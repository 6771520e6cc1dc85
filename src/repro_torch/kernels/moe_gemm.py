"""Grouped SwiGLU expert FFN over fp or blockwise-quantized weights: the
CUDA kernels' wrappers and their plain PyTorch versions.

``moe_ffn_kernel`` replaces the TPU kernel
``src/repro/kernels/moe_gemm.py::moe_ffn_kernel`` (``_kernel``) and
``moe_ffn_kernel_quant`` replaces ``moe_ffn_kernel_quant`` (``_kernel_q``,
``_dequant_tile``).  Both kernels (``csrc/moe_ffn.cu``,
``csrc/moe_ffn_quant.cu``) are memory-bound on an H100 at the main path's
shapes: they read each expert weight byte once per 16-row C-tile and keep
x and the rounded h on chip (see the source notes); the quantized one
reads int8 or packed int4 payload plus one fp32 scale per 128-row block.

Each wrapper launches its kernel on CUDA tensors and counts the launch in
its ``launches``; ``moe_ffn_plain`` / ``moe_ffn_quant_plain`` are the same
functions in torch ops (``kernels/ref.py::moe_ffn_ref`` and
``moe_ffn_ref_quant``), used on the CPU and as the yardstick on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import build

_ROWS = 16                    # C-tile rows per block (csrc/moe_ffn.cu)
_SMEM_LIMIT = 232448          # dynamic shared memory a Hopper block may use
_ENTRY = {torch.float32: "moe_ffn_f32", torch.bfloat16: "moe_ffn_bf16"}
_ENTRY_QUANT = {torch.float32: "moe_ffn_quant_f32",
                torch.bfloat16: "moe_ffn_quant_bf16"}


def moe_ffn_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w_gate/w_up: (E, D, F); w_down: (E, F, D) -> (E, C, D).
    fp32 accumulation; h is rounded to x's dtype before the down-projection."""
    g = torch.bmm(x.float(), w_gate.float())
    u = torch.bmm(x.float(), w_up.float())
    h = (F.silu(g) * u).to(x.dtype)
    return torch.bmm(h.float(), w_down.float()).to(x.dtype)


def moe_ffn_kernel(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/moe_ffn.cu`` on CUDA tensors (same contract as
    ``moe_ffn_plain``).  Raises on anything the kernel does not take."""
    build.refuse_grad("moe_ffn", x, w_gate, w_up, w_down)
    e, c, d = x.shape
    f = w_gate.shape[-1]
    for name, t, shape in (("x", x, (e, c, d)), ("w_gate", w_gate, (e, d, f)),
                           ("w_up", w_up, (e, d, f)),
                           ("w_down", w_down, (e, f, d))):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"moe_ffn_kernel: {name} must be on {x.device}")
        if t.dtype != x.dtype or x.dtype not in _ENTRY:
            raise ValueError(f"moe_ffn_kernel: {name} has dtype {t.dtype}; "
                             f"all operands must share fp32 or bf16")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"moe_ffn_kernel: {name} must be contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    if (d + f) * _ROWS * x.element_size() > _SMEM_LIMIT:
        raise ValueError(f"moe_ffn_kernel: D + F = {d + f} exceeds the "
                         f"shared-memory tile of one block")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = _ENTRY[x.dtype]
    build.check(getattr(lib, entry)(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        y.data_ptr(), e, c, d, f, stream), entry)
    moe_ffn_kernel.launches += 1
    return y


moe_ffn_kernel.launches = 0


def moe_ffn_quant_plain(x: torch.Tensor, w_gate: quant.QuantTensor,
                        w_up: quant.QuantTensor,
                        w_down: quant.QuantTensor) -> torch.Tensor:
    """``moe_ffn_plain`` over QuantTensor weights dequantized to x's dtype:
    each weight value is ``(float(q) * s).to(x.dtype)``, as the reference's
    ``_dequant_tile`` + ``.astype(x.dtype)`` makes it."""
    return moe_ffn_plain(x, *(quant.dequantize(w, x.dtype)
                              for w in (w_gate, w_up, w_down)))


def moe_ffn_kernel_quant(x: torch.Tensor, w_gate: quant.QuantTensor,
                         w_up: quant.QuantTensor,
                         w_down: quant.QuantTensor) -> torch.Tensor:
    """Launch ``csrc/moe_ffn_quant.cu`` on CUDA tensors (same contract as
    ``moe_ffn_quant_plain``).  w_gate/w_up: (E, D, F) quantized along D,
    w_down: (E, F, D) quantized along F, all with one bits and block.
    Raises on anything the kernel does not take."""
    build.refuse_grad("moe_ffn_quant", x,
                      *(w.scale for w in (w_gate, w_up, w_down)))
    e, c, d = x.shape
    f = w_gate.shape[-1]
    bits, qb = w_gate.bits, w_gate.block
    if not x.is_cuda:
        raise ValueError(f"moe_ffn_kernel_quant: x must be on a CUDA "
                         f"device, got {x.device}")
    if x.dtype not in _ENTRY_QUANT or not x.is_contiguous():
        raise ValueError(f"moe_ffn_kernel_quant: x must be contiguous fp32 "
                         f"or bf16, got {x.dtype}")
    if bits not in (4, 8) or qb < 2 or qb % 2:
        raise ValueError(f"moe_ffn_kernel_quant: bits={bits} block={qb} "
                         f"not supported")
    rows = lambda k: -(-k // 2) if bits == 4 else k
    for name, w, (kdim, n) in (("w_gate", w_gate, (d, f)),
                               ("w_up", w_up, (d, f)),
                               ("w_down", w_down, (f, d))):
        if (w.bits, w.block) != (bits, qb):
            raise ValueError(f"moe_ffn_kernel_quant: {name} has bits/block "
                             f"{(w.bits, w.block)}, w_gate {(bits, qb)}")
        for part, t, dtype, shape in (
                ("payload", w.data, torch.int8, (e, rows(kdim), n)),
                ("scale", w.scale, torch.float32, (e, -(-kdim // qb), n))):
            if not t.is_cuda or t.device != x.device:
                raise ValueError(f"moe_ffn_kernel_quant: {name} {part} must "
                                 f"be on {x.device}")
            if (t.dtype != dtype or tuple(t.shape) != shape
                    or not t.is_contiguous()):
                raise ValueError(
                    f"moe_ffn_kernel_quant: {name} {part} must be contiguous "
                    f"{dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if w.orig_dim != kdim:
            raise ValueError(f"moe_ffn_kernel_quant: {name} reduces over "
                             f"{w.orig_dim}, expected {kdim}")
    if (d + f) * _ROWS * x.element_size() > _SMEM_LIMIT:
        raise ValueError(f"moe_ffn_kernel_quant: D + F = {d + f} exceeds the "
                         f"shared-memory tile of one block")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = _ENTRY_QUANT[x.dtype]
    build.check(getattr(lib, entry)(
        x.data_ptr(), w_gate.data.data_ptr(), w_gate.scale.data_ptr(),
        w_up.data.data_ptr(), w_up.scale.data_ptr(), w_down.data.data_ptr(),
        w_down.scale.data_ptr(), y.data_ptr(), e, c, d, f, bits, qb, stream),
        entry)
    moe_ffn_kernel_quant.launches += 1
    return y


moe_ffn_kernel_quant.launches = 0
