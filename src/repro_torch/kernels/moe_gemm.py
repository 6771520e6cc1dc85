"""Grouped SwiGLU expert FFN over fp or blockwise-quantized weights: the
CUDA kernels' wrappers and their plain PyTorch versions.

``moe_ffn_kernel`` replaces the TPU kernel
``src/repro/kernels/moe_gemm.py::moe_ffn_kernel`` (``_kernel``) and
``moe_ffn_kernel_quant`` replaces ``moe_ffn_kernel_quant`` (``_kernel_q``,
``_dequant_tile``).  Both are memory-bound on an H100 at the serve's
capacities (they must read every expert weight byte once; the bf16 call
reads 1.21 GB, 0.36 ms at 3.35 TB/s) and near the card's ridge at the
forward's capacity 320 (see the source notes).

``csrc/moe_ffn.cu`` has one design per type.  bf16 runs on the tensor
cores (wgmma, swap-AB: 64-column weight slabs as the M side, the C-tile of
16 to 160 tokens as N) with the slabs streamed through a ring of
shared-memory stages by asynchronous copies, in two launches per call: one
writes h = silu(x Wg) * (x Wu), rounded to bf16, into a scratch
(E, C, F rounded up to 8) that the wrapper allocates, one multiplies it by
Wd.  Any D and F: the edge tiles are zero-filled on load and masked on
store (``check_ffn_dims``).  fp32 stays on the CUDA cores in
fp32 FMA (the port holds fp32 to 2e-5, which TF32 cannot meet), in the
same two launches with h kept fp32 in its scratch: each launch is a tiled
product (``csrc/moe_f32.cuh``) with D and F tiled through shared memory,
so no width is refused.  ``csrc/moe_ffn_quant.cu`` has the same two
designs over int8 or packed int4 payload with fp32 block scales: bf16
streams the compressed slabs through the same kind of ring and
dequantizes each value straight into ``wgmma``'s register operand (same
geometry and h scratch as bf16 ``moe_ffn``); fp32 dequantizes each weight
tile as it loads it into the CUDA-core product.

Each wrapper launches its kernel on CUDA tensors and counts the call (one
per call, whatever the launches inside) in its ``launches``;
``moe_ffn_plain`` / ``moe_ffn_quant_plain`` are the same functions in
torch ops (``kernels/ref.py::moe_ffn_ref`` and ``moe_ffn_ref_quant``), used
on the CPU and as the yardstick on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import build

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


def ffn_entry(dtype: torch.dtype) -> str:
    """The C entry of ``csrc/moe_ffn.cu`` for activations of ``dtype``."""
    if dtype not in _ENTRY:
        raise ValueError(f"moe_ffn_kernel: no kernel for {dtype}; "
                         f"fp32 or bf16")
    return _ENTRY[dtype]


def check_ffn_dims(d: int, f: int, dtype: torch.dtype,
                   who: str = "moe_ffn_kernel") -> None:
    """Raise unless the kernel for ``dtype`` takes widths D and F (the
    same rule for the fp and the quantized FFN): both types take any
    widths of at least 1, as the reference's kernels do (bf16 zero-fills
    and masks its edge tiles, fp32's tiles mask the ragged edges)."""
    if d < 1 or f < 1:
        raise ValueError(f"{who}: D and F must be at least 1, got D={d} "
                         f"F={f}")


def check_quant_dims(d: int, f: int, bits: int, qb: int,
                     dtype: torch.dtype) -> None:
    """Raise unless the quantized kernel for ``dtype`` takes widths D and F
    with ``bits``-bit payload in blocks of ``qb``: int8 or int4 with an
    even block (int4 rows pair up within a block), any even block for bf16
    (each value takes its own row's scale), and any widths
    (``check_ffn_dims``; a width that is not a whole number of blocks
    reads as padded with zero weights, as the reference pads it)."""
    if bits not in (4, 8) or qb < 2 or qb % 2:
        raise ValueError(f"moe_ffn_kernel_quant: bits={bits} block={qb} "
                         f"not supported")
    check_ffn_dims(d, f, dtype, "moe_ffn_kernel_quant")


def h_scratch_spec(e: int, c: int, f: int, dtype: torch.dtype
                   ) -> tuple[tuple[int, int, int], torch.dtype]:
    """Shape and dtype of the h scratch both kernels (fp and quantized
    weights) pass between their two launches: h in x's dtype, as the
    reference rounds it (bf16, or fp32 for fp32); bf16's rows are F
    rounded up to 8, so each starts 16-byte aligned
    (``csrc/common.cuh::ffn_h_stride``; its pad columns hold zeros)."""
    if dtype == torch.bfloat16:
        f = -(-f // 8) * 8
    return (e, c, f), dtype


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
        if x.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"moe_ffn_kernel: bf16 {name} needs a "
                             f"16-byte-aligned address (16-byte copies)")
    check_ffn_dims(d, f, x.dtype)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = ffn_entry(x.dtype)
    shape, h_dtype = h_scratch_spec(e, c, f, x.dtype)
    h = torch.empty(shape, dtype=h_dtype, device=x.device)
    ptrs = [x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), h.data_ptr()]
    build.check(getattr(lib, entry)(*ptrs, y.data_ptr(), e, c, d, f, stream),
                entry)
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
    check_quant_dims(d, f, bits, qb, x.dtype)
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
    operands = [x] + [t for w in (w_gate, w_up, w_down)
                      for t in (w.data, w.scale)]
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in operands):
        raise ValueError("moe_ffn_kernel_quant: bf16 operands need "
                         "16-byte-aligned addresses (16-byte copies)")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = _ENTRY_QUANT[x.dtype]
    ptrs = [x.data_ptr(), w_gate.data.data_ptr(), w_gate.scale.data_ptr(),
            w_up.data.data_ptr(), w_up.scale.data_ptr(),
            w_down.data.data_ptr(), w_down.scale.data_ptr()]
    shape, h_dtype = h_scratch_spec(e, c, f, x.dtype)
    h = torch.empty(shape, dtype=h_dtype, device=x.device)
    ptrs.append(h.data_ptr())
    build.check(getattr(lib, entry)(*ptrs, y.data_ptr(), e, c, d, f, bits,
                                    qb, stream), entry)
    moe_ffn_kernel_quant.launches += 1
    return y


moe_ffn_kernel_quant.launches = 0
