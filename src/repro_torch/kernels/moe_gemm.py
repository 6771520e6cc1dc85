"""Grouped SwiGLU expert FFN: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/moe_gemm.py::moe_ffn_kernel``
(``_kernel``).  The kernel (``csrc/moe_ffn.cu``) is memory-bound on an H100
at the main path's shapes: it reads each expert weight byte once per
16-row C-tile and keeps x and the rounded h on chip (see the source note).

``moe_ffn_kernel`` launches the kernel on a CUDA tensor and counts the
launch in ``moe_ffn_kernel.launches``; ``moe_ffn_plain`` is the same
function in torch ops (from ``kernels/ref.py::moe_ffn_ref``), used on the
CPU and as the yardstick on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_ROWS = 16                    # C-tile rows per block (csrc/moe_ffn.cu)
_SMEM_LIMIT = 232448          # dynamic shared memory a Hopper block may use
_ENTRY = {torch.float32: "moe_ffn_f32", torch.bfloat16: "moe_ffn_bf16"}


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
