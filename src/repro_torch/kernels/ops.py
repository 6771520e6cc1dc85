"""Device dispatch for the port's kernels.

The tensor's device decides: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the hand-written kernel (or the call
raises).  There is no switch and no fallback.  Each kernel wrapper keeps a
plain-integer launch count, read and reset here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import moe_gemm, paged_attn

_KERNELS = {"moe_ffn": moe_gemm.moe_ffn_kernel,
            "paged_attention": paged_attn.paged_attention}


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def moe_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """Prestacked grouped expert FFN (E, C, D) -> (E, C, D)."""
    if _on_cuda(x):
        return moe_gemm.moe_ffn_kernel(x, w_gate, w_up, w_down)
    return moe_gemm.moe_ffn_plain(x, w_gate, w_up, w_down)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, seg_lens: torch.Tensor, *,
                    window: int | None = None) -> torch.Tensor:
    """Block-table paged attention (B, T, Hq, hd) over one layer's fp pool
    (P, ps, Hkv, hd) — decode (T=1) and chunked prefill (T>1)."""
    if _on_cuda(q):
        return paged_attn.paged_attention(
            q, k_pool, v_pool, block_tables, lengths, seg_lens, window=window)
    return paged_attn.paged_attention_plain(
        q, k_pool, v_pool, block_tables, lengths, seg_lens, window=window)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
