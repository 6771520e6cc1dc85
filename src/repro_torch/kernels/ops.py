"""Device dispatch for the port's kernels.

The tensor's device decides: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the hand-written kernel (or the call
raises).  There is no switch and no fallback.  Each kernel wrapper keeps a
plain-integer launch count, read and reset here.  A ``QuantTensor``
``w_gate`` selects the quantized FFN, scale pools the int8 attention entry.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import flash_attn, moe_gemm, paged_attn

_KERNELS = {"moe_ffn": moe_gemm.moe_ffn_kernel,
            "moe_ffn_quant": moe_gemm.moe_ffn_kernel_quant,
            "paged_attention": paged_attn.paged_attention,
            "paged_attention_int8": paged_attn.paged_attention_int8,
            "flash_attention": flash_attn.flash_attention}


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def moe_ffn(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Prestacked grouped expert FFN (E, C, D) -> (E, C, D); the weights
    are raw tensors or QuantTensors (int8 / packed int4)."""
    if isinstance(w_gate, quant.QuantTensor):
        if _on_cuda(x):
            return moe_gemm.moe_ffn_kernel_quant(x, w_gate, w_up, w_down)
        return moe_gemm.moe_ffn_quant_plain(x, w_gate, w_up, w_down)
    if _on_cuda(x):
        return moe_gemm.moe_ffn_kernel(x, w_gate, w_up, w_down)
    return moe_gemm.moe_ffn_plain(x, w_gate, w_up, w_down)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, seg_lens: torch.Tensor, *,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Block-table paged attention (B, T, Hq, hd) over one layer's pool
    (P, ps, Hkv, hd) — decode (T=1) and chunked prefill (T>1).  An int8
    pool comes with its fp32 scale pools (P, ps, Hkv, 1)."""
    if _on_cuda(q):
        if k_scale is not None:
            return paged_attn.paged_attention_int8(
                q, k_pool, v_pool, k_scale, v_scale, block_tables, lengths,
                seg_lens, window=window)
        return paged_attn.paged_attention(
            q, k_pool, v_pool, block_tables, lengths, seg_lens, window=window)
    return paged_attn.paged_attention_plain(
        q, k_pool, v_pool, block_tables, lengths, seg_lens, k_scale=k_scale,
        v_scale=v_scale, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Full-sequence attention: q (B, S, Hq, hd) over unrepeated k/v
    (B, S, Hkv, hd) -> (B, S, Hq, hd), causal and/or windowed."""
    if _on_cuda(q):
        return flash_attn.flash_attention(q, k, v, causal=causal,
                                          window=window)
    return flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
