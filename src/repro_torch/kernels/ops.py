"""Device dispatch for the port's kernels.

The tensor's device decides: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the hand-written kernel (or the call
raises).  There is no switch and no fallback.  Each kernel wrapper keeps a
plain-integer launch count, read and reset here.  A ``QuantTensor``
``w_gate`` selects the quantized FFN, scale pools the int8 attention entry.

A meta tensor (the dry-run, ``launch/dryrun.py``) runs neither: each
entry returns an empty meta tensor of the kernel's output shape and books
the kernel's FLOPs and bytes (``kernels/cost.py``) to the active
``launch/opcount`` capture.  It never runs the plain version, whose
buffers (the flash plain's S x S scores, the paged plain's gathered
virtual cache) the kernels do not allocate.  Nothing is launched or
counted.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import cost, flash_attn, moe_gemm, paged_attn
from repro_torch.launch import opcount

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


def _meta(name: str, args, out: torch.Tensor, work) -> torch.Tensor:
    opcount.book_kernel(name, args, out, flops=work[1], nbytes=work[0])
    return out


def moe_ffn(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Prestacked grouped expert FFN (E, C, D) -> (E, C, D); the weights
    are raw tensors or QuantTensors (int8 / packed int4)."""
    if x.is_meta:
        e, c, d = x.shape
        f = w_gate.shape[-1]
        ws = (w_gate, w_up, w_down)
        if isinstance(w_gate, quant.QuantTensor):
            return _meta("moe_ffn_quant",
                         (x,) + tuple(t for w in ws for t in (w.data,
                                                              w.scale)),
                         torch.empty_like(x), cost.moe_ffn_quant(
                             e, c, d, f, x.element_size(),
                             sum(w.nbytes() for w in ws)))
        return _meta("moe_ffn", (x,) + ws, torch.empty_like(x),
                     cost.moe_ffn(e, c, d, f, x.element_size()))
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
    if q.is_meta:
        int8 = k_scale is not None
        hkv, hd = k_pool.shape[2:]
        slot = hd + 4 if int8 else hd * k_pool.element_size()
        return _meta(
            "paged_attention_int8" if int8 else "paged_attention",
            (q, k_pool, v_pool, block_tables, lengths, seg_lens)
            + ((k_scale, v_scale) if int8 else ()), torch.empty_like(q),
            cost.paged_reach(tuple(q.shape), hkv, slot, q.element_size(),
                             block_tables.shape[1] * k_pool.shape[1],
                             window))
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
    if q.is_meta:
        b, s, hq, hd = q.shape
        return _meta("flash_attention", (q, k, v), torch.empty_like(q),
                     cost.flash(b, s, hq, k.shape[2], hd, q.element_size(),
                                causal, window))
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
