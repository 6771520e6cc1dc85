"""Paged flash attention over the block-table page pool: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/paged_attn.py::paged_attention``
(``_kernel``, ``_page_index``) for fp pools; int8 pools are a later slice.
The kernel (``csrc/paged_attn.cu``) is memory-bound on an H100: one block
per (row, kv head, 16 grouped q rows) walks only the row's live pages,
staging each K/V page once for every query head of its group (see the
source note).

``paged_attention`` launches the kernel on CUDA tensors and counts the
launch in ``paged_attention.launches``; ``paged_attention_plain`` is the
page walk of ``kernels/ref.py::paged_attention_ref`` in torch ops,
used on the CPU and as the yardstick on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_ENTRY = {torch.float32: "paged_attention_f32",
          torch.bfloat16: "paged_attention_bf16"}


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, seg_lens: torch.Tensor, *,
                          window: int | None = None) -> torch.Tensor:
    """q (B, T, Hq, hd) + pool (P, ps, Hkv, hd) + block_tables (B, NB)
    -> (B, T, Hq, hd).  Token t of row b attends the slots at absolute
    positions <= lengths[b] + t (and > that - window); tokens with
    t >= seg_lens[b] come out exactly zero.  Table entries are clamped into
    the pool."""
    b, t, hq, hd = q.shape
    num_pages, ps, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    bt = block_tables.long().clamp(0, num_pages - 1)
    k = k_pool[bt].reshape(b, nb * ps, hkv, hd)        # (B, S, Hkv, hd)
    v = v_pool[bt].reshape(b, nb * ps, hkv, hd)
    qg = q.reshape(b, t, hkv, g, hd)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          k.float()) * hd ** -0.5
    slot = torch.arange(nb * ps, device=q.device)[None, None, :]
    tpos = torch.arange(t, device=q.device)
    qp = torch.where(tpos[None, :] < seg_lens[:, None].long(),
                     lengths[:, None].long() + tpos, -1)[:, :, None]
    mask = slot <= qp
    if window is not None:
        mask = mask & (slot > qp - window)
    mask5 = mask[:, None, None, :, :]                 # (B,1,1,T,S)
    logits = torch.where(mask5, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask5, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqs,bshd->bhgqd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, hd).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, seg_lens: torch.Tensor, *,
                    window: int | None = None) -> torch.Tensor:
    """Launch ``csrc/paged_attn.cu`` on CUDA tensors (same contract as
    ``paged_attention_plain``).  Raises on anything the kernel does not
    take."""
    b, t, hq, hd = q.shape
    num_pages, ps, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    checks = (("q", q, q.dtype, (b, t, hq, hd)),
              ("k_pool", k_pool, q.dtype, (num_pages, ps, hkv, hd)),
              ("v_pool", v_pool, q.dtype, (num_pages, ps, hkv, hd)),
              ("block_tables", block_tables, torch.int32, (b, nb)),
              ("lengths", lengths, torch.int32, (b,)),
              ("seg_lens", seg_lens, torch.int32, (b,)))
    for name, x, dtype, shape in checks:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on "
                             f"{q.device}")
        if x.dtype != dtype:
            raise ValueError(f"paged_attention: {name} has dtype "
                             f"{x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be "
                             f"contiguous {shape}, got {tuple(x.shape)}")
    if q.dtype not in _ENTRY:
        raise ValueError(f"paged_attention: dtype {q.dtype} is not "
                         f"ported (fp32 and bf16 pools)")
    if hkv == 0 or hq % hkv or hd > 256 or num_pages < 1 or nb < 1:
        raise ValueError(f"paged_attention: unsupported geometry "
                         f"Hq={hq} Hkv={hkv} hd={hd} P={num_pages} NB={nb}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = _ENTRY[q.dtype]
    build.check(getattr(lib, entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), seg_lens.data_ptr(),
        out.data_ptr(), b, t, hq, hkv, hd, num_pages, ps, nb,
        0 if window is None else int(window), hd ** -0.5, stream), entry)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
