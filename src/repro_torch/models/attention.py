"""GQA attention for the unified paged step (the paged branch of the JAX
package's ``models/attention.py``).

The cache is a page pool per layer, ``(num_pages, page_size, Hkv, hd)``,
shared by every row; row b reaches its cache positions through its block
table.  ``attn_block_step_paged`` writes the block's K/V into the pool IN
PLACE and attends through ``kernels/ops.paged_attention`` (the CUDA kernel
on the card, its plain page walk on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.kernels import ops
from repro_torch.models import layers


def attn_init(gen: torch.Generator, cfg, dtype, lead: tuple = ()) -> dict:
    """Attention weights, optionally stacked along ``lead`` (layers)."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": layers.dense_init(gen, d, hq * hd, dtype, lead),
        "wk": layers.dense_init(gen, d, hkv * hd, dtype, lead),
        "wv": layers.dense_init(gen, d, hkv * hd, dtype, lead),
        "wo": layers.dense_init(gen, hq * hd, d, dtype, lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (hq * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (hkv * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
    return p


def _project_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    if cfg.mrope or not cfg.use_rope:
        raise not_ported("attention without RoPE or with M-RoPE",
                         "other families")
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(p["q_norm"], q)
        k = layers.rms_norm(p["k_norm"], k)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def paged_layer_cache_spec(cfg, num_pages: int, page_size: int, dtype):
    """Per-layer paged pool: {"k", "v"} -> (shape, dtype)."""
    if cfg.kv_cache_dtype != "native":
        raise not_ported("the int8 KV cache", "the quantized slice")
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def _paged_scatter(pool: torch.Tensor, new: torch.Tensor, page: torch.Tensor,
                   slot: torch.Tensor, ok: torch.Tensor) -> None:
    """Write new (B, T, ...) rows at (page, slot) (B, T) into pool
    (P, ps, ...) IN PLACE, for the tokens where ``ok`` holds.

    Without a host sync a masked token cannot be left out of the
    scatter, so it repeats the first valid token's write instead (same
    index, same value: duplicate writes agree).  When no token is valid
    every write puts back the value it read."""
    num_pages, ps = pool.shape[:2]
    flat = pool.view((num_pages * ps,) + pool.shape[2:])
    n = ok.numel()
    idx = (page.clamp(0, num_pages - 1) * ps + slot).reshape(n)
    okf = ok.reshape(n)
    vals = new.reshape((n,) + new.shape[2:]).to(pool.dtype)
    src = torch.where(okf, torch.arange(n, device=ok.device),
                      okf.to(torch.uint8).argmax())
    dst = idx[src]
    flat[dst] = torch.where(okf.any(), vals[src], flat[dst])


def attn_block_step_paged(p: dict, cfg, cache: dict, x: torch.Tensor,
                          positions: torch.Tensor, lengths: torch.Tensor,
                          seg_lens: torch.Tensor, block_tables: torch.Tensor,
                          window: int | None) -> torch.Tensor:
    """Cached attention of a (B, T) token block over one layer's page pool.

    Row b's token j sits at absolute position ``positions[b, j] ==
    lengths[b] + j`` and is valid when ``j < seg_lens[b]``.  Valid tokens
    write their K/V IN PLACE at page ``block_tables[b, pos // ps]`` slot
    ``pos % ps`` of ``cache["k"]`` / ``cache["v"]``; invalid tokens and
    positions past the table write nothing.  Attention then walks the
    block table.  x: (B, T, D) -> (B, T, D)."""
    b, t, _ = x.shape
    page_size = cache["k"].shape[1]
    nb = block_tables.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    valid = torch.arange(t, device=x.device)[None, :] < seg_lens[:, None]
    blk = positions // page_size
    page = torch.gather(block_tables, 1, blk.clamp(0, nb - 1))
    ok = valid & (blk < nb)
    slot = positions % page_size
    _paged_scatter(cache["k"], k_new, page, slot, ok)
    _paged_scatter(cache["v"], v_new, page, slot, ok)
    out = ops.paged_attention(q, cache["k"], cache["v"], block_tables,
                              lengths, seg_lens, window=window)
    return out.reshape(b, t, cfg.num_heads * cfg.head_dim) @ p["wo"]
