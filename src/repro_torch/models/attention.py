"""GQA attention (the JAX package's ``models/attention.py``): the unified
paged step and the cache-free full-sequence forward.

The cache is a page pool per layer, ``(num_pages, page_size, Hkv, hd)``,
shared by every row; row b reaches its cache positions through its block
table.  ``attn_block_step_paged`` writes the block's K/V into the pool IN
PLACE and attends through ``kernels/ops.paged_attention`` (the CUDA kernel
on the card, its plain page walk on the CPU).  With
``kv_cache_dtype="int8"`` the pool holds int8 K/V plus fp32 scale pools
``k_scale``/``v_scale`` ``(num_pages, page_size, Hkv, 1)``, one scale per
(slot, head) (``quantize_kv``).  Projection weights may be QuantTensors
(``core/quant.qdot``).

``attn_forward`` is the full-sequence forward with no cache, the port of
the reference's ``use_flash_kernel`` branch: causal (optionally windowed)
attention through ``kernels/ops.flash_attention`` on the unrepeated K/V.
"""
from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.core import quant
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
    q, k, v = (quant.qdot(x, p[w]) for w in ("wq", "wk", "wv"))
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


def kv_quantized(cfg) -> bool:
    if cfg.kv_cache_dtype not in ("native", "int8"):
        raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}")
    return cfg.kv_cache_dtype == "int8"


def paged_layer_cache_spec(cfg, num_pages: int, page_size: int, dtype):
    """Per-layer paged pool: {"k", "v"} (+ {"k_scale", "v_scale"} for an
    int8 cache) -> (shape, dtype)."""
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_quantized(cfg):
        sshape = shape[:-1] + (1,)
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (sshape, torch.float32),
                "v_scale": (sshape, torch.float32)}
    return {"k": (shape, dtype), "v": (shape, dtype)}


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8: x (..., hd) -> (int8, fp32 scale
    (..., 1)); ``core/quant.absmax_quantize`` with one block over hd."""
    return quant.absmax_quantize(x, bits=8, block=x.shape[-1], axis=-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return quant.absmax_dequantize(q, scale, block=q.shape[-1], axis=-1,
                                   dtype=dtype)


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
    ``pos % ps`` of ``cache["k"]`` / ``cache["v"]`` (an int8 cache writes
    payload and scales); invalid tokens and positions past the table write
    nothing.  Attention then walks the block table.
    x: (B, T, D) -> (B, T, D)."""
    b, t, _ = x.shape
    page_size = cache["k"].shape[1]
    nb = block_tables.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    valid = torch.arange(t, device=x.device)[None, :] < seg_lens[:, None]
    blk = positions // page_size
    page = torch.gather(block_tables, 1, blk.clamp(0, nb - 1))
    ok = valid & (blk < nb)
    slot = positions % page_size
    if kv_quantized(cfg):
        (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k_new, "v": v_new}
    for kk, vals in new.items():
        _paged_scatter(cache[kk], vals, page, slot, ok)
    out = ops.paged_attention(q, cache["k"], cache["v"], block_tables,
                              lengths, seg_lens, k_scale=cache.get("k_scale"),
                              v_scale=cache.get("v_scale"), window=window)
    return quant.qdot(out.reshape(b, t, cfg.num_heads * cfg.head_dim),
                      p["wo"])


def attn_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                 window: int | None) -> torch.Tensor:
    """Causal self-attention over a full sequence with no cache.
    x: (B, S, D); positions: (B, S) for RoPE.  Returns (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    return quant.qdot(out.reshape(b, s, cfg.num_heads * cfg.head_dim),
                      p["wo"])
