"""The MoE decoder stack (the JAX package's ``models/transformer.py``):
the unified paged path and the cache-free full-sequence forward.

Parameters are stacked along a leading layer axis, as in the reference.
Where the reference runs the stack under ``jax.lax.scan`` with the whole
page pool as the scan carry (so a donating caller aliases it in place), the
port runs a Python loop over layers that writes each layer's slice of the
pool in place: PyTorch needs no donation for that.
"""
from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.core import expert_parallel
from repro_torch.models import attention, layers


def _moe_layer_init(cfg, gen: torch.Generator, dtype) -> dict:
    L, e, d, f = (cfg.num_layers, cfg.num_experts_padded, cfg.d_model,
                  cfg.d_ff)
    norm = lambda: layers.norm_init(cfg.norm, d, dtype, gen.device, (L,))
    return {
        "ln1": norm(),
        "attn": attention.attn_init(gen, cfg, dtype, (L,)),
        "ln2": norm(),
        "router": layers.dense_init(gen, d, e, dtype, (L,)),
        "experts": {
            "w_gate": layers.dense_init(gen, d, f, dtype, (L, e)),
            "w_up": layers.dense_init(gen, d, f, dtype, (L, e)),
            "w_down": layers.dense_init(gen, f, d, dtype, (L, e)),
        },
    }


def init_blocks(cfg, gen: torch.Generator) -> dict:
    """Layer-stacked block parameters, drawn from ``gen`` on its device."""
    if cfg.family != "moe":
        raise not_ported(f"the {cfg.family!r} family",
                         "the dense family and the reference path")
    return _moe_layer_init(cfg, gen, cfg.param_torch_dtype)


def _attn_mlp_block(cfg, layer_p, x, positions, window, cache_l=None,
                    token_mask=None, block_lens=None, block_tables=None):
    """Attention + MoE block: paged attention over ``cache_l`` when given,
    else the cache-free full-sequence forward.  Returns (x, aux, routed
    (B*T, K))."""
    h = layers.norm_apply(cfg.norm, layer_p["ln1"], x)
    if cache_l is None:
        h = attention.attn_forward(layer_p["attn"], cfg, h, positions, window)
    else:
        lengths, seg_lens = block_lens
        h = attention.attn_block_step_paged(
            layer_p["attn"], cfg, cache_l, h, positions, lengths, seg_lens,
            block_tables, window)
    x = x + h
    h = layers.norm_apply(cfg.norm, layer_p["ln2"], x)
    moe_p = {"router": layer_p["router"], "experts": layer_p["experts"]}
    h, aux, routed = expert_parallel.moe_layer(cfg, moe_p, h, token_mask)
    return x + h, aux, routed


def paged_stack_cache_spec(cfg, num_pages: int, page_size: int, dtype):
    """Stacked paged pool: {"k", "v"} -> ((L, P, ps, Hkv, hd), dtype), and
    for an int8 cache {"k_scale", "v_scale"} -> ((L, P, ps, Hkv, 1), fp32)."""
    if cfg.family != "moe":
        raise not_ported(f"a paged cache for the {cfg.family!r} family",
                         "the dense family and the reference path")
    per = attention.paged_layer_cache_spec(cfg, num_pages, page_size, dtype)
    return {kk: ((cfg.num_layers,) + shape, dt)
            for kk, (shape, dt) in per.items()}


def init_paged_stack_cache(cfg, num_pages: int, page_size: int, dtype,
                           device) -> dict:
    return {kk: torch.zeros(shape, dtype=dt, device=device)
            for kk, (shape, dt) in paged_stack_cache_spec(
                cfg, num_pages, page_size, dtype).items()}


def effective_window(cfg, seq_len: int) -> int | None:
    """Window actually used at this sequence length: native sliding window
    if the arch has one; the long-context SWA variant beyond
    ``cfg.long_context_threshold`` for otherwise full-attention archs."""
    if cfg.sliding_window:
        return cfg.sliding_window
    if cfg.long_context_window and seq_len >= cfg.long_context_threshold:
        return cfg.long_context_window
    return None


def _layer(tree: dict, l: int) -> dict:
    """Layer ``l`` of a layer-stacked tree (QuantTensor leaves slice payload
    and scales together)."""
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def forward_stack(cfg, blocks, x, positions, window):
    """Run all layers over a full sequence with no cache.
    x: (B, S, D); positions: (B, S).  Returns (x, total aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.num_layers):
        x, a, _ = _attn_mlp_block(cfg, _layer(blocks, l), x, positions,
                                  window)
        aux = aux + a
    return x, aux


def unified_stack(cfg, blocks, x, positions, lengths, seg_lens, cache, window,
                  token_mask, block_tables):
    """Token-block forward through all layers over the paged pool.

    x: (B, T, D); positions: (B, T) absolute; lengths/seg_lens: (B,);
    block_tables: (B, NB).  Layer l writes ``cache[..][l]`` IN PLACE.
    Returns (x, routing (L, B*T, K) int32) — invalid tokens read the E_pad
    sentinel."""
    b, t, _ = x.shape
    routing = torch.empty((cfg.num_layers, b * t, cfg.experts_per_token),
                          dtype=torch.int32, device=x.device)
    for l in range(cfg.num_layers):
        cache_l = {kk: v[l] for kk, v in cache.items()}
        x, _, routed = _attn_mlp_block(
            cfg, _layer(blocks, l), x, positions, window, cache_l, token_mask,
            (lengths, seg_lens), block_tables)
        routing[l] = routed
    return x, routing
