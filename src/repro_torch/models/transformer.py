"""The decoder stacks (the JAX package's ``models/transformer.py``):
``dense``, ``vlm`` and ``audio`` (attention + the SwiGLU or GeGLU MLP;
vlm's attention rotates by M-RoPE where the batch gives its positions),
``moe`` (attention + the MoE layer), ``ssm`` (Mamba-2 SSD blocks, no MLP)
and ``hybrid`` (RG-LRU, RG-LRU, local attention, each followed by the
MLP).

Four ways through the attention families' stack share one block body
(``_attn_mlp_block``): the unified step over the paged pool or the
contiguous cache (``unified_stack``), the cache-free full-sequence forward
(``forward_stack``), and the two-program reference engine's padded
prefill and one-token decode (``prefill_stack``, ``decode_stack``).  The
stateful families take the last three only (``_ssm_block``,
``_hybrid_block``), on one device or a mesh: the forward over this rank's
rows (on a training mesh with each layer's weights gathered), the cached
steps tensor-parallel over "model" in the serve layout (the hybrid's
RG-LRU channels and local attention heads split, the SSD block
replicated).

Parameters are stacked along a leading layer axis, as in the reference.
Where the reference runs the stack under ``jax.lax.scan`` with the whole
cache as the scan carry (so a donating caller aliases it in place), the
port runs a Python loop over layers that writes each layer's slice of the
cache in place: PyTorch needs no donation for that.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import expert_parallel, quant
from repro_torch.launch import sharding
from repro_torch.models import attention, layers, mamba2, rglru


def _in_copy(rows: slice, e: int) -> slice:
    """Rows of the r-copy expert stack (E_pad * r rows) as rows of one
    copy: a rank's rows lie inside one."""
    if rows.start is None:
        return rows
    return slice(rows.start % e, rows.start % e + rows.stop - rows.start)


def _one_copy(k, e: int):
    """A leaf's keep over the r-copy expert stack as its keep within one
    copy (a ``quant.Sink``'s own keep likewise); None keeps it whole."""
    if isinstance(k, quant.Sink):
        return dataclasses.replace(k, keep=_one_copy(k.keep, e))
    return None if k is None else (k[0], _in_copy(k[1], e)) + k[2:]


def _moe_layer_init(cfg, gen: torch.Generator, dtype, mesh=None,
                    keep=None) -> dict:
    L, e, d, f = (cfg.num_layers, cfg.num_experts_padded, cfg.d_model,
                  cfg.d_ff)
    norm = lambda: layers.norm_init(cfg.norm, d, dtype, gen.device, (L,))
    r = max(cfg.expert_replication, 1)
    keep = keep or {}
    ex = {k: None for k in ("w_gate", "w_up", "w_down")}
    if mesh is not None:
        ex = dict.fromkeys(ex, _in_copy(expert_parallel.expert_rows(cfg, mesh),
                                        e))
    elif "experts" in keep:
        ex = {k: _one_copy(sl, e) for k, sl in keep["experts"].items()}
    experts = {
        "w_gate": layers.dense_init(gen, d, f, dtype, (L, e), ex["w_gate"]),
        "w_up": layers.dense_init(gen, d, f, dtype, (L, e), ex["w_up"]),
        "w_down": layers.dense_init(gen, f, d, dtype, (L, e), ex["w_down"]),
    }
    whole = all((k.keep if isinstance(k, quant.Sink) else k) is None
                for k in ex.values())
    if r > 1 and mesh is None and whole:
        # the paper's overlapping placement (§5.3) stores r copies of the
        # expert stack, as the reference does; one device reads the first
        experts = {k: quant.cat([w] * r, dim=1) for k, w in experts.items()}
    return {
        "ln1": norm(),
        "attn": attention.attn_init(gen, cfg, dtype, (L,), keep.get("attn")),
        "ln2": norm(),
        "router": layers.dense_init(gen, d, e, dtype, (L,),
                                    keep.get("router")),
        "experts": experts,
    }


def _dense_layer_init(cfg, gen: torch.Generator, dtype, keep=None) -> dict:
    L, d = cfg.num_layers, cfg.d_model
    norm = lambda: layers.norm_init(cfg.norm, d, dtype, gen.device, (L,))
    keep = keep or {}
    return {
        "ln1": norm(),
        "attn": attention.attn_init(gen, cfg, dtype, (L,), keep.get("attn")),
        "ln2": norm(),
        "mlp": layers.mlp_init(gen, d, cfg.d_ff, dtype, (L,),
                               keep.get("mlp")),
    }


def _ssm_layer_init(cfg, gen: torch.Generator, dtype, keep=None) -> dict:
    L = cfg.num_layers
    keep = keep or {}
    return {"ln": layers.norm_init(cfg.norm, cfg.d_model, dtype, gen.device,
                                   (L,)),
            "mamba": mamba2.mamba_init(gen, cfg, dtype, (L,),
                                       keep.get("mamba"))}


def _hybrid_layer_init(cfg, gen: torch.Generator, dtype, kind: str,
                       n: int, keep=None) -> dict:
    """``n`` layers of one kind, stacked; ``keep``: their blocks."""
    d = cfg.d_model
    norm = lambda: layers.norm_init(cfg.norm, d, dtype, gen.device, (n,))
    keep = keep or {}
    mix = (rglru.rglru_init(gen, cfg, dtype, (n,), keep.get("mix"))
           if kind == "rec"
           else attention.attn_init(gen, cfg, dtype, (n,), keep.get("mix")))
    return {"ln1": norm(), "ln2": norm(),
            "mlp": layers.mlp_init(gen, d, cfg.d_ff, dtype, (n,),
                                   keep.get("mlp")),
            "mix": mix}


def hybrid_pattern(cfg) -> list[str]:
    """rec, rec, attn repeating (RecurrentGemma's one attention layer per
    two recurrent ones)."""
    return ["attn" if i % 3 == 2 else "rec" for i in range(cfg.num_layers)]


FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; expected one of "
                         f"{FAMILIES}")


def init_blocks(cfg, gen: torch.Generator, mesh=None, keep=None) -> dict:
    """Layer-stacked block parameters, drawn from ``gen`` on its device;
    on a ``mesh`` the expert stacks hold this rank's rows alone.
    ``keep``: the block of each leaf to store, a tree of slices
    (``launch/sharding.mode_slices``), with a ``quant.Sink`` at each
    weight quantized as it is drawn (``sharding.draw_keep``), every
    matrix still drawn.  A hybrid stack is {"rec": its recurrent layers,
    "attn": its attention layers (at least one)}, each stacked."""
    check_family(cfg)
    dtype = cfg.param_torch_dtype
    keep = keep or {}
    if cfg.family == "moe":
        return _moe_layer_init(cfg, gen, dtype, mesh, keep)
    if cfg.family == "ssm":
        return _ssm_layer_init(cfg, gen, dtype, keep)
    if cfg.family == "hybrid":
        pat = hybrid_pattern(cfg)
        return {"rec": _hybrid_layer_init(cfg, gen, dtype, "rec",
                                          pat.count("rec"), keep.get("rec")),
                "attn": _hybrid_layer_init(cfg, gen, dtype, "attn",
                                           max(pat.count("attn"), 1),
                                           keep.get("attn"))}
    return _dense_layer_init(cfg, gen, dtype, keep)


@dataclasses.dataclass(frozen=True)
class ServeTP:
    """A serving mesh's layout of the model on this rank, read from the
    serve-mode specs (``launch/sharding.serve_specs``): the embedding by
    vocabulary rows (``embed``), the LM head by vocabulary columns
    (``head``), each attention layer's heads (``attention.HeadTP``; None
    for the ssm family), the dense MLP's F split in W_gate / W_up and in
    W_down (``mlp``: the dense, vlm and audio families and both layer
    kinds of the hybrid), the hybrid's RG-LRU channels
    (``rglru.ChannelTP``, ``rec``; None where whole); the experts are the
    rank's rows.  The cached steps run this rank's block of rows
    (``Model``'s entry points cut them over the data axes, as the
    reference's ``cache_pspec`` places the caches) from its own caches,
    and the MoE layer runs ``cfg.expert_parallel`` over them asking for
    no aux loss, so no schedule takes its mean (the serving paths drop it,
    and XLA removes the reference's as dead code).  The ssm family's SSD
    block is replicated, as the reference's serve rules leave it."""
    mesh: object
    embed: bool
    head: bool
    attn: attention.HeadTP | None
    mlp: tuple | None
    rec: rglru.ChannelTP | None = None


def _mlp_tp(mesh, spec: dict) -> tuple:
    return (mesh, sharding.split(spec["w_gate"], -1),
            sharding.split(spec["w_down"], -2))


def serve_tp(cfg, mesh) -> ServeTP:
    specs = sharding.serve_specs(cfg, mesh)
    blocks = specs["blocks"]
    head = (sharding.split(specs["embed"], 0) if cfg.tie_embeddings
            else sharding.split(specs["lm_head"], -1))
    embed = sharding.split(specs["embed"], 0)
    if cfg.family == "ssm":
        return ServeTP(mesh, embed, head, None, None)
    if cfg.family == "hybrid":
        # both layer kinds' MLPs have one shape, so one split
        return ServeTP(mesh, embed, head, attention.head_tp(
            cfg, mesh, blocks["attn"]["mix"]),
            _mlp_tp(mesh, blocks["rec"]["mlp"]),
            rglru.channel_tp(cfg, mesh, blocks["rec"]["mix"]))
    mlp = (_mlp_tp(mesh, blocks["mlp"]) if cfg.family in ("dense", "vlm",
                                                           "audio")
           else None)
    return ServeTP(mesh, embed, head,
                   attention.head_tp(cfg, mesh, blocks["attn"]), mlp)


def _attn_mlp_block(cfg, layer_p, x, positions, window, cache_l=None,
                    decode=False, token_mask=None, block_lens=None,
                    block_tables=None, rows=None, kernels=True, mesh=None,
                    batch_axes=None, tp=None, cp=False, mrope_pos=None):
    """Attention (+ cache) and the MLP or MoE layer.  The attention step:
    with ``block_lens`` (lengths, seg_lens) the unified block step, over
    the paged pool when ``block_tables`` is given and the contiguous
    ``cache_l`` otherwise; with ``decode`` the one-token decode step
    (``positions`` are then the lengths); with ``cache_l`` alone the
    prefill that fills it (``rows``: the rows it writes); with no cache
    the full-sequence forward (``kernels=False``: through no kernel, the
    trainer's path).  On a ``mesh`` (the full-sequence forward) ``x`` is
    this rank's batch block over ``batch_axes`` and the MoE layer runs its
    expert-parallel schedule.  On a serving mesh (``tp``, a ``ServeTP``)
    ``x`` and the cache are this rank's rows, the cached steps run
    tensor-parallel over "model" and the MoE layer the schedule over the
    rank's rows; ``cp``: the contiguous cache is
    sequence-sharded (the decode is ``attn_decode_step_cp``).
    ``mrope_pos`` (B, T, 3): the tokens' M-RoPE positions (vlm), or None.
    Returns (x, aux, routed (B*T, K) or None but for the moe family); a
    cached step's MoE layer computes no aux (None)."""
    h = layers.norm_apply(cfg.norm, layer_p["ln1"], x)
    ap = layer_p["attn"]
    at = tp.attn if tp is not None else None
    if tp is not None:
        mesh = tp.mesh
    if cache_l is None:
        h = attention.attn_forward(ap, cfg, h, positions, window, kernels,
                                   mrope_pos)
    elif block_lens is not None and block_tables is not None:
        lengths, seg_lens = block_lens
        h = attention.attn_block_step_paged(
            ap, cfg, cache_l, h, positions, lengths, seg_lens, block_tables,
            window, at)
    elif block_lens is not None:
        lengths, seg_lens = block_lens
        h = attention.attn_block_step(ap, cfg, cache_l, h, positions,
                                      lengths, seg_lens, window, at,
                                      mrope_pos)
    elif decode and cp:
        h = attention.attn_decode_step_cp(ap, cfg, cache_l, h, positions,
                                          window, at, mrope_pos)
    elif decode:
        h = attention.attn_decode_step(ap, cfg, cache_l, h, positions, window,
                                       at, mrope_pos)
    else:
        h = attention.attn_prefill(ap, cfg, cache_l, h, positions, window,
                                   rows, at, cp, mrope_pos)
    x = x + h
    h = layers.norm_apply(cfg.norm, layer_p["ln2"], x)
    if cfg.family == "moe":
        moe_p = {"router": layer_p["router"], "experts": layer_p["experts"]}
        # the cached (serving) steps drop the aux loss: no mean of it
        h, aux, routed = expert_parallel.moe_layer(
            cfg, moe_p, h, token_mask, mesh=mesh, kernels=kernels,
            batch_axes=batch_axes, aux=cache_l is None)
    else:
        h = layers.mlp_apply(layer_p["mlp"], h, cfg.act,
                             tp.mlp if tp is not None else None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        routed = None
    return x + h, aux, routed


def paged_stack_cache_spec(cfg, num_pages: int, page_size: int, dtype,
                           heads: int | None = None):
    """Stacked paged pool: {"k", "v"} -> ((L, P, ps, Hkv, hd), dtype), and
    for an int8 cache {"k_scale", "v_scale"} -> ((L, P, ps, Hkv, 1), fp32);
    ``heads`` kv heads (all by default).  The stateful families keep their
    per-row state on the contiguous layout, as in the reference."""
    check_family(cfg)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged KV cache supports attention-cache families, not "
            f"{cfg.family!r}")
    per = attention.paged_layer_cache_spec(cfg, num_pages, page_size, dtype,
                                           heads)
    return {kk: ((cfg.num_layers,) + shape, dt)
            for kk, (shape, dt) in per.items()}


def init_paged_stack_cache(cfg, num_pages: int, page_size: int, dtype,
                           device, heads: int | None = None) -> dict:
    return {kk: torch.zeros(shape, dtype=dt, device=device)
            for kk, (shape, dt) in paged_stack_cache_spec(
                cfg, num_pages, page_size, dtype, heads).items()}


def _stacked(n: int, per: dict) -> dict:
    return {kk: ((n,) + shape, dt) for kk, (shape, dt) in per.items()}


def stack_cache_spec(cfg, batch: int, cache_len: int, dtype,
                     heads: int | None = None, seq_shards: int = 1,
                     channels: int | None = None):
    """Stacked contiguous cache: {"k", "v"} -> ((L, B, S, Hkv, hd), dtype)
    (+ int8 scales (L, B, S, Hkv, 1) fp32); ``heads`` kv heads (all by
    default) and S = cache_len / ``seq_shards`` (a sequence block).  As in
    the reference the cache is clipped to the effective window, which
    makes it a ring buffer.  ssm: {"conv", "ssm"} per layer; hybrid:
    {"rec": {"conv", "h"} of ``channels`` channels (all W by default),
    "attn": the attention cache of min(cache_len, window) slots (``heads``
    and ``seq_shards`` as above)}, each stacked over its layers.  The
    batch axis is 1 in every leaf."""
    check_family(cfg)
    if cfg.family == "ssm":
        return _stacked(cfg.num_layers,
                        mamba2.mamba_cache_spec(cfg, batch, dtype))
    if cfg.family == "hybrid":
        pat = hybrid_pattern(cfg)
        attn_len = min(cache_len, cfg.sliding_window or cache_len)
        return {"rec": _stacked(pat.count("rec"), rglru.rglru_cache_spec(
                    cfg, batch, dtype, channels)),
                "attn": _stacked(pat.count("attn"), attention.layer_cache_spec(
                    cfg, batch, attn_len // seq_shards, dtype, heads))}
    return _stacked(cfg.num_layers, attention.layer_cache_spec(
        cfg, batch, attn_cache_len(cfg, cache_len) // seq_shards, dtype,
        heads))


def attn_cache_len(cfg, cache_len: int) -> int:
    """The attention cache's length for a context of ``cache_len``:
    clipped to the effective window (a ring) where the window fits."""
    win = effective_window(cfg, cache_len)
    return min(cache_len, win) if win else cache_len


def _zeros(spec: dict, device) -> dict:
    return {kk: (_zeros(v, device) if isinstance(v, dict)
                 else torch.zeros(v[0], dtype=v[1], device=device))
            for kk, v in spec.items()}


def init_stack_cache(cfg, batch: int, cache_len: int, dtype, device,
                     heads: int | None = None, seq_shards: int = 1,
                     channels: int | None = None) -> dict:
    return _zeros(stack_cache_spec(cfg, batch, cache_len, dtype, heads,
                                   seq_shards, channels), device)


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


def forward_stack(cfg, blocks, x, positions, window, kernels=True,
                  mesh=None, batch_axes=None, specs=None, mrope_pos=None):
    """Run all layers over a full sequence with no cache.
    x: (B, S, D); positions: (B, S); ``mrope_pos`` (B, S, 3) or None.
    Returns (x, total aux loss, routing (L, B*S, K) int32, or None but for
    the moe family).
    ``kernels=False`` runs through no kernel (the trainer's path).  With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` (as the
    reference's ``jax.checkpoint``): a backward keeps only the layer
    inputs and recomputes the rest.

    On a ``mesh``, ``x`` is this rank's batch block over ``batch_axes``
    and every MoE layer runs ``cfg.expert_parallel`` across the ranks.
    The reference's ``seq_constrain`` (a Megatron-style sequence-sharding
    hint that changes no value) has no counterpart: the port keeps the
    residual stream replicated over the expert axis, and the schedules
    that shard the sequence gather it back (``expert_parallel``'s layout
    step).

    On a training mesh ``blocks`` are this rank's train blocks and
    ``specs`` their specs (``launch/sharding.train_specs``): each layer's
    weights are gathered for that layer alone (``sharding.compute_view``),
    inside the layer's checkpoint when ``cfg.remat`` is set, so a backward
    gathers them again instead of keeping them (ZeRO-3), and the
    gradients are reduced into the blocks."""
    b, s, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("hybrid", "ssm"):
        return _forward_families(cfg, blocks, x, positions, kernels, mesh,
                                 batch_axes, specs), aux, None
    routing = (torch.empty((cfg.num_layers, b * s, cfg.experts_per_token),
                           dtype=torch.int32, device=x.device)
               if cfg.family == "moe" else None)
    layer_specs = sharding.layer_spec(specs) if specs is not None else None

    def block(xx, lp):
        if layer_specs is not None:
            lp = sharding.compute_view(lp, layer_specs, mesh, batch_axes)
        return _attn_mlp_block(cfg, lp, xx, positions, window,
                               kernels=kernels, mesh=mesh,
                               batch_axes=batch_axes, mrope_pos=mrope_pos)
    for l in range(cfg.num_layers):
        if cfg.remat:
            x, a, routed = checkpoint(block, x, _layer(blocks, l),
                                      use_reentrant=False)
        else:
            x, a, routed = block(x, _layer(blocks, l))
        aux = aux + a
        if routing is not None:
            routing[l] = routed
    return x, aux, routing


# ---------------------------------------------------------------------------
# the stateful families (ssm, hybrid): the forward and the reference engine
# ---------------------------------------------------------------------------

def _write_state(cache_l: dict, new: dict, rows) -> None:
    """Copy the state ``new`` into the layer's cache leaves IN PLACE;
    ``rows`` (B,) bool limits the write to those rows (batch axis 0)."""
    for kk, v in new.items():
        dst = cache_l[kk]
        v = v.to(dst.dtype)
        if rows is not None:
            v = torch.where(rows.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                            dst)
        dst.copy_(v)


def _ssm_block(cfg, layer_p, x, cache_l=None, decode=False, rows=None):
    """Norm and the SSD block, residual added.  With ``cache_l``: the
    decode step or the prefill, its final state written IN PLACE.  The
    block is replicated on a serving mesh (the reference's serve rules
    cut none of its weights), so every rank runs it whole."""
    h = layers.norm_apply(cfg.norm, layer_p["ln"], x)
    if cache_l is None:
        return x + mamba2.mamba_forward(layer_p["mamba"], cfg, h)
    if decode:
        h, new = mamba2.mamba_decode_step(layer_p["mamba"], cfg, cache_l, h)
    else:
        h, new = mamba2.mamba_forward(layer_p["mamba"], cfg, h,
                                      state=cache_l)
    _write_state(cache_l, new, rows)
    return x + h


def _hybrid_block(cfg, layer_p, kind, x, positions, cache_l=None,
                  decode=False, rows=None, kernels=True, tp=None, cp=False):
    """Norm, the RG-LRU block or local attention (always the config's
    sliding window), residual, then norm, MLP, residual.  With ``cache_l``:
    the decode step (``positions`` are then the lengths) or the prefill;
    the recurrent state is written IN PLACE (the prefill starts from the
    cached one, as the reference's does), the attention cache by the
    attention steps.  ``kernels=False``: through no kernel.  On a serving
    mesh (``tp``, a ``ServeTP``) the RG-LRU runs this rank's channels,
    the attention its heads (``cp``: the attention cache is
    sequence-sharded and the decode is context-parallel), the MLP its
    columns of F."""
    h = layers.norm_apply(cfg.norm, layer_p["ln1"], x)
    mp, w = layer_p["mix"], cfg.sliding_window
    rec = tp.rec if tp is not None else None
    at = tp.attn if tp is not None else None
    if kind == "rec":
        if cache_l is None:
            h = rglru.rglru_forward(mp, cfg, h)
        else:
            step = (rglru.rglru_decode_step(mp, cfg, cache_l, h, rec)
                    if decode
                    else rglru.rglru_forward(mp, cfg, h, cache_l, rec))
            h = step[0]
            _write_state(cache_l, step[1], rows)
    elif cache_l is None:
        h = attention.attn_forward(mp, cfg, h, positions, w, kernels)
    elif decode and cp:
        h = attention.attn_decode_step_cp(mp, cfg, cache_l, h, positions, w,
                                          at)
    elif decode:
        h = attention.attn_decode_step(mp, cfg, cache_l, h, positions, w, at)
    else:
        h = attention.attn_prefill(mp, cfg, cache_l, h, positions, w, rows,
                                   at, cp)
    x = x + h
    h = layers.norm_apply(cfg.norm, layer_p["ln2"], x)
    return x + layers.mlp_apply(layer_p["mlp"], h, cfg.act,
                                tp.mlp if tp is not None else None)


def _family_layers(cfg, blocks, cache=None, specs=None):
    """(kind, the layer's parameters, its cache slice or None, its layer
    spec or None) for every layer of a stateful stack, in order (an ssm
    layer's kind is "ssm")."""
    if cfg.family == "ssm":
        sp = sharding.layer_spec(specs) if specs is not None else None
        for l in range(cfg.num_layers):
            yield ("ssm", _layer(blocks, l),
                   None if cache is None else _layer(cache, l), sp)
        return
    idx = {"rec": 0, "attn": 0}
    sps = ({k: sharding.layer_spec(specs[k]) for k in idx}
           if specs is not None else dict.fromkeys(idx))
    for kind in hybrid_pattern(cfg):
        i = idx[kind]
        idx[kind] += 1
        yield (kind, _layer(blocks[kind], i),
               None if cache is None else _layer(cache[kind], i), sps[kind])


def _family_block(cfg, kind, lp, x, positions, cache_l=None, decode=False,
                  rows=None, kernels=True, tp=None, cp=False):
    if kind == "ssm":
        return _ssm_block(cfg, lp, x, cache_l, decode, rows)
    return _hybrid_block(cfg, lp, kind, x, positions, cache_l, decode, rows,
                         kernels, tp, cp)


def _forward_families(cfg, blocks, x, positions, kernels, mesh=None,
                      batch_axes=None, specs=None):
    """The cache-free forward of a stateful stack, each layer under
    ``torch.utils.checkpoint`` when ``cfg.remat`` is set.  On a mesh ``x``
    is this rank's rows; on a training mesh (``specs``) each layer's
    weights are gathered for that layer (``sharding.compute_view``)."""
    for kind, lp, _, sp in _family_layers(cfg, blocks, specs=specs):
        def block(xx, lp, kind=kind, sp=sp):
            if sp is not None:
                lp = sharding.compute_view(lp, sp, mesh, batch_axes)
            return _family_block(cfg, kind, lp, xx, positions,
                                 kernels=kernels)
        x = (checkpoint(block, x, lp, use_reentrant=False) if cfg.remat
             else block(x, lp))
    return x


def _cached_families(cfg, blocks, x, cache, positions, decode, rows,
                     tp=None, cp=False):
    """Every layer of a stateful stack over ``cache`` (written IN PLACE)."""
    for kind, lp, cl, _ in _family_layers(cfg, blocks, cache=cache):
        x = _family_block(cfg, kind, lp, x, positions, cache_l=cl,
                          decode=decode, rows=rows, tp=tp, cp=cp)
    return x, None


def _cached_stack(cfg, blocks, x, cache, **block_kw):
    """Every layer over ``cache`` (layer l's slice written IN PLACE).
    Returns (x, routing (L, B*T, K) int32, or None for the dense
    family)."""
    b, t, _ = x.shape
    routing = (torch.empty((cfg.num_layers, b * t, cfg.experts_per_token),
                           dtype=torch.int32, device=x.device)
               if cfg.family == "moe" else None)
    for l in range(cfg.num_layers):
        cache_l = {kk: v[l] for kk, v in cache.items()}
        x, _, routed = _attn_mlp_block(cfg, _layer(blocks, l), x,
                                       cache_l=cache_l, **block_kw)
        if routing is not None:
            routing[l] = routed
    return x, routing


def unified_stack(cfg, blocks, x, positions, lengths, seg_lens, cache, window,
                  token_mask, block_tables=None, tp=None):
    """Token-block forward through all layers, over the paged pool
    (``block_tables`` (B, NB)) or the contiguous cache (None).

    x: (B, T, D); positions: (B, T) absolute; lengths/seg_lens: (B,).
    Layer l writes ``cache[..][l]`` IN PLACE.  Returns (x, routing (L,
    B*T, K) int32, None for the dense family) — invalid tokens read the
    E_pad sentinel."""
    return _cached_stack(cfg, blocks, x, cache, positions=positions,
                         window=window, token_mask=token_mask,
                         block_lens=(lengths, seg_lens),
                         block_tables=block_tables, tp=tp)


def prefill_stack(cfg, blocks, x, positions, cache, window, token_mask=None,
                  rows=None, tp=None, cp=False, mrope_pos=None):
    """Full-sequence forward that fills the contiguous cache IN PLACE (the
    reference engine's prefill); ``rows`` (B,) bool: the rows it writes;
    ``mrope_pos`` (B, S, 3) or None.  Returns (x, routing (L, B*S, K) or
    None)."""
    if cfg.family in ("hybrid", "ssm"):
        return _cached_families(cfg, blocks, x, cache, positions, False,
                                rows, tp, cp)
    return _cached_stack(cfg, blocks, x, cache, positions=positions,
                         window=window, token_mask=token_mask, rows=rows,
                         tp=tp, cp=cp, mrope_pos=mrope_pos)


def decode_stack(cfg, blocks, x, lengths, cache, window, token_mask=None,
                 tp=None, cp=False, mrope_pos=None):
    """One-token decode through all layers: x (B, 1, D) at positions
    ``lengths`` (M-RoPE: ``mrope_pos`` (B, 1, 3)), written IN PLACE into
    the contiguous cache.  Returns (x, routing (L, B, K) or None)."""
    if cfg.family in ("hybrid", "ssm"):
        return _cached_families(cfg, blocks, x, cache, lengths, True, None,
                                tp, cp)
    return _cached_stack(cfg, blocks, x, cache, positions=lengths,
                         window=window, decode=True, token_mask=token_mask,
                         tp=tp, cp=cp, mrope_pos=mrope_pos)
