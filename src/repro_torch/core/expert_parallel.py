"""Expert-parallel execution of one MoE layer (the JAX package's
``core/expert_parallel.py``): on one device, or across a mesh of rank
processes under one of four collective schedules (paper §5):

* ``centralized``   — the paper's naive organization (Fig. 3): the token
  block is all-gathered to every expert shard (comm 1) and the partial
  expert outputs are reduce-scattered back (comm 2);
* ``decentralized`` — the paper's P-*-D design (Fig. 7): attention and
  router replicated over the expert axis, experts sharded, one all-reduce
  of the expert outputs; with ``expert_replication`` r > 1 every expert
  lives on r shards, each serving the token stripe ``t % r`` (§5.3);
* ``a2a``           — tokens sequence-sharded, dispatch and combine by
  all-to-all, so only the routed activations move;
* ``a2a_pipelined`` — a2a over ``ep_microchunks`` chunks, chunk i+1's
  dispatch all-to-all in flight (``async_op``) while chunk i's expert FFN
  runs.

The reference's fallbacks are semantics and are ported as they are: a2a
and a2a_pipelined on single-token decode take the decentralized schedule,
a2a_pipelined with an m that does not divide T_loc takes a2a, centralized
with S % n != 0 takes psum plus a value-preserving ring permute.

The rank layout (``launch/mesh.py``).  The reference's ``shard_map`` bodies
receive per-device blocks of global arrays; the port is SPMD over ranks,
and on a mesh ``moe_layer`` is called with THIS RANK's blocks:

* ``x`` (B_loc, S, D): the rank's batch shard over ``batch_axes`` (the
  whole batch when the data axes do not divide B, as the reference
  decides; ``batch_shard``), the full sequence, replicated over the expert
  axis;
* ``layer_p["router"]`` whole; ``layer_p["experts"]`` the rank's rows of
  the (r-copy) expert stack (``expert_shard``), QuantTensor payload and
  scales sliced together.

The centralized and a2a schedules cut their sequence block from the
replicated ``x`` by expert rank and compute the block the reference's body
returns.  A layout step (``_unshard_seq``) then gathers the blocks back
over the expert axis, so that the next layer's replicated attention sees
the whole sequence: it stands in for the resharding GSPMD inserts in the
reference, is not part of the schedule, and its bytes are counted under
``collectives.LAYOUT``, apart from the schedule's.

Under autograd (training on a mesh, ``kernels=False``) every schedule is
differentiable and its forward values are the same: the collectives take
their transposes in the backward (``core/collectives``), and wherever a
value that every expert rank holds alike (x, the router weight, the
router's combine weights) enters per-rank work it passes
``collectives.enter``, whose backward sums the ranks' partial cotangents
over the expert axis, so the router and everything upstream get their
whole gradient.  The layout step's gather is ``invariant``: its result is
one value on every rank, and its backward keeps this rank's block.  Under
autograd a2a_pipelined's dispatch completes in the call (the same values;
the overlap is the forward-only path's).

Quantized expert shards ride every schedule unchanged; activations stay
fp and only fp activations move.  The collectives are
``core/collectives``'s, over the mesh's gloo groups: on the card each
operand goes through pinned host memory (``launch/mesh.py`` says why),
while the router, the dispatch and the grouped-FFN kernel run on the
card in every rank.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives
from repro_torch.core import moe as moe_lib
from repro_torch.core import router as router_lib
from repro_torch.core.quant import QuantTensor

EXPERT_AXIS = "model"


def mesh_batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axes_size(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def batch_split(mesh, b: int) -> tuple[str, ...]:
    """The axes a global batch of ``b`` rows is split over.  As in the
    reference, the batch is split over every data axis when they divide
    it, and over none (every rank holds it whole) otherwise.  Reads only
    ``mesh.axis_names`` and ``mesh.shape`` (``launch/sharding``'s specs
    take the same rule)."""
    axes = mesh_batch_axes(mesh)
    return axes if b % max(_axes_size(mesh, axes), 1) == 0 else ()


def batch_shard(mesh, b: int) -> tuple[tuple[str, ...], slice]:
    """(the axes a global batch of ``b`` rows is split over
    (``batch_split``), this rank's rows)."""
    axes = batch_split(mesh, b)
    if not axes:
        return (), slice(0, b)
    n = _axes_size(mesh, axes)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return axes, slice(idx * (b // n), (idx + 1) * (b // n))


def batch_unshard(mesh, x: torch.Tensor, b: int,
                  kind: str = collectives.ROWS) -> torch.Tensor:
    """The inverse of ``batch_shard`` for a global batch of ``b`` rows:
    ``x``, this rank's rows along dim 0, gathered over the axes that cut
    them, so every rank holds all ``b`` (the innermost axis first, since
    the blocks are numbered row-major over them); ``x`` itself where the
    rows are not cut."""
    for axis in reversed(batch_split(mesh, b)):
        x = collectives.all_gather(x, mesh, axis, dim=0, kind=kind)
    return x


def expert_rows(cfg, mesh) -> slice:
    """This rank's rows of the r-copy expert stack (E_pad * r rows):
    ``e_local`` rows from ``idx * e_local``, as the reference's
    ``_expert_specs`` shard them."""
    n = mesh.shape[EXPERT_AXIS]
    r = max(cfg.expert_replication, 1)
    e_local = cfg.num_experts_padded * r // n
    idx = mesh.coords[EXPERT_AXIS]
    return slice(idx * e_local, (idx + 1) * e_local)


def expert_shard(cfg, experts: dict, mesh) -> dict:
    """This rank's copy of its rows of every expert leaf, the expert axis
    third from last ((E, D, F) per layer or (L, E, D, F) stacked).  The
    copies are the rank's own, so the whole stack can be freed."""
    rows = (Ellipsis, expert_rows(cfg, mesh), slice(None), slice(None))

    def cut(w):
        if isinstance(w, QuantTensor):
            return QuantTensor(w.data[rows].clone(), w.scale[rows].clone(),
                               w.bits, w.block, w.orig_dim, w.out_dtype)
        return w[rows].clone()
    return {k: cut(w) for k, w in experts.items()}


def _local_moe(cfg, experts: dict, x2d: torch.Tensor,
               rout: router_lib.RouterOut, e_start: int, capacity: int,
               kernels: bool = True) -> torch.Tensor:
    """This rank's experts over x2d, ``capacity`` slots per expert."""
    if cfg.moe_strategy == "dense":
        return moe_lib.dense_moe(experts, x2d, rout.top_idx, rout.top_w,
                                 e_start, kernels)
    t, k = rout.top_idx.shape
    e_local = experts["w_gate"].shape[0]
    if 0 < t * k <= cfg.gather_decode_max_tk:
        # capacity-free decode fast path, form chosen by modelled cost:
        # per-token gather when T*K <= E_local (reads < one local shard of
        # weights), one-hot dense when T is below the capacity floor
        if t * k <= e_local:
            return moe_lib.gather_moe(experts, x2d, rout.top_idx, rout.top_w,
                                      e_start)
        if t < capacity:
            return moe_lib.dense_moe(experts, x2d, rout.top_idx, rout.top_w,
                                     e_start, kernels)
    return moe_lib.dispatch_moe(experts, x2d, rout.top_idx, rout.top_w,
                                cfg.num_experts_padded, e_start, capacity,
                                kernels)


def _mask_rout(rout: router_lib.RouterOut, valid: torch.Tensor,
               e_pad: int) -> router_lib.RouterOut:
    """Dead-route invalid tokens: padding rows consume no expert capacity
    and contribute zero (their routing reads the E_pad sentinel)."""
    top_idx = torch.where(valid[:, None], rout.top_idx, e_pad)
    top_w = torch.where(valid[:, None], rout.top_w, 0.0)
    return rout._replace(top_idx=top_idx, top_w=top_w)


def _route(cfg, layer_p, x2d, valid, mesh=None) -> router_lib.RouterOut:
    """The router over x2d, dead-routing invalid tokens; with ``mesh`` the
    tokens are this rank's own (a sequence block, a gathered block), so
    the router weight enters per-rank work (``collectives.enter``)."""
    w = layer_p["router"]
    if mesh is not None:
        w = collectives.enter(w, mesh, EXPERT_AXIS)
    rout = router_lib.route(w, x2d, cfg.experts_per_token,
                            norm_topk=cfg.router_norm_topk,
                            n_valid_experts=cfg.num_experts)
    return _mask_rout(rout, valid, cfg.num_experts_padded)


def moe_layer(cfg, layer_p: dict, x: torch.Tensor,
              token_mask: torch.Tensor | None = None, mesh=None,
              kernels: bool = True, batch_axes: tuple | None = None,
              aux: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux_loss (), top_idx (B*S, K)).

    ``layer_p``: {"router": (D, E_pad), "experts": {"w_gate": (E_pad, D, F),
    "w_up": ..., "w_down": (E_pad, F, D)}} (r x E_pad rows with
    ``expert_replication`` r).  ``token_mask`` (B, S) bool: False tokens
    are dead-routed to E_pad.  ``kernels=False``: the expert FFN takes the
    reference's jnp branch (``moe.expert_ffn``), the trainer's path.

    On a ``mesh`` with an expert axis, ``x`` and ``token_mask`` are this
    rank's batch block, split over ``batch_axes`` (default: every data
    axis), and ``layer_p["experts"]`` holds this rank's rows
    (``expert_shard``); the result is this rank's block, the whole
    sequence, and ``aux`` the global aux loss.  ``top_idx`` is the
    pre-stripe routing decision with r > 1.  The rank's block is planned
    with its own capacity (and its own replica stripes and pipeline
    chunks), as the reference's ``shard_map`` plans each device's block.

    ``aux=False`` (the serving paths, which drop the aux loss): no
    schedule takes its mean over the mesh, and ``aux_loss`` is None."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    r = max(cfg.expert_replication, 1)
    if mesh is None or EXPERT_AXIS not in mesh.axis_names:
        experts = layer_p["experts"]
        if r > 1:
            # overlapping placement stores r copies of the stack; one device
            # uses the first (QuantTensor leaves slice payload and scales)
            experts = {kk: w[:cfg.num_experts_padded]
                       for kk, w in experts.items()}
        x2d = x.reshape(b * s, d)
        rout = router_lib.route(layer_p["router"], x2d, k,
                                norm_topk=cfg.router_norm_topk,
                                n_valid_experts=cfg.num_experts)
        if token_mask is not None:
            rout = _mask_rout(rout, token_mask.reshape(b * s),
                              cfg.num_experts_padded)
        cap = moe_lib.round_capacity(b * s, k, cfg.num_experts_padded,
                                     cfg.capacity_factor)
        y = _local_moe(cfg, experts, x2d, rout, 0, cap, kernels)
        return (y.reshape(b, s, d), rout.aux_loss if aux else None,
                rout.top_idx)

    n_exp_shards = mesh.shape[EXPERT_AXIS]
    if r > 1:
        if cfg.expert_parallel != "decentralized":
            raise ValueError("overlapping expert placement (paper §5.3) is "
                             "implemented on the decentralized schedule")
        if n_exp_shards % r or (cfg.num_experts_padded * r) % n_exp_shards:
            raise ValueError(f"replication r={r} needs n_exp_shards "
                             f"{n_exp_shards} divisible by r and E_pad * r "
                             f"divisible by n_exp_shards")
    e_local = cfg.num_experts_padded * r // n_exp_shards
    if layer_p["experts"]["w_gate"].shape[0] != e_local:
        raise ValueError(f"on a mesh the experts are this rank's "
                         f"{e_local} rows (expert_shard), got "
                         f"{layer_p['experts']['w_gate'].shape[0]}")
    if batch_axes is None:
        batch_axes = mesh_batch_axes(mesh)
    if token_mask is None:
        token_mask = torch.ones((b, s), dtype=torch.bool, device=x.device)
    # each schedule returns (y, its router output, the axes its aux-loss
    # mean runs over, top_idx)
    fn = {"decentralized": _decentralized, "centralized": _centralized,
          "a2a": _a2a, "a2a_pipelined": _a2a_pipelined}[cfg.expert_parallel]
    y, rout, aux_axes, top_idx = fn(cfg, mesh, layer_p, x, token_mask,
                                    tuple(batch_axes), n_exp_shards,
                                    e_local, kernels)
    aux_loss = None
    if aux:
        aux_loss = (collectives.pmean(rout.aux_loss, mesh, aux_axes)
                    if aux_axes else rout.aux_loss)
    if y.shape[1] != s:
        y, top_idx = _unshard_seq(mesh, y, top_idx)
    return y, aux_loss, top_idx.reshape(b * s, k)


def _unshard_seq(mesh, y: torch.Tensor, top_idx: torch.Tensor):
    """The layout step: the sequence blocks of y (B_loc, S/n, D) and
    top_idx (B_loc, S/n, K) gathered over the expert axis, so the
    residual stream stays replicated there.  In the reference GSPMD
    reshards the schedule's sequence-sharded output (``seq_constrain`` is
    a layout hint there); here it is one all-gather of each, counted under
    ``collectives.LAYOUT``."""
    y = collectives.all_gather(y, mesh, EXPERT_AXIS, dim=1,
                               kind=collectives.LAYOUT, invariant=True)
    top_idx = collectives.all_gather(top_idx.to(torch.int32), mesh,
                                     EXPERT_AXIS, dim=1,
                                     kind=collectives.LAYOUT)
    return y, top_idx.long()


def _seq_block(mesh, t: torch.Tensor, n: int) -> torch.Tensor:
    """This expert rank's block of the sequence axis (dim 1)."""
    sl = t.shape[1] // n
    idx = mesh.coords[EXPERT_AXIS]
    return t[:, idx * sl:(idx + 1) * sl]


# ---------------------------------------------------------------------------
# decentralized (paper Fig. 7): replicated tokens, sharded experts, one psum
# ---------------------------------------------------------------------------

def _enter_local(mesh, x2d, rout):
    """x2d and the combine weights, the same on every expert rank, as the
    inputs of this rank's experts."""
    return (collectives.enter(x2d, mesh, EXPERT_AXIS),
            rout._replace(top_w=collectives.enter(rout.top_w, mesh,
                                                  EXPERT_AXIS)))


def _decentralized(cfg, mesh, layer_p, x, token_mask, batch_axes, n_shards,
                   e_local, kernels):
    """Paper Fig. 7, plus the §5.3 overlapping placement: with r > 1 each
    replica handles the 1/r token stripe ``t % r == replica``."""
    bl, sl, d = x.shape
    r = max(cfg.expert_replication, 1)
    t_loc = max(bl * sl, 1)
    cap = moe_lib.round_capacity(-(-t_loc // r), cfg.experts_per_token,
                                 cfg.num_experts_padded, cfg.capacity_factor)
    e_pad = cfg.num_experts_padded
    n_grp = n_shards // r           # shards per expert copy
    x2d = x.reshape(bl * sl, d)
    rout = _route(cfg, layer_p, x2d, token_mask.reshape(bl * sl))
    routed = rout.top_idx            # pre-stripe: actual decisions
    x2d, rout = _enter_local(mesh, x2d, rout)
    idx = mesh.coords[EXPERT_AXIS]
    if r > 1:
        replica = idx // n_grp
        e_start = (idx % n_grp) * e_local
        stripe = (torch.arange(bl * sl, device=x.device) % r) == replica
        # tokens outside this replica's stripe route to a dead sentinel
        rout = rout._replace(
            top_idx=torch.where(stripe[:, None], rout.top_idx, e_pad),
            top_w=torch.where(stripe[:, None], rout.top_w, 0.0))
    else:
        e_start = idx * e_local
    y = _local_moe(cfg, layer_p["experts"], x2d, rout, e_start, cap, kernels)
    y = collectives.psum(y, mesh, EXPERT_AXIS)
    return (y.reshape(bl, sl, d), rout, batch_axes,
            routed.reshape(bl, sl, cfg.experts_per_token))


# ---------------------------------------------------------------------------
# centralized (paper Fig. 3): 2 communications per layer
# ---------------------------------------------------------------------------

def _centralized(cfg, mesh, layer_p, x, token_mask, batch_axes, n_shards,
                 e_local, kernels):
    bl, s, d = x.shape
    k = cfg.experts_per_token
    cap = moe_lib.round_capacity(max(bl * s, 1), k,
                                 cfg.num_experts_padded, cfg.capacity_factor)
    idx = mesh.coords[EXPERT_AXIS]
    e_start = idx * e_local
    if s % n_shards == 0:
        # comm 1: gather the token block AND its mask to every expert shard
        x_full = collectives.all_gather(
            _seq_block(mesh, collectives.enter(x, mesh, EXPERT_AXIS),
                       n_shards), mesh, EXPERT_AXIS, dim=1)
        tm_full = collectives.all_gather(
            _seq_block(mesh, token_mask, n_shards), mesh, EXPERT_AXIS, dim=1)
        x2d = x_full.reshape(bl * s, d)
        rout = _route(cfg, layer_p, x2d, tm_full.reshape(bl * s), mesh)
        y = _local_moe(cfg, layer_p["experts"], x2d, rout, e_start, cap,
                       kernels)
        # comm 2: reduce the partial sums, scatter back to sequence shards
        y = collectives.psum_scatter(y.reshape(bl, s, d), mesh, EXPERT_AXIS,
                                     dim=1)
        # every shard routed the whole gathered block: keep its own slice
        ti = _seq_block(mesh, rout.top_idx.reshape(bl, s, k), n_shards)
        return y, rout, (EXPERT_AXIS,) + batch_axes, ti

    # decode fallback: psum (comm 1) + value-preserving ring permute (comm 2)
    x2d = x.reshape(bl * s, d)
    rout = _route(cfg, layer_p, x2d, token_mask.reshape(bl * s))
    top_idx = rout.top_idx
    x2d, rout = _enter_local(mesh, x2d, rout)
    y = _local_moe(cfg, layer_p["experts"], x2d, rout, e_start, cap, kernels)
    y = collectives.psum(y, mesh, EXPERT_AXIS)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    y = collectives.ppermute(y, mesh, EXPERT_AXIS, perm)  # identical values
    return y.reshape(bl, s, d), rout, batch_axes, top_idx.reshape(bl, s, k)


# ---------------------------------------------------------------------------
# a2a (beyond paper): sequence-sharded tokens + all_to_all dispatch/combine
# ---------------------------------------------------------------------------

def _a2a_dispatch(cfg, mesh, xi, ti, n_shards, e_local, cap,
                  async_op=False):
    """Token-block dispatch: capacity plan + gather + all_to_all (comm 1).
    The plan builds buffers for ALL experts grouped by owner shard, so
    shard i's block j travels to shard j.  Returns the post-exchange
    (n_src, e_local*cap, d) buffer of local-expert inputs (a ``Pending``
    with ``async_op``) and ``slot_of`` for the combine."""
    dd = xi.shape[-1]
    dispatch_tok, slot_valid, slot_of = moe_lib.make_dispatch_plan(
        ti, cfg.num_experts_padded, 0, cfg.num_experts_padded, cap)
    xe = moe_lib.dispatch_rows(xi, dispatch_tok, slot_valid, slot_of)
    xe = xe.reshape(n_shards, e_local * cap, dd)
    return (collectives.all_to_all(xe, mesh, EXPERT_AXIS, async_op),
            slot_of)


def _a2a_ffn_combine(cfg, mesh, experts, xe, slot_of, wi, n_shards, e_local,
                     cap, kernels):
    """Token-block compute: expert FFN + return all_to_all (comm 2) +
    weighted combine back into source-token order."""
    dd = xe.shape[-1]
    xe = xe.transpose(0, 1).reshape(e_local, n_shards * cap, dd)
    ye = moe_lib.expert_ffn(experts, xe, kernels)
    # invert (e_local, cap*n_src) -> (n_src, e_local*cap) exactly
    ye = ye.reshape(e_local, cap, n_shards, dd).permute(2, 0, 1, 3)
    ye = ye.reshape(n_shards, e_local * cap, dd)
    ye = collectives.all_to_all(ye, mesh, EXPERT_AXIS)
    y_tk = moe_lib.combine_rows(ye.reshape(n_shards * e_local * cap, dd),
                                slot_of)
    return torch.einsum("tk,tkd->td", wi.to(y_tk.dtype), y_tk)


def _a2a(cfg, mesh, layer_p, x, token_mask, batch_axes, n_shards, e_local,
         kernels):
    bl, s, d = x.shape
    if s % n_shards != 0:
        # single-token decode: fall back to the decentralized schedule
        return _decentralized(cfg, mesh, layer_p, x, token_mask, batch_axes,
                              n_shards, e_local, kernels)
    t_loc = bl * (s // n_shards)
    # per-(source shard, expert) capacity
    cap = moe_lib.round_capacity(max(t_loc, 1),
                                 cfg.experts_per_token,
                                 cfg.num_experts_padded, cfg.capacity_factor)
    x_loc = _seq_block(mesh, collectives.enter(x, mesh, EXPERT_AXIS),
                       n_shards)
    x2d = x_loc.reshape(t_loc, d)
    rout = _route(cfg, layer_p, x2d,
                  _seq_block(mesh, token_mask, n_shards).reshape(t_loc), mesh)
    xe, slot_of = _a2a_dispatch(cfg, mesh, x2d, rout.top_idx, n_shards,
                                e_local, cap)
    y = _a2a_ffn_combine(cfg, mesh, layer_p["experts"], xe, slot_of,
                         rout.top_w, n_shards, e_local, cap, kernels)
    return (y.reshape(bl, s // n_shards, d), rout, (EXPERT_AXIS,) + batch_axes,
            rout.top_idx.reshape(bl, s // n_shards, cfg.experts_per_token))


# ---------------------------------------------------------------------------
# a2a_pipelined: microchunked a2a with comm/compute overlap
# ---------------------------------------------------------------------------

def _a2a_pipelined(cfg, mesh, layer_p, x, token_mask, batch_axes, n_shards,
                   e_local, kernels):
    """Software-pipelined a2a: the local token block is split into
    ``cfg.ep_microchunks`` chunks; chunk i+1's dispatch all-to-all is issued
    (``async_op``) before chunk i's expert FFN and combine, the order of the
    reference's double-buffered ``lax.scan``, so the exchange runs while the
    card computes.  Per-chunk capacity is ``round_capacity(T_loc/m)``, so
    routing and per-slot contractions equal ``a2a``'s whenever capacity is
    not binding.  Falls back to ``_a2a`` when the chunk split does not
    divide, which itself falls back to ``_decentralized`` for single-token
    decode."""
    bl, s, d = x.shape
    if s % n_shards != 0:
        return _decentralized(cfg, mesh, layer_p, x, token_mask, batch_axes,
                              n_shards, e_local, kernels)
    m = max(cfg.ep_microchunks, 1)
    t_loc = bl * (s // n_shards)
    if m <= 1 or t_loc % m != 0 or t_loc // m < 1:
        return _a2a(cfg, mesh, layer_p, x, token_mask, batch_axes, n_shards,
                    e_local, kernels)
    k = cfg.experts_per_token
    # per-(source shard, chunk, expert) capacity
    cap = moe_lib.round_capacity(t_loc // m, k, cfg.num_experts_padded,
                                 cfg.capacity_factor)
    x2d = _seq_block(mesh, collectives.enter(x, mesh, EXPERT_AXIS),
                     n_shards).reshape(t_loc, d)
    rout = _route(cfg, layer_p, x2d,
                  _seq_block(mesh, token_mask, n_shards).reshape(t_loc), mesh)
    tc = t_loc // m
    xc = x2d.reshape(m, tc, d)
    ic = rout.top_idx.reshape(m, tc, k)
    wc = rout.top_w.reshape(m, tc, k)
    dispatch = lambda i: _a2a_dispatch(cfg, mesh, xc[i], ic[i], n_shards,
                                       e_local, cap, async_op=True)
    pending, slot_of = dispatch(0)
    ys = []
    for i in range(m):
        xe_i, so_i = pending.wait(), slot_of
        if i + 1 < m:
            pending, slot_of = dispatch(i + 1)     # comm for chunk i+1
        ys.append(_a2a_ffn_combine(cfg, mesh, layer_p["experts"], xe_i,
                                   so_i, wc[i], n_shards, e_local, cap,
                                   kernels))       # compute for chunk i
    y = torch.cat(ys, dim=0)
    return (y.reshape(bl, s // n_shards, d), rout, (EXPERT_AXIS,) + batch_axes,
            rout.top_idx.reshape(bl, s // n_shards, k))
