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

``attn_forward`` is the full-sequence forward with no cache: by default
the port of the reference's ``use_flash_kernel`` branch, causal
(optionally windowed) attention through ``kernels/ops.flash_attention`` on
the unrepeated K/V; with ``kernels=False`` (the trainer's path) the
reference's jnp branches, ``attend`` / ``attend_chunked`` over repeated
K/V, which autograd differentiates.

The contiguous cache is ``(B, S, Hkv, hd)`` per layer (int8: payload plus
``(B, S, Hkv, 1)`` fp32 scales), one row per decode slot.  Three steps
write it IN PLACE: ``attn_block_step`` (the unified step's contiguous
form), ``attn_decode_step`` and ``attn_prefill`` (the two-program
reference engine's).  The reference computes them in jnp with no Pallas
kernel, and so does the port in torch ops: ``attend`` /
``attend_chunked`` over repeated K/V for the prefill and
``_attend_grouped_block`` for the cached steps.  Where JAX clamps an
update's start (``dynamic_update_slice``) or drops an out-of-bounds
scatter, the port clamps or keeps the old value explicitly, with integer
indices only (no boolean-mask indexing, which syncs the host).

A cache whose length equals the window is a ring buffer: position p lives
at slot p % cache_len.  The decode step writes at ``lengths % cache_len``
and attends every slot written so far; the unified block step takes only
width-1 blocks on a ring (the reference's refusal: a wider block written
into a wrapped ring before attention would overwrite keys that earlier
tokens of the block still see); the prefill keeps the last cache_len
tokens, rolled into place.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives, quant
from repro_torch.kernels import ops
from repro_torch.launch import sharding
from repro_torch.models import layers

TP_AXIS = "model"

NEG_INF = -1e9   # the reference's mask constant for its jnp attention paths
# attn_prefill switches to chunked attention at or above this S
CHUNK_THRESHOLD = 2048
Q_CHUNK = 2048
K_CHUNK = 1024


def attn_init(gen: torch.Generator, cfg, dtype, lead: tuple = (),
              keep: dict | None = None) -> dict:
    """Attention weights, optionally stacked along ``lead`` (layers);
    ``keep``: each projection's block to store (``layers.dense_init``;
    biases and norms are replicated in every mode)."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    keep = keep or {}
    p = {
        "wq": layers.dense_init(gen, d, hq * hd, dtype, lead, keep.get("wq")),
        "wk": layers.dense_init(gen, d, hkv * hd, dtype, lead,
                                keep.get("wk")),
        "wv": layers.dense_init(gen, d, hkv * hd, dtype, lead,
                                keep.get("wv")),
        "wo": layers.dense_init(gen, hq * hd, d, dtype, lead, keep.get("wo")),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (hq * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (hkv * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=dev)
    return p


@dataclasses.dataclass(frozen=True)
class HeadTP:
    """This rank's share of every attention layer on a serving mesh, read
    from the serve-mode specs of ``wq``, ``wk``/``wv`` and ``wo``
    (``launch/sharding.params_pspec(mode="serve")``), tensor-parallel over
    "model":

    * ``q_split``: ``wq`` by heads, this rank's q heads ``[q0, q0 + hq)``
      (else all of them);
    * ``kv``: ``wk``/``wv`` by ``"heads"``, by the ``"flat"`` Hkv*hd
      dimension (the new k/v are gathered whole before qk-norm and RoPE,
      which act on whole heads: the reference's ``head_constrain``), or
      ``"none"``;
    * ``kv0``/``hkv``: the kv heads this rank's q heads read, which its
      page pool and contiguous cache hold;
    * ``wo_split``: ``wo`` by rows, a partial product per rank summed by a
      psum; else whole, after the heads are gathered."""
    mesh: object
    q_split: bool
    q0: int
    hq: int
    kv: str
    kv0: int
    hkv: int
    wo_split: bool


def head_tp(cfg, mesh, spec: dict) -> HeadTP:
    """The ``HeadTP`` of this rank from the attention specs ``spec``."""
    n, c = mesh.shape[TP_AXIS], mesh.coords[TP_AXIS]
    hq_all, hkv_all = cfg.num_heads, cfg.num_kv_heads
    q_split = sharding.split(spec["wq"], -1)
    hq = hq_all // n if q_split else hq_all
    q0 = c * hq if q_split else 0
    kv = ("none" if not sharding.split(spec["wk"], -1)
          else "heads" if hkv_all % n == 0 else "flat")
    g = hq_all // hkv_all
    kv0 = q0 // g
    hkv = (q0 + hq - 1) // g + 1 - kv0
    ok = hq % hkv == 0 and all((q0 + j) // g - kv0 == j // (hq // hkv)
                               for j in range(hq))
    if kv == "heads":
        ok = ok and (kv0, hkv) == (c * hkv_all // n, hkv_all // n)
    if not ok:
        raise ValueError(f"q heads [{q0}, {q0 + hq}) of {cfg.name} do not "
                         f"map onto whole kv heads on {n} ranks")
    return HeadTP(mesh, q_split, q0, hq, kv, kv0, hkv,
                  sharding.split(spec["wo"], -2))


def _cols(t: torch.Tensor, tp: HeadTP | None, cut: bool) -> torch.Tensor:
    """This rank's block of a replicated bias whose weight's columns are
    split over "model"."""
    if tp is None or not cut:
        return t
    return t.chunk(tp.mesh.shape[TP_AXIS], -1)[tp.mesh.coords[TP_AXIS]]


def _project_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                 tp: HeadTP | None = None, mrope_positions=None):
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd), qk-normed and rotated, in
    the reference's order: M-RoPE at ``mrope_positions`` (B, S, 3) when
    the config has it and they are given, else RoPE at ``positions`` when
    the config uses it, else no rotation (sinusoidal positions, added to
    the embeddings).  On a serving mesh: this rank's q heads and its kv
    heads (``"heads"``), or every kv head (``"flat"``, gathered;
    ``"none"``)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = (quant.qdot(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + _cols(p["bq"], tp, tp is not None and tp.q_split)
        cut_kv = tp is not None and tp.kv != "none"
        k, v = k + _cols(p["bk"], tp, cut_kv), v + _cols(p["bv"], tp, cut_kv)
    if tp is not None and tp.kv == "flat":
        k = collectives.all_gather(k, tp.mesh, TP_AXIS, dim=-1)
        v = collectives.all_gather(v, tp.mesh, TP_AXIS, dim=-1)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(p["q_norm"], q)
        k = layers.rms_norm(p["k_norm"], k)
    if cfg.mrope and mrope_positions is not None:
        q = layers.apply_mrope(q, mrope_positions, cfg.rope_theta,
                               cfg.mrope_sections)
        k = layers.apply_mrope(k, mrope_positions, cfg.rope_theta,
                               cfg.mrope_sections)
    elif cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _used(t: torch.Tensor, tp: HeadTP | None) -> torch.Tensor:
    """The kv heads this rank's q heads read, of k or v from
    ``_project_qkv``."""
    if tp is None or tp.kv == "heads":
        return t
    return t[:, :, tp.kv0:tp.kv0 + tp.hkv]


def _all_heads(t: torch.Tensor, tp: HeadTP, cut: bool) -> torch.Tensor:
    """Every head of (B, S, H_loc, hd), gathered over "model" when the
    heads are split (the context-parallel paths' replicated operands)."""
    return collectives.all_gather(t, tp.mesh, TP_AXIS, dim=2) if cut else t


def _out_proj(p: dict, out: torch.Tensor, tp: HeadTP | None) -> torch.Tensor:
    """``wo`` over the attention output (B, T, H, hd) of this rank's q
    heads: a partial product and a psum where ``wo``'s rows are split, the
    whole product over every head otherwise."""
    b, t = out.shape[:2]
    if tp is not None and not tp.wo_split:
        out = _all_heads(out, tp, tp.q_split)
    y = quant.qdot(out.reshape(b, t, -1), p["wo"])
    if tp is not None and tp.wo_split:
        y = collectives.psum(y, tp.mesh, TP_AXIS)
    return y


def kv_quantized(cfg) -> bool:
    if cfg.kv_cache_dtype not in ("native", "int8"):
        raise ValueError(f"unknown kv_cache_dtype {cfg.kv_cache_dtype!r}")
    return cfg.kv_cache_dtype == "int8"


def paged_layer_cache_spec(cfg, num_pages: int, page_size: int, dtype,
                           heads: int | None = None):
    """Per-layer paged pool of ``heads`` kv heads (all by default): {"k",
    "v"} (+ {"k_scale", "v_scale"} for an int8 cache) -> (shape, dtype)."""
    shape = (num_pages, page_size, heads or cfg.num_kv_heads, cfg.head_dim)
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
                          window: int | None,
                          tp: HeadTP | None = None) -> torch.Tensor:
    """Cached attention of a (B, T) token block over one layer's page pool.

    Row b's token j sits at absolute position ``positions[b, j] ==
    lengths[b] + j`` and is valid when ``j < seg_lens[b]``.  Valid tokens
    write their K/V IN PLACE at page ``block_tables[b, pos // ps]`` slot
    ``pos % ps`` of ``cache["k"]`` / ``cache["v"]`` (an int8 cache writes
    payload and scales); invalid tokens and positions past the table write
    nothing.  Attention then walks the block table.
    x: (B, T, D) -> (B, T, D).  On a serving mesh (``tp``) the pool holds
    this rank's kv heads and the kernel runs its q heads."""
    b, t, _ = x.shape
    page_size = cache["k"].shape[1]
    nb = block_tables.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, tp)
    k_new, v_new = _used(k_new, tp), _used(v_new, tp)
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
    return _out_proj(p, out, tp)


def attn_forward(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                 window: int | None, kernels: bool = True,
                 mrope_positions=None) -> torch.Tensor:
    """Causal self-attention over a full sequence with no cache.
    x: (B, S, D); positions: (B, S) for RoPE (and the masks);
    ``mrope_positions`` (B, S, 3) for M-RoPE.  Returns (B, S, D).
    ``kernels=False`` takes the reference's non-flash branches (``attend``,
    or ``attend_chunked`` at S >= CHUNK_THRESHOLD, over repeated K/V),
    which reach nothing in ``kernels/``: the trainer's path."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, None, mrope_positions)
    if kernels:
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        out = _attend_full(cfg, q, k, v, positions, window)
    return _out_proj(p, out, None)


# ---------------------------------------------------------------------------
# dense attention over repeated K/V (the reference's jnp paths)
# ---------------------------------------------------------------------------

def gqa_repeat(k: torch.Tensor, q_heads: int) -> torch.Tensor:
    """(..., Hkv, hd) -> (..., Hq, hd) by repeating each kv head."""
    rep = q_heads // k.shape[-2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=-2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, H, hd), mask (B, 1, Sq, Sk) bool ->
    (B, Sq, H, hd): fp32 logits masked at -1e9, fp32 softmax, probabilities
    in V's dtype, fp32 P.V, the result in q's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: int | None, scale: float, q_chunk: int = Q_CHUNK,
                   k_chunk: int = K_CHUNK) -> torch.Tensor:
    """Online-softmax attention over chunks (never the whole (Sq, Sk)
    logits), the reference's long-sequence path: causal (k_pos <= q_pos)
    with an optional window.  q (B, Sq, H, hd), k/v (B, Sk, H, hd), q_pos
    (B, Sq), k_pos (B, Sk).  Padding queries sit at position -1 and
    padding keys at 2**30, so the mask kills them; every query chunk scans
    every key chunk, as the reference's scan does.  Each query chunk runs
    under ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    does: its key loop's logits are recomputed in the backward instead of
    kept."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qc, kc = min(q_chunk, sq), min(k_chunk, sk)
    nq, nk = -(-sq // qc), -(-sk // kc)
    pad = lambda t, n: F.pad(t, (0, 0, 0, 0, 0, n - t.shape[1]))
    qp, kp, vp = pad(q, nq * qc), pad(k, nk * kc), pad(v, nk * kc)
    qpos = F.pad(q_pos, (0, nq * qc - sq), value=-1)
    kpos = F.pad(k_pos, (0, nk * kc - sk), value=2 ** 30)
    kts = [kp[:, j * kc:(j + 1) * kc].transpose(1, 2) for j in range(nk)]
    vts = [vp[:, j * kc:(j + 1) * kc].transpose(1, 2) for j in range(nk)]
    kpos_c = [kpos[:, j * kc:(j + 1) * kc] for j in range(nk)]

    def q_block(qb: torch.Tensor, qpb: torch.Tensor) -> torch.Tensor:
        qb = qb.transpose(1, 2).float()                         # (B,H,qc,hd)
        acc = torch.zeros((b, h, qc, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=q.device)
        for kb, vb, kpb in zip(kts, vts, kpos_c):           # (B,H,kc,hd)
            logit = qb @ kb.float().transpose(-1, -2) * scale
            msk = kpb[:, None, None, :] <= qpb[:, None, :, None]
            if window is not None:
                msk = msk & (kpb[:, None, None, :]
                             > qpb[:, None, :, None] - window)
            logit = torch.where(msk, logit, NEG_INF)
            m_new = torch.maximum(m, logit.amax(-1))
            p = torch.exp(logit - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(vb.dtype).float() @ vb.float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        return out.transpose(1, 2).to(q.dtype)                  # (B,qc,H,hd)

    outs = [checkpoint(q_block, qp[:, i * qc:(i + 1) * qc],
                       qpos[:, i * qc:(i + 1) * qc], use_reentrant=False)
            for i in range(nq)]
    return torch.cat(outs, dim=1)[:, :sq]


def _attend_full(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor, window: int | None) -> torch.Tensor:
    """Causal (optionally windowed) attention of a full sequence over
    repeated K/V, the reference's jnp paths: ``attend`` below
    CHUNK_THRESHOLD, ``attend_chunked`` at or above it."""
    kr, vr = gqa_repeat(k, q.shape[2]), gqa_repeat(v, q.shape[2])
    scale = cfg.head_dim ** -0.5
    if q.shape[1] >= CHUNK_THRESHOLD:
        return attend_chunked(q, kr, vr, positions, positions, window, scale)
    qp = positions[:, None, :, None]
    kp = positions[:, None, None, :]
    mask = kp <= qp
    if window is not None:
        mask = mask & (kp > qp - window)
    return attend(q, kr, vr, mask, scale)


# ---------------------------------------------------------------------------
# the contiguous cache: (B, S, Hkv, hd) per layer, one row per slot
# ---------------------------------------------------------------------------

def layer_cache_spec(cfg, batch: int, cache_len: int, dtype,
                     heads: int | None = None):
    """Per-layer contiguous cache of ``heads`` kv heads (all by default):
    {"k", "v"} (+ {"k_scale", "v_scale"} for an int8 cache) -> (shape,
    dtype)."""
    shape = (batch, cache_len, heads or cfg.num_kv_heads, cfg.head_dim)
    if kv_quantized(cfg):
        sshape = shape[:-1] + (1,)
        return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (sshape, torch.float32),
                "v_scale": (sshape, torch.float32)}
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_layer_cache(cfg, batch: int, cache_len: int, dtype,
                     device) -> dict:
    return {kk: torch.zeros(shape, dtype=dt, device=device)
            for kk, (shape, dt) in layer_cache_spec(cfg, batch, cache_len,
                                                    dtype).items()}


def _update_cache(cache_kv: torch.Tensor, new_kv: torch.Tensor,
                  lengths: torch.Tensor, ring: bool = False) -> None:
    """Write new_kv (B, 1, ...) at slot ``lengths[b]`` of each row of
    cache_kv (B, S, ...) IN PLACE; on a ``ring`` at slot lengths[b] % S,
    else a slot past the end lands on the last one, as
    ``dynamic_update_slice`` clamps it."""
    b, s = cache_kv.shape[:2]
    rows = torch.arange(b, device=cache_kv.device)
    slot = lengths.long() % s if ring else lengths.long().clamp(0, s - 1)
    cache_kv[rows, slot] = new_kv[:, 0].to(cache_kv.dtype)


def _update_cache_block(cache_kv: torch.Tensor, new_kv: torch.Tensor,
                        lengths: torch.Tensor, seg_lens: torch.Tensor,
                        ring: bool = False) -> None:
    """Write each row's first ``seg_lens[b]`` tokens of new_kv (B, T, ...)
    at cache offset ``lengths[b]`` of cache_kv (B, S, ...) IN PLACE.

    As in the reference, each row rewrites one T-slot window whose start
    is clamped to [0, S - T], keeping the old value wherever the window
    holds no valid new token, so a row near the cache end never smears
    earlier slots (and tokens past the end are dropped).  On a ``ring``
    token j goes to slot (lengths[b] + j) % S and invalid tokens write
    nothing (the reference drops them through an out-of-bounds index; the
    T <= S slots of a row are distinct, so they put back the old value)."""
    b, t = new_kv.shape[:2]
    s = cache_kv.shape[1]
    if t > s:
        raise ValueError(f"block length {t} exceeds cache length {s}")
    dev = cache_kv.device
    off = lengths.long()[:, None]
    ar = torch.arange(t, device=dev)[None, :]
    rows = torch.arange(b, device=dev)[:, None]
    if ring:
        slots = (off + ar) % s
        ok = ar < seg_lens.long()[:, None]
        new = new_kv.to(cache_kv.dtype)
    else:
        slots = off.clamp(0, s - t) + ar                       # (B, T)
        ci = slots - off                            # index into the block
        ok = (ci >= 0) & (ci < seg_lens.long()[:, None])
        new = new_kv.to(cache_kv.dtype)[rows, ci.clamp(0, t - 1)]
    okx = ok.reshape(ok.shape + (1,) * (new.dim() - 2))
    cache_kv[rows, slots] = torch.where(okx, new, cache_kv[rows, slots])


def block_slot_positions(lengths: torch.Tensor, seg_lens: torch.Tensor,
                         cache_len: int, ring: bool) -> torch.Tensor:
    """The absolute position each slot holds after a block write, (B, S)
    int32: slot s holds position s in a contiguous cache.  A ring holds at
    slot s the largest position <= hi = lengths + seg_lens - 1 congruent
    to s; a negative one marks a slot never written."""
    sidx = torch.arange(cache_len, dtype=torch.int32, device=lengths.device)
    if not ring:
        return sidx[None, :].expand(lengths.shape[0], cache_len)
    hi = (lengths + seg_lens - 1).to(torch.int32)[:, None]
    return hi - torch.remainder(hi - sidx[None, :], cache_len)


def _attend_grouped_block(cfg, q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Grouped-GQA attention of a (B, Tq) query block over the cache,
    without repeating K/V: q (B, Tq, Hq, hd), k/v (B, S, Hkv, hd), mask
    (B, Tq, S) bool -> (B, Tq, Hq, hd).  fp32 logits and P.V (the
    reference's preferred_element_type), masked at -1e9."""
    b, tq, hq, hd = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, tq, hkv, g, hd)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          k_cache.float()) * cfg.head_dim ** -0.5
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshd->bhgqd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4)    # (B, Tq, Hkv, G, hd)
    return out.reshape(b, tq, hkv * g, hd)


def _cache_kv(cfg, cache: dict, dtype):
    """The whole cache as K/V in the compute dtype (an int8 cache
    dequantized)."""
    if kv_quantized(cfg):
        return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
                dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def _new_kv(cfg, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The cache leaves' new values: K/V, or int8 payloads and scales."""
    if kv_quantized(cfg):
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def attn_decode_step(p: dict, cfg, cache: dict, x: torch.Tensor,
                     lengths: torch.Tensor, window: int | None,
                     tp: HeadTP | None = None,
                     mrope_positions=None) -> torch.Tensor:
    """One new token per row against the contiguous cache.  x (B, 1, D);
    lengths (B,) tokens already cached.  Row b writes its K/V at slot
    ``lengths[b]`` (clamped to the last slot) IN PLACE and attends slots
    <= lengths[b] (and > lengths[b] - window); on a ring (a window as long
    as the cache) at slot lengths[b] % cache_len, attending every slot
    written.  ``mrope_positions`` (B, 1, 3): the new tokens' M-RoPE
    positions.  Returns (B, 1, D)."""
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    ring = window is not None and cache_len == window
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None], tp,
                                   mrope_positions)
    for kk, vals in _new_kv(cfg, _used(k_new, tp), _used(v_new, tp)).items():
        _update_cache(cache[kk], vals, lengths, ring)
    k_cache, v_cache = _cache_kv(cfg, cache, x.dtype)
    idx = torch.arange(cache_len, device=x.device)[None, :]
    ln = lengths.long()[:, None]
    if ring:
        # every slot below min(lengths + 1, cache_len) holds a position of
        # the window
        mask = idx < torch.clamp(ln + 1, max=cache_len)
    else:
        mask = idx <= ln
        if window is not None:
            mask = mask & (idx > ln - window)
    out = _attend_grouped_block(cfg, q, k_cache, v_cache, mask[:, None, :])
    return _out_proj(p, out, tp)


def attn_block_step(p: dict, cfg, cache: dict, x: torch.Tensor,
                    positions: torch.Tensor, lengths: torch.Tensor,
                    seg_lens: torch.Tensor, window: int | None,
                    tp: HeadTP | None = None,
                    mrope_positions=None) -> torch.Tensor:
    """The unified step's contiguous form: row b's first ``seg_lens[b]``
    tokens (absolute positions ``positions[b]``) continue its sequence at
    cache offset ``lengths[b]``; they are written IN PLACE
    (``_update_cache_block``) and then attend every slot holding a position
    <= their own (and > pos - window).  Invalid tokens get a fully masked
    row.  A ring cache takes width-1 blocks only (the reference's
    ``ValueError``).  ``mrope_positions`` (B, T, 3): the block's M-RoPE
    positions.  x (B, T, D) -> (B, T, D)."""
    b, t, _ = x.shape
    cache_len = cache["k"].shape[1]
    ring = window is not None and cache_len == window
    if ring and t > 1:
        raise ValueError(
            f"ring KV cache (window == cache_len == {cache_len}) supports "
            f"only width-1 blocks, got T={t}")
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, tp,
                                   mrope_positions)
    for kk, vals in _new_kv(cfg, _used(k_new, tp), _used(v_new, tp)).items():
        _update_cache_block(cache[kk], vals, lengths, seg_lens, ring)
    k_cache, v_cache = _cache_kv(cfg, cache, x.dtype)
    slot_pos = block_slot_positions(lengths, seg_lens, cache_len, ring)
    valid = torch.arange(t, device=x.device)[None, :] < seg_lens[:, None]
    qp = torch.where(valid, positions, -1)
    mask = (slot_pos[:, None, :] >= 0) & (slot_pos[:, None, :]
                                          <= qp[:, :, None])
    if window is not None:
        mask = mask & (slot_pos[:, None, :] > qp[:, :, None] - window)
    out = _attend_grouped_block(cfg, q, k_cache, v_cache, mask)
    return _out_proj(p, out, tp)


def attn_prefill(p: dict, cfg, cache: dict, x: torch.Tensor,
                 positions: torch.Tensor, window: int | None,
                 rows: torch.Tensor | None = None, tp: HeadTP | None = None,
                 seq_block: bool = False,
                 mrope_positions=None) -> torch.Tensor:
    """Full-sequence forward that also fills the contiguous cache IN PLACE
    (the reference engine's padded prefill).  x (B, S, D); positions
    (B, S).  Attention is ``attend`` over repeated K/V, or
    ``attend_chunked`` at S >= CHUNK_THRESHOLD.  The cache takes K/V at
    slots [0, S); when S >= the cache length it takes the last cache_len
    tokens, rolled so that position p sits at slot p % cache_len (the
    reference rolls whenever ``S >= cache_len``, window or not).  ``rows``
    (B,) bool limits the write to those rows (the batched prefill's admit
    mask: in-flight rows keep their cache).  ``mrope_positions`` (B, S,
    3): the prompt's M-RoPE positions.  Returns (B, S, D).

    On a serving mesh (``tp``) the attention runs this rank's heads; with
    ``seq_block`` the cache is the context-parallel layout (this rank's
    sequence block of every kv head, ``attn_decode_step_cp``) and takes
    the slots of its block."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, tp, mrope_positions)
    out = _attend_full(cfg, q, _used(k, tp), _used(v, tp), positions, window)
    out = _out_proj(p, out, tp)
    if not seq_block:
        k, v = _used(k, tp), _used(v, tp)
        lo, cache_len = 0, cache["k"].shape[1]
    else:
        cut = tp.kv == "heads"
        k, v = _all_heads(k, tp, cut), _all_heads(v, tp, cut)
        lo = tp.mesh.coords[TP_AXIS] * cache["k"].shape[1]
        cache_len = cache["k"].shape[1] * tp.mesh.shape[TP_AXIS]
    if s >= cache_len:
        k = torch.roll(k[:, s - cache_len:], shifts=s, dims=1)
        v = torch.roll(v[:, s - cache_len:], shifts=s, dims=1)
    n = max(0, min(cache["k"].shape[1], k.shape[1] - lo))
    for kk, vals in _new_kv(cfg, k[:, lo:lo + n], v[:, lo:lo + n]).items():
        dst = cache[kk][:, :n]
        vals = vals.to(dst.dtype)
        if rows is not None:
            vals = torch.where(rows.reshape((b,) + (1,) * (vals.dim() - 1)),
                               vals, dst)
        dst.copy_(vals)
    return out


# ---------------------------------------------------------------------------
# context-parallel decode: the cache sequence-sharded over "model"
# ---------------------------------------------------------------------------

def use_cp_decode(cfg, mesh, cache_len: int) -> bool:
    """Sequence-sharded decode applies when a mesh with a "model" axis is
    present, the cache length divides it and the config opts in (the
    reference's rule)."""
    return (mesh is not None
            and TP_AXIS in getattr(mesh, "axis_names", ())
            and getattr(cfg, "kv_cache_shard", "seq") == "seq"
            and cache_len % mesh.shape[TP_AXIS] == 0)


def attn_decode_step_cp(p: dict, cfg, cache: dict, x: torch.Tensor,
                        lengths: torch.Tensor, window: int | None,
                        tp: HeadTP, mrope_positions=None) -> torch.Tensor:
    """Decode-time context parallelism (the reference's
    ``attn_decode_step_cp``): the contiguous cache is sequence-sharded
    over "model", (B, S / n, Hkv, hd) per rank, its block of every kv
    head.  q and the new k/v are gathered to every head (the reference's
    replicated operands); the new token is written by the rank whose
    block holds slot ``lengths[b]`` (none past the cache; on a ring, a
    window as long as the logical cache, slot lengths[b] % cache_len);
    each rank attends its block, and the online-softmax statistics are
    merged with a pmax and two psums.  The output keeps this rank's q heads for a
    split ``wo`` (partial product, psum), or every head for a whole one.
    ``mrope_positions`` (B, 1, 3): the new tokens' M-RoPE positions (vlm).
    x (B, 1, D) -> (B, 1, D)."""
    b = x.shape[0]
    n, c = tp.mesh.shape[TP_AXIS], tp.mesh.coords[TP_AXIS]
    s_loc = cache["k"].shape[1]
    cache_len = s_loc * n
    ring = window is not None and cache_len == window
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None], tp,
                                   mrope_positions)
    q = _all_heads(q, tp, tp.q_split)
    cut = tp.kv == "heads"
    k_new, v_new = _all_heads(k_new, tp, cut), _all_heads(v_new, tp, cut)
    ln = lengths.long()[:, None]
    local = (lengths.long() % cache_len if ring else lengths.long()) \
        - c * s_loc
    ok = (local >= 0) & (local < s_loc)
    rows = torch.arange(b, device=x.device)
    slot = local.clamp(0, s_loc - 1)
    for kk, vals in _new_kv(cfg, k_new, v_new).items():
        cur = cache[kk][rows, slot]
        cache[kk][rows, slot] = torch.where(
            ok.reshape((b,) + (1,) * (cur.dim() - 1)),
            vals[:, 0].to(cur.dtype), cur)
    kc, vc = _cache_kv(cfg, cache, q.dtype)
    hkv, hd = kc.shape[2], cfg.head_dim
    g = q.shape[2] // hkv
    qg = q.reshape(b, 1, hkv, g, hd)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          kc.float()) * hd ** -0.5
    gidx = c * s_loc + torch.arange(s_loc, device=x.device)[None, :]
    if ring:
        mask = gidx < torch.clamp(ln + 1, max=cache_len)
    else:
        mask = gidx <= ln
        if window is not None:
            mask = mask & (gidx > ln - window)
    mask5 = mask[:, None, None, None, :]
    logits = torch.where(mask5, logits, NEG_INF)
    m_loc = logits.amax(dim=-1)                             # (B, Hkv, G, 1)
    pr = torch.where(mask5, torch.exp(logits - m_loc[..., None]), 0.0)
    l_loc = pr.sum(dim=-1)
    acc = torch.einsum("bhgqs,bshd->bhgqd", pr.to(vc.dtype).float(),
                       vc.float())
    m_g = collectives.pmax(m_loc, tp.mesh, TP_AXIS)
    corr = torch.exp(m_loc - m_g)
    l_g = collectives.psum(l_loc * corr, tp.mesh, TP_AXIS)
    acc = collectives.psum(acc * corr[..., None], tp.mesh, TP_AXIS)
    out = acc / torch.clamp(l_g[..., None], min=1e-30)      # (B,Hkv,G,1,hd)
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, 1, hkv * g, hd)
    if tp.wo_split:
        out = out[:, :, tp.q0:tp.q0 + tp.hq]
    y = quant.qdot(out.reshape(b, 1, -1), p["wo"])
    return collectives.psum(y, tp.mesh, TP_AXIS) if tp.wo_split else y
