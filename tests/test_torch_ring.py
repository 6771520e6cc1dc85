"""Port vs JAX: the ring (sliding-window) forms of the contiguous KV cache,
op by op, on the same numpy weights and inputs.

A cache whose length equals the window is a ring: position p lives at
slot p % cache_len.  Held to the reference at fp32 2e-5 (int8 payloads
exactly, up to one rounding step on a boundary value): the single-slot
write, twelve decode steps on a 4-slot ring (and the same steps over a
long cache with a window mask, which must give the ring's outputs), the
prefill's kept tail at S below, at and above the cache length (rolled so
that position p sits at slot p % cache_len), the block write that drops
invalid tokens, the slot-position map, the width-1 block step and the
refusal of a wider one.  Context-parallel decode's ring branch is held to
JAX's on a (2, 2) mesh by ``tests/test_torch_serve_mesh.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models.model import build_model as jax_build_model
from repro_torch.models import attention
from repro_torch.models.model import build_model
from torch_archs import DENSE_ARCHS, FAMILY_ARCHS, reduced_pair

TOL = 2e-5
RING = 4          # a window as long as the cache


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _setup(kv: str, seed: int = 0):
    """A reduced dense config pair (qk-norm, GQA 2) and random attention
    weights."""
    jcfg, cfg = reduced_pair(DENSE_ARCHS[0], kv_cache_dtype=kv)
    rng = np.random.default_rng(seed)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
         "wo": (hq * hd, d)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in p.items()}
    p["q_norm"] = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
    p["k_norm"] = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
    return jcfg, cfg, p, rng


def _zero_cache(cfg, b, s):
    shape = (b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
                "k_scale": np.zeros(shape[:-1] + (1,), np.float32),
                "v_scale": np.zeros(shape[:-1] + (1,), np.float32)}
    return {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: _t(v) for k, v in tree.items()}


def _cache_close(got: dict, want: dict):
    """fp leaves to 2e-5; an int8 payload exactly, but for a value on a
    rounding boundary that the two sides' projection sums put one step
    apart (at most one step, on at most one element in 10^3)."""
    for kk in want:
        if got[kk].dtype != torch.int8:
            _close(got[kk], want[kk])
            continue
        diff = (got[kk].int() - torch.from_numpy(
            np.asarray(want[kk]).astype(np.int32))).abs()
        assert int(diff.max()) <= 1, kk
        assert float((diff > 0).float().mean()) <= 1e-3, kk


def test_update_cache_ring_matches_reference():
    rng = np.random.default_rng(1)
    cache = rng.standard_normal((3, RING, 2, 8)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    lengths = np.array([3, 9, 4], np.int32)
    want = jax_attn._update_cache(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.asarray(lengths), True)
    got = _t(cache)
    attention._update_cache(got, _t(new), _t(lengths), ring=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_decode_steps_on_a_ring_match_reference(kv):
    """Twelve decode steps on a 4-slot ring from two offsets: every output
    and the final ring as the reference's; and (fp) the same outputs as
    a 16-slot cache with a window-4 mask, the reference's own check of
    the ring."""
    jcfg, cfg, p, rng = _setup(kv)
    b, steps = 2, 12
    xs = rng.standard_normal((b, steps, cfg.d_model)).astype(np.float32)
    jring, ring = _jax(_zero_cache(cfg, b, RING)), _torch(
        _zero_cache(cfg, b, RING))
    full = _torch(_zero_cache(cfg, b, steps + 4))
    offsets = np.array([0, 3], np.int32)
    for t in range(steps):
        lengths = offsets + t
        want, jring = jax_attn.attn_decode_step(
            _jax(p), jcfg, jring, jnp.asarray(xs[:, t:t + 1]),
            jnp.asarray(lengths), RING)
        got = attention.attn_decode_step(_torch(p), cfg, ring,
                                         _t(xs[:, t:t + 1]), _t(lengths),
                                         RING)
        _close(got, want)
        wide = attention.attn_decode_step(_torch(p), cfg, full,
                                          _t(xs[:, t:t + 1]), _t(lengths),
                                          RING)
        if kv == "native":
            _close(got, wide.numpy())
    _cache_close(ring, jring)


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("s", [3, RING, 7, 10])
def test_prefill_into_a_ring_matches_reference(s, kv):
    """The prefill's attention and the cache it leaves: below the ring's
    length the first S slots; at and above it the last cache_len tokens,
    rolled by S (an identity at S = cache_len), as the reference keeps
    them; the decode after it writes slot S % cache_len."""
    jcfg, cfg, p, rng = _setup(kv, seed=s)
    b = 2
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    start = {k: (v if v.dtype == np.int8 else v + 0.5)
             for k, v in _zero_cache(cfg, b, RING).items()}
    want, jcache = jax_attn.attn_prefill(_jax(p), jcfg, _jax(start),
                                         jnp.asarray(x), jnp.asarray(pos),
                                         RING)
    cache = _torch(start)
    got = attention.attn_prefill(_torch(p), cfg, cache, _t(x), _t(pos), RING)
    _close(got, want)
    _cache_close(cache, jcache)
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    lengths = np.full((b,), s, np.int32)
    want, jcache = jax_attn.attn_decode_step(_jax(p), jcfg, jcache,
                                             jnp.asarray(x1),
                                             jnp.asarray(lengths), RING)
    got = attention.attn_decode_step(_torch(p), cfg, cache, _t(x1),
                                     _t(lengths), RING)
    _close(got, want)
    _cache_close(cache, jcache)


@pytest.mark.parametrize("ring", [False, True])
def test_block_slot_positions_match_reference(ring):
    ln = np.array([0, 5, 9, 2], np.int32)
    sl = np.array([3, 1, 0, 4], np.int32)
    want = jax_attn.block_slot_positions(jnp.asarray(ln), jnp.asarray(sl),
                                         RING if ring else 12, ring)
    got = attention.block_slot_positions(_t(ln), _t(sl),
                                         RING if ring else 12, ring)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_write_into_a_ring_drops_invalid_tokens():
    """Token j of row b goes to slot (lengths + j) % S; tokens at or past
    seg_lens write nothing (the reference's out-of-bounds drop)."""
    rng = np.random.default_rng(2)
    cache = rng.standard_normal((3, RING, 2, 8)).astype(np.float32)
    new = rng.standard_normal((3, 3, 2, 8)).astype(np.float32)
    ln = np.array([2, 7, 1], np.int32)
    sl = np.array([3, 1, 0], np.int32)
    want = jax_attn._update_cache_block(jnp.asarray(cache), jnp.asarray(new),
                                        jnp.asarray(ln), jnp.asarray(sl),
                                        True)
    got = _t(cache)
    attention._update_cache_block(got, _t(new), _t(ln), _t(sl), ring=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[2].numpy(), cache[2])


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_width1_block_step_on_a_ring_matches_reference(kv):
    """The unified block step of width 1 over a ring (a decode row and a
    row with no valid token), as the reference's; a wider block is
    refused on both sides with the reference's ``ValueError``."""
    jcfg, cfg, p, rng = _setup(kv, seed=3)
    b = 2
    jcache, cache = _jax(_zero_cache(cfg, b, RING)), _torch(
        _zero_cache(cfg, b, RING))
    for t in range(6):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        ln = np.array([t, 2 * t], np.int32)
        sl = np.array([1, t % 2], np.int32)
        want, jcache = jax_attn.attn_block_step(
            _jax(p), jcfg, jcache, jnp.asarray(x), jnp.asarray(ln[:, None]),
            jnp.asarray(ln), jnp.asarray(sl), RING)
        got = attention.attn_block_step(_torch(p), cfg, cache, _t(x),
                                        _t(ln[:, None]), _t(ln), _t(sl),
                                        RING)
        # a row with no valid token attends nothing: its output is noise
        # the caller never reads, computed differently on the two sides
        valid = sl > 0
        _close(got[valid], np.asarray(want)[valid])
    _cache_close(cache, jcache)
    x2 = np.zeros((b, 2, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(2, dtype=np.int32), (b, 2))
    zero = np.zeros((b,), np.int32)
    with pytest.raises(ValueError, match="width-1"):
        jax_attn.attn_block_step(_jax(p), jcfg, jcache, jnp.asarray(x2),
                                 jnp.asarray(pos), jnp.asarray(zero),
                                 jnp.asarray(zero + 2), RING)
    with pytest.raises(ValueError, match="width-1"):
        attention.attn_block_step(_torch(p), cfg, cache, _t(x2), _t(pos),
                                  _t(zero), _t(zero + 2), RING)


@pytest.mark.parametrize("arch,kw,cache_len", [
    ("qwen3_moe_30b_a3b", dict(sliding_window=16), 64),
    ("qwen3_moe_30b_a3b", dict(sliding_window=16, kv_cache_dtype="int8"),
     64),
    (FAMILY_ARCHS[0], {}, 96), (FAMILY_ARCHS[0], {}, 40),
    (FAMILY_ARCHS[1], {}, 40)])
def test_stacked_cache_layout_matches_reference(arch, kw, cache_len):
    """The model's contiguous cache: clipped to the window (a ring) for a
    windowed arch, min(cache_len, window) attention slots beside the
    recurrent state for the hybrid stack, the SSD state for ssm; the
    reference's leaves, shapes and dtypes, zero-initialised."""
    jcfg, cfg = reduced_pair(arch, **kw)
    want = jax_build_model(jcfg).init_cache(3, cache_len)
    got = build_model(cfg, "cpu").init_cache(3, cache_len)

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict)
                       else {pre + k: v})
        return out
    got, want = flat(got), flat(want)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
