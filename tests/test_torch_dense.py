"""Port vs JAX for the dense family (``qwen3_0_6b``, ``stablelm_12b``) and
the contiguous KV cache, op by op and model by model, on the same seeded
numpy inputs and bridged weights.

Ops run in fp32 and agree to 2e-5: the dense MLP (``mlp_apply``), the
cache writes (``_update_cache`` with its clamp at the cache's end,
``_update_cache_block`` with offsets past ``S - T``),
``block_slot_positions``, and the three cached attention steps
(``attn_decode_step``, ``attn_block_step``, ``attn_prefill``) over fp and
int8 caches, the prefill below and at ``CHUNK_THRESHOLD`` (the chunked
online softmax) and at and past the cache length (the rolled tail).  The
JAX functions are called eagerly, outside ``jit``, so the int8 scales
divide as the port does (see ``tests/test_torch_quant.py``); an int8
payload may still land one step apart where the fp32 K/V sits on a
rounding boundary (``_cache_close``).  Models: the
reduced dense configs' forward and loss agree to 2e-4 with the JAX model
run through its Pallas flash kernel (interpret mode) and through its plain
``attend``; the reference engine's model entry points (``prefill_routed``,
``decode_step_routed``) and the contiguous unified step agree to 1e-4 in
logits, with equal caches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ops as jax_ops
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.core import perf_model
from repro_torch.core.quant import QuantTensor
from repro_torch.kernels import flash_attn
from repro_torch.models import attention, layers
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine
from torch_archs import DENSE_ARCHS, reduced_pair

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the dense MLP
# ---------------------------------------------------------------------------

def _port_quant(w):
    return QuantTensor(_t(w.data), _t(w.scale), int(w.bits), int(w.block),
                       int(w.orig_dim), str(w.out_dtype))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("level", ["none", "int8", "int4"])
def test_mlp_apply_matches_reference(act, level):
    rng = np.random.default_rng(1)
    d, f = 48, 80
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if level != "none":
        jp = {k: jq.quantize(v, level, block=16) for k, v in jp.items()}
        tp = {k: _port_quant(v) for k, v in jp.items()}
    else:
        tp = {k: _t(v) for k, v in p.items()}
    want = jax_layers.mlp_apply(jp, jnp.asarray(x), act)
    _close(layers.mlp_apply(tp, _t(x), act), want)


def test_mlp_init_shapes():
    p = layers.mlp_init(torch.Generator().manual_seed(0), 8, 12,
                        torch.float32, (3,))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_gate": (3, 8, 12), "w_up": (3, 8, 12), "w_down": (3, 12, 8)}


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------

def test_update_cache_clamps_at_the_end():
    """Row b writes at slot lengths[b]; lengths == S lands on the last
    slot, as ``dynamic_update_slice`` clamps it."""
    rng = np.random.default_rng(2)
    cache = rng.standard_normal((4, 6, 2, 4)).astype(np.float32)
    new = rng.standard_normal((4, 1, 2, 4)).astype(np.float32)
    lengths = np.array([0, 3, 5, 6], np.int32)
    want = jax_attn._update_cache(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.asarray(lengths), False)
    got = _t(cache)
    attention._update_cache(got, _t(new), _t(lengths))
    _close(got, want, 0)
    assert np.array_equal(got[3, 5].numpy(), new[3, 0])


@pytest.mark.parametrize("lengths,seg", [
    ([0, 2, 5, 7], [3, 2, 3, 1]),        # 5 and 7 are past S - T = 5 ... 8
    ([6, 8, 1, 0], [3, 0, 1, 3]),        # a full cache, an empty row
])
def test_update_cache_block_matches_reference(lengths, seg):
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((4, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((4, 3, 2, 4)).astype(np.float32)
    ln, sl = np.array(lengths, np.int32), np.array(seg, np.int32)
    want = jax_attn._update_cache_block(jnp.asarray(cache), jnp.asarray(new),
                                        jnp.asarray(ln), jnp.asarray(sl),
                                        False)
    got = _t(cache)
    attention._update_cache_block(got, _t(new), _t(ln), _t(sl))
    _close(got, want, 0)


def test_update_cache_block_refuses_a_block_longer_than_the_cache():
    with pytest.raises(ValueError, match="exceeds cache length"):
        attention._update_cache_block(torch.zeros(1, 2, 1, 1),
                                      torch.zeros(1, 3, 1, 1),
                                      torch.zeros(1, dtype=torch.int32),
                                      torch.ones(1, dtype=torch.int32))


def test_block_slot_positions_matches_reference():
    ln = np.array([0, 5, 9], np.int32)
    sl = np.array([3, 1, 0], np.int32)
    want = jax_attn.block_slot_positions(jnp.asarray(ln), jnp.asarray(sl),
                                         12, False)
    got = attention.block_slot_positions(_t(ln), _t(sl), 12, False)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the cached attention steps
# ---------------------------------------------------------------------------

def _attn_setup(kv: str, seed: int = 0):
    """A reduced dense config pair (qk-norm, GQA 2), random attention
    weights and a random filled cache (int8: payload and scales)."""
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


def _cache(cfg, rng, b, s):
    shape = (b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.random(shape[:-1] + (1,)).astype(np.float32)
                / 60, "v_scale": rng.random(shape[:-1] + (1,)).astype(
                    np.float32) / 60}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _t(v) for k, v in tree.items()}


def _cache_close(got: dict, want: dict):
    """fp leaves to 2e-5; an int8 payload exactly, except that a value
    sitting on a rounding boundary may land one step apart (the two sides
    sum the K/V projection in different orders): at most one step, on at
    most one element in 10^4."""
    for kk in want:
        if got[kk].dtype != torch.int8:
            _close(got[kk], want[kk])
            continue
        diff = (got[kk].int() - torch.from_numpy(
            np.asarray(want[kk]).astype(np.int32))).abs()
        assert int(diff.max()) <= 1, kk
        assert float((diff > 0).float().mean()) <= 1e-4, kk


KV_WINDOW = [(kv, w) for kv in ("native", "int8") for w in (None, 5)]


@pytest.mark.parametrize("kv,window", KV_WINDOW)
def test_attn_decode_step_matches_reference(kv, window):
    """One token per row; the last row's lengths is the cache length (its
    write clamps onto the last slot)."""
    jcfg, cfg, p, rng = _attn_setup(kv)
    b, s = 4, 12
    cache = _cache(cfg, rng, b, s)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    lengths = np.array([0, 5, 11, 12], np.int32)
    want, jcache = jax_attn.attn_decode_step(
        _jax_tree(p), jcfg, _jax_tree(cache), jnp.asarray(x),
        jnp.asarray(lengths), window)
    tcache = _torch_tree(cache)
    got = attention.attn_decode_step(_torch_tree(p), cfg, tcache, _t(x),
                                     _t(lengths), window)
    _close(got, want)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("kv,window", KV_WINDOW)
def test_attn_block_step_matches_reference(kv, window):
    """A (B, T=4) block: a prefill chunk, a decode row, a row whose offset
    sits past S - T (its window is clamped) and an empty row."""
    jcfg, cfg, p, rng = _attn_setup(kv, 1)
    b, t, s = 4, 4, 12
    cache = _cache(cfg, rng, b, s)
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    lengths = np.array([0, 5, 10, 3], np.int32)
    seg = np.array([4, 1, 2, 0], np.int32)
    positions = (lengths[:, None] + np.arange(t)[None]).astype(np.int32)
    want, jcache = jax_attn.attn_block_step(
        _jax_tree(p), jcfg, _jax_tree(cache), jnp.asarray(x),
        jnp.asarray(positions), jnp.asarray(lengths), jnp.asarray(seg),
        window)
    tcache = _torch_tree(cache)
    got = attention.attn_block_step(_torch_tree(p), cfg, tcache, _t(x),
                                    _t(positions), _t(lengths), _t(seg),
                                    window)
    valid = np.arange(t)[None] < seg[:, None]
    _close(got[torch.from_numpy(valid)], np.asarray(want)[valid])
    _cache_close(tcache, jcache)


# (S, cache length, window): below the cache, at it and past it (the
# rolled tail), and at CHUNK_THRESHOLD (chunked attention), windowed too
PREFILL = [(6, 10, None), (10, 10, None), (13, 10, 4),
           (attention.CHUNK_THRESHOLD, attention.CHUNK_THRESHOLD, None),
           (attention.CHUNK_THRESHOLD, attention.CHUNK_THRESHOLD + 8, 700)]


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("s,cache_len,window", PREFILL)
def test_attn_prefill_matches_reference(s, cache_len, window, kv):
    assert attention.CHUNK_THRESHOLD == jax_attn.CHUNK_THRESHOLD
    jcfg, cfg, p, rng = _attn_setup(kv, 2)
    b = 2 if s < 1000 else 1
    cache = _cache(cfg, rng, b, cache_len)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, jcache = jax_attn.attn_prefill(
        _jax_tree(p), jcfg, _jax_tree(cache), jnp.asarray(x),
        jnp.asarray(positions), window)
    tcache = _torch_tree(cache)
    got = attention.attn_prefill(_torch_tree(p), cfg, tcache, _t(x),
                                 _t(positions), window)
    _close(got, want)
    _cache_close(tcache, jcache)


def test_attn_prefill_writes_only_its_rows():
    """The batched prefill's admit mask: rows outside ``rows`` keep their
    cache; admitted rows get what the unmasked prefill writes."""
    _, cfg, p, rng = _attn_setup("int8", 3)
    cache = _cache(cfg, rng, 3, 10)
    x = _t(rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32))
    pos = torch.arange(6)[None].expand(3, 6)
    full, masked = _torch_tree(cache), _torch_tree(cache)
    attention.attn_prefill(_torch_tree(p), cfg, full, x, pos, None)
    rows = torch.tensor([True, False, True])
    attention.attn_prefill(_torch_tree(p), cfg, masked, x, pos, None, rows)
    for kk, v in masked.items():
        assert torch.equal(v[rows], full[kk][rows]), kk
        assert torch.equal(v[1], _t(cache[kk])[1]), kk


@pytest.mark.parametrize("window", [None, 5, 20])
def test_attend_chunked_matches_reference(window):
    """Several query and key chunks (16 and 8 wide over S=37), ragged
    ends, windows shorter and longer than a chunk."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37))
    want = jax_attn.attend_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                   jnp.asarray(pos), jnp.asarray(pos), window,
                                   0.25, q_chunk=16, k_chunk=8)
    got = attention.attend_chunked(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                   window, 0.25, q_chunk=16, k_chunk=8)
    _close(got, want)


def test_ring_caches_are_not_ported():
    """A window as long as the cache makes it a ring buffer.  The ring
    forms are ported (``tests/test_torch_ring.py`` holds them to the
    reference); what a ring still refuses is the reference's own refusal:
    a unified block wider than one token, as a ``ValueError``, while the
    decode step runs and the stacked cache is clipped to the window."""
    _, cfg, p, rng = _attn_setup("native")
    cache = _torch_tree(_cache(cfg, rng, 1, 8))
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="width-1"):
        attention.attn_block_step(_torch_tree(p), cfg, cache,
                                  torch.zeros(1, 2, cfg.d_model),
                                  torch.arange(2)[None], one, one + 2, 8)
    out = attention.attn_decode_step(_torch_tree(p), cfg, cache,
                                     torch.zeros(1, 1, cfg.d_model), one, 8)
    assert out.shape == (1, 1, cfg.d_model)
    ring = build_model(cfg.replace(sliding_window=8), "cpu").init_cache(1, 20)
    assert ring["k"].shape[2] == 8


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_cache_layout_matches_reference(kv):
    """One layer's contiguous cache and the model's stacked one: the
    reference's leaves, shapes and dtypes, zero-initialised."""
    jcfg, cfg, _, _ = _attn_setup(kv)
    want = jax_attn.init_layer_cache(jcfg, 3, 10, jnp.float32)
    got = attention.init_layer_cache(cfg, 3, 10, torch.float32, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
    jspec = jax_build_model(jcfg).cache_specs(3, 10)
    spec = build_model(cfg, "cpu").cache_specs(3, 10)
    assert {k: (s, str(d).split(".")[-1]) for k, (s, d) in spec.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jspec.items()}


# ---------------------------------------------------------------------------
# flash attention at stablelm-12b's head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24])
def test_flash_plain_at_hd_160_matches_pallas(window):
    """The plain version at hd 160 (the third kernel instantiation) against
    the JAX Pallas kernel in interpret mode, G=4, S=40 over 32-wide
    blocks."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 40, 8, 160)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 2, 160)).astype(np.float32)
            for _ in range(2))
    tr = lambda a: jnp.asarray(np.repeat(a, 8 // a.shape[2], 2)
                               .transpose(0, 2, 1, 3))
    want = jax_ops.flash_attention(tr(q), tr(k), tr(v), window=window,
                                   block_q=32, block_k=32)
    got = flash_attn.flash_attention_plain(_t(q), _t(k), _t(v),
                                           window=window)
    _close(got, np.asarray(want).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("hd,ok", [(64, True), (128, True), (160, True),
                                   (256, True), (96, True), (320, False),
                                   (80, True), (112, True), (72, True),
                                   (1, True), (257, False)])
def test_flash_geometry_check(hd, ok):
    """The kernel takes any hd from 1 to 256, as the reference's kernel
    takes any (phi-2's 80, phi-3-mini's 96), and refuses a wider one (the
    bf16 kernel's P.V is one wgmma of N <= 256; no fallback to the plain
    version on the card)."""
    if ok:
        flash_attn.check_geometry(32, 8, hd)
    else:
        with pytest.raises(ValueError, match="unsupported geometry"):
            flash_attn.check_geometry(32, 8, hd)


@pytest.mark.parametrize("hd,bf16_hd", [
    (1, 8), (64, 64), (72, 72), (80, 80), (96, 96), (100, 104), (160, 160),
    (200, 200), (255, 256)])
def test_flash_staged_hd(hd, bf16_hd):
    """bf16 reads zero-padded copies at the next multiple of 8 where hd is
    not one (its TMA maps need rows of a multiple of 16 bytes), fp32 reads
    hd as it is; the copies hold the values and zeros past them."""
    assert flash_attn.staged_hd(torch.bfloat16, hd) == bf16_hd
    assert flash_attn.staged_hd(torch.float32, hd) == hd
    x = torch.randn(2, 3, 4, hd)[:, :, ::2]
    got = flash_attn.pad_head_dim(x, bf16_hd)
    assert got.is_contiguous() and got.shape == (2, 3, 2, bf16_hd)
    assert torch.equal(got[..., :hd], x)
    assert bool((got[..., hd:] == 0).all())


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    flash = kw.pop("flash", False)
    jcfg, cfg = reduced_pair(arch, {"use_kernel": True,
                                    "use_flash_kernel": flash}, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jq.quantize_params(jmodel.init(jax.random.PRNGKey(0)), jcfg)
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    return jcfg, cfg, jmodel, jparams, build_model(cfg, "cpu"), params


MODEL_CASES = [(a, f) for a in DENSE_ARCHS for f in (True, False)]


@pytest.mark.parametrize("arch,flash", MODEL_CASES, ids=[
    f"{a}-{'flash' if f else 'attend'}" for a, f in MODEL_CASES])
def test_forward_and_loss_match_reference(arch, flash):
    _, cfg, jmodel, jparams, model, params = _pair(arch, flash=flash)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(tokens), "labels": _t(labels)}
    want, jaux = jmodel.forward(jparams, jb)
    jtotal, jm = jmodel.loss(jparams, jb)
    with torch.no_grad():
        got, aux = model.forward(params, tb)
        total, m = model.loss(params, tb)
    _close(got, want, 2e-4)
    assert float(aux) == float(jaux) == 0.0
    for a, w in ((total, jtotal), (m["ce"], jm["ce"])):
        assert abs(float(a) - float(w)) <= 2e-4 * (1 + abs(float(w)))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("level", ["none", "int8"])
def test_reference_model_steps_match(arch, level):
    """The reference engine's model entry points: a padded (B, 8) prefill
    into a 16-slot cache, then three greedy decode steps, with equal
    logits (1e-4), caches and the same argmax."""
    kw = {} if level == "none" else {"weight_quant": "int8",
                                     "kv_cache_dtype": "int8"}
    _, cfg, jmodel, jparams, model, params = _pair(arch, **kw)
    b, s, c = 2, 8, 16
    jcache, cache = jmodel.init_cache(b, c), model.init_cache(b, c)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    toks = np.random.default_rng(7).integers(0, 100, (b, s)).astype(np.int32)
    jl, jcache, jr = jmodel.prefill_routed(jparams, {"tokens": jnp.asarray(
        toks)}, jcache)
    tl, tr = model.prefill_routed(params, {"tokens": _t(toks)}, cache)
    assert jr is None and tr is None
    for i in range(4):
        _close(tl, jl, 1e-4)
        _cache_close(cache, jcache)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt)
        lengths = np.full((b,), s + i, np.int32)
        jl, jcache = jmodel.decode_step(jparams, jcache, {
            "tokens": jnp.asarray(nxt[:, None]),
            "lengths": jnp.asarray(lengths)})
        tl = model.decode_step(params, cache, {"tokens": _t(nxt[:, None]),
                                               "lengths": _t(lengths)})


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_contiguous_unified_step_matches(arch):
    """``forward_routed`` over the contiguous cache: chunks of 3 over a
    7-token prompt, then greedy decode rows."""
    _, cfg, jmodel, jparams, model, params = _pair(arch)
    b, s, c = 2, 7, 12
    jcache, cache = jmodel.init_cache(b, c), model.init_cache(b, c)
    toks = np.random.default_rng(8).integers(0, 100, (b, s)).astype(np.int32)
    steps = [(toks[:, lo:lo + 3], lo, min(3, s - lo)) for lo in (0, 3, 6)]
    last = None
    for i in range(6):
        tokens, lo, n = (steps[i] if i < 3
                         else (last[:, None], s + i - 3, 1))
        if tokens.shape[1] < 3 and i < 3:
            tokens = np.pad(tokens, ((0, 0), (0, 3 - tokens.shape[1])))
        batch = {"tokens": tokens, "lengths": np.full((b,), lo, np.int32),
                 "seg_lens": np.full((b,), n, np.int32)}
        jl, jcache, jr = jmodel.forward_routed(jparams, _jax_tree(batch),
                                               jcache)
        tl, tr = model.forward_routed(params, _torch_tree(batch), cache)
        assert jr is None and tr is None
        _close(tl, jl, 1e-4)
        _cache_close(cache, jcache)
        last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("paged", [True, False])
def test_engine_memory_matches_perf_model(arch, paged):
    """Weight bytes (stablelm's untied head and layernorm leaves, qwen3's
    tied head) equal the performance model's; the contiguous cache holds
    max_batch x max_cache tokens."""
    _, cfg = reduced_pair(arch)
    eng = ServingEngine(cfg, EngineConfig(max_batch=2, max_cache=16,
                                          paged=paged),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    ms = eng.memory_stats()
    assert ms["weight_bytes"] == perf_model.model_weight_bytes(cfg)
    tokens = eng.num_pages * eng.page_size if paged else 2 * 16
    assert ms["kv_pool_bytes"] == tokens * perf_model.kv_bytes_per_token(
        cfg, precision=4)
    assert eng.tracker is None and eng.standby().item() == 0.0
