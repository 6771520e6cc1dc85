"""Port vs JAX: the stateful families (RecurrentGemma's RG-LRU hybrid,
Mamba-2's SSD) and the last two dense configs (qwen2-72b, deepseek-67b),
on JAX-initialised weights bridged into the port and the same numpy
inputs.

Op by op in fp32 at 2e-5: the RG-LRU gates and causal conv, the block's
forward with a state and its decode step; the chunked SSD, the SSD
block's forward (chunk 256, and one chunk of the whole sequence where 256
does not divide it) and decode step.  The linear recurrence is a
log-depth doubling scan in the port and ``jax.lax.associative_scan`` in
the reference: the products are taken in another order, so it is held to
SCAN_TOL of the output's largest magnitude (measured about 2e-7 at
S=2048), and so is everything downstream of it at 2e-5.  The chunked
SSD's in-chunk decays are exp of differences of cumulative sums of
dt * A, which the two sides add in another order: over 256-token chunks
the block's output is held to SSD_TOL of its largest magnitude (measured
2.6e-5 at S=512 and 3.1e-5 at one 256-token chunk, growing with the
chunk length: 1e-6 at 16, 4e-6 at 64).  The reference's
own layer checks (``tests/test_ssm_hybrid.py``: chunk-size invariance, the
forward against the stepwise decode, finite gradients) are repeated on the
port's side.

Models: the reduced recurrentgemma-2b (3 layers, window 64), mamba2-130m,
qwen2-72b (QKV bias) and deepseek-67b, forward (logits 1e-4) and loss
(2e-5); for the two families every gradient leaf within 2e-4 of its
largest, one ``make_train_step`` step against the jitted JAX step, and
three steps with a leaf's elements beyond 1e-6 counted in whole elements.
The engine: greedy streams and counters identical to the JAX engine's in
the reference engine for recurrentgemma (72-token prompts roll into its
64-slot attention ring; fp32 and int8 weights + int8 KV) and mamba2, for
the reduced qwen3-moe with a 16-token window (the ring fallback), and in
the paged unified step for qwen2-72b and deepseek-67b."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import optim as joptim
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import mamba2 as jmamba
from repro.models import rglru as jrglru
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge, optim
from repro_torch.ckpt import io as ckpt
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import mamba2, rglru
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine
from torch_archs import (FAMILY_ARCHS, LATE_DENSE_ARCHS,  # noqa: F401
                         one_torch_thread, reduced_pair)

TOL = 2e-5
SCAN_TOL = 1e-6
SSD_TOL = 1e-4
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 2e-5, 2e-4
RG, MAMBA = FAMILY_ARCHS


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(got, want, tol=TOL, scale=False):
    """Within ``tol`` (absolute and relative), or with ``scale`` within
    ``tol`` of the reference's largest magnitude."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if scale:
        err = float(np.abs(got - want).max())
        assert err <= tol * max(float(np.abs(want).max()), 1e-6), err
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def rec():
    """The reduced recurrentgemma's config pair and one recurrent block's
    JAX-initialised weights."""
    jcfg, cfg = reduced_pair(RG)
    p = jrglru.rglru_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    return jcfg, cfg, p, _torch_tree(_np_tree(p))


@pytest.fixture(scope="module")
def ssm():
    jcfg, cfg = reduced_pair(MAMBA)
    p = jmamba.mamba_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, cfg, p, _torch_tree(_np_tree(p))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_rglru_gates_match_reference(rec):
    jcfg, cfg, jp, p = rec
    x = _x((2, 24, cfg.lru_width))
    wa, wx = jrglru._rglru_gates(jp, jnp.asarray(x))
    a, gx = rglru._rglru_gates(p, _t(x))
    _close(a, wa)
    _close(gx, wx)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 37, 300])
def test_linear_scan_matches_reference(s, with_h0):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 48)).astype(np.float32)
    bx = rng.standard_normal((2, s, 48)).astype(np.float32)
    h0 = rng.standard_normal((2, 48)).astype(np.float32) if with_h0 else None
    want = jax.jit(jrglru._linear_scan)(
        jnp.asarray(a), jnp.asarray(bx),
        None if h0 is None else jnp.asarray(h0))
    got = rglru._linear_scan(_t(a), _t(bx), None if h0 is None else _t(h0))
    _close(got, want, SCAN_TOL, scale=True)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_convs_match_reference(rec, with_state):
    jcfg, cfg, jp, p = rec
    x = _x((2, 9, cfg.lru_width), 1)
    state = _x((2, cfg.conv1d_width - 1, cfg.lru_width), 2) \
        if with_state else None
    want, wstate = jrglru._causal_conv(
        jnp.asarray(x), jp["conv_w"], jp["conv_b"],
        None if state is None else jnp.asarray(state))
    got, gstate = rglru._causal_conv(_t(x), p["conv_w"], p["conv_b"],
                                     None if state is None else _t(state))
    _close(got, want)
    _close(gstate, wstate)
    w = _x((4, 12), 3)
    b = _x((12,), 4)
    xs = _x((2, 9, 12), 5)
    _close(mamba2._causal_conv(_t(xs), _t(w), _t(b)),
           jmamba._causal_conv(jnp.asarray(xs), jnp.asarray(w),
                               jnp.asarray(b)))


def test_rglru_forward_with_state_matches_reference(rec):
    jcfg, cfg, jp, p = rec
    x = _x((2, 40, cfg.d_model), 6)
    state = {"conv": _x((2, cfg.conv1d_width - 1, cfg.lru_width), 7),
             "h": _x((2, cfg.lru_width), 8)}
    fwd = jax.jit(lambda pp, xx, st: jrglru.rglru_forward(pp, jcfg, xx, st))
    want, wstate = fwd(jp, jnp.asarray(x),
                       {k: jnp.asarray(v) for k, v in state.items()})
    got, gstate = rglru.rglru_forward(p, cfg, _t(x), _torch_tree(state))
    _close(got, want, TOL, scale=True)
    for k in ("conv", "h"):
        _close(gstate[k], wstate[k], TOL, scale=True)
    _close(rglru.rglru_forward(p, cfg, _t(x)),
           jax.jit(lambda pp, xx: jrglru.rglru_forward(pp, jcfg, xx))(
               jp, jnp.asarray(x)), TOL, scale=True)


def test_rglru_decode_step_matches_reference(rec):
    jcfg, cfg, jp, p = rec
    cache = {"conv": _x((2, cfg.conv1d_width - 1, cfg.lru_width), 9),
             "h": _x((2, cfg.lru_width), 10)}
    x = _x((2, 1, cfg.d_model), 11)
    want, wnew = jrglru.rglru_decode_step(
        jp, jcfg, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(x))
    got, new = rglru.rglru_decode_step(p, cfg, _torch_tree(cache), _t(x))
    _close(got, want)
    for k in ("conv", "h"):
        _close(new[k], wnew[k])


def test_softplus_is_exact_at_the_threshold():
    """``jax.nn.softplus`` is exact; ``F.softplus`` turns into the identity
    above 20.  The port's is the exact one, and the two torch forms part
    by less than 1e-8 there."""
    x = np.array([-30.0, -1.0, 0.0, 19.5, 20.0, 20.5, 30.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = rglru.softplus(_t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    assert float((F.softplus(_t(x)) - got).abs().max()) < 1e-8 * 30


def test_rglru_forward_matches_stepwise_decode(rec):
    """The reference's duality check on the port's side: the full-sequence
    forward equals the token-by-token decode."""
    _, cfg, _, p = rec
    b, s = 2, 24
    x = _t(_x((b, s, cfg.d_model), 12))
    full, state = rglru.rglru_forward(p, cfg, x, state={})
    cache = rglru.init_rglru_cache(cfg, b, torch.float32, "cpu")
    ys = []
    for t in range(s):
        y, cache = rglru.rglru_decode_step(p, cfg, cache, x[:, t:t + 1])
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(cache["h"].numpy(), state["h"].numpy(),
                               rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    rng = np.random.default_rng(13)
    b, s, h, pd, n = 2, 32, 4, 8, 6
    x = rng.standard_normal((b, s, h, pd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, pd, n)).astype(np.float32) \
        if with_h0 else None
    want, wfinal = jax.jit(jmamba._ssd_chunked, static_argnums=5)(
        *(jnp.asarray(v) for v in (x, dt, a, bm, cm)), 8,
        None if h0 is None else jnp.asarray(h0))
    got, final = mamba2._ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                                     8, None if h0 is None else _t(h0))
    _close(got, want, TOL, scale=True)
    _close(final, wfinal, TOL, scale=True)


@pytest.mark.parametrize("s", [512, 300])
def test_mamba_forward_matches_reference(ssm, s):
    """S=512: two chunks of 256; S=300: 256 does not divide it, so both
    sides run one 300-token chunk.  Outputs and the handed-off state."""
    jcfg, cfg, jp, p = ssm
    x = _x((2, s, cfg.d_model), s)
    want, wstate = jax.jit(lambda pp, xx: jmamba.mamba_forward(
        pp, jcfg, xx, state={}))(jp, jnp.asarray(x))
    got, state = mamba2.mamba_forward(p, cfg, _t(x), state={})
    _close(got, want, SSD_TOL, scale=True)
    _close(state["conv"], wstate["conv"])
    _close(state["ssm"], wstate["ssm"], SSD_TOL, scale=True)


def test_mamba_decode_step_matches_reference(ssm):
    jcfg, cfg, jp, p = ssm
    cache = {"conv": _x((2, cfg.ssm_dconv - 1, mamba2.conv_dim(cfg)), 14),
             "ssm": _x((2, mamba2.n_heads(cfg), cfg.ssm_headdim,
                        cfg.ssm_state), 15)}
    x = _x((2, 1, cfg.d_model), 16)
    want, wnew = jmamba.mamba_decode_step(
        jp, jcfg, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(x))
    got, new = mamba2.mamba_decode_step(p, cfg, _torch_tree(cache), _t(x))
    _close(got, want)
    for k in ("conv", "ssm"):
        _close(new[k], wnew[k])


def test_xbc_raw_tail_pads_a_short_sequence(ssm):
    jcfg, cfg, _, _ = ssm
    width = 2 * mamba2.d_inner(cfg) + 2 * cfg.ssm_state + mamba2.n_heads(cfg)
    for s in (2, 9):
        z = _x((2, s, width), s)
        _close(mamba2.xbc_raw_tail(_t(z), cfg, cfg.ssm_dconv),
               jmamba.xbc_raw_tail(jnp.asarray(z), jcfg, cfg.ssm_dconv))


def test_ssd_chunk_size_invariance(ssm):
    _, cfg, _, p = ssm
    x = _t(_x((2, 32, cfg.d_model), 17))
    outs = [mamba2.mamba_forward(p, cfg, x, chunk=c).numpy()
            for c in (4, 8, 16, 32)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=2e-4, atol=2e-5)


def test_ssd_forward_matches_stepwise_decode(ssm):
    _, cfg, _, p = ssm
    b, s = 2, 32
    x = _t(_x((b, s, cfg.d_model), 18))
    full, state = mamba2.mamba_forward(p, cfg, x, state={}, chunk=8)
    cache = mamba2.init_mamba_cache(cfg, b, torch.float32, "cpu")
    ys = []
    for t in range(s):
        y, cache = mamba2.mamba_decode_step(p, cfg, cache, x[:, t:t + 1])
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(cache["ssm"].numpy(), state["ssm"].numpy(),
                               rtol=2e-3, atol=2e-4)


def test_gradients_are_finite(rec, ssm):
    for fwd, (_, cfg, _, p0), kw in ((rglru.rglru_forward, rec, {}),
                                     (mamba2.mamba_forward, ssm,
                                      {"chunk": 8})):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        x = _t(_x((2, 16, cfg.d_model), 19))
        (fwd(p, cfg, x, **kw) ** 2).sum().backward()
        assert all(bool(torch.isfinite(v.grad).all()) for v in p.values())


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_init(arch: str):
    """One JAX init per arch (the weights do not depend on remat)."""
    jcfg, _ = reduced_pair(arch)
    return jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))


def _setup(arch, **kw):
    """(JAX model, its params, the port's model, a fresh bridged copy of
    the params: the train step updates them in place)."""
    jcfg, cfg = reduced_pair(arch, **kw)
    jparams = _jax_init(arch)
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    return jax_build_model(jcfg), jparams, build_model(cfg, "cpu"), params


def _batch(vocab, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch", FAMILY_ARCHS + LATE_DENSE_ARCHS)
def test_forward_and_loss_match_reference(arch):
    """S=96: past recurrentgemma's 64-token window.  On the CPU the
    port's attention layers take the flash kernel's plain version."""
    jmodel, jparams, model, params = _setup(arch)
    batch = _batch(model.cfg.vocab_size, 2, 96)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    want, _ = jax.jit(jmodel.forward)(jparams, jb)
    jtotal, jm = jax.jit(jmodel.loss)(jparams, jb)
    with torch.no_grad():
        got, aux = model.forward(params, tb)
        total, m = model.loss(params, tb)
    _close(got, want, LOGIT_TOL)
    assert float(aux) == 0.0
    for g, w in ((total, jtotal), (m["ce"], jm["ce"])):
        assert abs(float(g) - float(w)) <= LOSS_RTOL * (1 + abs(float(w)))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The trainer's path (``kernels=False``) with remat on both sides:
    the loss to 2e-5 and every gradient leaf within 2e-4 of its largest."""
    jmodel, jparams, model, params = _setup(arch, remat=True)
    batch = _batch(model.cfg.vocab_size, 2, 80, seed=1)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    leaves = list(optim.adamw.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    ops.reset_launch_counts()
    total, _ = model.loss(params, {k: _t(v) for k, v in batch.items()},
                          kernels=False)
    total.backward()
    assert not any(ops.launch_counts().values())
    assert abs(float(total.detach()) - float(jtotal)) <= LOSS_RTOL * (
        1 + abs(float(jtotal)))
    grads = ckpt.flatten_tree(optim.adamw.tree_map(lambda p: p.grad, params))
    want = ckpt.flatten_tree(bridge.from_jax_params(
        jax.tree.map(np.asarray, jgrads), model.cfg, "cpu"))
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        err = float(np.abs(grads[k].numpy() - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-6), k


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step against the jitted JAX step: metrics
    to 1e-4, every param element within lr and 99.9 % within 1e-6 (the
    bound of ``tests/test_torch_train.py``)."""
    jmodel, jparams, model, params = _setup(arch)
    kw = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jstep = jax.jit(jax_make_train_step(jmodel, joptim.OptimizerConfig(**kw),
                                        None))
    step = train_mod.make_train_step(model, optim.OptimizerConfig(**kw))
    pc = dict(seq_len=32, global_batch=2, vocab_size=model.cfg.vocab_size,
              seed=4)
    jb = Pipeline(PipelineConfig(**pc)).next_batch()
    jparams, _, jm = jstep(jparams, joptim.init(jparams),
                           {k: jnp.asarray(v) for k, v in jb.items()})
    params, _, m = step(params, optim.init(params),
                        {k: _t(v) for k, v in jb.items()})
    for key in ("loss", "ce", "grad_norm", "lr"):
        want = float(jm[key])
        assert abs(float(m[key]) - want) <= 1e-4 * (1 + abs(want)), key
    got = ckpt.flatten_tree(params)
    want = ckpt.flatten_tree(bridge.from_jax_params(
        jax.tree.map(np.asarray, jparams), model.cfg, "cpu"))
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w.numpy())
        assert err.max() <= kw["lr"], (k, err.max())
        assert np.mean(err <= 1e-6) >= 0.999, k


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_three_train_steps_match_reference(arch):
    """Three steps (remat on, ``Pipeline`` batches of 2 x 64, seed 1: the
    reduced training of ``chip_smoke.py``'s phase 8) against the jitted
    JAX step: metrics to 1e-4, every param element within lr, and at most
    one element in a thousand of a leaf beyond 1e-6, at least one on a
    leaf of fewer.  Both sides are right fp32 trainers that round in
    another order, and that alone leaves single elements of small leaves
    apart after three steps (recurrentgemma's 256-element ``attn/ln2``:
    one element, 1.5e-5), where a rule of 99.9 % of every leaf would ask
    a small leaf for no element at all."""
    jmodel, jparams, model, params = _setup(arch, remat=True)
    kw = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jstep = jax.jit(jax_make_train_step(jmodel, joptim.OptimizerConfig(**kw),
                                        None))
    step = train_mod.make_train_step(model, optim.OptimizerConfig(**kw))
    pipe = Pipeline(PipelineConfig(seq_len=64, global_batch=2,
                                   vocab_size=model.cfg.vocab_size, seed=1))
    jstate, state = joptim.init(jparams), optim.init(params)
    for _ in range(3):
        b = pipe.next_batch()
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: _t(v) for k, v in b.items()})
        for key in ("loss", "ce", "grad_norm", "lr"):
            want = float(jm[key])
            assert abs(float(m[key]) - want) <= 1e-4 * (1 + abs(want)), key
    got = ckpt.flatten_tree(params)
    want = ckpt.flatten_tree(bridge.from_jax_params(
        jax.tree.map(np.asarray, jparams), model.cfg, "cpu"))
    off = {}
    for k, w in want.items():
        err = np.abs(got[k].numpy() - w.numpy())
        assert err.max() <= kw["lr"], (k, err.max())
        n_off = int((err > 1e-6).sum())
        if n_off > max(1, err.size // 1000):
            off[k] = (n_off, err.size, float(err.max()))
    assert not off, off


def test_forward_routed_refuses_the_stateful_families():
    """As the reference's ``forward_routed``: the unified step needs a
    token-input attention family."""
    for arch in FAMILY_ARCHS:
        cfg = reduced_pair(arch)[1]
        model = build_model(cfg, "cpu")
        batch = {"tokens": torch.zeros((1, 2), dtype=torch.int32),
                 "lengths": torch.zeros((1,), dtype=torch.int32),
                 "seg_lens": torch.ones((1,), dtype=torch.int32)}
        with pytest.raises(NotImplementedError, match=cfg.family):
            model.forward_routed({}, batch, {})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# the reference engine over recurrentgemma's 64-slot attention ring:
# 72-token prompts (and shorter ones, padded to 72) roll into it, and
# every decode wraps it
RING_ENGINE = dict(max_batch=2, prefill_len=72, max_cache=96,
                   unified_step=False, paged=False)
PAGED_ENGINE = dict(max_batch=2, prefill_len=8, max_cache=24, chunk_len=3,
                    page_size=5, paged=True)
INT8 = dict(weight_quant="int8", kv_cache_dtype="int8")
# name -> (arch, config fields, engine, JAX-only engine fields, the
# port's async_steps, prompt lengths)
ENGINE_CASES = {
    "recurrentgemma-fp32": (RG, {}, RING_ENGINE, {}, True, (72, 40, 72, 20,
                                                             66)),
    "recurrentgemma-int8": (RG, INT8, RING_ENGINE, {}, True, (72, 40, 72)),
    "recurrentgemma-sequential": (RG, {}, dict(RING_ENGINE,
                                               batched_prefill=False), {},
                                  False, (72, 40, 72)),
    "mamba2-fp32": (MAMBA, {}, RING_ENGINE, {}, True, (72, 40, 72, 20, 66)),
    "qwen3moe-window16": ("qwen3_moe_30b_a3b",
                          dict(sliding_window=16, capacity_factor=8.0),
                          RING_ENGINE, {}, True, (72, 40, 72)),
    "qwen2-paged": (LATE_DENSE_ARCHS[0], {}, PAGED_ENGINE, {}, False,
                    (8, 5, 8, 3, 7)),
    "deepseek-paged-int8": (LATE_DENSE_ARCHS[1], INT8, PAGED_ENGINE, {},
                            True, (8, 5, 8, 3, 7)),
}
COUNTERS = ("prefill_tokens", "prefill_pad_tokens", "decode_steps",
            "decode_tokens", "mixed_prefill_tokens", "mixed_decode_tokens")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_streams_and_counters_match_reference(case):
    """Five requests over two slots (slots are reused, so the reference
    engine prefills while rows decode, and a stateful slot's prefill
    starts from its previous occupant's decoded state, as the
    reference's does): identical greedy streams, counters and memory."""
    arch, kw, engine, jkw, async_steps, lens = ENGINE_CASES[case]
    jcfg, cfg = reduced_pair(arch, jkw, **kw)
    raw = _jax_init(arch)     # the fields above change no weight
    rng = np.random.default_rng(3)
    traffic = [(rng.integers(0, 500, n), m) for n, m in zip(lens, (6, 4, 9,
                                                                   3, 5))]
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(async_steps=False,
                                                  **engine), params=raw)
    peng = ServingEngine(cfg, EngineConfig(async_steps=async_steps,
                                           **engine),
                         params=bridge.from_jax_params(
                             jax.tree.map(np.asarray, raw), cfg, "cpu"),
                         device="cpu")
    assert peng.unified == jeng.unified
    out = []
    for eng in (jeng, peng):
        uids = [eng.submit(p, max_new_tokens=n) for p, n in traffic]
        eng.run_until_done()
        out.append([list(eng._all[u].generated) for u in uids])
    assert out[1] == out[0]
    for key in COUNTERS:
        assert peng.stats[key] == jeng.stats[key], key
    assert peng.memory_stats() == jeng.memory_stats()


@pytest.mark.parametrize("arch,kw", [(RG, {}), (MAMBA, {}),
                                     ("qwen3_moe_30b_a3b",
                                      dict(sliding_window=16))])
def test_paged_pool_is_refused_where_the_reference_refuses_it(arch, kw):
    """A ring arch or a stateful family has no unified step: the paged
    pool (the port's default) raises the reference's ``ValueError``,
    which names ``paged=False``."""
    jcfg, cfg = reduced_pair(arch, **kw)
    with pytest.raises(ValueError, match="paged KV cache requires"):
        JaxServingEngine(jcfg, JaxEngineConfig(paged=True, max_cache=96),
                         params=_jax_init(arch))
    with pytest.raises(ValueError, match="paged=False"):
        ServingEngine(cfg, EngineConfig(max_cache=96), device="cpu")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launchers_run_the_families(arch, capsys):
    """The serve launcher takes the reference engine for these families
    (and prints no memory-fit line: the performance model has no layer
    formula for them); the train launcher takes three steps."""
    cfg = reduced_pair(arch)[1]
    eng, done = serve_mod.serve_demo(cfg, requests=3, new_tokens=4,
                                     prompt_len=16, device="cpu",
                                     max_batch=2)
    out = capsys.readouterr().out
    assert not eng.unified and not eng.paged
    assert len(done) == 3 and all(r.status == "done" for r in done)
    assert "batched + async (reference)" in out and "memory fit" not in out
    train_mod.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2
