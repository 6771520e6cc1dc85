"""Port vs JAX: router, dispatch plan and the MoE execution forms on the
same numpy inputs (fp32, CPU).  ``use_kernel=True`` on the JAX side runs
its Pallas grouped FFN in interpret mode; the port's expert FFN takes its
plain version on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import expert_parallel as jax_ep
from repro.core import moe as jax_moe
from repro.core import router as jax_router
from repro_torch.configs.base import get_config
from repro_torch.core import expert_parallel, moe, router

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _experts(rng, e, d, f):
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    return {"w_gate": mk(e, d, f), "w_up": mk(e, d, f), "w_down": mk(e, f, d)}


def _routing(rng, t, k, e):
    """Distinct experts per token, weights normalized, like the router."""
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    w = rng.random((t, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("t,e,k,n_valid", [(16, 8, 2, 8), (33, 12, 4, 10)])
def test_route_matches(t, e, k, n_valid):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, 32)).astype(np.float32)
    w = (rng.standard_normal((32, e)) * 0.3).astype(np.float32)
    want = jax_router.route(jnp.asarray(w), jnp.asarray(x), k,
                            n_valid_experts=n_valid)
    got = router.route(_t(w), _t(x), k, n_valid_experts=n_valid)
    np.testing.assert_array_equal(got.top_idx.numpy(), np.asarray(want.top_idx))
    np.testing.assert_allclose(got.top_w.numpy(), np.asarray(want.top_w),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    assert int(got.top_idx.max()) < n_valid


@pytest.mark.parametrize("case", ["binding", "dead_routed", "local_shard"])
def test_dispatch_plan_exact(case):
    rng = np.random.default_rng(1)
    t, k, e = 24, 2, 4
    idx, _ = _routing(rng, t, k, e)
    e_start, e_local, cap = 0, e, 8           # 48 decisions over 32 slots
    if case == "dead_routed":
        idx[::3] = e                          # the E_pad sentinel
        cap = 16
    if case == "local_shard":
        e_start, e_local, cap = 2, 2, 12
    want = jax_moe.make_dispatch_plan(jnp.asarray(idx), e, e_start, e_local,
                                      cap)
    got = moe.make_dispatch_plan(_t(idx), e, e_start, e_local, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "binding":
        assert int(got[2].eq(e_local * cap).sum()) > 0    # some dropped


def _moe_inputs(seed, t=20, d=32, f=48, e=4, k=2):
    rng = np.random.default_rng(seed)
    ex = _experts(rng, e, d, f)
    x = (rng.standard_normal((t, d)) * 0.5).astype(np.float32)
    idx, w = _routing(rng, t, k, e)
    return ex, x, idx, w


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("cap", [8, 24])      # binding and non-binding
def test_dispatch_moe_matches(cap):
    ex, x, idx, w = _moe_inputs(2)
    jex = {k: jnp.asarray(v) for k, v in ex.items()}
    want = jax_moe.dispatch_moe(jex, jnp.asarray(x), jnp.asarray(idx),
                                jnp.asarray(w), 4, 0, cap, use_kernel=True)
    got = moe.dispatch_moe({k: _t(v) for k, v in ex.items()}, _t(x), _t(idx),
                           _t(w), 4, 0, cap)
    _close(got, want)


def test_gather_moe_matches():
    ex, x, idx, w = _moe_inputs(3, t=3)
    idx[1, 0] = 4                             # dead route: contributes zero
    jex = {k: jnp.asarray(v) for k, v in ex.items()}
    want = jax_moe.gather_moe(jex, jnp.asarray(x), jnp.asarray(idx),
                              jnp.asarray(w), 0)
    got = moe.gather_moe({k: _t(v) for k, v in ex.items()}, _t(x), _t(idx),
                         _t(w), 0)
    _close(got, want)


def test_gather_moe_never_reads_router_dead_experts():
    """Padding tokens dead-routed to the E_pad sentinel read a live expert
    (with weight 0), not the router-dead padding at the end of the stack:
    NaN there leaves every output row finite."""
    rng = np.random.default_rng(9)
    ex = _experts(rng, 6, 8, 16)
    for w in ex.values():
        w[4:] = np.nan                         # experts 4, 5: router-dead
    x = rng.standard_normal((3, 8)).astype(np.float32)
    idx = np.array([[0, 3], [6, 6], [2, 1]], np.int32)
    w = np.array([[0.7, 0.3], [0.0, 0.0], [0.5, 0.5]], np.float32)
    got = moe.gather_moe({k: _t(v) for k, v in ex.items()}, _t(x), _t(idx),
                         _t(w), 0)
    assert bool(torch.isfinite(got).all())
    assert bool((got[1] == 0).all())


def _bf16_steps(got: torch.Tensor, want) -> np.ndarray:
    """How many bf16 values lie between ``got`` and ``want``, per element."""
    def ordered(bits):
        i = bits.astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    g = got.contiguous().view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    return np.abs(ordered(g) - ordered(w))


def test_gather_moe_bf16_keeps_reference_rounding():
    """bf16 decode form: g, u and y stay fp32 and only h is rounded, as in
    the reference, so the two differ by at most one bf16 step and only
    where fp32 summation order tips a rounding.  Rounding g, u or y to
    bf16 as well moves about 60 % of the outputs."""
    rng = np.random.default_rng(8)
    t, d, f, e, k = 4, 64, 96, 8, 4
    ex = _experts(rng, e, d, f)
    x = rng.standard_normal((t, d)).astype(np.float32)
    idx, w = _routing(rng, t, k, e)
    idx[2, 1] = e                             # dead route: contributes zero
    want = jax_moe.gather_moe(
        {k_: jnp.asarray(v, jnp.bfloat16) for k_, v in ex.items()},
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(idx), jnp.asarray(w), 0)
    got = moe.gather_moe({k_: _t(v).bfloat16() for k_, v in ex.items()},
                         _t(x).bfloat16(), _t(idx), _t(w), 0)
    assert got.dtype == torch.bfloat16
    steps = _bf16_steps(got, want)
    assert steps.max() <= 1 and (steps > 0).mean() <= 0.02


def test_dense_moe_matches():
    ex, x, idx, w = _moe_inputs(4, t=6)
    jex = {k: jnp.asarray(v) for k, v in ex.items()}
    want = jax_moe.dense_moe(jex, jnp.asarray(x), jnp.asarray(idx),
                             jnp.asarray(w), 0, use_kernel=True)
    got = moe.dense_moe({k: _t(v) for k, v in ex.items()}, _t(x), _t(idx),
                        _t(w), 0)
    _close(got, want)


def test_round_capacity_matches():
    for args in [(1, 8, 128, 1.25), (128, 8, 128, 1.25), (6, 2, 4, 8.0),
                 (1000, 2, 4, 1.0)]:
        assert moe.round_capacity(*args) == jax_moe.round_capacity(*args)


# moe_layer at (B, S) shapes that reach each form of _local_moe on the
# reduced config (E=4, K=2): gather (T*K <= E), dense (T below capacity),
# dispatch (T*K above gather_decode_max_tk), with a token mask
@pytest.mark.parametrize("b,s,strategy,masked", [
    (2, 1, "dispatch", False),      # gather
    (2, 3, "dispatch", True),       # one-hot dense
    (4, 20, "dispatch", True),      # capacity dispatch
    (2, 3, "dense", False),         # moe_strategy="dense"
])
def test_moe_layer_matches(b, s, strategy, masked):
    jcfg = jax_get_config("qwen3_moe_30b_a3b").reduced().replace(
        capacity_factor=8.0, use_kernel=True, moe_strategy=strategy)
    cfg = get_config("qwen3_moe_30b_a3b").reduced().replace(
        capacity_factor=8.0, moe_strategy=strategy)
    rng = np.random.default_rng(b * 10 + s)
    d, e = cfg.d_model, cfg.num_experts_padded
    layer = {"router": (rng.standard_normal((d, e)) * 0.1).astype(np.float32),
             "experts": _experts(rng, e, d, cfg.d_ff)}
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    mask = rng.random((b, s)) > 0.3 if masked else None
    jlayer = {"router": jnp.asarray(layer["router"]),
              "experts": {k: jnp.asarray(v)
                          for k, v in layer["experts"].items()}}
    wy, waux, widx = jax_ep.moe_layer(
        jcfg, None, jlayer, jnp.asarray(x),
        None if mask is None else jnp.asarray(mask))
    player = {"router": _t(layer["router"]),
              "experts": {k: _t(v) for k, v in layer["experts"].items()}}
    gy, gaux, gidx = expert_parallel.moe_layer(
        cfg, player, _t(x), None if mask is None else _t(mask))
    _close(gy, wy)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)
