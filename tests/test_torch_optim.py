"""The port's AdamW (``repro_torch.optim``) against the JAX package's
``repro.optim`` on the same numpy trees.

Tolerances: the schedule and the global norm in fp32 to a relative 1e-6;
three updates of an fp32 tree to 1e-6 in the params and the moments (the
port updates IN PLACE with fused multiply-adds where XLA rounds each
product); three updates of a bf16 tree to one bf16 ulp of each weight (an
ulp-level difference in the fp32 update can round a bf16 weight the
other way).  Then the reference substrate tests' properties: convergence
on a quadratic, decay shrinking a weight with a zero gradient."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim

CFG = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=1.0)
SHAPES = {"embed": (11, 6), "blocks": {"w": (3, 4, 5), "ln": (3, 6)},
          "experts": {"w_up": (2, 3, 4, 5)}, "bias": (7,)}


def _tree(rng, scale=1.0, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(dtype), tree)


def _np(tree):
    return jax.tree.map(lambda t: t.float().numpy(), tree)


def test_lr_schedule_matches_reference():
    jcfg, cfg = joptim.OptimizerConfig(**CFG), optim.OptimizerConfig(**CFG)
    for step in range(25):
        want = float(joptim.lr_at(jcfg, jnp.asarray(step)))
        got = optim.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want), step
    # the reference suite's fixed points
    c = optim.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110)
    at = lambda s: float(optim.lr_at(c, torch.tensor(s)))
    assert at(0) == 0.0 and abs(at(5) - 0.5) < 1e-6
    assert abs(at(10) - 1.0) < 1e-6 and abs(at(110) - 0.1) < 1e-6


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_clip_by_global_norm_matches_reference(scale):
    g = _tree(np.random.default_rng(1), scale)
    want, want_norm = joptim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    got, norm = optim.clip_by_global_norm(_torch(g), 1.0)
    assert abs(float(norm) - float(want_norm)) <= 1e-6 * float(want_norm)
    for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    if scale > 1:
        assert abs(float(optim.global_norm(got)) - 1.0) < 1e-5


def _three_updates(dtype):
    rng = np.random.default_rng(2)
    p0 = _tree(rng, 0.5)
    grads = [_tree(rng, s) for s in (0.05, 3.0, 0.2)]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg, cfg = joptim.OptimizerConfig(**CFG), optim.OptimizerConfig(**CFG)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    js = joptim.init(jp)
    tp = _torch(p0, dtype)
    ts = optim.init(tp)
    for g in grads:
        jp, js, jm = joptim.update(
            jcfg, jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js, jp)
        tp, ts, m = optim.update(cfg, _torch(g, dtype), ts, tp)
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 3
    return jp, js, tp, ts


def test_three_updates_match_reference_fp32():
    jp, js, tp, ts = _three_updates(torch.float32)
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(want)):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def test_three_updates_match_reference_bf16_within_one_ulp():
    """bf16 params, no fp32 master copy on either side; fp32 moments."""
    jp, js, tp, ts = _three_updates(torch.bfloat16)
    for a, b in zip(jax.tree.leaves(_np(tp)), jax.tree.leaves(jp)):
        b = np.asarray(b.astype(jnp.float32))
        ulp = np.spacing(np.abs(b).astype(ml_dtypes.bfloat16)).astype(
            np.float32)
        assert np.all(np.abs(a - b) <= ulp), np.max(np.abs(a - b) / ulp)
    for got, want in ((ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


def test_update_is_in_place():
    tp = _torch(_tree(np.random.default_rng(3)))
    ts = optim.init(tp)
    g = _torch(_tree(np.random.default_rng(4)))
    w = tp["blocks"]["w"]
    before = w.clone()
    p2, ts2, _ = optim.update(optim.OptimizerConfig(**CFG), g, ts, tp)
    assert p2["blocks"]["w"] is w and not torch.equal(w, before)
    assert ts2.mu["blocks"]["w"] is ts.mu["blocks"]["w"]


def test_adamw_converges_on_quadratic():
    cfg = optim.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                                weight_decay=0.0, clip_norm=1e9)
    params = {"x": torch.tensor([5.0, -3.0])}
    st = optim.init(params)
    for _ in range(200):
        params, st, _ = optim.update(cfg, {"x": 2 * params["x"]}, st, params)
    assert float((params["x"] ** 2).sum()) < 1e-2


def test_adamw_weight_decay_shrinks():
    cfg = optim.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=100,
                                weight_decay=1.0, clip_norm=1e9)
    params = {"x": torch.tensor([1.0])}
    p2, _, _ = optim.update(cfg, {"x": torch.zeros(1)}, optim.init(params),
                            params)
    assert float(p2["x"][0]) < 1.0
