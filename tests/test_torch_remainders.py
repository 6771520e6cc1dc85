"""Port vs JAX: the small remainders of modules ported earlier
(``core/dynamic_load.quota_topup`` and ``simulate_expected_experts``,
``core/quant.dequantize_tree``, ``core/moe.reference_moe``, and
``configs``' shape specs and re-exports), each on the same numpy inputs
as the reference's function, CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.core import dynamic_load as jax_dl
from repro.core import moe as jax_moe
from repro.core import perf_model as jax_perf_model
from repro.core import quant as jq
import repro_torch.configs as configs
from repro_torch.core import dynamic_load, moe, quant


# ---------------------------------------------------------------------------
# dynamic loading (paper §4.2)
# ---------------------------------------------------------------------------

def test_quota_topup_paper_example():
    """Fig. 6b: one node selects three experts, the other one; the second
    tops up to three with its least-recently-used experts."""
    sel = [[0, 1, 2], [5]]
    lru = [[3, 0, 1, 2], [7, 6, 4, 5]]
    got = dynamic_load.quota_topup(sel, lru)
    assert got == [[0, 1, 2], [5, 7, 6]]
    assert got == jax_dl.quota_topup(sel, lru)


@pytest.mark.parametrize("seed", range(4))
def test_quota_topup_matches_reference(seed):
    """Random selections (repeats included) and LRU orders over 2-4 nodes:
    the same executed sets as the reference's."""
    rng = np.random.default_rng(seed)
    n, e = int(rng.integers(2, 5)), 8
    sel = [[int(x) for x in rng.integers(0, e, int(rng.integers(0, 5)))]
           for _ in range(n)]
    sel[0] = sel[0] or [1]
    lru = [[int(x) for x in rng.permutation(e)] for _ in range(n)]
    assert dynamic_load.quota_topup(sel, lru) == jax_dl.quota_topup(sel, lru)


@pytest.mark.parametrize("n_nodes", [2, 3, 4])
@pytest.mark.parametrize("use_topup", [True, False])
def test_simulated_expected_experts_matches_reference(n_nodes, use_topup):
    """Table 1's setting (16 experts, top-4) on 2, 3 and 4 nodes: the same
    seed draws the same choices, so the estimate is the reference's to the
    bit."""
    kw = dict(n_tokens=200, n_layers=4, seed=n_nodes, use_topup=use_topup)
    got = dynamic_load.simulate_expected_experts(16, 4, n_nodes, **kw)
    assert got == jax_dl.simulate_expected_experts(16, 4, n_nodes, **kw)


def test_simulated_expected_experts_table1_trend():
    """The reference's bounds: without the top-up the estimate lies
    between 0.9 x the analytic value and E/n, and it falls with more
    nodes; with it each node executes as many experts as the busiest
    node selects, so the estimate is larger, and falls from 2 to 3 to 4
    nodes in the order of Table 1's 2.65 / 2.32 / 1.57 (the values differ:
    the paper's router is skewed, the simulation's uniform)."""
    plain, topped = {}, {}
    for n in (2, 3, 4):
        plain[n] = dynamic_load.simulate_expected_experts(
            16, 4, n, n_tokens=300, use_topup=False)
        topped[n] = dynamic_load.simulate_expected_experts(16, 4, n,
                                                           n_tokens=300)
        lo = 0.9 * jax_perf_model.expected_experts_per_node(16, 4, n)
        assert lo <= plain[n] <= 16 / n + 1e-9
        assert topped[n] >= plain[n]
    assert plain[4] < plain[2] and topped[4] < topped[3] < topped[2]
    paper = jax_perf_model.PAPER_EXPECTED_EXPERTS
    assert paper[4] < paper[3] < paper[2]


# ---------------------------------------------------------------------------
# the fake-quant reference tree
# ---------------------------------------------------------------------------

def _torch_tree(tree: dict) -> dict:
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("level", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_dequantize_tree_matches_reference(level, dtype):
    """A tree of quantized and fp leaves (norms, the embedding) dense
    again: every leaf bit-equal to the reference's, the fp leaves passed
    through untouched."""
    rng = np.random.default_rng(3)
    tree = {"embed": rng.standard_normal((32, 16)).astype(np.float32),
            "blocks": {"ln1": np.ones((2, 16), np.float32),
                       "attn": {"wq": rng.standard_normal(
                           (2, 16, 24)).astype(np.float32)},
                       "mlp": {"w_down": rng.standard_normal(
                           (2, 40, 16)).astype(np.float32)}}}
    want = jq.dequantize_tree(jq.quantize_tree(
        jax.tree.map(jnp.asarray, tree), level, block=16),
        jnp.dtype(dtype) if dtype else None)
    qt = quant.quantize_tree(_torch_tree(tree), level, block=16)
    assert isinstance(qt["blocks"]["attn"]["wq"], quant.QuantTensor)
    got = quant.dequantize_tree(qt, getattr(torch, dtype) if dtype else None)
    assert got["embed"] is qt["embed"]
    for path in (("embed",), ("blocks", "ln1"), ("blocks", "attn", "wq"),
                 ("blocks", "mlp", "w_down")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert not isinstance(g, quant.QuantTensor)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# the exact per-token MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("quantized", [False, True])
def test_reference_moe_matches(dtype, tol, quantized):
    """The exact top-k MoE (no capacity drop) against the reference's, raw
    and int8 experts; and, in fp32, equal to the capacity-free gather
    form on one device."""
    rng = np.random.default_rng(7)
    t, e, d, f, k = 12, 6, 32, 48, 2
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    ex = {"w_gate": mk(e, d, f), "w_up": mk(e, d, f), "w_down": mk(e, f, d)}
    x = rng.standard_normal((t, d)).astype(np.float32)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    w = rng.random((t, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jex = {kk: jnp.asarray(v, jdt) for kk, v in ex.items()}
    tex = {kk: torch.from_numpy(v).to(tdt) for kk, v in ex.items()}
    if quantized:
        jex = {kk: jq.quantize(v, "int8", block=16) for kk, v in jex.items()}
        tex = {kk: quant.quantize(v, "int8", block=16)
               for kk, v in tex.items()}
    want = jax_moe.reference_moe(jex, jnp.asarray(x, jdt), jnp.asarray(idx),
                                 jnp.asarray(w))
    got = moe.reference_moe(tex, torch.from_numpy(x).to(tdt),
                            torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    if dtype == "float32":
        gather = moe.gather_moe(tex, torch.from_numpy(x),
                                torch.from_numpy(idx), torch.from_numpy(w), 0)
        np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# configs: shape specs and re-exports
# ---------------------------------------------------------------------------

def test_configs_reexports_the_reference_names():
    """``repro_torch.configs`` exports every name ``repro.configs`` does."""
    want = {n for n in dir(jax_configs) if not n.startswith("_")
            and n != "base"}
    assert want <= set(dir(configs)), want - set(dir(configs))


def test_shapes_and_mixed_shape_match():
    assert {k: (v.name, v.kind, v.seq_len, v.global_batch, v.chunk_len)
            for k, v in configs.SHAPES.items()} == {
        k: (v.name, v.kind, v.seq_len, v.global_batch, v.chunk_len)
        for k, v in jax_configs.SHAPES.items()}
    got = configs.base.mixed_shape("m", 4096, 8, 32)
    want = jax_configs.base.mixed_shape("m", 4096, 8, 32)
    assert (got.name, got.kind, got.seq_len, got.global_batch,
            got.chunk_len) == (want.name, want.kind, want.seq_len,
                               want.global_batch, want.chunk_len)


def test_all_configs_cover_the_reference():
    """Every arch of the reference's registry, with the same published
    widths; the port's registry adds DBRX, which the reference reaches by
    name only."""
    got, want = configs.all_configs(), jax_configs.all_configs()
    assert set(want) <= set(got)
    for a, jc in want.items():
        c = got[a]
        assert (c.family, c.num_layers, c.d_model, c.vocab_size) == (
            jc.family, jc.num_layers, jc.d_model, jc.vocab_size), a


SPEC_SHAPES = [jax_configs.base.mixed_shape("mixed", 256, 3, 16)] + list(
    jax_configs.SHAPES.values())


@pytest.mark.parametrize("arch", list(jax_configs.ARCH_IDS) + ["dbrx"])
@pytest.mark.parametrize("shape", SPEC_SHAPES, ids=lambda s: s.name)
def test_input_specs_match(arch, shape):
    """Every arch's inputs for every shape: the same keys, shapes and
    dtypes as the reference's ``ShapeDtypeStruct``s, as meta tensors."""
    want = jax_configs.input_specs(jax_configs.get_config(arch), shape)
    got = configs.input_specs(configs.get_config(arch), configs.base.ShapeSpec(
        shape.name, shape.kind, shape.seq_len, shape.global_batch,
        shape.chunk_len))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k
