"""The port's stochastic sampler against the exact top-k softmax law, and
the JAX reference's sampler against the same law.

The CPU and CUDA generators and JAX's ``fold_in`` draw different numbers,
so sampled tokens are compared as distributions across frameworks and
devices, and as exact streams only on one device with one seed.  Greedy
rows (``temperature == 0``, or ``top_k == 1``) are exact everywhere.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.faults import Fault, FaultPlan
from torch_archs import ARCHS, reduced_pair

ARCH = ARCHS[0]
B, V, STEPS, T, K = 3, 50, 20_000, 0.7, 5
TV_BOUND = 0.02


def _logits() -> np.ndarray:
    """Fixed (B, V) logits with distinct values, so each row's top k is
    unambiguous."""
    rng = np.random.default_rng(3)
    return np.stack([rng.permutation(V) * 0.15 + rng.normal(0, 0.01, V)
                     for _ in range(B)]).astype(np.float32)


def _law(logits: np.ndarray) -> np.ndarray:
    """The exact law: softmax(logits / T) over each row's top k."""
    scaled = logits.astype(np.float64) / T
    kth = np.sort(scaled, axis=-1)[:, -K][:, None]
    p = np.where(scaled >= kth, np.exp(scaled - scaled.max(-1)[:, None]), 0)
    return p / p.sum(-1, keepdims=True)


def _check_law(draws: np.ndarray, logits: np.ndarray) -> None:
    """draws (STEPS, B): never outside the top k, and within TV_BOUND of
    the exact law in every row."""
    law = _law(logits)
    for r in range(B):
        emp = np.bincount(draws[:, r], minlength=V) / len(draws)
        assert emp[law[r] == 0].sum() == 0, f"row {r} drew outside the top k"
        tv = 0.5 * np.abs(emp - law[r]).sum()
        assert tv < TV_BOUND, f"row {r}: total variation {tv:.4f}"


def _model(arch=ARCH, **kw):
    jcfg, cfg = reduced_pair(arch, capacity_factor=8.0, **kw)
    raw = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, raw, from_jax_params(jax.tree.map(np.asarray, raw),
                                           cfg, "cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


def _port(model, **kw):
    _, cfg, _, params = model
    eng_kw = dict(max_batch=2, max_cache=32, chunk_len=8, page_size=4,
                  async_steps=False)
    plan = kw.pop("fault_plan", None)
    return ServingEngine(cfg, EngineConfig(**{**eng_kw, **kw}),
                         params=params, device="cpu", fault_plan=plan)


def _sampler(model, vocab: int) -> ServingEngine:
    """A port engine whose ``_sample_next`` samples over ``vocab`` columns
    (the sampler reads only the config's vocab size), stochastic on."""
    eng = _port(model)
    eng.cfg = eng.cfg.replace(vocab_size=vocab)
    eng._sampling = True
    return eng


# ---------------------------------------------------------------------------
# the law
# ---------------------------------------------------------------------------

def test_port_sampler_matches_topk_softmax_law(model):
    logits = _logits()
    eng = _sampler(model, V)
    lg = torch.as_tensor(logits)
    temps = torch.full((B,), T)
    topks = torch.full((B,), K, dtype=torch.int32)
    draws = np.stack([eng._sample_next(lg, temps, topks, s).numpy()
                      for s in range(STEPS)])
    _check_law(draws, logits)


def test_jax_sampler_matches_topk_softmax_law():
    logits = _logits()
    stub = types.SimpleNamespace(cfg=types.SimpleNamespace(vocab_size=V),
                                 _sample_key=jax.random.PRNGKey(0))
    lg = jnp.asarray(logits)
    temps = jnp.full((B,), T, jnp.float32)
    topks = jnp.full((B,), K, jnp.int32)
    draw = jax.jit(jax.vmap(lambda s: JaxServingEngine._sample_next(
        stub, lg, temps, topks, s, True)))
    _check_law(np.asarray(draw(jnp.arange(STEPS, dtype=jnp.int32))), logits)


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (0.0, 5), (0.7, 1),
                                        (2.0, 1)])
def test_greedy_cases_are_argmax(model, temp, top_k):
    """temperature 0, or a top-k of 1, is the argmax exactly."""
    logits = torch.as_tensor(_logits())
    eng = _sampler(model, V)
    temps = torch.full((B,), temp)
    topks = torch.full((B,), top_k, dtype=torch.int32)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    for s in range(50):
        assert torch.equal(eng._sample_next(logits, temps, topks, s), want)


def test_padded_vocab_columns_never_drawn(model):
    """Columns past vocab_size (padding) are never drawn, even when they
    hold the largest logits and no top-k cut applies."""
    eng = _sampler(model, V - 6)
    logits = torch.as_tensor(_logits())
    logits[:, V - 6:] = 1e4
    temps = torch.full((B,), 5.0)
    for topk in (0, 10):
        topks = torch.full((B,), topk, dtype=torch.int32)
        draws = torch.stack([eng._sample_next(logits, temps, topks, s)
                             for s in range(2000)])
        assert int(draws.max()) < V - 6
    greedy = eng._sample_next(logits, torch.zeros(B), topks, 0)
    assert int(greedy.max()) < V - 6


def test_padded_vocab_through_the_engine():
    """Granite's reduced arch pads its vocab (500 of 512): a sampled serve
    over the full vocabulary never emits a padded column."""
    m = _model(ARCHS[1])
    cfg = m[1]
    assert cfg.vocab_padded > cfg.vocab_size
    eng = _port(m)
    rng = np.random.default_rng(1)
    uids = [eng.submit(rng.integers(0, cfg.vocab_size, 6), 20,
                       temperature=3.0, top_k=0) for _ in range(3)]
    eng.run_until_done()
    toks = [t for u in uids for t in eng._all[u].generated]
    assert len(toks) == 60 and max(toks) < cfg.vocab_size


# ---------------------------------------------------------------------------
# through the engine
# ---------------------------------------------------------------------------

def _mixed(model, hot_temp, seed=0, plan=None):
    rng = np.random.default_rng(5)
    p_greedy, p_hot = rng.integers(0, 100, 8), rng.integers(0, 100, 8)
    eng = _port(model, sample_seed=seed, fault_plan=plan)
    u1 = eng.submit(p_greedy, max_new_tokens=6)
    u2 = eng.submit(p_hot, max_new_tokens=6, temperature=hot_temp, top_k=16)
    eng.run_until_done()
    return list(eng._all[u1].generated), list(eng._all[u2].generated)


def test_mixed_batch_greedy_rows_match_jax(model):
    """In a batch with a sampled row, the greedy row's stream equals the
    JAX engine's for the same batch (and its own greedy-only run)."""
    jcfg, cfg, raw, _ = model
    rng = np.random.default_rng(5)
    p_greedy, p_hot = rng.integers(0, 100, 8), rng.integers(0, 100, 8)
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(
        max_batch=2, prefill_len=8, max_cache=32, unified_step=True,
        chunk_len=8, async_steps=False, paged=True, page_size=4),
        params=raw)
    u1 = jeng.submit(p_greedy, max_new_tokens=6)
    u2 = jeng.submit(p_hot, max_new_tokens=6, temperature=1.5, top_k=16)
    jeng.run_until_done()
    g_port, h_port = _mixed(model, 1.5)
    assert g_port == list(jeng._all[u1].generated)
    assert g_port == _mixed(model, 0.0)[0]
    assert all(0 <= t < cfg.vocab_size for t in h_port)
    assert len(jeng._all[u2].generated) == len(h_port) == 6


def test_sample_seed_replays_and_differs(model):
    """The same sample_seed replays a sampled stream on the CPU; another
    seed changes it; sampling changes the tokens at all."""
    _, h1 = _mixed(model, 1.5, seed=0)
    _, h2 = _mixed(model, 1.5, seed=0)
    _, h3 = _mixed(model, 1.5, seed=1)
    _, h0 = _mixed(model, 0.0)
    assert h1 == h2
    assert h1 != h3
    assert h1 != h0


def test_dispatch_faults_keep_sampled_streams(model):
    """A dispatch-only plan: the failed iterations do not advance the
    sampler's step index, so the sampled streams equal the fault-free
    ones."""
    plan = FaultPlan([Fault(s, "dispatch") for s in (2, 3, 6)])
    assert _mixed(model, 1.5, plan=plan) == _mixed(model, 1.5)
    assert plan.all_fired()


def test_greedy_only_serve_never_sorts(model, monkeypatch):
    """Until a stochastic request is submitted the sampler is one argmax:
    the sort and the draws do not run."""
    calls = []
    real = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    eng = _port(model)
    eng.submit(np.arange(8), 4)
    eng.run_until_done()
    assert not eng._sampling and not calls
    eng.submit(np.arange(8), 4, temperature=0.5)
    eng.run_until_done()
    assert eng._sampling and calls
