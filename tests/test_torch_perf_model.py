"""The port's copy of the paper's performance model (``core/perf_model``)
against the JAX package's, function by function, on every ported arch at
full size and reduced (exact for byte counts and other whole numbers, 1e-12
relative for the rest); its published numbers (paper Tables 1, 5 and 6, as
``tests/test_perf_model.py`` holds the reference to them); its weight- and
KV-byte model against the port's own engine; and the engine's keep-warm
``standby()`` against the reference's on bf16, int8 and int4 trees."""
import dataclasses
import inspect
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import perf_model as jpm
from repro.core import quant as jq
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.core import perf_model as pm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from torch_archs import ARCHS, DENSE_ARCHS, reduced_pair

HARDWARE = ("M2_ULTRA_10GBE", "M2_ULTRA_ROCE", "M2_ULTRA_IB", "TPU_V5E",
            "DGX_H100x8")
CONSTANTS = HARDWARE + ("PAPER_EXPECTED_EXPERTS", "DBRX_TABLE1",
                        "M2_ULTRA_MEM_BYTES", "WEIGHT_QUANT_LEVELS",
                        "PAPER_TABLE5")
LEVELS = ("none", "int8", "int4")
SCHEDULES = ("decentralized", "centralized", "a2a", "a2a_pipelined")


def _calls(m, cfg) -> dict:
    """Every public function of the perf-model module ``m`` on ``cfg``:
    name -> list of results over a sweep of its other arguments."""
    w = m.MoEWorkload.from_config(cfg)
    hws = [getattr(m, h) for h in HARDWARE]
    e, k = cfg.num_experts, cfg.experts_per_token
    lengths = [0, 5, 17, 40, 63]
    kv = [cfg.replace(kv_cache_dtype=d) for d in ("native", "int8")]
    return {
        "d_out_attn": [m.d_out_attn(cfg)],
        "from_config": [w, m.MoEWorkload.from_config(cfg, precision=1)],
        "expected_experts_per_node": [
            m.expected_experts_per_node(e, k, n, batch=b)
            for n in (1, 2, 4) for b in (1, 7, 64)],
        "estimate": [m.estimate(w, hw, n, microchunks=mc) for hw in hws
                     for n in (2, 3, 4, 8) for mc in (1, 4)]
        + [m.estimate(w, hws[0], 2, expected_experts=1.7)],
        # Table 6's rounded column divides by the bound rounded to 1 ms:
        # the 10 GbE profile's latency keeps it above zero
        "scaling_table": [m.scaling_table(w, m.M2_ULTRA_10GBE, microchunks=mc)
                          for mc in (1, 4)] + [m.scaling_table()],
        "mixed_step_estimate": [
            m.mixed_step_estimate(w, hw, n, decode_rows=4, chunk_len=c,
                                  num_experts=e, top_k=k, microchunks=mc)
            for hw in hws[:2] for n in (2, 4) for c in (0, 32)
            for mc in (1, 2)],
        "chunked_prefill_ttft": [
            m.chunked_prefill_ttft(w, hw, 2, prompt_len=p, chunk_len=c,
                                   decode_rows=3, num_experts=e, top_k=k)
            for hw in hws[:2] for p in (1, 100, 256) for c in (16, 64)],
        "prefix_hit_ttft": [
            m.prefix_hit_ttft(w, hws[0], 2, prompt_len=256, shared_len=sl,
                              chunk_len=64, page_size=ps, num_experts=e,
                              top_k=k)
            for sl in (0, 100, 256) for ps in (1, 16)],
        "quant_matrix_bytes": [
            m.quant_matrix_bytes(kk, cfg.d_ff, itemsize=2, quant=q, block=b,
                                 lead=cfg.num_experts_padded)
            for kk in (cfg.d_model, cfg.d_model + 1) for q in LEVELS
            for b in (64, 128)],
        "weight_bytes_per_layer": [m.weight_bytes_per_layer(cfg, quant=q)
                                   for q in (None,) + LEVELS]
        + [m.weight_bytes_per_layer(cfg, quant="int8", block=64)],
        "expert_weight_bytes": [m.expert_weight_bytes(cfg, quant=q)
                                for q in (None,) + LEVELS],
        "model_weight_bytes": [m.model_weight_bytes(cfg, quant=q)
                               for q in (None,) + LEVELS],
        "per_node_weight_bytes": [
            m.per_node_weight_bytes(cfg, n_nodes=n, quant=q)
            for n in (1, 2, 4) for q in LEVELS],
        "fits_in_memory": [
            m.fits_in_memory(cfg, n_nodes=n, quant=q, kv_pool_bytes=kvb)
            for n in (1, 2) for q in LEVELS for kvb in (0.0, 50e9)],
        "max_model_at_budget": [
            m.max_model_at_budget(cfg, n_nodes=n, budget=bud)
            for n in (1, 2) for bud in (m.M2_ULTRA_MEM_BYTES, 80e9)],
        "kv_bytes_per_token": [m.kv_bytes_per_token(c) for c in kv]
        + [m.kv_bytes_per_token(n_layers=cfg.num_layers,
                                num_kv_heads=cfg.num_kv_heads,
                                head_dim=cfg.head_dim, precision=4)],
        "paged_attention_read_bytes": [
            m.paged_attention_read_bytes(c, lengths=lengths, page_size=ps,
                                         max_blocks=-(-64 // ps))
            for c in kv for ps in (5, 16)],
        "max_concurrent_requests": [
            m.max_concurrent_requests(1e9, m.kv_bytes_per_token(cfg), mc,
                                      page_size=ps, slot_len=sl)
            for mc in (100, 512) for ps in (0, 16) for sl in (0, 4096)],
        "serving_capacity": [
            m.serving_capacity(c, pool_bytes=2e9, max_cache=4096,
                               mean_context=512, page_size=16) for c in kv],
        "node_serving_capacity": [
            m.node_serving_capacity(cfg, n_nodes=n, max_cache=4096,
                                    mean_context=512, page_size=16, quant=q)
            for n in (1, 2) for q in (None,) + LEVELS],
        "cost_efficiency": [m.cost_efficiency(9.7, n, hw) for hw in hws
                            if hw.price_per_node for n in (1, 2)],
        "paper_table5": [m.paper_table5()],
        "predicted_collective_bytes": [
            m.predicted_collective_bytes(
                cfg.replace(expert_parallel=s, ep_microchunks=2), batch=b,
                seq=sq, n_exp_shards=n, n_batch_shards=nb,
                include_tp=tp)
            for s in SCHEDULES for n in (1, 2, 4) for b, sq in ((2, 8), (4, 1))
            for nb in (1, 2) for tp in (True, False)],
    }


FUNCS = ("d_out_attn", "from_config", "expected_experts_per_node",
         "estimate", "scaling_table", "mixed_step_estimate",
         "chunked_prefill_ttft", "prefix_hit_ttft", "quant_matrix_bytes",
         "weight_bytes_per_layer", "expert_weight_bytes",
         "model_weight_bytes", "per_node_weight_bytes", "fits_in_memory",
         "max_model_at_budget", "kv_bytes_per_token",
         "paged_attention_read_bytes", "max_concurrent_requests",
         "serving_capacity", "node_serving_capacity", "cost_efficiency",
         "paper_table5", "predicted_collective_bytes")


def _plain(v):
    """A result as plain data; an Estimate keeps its derived totals."""
    if dataclasses.is_dataclass(v):
        out = {"type": type(v).__name__, **dataclasses.asdict(v)}
        for prop in ("gpu_time", "comm_time", "total", "throughput"):
            if hasattr(type(v), prop):
                out[prop] = getattr(v, prop)
        return out
    return v


def _same(got, want, where: str) -> None:
    got, want = _plain(got), _plain(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for key in want:
            _same(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and np.isfinite(want) \
            and not want.is_integer():
        assert got == pytest.approx(want, rel=1e-12, abs=0), where
    else:                   # whole numbers (byte counts), bools, names, inf
        assert type(got) is type(want) and got == want, where


def _configs(arch: str, reduced: bool):
    if reduced:
        return reduced_pair(arch)
    return jax_get_config(arch), get_config(arch)


SWEEP = [(a, r) for a in ARCHS for r in (False, True)]


@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("arch,reduced", SWEEP,
                         ids=[f"{a}-{'reduced' if r else 'full'}"
                              for a, r in SWEEP])
def test_function_matches_reference(arch, reduced, name):
    jcfg, cfg = _configs(arch, reduced)
    _same(_calls(pm, cfg)[name], _calls(jpm, jcfg)[name], name)


def test_sweep_covers_the_module():
    """The port has the reference's public functions and constants, and
    the sweep above calls every function."""
    public = lambda m: {n for n, f in vars(m).items() if not n.startswith("_")
                        and inspect.isfunction(f) and f.__module__ == m.__name__}
    assert public(pm) == public(jpm)
    assert public(jpm) == set(FUNCS) - {"from_config"}
    assert tuple(_calls(pm, get_config(ARCHS[0]).reduced())) == FUNCS
    for name in CONSTANTS:
        _same(getattr(pm, name), getattr(jpm, name), name)


def test_published_tables_reproduced():
    """Table 6's bounds on 2-8 nodes, Table 5's cost efficiency and Table
    1's DBRX variables from the port's DBRX config, as the reference's
    tests hold them."""
    rows = {r["nodes"]: r for r in pm.scaling_table()}
    for n, tp in {2: 9.7, 3: 10.4, 4: 12.3, 6: 13.9, 8: 14.2}.items():
        assert abs(rows[n]["tokens_per_sec"] - tp) / tp < 0.01
    t5 = pm.paper_table5()
    assert round(t5["ours-2xm2ultra"] / t5["databricks-8xh100"], 2) == 1.15
    w = pm.MoEWorkload.from_config(get_config("dbrx"))
    assert abs(w.params_sa_bytes - 7e9) / 7e9 < 0.15
    assert abs(w.params_expert_bytes - 16e9) / 16e9 < 0.05
    assert abs(w.comm_bytes - 2e6) / 2e6 < 0.05


def test_dbrx_memory_fit_headline():
    """DBRX in bf16 does not fit one 192 GB M2 Ultra but does in int8, and
    two nodes host it unquantized (the paper's own setup)."""
    dbrx = get_config("dbrx-132b")
    one = pm.max_model_at_budget(dbrx, n_nodes=1)
    assert not one["fits"]["none"] and one["level"] == "int8"
    assert pm.max_model_at_budget(dbrx, n_nodes=2)["level"] == "none"


WEIGHT_CASES = [(a, q) for a in ARCHS + DENSE_ARCHS for q in LEVELS]


@pytest.mark.parametrize("arch,level", WEIGHT_CASES,
                         ids=[f"{a}-{q}" for a, q in WEIGHT_CASES])
def test_weight_bytes_match_engine_memory_stats(arch, level):
    """``model_weight_bytes`` equals the port engine's reported weight
    bytes (layernorm's two leaves, a tied head and router-dead experts
    included), and the KV pool its pages times ``kv_bytes_per_token``."""
    _, cfg = reduced_pair(arch, weight_quant=level,
                          kv_cache_dtype="int8" if level == "int8"
                          else "native")
    eng = ServingEngine(cfg, EngineConfig(max_batch=2, max_cache=32,
                                          page_size=4),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    ms = eng.memory_stats()
    assert ms["weight_bytes"] == pm.model_weight_bytes(cfg)
    assert ms["kv_pool_bytes"] == eng.num_pages * eng.page_size \
        * pm.kv_bytes_per_token(cfg, precision=4)


@pytest.fixture(scope="module", params=ARCHS)
def bf16_init(request):
    """One arch's reduced bf16 parameters, drawn by the JAX package."""
    jcfg, _ = reduced_pair(request.param, dtype="bfloat16",
                           param_dtype="bfloat16")
    return request.param, jax_build_model(jcfg).init(jax.random.PRNGKey(3))


@pytest.mark.parametrize("level", LEVELS)
def test_standby_matches_reference(bf16_init, level):
    """The keep-warm touch sums the same expert leaves as the reference's
    (an int8 or packed-int4 payload and its fp32 scales), bf16 weights."""
    arch, raw = bf16_init
    jcfg, cfg = reduced_pair(arch, dtype="bfloat16", param_dtype="bfloat16",
                             weight_quant=level)
    jparams = jq.quantize_params(raw, jcfg)
    want = JaxServingEngine.standby(
        types.SimpleNamespace(cfg=jcfg, params=jparams))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    eng = ServingEngine(cfg, EngineConfig(max_batch=1, max_cache=16),
                        params=params, device="cpu")
    got = eng.standby()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
