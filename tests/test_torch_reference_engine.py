"""Port vs JAX: greedy token streams through the serving engine's three
layouts for the dense family and the MoE flagship, on the same (bridged)
weights: the two-program reference engine (``unified_step=False``,
``paged=False``; padded prefill, batched or one request at a time, then
one-token decode), the unified step over the contiguous cache
(``paged=False``) and over the paged pool.

The JAX engine runs ``use_kernel=True`` (its grouped-FFN Pallas kernel in
interpret mode) and, on the paged pool, ``paged_kernel=True``; the port
takes its kernels' plain versions on the CPU.  ``capacity_factor=8.0``
keeps MoE capacity non-binding.  Streams, the engine's counters and the
expert tracker must be identical, in fp32 and with int8 weights and an
int8 KV cache.  The traffic reuses slots (more requests than
``max_batch``), so the reference engine prefills while rows decode, and
holds prompts shorter than ``prefill_len`` (the reference pads them and
decodes from ``prefill_len``, attending the padding, which the port
copies)."""
import jax
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine
from torch_archs import ARCHS, DENSE_ARCHS, reduced_pair

ENGINE = dict(max_batch=2, prefill_len=8, max_cache=24, chunk_len=3,
              page_size=5)
# mode -> engine knobs of both sides (the port adds its own async_steps)
MODES = {
    "ref_batched": dict(unified_step=False, paged=False),
    "ref_sequential": dict(unified_step=False, paged=False,
                           batched_prefill=False),
    "contiguous": dict(paged=False),
    "paged": dict(paged=True),
}
QUANT = {"fp32": {}, "int8": {"weight_quant": "int8",
                              "kv_cache_dtype": "int8"}}
ARCHES = (ARCHS[0],) + DENSE_ARCHS
# (arch, mode, quant, port async_steps): every mode and both quant levels
# on each arch; the reference's batched prefill runs async, its one-by-one
# prefill and the unified steps sync, and the fp32 contiguous case also
# async
SERVED = [(a, m, q, m == "ref_batched" or (m == "contiguous" and q == "fp32"))
          for a in ARCHES for m in MODES for q in QUANT]


def _traffic(prompt_len=None):
    """Five requests over two slots; prompt lengths at and below
    ``prefill_len`` unless ``prompt_len`` fixes them."""
    rng = np.random.default_rng(3)
    lens = [8, 5, 8, 3, 7] if prompt_len is None else [prompt_len] * 5
    return [(rng.integers(0, 100, n), m)
            for n, m in zip(lens, (5, 4, 6, 3, 5))]


def _serve(eng, traffic):
    uids = [eng.submit(p, max_new_tokens=n) for p, n in traffic]
    eng.run_until_done()
    return [list(eng._all[u].generated) for u in uids]


def _engines(arch, mode, quant, async_steps, raw=None):
    jcfg, cfg = reduced_pair(arch, {"use_kernel": True}, capacity_factor=8.0,
                             **QUANT[quant])
    raw = raw if raw is not None else jax_build_model(jcfg).init(
        jax.random.PRNGKey(0))
    knobs = MODES[mode]
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(
        async_steps=False, paged_kernel=knobs.get("paged", False),
        **knobs, **ENGINE), params=raw)
    params = from_jax_params(jax.tree.map(np.asarray, raw), cfg, "cpu")
    peng = ServingEngine(cfg, EngineConfig(async_steps=async_steps, **knobs,
                                           **ENGINE),
                         params=params, device="cpu")
    return jeng, peng


@pytest.fixture(scope="module", params=SERVED,
                ids=[f"{a}-{m}-{q}-{'async' if s else 'sync'}"
                     for a, m, q, s in SERVED])
def served(request):
    arch, mode, quant, async_steps = request.param
    jeng, peng = _engines(arch, mode, quant, async_steps)
    traffic = _traffic()
    ops.reset_launch_counts()
    port = _serve(peng, traffic)
    return {"arch": arch, "mode": mode, "traffic": traffic,
            "jax": (jeng, _serve(jeng, traffic)), "port": (peng, port),
            "launches": ops.launch_counts()}


def test_greedy_streams_token_identical(served):
    _, want = served["jax"]
    peng, got = served["port"]
    assert got == want
    assert all(r.done and r.status == "done" for r in peng._all.values())


COUNTERS = ("prefill_tokens", "prefill_pad_tokens", "decode_steps",
            "decode_tokens", "mixed_prefill_tokens", "mixed_decode_tokens")


def test_engine_counters_match(served):
    jeng, _ = served["jax"]
    peng, _ = served["port"]
    for key in COUNTERS:
        assert peng.stats[key] == jeng.stats[key], key
    assert peng.memory_stats() == jeng.memory_stats()
    assert peng.paged_stats()["paged"] == jeng.paged_stats()["paged"]
    if served["mode"].startswith("ref"):
        assert peng.stats["prefill_pad_tokens"] > 0
        assert peng.throughput()["prefill_padding_overhead"] > 0
    else:
        assert peng.stats["prefill_pad_tokens"] == 0


def test_expert_tracker_matches(served):
    jeng, _ = served["jax"]
    peng, _ = served["port"]
    if jeng.tracker is None:
        assert peng.tracker is None and served["arch"] in DENSE_ARCHS
        return
    np.testing.assert_array_equal(peng.tracker.exec_counts,
                                  jeng.tracker.exec_counts)


def test_cpu_runs_no_kernel(served):
    """On CPU tensors every kernel wrapper takes its plain version."""
    assert not any(served["launches"].values())


@pytest.mark.parametrize("arch", ARCHES)
def test_reference_agrees_with_unified_at_prefill_len(arch):
    """On prompts of exactly ``prefill_len`` (no padding to attend) the
    reference engine, both prefills, and the unified step over both
    layouts give the same greedy streams."""
    traffic = _traffic(prompt_len=ENGINE["prefill_len"])
    _, cfg = reduced_pair(arch, capacity_factor=8.0)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    streams = {}
    for mode, knobs in MODES.items():
        eng = ServingEngine(cfg, EngineConfig(**knobs, **ENGINE),
                            params=params, device="cpu")
        streams[mode] = _serve(eng, traffic)
    assert all(s == streams["ref_batched"] for s in streams.values()), \
        streams


@pytest.mark.parametrize("knobs,match", [
    (dict(unified_step=False), "paged KV cache requires the unified"),
    (dict(paged=False, overcommit=True), "overcommit requires the paged"),
    (dict(unified_step=False, paged=False), "fault injection requires"),
])
def test_reference_config_errors(knobs, match):
    """The reference's three configuration errors, with its messages; the
    port's default ``paged=True`` makes ``unified_step=False`` alone the
    paged one."""
    from repro_torch.serving.faults import FaultPlan
    cfg = get_config(ARCHS[0]).reduced()
    plan = FaultPlan([]) if "fault" in match else None
    with pytest.raises(ValueError, match=match):
        ServingEngine(cfg, EngineConfig(**knobs), device="cpu",
                      fault_plan=plan)
    jcfg, _ = reduced_pair(ARCHS[0])
    jknobs = {"paged": True, **knobs}
    with pytest.raises(ValueError, match=match):
        JaxServingEngine(jcfg, JaxEngineConfig(**jknobs), fault_plan=plan)


def test_reference_refuses_prompts_past_prefill_len():
    cfg = get_config(ARCHS[0]).reduced()
    eng = ServingEngine(cfg, EngineConfig(unified_step=False, paged=False,
                                          **ENGINE), device="cpu",
                        generator=None)
    with pytest.raises(ValueError, match="reference engine's limit of 8"):
        eng.submit(np.arange(9), 2)
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit(np.arange(3), ENGINE["max_cache"])


@pytest.mark.parametrize("flags,mode", [
    ({}, "paged unified"), ({"paged": False}, "contiguous unified"),
    ({"unified": False}, "batched + async (reference)"),
    ({"legacy": True}, "legacy (sequential prefill, sync)")])
def test_launcher_modes(flags, mode, capsys):
    """``--contiguous``, ``--reference`` and ``--legacy`` reach their
    engines (the last two on the contiguous cache); a dense arch prints no
    expert lines."""
    from repro_torch.launch.serve import serve_demo
    cfg = get_config(DENSE_ARCHS[0]).reduced()
    eng, done = serve_demo(cfg, requests=3, new_tokens=3, prompt_len=6,
                           device="cpu", max_batch=2, **flags)
    out = capsys.readouterr().out
    assert f"completed 3 requests [{mode}, cpu]" in out
    assert "E[#exec experts" not in out and "memory fit" in out
    assert ("page pool" in out) == (mode == "paged unified")
    assert all(r.status == "done" for r in done)
    assert eng.unified == ("unified" in mode)
