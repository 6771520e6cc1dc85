"""Port vs JAX: greedy token streams through the whole serving engine.

The JAX reference is ``ServingEngine(paged=True, paged_kernel=True)`` with
``use_kernel=True`` (its Pallas kernels in interpret mode on the CPU); the
port runs the same weights (bridged) on the CPU, where its kernels take
their plain versions.  ``capacity_factor=8.0`` keeps MoE capacity
non-binding.  One traffic mix covers slot reuse (more requests than
``max_batch``), prompts longer than ``chunk_len``, and a shared system
prompt whose resubmission hits a partial tail page (copy-on-write).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.serving.engine import EngineConfig, ServingEngine

ARCH = "qwen3_moe_30b_a3b"
ENGINE = dict(max_batch=2, max_cache=32, chunk_len=3, page_size=5)


def _traffic():
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, 100, 7)              # one full page + 2 tokens
    prompts = [np.concatenate([sysp, rng.integers(0, 100, n)])
               for n in (5, 2, 4)]
    prompts += [rng.integers(0, 100, 11), rng.integers(0, 100, 4)]
    prompts.append(prompts[0].copy())          # resubmission: tail CoW
    new_tokens = [5, 4, 6, 3, 5, 4]
    return list(zip(prompts, new_tokens))


def _serve(eng, traffic):
    uids = [eng.submit(p, max_new_tokens=n) for p, n in traffic]
    eng.run_until_done()
    return [list(eng._all[u].generated) for u in uids]


# the port runs asynchronously by default; the second case syncs every
# step and caps prefill tokens per iteration (the stall-free scheduler's
# budget), so decode rows and partial chunks share iterations differently
@pytest.fixture(scope="module", params=[{}, {"token_budget": 2,
                                             "async_steps": False}],
                ids=["async", "budget"])
def served(request):
    traffic = _traffic()
    jcfg = jax_get_config(ARCH).reduced().replace(capacity_factor=8.0,
                                                  use_kernel=True)
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(
        async_steps=False, paged=True, paged_kernel=True,
        token_budget=request.param.get("token_budget", 0), **ENGINE),
        rng=jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced().replace(capacity_factor=8.0)
    params = from_jax_params(jax.tree.map(np.asarray, jeng.params), cfg,
                             "cpu")
    peng = ServingEngine(cfg, EngineConfig(**ENGINE, **request.param),
                         params=params, device="cpu")
    return {"traffic": traffic, "jax": (jeng, _serve(jeng, traffic)),
            "port": (peng, _serve(peng, traffic))}


def test_greedy_streams_token_identical(served):
    _, want = served["jax"]
    peng, got = served["port"]
    assert got == want
    assert [len(g) for g in got] == [n for _, n in served["traffic"]]
    assert all(r.done and r.status == "done" for r in peng._all.values())


def test_prefix_cache_stats_match(served):
    jeng, _ = served["jax"]
    peng, _ = served["port"]
    js, ps = jeng.paged_stats(), peng.paged_stats()
    for key in ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
                "cow_copies", "pages_hwm", "prefix_cached_pages"):
        assert ps[key] == js[key], key
    assert ps["prefix_hits"] > 0 and ps["cow_copies"] > 0


def test_scenario_shape(served):
    """The traffic really reuses slots and streams long prompts in chunks."""
    peng, _ = served["port"]
    assert len(served["traffic"]) > ENGINE["max_batch"]
    assert max(len(p) for p, _ in served["traffic"]) > ENGINE["chunk_len"]
    assert peng.stats["mixed_s"] > 0 and peng.stats["decode_steps"] > 0
    assert peng.allocator.pages_in_use == peng.prefix.cached_pages


def test_expert_tracker_matches(served):
    jeng, _ = served["jax"]
    peng, _ = served["port"]
    np.testing.assert_array_equal(peng.tracker.exec_counts,
                                  jeng.tracker.exec_counts)
    assert peng.expected_experts_per_node(2) == \
        jeng.expected_experts_per_node(2)


def test_paging_copy_matches_reference():
    """The port's numpy copy of PageAllocator / PrefixCache makes the same
    decisions as the reference on a random admit / insert / release /
    evict sequence."""
    from repro.serving import paging as jax_paging
    from repro_torch.serving import paging
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 4, int(rng.integers(3, 14)))
               for _ in range(40)]
    sides = []
    for mod in (jax_paging, paging):
        alloc = mod.PageAllocator(24)
        cache = mod.PrefixCache(4, alloc)
        held, log = [], []
        for p in prompts:
            hit = cache.lookup(p)
            need = -(-len(p) // 4) - len(hit.pages)
            if alloc.free_pages < need:
                cache.evict(need)
            pages = alloc.alloc(need)
            log.append((hit.pages, hit.tokens, hit.tail_page, hit.tail_len,
                        pages, alloc.free_pages, cache.cached_pages))
            if pages is None:
                alloc.free(hit.pages)
                if hit.tail_page >= 0:
                    alloc.free([hit.tail_page])
                continue
            if hit.tail_page >= 0:
                alloc.free([hit.tail_page])
            own = list(hit.pages) + pages
            k = len(p) // 4
            cache.insert(p, own[:k], own[k] if len(p) % 4 else -1, len(p) % 4)
            held.append(own)
            if len(held) > 3:
                alloc.free(held.pop(0))
        sides.append((log, cache.evictions, alloc.free_pages))
    assert sides[0] == sides[1]
    assert sides[1][1] > 0


@pytest.mark.parametrize("kw,match", [
    (dict(paged=False), "contiguous KV cache"),
    (dict(unified_step=False), "reference engine"),
    (dict(overcommit=True), "overcommit"),
])
def test_out_of_slice_options_raise(kw, match):
    cfg = get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError, match=match):
        ServingEngine(cfg, EngineConfig(**kw), device="cpu")


def test_out_of_slice_requests_raise():
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, EngineConfig(max_batch=1, max_cache=16),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.submit(np.arange(4), 2, temperature=0.7)
    with pytest.raises(NotImplementedError, match="deadlines"):
        eng.submit(np.arange(4), 2, deadline_ms=10.0)
    with pytest.raises(NotImplementedError, match="int8 KV cache"):
        ServingEngine(cfg.replace(kv_cache_dtype="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="quantized weight"):
        ServingEngine(cfg.replace(weight_quant="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="fault injection"):
        ServingEngine(cfg, device="cpu", fault_plan=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(cfg, device="cpu", mesh=object())
