"""Port vs JAX: greedy token streams through the whole serving engine.

The JAX reference is ``ServingEngine(paged=True, paged_kernel=True)`` with
``use_kernel=True`` (its Pallas kernels in interpret mode on the CPU); the
port runs the same weights (bridged) on the CPU, where its kernels take
their plain versions.  ``capacity_factor=8.0`` keeps MoE capacity
non-binding.  One traffic mix covers slot reuse (more requests than
``max_batch``), prompts longer than ``chunk_len``, and a shared system
prompt whose resubmission hits a partial tail page (copy-on-write).  The
quantized cases run the same traffic over an int8 KV pool, int8 or int4
weights quantized on load from the same raw weights, or both; their decode
steps take ``gather_moe`` over quantized experts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.core import moe
from repro_torch.core.quant import QuantTensor
from repro_torch.serving.engine import EngineConfig, ServingEngine
from torch_archs import ARCHS, one_torch_thread, reduced_pair  # noqa: F401

ARCH = ARCHS[0]
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


# case -> (port engine knobs, config fields).  The port runs asynchronously
# by default; "budget" syncs every step and caps prefill tokens per
# iteration (the stall-free scheduler's budget), so decode rows and partial
# chunks share iterations differently.  The rest are the quantized path.
CASES = {
    "async": ({}, {}),
    "budget": ({"token_budget": 2, "async_steps": False}, {}),
    "kv_int8": ({}, {"kv_cache_dtype": "int8"}),
    "w_int8": ({}, {"weight_quant": "int8"}),
    "w_int4": ({}, {"weight_quant": "int4"}),
    "w_int8_kv_int8": ({}, {"weight_quant": "int8",
                            "kv_cache_dtype": "int8"}),
}


# (arch, case): every case on the first arch (ids unchanged), the fp and
# the int8-weights + int8-KV cases on the others, which have router-dead
# experts and padded vocab columns (``torch_archs``)
SERVED = [(ARCH, c) for c in CASES] + [
    (a, c) for a in ARCHS[1:] for c in ("async", "w_int8_kv_int8")]


@pytest.fixture(scope="module", params=SERVED, ids=[
    c if a == ARCH else f"{a}-{c}" for a, c in SERVED])
def served(request):
    arch, case = request.param
    engine_kw, quant_kw = CASES[case]
    traffic = _traffic()
    jcfg, cfg = reduced_pair(arch, {"use_kernel": True}, capacity_factor=8.0,
                             **quant_kw)
    # both engines quantize the same raw weights on load
    raw = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(
        async_steps=False, paged=True, paged_kernel=True,
        token_budget=engine_kw.get("token_budget", 0), **ENGINE),
        params=raw)
    params = from_jax_params(jax.tree.map(np.asarray, raw), cfg, "cpu")
    peng = ServingEngine(cfg, EngineConfig(**ENGINE, **engine_kw),
                         params=params, device="cpu")
    gathered = []                 # was each decode gather's w_gate quantized?
    orig = moe.gather_moe

    def spy(experts, *args):
        gathered.append(isinstance(experts["w_gate"], QuantTensor))
        return orig(experts, *args)

    moe.gather_moe = spy
    try:
        port_out = _serve(peng, traffic)
    finally:
        moe.gather_moe = orig
    return {"traffic": traffic, "jax": (jeng, _serve(jeng, traffic)),
            "port": (peng, port_out), "quant": quant_kw,
            "gathered": gathered}


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
    assert peng.allocators[0].pages_in_use == peng.prefixes[0].cached_pages


def test_expert_tracker_matches(served):
    jeng, _ = served["jax"]
    peng, _ = served["port"]
    np.testing.assert_array_equal(peng.tracker.exec_counts,
                                  jeng.tracker.exec_counts)
    assert peng.expected_experts_per_node(2) == \
        jeng.expected_experts_per_node(2)


def test_store_and_pool_match_reference(served):
    """Same weight and pool bytes as the reference (QuantTensor payload +
    scales, int8 pool + scale pools), and the decode gather read the
    quantized experts."""
    jeng, _ = served["jax"]
    peng, _ = served["port"]
    js, ps = jeng.memory_stats(), peng.memory_stats()
    assert ps == js
    assert sorted(peng.cache) == sorted(jeng.cache)
    for kk, pool in peng.cache.items():
        assert str(pool.dtype).split(".")[-1] == str(jeng.cache[kk].dtype)
        assert tuple(pool.shape) == jeng.cache[kk].shape
    quantized = served["quant"].get("weight_quant", "none") != "none"
    experts = peng.params["blocks"]["experts"]
    assert isinstance(experts["w_down"], QuantTensor) == quantized
    assert isinstance(peng.params["blocks"]["router"], torch.Tensor)
    assert served["gathered"]
    assert set(served["gathered"]) == {quantized}


def test_copy_pages_copies_scale_pools():
    """Copy-on-write duplicates a page in every pool leaf of an int8 cache
    (payload and scales, every layer) and touches no other page."""
    cfg = get_config(ARCH).reduced().replace(kv_cache_dtype="int8")
    eng = ServingEngine(cfg, EngineConfig(max_batch=1, max_cache=16,
                                          page_size=4),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert sorted(eng.cache) == ["k", "k_scale", "v", "v_scale"]
    gen = torch.Generator().manual_seed(1)
    for pool in eng.cache.values():
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     dtype=torch.int8))
        else:
            pool.copy_(torch.rand(pool.shape, generator=gen))
    before = {kk: v.clone() for kk, v in eng.cache.items()}
    eng._copy_pages([1], [3])
    for kk, pool in eng.cache.items():
        assert torch.equal(pool[:, 3], before[kk][:, 1]), kk
        keep = [p for p in range(pool.shape[1]) if p != 3]
        assert torch.equal(pool[:, keep], before[kk][:, keep]), kk


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


# the ids these cases had while both were refusals of a later slice
@pytest.mark.parametrize("case", ["audio", "sinusoidal"], ids=[
    "kw0-the 'audio' family .*other families",
    "kw1-positional 'sinusoidal' .*other families"])
def test_out_of_slice_options_raise(case):
    """What were a later slice's refusals.  The audio family: the JAX
    engine takes it (the two-program path) and fails at its first step on
    ``frame_embeds``, which its prefill never receives; the port's engine
    refuses it at construction with a ``ValueError`` naming that key.
    Sinusoidal positions on the reduced qwen3-moe: greedy streams equal
    to the JAX engine's (the table added at every step's positions)."""
    jcfg, cfg = reduced_pair(ARCH, {"use_kernel": True}, capacity_factor=8.0,
                             positional="sinusoidal")
    if case == "audio":
        kw = dict(family="audio", norm="layernorm", act="gelu",
                  use_rope=False, num_experts=0, num_experts_padded=0,
                  experts_per_token=0)
        jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
        raw = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
        jeng = JaxServingEngine(jcfg, JaxEngineConfig(
            max_batch=1, prefill_len=8, max_cache=16, async_steps=False),
            params=raw)
        jeng.submit(np.arange(8, dtype=np.int32), max_new_tokens=2)
        with pytest.raises(KeyError, match="frame_embeds"):
            jeng.run_until_done()
        with pytest.raises(ValueError, match="frame_embeds"):
            ServingEngine(cfg, EngineConfig(paged=False), device="cpu")
        return
    traffic = _traffic()
    raw = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(
        async_steps=False, paged=True, paged_kernel=True, **ENGINE),
        params=raw)
    peng = ServingEngine(cfg, EngineConfig(**ENGINE), params=from_jax_params(
        jax.tree.map(np.asarray, raw), cfg, "cpu"), device="cpu")
    assert _serve(peng, traffic) == _serve(jeng, traffic)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_130m"])
def test_stateful_families_lay_out_on_a_mesh(arch):
    """The stateful families take a mesh (a stand-in with one rank's
    coordinates; nothing here runs a collective): ``init_serving`` keeps
    the rank's serve blocks of the whole draw, ``init_training`` its train
    blocks, and the engine's cache holds the hybrid's RG-LRU channels of
    the rank and its attention ring's sequence block (context-parallel
    decode), the ssm states whole."""
    import types

    from repro_torch.ckpt import io as ckpt
    from repro_torch.launch import sharding
    from repro_torch.models.model import build_model
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2},
                                 coords={"data": 0, "model": 1})
    cfg = get_config(arch).reduced()
    model = build_model(cfg, "cpu")
    whole = model.init(torch.Generator().manual_seed(2))
    for mode, init in (("serve", model.init_serving),
                       ("train", model.init_training)):
        want = sharding.shard_tree(whole, sharding.mode_specs(cfg, mesh, mode),
                                   mesh)
        got = ckpt.flatten_tree(init(torch.Generator().manual_seed(2), mesh))
        want = ckpt.flatten_tree(want)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert torch.equal(got[k], w), (mode, k)
    cache = model.init_cache(2, 96, mesh, seq_sharded=True)
    if arch == "recurrentgemma_2b":
        assert cache["rec"]["h"].shape == (2, 2, cfg.lru_width // 2)
        assert cache["attn"]["k"].shape == (1, 2, cfg.sliding_window // 2,
                                            cfg.num_kv_heads, cfg.head_dim)
    else:
        assert cache["ssm"].shape[:2] == (cfg.num_layers, 2)


def test_expert_replication_matches_reference():
    """Overlapping expert placement on one device (``expert_replication``
    2): both sides store two copies of the expert stack and route over
    the first, so the bridged weights give the reference's forward (2e-4)
    and greedy engine streams, and the engine's weight bytes (both copies)
    equal the performance model's."""
    from repro_torch.core import perf_model
    from repro_torch.models.model import build_model
    jcfg, cfg = reduced_pair(ARCH, {"use_kernel": True},
                             capacity_factor=8.0, expert_replication=2)
    raw = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    e = cfg.num_experts_padded
    assert raw["blocks"]["experts"]["w_up"].shape[1] == 2 * e
    params = from_jax_params(jax.tree.map(np.asarray, raw), cfg, "cpu")
    port_init = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    w = port_init["blocks"]["experts"]["w_gate"]
    assert w.shape[1] == 2 * e and torch.equal(w[:, :e], w[:, e:])
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax_build_model(jcfg).forward(raw, {"tokens": tokens})
    with torch.no_grad():
        got, _ = build_model(cfg, "cpu").forward(
            params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    traffic = _traffic()
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(
        async_steps=False, paged=True, paged_kernel=True, **ENGINE),
        params=raw)
    peng = ServingEngine(cfg, EngineConfig(**ENGINE), params=params,
                         device="cpu")
    assert _serve(peng, traffic) == _serve(jeng, traffic)
    weight = peng.memory_stats()["weight_bytes"]
    assert weight == jeng.memory_stats()["weight_bytes"]
    assert weight == perf_model.model_weight_bytes(cfg)
    assert weight > perf_model.model_weight_bytes(
        cfg.replace(expert_replication=1))
