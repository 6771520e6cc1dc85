"""Port vs JAX: the resilient serving path (overcommit with preemption and
prefix-cache restore, cancel, deadlines, fault injection with NaN
quarantine, the chaos matrix).

The JAX reference is its paged engine on the gather path
(``EngineConfig(paged=True, unified_step=True, async_steps=False)``), as
``tests/test_resilience.py`` runs it; its chaos matrix holds that path
token-identical to its Pallas kernel's.  The port runs the same weights
(bridged) on the CPU, where its kernels take their plain versions.
``capacity_factor=8.0`` keeps MoE capacity non-binding, so schedules that
differ (preemption, retries) cannot change the greedy tokens.  The host-side
policy (scheduler, page allocator, fault plans) is the port's own copy and
is held to the reference's decisions on the same inputs.
"""
import functools
import importlib.util
import pathlib
import types

import jax
import numpy as np
import pytest
import torch
try:  # requirements-dev.txt; degrade to fixed samples when absent
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, strategies as st

from repro.models.model import build_model as jax_build_model
from repro.serving import faults as jax_faults
from repro.serving import paging as jax_paging
from repro.serving import scheduler as jax_sched
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import from_jax_params
from repro_torch.models.model import Model
from repro_torch.serving import chaos, faults, paging
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import scheduler as sched
from repro_torch.serving.engine import (TERMINAL_STATES, EngineConfig,
                                        ServingEngine)
from repro_torch.serving.faults import Fault, FaultPlan, InjectedFault
from torch_archs import reduced_pair

ARCH = "qwen3_moe_30b_a3b"
ENGINE = dict(max_batch=2, max_cache=32, async_steps=False, chunk_len=3,
              page_size=4)


@functools.lru_cache(maxsize=1)
def _model():
    """(JAX config, port config, JAX params, bridged port params)."""
    jcfg, cfg = reduced_pair(ARCH, capacity_factor=8.0)
    raw = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, raw), cfg, "cpu")
    return jcfg, cfg, raw, params


@pytest.fixture(scope="module")
def model():
    return _model()


def _engines(model, *, plan=None, jax_plan=None, **kw):
    """(JAX engine, port engine) on the same weights and knobs."""
    jcfg, cfg, raw, params = model
    jeng = JaxServingEngine(jcfg, JaxEngineConfig(
        prefill_len=8, unified_step=True, paged=True, **ENGINE, **kw),
        params=raw, fault_plan=jax_plan)
    peng = _port(model, plan=plan, **kw)
    return jeng, peng


def _port(model, *, plan=None, **kw):
    _, cfg, _, params = model
    return ServingEngine(cfg, EngineConfig(**{**ENGINE, **kw}),
                         params=params, device="cpu", fault_plan=plan)


def _prompts(seed=0, lens=(7, 5)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50, n) for n in lens]


def _drain_clean(eng):
    """Post-drain hygiene: clear the prefix tree, then the pool must be
    fully free with consistent refcounts."""
    eng.prefixes[0].clear()
    assert eng.allocators[0].fully_free, \
        f"{eng.allocators[0].pages_in_use} pages leaked"
    eng.allocators[0].check_consistent()


def _step_until_decoding(eng, req, max_steps=64):
    """Step until ``req`` occupies a slot with its prefill complete."""
    for _ in range(max_steps):
        eng.step()
        slot = next((i for i, r in enumerate(eng.slots) if r is req), None)
        if (slot is not None
                and eng.prefill_pos[slot] >= len(eng.slot_ctx[slot])):
            return slot
    raise AssertionError("request never reached decode")


def _outcome(eng, uids):
    return ([list(eng._all[u].generated) for u in uids],
            [eng._all[u].status for u in uids], eng.resilience_stats())


# ---------------------------------------------------------------------------
# host side: fault plans, the scheduler and the page allocator, each held to
# the reference's decisions on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    ((1, "bogus-site"), {}), ((0, "nan"), {}),
    ((1, "nan"), {"kind": "minus-zero"})])
def test_fault_validation_matches_reference(args, kw):
    for mod in (jax_faults, faults):
        with pytest.raises(ValueError):
            mod.Fault(*args, **kw)
    with pytest.raises(ValueError):              # one fault per (step, site)
        FaultPlan([Fault(3, "nan"), Fault(3, "nan", rows=(1,))])
    assert faults.SITES == jax_faults.SITES
    assert np.isnan(Fault(1, "nan").value)
    assert np.isinf(Fault(1, "nan", kind="inf").value)


def test_fault_plan_poll_matches_reference():
    log = []
    for mod in (jax_faults, faults):
        plan = mod.FaultPlan([mod.Fault(2, "alloc"),
                              mod.Fault(4, "nan", rows=(0,))])
        seq = [plan.poll(1, "alloc"), plan.poll(2, "alloc"),
               plan.poll(2, "alloc"), plan.all_fired(),
               [f.step for f in plan.unfired()]]
        with pytest.raises(mod.InjectedFault):
            plan.maybe_raise(4, "nan")
        seq.append(plan.all_fired())
        log.append([(f.step, f.site) if isinstance(f, mod.Fault) else f
                    for f in seq])
    assert log[0] == log[1]
    assert log[1][:3] == [None, (2, "alloc"), None]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fault_plan_random_matches_reference(seed):
    kw = dict(n_faults=5, max_step=20, max_batch=4)
    a = FaultPlan.random(seed, **kw)
    b = jax_faults.FaultPlan.random(seed, **kw)
    key = lambda p: [(f.step, f.site, f.rows, f.kind) for f in p]
    assert key(a) == key(b) == key(FaultPlan.random(seed, **kw))
    assert len({(f.step, f.site) for f in a}) == len(a) == 5


@pytest.mark.parametrize("tokens,ps,new", [(0, 4, 0), (1, 4, 1), (8, 4, 8),
                                           (9, 4, 8), (7, 4, 0), (31, 16, 5)])
def test_pages_arithmetic_matches_reference(tokens, ps, new):
    assert sched.pages_for(tokens, ps) == jax_sched.pages_for(tokens, ps)
    assert (sched.lifetime_pages(tokens, new, ps)
            == jax_sched.lifetime_pages(tokens, new, ps))


@pytest.mark.parametrize("seed", range(4))
def test_select_victim_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(0, 6))
        rows = [(int(s), int(rng.integers(0, 3)), int(rng.integers(0, 4)),
                 int(rng.integers(0, 50))) for s in rng.permutation(8)[:n]]
        below = (None, 0, 1, 2)[int(rng.integers(0, 4))]
        exclude = tuple(int(s) for s in rng.permutation(8)[:2])
        got = sched.select_victim([sched.RunningRow(*r) for r in rows],
                                  below=below, exclude=exclude)
        want = jax_sched.select_victim(
            [jax_sched.RunningRow(*r) for r in rows], below=below,
            exclude=exclude)
        assert got == want, (rows, below, exclude)


@pytest.mark.parametrize("seed", range(3))
def test_admission_queue_matches_reference(seed):
    rng = np.random.default_rng(seed)
    mk = lambda uid, pr, seq: types.SimpleNamespace(uid=uid, priority=pr,
                                                    seq=seq)
    queues = (sched.AdmissionQueue(), jax_sched.AdmissionQueue())
    for uid in range(30):
        op, pr, seq = rng.random(), int(rng.integers(0, 3)), int(
            rng.integers(0, 30))
        gone = int(rng.integers(0, uid + 1))
        for q in queues:
            if op < 0.6:
                q.append(mk(uid, pr, seq))
            elif op < 0.8 and q:
                q.popleft()
            else:
                q.remove(gone)
        assert [r.uid for r in queues[0]] == [r.uid for r in queues[1]]
    for q in queues:
        q.clear()
        assert not q and len(q) == 0


def test_admission_queue_orders_priority_then_seq():
    q = sched.AdmissionQueue()
    mk = lambda uid, pr, seq: types.SimpleNamespace(uid=uid, priority=pr,
                                                    seq=seq)
    for args in ((1, 0, 1), (2, 5, 2), (3, 0, 3), (4, 5, 4)):
        q.append(mk(*args))
    assert [r.uid for r in q] == [2, 4, 1, 3]
    q.append(mk(9, 0, 2))           # a preempted request keeps its seq
    assert [r.uid for r in q] == [2, 4, 1, 9, 3]
    assert q.remove(4).uid == 4 and q.remove(4) is None
    assert q.popleft().uid == 2 and len(q) == 3


def test_allocator_checks_match_reference():
    """fully_free, check_consistent, writable (copy-on-write) and
    PrefixCache.clear decide as the reference's on one sequence."""
    log = []
    for mod in (jax_paging, paging):
        alloc = mod.PageAllocator(6)
        tree = mod.PrefixCache(4, alloc)
        pages = alloc.alloc(3)
        alloc.fork(pages[:1])
        copy = alloc.writable(pages[0])      # shared: re-homed
        steps = [alloc.fully_free, copy, alloc.writable(pages[1]),
                 alloc.free_pages]
        tree.insert(np.arange(9), pages[:2], pages[2], 1)
        alloc.free(pages)
        alloc.free([copy[0]])
        steps += [tree.cached_pages, tree.clear(), tree.evictions,
                  alloc.fully_free]
        alloc.check_consistent()
        alloc._free.append(alloc._free[0])      # a page freed twice
        with pytest.raises(AssertionError):
            alloc.check_consistent()
        log.append(steps)
    assert log[0] == log[1]


# ---------------------------------------------------------------------------
# engine: preempt/restore, overcommit, cancel, deadlines — the port's greedy
# streams, statuses and counters equal the reference engine's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uncontended(model):
    """Each prompt served alone by the reference engine (6 and 8 tokens)."""
    out = {}
    for n in (6, 8):
        jeng, _ = _engines(model)
        uids = [jeng.submit(p, max_new_tokens=n) for p in _prompts()]
        jeng.run_until_done()
        out[n] = [list(jeng._all[u].generated) for u in uids]
    return out


@pytest.mark.parametrize("async_steps", [False, True])
def test_preempt_restore_matches_reference(model, uncontended, async_steps):
    """Preempt a decoding request and restore it through the prefix cache:
    the port's stream equals the reference engine's (and the uncontended
    run's), and both restores reused cached pages."""
    p = _prompts()[0]
    jeng, _ = _engines(model)
    peng = _port(model, async_steps=async_steps)
    outs = []
    for eng in (jeng, peng):
        uid = eng.submit(p, max_new_tokens=6)
        req = eng._all[uid]
        _step_until_decoding(eng, req)
        assert eng.preempt(uid)
        assert req.status == "preempted" and req.preemptions == 1
        assert req.resume_tokens is not None
        eng.run_until_done()
        outs.append(_outcome(eng, [uid]))
    assert outs[1] == outs[0]
    assert outs[1][0] == [uncontended[6][0]]
    st = outs[1][2]
    assert st["preemptions"] == 1 and st["restores"] == 1
    assert st["restore_hit_tokens"] > 0
    assert not peng.preempt(10_000)
    _drain_clean(peng)


def test_overcommit_pressure_matches_reference(model, uncontended):
    """A pool too small for both lifetimes forces growth preemption; both
    requests complete with the reference's (and the uncontended) tokens."""
    jeng, peng = _engines(model, num_pages=4, overcommit=True)
    outs = []
    for eng in (jeng, peng):
        uids = [eng.submit(p, max_new_tokens=8) for p in _prompts()]
        eng.run_until_done()
        outs.append(_outcome(eng, uids))
        outs[-1] += (eng.preempt_log,)
    assert outs[1] == outs[0]
    assert outs[1][0] == uncontended[8]
    assert outs[1][1] == ["done", "done"]
    assert outs[1][2]["preemptions"] >= 1
    _drain_clean(peng)


def test_overcommit_admits_beyond_conservative_capacity(model):
    """Equal pool bytes, equal workload: overcommit runs more requests at
    once than whole-lifetime admission."""
    hwm = {}
    for overcommit in (False, True):
        eng = _port(model, num_pages=4, overcommit=overcommit)
        for p in _prompts():
            eng.submit(p, max_new_tokens=8)
        eng.run_until_done()
        hwm[overcommit] = eng.resilience_stats()["active_hwm"]
    assert hwm[True] > hwm[False]


def test_cancel_matches_reference(model):
    """Cancel a queued request and an in-flight one: the same statuses,
    tokens and counters as the reference; a second cancel is a no-op."""
    p1, p2 = _prompts()
    outs = []
    for eng in _engines(model):
        a = eng.submit(p1, max_new_tokens=6)
        b = eng.submit(p2, max_new_tokens=6)
        c = eng.submit(p1[:4], max_new_tokens=6)      # queued (max_batch=2)
        flags = [eng.cancel(c), eng.cancel(c)]
        eng.step()
        eng.step()
        flags += [eng.cancel(a), eng.cancel(a), eng.cancel(999_999)]
        eng.run_until_done()
        outs.append((flags,) + _outcome(eng, [a, b, c]))
    assert outs[1] == outs[0]
    assert outs[1][0] == [True, False, True, False, False]
    assert outs[1][2] == ["cancelled", "done", "cancelled"]
    assert outs[1][3]["cancelled"] == 2
    _drain_clean(eng)


def test_cancel_keeps_prefix_tree_pages_alive(model):
    """Cancelling an in-flight request must not rip shared pages out of
    the prefix tree: a follower over the same prompt still hits."""
    p = _prompts()[0]
    eng = _port(model)
    uid = eng.submit(p, max_new_tokens=6)
    eng.run_until_done()                            # seeds the prefix tree
    want = list(eng._all[uid].generated)
    hits0 = eng.stats["prefix_hit_tokens"]
    mid = eng.submit(p, max_new_tokens=6)           # prefix hit on admit
    _step_until_decoding(eng, eng._all[mid])
    assert eng.cancel(mid)
    assert eng.stats["prefix_hit_tokens"] > hits0
    again = eng.submit(p, max_new_tokens=6)
    eng.run_until_done()
    assert list(eng._all[again].generated) == want
    _drain_clean(eng)


def test_deadlines_match_reference(model):
    """An elapsed deadline expires a queued request on the first sweep; a
    patched clock expires an in-flight one; the rest is served as the
    reference serves it."""
    p1, p2 = _prompts()
    outs = []
    for eng in _engines(model):
        dead = eng.submit(p1, max_new_tokens=6, deadline_ms=0.0)
        live = eng.submit(p2, max_new_tokens=6)
        eng.step()
        assert eng._all[dead].status == "expired"
        assert eng._all[dead].first_token_s is None
        slow = eng.submit(p1, max_new_tokens=20, deadline_ms=60_000.0)
        req = eng._all[slow]
        _step_until_decoding(eng, req)
        eng._now = lambda: req.deadline_s + 1.0
        eng.step()
        assert req.status == "expired"
        eng.run_until_done()
        outs.append(_outcome(eng, [dead, live, slow]))
    assert outs[1] == outs[0]
    assert outs[1][1] == ["expired", "done", "expired"]
    assert outs[1][2]["expired"] == 2
    _drain_clean(eng)


# ---------------------------------------------------------------------------
# engine: fault guards
# ---------------------------------------------------------------------------

def _one_of_each():
    return [Fault(1, "alloc"), Fault(3, "dispatch"),
            Fault(5, "nan", rows=(0,))]


@pytest.mark.parametrize("async_steps", [False, True])
def test_fault_matrix_matches_reference(model, uncontended, async_steps):
    """One fault of each site in one run: the alloc stall delays
    admission, the failed dispatch re-runs the iteration, the poisoned row
    quarantines and retries — and the tokens and counters equal the
    reference's and the fault-free run's."""
    p = _prompts()[0]
    plan = FaultPlan(_one_of_each())
    jplan = jax_faults.FaultPlan([jax_faults.Fault(f.step, f.site,
                                                   rows=f.rows)
                                  for f in _one_of_each()])
    jeng, _ = _engines(model, jax_plan=jplan)
    peng = _port(model, plan=plan, async_steps=async_steps)
    outs = []
    for eng in (jeng, peng):
        uid = eng.submit(p, max_new_tokens=6)
        eng.run_until_done()
        outs.append(_outcome(eng, [uid]))
    assert outs[1] == outs[0]
    assert plan.all_fired() and jplan.all_fired()
    assert outs[1][0] == [uncontended[6][0]]
    st = outs[1][2]
    assert (st["alloc_stalls"], st["dispatch_failures"],
            st["nan_quarantines"]) == (1, 1, 1)
    _drain_clean(peng)


def test_nan_retry_limit_fails_request(model, monkeypatch):
    """Persistent poison exhausts the retry budget: the row is failed, its
    pages released, the engine drains clean."""
    monkeypatch.setattr(engine_mod, "NAN_RETRY_LIMIT", 2)
    plan = FaultPlan([Fault(s, "nan") for s in range(1, 12)])
    eng = _port(model, plan=plan)
    uid = eng.submit(_prompts()[0], max_new_tokens=4)
    eng.run_until_done()
    assert eng._all[uid].status == "failed"
    assert eng.resilience_stats()["failed"] == 1
    _drain_clean(eng)


def test_nan_retry_rewrites_the_pool_bit_identically(model):
    """A quarantined row re-dispatches the same block: the retry rewrites
    its own slot with the same bits (int8 payload and scale pools
    included) and leaves every other slot as it was, apart from the
    neighbour's next token."""
    _, cfg, _, params = model
    eng = ServingEngine(cfg.replace(kv_cache_dtype="int8"), EngineConfig(
        **ENGINE), params=params, device="cpu",
        fault_plan=FaultPlan([Fault(5, "nan", rows=(0,))]))
    for p in _prompts():
        eng.submit(p, max_new_tokens=6)
    for _ in range(4):
        eng.step()
    assert all(eng.prefill_pos[i] >= len(eng.slot_ctx[i]) for i in (0, 1))
    eng.step()                                       # row 0 poisoned
    assert eng.stats["nan_quarantines"] == 1
    before = {k: v.clone() for k, v in eng.cache.items()}
    pos1 = int(eng.lengths[1])
    page1 = int(eng.block_tables[1, pos1 // eng.page_size])
    eng.step()                                       # the retry
    for kk, pool in eng.cache.items():
        keep = torch.ones(pool.shape[1:3], dtype=torch.bool)
        keep[page1, pos1 % eng.page_size] = False    # the neighbour's write
        assert torch.equal(pool[:, keep], before[kk][:, keep]), kk
    eng.run_until_done()
    assert all(r.status == "done" for r in eng._all.values())


def test_only_injected_faults_are_caught(model, monkeypatch):
    """A real launch failure is not a fault to absorb: with a plan
    installed, an error of the forward propagates out of step()."""
    eng = _port(model, plan=FaultPlan([Fault(9, "dispatch")]))
    eng.submit(_prompts()[0], max_new_tokens=4)

    def boom(*args, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(Model, "forward_routed", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.step()
    assert eng.stats["dispatch_failures"] == 0
    with pytest.raises(InjectedFault):
        FaultPlan([Fault(1, "dispatch")]).maybe_raise(1, "dispatch")


def test_poison_reaches_the_device_as_fp32_bits(model):
    """The poison vector travels in the step's one int32 upload as fp32
    bits: NaN and inf arrive intact beside the int32 snapshots."""
    eng = _port(model)
    poison = np.array([np.nan, np.inf], np.float32)
    temps = np.array([0.0, 0.8], np.float32)
    ints = np.array([[3, -4], [5, 6]], np.int32)
    got_i, got_t, got_p, got_b = eng._upload(ints, temps, poison,
                                             np.array([True, False]))
    assert torch.equal(got_i, torch.as_tensor(ints))
    assert got_t.dtype == got_p.dtype == torch.float32
    assert torch.equal(got_t, torch.as_tensor(temps))
    assert torch.isnan(got_p[0]) and torch.isinf(got_p[1])
    assert got_b.tolist() == [1, 0]


def test_poison_is_uploaded_only_when_a_nan_fault_fires(model):
    """The fault-free steady state uploads and applies no poison: only the
    step a NaN fault fires in carries the vector (with NaN in its row)."""
    eng = _port(model, plan=FaultPlan([Fault(3, "nan", rows=(1,))]))
    seen = []
    upload = eng._upload

    def spy(*arrays):
        seen.append(arrays[8] if len(arrays) > 8 else None)
        return upload(*arrays)

    eng._upload = spy
    for p in _prompts():
        eng.submit(p, max_new_tokens=3)
    eng.run_until_done()
    fired = [(i, p) for i, p in enumerate(seen) if p is not None]
    assert len(fired) == 1 and len(seen) > 3
    assert np.isnan(fired[0][1][1]) and fired[0][1][0] == 0
    assert eng.resilience_stats()["nan_quarantines"] == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("corrupt", [False, True])
def test_forced_share_gate_catches_a_corrupt_restore(model, monkeypatch,
                                                     corrupt):
    """``chip_smoke.py`` phase 5c holds each greedy stream of its
    capacity-8 runs to the full-sequence forward of its own tokens.  On
    the CPU at reduced widths a correct overcommit serve (two preemptions
    and restores) sits at share 0; zeroing the last cached page a restore
    re-attends must push a preempted stream past the gate."""
    cs = _chip_smoke()
    _, cfg, _, params = model
    cfg = cfg.replace(capacity_factor=8.0)
    if corrupt:
        admit = ServingEngine._admit_paged

        def admit_and_zero(self, slot):
            restores = self.stats["restores"]
            ok = admit(self, slot)
            if ok and self.stats["restores"] > restores:
                page = self.slot_pages[slot][
                    int(self.prefill_pos[slot]) // self.page_size - 1]
                for pool in self.cache.values():
                    pool[:, page].zero_()
            return ok

        monkeypatch.setattr(ServingEngine, "_admit_paged", admit_and_zero)
    run = cs.resilience_serve(torch, cfg, params, device="cpu")
    assert run["eng"].resilience_stats()["restores"] >= 1
    shares = cs.forced_shares(torch, cfg, params, run["reqs"]["greedy"])
    preempted = [s for s, r in zip(shares, run["reqs"]["greedy"])
                 if r.preemptions]
    assert preempted
    if corrupt:
        assert max(preempted) >= cs.FORCED_SHARE_MAX, shares
    else:
        assert max(shares) < 1e-5, shares


def test_chaos_matrix_clean():
    """The port's chaos matrix on the CPU: every scenario absorbs its
    faults with token-identical recovery and a fully free pool."""
    record = {}
    assert chaos.run_matrix(ARCH, device="cpu", verbose=False,
                            record=record) == []
    st = record["paged/preempt"]["stats"]
    assert st["preemptions"] >= 1 and st["restore_hit_tokens"] > 0


def test_chaos_and_engine_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos.run_matrix(ARCH)


# ---------------------------------------------------------------------------
# properties (on the port; the reference's three)
# ---------------------------------------------------------------------------

@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_property_preemption_fairness(seed):
    """Property: the scheduler never preempts a request while a
    strictly-lower-priority peer keeps running, and never the same request
    twice in a row while any peer shares its class — audited from the
    engine's preempt log."""
    model = _model()
    rng = np.random.default_rng(seed)
    eng = _port(model, num_pages=5, overcommit=True)
    uids = [eng.submit(rng.integers(0, 50, int(rng.integers(4, 8))),
                       max_new_tokens=8, priority=int(rng.integers(0, 3)))
            for _ in range(4)]
    eng.run_until_done()
    assert all(eng._all[u].status == "done" for u in uids)
    prev_uid = None
    for _step, uid, peers in eng.preempt_log:
        vp = eng._all[uid].priority
        assert all(p >= vp for _u, p in peers), (uid, vp, peers)
        if uid == prev_uid:
            assert all(p > vp for _u, p in peers), (uid, peers)
        prev_uid = uid
    _drain_clean(eng)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_property_continuous_load_completes(seed):
    """Property: under continuous arrivals into an overcommitted pool,
    every admitted request eventually completes (no starvation, no
    preempt/restore livelock)."""
    model = _model()
    rng = np.random.default_rng(seed)
    eng = _port(model, num_pages=5, overcommit=True)
    pending = [(rng.integers(0, 50, int(rng.integers(3, 8))),
                int(rng.integers(0, 3))) for _ in range(6)]
    uids = []
    steps = 0
    while pending or eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        steps += 1
        if pending and steps % int(rng.integers(2, 5)) == 0:
            p, pr = pending.pop(0)
            uids.append(eng.submit(p, max_new_tokens=6, priority=pr))
        assert steps < 2_000, "livelock: load never drained"
    eng.flush()
    assert all(eng._all[u].status == "done" for u in uids)
    _drain_clean(eng)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_property_pool_free_after_chaos(seed):
    """Property: after any randomized schedule of preempts, cancels and
    injected faults, every page returns to the free list and refcounts
    stay consistent — no failure path leaks or double-frees."""
    model = _model()
    rng = np.random.default_rng(seed)
    plan = FaultPlan.random(seed, n_faults=4, max_step=24, max_batch=2)
    eng = _port(model, plan=plan, num_pages=6, overcommit=True)
    uids = [eng.submit(rng.integers(0, 50, int(rng.integers(3, 8))),
                       max_new_tokens=6, priority=int(rng.integers(0, 3)))
            for _ in range(4)]
    for _ in range(30):
        eng.step()
        op = rng.random()
        victim = int(rng.choice(uids))
        if op < 0.15:
            eng.cancel(victim)
        elif op < 0.3:
            eng.preempt(victim)
        eng.allocators[0].check_consistent()    # invariant holds mid-flight
    eng.run_until_done()
    assert all(eng._all[u].status in TERMINAL_STATES for u in uids)
    _drain_clean(eng)
