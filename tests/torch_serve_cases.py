"""The cases of ``tests/test_torch_serve_mesh.py``, shared by its JAX oracle
(``torch_serve_oracle.py``, a subprocess with four host devices) and its
port side (gloo rank processes spawned by the test).  numpy only at
import: rank processes import this module and must not load JAX.

The weights are seeded numpy parameters (``torch_ep_cases.model_params``)
that the test writes to an npz first; both sides read them."""
import itertools

import numpy as np

from torch_ep_cases import flatten, unflatten  # noqa: F401  (re-exported)

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}    # (n_data, n_model)
# name -> (arch, reduced-config fields): the reduced qwen3-moe and
# qwen3-0.6b, and two variants whose specs keep a weight whole on four
# ranks: six q heads with a QKV bias (wq and wo whole, the flat k/v split
# and its bias cut; on two ranks every bias cut by heads), and d_ff 12 in
# int4 (W_down's six packed rows whole: the MLP's columns are gathered;
# on two ranks its one row of scales re-blocked)
ARCHS = {"moe": ("qwen3_moe_30b_a3b", {}), "dense": ("qwen3_0_6b", {}),
         "moe_h6": ("qwen3_moe_30b_a3b", {"num_heads": 6,
                                          "qkv_bias": True}),
         "dense_f12": ("qwen3_0_6b", {"d_ff": 12})}
SCHEDULES = ("decentralized", "a2a_pipelined")
ALL_SCHEDULES = ("decentralized", "centralized", "a2a", "a2a_pipelined")
# capacity never binds; int8 weights at block 64
CFG = dict(capacity_factor=8.0, ep_microchunks=2)
QUANT = {"fp32": {}, "int8": dict(weight_quant="int8", weight_quant_block=64),
         "int4": dict(weight_quant="int4", weight_quant_block=64)}
ENGINE = dict(max_batch=2, prefill_len=8, max_cache=24, chunk_len=4,
              page_size=4, track_experts=False)
# engine layout -> knobs of both sides
MODES = {"paged": dict(paged=True), "contiguous": dict(paged=False),
         "reference": dict(paged=False, unified_step=False)}
# (arch, quant, mode): the JAX one-device engine's runs; the port's mesh
# runs are these under each schedule of ``engine_cases``
ORACLE_RUNS = [("moe", "fp32", m) for m in MODES] + [
    ("moe", "int8", "paged"), ("dense", "fp32", "paged"),
    ("dense", "fp32", "reference"), ("moe_h6", "fp32", "paged"),
    ("dense_f12", "int4", "paged")]
# the context-parallel decode cases: a layer of the reduced qwen3-0.6b,
# B=4, a 32-slot cache, five decode steps
CP_CACHE = {"fp32": "native", "int8": "int8"}
CP_B, CP_LEN, CP_STEPS = 4, 32, 5
# the unified step whose collective bytes are held to the prediction
BYTES_BLOCK = (2, 4)
# capacity that binds: the reduced qwen3-moe at the default capacity
# factor 1.25 with 32-token prefill chunks of two rows.  The reference's
# mesh engine on (2, 2) plans each data block (one row) apart, its
# one-device engine both rows at once, and on this traffic their greedy
# streams differ.  On (1, 4) the one data block is the whole batch, so the
# decentralized schedule plans as one device does (the a2a schedules plan
# per sequence block on any mesh, so (1, 4) has no JAX streams to match)
BINDING_ENGINE = dict(max_batch=2, max_cache=64, chunk_len=32, page_size=4,
                      track_experts=False)
BINDING_SCHEDULES = ("decentralized", "a2a_pipelined")
BINDING_CASES = {"2x2": BINDING_SCHEDULES, "1x4": ("decentralized",)}


# one overcommitted serve on each mesh: five requests over four slots,
# two a data block with a pool of 6 pages on (2, 2) (four slots over 12
# pages on (1, 4)), growing lazily and preempting under pool pressure
OVERCOMMIT_ENGINE = dict(ENGINE, max_batch=4, overcommit=True, num_pages=12)


def overcommit_traffic() -> list:
    """Five requests whose lifetimes overrun a data block's pool:
    (prompt, max_new_tokens, priority)."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 500, int(rng.integers(6, 12))), n, pr)
            for n, pr in ((12, 0), (10, 0), (12, 5), (8, 0), (10, 5))]


# the rows left whole on a mesh: three slots, which two data ranks do not
# divide, so every rank runs the whole batch (as the reference does), over
# the centralized schedule, whose one-token decode passes its result
# round the "model" ranks (``ppermute``, by global rank)
UNCUT_ENGINE = dict(ENGINE, max_batch=3)
UNCUT_MODES = ("reference", "paged")
# a pool that two data blocks do not divide: each block's is 13 // 2
ODD_POOL_ENGINE = dict(ENGINE, paged=True, num_pages=13)


def data_blocks(mesh, rows: int) -> int:
    """The data blocks ``mesh`` cuts ``rows`` rows into (the port's one
    rule, ``expert_parallel.batch_split``)."""
    from repro_torch.core.expert_parallel import batch_split
    from repro_torch.launch.mesh import axes_size
    return axes_size(mesh, batch_split(mesh, rows))


def engine_cases() -> dict:
    """name -> (arch, quant, mode, schedule) of the port's mesh serves."""
    out = {}
    for arch, quant, mode in ORACLE_RUNS:
        scheds = SCHEDULES if (arch, quant) == ("moe", "fp32") else (
            "decentralized",)
        for ep in scheds:
            out[f"{arch}/{quant}/{mode}/{ep}"] = (arch, quant, mode, ep)
    return out


def oracle_key(arch: str, quant: str, mode: str) -> str:
    return f"{arch}/{quant}/{mode}"


def traffic() -> list:
    """Three requests over two slots sharing a six-token prefix (the pool
    shares its first page and copies the partial second on write), the
    third a resubmission of the first: (prompt, max_new_tokens)."""
    rng = np.random.default_rng(11)
    sys_p = rng.integers(0, 500, 6)
    p1 = np.concatenate([sys_p, rng.integers(0, 500, 2)])
    p2 = np.concatenate([sys_p, rng.integers(0, 500, 1)])
    return [(p1, 4), (p2, 5), (p1, 3)]


def binding_traffic() -> list:
    """Three prompts of 20-39 tokens, four new tokens each."""
    rng = np.random.default_rng(1)
    return [(rng.integers(0, 500, int(rng.integers(20, 40))), 4)
            for _ in range(3)]


def binding_fields(ep: str) -> dict:
    """The binding case's config fields over the reduced qwen3-moe."""
    return dict(capacity_factor=1.25, ep_microchunks=2, expert_parallel=ep)


def cp_inputs(d: int, ring: bool = False) -> list:
    """The decode steps' inputs x (B, 1, D) and lengths (B,); with
    ``ring`` (a window as long as the cache) the rows' lengths run from
    below the cache length to past it, so their writes wrap."""
    rng = np.random.default_rng(22 if ring else 21)
    out = []
    for t in range(CP_STEPS):
        x = rng.standard_normal((CP_B, 1, d)).astype(np.float32)
        lengths = (CP_LEN - 3 + t + 7 * np.arange(CP_B) if ring
                   else t + 3 * np.arange(CP_B) % 7)
        out.append((x, np.asarray(lengths, np.int32)))
    return out


# the context-parallel decode cases: name -> window (the ring's window is
# the cache length)
CP_WINDOWS = {"cp": None, "cp_ring": CP_LEN}


def layer0(tree: dict) -> dict:
    """Layer 0 of a layer-stacked tree."""
    return {k: layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the port's side: one rank process of a mesh
# ---------------------------------------------------------------------------

def sum_input(rank: int) -> np.ndarray:
    """Rank ``rank``'s operand of the psum case: values over five decades,
    so that bfloat16 sums in different orders round differently."""
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal((16, 8))
            * 10.0 ** rng.integers(-2, 3, (16, 8))).astype(np.float32)


def port_config(arch: str, quant: str = "fp32", ep: str = "decentralized",
                **kw):
    from repro_torch.configs.base import get_config
    name, fields = ARCHS[arch]
    return get_config(name).reduced().replace(
        **fields, **CFG, **QUANT[quant], expert_parallel=ep, **kw)


def _serve(eng, requests=None) -> list:
    uids = [eng.submit(p, max_new_tokens=n)
            for p, n in (requests or traffic())]
    eng.run_until_done()
    return [[int(t) for t in eng._all[u].generated] for u in uids]


def rank_main(rank: int, world: int, store: str, shape: tuple,
              params_path: str, q) -> None:
    """Every port case of one mesh on this rank; puts (rank, results) or
    (rank, traceback text) on ``q``."""
    import traceback
    try:
        q.put((rank, _rank_cases(rank, world, store, shape, params_path)))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def _rank_cases(rank, world, store, shape, params_path) -> dict:
    import datetime

    import torch
    from repro_torch import bridge
    from repro_torch.core import collectives
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import attention, transformer
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    torch.set_num_threads(1)
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=90))
    mesh = mesh_lib.make_test_mesh(*shape)
    flat = np.load(params_path)
    trees = {a: unflatten({k[len(a) + 1:]: flat[k] for k in flat
                           if k.startswith(a + "/")}) for a in ARCHS}
    out = {"psum": collectives.psum(torch.from_numpy(sum_input(rank)).to(
        torch.bfloat16), mesh, "model").float().numpy()}
    for name, (arch, quant, mode, ep) in engine_cases().items():
        cfg = port_config(arch, quant, ep)
        params = bridge.from_jax_params(trees[arch], cfg, "cpu", mesh=mesh,
                                        mode="serve")
        eng = ServingEngine(cfg, EngineConfig(**ENGINE, **MODES[mode]),
                            params=params, device="cpu", mesh=mesh)
        out[f"serve/{name}"] = {"streams": _serve(eng),
                                "weight_bytes": eng.memory_stats()[
                                    "weight_bytes"],
                                "cache_shape": tuple(eng.cache["k"].shape)}
    for mode in UNCUT_MODES:
        cfg = port_config("moe", ep="centralized")
        params = bridge.from_jax_params(trees["moe"], cfg, "cpu", mesh=mesh,
                                        mode="serve")
        eng = ServingEngine(cfg, EngineConfig(**UNCUT_ENGINE, **MODES[mode]),
                            params=params, device="cpu", mesh=mesh)
        out[f"uncut/{mode}"] = {"streams": _serve(eng), "blocks": eng.blocks,
                                "cache_shape": tuple(eng.cache["k"].shape)}
    cfg = port_config("moe")
    params = bridge.from_jax_params(trees["moe"], cfg, "cpu", mesh=mesh,
                                    mode="serve")
    eng = ServingEngine(cfg, EngineConfig(**ODD_POOL_ENGINE),
                        params=params, device="cpu", mesh=mesh)
    out["odd_pool"] = {"streams": _serve(eng),
                       "pool_pages": eng.cache["k"].shape[1],
                       "block_pages": eng.block_pages}
    # capacity per data block: the binding traffic
    from repro_torch.configs.base import get_config
    for ep in BINDING_CASES[next(m for m, sh in MESHES.items()
                                 if sh == tuple(shape))]:
        cfg = get_config(ARCHS["moe"][0]).reduced().replace(
            **binding_fields(ep))
        params = bridge.from_jax_params(trees["moe"], cfg, "cpu", mesh=mesh,
                                        mode="serve")
        eng = ServingEngine(cfg, EngineConfig(**BINDING_ENGINE),
                            params=params, device="cpu", mesh=mesh)
        out[f"binding/{ep}"] = _serve(eng, binding_traffic())
    # one unified step's collective bytes, paged, both schedules; each
    # row's block table holds page ids of its data block's pool
    b, t = BYTES_BLOCK
    g = data_blocks(mesh, b)
    for ep in SCHEDULES:
        cfg = port_config("moe", ep=ep)
        params = bridge.from_jax_params(trees["moe"], cfg, "cpu", mesh=mesh,
                                        mode="serve")
        model = build_model(cfg, "cpu")
        cache = model.init_paged_cache(8 // g, 4, mesh)
        tok = torch.from_numpy(np.random.default_rng(5).integers(
            0, 500, (b, t)).astype(np.int32))
        batch = {"tokens": tok, "lengths": torch.tensor([0, 3],
                                                        dtype=torch.int32),
                 "seg_lens": torch.tensor([t, 2], dtype=torch.int32),
                 "block_tables": torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]],
                                              dtype=torch.int32) % (8 // g)}
        mesh.reset_counters()
        with torch.no_grad():
            logits, _ = model.forward_routed(params, batch, cache,
                                             context_len=16, mesh=mesh)
        out[f"bytes/{ep}"] = {"bytes": dict(mesh.bytes),
                              "logits": logits.numpy(),
                              "pool_pages": cache["k"].shape[1]}
    # every schedule's prefill block (T=4) and decode step (T=1: the
    # centralized decode fallback, a2a's decentralized one): the bytes
    # each step books, an aux mean's among them if a schedule took one
    for ep in ALL_SCHEDULES:
        cfg = port_config("moe", ep=ep)
        params = bridge.from_jax_params(trees["moe"], cfg, "cpu", mesh=mesh,
                                        mode="serve")
        model = build_model(cfg, "cpu")
        cache = model.init_paged_cache(8 // g, 4, mesh)
        steps = {}
        for tt, lengths, seg in ((t, [0, 3], [t, 2]), (1, [4, 5], [1, 1])):
            tok = torch.from_numpy(np.random.default_rng(6).integers(
                0, 500, (b, tt)).astype(np.int32))
            batch = {"tokens": tok,
                     "lengths": torch.tensor(lengths, dtype=torch.int32),
                     "seg_lens": torch.tensor(seg, dtype=torch.int32),
                     "block_tables": torch.tensor(
                         [[0, 1, 2, 3], [4, 5, 6, 7]],
                         dtype=torch.int32) % (8 // g)}
            mesh.reset_counters()
            with torch.no_grad():
                model.forward_routed(params, batch, cache, context_len=16,
                                     mesh=mesh)
            steps[tt] = dict(mesh.bytes)
        out[f"aux/{ep}"] = steps
    # context-parallel decode of one layer against the one-device step,
    # over a linear cache and over a ring, on this rank's rows
    from repro_torch.core.expert_parallel import batch_shard
    rows = batch_shard(mesh, CP_B)[1]
    for (name, window), (quant, kv) in itertools.product(
            CP_WINDOWS.items(), CP_CACHE.items()):
        cfg = port_config("dense", kv_cache_dtype=kv)
        params = bridge.from_jax_params(trees["dense"], cfg, "cpu",
                                        mesh=mesh, mode="serve")
        p = transformer._layer(params["blocks"], 0)["attn"]
        tp = transformer.serve_tp(cfg, mesh).attn
        cache = {kk: v[0] for kk, v in build_model(cfg, "cpu").init_cache(
            CP_B, CP_LEN, mesh, seq_sharded=True).items()}
        outs = []
        mesh.reset_counters()
        for x, lengths in cp_inputs(cfg.d_model, window is not None):
            with torch.no_grad():
                y = attention.attn_decode_step_cp(
                    p, cfg, cache, torch.from_numpy(x[rows]),
                    torch.from_numpy(lengths[rows]), window, tp)
            outs.append(y.numpy())
        out[f"{name}/{quant}"] = {"out": np.stack(outs),
                                  "rows": (rows.start, rows.stop),
                                  "cache": {k: v.numpy()
                                            for k, v in cache.items()},
                                  "bytes": dict(mesh.bytes)}
    # a deadline on rank 0's clock expires the same request on every rank
    cfg = port_config("moe")
    params = bridge.from_jax_params(trees["moe"], cfg, "cpu", mesh=mesh,
                                    mode="serve")
    eng = ServingEngine(cfg, EngineConfig(**ENGINE), params=params,
                        device="cpu", mesh=mesh)
    reads = []
    real = eng._clock

    def clock():
        reads.append(1)
        # rank 0's clock jumps past the deadline at its fourth read; the
        # other ranks' never do
        return real() + (1e6 if rank == 0 and len(reads) >= 4 else 0.0)
    eng._clock = clock
    uids = [eng.submit(p, max_new_tokens=n,
                       deadline_ms=1e5 if i == 1 else None)
            for i, (p, n) in enumerate(traffic())]
    eng.run_until_done()
    out["deadline"] = {"status": [eng._all[u].status for u in uids],
                       "streams": [[int(t) for t in eng._all[u].generated]
                                   for u in uids],
                       "broadcast_bytes": mesh.bytes.get("broadcast", 0)}
    out["overcommit"] = _overcommit(trees, mesh)
    out["analysis"] = _analysis(mesh)
    out["packed_mixed"] = _packed_mixed(rank, mesh)
    torch.distributed.destroy_process_group()
    return out


def _overcommit(trees, mesh) -> dict:
    """``overcommit_traffic`` served with lazy growth and preemption, and
    without overcommit (whole lifetimes reserved), on this rank: each
    request's status and how many times it ended, the streams, each data
    block's allocator check once drained, its high-water mark and the
    preemptions."""
    from repro_torch import bridge
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = port_config("moe")
    params = bridge.from_jax_params(trees["moe"], cfg, "cpu", mesh=mesh,
                                    mode="serve")
    out = {}
    for name, over in (("overcommit", True), ("reserved", False)):
        eng = ServingEngine(cfg, EngineConfig(**dict(OVERCOMMIT_ENGINE,
                                                     overcommit=over)),
                            params=params, device="cpu", mesh=mesh)
        ends = []
        term, fin = eng._terminate_req, eng._finish_slot

        def terminate(req, status, term=term):
            ends.append(req.uid)
            term(req, status)

        def finish(i, fin=fin):
            ends.append(eng.slots[i].uid)
            fin(i)
        eng._terminate_req, eng._finish_slot = terminate, finish
        uids = [eng.submit(p, max_new_tokens=n, priority=pr)
                for p, n, pr in overcommit_traffic()]
        hwm = [0] * eng.blocks
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            hwm = [max(h, a.pages_in_use)
                   for h, a in zip(hwm, eng.allocators)]
        eng.flush()
        checks = []
        for alloc, prefix in zip(eng.allocators, eng.prefixes):
            prefix.clear()
            try:
                alloc.check_consistent()
                checks.append(alloc.fully_free)
            except AssertionError:
                checks.append(False)
        out[name] = {"status": [eng._all[u].status for u in uids],
                     "ends": [ends.count(u) for u in uids],
                     "streams": [[int(t) for t in eng._all[u].generated]
                                 for u in uids],
                     "drained_consistent": checks,
                     "block_pages": eng.block_pages, "hwm": hwm,
                     "preemptions": eng.stats["preemptions"]}
    return out


# the unified engine's programs the analysis rules R2 and R6 read on a mesh
ANALYSIS_PROGRAMS = ("unified", "paged", "int8")


def _analysis(mesh) -> dict:
    """R2 and R6 over one traced step of each of ``ANALYSIS_PROGRAMS`` on
    this rank (the reduced qwen3-moe at capacity factor 8, as the
    analysis CLI runs it on a mesh), and R6 over the paged step with a
    planted all-gather of a layer's expert weights."""
    import dataclasses

    from repro_torch.analysis import programs
    from repro_torch.analysis.collectives import CollectiveBudgetRule
    from repro_torch.analysis.sharding_lint import ShardingLintRule
    from repro_torch.core import collectives
    from repro_torch.launch import opcount
    found, bytes_ = {}, {}
    for v in ANALYSIS_PROGRAMS:
        prog = programs.trace_program(v, device="cpu", mesh=mesh,
                                      cfg_kw=dict(capacity_factor=8.0))
        found[v] = [str(f) for rule in (CollectiveBudgetRule(),
                                        ShardingLintRule())
                    for f in rule.check(prog)]
        bytes_[v] = dict(prog.coll)
        if v == "paged":
            paged = prog
    w = paged.engine.params["blocks"]["experts"]["w_gate"][0]
    cap = opcount.capture(lambda: collectives.all_gather(w, mesh, "model", 0))
    planted = dataclasses.replace(paged, records=paged.records + cap.records)
    return {"findings": found, "bytes": bytes_,
            "planted": [f.detail for f in ShardingLintRule().check(planted)]}


def _packed_mixed(rank: int, mesh) -> dict:
    """Each packed collective over "model" of a list mixing bf16 and fp32
    tensors (a bf16 layer beside RG-LRU's or Mamba-2's fp32 leaves, one
    exchange a dtype), against the per-tensor collective of each: whether
    every result has the bits and dtype of the per-tensor one, and the
    bytes each side booked."""
    import torch
    from repro_torch.core import collectives
    rng = np.random.default_rng(100 + rank)
    xs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(dt) for shape, dt in (((8, 3), torch.bfloat16),
                                    ((4, 8), torch.float32),
                                    ((8,), torch.bfloat16),
                                    ((2, 8, 2), torch.float32))]
    dims = [0, 1, 0, 1]
    n = mesh.shape["model"]
    same = lambda got, want: all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    out = {}
    for name, packed, single in (
            ("all_gather", lambda: collectives.all_gather_packed(
                xs, mesh, "model", dims, "mixed"),
             lambda x, d: collectives.all_gather(x, mesh, "model", d)),
            ("psum_scatter", lambda: collectives.psum_scatter_packed(
                xs, mesh, "model", dims, "mixed"),
             lambda x, d: collectives.psum_scatter(x, mesh, "model", d)),
            ("psum", lambda: collectives.psum_packed(
                xs, mesh, "model", "mixed"),
             lambda x, d: collectives.psum(x, mesh, "model")),
            ("pmean", lambda: collectives.psum_packed(
                xs, mesh, "model", "mixed", mean=True),
             lambda x, d: collectives.psum(x, mesh, "model") / n)):
        mesh.reset_counters()
        got = packed()
        packed_bytes = mesh.bytes.get("mixed", 0)
        mesh.reset_counters()
        want = [single(x, d) for x, d in zip(xs, dims)]
        out[name] = {"equal": same(got, want), "packed_bytes": packed_bytes,
                     "single_bytes": sum(mesh.bytes.values())}
    return out
