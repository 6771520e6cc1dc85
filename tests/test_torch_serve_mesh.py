"""Port vs JAX: serving on a mesh (the serve-mode layout of
``launch/sharding.py``: tensor parallelism over "model", the experts
under the schedules, context-parallel decode in the two-program engine)
on meshes of (2, 2) and (1, 4) ranks, fp32 on the reduced configs, CPU.

The JAX side (``torch_serve_oracle.py``) runs in a subprocess with four
host devices: the reference's one-device engine on the shared weights
(its mesh engine's own check demands exactly these streams of it), its
mesh engine on an ``Auto`` (2, 2) mesh where capacity binds, and its
``attn_decode_step_cp`` on that mesh.  The port side
runs as four spawned gloo rank processes per mesh (``torch_serve_cases``),
meeting through a ``FileStore`` in the test's tmp dir; each rank bridges
its serve-mode blocks (``bridge.from_jax_params(..., mode="serve")``) and
runs the mesh engine.

Checked: greedy streams of the reduced qwen3-moe (capacity factor 8,
decentralized and a2a_pipelined) through the unified step over the page
pool and the contiguous cache and through the two-program engine with
context-parallel decode, of its int8-weight form (block 64), of the
dense qwen3-0.6b, and of two variants whose specs keep a weight whole
(six q heads and a QKV bias: wq and wo whole on four ranks; d_ff 12 in
int4: W_down
whole on four ranks, its scales re-blocked on two), equal to the JAX
one-device engine's on every rank, with the rows cut over "data" on
(2, 2) (each rank serves its data block's row); three slots, which no
data axis cuts, under the centralized schedule, every rank holding the
whole batch and streaming as the port's one-device engine; a 13-page
pool, each data block's 13 // G pages, streaming as the JAX one-device
engine;
each rank's weight bytes equal its serve blocks' and its caches its data
block's rows or pages of the kv heads (or sequence block) its attention
uses; at the default capacity factor, on traffic where capacity binds,
the streams of the JAX engine on the same mesh shape (each data block of
rows planned apart); one unified step's collective bytes by kind on each
rank equal to ``predicted_collective_bytes(..., n_batch_shards=G,
include_tp=True)`` with the head gather apart, and its logits the rank's
rows of the one-device step's; an overcommitted serve (two slots a data
block) whose every request ends once, each data block's allocator
consistent and drained, the streams those of the same traffic served
with whole lifetimes reserved; ``attn_decode_step_cp``
within 1e-5 of JAX's (the int8 payload exact) and of the port's one-device
``attn_decode_step``; a deadline on rank 0's clock expiring the same
request on every rank; ``psum`` the rank-order bfloat16 sum on every
rank; the packed collectives of a list mixing bf16 and fp32 equal to each
tensor's own collective."""
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ep_cases
import torch_serve_cases as cases
from repro_torch import bridge
from repro_torch.core import collectives, perf_model
from repro_torch.launch import sharding
from repro_torch.models import attention, transformer
from repro_torch.models.model import HEAD, build_model
from test_torch_expert_parallel import SPAWN_TIMEOUT_S, _collect, _FakeMesh

ROOT = Path(__file__).resolve().parents[1]
TOL_CP = 1e-5
TOL_LOGITS = 1e-5
ORACLE_PARTS = ("engines", "binding")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"oracle": the JAX results, mesh name: [each rank's results],
    "params": the weights}: the oracle's two parts (subprocesses) and both
    meshes' ranks at once."""
    tmp = tmp_path_factory.mktemp("serve")
    flat = {}
    for a in cases.ARCHS:
        params = torch_ep_cases.model_params(bridge.param_shapes(
            cases.port_config(a)))
        flat.update({f"{a}/{k}": v for k, v in
                     torch_ep_cases.flatten(params).items()})
    params_path = str(tmp / "params.npz")
    np.savez(params_path, **flat)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    oracles = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_serve_oracle.py"),
         params_path, str(tmp / f"oracle_{part}.npz"), part], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in ORACLE_PARTS]
    ctx = mp.get_context("spawn")
    try:
        spawned = {}
        for m, shape in cases.MESHES.items():
            q = ctx.Queue()
            world = shape[0] * shape[1]
            procs = [ctx.Process(target=cases.rank_main, args=(
                r, world, str(tmp / f"store_{m}"), shape, params_path, q))
                for r in range(world)]
            for p in procs:
                p.start()
            spawned[m] = (procs, q)
        out = {m: _collect(*sp) for m, sp in spawned.items()}
        for oracle in oracles:
            log, _ = oracle.communicate(timeout=SPAWN_TIMEOUT_S)
            assert oracle.returncode == 0, log[-4000:]
    finally:
        for oracle in oracles:
            if oracle.poll() is None:
                oracle.kill()
                oracle.wait()
    out["oracle"] = {}
    for part in ORACLE_PARTS:
        out["oracle"].update(np.load(tmp / f"oracle_{part}.npz"))
    out["params"] = {a: torch_ep_cases.unflatten(
        {k[len(a) + 1:]: v for k, v in flat.items()
         if k.startswith(a + "/")}) for a in cases.ARCHS}
    return out


def _mesh(name: str, rank: int) -> _FakeMesh:
    n_data, n_model = cases.MESHES[name]
    return _FakeMesh((n_data, n_model), data=rank // n_model,
                     model=rank % n_model)


SERVES = [(m, c) for m in cases.MESHES for c in cases.engine_cases()]


@pytest.mark.parametrize("mesh_name,case", SERVES,
                         ids=[f"{m}-{c}" for m, c in SERVES])
def test_streams_equal_the_jax_one_device_engine(runs, mesh_name, case):
    """Every rank's greedy streams equal the JAX one-device engine's,
    exactly, so every rank's equal each other's."""
    arch, quant, mode, _ = cases.engine_cases()[case]
    key = cases.oracle_key(arch, quant, mode)
    want = [runs["oracle"][f"serve/{key}/{i}"].tolist()
            for i in range(len(cases.traffic()))]
    for rank, rec in enumerate(runs[mesh_name]):
        assert rec[f"serve/{case}"]["streams"] == want, (rank, want)


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_ranks_hold_their_serve_blocks_and_caches(runs, mesh_name):
    """Each rank's weight bytes are its serve blocks' bytes from the specs
    (``sharding.block_bytes``); its page pool holds its data block's
    ``num_pages / G`` pages and its contiguous cache its B / G rows (G = 2
    on (2, 2), 1 on (1, 4)), of the kv heads its q heads read, and the
    two-program engine's cache its rows' sequence block of every kv
    head."""
    shape = cases.MESHES[mesh_name]
    n_model = shape[1]
    b, c = cases.ENGINE["max_batch"], cases.ENGINE["max_cache"]
    g = cases.data_blocks(_mesh(mesh_name, 0), b)
    assert g == shape[0]
    for rank, rec in enumerate(runs[mesh_name]):
        mesh = _mesh(mesh_name, rank)
        for case, (arch, quant, mode, ep) in cases.engine_cases().items():
            cfg = cases.port_config(arch, quant, ep)
            got = rec[f"serve/{case}"]
            assert got["weight_bytes"] == sharding.block_bytes(cfg, mesh)
            tp = transformer.serve_tp(cfg, mesh).attn
            hd, L = cfg.head_dim, cfg.num_layers
            if mode == "paged":
                want = (L, b * c // cases.ENGINE["page_size"] // g,
                        cases.ENGINE["page_size"], tp.hkv, hd)
            elif mode == "contiguous":
                want = (L, b // g, c, tp.hkv, hd)
            else:
                want = (L, b // g, c // n_model, cfg.num_kv_heads, hd)
            assert got["cache_shape"] == want, (case, got["cache_shape"])


def _one_device_streams(params: dict, mode: str) -> list:
    """The port's one-device engine's greedy streams of ``cases.traffic``
    over ``cases.UNCUT_ENGINE`` (three slots) in ``mode``."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = cases.port_config("moe", ep="centralized")
    eng = ServingEngine(cfg, EngineConfig(**cases.UNCUT_ENGINE,
                                          **cases.MODES[mode]),
                        params=bridge.from_jax_params(params, cfg, "cpu"),
                        device="cpu")
    return cases._serve(eng)


UNCUT_IDS = [(m, mode) for m in cases.MESHES for mode in cases.UNCUT_MODES]


@pytest.mark.parametrize("mesh_name,mode", UNCUT_IDS,
                         ids=[f"{m}-{mode}" for m, mode in UNCUT_IDS])
def test_uncut_rows_serve_as_one_device(runs, mesh_name, mode):
    """Three slots, which the data axes of neither mesh cut, under the
    centralized schedule (whose one-token decode passes its result round
    the "model" ranks by global rank): every rank holds the whole batch's
    cache (the whole pool) and streams exactly as the port's one-device
    engine on the same three slots."""
    n_model = cases.MESHES[mesh_name][1]
    want = _one_device_streams(runs["params"]["moe"], mode)
    b, c = cases.UNCUT_ENGINE["max_batch"], cases.UNCUT_ENGINE["max_cache"]
    ps = cases.UNCUT_ENGINE["page_size"]
    for rank, rec in enumerate(runs[mesh_name]):
        got = rec[f"uncut/{mode}"]
        assert got["blocks"] == 1
        assert got["cache_shape"][1] == (b * c // ps if mode == "paged"
                                         else b), got["cache_shape"]
        if mode == "reference":
            assert got["cache_shape"][2] == c // n_model
        assert got["streams"] == want, (rank, got["streams"], want)


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_pool_the_data_blocks_do_not_divide(runs, mesh_name):
    """A 13-page pool on a mesh whose rows are cut: each data block's pool
    holds ``13 // G`` pages (the remainder unused), and every rank streams
    as the JAX one-device engine."""
    g = cases.data_blocks(_mesh(mesh_name, 0), cases.ENGINE["max_batch"])
    key = cases.oracle_key("moe", "fp32", "paged")
    want = [runs["oracle"][f"serve/{key}/{i}"].tolist()
            for i in range(len(cases.traffic()))]
    for rank, rec in enumerate(runs[mesh_name]):
        got = rec["odd_pool"]
        assert got["block_pages"] == got["pool_pages"] == 13 // g
        assert got["streams"] == want, (rank, got["streams"], want)


BINDING_IDS = [(m, ep) for m, eps in cases.BINDING_CASES.items()
               for ep in eps]


@pytest.mark.parametrize("mesh_name,ep", BINDING_IDS,
                         ids=[f"{ep}-{m}" for m, ep in BINDING_IDS])
def test_capacity_per_data_block_matches_jax_mesh_engine(runs, mesh_name,
                                                         ep):
    """At the default capacity factor, where capacity binds, every rank
    streams as the JAX engine on the same mesh shape: on (2, 2) each data
    block of rows gets its own capacity, as the reference's ``shard_map``
    plans it, which gives other streams than the one-device engine (the
    traffic is chosen so); on (1, 4) the decentralized schedule's one
    block is the whole batch, the one-device engine's plan."""
    ref = runs["oracle"]
    n = len(cases.binding_traffic())
    jax_streams = {w: [ref[f"binding/{ep}/{w}/{i}"].tolist()
                       for i in range(n)] for w in ("single", "mesh")}
    assert jax_streams["single"] != jax_streams["mesh"]
    want = jax_streams["mesh" if cases.MESHES[mesh_name][0] > 1
                       else "single"]
    for r, rank in enumerate(runs[mesh_name]):
        assert rank[f"binding/{ep}"] == want, (r, rank[f"binding/{ep}"],
                                               want)


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
@pytest.mark.parametrize("ep", cases.SCHEDULES)
def test_unified_step_bytes_equal_the_prediction(runs, mesh_name, ep):
    """One unified step's collective bytes on each rank, kind by kind,
    equal ``predicted_collective_bytes(..., n_batch_shards=G,
    include_tp=True)`` (the embedding psum, the ``wo`` psums, the flat
    k/v gathers and the schedule), G the data blocks of rows: each rank
    runs its block, as the reference's per-shard program does; the
    head's vocabulary gather, the aux pmeans and the layout step are
    booked apart.  Each rank's pool holds its block's pages, and its
    logits are its rows of the one-device step's."""
    n_data, n_model = cases.MESHES[mesh_name]
    b, t = cases.BYTES_BLOCK
    g = cases.data_blocks(_mesh(mesh_name, 0), b)
    cfg = cases.port_config("moe", ep=ep)
    want = perf_model.predicted_collective_bytes(
        cfg, batch=b, seq=t, n_exp_shards=n_model, n_batch_shards=g,
        include_tp=True)
    model = build_model(cfg, "cpu")
    params = bridge.from_jax_params(runs["params"]["moe"], cfg, "cpu")
    cache = model.init_paged_cache(8, 4)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, 500, (b, t)).astype(np.int32))
    batch = {"tokens": tok, "lengths": torch.tensor([0, 3],
                                                    dtype=torch.int32),
             "seg_lens": torch.tensor([t, 2], dtype=torch.int32),
             "block_tables": torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]],
                                          dtype=torch.int32)}
    with torch.no_grad():
        one, _ = model.forward_routed(params, batch, cache, context_len=16)
    bl = b // g
    recs = [r[f"bytes/{ep}"] for r in runs[mesh_name]]
    for rank, rec in enumerate(recs):
        got = {k: v for k, v in rec["bytes"].items()
               if k not in (collectives.AUX, collectives.LAYOUT, HEAD)}
        assert got == {k: int(v) for k, v in want.items()}, (got, want)
        assert rec["bytes"][HEAD] == bl * cfg.vocab_padded // n_model * 4
        assert rec["pool_pages"] == 8 // g
        rows = slice(rank // n_model * bl, (rank // n_model + 1) * bl)
        # the same bits as the first rank of its data block
        np.testing.assert_array_equal(
            rec["logits"], recs[rank // n_model * n_model]["logits"])
        np.testing.assert_allclose(rec["logits"], one.numpy()[rows],
                                   rtol=0, atol=TOL_LOGITS)


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
@pytest.mark.parametrize("ep", cases.ALL_SCHEDULES)
def test_serving_books_no_aux_mean(runs, mesh_name, ep):
    """A serving step asks the MoE layer for no aux loss, so no schedule
    takes its mean over the mesh: a prefill block and a decode step under
    each of the four schedules book no ``collectives.AUX`` bytes on any
    rank (the forward on a mesh still does:
    ``test_torch_expert_parallel.py``'s ``_check_bytes``), while the
    step's own collectives ran."""
    for rank, rec in enumerate(r[f"aux/{ep}"] for r in runs[mesh_name]):
        assert sorted(rec) == [1, cases.BYTES_BLOCK[1]], rank
        for t, nbytes in rec.items():
            assert collectives.AUX not in nbytes, (rank, t, nbytes)
            assert nbytes.get("all-reduce", 0) > 0, (rank, t, nbytes)


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
@pytest.mark.parametrize("quant", list(cases.CP_CACHE))
def test_cp_decode_matches_jax(runs, mesh_name, quant):
    """``attn_decode_step_cp`` over each rank's sequence block of its
    rows (B / 2 of them on (2, 2)): the output within 1e-5 of JAX's on its
    (2, 2) mesh and of the port's one-device ``attn_decode_step`` on those
    rows; each rank's cache block equal to the same rows and slots of
    JAX's whole cache (an int8 payload exactly)."""
    _check_cp(runs, mesh_name, quant, "cp")


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
@pytest.mark.parametrize("quant", list(cases.CP_CACHE))
def test_cp_decode_ring_matches_jax(runs, mesh_name, quant):
    """The same over a ring (a window as long as the 32-slot cache), the
    rows' lengths running past the cache so their writes wrap: each rank
    writes slot lengths % 32 when its block holds it, and every written
    slot is attended."""
    _check_cp(runs, mesh_name, quant, "cp_ring")


def _check_cp(runs, mesh_name: str, quant: str, name: str) -> None:
    window = cases.CP_WINDOWS[name]
    n_model = cases.MESHES[mesh_name][1]
    ref = runs["oracle"]
    cfg = cases.port_config("dense", kv_cache_dtype=cases.CP_CACHE[quant])
    p = transformer._layer(bridge.from_jax_params(
        runs["params"]["dense"], cfg, "cpu")["blocks"], 0)["attn"]
    cache = attention.init_layer_cache(cfg, cases.CP_B, cases.CP_LEN,
                                       torch.float32, "cpu")
    one = []
    with torch.no_grad():
        for x, lengths in cases.cp_inputs(cfg.d_model, window is not None):
            one.append(attention.attn_decode_step(
                p, cfg, cache, torch.from_numpy(x),
                torch.from_numpy(lengths), window).numpy())
    s_loc = cases.CP_LEN // n_model
    b_loc = cases.CP_B // cases.data_blocks(_mesh(mesh_name, 0),
                                            cases.CP_B)
    for rank, rec in enumerate(runs[mesh_name]):
        got = rec[f"{name}/{quant}"]
        rows = slice(*got["rows"])
        assert rows == slice(rank // n_model * b_loc,
                             (rank // n_model + 1) * b_loc)
        np.testing.assert_allclose(got["out"],
                                   ref[f"{name}/{quant}/out"][:, rows],
                                   rtol=0, atol=TOL_CP)
        np.testing.assert_allclose(got["out"], np.stack(one)[:, rows],
                                   rtol=0, atol=TOL_CP)
        blk = slice(rank % n_model * s_loc, (rank % n_model + 1) * s_loc)
        for k, v in got["cache"].items():
            whole = ref[f"{name}/{quant}/cache/{k}"][rows, blk]
            if v.dtype == np.int8:
                np.testing.assert_array_equal(v, whole)
            else:
                np.testing.assert_allclose(v, whole, rtol=0, atol=TOL_CP)
        assert got["bytes"]["all-reduce"] > 0


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_psum_is_the_rank_order_sum(runs, mesh_name):
    """``psum`` adds its group's bfloat16 terms first to last in
    bfloat16, so every rank holds the rank-order sum bit for bit, at any
    group size (what the serving mesh's TP sums rest on: every rank's
    logits, hence its sampled tokens, the same)."""
    n_model = cases.MESHES[mesh_name][1]
    for rank, run in enumerate(runs[mesh_name]):
        want = None
        for r in range(rank - rank % n_model, rank - rank % n_model + n_model):
            x = torch.from_numpy(cases.sum_input(r)).to(torch.bfloat16)
            want = x if want is None else want + x
        assert torch.equal(torch.from_numpy(run["psum"]), want.float())


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_deadline_expires_on_every_rank(runs, mesh_name):
    """Rank 0's clock jumps past one request's deadline; its clock is the
    mesh's (broadcast each step while a deadline exists), so every rank
    expires that request at the same step and serves the others alike."""
    recs = [r["deadline"] for r in runs[mesh_name]]
    for rec in recs:
        assert rec["status"] == ["done", "expired", "done"]
        assert rec["streams"] == recs[0]["streams"]
        assert rec["broadcast_bytes"] > 0


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_analysis_rules_on_every_rank(runs, mesh_name):
    """The analysis rules R2 (collective bytes, ``predicted_collective_bytes
    (..., n_batch_shards=G, include_tp=True)`` on each rank, the aux,
    layout, head and row-gather kinds booked apart) and R6 (no
    expert-weight all-gather) hold on every rank for the unified engine's
    programs; the row gather moves each rank's rows' token, flag and
    routing (L x T x K), int32, once a data axis (nothing on (1, 4)); on
    the paged step a planted all-gather of one layer's expert weights
    fires R6 on every rank."""
    shape = cases.MESHES[mesh_name]
    n_model = shape[1]
    cfg = cases.port_config("moe")
    b, t = 2, 4                     # programs.build_engine's block
    g = cases.data_blocks(_mesh(mesh_name, 0), b)
    rows = (b // g * (2 + cfg.num_layers * t * cfg.experts_per_token) * 4
            if g > 1 else 0)
    for r, rank in enumerate(runs[mesh_name]):
        got = rank["analysis"]
        for v in cases.ANALYSIS_PROGRAMS:
            assert got["findings"][v] == [], (r, v, got["findings"][v])
            assert got["bytes"][v].get("all-reduce", 0) > 0, (r, v)
            assert got["bytes"][v].get(collectives.ROWS, 0) == rows, (r, v)
        assert len(got["planted"]) == 1, (r, got["planted"])
        planted = got["planted"][0]
        assert planted["bytes"] == n_model * planted["threshold"]


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_overcommitted_serve_per_data_block(runs, mesh_name):
    """An overcommitted serve of five requests (two slots a data block on
    (2, 2), each block's pool 6 pages; four slots over 12 on (1, 4)):
    preemptions happen, every request ends once and done, no block's pages
    in use pass its pool, each block's allocator is consistent and drained
    once its prefix tree is cleared, and the streams are those of the
    same traffic served with whole lifetimes reserved, alike on every
    rank."""
    recs = [r["overcommit"] for r in runs[mesh_name]]
    g = cases.data_blocks(_mesh(mesh_name, 0),
                          cases.OVERCOMMIT_ENGINE["max_batch"])
    n = len(cases.overcommit_traffic())
    for rec in recs:
        for name in ("overcommit", "reserved"):
            got = rec[name]
            assert got["status"] == ["done"] * n, (name, got["status"])
            assert got["ends"] == [1] * n, (name, got["ends"])
            assert got["drained_consistent"] == [True] * g, name
            assert got["block_pages"] == cases.OVERCOMMIT_ENGINE[
                "num_pages"] // g
            assert max(got["hwm"]) <= got["block_pages"]
            assert got["streams"] == recs[0][name]["streams"]
        assert rec["overcommit"]["preemptions"] > 0
        assert rec["overcommit"]["streams"] == rec["reserved"]["streams"]


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_packed_collectives_mixed_dtypes(runs, mesh_name):
    """``all_gather_packed``, ``psum_scatter_packed`` and ``psum_packed``
    (sum and mean) of a list of bf16 and fp32 tensors give, on every rank,
    the bits and dtype of each tensor's own collective, and book the same
    bytes."""
    for r, rank in enumerate(runs[mesh_name]):
        for name, got in rank["packed_mixed"].items():
            assert got["equal"], (r, name)
            assert got["packed_bytes"] == got["single_bytes"] > 0, (r, name,
                                                                   got)
