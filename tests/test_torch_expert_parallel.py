"""Port vs JAX for the paper's expert-parallel schedules (decentralized,
centralized, a2a, a2a_pipelined) on meshes of (2, 2) and (1, 4) ranks, fp32
on the reduced configs, CPU.

The JAX side (``torch_ep_oracle.py``) runs in a subprocess per mesh with
four host devices, on an ``Auto``-axis mesh under ``jax.set_mesh``.  The port side
runs as four spawned gloo rank processes per mesh (``torch_ep_cases``),
which meet through a ``FileStore`` in ``tmp_path`` (no TCP port to collide
between test workers).  Both sides run at once and read the same numpy
inputs; each rank hands back its blocks, which are held to the JAX
arrays' rows.

Checked: every schedule x strategy at a prefill (4, 16) and a decode (4, 1)
block (y within 1e-5, top_idx identical, aux within 1e-6), the dispatch
strategy at B=3 (the data axes do not divide it), the gather decode fast
path, and ``Model.forward`` on the mesh (logits within 1e-4, identical
argmax, layer 0's routing equal to the single-device forward's); the
reference's own properties in the port (pipelined chunks, the fallbacks
bit for bit, padded experts, replication, int8 / int4 expert shards); and
every rank's collective bytes, kind by kind, equal to
``perf_model.predicted_collective_bytes``, with the aux pmeans and the
layout step counted apart; and 16-bit sums kept in their dtype."""
import multiprocessing as mp
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ep_cases as cases
from repro_torch import bridge
from repro_torch.core import collectives, expert_parallel, perf_model
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parents[1]
TOL_Y = 1e-5
TOL_AUX = 1e-6
TOL_LOGITS = 1e-4
SPAWN_TIMEOUT_S = 240


def _spawn_mesh(shape, params_path: str, tmp: Path, name: str):
    """Start the mesh's rank processes; returns (processes, queue)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    world = shape[0] * shape[1]
    procs = [ctx.Process(target=cases.rank_main, args=(
        r, world, str(tmp / f"store_{name}"), shape, params_path, q))
        for r in range(world)]
    for p in procs:
        p.start()
    return procs, q


def _collect(procs, q) -> dict:
    res = {}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while len(res) < len(procs) and time.monotonic() < deadline:
            try:
                rank, val = q.get(timeout=2)
            except Exception:  # queue.Empty: a rank may have died
                if not any(p.is_alive() for p in procs):
                    break
                continue
            if isinstance(val, str):
                raise AssertionError(f"rank {rank} failed:\n{val}")
            res[rank] = val
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    assert len(res) == len(procs), (
        f"ranks {sorted(res)} of {len(procs)} reported; exit codes "
        f"{[p.exitcode for p in procs]}")
    return [res[r] for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"oracle": {mesh name: JAX npz}, mesh name: [each rank's results],
    "params": the forward cases' parameters}: one oracle subprocess per
    mesh and both meshes' ranks, all at the same time."""
    tmp = tmp_path_factory.mktemp("ep")
    flat = {}
    for arch in cases.FORWARD_ARCHS:
        params = cases.model_params(bridge.param_shapes(
            cases.port_config(arch)))
        flat.update({f"{arch}/{k}": v
                     for k, v in cases.flatten(params).items()})
    params_path = str(tmp / "params.npz")
    np.savez(params_path, **flat)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    oracles = {m: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_ep_oracle.py"),
         params_path, str(tmp / f"oracle_{m}.npz"), m], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for m in cases.MESHES}
    try:
        spawned = {m: _spawn_mesh(shape, params_path, tmp, m)
                   for m, shape in cases.MESHES.items()}
        out = {m: _collect(*sp) for m, sp in spawned.items()}
        for m, proc in oracles.items():
            log, _ = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            assert proc.returncode == 0, log[-4000:]
    finally:
        for proc in oracles.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["oracle"] = {m: dict(np.load(tmp / f"oracle_{m}.npz"))
                     for m in cases.MESHES}
    out["params"] = flat
    return out


def _rows(rec):
    return slice(*rec["rows"])


def _check_bytes(rec, cfg, b, s, shape, n_layers=1):
    """This rank's schedule bytes equal the prediction kind by kind; the
    aux pmeans and the layout step are counted apart, at their own sizes."""
    n_data, n_model = shape
    want = perf_model.predicted_collective_bytes(
        cfg, batch=b, seq=s, n_exp_shards=n_model, n_batch_shards=n_data,
        n_moe_layers=n_layers, include_tp=False)
    got = {k: v for k, v in rec["bytes"].items()
           if k not in (collectives.AUX, collectives.LAYOUT)}
    assert got == {k: int(v) for k, v in want.items()}, (got, want)
    axes, rows = expert_parallel.batch_shard(_FakeMesh(shape), b)
    bl = rows.stop - rows.start
    seq_sharded = (cfg.expert_parallel == "centralized"
                   or cfg.expert_parallel.startswith("a2a")) and s % n_model == 0
    layout = (n_layers * bl * s // n_model
              * (cfg.d_model * 4 + cfg.experts_per_token * 4)
              if seq_sharded and n_model > 1 else 0)
    assert rec["bytes"].get(collectives.LAYOUT, 0) == layout
    # one fp32 scalar per aux pmean: per layer, when the schedule pmeans
    pmeans = (cfg.expert_parallel != "decentralized" and s % n_model == 0
              and n_model > 1) or (bool(axes) and n_data > 1)
    assert rec["bytes"].get(collectives.AUX, 0) == (4 * n_layers
                                                    if pmeans else 0)


class _FakeMesh:
    """Axis sizes and one rank's coordinates (rank 0's by default): enough
    for ``batch_shard`` and ``expert_rows``, with no process group."""

    def __init__(self, shape, data=0, model=0):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = {"data": data, "model": model}


MOE_IDS = [(m, name) for m in cases.MESHES for name in cases.moe_cases()]


@pytest.mark.parametrize("mesh_name,case", MOE_IDS,
                         ids=[f"{m}-{n}" for m, n in MOE_IDS])
def test_moe_layer_matches_jax(runs, mesh_name, case):
    ref = runs["oracle"][mesh_name]
    key = f"moe/{case}"
    y, aux, ti = (ref[key + "/y"], float(ref[key + "/aux"]),
                  ref[key + "/top_idx"])
    b, s = cases.block_of(case)
    cfg = cases.port_config().replace(**cases.moe_cases()[case])
    ti = ti.reshape(b, s, -1)
    for rec in (r[f"moe/{case}"] for r in runs[mesh_name]):
        rows = _rows(rec)
        np.testing.assert_allclose(rec["y"], y[rows], rtol=0, atol=TOL_Y)
        np.testing.assert_array_equal(rec["top_idx"],
                                      ti[rows].reshape(-1, ti.shape[-1]))
        assert abs(rec["aux"] - aux) <= TOL_AUX
        _check_bytes(rec, cfg, b, s, cases.MESHES[mesh_name])


FORWARD_IDS = [(m, a, ep) for m in cases.MESHES for a in cases.FORWARD_ARCHS
               for ep in cases.SCHEDULES]


@pytest.mark.parametrize("mesh_name,arch,ep", FORWARD_IDS,
                         ids=[f"{m}-{a}-{ep}" for m, a, ep in FORWARD_IDS])
def test_forward_on_mesh_matches_jax(runs, mesh_name, arch, ep):
    ref = runs["oracle"][mesh_name]
    key = f"forward/{arch}/{ep}"
    logits, aux = ref[key + "/logits"], float(ref[key + "/aux"])
    cfg = cases.port_config(arch, expert_parallel=ep, ep_microchunks=2)
    tree = cases.unflatten({k[len(arch) + 1:]: v
                            for k, v in runs["params"].items()
                            if k.startswith(arch + "/")})
    tokens = torch.from_numpy(cases.forward_tokens(cfg.vocab_size))
    with torch.no_grad():
        _, _, routing = build_model(cfg, "cpu").forward_seq_routed(
            bridge.from_jax_params(tree, cfg, "cpu"), {"tokens": tokens})
    b, s = tokens.shape
    routing = routing.numpy().reshape(cfg.num_layers, b, s, -1)
    for rec in (r[f"forward/{arch}/{ep}"] for r in runs[mesh_name]):
        rows = _rows(rec)
        v = cfg.vocab_size
        np.testing.assert_allclose(rec["logits"], logits[rows],
                                   rtol=0, atol=TOL_LOGITS)
        np.testing.assert_array_equal(rec["logits"][..., :v].argmax(-1),
                                      logits[rows, :, :v].argmax(-1))
        assert abs(rec["aux"] - aux) <= TOL_AUX * cfg.num_layers
        # layer 0 routes the same inputs on both; later layers see the
        # schedule's capacity per block, as in the reference
        np.testing.assert_array_equal(
            rec["routing"][0], routing[0, rows].reshape(-1, routing.shape[-1]))
        _check_bytes(rec, cfg, b, s, cases.MESHES[mesh_name],
                     n_layers=cfg.num_layers)


def _global(recs, key):
    """The global y of a port case, reassembled from the ranks' rows."""
    b = max(r[key]["rows"][1] for r in recs)
    first = recs[0][key]["y"]
    y = np.zeros((b,) + first.shape[1:], first.dtype)
    for r in recs:
        y[_rows(r[key])] = r[key]["y"]
    return y


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
@pytest.mark.parametrize("m", cases.PIPELINE_M)
def test_pipelined_chunks_match_a2a(runs, mesh_name, m):
    recs = runs[mesh_name]
    a2a = _global(recs, "moe/a2a-dispatch-4x16")
    np.testing.assert_allclose(_global(recs, f"pipelined/m{m}"), a2a,
                               rtol=0, atol=TOL_Y)
    for r in recs:
        np.testing.assert_array_equal(r[f"pipelined/m{m}"]["top_idx"],
                                      r["moe/a2a-dispatch-4x16"]["top_idx"])


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_fallbacks_are_bitwise(runs, mesh_name):
    """m = 3 on T_loc = 8 is a2a, and a single-token decode of both a2a
    schedules is decentralized, bit for bit: the same code runs."""
    recs = runs[mesh_name]
    np.testing.assert_array_equal(_global(recs, "tloc8/a2a_pipelined"),
                                  _global(recs, "tloc8/a2a"))
    for strat in cases.STRATEGIES:
        dec = _global(recs, f"moe/decentralized-{strat}-4x1")
        for ep in ("a2a", "a2a_pipelined"):
            np.testing.assert_array_equal(
                _global(recs, f"moe/{ep}-{strat}-4x1"), dec)


def _single_device(cfg, lp, x, experts=None):
    if experts is None:
        experts = {k: torch.from_numpy(w) for k, w in lp["experts"].items()}
    y, _, _ = expert_parallel.moe_layer(
        cfg, {"router": torch.from_numpy(lp["router"]), "experts": experts},
        torch.from_numpy(x))
    return y.numpy()


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
@pytest.mark.parametrize("ep", cases.SCHEDULES)
def test_padded_experts_equal_live_ones(runs, mesh_name, ep):
    """Six live experts padded to eight (zero weights, router-dead) give
    the six-expert result under every schedule."""
    gran = cases.port_config("granite_moe_3b_a800m", experts_per_token=2,
                             **cases.MOE_FIELDS)
    _, live = cases.padded_layer_params(gran.d_model, gran.d_ff)
    want = _single_device(gran.replace(num_experts=6, num_experts_padded=6),
                          live, cases.moe_input(4, 8, gran.d_model))
    np.testing.assert_allclose(_global(runs[mesh_name], f"padded/{ep}"),
                               want, rtol=0, atol=TOL_Y)


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_replication_equals_one_copy(runs, mesh_name):
    recs = runs[mesh_name]
    np.testing.assert_allclose(_global(recs, "replication/r2"),
                               _global(recs, "replication/r1"), rtol=0,
                               atol=TOL_Y)
    for r in recs:      # top_idx is the pre-stripe decision
        np.testing.assert_array_equal(r["replication/r2"]["top_idx"],
                                      r["replication/r1"]["top_idx"])
        assert r["replication/r2"]["bytes"] == r["replication/r1"]["bytes"]


QUANT_IDS = [(m, lv, ep) for m in cases.MESHES for lv in cases.QUANT_LEVELS
             for ep in cases.SCHEDULES]


@pytest.mark.parametrize("mesh_name,level,ep", QUANT_IDS,
                         ids=[f"{m}-{lv}-{ep}" for m, lv, ep in QUANT_IDS])
def test_quantized_shards_match_single_device(runs, mesh_name, level, ep):
    base = cases.port_config().replace(**cases.MOE_FIELDS,
                                       expert_parallel=ep)
    lp = cases.layer_params(base.d_model, base.d_ff, base.num_experts_padded)
    qexp = cases.quantized_experts(lp["experts"], level)
    for b, s in cases.BLOCKS:
        x = cases.moe_input(b, s, base.d_model)
        np.testing.assert_allclose(
            _global(runs[mesh_name], f"quant/{level}/{ep}/{b}x{s}"),
            _single_device(base, lp, x, qexp), rtol=0, atol=TOL_Y)


@pytest.mark.parametrize("mesh_name", list(cases.MESHES))
def test_16bit_sums_stay_in_their_dtype(runs, mesh_name):
    """``psum`` and ``psum_scatter`` of bfloat16 operands sum in bfloat16,
    as ``jax.lax.psum`` does: the results keep the dtype, every rank of an
    expert group gets the same sum, the counters book the operand's bytes
    (what the wire carries), and each sum lies within the bf16 bound
    2 (n-1) u (1+u)^(n-1) sum_r |x_r| of the rank-order sum, bit for bit
    over two ranks (a sum of two is order-free)."""
    u = 2.0 ** -8
    n_model = cases.MESHES[mesh_name][1]
    recs = [rec["sum16"] for rec in runs[mesh_name]]
    for rank, rec in enumerate(recs):
        group = [rank - rank % n_model + j for j in range(n_model)]
        xs = [torch.from_numpy(cases.collective_input(r)).to(torch.bfloat16)
              for r in group]
        want = xs[0]
        for x in xs[1:]:
            want = want + x
        want = want.float()
        bound = (2 * (n_model - 1) * u * (1 + u) ** (n_model - 1)
                 * sum(x.float().abs() for x in xs))
        assert rec["dtypes"] == ("torch.bfloat16", "torch.bfloat16")
        assert rec["bytes"] == {"all-reduce": xs[0].numel() * 2,
                                "reduce-scatter": xs[0].numel() * 2}
        got = torch.from_numpy(rec["psum"])
        assert np.array_equal(rec["psum"], recs[group[0]]["psum"])
        rows = xs[0].shape[0] // n_model
        blk = slice(rank % n_model * rows, (rank % n_model + 1) * rows)
        got_blk = torch.from_numpy(rec["psum_scatter"])
        if n_model == 2:
            assert torch.equal(got, want) and torch.equal(got_blk, want[blk])
        assert bool(((got - want).abs() <= bound).all())
        assert bool(((got_blk - want[blk]).abs() <= bound[blk]).all())


def test_expected_experts_per_shard_matches_jax():
    import jax.numpy as jnp
    from repro.core import router as jax_router
    from repro_torch.core import router
    rng = np.random.default_rng(3)
    for e, n, k, t in ((16, 4, 4, 8), (48, 4, 8, 32), (8, 2, 2, 1)):
        ti = np.stack([rng.permutation(e)[:k] for _ in range(t)])
        ti[0, 0] = e        # the E_pad dead-route sentinel hits nothing
        want = float(jax_router.expected_experts_per_shard(
            jnp.asarray(ti, jnp.int32), e, n))
        got = float(router.expected_experts_per_shard(
            torch.from_numpy(ti), e, n))
        assert got == want, (e, n, k, t)


@pytest.mark.parametrize("r", [1, 2])
def test_rank_init_and_bridge_keep_the_ranks_rows(r):
    """``Model.init(gen, mesh)`` draws every matrix and keeps this rank's
    expert rows: they equal the same rows of the whole draw (of its r
    copies); ``bridge.from_jax_params(..., mesh=)`` cuts the same rows,
    QuantTensor payload and scales alike."""
    from repro_torch.core import quant
    cfg = cases.port_config().replace(expert_replication=r)
    mesh = _FakeMesh((1, 4), model=3)
    model = build_model(cfg, "cpu")
    full = model.init(torch.Generator().manual_seed(5))
    mine = model.init(torch.Generator().manual_seed(5), mesh)
    rows = expert_parallel.expert_rows(cfg, mesh)
    for k, w in full["blocks"]["experts"].items():
        assert torch.equal(mine["blocks"]["experts"][k], w[:, rows]), k
    assert torch.equal(mine["blocks"]["router"], full["blocks"]["router"])
    assert torch.equal(mine["embed"], full["embed"])
    tree = bridge.to_numpy(full)
    tree["blocks"]["experts"] = bridge.to_numpy({"e": {
        k: quant.quantize(w, "int8") for k, w in
        full["blocks"]["experts"].items()}})["e"]
    cut = bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh)
    for k, w in cut["blocks"]["experts"].items():
        want = quant.quantize(full["blocks"]["experts"][k], "int8")
        assert torch.equal(w.data, want.data[:, rows])
        assert torch.equal(w.scale, want.scale[:, rows])


def test_batch_shard_follows_the_reference():
    """Rows by the data coordinate when the data axes divide B, the whole
    batch on every rank otherwise (``moe_layer``'s reference rule)."""
    assert expert_parallel.batch_shard(_FakeMesh((2, 2), data=1), 4) == (
        ("data",), slice(2, 4))
    assert expert_parallel.batch_shard(_FakeMesh((2, 2), data=1), 3) == (
        (), slice(0, 3))
    assert expert_parallel.batch_shard(_FakeMesh((1, 4)), 1) == (
        ("data",), slice(0, 1))


def test_entry_points_on_a_mesh_wait_for_meshes_2():
    """The loss, the trainer and ``shard_batch`` run on a mesh (queue A's
    "meshes (3)", ``tests/test_torch_train_mesh.py`` holds them to JAX on
    four ranks); the cached entry points and the engine serve on a mesh
    (``tests/test_torch_serve_mesh.py``).  On a (1, 1) mesh, whose
    collectives are identities, they are the one-device paths."""
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    cfg = cases.port_config()
    model = build_model(cfg, "cpu")
    mesh = mesh_lib.Mesh(("data", "model"), {"data": 1, "model": 1},
                         {"data": 0, "model": 0},
                         {"data": None, "model": None})
    rng = np.random.default_rng(0)
    tok = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                            dtype=np.int32))
           for k in ("tokens", "labels")}
    params = model.init(torch.Generator().manual_seed(0))
    blocks = model.init_training(torch.Generator().manual_seed(0), mesh)
    one, m1 = model.loss(params, tok, kernels=False)
    on_mesh, m2 = model.loss(blocks, tok, kernels=False, mesh=mesh)
    assert abs(float(one) - float(on_mesh)) <= 1e-6
    assert float(m1["aux"]) == float(m2["aux"])
    assert torch.equal(pipeline.shard_batch(tok, mesh)["tokens"], tok["tokens"])
    kw = dict(steps=2, global_batch=2, seq_len=8, log_every=1, device="cpu")
    _, h1 = train.train(cfg, **kw)
    _, h2 = train.train(cfg, mesh=mesh, **kw)
    for a, b in zip(h1, h2):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= 1e-5 * (1 + abs(a[k])), k


@pytest.mark.parametrize("ep,want", [
    ("decentralized", {"all-reduce": 100_663_296}),
    ("centralized", {"all-gather": 25_167_872, "reduce-scatter": 100_663_296}),
    ("a2a", {"all-to-all": 805_306_368})])
def test_dbrx_bytes_as_worked(ep, want):
    """DBRX's widths, 4 layers, B=1, S=2048, 4 expert shards, bf16 at
    capacity factor E_pad / K: the port's prediction is the reference's
    and the worked numbers."""
    from repro.configs.base import get_config as jax_get_config
    from repro.core import perf_model as jax_perf_model
    from repro_torch.configs.base import get_config
    kw = dict(num_layers=4, capacity_factor=4.0, expert_parallel=ep)
    args = dict(batch=1, seq=2048, n_exp_shards=4, include_tp=False)
    got = perf_model.predicted_collective_bytes(
        get_config("dbrx").replace(**kw), **args)
    assert got == jax_perf_model.predicted_collective_bytes(
        jax_get_config("dbrx").replace(**kw), **args) == want
