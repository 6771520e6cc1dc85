"""The port's dry-run (``repro_torch.launch.dryrun``) and its op counter
(``launch/opcount``) on the CPU, meta tensors only.

Held to the JAX package: every arch's parameter bytes at (1, 1) equal
``jax.eval_shape(model.init)``'s, every decode shape's cache bytes the
reference's ``cache_specs``, ``model_flops`` the reference's (taken
through one subprocess: importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices, which must not reach this process),
and ``opcount`` FLOPs ``hlo.analyze``'s on a matmul, a bf16 matmul and an
L-step scan (the port runs a loop), within a stated tolerance on a
reduced dense forward.  Beside those: per-rank block bytes at (16, 16)
equal ``sharding.block_bytes``, each kernel wrapper on meta tensors
returns its kernel's shape and books its cost, ``--all --reduced`` at
(16, 16) writes 44 records, all ok, the reduced qwen3-moe's serve
steps under each expert schedule move R2's predicted collective bytes at
that mesh, and rank 0's serving caches at (16, 16) hold the reference's
per-device bytes (``cache_pspec``: the rows over "data")."""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.launch import hlo
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeSpec, get_config
from repro_torch.core import quant
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun, opcount, sharding
from repro_torch.launch.mesh import make_meta_mesh
from repro_torch.models.model import build_model
from torch_archs import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
# the reduced dense forward: opcount's FLOPs (every aten op with a
# formula: the products, SDPA-free plain attention) against hlo.analyze's
# (XLA's dots); they count the same products, and the rest (the
# softmax's and norms' elementwise work carries no formula on either
# side) leaves them within this share of each other
FORWARD_FLOPS_RTOL = 0.02


def _jax_nbytes(tree) -> int:
    return sum(math.prod(a.shape) * np.dtype(a.dtype).itemsize
               for a in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_bytes_equal_the_reference(arch):
    ref_model = jax_build_model(jax_get_config(arch))
    want = _jax_nbytes(jax.eval_shape(ref_model.init, jax.random.PRNGKey(0)))
    cfg = get_config(arch)
    pair = dryrun.setup_pair(cfg, SHAPES["decode_32k"])
    assert dryrun.tree_nbytes(pair.arguments["params"]) == want
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        pair = dryrun.setup_pair(cfg, shape)
        assert dryrun.tree_nbytes(pair.arguments["cache"]) == _jax_nbytes(
            ref_model.cache_specs(shape.global_batch, shape.seq_len)), name
        assert dryrun.tree_nbytes(pair.aliased) == dryrun.tree_nbytes(
            pair.arguments["cache"])


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "qwen3_0_6b",
                                  "recurrentgemma_2b"])
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_block_bytes_at_16x16_equal_sharding(arch, mode):
    cfg = get_config(arch)
    mesh = make_meta_mesh((16, 16), ("data", "model"))
    shape = SHAPES["train_4k" if mode == "train" else "decode_32k"]
    pair = dryrun.setup_pair(cfg, shape, "meta", mesh)
    got = dryrun.tree_nbytes(pair.arguments["params"])
    assert got == sharding.block_bytes(
        cfg.replace(weight_quant="none") if mode == "train" else cfg, mesh,
        mode)
    if mode == "train":       # both fp32 AdamW moments of the blocks
        assert dryrun.tree_nbytes(pair.arguments["opt"]) == 8 * sum(
            t.numel() for t in dryrun.tree_tensors(
                pair.arguments["params"])) + 4


def _hlo_flops(fn, *args) -> float:
    return hlo.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _port_flops(fn, *args) -> float:
    with torch.no_grad():
        return opcount.analyze(opcount.capture(fn, *args).records).flops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_flops_equal_hlo(dtype):
    x, w = np.ones((32, 64), np.float32), np.ones((64, 48), np.float32)
    want = _hlo_flops(lambda a, b: a @ b, jnp.asarray(x, dtype),
                      jnp.asarray(w, dtype))
    got = _port_flops(lambda a, b: a @ b,
                      torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got == want == 2 * 32 * 64 * 48


def test_scan_flops_equal_hlo():
    """An L-step scan of h @ W: hlo.analyze multiplies the loop body by
    its trip count; the port's loop is unrolled in the op stream."""
    n_steps = 7

    def jax_fn(h, w):
        return jax.lax.scan(lambda c, _: (c @ w, None), h, None,
                            length=n_steps)[0]

    def port_fn(h, w):
        for _ in range(n_steps):
            h = h @ w
        return h

    h, w = np.ones((8, 32), np.float32), np.ones((32, 32), np.float32)
    want = _hlo_flops(jax_fn, jnp.asarray(h), jnp.asarray(w))
    got = _port_flops(port_fn, torch.from_numpy(h), torch.from_numpy(w))
    assert got == want == n_steps * 2 * 8 * 32 * 32


def test_reduced_dense_forward_flops_near_hlo():
    from repro_torch import bridge
    from torch_archs import reduced_pair
    jcfg, cfg = reduced_pair("qwen3_0_6b")
    ref = jax_build_model(jcfg)
    jparams = ref.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 500, (2, 64)).astype(
        np.int32)
    want = _hlo_flops(lambda p, t: ref.forward(p, {"tokens": t})[0],
                      jparams, jnp.asarray(tokens))
    model = build_model(cfg, "cpu")
    params = bridge.from_jax_params(jparams, cfg, "cpu")
    got = _port_flops(lambda: model.forward(
        params, {"tokens": torch.from_numpy(tokens)}))
    assert abs(got - want) <= FORWARD_FLOPS_RTOL * want, (got, want)


def test_kernel_wrappers_book_their_cost_on_meta():
    """On meta tensors each wrapper returns its kernel's output shape,
    books the kernel's FLOPs and bytes (``kernels/cost.py``), and
    launches and counts nothing; the plain version does not run."""
    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,
                                                     device="meta")
    e, c, d, f = 4, 16, 256, 512
    x, wg, wu, wd = meta(e, c, d), meta(e, d, f), meta(e, d, f), meta(e, f, d)
    qs = [quant.QuantTensor(meta(*w.shape, dt=torch.int8),
                            meta(w.shape[0], w.shape[1] // 128, w.shape[2],
                                 dt=torch.float32), 8, 128, w.shape[1],
                            "bfloat16") for w in (wg, wu, wd)]
    q = meta(2, 4, 8, 64)
    pool = meta(9, 5, 2, 64)
    bt = meta(2, 7, dt=torch.int32)
    vec = meta(2, dt=torch.int32)
    fq, fk = meta(2, 300, 8, 64), meta(2, 300, 2, 64)
    ops.reset_launch_counts()
    calls = {
        "moe_ffn": (lambda: ops.moe_ffn(x, wg, wu, wd), (e, c, d),
                    cost.moe_ffn(e, c, d, f, 2)),
        "moe_ffn_quant": (lambda: ops.moe_ffn(x, *qs), (e, c, d),
                          cost.moe_ffn_quant(e, c, d, f, 2, sum(
                              w.nbytes() for w in qs))),
        "paged_attention": (lambda: ops.paged_attention(
            q, pool, pool, bt, vec, vec, window=16), (2, 4, 8, 64),
            cost.paged_reach((2, 4, 8, 64), 2, 128, 2, 35, 16)),
        "flash_attention": (lambda: ops.flash_attention(fq, fk, fk),
                            (2, 300, 8, 64),
                            cost.flash(2, 300, 8, 2, 64, 2, True, None)),
    }
    for name, (fn, shape, (nbytes, flops)) in calls.items():
        cap = opcount.capture(fn)
        assert cap.result.is_meta and tuple(cap.result.shape) == shape
        rec = [r for r in cap.records if r.name == f"kernel.{name}"]
        assert len(rec) == 1, (name, [r.name for r in cap.records])
        assert rec[0].flops == flops > 0
        assert rec[0].in_bytes + rec[0].out_bytes == nbytes
        # the output's allocation and the booking, nothing of the plain
        assert [r.name for r in cap.records] == ["empty_like",
                                                 f"kernel.{name}"]
    assert not any(ops.launch_counts().values())


def test_meta_collectives_count_bytes_and_shapes():
    from repro_torch.core import collectives
    mesh = make_meta_mesh((2, 4), ("data", "model"), rank=5)
    assert mesh.coords == {"data": 1, "model": 1}
    x = torch.empty((3, 8), device="meta")
    assert collectives.all_gather(x, mesh, "model", 1).shape == (3, 32)
    assert collectives.psum_scatter(x, mesh, "model", 1).shape == (3, 2)
    assert collectives.psum(x, mesh, "data").shape == (3, 8)
    assert mesh.bytes == {"all-gather": 96, "reduce-scatter": 96,
                          "all-reduce": 96}
    with pytest.raises(ValueError, match="meta mesh takes meta tensors"):
        collectives.psum(torch.zeros(3), mesh, "data")
    # a packed exchange of two dtypes (a layer's bf16 weights beside
    # RG-LRU's fp32 leaves): one exchange a dtype, each result in place
    mesh.reset_counters()
    xs = [torch.empty((2, 3), dtype=torch.bfloat16, device="meta"),
          torch.empty((5,), device="meta"),
          torch.empty((4, 1), dtype=torch.bfloat16, device="meta")]
    got = collectives.all_gather_packed(xs, mesh, "model", [1, 0, 0],
                                        collectives.PARAM_GATHER)
    assert [(tuple(g.shape), g.dtype) for g in got] == [
        ((2, 12), torch.bfloat16), ((20,), torch.float32),
        ((16, 1), torch.bfloat16)]
    assert mesh.bytes == {collectives.PARAM_GATHER: 2 * 10 + 4 * 5}


def test_model_flops_equal_the_reference():
    """Through one subprocess: importing ``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` to 512 host devices in that process only."""
    code = ("import json, sys; from repro.launch import dryrun as d; "
            "from repro.configs.base import SHAPES, get_config; "
            "print(json.dumps({f'{a}/{s}': d.model_flops(get_config(a), "
            "SHAPES[s]) for a in json.loads(sys.argv[1]) for s in SHAPES}))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code, json.dumps(ARCH_IDS)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    got = {f"{a}/{s}": dryrun.model_flops(get_config(a), SHAPES[s])
           for a in ARCH_IDS for s in SHAPES}
    assert got == want


def test_pair_runs_on_meta_and_books_flash():
    """One full-width pair's record: exact argument bytes, a temp peak,
    the kernels the step books; a forward pair launches flash."""
    rec = dryrun.run_pair("qwen3_0_6b", "decode_32k", (1, 1),
                          ("data", "model"))
    assert rec["ok"], rec.get("error")
    cfg = get_config("qwen3_0_6b")
    pair = dryrun.setup_pair(cfg, SHAPES["decode_32k"])
    assert rec["memory"]["argument_bytes"] == dryrun.tree_nbytes(
        pair.arguments)
    assert 0 < rec["memory"]["temp_bytes"] < rec["memory"]["argument_bytes"]
    assert rec["memory"]["peak_per_device"] == (
        rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"])
    fwd = dryrun.run_pair("qwen3_0_6b", "forward", (1, 1), ("data", "model"),
                          shape=ShapeSpec("forward", "forward", 1024, 2))
    assert fwd["ok"], fwd.get("error")
    assert fwd["ops"]["kernels"] == ["flash_attention"]


def test_cli_all_writes_every_pair(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--reduced", "--out", str(tmp_path)], capture_output=True,
        text=True, env=env, cwd=REPO, timeout=120)
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == len(ARCH_IDS) * len(SHAPES) == 44, r.stdout[-2000:]
    assert {(x["arch"], x["shape"]) for x in recs} == {
        (a, s) for a in ARCH_IDS for s in SHAPES}
    for x in recs:
        assert x["mesh"] == "16x16"
        assert x["ok"], x["error"]
    assert r.returncode == 0


# rank 0's cache at (16, 16) for the two MoE archs at decode_32k (the
# reference's per-device bytes; before the rows were cut over "data",
# 25,769,803,776 and 17,179,869,184)
CACHE_AT_16X16 = {("qwen3_moe_30b_a3b", "decode_32k"): 1_610_612_736,
                  ("granite_moe_3b_a800m", "decode_32k"): 1_073_741_824}


@pytest.mark.parametrize("shape_name", ["decode_32k", "prefill_32k",
                                        "long_500k"])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b",
                                  "granite_moe_3b_a800m"])
def test_serving_cache_at_16x16_is_the_reference_per_device_block(
        arch, shape_name):
    """Rank 0's prefill and decode caches at (16, 16) hold the bytes the
    reference's ``cache_pspec`` gives each device on an ``AbstractMesh``:
    the batch over "data" where 16 divides it (B = 128 and 32; long_500k's
    B = 1 whole on every rank), the sequence over "model" (the reference's
    default ``kv_cache_shard="seq"``, which the port's context-parallel
    cache takes: each leaf is checked to be cut along the same
    dimensions before its bytes are compared)."""
    from jax.sharding import AbstractMesh

    from repro.launch import sharding as jax_sharding
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    ref_cache = jax_build_model(jax_get_config(arch)).cache_specs(b, s)
    spec = jax_sharding.cache_pspec(jax_get_config(arch), AbstractMesh(
        (16, 16), ("data", "model")), ref_cache)
    mesh = make_meta_mesh((16, 16), ("data", "model"))
    cache = dryrun.setup_pair(get_config(arch), shape, "meta",
                              mesh).arguments["cache"]
    assert sorted(cache) == sorted(ref_cache)
    got_bytes = want_bytes = 0
    for k, leaf in ref_cache.items():
        per = tuple(n // (16 if ax else 1) for n, ax in zip(
            leaf.shape, tuple(spec[k]) + (None,) * leaf.ndim))
        assert tuple(cache[k].shape) == per, (k, cache[k].shape, per)
        got_bytes += cache[k].numel() * cache[k].element_size()
        want_bytes += math.prod(per) * np.dtype(leaf.dtype).itemsize
    assert got_bytes == want_bytes
    if (arch, shape_name) in CACHE_AT_16X16:
        assert got_bytes == CACHE_AT_16X16[arch, shape_name]


SCHEDULES = ("decentralized", "centralized", "a2a", "a2a_pipelined")


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_reduced_moe_serve_pair_at_16x16_moves_the_predicted_bytes(
        schedule, shape_name):
    """The reduced qwen3-moe (its experts widened to the 16 "model"
    ranks) runs its serve step on meta at the production mesh under each
    expert schedule, and its collective bytes by kind are R2's prediction
    (``predicted_collective_bytes(..., n_batch_shards=16,
    include_tp=True)``: rank 0 runs its one row of the 16), the kinds R2
    books apart aside.  Decode adds context-parallel decode's merge (the
    kv heads do not cover 16 ranks, so the cache is sharded by sequence):
    per layer and rank row a pmax and a psum of (Hq,) statistics and a
    psum of the (Hq, hd) partial output."""
    from types import SimpleNamespace

    from repro_torch.analysis.collectives import BOOKED_APART, predicted
    from repro_torch.models.model import HEAD
    arch, mesh = "qwen3_moe_30b_a3b", (16, 16)
    rec = dryrun.run_pair(arch, shape_name, mesh, ("data", "model"),
                          cfg_overrides={"expert_parallel": schedule},
                          reduced=True)
    assert rec["ok"], rec.get("error")
    cfg, shape = dryrun.reduced_pair(
        get_config(arch).replace(expert_parallel=schedule),
        SHAPES[shape_name], mesh)
    assert cfg.num_experts == cfg.num_experts_padded == 16
    decode = shape.kind == "decode"
    want = predicted(SimpleNamespace(
        cfg=cfg, batch=shape.global_batch, seq=1 if decode else
        shape.seq_len, n_exp_shards=16, n_batch_shards=16))
    if decode:
        want["all-reduce"] += (shape.global_batch // 16 * cfg.num_layers
                               * cfg.num_heads * (2 + cfg.head_dim) * 4)
    got = rec["ops"]["collective_by_kind"]
    assert {k: v for k, v in got.items() if k not in BOOKED_APART} == want
    assert got[HEAD] > 0


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_reduced_moe_train_pair_at_16x16_runs_its_schedule(schedule):
    """The reduced qwen3-moe's train step on meta at the production
    mesh: the packed parameter gathers and gradient reductions, and the
    schedule's own collective (the all-to-all of the a2a schedules, the
    centralized schedule's reduce-scatter, the decentralized psum)."""
    rec = dryrun.run_pair("qwen3_moe_30b_a3b", "train_4k", (16, 16),
                          ("data", "model"),
                          cfg_overrides={"expert_parallel": schedule},
                          reduced=True)
    assert rec["ok"], rec.get("error")
    got = rec["ops"]["collective_by_kind"]
    own = {"decentralized": "all-reduce", "centralized": "reduce-scatter",
           "a2a": "all-to-all", "a2a_pipelined": "all-to-all"}[schedule]
    assert got["param-gather"] > 0 and got["grad-reduce"] > 0
    assert got[own] > 0
    assert rec["memory"]["alias_bytes"] > 0
