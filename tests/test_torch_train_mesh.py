"""Port vs JAX for training on a mesh: the loss, its gradients and the
AdamW step on a (2, 2) mesh of ranks in the "train" layout (FSDP over
"data", the experts' rows over "model"), fp32 on the reduced configs, CPU.

The JAX side (``torch_train_oracle.py``) runs the reference's
``jax.value_and_grad(model.loss)(params, batch, mesh)`` and its jitted
``make_train_step(model, ocfg, mesh)`` on an ``Auto``-axis (2, 2) mesh
of four host devices under ``jax.set_mesh``, in four subprocesses at
once; its part 0 writes the JAX-initialised parameters that both sides
start from.  The port side runs as four spawned gloo rank processes
(``torch_train_cases``) meeting through a ``FileStore`` in the test's
tmp dir; each rank holds its train blocks
(``bridge.from_jax_params(..., mode="train")``) and hands back the
gradients and params gathered whole.

Cases: the four schedules, expert replication 2 and the default capacity
factor 1.25 under a2a on the reduced qwen3-moe (capacity factor 8
otherwise), the dense qwen3-0.6b (FSDP alone) and granite with router-dead
experts and a padded vocab.  Tolerances (fp32): the loss and CE to 2e-5
relative, the aux to 1e-6 of JAX's MESH aux (each MoE layer's mean of
per-shard aux, not the one-device aux), every gradient leaf to 2e-4 of its
own largest magnitude (as ``test_torch_train.py``), dead experts'
gradients exactly zero, the global norm to 1e-5 relative.  Two train
steps at the reference's ``check_sharded_train_step_matches_single``
settings: losses to 2e-5, params within lr elementwise and 99.9 % within
1e-6 (``test_torch_train.py``'s gate)."""
import multiprocessing as mp
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_train_cases as cases
from repro_torch.ckpt import io as ckpt
from torch_archs import DEAD_AND_PADDED

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2e-5
AUX_TOL = 1e-6
GRAD_TOL = 2e-4
NORM_RTOL = 1e-5
ORACLE_PARTS = 4
SPAWN_TIMEOUT_S = 240
LR = cases.STEP_OPT["lr"]


def _collect(procs, q) -> list:
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
    """{"oracle": the JAX results (every part's npz), "ranks": each rank's
    results, "ckpt": the mesh checkpoint's path}.  The ranks start with the
    oracle and wait for the params its part 0 writes."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    params_path = tmp / "params.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    oracles = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_train_oracle.py"),
         str(params_path), str(tmp / f"oracle_{i}.npz"), str(i),
         str(ORACLE_PARTS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(ORACLE_PARTS)]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    world = cases.MESH[0] * cases.MESH[1]
    try:
        procs = [ctx.Process(target=cases.rank_main, args=(
            r, world, str(tmp / "store"), str(params_path),
            str(tmp / "mesh_ckpt.npz"), q)) for r in range(world)]
        for p in procs:
            p.start()
        ranks = _collect(procs, q)
        for proc in oracles:
            log, _ = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            assert proc.returncode == 0, log[-4000:]
    finally:
        for proc in oracles:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    oracle = {}
    for i in range(ORACLE_PARTS):
        oracle.update(np.load(tmp / f"oracle_{i}.npz"))
    return {"oracle": oracle, "ranks": ranks, "ckpt": tmp / "mesh_ckpt.npz",
            "tmp": tmp}


def _close(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * (1 + abs(want))


def test_cases_use_the_archs_dead_and_padded_variant():
    assert cases.DEAD_AND_PADDED == DEAD_AND_PADDED


@pytest.mark.parametrize("name", list(cases.GRAD_CASES))
def test_loss_and_grads_match_jax_mesh(runs, name):
    """Every rank's loss, CE, aux and global norm are the JAX mesh step's;
    the gradient gathered from the rank blocks matches leaf by leaf."""
    want = runs["oracle"]
    key = f"grad/{name}"
    for r, rank in enumerate(runs["ranks"]):
        rec = rank[key]
        for k, tol in (("loss", LOSS_RTOL), ("ce", LOSS_RTOL)):
            assert _close(rec[k], float(want[f"{key}/{k}"]), tol), (r, k)
        assert abs(rec["aux"] - float(want[f"{key}/aux"])) <= AUX_TOL, r
        assert abs(rec["grad_norm"] - float(want[f"{key}/grad_norm"])) <= \
            NORM_RTOL * float(want[f"{key}/grad_norm"]), r
    got = runs["ranks"][0][key]["grads"]
    jgrads = cases.unflatten(want, key + "/grads/")
    assert sorted(got) == sorted(cases.flatten(jgrads))
    for k, w in cases.flatten(jgrads).items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, f"{k}: {err} vs scale {scale}"


def test_dead_experts_get_zero_grads(runs):
    """Granite's router-dead padded experts: exactly zero on both sides."""
    e = DEAD_AND_PADDED["num_experts"]
    jgrads = cases.unflatten(runs["oracle"], "grad/granite/grads/")
    got = runs["ranks"][0]["grad/granite"]["grads"]
    for w in ("w_gate", "w_up", "w_down"):
        for g in (got[f"blocks/experts/{w}"],
                  jgrads["blocks"]["experts"][w]):
            dead = np.asarray(g)[:, e:]
            assert dead.size and not dead.any()


def test_replication_grads_hold_both_copies(runs):
    """r = 2: the gradient tree holds E_pad x 2 expert rows, each copy
    with its own token stripe's gradient (neither copy is zero)."""
    got = runs["ranks"][0]["grad/replication2"]["grads"]
    e = 4
    w = got["blocks/experts/w_gate"]
    assert w.shape[1] == 2 * e
    assert np.abs(w[:, :e]).max() > 0 and np.abs(w[:, e:]).max() > 0


def test_train_steps_match_jax_mesh(runs):
    want = runs["oracle"]
    for r, rank in enumerate(runs["ranks"]):
        rec = rank["steps"]
        assert rec["step"] == cases.STEPS
        for i, m in enumerate(rec["metrics"]):
            for k in ("loss", "ce", "grad_norm", "lr"):
                assert _close(m[k], float(want[f"steps/{i}/{k}"]),
                              LOSS_RTOL), (r, i, k)
            assert abs(m["aux"] - float(want[f"steps/{i}/aux"])) <= \
                AUX_TOL, (r, i)
    got = runs["ranks"][0]["steps"]["params"]
    jparams = cases.flatten(cases.unflatten(want, "steps/params/"))
    assert sorted(got) == sorted(jparams)
    for k, w in jparams.items():
        err = np.abs(got[k] - w)
        assert err.max() <= LR, (k, err.max())
        assert np.mean(err <= 1e-6) >= 0.999, (k, np.mean(err <= 1e-6))


def test_ranks_store_only_their_train_blocks(runs):
    """Params and both moments have exactly the shapes of ``block_slices``
    under the train spec on every rank; the moments are fp32."""
    for rank in runs["ranks"]:
        rec = rank["steps"]
        assert rec["blocks_ok"] == {"params": True, "mu": True, "nu": True}
        assert rec["fp32_moments"]


def test_shard_batch_gives_batch_pspec_rows(runs):
    assert all(rank["steps"]["shard_batch_ok"] for rank in runs["ranks"])


def test_mesh_checkpoint_is_the_one_device_file(runs):
    """The file rank 0 wrote from the gathered blocks holds, entry for
    entry and bit for bit, what the one-device ``save`` writes of the same
    tree; every rank restored its own blocks from it."""
    whole = cases.unflatten(runs["ranks"][0]["steps"]["params"])
    one = runs["tmp"] / "one_device.npz"
    ckpt.save(str(one), _to_torch(whole), step=cases.STEPS)
    with np.load(runs["ckpt"]) as a, np.load(one) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    assert all(rank["steps"]["restore_ok"] for rank in runs["ranks"])


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}
