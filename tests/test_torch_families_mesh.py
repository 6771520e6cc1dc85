"""Port vs JAX: four more families on a mesh (recurrentgemma-2b's
hybrid, mamba2-130m's ssm, qwen2-vl-7b's vlm, musicgen-large's audio;
reduced, fp32, CPU) on meshes of (2, 2) and (1, 4) gloo ranks.

The JAX side (``torch_families_mesh_oracle.py``) runs one subprocess per
arch, at once, on an ``Auto``-axis (2, 2) mesh of four host devices under
``jax.set_mesh``: the reference's forward, ``value_and_grad`` of its loss
and one jitted ``make_train_step`` step, then its one-device serve (vlm
and audio: prefill and four decode steps; hybrid and ssm: the
two-program engine).  None of these families routes experts, so the
reference's values do not depend on the mesh shape, and both of the
port's meshes are held to the one oracle.  The port side runs as four
spawned gloo rank processes per mesh (``torch_families_mesh_cases``),
meeting through a ``FileStore`` in the test's tmp dir, on seeded weights
that both sides read from one npz; each rank bridges the weights in the
layout of each case (``bridge.from_jax_params(..., mesh=)``: whole for
the forward, ``mode="train"`` for the loss and the step, ``mode="serve"``
for the serves).

Checked, per mesh and arch: the forward's logits of each rank's rows at
2e-5 (fp32; vlm's patches, text and M-RoPE positions and audio's frames
cut to the rank's rows); the loss at 2e-5 on every rank (vlm's masked
mean over the global batch) and every gradient leaf, gathered whole, at
2e-4 of its largest; one train step's metrics at 1e-4 and its params
under the train tests' gate (every element within lr, at most one element
in a thousand of a leaf beyond 1e-6, at least one on a leaf of fewer);
``train(mesh=)``'s losses at 1e-4 of the one-device ``train()``'s (vlm
refused as on one device); ``shard_batch`` giving every rank
``batch_pspec``'s rows of every input;
vlm's and audio's prefill and decode-step logits at 2e-5 on every rank
(the decode context-parallel, M-RoPE positions through it); the hybrid's
and ssm's greedy engine streams equal to the JAX one-device engine's on
every rank, a reused slot included (C6), with the hybrid's recurrent
states of the rank's RG-LRU channels and its attention ring
sequence-sharded, and each rank's weight bytes its serve blocks'."""
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_families_mesh_cases as cases
from repro_torch import bridge
from repro_torch.launch import sharding
from test_torch_expert_parallel import SPAWN_TIMEOUT_S, _collect, _FakeMesh
from torch_archs import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
GRAD_TOL = 2e-4
METRIC_TOL = 1e-4
LR = cases.STEP_OPT["lr"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"oracle": {arch: the JAX results}, mesh name: [each rank's
    results]}: the four oracle processes and both meshes' ranks at
    once."""
    tmp = tmp_path_factory.mktemp("families_mesh")
    flat = {}
    for a in cases.ARCHS:
        flat.update(cases.flatten(cases.family_params(bridge.param_shapes(
            cases.port_config(a))), a + "/"))
    params_path = str(tmp / "params.npz")
    np.savez(params_path, **flat)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    oracles = {a: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_families_mesh_oracle.py"),
         params_path, str(tmp / f"oracle_{a}.npz"), a], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in cases.ARCHS}
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
        for oracle in oracles.values():
            log, _ = oracle.communicate(timeout=SPAWN_TIMEOUT_S)
            assert oracle.returncode == 0, log[-4000:]
    finally:
        for oracle in oracles.values():
            if oracle.poll() is None:
                oracle.kill()
                oracle.wait()
    out["oracle"] = {a: dict(np.load(tmp / f"oracle_{a}.npz"))
                     for a in cases.ARCHS}
    return out


def _mesh(name: str, rank: int) -> _FakeMesh:
    n_data, n_model = cases.MESHES[name]
    return _FakeMesh((n_data, n_model), data=rank // n_model,
                     model=rank % n_model)


def _rel(got: float, want: float, tol: float) -> bool:
    return abs(got - want) <= tol * (1 + abs(want))


CASES = [(m, a) for m in cases.MESHES for a in cases.ARCHS]
IDS = [f"{m}-{a}" for m, a in CASES]


@pytest.mark.parametrize("mesh_name,arch", CASES, ids=IDS)
def test_forward_matches_jax(runs, mesh_name, arch):
    """Each rank's logits are JAX's forward at its rows (2e-5), every
    batch input cut to those rows."""
    want = runs["oracle"][arch]["forward"]
    for r, rec in enumerate(runs[mesh_name]):
        got = rec[f"{arch}/forward"]
        lo, hi = got["rows"]
        assert hi - lo == cases.B // cases.MESHES[mesh_name][0], (r, lo, hi)
        np.testing.assert_allclose(got["logits"], want[lo:hi], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mesh_name,arch", CASES, ids=IDS)
def test_loss_and_grads_match_jax(runs, mesh_name, arch):
    """The global loss and CE on every rank at 2e-5 of JAX's (vlm: the
    masked mean, its CE sum and mask count each summed over "data"), and
    every gradient leaf, gathered whole from the train blocks, at 2e-4 of
    its own largest (audio's embedding, which the loss does not read,
    zero on both sides)."""
    ref = runs["oracle"][arch]
    for rec in (r[f"{arch}/grad"] for r in runs[mesh_name]):
        assert _rel(rec["loss"], float(ref["grad/loss"]), TOL), rec["loss"]
        assert _rel(rec["ce"], float(ref["grad/ce"]), TOL), rec["ce"]
    grads = runs[mesh_name][0][f"{arch}/grad"]["grads"]
    want = {k[len("grad/grads/"):]: v for k, v in ref.items()
            if k.startswith("grad/grads/")}
    assert set(grads) == set(want)
    for k, w in want.items():
        err = float(np.abs(grads[k] - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-6), (k, err)


# the one leaf held by the first half of the step gate alone: the key
# bias's gradient is a near-cancellation.  A bias shared by every key
# shifts each query's logits by one constant, which the softmax ignores,
# so its gradient is exactly zero without a rotation; M-RoPE rotates the
# keys apart, but at these 16-position spreads under rope_theta 1e6 most
# frequency pairs barely turn, and half of bk's gradient elements are
# below 1e-5 (its largest 1.7e-2), where two right fp32 sums differ by
# their rounding and Adam's first step (lr * g / (|g| + 1e-8)) magnifies
# that.  Its gradient is held with every other leaf's (2e-4 of its
# largest), and its step within lr.
STEP_CANCELLING = {cases.VLM: ("blocks/attn/bk",)}


@pytest.mark.parametrize("mesh_name,arch", CASES, ids=IDS)
def test_train_step_matches_jax(runs, mesh_name, arch):
    """One ``make_train_step`` step from the train blocks: the metrics at
    1e-4 of JAX's jitted step on every rank, and the params gathered
    whole under the train tests' gate (every element within lr; at most
    one in a thousand of a leaf beyond 1e-6, at least one on a leaf of
    fewer; ``STEP_CANCELLING``'s leaf by the first half)."""
    ref = runs["oracle"][arch]
    for rec in (r[f"{arch}/step"] for r in runs[mesh_name]):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert _rel(rec["metrics"][k], float(ref[f"step/{k}"]),
                        METRIC_TOL), (k, rec["metrics"][k])
    got = runs[mesh_name][0][f"{arch}/step"]["params"]
    want = {k[len("step/params/"):]: v for k, v in ref.items()
            if k.startswith("step/params/")}
    assert set(got) == set(want)
    off = {}
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert err.max() <= LR, (k, float(err.max()))
        n_off = int((err > 1e-6).sum())
        if (n_off > max(1, err.size // 1000)
                and k not in STEP_CANCELLING.get(arch, ())):
            off[k] = (n_off, err.size, float(err.max()))
    assert not off, off


@pytest.mark.parametrize("mesh_name,arch", CASES, ids=IDS)
def test_train_on_a_mesh_matches_one_device(runs, mesh_name, arch):
    """``train(mesh=)`` from the seed's weights on ``Pipeline`` batches:
    each logged loss at 1e-4 of the one-device ``train()``'s on every
    rank (audio's second step takes its frames from the table the first
    step updated, gathered whole from the train blocks); vlm is refused
    on a mesh as on one device (its batches carry no patches)."""
    want = cases.train_losses(cases.port_config(arch))
    for r, rec in enumerate(runs[mesh_name]):
        got = rec[f"{arch}/train"]
        if isinstance(want, str):
            assert got == want and "patch_embeds" in got, (r, got)
            continue
        assert len(got) == len(want) == cases.TRAIN["steps"], (r, got)
        for g, w in zip(got, want):
            assert _rel(g, w, METRIC_TOL), (r, got, want)


@pytest.mark.parametrize("mesh_name,arch", CASES, ids=IDS)
def test_shard_batch_cuts_every_input(runs, mesh_name, arch):
    """``pipeline.shard_batch`` gives each rank ``batch_pspec``'s rows of
    every input: tokens, labels, vlm's patches and M-RoPE positions (B, S,
    3), audio's frames."""
    assert all(r[f"{arch}/shard_batch_ok"] for r in runs[mesh_name])


@pytest.mark.parametrize("mesh_name,arch",
                         [(m, a) for m in cases.MESHES
                          for a in (cases.VLM, cases.AUDIO)],
                         ids=[f"{m}-{a}" for m in cases.MESHES
                              for a in (cases.VLM, cases.AUDIO)])
def test_prefill_and_decode_match_jax(runs, mesh_name, arch):
    """vlm and audio on the serving mesh: the prefill's and four decode
    steps' logits, each rank's rows (the rows cut over "data": one a
    rank on (2, 2)), at 2e-5 of the same rows of JAX's; the decode is
    context-parallel (each rank's cache its rows' sequence block of every
    kv head), vlm's M-RoPE positions through it."""
    want = runs["oracle"][arch]["serve"]
    n_data, n_model = cases.MESHES[mesh_name]
    bl = cases.SERVE_B // n_data
    cfg = cases.port_config(arch)
    for r, rec in enumerate(rr[f"{arch}/serve"] for rr in runs[mesh_name]):
        assert rec["context_parallel"]
        assert rec["cache_shape"] == (
            cfg.num_layers, bl, cases.SERVE_CACHE // n_model,
            cfg.num_kv_heads, cfg.head_dim)
        rows = slice(r // n_model * bl, (r // n_model + 1) * bl)
        np.testing.assert_allclose(rec["logits"], want[:, rows], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("mesh_name,arch",
                         [(m, a) for m in cases.MESHES
                          for a in cases.STATEFUL],
                         ids=[f"{m}-{a}" for m in cases.MESHES
                              for a in cases.STATEFUL])
def test_engine_streams_equal_the_jax_engine(runs, mesh_name, arch):
    """hybrid and ssm through ``ServingEngine(paged=False, mesh=)``: every
    rank's greedy streams equal the JAX one-device engine's, the third
    request in a reused slot (C6); each rank's weight bytes are its serve
    blocks'; each rank's caches hold its data block's rows (one of the two
    on (2, 2)): the hybrid's recurrent states its W / n RG-LRU channels
    and its 64-slot attention ring its sequence block (context-parallel
    decode) of the one kv head, the ssm states whole."""
    ref = runs["oracle"][arch]
    want = [ref[f"serve/{i}"].tolist() for i in range(len(cases.NEW_TOKENS))]
    cfg = cases.port_config(arch)
    n_data, n_model = cases.MESHES[mesh_name]
    b = cases.ENGINE["max_batch"] // n_data
    for r, run in enumerate(runs[mesh_name]):
        rec = run[f"{arch}/serve"]
        assert rec["streams"] == want, (r, rec["streams"], want)
        assert rec["weight_bytes"] == sharding.block_bytes(
            cfg, _mesh(mesh_name, r))
        shapes = rec["cache_shapes"]
        if arch == cases.HYBRID:
            w = cfg.lru_width // n_model
            assert shapes["rec"]["h"] == (2, b, w)
            assert shapes["rec"]["conv"] == (2, b, cfg.conv1d_width - 1, w)
            assert shapes["attn"]["k"] == (1, b, cfg.sliding_window // n_model,
                                           cfg.num_kv_heads, cfg.head_dim)
        else:
            assert shapes["ssm"][:2] == (cfg.num_layers, b)
