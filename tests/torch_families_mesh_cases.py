"""The cases of ``tests/test_torch_families_mesh.py``, shared by its JAX
oracle (``torch_families_mesh_oracle.py``, subprocesses with four host
devices) and its port side (gloo rank processes spawned by the test).
numpy only at import: rank processes import this module and must not
load JAX.

The weights are seeded numpy parameters (``family_params``) that the test
writes to an npz first; both sides read them, and every batch is drawn
here from a numpy seed."""
import numpy as np

from torch_train_cases import flatten, unflatten  # noqa: F401  (re-exported)

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}    # (n_data, n_model)
HYBRID, SSM = "recurrentgemma_2b", "mamba2_130m"
VLM, AUDIO = "qwen2_vl_7b", "musicgen_large"
ARCHS = (HYBRID, SSM, VLM, AUDIO)
STATEFUL = (HYBRID, SSM)
# the full-sequence forward, loss and train step: B rows (split over
# "data") of S positions; the hybrid's past its 64-token window
B = 4
SEQ = {HYBRID: 80, SSM: 16, VLM: 16, AUDIO: 16}
# one make_train_step step at the mesh train tests' settings
STEP_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
# vlm and audio: prefill of SERVE_B rows of SEQ positions, then
# DECODE_STEPS seeded tokens; the cache holds SERVE_CACHE positions (a
# multiple of 4: context-parallel decode on both meshes)
SERVE_B, DECODE_STEPS, SERVE_CACHE = 2, 4, 24
# hybrid and ssm: the two-program engine, three requests over two slots
# (the third reuses a slot: C6), prompts rolled into the hybrid's 64-slot
# attention ring (72 > 64) and its decode wrapping it; 64 % 4 == 0, so
# the ring decodes context-parallel on both meshes
ENGINE = dict(max_batch=2, prefill_len=72, max_cache=96)
NEW_TOKENS = (5, 3, 4)


def family_params(shapes: dict, seed: int = 0) -> dict:
    """Seeded fp32 parameters of a reduced model, from the port's
    ``bridge.param_shapes`` tree: N(0, 1/fan_in) matrices (embedding 0.02),
    unit norms, small random biases, and the recurrent leaves in the
    ranges their inits draw (RG-LRU's Lambda so that sigmoid(Lambda)^8
    lies in (0.9, 0.999); Mamba-2's A_log, D and dt_bias)."""
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        name = path[-1]
        if name in ("ln", "ln1", "ln2", "final_norm", "q_norm", "k_norm",
                    "scale", "norm"):
            return np.ones(shape, np.float32)
        if name in ("bias", "bq", "bk", "bv", "conv_b", "bias_a", "bias_x",
                    "dt_bias"):
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        if name == "Lambda":
            u = rng.uniform(0.9, 0.999, shape)
            return np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
        if name == "A_log":
            return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
        if name == "D":
            return (1.0 + rng.standard_normal(shape) * 0.1).astype(np.float32)
        std = 0.02 if name == "embed" else 1 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), v) for k, v in tree.items()}
    return walk(shapes, ())


def _mrope(p: int, text: int, rows: int) -> np.ndarray:
    """(rows, p + text, 3): a p // 2 x 2 patch grid at t = 0, then the
    text at max + 1 on all three components."""
    i = np.arange(p)
    patches = np.stack([0 * i, i // 2, i % 2], -1)
    t = patches.max() + 1 + np.arange(text)
    pos = np.concatenate([patches, np.repeat(t[:, None], 3, 1)])
    return np.broadcast_to(pos, (rows, p + text, 3)).astype(np.int32).copy()


def inputs(arch: str, cfg, rows: int, seed: int) -> dict:
    """A seeded batch of the family's inputs over SEQ[arch] positions,
    without labels: tokens; vlm's patches, text and M-RoPE positions;
    audio's frame embeddings."""
    rng = np.random.default_rng(seed)
    s, d, v = SEQ[arch], cfg.d_model, cfg.vocab_size
    if arch == AUDIO:
        return {"frame_embeds": rng.standard_normal((rows, s, d)).astype(
            np.float32)}
    if arch == VLM:
        p = cfg.num_patch_tokens
        return {"tokens": rng.integers(0, v, (rows, s - p)).astype(np.int32),
                "patch_embeds": rng.standard_normal((rows, p, d)).astype(
                    np.float32),
                "mrope_positions": _mrope(p, s - p, rows)}
    return {"tokens": rng.integers(0, v, (rows, s)).astype(np.int32)}


def batch(arch: str, cfg) -> dict:
    """The forward, loss and train step's global batch, with labels."""
    out = inputs(arch, cfg, B, 10 + ARCHS.index(arch))
    out["labels"] = np.random.default_rng(20 + ARCHS.index(arch)).integers(
        0, cfg.vocab_size, (B, SEQ[arch])).astype(np.int32)
    return out


def decode_steps(arch: str, cfg) -> list:
    """The decode steps after the prefill: seeded tokens at lengths SEQ +
    i (vlm: M-RoPE positions continuing the text's at (p, p, p))."""
    rng = np.random.default_rng(30 + ARCHS.index(arch))
    s = SEQ[arch]
    nxt = (int(_mrope(cfg.num_patch_tokens, s - cfg.num_patch_tokens,
                      1)[0, -1, 0]) + 1 if arch == VLM else 0)
    out = []
    for i in range(DECODE_STEPS):
        step = {"tokens": rng.integers(0, cfg.vocab_size,
                                       (SERVE_B, 1)).astype(np.int32),
                "lengths": np.full((SERVE_B,), s + i, np.int32)}
        if arch == VLM:
            step["mrope_positions"] = np.full((SERVE_B, 1, 3), nxt + i,
                                              np.int32)
        out.append(step)
    return out


def traffic(cfg) -> list:
    """(prompt, max_new_tokens) of the engine serves: 72, 40 and 70
    tokens."""
    rng = np.random.default_rng(41)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in zip((72, 40, 70), NEW_TOKENS)]


# ---------------------------------------------------------------------------
# the port's side: one rank process of a mesh
# ---------------------------------------------------------------------------

def port_config(arch: str):
    from repro_torch.configs.base import get_config
    return get_config(arch).reduced()


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
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=90))
    mesh = mesh_lib.make_test_mesh(*shape)
    flat = np.load(params_path)
    out = {}
    for arch in ARCHS:
        tree = unflatten(flat, arch + "/")
        out.update({f"{arch}/{k}": v for k, v in
                    _arch_cases(arch, tree, mesh, rank).items()})
    torch.distributed.destroy_process_group()
    return out


def _arch_cases(arch: str, tree: dict, mesh, rank: int) -> dict:
    import torch
    from repro_torch import bridge, optim
    from repro_torch.core import expert_parallel
    from repro_torch.data import pipeline
    from repro_torch.launch import sharding
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import build_model
    t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    cfg = port_config(arch)
    model = build_model(cfg, "cpu")
    gb = batch(arch, cfg)
    out = {}
    # the full-sequence forward: whole weights, this rank's rows
    params = bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh)
    with torch.no_grad():
        logits, _ = model.forward(params, t(gb), mesh)
    rows = expert_parallel.batch_shard(mesh, B)[1]
    out["forward"] = {"logits": logits.numpy(),
                      "rows": (rows.start, rows.stop)}
    # shard_batch's rows of every input are batch_pspec's blocks
    got = pipeline.shard_batch(gb, mesh)
    bspec = sharding.batch_pspec(cfg, mesh, gb)
    out["shard_batch_ok"] = all(np.array_equal(
        got[k], gb[k][sharding.block_slices(gb[k].shape, bspec[k], mesh)])
        and got[k].shape[0] == B // mesh.shape["data"] for k in gb)
    # the loss and its gradients in the train layout, gathered whole
    spec = sharding.train_specs(cfg, mesh)
    params = bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh,
                                    mode="train")
    leaves = list(optim.adamw.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    total, m = model.loss(params, t(gb), kernels=False, mesh=mesh)
    total.backward()
    grads = optim.adamw.tree_map(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        params)
    rec = {"loss": float(total.detach()), "ce": float(m["ce"].detach())}
    whole = sharding.unshard_tree(grads, spec, mesh)
    if rank == 0:
        rec["grads"] = flatten(whole)
    out["grad"] = rec
    # one train step from the same blocks
    params = bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh,
                                    mode="train")
    state = optim.init(params)
    step = train_mod.make_train_step(model, optim.OptimizerConfig(
        **STEP_OPT), mesh)
    params, state, m = step(params, state, t(gb))
    rec = {"metrics": {k: float(v) for k, v in m.items()}}
    whole = sharding.unshard_tree(params, spec, mesh)
    if rank == 0:
        rec["params"] = flatten(whole)
    out["step"] = rec
    out["train"] = train_losses(cfg, mesh)
    out["serve"] = (_serve_engine(arch, cfg, tree, mesh) if arch in STATEFUL
                    else _serve_steps(arch, cfg, model, tree, mesh))
    return out


# ``train()`` on a mesh: two steps of Pipeline batches (the audio family's
# second step takes its frames from the table the first step updated)
TRAIN = dict(steps=2, global_batch=B, seq_len=16, lr=1e-3, log_every=1,
             seed=3)


def train_losses(cfg, mesh=None) -> list:
    """The logged losses of ``train()`` on the CPU, or the refusal's text
    (vlm: the reference's launcher fails there too)."""
    import contextlib
    import io

    from repro_torch.launch.train import train
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, hist = train(cfg, mesh=mesh, device="cpu", **TRAIN)
    except ValueError as e:
        return str(e)
    return [h["loss"] for h in hist]


def _serve_steps(arch, cfg, model, tree, mesh) -> dict:
    """vlm and audio on the serving mesh: prefill, then the decode steps,
    each step's logits (every rank's whole)."""
    import torch
    from repro_torch import bridge
    from repro_torch.models.attention import use_cp_decode
    from repro_torch.models.transformer import attn_cache_len
    t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    params = bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh,
                                    mode="serve")
    cp = use_cp_decode(cfg, mesh, attn_cache_len(cfg, SERVE_CACHE))
    cache = model.init_cache(SERVE_B, SERVE_CACHE, mesh, seq_sharded=cp)
    logits = []
    with torch.no_grad():
        logits.append(model.prefill(params, t(inputs(arch, cfg, SERVE_B, 3)),
                                    cache, SERVE_CACHE, mesh=mesh).numpy())
        for st in decode_steps(arch, cfg):
            logits.append(model.decode_step(params, cache, t(st),
                                            SERVE_CACHE, mesh=mesh).numpy())
    return {"logits": np.stack(logits), "context_parallel": cp,
            "cache_shape": tuple(cache["k"].shape)}


def _serve_engine(arch, cfg, tree, mesh) -> dict:
    """hybrid and ssm on the serving mesh: the two-program engine's greedy
    streams, and its recurrent cache's shapes."""
    from repro_torch import bridge
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    params = bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh,
                                    mode="serve")
    eng = ServingEngine(cfg, EngineConfig(paged=False, track_experts=False,
                                          **ENGINE),
                        params=params, device="cpu", mesh=mesh)
    uids = [eng.submit(p, max_new_tokens=n) for p, n in traffic(cfg)]
    eng.run_until_done()
    cache = {k: {kk: tuple(v.shape) for kk, v in c.items()}
             for k, c in eng.cache.items()} if arch == HYBRID else {
        k: tuple(v.shape) for k, v in eng.cache.items()}
    return {"streams": [[int(x) for x in eng._all[u].generated]
                        for u in uids],
            "cache_shapes": cache,
            "weight_bytes": eng.memory_stats()["weight_bytes"]}
