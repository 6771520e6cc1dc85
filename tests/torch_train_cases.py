"""The cases of ``tests/test_torch_train_mesh.py``, shared by its JAX
oracle (``torch_train_oracle.py``, a subprocess with four host devices)
and its port side (gloo rank processes spawned by the test).  numpy only
at import: rank processes import this module and must not load JAX.

The parameters are JAX-initialised by the test and handed to both sides
as an npz (``unflatten`` of the keys under a params key); every batch is
drawn here from a numpy seed."""
import numpy as np

MESH = (2, 2)                              # (n_data, n_model)
B, S = 8, 16                               # the reference's train check
# torch_archs.DEAD_AND_PADDED (that module imports the JAX package)
DEAD_AND_PADDED = dict(num_experts=6, num_experts_padded=8, vocab_size=500)
# params key -> (arch, config fields that change the parameter tree)
PARAMS = {"qwen": ("qwen3_moe_30b_a3b", {}),
          "qwen_r2": ("qwen3_moe_30b_a3b", dict(expert_replication=2)),
          "dense": ("qwen3_0_6b", {}),
          "granite": ("granite_moe_3b_a800m", DEAD_AND_PADDED)}
CF8 = dict(capacity_factor=8.0)
# one value_and_grad of the loss on the (2, 2) mesh per case:
# name -> (params key, config fields)
GRAD_CASES = {
    "decentralized": ("qwen", dict(CF8, expert_parallel="decentralized")),
    "centralized": ("qwen", dict(CF8, expert_parallel="centralized")),
    "a2a": ("qwen", dict(CF8, expert_parallel="a2a")),
    "a2a_pipelined": ("qwen", dict(CF8, expert_parallel="a2a_pipelined",
                                   ep_microchunks=2)),
    "replication2": ("qwen_r2", dict(CF8, expert_parallel="decentralized")),
    "a2a_cf1.25": ("qwen", dict(expert_parallel="a2a")),
    "dense": ("dense", {}),
    "granite": ("granite", {}),
}
# two make_train_step steps at check_sharded_train_step_matches_single's
# settings (reduced qwen3-moe at capacity factor 8, lr 1e-3, no warmup)
STEP_PARAMS, STEP_FIELDS = "qwen", CF8
STEP_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
STEPS = 2


def config_fields(pkey: str, fields: dict) -> tuple:
    """(arch, every config field over ``reduced()``) of a case."""
    arch, extra = PARAMS[pkey]
    return arch, dict(extra, **fields)


def batch(vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def grad_batch(name: str, vocab: int) -> dict:
    return batch(vocab, 10 + list(GRAD_CASES).index(name))


def step_batches(vocab: int) -> list:
    return [batch(vocab, 100 + i) for i in range(STEPS)]


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays as flat 'a/b/c' keys (an npz's layout)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat, prefix: str = "") -> dict:
    """The keys of ``flat`` under ``prefix`` as a nested dict."""
    out = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(flat[key])
    return out


# ---------------------------------------------------------------------------
# the port's side: one rank process of the mesh
# ---------------------------------------------------------------------------

def rank_main(rank: int, world: int, store: str, params_path: str,
              ckpt_path: str, q) -> None:
    """Every port case on this rank; puts (rank, results) or (rank,
    traceback text) on ``q``."""
    import traceback
    try:
        q.put((rank, _rank_cases(rank, world, store, params_path,
                                 ckpt_path)))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def _port_config(pkey: str, fields: dict):
    from repro_torch.configs.base import get_config
    arch, kw = config_fields(pkey, fields)
    return get_config(arch).reduced().replace(**kw)


def _shapes_are_blocks(tree, spec, whole_shapes, mesh) -> bool:
    """Every leaf of ``tree`` has exactly the shape of its block of the
    whole leaf under ``spec``."""
    from repro_torch.launch import sharding
    for key, leaf in flatten(tree).items():
        sp = spec_at(spec, key)
        sl = sharding.block_slices(whole_shapes[key], sp, mesh)
        want = tuple(len(range(n)[s]) for n, s in zip(whole_shapes[key], sl))
        if tuple(leaf.shape) != want:
            return False
    return True


def spec_at(spec: dict, key: str):
    for p in key.split("/"):
        spec = spec[p]
    return spec


def _wait_for(path: str, timeout: float = 180.0) -> None:
    """Until ``path`` exists (the oracle's part 0 writes the params, then
    renames them into place)."""
    import os
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.2)


def _rank_cases(rank, world, store, params_path, ckpt_path) -> dict:
    import datetime

    import torch
    from repro_torch import bridge, optim
    from repro_torch.ckpt import io as ckpt
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import build_model
    torch.set_num_threads(1)
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=90))
    mesh = mesh_lib.make_test_mesh(*MESH)
    _wait_for(params_path)
    flat = np.load(params_path)
    trees = {k: unflatten(flat, k + "/") for k in PARAMS}
    tensors = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    out = {}
    for name, (pkey, fields) in GRAD_CASES.items():
        cfg = _port_config(pkey, fields)
        params = bridge.from_jax_params(trees[pkey], cfg, "cpu", mesh=mesh,
                                        mode="train")
        leaves = list(optim.adamw.tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        mesh.reset_counters()
        total, m = build_model(cfg, "cpu").loss(
            params, tensors(grad_batch(name, cfg.vocab_size)),
            kernels=False, mesh=mesh)
        total.backward()
        grads = optim.adamw.tree_map(lambda p: p.grad, params)
        spec = sharding.train_specs(cfg, mesh)
        gnorm = optim.adamw.global_norm(grads, mesh, spec)
        rec = {"loss": float(total.detach()), "ce": float(m["ce"].detach()),
               "aux": float(m["aux"].detach()), "grad_norm": float(gnorm),
               "bytes": dict(mesh.bytes)}
        whole = sharding.unshard_tree(grads, spec, mesh)
        if rank == 0:
            rec["grads"] = flatten(whole)
        out[f"grad/{name}"] = rec

    cfg = _port_config(STEP_PARAMS, STEP_FIELDS)
    model = build_model(cfg, "cpu")
    spec = sharding.train_specs(cfg, mesh)
    params = bridge.from_jax_params(trees[STEP_PARAMS], cfg, "cpu",
                                    mesh=mesh, mode="train")
    state = optim.init(params)
    step = train_mod.make_train_step(model, optim.OptimizerConfig(**STEP_OPT),
                                     mesh)
    losses = []
    for b in step_batches(cfg.vocab_size):
        params, state, m = step(params, state, tensors(b))
        losses.append({k: float(v) for k, v in m.items()})
    shapes = {k: v.shape for k, v in flatten(trees[STEP_PARAMS]).items()}
    rec = {"metrics": losses, "step": int(state.step),
           "blocks_ok": {
               "params": _shapes_are_blocks(params, spec, shapes, mesh),
               "mu": _shapes_are_blocks(state.mu, spec, shapes, mesh),
               "nu": _shapes_are_blocks(state.nu, spec, shapes,
                                        mesh)},
           "fp32_moments": all(t.dtype == torch.float32 for t in
                               optim.adamw.tree_leaves(state.mu))}
    whole = sharding.unshard_tree(params, spec, mesh)
    if rank == 0:
        rec["params"] = flatten(whole)
    # shard_batch's rows are batch_pspec's block
    gb = step_batches(cfg.vocab_size)[0]
    got = pipeline.shard_batch(gb, mesh)
    bspec = sharding.batch_pspec(cfg, mesh, gb)
    rec["shard_batch_ok"] = all(np.array_equal(
        got[k], gb[k][sharding.block_slices(gb[k].shape, bspec[k], mesh)])
        for k in gb) and got["tokens"].shape[0] == B // MESH[0]
    # a checkpoint from the mesh: rank 0 writes the whole tree; every rank
    # restores its own blocks
    ckpt.save(ckpt_path, params, step=STEPS, mesh=mesh, spec=spec)
    restored, rstep = ckpt.restore(ckpt_path, "cpu", mesh=mesh, spec=spec)
    rec["restore_ok"] = rstep == STEPS and all(
        torch.equal(a, b) for a, b in zip(optim.adamw.tree_leaves(restored),
                                          optim.adamw.tree_leaves(params)))
    out["steps"] = rec
    torch.distributed.destroy_process_group()
    return out
