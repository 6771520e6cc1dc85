"""Training launcher of the port (the JAX package's ``launch/train.py``):
real optimizer steps on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_moe_3b_a800m \\
        --steps 12 --batch 4 --seq 2048 --lr 1e-3

``--reduced`` trains the smoke-test variant and ``--device cpu`` runs on
the CPU.  Each step is ``Model.loss(..., kernels=False)`` differentiated
by autograd, then AdamW (``optim``): the reference trains with
``use_kernel=False`` and ``use_flash_kernel=False`` (its Pallas kernels
have no backward), so the step reaches no kernel: ``attend`` /
``attend_chunked``, the expert FFN in torch ops, each layer rematerialised
when ``cfg.remat`` is set, the LM head and cross-entropy one checkpointed
chunk at a time.  Where the reference's step is one jitted program with
donated params and optimizer state, the port updates both IN PLACE.

On a mesh (``launch/mesh.py``: one rank process per position, every rank
calling ``train`` with its ``Mesh``) the params and both moments are this
rank's blocks of the "train" layout (``launch/sharding.train_specs``:
FSDP over "data", the experts' rows over "model"), drawn from the same
seed as the one-device weights; every rank reads the same ``Pipeline``
batches and computes its rows; the loss, its gradient norm and the logged
metrics are the global ones, the same on every rank.

The audio family trains on frame embeddings, as the reference's launcher
feeds it: each step's ``frame_embeds`` are the rows ``embed[tokens %
vocab_size]`` of the current table (already updated by the steps before),
taken before the step, detached, in the compute dtype; on a mesh, of the
table gathered whole from the ranks' train blocks, as ``Model.loss``
gathers the leaves outside the layers.  The vlm family
needs ``patch_embeds``, which ``Pipeline`` batches do not carry: ``train``
refuses it (the reference's launcher fails on that key at its first
step); ``make_train_step`` takes a vlm batch with patches and M-RoPE
positions.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import optim
from repro_torch.ckpt import io as ckpt_io
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.launch import sharding
from repro_torch.models.model import build_model


def make_train_step(model, ocfg: optim.OptimizerConfig, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss and its gradients through the path that reaches no kernel, then
    one AdamW update IN PLACE.  The metrics (loss, ce, aux, lr,
    grad_norm) stay 0-d tensors on the device.  On a ``mesh`` params and
    moments are this rank's train blocks and ``batch`` the global batch;
    the metrics are the global ones."""
    spec = sharding.train_specs(model.cfg, mesh) if mesh is not None \
        else None

    def train_step(params, opt_state, batch):
        leaves = list(optim.adamw.tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch, kernels=False, mesh=mesh)
        loss.backward()
        # a leaf the loss does not read (the audio family's embedding
        # table) has no grad: its gradient is zero, as the reference's is
        grads = optim.adamw.tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
        with torch.profiler.record_function("optimizer"):
            params, opt_state, om = optim.update(ocfg, grads, opt_state,
                                                 params, mesh, spec)
        return params, opt_state, {**{k: v.detach() for k, v in
                                      metrics.items()},
                                   **om, "loss": loss.detach()}
    return train_step


def audio_frames(cfg, params: dict, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """The audio frontend stub's frame embeddings: the current embedding
    table's rows of ``tokens % vocab_size``, detached, in the compute
    dtype.  On a ``mesh`` ``params`` are this rank's train blocks, and
    the rows come from the table gathered whole."""
    table = params["embed"].detach()
    if mesh is not None:
        spec = {"embed": sharding.train_specs(cfg, mesh)["embed"]}
        table = sharding.unshard_tree({"embed": table}, spec, mesh)["embed"]
    return table[tokens.long() % cfg.vocab_size].to(cfg.torch_dtype)


def train(cfg, *, steps: int, global_batch: int, seq_len: int, mesh=None,
          lr: float = 3e-4, log_every: int = 10,
          ckpt_path: str | None = None, seed: int = 0, device="cuda"):
    """Train ``cfg`` from random weights (drawn from ``seed`` on the
    device) on ``Pipeline`` batches of the same seed.  Returns (params,
    history): one dict of floats per logged step (loss, ce, aux, lr,
    grad_norm, step, wall_s).  On a ``mesh`` the params are this rank's
    train blocks; rank 0 prints and writes the checkpoint (the whole
    tree, the file the one-device trainer writes)."""
    if cfg.family == "vlm":
        raise ValueError(
            "train() feeds Pipeline token batches, which carry no "
            "'patch_embeds' for the vlm family (the reference's launcher "
            "fails on that key); call make_train_step with batches that "
            "hold them")
    model = build_model(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = (model.init(gen) if mesh is None
              else model.init_training(gen, mesh))
    ocfg = optim.OptimizerConfig(lr=lr, total_steps=steps,
                                 warmup_steps=max(steps // 20, 5))
    opt_state = optim.init(params)
    step_fn = make_train_step(model, ocfg, mesh)
    rank0 = mesh is None or not any(mesh.coords.values())
    pipe = Pipeline(PipelineConfig(seq_len=seq_len, global_batch=global_batch,
                                   vocab_size=cfg.vocab_size, seed=seed))
    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in pipe.next_batch().items()}
        if cfg.family == "audio":
            batch = {"frame_embeds": audio_frames(cfg, params,
                                                  batch["tokens"], mesh),
                     "labels": batch["labels"]}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"], m["wall_s"] = step, time.perf_counter() - t0
            history.append(m)
            if rank0:
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"ce {m['ce']:.4f} aux {m['aux']:.4f} "
                      f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.3f} "
                      f"[{m['wall_s']:.2f}s]", flush=True)
    if ckpt_path:
        ckpt_io.save(ckpt_path, params, step=steps, mesh=mesh,
                     spec=sharding.train_specs(cfg, mesh)
                     if mesh is not None else None)
        if rank0:
            print(f"saved checkpoint to {ckpt_path}")
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--moe-strategy", default=None,
                    choices=[None, "dense", "dispatch"])
    ap.add_argument("--expert-parallel", default=None,
                    choices=[None, "centralized", "decentralized", "a2a"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {}
    if args.moe_strategy:
        over["moe_strategy"] = args.moe_strategy
    if args.expert_parallel:
        over["expert_parallel"] = args.expert_parallel
    if over:
        cfg = cfg.replace(**over)
    train(cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
          lr=args.lr, ckpt_path=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
