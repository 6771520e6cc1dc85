"""AdamW with a cosine schedule, linear warmup and global-norm clipping (the
JAX package's ``optim/adamw.py``, over the port's dict trees).

The arithmetic is the reference's: moments in fp32, parameters kept in
their own dtype with no fp32 master copy (a bf16 weight takes each update
rounded to bf16), the clip scale rounded to the gradient's dtype before
the multiply, the learning rate and the bias corrections in fp32, weight
decay on every leaf.  Where the reference returns new trees (XLA fuses the
per-leaf formula under ``jit`` with donated buffers), the port updates
IN PLACE: the gradients are clipped, the moments and the parameters
written, and a layer-stacked matrix (3-D and up) is taken one layer slice
at a time, so the fp32 temporaries stay a few slices' size.  Nothing here
waits for the device: the step, the rate and the norm stay tensors.

On a training mesh (``mesh`` and the params' ``spec`` tree, from
``launch/sharding.train_specs``) each rank holds its blocks of the
params, the gradients and both moments; only the global norm needs the
others (``global_norm``), and everything else is elementwise on the
blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import collectives


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: dict             # first moment, fp32, the params' tree
    nu: dict             # second moment


def tree_leaves(tree):
    """The leaves of a dict tree in sorted-key order (the order in which
    JAX flattens a dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _slices(t: torch.Tensor):
    """A layer-stacked matrix one leading slice at a time, else whole."""
    return t.unbind(0) if t.dim() >= 3 else (t,)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_ratio * lr (fp32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decayed


def init(params: dict) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params)).device)
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params))


def _spec_axes(spec) -> tuple:
    return tuple(a for entry in spec if entry is not None
                 for a in (entry if isinstance(entry, tuple) else (entry,)))


def global_norm(tree: dict, mesh=None, spec: dict | None = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares in fp32, each leaf's sum taken slice by
    slice (no fp32 copy of a whole stacked leaf).  On a ``mesh``, with
    ``spec`` the leaves' specs, the norm of the whole tree: the local
    square sums of the leaves that share a set of cut axes are added, each
    set's sum is summed over its axes, and a leaf held alike by several
    ranks (an axis that does not cut it) is counted once."""
    sums = [sum(torch.square(s.float()).sum() for s in _slices(x))
            for x in tree_leaves(tree)]
    if mesh is None:
        return torch.sqrt(torch.stack(sums).sum())
    groups: dict = {}
    for sq, sp in zip(sums, tree_leaves(spec)):
        axes = tuple(a for a in mesh.axis_names if a in _spec_axes(sp)
                     and mesh.shape[a] > 1)
        groups.setdefault(axes, []).append(sq)
    total = []
    for axes, part in sorted(groups.items()):
        part = torch.stack(part).sum()
        for a in axes:
            part = collectives.psum(part, mesh, a)
        total.append(part)
    return torch.sqrt(torch.stack(total).sum())


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, mesh=None,
                        spec: dict | None = None):
    """Scale ``grads`` IN PLACE to a global norm of at most ``max_norm``;
    the scale is rounded to each gradient's dtype first.  Returns (grads,
    the norm before clipping)."""
    norm = global_norm(grads, mesh, spec)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _adamw_(cfg: OptimizerConfig, p, g, m, v, lr, bc1, bc2) -> None:
    g32 = g.float()
    m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
    delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    p32 = p.float()
    delta.add_(p32, alpha=cfg.weight_decay)
    p.copy_(p32.sub_(delta.mul_(lr)))


@torch.no_grad()
def update(cfg: OptimizerConfig, grads: dict, state: OptState, params: dict,
           mesh=None, spec: dict | None = None):
    """One AdamW step IN PLACE: ``grads`` are clipped, ``state``'s moments
    and ``params`` written.  On a ``mesh`` every tree holds this rank's
    blocks under ``spec``.  Returns (params, the new state, {"lr",
    "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, mesh, spec)
    step = state.step + 1
    lr = lr_at(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(*(tree_leaves(t) for t in
                            (params, grads, state.mu, state.nu))):
        for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
            _adamw_(cfg, ps, gs, ms, vs, lr, bc1, bc2)
    return params, OptState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
