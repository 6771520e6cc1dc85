"""Top-k MoE router with dead-expert masking and the load-balance loss
(the JAX package's ``core/router.py``), and the paper's Table 1 statistic.

The router computes in fp32 (``quant.dot_f32``); on the card that needs
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
default).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import quant


class RouterOut(NamedTuple):
    top_idx: torch.Tensor   # (T, K) int64 — selected expert ids
    top_w: torch.Tensor     # (T, K) fp32 — combine weights
    probs: torch.Tensor     # (T, E) fp32 — full softmax
    aux_loss: torch.Tensor  # () fp32 — Switch-style load-balance loss


def route(router_w: torch.Tensor, x: torch.Tensor, k: int, *,
          norm_topk: bool = True,
          n_valid_experts: int | None = None) -> RouterOut:
    """x: (T, D); router_w: (D, E).  Experts >= ``n_valid_experts`` are
    dead padding and get -1e9 logits."""
    e = router_w.shape[-1]
    logits = quant.dot_f32(x, router_w)
    if n_valid_experts is not None and n_valid_experts < e:
        dead = torch.arange(e, device=x.device) >= n_valid_experts
        logits = logits.masked_fill(dead[None, :], -1e9)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    aux = load_balance_loss(probs, top_idx, e)
    return RouterOut(top_idx, top_w, probs, aux)


def load_balance_loss(probs: torch.Tensor, top_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-transformer aux loss, generalized to top-k."""
    t, k = top_idx.shape
    counts = torch.zeros((num_experts,), dtype=torch.float32,
                         device=probs.device)
    counts.index_add_(0, top_idx.reshape(-1),
                      torch.ones((t * k,), dtype=torch.float32,
                                 device=probs.device))
    f = counts / (t * k)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def expected_experts_per_shard(top_idx: torch.Tensor, num_experts: int,
                               n_shards: int) -> torch.Tensor:
    """E[#distinct experts executed per shard], the paper's Table 1
    statistic (``E[#exec. experts/node/layer]``), from routing decisions.
    Indices outside [0, num_experts) (the E_pad dead-route sentinel) hit
    nothing, as the reference's dropped scatter does."""
    eps = num_experts // n_shards
    flat = top_idx.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < num_experts), flat, num_experts)
    hit = torch.zeros((num_experts + 1,), dtype=torch.bool,
                      device=top_idx.device)
    hit.index_fill_(0, flat, True)
    per_shard = hit[:num_experts].reshape(n_shards, eps).sum(dim=1)
    return per_shard.float().mean()
