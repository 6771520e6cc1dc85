"""One MoE layer on a single device (the single-shard branch of the JAX
package's ``core/expert_parallel.moe_layer``).  The expert-parallel mesh
schedules are a later slice (ROADMAP queue A: meshes)."""
from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.core import moe as moe_lib
from repro_torch.core import router as router_lib


def _local_moe(cfg, experts: dict, x2d: torch.Tensor,
               rout: router_lib.RouterOut, e_start: int, capacity: int,
               kernels: bool = True) -> torch.Tensor:
    if cfg.moe_strategy == "dense":
        return moe_lib.dense_moe(experts, x2d, rout.top_idx, rout.top_w,
                                 e_start, kernels)
    t, k = rout.top_idx.shape
    e_local = experts["w_gate"].shape[0]
    if 0 < t * k <= cfg.gather_decode_max_tk:
        # capacity-free decode fast path, form chosen by modelled cost:
        # per-token gather when T*K <= E_local (reads < one local shard of
        # weights), one-hot dense when T is below the capacity floor
        if t * k <= e_local:
            return moe_lib.gather_moe(experts, x2d, rout.top_idx, rout.top_w,
                                      e_start)
        if t < capacity:
            return moe_lib.dense_moe(experts, x2d, rout.top_idx, rout.top_w,
                                     e_start, kernels)
    return moe_lib.dispatch_moe(experts, x2d, rout.top_idx, rout.top_w,
                                cfg.num_experts_padded, e_start, capacity,
                                kernels)


def _mask_rout(rout: router_lib.RouterOut, valid: torch.Tensor,
               e_pad: int) -> router_lib.RouterOut:
    """Dead-route invalid tokens: padding rows consume no expert capacity
    and contribute zero (their routing reads the E_pad sentinel)."""
    top_idx = torch.where(valid[:, None], rout.top_idx, e_pad)
    top_w = torch.where(valid[:, None], rout.top_w, 0.0)
    return rout._replace(top_idx=top_idx, top_w=top_w)


def moe_layer(cfg, layer_p: dict, x: torch.Tensor,
              token_mask: torch.Tensor | None = None, mesh=None,
              kernels: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux_loss (), top_idx (B*S, K)).

    ``layer_p``: {"router": (D, E_pad), "experts": {"w_gate": (E_pad, D, F),
    "w_up": ..., "w_down": (E_pad, F, D)}} (r x E_pad rows with
    ``expert_replication`` r).  ``token_mask`` (B, S) bool: False tokens
    are dead-routed to E_pad.  ``kernels=False``: the expert FFN takes the
    reference's jnp branch (``moe.expert_ffn``), the trainer's path."""
    if mesh is not None:
        raise not_ported("expert-parallel meshes", "meshes")
    experts = layer_p["experts"]
    if cfg.expert_replication > 1:
        # overlapping placement stores r copies of the stack; one device
        # uses the first (QuantTensor leaves slice payload and scales)
        experts = {k: w[:cfg.num_experts_padded] for k, w in experts.items()}
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    rout = router_lib.route(layer_p["router"], x2d, cfg.experts_per_token,
                            norm_topk=cfg.router_norm_topk,
                            n_valid_experts=cfg.num_experts)
    if token_mask is not None:
        rout = _mask_rout(rout, token_mask.reshape(b * s),
                          cfg.num_experts_padded)
    cap = moe_lib.round_capacity(b * s, cfg.experts_per_token,
                                 cfg.num_experts_padded, cfg.capacity_factor)
    y = _local_moe(cfg, experts, x2d, rout, 0, cap, kernels)
    return y.reshape(b, s, d), rout.aux_loss, rout.top_idx
