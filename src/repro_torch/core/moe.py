"""MoE expert execution forms on one device (the JAX package's
``core/moe.py``).

* ``dense_moe``    — every local expert computes every token (L_B);
* ``dispatch_moe`` — fixed-capacity dispatch (L_R): drops above capacity,
                     pads below;
* ``gather_moe``   — capacity-free per-token gather for small decode blocks;
* ``reference_moe`` — the exact per-token top-k MoE (no capacity drops),
                     the tests' oracle.

``expert_ffn`` goes through ``kernels/ops.moe_ffn`` (the grouped expert
FFN kernel on a CUDA tensor, its plain version on a CPU tensor, for raw or
QuantTensor expert weights alike), or with ``kernels=False`` through the
reference's jnp branch in torch ops, which autograd differentiates: the
trainer's path (``launch/train.py``), as the reference trains with
``use_kernel=False``.
Out-of-range indices are clamped or routed to a spare buffer row
explicitly (JAX clamps gathers and drops scatters silently).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import ops


def round_capacity(tokens: int, k: int, num_experts: int,
                   capacity_factor: float, multiple: int = 8) -> int:
    """Static per-expert capacity, rounded up to a multiple of 8."""
    raw = math.ceil(tokens * k / num_experts * capacity_factor)
    return max(multiple, math.ceil(raw / multiple) * multiple)


def expert_ffn(experts: dict, xe: torch.Tensor,
               kernels: bool = True) -> torch.Tensor:
    """Grouped SwiGLU FFN. xe: (E_local, C, D) -> (E_local, C, D).

    ``kernels=False`` runs the reference's jnp branch: the products on fp32
    copies of the operands (``qdot`` with fp32 outputs; a QuantTensor is
    dequantized to its own dtype first), h rounded to xe's dtype, the
    result in xe's dtype.  It reaches nothing in ``kernels/``."""
    if kernels:
        return ops.moe_ffn(xe, experts["w_gate"], experts["w_up"],
                           experts["w_down"])
    w = lambda name: quant.materialize(experts[name]).float()
    xf = xe.float()
    g = torch.bmm(xf, w("w_gate"))
    u = torch.bmm(xf, w("w_up"))
    h = (F.silu(g) * u).to(xe.dtype)
    return torch.bmm(h.float(), w("w_down")).to(xe.dtype)


def dense_moe(experts: dict, x: torch.Tensor, top_idx: torch.Tensor,
              top_w: torch.Tensor, e_start: int,
              kernels: bool = True) -> torch.Tensor:
    """x: (T, D).  Every local expert computes every token; the combine
    masks out what the router did not select.  Returns the local partial
    sum (T, D)."""
    e_local = experts["w_gate"].shape[0]
    t, d = x.shape
    xe = x[None].expand(e_local, t, d).contiguous()
    ye = expert_ffn(experts, xe, kernels)                     # (E_local, T, D)
    local_ids = e_start + torch.arange(e_local, device=x.device)
    sel = top_idx[None, :, :] == local_ids[:, None, None]     # (E_local, T, K)
    w = torch.where(sel, top_w[None], 0.0).sum(dim=-1)        # (E_local, T)
    return torch.einsum("et,etd->td", w.to(ye.dtype), ye)


def make_dispatch_plan(top_idx: torch.Tensor, num_experts: int, e_start: int,
                       e_local: int, capacity: int, groups: int = 1):
    """Gather/scatter indices for capacity dispatch.

    Returns (dispatch_tok, slot_valid, slot_of):
      dispatch_tok: (E_local * G * C,) int64 — source token per expert slot
                    (padding slots point at token 0 and are masked)
      slot_valid:   (E_local * G * C,) bool — slot actually holds a token
      slot_of:      (T, K) int64 — destination slot per routing decision,
                    == E_local*G*C (one past the end) when dropped /
                    non-local
    Ties keep token order (stable sort), so drops hit the latest tokens.
    ``groups`` G: the T tokens are G equal blocks of rows, each planned
    apart with ``capacity`` slots per expert (what G separate plans of
    the blocks give); expert e's slots hold block 0's, then block 1's."""
    t, k = top_idx.shape
    dev = top_idx.device
    flat_e = top_idx.reshape(-1).long()
    if groups > 1:
        block = torch.arange(t * k, device=dev) // k // (t // groups)
        flat_e = flat_e * groups + block
    order = torch.argsort(flat_e, stable=True)
    sorted_key = flat_e[order]
    n_keys = num_experts * groups
    first = torch.searchsorted(sorted_key, torch.arange(n_keys, device=dev),
                               side="left")
    # dead-routed decisions carry the E_pad sentinel: clamp the lookup
    # (their rank is irrelevant, they are never local)
    rank = (torch.arange(t * k, device=dev)
            - first[sorted_key.clamp(max=n_keys - 1)])
    sorted_e = sorted_key // groups if groups > 1 else sorted_key
    is_local = (sorted_e >= e_start) & (sorted_e < e_start + e_local)
    ok = is_local & (rank < capacity)
    nbuf = e_local * groups * capacity
    slot = (sorted_e - e_start) * groups * capacity + rank
    if groups > 1:
        slot = slot + (sorted_key % groups) * capacity
    dest = torch.where(ok, slot, nbuf)
    # one spare row (index nbuf) takes every dropped decision
    dispatch_tok = torch.zeros((nbuf + 1,), dtype=torch.long, device=dev)
    dispatch_tok[dest] = order // k
    slot_valid = torch.zeros((nbuf + 1,), dtype=torch.bool, device=dev)
    # index_fill_ takes the value as a kernel argument: an indexed
    # assignment of True would copy a host scalar up and sync on the card
    slot_valid.index_fill_(0, dest, True)
    slot_of = torch.empty((t * k,), dtype=torch.long, device=dev)
    slot_of[order] = dest
    return dispatch_tok[:nbuf], slot_valid[:nbuf], slot_of.reshape(t, k)


def dispatch_moe(experts: dict, x: torch.Tensor, top_idx: torch.Tensor,
                 top_w: torch.Tensor, num_experts: int, e_start: int,
                 capacity: int, kernels: bool = True,
                 groups: int = 1) -> torch.Tensor:
    """Capacity-based dispatch on the local shard. x: (T, D).  Returns the
    local partial sum (T, D).  ``groups``: blocks of rows with a capacity
    each (``make_dispatch_plan``).

    The gathers are ``index_select``s: their backward adds with atomics,
    where advanced indexing's backward sorts the indices and sums each run
    of equal ones serially (every padding slot reads token 0 and every
    dropped decision the spare row, so those runs are long)."""
    e_local = experts["w_gate"].shape[0]
    t, d = x.shape
    dispatch_tok, slot_valid, slot_of = make_dispatch_plan(
        top_idx, num_experts, e_start, e_local, capacity, groups)
    xe = x.index_select(0, dispatch_tok) * slot_valid[:, None].to(x.dtype)
    xe = xe.reshape(e_local, groups * capacity, d)
    ye = expert_ffn(experts, xe, kernels).reshape(-1, d)
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))], dim=0)
    y_tk = ye_pad.index_select(0, slot_of.reshape(-1)).reshape(t, -1, d)
    return torch.einsum("tk,tkd->td", top_w.to(y_tk.dtype), y_tk)


def gather_moe(experts: dict, x: torch.Tensor, top_idx: torch.Tensor,
               top_w: torch.Tensor, e_start: int) -> torch.Tensor:
    """Capacity-free per-token expert gather on the local shard: T*K FFN
    rows, no padding, no drops; only the selected experts' weights are
    read.  Non-local selections (including the E_pad dead-route sentinel)
    contribute zero.  x: (T, D) -> local partial sum (T, D).

    Products run on fp32 copies of the operands, so g, u and y stay fp32
    as in the reference; only h is rounded to x's dtype, at the
    reference's point.  QuantTensor experts gather only the selected
    experts' payload and scales (``w[idx]``) and dequantize that slice to
    the weights' own dtype, as the reference's ``qdot`` does.  This path
    has no TPU kernel; it stays in torch ops."""
    e_local = experts["w_gate"].shape[0]
    local = (top_idx >= e_start) & (top_idx < e_start + e_local)
    # a non-local selection reads local expert 0 (weight 0), never the
    # router-dead padding at the end of the stack that a clamp would reach
    idx = torch.where(local, top_idx - e_start, 0)
    w = torch.where(local, top_w, 0.0)
    xf = x.float()
    sel = lambda name: quant.materialize(experts[name][idx]).float()
    g = torch.einsum("td,tkdf->tkf", xf, sel("w_gate"))
    u = torch.einsum("td,tkdf->tkf", xf, sel("w_up"))
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.einsum("tkf,tkfd->tkd", h.float(), sel("w_down"))
    return torch.einsum("tk,tkd->td", w.float(), y).to(x.dtype)


def reference_moe(experts: dict, x: torch.Tensor, top_idx: torch.Tensor,
                  top_w: torch.Tensor) -> torch.Tensor:
    """Exact per-token top-k MoE with no capacity drop, in gather form (the
    reference's single-device oracle): x (T, D), top_idx / top_w (T, K) ->
    (T, D) in x's dtype.  g, u and y in fp32 on fp32 copies of the
    operands, h rounded to x's dtype, the weighted sum in fp32."""
    xf = x.float()
    sel = lambda name: quant.materialize(experts[name][top_idx]).float()
    g = torch.einsum("td,tkdf->tkf", xf, sel("w_gate"))
    u = torch.einsum("td,tkdf->tkf", xf, sel("w_up"))
    h = (F.silu(g) * u).to(x.dtype)
    y = torch.einsum("tkf,tkfd->tkd", h.float(), sel("w_down"))
    return torch.einsum("tk,tkd->td", top_w.float(), y).to(x.dtype)
