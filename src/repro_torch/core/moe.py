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
reference's jnp branch in torch ops, a block of experts at a time
(``_ExpertFFN``, with its own backward): the trainer's path
(``launch/train.py``), as the reference trains with ``use_kernel=False``.
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


# the trainer's expert FFN copies its weights to fp32 a block of experts
# at a time: as many experts as hold their three matrices in this many
# fp32 bytes (at least one).  Granite's 48 experts at D 1536, F 512 go 7
# at a time (66.1 MB of copies, of 453.0 MB for the stack), DBRX's
# 6144 x 10752 experts one at a time (793 MB, of 12.68 GB)
FFN_BLOCK_BYTES = 1 << 26


def experts_per_block(d: int, f: int) -> int:
    """Experts a block of ``_ExpertFFN`` holds at widths D and F."""
    return max(1, FFN_BLOCK_BYTES // (3 * d * f * 4))


def _blocks(e: int, d: int, f: int):
    step = experts_per_block(d, f)
    return [slice(e0, min(e0 + step, e)) for e0 in range(0, e, step)]


def _f32(w, rows: slice) -> torch.Tensor:
    """An fp32 copy of experts ``rows`` of a stack (a QuantTensor's
    dequantized to its own dtype first, ``_selected``)."""
    return _selected(w, rows).float()


class _ExpertFFN(torch.autograd.Function):
    """The reference's jnp branch of the grouped SwiGLU FFN (g = x Wg and
    u = x Wu as fp32 products of fp32 copies, h = silu(g) u rounded to
    x's dtype, y = h Wd in fp32 rounded to x's dtype), computed a block of
    experts at a time (``experts_per_block``), so no fp32 copy of a whole
    stack is made.  The forward saves the inputs in their own dtypes,
    never a copy; the backward copies each block again, recomputes its g,
    u and h, and writes the gradients of the block's weights in the
    weights' dtype, which is the gradient autograd takes through the
    reference's convert and fp32 dot: fp32, cast once.  A QuantTensor
    stack is dequantized a block at a time and has no gradient.  Every
    product is a ``bmm``, so the gradients come out the same from run to
    run."""

    @staticmethod
    def forward(ctx, xe, w_gate, w_up, w_down):
        ws = (w_gate, w_up, w_down)
        ctx.quant = tuple(w if isinstance(w, quant.QuantTensor) else None
                          for w in ws)
        ctx.save_for_backward(xe, *(None if q is not None else w
                                    for w, q in zip(ws, ctx.quant)))
        y = torch.empty_like(xe)
        e, _, d = xe.shape
        for rows in _blocks(e, d, w_gate.shape[-1]):
            xf = xe[rows].float()
            g = torch.bmm(xf, _f32(w_gate, rows))
            u = torch.bmm(xf, _f32(w_up, rows))
            h = (F.silu(g) * u).to(xe.dtype)
            y[rows] = torch.bmm(h.float(), _f32(w_down, rows)).to(xe.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        xe, *saved = ctx.saved_tensors
        wg, wu, wd = (q if q is not None else w
                      for q, w in zip(ctx.quant, saved))
        need = [ctx.needs_input_grad[i] and (i == 0 or ctx.quant[i - 1]
                                             is None) for i in range(4)]
        grads = [torch.empty_like(t) if n else None
                 for t, n in zip((xe, wg, wu, wd), need)]
        gx, gwg, gwu, gwd = grads
        e, _, d = xe.shape
        for rows in _blocks(e, d, wg.shape[-1]):
            xf = xe[rows].float()
            wgf, wuf, wdf = (_f32(w, rows) for w in (wg, wu, wd))
            g, u = torch.bmm(xf, wgf), torch.bmm(xf, wuf)
            s = F.silu(g)
            gyf = gy[rows].float()
            if gwd is not None:
                h = (s * u).to(xe.dtype).float()
                gwd[rows] = torch.bmm(h.transpose(1, 2), gyf).to(gwd.dtype)
            # dh through h's rounding to x's dtype, as autograd takes it
            gh = torch.bmm(gyf, wdf.transpose(1, 2)).to(xe.dtype).float()
            gu = gh * s
            gg = torch.ops.aten.silu_backward(gh * u, g)
            if gwg is not None:
                gwg[rows] = torch.bmm(xf.transpose(1, 2), gg).to(gwg.dtype)
            if gwu is not None:
                gwu[rows] = torch.bmm(xf.transpose(1, 2), gu).to(gwu.dtype)
            if gx is not None:
                gx[rows] = (torch.bmm(gg, wgf.transpose(1, 2))
                            + torch.bmm(gu, wuf.transpose(1, 2))).to(gx.dtype)
        return gx, gwg, gwu, gwd


def expert_ffn(experts: dict, xe: torch.Tensor,
               kernels: bool = True) -> torch.Tensor:
    """Grouped SwiGLU FFN. xe: (E_local, C, D) -> (E_local, C, D).

    ``kernels=False`` runs the reference's jnp branch (``_ExpertFFN``: the
    products on fp32 copies of the operands, a block of experts at a time;
    a QuantTensor is dequantized to its own dtype first), h rounded to
    xe's dtype, the result in xe's dtype.  It reaches nothing in
    ``kernels/``."""
    if kernels:
        return ops.moe_ffn(xe, experts["w_gate"], experts["w_up"],
                           experts["w_down"])
    return _ExpertFFN.apply(xe, experts["w_gate"], experts["w_up"],
                            experts["w_down"])


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
                       e_local: int, capacity: int):
    """Gather/scatter indices for capacity dispatch.

    Returns (dispatch_tok, slot_valid, slot_of):
      dispatch_tok: (E_local * C,) int64 — source token per expert slot
                    (padding slots point at token 0 and are masked)
      slot_valid:   (E_local * C,) bool — slot actually holds a token
      slot_of:      (T, K) int64 — destination slot per routing decision,
                    == E_local*C (one past the end) when dropped /
                    non-local
    Ties keep token order (stable sort), so drops hit the latest tokens."""
    t, k = top_idx.shape
    dev = top_idx.device
    flat_e = top_idx.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e,
                               torch.arange(num_experts, device=dev),
                               side="left")
    # dead-routed decisions carry the E_pad sentinel: clamp the lookup
    # (their rank is irrelevant, they are never local)
    rank = (torch.arange(t * k, device=dev)
            - first[sorted_e.clamp(max=num_experts - 1)])
    is_local = (sorted_e >= e_start) & (sorted_e < e_start + e_local)
    ok = is_local & (rank < capacity)
    nbuf = e_local * capacity
    slot = (sorted_e - e_start) * capacity + rank
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


class _DispatchRows(torch.autograd.Function):
    """xe[s] = x[dispatch_tok[s]] for a valid slot s, 0 for a padding slot
    (the forward of ``index_select`` times the mask, bit for bit).  The
    backward is a gather: each valid slot holds exactly one (token, k)
    decision, so grad_x[t] = sum over k of grad_xe[slot_of[t, k]], a
    dropped decision reading a spare zero row, summed over k in one fixed
    order.  ``index_select``'s own backward adds with atomics, in an order
    that changes from run to run."""

    @staticmethod
    def forward(ctx, x, dispatch_tok, slot_valid, slot_of):
        ctx.save_for_backward(slot_of)
        return x.index_select(0, dispatch_tok) * slot_valid[:, None].to(
            x.dtype)

    @staticmethod
    def backward(ctx, grad_xe):
        (slot_of,) = ctx.saved_tensors
        pad = torch.cat([grad_xe, grad_xe.new_zeros((1,) + grad_xe.shape[1:])])
        return pad[slot_of].sum(dim=1), None, None, None


class _CombineRows(torch.autograd.Function):
    """y_tk[t, k] = ye[slot_of[t, k]], the spare row (index len(ye)) a zero
    row for dropped decisions (the forward of ``index_select`` over ye
    with a zero row appended, bit for bit).  The backward is a gather:
    grad_ye[s] = grad_y_tk at the one decision slot s holds, 0 for a
    padding slot; no atomic adds."""

    @staticmethod
    def forward(ctx, ye, slot_of):
        ctx.save_for_backward(slot_of)
        ctx.nbuf = ye.shape[0]
        ye_pad = torch.cat([ye, ye.new_zeros((1,) + ye.shape[1:])], dim=0)
        return ye_pad.index_select(0, slot_of.reshape(-1)).reshape(
            slot_of.shape + ye.shape[1:])

    @staticmethod
    def backward(ctx, grad_y):
        (slot_of,) = ctx.saved_tensors
        nbuf, flat = ctx.nbuf, slot_of.reshape(-1)
        # the decision of each slot (one writer per valid slot; the spare
        # row, past nbuf, takes every dropped one and is cut off)
        dec = torch.zeros((nbuf + 1,), dtype=torch.long, device=flat.device)
        dec[flat] = torch.arange(flat.numel(), device=flat.device)
        held = torch.zeros((nbuf + 1,), dtype=torch.bool, device=flat.device)
        held.index_fill_(0, flat, True)
        g = grad_y.reshape((flat.numel(),) + grad_y.shape[2:])
        return torch.where(held[:nbuf, None], g.index_select(0, dec[:nbuf]),
                           0.0), None


def dispatch_rows(x: torch.Tensor, dispatch_tok: torch.Tensor,
                  slot_valid: torch.Tensor,
                  slot_of: torch.Tensor) -> torch.Tensor:
    """The capacity buffer (E_local * G * C, D) of a dispatch plan's
    slots, padding slots zero; its gradient is a gather (no atomics)."""
    return _DispatchRows.apply(x, dispatch_tok, slot_valid, slot_of)


def combine_rows(ye: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """Each routing decision's row (T, K, D) of the expert outputs ye
    (nbuf, D), zero for a dropped one; its gradient is a gather."""
    return _CombineRows.apply(ye, slot_of)


def dispatch_moe(experts: dict, x: torch.Tensor, top_idx: torch.Tensor,
                 top_w: torch.Tensor, num_experts: int, e_start: int,
                 capacity: int, kernels: bool = True) -> torch.Tensor:
    """Capacity-based dispatch on the local shard. x: (T, D).  Returns the
    local partial sum (T, D).

    The two gathers (``dispatch_rows``, ``combine_rows``) are
    ``index_select``s forward, and gathers backward too, so a trainer's
    gradients are the same from run to run (``index_select``'s backward
    adds with atomics)."""
    e_local = experts["w_gate"].shape[0]
    t, d = x.shape
    dispatch_tok, slot_valid, slot_of = make_dispatch_plan(
        top_idx, num_experts, e_start, e_local, capacity)
    xe = dispatch_rows(x, dispatch_tok, slot_valid, slot_of)
    xe = xe.reshape(e_local, capacity, d)
    ye = expert_ffn(experts, xe, kernels).reshape(-1, d)
    y_tk = combine_rows(ye, slot_of)
    return torch.einsum("tk,tkd->td", top_w.to(y_tk.dtype), y_tk)


def gather_moe(experts: dict, x: torch.Tensor, top_idx: torch.Tensor,
               top_w: torch.Tensor, e_start: int) -> torch.Tensor:
    """Capacity-free per-token expert gather on the local shard: T*K FFN
    rows, no padding, no drops; only the selected experts' weights are
    read.  Non-local selections (including the E_pad dead-route sentinel)
    contribute zero.  x: (T, D) -> local partial sum (T, D).

    As in the reference, the selected weights are gathered in their own
    dtype and the products have fp32 outputs (``quant.dot_f32``: the
    gathered slice copied to fp32 a block at a time), so g, u and y are
    fp32 and only h is rounded to x's dtype, at the reference's point.  QuantTensor
    experts gather only the selected experts' payload and scales
    (``w[idx]``) and dequantize that selection to the weights' own dtype
    a block at a time (``_selected``), one weight stack after the other:
    no transient exceeds the gathered slice of one stack in the weights'
    dtype.  This path has no TPU kernel; it stays in torch ops."""
    e_local = experts["w_gate"].shape[0]
    local = (top_idx >= e_start) & (top_idx < e_start + e_local)
    # a non-local selection reads local expert 0 (weight 0), never the
    # router-dead padding at the end of the stack that a clamp would reach
    idx = torch.where(local, top_idx - e_start, 0).reshape(-1)
    w = torch.where(local, top_w, 0.0)
    t, k = top_idx.shape
    xs = x[:, None].expand(t, k, x.shape[-1]).reshape(t * k, 1, -1)
    g = quant.dot_f32(xs, _selected(experts["w_gate"], idx))
    u = quant.dot_f32(xs, _selected(experts["w_up"], idx))
    h = (F.silu(g) * u).to(x.dtype)
    y = quant.dot_f32(h, _selected(experts["w_down"], idx)).reshape(t, k, -1)
    return torch.einsum("tk,tkd->td", w.float(), y).to(x.dtype)


def _selected(w, idx: torch.Tensor) -> torch.Tensor:
    """The stack's matrices at ``idx`` (n, K, N) in the weights' own
    dtype: a gather of a raw stack; of a QuantTensor's payload and scales,
    then each matrix dequantized into its place in a preallocated slice
    (``quant.dequantize_into``: one block's temporaries at a time)."""
    sel = w[idx]
    if not isinstance(sel, quant.QuantTensor):
        return sel
    out = torch.empty(sel.shape, dtype=sel.dtype, device=sel.data.device)
    quant.dequantize_into(out, sel)
    return out


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
