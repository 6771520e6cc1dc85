"""The collectives of the expert-parallel schedules over ``torch.distributed``
(what ``jax.lax``'s named-axis collectives are to the JAX package).

One function per collective the schedules use, each over one axis of a
``launch.mesh.Mesh``:

  psum          -> all_gather, rank-order sum  "all-reduce"
  all_gather    -> all_gather_into_tensor      "all-gather"
  psum_scatter  -> reduce_scatter_tensor       "reduce-scatter"
  all_to_all    -> all_to_all_single           "all-to-all" (async form too)
  ppermute      -> batch_isend_irecv ring      "collective-permute"
  pmean         -> psum's sum, then / n        AUX ("aux-pmean")
  pmax          -> all_reduce(MAX)             "all-reduce"
  broadcast     -> broadcast from the axis's first rank  "broadcast"
  enter         -> nothing forward (autograd's entry operator, below)

Each call adds its OPERAND bytes to the mesh's per-rank counter
(``mesh.bytes``) under the HLO kind names that
``core/perf_model.predicted_collective_bytes`` uses, and the host seconds
it waited to ``mesh.seconds``.  Three uses are kept under keys of their
own, because the prediction leaves them out: the scalar aux-loss
``pmean``s (``AUX``), the layout step that gathers sequence blocks back
over the expert axis (``LAYOUT``, see ``core/expert_parallel``) and the
gather of a serving step's per-row results over the data axes that cut
its rows (``ROWS``: ``expert_parallel.batch_unshard``).  An axis of size
1 is an identity and counts nothing.

Transport: the ranks meet over gloo (``launch/mesh.py``), so a CUDA
operand goes through a pinned host buffer: a device-to-host copy queued
behind the compute that produced the operand and one wait for both, the
collective on the host, a copy back that the host does not wait for.
The choice is fixed by the tensor's device.  ``mesh.seconds`` holds that
wait, the collective and the copies.

Sums run in the operand's dtype, as ``jax.lax.psum`` does, and in rank
order: every rank gathers the axis's terms and adds them first to last,
so every rank holds the same bits, and a 16-bit sum equals the
one-device sum of the same partials in shard order.  A gather is also
the faster sum here: gloo's ring all-reduce takes 2 (n - 1) exchanges,
each a thread wake-up on every rank, where the gather takes n - 1, and on
a few hundred KB a wake-up costs more than the wire.  Bools travel as
uint8.

Autograd (training on a mesh).  A floating operand that requires grad
goes through a ``torch.autograd.Function`` whose backward is the
collective's transpose, as under ``shard_map(check_vma=True)``: the
forward is the same call (same values, same bytes), and the backward's
collective is counted under its own kind.  The convention is JAX's: a
value that is the same on every rank of an axis (invariant) carries its
whole cotangent on every rank; a value that differs (varying) carries
its own.  So

  psum          backward identity (varying partials -> invariant sum)
  enter         forward identity, backward psum: where an invariant value
                enters per-rank work (JAX's implicit ``pvary``)
  all_gather    backward psum_scatter; with ``invariant=True`` (the result
                is used as the same value on every rank) this rank's block
  psum_scatter  backward all_gather
  all_to_all    backward all_to_all (the exchange is its own inverse)
  ppermute      backward the inverse permutation
  pmean         backward g / n, no communication

``all_gather_packed``, ``psum_scatter_packed`` and ``psum_packed`` move
several tensors in one exchange a dtype (a layer's parameter blocks and
their gradients, ``launch/sharding.compute_view``).

A meta mesh (``launch/mesh.make_meta_mesh``: no process group, the
dry-run's) takes meta tensors only: each collective returns an empty meta
tensor of its result's shape and counts its bytes, without communicating.
Every collective also books itself to an active ``launch/opcount``
capture (kind, operand and result bytes), which the analysis rules read.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from repro_torch.launch import opcount

AUX = "aux-pmean"
LAYOUT = "layout"
ROWS = "row-gather"
# training on a mesh: the parameter blocks gathered for a layer's compute,
# and their gradients reduced back into the blocks (``launch/sharding``)
PARAM_GATHER = "param-gather"
GRAD_REDUCE = "grad-reduce"


def _count(mesh, kind: str, x: torch.Tensor, seconds: float,
           out_bytes: int | None = None) -> None:
    nb = x.numel() * x.element_size()
    mesh.bytes[kind] = mesh.bytes.get(kind, 0) + nb
    mesh.seconds[kind] = mesh.seconds.get(kind, 0.0) + seconds
    opcount.book_collective(kind, x, nb if out_bytes is None else out_bytes)


def _on_meta(mesh, x: torch.Tensor) -> bool:
    """Whether this call runs the meta path: the mesh has no process
    group, and then the operand must be a meta tensor."""
    if not getattr(mesh, "meta", False):
        return False
    if not x.is_meta:
        raise ValueError(f"a meta mesh takes meta tensors, got one on "
                         f"{x.device}")
    return True


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """The operand where gloo reads it: a pinned host copy of a CUDA
    tensor (the copy queued on the stream, then one wait for it and all
    before it), else a contiguous copy (the collectives write their
    buffers in place)."""
    if x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return host
    return x.contiguous().clone()


def _back(host: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A collective's result on the operand's device.  The copy up from
    pinned memory is stream-ordered and does not wait: the next kernel on
    the stream reads it, and the host allocator keeps the buffer until the
    copy is done."""
    return host.to(x.device, non_blocking=True) if x.is_cuda else host


def _empty_like_host(x: torch.Tensor, shape) -> torch.Tensor:
    if x.is_cuda:
        return torch.empty(shape, dtype=x.dtype, pin_memory=True)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def _raw(x: torch.Tensor) -> torch.Tensor:
    """Bools travel as uint8 (the same byte)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _sum(buf: torch.Tensor, x: torch.Tensor, mesh,
         axis: str) -> torch.Tensor:
    """The sum over ``axis`` of every rank's host ``buf`` (operand ``x``
    staged), in rank order and in its dtype."""
    terms = _empty_like_host(x, (mesh.shape[axis],) + tuple(buf.shape))
    dist.all_gather_into_tensor(terms.view(-1), buf.reshape(-1),
                                group=mesh.groups[axis])
    out = terms[0]
    for term in terms[1:]:
        out += term
    return out


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records a collective of ``x`` (its transpose then
    runs in the backward)."""
    return torch.is_grad_enabled() and x.requires_grad


def _psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if _on_meta(mesh, x):
        _count(mesh, "all-reduce", x, 0.0)
        return torch.empty_like(x)
    t0 = time.perf_counter()
    out = _back(_sum(_to_host(x), x, mesh, axis), x)
    _count(mesh, "all-reduce", x, time.perf_counter() - t0)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.mesh, ctx.axis), None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` in rank order; every rank of the axis
    gets the same bits.  Backward: identity."""
    if mesh.groups[axis] is None:
        return x
    if _tracked(x):
        return _Psum.apply(x, mesh, axis)
    return _psum(x, mesh, axis)


def enter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, the same on every rank of ``axis``, as the input of work
    that differs per rank (a rank's experts, its sequence block): the
    identity, whose backward sums the ranks' partial cotangents over the
    axis (the transpose of JAX's implicit ``pvary``)."""
    if mesh.groups[axis] is None or not _tracked(x):
        return x
    return _Enter.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise maximum of ``x`` over ``axis`` (``jax.lax.pmax``, an
    all-reduce in HLO); every rank of the axis gets it."""
    if mesh.groups[axis] is None:
        return x
    if _on_meta(mesh, x):
        _count(mesh, "all-reduce", x, 0.0)
        return torch.empty_like(x)
    t0 = time.perf_counter()
    buf = _to_host(x)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.groups[axis])
    out = _back(buf, x)
    _count(mesh, "all-reduce", x, time.perf_counter() - t0)
    return out


def broadcast(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The value of ``x`` on the axis's first rank (index 0), handed to
    every rank of the axis."""
    if mesh.groups[axis] is None:
        return x
    if _on_meta(mesh, x):
        _count(mesh, "broadcast", x, 0.0)
        return torch.empty_like(x)
    t0 = time.perf_counter()
    buf = _to_host(_raw(x))
    dist.broadcast(buf, src=mesh.rank_at(axis, 0), group=mesh.groups[axis])
    out = _back(buf, x)
    _count(mesh, "broadcast", x, time.perf_counter() - t0)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def _pmean(x: torch.Tensor, mesh, live: list) -> torch.Tensor:
    if _on_meta(mesh, x):
        _count(mesh, AUX, x, 0.0)
        return torch.empty_like(x)
    t0 = time.perf_counter()
    buf = _to_host(x)
    for a in live:
        buf = _sum(buf, x, mesh, a)
    out = _back(buf, x) / _live_size(mesh, live)
    _count(mesh, AUX, x, time.perf_counter() - t0)
    return out


def _live_size(mesh, live) -> int:
    n = 1
    for a in live:
        n *= mesh.shape[a]
    return n


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, live):
        ctx.n = _live_size(mesh, live)
        return _pmean(x, mesh, live)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def pmean(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """Mean over every axis of ``axes`` (the aux losses): one sum per axis,
    divided by the product of their sizes, counted once under ``AUX``.
    Backward: g / n on every rank, no communication."""
    live = [a for a in axes if mesh.groups[a] is not None]
    if not live:
        return x
    if _tracked(x):
        return _Pmean.apply(x, mesh, live)
    return _pmean(x, mesh, live)


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int,
                kind: str) -> torch.Tensor:
    n = mesh.shape[axis]
    if _on_meta(mesh, x):
        _count(mesh, kind, x, 0.0, n * x.numel() * x.element_size())
        shape = list(x.shape)
        shape[dim] *= n
        return torch.empty(shape, dtype=x.dtype, device="meta")
    t0 = time.perf_counter()
    src = _to_host(_raw(x))
    out = _empty_like_host(src, (n * src.numel(),))
    dist.all_gather_into_tensor(out, src.reshape(-1),
                                group=mesh.groups[axis])
    out = _back(out.view((n,) + tuple(x.shape)), x)
    out = torch.cat(out.unbind(0), dim=dim)
    _count(mesh, kind, x, time.perf_counter() - t0,
           n * x.numel() * x.element_size())
    return out.view(torch.bool) if x.dtype == torch.bool else out


def local_block(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` split into axis-size blocks."""
    blk = t.shape[dim] // mesh.shape[axis]
    return t.narrow(dim, mesh.coords[axis] * blk, blk)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, kind, invariant):
        ctx.args = (mesh, axis, dim, invariant)
        return _all_gather(x, mesh, axis, dim, kind)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, invariant = ctx.args
        if invariant:
            gx = local_block(g, mesh, axis, dim).contiguous()
        else:
            gx = _psum_scatter(g, mesh, axis, dim)
        return gx, None, None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int,
               kind: str = "all-gather",
               invariant: bool = False) -> torch.Tensor:
    """The blocks of every rank of ``axis`` concatenated along ``dim`` in
    axis order (``jax.lax.all_gather(..., tiled=True)``).  Backward:
    psum_scatter of the cotangents; with ``invariant`` (the result is used
    as one value that every rank holds, so its cotangent is whole on every
    rank) this rank's block of it."""
    if mesh.groups[axis] is None:
        return x
    if _tracked(x):
        return _AllGather.apply(x, mesh, axis, dim, kind, invariant)
    return _all_gather(x, mesh, axis, dim, kind)


def _psum_scatter(x: torch.Tensor, mesh, axis: str,
                  dim: int) -> torch.Tensor:
    n = mesh.shape[axis]
    if _on_meta(mesh, x):
        _count(mesh, "reduce-scatter", x, 0.0, x.numel() * x.element_size()
               // n)
        shape = list(x.shape)
        shape[dim] //= n
        return torch.empty(shape, dtype=x.dtype, device="meta")
    t0 = time.perf_counter()
    blocks = x.movedim(dim, 0)
    src = _to_host(blocks)
    out = _empty_like_host(src, (src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=mesh.groups[axis])
    out = _back(out, x).movedim(0, dim)
    _count(mesh, "reduce-scatter", x, time.perf_counter() - t0)
    return out


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _psum_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return (_all_gather(g.contiguous(), mesh, axis, dim, "all-gather"),
                None, None, None)


def psum_scatter(x: torch.Tensor, mesh, axis: str,
                 dim: int) -> torch.Tensor:
    """Sum over ``axis``, then this rank's block of ``dim`` (split into
    axis-size blocks): ``jax.lax.psum_scatter(..., tiled=True)``.
    Backward: all_gather."""
    if mesh.groups[axis] is None:
        return x
    if _tracked(x):
        return _PsumScatter.apply(x, mesh, axis, dim)
    return _psum_scatter(x, mesh, axis, dim)


class Pending:
    """An all-to-all in flight: ``wait()`` returns its output on the
    operand's device and books the wait."""

    def __init__(self, mesh, x, out, work, t_issue: float):
        self.mesh, self.x, self.out, self.work = mesh, x, out, work
        self.t_issue = t_issue

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        if self.work is not None:
            self.work.wait()
        out = _back(self.out, self.x)
        _count(self.mesh, "all-to-all", self.x,
               self.t_issue + time.perf_counter() - t0)
        return out


class _Done:
    """A finished exchange behind ``Pending``'s interface."""

    def __init__(self, out):
        self.out = out

    def wait(self) -> torch.Tensor:
        return self.out


def _all_to_all(x: torch.Tensor, mesh, axis: str, async_op: bool = False):
    if _on_meta(mesh, x):
        pending = Pending(mesh, x, torch.empty_like(x), None, 0.0)
        return pending if async_op else pending.wait()
    t0 = time.perf_counter()
    src = _to_host(x)
    out = _empty_like_host(src, src.shape)
    work = dist.all_to_all_single(out, src, group=mesh.groups[axis],
                                  async_op=async_op)
    pending = Pending(mesh, x, out, work, time.perf_counter() - t0)
    return pending if async_op else pending.wait()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), *ctx.args), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str,
               async_op: bool = False):
    """``x`` (n, ...) with n the axis size: block j goes to rank j, and
    block j of the output came from rank j (``jax.lax.all_to_all`` with
    split and concat axis 0, untiled).  With ``async_op`` it returns a
    ``Pending`` whose ``wait()`` gives the output; under autograd the
    exchange completes in the call (the same values; backward: the same
    exchange of the cotangents)."""
    if mesh.groups[axis] is None:
        return Pending(mesh, x, x, None, 0.0) if async_op else x
    if _tracked(x):
        out = _AllToAll.apply(x, mesh, axis)
        return _Done(out) if async_op else out
    return _all_to_all(x, mesh, axis, async_op)


def _ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    if _on_meta(mesh, x):
        _count(mesh, "collective-permute", x, 0.0)
        return torch.empty_like(x)
    me = mesh.coords[axis]
    t0 = time.perf_counter()
    src = _to_host(x)
    out = torch.zeros_like(src)
    ops = [dist.P2POp(dist.isend, src, mesh.rank_at(axis, d),
                      mesh.groups[axis]) for s, d in perm if s == me]
    ops += [dist.P2POp(dist.irecv, out, mesh.rank_at(axis, s),
                       mesh.groups[axis]) for s, d in perm if d == me]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = _back(out, x)
    _count(mesh, "collective-permute", x, time.perf_counter() - t0)
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm])
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g.contiguous(), *ctx.args), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """Send this rank's ``x`` along ``perm`` ((source, destination) axis
    indices); a rank that no pair sends to gets zeros, as in JAX.
    Backward: the cotangents sent along the inverse permutation."""
    if mesh.groups[axis] is None:
        return x
    if _tracked(x):
        return _Ppermute.apply(x, mesh, axis, perm)
    return _ppermute(x, mesh, axis, perm)


# ---------------------------------------------------------------------------
# packed forms: several tensors of one dtype in one exchange
# ---------------------------------------------------------------------------

def _flat(xs) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in xs])


def _per_dtype(xs, packed):
    """``packed(indices)`` over each dtype's tensors of ``xs`` (one
    exchange a dtype: a layer's bf16 weights beside RG-LRU's or Mamba-2's
    fp32 leaves), the results back in ``xs``' order; None when ``xs`` has
    one dtype."""
    dtypes = list(dict.fromkeys(x.dtype for x in xs))
    if len(dtypes) == 1:
        return None
    out = [None] * len(xs)
    for dt in dtypes:
        idx = [i for i, x in enumerate(xs) if x.dtype == dt]
        for i, r in zip(idx, packed(idx)):
            out[i] = r
    return out


def _unflat(flat: torch.Tensor, shapes) -> list:
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[..., off:off + n].reshape(flat.shape[:-1] + shape))
        off += n
    return out


def all_gather_packed(xs, mesh, axis: str, dims, kind: str) -> list:
    """``all_gather(x, mesh, axis, dim)`` of each ``x`` with its ``dim``,
    in one exchange a dtype (no autograd)."""
    if mesh.groups[axis] is None or not xs:
        return list(xs)
    split = _per_dtype(xs, lambda idx: all_gather_packed(
        [xs[i] for i in idx], mesh, axis, [dims[i] for i in idx], kind))
    if split is not None:
        return split
    flat = _flat(xs)
    n = mesh.shape[axis]
    if _on_meta(mesh, flat):
        _count(mesh, kind, flat, 0.0, n * flat.numel() * flat.element_size())
        return [torch.empty([s * n if i == d else s for i, s in
                             enumerate(x.shape)], dtype=x.dtype,
                            device="meta") for x, d in zip(xs, dims)]
    t0 = time.perf_counter()
    src = _to_host(flat)
    out = _empty_like_host(src, (n, src.numel()))
    dist.all_gather_into_tensor(out.view(-1), src, group=mesh.groups[axis])
    out = _back(out, flat)
    _count(mesh, kind, flat, time.perf_counter() - t0,
           n * flat.numel() * flat.element_size())
    parts = _unflat(out, [tuple(x.shape) for x in xs])
    return [torch.cat(p.unbind(0), dim=d) for p, d in zip(parts, dims)]


def psum_scatter_packed(xs, mesh, axis: str, dims, kind: str) -> list:
    """``psum_scatter(x, mesh, axis, dim)`` of each ``x`` with its
    ``dim``, in one exchange a dtype (no autograd)."""
    if mesh.groups[axis] is None or not xs:
        return list(xs)
    split = _per_dtype(xs, lambda idx: psum_scatter_packed(
        [xs[i] for i in idx], mesh, axis, [dims[i] for i in idx], kind))
    if split is not None:
        return split
    n = mesh.shape[axis]
    rows = [x.unflatten(d, (n, x.shape[d] // n)).movedim(d, 0).reshape(n, -1)
            for x, d in zip(xs, dims)]
    src_dev = torch.cat(rows, dim=1)
    if _on_meta(mesh, src_dev):
        _count(mesh, kind, src_dev, 0.0, src_dev.numel()
               * src_dev.element_size() // n)
        return [torch.empty([s // n if i == d else s for i, s in
                             enumerate(x.shape)], dtype=x.dtype,
                            device="meta") for x, d in zip(xs, dims)]
    t0 = time.perf_counter()
    src = _to_host(src_dev)
    out = _empty_like_host(src, (src.shape[1],))
    dist.reduce_scatter_tensor(out, src.view(-1), group=mesh.groups[axis])
    out = _back(out, src_dev)
    _count(mesh, kind, src_dev, time.perf_counter() - t0)
    shapes = []
    for x, d in zip(xs, dims):
        shape = list(x.shape)
        shape[d] //= n
        shapes.append(tuple(shape))
    return _unflat(out, shapes)


def psum_packed(xs, mesh, axis: str, kind: str, mean: bool = False) -> list:
    """``psum`` (or with ``mean`` the mean) of each ``x`` over ``axis`` in
    one exchange a dtype, in rank order (no autograd)."""
    if mesh.groups[axis] is None or not xs:
        return list(xs)
    split = _per_dtype(xs, lambda idx: psum_packed(
        [xs[i] for i in idx], mesh, axis, kind, mean))
    if split is not None:
        return split
    flat = _flat(xs)
    if _on_meta(mesh, flat):
        _count(mesh, kind, flat, 0.0)
        return [torch.empty_like(x) for x in xs]
    t0 = time.perf_counter()
    out = _back(_sum(_to_host(flat), flat, mesh, axis), flat)
    if mean:
        out = out / mesh.shape[axis]
    _count(mesh, kind, flat, time.perf_counter() - t0)
    return _unflat(out, [tuple(x.shape) for x in xs])
