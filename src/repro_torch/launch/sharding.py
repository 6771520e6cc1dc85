"""Per-architecture partition specs for params, optimizer state, inputs and
caches (the JAX package's ``launch/sharding.py``), and the per-rank slicing
that stands in for ``jax.device_put`` on a ``NamedSharding``.

A spec is a plain tuple per leaf, one entry per dimension: ``None``
(replicated), an axis name, or a tuple of names (the dimension split over
their product, the first name slowest).  A ``QuantTensor`` leaf gets
``{"data": spec, "scale": spec}``: the reference's rule sees its payload
and its scales as two leaves under the weight's name, each spec derived
from the logical weight's with ``_axes_divide``'s drops.

Two parameter modes, as in the reference:

* ``train`` — FSDP-style: the tensor-parallel dimension over "model", the
  d_model (or another large) dimension over "data";
* ``serve`` — weights split over "model" only and replicated over the
  batch axes: the embedding by vocabulary rows, ``wq``/``wk``/``wv`` by
  heads (``wk``/``wv`` by the flat ``Hkv*hd`` dimension where the kv
  heads do not divide the axis), ``wo`` by rows, the dense MLP over F,
  the LM head by vocabulary columns, the experts over the expert axis.

The rules read only ``mesh.axis_names`` and ``mesh.shape`` (and leaf
shapes), so any object with those two fields will do; ``block_slices``
and ``shard_tree`` also read ``mesh.coords``, this rank's position.

``cache_pspec``'s ``hd`` placement (the reference's default for
``kv_cache_shard``) splits the head dimension of a dry-run's cache.  The
port's serving layers do not take it: on a mesh each rank's page pool and
contiguous cache hold the kv heads its attention uses, or with ``seq``
(context-parallel decode in the two-program engine) its sequence block of
every kv head (``models/attention.py``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import quant as quant_lib
from repro_torch.core.quant import QuantTensor
from repro_torch.launch import mesh as mesh_lib


def _dim_ok(size: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and size % mesh.shape[axis] == 0


def _spec(ndim: int, **at) -> tuple:
    """A spec of rank ``ndim`` with axes at the given positions, e.g.
    ``_spec(3, **{"2": "model"})`` -> (None, None, "model"); a tuple of
    one name is that name, as ``PartitionSpec`` normalises it."""
    out = [None] * ndim
    for pos, ax in at.items():
        out[int(pos)] = ax[0] if isinstance(ax, tuple) and len(ax) == 1 \
            else ax
    return tuple(out)


def _axes(entry) -> tuple:
    """A spec entry as a tuple of axis names (() when replicated)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _walk(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict; a QuantTensor's payload and
    scales are two leaves under the weight's key (``"data"``, ``"scale"``),
    as in the reference's pytree."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return {"data": fn(path + ("data",), tree.data),
                "scale": fn(path + ("scale",), tree.scale)}
    return fn(path, tree)


def params_pspec(cfg, mesh, params: dict, mode: str = "train") -> dict:
    """The spec tree of ``params`` (a tree of tensors, meta tensors or
    QuantTensors).  ``mode``: train | serve."""
    tp = "model"
    fsdp = "data" if (mode == "train" and "data" in mesh.axis_names) else None

    def _axes_divide(spec: tuple, shape) -> tuple:
        """Drop spec axes whose mesh extent no longer divides the leaf
        dimension (a QuantTensor's payload and scales shrink the reduction
        axis: int4 packing, per-block scales)."""
        out = []
        for i, ax in enumerate(spec):
            if ax is None:
                out.append(None)
                continue
            size = mesh_lib.axes_size(mesh, _axes(ax))
            out.append(ax if size and shape[i] % size == 0 else None)
        return tuple(out)

    def rule(names, leaf) -> tuple:
        names = list(names)
        name = names[-1]
        # QuantTensor membership is keyed on the PARENT being a weight
        # name: plain param dicts reuse "scale" (layernorm)
        quant_leaf = (name in ("data", "scale") and len(names) >= 2
                      and names[-2] in quant_lib.WEIGHT_NAMES)
        if quant_leaf:
            names = names[:-1]
            name = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        in_experts = "experts" in names

        def fin(spec: tuple) -> tuple:
            return _axes_divide(spec, shape) if quant_leaf else spec

        def sub(**kw) -> tuple:
            return fin(_spec(nd, **kw))

        if name == "embed":                       # (Vpad, D)
            return (tp, fsdp)
        if name == "lm_head":                     # (D, Vpad)
            return fin((fsdp, tp))
        if in_experts:                            # (L, E, D, F) / (L, E, F, D)
            if name in ("w_gate", "w_up"):
                dd = shape[2]
                return fin((None, tp, fsdp if _dim_ok(dd, mesh, "data")
                            and fsdp else None, None))
            if name == "w_down":
                dd = shape[3]
                return fin((None, tp, None, fsdp if _dim_ok(dd, mesh, "data")
                            and fsdp else None))
            return sub()
        if name == "router":                      # (L, D, E)
            return sub(**({"1": fsdp} if fsdp and _dim_ok(shape[1], mesh,
                                                          "data") else {}))
        if name in ("wq", "wk", "wv"):            # (L, D, H*hd)
            heads = cfg.num_heads if name == "wq" else cfg.num_kv_heads
            at = {}
            if fsdp and _dim_ok(shape[1], mesh, "data"):
                at["1"] = fsdp
            if heads and heads % mesh.shape[tp] == 0:
                at["2"] = tp
            elif (mode == "serve" and name in ("wk", "wv")
                  and _dim_ok(shape[2], mesh, tp)):
                # serve mode: the flat Hkv*hd dimension when the kv heads
                # do not divide the axis
                at["2"] = tp
            return sub(**at)
        if name == "wo":                          # (L, H*hd, D)
            at = {}
            if cfg.num_heads and cfg.num_heads % mesh.shape[tp] == 0:
                at["1"] = tp
            if fsdp and _dim_ok(shape[2], mesh, "data"):
                at["2"] = fsdp
            return sub(**at)
        if name in ("w_gate", "w_up"):            # (L, D, F) dense MLP
            at = {}
            if fsdp and _dim_ok(shape[1], mesh, "data"):
                at["1"] = fsdp
            if _dim_ok(shape[2], mesh, tp):
                at["2"] = tp
            return sub(**at)
        if name == "w_down":                      # (L, F, D)
            at = {}
            if _dim_ok(shape[1], mesh, tp):
                at["1"] = tp
            if fsdp and _dim_ok(shape[2], mesh, "data"):
                at["2"] = fsdp
            return sub(**at)
        # norms, biases, scalars (the families the port has)
        return sub()

    return _walk(rule, params)


def opt_pspec(cfg, mesh, opt_state, params_spec):
    """AdamW state: moments split like the params, the step replicated."""
    return type(opt_state)((), params_spec, params_spec)


def batch_pspec(cfg, mesh, batch: dict) -> dict:
    """A global batch: the leading dimension over the data axes when they
    divide it."""
    ba = mesh_lib.batch_axes(mesh)
    nb = mesh_lib.axes_size(mesh, ba)

    def per(v):
        b = v.shape[0]
        ax = ba if (nb and b % nb == 0) else ()
        return _spec(len(v.shape), **{"0": ax}) if ax else _spec(len(v.shape))

    return {k: per(v) for k, v in batch.items()}


def cache_pspec(cfg, mesh, cache: dict) -> dict:
    """KV caches (L, B, S, Hkv, hd): batch over the data axes, plus one
    "model" dimension chosen by ``cfg.kv_cache_shard`` (``hd``: the head
    dim; ``seq``: the cache length; ``kv``: the kv heads when they divide
    the axis; ``none``: batch only)."""
    ba = mesh_lib.batch_axes(mesh)
    nb = mesh_lib.axes_size(mesh, ba)
    mode = getattr(cfg, "kv_cache_shard", "hd")

    def rule(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        b = shape[1] if nd >= 2 else 0
        bax = ba if (nb and b % nb == 0) else ()
        at = {}
        if bax:
            at["1"] = bax
        if name in ("k", "v") and nd == 5:
            dim = {"seq": 2, "kv": 3, "hd": 4}.get(mode)
            if dim is not None and _dim_ok(shape[dim], mesh, "model"):
                at[str(dim)] = "model"
        if name in ("k_scale", "v_scale") and nd == 5 and mode == "seq" \
                and _dim_ok(shape[2], mesh, "model"):
            at["2"] = "model"
        return _spec(nd, **at)

    return _walk(rule, cache)


# ---------------------------------------------------------------------------
# per-rank slicing
# ---------------------------------------------------------------------------

def block_slices(shape, spec: tuple, mesh) -> tuple:
    """This rank's block of a leaf of ``shape`` under ``spec``: one slice
    per dimension.  A dimension split over axes (a, b, ...) takes block
    ``idx`` of ``prod(sizes)`` equal blocks, ``idx`` row-major over this
    rank's coordinates on those axes; it must divide."""
    out = []
    for size, entry in zip(shape, spec):
        axes = _axes(entry)
        n = mesh_lib.axes_size(mesh, axes)
        if n <= 1:
            out.append(slice(None))
            continue
        if size % n:
            raise ValueError(f"dimension {size} of {tuple(shape)} does not "
                             f"divide over {axes} ({n})")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
        blk = size // n
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


def _cut(x, sl: tuple):
    """The block of a tensor (a copy of its own, so the whole can be
    freed) or of a numpy array."""
    blk = x[sl]
    return blk.clone() if isinstance(blk, torch.Tensor) else blk.copy()


def _cut_quant(qt: QuantTensor, spec: dict, mesh) -> QuantTensor:
    """A QuantTensor's block: payload and scales each by its own spec.
    Where the payload is cut along its reduction axis (-2) and the scales
    stay whole (``_axes_divide`` dropped the axis for the block count),
    the block keeps the scale rows of its own rows, re-blocked at
    ``gcd(block, rows)`` so that its rows are whole blocks: each value
    keeps the scale it had, so the block dequantizes to the same values
    as the same rows of the whole."""
    dsl = block_slices(qt.data.shape, spec["data"], mesh)
    ssl = block_slices(qt.scale.shape, spec["scale"], mesh)
    data = _cut(qt.data, dsl)
    pack = 2 if qt.bits == 4 else 1
    rows = dsl[-2]
    if rows == slice(None):
        return QuantTensor(data, _cut(qt.scale, ssl), qt.bits, qt.block,
                           qt.orig_dim, qt.out_dtype)
    n_rows = (rows.stop - rows.start) * pack
    start = rows.start * pack
    if ssl[-2] != slice(None):
        if start % qt.block or qt.orig_dim % qt.block:
            raise ValueError("a cut of a QuantTensor's scales must fall on "
                             "its blocks")
        return QuantTensor(data, _cut(qt.scale, ssl), qt.bits, qt.block,
                           n_rows, qt.out_dtype)
    blk = math.gcd(qt.block, n_rows)
    if qt.bits == 4 and blk % 2:
        raise ValueError("an int4 block must stay even")
    lead = ssl[:-2] + (slice(None), ssl[-1])
    scale = qt.scale[lead]
    scale = torch.repeat_interleave(scale, qt.block // blk, dim=-2) \
        if isinstance(scale, torch.Tensor) else scale.repeat(
            qt.block // blk, axis=-2)
    scale = _cut(scale, (Ellipsis, slice(start // blk,
                                         (start + n_rows) // blk),
                         slice(None)))
    return QuantTensor(data, scale, qt.bits, blk, n_rows, qt.out_dtype)


def shard_tree(tree: dict, spec: dict, mesh) -> dict:
    """This rank's blocks of every leaf of ``tree`` (tensors, numpy arrays
    or QuantTensors) under the spec tree ``spec``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, spec[k], mesh) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return _cut_quant(tree, spec, mesh)
    return _cut(tree, block_slices(tree.shape, spec, mesh))


def split(spec, dim: int, axis: str = "model") -> bool:
    """Whether a leaf's spec (a QuantTensor's: its payload's) splits
    dimension ``dim`` over ``axis``."""
    if isinstance(spec, dict):
        spec = spec["data"]
    return axis in _axes(spec[dim])


# ---------------------------------------------------------------------------
# the serve-mode layout of a config, from its whole shapes
# ---------------------------------------------------------------------------

def meta_params(cfg) -> dict:
    """The whole parameter tree of ``cfg`` as meta tensors (no storage),
    quantized as ``cfg.weight_quant`` asks: the shapes the rules read."""
    from repro_torch.bridge import param_shapes
    dt = cfg.param_torch_dtype

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else torch.empty(v, dtype=dt, device="meta")
                for k, v in tree.items()}
    return quant_lib.quantize_params(walk(param_shapes(cfg)), cfg,
                                     inplace=True)


@functools.lru_cache(maxsize=64)
def _serve_specs(cfg, axis_names: tuple, shape: tuple) -> dict:
    mesh = _Axes(axis_names, dict(zip(axis_names, shape)))
    return params_pspec(cfg, mesh, meta_params(cfg), mode="serve")


class _Axes:
    def __init__(self, axis_names, shape):
        self.axis_names, self.shape = axis_names, shape


def serve_specs(cfg, mesh) -> dict:
    """``params_pspec(cfg, mesh, <the whole tree>, mode="serve")``: the
    specs every serving entry point and layer reads on a mesh (cached per
    config and mesh shape)."""
    return _serve_specs(cfg, tuple(mesh.axis_names),
                        tuple(mesh.shape[a] for a in mesh.axis_names))


def serve_slices(cfg, mesh) -> dict:
    """This rank's ``block_slices`` of every leaf of ``cfg``'s unquantized
    parameter tree under the serve-mode specs (what
    ``Model.init_serving`` keeps of each draw)."""
    fp = cfg.replace(weight_quant="none")
    specs = serve_specs(fp, mesh)

    def walk(tree, spec):
        return {k: walk(v, spec[k]) if isinstance(v, dict)
                else block_slices(v.shape, spec[k], mesh)
                for k, v in tree.items()}
    return walk(meta_params(fp), specs)


def block_bytes(cfg, mesh) -> int:
    """This rank's bytes of the serve-mode blocks of ``cfg``'s weights:
    each leaf's block size times its element size (QuantTensor payload
    and scales alike)."""
    tree = shard_tree(meta_params(cfg), serve_specs(cfg, mesh), mesh)
    return quant_lib.tree_bytes(tree)
