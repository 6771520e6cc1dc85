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

Training on a mesh stores each rank's ``train`` blocks (``train_specs``)
of the params and of both AdamW moments, and computes with each layer's
``compute_view``: every leaf gathered over the axes its spec cuts it on,
except an expert leaf's expert axis over "model" (the rank keeps its
expert rows, as ``expert_parallel.expert_shard`` cuts them).  Its
backward is the gathers' transpose: over the axes the batch rows are
split on, the gradients are partials, summed into this rank's block
(reduce-scatter) or, for a leaf those axes do not cut, summed whole; over
the others (the ranks computed the same rows, so each holds the whole
gradient) this rank's block is kept, and a leaf that the axis does not
cut takes the mean of its identical copies, so replicas stay equal to
the bit.  ``unshard_tree`` puts whole leaves back together (a
checkpoint).

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

from repro_torch.core import collectives
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
        # mamba2 projections: over "data" only, in train mode
        if name == "in_proj":                     # (L, D, Z) ragged out dim
            return sub(**({"1": fsdp} if fsdp and _dim_ok(shape[1], mesh,
                                                          "data") else {}))
        if name == "out_proj":                    # (L, di, D)
            return sub(**({"2": fsdp} if fsdp and _dim_ok(shape[2], mesh,
                                                          "data") else {}))
        # rg-lru: the channels over "model"
        if name in ("in_x", "in_y"):              # (L, D, W)
            at = {}
            if fsdp and _dim_ok(shape[1], mesh, "data"):
                at["1"] = fsdp
            if _dim_ok(shape[2], mesh, tp):
                at["2"] = tp
            return sub(**at)
        if name in ("gate_a", "gate_x"):          # (L, W, W)
            return sub(**({"2": tp} if _dim_ok(shape[2], mesh, tp) else {}))
        if name == "out":                         # (L, W, D)
            at = {}
            if _dim_ok(shape[1], mesh, tp):
                at["1"] = tp
            if fsdp and _dim_ok(shape[2], mesh, "data"):
                at["2"] = fsdp
            return sub(**at)
        # norms, biases, conv kernels, Lambda, A_log, D, dt_bias, scalars
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
    the axis; ``none``: batch only).  SSM and conv states (every other
    leaf) are cut over the batch only."""
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

# the leaves ``Model.init`` keeps in fp32 whatever the parameter dtype:
# RG-LRU's gate biases and Lambda (``models/rglru.py``), Mamba-2's A_log,
# D and dt_bias (``models/mamba2.py``)
FP32_LEAVES = frozenset({"bias_a", "bias_x", "Lambda", "A_log", "D",
                         "dt_bias"})


def meta_params(cfg) -> dict:
    """The whole parameter tree of ``cfg`` as meta tensors (no storage),
    in the dtypes ``Model.init`` draws and quantized as
    ``cfg.weight_quant`` asks: the shapes and bytes the rules and the
    dry-run read."""
    from repro_torch.bridge import param_shapes
    dt = cfg.param_torch_dtype

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else torch.empty(v, dtype=torch.float32 if k in FP32_LEAVES
                                 else dt, device="meta")
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


def _mesh_key(cfg, mesh) -> tuple:
    return (tuple(mesh.axis_names),
            tuple(mesh.shape[a] for a in mesh.axis_names))


def serve_specs(cfg, mesh) -> dict:
    """``params_pspec(cfg, mesh, <the whole tree>, mode="serve")``: the
    specs every serving entry point and layer reads on a mesh (cached per
    config and mesh shape)."""
    return _serve_specs(cfg, *_mesh_key(cfg, mesh))


@functools.lru_cache(maxsize=64)
def _train_specs(cfg, axis_names: tuple, shape: tuple) -> dict:
    mesh = _Axes(axis_names, dict(zip(axis_names, shape)))
    return params_pspec(cfg, mesh, meta_params(cfg), mode="train")


def train_specs(cfg, mesh) -> dict:
    """``params_pspec(cfg, mesh, <the whole tree>, mode="train")``: the
    blocks a training rank stores of the params and of both AdamW
    moments (``opt_pspec``), cached per config and mesh shape."""
    return _train_specs(cfg.replace(weight_quant="none"),
                        *_mesh_key(cfg, mesh))


def mode_specs(cfg, mesh, mode: str) -> dict:
    if mode not in ("serve", "train"):
        raise ValueError(f"unknown mode {mode!r}; expected serve or train")
    return serve_specs(cfg, mesh) if mode == "serve" else train_specs(
        cfg, mesh)


def mode_slices(cfg, mesh, mode: str) -> dict:
    """This rank's ``block_slices`` of every leaf of ``cfg``'s unquantized
    parameter tree under the ``mode`` specs (what ``Model.init_serving``
    and ``Model.init_training`` keep of each draw)."""
    fp = cfg.replace(weight_quant="none")
    specs = mode_specs(fp, mesh, mode)

    def walk(tree, spec):
        return {k: walk(v, spec[k]) if isinstance(v, dict)
                else block_slices(v.shape, spec[k], mesh)
                for k, v in tree.items()}
    return walk(meta_params(fp), specs)


def draw_keep(cfg, mesh=None) -> dict:
    """The ``keep`` tree with which ``Model.init`` stores the weights as
    ``cfg.weight_quant`` asks, each matrix quantized as it is drawn: a
    ``quant.Sink`` at every leaf ``quantize_params`` converts.  On a
    serving ``mesh`` every other leaf takes this rank's serve block
    (``mode_slices``), and each sink keeps the leaf's leading-axis block
    and cuts every quantized matrix as ``shard_tree`` cuts the whole
    (``_cut_quant``, axis by axis), so the rank's blocks equal
    ``shard_tree(quantize_params(init(gen)), serve_specs, mesh)``."""
    slices = (mode_slices(cfg, mesh, "serve") if mesh is not None
              else None)
    specs = serve_specs(cfg, mesh) if mesh is not None else None

    def sink(leaf: QuantTensor, spec) -> quant_lib.Sink:
        level, block = cfg.weight_quant, cfg.weight_quant_block
        if mesh is None:
            return quant_lib.Sink(level, block)
        lead = block_slices(leaf.data.shape, spec["data"], mesh)[:-2]
        one = {k: v[-2:] for k, v in spec.items()}
        return quant_lib.Sink(level, block, lead + (slice(None),) * 2,
                              functools.partial(_cut_quant, spec=one,
                                                mesh=mesh))

    def walk(tree, sl, sp):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, sl and sl[k], sp and sp[k])
            elif isinstance(v, QuantTensor):
                out[k] = sink(v, sp and sp[k])
            elif sl is not None:
                out[k] = sl[k]
        return out
    return walk(meta_params(cfg), slices, specs)


def draw_peak_bytes(cfg) -> int:
    """The most memory ``Model.init_serving(gen)`` may hold while it
    draws ``cfg``'s weights on one device, quantizing each as drawn: the
    store (``quant.tree_bytes``; ``perf_model.model_weight_bytes``) plus
    one matrix's transients, which are the largest fp32 matrix drawn (4 B
    an element of the last two axes of any leaf; the embedding (V, D) is
    drawn whole, before anything else) and one column chunk's
    temporaries (16 B an element of the largest chunk, K rounded up to
    whole blocks: the chunk in the param dtype (2 B), its fp32 copy, the
    quotient and its rounding (4 B each), the codes (1 B) and the last
    chunk's codes and scales)."""
    store = meta_params(cfg)
    mat = max(math.prod(v.shape[-2:]) for v in _leaves(meta_params(
        cfg.replace(weight_quant="none"))))
    chunk = max((-(-v.orig_dim // v.block) * v.block
                 * min(v.data.shape[-1],
                       quant_lib.chunk_cols(v.orig_dim))
                 for v in _leaves(store) if isinstance(v, QuantTensor)),
                default=0)
    return quant_lib.tree_bytes(store) + 4 * mat + 16 * chunk


def serve_peak_bytes(cfg, *, rows: int, chunk_len: int,
                     pool_bytes: int) -> int:
    """The most memory a one-device serve of ``cfg`` (weights already
    stored, quantized as ``cfg`` says) may hold over its store and page
    pool (``pool_bytes``) while it steps ``rows`` rows of up to
    ``chunk_len`` tokens each: the store, plus the pool, plus the largest
    transient of a weight product, plus the step's activations.

    * A quantized matrix (K, N) is dequantized a column block at a time
      (``quant.qdot`` / ``qdot_f32``): 16 B an element of the largest
      block (``quant.block_cols``, about ``quant.BLOCK_BYTES`` in all)
      covers its unpacked and padded codes (1 B each), their fp32 product
      with the scales and its rounding (4 + 4 B), the block in the
      weights' dtype (2 B) and its fp32 copy (``quant.dot_f32``).
    * A decode step of at most ``cfg.gather_decode_max_tk`` selections
      gathers each selected expert matrix in the weights' dtype
      (``moe.gather_moe``): R = rows * K matrices of one stack, plus their
      gathered payload and scales, plus one block's dequantize
      temporaries or fp32 copy (``quant.dot_f32``), at most
      ``quant.BLOCK_BYTES``.
    * Activations: the prefill step's T = rows * chunk_len tokens, 64 B a
      token and unit of the widest of D, F and the heads' width (the
      residual, normed and projected rows, q, k, v and attention output,
      g, u, h in up to fp32), the capacity buffers of a dispatch (x, ye
      and its padded copy in D, h in F, at ``cfg.capacity_factor``), the
      decisions' rows (T, K, D) twice, and the fp32 logits of the rows
      twice."""
    store = meta_params(cfg)
    elt = cfg.torch_dtype.itemsize
    mats = [v for v in _leaves(store) if isinstance(v, QuantTensor)]
    block = max((16 * -(-v.orig_dim // v.block) * v.block
                 * min(v.data.shape[-1], quant_lib.block_cols(v.orig_dim))
                 for v in mats), default=0)
    transient = block
    if cfg.is_moe and rows * cfg.experts_per_token <= \
            cfg.gather_decode_max_tk:
        sel = rows * cfg.experts_per_token
        for w in store["blocks"]["experts"].values():
            mat = math.prod(w.shape[-2:]) * cfg.param_torch_dtype.itemsize
            packed = (quant_lib.tree_bytes({"w": w[0, 0]})
                      if isinstance(w, QuantTensor) else 0)
            transient = max(transient, sel * (mat + packed) + min(
                16 * sel * math.prod(w.shape[-2:]), quant_lib.BLOCK_BYTES))
    tokens = rows * chunk_len
    width = max(cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim)
    act = 64 * tokens * width + 8 * rows * cfg.vocab_padded
    if cfg.is_moe:
        from repro_torch.core import moe as moe_lib
        cap = moe_lib.round_capacity(tokens, cfg.experts_per_token,
                                     cfg.num_experts_padded,
                                     cfg.capacity_factor)
        act += elt * cfg.num_experts_padded * cap * (3 * cfg.d_model
                                                     + cfg.d_ff)
        act += 2 * elt * tokens * cfg.experts_per_token * cfg.d_model
    return quant_lib.tree_bytes(store) + pool_bytes + transient + act


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def block_bytes(cfg, mesh, mode: str = "serve") -> int:
    """This rank's bytes of the ``mode`` blocks of ``cfg``'s weights:
    each leaf's block size times its element size (QuantTensor payload
    and scales alike)."""
    tree = shard_tree(meta_params(cfg), mode_specs(cfg, mesh, mode), mesh)
    return quant_lib.tree_bytes(tree)


# ---------------------------------------------------------------------------
# training on a mesh: the compute view of the train blocks
# ---------------------------------------------------------------------------

def layer_spec(spec):
    """The spec tree of one layer of a layer-stacked spec tree (the
    leading layer axis, never cut, dropped)."""
    if isinstance(spec, dict):
        return {k: layer_spec(v) for k, v in spec.items()}
    if spec[0] is not None:
        raise ValueError(f"a layer-stacked leaf cut on its layer axis: {spec}")
    return spec[1:]


def _flat_leaves(tree, spec, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], spec[k], path + (k,))
    else:
        yield path, tree, spec


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in sorted(tree)}
    return next(values)


class _ComputeView(torch.autograd.Function):
    """Blocks -> compute views, one packed all-gather per axis; the
    backward is their transpose (see the module docstring)."""

    @staticmethod
    def forward(ctx, mesh, plan, order, varying, *blocks):
        ctx.plan, ctx.mesh, ctx.order, ctx.varying = plan, mesh, order, varying
        views = list(blocks)
        for axis in order:
            idx = [i for i, (cuts, _) in enumerate(plan) if axis in cuts]
            got = collectives.all_gather_packed(
                [views[i] for i in idx], mesh, axis,
                [plan[i][0][axis] for i in idx], collectives.PARAM_GATHER)
            for i, v in zip(idx, got):
                views[i] = v
        return tuple(v.view_as(v) for v in views)

    @staticmethod
    def backward(ctx, *grads):
        mesh, plan = ctx.mesh, ctx.plan
        grads = list(grads)
        for axis in reversed(ctx.order):
            if mesh.groups[axis] is None:
                continue
            cut = [i for i, (cuts, _) in enumerate(plan) if axis in cuts]
            whole = [i for i, (cuts, kept) in enumerate(plan)
                     if axis not in cuts and axis not in kept]
            if axis in ctx.varying:
                got = collectives.psum_scatter_packed(
                    [grads[i] for i in cut], mesh, axis,
                    [plan[i][0][axis] for i in cut], collectives.GRAD_REDUCE)
            else:
                got = [collectives.local_block(grads[i], mesh, axis,
                                               plan[i][0][axis]).contiguous()
                       for i in cut]
            got += collectives.psum_packed(
                [grads[i] for i in whole], mesh, axis,
                collectives.GRAD_REDUCE, mean=axis not in ctx.varying)
            for i, g in zip(cut + whole, got):
                grads[i] = g
        return (None, None, None, None) + tuple(grads)


def compute_view(tree: dict, spec: dict, mesh, varying: tuple = ()) -> dict:
    """The leaves of ``tree`` (this rank's train blocks; ``spec`` their
    specs) as the forward computes with them: gathered over every axis
    their spec cuts, the axes in ``varying`` (the batch axes the rows are
    split over) first, except an expert leaf's "model" axis.  Packed:
    one exchange per axis, and in the backward one or two (reduce-scatter
    and sum over a varying axis; the mean of the uncut leaves over
    another)."""
    leaves = list(_flat_leaves(tree, spec))
    plan = []
    for path, leaf, sp in leaves:
        cuts = {}
        for dim, entry in enumerate(sp):
            axes = _axes(entry)
            if len(axes) > 1:
                raise ValueError(f"{'/'.join(path)}: a dimension cut over "
                                 f"several axes {axes}")
            if axes and mesh.shape[axes[0]] > 1:
                cuts[axes[0]] = dim
        kept = ("model",) if "experts" in path else ()
        if kept:
            cuts.pop("model", None)
        plan.append((cuts, kept))
    order = tuple(a for a in mesh.axis_names if a in varying) + tuple(
        a for a in mesh.axis_names if a not in varying)
    views = _ComputeView.apply(mesh, tuple(plan), order, tuple(varying),
                               *[leaf for _, leaf, _ in leaves])
    return _rebuild(tree, iter(views))


@torch.no_grad()
def unshard_tree(tree: dict, spec: dict, mesh) -> dict:
    """Whole leaves from every rank's blocks (each dimension gathered over
    its axes, the fastest first); every rank gets them."""
    def whole(leaf, sp):
        for dim, entry in enumerate(sp):
            for axis in reversed(_axes(entry)):
                leaf = collectives.all_gather(leaf, mesh, axis, dim)
        return leaf

    def walk(t, sp):
        if isinstance(t, dict):
            return {k: walk(v, sp[k]) for k, v in t.items()}
        return whole(t, sp)
    return walk(tree, spec)
