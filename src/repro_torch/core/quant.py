"""Blockwise int8/int4 quantized weight store (the JAX package's
``core/quant.py``, without JAX).

* ``QuantTensor`` — an int8 payload (int4: two values packed per byte
  along the reduction axis) plus fp32 scales, one per ``block`` rows of the
  reduction axis (-2) and column.  Leading axes (layer stack L, expert
  axis E) are ordinary batch axes of both, so ``v[l]`` slices a layer and
  ``w[idx]`` gathers experts without touching the reduction axis.
* ``absmax_quantize`` / ``absmax_dequantize`` — the one numeric policy:
  per block, scale = absmax / qmax and q = round(x / max(scale, 1e-20)),
  computed in fp32 (``torch.round`` rounds half to even, as ``jnp.round``
  does).  ``models/attention.quantize_kv`` wraps it with one block over hd.
* ``qdot`` — the weight-matmul policy point: a raw tensor multiplies as it
  is, a ``QuantTensor`` is dequantized a column block at a time
  (``BLOCK_BYTES``) and each block multiplied into a preallocated
  output, so no whole matrix is ever dequantized.  ``qdot_f32`` is the
  same with fp32 output (the LM head), ``dot_f32`` the product of two
  raw operands with fp32 output, on fp32 copies of the operands, the
  weight's a column block at a time: no fp32 copy of a whole weight.
* ``quantize_tree`` / ``quantize_params`` — quantize a tree: eligible
  weight kinds (``attn``, ``mlp``, ``experts``, ``lm_head`` by default;
  router and embedding stay fp) become ``QuantTensor`` leaves.  A stacked
  leaf is quantized one matrix at a time, each matrix a chunk of columns
  at a time (each block runs along axis -2 within a column, so slicing
  is exact), and ``inplace=True`` drops each fp leaf from its dict as
  soon as its replacement exists.
* ``Sink`` — quantize-on-draw, the load path: ``models/layers.dense_init``
  hands each matrix it draws to a sink, which rounds it to the param
  dtype and quantizes it into a preallocated ``QuantTensor`` stack
  (``empty``, ``quantize_into``).  The store is ``quantize_params`` of
  the drawn tree bit for bit, and the load never holds a leaf in the
  param dtype: its peak is the store plus one fp32 matrix and a column
  chunk's temporaries.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.configs.base import torch_dtype

# symmetric ranges: int8 uses [-127, 127]; int4 stays in [-7, 7] so both
# nibbles sign-extend identically
QMAX = {8: 127, 4: 7}
LEVELS = ("none", "int8", "int4")
BITS = {"int8": 8, "int4": 4}
DEFAULT_KINDS = ("attn", "mlp", "experts", "lm_head")
WEIGHT_NAMES = ("w_gate", "w_up", "w_down", "wq", "wk", "wv", "wo",
                "lm_head", "router", "embed")


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """Blockwise-quantized weight.

    ``data``:  int8 payload; int8 keeps the logical shape, int4 packs two
               values per byte along axis -2 (``ceil(K / 2)`` rows).
    ``scale``: fp32, the logical shape with axis -2 replaced by the block
               count ``ceil(K / block)``.
    ``orig_dim``: the logical size K of axis -2; ``out_dtype``: the dtype
               name ``dequantize`` targets by default (the fp weight's).
    """
    data: torch.Tensor
    scale: torch.Tensor
    bits: int
    block: int
    orig_dim: int
    out_dtype: str

    @property
    def shape(self) -> tuple:
        """The LOGICAL (unpacked) shape."""
        s = list(self.data.shape)
        s[-2] = self.orig_dim
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.out_dtype)

    def __getitem__(self, idx) -> "QuantTensor":
        """Leading-axis indexing or gather: payload and scales together."""
        return QuantTensor(self.data[idx], self.scale[idx], self.bits,
                           self.block, self.orig_dim, self.out_dtype)

    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def matrices(self) -> "QuantTensor":
        """The stack as (n, ., .): its leading axes flattened into one
        (views of the payload and scales; a matrix is n = 1)."""
        return QuantTensor(self.data.reshape((-1,) + self.data.shape[-2:]),
                           self.scale.reshape((-1,) + self.scale.shape[-2:]),
                           self.bits, self.block, self.orig_dim,
                           self.out_dtype)


def _pad_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    if x.shape[axis] == size:
        return x
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def absmax_quantize(x: torch.Tensor, *, bits: int = 8,
                    block: int | None = None, axis: int = -1):
    """Per-block symmetric quantization along ``axis`` (zero-padded to whole
    blocks).  Returns (q int8 with ``axis`` padded to whole blocks, scale
    fp32 with ``axis`` replaced by the block count)."""
    axis = axis % x.ndim
    k = x.shape[axis]
    block = block or k
    nb = -(-k // block)
    xf = _pad_axis(x.float(), axis, nb * block)
    xb = xf.reshape(xf.shape[:axis] + (nb, block) + xf.shape[axis + 1:])
    # a true division, as the reference's: on CUDA, dividing by a Python
    # number multiplies by its fp32 reciprocal, which can move the last bit
    qmax = torch.full((), QMAX[bits], dtype=torch.float32, device=x.device)
    scale = xb.abs().amax(dim=axis + 1) / qmax
    q = torch.round(xb / torch.clamp(scale.unsqueeze(axis + 1), min=1e-20))
    return q.to(torch.int8).reshape(xf.shape), scale


def absmax_dequantize(q: torch.Tensor, scale: torch.Tensor, *, block: int,
                      axis: int = -1, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``absmax_quantize``: each value times its block's scale,
    in fp32, then cast to ``dtype``; ``q`` may stop short of whole blocks."""
    axis = axis % q.ndim
    k, nb = q.shape[axis], scale.shape[axis]
    qp = _pad_axis(q, axis, nb * block)
    qb = qp.reshape(qp.shape[:axis] + (nb, block) + qp.shape[axis + 1:])
    out = (qb.float() * scale.unsqueeze(axis + 1)).to(dtype)
    out = out.reshape(qp.shape)
    return out if qp.shape[axis] == k else out.narrow(axis, 0, k)


def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """int8 values in [-7, 7] -> packed int8: element 2i in the low nibble,
    2i+1 in the high nibble, along ``axis``; an odd extent is zero-padded."""
    axis = axis % q.ndim
    k = q.shape[axis]
    q = _pad_axis(q, axis, k + k % 2)
    pairs = q.reshape(q.shape[:axis] + (q.shape[axis] // 2, 2)
                      + q.shape[axis + 1:]).view(torch.uint8)
    lo = pairs.select(axis + 1, 0)
    hi = pairs.select(axis + 1, 1)
    return ((lo & 0xF) | ((hi & 0xF) << 4)).view(torch.int8)


def unpack_int4(p: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Packed int8 -> int8 values, doubling ``axis``.  ``>>`` on int8 is
    an arithmetic shift, so it sign-extends each nibble: the high one
    straight, the low one after ``<< 4`` has moved it to the top."""
    axis = axis % p.ndim
    lo = (p << 4) >> 4
    hi = p >> 4
    pairs = torch.stack([lo, hi], dim=axis + 1)
    return pairs.reshape(p.shape[:axis] + (2 * p.shape[axis],)
                         + p.shape[axis + 1:])


def _quantize_payload(w: torch.Tensor, bits: int, block: int):
    k = w.shape[-2]
    q, scale = absmax_quantize(w, bits=bits, block=block, axis=-2)
    q = q.narrow(-2, 0, k)                          # drop block padding
    if bits == 4:
        q = pack_int4(q, axis=-2)
    return q.contiguous(), scale


# a matrix is quantized a chunk of about this many elements (whole
# columns) at a time, so its temporaries stay a few hundred MB
CHUNK_ELEMS = 1 << 24


def _bits(level: str, block: int) -> int:
    if level not in BITS:
        raise ValueError(f"unknown weight_quant level {level!r}; "
                         f"expected one of {LEVELS}")
    if BITS[level] == 4 and block % 2:
        raise ValueError(f"int4 packing needs an even block, got {block}")
    return BITS[level]


def empty(shape: tuple, level: str, block: int, dtype,
          device) -> QuantTensor:
    """An unfilled QuantTensor of logical shape (*lead, K, N) for a weight
    of ``dtype``: the payload and scales ``quantize`` gives, allocated."""
    bits = _bits(level, block)
    *lead, k, n = shape
    rows = -(-k // 2) if bits == 4 else k
    return QuantTensor(
        torch.empty((*lead, rows, n), dtype=torch.int8, device=device),
        torch.empty((*lead, -(-k // block), n), dtype=torch.float32,
                    device=device),
        bits, block, k, str(dtype).split(".")[-1])


def chunk_cols(k: int) -> int:
    """Columns of a K-deep matrix in one chunk of ``CHUNK_ELEMS``."""
    return max(1, CHUNK_ELEMS // max(k, 1))


# a served product dequantizes a QuantTensor, or copies a weight to fp32,
# a block of whole columns at a time whose temporaries take about this
# many bytes (a dequantize about 16 B an element, an fp32 copy 4 B), so a
# step launches a few blocks a matrix
BLOCK_BYTES = 1 << 30


def block_cols(k: int, elem_bytes: int = 16) -> int:
    """Columns of a K-deep matrix in one block of ``BLOCK_BYTES`` at
    ``elem_bytes`` of temporaries an element."""
    return max(1, BLOCK_BYTES // (elem_bytes * max(k, 1)))


def quantize_into(dst: QuantTensor, w: torch.Tensor) -> None:
    """Quantize the matrix ``w`` (K, N) into ``dst``, one matrix (a view
    of a stack's payload and scales), a chunk of whole columns at a time.
    Each chunk is rounded to ``dst``'s dtype first (nothing to do where
    ``w`` has it), so an fp32 draw is quantized as the param-dtype matrix
    it rounds to without a rounded copy of the whole.  Blocks run along
    axis -2 within a column, so the chunks give the bytes the matrix
    quantized whole gives."""
    k, n = w.shape
    step = chunk_cols(k)
    for c in range(0, n, step):
        q, scale = _quantize_payload(w[:, c:c + step].to(dst.dtype),
                                     dst.bits, dst.block)
        dst.data[:, c:c + step] = q
        dst.scale[:, c:c + step] = scale


def quantize(w: torch.Tensor, level: str = "int8", *,
             block: int = 128) -> QuantTensor:
    """Quantize a weight (reduction axis -2) into a QuantTensor, one
    (K, N) matrix at a time into preallocated payload and scales
    (``quantize_into``): the fp32 temporaries stay a column chunk big,
    and the result is the same as quantizing it whole.  A meta weight
    gets the meta payload and scales (the shapes alone)."""
    out = empty(w.shape, level, block, w.dtype, w.device)
    if w.device.type == "meta":
        return out
    mats = out.matrices()
    for i, idx in enumerate(itertools.product(*map(range, w.shape[:-2]))):
        quantize_into(mats[i], w[idx])
    return out


@dataclasses.dataclass(frozen=True)
class Sink:
    """How ``models/layers.dense_init`` stores a weight that is kept
    quantized: each drawn (K, N) matrix, in fp32, is rounded to the param
    dtype and quantized at once (``quantize_into``) into a preallocated
    stack.  ``keep``: the block of (*lead, K, N) to store, as
    ``dense_init`` reads it, its last two axes whole; ``cut``: a function
    from one quantized matrix to the part of it this rank keeps (the
    serve cut of ``launch/sharding.py``), or None for all of it."""
    level: str
    block: int
    keep: tuple | None = None
    cut: object = None

    def empty(self, lead: tuple, k: int, n: int, dtype,
              device) -> QuantTensor:
        """The unfilled stack of ``lead`` kept matrices."""
        one = empty((k, n), self.level, self.block, dtype, "meta")
        if self.cut is not None:
            one = self.cut(one)
        return QuantTensor(
            torch.empty(lead + tuple(one.data.shape), dtype=torch.int8,
                        device=device),
            torch.empty(lead + tuple(one.scale.shape), dtype=torch.float32,
                        device=device),
            one.bits, one.block, one.orig_dim, one.out_dtype)

    def put(self, dst: QuantTensor, w: torch.Tensor) -> None:
        """Quantize the drawn matrix ``w`` into ``dst``, one matrix of the
        stack (through the whole quantized matrix where it is cut)."""
        if self.cut is None:
            quantize_into(dst, w)
            return
        whole = empty(w.shape, self.level, self.block, dst.dtype, w.device)
        quantize_into(whole, w)
        part = self.cut(whole)
        dst.data.copy_(part.data)
        dst.scale.copy_(part.scale)


def cat(ws: list, dim: int):
    """``torch.cat`` of tensors, or of QuantTensors of one layout along a
    leading axis (payload and scales alike)."""
    w = ws[0]
    if not isinstance(w, QuantTensor):
        return torch.cat(ws, dim=dim)
    return QuantTensor(torch.cat([v.data for v in ws], dim=dim),
                       torch.cat([v.scale for v in ws], dim=dim), w.bits,
                       w.block, w.orig_dim, w.out_dtype)


def dequantize(qt: QuantTensor, dtype=None) -> torch.Tensor:
    """QuantTensor -> dense weight in ``dtype`` (default: the fp weight's
    own dtype, so raw and quantized leaves are interchangeable)."""
    v = qt.data
    if qt.bits == 4:
        v = unpack_int4(v, axis=-2)
    if v.shape[-2] != qt.orig_dim:
        v = v.narrow(-2, 0, qt.orig_dim)
    return absmax_dequantize(v, qt.scale, block=qt.block, axis=-2,
                             dtype=dtype or qt.dtype)


def materialize(w, dtype=None) -> torch.Tensor:
    """Dequantize a QuantTensor (to ``dtype``, default its own fp dtype);
    a raw tensor passes through."""
    return dequantize(w, dtype) if isinstance(w, QuantTensor) else w


def columns(w, c0: int, c1: int):
    """Columns [c0, c1) of a raw weight or a QuantTensor (its payload and
    scales alike: the quant blocks run along axis -2, so a column slice
    is exact)."""
    if isinstance(w, QuantTensor):
        return QuantTensor(w.data[..., c0:c1], w.scale[..., c0:c1], w.bits,
                           w.block, w.orig_dim, w.out_dtype)
    return w[..., c0:c1]


def dequantize_into(dst: torch.Tensor, qt: QuantTensor) -> None:
    """``dequantize(qt, dst.dtype)`` written into ``dst`` (the logical
    shape) a block (``BLOCK_BYTES``) at a time: as many whole matrices as
    a block holds, or a matrix a column block at a time where one matrix
    is larger, so its temporaries stay one block big whatever the stack
    holds."""
    mats, out = qt.matrices(), dst.reshape((-1,) + tuple(dst.shape[-2:]))
    n, k, cols = out.shape
    step = block_cols(k)
    per = max(1, step // cols)                 # whole matrices a block
    for i in range(0, n, per):
        if step >= cols:
            out[i:i + per] = dequantize(mats[i:i + per], dst.dtype)
            continue
        for c in range(0, cols, step):
            out[i, :, c:c + step] = dequantize(
                columns(mats[i], c, c + step), dst.dtype)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with fp32 output, the reference's
    ``preferred_element_type=float32``: ``x`` (..., K) by a matrix ``w``
    (K, N), or (B, M, K) by a stack (B, K, N).  The products run on fp32
    copies of the operands (IEEE fp32 FMA), the weight's copied a column
    block of ``BLOCK_BYTES`` at a time into a preallocated output, so no
    fp32 copy of a whole weight is made; a weight within one block
    multiplies whole, today's plain form.  (cuBLAS's bf16 product with an
    fp32 output, ``mm(..., out_dtype=float32)``, needs no copy at all, but
    accumulates on the tensor cores with about twenty times the rounding
    error of IEEE fp32, enough to move the served streams' near-ties.)"""
    xf = x.float()
    n = w.shape[-1]
    step = block_cols(w.numel() // max(n, 1), elem_bytes=4)
    if step >= n:
        return xf @ w.float()
    out = torch.empty(xf.shape[:-1] + (n,), dtype=torch.float32,
                      device=x.device)
    for c in range(0, n, step):
        out[..., c:c + step] = xf @ w[..., c:c + step].float()
    return out


def _blocked(x: torch.Tensor, w: QuantTensor | torch.Tensor, dtype,
             out_dtype, mul) -> torch.Tensor:
    """``mul(x, block)`` for each column block of ``w`` taken in ``dtype``
    (dequantized, or cast), written into a preallocated (..., N) output of
    ``out_dtype``: the transient is one block, not the whole matrix."""
    k, n = w.shape[-2:]
    out = torch.empty(x.shape[:-1] + (n,), dtype=out_dtype, device=x.device)
    step = block_cols(k)
    for c in range(0, n, step):
        out[..., c:c + step] = mul(x, materialize(columns(w, c, c + step),
                                                  dtype).to(dtype))
    return out


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a raw weight; for a QuantTensor ``x @ dequantize(w)``
    (to its own fp dtype, as the reference's ``qdot`` does), a column
    block at a time into the output (each output column is the same dot
    product as over the whole dequantized matrix)."""
    if not isinstance(w, QuantTensor):
        return x @ w
    return _blocked(x, w, w.dtype, torch.promote_types(x.dtype, w.dtype),
                    torch.matmul)


def qdot_f32(x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """fp32 ``x @ w`` with the weight taken in ``dtype`` (default its own):
    the reference's ``qdot(..., weight_dtype=, preferred_element_type=
    float32)``.  A raw weight already in ``dtype`` goes to ``dot_f32``; a
    QuantTensor, or a weight to cast, is taken in ``dtype`` a column block
    at a time into a preallocated fp32 output."""
    dtype = dtype or w.dtype
    if not isinstance(w, QuantTensor) and w.dtype == dtype:
        return dot_f32(x, w)
    return _blocked(x, w, dtype, torch.float32, dot_f32)


def classify_weight(names: list[str]) -> str | None:
    """A params-tree path -> its weight kind, or None for leaves the store
    never touches (norms, biases)."""
    name = names[-1]
    if name not in WEIGHT_NAMES:
        return None
    if name in ("embed", "lm_head", "router"):
        return name
    if name in ("wq", "wk", "wv", "wo"):
        return "attn"
    return "experts" if "experts" in names else "mlp"


def quantize_tree(params: dict, level: str, *, block: int = 128,
                  kinds: tuple = DEFAULT_KINDS,
                  inplace: bool = False) -> dict:
    """Convert eligible weight leaves of ``params`` to QuantTensor.

    ``level='none'`` is the identity; QuantTensor leaves pass through.
    Only >= 2-D leaves whose path classifies into ``kinds`` convert; the
    embedding is refused (it is read by row gather, not a matmul).
    ``inplace=True`` replaces the leaves in ``params``' own dicts one at a
    time and returns ``params``, so each fp leaf is freed as soon as it is
    quantized (when nothing else holds it)."""
    if level == "none":
        return params
    if "embed" in kinds:
        raise ValueError("the embedding is consumed by row gather, not a "
                         "qdot matmul: it must stay fp")

    def walk(tree: dict, path: list[str]) -> dict:
        out = tree if inplace else {}
        for key in list(tree):
            leaf = tree[key]
            names = path + [key]
            if isinstance(leaf, dict):
                leaf = walk(leaf, names)
            elif (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                  and classify_weight(names) in kinds):
                leaf = quantize(leaf, level, block=block)
            out[key] = leaf
        return out

    return walk(params, [])


def quantize_params(params: dict, cfg, *, inplace: bool = False) -> dict:
    """Apply ``cfg.weight_quant`` / ``weight_quant_block`` /
    ``weight_quant_kinds`` to a params tree (the engine's quantize-on-load
    entry point)."""
    return quantize_tree(params, cfg.weight_quant,
                         block=cfg.weight_quant_block,
                         kinds=tuple(cfg.weight_quant_kinds),
                         inplace=inplace)


def dequantize_tree(tree: dict, dtype=None) -> dict:
    """Every QuantTensor leaf of ``tree`` dense again (to ``dtype``,
    default its own fp dtype); other leaves pass through.  Served as raw
    fp params it is the fake-quant reference: it holds exactly the values
    the quantized store dequantizes on the fly, so a quantized engine's
    greedy tokens must be its argmaxes."""
    return {k: dequantize_tree(v, dtype) if isinstance(v, dict)
            else materialize(v, dtype) if isinstance(v, QuantTensor) else v
            for k, v in tree.items()}


def tree_bytes(tree: dict) -> int:
    """Bytes of a tree's tensors; a QuantTensor counts payload plus scales."""
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += tree_bytes(v)
        elif isinstance(v, QuantTensor):
            total += v.nbytes()
        else:
            total += v.numel() * v.element_size()
    return total
