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
  is, a ``QuantTensor`` is dequantized first.
* ``quantize_tree`` / ``quantize_params`` — quantize-on-load: eligible
  weight kinds (``attn``, ``mlp``, ``experts``, ``lm_head`` by default;
  router and embedding stay fp) become ``QuantTensor`` leaves.  A stacked
  leaf is quantized one leading-axis slice at a time (each block runs
  along axis -2, so slicing is exact), and ``inplace=True`` drops each fp
  leaf from its dict as soon as its replacement exists: a full-width
  model then needs its fp tree plus one leaf's payload, not two trees.
"""
from __future__ import annotations

import dataclasses

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
    return out.reshape(qp.shape).narrow(axis, 0, k)


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
    """Packed int8 -> int8 values, doubling ``axis``.  Goes through uint8:
    ``>>`` on int8 is an arithmetic shift."""
    axis = axis % p.ndim
    u = p.view(torch.uint8)
    lo = (u & 0xF).to(torch.int8)
    hi = (u >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
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


def quantize(w: torch.Tensor, level: str = "int8", *,
             block: int = 128) -> QuantTensor:
    """Quantize a weight (reduction axis -2) into a QuantTensor.  A stacked
    weight (ndim > 2) is quantized one leading-axis slice at a time, into
    preallocated payload and scales: the fp32 temporaries stay one slice
    big, and the result is the same as quantizing it whole."""
    if level not in BITS:
        raise ValueError(f"unknown weight_quant level {level!r}; "
                         f"expected one of {LEVELS}")
    bits = BITS[level]
    if bits == 4 and block % 2:
        raise ValueError(f"int4 packing needs an even block, got {block}")
    k = w.shape[-2]
    dtype_name = str(w.dtype).split(".")[-1]
    if w.ndim <= 2:
        q, scale = _quantize_payload(w, bits, block)
        return QuantTensor(q, scale, bits, block, k, dtype_name)
    rows = -(-k // 2) if bits == 4 else k
    q = torch.empty(w.shape[:-2] + (rows, w.shape[-1]), dtype=torch.int8,
                    device=w.device)
    scale = torch.empty(w.shape[:-2] + (-(-k // block), w.shape[-1]),
                        dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize_payload(w[i], bits, block)
    return QuantTensor(q, scale, bits, block, k, dtype_name)


def dequantize(qt: QuantTensor, dtype=None) -> torch.Tensor:
    """QuantTensor -> dense weight in ``dtype`` (default: the fp weight's
    own dtype, so raw and quantized leaves are interchangeable)."""
    v = qt.data
    if qt.bits == 4:
        v = unpack_int4(v, axis=-2)
    v = v.narrow(-2, 0, qt.orig_dim)
    return absmax_dequantize(v, qt.scale, block=qt.block, axis=-2,
                             dtype=dtype or qt.dtype)


def materialize(w, dtype=None) -> torch.Tensor:
    """Dequantize a QuantTensor (to ``dtype``, default its own fp dtype);
    a raw tensor passes through."""
    return dequantize(w, dtype) if isinstance(w, QuantTensor) else w


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a raw weight, ``x @ dequantize(w)`` for a QuantTensor
    (to its own fp dtype, as the reference's ``qdot`` does)."""
    return x @ materialize(w)


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
