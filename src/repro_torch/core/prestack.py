"""Expert-wise weights prestacking (paper §4.1) — the layout converters of
the JAX package's ``core/prestack.py``, on torch tensors.

The canonical parameter layout is *prestacked*: every weight kind is one
contiguous tensor with leading (L[, E]) axes.  The naive layout keeps a
list of per-layer trees.  These converters serve the checkpoint pipeline
(``ckpt/io.py``, the one-time stacking script).  A ``QuantTensor`` leaf is
sliced, stacked and padded payload and scales together.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant


def _map(fn, *trees):
    """``fn`` over matching leaves of dict trees; a QuantTensor leaf maps
    its payload and its scales (its metadata comes from the first tree)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, quant.QuantTensor):
        return quant.QuantTensor(
            fn(*(t.data for t in trees)), fn(*(t.scale for t in trees)),
            first.bits, first.block, first.orig_dim, first.out_dtype)
    return fn(*trees)


def unstack_blocks(blocks: dict) -> list:
    """Prestacked blocks tree (leading L axis) -> list of per-layer trees."""
    num_layers = next(_tensors(blocks)).shape[0]
    return [_map(lambda a, i=i: a[i], blocks) for i in range(num_layers)]


def stack_blocks(layer_list: list) -> dict:
    """List of per-layer trees -> prestacked tree with a leading L axis."""
    return _map(lambda *a: torch.stack(a), *layer_list)


def stack_experts(expert_list: list) -> dict:
    """List of per-expert {'w_gate', 'w_up', 'w_down'} -> stacked (E, ...)."""
    return _map(lambda *a: torch.stack(a), *expert_list)


def pad_experts(experts: dict, num_padded: int) -> dict:
    """Pad the expert axis with zero (router-dead) experts — granite's
    40 -> 48 padding."""
    e = next(_tensors(experts)).shape[0]
    if e == num_padded:
        return experts
    if e > num_padded:
        raise ValueError(f"{e} experts do not fit {num_padded} padded slots")
    return _map(lambda a: F.pad(a, (0, 0) * (a.dim() - 1)
                                + (0, num_padded - e)), experts)


def quantize_blocks(blocks: dict, level: str = "none", *, block: int = 128,
                    kinds: tuple = quant.DEFAULT_KINDS) -> dict:
    """Quantize a prestacked blocks tree into the blockwise weight store
    (the second half of the one-time preprocessing).  The identity at
    ``level='none'``; quantized leaves pass through."""
    return quant.quantize_tree(blocks, level, block=block, kinds=kinds)


def _tensors(tree):
    """Every tensor of a tree: raw leaves, and a QuantTensor's payload and
    scales."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, quant.QuantTensor):
        yield from (tree.data, tree.scale)
    else:
        yield tree


def validate_roundtrip(blocks: dict) -> bool:
    """stack(unstack(x)) == x."""
    rt = stack_blocks(unstack_blocks(blocks))
    return all(torch.equal(a, b) for a, b in zip(_tensors(blocks),
                                                 _tensors(rt)))
