"""Checkpointing: flat-key npz save/restore and the prestacking converter
(the JAX package's ``ckpt/io.py``, on torch tensors).

The file format is the reference's: one npz entry per leaf under its
``//``-joined path, ``__step__`` beside them, and each QuantTensor leaf as
three sibling entries (``<key>//__qt_data__``, ``//__qt_scale__``,
``//__qt_meta__``): payload, scales, and the static metadata
``[bits, block, orig_dim, out-dtype index]``.

A bf16 leaf is written as the reference writes it: numpy has no bfloat16,
so the npz holds it as a 2-byte void (``|V2``) with the bf16 bits.  The
port takes those bits through a ``uint16`` view and reads every ``|V2``
entry back as ``torch.bfloat16``; neither step needs ``ml_dtypes``.  (The
reference's own ``restore`` hands the ``|V2`` array to ``jnp.asarray``,
which refuses it: ROADMAP queue C.)

On a mesh (training, ``launch/sharding.train_specs``) ``save`` gathers
every rank's blocks and rank 0 writes the whole tree, the file the
one-device trainer writes; ``restore`` reads the whole file and keeps this
rank's blocks.

The converter is the paper's one-time stacking script (§4.1): an
unstacked checkpoint (one entry per layer / per expert) becomes the
prestacked layout, with granite-style expert padding and, with
``weight_quant``, the blockwise quantized store in the same pass.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import prestack, quant
from repro_torch.launch import sharding
from repro_torch.models.model import resolve_device

SEP = "//"

_QT_DATA, _QT_SCALE, _QT_META = "__qt_data__", "__qt_scale__", "__qt_meta__"
# dtypes a QuantTensor may dequantize to, indexed by the meta record
_QT_DTYPES = ("float32", "bfloat16", "float16", "float64")
_BF16_NPZ = np.dtype("V2")


def flatten_tree(tree: dict) -> dict:
    """Nested dict -> {"a//b//c": leaf}, keys in sorted order; a
    QuantTensor becomes its three sibling entries (the meta as numpy)."""
    flat = {}

    def rec(t, path):
        if isinstance(t, quant.QuantTensor):
            flat[SEP.join(path + [_QT_DATA])] = t.data
            flat[SEP.join(path + [_QT_SCALE])] = t.scale
            flat[SEP.join(path + [_QT_META])] = np.asarray(
                [t.bits, t.block, t.orig_dim,
                 _QT_DTYPES.index(t.out_dtype)], np.int64)
        elif isinstance(t, dict):
            for k in sorted(t):
                rec(t[k], path + [str(k)])
        else:
            flat[SEP.join(path)] = t

    rec(tree, [])
    return flat


def unflatten_tree(flat: dict) -> dict:
    """Inverse of ``flatten_tree``: the QuantTensor triples become
    QuantTensors again."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if _QT_DATA in node:
            meta = np.asarray(node[_QT_META])
            return quant.QuantTensor(
                node[_QT_DATA], node[_QT_SCALE], int(meta[0]), int(meta[1]),
                int(meta[2]), _QT_DTYPES[int(meta[3])])
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(tree)


def to_npz_array(t) -> np.ndarray:
    """A leaf as the npz entry the reference writes: bf16 as ``|V2``."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(_BF16_NPZ)
    return t.numpy()


def from_npz_array(a: np.ndarray, device) -> torch.Tensor:
    """An npz entry as a tensor on ``device``: ``|V2`` as bf16."""
    if a.dtype == _BF16_NPZ:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def save(path: str, params: dict, step: int = 0, mesh=None,
         spec: dict | None = None) -> None:
    """Write ``params`` (on any device) as a flat-key npz; each leaf is
    copied to the host one at a time.  On a ``mesh`` (every rank calls
    it) ``params`` are this rank's blocks under ``spec``: they are
    gathered whole, rank 0 writes, and every rank returns once the file
    is written."""
    write = True
    if mesh is not None:
        params = sharding.unshard_tree(params, spec, mesh)
        write = not any(mesh.coords.values())
    if write:
        flat = {k: to_npz_array(v) for k, v in flatten_tree(params).items()}
        flat["__step__"] = np.asarray(step, np.int64)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **flat)
    if mesh is not None and dist.is_initialized():
        dist.barrier()


def restore(path: str, device="cuda", mesh=None,
            spec: dict | None = None) -> tuple[dict, int]:
    """(params on ``device``, step) from a file ``save`` (or the
    reference's ``save``) wrote; on a ``mesh``, this rank's blocks of
    them under ``spec``."""
    dev = resolve_device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        step = int(z["__step__"]) if "__step__" in z.files else 0
        flat = {k: (z[k] if k.endswith(_QT_META)
                    else from_npz_array(z[k], "cpu" if mesh is not None
                                        else dev))
                for k in z.files if k != "__step__"}
    params = unflatten_tree(flat)
    if mesh is not None:
        params = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                  for k, v in flatten_tree(
                      sharding.shard_tree(params, spec, mesh)).items()}
        params = unflatten_tree(params)
    return params, step


# ---------------------------------------------------------------------------
# prestack converter (paper §4.1, the one-time stacking script)
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"^layer_(\d+)$")
_EXPERT_RE = re.compile(r"^expert_(\d+)$")


def convert_unstacked(unstacked: dict, num_experts_padded: int = 0,
                      weight_quant: str = "none",
                      weight_quant_block: int = 128,
                      weight_quant_kinds: tuple = quant.DEFAULT_KINDS) -> dict:
    """{"layer_0": {...}, "layer_1": {...}} -> prestacked tree with a
    leading L axis; inside each layer an optional {"expert_<i>": {...}}
    level is stacked into a leading E axis and zero-padded to
    ``num_experts_padded``.  ``weight_quant`` then quantizes the eligible
    weight kinds in the same pass."""
    layer_keys = sorted((k for k in unstacked if _LAYER_RE.match(k)),
                        key=lambda k: int(_LAYER_RE.match(k).group(1)))
    if not layer_keys:
        raise ValueError("no layer_<i> entries found")

    def stack_layer(layer: dict) -> dict:
        e_keys = sorted((k for k in layer if _EXPERT_RE.match(k)),
                        key=lambda k: int(_EXPERT_RE.match(k).group(1)))
        if not e_keys:
            return layer
        experts = prestack.stack_experts([layer[k] for k in e_keys])
        if num_experts_padded:
            experts = prestack.pad_experts(experts, num_experts_padded)
        rest = {k: v for k, v in layer.items() if k not in e_keys}
        return {**rest, "experts": experts}

    blocks = prestack.stack_blocks([stack_layer(unstacked[k])
                                    for k in layer_keys])
    return prestack.quantize_blocks(blocks, weight_quant,
                                    block=weight_quant_block,
                                    kinds=weight_quant_kinds)


def to_unstacked(blocks: dict, num_layers: int) -> dict:
    """Inverse converter (prestacked -> the naive per-layer layout)."""
    return {f"layer_{i}": layer
            for i, layer in enumerate(prestack.unstack_blocks(blocks))}


def quantize_on_load(path: str, cfg, device="cuda") -> tuple[dict, int]:
    """Restore a checkpoint and apply ``cfg.weight_quant`` (idempotent: a
    checkpoint saved already quantized passes through)."""
    params, step = restore(path, device)
    return quant.quantize_params(params, cfg), step
