"""Weight bridge between the JAX package's parameter tree and the port's.

Both keep the same layout (weights (D_in, D_out), experts (L, E, D, F) /
(L, E, F, D), the dense MLP (L, D, F) / (L, F, D), layer-stacked blocks),
so the bridge is a copy.  The JAX
side is handed over as numpy (``jax.tree.map(np.asarray, params)``); this
module imports no JAX.  The tests need it because ``jax.random`` and
``torch`` cannot draw the same weights.

A JAX gradient tree has the params' structure, so it comes over the same
way (the training tests hold the port's gradients to it).  A quantized
tree comes over too: a JAX ``QuantTensor`` leaf arrives as an
object with ``data``/``scale`` (numpy) and ``bits``/``block``/
``orig_dim``/``out_dtype`` attributes; the bridge reads those attributes
(without importing the class) and builds the port's ``QuantTensor``.
On a mesh, ``from_jax_params(..., mesh=)`` gives one rank its parameters:
its expert rows for the full-sequence forward, or with ``mode="serve"``
(``mode="train"``) its serve-mode (train-mode) block of every weight
(``launch/sharding.py``).
"""
from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch.core import expert_parallel
from repro_torch.core import quant
from repro_torch.core.quant import QuantTensor
from repro_torch.launch import sharding
from repro_torch.models import mamba2, transformer
from repro_torch.models.model import resolve_device

_QUANT_META = ("bits", "block", "orig_dim", "out_dtype")


def _attn_shapes(cfg, L: int) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    attn = {"wq": (L, d, hq * hd), "wk": (L, d, hkv * hd),
            "wv": (L, d, hkv * hd), "wo": (L, hq * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(L, hq * hd), bk=(L, hkv * hd), bv=(L, hkv * hd))
    if cfg.qk_norm:
        attn.update(q_norm=(L, hd), k_norm=(L, hd))
    return attn


def _family_blocks(cfg, norm) -> dict:
    """The stacked blocks of the ssm and hybrid families, as shapes."""
    d = cfg.d_model
    if cfg.family == "ssm":
        L, n, k = cfg.num_layers, cfg.ssm_state, cfg.ssm_dconv
        di, h, dc = mamba2.d_inner(cfg), mamba2.n_heads(cfg), \
            mamba2.conv_dim(cfg)
        return {"ln": norm(L, d), "mamba": {
            "in_proj": (L, d, 2 * di + 2 * n + h), "conv_w": (L, k, dc),
            "conv_b": (L, dc), "A_log": (L, h), "D": (L, h),
            "dt_bias": (L, h), "norm": (L, di), "out_proj": (L, di, d)}}
    pattern = transformer.hybrid_pattern(cfg)
    n_rec, n_attn = pattern.count("rec"), max(pattern.count("attn"), 1)
    w = cfg.lru_width
    layer = lambda n, mix: {
        "ln1": norm(n, d), "ln2": norm(n, d),
        "mlp": {"w_gate": (n, d, cfg.d_ff), "w_up": (n, d, cfg.d_ff),
                "w_down": (n, cfg.d_ff, d)}, "mix": mix}
    rec = {"in_x": (n_rec, d, w), "in_y": (n_rec, d, w),
           "conv_w": (n_rec, cfg.conv1d_width, w), "conv_b": (n_rec, w),
           "gate_a": (n_rec, w, w), "bias_a": (n_rec, w),
           "gate_x": (n_rec, w, w), "bias_x": (n_rec, w),
           "Lambda": (n_rec, w), "out": (n_rec, w, d)}
    return {"rec": layer(n_rec, rec),
            "attn": layer(n_attn, _attn_shapes(cfg, n_attn))}


def param_shapes(cfg) -> dict:
    """The port's parameter tree for ``cfg`` (``Model.init``), as shapes."""
    L, d, e, f = (cfg.num_layers, cfg.d_model, cfg.num_experts_padded,
                  cfg.d_ff)
    er = e * max(cfg.expert_replication, 1)     # r stored expert copies
    norm = lambda *shape: ({"scale": shape, "bias": shape}
                           if cfg.norm == "layernorm" else shape)
    blocks = {"ln1": norm(L, d), "attn": _attn_shapes(cfg, L),
              "ln2": norm(L, d)}
    if cfg.family in ("ssm", "hybrid"):
        blocks = _family_blocks(cfg, norm)
    elif cfg.family == "moe":
        blocks["router"] = (L, d, e)
        blocks["experts"] = {"w_gate": (L, er, d, f), "w_up": (L, er, d, f),
                             "w_down": (L, er, f, d)}
    else:
        blocks["mlp"] = {"w_gate": (L, d, f), "w_up": (L, d, f),
                         "w_down": (L, f, d)}
    params = {"embed": (cfg.vocab_padded, d), "blocks": blocks,
              "final_norm": norm(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = (d, cfg.vocab_padded)
    return params


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                         # a writable contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _is_quant(leaf) -> bool:
    # the metadata first: ``ndarray.data`` raises for ml_dtypes bfloat16
    return all(hasattr(leaf, a) for a in _QUANT_META + ("data", "scale"))


def _logical_shape(leaf) -> tuple:
    if _is_quant(leaf):
        shape = list(np.shape(leaf.data))
        shape[-2] = int(leaf.orig_dim)
        return tuple(shape)
    return tuple(np.shape(leaf))


def from_jax_params(tree: dict, cfg, device, mesh=None,
                    mode: str = "forward") -> dict:
    """The JAX param tree (as numpy) -> the port's parameters on ``device``.
    Raises if the tree's structure or (logical) shapes differ from what the
    port's ``Model.init`` builds for ``cfg``.  With a ``mesh``
    (``launch/mesh.py``) it is this rank's parameters: every leaf whole but
    the expert stacks, which keep this rank's rows
    (``expert_parallel.expert_rows``; QuantTensor payload and scales
    alike), as ``Model.init(gen, mesh)`` builds them.  With
    ``mode="serve"`` it is this rank's serve-mode block of every leaf
    (``sharding.shard_tree``), as ``Model.init_serving`` builds them: the
    whole tree is quantized first as ``cfg.weight_quant`` asks (already
    quantized leaves pass through), on the host, then cut, as the
    reference quantizes on load before placing the weights.  With
    ``mode="train"`` it is this rank's train-mode block of every leaf
    (``sharding.train_specs``), as ``Model.init_training`` builds them;
    a JAX gradient tree comes over the same way."""
    got = _tree_map(_logical_shape, tree)
    want = param_shapes(cfg)
    if got != want:
        raise ValueError(f"JAX params do not match the port's layout for "
                         f"{cfg.name}: {got} != {want}")
    resolve_device(device)
    if mode not in ("forward", "serve", "train"):
        raise ValueError(f"unknown mode {mode!r}; expected forward, serve "
                         f"or train")
    if mesh is not None and mode != "forward":
        whole = from_jax_params(tree, cfg, "cpu")
        if mode == "serve":
            whole = quant.quantize_params(whole, cfg, inplace=True)
        cut = sharding.shard_tree(whole, sharding.mode_specs(cfg, mesh, mode),
                                  mesh)
        return _tree_map(lambda t: QuantTensor(
            t.data.to(device), t.scale.to(device), t.bits, t.block,
            t.orig_dim, t.out_dtype) if isinstance(t, QuantTensor)
            else t.to(device), cut)
    if mesh is not None and "experts" in tree.get("blocks", {}):
        rows = (slice(None), expert_parallel.expert_rows(cfg, mesh))
        cut = lambda leaf: (types.SimpleNamespace(
            data=np.asarray(leaf.data)[rows],
            scale=np.asarray(leaf.scale)[rows],
            **{a: getattr(leaf, a) for a in _QUANT_META})
            if _is_quant(leaf) else np.asarray(leaf)[rows])
        blocks = dict(tree["blocks"],
                      experts=_tree_map(cut, tree["blocks"]["experts"]))
        tree = dict(tree, blocks=blocks)

    def conv(leaf):
        if _is_quant(leaf):
            return QuantTensor(
                _to_torch(np.asarray(leaf.data), device),
                _to_torch(np.asarray(leaf.scale), device), int(leaf.bits),
                int(leaf.block), int(leaf.orig_dim), str(leaf.out_dtype))
        return _to_torch(np.asarray(leaf), device)
    return _tree_map(conv, tree)


def to_numpy(params: dict) -> dict:
    """Inverse of ``from_jax_params``: the port's parameters as numpy (bf16
    tensors come back as ml_dtypes bfloat16, as JAX hands them out; a
    QuantTensor as a namespace with numpy ``data``/``scale`` and its
    metadata)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy().copy()

    def conv(leaf):
        if isinstance(leaf, QuantTensor):
            return types.SimpleNamespace(
                data=arr(leaf.data), scale=arr(leaf.scale),
                **{a: getattr(leaf, a) for a in _QUANT_META})
        return arr(leaf)
    return _tree_map(conv, params)
