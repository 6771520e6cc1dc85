"""Trace one step of the engine's serving programs for the analyzers (the
JAX package's ``analysis/programs.py``).

``trace_program(variant)`` builds a ServingEngine as the serving tests do
(the reduced config by default: the same family, 2 layers) and runs one
call of the variant's step body under ``launch/opcount.capture``.  The
reference lowers its jit for that body and reads the compiled HLO; the
port's program is the stream of aten ops the body dispatched, packaged
with the tree facts every rule needs:

  * the cache leaves' paths, bytes and storage pointers before and after
    the step (R1: the step updates each leaf in place, and allocates
    nothing of a leaf's size);
  * the QuantTensor (data, scale) leaf map, with the serials the capture
    gave each payload and scale tensor (R5's taint seeds);
  * the mesh's shard counts and the step's collective bytes by kind,
    ``mesh.bytes`` (R2, R6; empty on one device).

The five variants: ``decode`` (the reference engine's one-token step),
``unified`` (the mixed prefill/decode block over the contiguous cache),
``paged`` (the same over the page pool), ``int8`` (``paged`` over the
int8 weight store) and ``paged_kernel`` (the page pool at page 5 with 9
pages).  In the port ``paged`` and ``paged_kernel`` differ only in the
pool's geometry: both launch the CUDA kernel on the card and take its
plain version on the CPU, whose page walk gathers the virtual cache.

A planted violation is a ``dataclasses.replace`` of the record with an
extra op or counter entry, as the reference splices HLO lines.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.quant import QuantTensor
from repro_torch.launch import opcount
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine

DEFAULT_ARCH = "qwen3_moe_30b_a3b"
VARIANTS = ("decode", "unified", "paged", "int8", "paged_kernel")


@dataclasses.dataclass(frozen=True)
class QuantLeaf:
    """One QuantTensor's sibling leaves: flat leaf indices (a QuantTensor
    flattens to (data, scale), dict keys in sorted order, as the
    reference's pytrees do) and, once traced, the capture's serials of
    the two tensors."""
    data_idx: int
    scale_idx: int
    path: str
    full_elems: int      # logical (dequantized) element count
    data_serial: int = -1
    scale_serial: int = -1


@dataclasses.dataclass
class TracedProgram:
    name: str            # variant name shown in findings
    variant: str
    kind: str            # "decode" | "unified"
    engine: ServingEngine
    cfg: Any
    ecfg: EngineConfig
    records: list        # the step's OpRecords
    peak_bytes: int      # peak live bytes allocated inside the step
    cache_paths: list
    cache_bytes: list
    cache_ptrs_before: list
    cache_ptrs_after: list
    cache_storages: list # the leaves' storage keys in the capture
    batch: int
    seq: int             # tokens per row per step (1 for decode)
    copy_exact_sizes: bool
    n_exp_shards: int
    n_batch_shards: int
    coll: dict           # the step's collective bytes by kind
    quant_leaves: list
    device: str = "cpu"


def _leaves(tree: dict, path: str = ""):
    """(path, leaf) in sorted key order; a QuantTensor is one leaf."""
    for k in sorted(tree):
        v = tree[k]
        p = f"{path}[{k!r}]"
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _flat(params):
    """(path, leaf) of ``params`` (a dict, or a tuple of dicts and
    leaves) in flattening order."""
    items = (list(_leaves(params)) if isinstance(params, dict) else
             [(f"[{i}]", p) for i, p in enumerate(params)])
    for path, leaf in items:
        yield from (_leaves(leaf, path) if isinstance(leaf, dict)
                    else [(path, leaf)])


def quant_leaf_map(params) -> list:
    """Flat-index map of the QuantTensor (data, scale) sibling pairs of
    ``params``."""
    out, idx = [], 0
    for path, leaf in _flat(params):
        if isinstance(leaf, QuantTensor):
            out.append(QuantLeaf(idx, idx + 1, path,
                                 int(np.prod(leaf.shape))))
            idx += 2
        else:
            idx += 1
    return out


def watch_tensors(params) -> list:
    """Each QuantTensor's (data, scale) in ``quant_leaf_map``'s order: the
    tensors a capture fixes serials for first."""
    return [t for _, q in _flat(params) if isinstance(q, QuantTensor)
            for t in (q.data, q.scale)]


def seeded_leaves(params, watched: list) -> list:
    """``quant_leaf_map(params)`` with the serials a capture gave each
    (data, scale) pair, ``watched`` being those of ``watch_tensors``."""
    return [dataclasses.replace(q, data_serial=watched[2 * i],
                                scale_serial=watched[2 * i + 1])
            for i, q in enumerate(quant_leaf_map(params))]


def _mesh_shards(eng: ServingEngine) -> tuple:
    """(expert shards, the data blocks the engine's rows are cut into)."""
    mesh = eng.mesh
    if mesh is None:
        return 1, 1
    n_exp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    return n_exp, eng.blocks


def build_engine(variant: str, arch: str = DEFAULT_ARCH, *, device="cuda",
                 mesh=None, cfg_kw: dict | None = None,
                 ecfg_kw: dict | None = None,
                 reduced: bool = True) -> ServingEngine:
    """A fresh engine configured for ``variant`` (the reference's shapes:
    max_batch=2, prefill_len=8, max_cache=32, chunk_len=4).  Its weights
    are drawn on the CPU from seed 0 and moved to ``device``, so a CPU
    and a card engine hold the same model.  ``reduced=False``: the arch
    at full width, its weights drawn on ``device``."""
    if variant not in VARIANTS and variant not in ("int4",):
        raise ValueError(f"unknown variant {variant!r}; pick from {VARIANTS}")
    cfg_kw = dict(cfg_kw or {})
    if variant in ("int8", "int4"):
        cfg_kw.setdefault("weight_quant", variant)
    cfg = get_config(arch)
    cfg = (cfg.reduced() if reduced else cfg).replace(**cfg_kw)
    ekw: dict = dict(max_batch=2, prefill_len=8, max_cache=32)
    if variant == "decode":
        ekw.update(unified_step=False, paged=False)
    else:
        ekw.update(unified_step=True, chunk_len=4,
                   paged=variant != "unified")
    if variant in ("paged", "int8", "int4"):
        ekw.update(page_size=8)
    if variant == "paged_kernel":
        # page_size 5 / 9-page pool: deliberately OFF the auto pool size
        # (max_batch * max_blocks), so the three buffer families R1 must
        # tell apart (the virtual cache, B*NB*ps slots; a layer's pool,
        # num_pages*ps slots; the MoE dispatch, B*T token rows) all have
        # distinct byte sizes
        ekw.update(page_size=5, num_pages=9)
    ekw.update(ecfg_kw or {})
    params, gen = None, None
    if mesh is None and reduced:
        params = _to(build_model(cfg.replace(weight_quant="none"), "cpu")
                     .init(torch.Generator().manual_seed(0)), device)
    else:       # each rank draws its serve blocks (``init_serving``)
        gen = torch.Generator(device=device).manual_seed(0)
    return ServingEngine(cfg, EngineConfig(**ekw), params=params,
                         generator=gen, device=device, mesh=mesh)


def _to(tree: dict, device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def step_args(eng: ServingEngine) -> tuple:
    """The step body's arguments, uploaded as the engine uploads them: a
    full prefill chunk in every row at offset 0 (block tables mapping
    each row onto its own pages, wrapped into its data block's pool), all
    rows sampled; the decode body's: every row active at position 0."""
    b = eng.ecfg.max_batch
    z = np.zeros((b,), np.int32)
    if not eng.unified:
        d_len, d_act, d_temp, d_topk = eng._upload(
            z, np.ones((b,), bool), np.zeros((b,), np.float32), z)
        return d_len, d_act != 0, d_temp, d_topk, 0
    t = eng.chunk_len
    tables = ()
    if eng.paged:
        tables = ((np.arange(b * eng.max_blocks, dtype=np.int32)
                   % eng.block_pages).reshape(b, eng.max_blocks),)
    rng = np.random.default_rng(0)
    d_tok, d_len, d_seg, d_dec, d_sample, d_temp, d_topk, *rest = \
        eng._upload(rng.integers(0, 50, (b, t)).astype(np.int32), z,
                    np.full((b,), t, np.int32), np.zeros((b,), bool),
                    np.ones((b,), bool), np.zeros((b,), np.float32), z,
                    *tables)
    return (d_tok, d_len, d_seg, rest[0] if rest else None, d_dec != 0,
            d_sample != 0, d_temp, d_topk, None, 0)


def run_step(eng: ServingEngine, args: tuple):
    body = eng._unified if eng.unified else eng._decode
    with torch.no_grad():
        return body(*args)


def trace_engine(eng: ServingEngine, variant: str,
                 name: str | None = None, step=None) -> TracedProgram:
    """One step of ``eng``'s body under a capture, as a TracedProgram.
    ``step``: the callable to run in place of the body (a planted
    violation), with the same arguments."""
    cfg, ecfg = eng.cfg, eng.ecfg
    args = step_args(eng)
    paths, leaves = zip(*_leaves(eng.cache))
    before = [t.data_ptr() for t in leaves]
    storages = [t.untyped_storage()._cdata for t in leaves]
    if eng.mesh is not None:
        eng.mesh.reset_counters()
    fn = step or (lambda *a: run_step(eng, a))
    cap = opcount.capture(fn, *args, watch=watch_tensors(eng.params))
    after = [t.data_ptr() for _, t in _leaves(eng.cache)]
    n_exp, n_batch = _mesh_shards(eng)
    # production MoE configs keep the capacity-free gather decode path on;
    # its selected-expert weight copies legitimately exceed a cache leaf,
    # so R1 matches cache-leaf sizes exactly there and uses the stricter
    # >= smallest-leaf threshold everywhere else
    exact = bool(cfg.is_moe and getattr(cfg, "gather_decode_max_tk", 0))
    return TracedProgram(
        name=name or variant, variant=variant,
        kind="unified" if eng.unified else "decode", engine=eng, cfg=cfg,
        ecfg=ecfg, records=cap.records, peak_bytes=cap.peak_bytes,
        cache_paths=list(paths),
        cache_bytes=[t.numel() * t.element_size() for t in leaves],
        cache_ptrs_before=before, cache_ptrs_after=after,
        cache_storages=storages,
        batch=ecfg.max_batch, seq=eng.chunk_len if eng.unified else 1,
        copy_exact_sizes=exact, n_exp_shards=n_exp, n_batch_shards=n_batch,
        coll=dict(eng.mesh.bytes) if eng.mesh is not None else {},
        quant_leaves=seeded_leaves(eng.params, cap.watched),
        device=eng.device.type)


def trace_program(variant: str, arch: str = DEFAULT_ARCH, *, device="cuda",
                  mesh=None, cfg_kw: dict | None = None,
                  ecfg_kw: dict | None = None,
                  name: str | None = None) -> TracedProgram:
    """Build the ``variant`` engine and trace one step of its body."""
    eng = build_engine(variant, arch, device=device, mesh=mesh,
                       cfg_kw=cfg_kw, ecfg_kw=ecfg_kw)
    return trace_engine(eng, variant, name)
