"""Quantize-on-draw: ``Model.init_serving`` rounds each weight matrix to
the param dtype and quantizes it as it is drawn (``layers.dense_init``
through a ``quant.Sink``), never holding a leaf in the param dtype.

* The store equals ``quant.quantize_params(model.init(gen), cfg)`` leaf
  for leaf, exactly (payload, scales, shapes, dtypes, block metadata), for
  every family, int8 and int4, fp32 and bf16 params; also where each
  matrix is quantized in many column chunks, with two copies of the
  expert stack, and as the engine draws it.
* It equals the JAX package's ``quantize_params`` of the same raw weights
  bridged over (moe and dense).
* On a (2, 2) mesh each rank's blocks equal ``sharding.shard_tree`` of
  the whole quantized tree.
* The peak of the draw's live bytes (``launch/opcount.capture``) is at
  most the store plus one matrix's transients: the largest fp32 matrix
  (4 B an element) and one column chunk's temporaries (16 B an element of
  the chunk, its rows rounded up to whole blocks).  The old path (draw
  the whole tree, then quantize it) peaks at the param-dtype tree or
  more.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import quant as jq
from repro_torch.bridge import from_jax_params, param_shapes, to_numpy
from repro_torch.configs.base import get_config
from repro_torch.core import quant
from repro_torch.launch import opcount, sharding
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine
from torch_archs import DEAD_AND_PADDED, one_torch_thread  # noqa: F401

# one arch of each family
FAMILIES = {"moe": "dbrx", "dense": "qwen3_0_6b",
            "hybrid": "recurrentgemma_2b", "ssm": "mamba2_130m",
            "vlm": "qwen2_vl_7b", "audio": "musicgen_large"}
LEVELS = ("int8", "int4")
SEED = 5


def _cfg(family: str, level: str, dtype: str = "float32", **kw):
    extra = DEAD_AND_PADDED if FAMILIES[family] == "dbrx" else {}
    return get_config(FAMILIES[family]).reduced().replace(
        weight_quant=level, dtype=dtype, param_dtype=dtype, **extra, **kw)


def _gen():
    return torch.Generator().manual_seed(SEED)


def _flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def _assert_same_tree(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, quant.QuantTensor) == isinstance(
            w, quant.QuantTensor), k
        if isinstance(w, quant.QuantTensor):
            assert (g.bits, g.block, g.orig_dim, g.out_dtype) == (
                w.bits, w.block, w.orig_dim, w.out_dtype), k
            for a, b in ((g.data, w.data), (g.scale, w.scale)):
                assert (a.dtype, a.shape) == (b.dtype, b.shape), k
                assert torch.equal(a, b), k
        else:
            assert (g.dtype, g.shape) == (w.dtype, w.shape), k
            assert torch.equal(g, w), k


def _quantized_kinds(tree: dict) -> set:
    return {quant.classify_weight(k.split("/"))
            for k, v in _flat(tree).items()
            if isinstance(v, quant.QuantTensor)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_draw_equals_quantize_params(family, level, dtype):
    """(a) The store drawn quantized equals quantize_params of the drawn
    tree, exactly, and converts the same kinds (the embedding and the
    router stay in the param dtype)."""
    cfg = _cfg(family, level, dtype)
    model = build_model(cfg, "cpu")
    got = model.init_serving(_gen())
    want = quant.quantize_params(model.init(_gen()), cfg)
    _assert_same_tree(got, want)
    assert not isinstance(got["embed"], quant.QuantTensor)
    kinds = _quantized_kinds(got)
    assert kinds <= set(cfg.weight_quant_kinds) and "router" not in kinds
    if family != "ssm":          # the ssm block's projections never convert
        assert "attn" in kinds
    assert quant.tree_bytes(got) == quant.tree_bytes(want)


@pytest.mark.parametrize("family,case", [
    ("moe", "chunked"), ("moe", "replicated"), ("moe", "engine"),
    ("moe", "block64"), ("dense", "chunked"), ("dense", "engine"),
    ("dense", "block64")])
def test_draw_equals_quantize_params_variants(family, case, monkeypatch):
    """(a) The same where every matrix is quantized in many column chunks
    (a few rows' worth each), with the expert stack stored twice
    (expert_replication 2, an MoE option), at a 64-row block, and as the
    serving engine draws its own parameters."""
    kw = {"expert_replication": 2} if case == "replicated" else {}
    if case == "block64":
        kw["weight_quant_block"] = 64
    cfg = _cfg(family, "int4", "bfloat16", **kw)
    model = build_model(cfg, "cpu")
    want = quant.quantize_params(model.init(_gen()), cfg)
    if case == "chunked":
        monkeypatch.setattr(quant, "CHUNK_ELEMS", 1000)
    if case == "engine":
        got = ServingEngine(cfg, EngineConfig(max_batch=2, max_cache=32),
                            generator=_gen(), device="cpu").params
    else:
        got = model.init_serving(_gen())
    _assert_same_tree(got, want)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("family", ["moe", "dense"])
def test_draw_equals_jax_quantize_params(family, level):
    """(b) The store equals the JAX package's quantize_params of the same
    raw weights (the port's fp draw bridged over as numpy), bf16 params:
    the rounding to the param dtype before quantizing is the reference's
    too."""
    cfg = _cfg(family, level, "bfloat16")
    extra = DEAD_AND_PADDED if FAMILIES[family] == "dbrx" else {}
    jcfg = jax_get_config(FAMILIES[family]).reduced().replace(
        weight_quant=level, dtype="bfloat16", param_dtype="bfloat16",
        **extra)
    model = build_model(cfg, "cpu")
    raw = jax.tree.map(jnp.asarray, to_numpy(model.init(_gen())))
    want = from_jax_params(jax.tree.map(
        np.asarray, jq.quantize_params(raw, jcfg)), cfg, "cpu")
    got = model.init_serving(_gen())
    _assert_same_tree(got, want)
    assert quant.tree_bytes(got) == jq.tree_bytes(jq.quantize_params(raw,
                                                                     jcfg))


class Axes:
    """A stand-in (2, 2) mesh: axis names and sizes, and one rank's
    coordinates."""

    def __init__(self, data: int, model: int):
        self.axis_names = ("data", "model")
        self.shape = {"data": 2, "model": 2}
        self.coords = {"data": data, "model": model}


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_blocks_equal_shard_tree(family, level):
    """(c) On a (2, 2) mesh every rank's init_serving blocks, drawn and
    quantized matrix by matrix, equal shard_tree of the whole quantized
    tree (a row-cut QuantTensor keeps its own scale rows)."""
    cfg = _cfg(family, level, "bfloat16", weight_quant_block=64)
    model = build_model(cfg, "cpu")
    whole = quant.quantize_params(model.init(_gen()), cfg)
    for data in range(2):
        for mdl in range(2):
            mesh = Axes(data, mdl)
            want = sharding.shard_tree(
                whole, sharding.serve_specs(cfg, mesh), mesh)
            _assert_same_tree(model.init_serving(_gen(), mesh), want)


def _bound_from_shapes(cfg) -> int:
    """The store plus the largest fp32 matrix drawn (4 B an element of the
    last two axes of any leaf) plus one column chunk's temporaries (16 B
    an element: rows rounded up to whole blocks, as many whole columns as
    ``CHUNK_ELEMS`` allows, at most all of them), from the config's leaf
    shapes."""
    shapes = [s for s in _flat(param_shapes(cfg)).values()]
    mat = max(math.prod(s[-2:]) for s in shapes)
    block = cfg.weight_quant_block
    chunk = 0
    for name, s in _flat(param_shapes(cfg)).items():
        if len(s) >= 2 and quant.classify_weight(name.split("/")) in \
                cfg.weight_quant_kinds:
            k, n = s[-2:]
            cols = min(n, max(1, quant.CHUNK_ELEMS // k))
            chunk = max(chunk, -(-k // block) * block * cols)
    store = quant.tree_bytes(sharding.meta_params(cfg))
    return store + 4 * mat + 16 * chunk


@pytest.mark.parametrize("chunk", [1 << 24, 4096])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_draw_peak_within_one_matrix(family, level, chunk, monkeypatch):
    """(d) The draw's peak of live bytes is at most the store plus one
    matrix's transients (the bound above; ``sharding.draw_peak_bytes`` states
    the same), at the default chunk and at a chunk of a few rows.  The
    keep tree (``sharding.draw_keep``, meta tensors of the whole tree:
    shapes, no device memory) is built before the capture, which counts
    meta storages as the dry-run's.  The old path, the whole tree drawn
    and then quantized in place, peaks at the param-dtype tree or more."""
    monkeypatch.setattr(quant, "CHUNK_ELEMS", chunk)
    cfg = _cfg(family, level, "bfloat16")
    model = build_model(cfg, "cpu")
    bound = _bound_from_shapes(cfg)
    assert sharding.draw_peak_bytes(cfg) == bound
    keep = sharding.draw_keep(cfg)
    cap = opcount.capture(model.init, _gen(), keep=keep)
    store = quant.tree_bytes(cap.result)
    assert store == quant.tree_bytes(sharding.meta_params(cfg))
    assert store < cap.peak_bytes <= bound
    old = opcount.capture(lambda: quant.quantize_params(
        model.init(_gen()), cfg, inplace=True))
    fp = quant.tree_bytes(sharding.meta_params(cfg.replace(
        weight_quant="none")))
    assert old.peak_bytes >= fp
