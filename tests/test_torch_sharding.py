"""Port vs JAX: the partition-spec rules of ``launch/sharding.py`` and the
per-rank slicing beside them, for every port arch (all of them run on a
mesh).

The rules read only ``mesh.axis_names`` and ``mesh.shape``, so both sides
get a stand-in mesh with those two fields and no devices: the JAX rules
run on ``jax.eval_shape`` trees of the full-size configs, the port's on
meta tensors of the same shapes (``sharding.meta_params``).  Every port
arch, fp and int8 / int4 (QuantTensor payload and scales, with
``_axes_divide``'s drops), serve and train mode, and ``kv_cache_shard``
seq / hd / kv / none for the caches, on meshes (2, 4), (1, 4), (2, 2) and
the production (16, 16): the port's four spec functions equal the JAX
functions leaf for leaf.  Then ``shard_tree``'s blocks of every rank put
back together give the whole tree (a QuantTensor's block dequantizes to
the same rows of the whole, also where its scales stay whole), and
``Model.init_serving`` and the bridge's serve mode keep exactly those
blocks."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as jax_get_config
from repro.core import quant as jax_quant
from repro.launch import sharding as jax_sharding
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs.base import ARCH_IDS as ALL_ARCH_IDS
from repro_torch.configs.base import get_config
from repro_torch.core import quant
from repro_torch.launch import sharding
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

SHAPES = [(2, 4), (1, 4), (2, 2), (16, 16)]
LEVELS = ("none", "int8", "int4")
KV_SHARDS = ("seq", "hd", "kv", "none")
# every arch of the port runs on a mesh
ARCH_IDS = list(ALL_ARCH_IDS)


class Axes:
    """A stand-in mesh: axis names and sizes, and (for the slicing) one
    rank's coordinates."""

    def __init__(self, shape, data=0, model=0):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = {"data": data, "model": model}


def _flat_jax(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[key] = tuple(leaf)
    return out


def _flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch: str, level: str):
    cfg = jax_get_config(arch).replace(weight_quant=level)
    return cfg, jax.eval_shape(
        lambda k: jax_quant.quantize_params(jax_build_model(cfg).init(k),
                                            cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_pspec_equals_jax(arch, level):
    jcfg, shapes = _jax_shapes(arch, level)
    cfg = get_config(arch).replace(weight_quant=level)
    meta = sharding.meta_params(cfg)
    for shape in SHAPES:
        for mode in ("serve", "train"):
            want = _flat_jax(jax_sharding.params_pspec(jcfg, Axes(shape),
                                                       shapes, mode=mode))
            got = _flat(sharding.params_pspec(cfg, Axes(shape), meta, mode))
            assert got == want, (shape, mode)
            if mode == "serve":
                assert sharding.serve_specs(cfg, Axes(shape)) == \
                    sharding.params_pspec(cfg, Axes(shape), meta, mode)


def _meta(spec: dict) -> dict:
    """Meta tensors of a cache spec tree ({name: (shape, dtype)})."""
    return {k: _meta(v) if isinstance(v, dict)
            else torch.empty(v[0], dtype=v[1], device="meta")
            for k, v in spec.items()}


def test_rglru_channel_sharding():
    """The reference's own rule check: recurrentgemma-2b's lru_width 2560
    divides 16, so its recurrent channels are cut over "model" in the
    serve layout (``in_x``'s output, ``gate_a``'s output, ``out``'s
    rows)."""
    sp = sharding.serve_specs(get_config("recurrentgemma_2b"),
                              Axes((16, 16)))
    rec = sp["blocks"]["rec"]["mix"]
    assert rec["in_x"][2] == "model" and rec["in_y"][2] == "model"
    assert rec["gate_a"][2] == "model" and rec["gate_x"][2] == "model"
    assert rec["out"][1] == "model"
    assert all("model" not in sharding._axes(e) for name in (
        "conv_w", "conv_b", "Lambda", "bias_a", "bias_x") for e in rec[name])


def test_mamba_weights_replicated_over_model():
    """The reference's own rule check: mamba2-130m's SSD block is
    replicated over "model" in the serve layout (24 heads do not divide
    16), and only "data" cuts its projections in the train layout."""
    cfg = get_config("mamba2_130m")
    serve = sharding.serve_specs(cfg, Axes((16, 16)))["blocks"]["mamba"]
    for name in ("in_proj", "conv_w", "A_log", "norm", "out_proj"):
        assert all("model" not in sharding._axes(e) for e in serve[name]), \
            name
    train = sharding.train_specs(cfg, Axes((16, 16)))["blocks"]["mamba"]
    assert train["in_proj"] == (None, "data", None)
    assert train["out_proj"] == (None, None, "data")


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspec_equals_jax(arch, kv):
    for mode in KV_SHARDS:
        jcfg = jax_get_config(arch).replace(kv_cache_shard=mode,
                                            kv_cache_dtype=kv)
        cfg = get_config(arch).replace(kv_cache_shard=mode,
                                       kv_cache_dtype=kv)
        for b, s in ((8, 4096), (3, 256)):
            jcache = jax.eval_shape(lambda: jax_build_model(jcfg).init_cache(
                b, s))
            cache = _meta(build_model(cfg, "cpu").cache_specs(b, s))
            for shape in SHAPES:
                want = _flat_jax(jax_sharding.cache_pspec(jcfg, Axes(shape),
                                                          jcache))
                got = _flat(sharding.cache_pspec(cfg, Axes(shape), cache))
                assert got == want, (mode, b, s, shape)


def test_batch_and_opt_pspec_equal_jax():
    cfg, jcfg = get_config("qwen3_0_6b"), jax_get_config("qwen3_0_6b")
    for shape in SHAPES:
        for b in (1, 2, 3, 16, 32):
            batch = {"tokens": np.zeros((b, 8), np.int32),
                     "labels": np.zeros((b, 8), np.int32)}
            want = {k: tuple(v) for k, v in jax_sharding.batch_pspec(
                jcfg, Axes(shape), batch).items()}
            assert sharding.batch_pspec(cfg, Axes(shape), batch) == want
        ps = sharding.params_pspec(cfg, Axes(shape),
                                   sharding.meta_params(cfg))
        state = adamw.OptState(torch.zeros((), dtype=torch.int32), {}, {})
        opt = sharding.opt_pspec(cfg, Axes(shape), state, ps)
        assert isinstance(opt, adamw.OptState)
        assert opt.step == tuple(P()) and opt.mu is ps and opt.nu is ps


def _blocks(tree, cfg, mesh_shape):
    """Every rank's ``shard_tree`` of ``tree`` with the serve specs."""
    n_data, n_model = mesh_shape
    return {(d, m): sharding.shard_tree(
        tree, sharding.serve_specs(cfg, Axes(mesh_shape, d, m)),
        Axes(mesh_shape, d, m))
        for d in range(n_data) for m in range(n_model)}


def _logical(leaf):
    return quant.dequantize(leaf) if isinstance(leaf, quant.QuantTensor) \
        else leaf


def _reassembled(whole: dict, blocks: dict, cfg, mesh_shape) -> None:
    """Each rank's block of each leaf sits at its ``block_slices`` of the
    logical whole; together the blocks cover it."""
    spec = _flat(sharding.serve_specs(cfg, Axes(mesh_shape)))
    for name, leaf in _flat(whole).items():
        ref = _logical(leaf)
        cover = torch.zeros(ref.shape, dtype=torch.int32)
        for (d, m), tree in blocks.items():
            blk = _flat(tree)[name]
            s = (spec[name + "/data"] if isinstance(leaf, quant.QuantTensor)
                 else spec[name])
            sl = sharding.block_slices(ref.shape, s, Axes(mesh_shape, d, m))
            assert torch.equal(_logical(blk), ref[sl]), (name, d, m)
            cover[sl] += 1
        assert int(cover.min()) >= 1, name


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("level,block", [("none", 128), ("int8", 64),
                                         ("int4", 64), ("int8", 256)])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "qwen3_0_6b"])
def test_shard_tree_blocks_reassemble(arch, level, block, mesh_shape):
    """int8 at block 256 on four ranks: wo's 256 rows split, its one row
    of scales kept whole, re-blocked to the rank's 64 rows."""
    cfg = get_config(arch).reduced().replace(weight_quant=level,
                                             weight_quant_block=block)
    whole = quant.quantize_params(build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(3)), cfg)
    blocks = _blocks(whole, cfg, mesh_shape)
    _reassembled(whole, blocks, cfg, mesh_shape)
    if (level, block, mesh_shape) == ("int8", 256, (1, 4)):
        wo = _flat(blocks[(0, 1)])["blocks/attn/wo"]
        assert (wo.block, wo.orig_dim, tuple(wo.scale.shape)) == (
            64, 64, (cfg.num_layers, 1, cfg.d_model))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_serving_keeps_the_serve_blocks(arch):
    """``Model.init_serving`` draws every matrix and keeps this rank's
    serve block: the same block of ``init``'s whole draw, and the bridge's
    serve mode cuts the same blocks (quantized first where the config
    asks, as the reference quantizes on load before placing)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, "cpu")
    whole = model.init(torch.Generator().manual_seed(4))
    tree = bridge.to_numpy(whole)
    for mesh_shape, coords in (((1, 4), (0, 3)), ((2, 2), (1, 1))):
        mesh = Axes(mesh_shape, *coords)
        want = _flat(sharding.shard_tree(
            whole, sharding.serve_specs(cfg, mesh), mesh))
        got = _flat(model.init_serving(torch.Generator().manual_seed(4),
                                       mesh))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        cut = _flat(bridge.from_jax_params(tree, cfg, "cpu", mesh=mesh,
                                           mode="serve"))
        assert all(torch.equal(cut[k], want[k]) for k in want)
        assert quant.tree_bytes(sharding.shard_tree(
            whole, sharding.serve_specs(cfg, mesh), mesh)) == \
            sharding.block_bytes(cfg, mesh)
    q8 = cfg.replace(weight_quant="int8", weight_quant_block=64)
    mesh = Axes((1, 4), 0, 2)
    want = _flat(sharding.shard_tree(quant.quantize_params(
        model.init(torch.Generator().manual_seed(4)), q8),
        sharding.serve_specs(q8, mesh), mesh))
    for got in (build_model(q8, "cpu").init_serving(
            torch.Generator().manual_seed(4), mesh),
            bridge.from_jax_params(tree, q8, "cpu", mesh=mesh,
                                   mode="serve")):
        got = _flat(got)
        for k, w in want.items():
            g = got[k]
            if isinstance(w, quant.QuantTensor):
                assert torch.equal(g.data, w.data) and torch.equal(
                    g.scale, w.scale), k
            else:
                assert torch.equal(g, w), k
