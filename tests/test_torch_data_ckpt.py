"""The port's data pipeline, checkpoint files and prestacking converter
(``repro_torch.data``, ``repro_torch.ckpt``, ``repro_torch.core.prestack``)
against the JAX package's on the same numpy inputs.

Everything here is exact: batches bit for bit, checkpoint entries equal
in key, dtype and bytes in both directions (fp32 trees, int8/int4
QuantTensor trees, and bf16, which the port writes as the reference does,
a ``|V2`` entry holding the bf16 bits), and the converters equal the
reference's outputs entry by entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import io as jckpt
from repro.core import quant as jquant
from repro.data import pipeline as jpipe
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.ckpt import io as ckpt
from repro_torch.core import prestack
from repro_torch.data import pipeline
from torch_archs import reduced_pair


def _np_leaf(v):
    if isinstance(v, torch.Tensor):
        return ckpt.to_npz_array(v)
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_flat(port_tree, jax_tree):
    """Equal keys, and equal values bit for bit (bf16 compared as its
    bits), through each side's own ``flatten_tree``."""
    got, want = ckpt.flatten_tree(port_tree), jckpt.flatten_tree(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = _np_leaf(got[k]), _np_leaf(want[k])
        if a.dtype.kind == "V":
            a = a.view(np.uint16)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_equal_reference(seed):
    pc = dict(seq_len=48, global_batch=3, vocab_size=500, seed=seed)
    ours = pipeline.Pipeline(pipeline.PipelineConfig(**pc))
    ref = jpipe.Pipeline(jpipe.PipelineConfig(**pc))
    for _ in range(4):
        a, b = ours.next_batch(), ref.next_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("doc_sep", [None, 5])
def test_memmap_batches_equal_reference(tmp_path, doc_sep):
    path = tmp_path / "toks.bin"
    (np.arange(10_000, dtype=np.uint16) % 97).tofile(path)
    pc = dict(seq_len=32, global_batch=4, vocab_size=97)
    ours = pipeline.Pipeline(pipeline.PipelineConfig(**pc),
                             pipeline.MemmapSource(str(path), doc_sep=doc_sep))
    ref = jpipe.Pipeline(jpipe.PipelineConfig(**pc),
                         jpipe.MemmapSource(str(path), doc_sep=doc_sep))
    for _ in range(3):
        a, b = ours.next_batch(), ref.next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_shard_batch_waits_for_meshes():
    """A rank's rows of a global batch under ``batch_pspec``: split over the
    data axes when they divide the batch, whole otherwise (the same rows
    ``expert_parallel.batch_shard`` cuts)."""
    import types
    from repro_torch.core import expert_parallel
    b = {"tokens": np.arange(8 * 3).reshape(8, 3),
         "labels": np.arange(8 * 3).reshape(8, 3) + 1}
    for shape, coords, rows in (((2, 2), (1, 0), slice(4, 8)),
                                ((2, 2), (0, 1), slice(0, 4)),
                                ((1, 4), (0, 3), slice(0, 8))):
        mesh = types.SimpleNamespace(
            axis_names=("data", "model"),
            shape=dict(zip(("data", "model"), shape)),
            coords=dict(zip(("data", "model"), coords)))
        got = pipeline.shard_batch(b, mesh)
        for k in b:
            np.testing.assert_array_equal(got[k], b[k][rows])
        assert expert_parallel.batch_shard(mesh, 8)[1] == rows
        odd = pipeline.shard_batch({"tokens": b["tokens"][:3]}, mesh)
        assert odd["tokens"].shape[0] == 3


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

def _jax_params(arch="granite_moe_3b_a800m", **kw):
    jcfg, cfg = reduced_pair(arch, **kw)
    return jcfg, cfg, jax_build_model(jcfg).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("level", ["none", "int8", "int4"])
def test_jax_checkpoint_restores_into_port(tmp_path, level):
    jcfg, cfg, jparams = _jax_params(weight_quant=level)
    jparams = jquant.quantize_params(jparams, jcfg)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jparams, step=17)
    params, step = ckpt.restore(path, device="cpu")
    assert step == 17
    _assert_same_flat(params, jparams)
    if level != "none":
        qt = params["blocks"]["experts"]["w_gate"]
        assert isinstance(qt, ckpt.quant.QuantTensor)
        assert qt.bits == {"int8": 8, "int4": 4}[level]


def test_port_checkpoint_restores_into_jax(tmp_path):
    _, cfg, jparams = _jax_params("qwen3_0_6b")
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    path = str(tmp_path / "port")
    ckpt.save(path, params, step=5)
    restored, step = jckpt.restore(path)
    assert step == 5
    _assert_same_flat(params, restored)


def test_bf16_file_equals_the_reference_file(tmp_path):
    """The port writes bf16 leaves as the reference does (same keys, the
    ``|V2`` dtype, the same bits) and reads them back as bf16; the
    reference's own restore refuses that file (ROADMAP queue C)."""
    bf16 = dict(dtype="bfloat16", param_dtype="bfloat16")
    _, cfg, jparams = _jax_params(**bf16)
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save(jpath, jparams, step=3)
    ckpt.save(ppath, params, step=3)
    with np.load(jpath) as zj, np.load(ppath) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype.str == zp[k].dtype.str, k
            assert zj[k].shape == zp[k].shape, k
            assert zj[k].tobytes() == zp[k].tobytes(), k
        assert zj["embed"].dtype.str == "|V2"
    for path in (jpath, ppath):
        restored, step = ckpt.restore(path, device="cpu")
        assert step == 3
        assert restored["embed"].dtype == torch.bfloat16
        _assert_same_flat(restored, jparams)
    with pytest.raises(TypeError):
        jckpt.restore(jpath)


# ---------------------------------------------------------------------------
# the prestacking converter
# ---------------------------------------------------------------------------

def _unstacked(L=3, E=5, D=4, F=8):
    rng = np.random.default_rng(1)
    out = {}
    for i in range(L):
        layer = {"ln": np.ones((D,), np.float32),
                 "attn": {"wq": rng.normal(size=(D, D)).astype(np.float32)}}
        for e in range(E):
            layer[f"expert_{e}"] = {
                w: rng.normal(size=shape).astype(np.float32)
                for w, shape in (("w_gate", (D, F)), ("w_up", (D, F)),
                                 ("w_down", (F, D)))}
        out[f"layer_{i}"] = layer
    return out


def _tmap(fn, tree):
    return ({k: _tmap(fn, v) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


@pytest.mark.parametrize("level", ["none", "int8", "int4"])
def test_convert_unstacked_equals_reference(level):
    un = _unstacked()
    want = jckpt.convert_unstacked(_tmap(jnp.asarray, un),
                                   num_experts_padded=8, weight_quant=level,
                                   weight_quant_block=4)
    got = ckpt.convert_unstacked(_tmap(torch.from_numpy, un),
                                 num_experts_padded=8, weight_quant=level,
                                 weight_quant_block=4)
    _assert_same_flat(got, want)
    if level == "none":
        assert got["experts"]["w_gate"].shape == (3, 8, 4, 8)
        assert not got["experts"]["w_gate"][:, 5:].any()
    back = ckpt.to_unstacked(got, 3)
    want_back = jckpt.to_unstacked(want, 3)
    assert set(back) == set(want_back) == {"layer_0", "layer_1", "layer_2"}
    for k in back:
        _assert_same_flat(back[k], want_back[k])


def test_quantize_on_load_equals_reference(tmp_path):
    jcfg, cfg, jparams = _jax_params(weight_quant="int8")
    path = str(tmp_path / "fp.npz")
    jckpt.save(path, jparams, step=2)
    want, _ = jckpt.quantize_on_load(path, jcfg)
    got, step = ckpt.quantize_on_load(path, cfg, device="cpu")
    assert step == 2
    _assert_same_flat(got, want)
    # idempotent: a quantized checkpoint passes through
    ckpt.save(path, got, step=2)
    again, _ = ckpt.quantize_on_load(path, cfg, device="cpu")
    _assert_same_flat(again, want)


def test_prestack_roundtrip_and_padding():
    _, cfg, jparams = _jax_params()
    blocks = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    "cpu")["blocks"]
    assert prestack.validate_roundtrip(blocks)
    layers = prestack.unstack_blocks(blocks)
    assert len(layers) == cfg.num_layers
    q = prestack.quantize_blocks(blocks, "int4", block=64)
    assert prestack.validate_roundtrip(q)
    assert prestack.unstack_blocks(q)[1]["experts"]["w_up"].data.shape[0] \
        == cfg.num_experts_padded
    experts = prestack.stack_experts(
        [{"w": torch.ones(2, 3)}, {"w": 2 * torch.ones(2, 3)}])
    padded = prestack.pad_experts(experts, 4)
    assert padded["w"].shape == (4, 2, 3)
    assert torch.equal(padded["w"][:2], experts["w"])
    assert not padded["w"][2:].any()
    with pytest.raises(ValueError):
        prestack.pad_experts(experts, 1)


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    path = str(tmp_path / "x.npz")
    ckpt.save(path, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.restore(path)
