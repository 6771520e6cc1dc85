"""The port's quantized weight store (``repro_torch.core.quant``) and int8
KV quantizer against the JAX package's, bit for bit on the same numpy
inputs, and the quantized MoE forms against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import moe as jax_moe
from repro.core import quant as jq
from repro.models import attention as jax_attention
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import from_jax_params, to_numpy
from repro_torch.configs.base import get_config
from repro_torch.core import moe, quant
from repro_torch.models import attention

ARCH = "qwen3_moe_30b_a3b"


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x, dtype),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                 dtype)))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _assert_same_quant(got: quant.QuantTensor, want) -> None:
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.bits, got.block, got.orig_dim, got.out_dtype) == (
        want.bits, want.block, want.orig_dim, want.out_dtype)
    assert got.shape == want.shape


# K = 256: whole blocks; 200: ragged last block; 129: ragged and odd (int4
# pads a zero nibble)
@pytest.mark.parametrize("k", [256, 200, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", ["int8", "int4"])
def test_quantize_dequantize_bit_exact(level, dtype, k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, k, 24)).astype(np.float32)
    x[0, :, 3] *= 1e3                              # blocks of very
    x[1, :, 5] = 0.0                               # different absmax
    xj, xt = _pair(x, dtype)
    want = jq.quantize(xj, level, block=128)
    got = quant.quantize(xt, level, block=128)
    _assert_same_quant(got, want)
    for out in (None, "float32", "bfloat16"):
        dq = quant.dequantize(got, getattr(torch, out) if out else None)
        ref = jq.dequantize(want, jnp.dtype(out) if out else None)
        assert str(dq.dtype).split(".")[-1] == str(ref.dtype)
        np.testing.assert_array_equal(_np(dq), np.asarray(ref, np.float32))


@pytest.mark.parametrize("k", [6, 7])
@pytest.mark.parametrize("axis", [-2, 0])
def test_pack_unpack_int4_bit_exact(k, axis):
    """Nibble order (2i low, 2i+1 high), zero padding of an odd extent and
    sign extension of every value in [-8, 7]."""
    rng = np.random.default_rng(k)
    q = rng.integers(-8, 8, (k, 5)).astype(np.int8)
    q[:, 0] = np.resize(np.arange(-8, 8), k)
    packed = quant.pack_int4(torch.from_numpy(q), axis=axis)
    want = jq.pack_int4(jnp.asarray(q), axis=axis)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    back = quant.unpack_int4(packed, axis=axis)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jq.unpack_int4(want, axis=axis)))
    np.testing.assert_array_equal(back.numpy()[:k], q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype):
    """One block over hd, one scale per (token, head), bit for bit with
    the reference's quantize_kv / dequantize_kv as it runs eagerly."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 9, 2, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                               # an all-zero row
    xj, xt = _pair(x, dtype)
    qj, sj = jax_attention.quantize_kv(xj)
    qt, st = attention.quantize_kv(xt)
    assert tuple(st.shape) == sj.shape == (2, 9, 2, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        _np(attention.dequantize_kv(qt, st, torch.bfloat16)),
        np.asarray(jax_attention.dequantize_kv(qj, sj, jnp.bfloat16),
                   np.float32))


def test_quantize_kv_under_jit_one_ulp():
    """Inside a jitted step XLA on the CPU rewrites the reference's
    ``absmax / 127`` into ``absmax * f32(1/127)``, so the JAX engine's
    int8 KV scales may differ from the port's (and from its own eager
    ones) in the last bit; the payload agrees."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    qj, sj = jax.jit(jax_attention.quantize_kv)(jnp.asarray(x))
    qt, st = attention.quantize_kv(torch.from_numpy(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2 ** -23,
                               atol=0)
    amax = np.abs(x).max(-1, keepdims=True)
    np.testing.assert_array_equal(np.asarray(sj),
                                  amax * np.float32(1 / 127))
    np.testing.assert_array_equal(st.numpy(), amax / np.float32(127))
    assert np.abs(qt.numpy().astype(int) - np.asarray(qj)).max() <= 1


def _raw_params(level: str):
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced().replace(weight_quant=level)
    raw = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg.replace(weight_quant=level), cfg, raw


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("level", ["int8", "int4"])
def test_quantize_params_matches_bridged_jax_tree(level, inplace):
    """quantize_params of the bridged raw weights == the bridged
    JAX-quantized tree, leaf for leaf; router and embedding stay fp."""
    jcfg, cfg, raw = _raw_params(level)
    want = from_jax_params(
        jax.tree.map(np.asarray, jq.quantize_params(raw, jcfg)), cfg, "cpu")
    params = from_jax_params(jax.tree.map(np.asarray, raw), cfg, "cpu")
    got = quant.quantize_params(params, cfg, inplace=inplace)
    assert (got is params) == inplace
    pairs = dict(_leaves(want))
    assert sorted(dict(_leaves(got))) == sorted(pairs)
    kinds = set()
    for path, leaf in _leaves(got):
        ref = pairs[path]
        assert isinstance(leaf, quant.QuantTensor) == isinstance(
            ref, quant.QuantTensor), path
        if isinstance(leaf, quant.QuantTensor):
            kinds.add(quant.classify_weight(list(path)))
            _assert_same_quant(leaf, ref)
        else:
            assert torch.equal(leaf, ref), path
    assert kinds == {"attn", "experts", "lm_head"}
    assert not isinstance(got["embed"], quant.QuantTensor)
    assert not isinstance(got["blocks"]["router"], quant.QuantTensor)
    assert quant.tree_bytes(got) == jq.tree_bytes(jq.quantize_params(raw,
                                                                     jcfg))


def test_quantize_tree_policy():
    """'none' is the identity, quantized leaves pass through (idempotent),
    the embedding is refused, and the bridge round-trips a quantized
    tree."""
    _, cfg, raw = _raw_params("int8")
    params = from_jax_params(jax.tree.map(np.asarray, raw), cfg, "cpu")
    assert quant.quantize_tree(params, "none") is params
    q1 = quant.quantize_params(params, cfg)
    q2 = quant.quantize_params(q1, cfg.replace(weight_quant="int4"))
    w = q1["blocks"]["experts"]["w_gate"]
    assert q2["blocks"]["experts"]["w_gate"] is w and w.bits == 8
    with pytest.raises(ValueError, match="embedding"):
        quant.quantize_tree(params, "int8", kinds=("embed",))
    with pytest.raises(ValueError, match="unknown weight_quant"):
        quant.quantize(params["lm_head"], "int2")
    back = from_jax_params(to_numpy(q1), cfg, "cpu")
    _assert_same_quant(back["blocks"]["experts"]["w_gate"], w)
    assert torch.equal(back["embed"], q1["embed"])


def test_quanttensor_indexing():
    """Leading-axis slicing and gathers move payload and scales together;
    ``shape`` stays logical."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((3, 4, 129, 16)).astype(
        np.float32))
    qt = quant.quantize(w, "int4", block=64)
    assert qt.shape == (3, 4, 129, 16) and qt.data.shape == (3, 4, 65, 16)
    layer = qt[1]
    assert layer.shape == (4, 129, 16)
    idx = torch.tensor([[3, 0], [2, 2]])
    sel = layer[idx]
    assert sel.shape == (2, 2, 129, 16)
    torch.testing.assert_close(quant.dequantize(sel),
                               quant.dequantize(layer)[idx], rtol=0, atol=0)
    whole = quant.quantize(w[1], "int4", block=64)   # sliced == whole
    assert torch.equal(whole.data, layer.data)
    assert torch.equal(whole.scale, layer.scale)


def _quant_experts(level, e=4, d=96, f=80, block=32, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    raw = {"w_gate": mk(e, d, f), "w_up": mk(e, d, f), "w_down": mk(e, f, d)}
    jexp = {k: jq.quantize(jnp.asarray(v), level, block=block)
            for k, v in raw.items()}
    texp = {k: quant.quantize(torch.from_numpy(v), level, block=block)
            for k, v in raw.items()}
    return jexp, texp


@pytest.mark.parametrize("level", ["int8", "int4"])
def test_gather_moe_quantized_matches(level):
    """The decode gather over quantized experts (only the selected
    experts' payload and scales are gathered), with a dead-routed token."""
    jexp, texp = _quant_experts(level)
    rng = np.random.default_rng(7)
    t, k = 5, 2
    x = rng.standard_normal((t, 96)).astype(np.float32)
    idx = np.stack([rng.permutation(4)[:k] for _ in range(t)]).astype(
        np.int32)
    idx[3] = 4                                     # the E_pad sentinel
    w = rng.random((t, k)).astype(np.float32)
    want = jax_moe.gather_moe(jexp, jnp.asarray(x), jnp.asarray(idx),
                              jnp.asarray(w), 0)
    got = moe.gather_moe(texp, torch.from_numpy(x), torch.from_numpy(idx),
                         torch.from_numpy(w), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[3] == 0.0)


@pytest.mark.parametrize("form", ["dense", "dispatch"])
@pytest.mark.parametrize("level", ["int8", "int4"])
def test_moe_forms_quantized_match(level, form):
    """dense_moe and dispatch_moe route QuantTensor experts through the
    grouped FFN (the port's quant FFN plain version on the CPU, the
    reference's Pallas quant kernel in interpret mode)."""
    jexp, texp = _quant_experts(level, seed=1)
    rng = np.random.default_rng(8)
    t, k = 12, 2
    x = rng.standard_normal((t, 96)).astype(np.float32)
    idx = np.stack([rng.permutation(4)[:k] for _ in range(t)]).astype(
        np.int32)
    w = rng.random((t, k)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w))
    targs = (torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    if form == "dense":
        want = jax_moe.dense_moe(jexp, *jargs, 0, use_kernel=True)
        got = moe.dense_moe(texp, *targs, 0)
    else:
        want = jax_moe.dispatch_moe(jexp, *jargs, 4, 0, 16, use_kernel=True)
        got = moe.dispatch_moe(texp, *targs, 4, 0, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
