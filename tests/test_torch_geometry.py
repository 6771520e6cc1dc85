"""The kernels' widened geometry on the CPU: the plain versions at the
head dims and FFN widths the CUDA kernels now take (phi-2's hd 80,
phi-3-mini's hd 96, an FFN of D 320 and F 200) against the JAX package's
Pallas kernels in interpret mode and their oracles, on the same numpy
inputs.  The CUDA kernels run these geometries on their existing
instantiations (flash and paged attention at width 128, the FFN through
zero-filled, masked edge tiles) and are held to these plain versions on
the card by ``chip_smoke.py``'s phase 3."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_kernel_quant
from test_torch_flash import _from_jax, _jax_inputs, _pallas, _port
from test_torch_kernels import (_int8_pools, _jax_paged, _paged_case,
                                _port_paged, _quant_weights, _valid_rows)
from repro_torch.kernels import ops

# fp32 2e-5 and bf16 3e-2 for flash (the port's kernel tolerances); the
# paged and FFN plain versions in fp32 within 1e-5 of the reference, as
# at the other widths (tests/test_torch_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TOL_FP32 = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 8), (False, None)])
@pytest.mark.parametrize("hd", [80, 96])
def test_flash_head_dims_80_and_96_match_pallas_kernel(hd, causal, window,
                                                       dtype):
    """The flash plain version against the Pallas kernel (S=40 over
    32-wide blocks, G=2, causal within a window of 8) and the oracle;
    with causal=False S is a whole number of blocks (the Pallas kernel
    attends a ragged S's padding there)."""
    s = 40 if causal else 64
    rng = np.random.default_rng(hd + s)
    q, k, v = (rng.standard_normal((2, s, h, hd)).astype(np.float32)
               for h in (4, 2, 2))
    if dtype == "bfloat16":
        q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (q, k, v))
    kw = dict(causal=causal, window=window)
    got = _port(q, k, v, dtype, **kw)
    np.testing.assert_allclose(got, _pallas(q, k, v, dtype, **kw),
                               rtol=TOL[dtype], atol=TOL[dtype])
    oracle = _from_jax(ref.flash_attention_ref(
        *_jax_inputs(q, k, v, dtype), **kw))
    np.testing.assert_allclose(got, oracle, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("hd", [80, 96])
def test_paged_head_dims_80_and_96_match_jax(hd, t, int8):
    """The paged plain version against the Pallas kernel and its oracle,
    fp and int8 pools (G=4, pages of 5), padding rows exactly zero."""
    nb = -(-(t + 12) // 5) + 1
    q, kp, vp, bt, ln, sg = _paged_case(hd + t, b=3, t=t, hq=8, hkv=2,
                                        hd=hd, ps=5, nb=nb,
                                        num_pages=nb + 3)
    case = (q, kp, vp, bt, ln, sg, None)
    if int8:
        kq, vq, scales = _int8_pools(kp, vp)
        case = (q, kq, vq, bt, ln, sg, None, scales)
    got = _port_paged(*case)
    pallas, oracle = _jax_paged(*case)
    valid = _valid_rows(sg, t)
    np.testing.assert_allclose(got[valid], pallas[valid], rtol=TOL_FP32,
                               atol=TOL_FP32)
    np.testing.assert_allclose(got[valid], oracle[valid], rtol=TOL_FP32,
                               atol=TOL_FP32)
    assert np.all(got[~valid] == 0.0)


def test_ffn_at_d_320_f_200_matches_jax():
    """The grouped FFN's plain version at D 320, F 200 (neither on the
    bf16 kernel's old 128 / 64 tiles) against the Pallas kernel and its
    oracle."""
    rng = np.random.default_rng(320)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    x, wg, wu, wd = mk(2, 16, 320), mk(2, 320, 200), mk(2, 320, 200), \
        mk(2, 200, 320)
    got = ops.moe_ffn(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    args = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    pallas = moe_ffn_kernel(*args, block_c=16, block_f=64, interpret=True)
    oracle = ref.moe_ffn_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=TOL_FP32, atol=TOL_FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=TOL_FP32, atol=TOL_FP32)


@pytest.mark.parametrize("level", ["int8", "int4"])
def test_quant_ffn_at_d_320_f_200_matches_jax(level):
    """The quantized FFN's plain version at D 320, F 200 in blocks of 64
    (F not a whole number of blocks: the reference pads it with zero
    weights) against the Pallas kernel and its oracle."""
    rng = np.random.default_rng(200)
    x = rng.standard_normal((2, 8, 320)).astype(np.float32)
    jw, tw = _quant_weights(rng, 2, 320, 200, level, 64)
    got = ops.moe_ffn(torch.from_numpy(x), *tw)
    pallas = moe_ffn_kernel_quant(jnp.asarray(x), *jw, block_c=8,
                                  block_f=64, interpret=True)
    oracle = ref.moe_ffn_ref_quant(jnp.asarray(x), *jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=TOL_FP32, atol=TOL_FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=TOL_FP32, atol=TOL_FP32)
