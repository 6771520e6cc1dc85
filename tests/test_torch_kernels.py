"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels (interpret mode) and their jnp oracles, on
the same numpy inputs.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.moe_gemm import moe_ffn_kernel
from repro.kernels.paged_attn import paged_attention
from repro_torch.kernels import ops

TOL = 2e-5
jit_paged_ref = jax.jit(ref.paged_attention_ref, static_argnames=("window",))


def _paged_case(seed, *, b, t, hq, hkv, hd, ps, nb, num_pages):
    """Random pool + per-row block tables (distinct pages per row) with
    lengths spread over the table's reach and ragged seg_lens."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, t, hq, hd)) * 0.1).astype(np.float32)
    bt = rng.permuted(np.tile(np.arange(num_pages), (b, 1)),
                      axis=1)[:, :nb].astype(np.int32)
    lengths = rng.integers(0, max(nb * ps - t, 1), b).astype(np.int32)
    seg = rng.integers(0, t + 1, b).astype(np.int32)
    shape = (num_pages, ps, hkv, hd)
    kp = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    vp = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return q, kp, vp, bt, lengths, seg


def _port_paged(q, kp, vp, bt, ln, sg, window):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return ops.paged_attention(t(q), t(kp), t(vp), t(bt), t(ln), t(sg),
                               window=window).numpy()


def _jax_paged(q, kp, vp, bt, ln, sg, window):
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, ln, sg)]
    got = paged_attention(*args, window=window, interpret=True)
    want = jit_paged_ref(*args, window=window)
    return np.asarray(got), np.asarray(want)


def _valid_rows(sg, t):
    return np.arange(t)[None, :] < sg[:, None]


# the sweep of tests/test_kernels.py: decode and chunked prefill, G in
# {2, 4}, a single kv head, page sizes dividing nothing, windowed or not
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("ps", [4, 5, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1), (8, 2)])
@pytest.mark.parametrize("t", [1, 3, 8])
def test_paged_attention_matches_jax(t, hq, hkv, ps, window):
    nb = -(-(t + 12) // ps) + 1
    case = _paged_case(t * 100 + hq * 10 + ps, b=3, t=t, hq=hq, hkv=hkv,
                       hd=32, ps=ps, nb=nb, num_pages=nb + 3)
    got = _port_paged(*case, window)
    pallas, oracle = _jax_paged(*case, window)
    valid = _valid_rows(case[5], t)
    np.testing.assert_allclose(got[valid], pallas[valid], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[valid], oracle[valid], rtol=TOL, atol=TOL)
    assert np.all(got[~valid] == 0.0)


def test_paged_attention_padding_rows_zero():
    q, kp, vp, bt, ln, _ = _paged_case(5, b=2, t=6, hq=4, hkv=2, hd=32,
                                       ps=4, nb=6, num_pages=8)
    sg = np.asarray([2, 0], np.int32)
    got = _port_paged(q, kp, vp, bt, ln, sg, None)
    assert np.all(got[0, 2:] == 0.0) and np.all(got[1] == 0.0)
    assert np.any(got[0, :2] != 0.0)


def test_paged_attention_garbage_pages_masked():
    """Pool pages outside every block table hold NaN/Inf; table entries
    past a row's live extent must not let them in."""
    case = list(_paged_case(7, b=2, t=3, hq=4, hkv=2, hd=32, ps=4, nb=4,
                            num_pages=8))
    garbage = np.setdiff1d(np.arange(8), np.unique(case[3]))
    assert garbage.size
    case[1][garbage] = np.nan
    case[2][garbage] = np.inf
    got = _port_paged(*case, None)
    pallas, oracle = _jax_paged(*case, None)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


def test_paged_attention_clamps_table_entries():
    """Out-of-pool table entries are clamped into [0, P), as the Pallas
    kernel's _page_index does."""
    q, kp, vp, bt, ln, sg = _paged_case(9, b=2, t=2, hq=4, hkv=2, hd=32,
                                        ps=4, nb=3, num_pages=6)
    bt[0, -1], bt[1, -1] = 99, -5
    got = _port_paged(q, kp, vp, bt, ln, sg, None)
    pallas, _ = _jax_paged(q, kp, vp, bt, ln, sg, None)
    valid = _valid_rows(sg, 2)
    np.testing.assert_allclose(got[valid], pallas[valid], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("e,c,d,f", [
    (1, 8, 64, 128),
    (4, 16, 128, 256),
    (3, 33, 96, 80),        # C and F not multiples of the blocks
    (2, 1, 128, 300),       # single-token capacity, ragged F
])
def test_moe_ffn_matches_jax(e, c, d, f):
    rng = np.random.default_rng(e * 1000 + c)
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    x, wg, wu, wd = mk(e, c, d), mk(e, d, f), mk(e, d, f), mk(e, f, d)
    got = ops.moe_ffn(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    args = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    pallas = moe_ffn_kernel(*args, block_c=16, block_f=64, interpret=True)
    oracle = ref.moe_ffn_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=1e-5, atol=1e-5)


def test_moe_ffn_zero_rows_exact():
    rng = np.random.default_rng(3)
    w = lambda *s: torch.from_numpy(
        (rng.standard_normal(s) * 0.1).astype(np.float32))
    y = ops.moe_ffn(torch.zeros(2, 16, 64), w(2, 64, 64), w(2, 64, 64),
                    w(2, 64, 64))
    assert float(y.abs().max()) == 0.0


def _bf16_steps(got: torch.Tensor, want) -> np.ndarray:
    """How many bf16 values lie between ``got`` and ``want``, per element."""
    def ordered(bits):
        i = bits.astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    g = got.contiguous().view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    return np.abs(ordered(g) - ordered(w))


def _same_bf16_rounding(got, want) -> bool:
    """At most one bf16 step apart, and only where fp32 summation order
    tips a rounding (a few elements at most)."""
    steps = _bf16_steps(got, want)
    return steps.max() <= 1 and (steps > 0).mean() <= 0.02


def test_moe_ffn_bf16_rounds_h_like_the_reference():
    """bf16 at O(1) outputs: h is rounded to bf16 before the
    down-projection (moe_gemm.py:43), exactly as in the Pallas kernel and
    the jnp oracle.  A version that leaves h in fp32 moves about 40 % of
    the outputs by a bf16 step, and the check must see that."""
    rng = np.random.default_rng(11)
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    wg, wu, wd = mk(2, 64, 96), mk(2, 64, 96), mk(2, 96, 64)
    args = [torch.from_numpy(a).bfloat16() for a in (x, wg, wu, wd)]
    got = ops.moe_ffn(*args)
    assert got.dtype == torch.bfloat16
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, wg, wu, wd)]
    oracle = ref.moe_ffn_ref(*jargs)
    pallas = moe_ffn_kernel(*jargs, block_c=8, block_f=32, interpret=True)
    assert float(np.abs(np.asarray(oracle, np.float32)).max()) > 1.0
    assert _same_bf16_rounding(got, oracle)
    assert _same_bf16_rounding(got, pallas)
    xf, wgf, wuf, wdf = (a.float() for a in args)
    h32 = torch.nn.functional.silu(xf @ wgf) * (xf @ wuf)
    unrounded = (h32 @ wdf).bfloat16()
    assert not _same_bf16_rounding(unrounded, oracle)


def test_cuda_wrappers_reject_cpu_tensors():
    """On a CPU tensor only the plain version runs: the kernel wrappers
    themselves refuse it (no silent fallback)."""
    from repro_torch.kernels import moe_gemm
    from repro_torch.kernels import paged_attn as port_paged_attn
    x = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="must be on"):
        moe_gemm.moe_ffn_kernel(x, torch.zeros(1, 4, 4), torch.zeros(1, 4, 4),
                                torch.zeros(1, 4, 4))
    q = torch.zeros(1, 1, 2, 4)
    pool = torch.zeros(2, 2, 1, 4)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        port_paged_attn.paged_attention(q, pool, pool, i32(1, 1), i32(1),
                                        i32(1))
    assert ops.launch_counts() == {"moe_ffn": 0, "paged_attention": 0}
