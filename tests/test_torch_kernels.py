"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels (interpret mode) and their jnp oracles, on
the same numpy inputs.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ref
from repro.kernels.moe_gemm import moe_ffn_kernel, moe_ffn_kernel_quant
from repro.kernels.paged_attn import paged_attention
from repro_torch.core import quant
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


def _port_paged(q, kp, vp, bt, ln, sg, window, scales=None):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ks, vs = (None, None) if scales is None else (t(s) for s in scales)
    return ops.paged_attention(t(q), t(kp), t(vp), t(bt), t(ln), t(sg),
                               k_scale=ks, v_scale=vs, window=window).numpy()


def _jax_paged(q, kp, vp, bt, ln, sg, window, scales=None):
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, ln, sg)]
    kw = {} if scales is None else dict(
        k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
    got = paged_attention(*args, window=window, interpret=True, **kw)
    want = jit_paged_ref(*args, window=window, **kw)
    return np.asarray(got), np.asarray(want)


def _int8_pools(kp, vp):
    """Quantize fp pools the way the engine writes them: one scale per
    (slot, kv head)."""
    out = []
    for pool in (kp, vp):
        q, s = jq.absmax_quantize(jnp.asarray(pool), bits=8,
                                  block=pool.shape[-1], axis=-1)
        out += [np.array(q), np.array(s)]
    kq, ks, vq, vs = out
    return kq, vq, (ks, vs)


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


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("ps", [4, 5])
@pytest.mark.parametrize("t", [1, 8])
def test_paged_attention_int8_matches_jax(t, ps, window):
    """int8 pools with fp32 scale pools: K/V dequantized to q's dtype
    before the dot, as the reference's quantized branch does."""
    nb = -(-(t + 12) // ps) + 1
    q, kp, vp, bt, ln, sg = _paged_case(t * 10 + ps, b=3, t=t, hq=8, hkv=2,
                                        hd=32, ps=ps, nb=nb,
                                        num_pages=nb + 3)
    kq, vq, scales = _int8_pools(kp, vp)
    case = (q, kq, vq, bt, ln, sg, window, scales)
    got = _port_paged(*case)
    pallas, oracle = _jax_paged(*case)
    valid = _valid_rows(sg, t)
    np.testing.assert_allclose(got[valid], pallas[valid], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[valid], oracle[valid], rtol=1e-5,
                               atol=1e-5)
    assert np.all(got[~valid] == 0.0)


@pytest.mark.parametrize("hd,ok", [(1, True), (80, True), (96, True),
                                   (200, True), (256, True), (320, False)])
def test_paged_geometry_check(hd, ok):
    """The paged kernel takes any hd from 1 to 256 (its widest
    instantiation), as the reference's kernel takes any, and refuses a
    wider one; whole query groups, a page and a table column."""
    from repro_torch.kernels import paged_attn
    if ok:
        paged_attn.check_geometry(32, 8, hd, 4, 2)
    else:
        with pytest.raises(ValueError, match="unsupported geometry"):
            paged_attn.check_geometry(32, 8, hd, 4, 2)
    for args in ((32, 6, 64, 4, 2), (32, 8, 64, 0, 2), (32, 8, 64, 4, 0)):
        with pytest.raises(ValueError, match="unsupported geometry"):
            paged_attn.check_geometry(*args)


def test_paged_attention_int8_garbage_scales_masked():
    """Unreferenced pages of an int8 pool with NaN/Inf scales never reach
    a valid row."""
    q, kp, vp, bt, ln, sg = _paged_case(8, b=2, t=3, hq=4, hkv=2, hd=32,
                                        ps=4, nb=4, num_pages=8)
    kq, vq, (ks, vs) = _int8_pools(kp, vp)
    garbage = np.setdiff1d(np.arange(8), np.unique(bt))
    assert garbage.size
    ks[garbage], vs[garbage] = np.nan, np.inf
    case = (q, kq, vq, bt, ln, sg, None, (ks, vs))
    got = _port_paged(*case)
    pallas, _ = _jax_paged(*case)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


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


def _quant_weights(rng, e, d, f, level, block, scale=None):
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(scale or s[-2])
                     ).astype(np.float32)
    raw = (mk(e, d, f), mk(e, d, f), mk(e, f, d))
    jw = [jq.quantize(jnp.asarray(w), level, block=block) for w in raw]
    tw = [quant.quantize(torch.from_numpy(w), level, block=block)
          for w in raw]
    return jw, tw


# F (and D) not multiples of the quantization block exercise the
# reference's zero-scale padding (moe_gemm.py:174-185); F=75 is odd too,
# so int4 w_down packs a zero nibble
@pytest.mark.parametrize("level", ["int8", "int4"])
@pytest.mark.parametrize("e,c,d,f,block", [
    (2, 8, 64, 128, 32),
    (3, 17, 96, 80, 32),
    (2, 5, 72, 75, 16),
])
def test_moe_ffn_quant_matches_jax(level, e, c, d, f, block):
    rng = np.random.default_rng(e * 100 + f)
    x = (rng.standard_normal((e, c, d))).astype(np.float32)
    jw, tw = _quant_weights(rng, e, d, f, level, block)
    got = ops.moe_ffn(torch.from_numpy(x), *tw)
    pallas = moe_ffn_kernel_quant(jnp.asarray(x), *jw, block_c=8,
                                  block_f=64, interpret=True)
    oracle = ref.moe_ffn_ref_quant(jnp.asarray(x), *jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("level", ["int8", "int4"])
def test_moe_ffn_quant_bf16_rounds_like_the_reference(level):
    """bf16 activations: each weight value is bf16(float(q) * s) and h is
    rounded to bf16, as in the reference's quant kernel and oracle."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jw, tw = _quant_weights(rng, 2, 64, 96, level, 32)
    xt = torch.from_numpy(x).bfloat16()
    got = ops.moe_ffn(xt, *tw)
    assert got.dtype == torch.bfloat16
    oracle = ref.moe_ffn_ref_quant(jnp.asarray(x, jnp.bfloat16), *jw)
    pallas = moe_ffn_kernel_quant(jnp.asarray(x, jnp.bfloat16), *jw,
                                  block_c=8, block_f=32, interpret=True)
    assert float(np.abs(np.asarray(oracle, np.float32)).max()) > 1.0
    assert _same_bf16_rounding(got, oracle)
    assert _same_bf16_rounding(got, pallas)


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
    scale = torch.zeros(2, 2, 1, 1)
    with pytest.raises(ValueError, match="must be on"):
        port_paged_attn.paged_attention_int8(
            q, pool.to(torch.int8), pool.to(torch.int8), scale, scale,
            i32(1, 1), i32(1), i32(1))
    w = quant.quantize(torch.ones(1, 4, 4), "int8", block=4)
    with pytest.raises(ValueError, match="must be on"):
        moe_gemm.moe_ffn_kernel_quant(x, w, w, w)
    assert ops.launch_counts() == {"moe_ffn": 0, "moe_ffn_quant": 0,
                                   "paged_attention": 0,
                                   "paged_attention_int8": 0,
                                   "flash_attention": 0}


def _grad_cases():
    """Each kernel entry with CPU inputs, one of which requires grad."""
    from repro_torch.kernels import flash_attn, moe_gemm
    from repro_torch.kernels import paged_attn as port_paged_attn
    x = torch.zeros(1, 1, 4, requires_grad=True)
    w = torch.zeros(1, 4, 4)
    wq = quant.quantize(torch.ones(1, 4, 4), "int8", block=4)
    q = torch.zeros(1, 1, 2, 4, requires_grad=True)
    pool, scale = torch.zeros(2, 2, 1, 4), torch.zeros(2, 2, 1, 1)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    tables = (i32(1, 1), i32(1), i32(1))
    return {
        "moe_ffn": lambda: moe_gemm.moe_ffn_kernel(x, w, w, w),
        "moe_ffn_quant": lambda: moe_gemm.moe_ffn_kernel_quant(x, wq, wq, wq),
        "paged_attention": lambda: port_paged_attn.paged_attention(
            q, pool, pool, *tables),
        "paged_attention_int8": lambda: port_paged_attn.paged_attention_int8(
            q, pool.to(torch.int8), pool.to(torch.int8), scale, scale,
            *tables),
        "flash_attention": lambda: flash_attn.flash_attention(
            torch.zeros(1, 2, 2, 64), torch.zeros(1, 2, 1, 64),
            torch.zeros(1, 2, 1, 64, requires_grad=True)),
    }


@pytest.mark.parametrize("entry", sorted(_grad_cases()))
def test_kernel_wrappers_refuse_grad(entry):
    """A kernel's output has no grad_fn, so a wrapper given an input that
    requires grad raises (as the reference does) instead of returning a
    tensor whose gradient silently skips the kernel; the check comes
    before the device check, so the CPU shows it without launching.
    Under no_grad the same call reaches the device check."""
    call = _grad_cases()[entry]
    with pytest.raises(NotImplementedError,
                       match=f"gradients through the {entry} kernel"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="must be on"):
        call()
    assert ops.launch_counts()[entry] == 0


@pytest.mark.parametrize("d,f,dtype,ok", [
    (2048, 768, torch.bfloat16, True),      # qwen3-moe-30b-a3b
    (256, 512, torch.bfloat16, True),       # its reduced config
    (96, 80, torch.bfloat16, True),         # bf16: any widths
    (2048, 700, torch.bfloat16, True),
    (2040, 768, torch.bfloat16, True),
    (192, 768, torch.bfloat16, True),       # D off the 128-wide tiles
    (96, 80, torch.float32, True),          # fp32: any widths
    (2048, 768, torch.float32, True),
    (2048, 2048, torch.float32, True),
    (6144, 10752, torch.float32, True),     # DBRX
    (2880, 2880, torch.bfloat16, True),     # gpt-oss
    (320, 201, torch.bfloat16, True),       # F not a multiple of 8
    (0, 768, torch.bfloat16, False),
    (2048, 0, torch.float32, False),
])
def test_ffn_dims_check(d, f, dtype, ok):
    """Both types take any widths, as the reference's kernel does (bf16
    zero-fills and masks its edge tiles; fp32 tiles D and F through shared
    memory), and raise only on an empty one (no fallback)."""
    from repro_torch.kernels import moe_gemm
    if ok:
        moe_gemm.check_ffn_dims(d, f, dtype)
    else:
        with pytest.raises(ValueError, match="moe_ffn_kernel"):
            moe_gemm.check_ffn_dims(d, f, dtype)


def test_ffn_h_scratch_and_entries():
    """Both types pass h (E, C, F) between their two launches through a
    scratch the wrapper allocates, in x's dtype (bf16 rounded, fp32 as it
    is), and both C entries take that pointer."""
    from repro_torch.kernels import build, moe_gemm
    assert moe_gemm.h_scratch_spec(128, 320, 768, torch.bfloat16) == (
        (128, 320, 768), torch.bfloat16)
    assert moe_gemm.h_scratch_spec(4, 5, 512, torch.float32) == (
        (4, 5, 512), torch.float32)
    assert moe_gemm.ffn_entry(torch.float32) == "moe_ffn_f32"
    assert moe_gemm.ffn_entry(torch.bfloat16) == "moe_ffn_bf16"
    with pytest.raises(ValueError, match="no kernel"):
        moe_gemm.ffn_entry(torch.float16)
    pointers = lambda name: build.SIGNATURES[name].count(build._P)
    assert pointers("moe_ffn_bf16") == pointers("moe_ffn_f32") == 7


# ---------------------------------------------------------------------------
# the paged kernel's work split (csrc/paged_attn.cu): split plan and combine
# ---------------------------------------------------------------------------

def _tile_tokens(r0, seg, t, g):
    """A 16-row tile's valid tokens t_lo..t_hi (the kernel's tile_tokens)."""
    from repro_torch.kernels import paged_attn as pa
    return r0 // g, min((r0 + pa.ROWS - 1) // g, t - 1, seg - 1)


@pytest.mark.parametrize("seed", range(8))
def test_paged_split_plan_covers_live_pages_once(seed):
    """Over random shapes, lengths, seg_lens and windows, the splits of
    every row tile cut its live pages into disjoint ranges whose union is
    exactly the slots its valid tokens attend; the number of splits comes
    from shapes alone (num_splits takes no length).  ``split_keys`` is the
    host's copy of the kernel's plan and must stay in step with it;
    ``chip_smoke.py``'s paged sweep holds the device's plan."""
    import inspect
    from repro_torch.kernels import paged_attn as pa
    assert "length" not in " ".join(inspect.signature(pa.num_splits).parameters)
    rng = np.random.default_rng(seed)
    for _ in range(40):
        b, t = int(rng.integers(1, 5)), int(rng.choice([1, 2, 3, 8, 32]))
        hkv, g = int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 8]))
        ps, nb = int(rng.choice([4, 5, 16])), int(rng.integers(1, 300))
        splits = pa.num_splits(b, t * g, hkv, nb, ps,
                               int(rng.choice([8, 132])))
        assert 1 <= splits <= min(pa.MAX_SPLITS, -(-nb * ps // pa.KEYS))
        window = None if rng.random() < 0.5 else int(rng.integers(1, 200))
        for _ in range(b):
            length = int(rng.integers(0, nb * ps + 4))
            seg = int(rng.integers(0, t + 1))
            for r0 in range(0, t * g, pa.ROWS):
                t_lo, t_hi = _tile_tokens(r0, seg, t, g)
                want = set()
                for tok in range(t_lo, t_hi + 1):
                    qp = length + tok
                    lo = max(qp - window + 1, 0) if window else 0
                    want.update(range(lo, min(qp, nb * ps - 1) + 1))
                got, pages = [], []
                for s in range(splits):
                    js, je = pa.split_keys(length, t_lo, t_hi, window, ps,
                                           nb, splits, s)
                    if js < je:
                        got += range(js, je)
                        pages.append(set(range(js // ps, (je - 1) // ps + 1)))
                assert len(got) == len(set(got)) and set(got) == want
                assert sum(map(len, pages)) == len(set().union(*pages))


def _split_combine_emulation(q, kp, vp, bt, ln, sg, window, splits):
    """The kernel's split-then-combine in torch, fp32: each split's (m, l,
    unnormalized acc) over its slots, merged as
    out = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30) over
    the splits with l_s > 0; padding rows exactly zero.  The splits come
    from ``split_keys``, the host's copy of the kernel's plan."""
    from repro_torch.kernels import paged_attn as pa
    b, t, hq, hd = q.shape
    num_pages, ps, hkv, _ = kp.shape
    nb, g = bt.shape[1], hq // hkv
    out = torch.zeros_like(q)
    for i in range(b):
        pages = bt[i].long().clamp(0, num_pages - 1)
        k = kp[pages].reshape(nb * ps, hkv, hd)
        v = vp[pages].reshape(nb * ps, hkv, hd)
        length, seg = int(ln[i]), int(sg[i])
        for h in range(hkv):
            for r0 in range(0, t * g, pa.ROWS):
                t_lo, t_hi = _tile_tokens(r0, seg, t, g)
                parts = [pa.split_keys(length, t_lo, t_hi, window, ps, nb,
                                       splits, s) for s in range(splits)]
                for r in range(r0, min(r0 + pa.ROWS, t * g)):
                    tok, head = r // g, h * g + r % g
                    if tok >= seg:
                        continue
                    qp = length + tok
                    ms, ls, accs = [], [], []
                    for js, je in parts:
                        j = torch.arange(js, max(js, je))
                        j = j[(j <= qp) & ((j > qp - window) if window
                                           else True)]
                        if j.numel() == 0:
                            ms.append(pa.NEG_INF)
                            ls.append(0.0)
                            accs.append(None)
                            continue
                        logit = (k[j, h] @ q[i, tok, head]) * hd ** -0.5
                        m = logit.max()
                        p = torch.exp(logit - m)
                        ms.append(float(m))
                        ls.append(float(p.sum()))
                        accs.append(p @ v[j, h])
                    live = [s for s in range(splits) if ls[s] > 0]
                    if not live:
                        continue
                    big_m = max(ms[s] for s in live)
                    w = {s: float(np.exp(ms[s] - big_m)) for s in live}
                    num = sum(w[s] * accs[s] for s in live)
                    den = max(sum(w[s] * ls[s] for s in live), 1e-30)
                    out[i, tok, head] = num / den
    return out


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("t,ps", [(1, 4), (3, 5), (8, 4)])
def test_paged_split_combine_matches_plain(t, ps, window, splits):
    """Split-then-combine with the combine kernel's formula equals the
    plain page walk in fp32 (2e-5), with splits that come out empty (short
    rows, rows of seg 0), windows and exactly-zero padding rows."""
    nb = -(-(t + 140) // ps) + 1     # rows long enough for several splits
    q, kp, vp, bt, ln, sg = (torch.from_numpy(a) for a in _paged_case(
        t * 7 + ps + splits, b=3, t=t, hq=4, hkv=2, hd=32, ps=ps, nb=nb,
        num_pages=nb + 3))
    ln[0] = 0                      # a one-page row, an all-padding row
    sg[:] = torch.tensor([t, 0, max(t - 1, 1)])
    got = _split_combine_emulation(q, kp, vp, bt, ln, sg, window, splits)
    want = ops.paged_attention(q, kp, vp, bt, ln, sg, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    valid = _valid_rows(sg.numpy(), t)
    assert np.all(got.numpy()[~valid] == 0.0)
    assert np.any(got.numpy()[valid] != 0.0)


@pytest.mark.parametrize("d,f,bits,qb,dtype,ok", [
    (2048, 768, 8, 128, torch.bfloat16, True),     # qwen3-moe-30b-a3b
    (2048, 768, 4, 128, torch.bfloat16, True),
    (6144, 10752, 8, 128, torch.bfloat16, True),   # DBRX, now on wgmma
    (256, 512, 4, 2, torch.bfloat16, True),        # any even block
    (256, 512, 8, 6, torch.bfloat16, True),
    (256, 512, 8, 3, torch.bfloat16, False),       # odd block
    (256, 512, 2, 128, torch.bfloat16, False),
    (192, 512, 8, 128, torch.bfloat16, True),      # D off the 128-wide tiles
    (256, 500, 8, 128, torch.bfloat16, True),      # F off the 64-wide tiles
    (2880, 2880, 8, 128, torch.bfloat16, True),    # gpt-oss
    (2880, 2880, 4, 128, torch.bfloat16, True),
    (96, 80, 8, 32, torch.bfloat16, True),
    (96, 80, 4, 32, torch.bfloat16, True),
    (96, 80, 8, 32, torch.float32, True),          # fp32: any widths
    (2048, 768, 4, 128, torch.float32, True),
    (6144, 10752, 8, 128, torch.float32, True),    # DBRX in fp32 too
    (6144, 10752, 4, 128, torch.float32, True),
])
def test_quant_ffn_dims_check(d, f, bits, qb, dtype, ok):
    """The quantized FFN takes any widths in both types, as the reference
    does (a width that is not a whole number of blocks reads as padded
    with zero weights), int8 or int4 in any even block; it raises on a
    payload width or an odd block it never took."""
    from repro_torch.kernels import moe_gemm
    if ok:
        moe_gemm.check_quant_dims(d, f, bits, qb, dtype)
    else:
        with pytest.raises(ValueError, match="moe_ffn_kernel_quant"):
            moe_gemm.check_quant_dims(d, f, bits, qb, dtype)


@pytest.mark.parametrize("f,bf16_rows", [(768, 768), (200, 200),
                                         (201, 208), (75, 80)])
def test_ffn_h_scratch_rows_are_16_byte_aligned(f, bf16_rows):
    """bf16's h scratch rows are F rounded up to 8 (16 bytes), so the down
    launch copies its tiles 16 bytes at a time whatever F
    (``csrc/common.cuh::ffn_h_stride``); fp32's stay F."""
    from repro_torch.kernels import moe_gemm
    assert moe_gemm.h_scratch_spec(3, 5, f, torch.bfloat16) == (
        (3, 5, bf16_rows), torch.bfloat16)
    assert moe_gemm.h_scratch_spec(3, 5, f, torch.float32) == (
        (3, 5, f), torch.float32)


def test_quant_ffn_h_scratch_and_entries():
    """The quantized bf16 entry passes h (E, C, F) in bf16 between its two
    launches, as bf16 moe_ffn does; the fp32 entry passes an fp32 h the
    same way."""
    from repro_torch.kernels import build, moe_gemm
    assert moe_gemm.h_scratch_spec(128, 16, 768, torch.bfloat16) == (
        (128, 16, 768), torch.bfloat16)
    assert moe_gemm.h_scratch_spec(128, 16, 768, torch.float32) == (
        (128, 16, 768), torch.float32)
    pointers = lambda name: build.SIGNATURES[name].count(build._P)
    assert pointers("moe_ffn_quant_bf16") == pointers(
        "moe_ffn_quant_f32") == 10
