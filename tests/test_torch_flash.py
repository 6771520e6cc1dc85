"""The port's full-sequence flash attention on the CPU (its plain version,
``flash_attention_plain``) against the JAX package's Pallas
``flash_attention`` in interpret mode and its oracle
``kernels/ref.py::flash_attention_ref``, on the same numpy inputs.

The port takes q (B, S, Hq, hd) and unrepeated k/v (B, S, Hkv, hd); the
reference takes (B, H, S, hd) with K/V repeated to Hq heads, which the
tests do on the JAX side.  The Pallas kernel runs with 32-wide blocks so
that S=40 and S=96 span several key tiles.  The CUDA kernel is held to the
plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro_torch.kernels import flash_attn, ops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
B, HQ, HKV, HD = 2, 4, 2, 64


def _case(seed: int, s: int, dtype: str):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, HQ, HD)).astype(np.float32)
    k = rng.standard_normal((B, s, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, s, HKV, HD)).astype(np.float32)
    if dtype == "bfloat16":        # round once, hand both sides the same bits
        q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (q, k, v))
    return q, k, v


def _jax_inputs(q, k, v, dtype):
    """(B, S, H, hd) -> (B, H, S, hd), K/V repeated to every query head
    (head h reads kv head h // (Hq / Hkv), as ``gqa_repeat`` does)."""
    rep = q.shape[2] // k.shape[2]
    to = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3), getattr(jnp, dtype))
    return to(q), to(np.repeat(k, rep, axis=2)), to(np.repeat(v, rep, axis=2))


def _port(q, k, v, dtype, **kw):
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    out = ops.flash_attention(t(q), t(k), t(v), **kw)
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


def _from_jax(y):
    return np.asarray(y, np.float32).transpose(0, 2, 1, 3)


def _pallas(q, k, v, dtype, **kw):
    return _from_jax(jax_ops.flash_attention(*_jax_inputs(q, k, v, dtype),
                                             block_q=32, block_k=32, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8, 32])
@pytest.mark.parametrize("s", [16, 40, 64, 96])
def test_causal_matches_pallas_kernel(s, window, dtype):
    """Causal, with and without a window, ragged S (40) included: the
    padded keys of the Pallas kernel lie above every query's diagonal."""
    q, k, v = _case(s, s, dtype)
    got = _port(q, k, v, dtype, causal=True, window=window)
    want = _pallas(q, k, v, dtype, causal=True, window=window)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_matches_pallas_kernel(dtype):
    """Non-causal at S=64, a whole number of blocks: no padding exists."""
    q, k, v = _case(7, 64, dtype)
    got = _port(q, k, v, dtype, causal=False)
    want = _pallas(q, k, v, dtype, causal=False)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_ragged_matches_oracle_not_kernel(dtype):
    """Non-causal at S=40 with 32-wide blocks: the Pallas kernel pads S to
    64 with zero keys and, with no causal mask, attends to them (a defect
    of the reference that no JAX path reaches: ``attn_forward`` always
    passes causal=True).  The port masks keys at or beyond S, so it is
    held to ``flash_attention_ref`` here, and the kernel is shown to fail
    the same check."""
    q, k, v = _case(11, 40, dtype)
    got = _port(q, k, v, dtype, causal=False)
    oracle = _from_jax(ref.flash_attention_ref(*_jax_inputs(q, k, v, dtype),
                                               causal=False))
    np.testing.assert_allclose(got, oracle, rtol=TOL[dtype], atol=TOL[dtype])
    kernel = _pallas(q, k, v, dtype, causal=False)
    assert not np.allclose(kernel, oracle, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 32])
def test_hd256_ten_query_heads_match_pallas_kernel(window, dtype):
    """recurrentgemma-2b's local attention: hd 256, ten query heads on one
    kv head, at S=80 (ragged against the 32-wide blocks), causal with and
    without a window."""
    rng = np.random.default_rng(256 + (window or 0))
    q = rng.standard_normal((1, 80, 10, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, 80, 1, 256)).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (q, k, v))
    got = _port(q, k, v, dtype, causal=True, window=window)
    want = _pallas(q, k, v, dtype, causal=True, window=window)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,hd", [(7, 1, 128), (4, 4, 64)],
                         ids=["G7-hd128", "G1-hd64"])
def test_modality_head_groups_match_pallas_kernel(hq, hkv, hd, dtype):
    """qwen2-vl-7b's query groups (G = 7 at hd 128: a 32-row block of
    grouped rows ends inside a position's group) and musicgen-large's MHA
    (G = 1 at hd 64), causal at S=80 (ragged against the 32-wide
    blocks)."""
    rng = np.random.default_rng(hq * hd)
    q = rng.standard_normal((1, 80, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((1, 80, hkv, hd)).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (q, k, v))
    got = _port(q, k, v, dtype, causal=True)
    want = _pallas(q, k, v, dtype, causal=True)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_gqa_reads_kv_head_of_its_group():
    """Query head h reads kv head h // (Hq / Hkv): swapping the two kv
    heads changes exactly the outputs of the query heads that read them."""
    q, k, v = _case(3, 24, "float32")
    base = _port(q, k, v, "float32")
    swapped = _port(q, k[:, :, ::-1].copy(), v[:, :, ::-1].copy(), "float32")
    g = HQ // HKV
    np.testing.assert_allclose(swapped[:, :, :g], _port(
        q[:, :, :g], k[:, :, 1:], v[:, :, 1:], "float32"), rtol=1e-6,
        atol=1e-6)
    assert np.abs(swapped - base).max() > 0.1


def test_cpu_dispatch_launches_no_kernel():
    """A CPU tensor takes the plain version; the CUDA wrapper refuses it."""
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _case(5, 8, "float32"))
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="must be on"):
        flash_attn.flash_attention(q, k, v)


def _replay_tiled(q, k, v, *, causal, window, tile=64):
    """The bf16 CUDA kernel's order of operations in torch: key tiles of
    ``tile`` keys from key 0; per tile, fp32 logits times hd**-0.5, masked
    at -1e30, a running max, p = exp(logit - running max) with masked p 0,
    l summing the unrounded p, and P rounded to bf16 before the fp32 P.V
    product; out = acc / max(l, 1e-30) in bf16.  (Tiles the kernel skips
    leave m, l and acc unchanged, so visiting every tile is the same.)"""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, hd)
    qp = torch.arange(s)[:, None]
    m = torch.full((b, hkv, hq // hkv, s), flash_attn.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, hq // hkv, s, hd)
    for key0 in range(0, s, tile):
        kt, vt = k[:, key0:key0 + tile].float(), v[:, key0:key0 + tile]
        kp = torch.arange(key0, key0 + kt.shape[1])[None, :]
        ok = torch.ones(s, kt.shape[1], dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window is not None:
            ok &= kp > qp - window
        logit = torch.einsum("bqhgd,bkhd->bhgqk", qg, kt) * hd ** -0.5
        logit = torch.where(ok, logit, flash_attn.NEG_INF)
        m_new = torch.maximum(m, logit.amax(-1))
        p = torch.where(ok, torch.exp(logit - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.bfloat16().float(), vt.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd).bfloat16()


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("hd", [64, 128, 160, 256])
def test_kernel_tiling_fits_bf16_tolerance(hd, window):
    """The bf16 kernel rounds p against each 64-key tile's running max, not
    the final one; replayed in torch at S=300 (ragged against the tiles),
    that order stays within chip_smoke's bf16 tolerance of the plain
    version, so the card's check can hold the kernel to it."""
    rng = np.random.default_rng(hd + (window or 0))
    mk = lambda *sh: torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32)).bfloat16()
    q, k, v = mk(1, 300, 8, hd), mk(1, 300, 2, hd), mk(1, 300, 2, hd)
    got = _replay_tiled(q, k, v, causal=True, window=window)
    want = flash_attn.flash_attention_plain(q, k, v, causal=True,
                                            window=window)
    err = (got.float() - want.float()).abs()
    assert float(err.max()) > 0       # the tiled order does round apart
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


# the main path's views: k and v are halves of one (B, S, 2 Hkv, hd) tensor
_KV_STRIDES = (2048 * 8 * 128, 8 * 128, 128, 1)


@pytest.mark.parametrize("dtype,ptr,strides,ok", [
    (torch.bfloat16, 0x7f0000000000, _KV_STRIDES, True),
    (torch.bfloat16, 0x7f0000000000 + 4 * 128 * 2, _KV_STRIDES, True),
    (torch.bfloat16, 0x7f0000000000 + 2, _KV_STRIDES, False),
    (torch.bfloat16, 0x7f0000000000, (2048 * 900, 900, 128, 1), False),
    (torch.bfloat16, 0x7f0000000000, (2048 * 1028, 1028, 68, 1), False),
    (torch.bfloat16, 0x7f0000000000, (2048 * 1032, 1032, 128, 1), True),
    (torch.float32, 0x7f0000000000 + 4, (2048 * 900, 900, 68, 1), True),
])
def test_copy_alignment_check(dtype, ptr, strides, ok):
    """The bf16 kernel reads k/v through TMA: base addresses and
    batch/sequence/head strides must be 16-byte aligned (a misaligned view
    raises; nothing falls back).  fp32 reads element by element."""
    if ok:
        flash_attn.check_copy_alignment("k", dtype, ptr, strides)
    else:
        with pytest.raises(ValueError, match="16-byte-aligned"):
            flash_attn.check_copy_alignment("k", dtype, ptr, strides)


def test_entries_by_dtype():
    assert flash_attn.flash_entry(torch.float32) == "flash_attention_f32"
    assert flash_attn.flash_entry(torch.bfloat16) == "flash_attention_bf16"
    with pytest.raises(ValueError, match="no kernel"):
        flash_attn.flash_entry(torch.float16)
