"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060), the JAX package's
``models/mamba2.py``.

A full sequence runs the chunked SSD (the quadratic dual form inside each
chunk and a sequential recurrence over the chunks' states); decode is the
O(1) state update.  The paper's expert parallelism does not apply to this
attention-free family.

x is split into H heads of P = headdim channels; the state is (H, P, N)
with N = d_state; B and C are shared across heads (n_groups = 1).  The
functions are pure, as in the reference: the stacks write the states they
return into the cache (``models/transformer.py``).  As in the reference the
forward's conv runs in the activation dtype and the decode's in fp32, and
the conv state is the pre-conv tail (``xbc_raw_tail``).  ``in_proj`` and
``out_proj`` stay in fp under weight quantization (``core/quant`` names
neither).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.rglru import softplus


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_headdim


def conv_dim(cfg) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state


def mamba_init(gen: torch.Generator, cfg, dtype, lead: tuple = (),
               keep: dict | None = None) -> dict:
    """One SSD block's weights, stacked along ``lead`` (layers);
    ``in_proj`` emits [z (di), xBC (dc), dt (h)].  ``keep``: the block of
    ``in_proj`` / ``out_proj`` to store (``layers.dense_init``; the train
    layout cuts them over "data", the serve layout keeps the block
    whole)."""
    keep = keep or {}
    d = cfg.d_model
    di, h, n = d_inner(cfg), n_heads(cfg), cfg.ssm_state
    dc, k = conv_dim(cfg), cfg.ssm_dconv
    dev = gen.device
    full = lambda v, dt: torch.full(lead + (h,), v, dtype=dt, device=dev)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev)).expand(lead + (h,))
    return {
        "in_proj": layers.dense_init(gen, d, 2 * di + 2 * n + h, dtype, lead,
                                     keep.get("in_proj")),
        "conv_w": (torch.randn(lead + (k, dc), generator=gen, device=dev,
                               dtype=torch.float32) / math.sqrt(k)).to(dtype),
        "conv_b": torch.zeros(lead + (dc,), dtype=dtype, device=dev),
        "A_log": a_log.contiguous(),
        "D": full(1.0, torch.float32),
        "dt_bias": full(0.0, torch.float32),
        "norm": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "out_proj": layers.dense_init(gen, di, d, dtype, lead,
                                      keep.get("out_proj")),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    di, n = d_inner(cfg), cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d of xbc (B, S, C) with taps w (K, C), summed
    in the reference's order, then SiLU."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 h0: torch.Tensor | None):
    """Chunked SSD scan.  x (b, s, h, p); dt (b, s, h) (softplus'ed);
    A (h,) negative; B, C (b, s, n).  Returns y (b, s, h, p) fp32 and the
    final state (b, h, p, n) fp32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk != 0:
        raise ValueError(f"sequence {s} is not a whole number of "
                         f"{chunk}-token chunks")
    c = s // chunk
    xc = x.reshape(b, c, chunk, h, p).float()
    dtc = dt.reshape(b, c, chunk, h)
    Bc = B.reshape(b, c, chunk, n).float()
    Cc = C.reshape(b, c, chunk, n).float()

    dA_cs = torch.cumsum(dtc * A, dim=2)                    # (b,c,q,h) <= 0
    # intra-chunk dual form: L[i, j] = exp(dA_cs[i] - dA_cs[j]) for j <= i,
    # masked BEFORE exp: the other triangle overflows, and its backward
    # would be inf * 0 = NaN
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (b,c,i,j,h)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    seg = torch.where(causal, seg, 0.0)
    L = torch.where(causal, torch.exp(seg), 0.0)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    att = CB[..., None] * L                                 # (b,c,i,j,h)
    xdt = xc * dtc[..., None]                               # (b,c,q,h,p)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xdt)

    # chunk-local end states: sum_j exp(dA_cs[-1] - dA_cs[j]) dt_j B_j x_j
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,c,q,h)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_to_end * dtc, Bc,
                          xc)                               # (b,c,h,p,n)

    # the recurrence over chunks: each chunk reads the state entering it
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])             # (b,c,h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    entry = []
    for i in range(c):
        entry.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    entry_states = torch.stack(entry, dim=1)                # (b,c,h,p,n)

    state_decay = torch.exp(dA_cs)                          # (b,c,q,h)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, entry_states,
                           state_decay)
    return (y_intra + y_inter).reshape(b, s, h, p), carry


def mamba_forward(p: dict, cfg, x: torch.Tensor, state: dict | None = None,
                  chunk: int = 256):
    """The SSD block over a full sequence, x (B, S, D) -> (B, S, D).  With
    ``state`` the final (conv, ssm) states are returned too (the incoming
    state is not read, as in the reference).  A sequence that is not a
    whole number of ``chunk``-token chunks runs as one chunk."""
    b, s, _ = x.shape
    h, pdim, n = n_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    di = d_inner(cfg)
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di].reshape(b, s, h, pdim)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    ck = min(chunk, s) if s % min(chunk, s) == 0 else s
    y, final = _ssd_chunked(xs, dt, A, B, C, ck, None)
    y = y + xs.float() * p["D"][:, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = layers.rms_norm(p["norm"], y * F.silu(z))
    out = y @ p["out_proj"]
    if state is not None:
        conv_state = xbc_raw_tail(zxbcdt, cfg, cfg.ssm_dconv).to(x.dtype)
        return out, {"conv": conv_state, "ssm": final}
    return out


def xbc_raw_tail(zxbcdt: torch.Tensor, cfg, k: int) -> torch.Tensor:
    """The last k-1 pre-conv xBC activations, zero-padded on the left when
    S < k-1."""
    di, n = d_inner(cfg), cfg.ssm_state
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    s = xbc.shape[1]
    if s >= k - 1:
        return xbc[:, s - (k - 1):]
    return F.pad(xbc, (0, 0, k - 1 - s, 0))


def mamba_cache_spec(cfg, batch: int, dtype) -> dict:
    h, pdim, n = n_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    return {"conv": ((batch, cfg.ssm_dconv - 1, conv_dim(cfg)), dtype),
            "ssm": ((batch, h, pdim, n), torch.float32)}


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    return {kk: torch.zeros(shape, dtype=dt, device=device)
            for kk, (shape, dt) in mamba_cache_spec(cfg, batch,
                                                    dtype).items()}


def mamba_decode_step(p: dict, cfg, cache: dict, x: torch.Tensor):
    """x (B, 1, D) -> ((B, 1, D), the next state {"conv", "ssm"}): the
    O(1) recurrent update, its conv in fp32."""
    b = x.shape[0]
    h, pdim, n = n_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    di = d_inner(cfg)
    zxbcdt = x @ p["in_proj"]
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)
    win = torch.cat([cache["conv"].to(xbc_new.dtype), xbc_new], dim=1)
    conv_out = (torch.einsum("bkc,kc->bc", win.float(), p["conv_w"].float())
                + p["conv_b"].float())
    xbc = F.silu(conv_out)[:, None, :]                      # (B, 1, C)
    new_conv = win[:, 1:].to(cache["conv"].dtype)
    xs = xbc[..., :di].reshape(b, h, pdim)
    B = xbc[:, 0, di:di + n]
    C = xbc[:, 0, di + n:]
    dtv = softplus(dt[:, 0].float() + p["dt_bias"])         # (B, h)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtv * A)
    ssm = cache["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtv, B, xs)
    y = torch.einsum("bn,bhpn->bhp", C, ssm)
    y = y + xs * p["D"][:, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = layers.rms_norm(p["norm"], y * F.silu(z))
    return y @ p["out_proj"], {"conv": new_conv, "ssm": ssm}
