"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427), the JAX
package's ``models/rglru.py``.

The hybrid architecture interleaves two recurrent (RG-LRU) blocks with one
local-attention block (pattern rec, rec, attn).  The recurrence is a
per-channel (diagonal) gated linear recurrence:

    r_t = sigmoid(x_t W_a + b_a)              (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)              (input gate)
    log a_t = -c * r_t * softplus(Lambda)     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A full sequence runs ``_linear_scan``; decode is the O(1) step.  The
reference scans with ``jax.lax.associative_scan``, which torch lacks: the
port runs a log-depth doubling (Hillis-Steele) scan over the sequence with
the same combine, ceil(log2 S) rounds of whole-tensor ops, so the products
are taken in another order than XLA's and agree to fp32 rounding.  A
cumulative sum in log space would overflow through exp(-log a), and a
Python loop over S would launch S tiny steps per layer on the card.

The functions are pure, as in the reference: the stacks write the states
they return into the cache (``models/transformer.py``).  Every recurrent
weight stays in fp (``core/quant.classify_weight`` names none of them).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers

_C = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) exactly, as ``jax.nn.softplus`` (``F.softplus`` turns
    into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_init(gen: torch.Generator, cfg, dtype, lead: tuple = ()) -> dict:
    """One recurrent block's weights, stacked along ``lead`` (layers).
    Lambda is drawn so that a = sigmoid(Lambda)^c lies in (0.9, 0.999)."""
    d, w, k = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    dev = gen.device
    u = torch.rand(lead + (w,), generator=gen, device=dev,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    conv_w = (torch.randn(lead + (k, w), generator=gen, device=dev,
                          dtype=torch.float32) / math.sqrt(k)).to(dtype)
    zeros = lambda dt: torch.zeros(lead + (w,), dtype=dt, device=dev)
    return {
        "in_x": layers.dense_init(gen, d, w, dtype, lead),
        "in_y": layers.dense_init(gen, d, w, dtype, lead),
        "conv_w": conv_w,
        "conv_b": zeros(dtype),
        "gate_a": layers.dense_init(gen, w, w, dtype, lead),
        "bias_a": zeros(torch.float32),
        "gate_x": layers.dense_init(gen, w, w, dtype, lead),
        "bias_x": zeros(torch.float32),
        "Lambda": lam,
        "out": layers.dense_init(gen, w, d, dtype, lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None):
    """Depthwise causal conv over x (B, S, W) with taps w (K, W); with a
    ``state`` (B, K-1, W) it is prepended instead of zeros.  Returns (the
    conv output, the last K-1 rows of the padded input: the next state).
    The taps are summed in the reference's order."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b, pad[:, pad.shape[1] - (k - 1):]


def _rglru_gates(p: dict, x: torch.Tensor):
    """(a, gated x), both (B, S, W) fp32."""
    r = torch.sigmoid((x @ p["gate_a"]).float() + p["bias_a"])
    i = torch.sigmoid((x @ p["gate_x"]).float() + p["bias_x"])
    log_a = -_C * r * softplus(p["Lambda"])
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * x.float())
    return a, gated_x


def _linear_scan(a: torch.Tensor, bx: torch.Tensor,
                 h0: torch.Tensor | None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t over axis 1 of (B, S, W) fp32, with h0
    folded into step 0 as the reference does.  Round r combines each step
    with the one 2^r before it (c1 then c2 -> (a2 a1, a2 b1 + b2), the
    reference's combine)."""
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    s, d = a.shape[1], 1
    while d < s:
        bx = torch.cat([bx[:, :d], a[:, d:] * bx[:, :-d] + bx[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return bx


def rglru_forward(p: dict, cfg, x: torch.Tensor, state: dict | None = None):
    """The recurrent block over a full sequence, x (B, S, D) -> (B, S, D);
    with ``state`` ({"conv", "h"}) it starts from it and also returns the
    final one."""
    y_branch = F.gelu(x @ p["in_y"], approximate="tanh")
    xb = x @ p["in_x"]
    conv_state = state.get("conv") if state else None
    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    a, bx = _rglru_gates(p, xb)
    h0 = state.get("h") if state else None
    h = _linear_scan(a, bx, h0)
    out = (h.to(x.dtype) * y_branch) @ p["out"]
    if state is not None:
        return out, {"conv": new_conv.to(x.dtype), "h": h[:, -1]}
    return out


def rglru_cache_spec(cfg, batch: int, dtype) -> dict:
    return {"conv": ((batch, cfg.conv1d_width - 1, cfg.lru_width), dtype),
            "h": ((batch, cfg.lru_width), torch.float32)}


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    return {kk: torch.zeros(shape, dtype=dt, device=device)
            for kk, (shape, dt) in rglru_cache_spec(cfg, batch,
                                                    dtype).items()}


def rglru_decode_step(p: dict, cfg, cache: dict, x: torch.Tensor):
    """x (B, 1, D) -> ((B, 1, D), the next state {"conv", "h"})."""
    y_branch = F.gelu(x @ p["in_y"], approximate="tanh")
    xb = x @ p["in_x"]
    xb, new_conv = _causal_conv(xb, p["conv_w"], p["conv_b"], cache["conv"])
    a, bx = _rglru_gates(p, xb)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    out = (h[:, None].to(x.dtype) * y_branch) @ p["out"]
    return out, {"conv": new_conv.to(x.dtype), "h": h}
