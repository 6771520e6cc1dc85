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

On a serving mesh (``ChannelTP``, read from the serve-mode specs of
``launch/sharding.py``) a rank runs its block of the W channels: ``in_x``
and ``in_y`` give its W/n channels, the causal conv, ``Lambda`` and the
gate biases are sliced to them; ``gate_a`` and ``gate_x`` are (W, W)
products cut on their output, so the conv output is all-gathered over
"model" before them; the scan runs on the local channels; ``out`` is cut
by rows, giving a partial (B, S, D) that a psum adds up.  The decode
carries the local channels' ``h`` and conv state.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.launch import sharding
from repro_torch.models import layers

TP_AXIS = "model"

_C = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) exactly, as ``jax.nn.softplus`` (``F.softplus`` turns
    into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_init(gen: torch.Generator, cfg, dtype, lead: tuple = (),
               keep: dict | None = None) -> dict:
    """One recurrent block's weights, stacked along ``lead`` (layers).
    Lambda is drawn so that a = sigmoid(Lambda)^c lies in (0.9, 0.999).
    ``keep``: each projection's block to store (``layers.dense_init``;
    the conv, biases and Lambda are replicated in every mode)."""
    d, w, k = cfg.d_model, cfg.lru_width, cfg.conv1d_width
    dev = gen.device
    keep = keep or {}
    dense = lambda name, din, dout: layers.dense_init(gen, din, dout, dtype,
                                                      lead, keep.get(name))
    u = torch.rand(lead + (w,), generator=gen, device=dev,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    conv_w = (torch.randn(lead + (k, w), generator=gen, device=dev,
                          dtype=torch.float32) / math.sqrt(k)).to(dtype)
    zeros = lambda dt: torch.zeros(lead + (w,), dtype=dt, device=dev)
    return {
        "in_x": dense("in_x", d, w),
        "in_y": dense("in_y", d, w),
        "conv_w": conv_w,
        "conv_b": zeros(dtype),
        "gate_a": dense("gate_a", w, w),
        "bias_a": zeros(torch.float32),
        "gate_x": dense("gate_x", w, w),
        "bias_x": zeros(torch.float32),
        "Lambda": lam,
        "out": dense("out", w, d),
    }


@dataclasses.dataclass(frozen=True)
class ChannelTP:
    """This rank's block of the W channels on a serving mesh: channels
    ``[c0, c0 + w)``.  The reference's serve rules cut ``in_x`` / ``in_y``
    and ``gate_a`` / ``gate_x`` on their output and ``out`` on its rows
    together: all of them where W divides the "model" axis."""
    mesh: object
    c0: int
    w: int


def channel_tp(cfg, mesh, spec: dict) -> ChannelTP | None:
    """The ``ChannelTP`` of this rank from a recurrent block's specs, or
    None where its channels are whole."""
    if not sharding.split(spec["in_x"], -1):
        return None
    w = cfg.lru_width // mesh.shape[TP_AXIS]
    return ChannelTP(mesh, mesh.coords[TP_AXIS] * w, w)


def _local(t: torch.Tensor, tp: ChannelTP | None) -> torch.Tensor:
    """This rank's channels of a replicated per-channel leaf (..., W)."""
    return t if tp is None else t[..., tp.c0:tp.c0 + tp.w]


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


def _rglru_gates(p: dict, x: torch.Tensor, tp: ChannelTP | None = None):
    """(a, gated x), both (B, S, W) fp32 (on a mesh, this rank's channels
    of both: the gates' products read every channel of x, gathered)."""
    xw = x if tp is None else collectives.all_gather(x, tp.mesh, TP_AXIS,
                                                     dim=-1)
    r = torch.sigmoid((xw @ p["gate_a"]).float() + _local(p["bias_a"], tp))
    i = torch.sigmoid((xw @ p["gate_x"]).float() + _local(p["bias_x"], tp))
    log_a = -_C * r * softplus(_local(p["Lambda"], tp))
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * x.float())
    return a, gated_x


def _out(p: dict, y: torch.Tensor, tp: ChannelTP | None) -> torch.Tensor:
    """``out`` over the gated scan output: on a mesh, a partial product of
    this rank's rows, summed over "model"."""
    out = y @ p["out"]
    return out if tp is None else collectives.psum(out, tp.mesh, TP_AXIS)


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


def rglru_forward(p: dict, cfg, x: torch.Tensor, state: dict | None = None,
                  tp: ChannelTP | None = None):
    """The recurrent block over a full sequence, x (B, S, D) -> (B, S, D);
    with ``state`` ({"conv", "h"}) it starts from it and also returns the
    final one.  On a serving mesh (``tp``) the weights are this rank's
    serve blocks, the state its channels'."""
    y_branch = F.gelu(x @ p["in_y"], approximate="tanh")
    xb = x @ p["in_x"]
    conv_state = state.get("conv") if state else None
    xb, new_conv = _causal_conv(xb, _local(p["conv_w"], tp),
                                _local(p["conv_b"], tp), conv_state)
    a, bx = _rglru_gates(p, xb, tp)
    h0 = state.get("h") if state else None
    h = _linear_scan(a, bx, h0)
    out = _out(p, h.to(x.dtype) * y_branch, tp)
    if state is not None:
        return out, {"conv": new_conv.to(x.dtype), "h": h[:, -1]}
    return out


def rglru_cache_spec(cfg, batch: int, dtype,
                     channels: int | None = None) -> dict:
    """{"conv", "h"} -> (shape, dtype) of ``channels`` channels (all W by
    default)."""
    w = channels or cfg.lru_width
    return {"conv": ((batch, cfg.conv1d_width - 1, w), dtype),
            "h": ((batch, w), torch.float32)}


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    return {kk: torch.zeros(shape, dtype=dt, device=device)
            for kk, (shape, dt) in rglru_cache_spec(cfg, batch,
                                                    dtype).items()}


def rglru_decode_step(p: dict, cfg, cache: dict, x: torch.Tensor,
                      tp: ChannelTP | None = None):
    """x (B, 1, D) -> ((B, 1, D), the next state {"conv", "h"}); on a
    serving mesh (``tp``) of this rank's channels."""
    y_branch = F.gelu(x @ p["in_y"], approximate="tanh")
    xb = x @ p["in_x"]
    xb, new_conv = _causal_conv(xb, _local(p["conv_w"], tp),
                                _local(p["conv_b"], tp), cache["conv"])
    a, bx = _rglru_gates(p, xb, tp)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    out = _out(p, h[:, None].to(x.dtype) * y_branch, tp)
    return out, {"conv": new_conv.to(x.dtype), "h": h}
