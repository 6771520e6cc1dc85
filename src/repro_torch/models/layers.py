"""Core NN layers of the ported slice (the JAX package's ``models/layers.py``).

Plain functions over tensors.  Compute follows the reference's
bf16-weights / fp32-accumulate policy; norms and rotary angles always run
in fp32.  Initializers draw from an explicit ``torch.Generator`` on the
generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import quant


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               lead: tuple = (), keep: slice | None = None) -> torch.Tensor:
    """(*lead, d_in, d_out) weights ~ N(0, 1/d_in), drawn in fp32 one
    (d_in, d_out) matrix at a time, so the fp32 transient stays one matrix
    even for a full-width expert stack.  ``keep``: store only these indices
    of the last lead axis (a rank's expert rows); every matrix is still
    drawn, so the kept ones equal the whole stack's."""
    kept = range(lead[-1])[keep] if keep is not None else None
    shape = lead if kept is None else lead[:-1] + (len(kept),)
    out = torch.empty(shape + (d_in, d_out), dtype=dtype, device=gen.device)
    mats = out.view(-1, d_in, d_out)
    scale = 1.0 / math.sqrt(d_in)
    for i in range(math.prod(lead)):
        mat = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                          dtype=torch.float32).mul_(scale)
        if kept is None:
            mats[i].copy_(mat)
        elif i % lead[-1] in kept:
            mats[i // lead[-1] * len(kept)
                 + kept.index(i % lead[-1])].copy_(mat)
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(dt)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Statistics in fp32; the variance is the biased one (``jnp.var``)."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * params["scale"].float() + params["bias"].float()).to(dt)


def norm_apply(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    """``params`` is the rmsnorm weight, or layernorm's {"scale", "bias"}."""
    if kind == "layernorm":
        return layer_norm(params, x)
    return rms_norm(params, x)


def norm_init(kind: str, d: int, dtype, device, lead: tuple = ()):
    """Unit norm parameters of width ``d`` (stacked over ``lead``): the
    rmsnorm weight, or layernorm's {"scale": ones, "bias": zeros}."""
    ones = torch.ones(lead + (d,), dtype=dtype, device=device)
    if kind == "layernorm":
        return {"scale": ones, "bias": torch.zeros_like(ones)}
    return ones


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S) int."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * inv              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int, dtype,
             lead: tuple = ()) -> dict:
    """The dense block's MLP weights, optionally stacked along ``lead``."""
    return {"w_gate": dense_init(gen, d, f, dtype, lead),
            "w_up": dense_init(gen, d, f, dtype, lead),
            "w_down": dense_init(gen, f, d, dtype, lead)}


def mlp_apply(params: dict, x: torch.Tensor,
              act: str = "silu") -> torch.Tensor:
    """act(x W_gate) * (x W_up) W_down through ``quant.qdot``, in x's dtype
    (the reference's ``qdot`` here asks for no fp32 output, so a bf16 run
    rounds g, u and the result to bf16 as it does).  ``gelu`` is the tanh
    form, as ``jax.nn.gelu`` defaults to."""
    g = quant.qdot(x, params["w_gate"])
    u = quant.qdot(x, params["w_up"])
    g = (F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g))
    return quant.qdot(g * u, params["w_down"])


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          valid_vocab: int) -> torch.Tensor:
    """CE over possibly vocab-padded logits (..., V_pad): the padded
    columns are masked at -1e9.  labels: (...) int.  Returns (...) fp32."""
    lf = logits.float()
    vpad = lf.shape[-1]
    if vpad != valid_vocab:
        valid = torch.arange(vpad, device=lf.device) < valid_vocab
        lf = torch.where(valid, lf, -1e9)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return logz - gold
