"""Core NN layers of the ported slice (the JAX package's ``models/layers.py``).

Plain functions over tensors.  Compute follows the reference's
bf16-weights / fp32-accumulate policy; norms and rotary angles (RoPE and
Qwen2-VL's M-RoPE) always run in fp32.  Initializers draw from an
explicit ``torch.Generator`` on the generator's device.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.core import collectives, quant


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               lead: tuple = (), keep=None):
    """(*lead, d_in, d_out) weights ~ N(0, 1/d_in), drawn in fp32 one
    (d_in, d_out) matrix at a time, so the fp32 transient stays one matrix
    even for a full-width expert stack.  ``keep``: store only a block of
    the whole, one slice per dimension of (*lead, d_in, d_out) (a slice
    alone: of the last lead axis, a rank's expert rows); every matrix is
    still drawn, so the kept block equals the same block of the whole.
    ``keep`` may instead be a ``quant.Sink`` (its own ``keep`` the block):
    each kept matrix then goes through the sink, rounded to ``dtype`` and
    quantized as it is drawn, and the result is a QuantTensor equal to
    ``quant.quantize`` of the stored weight, with no ``dtype`` copy of
    the leaf ever made."""
    sink = keep if isinstance(keep, quant.Sink) else None
    if sink is not None:
        keep = sink.keep
    full = lead + (d_in, d_out)
    if isinstance(keep, slice):
        keep = (slice(None),) * (len(lead) - 1) + (keep, slice(None),
                                                   slice(None))
    keep = keep if keep is not None else (slice(None),) * len(full)
    kept = [range(n)[k] for n, k in zip(full, keep)]
    shape = tuple(len(r) for r in kept)
    if sink is None:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        mats = out.view((-1,) + shape[-2:])
    else:
        out = sink.empty(shape[:-2], d_in, d_out, dtype, gen.device)
        mats = out.matrices()
    scale = 1.0 / math.sqrt(d_in)
    for idx in itertools.product(*map(range, lead)):
        mat = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                          dtype=torch.float32)
        if all(j in r for j, r in zip(idx, kept)):
            pos = 0
            for j, r in zip(idx, kept):
                pos = pos * len(r) + r.index(j)
            if sink is None:
                mats[pos].copy_(mat[keep[-2], keep[-1]].mul_(scale))
            else:
                sink.put(mats[pos], mat.mul_(scale))
        del mat             # freed before the next draw: one fp32 matrix
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               keep: tuple | None = None) -> torch.Tensor:
    """(vocab, d) ~ N(0, 0.02^2); ``keep``: store only that block."""
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    if keep is not None:
        w = w[keep].clone()
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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (B, S, H, hd); positions3: (B, S,
    3) int (temporal, height, width).  ``sections`` counts the frequency
    pairs of each component and must sum to hd // 2 ((16, 24, 24) at hd
    128): the first pairs rotate by the temporal position, the next by
    the height, the last by the width.  The angle of every component is
    taken in fp32, and the rotation is ``apply_rope``'s half split."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    # output_size: the counts' sum is known on the host, so the device
    # never hands it back (a sync on the card, an error on a meta tensor)
    sel = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device),
        output_size=hd // 2)                                # (hd/2,)
    ang_all = positions3[..., None, :].float() * inv[:, None]  # (B,S,hd/2,3)
    ang = torch.gather(ang_all, -1, sel[:, None].expand(
        ang_all.shape[:-1] + (1,)))[..., 0]               # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, f: int, dtype,
             lead: tuple = (), keep: dict | None = None) -> dict:
    """The dense block's MLP weights, optionally stacked along ``lead``;
    ``keep``: each weight's block to store (``dense_init``)."""
    keep = keep or {}
    return {"w_gate": dense_init(gen, d, f, dtype, lead, keep.get("w_gate")),
            "w_up": dense_init(gen, d, f, dtype, lead, keep.get("w_up")),
            "w_down": dense_init(gen, f, d, dtype, lead, keep.get("w_down"))}


def mlp_apply(params: dict, x: torch.Tensor, act: str = "silu",
              tp=None) -> torch.Tensor:
    """act(x W_gate) * (x W_up) W_down through ``quant.qdot``, in x's dtype
    (the reference's ``qdot`` here asks for no fp32 output, so a bf16 run
    rounds g, u and the result to bf16 as it does).  ``gelu`` is the tanh
    form, as ``jax.nn.gelu`` defaults to.

    On a serving mesh ``tp`` is (mesh, F split in W_gate / W_up, F split
    in W_down), read from the serve-mode specs: with W_down's rows split
    each rank multiplies its columns of F and a psum over "model" adds the
    partial outputs; with them whole the columns are gathered first and
    the product runs whole."""
    g = quant.qdot(x, params["w_gate"])
    u = quant.qdot(x, params["w_up"])
    g = (F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g))
    h = g * u
    if tp is None:
        return quant.qdot(h, params["w_down"])
    mesh, cols, rows = tp
    if cols and not rows:
        h = collectives.all_gather(h, mesh, "model", dim=-1)
    y = quant.qdot(h, params["w_down"])
    return collectives.psum(y, mesh, "model") if rows else y


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
