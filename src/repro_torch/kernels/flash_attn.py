"""Causal / sliding-window flash attention over a full sequence: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attn.py::flash_attention``
(``_kernel``).  The reference takes q/k/v as (B, H, S, hd) after the caller
repeats K/V to every query head (``gqa_repeat``); the port takes the
projection's layout, q (B, S, Hq, hd) and k/v (B, S, Hkv, hd), and query
head h reads kv head h // (Hq / Hkv), so neither a repeat nor a transpose
is materialised.  Keys at or beyond S are masked whatever ``causal`` is
(the Pallas kernel pads S to whole blocks with zero keys that only the
causal or window mask hides, so with ``causal=False`` and a ragged S it
attends to the padding; ``kernels/ref.py::flash_attention_ref`` does not).

The kernel (``csrc/flash_attn.cu``) is bound by operations on an H100
(0.07 ms of bf16 tensor-core work at B=2, S=2048, Hq=32, hd=128, causal).
Both types run one block per 64 grouped query rows of one kv head and skip
key tiles wholly above the diagonal or wholly below the window.  bf16 runs
both products on the tensor cores (wgmma, fp32 accumulation, Q and P kept
in registers; at hd 256 Q is staged in shared memory instead) with K/V
tiles streamed into shared-memory rings by TMA (hd 160 as three 64-dim
boxes whose last 32 dims TMA fills with zeros), so
q, k and v must have 16-byte-aligned base addresses and strides
(``check_copy_alignment``).  fp32 stays on the CUDA cores in fp32 FMA: the
port holds it to 2e-5, which TF32 cannot meet (see the source note).
``flash_attention`` launches the kernel on CUDA tensors and counts the
launch in its ``launches``;
``flash_attention_plain`` is the dense masked oracle
(``kernels/ref.py::flash_attention_ref``) in torch ops, used on the CPU and
as the yardstick on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# the reduced widths, qwen3's, stablelm's, recurrentgemma's
HEAD_DIMS = (64, 128, 160, 256)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd) in q's
    dtype.  Dense masked attention: fp32 logits times hd**-0.5, masked at
    -1e30, softmax in fp32, probabilities rounded to V's dtype before the
    fp32 P.V product.  Query head h reads kv head h // (Hq / Hkv).  No
    key lies at or beyond S: nothing is padded."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def flash_entry(dtype: torch.dtype) -> str:
    """The C entry of ``csrc/flash_attn.cu`` for ``dtype``."""
    if dtype not in _ENTRY:
        raise ValueError(f"flash_attention: no kernel for {dtype}; "
                         f"fp32 or bf16")
    return _ENTRY[dtype]


def check_geometry(hq: int, hkv: int, hd: int) -> None:
    """Raise unless the kernel has an instantiation for these heads: whole
    query groups and hd 64, 128, 160 or 256 (any other hd raises; nothing
    falls back to the plain version)."""
    if hkv == 0 or hq % hkv or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported geometry Hq={hq} "
                         f"Hkv={hkv} hd={hd} (hd in {HEAD_DIMS})")


def check_copy_alignment(name: str, dtype: torch.dtype, data_ptr: int,
                         strides: tuple[int, ...]) -> None:
    """Raise unless the kernel for ``dtype`` can read ``name``: the bf16
    kernel reads k and v through TMA tensor maps, which need 16-byte-aligned
    base addresses and (batch, sequence, head) strides, and holds q to the
    same.  The fp32 kernel reads element by element and takes any."""
    if dtype != torch.bfloat16:
        return
    elt = dtype.itemsize
    if data_ptr % 16 or any(st * elt % 16 for st in strides[:3]):
        raise ValueError(
            f"flash_attention: bf16 {name} needs a 16-byte-aligned address "
            f"and strides, got address {data_ptr:#x} strides {strides}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Launch ``csrc/flash_attn.cu`` on CUDA tensors (same contract as
    ``flash_attention_plain``).  q/k/v may be strided views as long as the
    head dim is contiguous; the output is contiguous.  Raises on anything
    the kernel does not take."""
    build.refuse_grad("flash_attention", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, S, Hq, hd), got "
                         f"{tuple(q.shape)}")
    b, s, hq, hd = q.shape
    hkv = k.shape[2] if k.dim() == 4 else 0
    for name, t, shape in (("q", q, (b, s, hq, hd)),
                           ("k", k, (b, s, hkv, hd)),
                           ("v", v, (b, s, hkv, hd))):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device}")
        if t.dtype != q.dtype or q.dtype not in _ENTRY:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype}; "
                             f"q, k and v must share fp32 or bf16")
        if tuple(t.shape) != shape or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be {shape} with "
                             f"a contiguous head dim, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
        check_copy_alignment(name, t.dtype, t.data_ptr(), t.stride())
    check_geometry(hq, hkv, hd)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    out = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = flash_entry(q.dtype)
    build.check(getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(st for t in (q, k, v) for st in t.stride()[:3]), b, s, hq, hkv, hd,
        int(causal), 0 if window is None else int(window), hd ** -0.5,
        stream), entry)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
