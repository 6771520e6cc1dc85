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
key tiles wholly above the diagonal or wholly below the window.  Any head
dim from 1 to 256 runs on the smallest of the instantiations 64, 128,
192 and 256 that covers it, its dims past hd zero (``check_geometry``).  bf16 runs both
products on the tensor cores (wgmma, fp32 accumulation, Q and P kept in
registers; at width 256 Q is staged in shared memory instead) with K/V
tiles streamed into shared-memory rings by TMA, 64-dim boxes whose dims
past hd TMA fills with zeros, so q, k and v must have 16-byte-aligned
base addresses and strides (``check_copy_alignment``); an hd that is not
a multiple of 8 is run on zero-padded copies at the next multiple of 8
(``staged_hd``, ``pad_head_dim``).  hd above 256 is refused: the bf16
kernel's P.V is one wgmma whose N is the width, at most 256.  fp32 stays
on the CUDA cores in fp32 FMA, reading element by element (any hd, no
copy): the port holds it to 2e-5, which TF32 cannot meet (see the source
note).
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
MAX_HEAD_DIM = 256    # the widest instantiation: wgmma's N is at most 256
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
    """Raise unless the kernel takes these heads: whole query groups and
    any hd from 1 to 256 (above 256 the bf16 kernel's P.V, one wgmma of N
    = its width, has no instantiation; nothing falls back to the plain
    version)."""
    if hkv == 0 or hq % hkv or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: unsupported geometry Hq={hq} Hkv={hkv} "
            f"hd={hd} (hd from 1 to {MAX_HEAD_DIM}: the bf16 kernel's P.V "
            f"is one wgmma of N <= 256)")


def staged_hd(dtype: torch.dtype, hd: int) -> int:
    """The head dim the kernel for ``dtype`` reads: bf16's TMA maps need
    rows of a multiple of 16 bytes, so an hd that is not a multiple of 8
    is read from zero-padded copies at the next multiple of 8; fp32 reads
    element by element and takes hd as it is."""
    return -(-hd // 8) * 8 if dtype == torch.bfloat16 else hd


def pad_head_dim(t: torch.Tensor, hd: int) -> torch.Tensor:
    """A contiguous copy of ``t`` (B, S, H, hd0) with its head dim
    zero-padded to ``hd``."""
    out = t.new_zeros(t.shape[:-1] + (hd,))
    out[..., :t.shape[-1]] = t
    return out


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
    head dim is contiguous; the output is contiguous.  bf16 at an hd that
    is not a multiple of 8 runs on zero-padded copies (``staged_hd``).
    Raises on anything the kernel does not take."""
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
    check_geometry(hq, hkv, hd)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    hk = staged_hd(q.dtype, hd)
    if hk != hd:
        q, k, v = (pad_head_dim(t, hk) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_copy_alignment(name, t.dtype, t.data_ptr(), t.stride())
    out = torch.empty((b, s, hq, hk), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :hd]
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = flash_entry(q.dtype)
    build.check(getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(st for t in (q, k, v) for st in t.stride()[:3]), b, s, hq, hkv, hk,
        int(causal), 0 if window is None else int(window), hd ** -0.5,
        stream), entry)
    flash_attention.launches += 1
    return out if hk == hd else out[..., :hd].contiguous()


flash_attention.launches = 0
