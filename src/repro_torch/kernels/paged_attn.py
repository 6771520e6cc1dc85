"""Paged flash attention over the block-table page pool: the CUDA kernel's
wrappers and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/paged_attn.py::paged_attention``
(``_kernel``, ``_page_index``) for fp pools (``paged_attention``) and for
int8 pools with fp32 scale pools (``paged_attention_int8``, the
``quantized=True`` branch).  The kernel (``csrc/paged_attn.cu``) is
memory-bound on an H100, and latency-bound at the serve's shapes: a block
per (row, kv head, 16 grouped q rows, split) walks one of ``num_splits``
contiguous ranges of the tile's live pages, 64 keys a step, staging each
K/V page once for every query head of its group; with more than one split
a second launch merges the blocks' partial softmax states.  bf16 runs both
products on the tensor cores (``mma.sync``), fp32 on the CUDA cores (see
the source note).  Any head dim from 1 to 256 runs (``check_geometry``):
the kernel stages Q, K and V with their dims past hd zero-filled, 16 bytes
a copy where the pool's rows allow and narrower where they do not; the
pools, which are the caches, are read in place and never copied.

Each wrapper launches the kernel on CUDA tensors and counts the call in
its own ``launches``; ``paged_attention_plain`` is the page walk of
``kernels/ref.py::paged_attention_ref`` in torch ops (fp and int8 pools),
used on the CPU and as the yardstick on the card.  ``num_splits`` and
``split_keys`` are the kernel's work split, written out for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
ROWS = 16             # grouped q rows of a block
KEYS = 64             # keys of a step
MAX_SPLITS = 64       # csrc/paged_attn.cu::kMaxSplits
BLOCKS_PER_SM = 3     # blocks of the bf16 kernel an SM holds at hd 128
_ENTRY = {torch.float32: "paged_attention_f32",
          torch.bfloat16: "paged_attention_bf16"}
_ENTRY_INT8 = {torch.float32: "paged_attention_int8_f32",
               torch.bfloat16: "paged_attention_int8_bf16"}


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, seg_lens: torch.Tensor, *,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None,
                          window: int | None = None) -> torch.Tensor:
    """q (B, T, Hq, hd) + pool (P, ps, Hkv, hd) + block_tables (B, NB)
    -> (B, T, Hq, hd).  Token t of row b attends the slots at absolute
    positions <= lengths[b] + t (and > that - window); tokens with
    t >= seg_lens[b] come out exactly zero.  Table entries are clamped into
    the pool.  An int8 pool comes with fp32 ``k_scale``/``v_scale``
    (P, ps, Hkv, 1) and is dequantized to q's dtype before the dot,
    ``(pool.float() * scale).to(q.dtype)``, as the reference does."""
    b, t, hq, hd = q.shape
    num_pages, ps, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    bt = block_tables.long().clamp(0, num_pages - 1)

    def walk(pool, scale):
        lin = pool[bt].reshape(b, nb * ps, hkv, hd)    # (B, S, Hkv, hd)
        if scale is not None:
            s = scale[bt].reshape(b, nb * ps, hkv, 1)
            lin = (lin.float() * s).to(q.dtype)
        return lin

    k, v = walk(k_pool, k_scale), walk(v_pool, v_scale)
    qg = q.reshape(b, t, hkv, g, hd)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          k.float()) * hd ** -0.5
    slot = torch.arange(nb * ps, device=q.device)[None, None, :]
    tpos = torch.arange(t, device=q.device)
    qp = torch.where(tpos[None, :] < seg_lens[:, None].long(),
                     lengths[:, None].long() + tpos, -1)[:, :, None]
    mask = slot <= qp
    if window is not None:
        mask = mask & (slot > qp - window)
    mask5 = mask[:, None, None, :, :]                 # (B,1,1,T,S)
    logits = torch.where(mask5, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask5, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqs,bshd->bhgqd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, hd).to(q.dtype)


def num_splits(b: int, tg: int, hkv: int, nb: int, ps: int,
               sms: int) -> int:
    """How many blocks share one row tile's page walk: enough to fill the
    card's SMs ``BLOCKS_PER_SM`` deep (B * Hkv * ceil(T*G / 16) blocks
    without a split), never more than the table's 64-key steps.  A function
    of shapes alone: the lengths live on the device, and reading them would
    synchronise the host."""
    base = b * hkv * -(-tg // ROWS)
    steps = -(-(nb * ps) // KEYS)
    return max(1, min(steps, MAX_SPLITS, BLOCKS_PER_SM * sms // base))


def split_keys(length: int, t_lo: int, t_hi: int, window: int | None,
               ps: int, nb: int, splits: int, s: int) -> tuple[int, int]:
    """The slots [js, je) that split ``s`` of a row tile walks: the
    tile's valid tokens t_lo..t_hi at positions length + t attend the slots
    s_lo..s_hi; their pages are cut into ``splits`` ranges of whole 64-key
    steps' worth of pages.  Empty when js >= je.  A copy of the device's
    plan (``csrc/paged_attn.cu::split_keys``) for the CPU tests: the two
    must stay in step (``chip_smoke.py``'s paged sweep holds the device's
    own plan to the plain version)."""
    if t_lo > t_hi:
        return 0, 0
    s_lo = max(length + t_lo - window + 1, 0) if window else 0
    s_hi = min(length + t_hi, nb * ps - 1)
    if s_lo > s_hi:
        return 0, 0
    p_lo, p_hi = s_lo // ps, s_hi // ps
    step = max(1, KEYS // ps)
    per = -(-(p_hi - p_lo + 1) // splits)
    per = -(-per // step) * step
    a = p_lo + s * per
    e = min(a + per, p_hi + 1)
    if a >= e:
        return 0, 0
    return max(a * ps, s_lo), min(e * ps, s_hi + 1)


def check_geometry(hq: int, hkv: int, hd: int, num_pages: int, nb: int,
                   who: str = "paged_attention") -> None:
    """Raise unless the kernel takes these heads, pool and tables: whole
    query groups, any hd from 1 to 256 (the widest instantiation), a
    page and a table column."""
    if hkv == 0 or hq % hkv or not 1 <= hd <= 256 or num_pages < 1 or nb < 1:
        raise ValueError(f"{who}: unsupported geometry Hq={hq} Hkv={hkv} "
                         f"hd={hd} (from 1 to 256) P={num_pages} NB={nb}")


def _launch(entries: dict, q, k_pool, v_pool, scales, block_tables,
            lengths, seg_lens, window, who: str) -> torch.Tensor:
    """Check the operands and launch one of ``csrc/paged_attn.cu``'s
    entries; ``scales`` is () for an fp pool, (k_scale, v_scale) for int8."""
    build.refuse_grad(who, q, k_pool, v_pool, *scales)
    b, t, hq, hd = q.shape
    num_pages, ps, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    pool_dtype = torch.int8 if scales else q.dtype
    checks = [("q", q, q.dtype, (b, t, hq, hd)),
              ("k_pool", k_pool, pool_dtype, (num_pages, ps, hkv, hd)),
              ("v_pool", v_pool, pool_dtype, (num_pages, ps, hkv, hd))]
    checks += [(name, s, torch.float32, (num_pages, ps, hkv, 1))
               for name, s in zip(("k_scale", "v_scale"), scales)]
    checks += [("block_tables", block_tables, torch.int32, (b, nb)),
               ("lengths", lengths, torch.int32, (b,)),
               ("seg_lens", seg_lens, torch.int32, (b,))]
    for name, x, dtype, shape in checks:
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{who}: {name} must be on {q.device}")
        if x.dtype != dtype:
            raise ValueError(f"{who}: {name} has dtype {x.dtype}, expected "
                             f"{dtype}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous {shape}, "
                             f"got {tuple(x.shape)}")
    if q.dtype not in entries:
        raise ValueError(f"{who}: dtype {q.dtype} is not ported (fp32 and "
                         f"bf16 queries)")
    check_geometry(hq, hkv, hd, num_pages, nb, who)
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} needs a 16-byte-aligned "
                             f"address (its rows' copies are aligned to it)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = num_splits(b, t * (hq // hkv), hkv, nb, ps, sms)
    parts = [0, 0]
    if splits > 1:
        part_acc = torch.empty((b, t, hq, splits, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, t, hq, splits, 2), dtype=torch.float32,
                              device=q.device)
        parts = [part_acc.data_ptr(), part_ml.data_ptr()]
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = entries[q.dtype]
    build.check(getattr(lib, entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *(s.data_ptr() for s in scales), block_tables.data_ptr(),
        lengths.data_ptr(), seg_lens.data_ptr(), out.data_ptr(), *parts, b,
        t, hq, hkv, hd, num_pages, ps, nb,
        0 if window is None else int(window), splits, hd ** -0.5, stream),
        entry)
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, seg_lens: torch.Tensor, *,
                    window: int | None = None) -> torch.Tensor:
    """Launch ``csrc/paged_attn.cu`` over fp pools in q's dtype (same
    contract as ``paged_attention_plain``).  Raises on anything the kernel
    does not take."""
    out = _launch(_ENTRY, q, k_pool, v_pool, (), block_tables, lengths,
                  seg_lens, window, "paged_attention")
    if q.numel():
        paged_attention.launches += 1
    return out


def paged_attention_int8(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor, seg_lens: torch.Tensor, *,
                         window: int | None = None) -> torch.Tensor:
    """Launch ``csrc/paged_attn.cu`` over int8 pools with fp32 scale pools
    (P, ps, Hkv, 1) (same contract as ``paged_attention_plain`` with
    scales).  Raises on anything the kernel does not take."""
    out = _launch(_ENTRY_INT8, q, k_pool, v_pool, (k_scale, v_scale),
                  block_tables, lengths, seg_lens, window,
                  "paged_attention_int8")
    if q.numel():
        paged_attention_int8.launches += 1
    return out


paged_attention.launches = 0
paged_attention_int8.launches = 0
