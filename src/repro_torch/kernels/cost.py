"""The work of each hand-written kernel: the bytes it must move (each
input read once, each output written once) and the operations it does.

One copy, read by ``chip_smoke.py`` (each kernel's bound on the card)
and by the kernel wrappers' meta branch (``kernels/ops.py``), which books
a kernel's cost to the active ``launch/opcount`` capture in place of
running it (the dry-run's FLOPs and bytes).  Every function returns
``(bytes, flops)``.
"""
from __future__ import annotations

import numpy as np


def attended_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through for one head."""
    i = np.arange(s)
    hi = i + 1 if causal else np.full(s, s)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, int)
    return int((hi - lo).sum())


def flash(b: int, s: int, hq: int, hkv: int, hd: int, elt: int,
          causal: bool, window) -> tuple[float, float]:
    """Full-sequence attention: q and out, k and v once; QK and PV over
    the attended pairs."""
    return (2.0 * b * s * (hq + hkv) * hd * elt,
            4.0 * b * hq * hd * attended_pairs(s, causal, window))


def moe_ffn(e: int, c: int, d: int, f: int, elt: int) -> tuple[float, float]:
    """Grouped SwiGLU FFN: x and y, the three weight stacks once; three
    (C, D) x (D, F)-sized products per expert."""
    return (float((2 * e * c * d + 3 * e * d * f) * elt),
            6.0 * e * c * d * f)


def moe_ffn_quant(e: int, c: int, d: int, f: int, elt: int,
                  weight_bytes: int) -> tuple[float, float]:
    """The same over quantized weights: their payload and scales once."""
    return float(2 * e * c * d * elt + weight_bytes), 6.0 * e * c * d * f


def paged(q_shape: tuple, hkv: int, slot_bytes: int, elt: int, lengths,
          seg, window) -> tuple[float, float]:
    """Paged attention: q and out once, each attended K/V slot once (an
    int8 slot: hd bytes plus its 4-byte scale), the tables; QK and PV over
    the attended slots of the valid tokens.  ``lengths`` and ``seg`` are
    host arrays."""
    b, t, hq, hd = q_shape
    kv_slots, pairs = 0, 0
    for i in range(b):
        slots = set()
        for j in range(int(seg[i])):
            qp = int(lengths[i]) + j
            lo = 0 if window is None else max(qp - window + 1, 0)
            slots.update(range(lo, qp + 1))
            pairs += qp + 1 - lo
        kv_slots += len(slots)
    nbytes = 2 * b * t * hq * hd * elt + 2 * kv_slots * hkv * slot_bytes \
        + 16 * b
    return float(nbytes), 4.0 * pairs * hq * hd


def paged_reach(q_shape: tuple, hkv: int, slot_bytes: int, elt: int,
                reach: int, window) -> tuple[float, float]:
    """Paged attention where the lengths are not known (a meta tensor
    holds no data): every token of every row attends the whole reach of
    its block table (``NB * page_size`` slots, cut to the window), an
    upper bound of ``paged``."""
    b, t, hq, hd = q_shape
    span = reach if window is None else min(reach, window)
    nbytes = 2 * b * t * hq * hd * elt + 2 * b * reach * hkv * slot_bytes \
        + 16 * b
    return float(nbytes), 4.0 * b * t * span * hq * hd
