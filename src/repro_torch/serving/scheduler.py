"""Priority admission and preemption policy for the serving engine: a copy
of the JAX package's ``serving/scheduler.py`` (the port imports nothing of
that package).

Pure host-side policy (docs/DESIGN.md §10): nothing here touches the
device.  The engine owns the *mechanism* — evicting a row's pages into
the prefix tree and restoring it later is `ServingEngine._preempt_slot`
/ `_admit_paged` — while this module owns the *decisions*: who waits
(:class:`AdmissionQueue`), who yields (:func:`select_victim`), and how
many pages a request is entitled to now vs. over its lifetime
(:func:`pages_for` / :func:`lifetime_pages`).

Scheduling contract, gated by tests/test_torch_resilience.py:

  * higher ``Request.priority`` admits first; ties admit FIFO by
    submission sequence, and a preempted request keeps its original
    sequence so it re-enters *ahead* of later same-priority arrivals;
  * a victim is only ever chosen from strictly-lower-priority running
    rows at admission time (``below=``), or unconditionally under
    decode-growth pressure where *somebody* must yield a page;
  * among eligible victims the least-recently-preempted yields first
    (``epoch`` ascending), so no ready request is preempted twice in a
    row while a peer of no-higher priority keeps running — the
    fairness property test pins exactly this;
  * ties beyond that evict the youngest arrival (``seq`` descending),
    which drains the oldest requests first and gives the
    eventually-completes property its progress measure.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, Optional


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache positions."""
    return max(0, -(-tokens // page_size))


def lifetime_pages(ctx_len: int, remaining_new: int, page_size: int) -> int:
    """Whole-lifetime page count: positions written = context plus every
    generated token except the last (whose KV is never stored)."""
    return pages_for(ctx_len + max(remaining_new, 1) - 1, page_size)


@dataclasses.dataclass(frozen=True)
class RunningRow:
    """A candidate victim: one occupied engine slot."""
    slot: int
    priority: int
    epoch: int      # engine preemption epoch at this request's last
                    # preemption (0 = never preempted)
    seq: int        # submission sequence number


def select_victim(rows: Iterable[RunningRow], *,
                  below: Optional[int] = None,
                  exclude: tuple = ()) -> Optional[int]:
    """The slot that should yield its pages, or None if nobody is
    eligible.

    ``below`` restricts victims to priority strictly less than it (the
    admission-time rule: a request may only displace lesser work);
    ``below=None`` is growth pressure, where any running row — including
    the grower itself — may be chosen.  Ordering: lowest priority, then
    least-recently-preempted, then youngest arrival.
    """
    cands = [r for r in rows
             if r.slot not in exclude
             and (below is None or r.priority < below)]
    if not cands:
        return None
    return min(cands, key=lambda r: (r.priority, r.epoch, -r.seq)).slot


class AdmissionQueue:
    """Priority-ordered admission queue with the engine's old deque API.

    Orders by ``(-priority, seq)``: higher priority first, FIFO within a
    priority.  A preempted request re-``append``-ed here keeps the
    ``seq`` it was assigned at submit, so it outranks every
    same-priority request that arrived after it — preemption costs a
    request its slot, never its place in line.

    Supports the operations the engine and its callers already use on
    ``collections.deque``: truthiness, ``len``, iteration (in admission
    order), ``queue[0]`` peek, ``append``, ``popleft`` — plus
    ``remove(uid)`` for cancellation and deadline expiry.
    """

    def __init__(self):
        self._keys: list[tuple[int, int]] = []   # (-priority, seq)
        self._reqs: list = []

    def __len__(self) -> int:
        return len(self._reqs)

    def __bool__(self) -> bool:
        return bool(self._reqs)

    def __iter__(self):
        return iter(list(self._reqs))

    def __getitem__(self, idx):
        return self._reqs[idx]

    def append(self, req) -> None:
        key = (-req.priority, req.seq)
        i = bisect.bisect_right(self._keys, key)
        self._keys.insert(i, key)
        self._reqs.insert(i, req)

    def popleft(self):
        if not self._reqs:
            raise IndexError("pop from an empty AdmissionQueue")
        self._keys.pop(0)
        return self._reqs.pop(0)

    def remove(self, uid: int):
        """Drop and return the queued request with ``uid`` (None if not
        queued)."""
        for i, req in enumerate(self._reqs):
            if req.uid == uid:
                self._keys.pop(i)
                return self._reqs.pop(i)
        return None

    def clear(self) -> None:
        self._keys.clear()
        self._reqs.clear()
