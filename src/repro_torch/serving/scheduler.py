"""Admission policy for the serving engine: a numpy-free copy of the part of
the JAX package's ``serving/scheduler.py`` that the unified paged path
uses (preemption victim selection comes with overcommit, ROADMAP queue A:
resilience paths and sampling).

Pure host-side policy: who waits (:class:`AdmissionQueue`) and how many
pages a request is entitled to now vs. over its lifetime
(:func:`pages_for` / :func:`lifetime_pages`).  Higher
``Request.priority`` admits first; ties admit FIFO by submission sequence.
"""
from __future__ import annotations

import bisect


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache positions."""
    return max(0, -(-tokens // page_size))


def lifetime_pages(ctx_len: int, remaining_new: int, page_size: int) -> int:
    """Whole-lifetime page count: positions written = context plus every
    generated token except the last (whose KV is never stored)."""
    return pages_for(ctx_len + max(remaining_new, 1) - 1, page_size)


class AdmissionQueue:
    """Priority-ordered admission queue with a deque-like API.

    Orders by ``(-priority, seq)``: higher priority first, FIFO within a
    priority.  Supports truthiness, ``len``, ``queue[0]`` peek, ``append``
    and ``popleft``.
    """

    def __init__(self):
        self._keys: list[tuple[int, int]] = []   # (-priority, seq)
        self._reqs: list = []

    def __len__(self) -> int:
        return len(self._reqs)

    def __bool__(self) -> bool:
        return bool(self._reqs)

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
