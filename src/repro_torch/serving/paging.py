"""Host-side page management for the paged KV cache (docs/DESIGN.md §7).

A numpy-only copy of the JAX package's ``serving/paging.py``: the port
imports nothing of that package.

The paper's central systems finding is that memory is the binding
constraint and memory-management churn the dominant overhead (§4.2/§5.4:
pre-allocated buffers remove the allocator from the hot loop).  The paged
cache keeps that property — ONE donated pool ``(L, num_pages, page_size,
Hkv, hd)`` allocated at engine start, never resized — while replacing the
contiguous slot-per-request reservation (every request pinning
``max_cache`` slots whether it uses 20 or 200) with page-granular
accounting:

  * :class:`PageAllocator` — free list + per-page reference counts.  All
    bookkeeping is host-side integers; the device never sees an
    allocation, only block tables (per-row page-id vectors) handed to the
    step like ``lengths``.  ``fork`` shares pages between owners
    (refcount++), and ``writable`` implements copy-on-write: a page about
    to be written that has other owners is re-homed to a fresh page and
    the caller is told to issue a device page copy.
  * :class:`PrefixCache` — a radix tree over **page-sized token chunks**
    of completed prompts.  Requests sharing a system prompt map their
    leading block-table entries to the same physical pages and skip
    prefill for the shared prefix entirely (the Apple Foundation-Models
    serving shape: thousands of requests over one system prompt).  A node
    may also hold a *partial tail* record — the last, not-page-aligned
    chunk of a cached prompt — which a new request with the same prompt
    shares via copy-on-write (the tail page's owner keeps appending decode
    tokens to it, so the sharer copies the page and overwrites the
    divergent suffix as it generates).  Eviction is LRU over leaves: a
    leaf's tree reference is dropped and the page returns to the free list
    once no in-flight request maps it.

Sharing is exact, not approximate: a cache chunk is keyed by its literal
token bytes, and causal attention makes the K/V of a prompt prefix a pure
function of that prefix (MoE included, when dispatch capacity is not
binding), so a reused page is bit-identical to a recomputed one.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


class PageAllocator:
    """Free-list page allocator with reference counting.

    Pages are integers in ``[0, num_pages)``.  Every mapped page has
    refcount >= 1; ``free`` decrements and returns the page to the free
    list at zero.  ``alloc`` is all-or-nothing (returns None rather than a
    partial allocation), so admission control can gate on
    ``free_pages`` without unwinding.  Invariants (property-tested in
    tests/test_paged_cache.py): a page is never in the free list twice,
    never both free and referenced, and after every owner releases its
    references the pool is fully free again.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        # pop() hands out ascending ids — deterministic, test-friendly
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = [0] * num_pages

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def fully_free(self) -> bool:
        """True when every page is back on the free list — the drain
        invariant the resilience gates check after every preempt /
        cancel / fault schedule."""
        return len(self._free) == self.num_pages

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def check_consistent(self) -> None:
        """Raise if the free list and refcounts disagree: a page on the
        free list twice, a free page with owners, or a mapped page
        without a reference.  The chaos harness and the resilience
        property tests call this after every engine step, so a failure
        path that corrupts the accounting fails loudly at the step that
        broke it, not at drain."""
        if len(set(self._free)) != len(self._free):
            raise AssertionError("page on the free list twice")
        free = set(self._free)
        for p in range(self.num_pages):
            if p in free and self._ref[p] != 0:
                raise AssertionError(
                    f"page {p} is free but has refcount {self._ref[p]}")
            if p not in free and self._ref[p] <= 0:
                raise AssertionError(
                    f"page {p} is mapped but has refcount {self._ref[p]}")

    # -- ops ----------------------------------------------------------------

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` pages (refcount 1 each); None if fewer are free."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def fork(self, pages: Iterable[int]) -> None:
        """Add one reference per page (a new owner shares existing pages)."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"fork of unreferenced page {p}")
            self._ref[p] += 1

    def free(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; a page with no owners left returns
        to the free list.  Freeing an already-free page raises — the
        double-free class of bug the property test hunts."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def writable(self, page: int) -> tuple[int, bool]:
        """Copy-on-write: return a page the caller may write.

        If the caller is the sole owner the page itself is returned.
        Otherwise one reference is moved to a freshly allocated page and
        ``(new_page, True)`` is returned — the caller must issue a device
        copy ``page -> new_page`` before writing.  Returns ``(page,
        False)`` on sole ownership; raises if no page is free for the
        copy (callers gate admission on ``free_pages`` first)."""
        if self._ref[page] <= 0:
            raise ValueError(f"writable() on unreferenced page {page}")
        if self._ref[page] == 1:
            return page, False
        got = self.alloc(1)
        if got is None:
            raise RuntimeError("no free page for copy-on-write")
        self._ref[page] -= 1
        return got[0], True


@dataclasses.dataclass
class _Node:
    """One radix-tree node = one full page of prompt tokens.

    ``children`` maps the NEXT chunk's token bytes to its node.  A node
    may additionally hold a partial-tail record: the page holding the
    first ``tail_len`` tokens after this node's chunk (a prompt whose
    length is not page-aligned).  The tree owns one allocator reference
    per ``page`` / ``tail_page`` it records."""
    page: int = -1                      # -1: root (no page of its own)
    children: dict = dataclasses.field(default_factory=dict)
    tail_page: int = -1
    tail_tokens: np.ndarray | None = None
    last_used: int = 0


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    """Result of a prefix-cache lookup.  ``pages`` are full shared pages
    (the caller holds one reference on each); ``tokens`` counts full-page
    tokens plus ``tail_len`` tokens readable from ``tail_page`` (also
    referenced when >= 0).  The tail page must be copy-on-write'd before
    the request writes past the shared region."""
    pages: tuple
    tokens: int
    tail_page: int = -1
    tail_len: int = 0


class PrefixCache:
    """Radix tree of page-aligned prompt prefixes over physical pages.

    ``lookup`` walks full-page chunks while they match (capped at
    ``len(prompt) - 1`` shared tokens — at least one prompt token is
    always recomputed so the request has a logit to sample its first
    token from), then tries the terminal partial-tail record.  ``insert``
    is first-writer-wins: existing nodes keep their pages, only newly
    created nodes take a tree reference.  ``evict`` drops LRU leaves (and
    tail records) until enough allocator pages are free or nothing
    evictable remains; a page still mapped by an in-flight request merely
    loses its tree reference and returns to the pool when that request
    completes."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.alloc = allocator
        self.root = _Node()
        self._tick = 0
        self.cached_pages = 0           # pages the tree holds references on
        self.evictions = 0              # pages evicted (tree refs dropped)

    def _key(self, tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def lookup(self, prompt: np.ndarray) -> PrefixHit:
        """Longest shared prefix of ``prompt`` present in the tree.  The
        caller receives one allocator reference per returned page (full
        and tail) and must ``free`` them when the request completes."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        cap = len(prompt) - 1           # always recompute >= 1 prompt token
        self._tick += 1
        node, pages = self.root, []
        while (len(pages) + 1) * ps <= cap:
            chunk = self._key(prompt[len(pages) * ps:(len(pages) + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                break
            pages.append(child.page)
            node = child
            node.last_used = self._tick
        hit_tokens = len(pages) * ps
        tail_page, tail_len = -1, 0
        if node.tail_page >= 0 and node.tail_tokens is not None:
            tt = node.tail_tokens
            usable = min(len(tt), cap - hit_tokens)
            if usable >= 1 and np.array_equal(
                    tt[:usable], prompt[hit_tokens:hit_tokens + usable]):
                tail_page, tail_len = node.tail_page, int(usable)
                node.last_used = self._tick
        self.alloc.fork(pages)
        if tail_page >= 0:
            self.alloc.fork([tail_page])
        return PrefixHit(tuple(pages), hit_tokens + tail_len,
                         tail_page, tail_len)

    def insert(self, prompt: np.ndarray, pages: Iterable[int],
               tail_page: int = -1, tail_len: int = 0) -> int:
        """Record a prefilled prompt: ``pages`` hold its full page-aligned
        chunks, ``tail_page`` its first ``tail_len`` overflow tokens.  The
        tree takes one reference per page it newly records; existing
        nodes are left untouched (their identical-content pages win).
        Returns the number of pages newly referenced."""
        prompt = np.asarray(prompt, np.int32)
        pages = list(pages)
        ps = self.page_size
        if len(pages) * ps + max(tail_len, 0) > len(prompt):
            raise ValueError("insert covers more tokens than the prompt")
        self._tick += 1
        node, added = self.root, 0
        for i, page in enumerate(pages):
            chunk = self._key(prompt[i * ps:(i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(page=int(page))
                node.children[chunk] = child
                self.alloc.fork([page])
                self.cached_pages += 1
                added += 1
            child.last_used = self._tick
            node = child
        if tail_len >= 1 and tail_page >= 0 and node.tail_page < 0:
            node.tail_page = int(tail_page)
            node.tail_tokens = np.array(
                prompt[len(pages) * ps:len(pages) * ps + tail_len], np.int32)
            self.alloc.fork([tail_page])
            self.cached_pages += 1
            added += 1
        return added

    def _drop_tail(self, node: _Node) -> None:
        self.alloc.free([node.tail_page])
        node.tail_page, node.tail_tokens = -1, None
        self.cached_pages -= 1
        self.evictions += 1

    def reclaimable_pages(self) -> int:
        """Tree-held pages that would reach the free list if evicted NOW
        (refcount 1 — no in-flight request maps them).  Admission uses
        this to avoid draining the tree when eviction cannot possibly
        free enough pages (the pages are pinned by running requests)."""
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.tail_page >= 0 and self.alloc.refcount(node.tail_page) == 1:
                count += 1
            for child in node.children.values():
                if self.alloc.refcount(child.page) == 1:
                    count += 1
                stack.append(child)
        return count

    def evict(self, need_free: int) -> int:
        """Drop LRU leaves / tail records until ``allocator.free_pages >=
        need_free`` or the tree is exhausted.  Returns pages whose tree
        reference was dropped (they reach the free list only once no
        request maps them)."""
        dropped = 0
        while self.alloc.free_pages < need_free:
            victims = []                # (last_used, parent, key|None, node)
            stack = [(None, None, self.root)]
            while stack:
                parent, key, node = stack.pop()
                if node.tail_page >= 0:
                    victims.append((node.last_used, node, None))
                for k, child in node.children.items():
                    if child.children or child.tail_page >= 0:
                        stack.append((node, k, child))
                    else:
                        victims.append((child.last_used, node, k))
            if not victims:
                break
            _, parent, key = min(victims, key=lambda v: v[0])
            if key is None:             # tail record on ``parent``
                self._drop_tail(parent)
            else:
                child = parent.children.pop(key)
                self.alloc.free([child.page])
                self.cached_pages -= 1
                self.evictions += 1
            dropped += 1
        return dropped

    def clear(self) -> int:
        """Drop every tree reference (engine shutdown / benchmark warmup
        resets).  NOT eviction pressure: the ``evictions`` counter is
        preserved so reported stats only ever count admission-driven
        evictions."""
        before = self.evictions
        dropped = self.evict(self.alloc.num_pages + 1)
        self.evictions = before
        return dropped
