"""Deterministic fault injection for the serving engine (docs/DESIGN.md §10):
a copy of the JAX package's ``serving/faults.py`` (numpy only; the port
imports nothing of that package).

The paper's target is an always-on private serving cluster: the engine
must survive overload and partial failure, not assume a benign batch.
This module is the *controlled adversary* half of that story — a
seedable, replayable schedule of faults the engine's guards are gated
against (tests/test_torch_resilience.py, ``python -m
repro_torch.serving.chaos``, ``chip_smoke.py``'s chaos phases).

A :class:`FaultPlan` maps ``(step, site)`` to a :class:`Fault`, where
``step`` is the engine's iteration counter (``ServingEngine`` increments
it once per ``step()`` call, first call = 1) and ``site`` is one of:

  * ``"alloc"``    — the page allocator reports exhaustion for that
    iteration: admission and lazy decode-page growth both see zero free
    pages (no eviction, no preemption is attempted — the fault models a
    pool with nothing reclaimable).  Guarded by: the starved row/request
    simply does not advance that iteration and is retried on the next
    (``stats["alloc_stalls"]``); refcounts are never touched.
  * ``"dispatch"`` — the device step raises :class:`InjectedFault`
    *instead of* running (a backend refusing the launch).  Guarded by:
    the engine catches it before any host bookkeeping was mutated (the
    sampler's step index included), so the identical iteration is
    re-dispatched next ``step()`` (``stats["dispatch_failures"]``).  The
    injection fires before anything is launched, so the page pool is
    untouched.  No other exception is caught: a real launch failure
    propagates.
  * ``"nan"``      — the chosen rows' logits are overwritten with
    NaN (or +inf, ``kind="inf"``) *on the device* via a poison vector
    uploaded with the step's other inputs.  Guarded by: the step always
    returns a per-row ``bad = ~all(isfinite(logits))`` flag; while a plan
    is installed the engine's quarantine guard fetches it, withholds the poisoned rows' host-state
    advance (lengths / prefill_pos / budgets / token record), and
    re-dispatches them from their last durable cache state — the
    repeated block writes are idempotent, neighbours never see the
    fault, and a row that stays non-finite for
    ``engine.NAN_RETRY_LIMIT`` consecutive steps is cancelled
    with status ``"failed"`` instead of spinning forever.

Determinism: a plan is a pure value — the same plan against the same
engine/workload fires the same faults at the same iterations, which is
what lets the chaos gates demand *token-identical* output on every
unfaulted (and, for transient faults, every faulted-then-recovered)
request.  ``FaultPlan.random(seed, ...)`` derives a schedule from a
``numpy`` generator so randomized chaos runs are replayable from the
seed alone.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

SITES = ("alloc", "dispatch", "nan")


class InjectedFault(RuntimeError):
    """Raised at a ``dispatch`` fault site; carries the fault record."""

    def __init__(self, fault: "Fault"):
        super().__init__(f"injected fault {fault.site!r} at engine step "
                         f"{fault.step}")
        self.fault = fault


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault: fire at engine iteration ``step`` on ``site``.

    ``rows`` selects which batch rows a ``"nan"`` fault poisons (empty =
    every row); ``kind`` picks the poison value (``"nan"`` or ``"inf"``).
    Both are ignored by the other sites."""
    step: int
    site: str
    rows: tuple = ()
    kind: str = "nan"

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"pick from {SITES}")
        if self.kind not in ("nan", "inf"):
            raise ValueError(f"unknown poison kind {self.kind!r}")
        if self.step < 1:
            raise ValueError(f"fault step must be >= 1, got {self.step}")

    @property
    def value(self) -> float:
        return float("inf") if self.kind == "inf" else float("nan")


class FaultPlan:
    """An immutable schedule of faults keyed on ``(step, site)``.

    The engine ``poll()``s each site it guards once per iteration; a
    poll that matches records the fault in ``fired`` (once per key), so
    harnesses can assert the plan was actually exercised
    (``all_fired()``) — a chaos gate that silently injected nothing
    would prove nothing."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self._by_key: dict[tuple[int, str], Fault] = {}
        for f in faults:
            key = (f.step, f.site)
            if key in self._by_key:
                raise ValueError(f"duplicate fault at {key}")
            self._by_key[key] = f
        self.fired: list[Fault] = []
        self._fired_keys: set[tuple[int, str]] = set()

    def __len__(self) -> int:
        return len(self._by_key)

    def __iter__(self):
        return iter(sorted(self._by_key.values(),
                           key=lambda f: (f.step, f.site)))

    def poll(self, step: int, site: str) -> Fault | None:
        """The engine's query point: the fault active at (step, site),
        or None.  Each fault fires exactly ONCE — repeat polls of the
        same key return None, so a retry that re-polls within the same
        step sees the fault cleared (transient-failure semantics)."""
        f = self._by_key.get((step, site))
        if f is None or (step, site) in self._fired_keys:
            return None
        self._fired_keys.add((step, site))
        self.fired.append(f)
        return f

    def maybe_raise(self, step: int, site: str) -> None:
        """Raise :class:`InjectedFault` if a fault is active — the
        ``dispatch`` site's idiom (the engine catches it in place of the
        real backend error)."""
        f = self.poll(step, site)
        if f is not None:
            raise InjectedFault(f)

    def all_fired(self) -> bool:
        return len(self.fired) == len(self._by_key)

    def unfired(self) -> list[Fault]:
        return [f for k, f in sorted(self._by_key.items())
                if k not in self._fired_keys]

    @classmethod
    def random(cls, seed: int, *, n_faults: int, max_step: int,
               sites: tuple = SITES, max_batch: int = 1,
               min_step: int = 1) -> "FaultPlan":
        """A replayable randomized schedule: ``n_faults`` faults at
        distinct (step, site) keys drawn from ``[min_step, max_step]`` ×
        ``sites``; NaN faults poison one random row of ``max_batch``."""
        rng = np.random.default_rng(seed)
        keys: set[tuple[int, str]] = set()
        faults: list[Fault] = []
        tries = 0
        while len(faults) < n_faults and tries < 100 * n_faults:
            tries += 1
            step = int(rng.integers(min_step, max_step + 1))
            site = str(rng.choice(sites))
            if (step, site) in keys:
                continue
            keys.add((step, site))
            if site == "nan":
                faults.append(Fault(step, site,
                                    rows=(int(rng.integers(0, max_batch)),),
                                    kind=str(rng.choice(["nan", "inf"]))))
            else:
                faults.append(Fault(step, site))
        return cls(faults)
