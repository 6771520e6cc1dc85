"""R3 retrace: the engine's step bodies run with their documented set of
input signatures, nothing more (the JAX package's ``analysis/retrace.py``).

The reference counts traces: on CPU-class backends a silent retrace costs
more than hundreds of steps, and the classic regressions (a host int
leaking into a shape, a static flag toggling per step, ragged chunk
widths) all show as trace counts creeping past the documented set.  The
port runs eagerly, so it counts what a trace is keyed on:
``ServingEngine.trace_counts`` holds, per step body, the distinct input
signatures (shapes, dtypes and the static sampling flag) it has run
with.  A new signature is a retrace under the reference's ``jit`` and a
new recording for a CUDA graph of the body.  The documented budget per
engine mode is the reference's:

  * unified:   2 signatures of ``unified``: the chunk_len-wide mixed
               block and the width-1 pure-decode block (1 when
               chunk_len == 1);
  * paged:     + 1 ``copy_pages`` (copy-on-write);
  * reference: 1 prefill (batched or per-slot) + 1 ``decode``;
  * sampling:  the first stochastic request flips the static flag and
               doubles each budget (the one documented retrace).

``drive_engine`` pushes an engine through admission, chunked prefill,
mixed and pure-decode steps, a paged preempt and prefix restore, and a
NaN-quarantine retry; the rule then holds the counts to the budget.
Budgets are upper bounds.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.framework import Rule
from repro_torch.serving.faults import Fault, FaultPlan


def expected_trace_budget(eng) -> dict:
    """Max signatures per step body for this engine's configuration.
    Preempt, restore and quarantine are deliberately not budget lines:
    they must reuse the steady-state signatures."""
    if eng.unified:
        budget = {"unified": 2 if eng.chunk_len > 1 else 1}
        if eng.paged:
            budget["copy_pages"] = 1
    else:
        key = ("prefill_batch" if eng.ecfg.batched_prefill
               else "prefill_one")
        budget = {key: 1, "decode": 1}
    mult = 2 if eng._sampling else 1
    return {k: v * mult for k, v in budget.items()}


def drive_engine(eng, *, rounds: int = 2, prompt_len: int = 6,
                 new_tokens: int = 4, seed: int = 0) -> None:
    """Admission -> chunked prefill -> mixed -> pure-decode transitions,
    twice over; on a paged engine also a mid-decode preempt and prefix
    restore; on a unified engine a NaN-quarantine retry."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        for _ in range(eng.ecfg.max_batch):
            eng.submit(rng.integers(0, 50, prompt_len),
                       max_new_tokens=new_tokens)
        eng.run_until_done()
    if eng.paged:
        # preempt a decoding row, then restore through the prefix cache:
        # the block-table remap and the one-token tail re-prefill must
        # reuse the chunk_len-wide block and the budgeted copy_pages
        uid = eng.submit(rng.integers(0, 50, prompt_len),
                         max_new_tokens=new_tokens + 2)
        req = eng._all[uid]
        for _ in range(64):
            eng.step()
            slot = next((i for i, r in enumerate(eng.slots) if r is req),
                        None)
            if (slot is not None
                    and eng.prefill_pos[slot] >= len(eng.slot_ctx[slot])):
                break
        eng.preempt(uid)
        eng.run_until_done()
    if eng.unified and eng.faults is None:
        # quarantine retry: poison one step's logits (a fault plan turns
        # the NaN guard on); the retried dispatch has the signature it
        # failed at
        eng.faults = FaultPlan([Fault(eng._iter + 2, "nan")])
        try:
            eng.submit(rng.integers(0, 50, prompt_len),
                       max_new_tokens=new_tokens)
            eng.run_until_done()
        finally:
            eng.faults = None


def over_budget(eng) -> list:
    """(body, count, budget) for every body past its budget."""
    budget = expected_trace_budget(eng)
    return [(key, count, budget.get(key, 0))
            for key, count in sorted(eng.trace_counts.items())
            if count > budget.get(key, 0)]


class RetraceRule(Rule):
    rule_id = "R3"
    name = "retrace"
    description = "no step-body signature beyond the documented set"
    requires = "engine"

    def __init__(self, workload=drive_engine):
        self.workload = workload

    def check_engine(self, eng, program: str = "engine") -> list:
        """Drive ``eng`` (freshly built: trace_counts at zero) and audit
        its signature counts."""
        if self.workload is not None:
            self.workload(eng)
        return [self.finding(
            program,
            f"step body '{key}' ran with {count} signatures (documented "
            f"budget {allowed}) — a silent retrace eating dispatch "
            "latency", body=key, count=count, budget=allowed)
            for key, count, allowed in over_budget(eng)]
