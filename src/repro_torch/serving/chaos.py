"""Deterministic chaos matrix of the port: every fault site
(``serving/faults.py``) plus an overcommit-preemption scenario, driven
through the unified engine (the JAX package's ``serving/chaos.py``).

The reference runs three layouts; the port runs two.  The contiguous
("unified") layout takes the dispatch and NaN sites (alloc faults need
the page allocator), as the reference's does; the reference's "paged"
(gather) and "kernel" (Pallas) layouts are one paged layout here, whose
attention is the CUDA kernel on the card and its plain version on the
CPU (``device``).  The gates:

  1. no crash — every injected fault is absorbed by an engine guard
     (alloc exhaustion stalls admission, a failed dispatch re-runs the
     identical iteration, non-finite logits quarantine the row);
  2. token identity — greedy decoding under transient faults emits the
     EXACT token stream of the fault-free baseline, and the preempted run
     (an overcommitted pool too small for both lifetimes, priorities 0 and
     5) the stream of the uncontended one, its restore re-attending
     through a remapped block table;
  3. allocator hygiene — after the workload drains and the prefix tree is
     cleared, every page is back on the free list and refcounts are
     consistent (``PageAllocator.check_consistent``);
  4. coverage — every fault in the plan fired (``FaultPlan.all_fired``);
  5. signature budget — fault recovery and preemption run the step
     bodies with no input signature beyond the steady-state set
     (``analysis.retrace.expected_trace_budget`` over the engine's
     ``trace_counts``: what a retrace is under the reference's jit, and a
     re-recording for a CUDA graph).

The weights are drawn on the CPU from ``seed`` and copied to the device,
so a CPU and a card run hold the same model.  The matrix is seeded and
host-driven, so a failure replays exactly:

    PYTHONPATH=src python -m repro_torch.serving.chaos [--device cpu]

Exit status 0 on a clean matrix, 1 with a per-scenario report otherwise.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.analysis.retrace import over_budget
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.models.model import build_model, resolve_device
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.faults import Fault, FaultPlan

# (name, layout, fault site): alloc faults need the page allocator
SCENARIOS = (("unified/dispatch", "unified", "dispatch"),
             ("unified/nan", "unified", "nan"),
             ("paged/alloc", "paged", "alloc"),
             ("paged/dispatch", "paged", "dispatch"),
             ("paged/nan", "paged", "nan"))


def _cfg(arch: str):
    # capacity_factor high enough that token routing never drops tokens:
    # the matrix gates exact token equality across schedules, and capacity
    # drops are schedule-dependent
    return get_config(arch).reduced().replace(capacity_factor=8.0)


def _to(tree: dict, device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _engine(cfg, params, device, *, layout: str = "paged",
            plan: FaultPlan | None = None, num_pages: int = 0,
            overcommit: bool = False) -> ServingEngine:
    return ServingEngine(cfg, EngineConfig(
        max_batch=2, max_cache=32, chunk_len=3, async_steps=False,
        paged=layout == "paged", page_size=4, num_pages=num_pages,
        overcommit=overcommit), params=params, device=device,
        fault_plan=plan)


def _serve(eng: ServingEngine, prompts, new_tokens: int,
           priorities=None) -> list:
    uids = [eng.submit(p, max_new_tokens=new_tokens,
                       priority=0 if priorities is None else priorities[i])
            for i, p in enumerate(prompts)]
    eng.run_until_done()
    return [list(eng._all[u].generated) for u in uids]


def _check_drained(eng: ServingEngine, errors: list, name: str) -> None:
    for r in eng._all.values():
        if r.status != "done":
            errors.append(f"{name}: request {r.uid} ended {r.status!r}")
    if not eng.paged:
        return
    for blk, (alloc, prefix) in enumerate(zip(eng.allocators,
                                              eng.prefixes)):
        prefix.clear()
        if not alloc.fully_free:
            errors.append(f"{name}: {alloc.pages_in_use} pages of data "
                          f"block {blk} leaked after drain")
        try:
            alloc.check_consistent()
        except AssertionError as e:
            errors.append(f"{name}: data block {blk}'s allocator "
                          f"inconsistent — {e}")


def _check_traces(eng: ServingEngine, errors: list, name: str) -> None:
    for key, count, budget in over_budget(eng):
        errors.append(f"{name}: step body '{key}' ran with {count} "
                      f"signatures (budget {budget}) — fault recovery "
                      "must reuse the steady-state signatures")


def _plan(site: str) -> FaultPlan:
    """Three injections of ``site`` spread over the run (alloc: admission
    and its immediate retry); NaN faults poison alternating rows, NaN and
    inf, so both slots exercise the quarantine."""
    if site == "nan":
        return FaultPlan([Fault(s, "nan", rows=(i % 2,),
                                kind=("nan", "inf")[i % 2])
                          for i, s in enumerate((2, 4, 7))])
    if site == "alloc":
        return FaultPlan([Fault(s, site) for s in (1, 2)])
    return FaultPlan([Fault(s, site) for s in (1, 3, 6)])


def run_matrix(arch: str, *, device="cuda", new_tokens: int = 6,
               seed: int = 0, weight_quant: str = "none",
               kv_cache_dtype: str = "native", verbose: bool = True,
               record: dict | None = None) -> list:
    """Run every scenario on ``device``; returns the gate violations ([]
    on a clean matrix).  ``record``, when given, receives each scenario's
    token streams, resilience counters and kernel launches by name (the
    paged layout's fault-free run is "baseline", the contiguous one's
    "baseline/unified")."""
    device = resolve_device(device)
    base = _cfg(arch)
    cfg = base.replace(weight_quant=weight_quant,
                       kv_cache_dtype=kv_cache_dtype)
    params = _to(build_model(base, "cpu").init(
        torch.Generator().manual_seed(seed)), device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, 7),
               rng.integers(0, cfg.vocab_size, 5)]
    errors: list = []

    def run(name, eng, n_new, priorities=None):
        ops.reset_launch_counts()
        try:
            got = _serve(eng, prompts, n_new, priorities)
        except Exception as e:                     # gate 1: no crash
            errors.append(f"{name}: crashed — {type(e).__name__}: {e}")
            return None
        if record is not None:
            record[name] = {"tokens": got, "launches": ops.launch_counts(),
                            "stats": eng.resilience_stats()}
        return got

    baseline = {}
    for layout, name in (("paged", "baseline"),
                         ("unified", "baseline/unified")):
        eng = _engine(cfg, params, device, layout=layout)
        baseline[layout] = run(name, eng, new_tokens)
        if baseline[layout] is not None:
            _check_drained(eng, errors, name)
            _check_traces(eng, errors, name)
    if errors:        # a broken baseline invalidates the whole matrix
        return errors

    for name, layout, site in SCENARIOS:
        plan = _plan(site)
        eng = _engine(cfg, params, device, layout=layout, plan=plan)
        got = run(name, eng, new_tokens)
        if got is None:
            continue
        if got != baseline[layout]:                # gate 2: token identity
            errors.append(f"{name}: tokens diverged from fault-free run")
        if not plan.all_fired():                   # gate 4: coverage
            errors.append(f"{name}: unfired faults {plan.unfired()}")
        _check_drained(eng, errors, name)          # gate 3: hygiene
        _check_traces(eng, errors, name)           # gate 5: budget
        if verbose:
            st = {k: v for k, v in eng.resilience_stats().items() if v}
            print(f"  {name:18s} ok={got == baseline[layout]}  {st}")

    # overcommit-preemption: a pool too small for both lifetimes forces a
    # mid-decode preempt and a prefix-cache restore; the tokens must still
    # match the uncontended run
    want = run("uncontended", _engine(cfg, params, device), 8)
    name = "paged/preempt"
    eng = _engine(cfg, params, device, num_pages=4, overcommit=True)
    got = run(name, eng, 8, priorities=[0, 5])
    if got is not None and want is not None:
        if got != want:
            errors.append(f"{name}: preempted run diverged from "
                          "uncontended run")
        st = eng.resilience_stats()
        if st["preemptions"] < 1 or st["restores"] < 1:
            errors.append(f"{name}: pool pressure produced no "
                          f"preempt/restore cycle ({st})")
        _check_drained(eng, errors, name)
        _check_traces(eng, errors, name)
        if verbose:
            print(f"  {name:18s} ok={got == want}  "
                  + str({k: st[k] for k in ("preemptions", "restores",
                                            "restore_hit_tokens")}))
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_moe_30b_a3b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--new-tokens", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weight-quant", choices=["none", "int8", "int4"],
                    default="none")
    ap.add_argument("--kv-cache-dtype", choices=["native", "int8"],
                    default="native")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print(f"chaos matrix: {args.arch} on {args.device} (seed {args.seed}, "
          f"weights {args.weight_quant}, KV {args.kv_cache_dtype})")
    errors = run_matrix(args.arch, device=args.device,
                        new_tokens=args.new_tokens, seed=args.seed,
                        weight_quant=args.weight_quant,
                        kv_cache_dtype=args.kv_cache_dtype)
    if errors:
        print(f"\nFAIL — {len(errors)} gate violation(s):")
        for e in errors:
            print(f"  - {e}")
        return 1
    print("chaos matrix clean: no crashes, token-identical recovery, "
          "allocator fully free, all faults fired, no signature beyond "
          "the budget")
    return 0


if __name__ == "__main__":
    sys.exit(main())
