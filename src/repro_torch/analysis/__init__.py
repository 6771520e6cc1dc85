"""Rule-based analysis of the port's engine (the JAX package's
``analysis/``).

The paper's central finding is that memory management (hidden cache
copies) and per-message latency, not link bandwidth, dominate multi-node
MoE inference.  The reference encodes the invariants as rules over what
XLA compiled (HLO text, jaxprs).  The port runs eagerly, so each rule
reads what it actually does instead:

  * the stream of aten ops one engine step dispatches
    (``launch/opcount.capture``, a ``TorchDispatchMode``);
  * the byte counters ``core/collectives`` keeps by HLO kind name
    (``mesh.bytes``);
  * storage identity, in place of input-output aliasing;
  * ``torch.cuda.set_sync_debug_mode``, in place of a host-sync view of
    the compiled program.

Rules:
  R1 donation-alias   every cache leaf keeps its storage; no copy of a
                      leaf's size; no virtual cache on the kernel path
  R2 collective-bytes per-kind collective bytes match core/perf_model
  R3 retrace          step bodies run with their documented signatures
  R4 host-sync        no blocking device->host reads in the hot loop
  R5 quant-integrity  data/scale siblings enter products together; no
                      full dequantized weight outside qdot
  R6 sharding-lint    no all-gather of expert-sharded weights

Run ``python -m repro_torch.analysis`` from the command line.
"""
from repro_torch.analysis.framework import (Finding, Report, Rule,  # noqa: F401
                                            demote_findings, run_rules)

RULE_IDS = ("R1", "R2", "R3", "R4", "R5", "R6")


def analyze_engines(variants, rule_ids=RULE_IDS, *, arch=None,
                    device="cuda", mesh=None, cfg_kw=None,
                    warn_only=()) -> Report:
    """Every rule of ``rule_ids`` over each variant's engine on
    ``device`` (and ``mesh``): R1, R2, R5 and R6 over one traced step of
    each, R3 over a driven engine of each, R4 over the engine's source
    and, on one CUDA device, over a driven engine of each under the sync
    debug mode."""
    from repro_torch.analysis import programs
    from repro_torch.analysis.collectives import CollectiveBudgetRule
    from repro_torch.analysis.donation import DonationAliasRule
    from repro_torch.analysis.hostsync import HostSyncRule
    from repro_torch.analysis.quant_integrity import QuantIntegrityRule
    from repro_torch.analysis.retrace import RetraceRule, drive_engine
    from repro_torch.analysis.sharding_lint import ShardingLintRule
    arch = arch or programs.DEFAULT_ARCH
    rule_ids = [r.upper() for r in rule_ids]
    kw = dict(device=device, mesh=mesh, cfg_kw=cfg_kw)
    prog_rules = [r for r in (DonationAliasRule(), CollectiveBudgetRule(),
                              QuantIntegrityRule(), ShardingLintRule())
                  if r.rule_id in rule_ids]
    traced = ([programs.trace_program(v, arch, **kw) for v in variants]
              if prog_rules else [])
    report = run_rules(prog_rules, traced, warn_only=warn_only)
    report.programs = list(variants)
    report.rules = list(rule_ids)
    extra = []
    if "R3" in rule_ids:
        for v in variants:
            extra += RetraceRule().check_engine(
                programs.build_engine(v, arch, **kw), f"{v}-engine")
    if "R4" in rule_ids:
        extra += HostSyncRule().check_source()
        if mesh is None and str(device).startswith("cuda"):
            for v in variants:
                extra += HostSyncRule().check_dynamic(
                    programs.build_engine(v, arch, **kw), drive_engine,
                    f"{v}-engine")
    report.findings.extend(demote_findings(extra, warn_only))
    return report


# ---------------------------------------------------------------------------
# the CLI's runs (here, not in ``__main__``: spawned ranks import them)
# ---------------------------------------------------------------------------

def cli_report(args, variants, mesh=None) -> Report:
    """The report of the CLI's ``args`` over ``variants``."""
    rule_ids = [r.strip().upper() for r in args.rules.split(",")
                if r.strip()]
    warn_only = {r.strip().upper() for r in args.warn_only.split(",")
                 if r.strip()}
    # the mesh engine's reduced config: capacity that never binds and an
    # unsharded kv cache, as the reference's CLI sets on a mesh
    cfg_kw = (dict(capacity_factor=8.0, kv_cache_shard="none")
              if mesh is not None else None)
    return analyze_engines(variants, rule_ids, arch=args.arch,
                           device=args.device, mesh=mesh, cfg_kw=cfg_kw,
                           warn_only=warn_only)


def _rank(rank: int, world: int, store: str, args, variants, q) -> None:
    """One rank's report on the (data, model) mesh, put on ``q``."""
    import traceback
    try:
        import torch
        from repro_torch.launch import mesh as mesh_lib
        torch.set_num_threads(1)
        mesh_lib.init_ranks(rank, world, store)
        mesh = mesh_lib.make_test_mesh(max(args.data, 1), max(args.ep, 1))
        rep = cli_report(args, variants, mesh)
        torch.distributed.destroy_process_group()
        q.put((rank, rep.to_dict()))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def mesh_report(args, variants, timeout_s: float = 900.0) -> Report:
    """``args.data * args.ep`` spawned gloo ranks, each running the rules
    on its blocks; one report of every rank's findings (programs named
    ``rank<r>/<program>``)."""
    import multiprocessing as mp
    import queue
    import tempfile
    import time
    world = max(args.ep, 1) * max(args.data, 1)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(
            r, world, f"{tmp}/store", args, variants, q))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world:
                try:
                    r, v = q.get(timeout=1.0)
                    got[r] = v
                except queue.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > deadline:
                        raise RuntimeError(
                            f"mesh analysis: {len(dead)} rank(s) died, "
                            f"{world - len(got)} never reported")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    bad = {r: v for r, v in got.items() if isinstance(v, str)}
    if bad:
        raise RuntimeError(f"rank {min(bad)} failed:\n{bad[min(bad)]}")
    report = Report(programs=list(variants), rules=got[0]["rules"])
    for r in sorted(got):
        for f in got[r]["findings"]:
            report.findings.append(Finding(**dict(
                f, program=f"rank{r}/{f['program']}")))
    return report
