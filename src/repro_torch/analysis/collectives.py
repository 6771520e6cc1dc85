"""R2 collective-bytes budget: the paper's latency accounting (the JAX
package's ``analysis/collectives.py``).

Paper §5.2: expert communication time is about expert computation time,
so the bytes each schedule moves per layer are a pinned quantity.
``core/perf_model.predicted_collective_bytes(..., include_tp=True)``
mirrors the schedules and the serve layout's tensor-parallel terms
analytically; this rule holds the step's ``mesh.bytes``, the counters
``core/collectives`` keeps by HLO kind name, to it.

Each rank runs its data block of rows (``ServingEngine.blocks``: G
blocks, or one where the data axes do not divide the batch:
``expert_parallel.batch_split``), as the reference's
per-shard program does, so a rank's step moves ``predicted(...,
n_batch_shards=G)`` exactly.  The kinds the prediction leaves out are
booked apart and not compared: the aux-loss pmeans (``collectives.AUX``),
the layout step of the a2a schedules (``LAYOUT``), the LM head's
vocabulary gather (``model.HEAD``) and the engine's gather of the data
blocks' sampled tokens (``collectives.ROWS``).  Any other kind the model does
not predict (context-parallel decode's) is a warning.

On one device no collective may be issued at all.
"""
from __future__ import annotations

from repro_torch.analysis.framework import Rule
from repro_torch.core import collectives, perf_model
from repro_torch.models.model import HEAD

BOOKED_APART = (collectives.AUX, collectives.LAYOUT, HEAD, collectives.ROWS)


def predicted(prog) -> dict:
    """The step's predicted bytes by kind on its rank, whose rows are one
    of ``prog.n_batch_shards`` data blocks."""
    if prog.n_exp_shards * prog.n_batch_shards == 1:
        return {}
    return perf_model.predicted_collective_bytes(
        prog.cfg, batch=prog.batch, seq=prog.seq,
        n_exp_shards=prog.n_exp_shards, n_batch_shards=prog.n_batch_shards,
        include_tp=True)


class CollectiveBudgetRule(Rule):
    rule_id = "R2"
    name = "collective-bytes"
    description = ("per-kind collective bytes match core/perf_model "
                   "predictions")
    requires = "ops"

    def __init__(self, rel_tol: float = 0.5):
        self.rel_tol = rel_tol

    def check(self, prog):
        findings = []
        actual = {k: float(v) for k, v in prog.coll.items()}
        pred = predicted(prog)
        if prog.n_exp_shards * prog.n_batch_shards == 1:
            for kind, nb in sorted(actual.items()):
                if nb > 0:
                    findings.append(self.finding(
                        prog.name,
                        f"{kind} moves {nb:.0f} B in a single-device "
                        "serving program (predicted: none)",
                        kind=kind, actual=nb, predicted=0.0))
            return findings
        for kind, want in sorted(pred.items()):
            got = actual.get(kind, 0.0)
            if abs(got - want) > self.rel_tol * want:
                findings.append(self.finding(
                    prog.name,
                    f"{kind}: {got:.0f} B in the step vs {want:.0f} B "
                    f"predicted (rel_tol {self.rel_tol})",
                    kind=kind, actual=got, predicted=want))
        for kind, got in sorted(actual.items()):
            if kind not in pred and kind not in BOOKED_APART and got > 0:
                findings.append(self.finding(
                    prog.name,
                    f"unbudgeted collective kind {kind}: {got:.0f} B "
                    "(not part of the schedule's model)",
                    severity="warning", kind=kind, actual=got))
        return findings
