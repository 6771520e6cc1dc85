"""R6 sharding lint: expert-sharded weights never travel (the JAX
package's ``analysis/sharding_lint.py``).

Every schedule moves activations between expert shards; the expert
weights stay put (that is the point of expert parallelism, and the
paper's Table 2 memory budget depends on it).  A layout regression (a
spec typo, a schedule closing over replicated weights) shows as an
all-gather whose result is a whole expert-weight slice.  The rule flags
any all-gather of the step (``opcount.collective_ops``, booked by
``core/collectives``) whose result reaches one layer's smallest
expert-weight slice on this rank; activation gathers are orders of
magnitude below that.
"""
from __future__ import annotations

from repro_torch.analysis.framework import Rule
from repro_torch.core.quant import QuantTensor
from repro_torch.launch import opcount


def expert_gather_threshold(prog) -> int | None:
    """Smallest per-layer expert-weight slice in bytes (None: no
    experts).  A QuantTensor counts its payload and scales."""
    blocks = prog.engine.params.get("blocks", {})
    experts = blocks.get("experts") if isinstance(blocks, dict) else None
    if not experts:
        return None
    n_layers = max(int(getattr(prog.cfg, "num_layers", 1)), 1)
    sizes = []
    for leaf in experts.values():
        nb = (leaf.nbytes() if isinstance(leaf, QuantTensor)
              else leaf.numel() * leaf.element_size())
        # stacked leaves are (L, E, ...): a per-layer gather moves nb / L
        sizes.append(nb // n_layers if len(leaf.shape) >= 3 else nb)
    return min(sizes)


class ShardingLintRule(Rule):
    rule_id = "R6"
    name = "sharding-lint"
    description = "no all-gather of expert-sharded weight leaves"
    requires = "ops"

    def check(self, prog):
        threshold = expert_gather_threshold(prog)
        if threshold is None:
            return []
        return [self.finding(
            prog.name,
            f"all-gather of {nb} B >= expert-weight slice ({threshold} B) "
            f"— expert weights must stay sharded: {line[:120]}",
            bytes=nb, threshold=threshold, line=line)
            for kind, nb, line in opcount.collective_ops(prog.records)
            if kind == "all-gather" and nb >= threshold]
