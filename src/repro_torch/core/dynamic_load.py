"""Router-aided dynamic loading (paper §4.2, L_R) — host-side half: a copy
of the JAX package's ``LRUExpertTracker``, ``quota_topup`` and
``simulate_expected_experts``.

Per-layer last-used step and execution count per expert, the paper's LRU
structure.  The serving engine feeds it the device-captured routing of
every served step and reads the paper's E[#executed experts/node/layer]
statistic from it.  ``quota_topup`` is the paper's top-up of each node's
executed set to the largest selection (Fig. 6b), and
``simulate_expected_experts`` its Monte-Carlo check of Table 1.
"""
from __future__ import annotations

import numpy as np


class LRUExpertTracker:
    def __init__(self, num_layers: int, num_experts: int):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.last_used = np.zeros((num_layers, num_experts), np.int64)
        self.exec_counts = np.zeros((num_layers, num_experts), np.int64)
        self.step = 0

    def observe(self, layer: int, expert_ids) -> None:
        ids = np.asarray(expert_ids).reshape(-1)
        self.last_used[layer, ids] = self.step
        self.exec_counts[layer, ids] += 1

    def tick(self) -> None:
        self.step += 1

    def lru_order(self, layer: int) -> np.ndarray:
        """Expert ids, least-recently-used first (stable)."""
        return np.argsort(self.last_used[layer], kind="stable")

    def staleness(self, layer: int) -> np.ndarray:
        return self.step - self.last_used[layer]

    def mean_executed_per_node(self, n_nodes: int) -> float:
        """E[#executed experts/node/layer] over the observed trace — the
        paper's Table 1 statistic.  Experts are range-partitioned; a ragged
        last node is zero-padded."""
        e_per_node = -(-self.num_experts // n_nodes)        # ceil
        hits = (self.exec_counts > 0)
        pad = n_nodes * e_per_node - self.num_experts
        if pad:
            hits = np.pad(hits, ((0, 0), (0, pad)))
        hits = hits.reshape(self.num_layers, n_nodes, e_per_node)
        return float(hits.sum(axis=2).mean())


def quota_topup(selected_per_node: list[list[int]],
                lru_order_per_node: list[list[int]]) -> list[list[int]]:
    """Paper §4.2 Router-Aided Dynamic Loading: every node tops its
    executed-expert set up to max(len(selected)) with its least-recently-
    used experts.  Returns the executed set per node (selection order,
    deduplicated, then the top-up in LRU order)."""
    quota = max(len(s) for s in selected_per_node)
    out = []
    for sel, lru in zip(selected_per_node, lru_order_per_node):
        execed = list(dict.fromkeys(sel))
        for e in lru:
            if len(execed) >= quota:
                break
            if e not in execed:
                execed.append(e)
        out.append(execed)
    return out


def simulate_expected_experts(num_experts: int, top_k: int, n_nodes: int,
                              n_tokens: int = 2048, n_layers: int = 8,
                              seed: int = 0, use_topup: bool = True) -> float:
    """Monte-Carlo E[#exec experts/node/layer] under uniform routing, with
    the L_R top-up (``use_topup``) or without: Table 1's 2.65 / 2.32 /
    1.57 trend.  The same seed draws the reference's choices."""
    rng = np.random.default_rng(seed)
    e_per_node = num_experts // n_nodes
    tracker = [LRUExpertTracker(n_layers, e_per_node) for _ in range(n_nodes)]
    total = 0.0
    count = 0
    for _ in range(n_tokens):
        for layer in range(n_layers):
            choice = rng.choice(num_experts, size=top_k, replace=False)
            per_node = [[int(e - n * e_per_node) for e in choice
                         if n * e_per_node <= e < (n + 1) * e_per_node]
                        for n in range(n_nodes)]
            if use_topup:
                execed = quota_topup(per_node, [t.lru_order(layer).tolist()
                                                for t in tracker])
            else:
                execed = per_node
            for n, ex in enumerate(execed):
                if ex:
                    tracker[n].observe(layer, ex)
                total += len(ex)
                count += 1
        for t in tracker:
            t.tick()
    return total / count
