"""Router-aided dynamic loading (paper §4.2, L_R) — host-side half: a copy
of the JAX package's ``LRUExpertTracker``.

Per-layer last-used step and execution count per expert, the paper's LRU
structure.  The serving engine feeds it the device-captured routing of
every served step and reads the paper's E[#executed experts/node/layer]
statistic from it.
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
