"""Token data pipeline (the JAX package's ``data/pipeline.py``, in numpy):
synthetic and memmap sources, document packing into fixed-length rows.

Sources
  * ``SyntheticSource`` — deterministic pseudo-corpus (zipf-ish unigram
    over the vocab) from a seed, so everything runs offline;
  * ``MemmapSource``    — a flat .bin of uint16/uint32 token ids (the usual
    tokenized corpus on disk), read in windows.

``Pipeline`` packs documents into (global_batch, seq_len) rows of tokens
and next-token labels, EOS-separated.  The same seed gives the reference's
batches bit for bit.  ``shard_batch`` gives a rank of a mesh its rows of
a global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np



class SyntheticSource:
    """Deterministic document stream: doc lengths ~ U[32, 4 * mean_len),
    zipf-ish unigram token distribution; reproducible per seed."""

    def __init__(self, vocab_size: int, seed: int = 0, mean_len: int = 512):
        self.vocab = max(vocab_size, 4)
        self.rng = np.random.default_rng(seed)
        self.mean_len = mean_len
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def documents(self) -> Iterator[np.ndarray]:
        while True:
            n = int(self.rng.integers(32, 4 * self.mean_len))
            yield self.rng.choice(self.vocab, size=n, p=self.p).astype(np.int32)


class MemmapSource:
    """Flat binary token file. ``dtype`` uint16 for vocab < 65536, else
    uint32.  Without ``doc_sep`` the file is one stream of 2048-token
    documents."""

    def __init__(self, path: str, dtype=np.uint16, doc_sep: int | None = None):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.doc_sep = doc_sep

    def documents(self) -> Iterator[np.ndarray]:
        if self.doc_sep is None:
            step = 2048
            while True:
                for i in range(0, len(self.data) - step, step):
                    yield np.asarray(self.data[i:i + step], dtype=np.int32)
        else:
            bounds = np.flatnonzero(self.data == self.doc_sep)
            while True:
                start = 0
                for b in bounds:
                    if b > start:
                        yield np.asarray(self.data[start:b], dtype=np.int32)
                    start = b + 1


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    eos_id: int = 0
    seed: int = 0


class Pipeline:
    """Packs documents into (global_batch, seq_len) token/label rows."""

    def __init__(self, cfg: PipelineConfig, source=None):
        self.cfg = cfg
        self.source = source or SyntheticSource(cfg.vocab_size, cfg.seed)
        self._docs = self.source.documents()
        self._buf = np.zeros((0,), np.int32)

    def _fill(self, n: int) -> np.ndarray:
        parts = [self._buf]
        have = len(self._buf)
        while have < n:
            d = next(self._docs)
            parts.append(np.append(d, self.cfg.eos_id).astype(np.int32))
            have += len(d) + 1
        flat = np.concatenate(parts)
        self._buf = flat[n:]
        return flat[:n]

    def next_batch(self) -> dict:
        """{"tokens": (B, S) int32, "labels": (B, S) int32}: each row packs
        S + 1 tokens, and the labels are the next-token targets."""
        b, s = self.cfg.global_batch, self.cfg.seq_len
        rows = self._fill(b * (s + 1)).reshape(b, s + 1)
        return {"tokens": np.ascontiguousarray(rows[:, :-1]),
                "labels": np.ascontiguousarray(rows[:, 1:])}

    def __iter__(self):
        while True:
            yield self.next_batch()


def shard_batch(batch: dict, mesh, batch_axes=("pod", "data")) -> dict:
    """This rank's block of a global batch (numpy or tensors) under
    ``launch/sharding.batch_pspec``: the leading dimension split over the
    mesh's axes among ``batch_axes`` when they divide it, the whole batch
    otherwise (the reference's ``shard_batch`` places the same blocks).
    ``Model.loss`` and ``Model.forward`` on a mesh take the global batch
    and cut the same rows themselves (``expert_parallel.batch_shard``)."""
    axes = tuple(a for a in mesh.axis_names if a in batch_axes)
    n = 1
    for a in axes:
        n *= mesh.shape[a]

    def rows(v):
        b = v.shape[0]
        if b % n:
            return v
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
        return v[idx * (b // n):(idx + 1) * (b // n)]
    return {k: rows(v) for k, v in batch.items()}
