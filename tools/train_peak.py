#!/usr/bin/env python3
"""Where a granite training step's backward peaks, by the code that
allocated each live block at the peak.

    python3 tools/train_peak.py [--top N]

Runs one step of ``chip_smoke.py``'s phase-8 granite training (its B, S,
depth and seed; bf16, remat, ``Model.loss(..., kernels=False)``) on the
card: the loss forward, then its backward under
``torch.cuda.memory._record_memory_history``.  Replaying the allocator's
trace finds the backward's peak of live bytes above its start; the blocks
live at that moment are summed by their innermost three frames in
``repro_torch`` (blank: blocks the autograd engine allocated with no
frame of the port, gradients among them).  Prints the card's name and
power limit, the peak and the top N groups as JSON lines.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_peak: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import optim
    from repro_torch.data.pipeline import Pipeline, PipelineConfig
    from repro_torch.models.model import build_model
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    arch, b, s, _, _ = cs.TRAIN_FULL[0]
    cfg = cs.full_config(arch, cs.TRAIN_LAYERS.get(arch))
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(cs.TRAIN_SEED))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in Pipeline(
        PipelineConfig(seq_len=s, global_batch=b, vocab_size=cfg.vocab_size,
                       seed=cs.TRAIN_SEED)).next_batch().items()}
    for p in optim.adamw.tree_leaves(params):
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch, kernels=False)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=200000,
                                            stacks="python")
    loss.backward()
    torch.cuda.synchronize()
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at = {}, 0, 0, -1
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > peak:
                peak, at = cur, i
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    live = {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    groups = collections.Counter()
    for ev in live.values():
        frames = [f for f in ev.get("frames", [])
                  if "repro_torch" in f["filename"]][:3]
        groups[" <- ".join(
            f"{f['filename'].split('repro_torch/')[-1]}:{f['line']}:"
            f"{f['name']}" for f in frames)] += ev["size"]
    print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers,
                      "dtype": cfg.dtype, "B": b, "S": s,
                      "allocated_at_backward_start": start,
                      "backward_peak_above_start": peak}), flush=True)
    for where, nbytes in groups.most_common(args.top):
        print(json.dumps({"bytes": nbytes, "allocated_by": where}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
