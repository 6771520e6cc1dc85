#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases on the kernels and port of one
source tree, so that a parent tree and a change can be timed in turns
(parent, change, change, parent) in one call on one card.

    python3 tools/smoke_ab.py [--src DIR] [--label NAME] [--only PHASE ...]
                              [--repeat N]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (this
checkout's by default); the phases, their cases, checks and bounds are this
checkout's ``chip_smoke.py``.  PHASE is ``paged`` (phase 3's paged-attention
cases and split sweep; the tree's wrapper must have ``num_splits``),
``quant`` (phase 3's quantized-FFN cases), ``flash`` (phase 3's
flash-attention cases), ``chaos`` (phase 4c, run
before any serve; the tree must have ``serving/chaos.py``), ``serve`` (phases 5, 6 and 5b:
the full-width serve, forward and quantized serve, each with its profile
window) or ``serve5`` (phase 5's serve alone, ``--repeat`` times on the
same weights, without the profile window: its decode rate is the reading)
or ``train`` (phase 8: the reduced archs trained on the card against the
CPU, then granite-moe-3b-a800m and qwen3-0.6b at full width) or ``ep``
(phase 9: the expert-parallel schedules over 2 and 4 rank processes)
or ``serve_mesh`` (phase 10: serving on a mesh of 2 and 4 rank processes;
phase 3's paged and FFN cases at its per-rank shapes run first) or
``train_mesh`` (phase 11: training on a (2, 2) mesh of rank processes;
phase 3's fp32 FFN and flash cases at its per-rank shapes run first) or
``families`` (slice 11's archs: phase 3's hd-256 and G=8 flash cases,
phase 4d's new runs, phase 12, then phase 8's recurrentgemma-2b and
mamba2-130m against the CPU and recurrentgemma-2b at full width) or
``modalities`` (slice 12's archs: phase 3's flash cases at qwen2-vl-7b's
and musicgen-large's heads, then phase 13) or ``families_mesh`` (phase
3's flash cases at phase 14's per-rank shapes, then phase 14: the four
other families on a (2, 2) mesh of rank processes) or ``analysis``
(phase 3's fp32 paged cases at the reduced qwen3-moe's programs' shapes,
its FFN and quantized-FFN cases at the reduced widths and the qwen3-0.6b
flash case at S=4096, then phase 15: the analysis rules on the
card and the dry-run against the allocator) or ``full_depth`` (phase
3's paged cases at phase 16's DBRX shape (four rows over 12 pages) and
qwen2-72b's heads and its quantized-FFN
cases at DBRX's widths, then phase 16: DBRX int4, deepseek-67b int8 and
qwen2-72b int8 loaded at full depth, quantized as drawn, and served at
four rows) or ``fp32_ffn`` (phase 3's fp32 FFN and quantized-FFN cases at
DBRX's widths, then phase 3b: fp32 DBRX at 2 layers through forward and
loss with the CUDA-core FFN) or ``train_step`` (granite's bf16 trainer
step at phase 8's shape, ``--repeat`` steps timed, then one profiled for
the dispatch gathers' backward share: no gate, so a parent tree runs it
too).  Prints the card's name and power limit, the build's ptxas lines
and every row the phases print, each tagged with the label; exits non-zero
if a phase fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--only", nargs="*", default=["paged", "quant"],
                    choices=["paged", "quant", "flash", "chaos", "serve",
                             "serve5", "train", "ep", "serve_mesh",
                             "train_mesh", "families", "modalities",
                             "families_mesh", "analysis",
                             "full_depth", "fp32_ffn", "train_step"])
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("smoke_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    cs.emit = lambda phase, **kw: print(json.dumps(
        {"label": args.label, "phase": phase, **kw}, default=float),
        flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, info = build.build()
    cs.emit("build", seconds=info["seconds"], ptxas=[
        line.strip() for rep in info["ptxas"].values()
        for line in rep.splitlines() if "registers" in line or "spill" in line])
    build.library()
    results = []
    if "paged" in args.only:
        cs.check_paged_attention(torch, results)
        cs.check_paged_sweep(torch)
    if "quant" in args.only:
        cs.check_moe_ffn_quant(torch, results)
    if "flash" in args.only:
        cs.check_flash_attention(torch, results)
    if "chaos" in args.only:
        cs.check_chaos(torch)
    if "serve" in args.only:
        _, params, _ = cs.check_serve(torch)
        cs.check_forward(torch, params)
        del params
        cs.check_serve_quant(torch)
    if "train" in args.only:
        cs.check_train(torch, {})
    if "ep" in args.only:
        cs.check_expert_parallel(torch, {})
    if "serve_mesh" in args.only:
        cs.GQA_HEADS = cs.GQA_HEADS[-3:]
        cs.PAGED_CASES = []
        cs.REDUCED_PAGED = []
        cs.FULL_DBRX_PAGED = []
        cs.check_paged_attention(torch, results)
        cs.FFN_CASES = []
        cs.MESH_FFN_CASES = cs.MESH_FFN_CASES[-3:]
        cs.check_moe_ffn(torch, results)
        cs.check_serve_mesh(torch, {})
    if "train_mesh" in args.only:
        cs.FFN_CASES = cs.FFN_CASES[-1:]
        cs.MESH_FFN_CASES = []
        cs.check_moe_ffn(torch, results)
        cs.FLASH_CASES = [c for c in cs.FLASH_CASES
                          if c == (2, 2048, 24, 8, 64, True, None)]
        cs.check_flash_attention(torch, results)
        cs.check_train_mesh(torch, {})
    if "families" in args.only:
        # slice 11's archs alone: phase 3's hd-256 and G=8 flash cases,
        # phase 4d's new runs, phase 8's two new reduced archs, phase 12
        cs.FLASH_CASES = [c for c in cs.FLASH_CASES if c[2] in (10, 64)]
        cs.check_flash_attention(torch, results)
        new = cs.LATE_DENSE_ARCHS + cs.FAMILY_ARCHS
        cases = cs.modes_cases
        cs.modes_cases = lambda: [c for c in cases() if c[0] in new]
        cs.check_reduced_modes(torch)
        cs.check_families(torch, {})
        cs.TRAIN_ARCHS = cs.FAMILY_ARCHS
        cs.check_train_reduced(torch)
        cs.check_train_full(torch, *cs.TRAIN_FULL[-1])
    if "modalities" in args.only:
        # slice 12's archs alone: phase 3's flash cases at their heads,
        # then phase 13
        cs.FLASH_CASES = [c for c in cs.FLASH_CASES
                          if c[2:4] in ((28, 4), (32, 32))]
        cs.check_flash_attention(torch, results)
        runs = {}
        cs.check_modalities(torch, runs)
        print(json.dumps(cs.kernels_line(results, runs, [
            e for e in cs.LINE if e[2] in runs])), flush=True)
    if "families_mesh" in args.only:
        # phase 14 alone: phase 3's flash cases at its per-rank shapes
        # (and the hd-256 G=5 case), then the phase
        cs.FLASH_CASES = [c for c in cs.FLASH_CASES
                          if c[:3] in ((1, 4096, 10), (1, 4096, 5),
                                       (1, 2048, 28), (1, 2048, 32))]
        cs.check_flash_attention(torch, results)
        runs = {}
        cs.check_families_mesh(torch, runs)
        print(json.dumps(cs.kernels_line(results, runs, [
            e for e in cs.LINE if e[2] in runs])), flush=True)
    if "analysis" in args.only:
        # phase 15 alone, with the phase 3 rows its kernels-line entries
        # read
        cs.PAGED_CASES = []
        cs.GQA_HEADS = []
        cs.FULL_DBRX_PAGED = []
        cs.check_paged_attention(torch, results)
        cs.FFN_CASES = [c for c in cs.FFN_CASES if c[0] == 4]
        cs.MESH_FFN_CASES = []
        cs.check_moe_ffn(torch, results)
        cs.QUANT_CASES = [c for c in cs.QUANT_CASES if c[0] == 4]
        cs.check_moe_ffn_quant(torch, results)
        cs.FLASH_CASES = [c for c in cs.FLASH_CASES
                          if c[:4] == (2, 4096, 16, 8)]
        cs.check_flash_attention(torch, results)
        runs = {}
        cs.check_analysis(torch, runs)
        print(json.dumps(cs.kernels_line(results, runs, [
            e for e in cs.LINE if e[2] in runs])), flush=True)
    if "full_depth" in args.only:
        # phase 16 alone, with the phase 3 rows its kernels-line entries
        # read: paged attention at DBRX's four rows (FULL_DBRX_PAGED) and
        # the G=8 heads, the int4 FFN at DBRX's widths
        cs.PAGED_CASES = []
        cs.REDUCED_PAGED = []
        cs.GQA_HEADS = [h for h in cs.GQA_HEADS if h == (64, 8, 128)]
        cs.check_paged_attention(torch, results)
        cs.QUANT_CASES = [c for c in cs.QUANT_CASES
                          if c[0] == 16 and c[4] == ("bfloat16",)]
        cs.check_moe_ffn_quant(torch, results)
        runs = {}
        cs.check_full_depth(torch, runs)
        print(json.dumps(cs.kernels_line(results, runs, [
            e for e in cs.LINE if e[2] in runs])), flush=True)
    if "fp32_ffn" in args.only:
        # phase 3's fp32 FFN cases (DBRX's widths and phase 11's C=4096)
        # and quantized-FFN cases at DBRX's widths, then phase 3b
        cs.FFN_CASES = [c for c in cs.FFN_CASES
                        if c[2] == 6144 or c[1] == 4096]
        cs.MESH_FFN_CASES = []
        cs.check_moe_ffn(torch, results, ("float32",))
        cs.QUANT_CASES = [c for c in cs.QUANT_CASES
                          if c[0] == 16 and c[4] == ("float32",)]
        cs.check_moe_ffn_quant(torch, results)
        runs = {}
        cs.check_fp32_dbrx(torch, runs)
        print(json.dumps(cs.kernels_line(results, runs, [
            e for e in cs.LINE if e[2] in runs])), flush=True)
    if "train_step" in args.only:
        out = cs.train_step_times(torch, args.repeat)
        del out["params"]
        cs.emit("train_step", **out)
    if "serve5" in args.only:
        from repro_torch.configs.base import get_config
        cs.profile_window = lambda *a, **kw: {"device_busy_share": None}
        _, params, _ = cs.check_serve(torch)
        for _ in range(args.repeat - 1):
            cs.serve_phase(torch, get_config(cs.ARCH), "serve",
                           ("moe_ffn", "paged_attention"),
                           time.perf_counter(), {}, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
