#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

It takes no arguments and runs every phase, in order (each prints its
findings on its own line; any failure exits non-zero before the final
line):

  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch and CUDA versions; TF32 off.
  2. build    — compile the kernels from ``src/repro_torch/kernels/csrc``
                with nvcc for sm_90a; print build seconds, ptxas usage and
                (where cuobjdump is present) each kernel's count of
                tensor-core instructions (HGMMA, HMMA) in its SASS; the
                bf16 kernels must hold them, the fp32 ones none.
  3. kernels  — each kernel against its plain PyTorch version at every
                path's shapes (qwen3-moe's, granite's and DBRX's), fp32
                (tol 2e-5) and bf16 (tol 3e-2; flash also within 1e-2 in
                RMS, FLASH_RMS_TOL), with kernel / plain times
                and the card's bound: paged attention over fp and int8
                pools (decode and prefill at the serve's lengths, windowed,
                a long-context decode to 4000 tokens, query groups of 3 and
                6 heads; NaN in every row's dead slots), the grouped FFN
                over bf16/fp32 (capacities 16, 40, 320, the reduced widths
                at 5 and 16, granite's 48 experts with 8 empty at 16, 32
                and 856, DBRX's widths at 16, 40 and 640, in fp32 too; a
                zero row of x, and a dead expert's empty slice, must give
                exact zeros), int8 and int4 weights (at the model's, the
                reduced and DBRX's widths, DBRX's in fp32 too, zero rows
                exact), full-sequence flash attention
                (causal, windowed, non-causal over a ragged S, one partial
                tile at S=37; hd 128 and 64; granite's and DBRX's heads;
                hd 160; qwen2-72b's G=8; recurrentgemma-2b's hd 256 with
                ten query heads on one kv head at window 2048;
                qwen2-vl-7b's G=7 at hd 128 and musicgen-large's MHA at hd
                64; beside each case the time of PyTorch's
                scaled_dot_product_attention).
  4. reduced  — the reduced qwen3-moe config served by the port on the card
                and on the CPU from the same weights: identical greedy
                tokens, fp and quantized (int8 weights + int8 KV, int4
                weights, int8 KV alone), each path's kernels launched on
                the card; then its full-sequence forward and loss on the
                card against the CPU's.  Then the same (fp, and int8
                weights + int8 KV) for granite and DBRX reduced with
                router-dead experts (6 live of 8) and padded vocab columns.
  4d. modes   — the reduced qwen3-0.6b and stablelm-12b (the dense
                family) and qwen3-moe through all three engine layouts:
                the unified step over the page pool and over the
                contiguous cache, and the two-program reference engine
                (batched and one-by-one padded prefill), fp32 and int8
                weights + int8 KV, on the card and on the CPU from the same
                weights: identical greedy tokens and counters; paged
                attention launched only on the paged path, the grouped FFN
                in the reference prefill of the MoE arch.  Then the same
                for the reduced qwen2-72b and deepseek-67b in the three
                layouts (paged, contiguous, reference), and for the reduced
                recurrentgemma-2b (its 64-slot attention ring: 72-token
                prompts roll into it and the decode wraps it; fp32 and int8
                weights + int8 KV) and mamba2-130m in the reference
                engine, the only one the reference gives them.
  4c. chaos   — the port's chaos matrix (every fault site, an overcommit
                preemption and restore) on the reduced qwen3-moe, on the
                card and on the CPU from the same weights, fp32 and int8
                weights + int8 KV: gates 1-4 on each device, the card's
                streams and counters equal the CPU's scenario by scenario.
  5. serve    — the full-width qwen3-moe-30b-a3b (depth cut to 12 of 48
                layers, QWEN_LAYERS, for the time limit; bf16, random
                weights from a seeded generator on the card) serves six
                requests sharing a system prompt through the paged engine;
                its weight bytes must equal the performance model's, and
                the keep-warm touch (standby) is timed against its bound.
  6. forward  — on phase 5's weights, before they are freed: the full-
                sequence forward and loss at B=2, S=2048 (12 flash and 12
                grouped-FFN launches each), with a profile window.
  5c. serve_resilience — on the same weights: overcommit on a 24-page
                pool with priorities, two sampled requests, a cancel, an
                expired deadline and 2 alloc + 3 dispatch + 3 NaN faults,
                every counter gated; a replay must repeat every stream;
                conservative admission on the same traffic prints its
                agreement with phase 5 and the overcommit run, and both
                again at capacity_factor 8 print theirs; each greedy
                stream of those two runs is held to the full-sequence
                forward of its own tokens (FORCED_SHARE_MAX).
  5d. serve_reference — on the same weights: the reference engine
                (padded batched prefill, then one-token decode) on six
                prompts of exactly prefill_len; the prefill launches the
                grouped FFN and no attention kernel; each stream is held
                to the forward of its own tokens (FORCED_SHARE_MAX).
  5b. serve_quant — the same model and traffic with int8 weights
                (each matrix quantized as it is drawn on the card) and an
                int8 KV pool, after the bf16 model is freed.
  granite     — granite-moe-3b-a800m at full width, depth cut to 16 of 32
                layers (GRANITE_LAYERS; bf16; 8 of 48 experts router-dead,
                a tied head over a vocab padded 49155 -> 49408): phase 5's
                serve, then the forward and loss at B=2, S=2048.
  dbrx        — DBRX at full width, depth cut to 8 of 40 layers (bf16,
                about 55 GB): phase 5's serve, the forward and loss at
                B=1, S=2048, then the same weights quantized to int8 on
                load with an int8 KV pool and served again.
  3b. dbrx_fp32 — DBRX at full width in fp32, 2 of 40 layers, B=1,
                S=2048: the forward and loss with the CUDA-core FFN (fp32
                weights) and the forward over int8 and int4 weights,
                each held to the same call with kernels=False on the card
                (loss to TM_KERNEL_LOSS_TOL, logits to DBRX_FP32_LOGIT_RMS
                in RMS).
  7. stablelm — stablelm-12b at full width, depth cut to 10 of 40 layers
                (STABLELM_LAYERS; bf16, hd 160, layernorm, an untied
                head): phase 5's paged serve, the reference engine as in
                5d, the forward and loss at B=2, S=2048 (10 launches of the
                flash
                kernel's hd-160 instantiation), then int8 weights + int8
                KV served.  Then qwen3-0.6b at full width (28 layers, a
                tied head at V 151936) serves once and runs its forward.
  8. train    — the trainer (``launch/train.py``), which reaches no
                kernel, as the reference's trains through no Pallas
                kernel: seven reduced archs (the five of phases 4-7,
                recurrentgemma-2b and mamba2-130m) take three steps on the
                card and on the CPU from the same weights and batches
                (fp32, remat on; losses within TRAIN_LOSS_TOL, params
                within lr and at most one element in TRAIN_PARAM_OFF_PER
                of a leaf, one at least, beyond TRAIN_PARAM_TOL, no
                launch, router-dead experts stay zero), each kernel
                wrapper refuses an input that requires grad; then
                granite-moe-3b-a800m (8 of 32 layers, bf16, B=4, S=2048:
                the chunked attention and CE, 12 steps) and qwen3-0.6b (28
                layers, 6 steps) and recurrentgemma-2b (12 of 26 layers,
                B=2, 6 steps) train at full width: finite losses that
                fall, the step-0 loss equal to the kernel path's, peak
                under 75 GB, granite's dead experts moved by decay alone,
                the checkpoint restored bit for bit; step time, train
                tokens/s, peak memory and a profile window over one step
                with the optimizer's share.  Then C8's gate: granite
                (bf16, 8 of 32 layers, B=4, S=2048) trained three steps
                twice from one seed must give bitwise equal losses and
                parameters, and one step under
                use_deterministic_algorithms(True, warn_only=True) prints
                the ops it warns about.
  9. expert_parallel — the paper's expert-parallel schedules
                (decentralized, centralized, a2a, a2a_pipelined) over 2,
                then 4, spawned rank processes sharing the one card (gloo
                through a file store; each collective's operand staged
                through pinned host memory), budget 180 s: the reduced
                qwen3-moe and granite (6 live experts of 8), every schedule
                and strategy at a prefill and a decode block, int8 and
                int4 expert shards, r = 2 at 4 ranks, each against the
                one-device moe_layer on the card (fp32, 1e-5, top_idx
                identical); granite at full width cut to 8 of 32 layers
                and DBRX to 4 of 40 through Model.forward on
                the mesh (B=1, S=2048, bf16, capacity factor E_pad / K),
                held to one-device forwards of the same seeded weights
                (layer-0 routing identical, greedy argmax on at least 99 %
                of positions, max |delta logit|); every rank's bytes equal
                to the performance model's prediction and its flash and
                grouped-FFN launches; and the paper's Table 3 / §5.2 split
                of DBRX's MoE layer (expert FFN ms, collective ms, bytes,
                peak memory, E[#experts per shard]).  Its times are ranks
                time-sharing one card over gloo, no interconnect's.
  10. serve_mesh — serving on a mesh of 2, then 4, spawned rank processes
                on the one card, budget 150 s: the serve-mode layout
                (``launch/sharding.py``: the embedding, attention heads,
                dense MLP and LM head tensor-parallel over "model", the
                experts under the schedules) through the paged engine.
                The reduced qwen3-moe (fp32, decentralized and a2a) streams
                as the one-device engine on the card; granite at full width
                cut to 8 of 32 layers (2 and 4 ranks, decentralized and
                a2a) and DBRX at
                full width cut to 4 of 40 layers (4 ranks, decentralized),
                bf16, phase 5's traffic at capacity factor 8: every rank's
                streams identical, each held to the one-device forward of
                its own tokens (FORCED_SHARE_MAX), the paged and grouped-FFN
                kernels launched on every rank at its local shapes, each
                rank's weight bytes its serve blocks' and its bytes by kind
                the performance model's; per rank tok/s, peak memory,
                collective ms by kind and E[#experts per shard].
  11. train_mesh — training on a (2, 2) mesh of 4 spawned rank processes
                on the one card, budget 150 s: the train layout
                (``launch/sharding.train_specs``: FSDP over "data", the
                experts' rows over "model"; each layer's weights gathered
                for that layer, inside its remat, the gradients
                reduce-scattered into the blocks).  Granite at full width
                cut to 4 of 32 layers (fp32, B=4, S=2048, capacity factor
                E_pad / K) takes 3 decentralized steps and 1 a2a step from
                the seeded weights on ``Pipeline`` batches: each loss
                within 2e-3 (rtol and atol, the reference's own check) of
                the one-device trainer's on the same weights and batches,
                every loss and norm finite, no kernel launched by the
                steps, each rank's resident params and moments exactly its
                train blocks' bytes; the mesh scoring loss
                (``Model.loss(..., kernels=True, mesh=)``) launches flash
                and the grouped FFN on every rank, within 1e-4 of the
                step-0 loss.  Per rank: step s, tok/s, peak and the
                collective host seconds by kind.
  12. families — the last two dense configs and the stateful families,
                one card, budget 150 s: qwen2-72b (8 of 80 layers) and
                deepseek-67b (8 of 95) at full width in bf16, each phase
                5's paged serve (weight bytes the performance model's) and
                the forward and loss at B=2, S=2048 (8 flash launches);
                recurrentgemma-2b at full width and depth (26 layers) in
                the reference engine on 4 prompts of exactly 2048 tokens
                (its 2048-slot attention ring kept whole by the prefill and
                wrapped by 16 decode tokens), each stream held to the
                forward of its own tokens (FORCED_SHARE_MAX), then the
                forward and loss at B=1, S=4096 (8 launches of the flash
                kernel's hd-256 instantiation, window 2048); mamba2-130m
                at full width and depth the same way, its forward and loss
                at B=2, S=2048 launching no kernel; its shares also
                printed against the forward padded to whole SSD chunks,
                and the same prompts served in fp32 held to the fp32
                forward (FP32_FORCED_SHARE_MAX).  The reference's
                performance model has no layer formula for the stateful
                families, so their weight bytes are held to the bytes of
                the parameter tree's leaves.
  13. modalities — the vlm and audio families, one card, budget 120 s:
                the reduced qwen2-vl-7b (M-RoPE, 8 patch embeddings) and
                musicgen-large (frame embeddings, sinusoidal positions) on
                the card against the CPU from the same fp32 weights
                (forward and loss within TOL, identical greedy tokens
                through prefill and decode_step, the prefill's and every
                decode step's logits within TOL of the CPU's step by
                step); then both at full width
                and depth in bf16 (28 and 48 layers), weights drawn on the
                card: the leaves' bytes exactly the performance model's,
                the forward and loss at B=2, S=2048 (28 / 48 flash
                launches each; qwen2-vl's 1024 patch embeddings on a 32 x
                32 M-RoPE grid before 1024 text tokens, its loss leaving
                the patches out; musicgen's frames the embedding rows of
                seeded codec tokens), with a profile window; and 4 prompts
                served greedily for 16 tokens through prefill and
                decode_step (the engine refuses these families, as the
                reference's fails on them), each stream held to the
                forward of its own inputs (FORCED_SHARE_MAX).
  14. families_mesh — the four other families on a (2, 2) mesh of four
                rank processes on the one card (one spawn), budget 150 s,
                at full width: recurrentgemma-2b (3 of 26 layers, B=1
                S=4096), qwen2-vl-7b (2 of 28, B=2 S=2048), musicgen-large
                (4 of 48) and mamba2-130m (12 of 24, fp32): each mesh
                forward held to the one-device forward of the same
                weights (computed while the ranks start up) by argmax
                agreement and |logit delta| (FM_LOGIT_DELTA_MAX), flash
                launched once per attention layer on every rank; then two
                prompts served for 8 tokens on each rank's serve blocks
                (vlm and audio through prefill and decode_step, hybrid and
                ssm through the engine; every decode context-parallel),
                the streams identical on every rank and each held to the
                one-device forward of its own inputs (FORCED_SHARE_MAX;
                mamba2 FP32_FORCED_SHARE_MAX).
  16. full_depth — the three configs whose quantized store fits one
                card, at full depth, budget 180 s: DBRX at int4 (40
                layers, 70.82 GB), deepseek-67b at int8 (95 layers, 70.35
                GB) and qwen2-72b at int8 (80 layers, 76.19 GB), each
                weight matrix rounded to bf16 and quantized as it is drawn
                (``Model.init_serving``): the load's seconds, its peak
                of requested bytes within ``sharding.draw_peak_bytes``
                (the allocated peak printed beside it; the store,
                one fp32 matrix and a column chunk), the weight bytes
                exactly the performance model's, ``fits_in_memory`` at
                the card's total beside it; phase 5's traffic through the
                paged engine at four rows (DBRX at capacity factor 8),
                its peak of requested bytes within
                ``sharding.serve_peak_bytes`` (serve_peak_bound: the store,
                the pool, a block's or the decode gather's transient, the
                step's activations); each greedy stream held, with the
                engine freed, to one batched forward of the streams' own
                tokens through the served store and through its
                dequantized tree layer by layer (FORCED_SHARE_MAX).
  Every paged serve through phase 5's ``serve_phase`` (phases 5, 5b, the
  granite, DBRX, stablelm-12b, qwen3-0.6b, qwen2-72b and deepseek-67b
  serves) holds its greedy streams to the forward of their own tokens
  (``held_serve``: an MoE arch's traffic served again at capacity factor
  8, where no token is dropped, phase 5's by phase 5c; int8 weights also
  against the forward of their dequantized tree), under FORCED_SHARE_MAX.
  Then the kernels line: one JSON object per ported kernel entry, and the
  last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, no tensor-core fp32
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 flash attention, beside TOL's elementwise rule: the RMS of the
# error at most this share of the RMS of the plain output.  A row that
# averages ~2000 random keys has outputs near 0.04, about TOL's bf16 bound
# itself; the two sides' bf16 roundings of P and O give ~3e-3 here, while
# a wrong P.V, mask or query group is of the order of the output
FLASH_RMS_TOL = 1e-2
ARCH = "qwen3_moe_30b_a3b"


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def check_path_kernels(launches: dict, want: tuple, what: str) -> None:
    """The run launched exactly the kernels of its path: each of ``want``
    at least once and no other (no fallback to another entry)."""
    check(all((n > 0) == (k in want) for k, n in launches.items()),
          f"{what}: the path's kernels are {want}, launched {launches}")


def serve_kernels(cfg, paged: bool = True) -> tuple:
    """The kernels a serve of ``cfg`` launches: the grouped FFN (quantized
    with quantized weights) on MoE archs, paged attention (its int8 entry
    over an int8 pool) on the paged path only."""
    out = ()
    if cfg.is_moe:
        out += ("moe_ffn_quant" if cfg.weight_quant != "none"
                else "moe_ffn",)
    if paged:
        out += ("paged_attention_int8" if cfg.kv_cache_dtype == "int8"
                else "paged_attention",)
    return out


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


TIME_LOOP_S = 0.5


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events).
    A sleep kernel holds the stream while the host enqueues the launches,
    so a kernel shorter than its wrapper's Python is timed on the device,
    not at the rate the host can launch it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0          # one call, host and device
    # a call of tens of ms needs few repeats: about TIME_LOOP_S of them
    iters = max(2, min(iters, int(TIME_LOOP_S / host_s)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most 2 GHz: the sleep outlasts twice the enqueue time (capped)
    torch.cuda._sleep(int(min(2 * iters * host_s, 0.5) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, tol: float, valid=None) -> float:
    """(max abs error, that error relative to max |want|) of ``got``
    against ``want`` over ``valid`` rows; fails beyond tol * (1 + |want|)
    elementwise or on an all-zero reference."""
    import torch
    g, w = got.float(), want.float()
    if valid is not None:
        g, w = g[valid], w[valid]
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    check(w.numel() > 0 and bool(w.abs().max() > 0),
          "the plain version's output is empty or all zero")
    err = (g - w).abs()
    check(bool((err <= tol * (1 + w.abs())).all()),
          f"kernel disagrees with its plain version: max abs err "
          f"{float(err.max()):.3g} > tol {tol}")
    return float(err.max()), float(err.max() / w.abs().max())


def rms_rel(got, want) -> float:
    """RMS of ``got - want`` over the RMS of ``want``."""
    g, w = got.float(), want.float()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_mma_counts(lib: Path):
    """Per kernel of the built library, its HGMMA (wgmma) and HMMA
    (mma.sync) instructions in the SASS, as cuobjdump lists them; None
    where the toolkit has no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                counts[fn][op] += f" {op}." in line
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    names = list(counts)
    if filt and names:
        names = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    def short(name: str) -> str:      # "tc::flash_attn_tc_kernel<128>"
        for junk in ("void ", "(anonymous namespace)::", "<unnamed>::",
                     "(int)"):
            name = name.replace(junk, "")
        end = name.find(">(")
        return name[:end + 1] if end >= 0 else name.split("(")[0]
    return {short(n): c for n, c in zip(names, counts.values())}


# kernels whose every instantiation must (or must not) hold tensor-core
# instructions: the bf16 ones on wgmma (HGMMA), the bf16 paged kernel on
# mma.sync (HMMA) or wgmma, the fp32 ones on the CUDA cores
SASS_RULES = {"moe_quant_gate_up_kernel": "HGMMA", "moe_quant_down_kernel":
              "HGMMA", "moe_gate_up_kernel": "HGMMA",
              "moe_down_kernel": "HGMMA", "flash_attn_tc_kernel": "HGMMA",
              "paged_attn_tc_kernel": "HMMA|HGMMA",
              "paged_attn_f32_kernel": "none",
              "moe_f32_kernel": "none"}


def ptxas_usage(reports: dict, mangled: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled name holds
    ``mangled``, read from the build's ``-Xptxas -v`` reports (each
    function's "Function properties" and "Used" lines follow its name)."""
    import re
    out, fn = {}, None
    for line in (ln for rep in reports.values() for ln in rep.splitlines()):
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
        elif fn is not None and mangled in fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out.update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m.group(1))
                out["line"] = line.strip()
    check("registers" in out, f"ptxas: no usage line for {mangled}")
    return out


def check_sass(counts) -> dict:
    """Hold each kernel of SASS_RULES to its rule; each must be found."""
    check(counts is not None, "no cuobjdump: tensor-core use unchecked")
    seen = {}
    for rule_name, rule in SASS_RULES.items():
        found = {n: c for n, c in counts.items() if f"{rule_name}<" in n}
        check(found, f"SASS: no instantiation of {rule_name}")
        for n, c in found.items():
            held = (c["HGMMA"] + c["HMMA"] == 0 if rule == "none"
                    else sum(c[op] for op in rule.split("|")) > 0)
            check(held, f"SASS: {n} has {c}, expected {rule}")
        seen[rule_name] = len(found)
    return seen


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, dtype, t: int, window, seed: int = 0, int8=False,
               lengths=(0, 17, 100, 250), seg=None, hd: int = 128,
               hq: int = 32, hkv: int = 4, ps: int = 16, pages=None):
    """Main-path attention shapes: B=4 (a row a length), Hq=32, Hkv=4,
    hd=128, ps=16, ragged lengths and seg_lens, block tables over a
    shuffled pool whose unreferenced pages hold NaN (an int8 pool: NaN
    scales); ``pages``: the tables' width (a serve's max_cache / ps),
    else one page past what the lengths need.  Returns the pools as
    (k, v) or, int8, (k, v, k_scale, v_scale)."""
    b = len(lengths)
    lengths = np.array(lengths, np.int32)
    if seg is None:
        seg = [1, 0, 1, 1] if t == 1 else [t, 0, 13, t]
    seg = np.array(seg, np.int32)
    need = -(-(int(lengths.max()) + t) // ps)
    check(pages is None or pages >= need,
          f"paged_case: {pages} pages hold no {need}")
    nb = need + 1 if pages is None else pages
    num_pages = b * nb + 8
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_pages)
    bt = perm[:b * nb].reshape(b, nb).astype(np.int32)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda shape: torch.randn(shape, generator=g, device=dev).to(dtype)
    q = mk((b, t, hq, hd))
    kp, vp = mk((num_pages, ps, hkv, hd)), mk((num_pages, ps, hkv, hd))
    unused = torch.as_tensor(perm[b * nb:], device=dev)
    if int8:
        from repro_torch.models.attention import quantize_kv
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        ks[unused] = float("nan")
        vs[unused] = float("nan")
        pools = (kp, vp, ks.contiguous(), vs.contiguous())
    else:
        kp[unused] = float("nan")
        vp[unused] = float("nan")
        pools = (kp, vp)
    to = lambda a: torch.as_tensor(a, device=dev)
    return q, pools, to(bt), to(lengths), to(seg), window


def paged_bound(q, kp, lengths, seg, window, dtype: str):
    """``kernels/cost.paged``'s work over this case's lengths: q and out
    once, each attended K/V slot once (an int8 slot: hd bytes plus its
    4-byte scale), the tables; QK and PV over the attended slots."""
    from repro_torch.kernels import cost
    hd = q.shape[-1]
    slot_bytes = hd + 4 if kp.element_size() == 1 else hd * q.element_size()
    return bound(*cost.paged(tuple(q.shape), kp.shape[2], slot_bytes,
                             q.element_size(), lengths, seg, window), dtype)


def dead_slots_nan(pools, bt, lengths, seg, ps: int):
    """NaN into the dead slots of each row's last live page (past its last
    position, lengths + seg - 1; an int8 pool: their scales).  Returns the
    pools the kernel reads and a copy with those slots zeroed for the plain
    version, which multiplies p = 0 by V as the reference does."""
    nan_pools, clean = [p.clone() for p in pools], [p.clone() for p in pools]
    idx = (2, 3) if len(pools) == 4 else (0, 1)
    for r in range(bt.shape[0]):
        last = int(lengths[r]) + int(seg[r]) - 1
        if last < 0 or last % ps == ps - 1:
            continue
        page = int(bt[r, last // ps])
        for i in idx:
            nan_pools[i][page, last % ps + 1:] = float("nan")
            clean[i][page, last % ps + 1:] = 0
    return nan_pools, clean


# (T, window, lengths, seg_lens, hd): decode and prefill/mixed at the
# serve's lengths, windowed, a long-context decode (about 14 MB of live
# K/V), the reduced configs' head dim (the bf16 kernel's 64-wide variant),
# head dims below their variant's width (96 and 160: Q, K and V padded
# with zero columns) and the widest the kernels take (fp32 pools then
# stage one step at a time)
PAGED_CASES = [(1, None, None, None, 128), (1, 64, None, None, 128),
               (32, None, None, None, 128), (32, 64, None, None, 128),
               (1, None, (0, 1000, 2000, 4000), (1, 1, 1, 1), 128),
               (32, None, None, None, 64), (1, None, None, None, 96),
               (32, 64, None, None, 160), (32, None, None, None, 256)]
# (Hq, Hkv, hd): granite's and DBRX's heads, groups of 3 and 6 query
# heads, which no 16-row tile holds whole, stablelm-12b's (G=4 at hd 160,
# padded to its variant's width) and qwen3-0.6b's (G=2), each at T 1 and
# 32
GQA_HEADS = [(24, 8, 64), (48, 8, 128), (32, 8, 160), (16, 8, 128),
             # qwen2-72b's and deepseek-67b's (G=8)
             (64, 8, 128),
             # phase 10's ranks: granite's heads on 2 and 4 ranks, DBRX's
             # on 4
             (12, 4, 64), (6, 2, 64), (12, 2, 128)]
# (T, lengths, seg_lens, page size): the reduced qwen3-moe's paged
# programs in phase 15 (B=2, Hq 4, Hkv 2, hd 64, fp32 only): its prefill
# chunks (T=4) and decode-only blocks (T=1) within the programs' 32-slot
# cache, at their page sizes 8 and 5
REDUCED_PAGED = [(4, (0, 20), (4, 3), 8), (1, (13, 27), (1, 1), 8),
                 (4, (0, 20), (4, 3), 5), (1, (13, 27), (1, 1), 5)]
# (T, lengths, seg_lens): DBRX's paged attention in phase 16 (bf16, Hq 48,
# Hkv 8, hd 128, G=6) at its four rows over the serve's 12-page tables
# (max_cache 192, pages of 16): a T=32 prefill block and a decode step
FULL_DBRX_PAGED = [(32, (17, 100, 0, 60), (32, 20, 32, 32)),
                   (1, (17, 100, 150, 60), (1, 1, 1, 1))]


def paged_run(torch, paged_attn, int8: bool, dtype, t: int, window,
              **kw):
    """One ``paged_case`` with NaN in each row's dead slots, its kernel
    entry held to the plain version (on the zeroed copy) and its padding
    rows to exact zeros.  Returns the errors, both calls and the case."""
    name = "paged_attention_int8" if int8 else "paged_attention"
    q, pools, bt, ln, sg, win = paged_case(torch, dtype, t, window,
                                           int8=int8, **kw)
    pools, clean = dead_slots_nan(pools, bt.cpu(), ln.cpu(), sg.cpu(),
                                  kw.get("ps", 16))
    scales = dict(zip(("k_scale", "v_scale"), clean[2:]))
    run_k = lambda: getattr(paged_attn, name)(q, *pools, bt, ln, sg,
                                              window=win)
    run_p = lambda: paged_attn.paged_attention_plain(
        q, *clean[:2], bt, ln, sg, window=win, **scales)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    tmask = torch.arange(t, device="cuda")[None, :] < sg[:, None].long()
    check(bool((got[~tmask] == 0).all()),
          f"{name}: padding rows are not exactly zero")
    err, rel = compare(got, want, TOL[str(dtype).split(".")[-1]], tmask)
    return err, rel, run_k, run_p, (q, clean[0], bt, ln, sg, win)


def check_paged_attention(torch, results):
    """Each paged entry against its plain version; every case also holds
    NaN in the dead slots of each row's last live page."""
    from repro_torch.kernels import paged_attn

    def one(int8, dtype, t, window, hd, hq, hkv, **kw):
        name = "paged_attention_int8" if int8 else "paged_attention"
        dname = str(dtype).split(".")[-1]
        err, rel, run_k, run_p, case = paged_run(
            torch, paged_attn, int8, dtype, t, window, hd=hd, hq=hq,
            hkv=hkv, **kw)
        q, kp, bt, ln, sg, win = case
        ms, plain_ms = time_ms(run_k, 50), time_ms(run_p, 10)
        bms, by = paged_bound(q, kp, ln.cpu().numpy(), sg.cpu().numpy(), win,
                              dname)
        row = dict(kernel=name, dtype=dname, T=t, window=win, hd=hd, Hq=hq,
                   Hkv=hkv, B=q.shape[0], ps=kp.shape[1],
                   lengths=[int(v) for v in ln.cpu()],
                   splits=paged_splits(paged_attn, q, kp, bt),
                   dead_slots_nan=True, max_abs_err=err, max_rel_err=rel,
                   kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by)
        emit("kernels", **row)
        results.append(row)

    cases = [(t, w, ln, sg, hd, 32, 4) for t, w, ln, sg, hd in PAGED_CASES]
    cases += [(t, None, None, None, hd, hq, hkv) for hq, hkv, hd in GQA_HEADS
              for t in (1, 32)]
    for int8 in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for t, window, lengths, seg, hd, hq, hkv in cases:
                if lengths is not None and dtype != torch.bfloat16:
                    continue
                kw = {} if lengths is None else dict(lengths=lengths, seg=seg)
                one(int8, dtype, t, window, hd, hq, hkv, **kw)
    for t, lengths, seg, ps in REDUCED_PAGED:
        one(False, torch.float32, t, None, 64, 4, 2, lengths=lengths,
            seg=seg, ps=ps)
    for t, lengths, seg in FULL_DBRX_PAGED:
        one(False, torch.bfloat16, t, None, 128, 48, 8, lengths=lengths,
            seg=seg, pages=SERVE_ENGINE["max_cache"]
            // SERVE_ENGINE["page_size"])


def check_paged_sweep(torch, draws: int = 32):
    """The kernel's own split plan: random lengths, seg_lens (some rows
    all padding) and windows at T 1 and 5, where the wrapper splits every
    tile's page walk, each entry and type against the plain version with
    NaN in the dead slots (``paged_attn.split_keys`` is the host's copy of
    the plan, which the CPU tests hold; this holds the device's)."""
    from repro_torch.kernels import paged_attn
    rng = np.random.default_rng(5)
    worst, splits = 0.0, set()
    for i in range(draws):
        t = (1, 5)[i % 2]
        int8 = bool(i // 2 % 2)
        dtype = (torch.bfloat16, torch.float32)[i // 4 % 2]
        lengths = rng.integers(0, 700, 4)
        seg = rng.integers(0, t + 1, 4)
        seg[i % 4] = t                    # a row with every token valid
        window = (None, 1, 16, 50, 300)[int(rng.integers(5))]
        err, _, _, _, case = paged_run(
            torch, paged_attn, int8, dtype, t, window, seed=100 + i,
            lengths=tuple(int(v) for v in lengths),
            seg=tuple(int(v) for v in seg))
        q, kp, bt = case[:3]
        s = paged_splits(paged_attn, q, kp, bt)
        check(s > 1, f"paged sweep draw {i}: the walk was not split")
        worst, splits = max(worst, err), splits | {s}
        del case
    emit("kernels", kernel="paged_attention_sweep", draws=draws,
         splits=sorted(splits), dead_slots_nan=True, max_abs_err=worst)


def paged_splits(paged_attn, q, kp, bt) -> int:
    """The split count the wrapper chose for this case (shapes only)."""
    import torch
    b, t, hq, _ = q.shape
    _, ps, hkv, _ = kp.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return paged_attn.num_splits(b, t * (hq // hkv), hkv, bt.shape[1], ps,
                                 sms)


# (E, C, D, F, dead experts): the model's widths at the serve's prefill
# blocks (16, 40) and the forward's B=2, S=2048 (320 = round_capacity(4096,
# 8, 128, 1.25)); the reduced config's widths at a ragged and a whole
# C-tile; granite's (8 of 48 experts router-dead: their slices all padding)
# at C 16, its serve's 32 and its forward's 856; DBRX's (fp32 too, whose
# tiled kernel takes any width) at C 16, its serve's 40 and its B=1
# forward's 640 (phase 3b's fp32 forward); and the model's widths at phase
# 5d's reference prefill (256: four 128-token prompts at capacity factor 8)
FFN_CASES = [(128, 16, 2048, 768, 0), (128, 40, 2048, 768, 0),
             (128, 320, 2048, 768, 0), (4, 5, 256, 512, 0),
             (4, 16, 256, 512, 0), (48, 16, 1536, 512, 8),
             (48, 32, 1536, 512, 8), (48, 856, 1536, 512, 8),
             (16, 16, 6144, 10752, 0), (16, 40, 6144, 10752, 0),
             (16, 640, 6144, 10752, 0), (128, 256, 2048, 768, 0),
             # phase 11's scoring loss on each rank of the (2, 2) mesh
             # (fp32, B=2 rows of 2048 at capacity factor E_pad / K):
             # granite's 24 local experts at C=4096, the second rank's
             # last 8 dead
             (24, 4096, 1536, 512, 8)]
# phase 9's per-rank shapes at B=1, S=2048 and capacity factor E_pad / K:
# DBRX's 8 and 4 local experts and granite's 24 and 12 (the last rank's 8
# router-dead) at C = 2048 (every schedule but a2a_pipelined, whose two
# chunks give C = 1024), bf16 only
MESH_FFN_CASES = [(8, 2048, 6144, 10752, 0), (4, 2048, 6144, 10752, 0),
                  (24, 2048, 1536, 512, 8), (12, 2048, 1536, 512, 8),
                  # phase 10's decentralized prefill steps (B=4 x 32
                  # tokens at capacity factor 8): granite's 24 / 12 local
                  # experts at C=176, DBRX's 4 at C=256
                  (24, 176, 1536, 512, 8), (12, 176, 1536, 512, 8),
                  (4, 256, 6144, 10752, 0)]


def check_moe_ffn(torch, results, dtypes=("float32", "bfloat16")):
    from repro_torch.kernels import cost, moe_gemm
    for dname in dtypes:
        dtype = getattr(torch, dname)
        for e, c, d, f, dead in FFN_CASES + MESH_FFN_CASES:
            if dtype == torch.float32 and (e, c, d, f,
                                           dead) in MESH_FFN_CASES:
                continue
            g = torch.Generator(device="cuda").manual_seed(c)
            mk = lambda shape, s: (torch.randn(shape, generator=g,
                                               device="cuda") * s).to(dtype)
            x = mk((e, c, d), 1.0)
            x[:, -1] = 0          # a padding row of every expert
            x[e - dead:] = 0      # router-dead experts: no token at all
            wg, wu = mk((e, d, f), d ** -0.5), mk((e, d, f), d ** -0.5)
            wd = mk((e, f, d), f ** -0.5)
            run_k = lambda: moe_gemm.moe_ffn_kernel(x, wg, wu, wd)
            run_p = lambda: moe_gemm.moe_ffn_plain(x, wg, wu, wd)
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            check(bool((got[:, -1] == 0).all()),
                  f"moe_ffn {dname} C={c}: a zero row of x gave a nonzero "
                  f"row of y")
            check(bool((got[e - dead:] == 0).all()),
                  f"moe_ffn {dname} E={e}: a dead expert's empty slice gave "
                  f"a nonzero output")
            err, rel = compare(got, want, TOL[dname])
            ms, plain_ms = time_ms(run_k, 10), time_ms(run_p, 5)
            bms, by = bound(*cost.moe_ffn(e, c, d, f, x.element_size()),
                            dname)
            row = dict(kernel="moe_ffn", dtype=dname, E=e, C=c, D=d, F=f,
                       dead_experts=dead, max_abs_err=err, max_rel_err=rel,
                       kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by)
            emit("kernels", **row)
            results.append(row)
            del x, wg, wu, wd, got, want


# (E, D, F, capacities, dtypes): the model's widths at the serve's prefill
# blocks, the reduced config's widths at a ragged and a whole C-tile, and
# DBRX's widths at C 16, its serve's 40 and phase 16's 256 (four rows'
# prefill blocks at capacity factor 8) in bf16, and at C 16, 40 and
# phase 3b's fp32 forward's 640 in fp32
QUANT_CASES = [(128, 2048, 768, (16, 40), ("float32", "bfloat16")),
               (4, 256, 512, (5, 16), ("float32", "bfloat16")),
               (16, 6144, 10752, (16, 40, 256), ("bfloat16",)),
               (16, 6144, 10752, (16, 40, 640), ("float32",)),
               # phase 9's quantized shards at 4 ranks: one local expert,
               # 256 slots of a (4, 16) block
               (1, 256, 512, (256,), ("float32",))]


def check_moe_ffn_quant(torch, results):
    """The quantized grouped FFN: weights drawn in fp32 on the card and
    quantized (block 128) as the engine does on load; a zero row of x must
    give an exactly zero row of y."""
    from repro_torch.core import quant
    from repro_torch.kernels import cost, moe_gemm
    for (e, d, f, caps, dtypes), (level, bits) in itertools.product(
            QUANT_CASES, (("int8", 8), ("int4", 4))):
        g = torch.Generator(device="cuda").manual_seed(bits + e)
        mk = lambda shape, s: torch.randn(shape, generator=g,
                                          device="cuda") * s
        ws = [quant.quantize(mk(shape, shape[1] ** -0.5), level, block=128)
              for shape in ((e, d, f), (e, d, f), (e, f, d))]
        wbytes = sum(w.nbytes() for w in ws)
        for dname in dtypes:
            dtype = getattr(torch, dname)
            for c in caps:
                x = mk((e, c, d), 1.0).to(dtype)
                x[:, -1] = 0          # a padding row of every expert
                run_k = lambda: moe_gemm.moe_ffn_kernel_quant(x, *ws)
                run_p = lambda: moe_gemm.moe_ffn_quant_plain(x, *ws)
                got, want = run_k(), run_p()
                torch.cuda.synchronize()
                check(bool((got[:, -1] == 0).all()),
                      f"moe_ffn_quant {level} {dname} C={c}: a zero row of "
                      f"x gave a nonzero row of y")
                err, rel = compare(got, want, TOL[dname])
                ms, plain_ms = time_ms(run_k, 10), time_ms(run_p, 5)
                bms, by = bound(*cost.moe_ffn_quant(
                    e, c, d, f, x.element_size(), wbytes), dname)
                row = dict(kernel="moe_ffn_quant", bits=bits, dtype=dname,
                           E=e, C=c, D=d, F=f, max_abs_err=err,
                           max_rel_err=rel, kernel_ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by)
                emit("kernels", **row)
                results.append(row)
                del x, got, want
        del ws


# (B, S, Hq, Hkv, hd, causal, window): the main path's widths at two
# lengths (1000 is ragged against the kernel's 64-row tiles), a window, a
# non-causal ragged case, one partial tile (S=37), and the reduced
# config's head dim
FLASH_CASES = [(2, 2048, 32, 4, 128, True, None),
               (2, 1000, 32, 4, 128, True, None),
               (2, 2048, 32, 4, 128, True, 256),
               (2, 1000, 32, 4, 128, True, 256),
               (2, 1000, 32, 4, 128, False, None),
               (2, 37, 32, 4, 128, True, None),
               (2, 1000, 4, 2, 64, True, None),
               (2, 1000, 4, 2, 64, True, 256),
               (2, 37, 4, 2, 64, True, None),
               # granite's heads (G=3) at its forward's B=2, DBRX's (G=6)
               # at its B=1: a 64-row tile ends mid-position
               (2, 2048, 24, 8, 64, True, None),
               (2, 37, 24, 8, 64, True, None),
               (1, 2048, 48, 8, 128, True, None),
               (1, 37, 48, 8, 128, True, None),
               # stablelm-12b's heads (G=4, hd 160: the kernels' third
               # instantiation) at its forward's B=2
               (2, 2048, 32, 8, 160, True, None),
               (2, 1000, 32, 8, 160, True, None),
               (2, 2048, 32, 8, 160, True, 256),
               (2, 37, 32, 8, 160, True, None),
               # qwen3-0.6b's heads (G=2) at its forward's B=2, and at
               # phase 15's dry-run forward pair, S=4096
               (2, 2048, 16, 8, 128, True, None),
               (2, 4096, 16, 8, 128, True, None),
               # granite's heads at phase 9's B=1 forward on every rank
               (1, 2048, 24, 8, 64, True, None),
               # qwen2-72b's and deepseek-67b's heads (G=8) at their
               # forwards' B=2
               (2, 2048, 64, 8, 128, True, None),
               # recurrentgemma-2b's local attention (hd 256, the fourth
               # instantiation; G=10 on one kv head, so a 64-row tile ends
               # inside a position's group): its forward's B=1 S=4096 and
               # B=2 S=2048 at window 2048, one partial tile, and
               # non-causal over a ragged S
               (1, 4096, 10, 1, 256, True, 2048),
               (2, 2048, 10, 1, 256, True, 2048),
               (1, 37, 10, 1, 256, True, None),
               (1, 1000, 10, 1, 256, False, None),
               # qwen2-vl-7b's heads (G=7 at hd 128: a 64-row tile holds
               # 9.14 positions, so a position's group straddles two
               # tiles) and musicgen-large's MHA (G=1 at hd 64), each at
               # its forward's B=2 S=2048 and one partial tile
               (2, 2048, 28, 4, 128, True, None),
               (2, 37, 28, 4, 128, True, None),
               (2, 2048, 32, 32, 64, True, None),
               (2, 37, 32, 32, 64, True, None),
               # phase 14's ranks: qwen2-vl-7b's and musicgen-large's
               # forwards at a row a rank; recurrentgemma-2b's heads on two
               # "model" ranks (G=5 on its one kv head) at its B=1 S=4096
               # window 2048
               (1, 2048, 28, 4, 128, True, None),
               (1, 2048, 32, 32, 64, True, None),
               (1, 4096, 5, 1, 256, True, 2048)]


def sdpa_call(torch, q, k, v, causal: bool, window):
    """PyTorch's one call for the same attention, on (B, H, S, hd) views
    (the yardstick only; the port never calls it): is_causal for the
    causal cases, no mask for the non-causal one, an explicit boolean mask
    for a window."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(enable_gqa=True)
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)
        mask = i[None, :] > i[:, None] - window
        if causal:
            mask &= i[None, :] <= i[:, None]
        kw["attn_mask"] = mask
    else:
        kw["is_causal"] = causal
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def check_flash_attention(torch, results):
    """The flash kernel against its dense plain version (bf16 also within
    FLASH_RMS_TOL in RMS).  k and v are views of one (B, S, 2 Hkv, hd)
    tensor, so the kernel reads them by strides."""
    from repro_torch.kernels import cost, flash_attn
    for b, s, hq, hkv, hd, causal, window in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            g = torch.Generator(device="cuda").manual_seed(s + hd)
            q = torch.randn((b, s, hq, hd), generator=g,
                            device="cuda").to(dtype)
            kv = torch.randn((b, s, 2 * hkv, hd), generator=g,
                             device="cuda").to(dtype)
            k, v = kv[:, :, :hkv], kv[:, :, hkv:]
            kw = dict(causal=causal, window=window)
            run_k = lambda: flash_attn.flash_attention(q, k, v, **kw)
            run_p = lambda: flash_attn.flash_attention_plain(q, k, v, **kw)
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            err, rel = compare(got, want, TOL[dname])
            rms = rms_rel(got, want)
            check(dname == "float32" or rms <= FLASH_RMS_TOL,
                  f"flash {dname} B={b} S={s} Hq={hq} hd={hd}: RMS error "
                  f"{rms:.3g} of the plain output's RMS > {FLASH_RMS_TOL}")
            ms, plain_ms = time_ms(run_k, 10), time_ms(run_p, 3)
            bms, by = bound(*cost.flash(b, s, hq, hkv, hd, q.element_size(),
                                        causal, window), dname)
            row = dict(kernel="flash_attention", dtype=dname, B=b, S=s,
                       Hq=hq, Hkv=hkv, hd=hd, causal=causal, window=window,
                       max_abs_err=err, max_rel_err=rel, rms_rel_err=rms,
                       kernel_ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by)
            # the library's time beside every case (its error gated in
            # bf16; in fp32 printed: its kernel may round otherwise)
            run_l = sdpa_call(torch, q, k, v, causal, window)
            lib = run_l().transpose(1, 2)
            lib_err = (compare(lib, want, TOL[dname])[0]
                       if dname == "bfloat16"
                       else float((lib.float() - want.float()).abs().max()))
            row.update(library_ms=time_ms(run_l, 10),
                       library_max_abs_err=lib_err)
            del lib
            emit("kernels", **row)
            results.append(row)
            del q, kv, k, v, got, want


# ---------------------------------------------------------------------------
# phases 4 to 6: the port's serving path and full-sequence forward
# ---------------------------------------------------------------------------

def traffic(vocab: int, n: int, sys_len: int, lo: int, hi: int, seed: int):
    """``n`` prompts of lo..hi tokens sharing a ``sys_len``-token system
    prompt; the last one resubmits the first, so the prefix cache hits
    into a partial tail page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, vocab, sys_len)
    prompts = [np.concatenate([sysp, rng.integers(
        0, vocab, int(rng.integers(lo, hi + 1)) - sys_len)])
        for _ in range(n - 1)]
    return prompts + [prompts[0].copy()]


def serve_requests(engine, prompts, new_tokens: int) -> list:
    """``prompts`` through ``engine`` to the end: the finished requests."""
    uids = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    engine.run_until_done()
    reqs = [engine._all[u] for u in uids]
    n_done = sum(r.done and r.status == "done" for r in reqs)
    check(n_done == len(reqs), f"only {n_done}/{len(reqs)} requests completed")
    return reqs


def serve(engine, prompts, new_tokens: int):
    return [list(r.generated) for r in serve_requests(engine, prompts,
                                                      new_tokens)]


# reduced configs: (weight_quant, kv_cache_dtype) -> the kernels its path
# must launch on the card (and the others it must not)
REDUCED = {("none", "native"): ("moe_ffn", "paged_attention"),
           ("int8", "int8"): ("moe_ffn_quant", "paged_attention_int8"),
           ("int4", "native"): ("moe_ffn_quant", "paged_attention"),
           ("none", "int8"): ("moe_ffn", "paged_attention_int8")}
# granite and DBRX: the fp path and int8 weights + int8 KV, on a reduced
# variant with what reduced() drops (router-dead experts, 6 live of 8;
# padded vocab columns, 500 of 512), the same on both devices
NEW_ARCHS = ("granite_moe_3b_a800m", "dbrx")
NEW_REDUCED = {k: REDUCED[k] for k in (("none", "native"), ("int8", "int8"))}
DEAD_AND_PADDED = dict(num_experts=6, num_experts_padded=8, vocab_size=500)
# DBRX at full width, depth cut to fit one card: 8 layers in bf16 are
# about 55 GB (its 40 would be about 264 GB)
DBRX_LAYERS = 8
# the script's 1200 s limit: qwen3-moe's full-width phases (5, 6, 5c, 5d,
# 5b) run 12 of its 48 layers, stablelm-12b's (phase 7) 10 of 40,
# granite's one-device serve and forward 16 of 32, its full-width
# training (phase 8), mesh forward (phase 9) and mesh serve (phase 10) 8
# of 32 (each halved when phase 11 came, phase 10's when phase 3b and 8's
# determinism gate came, with recurrentgemma-2b's training 12 of 26);
# the widths stay whole
QWEN_LAYERS = 12
STABLELM_LAYERS = 10
GRANITE_LAYERS = 16
GRANITE_TRAIN_LAYERS = 8
RGEMMA_TRAIN_LAYERS = 12       # of 26: four rec, rec, attn cycles


def full_config(arch: str = ARCH, layers: int | None = QWEN_LAYERS):
    """The full-width config of ``arch``, its depth cut to ``layers``."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=layers) if layers else cfg


def reduced_config(arch: str):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch).reduced()
    return cfg.replace(**DEAD_AND_PADDED) if arch in NEW_ARCHS else cfg


def check_reduced(torch, arch: str = ARCH, paths: dict = REDUCED):
    """Card vs CPU greedy tokens on the same raw weights and prompts, for
    each of ``paths`` (the fp path and quantized ones); each engine
    quantizes on load on its own device.  Returns each path's launch
    counts."""
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    base = reduced_config(arch).replace(capacity_factor=8.0)
    params = build_model(base, "cpu").init(torch.Generator().manual_seed(0))
    ecfg = EngineConfig(max_batch=2, max_cache=32, chunk_len=3, page_size=5)
    prompts = traffic(base.vocab_size, 5, 7, 9, 14, seed=1)
    out = {}
    for (wq, kv), want in paths.items():
        cfg = base.replace(weight_quant=wq, kv_cache_dtype=kv)
        cpu_eng = ServingEngine(cfg, ecfg, params=params, device="cpu")
        cpu = serve(cpu_eng, prompts, 5)
        ops.reset_launch_counts()
        eng = ServingEngine(cfg, ecfg, params=to_cuda(params), device="cuda")
        gpu = serve(eng, prompts, 5)
        launches = ops.launch_counts()
        check(gpu == cpu, f"{cfg.name} {wq}/{kv}: card tokens {gpu} != CPU "
              f"tokens {cpu}")
        check_path_kernels(launches, want, f"reduced {cfg.name} {wq}/{kv}")
        check(eng.stats["cow_copies"] > 0 and eng.stats["prefix_hits"] > 0,
              f"{cfg.name} {wq}/{kv}: no prefix hit or copy-on-write")
        # quantize-on-load on the card builds the CPU's store bit for bit
        same_store = all(
            torch.equal(a.data.cpu(), b.data) and torch.equal(
                a.scale.cpu(), b.scale)
            for a, b in zip(leaves(eng.params), leaves(cpu_eng.params))
            if isinstance(a, quant.QuantTensor))
        check(same_store, f"{cfg.name} {wq}/{kv}: the card's quantized store "
              f"differs from the CPU's")
        emit("reduced", arch=cfg.name, weight_quant=wq, kv_cache_dtype=kv,
             num_experts=cfg.num_experts,
             num_experts_padded=cfg.num_experts_padded,
             vocab_size=cfg.vocab_size, vocab_padded=cfg.vocab_padded,
             tokens_identical=True, requests=len(prompts), launches=launches,
             store_bit_identical_to_cpu=same_store,
             weight_bytes=check_weight_bytes(eng, cfg),
             cow_copies=eng.stats["cow_copies"],
             prefix_hits=eng.stats["prefix_hits"])
        out[(wq, kv)] = launches
    return out


def seq_batch(torch, vocab: int, b: int, s: int, seed: int, device):
    """Seeded (B, S) tokens and labels."""
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, vocab, (b, s)).astype(
        np.int32), device=device) for k in ("tokens", "labels")}


def check_reduced_forward(torch, arch: str = ARCH):
    """The reduced config's full-sequence forward and loss (fp32, B=2,
    S=96) on the card against the CPU's, on the same weights and tokens;
    each forward launches one flash and one grouped-FFN kernel per layer."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    cfg = reduced_config(arch)
    cpu_model, gpu_model = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    gparams = to_cuda(params)
    batch = seq_batch(torch, cfg.vocab_size, 2, 96, 2, "cpu")
    gbatch = {k: v.to("cuda") for k, v in batch.items()}
    tol = 2e-4
    with torch.no_grad():
        want_logits, want_aux = cpu_model.forward(params, batch)
        want_total, want_m = cpu_model.loss(params, batch)
        ops.reset_launch_counts()
        logits, aux = gpu_model.forward(gparams, gbatch)
        launches = ops.launch_counts()
        total, m = gpu_model.loss(gparams, gbatch)
    want = {"flash_attention": cfg.num_layers, "moe_ffn": cfg.num_layers}
    check(launches == {**dict.fromkeys(launches, 0), **want},
          f"reduced {cfg.name} forward launched {launches}, expected {want}")
    err, _ = compare(logits.cpu(), want_logits, tol)
    for name, got, ref in (("aux", aux, want_aux), ("total", total, want_total),
                           ("ce", m["ce"], want_m["ce"])):
        check(abs(float(got) - float(ref)) <= tol * (1 + abs(float(ref))),
              f"reduced {cfg.name} {name}: card {float(got)} != CPU "
              f"{float(ref)}")
    emit("reduced_forward", arch=cfg.name, B=2, S=96, dtype=cfg.dtype,
         logits_max_abs_err=err, loss=float(total), cpu_loss=float(want_total),
         aux=float(aux), cpu_aux=float(want_aux), tolerance=tol,
         launches=launches)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def check_weight_bytes(eng, cfg) -> int:
    """The engine's weight bytes equal the performance model's, exactly."""
    from repro_torch.core import perf_model
    got = eng.memory_stats()["weight_bytes"]
    want = perf_model.model_weight_bytes(cfg)
    check(got == want, f"{cfg.name}: memory_stats weight_bytes {got} != "
          f"perf_model.model_weight_bytes {want}")
    return got


def standby_stats(torch, eng) -> dict:
    """The keep-warm touch over every expert weight (payload and scales),
    timed on the device, against the least time its bytes take."""
    from repro_torch.core import quant
    if not eng.cfg.is_moe:
        check(float(eng.standby()) == 0.0, "standby of a dense model")
        return {}
    nbytes = quant.tree_bytes(eng.params["blocks"]["experts"])
    total = eng.standby()
    check(bool(torch.isfinite(total)), "standby sum is not finite")
    return {"standby_ms": time_ms(eng.standby, 3, warmup=1),
            "standby_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "standby_bytes": nbytes, "standby_sum": float(total)}


def free_device(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def forward_kernels(cfg) -> dict:
    """The kernels one full-sequence forward of ``cfg`` launches: flash
    once per attention layer (a hybrid stack's every third layer, none in
    an ssm stack), the grouped FFN once per MoE layer."""
    from repro_torch.models import transformer
    n_attn = {"hybrid": transformer.hybrid_pattern(cfg).count("attn"),
              "ssm": 0}.get(cfg.family, cfg.num_layers)
    want = {"flash_attention": n_attn} if n_attn else {}
    if cfg.is_moe:
        want["moe_ffn"] = cfg.num_layers
    return want


def check_forward(torch, params, cfg=None, b: int = 2, phase="forward",
                  s: int = 2048, batch=None):
    """Phase 6 (and the other archs' forwards): the full-width forward and
    loss on the serve's bf16 weights, B x S seeded tokens (or ``batch``,
    with labels: the vlm and audio families' inputs), under no_grad, with
    a profile window.  Returns the forward's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    cfg = cfg or full_config()
    t_phase = time.perf_counter()
    model = build_model(cfg, "cuda")
    if batch is None:
        batch = seq_batch(torch, cfg.vocab_size, b, s, 0, "cuda")
    want = forward_kernels(cfg)
    with torch.no_grad():
        model.forward(params, batch)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, aux = model.forward(params, batch)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(launches == {**dict.fromkeys(launches, 0), **want},
              f"{phase} launched {launches}, expected {want}")
        check(tuple(logits.shape) == (b, s, cfg.vocab_padded)
              and logits.dtype == torch.float32, "forward logits shape/dtype")
        check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux)),
              "forward logits or aux not finite")
        logit_std = float(logits[..., :cfg.vocab_size].std())
        fwd_peak = torch.cuda.max_memory_allocated()
        del logits
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        total, m = model.loss(params, batch)
        torch.cuda.synchronize()
        loss_s = time.perf_counter() - t0
        loss_launches = ops.launch_counts()
        check(loss_launches == launches,
              f"{phase} loss launched {loss_launches}, expected {want}")
        ce = float(m["ce"])
        check(np.isfinite(float(total)) and abs(ce - np.log(cfg.vocab_size))
              < 2.0, f"loss ce {ce} not near ln(vocab) "
              f"{np.log(cfg.vocab_size):.2f}")
        peak = torch.cuda.max_memory_allocated()
        prof = profile_window(torch, lambda: model.forward(params, batch),
                              phase)
    emit(phase, arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         B=b, S=s, forward_s=fwd_s, prompt_tok_per_s=b * s / fwd_s,
         loss_s=loss_s, loss_tok_per_s=b * s / loss_s, loss=float(total),
         ce=ce, aux=float(m["aux"]), ln_vocab=float(np.log(cfg.vocab_size)),
         logit_std=logit_std, forward_peak_allocated=fwd_peak,
         max_memory_allocated=peak, launches=launches,
         device_busy_share=prof["device_busy_share"],
         phase_s=time.perf_counter() - t_phase, card=card())
    return launches


# phase 3b: DBRX at its full widths in fp32 (the CUDA-core FFN, which
# takes any width), cut to DBRX_FP32_LAYERS of 40 layers, B=1, S=2048
# (C=640 at capacity factor 1.25): the forward and the loss with the
# kernels held to the same calls with kernels=False (attend_chunked and
# the expert FFN in torch ops) on the card, then the forward of the same
# weights quantized (int8, int4: the fp32 quantized FFN) held so too.
# The loss to TM_KERNEL_LOSS_TOL (fp32, relative); the logits by the RMS
# of their difference over the RMS of the kernels=False logits: two fp32
# sums in other orders move both by about 1e-6 relative
DBRX_FP32_LAYERS = 2
DBRX_FP32_LOGIT_RMS = 1e-4


def check_fp32_dbrx(torch, runs: dict) -> None:
    """Phase 3b (see DBRX_FP32_LAYERS).  Fills ``runs["dbrx_fp32_<level>"]``
    with each forward's launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.models.model import _lm_head, build_model
    t_phase = time.perf_counter()
    free_device(torch)
    cfg = get_config("dbrx").replace(num_layers=DBRX_FP32_LAYERS,
                                     dtype="float32", param_dtype="float32")
    params = build_model(cfg, "cuda").init(
        torch.Generator("cuda").manual_seed(0))
    batch = seq_batch(torch, cfg.vocab_size, 1, 2048, 0, "cuda")
    with torch.no_grad():
        for level in ("none", "int8", "int4"):
            qcfg = cfg.replace(weight_quant=level)
            p = quant.quantize_params(params, qcfg)
            model = build_model(qcfg, "cuda")
            want_k = dict(forward_kernels(qcfg))
            if level != "none":
                want_k["moe_ffn_quant"] = want_k.pop("moe_ffn")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, _ = model.forward(p, batch)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            check(launches == {**dict.fromkeys(launches, 0), **want_k},
                  f"dbrx fp32 {level} forward launched {launches}, "
                  f"expected {want_k}")
            want = _lm_head(qcfg, p, model._trunk(p, batch, False)[0])
            check(not any(ops.launch_counts()[k] - launches[k]
                          for k in launches),
                  "the kernels=False trunk launched a kernel")
            check(bool(torch.isfinite(logits).all()),
                  f"dbrx fp32 {level}: logits not finite")
            rms = rms_rel(logits, want)
            check(rms <= DBRX_FP32_LOGIT_RMS, f"dbrx fp32 {level}: logits "
                  f"{rms:.3g} (RMS) from the kernels=False forward")
            row = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
                       weight_quant=level, B=1, S=2048,
                       capacity_factor=cfg.capacity_factor,
                       forward_s=fwd_s, launches=_live(launches),
                       logits_rms_rel=rms,
                       logits_rms_bound=DBRX_FP32_LOGIT_RMS,
                       logits_max_abs=float((logits - want).abs().max()))
            del logits, want
            if level == "none":
                ops.reset_launch_counts()
                total = float(model.loss(p, batch)[0])
                loss_launches = ops.launch_counts()
                check(loss_launches == launches, f"dbrx fp32 loss launched "
                      f"{loss_launches}, expected {want_k}")
                plain = float(model.loss(p, batch, kernels=False)[0])
                rel = abs(total - plain) / abs(plain)
                check(rel <= TM_KERNEL_LOSS_TOL, f"dbrx fp32 loss {total} vs "
                      f"{plain} with kernels=False")
                row.update(loss=total, loss_kernels_false=plain,
                           loss_rel=rel, loss_rtol=TM_KERNEL_LOSS_TOL)
            runs[f"dbrx_fp32_{level}"] = launches
            del p
            emit("dbrx_fp32", **row, card=card())
    del params
    free_device(torch)
    emit("dbrx_fp32_phase", seconds=time.perf_counter() - t_phase)


def to_cuda(tree: dict) -> dict:
    return {k: to_cuda(v) if isinstance(v, dict) else v.to("cuda")
            for k, v in tree.items()}


def leaves(tree):
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def leaf_names(tree, pre: str = ""):
    """The paths of ``leaves(tree)``, in its order."""
    for k, v in tree.items():
        yield from (leaf_names(v, f"{pre}{k}/") if isinstance(v, dict)
                    else (pre + k,))


# a pool roomy enough that no prefix entry is evicted: the resubmitted
# prompt must find its original's partial tail page
SERVE_ENGINE = dict(max_batch=4, max_cache=192, chunk_len=32, page_size=16,
                    num_pages=96)


def serve_phase(torch, cfg, phase: str, want: tuple, t_phase: float,
                init: dict, params):
    """Phase 5's traffic through a new engine on ``params`` (six requests
    sharing a 40-token system prompt, the last resubmitting the first; 16
    new tokens), then the weight-byte identity, the keep-warm touch and a
    profile window of two more requests.  Returns the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    eng = ServingEngine(cfg, EngineConfig(**SERVE_ENGINE), params=params,
                        device="cuda")
    prompts = traffic(cfg.vocab_size, 6, 40, 48, 160, seed=0)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    reqs = serve_requests(eng, prompts, 16)
    wall = time.perf_counter() - t1
    launches = ops.launch_counts()
    out = [list(r.generated) for r in reqs]
    check(all(len(g) == 16 and max(g) < cfg.vocab_size and min(g) >= 0
              for g in out), "generated tokens out of range")
    check_path_kernels(launches, want, phase)
    ps = eng.paged_stats()
    check(ps["prefix_hits"] > 0, "no prefix-cache hit")
    check(ps["cow_copies"] > 0, "no copy-on-write of a shared tail page")
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"peak allocation {peak / 1e9:.2f} GB")
    t1 = time.perf_counter()
    held = held_serve(torch, cfg, params, prompts, reqs, phase)
    held["seconds"] = time.perf_counter() - t1
    tp, tt, ms = eng.throughput(), eng.ttft(), eng.memory_stats()
    row = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
               weight_quant=cfg.weight_quant,
               kv_cache_dtype=cfg.kv_cache_dtype, params=cfg.n_params(),
               wall_s=wall, requests=len(prompts),
               prompt_tokens=int(sum(len(p) for p in prompts)),
               prefill_tok_per_s=tp["prefill_tok_per_s"],
               decode_tok_per_s=tp["decode_tok_per_s"],
               total_tok_per_s=tp["total_tok_per_s"], ttft_p50_s=tt["p50"],
               ttft_p95_s=tt["p95"], memory_stats=ms,
               weight_bytes_equal_perf_model=check_weight_bytes(eng, cfg),
               **init, max_memory_allocated=peak,
               launches=launches, decode_steps=eng.stats["decode_steps"],
               prefix_hits=ps["prefix_hits"],
               prefix_hit_tokens=ps["prefix_hit_tokens"],
               cow_copies=ps["cow_copies"], held_to_forward=held,
               experts_per_node_2=eng.expected_experts_per_node(2),
               **standby_stats(torch, eng))
    extra = traffic(cfg.vocab_size, 2, 40, 48, 160, seed=3)
    prof = profile_window(torch, lambda: serve(eng, extra, 8), phase)
    emit(phase, **row, device_busy_share=prof["device_busy_share"],
         phase_s=time.perf_counter() - t_phase, card=card())
    return launches, out


def check_serve(torch, cfg=None, phase: str = "serve"):
    """Phase 5 (and the other archs' serves): the full-width model in bf16,
    random weights from a seeded generator on the card.  Returns the launch
    counts, the weights (the forward runs on them next) and the greedy
    streams."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = cfg or full_config()
    free_device(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = ServingEngine(cfg, EngineConfig(**SERVE_ENGINE), generator=gen,
                         device="cuda")
    params = warm.params
    torch.cuda.synchronize()
    init = dict(init_s=time.perf_counter() - t0,
                load_peak_allocated=torch.cuda.max_memory_allocated())
    # warm-up on its own engine (cuBLAS handles, allocator), then reset
    serve(warm, traffic(cfg.vocab_size, 2, 8, 24, 40, seed=7), 2)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, streams = serve_phase(torch, cfg, phase, serve_kernels(cfg),
                                    t0, init, params)
    return launches, params, streams


def check_serve_quant(torch, cfg=None, phase: str = "serve_quant"):
    """Phase 5b (and DBRX's quantized serve): the full-width model with
    int8 weights, each matrix quantized as the engine draws it on the
    card, and an int8 KV pool; the bf16 model is freed first.  Same traffic, prefix hit and copy-on-write as
    phase 5.  Returns the launch counts."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = cfg or full_config().replace(weight_quant="int8",
                                       kv_cache_dtype="int8")
    free_device(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = ServingEngine(cfg, EngineConfig(**SERVE_ENGINE), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    init = dict(init_and_quantize_s=time.perf_counter() - t0,
                load_peak_allocated=torch.cuda.max_memory_allocated())
    serve(warm, traffic(cfg.vocab_size, 2, 8, 24, 40, seed=7), 2)
    params = warm.params              # already quantized: passes through
    del warm
    return serve_phase(torch, cfg, phase, serve_kernels(cfg), t0, init,
                       params)[0]


def check_chaos(torch):
    """Phase 4c: the port's chaos matrix (``serving/chaos.run_matrix``) on
    the reduced qwen3-moe, on the card and on the CPU from the same
    weights, fp32 and with int8 weights + an int8 KV pool.  Each device
    must pass gates 1-4 in every scenario, the card's streams must equal
    the CPU's scenario by scenario, the card must launch its path's
    kernels, and the preempted request's restore must re-attend its own
    cached pages through the CUDA paged kernel."""
    from repro_torch.serving import chaos
    for (wq, kv), want in ((("none", "native"), REDUCED[("none", "native")]),
                           (("int8", "int8"), REDUCED[("int8", "int8")])):
        t0 = time.perf_counter()
        recs = {}
        for dev in ("cpu", "cuda"):
            recs[dev] = {}
            errors = chaos.run_matrix(ARCH, device=dev, weight_quant=wq,
                                      kv_cache_dtype=kv, verbose=False,
                                      record=recs[dev])
            check(not errors, f"chaos {wq}/{kv} on {dev}: {errors}")
        gpu, cpu = recs["cuda"], recs["cpu"]
        check(list(gpu) == list(cpu), f"chaos {wq}/{kv}: scenarios differ")
        for name in gpu:
            check(gpu[name]["tokens"] == cpu[name]["tokens"],
                  f"chaos {wq}/{kv} {name}: card tokens "
                  f"{gpu[name]['tokens']} != CPU {cpu[name]['tokens']}")
            check(gpu[name]["stats"] == cpu[name]["stats"],
                  f"chaos {wq}/{kv} {name}: card counters "
                  f"{gpu[name]['stats']} != CPU {cpu[name]['stats']}")
        launches = {k: sum(r["launches"][k] for r in gpu.values())
                    for k in gpu["baseline"]["launches"]}
        check_path_kernels(launches, want, f"chaos {wq}/{kv}")
        pre = gpu["paged/preempt"]
        check(pre["stats"]["restore_hit_tokens"] > 0
              and pre["launches"][want[1]] > 0,
              f"chaos {wq}/{kv}: no restore of cached pages through "
              f"{want[1]} ({pre})")
        emit("chaos", weight_quant=wq, kv_cache_dtype=kv,
             scenarios=list(gpu), card_equals_cpu=True, launches=launches,
             preempt=pre["stats"], seconds=time.perf_counter() - t0)


# phase 4d: each engine layout's knobs, and the engine they share (prompts
# at and below prefill_len, more requests than slots)
MODES = {"paged": dict(paged=True),
         "contiguous": dict(paged=False),
         "reference": dict(unified_step=False, paged=False),
         "reference_sequential": dict(unified_step=False, paged=False,
                                      batched_prefill=False)}
MODES_ENGINE = dict(max_batch=2, prefill_len=12, max_cache=24, chunk_len=3,
                    page_size=5)
DENSE_ARCHS = ("qwen3_0_6b", "stablelm_12b")
# slice 11's archs: the last two dense configs in the three layouts, and
# the stateful families in the reference engine (the only one the
# reference gives them); recurrentgemma's reduced window is 64, so its
# 72-token prompts roll into the 64-slot attention ring at prefill and
# the decode wraps it
LATE_DENSE_ARCHS = ("qwen2_72b", "deepseek_67b")
FAMILY_ARCHS = ("recurrentgemma_2b", "mamba2_130m")
RING_ENGINE = dict(max_batch=2, prefill_len=72, max_cache=96)
BOTH_QUANTS = (("none", "native"), ("int8", "int8"))


def modes_cases():
    """Phase 4d's runs: (arch, engine modes, (weight_quant,
    kv_cache_dtype) levels, engine knobs, prompt lengths)."""
    short = (12, 7, 12, 4, 10)
    cases = [(a, tuple(MODES), BOTH_QUANTS, MODES_ENGINE, short)
             for a in DENSE_ARCHS + (ARCH,)]
    cases += [(a, ("paged", "contiguous", "reference"), BOTH_QUANTS,
               MODES_ENGINE, short) for a in LATE_DENSE_ARCHS]
    ring = (72, 40, 72, 20, 66)
    cases.append((FAMILY_ARCHS[0], ("reference", "reference_sequential"),
                  BOTH_QUANTS, RING_ENGINE, ring))
    cases.append((FAMILY_ARCHS[1], ("reference", "reference_sequential"),
                  BOTH_QUANTS[:1], RING_ENGINE, ring))
    return cases


def check_reduced_modes(torch):
    """Phase 4d: the reduced archs through every engine layout the
    reference gives them (``modes_cases``), fp32 and, where attention
    exists, int8 weights + int8 KV, on the card and on the CPU from the
    same weights: identical greedy tokens and counters, and on the card
    exactly the path's kernels (paged attention only on the paged path;
    the grouped FFN wherever the MoE arch prefills, the reference
    engine's padded prefill included; the contiguous cache, the recurrent
    blocks and the ring attend in torch ops, as the reference does in
    jnp)."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    for arch, modes, quants, engine, lens in modes_cases():
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, 500, n) for n in lens]
        t0 = time.perf_counter()
        base = reduced_config(arch).replace(capacity_factor=8.0)
        params = build_model(base, "cpu").init(
            torch.Generator().manual_seed(0))
        gparams = to_cuda(params)
        rows = {}
        for wq, kv in quants:
            cfg = base.replace(weight_quant=wq, kv_cache_dtype=kv)
            for mode in modes:
                ecfg = EngineConfig(**MODES[mode], **engine)
                cpu_eng = ServingEngine(cfg, ecfg, params=params,
                                        device="cpu")
                cpu = serve(cpu_eng, prompts, 5)
                ops.reset_launch_counts()
                eng = ServingEngine(cfg, ecfg, params=gparams, device="cuda")
                gpu = serve(eng, prompts, 5)
                launches = ops.launch_counts()
                what = f"modes {cfg.name} {wq}/{kv} {mode}"
                check(gpu == cpu, f"{what}: card tokens {gpu} != CPU {cpu}")
                stats = ("prefill_tokens", "prefill_pad_tokens",
                         "decode_steps", "decode_tokens")
                check(all(eng.stats[k] == cpu_eng.stats[k] for k in stats),
                      f"{what}: card counters differ from the CPU's")
                check_path_kernels(launches, serve_kernels(
                    cfg, paged=mode == "paged"), what)
                check((eng.stats["prefill_pad_tokens"] > 0)
                      == mode.startswith("reference"),
                      f"{what}: prefill padding {eng.stats}")
                rows[f"{wq}/{kv} {mode}"] = dict(
                    launches={k: n for k, n in launches.items() if n},
                    prefill_pad_tokens=eng.stats["prefill_pad_tokens"],
                    decode_steps=eng.stats["decode_steps"])
        emit("reduced_modes", arch=base.name, requests=len(prompts),
             engine=engine, tokens_identical=True, runs=rows,
             seconds=time.perf_counter() - t0)


# phases 5d and 7: the reference engine at full width, on prompts of
# exactly prefill_len (shorter ones decode against their zero padding);
# its batched prefill's grouped FFN runs at C = round_capacity(4 x 128, 8,
# 128, 8.0) = 256 on qwen3-moe
REFERENCE_ENGINE = dict(max_batch=4, prefill_len=128, max_cache=192,
                        unified_step=False, paged=False)
# new tokens per request: two finish early, so the last two are admitted
# while rows decode (the reference engine's stall)
REFERENCE_NEW_TOKENS = (16, 10, 16, 10, 16, 16)


def check_serve_reference(torch, cfg, params, phase: str):
    """Phase 5d (and stablelm's): six requests sharing a system prompt,
    each prompt exactly prefill_len, through the two-program reference
    engine on ``params``: four admitted in one padded batched prefill, two
    more while two of those still decode (a stall).  The prefill launches
    the grouped FFN on MoE archs and no attention kernel runs; each greedy
    stream is held to the full-sequence forward of its own tokens
    (``forced_shares``: bf16 near-ties break with the batch mix).  As in
    phase 5c's gate, MoE
    capacity never binds (capacity_factor 8): a token dropped from the
    batched prefill's pooled capacity but kept by the forward would move
    the stream for a reason other than rounding.  Returns the launch
    counts."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    t_phase = time.perf_counter()
    cfg = cfg.replace(capacity_factor=8.0)
    eng = ServingEngine(cfg, EngineConfig(**REFERENCE_ENGINE), params=params,
                        device="cuda")
    p_len = REFERENCE_ENGINE["prefill_len"]
    serve(eng, traffic(cfg.vocab_size, 2, 8, p_len, p_len, seed=7), 2)
    eng = ServingEngine(cfg, EngineConfig(**REFERENCE_ENGINE), params=params,
                        device="cuda")
    prompts = traffic(cfg.vocab_size, 6, 40, p_len, p_len, seed=0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, REFERENCE_NEW_TOKENS)]
    eng.run_until_done()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    reqs = [eng._all[u] for u in uids]
    check(all(r.status == "done" and len(r.generated) == n
              for r, n in zip(reqs, REFERENCE_NEW_TOKENS)),
          f"{phase}: requests {[(r.status, len(r.generated)) for r in reqs]}")
    check_path_kernels(launches, serve_kernels(cfg, paged=False), phase)
    st = eng.stats
    check(st["prefill_pad_tokens"] == 0 and st["stall_s"] > 0,
          f"{phase}: padding {st['prefill_pad_tokens']}, stall "
          f"{st['stall_s']}")
    peak = torch.cuda.max_memory_allocated()
    shares = forced_shares(torch, cfg, params, reqs)
    check(max(shares) < FORCED_SHARE_MAX,
          f"{phase}: a greedy stream strays from the forward of its own "
          f"tokens (largest shares {shares})")
    tp, tt = eng.throughput(), eng.ttft()
    emit(phase, arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
         engine=REFERENCE_ENGINE, requests=len(reqs), wall_s=wall,
         prefill_tok_per_s=tp["prefill_tok_per_s"],
         decode_tok_per_s=tp["decode_tok_per_s"],
         total_tok_per_s=tp["total_tok_per_s"],
         decode_stall_s=tp["decode_stall_s"],
         prefill_padding_overhead=tp["prefill_padding_overhead"],
         ttft_p50_s=tt["p50"], ttft_p95_s=tt["p95"],
         decode_steps=st["decode_steps"], launches=launches,
         forced_shares=shares, forced_share_max=FORCED_SHARE_MAX,
         weight_bytes_equal_perf_model=check_weight_bytes(eng, cfg),
         kv_cache_bytes=eng.memory_stats()["kv_pool_bytes"],
         max_memory_allocated=peak, phase_s=time.perf_counter() - t_phase,
         card=card())
    return launches


def check_dense(torch, runs: dict) -> None:
    """Phase 7: stablelm-12b at full width, 10 of 40 layers (bf16 serve, the
    reference engine, forward and loss, then int8 weights + int8 KV), then
    qwen3-0.6b at full width (serve and forward).  Fills ``runs``."""
    from repro_torch.configs.base import get_config
    cfg = full_config("stablelm_12b", STABLELM_LAYERS)
    runs["stablelm_serve"], params, _ = check_serve(torch, cfg,
                                                    "stablelm_serve")
    runs["stablelm_serve_reference"] = check_serve_reference(
        torch, cfg, params, "stablelm_serve_reference")
    runs["stablelm_forward"] = check_forward(torch, params, cfg, 2,
                                             "stablelm_forward")
    del params
    runs["stablelm_serve_quant"] = check_serve_quant(
        torch, cfg.replace(weight_quant="int8", kv_cache_dtype="int8"),
        "stablelm_serve_quant")
    qwen = get_config("qwen3_0_6b")
    runs["qwen3_0_6b_serve"], params, _ = check_serve(torch, qwen,
                                                      "qwen3_0_6b_serve")
    runs["qwen3_0_6b_forward"] = check_forward(torch, params, qwen, 2,
                                               "qwen3_0_6b_forward")
    del params
    free_device(torch)


# ---------------------------------------------------------------------------
# phase 8: training (launch/train.py), which reaches no kernel
# ---------------------------------------------------------------------------

# the reduced archs trained on the card and on the CPU (fp32, remat on)
TRAIN_ARCHS = ("qwen3_moe_30b_a3b", "granite_moe_3b_a800m", "dbrx",
               "qwen3_0_6b", "stablelm_12b", "recurrentgemma_2b",
               "mamba2_130m")
TRAIN_REDUCED = dict(lr=1e-3, total_steps=3, warmup_steps=1)
# card vs CPU after three steps: losses (and norms, rates) to 1e-4
# relative; each param leaf with all elements within lr and at most one
# in TRAIN_PARAM_OFF_PER beyond 1e-6, at least one element on a leaf of
# fewer: Adam moves a weight by lr x m/sqrt(v), and its first step by
# lr x sign(g), so where a gradient sits within rounding of zero the two
# sides may differ by a step.  Two right fp32 trainers that round in
# another order differ so: three steps of the reduced recurrentgemma-2b in
# the port and in the JAX package, both on the CPU, leave one element of a
# 256-element norm 1.5e-5 apart
# (tests/test_torch_families.py::test_three_train_steps_match_reference)
TRAIN_LOSS_TOL, TRAIN_PARAM_TOL, TRAIN_PARAM_OFF_PER = 1e-4, 1e-6, 1000
# full width: (arch, B, S, steps, lr); granite fits one card with its
# optimizer (bf16 params 7.8 GB, gradients 7.8 GB, fp32 moments 31.2 GB)
TRAIN_FULL = (("granite_moe_3b_a800m", 4, 2048, 12, 1e-3),
              ("qwen3_0_6b", 4, 2048, 6, 1e-3),
              ("recurrentgemma_2b", 2, 2048, 6, 1e-3))
TRAIN_LAYERS = {"granite_moe_3b_a800m": GRANITE_TRAIN_LAYERS,
                "recurrentgemma_2b": RGEMMA_TRAIN_LAYERS}
TRAIN_SEED = 0
# the trainer's step-0 loss (attend_chunked, the expert FFN in torch ops)
# against the kernel path's (flash, the grouped-FFN kernel) on the same
# bf16 params and batch, relative
TRAIN_KERNEL_LOSS_TOL = 1e-2
TRAIN_PEAK_BYTES = 75e9


def check_train_reduced(torch) -> None:
    """Three ``make_train_step`` steps of each reduced arch (fp32, remat on;
    granite and DBRX with router-dead experts, zero as the prestacking
    converter pads them) on the card and on the CPU from the same weights
    and ``Pipeline`` batches; no kernel launched; then each kernel wrapper
    refuses an input that requires grad."""
    from repro_torch import optim
    from repro_torch.data.pipeline import Pipeline, PipelineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    ocfg = optim.OptimizerConfig(**TRAIN_REDUCED)
    for arch in TRAIN_ARCHS:
        cfg = reduced_config(arch).replace(remat=True)
        cpu_model = build_model(cfg, "cpu")
        params = cpu_model.init(torch.Generator().manual_seed(0))
        if cfg.is_moe:
            for w in params["blocks"]["experts"].values():
                w[:, cfg.num_experts:] = 0
        gparams = to_cuda(params)
        steps = {"cpu": make_train_step(cpu_model, ocfg),
                 "cuda": make_train_step(build_model(cfg, "cuda"), ocfg)}
        states = {"cpu": optim.init(params), "cuda": optim.init(gparams)}
        trees = {"cpu": params, "cuda": gparams}
        pipe = Pipeline(PipelineConfig(seq_len=64, global_batch=2,
                                       vocab_size=cfg.vocab_size, seed=1))
        ops.reset_launch_counts()
        losses = []
        for _ in range(3):
            np_batch = pipe.next_batch()
            m = {}
            for dev in ("cpu", "cuda"):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in np_batch.items()}
                trees[dev], states[dev], m[dev] = steps[dev](
                    trees[dev], states[dev], batch)
            for key in ("loss", "ce", "aux", "grad_norm", "lr"):
                got, want = float(m["cuda"][key]), float(m["cpu"][key])
                check(abs(got - want) <= TRAIN_LOSS_TOL * (1 + abs(want)),
                      f"train {cfg.name} {key}: card {got} != CPU {want}")
            losses.append((float(m["cuda"]["loss"]), float(m["cpu"]["loss"])))
        launches = ops.launch_counts()
        check(not any(launches.values()),
              f"train {cfg.name}: the training step launched {launches}")
        worst_err, worst_share, off, bad = 0.0, 1.0, {}, False
        for name, a, b in zip(leaf_names(trees["cpu"]), leaves(trees["cuda"]),
                              leaves(trees["cpu"])):
            err = (a.cpu() - b).abs()
            n_off = int((err > TRAIN_PARAM_TOL).sum())
            worst_err = max(worst_err, float(err.max()))
            worst_share = min(worst_share, 1 - n_off / err.numel())
            if n_off:
                off[name] = (float(err.max()), n_off, err.numel())
            bad |= (float(err.max()) > ocfg.lr or
                    n_off > max(1, err.numel() // TRAIN_PARAM_OFF_PER))
        check(not bad,
              f"train {cfg.name}: params after 3 steps differ by "
              f"{worst_err} (lr {ocfg.lr}); leaves with elements beyond "
              f"{TRAIN_PARAM_TOL} (max err, elements off, size): {off}")
        dead_zero = None
        if cfg.num_experts_padded > cfg.num_experts:
            dead_zero = all(
                not bool(t["blocks"]["experts"][w][:, cfg.num_experts:].any())
                for t in trees.values() for w in ("w_gate", "w_up", "w_down"))
            check(dead_zero, f"train {cfg.name}: a router-dead expert moved")
        emit("train_reduced", arch=cfg.name, steps=3, B=2, S=64,
             dtype=cfg.dtype, remat=cfg.remat, losses_card_cpu=losses,
             params_max_abs_err=worst_err, params_share_within=worst_share,
             params_leaves_off=off, dead_experts_zero=dead_zero, launches=launches)
    refused = {}
    q = torch.zeros(1, 64, 2, 64, device="cuda", requires_grad=True)
    x = torch.zeros(1, 16, 256, device="cuda", requires_grad=True)
    w = torch.zeros(1, 256, 512, device="cuda")
    for name, call in (("flash_attention", lambda: ops.flash_attention(q, q, q)),
                       ("moe_ffn", lambda: ops.moe_ffn(
                           x, w, w, w.transpose(1, 2).contiguous()))):
        try:
            call()
        except NotImplementedError as e:
            refused[name] = "kernels=False" in str(e)
    check(refused == {"flash_attention": True, "moe_ffn": True}
          and not any(ops.launch_counts().values()),
          f"kernel wrappers under autograd: {refused}")
    emit("train_grad_refused", refused=refused)


def check_train_full(torch, arch: str, b: int, s: int, steps: int,
                     lr: float) -> dict:
    """``train()`` at full width (bf16, remat on; at S=2048 the
    path is ``attend_chunked`` and the chunked CE): every loss and norm
    finite, the loss falls, no kernel launched, the peak under
    TRAIN_PEAK_BYTES, the step-0 loss equal to the kernel path's on the
    same params and batch, the router-dead experts' slices changed by
    weight decay alone (bit for bit against a replay of the optimizer with
    zero gradients), and save/restore of the trained tree bit-exact
    without ml_dtypes.  Then a step's time split and a profile window.
    Returns the training run's launch counts (all zero)."""
    import tempfile
    from repro_torch import optim
    from repro_torch.ckpt import io as ckpt_io
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import Pipeline, PipelineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    cfg = full_config(arch, TRAIN_LAYERS.get(arch))
    check(cfg.remat, f"{arch}: the full config trains with remat")
    model = build_model(cfg, "cuda")
    pipe_cfg = PipelineConfig(seq_len=s, global_batch=b,
                              vocab_size=cfg.vocab_size, seed=TRAIN_SEED)
    np_batch = Pipeline(pipe_cfg).next_batch()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in np_batch.items()}
    # the same params train() draws: the kernel path's loss on them
    params = model.init(torch.Generator("cuda").manual_seed(TRAIN_SEED))
    dead = cfg.num_experts_padded > cfg.num_experts
    dead0 = ({w: params["blocks"]["experts"][w][:, cfg.num_experts:].clone()
              for w in ("w_gate", "w_up", "w_down")} if dead else None)
    ops.reset_launch_counts()
    with torch.no_grad():
        kernel_loss = float(model.loss(params, batch)[0])
    kernel_launches = ops.launch_counts()
    want = forward_kernels(cfg)
    check(kernel_launches == {**dict.fromkeys(kernel_launches, 0), **want},
          f"{arch} kernel-path loss launched {kernel_launches}")
    del params
    free_device(torch)

    ckpt_dir = ROOT / "build" / "train_ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as tmp:
        path = str(Path(tmp) / f"{arch}.npz")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, history = train(cfg, steps=steps, global_batch=b, seq_len=s,
                                lr=lr, log_every=1, ckpt_path=path,
                                seed=TRAIN_SEED, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in history]
        gnorms = [h["grad_norm"] for h in history]
        check(not any(launches.values()), f"{arch} train launched {launches}")
        check(len(history) == steps and all(np.isfinite(losses + gnorms)),
              f"{arch} train: non-finite loss or norm {losses} {gnorms}")
        check(losses[-1] < losses[0], f"{arch} train: the loss did not fall "
              f"{losses}")
        check(abs(losses[0] - kernel_loss)
              <= TRAIN_KERNEL_LOSS_TOL * abs(kernel_loss),
              f"{arch} step-0 loss {losses[0]} != kernel path {kernel_loss}")
        check(peak < TRAIN_PEAK_BYTES, f"{arch} train peak {peak} bytes")
        dead_ok = None
        if dead:
            # zero gradients: the optimizer alone, from the same values
            ocfg = optim.OptimizerConfig(lr=lr, total_steps=steps,
                                         warmup_steps=max(steps // 20, 5))
            state = optim.init(dead0)
            for _ in range(steps):
                _, state, _ = optim.update(
                    ocfg, {w: torch.zeros_like(v) for w, v in dead0.items()},
                    state, dead0)
            dead_ok = all(torch.equal(
                params["blocks"]["experts"][w][:, cfg.num_experts:], v)
                for w, v in dead0.items())
            check(dead_ok, f"{arch}: a router-dead expert's slice moved by "
                  f"more than weight decay")
            del dead0, state
        t0 = time.perf_counter()
        restored, step = ckpt_io.restore(path, "cuda")
        restore_s = time.perf_counter() - t0
        ckpt_bytes = Path(path).stat().st_size
    got, want = (ckpt_io.flatten_tree(t) for t in (restored, params))
    same = step == steps and sorted(got) == sorted(want) and all(
        got[k].dtype == v.dtype and torch.equal(got[k], v)
        for k, v in want.items())
    check(same, f"{arch}: the restored checkpoint differs from the trained "
          f"params")
    check("ml_dtypes" not in sys.modules, "the checkpoint path imported "
          "ml_dtypes")
    del restored
    free_device(torch)

    # one more step, timed in halves through the step's "optimizer" range
    ocfg = optim.OptimizerConfig(lr=lr, total_steps=steps,
                                 warmup_steps=max(steps // 20, 5))
    opt_state = optim.init(params)
    step_fn = make_train_step(model, ocfg)
    step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    prof = profile_window(torch, lambda: step_fn(params, opt_state, batch),
                          f"{arch}_train", ranges=("optimizer",))
    opt_ms = prof["ranges"]["optimizer"]["device_ms"]
    step_s = [h1["wall_s"] - h0["wall_s"]
              for h0, h1 in zip(history, history[1:])]
    med = float(np.median(step_s))
    emit(f"{arch}_train", arch=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, B=b, S=s, steps=steps, lr=lr, remat=cfg.remat,
         losses=losses, grad_norms=gnorms, kernel_path_loss=kernel_loss,
         step0_vs_kernel_rel=abs(losses[0] - kernel_loss) / abs(kernel_loss),
         step_s=step_s, median_step_s=med, train_tok_per_s=b * s / med,
         train_s=train_s, max_memory_allocated=peak, launches=launches,
         dead_experts_decay_only=dead_ok, ckpt_bytes=ckpt_bytes,
         ckpt_bit_exact=same, restore_s=restore_s,
         optimizer_device_ms=opt_ms,
         optimizer_share_of_device=(opt_ms / prof["device_busy_ms"]
                                    if prof["device_busy_ms"] else None),
         device_busy_share=prof["device_busy_share"],
         phase_s=time.perf_counter() - t_phase, card=card())
    del params, opt_state
    free_device(torch)
    return launches


# C8's gate: granite at phase 8's width, depth, batch and length (bf16),
# TRAIN_DET_STEPS trainer steps twice from one seed must give bitwise
# equal losses and parameters; the autograd nodes whose backward is the
# dispatch plan's two gathers (the parent's ``index_select``, adding with
# atomics; the repair's gathers), whose device time ``train_step_times``
# reports as the step's share
TRAIN_DET_STEPS = 3
DISPATCH_BACKWARD = ("IndexSelectBackward", "_DispatchRowsBackward",
                     "_CombineRowsBackward")


def train_step_times(torch, steps: int, profile: bool = True) -> dict:
    """Granite (TRAIN_FULL[0]: B, S, lr; GRANITE_TRAIN_LAYERS layers,
    bf16) drawn from TRAIN_SEED and trained ``steps`` ``make_train_step``
    steps on ``Pipeline`` batches, each step timed (host clock around a
    synchronized step), then with ``profile`` one more under
    torch.profiler: the device time of the dispatch gathers' backward
    (DISPATCH_BACKWARD) and its share of the step's device time.  Returns
    the losses and params (as a flat list) of the timed steps, the times
    and the share."""
    from repro_torch import optim
    from repro_torch.data.pipeline import Pipeline, PipelineConfig
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    arch, b, s, _, lr = TRAIN_FULL[0]
    cfg = full_config(arch, TRAIN_LAYERS.get(arch))
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(TRAIN_SEED))
    opt = optim.init(params)
    step = make_train_step(model, optim.OptimizerConfig(
        lr=lr, total_steps=steps + 1, warmup_steps=1))
    pipe = Pipeline(PipelineConfig(seq_len=s, global_batch=b,
                                   vocab_size=cfg.vocab_size,
                                   seed=TRAIN_SEED))
    batch = lambda: {k: torch.as_tensor(v, device="cuda")
                     for k, v in pipe.next_batch().items()}
    losses, times = [], []
    for _ in range(steps):
        x = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    # the parameters after the timed steps (the profiled one moves them)
    flat = [t.detach().clone() for t in optim.adamw.tree_leaves(params)]
    busy = gathers = 0.0
    if profile:
        x = batch()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(params, opt, x)
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        busy = sum(e.self_device_time_total for e in avgs
                   if e.device_type == DeviceType.CUDA) / 1e3
        gathers = sum(e.device_time_total for e in avgs
                      if e.device_type == DeviceType.CPU
                      and "evaluate_function" in e.key
                      and any(n in e.key for n in DISPATCH_BACKWARD)) / 1e3
    del params, opt
    free_device(torch)
    return dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, B=b,
                S=s, losses=losses, step_s=times, params=flat,
                profiled_step_device_ms=busy, dispatch_backward_ms=gathers,
                dispatch_backward_share=gathers / busy if busy else None)


def check_train_deterministic(torch) -> None:
    """C8's gate: two ``train_step_times`` runs of TRAIN_DET_STEPS steps
    give bitwise equal losses and parameters.  Then one step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the ops
    it warns about (no deterministic CUDA implementation) are printed."""
    import warnings
    t0 = time.perf_counter()
    runs = [train_step_times(torch, TRAIN_DET_STEPS, profile=False)
            for _ in range(2)]
    same_loss = runs[0]["losses"] == runs[1]["losses"]
    same_params = all(torch.equal(a, b) for a, b in
                      zip(runs[0]["params"], runs[1]["params"]))
    check(same_loss and same_params, f"granite bf16 training is not "
          f"reproducible: losses {runs[0]['losses']} / {runs[1]['losses']}, "
          f"params equal {same_params}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            train_step_times(torch, 1, profile=False)
        finally:
            torch.use_deterministic_algorithms(False)
    warned = sorted({str(w.message).split(" does not have")[0][:160]
                     for w in caught if "determinis" in str(w.message)})
    for r in runs:
        del r["params"]
    emit("train_deterministic", runs=runs, bitwise_equal_losses=same_loss,
         bitwise_equal_params=same_params, nondeterministic_ops=warned,
         seconds=time.perf_counter() - t0, card=card())


def check_train(torch, runs: dict) -> None:
    """Phase 8: the reduced archs trained on the card against the CPU,
    then granite-moe-3b-a800m and qwen3-0.6b trained at full width and
    depth, then granite's determinism gate.  Fills ``runs``."""
    t0 = time.perf_counter()
    check_train_reduced(torch)
    for arch, b, s, steps, lr in TRAIN_FULL:
        runs[f"{arch}_train"] = check_train_full(torch, arch, b, s, steps, lr)
    check_train_deterministic(torch)
    emit("train_phase", seconds=time.perf_counter() - t0)


# phase 5c: the resilient serve.  Phase 5's six prompts take these
# priorities; the pool is small enough that overcommit must preempt and
# restore; two more requests sample, one is cancelled in flight and one
# expires in the queue; the plan injects 2 alloc, 3 dispatch and 3 NaN
# faults (each NaN fault poisons one row that the step schedules)
RESILIENCE_PRIORITIES = [0, 0, 0, 5, 0, 5]
RESILIENCE_ENGINE = dict(max_batch=4, max_cache=192, chunk_len=32,
                         page_size=16, num_pages=24, sample_seed=7)
RESILIENCE_FAULTS = [(1, "alloc", ()), (2, "alloc", ()),
                     (4, "dispatch", ()), (9, "dispatch", ()),
                     (21, "dispatch", ()), (6, "nan", (0,)),
                     (13, "nan", (1,)), (17, "nan", (2,))]


def resilience_serve(torch, cfg, params, *, overcommit: bool = True,
                     faults: bool = True, steps: int | None = None,
                     device: str = "cuda") -> dict:
    """One run of phase 5c's traffic on a new engine: the six prompts at
    their priorities and, with ``faults``, the fault plan, the two sampled
    requests, the one cancelled once it decodes and the one that expires.
    ``steps`` stops after that many engine steps instead (a profile
    window).  ``device`` is the card, or the CPU where a test holds the
    phase's checks to the plain versions at reduced widths.  Returns the
    engine, the plan and every request by role."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.faults import Fault, FaultPlan
    plan = (FaultPlan([Fault(st, site, rows=rows)
                       for st, site, rows in RESILIENCE_FAULTS])
            if faults else None)
    eng = ServingEngine(cfg, EngineConfig(**RESILIENCE_ENGINE,
                                          overcommit=overcommit),
                        params=params, device=device, fault_plan=plan)
    prompts = traffic(cfg.vocab_size, 6, 40, 48, 160, seed=0)
    roles = {"greedy": [eng.submit(p, 16, priority=pr) for p, pr in
                        zip(prompts, RESILIENCE_PRIORITIES)]}
    if faults:
        more = traffic(cfg.vocab_size, 5, 40, 48, 160, seed=11)
        roles["sampled"] = [eng.submit(p, 16, temperature=0.8, top_k=40)
                            for p in more[:2]]
        roles["cancelled"] = [eng.submit(more[2], 16)]
        roles["expired"] = [eng.submit(more[3], 16, deadline_ms=0)]
    if steps is not None:
        for _ in range(steps):
            eng.step()
        eng.flush()
        return {"eng": eng}
    if faults:
        victim = eng._all[roles["cancelled"][0]]
        for _ in range(10_000):
            eng.step()
            slot = next((i for i, r in enumerate(eng.slots) if r is victim),
                        None)
            if (slot is not None
                    and eng.prefill_pos[slot] >= len(eng.slot_ctx[slot])):
                break
        check(victim.status == "running" and eng.cancel(victim.uid),
              f"serve_resilience: the cancel target was {victim.status!r}, "
              f"not in flight")
    eng.run_until_done()
    reqs = {role: [eng._all[u] for u in uids] for role, uids in roles.items()}
    return {"eng": eng, "plan": plan, "reqs": reqs}


def forced_shares(torch, cfg, params, reqs, pad_to: int = 1,
                  batch: int = 1) -> list:
    """Each greedy stream held to the full-sequence forward of its own
    tokens: at every generated position, how far the emitted token's
    logit sits below the forward's largest, as a share of that largest
    logit's distance from the mean (0: the forward's argmax; a token
    picked at random sits near 1).  A near-tie that the serve's rounding
    broke the other way costs a few hundredths; a restore that attended
    to the wrong pages emits tokens the forward ranks far lower.  The
    forward takes ``batch`` requests at a time, each row its own tokens
    padded with token 0 to the longest and then to a multiple of
    ``pad_to`` (the model is causal: the padding changes no earlier
    logit).  One request a forward by default: padding rows of token 0
    route alike and can crowd an expert past its capacity where the
    capacity factor is below E / K (qwen3-moe's 8 against 16), which
    would move a real token's routing.  A batch of every request serves
    where no token can be dropped, and dequantizes a quantized store once
    rather than once a request.  Returns each request's largest share."""
    from repro_torch.models.model import build_model
    model = build_model(cfg, params["embed"].device)
    out = []
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        seqs = [np.concatenate([r.prompt, np.asarray(r.generated[:-1],
                                                     np.int32)])
                for r in group]
        width = -(-max(map(len, seqs)) // pad_to) * pad_to
        toks = np.zeros((len(seqs), width), np.int32)
        for j, seq in enumerate(seqs):
            toks[j, :len(seq)] = seq
        with torch.no_grad():
            logits, _ = model.forward(params, {"tokens": torch.as_tensor(
                toks, device=model.device)})
            out += [_share(torch, cfg, logits[j], r)
                    for j, r in enumerate(group)]
    return out


def _share(torch, cfg, logits, r) -> float:
    """The largest share (``forced_shares``) of request ``r``'s generated
    tokens under ``logits`` (S, V_pad), the forward of its own tokens."""
    seq_len = len(r.prompt) + len(r.generated) - 1
    lg = logits[len(r.prompt) - 1:seq_len, :cfg.vocab_size]
    gen = torch.as_tensor(r.generated, device=lg.device).long()
    top = lg.max(-1).values
    share = (top - lg.gather(1, gen[:, None])[:, 0]) / (top - lg.mean(-1))
    return float(share.max())


# the largest share (``forced_shares``) a greedy stream of phase 5c's
# capacity-8 runs, and of every serve through ``serve_phase`` (bf16, and
# int8 weights with an int8 KV cache), may reach
FORCED_SHARE_MAX = 0.25


class LayerDequant:
    """A layer-stacked QuantTensor that dequantizes one layer when the
    stack indexes it (``transformer._layer``): the forward of a tree of
    these sees the dequantized tree's values layer by layer, with one
    dense layer resident at a time.  A layer's stack is dequantized a
    matrix and a column block at a time into its dense tensor
    (``quant.dequantize_into``: the same values), so the fp32 transient
    is one block's, not the layer's (8.4 GB for a DBRX expert leaf)."""

    def __init__(self, qt):
        self.qt = qt

    def __getitem__(self, layer):
        import torch
        from repro_torch.core import quant
        qt = self.qt[layer]
        out = torch.empty(qt.shape, dtype=qt.dtype, device=qt.data.device)
        quant.dequantize_into(out, qt)
        return out


def dequantized(torch, params: dict) -> tuple:
    """(the fake-quant reference of ``params``: every QuantTensor dense in
    its own dtype, how it was built).  ``quant.dequantize_tree`` where the
    dense tree fits beside the quantized one with 8 GB to spare; else the
    blocks as ``LayerDequant`` stacks (the values are the same)."""
    from repro_torch.core import quant
    dense = sum(math.prod(t.shape) * t.dtype.itemsize
                for t in leaves(params) if isinstance(t, quant.QuantTensor))
    free, _ = torch.cuda.mem_get_info()
    if dense + 8e9 < free:
        return quant.dequantize_tree(params), "dequantize_tree"

    def wrap(tree):
        return {k: wrap(v) if isinstance(v, dict)
                else LayerDequant(v) if isinstance(v, quant.QuantTensor)
                else v for k, v in tree.items()}

    def dense(v):
        """A top-level QuantTensor (the LM head) dense in its own dtype,
        filled a column block at a time: no fp32 copy of the whole."""
        if not isinstance(v, quant.QuantTensor):
            return v
        out = torch.empty(v.shape, dtype=v.dtype, device=v.data.device)
        quant.dequantize_into(out, v)
        return out
    top = {k: dense(v) for k, v in params.items() if k != "blocks"}
    return dict(top, blocks=wrap(params["blocks"])), "layer_by_layer"


# serves whose capacity-8 rerun phase 5c makes: it serves phase 5's
# prompts on phase 5's weights at capacity factor 8 under both admissions
# and holds every greedy stream to its forward
HELD_IN_5C = ("serve",)


def held_serve(torch, cfg, params, prompts, reqs, phase: str) -> dict:
    """``serve_phase``'s streams held to the forward of their own tokens
    (``held_shares``).  Where the MoE capacity can bind, a serve drops
    other tokens than any forward does, so the streams held are those of
    the same traffic served again on the same weights at capacity factor
    8 (a new engine; phase 5c's setting), and the phase's own streams are
    counted against them; phase 5's are held in 5c (HELD_IN_5C)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    if not cfg.is_moe:
        return held_shares(torch, cfg, params, reqs, phase)
    if phase in HELD_IN_5C:
        return {"held_in": "serve_resilience", "capacity_factor": 8.0}
    wide = cfg.replace(capacity_factor=8.0)
    eng = ServingEngine(wide, EngineConfig(**SERVE_ENGINE), params=params,
                        device="cuda")
    wide_reqs = serve_requests(eng, prompts, 16)
    del eng
    out = held_shares(torch, wide, params, wide_reqs, phase)
    out["capacity_factor"] = 8.0
    out["streams_equal_to_the_phase"] = sum(
        list(a.generated) == list(b.generated)
        for a, b in zip(reqs, wide_reqs))
    return out


def held_shares(torch, cfg, params, reqs, phase: str) -> dict:
    """A paged serve's greedy streams held to the forward of their own
    tokens (``forced_shares``), the forward at capacity factor 8 (it drops
    no token), under FORCED_SHARE_MAX: a quantized serve to the forward
    of the weights it was served with and to the forward of their
    dequantized tree (the reference's fake-quant gate; the forward has no
    KV cache, so an int8 cache's rounding shows in the shares).  Returns
    the shares by reference."""
    ref = cfg.replace(capacity_factor=8.0)
    out = {"served": forced_shares(torch, ref, params, reqs)}
    if cfg.weight_quant != "none":
        dense, how = dequantized(torch, params)
        out["dequantized"] = forced_shares(
            torch, ref.replace(weight_quant="none"), dense, reqs)
        out["dequantized_by"] = how
        del dense
        torch.cuda.empty_cache()
    out["bound"] = FORCED_SHARE_MAX
    worst = max(max(v) for k, v in out.items()
                if k in ("served", "dequantized"))
    check(worst <= FORCED_SHARE_MAX, f"{phase}: a greedy stream strays from "
          f"the forward of its own tokens (shares {out})")
    return out


def check_serve_resilience(torch, params, uncontended):
    """Phase 5c: the resilient serve at full width on phase 5's weights
    (after phase 6's forward, before they are freed): overcommit with
    preemption and prefix-cache restore, priorities, sampling, a cancel, a
    deadline and injected faults, each gated; then a replay of the same
    traffic, plan and sample_seed (every stream, sampled ones included,
    must repeat); then conservative admission on the same pool, traffic
    and plan, whose greedy streams are printed against phase 5's and the
    overcommit run's; then a profile window.  Returns the first run's
    launch counts."""
    from repro_torch.kernels import ops
    cfg = full_config()
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = resilience_serve(torch, cfg, params)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    eng, plan, reqs = run["eng"], run["plan"], run["reqs"]
    check_path_kernels(launches, ("moe_ffn", "paged_attention"),
                       "serve_resilience")
    for role, rs in reqs.items():
        status = {"cancelled": "cancelled", "expired": "expired"}.get(role,
                                                                       "done")
        check(all(r.status == status for r in rs),
              f"serve_resilience {role}: statuses "
              f"{[r.status for r in rs]}, expected {status!r}")
    for r in reqs["greedy"] + reqs["sampled"]:
        check(len(r.generated) == 16 and all(
            0 <= t < cfg.vocab_size for t in r.generated),
            f"serve_resilience: request {r.uid} generated {r.generated}")
    check(reqs["expired"][0].generated == [],
          "serve_resilience: the expired request generated tokens")
    st = eng.resilience_stats()
    n_nan = sum(1 for f in RESILIENCE_FAULTS if f[1] == "nan")
    check(st["preemptions"] >= 1 and st["restores"] >= 1
          and st["restore_hit_tokens"] > 0,
          f"serve_resilience: no preempt/restore cycle with a prefix hit "
          f"({st})")
    check(st["alloc_stalls"] == 2 and st["dispatch_failures"] == 3
          and st["nan_quarantines"] == n_nan and st["failed"] == 0,
          f"serve_resilience: counters {st} disagree with the plan")
    check(plan.all_fired(), f"serve_resilience: unfired {plan.unfired()}")
    eng.prefix.clear()
    check(eng.allocator.fully_free,
          f"serve_resilience: {eng.allocator.pages_in_use} pages leaked")
    eng.allocator.check_consistent()
    tp, tt = eng.throughput(), eng.ttft()
    streams = lambda rn: {role: [list(r.generated) for r in rs]
                          for role, rs in rn["reqs"].items()}
    first = streams(run)
    check(streams(resilience_serve(torch, cfg, params)) == first,
          "serve_resilience: the replay's streams differ from the first run")
    # conservative admission on the same pool, traffic and plan: no row
    # is ever preempted, so its agreement with phase 5 shows what the
    # batch mix alone moves, and its agreement with the overcommit run
    # what preemption and restore add
    cons = resilience_serve(torch, cfg, params, overcommit=False)
    conservative = cons["eng"].resilience_stats()
    check(conservative["preemptions"] == 0,
          f"serve_resilience: conservative admission preempted "
          f"({conservative})")
    cons_greedy = streams(cons)["greedy"]
    agree = lambda a, b: f"{sum(x == y for x, y in zip(a, b))}/{len(a)}"
    preempted = [r.preemptions > 0 for r in reqs["greedy"]]
    pick = lambda xs, want: [x for x, p in zip(xs, preempted) if p == want]
    # both admissions again with capacity that never binds (the chaos
    # matrix's capacity_factor 8): what still differs is restore and the
    # bf16 rounding of a different batch mix, no longer dropped tokens
    wide = cfg.replace(capacity_factor=8.0)
    wide_runs = [resilience_serve(torch, wide, params, overcommit=oc)
                 for oc in (True, False)]
    wide_oc, wide_cons = (streams(r)["greedy"] for r in wide_runs)
    wide_pre = [r.preemptions > 0 for r in wide_runs[0]["reqs"]["greedy"]]
    # the streams that differ are held to the forward of their own tokens
    shares = [forced_shares(torch, wide, params, r["reqs"]["greedy"])
              for r in wide_runs]
    check(max(map(max, shares)) < FORCED_SHARE_MAX,
          f"serve_resilience: a capacity-8 greedy stream strays from the "
          f"forward of its own tokens (largest shares, overcommit then "
          f"conservative: {shares})")
    # the window: the first 16 steps of the same traffic and plan (alloc
    # stalls, dispatch failures, NaN retries, both preemptions; the
    # sampler runs every step once a stochastic request is queued).  A
    # whole run's window takes the profiler minutes to digest
    prof = profile_window(
        torch, lambda: resilience_serve(torch, cfg, params, steps=16),
        "serve_resilience", ranges=("sample_next",))
    check(prof["ranges"]["sample_next"]["calls"] > 0,
          "serve_resilience: the sampler never ran in the window")
    emit("serve_resilience", arch=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, engine=RESILIENCE_ENGINE,
         priorities=RESILIENCE_PRIORITIES, faults=RESILIENCE_FAULTS,
         requests={k: len(v) for k, v in reqs.items()}, wall_s=wall,
         resilience=st, launches=launches,
         prefill_tok_per_s=tp["prefill_tok_per_s"],
         decode_tok_per_s=tp["decode_tok_per_s"], ttft_p50_s=tt["p50"],
         replay_identical=True,
         greedy_equal_to_phase5=agree(first["greedy"], uncontended),
         greedy_preempted=[r.uid for r in reqs["greedy"]
                           if r.preemptions > 0],
         preempted_equal_to_phase5=agree(pick(first["greedy"], True),
                                         pick(uncontended, True)),
         unpreempted_equal_to_phase5=agree(pick(first["greedy"], False),
                                           pick(uncontended, False)),
         conservative_equal_to_phase5=agree(cons_greedy, uncontended),
         conservative_equal_to_overcommit=agree(cons_greedy,
                                                first["greedy"]),
         conservative=conservative,
         cf8_preempted=[r.uid for r in wide_runs[0]["reqs"]["greedy"]
                        if r.preemptions > 0],
         cf8_overcommit_equal_to_conservative=agree(wide_oc, wide_cons),
         cf8_preempted_equal=agree(
             [x for x, p in zip(wide_oc, wide_pre) if p],
             [x for x, p in zip(wide_cons, wide_pre) if p]),
         cf8_forced_share_overcommit=shares[0],
         cf8_forced_share_conservative=shares[1],
         active_hwm_overcommit=st["active_hwm"],
         active_hwm_conservative=conservative["active_hwm"],
         device_busy_share=prof["device_busy_share"],
         sampler_window=prof["ranges"]["sample_next"],
         phase_s=time.perf_counter() - t_phase, card=card())
    return launches


# the port's kernels, as the profiler names them
# ---------------------------------------------------------------------------
# phase 9: the expert-parallel schedules on a mesh of rank processes
# ---------------------------------------------------------------------------
# The ranks share the one card and meet over gloo through a file store
# (NCCL refuses two ranks of one communicator on one device, and gloo takes
# no CUDA tensor: core/collectives stages each operand through pinned host
# memory).  Every time below is several ranks time-sharing one card with
# collectives over gloo on the host: no interconnect's time.
EP_RANKS = (2, 4)
EP_SCHEDULES = ("decentralized", "centralized", "a2a", "a2a_pipelined")
EP_STRATEGIES = ("dispatch", "dense")
EP_BLOCKS = ((4, 16), (4, 1))
# the reduced cases: a capacity that never binds, the dispatch path at
# decode too (gather_decode_max_tk=0)
EP_REDUCED = dict(capacity_factor=8.0, ep_microchunks=2,
                  gather_decode_max_tk=0)
EP_REDUCED_ARCHS = ("qwen3_moe_30b_a3b", "granite_moe_3b_a800m")
EP_TOL = 1e-5
# full width: granite at full depth, DBRX cut to 4 of 40 layers (25.4 GB of
# experts split over the ranks, about 3.2 GB replicated on each)
EP_FULL = (("granite_moe_3b_a800m", GRANITE_TRAIN_LAYERS), ("dbrx", 4))
EP_SEED = 0
EP_S = 2048
# the full-width gates against the plain one-device forward (PERF.md §6):
# greedy argmax agreement and max |delta logit|, from readings of 0.9365
# and 0.23 (granite), 0.9639 and 1.48 (DBRX) before bf16 sums on the wire
EP_PLAIN_ARGMAX_MIN = 0.90
EP_PLAIN_LOGIT_DELTA_MAX = {"granite_moe_3b_a800m": 0.5, "dbrx": 3.0}
# bf16's unit roundoff (8 significant bits)
BF16_U = 2.0 ** -8
# the paper's Table 3 / §5.2 split: DBRX's MoE layer alone at decode and
# prefill blocks
EP_TABLE3 = ((8, 1), (1, 2048))
EP_REPS = 3
EP_BUDGET_S = 180.0
EP_TIMEOUT_S = 600


def ep_full_config(arch: str, layers):
    """Full width, capacity factor E_pad / K (no token can be dropped), two
    microchunks for a2a_pipelined."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=layers or cfg.num_layers,
                       capacity_factor=cfg.num_experts_padded
                       / cfg.experts_per_token, ep_microchunks=2)


def ep_tokens(torch, cfg):
    rng = np.random.default_rng(EP_SEED)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, EP_S)).astype(
        np.int32), device="cuda")


@contextlib.contextmanager
def partial_sums(n: int, magnitudes: list | None = None):
    """The one-device MoE layer with the rounding points of the schedules
    that sum partial outputs (decentralized, centralized) over n shards:
    each shard's local MoE in the compute dtype, the n partials summed in
    that dtype in shard order.  ``collectives.psum`` sums in this order
    too; the reduce-scatter sums in an order of its own, which is this one
    for n = 2 (a sum of two is order-free).  With
    ``magnitudes`` each call appends sum_r |partial_r| (fp32), which
    bounds how far two orders of the sum can differ.  Only the card's
    reference forwards run under it."""
    from repro_torch.core import expert_parallel
    local = expert_parallel._local_moe

    def summed(cfg, experts, x2d, rout, e_start, capacity, kernels=True,
               groups=1):
        e_local = experts["w_gate"].shape[0] // n
        acc, mag = None, 0.0
        for r in range(n):
            shard = {k: w[r * e_local:(r + 1) * e_local]
                     for k, w in experts.items()}
            part = local(cfg, shard, x2d, rout, e_start + r * e_local,
                         capacity, kernels, groups)
            acc = part if acc is None else acc + part
            mag = mag + part.float().abs()
        if magnitudes is not None:
            magnitudes.append(mag)
        return acc
    expert_parallel._local_moe = summed
    try:
        yield
    finally:
        expert_parallel._local_moe = local


@contextlib.contextmanager
def a2a_arithmetic(n: int, m: int):
    """The one-device MoE layer with the a2a schedules' arithmetic over n
    sequence blocks (a2a: m = 1; a2a_pipelined: m chunks a block): the
    router over each block and the combine over each chunk, at the shapes
    the ranks give cuBLAS; the expert FFN over one dispatch of every token
    (each of its output columns is summed in a fixed order whatever its
    neighbours, ``csrc/moe_ffn.cu``).  B = 1, as in phase 9's forwards.
    Only the card's reference forwards run under it."""
    import torch
    from repro_torch.core import expert_parallel, moe as moe_lib
    layer = expert_parallel.moe_layer

    def blockwise(cfg, layer_p, x, token_mask=None, mesh=None, kernels=True,
                  batch_axes=None, row_blocks=1):
        b, s, d = x.shape
        check(b == 1 and token_mask is None and mesh is None
              and row_blocks == 1,
              "a2a_arithmetic models one row, no mask, one device")
        sl, e_pad = s // n, cfg.num_experts_padded
        x2d = x.reshape(s, d)
        every = torch.ones((sl,), dtype=torch.bool, device=x.device)
        routs = [expert_parallel._route(cfg, layer_p,
                                        x2d[i * sl:(i + 1) * sl], every)
                 for i in range(n)]
        top_idx = torch.cat([r.top_idx for r in routs])
        top_w = torch.cat([r.top_w for r in routs])
        cap = moe_lib.round_capacity(s, cfg.experts_per_token, e_pad,
                                     cfg.capacity_factor)
        tok, valid, slot_of = moe_lib.make_dispatch_plan(top_idx, e_pad, 0,
                                                         e_pad, cap)
        xe = x2d.index_select(0, tok) * valid[:, None].to(x.dtype)
        ye = moe_lib.expert_ffn(layer_p["experts"],
                                xe.reshape(e_pad, cap, d), kernels)
        ye = torch.cat([ye.reshape(e_pad * cap, d), ye.new_zeros((1, d))])
        y_tk = ye.index_select(0, slot_of.reshape(-1)).reshape(s, -1, d)
        tc = sl // m
        y = torch.cat([torch.einsum("tk,tkd->td",
                                    top_w[c:c + tc].to(y_tk.dtype),
                                    y_tk[c:c + tc])
                       for c in range(0, s, tc)])
        return y.reshape(1, s, d), routs[0].aux_loss, top_idx
    expert_parallel.moe_layer = blockwise
    try:
        yield
    finally:
        expert_parallel.moe_layer = layer


# the reference each schedule's mesh forward is held to: the one-device
# forward with the schedule's own rounding points and GEMM shapes
EP_REFERENCE = {"decentralized": "partial", "centralized": "partial",
                "a2a": "a2a", "a2a_pipelined": "a2a_pipelined"}


def ep_sum_order_fixed(sched: str, n: int) -> bool:
    """Whether the schedule's arithmetic on n ranks is all the program's:
    the a2a schedules sum nothing on the wire, and a sum of two partials
    is the same in either order.  Then the mesh forward equals its
    reference bit for bit."""
    return EP_REFERENCE[sched] != "partial" or n == 2


def ep_table3_inputs(torch, cfg) -> list:
    """The seeded bf16 activations of the Table 3 blocks, in EP_TABLE3's
    order (the parent's layer references and the ranks draw the same)."""
    g = torch.Generator(device="cuda").manual_seed(EP_SEED + 1)
    return [torch.randn((b, s, cfg.d_model), generator=g,
                        device="cuda").to(cfg.torch_dtype)
            for b, s in EP_TABLE3]


def ep_layer_references(torch, cfg, params, tmp: str) -> None:
    """DBRX's layer 0 alone on the Table 3 blocks, one device, with the
    partial-sum schedules' rounding points over n shards: the output and
    the elementwise bound 2 (n-1) u (1+u)^(n-1) sum_r |partial_r| (u
    bf16's unit roundoff) on how far any other order of the n - 1 bf16
    additions can land from it.  Saved for ``ep_table3``."""
    from repro_torch.core import expert_parallel as ep
    layer_p = {"router": params["blocks"]["router"][0],
               "experts": {k: w[0] for k, w in
                           params["blocks"]["experts"].items()}}
    for (b, s), x in zip(EP_TABLE3, ep_table3_inputs(torch, cfg)):
        for n in EP_RANKS:
            mags = []
            with partial_sums(n, mags):
                y, _, _ = ep.moe_layer(cfg, layer_p, x)
            bound = (2 * (n - 1) * BF16_U * (1 + BF16_U) ** (n - 1)
                     * mags[0].reshape(y.shape))
            torch.save((y.cpu(), bound.cpu()),
                       f"{tmp}/{cfg.name}_layer{b}x{s}_{n}.pt")


def ep_references(torch, arch: str, layers, tmp: str) -> dict:
    """The one-device forwards the mesh forwards are held to, on the same
    seeded weights and tokens, saved under ``tmp`` for the ranks (the
    weights are freed before the ranks start): the plain forward (its
    logits and layer-0 routing) and, per rank count, the forward with each
    schedule's arithmetic (``partial_sums``, ``a2a_arithmetic``); for
    DBRX also the layer references of ``ep_layer_references``."""
    from repro_torch.models.model import build_model
    cfg = ep_full_config(arch, layers)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(EP_SEED))
    batch = {"tokens": ep_tokens(torch, cfg)}
    with torch.no_grad():
        logits, _, routing = model.forward_seq_routed(params, batch)
        torch.save(logits.cpu(), f"{tmp}/{arch}_plain.pt")
        torch.save(routing[0].cpu(), f"{tmp}/{arch}_routing0.pt")
        del logits
        for n in EP_RANKS:
            for kind, ctx in (("partial", partial_sums(n)),
                              ("a2a", a2a_arithmetic(n, 1)),
                              ("a2a_pipelined", a2a_arithmetic(
                                  n, cfg.ep_microchunks))):
                with ctx:
                    torch.save(model.forward(params, batch)[0].cpu(),
                               f"{tmp}/{arch}_{kind}{n}.pt")
        if arch == "dbrx":
            ep_layer_references(torch, cfg, params, tmp)
    del params
    free_device(torch)
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "reference_s": time.perf_counter() - t0}


def _ep_rank(rank: int, world: int, store: str, tmp: str, q) -> None:
    """A rank process of phase 9: puts (rank, results), or (rank, the
    traceback) and exits non-zero."""
    import traceback
    try:
        q.put((rank, ep_rank_work(rank, world, store, tmp)))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def ep_rank_work(rank: int, world: int, store: str, tmp: str) -> dict:
    import datetime

    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("a phase-9 rank process without CUDA")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    build.library()                 # the parent's build, loaded
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=EP_TIMEOUT_S))
    mesh = mesh_lib.make_mesh((1, world), ("data", "model"))
    t0 = time.perf_counter()
    out = {"reduced": ep_reduced(torch, mesh)}
    out["reduced_s"] = time.perf_counter() - t0
    out["full"] = {}
    for arch, layers in EP_FULL:
        cfg = ep_full_config(arch, layers)
        out["full"][arch], params = ep_full(torch, mesh, arch, cfg, tmp)
        if arch == "dbrx":
            out["table3"] = ep_table3(torch, mesh, cfg, params, tmp)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    dist.barrier()
    dist.destroy_process_group()
    return out


def _schedule_bytes(mesh) -> dict:
    from repro_torch.core import collectives
    return {k: v for k, v in mesh.bytes.items()
            if k not in (collectives.AUX, collectives.LAYOUT)}


def ep_reduced(torch, mesh) -> dict:
    """The reduced cases on this rank, each against the one-device
    ``moe_layer`` on the same card and inputs (fp32): qwen3-moe and
    granite with 6 live experts of 8; every schedule and strategy at a
    prefill and a decode block; int8 and int4 expert shards through every
    schedule; replication r = 2 (decentralized) at 4 ranks.  y within
    EP_TOL, top_idx identical, schedule bytes equal to the prediction, the
    grouped FFN (quantized for quantized shards) launched."""
    from repro_torch.core import expert_parallel as ep
    from repro_torch.core import perf_model, quant
    from repro_torch.kernels import ops
    n = mesh.shape["model"]
    worst, cases, launched = 0.0, 0, {}
    for arch in EP_REDUCED_ARCHS:
        base = reduced_config(arch).replace(**EP_REDUCED)
        d, f, e = base.d_model, base.d_ff, base.num_experts_padded
        g = torch.Generator(device="cuda").manual_seed(3)
        rand = lambda shape, s: torch.randn(shape, generator=g,
                                            device="cuda") * s
        router = rand((d, e), 0.1)
        fp = {"w_gate": rand((e, d, f), 0.05), "w_up": rand((e, d, f), 0.05),
              "w_down": rand((e, f, d), 0.05)}
        xs = {blk: rand((*blk, d), 1.0) for blk in EP_BLOCKS}
        runs = [("fp", fp, strat, sched, 1) for sched in EP_SCHEDULES
                for strat in EP_STRATEGIES]
        for level in ("int8", "int4"):
            qexp = {k: quant.quantize(w, level) for k, w in fp.items()}
            runs += [(level, qexp, "dispatch", sched, 1)
                     for sched in EP_SCHEDULES]
        if n == 4:
            runs.append(("fp", fp, "dispatch", "decentralized", 2))
        for wq, experts, strat, sched, r in runs:
            cfg = base.replace(expert_parallel=sched, moe_strategy=strat,
                               expert_replication=r)
            stack = ({k: torch.cat([w] * r) for k, w in experts.items()}
                     if r > 1 else experts)
            shard = {"router": router,
                     "experts": ep.expert_shard(cfg, stack, mesh)}
            want_kernel = "moe_ffn" if wq == "fp" else "moe_ffn_quant"
            for (b, s), x in xs.items():
                want_y, _, want_ti = ep.moe_layer(
                    cfg, {"router": router, "experts": stack}, x)
                mesh.reset_counters()
                ops.reset_launch_counts()
                y, aux, ti = ep.moe_layer(cfg, shard, x, mesh=mesh)
                torch.cuda.synchronize()
                launches = ops.launch_counts()
                what = f"ep reduced {cfg.name} {wq} {strat} {sched} r={r} " \
                       f"{b}x{s} on {n} ranks"
                err, _ = compare(y, want_y, EP_TOL)
                worst = max(worst, err)
                check(torch.equal(ti, want_ti), f"{what}: top_idx differs")
                check(bool(torch.isfinite(aux)), f"{what}: aux not finite")
                want_b = perf_model.predicted_collective_bytes(
                    cfg, batch=b, seq=s, n_exp_shards=n, n_moe_layers=1,
                    include_tp=False)
                check(_schedule_bytes(mesh) == {k: int(v) for k, v in
                                                want_b.items()},
                      f"{what}: bytes {mesh.bytes} != predicted {want_b}")
                check_path_kernels(launches, (want_kernel,), what)
                for k, v in launches.items():
                    launched[k] = launched.get(k, 0) + v
                cases += 1
    return {"cases": cases, "max_abs_err": worst, "launches": _live(launched)}


def ep_full(torch, mesh, arch: str, cfg, tmp: str):
    """``Model.forward`` on the mesh at full width under each schedule, on
    the seeded weights (this rank keeps its expert rows of every draw),
    held to the one-device forwards of ``ep_references``: layer-0 routing
    identical to the plain forward's on every rank; on rank 0, against the
    plain forward, greedy argmax agreement at least EP_PLAIN_ARGMAX_MIN
    and max |delta logit| at most EP_PLAIN_LOGIT_DELTA_MAX, and against
    the forward with the schedule's own arithmetic (``EP_REFERENCE``) the
    logits bit for bit where the program fixes the sum's order
    (``ep_sum_order_fixed``), else the plain forward's two gates (the
    layer alone is held to a bf16 bound in ``ep_table3``); schedule bytes
    equal to the prediction; flash (once a layer) and the grouped FFN
    launched, nothing else.  Returns (rows, params)."""
    import torch.distributed as dist
    from repro_torch.core import perf_model
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    n = mesh.shape["model"]
    rank = dist.get_rank()
    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(EP_SEED), mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": ep_tokens(torch, cfg)}
    routing0 = torch.load(f"{tmp}/{arch}_routing0.pt", map_location="cuda")
    refs = ({kind: torch.load(f"{tmp}/{arch}_{kind}{n}.pt",
                              map_location="cuda")
             for kind in set(EP_REFERENCE.values())} if rank == 0 else None)
    plain = (torch.load(f"{tmp}/{arch}_plain.pt", map_location="cuda")
             if rank == 0 else None)
    v = cfg.vocab_size
    rows = []
    for sched in EP_SCHEDULES:
        c = cfg.replace(expert_parallel=sched)
        model = build_model(c, "cuda")
        dist.barrier()
        mesh.reset_counters()
        ops.reset_launch_counts()
        t = time.perf_counter()
        with torch.no_grad():
            logits, aux, routing = model.forward_seq_routed(params, batch,
                                                            mesh)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t
        launches = ops.launch_counts()
        what = f"ep {c.name} {sched} on {n} ranks, rank {rank}"
        check_path_kernels(launches, ("flash_attention", "moe_ffn"), what)
        check(launches["flash_attention"] == c.num_layers,
              f"{what}: flash launched {launches['flash_attention']} times")
        check(bool(torch.isfinite(logits).all()) and bool(
            torch.isfinite(aux)), f"{what}: logits or aux not finite")
        check(torch.equal(routing[0], routing0.to(routing.dtype)),
              f"{what}: layer-0 routing differs from the one-device "
              f"forward's")
        want_b = perf_model.predicted_collective_bytes(
            c, batch=1, seq=EP_S, n_exp_shards=n, include_tp=False)
        got_b = _schedule_bytes(mesh)
        check(got_b == {k: int(val) for k, val in want_b.items()},
              f"{what}: bytes {got_b} != predicted {want_b}")
        row = dict(schedule=sched, forward_s=fwd_s, launches=_live(launches),
                   bytes=dict(mesh.bytes), predicted_bytes=want_b,
                   collective_s=dict(mesh.seconds), aux=float(aux))
        if rank == 0:
            top = logits[0, :, :v].argmax(-1)
            kind = EP_REFERENCE[sched]
            exact = ep_sum_order_fixed(sched, n)
            delta_max = EP_PLAIN_LOGIT_DELTA_MAX[arch]

            def against(ref):
                return (float((top == ref[0, :, :v].argmax(-1)).float()
                              .mean()),
                        float((logits - ref)[..., :v].abs().max()))
            agree, delta = against(refs[kind])
            agree_plain, delta_plain = against(plain)
            row.update(reference=kind, bitwise_gate=exact,
                       argmax_agreement=agree, max_abs_logit_delta=delta,
                       argmax_agreement_plain=agree_plain,
                       max_abs_logit_delta_plain=delta_plain,
                       max_abs_logit_plain=float(plain[..., :v].abs().max()))
            gates = [("plain", agree_plain, delta_plain)]
            if exact:
                check(delta == 0.0, f"{what}: logits differ from the "
                      f"{kind} reference by up to {delta} (bitwise gate)")
            else:
                gates.append((kind, agree, delta))
            for name, a, dl in gates:
                check(a >= EP_PLAIN_ARGMAX_MIN,
                      f"{what}: greedy argmax agrees with the {name} "
                      f"forward on {a:.4f} of the positions "
                      f"(< {EP_PLAIN_ARGMAX_MIN})")
                check(dl <= delta_max, f"{what}: max |delta logit| "
                      f"against the {name} forward {dl} > {delta_max}")
        del logits, routing
        rows.append(row)
    del refs, plain
    return {"init_s": init_s, "layers": cfg.num_layers, "rows": rows}, params


def ep_table3(torch, mesh, cfg, params, tmp: str) -> list:
    """The paper's Table 3 / §5.2 split on DBRX's layer 0 alone, per
    schedule, at a decode block (B=8, S=1) and a prefill block (B=1,
    S=2048) of seeded bf16 activations: the layer's median host-clock ms
    over EP_REPS runs (after one warm-up), the median device ms of each
    local expert FFN call (CUDA events around ``moe.expert_ffn``), the
    collectives' host ms by kind (``mesh.seconds``: the waits and the
    host staging), bytes by kind, this rank's peak memory, and at decode
    ``expected_experts_per_shard`` of the routing.  The partial-sum
    schedules' output is held to ``ep_layer_references`` within its bf16
    bound (bitwise where ``ep_sum_order_fixed``).  The ranks time-share
    one card and exchange over gloo on the host."""
    import torch.distributed as dist
    from repro_torch.core import expert_parallel as ep
    from repro_torch.core import moe as moe_lib
    from repro_torch.core import router
    n = mesh.shape["model"]
    layer_p = {"router": params["blocks"]["router"][0],
               "experts": {k: w[0] for k, w in
                           params["blocks"]["experts"].items()}}
    ffn = moe_lib.expert_ffn
    events = []

    def timed_ffn(experts, xe, kernels=True):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = ffn(experts, xe, kernels)
        ev[1].record()
        events.append(ev)
        return out
    rows = []
    moe_lib.expert_ffn = timed_ffn
    try:
        for (b, s), x in zip(EP_TABLE3, ep_table3_inputs(torch, cfg)):
            want_y, bound = (t.to("cuda") for t in torch.load(
                f"{tmp}/{cfg.name}_layer{b}x{s}_{n}.pt"))
            for sched in EP_SCHEDULES:
                c = cfg.replace(expert_parallel=sched)
                walls, coll, ffn_ms = [], {}, []
                torch.cuda.reset_peak_memory_stats()
                for i in range(1 + EP_REPS):
                    dist.barrier()
                    torch.cuda.synchronize()
                    mesh.reset_counters()
                    events.clear()
                    t = time.perf_counter()
                    with torch.no_grad():
                        y, _, ti = ep.moe_layer(c, layer_p, x, mesh=mesh)
                    torch.cuda.synchronize()
                    if i:
                        walls.append(time.perf_counter() - t)
                        ffn_ms += [a.elapsed_time(z) for a, z in events]
                        for k, sec in mesh.seconds.items():
                            coll.setdefault(k, []).append(sec * 1e3)
                check(bool(torch.isfinite(y).all()),
                      f"table3 {sched} {b}x{s}: y not finite")
                row = {}
                if EP_REFERENCE[sched] == "partial":
                    err = (y.float() - want_y.float()).abs()
                    row.update(max_abs_err=float(err.max()),
                               max_err_over_bound=float(
                                   (err / bound.clamp_min(1e-30)).max()))
                    what = f"table3 {sched} {b}x{s} on {n} ranks"
                    if ep_sum_order_fixed(sched, n):
                        check(torch.equal(y, want_y),
                              f"{what}: not bitwise equal to the reference")
                    check(bool((err <= bound).all()), f"{what}: off the "
                          f"reference by more than the bf16 bound")
                row.update(B=b, S=s, schedule=sched,
                           layer_ms=float(np.median(walls)) * 1e3,
                           ffn_ms=float(np.median(ffn_ms)) if ffn_ms
                           else None, ffn_calls=len(events),
                           collective_ms={k: float(np.median(v))
                                          for k, v in coll.items()},
                           bytes=dict(mesh.bytes),
                           peak_bytes=torch.cuda.max_memory_allocated())
                if s == 1:
                    row["expected_experts_per_shard"] = float(
                        router.expected_experts_per_shard(
                            ti, cfg.num_experts, n))
                rows.append(row)
    finally:
        moe_lib.expert_ffn = ffn
    return rows


class RankGroup:
    """``world`` spawned rank processes on the one card, each running
    ``target(rank, world, *args, q)``; they meet through a file store named
    in ``args``.  Started on construction."""

    def __init__(self, target, world: int, args: tuple):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world, self.q = world, ctx.Queue()
        self.procs = [ctx.Process(target=target,
                                  args=(r, world) + args + (self.q,))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def collect(self, timeout: float, what: str) -> dict:
        """Rank -> results, as the ranks put them, until every rank has or
        ``timeout`` s pass or a rank dies; a rank's failure fails
        ``what``."""
        import queue
        res = {}
        deadline = time.monotonic() + timeout
        while len(res) < self.world and time.monotonic() < deadline:
            try:
                rank, val = self.q.get(timeout=5)
            except queue.Empty:
                if not all(p.is_alive() for p in self.procs):
                    break
                continue
            check(not isinstance(val, str),
                  f"{what} rank {rank} of {self.world} failed:\n{val}")
            res[rank] = val
        return res

    def stop(self, grace: float = 30.0) -> None:
        """Join every process, killing one still alive after ``grace`` s."""
        for p in self.procs:
            p.join(timeout=grace)
            if p.is_alive():
                p.kill()
                p.join()

    def finished(self, res: dict, what: str) -> list:
        """After ``stop``: each rank's results, failing ``what`` unless
        every rank reported and exited 0."""
        codes = [p.exitcode for p in self.procs]
        check(len(res) == self.world, f"{what}: ranks {sorted(res)} of "
              f"{self.world} reported; exit codes {codes}")
        check(all(c == 0 for c in codes), f"{what}: exit codes {codes}")
        return [res[r] for r in range(self.world)]


def spawn_ranks(target, world: int, args: tuple, timeout: float,
                what: str) -> list:
    """``world`` rank processes (``RankGroup``) run to their end: each
    rank's results; any rank's failure fails ``what``, and every process
    is stopped."""
    group = RankGroup(target, world, args)
    try:
        res = group.collect(timeout, what)
    finally:
        group.stop()
    return group.finished(res, what)


def ep_spawn(world: int, tmp: str) -> list:
    """Phase 9's ranks on the one card: ``world`` spawned processes meeting
    through a file store in ``tmp``."""
    return spawn_ranks(_ep_rank, world, (f"{tmp}/store_{world}", tmp),
                       EP_TIMEOUT_S, "phase 9")


def check_expert_parallel(torch, runs: dict) -> None:
    """Phase 9: the expert-parallel schedules over 2, then 4, rank
    processes on the one card (one spawn each; the kernels built by this
    process, loaded by the ranks): the reduced cases, granite at full
    width and depth and DBRX at full width (4 of 40 layers) through
    ``Model.forward`` on the mesh, and the Table 3 split.  Fills ``runs``
    with each spawn's launches, summed over its ranks."""
    import tempfile
    t0 = time.perf_counter()
    free_device(torch)
    dev = card()
    with tempfile.TemporaryDirectory() as tmp:
        for arch, layers in EP_FULL:
            emit("ep_reference", **ep_references(torch, arch, layers, tmp),
                 card=dev)
        for n in EP_RANKS:
            t = time.perf_counter()
            ranks = ep_spawn(n, tmp)
            red = [r["reduced"] for r in ranks]
            runs[f"ep_reduced_{n}"] = _summed([r["launches"] for r in red])
            emit("ep_reduced", ranks=n, cases=red[0]["cases"],
                 max_abs_err=max(r["max_abs_err"] for r in red),
                 tolerance=EP_TOL, launches_per_rank=[r["launches"]
                                                      for r in red],
                 seconds=max(r["reduced_s"] for r in ranks))
            for arch, _ in EP_FULL:
                full = [r["full"][arch] for r in ranks]
                runs[f"ep_{arch}_{n}"] = _summed(
                    [row["launches"] for f in full for row in f["rows"]])
                for i, sched in enumerate(EP_SCHEDULES):
                    rows = [f["rows"][i] for f in full]
                    emit("ep_forward", arch=arch, layers=full[0]["layers"],
                         ranks=n, B=1, S=EP_S, dtype="bfloat16", **{
                             k: v for k, v in rows[0].items()
                             if k not in ("launches", "collective_s")},
                         forward_s_per_rank=[r["forward_s"] for r in rows],
                         launches_per_rank=[r["launches"] for r in rows],
                         collective_s_rank0=rows[0]["collective_s"],
                         init_s=max(f["init_s"] for f in full), card=dev)
            for i, row in enumerate(ranks[0]["table3"]):
                emit("ep_table3", ranks=n, arch="dbrx", **row,
                     ffn_ms_per_rank=[r["table3"][i]["ffn_ms"]
                                      for r in ranks],
                     layer_ms_per_rank=[r["table3"][i]["layer_ms"]
                                        for r in ranks],
                     peak_bytes_per_rank=[r["table3"][i]["peak_bytes"]
                                          for r in ranks],
                     timing="ranks time-sharing one card, collectives over "
                            "gloo on the host", card=dev)
            emit("ep_spawn", ranks=n, seconds=time.perf_counter() - t,
                 peak_bytes_per_rank=[r["peak_bytes"] for r in ranks])
    phase_s = time.perf_counter() - t0
    emit("expert_parallel", seconds=phase_s, budget_s=EP_BUDGET_S, card=dev)
    check(phase_s <= EP_BUDGET_S, f"phase 9 took {phase_s:.1f} s of its "
          f"{EP_BUDGET_S} s budget")


# ---------------------------------------------------------------------------
# phase 10: serving on a mesh
# ---------------------------------------------------------------------------

SM_RANKS = (2, 4)
SM_SEED = 0
SM_BUDGET_S = 150.0
SM_TIMEOUT_S = 600
SM_CF = 8.0                      # capacity never binds: 5c's setting
SM_REDUCED_SCHEDULES = ("decentralized", "a2a")
SM_REDUCED_ENGINE = dict(max_batch=2, max_cache=48, chunk_len=8,
                         page_size=4)
# arch -> (layers, rank counts, schedules) at full width, bf16, paged,
# phase 5's traffic; granite at 8 of 32 layers since phase 3b came
SM_FULL = {"granite_moe_3b_a800m": (GRANITE_TRAIN_LAYERS, (2, 4),
                                    ("decentralized", "a2a")),
           "dbrx": (4, (4,), ("decentralized",))}


def sm_config(arch: str, layers, sched: str):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch).replace(capacity_factor=SM_CF,
                                   expert_parallel=sched, ep_microchunks=2)
    return cfg.replace(num_layers=layers) if layers else cfg


def sm_reduced_config(sched: str):
    from repro_torch.configs.base import get_config
    return get_config(ARCH).reduced().replace(capacity_factor=SM_CF,
                                              expert_parallel=sched)


def sm_reduced_prompts(vocab: int):
    return traffic(vocab, 3, 6, 10, 16, seed=5)


class StepRecorder:
    """The engine's model with each unified step's block (B, T) and, for
    the decode steps, routing recorded (what the byte prediction and the
    per-shard expert count read)."""

    def __init__(self, model):
        self.model, self.blocks, self.decode_routing = model, [], []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def forward_routed(self, params, batch, cache, context_len=None, *,
                       mesh=None):
        logits, routing = self.model.forward_routed(
            params, batch, cache, context_len, mesh=mesh)
        b, t = batch["tokens"].shape
        self.blocks.append((b, t))
        if t == 1 and routing is not None:
            self.decode_routing.append(routing.clone())
        return logits, routing


def sm_full(torch, mesh, arch: str, layers, params: dict, sched: str,
            warm: bool) -> dict:
    """One full-width serve on this rank: phase 5's traffic through the
    mesh engine on this rank's serve blocks (after a warm-up serve on the
    rank's first).  Its bytes by kind are held to the prediction summed
    over the steps' blocks, its weight bytes to its serve blocks'
    (``sharding.block_bytes``)."""
    from repro_torch.core import collectives, perf_model, router
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.models.model import HEAD
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = sm_config(arch, layers, sched)
    n = mesh.shape["model"]
    eng = ServingEngine(cfg, EngineConfig(**SERVE_ENGINE), params=params,
                        device="cuda", mesh=mesh)
    if warm:
        serve(eng, traffic(cfg.vocab_size, 2, 8, 24, 40, seed=7), 2)
    rec = StepRecorder(eng.model)
    eng.model = rec
    mesh.reset_counters()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    prompts = traffic(cfg.vocab_size, 6, 40, 48, 160, seed=0)
    t0 = time.perf_counter()
    streams = serve(eng, prompts, 16)
    wall = time.perf_counter() - t0
    want = {}
    for b, t in rec.blocks:
        for k, v in perf_model.predicted_collective_bytes(
                cfg, batch=b, seq=t, n_exp_shards=n, n_batch_shards=1,
                include_tp=True).items():
            want[k] = want.get(k, 0.0) + v
    got = {k: v for k, v in mesh.bytes.items()
           if k not in (collectives.AUX, collectives.LAYOUT, HEAD)}
    weight = eng.memory_stats()["weight_bytes"]
    # the placement's shards hold E_pad / n rows (router-dead ones too)
    shard = [float(router.expected_experts_per_shard(
        r[layer], cfg.num_experts_padded, n)) for r in rec.decode_routing
        for layer in range(cfg.num_layers)]
    tp = eng.throughput()
    return {"streams": [[int(t) for t in g] for g in streams],
            "prompts": [p.tolist() for p in prompts],
            "launches": ops.launch_counts(), "wall_s": wall,
            "steps": len(rec.blocks),
            "bytes": dict(mesh.bytes), "bytes_predicted": want,
            "bytes_as_predicted": got == {k: int(v) for k, v in
                                          want.items()},
            "collective_ms": {k: v * 1e3 for k, v in mesh.seconds.items()},
            "weight_bytes": weight,
            "weight_bytes_as_blocks": weight == sharding.block_bytes(cfg,
                                                                     mesh),
            "total_tok_per_s": tp["total_tok_per_s"],
            "decode_tok_per_s": tp["decode_tok_per_s"],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "experts_per_shard_tracker": eng.expected_experts_per_node(n),
            "experts_per_shard_routing": float(np.mean(shard))}


def sm_rank_work(rank: int, world: int, store: str, go) -> dict:
    """One rank's share of phase 10.  With ``go`` (an event) the rank
    starts up (imports, its CUDA context, the parent's kernel build) and
    then waits for it, so a later group's start-up overlaps the group
    before it."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("a phase-10 rank process without CUDA")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores: an equal share each, so no rank's
    # host threads crowd out the others' collectives
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    from repro_torch.kernels import build, ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    build.library()                 # the parent's build, loaded
    torch.zeros((), device="cuda")  # the rank's context
    if go is not None and not go.wait(SM_TIMEOUT_S):
        raise RuntimeError("phase 10: this rank group was never started")
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=SM_TIMEOUT_S))
    mesh = mesh_lib.make_mesh((1, world), ("data", "model"))
    out = {"reduced": {}, "full": {}}
    t0 = time.perf_counter()
    for sched in SM_REDUCED_SCHEDULES:
        cfg = sm_reduced_config(sched)
        eng = ServingEngine(cfg, EngineConfig(**SM_REDUCED_ENGINE),
                            generator=torch.Generator(
                                device="cuda").manual_seed(SM_SEED),
                            device="cuda", mesh=mesh)
        ops.reset_launch_counts()
        out["reduced"][sched] = {
            "streams": [[int(t) for t in g] for g in serve(
                eng, sm_reduced_prompts(cfg.vocab_size), 4)],
            "launches": ops.launch_counts()}
    out["reduced_s"] = time.perf_counter() - t0
    for arch, (layers, ranks, scheds) in SM_FULL.items():
        if world not in ranks:
            continue
        t0 = time.perf_counter()
        cfg = sm_config(arch, layers, scheds[0])
        params = build_model(cfg, "cuda").init_serving(
            torch.Generator(device="cuda").manual_seed(SM_SEED), mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        for sched in scheds:
            row = sm_full(torch, mesh, arch, layers, params, sched,
                          warm=not out["full"])
            out["full"][f"{arch}/{sched}"] = dict(row, init_s=init_s)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return out


def _sm_rank(rank: int, world: int, store: str, go, q) -> None:
    """A rank process of phase 10: puts (rank, results), or (rank, the
    traceback) and exits non-zero."""
    import traceback
    try:
        q.put((rank, sm_rank_work(rank, world, store, go)))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def sm_forced_shares(torch, arch: str, layers, rows: dict) -> dict:
    """Each mesh serve's greedy streams held to the one-device forward of
    their own tokens (``forced_shares``), on the whole draw of the seed
    the ranks cut their blocks from.  Returns case -> largest share."""
    import types

    from repro_torch.models.model import build_model
    cfg = sm_config(arch, layers, "decentralized")
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(SM_SEED))
    out = {}
    for case, row in rows.items():
        reqs = [types.SimpleNamespace(prompt=np.asarray(p, np.int32),
                                      generated=g)
                for p, g in zip(row["prompts"], row["streams"])]
        out[case] = max(forced_shares(torch, cfg, params, reqs))
    del params
    free_device(torch)
    return out


def check_serve_mesh(torch, runs: dict) -> None:
    """Phase 10: serving on a mesh of 2, then 4, rank processes on the one
    card (the serve-mode layout: tensor parallelism over "model", the
    experts under the schedules).  The reduced qwen3-moe's streams equal
    the one-device engine's on the card; granite at full width cut to 16
    of 32 layers (2 and 4 ranks, decentralized and a2a) and DBRX at full
    width cut to 4 of 40 layers (4 ranks, decentralized): every rank's
    streams identical,
    each held to the one-device forward of its own tokens, the paged and
    grouped-FFN kernels launched on every rank, bytes and weight bytes as
    predicted.  Both groups start together; the 4-rank group waits, started
    up, until the 2-rank group is done.  Fills ``runs`` with each group's
    launches."""
    import multiprocessing as mp
    import tempfile

    from repro_torch.serving.engine import EngineConfig, ServingEngine
    t_phase = time.perf_counter()
    free_device(torch)
    dev = card()
    go = mp.get_context("spawn").Event()
    full = {}
    with tempfile.TemporaryDirectory() as tmp:
        later = RankGroup(_sm_rank, SM_RANKS[1],
                          (f"{tmp}/store_sm_{SM_RANKS[1]}", go))
        try:
            first = RankGroup(_sm_rank, SM_RANKS[0],
                              (f"{tmp}/store_sm_{SM_RANKS[0]}", None))
            t_group = time.perf_counter()
            try:
                want = {}           # while the ranks start up
                for sched in SM_REDUCED_SCHEDULES:
                    cfg = sm_reduced_config(sched)
                    eng = ServingEngine(cfg, EngineConfig(**SM_REDUCED_ENGINE),
                                        generator=torch.Generator(
                                            device="cuda").manual_seed(SM_SEED),
                                        device="cuda")
                    want[sched] = [[int(t) for t in g] for g in serve(
                        eng, sm_reduced_prompts(cfg.vocab_size), 4)]
                    del eng
                free_device(torch)
                res = first.collect(SM_TIMEOUT_S, "phase 10")
            finally:
                go.set()
                first.stop()
            sm_record(first.finished(res, "phase 10"), want, runs, full,
                      time.perf_counter() - t_group, dev)
            t_group = time.perf_counter()
            res = later.collect(SM_TIMEOUT_S, "phase 10")
        except BaseException:
            go.set()
            later.stop(grace=0)
            raise
        later.stop()
        sm_record(later.finished(res, "phase 10"), want, runs, full,
                  time.perf_counter() - t_group, dev)
    for arch, rows in full.items():
        shares = sm_forced_shares(torch, arch, SM_FULL[arch][0], rows)
        emit("serve_mesh_forced", arch=arch, forced_share_max=shares,
             gate=FORCED_SHARE_MAX, card=dev)
        for case, share in shares.items():
            check(share <= FORCED_SHARE_MAX,
                  f"phase 10 {case}: a stream's forced share {share:.3f} > "
                  f"{FORCED_SHARE_MAX}")
    phase_s = time.perf_counter() - t_phase
    emit("serve_mesh", seconds=phase_s, budget_s=SM_BUDGET_S, card=dev)
    check(phase_s <= SM_BUDGET_S, f"phase 10 took {phase_s:.1f} s of its "
          f"{SM_BUDGET_S} s budget")


def sm_record(ranks: list, want: dict, runs: dict, full: dict,
              seconds: float, dev) -> None:
    """Phase 10's gates on one group's results, and its rows: the reduced
    streams against the one-device engine's ``want``; each full case's
    streams identical on every rank, bytes and weight bytes as predicted,
    the kernels launched on every rank.  Adds the group's launches to
    ``runs`` and rank 0's rows to ``full`` (arch -> case/ranks -> row).
    ``seconds``: the group's run, from its start to its last result."""
    n = len(ranks)
    for sched in SM_REDUCED_SCHEDULES:
        for r, res in enumerate(ranks):
            got = res["reduced"][sched]
            check(got["streams"] == want[sched],
                  f"phase 10: reduced {sched} rank {r} of {n}: "
                  f"{got['streams']} != the one-device engine's "
                  f"{want[sched]}")
            check_path_kernels(got["launches"],
                               ("moe_ffn", "paged_attention"),
                               f"serve_mesh reduced rank {r}")
    runs[f"sm_reduced_{n}"] = _summed(
        [res["reduced"][s]["launches"] for res in ranks
         for s in SM_REDUCED_SCHEDULES])
    for case in ranks[0]["full"]:
        rows = [res["full"][case] for res in ranks]
        for r, row in enumerate(rows):
            check(row["streams"] == rows[0]["streams"],
                  f"phase 10 {case}: rank {r} of {n} streamed "
                  f"otherwise than rank 0")
            check(row["bytes_as_predicted"],
                  f"phase 10 {case} rank {r}: bytes {row['bytes']} "
                  f"!= predicted {row['bytes_predicted']}")
            check(row["weight_bytes_as_blocks"],
                  f"phase 10 {case} rank {r}: weight bytes "
                  f"{row['weight_bytes']} != its serve blocks'")
            check(row["launches"]["paged_attention"] > 0
                  and row["launches"]["moe_ffn"] > 0,
                  f"phase 10 {case} rank {r}: launches "
                  f"{_live(row['launches'])}")
        arch = case.split("/")[0]
        full.setdefault(arch, {})[f"{case}/{n}"] = rows[0]
        runs[f"sm_{arch}_{n}"] = _summed(
            [runs.get(f"sm_{arch}_{n}", {})]
            + [row["launches"] for row in rows])
        emit("serve_mesh", case=case, ranks=n,
             layers=SM_FULL[arch][0] or "all", dtype="bfloat16",
             requests=len(rows[0]["streams"]),
             steps=rows[0]["steps"],
             init_s=max(row["init_s"] for row in rows),
             wall_s_per_rank=[row["wall_s"] for row in rows],
             total_tok_per_s_per_rank=[row["total_tok_per_s"]
                                       for row in rows],
             decode_tok_per_s_per_rank=[row["decode_tok_per_s"]
                                        for row in rows],
             peak_bytes_per_rank=[row["peak_bytes"] for row in rows],
             weight_bytes_per_rank=[row["weight_bytes"] for row in rows],
             bytes_rank0=rows[0]["bytes"],
             collective_ms_per_rank=[row["collective_ms"] for row in rows],
             launches_per_rank=[_live(row["launches"]) for row in rows],
             experts_per_shard_tracker=rows[0]["experts_per_shard_tracker"],
             experts_per_shard_routing=rows[0]["experts_per_shard_routing"],
             timing="ranks time-sharing one card, collectives over "
                    "gloo on the host", card=dev)
    emit("serve_mesh_spawn", ranks=n, seconds=seconds,
         reduced_s=max(res["reduced_s"] for res in ranks))


# ---------------------------------------------------------------------------
# phase 11: training on a mesh
# ---------------------------------------------------------------------------

TM_MESH = (2, 2)                 # (data, model): FSDP over data, EP over model
TM_ARCH = "granite_moe_3b_a800m"
TM_LAYERS = 4                    # of 32: the phase's budget
TM_B, TM_S = 4, 2048
# the mesh steps' schedules, in order (the params and moments keep their
# train blocks across the switch: the layout does not depend on it)
TM_SCHEDULES = ("decentralized",) * 3 + ("a2a",)
TM_LR = 1e-3
TM_SEED = 0
# each mesh loss against the one-device trainer's at the same step:
# check_sharded_train_step_matches_single's tolerance (the mesh aux is a
# mean of per-shard aux, not the one-device aux)
TM_RTOL = TM_ATOL = 2e-3
# the scoring loss (flash and the grouped FFN, fp32) against the step-0
# trainer loss on the same blocks and batch, relative
TM_KERNEL_LOSS_TOL = 1e-4
TM_BUDGET_S = 150.0
TM_TIMEOUT_S = 600


def tm_config(sched: str = TM_SCHEDULES[0]):
    """Granite at full width cut to TM_LAYERS, fp32, remat on, at capacity
    factor E_pad / K (no token is ever dropped, as at the reference
    check's factor 8: where capacity binds, a data shard's plan drops
    other tokens than the whole batch's, and the mesh's losses part from
    the one-device trainer's by more than that check's tolerance)."""
    cfg = full_config(TM_ARCH, TM_LAYERS)
    return cfg.replace(
        dtype="float32", param_dtype="float32", remat=True,
        expert_parallel=sched,
        capacity_factor=cfg.num_experts_padded / cfg.experts_per_token)


def tm_optimizer():
    from repro_torch import optim
    n = len(TM_SCHEDULES)
    return optim.OptimizerConfig(lr=TM_LR, total_steps=n,
                                 warmup_steps=max(n // 20, 5))


def tm_batches(torch, vocab: int) -> list:
    """The ``Pipeline`` batches of TM_SEED, one per step, on the card."""
    from repro_torch.data.pipeline import Pipeline, PipelineConfig
    pipe = Pipeline(PipelineConfig(seq_len=TM_S, global_batch=TM_B,
                                   vocab_size=vocab, seed=TM_SEED))
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in pipe.next_batch().items()} for _ in TM_SCHEDULES]


def tm_reference(torch) -> dict:
    """The one-device trainer on the whole weights of TM_SEED and the same
    batches: each step's loss and time."""
    from repro_torch import optim
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    cfg = tm_config()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(TM_SEED))
    state = optim.init(params)
    step = make_train_step(model, tm_optimizer())
    losses, step_s = [], []
    for batch in tm_batches(torch, cfg.vocab_size):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del params, state
    free_device(torch)
    return {"losses": losses, "step_s": step_s, "max_memory_allocated": peak}


def _tree_bytes(tree) -> int:
    from repro_torch import optim
    return sum(t.numel() * t.element_size()
               for t in optim.adamw.tree_leaves(tree))


def tm_rank_work(rank: int, world: int, store: str) -> dict:
    """One rank of phase 11: its train blocks of the TM_SEED weights, the
    scoring loss on the mesh (the kernels), then the trainer's steps under
    TM_SCHEDULES (no kernel)."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("a phase-11 rank process without CUDA")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    from repro_torch import optim
    from repro_torch.kernels import build, ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build_model
    build.library()                 # the parent's build, loaded
    torch.zeros((), device="cuda")  # the rank's context
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=TM_TIMEOUT_S))
    mesh = mesh_lib.make_mesh(TM_MESH, ("data", "model"))
    cfg = tm_config()
    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init_training(
        torch.Generator(device="cuda").manual_seed(TM_SEED), mesh)
    state = optim.init(params)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "param_bytes": _tree_bytes(params),
           "moment_bytes": _tree_bytes(state.mu) + _tree_bytes(state.nu),
           "block_bytes": sharding.block_bytes(cfg, mesh, "train")}
    batches = tm_batches(torch, cfg.vocab_size)
    # the scoring loss on the step-0 blocks and batch: every rank runs the
    # flash and grouped-FFN kernels
    ops.reset_launch_counts()
    mesh.reset_counters()
    t0 = time.perf_counter()
    with torch.no_grad():
        out["kernel_loss"] = float(build_model(cfg, "cuda").loss(
            params, batches[0], kernels=True, mesh=mesh)[0])
    out["kernel_loss_s"] = time.perf_counter() - t0
    out["kernel_launches"] = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    ops.reset_launch_counts()
    for sched, batch in zip(TM_SCHEDULES, batches):
        step = make_train_step(build_model(tm_config(sched), "cuda"),
                               tm_optimizer(), mesh)
        mesh.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        m = {k: float(v) for k, v in m.items()}
        steps.append(dict(m, schedule=sched,
                          step_s=time.perf_counter() - t0,
                          collective_s=dict(mesh.seconds),
                          collective_bytes=dict(mesh.bytes)))
    out["steps"] = steps
    out["train_launches"] = ops.launch_counts()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["resident_after"] = _tree_bytes(params) + _tree_bytes(state.mu) \
        + _tree_bytes(state.nu)
    dist.barrier()
    dist.destroy_process_group()
    return out


def _tm_rank(rank: int, world: int, store: str, q) -> None:
    """A rank process of phase 11: puts (rank, results), or (rank, the
    traceback) and exits non-zero."""
    import traceback
    try:
        q.put((rank, tm_rank_work(rank, world, store)))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def check_train_mesh(torch, runs: dict) -> None:
    """Phase 11: training on a (2, 2) mesh of rank processes on the one
    card, in the train layout (FSDP over "data", the experts' rows over
    "model"): granite at full width (TM_LAYERS of 32, fp32, B=4, S=2048,
    remat) takes TM_SCHEDULES' steps from the TM_SEED weights on the
    ``Pipeline`` batches, each loss within TM_RTOL / TM_ATOL of the
    one-device trainer's (run here while the ranks start up), no kernel
    launched by the steps, each rank's resident params and moments exactly
    its train blocks' bytes, and the mesh scoring loss (flash and the
    grouped FFN on every rank) within TM_KERNEL_LOSS_TOL of the step-0
    loss.  Fills ``runs["train_mesh"]`` with the scoring loss's launches
    summed over the ranks."""
    import tempfile
    t_phase = time.perf_counter()
    free_device(torch)
    dev = card()
    world = TM_MESH[0] * TM_MESH[1]
    cfg = tm_config()
    with tempfile.TemporaryDirectory() as tmp:
        group = RankGroup(_tm_rank, world, (f"{tmp}/store_tm",))
        try:
            ref = tm_reference(torch)     # while the ranks start up
            res = group.collect(TM_TIMEOUT_S, "phase 11")
        finally:
            group.stop()
        ranks = group.finished(res, "phase 11")
    emit("train_mesh_reference", arch=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, B=TM_B, S=TM_S, losses=ref["losses"],
         step_s=ref["step_s"],
         max_memory_allocated=ref["max_memory_allocated"], card=dev)
    want_k = {"flash_attention": cfg.num_layers, "moe_ffn": cfg.num_layers}
    for r, rec in enumerate(ranks):
        check(rec["param_bytes"] == rec["block_bytes"]
              and rec["moment_bytes"] == 2 * rec["block_bytes"]
              and rec["resident_after"] == 3 * rec["block_bytes"],
              f"phase 11 rank {r}: params {rec['param_bytes']} and moments "
              f"{rec['moment_bytes']} bytes, blocks {rec['block_bytes']}")
        check(_live(rec["kernel_launches"]) == want_k,
              f"phase 11 rank {r}: the scoring loss launched "
              f"{rec['kernel_launches']}, expected {want_k}")
        check(not any(rec["train_launches"].values()),
              f"phase 11 rank {r}: the steps launched "
              f"{rec['train_launches']}")
        losses = [s["loss"] for s in rec["steps"]]
        norms = [s["grad_norm"] for s in rec["steps"]]
        check(all(np.isfinite(losses + norms)),
              f"phase 11 rank {r}: non-finite loss or norm {losses} {norms}")
        for i, (got, want) in enumerate(zip(losses, ref["losses"])):
            check(abs(got - want) <= TM_ATOL + TM_RTOL * abs(want),
                  f"phase 11 rank {r} step {i} "
                  f"({rec['steps'][i]['schedule']}): loss {got} against "
                  f"the one-device {want}")
        check(abs(rec["kernel_loss"] - losses[0])
              <= TM_KERNEL_LOSS_TOL * abs(losses[0]),
              f"phase 11 rank {r}: the scoring loss {rec['kernel_loss']} "
              f"against the step-0 loss {losses[0]}")
    runs["train_mesh"] = _summed([r["kernel_launches"] for r in ranks])
    for i, sched in enumerate(TM_SCHEDULES):
        rows = [r["steps"][i] for r in ranks]
        emit("train_mesh", step=i, schedule=sched, ranks=world,
             mesh=dict(zip(("data", "model"), TM_MESH)), arch=cfg.name,
             layers=cfg.num_layers, dtype=cfg.dtype, B=TM_B, S=TM_S,
             loss=rows[0]["loss"], one_device_loss=ref["losses"][i],
             loss_per_rank=[row["loss"] for row in rows],
             grad_norm=rows[0]["grad_norm"], aux=rows[0]["aux"],
             step_s_per_rank=[row["step_s"] for row in rows],
             tok_per_s_per_rank=[TM_B * TM_S / row["step_s"]
                                 for row in rows],
             one_device_step_s=ref["step_s"][i],
             collective_s_per_rank=[row["collective_s"] for row in rows],
             collective_bytes_rank0=rows[0]["collective_bytes"],
             timing="ranks time-sharing one card, collectives over gloo "
                    "on the host", card=dev)
    emit("train_mesh_ranks", ranks=world,
         param_bytes_per_rank=[r["param_bytes"] for r in ranks],
         moment_bytes_per_rank=[r["moment_bytes"] for r in ranks],
         block_bytes_per_rank=[r["block_bytes"] for r in ranks],
         peak_bytes_per_rank=[r["max_memory_allocated"] for r in ranks],
         init_s_per_rank=[r["init_s"] for r in ranks],
         kernel_loss=ranks[0]["kernel_loss"],
         kernel_loss_per_rank=[r["kernel_loss"] for r in ranks],
         kernel_loss_s_per_rank=[r["kernel_loss_s"] for r in ranks],
         kernel_launches_per_rank=[r["kernel_launches"] for r in ranks],
         card=dev)
    phase_s = time.perf_counter() - t_phase
    emit("train_mesh_phase", seconds=phase_s, budget_s=TM_BUDGET_S, card=dev)
    check(phase_s <= TM_BUDGET_S, f"phase 11 took {phase_s:.1f} s of its "
          f"{TM_BUDGET_S} s budget")


# ---------------------------------------------------------------------------
# phase 12: the last two dense configs and the stateful families
# ---------------------------------------------------------------------------

# qwen2-72b and deepseek-67b at full width, depth cut to fit one card with
# the phase's budget: 8 layers are about 19 and 16 GB in bf16 (their 80
# and 95 would be about 145 and 135 GB)
FAMILY_DENSE = (("qwen2_72b", 8), ("deepseek_67b", 8))
# the stateful families at full width and depth in the reference engine
# (the only one the reference gives them): four prompts of exactly
# prefill_len (a shorter one decodes against its padding, which the
# forward does not see), 16 new tokens; the cache holds prefill_len + 16
# positions, so recurrentgemma's attention cache is its 2048-slot ring,
# kept whole by the prefill and wrapped by the decode
FAMILY_NEW_TOKENS = 16
FAMILY_SERVE = dict(max_batch=4, prefill_len=2048,
                    max_cache=2048 + FAMILY_NEW_TOKENS, unified_step=False,
                    paged=False)
# (arch, B, S) of each stateful family's forward and loss: recurrentgemma
# at S=4096, past its 2048-token window
FAMILY_FORWARD = (("recurrentgemma_2b", 1, 4096), ("mamba2_130m", 2, 2048))
FAMILY_BUDGET_S = 150.0
# mamba_forward's SSD chunk length (its default)
SSD_CHUNK = 256
# the largest share an fp32 serve of mamba2-130m may reach against the
# fp32 forward: with bf16's roundings gone only fp32's remain, about 1e-6
# of a logit, far below a near-tie's hundredths
FP32_FORCED_SHARE_MAX = 0.01


def check_family_serve(torch, cfg, phase: str):
    """A stateful family at full width in the reference engine, weights
    drawn on the card from a seeded generator: FAMILY_SERVE's traffic
    after a warm-up on its own engine, no kernel launched (the reference
    path attends in torch ops, as the reference does in jnp), each stream
    held to the forward of its own tokens (``forced_shares``), and the
    weight bytes the bytes of the parameter tree's leaves (the
    performance model has no layer formula for these families).  Returns
    (the launch counts, the weights)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    free_device(torch)
    t_phase = time.perf_counter()
    ecfg = EngineConfig(**FAMILY_SERVE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    eng = ServingEngine(cfg, ecfg, generator=gen, device="cuda")
    params = eng.params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    p_len = FAMILY_SERVE["prefill_len"]
    serve(eng, traffic(cfg.vocab_size, 2, 8, p_len, p_len, seed=7), 2)
    eng = ServingEngine(cfg, ecfg, params=params, device="cuda")
    prompts = traffic(cfg.vocab_size, 4, 40, p_len, p_len, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new_tokens=FAMILY_NEW_TOKENS) for p in prompts]
    eng.run_until_done()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    reqs = [eng._all[u] for u in uids]
    check(all(r.status == "done" and len(r.generated) == FAMILY_NEW_TOKENS
              and 0 <= min(r.generated) and max(r.generated) < cfg.vocab_size
              for r in reqs),
          f"{phase}: requests {[(r.status, len(r.generated)) for r in reqs]}")
    check_path_kernels(launches, (), phase)
    peak = torch.cuda.max_memory_allocated()
    tree = list(leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in tree)
    ms = eng.memory_stats()
    check(ms["weight_bytes"] == nbytes,
          f"{phase}: memory_stats weight_bytes {ms['weight_bytes']} != the "
          f"leaves' {nbytes}")
    ring = None
    if cfg.family == "hybrid":
        ring = eng.cache["attn"]["k"].shape[2]
        check(ring == cfg.sliding_window and
              p_len + FAMILY_NEW_TOKENS > ring,
              f"{phase}: the attention cache holds {ring} slots; the decode "
              f"must wrap a {cfg.sliding_window}-slot ring")
    shares = forced_shares(torch, cfg, params, reqs)
    check(max(shares) < FORCED_SHARE_MAX,
          f"{phase}: a greedy stream strays from the forward of its own "
          f"tokens (largest shares {shares})")
    by_forward = None
    if cfg.family == "ssm":
        by_forward = ssm_forced_shares(torch, cfg, ecfg, params, prompts,
                                       reqs)
        check(max(by_forward["fp32"]) < FP32_FORCED_SHARE_MAX,
              f"{phase}: an fp32 stream strays from the fp32 forward of its "
              f"own tokens (largest shares {by_forward['fp32']})")
    tp, tt = eng.throughput(), eng.ttft()
    emit(phase, arch=cfg.name, family=cfg.family, layers=cfg.num_layers,
         dtype=cfg.dtype, params=sum(t.numel() for t in tree),
         engine=FAMILY_SERVE, requests=len(reqs),
         new_tokens=FAMILY_NEW_TOKENS, init_s=init_s, wall_s=wall,
         prefill_tok_per_s=tp["prefill_tok_per_s"],
         decode_tok_per_s=tp["decode_tok_per_s"],
         total_tok_per_s=tp["total_tok_per_s"], ttft_p50_s=tt["p50"],
         ttft_p95_s=tt["p95"], decode_steps=eng.stats["decode_steps"],
         launches=launches, attention_ring_slots=ring,
         forced_shares=shares, forced_share_max=FORCED_SHARE_MAX,
         forced_shares_by_forward=by_forward,
         weight_bytes=nbytes, weight_bytes_equal_leaves=True,
         kv_cache_bytes=ms["kv_pool_bytes"], max_memory_allocated=peak,
         phase_s=time.perf_counter() - t_phase, card=card())
    return launches, params


def ssm_forced_shares(torch, cfg, ecfg, params, prompts, reqs) -> dict:
    """Where a stream's forced share comes from.  ``bf16_chunk``: the bf16
    streams against the forward padded to whole SSD_CHUNK chunks (the
    serve's prefill runs its 2048 tokens in such chunks, the 2063-token
    forward as one).  ``fp32``: the same prompts served again with the
    weights widened to fp32 and fp32 activations, held to the fp32
    forward: with bf16's roundings gone, a near-tie no longer explains a
    share, a wrong decode or conv state still would."""
    from repro_torch.serving.engine import ServingEngine

    def widen(tree):
        return {k: widen(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    params32 = widen(params)
    eng = ServingEngine(cfg32, ecfg, params=params32, device="cuda")
    uids = [eng.submit(p, max_new_tokens=FAMILY_NEW_TOKENS) for p in prompts]
    eng.run_until_done()
    reqs32 = [eng._all[u] for u in uids]
    out = {"bf16_chunk": forced_shares(torch, cfg, params, reqs, SSD_CHUNK),
           "fp32": forced_shares(torch, cfg32, params32, reqs32),
           "fp32_tokens_equal_bf16": sum(
               list(a.generated) == list(b.generated)
               for a, b in zip(reqs, reqs32))}
    del eng, params32
    return out


def check_families(torch, runs: dict) -> None:
    """Phase 12: qwen2-72b and deepseek-67b at full width cut in depth
    (phase 5's paged serve and the forward and loss, bf16), then
    recurrentgemma-2b and mamba2-130m at full width and depth (the
    reference engine, then the forward and loss).  Fills ``runs``."""
    t0 = time.perf_counter()
    for arch, layers in FAMILY_DENSE:
        cfg = full_config(arch, layers)
        runs[f"{arch}_serve"], params, _ = check_serve(torch, cfg,
                                                       f"{arch}_serve")
        runs[f"{arch}_forward"] = check_forward(torch, params, cfg, 2,
                                                f"{arch}_forward")
        del params
    for arch, b, s in FAMILY_FORWARD:
        cfg = full_config(arch, None)
        runs[f"{arch}_serve"], params = check_family_serve(
            torch, cfg, f"{arch}_serve")
        runs[f"{arch}_forward"] = check_forward(torch, params, cfg, b,
                                                f"{arch}_forward", s)
        del params
    free_device(torch)
    phase_s = time.perf_counter() - t0
    emit("families", seconds=phase_s, budget_s=FAMILY_BUDGET_S, card=card())
    check(phase_s <= FAMILY_BUDGET_S, f"phase 12 took {phase_s:.1f} s of its "
          f"{FAMILY_BUDGET_S} s budget")


# ---------------------------------------------------------------------------
# phase 13: the vlm and audio families
# ---------------------------------------------------------------------------

# qwen2-vl-7b and musicgen-large at full width and depth (15.23 and 6.46
# GB in bf16); the serve: 4 prompts (qwen2-vl: its 1024 patches, then 1000
# text tokens; musicgen: 1000 frames), 16 greedy tokens through prefill and
# decode_step (the engine refuses these families, as the reference's fails
# on them)
MODALITY_ARCHS = ("qwen2_vl_7b", "musicgen_large")
MODALITY_B, MODALITY_S = 2, 2048
MODALITY_SERVE = dict(requests=4, prompt=1000, new_tokens=16)
MODALITY_BUDGET_S = 120.0


def patch_grid(p: int) -> tuple[int, int]:
    """(rows, columns) of the most nearly square grid of ``p`` patches."""
    w = int(np.sqrt(p))
    while p % w:
        w -= 1
    return p // w, w


def modality_inputs(torch, cfg, params, b: int, text: int, seed: int):
    """A seeded batch of the family's inputs on the params' device, without
    labels.  vlm: ``num_patch_tokens`` patch embeddings (N(0, 0.02^2), as
    the embedding rows) on a patch grid at M-RoPE (0, row, column), then
    ``text`` tokens at max + 1 + j on all three components; audio: the
    embedding rows of ``text`` seeded codec tokens as frames.  Returns
    (batch, the text tokens)."""
    from repro_torch.launch.train import audio_frames
    dev = params["embed"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, text), generator=g,
                           device=dev, dtype=torch.int32)
    if cfg.family == "audio":
        return {"frame_embeds": audio_frames(cfg, params, tokens)}, tokens
    p = cfg.num_patch_tokens
    patches = (torch.randn((b, p, cfg.d_model), generator=g, device=dev)
               * 0.02).to(cfg.torch_dtype)
    return {"tokens": tokens, "patch_embeds": patches,
            "mrope_positions": mrope_positions(torch, cfg, b, text, dev)}, \
        tokens


def mrope_positions(torch, cfg, b: int, text: int, dev):
    """(B, P + text, 3) int32: the patch grid at t = 0, then the text."""
    rows, cols = patch_grid(cfg.num_patch_tokens)
    i = torch.arange(cfg.num_patch_tokens, device=dev)
    grid = torch.stack([0 * i, i // cols, i % cols], -1)
    t = max(rows, cols) + torch.arange(text, device=dev)
    pos = torch.cat([grid, t[:, None].expand(text, 3)])
    return pos[None].expand(b, -1, -1).to(torch.int32).contiguous()


def modality_greedy(torch, model, params, batch, prompt_len: int,
                    new_tokens: int, logits_out: list | None = None,
                    mesh=None):
    """Greedy tokens (B, new_tokens) through ``prefill`` then
    ``decode_step`` over a contiguous cache of prompt_len + new_tokens;
    qwen2-vl's decode positions continue the text's at (p, p, p).  Each
    step's last-position logits (the prefill's, then each decode step's)
    are appended to ``logits_out`` on the host, when it is given.  On a
    serving ``mesh`` ``params`` are this rank's serve blocks and the
    cache its share (context-parallel where ``use_cp_decode`` holds)."""
    from repro_torch.models.attention import use_cp_decode
    from repro_torch.models.transformer import attn_cache_len
    cfg = model.cfg
    b = next(iter(batch.values())).shape[0]
    dev = model.device
    cache_len = prompt_len + new_tokens
    cache = model.init_cache(b, cache_len, mesh, seq_sharded=(
        mesh is not None and use_cp_decode(cfg, mesh, attn_cache_len(
            cfg, cache_len))))
    ctx = cache_len if mesh is not None else None
    out = []
    with torch.no_grad():
        logits = model.prefill(params, batch, cache, ctx, mesh=mesh)
        nxt = None
        if cfg.family == "vlm":
            nxt = int(batch["mrope_positions"][0, -1, 0]) + 1
        for i in range(new_tokens):
            if logits_out is not None:
                logits_out.append(logits[:, -1, :cfg.vocab_size].cpu())
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1)
            out.append(tok)
            if i == new_tokens - 1:
                break
            step = {"tokens": tok[:, None].to(torch.int32),
                    "lengths": torch.full((b,), prompt_len + i,
                                          dtype=torch.int32, device=dev)}
            if nxt is not None:
                step["mrope_positions"] = torch.full(
                    (b, 1, 3), nxt + i, dtype=torch.int32, device=dev)
            logits = model.decode_step(params, cache, step, ctx, mesh=mesh)
    return torch.stack(out, 1)


def modality_shares(torch, model, params, batch, tokens, gen) -> list:
    """Each greedy stream held to the full-sequence forward of its own
    inputs (``forced_shares``' measure): qwen2-vl's patches and [text ;
    generated], audio's [frames ; the embedding rows of the generated
    tokens].  Returns each stream's largest share."""
    from repro_torch.launch.train import audio_frames
    cfg = model.cfg
    prev = gen[:, :-1].to(torch.int32)
    if cfg.family == "audio":
        frames = torch.cat([batch["frame_embeds"],
                            audio_frames(cfg, params, prev)], 1)
        fwd = {"frame_embeds": frames}
        start = batch["frame_embeds"].shape[1]
    else:
        text = torch.cat([tokens, prev], 1)
        fwd = {"tokens": text, "patch_embeds": batch["patch_embeds"],
               "mrope_positions": mrope_positions(
                   torch, cfg, text.shape[0], text.shape[1], model.device)}
        start = cfg.num_patch_tokens + tokens.shape[1]
    with torch.no_grad():
        logits, _ = model.forward(params, fwd)
    lg = logits[:, start - 1:, :cfg.vocab_size]
    top = lg.max(-1).values
    share = (top - lg.gather(2, gen.long()[..., None])[..., 0]) / (
        top - lg.mean(-1))
    return [float(x) for x in share.max(1).values]


def check_modalities_reduced(torch, arch: str) -> dict:
    """The reduced config on the card against the CPU from the same fp32
    weights and inputs: forward and loss within TOL (the card's forward
    launching flash once a layer); through prefill and decode_step (which
    launch no kernel) the prefill's and every decode step's logits within
    TOL of the CPU's, step by step, and identical greedy tokens (musicgen's
    reduced streams repeat one token, so the tokens alone would not see a
    decode fault)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    text, p = 40, cfg.num_patch_tokens
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch, _ = modality_inputs(torch, cfg, params, 2, text, 1)
    labels = torch.randint(0, cfg.vocab_size, (2, p + text),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    sides = []
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, dev)
        prm = params if dev == "cpu" else to_cuda(params)
        bt = {k: v.to(dev) for k, v in batch.items()}
        ops.reset_launch_counts()
        with torch.no_grad():
            logits, _ = model.forward(prm, bt)
            launches = ops.launch_counts()
            total, _ = model.loss(prm, dict(bt, labels=labels.to(dev)))
        ops.reset_launch_counts()
        steps = []
        gen = modality_greedy(torch, model, prm, bt, p + text, 8, steps)
        sides.append(dict(logits=logits.cpu(), loss=float(total),
                          gen=gen.cpu().tolist(), launches=launches,
                          serve_launches=ops.launch_counts(), steps=steps))
    cpu, card_ = sides
    err, _ = compare(card_["logits"], cpu["logits"], TOL["float32"])
    check(len(card_["steps"]) == len(cpu["steps"]) == 8,
          f"reduced {cfg.name}: {len(card_['steps'])} serve steps")
    step_errs = [compare(g, w, TOL["float32"])[0]
                 for g, w in zip(card_["steps"], cpu["steps"])]
    check(abs(card_["loss"] - cpu["loss"]) <= TOL["float32"] * (
        1 + abs(cpu["loss"])), f"reduced {cfg.name}: card loss "
          f"{card_['loss']} != CPU {cpu['loss']}")
    check(card_["gen"] == cpu["gen"], f"reduced {cfg.name}: card tokens "
          f"{card_['gen']} != CPU {cpu['gen']}")
    want = {"flash_attention": cfg.num_layers}
    check(_live(card_["launches"]) == want, f"reduced {cfg.name} forward "
          f"launched {card_['launches']}, expected {want}")
    check(not _live(card_["serve_launches"]), f"reduced {cfg.name} serve "
          f"launched {card_['serve_launches']}")
    row = dict(arch=cfg.name, family=cfg.family, dtype=cfg.dtype,
               logits_max_abs_err=err, loss=card_["loss"],
               cpu_loss=cpu["loss"], tolerance=TOL["float32"],
               serve_step_max_abs_err=step_errs,
               tokens_identical=True, tokens=card_["gen"],
               launches=card_["launches"])
    emit("modalities_reduced", **row)
    return row


def check_modality(torch, arch: str, runs: dict) -> None:
    """One family at full width and depth in bf16, weights drawn on the
    card from a seeded generator: the leaves' bytes exactly the
    performance model's; the forward and loss at B=2, S=2048 (one flash
    launch a layer, counted; qwen2-vl's loss leaving its 1024 patches
    out), with a profile window; then MODALITY_SERVE's greedy streams
    through prefill and decode_step, each held to the forward of its own
    inputs (FORCED_SHARE_MAX)."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    free_device(torch)
    t_phase = time.perf_counter()
    cfg = full_config(arch, None)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    want_bytes = perf_model.model_weight_bytes(cfg)
    check(nbytes == want_bytes, f"{arch}: the leaves' bytes {nbytes} != "
          f"perf_model.model_weight_bytes {want_bytes}")
    p = cfg.num_patch_tokens
    b, s = MODALITY_B, MODALITY_S
    batch, _ = modality_inputs(torch, cfg, params, b, s - p, 3)
    batch["labels"] = torch.randint(
        0, cfg.vocab_size, (b, s), device="cuda", dtype=torch.int32,
        generator=torch.Generator(device="cuda").manual_seed(4))
    runs[f"{arch}_forward"] = check_forward(torch, params, cfg, b,
                                            f"{arch}_forward", s, batch)
    del batch
    n, plen, new = (MODALITY_SERVE[k] for k in ("requests", "prompt",
                                                "new_tokens"))
    batch, tokens = modality_inputs(torch, cfg, params, n, plen, 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gen = modality_greedy(torch, model, params, batch, p + plen, new)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    check(not _live(launches), f"{arch} serve launched {launches}: "
          f"prefill and decode attend in torch ops, as the reference's")
    check(0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size,
          f"{arch}: generated tokens out of the vocabulary")
    shares = modality_shares(torch, model, params, batch, tokens, gen)
    check(max(shares) <= FORCED_SHARE_MAX,
          f"{arch}: a greedy stream strays from the forward of its own "
          f"inputs (largest shares {shares})")
    emit(f"{arch}_serve", arch=cfg.name, family=cfg.family,
         layers=cfg.num_layers, dtype=cfg.dtype, init_s=init_s,
         weight_bytes=nbytes, weight_bytes_equal_model=True,
         requests=n, prompt_positions=p + plen, new_tokens=new,
         serve_s=serve_s, decode_tok_per_s=n * (new - 1) / serve_s,
         forced_shares=shares, forced_share_max=FORCED_SHARE_MAX,
         launches=launches, max_memory_allocated=serve_peak,
         phase_s=time.perf_counter() - t_phase, card=card())
    del params, batch


def check_modalities(torch, runs: dict) -> None:
    """Phase 13: the reduced qwen2-vl-7b and musicgen-large on the card
    against the CPU (fp32), then both at full width and depth (bf16).
    Fills ``runs``."""
    t0 = time.perf_counter()
    for arch in MODALITY_ARCHS:
        check_modalities_reduced(torch, arch)
    for arch in MODALITY_ARCHS:
        check_modality(torch, arch, runs)
    free_device(torch)
    phase_s = time.perf_counter() - t0
    emit("modalities", seconds=phase_s, budget_s=MODALITY_BUDGET_S,
         card=card())
    check(phase_s <= MODALITY_BUDGET_S, f"phase 13 took {phase_s:.1f} s of "
          f"its {MODALITY_BUDGET_S} s budget")


# ---------------------------------------------------------------------------
# phase 14: the hybrid, ssm, vlm and audio families on a mesh
# ---------------------------------------------------------------------------

FM_MESH = (2, 2)                 # (data, model)
FM_SEED = 0
# (arch, layers (None: all), B, S) of each family's mesh forward at full
# width, its depth cut for the whole script's time limit: recurrentgemma-2b
# one rec,rec,attn cycle at B=1 S=4096 (past its 2048-token window; B=1
# does not divide "data", so every rank runs the row), qwen2-vl-7b (1024
# patches, then 1024 tokens), musicgen-large and mamba2-130m (12 of 24
# layers, fp32) at B=2 S=2048, a row a rank
FM_FORWARD = (("recurrentgemma_2b", 3, 1, 4096), ("qwen2_vl_7b", 2, 2, 2048),
              ("musicgen_large", 4, 2, 2048), ("mamba2_130m", 12, 2, 2048))
# the serves: two prompts, 8 greedy tokens; vlm and audio through
# prefill + decode_step (qwen2-vl's 1024 patches and 64 text tokens,
# musicgen's 1024 frames), the stateful families through the two-program
# engine on prompts of exactly prefill_len (recurrentgemma's 2048 fill
# its ring, which the decode wraps); every cache length divides the
# "model" axis, so every decode is context-parallel
FM_NEW_TOKENS = 8
FM_SERVE_PROMPT = {"qwen2_vl_7b": 64, "musicgen_large": 1024,
                   "recurrentgemma_2b": 2048, "mamba2_130m": 256}
# the mesh forward's logits held to the one-device forward's on a seeded
# sample of vocabulary columns and at the one-device argmax: phase 9's
# floors in bf16, fp32's rounding for mamba2
FM_COLS = 1024
FM_LOGIT_DELTA_MAX = {"bfloat16": 0.5, "float32": 1e-3}
FM_BUDGET_S = 150.0
FM_TIMEOUT_S = 600


def fm_config(arch: str, layers=None):
    cfg = full_config(arch, layers)
    if cfg.family == "ssm":
        cfg = cfg.replace(dtype="float32", param_dtype="float32")
    return cfg


def fm_inputs(torch, cfg, b: int, s: int, seed: int) -> tuple:
    """A seeded batch of ``cfg``'s inputs over s positions on the card (no
    labels), drawn alike on every process: tokens; qwen2-vl's patches,
    text and M-RoPE positions (``modality_inputs``); musicgen's frames
    N(0, 0.02^2), as the embedding's rows.  Returns (batch, the text
    tokens or None)."""
    if cfg.family == "vlm":
        return modality_inputs(torch, cfg, {"embed": torch.empty(
            0, device="cuda")}, b, s - cfg.num_patch_tokens, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.family == "audio":
        frames = torch.randn((b, s, cfg.d_model), generator=g,
                             device="cuda") * 0.02
        return {"frame_embeds": frames.to(cfg.torch_dtype)}, None
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                    device="cuda", dtype=torch.int32)}, None


def fm_prompts(cfg, plen: int) -> list:
    """The engine serves' two prompts of exactly ``plen`` tokens, sharing
    a 40-token system prompt."""
    return traffic(cfg.vocab_size, 3, 40, plen, plen, seed=5)[:2]


def fm_reference(torch, arch: str, layers, b: int, s: int, tmp: str) -> dict:
    """The one-device forward of the FM_SEED weights on the phase's inputs:
    its argmax and top logit at every position and its logits at FM_COLS
    seeded columns, saved under ``tmp`` (renamed into place: a rank waits
    for the file)."""
    from repro_torch.models.model import build_model
    cfg = fm_config(arch, layers)
    model = build_model(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(FM_SEED))
    batch, _ = fm_inputs(torch, cfg, b, s, 1)
    with torch.no_grad():
        lg = model.forward(params, batch)[0][..., :cfg.vocab_size]
        cols = torch.randperm(cfg.vocab_size, device="cuda", generator=(
            torch.Generator(device="cuda").manual_seed(2)))[:FM_COLS]
        ref = {"argmax": lg.argmax(-1), "top": lg.max(-1).values,
               "cols": cols, "sampled": lg[..., cols]}
    torch.save({k: v.cpu() for k, v in ref.items()}, f"{tmp}/{arch}.part")
    Path(f"{tmp}/{arch}.part").rename(f"{tmp}/{arch}.pt")
    del params, lg, ref
    free_device(torch)
    return {"reference_s": time.perf_counter() - t0}


def _fm_rank(rank: int, world: int, store: str, tmp: str, q) -> None:
    """A rank process of phase 14: puts (rank, results), or (rank, the
    traceback) and exits non-zero."""
    import traceback
    try:
        q.put((rank, fm_rank_work(rank, world, store, tmp)))
    except BaseException:
        q.put((rank, traceback.format_exc()))
        raise


def fm_rank_work(rank: int, world: int, store: str, tmp: str) -> dict:
    import datetime
    import os

    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("a phase-14 rank process without CUDA")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    build.library()                 # the parent's build, loaded
    torch.zeros((), device="cuda")  # the rank's context
    mesh_lib.init_ranks(rank, world, store,
                        timeout=datetime.timedelta(seconds=FM_TIMEOUT_S))
    mesh = mesh_lib.make_mesh(FM_MESH, ("data", "model"))
    out = {arch: fm_rank_arch(torch, mesh, arch, layers, b, s, tmp)
           for arch, layers, b, s in FM_FORWARD}
    dist.barrier()
    dist.destroy_process_group()
    return out


def fm_rank_arch(torch, mesh, arch: str, layers, b: int, s: int,
                 tmp: str) -> dict:
    """One family on this rank: the mesh forward of the FM_SEED weights
    (whole, as ``init(gen, mesh)`` draws them for a family with no
    experts) over its rows, held to the one-device reference; then the
    serve on this rank's serve blocks (``init_serving``)."""
    from repro_torch.core import expert_parallel
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = fm_config(arch, layers)
    model = build_model(cfg, "cuda")
    out = {}
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(FM_SEED),
                        mesh)
    batch, _ = fm_inputs(torch, cfg, b, s, 1)
    with torch.no_grad():
        model.forward(params, batch, mesh)          # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        mesh.reset_counters()
        t0 = time.perf_counter()
        lg = model.forward(params, batch, mesh)[0][..., :cfg.vocab_size]
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
        out["launches"] = ops.launch_counts()
        out["forward_collective_s"] = dict(mesh.seconds)
        rows = expert_parallel.batch_shard(mesh, b)[1]
        out["rows"] = (rows.start, rows.stop)
        path = Path(f"{tmp}/{arch}.pt")
        deadline = time.monotonic() + FM_TIMEOUT_S
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.2)
        ref = {k: v.cuda()[rows] if k != "cols" else v.cuda()
               for k, v in torch.load(path).items()}
        out["argmax_agreement"] = float(
            (lg.argmax(-1) == ref["argmax"]).float().mean())
        out["max_abs_logit_delta"] = max(
            float((lg[..., ref["cols"]] - ref["sampled"]).abs().max()),
            float((lg.gather(-1, ref["argmax"][..., None])[..., 0]
                   - ref["top"]).abs().max()))
        out["forward_peak_allocated"] = torch.cuda.max_memory_allocated()
        del lg, ref, params
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(FM_SEED)
    params = model.init_serving(gen, mesh)
    plen = FM_SERVE_PROMPT[arch]
    mesh.reset_counters()
    t0 = time.perf_counter()
    if cfg.family in ("vlm", "audio"):
        p = cfg.num_patch_tokens if cfg.family == "vlm" else 0
        batch, _ = fm_inputs(torch, cfg, 2, p + plen, 5)
        streams = modality_greedy(torch, model, params, batch, p + plen,
                                  FM_NEW_TOKENS, mesh=mesh).tolist()
    else:
        eng = ServingEngine(cfg, EngineConfig(
            max_batch=2, prefill_len=plen, max_cache=plen + FM_NEW_TOKENS,
            unified_step=False, paged=False), params=params, device="cuda",
            mesh=mesh)
        streams = serve(eng, fm_prompts(cfg, plen), FM_NEW_TOKENS)
        out["cache_shapes"] = {k: tuple(v.shape) for k, v in (
            eng.cache["rec"].items() if cfg.family == "hybrid"
            else eng.cache.items())}
        del eng
    torch.cuda.synchronize()
    out.update(serve_s=time.perf_counter() - t0, streams=streams,
               serve_collective_s=dict(mesh.seconds),
               serve_collective_bytes=dict(mesh.bytes),
               serve_peak_allocated=torch.cuda.max_memory_allocated())
    del params
    free_device(torch)
    return out


def fm_shares(torch, arch: str, layers, streams) -> list:
    """Each greedy stream of the mesh serve held to the one-device forward
    of its own inputs on the whole FM_SEED weights (``forced_shares``, or
    ``modality_shares`` for vlm and audio)."""
    import types

    from repro_torch.models.model import build_model
    cfg = fm_config(arch, layers)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(FM_SEED))
    plen = FM_SERVE_PROMPT[arch]
    gen = torch.as_tensor(streams, device="cuda")
    if cfg.family in ("vlm", "audio"):
        p = cfg.num_patch_tokens if cfg.family == "vlm" else 0
        batch, tokens = fm_inputs(torch, cfg, 2, p + plen, 5)
        shares = modality_shares(torch, model, params, batch, tokens, gen)
    else:
        prompts = fm_prompts(cfg, plen)
        shares = forced_shares(torch, cfg, params, [
            types.SimpleNamespace(prompt=np.asarray(pr, np.int32),
                                  generated=g)
            for pr, g in zip(prompts, streams)])
    del params
    free_device(torch)
    return shares


def check_families_mesh(torch, runs: dict) -> None:
    """Phase 14: the four other families on a (2, 2) mesh of rank
    processes on the one card (one spawn), at full width: each family's
    mesh forward (every batch input cut to the rank's rows; recurrentgemma
    at B=1 runs its row on every rank) held to the one-device forward of
    the same weights (computed here while the ranks start up) by argmax
    agreement (EP_PLAIN_ARGMAX_MIN) and the largest |logit delta| on
    FM_COLS columns and at the argmax (FM_LOGIT_DELTA_MAX), flash launched
    once per attention layer on every rank; then each family served on
    the rank's serve blocks (vlm and audio through prefill and
    decode_step, hybrid and ssm through the engine), every rank's streams
    identical and each held to the one-device forward of its own inputs
    (FORCED_SHARE_MAX; mamba2's fp32 FP32_FORCED_SHARE_MAX).  Fills
    ``runs["fm_<arch>"]`` with the forward's launches summed over the
    ranks."""
    import tempfile
    t_phase = time.perf_counter()
    free_device(torch)
    dev = card()
    world = FM_MESH[0] * FM_MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        group = RankGroup(_fm_rank, world, (f"{tmp}/store_fm", tmp))
        try:
            refs = {arch: fm_reference(torch, arch, layers, b, s, tmp)
                    for arch, layers, b, s in FM_FORWARD}
            res = group.collect(FM_TIMEOUT_S, "phase 14")
        finally:
            group.stop()
        ranks = group.finished(res, "phase 14")
    for arch, layers, b, s in FM_FORWARD:
        cfg = fm_config(arch, layers)
        recs = [r[arch] for r in ranks]
        want = forward_kernels(cfg)
        for r, rec in enumerate(recs):
            check(_live(rec["launches"]) == want,
                  f"phase 14 {arch} rank {r}: the forward launched "
                  f"{rec['launches']}, expected {want}")
            check(rec["argmax_agreement"] >= EP_PLAIN_ARGMAX_MIN,
                  f"phase 14 {arch} rank {r}: argmax agreement "
                  f"{rec['argmax_agreement']:.4f} with the one-device "
                  f"forward < {EP_PLAIN_ARGMAX_MIN}")
            check(rec["max_abs_logit_delta"] <= FM_LOGIT_DELTA_MAX[cfg.dtype],
                  f"phase 14 {arch} rank {r}: |logit delta| "
                  f"{rec['max_abs_logit_delta']:.3g} > "
                  f"{FM_LOGIT_DELTA_MAX[cfg.dtype]}")
            check(rec["streams"] == recs[0]["streams"],
                  f"phase 14 {arch}: rank {r} streamed {rec['streams']}, "
                  f"rank 0 {recs[0]['streams']}")
            check(all(0 <= t < cfg.vocab_size for g in rec["streams"]
                      for t in g) and all(len(g) == FM_NEW_TOKENS
                                          for g in rec["streams"]),
                  f"phase 14 {arch} rank {r}: streams {rec['streams']}")
        shares = fm_shares(torch, arch, layers, recs[0]["streams"])
        bound_ = (FP32_FORCED_SHARE_MAX if cfg.dtype == "float32"
                  else FORCED_SHARE_MAX)
        check(max(shares) <= bound_, f"phase 14 {arch}: a mesh stream strays "
              f"from the one-device forward of its own inputs (shares "
              f"{shares}, bound {bound_})")
        runs[f"fm_{arch}"] = _summed(rec["launches"] for rec in recs)
        emit(f"fm_{arch}", arch=cfg.name, family=cfg.family,
             layers=cfg.num_layers, dtype=cfg.dtype, mesh=FM_MESH, B=b, S=s,
             reference_s=refs[arch]["reference_s"],
             per_rank=[{k: v for k, v in rec.items() if k != "streams"}
                       for rec in recs],
             streams=recs[0]["streams"], forced_shares=shares,
             forced_share_max=bound_, card=dev)
    phase_s = time.perf_counter() - t_phase
    emit("families_mesh", seconds=phase_s, budget_s=FM_BUDGET_S, card=dev)
    check(phase_s <= FM_BUDGET_S, f"phase 14 took {phase_s:.1f} s of its "
          f"{FM_BUDGET_S} s budget")


# ---------------------------------------------------------------------------
# phase 15: the analysis rules and the dry-run against real allocations
# ---------------------------------------------------------------------------

ANALYSIS_BUDGET_S = 90.0
# the dry-run pairs run for real at (1, 1): qwen3-0.6b's prefill (the
# chunked attention of Model.prefill, as the reference's prefill) and its
# scoring forward (the flash kernel, once per layer), granite's decode
# (the gather MoE decode) at a 32768-slot cache
DRYRUN_PAIRS = (("qwen3_0_6b", ("prefill_4k", "prefill", 4096, 4)),
                ("qwen3_0_6b", ("forward_4k", "forward", 4096, 2)),
                ("granite_moe_3b_a800m", ("decode_32k_8", "decode", 32768,
                                          8)))
# the caching allocator's rounding of one tensor's block: a multiple of
# 512 B, and a block of more than 1 MiB also keeps a segment's remainder
# of up to 1 MiB that it does not split off
ALLOC_ROUND_SMALL, ALLOC_ROUND_LARGE = 512, 2**20
# the real peak of requested bytes (the allocator's count before its
# rounding) against the dry-run's argument + temp bytes: equal on all
# three pairs in the measurement (NVIDIA H100 80GB HBM3, 700 W); the gate
# allows this share of the prediction plus DRYRUN_PEAK_SLACK for what the
# op stream cannot see (a cuBLAS workspace first allocated in the step)
DRYRUN_PEAK_RTOL = 0.001
DRYRUN_PEAK_SLACK = 2**20
# R4's sync debug check beyond the reduced qwen3-moe's programs: (arch,
# variant, reduced) for the dense qwen3-0.6b's paged and two-program
# engines, the hybrid's and the ssm's two-program engines, and
# qwen3-0.6b's paged engine at full width
SYNC_ENGINES = (("qwen3_0_6b", "paged", True), ("qwen3_0_6b", "decode", True),
                ("recurrentgemma_2b", "decode", True),
                ("mamba2_130m", "decode", True),
                ("qwen3_0_6b", "paged", False))


def _requested(torch) -> tuple[int, int]:
    """(current, peak) bytes the program asked the allocator for."""
    st = torch.cuda.memory_stats()
    return st["requested_bytes.all.current"], st["requested_bytes.all.peak"]


def check_dryrun_pair(torch, arch: str, spec) -> dict:
    """One pair: the dry-run's record at (1, 1) on meta tensors, then the
    same step on the card from a clean allocator: the argument bytes
    against ``memory_allocated`` after setup, the peak against
    ``max_memory_allocated`` over the step."""
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    shape = ShapeSpec(*spec)
    rec = dryrun.run_pair(arch, shape.name, (1, 1), ("data", "model"),
                          shape=shape)
    check(rec["ok"], f"dry-run {arch} {shape.name}: {rec.get('error')}")
    want_arg = rec["memory"]["argument_bytes"]
    want_peak = rec["memory"]["peak_per_device"]
    free_device(torch)
    base = torch.cuda.memory_allocated()
    base_req = _requested(torch)[0]
    pair = dryrun.setup_pair(get_config(arch), shape, "cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    got_arg = torch.cuda.memory_allocated() - base
    req_arg = _requested(torch)[0] - base_req
    tensors = dryrun.tree_tensors(pair.arguments)
    rounding = sum(ALLOC_ROUND_LARGE if t.numel() * t.element_size() > 2**20
                   else ALLOC_ROUND_SMALL for t in tensors)
    check(req_arg == want_arg and 0 <= got_arg - want_arg <= rounding,
          f"dry-run {arch} {shape.name}: argument bytes {want_arg}, "
          f"requested {req_arg}, allocated {got_arg} over {len(tensors)} "
          f"tensors (rounding at most {rounding})")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = pair.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got_peak = torch.cuda.max_memory_allocated() - base
    req_peak = _requested(torch)[1] - base_req
    launches = _live(ops.launch_counts())
    del out, pair
    free_device(torch)
    check(abs(req_peak - want_peak) <= DRYRUN_PEAK_RTOL * want_peak
          + DRYRUN_PEAK_SLACK,
          f"dry-run {arch} {shape.name}: peak {want_peak} predicted, "
          f"{req_peak} requested ({got_peak} allocated)")
    check(launches.keys() == set(rec["ops"]["kernels"]),
          f"dry-run {arch} {shape.name}: booked {rec['ops']['kernels']}, "
          f"launched {launches}")
    return dict(arch=arch, shape=list(spec),
                argument_bytes=want_arg, requested_after_setup=req_arg,
                allocated_after_setup=got_arg, tensors=len(tensors),
                peak_predicted=want_peak, peak_requested=req_peak,
                peak_allocated=got_peak, peak_ratio=req_peak / want_peak,
                temp_bytes=rec["memory"]["temp_bytes"],
                flops=rec["ops"]["flops_per_device"],
                hbm_bytes=rec["ops"]["hbm_bytes_per_device"],
                roofline_s=max(rec["roofline"]["compute_s"],
                               rec["roofline"]["memory_s"]),
                step_s=step_s, launches=launches,
                dryrun_trace_s=rec["trace_s"])


def check_analysis(torch, runs: dict) -> None:
    """Phase 15: the analysis rules on the card (R1, R2, R3, R4 static and
    under the sync debug mode, R5, R6) over the five programs of the
    reduced qwen3-moe, every one clean, R1(c) with the paged kernel
    launched; R4's sync debug check over SYNC_ENGINES; a planted ``.item()`` caught by the sync debug mode and a
    cloned cache leaf by R1; then the dry-run's memory against the
    allocator on DRYRUN_PAIRS.  Fills ``runs["analysis"]`` with the
    launches of the rules' programs and ``runs["analysis_forward"]`` with
    the dry-run forward's."""
    from repro_torch.analysis import RULE_IDS, analyze_engines, programs
    from repro_torch.analysis.donation import DonationAliasRule
    from repro_torch.analysis.hostsync import HostSyncRule
    from repro_torch.analysis.retrace import drive_engine
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    free_device(torch)
    dev = card()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = analyze_engines(programs.VARIANTS, RULE_IDS, device="cuda")
    runs["analysis"] = ops.launch_counts()
    check(not report.findings, "analysis on the card: "
          + "; ".join(str(f) for f in report.findings))
    emit("analysis_rules", programs=list(programs.VARIANTS),
         rules=list(RULE_IDS), findings=0, launches=_live(runs["analysis"]),
         seconds=time.perf_counter() - t0, card=dev)
    t0 = time.perf_counter()
    for arch, variant, reduced in SYNC_ENGINES:
        eng = programs.build_engine(variant, arch, device="cuda",
                                    reduced=reduced)
        found = HostSyncRule().check_dynamic(eng, drive_engine,
                                             f"{arch}/{variant}")
        check(not found, "R4 on the card: " + "; ".join(map(str, found)))
        del eng
        free_device(torch)
    emit("analysis_sync", engines=[list(e) for e in SYNC_ENGINES],
         findings=0, seconds=time.perf_counter() - t0, card=dev)
    # R1(c) with the kernel: the paged_kernel step allocates no virtual
    # cache while the CUDA kernel attends
    ops.reset_launch_counts()
    prog = programs.trace_program("paged_kernel", device="cuda")
    launched = ops.launch_counts()["paged_attention"]
    check(launched > 0 and DonationAliasRule().check(prog) == [],
          f"R1(c) on the card: {launched} paged launches, "
          f"{DonationAliasRule().check(prog)}")
    # planted: a .item() in the step trips the sync debug mode
    eng = programs.build_engine("paged", device="cuda")
    body = eng._unified

    def synced(*a, **kw):
        out = body(*a, **kw)
        out[2].any().item()
        return out
    eng._unified = synced
    caught = HostSyncRule().check_dynamic(eng, drive_engine)
    check(len(caught) == 1, f"planted .item(): the sync debug mode gave "
          f"{[str(f) for f in caught]}")
    # planted: a cloned cache leaf trips R1 (a) and (b)
    eng = programs.build_engine("paged", device="cuda")

    def cloned(*args):
        eng.cache["k"] = eng.cache["k"].clone()
        return programs.run_step(eng, args)
    got = sorted(f.detail["check"] for f in DonationAliasRule().check(
        programs.trace_engine(eng, "paged", step=cloned)))
    check(got == ["a", "b"], f"planted cache clone: R1 gave {got}")
    del eng, prog
    emit("analysis_planted", r1c_paged_launches=launched,
         item_caught=caught[0].detail["where"], clone_checks=got, card=dev)
    pairs = []
    for arch, spec in DRYRUN_PAIRS:
        row = check_dryrun_pair(torch, arch, spec)
        emit("analysis_dryrun", **row, card=dev)
        pairs.append(row)
        if spec[1] == "forward":
            runs["analysis_forward"] = ops.launch_counts()
    phase_s = time.perf_counter() - t_phase
    emit("analysis", seconds=phase_s, budget_s=ANALYSIS_BUDGET_S,
         peak_ratios=[p["peak_ratio"] for p in pairs], card=dev)
    check(phase_s <= ANALYSIS_BUDGET_S, f"phase 15 took {phase_s:.1f} s of "
          f"its {ANALYSIS_BUDGET_S} s budget")


# phase 16: the configs whose quantized store fits one card, at full
# depth, each weight matrix quantized as it is drawn (``init_serving``):
# (arch, weight_quant, max_batch) for DBRX at int4 (70.82 GB),
# deepseek-67b at int8 (70.35 GB) and qwen2-72b at int8 (76.19 GB), each
# at its natural four rows.  A serve step holds no weight-sized fp32
# copy: a quantized matrix is dequantized a column block at a time
# (``quant.qdot`` / ``qdot_f32``) and a decode step's ``gather_moe``
# gathers the selected experts in the weights' own dtype, so the serve's
# peak of requested bytes lies within ``sharding.serve_peak_bytes``
FULL_DEPTH = (("dbrx", "int4", 4), ("deepseek_67b", "int8", 4),
              ("qwen2_72b", "int8", 4))
FULL_DEPTH_SEED = 0
FULL_DEPTH_BUDGET_S = 180.0


def full_depth_config(arch: str, level: str):
    """``arch`` at its published depth and widths with ``level`` weights;
    an MoE arch at capacity factor 8, where no token is dropped (C1's
    held form), so it is served once and its streams are held to the
    forward directly."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch).replace(weight_quant=level)
    return cfg.replace(capacity_factor=8.0) if cfg.is_moe else cfg


def check_full_depth(torch, runs: dict) -> None:
    """Phase 16: each of FULL_DEPTH loads at full depth on the card, its
    weights drawn and quantized matrix by matrix (``Model.init_serving``,
    the engine's own draw): the load's seconds, its peak of requested
    bytes (reset before the draw) within ``sharding.draw_peak_bytes`` (the
    store plus one fp32 matrix and a column chunk) with the allocated peak
    beside it, the store's bytes exactly
    ``perf_model.model_weight_bytes``, and ``perf_model.fits_in_memory``
    at the card's total beside it.  Then phase 5's traffic through the
    paged engine at four rows (its path's kernels launched, a prefix hit
    and a copy-on-write), its peak of requested bytes within
    ``sharding.serve_peak_bytes`` (``serve_peak_bound``: the store, the
    pool, the largest block or gathered-expert transient and the step's
    activations), and, with the engine freed, each greedy stream held
    to the forward of its own tokens through the served store and
    through its dequantized tree layer by layer (``LayerDequant``), under
    FORCED_SHARE_MAX.  Fills ``runs["full_<arch>"]`` with each serve's
    launches."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    t_phase = time.perf_counter()
    dev = card()
    _, total = torch.cuda.mem_get_info()
    for arch, level, rows in FULL_DEPTH:
        t_cfg = time.perf_counter()
        cfg = full_depth_config(arch, level)
        phase = f"full_{arch}"
        free_device(torch)
        base = torch.cuda.memory_allocated()
        base_req = _requested(torch)[0]
        gen = torch.Generator(device="cuda").manual_seed(FULL_DEPTH_SEED)
        t0 = time.perf_counter()
        params = build_model(cfg, "cuda").init_serving(gen)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() - base
        load_req = _requested(torch)[1] - base_req
        # the bound counts bytes requested; the allocated peak, which
        # the allocator rounds up block by block, is printed beside it
        load_bound = sharding.draw_peak_bytes(cfg)
        check(load_req <= load_bound,
              f"{phase}: the load peaked at {load_req} B requested "
              f"({load_peak} B allocated), past its bound {load_bound} B")
        fits = perf_model.fits_in_memory(cfg, quant=level, budget=total)
        eng = ServingEngine(cfg, EngineConfig(**dict(
            SERVE_ENGINE, max_batch=rows)), params=params, device="cuda")
        weight_bytes = check_weight_bytes(eng, cfg)
        prompts = traffic(cfg.vocab_size, 6, 40, 48, 160, seed=0)
        ms = eng.memory_stats()
        serve_bound = sharding.serve_peak_bytes(
            cfg, rows=rows, chunk_len=SERVE_ENGINE["chunk_len"],
            pool_bytes=ms["kv_pool_bytes"])
        torch.cuda.reset_peak_memory_stats()
        serve_base = _requested(torch)[0]
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        reqs = serve_requests(eng, prompts, 16)
        wall = time.perf_counter() - t1
        launches = ops.launch_counts()
        runs[phase] = launches
        # the store and the pool are live from before the reset on: the
        # requested peak counts them, and whatever else the serve held
        serve_req = _requested(torch)[1]
        check(serve_req <= serve_bound, f"{phase}: the serve peaked at "
              f"{serve_req} B requested, past serve_peak_bound "
              f"{serve_bound} B")
        check(all(len(r.generated) == 16 and 0 <= min(r.generated)
                  and max(r.generated) < cfg.vocab_size for r in reqs),
              f"{phase}: generated tokens out of range")
        check_path_kernels(launches, serve_kernels(cfg), phase)
        ps = eng.paged_stats()
        check(ps["prefix_hits"] > 0 and ps["cow_copies"] > 0,
              f"{phase}: no prefix-cache hit or copy-on-write ({ps})")
        serve_peak = torch.cuda.max_memory_allocated()
        tp, tt = eng.throughput(), eng.ttft()
        eng_steps = eng.stats["decode_steps"]
        del eng
        free_device(torch)
        t1 = time.perf_counter()
        # capacity factor 8 is at or above DBRX's E / K: one forward of
        # every request
        held = {"served": forced_shares(torch, cfg, params, reqs,
                                        batch=len(reqs))}
        dense, held["dequantized_by"] = dequantized(torch, params)
        held["dequantized"] = forced_shares(
            torch, cfg.replace(weight_quant="none"), dense, reqs,
            batch=len(reqs))
        del dense
        held_peak = torch.cuda.max_memory_allocated()
        worst = max(held["served"] + held["dequantized"])
        check(worst <= FORCED_SHARE_MAX, f"{phase}: a greedy stream strays "
              f"from the forward of its own tokens (shares {held})")
        held.update(bound=FORCED_SHARE_MAX,
                    seconds=time.perf_counter() - t1)
        emit(phase, arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
             weight_quant=level, kv_cache_dtype=cfg.kv_cache_dtype,
             capacity_factor=cfg.capacity_factor, max_batch=rows,
             params=cfg.n_params(),
             load_s=load_s, load_peak_allocated=load_peak,
             load_peak_requested=load_req, load_peak_bound=load_bound,
             weight_bytes=weight_bytes,
             weight_bytes_equal_perf_model=True, card_total_bytes=total,
             fits_in_memory=fits, loaded=True, wall_s=wall,
             requests=len(prompts),
             prompt_tokens=int(sum(len(p) for p in prompts)),
             prefill_tok_per_s=tp["prefill_tok_per_s"],
             decode_tok_per_s=tp["decode_tok_per_s"],
             total_tok_per_s=tp["total_tok_per_s"], ttft_p50_s=tt["p50"],
             ttft_p95_s=tt["p95"], memory_stats=ms,
             serve_peak_allocated=serve_peak,
             serve_peak_requested=serve_req,
             serve_base_requested=serve_base, serve_peak_bound=serve_bound,
             decode_steps=eng_steps, held_peak_allocated=held_peak,
             launches=_live(launches), prefix_hits=ps["prefix_hits"],
             cow_copies=ps["cow_copies"], held_to_forward=held,
             seconds=time.perf_counter() - t_cfg, card=dev)
        del params
    free_device(torch)
    phase_s = time.perf_counter() - t_phase
    emit("full_depth", seconds=phase_s, budget_s=FULL_DEPTH_BUDGET_S,
         card=dev)
    check(phase_s <= FULL_DEPTH_BUDGET_S, f"phase 16 took {phase_s:.1f} s "
          f"of its {FULL_DEPTH_BUDGET_S} s budget")


def _live(launches: dict) -> dict:
    """The kernels a run launched (the counts that are not zero)."""
    return {k: v for k, v in launches.items() if v}


def _summed(launch_dicts) -> dict:
    out = {}
    for d in launch_dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


PORT_KERNELS = ("paged_attn_", "paged_combine_kernel", "moe_f32_kernel",
                "moe_gate_up_kernel",
                "moe_down_kernel", "moe_quant_", "flash_attn_")


def profile_window(torch, work, of: str, ranges: tuple = ()):
    """Where the device time goes: ``work`` (two more requests, or one
    forward) under torch.profiler; prints the device-busy share of the
    window and the top kernels, and returns them, with the device time of
    each named range in ``ranges`` (``record_function`` in the port)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    dev = lambda e: e.self_device_time_total / 1e3                   # ms
    avgs = prof.key_averages()
    # device-side events only (kernels, copies); host ops would count twice,
    # and so would a named range's span on the device timeline
    events = [e for e in avgs if e.device_type == DeviceType.CUDA
              and dev(e) > 0 and e.key not in ranges]
    busy_ms = sum(dev(e) for e in events)
    top = sorted(events, key=dev, reverse=True)[:8]
    row = lambda e: {"name": e.key[:90], "ms": dev(e), "calls": e.count}
    out = dict(of=of, wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_busy_share=busy_ms / wall_ms if wall_ms else None,
               top=[row(e) for e in top],
               port_kernels=[row(e) for e in events
                             if any(k in e.key for k in PORT_KERNELS)],
               # a range's host op: the device time of the kernels it
               # launched, and its calls
               ranges={name: {"device_ms": sum(
                   e.device_time_total for e in avgs if e.key == name
                   and e.device_type == DeviceType.CPU) / 1e3, "calls": sum(
                   e.count for e in avgs if e.key == name
                   and e.device_type == DeviceType.CPU)} for name in ranges})
    emit("profile", **out)
    return out


# each kernel entry's source and the TPU kernel it replaces
SOURCES = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                        "src/repro/kernels/paged_attn.py:121"),
    "paged_attention_int8": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                             "src/repro/kernels/paged_attn.py:121"),
    "moe_ffn": ("src/repro_torch/kernels/csrc/moe_ffn.cu",
                "src/repro/kernels/moe_gemm.py:52"),
    "moe_ffn_quant": ("src/repro_torch/kernels/csrc/moe_ffn_quant.cu",
                      "src/repro/kernels/moe_gemm.py:145"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:82"),
}
PAGED_T32 = dict(dtype="bfloat16", T=32, window=None,
                 lengths=[0, 17, 100, 250])
CAUSAL_2048 = dict(dtype="bfloat16", S=2048, causal=True, window=None)
# kernels-line entries: (name, shape picked from phase 3, the run whose
# launches it reports); each path's kernels at the shapes it gives them
LINE = [
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=32), "serve"),
    ("paged_attention_int8", dict(PAGED_T32, hd=128, Hq=32), "serve_quant"),
    ("moe_ffn", dict(dtype="bfloat16", E=128, C=16), "serve"),
    ("moe_ffn", dict(dtype="bfloat16", E=128, C=320), "forward"),
    ("moe_ffn_quant", dict(dtype="bfloat16", E=128, C=16, bits=8),
     "serve_quant"),
    ("moe_ffn_quant", dict(dtype="bfloat16", E=128, C=16, bits=4),
     "reduced_int4"),
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=32), "forward"),
    ("paged_attention", dict(PAGED_T32, hd=64, Hq=24), "granite_serve"),
    ("moe_ffn", dict(dtype="bfloat16", E=48, C=32), "granite_serve"),
    ("moe_ffn", dict(dtype="bfloat16", E=48, C=856), "granite_forward"),
    ("flash_attention", dict(CAUSAL_2048, hd=64, Hq=24), "granite_forward"),
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=48), "dbrx_serve"),
    ("paged_attention_int8", dict(PAGED_T32, hd=128, Hq=48),
     "dbrx_serve_quant"),
    ("moe_ffn", dict(dtype="bfloat16", E=16, C=40), "dbrx_serve"),
    ("moe_ffn", dict(dtype="bfloat16", E=16, C=640), "dbrx_forward"),
    ("moe_ffn_quant", dict(dtype="bfloat16", E=16, C=40, bits=8),
     "dbrx_serve_quant"),
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=48), "dbrx_forward"),
    ("moe_ffn", dict(dtype="bfloat16", E=128, C=256), "serve_reference"),
    ("paged_attention", dict(PAGED_T32, hd=160, Hq=32, Hkv=8),
     "stablelm_serve"),
    ("paged_attention_int8", dict(PAGED_T32, hd=160, Hq=32, Hkv=8),
     "stablelm_serve_quant"),
    ("flash_attention", dict(CAUSAL_2048, hd=160, Hq=32), "stablelm_forward"),
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=16, Hkv=8),
     "qwen3_0_6b_serve"),
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=16),
     "qwen3_0_6b_forward"),
    # phase 9: each rank's grouped FFN and flash at full width on 2 and 4
    # ranks (launches summed over the ranks and the four schedules), the
    # reduced quantized shards
    ("moe_ffn", dict(dtype="bfloat16", E=8, C=2048), "ep_dbrx_2"),
    ("moe_ffn", dict(dtype="bfloat16", E=4, C=2048), "ep_dbrx_4"),
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=48), "ep_dbrx_4"),
    ("moe_ffn", dict(dtype="bfloat16", E=24, C=2048),
     "ep_granite_moe_3b_a800m_2"),
    ("moe_ffn", dict(dtype="bfloat16", E=12, C=2048),
     "ep_granite_moe_3b_a800m_4"),
    ("flash_attention", dict(CAUSAL_2048, hd=64, Hq=24, B=1),
     "ep_granite_moe_3b_a800m_4"),
    ("moe_ffn_quant", dict(dtype="float32", E=1, C=256, bits=8),
     "ep_reduced_4"),
    # phase 10: each rank's paged attention and grouped FFN serving on 2
    # and 4 ranks (launches summed over the ranks and the schedules)
    ("paged_attention", dict(PAGED_T32, hd=64, Hq=12, Hkv=4),
     "sm_granite_moe_3b_a800m_2"),
    ("paged_attention", dict(PAGED_T32, hd=64, Hq=6, Hkv=2),
     "sm_granite_moe_3b_a800m_4"),
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=12, Hkv=2), "sm_dbrx_4"),
    ("moe_ffn", dict(dtype="bfloat16", E=24, C=176),
     "sm_granite_moe_3b_a800m_2"),
    ("moe_ffn", dict(dtype="bfloat16", E=12, C=176),
     "sm_granite_moe_3b_a800m_4"),
    ("moe_ffn", dict(dtype="bfloat16", E=4, C=256), "sm_dbrx_4"),
    # phase 11: each rank's grouped FFN and flash in the mesh scoring loss
    # (fp32; launches summed over the four ranks)
    ("moe_ffn", dict(dtype="float32", E=24, C=4096), "train_mesh"),
    ("flash_attention", dict(CAUSAL_2048, dtype="float32", hd=64, Hq=24,
                             B=2), "train_mesh"),
    # phase 12: qwen2-72b's and deepseek-67b's heads (G=8) in their serves
    # and forwards, and recurrentgemma-2b's local attention (hd 256)
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=64, Hkv=8),
     "qwen2_72b_serve"),
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=64), "qwen2_72b_forward"),
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=64, Hkv=8),
     "deepseek_67b_serve"),
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=64),
     "deepseek_67b_forward"),
    ("flash_attention", dict(dtype="bfloat16", B=1, S=4096, causal=True,
                             window=2048, hd=256, Hq=10),
     "recurrentgemma_2b_forward"),
    # phase 13: qwen2-vl-7b's heads (G=7) and musicgen-large's (MHA) in
    # their forwards
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=28, Hkv=4),
     "qwen2_vl_7b_forward"),
    ("flash_attention", dict(CAUSAL_2048, hd=64, Hq=32, Hkv=32),
     "musicgen_large_forward"),
    # phase 14: each rank's flash in the four families' mesh forwards
    # (launches summed over the four ranks): a row a rank, every head
    ("flash_attention", dict(dtype="bfloat16", B=1, S=4096, causal=True,
                             window=2048, hd=256, Hq=10),
     "fm_recurrentgemma_2b"),
    ("flash_attention", dict(CAUSAL_2048, hd=128, Hq=28, Hkv=4, B=1),
     "fm_qwen2_vl_7b"),
    ("flash_attention", dict(CAUSAL_2048, hd=64, Hq=32, Hkv=32, B=1),
     "fm_musicgen_large"),
    # phase 3b: DBRX's full widths in fp32 (2 of 40 layers, B=1, S=2048):
    # the CUDA-core FFN over fp32, int8 and int4 weights at C=640
    ("moe_ffn", dict(dtype="float32", E=16, C=640), "dbrx_fp32_none"),
    ("moe_ffn_quant", dict(dtype="float32", E=16, C=640, bits=8),
     "dbrx_fp32_int8"),
    ("moe_ffn_quant", dict(dtype="float32", E=16, C=640, bits=4),
     "dbrx_fp32_int4"),
    # phase 15: the reduced qwen3-moe's programs under the analysis rules
    # (fp32; launches over the traced steps and the driven engines): its
    # paged attention at each T and page size they give it; and the
    # dry-run's forward pair on the card (qwen3-0.6b's heads, B=2, S=4096)
    *(("paged_attention", dict(dtype="float32", T=t, Hq=4, Hkv=2, hd=64,
                               B=2, ps=ps), "analysis")
      for t, _, _, ps in REDUCED_PAGED),
    ("moe_ffn", dict(dtype="float32", E=4, C=16), "analysis"),
    ("moe_ffn_quant", dict(dtype="float32", E=4, C=16, bits=8), "analysis"),
    ("flash_attention", dict(dtype="bfloat16", B=2, S=4096, causal=True,
                             window=None, hd=128, Hq=16, Hkv=8),
     "analysis_forward"),
    # phase 16: the three full-depth serves of a store quantized as drawn
    # (DBRX's four rows: their prefill blocks over 12-page tables, and at
    # capacity factor 8, C=256)
    ("paged_attention", dict(dtype="bfloat16", T=32, window=None, hd=128,
                             Hq=48, Hkv=8, B=4, lengths=[17, 100, 0, 60]),
     "full_dbrx"),
    ("moe_ffn_quant", dict(dtype="bfloat16", E=16, C=256, bits=4),
     "full_dbrx"),
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=64, Hkv=8),
     "full_deepseek_67b"),
    ("paged_attention", dict(PAGED_T32, hd=128, Hq=64, Hkv=8),
     "full_qwen2_72b"),
]


def kernels_line(results, runs, line=None) -> dict:
    """One entry per ported kernel (and quantization width) at each path's
    bf16 shape, with the launches of the run that drives it; ``line``:
    those of LINE's entries (all by default)."""
    entries = []
    for name, want, run in LINE if line is None else line:
        row = next(r for r in results if r["kernel"] == name
                   and all(r.get(k) == v for k, v in want.items()))
        src, replaces = SOURCES[name]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches_from": run,
            "launches": runs[run][name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
            "check": "pass", "tolerance": TOL[row["dtype"]],
            "shape": {k: v for k, v in row.items()
                      if k in ("dtype", "bits", "T", "window", "E", "C", "D",
                               "F", "B", "S", "Hq", "Hkv", "hd", "causal",
                               "ps", "lengths", "dead_experts")},
        })
    return {"kernels": entries}


def main() -> int:
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    path, info = build.build()
    ptxas = [line.strip() for rep in info["ptxas"].values()
             for line in rep.splitlines()
             if "registers" in line or "spill" in line]
    counts = sass_mma_counts(path)
    emit("build", seconds=info["seconds"], cached=info["cached"],
         library=path.name, ptxas=ptxas, tensor_core_instructions=counts,
         sass_rules_held=check_sass(counts),
         # the hd-256 bf16 flash instantiation: its registers and spills
         # (the aim is none; printed, not gated; a cached library has no
         # report)
         flash_tc_256_ptxas=None if info["cached"] else ptxas_usage(
             info["ptxas"], "flash_attn_tc_kernelILi256E"),
         flash_tc_256_hgmma=counts["tc::flash_attn_tc_kernel<256>"])
    build.library()

    results = []
    check_paged_attention(torch, results)
    check_paged_sweep(torch)
    check_moe_ffn(torch, results)
    check_moe_ffn_quant(torch, results)
    check_flash_attention(torch, results)
    torch.cuda.empty_cache()
    reduced = check_reduced(torch)
    check_reduced_forward(torch)
    for arch in NEW_ARCHS:
        check_reduced(torch, arch, NEW_REDUCED)
        check_reduced_forward(torch, arch)
    check_chaos(torch)
    check_reduced_modes(torch)
    torch.cuda.empty_cache()
    runs = {"reduced_int4": reduced[("int4", "native")]}
    runs["serve"], params, streams = check_serve(torch)
    runs["forward"] = check_forward(torch, params)
    runs["serve_resilience"] = check_serve_resilience(torch, params, streams)
    from repro_torch.configs.base import get_config
    runs["serve_reference"] = check_serve_reference(
        torch, full_config(), params, "serve_reference")
    del params
    runs["serve_quant"] = check_serve_quant(torch)
    granite = full_config("granite_moe_3b_a800m", GRANITE_LAYERS)
    runs["granite_serve"], params, _ = check_serve(torch, granite,
                                                   "granite_serve")
    runs["granite_forward"] = check_forward(torch, params, granite, 2,
                                            "granite_forward")
    del params
    dbrx = get_config("dbrx").replace(num_layers=DBRX_LAYERS)
    runs["dbrx_serve"], params, _ = check_serve(torch, dbrx, "dbrx_serve")
    runs["dbrx_forward"] = check_forward(torch, params, dbrx, 1,
                                         "dbrx_forward")
    del params
    runs["dbrx_serve_quant"] = check_serve_quant(
        torch, dbrx.replace(weight_quant="int8", kv_cache_dtype="int8"),
        "dbrx_serve_quant")
    check_fp32_dbrx(torch, runs)
    check_dense(torch, runs)
    check_train(torch, runs)
    check_expert_parallel(torch, runs)
    check_serve_mesh(torch, runs)
    check_train_mesh(torch, runs)
    check_families(torch, runs)
    check_modalities(torch, runs)
    check_families_mesh(torch, runs)
    check_analysis(torch, runs)
    check_full_depth(torch, runs)
    print(json.dumps(kernels_line(results, runs)), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
