#!/usr/bin/env python3
"""Accuracy and time of the two ways to take a bf16 product with fp32
output on the card, at the shapes the served path gives ``quant.dot_f32``:
cuBLAS's ``mm`` / ``bmm`` with ``out_dtype=torch.float32`` (no copy of
either operand; the sums run on the tensor cores) and ``quant.dot_f32``
(fp32 copies, the weight's a column block at a time; IEEE fp32 FMA).

    python3 tools/dot_f32_numerics.py

Prints the card's name and power limit, then one JSON line per shape:
each form's largest absolute error against an fp64 product of the same
bf16 operands, and its time (CUDA events, mean of 20 calls).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (name, x shape, w shape, weight scale): the LM head of qwen3-moe at a
# decode step's four rows and a 200-token forward, its router at a
# prefill block of 128 tokens, and gather_moe's down-projection stack of
# 32 selections (4 rows x K=8)
SHAPES = (("head_decode", (4, 2048), (2048, 151936), 0.02),
          ("head_forward", (200, 2048), (2048, 151936), 0.02),
          ("router", (128, 2048), (2048, 128), 0.02),
          ("gather_bmm", (32, 1, 2048), (32, 2048, 768), 0.02))


def time_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dot_f32_numerics: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import quant
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator("cuda").manual_seed(0)
    for name, xs, ws, scale in SHAPES:
        x = torch.randn(xs, device="cuda", generator=g).bfloat16()
        w = (torch.randn(ws, device="cuda", generator=g) * scale).bfloat16()
        ref = x.double() @ w.double()
        card = (lambda: torch.bmm(x, w, out_dtype=torch.float32)) \
            if w.dim() == 3 else (lambda: torch.mm(x, w,
                                                   out_dtype=torch.float32))
        port = lambda: quant.dot_f32(x, w)
        print(json.dumps({
            "shape": name, "x": list(xs), "w": list(ws),
            "out_dtype_max_abs_err": float((card() - ref).abs().max()),
            "dot_f32_max_abs_err": float((port() - ref).abs().max()),
            "ref_max_abs": float(ref.abs().max()),
            "out_dtype_ms": time_ms(torch, card),
            "dot_f32_ms": time_ms(torch, port)}), flush=True)
        del x, w, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
