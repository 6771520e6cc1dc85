"""Serving launcher of the port: continuous batching through
``ServingEngine`` on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b

runs the full-width model (bf16, random weights from a seeded generator);
``--arch`` takes any arch of ``configs/base.ARCH_IDS`` (or the reference's
aliases, e.g. ``dbrx-132b``, ``stablelm-12b``, ``recurrentgemma-2b``).
``--reduced`` runs the smoke-test variant and ``--device cpu`` the plain
versions of the kernels on the CPU.  The engine is the unified step over
the paged pool by default; the hybrid and ssm families and archs whose
window makes the cache a ring always take the two-program reference
engine over the contiguous cache, as the reference's engine does;
``--contiguous`` keeps the contiguous (max_batch, max_cache) cache,
``--reference`` runs the two-program reference engine (prompts padded to
``--prompt-len``, batched prefill, then one-token decode) and ``--legacy``
the same with one prefill per request and a host sync every step; both
take the contiguous cache, which the reference engine needs.  The vlm and
audio archs (``qwen2_vl_7b``, ``musicgen_large``) raise the engine's
``ValueError``, which names the batch key their prefill needs
(``patch_embeds``, ``frame_embeds``): the reference's launcher dies on
that key at its first step.  ``--weight-quant int8|int4`` quantizes each weight
matrix as it is drawn (so DBRX at int4, qwen2-72b at int4 and
deepseek-67b at int8 load at full depth on one 80 GB card) and
``--kv-cache-dtype int8`` keeps an int8 page pool.
``--overcommit`` admits on the context's pages and preempts under pool
pressure, ``--priority`` (cycled over the requests) orders admission,
``--deadline-ms`` expires unfinished requests, and ``--temperature`` /
``--top-k`` sample instead of taking the argmax.  Prints prompt-eval and
generation tok/s, TTFT, device memory, the load's seconds and peak
beside its bound, prefix-cache statistics, the
resilience counters, each kernel's launch count, and from the paper's
performance model (``core/perf_model``): the modelled paged-attention
reads, the E[#exec experts/node/layer] statistic beside Eq. 1's bound on
two to four M2-Ultra nodes, and which weight-quant level lets two such
nodes host the full-size arch (the attention families: the model has no
layer formula for the others).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import perf_model
from repro_torch.kernels import ops
from repro_torch.launch import sharding
from repro_torch.models.model import resolve_device
from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        reference_only)


def serve_demo(cfg, *, requests: int, new_tokens: int, prompt_len: int,
               device="cuda", max_batch: int = 4, seed: int = 0,
               legacy: bool = False, unified: bool = True,
               paged: bool = True, chunk_len: int = 32, page_size: int = 16,
               num_pages: int = 0, shared_prefix: int = 0, fit_cfg=None,
               overcommit: bool = False, priorities=None,
               deadline_ms: float | None = None, temperature: float = 0.0,
               top_k: int = 0):
    fit_cfg = fit_cfg or cfg
    max_cache = prompt_len + new_tokens + 8
    unified = unified and not legacy and not reference_only(cfg, max_cache)
    paged = paged and unified          # the reference engine is contiguous
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, EngineConfig(
        max_batch=max_batch, prefill_len=prompt_len,
        max_cache=max_cache, batched_prefill=not legacy,
        async_steps=not legacy, unified_step=unified, chunk_len=chunk_len,
        paged=paged, page_size=page_size, num_pages=num_pages,
        overcommit=overcommit), generator=gen, device=device)
    load_peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        # the load's peak, read before any request runs
        load_peak = (torch.cuda.max_memory_allocated(),
                     torch.cuda.memory_stats()["requested_bytes.all.peak"])
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, cfg.vocab_size, shared_prefix)
    for k in range(requests):
        plen = int(rng.integers(prompt_len // 2, prompt_len + 1))
        plen = max(plen, min(shared_prefix + 1, prompt_len))
        tail = rng.integers(0, cfg.vocab_size, max(plen - shared_prefix, 1))
        eng.submit(np.concatenate([sysp, tail])[:prompt_len], new_tokens,
                   temperature=temperature, top_k=top_k,
                   priority=(priorities[k % len(priorities)]
                             if priorities else 0),
                   deadline_ms=deadline_ms)
    ops.reset_launch_counts()
    done = eng.run_until_done()
    tp = eng.throughput()
    mode = ("legacy (sequential prefill, sync)" if legacy
            else "paged unified" if paged
            else "contiguous unified" if unified
            else "batched + async (reference)")
    print(f"completed {len(done)} requests [{mode}, {eng.device}]")
    print(f"prompt-eval throughput : {tp['prefill_tok_per_s']:.1f} tok/s")
    print(f"generation throughput  : {tp['decode_tok_per_s']:.1f} tok/s")
    print(f"overall throughput     : {tp['total_tok_per_s']:.1f} tok/s")
    print(f"prefill padding overhead: {tp['prefill_padding_overhead']:.1%}  "
          f"decode stall: {tp['decode_stall_s'] * 1e3:.1f} ms")
    ms = eng.memory_stats()
    print(f"device memory          : weights {ms['weight_bytes'] / 1e6:.2f} "
          f"MB (weight_quant={ms['weight_quant']}), KV pool "
          f"{ms['kv_pool_bytes'] / 1e6:.2f} MB ({cfg.kv_cache_dtype}), total "
          f"{ms['total_bytes'] / 1e6:.2f} MB")
    # the load: every matrix drawn on the device (quantized as it is
    # drawn), its peak against the draw's bound plus the KV pool
    peak = ("peak not measured on the CPU" if load_peak is None else
            f"peak {load_peak[0] / 1e9:.2f} GB allocated, "
            f"{load_peak[1] / 1e9:.2f} GB requested")
    bound = sharding.draw_peak_bytes(cfg) + ms["kv_pool_bytes"]
    print(f"load                   : {load_s:.1f} s, {peak} (bound "
          f"{bound / 1e9:.2f} GB: the store, one fp32 matrix and a "
          f"column chunk, the KV pool)")
    tt = eng.ttft()
    if tt["n"]:
        print(f"TTFT p50/p95           : {tt['p50'] * 1e3:.1f} / "
              f"{tt['p95'] * 1e3:.1f} ms over {tt['n']} requests")
    ps = eng.paged_stats()
    if ps["paged"]:
        print(f"page pool              : {ps['pages_in_use']}/"
              f"{ps['num_pages']} pages in use, high-water "
              f"{ps['pages_hwm']} ({ps['pool_utilization']:.1%} of pool), "
              f"page_size {ps['page_size']}")
        # attention-read model over the decode trajectory (not its last
        # step, where every row fills its block table and both reads are
        # equal): the pages the kernel walks against a gather of the whole
        # block table
        rb = perf_model.paged_attention_read_bytes(
            cfg, lengths=[prompt_len + i for i in range(new_tokens)
                          for _ in range(max_batch)],
            page_size=page_size, max_blocks=eng.max_blocks)
        steps = max(new_tokens, 1)
        print(f"paged-attention reads  : "
              f"{rb['kernel_bytes'] / steps / 1e6:.2f} MB/step over live "
              f"pages (the kernel, device memory) vs "
              f"{rb['gather_bytes'] / steps / 1e6:.2f} MB gathering whole "
              f"block tables ({rb['ratio']:.1f}x)")
        print(f"prefix cache           : hit rate "
              f"{ps['prefix_hit_rate']:.1%} ({ps['prefix_hits']}/"
              f"{ps['prefix_lookups']} lookups), {ps['prefix_hit_tokens']} "
              f"prefill tokens skipped, {ps['prefix_cached_pages']} pages "
              f"cached, {ps['prefix_evictions']} evictions, "
              f"{ps['cow_copies']} CoW copies")
    rs = eng.resilience_stats()
    n_done = sum(1 for r in done if r.status == "done")
    print(f"resilience             : {n_done}/{len(done)} done, "
          f"{rs['expired']} expired, {rs['cancelled']} cancelled, "
          f"{rs['failed']} failed; {rs['preemptions']} preemptions / "
          f"{rs['restores']} restores ({rs['restore_hit_tokens']} tokens "
          f"restored from prefix cache), admitted high-water "
          f"{rs['active_hwm']}")
    print("kernel launches        : " + ", ".join(
        f"{k} {v}" for k, v in ops.launch_counts().items()))
    for n in (2, 3, 4) if cfg.is_moe else ():
        e = eng.expected_experts_per_node(n)
        est = perf_model.estimate(perf_model.MoEWorkload.from_config(cfg),
                                  perf_model.M2_ULTRA_10GBE, n,
                                  expected_experts=e)
        print(f"E[#exec experts/node/layer] @ {n} nodes: {e:.2f}  "
              f"(paper-model bound {est.throughput:.1f} tok/s)")
    # which quant level lets two of the paper's nodes host the arch, from
    # ``fit_cfg`` (main() passes the full-size config, so a --reduced run
    # still prints the real answer)
    if fit_cfg.family in ("dense", "moe"):
        fit = perf_model.max_model_at_budget(fit_cfg, n_nodes=2)
        print(f"memory fit @ 2 M2-Ultra nodes ({fit_cfg.name}): "
              f"{fit['level'] or 'does not fit (even int4)'}  "
              + " ".join(f"{k}={v / 1e9:.1f}GB"
                         for k, v in fit["per_node_bytes"].items()))
    return eng, done


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--legacy", action="store_true",
                    help="the reference engine with one prefill per request "
                         "and a host sync every step (for A/B comparison)")
    ap.add_argument("--reference", action="store_true",
                    help="two-program reference engine (batched padded "
                         "prefill + decode; unified_step=False, contiguous "
                         "cache)")
    ap.add_argument("--contiguous", action="store_true",
                    help="the unified step over the contiguous (max_batch, "
                         "max_cache) cache instead of the page pool")
    ap.add_argument("--chunk-len", type=int, default=32,
                    help="unified block width / prefill chunk size")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pool size in pages (0 = max_batch * "
                         "ceil(max_cache / page_size))")
    ap.add_argument("--weight-quant", choices=["none", "int8", "int4"],
                    default="none",
                    help="quantize attn/experts/lm_head weights on load "
                         "(blockwise, block 128; router and embedding stay "
                         "fp)")
    ap.add_argument("--kv-cache-dtype", choices=["native", "int8"],
                    default="native",
                    help="int8: int8 page pool with one fp32 scale per "
                         "(slot, kv head)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt shared by every request "
                         "(exercises the prefix cache)")
    ap.add_argument("--overcommit", action="store_true",
                    help="admit on the current context instead of reserving "
                         "the whole lifetime; under pool pressure the "
                         "scheduler preempts low-priority rows into the "
                         "prefix cache and restores them later")
    ap.add_argument("--priority", type=int, nargs="+", default=None,
                    help="admission priorities, cycled across requests "
                         "(e.g. --priority 0 5: every other request is "
                         "high-priority; higher admits first and, with "
                         "--overcommit, may preempt lower)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request wall-clock deadline from submit; "
                         "unfinished requests expire and release pages")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k cut (0 = full vocab)")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(weight_quant=args.weight_quant,
                      kv_cache_dtype=args.kv_cache_dtype)
    serve_demo(cfg, requests=args.requests, new_tokens=args.new_tokens,
               prompt_len=args.prompt_len, device=args.device,
               max_batch=args.max_batch, legacy=args.legacy,
               unified=not args.reference, paged=not args.contiguous,
               chunk_len=args.chunk_len,
               page_size=args.page_size, num_pages=args.num_pages,
               shared_prefix=args.shared_prefix,
               fit_cfg=get_config(args.arch), overcommit=args.overcommit,
               priorities=args.priority, deadline_ms=args.deadline_ms,
               temperature=args.temperature, top_k=args.top_k)


if __name__ == "__main__":
    main()
