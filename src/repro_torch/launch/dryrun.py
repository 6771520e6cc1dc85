"""Dry-run: every (architecture x input shape) pair's step on the meta
device, with no allocation (the JAX package's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced --jobs 4

``--reduced`` runs each arch's ``reduced()`` config on every shape cut to
``REDUCED_SEQ`` tokens and one row per data shard (the smoke form the
tests run); ``--jobs`` runs pairs in that many processes.

The reference lowers and compiles each pair for 512 placeholder TPU
devices and reads XLA's memory analysis and HLO.  The port runs rank 0's
step of the pair on meta tensors (shapes, no storage) over a meta mesh
(``launch/mesh.make_meta_mesh``: the production (16, 16), or with
``--multi-pod`` (2, 16, 16), or ``--mesh 1x1``, one device), under
``launch/opcount.capture``.  The program is SPMD, so rank 0's step gives
the per-device numbers.  The kernels book their cost on meta tensors
(``kernels/ops.py``), the collectives their bytes (``core/collectives``).

Each pair's record has the reference's keys, with ``ops`` in place of
``hlo``:

  * ``memory.argument_bytes`` — exact from the specs: this rank's params
    blocks (train: and both fp32 AdamW moments), the cache block
    (prefill, decode) and the inputs;
  * ``memory.alias_bytes`` — what the step updates in place (train: the
    params and moments; prefill and decode: the cache);
  * ``memory.temp_bytes`` — from the op stream: the peak of the live bytes
    of the storages the step allocates (each counted from the op that
    creates it until it is freed); ``output_bytes`` what of it is still
    live at the end; ``peak_per_device`` = argument + temp;
  * ``ops`` — ``opcount.analyze`` of the stream; ``roofline`` its three
    terms against the card's data-sheet rates (below).

A pair that cannot run on meta tensors (a host read of a tensor value in
its step) gets ``ok: false`` and a reason naming the file and line of the
port where it stopped.  Nothing is skipped quietly, and nothing is set at
import time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import optim
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.core import quant
from repro_torch.launch import opcount, sharding
from repro_torch.launch.mesh import make_meta_mesh, production_shape
from repro_torch.launch.train import make_train_step
from repro_torch.models.attention import use_cp_decode
from repro_torch.models.model import build_model
from repro_torch.models.transformer import attn_cache_len

# NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet, per card
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; fp32 no TF32
HBM_BW = 3.35e12          # bytes/s
NVLINK_BW = 450e9         # bytes/s per direction (NVLink 4, 18 links)


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D per decoded/prefilled token
    (N = active params for MoE)."""
    n = cfg.n_active_params() if cfg.is_moe else cfg.n_params()
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill") else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


def roofline(totals: opcount.Totals, n_devices: int, cfg, shape) -> dict:
    """Three roofline terms (seconds) of rank 0's step: its FLOPs over the
    card's peak for the config's dtype, its device-memory bytes over HBM,
    its collective bytes over one NVLink direction."""
    t_comp = totals.flops / PEAK_FLOPS.get(cfg.dtype, PEAK_FLOPS["bfloat16"])
    t_mem = totals.hbm_bytes / HBM_BW
    t_coll = totals.collective_bytes / NVLINK_BW
    dom = max(("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
              key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    return {
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "dominant": dom,
        "model_flops": mf,
        "ops_flops_per_device": totals.flops,
        "useful_flop_ratio": mf / max(totals.flops * n_devices, 1.0),
        "collective_by_kind": dict(totals.coll),
    }


def tree_tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, quant.QuantTensor):
        return [tree.data, tree.scale]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


def _contiguous(tree):
    """Every leaf a storage of its own (a block cut from a whole meta
    tensor is a view): what a rank holds."""
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    if isinstance(tree, quant.QuantTensor):
        return dataclasses.replace(tree, data=tree.data.clone(),
                                   scale=tree.scale.clone())
    return tree.clone()


@dataclasses.dataclass
class Pair:
    """One (arch, shape) step, set up on a device: ``step()`` runs it;
    ``arguments`` / ``aliased`` are the trees it reads / updates in
    place."""
    cfg: object
    shape: object
    step: object
    arguments: dict
    aliased: dict


def setup_pair(cfg, shape, device="meta", mesh=None,
               generator: torch.Generator | None = None) -> Pair:
    """The pair's step and its arguments on ``device``: the meta device
    (the dry-run; params are ``sharding.meta_params``' blocks) or a real
    one (random weights from ``generator``; the inputs zeros), on one
    device or, on meta, a meta mesh.  Beside the shapes' kinds (train:
    the trainer's step; prefill: ``Model.prefill`` into the contiguous
    cache; decode: ``Model.decode_step``), a ``forward`` kind is the
    scoring forward ``Model.forward`` on the prefill's inputs, the path
    that launches the flash and grouped-FFN kernels."""
    mode = "train" if shape.kind == "train" else "serve"
    if shape.kind == "train":
        cfg = cfg.replace(weight_quant="none")
    model = build_model(cfg, device)
    if str(device) == "meta":
        params = sharding.meta_params(cfg)
        if mesh is not None:
            params = sharding.shard_tree(
                params, sharding.mode_specs(cfg, mesh, mode), mesh)
        params = _contiguous(params)
    else:           # quantized as each matrix is drawn, where it is
        params = model.init_serving(generator)
    specs = input_specs(cfg, shape if shape.kind != "forward" else
                        dataclasses.replace(shape, kind="prefill"))
    batch = {k: (v if str(device) == "meta" else
                 torch.zeros(v.shape, dtype=v.dtype, device=device))
             for k, v in specs.items()}
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "forward":
        return Pair(cfg, shape, lambda: model.forward(params, batch,
                                                      mesh=mesh),
                    {"params": params, "batch": batch}, {})
    if shape.kind == "train":
        opt = optim.init(params)
        train_step = make_train_step(model, optim.OptimizerConfig(), mesh)
        return Pair(cfg, shape, lambda: train_step(params, opt, batch),
                    {"params": params, "opt": opt, "batch": batch},
                    {"params": params, "opt": opt})
    cache = model.init_cache(b, s, mesh, seq_sharded=(
        mesh is not None and use_cp_decode(cfg, mesh,
                                           attn_cache_len(cfg, s))))
    if shape.kind == "prefill":
        step = lambda: model.prefill(params, batch, cache, s, mesh=mesh)
    else:
        step = lambda: model.decode_step(params, cache, batch, s, mesh=mesh)
    return Pair(cfg, shape, step,
                {"params": params, "cache": cache, "batch": batch},
                {"cache": cache})


def _where(exc: BaseException) -> str:
    """file:line of the innermost frame of the port in ``exc``'s
    traceback (else the innermost frame)."""
    frames = traceback.extract_tb(exc.__traceback__)
    ours = [f for f in frames if "repro_torch" in f.filename]
    f = (ours or frames)[-1]
    name = f.filename
    if "src/" in name:
        name = name.split("src/")[-1]
    return f"{name}:{f.lineno}"


REDUCED_SEQ = 128


def reduced_pair(cfg, shape, mesh_shape: tuple):
    """``--reduced``: the arch's ``reduced()`` config, the shape cut to
    ``REDUCED_SEQ`` tokens and one row per data shard.  An MoE config's
    experts are widened to the next multiple of the "model" axis (the
    reduced four do not split over 16 ranks), so that its schedule runs
    at the production mesh."""
    rows = 1
    for n in mesh_shape[:-1]:
        rows *= n
    red = cfg.reduced()
    if red.is_moe and red.num_experts % mesh_shape[-1]:
        e = -(-red.num_experts // mesh_shape[-1]) * mesh_shape[-1]
        red = red.replace(num_experts=e, num_experts_padded=e)
    return red, dataclasses.replace(
        shape, seq_len=min(shape.seq_len, REDUCED_SEQ), global_batch=rows)


def mesh_name(shape: tuple) -> str:
    return "x".join(str(s) for s in shape)


def run_pair(arch: str, shape_name: str, mesh_shape: tuple, axes: tuple,
             cfg_overrides=None, shape=None, reduced: bool = False) -> dict:
    """One pair's record (``shape`` overrides ``SHAPES[shape_name]``;
    ``reduced``: ``reduced_pair``'s cut)."""
    n_dev = 1
    for n in mesh_shape:
        n_dev *= n
    t0 = time.perf_counter()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_shape),
           "n_devices": n_dev, "ok": False}
    try:
        cfg = get_config(arch)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        shape = shape or SHAPES[shape_name]
        if reduced:
            cfg, shape = reduced_pair(cfg, shape, mesh_shape)
            rec["reduced"] = {"seq_len": shape.seq_len,
                              "global_batch": shape.global_batch}
        mesh = make_meta_mesh(mesh_shape, axes) if n_dev > 1 else None
        pair = setup_pair(cfg, shape, "meta", mesh)
        with torch.no_grad() if shape.kind != "train" else \
                torch.enable_grad():
            cap = opcount.capture(pair.step)
        totals = opcount.analyze(cap.records)
        arg = tree_nbytes(pair.arguments)
        rec.update({
            "ok": True,
            "trace_s": round(time.perf_counter() - t0, 2),
            "n_ops": len(cap.records),
            "memory": {
                "argument_bytes": arg,
                "output_bytes": cap.live_bytes,
                "temp_bytes": cap.peak_bytes,
                "alias_bytes": tree_nbytes(pair.aliased),
                "peak_per_device": arg + cap.peak_bytes,
            },
            "ops": {
                "flops_per_device": totals.flops,
                "bytes_per_device_raw": totals.bytes,
                "hbm_bytes_per_device": totals.hbm_bytes,
                "convert_bytes_per_device": totals.convert_bytes,
                "collective_bytes_per_device": totals.collective_bytes,
                "collective_by_kind": dict(totals.coll),
                "kernels": sorted({r.name[7:] for r in cap.records
                                   if r.name.startswith("kernel.")}),
            },
            "roofline": roofline(totals, n_dev, pair.cfg, shape),
        })
    except Exception as e:                    # noqa: BLE001 (recorded)
        rec["error"] = f"{type(e).__name__}: {str(e)[:300]} at {_where(e)}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="production",
                    help="production (16x16, or 2x16x16 with --multi-pod) "
                         "or 1x1 (one device)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--tag", default="")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs, shapes cut (REDUCED_SEQ tokens, "
                         "a row per data shard)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs run in this many processes")
    args = ap.parse_args(argv)

    if args.mesh == "production":
        mesh_shape, axes = production_shape(args.multi_pod)
    elif args.mesh == "1x1":
        mesh_shape, axes = (1, 1), ("data", "model")
    else:
        raise SystemExit(f"--mesh takes production or 1x1, not {args.mesh}")
    overrides = json.loads(args.override) if args.override else None
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    t0 = time.perf_counter()
    jobs = [(a, s, mesh_shape, axes, overrides, None, args.reduced)
            for a in archs for s in shapes]
    if args.jobs > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.starmap(run_pair, jobs, chunksize=1)
    else:
        recs = (run_pair(*j) for j in jobs)
    for rec in recs:
        arch, shape_name = rec["arch"], rec["shape"]
        tag = ("-" + args.tag) if args.tag else ""
        fname = (f"{arch.replace('-', '_')}_{shape_name}_"
                 f"{rec['mesh']}{tag}.json")
        with open(os.path.join(args.out, fname), "w") as f:
            json.dump(rec, f, indent=1, default=str)
        if rec["ok"]:
            r, m = rec["roofline"], rec["memory"]
            print(f"OK   {arch:24s} {shape_name:12s} {rec['mesh']:8s} "
                  f"compute={r['compute_s']:.2e}s "
                  f"memory={r['memory_s']:.2e}s "
                  f"coll={r['collective_s']:.2e}s dom={r['dominant']:10s} "
                  f"peak/dev={m['peak_per_device'] / 2**30:.2f}GiB "
                  f"[{rec['trace_s']}s]", flush=True)
        else:
            n_fail += 1
            print(f"FAIL {arch:24s} {shape_name:12s} {rec['mesh']:8s} "
                  f"{rec['error']}", flush=True)
    print(f"dry-run: {len(archs) * len(shapes) - n_fail} ok, {n_fail} failed "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
