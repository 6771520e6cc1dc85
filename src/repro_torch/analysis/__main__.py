"""The command line: ``python -m repro_torch.analysis`` (the JAX package's
``python -m repro.analysis``).

Traces one step of each of the engine's serving programs (decode /
unified / paged / int8 / paged_kernel, the reduced config), runs every
rule, prints the report, and exits 1 on any error finding.

  python -m repro_torch.analysis                       # on the card
  python -m repro_torch.analysis --device cpu --programs decode,int8 --rules R1,R5
  python -m repro_torch.analysis --device cpu --warn-only R2 --json report.json
  python -m repro_torch.analysis --device cpu --ep 2 --data 2

On the CPU the default program list leaves ``paged_kernel`` out and says
so: there the kernel's plain version gathers the virtual cache, which R1
reports (its tripwire; ask for it with ``--programs paged_kernel``).
``--ep``/``--data`` spawn ``ep * data`` gloo rank processes on a
(data, model) mesh (``launch/mesh.py``, meeting through a file store in a
temporary directory); each rank traces its own programs and the report
holds every rank's findings.  R4's dynamic check runs on one CUDA device
only.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import RULE_IDS, cli_report, mesh_report

ALL_PROGRAMS = "decode,unified,paged,int8,paged_kernel"


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="rule-based analysis of the engine's serving programs")
    p.add_argument("--arch", default="qwen3_moe_30b_a3b")
    p.add_argument("--programs", default=None,
                   help=f"comma list of {ALL_PROGRAMS} (default: all; on "
                        "the CPU all but paged_kernel)")
    p.add_argument("--rules", default=",".join(RULE_IDS),
                   help="comma list of rule ids to run")
    p.add_argument("--warn-only", default="",
                   help="comma list of rule ids demoted to warnings")
    p.add_argument("--json", dest="json_path", default="",
                   help="write the machine-readable report here "
                        "('-' for stdout)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert (model) shards: rank processes on a mesh")
    p.add_argument("--data", type=int, default=1,
                   help="data shards of the mesh")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    from repro_torch.models.model import resolve_device
    resolve_device(args.device)
    world = max(args.ep, 1) * max(args.data, 1)
    if args.programs is None:
        variants = ALL_PROGRAMS.split(",")
        if args.device == "cpu":
            variants.remove("paged_kernel")
            print("leaving paged_kernel out on the CPU: its plain page walk "
                  "gathers the virtual cache R1 reports (ask for it with "
                  "--programs paged_kernel)")
    else:
        variants = [v.strip() for v in args.programs.split(",") if v.strip()]
    print(f"tracing programs: {', '.join(variants)} (arch {args.arch} on "
          f"{args.device}{f', mesh of {world} ranks' if world > 1 else ''})",
          flush=True)
    report = (mesh_report(args, variants) if world > 1
              else cli_report(args, variants))
    print(report.summary())
    if args.json_path == "-":
        print(report.to_json())
    elif args.json_path:
        with open(args.json_path, "w") as fh:
            fh.write(report.to_json())
        print(f"report written to {args.json_path}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
