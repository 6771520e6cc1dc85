"""R5 QuantTensor integrity: data and scale stay married (the JAX
package's ``analysis/quant_integrity.py``).

A QuantTensor is a pair of tensors, an int8 (or packed int4) payload and
its per-block fp32 scales, and correctness rests on two dataflow facts
the types cannot see:

  1. every product that consumes the payload also consumes its OWN scale
     (a detached or swapped scale silently rescales the weights);
  2. the full dequantized weight is never materialised outside the
     ``qdot`` policy point (materialising it re-spends the memory the
     store exists to save: the paper's Table 2 budget).

The reference checks both by taint propagation over the jaxpr.  The port
propagates taint over the op stream of one traced step
(``launch/opcount``): each payload's tensor seeds token ``("d", i)``, its
scale ``("s", i)`` (``i`` the payload's flat leaf index, as in the
reference), and every op's outputs take the union of its operands'
taints.  At each ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` an operand
tainted by ``d_i`` must also carry ``s_i``.  A float output of at least
leaf i's logical element count tainted by ``d_i`` is a full dequantized
weight; in an eager stream its consumers are known only after the step,
so they are read from the records afterwards: each must be the qdot chain
itself (``QDOT_CONSUMERS``: the products, ``mul`` by the scales, the
dtype casts, and the views that move no data, ``narrow``'s ``slice`` and
``matmul``'s ``expand`` among them).

On the card the quantized FFN's launch goes through ctypes and is
invisible to the dispatch mode: its operands' taints end at the wrapper,
and R5 sees the glue around it (the router, attention and the dense
products, which dequantize through ``qdot``).  On the CPU the kernel's
plain version runs in aten ops and R5 sees all of it.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.framework import Rule

PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm"})
QDOT_CONSUMERS = PRODUCTS | frozenset(
    {"mul", "_to_copy", "to", "t", "transpose", "view", "reshape",
     "_unsafe_view", "slice", "expand", "alias"})


def check_records(records, quant_leaves, emit) -> None:
    """Propagate the leaves' taints over ``records`` and report each
    violation once through ``emit(key, detail)``, key ("detached", i) or
    ("materialized", i)."""
    leaves = {q.data_idx: q for q in quant_leaves}
    env: dict = {}
    for q in quant_leaves:
        env[q.data_serial] = frozenset({("d", q.data_idx)})
        env.setdefault(q.scale_serial, frozenset())
        env[q.scale_serial] = env[q.scale_serial] | {("s", q.data_idx)}
    seen: set = set()

    def report(key, **kw):
        if key not in seen:
            seen.add(key)
            emit(key, kw)

    full: dict = {}               # serial -> leaf index of a full weight
    for rec in records:
        taints = [env.get(s, frozenset()) for s in rec.inputs]
        if rec.name in PRODUCTS:
            for t in taints:
                scales = {i for kind, i in t if kind == "s"}
                for kind, i in t:
                    if kind == "d" and i not in scales:
                        report(("detached", i), leaf=leaves[i].path,
                               reason=f"{rec.name} operand tainted by "
                                      f"{leaves[i].path}.data without its "
                                      ".scale")
        for s in rec.inputs:
            i = full.get(s)
            if i is not None and rec.name not in QDOT_CONSUMERS:
                report(("materialized", i), leaf=leaves[i].path,
                       reason=f"full dequantized weight of "
                              f"{leaves[i].path} consumed by {rec.name} — "
                              "outside the qdot policy point")
        union = frozenset().union(*taints) if taints else frozenset()
        for s, shape, dt in zip(rec.outputs, rec.out_shapes,
                                rec.out_dtypes):
            env[s] = env.get(s, frozenset()) | union
            if not dt.is_floating_point:
                continue
            n = 1
            for d in shape:
                n *= d
            for kind, i in union:
                if kind == "d" and n >= leaves[i].full_elems:
                    full[s] = i


class QuantIntegrityRule(Rule):
    rule_id = "R5"
    name = "quant-integrity"
    description = ("data/scale siblings enter products together; no full "
                   "dequantized weight outside qdot")
    requires = "ops"

    def check(self, prog):
        if not prog.quant_leaves:
            return []
        findings = []

        def emit(key, kw):
            findings.append(self.finding(prog.name, kw.pop("reason"),
                                         key=list(key), **kw))

        check_records(prog.records, prog.quant_leaves, emit)
        return findings


def keys_of(fn, args, params) -> list:
    """The violation keys of ``fn(*args)`` with the QuantTensors of
    ``params`` (a tuple of leaves, as the reference's tests build them)
    seeded: the port's counterpart of the reference's
    ``check_closed_jaxpr`` over ``jax.make_jaxpr(fn)``."""
    from repro_torch.analysis import programs
    from repro_torch.launch import opcount
    with torch.no_grad():
        cap = opcount.capture(fn, *args,
                              watch=programs.watch_tensors(params))
    found = []
    check_records(cap.records, programs.seeded_leaves(params, cap.watched),
                  lambda key, kw: found.append(key))
    return found
