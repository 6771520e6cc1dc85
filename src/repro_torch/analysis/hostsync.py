"""R4 host-sync: the hot loop never blocks on the device (the JAX
package's ``analysis/hostsync.py``).

The engine's throughput rests on the host scheduler running ahead of the
device: every step is queued asynchronously, generated tokens are read
back only at ``_harvest``, and the decode feedback token stays on the
device (``last_tok``).  One ``.item()`` or implicit ``bool`` on a device
tensor inside the scheduling path serialises host and device.

Two checks:

**Static** (``HostSyncRule.check_source``): an AST scan of the port's
engine source (no execution) over the hot-loop methods (``HOT_METHODS``,
the reference's list and the port's ``_admit_slot`` and
``_timed_prefill``).  Device-rooted expressions are ``self.last_tok``,
``self.cache``, the ``self._pending`` records' tensors, and any local
assigned from a step body or the upload (``STEP_CALLS``), or looping over
a device-rooted value.  Flagged: ``.item()``, ``.cpu()``, ``.numpy()``,
``.tolist()`` on a device-rooted expression; ``int``/``float``/``bool``
or ``np.*`` of one; an ``if``/``while`` test on one; and
``torch.cuda.synchronize()`` outside an ``async_steps`` guard.
``_harvest`` and ``_quarantine_check`` are the allowed boundaries and
are not scanned; ``_preempt_slot``, ``cancel`` and ``_sweep_deadlines``
are scanned and harvest only through ``_harvest`` (ROADMAP C13).

**Dynamic** (``check_dynamic``, CUDA only): drive the engine under
``torch.cuda.set_sync_debug_mode("error")``, with the allowed methods
wrapped on the instance (the engine's source is not edited) so that they
lower the mode while they run.  This catches the syncs an AST cannot
see, inside the model and the kernels' wrappers: boolean-mask indexing,
``nonzero``, ``repeat_interleave`` without ``output_size``, a copy from
pageable host memory.  One device only: on a mesh every gloo collective
stages through host memory, so every collective syncs.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
import traceback

from repro_torch.analysis.framework import Rule

HOT_METHODS = ("step", "_step_unified", "_admit", "_admit_batched",
               "_admit_sequential", "_admit_paged", "_admit_slot",
               "_post_admit", "_timed_prefill", "_release_slot",
               "_prefix_insert", "_next_step_idx",
               "_ensure_decode_page", "_preempt_slot", "_running_rows",
               "_covered", "preempt", "cancel", "_terminate_slot",
               "_finish_slot", "_sweep_deadlines", "_quarantine")
DEVICE_ATTRS = ("last_tok", "cache", "_pending")
# calls whose results live on the device: the step bodies and the upload
STEP_CALLS = ("_unified", "_decode", "_prefill_batch", "_prefill_one",
              "_timed_prefill", "_upload", "_copy_pages")
# the documented sync points, which the dynamic check lets sync
ALLOWED = ("_harvest", "_quarantine_check")
_FORCING_BUILTINS = ("int", "float", "bool")
_FORCING_METHODS = ("item", "cpu", "numpy", "tolist")


def _engine_source() -> str:
    from repro_torch.serving import engine
    return inspect.getsource(engine)


class _MethodScan(ast.NodeVisitor):
    def __init__(self, rule, method: str, device_attrs):
        self.rule = rule
        self.method = method
        self.device_attrs = device_attrs
        self.tainted: set = set()
        self.findings: list = []
        self._async_guard_depth = 0

    # -- device-rootedness --------------------------------------------------

    def _rooted(self, node) -> bool:
        if isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in self.device_attrs):
                return True
            return self._rooted(node.value)
        if isinstance(node, ast.Subscript):
            return self._rooted(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._rooted(e) for e in node.elts)
        return False

    def _taint(self, tgt) -> None:
        for el in ([tgt] if not isinstance(tgt, (ast.Tuple, ast.List))
                   else tgt.elts):
            if isinstance(el, ast.Starred):
                el = el.value
            if isinstance(el, ast.Name):
                self.tainted.add(el.id)

    def _collect_taint(self, fn: ast.FunctionDef):
        # two passes so a = body(...); b = a chains resolve
        for _ in range(2):
            for node in ast.walk(fn):
                if isinstance(node, ast.For) and self._rooted(node.iter):
                    self._taint(node.target)
                if not isinstance(node, ast.Assign):
                    continue
                val = node.value
                from_step = (isinstance(val, ast.Call)
                             and isinstance(val.func, ast.Attribute)
                             and val.func.attr in STEP_CALLS)
                if from_step or self._rooted(val):
                    for tgt in node.targets:
                        self._taint(tgt)

    # -- violations ---------------------------------------------------------

    def _flag(self, node, what: str):
        self.findings.append(self.rule.finding(
            f"engine.{self.method}",
            f"{what} at line {node.lineno} — blocking device->host sync "
            "in the hot loop (only _harvest may read back)",
            method=self.method, line=node.lineno, what=what))

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _FORCING_METHODS and self._rooted(f.value):
                self._flag(node, f".{f.attr}() on a device tensor")
            elif (f.attr == "synchronize"
                  and "cuda" in ast.dump(f.value)):
                if self._async_guard_depth == 0:
                    self._flag(node, "torch.cuda.synchronize() outside an "
                                     "async_steps guard")
            elif (isinstance(f.value, ast.Name) and f.value.id == "np"
                  and any(self._rooted(a) for a in node.args)):
                self._flag(node, f"np.{f.attr}() on a device tensor")
        elif (isinstance(f, ast.Name) and f.id in _FORCING_BUILTINS
              and any(self._rooted(a) for a in node.args)):
            self._flag(node, f"{f.id}() on a device tensor")
        self.generic_visit(node)

    def _visit_test(self, node):
        if self._rooted(node.test):
            self._flag(node, "implicit bool() of a device tensor in a "
                             "branch test")

    def visit_If(self, node: ast.If):
        self._visit_test(node)
        guarded = "async_steps" in ast.dump(node.test)
        if guarded:
            self._async_guard_depth += 1
        for child in node.body:
            self.visit(child)
        if guarded:
            self._async_guard_depth -= 1
        for child in node.orelse:
            self.visit(child)
        self.visit(node.test)

    def visit_While(self, node: ast.While):
        self._visit_test(node)
        self.generic_visit(node)


class HostSyncRule(Rule):
    rule_id = "R4"
    name = "host-sync"
    description = ("no blocking device->host reads in hot-loop methods "
                   "outside harvest boundaries")
    requires = "source"

    def __init__(self, methods=HOT_METHODS, device_attrs=DEVICE_ATTRS):
        self.methods = methods
        self.device_attrs = device_attrs

    def check_source(self, source: str | None = None,
                     program: str = "serving/engine.py") -> list:
        tree = ast.parse(textwrap.dedent(source if source is not None
                                         else _engine_source()))
        findings = []
        for node in ast.walk(tree):
            if (isinstance(node, ast.FunctionDef)
                    and node.name in self.methods):
                scan = _MethodScan(self, node.name, self.device_attrs)
                scan._collect_taint(node)
                for stmt in node.body:
                    scan.visit(stmt)
                findings.extend(scan.findings)
        return findings

    def check_dynamic(self, eng, workload, program: str = "engine") -> list:
        """Run ``workload(eng)`` with every CUDA sync an error outside the
        ``ALLOWED`` methods; returns the first sync as a finding, with the
        innermost frame of the port that made it."""
        import torch
        if eng.device.type != "cuda" or eng.mesh is not None:
            raise ValueError("the dynamic host-sync check runs on one CUDA "
                             "device")

        def lowered(fn):
            def run(*a, **kw):
                torch.cuda.set_sync_debug_mode(0)
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("error")
            return run

        for name in ALLOWED:
            setattr(eng, name, lowered(getattr(eng, name)))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            workload(eng)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            frames = [f for f in traceback.extract_tb(e.__traceback__)
                      if "repro_torch" in f.filename
                      and "analysis" not in f.filename]
            where = (f"{frames[-1].filename.split('src/')[-1]}:"
                     f"{frames[-1].lineno}" if frames else "?")
            return [self.finding(
                program, f"a device sync in the hot loop at {where}: "
                f"{str(e).splitlines()[0][:120]}", where=where,
                what="sync_debug_mode")]
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for name in ALLOWED:
                eng.__dict__.pop(name, None)
        return []
