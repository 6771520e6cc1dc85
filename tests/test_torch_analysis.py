"""The port's analysis rules (``repro_torch.analysis``) on the CPU: clean on
the port's real programs, and every rule fires on a planted violation,
case by case as ``tests/test_analysis.py`` holds the JAX package's.

R1, R2, R5 and R6 read one traced step (``analysis/programs.py``); a
planted violation is a ``dataclasses.replace`` of it with an extra op
record or counter entry, as the reference splices HLO lines, or a step
that really clones a cache leaf.  R3 drives live engines, and after the
same drive the port's ``trace_counts`` equal the JAX engine's.  R4 scans
the engine's source and planted source.  R5's three hand-built cases give
the keys the reference's ``check_closed_jaxpr`` gives on their JAX
versions.  R2 and R6 on a mesh ride the rank spawn of
``tests/test_torch_serve_mesh.py``."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import programs as jax_programs
from repro.analysis.quant_integrity import check_closed_jaxpr
from repro.analysis.retrace import drive_engine as jax_drive
from repro.analysis.retrace import expected_trace_budget as jax_budget
from repro.core import quant as jax_quant
from repro_torch.analysis import framework, programs
from repro_torch.analysis.collectives import CollectiveBudgetRule
from repro_torch.analysis.donation import (DonationAliasRule,
                                           virtual_cache_traffic)
from repro_torch.analysis.hostsync import HostSyncRule
from repro_torch.analysis.quant_integrity import QuantIntegrityRule, keys_of
from repro_torch.analysis.retrace import (RetraceRule, drive_engine,
                                          expected_trace_budget)
from repro_torch.analysis.sharding_lint import (ShardingLintRule,
                                                expert_gather_threshold)
from repro_torch.core import quant
from repro_torch.launch.opcount import OpRecord
from torch_archs import one_torch_thread  # noqa: F401

ARCH = "qwen3_moe_30b_a3b"
REPO = pathlib.Path(__file__).resolve().parents[1]
CPU_PROGRAMS = ("decode", "unified", "paged", "int8")


@pytest.fixture(scope="module")
def progs():
    return {v: programs.trace_program(v, ARCH, device="cpu")
            for v in CPU_PROGRAMS}


def _op(name: str, nbytes: int, *, reading=(), dtype=torch.float32):
    """A planted op record allocating one ``nbytes`` buffer."""
    n = nbytes // torch.tensor([], dtype=dtype).element_size()
    return OpRecord(name=name, out_shapes=((n,),), out_dtypes=(dtype,),
                    out_bytes=nbytes, new_bytes=(nbytes,), in_bytes=0,
                    inplace=False, view=False, storages=(None,),
                    in_storages=tuple(reading), inputs=(), outputs=(-1,))


def _plant(prog, *records, **fields):
    return dataclasses.replace(prog, records=prog.records + list(records),
                               **fields)


# ---------------------------------------------------------------------------
# framework


class _BoomRule(framework.Rule):
    rule_id = "RX"
    name = "boom"

    def check(self, prog):
        return [self.finding(prog.name, "boom", tag=1)]


def test_framework_report_and_warn_only():
    progs_ = [SimpleNamespace(name="p1"), SimpleNamespace(name="p2")]
    rep = framework.run_rules([_BoomRule()], progs_)
    assert not rep.ok and len(rep.errors) == 2 and rep.by_rule("RX")
    demoted = framework.run_rules([_BoomRule()], progs_, warn_only={"RX"})
    assert demoted.ok and len(demoted.warnings) == 2
    d = json.loads(demoted.to_json())
    assert d["ok"] and d["n_warnings"] == 2
    assert d["findings"][0]["detail"] == {"tag": 1}
    assert "RX" in str(demoted.findings[0])


# ---------------------------------------------------------------------------
# R1 donation-alias


@pytest.mark.parametrize("variant", CPU_PROGRAMS)
def test_r1_clean_on_real_programs(progs, variant):
    prog = progs[variant]
    assert prog.records and prog.cache_ptrs_before == prog.cache_ptrs_after
    assert DonationAliasRule().check(prog) == []


def test_r1_flags_a_cloned_cache_leaf():
    """A step that replaces a cache leaf by its clone: the leaf leaves its
    storage (a) and a leaf-sized buffer is copied out of the cache (b)."""
    eng = programs.build_engine("paged", ARCH, device="cpu")

    def step(*args):
        eng.cache["k"] = eng.cache["k"].clone()
        return programs.run_step(eng, args)

    prog = programs.trace_engine(eng, "paged", step=step)
    checks = sorted(f.detail["check"] for f in DonationAliasRule().check(prog))
    assert checks == ["a", "b"]


def test_r1_flags_planted_cache_copy(progs):
    prog = progs["decode"]
    nb = max(prog.cache_bytes)
    planted = _plant(prog, _op("clone", nb, reading=prog.cache_storages[:1]))
    findings = DonationAliasRule().check(planted)
    assert [f.detail["check"] for f in findings] == ["b"]
    assert findings[0].detail["bytes"] == nb
    # a buffer of the same size that reads no cache leaf is not a copy
    # of the cache (an eager step allocates every intermediate)
    assert DonationAliasRule().check(_plant(prog, _op("silu", nb))) == []


def test_r1_virtual_cache_tripwire():
    """On the CPU the paged kernel's plain version gathers the
    (B, NB*page_size, Hkv, hd) virtual cache of every pool leaf: R1(c)
    fires there (on the card the kernel allocates none).  The paged
    program at the same geometry has the same gathers and is not linted
    for them."""
    kern = programs.trace_program("paged_kernel", ARCH, device="cpu")
    traffic = virtual_cache_traffic(kern)
    assert traffic and all(kind == "gather" for kind, _, _ in traffic)
    findings = DonationAliasRule().check(kern)
    assert findings and {f.detail["check"] for f in findings} == {"c"}
    gather = programs.trace_program(
        "paged", ARCH, device="cpu",
        ecfg_kw=dict(page_size=kern.ecfg.page_size,
                     num_pages=kern.ecfg.num_pages))
    assert virtual_cache_traffic(gather)
    assert DonationAliasRule().check(gather) == []


# ---------------------------------------------------------------------------
# R2 collective-bytes


def test_r2_clean_on_single_device(progs):
    for prog in progs.values():
        assert prog.coll == {} and CollectiveBudgetRule().check(prog) == []


def test_r2_flags_planted_collective(progs):
    planted = dataclasses.replace(progs["decode"],
                                  coll={"all-reduce": 4 * 4096 * 4})
    findings = CollectiveBudgetRule().check(planted)
    assert [f.detail["kind"] for f in findings] == ["all-reduce"]
    assert findings[0].severity == "error"
    assert findings[0].detail["actual"] == 4 * 4096 * 4


# ---------------------------------------------------------------------------
# R3 retrace


def test_r3_clean_then_flags_undocumented_width():
    eng = programs.build_engine("unified", ARCH, device="cpu")
    assert RetraceRule().check_engine(eng) == []
    assert expected_trace_budget(eng) == {"unified": 2}
    # a ragged chunk width (neither chunk_len nor 1) is a new signature
    b = eng.ecfg.max_batch
    ivec = torch.zeros((b,), dtype=torch.int32)
    bvec = torch.zeros((b,), dtype=torch.bool)
    fvec = torch.zeros((b,), dtype=torch.float32)
    with torch.no_grad():
        eng._unified(torch.zeros((b, 3), dtype=torch.int32), ivec, ivec,
                     None, bvec, bvec, fvec, ivec, None, 0)
    findings = RetraceRule(workload=None).check_engine(eng)
    assert [f.detail["body"] for f in findings] == ["unified"]
    assert findings[0].detail["count"] == 3


@pytest.mark.parametrize("variant", ["paged", "decode"])
def test_r3_counts_equal_the_jax_engine(variant):
    """After the same drive (admission, chunked prefill, decode, a paged
    preempt and restore, a NaN-quarantine retry), the port's signature
    counts equal the JAX engine's trace counts, and the budgets agree:
    the unified paged engine and the two-program engine."""
    ref = jax_programs.build_engine(variant, ARCH)
    jax_drive(ref)
    eng = programs.build_engine(variant, ARCH, device="cpu")
    drive_engine(eng)
    assert dict(eng.trace_counts) == dict(ref.trace_counts)
    assert expected_trace_budget(eng) == jax_budget(ref)
    assert RetraceRule(workload=None).check_engine(eng) == []


# ---------------------------------------------------------------------------
# R4 host-sync

_PLANTED_SOURCE = '''
class Fake:
    def step(self):
        out = self._decode(self.params, self.cache)
        tok = out
        n = int(self.last_tok[0])
        v = tok.item()
        w = np.asarray(self.cache)
        x = self.last_tok.cpu()
        if tok:
            pass
        torch.cuda.synchronize()
        if self.ecfg.async_steps > 0:
            torch.cuda.synchronize()
        for rec in self._pending:
            y = rec.tok.tolist()

    def _harvest(self):
        return self.last_tok.item()
'''


def test_r4_clean_on_engine_source():
    findings = HostSyncRule().check_source()
    assert findings == [], [str(f) for f in findings]


def test_r4_flags_planted_syncs():
    findings = HostSyncRule().check_source(_PLANTED_SOURCE)
    whats = [f.detail["what"] for f in findings]
    assert "int() on a device tensor" in whats
    assert ".item() on a device tensor" in whats
    assert "np.asarray() on a device tensor" in whats
    assert ".cpu() on a device tensor" in whats
    assert ".tolist() on a device tensor" in whats
    assert "implicit bool() of a device tensor in a branch test" in whats
    # exactly one unguarded synchronize: the async_steps-guarded one is
    # the documented sync point
    assert len([w for w in whats if "synchronize" in w]) == 1
    # _harvest is the allowed boundary and is never scanned
    assert all(f.detail["method"] == "step" for f in findings)


def test_r4_dynamic_check_refuses_the_cpu():
    eng = programs.build_engine("unified", ARCH, device="cpu")
    with pytest.raises(ValueError, match="one CUDA device"):
        HostSyncRule().check_dynamic(eng, drive_engine)


# ---------------------------------------------------------------------------
# R5 quant integrity: the reference's three cases on both sides


def _weights(d=64, dout=48, block=32):
    w = jnp.linspace(-1.0, 1.0, d * dout).reshape(d, dout)
    q, s = jax_quant.absmax_quantize(w, bits=8, block=block, axis=-2)
    ref = jax_quant.QuantTensor(q, s, 8, block, d, "float32")
    port = quant.QuantTensor(torch.from_numpy(np.array(q)),
                             torch.from_numpy(np.array(s)), 8, block, d,
                             "float32")
    return ref, port


def _jax_keys(fn, x, qt):
    leaves = jax_programs.quant_leaf_map((x, qt))
    found = []
    check_closed_jaxpr(jax.make_jaxpr(fn)(x, qt), leaves,
                       lambda key, kw: found.append(key))
    return found


def _jax_bad_dequant(x, qt):
    scale = jnp.repeat(qt.scale, qt.block, axis=-2)
    w = qt.data.astype(jnp.float32) * scale
    w = w + 0.0
    return x @ w


def _port_bad_dequant(x, qt):
    scale = torch.repeat_interleave(qt.scale, qt.block, dim=-2)
    w = qt.data.float() * scale
    w = w + 0.0
    return x @ w


R5_CASES = {
    "qdot": (lambda x, qt: jax_quant.qdot("td,dk->tk", x, qt),
             lambda x, qt: quant.qdot(x, qt), []),
    "detached": (lambda x, qt: x @ qt.data.astype(jnp.float32),
                 lambda x, qt: x @ qt.data.float(), [("detached", 1)]),
    "materialized": (_jax_bad_dequant, _port_bad_dequant,
                     [("materialized", 1)]),
}


@pytest.mark.parametrize("case", list(R5_CASES))
def test_r5_keys_equal_the_reference(case):
    jax_fn, port_fn, want = R5_CASES[case]
    ref, port = _weights()
    assert programs.quant_leaf_map((torch.ones(4, 64), port))[0].data_idx \
        == jax_programs.quant_leaf_map((jnp.ones((4, 64)), ref))[0].data_idx
    got_ref = _jax_keys(jax_fn, jnp.ones((4, 64)), ref)
    x = torch.ones((4, 64))
    got = keys_of(port_fn, (x, port), (x, port))
    assert got == got_ref == want


def test_r5_clean_on_real_int8_program(progs):
    prog = progs["int8"]
    assert prog.quant_leaves, "the int8 engine must hold QuantTensor leaves"
    assert all(q.data_serial >= 0 and q.scale_serial >= 0
               for q in prog.quant_leaves)
    assert QuantIntegrityRule().check(prog) == []


def test_r5_flags_a_detached_payload_in_the_int8_program(progs):
    """The real program with one planted product of a payload alone."""
    prog = progs["int8"]
    q = prog.quant_leaves[0]
    planted = _plant(prog, dataclasses.replace(
        _op("mm", 64), inputs=(q.data_serial,)))
    findings = QuantIntegrityRule().check(planted)
    assert [tuple(f.detail["key"]) for f in findings] == [
        ("detached", q.data_idx)]


# ---------------------------------------------------------------------------
# R6 sharding lint


def test_r6_clean_and_flags_planted_expert_gather(progs):
    prog = progs["decode"]
    assert ShardingLintRule().check(prog) == []
    thr = expert_gather_threshold(prog)
    assert thr and thr > 0
    planted = _plant(prog, dataclasses.replace(
        _op("coll.all-gather", thr), new_bytes=()))
    findings = ShardingLintRule().check(planted)
    assert len(findings) == 1 and findings[0].detail["bytes"] >= thr


# ---------------------------------------------------------------------------
# CLI


def _cli(*argv, tmp_path=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *argv], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)


def test_cli_end_to_end(tmp_path):
    out = tmp_path / "report.json"
    r = _cli("--device", "cpu", "--programs", "decode", "--rules",
             "R1,R2,R4,R6", "--json", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["n_errors"] == 0
    assert rep["rules"] == ["R1", "R2", "R4", "R6"]
    assert rep["programs"] == ["decode"]


def test_cli_reports_the_cpu_tripwire():
    """Asked for paged_kernel on the CPU, the CLI reports R1(c) and exits
    1; by default it leaves the program out and says so."""
    r = _cli("--device", "cpu", "--programs", "paged_kernel", "--rules",
             "R1")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "virtual-cache-sized gather" in r.stdout
    r = _cli("--device", "cpu", "--rules", "R4")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "leaving paged_kernel out on the CPU" in r.stdout
