"""Finding / Rule / Report: the common core every analysis rule feeds
(the JAX package's ``analysis/framework.py``, kept as the port's own copy).

A ``Rule`` inspects one traced program (or the engine, or its source) and
returns ``Finding``s.  ``run_rules`` fans a rule set over a program set,
applies severity overrides (``warn_only``), and folds everything into a
``Report`` that the CLI prints and gates on (``report.ok``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or observation), machine-readable.

    ``rule`` is the stable id ("R1".."R6"), ``name`` the human slug
    ("donation-alias"), ``program`` the traced program it was found in
    ("decode", "unified", ... or "engine" / "source" for the rules that
    take no traced program).  ``detail`` carries rule-specific structured
    context (leaf paths, byte counts, op names, line numbers)."""
    rule: str
    name: str
    severity: str
    program: str
    message: str
    detail: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"[{self.severity.upper():7s}] {self.rule} "
                f"{self.name} @ {self.program}: {self.message}")


class Rule:
    """Base class.  Subclasses set ``rule_id`` / ``name`` / ``requires``
    and implement ``check(program)``.

    ``requires`` declares the input the rule consumes:
      * "ops"    — a ``TracedProgram``: the op stream of one engine step
                   (``launch/opcount.capture``) and its tree facts
      * "engine" — a live ServingEngine to drive (R3)
      * "source" — the engine's Python source (R4)
    The runner only hands a rule inputs of its declared kind."""
    rule_id = "R0"
    name = "base"
    description = ""
    requires = "ops"
    default_severity = "error"

    def check(self, program) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, program: str, message: str, *, severity: str | None = None,
                **detail) -> Finding:
        return Finding(rule=self.rule_id, name=self.name,
                       severity=severity or self.default_severity,
                       program=program, message=message, detail=detail)


@dataclasses.dataclass
class Report:
    findings: list = dataclasses.field(default_factory=list)
    programs: list = dataclasses.field(default_factory=list)
    rules: list = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self, rule_id: str) -> list:
        return [f for f in self.findings if f.rule == rule_id]

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "programs": list(self.programs),
            "rules": list(self.rules),
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str, **kw)

    def summary(self) -> str:
        lines = [f"analysis: {len(self.rules)} rules x "
                 f"{len(self.programs)} programs -> "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        for f in self.findings:
            lines.append("  " + str(f))
        if not self.findings:
            lines.append("  clean: no findings")
        return "\n".join(lines)


def _demote(findings: Iterable[Finding], warn_only: set) -> list[Finding]:
    out = []
    for f in findings:
        if f.rule in warn_only and f.severity == "error":
            f = dataclasses.replace(f, severity="warning")
        out.append(f)
    return out


def run_rules(rules, programs, *, warn_only: Iterable[str] = ()) -> Report:
    """Run every op-stream rule over every traced program.

    Rules with ``requires`` other than "ops" (engine- and source-level
    rules) are the caller's job — they take no traced program; pass their
    findings through ``Report.findings`` directly or demote them with
    ``demote_findings``."""
    warn_only = set(warn_only)
    rep = Report(programs=[p.name for p in programs],
                 rules=[r.rule_id for r in rules])
    for rule in rules:
        if rule.requires != "ops":
            continue
        for prog in programs:
            rep.findings.extend(_demote(rule.check(prog), warn_only))
    return rep


def demote_findings(findings, warn_only: Iterable[str]) -> list[Finding]:
    """Public severity-override helper for engine/source-level findings."""
    return _demote(findings, set(warn_only))
