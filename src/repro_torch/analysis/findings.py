"""Typed findings for the homecheck locality analyzer (a copy of
`repro/analysis/findings.py`; the wording of R3, R5 and R8 speaks of the
port's kernel launches).

A `Finding` is one violation of the cache-home contract, tagged with the
rule that produced it (R1-R11), a severity, the offending op, and the
predicted-vs-actual byte counts where the rule is quantitative.  A `Report`
bundles the findings of one analyzed program together with the context
(workload, policy, mesh) they were produced under; ``report.clean`` is the
CI contract — no findings at WARN severity or above.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class Severity(enum.IntEnum):
    """Ordered: higher is worse.  ERROR fails CI (CLI exit 1)."""
    INFO = 0
    WARN = 1
    ERROR = 2


RULES = {
    "R1": "surprise-collective: HLO collective not budgeted by "
          "exchange_schedule (kind/count/bytes diff)",
    "R2": "home-leak: collective device groups vary over a mesh axis the "
          "locale never declared (GSPMD resharding of homed values)",
    "R3": "smem-budget: a kernel launch's static + dynamic shared memory "
          "exceeds the per-block ceiling",
    "R4": "donation-audit: large step-carried buffer copied across steps "
          "(an output with the exact shape of an input, in fresh storage)",
    "R5": "write-race/coverage: a kernel launch's output tile maps must "
          "partition the output over its blocks (overlap = race ERROR, "
          "gap = WARN) and input tiles must stay in bounds",
    "R6": "network-certification: the engine's exchange network is a "
          "structurally sound sorting network, 0-1-certified on every "
          "supported mesh up to 16 devices",
    "R7": "index-arithmetic: merge-path ranks must fit the index dtype at "
          "declared block sizes; the BIG sentinel must be representable "
          "and tie-stable in the key dtype",
    "R8": "grid-dead-lane: a branch on blockIdx that no block of the grid "
          "takes (code that never runs)",
    "R9": "scheduler-certification: the serving scheduler's pure "
          "transitions exhaustively certified (I1-I7: off-home moves "
          "charged, starvation <= max_skip, work conservation, eviction "
          "never migrates, no double-booking, charges == replayed moves, "
          "minimal spill donor) over the small-config lattice",
    "R10": "device-live-range: a call's peak live device bytes exceed "
           "the declared ceiling "
           "(repro_torch.kernels.HBM_BYTES_PER_DEVICE)",
    "R11": "collective-control-flow: ranks that issue different "
           "collectives (deadlock), or whose collectives' count depends "
           "on the data",
}


def normalize_rules(rules) -> Tuple[str, ...]:
    """Resolve a rule filter (None / 'all' / ids) to canonical rule ids."""
    if rules is None or rules == "all" or "all" in tuple(rules):
        return tuple(RULES)
    out = []
    for r in ([rules] if isinstance(rules, str) else rules):
        for part in str(r).replace(",", " ").split():
            rid = part.upper()
            if rid not in RULES:
                raise ValueError(f"unknown rule {part!r}; "
                                 f"known: {', '.join(RULES)}")
            if rid not in out:
                out.append(rid)
    return tuple(out)


@dataclass(frozen=True)
class Finding:
    rule: str                       # "R1".."R11"
    severity: Severity
    op: str                         # HLO opcode / primitive name
    shape: str = ""                 # offending value's type string
    predicted_bytes: Optional[float] = None
    actual_bytes: Optional[float] = None
    message: str = ""

    def format(self) -> str:
        pa = ""
        if self.predicted_bytes is not None or self.actual_bytes is not None:
            fmt = lambda b: "-" if b is None else f"{b:,.0f}B"
            pa = (f" predicted={fmt(self.predicted_bytes)}"
                  f" actual={fmt(self.actual_bytes)}")
        shape = f" {self.shape}" if self.shape else ""
        return (f"[{self.rule} {self.severity.name}] {self.op}{shape}{pa}"
                f" — {self.message}")


@dataclass
class Report:
    """Findings of one homecheck run plus the context they apply to."""
    target: str                                  # e.g. "sort[shard_map]"
    context: Dict = field(default_factory=dict)  # policy/mesh/n/backend...
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[str] = field(default_factory=list)   # rule ids filtered
    notes: List[str] = field(default_factory=list)        # e.g. "R1 skipped"

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    @property
    def clean(self) -> bool:
        """No findings at WARN or above — the CI-gating predicate."""
        return not any(f.severity >= Severity.WARN for f in self.findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.ERROR]

    def suppress(self, rules: Sequence[str]) -> "Report":
        """Drop findings of the given rule ids (recorded in `suppressed`)."""
        rules = tuple(rules or ())
        if not rules:
            return self
        kept = [f for f in self.findings if f.rule not in rules]
        dropped = sorted({f.rule for f in self.findings if f.rule in rules})
        self.findings = kept
        self.suppressed.extend(dropped)
        return self

    def format(self, verbose: bool = False) -> str:
        head = f"homecheck {self.target}"
        ctx = ", ".join(f"{k}={v}" for k, v in self.context.items())
        if ctx:
            head += f" ({ctx})"
        lines = [head]
        for f in sorted(self.findings, key=lambda f: -f.severity):
            lines.append("  " + f.format())
        for n in self.notes if verbose else []:
            lines.append(f"  note: {n}")
        if self.suppressed:
            lines.append(f"  suppressed rules: {', '.join(self.suppressed)}")
        if not self.findings:
            lines.append("  clean: no findings")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "target": self.target, "context": self.context,
            "clean": self.clean, "suppressed": self.suppressed,
            "notes": self.notes,
            "findings": [{
                "rule": f.rule, "severity": f.severity.name, "op": f.op,
                "shape": f.shape, "predicted_bytes": f.predicted_bytes,
                "actual_bytes": f.actual_bytes, "message": f.message,
            } for f in self.findings]}, indent=2)


def summarize(reports: Sequence[Report]) -> Tuple[int, int]:
    """(#reports with any finding, #ERROR findings) across a sweep."""
    dirty = sum(1 for r in reports if r.findings)
    errors = sum(len(r.errors) for r in reports)
    return dirty, errors
