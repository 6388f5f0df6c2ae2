"""Rules R1-R4: the collectives of a rank, the launches and buffers of a call.

R1 surprise-collective and R2 home-leak are copies of the reference's
(`repro/analysis/rules.py:42-125`, with `_varied_axes` and the R1
tolerances).  The reference feeds them the collective ops of a lowered
module's HLO; the port feeds them a rank's collective log
(`core.collectives`, one record per call in the same shape: ``kind`` as
an HLO opcode, ``groups`` as rank lists, ``mult``, ``wire_bytes``), so R1
diffs what a rank really sent against `engine.collective_census`, and R2
the ranks each call spans against the locale's declared axes.

R3 is the counterpart of `r3_vmem_budget`.  The TPU rule compares each
`pallas_call`'s resident blocks and scratch with the per-core VMEM
ceiling; on an H100 the scarce on-chip store is a block's shared memory,
so each launch's static plus dynamic shared memory is checked against
`repro_torch.kernels.SMEM_BYTES_PER_BLOCK` (232,448 B, the most one block
may opt into).  A launch above it would be refused by the card at run
time; the rule refuses it from the plan.

R4 donation-audit is the counterpart of `r4_donation_audit`
(`repro/analysis/rules.py:144-164`, with `R4_MIN_BYTES`).  The reference
flags a large entry parameter whose type reappears among the outputs
without a donation alias: XLA copies it every step.  The port's donation
contract is `Locale.jit` / `core.localisation.donate_buffers` (a donated
argument may have its storage reused); the facts are what the call did
(`mem_facts.call_facts`'s aliasing): an argument of at least
`R4_MIN_BYTES` that comes back same-shaped and same-typed in fresh
storage only was copied, and one that comes back in its own storage was
written in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.analysis.findings import Finding, Report, Severity
from repro_torch.analysis.launches import LaunchFacts

# R1 byte tolerance: the schedule is exact on CPU SPMD lowerings; allow a
# whisker for layout padding on other backends.
R1_REL_TOL = 0.02
R1_ABS_TOL = 4096.0

R4_MIN_BYTES = float(1 << 20)           # audit buffers >= 1 MiB


def r1_surprise_collective(report: Report, coll_ops: List[Dict],
                           predicted: Dict[str, Dict]) -> None:
    """Diff the collective census against the analytic budget."""
    actual: Dict[str, Dict] = {}
    for rec in coll_ops:
        e = actual.setdefault(rec["kind"], {"count": 0.0, "wire": 0.0})
        e["count"] += rec["mult"]
        e["wire"] += rec["wire_bytes"] * rec["mult"]
    for kind in sorted(set(actual) | set(predicted)):
        a = actual.get(kind, {"count": 0.0, "wire": 0.0})
        p = predicted.get(kind, {"count": 0, "wire_bytes": 0.0})
        ca, cp = a["count"], p["count"]
        wa, wp = a["wire"], p["wire_bytes"]
        if ca > cp:
            report.add(Finding(
                "R1", Severity.ERROR, kind,
                predicted_bytes=wp, actual_bytes=wa,
                message=f"unbudgeted collective: HLO has {ca:g} "
                        f"{kind}(s), exchange_schedule budgets {cp:g}"))
        elif ca < cp:
            report.add(Finding(
                "R1", Severity.WARN, kind,
                predicted_bytes=wp, actual_bytes=wa,
                message=f"budgeted {kind} missing from HLO "
                        f"({ca:g} < {cp:g}) — compiler elided or fused; "
                        f"the byte model overestimates this case"))
        elif abs(wa - wp) > max(R1_ABS_TOL, R1_REL_TOL * max(wa, wp)):
            report.add(Finding(
                "R1", Severity.WARN, kind,
                predicted_bytes=wp, actual_bytes=wa,
                message=f"{kind} count matches ({ca:g}) but per-device "
                        f"wire bytes diverge beyond tolerance"))


def _varied_axes(groups: List[List[int]], axis_names: Sequence[str],
                 axis_sizes: Sequence[int]) -> Set[str]:
    """Mesh axes over which the collective's device groups vary.

    Device ids are logical partition ids == positions in the mesh's
    row-major device flattening, so coords come from unravel_index over the
    mesh shape.  Empty `groups` (HLO `replica_groups={}`) means every
    device participates: all >1-size axes vary.
    """
    shape = tuple(axis_sizes)
    if not groups:
        return {a for a, s in zip(axis_names, shape) if s > 1}
    nd = int(np.prod(shape))
    varied: Set[str] = set()
    for g in groups:
        if len(g) < 2:
            continue
        coords = [np.unravel_index(p, shape) for p in g if p < nd]
        for k, name in enumerate(axis_names):
            if len({c[k] for c in coords}) > 1:
                varied.add(name)
    return varied


def r2_home_leak(report: Report, coll_ops: List[Dict],
                 axis_names: Sequence[str], axis_sizes: Sequence[int],
                 allowed_axes: Sequence[str]) -> None:
    """Flag collectives whose groups span an undeclared mesh axis."""
    allowed = set(allowed_axes)
    for rec in coll_ops:
        varied = _varied_axes(rec["groups"], axis_names, axis_sizes)
        leak = varied - allowed
        if leak:
            report.add(Finding(
                "R2", Severity.ERROR, rec["kind"],
                actual_bytes=rec["wire_bytes"] * rec["mult"],
                message=f"device groups vary over undeclared mesh "
                        f"axis(es) {sorted(leak)} (declared: "
                        f"{sorted(allowed)}) — GSPMD is moving homed "
                        f"values across an axis the locale never uses; "
                        f"groups={rec['groups'] or 'all devices'}"))


def r3_smem_budget(report: Report, facts: Sequence[LaunchFacts],
                   ceiling_bytes: int) -> None:
    """Flag launches whose shared memory per block exceeds the ceiling."""
    for fc in facts:
        if fc.smem_bytes > ceiling_bytes:
            report.add(Finding(
                "R3", Severity.ERROR, "launch", shape=fc.name,
                predicted_bytes=float(ceiling_bytes),
                actual_bytes=float(fc.smem_bytes),
                message=f"grid={tuple(fc.grid)} threads={fc.threads}: "
                        f"{fc.smem_bytes:,} bytes of shared memory per block "
                        f"(static {fc.smem_static:,} + dynamic "
                        f"{fc.smem_dynamic:,}) > the per-block ceiling "
                        f"{ceiling_bytes:,}"))


def r4_donation_audit(report: Report, facts: Sequence[Dict],
                      min_bytes: float = R4_MIN_BYTES,
                      donated_ok: Optional[Sequence[int]] = None) -> None:
    """Flag large arguments that come back same-shaped in fresh storage;
    `facts` is `mem_facts.call_facts`'s ``facts["aliasing"]``, and
    `donated_ok` exempts arguments by position."""
    for a in facts:
        if donated_ok and a["index"] in donated_ok:
            continue
        if a["bytes"] >= min_bytes and a["returned"] and not a["in_place"]:
            report.add(Finding(
                "R4", Severity.WARN, "argument",
                shape=f"{a['path']} {a['dtype']}{list(a['shape'])}",
                actual_bytes=float(a["bytes"]),
                message=f"argument {a['path']} ({a['bytes']:,.0f}B) comes "
                        f"back same-shaped in fresh storage — copied every "
                        f"step; write it in place (a donated argument's "
                        f"storage may be reused: Locale.jit(fn, "
                        f"donate=(...,)))"))
