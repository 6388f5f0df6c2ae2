"""Rule R3 over the port's kernel launches: shared memory per block.

The counterpart of `r3_vmem_budget` (`repro/analysis/rules.py`).  The TPU
rule compares each `pallas_call`'s resident blocks and scratch with the
per-core VMEM ceiling; on an H100 the scarce on-chip store is a block's
shared memory, so each launch's static plus dynamic shared memory is
checked against `repro_torch.kernels.SMEM_BYTES_PER_BLOCK` (232,448 B, the
most one block may opt into).  A launch above it would be refused by the
card at run time; the rule refuses it from the plan.

R1, R2 and R4 read the reference's HLO and wait for the port's
torch.distributed slice.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.analysis.findings import Finding, Report, Severity
from repro_torch.analysis.launches import LaunchFacts


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
