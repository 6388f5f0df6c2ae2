"""The homecheck orchestrator of the port: run a workload, check its launches.

The counterpart of `repro/analysis/homecheck.py`.  The reference lowers a
workload and reads its facts off the HLO and the jaxpr without running
anything.  The port has no trace to read: `check_workload` runs the
workload once on the locale's device inside `launches.record()`, so every
kernel wrapper on its path hands in the plan of the launches it makes (on
the card, the launches themselves; on the CPU, the launches the card
would make), and the rules run on those facts afterwards:

  R1  on a `RankMesh`, for the engine: this rank's collectives
      (`core.collectives`'s log of the run) against
      `engine.collective_census` (the constraint tree and the microbench
      have no budget, as in the reference: a note says R1 skipped);
  R2  on a `RankMesh`: the ranks each collective spans against the
      locale's declared axes;
  R3  shared memory per launch against `kernels.SMEM_BYTES_PER_BLOCK`;
  R5  write races, coverage and out-of-bounds reads of the tile maps;
  R6  the exchange network the engine was built from (shard_map backend);
  R7  index arithmetic in each launch's index type, and the sentinel;
  R8  dead ``blockIdx`` lanes.

On a `HomeMesh` the homes are rows of one process's tensor and no
collective runs, so R1 and R2 are noted as skipped there.  R4 reads HLO
(donation) and waits for its slice; R9 (the serving scheduler), R10
(peak device memory) and R11 (collectives under control flow) wait for
theirs.  Each of them adds a report note when selected, as the
reference does for a rule it skips.  `check_decode` waits for serving.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

from repro_torch.analysis.findings import Report, normalize_rules
from repro_torch.analysis.kernelcheck import (r5_block_coverage,
                                              r7_index_arith, r8_dead_lanes)
from repro_torch.analysis.launches import record
from repro_torch.analysis.netverify import r6_network_certification
from repro_torch.analysis.rules import (r1_surprise_collective,
                                        r2_home_leak, r3_smem_budget)

#: rules with no counterpart in the port yet, and what they wait for
NOT_PORTED = {
    "R4": "the donation audit: donated buffers and the decode cache "
          "written in place",
    "R9": "the scheduler certificate: a port of analysis/schedcheck.py",
    "R10": "the device-memory live range: measured peak against the "
           "device's memory",
    "R11": "collective control flow: a comparison of the ranks' "
           "collectives.LOG",
}


def check_artifacts(target: str, launches: Sequence, *, network=None,
                    collectives: Optional[Sequence[Dict]] = None,
                    predicted: Optional[Dict[str, Dict]] = None,
                    mesh=None, allowed_axes: Sequence[str] = (),
                    context: Optional[Dict] = None, rules=None,
                    suppress: Sequence[str] = ()) -> Report:
    """Run the selected rules over recorded launches (`LaunchFacts`), an
    exchange network and a rank's collective log.

    ``network=None`` (else a ``(policy, sizes, axes)`` triple for the
    shard_map engine) skips R6 with a note.  ``collectives=None`` (else a
    rank's `core.collectives` log, with the `RankMesh` it ran on as
    `mesh`) skips R1 and R2; ``predicted=None`` (else the
    `engine.collective_census` budget) skips R1.  R3's ceiling is
    `repro_torch.kernels.SMEM_BYTES_PER_BLOCK`.
    """
    from repro_torch.kernels import SMEM_BYTES_PER_BLOCK

    active = normalize_rules(rules)
    report = Report(target=target, context=dict(context or {}))
    for rid in active:
        if rid in NOT_PORTED:
            report.notes.append(f"{rid} skipped: no port counterpart yet "
                                f"({NOT_PORTED[rid]})")
    no_log = ("no collective log: the homes of a HomeMesh are rows of one "
              "process's tensor, and only a RankMesh's ranks make "
              "collectives")
    if "R1" in active:
        if collectives is None:
            report.notes.append(f"R1 skipped: {no_log}")
        elif predicted is None:
            report.notes.append("R1 skipped: no analytic collective budget "
                                "for this target")
        else:
            r1_surprise_collective(report, list(collectives), predicted)
    if "R2" in active:
        if collectives is None:
            report.notes.append(f"R2 skipped: {no_log}")
        else:
            r2_home_leak(report, list(collectives), tuple(mesh.shape),
                         tuple(mesh.shape.values()), allowed_axes)
    if "R3" in active:
        r3_smem_budget(report, launches, SMEM_BYTES_PER_BLOCK)
    if "R5" in active:
        r5_block_coverage(report, launches)
    if "R7" in active:
        r7_index_arith(report, launches)
    if "R8" in active:
        r8_dead_lanes(report, launches)
    if "R6" in active:
        if network is not None:
            policy, sizes, axes = network
            r6_network_certification(report, policy, sizes, axes)
        else:
            report.notes.append("R6 skipped: target has no exchange "
                                "network (not the shard_map engine)")
    return report.suppress(suppress)


def _round_up(n: int, g: int) -> int:
    return (n + g - 1) // g * g


def check_workload(locale, workload: str = "sort", *,
                   backend: Optional[str] = None,
                   num_workers: Optional[int] = None,
                   local_phase: Optional[str] = None,
                   logn: int = 12, reps: int = 4,
                   device=None,
                   rules=None,
                   suppress: Sequence[str] = ()) -> Report:
    """Check one registered workload under `locale`.

    Builds the workload as `Locale.workload` would, runs it once on an
    input of ~2**logn elements (granule-aligned ``arange`` int32; float32
    for the microbench) on the locale's device -- without a mesh, on
    `device` (default ``"cuda"``) -- while recording its launches, and runs
    the selected rules (default all) on them.  On a `RankMesh` every rank
    calls it (every workload's collectives span the ranks), and each
    rank's report covers its own launches and collectives.
    """
    import torch

    from repro_torch.core import collectives as coll

    from repro_torch.core.api import Locale
    from repro_torch.core.engine import collective_census, engine_granule
    from repro_torch.core.homing import Homing, axis_tuple
    from repro_torch.core.mesh import HomeMesh, RankMesh, entry_device
    from repro_torch.core.sort import constraint_granule

    mesh, policy = locale.mesh, locale.policy
    axes = axis_tuple(locale.axis)
    sort_sizes = (tuple(mesh.shape[a] for a in axes) if mesh is not None
                  else (1,))
    m = math.prod(sort_sizes)
    hash_homed = policy.homing == Homing.HASH_INTERLEAVED
    dev = entry_device(mesh, device)
    mesh_ctx = mesh.shape if mesh is not None else None
    ranks = isinstance(mesh, RankMesh)
    predicted = None

    if workload in ("sort", "engine"):
        backend = backend or ("shard_map" if workload == "engine"
                              else "constraint")
        kw = dict(backend=backend, num_workers=num_workers,
                  local_phase=local_phase)
        if backend == "shard_map":
            granule = engine_granule(m, num_workers, hash_homed)
            network = (policy, sort_sizes, axes if mesh is not None else None)
            if mesh is None:        # the engine's own one home, on `dev`
                locale = Locale(HomeMesh({axes[-1]: 1}, device=dev),
                                axes[-1], policy)
        else:
            granule = constraint_granule(mesh, policy, num_workers,
                                         locale.axis)
            network = None
            if mesh is None:
                kw["device"] = dev
        fn = locale.workload(workload, **kw)
        n = _round_up(1 << logn, granule)
        if backend == "shard_map":
            predicted = collective_census(n, sort_sizes, policy,
                                          num_workers=num_workers,
                                          itemsize=4, local_phase=local_phase)
        dtype = torch.int32
        target = f"{workload}[{backend}]"
        context = dict(workload=workload, backend=backend,
                       policy=policy.name, n=n, mesh=mesh_ctx)
    elif workload == "microbench":
        kw = {} if mesh is not None else {"device": dev}
        fn = locale.workload("microbench", reps=reps, **kw)
        n = _round_up(1 << logn, m)
        network = None
        dtype = torch.float32
        target = "microbench"
        context = dict(workload="microbench", reps=reps, policy=policy.name,
                       n=n, mesh=mesh_ctx)
    else:
        raise ValueError(
            f"homecheck has no driver for workload {workload!r}; serving "
            f"(check_decode) waits for its slice")

    x = torch.arange(n, dtype=torch.int32).to(dtype).to(dev)
    if ranks:                       # each workload takes this rank's share
        x = fn.place(x)
    coll.reset_collectives()
    with record() as launches:
        fn(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    context.update(device=str(dev), launches=len(launches))
    if ranks:
        context.update(rank=mesh.rank, collectives=len(coll.LOG))
    return check_artifacts(
        target, launches, network=network,
        collectives=coll.collective_log() if ranks else None,
        predicted=predicted, mesh=mesh, allowed_axes=axes,
        context=context, rules=rules, suppress=suppress)
