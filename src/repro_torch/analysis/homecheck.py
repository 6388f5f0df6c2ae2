"""The homecheck orchestrator of the port: run a target, check what it did.

The counterpart of `repro/analysis/homecheck.py`.  The reference lowers a
workload and reads its facts off the HLO and the jaxpr without running
anything.  The port has no trace to read: `check_workload` runs the
workload once (and `check_decode` one decode step of a server) on the
locale's device inside `launches.record()`, so every kernel wrapper on its
path hands in the plan of the launches it makes (on the card, the
launches themselves; on the CPU, the launches the card would make), and
inside `mem_facts.call_facts`, which sees every buffer the call makes;
the rules run on those facts afterwards:

  R1  on a `RankMesh`, for the engine: this rank's collectives
      (`core.collectives`'s log of the run) against
      `engine.collective_census` (the constraint tree, the microbench and
      the decode step have no budget, as in the reference: a note says
      R1 skipped);
  R2  on a `RankMesh`: the ranks each collective spans against the
      locale's declared axes (the decode step's: the plan's batch axes
      and "model");
  R3  shared memory per launch against `kernels.SMEM_BYTES_PER_BLOCK`;
  R4  large arguments that come back same-shaped in fresh storage;
  R5  write races, coverage and out-of-bounds reads of the tile maps;
  R6  the exchange network the engine was built from (shard_map backend);
  R7  index arithmetic in each launch's index type, and the sentinel;
  R8  dead ``blockIdx`` lanes;
  R9  the serving scheduler's transitions certified over a lattice
      (`schedcheck`; the decode target only);
  R10 the call's peak live device bytes (the live scan, and on the card
      the CUDA allocator's peak) against `kernels.HBM_BYTES_PER_DEVICE`;
  R11 on a `RankMesh`: every rank's collective log of the run, gathered
      outside the log (`livecheck.gather_logs`), held to one sequence.

On a `HomeMesh` the homes are rows of one process's tensor and no
collective runs, so R1 and R2 are noted as skipped there and R11 notes
that nothing ran a collective, as the reference notes a module without
collectives.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

from repro_torch.analysis.findings import Report, normalize_rules
from repro_torch.analysis.kernelcheck import (r5_block_coverage,
                                              r7_index_arith, r8_dead_lanes)
from repro_torch.analysis.launches import record
from repro_torch.analysis.livecheck import (gather_logs,
                                            r10_device_live_range,
                                            r11_collective_control_flow)
from repro_torch.analysis.mem_facts import call_facts
from repro_torch.analysis.netverify import r6_network_certification
from repro_torch.analysis.rules import (r1_surprise_collective, r2_home_leak,
                                        r3_smem_budget, r4_donation_audit)


def check_artifacts(target: str, launches: Sequence, *, network=None,
                    collectives: Optional[Sequence[Dict]] = None,
                    predicted: Optional[Dict[str, Dict]] = None,
                    mesh=None, allowed_axes: Sequence[str] = (),
                    mem_facts: Optional[Dict] = None,
                    rank_logs: Optional[Sequence[Sequence[Dict]]] = None,
                    sched_lattice=None,
                    hbm_ceiling: Optional[float] = None,
                    memory_stats=None,
                    context: Optional[Dict] = None, rules=None,
                    suppress: Sequence[str] = ()) -> Report:
    """Run the selected rules over recorded launches (`LaunchFacts`), an
    exchange network, a rank's collective log, a call's memory facts and
    every rank's log.

    ``network=None`` (else a ``(policy, sizes, axes)`` triple for the
    shard_map engine) skips R6 with a note.  ``collectives=None`` (else a
    rank's `core.collectives` log, with the `RankMesh` it ran on as
    `mesh`) skips R1 and R2; ``predicted=None`` (else the
    `engine.collective_census` budget) skips R1.  R3's ceiling is
    `repro_torch.kernels.SMEM_BYTES_PER_BLOCK`.  `mem_facts`
    (`mem_facts.call_facts`'s facts; None skips R4 and R10 with a note)
    feeds R4 (its aliasing) and R10 (its liveness, against `hbm_ceiling`,
    default `repro_torch.kernels.HBM_BYTES_PER_DEVICE`, and
    `memory_stats`, default the facts' own allocator peak).
    ``sched_lattice=None`` (else a sequence of `schedcheck.LatticeEntry`)
    skips R9.  `rank_logs` is every rank's collective log of the run, by
    rank (None: no rank made one).
    """
    from repro_torch.kernels import HBM_BYTES_PER_DEVICE, SMEM_BYTES_PER_BLOCK

    active = normalize_rules(rules)
    report = Report(target=target, context=dict(context or {}))
    no_log = ("no collective log: the homes of a HomeMesh are rows of one "
              "process's tensor, and only a RankMesh's ranks make "
              "collectives")
    no_facts = ("no memory facts: the call did not run under "
                "mem_facts.call_facts")
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
    if "R4" in active:
        if mem_facts is not None:
            r4_donation_audit(report, mem_facts["aliasing"])
        else:
            report.notes.append(f"R4 skipped: {no_facts}")
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
    if "R9" in active:
        if sched_lattice is not None:
            from repro_torch.analysis.schedcheck import (
                r9_scheduler_certification)
            r9_scheduler_certification(report, sched_lattice)
        else:
            report.notes.append("R9 skipped: target has no serving "
                                "scheduler (serve[decode] only)")
    if "R10" in active:
        if mem_facts is not None:
            r10_device_live_range(
                report, mem_facts["liveness"],
                hbm_ceiling or HBM_BYTES_PER_DEVICE,
                memory_stats=(memory_stats if memory_stats is not None
                              else mem_facts.get("memory_stats")))
        else:
            report.notes.append(f"R10 skipped: {no_facts}")
    if "R11" in active:
        r11_collective_control_flow(report, rank_logs)
    return report.suppress(suppress)


def _peaks(facts: Dict) -> Dict:
    """The call's peaks for a report's context: the live scan's, and on
    the card the allocator's."""
    out = {"peak_bytes": int(facts["liveness"]["peak_bytes"])}
    if facts["memory_stats"]:
        out["allocator_peak_bytes"] = int(
            facts["memory_stats"]["allocated_bytes.all.peak"])
    return out


def _run(fn, args, mesh, active):
    """Run ``fn(*args)`` under `record()` and `call_facts`: returns
    ``(launches, facts, this rank's log, every rank's log)`` (the logs
    None off ranks; every rank's only where R11 is active)."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.mesh import RankMesh

    coll.reset_collectives()
    with record() as launches:
        _, facts = call_facts(fn, *args)
    if not isinstance(mesh, RankMesh):
        return list(launches), facts, None, None
    log = coll.collective_log()
    return (list(launches), facts, log,
            gather_logs(log) if "R11" in active else None)


def _round_up(n: int, g: int) -> int:
    return (n + g - 1) // g * g


def check_workload(locale, workload: str = "sort", *,
                   backend: Optional[str] = None,
                   num_workers: Optional[int] = None,
                   local_phase: Optional[str] = None,
                   logn: int = 12, reps: int = 4,
                   device=None,
                   hbm_ceiling: Optional[float] = None,
                   rules=None,
                   suppress: Sequence[str] = ()) -> Report:
    """Check one registered workload under `locale`.

    Builds the workload as `Locale.workload` would, runs it once on an
    input of ~2**logn elements (granule-aligned ``arange`` int32; float32
    for the microbench) on the locale's device -- without a mesh, on
    `device` (default ``"cuda"``) -- while recording its launches, and runs
    the selected rules (default all) on them, R4 and R10 on the call's
    memory facts (`hbm_ceiling` overrides R10's ceiling).  On a
    `RankMesh` every rank calls it (every workload's collectives span the
    ranks), and each rank's report covers its own launches and
    collectives, and R11 every rank's log.
    """
    import torch

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
            f"goes through check_decode")

    active = normalize_rules(rules)
    x = torch.arange(n, dtype=torch.int32).to(dtype).to(dev)
    if ranks:                       # each workload takes this rank's share
        x = fn.place(x)
    launches, facts, log, logs = _run(fn, (x,), mesh, active)
    context.update(device=str(dev), launches=len(launches), **_peaks(facts))
    if ranks:
        context.update(rank=mesh.rank, collectives=len(log))
    return check_artifacts(
        target, launches, network=network, collectives=log,
        predicted=predicted, mesh=mesh, allowed_axes=axes, mem_facts=facts,
        rank_logs=logs, hbm_ceiling=hbm_ceiling, context=context,
        rules=active, suppress=suppress)


def check_decode(mesh=None, *, cfg_name: str = "qwen3-0.6b",
                 batch_slots: int = 4, max_len: int = 64,
                 prompt_len: int = 8, device=None,
                 hbm_ceiling: Optional[float] = None,
                 sched_lattice=None, rules=None,
                 suppress: Sequence[str] = ()) -> Report:
    """Check the serving decode step (`DecodeServer`'s ``_decode``).

    Builds `reduce_config(cfg_name)`'s server over `mesh` (None = one
    home on `device`, default the card; a `HomeMesh`; or a `RankMesh`,
    whose every rank calls this with its blocks of the parameters drawn
    from seed 0), fills its cache by one prefill of ``(batch_slots,
    prompt_len)`` tokens drawn from seed 0 (the reference derives the
    cache's shapes without running; here the step needs a cache), and
    records the launches, memory facts and collectives of one decode
    step.  R2's declared axes are the plan's batch axes (slot homing)
    plus "model" (tensor parallelism); R4 audits the step's arguments,
    the cache among them; R9 certifies the scheduler over `sched_lattice`
    (default the cheap `schedcheck.FAST_LATTICE` corner; the CLI runs the
    full `DEFAULT_LATTICE` once and prints the certificate).
    """
    import numpy as np
    import torch

    from repro_torch.analysis.schedcheck import FAST_LATTICE
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_params
    from repro_torch.core.mesh import RankMesh, entry_device
    from repro_torch.models import LM
    from repro_torch.runtime.server import DecodeServer
    from repro_torch.sharding.partition import NULL_PLAN, make_plan

    active = normalize_rules(rules)
    dev = entry_device(mesh, device)
    ranks = isinstance(mesh, RankMesh)
    cfg = reduce_config(get_config(cfg_name))
    plan = (make_plan(mesh, cfg, ShapeSpec("d", max_len, batch_slots,
                                           "decode"))
            if mesh is not None else NULL_PLAN)
    params = rank_params(LM(cfg).init(
        torch.Generator(device=dev).manual_seed(0)), plan, cfg)
    srv = DecodeServer(cfg, params, batch_slots=batch_slots,
                       max_len=max_len, plan=plan)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch_slots, prompt_len)).astype(np.int64)
    cur, caches = srv.prefill_wave(toks)
    batch = srv.decode_batch(cur)
    launches, facts, log, logs = _run(
        srv._decode, (params, caches, batch, prompt_len), mesh, active)
    context = dict(workload="serve", cfg=cfg_name, batch_slots=batch_slots,
                   max_len=max_len,
                   mesh=mesh.shape if mesh is not None else None,
                   device=str(dev), launches=len(launches), **_peaks(facts))
    if ranks:
        context.update(rank=mesh.rank, collectives=len(log))
    allowed = tuple(plan.batch_axes or ()) + ("model",)
    return check_artifacts(
        "serve[decode]", launches, collectives=log, mesh=mesh,
        allowed_axes=allowed, mem_facts=facts, rank_logs=logs,
        sched_lattice=(FAST_LATTICE if sched_lattice is None
                       else sched_lattice),
        hbm_ceiling=hbm_ceiling, context=context, rules=active,
        suppress=suppress)
