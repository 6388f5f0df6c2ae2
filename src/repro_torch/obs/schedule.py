"""The analytic list of a rank's serving collectives.

`serve_schedule(cfg, plan, calls)` gives, in order, the collectives that
one rank of a `DecodeServer` across ranks makes for the model calls it
listed (``srv.calls``: prefill, decode and page steps with their rows
and tokens a row, and each greedy pick), from the plan alone: the
counterpart for serving of `engine.exchange_schedule` and
`sort.constraint_schedule`.  `log_against_serve` holds a rank's
`collectives.collective_log` to it op for op.  Every record is a
model-axis sum, a pick or a count of expert choices: none carries a KV
cache, which never crosses ranks (a session that lands off its home is
recomputed there, as in the reference).

Kept apart from `obs.reconcile`, which stays a copy of the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import ArchConfig

#: the prefill's MoE group size (`moe.apply_moe`'s default)
PREFILL_GROUP = 2048


def _record(kind: str, axes, nbytes: int, plan) -> Dict:
    """This rank's record of a collective over `axes` that sends its
    `nbytes` to each other home of the group (all-gather and psum)."""
    mesh = plan.mesh
    g = math.prod(mesh.shape[a] for a in axes)
    in_pod = math.prod(mesh.shape[a] for a in axes if a != "pod")
    wire = (g - 1) * nbytes
    inter = (g - in_pod) * nbytes
    return {"kind": kind, "axes": list(axes), "wire_bytes": wire,
            "inter_pod_bytes": inter, "intra_pod_bytes": wire - inter}


def serve_schedule(cfg: ArchConfig, plan, calls: Sequence[Dict]) -> List[Dict]:
    """The collectives, in order, of the model calls `calls` on one rank
    of `plan`'s `RankMesh` (records of `_record`'s form: kind, axes, wire,
    inter- and intra-pod bytes)."""
    from repro_torch.models.blocks import num_superblocks, superblock_spec
    from repro_torch.sharding.partition import homes_of, tp_of
    par = getattr(torch, cfg.param_dtype).itemsize
    act = getattr(torch, cfg.dtype).itemsize
    M, n = tp_of(plan)[0], homes_of(plan)[0]
    tp, homes = (plan.tp,), tuple(plan.batch_axes or ())
    members = superblock_spec(cfg)
    D, K, E = cfg.d_model, cfg.top_k, cfg.num_experts
    out: List[Dict] = []
    for c in calls:
        r, S = c["rows"], c["seq"]
        if c["call"] == "pick":
            if M > 1:
                out.append(_record("all-gather", tp, r * S * 2 * 8, plan))
            if n > 1:
                out.append(_record("all-gather", homes, r * S * 8, plan))
            continue
        x = r * S * D * act               # a (rows, seq, D) activation sum
        if M > 1 and cfg.embed_input:
            out.append(_record("all-reduce", tp, r * S * D * par, plan))
        group = PREFILL_GROUP if c["call"] == "prefill" else r * n
        for _ in range(num_superblocks(cfg)):
            for m in members:
                if M > 1 and m.mixer != "attn":
                    raise NotImplementedError(
                        f"{m.mixer} over \"model\" is not split yet")
                if M > 1 and plan.head_axis is not None:
                    out.append(_record("all-reduce", tp, x, plan))
                if m.ffn == "mlp" and M > 1:
                    out.append(_record("all-reduce", tp, x, plan))
                elif m.ffn == "moe":
                    T = r * S * n
                    gs = min(group, T)
                    if n > 1 and (r * S) % gs:
                        out.append(_record("all-gather", homes,
                                           (T // gs) * K * E * 4, plan))
                    if M > 1:
                        out.append(_record("all-reduce", tp, x, plan))
                        if cfg.num_shared_experts:
                            out.append(_record("all-reduce", tp, x, plan))
    return out


def log_against_serve(log: Sequence[Dict], schedule: Sequence[Dict]
                      ) -> List[str]:
    """Where a rank's collective log differs from its `serve_schedule`,
    op for op: the kind, the axes and the wire, inter- and intra-pod
    bytes, exactly.  Returns the differences (empty when they agree)."""
    out = []
    if len(log) != len(schedule):
        out.append(f"{len(log)} collectives logged, the schedule has "
                   f"{len(schedule)}")
    for i, (got, want) in enumerate(zip(log, schedule)):
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            out.append(f"collective {i}: " + ", ".join(
                f"{k} {a} != {b}" for k, (a, b) in bad.items()))
    return out
