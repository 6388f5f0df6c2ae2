"""R10/R11: a call's device memory and the ranks' collectives.

The counterpart of `repro/analysis/livecheck.py`.  The reference reads
both rules off the optimized HLO of a lowered workload; the port reads
them off what a call did when it ran:

  R10 device-live-range       Gate the call's peak live device bytes
                              against a declared ceiling.  The peak is
                              the max of (a) the live scan of
                              `mem_facts.call_facts` (the arguments plus
                              the most the call's own buffers held at
                              once) and (b), where the caller passes it,
                              the CUDA allocator's peak over the call
                              (``memory_stats["allocated_bytes.all.
                              peak"]``, the counterpart of XLA's
                              `memory_analysis()`), which also sees the
                              scratch a kernel takes inside one op.  On
                              success the note reports the headroom: the
                              budget the KV prefix pools can grow into.

  R11 collective-control-flow Every rank's `core.collectives` log of the
                              same run, compared.  Within each group of
                              ranks that share a collective, every rank
                              must issue the same sequence of (kind,
                              axes, groups, payload bytes) -- payloads
                              compared wherever every rank passes the
                              same, so not for `all_to_all_v`.  The
                              first difference is an ERROR: the two
                              ranks would deadlock there (a branch on
                              the rank's data that only some ranks
                              take, the counterpart of a `conditional`
                              whose branches disagree).  Given the logs
                              of a second run of the same entry point on
                              other data of the same shapes, a rank
                              whose sequence differs between the runs is
                              a WARN: the number of collectives is data
                              the ranks must agree on (the counterpart
                              of a `while` with no known trip count).

A process without a `RankMesh` makes no collective, so there is no log:
R11 notes that nothing ran one, as the reference's clean note does for
an HLO without collectives.  The logs are gathered by `gather_logs`
outside the counted collectives, so gathering them is not itself logged.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, Report, Severity

#: the fields of a collective record that R11 compares
SIGNATURE_KEYS = ("kind", "axes", "groups", "payload_bytes")


def _stats_peak(memory_stats) -> Optional[float]:
    """The allocator's peak over the call, None when not given."""
    if not memory_stats:
        return None
    v = memory_stats.get("allocated_bytes.all.peak")
    return float(v) if v is not None else None


def r10_device_live_range(report: Report, facts: Dict, ceiling: float,
                          memory_stats=None) -> None:
    """Gate a call's peak live device bytes against `ceiling`; `facts` is
    `mem_facts.call_facts`'s ``facts["liveness"]``."""
    scan_peak = facts["peak_bytes"]
    stats_peak = _stats_peak(memory_stats)
    peak = max(scan_peak, stats_peak or 0.0)
    source = ("cuda allocator" if stats_peak is not None
              and stats_peak >= scan_peak else "liveness scan")
    if peak > ceiling:
        top = ", ".join(f"{name}:{op}={b:,.0f}B"
                        for b, name, op in facts["live_at_peak"][:4])
        report.add(Finding(
            rule="R10", severity=Severity.ERROR, op="call",
            predicted_bytes=ceiling, actual_bytes=peak,
            message=f"peak live device memory {peak:,.0f}B exceeds the "
                    f"{ceiling:,.0f}B per-device ceiling ({source}; "
                    f"largest at peak: {top})"))
        return
    report.notes.append(
        f"R10: device-live-range ok — peak {peak:,.0f}B of {ceiling:,.0f}B "
        f"ceiling ({source}; {ceiling - peak:,.0f}B headroom for KV pools, "
        f"{facts['n_buffers']} buffers scanned)")


def _groups(groups) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(r) for r in g) for g in groups or ())


def log_signature(log: Sequence[Dict]) -> List[Dict]:
    """A rank's log reduced to what R11 compares (`SIGNATURE_KEYS`): what
    a rank process hands back for the rule."""
    return [{k: r.get(k) for k in SIGNATURE_KEYS} for r in log]


def _key(rec: Dict) -> Tuple:
    return (rec["kind"], tuple(rec["axes"]), _groups(rec["groups"]),
            rec.get("payload_bytes"))


def _components(logs: Sequence[Sequence[Dict]]) -> List[List[int]]:
    """The ranks, joined wherever a collective's group holds both (every
    rank of a run on one mesh ends up in one component)."""
    parent = list(range(len(logs)))

    def root(r):
        while parent[r] != r:
            parent[r] = parent[parent[r]]
            r = parent[r]
        return r
    for log in logs:
        for rec in log:
            for g in _groups(rec["groups"]):
                g = [r for r in g if r < len(logs)]
                for r in g[1:]:
                    parent[root(r)] = root(g[0])
    comps: Dict[int, List[int]] = {}
    for r in range(len(logs)):
        comps.setdefault(root(r), []).append(r)
    return list(comps.values())


def _show(rec: Optional[Dict]) -> str:
    if rec is None:
        return "nothing"
    pay = rec.get("payload_bytes")
    return (f"{rec['kind']} over {list(rec['axes'])}"
            + (f" of {pay:,d}B" if pay is not None else ""))


def _first_difference(a: Sequence[Dict], b: Sequence[Dict]) -> Optional[int]:
    for i in range(max(len(a), len(b))):
        if i >= len(a) or i >= len(b) or _key(a[i]) != _key(b[i]):
            return i
    return None


def r11_collective_control_flow(report: Report,
                                logs: Optional[Sequence[Sequence[Dict]]],
                                second: Optional[Sequence[Sequence[Dict]]]
                                = None) -> None:
    """Hold every rank's collective log (index = rank) to one sequence
    within each group of ranks; `second`, the logs of a second run on
    other data, to the first."""
    if not logs:
        report.notes.append(
            "R11: collective-control-flow ok — no collective log: nothing "
            "ran a collective (one process, no RankMesh)")
        return
    bad = False
    for comp in _components(logs):
        first = comp[0]
        for r in comp[1:]:
            i = _first_difference(logs[first], logs[r])
            if i is None:
                continue
            bad = True
            a = logs[first][i] if i < len(logs[first]) else None
            b = logs[r][i] if i < len(logs[r]) else None
            report.add(Finding(
                rule="R11", severity=Severity.ERROR, op="collective",
                shape=f"rank {first} vs rank {r} at #{i}",
                message=f"ranks {first} and {r} issue different collectives "
                        f"at #{i}: rank {first} {_show(a)}, rank {r} "
                        f"{_show(b)} — the ranks would deadlock there (a "
                        f"branch on a rank's data that not every rank of "
                        f"the group takes)"))
            break
    if second is not None:
        moved = [r for r in range(min(len(logs), len(second)))
                 if _first_difference(logs[r], second[r]) is not None]
        if moved:
            r = moved[0]
            i = _first_difference(logs[r], second[r])
            bad = True
            report.add(Finding(
                rule="R11", severity=Severity.WARN, op="collective",
                shape=f"ranks {moved}",
                message=f"rank {r} issues {len(logs[r])} collective(s) on "
                        f"one run and {len(second[r])} on another of the "
                        f"same shapes (first difference at #{i}) — the "
                        f"trip count of its collectives depends on the data, "
                        f"which every rank must agree on"))
    if not bad:
        n = max(len(log) for log in logs)
        runs = "two runs" if second is not None else "one run"
        report.notes.append(
            f"R11: collective-control-flow ok — {len(logs)} rank(s) issue "
            f"the same {n} collective(s) in each group ({runs} compared)")


def gather_logs(log: Sequence[Dict], group=None) -> List[List[Dict]]:
    """Every rank's `log_signature` of `log`, indexed by rank, by
    ``all_gather_object`` over `group` (default the world): outside
    `core.collectives`, so the gathering is not logged."""
    import torch.distributed as dist
    out: List = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, log_signature(log), group=group)
    return out
