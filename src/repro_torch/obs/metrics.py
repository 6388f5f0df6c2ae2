"""Per-home metrics registry: wave-boundary snapshots + ONE rendering path.

The scheduler owns a `MetricsRegistry`; at every wave boundary it calls
`record_wave`, which snapshots the per-home state a dashboard would plot
— queue depths, bound sessions, KV-pool pages / live refs, the wave's
step target and admitted waits, utilisation so far — and emits the same
numbers as tracer gauges so a trace carries the full time series.

`summarise(scheduler)` folds the final stats + snapshots into the ONE
canonical summary dict every consumer renders from:

* ``format_summary(summary)``  — the human exit report
  (`launch/serve.py`, `Scheduler.format_summary`),
* ``bench_rows(name, summary, wall_us)`` — the ``name,us,derived`` CSV
  rows `benchmarks/bench_serve.py` prints (and `compare.py` gates),
* the ``sched.summary`` trace event (`Scheduler.emit_summary`) that
  `repro_torch.obs.reconcile` checks every traced counter against.

Because all three render the same dict, a stat can't drift between the
launcher's print, the bench baseline and the trace — the reconciliation
identities would catch it.

A copy of `repro/obs/metrics.py`: the port imports nothing of the JAX
package, and `tests/test_torch_serve.py` holds the two equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.tracelog import NULL_TRACER


@dataclass(frozen=True)
class WaveSnapshot:
    """One wave boundary, as a dashboard row."""
    wave: int
    now: float
    target: int
    placed: int
    queue_depth: Dict[int, int]
    bound_sessions: Dict[int, int]
    pool_pages: Dict[int, int]
    pool_refs: Dict[int, int]
    waits: Tuple[float, ...]
    utilisation: float


@dataclass
class MetricsRegistry:
    """Wave-boundary snapshots + derived per-home aggregates."""

    snapshots: List[WaveSnapshot] = field(default_factory=list)

    def record_wave(self, cfg, state, wave: int, now: float, target: int,
                    placements, waits, utilisation: float,
                    tracer=NULL_TRACER) -> WaveSnapshot:
        """Snapshot one formed wave from the scheduler's (cfg, state').

        ``state`` is the post-wave `SchedState`; queue depths and pool
        contents are therefore what the *next* decision will see — the
        steady-state backlog a dashboard wants.
        """
        bound: Dict[int, int] = {h: 0 for h in cfg.homes}
        for b in state.bindings:
            bound[b.home] = bound.get(b.home, 0) + 1
        snap = WaveSnapshot(
            wave=wave, now=now, target=target, placed=len(placements),
            queue_depth={h: len(q) for h, q in state.queues},
            bound_sessions=bound,
            pool_pages={h: len(p) for h, p in state.pools},
            pool_refs={h: sum(pg.refs for pg in p)
                       for h, p in state.pools},
            waits=tuple(waits), utilisation=utilisation)
        self.snapshots.append(snap)
        if tracer.enabled:
            tracer.gauge("sched.queue_depth",
                         sum(snap.queue_depth.values()), cat="metrics",
                         per_home=snap.queue_depth, wave=wave, now=now)
            tracer.gauge("sched.bound_sessions", sum(bound.values()),
                         cat="metrics", per_home=bound, wave=wave)
            if snap.pool_pages:
                tracer.gauge("pool.pages", sum(snap.pool_pages.values()),
                             cat="metrics", per_home=snap.pool_pages,
                             wave=wave)
                tracer.gauge("pool.live_refs",
                             sum(snap.pool_refs.values()), cat="metrics",
                             per_home=snap.pool_refs, wave=wave)
            tracer.gauge("sched.utilisation", round(utilisation, 4),
                         cat="metrics", wave=wave)
        return snap

    # ------------------------------------------------------------ aggregates
    def queue_depth_max(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for s in self.snapshots:
            for h, d in s.queue_depth.items():
                out[h] = max(out.get(h, 0), d)
        return out

    def wave_waits(self) -> List[float]:
        return [w for s in self.snapshots for w in s.waits]


def _pct(values, q: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values), q))


def summarise(sch) -> Dict[str, Any]:
    """The canonical summary dict for one finished (or running) scheduler.

    A strict superset of the pre-obs ``Scheduler.summary()`` keys, so
    old consumers keep working; the additions are what the registry
    snapshots and the reconciler need (pool totals, per-home queue-depth
    maxima, config echoes).
    """
    s = sch.stats
    reg: MetricsRegistry = sch.metrics
    state = sch.state
    pool = {h: {"pages": len(p), "refs": sum(pg.refs for pg in p)}
            for h, p in state.pools}
    placements_with_blocks = s.prefix_hits_full + s.prefix_hits_partial
    return {
        "policy": sch.policy,
        "n_slots": sch.n_slots,
        "n_homes": len(sch.homes),
        "homes": list(sch.homes),
        "homes_per_pod": sch.homes_per_pod,
        "served": s.served,
        "tokens_out": s.tokens_out,
        "waves": s.waves,
        "steps": s.steps,
        "utilisation": round(sch.utilisation(), 4),
        "wait_p50": s.wait_pct(50.0),
        "wait_p99": s.wait_pct(99.0),
        "relayout_bytes": s.relayout_bytes,
        "inter_pod_bytes": s.inter_pod_bytes,
        "intra_pod_bytes": s.intra_pod_bytes,
        "relayout_events": s.relayout_events,
        "affinity_hits": s.affinity_hits,
        "pages_attached": s.pages_attached,
        "prefix_hits_full": s.prefix_hits_full,
        "prefix_hits_partial": s.prefix_hits_partial,
        "prefill_rows_saved": round(sch.prefill_rows_saved(), 2),
        "prefix_hit_rate": (round(placements_with_blocks / s.served, 4)
                            if s.served else 0.0),
        "per_home": {h: vars(hs).copy() for h, hs in s.homes.items()},
        "pool": pool,
        "pool_pages": sum(v["pages"] for v in pool.values()),
        "pool_live_refs": sum(v["refs"] for v in pool.values()),
        "queue_depth_max": reg.queue_depth_max(),
        "wave_snapshots": len(reg.snapshots),
        "page_size": sch.page_size or 0,
        "page_capacity": sch.page_capacity,
        "prompt_pad": sch.prompt_pad or 0,
        "bytes_per_token": sch.bytes_per_token,
    }


def format_summary(summary: Dict[str, Any]) -> str:
    """The human exit report — one line per home, then totals."""
    lines = [f"# scheduler policy={summary['policy']} "
             f"slots={summary['n_slots']} homes={summary['n_homes']}"
             + (f" homes_per_pod={summary['homes_per_pod']}"
                if summary.get("homes_per_pod") else ""),
             "# home  admitted  spill_in  spill_out  evicted  "
             "relayout_bytes  max_queue"]
    qmax = summary.get("queue_depth_max", {})
    for h in summary["homes"]:
        hs = summary["per_home"][h]
        lines.append(f"#  {h:>3} {hs['admitted']:>9} {hs['spilled_in']:>9} "
                     f"{hs['spilled_out']:>10} {hs['evicted']:>8} "
                     f"{hs['relayout_bytes']:>14} {qmax.get(h, 0):>9}")
    lines.append(
        f"# served={summary['served']} tokens={summary['tokens_out']} "
        f"waves={summary['waves']} steps={summary['steps']:.0f} "
        f"util={summary['utilisation']:.2f} "
        f"wait_p50={summary['wait_p50']:.1f} "
        f"wait_p99={summary['wait_p99']:.1f} "
        f"relayout={summary['relayout_bytes']}B "
        f"(inter_pod={summary['inter_pod_bytes']}B "
        f"intra_pod={summary['intra_pod_bytes']}B)")
    if summary.get("page_capacity"):
        lines.append(
            f"# pages_attached={summary['pages_attached']} "
            f"prefix_hits={summary['prefix_hits_full']}full/"
            f"{summary['prefix_hits_partial']}partial "
            f"prefill_rows_saved={summary['prefill_rows_saved']:.1f} "
            f"pool_pages={summary['pool_pages']} "
            f"live_refs={summary['pool_live_refs']}")
    return "\n".join(lines)


def bench_rows(name: str, summary: Dict[str, Any],
               wall_us: float) -> List[str]:
    """The ``name,us_per_call,derived`` CSV rows `bench_serve` prints.

    Field names and formats are pinned by the committed BENCH_serve.json
    baselines and `compare.py`'s derived-field gates (``tok_s`` /
    ``rows_saved`` on the ``_prefix`` family, ``p50``/``p99`` on the
    ``_wait`` family) — rendering them here is what makes the bench rows,
    the launcher summary and the trace summary the same numbers.
    """
    tokens = summary["tokens_out"]
    tok_s = tokens / (wall_us / 1e6) if wall_us else 0.0
    return [
        f"{name},{wall_us / max(1, tokens):.0f},"
        f"tok_s={tok_s:.0f};served={summary['served']};"
        f"tokens={tokens};steps={summary['steps']:.0f};"
        f"waves={summary['waves']};"
        f"util={summary['utilisation']:.3f};"
        f"pages={summary['pages_attached']};"
        f"hits_full={summary['prefix_hits_full']};"
        f"hits_part={summary['prefix_hits_partial']};"
        f"rows_saved={summary['prefill_rows_saved']:.1f}",
        f"{name}_wait,,"
        f"p50={summary['wait_p50']:.1f};p99={summary['wait_p99']:.1f}",
        f"{name}_relayout,,"
        f"total={summary['relayout_bytes']};"
        f"inter_pod={summary['inter_pod_bytes']};"
        f"intra_pod={summary['intra_pod_bytes']};"
        f"events={summary['relayout_events']};"
        f"affinity_hits={summary['affinity_hits']}",
    ]
