"""Offline trace validation: replay a trace, prove the counter identities.

A copy of `repro/obs/reconcile.py`: the port imports nothing of the JAX
package, and `tests/test_torch_ranks.py` holds the two equal.  The
I-engine identity recomputes the port's `exchange_schedule`.

A trace is evidence, not truth — this module makes it truth by replaying
the per-event records and checking them against the final ``sched.summary``
(the same canonical dict the launcher prints and the bench rows render)
and against the *analytic* cost model (`repro_torch.core.engine.exchange_schedule`
recomputed from each ``engine.sort`` span's stamped arguments).  A bug in
the instrumentation, the scheduler's charge accounting, or the metrics
registry shows up as an identity failure here, not as a quietly wrong
BENCH row.

The identities (per reconciliation segment — a trace may hold several
serving runs; each ``sched.summary`` event closes one):

I-bytes     sum of ``sched.charge`` nbytes == summary ``relayout_bytes``,
            split exactly into ``inter_pod_bytes`` / ``intra_pod_bytes``
            by the charge's ``inter_pod`` flag, and per-home by ``dst``;
            the count of nonzero charges == ``relayout_events``.
I-offhome   replaying the ``sched.place`` events in decision order with
            the scheduler's same-wave cache-copy-site rule (a session's
            sites start at its pre-wave ``bound_home`` and accumulate
            every home it lands on this wave) predicts *exactly* which
            placements carry a charge — the charge events' rid set must
            equal the predicted set: every off-home decode is paid for,
            and nothing is double-charged.
I-pool      sum(``pool.acquire`` refs) − sum(``pool.release`` refs) −
            sum(``pool.invalidate`` refs) == summary ``pool_live_refs``,
            per home and in total (events carry actual state deltas, so
            the identity survives mid-flight force-invalidation).
I-serve     placements == ``served``; distinct wave ids == ``waves``;
            sum of placement ``attached`` == ``pages_attached``; the
            placement waits reproduce ``wait_p50``/``wait_p99``; under
            the homed policy the unspilled on-bound-home placements
            count == ``affinity_hits``.
I-engine    each ``engine.sort`` span's child ``engine.exchange_level``
            events equal a fresh ``exchange_schedule(n, sizes, policy)``
            recomputed from the span's stamped args, record for record.

Schema checks run first (every record well-formed, ``trace.meta`` header
present with a known schema version); a malformed trace is rejected
before any identity is attempted.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.obs.tracelog import KINDS, SCHEMA

#: identity tolerance for float comparisons (wait percentiles)
_EPS = 1e-6


class ReconcileError(AssertionError):
    """A trace failed schema validation or a counter identity."""


def _fail(name: str, msg: str):
    raise ReconcileError(f"[{name}] {msg}")


# --------------------------------------------------------------------- schema
def check_schema(records: List[Dict[str, Any]]) -> None:
    """Structural validation: reject malformed records before replay."""
    if not records:
        _fail("schema", "empty trace")
    meta = records[0]
    if meta.get("name") != "trace.meta":
        _fail("schema", "first record is not the trace.meta header")
    if meta.get("args", {}).get("schema") != SCHEMA:
        _fail("schema", f"unknown trace schema "
                        f"{meta.get('args', {}).get('schema')!r} "
                        f"(validator speaks {SCHEMA})")
    for i, r in enumerate(records):
        kind = r.get("kind")
        if kind not in KINDS:
            _fail("schema", f"record {i}: unknown kind {kind!r}")
        if not isinstance(r.get("name"), str) or not r["name"]:
            _fail("schema", f"record {i}: missing name")
        if not isinstance(r.get("ts"), (int, float)):
            _fail("schema", f"record {i}: non-numeric ts")
        if not isinstance(r.get("args"), dict):
            _fail("schema", f"record {i}: args is not a dict")
        if kind == "span" and not isinstance(r.get("dur"), (int, float)):
            _fail("schema", f"record {i}: span without dur")
        if kind in ("counter", "gauge") \
                and not isinstance(r.get("value"), (int, float)):
            _fail("schema", f"record {i}: {kind} without value")


# ------------------------------------------------------------------- segments
def segments(records: List[Dict[str, Any]]
             ) -> List[Tuple[List[Dict[str, Any]], Dict[str, Any]]]:
    """Split a trace into ``(records, summary_args)`` reconciliation
    segments, one per ``sched.summary`` event.  Trailing scheduler events
    with no closing summary are an error (the run died before
    `emit_summary` — nothing to reconcile them against)."""
    segs = []
    cur: List[Dict[str, Any]] = []
    for r in records:
        if r.get("name") == "sched.summary":
            segs.append((cur, r["args"]))
            cur = []
        else:
            cur.append(r)
    dangling = [r["name"] for r in cur
                if r.get("name") in ("sched.place", "sched.charge")]
    if dangling:
        _fail("segments", f"{len(dangling)} scheduler events after the "
                          f"last sched.summary — incomplete run?")
    return segs


def _named(records, name):
    return [r for r in records if r.get("name") == name]


def _homes_int(d: Dict) -> Dict[int, Any]:
    """JSON round-trips int dict keys to strings; undo that."""
    return {int(k): v for k, v in d.items()}


# ----------------------------------------------------------------- identities
def check_charges(records, summary) -> None:
    """I-bytes: charged relayout == scheduler stats == summary bytes."""
    charges = [r["args"] for r in _named(records, "sched.charge")]
    total = sum(c["nbytes"] for c in charges)
    inter = sum(c["nbytes"] for c in charges if c["inter_pod"])
    events = sum(1 for c in charges if c["nbytes"])
    if total != summary["relayout_bytes"]:
        _fail("I-bytes", f"charged {total}B != summary "
                         f"relayout_bytes {summary['relayout_bytes']}B")
    if inter != summary["inter_pod_bytes"]:
        _fail("I-bytes", f"inter-pod charges {inter}B != summary "
                         f"{summary['inter_pod_bytes']}B")
    if total - inter != summary["intra_pod_bytes"]:
        _fail("I-bytes", f"intra-pod charges {total - inter}B != summary "
                         f"{summary['intra_pod_bytes']}B")
    if events != summary["relayout_events"]:
        _fail("I-bytes", f"{events} nonzero charges != relayout_events "
                         f"{summary['relayout_events']}")
    per_home = _homes_int(summary["per_home"])
    by_dst: Dict[int, int] = {}
    for c in charges:
        by_dst[c["dst"]] = by_dst.get(c["dst"], 0) + c["nbytes"]
    for h, hs in per_home.items():
        if by_dst.get(h, 0) != hs["relayout_bytes"]:
            _fail("I-bytes", f"home {h}: charged {by_dst.get(h, 0)}B != "
                             f"per-home relayout {hs['relayout_bytes']}B")


def check_offhome(records, summary) -> None:
    """I-offhome: replay the same-wave site rule; predicted charge set
    must equal the actual charge events' rid set, per wave."""
    places = [r["args"] for r in _named(records, "sched.place")]
    charged: Dict[int, set] = {}
    for r in _named(records, "sched.charge"):
        charged.setdefault(r["args"]["wave"], set()).add(r["args"]["rid"])
    waves: Dict[int, list] = {}
    for p in places:          # record order == decision order
        waves.setdefault(p["wave"], []).append(p)
    for w, plist in waves.items():
        expect = set()
        sites: Dict[Any, set] = {}
        for p in plist:
            sess, bound = p["session"], p["bound_home"]
            if bound is None:
                continue      # fresh session: first landing is free
            s = sites.setdefault(sess, {bound})
            if p["home"] not in s:
                expect.add(p["rid"])
            s.add(p["home"])
        got = charged.get(w, set())
        if expect != got:
            _fail("I-offhome",
                  f"wave {w}: off-home placements {sorted(expect)} vs "
                  f"charge events {sorted(got)} — "
                  f"{'uncharged off-home decode' if expect - got else 'charge with no off-home placement'}")


def check_pool(records, summary) -> None:
    """I-pool: acquires − releases − invalidations == live refs."""
    flow: Dict[int, int] = {}
    for r in _named(records, "pool.acquire"):
        flow[r["args"]["home"]] = \
            flow.get(r["args"]["home"], 0) + r["args"]["refs"]
    for r in _named(records, "pool.release"):
        flow[r["args"]["home"]] = \
            flow.get(r["args"]["home"], 0) - r["args"]["refs"]
    for r in _named(records, "pool.invalidate"):
        flow[r["args"]["home"]] = \
            flow.get(r["args"]["home"], 0) - r["args"]["refs"]
    pool = _homes_int(summary.get("pool", {}))
    for h in set(flow) | set(pool):
        net = flow.get(h, 0)
        live = pool.get(h, {}).get("refs", 0)
        if net != live:
            _fail("I-pool", f"home {h}: acquires-releases net {net} != "
                            f"live refs {live}")
    total = sum(flow.values())
    if total != summary.get("pool_live_refs", 0):
        _fail("I-pool", f"net pinned refs {total} != summary "
                        f"pool_live_refs {summary.get('pool_live_refs', 0)}")


def check_serve(records, summary) -> None:
    """I-serve: placements/waves/waits/attached/affinity vs summary."""
    places = [r["args"] for r in _named(records, "sched.place")]
    if len(places) != summary["served"]:
        _fail("I-serve", f"{len(places)} placements != served "
                         f"{summary['served']}")
    wave_ids = {p["wave"] for p in places}
    if len(wave_ids) != summary["waves"] or \
            (wave_ids and max(wave_ids) != summary["waves"]):
        _fail("I-serve", f"wave ids {sorted(wave_ids)[:8]}... != "
                         f"summary waves {summary['waves']}")
    attached = sum(p["attached"] for p in places)
    if attached != summary["pages_attached"]:
        _fail("I-serve", f"placed attached pages {attached} != "
                         f"pages_attached {summary['pages_attached']}")
    waits = [p["wait"] for p in places]
    for q, key in ((50.0, "wait_p50"), (99.0, "wait_p99")):
        got = float(np.percentile(np.asarray(waits), q)) if waits else 0.0
        if abs(got - summary[key]) > _EPS:
            _fail("I-serve", f"placement waits give {key}={got:.4f} != "
                             f"summary {summary[key]:.4f}")
    if summary["policy"] == "homed":
        hits = sum(1 for p in places
                   if p["spilled_from"] is None
                   and p["bound_home"] == p["home"])
        if hits != summary["affinity_hits"]:
            _fail("I-serve", f"{hits} on-bound-home placements != "
                             f"affinity_hits {summary['affinity_hits']}")


def check_engine(records) -> None:
    """I-engine: stamped per-level budgets == a fresh exchange_schedule.

    Recomputes the analytic schedule from each ``engine.sort`` span's
    stamped (n, sizes, policy, num_workers, itemsize, local_phase) and
    compares record-for-record with the span's stamped levels — the
    trace carries the analytic budget, and the budget must be *right*.
    """
    sorts = _named(records, "engine.sort")
    if not sorts:
        return
    from repro_torch.core.engine import exchange_schedule
    from repro_torch.core.homing import Homing
    from repro_torch.core.localisation import LocalisationPolicy
    levels: Dict[int, list] = {}
    for r in _named(records, "engine.exchange_level"):
        a = dict(r["args"])
        a.pop("parent", None)
        levels.setdefault(a.pop("call"), []).append(a)
    for r in sorts:
        a = r["args"]
        pol = a["policy"]
        policy = LocalisationPolicy(
            localised=pol["localised"],
            static_mapping=pol["static_mapping"],
            homing=Homing[pol["homing"]], outer=pol["outer"])
        want = exchange_schedule(
            a["n"], tuple(a["sizes"]), policy,
            num_workers=a["num_workers"], itemsize=a["itemsize"],
            local_phase=a["local_phase"])
        got = levels.get(a["call"], [])
        if got != want:
            _fail("I-engine",
                  f"engine.sort call {a['call']} (n={a['n']}, "
                  f"sizes={a['sizes']}): stamped {len(got)} level records "
                  f"!= analytic schedule {len(want)}"
                  + next((f"; first diff at record {i}: {g} != {w}"
                          for i, (g, w) in enumerate(zip(got, want))
                          if g != w), ""))


# ----------------------------------------------------------------- entrypoint
def reconcile(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Validate a full trace; returns a report dict or raises
    `ReconcileError` on the first failed check.

    ``{"segments": N, "checks": [names run], "served": total,
    "relayout_bytes": total, "engine_sorts": N}``
    """
    check_schema(records)
    segs = segments(records)
    served = relayout = 0
    for recs, summary in segs:
        check_charges(recs, summary)
        check_offhome(recs, summary)
        check_pool(recs, summary)
        check_serve(recs, summary)
        served += summary["served"]
        relayout += summary["relayout_bytes"]
    check_engine(records)
    return {"segments": len(segs),
            "checks": ["schema", "I-bytes", "I-offhome", "I-pool",
                       "I-serve", "I-engine"],
            "served": served, "relayout_bytes": relayout,
            "engine_sorts": len(_named(records, "engine.sort"))}
