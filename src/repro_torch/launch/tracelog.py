"""Trace tooling: validate a JSONL trace's counter identities, or export
it as Chrome trace-event JSON for ``chrome://tracing`` / Perfetto.

    PYTHONPATH=src python -m repro_torch.launch.tracelog TRACE.jsonl \
        --validate
    PYTHONPATH=src python -m repro_torch.launch.tracelog TRACE.jsonl \
        --chrome trace.json

The counterpart of `repro/launch/tracelog.py`, over the port's
`repro_torch.obs` (a trace from ``python -m repro_torch.launch.serve
--trace PATH``; the two packages write the same schema).

``--validate`` replays the trace through `repro_torch.obs.reconcile` and
proves the identities (charged relayout bytes == scheduler stats ==
summary; pool acquires − releases − invalidations == live refs; every
off-home decode has a matching charge; the engine's stamped per-level
bytes == a fresh `exchange_schedule`).  Exit code 0 iff every identity holds, 1
when one breaks.

``--chrome`` converts the records to the Chrome trace-event format; load
the output at https://ui.perfetto.dev or ``chrome://tracing``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.tracelog import read_jsonl, to_chrome


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="JSONL trace (from --trace PATH)")
    ap.add_argument("--validate", action="store_true",
                    help="replay the trace and prove the counter "
                    "identities; nonzero exit on any failure")
    ap.add_argument("--chrome", default=None, metavar="OUT",
                    help="write Chrome trace-event JSON here")
    ap.add_argument("--summary", action="store_true",
                    help="print record-kind counts and the traced "
                    "sched.summary dicts")
    args = ap.parse_args(argv)
    records = read_jsonl(args.trace)

    if args.summary or not (args.validate or args.chrome):
        kinds = {}
        for r in records:
            kinds[r.get("name", "?")] = kinds.get(r.get("name", "?"), 0) + 1
        for name in sorted(kinds):
            print(f"{kinds[name]:>7}  {name}")
        for r in records:
            if r.get("name") == "sched.summary":
                print(json.dumps(r["args"]))

    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(to_chrome(records), f)
        print(f"# chrome trace: {args.chrome} "
              f"({len(records)} records)")

    if args.validate:
        # local import: reconcile pulls in the engine's analytic model
        from repro_torch.obs.reconcile import ReconcileError, reconcile
        try:
            report = reconcile(records)
        except ReconcileError as e:
            print(f"FAIL {args.trace}: {e}", file=sys.stderr)
            return 1
        print(f"OK {args.trace}: {report['segments']} segment(s), "
              f"served={report['served']}, "
              f"relayout={report['relayout_bytes']}B, "
              f"engine_sorts={report['engine_sorts']}; "
              f"checks: {', '.join(report['checks'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
