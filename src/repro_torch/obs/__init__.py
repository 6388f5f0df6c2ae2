"""Structured observability: tracing and the per-home metrics registry.

The counterpart of `repro.obs`:

``repro_torch.obs.tracelog``
    `Span`/`Event`/`Counter`/`Gauge`, a thread-safe in-memory `Tracer` with
    a JSONL sink and Chrome trace-event export, and a `NullTracer` whose
    no-op methods keep instrumented hot paths free when tracing is off.

``repro_torch.obs.metrics``
    The per-home metrics registry and the one rendering path
    (`summarise` -> `format_summary` / `bench_rows` / JSON) that the
    serving launcher's exit summary and the trace's ``sched.summary``
    event share.

``repro_torch.obs.reconcile``
    The offline trace validator: schema checks, then the serving
    identities against each ``sched.summary`` and I-engine, each
    ``engine.sort`` span's levels against `exchange_schedule`.
"""
from repro_torch.obs.tracelog import (NULL_TRACER, Counter, Event, Gauge,
                                      NullTracer, Span, Tracer, get_tracer,
                                      read_jsonl, set_tracer, to_chrome)

__all__ = ["Tracer", "NullTracer", "Span", "Event", "Counter", "Gauge",
           "NULL_TRACER", "get_tracer", "set_tracer", "read_jsonl",
           "to_chrome"]
