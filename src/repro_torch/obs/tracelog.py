"""Structured per-wave tracing: spans, events, counters, gauges — zero-dep.

One `Tracer` holds an append-only in-memory record list (thread-safe) and
optionally streams every record to a JSONL sink as it is emitted, so a
crashed run still leaves a readable trace.  Records are plain dicts with
a fixed schema (`KINDS`); `to_chrome` converts any record list to the
Chrome trace-event JSON that ``chrome://tracing`` and Perfetto load
directly.

The four primitives:

``Span``      a timed region (``with tracer.span("sched.form_wave", ...)``),
              nested via an explicit per-thread stack (children record
              their parent's name); emitted at exit with its duration.
              ``Span.set(**kw)`` annotates after the fact, ``Span.event``
              emits an instant event inside the span.
``Event``     an instant decision point ("affinity hit", "charge", ...).
``Counter``   a monotonically accumulated value; each emission carries the
              increment *and* the running total.
``Gauge``     a sampled level (queue depth, live refs) — no accumulation.

`NullTracer` implements the same surface as no-ops returning singletons,
so instrumented hot paths cost one attribute load + one no-op call when
tracing is off — the production default (`NULL_TRACER`).  Code that wants
to skip even argument construction guards on ``tracer.enabled``.

A process-global default tracer (`get_tracer` / `set_tracer`) exists for
layers with no constructor to thread a tracer through (the engine's
eager sort entry); everything else takes an explicit ``tracer=``.

Timestamps are wall-clock microseconds since the tracer's epoch (what
Chrome wants); deterministic simulated clocks (the scheduler's wave
units) ride in ``args`` (``now=...``) so reconciliation never depends on
wall time.

A copy of `repro/obs/tracelog.py`: the port imports nothing of the JAX
package, and `tests/test_torch_serve.py` holds the two equal.
"""
from __future__ import annotations

import io
import json
import threading
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Union

#: record schema: every record is {"kind", "name", "cat", "ts", "tid",
#: "args"}; spans add "dur" and "parent", counters add "value" + "total",
#: gauges add "value".
KINDS = ("span", "event", "counter", "gauge")

#: trace schema version, stamped as the first record of every sink
SCHEMA = 1


class Event(NamedTuple):
    """An instant record (also the return of `Tracer.event`)."""
    name: str
    ts: float
    cat: str = ""
    args: Optional[Dict[str, Any]] = None


class Counter(NamedTuple):
    """One counter sample: the increment and the running total."""
    name: str
    value: float
    total: float


class Gauge(NamedTuple):
    """One sampled level."""
    name: str
    value: float


def _jsonable(v):
    """Coerce numpy scalars / tuples so records always serialise."""
    try:
        json.dumps(v)
        return v
    except TypeError:
        if hasattr(v, "tolist"):             # numpy scalar or array
            return v.tolist()
        if isinstance(v, (tuple, list, set, frozenset)):
            return [_jsonable(x) for x in v]
        if isinstance(v, dict):
            return {str(k): _jsonable(x) for k, x in v.items()}
        return repr(v)


class Span:
    """A timed region; a context manager emitted at ``__exit__``.

    Created by `Tracer.span` — never directly.  Mutating helpers:
    ``set(**kw)`` merges into ``args`` (annotate a span with results
    computed inside it), ``event(name, **kw)`` emits an instant child
    event stamped with this span's name as ``parent``.
    """

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self.parent = None

    def set(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    def event(self, name: str, cat: Optional[str] = None, **args) -> None:
        args.setdefault("parent", self.name)
        self._tracer.event(name, cat=self.cat if cat is None else cat,
                           **args)

    def __enter__(self) -> "Span":
        self._t0 = self._tracer._now()
        stack = self._tracer._stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        t1 = self._tracer._now()
        self._tracer._emit({"kind": "span", "name": self.name,
                            "cat": self.cat, "ts": self._t0,
                            "dur": t1 - self._t0, "parent": self.parent,
                            "args": self.args})
        return False


class _NullSpan:
    """The free span: every method is a no-op returning itself."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self

    def event(self, name, cat=None, **args):
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: same surface, nothing recorded, ~zero cost.

    Hot paths are instrumented unconditionally against this default;
    code that would *build* expensive args first guards on ``enabled``.
    """

    enabled = False

    def span(self, name, cat="", **args):
        return _NULL_SPAN

    def event(self, name, cat="", **args):
        pass

    def count(self, name, value=1, cat="", **args):
        pass

    def gauge(self, name, value, cat="", **args):
        pass

    def records(self):
        return []

    def close(self):
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Thread-safe in-memory trace with an optional streaming JSONL sink.

    ``sink`` is a path or writable text file; every record is written as
    one JSON line the moment it is emitted (the in-memory list is kept
    either way, so `to_chrome`/`records` work without re-reading).  The
    first sinked line is a ``trace.meta`` event carrying the schema
    version.  ``meta`` key/values ride in that header record — stamp the
    run's configuration there (policy, mesh, page_size, ...).
    """

    enabled = True

    def __init__(self, sink: Optional[Union[str, io.TextIOBase]] = None,
                 **meta):
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._totals: Dict[str, float] = {}
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self._file = None
        self._own_file = False
        if isinstance(sink, str):
            self._file = open(sink, "w")
            self._own_file = True
        elif sink is not None:
            self._file = sink
        self.event("trace.meta", cat="trace", schema=SCHEMA, **meta)

    # ------------------------------------------------------------ internals
    def _now(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6   # us since epoch

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _emit(self, rec: Dict[str, Any]) -> None:
        rec.setdefault("tid", threading.get_ident() & 0xFFFF)
        rec["args"] = {k: _jsonable(v)
                       for k, v in (rec.get("args") or {}).items()}
        with self._lock:
            self._records.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------ primitives
    def span(self, name: str, cat: str = "", **args) -> Span:
        return Span(self, name, cat, args)

    def event(self, name: str, cat: str = "", **args) -> None:
        self._emit({"kind": "event", "name": name, "cat": cat,
                    "ts": self._now(), "args": args})

    def count(self, name: str, value: float = 1, cat: str = "",
              **args) -> None:
        with self._lock:
            total = self._totals[name] = self._totals.get(name, 0) + value
        self._emit({"kind": "counter", "name": name, "cat": cat,
                    "ts": self._now(), "value": value, "total": total,
                    "args": args})

    def gauge(self, name: str, value: float, cat: str = "", **args) -> None:
        self._emit({"kind": "gauge", "name": name, "cat": cat,
                    "ts": self._now(), "value": value, "args": args})

    # ------------------------------------------------------------ export
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def total(self, name: str) -> float:
        with self._lock:
            return self._totals.get(name, 0)

    def chrome_trace(self) -> Dict[str, Any]:
        return to_chrome(self.records())

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec) + "\n")

    def dump_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                if self._own_file:
                    self._file.close()
                self._file = None


def to_chrome(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert trace records to Chrome trace-event JSON.

    Spans become complete (``ph="X"``) events, instants become ``ph="i"``
    (thread-scoped), counters and gauges become ``ph="C"`` counter tracks
    (the counter's running total, so the track is monotone).  Load the
    result in ``chrome://tracing`` or https://ui.perfetto.dev.
    """
    out = []
    for r in records:
        base = {"name": r["name"], "cat": r.get("cat") or "trace",
                "pid": 0, "tid": r.get("tid", 0), "ts": r["ts"],
                "args": r.get("args") or {}}
        kind = r["kind"]
        if kind == "span":
            out.append({**base, "ph": "X", "dur": r["dur"]})
        elif kind == "event":
            out.append({**base, "ph": "i", "s": "t"})
        elif kind == "counter":
            out.append({**base, "ph": "C",
                        "args": {"total": r.get("total", r.get("value"))}})
        elif kind == "gauge":
            out.append({**base, "ph": "C", "args": {"value": r["value"]}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL trace back into the record-dict list form."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


# ---------------------------------------------------------------------------
# the process-global default tracer (layers without a constructor to thread
# an explicit tracer through — the engine's eager sort entry)
# ---------------------------------------------------------------------------
_GLOBAL: Union[Tracer, NullTracer] = NULL_TRACER


def get_tracer() -> Union[Tracer, NullTracer]:
    return _GLOBAL


def set_tracer(tracer: Optional[Union[Tracer, NullTracer]]
               ) -> Union[Tracer, NullTracer]:
    """Install the process-global tracer; returns the previous one.
    ``None`` resets to `NULL_TRACER`."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer if tracer is not None else NULL_TRACER
    return prev
