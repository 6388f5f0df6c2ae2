"""Serving-side fault tolerance: drop a lost home's pooled KV pages.

The counterpart of `evacuate_home` in `repro/runtime/ft.py`; the
training `Supervisor` comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import NULL_TRACER


def evacuate_home(scheduler, home: Optional[int] = None,
                  store=None) -> dict:
    """Serving-side device-loss/drain hook: drop one home's pooled prompt
    pages (every home when ``home`` is None) and the host-side content
    backing them.

    The pool state is *accounting*, not truth: in-flight requests hold
    private copies of everything they attached, so they finish untouched
    and their completion-time release finds nothing to unpin.  The
    affected sessions' next requests find no pooled prefix and re-enter as
    fresh, *charged* prefills -- the cost of the loss is paid visibly, in
    the same relayout ledger as every other cross-home byte.
    """
    dropped = scheduler.invalidate_pages(home)
    pruned = 0
    if store is not None:
        homes = scheduler.homes if home is None else [home]
        for h in homes:
            pruned += store.prune(h, scheduler.pool_keys(h))
    rec = {"home": home, "pages_dropped": dropped,
           "content_pruned": pruned}
    getattr(scheduler, "tracer", NULL_TRACER).event(
        "ft.evacuate", cat="ft", **rec)
    return rec
