"""Per-home paged KV pool with refcounts, LRU free-list and radix prefix
reuse — the serving analogue of the paper's localised chunks.

A slot's KV cache used to be opaque whole-slot state: an affinity hit
saved *relayout bytes* but re-computed the prefix it already held.  This
module splits the prompt side of a slot's cache into fixed-size **pages**
(``page_size`` tokens each) and gives every home its own pool of them:

* pages are **content-addressed** — a page's key is the full token prefix
  it closes (a hash chain over prompt blocks), so two requests sharing a
  prompt prefix share page keys, and the longest-prefix lookup over a
  request's block chain *is* the radix match;
* each pooled page carries a **refcount** (in-flight requests pin it) and
  a ``last_used`` stamp; unreferenced pages form the LRU free-list an
  over-capacity insert evicts from;
* a prefix hit on the request's **own home** attaches the pooled pages
  and skips their prefill compute entirely; attaching never crosses
  homes — a session whose cache lives elsewhere pays the existing
  fork-vs-migrate relayout charge first (scheduler I1), which is the
  paper's fork-free-within-home / charged-across-homes rule extended to
  prefix blocks;
* sharing is **copy-on-write by construction**: attached page *content*
  is copied into the row's private cache region, and the first token a
  row deviates by changes every later page key, so forked continuations
  never alias (COW at page granularity without aliasing machinery).

The pure accounting (``acquire``/``release``/``invalidate`` over a tuple
of `Page`) lives in the scheduler's `SchedState` so `schedcheck` R9 can
certify it exhaustively (invariant I8: refcounts never leak, attach never
crosses homes, capacity is never exceeded).  The device-side content —
per-layer K/V blocks — lives host-side in a `PageStore` owned by the
server, pruned against the pool state after every completion.

Bit-identity note: a page's K/V content is a pure function of the tokens
up to its end (page p attends only to positions < its own — see
`LM.decode_pages`), so an attached page is byte-for-byte the page the row
would have computed; fifo and homed serve identical tokens no matter how
their hit patterns differ.

A copy of `repro/runtime/kvpool.py`: the port imports nothing of the JAX
package, and `tests/test_torch_serve.py` holds the two equal.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple


class Page(NamedTuple):
    """One pooled KV page: its content key, pin count and LRU stamp."""
    key: object
    refs: int
    last_used: float


PoolPages = Tuple[Page, ...]


def prompt_blocks(prompt: Sequence[int], page_size: int) -> Tuple[object, ...]:
    """The cacheable block-key chain of a prompt.

    Block i covers token positions [i*page_size, (i+1)*page_size); only
    *full* pages strictly before the page holding the last prompt token
    are cacheable (the last page is still being written when the first
    output token is sampled).  Keys are the full token prefix each block
    closes — the hash-chain/radix property: equal key => equal tokens so
    far => equal K/V content.
    """
    toks = tuple(int(t) for t in prompt)
    if page_size <= 0 or len(toks) == 0:
        return ()
    n = (len(toks) - 1) // page_size
    return tuple(toks[:(i + 1) * page_size] for i in range(n))


def lookup(pages: PoolPages, blocks: Sequence[object]) -> int:
    """Radix longest-prefix match: how many leading blocks the pool holds."""
    keys = {p.key for p in pages}
    hit = 0
    while hit < len(blocks) and blocks[hit] in keys:
        hit += 1
    return hit


def acquire(pages: PoolPages, blocks: Sequence[object], capacity: int,
            now: float, known: Optional[frozenset] = None
            ) -> Tuple[PoolPages, int]:
    """Pin a request's block chain into one home's pool.

    Returns ``(pages', attached)``.  ``attached`` is the longest-prefix
    hit against ``known`` — the key set at *wave start* (default: the
    pool's current keys): only those pages have content ready to attach;
    a block committed by a wave-mate moments ago is refcounted as shared
    but still computed by this row.  Every block gets refs+1 (present)
    or is inserted with refs=1, evicting the LRU *unreferenced* page when
    the pool is full; a pool pinned full stops inserting (those blocks
    simply stay uncached — correctness never depends on an insert).
    """
    out: List[Page] = list(pages)
    if known is None:
        known = frozenset(p.key for p in out)
    hit = 0
    while hit < len(blocks) and blocks[hit] in known:
        hit += 1
    for b in blocks:
        idx = next((i for i, p in enumerate(out) if p.key == b), None)
        if idx is not None:
            out[idx] = out[idx]._replace(refs=out[idx].refs + 1,
                                         last_used=now)
            continue
        if len(out) >= capacity:
            free = [i for i, p in enumerate(out) if p.refs == 0]
            if not free:
                break                      # pinned full: rest stay uncached
            out.pop(min(free, key=lambda i: (out[i].last_used, i)))
        out.append(Page(b, 1, now))
    return tuple(out), hit


def release(pages: PoolPages, blocks: Sequence[object],
            now: float) -> PoolPages:
    """Unpin a completed request's blocks: refs-1 on each present page.

    Tolerates absent keys (the page was force-invalidated mid-flight —
    the fleet-reliability path: the request finished on its private cache
    copy and simply has nothing left to unpin) and never drives a
    refcount negative.
    """
    out = list(pages)
    for b in blocks:
        for i, p in enumerate(out):
            if p.key == b:
                if p.refs > 0:
                    out[i] = p._replace(refs=p.refs - 1, last_used=now)
                break
    return tuple(out)


def invalidate(pages: PoolPages,
               keys: Optional[Iterable[object]] = None) -> PoolPages:
    """Force-drop pages (all of them when ``keys`` is None) regardless of
    refcounts — device loss / evacuation.  In-flight requests keep their
    private cache copies and their later `release` is tolerated; the next
    request of the session re-enters as a fresh, charged prefill."""
    if keys is None:
        return ()
    drop = set(keys)
    return tuple(p for p in pages if p.key not in drop)


class PageStore:
    """Host-side page content, keyed (home, block-key) — the server's half
    of the pool.  The pure pool state decides *which* keys exist; this
    store holds their per-layer K/V arrays and is pruned to the pool's
    key set after every scheduler transition, so eviction/invalidate in
    the accounting layer frees the bytes here."""

    def __init__(self, tracer=None):
        from repro_torch.obs import NULL_TRACER     # local: keep module zero-dep
        self._data: Dict[int, Dict[object, object]] = {}
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def put(self, home: int, key: object, content) -> None:
        if self.tracer.enabled and not self.has(home, key):
            self.tracer.count("store.pages", 1, cat="pool", home=home)
        self._data.setdefault(home, {})[key] = content

    def get(self, home: int, key: object):
        return self._data.get(home, {}).get(key)

    def has(self, home: int, key: object) -> bool:
        return key in self._data.get(home, {})

    def prune(self, home: int, live_keys: Iterable[object]) -> int:
        """Drop content for keys the pool no longer holds; returns count."""
        live = set(live_keys)
        tbl = self._data.get(home, {})
        dead = [k for k in tbl if k not in live]
        for k in dead:
            del tbl[k]
        if dead and self.tracer.enabled:
            self.tracer.count("store.pages", -len(dead), cat="pool",
                              home=home)
        return len(dead)

    def clear(self) -> None:
        self._data.clear()
