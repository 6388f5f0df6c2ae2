"""Home-aware serving scheduler: admission, batching, eviction by cache home.

The server homes each decode slot's KV cache on the device that computes it
(`Locale.pin_tree` over the batch-slot axis).  That localises serving
*state*; this module localises serving *decisions*.  The paper's ownership
math (`chunk_bounds`: worker w owns one contiguous chunk) is applied to
decode slots instead of sort chunks: slot s of a B-slot server on an
N-device locale is *homed* on device `Locale.owners(B)[s]`, and every
scheduling decision — which home admits a request, which requests form the
next wave, which cached session is evicted — is made in home terms.

Two policies, selected by ``Scheduler(policy=...)`` (and surfaced as
``DecodeServer(scheduler=...)`` / ``repro.launch.serve --policy``):

``"fifo"``
    The oracle: today's behaviour.  One global queue; a wave is the first B
    queued requests; a request lands on whatever slot frees first, so a
    recurring session's cached KV prefix is dragged to an arbitrary home
    almost every time it returns (cross-home relayout), and a burst of
    long decodes padlocks every slot behind the longest request.

``"homed"``
    The paper's discipline:

    * **admission** — per-home queues.  A request is routed at arrival to
      the home its session's KV already lives on (affinity), else to the
      least-loaded home; it never decodes anywhere but its assigned home.
    * **batch formation** — at each wave boundary the scheduler picks the
      step *target* that maximises slot utilisation over the visible
      queue windows (so short decodes batch with short decodes instead of
      padlocking behind a long one), then every home fills its own slots
      from its own queue, front first, with requests fitting the target.
      A request skipped ``max_skip`` waves forces the target up to its own
      span — aging bounds staleness.
    * **spill** — work conservation: a home with free slots and an empty
      (or drained) queue pulls fitting work from other homes' queues,
      cheapest relayout first (unbound sessions move free; same-pod donors
      break ties so a spill crosses DCN only when ICI has nothing to
      give), and the bytes it does move are charged — measured, not
      hidden.  A spilled session with work still queued at its bound home
      takes a one-way *copy* (the canonical cache stays put); it migrates
      only when nothing remains for it at home.
    * **eviction/compaction** — per-home LRU over session bindings.  A
      binding is only ever *dropped* on its own home, never migrated to
      another home's table: a live cache never moves off its home.

Relayout accounting is analytic, like `engine.exchange_schedule`: moving a
session with T cached tokens across homes costs ``T * kv_bytes_per_token``
bytes, split inter-pod vs intra-pod on hierarchical (pod-major) locales.
Both policies run bit-identical decode compute for the same request set
(the server's fixed ``prompt_pad`` makes each row's numerics independent
of wave composition), so the byte/step deltas are pure scheduling wins.

Every decision above is made by *pure transition functions* over an
immutable `SchedState` — ``route_t``, ``form_wave_t``, ``complete_t``:
state in, ``(state', placements, charges)`` out, the `exchange_network`
move.  The `Scheduler` class is a thin stateful shell that
replays the charges into its stats tables; `repro.analysis.schedcheck`
(rule R9) exhaustively explores the same transitions over a small-config
lattice and certifies the invariants the docstring promises.  The
``SchedConfig.mutations`` hook exists solely for that checker's committed
known-bad fixtures — production schedulers never set it.

A copy of `repro/runtime/scheduler.py`: the port imports nothing of the JAX
package, and `tests/test_torch_serve.py` holds the two equal.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import (Dict, FrozenSet, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.obs import NULL_TRACER
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import kvpool
from repro_torch.runtime.kvpool import Page

POLICIES = ("fifo", "homed")

# known-bad transition variants `analysis/fixtures.py` commits for R9;
# every name here must make `schedcheck.certify` produce a witness
MUTATIONS = ("no_aging", "drop_charge", "greedy_spill", "leak_page")


def kv_bytes_per_token(cfg) -> int:
    """Analytic KV-cache bytes one decoded token pins to a slot's home.

    The attention K+V rows per *attention* layer (`cfg.attn_layers` — the
    full stack for pure-attention families, the sparse subset for hybrids,
    empty for pure-SSM): the dominant, relayout-priced state.  SSM members
    carry O(1)-per-sequence state and are ignored, like small replicated
    leaves in `Locale.pin_tree`.  The itemsize is the torch dtype's (numpy
    knows no ``"bfloat16"``).
    """
    itemsize = getattr(torch, cfg.dtype).itemsize
    return len(cfg.attn_layers) * 2 * cfg.num_kv_heads * cfg.head_dim \
        * itemsize


# ---------------------------------------------------------------------------
# the pure transition layer: immutable config/state, inspectable decisions
# ---------------------------------------------------------------------------
class ReqInfo(NamedTuple):
    """What a scheduling decision may observe about one request.

    ``rid`` is any unique hashable id (the shell uses its submission
    counter); ``span`` is the slot occupancy in wave steps — with a fixed
    server pad bucket every wave prefills ``prompt_pad`` rows regardless
    of the admitted prompts, so the span that predicts wave cost uses the
    bucket, not the raw prompt length.

    ``blocks`` is the prompt's cacheable page-key chain
    (`kvpool.prompt_blocks`) when the server runs a paged pool, else
    empty — the radix key the wave uses for prefix attach."""
    rid: object
    span: int
    session: object = None
    blocks: Tuple = ()


class QEntry(NamedTuple):
    req: ReqInfo
    skips: int = 0


class Binding(NamedTuple):
    """Where a session's cached KV prefix lives: its *home* and size."""
    session: object
    home: int
    tokens: int
    last_used: float


class Placement(NamedTuple):
    """One admitted request: decodes on ``home`` (which owns ``slot``);
    ``spilled_from`` names the donor queue when work conservation pulled
    it across homes, else None.  ``attached`` counts the leading prompt
    pages the home's pool already held at wave start — prefill compute
    the server skips by attaching pooled KV instead of recomputing."""
    slot: int
    rid: object
    home: int
    spilled_from: Optional[int] = None
    attached: int = 0


class Charge(NamedTuple):
    """One session-cache relayout the wave decided to pay.  ``migrate``
    distinguishes a rebind (the canonical cache moved) from the one-way
    *fork* copy a spill takes when the session still has work queued at
    its bound home."""
    rid: object
    session: object
    src: int
    dst: int
    tokens: int
    nbytes: int
    inter_pod: bool
    migrate: bool


class Charges(NamedTuple):
    """Everything `form_wave_t` decided to pay and why: the replayable
    accounting record the shell turns into stats and R9 audits move-by-
    move against an independent model."""
    moves: Tuple[Charge, ...]
    target: int
    floor: int


@dataclass(frozen=True)
class SchedConfig:
    """The immutable decision parameters (`Scheduler.__init__` validated).

    ``mutations`` enables committed known-bad transition variants for the
    R9 checker (`MUTATIONS`); production configs leave it empty."""
    policy: str = "fifo"
    n_slots: int = 1
    owners: Tuple[int, ...] = (0,)
    bytes_per_token: int = 0
    lookahead: int = 8
    max_skip: int = 4
    homes_per_pod: Optional[int] = None
    session_capacity: int = 4
    affinity_slack: int = 2
    page_capacity: int = 0       # pooled KV pages per home; 0 = no pool
    mutations: FrozenSet[str] = frozenset()

    @property
    def homes(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.owners)))

    @property
    def slots_of(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for s, h in enumerate(self.owners):
            out.setdefault(h, []).append(s)
        return out

    def pod(self, home: int) -> int:
        return home // self.homes_per_pod if self.homes_per_pod else 0


@dataclass(frozen=True)
class SchedState:
    """The entire mutable world a decision may read, as immutable tuples.

    ``queues`` maps home -> arrival-ordered entries; ``bindings`` keeps
    the session table in *insertion order* (dict semantics: an update
    keeps its slot, a new binding appends) because LRU eviction ties on
    ``last_used`` break by that order; ``forked`` holds rids of in-flight
    spill copies that must not rebind at completion; ``pools`` maps
    home -> its paged-KV pool (`kvpool.Page` tuples) when the config
    runs one (``page_capacity > 0``)."""
    queues: Tuple[Tuple[int, Tuple[QEntry, ...]], ...] = ()
    fifo: Tuple[ReqInfo, ...] = ()
    bindings: Tuple[Binding, ...] = ()
    forked: FrozenSet[object] = frozenset()
    pools: Tuple[Tuple[int, Tuple[Page, ...]], ...] = ()

    def queue(self, home: int) -> Tuple[QEntry, ...]:
        for h, q in self.queues:
            if h == home:
                return q
        return ()

    def pool(self, home: int) -> Tuple[Page, ...]:
        for h, p in self.pools:
            if h == home:
                return p
        return ()

    def binding(self, session) -> Optional[Binding]:
        if session is None:
            return None
        for b in self.bindings:
            if b.session == session:
                return b
        return None

    @property
    def pending(self) -> int:
        return len(self.fifo) + sum(len(q) for _, q in self.queues)


def initial_state(cfg: SchedConfig) -> SchedState:
    pools = tuple((h, ()) for h in cfg.homes) if cfg.page_capacity > 0 \
        else ()
    return SchedState(queues=tuple((h, ()) for h in cfg.homes),
                      pools=pools)


def _queues_dict(state: SchedState) -> Dict[int, List[QEntry]]:
    return {h: list(q) for h, q in state.queues}


def _bindings_dict(state: SchedState) -> Dict[object, Binding]:
    return {b.session: b for b in state.bindings}


def _pools_dict(state: SchedState) -> Dict[int, Tuple[Page, ...]]:
    return {h: p for h, p in state.pools}


def _pool_refs(state: SchedState) -> Dict[int, int]:
    """Per-home live page refcounts — the traced pool-identity quantity."""
    return {h: sum(pg.refs for pg in p) for h, p in state.pools}


def _pack(queues: Dict[int, List[QEntry]], fifo: List[ReqInfo],
          bindings: Dict[object, Binding], forked: FrozenSet[object],
          pools: Dict[int, Tuple[Page, ...]]) -> SchedState:
    return SchedState(
        queues=tuple((h, tuple(q)) for h, q in queues.items()),
        fifo=tuple(fifo), bindings=tuple(bindings.values()), forked=forked,
        pools=tuple((h, tuple(p)) for h, p in pools.items()))


def route_t(cfg: SchedConfig, state: SchedState,
            req: ReqInfo) -> Tuple[SchedState, int]:
    """Admit one arrival: returns ``(state', home)``.  Affinity keeps a
    bound session with its cache unless its home's queue runs
    ``affinity_slack`` entries past the least-loaded one (the hot-home
    relief valve); an unbound request always balances."""
    if cfg.policy == "fifo":
        return _pack(_queues_dict(state), list(state.fifo) + [req],
                     _bindings_dict(state), state.forked,
                     _pools_dict(state)), -1
    queues = _queues_dict(state)
    b = state.binding(req.session)
    least = min(cfg.homes, key=lambda h: (len(queues[h]), h))
    if (b is not None and b.home in queues
            and len(queues[b.home]) - len(queues[least])
            <= cfg.affinity_slack):
        home = b.home                       # affinity: stay with the cache
    else:
        # no cached home, or the bound home is running hot: balance wins
        # (any cached prefix is dragged along — charged at admission)
        home = least
    queues[home].append(QEntry(req))
    return _pack(queues, list(state.fifo), _bindings_dict(state),
                 state.forked, _pools_dict(state)), home


class _WaveCtx:
    """Mutable scratch shared by one `form_wave_t` call: the evolving
    binding table, the per-wave cache-copy sites, the per-home page
    pools, and the move record."""

    def __init__(self, cfg: SchedConfig, state: SchedState,
                 now: float = 0.0):
        self.cfg = cfg
        self.now = now
        self.bindings = _bindings_dict(state)
        self.forked = set(state.forked)
        self.sites: Dict[object, set] = {}   # session -> homes holding a
        #   copy of its cache *this wave* (a second request reuses it free)
        self.moves: List[Charge] = []
        self.pools = _pools_dict(state)
        # the attachable key set is frozen at wave start: a page a wave-
        # mate inserts *this wave* is refcount-shared but its content is
        # not in the home's store yet, so it cannot be attached
        self.known = {h: frozenset(pg.key for pg in p)
                      for h, p in self.pools.items()}

    def attach_pages(self, req: ReqInfo, home: int) -> int:
        """Pin ``req``'s block chain into ``home``'s pool; returns the
        attachable longest-prefix hit.  Attach never crosses homes: the
        only pool consulted is the landing home's own — a prefix cached
        elsewhere is invisible here and gets recomputed (or the session
        pays the fork/migrate charge that brought it, which `charge_move`
        already recorded)."""
        if not req.blocks or self.cfg.page_capacity <= 0:
            return 0
        pages, hit = kvpool.acquire(
            tuple(self.pools.get(home, ())), req.blocks,
            self.cfg.page_capacity, self.now,
            self.known.get(home, frozenset()))
        self.pools[home] = pages
        return hit

    def charge_move(self, req: ReqInfo, new_home: int,
                    migrate: bool = True) -> None:
        """Account the session-cache relayout implied by landing off-home.

        ``migrate=False`` is the *fork* form a spill uses when the session
        still has work queued on its bound home: the cached prefix is
        copied to the spill home for this one request (bytes charged) but
        the canonical cache — and every later request's affinity — stays
        put, so the session doesn't ping-pong home every wave.
        """
        b = self.bindings.get(req.session) if req.session is not None \
            else None
        if b is None:
            return
        sites = self.sites.setdefault(req.session, {b.home})
        if new_home not in sites and new_home != b.home:
            if "drop_charge" not in self.cfg.mutations:
                self.moves.append(Charge(
                    rid=req.rid, session=req.session, src=b.home,
                    dst=new_home, tokens=b.tokens,
                    nbytes=b.tokens * self.cfg.bytes_per_token,
                    inter_pod=self.cfg.pod(b.home) != self.cfg.pod(new_home),
                    migrate=migrate))
        sites.add(new_home)
        if migrate:
            self.bindings[b.session] = b._replace(home=new_home)
        elif new_home != b.home:
            self.forked.add(req.rid)        # one-way copy; don't rebind


def _pick_target(cfg: SchedConfig, queues: Dict[int, List[QEntry]],
                 free_of: Dict[int, List[int]]) -> Tuple[int, int]:
    """The wave's step target: the span that maximises slot utilisation.

    Candidate targets are the distinct spans visible in the per-home
    lookahead windows; for each, the admissible work is every windowed
    entry fitting it (capped by the *free* slots per home — under
    continuous batching a wave refills only the slots that drained —
    spill-eligible across homes), and the wave utilisation is that work
    over the capacity the wave would offer (``free * target``).  Short
    decodes therefore batch with short decodes instead of padlocking
    behind a long one — but an *aged* entry (skipped ``max_skip`` waves)
    bounds staleness by forcing the target up to its own span.  Returns
    ``(target, floor)``; target 0 = nothing queued.
    """
    n_free = sum(len(s) for s in free_of.values())
    windows = [queues[h][:cfg.lookahead] for h in cfg.homes]
    spans = sorted({e.req.span for w in windows for e in w})
    if not spans or n_free == 0:
        return 0, 0
    # drain-all guard: when everything queued fits one wave, splitting
    # it by span class only buys extra prefill waves — take it all
    if (sum(len(q) for q in queues.values()) <= n_free
            and all(len(q) <= cfg.lookahead for q in queues.values())):
        return spans[-1], 0
    floor = 0 if "no_aging" in cfg.mutations else \
        max((e.req.span for w in windows for e in w
             if e.skips >= cfg.max_skip), default=0)
    best_t, best_eff = 0, -1.0
    for t in spans:
        if t < floor:
            continue
        busy, used, pool = 0, 0, []
        for h, w in zip(cfg.homes, windows):
            fits = sorted(e.req.span for e in w if e.req.span <= t)
            cap = len(free_of.get(h, ()))
            busy += sum(fits[:cap])              # this home's own slots
            used += min(len(fits), cap)
            pool += fits[cap:]                   # spill-eligible excess
        busy += sum(sorted(pool)[:n_free - used])
        eff = busy / (n_free * t)
        if eff > best_eff + 1e-12:
            best_t, best_eff = t, eff
    return max(best_t, floor), floor


def _place(ctx: _WaveCtx, queues: Dict[int, List[QEntry]],
           placements: List[Placement], slot: int, req: ReqInfo,
           home: int, spilled_from: Optional[int] = None) -> None:
    """Admit one request onto one slot: charge the relayout its landing
    implies (fork vs migrate — see `_WaveCtx.charge_move`), pin its
    prompt pages into the landing home's pool, and keep the invariant
    that a request only ever decodes on the home owning its slot."""
    b = ctx.bindings.get(req.session) if req.session is not None else None
    migrate = not (b is not None and b.home != home
                   and b.home in queues
                   and any(x.req.session == req.session
                           for x in queues[b.home]))
    ctx.charge_move(req, home, migrate=migrate)
    assert ctx.cfg.owners[slot] == home          # the invariant
    attached = ctx.attach_pages(req, home)
    placements.append(Placement(slot, req.rid, home, spilled_from,
                                attached))


def form_wave_t(cfg: SchedConfig, state: SchedState,
                free: Optional[Sequence[int]] = None, now: float = 0.0
                ) -> Tuple[SchedState, Tuple[Placement, ...], Charges]:
    """One wave-boundary batch, purely: ``(state', placements, charges)``.

    ``free`` is the set of slot indices available this wave — ``None``
    means all of them (the legacy whole-wave boundary); under continuous
    batching the server passes just the slots whose requests drained, so
    a freed slot refills mid-wave while its neighbours keep decoding.

    Placements come back in *decision order* (fill before spill) so a
    checker can replay them against the pre-wave queues; the shell sorts
    by slot before reporting.  Every placement decodes on the home that
    owns its slot, every cache byte the decisions move is a `Charge` in
    ``charges.moves``, and every prompt page a placement pins into its
    home's pool is refcounted in ``state'.pools`` — the complete
    accounting record.
    """
    free_slots = sorted(range(cfg.n_slots) if free is None else free)
    if cfg.policy == "fifo":
        ctx = _WaveCtx(cfg, state, now)
        fifo = list(state.fifo)
        placements: List[Placement] = []
        for slot in free_slots:                  # whatever slot frees first
            if not fifo:
                break
            req = fifo.pop(0)
            ctx.charge_move(req, cfg.owners[slot])
            attached = ctx.attach_pages(req, cfg.owners[slot])
            placements.append(Placement(slot, req.rid, cfg.owners[slot],
                                        None, attached))
        return (_pack(_queues_dict(state), fifo, ctx.bindings,
                      frozenset(ctx.forked), ctx.pools),
                tuple(placements), Charges(tuple(ctx.moves), 0, 0))

    ctx = _WaveCtx(cfg, state, now)
    queues = _queues_dict(state)
    placements = []
    free_set = set(free_slots)
    free_of: Dict[int, List[int]] = {
        h: [s for s in slots if s in free_set]
        for h, slots in cfg.slots_of.items()}
    if free is not None:
        # continuous refill: per-slot position clocks removed the
        # alignment constraint, so span classes no longer gate admission
        # — any queued span can take any free slot without padlocking
        # its neighbours.  Admit front-first; locality still decides
        # *where* (fill own home, then charged spill).
        windows = [queues[h][:cfg.lookahead] for h in cfg.homes]
        target = max((e.req.span for w in windows for e in w), default=0)
        floor = 0
    else:
        target, floor = _pick_target(cfg, queues, free_of)
    if target == 0:
        return state, (), Charges((), 0, floor)
    # 2. fill: each home admits from its own queue, front first (bounded
    # lookahead), every entry whose span fits the target — which
    # `_pick_target` already raised above every aged entry's span, so
    # nothing admissible can outgrow the wave mid-fill
    for h in cfg.homes:
        q = queues[h]
        kept: List[QEntry] = []
        scanned = 0
        while q and free_of[h] and scanned < cfg.lookahead:
            e = q.pop(0)
            scanned += 1
            if e.req.span <= target:
                _place(ctx, queues, placements, free_of[h].pop(0), e.req,
                       h)
            else:
                kept.append(e._replace(skips=e.skips + 1))
        q[:0] = kept
    # 3. spill: idle capacity pulls fitting work from other queues —
    # work conservation over strict affinity.  Donor choice minimises
    # the relayout it causes: unbound (or already-here) sessions move
    # free, bound ones cost their cached tokens; same-pod donors break
    # ties so a spill crosses DCN only when ICI has nothing to give.
    greedy = "greedy_spill" in cfg.mutations
    for h in cfg.homes:
        while free_of[h]:
            pick = None
            for d in cfg.homes:
                if d == h:
                    continue
                for i, e in enumerate(queues[d][:cfg.lookahead]):
                    if e.req.span > target:
                        continue
                    b = (ctx.bindings.get(e.req.session)
                         if e.req.session is not None else None)
                    cost = (0 if b is None or b.home == h
                            or h in ctx.sites.get(e.req.session, ())
                            else b.tokens)
                    key = (cost, cfg.pod(d) != cfg.pod(h),
                           -len(queues[d]), d, i)
                    if pick is None or (not greedy and key < pick[0]):
                        pick = (key, d, i)
                if greedy and pick is not None:
                    break
            if pick is None:
                break
            _, d, i = pick
            e = queues[d].pop(i)
            _place(ctx, queues, placements, free_of[h].pop(0), e.req, h,
                   spilled_from=d)
    return (_pack(queues, list(state.fifo), ctx.bindings,
                  frozenset(ctx.forked), ctx.pools),
            tuple(placements), Charges(tuple(ctx.moves), target, floor))


class Served(NamedTuple):
    """What completion reports per request: its final cached size and
    the prompt-page chain it pinned at formation (released here)."""
    rid: object
    session: object
    home: int
    tokens: int
    blocks: Tuple = ()


def complete_t(cfg: SchedConfig, state: SchedState,
               served: Sequence[Served], now: float
               ) -> Tuple[SchedState, Tuple[Binding, ...]]:
    """Rebind completed sessions (LRU-touch fork copies instead), release
    the page refcounts formation acquired, and run per-home LRU
    compaction: returns ``(state', evicted_bindings)``.  Evicted bindings
    are *dropped on their own home*, never migrated — a cached session
    leaves its home only by being freed."""
    bindings = _bindings_dict(state)
    forked = set(state.forked)
    pools = _pools_dict(state)
    evicted: List[Binding] = []
    for sv in served:
        # unpin the prompt pages this request held in flight (absent keys
        # tolerated: a mid-flight invalidation already dropped them)
        if sv.blocks and sv.home in pools \
                and "leak_page" not in cfg.mutations:
            pools[sv.home] = kvpool.release(pools[sv.home], sv.blocks, now)
        if sv.session is None:
            continue
        if sv.rid in forked:
            # a spill copy: the canonical cache never left its home
            forked.discard(sv.rid)
            b = bindings.get(sv.session)
            if b is not None:
                bindings[sv.session] = b._replace(last_used=now)
            continue
        bindings[sv.session] = Binding(sv.session, sv.home, sv.tokens, now)
        # sort once, take the over-capacity prefix oldest-first (ties
        # break by insertion order — the sort is stable over the dict)
        mine = [b for b in bindings.values() if b.home == sv.home]
        if len(mine) > cfg.session_capacity:
            mine.sort(key=lambda b: b.last_used)
            for b in mine[:len(mine) - cfg.session_capacity]:
                del bindings[b.session]
                evicted.append(b)
    return _pack(_queues_dict(state), list(state.fifo), bindings,
                 frozenset(forked), pools), tuple(evicted)


# ---------------------------------------------------------------------------
# the stateful shell: arrival clock, request objects, stats
# ---------------------------------------------------------------------------
@dataclass
class HomeStats:
    admitted: int = 0
    spilled_in: int = 0
    spilled_out: int = 0
    evicted: int = 0
    relayout_bytes: int = 0      # bytes charged for sessions moved ONTO this home


@dataclass
class ScheduleStats:
    """Deterministic per-run accounting (wall clock lives in the bench)."""
    homes: Dict[int, HomeStats] = field(default_factory=dict)
    waves: int = 0
    steps: float = 0.0           # wave cost units: prefill rows + decode steps
    slot_steps: float = 0.0      # n_slots * steps (capacity offered)
    busy_slot_steps: float = 0.0 # sum over served reqs of their own span
    waits: List[float] = field(default_factory=list)
    relayout_bytes: int = 0      # total cross-home session-cache movement
    inter_pod_bytes: int = 0     # subset crossing a pod boundary
    intra_pod_bytes: int = 0
    relayout_events: int = 0
    served: int = 0
    tokens_out: int = 0
    affinity_hits: int = 0       # placements landing on the session's home
    pages_attached: int = 0      # pooled prompt pages reused (prefill skipped)
    prefix_hits_full: int = 0    # placements attaching their whole chain
    prefix_hits_partial: int = 0 # placements attaching a proper prefix

    def wait_pct(self, q: float) -> float:
        if not self.waits:
            return 0.0
        return float(np.percentile(np.asarray(self.waits), q))


class Scheduler:
    """Route, batch and evict decode requests by KV-cache home.

    A thin shell over the pure transitions above: it owns the arrival
    heap, the `Request` objects and the stats tables; every decision is
    `route_t`/`form_wave_t`/`complete_t` on ``self.state``, and the stats
    are replayed from the `Charges` those transitions return.

    ``owners`` maps slot index -> home-device index (``Locale.owners``:
    `chunk_bounds` applied to slots).  ``homes_per_pod`` is the number of
    homes per pod on a hierarchical (pod-major) locale — it only affects
    the inter/intra-pod split of the relayout bytes and the spill donor
    preference; ``None`` means a flat (single-distance-class) locale.
    """

    def __init__(self, n_slots: int, owners: Optional[Sequence[int]] = None,
                 policy: str = "fifo", bytes_per_token: int = 0,
                 lookahead: int = 8, max_skip: int = 4,
                 homes_per_pod: Optional[int] = None,
                 session_capacity: Optional[int] = None,
                 affinity_slack: Optional[int] = None,
                 prompt_pad: Optional[int] = None,
                 page_size: int = 0, page_capacity: int = 0,
                 tracer=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; want one of "
                             f"{POLICIES}")
        owners = tuple(owners) if owners is not None else (0,) * n_slots
        if len(owners) != n_slots:
            raise ValueError(f"owners maps {len(owners)} slots, server has "
                             f"{n_slots}")
        if page_capacity > 0 and page_size <= 0:
            raise ValueError("page_capacity needs a positive page_size")
        sph = max(len(v) for v in SchedConfig(owners=owners).slots_of
                  .values())
        self.cfg = SchedConfig(
            policy=policy, n_slots=n_slots, owners=owners,
            bytes_per_token=bytes_per_token, lookahead=lookahead,
            max_skip=max_skip, homes_per_pod=homes_per_pod,
            session_capacity=(session_capacity if session_capacity
                              is not None else 4 * sph),
            # affinity yields to balance once the bound home's queue runs
            # this many entries past the least-loaded one (the hot-home
            # relief valve)
            affinity_slack=(affinity_slack if affinity_slack is not None
                            else 2 * sph),
            page_capacity=page_capacity)
        self.prompt_pad = prompt_pad     # the server's fixed prefill bucket
        self.page_size = page_size       # tokens per pooled KV page
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = obs_metrics.MetricsRegistry()
        self.state = initial_state(self.cfg)
        self._future: List[Tuple[float, int, object]] = []   # arrival heap
        self._seq = 0
        self._uid = 0                        # monotone ReqInfo.rid source
        self._reqs: Dict[int, object] = {}   # uid -> queued Request
        self.stats = ScheduleStats(
            homes={h: HomeStats() for h in self.homes})

    # config views (the shell's public surface predates SchedConfig)
    policy = property(lambda self: self.cfg.policy)
    n_slots = property(lambda self: self.cfg.n_slots)
    owners = property(lambda self: self.cfg.owners)
    bytes_per_token = property(lambda self: self.cfg.bytes_per_token)
    lookahead = property(lambda self: self.cfg.lookahead)
    max_skip = property(lambda self: self.cfg.max_skip)
    homes_per_pod = property(lambda self: self.cfg.homes_per_pod)
    session_capacity = property(lambda self: self.cfg.session_capacity)
    affinity_slack = property(lambda self: self.cfg.affinity_slack)
    slots_of = property(lambda self: self.cfg.slots_of)
    page_capacity = property(lambda self: self.cfg.page_capacity)

    @property
    def homes(self) -> List[int]:
        return list(self.cfg.homes)

    # ------------------------------------------------------------ submission
    def submit(self, req) -> None:
        """Enqueue a request for admission at its arrival time ``t_arrive``."""
        heapq.heappush(self._future,
                       (float(getattr(req, "t_arrive", 0.0)), self._seq, req))
        self._seq += 1

    def has_work(self) -> bool:
        return bool(self._future) or self.state.pending > 0

    def clock(self, now: float) -> float:
        """Advance the clock to the next actionable instant (arrival jump)."""
        if self.state.pending:
            return now
        if self._future:
            return max(now, self._future[0][0])
        return now

    def _span(self, req) -> int:
        return (self.prompt_pad or len(req.prompt)) + req.max_new

    def _admit(self, now: float) -> None:
        while self._future and self._future[0][0] <= now:
            _, _, req = heapq.heappop(self._future)
            uid, self._uid = self._uid, self._uid + 1
            blocks = (kvpool.prompt_blocks(req.prompt, self.page_size)
                      if self.cfg.page_capacity > 0 else ())
            info = ReqInfo(rid=uid, span=self._span(req),
                           session=req.session, blocks=blocks)
            req._sched_blocks = blocks
            self._reqs[uid] = req
            pre_b = self.state.binding(req.session)
            self.state, home = route_t(self.cfg, self.state, info)
            if home >= 0:
                req.home = home
            if self.tracer.enabled:
                self.tracer.event(
                    "sched.route", cat="sched", rid=uid,
                    session=req.session, home=home, now=now,
                    span=info.span, blocks=len(blocks),
                    affinity=(pre_b is not None and home == pre_b.home))

    # ------------------------------------------------------------ formation
    def form_wave(self, now: float,
                  free_slots: Optional[Sequence[int]] = None
                  ) -> List[Tuple[int, object]]:
        """One wave-boundary batch: ``[(slot, request), ...]`` placements.

        ``free_slots`` restricts the wave to the slots that actually
        drained (continuous batching); ``None`` offers every slot — the
        legacy whole-wave boundary.  Every returned request decodes on
        the home that owns its slot; the caller serves the wave and then
        reports it back via `complete`.
        """
        tr = self.tracer
        with tr.span("sched.form_wave", cat="sched", now=now,
                     free=(len(free_slots) if free_slots is not None
                           else self.n_slots)) as sp:
            self._admit(now)
            pre_homes = {b.session: b.home for b in self.state.bindings}
            pre_refs = _pool_refs(self.state)
            self.state, placements, charges = form_wave_t(
                self.cfg, self.state, free=free_slots, now=now)
            # the wave id the events carry: stats.waves is bumped below
            # only for non-empty waves, so this is the id it will get
            wid = self.stats.waves + (1 if placements else 0)
            charged = 0
            for c in charges.moves:
                if c.nbytes:
                    self.stats.relayout_bytes += c.nbytes
                    self.stats.relayout_events += 1
                    self.stats.homes[c.dst].relayout_bytes += c.nbytes
                    if c.inter_pod:
                        self.stats.inter_pod_bytes += c.nbytes
                    else:
                        self.stats.intra_pod_bytes += c.nbytes
                charged += c.nbytes
                tr.event("sched.charge", cat="sched", wave=wid, rid=c.rid,
                         session=c.session, src=c.src, dst=c.dst,
                         tokens=c.tokens, nbytes=c.nbytes,
                         inter_pod=c.inter_pod, migrate=c.migrate)
            # pool refs the wave's attaches pinned (reconcile identity:
            # acquires - releases - invalidations == live refs)
            for h, refs in _pool_refs(self.state).items():
                if refs - pre_refs.get(h, 0) > 0:
                    tr.event("pool.acquire", cat="pool", wave=wid, home=h,
                             refs=refs - pre_refs.get(h, 0))
            wave = []
            for p in placements:
                req = self._reqs.pop(p.rid)
                req.home = p.home
                req._sched_uid = p.rid      # complete() keys forked by it
                req._attached = p.attached  # pages the server may attach
                nblk = len(getattr(req, "_sched_blocks", ()))
                if p.attached:
                    self.stats.pages_attached += p.attached
                    if p.attached == nblk:
                        self.stats.prefix_hits_full += 1
                    else:
                        self.stats.prefix_hits_partial += 1
                if p.spilled_from is not None:
                    self.stats.homes[p.spilled_from].spilled_out += 1
                    self.stats.homes[p.home].spilled_in += 1
                elif (self.cfg.policy == "homed"
                      and pre_homes.get(req.session) == p.home):
                    self.stats.affinity_hits += 1
                # decision order matters: the reconciler replays the
                # same-wave cache-copy sites from this event sequence
                tr.event("sched.place", cat="sched", wave=wid, rid=p.rid,
                         slot=p.slot, home=p.home, session=req.session,
                         spilled_from=p.spilled_from, attached=p.attached,
                         blocks=nblk, bound_home=pre_homes.get(req.session),
                         wait=now - float(getattr(req, "t_arrive", 0.0)))
                wave.append((p.slot, req))
            wave.sort(key=lambda sr: sr[0])
            if wave:
                self.stats.waves += 1
            waits = []
            for _slot, req in wave:
                req.wait = now - float(getattr(req, "t_arrive", 0.0))
                self.stats.waits.append(req.wait)
                waits.append(req.wait)
                self.stats.homes[req.home].admitted += 1
            sp.set(wave=wid, target=charges.target, floor=charges.floor,
                   placed=len(placements), charged_bytes=charged)
            if wave:
                self.metrics.record_wave(
                    self.cfg, self.state, wid, now, charges.target,
                    placements, waits, self.utilisation(), tracer=tr)
        return wave

    # ------------------------------------------------------------ completion
    def tick(self, units: float) -> None:
        """Account wave-cost units as they happen (continuous batching:
        there is no single per-wave cost — prefill page levels and decode
        steps interleave across refills)."""
        self.stats.steps += units
        self.stats.slot_steps += self.n_slots * units

    def complete(self, placements, now: float, steps: float = 0.0) -> None:
        """Report served requests: update stats, session bindings (LRU)
        and page refcounts.  ``steps`` adds a whole-wave cost for legacy
        callers; continuous servers account costs via `tick` and complete
        requests as their slots drain (possibly a subset of a wave)."""
        if steps:
            self.tick(steps)
        tr = self.tracer
        with tr.span("sched.complete", cat="sched", now=now,
                     served=len(placements)) as sp:
            served = []
            for _slot, req in placements:
                self.stats.served += 1
                self.stats.tokens_out += len(req.out)
                self.stats.busy_slot_steps += len(req.prompt) + len(req.out)
                served.append(Served(
                    rid=getattr(req, "_sched_uid", id(req)),
                    session=req.session,
                    home=req.home, tokens=len(req.prompt) + len(req.out),
                    blocks=getattr(req, "_sched_blocks", ())))
            pre_refs = _pool_refs(self.state)
            self.state, evicted = complete_t(self.cfg, self.state, served,
                                             now)
            for b in evicted:
                self.stats.homes[b.home].evicted += 1
                tr.event("sched.evict", cat="sched", session=b.session,
                         home=b.home, now=now)
            post_refs = _pool_refs(self.state)
            for h, refs in pre_refs.items():
                dropped = refs - post_refs.get(h, 0)
                if dropped > 0:
                    tr.event("pool.release", cat="pool", home=h,
                             refs=dropped, now=now)
            sp.set(evicted=len(evicted))

    # ------------------------------------------------------------ page pool
    def pool_keys(self, home: int) -> List[object]:
        """The block keys ``home``'s pool currently holds (server pruning)."""
        return [p.key for p in self.state.pool(home)]

    def invalidate_pages(self, home: Optional[int] = None) -> int:
        """Force-drop pooled pages (all homes when ``home`` is None)
        regardless of refcounts — the fleet-reliability path after a home
        loses its device state.  In-flight requests finish on their
        private cache copies (their later release is tolerated); the
        session's next request re-enters as a fresh, charged prefill.
        Returns the number of pages dropped."""
        pools = _pools_dict(self.state)
        dropped = 0
        for h in list(pools):
            if home is not None and h != home:
                continue
            npages = len(pools[h])
            if npages:
                self.tracer.event(
                    "pool.invalidate", cat="pool", home=h, pages=npages,
                    refs=sum(pg.refs for pg in pools[h]))
            dropped += npages
            pools[h] = kvpool.invalidate(pools[h])
        self.state = _pack(_queues_dict(self.state), list(self.state.fifo),
                           _bindings_dict(self.state), self.state.forked,
                           pools)
        return dropped

    # ------------------------------------------------------------ reporting
    def binding_home(self, session) -> Optional[int]:
        b = self.state.binding(session)
        return b.home if b is not None else None

    def utilisation(self) -> float:
        if not self.stats.slot_steps:
            return 0.0
        return self.stats.busy_slot_steps / self.stats.slot_steps

    def prefill_rows_saved(self) -> float:
        """Prefill compute avoided by page attach, in the bench's row
        units: one 'row' = one request's ``prompt_pad``-token prefill, so
        attached pages convert at ``page_size / prompt_pad`` rows each."""
        if not self.prompt_pad or not self.page_size:
            return 0.0
        return self.stats.pages_attached * self.page_size / self.prompt_pad

    def summary(self) -> Dict:
        """The canonical summary dict (see `repro_torch.obs.metrics.summarise`).
        One rendering path: the launcher's human report, bench_serve's CSV
        rows and the trace's ``sched.summary`` event all read this dict."""
        return obs_metrics.summarise(self)

    def format_summary(self) -> str:
        """The launcher's exit report: one line per home, then totals."""
        return obs_metrics.format_summary(self.summary())

    def emit_summary(self) -> Dict:
        """Emit the final summary into the trace (the reconciliation
        target) and return it.  A trace may contain several serving runs;
        each ``sched.summary`` event closes one reconciliation segment."""
        summary = self.summary()
        self.tracer.event("sched.summary", cat="sched", **summary)
        return summary


def make_scheduler(policy: str, n_slots: int, locale=None, cfg=None,
                   prompt_pad: Optional[int] = None, **kw) -> Scheduler:
    """Build a scheduler from a `Locale` — the ownership map is
    `locale.owners(n_slots)` (the engine's `chunk_bounds` applied to slots)
    and the pod split comes from the locale's (outer, ..., inner) axes."""
    owners = locale.owners(n_slots) if locale is not None else None
    homes_per_pod = None
    if locale is not None and locale.mesh is not None:
        from repro_torch.core.homing import axis_tuple
        axes = axis_tuple(locale.axis)
        if len(axes) > 1:
            homes_per_pod = math.prod(locale.mesh.shape[a] for a in axes[1:])
    bpt = kv_bytes_per_token(cfg) if cfg is not None else 0
    return Scheduler(n_slots=n_slots, owners=owners, policy=policy,
                     bytes_per_token=bpt, homes_per_pod=homes_per_pod,
                     prompt_pad=prompt_pad, **kw)
