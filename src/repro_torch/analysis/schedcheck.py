"""Rule R9: exhaustively certify the home-aware scheduler's invariants.

The port's counterpart of `repro/analysis/schedcheck.py`, over the port's
copy of the scheduler (`repro_torch.runtime.scheduler`, `kvpool`).  The
serving scheduler is the runtime's *placement authority*: every decode
request lands where it says, every cache byte moves when it says.  The
scheduler exposes routing, wave formation, spill and eviction as pure
transition functions (`route_t`/`form_wave_t`/`complete_t`: state in,
``(state', placements, charges)`` out), so the checker explores **all
interleavings of arrivals and wave boundaries** over a small-config
lattice by breadth-first search on canonicalized states, checking at
every wave transition:

I1 off-home-unless-charged
    a placement landing off its session's bound home carries a `Charge`
    (or reuses a cache copy already charged this wave) — no silent moves,
    the "invisible coherence traffic" failure mode.
I2 starvation bound
    no queued entry is ever skipped more than ``max_skip`` waves — the
    aging floor provably forces an aged entry's span into the target.
I3 work conservation
    a formed wave never leaves a free slot while an admissible entry
    (span <= target) waits in any queue the config can see.
I4 eviction-never-migrates + capacity
    a binding leaves the table only by eviction on its own home; no home
    ever holds more than ``session_capacity`` bindings.
I5 no double-booking / binding leak
    slots and requests are placed at most once, placements come from the
    queues, fills are front-first, and in-flight fork marks are consumed
    by the wave that made them.
I6 charges equal the replayed moves
    an *independent* accounting model replays the placements in decision
    order against the pre-wave binding table; the transition's charges —
    bytes, inter/intra-pod split, fork-vs-migrate — must match move for
    move, and the post-state bindings must equal the model's.
I7 spill donor minimality
    every spilled placement picked the donor the cost order
    ``(relayout cost, crosses pod, -queue depth, donor, index)`` ranks
    first — spills pay the cheapest relayout the queues offered.
I8 page refcounts never leak
    on paged configs (``page_capacity > 0``) an independent model replays
    every placement's page acquire and every completion's release against
    the pre-state pools: the transition's pools must match page for page,
    a placement's attached-prefix count must equal what the *pre-wave*
    key set offers on its own home (attach never crosses homes and never
    sees a wave-mate's in-flight insert), no home ever pools more than
    ``page_capacity`` pages, and a quiescent pool — nothing in flight —
    holds only refs==0 pages.

Paged entries give each sessioned arrival a block chain keyed on its
session (two requests of one session share prompt pages, the radix-hit
case); ``continuous=True`` entries drop the atomic form+complete wave for
the continuous-batching event alphabet the real server loop executes —
``form`` over the currently-free slot subset and per-slot ``finish`` —
so mid-wave refill and page pinning across overlapping lifetimes are
explored exhaustively too.

States are canonicalized (request ids relabelled in queue order, sessions
by first appearance, ``last_used`` timestamps by dense LRU rank, pool
pages by relabelled key and refcount) so the search closes over a finite
lattice; BFS order makes the first violation a *minimal witness* — the
shortest arrival/wave script reaching it, which `Witness.format()` prints
as a replayable trace.  The committed mutants in `analysis.fixtures`
(aging off, charge dropped, greedy spill, page release dropped) each
produce such a witness; the production config produces none, and the CLI
prints the certificate (`certify_lattice`) next to R6's.

The canonical key, the event order and the lattice are the reference's,
so the state counts and the minimal witnesses compare one for one
(`tests/test_torch_schedcheck.py`).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import (Dict, FrozenSet, List, NamedTuple, Optional, Sequence,
                    Tuple)

from repro_torch.analysis.findings import Finding, Report, Severity
from repro_torch.runtime import kvpool
from repro_torch.runtime.scheduler import (Charge, ReqInfo, SchedConfig,
                                     SchedState, Served, complete_t,
                                     form_wave_t, initial_state, route_t)

#: exploration is exhaustive; refuse lattices whose closure outgrows this
MAX_STATES = 200_000


@dataclass(frozen=True)
class LatticeEntry:
    """One certified configuration plus the arrival space explored on it.

    ``blocks_per_req`` gives every *sessioned* arrival a prompt block
    chain ``((session, 0), (session, 1), ...)`` — session identity stands
    in for prompt content, so a returning session is the radix-hit case.
    ``continuous=True`` swaps the atomic wave event for the continuous-
    batching alphabet: ``form`` over the free slot subset, per-slot
    ``finish``."""
    name: str
    cfg: SchedConfig
    max_arrivals: int = 5
    spans: Tuple[int, ...] = (1, 2)
    max_sessions: int = 2
    blocks_per_req: int = 0
    continuous: bool = False


class _Running(NamedTuple):
    """One in-flight slot of a continuous-mode exploration node: what a
    later ``finish`` event needs to complete it."""
    slot: int
    rid: object
    session: object
    span: int
    home: int
    blocks: Tuple
    attached: int


@dataclass(frozen=True)
class Witness:
    """A minimal violating run: the event script and what broke."""
    config: str
    invariant: str
    events: Tuple[str, ...]
    violation: str

    def format(self) -> str:
        script = " -> ".join(self.events) if self.events else "(initial)"
        return (f"{self.config}: {self.invariant} after [{script}]: "
                f"{self.violation}")


class _Violation(Exception):
    def __init__(self, invariant: str, message: str):
        super().__init__(message)
        self.invariant = invariant


# ---------------------------------------------------------------------------
# canonicalization: close the search over relabelled-isomorphic states
# ---------------------------------------------------------------------------
def _canonical_key(state: SchedState, arrivals_left: int,
                   running: Tuple[_Running, ...] = ()) -> Tuple:
    sess_map: Dict[object, int] = {}

    def sess(s):
        if s is None:
            return None
        if s not in sess_map:
            sess_map[s] = len(sess_map)
        return sess_map[s]

    # bindings first: their order is LRU-tie-breaking insertion order;
    # pool pages share the dense-rank timeline (acquire/release touch)
    stamps = {b.last_used for b in state.bindings}
    stamps |= {p.last_used for _, pgs in state.pools for p in pgs}
    ranks = {t: i for i, t in enumerate(sorted(stamps))}
    binds = tuple((sess(b.session), b.home, b.tokens, ranks[b.last_used])
                  for b in state.bindings)
    fifo = tuple((e.span, sess(e.session)) for e in state.fifo)
    queues = tuple((h, tuple((e.req.span, sess(e.req.session), e.skips)
                             for e in q))
                   for h, q in state.queues)
    # lattice block keys are (session, index) pairs — relabel the session
    # half so pools of isomorphic histories collapse
    pools = tuple((h, tuple((sess(p.key[0]), p.key[1], p.refs,
                             ranks[p.last_used]) for p in pgs))
                  for h, pgs in state.pools)
    run = tuple((r.slot, sess(r.session), r.span, r.home, r.attached,
                 r.rid in state.forked)
                for r in sorted(running, key=lambda r: r.slot))
    return (binds, fifo, queues, bool(state.forked), pools, run,
            arrivals_left)


# ---------------------------------------------------------------------------
# the independent accounting model (invariants I1, I6, I7, parts of I5)
# ---------------------------------------------------------------------------
def _audit_wave(cfg: SchedConfig, pre: SchedState, post: SchedState,
                placements, charges,
                free_slots: Optional[Sequence[int]] = None) -> None:
    """Replay the wave's placements in decision order against the pre-wave
    tables and demand the transition's charges and post-state match.
    ``free_slots`` is the continuous-refill slot subset (None = the whole
    server, the atomic wave boundary)."""
    slots_of = cfg.slots_of
    fs = set(range(cfg.n_slots)) if free_slots is None else set(free_slots)
    # I5: slots/requests at most once, slot owned by the placement's home
    slots = [p.slot for p in placements]
    if len(set(slots)) != len(slots):
        raise _Violation("I5-double-booking",
                         f"slot placed twice: {sorted(slots)}")
    rids = [p.rid for p in placements]
    if len(set(rids)) != len(rids):
        raise _Violation("I5-double-booking",
                         f"request placed twice: {rids}")
    for p in placements:
        if cfg.owners[p.slot] != p.home:
            raise _Violation("I5-double-booking",
                             f"slot {p.slot} owned by "
                             f"{cfg.owners[p.slot]}, placed for {p.home}")
        if p.slot not in fs:
            raise _Violation("I5-double-booking",
                             f"slot {p.slot} refilled while occupied")

    if cfg.policy == "fifo":
        want = [e.rid for e in pre.fifo[:len(fs)]]
        if rids != want:
            raise _Violation("I5-double-booking",
                             f"fifo wave {rids} is not the queue prefix "
                             f"{want}")
    else:
        # fill placements on each home must be the front-first admissible
        # prefix of that home's own pre-wave queue (spills exempt)
        for h in cfg.homes:
            fills = [p.rid for p in placements
                     if p.home == h and p.spilled_from is None]
            q = [e.req for e in pre.queue(h)[:cfg.lookahead]]
            admissible = [r.rid for r in q if r.span <= charges.target]
            if fills != admissible[:len(fills)]:
                raise _Violation(
                    "I5-double-booking",
                    f"home {h} fill {fills} is not the front-first "
                    f"admissible prefix {admissible[:len(fills)]}")

    # replay: model queues (entries removed as placed), bindings, sites
    queues = {h: [e.req for e in q] for h, q in pre.queues}
    bindings = {b.session: b for b in pre.bindings}
    sites: Dict[object, set] = {}
    forked = set(pre.forked)
    moves: List[Charge] = []
    info = {e.req.rid: e.req for _, q in pre.queues for e in q}
    info.update({e.rid: e for e in pre.fifo})
    for p in placements:
        req = info.get(p.rid)
        if req is None:
            raise _Violation("I5-binding-leak",
                             f"placement of rid {p.rid} not found in any "
                             f"pre-wave queue")
        if cfg.policy == "homed":
            src_q = queues[p.home if p.spilled_from is None
                           else p.spilled_from]
            src_q.remove(req)
        b = bindings.get(req.session) if req.session is not None else None
        if b is None:
            continue
        # fork iff the session still has work queued at its bound home
        migrate = not (b.home != p.home and b.home in queues
                       and any(r.session == req.session
                               for r in queues[b.home]))
        ss = sites.setdefault(req.session, {b.home})
        if p.home not in ss and p.home != b.home:
            # off-home landing without a cache copy charged onto this
            # home earlier in the wave: a Charge is owed (I1), and the
            # move-for-move comparison below enforces it
            moves.append(Charge(
                rid=p.rid, session=req.session, src=b.home, dst=p.home,
                tokens=b.tokens, nbytes=b.tokens * cfg.bytes_per_token,
                inter_pod=cfg.pod(b.home) != cfg.pod(p.home),
                migrate=migrate))
        ss.add(p.home)
        if migrate:
            bindings[req.session] = b._replace(home=p.home)
        elif p.home != b.home:
            forked.add(p.rid)

    if tuple(moves) != charges.moves:
        # distinguish the silent-move class from a mere accounting skew
        charged = {(c.session, c.dst) for c in charges.moves}
        missing = [c for c in moves if (c.session, c.dst) not in charged]
        inv = "I1-uncharged-move" if missing else "I6-charge-mismatch"
        raise _Violation(
            inv, f"transition charged {list(charges.moves)}, independent "
                 f"replay expects {moves}")
    if {b.session: b.home for b in post.bindings} != \
            {s: b.home for s, b in bindings.items()}:
        raise _Violation(
            "I6-charge-mismatch",
            f"post-wave binding homes "
            f"{{ {', '.join(f'{b.session}:{b.home}' for b in post.bindings)} }}"
            f" diverge from the replayed fork/migrate model")
    if post.forked != frozenset(forked):
        raise _Violation("I5-binding-leak",
                         f"fork marks {set(post.forked)} != replayed "
                         f"{forked}")

    # I7: every spill picked the minimal-cost donor available at its turn
    if cfg.policy == "homed":
        _audit_spills(cfg, pre, placements, charges)

    # I3: free slots + admissible leftover work = a broken conservation law
    placed_per_home = {h: sum(1 for p in placements if p.home == h)
                       for h in cfg.homes}
    cap_of = {h: sum(1 for s in ss if s in fs) for h, ss in slots_of.items()}
    if cfg.policy == "homed" and charges.target:
        for h in cfg.homes:
            if placed_per_home[h] >= cap_of[h]:
                continue
            leftovers = [e.req for _, q in post.queues for e in
                         q[:cfg.lookahead]]
            stuck = [r.rid for r in leftovers if r.span <= charges.target]
            if stuck:
                raise _Violation(
                    "I3-work-conservation",
                    f"home {h} left {cap_of[h] - placed_per_home[h]} "
                    f"slot(s) free while rid(s) {stuck} (span <= target "
                    f"{charges.target}) stayed queued")


def _audit_spills(cfg: SchedConfig, pre: SchedState, placements,
                  charges) -> None:
    """Re-run the donor scan for each spilled placement and demand the
    recorded pick is cost-minimal at that point of the replay."""
    queues = {h: [e.req for e in q] for h, q in pre.queues}
    bindings = {b.session: b for b in pre.bindings}
    sites: Dict[object, set] = {}

    def touch(req, home):
        b = bindings.get(req.session) if req.session is not None else None
        if b is None:
            return
        ss = sites.setdefault(req.session, {b.home})
        migrate = not (b.home != home and b.home in queues
                       and any(r.session == req.session
                               for r in queues[b.home]))
        ss.add(home)
        if migrate:
            bindings[req.session] = b._replace(home=home)

    for p in placements:
        donor = p.home if p.spilled_from is None else p.spilled_from
        req = next(r for r in queues[donor] if r.rid == p.rid)
        if p.spilled_from is not None:
            h = p.home
            best = None
            for d in cfg.homes:
                if d == h:
                    continue
                for i, r in enumerate(queues[d][:cfg.lookahead]):
                    if r.span > charges.target:
                        continue
                    b = (bindings.get(r.session)
                         if r.session is not None else None)
                    cost = (0 if b is None or b.home == h
                            or h in sites.get(r.session, ())
                            else b.tokens)
                    key = (cost, cfg.pod(d) != cfg.pod(h),
                           -len(queues[d]), d, i)
                    if best is None or key < best[0]:
                        best = (key, d, r)
            if best is not None and (best[1], best[2].rid) != (donor,
                                                               p.rid):
                raise _Violation(
                    "I7-spill-order",
                    f"spill onto home {h} took rid {p.rid} from donor "
                    f"{donor}, but rid {best[2].rid} from donor {best[1]} "
                    f"was cheaper (key {best[0]})")
        queues[donor].remove(req)
        touch(req, p.home)


# ---------------------------------------------------------------------------
# the independent page-accounting model (invariant I8)
# ---------------------------------------------------------------------------
def _cmp_pools(state_pools, model: Dict, stage: str) -> None:
    got = {h: tuple((p.key, p.refs) for p in pgs) for h, pgs in state_pools}
    want = {h: tuple((p.key, p.refs) for p in pgs)
            for h, pgs in model.items()}
    if got != want:
        raise _Violation(
            "I8-page-leak",
            f"pool refcounts after {stage} diverge from the independent "
            f"acquire/release replay: transition holds {got}, replay "
            f"expects {want}")


def _audit_pages(cfg: SchedConfig, pre: SchedState, formed: SchedState,
                 post: SchedState, placements, served, now: float,
                 quiescent: bool = False) -> None:
    """Invariant I8: replay every placement's page acquire (in decision
    order, against the *pre*-state pools and their frozen key snapshot)
    and every completion's release, and demand the transition's pools
    match page for page.  Also proves the attach count is exactly the
    pre-wave longest-prefix hit on the placement's own home (attach never
    crosses homes, never sees a wave-mate's insert), the capacity bound,
    and — when nothing is left in flight — that every pooled page is back
    to refs==0."""
    if cfg.page_capacity <= 0:
        return
    info = {e.req.rid: e.req for _, q in pre.queues for e in q}
    info.update({e.rid: e for e in pre.fifo})
    pools = {h: p for h, p in pre.pools}
    known = {h: frozenset(pg.key for pg in p) for h, p in pre.pools}
    for p in placements:
        req = info.get(p.rid)
        blocks = req.blocks if req is not None else ()
        pages, hit = kvpool.acquire(pools.get(p.home, ()), blocks,
                                    cfg.page_capacity, now,
                                    known.get(p.home, frozenset()))
        pools[p.home] = pages
        if hit != p.attached:
            raise _Violation(
                "I8-attach",
                f"placement of rid {p.rid} on home {p.home} reports "
                f"{p.attached} attached page(s); the pre-wave pool "
                f"offers {hit}")
    _cmp_pools(formed.pools, pools, "formation")
    for h, pgs in pools.items():
        if len(pgs) > cfg.page_capacity:
            raise _Violation(
                "I8-capacity",
                f"home {h} pools {len(pgs)} pages "
                f"(page_capacity {cfg.page_capacity})")
    for sv in served:
        pools[sv.home] = kvpool.release(pools.get(sv.home, ()), sv.blocks,
                                        now)
    _cmp_pools(post.pools, pools, "completion")
    if quiescent:
        for h, pgs in post.pools:
            for pg in pgs:
                if pg.refs:
                    raise _Violation(
                        "I8-page-leak",
                        f"page {pg.key} on home {h} holds {pg.refs} "
                        f"ref(s) with nothing in flight — a release "
                        f"was dropped")


# ---------------------------------------------------------------------------
# the exhaustive exploration
# ---------------------------------------------------------------------------
def certify(entry: LatticeEntry) -> Tuple[Optional[Witness], int]:
    """Explore every arrival/wave interleaving of one lattice entry.

    Returns ``(witness, states_explored)`` — witness None means every
    reachable transition satisfied I1–I8 (a proof over this config's
    event space, not a sample).  BFS guarantees the witness is minimal.
    """
    cfg = entry.cfg
    init = initial_state(cfg)
    start = _canonical_key(init, entry.max_arrivals)
    seen = {start}
    frontier = deque([(init, entry.max_arrivals, (), ())])
    explored = 0
    try:
        while frontier:
            state, left, running, path = frontier.popleft()
            explored += 1
            if explored > MAX_STATES:
                raise RuntimeError(
                    f"{entry.name}: lattice closure exceeds MAX_STATES="
                    f"{MAX_STATES}; shrink the entry — a capped sweep is "
                    f"not a certificate")
            for ev, nxt, nleft, nrun in _successors(cfg, entry, state,
                                                    left, running, path):
                key = _canonical_key(nxt, nleft, nrun)
                if key in seen:
                    continue
                seen.add(key)
                frontier.append((nxt, nleft, nrun, path + (ev,)))
    except _WitnessFound as wf:
        return wf.witness, explored
    return None, explored


def _now(state: SchedState) -> float:
    """A clock strictly past every stamp the state carries (bindings and
    pool pages share the LRU timeline)."""
    stamps = [b.last_used for b in state.bindings]
    stamps += [p.last_used for _, pgs in state.pools for p in pgs]
    return max(stamps, default=0.0) + 1.0


def _successors(cfg: SchedConfig, entry: LatticeEntry, state: SchedState,
                left: int, running: Tuple[_Running, ...], path):
    """Yield ``(event, state', arrivals_left', running')`` or raise via
    audit.

    Arrival events draw from the entry's span alphabet crossed with the
    visible session choices (each existing session, one fresh name while
    under ``max_sessions``, and the session-less request); the wave event
    is the atomic form+serve+complete boundary the legacy server loop
    executes — or, on ``continuous`` entries, the split ``form`` (over
    the free slot subset) and per-slot ``finish`` events of the
    continuous-batching loop.
    """
    if left > 0:
        sessions = sorted({b.session for b in state.bindings}
                          | {e.session for e in state.fifo
                             if e.session is not None}
                          | {e.req.session for _, q in state.queues
                             for e in q if e.req.session is not None})
        choices: List[object] = [None] + sessions
        if len(sessions) < entry.max_sessions:
            fresh = 0
            while f"s{fresh}" in sessions:
                fresh += 1
            choices.append(f"s{fresh}")
        rid = f"a{entry.max_arrivals - left}"
        for span in entry.spans:
            for sess in choices:
                blocks = (tuple((sess, i)
                                for i in range(entry.blocks_per_req))
                          if sess is not None else ())
                nxt, _home = route_t(
                    cfg, state, ReqInfo(rid=rid, span=span, session=sess,
                                        blocks=blocks))
                yield (f"arrive({rid},span={span},sess={sess})", nxt,
                       left - 1, running)
    if entry.continuous:
        yield from _continuous_events(cfg, entry, state, left, running,
                                      path)
        return
    if state.pending:
        now = _now(state)
        mid, placements, charges = form_wave_t(cfg, state, now=now)
        served = [Served(rid=p.rid, session=_session_of(state, p.rid),
                         home=p.home, tokens=_span_of(state, p.rid),
                         blocks=_blocks_of(state, p.rid))
                  for p in placements]
        post, evicted = complete_t(cfg, mid, served, now)
        try:
            _audit_wave(cfg, state, mid, placements, charges)
            _check_post(cfg, state, post, served, evicted)
            _audit_pages(cfg, state, mid, post, placements, served, now,
                         quiescent=True)
        except _Violation as v:
            raise _WitnessFound(Witness(
                config=entry.name, invariant=v.invariant,
                events=path + ("wave",), violation=str(v))) from None
        yield ("wave", post, left, running)


def _continuous_events(cfg: SchedConfig, entry: LatticeEntry,
                       state: SchedState, left: int,
                       running: Tuple[_Running, ...], path):
    """The continuous-batching event alphabet: a ``form`` refills only
    the free slot subset while occupied neighbours keep decoding; a
    ``finish`` completes one in-flight slot (any interleaving — decode
    lengths are adversarial)."""
    occupied = {r.slot for r in running}
    free = [s for s in range(cfg.n_slots) if s not in occupied]
    if state.pending and free:
        now = _now(state)
        mid, placements, charges = form_wave_t(cfg, state, free=free,
                                               now=now)
        if placements:
            try:
                _audit_wave(cfg, state, mid, placements, charges,
                            free_slots=free)
                _audit_pages(cfg, state, mid, mid, placements, (), now)
            except _Violation as v:
                raise _WitnessFound(Witness(
                    config=entry.name, invariant=v.invariant,
                    events=path + ("form",), violation=str(v))) from None
            nrun = running + tuple(
                _Running(p.slot, p.rid, _session_of(state, p.rid),
                         _span_of(state, p.rid), p.home,
                         _blocks_of(state, p.rid), p.attached)
                for p in placements)
            yield ("form", mid, left, nrun)
    for r in running:
        now = _now(state)
        served = [Served(rid=r.rid, session=r.session, home=r.home,
                         tokens=r.span, blocks=r.blocks)]
        post, evicted = complete_t(cfg, state, served, now)
        nrun = tuple(x for x in running if x.slot != r.slot)
        try:
            _check_post(cfg, state, post, served, evicted,
                        inflight=frozenset(x.rid for x in nrun))
            _audit_pages(cfg, state, state, post, (), served, now,
                         quiescent=not nrun)
        except _Violation as v:
            raise _WitnessFound(Witness(
                config=entry.name, invariant=v.invariant,
                events=path + (f"finish({r.slot})",),
                violation=str(v))) from None
        yield (f"finish({r.slot})", post, left, nrun)


class _WitnessFound(Exception):
    def __init__(self, witness: Witness):
        super().__init__(witness.format())
        self.witness = witness


def _session_of(state: SchedState, rid):
    for _, q in state.queues:
        for e in q:
            if e.req.rid == rid:
                return e.req.session
    for e in state.fifo:
        if e.rid == rid:
            return e.session
    return None


def _span_of(state: SchedState, rid) -> int:
    for _, q in state.queues:
        for e in q:
            if e.req.rid == rid:
                return e.req.span
    for e in state.fifo:
        if e.rid == rid:
            return e.span
    return 1


def _blocks_of(state: SchedState, rid) -> Tuple:
    for _, q in state.queues:
        for e in q:
            if e.req.rid == rid:
                return e.req.blocks
    for e in state.fifo:
        if e.rid == rid:
            return e.blocks
    return ()


def _check_post(cfg: SchedConfig, pre: SchedState, post: SchedState,
                served, evicted,
                inflight: FrozenSet[object] = frozenset()) -> None:
    """I2 (skips bound), I4 (eviction/capacity), I5 (fork marks cleared)."""
    for h, q in post.queues:
        for e in q:
            if e.skips > cfg.max_skip:
                raise _Violation(
                    "I2-starvation",
                    f"rid {e.req.rid} on home {h} skipped {e.skips} waves "
                    f"(> max_skip={cfg.max_skip}): the aging floor failed")
    per_home: Dict[int, int] = {}
    for b in post.bindings:
        per_home[b.home] = per_home.get(b.home, 0) + 1
    for h, n in per_home.items():
        if n > cfg.session_capacity:
            raise _Violation(
                "I4-eviction",
                f"home {h} holds {n} bindings "
                f"(capacity {cfg.session_capacity})")
    pre_sessions = {b.session for b in pre.bindings}
    post_sessions = {b.session for b in post.bindings}
    gone = pre_sessions - post_sessions
    dropped = {b.session for b in evicted}
    if gone - dropped:
        raise _Violation("I4-eviction",
                         f"binding(s) {sorted(gone - dropped)} vanished "
                         f"without an eviction record")
    # an evicted session may only reappear when a *later completion of
    # that session in the same wave* rebound it afresh — never by the
    # eviction itself relocating the cache
    rebound = dropped & post_sessions
    reestablished = {sv.session for sv in served}
    if rebound - reestablished:
        raise _Violation("I4-eviction",
                         f"evicted session(s) {sorted(rebound - reestablished)}"
                         f" still bound — eviction must drop, not migrate")
    for b in post.bindings:
        if b.session in rebound and not any(
                sv.session == b.session and sv.home == b.home
                for sv in served):
            raise _Violation(
                "I4-eviction",
                f"evicted session {b.session} rebound on home {b.home} "
                f"where no completion of it landed")
    # every wave serves all its placements, so no fork mark survives it
    # (continuous mode: marks of still-in-flight spill copies are exempt)
    if post.forked - inflight:
        raise _Violation("I5-binding-leak",
                         f"fork mark(s) {set(post.forked - inflight)} "
                         f"outlived the wave that made them")


# ---------------------------------------------------------------------------
# the lattice and its rule/CLI surface
# ---------------------------------------------------------------------------
def _cfg(owners, **kw) -> SchedConfig:
    base = dict(policy="homed", n_slots=len(owners), owners=tuple(owners),
                bytes_per_token=2, lookahead=8, max_skip=1,
                session_capacity=2, affinity_slack=1)
    base.update(kw)
    return SchedConfig(**base)


#: the full small-config lattice the certificate covers: homes <= 4,
#: slots <= 8, sessions <= 6 concurrent, spans <= 3 distinct — and
#: ``lookahead >= max_arrivals`` throughout, so the formation windows see
#: every queued entry and I3's conservation claim is unconditional.
DEFAULT_LATTICE: Tuple[LatticeEntry, ...] = (
    LatticeEntry("fifo-2x2", _cfg((0, 0, 1, 1), policy="fifo"),
                 max_arrivals=5, spans=(1, 2), max_sessions=2),
    LatticeEntry("homed-1x2", _cfg((0, 0)),
                 max_arrivals=5, spans=(1, 2), max_sessions=2),
    LatticeEntry("homed-2x1", _cfg((0, 1)),
                 max_arrivals=5, spans=(1, 2), max_sessions=2),
    LatticeEntry("homed-2x2", _cfg((0, 0, 1, 1)),
                 max_arrivals=5, spans=(1, 2, 3), max_sessions=2),
    LatticeEntry("homed-3x1", _cfg((0, 1, 2)),
                 max_arrivals=5, spans=(1, 2), max_sessions=3),
    LatticeEntry("homed-evict", _cfg((0, 1), session_capacity=1),
                 max_arrivals=5, spans=(1, 2), max_sessions=3),
    LatticeEntry("homed-pods-4x2",
                 _cfg((0, 0, 1, 1, 2, 2, 3, 3), homes_per_pod=2),
                 max_arrivals=4, spans=(1, 3), max_sessions=3),
    # paged entries (page_capacity > 0): I8 joins the certificate —
    # sessioned arrivals carry a (session, i) block chain, so a session's
    # return is the radix-hit case and two sessions contend for pages
    LatticeEntry("homed-paged", _cfg((0, 1), page_capacity=2),
                 max_arrivals=4, spans=(1, 2), max_sessions=2,
                 blocks_per_req=1),
    LatticeEntry("homed-paged-evict", _cfg((0, 1), page_capacity=1),
                 max_arrivals=4, spans=(1, 2), max_sessions=2,
                 blocks_per_req=2),
    LatticeEntry("fifo-paged", _cfg((0, 1), policy="fifo",
                                    page_capacity=2),
                 max_arrivals=4, spans=(1, 2), max_sessions=2,
                 blocks_per_req=1),
    # continuous refill: the mid-wave free-subset formation + per-slot
    # finish alphabet of the paged server loop, pages pinned across
    # overlapping request lifetimes
    LatticeEntry("homed-cont-2x1", _cfg((0, 1), page_capacity=2),
                 max_arrivals=3, spans=(1, 2), max_sessions=2,
                 blocks_per_req=1, continuous=True),
)


#: the cheap corner of the lattice `check_decode` runs per target; the
#: CLI certificate and the certification test always sweep the full one
FAST_LATTICE: Tuple[LatticeEntry, ...] = tuple(
    e for e in DEFAULT_LATTICE
    if e.name in ("fifo-2x2", "homed-2x1", "homed-evict",
                  "homed-pods-4x2", "homed-paged", "homed-cont-2x1"))

_entry_cache: Dict[LatticeEntry, Tuple[Optional[Witness], int]] = {}


def certify_lattice(lattice: Sequence[LatticeEntry] = DEFAULT_LATTICE
                    ) -> Dict:
    """The scheduler certificate the CLI prints:
    ``{entry: {"states": N, "witness": None | Witness}}``.  Memoized per
    entry (the transitions are pure), so one process pays once for each
    entry: the fast corner after the full lattice is free."""
    out: Dict = {}
    for entry in lattice:
        if entry not in _entry_cache:
            _entry_cache[entry] = certify(entry)
        witness, states = _entry_cache[entry]
        out[entry.name] = {"states": states, "witness": witness,
                           "cfg": entry.cfg}
    return out


def r9_scheduler_certification(report: Report,
                               lattice: Sequence[LatticeEntry]
                               = DEFAULT_LATTICE) -> None:
    """Run R9: certify the transition functions over the lattice; any
    witness is an ERROR carrying the minimal violating event script."""
    cert = certify_lattice(tuple(lattice))
    bad = {n: rec for n, rec in cert.items() if rec["witness"] is not None}
    for name, rec in bad.items():
        w: Witness = rec["witness"]
        report.add(Finding(
            "R9", Severity.ERROR, "scheduler",
            message=f"{w.invariant} violated — {w.format()}"))
    if not bad:
        total = sum(rec["states"] for rec in cert.values())
        report.notes.append(
            f"R9: scheduler certified — I1-I8 hold over {len(cert)} "
            f"lattice configs, {total} canonical states explored "
            f"exhaustively")
