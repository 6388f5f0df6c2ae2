"""Batched decode server: continuous batching over per-slot position clocks.

The counterpart of `repro/runtime/server.py`.  Requests queue up; whenever
slots free (EOS/max-len), queued prompts are prefilled into the freed
slots.  The KV cache is donated across steps (`Locale.jit`): the server
never reads a cache after passing it to a step.

Cache placement goes through the same `Locale` API as every other
workload: each request's KV-cache slot is homed chunk-contiguously over
the batch-slot axis (`Locale.pin_tree` after every step, a counted
relayout on a `HomeMesh` of several homes).  *Which* request lands on
which slot is the scheduler's decision (`repro_torch.runtime.scheduler`):
``scheduler="fifo"`` is the arrival-order oracle, ``scheduler="homed"``
routes/batches/evicts by the slot ownership map `Locale.owners`.

Two serving modes, picked at construction, as in the reference:

**paged / continuous** (``prompt_pad`` set, attention-only stack, no
sliding window; an MoE stack qualifies, though its capacity buckets make
a row's tokens depend on its group-mates wherever one fills) -- prompts are *right*-padded into a fixed bucket, every
row decodes at its own position clock, a freed slot refills mid-wave.
Prefill runs page-stepped (``page_size`` tokens a call, through
`LM.decode_pages` and `decode_attention`), so a prompt's leading pages
can be *attached* from the home's paged KV pool (`runtime.kvpool`)
instead of recomputed.  Each row's numerics are a pure function of its
own prompt, so decode outputs are bit-identical across scheduling
policies for the same request set.

**aligned waves** (everything else: Mamba2 and hybrid stacks, sliding
windows) -- a wave of slots is prefilled together (`LM.prefill`,
left-padded to ``prompt_pad`` or the wave max; its attention is the
`flash_attention` kernel on the card) and all active slots share one
decode position clock; the decode step writes every cache leaf in place,
KV rings and SSM/conv states alike.

The pooled page content (`PageStore`) stays on the model's device here,
where the reference copies it to the host.

**Across ranks** (a `plan` on a `RankMesh`): every rank runs a replica of
the scheduler, in lockstep (each sees the same requests and the same
tokens, so each makes the same decisions: `event_digest`), and computes
only its home's slot rows -- home h of the plan's batch axes owns slots
``[h*B/n, (h+1)*B/n)``, the slots `Locale.owners` gives it, with their KV
cache on its ranks alone -- through the model split over "model" as the
plan says (the rank's parameter blocks, `convert.rank_params`).  After
every model call the rows' greedy tokens (`greedy`, across vocabulary
blocks) are all-gathered over the home axes, so every replica appends
the same tokens.  A page is attached only from its own home's pool, as
in the reference; a rank holds the content of its home's pages and the
keys of every home's (`HomePageStore`), so no KV cache crosses ranks.
The model calls are listed in ``calls`` (`obs.schedule.serve_schedule`
gives the collectives they imply).  With no batch axes (the slots do
not divide over the homes) every rank computes every row, the
reference's replicated batch.  Where the plan homes the decode cache by
sequence (``cache_seq_axis``: caches of 8192 positions or more whose
slots do not divide over the homes, or whose KV heads do not divide over
"model"), each rank keeps its block of every self-attention cache's
slots (`partition.cache_block`; `Locale.pin_tree` over that axis on the
slot dim), the model merges the blocks' attention, and a pooled page
holds the part of its slots that lies in the rank's block.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import Locale
from repro_torch.core.mesh import HomeMesh, RankMesh
from repro_torch.models.blocks import superblock_spec
from repro_torch.models.model import LM
from repro_torch.runtime.kvpool import PageStore
from repro_torch.runtime.scheduler import Scheduler, make_scheduler
from repro_torch.sharding.partition import (MeshPlan, NULL_PLAN,
                                            cache_block, cache_seq, homes_of,
                                            tp_of)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    session: Optional[object] = None  # affinity key (prefix/session KV reuse)
    t_arrive: float = 0.0        # open-loop arrival, in wave-step units
    home: Optional[int] = None   # assigned home device (set at admission)
    wait: Optional[float] = None # admission wait in wave-step units


def greedy(logits: torch.Tensor, plan: Optional[MeshPlan] = None
           ) -> torch.Tensor:
    """Greedy token ids (the first maximum, as ``jnp.argmax``) of the last
    axis, as int64 on the logits' device.  Across the ranks of a "model"
    axis `logits` is this rank's vocabulary block: each rank's (largest
    logit, its first global id) pair is all-gathered over "model" (one
    counted collective of float64 pairs, exact for every logit dtype)
    and the first block holding the largest logit wins, which is the
    first maximum of the whole row."""
    M, i = tp_of(plan)
    if M == 1:
        return logits.argmax(dim=-1)
    val = logits.max(dim=-1).values
    idx = logits.argmax(dim=-1)
    from repro_torch.core import collectives
    pair = torch.stack([val.double(), (idx + i * logits.shape[-1]).double()],
                       dim=-1)
    every = collectives.all_gather(pair, plan.mesh, (plan.tp,))
    best = every[..., 0].argmax(dim=0, keepdim=True)
    return every[..., 1].gather(0, best)[0].long()


def event_digest(tracer) -> str:
    """SHA-256 of a trace's scheduler, pool and serving records, clocks
    dropped: equal on every rank whose scheduler replica runs in
    lockstep with the others'."""
    recs = [{k: v for k, v in r.items() if k not in ("ts", "dur", "tid")}
            for r in tracer.records() if r["cat"] in ("sched", "pool", "serve")]
    return hashlib.sha256(json.dumps(recs, sort_keys=True, default=str)
                          .encode()).hexdigest()


class HomePageStore(PageStore):
    """The page store of one home's rank: the keys of every home's pages,
    as every scheduler replica publishes them, with the content of its
    own home's only (a key of another home holds None)."""

    def __init__(self, home: int, tracer=None):
        super().__init__(tracer=tracer)
        self.home = home

    def put(self, home: int, key: object, content) -> None:
        super().put(home, key, content if home == self.home else None)


class DecodeServer:
    def __init__(self, cfg: ArchConfig, params, batch_slots: int = 4,
                 max_len: int = 128, plan: MeshPlan = NULL_PLAN,
                 locale: Optional[Locale] = None,
                 scheduler: Union[str, Scheduler] = "fifo",
                 prompt_pad: Optional[int] = None,
                 page_size: Optional[int] = None,
                 page_capacity: Optional[int] = None,
                 tracer=None):
        assert cfg.embed_input, "server serves token LMs"
        if any(m.mixer == "cross" for m in superblock_spec(cfg)):
            raise ValueError(f"{cfg.name}: the server has no image input (nor "
                             f"has the reference's), so a cross-attention "
                             f"config is not served")
        self.cfg, self.params, self.plan = cfg, params, plan
        self.B, self.max_len = batch_slots, max_len
        self.model = LM(cfg)
        self.device = params["head"]["head_w"].device
        self.prompt_pad = prompt_pad
        # this rank's home and slot rows (every row off ranks)
        self.ranks = isinstance(plan.mesh, RankMesh)
        self.n_homes, self.home = homes_of(plan)
        if batch_slots % self.n_homes:
            raise ValueError(f"{batch_slots} slots do not divide over "
                             f"{self.n_homes} homes")
        b = batch_slots // self.n_homes
        self.rows = slice(self.home * b, (self.home + 1) * b)
        self.calls: List[Dict] = []
        if locale is None:
            # home cache slots over the plan's batch axes (a tuple of mesh
            # axis names); a mesh-less locale when the plan has no mesh
            slot_axes = (tuple(plan.batch_axes or ())
                         if plan.mesh is not None else ())
            locale = (Locale(mesh=plan.mesh, axis=slot_axes)
                      if slot_axes else Locale(mesh=None))
        if locale.mesh is not None and torch.empty(
                0, device=locale.mesh.device).device != self.device:
            raise ValueError(f"the locale's mesh lies on {locale.mesh.device},"
                             f" the parameters on {self.device}")
        self.locale = locale
        # a cache homed by sequence: the whole cache's slots (set by each
        # run: the wave's horizon, or max_len paged) and the pinning
        # locale over the cache's axis
        self.slots = max_len
        self.seq_locale = (Locale(mesh=plan.mesh, axis=(plan.cache_seq_axis,))
                           if cache_seq(plan)[0] > 1 else None)

        # the paged/continuous mode needs position-pure rows: a fixed
        # right-pad bucket, no sequential member state, no ring window
        self.paged = (prompt_pad is not None
                      and all(m.mixer == "attn" for m in superblock_spec(cfg))
                      and not cfg.sliding_window)
        if isinstance(scheduler, str):
            ps = page_size if page_size is not None else \
                (min(4, prompt_pad) if self.paged else 0)
            if self.paged and page_capacity is None:
                # per home: enough pages for 4x-slots-per-home resident
                # prefix chains, the binding table's sizing
                owners = locale.owners(self.B)
                sph = max(owners.count(h) for h in set(owners))
                page_capacity = 4 * sph * max(1, (prompt_pad - 1) // ps)
            scheduler = make_scheduler(
                scheduler, n_slots=self.B, locale=self.locale, cfg=cfg,
                prompt_pad=prompt_pad, page_size=ps if self.paged else 0,
                page_capacity=page_capacity if self.paged else 0,
                tracer=tracer)
        if scheduler.n_slots != self.B:
            raise ValueError(f"scheduler manages {scheduler.n_slots} slots, "
                             f"server has {self.B}")
        if scheduler.page_capacity > 0 and not self.paged:
            raise ValueError(
                "a paged KV pool needs prompt_pad and an attention-only, "
                "non-sliding-window stack")
        self.scheduler = scheduler
        self.tracer = scheduler.tracer
        self.page_size = (scheduler.page_size if scheduler.page_size
                          else (min(4, prompt_pad) if self.paged else 0))
        self.store = (HomePageStore(self.home, tracer=self.tracer)
                      if self.ranks else PageStore(tracer=self.tracer))

        def _step(p, c, b, pos):
            logits, c2 = self.model.decode_step(p, c, b, pos, plan=self.plan,
                                                cache_slots=self._slots())
            # re-home each slot's cache on its decode home (slot dim = 1:
            # cache leaves are (layers, slot, ...))
            c2 = self.locale.pin_tree(c2, dim=1, size=self.B)
            return logits, self._pin_seq(c2)

        self._decode = self.locale.jit(_step, donate=(1,))
        if self.paged:
            self._build_paged_steps()

    def _slots(self) -> Optional[int]:
        """The whole self-attention cache's slots where the plan homes it
        by sequence (the model's `cache_slots`); None otherwise."""
        return self.slots if self.seq_locale is not None else None

    def _pin_seq(self, caches):
        """Each self-attention member's cache homed by sequence over the
        plan's cache axis (`Locale.pin_tree` on the slot dim, 2): a rank's
        block stays as it is, a whole cache is cut to it.  The caches
        themselves where the plan homes none by sequence."""
        if self.seq_locale is None:
            return caches
        for i, m in enumerate(superblock_spec(self.cfg)):
            if m.mixer == "attn":
                caches[f"m{i}"] = self.seq_locale.pin_tree(
                    caches[f"m{i}"], dim=2, size=self.slots)
        return caches

    def _block(self, p0: int, p1: int) -> Optional[slice]:
        """The slots ``[p0, p1)`` of the whole cache that lie in this
        rank's block, as the block's slice; None where none does."""
        lo, blk = cache_block(self.slots, self.plan)
        a, b = max(p0, lo), min(p1, lo + blk)
        return slice(a - lo, b - lo) if b > a else None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _mine(self, a: np.ndarray) -> torch.Tensor:
        """This home's rows of a (B, ...) array, on the model's device."""
        return self._tensor(a[self.rows])

    def _call(self, kind: str, tokens: torch.Tensor) -> None:
        if self.ranks:
            self.calls.append({"call": kind, "rows": tokens.shape[0],
                               "seq": tokens.shape[1]})

    def _pick(self, logits: torch.Tensor) -> np.ndarray:
        """The greedy tokens of every slot row (B, ...) on the host: this
        home's picks (`greedy`), all-gathered over the home axes."""
        tok = greedy(logits, self.plan)
        if self.ranks:
            self.calls.append({"call": "pick",
                               "rows": tok.shape[0],
                               "seq": tok[0].numel()})
            if self.n_homes > 1:
                from repro_torch.core import collectives
                tok = collectives.all_gather(tok, self.plan.mesh,
                                             self.plan.batch_axes)
                tok = tok.reshape(self.B, *tok.shape[2:])
        return tok.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------ paged steps
    def _build_paged_steps(self):
        ps = self.page_size

        def _page(p, c, toks, positions, wmask):
            logits, c2 = self.model.decode_pages(
                p, c, {"tokens": toks}, positions, wmask, plan=self.plan,
                cache_slots=self._slots())
            c2 = self.locale.pin_tree(c2, dim=1, size=self.B)
            return logits, self._pin_seq(c2)

        def _reset(c, mask):
            # wipe refilled rows' attention timelines: kpos back to -1, so
            # stale entries of the slot's previous tenant never pass the
            # kpos >= 0 mask (in place: the cache is donated)
            for sub in c.values():
                sub["kpos"][:, mask] = -1
            return c

        def _attach(c, content, p0):
            # splice one pooled page level into the refilled rows' caches:
            # row s (of this home's rows) takes content[s][m] = (k, v) at
            # cache slots [p0, p0 + ps), and positions p0 .. p0 + ps - 1
            # (of a cache homed by sequence, the part in this rank's block)
            sl = self._block(p0, p0 + ps)
            if sl is None:
                return c
            lo = cache_block(self.slots, self.plan)[0]
            for s, pages in content.items():
                for m, (kb, vb) in pages.items():
                    c[m]["k"][:, s, sl] = kb
                    c[m]["v"][:, s, sl] = vb
                    c[m]["kpos"][:, s, sl] = torch.arange(
                        lo + sl.start, lo + sl.stop, dtype=torch.int32,
                        device=self.device)
            return self._pin_seq(self.locale.pin_tree(c, dim=1, size=self.B))

        self._page = self.locale.jit(_page, donate=(1,))
        self._reset = self.locale.jit(_reset, donate=(0,))
        self._attach = self.locale.jit(_attach, donate=(0,))

    # ------------------------------------------------------------ submission
    def submit(self, req: Request):
        if self.prompt_pad is not None and len(req.prompt) > self.prompt_pad:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} exceeds "
                f"prompt_pad={self.prompt_pad}")
        self.scheduler.submit(req)

    # ------------------------------------------------------- aligned waves
    def _serve_wave(self, placements) -> Tuple[List[Request], float]:
        """Serve one aligned wave of slot-placed requests.

        The batch always carries all B slot rows (empty slots hold a dummy
        token row); a row's computation never depends on the other rows,
        so each request's tokens are a function of its own prompt alone.
        Returns the served requests and the wave's cost in step units
        (prefill rows + forward steps).
        """
        B = self.B
        reqs: List[Optional[Request]] = [None] * B
        for slot, r in placements:
            reqs[slot] = r
        active = [r for r in reqs if r is not None]
        plen = (self.prompt_pad if self.prompt_pad is not None
                else max(1, max(len(r.prompt) for r in active)))
        self.slots = max(self.max_len, plen)     # the cache prefill builds
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(reqs):             # left-pad with token 0
            if r is not None:
                toks[i, plen - len(r.prompt):] = r.prompt
        mine = self._mine(toks)
        self._call("prefill", mine)
        last, caches = self.model.prefill(
            self.params, {"tokens": mine}, max_len=self.max_len,
            plan=self.plan)
        pos = plen
        cur = self._pick(last)
        for i, r in enumerate(reqs):
            if r is not None:
                r.out.append(int(cur[i]))
        steps = 1
        max_new = max(r.max_new for r in active)
        for _ in range(max_new - 1):
            batch = {"tokens": self._mine(cur[:, None].astype(np.int64))}
            self._call("decode", batch["tokens"])
            logits, caches = self._decode(self.params, caches, batch, pos)
            cur = self._pick(logits)
            pos += 1
            steps += 1
            for i, r in enumerate(reqs):
                if r is None:
                    continue
                if len(r.out) < r.max_new and not r.done:
                    r.out.append(int(cur[i]))
            if pos >= self.max_len:
                break
        for r in active:
            r.done = True
        return active, float(plen + steps)

    def _run_waves(self) -> List[Request]:
        served: List[Request] = []
        sch = self.scheduler
        now = 0.0
        while sch.has_work():
            now = sch.clock(now)
            wave = sch.form_wave(now)
            if not wave:          # future arrivals only -- jump, then retry
                continue
            with self.tracer.span("serve.wave", cat="serve", now=now,
                                  placed=len(wave)) as sp:
                reqs, cost = self._serve_wave(wave)
                sp.set(cost=cost)
            sch.complete(wave, now, cost)
            now += cost
            served += reqs
        return served

    # --------------------------------------------------- paged / continuous
    def _refill(self, wave, slots, caches, pos_np, cur_np, now):
        """Prefill freshly placed requests into their (freed) slots while
        the other rows' caches ride along untouched.

        Per row: reset its attention timeline, *attach* the leading
        prompt pages its home's pool already holds (splice pooled KV, no
        compute), then run the remaining pages through the page-stepped
        prefill (`LM.decode_pages`), committing KV only for this wave's
        rows at their own positions.  Newly pooled blocks have their
        computed content put into the `PageStore` so later waves can
        attach them.  Returns (caches, cost_units).
        """
        sch, ps, B = self.scheduler, self.page_size, self.B
        rows = [slot for slot, _ in wave]
        for slot, r in wave:
            slots[slot] = r
        rmask = np.zeros((B,), bool)
        rmask[rows] = True
        caches = self._reset(caches, self._mine(rmask))
        lo, hi = self.rows.start, self.rows.stop

        plen = {s: len(r.prompt) for s, r in wave}
        blocks = {s: getattr(r, "_sched_blocks", ()) for s, r in wave}
        # attachable = the scheduler's pre-wave longest-prefix hit, capped
        # by what the content store actually holds
        att = {}
        for s, r in wave:
            n = 0
            while (n < getattr(r, "_attached", 0)
                   and self.store.has(r.home, blocks[s][n])):
                n += 1
            att[s] = n
        if self.tracer.enabled:
            aps = sum(att.values())
            self.tracer.event(
                "serve.attach", cat="serve", now=now, pages=aps,
                per_slot={s: att[s] for s, _ in wave},
                rows_saved=round(aps * ps / self.prompt_pad, 2))

        # 1. attach pooled page levels (no compute, no cost)
        for p in range(max(att.values(), default=0)):
            content = {s - lo: self.store.get(slots[s].home, blocks[s][p])
                       for s, _ in wave if att[s] > p and lo <= s < hi}
            if content:
                caches = self._attach(caches, content, p * ps)

        # 2. page-stepped prefill for everything not attached
        cost = 0.0
        lastlv = {s: (plen[s] - 1) // ps for s, _ in wave}
        level_tokens: Dict[int, np.ndarray] = {}
        for p in range(max(lastlv.values()) + 1):
            lv = [s for s, _ in wave if att[s] <= p <= lastlv[s]]
            if not lv:
                continue
            toks = np.zeros((B, ps), np.int64)
            wm = np.zeros((B, ps), bool)
            for s in lv:
                chunk = slots[s].prompt[p * ps:(p + 1) * ps]
                toks[s, :len(chunk)] = chunk
                wm[s, :len(chunk)] = True
            positions = np.broadcast_to(
                p * ps + np.arange(ps, dtype=np.int64), (B, ps))
            mine = self._mine(toks)
            self._call("pages", mine)
            logits, caches = self._page(
                self.params, caches, mine, self._mine(positions),
                self._mine(wm))
            cost += float(ps)
            if any(lastlv[s] == p for s in lv):
                level_tokens[p] = self._pick(logits)

        # 3. first sampled token + per-slot clock start
        for s, r in wave:
            off = (plen[s] - 1) - lastlv[s] * ps
            first = int(level_tokens[lastlv[s]][s, off])
            r.out.append(first)
            cur_np[s] = first
            pos_np[s] = plen[s]

        # 4. publish newly pooled blocks' computed content to the store
        members = [f"m{i}" for i in range(len(superblock_spec(self.cfg)))]
        live = {h: set(sch.pool_keys(h)) for h in sch.homes}
        for s, r in wave:
            for i in range(att[s], len(blocks[s])):
                key = blocks[s][i]
                if key not in live.get(r.home, ()) \
                        or self.store.has(r.home, key):
                    continue
                sl = self._block(i * ps, (i + 1) * ps) or slice(0, 0)
                self.store.put(r.home, key, {
                    m: (caches[m]["k"][:, s - lo, sl].clone(),
                        caches[m]["v"][:, s - lo, sl].clone())
                    for m in members} if lo <= s < hi else None)
        return caches, cost

    def _run_paged(self) -> List[Request]:
        """Continuous batching: per-slot position clocks, mid-wave refill.

        One loop iteration = (refill any freed slots) + (one decode step
        for every occupied slot).  Inactive rows carry a dummy token at a
        stale clock -- their writes are row-local and wiped at refill, so
        no active row ever observes them.
        """
        served: List[Request] = []
        sch, B = self.scheduler, self.B
        slots: List[Optional[Request]] = [None] * B
        caches = None
        self.slots = self.max_len
        pos_np = np.zeros((B,), np.int64)
        cur_np = np.zeros((B,), np.int64)
        now = 0.0
        while sch.has_work() or any(r is not None for r in slots):
            free = [i for i, r in enumerate(slots) if r is None]
            occupied = any(r is not None for r in slots)
            if free and sch.has_work():
                if not occupied:
                    now = sch.clock(now)     # idle: jump to next arrival
                wave = sch.form_wave(now, free_slots=free)
                if wave:
                    if caches is None:
                        caches = self.locale.pin_tree(
                            self.model.init_cache(
                                self.rows.stop - self.rows.start,
                                self.max_len, device=self.device,
                                plan=self.plan), dim=1, size=B)
                    with self.tracer.span("serve.refill", cat="serve",
                                          now=now, placed=len(wave)) as sp:
                        caches, cost = self._refill(wave, slots, caches,
                                                    pos_np, cur_np, now)
                        sp.set(cost=cost)
                    sch.tick(cost)
                    now += cost
                elif not occupied:
                    continue                 # future arrivals only -- retry
            if not any(r is not None for r in slots):
                continue
            batch = {"tokens": self._mine(cur_np[:, None])}
            self._call("decode", batch["tokens"])
            if self.tracer.enabled:
                act = [s for s, r in enumerate(slots) if r is not None]
                dspan = self.tracer.span(
                    "serve.decode", cat="serve", now=now, active=len(act),
                    pos_min=int(pos_np[act].min()),
                    pos_max=int(pos_np[act].max()))
            else:
                dspan = self.tracer.span("serve.decode")
            with dspan:
                logits, caches = self._decode(self.params, caches, batch,
                                              self._mine(pos_np))
            cur_np = self._pick(logits).astype(np.int64)
            pos_np = pos_np + 1
            sch.tick(1.0)
            now += 1.0
            done_now = []
            for s, r in enumerate(slots):
                if r is None:
                    continue
                if len(r.out) < r.max_new:
                    r.out.append(int(cur_np[s]))
                if len(r.out) >= r.max_new or int(pos_np[s]) >= self.max_len:
                    r.done = True
                    done_now.append((s, r))
                    slots[s] = None
            if done_now:
                sch.complete(done_now, now)
                served += [r for _, r in done_now]
                for h in sch.homes:          # eviction frees stored pages too
                    self.store.prune(h, sch.pool_keys(h))
        return served

    def run(self) -> List[Request]:
        """Drain the queues (continuous batching when the config supports
        it, aligned waves otherwise).

        The scheduler decides wave membership and slot placement; the
        simulated clock advances by each step's cost, so open-loop
        arrivals (``Request.t_arrive``) and admission waits are measured in
        the same deterministic units across policies.
        """
        if self.paged:
            return self._run_paged()
        return self._run_waves()


class _NullLM:
    """A model that computes nothing: one-wide zero logits (token 0 is
    always the greedy pick) and a cache of one element per slot position,
    on the CPU.  What the scheduler sees of a run -- arrivals, prompts,
    decode lengths, prefix pages -- never depends on the tokens, so a
    server over it makes the same decisions as over the real model."""

    def __init__(self, n_members: int):
        self.members = [f"m{i}" for i in range(n_members)]

    def init_cache(self, batch_size: int, max_len: int, device="cpu",
                   plan=None):
        shape = (1, batch_size, max_len)
        return {m: {"k": torch.zeros(shape + (1, 1)),
                    "v": torch.zeros(shape + (1, 1)),
                    "kpos": torch.full(shape, -1, dtype=torch.int32)}
                for m in self.members}

    def prefill(self, params, batch, max_len=None, plan=None):
        B = batch["tokens"].shape[0]
        return torch.zeros(B, 1), self.init_cache(B, max_len)

    def decode_step(self, params, caches, batch, pos, plan=None,
                    cache_slots=None):
        return torch.zeros(batch["tokens"].shape[0], 1), caches

    def decode_pages(self, params, caches, batch, positions, write_mask,
                     plan=None, cache_slots=None):
        return torch.zeros(*batch["tokens"].shape, 1), caches


def schedule_replay(cfg: ArchConfig, requests, *, batch_slots: int,
                    max_len: int, locale: Locale,
                    scheduler: Union[str, Scheduler] = "fifo",
                    prompt_pad: Optional[int] = None,
                    page_size: Optional[int] = None,
                    tracer=None) -> Scheduler:
    """Serve `requests` (fresh `Request`s) through a `DecodeServer` whose
    model computes nothing (`_NullLM`), on the CPU, over `locale`'s homes
    (its mesh's shape, on the CPU).  Returns the scheduler: its stats,
    summary and trace are the model-free replay of the stream, which a
    run over the real model must equal."""
    if locale.mesh is not None:
        locale = Locale(HomeMesh(locale.mesh.shape, device="cpu"),
                        locale.axis, locale.policy)
    srv = DecodeServer(cfg, {"head": {"head_w": torch.empty(0)}},
                       batch_slots=batch_slots, max_len=max_len,
                       locale=locale, scheduler=scheduler,
                       prompt_pad=prompt_pad, page_size=page_size,
                       tracer=tracer)
    srv.model = _NullLM(len(superblock_spec(cfg)))
    for r in requests:
        srv.submit(r)
    srv.run()
    return srv.scheduler
