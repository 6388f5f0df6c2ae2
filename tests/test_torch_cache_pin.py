"""A decode cache on a `HomeMesh` is copied into its home once.

`Locale.pin_tree` relays out a fresh cache (the first pin after a
prefill is counted) and returns a leaf it has already homed as it is,
uncounted: the reference's sharding constraint on a value that already
has the sharding.  On ``HomeMesh({"data": 2})`` and a reduced qwen3-0.6b
on the CPU: the decode steps of whole runs (aligned waves and paged)
relay out nothing, their cache comes back in its own storage (`call_facts`
shows ``k``, ``v`` and ``kpos`` written in place, and R4 is silent), the
same step on a cache that was never pinned still draws R4's WARN with its
bytes, and the served tokens are the JAX reference server's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.model import LM as JLM
from repro.runtime.server import DecodeServer as JServer
from repro.runtime.server import Request as JRequest

from repro_torch.analysis import Report
from repro_torch.analysis.mem_facts import call_facts
from repro_torch.analysis.rules import R4_MIN_BYTES, r4_donation_audit
from repro_torch.configs import base
from repro_torch.convert import lm_params_from_reference, make_serve_stream
from repro_torch.core import HomeMesh, Locale
from repro_torch.core.homing import relayout_counts, reset_relayouts
from repro_torch.runtime.server import DecodeServer, Request
from repro_torch.tree import tree_leaves

SLOTS = 4
#: a cache of 1 MiB a K/V leaf (2 layers x 4 slots x 1024 x 2 x 16 float32),
#: R4's threshold
MAX_LEN = 1024
NOTHING = {"relayouts": 0, "elems": 0, "bytes": 0}


@pytest.fixture(scope="module")
def reduced():
    jcfg = jbase.reduce_config(jbase.get_config("qwen3-0.6b"), layers=2)
    cfg = base.reduce_config(base.get_config("qwen3-0.6b"), layers=2)
    jp = JLM(jcfg).init(jax.random.key(1))
    return jcfg, jp, cfg, lm_params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


def locale():
    return Locale(mesh=HomeMesh({"data": 2}, device="cpu"))


def stream(cls, cfg):
    return [cls(**d) for d in make_serve_stream(
        12, cfg.vocab_size, (2, 14), sessions=3, new_tokens=(2, 5),
        slots=SLOTS, seed=4, prefix=8)]


def storages(tree):
    return [t.untyped_storage()._cdata for t in tree_leaves(tree)]


def test_pin_tree_moves_a_homed_leaf_once():
    loc = locale()
    cache = torch.arange(2 * 4 * 3, dtype=torch.float32).view(2, 4, 3)
    reset_relayouts()
    homed = loc.pin_tree({"k": cache}, dim=1, size=4)
    assert relayout_counts()["elems"] > 0
    reset_relayouts()
    again = loc.pin_tree(homed, dim=1, size=4)
    assert relayout_counts() == NOTHING and again["k"] is homed["k"]
    # written in place, it stays homed
    homed["k"][:, 1].add_(1)
    assert loc.pin_tree(homed, dim=1, size=4)["k"] is homed["k"]
    # another view of the storage, or a rebuilt leaf, is relaid out again
    for other in (homed["k"][:, :, :2], homed["k"] + 0):
        reset_relayouts()
        loc.pin_tree({"k": other}, dim=1, size=4)
        assert relayout_counts()["elems"] > 0
    # homed along another dim, or over other homes: relaid out
    reset_relayouts()
    Locale(mesh=HomeMesh({"data": 4}, device="cpu")).pin_tree(
        homed, dim=1, size=4)
    assert relayout_counts()["elems"] > 0


@pytest.mark.parametrize("pad", [None, 16], ids=["waves", "paged"])
def test_steady_decode_steps_relay_out_nothing(reduced, pad):
    """Whole runs: in aligned waves the first decode step after a wave's
    prefill homes the fresh cache (counted) and every later step moves
    nothing; paged, the cache is homed once before the first page step
    and no decode or page step moves it."""
    jcfg, jp, cfg, p = reduced
    kw = dict(batch_slots=SLOTS, max_len=40, scheduler="fifo",
              prompt_pad=pad, page_size=4 if pad else None)
    srv = DecodeServer(cfg, p, locale=locale(), **kw)
    events = []

    def counted(kind, fn):
        def step(*args):
            reset_relayouts()
            out = fn(*args)
            events.append((kind, relayout_counts(),
                           storages(out[1]) == storages(args[1])))
            return out
        return step

    srv._decode = counted("decode", srv._decode)
    if pad:
        srv._page = counted("page", srv._page)
    wave = srv.prefill_wave
    srv.prefill_wave = lambda toks: events.append(("prefill",)) or wave(toks)
    for r in stream(Request, cfg):
        srv.submit(r)
    got = {r.rid: list(r.out) for r in srv.run()}
    steps = [e for e in events if e[0] != "prefill"]
    assert [e for e in steps if e[0] == "decode"]
    assert bool([e for e in steps if e[0] == "page"]) == bool(pad)
    homing = [after for before, after in zip(events, events[1:])
              if before[0] == "prefill"]
    assert len(homing) == (0 if pad else srv.scheduler.summary()["waves"])
    for e in homing:                 # a wave's fresh cache, homed once
        assert e[0] == "decode" and e[1]["relayouts"] == 3 and not e[2]
    steady = [e for e in steps if not any(e is h for h in homing)]
    assert steady and all(c == NOTHING and same for _, c, same in steady)
    # the tokens are the reference server's (one home)
    js = JServer(jcfg, jp, **kw)
    for r in stream(JRequest, cfg):
        js.submit(r)
    assert got == {r.rid: list(r.out) for r in js.run()}


def decode_inputs(reduced):
    _, _, cfg, p = reduced
    srv = DecodeServer(cfg, p, batch_slots=SLOTS, max_len=MAX_LEN,
                       locale=locale())
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (SLOTS, 8))
    cur, caches = srv.prefill_wave(toks)
    return srv, p, caches, srv.decode_batch(cur)


def r4(facts):
    rep = Report("serve[decode]")
    r4_donation_audit(rep, facts["aliasing"])
    return rep.findings


def test_r4_is_silent_on_a_homed_cache(reduced):
    srv, p, caches, batch = decode_inputs(reduced)
    reset_relayouts()
    homed = srv.locale.pin_tree(caches, dim=1, size=SLOTS)
    first = relayout_counts()
    assert first["bytes"] == sum(t.numel() * t.element_size()
                                 for t in tree_leaves(caches)) // 2
    _, homed = srv._decode(p, homed, batch, 8)        # steady state
    reset_relayouts()
    _, facts = call_facts(srv._decode, p, homed, batch, 9)
    assert relayout_counts() == NOTHING
    cache = {a["path"]: a for a in facts["aliasing"] if a["index"] == 1}
    assert set(cache) == {"1.m0.k", "1.m0.v", "1.m0.kpos"}
    assert all(a["returned"] and a["in_place"] for a in cache.values())
    assert cache["1.m0.k"]["bytes"] >= R4_MIN_BYTES
    assert r4(facts) == []


def test_r4_reports_a_cache_never_homed(reduced):
    srv, p, caches, batch = decode_inputs(reduced)
    reset_relayouts()
    _, facts = call_facts(srv._decode, p, caches, batch, 8)
    assert relayout_counts()["relayouts"] == 3
    found = r4(facts)
    big = {a["path"]: a["bytes"] for a in facts["aliasing"]
           if a["index"] == 1 and a["bytes"] >= R4_MIN_BYTES}
    assert sorted(f.shape.split()[0] for f in found) == sorted(big) \
        == ["1.m0.k", "1.m0.v"]
    assert all(f.severity.name == "WARN" for f in found)
    assert sum(f.actual_bytes for f in found) == sum(big.values()) \
        == 2 * 2 * SLOTS * MAX_LEN * 2 * 16 * 4
