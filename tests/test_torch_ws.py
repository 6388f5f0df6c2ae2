"""The reference's sharding-constraint sites, checked in the port.

The reference constrains layouts with ``ws`` (`repro/sharding/
partition.py:61`, a ``with_sharding_constraint``) at 24 call sites of
its models.  The port realises each layout as a rank's block or a
counted collective, and calls `repro_torch.sharding.partition.ws` at
each site's counterpart, naming the reference's site: it moves nothing
and raises where the rank holds another block than the spec names.

For one dense (qwen3-0.6b), one MoE (deepseek-moe-16b), one windowed
(mixtral-8x7b, whose prompt of 32 takes the banded form over its window
of 16) and one Mamba2 (mamba2-2.7b) reduced config, with the residual
sequence-sharded, on ``{"data": 2, "model": 2}``:

* one JAX subprocess (4 host devices, a mesh with Auto axes: jax 0.9.0's
  default Explicit axes reject the reference's constraints) traces the
  reference's ``forward`` under a train plan and its ``prefill`` and
  ``decode_step`` under a decode plan, recording the ``(site, spec)``
  pairs its ``ws`` is called with by wrapping the module attributes (no
  file of the JAX package changes);
* a gloo world of 4 CPU processes runs the port's same three calls,
  recording the pairs of the port's ``ws`` by wrapping the model modules'
  attributes the same way.

The two sets must be equal but for `NAMED`: the places where the port
holds another block on purpose, each with its reason.  `partition.ws`
itself checks a block's extents only; that each rank holds the right
block is checked here: every tensor a rank holds at a site equals the
block its spec names (`block_of`) of the tensor one process holds at
that site in the same calls, or for the sites named "one group at a
time", summed over the homes.  The rank processes import this module,
which imports torch, numpy and the port only.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import base

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESH = {"data": 2, "model": 2}
B, MAX_LEN = 4, 48
#: case -> (arch, prompt length)
CASES = {"dense": ("qwen3-0.6b", 16), "moe": ("deepseek-moe-16b", 16),
         "windowed": ("mixtral-8x7b", 32), "mamba": ("mamba2-2.7b", 16)}

# the port's MoE runs one group at a time, and a group of every home's
# tokens (a decode step's, or a prompt's B * S <= 2048) is cut by its
# rows over the homes, where the reference cuts (and pads) the group dim
_SPAN = "a group spans the homes: the port's home holds its rows of it"
_ONE = "one group at a time: the reference's group dim is whole here"
#: the sites where a rank holds its home's tokens of a group, in the
#: group's expert slots: over the homes they sum to the group's
SUMMED = ("models/moe.py:80", "models/moe.py:84", "models/moe.py:86")
#: (site, the reference's spec) -> (the port's spec, why), as JSON lists
NAMED = {
    ("models/moe.py:59", '["data", null, null]'):
        ('[null, "data", null]', _SPAN),
    ("models/moe.py:76", '["data", null, "model", null]'):
        ('[null, "data", "model", null]', _SPAN),
    ("models/moe.py:80", '["data", "model", null, null]'):
        ('[null, "model", null, null]', _ONE),
    ("models/moe.py:84", '["data", "model", null, null]'):
        ('[null, "model", null, null]', _ONE),
    ("models/moe.py:86", '["data", "model", null, null]'):
        ('[null, "model", null, null]', _ONE),
}


def config(name, cfgs=base):
    """A case's reduced config with the residual sequence-sharded, from
    `cfgs` (the port's configs module or the reference's)."""
    cfg = cfgs.reduce_config(cfgs.get_config(CASES[name][0]))
    return cfg.replace(parallel=cfg.parallel.__class__(sequence_shard=True))


def mamba6(cfgs=base):
    """Reduced mamba2-2.7b narrowed to 6 SSD heads (d_model 48)."""
    cfg = cfgs.reduce_config(cfgs.get_config("mamba2-2.7b")).replace(
        d_model=48)
    assert cfg.ssm_nheads == 6
    return cfg


def spec_json(spec) -> str:
    """A spec as a JSON list, a tuple of one axis name as that name."""
    def entry(d):
        if isinstance(d, (tuple, list)):
            return None if not d else (d[0] if len(d) == 1 else list(d))
        return d
    return json.dumps([entry(d) for d in spec])


REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import repro.models
import repro.models.attention, repro.models.blocks, repro.models.mamba2
import repro.models.model, repro.models.moe, repro.models.steps
from repro.configs import base
from repro.configs.base import ShapeSpec
from repro.models.model import LM
from repro.sharding import partition as part
from test_torch_ws import (B, CASES, MAX_LEN, MESH, config, mamba6,
                           spec_json)

top = os.path.dirname(os.path.dirname(repro.models.__file__))
ws, seen = part.ws, set()

def recording(x, plan, *spec):
    if plan is not None and plan.mesh is not None:
        f = sys._getframe(1)
        site = os.path.relpath(f.f_code.co_filename, top)
        seen.add((f"{site}:{f.f_lineno}", spec_json(spec)))
    return ws(x, plan, *spec)

for mod in (part, repro.models.attention, repro.models.blocks,
            repro.models.mamba2, repro.models.model, repro.models.moe,
            repro.models.steps):
    mod.ws = recording
mesh = jax.make_mesh(tuple(MESH.values()), tuple(MESH),
                     axis_types=(AxisType.Auto,) * len(MESH),
                     devices=jax.devices()[:4])
out = {}
for name, (arch, S) in CASES.items():
    seen.clear()
    cfg = config(name, base)
    m = LM(cfg)
    ps = m.param_struct()
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    train = part.make_plan(mesh, cfg, ShapeSpec("train", S, B, "train"))
    jax.jit(lambda p, t: m.forward(p, {"tokens": t}, train)).lower(ps, toks)
    dec = part.make_plan(mesh, cfg, ShapeSpec("serve", MAX_LEN, B, "decode"))
    pre = lambda p, t: m.prefill(p, {"tokens": t}, dec, max_len=MAX_LEN)
    jax.jit(pre).lower(ps, toks)
    _, caches = jax.eval_shape(pre, ps, toks)
    step = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    jax.jit(lambda p, c, t: m.decode_step(p, c, {"tokens": t}, jnp.int32(S),
                                          dec)).lower(ps, caches, step)
    out[name] = sorted(seen)
# six SSD heads over "model" of 2: the wdt leaf's spec cuts 6 over 2
# evenly, over a "model" of 4 it does not and jax refuses to place it
cfg = mamba6(base)
m4 = jax.make_mesh((1, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                   devices=jax.devices()[:4])
plan = part.make_plan(m4, cfg, ShapeSpec("train", 16, 4, "train"))
params = LM(cfg).init(jax.random.key(0))
shard = jax.tree.map(lambda s: jax.sharding.NamedSharding(m4, s),
                     part.param_specs(params, plan, cfg),
                     is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
try:
    jax.device_put(params, shard)
    out["mamba6"] = None
except ValueError as e:
    out["mamba6"] = str(e)
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_OK")
"""


def rank_work(device):
    """The port's three calls of every case on this rank, recording the
    ``(site, spec)`` pairs its `partition.ws` checks."""
    assert "jax" not in sys.modules, "a rank process imported JAX"
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_cut
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models import LM
    from repro_torch.sharding import partition
    from repro_torch.models import (attention, blocks, common, mamba2, model,
                                    moe, steps)
    seen, held = set(), []

    def recording(x, plan, *spec, shape, site):
        partition.ws(x, plan, *spec, shape=shape, site=site)
        spec = partition.P(*spec)
        seen.add((site, spec_json(spec)))
        held.append((site, tuple(spec), (x() if callable(x) else x).clone()))
        return x
    for mod in (attention, blocks, common, mamba2, model, moe, steps):
        mod.ws = recording
    mesh = RankMesh(MESH, device=device)
    out = {"held": {}}
    for name, (arch, S) in CASES.items():
        cfg = config(name)
        toks, fed = inputs(cfg, S)
        seen.clear()
        with torch.no_grad():
            train = partition.make_plan(mesh, cfg,
                                        ShapeSpec("train", S, B, "train"))
            n, h = partition.homes_of(train)
            rows = slice(h * B // n, (h + 1) * B // n)
            m = LM(cfg)
            params = m.init(torch.Generator().manual_seed(0),
                            cut=rank_cut(train, cfg))
            held.clear()
            m.forward(params, {"tokens": toks[rows]}, train)
            out["held"][name, "forward"] = list(held)
            dec = partition.serving_plan(partition.make_plan(
                mesh, cfg, ShapeSpec("serve", MAX_LEN, B, "decode")))
            n, h = partition.homes_of(dec)
            rows = slice(h * B // n, (h + 1) * B // n)
            params = m.init(torch.Generator().manual_seed(0),
                            cut=rank_cut(dec, cfg))
            held.clear()
            _, caches = m.prefill(params, {"tokens": toks[rows]},
                                  max_len=MAX_LEN, plan=dec)
            m.decode_step(params, caches, {"tokens": fed[rows]}, S, plan=dec)
            out["held"][name, "serve"] = list(held)
        out[name] = sorted(seen)
    assert "jax" not in sys.modules, "a rank process imported JAX"
    return out


def inputs(cfg, S):
    """A case's prompt tokens (B, S) and decode step's (B, 1)."""
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))))


def one_process_sites(name, monkeypatch) -> dict:
    """The tensors one process holds at each site in a case's forward
    and its prefill and decode step: ``{(call, site): [tensor, ...]}`` in
    call order, on the whole parameters the ranks cut theirs from."""
    from repro_torch.models import (LM, attention, blocks, common, mamba2,
                                    model, moe, steps)
    got = {}
    call = [None]

    def recording(x, plan, *spec, shape, site):
        t = x() if callable(x) else x
        got.setdefault((call[0], site), []).append(t.clone())
        return x
    for mod in (attention, blocks, common, mamba2, model, moe, steps):
        monkeypatch.setattr(mod, "ws", recording)
    cfg = config(name)
    toks, fed = inputs(cfg, CASES[name][1])
    m = LM(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        call[0] = "forward"
        m.forward(params, {"tokens": toks})
        call[0] = "serve"
        _, caches = m.prefill(params, {"tokens": toks}, max_len=MAX_LEN)
        m.decode_step(params, caches, {"tokens": fed}, CASES[name][1])
    monkeypatch.undo()
    return got


def blocks_against(one: dict, ranks: list, name: str, mesh_of) -> dict:
    """Each rank's tensor at each site and call against the block its
    spec names of one process's (`one_process_sites`), the `SUMMED` sites'
    summed over the homes first: ``{(call, site): (compared, unequal)}``.
    `mesh_of(rank)` is the mesh whose block a rank's tensor is held to."""
    from repro_torch.sharding import partition
    out, sums = {}, {}
    for r, res in enumerate(ranks):
        mesh = mesh_of(r)
        for call in ("forward", "serve"):
            k_of = {}
            for site, spec, t in res["held"][name, call]:
                k = k_of[site] = k_of.get(site, -1) + 1
                whole = one[call, site][k]
                want = whole[partition.block_of(whole.shape, spec, mesh,
                                                padded=True)]
                if site in SUMMED:
                    key = (call, site, k, mesh.coords["model"])
                    sums[key] = (want, sums.get(key, (None, 0))[1] + t)
                    continue
                n, bad = out.get((call, site), (0, 0))
                out[call, site] = (n + 1, bad + int(
                    want.shape != t.shape
                    or not torch.allclose(t, want, rtol=1e-4, atol=1e-5)))
    for (call, site, _, _), (want, t) in sums.items():
        n, bad = out.get((call, site), (0, 0))
        out[call, site] = (n + 1, bad + int(
            not torch.allclose(t, want, rtol=1e-4, atol=1e-5)))
    return out


@pytest.fixture(scope="module")
def sites(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    path = str(tmp_path_factory.mktemp("ws") / "reference.json")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, path], cwd=ROOT,
                           env={**os.environ, "PYTHONPATH": "src"},
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ranks = spawn(rank_work, WORLD, "gloo", "cpu")
        r_out, r_err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert "REFERENCE_OK" in r_out, r_out + r_err
    with open(path) as f:
        reference = json.load(f)
    return {"ref": reference, "ranks": ranks}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sites_and_specs_equal_the_reference_s(sites, name):
    """The port's ``(site, spec)`` pairs are the reference's, each taken
    through `NAMED` where the port holds another block on purpose; every
    rank checks the same pairs."""
    ref = {tuple(p) for p in sites["ref"][name]}
    got = {tuple(p) for p in sites["ranks"][0][name]}
    for r in sites["ranks"][1:]:
        assert {tuple(p) for p in r[name]} == got, name
    want = {(site, NAMED.get((site, spec), (spec,))[0]) for site, spec in ref}
    assert got == want, (name, sorted(got - want), sorted(want - got))


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_its_block_of_one_process_s_tensor(
        sites, name, monkeypatch):
    """At every site, in the forward and in the prefill and decode step,
    each rank's tensor is the block its spec names of the tensor one
    process holds there on the whole parameters (within float32's
    summation order), and held to another rank's block it is not."""
    from repro_torch.core.mesh import AbstractRankMesh
    one = one_process_sites(name, monkeypatch)
    ranks = sites["ranks"]
    held = blocks_against(one, ranks, name,
                          lambda r: AbstractRankMesh(MESH, r))
    sites_of = {site for res in ranks for call in ("forward", "serve")
                for site, _, _ in res["held"][name, call]}
    assert {site for _, site in held} == sites_of
    assert all(bad == 0 for _, bad in held.values()), held
    # the planted fault: every rank held to the block of the rank across
    # both axes, which every site's spec cuts over one of them at least
    wrong = blocks_against(one, ranks, name,
                           lambda r: AbstractRankMesh(MESH, WORLD - 1 - r))
    assert wrong.keys() == held.keys()
    assert all(bad == n for n, bad in wrong.values()), wrong


def test_every_site_is_reached_and_every_named_difference_used(sites):
    """Across the four cases the reference reaches all 23 of its forward
    and decode sites (the 24th, the train step's microbatch split, is
    the train tests'), and each named difference is met."""
    ref = {tuple(p) for name in CASES for p in sites["ref"][name]}
    assert len({site for site, _ in ref}) == 23, sorted(ref)
    assert set(NAMED) <= ref


def test_ws_raises_on_another_block_and_passes_off_ranks():
    """`partition.ws` returns its tensor (the same object) where the rank
    holds the spec's block, raises where it holds another, cuts a dim
    the axes do not divide as GSPMD pads it, and checks nothing without
    a rank mesh."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.mesh import AbstractRankMesh
    from repro_torch.sharding import partition
    cfg = config("dense")
    x = torch.zeros(2, 8, 3)
    assert partition.ws(x, None, "data", shape=(9, 9, 9), site="s") is x
    assert partition.ws(x, partition.NULL_PLAN, "data", shape=(9,),
                        site="s") is x
    for rank in range(4):
        mesh = AbstractRankMesh(MESH, rank)
        plan = partition.make_plan(mesh, cfg, ShapeSpec("train", 16, 4,
                                                        "train"))
        assert partition.ws(x, plan, "data", None, "model",
                            shape=(4, 8, 6), site="s") is x
        with pytest.raises(ValueError, match="holds"):
            partition.ws(x, plan, "data", "model", None, shape=(4, 8, 6),
                         site="s")
        # 3 rows over 2 homes: blocks of 2, the last of 1
        rows = 2 if mesh.coords["data"] == 0 else 1
        assert partition.ws(torch.zeros(rows, 1), plan, "data", None,
                            shape=(3, 1), site="s").shape == (rows, 1)


def test_ssd_heads_that_do_not_divide_over_model_raise_in_both(sites):
    """Six SSD heads over a "model" axis of 4: the reference's
    ``param_specs`` cut the ``(D, 6)`` wdt leaf over "model", and jax
    refuses to place it (`ValueError`, "divisible"); the port's
    `rank_ssm_heads` raises `ValueError` with that reason.  Over 2 and 1
    it splits."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.mesh import AbstractRankMesh
    from repro_torch.models.mamba2 import rank_ssm_heads
    from repro_torch.sharding import partition
    assert "divisible" in sites["ref"]["mamba6"], sites["ref"]["mamba6"]
    cfg = mamba6()
    for shape, heads in (({"data": 1, "model": 4}, None),
                         ({"data": 2, "model": 2}, 3),
                         ({"data": 4, "model": 1}, 6)):
        plan = partition.make_plan(AbstractRankMesh(shape, 0), cfg,
                                   ShapeSpec("train", 16, 4, "train"))
        if heads is None:
            with pytest.raises(ValueError, match="wdt leaf does not split"):
                rank_ssm_heads(cfg, plan)
        else:
            assert rank_ssm_heads(cfg, plan) == (heads, 0)
