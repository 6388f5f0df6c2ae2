"""Serving across torch.distributed ranks, held to the JAX reference's
server on a mesh of host devices.

One JAX subprocess (8 host devices, meshes with Auto axes: jax 0.9.0's
default Explicit axes reject the reference's sharding constraints)
serves the reference's own streams -- `tests/test_scheduler.py`'s
`_SERVE_CODE` stream on reduced qwen3-0.6b at one layer, paged, over
``{"data": 8}`` and ``{"pod": 2, "data": 2, "model": 2}`` (and over
``{"data": 4}`` and ``{"data": 2, "model": 2}`` on 4 of the devices),
`tests/test_runtime.py`'s 2-device case in aligned waves, and a reduced
deepseek-moe-16b at capacity factor 0.5 in aligned waves on ``{"data":
2, "model": 2}`` (and paged on ``{"data": 2, "model": 4}``, where its 2
KV heads do not split over 4 ranks: each rank's one q head reads its KV
head of the whole ones), where dropped tokens make each token's bucket
place depend on the tokens of the home before it -- and writes its parameters,
tokens, homes, summaries, the reduced models' prefill and decode logits
on a fixed batch, and `make_plan`/`param_specs`/`batch_specs`/
`cache_specs` over all ten configs, three meshes and three shapes.

The port serves the same streams on gloo worlds of 2, 4 and 8 CPU
processes (`launch.mesh.spawn`), one spawn a world, each rank cutting
the reference's parameters to its blocks (`convert.rank_params`).
Required: tokens equal to the reference's, summaries equal field for
field, every request's home equal, logits within rtol 1e-4 / atol 1e-5
(float32), every rank's collective log equal to `obs.schedule.
serve_schedule` op for op, and the scheduler replicas' event digests
equal across ranks.

The rank processes import this module, which imports torch, numpy and
the port only; JAX comes in inside the subprocess.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.sharding import partition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5

#: the served configs: (arch, layers (None: reduce_config's), key of the
#: reference's parameters, capacity factor (None: reduce_config's))
CFGS = {"qwen": ("qwen3-0.6b", 1, 0, None),
        "qwen2dev": ("qwen3-0.6b", None, 42, None),
        "moe": ("deepseek-moe-16b", 1, 0, 0.5)}
#: name -> (world, mesh, config, slots, max_len, prompt_pad, stream,
#: policies)
CASES = {
    "dev2": (2, {"data": 2, "model": 1}, "qwen2dev", 4, 64, None, "dev2",
             ("fifo",)),
    "data4": (4, {"data": 4, "model": 1}, "qwen", 16, 32, 6, "serve",
              ("fifo", "homed")),
    "d2m2": (4, {"data": 2, "model": 2}, "qwen", 16, 32, 6, "serve",
             ("fifo", "homed")),
    "moe": (4, {"data": 2, "model": 2}, "moe", 16, 32, None, "serve",
            ("homed",)),
    "flat8": (8, {"data": 8, "model": 1}, "qwen", 16, 32, 6, "serve",
              ("fifo", "homed")),
    "pods222": (8, {"pod": 2, "data": 2, "model": 2}, "qwen", 16, 32, 6,
                "serve", ("fifo", "homed")),
    "moe_m4": (8, {"data": 2, "model": 4}, "moe", 16, 32, 6, "serve",
               ("fifo",)),
}
WORLDS = (2, 4, 8)
#: the model-level logits check: a (16, 6) prompt batch, then two decode
#: steps of fed tokens
LOGIT_BATCH, LOGIT_STEPS = (16, 6), 2
#: the plan grid: meshes and shapes
SPEC_MESHES = {"flat8": {"data": 8, "model": 1},
               "pods222": {"pod": 2, "data": 2, "model": 2},
               "pods142": {"pod": 1, "data": 4, "model": 2}}
SPEC_SHAPES = {"decode96": ("serve", 96, 16, "decode"),
               "decode8192": ("serve", 8192, 16, "decode"),
               "prefill": ("prefill_32k", 32768, 32, "prefill")}
#: `launch.serve` across 8 ranks: the arguments, and the reference's mesh
#: for them (the port's --ranks 8 builds the same)
LAUNCHES = {"flat": (["--slots", "16", "--requests", "24", "--max-new", "4"],
                     {"data": 8, "model": 1}),
            "pods": (["--slots", "16", "--requests", "24", "--max-new", "4",
                      "--pods", "2x2x2"],
                     {"pod": 2, "data": 2, "model": 2}),
            "smoke": (["--smoke"], {"data": 8, "model": 1})}
SUMMARY_KEYS = ("relayout_bytes", "inter_pod_bytes", "intra_pod_bytes",
                "steps", "homes", "homes_per_pod", "served", "waves")


def config(tag, cfgs=base):
    """A served config of `cfgs` (the port's configs module or the
    reference's)."""
    arch, layers, _, cap = CFGS[tag]
    cfg = cfgs.reduce_config(cfgs.get_config(arch), **(
        {"layers": layers} if layers else {}))
    return cfg.replace(capacity_factor=cap) if cap else cfg


def stream(kind, vocab):
    """The reference's own streams, as dicts of `Request` fields."""
    if kind == "dev2":
        return [dict(rid=i, prompt=np.asarray([3 + i, 5, 7], np.int32),
                     max_new=4) for i in range(4)]
    rng = np.random.RandomState(0)
    w = 1.0 / (1.0 + np.arange(4))
    w /= w.sum()
    return [dict(rid=i, prompt=rng.randint(0, vocab, rng.randint(2, 7))
                 .astype(np.int32),
                 max_new=int(12 if rng.rand() < 0.3 else 3),
                 session=f"s{rng.choice(4, p=w)}", t_arrive=float(i // 16))
            for i in range(24)]


def launcher_stream(argv):
    """`launch.serve`'s arguments, its served config and its request
    stream as dicts of `Request` fields."""
    from repro_torch.launch.serve import parse_args, requests, served_config
    args = parse_args(argv)
    cfg = served_config(args.arch)
    return args, cfg, [dict(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                            session=r.session, t_arrive=r.t_arrive)
                       for r in requests(cfg, args)]


def logit_inputs(vocab):
    rng = np.random.default_rng(7)
    B, S = LOGIT_BATCH
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, LOGIT_STEPS)).astype(np.int32))


# ---------------------------------------------------------------------------
# the reference, in one subprocess
# ---------------------------------------------------------------------------
REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from repro.configs import base
from repro.configs.base import ShapeSpec
from repro.models.model import LM
from repro.runtime.server import DecodeServer, Request
from repro.sharding import partition as part
from test_torch_serve_ranks import (CASES, CFGS, LAUNCHES, SPEC_MESHES,
                                    SPEC_SHAPES, config, launcher_stream,
                                    logit_inputs, stream)

out_dir = sys.argv[1]
flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                  for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}

def mesh_of(shape, n):
    return jax.make_mesh(tuple(shape.values()), tuple(shape),
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])

out = {"cases": {}, "logits": {}, "specs": {}, "launches": {}}
params = {}
for tag in CFGS:
    cfg = config(tag, base)
    params[tag] = LM(cfg).init(jax.random.key(CFGS[tag][2]))
    np.savez(os.path.join(out_dir, tag + ".npz"), **flat(params[tag]))
    toks, fed = logit_inputs(cfg.vocab_size)
    m = LM(cfg)
    last, caches = m.prefill(params[tag], {"tokens": jnp.asarray(toks)},
                             max_len=32)
    rows = [np.asarray(last)]
    for t in range(fed.shape[1]):
        lg, caches = m.decode_step(params[tag], caches,
                                   {"tokens": jnp.asarray(fed[:, t:t + 1])},
                                   jnp.int32(toks.shape[1] + t))
        rows.append(np.asarray(lg))
    np.save(os.path.join(out_dir, tag + "_logits.npy"), np.stack(rows))

for name, (world, shape, tag, slots, max_len, pad, kind, pols) in CASES.items():
    cfg = config(tag, base)
    plan = part.make_plan(mesh_of(shape, world), cfg,
                          ShapeSpec("serve", max_len, slots, "decode"))
    for pol in pols:
        srv = DecodeServer(cfg, params[tag], batch_slots=slots,
                           max_len=max_len, plan=plan, scheduler=pol,
                           prompt_pad=pad)
        for d in stream(kind, cfg.vocab_size):
            srv.submit(Request(**d))
        served = srv.run()
        out["cases"][f"{name}-{pol}"] = {
            "tokens": {str(r.rid): [int(t) for t in r.out] for r in served},
            "homes": {str(r.rid): r.home for r in served},
            "summary": srv.scheduler.summary()}

# the launcher's runs: its stream and config, the reference's server
for name, (argv, shape) in LAUNCHES.items():
    args, _, reqs = launcher_stream(argv)
    cfg = base.reduce_config(base.get_config(args.arch), layers=4)
    plan = part.make_plan(mesh_of(shape, 8), cfg,
                          ShapeSpec("serve", 96, args.slots, "decode"))
    srv = DecodeServer(cfg, LM(cfg).init(jax.random.key(0)),
                       batch_slots=args.slots, max_len=96, plan=plan,
                       scheduler=args.policy, prompt_pad=args.prompt_pad)
    for d in reqs:
        srv.submit(Request(**d))
    srv.run()
    out["launches"][name] = srv.scheduler.summary()

def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]

is_p = lambda s: isinstance(s, jax.sharding.PartitionSpec)
for arch in base.list_configs():
    cfg = base.get_config(arch)
    m = LM(cfg)
    pshape = jax.eval_shape(m.init, jax.random.key(0))
    out["specs"][arch] = {"shapes": {
        "/".join(str(getattr(k, "key", k)) for k in path): list(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(pshape)[0]}}
    for mname, shape in SPEC_MESHES.items():
        mesh = mesh_of(shape, 8)
        for sname, s in SPEC_SHAPES.items():
            sh = ShapeSpec(*s)
            plan = part.make_plan(mesh, cfg, sh)
            ps = part.param_specs(pshape, plan, cfg)
            bs = part.batch_specs({"tokens": jax.ShapeDtypeStruct(
                (sh.global_batch, sh.seq_len), jnp.int32)}, plan)
            cs = part.cache_specs(m.cache_struct(16, sh.seq_len), plan, cfg)
            fields = {f: (list(v) if isinstance(v, tuple) else v)
                      for f, v in vars(plan).items() if f != "mesh"}
            tree = lambda t: {"/".join(str(getattr(k, "key", k)) for k in pth):
                              spec(v) for pth, v in
                              jax.tree_util.tree_flatten_with_path(
                                  t, is_leaf=is_p)[0]}
            out["specs"][arch][f"{mname}-{sname}"] = {
                "plan": fields, "params": tree(ps), "batch": tree(bs),
                "cache": tree(cs)}
json.dump(out, open(os.path.join(out_dir, "reference.json"), "w"))
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ranks")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d)],
                       capture_output=True, text=True, timeout=900, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert "REFERENCE_OK" in r.stdout, r.stdout + r.stderr
    with open(d / "reference.json") as f:
        return str(d), json.load(f)


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it by name)
# ---------------------------------------------------------------------------
def unflatten(flat):
    """``{"a/b/c": array}`` -> a nested dict of tensors."""
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(v))
    return out


def rank_serve(device, world, ref_dir):
    assert "jax" not in sys.modules, "a rank process imported JAX"
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_cut, rank_params
    from repro_torch.core import collectives
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.obs.schedule import log_against_serve, serve_schedule
    from repro_torch.runtime.server import (DecodeServer, Request,
                                            event_digest)
    from repro_torch.tree import tree_items

    out = {"rank": dist.get_rank(), "cases": {}, "logits": {}, "drawn": {}}
    for name, (w, shape, tag, slots, max_len, pad, kind, pols) in \
            CASES.items():
        if w != world:
            continue
        cfg = config(tag)
        mesh = RankMesh(shape, device=device)
        plan = partition.make_plan(mesh, cfg, ShapeSpec("serve", max_len,
                                                        slots, "decode"))
        whole = unflatten(np.load(os.path.join(ref_dir, tag + ".npz")))
        params = rank_params(whole, plan, cfg)
        # a rank's blocks drawn a superblock at a time == the whole
        # parameters drawn from the same seed, then cut
        drawn = LM(cfg).init(torch.Generator().manual_seed(7),
                             cut=rank_cut(plan, cfg))
        cut = rank_params(LM(cfg).init(torch.Generator().manual_seed(7)),
                          plan, cfg)
        a, b = tree_items(drawn), tree_items(cut)
        out["drawn"][name] = [p for p, _ in a] == [p for p, _ in b] and all(
            x.shape == y.shape and torch.equal(x, y)
            for (_, x), (_, y) in zip(a, b))
        for pol in pols:
            tracer = Tracer()
            srv = DecodeServer(cfg, params, batch_slots=slots,
                               max_len=max_len, plan=plan, scheduler=pol,
                               prompt_pad=pad, tracer=tracer)
            for d in stream(kind, cfg.vocab_size):
                srv.submit(Request(**d))
            collectives.reset_collectives()
            served = srv.run()
            log = collectives.collective_log()
            out["cases"][f"{name}-{pol}"] = {
                "tokens": {str(r.rid): list(r.out) for r in served},
                "homes": {str(r.rid): r.home for r in served},
                "summary": json.loads(json.dumps(srv.scheduler.summary())),
                "digest": event_digest(tracer),
                "schedule": log_against_serve(
                    log, serve_schedule(cfg, plan, srv.calls)),
                "collectives": len(log),
                "wire": sum(r["wire_bytes"] for r in log),
                "rows": (srv.rows.start, srv.rows.stop)}
        # the model-level logits: this rank's rows and vocabulary block
        toks, fed = logit_inputs(cfg.vocab_size)
        n, h = partition.homes_of(plan)
        b = toks.shape[0] // n
        m = LM(cfg)
        mine = torch.from_numpy(toks[h * b:(h + 1) * b]).long()
        last, caches = m.prefill(params, {"tokens": mine}, max_len=32,
                                 plan=plan)
        blocks = [last]
        for t in range(fed.shape[1]):
            step = torch.from_numpy(fed[h * b:(h + 1) * b, t:t + 1]).long()
            lg, caches = m.decode_step(params, caches, {"tokens": step},
                                       toks.shape[1] + t, plan=plan)
            blocks.append(lg)
        out["logits"][name] = (h, partition.tp_of(plan)[1],
                               torch.stack(blocks).numpy())
    assert "jax" not in sys.modules, "a rank process imported JAX"
    return out


@pytest.fixture(scope="module")
def worlds(reference):
    from repro_torch.launch.mesh import spawn
    ref_dir, _ = reference
    return {w: spawn(rank_serve, w, "gloo", "cpu", w, ref_dir)
            for w in WORLDS}


def case_runs(worlds, name):
    world, _, _, _, _, _, _, pols = CASES[name]
    return [(pol, [res["cases"][f"{name}-{pol}"] for res in worlds[world]])
            for pol in pols]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_serve_the_reference_tokens_and_summary(reference, worlds,
                                                      name):
    _, ref = reference
    for pol, ranks in case_runs(worlds, name):
        want = ref["cases"][f"{name}-{pol}"]
        for res in ranks:
            assert res["tokens"] == want["tokens"], (name, pol)
            assert res["homes"] == want["homes"], (name, pol)
            for k in SUMMARY_KEYS:
                assert res["summary"][k] == want["summary"][k], (name, pol, k)
            assert res["summary"] == want["summary"], (name, pol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_logs_equal_serve_schedule(worlds, name):
    """Every rank's collectives are the schedule's, one for one: the
    model-axis sums, picks and expert counts, never a KV cache."""
    world, shape = CASES[name][:2]
    for pol, ranks in case_runs(worlds, name):
        for res in ranks:
            assert res["schedule"] == [], (name, pol, res["schedule"][:3])
        digests = {res["digest"] for res in ranks}
        assert len(digests) == 1, (name, pol, "scheduler replicas diverged")
        splits = shape["model"] > 1 or world > 1
        assert all(res["collectives"] > 0 for res in ranks) == splits


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_logits_equal_the_reference(reference, worlds, name):
    """Prefill and two decode steps of a fixed batch, each rank's rows and
    vocabulary block assembled: the reference's logits within rtol 1e-4 /
    atol 1e-5."""
    ref_dir, _ = reference
    world, shape, tag = CASES[name][:3]
    want = np.load(os.path.join(ref_dir, tag + "_logits.npy"))
    got = np.zeros_like(want)
    n = len({res["logits"][name][0] for res in worlds[world]})
    M = shape["model"]
    b, v = want.shape[1] // n, want.shape[2] // M
    for res in worlds[world]:
        h, i, block = res["logits"][name]
        got[:, h * b:(h + 1) * b, i * v:(i + 1) * v] = block
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launcher_across_ranks_prints_the_reference_summary(reference,
                                                           name):
    """``launch.serve --ranks 8 --device cpu``: the summary the reference's
    server gives for the launcher's stream on 8 host devices."""
    _, ref = reference
    argv, _ = LAUNCHES[name]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--ranks", "8", "--device", "cpu", "--json", *argv],
                       capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == json.loads(json.dumps(ref["launches"][name]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_init_cut_equals_rank_params(worlds, name):
    """``LM.init(gen, cut=rank_cut(...))`` draws each rank's blocks a
    superblock at a time: the same tree, bit for bit, as the whole
    parameters from the same seed cut by `rank_params`."""
    for res in worlds[CASES[name][0]]:
        assert res["drawn"][name], (name, res["rank"])


def test_rank_rows_are_the_homes_slots(worlds):
    """Each rank computes its home's slots only: rows [h*b, (h+1)*b)."""
    for res in worlds[8]:
        r = res["rank"]
        assert res["cases"]["flat8-fifo"]["rows"] == (2 * r, 2 * r + 2)
        home = (r // 4) * 2 + (r // 2) % 2          # (pod, data) of r
        assert res["cases"]["pods222-fifo"]["rows"] == (4 * home,
                                                        4 * home + 4)


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _tree_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_specs(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _norm(tree)}


@pytest.mark.parametrize("arch", base.list_configs())
def test_plan_and_specs_equal_the_reference(reference, arch):
    from repro_torch.core.mesh import HomeMesh
    from repro_torch.models.model import LM
    _, ref = reference
    cfg = base.get_config(arch)
    want = ref["specs"][arch]
    shapes = unflatten_shapes(want["shapes"])
    for mname, shape in SPEC_MESHES.items():
        mesh = HomeMesh(shape, device="cpu")
        for sname, s in SPEC_SHAPES.items():
            sh = base.ShapeSpec(*s)
            plan = partition.make_plan(mesh, cfg, sh)
            cell = want[f"{mname}-{sname}"]
            got = {f: (list(v) if isinstance(v, tuple) else v)
                   for f, v in vars(plan).items() if f != "mesh"}
            assert got == cell["plan"], (mname, sname)
            assert _tree_specs(partition.param_specs(shapes, plan, cfg)) \
                == cell["params"], (mname, sname)
            assert _tree_specs(partition.batch_specs(
                {"tokens": _Leaf((sh.global_batch, sh.seq_len))}, plan)) \
                == cell["batch"]
            cache = LM(cfg).init_cache(16, sh.seq_len, device="meta")
            assert _tree_specs(partition.cache_specs(cache, plan, cfg)) \
                == cell["cache"], (mname, sname)


def unflatten_shapes(flat):
    out = {}
    for path, shape in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = _Leaf(shape)
    return out


def test_shard_for_rank_cuts_blocks():
    """`block_of` on a (pod 2, data 2, model 2) mesh: a dim over "model"
    in 2 blocks, over ("pod", "data") in 4, by the rank's index."""
    class Mesh:
        shape = {"pod": 2, "data": 2, "model": 2}

        def __init__(self, rank):
            self.rank = rank

        def index(self, axes):
            c = dict(zip(self.shape, np.unravel_index(self.rank, (2, 2, 2))))
            return int(np.ravel_multi_index([c[a] for a in axes],
                                            [self.shape[a] for a in axes]))
    for r in range(8):
        sl = partition.block_of((8, 4, 6), ("model", ("pod", "data"), None),
                                Mesh(r))
        m, home = r % 2, r // 2
        assert sl == (slice(4 * m, 4 * m + 4), slice(home, home + 1),
                      slice(None))
