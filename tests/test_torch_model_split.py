"""Mamba2 and cross attention split over "model", and the decode cache
homed by sequence, held to the JAX reference on meshes of host devices.

JAX subprocesses (8 host devices, meshes with Auto axes: jax 0.9.0's
default Explicit axes reject the reference's sharding constraints) run
the reference under the same `make_plan` as the port, from parameters
the port drew (float32; the reference reads them):

* at the model level (`MODEL_CASES`), a prefill and decode steps fed
  fixed tokens -- reduced mamba2-2.7b and jamba (8 layers) and the vision
  config (one superblock, image embeddings) on ``{"data": 2, "model":
  2}``; reduced qwen3-0.6b with one slot and a cache of 8192 positions
  on ``{"data": 4}`` (the cache over "data": the batch does not divide
  over the homes); reduced granite-20b (one KV head) with 2 slots and
  8192 positions on ``{"data": 2, "model": 2}`` (the cache over "model":
  its KV head does not divide over it).  The long prompts span two of
  the cache's blocks and a decode write crosses into the next block;
* through the reference's `DecodeServer` (`SERVER_CASES`): the same
  configs' request streams in aligned waves, and qwen3-0.6b's paged
  (pages attached from the pool) over its cache homed by sequence;
* two train steps (`TRAIN_CASES`) of reduced mamba2-2.7b, jamba and the
  vision config with FSDP, the sequence-sharded residual, remat and 2
  microbatches on ``{"data": 2, "model": 2}``.

The port runs every case on one gloo world of 4 CPU processes
(`launch.mesh.spawn`), beside the reference's subprocesses.  Required:
logits, losses, norms, parameters, ``m`` and ``v`` within rtol 1e-4 /
atol 1e-5 of the reference's; served tokens equal; each rank's cache
block equal (within the same tolerance) to the reference's cache cut by
`cache_specs`; every rank's collective log equal to `serve_schedule` or
`train_schedule` op for op; blocks that several ranks hold bit-equal
(SHA-256).  A grid holds that `make_plan`, `rank_heads`, the model's
cache, `serve_schedule` and `train_schedule` take every plan of the ten
configs on three meshes and four shapes.

The rank processes import this module, which imports torch, numpy and
the port only; JAX comes in inside the subprocesses.
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.core.mesh import AbstractRankMesh, RankMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
WORLD = 4
D2M2 = {"data": 2, "model": 2}
DATA4 = {"data": 4, "model": 1}
#: the served configs: name -> (arch, layers (None: reduce_config's))
ARCHS = {"mamba": ("mamba2-2.7b", None),
         "jamba": ("jamba-1.5-large-398b", 8),
         "vision": ("llama-3.2-vision-90b", 5),
         "qwen": ("qwen3-0.6b", 1),
         "granite": ("granite-20b", 1)}
#: name -> (mesh, config, batch, max_len, prompt length, decode steps)
MODEL_CASES = {
    "mamba": (D2M2, "mamba", 4, 32, 8, 2),
    "jamba": (D2M2, "jamba", 4, 32, 8, 2),
    "vision": (D2M2, "vision", 4, 32, 6, 2),
    "qwen_long": (DATA4, "qwen", 1, 8192, 4095, 3),
    "granite_long": (D2M2, "granite", 2, 8192, 4095, 3),
}
#: name -> (mesh, config, slots, max_len, prompt lengths, new tokens,
#: prompt pad (None: aligned waves))
SERVER_CASES = {
    "mamba": (D2M2, "mamba", 4, 32, (2, 6), 6, None),
    "jamba": (D2M2, "jamba", 4, 32, (2, 6), 4, None),
    "qwen_long": (DATA4, "qwen", 1, 8192, (4094, 4095), 3, None),
    "granite_long": (D2M2, "granite", 2, 8192, (4097, 4200), 3, None),
    # paged over a cache homed by sequence: 2 slots over 4 homes
    "qwen_paged": (DATA4, "qwen", 2, 8192, (2, 8), 4, 16),
}
S_TRAIN, STEPS, LR = 32, 2, 1e-3
KNOBS = dict(fsdp=True, sequence_shard=True, remat=True, microbatches=2)
#: name -> (mesh, config, parallel knobs, global batch)
TRAIN_CASES = {
    "mamba": (D2M2, "mamba", KNOBS, 4),
    "jamba": (D2M2, "jamba", {**KNOBS, "zero1": True}, 4),
    "vision": (D2M2, "vision", KNOBS, 4),
}
#: the grid of plans: meshes and shapes
GRID_MESHES = {"d2m2": {"data": 2, "model": 2},
               "pods222": {"pod": 2, "data": 2, "model": 2},
               "d2m4": {"data": 2, "model": 4}}
GRID_SHAPES = ("train_4k", "decode_32k", "long_500k", "serve")


def config(tag, cfgs=base):
    """A config of `ARCHS` from `cfgs` (the port's configs module or the
    reference's)."""
    arch, layers = ARCHS[tag]
    return cfgs.reduce_config(cfgs.get_config(arch), **(
        {"layers": layers} if layers else {}))


def train_config(name, cfgs=base):
    cfg = config(TRAIN_CASES[name][1], cfgs)
    return cfg.replace(parallel=cfg.parallel.__class__(
        **TRAIN_CASES[name][2]))


def model_inputs(name, cfg):
    """A model case's prompt tokens, fed decode tokens and (vision) image
    embeddings, made with numpy."""
    _, _, B, _, S, steps = MODEL_CASES[name]
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fed = rng.integers(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = (0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    return toks, fed, img


def stream(name, vocab):
    """A server case's requests, as dicts of `Request` fields; a paged
    case's prompts open with their session's 8 tokens (two pages the pool
    can attach)."""
    _, _, slots, _, (lo, hi), new, pad = SERVER_CASES[name]
    rng = np.random.RandomState(3)
    n = 8 if slots > 2 or pad else 2 * slots
    heads = rng.randint(0, vocab, (3, 8 if pad else 0))
    return [dict(rid=i, prompt=np.concatenate(
        [heads[i % 3], rng.randint(0, vocab, rng.randint(lo, hi + 1))]
    ).astype(np.int32), max_new=int(new if i % 3 else new // 2 or 1),
                 session=f"s{i % 3}", t_arrive=float(i // slots))
            for i in range(n)]


def flat(tree, prefix=""):
    """A nested dict of tensors as ``{"a/b/c": numpy}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().cpu().numpy()}


def unflatten(d):
    """``{"a/b/c": array}`` -> a nested dict of tensors."""
    out = {}
    for path, v in d.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(v))
    return out


# ---------------------------------------------------------------------------
# the reference, in subprocesses
# ---------------------------------------------------------------------------
REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from repro.configs import base
from repro.configs.base import ShapeSpec
from repro.data.pipeline import SyntheticLM
from repro.models import steps
from repro.models.model import LM
from repro.optim import AdamW
from repro.runtime.server import DecodeServer, Request
from repro.sharding import partition as part
from test_torch_model_split import (LR, MODEL_CASES, S_TRAIN, SERVER_CASES,
                                    STEPS, TRAIN_CASES, WORLD, config,
                                    model_inputs, stream, train_config)

out_dir, what, names = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path):
                  np.asarray(v)
                  for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}

def unflat(d):
    out = {}
    for path, v in d.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out

def mesh_of(shape):
    return jax.make_mesh(tuple(shape.values()), tuple(shape),
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:WORLD])

def load(tag):
    return unflat(dict(np.load(os.path.join(out_dir, tag + "_init.npz"))))

out = {}
if what == "serve":
    for name in names:
        shape, tag, B, max_len, S, steps_ = MODEL_CASES[name]
        cfg = config(tag, base)
        plan = part.make_plan(mesh_of(shape), cfg,
                              ShapeSpec("serve", max_len, B, "decode"))
        params = load(tag)
        toks, fed, img = model_inputs(name, cfg)
        m = LM(cfg)
        batch = {"tokens": jnp.asarray(toks)}
        if img is not None:
            batch["image_embeds"] = jnp.asarray(img)
        prefill = jax.jit(lambda p, b: m.prefill(p, b, plan, max_len=max_len))
        decode = jax.jit(lambda p, c, b, pos: m.decode_step(p, c, b, pos,
                                                            plan))
        last, caches = prefill(params, batch)
        rows = [np.asarray(last)]
        saved = {"prefill/" + k: v for k, v in flat(caches).items()}
        for t in range(fed.shape[1]):
            lg, caches = decode(params, caches,
                                {"tokens": jnp.asarray(fed[:, t:t + 1])},
                                jnp.int32(S + t))
            rows.append(np.asarray(lg))
        saved.update({"decode/" + k: v for k, v in flat(caches).items()})
        np.save(os.path.join(out_dir, name + "_logits.npy"), np.stack(rows))
        np.savez(os.path.join(out_dir, name + "_caches.npz"), **saved)
    for name, (shape, tag, slots, max_len, _, _, pad) in \
            SERVER_CASES.items():
        cfg = config(tag, base)
        plan = part.make_plan(mesh_of(shape), cfg,
                              ShapeSpec("serve", max_len, slots, "decode"))
        srv = DecodeServer(cfg, load(tag), batch_slots=slots,
                           max_len=max_len, plan=plan, scheduler="fifo",
                           prompt_pad=pad)
        for d in stream(name, cfg.vocab_size):
            srv.submit(Request(**d))
        served = srv.run()
        out["server/" + name] = {
            "tokens": {str(r.rid): [int(t) for t in r.out] for r in served},
            "summary": srv.scheduler.summary()}
else:
    for name in names:
        shape, tag, knobs, GB = TRAIN_CASES[name]
        cfg = train_config(name, base)
        mesh = mesh_of(shape)
        plan = part.make_plan(mesh, cfg, ShapeSpec("train", S_TRAIN, GB,
                                                   "train"))
        params = load("train_" + name)
        opt = AdamW(lr=LR)
        ostate = steps.init_opt_state(cfg, opt, params)
        nm = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda s: isinstance(s, P))
        data = SyntheticLM(cfg, GB, S_TRAIN, seed=0)
        psh = nm(part.param_specs(params, plan, cfg))
        osh = nm(part.full_opt_specs(ostate, params, plan, cfg))
        step = jax.jit(steps.make_train_step(LM(cfg), cfg, plan, opt),
                       in_shardings=(psh, osh,
                                     nm(part.batch_specs(data.batch(0),
                                                         plan))),
                       out_shardings=(psh, osh, None))
        metrics = []
        for i in range(STEPS):
            with jax.ensure_compile_time_eval():
                params, ostate, mt = step(params, ostate, data.batch(i))
            metrics.append([float(mt["loss"]), float(mt["grad_norm"])])
            np.savez(os.path.join(out_dir, f"train_{name}_step{i + 1}.npz"),
                     **{"params/" + k: v for k, v in flat(params).items()},
                     **{"opt/" + k: v for k, v in flat(ostate).items()})
        out["train/" + name] = metrics
json.dump(out, open(os.path.join(out_dir, f"reference_{what}_{names[0]}.json"),
                    "w"))
print("REFERENCE_OK")
"""

#: the reference's subprocesses: (what, cases), run side by side (jamba's
#: train step compiles for about as long as the rest together)
REFERENCE_RUNS = (("serve", ",".join(MODEL_CASES)),
                  ("train", "mamba,vision"),
                  ("train", "jamba"))


def initial_params(d):
    """Every config's parameters, drawn by the port (seed 0) and written as
    ``<tag>_init.npz`` (and ``train_<case>_init.npz``) for both
    packages."""
    from repro_torch.models import LM
    for tag in ARCHS:
        params = LM(config(tag)).init(torch.Generator().manual_seed(0))
        np.savez(os.path.join(d, tag + "_init.npz"), **flat(params))
    for name in TRAIN_CASES:
        params = LM(train_config(name)).init(
            torch.Generator().manual_seed(1))
        np.savez(os.path.join(d, f"train_{name}_init.npz"), **flat(params))


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it by name)
# ---------------------------------------------------------------------------
def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def blocks_of(tree, specs, mesh, whole_shapes=None):
    """``{path: (slices of the whole leaf, block as numpy, digest, the
    rank's coordinates on the axes the spec cuts by)}``; the whole leaf's
    shape from `whole_shapes` (a path -> shape map) or from the block."""
    from repro_torch.sharding.partition import block_of, whole_shape
    from repro_torch.tree import tree_items
    spec_of = dict(tree_items(specs))
    out = {}
    for path, leaf in tree_items(tree):
        spec = spec_of[path]
        used = {a for d in spec for a in ((d,) if isinstance(d, str)
                                          else (d or ()))}
        key = "/".join(path)
        shape = (whole_shapes[key] if whole_shapes is not None
                 else whole_shape(leaf.shape, spec, mesh))
        sl = block_of(shape, spec, mesh)
        out[key] = ([(s.start, s.stop) for s in sl],
                    leaf.detach().cpu().numpy().copy(), sha(leaf),
                    tuple(sorted((a, mesh.coords[a]) for a in used
                                 if a in mesh.shape)))
    return out


def model_case(device, name, ref_dir):
    """A model case on this rank: its rows and vocabulary block of the
    logits, its cache blocks after the prefill and after the decode steps
    (cut as `cache_specs` cuts the whole cache), and its log against
    `serve_schedule`."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_params
    from repro_torch.core import collectives
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models import LM
    from repro_torch.obs.schedule import log_against_serve, serve_schedule
    from repro_torch.sharding import partition
    from repro_torch.tree import tree_items
    shape, tag, B, max_len, S, _ = MODEL_CASES[name]
    cfg = config(tag)
    mesh = RankMesh(shape, device=device)
    plan = partition.make_plan(mesh, cfg, ShapeSpec("serve", max_len, B,
                                                    "decode"))
    whole = unflatten(dict(np.load(os.path.join(ref_dir,
                                                tag + "_init.npz"))))
    params = rank_params(whole, plan, cfg)
    toks, fed, img = model_inputs(name, cfg)
    n, h = partition.homes_of(plan)
    rows = slice(h * (B // n), (h + 1) * (B // n))
    m = LM(cfg)
    batch = {"tokens": torch.from_numpy(toks[rows]).long()}
    if img is not None:
        batch["image_embeds"] = torch.from_numpy(img[rows])
    struct = m.init_cache(B, max_len, device="meta")
    specs = partition.cache_specs(struct, plan, cfg)
    shapes = {"/".join(p): tuple(t.shape) for p, t in tree_items(struct)}
    collectives.reset_collectives()
    calls = [{"call": "prefill", "rows": B // n, "seq": S}]
    last, caches = m.prefill(params, batch, max_len=max_len, plan=plan)
    out = {"caches": {"prefill": blocks_of(caches, specs, mesh, shapes)}}
    logits = [last]
    for t in range(fed.shape[1]):
        step = torch.from_numpy(fed[rows, t:t + 1]).long()
        calls.append({"call": "decode", "rows": B // n, "seq": 1})
        lg, caches = m.decode_step(params, caches, {"tokens": step}, S + t,
                                   plan=plan)
        logits.append(lg)
    log = collectives.collective_log()
    out["caches"]["decode"] = blocks_of(caches, specs, mesh, shapes)
    out.update(home=h, tp=partition.tp_of(plan)[1],
               logits=torch.stack(logits).numpy(),
               schedule=log_against_serve(log, serve_schedule(cfg, plan,
                                                              calls))[:4],
               collectives=len(log),
               kinds=sorted({r["kind"] for r in log}))
    return out


def server_case(device, name, ref_dir):
    """A server case on this rank: tokens, summary and its log against
    `serve_schedule` of its calls."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_params
    from repro_torch.core import collectives
    from repro_torch.core.mesh import RankMesh
    from repro_torch.obs.schedule import log_against_serve, serve_schedule
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.sharding import partition
    shape, tag, slots, max_len, _, _, pad = SERVER_CASES[name]
    cfg = config(tag)
    mesh = RankMesh(shape, device=device)
    plan = partition.make_plan(mesh, cfg, ShapeSpec("serve", max_len, slots,
                                                    "decode"))
    whole = unflatten(dict(np.load(os.path.join(ref_dir,
                                                tag + "_init.npz"))))
    srv = DecodeServer(cfg, rank_params(whole, plan, cfg), batch_slots=slots,
                       max_len=max_len, plan=plan, scheduler="fifo",
                       prompt_pad=pad)
    for d in stream(name, cfg.vocab_size):
        srv.submit(Request(**d))
    collectives.reset_collectives()
    served = srv.run()
    log = collectives.collective_log()
    return {"tokens": {str(r.rid): list(r.out) for r in served},
            "summary": json.loads(json.dumps(srv.scheduler.summary())),
            "schedule": log_against_serve(
                log, serve_schedule(cfg, plan, srv.calls))[:4],
            "collectives": len(log)}


def train_case(device, name, ref_dir):
    """A train case's 2 steps on this rank: metrics, schedule differences
    and blocks of each step."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_params
    from repro_torch.core import collectives
    from repro_torch.core.mesh import RankMesh
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM, steps
    from repro_torch.obs.schedule import log_against_train, train_schedule
    from repro_torch.optim import AdamW
    from repro_torch.sharding import partition
    shape, _, _, GB = TRAIN_CASES[name]
    cfg = train_config(name)
    mesh = RankMesh(shape, device=device)
    sh = ShapeSpec("train", S_TRAIN, GB, "train")
    plan = partition.make_plan(mesh, cfg, sh)
    whole = unflatten(dict(np.load(os.path.join(
        ref_dir, f"train_{name}_init.npz"))))
    params = rank_params(whole, plan, cfg, train=True)
    opt = AdamW(lr=LR)
    state = steps.init_opt_state(cfg, opt, params, plan)
    fn = steps.make_train_step(LM(cfg, flash=False), cfg, plan, opt)
    data = SyntheticLM(cfg, GB, S_TRAIN, 0, mesh)
    want = train_schedule(cfg, plan, sh)
    specs = {"params": partition.param_specs(params, plan, cfg),
             "opt": partition.full_opt_specs(state, params, plan, cfg)}
    out = {"metrics": [], "schedule": [], "blocks": [], "collectives": 0}
    for i in range(STEPS):
        collectives.reset_collectives()
        params, state, mt = fn(params, state, data.batch(i))
        log = collectives.collective_log()
        out["collectives"] = len(log)
        out["schedule"].append(log_against_train(log, want)[:4])
        out["metrics"].append([float(mt["loss"]), float(mt["grad_norm"])])
        out["blocks"].append(blocks_of({"params": params, "opt": state},
                                       specs, mesh))
    return out


def rank_work(device, ref_dir):
    assert "jax" not in sys.modules, "a rank process imported JAX"
    import torch.distributed as dist
    out = {"rank": dist.get_rank(), "model": {}, "server": {}, "train": {}}
    for name in MODEL_CASES:
        out["model"][name] = model_case(device, name, ref_dir)
    for name in SERVER_CASES:
        out["server"][name] = server_case(device, name, ref_dir)
    for name in TRAIN_CASES:
        out["train"][name] = train_case(device, name, ref_dir)
    assert "jax" not in sys.modules, "a rank process imported JAX"
    return out


# ---------------------------------------------------------------------------
# the runs: the reference's subprocesses and the port's world side by side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    d = str(tmp_path_factory.mktemp("model_split"))
    initial_params(d)
    env = {**os.environ, "PYTHONPATH": "src"}
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, d, what,
                              names], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for what, names in REFERENCE_RUNS]
    try:
        ranks = spawn(rank_work, WORLD, "gloo", "cpu", d)
        ref_out = [p.communicate(timeout=900) for p in refs]
    finally:
        for p in refs:
            if p.poll() is None:
                p.kill()
    reference = {}
    for (r_out, r_err), (what, names) in zip(ref_out, REFERENCE_RUNS):
        assert "REFERENCE_OK" in r_out, r_out + r_err
        name = names.split(",")[0]
        with open(os.path.join(d, f"reference_{what}_{name}.json")) as f:
            reference.update(json.load(f))
    return {"dir": d, "ref": reference, "ranks": ranks}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_logits_equal_the_reference(runs, name):
    """Prefill and decode steps of fixed tokens, each rank's rows and
    vocabulary block assembled: the reference's logits within rtol 1e-4 /
    atol 1e-5."""
    shape = MODEL_CASES[name][0]
    want = np.load(os.path.join(runs["dir"], name + "_logits.npy"))
    got = np.full_like(want, np.nan)
    res = [r["model"][name] for r in runs["ranks"]]
    n = len({r["home"] for r in res})
    b, v = want.shape[1] // n, want.shape[2] // shape["model"]
    for r in res:
        h, i = r["home"], r["tp"]
        got[:, h * b:(h + 1) * b, i * v:(i + 1) * v] = r["logits"]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_cache_blocks_equal_the_reference_cut(runs, name):
    """After the prefill and after the decode steps, each rank's cache
    leaves are the reference's cache cut by `cache_specs` (positions
    exactly, values within rtol 1e-4 / atol 1e-5), and a block several
    ranks hold has one SHA-256 on all of them."""
    ref = np.load(os.path.join(runs["dir"], name + "_caches.npz"))
    for when in ("prefill", "decode"):
        held = {}
        for r in runs["ranks"]:
            blocks = r["model"][name]["caches"][when]
            assert {f"{when}/{k}" for k in blocks} == \
                {k for k in ref.files if k.startswith(when + "/")}
            for path, (sl, block, digest, where) in blocks.items():
                cut = ref[f"{when}/{path}"][tuple(slice(a, b) for a, b in sl)]
                assert block.shape == cut.shape, (name, when, path)
                if block.dtype.kind == "i":
                    np.testing.assert_array_equal(block, cut, err_msg=path)
                else:
                    np.testing.assert_allclose(block, cut, rtol=RTOL,
                                               atol=ATOL, err_msg=path)
                held.setdefault((path, where), set()).add(digest)
        assert all(len(v) == 1 for v in held.values()), (name, when)


def test_long_caches_are_homed_by_sequence(runs):
    """The long caches' self-attention blocks hold 8192 / 4 (over "data")
    and 8192 / 2 (over "model") slots a rank.  Over "data" the prompt's
    keys lie in two blocks and a decode write crosses into a third; over
    "model" a decode write crosses from the prompt's block into the
    next."""
    for name, axis, blk, blocks_live in (
            ("qwen_long", "data", 2048, (2, 3)),
            ("granite_long", "model", 4096, (1, 2))):
        for when, want in zip(("prefill", "decode"), blocks_live):
            live = set()
            for r in runs["ranks"]:
                sl, kpos, _, where = r["model"][name]["caches"][when][
                    "m0/kpos"]
                assert sl[2][1] - sl[2][0] == blk, (name, sl)
                assert dict(where).get(axis) is not None, (name, where)
                if (kpos >= 0).any():
                    live.add(sl[2][0])
            assert len(live) == want, (name, when, live)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_logs_equal_serve_schedule(runs, name):
    """Every rank's collectives of the prefill and decode steps are
    `serve_schedule`'s, one for one: the norm statistic's and the split
    products' sums, the blocks' merges."""
    kinds = set()
    for r in runs["ranks"]:
        res = r["model"][name]
        assert res["schedule"] == [], (name, res["schedule"])
        assert res["collectives"] > 0, name
        kinds |= set(res["kinds"])
    if name == "granite_long":
        assert {"all-gather", "all-to-all", "all-reduce"} <= kinds


@pytest.mark.parametrize("name", sorted(SERVER_CASES))
def test_server_tokens_equal_the_reference(runs, name):
    """The reference's `DecodeServer` on the same plan: every request's
    tokens and the summary, on every rank; every rank's log equal to
    `serve_schedule` of its calls."""
    want = runs["ref"]["server/" + name]
    for r in runs["ranks"]:
        res = r["server"][name]
        assert res["tokens"] == want["tokens"], name
        assert res["summary"] == json.loads(json.dumps(want["summary"]))
        assert res["schedule"] == [], (name, res["schedule"])
        assert res["collectives"] > 0, name


def _close(got, want, what):
    """Within rtol / atol, but for at most 0.1 % of the elements, each
    within 2 * LR * STEPS (a near-zero gradient element turns AdamW's step
    on the rounding; the two frameworks add gradients in other orders)."""
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert off.mean() <= 1e-3, (what, off.mean())
    far = 2 * LR * STEPS if "params/" in what else ATOL * 10
    assert (np.abs(got - want)[off] <= far).all(), (
        what, np.abs(got - want)[off].max())


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_ranks_train_the_reference_step(runs, name):
    """Loss and gradient norm of each step, and every rank's blocks of the
    updated parameters, ``m`` and ``v``: the reference's within rtol 1e-4
    / atol 1e-5."""
    want = runs["ref"]["train/" + name]
    refs = [np.load(os.path.join(runs["dir"],
                                 f"train_{name}_step{i + 1}.npz"))
            for i in range(STEPS)]
    for r in runs["ranks"]:
        res = r["train"][name]
        np.testing.assert_allclose(res["metrics"], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        for i, ref in enumerate(refs):
            assert set(res["blocks"][i]) == set(ref.files), name
            for path, (sl, block, _, _) in res["blocks"][i].items():
                cut = ref[path][tuple(slice(a, b) for a, b in sl)]
                assert block.shape == cut.shape, (name, path)
                _close(block, cut, f"{name} step {i + 1} {path}")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_logs_and_replicas(runs, name):
    """Every rank's collectives of each step are `train_schedule`'s, one
    for one, and a block several ranks hold is bit-equal on all of them
    after every step."""
    ranks = [r["train"][name] for r in runs["ranks"]]
    for res in ranks:
        assert res["schedule"] == [[]] * STEPS, (name, res["schedule"])
        assert res["collectives"] > 0
    for i in range(STEPS):
        held = {}
        for res in ranks:
            for path, (_, _, digest, where) in res["blocks"][i].items():
                held.setdefault((path, where), set()).add(digest)
        assert not [k for k, v in held.items() if len(v) > 1], (name, i)


# ---------------------------------------------------------------------------
# the plan grid: every config on three meshes and four shapes
# ---------------------------------------------------------------------------
def grid_shape(name):
    return (base.ShapeSpec("serve", 96, 16, "decode") if name == "serve"
            else base.SHAPES[name])


@pytest.mark.parametrize("arch", base.list_configs())
def test_every_plan_runs_on_ranks(arch):
    """For each of three meshes and four shapes, on every rank: `make_plan`
    resolves, `rank_heads` (or the Mamba2 heads) splits, the model's
    cache takes the plan (its blocks as `cache_specs` cuts the whole),
    `serve_schedule` lists a prefill, a decode step and their picks, and
    `train_schedule` (at ``train_4k``) lists a step -- none raises."""
    from repro_torch.models import LM, blocks
    from repro_torch.models.attention import rank_heads
    from repro_torch.models.mamba2 import rank_ssm_heads
    from repro_torch.obs.schedule import serve_schedule, train_schedule
    from repro_torch.sharding import partition
    from repro_torch.tree import tree_items
    cfg = base.get_config(arch)
    members = {m.mixer for m in blocks.superblock_spec(cfg)}
    for mname, shape in GRID_MESHES.items():
        size = int(np.prod(list(shape.values())))
        for sname in GRID_SHAPES:
            sh = grid_shape(sname)
            for rank in range(size):
                mesh = AbstractRankMesh(shape, rank)
                plan = partition.make_plan(mesh, cfg, sh)
                if members - {"mamba"}:
                    rh = rank_heads(cfg, plan)
                    assert rh.H * partition.tp_of(plan)[0] == cfg.num_heads \
                        or not rh.split
                if "mamba" in members:
                    assert rank_ssm_heads(cfg, plan)[0] \
                        * partition.tp_of(plan)[0] == cfg.ssm_nheads
                if sname == "train_4k":
                    assert train_schedule(cfg, plan, sh), (mname, rank)
                    continue
                splan = partition.serving_plan(plan)
                n = partition.homes_of(splan)[0]
                B = sh.global_batch // n
                calls = [{"call": "prefill", "rows": B, "seq": 16},
                         {"call": "pick", "rows": B, "seq": 1},
                         {"call": "decode", "rows": B, "seq": 1},
                         {"call": "pick", "rows": B, "seq": 1}]
                assert serve_schedule(cfg, splan, calls), (mname, sname)
                if rank:
                    continue
                model = LM(cfg)
                mine = model.init_cache(B, sh.seq_len, device="meta",
                                        plan=splan)
                whole = model.init_cache(sh.global_batch, sh.seq_len,
                                         device="meta")
                specs = dict(tree_items(partition.cache_specs(
                    whole, splan, cfg)))
                for path, leaf in tree_items(whole):
                    if path[-1] == "kpos" and len(leaf.shape) == 2:
                        continue          # a cross layer's: kept whole
                    sl = partition.block_of(leaf.shape, specs[path], mesh)
                    got = dict(tree_items(mine))[path].shape
                    assert tuple(got) == tuple(
                        len(range(*s.indices(d)))
                        for s, d in zip(sl, leaf.shape)), (mname, sname,
                                                           path)
