"""Training across torch.distributed ranks, held to the JAX reference's
sharded train step on a mesh of host devices.

One JAX subprocess (8 host devices; meshes with Auto axes: jax 0.9.0's
default Explicit axes reject the reference's sharding constraints) runs
``jax.jit(make_train_step(...))`` with ``in_shardings`` from
`param_specs`, `full_opt_specs` and `batch_specs`, as
`tests/test_sharded_equivalence.py` sets it up, for 2 steps of each case
of `CASES` -- reduced qwen3-0.6b and mixtral-8x7b with FSDP, the
sequence-sharded residual, remat and 2 microbatches on ``{"data": 2,
"model": 2}`` (and qwen3 without the sequence split, Megatron's f/g
only), reduced mamba2-2.7b and jamba (one superblock, its own ZeRO-1)
on ``{"data": 4, "model": 1}``, and error feedback on ``{"data": 2,
"model": 1}`` -- from parameters the port drew (float32, the reference
reads them), on the reference pipeline's batches.  It also writes
`opt_specs`/`full_opt_specs` for all ten configs on three meshes at
``SHAPES["train_4k"]``, and the reference's `launch.train` runs from a
step-0 checkpoint the port wrote.

The port trains the same cases on gloo worlds of 4 and 2 CPU processes
(`launch.mesh.spawn`, one spawn a world, beside the reference's
subprocess), each rank cutting the parameters to its blocks
(`convert.rank_params`).  Required: loss, gradient norm, updated
parameters, ``m`` and ``v`` after each step within rtol 1e-4 / atol
1e-5 of the reference's; every rank's collective log of every step equal
to `obs.schedule.train_schedule` op for op; every block that several
ranks hold bit-equal on all of them (SHA-256).  Also: `reduce_scatter`
is `psum` sliced bit for bit; an elastic checkpoint saved on 4 ranks
restores bit-equal in one process and on 2 ranks; a resume on ranks is
bit-identical to a straight run; a bad batch on one home makes every
rank skip the same step; ``launch.train --ranks 4`` prints the
reference launcher's loss.

The rank processes import this module, which imports torch, numpy and
the port only; JAX comes in inside the subprocesses.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import base

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
S, STEPS, LR = 32, 2, 1e-3
KNOBS = dict(fsdp=True, sequence_shard=True, remat=True, microbatches=2)
#: name -> (world, mesh, arch, layers (None: reduce_config's), parallel
#: knobs, global batch)
CASES = {
    "qwen": (4, {"data": 2, "model": 2}, "qwen3-0.6b", None, KNOBS, 4),
    "mixtral": (4, {"data": 2, "model": 2}, "mixtral-8x7b", None, KNOBS, 4),
    "qwen_tp": (4, {"data": 2, "model": 2}, "qwen3-0.6b", None,
                dict(sequence_shard=False), 4),
    "mamba": (4, {"data": 4, "model": 1}, "mamba2-2.7b", None, KNOBS, 8),
    "jamba": (4, {"data": 4, "model": 1}, "jamba-1.5-large-398b", 8,
              {**KNOBS, "zero1": True}, 8),
    "ef": (2, {"data": 2, "model": 1}, "qwen3-0.6b", None,
           dict(grad_compression=True), 4),
}
WORLDS = (4, 2)
#: microbatches that do not divide over the homes (`partition.micro_rows`),
#: each held to one process's step: name -> (arch, mesh, knobs, global
#: batch, the rows a home takes of each microbatch).  "data4": 8 rows in 4
#: microbatches of 2 on {"data": 4}, homes 0 and 1 one row, homes 2 and 3
#: none.  "data2_model2": 4 rows in 4 microbatches of 1 on {"data": 2,
#: "model": 2} with the sequence-sharded residual, home 1 none, so its
#: ranks run the vocabulary's all-gather, the tensor-parallel collectives
#: and the sequence split on empty tensors
UNEVEN = {
    "data4": ("qwen3-0.6b", {"data": 4, "model": 1},
              dict(fsdp=True, remat=True, microbatches=4), 8, (1, 1, 0, 0)),
    "data2_model2": ("qwen3-0.6b", {"data": 2, "model": 2},
                     dict(fsdp=True, sequence_shard=True, remat=True,
                          microbatches=4), 4, (1, 0)),
}
#: the cases the reference runs in a process of their own
SLOW_REFERENCE = ("jamba",)
#: the opt-spec grid (the reference's meshes of `test_torch_serve_ranks`)
SPEC_MESHES = {"flat8": {"data": 8, "model": 1},
               "pods222": {"pod": 2, "data": 2, "model": 2},
               "pods142": {"pod": 1, "data": 4, "model": 2}}
#: the checkpoint, resume and guard cases: saved on the "qwen" case's 4
#: ranks, restored on 2 ranks of this mesh
RESTORE_MESH = {"data": 1, "model": 2}
TRAIN_STEPS, TRAIN_EVERY, POISON_STEP = 5, 2, 3
#: the launchers' run: reduced qwen3-0.6b, its default batch and sequence
LAUNCH = ["--arch", "qwen3-0.6b", "--steps", "10"]


def case_config(name, cfgs=base):
    """A case's reduced config of `cfgs` (the port's configs module or the
    reference's) with its parallel knobs."""
    _, _, arch, layers, knobs, _ = CASES[name]
    cfg = cfgs.reduce_config(cfgs.get_config(arch), **(
        {"layers": layers} if layers else {}))
    return cfg.replace(parallel=cfg.parallel.__class__(**knobs))


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
# the reference, in one subprocess
# ---------------------------------------------------------------------------
REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from repro.configs import base
from repro.configs.base import SHAPES, ShapeSpec
from repro.data.pipeline import SyntheticLM
from repro.models import steps
from repro.models.model import LM
from repro.optim import AdamW
from repro.sharding import partition as part
from test_torch_train_ranks import (CASES, LR, S, SPEC_MESHES, STEPS,
                                    case_config)

out_dir, which, names = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
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

def mesh_of(shape, n):
    return jax.make_mesh(tuple(shape.values()), tuple(shape),
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])

out = {"metrics": {}, "specs": {}}
for name in names:
    world, shape, arch, layers, knobs, GB = CASES[name]
    cfg = case_config(name, base)
    mesh = mesh_of(shape, world)
    plan = part.make_plan(mesh, cfg, ShapeSpec("train", S, GB, "train"))
    params = unflat(dict(np.load(os.path.join(out_dir, name + "_init.npz"))))
    opt = AdamW(lr=LR)
    ostate = steps.init_opt_state(cfg, opt, params)
    nm = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda s: isinstance(s, P))
    data = SyntheticLM(cfg, GB, S, seed=0)
    batch = data.batch(0)
    psh = nm(part.param_specs(params, plan, cfg))
    osh = nm(part.full_opt_specs(ostate, params, plan, cfg))
    step = jax.jit(steps.make_train_step(LM(cfg), cfg, plan, opt),
                   in_shardings=(psh, osh, nm(part.batch_specs(batch, plan))),
                   out_shardings=(psh, osh, None))
    metrics = []
    for i in range(STEPS):
        with jax.ensure_compile_time_eval():
            params, ostate, m = step(params, ostate, data.batch(i))
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
        np.savez(os.path.join(out_dir, f"{name}_step{i + 1}.npz"),
                 **{"params/" + k: v for k, v in flat(params).items()},
                 **{"opt/" + k: v for k, v in flat(ostate).items()})
    out["metrics"][name] = metrics

def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]

is_p = lambda s: isinstance(s, P)
for arch in base.list_configs() if which == "specs" else ():
    for ef in (False, True):
        cfg = base.get_config(arch)
        cfg = cfg.replace(parallel=cfg.parallel.__class__(
            **{**cfg.parallel.__dict__, "grad_compression": ef}))
        pshape = jax.eval_shape(LM(cfg).init, jax.random.key(0))
        oshape = jax.eval_shape(lambda p: steps.init_opt_state(
            cfg, AdamW(), p), pshape)
        for mname, shape in SPEC_MESHES.items():
            plan = part.make_plan(mesh_of(shape, 8), cfg, SHAPES["train_4k"])
            tree = lambda t: {"/".join(str(getattr(k, "key", k))
                                       for k in pth): spec(v)
                              for pth, v in
                              jax.tree_util.tree_flatten_with_path(
                                  t, is_leaf=is_p)[0]}
            out["specs"][f"{arch}-{ef}-{mname}"] = {
                "opt": tree(part.opt_specs(pshape, plan, cfg)),
                "full": tree(part.full_opt_specs(oshape, pshape, plan, cfg))}
json.dump(out, open(os.path.join(out_dir, f"reference_{which}.json"), "w"))
print("REFERENCE_OK")
"""


def initial_params(d):
    """Each case's parameters, drawn by the port (seed 0) and written as
    ``<case>_init.npz`` for both packages; the launchers' step-0
    checkpoint (the reduced qwen3-0.6b from seed 0 and AdamW's zero
    state), written by the port in the reference's format."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import LM, steps
    from repro_torch.optim import AdamW
    for name in CASES:
        cfg = case_config(name)
        params = LM(cfg).init(torch.Generator().manual_seed(0))
        np.savez(os.path.join(d, name + "_init.npz"), **flat(params))
    cfg = base.reduce_config(base.get_config("qwen3-0.6b"))
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    state = {"params": params,
             "opt": steps.init_opt_state(cfg, AdamW(), params)}
    for who in ("port", "ref"):
        ckpt.save(os.path.join(d, f"launch_{who}"), 0, state)


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it by name)
# ---------------------------------------------------------------------------
def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def blocks_of(tree, specs, mesh):
    """``{path: (slices of the whole leaf, block as numpy, digest, the
    rank's coordinates on the axes the spec cuts by)}``."""
    from repro_torch.sharding.partition import block_of, whole_shape
    from repro_torch.tree import tree_items
    spec_of = dict(tree_items(specs))
    out = {}
    for path, leaf in tree_items(tree):
        spec = spec_of[path]
        used = {a for d in spec for a in ((d,) if isinstance(d, str)
                                          else (d or ()))}
        sl = block_of(whole_shape(leaf.shape, spec, mesh), spec, mesh)
        out["/".join(path)] = (
            [(s.start, s.stop) for s in sl],
            leaf.detach().cpu().numpy().copy(),   # the step updates in place
            sha(leaf), tuple(sorted((a, mesh.coords[a]) for a in used
                                    if a in mesh.shape)))
    return out


def train_case(device, name, ref_dir):
    """One case's 2 steps on this rank: metrics, schedule differences and
    blocks of each step."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_opt_state, rank_params
    from repro_torch.core import collectives
    from repro_torch.core.mesh import RankMesh
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM, steps
    from repro_torch.obs.schedule import log_against_train, train_schedule
    from repro_torch.optim import AdamW
    from repro_torch.sharding import partition
    from repro_torch.tree import tree_items
    world, shape, _, _, _, GB = CASES[name]
    cfg = case_config(name)
    mesh = RankMesh(shape, device=device)
    sh = ShapeSpec("train", S, GB, "train")
    plan = partition.make_plan(mesh, cfg, sh)
    whole = unflatten(dict(np.load(os.path.join(ref_dir,
                                                name + "_init.npz"))))
    params = rank_params(whole, plan, cfg, train=True)
    opt = AdamW(lr=LR)
    # the whole zero state cut to the rank's blocks (ZeRO-1's cut of m
    # and v too) is the state the rank's own init makes
    state = rank_opt_state(steps.init_opt_state(cfg, opt, whole), whole,
                           plan, cfg)
    own = steps.init_opt_state(cfg, opt, params, plan)
    assert [(p, t.shape) for p, t in tree_items(state)] == \
        [(p, t.shape) for p, t in tree_items(own)], name
    fn = steps.make_train_step(LM(cfg, flash=False), cfg, plan, opt)
    data = SyntheticLM(cfg, GB, S, 0, mesh)
    want = train_schedule(cfg, plan, sh)
    specs = {"params": partition.param_specs(params, plan, cfg),
             "opt": partition.full_opt_specs(state, params, plan, cfg)}
    out = {"metrics": [], "schedule": [], "blocks": [], "collectives": 0}
    for i in range(STEPS):
        collectives.reset_collectives()
        params, state, m = fn(params, state, data.batch(i))
        log = collectives.collective_log()
        out["collectives"] = len(log)
        out["schedule"].append(log_against_train(log, want)[:4])
        out["metrics"].append([float(m["loss"]), float(m["grad_norm"])])
        out["blocks"].append(blocks_of({"params": params, "opt": state},
                                       specs, mesh))
    return out, (cfg, mesh, plan, params, state, specs)


def uneven_steps(device, name, ranks: bool):
    """`STEPS` train steps of the `UNEVEN` case `name` from the port's
    parameters of seed 0: on this rank's blocks of its mesh (`ranks`), or
    in one process.  Each step's loss and norm, the rows each microbatch
    gave this rank, its home (its "data" coordinate), and (on ranks) where
    its collectives differ from `train_schedule`."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_params
    from repro_torch.core import collectives
    from repro_torch.core.mesh import RankMesh
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM, steps
    from repro_torch.obs.schedule import log_against_train, train_schedule
    from repro_torch.optim import AdamW
    from repro_torch.sharding import partition
    arch, shape, knobs, GB, _ = UNEVEN[name]
    cfg = base.reduce_config(base.get_config(arch))
    cfg = cfg.replace(parallel=cfg.parallel.__class__(**knobs))
    sh = ShapeSpec("train", S, GB, "train")
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    mesh, plan = None, partition.NULL_PLAN
    if ranks:
        mesh = RankMesh(shape, device=device)
        plan = partition.make_plan(mesh, cfg, sh)
        params = rank_params(params, plan, cfg, train=True)
    opt = AdamW(lr=LR)
    state = steps.init_opt_state(cfg, opt, params, plan)
    fn = steps.make_train_step(LM(cfg, flash=False), cfg, plan, opt)
    data = SyntheticLM(cfg, GB, S, 0, mesh, device=device)
    rows = []
    split = steps._micro_split

    def counted(batch, m, p=None):
        parts = split(batch, m, p)
        rows.append([int(x["tokens"].shape[0]) for x in parts])
        return parts
    steps._micro_split = counted
    out = {"metrics": [], "schedule": [], "rows": rows,
           "home": mesh.coords["data"] if ranks else 0}
    try:
        for i in range(STEPS):
            collectives.reset_collectives()
            params, state, m = fn(params, state, data.batch(i))
            if ranks:
                out["schedule"].append(log_against_train(
                    collectives.collective_log(),
                    train_schedule(cfg, plan, sh))[:4])
            out["metrics"].append([float(m["loss"]), float(m["grad_norm"])])
    finally:
        steps._micro_split = split
    return out


def rank_train(device, world, ref_dir):
    assert "jax" not in sys.modules, "a rank process imported JAX"
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt
    from repro_torch.core import collectives
    from repro_torch.core.mesh import RankMesh
    out = {"rank": dist.get_rank(), "cases": {}}
    for name, (w, *_) in CASES.items():
        if w != world:
            continue
        res, held = train_case(device, name, ref_dir)
        out["cases"][name] = res
        if name == "qwen":
            cfg, mesh, plan, params, state, specs = held
            d = os.path.join(ref_dir, "elastic")
            ckpt.save(d, STEPS, {"params": params, "opt": state}, 3,
                      specs, mesh)
            out["saved"] = blocks_of({"params": params, "opt": state},
                                     specs, mesh)
    if world == 4:
        mesh = RankMesh({"data": 4}, device=device)
        gen = torch.Generator().manual_seed(dist.get_rank())
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((8, 5), generator=gen).to(dt)
            out.setdefault("rs", []).append(bool(torch.equal(
                collectives.reduce_scatter(x, mesh, ("data",)).view(
                    torch.uint8) if dt == torch.bfloat16 else
                collectives.reduce_scatter(x, mesh, ("data",)),
                (collectives.psum(x, mesh, ("data",))[
                    2 * mesh.rank:2 * mesh.rank + 2]).view(torch.uint8)
                if dt == torch.bfloat16 else
                collectives.psum(x, mesh, ("data",))[
                    2 * mesh.rank:2 * mesh.rank + 2])))
        out["trainer"] = trainer_runs(device, ref_dir)
        out["uneven"] = {name: uneven_steps(device, name, ranks=True)
                         for name in UNEVEN}
    else:
        out["restored"] = restore_elastic(device, ref_dir)
    assert "jax" not in sys.modules, "a rank process imported JAX"
    return out


def restore_elastic(device, ref_dir):
    """The 4 ranks' checkpoint restored on this world's `RESTORE_MESH`:
    this rank's blocks."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_params
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models import steps
    from repro_torch.optim import AdamW
    from repro_torch.sharding import partition
    cfg = case_config("qwen")
    mesh = RankMesh(RESTORE_MESH, device=device)
    plan = partition.make_plan(mesh, cfg, ShapeSpec("train", S, 4, "train"))
    whole = unflatten(dict(np.load(os.path.join(ref_dir, "qwen_init.npz"))))
    params = rank_params(whole, plan, cfg, train=True)
    state = steps.init_opt_state(cfg, AdamW(), params, plan)
    specs = {"params": partition.param_specs(params, plan, cfg),
             "opt": partition.full_opt_specs(state, params, plan, cfg)}
    got = ckpt.restore(os.path.join(ref_dir, "elastic"), STEPS,
                       {"params": params, "opt": state}, specs, mesh)
    return blocks_of(got, specs, mesh)


def trainer_runs(device, ref_dir):
    """The "qwen" case's `Trainer` on these 4 ranks: a straight run of
    `TRAIN_STEPS`, a run resumed from its step-4 checkpoint, and a run in
    which home 1's nll at step `POISON_STEP` is not a number.  Each run's
    metrics as every rank saw them, and its final parameters' digests."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models import steps as steps_mod
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding import partition
    from repro_torch.tree import tree_items
    cfg = case_config("qwen")
    mesh = RankMesh(CASES["qwen"][1], device=device)
    plan = partition.make_plan(mesh, cfg, ShapeSpec("train", S, 4, "train"))
    out = {}

    def run(tag, d, poison=False):
        tr = Trainer(cfg, TrainerConfig(
            steps=TRAIN_STEPS, global_batch=4, seq_len=S, ckpt_dir=d,
            ckpt_every=TRAIN_EVERY, log_every=1, device=device,
            warmup=1, lr=LR), plan, mesh)
        inner, seen = tr.step_fn, []

        def step_fn(*a, **kw):
            r = inner(*a, **kw)
            seen.append([float(r[2]["step"]), float(r[2]["loss"]),
                         float(r[2]["grad_norm"])])
            return r
        tr.step_fn = step_fn
        real = steps_mod.vocab_nll
        calls = [0]

        def poisoned(*a, **kw):
            v = real(*a, **kw)
            calls[0] += 1
            mb = cfg.parallel.microbatches
            if mesh.coords["data"] == 1 and \
                    (calls[0] - 1) // mb == POISON_STEP - 1:
                v = v * float("nan")
            return v
        if poison:
            steps_mod.vocab_nll = poisoned
        try:
            res = tr.run()
        finally:
            steps_mod.vocab_nll = real
        out[tag] = {"seen": seen, "final_step": res["final_step"],
                    "digests": {"/".join(p): sha(t) for p, t in
                                tree_items(res["params"])}}

    base_dir = os.path.join(ref_dir, "trainer")
    run("straight", base_dir)
    dist.barrier()
    if mesh.rank == 0:
        shutil.rmtree(os.path.join(base_dir, f"step_{TRAIN_STEPS:08d}"))
    dist.barrier()
    run("resumed", base_dir)
    run("poisoned", os.path.join(ref_dir, "poisoned"), poison=True)
    return out


# ---------------------------------------------------------------------------
# the runs: the reference's subprocesses and the port's worlds side by side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    d = str(tmp_path_factory.mktemp("train_ranks"))
    initial_params(d)
    env = {**os.environ, "PYTHONPATH": "src"}
    # two reference processes: jamba's step compiles for as long as the
    # other cases together
    rest = ",".join(n for n in CASES if n not in SLOW_REFERENCE)
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, d, part,
                              names], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for part, names in (("slow", ",".join(SLOW_REFERENCE)),
                                ("specs", rest))]
    ref_launch = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *LAUNCH, "--ckpt",
         os.path.join(d, "launch_ref")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        worlds = {w: spawn(rank_train, w, "gloo", "cpu", w, d)
                  for w in WORLDS}
        port_launch = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
             "--ranks", "4", "--device", "cpu", "--ckpt",
             os.path.join(d, "launch_port")], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
        ref_out = [p.communicate(timeout=900) for p in refs]
        l_out, l_err = ref_launch.communicate(timeout=600)
    finally:
        for p in (*refs, ref_launch):
            if p.poll() is None:
                p.kill()
    reference = {"metrics": {}, "specs": {}}
    for (r_out, r_err), part in zip(ref_out, ("slow", "specs")):
        assert "REFERENCE_OK" in r_out, r_out + r_err
        with open(os.path.join(d, f"reference_{part}.json")) as f:
            for k, v in json.load(f).items():
                reference[k].update(v)
    return {"dir": d, "ref": reference, "worlds": worlds,
            "launch": (port_launch, (ref_launch.returncode, l_out, l_err))}


def ranks_of(runs, name):
    return [res["cases"][name] for res in runs["worlds"][CASES[name][0]]]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
#: the share of a leaf's elements that may lie outside rtol / atol, and
#: by how much (`held`)
OUTLIERS = 1e-3


def held(got, want, what: str, far: float) -> None:
    """`got` within rtol 1e-4 / atol 1e-5 of `want`, but for at most 0.1 %
    of the elements, each within `far`.  The two frameworks add the same
    gradients in other orders; where a gradient element is near zero
    (AdamW's step ``m / (sqrt(v) + eps)`` then turns on the rounding) or
    near a rounding boundary of the int8 grid (error feedback: one
    quantum apart), an element may land that far off (see `far_of`)."""
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert off.mean() <= OUTLIERS, (what, off.mean())
    assert (np.abs(got - want)[off] <= far).all(), (
        what, np.abs(got - want)[off].max(), far)


def far_of(path: str, step: int, ref, prev, gnorm: float,
           ef: bool) -> float:
    """How far an outlier of `held` may be: a parameter, the most two
    AdamW runs move apart in `STEPS` steps of learning rate `LR` (|step|
    <= 1 each); under error feedback, a moment or a residual, two quanta
    of the int8 grid of the step's dequantised gradient (its largest
    |value| / 127), that largest value bounded from the reference's
    first moments (``m = 0.9 m' + 0.1 clip g``)."""
    if path.startswith("params/"):
        return 2 * LR * STEPS
    if not ef or path == "opt/adam/step":
        return 0.0
    leaf = path.split("/", 3)[-1] if path.startswith("opt/adam/") \
        else path.split("/", 2)[-1]
    m = np.abs(ref["opt/adam/m/" + leaf]).max()
    m_prev = np.abs(prev["opt/adam/m/" + leaf]).max() if prev else 0.0
    clip = min(1.0, 1.0 / (gnorm + 1e-9))
    grad = (m + 0.9 * m_prev) / (0.1 * clip)
    return 2 * grad / 127 * (1.0 if "/v/" not in path else 2 * grad)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_train_the_reference_step(runs, name):
    """Loss and gradient norm of each step, and the updated parameters,
    ``m`` and ``v`` after each, of every rank's blocks: the reference's
    within rtol 1e-4 / atol 1e-5 (`held`)."""
    want = runs["ref"]["metrics"][name]
    ef = CASES[name][4].get("grad_compression", False)
    refs = [np.load(os.path.join(runs["dir"], f"{name}_step{i + 1}.npz"))
            for i in range(STEPS)]
    for res in ranks_of(runs, name):
        np.testing.assert_allclose(res["metrics"], want, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        for i, ref in enumerate(refs):
            assert set(res["blocks"][i]) == set(ref.files), name
            for path, (sl, block, _, _) in res["blocks"][i].items():
                cut = ref[path][tuple(slice(a, b) for a, b in sl)]
                assert block.shape == cut.shape, (name, path)
                held(block, cut, f"{name} step {i + 1} {path}",
                     far_of(path, i, ref, refs[i - 1] if i else None,
                            want[i][1], ef))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_logs_equal_train_schedule(runs, name):
    """Every rank's collectives of each step are `train_schedule`'s, one
    for one: kind, axes, wire, inter- and intra-pod bytes."""
    for res in ranks_of(runs, name):
        assert res["schedule"] == [[]] * STEPS, (name, res["schedule"])
        assert res["collectives"] > 0, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_blocks_are_bit_equal(runs, name):
    """A block that several ranks hold (the same coordinates on the axes
    its spec cuts by) has one SHA-256 on all of them, after every step."""
    ranks = ranks_of(runs, name)
    for i in range(STEPS):
        held = {}
        for res in ranks:
            for path, (_, _, digest, where) in res["blocks"][i].items():
                held.setdefault((path, where), set()).add(digest)
        bad = [k for k, v in held.items() if len(v) > 1]
        assert not bad, (name, i, bad[:3])
        # every rank of a block that is replicated shares it
        assert any(len(ranks) > len({w for (p, w) in held if p == path})
                   for path in {p for p, _ in held})


@pytest.mark.parametrize("name", sorted(UNEVEN))
def test_microbatches_that_do_not_divide_over_the_homes(runs, name):
    """A microbatch of fewer rows than homes, where the split raised
    before: the first homes take its rows, the last none.  Each home
    weights its rows by the microbatch's row count (a home of no rows
    adds exactly 0), so every rank's loss and gradient norm are one
    process's step within rtol 1e-4 / atol 1e-5, and every rank's
    collectives (the uneven all-to-alls among them) are
    `train_schedule`'s."""
    *_, GB, homes = UNEVEN[name]
    m = UNEVEN[name][2]["microbatches"]
    want = uneven_steps("cpu", name, ranks=False)
    assert want["rows"] == [[GB // m] * m] * STEPS
    for res in runs["worlds"][4]:
        got = res["uneven"][name]
        r = res["rank"]
        assert got["rows"] == [[homes[got["home"]]] * m] * STEPS, (r, got)
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=RTOL, atol=ATOL, err_msg=str(r))
        assert got["schedule"] == [[]] * STEPS, (r, got["schedule"])
        assert all(np.isfinite(got["metrics"]).ravel())


def test_reduce_scatter_is_psum_sliced(runs):
    """Bit for bit, float32 and bfloat16, on 4 ranks."""
    for res in runs["worlds"][4]:
        assert res["rs"] == [True, True]


def test_elastic_checkpoint_restores_on_any_mesh(runs):
    """The 4 ranks' checkpoint of the "qwen" case: restored in one process,
    each leaf is the whole array whose blocks the ranks held (bit for
    bit); restored on 2 ranks of another mesh, each rank's blocks are
    that array's blocks."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.tree import tree_items
    d = os.path.join(runs["dir"], "elastic")
    man = ckpt.manifest(d, STEPS)
    target = unflatten({k: np.zeros(v["shape"], np.float32)
                        if v["dtype"] == "float32" else
                        np.zeros(v["shape"], v["dtype"])
                        for k, v in man.items()})
    whole = {"/".join(p): t.numpy() for p, t in
             tree_items(ckpt.restore(d, STEPS, target))}
    for res in runs["worlds"][4]:
        for path, (sl, block, _, _) in res["saved"].items():
            cut = whole[path][tuple(slice(a, b) for a, b in sl)]
            assert cut.tobytes() == block.tobytes(), path
    for res in runs["worlds"][2]:
        assert set(res["restored"]) == set(whole)
        for path, (sl, block, _, _) in res["restored"].items():
            cut = whole[path][tuple(slice(a, b) for a, b in sl)]
            assert cut.shape == block.shape and \
                cut.tobytes() == block.tobytes(), path


def test_resume_on_ranks_is_bit_identical(runs):
    """A trainer resumed on the 4 ranks from the step-4 checkpoint logs
    step 5's loss and norm bit for bit, and ends on the straight run's
    parameters."""
    for res in runs["worlds"][4]:
        t = res["trainer"]
        assert t["resumed"]["seen"] == t["straight"]["seen"][4:], res["rank"]
        assert t["resumed"]["digests"] == t["straight"]["digests"]
        assert t["straight"]["final_step"] == TRAIN_STEPS


def test_guard_skips_the_same_step_on_every_rank(runs):
    """Home 1's nll at step 3 is not a number: every rank rejects that
    step (the optimiser's step count repeats), restores the step-2
    checkpoint, and all end on the same parameters."""
    seen = [res["trainer"]["poisoned"]["seen"] for res in runs["worlds"][4]]
    steps = [[s[0] for s in one] for one in seen]
    assert all(s == steps[0] for s in steps)
    assert steps[0] == [1.0, 2.0, 3.0, 3.0, 4.0], steps[0]
    assert all(not np.isfinite(one[2][1]) for one in seen)
    whole = ("final_norm", "stack/m0/ln1", "stack/m0/attn/q_norm")
    digests = {tuple(res["trainer"]["poisoned"]["digests"][p] for p in whole)
               for res in runs["worlds"][4]}
    assert len(digests) == 1


def _step10(text):
    for line in text.splitlines():
        if line.startswith("{") and '"step": 10' in line:
            return json.loads(line)
    raise AssertionError(text[-2000:])


def test_launch_train_on_ranks_prints_the_reference_launchers_loss(runs):
    """``launch.train --ranks 4 --device cpu`` and the reference's
    ``launch.train``, both resuming the same step-0 checkpoint: step 10's
    loss and norm within rtol 1e-4."""
    port, (rc, out, err) = runs["launch"]
    assert port.returncode == 0, port.stdout + port.stderr
    assert rc == 0, out + err
    got, want = _step10(port.stdout), _step10(out)
    np.testing.assert_allclose([got["loss"], got["grad_norm"]],
                               [want["loss"], want["grad_norm"]], rtol=RTOL)
    assert "done: step=10" in port.stdout


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _tree_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_specs(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: [list(e) if isinstance(e, tuple) else e
                          for e in tree]}


def _norm(specs):
    """A reference spec tree with one-name tuples as the name (the
    `partition.P` normal form)."""
    return {k: [e[0] if isinstance(e, list) and len(e) == 1 else e
                for e in v] for k, v in specs.items()}


@pytest.mark.parametrize("arch", base.list_configs())
def test_opt_specs_equal_the_reference(runs, arch):
    """`opt_specs` and `full_opt_specs` of the full config (with and
    without error feedback) on three meshes at ``train_4k``."""
    from repro_torch.core.mesh import HomeMesh
    from repro_torch.models import LM
    from repro_torch.models.common import MetaGen
    from repro_torch.sharding import partition
    for ef in (False, True):
        cfg = base.get_config(arch)
        cfg = cfg.replace(parallel=cfg.parallel.__class__(
            **{**cfg.parallel.__dict__, "grad_compression": ef}))
        params = LM(cfg).init(MetaGen())
        state = {"adam": {}, **({"ef": {}} if ef else {})}
        for mname, shape in SPEC_MESHES.items():
            plan = partition.make_plan(HomeMesh(shape, device="cpu"), cfg,
                                       base.SHAPES["train_4k"])
            want = runs["ref"]["specs"][f"{arch}-{ef}-{mname}"]
            assert _tree_specs(partition.opt_specs(params, plan, cfg)) \
                == _norm(want["opt"]), (mname, ef)
            assert _tree_specs(partition.full_opt_specs(
                state, params, plan, cfg)) == _norm(want["full"]), (mname, ef)
