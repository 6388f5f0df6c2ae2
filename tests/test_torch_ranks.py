"""The engine across torch.distributed ranks, held to the one-process
engine and to the 8-device JAX engine, bit for bit.

One gloo world of 2, 4 and 8 processes each (`launch.mesh.spawn`, on the
CPU: the kernels' plain versions) runs every case of this file in one
spawn per world size: the 8 Table-1 cases in int32 and float32 under both
local phases, bfloat16 and uint32, the hierarchical policies on (2, 4)
and (4, 2), `compressed_psum`, `Locale.check`, planted faults for R1/R2,
a traced run and `make_rank_mesh`'s errors.  Each rank returns its rows
and collective log; the tests compare them here with the one-process
`HomeMesh` engine, `exchange_schedule`, `collective_census`, the
reference's R1/R2 rule functions and, through one subprocess with 8
emulated host devices (Auto axes), the JAX `shard_map` engine,
`compressed_psum` and `make_host_mesh`.  Tolerance: bit-exact (floats
compared as bit patterns), except `compressed_psum`'s sums, within 2
float32 ulps of the reference's.

The rank processes import this module, which imports torch, numpy and the
port only; JAX comes in inside the tests, and the workers assert that it
never reached them.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import CASES
from repro_torch.convert import make_sort_data
from repro_torch.core import (HomeMesh, Homing, Locale, LocalisationPolicy,
                              collective_census, exchange_schedule)
from repro_torch.core.engine import SCHEDULE_TO_HLO, engine_granule
from repro_torch.core.sort import pad_to_multiple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORRUPT = os.path.join(ROOT, "tests", "data", "corrupt_trace.jsonl")
N = (1 << 12) + 5
SEED = 19
WORLDS = (2, 4, 8)
PHASES = ("kernel", "reference")
POD_SHAPES = {"2x4": {"pod": 2, "data": 4}, "4x2": {"pod": 4, "data": 2}}
HIER = {"hier-hash": LocalisationPolicy.hierarchical(inner="hash"),
        "hier-local": LocalisationPolicy.hierarchical(inner="localised")}
PSUM_SHAPE = (63, 100)                 # per rank: 6300 elements, 25 blocks


def case_policy(k: int) -> LocalisationPolicy:
    c = CASES[k]
    return LocalisationPolicy(c.localised, c.static_mapping, Homing(c.homing))


def sort_input(dtype: str, seed: int) -> torch.Tensor:
    x = torch.from_numpy(make_sort_data(N, dtype, seed))
    return x.to(getattr(torch, dtype))


def nbits(t) -> np.ndarray:
    """Bit patterns of a result of any sort dtype (torch or numpy)."""
    a = np.ascontiguousarray(t.cpu().contiguous().view(
        {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])
        .numpy() if isinstance(t, torch.Tensor) else np.asarray(t))
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def tasks_for(world: int):
    """Every sort the world runs: (id, shape, axis, policy, dtype, phase,
    seed)."""
    flat = {"data": world}
    out = []
    for k in CASES:
        for dt in ("int32", "float32"):
            for ph in PHASES:
                out.append((f"case{k}-{dt}-{ph}", flat, "data",
                            case_policy(k), dt, ph, SEED + k))
        for dt in ("bfloat16", "uint32"):
            out.append((f"case{k}-{dt}-kernel", flat, "data",
                        case_policy(k), dt, "kernel", SEED + k))
    if world == 8:
        for ptag, shape in POD_SHAPES.items():
            for htag, pol in HIER.items():
                for dt in ("int32", "float32"):
                    for ph in PHASES:
                        out.append((f"{ptag}-{htag}-{dt}-{ph}", shape,
                                    ("pod", "data"), pol, dt, ph, SEED + 9))
    return out


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it by name)
# ---------------------------------------------------------------------------
def rank_battery(device, tasks, extras):
    assert "jax" not in sys.modules, "a rank process imported JAX"
    import torch.distributed as dist

    from repro_torch.core import collectives as coll
    from repro_torch.core.engine import gather_sorted
    from repro_torch.core.mesh import RankMesh

    meshes = {}

    def mesh_of(shape):
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = RankMesh(shape, device=device)
        return meshes[key]

    out = {"rank": dist.get_rank(), "sorts": {}}
    for tid, shape, axis, policy, dt, phase, seed in tasks:
        mesh = mesh_of(shape)
        fn = Locale(mesh, axis, policy).workload(
            "sort", backend="shard_map", local_phase=phase)
        shard = fn.place(sort_input(dt, seed))
        coll.reset_collectives()
        y = fn(shard)
        log = coll.collective_log()
        full = gather_sorted(y, mesh, N)
        out["sorts"][tid] = {"row": nbits(y.data), "full": nbits(full),
                             "homing": y.homing.value, "log": log,
                             "staged": coll.staged_bytes(),
                             "index": mesh.index(
                                 (axis,) if isinstance(axis, str) else axis)}
    if extras:
        out.update(rank_extras(device, mesh_of))
    assert "jax" not in sys.modules, "a rank process imported JAX"
    return out


def rank_extras(device, mesh_of):
    """The 8-rank world's other cases: compressed_psum, Locale.check,
    planted R1/R2 faults, a traced run, pin_tree without the slot count
    and make_rank_mesh's errors."""
    import torch.distributed as dist

    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import make_production_mesh, make_rank_mesh
    from repro_torch.obs.tracelog import Tracer, set_tracer
    from repro_torch.optim.compression import (compressed_psum,
                                               gather_quantized)

    rank = dist.get_rank()
    out = {}
    flat, pods = mesh_of({"data": 8}), mesh_of(POD_SHAPES["2x4"])
    # compressed_psum: rank r holds rows [r*63, (r+1)*63) of one array
    x = torch.from_numpy(psum_input())[rank * PSUM_SHAPE[0]:
                                       (rank + 1) * PSUM_SHAPE[0]]
    qg, sg = gather_quantized(x, flat, "data")
    coll.reset_collectives()
    total = compressed_psum(x, flat, "data")
    out["psum"] = {"q": qg.numpy(), "s": sg.numpy(), "sum": total.numpy(),
                   "log": coll.collective_log()}
    # Locale.check on the ranks: R1 and R2 read this rank's collectives
    out["check"] = {}
    for tag, mesh, axis, pol in (
            ("case7", flat, "data", case_policy(7)),
            ("case3", flat, "data", case_policy(3)),
            ("hier", pods, ("pod", "data"), HIER["hier-hash"])):
        rep = Locale(mesh, axis, pol).check("engine", logn=12)
        out["check"][tag] = {"clean": rep.clean, "notes": rep.notes,
                             "findings": [f.format() for f in rep.findings],
                             "collectives": rep.context["collectives"]}
    # planted: an extra all_gather after a clean sort; a sort over "data"
    # of the pod mesh, then a gather that spans the undeclared pod axis
    fn = Locale(flat, "data", case_policy(8)).workload(
        "sort", backend="shard_map")
    shard = fn.place(sort_input("int32", SEED))
    coll.reset_collectives()
    y = fn(shard)
    coll.all_gather(y.data[0], flat, "data")
    out["planted_extra"] = coll.collective_log()
    fn = Locale(pods, "data", case_policy(8)).workload(
        "sort", backend="shard_map")
    shard = fn.place(sort_input("int32", SEED))
    coll.reset_collectives()
    y = fn(shard)
    out["pod_data_clean"] = coll.collective_log()
    coll.all_gather(y.data[0], pods, ("pod", "data"))
    out["planted_leak"] = coll.collective_log()
    # the engine.sort trace: rank 0 emits it
    tr = Tracer(run="ranks")
    set_tracer(tr)
    try:
        for mesh, axis, pol, dt in (
                (flat, "data", case_policy(7), "int32"),
                (flat, "data", case_policy(2), "float32"),
                (pods, ("pod", "data"), HIER["hier-hash"], "bfloat16")):
            fn = Locale(mesh, axis, pol).workload("sort",
                                                  backend="shard_map")
            fn(fn.place(sort_input(dt, SEED)))
    finally:
        set_tracer(None)
    out["trace"] = tr.records()
    # placements: Locale.put and homed_from_reference give each rank its
    # shard (the reference's placed data: x, or its (n/N, N) stripe view)
    from repro_torch.convert import homed_from_reference
    x = np.arange(64, dtype=np.int32)
    out["placed"] = {}
    for tag, mesh, axis, homing in (
            ("chunked", flat, "data", Homing.LOCAL_CHUNKED),
            ("interleaved", flat, "data", Homing.HASH_INTERLEAVED),
            ("pods_interleaved", pods, ("pod", "data"),
             Homing.HASH_INTERLEAVED)):
        locale = Locale(mesh, axis, LocalisationPolicy(homing=homing))
        placed = x if homing == Homing.LOCAL_CHUNKED else x.reshape(8, 8)
        out["placed"][tag] = (
            homed_from_reference(placed, homing.value, locale).data.numpy(),
            locale.put(x).data.numpy())
    # the engine refuses a shard of another homing, or one not padded to
    # its granule (hash homing: 8 x 8 elements a granule)
    fn = Locale(flat, "data", case_policy(7)).workload("sort",
                                                       backend="shard_map")
    with pytest.raises(TypeError, match="Locale.put"):
        fn(Locale(flat, "data", case_policy(8)).put(np.arange(64)))
    with pytest.raises(TypeError, match="place the whole input"):
        fn(torch.arange(64))
    with pytest.raises(ValueError, match="granule 64"):
        fn(Locale(flat, "data", case_policy(7)).put(np.arange(8)))
    # pin_tree across ranks homes the slots' rows: it needs their count
    with pytest.raises(ValueError, match="size="):
        Locale(flat, "data", case_policy(8)).pin_tree({"x": torch.zeros(8)})
    # make_rank_mesh: its errors, and the meshes it builds
    errors = {}
    for tag, kw in MESH_ERRORS.items():
        with pytest.raises(ValueError) as e:
            make_rank_mesh(device=device, **kw)
        errors[tag] = str(e.value)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device=device)
    out["mesh_errors"] = errors
    out["meshes"] = [make_rank_mesh(device=device).shape,
                     make_rank_mesh(n_pods=2, device=device).shape]
    return out


#: make_host_mesh / make_rank_mesh arguments that must raise on 8
MESH_ERRORS = {"model3": {"n_model": 3}, "data2": {"n_data": 2},
               "pods3": {"n_pods": 3}, "zero": {"n_data": 0},
               "pods2data8": {"n_pods": 2, "n_data": 8}}


def psum_input() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((8 * PSUM_SHAPE[0], PSUM_SHAPE[1]))
    return (x * 3).astype(np.float32)


# ---------------------------------------------------------------------------
# the 8-device JAX reference, in one subprocess
# ---------------------------------------------------------------------------
JAX_8DEV = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import AxisType, PartitionSpec as P
from repro.core import Homing, Locale, LocalisationPolicy
from repro.configs.paper_sort import CASES
from repro.launch.mesh import make_host_mesh
from repro.optim.compression import compressed_psum, quantize

src, dst, errs = sys.argv[1], sys.argv[2], sys.argv[3]
inp = dict(np.load(src))
# Auto axes: jax.make_mesh's default Explicit axes reject the reference's
# in-jit reshapes of sharded values
flat = jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,))
pods = jax.make_mesh((2, 4), ("pod", "data"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
runs = {f"case{k}": (flat, "data", LocalisationPolicy(
    c.localised, c.static_mapping, Homing(c.homing)))
    for k, c in CASES.items()}
runs["hier-hash"] = (pods, ("pod", "data"),
                     LocalisationPolicy.hierarchical(inner="hash"))
runs["hier-local"] = (pods, ("pod", "data"),
                      LocalisationPolicy.hierarchical(inner="localised"))
for tag, (mesh, axis, pol) in runs.items():
    fn = Locale(mesh, axis, pol).workload("sort", backend="shard_map",
                                          local_phase="pallas")
    for dt in ("int32", "float32"):
        out[f"{tag}-{dt}"] = np.asarray(fn(jnp.asarray(inp[f"{tag}-{dt}"])))

def body(x):
    q, s = quantize(x)
    return (jax.lax.all_gather(q, "data"), jax.lax.all_gather(s, "data"),
            compressed_psum(x, "data"))

q, s, total = jax.jit(shard_map(body, mesh=flat, in_specs=P("data"),
                                out_specs=(P(), P(), P()),
                                check_rep=False))(jnp.asarray(inp["psum"]))
out["psum_q"], out["psum_s"], out["psum_sum"] = map(np.asarray, (q, s, total))
# quantize run eagerly on each shard: under jit XLA turns the division by
# 127 into a product with its reciprocal, 1 ulp off in some scales
eager = [quantize(jnp.asarray(part)) for part in np.split(inp["psum"], 8)]
out["psum_q_eager"] = np.stack([np.asarray(e[0]) for e in eager])
out["psum_s_eager"] = np.stack([np.asarray(e[1]) for e in eager])
deq = out["psum_q_eager"].astype(np.float32) * out["psum_s_eager"][..., None]
out["psum_sum_eager"] = np.asarray(jnp.sum(jnp.asarray(deq), axis=0)).reshape(
    -1)[:inp["psum"].size // 8].reshape(inp["psum"].shape[0] // 8, -1)
out["psum_abs_terms"] = np.abs(deq).sum(0).reshape(-1)[
    :inp["psum"].size // 8].reshape(inp["psum"].shape[0] // 8, -1)
# each device's shard of a placement, in mesh (pod-major) order
for tag, (mesh, axis, h) in {
        "chunked": (flat, "data", Homing.LOCAL_CHUNKED),
        "interleaved": (flat, "data", Homing.HASH_INTERLEAVED),
        "pods_interleaved": (pods, ("pod", "data"), Homing.HASH_INTERLEAVED),
        }.items():
    homed = Locale(mesh, axis, LocalisationPolicy(homing=h)).put(
        jnp.arange(64, dtype=jnp.int32))
    order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    shards = sorted(homed.data.addressable_shards,
                    key=lambda s: order[s.device])
    out[f"shards_{tag}"] = np.stack([np.asarray(s.data).reshape(-1)
                                     for s in shards])
np.savez(dst, **out)
messages = {}
for tag, kw in eval(errs).items():
    try:
        make_host_mesh(**kw)
        messages[tag] = None
    except ValueError as e:
        messages[tag] = str(e)
print("MESH_ERRORS " + repr(messages))
print("JAX_8DEV_OK")
"""


def ref_inputs() -> dict:
    inp = {"psum": psum_input()}
    for k in CASES:
        for dt in ("int32", "float32"):
            inp[f"case{k}-{dt}"] = make_sort_data(N, dt, SEED + k)
    for htag in HIER:
        for dt in ("int32", "float32"):
            inp[f"{htag}-{dt}"] = make_sort_data(N, dt, SEED + 9)
    return inp


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX subprocess, started before the rank worlds so that the two
    overlap; `jax_ref` waits for it."""
    d = tmp_path_factory.mktemp("jax8")
    src, dst = d / "in.npz", d / "out.npz"
    np.savez(src, **ref_inputs())
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_8DEV, str(src), str(dst),
         repr(MESH_ERRORS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"})
    yield proc, dst
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    proc, dst = jax_proc
    stdout, stderr = proc.communicate(timeout=600)
    assert "JAX_8DEV_OK" in stdout, stdout + stderr
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("MESH_ERRORS "))
    return dict(np.load(dst)), eval(line[len("MESH_ERRORS "):])


@pytest.fixture(scope="module")
def worlds(jax_proc):
    """{world size: [each rank's results]}: one spawn per world size."""
    from repro_torch.launch.mesh import spawn
    return {w: spawn(rank_battery, w, "gloo", "cpu", tasks_for(w), w == 8)
            for w in WORLDS}


def home_rows(task) -> tuple:
    """The one-process HomeMesh engine on the task's input: its logical
    result and its padded per-home rows in the output homing."""
    tid, shape, axis, policy, dt, phase, seed = task
    x = sort_input(dt, seed)
    fn = Locale(HomeMesh(shape, device="cpu"), axis, policy).workload(
        "sort", backend="shard_map", local_phase=phase)
    y = fn(x)
    m = int(np.prod(list(shape.values())))
    granule = engine_granule(m, None, policy.homing == Homing.HASH_INTERLEAVED)
    n_p = -(-N // granule) * granule
    out_homing = Homing.LOCAL_CHUNKED if policy.localised else policy.homing
    padded = pad_to_multiple(y, n_p, nan_check=False)
    if out_homing == Homing.LOCAL_CHUNKED:
        rows = padded.view(m, -1)
    else:
        rows = padded.view(-1, m).t()
    return y, rows, out_homing


# ---------------------------------------------------------------------------
# the engine across ranks against the one-process engine
# ---------------------------------------------------------------------------
def check_world(worlds, world, select):
    ranks = worlds[world]
    tasks = [t for t in tasks_for(world) if select(t[0])]
    assert tasks
    for task in tasks:
        y, rows, out_homing = home_rows(task)
        for r, res in enumerate(ranks):
            got = res["sorts"][task[0]]
            assert got["homing"] == out_homing.value, task[0]
            np.testing.assert_array_equal(
                got["row"][0], nbits(rows[got["index"]]),
                err_msg=f"{task[0]} rank {r}: row differs")
            np.testing.assert_array_equal(
                got["full"], nbits(y), err_msg=f"{task[0]} rank {r}")


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_engine_matches_home_mesh(worlds, world, phase, dtype):
    check_world(worlds, world,
                lambda tid: tid.startswith("case")
                and tid.endswith(f"-{dtype}-{phase}"))


@pytest.mark.parametrize("dtype", ["bfloat16", "uint32"])
@pytest.mark.parametrize("world", WORLDS)
def test_rank_engine_narrow_dtypes_match_home_mesh(worlds, world, dtype):
    check_world(worlds, world, lambda tid: f"-{dtype}-" in tid)


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("pods", sorted(POD_SHAPES))
def test_rank_engine_hierarchical_matches_home_mesh(worlds, pods, phase):
    check_world(worlds, 8, lambda tid: tid.startswith(pods)
                and tid.endswith(phase))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("tag", [f"case{k}" for k in CASES] + sorted(HIER))
def test_rank_engine_matches_jax_8dev_engine(worlds, jax_ref, tag, dtype):
    ref, _ = jax_ref
    prefix = f"2x4-{tag}" if tag in HIER else tag
    tid = f"{prefix}-{dtype}-kernel"
    want = nbits(ref[f"{tag}-{dtype}"])
    for r, res in enumerate(worlds[8]):
        np.testing.assert_array_equal(res["sorts"][tid]["full"], want,
                                      err_msg=f"{tid} rank {r}")
    x = make_sort_data(N, dtype, SEED + (9 if tag in HIER else int(tag[4:])))
    assert (ref[f"{tag}-{dtype}"] == np.sort(x)).all()


# ---------------------------------------------------------------------------
# the collective log against the schedule, the census and the rules
# ---------------------------------------------------------------------------
def task_sizes(task):
    axis = task[2]
    return tuple(task[1][a] for a in ((axis,) if isinstance(axis, str)
                                      else axis))


@pytest.mark.parametrize("world", WORLDS)
def test_rank_logs_equal_schedule_and_census(worlds, world):
    from repro_torch.core.collectives import census, log_against_schedule
    for task in tasks_for(world):
        tid, shape, axis, policy, dt, phase, seed = task
        sizes = task_sizes(task)
        m = int(np.prod(sizes))
        itemsize = torch.empty(0, dtype=getattr(torch, dt)).element_size()
        sched = exchange_schedule(N, sizes, policy, itemsize=itemsize,
                                  local_phase=phase)
        budget = collective_census(N, sizes, policy, itemsize=itemsize,
                                   local_phase=phase)
        for r, res in enumerate(worlds[world]):
            log = res["sorts"][tid]["log"]
            assert log_against_schedule(log, sched, m) == [], (tid, r)
            assert census(log) == budget, (tid, r)
            assert res["sorts"][tid]["staged"] == 0   # CPU tensors: none
            kinds = {rec["kind"] for rec in log}
            assert kinds <= set(SCHEDULE_TO_HLO.values())


def findings(report) -> list:
    return [(f.rule, f.severity.name, f.op, f.predicted_bytes,
             f.actual_bytes, f.message) for f in report.findings]


def both_rules(log, predicted, shape, allowed):
    """The port's R1/R2 and the reference's own on the same records."""
    from repro.analysis.findings import Report as RefReport
    from repro.analysis.rules import r1_surprise_collective as ref_r1
    from repro.analysis.rules import r2_home_leak as ref_r2
    from repro_torch.analysis.findings import Report
    from repro_torch.analysis.rules import r1_surprise_collective, r2_home_leak
    mine, ref = Report("ranks"), RefReport("ranks")
    r1_surprise_collective(mine, log, predicted)
    ref_r1(ref, log, predicted)
    r2_home_leak(mine, log, tuple(shape), tuple(shape.values()), allowed)
    ref_r2(ref, log, tuple(shape), tuple(shape.values()), allowed)
    assert findings(mine) == findings(ref)
    return mine


def test_r1_r2_clean_on_every_sort_and_equal_to_reference(worlds):
    for world in WORLDS:
        for task in tasks_for(world):
            tid, shape, axis, policy, dt, phase, _ = task
            itemsize = torch.empty(0, dtype=getattr(torch, dt)).element_size()
            budget = collective_census(N, task_sizes(task), policy,
                                       itemsize=itemsize, local_phase=phase)
            allowed = (axis,) if isinstance(axis, str) else axis
            for res in worlds[world]:
                rep = both_rules(res["sorts"][tid]["log"], budget, shape,
                                 allowed)
                assert rep.clean and not rep.findings, (tid, rep.format())


def test_r1_flags_a_planted_all_gather(worlds):
    budget = collective_census(N, (8,), case_policy(8))
    for res in worlds[8]:
        rep = both_rules(res["planted_extra"], budget, {"data": 8},
                         ("data",))
        assert [(f.rule, f.severity.name, f.op) for f in rep.findings] == \
            [("R1", "ERROR", "all-gather")]


def test_r2_flags_a_group_across_an_undeclared_axis(worlds):
    budget = collective_census(N, (4,), case_policy(8))
    shape = POD_SHAPES["2x4"]
    for res in worlds[8]:
        clean = both_rules(res["pod_data_clean"], budget, shape, ("data",))
        assert not clean.findings
        rep = both_rules(res["planted_leak"], budget, shape, ("data",))
        assert sorted((f.rule, f.severity.name) for f in rep.findings) == \
            [("R1", "ERROR"), ("R2", "ERROR")]
        assert "['pod']" in next(f.message for f in rep.findings
                                 if f.rule == "R2")


def test_locale_check_runs_r1_r2_on_ranks(worlds):
    for res in worlds[8]:
        for tag, rep in res["check"].items():
            assert rep["clean"], (tag, rep["findings"])
            assert rep["collectives"] > 0
            skipped = {n.split()[0] for n in rep["notes"] if "skipped" in n}
            assert not skipped & {"R1", "R2"}, rep["notes"]
            assert {"R4", "R9", "R10", "R11"} <= skipped


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------
def ulps(a, b) -> np.ndarray:
    return np.abs(a - b) / np.spacing(np.abs(b))


def test_compressed_psum_matches_reference(worlds, jax_ref):
    """The int8 payload is bit for bit the reference's under shard_map.
    The scales are bit for bit its `quantize` run eagerly, and within 1
    ulp of its jitted one (XLA multiplies by 1/127 where the code
    divides by 127).  The sums are within 2 ulps of the reference's
    dequantise-and-sum of the eager payload, and within 8 float32 epsilons
    of the summed magnitudes of the jitted reference's (a 1-ulp scale
    moves each term by at most one epsilon of it, and each of the two
    sums of 8 terms rounds by at most 7/2 epsilons of them)."""
    ref, _ = jax_ref
    for res in worlds[8]:
        p = res["psum"]
        np.testing.assert_array_equal(p["q"], ref["psum_q"])
        np.testing.assert_array_equal(p["q"], ref["psum_q_eager"])
        np.testing.assert_array_equal(p["s"].view(np.int32),
                                      ref["psum_s_eager"].view(np.int32))
        assert ulps(p["s"], ref["psum_s"]).max() <= 1
        want = ref["psum_sum_eager"]
        assert p["sum"].shape == want.shape == ref["psum_sum"].shape \
            == PSUM_SHAPE
        assert ulps(p["sum"], want).max() <= 2, ulps(p["sum"], want).max()
        eps = np.finfo(np.float32).eps
        assert (np.abs(p["sum"] - ref["psum_sum"])
                <= 8 * eps * ref["psum_abs_terms"]).all()


def test_compressed_psum_wire_is_int8(worlds):
    blocks = -(-PSUM_SHAPE[0] * PSUM_SHAPE[1] // 256)
    for res in worlds[8]:
        log = res["psum"]["log"]
        assert [r["kind"] for r in log] == ["all-gather", "all-gather"]
        # 1 byte a padded element to each of the 7 others, then the scales
        assert [r["wire_bytes"] for r in log] == [7 * blocks * 256,
                                                  7 * blocks * 4]


# ---------------------------------------------------------------------------
# the engine.sort trace
# ---------------------------------------------------------------------------
def test_engine_trace_reconciles(worlds):
    from repro_torch.obs.reconcile import reconcile
    traces = [res["trace"] for res in worlds[8]]
    assert all(r["name"] == "trace.meta" for t in traces[1:]
               for r in t)                          # rank 0 alone emits
    records = json.loads(json.dumps(traces[0]))    # as a JSONL file holds it
    rep = reconcile(records)
    assert rep["engine_sorts"] == 3 and "I-engine" in rep["checks"]
    sorts = [r for r in records if r["name"] == "engine.sort"]
    # each call sorts the placed shards: N padded to the engine's granule
    padded = [-(-N // g) * g for g in (engine_granule(8, None, True),
                                       engine_granule(8, None, False),
                                       engine_granule(8, None, True))]
    assert [s["args"]["n"] for s in sorts] == padded
    assert [s["args"]["itemsize"] for s in sorts] == [4, 4, 2]


def test_reconcile_rejects_corrupt_traces(worlds):
    from repro_torch.obs.reconcile import ReconcileError, reconcile
    from repro_torch.obs.tracelog import read_jsonl
    with pytest.raises(ReconcileError, match="I-bytes"):
        reconcile(read_jsonl(CORRUPT))
    records = json.loads(json.dumps(worlds[8][0]["trace"]))
    level = next(r for r in records if r["name"] == "engine.exchange_level"
                 and r["args"]["op"] == "all_to_all")
    level["args"]["intra_pod_bytes"] += 4
    with pytest.raises(ReconcileError, match="I-engine"):
        reconcile(records)


def test_reconcile_is_a_copy_of_the_reference():
    def body(pkg):
        text = open(os.path.join(ROOT, "src", pkg, "obs",
                                 "reconcile.py")).read()
        text = text.replace(pkg + ".", "PKG.")
        return text[text.index("from __future__"):]
    assert body("repro") == body("repro_torch")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_make_rank_mesh_errors_match_make_host_mesh(worlds, jax_ref):
    _, ref_messages = jax_ref
    for res in worlds[8]:
        for tag, msg in res["mesh_errors"].items():
            want = ref_messages[tag]
            assert want is not None, tag
            want = (want.replace("host device(s)", "rank(s)")
                    .replace("device(s) but this host has",
                             "rank(s) but the world has")
                    .replace("the device count", "the world size")
                    .replace("available devices", "available ranks"))
            assert msg == want, tag
        assert res["meshes"] == [{"data": 8, "model": 1},
                                 {"pod": 2, "data": 4, "model": 1}]


@pytest.mark.parametrize("tag", ["chunked", "interleaved",
                                 "pods_interleaved"])
def test_rank_placement_is_the_device_shard(worlds, jax_ref, tag):
    ref, _ = jax_ref
    for r, res in enumerate(worlds[8]):
        converted, put = res["placed"][tag]
        np.testing.assert_array_equal(converted[0], ref[f"shards_{tag}"][r])
        np.testing.assert_array_equal(put[0], ref[f"shards_{tag}"][r])


def test_home_mesh_engine_trace_reconciles():
    from repro_torch.obs.reconcile import reconcile
    from repro_torch.obs.tracelog import Tracer, set_tracer
    tr = Tracer(run="home")
    set_tracer(tr)
    try:
        for shape, axis, pol in (({"data": 8}, "data", case_policy(3)),
                                 (POD_SHAPES["4x2"], ("pod", "data"),
                                  HIER["hier-local"])):
            Locale(HomeMesh(shape, device="cpu"), axis, pol).workload(
                "sort", backend="shard_map", local_phase="reference")(
                    sort_input("float32", SEED))
    finally:
        set_tracer(None)
    rep = reconcile(json.loads(json.dumps(tr.records())))
    assert rep["engine_sorts"] == 2


def test_rank_mesh_needs_a_world():
    from repro_torch.core.mesh import RankMesh
    with pytest.raises(RuntimeError, match="init_process_group|spawn"):
        RankMesh({"data": 2}, device="cpu")


def test_rank_rows_are_the_home_mesh_rows(worlds):
    """Each rank placed row d of `to_layout` on a HomeMesh, d its index."""
    for world in WORLDS:
        for r, res in enumerate(worlds[world]):
            assert res["rank"] == r
            assert all(s["index"] == r for s in res["sorts"].values())


def test_engine_source_is_jax_free():
    pat = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)", re.M)
    for rel in ("core/mesh.py", "core/collectives.py", "core/engine.py",
                "launch/mesh.py", "launch/sort.py", "obs/reconcile.py",
                "optim/compression.py", "analysis/rules.py"):
        text = open(os.path.join(ROOT, "src", "repro_torch", rel)).read()
        assert not pat.search(text), rel
