"""The constraint tree, the Fig-1 microbench and `Locale`'s relayout
methods across torch.distributed ranks, held to the one-process port and
to the JAX reference, bit for bit.

One gloo world of 2, 4 and 8 processes each (`launch.mesh.spawn`, on the
CPU: the kernels' plain versions) runs every case of this file in one
spawn per world size: the default ``workload("sort")`` for the 8 Table-1
cases in int32, float32 and bfloat16 with ``num_workers`` N and 2N, on
``{"data": w}`` and (8 ranks) on ``{"pod": 2, "data": 4}``; the
``"microbench"`` workload under the localised, static non-localised and
auto policies; `Locale.pin_tree` (every world); and (8 ranks)
`Locale.pin`, `localise`, `make`, `check` and a planted cross-axis move.  Each rank returns
its elements, their layout and its collective log; the tests compare
them here with the one-process `HomeMesh` port, `constraint_schedule`,
`relayout_counts` and, through one subprocess with 8 emulated host
devices on meshes with Auto axes, the JAX constraint sort; the
microbench with the mesh-less JAX one.  Tolerance: bit-exact (floats as
bit patterns), except the reference's fault on the 8-device meshes, where
its localised static policies (cases 7 and 8) return every zero as +0.0:
there the values equal under ``==``, and the bits equal the mesh-less
reference's (`tests/test_torch_constraint.py` pins the same).

The rank processes import this module, which imports torch, numpy and the
port only; JAX comes in inside the tests, and the workers assert that it
never reached them.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import CASES
from repro_torch.convert import make_fig1_data, make_sort_data
from repro_torch.core import HomeMesh, Homing, Locale, LocalisationPolicy
from repro_torch.core.homing import (Layout, home_of, moved_elems, positions,
                                     relayout_counts, reset_relayouts,
                                     send_counts, shares)
from repro_torch.core.sort import (constraint_schedule, pad_to_multiple,
                                   rank_granule)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3001
SEED = 31
WORLDS = (2, 4, 8)
DTYPES = ("int32", "float32", "bfloat16")
PODS = ({"pod": 2, "data": 4}, ("pod", "data"))
FIG1_N = 4096
FIG1_REPS = (1, 3)
#: the three policies of Fig 1: localised static chunked, non-localised
#: static hash, and the auto baseline
FIG1 = {"localised": (True, True, "local"),
        "nonlocalised": (False, True, "hash"),
        "auto": (False, False, "hash")}


def case_policy(k: int) -> LocalisationPolicy:
    c = CASES[k]
    return LocalisationPolicy(c.localised, c.static_mapping, Homing(c.homing))


def sort_input(dtype: str, seed: int) -> torch.Tensor:
    """`make_sort_data`, and for float32 a run of zeros of both signs in
    the first leaf."""
    x = make_sort_data(N, dtype, seed)
    if dtype == "float32":
        x[5:45] = np.where(np.arange(40) % 3 == 0, -0.0, 0.0)
    return torch.from_numpy(x).to(getattr(torch, dtype))


def nbits(t) -> np.ndarray:
    """Bit patterns of a result of any sort dtype (torch or numpy)."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().contiguous()
        return t.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[t.element_size()]).numpy()
    a = np.ascontiguousarray(np.asarray(t))
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def meshes_for(world: int) -> dict:
    out = {"flat": ({"data": world}, "data")}
    if world == 8:
        out["pods"] = PODS
    return out


def tasks_for(world: int):
    """Every sort the world runs: (mesh tag, case, dtype, num_workers)."""
    return [(tag, k, dt, nw) for tag in meshes_for(world) for k in CASES
            for dt in DTYPES for nw in (None, 2 * world)]


# ---------------------------------------------------------------------------
# what every rank runs (module level: the spawned ranks import it by name)
# ---------------------------------------------------------------------------
def rank_battery(device, world):
    assert "jax" not in sys.modules, "a rank process imported JAX"
    import torch.distributed as dist

    from repro_torch.core import collectives as coll
    from repro_torch.core.homing import axis_tuple
    from repro_torch.core.mesh import RankMesh
    from repro_torch.core.sort import gather_sorted

    meshes = {tag: (RankMesh(shape, device=device), axis)
              for tag, (shape, axis) in meshes_for(world).items()}
    out = {"rank": dist.get_rank(), "sorts": {}, "fig1": {}}
    for task in tasks_for(world):
        tag, k, dt, nw = task
        mesh, axis = meshes[tag]
        fn = Locale(mesh, axis, case_policy(k)).workload("sort",
                                                         num_workers=nw)
        share = fn.place(sort_input(dt, SEED + k))
        coll.reset_collectives()
        reset_relayouts()
        y = fn(share)
        log, moved = coll.collective_log(), relayout_counts()
        out["sorts"][task] = {
            "row": nbits(y.data), "layout": y.layout, "n": y.n,
            "index": mesh.index(axis_tuple(axis)), "log": log,
            "relayouts": moved, "staged": coll.staged_bytes(),
            "full": nbits(gather_sorted(y, mesh, N))}
    flat = meshes["flat"][0]
    for name, (loc, static, h) in FIG1.items():
        for reps in FIG1_REPS:
            fn = Locale(flat, "data", LocalisationPolicy(
                loc, static, Homing(h))).workload("microbench", reps=reps)
            chunk = fn.place(torch.from_numpy(make_fig1_data(FIG1_N,
                                                             "float32", 5)))
            coll.reset_collectives()
            reset_relayouts()
            y = fn(chunk)
            out["fig1"][name, reps] = {
                "chunk": y.numpy(), "log": coll.collective_log(),
                "relayouts": relayout_counts()}
    out["pin_tree"] = {tag: rank_pin_tree(mesh, axis)
                       for tag, (mesh, axis) in meshes.items()}
    if world == 8:
        out.update(rank_extras(device, flat, meshes["pods"][0]))
    assert "jax" not in sys.modules, "a rank process imported JAX"
    return out


def pin_tree_input(world: int) -> dict:
    """A cache-like tree: (layers, slots, ...) leaves of 4 slots a home,
    and a leaf whose dim 1 is not the slots."""
    S = 4 * world
    return {"k": torch.arange(2 * S * 3, dtype=torch.float32).view(2, S, 3),
            "kpos": torch.arange(2 * S, dtype=torch.int32).view(2, S),
            "other": torch.zeros(2, 5)}


def rank_pin_tree(mesh, axis):
    """`Locale.pin_tree` on a `RankMesh`: the whole tree pinned (each rank
    keeps its home's rows), then pinned again (steady state), with the
    collectives each made."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.mesh import axis_tuple
    locale = Locale(mesh, axis)
    whole = pin_tree_input(mesh.size)
    S = whole["k"].shape[1]
    coll.reset_collectives()
    mine = locale.pin_tree(whole, dim=1, size=S)
    first = coll.collective_log()
    again = locale.pin_tree(mine, dim=1, size=S)
    with pytest.raises(ValueError) as e:
        locale.pin_tree(whole, dim=1)
    return {"home": mesh.index(axis_tuple(axis)), "refusal": str(e.value),
            "rows": {k: v.numpy() for k, v in mine.items()},
            "same": all(again[k] is mine[k] for k in mine),
            "other_kept": mine["other"] is whole["other"],
            "log": first + coll.collective_log()}


def rank_extras(device, flat, pods):
    """The 8-rank world's other cases: `Locale.pin`, `localise`, `make`
    and `check`, and a planted cross-axis move."""
    from repro_torch.analysis import check_artifacts
    from repro_torch.core import collectives as coll
    from repro_torch.core.homing import Layout, relayout

    out = {"pin": {}, "check": {}}
    x = torch.arange(64, dtype=torch.int32)
    for k in (3, 4, 7, 8):
        locale = Locale(flat, "data", case_policy(k))
        h = locale.put(x)
        chunk = x[flat.rank * 8:(flat.rank + 1) * 8]
        coll.reset_collectives()
        pinned, homed = locale.pin(chunk), locale.pin(h)
        out["pin"][k] = {"raw": pinned.numpy(),
                         "homed": (homed.data.numpy(), homed.homing.value,
                                   homed is h),
                         "localised": locale.localise(h).data.numpy(),
                         "log": [r["kind"] for r in coll.collective_log()]}
    calls = []

    def cb(index):
        calls.append(index)
        return np.arange(32 * 3).reshape(32, 3)[index]

    out["make"] = (Locale(flat, "data").make((32, 3), cb).numpy(),
                   [c[0] for c in calls])
    with pytest.raises(ValueError, match="pad"):
        Locale(flat, "data").make((30, 3), cb)
    for tag, mesh, axis, workload, pol in (
            ("sort-case3", flat, "data", "sort", case_policy(3)),
            ("sort-case8-pods", pods, ("pod", "data"), "sort",
             case_policy(8)),
            ("sort-case4-data", pods, "data", "sort", case_policy(4)),
            ("microbench", flat, "data", "microbench", case_policy(3))):
        rep = Locale(mesh, axis, pol).check(workload, logn=10, reps=2)
        out["check"][tag] = {"clean": rep.clean, "notes": rep.notes,
                             "findings": [f.format() for f in rep.findings],
                             "collectives": rep.context["collectives"]}
    # planted: a sort over "data" of the pod mesh, then a relayout whose
    # all-to-all spans the undeclared pod axis
    fn = Locale(pods, "data", case_policy(3)).workload("sort")
    share = fn.place(sort_input("int32", SEED))
    coll.reset_collectives()
    fn(share)
    clean = coll.collective_log()
    relayout(share[:64], pods, Layout("interleaved", 8),
             axis=("pod", "data"))
    leak = coll.collective_log()
    out["planted"] = {
        tag: [f.format() for f in check_artifacts(
            "ranks", [], collectives=log, mesh=pods, allowed_axes=("data",),
            rules=("R2",)).findings]
        for tag, log in (("clean", clean), ("leak", leak))}
    return out


# ---------------------------------------------------------------------------
# the 8-device JAX constraint sort, in one subprocess
# ---------------------------------------------------------------------------
JAX_8DEV = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core import Homing, Locale, LocalisationPolicy
from repro.configs.paper_sort import CASES

src, dst = sys.argv[1], sys.argv[2]
inp = dict(np.load(src))
# Auto axes: jax.make_mesh's default Explicit axes reject the reference's
# sharding constraints
meshes = {"flat": (jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,)),
                   "data"),
          "pods": (jax.make_mesh((2, 4), ("pod", "data"),
                                 axis_types=(AxisType.Auto,) * 2),
                   ("pod", "data"))}
out = {}
for k, c in CASES.items():
    pol = LocalisationPolicy(c.localised, c.static_mapping, Homing(c.homing))
    for tag, (mesh, axis) in list(meshes.items()) + [("meshless", (None,
                                                                   "data"))]:
        fn = Locale(mesh, axis, pol).workload("sort")
        for dt in ("int32", "float32"):
            x = jnp.asarray(inp[f"{dt}_{k}"])
            out[f"{tag}_{k}_{dt}"] = np.asarray(fn(x))
        # bfloat16 goes in and out as its int16 bit patterns
        bf = jnp.asarray(inp[f"bfloat16_{k}"]).view(jnp.bfloat16)
        out[f"{tag}_{k}_bfloat16"] = np.asarray(fn(bf)).view(np.int16)
np.savez(dst, **out)
print("JAX_8DEV_OK")
"""


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX subprocess, started before the rank worlds so that the two
    overlap; `jax_ref` waits for it."""
    d = tmp_path_factory.mktemp("jax8rc")
    src, dst = d / "in.npz", d / "out.npz"
    np.savez(src, **{f"{dt}_{k}": nbits(sort_input(dt, SEED + k))
                     if dt == "bfloat16" else sort_input(dt, SEED + k).numpy()
                     for k in CASES for dt in DTYPES})
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_8DEV, str(src), str(dst)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src"})
    yield proc, dst
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    proc, dst = jax_proc
    stdout, stderr = proc.communicate(timeout=600)
    assert "JAX_8DEV_OK" in stdout, stdout + stderr
    return dict(np.load(dst))


@pytest.fixture(scope="module")
def worlds(jax_proc):
    """{world size: [each rank's results]}: one spawn per world size."""
    from repro_torch.launch.mesh import spawn
    return {w: spawn(rank_battery, w, "gloo", "cpu", w) for w in WORLDS}


def home_sorted(task, world) -> torch.Tensor:
    """The one-process HomeMesh constraint sort of the task's input,
    padded to the tree's granule (the padded array the ranks hold)."""
    tag, k, dt, nw = task
    shape, axis = meshes_for(world)[tag]
    y = Locale(HomeMesh(shape, device="cpu"), axis, case_policy(k)).workload(
        "sort", num_workers=nw)(sort_input(dt, SEED + k))
    m = int(np.prod([shape[a] for a in ((axis,) if isinstance(axis, str)
                                        else axis)]))
    n_p = -(-N // rank_granule(m, case_policy(k), nw)) * rank_granule(
        m, case_policy(k), nw)
    return pad_to_multiple(y, n_p, nan_check=False)


# ---------------------------------------------------------------------------
# the tree across ranks against the one-process tree and the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world,tag", [(2, "flat"), (4, "flat"), (8, "flat"),
                                       (8, "pods")])
def test_rank_constraint_sort_matches_home_mesh(worlds, world, tag, dtype):
    """Every rank holds exactly the one-process tree's elements that the
    final layout puts on its home, in flat order, and gathers the same
    sorted array."""
    for task in tasks_for(world):
        if task[0] != tag or task[2] != dtype:
            continue
        want = home_sorted(task, world)
        for r, res in enumerate(worlds[world]):
            got = res["sorts"][task]
            assert got["n"] == want.numel()
            idx = positions(got["n"], got["layout"], got["index"])
            np.testing.assert_array_equal(
                got["row"], nbits(want[idx]), err_msg=f"{task} rank {r}")
            np.testing.assert_array_equal(
                got["full"], nbits(want[:N]), err_msg=f"{task} rank {r}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tag", ["flat", "pods"])
def test_rank_constraint_sort_matches_jax_8dev(worlds, jax_ref, tag, case):
    localised_static = CASES[case].localised and CASES[case].static_mapping
    for dt in DTYPES:
        want = nbits(jax_ref[f"{tag}_{case}_{dt}"])
        meshless = nbits(jax_ref[f"meshless_{case}_{dt}"])
        for r, res in enumerate(worlds[8]):
            got = res["sorts"][tag, case, dt, None]["full"]
            np.testing.assert_array_equal(got, meshless,
                                          err_msg=f"{dt} rank {r}")
            if dt != "int32" and localised_static:
                # the reference's fault: every zero comes back as +0.0
                vals, ref = (torch.from_numpy(a).view(getattr(torch, dt))
                             .float().numpy() for a in (got, want))
                np.testing.assert_array_equal(vals, ref)      # under ==
                assert (vals[got != want] == 0).all()
                assert not np.signbit(ref[ref == 0]).any()
                if dt == "float32":                 # sort_input's -0.0s
                    assert (got != want).any()
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{dt} rank {r}")


# ---------------------------------------------------------------------------
# the moves: each rank's log against the schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_rank_logs_equal_constraint_schedule(worlds, world):
    """Each rank's collectives equal `constraint_schedule` op for op (kind,
    wire, inter- and intra-pod bytes of its row), and its relayout counts
    add what it sent: summed over the ranks, the schedule's moved
    elements."""
    from repro_torch.core.collectives import log_against_moves
    for task in tasks_for(world):
        tag, k, dt, nw = task
        shape, axis = meshes_for(world)[tag]
        sizes = tuple(shape[a] for a in ((axis,) if isinstance(axis, str)
                                         else axis))
        itemsize = torch.empty(0, dtype=getattr(torch, dt)).element_size()
        sched = constraint_schedule(N, sizes, case_policy(k),
                                    num_workers=nw, itemsize=itemsize)
        moved = sum(int(s["send_counts"].sum() - np.trace(s["send_counts"]))
                    for s in sched)
        ranks = worlds[world]
        for r, res in enumerate(ranks):
            got = res["sorts"][task]
            assert log_against_moves(got["log"], sched, got["index"],
                                     sizes) == [], (task, r)
            assert got["staged"] == 0               # CPU tensors: none
            assert got["relayouts"]["relayouts"] == len(sched), (task, r)
        assert sum(res["sorts"][task]["relayouts"]["elems"]
                   for res in ranks) == moved, task
        assert sum(res["sorts"][task]["relayouts"]["bytes"]
                   for res in ranks) == moved * itemsize, task
        if not case_policy(k).static_mapping:
            assert {s["move"] for s in sched} <= {"merge"}, task


#: the moves at N = 8, m = 8 summed over the ranks, in multiples of n:
#: (relayout, merge)
MOVES_AT_8 = {8: (2.625, 2.25), 7: (2.625, 2.25), 3: (4.375, 3.5),
              4: (7.0, 0.0), 1: (0.0, 1.5), 2: (0.0, 1.5), 5: (0.0, 1.5),
              6: (0.0, 1.5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_constraint_schedule_at_8_homes(case):
    """The moves of the tree at N = 8 and n = 100 M int32 (the paper's
    Fig-2 size): relayout and merge elements in multiples of n, and case
    4 as its one all-gather."""
    n = 100_000_000
    sched = constraint_schedule(n, (8,), case_policy(case))
    got = {"relayout": 0, "merge": 0}
    for s in sched:
        got[s["move"]] += int(s["send_counts"].sum()
                              - np.trace(s["send_counts"]))
    assert (got["relayout"] / n, got["merge"] / n) == MOVES_AT_8[case]
    total = 4 * (got["relayout"] + got["merge"])
    assert total == {8: 1_950_000_000, 7: 1_950_000_000, 3: 3_150_000_000,
                     4: 2_800_000_000}.get(case, 600_000_000)
    if case == 4:
        assert [s["collective"] for s in sched] == ["all-gather"]
    assert all(s["collective"] == "all-to-all" for s in sched
               if s["dst"].kind != "replicated")


def test_send_counts_against_moved_elems_for_every_pair_of_kinds():
    """`send_counts` against a brute-force count of each element's old
    and new home, and its off-diagonal sum against `moved_elems`, for
    every pair of layout kinds (replicated included)."""
    n, H = 192, 4
    lays = ([Layout("chunked", H), Layout("interleaved", H)]
            + [Layout("runs", H, r) for r in (1, 2, 4, 8)]
            + [Layout("leaders", H, r) for r in (1, 2, 4, 8, 16)])
    idx = torch.arange(n)
    for a in lays:
        ha = home_of(idx, n, a).numpy()
        assert shares(n, a).tolist() == np.bincount(ha, minlength=H).tolist()
        for d in range(H):
            np.testing.assert_array_equal(positions(n, a, d).numpy(),
                                          np.nonzero(ha == d)[0])
        for b in lays:
            brute = np.zeros((H, H), np.int64)
            np.add.at(brute, (ha, home_of(idx, n, b).numpy()), 1)
            counts = send_counts(n, a, b)
            np.testing.assert_array_equal(counts, brute, err_msg=f"{a} {b}")
            assert moved_elems(n, a, b) == counts.sum() - np.trace(counts)
        rep = Layout("replicated", H)
        into, out = send_counts(n, a, rep), send_counts(n, rep, a)
        assert moved_elems(n, a, rep) == into.sum() - np.trace(into)
        assert moved_elems(n, rep, a) == out.sum() - np.trace(out) == 0
        np.testing.assert_array_equal(np.diag(out), shares(n, a))


# ---------------------------------------------------------------------------
# Fig 1 across ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_rank_microbench_matches_jax_and_home_mesh(worlds, world):
    """Each rank's chunk is the mesh-less JAX microbench's, bit for bit;
    its wire bytes are the one-process `relayout_counts` bytes / N, in 2R
    all-to-alls under static non-localised mapping and none otherwise."""
    import jax
    import jax.numpy as jnp

    from repro.core import Homing as JHoming
    from repro.core import LocalisationPolicy as JPolicy
    from repro.core import microbench as jmb
    x = make_fig1_data(FIG1_N, "float32", 5)
    for name, (loc, static, h) in FIG1.items():
        for reps in FIG1_REPS:
            ref = np.asarray(jax.jit(jmb.repetitive_copy,
                                     static_argnums=(1, 2, 3))(
                jnp.asarray(x), reps, None, JPolicy(loc, static, JHoming(h))))
            reset_relayouts()
            Locale(HomeMesh({"data": world}, device="cpu"), "data",
                   LocalisationPolicy(loc, static, Homing(h))).workload(
                "microbench", reps=reps)(x)
            home_bytes = relayout_counts()["bytes"]
            c = FIG1_N // world
            for r, res in enumerate(worlds[world]):
                got = res["fig1"][name, reps]
                np.testing.assert_array_equal(
                    got["chunk"].view(np.int32),
                    ref[r * c:(r + 1) * c].view(np.int32),
                    err_msg=f"{name} R={reps} rank {r}")
                wire = sum(rec["wire_bytes"] for rec in got["log"])
                assert wire * world == home_bytes, (name, reps, r)
                assert got["relayouts"]["bytes"] == wire
                want = 2 * reps if name == "nonlocalised" else 0
                assert [rec["kind"] for rec in got["log"]] == \
                    ["all-to-all"] * want, (name, reps)


# ---------------------------------------------------------------------------
# Locale's methods on ranks, the analyser, pin_tree
# ---------------------------------------------------------------------------
def test_rank_pin_localise_make(worlds):
    """`pin` gives each rank its elements under the policy's layout (its
    interleaved column under static non-localised hash homing, its chunk
    otherwise), `localise` its chunk, `make` builds its chunk only."""
    x = np.arange(64, dtype=np.int32)
    for r, res in enumerate(worlds[8]):
        for k, got in res["pin"].items():
            pol = case_policy(k)
            hashed = (not pol.localised
                      and pol.homing == Homing.HASH_INTERLEAVED)
            want_raw = x[r::8] if hashed else x[r * 8:(r + 1) * 8]
            np.testing.assert_array_equal(got["raw"], want_raw, err_msg=k)
            data, homing, same = got["homed"]
            placed = x[r::8] if pol.homing == Homing.HASH_INTERLEAVED \
                else x[r * 8:(r + 1) * 8]
            if pol.localised:
                np.testing.assert_array_equal(data[0], x[r * 8:(r + 1) * 8])
                assert homing == "local"
                assert same == (pol.homing == Homing.LOCAL_CHUNKED)
            else:
                np.testing.assert_array_equal(data[0], placed)
                assert same
            np.testing.assert_array_equal(got["localised"][0],
                                          x[r * 8:(r + 1) * 8])
            # hash homing: the raw chunk pinned (case 3) and the placed
            # column localised are one all-to-all each
            moves = (k in (3, 7)) + (pol.homing == Homing.HASH_INTERLEAVED)
            assert got["log"] == ["all-to-all"] * moves, (k, got["log"])
        rows, calls = res["make"]
        np.testing.assert_array_equal(
            rows, np.arange(96).reshape(32, 3)[r * 4:(r + 1) * 4])
        assert calls == [slice(4 * r, 4 * r + 4)]


def test_rank_check_runs_r2_and_flags_a_planted_move(worlds):
    """`Locale.check` of the constraint sort and the microbench on ranks:
    clean, R2 run on each rank's collectives, R1 noted as skipped (the
    reference checks neither against a budget); a relayout that spans the
    undeclared pod axis is an R2 error."""
    for res in worlds[8]:
        for tag, rep in res["check"].items():
            assert rep["clean"], (tag, rep["findings"])
            skipped = {n.split()[0] for n in rep["notes"] if "skipped" in n}
            assert "R1" in skipped and "R2" not in skipped, rep["notes"]
            assert rep["collectives"] > 0, tag
        assert res["planted"]["clean"] == []
        leak = res["planted"]["leak"]
        assert len(leak) == 1 and "R2" in leak[0] and "['pod']" in leak[0]


def test_pin_tree_raises_on_a_rank_mesh(worlds):
    """`pin_tree` on a `RankMesh` of 2, 4 and 8 ranks (and the pod mesh):
    each rank keeps exactly its home's 4 slots of every slot leaf, a leaf
    of another size stays as it was, pinning the rank's rows again
    returns them as they are, and no collective runs.  (It raised until
    serving ran across ranks; it raises now only for a call without the
    whole slot count, ``size``.)"""
    for world, ranks in worlds.items():
        whole = pin_tree_input(world)
        for res in ranks:
            for tag, got in res["pin_tree"].items():
                h = got["home"]
                rows = slice(h * 4, (h + 1) * 4)
                np.testing.assert_array_equal(got["rows"]["k"],
                                              whole["k"][:, rows].numpy())
                np.testing.assert_array_equal(got["rows"]["kpos"],
                                              whole["kpos"][:, rows].numpy())
                assert got["other_kept"] and got["same"], (world, tag)
                assert got["log"] == [], (world, tag)
                assert "size=" in got["refusal"]
    mesh_free = Locale(None, "data")
    assert mesh_free.pin_tree(whole, dim=1, size=4) is whole
