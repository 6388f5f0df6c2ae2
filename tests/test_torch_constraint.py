"""The port's constraint backend held against the JAX constraint backend.

The default ``workload("sort")`` on both sides, for the 8 Table-1
policies x {int32, float32}: without a mesh (8 workers) in this process,
and on ``{"data": 8}`` and ``{"pod": 2, "data": 4}`` against the JAX sort
run in one subprocess with 8 emulated host devices on meshes with Auto
axes (``jax.make_mesh``'s Explicit axes reject the reference's sharding
constraints; ROADMAP.md, "Reference caveat").  The port runs on
``device="cpu"``, the kernels' plain versions.  Tolerance: bit-exact,
floats compared as int32 bit patterns; one float input puts zeros of both
signs in one leaf, where ``jnp.sort`` keeps input order.

One fault of the reference shows here: on the 8-device meshes its
localised policies (cases 5-8 are localised; 7 and 8 static) return every
zero as ``+0.0``, while the same tree without a mesh keeps the signs.
For those float cases the port is held bit for bit to the mesh-less
reference, and the test checks that the 8-device reference differs from
it in zero signs only (ROADMAP.md, "Reference caveat").  Also: the
relayout counts, the placement methods of `Locale`, and the errors.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.core import Homing as JHoming
from repro.core import Locale as JLocale
from repro.core import LocalisationPolicy as JPolicy
from repro.core import sort as jsort
from repro_torch.configs import CASES
from repro_torch.convert import make_sort_data
from repro_torch.core import (HomeMesh, Homed, Homing, Locale,
                              LocalisationPolicy, sort)
from repro_torch.core.homing import (Layout, constrain, moved_elems,
                                     relayout_counts, reset_relayouts)
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3001


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def case_policy(k: int) -> LocalisationPolicy:
    c = CASES[k]
    return LocalisationPolicy(c.localised, c.static_mapping, Homing(c.homing))


def jax_policy(k: int):
    c = CASES[k]
    return JPolicy(c.localised, c.static_mapping, JHoming(c.homing))


def sort_input(dtype: str, seed: int) -> np.ndarray:
    """`make_sort_data`, and for float32 a run of zeros of both signs in
    the first leaf (the first 3001 / 8 elements)."""
    x = make_sort_data(N, dtype, seed)
    if dtype == "float32":
        x[5:45] = np.where(np.arange(40) % 3 == 0, -0.0, 0.0)
    return x


def test_sort_input_has_both_zero_signs_in_one_leaf():
    x = sort_input("float32", 0)[:N // 8]
    zero = x == 0
    assert np.signbit(x[zero]).any() and (~np.signbit(x[zero])).any()


# ---------------------------------------------------------------------------
# without a mesh: 8 workers, the JAX constraint sort in this process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_meshless_sort_matches_jax_constraint_backend(case, dtype):
    x = sort_input(dtype, case)
    ref = np.asarray(JLocale(policy=jax_policy(case)).workload("sort")(
        jnp.asarray(x)))
    got = Locale(policy=case_policy(case)).workload("sort", device="cpu")(x)
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_home_sort_matches_jax_on_one_device(case):
    """A mesh of one home: one worker, and a replicated layout of one copy."""
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    locale = Locale(HomeMesh({"data": 1}, device="cpu"), "data",
                    case_policy(case))
    for dt in ("int32", "float32"):
        x = sort_input(dt, case)
        ref = np.asarray(JLocale(mesh, "data", jax_policy(case)).workload(
            "sort")(jnp.asarray(x)))
        np.testing.assert_array_equal(bits(locale.workload("sort")(x).numpy()),
                                      bits(ref), err_msg=dt)


# ---------------------------------------------------------------------------
# 8 homes: the JAX constraint sort in one subprocess
# ---------------------------------------------------------------------------
JAX_8DEV = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core import Homing, Locale, LocalisationPolicy
from repro.configs.paper_sort import CASES

src, dst = sys.argv[1], sys.argv[2]
inp = np.load(src)
meshes = {"flat": (jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,)),
                   "data"),
          "pods": (jax.make_mesh((2, 4), ("pod", "data"),
                                 axis_types=(AxisType.Auto,) * 2),
                   ("pod", "data"))}
out = {}
for tag, (mesh, axis) in meshes.items():
    for k, c in CASES.items():
        pol = LocalisationPolicy(c.localised, c.static_mapping, Homing(c.homing))
        fn = Locale(mesh, axis, pol).workload("sort")
        for dt in ("int32", "float32"):
            out[f"{tag}_{k}_{dt}"] = np.asarray(fn(jnp.asarray(inp[dt])))
np.savez(dst, **out)
print("JAX_8DEV_OK")
"""

MESHES = {"flat": ({"data": 8}, "data"),
          "pods": ({"pod": 2, "data": 4}, ("pod", "data"))}


@pytest.fixture(scope="module")
def jax_8dev(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax8c")
    src, dst = d / "in.npz", d / "out.npz"
    inputs = {dt: sort_input(dt, 21) for dt in ("int32", "float32")}
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", JAX_8DEV, str(src), str(dst)],
                       capture_output=True, text=True, cwd=ROOT, timeout=900,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert "JAX_8DEV_OK" in r.stdout, r.stdout + r.stderr
    meshless = {(k, dt): np.asarray(JLocale(policy=jax_policy(k)).workload(
        "sort")(jnp.asarray(inputs[dt]))) for k in CASES
        for dt in ("int32", "float32")}
    return inputs, dict(np.load(dst)), meshless


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_on_8_homes_matches_jax_constraint_backend(jax_8dev, tag, case):
    inputs, ref, meshless = jax_8dev
    shape, axis = MESHES[tag]
    locale = Locale(HomeMesh(shape, device="cpu"), axis, case_policy(case))
    for dt in ("int32", "float32"):
        got = locale.workload("sort")(inputs[dt]).numpy()
        want = ref[f"{tag}_{case}_{dt}"]
        if dt == "float32" and CASES[case].localised \
                and CASES[case].static_mapping:
            # the reference's fault: every zero comes back as +0.0
            np.testing.assert_array_equal(want, got)          # under ==
            off = bits(want) != bits(got)
            assert off.any() and (got[off] == 0).all()
            assert not np.signbit(want[want == 0]).any()
            want = meshless[case, dt]
        np.testing.assert_array_equal(bits(got), bits(want),
                                      err_msg=f"{tag} case {case} {dt}")
        np.testing.assert_array_equal(bits(got), bits(meshless[case, dt]))


# ---------------------------------------------------------------------------
# relayouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", [k for k, c in CASES.items()
                                  if not c.static_mapping])
@pytest.mark.parametrize("tag", sorted(MESHES))
def test_non_static_policies_make_no_relayout(case, tag):
    shape, axis = MESHES[tag]
    reset_relayouts()
    fn = Locale(HomeMesh(shape, device="cpu"), axis,
                case_policy(case)).workload("sort")
    x = sort_input("int32", case)
    np.testing.assert_array_equal(fn(x).numpy(), np.sort(x))
    assert relayout_counts() == {"relayouts": 0, "elems": 0, "bytes": 0}


@pytest.mark.parametrize("N,n", [(2, 64), (4, 64), (8, 512), (8, 4096)])
def test_chunked_interleaved_relayout_moves_n_times_n_minus_1_over_n(N, n):
    mesh = HomeMesh({"data": N}, device="cpu")
    x = torch.arange(n, dtype=torch.int32)
    reset_relayouts()
    y = constrain(x, mesh, Homing.HASH_INTERLEAVED)
    assert torch.equal(y, x)
    hashed = Layout("interleaved", N)
    back = constrain(y, mesh, Homing.LOCAL_CHUNKED, src=hashed)
    assert torch.equal(back, x)
    assert relayout_counts() == {"relayouts": 2, "elems": 2 * n * (N - 1) // N,
                                 "bytes": 8 * n * (N - 1) // N}
    # a relayout into the layout a value already has copies nothing
    assert constrain(y, mesh, Homing.HASH_INTERLEAVED, src=hashed) is y
    assert constrain(x, mesh, Homing.LOCAL_CHUNKED) is x
    assert relayout_counts()["relayouts"] == 2


def test_moved_elems_counts_each_home_change():
    """Against a brute-force count of the elements whose home differs."""
    n, N = 96, 4

    def homes(lay):
        i = np.arange(n)
        if lay.kind == "chunked":
            return i // (n // N)
        if lay.kind == "interleaved":
            return i % N
        s = n // lay.runs
        return (i % s) // (s // N)

    lays = [Layout("chunked", N), Layout("interleaved", N)] + [
        Layout("runs", N, r) for r in (1, 2, 4, 8)]
    for a in lays:
        for b in lays:
            assert moved_elems(n, a, b) == int((homes(a) != homes(b)).sum())
        assert moved_elems(n, a, Layout("replicated", N)) == (N - 1) * n
        assert moved_elems(n, Layout("replicated", N), a) == 0


def test_replicated_policy_sorts_over_one_copy_per_home():
    """Cases 2/4 under static mapping: the leaves are sorted over the m
    copies (one `local_sort` call of m * 8 rows), counted as one gather."""
    seen = []

    def leaf_sort(runs):
        seen.append(tuple(runs.shape))
        return torch.sort(runs, dim=-1, stable=True).values

    x = make_sort_data(1000, "int32", 4)
    reset_relayouts()
    y = Locale(HomeMesh({"data": 8}, device="cpu"), "data",
               case_policy(4)).workload("sort", local_sort=leaf_sort)(x)
    np.testing.assert_array_equal(y.numpy(), np.sort(x))
    n_p = 1000 + (-1000) % 64
    assert seen == [(8, 8, n_p // 8)]
    assert relayout_counts() == {"relayouts": 1, "elems": 7 * n_p,
                                 "bytes": 4 * 7 * n_p}


# ---------------------------------------------------------------------------
# the placement methods of Locale
# ---------------------------------------------------------------------------
def cpu_locale(policy=LocalisationPolicy(), shape=None, axis="data"):
    return Locale(HomeMesh(shape or {"data": 8}, device="cpu"), axis, policy)


@pytest.mark.parametrize("homing", list(Homing))
@pytest.mark.parametrize("localised", [True, False])
def test_pin_round_trips(homing, localised):
    policy = LocalisationPolicy(localised, True, homing)
    locale = cpu_locale(policy)
    x = torch.arange(64, dtype=torch.int32)
    assert torch.equal(locale.pin(x), x)
    h = locale.put(x)
    pinned = locale.pin(h)
    assert torch.equal(pinned.logical(), x)
    if localised:
        assert pinned.homing == Homing.LOCAL_CHUNKED
        assert torch.equal(locale.localise(h).logical(), x)
    else:
        assert pinned is h
    # no mesh, or a runtime-chosen mapping: strict no-ops, nothing counted
    reset_relayouts()
    for off in (Locale(policy=policy),
                cpu_locale(LocalisationPolicy(localised, False, homing))):
        assert off.pin(x) is x and off.pin(h) is h
        tree = {"a": x, "b": [x.view(8, 8)]}
        assert off.pin_tree(tree) is tree
    assert relayout_counts()["relayouts"] == 0


def test_pin_raises_on_mixed_homing():
    locale = cpu_locale(LocalisationPolicy(homing=Homing.HASH_INTERLEAVED))
    h = cpu_locale().put(np.arange(16, dtype=np.int32))
    with pytest.raises(TypeError, match="cannot pin"):
        locale.pin(h)


def test_pin_tree_homes_each_leaf_along_dim():
    locale = cpu_locale(shape={"pod": 2, "data": 4}, axis=("pod", "data"))
    cache = torch.arange(2 * 16 * 3, dtype=torch.float32).view(2, 16, 3)
    tree = {"k": cache, "v": [cache + 1, torch.zeros(5)], "step": 7}
    reset_relayouts()
    out = locale.pin_tree(tree, dim=1, size=16)
    assert out["step"] == 7 and out["v"][1] is tree["v"][1]
    assert torch.equal(out["k"], cache) and torch.equal(out["v"][0], cache + 1)
    # along dim 1 each of the 2 outer runs is chunked over the 8 homes
    per_leaf = moved_elems(cache.numel(), Layout("chunked", 8),
                           Layout("runs", 8, 2))
    assert per_leaf > 0
    assert relayout_counts()["elems"] == 2 * per_leaf
    # along dim 0 a leaf already is chunk-contiguous: nothing moves
    reset_relayouts()
    locale.pin_tree({"x": torch.zeros(8, 4)})
    assert relayout_counts()["relayouts"] == 0


def test_make_builds_each_homes_rows_and_jit_returns_fn():
    locale = cpu_locale()
    calls = []

    def cb(index):
        calls.append(index)
        return np.arange(32 * 3).reshape(32, 3)[index]

    y = locale.make((32, 3), cb)
    assert y.shape == (32, 3) and y.device.type == "cpu"
    np.testing.assert_array_equal(y.numpy(), np.arange(96).reshape(32, 3))
    assert [c[0] for c in calls] == [slice(4 * d, 4 * d + 4) for d in range(8)]
    with pytest.raises(ValueError, match="pad"):
        locale.make((30, 3), cb)

    def f(v):
        return v + 1
    assert locale.jit(f) is f


# ---------------------------------------------------------------------------
# errors and the granule
# ---------------------------------------------------------------------------
def test_constraint_backend_errors():
    locale = cpu_locale()
    with pytest.raises(ValueError, match="shard_map"):
        locale.workload("sort", local_phase="pallas")
    with pytest.raises(ValueError, match="shard_map"):
        locale.workload("sort", local_phase="kernel")
    with pytest.raises(ValueError, match="NaN"):
        locale.workload("sort")(np.asarray([1.0, np.nan], np.float32))
    with pytest.raises(ValueError, match="differs"):
        locale.workload("sort", device="meta")
    with pytest.raises(ValueError, match="HomeMesh"):
        Locale().workload("sort", backend="shard_map", device="cpu")
    pods = HomeMesh({"pod": 2, "data": 4}, device="cpu")
    with pytest.raises(ValueError, match="pad"):
        sort.distributed_merge_sort(torch.arange(100, dtype=torch.int32), pods,
                                    axis="data")
    y = sort.distributed_merge_sort(
        torch.arange(64, 0, -1, dtype=torch.int32), pods, axis="data")
    np.testing.assert_array_equal(y.numpy(), np.arange(1, 65))


@pytest.mark.parametrize("case", sorted(CASES))
def test_constraint_granule_is_the_references(case):
    for workers in (None, 4, 16):
        assert (sort.constraint_granule(None, case_policy(case), workers, "d")
                == jsort.constraint_granule(None, jax_policy(case), workers,
                                            "d"))
        # on a mesh of 8 homes, per the reference's formula
        m = workers or 8
        want = m * 8 if CASES[case].static_mapping else m
        assert sort.constraint_granule(HomeMesh({"data": 8}, device="cpu"),
                                       case_policy(case), workers,
                                       "data") == want


def test_cpu_constraint_sort_launches_no_kernel():
    ops.reset_launches()
    cpu_locale(case_policy(3)).workload("sort")(make_sort_data(999, "int32", 1))
    assert not any(ops.launch_counts().values())


def test_meshless_constraint_sort_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        Locale().workload("sort")
    with pytest.raises(RuntimeError, match="CUDA"):
        Locale().workload("microbench", reps=2)
    assert isinstance(cpu_locale().put(np.arange(8)), Homed)
