"""The port's sort engine held against the JAX engine, bit for bit.

The slice as a whole: the same seeded inputs go through the JAX engine
(``backend="shard_map"``, ``local_phase="pallas"`` in interpret mode) and
the port's engine on ``device="cpu"`` (the kernels' plain versions).  The
8-device reference runs in one subprocess with emulated host devices;
the one-device reference runs in this process.  Tolerance: bit-exact,
floats compared as int32 bit patterns.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Homing as JHoming
from repro.core import Locale as JLocale
from repro.core import LocalisationPolicy as JPolicy
from repro_torch.configs import CASES
from repro_torch.convert import homed_from_reference, make_sort_data
from repro_torch.core import (HomeMesh, Homing, Locale, LocalisationPolicy,
                              exchange_schedule)
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def case_policy(k: int) -> LocalisationPolicy:
    c = CASES[k]
    return LocalisationPolicy(c.localised, c.static_mapping, Homing(c.homing))


def port_sort(x, shape, axis, policy, **kw):
    mesh = HomeMesh(shape, device="cpu")
    fn = Locale(mesh, axis, policy).workload("sort", backend="shard_map", **kw)
    return fn(x).numpy()


def check_sorted(y, x):
    """int32 bit-exact against np.sort; float32 equal under == (so the
    multiset of values is preserved), and bit-exact off the zeros.

    The zeros' signs are not a multiset invariant of the reference: a
    merge-split pair computes its low and its high half separately, each
    side breaking -0.0 == +0.0 ties toward its own run, so one sign of zero
    can be kept twice at a block boundary.  The JAX engine does the same,
    which the bit-exact comparisons against it pin.
    """
    expect = np.sort(x)
    if x.dtype == np.int32:
        np.testing.assert_array_equal(y, expect)
    else:
        assert (y == expect).all()
        nz = expect != 0
        np.testing.assert_array_equal(bits(y[nz]), bits(expect[nz]))


# ---------------------------------------------------------------------------
# the 8-device JAX engine in one subprocess
# ---------------------------------------------------------------------------
JAX_8DEV = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core import Homing, Locale, LocalisationPolicy
from repro.configs.paper_sort import CASES

src, dst = sys.argv[1], sys.argv[2]
inp = np.load(src)
from jax.sharding import AxisType
# Auto axes: jax.make_mesh's default Explicit axes reject the reference's
# in-jit reshapes of sharded values
flat = jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,))
pods = jax.make_mesh((2, 4), ("pod", "data"),
                     axis_types=(AxisType.Auto,) * 2)
runs = {}
for k in (3, 7, 8):
    c = CASES[k]
    runs[f"case{k}"] = (flat, "data", LocalisationPolicy(
        c.localised, c.static_mapping, Homing(c.homing)))
runs["hier"] = (pods, ("pod", "data"),
                LocalisationPolicy.hierarchical(inner="hash"))
out = {}
for tag, (mesh, axis, pol) in runs.items():
    for dt in ("int32", "float32"):
        fn = Locale(mesh, axis, pol).workload("sort", backend="shard_map",
                                               local_phase="pallas")
        out[f"{tag}_{dt}"] = np.asarray(fn(jnp.asarray(inp[dt])))
# placements, for homed_from_reference: the full placed data and each
# device's shard in mesh (pod-major) order
for tag, (mesh, axis, h) in {
        "chunked": (flat, "data", Homing.LOCAL_CHUNKED),
        "interleaved": (flat, "data", Homing.HASH_INTERLEAVED),
        "pods_interleaved": (pods, ("pod", "data"), Homing.HASH_INTERLEAVED),
        }.items():
    homed = Locale(mesh, axis, LocalisationPolicy(homing=h)).put(
        jnp.asarray(inp["homed"]))
    order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    shards = sorted(homed.data.addressable_shards,
                    key=lambda s: order[s.device])
    out[f"placed_{tag}"] = np.asarray(homed.data)
    out[f"shards_{tag}"] = np.stack([np.asarray(s.data).reshape(-1)
                                     for s in shards])
np.savez(dst, **out)
print("JAX_8DEV_OK")
"""


@pytest.fixture(scope="module")
def jax_8dev(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax8")
    src, dst = d / "in.npz", d / "out.npz"
    inputs = {"int32": make_sort_data(3001, "int32", 11),
              "float32": make_sort_data(3001, "float32", 12),
              "homed": np.arange(64, dtype=np.int32)}
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", JAX_8DEV, str(src), str(dst)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert "JAX_8DEV_OK" in r.stdout, r.stdout + r.stderr
    return inputs, dict(np.load(dst))


PORT_8DEV = {"case3": ({"data": 8}, "data", case_policy(3)),
             "case7": ({"data": 8}, "data", case_policy(7)),
             "case8": ({"data": 8}, "data", case_policy(8)),
             "hier": ({"pod": 2, "data": 4}, ("pod", "data"),
                      LocalisationPolicy.hierarchical(inner="hash"))}


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(PORT_8DEV))
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_engine_matches_jax_8dev_engine(jax_8dev, tag, dtype):
    inputs, ref = jax_8dev
    shape, axis, policy = PORT_8DEV[tag]
    got = port_sort(inputs[dtype], shape, axis, policy)
    np.testing.assert_array_equal(bits(got), bits(ref[f"{tag}_{dtype}"]))
    check_sorted(got, inputs[dtype])


@pytest.mark.slow
@pytest.mark.parametrize("tag", ["chunked", "interleaved", "pods_interleaved"])
def test_homed_from_reference_rows_are_device_shards(jax_8dev, tag):
    _, ref = jax_8dev
    shape, axis = (({"pod": 2, "data": 4}, ("pod", "data")) if "pods" in tag
                   else ({"data": 8}, "data"))
    homing = Homing.LOCAL_CHUNKED if tag == "chunked" else Homing.HASH_INTERLEAVED
    locale = Locale(HomeMesh(shape, device="cpu"), axis,
                    LocalisationPolicy(homing=homing))
    homed = homed_from_reference(ref[f"placed_{tag}"], homing.value, locale)
    np.testing.assert_array_equal(homed.data.numpy(), ref[f"shards_{tag}"])
    np.testing.assert_array_equal(homed.logical().numpy(), np.arange(64))
    np.testing.assert_array_equal(locale.put(np.arange(64, dtype=np.int32))
                                  .data.numpy(), ref[f"shards_{tag}"])


# ---------------------------------------------------------------------------
# the one-device JAX engine in this process
# ---------------------------------------------------------------------------
ONE_DEV_POLICIES = [(loc, h) for loc in (True, False)
                    for h in ("local", "hash")]


@pytest.mark.parametrize("local_phase", [("kernel", "pallas"),
                                         ("reference", "reference")],
                         ids=lambda p: p[0])
@pytest.mark.parametrize("loc,homing", ONE_DEV_POLICIES)
def test_engine_matches_jax_one_device_engine(loc, homing, local_phase):
    ours, theirs = local_phase
    ndev = len(jax.devices())
    jfn = JLocale(jax.make_mesh((ndev,), ("data",)),
                  policy=JPolicy(loc, True, JHoming(homing))).workload(
        "engine", num_workers=8, local_phase=theirs)
    policy = LocalisationPolicy(loc, True, Homing(homing))
    for n, dt in ((1000, "int32"), (513, "float32")):
        x = make_sort_data(n, dt, n)
        ref = np.asarray(jfn(jnp.asarray(x)))
        got = port_sort(x, {"data": ndev}, "data", policy, num_workers=8,
                        local_phase=ours)
        np.testing.assert_array_equal(bits(got), bits(ref),
                                      err_msg=f"{policy.name} {dt}")


# ---------------------------------------------------------------------------
# the port alone: every Table-1 case, the hierarchical policies, the API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_all_table1_cases_sort_on_8_homes(case):
    for dt in ("int32", "float32"):
        for phase in ("kernel", "reference"):
            x = make_sort_data(2053, dt, case)
            got = port_sort(x, {"data": 8}, "data", case_policy(case),
                            local_phase=phase, num_workers=16)
            check_sorted(got, x)


@pytest.mark.parametrize("inner", ["localised", "hash"])
@pytest.mark.parametrize("outer", ["hash", "replicate"])
def test_hierarchical_policies_sort_on_pods(inner, outer):
    policy = LocalisationPolicy.hierarchical(inner, outer)
    for shape in ({"pod": 2, "data": 4}, {"pod": 4, "data": 2},
                  {"pod": 2, "data": 8}):
        x = make_sort_data(1501, "float32", 5)
        check_sorted(port_sort(x, shape, ("pod", "data"), policy), x)


def test_sort_workload_keeps_reference_default_backend():
    locale = Locale(HomeMesh({"data": 8}, device="cpu"))
    # the default is the reference's, the constraint backend
    fn = locale.workload("sort")
    assert fn.__wrapped__.func.__name__ == "distributed_merge_sort"
    np.testing.assert_array_equal(fn(np.arange(9, 0, -1, dtype=np.int32))
                                  .numpy(), np.arange(1, 10))
    with pytest.raises(ValueError, match="unknown backend"):
        locale.workload("sort", backend="nope")
    with pytest.raises(ValueError, match="shard_map"):
        locale.workload("engine", backend="constraint")
    with pytest.raises(ValueError, match="unknown workload"):
        locale.workload("nope")
    with pytest.raises(TypeError, match="reps"):
        locale.workload("microbench")
    with pytest.raises(ValueError, match="hierarchical"):
        locale.with_policy(LocalisationPolicy.hierarchical()).workload(
            "engine")(np.arange(16, dtype=np.int32))
    fn = locale.workload("engine")
    np.testing.assert_array_equal(fn(np.arange(9, 0, -1, dtype=np.int32))
                                  .numpy(), np.arange(1, 10))


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        Locale().workload("engine")
    with pytest.raises(RuntimeError, match="CUDA"):
        Locale.auto(homes=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Locale().put(np.arange(4, dtype=np.int32))


def test_one_home_locale_puts_on_its_mesh_device():
    x = np.arange(5, dtype=np.int32)
    for axis in ("data", ("pod", "data")):
        shape = {"data": 1} if axis == "data" else {"pod": 1, "data": 1}
        h = Locale(HomeMesh(shape, device="cpu"), axis).put(x)
        assert h.shape == (1, 5) and h.data.device.type == "cpu"
        np.testing.assert_array_equal(h.logical().numpy(), x)


@pytest.mark.parametrize("case", [k for k, c in CASES.items()
                                  if not c.localised])
def test_unlocalised_engine_replicates_the_leaf_work_per_home(case):
    """Every home sorts the leaves of its own gathered copy, as in the
    reference: m * n_p leaf elements, the count `exchange_schedule`
    charges to level 0."""
    seen = []

    def leaf_sort(rows):
        seen.append(tuple(rows.shape))
        return torch.sort(rows, dim=-1).values

    x = make_sort_data(3001, "int32", case)
    y = port_sort(x, {"data": 8}, "data", case_policy(case),
                  local_sort=leaf_sort, local_phase="reference")
    np.testing.assert_array_equal(y, np.sort(x))
    (rows, leaf), = seen
    level0 = [r for r in exchange_schedule(3001, (8,), case_policy(case),
                                           local_phase="reference")
              if r["op"] == "local_sort"]
    assert rows == 8 * 8 and rows * leaf == level0[0]["local_merge_elems"]


def test_sort_rejects_nan_and_keeps_sentinel_data():
    fn = Locale(HomeMesh({"data": 4}, device="cpu")).workload("engine")
    with pytest.raises(ValueError, match="NaN"):
        fn(np.asarray([1.0, np.nan, 0.5], np.float32))
    big = np.iinfo(np.int32).max
    np.testing.assert_array_equal(
        fn(np.asarray([5, big, -3, 1, 2], np.int32)).numpy(),
        [-3, 1, 2, 5, big])


def test_locale_put_owners_and_homed():
    locale = Locale.auto(homes=4, device="cpu",
                         policy=LocalisationPolicy(homing=Homing.HASH_INTERLEAVED))
    h = locale.put(np.arange(10, dtype=np.int32), pad=True)
    assert h.shape == (4, 3) and h.homing == Homing.HASH_INTERLEAVED
    np.testing.assert_array_equal(h.logical().numpy()[:10], np.arange(10))
    assert (h.logical().numpy()[10:] == np.iinfo(np.int32).max).all()
    with pytest.raises(ValueError, match="pad"):
        locale.put(np.arange(10, dtype=np.int32))
    assert locale.owners(6) == (0, 0, 1, 1, 2, 2)
    assert Locale().owners(3) == (0, 0, 0)


def test_cpu_engine_launches_no_kernel():
    ops.reset_launches()
    port_sort(make_sort_data(777, "int32", 0), {"data": 8}, "data",
              case_policy(8))
    assert ops.launch_counts() == {"local_sort": 0, "merge_split": 0,
                                   "bitonic_sort": 0, "localised_copy": 0,
                                   "flash_attention": 0,
                                   "overlapping_index_map": 0,
                                   "gapped_index_map": 0, "oob_index_map": 0,
                                   "dead_lane_kernel": 0}
