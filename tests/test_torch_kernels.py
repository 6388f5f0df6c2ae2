"""The port's kernels held against the JAX reference kernels.

Inputs are made with numpy from a seed and go through both the JAX kernel
(Pallas in interpret mode, as the reference's own tests run it on the CPU)
and the port's wrapper on a CPU tensor (its plain version).  Tolerance:
bit-exact everywhere; floats are compared as int32 bit patterns, so a
signed-zero difference is a failure.  The CUDA kernels are held
against these plain versions on the card in `test_torch_gpu.py`.
"""
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sort import merge_sorted as jax_merge_sorted
from repro.kernels import ops as jops
from repro_torch.convert import (GRID_NAMES, NARROW_SORT_DTYPES, grid_rows,
                                 make_sort_data)
from repro_torch.core.sort import merge_sorted, merge_sorted_reference
from repro_torch.kernels import _build, local_sort, ops
from repro_torch.kernels.local_sort import local_sort_reference
from repro_torch.kernels.merge_split import (merge_schedule,
                                             merge_split_reference)

GRID_C = (1, 5, 96, 256, 257)


def bits(x) -> np.ndarray:
    """int32 bit patterns of an int32/float32 array or tensor."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32)


def nbits(x) -> np.ndarray:
    """Bit patterns of an array or tensor of any sort dtype, as signed
    integers of its width (bfloat16 and float16 as int16)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view({1: torch.int8, 2: torch.int16,
                       4: torch.int32}[x.element_size()]).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def narrow(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def narrow_rows(dtype: str, C: int, rows: int = 4, seed: int = 0):
    """(rows, C) values of `dtype` (`make_sort_data`: its extremes, zeros
    of both signs), as numpy int32 / float32 the dtype holds exactly."""
    return make_sort_data(rows * C, dtype, seed * 7919 + C).reshape(rows, C)


# ---------------------------------------------------------------------------
# local_sort / bitonic network: total-order key, -0.0 before +0.0
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", GRID_NAMES)
@pytest.mark.parametrize("C", GRID_C)
def test_local_sort_matches_reference_kernel(name, C):
    x = grid_rows(name, C)
    ref = np.asarray(jops.local_sort(jnp.asarray(x)))
    got = ops.local_sort(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(got), bits(ref), err_msg=f"{name} {C}")


@pytest.mark.parametrize("name", GRID_NAMES)
def test_bitonic_sort_matches_reference_kernel(name):
    for C in (1, 8, 256):
        x = grid_rows(name, C, rows=4, seed=1)
        ref = np.asarray(jops.bitonic_sort(jnp.asarray(x)))
        got = ops.bitonic_sort(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(bits(got), bits(ref),
                                      err_msg=f"{name} {C}")


def test_signed_zeros_order_like_reference():
    """XLA's min/max put -0.0 before +0.0; torch.sort would keep input order."""
    x = np.asarray([[0, -0.0, 1, -0.0, 0, -1, 0, -0.0]], np.float32)
    ref = np.asarray(jops.local_sort(jnp.asarray(x)))
    got = ops.local_sort(torch.from_numpy(x)).numpy()
    assert np.signbit(got).tolist() == [[True] * 4 + [False] * 4]
    np.testing.assert_array_equal(bits(got), bits(ref))
    # padded row (C=5 -> L=8) keeps its zeros' signs too
    x5 = np.asarray([[0.0, -0.0, np.inf, -0.0, -np.inf]], np.float32)
    np.testing.assert_array_equal(
        bits(ops.local_sort(torch.from_numpy(x5)).numpy()),
        bits(np.asarray(jops.local_sort(jnp.asarray(x5)))))


# the kernel's schedule (tile pass, then merge passes with merge-path
# co-ranks) emulated in PyTorch, at small tiles: C values giving 1, 2, 3,
# 6 and 7 merge passes, odd run counts and ragged last runs; `block` below
# the tile puts several merge blocks in every pair, as MT < TILE does
SCHEDULE_CASES = [(64, 64, C) for C in (5, 64, 65, 3 * 64 + 7, 5 * 64 + 3,
                                        37 * 64 + 11, 64 * 64 + 1)] + \
    [(256, 32, C) for C in (257, 3 * 256 + 7, 5 * 256 + 3, 37 * 256 + 11)] + \
    [(64, 1, 5 * 64 + 3)]


@pytest.mark.parametrize("tile,block,C", SCHEDULE_CASES, ids=str)
def test_local_sort_schedule_matches_plain_version(tile, block, C):
    for name in GRID_NAMES:
        x = torch.from_numpy(grid_rows(name, C))
        got = local_sort.local_sort_schedule(x, tile=tile, block=block)
        np.testing.assert_array_equal(bits(got), bits(local_sort_reference(x)),
                                      err_msg=f"{name} {tile} {block} {C}")


@pytest.mark.parametrize("name", ["rand_float", "dups_int"])
def test_local_sort_schedule_at_the_real_tile_matches_reference_kernel(name):
    C = 3 * local_sort.TILE + 7                  # 4 tiles, 2 merge passes
    x = grid_rows(name, C, rows=2, seed=5)
    ref = np.asarray(jops.local_sort(jnp.asarray(x)))
    got = local_sort.local_sort_schedule(torch.from_numpy(x))
    np.testing.assert_array_equal(bits(got), bits(ref))


def test_local_sort_schedule_merges_by_the_total_order_key():
    """Run 0 holds +0.0 only and run 1 -0.0 only: an IEEE merge with ties
    to the left run would keep +0.0 first; the key merge puts -0.0 first."""
    x = np.concatenate([np.zeros(64, np.float32), -np.zeros(64, np.float32),
                        np.full(5, -1.0, np.float32)])[None]
    got = local_sort.local_sort_schedule(torch.from_numpy(x), tile=64,
                                         block=16).numpy()
    assert got[0, :5].tolist() == [-1.0] * 5
    assert np.signbit(got[0, 5:]).tolist() == [True] * 64 + [False] * 64
    np.testing.assert_array_equal(
        bits(got), bits(np.asarray(jops.local_sort(jnp.asarray(x)))))


def test_bitonic_sort_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        ops.bitonic_sort(torch.zeros((2, 6), dtype=torch.int32))


def test_chunked_sort_matches_reference():
    x = grid_rows("rand_float", 64, rows=8, seed=3)
    ref = np.asarray(jops.chunked_sort(jnp.asarray(x)))
    got = ops.chunked_sort(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(got), bits(ref))


# ---------------------------------------------------------------------------
# merge_split / merge_sorted: IEEE compares, ties to a
# ---------------------------------------------------------------------------
def _runs(name, C, rows=4):
    a = np.sort(grid_rows(name, C, rows), axis=-1)
    b = np.sort(grid_rows(name, C, rows, seed=7), axis=-1)
    return a, b


@pytest.mark.parametrize("name", GRID_NAMES)
@pytest.mark.parametrize("C", GRID_C)
def test_merge_split_matches_reference_kernel(name, C):
    a, b = _runs(name, C)
    keep = (np.arange(4) % 2) == 0                   # mixed per-row flags
    ref = np.asarray(jops.merge_split(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(keep)))
    got = ops.merge_split(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(keep)).numpy()
    np.testing.assert_array_equal(bits(got), bits(ref), err_msg=f"{name} {C}")


@pytest.mark.parametrize("keep", [True, False])
def test_merge_split_scalar_keep_matches_reference(keep):
    a, b = _runs("rand_float", 96)
    ref = np.asarray(jops.merge_split(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(keep)))
    got = ops.merge_split(torch.from_numpy(a), torch.from_numpy(b),
                          keep).numpy()
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("keep_shape", [(2, 3), (2,), (5,)])
def test_merge_split_keep_validation_matches_reference(keep_shape):
    a, b = _runs("rand_int", 8, rows=3)
    keep = np.ones(keep_shape, bool)
    with pytest.raises(ValueError) as ref:
        jops.merge_split(jnp.asarray(a), jnp.asarray(b), jnp.asarray(keep))
    with pytest.raises(ValueError) as got:
        ops.merge_split(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(keep))
    assert str(got.value) == str(ref.value)


def test_merge_split_ties_go_to_a_across_signed_zeros():
    a = np.asarray([[-1.0, -0.0, -0.0, 2.0]], np.float32)
    b = np.asarray([[0.0, 0.0, 1.0, 2.0]], np.float32)
    for keep in (True, False):
        ref = np.asarray(jops.merge_split(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(keep)))
        got = ops.merge_split(torch.from_numpy(a), torch.from_numpy(b),
                              keep).numpy()
        np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("name", GRID_NAMES)
def test_merge_sorted_matches_reference(name):
    for C, D in ((1, 1), (5, 9), (96, 33), (257, 256)):
        a = np.sort(grid_rows(name, C, rows=1)[0])
        b = np.sort(grid_rows(name, D, rows=1, seed=2)[0])
        ref = np.asarray(jax_merge_sorted(jnp.asarray(a), jnp.asarray(b)))
        got = merge_sorted(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(bits(got), bits(ref),
                                      err_msg=f"{name} {C} {D}")


def test_merge_sorted_batched_rows_match_per_row():
    a, b = _runs("dups_int", 40, rows=5)
    got = merge_sorted(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for r in range(5):
        ref = np.asarray(jax_merge_sorted(jnp.asarray(a[r]),
                                          jnp.asarray(b[r])))
        np.testing.assert_array_equal(got[r], ref)


# ---------------------------------------------------------------------------
# the narrow sort dtypes, bit for bit against the reference kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", NARROW_SORT_DTYPES)
@pytest.mark.parametrize("C", GRID_C)
def test_local_sort_takes_the_narrow_dtypes_like_reference_kernel(dtype, C):
    jx, tx = narrow(narrow_rows(dtype, C), dtype)
    ref = jops.local_sort(jx)
    got = ops.local_sort(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(nbits(got), nbits(ref))
    if C > 1:
        np.testing.assert_array_equal(
            nbits(local_sort.local_sort_schedule(tx, tile=64, block=16)),
            nbits(ref))


@pytest.mark.parametrize("dtype", NARROW_SORT_DTYPES)
def test_bitonic_sort_takes_the_narrow_dtypes_like_reference_kernel(dtype):
    for C in (1, 8, 256):
        jx, tx = narrow(narrow_rows(dtype, C, seed=1), dtype)
        np.testing.assert_array_equal(nbits(ops.bitonic_sort(tx)),
                                      nbits(jops.bitonic_sort(jx)))


@pytest.mark.parametrize("dtype", NARROW_SORT_DTYPES)
@pytest.mark.parametrize("C", GRID_C)
def test_merge_split_takes_the_narrow_dtypes_like_reference_kernel(dtype, C):
    a = np.sort(narrow_rows(dtype, C), axis=-1)
    b = np.sort(narrow_rows(dtype, C, seed=7), axis=-1)
    (ja, ta), (jb, tb) = narrow(a, dtype), narrow(b, dtype)
    keep = (np.arange(4) % 2) == 0
    ref = jops.merge_split(ja, jb, jnp.asarray(keep))
    got = ops.merge_split(ta, tb, torch.from_numpy(keep))
    np.testing.assert_array_equal(nbits(got), nbits(ref))


@pytest.mark.parametrize("dtype", NARROW_SORT_DTYPES)
def test_merge_sorted_takes_the_narrow_dtypes_like_reference(dtype):
    for C, D in ((1, 1), (5, 9), (96, 33), (257, 256)):
        a = np.sort(narrow_rows(dtype, C, rows=1)[0])
        b = np.sort(narrow_rows(dtype, D, rows=1, seed=2)[0])
        (ja, ta), (jb, tb) = narrow(a, dtype), narrow(b, dtype)
        np.testing.assert_array_equal(nbits(merge_sorted(ta, tb)),
                                      nbits(jax_merge_sorted(ja, jb)),
                                      err_msg=f"{C} {D}")


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_unsigned_sort_dtypes_match_numpy_above_the_signed_range(dtype):
    """uint16 and uint32 keys at and above 2^15 / 2^31 (where a signed view
    would order them first): every wrapper and `merge_sorted` agree with
    numpy's sort and merge, bit for bit."""
    top = np.iinfo(dtype).max
    x = np.asarray([top, 0, top // 2 + 1, top // 2, 1, top - 1, top // 2 + 2,
                    7], dtype=dtype).reshape(1, 8).repeat(2, axis=0)
    x[1] = x[1, ::-1]
    t = torch.from_numpy(x)
    want = np.sort(x, axis=-1)
    for got in (ops.local_sort(t), ops.bitonic_sort(t),
                local_sort.local_sort_schedule(t, tile=4, block=2)):
        assert got.dtype == t.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    a, b = torch.from_numpy(want[:1]), torch.from_numpy(want[1:])
    both = np.sort(np.concatenate([want[0], want[1]]))
    for got in (ops.merge_runs(a, b), merge_sorted(a, b),
                merge_schedule(a, b, None, block=4, items=2)):
        np.testing.assert_array_equal(got.numpy()[0], both)
    np.testing.assert_array_equal(ops.merge_split(a, b, True).numpy()[0],
                                  both[:8])
    np.testing.assert_array_equal(ops.merge_split(a, b, False).numpy()[0],
                                  both[8:])


# ---------------------------------------------------------------------------
# the merge kernel's tile schedule, emulated (partition, windows, threads)
# ---------------------------------------------------------------------------
def _pair_buffer(dtype: str, rows: int, width: int, seed: int):
    """A (rows, 2, width) tensor of sorted runs with heavy duplicates and
    (floats) zeros of both signs; the strided views ``[:, 0]`` and
    ``[:, 1]`` are the runs the tree passes."""
    rng = np.random.default_rng(seed)
    lo = 0 if dtype.startswith("uint") else -6
    x = rng.integers(lo, 6, size=(rows, 2, width)).astype(np.float32)
    if dtype in ("float16", "bfloat16", "float32"):
        x[x == 0] = np.where(rng.random(int((x == 0).sum())) < 0.5, -0.0, 0.0)
        x[x == 5] = np.inf
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t.sort(dim=-1).values


# (block, items): several blocks a row with ragged last blocks, one output
# a thread, and the kernel's own thread shape at a small block
SCHEDULES = [(16, 4), (32, 8), (64, 1), (256, 32)]


@pytest.mark.parametrize("block,items", SCHEDULES, ids=str)
@pytest.mark.parametrize("dtype", ["int32", "float32"] +
                         list(NARROW_SORT_DTYPES))
def test_merge_schedule_matches_plain_versions(dtype, block, items):
    for rows, na, nb in ((3, 100, 100), (2, 257, 31), (1, 5, 0), (4, 64, 64),
                         (2, 0, 9), (3, 1000, 1000)):
        buf = _pair_buffer(dtype, rows, max(na, nb) + 3, rows + na + nb)
        a, b = buf[:, 0, :na], buf[:, 1, :nb]
        assert a.stride(0) == 2 * buf.shape[-1]       # strided rows
        got = merge_schedule(a, b, None, block=block, items=items)
        np.testing.assert_array_equal(nbits(got),
                                      nbits(merge_sorted_reference(a, b)),
                                      err_msg=f"full {rows} {na} {nb}")
        if na == nb:
            keep = torch.tensor([True, False, False, True][:rows])
            got = merge_schedule(a, b, keep, block=block, items=items)
            np.testing.assert_array_equal(
                nbits(got), nbits(merge_split_reference(a, b, keep)),
                err_msg=f"keep {rows} {na}")


def test_merge_schedule_ties_go_to_a_across_signed_zeros():
    """a holds -0.0 only and b +0.0 only (and the other way round): ties
    go to a in every block, so a's zeros come first and the keep halves
    take their own run's signs at the cut, as the reference does."""
    z = np.zeros(40, np.float32)
    for a_np, b_np in ((-z, z), (z, -z)):
        a = torch.from_numpy(np.concatenate([[-1.0], a_np, [2.0]])[None]
                             .astype(np.float32))
        b = torch.from_numpy(np.concatenate([[-2.0], b_np, [1.0]])[None]
                             .astype(np.float32))
        full = merge_schedule(a, b, None, block=16, items=4)
        assert np.signbit(full[0, 2:42].numpy()).tolist() == \
            [bool(np.signbit(a_np[0]))] * 40
        np.testing.assert_array_equal(nbits(full),
                                      nbits(merge_sorted_reference(a, b)))
        for keep in (True, False):
            got = merge_schedule(a, b, keep, block=16, items=4)
            ref = jops.merge_split(jnp.asarray(a.numpy()),
                                   jnp.asarray(b.numpy()), jnp.asarray(keep))
            np.testing.assert_array_equal(nbits(got), nbits(ref))


def test_merge_runs_on_the_cpu_is_the_plain_merge_uncounted():
    ops.reset_launches()
    buf = _pair_buffer("int32", 3, 50, 1)
    a, b = buf[:, 0, :40], buf[:, 1, :50]
    np.testing.assert_array_equal(ops.merge_runs(a, b).numpy(),
                                  merge_sorted_reference(a, b).numpy())
    # merge_sorted flattens the leading dims into rows of merge_runs
    runs = _pair_buffer("float32", 4, 33, 2).view(2, 4, 33)
    np.testing.assert_array_equal(
        nbits(merge_sorted(runs[:, 0::2], runs[:, 1::2])),
        nbits(merge_sorted_reference(runs[:, 0::2], runs[:, 1::2])))
    assert sum(ops.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# wrapper dispatch, counters, build
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_uncounted():
    ops.reset_launches()
    x = torch.from_numpy(grid_rows("rand_int", 33))
    np.testing.assert_array_equal(ops.local_sort(x).numpy(),
                                  local_sort_reference(x).numpy())
    a, b = (torch.from_numpy(v) for v in _runs("rand_int", 33))
    np.testing.assert_array_equal(ops.merge_split(a, b, True).numpy(),
                                  merge_split_reference(a, b, True).numpy())
    assert ops.launch_counts() == {"local_sort": 0, "merge_split": 0, "merge_runs": 0,
                                   "bitonic_sort": 0, "localised_copy": 0,
                                   "flash_attention": 0,
                                   "overlapping_index_map": 0,
                                   "gapped_index_map": 0, "oob_index_map": 0,
                                   "dead_lane_kernel": 0}


def test_wrappers_reject_other_devices_and_dtypes():
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.local_sort(meta)
    with pytest.raises(ValueError, match="meta"):
        ops.merge_split(meta, meta, True)
    with pytest.raises(TypeError):
        ops.local_sort(torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        ops.local_sort(torch.zeros((2, 0), dtype=torch.int32))


def test_build_names_every_source_by_content_hash(monkeypatch, tmp_path):
    assert set(_build.sources()) == {"fixtures", "flash_attention",
                                     "local_sort", "localised_copy",
                                     "merge_split"}
    # the merge-path header is shared: a change to it rebuilds both users
    assert (_build.CSRC / "merge_path.cuh").exists()
    t = _build._target("local_sort")
    assert t.parent == _build.BUILD_DIR and t.suffix == ".so"
    assert t != _build._target("merge_split")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_build_check_raises_with_the_cuda_error_string():
    def repro_test_error(code):
        return b"an illegal memory access was encountered"
    lib = types.SimpleNamespace(repro_test_error=repro_test_error)
    _build.check(0, lib, "repro_test_error", "kernel")       # 0: no error
    with pytest.raises(RuntimeError, match="kernel: CUDA error 700 .*illegal"):
        _build.check(700, lib, "repro_test_error", "kernel")


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=root, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no CUDA device" in r.stderr
