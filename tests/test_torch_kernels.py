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
from repro_torch.convert import GRID_NAMES, grid_rows
from repro_torch.core.sort import merge_sorted
from repro_torch.kernels import _build, ops
from repro_torch.kernels.local_sort import local_sort_reference
from repro_torch.kernels.merge_split import merge_split_reference

GRID_C = (1, 5, 96, 256, 257)


def bits(x) -> np.ndarray:
    """int32 bit patterns of an int32/float32 array or tensor."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32)


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
    assert ops.launch_counts() == {"local_sort": 0, "merge_split": 0,
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
