"""The port's CUDA kernels and engine on the card, against their plain versions.

Every test here is marked ``gpu``, decides inside its body whether a card
is present, and skips without one.  Run on the card with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports torch, numpy and the port only (no JAX), so it runs on a
machine that has no JAX.  Tolerance: bit-exact, floats compared as int32
bit patterns.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import CASES
from repro_torch.convert import GRID_NAMES, grid_rows, make_sort_data
from repro_torch.core import (HomeMesh, Homing, Locale, LocalisationPolicy,
                              exchange_schedule)
from repro_torch.kernels import ops
from repro_torch.kernels.local_sort import TILE, local_sort_reference
from repro_torch.kernels.merge_split import merge_split_reference

CARD_C = (1, 5, 96, 256, 257, TILE - 1, TILE, TILE + 1, 3 * TILE + 7)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().view(torch.int32).numpy()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


def _runs(name, C, rows=4):
    a = np.sort(grid_rows(name, C, rows), axis=-1)
    b = np.sort(grid_rows(name, C, rows, seed=7), axis=-1)
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.gpu
@pytest.mark.parametrize("C", CARD_C)
def test_local_sort_kernel_matches_plain_on_card(C):
    _need_card()
    for name in GRID_NAMES:
        x = torch.from_numpy(grid_rows(name, C))
        np.testing.assert_array_equal(bits(ops.local_sort(x.cuda())),
                                      bits(local_sort_reference(x)),
                                      err_msg=f"{name} {C}")


@pytest.mark.gpu
@pytest.mark.parametrize("C", CARD_C)
def test_merge_split_kernel_matches_plain_on_card(C):
    _need_card()
    for name in GRID_NAMES:
        a, b = _runs(name, C)
        for k in (torch.tensor([True, False, False, True]), True, False):
            np.testing.assert_array_equal(
                bits(ops.merge_split(a.cuda(), b.cuda(), k)),
                bits(merge_split_reference(a, b, k)),
                err_msg=f"{name} {C} {k}")


@pytest.mark.gpu
def test_bitonic_sort_kernel_matches_plain_on_card():
    _need_card()
    for C in (1, 256, TILE, 4 * TILE):
        x = torch.from_numpy(grid_rows("rand_float", C))
        np.testing.assert_array_equal(bits(ops.bitonic_sort(x.cuda())),
                                      bits(ops.bitonic_sort(x)))


@pytest.mark.gpu
def test_wrappers_count_kernel_launches_and_raise_on_bad_input():
    _need_card()
    ops.reset_launches()
    x = torch.from_numpy(grid_rows("rand_int", 300)).cuda()
    ops.local_sort(x)
    ops.merge_split(x, x, True)
    assert ops.launch_counts() == {"local_sort": 1, "merge_split": 1,
                                   "bitonic_sort": 0}
    assert ops.merged_elems() == x.numel()
    with pytest.raises(ValueError, match="contiguous"):
        ops.local_sort(x.t())


ENGINE = {"case3": ({"data": 8}, "data", 3),
          "case7": ({"data": 8}, "data", 7),
          "case8": ({"data": 8}, "data", 8),
          "hier": ({"pod": 2, "data": 4}, ("pod", "data"), None)}


@pytest.mark.gpu
@pytest.mark.parametrize("tag", sorted(ENGINE))
def test_engine_on_card_matches_cpu_and_counts_launches(tag):
    _need_card()
    shape, axis, case = ENGINE[tag]
    if case is None:
        policy = LocalisationPolicy.hierarchical(inner="hash")
    else:
        c = CASES[case]
        policy = LocalisationPolicy(c.localised, c.static_mapping,
                                    Homing(c.homing))
    x = make_sort_data(2**16 + 5, "float32", 3)
    ops.reset_launches()
    got = Locale(HomeMesh(shape), axis, policy).workload(
        "sort", backend="shard_map")(x)
    counts = ops.launch_counts()
    want = Locale(HomeMesh(shape, device="cpu"), axis, policy).workload(
        "sort", backend="shard_map")(x)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert counts["local_sort"] == 1
    if policy.localised:
        merges = sum(r["local_merge_elems"] for r in exchange_schedule(
            x.shape[0], tuple(shape.values()), policy)
            if r["op"] == "merge_split")
        assert ops.merged_elems() == merges
    else:
        assert counts["merge_split"] == 0


@pytest.mark.gpu
def test_locale_put_defaults_to_the_card():
    _need_card()
    h = Locale().put(np.arange(8, dtype=np.int32))
    assert h.data.device.type == "cuda" and h.shape == (1, 8)
