"""The port's CUDA kernels and engine on the card, against their plain versions.

Every test here is marked ``gpu``, decides inside its body whether a card
is present, and skips without one.  Run on the card with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports torch, numpy and the port only (no JAX), so it runs on a
machine that has no JAX.  Tolerance: bit-exact, floats compared as int32
bit patterns, except `flash_attention`, held to its plain version within
`KERNEL_TOL`: rtol = atol = 2e-5 (float32), and one bfloat16 rounding step
(rtol = 2**-7, atol = 1e-5) for bfloat16: its sums run in another order;
and the raced rows of the `overlapping` mutant, a real race on the card,
each element one of its two writers'.  Each kernel's Python launch plan
must equal its C entry's dry run, and its coverage probe be exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import CASES
from repro_torch.convert import (GRID_NAMES, grid_rows, make_attention_inputs,
                                 make_fig1_data, make_sort_data)
from repro_torch.core import (HomeMesh, Homing, Locale, LocalisationPolicy,
                              exchange_schedule)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (KERNEL_TOL,
                                                 flash_attention_reference)
from repro_torch.kernels.local_sort import TILE, local_sort_reference
from repro_torch.kernels.localised_copy import localised_copy_reference
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
                                   "bitonic_sort": 0, "localised_copy": 0,
                                   "flash_attention": 0,
                                   "overlapping_index_map": 0,
                                   "gapped_index_map": 0, "oob_index_map": 0,
                                   "dead_lane_kernel": 0}
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


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [0, 1, 7, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_localised_copy_kernel_matches_plain_on_card(reps, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    for shape in ((3, 1001), (8, 4096), (1, 5)):
        x = torch.from_numpy(make_fig1_data(shape, dtype, reps)).to(dt)
        want = localised_copy_reference(x, reps)
        got = ops.localised_copy(x.cuda(), reps)
        assert torch.equal(got.cpu().view(torch.int16 if dtype == "bfloat16"
                                          else torch.int32),
                           want.view(torch.int16 if dtype == "bfloat16"
                                     else torch.int32)), shape
    # a buffer that is not 16-byte aligned takes the element-wise path
    flat = torch.from_numpy(make_fig1_data(4097, dtype, 9)).to(dt).cuda()
    odd = flat[1:].view(1, 4096)
    assert odd.data_ptr() % 16
    assert torch.equal(ops.localised_copy(odd, reps).cpu(),
                       localised_copy_reference(odd.cpu(), reps))


FA_CASES = [
    # (B, H, KV, Sq, Skv, hd, causal, window, bq, bk)
    (1, 4, 2, 200, 200, 32, True, 0, 64, 64),       # ragged, GQA
    (2, 2, 1, 77, 130, 64, False, 0, 128, 128),     # cross, MQA, ragged
    (1, 2, 2, 512, 512, 128, True, 64, 64, 64),     # window: tiles skipped
    (1, 4, 4, 300, 300, 128, True, 0, 128, 128),
    (1, 2, 2, 100, 100, 16, True, 40, 32, 32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_kernel_matches_plain_on_card(case, dtype):
    _need_card()
    B, H, KV, Sq, Skv, hd, causal, window, bq, bk = case
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt).cuda() for a in
               make_attention_inputs(B, H, KV, Sq, Skv, hd, dtype, 3))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=bq, block_k=bk)
    assert ops.launch_counts()["flash_attention"] == 1
    want = flash_attention_reference(q, k, v, causal=causal, window=window,
                                     block_q=bq, block_k=bk)
    rtol, atol = KERNEL_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["localised", "nonlocalised", "auto"])
def test_microbench_on_card_is_one_launch_a_pass(policy):
    _need_card()
    loc, static = {"localised": (True, True), "nonlocalised": (False, True),
                   "auto": (False, False)}[policy]
    pol = LocalisationPolicy(loc, static, Homing.LOCAL_CHUNKED if loc
                             else Homing.HASH_INTERLEAVED)
    x = make_fig1_data(1 << 16, "float32", 0)
    fn = Locale(HomeMesh({"data": 8}), "data", pol).workload("microbench",
                                                            reps=9)
    ops.reset_launches()
    got = fn(x)
    assert ops.launch_counts()["localised_copy"] == 9
    want = localised_copy_reference(torch.from_numpy(x)[None], 9)[0]
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_constraint_sort_on_card_matches_cpu(case):
    _need_card()
    c = CASES[case]
    policy = LocalisationPolicy(c.localised, c.static_mapping,
                                Homing(c.homing))
    for dt in ("int32", "float32"):
        x = make_sort_data(2**16 + 5, dt, case)
        ops.reset_launches()
        got = Locale(HomeMesh({"data": 8}), "data", policy).workload("sort")(x)
        assert ops.launch_counts()["local_sort"] == 1
        want = Locale(HomeMesh({"data": 8}, device="cpu"), "data",
                      policy).workload("sort")(x)
        np.testing.assert_array_equal(bits(got), bits(want))


# ---------------------------------------------------------------------------
# the analysis slice: the mutants, the launch plans, the coverage probe
# ---------------------------------------------------------------------------
MUTANT_KINDS = ("overlapping", "gapped", "oob", "dead_lane")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", MUTANT_KINDS)
def test_mutant_kernel_matches_plain_on_card(kind):
    _need_card()
    from repro_torch.kernels.fixtures import (MUTANTS, mutant_reference,
                                              run_mutant)
    x = torch.from_numpy(make_fig1_data((4, 128), "float32", 5))
    want, want_entered = mutant_reference(kind, x)
    ops.reset_launches()
    got, entered = run_mutant(kind, x.cuda())
    assert MUTANTS[kind].launches == 1
    assert int(entered) == 0 and int(want_entered) == 0
    got = got.cpu()
    if kind == "overlapping":
        # a real race: each element of row k is one of its two writers'
        for k in range(2):
            one = (bits(got[k]) == bits(x[2 * k])) | \
                (bits(got[k]) == bits(x[2 * k + 1]))
            assert one.all()
        assert torch.isnan(got[2:]).all()
    else:
        np.testing.assert_array_equal(bits(got), bits(want))


PLAN_CASES = {
    "local_sort": [(8, 1000, "int32"), (3, 3 * TILE + 7, "float32")],
    "merge_split": [(8, 5000, "int32"), (16, 2049, "float32")],
    "localised_copy": [(1003, 3, "bfloat16", True), (4097, 1, "float32",
                                                     False)],
    "flash_attention": [(1, 4, 2, 200, 200, 32, 64, 64, True, 0, "float32"),
                        (1, 2, 2, 512, 512, 128, 128, 128, True, 64,
                         "bfloat16")],
    "fixtures": [(k, 4, 128) for k in MUTANT_KINDS],
}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(PLAN_CASES))
def test_python_plan_equals_c_plan_and_probe(kernel):
    _need_card()
    import importlib

    from repro_torch.analysis.probe import coverage_probe
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    for args in PLAN_CASES[kernel]:
        want = [f.launch_tuple() for f in mod.plan(*args)]
        assert mod.c_plan(*args) == want, args
        probe = coverage_probe((mod.__name__, args))
        assert all(p["mismatches"] == 0 for p in probe.values()), (args,
                                                                   probe)
