"""The port's CUDA kernels and engine on the card, against their plain versions.

Every test here is marked ``gpu``, decides inside its body whether a card
is present, and skips without one.  Run on the card with::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports torch, numpy and the port only (no JAX), so it runs on a
machine that has no JAX.  Tolerance: bit-exact, floats compared as bit
patterns of their width, except `flash_attention`, held to its plain
version within `KERNEL_TOL`: rtol = atol = 2e-5 (float32), one bfloat16
rounding step (rtol = 2**-7, atol = 1e-5) for bfloat16 and one float16
step (rtol = 2**-10, atol = 1e-5) for float16: its sums run in another
order;
and the raced rows of the `overlapping` mutant, a real race on the card,
each element one of its two writers'.  Each kernel's Python launch plan
must equal its C entry's dry run, and its coverage probe be exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import record
from repro_torch.configs import CASES
from repro_torch.convert import (GRID_NAMES, NARROW_SORT_DTYPES, grid_rows,
                                 make_attention_inputs, make_fig1_data,
                                 make_sort_data)
from repro_torch.core import (HomeMesh, Homing, Locale, LocalisationPolicy,
                              exchange_schedule)
from repro_torch.core.sort import merge_sorted_reference
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (KERNEL_TOL, KERNELS,
                                                 flash_attention_reference)
from repro_torch.kernels.local_sort import (TILE, local_sort_reference,
                                            local_sort_schedule)
from repro_torch.kernels.localised_copy import localised_copy_reference
from repro_torch.kernels.merge_split import (merge_schedule,
                                             merge_split_reference)

# C > TILE: 2, 4, 6 and 38 sorted runs (1, 2, 3 and 6 merge passes, odd
# run counts and ragged last runs on the last three)
CARD_C = (1, 5, 96, 256, 257, TILE - 1, TILE, TILE + 1, 3 * TILE + 7,
          5 * TILE + 3, 37 * TILE + 11)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().view(torch.int32).numpy()


def nbits(t: torch.Tensor) -> np.ndarray:
    """Bit patterns of a tensor of any sort dtype."""
    t = t.cpu().contiguous()
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()]).numpy()


SORT_DTYPES = ("int32", "float32") + NARROW_SORT_DTYPES


def pair_buffer(dtype: str, rows: int, width: int, seed: int):
    """(rows, 2, width) sorted runs of `make_sort_data` values of `dtype`
    with heavy duplicates; ``[:, 0]`` and ``[:, 1]`` are strided views."""
    x = make_sort_data(rows * 2 * width, dtype, seed).reshape(rows, 2, width)
    x[..., ::3] = x[..., :1]                       # duplicates across runs
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t.sort(dim=-1).values


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
                                      bits(local_sort_reference(x.cuda())),
                                      err_msg=f"{name} {C}")


@pytest.mark.gpu
def test_local_sort_kernel_matches_schedule_emulation_on_card():
    _need_card()
    for name in GRID_NAMES:
        x = torch.from_numpy(grid_rows(name, 5 * TILE + 3, rows=2))
        np.testing.assert_array_equal(bits(ops.local_sort(x.cuda())),
                                      bits(local_sort_schedule(x)),
                                      err_msg=name)


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


# (rows, na, nb): equal and unequal runs, ragged blocks, an empty run
RUNS_CASES = [(1, 5, 3), (3, 100, 100), (2, 8192, 8192), (4, 20000, 3),
              (2, 30001, 30001), (3, 70000, 9000), (1, 0, 7),
              (2, 5 * 8192 + 17, 3 * 8192 + 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", SORT_DTYPES)
def test_merge_kernels_match_plain_on_card(dtype):
    """`merge_runs` (full) and `merge_split` (keep modes) on strided views
    of every sort dtype, against `merge_sorted_reference` and
    `merge_split_reference`."""
    _need_card()
    for rows, na, nb in RUNS_CASES:
        buf = pair_buffer(dtype, rows, max(na, nb) + 3, rows + na + nb)
        a, b = buf[:, 0, :na], buf[:, 1, :nb]
        ac, bc = buf.cuda()[:, 0, :na], buf.cuda()[:, 1, :nb]
        want = merge_sorted_reference(a, b)
        np.testing.assert_array_equal(nbits(ops.merge_runs(ac, bc)),
                                      nbits(want), err_msg=f"{rows} {na} {nb}")
        if na == nb:
            keep = torch.tensor([True, False, False, True] * 2)[:rows]
            np.testing.assert_array_equal(
                nbits(ops.merge_split(ac, bc, keep)),
                nbits(merge_split_reference(a, b, keep)),
                err_msg=f"keep {rows} {na}")


@pytest.mark.gpu
def test_merge_kernel_matches_schedule_emulation_on_card():
    _need_card()
    buf = pair_buffer("float32", 3, 5 * 8192 + 20, 3)
    a, b = buf[:, 0, :5 * 8192 + 17], buf[:, 1, :4 * 8192 + 1]
    got = ops.merge_runs(a.cuda(), b.cuda())
    np.testing.assert_array_equal(nbits(got), nbits(merge_schedule(a, b)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", NARROW_SORT_DTYPES)
def test_local_sort_kernel_takes_the_narrow_dtypes_on_card(dtype):
    _need_card()
    for C in (1, 5, 300, TILE, TILE + 1, 5 * TILE + 3):
        x = make_sort_data(3 * C, dtype, C).reshape(3, C)
        x = torch.from_numpy(x).to(getattr(torch, dtype))
        got = ops.local_sort(x.cuda())
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(nbits(got), nbits(local_sort_reference(x)),
                                      err_msg=f"{C}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", NARROW_SORT_DTYPES)
def test_constraint_sort_of_narrow_dtypes_on_card_matches_cpu(dtype):
    _need_card()
    x = torch.from_numpy(make_sort_data(2**16 + 5, dtype, 9)).to(
        getattr(torch, dtype))
    for case in (3, 8):
        c = CASES[case]
        policy = LocalisationPolicy(c.localised, c.static_mapping,
                                    Homing(c.homing))
        for backend in ("constraint", "shard_map"):
            ops.reset_launches()
            got = Locale(HomeMesh({"data": 8}), "data", policy).workload(
                "sort", backend=backend)(x)
            counts = ops.launch_counts()
            want = Locale(HomeMesh({"data": 8}, device="cpu"), "data",
                          policy).workload("sort", backend=backend)(x)
            np.testing.assert_array_equal(nbits(got), nbits(want),
                                          err_msg=f"{case} {backend}")
            assert counts["local_sort"] == 1
            if backend == "constraint":
                assert counts["merge_runs"] == 3


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
    assert ops.launch_counts() == {"local_sort": 1, "merge_split": 1, "merge_runs": 0,
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
    # the bfloat16 kernel's edges: every head dim, Sq and Skv off 64 and
    # 16, Sq < 64, cross attention, MQA and GQA, windows that empty tiles
    (1, 2, 2, 40, 40, 16, True, 0, 64, 64),         # hd 16, Sq < 64
    (1, 4, 1, 100, 100, 32, True, 0, 128, 128),     # hd 32, MQA
    (2, 8, 2, 333, 333, 64, True, 0, 128, 128),     # hd 64, GQA
    (1, 4, 2, 50, 333, 128, False, 0, 128, 128),    # cross, Sq < 64
    (1, 2, 1, 300, 70, 128, False, 0, 64, 64),      # cross, Sq > Skv
    (1, 2, 2, 1000, 1000, 128, True, 200, 128, 128),  # window: tiles empty
    (1, 4, 2, 700, 700, 64, False, 150, 64, 64),    # window, no causal
    (1, 4, 2, 1, 257, 128, True, 0, 128, 128),      # one query row
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
    with record() as launches:
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=bq, block_k=bk)
    assert ops.launch_counts()["flash_attention"] == 1
    assert [f.name for f in launches] == [KERNELS[dtype]]
    want = flash_attention_reference(q, k, v, causal=causal, window=window,
                                     block_q=bq, block_k=bk)
    rtol, atol = KERNEL_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [None, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FA_CASES[:8], ids=str)
def test_flash_attention_kernel_takes_scale_and_float16_on_card(case, dtype,
                                                                scale):
    _need_card()
    B, H, KV, Sq, Skv, hd, causal, window, bq, bk = case
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt).cuda() for a in
               make_attention_inputs(B, H, KV, Sq, Skv, hd, dtype, 5))
    with record() as launches:
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=bq, block_k=bk, scale=scale)
    assert [f.name for f in launches] == [KERNELS[dtype]]
    want = flash_attention_reference(q, k, v, causal=causal, window=window,
                                     block_q=bq, block_k=bk, scale=scale)
    assert got.dtype == dt
    rtol, atol = KERNEL_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_flash_attention_bf16_rejects_misaligned_inputs():
    """TMA needs 16-byte aligned tensors: an offset view raises (no
    fallback to another kernel)."""
    _need_card()
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device="cuda")
    flat = torch.zeros(1 + q.numel(), dtype=torch.bfloat16, device="cuda")
    odd = flat[1:].view(q.shape)
    assert odd.data_ptr() % 16
    ops.reset_launches()
    for args in ((odd, q, q), (q, odd, q), (q, q, odd)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(*args)
    assert ops.launch_counts()["flash_attention"] == 0


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
    "local_sort": [(8, 1000, "int32"), (3, 3 * TILE + 7, "float32"),
                   (3, 37 * TILE + 11, "int32"), (3, 5 * TILE + 3, "int8"),
                   (2, 300, "bfloat16"), (3, 3 * TILE + 7, "uint32"),
                   (2, 3 * TILE + 1, "uint16")],
    # merge_split (keep modes), then merge_runs (full mode, strided probe)
    "merge_split": [(8, 5000, "int32"), (16, 2049, "float32"),
                    (2, 9000, "uint8"), (4, 3000, "bfloat16", 7000),
                    (3, 100, "int8", 0), (2, 5 * 8192 + 17, "float16", 9),
                    (2, 9000, "uint32"), (2, 300, "uint16", 77)],
    "localised_copy": [(1003, 3, "bfloat16", True), (4097, 1, "float32",
                                                     False)],
    "flash_attention": [(1, 4, 2, 200, 200, 32, 64, 64, True, 0, "float32"),
                        (1, 2, 2, 512, 512, 128, 128, 128, True, 64,
                         "bfloat16"),
                        (2, 4, 2, 200, 77, 64, 128, 64, True, 48,
                         "bfloat16"),
                        (1, 2, 1, 40, 300, 16, 64, 64, False, 0,
                         "bfloat16"),
                        (1, 4, 2, 200, 200, 64, 64, 64, True, 0, "float16",
                         0.1)],
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


# ---------------------------------------------------------------------------
# the serving slice: the model's prefill through the kernel, the server
# ---------------------------------------------------------------------------
#: the prefill's logits through the kernel against the plain chunked form,
#: as the largest difference over the largest |logit|, at two layers (the
#: kernel's P is a bf16 hi + lo pair where the chunked form rounds it
#: once; float32 differs only in the order of the sums).  chip_smoke.py's
#: LOGIT_TOL holds the full-width model, with planted faults beside it
LOGIT_TOL = {"bfloat16": 2.0 ** -4, "float32": 2.0 ** -12}


def _serving_model(dtype: str, layers: int = 2):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import LM
    cfg = reduce_config(get_config("qwen3-0.6b"), layers=layers).replace(
        dtype=dtype, param_dtype=dtype)
    return cfg, LM(cfg).init(torch.Generator().manual_seed(3))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_through_kernel_matches_plain_chunked_on_card(dtype):
    """`LM.prefill` on the card runs `flash_attention` once a layer, and
    its logits stay within `LOGIT_TOL` of the plain chunked form's."""
    _need_card()
    from repro_torch.models import LM
    cfg, params = _serving_model(dtype)
    params = _to(params, "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 77))).cuda()
    ops.reset_launches()
    got, caches = LM(cfg).prefill(params, {"tokens": toks}, max_len=96)
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    want, plain_caches = LM(cfg, flash=False).prefill(
        params, {"tokens": toks}, max_len=96)
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    err = float((got.float() - want.float()).abs().max())
    assert err <= LOGIT_TOL[dtype] * float(want.float().abs().max()), err
    assert torch.equal(caches["m0"]["kpos"], plain_caches["m0"]["kpos"])


@pytest.mark.gpu
def test_decode_server_on_card_matches_cpu():
    """A reduced float32 server on the card: the CPU's tokens in both modes,
    paged tokens equal across the policies, one `flash_attention` launch a
    layer for each aligned prefill wave and none in the paged mode."""
    _need_card()
    from repro_torch.convert import make_serve_stream
    from repro_torch.runtime.server import DecodeServer, Request
    cfg, params = _serving_model("float32")
    reqs = make_serve_stream(12, cfg.vocab_size, (3, 30), sessions=3,
                             new_tokens=(2, 6), slots=4, seed=1, prefix=8)
    homed = Locale(HomeMesh({"data": 2}), "data")
    cpu_homed = Locale(HomeMesh({"data": 2}, device="cpu"), "data")
    for pad in (None, 32):
        outs = {}
        for device, loc in (("cuda", homed), ("cpu", cpu_homed)):
            for policy in ("fifo", "homed"):
                srv = DecodeServer(cfg, _to(params, device), batch_slots=4,
                                   max_len=48, locale=loc, scheduler=policy,
                                   prompt_pad=pad, page_size=8 if pad else None)
                for d in reqs:
                    srv.submit(Request(**d))
                ops.reset_launches()
                outs[device, policy] = {r.rid: r.out for r in srv.run()}
                flash = ops.launch_counts()["flash_attention"]
                waves = srv.scheduler.stats.waves
                if device == "cuda":
                    assert flash == (0 if pad else cfg.num_layers * waves)
        assert outs["cuda", "fifo"] == outs["cpu", "fifo"]
        assert outs["cuda", "homed"] == outs["cpu", "homed"]
        if pad:
            assert outs["cuda", "fifo"] == outs["cuda", "homed"]


# ---------------------------------------------------------------------------
# the rest of the model stack: windowed and cross prefill through the
# kernel, every member on the card against the CPU
# ---------------------------------------------------------------------------
STACK_ARCHS = ["mixtral-8x7b", "deepseek-moe-16b", "mamba2-2.7b",
               "jamba-1.5-large-398b", "llama-3.2-vision-90b"]


def _stack_model(name: str, dtype: str = "float32"):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import LM
    cfg = reduce_config(get_config(name)).replace(dtype=dtype,
                                                  param_dtype=dtype)
    return cfg, LM(cfg).init(torch.Generator().manual_seed(4))


def _stack_batch(cfg, B: int, S: int, device):
    rng = np.random.default_rng(5)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        b["image_embeds"] = torch.from_numpy((0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)).to(
                getattr(torch, cfg.dtype))
    return _to(b, device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,S", [("mixtral-8x7b", 64),
                                    ("mixtral-8x7b", 40),
                                    ("llama-3.2-vision-90b", 33)])
def test_windowed_and_cross_prefill_through_kernel_on_card(name, S, dtype):
    """`LM.prefill` of a sliding-window config (S a multiple of the
    window and not) and of the vision config launches `flash_attention`
    once an attention layer -- windowed, and non-causal over the image
    tokens (Sq != Skv) in the cross layers -- and its logits stay within
    `LOGIT_TOL` of the plain chunked (banded) form's."""
    _need_card()
    from repro_torch.models import LM
    cfg, params = _stack_model(name, dtype)
    params = _to(params, "cuda")
    b = _stack_batch(cfg, 3, S, "cuda")
    ops.reset_launches()
    with record() as launches:
        got, caches = LM(cfg).prefill(params, b, max_len=S + 8)
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    calls = {f.call[1][3:5] + f.call[1][8:10] for f in launches}
    if cfg.sliding_window:
        assert calls == {(S, S, True, cfg.sliding_window)}
    else:
        assert calls == {(S, S, True, 0),
                         (S, cfg.num_image_tokens, False, 0)}
    want, plain_caches = LM(cfg, flash=False).prefill(params, b,
                                                      max_len=S + 8)
    err = float((got.float() - want.float()).abs().max())
    assert err <= LOGIT_TOL[dtype] * float(want.float().abs().max()), err
    assert torch.equal(caches["m0"]["kpos"], plain_caches["m0"]["kpos"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", STACK_ARCHS)
def test_stack_on_card_matches_cpu(name):
    """A reduced float32 model of each new member kind on the card --
    prefill through the kernel, MoE, Mamba2 state steps, ring and cross
    caches -- against the same on the CPU: logits, aux and every cache
    leaf within rtol 1e-4, atol 1e-5, positions exact."""
    _need_card()
    from repro_torch.models import LM
    cfg, params = _stack_model(name)
    m = LM(cfg)
    out = {}
    for device in ("cpu", "cuda"):
        p = _to(params, device)
        b = _stack_batch(cfg, 2, 32, device)
        first = {k: v if k == "image_embeds" else v[:, :16]
                 for k, v in b.items()}
        logits, _, aux = m.forward(p, b)
        last, caches = m.prefill(p, first, max_len=32)
        got = [logits, aux, last]
        for pos in range(16, 20):
            lg, caches = m.decode_step(p, caches,
                                       {"tokens": b["tokens"][:, pos:pos + 1]},
                                       pos)
            got.append(lg)
        out[device] = got + [leaf for sub in caches.values()
                             for leaf in sub.values()]
    for a, c in zip(out["cpu"], out["cuda"]):
        if a.dtype == torch.int32:
            assert torch.equal(a, c.cpu())
        else:
            np.testing.assert_allclose(c.cpu().float().numpy(),
                                       a.float().numpy(), rtol=1e-4,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(remat):
    """One train step of the reduced float32 qwen3-0.6b on the card against
    the same step on the CPU, from the same parameters and batch (the
    pipeline's, born on each device): the loss within rtol 1e-5, the
    gradient norm within rtol 1e-4, AdamW's first moment (0.1 x the
    clipped gradient after one step from zero) within rtol 1e-4, atol
    1e-6 x each leaf's largest value; no kernel launched.  With `remat`
    the superblocks are rematerialised, which must not change the step."""
    _need_card()
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.models.steps import init_opt_state, make_train_step
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.sharding.partition import NULL_PLAN
    from repro_torch.tree import tree_leaves, tree_map
    cfg = reduce_config(get_config("qwen3-0.6b"))
    cfg = cfg.replace(parallel=cfg.parallel.__class__(remat=remat))
    params = LM(cfg).init(torch.Generator().manual_seed(5))
    out = {}
    for device in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(device, copy=True),  # updated in place
                     params)
        opt = AdamW(lr=cosine_schedule(3e-4, 2, 10))
        state = init_opt_state(cfg, opt, p)
        step = make_train_step(LM(cfg, flash=False), cfg, NULL_PLAN, opt)
        batch = SyntheticLM(cfg, 4, 64, seed=2, device=device).batch(0)
        ops.reset_launches()
        _, state, met = step(p, state, batch)
        assert not any(ops.launch_counts().values())
        out[device] = met, state
    (mc, sc), (mg, sg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mg["grad_norm"]), float(mc["grad_norm"]),
                               rtol=1e-4)
    for g, c in zip(tree_leaves(sg["adam"]["m"]), tree_leaves(sc["adam"]["m"])):
        c = c.numpy()
        np.testing.assert_allclose(g.cpu().numpy(), c, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(c).max()))


@pytest.mark.gpu
def test_flash_attention_refuses_autograd_on_card():
    """The kernel has no backward pass: under autograd its wrapper raises
    before launching, and so does `LM(cfg)`'s prefill attention; without
    grad the same call launches it."""
    _need_card()
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import LM
    from repro_torch.models.steps import make_loss_fn
    from repro_torch.tree import tree_leaves
    q, k, v = (torch.from_numpy(a).cuda() for a in
               make_attention_inputs(1, 4, 2, 64, 64, 32, "float32", 0))
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="no backward pass"):
        ops.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert ops.launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True)
    assert ops.launch_counts()["flash_attention"] == 1

    cfg = reduce_config(get_config("qwen3-0.6b"))
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    LM(cfg).prefill(params, batch)                  # serving: the kernel
    assert ops.launch_counts()["flash_attention"] == 1 + cfg.num_layers
    for t in tree_leaves(params):
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        make_loss_fn(LM(cfg), cfg)(params, batch)
    loss, _ = make_loss_fn(LM(cfg, flash=False), cfg)(params, batch)
    loss.backward()
    assert ops.launch_counts()["flash_attention"] == 1 + cfg.num_layers




def _two_ranks_on_card(device, n, seed):
    """A rank of the card test below: the 8 cases, int32 and float32, on
    a 2-rank `RankMesh` of the card (gloo, staged exchanges)."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.mesh import RankMesh
    mesh = RankMesh({"data": 2}, device=device)
    out = {}
    for k, c in CASES.items():
        policy = LocalisationPolicy(c.localised, c.static_mapping,
                                    Homing(c.homing))
        fn = Locale(mesh, "data", policy).workload("sort",
                                                   backend="shard_map")
        for dt in ("int32", "float32"):
            shard = fn.place(torch.from_numpy(make_sort_data(n, dt,
                                                             seed + k)))
            ops.reset_launches()
            coll.reset_collectives()
            y = fn(shard)
            torch.cuda.synchronize()
            out[(k, dt)] = {"row": nbits(y.data), "homing": y.homing.value,
                            "launches": ops.launch_counts(),
                            "staged": coll.staged_bytes(),
                            "log": coll.collective_log()}
    return out


@pytest.mark.gpu
def test_rank_engine_on_card_matches_home_mesh():
    """Two gloo ranks sharing the card, each launching the kernels on its
    own row, give row r of the one-process HomeMesh engine's result bit
    for bit; every exchange is staged through pinned host memory."""
    _need_card()
    from repro_torch.core.engine import engine_granule
    from repro_torch.core.sort import pad_to_multiple
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn
    _build.build(("local_sort", "merge_split"))    # once, before the ranks
    n, seed = (1 << 16) + 5, 41
    ranks = spawn(_two_ranks_on_card, 2, "gloo", "cuda", n, seed)
    for k, c in CASES.items():
        policy = LocalisationPolicy(c.localised, c.static_mapping,
                                    Homing(c.homing))
        hash_homed = policy.homing == Homing.HASH_INTERLEAVED
        for dt in ("int32", "float32"):
            x = torch.from_numpy(make_sort_data(n, dt, seed + k))
            y = Locale(HomeMesh({"data": 2}), "data", policy).workload(
                "sort", backend="shard_map")(x.cuda())
            padded = pad_to_multiple(y, engine_granule(2, None, hash_homed))
            homing = Homing.LOCAL_CHUNKED if c.localised else policy.homing
            rows = (padded.view(2, -1) if homing == Homing.LOCAL_CHUNKED
                    else padded.view(-1, 2).t())
            for r, res in enumerate(ranks):
                got = res[(k, dt)]
                assert got["homing"] == homing.value
                np.testing.assert_array_equal(got["row"][0], nbits(rows[r]))
                if c.localised:
                    assert got["launches"]["local_sort"] == 1
                    assert got["launches"]["merge_split"] == 1
                assert got["staged"] == sum(rec["staged_bytes"]
                                            for rec in got["log"]) > 0
                for rec in got["log"]:        # a permute stages out and in
                    if rec["kind"] == "collective-permute":
                        assert rec["staged_bytes"] == 2 * rec["wire_bytes"]


#: Fig 1 on the card's ranks: the three policies of `repetitive_copy`
FIG1_POLICIES = {"localised": (True, True, "local"),
                 "nonlocalised": (False, True, "hash"),
                 "auto": (False, False, "hash")}


def _four_ranks_tree_on_card(device, n, seed, reps):
    """A rank of the two card tests below, on a 4-rank `RankMesh` of the
    card (gloo, staged exchanges): the constraint tree for the 8 cases,
    int32 and float32, and the microbench under the Fig-1 policies."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.mesh import RankMesh
    mesh = RankMesh({"data": 4}, device=device)
    out = {"sort": {}, "fig1": {}}
    for k, c in CASES.items():
        fn = Locale(mesh, "data", LocalisationPolicy(
            c.localised, c.static_mapping, Homing(c.homing))).workload("sort")
        for dt in ("int32", "float32"):
            share = fn.place(torch.from_numpy(make_sort_data(n, dt,
                                                             seed + k)))
            ops.reset_launches()
            coll.reset_collectives()
            y = fn(share)
            torch.cuda.synchronize()
            out["sort"][k, dt] = {"row": nbits(y.data), "layout": y.layout,
                                  "n": y.n, "launches": ops.launch_counts(),
                                  "staged": coll.staged_bytes(),
                                  "log": coll.collective_log()}
    x = torch.from_numpy(make_fig1_data(n - 5, "float32", seed))
    for name, (loc, static, h) in FIG1_POLICIES.items():
        fn = Locale(mesh, "data", LocalisationPolicy(
            loc, static, Homing(h))).workload("microbench", reps=reps)
        chunk = fn.place(x)
        ops.reset_launches()
        coll.reset_collectives()
        y = fn(chunk)
        torch.cuda.synchronize()
        out["fig1"][name] = {"chunk": bits(y), "launches": ops.launch_counts(),
                             "log": coll.collective_log()}
    return out


@pytest.fixture(scope="module")
def tree_ranks_on_card():
    """Four gloo ranks sharing the card, one spawn for both tests."""
    _need_card()
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn
    _build.build(("local_sort", "merge_split", "localised_copy"))
    n, seed, reps = (1 << 16) + 5, 43, 3
    return n, seed, reps, spawn(_four_ranks_tree_on_card, 4, "gloo", "cuda",
                                n, seed, reps)


@pytest.mark.gpu
def test_rank_constraint_sort_on_card_matches_home_mesh(tree_ranks_on_card):
    """The default workload("sort") on four gloo ranks sharing the card:
    each rank holds the one-process HomeMesh tree's elements under the
    final layout bit for bit, its collectives are `constraint_schedule`'s
    op for op (staged through pinned host memory), and it launches
    `local_sort` and `merge_runs` where the layouts put rows: every rank
    one leaf sort; the merges on each pair's leader ([2, 0, 1, 0] at 4
    homes), or on every rank under replicated (case 4)."""
    from repro_torch.core.collectives import log_against_moves
    from repro_torch.core.homing import positions
    from repro_torch.core.sort import constraint_schedule, pad_to_multiple
    n, seed, _, ranks = tree_ranks_on_card
    for k, c in CASES.items():
        policy = LocalisationPolicy(c.localised, c.static_mapping,
                                    Homing(c.homing))
        replicated = c.static_mapping and not c.localised \
            and c.homing == "local"
        for dt in ("int32", "float32"):
            x = torch.from_numpy(make_sort_data(n, dt, seed + k))
            y = Locale(HomeMesh({"data": 4}), "data", policy).workload(
                "sort")(x.cuda())
            sched = constraint_schedule(n, (4,), policy)
            for r, res in enumerate(ranks):
                got = res["sort"][k, dt]
                padded = pad_to_multiple(y, got["n"], nan_check=False)
                idx = positions(got["n"], got["layout"], r, "cuda")
                np.testing.assert_array_equal(got["row"], nbits(padded[idx]))
                assert log_against_moves(got["log"], sched, r, (4,)) == []
                assert got["staged"] == sum(rec["staged_bytes"]
                                            for rec in got["log"])
                assert got["launches"]["local_sort"] == 1
                assert got["launches"]["merge_runs"] == (
                    2 if replicated else [2, 0, 1, 0][r]), (k, dt, r)


@pytest.mark.gpu
def test_rank_microbench_on_card_matches_home_mesh(tree_ranks_on_card):
    """The Fig-1 workload on four gloo ranks sharing the card: each rank's
    chunk bit for bit the one-process microbench's, R `localised_copy`
    launches a rank, and its wire bytes the one-process relayout bytes
    / 4 (2R all-to-alls under static non-localised mapping, none
    otherwise)."""
    from repro_torch.core.homing import relayout_counts, reset_relayouts
    n, seed, reps, ranks = tree_ranks_on_card
    x = torch.from_numpy(make_fig1_data(n - 5, "float32", seed)).cuda()
    for name, (loc, static, h) in FIG1_POLICIES.items():
        reset_relayouts()
        y = Locale(HomeMesh({"data": 4}), "data", LocalisationPolicy(
            loc, static, Homing(h))).workload("microbench", reps=reps)(x)
        home_bytes = relayout_counts()["bytes"]
        for r, res in enumerate(ranks):
            got = res["fig1"][name]
            np.testing.assert_array_equal(got["chunk"],
                                          bits(y.view(4, -1)[r]))
            assert got["launches"]["localised_copy"] == reps
            assert 4 * sum(rec["wire_bytes"] for rec in got["log"]) \
                == home_bytes
            assert len(got["log"]) == (2 * reps if name == "nonlocalised"
                                       else 0)


# ---------------------------------------------------------------------------
# serving across ranks: the kernel at a rank's heads, two ranks on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("heads,kv", [(8, 4), (16, 8)])
def test_flash_attention_at_head_split_shapes_on_card(heads, kv):
    """`flash_attention` at a rank's share of qwen3-0.6b's 16 heads / 8 KV
    heads (bf16, hd 128): the q heads and the KV heads they read sliced
    out of the whole projections (strided views) and made contiguous, as
    `models.attention.flash_prefill_attention` hands them over, against
    the plain version within `KERNEL_TOL`."""
    _need_card()
    from repro_torch.models.attention import flash_prefill_attention
    B, S, hd = 2, 753, 128
    rng = np.random.default_rng(heads)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, hd)).astype(
        np.float32)).to(torch.bfloat16).cuda() for n in (16, 8, 8))
    lo = 16 - heads                              # the last rank's heads
    qs = q[:, :, lo:]
    ks, vs = k[:, :, lo // 2:], v[:, :, lo // 2:]
    assert not qs.is_contiguous() or heads == 16
    ops.reset_launches()
    got = flash_prefill_attention(qs.reshape(B, S, kv, 2, hd), ks, vs)
    assert ops.launch_counts()["flash_attention"] == 1
    want = flash_attention_reference(
        qs.transpose(1, 2).contiguous(), ks.transpose(1, 2).contiguous(),
        vs.transpose(1, 2).contiguous(), causal=True).transpose(1, 2)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _two_rank_serve(device):
    """A rank of the card test below: reduced float32 qwen3-0.6b served on
    {"data": 1, "model": 2} (heads, KV heads, MLP and vocabulary split)
    on `device`, then on the CPU; tokens, logits and launches."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import make_serve_stream, rank_params
    from repro_torch.core.mesh import RankMesh
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.sharding.partition import make_plan
    from repro_torch.models import LM
    cfg, whole = _serving_model("float32")
    reqs = make_serve_stream(12, cfg.vocab_size, (3, 30), sessions=3,
                             new_tokens=(2, 6), slots=4, seed=1, prefix=8)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 19)))
    out = {}
    for dev in (device, "cpu"):
        mesh = RankMesh({"data": 1, "model": 2}, device=dev)
        plan = make_plan(mesh, cfg, ShapeSpec("s", 48, 4, "decode"))
        params = _to(rank_params(whole, plan, cfg), mesh.device)
        res = {}
        for pad in (None, 32):
            srv = DecodeServer(cfg, params, batch_slots=4, max_len=48,
                               plan=plan, prompt_pad=pad,
                               page_size=8 if pad else None)
            for d in reqs:
                srv.submit(Request(**d))
            ops.reset_launches()
            res[pad] = ({r.rid: r.out for r in srv.run()},
                        ops.launch_counts()["flash_attention"],
                        srv.scheduler.stats.waves)
        last, _ = LM(cfg).prefill(params, {"tokens": toks.to(mesh.device)},
                                  max_len=48, plan=plan)
        out[mesh.device.type] = (res, last.cpu())
    return out


@pytest.mark.gpu
def test_two_rank_serve_on_card_matches_cpu():
    """Two gloo ranks sharing the card serve reduced float32 qwen3-0.6b
    with the model split over "model": in both modes the CPU ranks'
    tokens, each rank's logit block within rtol 1e-4 / atol 1e-5 of its
    CPU block, and one `flash_attention` launch a layer on each rank for
    each aligned prefill wave."""
    _need_card()
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn
    _build.build(("flash_attention",))
    layers = 2
    for res in spawn(_two_rank_serve, 2, "gloo", "cuda"):
        (card, card_last), (cpu, cpu_last) = res["cuda"], res["cpu"]
        for pad in (None, 32):
            assert card[pad][0] == cpu[pad][0]
            assert card[pad][1] == (0 if pad else layers * card[pad][2])
        torch.testing.assert_close(card_last, cpu_last, rtol=1e-4,
                                   atol=1e-5)


def _two_rank_train(device, arch):
    """A rank of the card test below: reduced float32 `arch` with FSDP,
    the sequence-sharded residual, remat and 2 microbatches, on {"data":
    1, "model": 2} (the model split) and on {"data": 2, "model": 1}
    (FSDP's gathers), two steps on `device`, then on the CPU: metrics,
    parameter blocks and `flash_attention` launches."""
    from repro_torch.configs import base
    from repro_torch.convert import rank_params
    from repro_torch.core.mesh import RankMesh
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import LM, steps
    from repro_torch.optim import AdamW
    from repro_torch.sharding.partition import make_plan
    from repro_torch.tree import tree_items, tree_map
    cfg = base.reduce_config(base.get_config(arch))
    cfg = cfg.replace(parallel=base.ParallelConfig(
        fsdp=True, sequence_shard=True, remat=True, microbatches=2))
    whole = LM(cfg).init(torch.Generator().manual_seed(0))
    out = {}
    for shape in ({"data": 1, "model": 2}, {"data": 2, "model": 1}):
        for dev in (device, "cpu"):
            mesh = RankMesh(shape, device=dev)
            plan = make_plan(mesh, cfg, base.ShapeSpec("t", 32, 4, "train"))
            # a copy: the step updates in place, and a leaf left whole is
            # `whole`'s own tensor
            params = _to(tree_map(torch.clone, rank_params(
                whole, plan, cfg, train=True)), mesh.device)
            opt = AdamW(lr=1e-3)
            state = steps.init_opt_state(cfg, opt, params, plan)
            fn = steps.make_train_step(LM(cfg, flash=False), cfg, plan, opt)
            data = SyntheticLM(cfg, 4, 32, 0, mesh)
            ops.reset_launches()
            metrics = []
            for i in range(2):
                params, state, m = fn(params, state, data.batch(i))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            out[str(shape), mesh.device.type] = (
                metrics, {"/".join(p): t.detach().cpu() for p, t in
                          tree_items(params)},
                ops.launch_counts()["flash_attention"])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b"])
def test_two_rank_train_on_card_matches_cpu(arch):
    """Two gloo ranks sharing the card train reduced float32 qwen3-0.6b
    (dense) and mixtral-8x7b (MoE) with FSDP, the sequence-sharded
    residual, remat and 2 microbatches, split over "model" and over
    "data": each step's loss and norm within rtol 1e-5 of the CPU
    ranks', each rank's parameter blocks within rtol 1e-4 / atol 1e-5 of
    its CPU blocks after two steps (but for at most 0.1 % of the
    elements, each within two steps' learning rate), no
    `flash_attention` launch."""
    _need_card()
    from repro_torch.launch.mesh import spawn
    for res in spawn(_two_rank_train, 2, "gloo", "cuda", arch):
        for shape in ({"data": 1, "model": 2}, {"data": 2, "model": 1}):
            card, cpu = res[str(shape), "cuda"], res[str(shape), "cpu"]
            np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
            for k, t in card[1].items():
                # AdamW's step turns on the rounding where a gradient
                # element is near zero: at most 0.1 % of the elements, each
                # within the most two runs move apart (lr a step)
                d = (t - cpu[1][k]).abs()
                off = d > 1e-5 + 1e-4 * cpu[1][k].abs()
                assert off.float().mean() <= 1e-3, (k, int(off.sum()))
                assert (d[off] <= 2 * 1e-3 * 2).all(), (k, float(d.max()))
            assert card[2] == cpu[2] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 16, 2, 512, 4096, 128),
                                  (1, 4, 1, 40, 24, 16)], ids=str)
def test_cross_flash_attention_at_a_ranks_heads_on_card(case):
    """The non-causal kernel at a rank's heads of the vision config's cross
    layer on ``{"data": 2, "model": 4}`` -- one row, 16 q and 2 KV heads,
    512 queries over 4096 image tokens -- and of its reduced config on 4
    "model" ranks, bf16: its plain version's within `KERNEL_TOL`."""
    _need_card()
    B, H, KV, Sq, Skv, hd = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).cuda() for a in
               make_attention_inputs(B, H, KV, Sq, Skv, hd, "bfloat16", 5))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=False)
    assert ops.launch_counts()["flash_attention"] == 1
    want = flash_attention_reference(q, k, v, causal=False)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


#: the sequence-homed decode on the card: reduced qwen3-0.6b (float32),
#: one slot, a cache of 8192 positions (over "data": the slot does not
#: divide over 2 homes, 4096 slots a rank), a prompt spanning both blocks
SEQ_CARD = dict(max_len=8192, S=4100, steps=3)


def _seq_homed_decode(device, toks, fed):
    """A rank of the card test below: its logits of the prefill and decode
    steps, its log against `serve_schedule`, its cache block's shape."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_params
    from repro_torch.core import collectives as coll
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models import LM
    from repro_torch.obs.schedule import log_against_serve, serve_schedule
    from repro_torch.sharding.partition import make_plan
    from repro_torch.tree import tree_map
    mesh = RankMesh({"data": 2}, device=device)
    cfg = reduce_config(get_config("qwen3-0.6b"))
    plan = make_plan(mesh, cfg, ShapeSpec("serve", SEQ_CARD["max_len"], 1,
                                          "decode"))
    assert plan.cache_seq_axis == "data"
    params = tree_map(lambda t: t.to(mesh.device), rank_params(
        LM(cfg).init(torch.Generator().manual_seed(0)), plan, cfg))
    m = LM(cfg)
    coll.reset_collectives()
    last, caches = m.prefill(params, {"tokens": toks.to(mesh.device)},
                             max_len=SEQ_CARD["max_len"], plan=plan)
    logits = [last]
    calls = [{"call": "prefill", "rows": 1, "seq": toks.shape[1]}]
    for t in range(fed.shape[1]):
        lg, caches = m.decode_step(params, caches, {
            "tokens": fed[:, t:t + 1].to(mesh.device)}, toks.shape[1] + t,
            plan=plan)
        logits.append(lg)
        calls.append({"call": "decode", "rows": 1, "seq": 1})
    return {"logits": torch.stack(logits).cpu(),
            "schedule": log_against_serve(coll.collective_log(),
                                          serve_schedule(cfg, plan, calls)),
            "block": tuple(caches["m0"]["k"].shape)}


@pytest.mark.gpu
def test_sequence_homed_decode_on_two_ranks_of_the_card():
    """Two gloo ranks sharing the card, each holding half of the decode
    cache's 8192 slots: a prefill whose keys span both blocks and decode
    steps, merged across the ranks, give one process's logits on the card
    within rtol 1e-4 / atol 1e-5 (float32), with every log equal to
    `serve_schedule`."""
    _need_card()
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import LM
    cfg = reduce_config(get_config("qwen3-0.6b"))
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, SEQ_CARD["S"])))
    fed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, SEQ_CARD["steps"])))
    from repro_torch.tree import tree_map
    params = tree_map(lambda t: t.cuda(), LM(cfg).init(
        torch.Generator().manual_seed(0)))
    m = LM(cfg)
    last, caches = m.prefill(params, {"tokens": toks.cuda()},
                             max_len=SEQ_CARD["max_len"])
    want = [last]
    for t in range(fed.shape[1]):
        lg, caches = m.decode_step(params, caches, {
            "tokens": fed[:, t:t + 1].cuda()}, toks.shape[1] + t)
        want.append(lg)
    want = torch.stack(want).cpu()
    for res in spawn(_seq_homed_decode, 2, "gloo", "cuda", toks, fed):
        assert res["schedule"] == []
        assert res["block"][2] == SEQ_CARD["max_len"] // 2
        torch.testing.assert_close(res["logits"], want, rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# R10 and check_decode on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_r10_hog_with_the_allocator_on_the_card():
    """The hog's live scan gives the CPU's 64 MiB on the card, and the
    CUDA allocator's peak over the call agrees; both flag it at 32 MiB."""
    _need_card()
    from repro_torch.analysis import check_artifacts
    from repro_torch.analysis.fixtures import hbm_hog, hbm_hog_input
    from repro_torch.analysis.mem_facts import call_facts
    _, card = call_facts(hbm_hog, hbm_hog_input())
    _, cpu = call_facts(hbm_hog, hbm_hog_input("cpu"))
    assert card["liveness"]["peak_bytes"] == cpu["liveness"]["peak_bytes"] \
        == 64 * 2 ** 20
    assert card["memory_stats"]["allocated_bytes.all.peak"] == 64 * 2 ** 20
    rep = check_artifacts("r10-hog", [], mem_facts=card,
                          hbm_ceiling=32 * 2 ** 20, rules="R10")
    assert [f.rule for f in rep.errors] == ["R10"]
    assert rep.errors[0].actual_bytes == 64 * 2 ** 20


@pytest.mark.gpu
def test_check_decode_on_the_card():
    """`check_decode` at its defaults on the card: clean, the scheduler's
    fast corner certified with the CPU's state count, the step's peak
    read by the allocator too."""
    _need_card()
    from repro_torch.analysis import FAST_LATTICE, certify_lattice, \
        check_decode
    rep = check_decode()
    assert rep.clean, rep.format(verbose=True)
    assert rep.context["device"].startswith("cuda")
    states = sum(r["states"] for r in certify_lattice(FAST_LATTICE).values())
    assert states == 59169
    assert any(f"{states} canonical states" in n for n in rep.notes)
    assert any(n.startswith("R10: device-live-range ok") for n in rep.notes)
