"""The port's kernel analyser (R3/R5/R6/R7/R8) against the JAX reference's.

The four mutant kernels of `repro/analysis/fixtures.py` run in the port
(`repro_torch.kernels.fixtures`; on the CPU their plain versions) under
`launches.record()`, and the port's rules over the recorded launches
must give the reference's findings by rule, severity and kind ("write
race", "coverage gap", "out-of-bounds read", "dead lane").  The
reference's facts are rebuilt here from its traced programs: under the
installed jax its `pallas_call_facts` and `_footprint` read
`BlockMapping.array_shape_dtype`, since renamed `array_aval`, so
`ref_facts` / `ref_footprints` are the same walks reading `array_aval`;
the reference's own rule functions then run on them.

Tolerance: the plain mutants equal the interpret-mode outputs bit for bit
(floats compared as int32 bits), except the stated difference of
`oob_index_map`: rows 0-1 equal, rows 2-3 read the port's NaN guard band
where Pallas clamps the block index to x[3].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (must precede repro.kernels imports)
from repro.analysis import certify_supported_meshes as ref_certify
from repro.analysis import fixtures as ref_fixtures
from repro.analysis.findings import RULES as REF_RULES
from repro.analysis.findings import Report as RefReport
from repro.analysis.findings import Severity as RefSeverity
from repro.analysis.kernelcheck import r5_block_coverage as ref_r5
from repro.analysis.kernelcheck import r7_index_arith as ref_r7
from repro.analysis.kernelcheck import r8_dead_lanes as ref_r8
from repro.analysis.rules import r3_vmem_budget as ref_r3
from repro.analysis.vmem import (OperandFacts as RefOperand, PallasCallFacts,
                                 PallasFootprint, _aval_bytes, _block_numel,
                                 _index_map_fn, _walk_pallas_calls)
from repro.kernels import VMEM_BYTES_PER_CORE
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.local_sort import local_sort as jlocal_sort
from repro_torch.analysis import (RULES, Report, Severity,
                                  certify_supported_meshes, check_artifacts,
                                  check_workload, normalize_rules, record,
                                  zero_one_certify)
from repro_torch.analysis import homecheck as port_homecheck
from repro_torch.analysis.fixtures import (inverted_keep_network,
                                           mutant_launches,
                                           nonbijective_network)
from repro_torch.analysis.kernelcheck import (_check_sentinel,
                                              r5_block_coverage,
                                              r7_index_arith, r8_dead_lanes)
from repro_torch.analysis.launches import (LaunchFacts, OperandFacts,
                                           stack_tiles)
from repro_torch.analysis.netverify import _substage_findings
from repro_torch.analysis.probe import image, poisoned, written
from repro_torch.analysis.rules import r3_smem_budget
from repro_torch.core import HomeMesh, Homing, Locale, LocalisationPolicy
from repro_torch.kernels import SMEM_BYTES_PER_BLOCK, ops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import local_sort as tlocal_sort
from repro_torch.kernels import merge_split as tmerge_split
from repro_torch.kernels.fixtures import mutant_reference
from repro_torch.launch import homecheck as cli

KINDS = ("write race", "coverage gap", "out-of-bounds read", "dead lane")


# ---------------------------------------------------------------------------
# the reference's facts, rebuilt to read `array_aval`
# ---------------------------------------------------------------------------
def ref_facts(jaxpr_like):
    """`repro.analysis.vmem.pallas_call_facts`, reading `array_aval`."""
    out = []

    def on_eqn(eqn):
        gm = eqn.params["grid_mapping"]
        n_in = int(gm.num_inputs)
        ops_ = []
        for k, bm in enumerate(gm.block_mappings):
            sd = bm.array_aval
            block = tuple(None if d is None
                          else int(getattr(d, "block_size", d))
                          for d in bm.block_shape)
            ops_.append(RefOperand(
                role="in" if k < n_in else "out",
                array_shape=tuple(int(s) for s in sd.shape),
                dtype=str(np.dtype(sd.dtype)), block_shape=block,
                index_map=_index_map_fn(bm)))
        out.append(PallasCallFacts(
            name="pallas_call", grid=tuple(gm.grid),
            inputs=tuple(o for o in ops_ if o.role == "in"),
            outputs=tuple(o for o in ops_ if o.role == "out"),
            kernel_jaxpr=eqn.params.get("jaxpr"),
            static_grid=all(isinstance(g, (int, np.integer))
                            for g in gm.grid)))

    _walk_pallas_calls(jaxpr_like, on_eqn)
    return out


def ref_footprints(jaxpr_like):
    """`repro.analysis.vmem.pallas_footprints`, reading `array_aval`."""
    out = []

    def on_eqn(eqn):
        gm = eqn.params["grid_mapping"]
        blocks, block_bytes = [], 0
        for bm in gm.block_mappings:
            dtype = np.dtype(bm.array_aval.dtype)
            block_bytes += _block_numel(bm.block_shape) * dtype.itemsize
            blocks.append((bm.block_shape, str(dtype)))
        n_scratch = getattr(gm, "num_scratch_operands", 0)
        scratch = sum(_aval_bytes(v.aval) for v in
                      eqn.params["jaxpr"].invars[-n_scratch:]) \
            if n_scratch else 0
        out.append(PallasFootprint("pallas_call", tuple(gm.grid),
                                   block_bytes, scratch, tuple(blocks)))

    _walk_pallas_calls(jaxpr_like, on_eqn)
    return out


def kind_of(message: str) -> str:
    return next(k for k in KINDS if k in message)


def ref_findings(jaxpr_like):
    rep = RefReport(target="ref")
    facts = ref_facts(jaxpr_like)
    assert facts
    ref_r3(rep, ref_footprints(jaxpr_like), VMEM_BYTES_PER_CORE)
    ref_r5(rep, facts)
    ref_r7(rep, facts)
    ref_r8(rep, facts)
    return rep


def port_findings(launches):
    rep = Report(target="port")
    assert launches
    r3_smem_budget(rep, launches, SMEM_BYTES_PER_BLOCK)
    r5_block_coverage(rep, launches)
    r7_index_arith(rep, launches)
    r8_dead_lanes(rep, launches)
    return rep


def signature(findings):
    return sorted((f.rule, f.severity.name, kind_of(f.message))
                  for f in findings)


MUTANTS = ("overlapping_index_map", "gapped_index_map", "oob_index_map",
           "dead_lane_kernel")
#: the reference's findings on its fixtures (rebuilt facts), as pinned
EXPECTED = {
    "overlapping_index_map": [("R5", "ERROR", "write race"),
                              ("R5", "WARN", "coverage gap")],
    "gapped_index_map": [("R5", "WARN", "coverage gap")],
    "oob_index_map": [("R5", "ERROR", "out-of-bounds read")],
    "dead_lane_kernel": [("R8", "WARN", "dead lane")],
}


@pytest.mark.parametrize("name", MUTANTS)
def test_mutant_findings_match_the_reference(name):
    ref = ref_findings(getattr(ref_fixtures, name)())
    _, launches = mutant_launches(name, device="cpu")
    port = port_findings(launches)
    assert signature(ref.findings) == EXPECTED[name], ref.format()
    assert signature(port.findings) == EXPECTED[name], port.format()
    assert ops.launch_counts()[name] == 0        # the CPU ran the plain one


def test_mutant_findings_name_the_same_places():
    """The race, the gap and the read land where the reference says:
    blocks 0 and 1 on row 0, cell (2, 0), block 2 reading row 4, lane 7."""
    msgs = {n: " ".join(
        f.message for f in
        port_findings(mutant_launches(n, device="cpu")[1]).findings)
        for n in MUTANTS}
    assert "blocks (0, 0, 0) and (1, 0, 0)" in msgs["overlapping_index_map"]
    assert "tile (0, 0)" in msgs["overlapping_index_map"]
    assert "cell (2, 0)" in msgs["overlapping_index_map"]
    assert "cell (2, 0)" in msgs["gapped_index_map"]
    assert "block (2, 0, 0) reads tile (4, 0)" in msgs["oob_index_map"]
    assert "blockIdx.x eq 7" in msgs["dead_lane_kernel"]


def _interpret(name, x):
    jx = getattr(ref_fixtures, name)()
    return np.asarray(jax.core.eval_jaxpr(jx.jaxpr, jx.consts,
                                          jnp.asarray(x))[0])


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


@pytest.mark.parametrize("name", MUTANTS)
def test_plain_mutants_match_interpret_mode(name):
    x = np.random.default_rng(13).standard_normal((4, 128)).astype(np.float32)
    want = _interpret(name, x)
    got, launches = mutant_launches(name, x=torch.from_numpy(x))
    got = got.numpy()
    if name == "oob_index_map":
        # stated difference: the port reads its NaN guard band where Pallas
        # clamps the block index (x[3])
        np.testing.assert_array_equal(_bits(got[:2]), _bits(want[:2]))
        np.testing.assert_array_equal(_bits(want[2:]), _bits(x[[3, 3]]))
        assert np.isnan(got[2:]).all()
        np.testing.assert_array_equal(_bits(got[:2]), _bits(x[2:]))
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    rows = {"overlapping_index_map": [1, 3], "gapped_index_map": [0, 1],
            "dead_lane_kernel": [0, 1, 2, 3]}.get(name)
    if rows is not None:        # the rows interpret mode writes, by source
        np.testing.assert_array_equal(got[:len(rows)], x[rows])
        assert np.isnan(got[len(rows):]).all()
    assert len(launches) == 1


def test_dead_lane_is_never_entered_on_the_cpu():
    x = torch.ones(4, 128)
    _, entered = mutant_reference("dead_lane", x)
    assert int(entered) == 0
    _, launches = mutant_launches("dead_lane_kernel", device="cpu")
    assert launches[0].lanes == ((0, "eq", 7),)


def test_mutant_launches_runs_on_the_card_by_default(monkeypatch):
    """Like every entry point: without a device it asks for the card and
    raises where there is none; ``device="cpu"`` runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mutant_launches("gapped_index_map")
    y, launches = mutant_launches("gapped_index_map", device="cpu")
    assert y.device.type == "cpu" and len(launches) == 1


# ---------------------------------------------------------------------------
# real kernels: clean in both packages
# ---------------------------------------------------------------------------
def test_real_kernels_clean_under_both_packages():
    jx = jax.make_jaxpr(jlocal_sort)(
        jax.ShapeDtypeStruct((4, 1024), jnp.float32))
    assert ref_findings(jx).clean
    q = jax.ShapeDtypeStruct((2, 2, 256, 64), jnp.float32)
    jx = jax.make_jaxpr(lambda q, k, v: jflash(q, k, v))(q, q, q)
    assert ref_findings(jx).clean
    for facts in (tlocal_sort.plan(4, 1024, "float32"),
                  tlocal_sort.plan(3, 3 * 16384 + 7, "int32"),
                  tmerge_split.plan(2, 512, "float32"),
                  tflash.plan(2, 2, 2, 256, 256, 64, 128, 128, True, 0,
                              "float32"),
                  tflash.plan(2, 4, 2, 200, 77, 64, 128, 64, True, 48,
                              "bfloat16")):
        rep = port_findings(facts)
        assert rep.clean, rep.format()


def test_race_over_an_ignored_grid_dim_is_an_error_in_the_port():
    """The semantic difference: a grid dim the output tile map ignores is
    a sequential revisit on the TPU (no finding) and a race here."""
    out = OperandFacts("out", "out", (4, 128), "float32", (1, 128),
                       lambda bx, by, bz: stack_tiles(bx, bx, 0))
    fc = LaunchFacts("revisit", (4, 2, 1), 128, 0, 0, "int32",
                     inputs=(), outputs=(out,))
    rep = Report(target="t")
    r5_block_coverage(rep, [fc])
    assert [f.severity for f in rep.findings] == [Severity.ERROR]
    assert "blocks (0, 0, 0) and (0, 1, 0)" in rep.findings[0].message


# ---------------------------------------------------------------------------
# R7 and R3
# ---------------------------------------------------------------------------
def test_r7_sentinel_fixtures():
    rep = Report(target="r7")
    _check_sentinel(rep, "f", np.dtype(np.int32), 1 << 31)   # overflows
    assert rep.errors and "not representable" in rep.errors[0].message
    rep2 = Report(target="r7")
    _check_sentinel(rep2, "f", np.dtype(np.float16), 65504.0)  # finite max
    assert not rep2.errors and any("tie" in f.message for f in rep2.findings)
    rep3 = Report(target="r7")
    _check_sentinel(rep3, "f", np.dtype(np.float32), np.inf)
    _check_sentinel(rep3, "f", np.dtype(np.int32), np.iinfo(np.int32).max)
    _check_sentinel(rep3, "f", torch.bfloat16, float("inf"))
    assert rep3.clean, rep3.format()
    rep4 = Report(target="r7")
    _check_sentinel(rep4, "f", np.dtype(np.int32), 1000)    # below the max
    assert not rep4.errors and any("leak" in f.message
                                   for f in rep4.findings)


def test_r7_rank_overflow_via_index_dtype_override():
    facts = tlocal_sort.plan(1, 1 << 10, "float32")
    rep = Report(target="r7")
    r7_index_arith(rep, facts)
    assert rep.clean, rep.format()
    r7_index_arith(rep, facts, index_dtype="int8")
    assert any(f.rule == "R7" and "overflow" in f.message
               for f in rep.errors), rep.format()


def test_r7_merge_split_ranks_are_64_bit():
    """Array offsets are 64-bit; the co-ranks inside a row are int32, so
    the plan refuses rows that merge 2^31 or more keys, and the largest
    row it takes is clean under R7."""
    facts = tmerge_split.plan(2, 2**30 - 1, "int32")  # 2^31 - 2-key merges
    assert all(f.index_dtype == "int64" for f in facts)
    rep = Report(target="r7")
    r7_index_arith(rep, facts)
    assert rep.clean, rep.format()
    r7_index_arith(rep, facts, index_dtype="int16")
    assert rep.errors
    with pytest.raises(ValueError, match="2\\^31 - 1 elements"):
        tmerge_split.plan(2, 2**30, "int32")
    with pytest.raises(ValueError, match="2\\^31 - 1 elements"):
        tmerge_split.plan(1, 2**31 - 5, "int32", 5)


def test_merge_split_plan_carries_the_grid_limit():
    """The grid is flat over rows x blocks, so rows are not bounded by a
    grid dimension (the old 65535-row gridDim.y limit is gone)."""
    facts = tmerge_split.plan(65536, 8, "int32")
    assert facts[-1].name == "merge_split_kernel"
    assert facts[-1].grid == (65536, 1, 1)
    assert tmerge_split.plan(3, 2 * tmerge_split.TILE + 1, "int32",
                             4)[-1].grid == (9, 1, 1)


def test_r3_budget_on_the_flash_plan():
    ok = tflash.plan(1, 16, 8, 4096, 4096, 128, 128, 128, True, 0, "bfloat16")
    assert ok[0].smem_bytes == 230_480          # fa_wgmma: 3 K/V stages
    f32 = tflash.plan(1, 16, 8, 4096, 4096, 128, 128, 128, True, 0, "float32")
    assert f32[0].smem_bytes == 198_144
    rep = Report(target="r3")
    r3_smem_budget(rep, ok + f32, SMEM_BYTES_PER_BLOCK)
    assert rep.clean, rep.format()
    big = tflash.plan(1, 16, 8, 4096, 4096, 128, 128, 256, True, 0,
                      "bfloat16")
    r3_smem_budget(rep, big, SMEM_BYTES_PER_BLOCK)
    assert [f.rule for f in rep.errors] == ["R3"]
    assert rep.errors[0].actual_bytes > SMEM_BYTES_PER_BLOCK


def test_local_sort_plan_counts_its_launches():
    """(8, 12.5 M): 763 tiles, so the tile sort and ceil(log2 763) = 10
    merge passes of a partition and a merge, ping-ponging between the
    output and a (rows, C) scratch so that the last pass writes the output;
    no global compare-exchange substage and no copy pass."""
    rows, C = 8, 12_500_000
    facts = tlocal_sort.plan(rows, C, "int32")
    names = [f.name for f in facts]
    assert tlocal_sort.merge_passes(C) == 10
    assert len(facts) == 21
    assert names == ["tile_sort"] + ["merge_partition", "merge_pass"] * 10
    assert "global_step" not in names and "copy_out" not in names
    assert [f.step for f in facts] == list(range(21))
    assert facts[0].grid == (rows * 763, 1, 1)
    bpr = -(-C // tlocal_sort.MT)
    assert [f.grid[0] for f in facts[2::2]] == [rows * bpr] * 10
    dst = [f.outputs[0].buffer for f in facts[::2]]
    assert dst == ["out", "scratch"] * 5 + ["out"]
    assert {f.outputs[0].array_shape for f in facts[::2]} == {(rows, C)}
    assert tlocal_sort.scratch_shapes(rows, C) == {"scratch": (rows, C),
                                                   "diag": (rows * bpr,)}
    assert {f.index_dtype for f in facts} == {"int64"}
    assert len(tlocal_sort.plan(8, 16384, "int32")) == 1
    assert tlocal_sort.scratch_shapes(8, 16384) == {}
    with pytest.raises(ValueError, match="at most"):
        tlocal_sort.plan(1, 2**31, "int32")


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_local_sort_full_width_plan_is_clean(dtype):
    rep = check_artifacts("local_sort", tlocal_sort.plan(8, 12_500_000, dtype),
                          rules=("R3", "R5", "R7", "R8"))
    assert rep.clean and not rep.notes, rep.format()


# ---------------------------------------------------------------------------
# recording, the image of the tile maps
# ---------------------------------------------------------------------------
def test_record_collects_the_launches_the_card_would_make():
    x = torch.arange(64, dtype=torch.int32).view(2, 32)
    assert ops.local_sort(x) is not None          # no recorder: nothing kept
    with record() as outer:
        ops.local_sort(x)
        with record() as inner:
            ops.merge_split(x, x, True)
    assert [f.name for f in outer] == ["sort_rows_smem",
                                       "merge_split_partition",
                                       "merge_split_kernel"]
    assert [f.name for f in inner] == ["merge_split_partition",
                                       "merge_split_kernel"]
    assert outer[0].call == ("repro_torch.kernels.local_sort",
                             (2, 32, "int32"))
    q, k = torch.zeros(1, 4, 40, 16), torch.zeros(1, 2, 72, 16)
    y = torch.zeros(3, 1001, dtype=torch.bfloat16)
    with record() as launches:
        ops.flash_attention(q, k, k, causal=False, block_q=32, block_k=64)
        ops.localised_copy(y, 2)
        ops.bitonic_sort(torch.zeros(2, 64))
    assert [f.call for f in launches] == [
        ("repro_torch.kernels.flash_attention",
         (1, 4, 2, 40, 72, 16, 32, 64, False, 0, "float32")),
        ("repro_torch.kernels.localised_copy",
         (3003, 2, "bfloat16", y.data_ptr() % 16 == 0)),
        ("repro_torch.kernels.local_sort", (2, 64, "float32"))]
    assert launches[0].grid == (2, 4, 1)          # (q tiles, H, B)


@pytest.mark.parametrize("C", [1000, 3 * 16384 + 7, 37 * 16384 + 11])
def test_image_of_the_sort_plans_covers_their_outputs(C):
    facts = tlocal_sort.plan(3, C, "int32")
    assert bool(image(facts, "out", 3 * C).all())
    for name, shape in tlocal_sort.scratch_shapes(3, C).items():
        assert bool(image(facts, name, int(np.prod(shape))).all())
    gapped = mutant_launches("gapped_index_map", device="cpu")[1]
    assert image(gapped, "out", 512).view(4, 128).all(1).tolist() == \
        [True, True, False, False]


MERGE_TILE = tmerge_split.TILE
# (rows, na, dtype, nb): the engine's merge-splits (nb None) and the
# constraint tree's three full merges at n = 100 M, and ragged small ones
MERGE_PLANS = [(8, 12_500_000, "int32", None), (16, 12_500_000, "int32", None),
               (4, 12_500_000, "int32", 12_500_000),
               (2, 25_000_000, "float32", 25_000_000),
               (1, 50_000_000, "bfloat16", 50_000_000),
               (3, 2 * MERGE_TILE + 5, "int8", 7), (2, 0, "uint8", 9)]


@pytest.mark.parametrize("args", MERGE_PLANS, ids=str)
def test_merge_plans_are_clean_at_full_width(args):
    """A partition launch then the merge over a flat grid of rows x
    blocks; R3/R5/R7/R8 silent."""
    rows, na, dtype, nb = args
    facts = tmerge_split.plan(rows, na, dtype, nb)
    assert [f.name for f in facts] == ["merge_split_partition",
                                       "merge_split_kernel"]
    n_row = na if nb is None else na + nb
    assert facts[-1].grid == (rows * -(-n_row // MERGE_TILE), 1, 1)
    assert facts[-1].smem_static == 4 * tmerge_split.SLOTS
    rep = check_artifacts("merge_split", facts,
                          rules=("R3", "R5", "R7", "R8"))
    assert rep.clean and not rep.notes, rep.format()


@pytest.mark.parametrize("args", [(3, 2 * MERGE_TILE + 5, "int32", None),
                                  (2, 100, "float16", 3 * MERGE_TILE),
                                  (4, 8, "uint8", 0), (1, 1, "int16", None)],
                         ids=str)
def test_image_of_the_merge_plans_covers_their_outputs(args):
    rows, na, dtype, nb = args
    facts = tmerge_split.plan(rows, na, dtype, nb)
    n_row = na if nb is None else na + nb
    assert bool(image(facts, "out", rows * n_row).all())
    assert bool(image(facts, "diag",
                      tmerge_split.diag_size(rows, n_row)).all())
    call = facts[0].call
    assert call == ("repro_torch.kernels.merge_split",
                    (rows, na, dtype) if nb is None else (rows, na, dtype, nb))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_local_sort_plan_of_a_narrow_dtype_keeps_keys_in_int32_scratch(dtype):
    """A narrow output cannot hold 32-bit keys: a second int32 scratch
    takes its place in the ping-pong, and only the last pass writes it."""
    C = 5 * 16384 + 3                              # 3 merge passes
    facts = tlocal_sort.plan(3, C, dtype)
    shapes = tlocal_sort.scratch_shapes(3, C, dtype)
    assert set(shapes) == {"scratch", "scratch2", "diag"}
    assert tlocal_sort.scratch_shapes(3, C, "int32").keys() == \
        {"scratch", "diag"}
    writes = [(f.name, op.buffer) for f in facts for op in f.outputs]
    assert [b for _, b in writes if b != "diag"] == [
        "scratch", "scratch2", "scratch", "out"]
    assert all(op.dtype == "int32" for f in facts for op in f.outputs
               if op.buffer != "out")
    assert bool(image(facts, "out", 3 * C).all())
    for name, shape in shapes.items():
        assert bool(image(facts, name, int(np.prod(shape))).all())
    rep = check_artifacts("local_sort", facts, rules=("R3", "R5", "R7", "R8"))
    assert rep.clean and not rep.notes, rep.format()


def test_poison_marks_what_is_not_written():
    for dt in (torch.float32, torch.int32, torch.bfloat16, torch.int8,
               torch.uint8, torch.float16, torch.int16):
        t = poisoned((3, 5), dt, "cpu")
        assert not bool(written(t).any())
        t[1, 2] = 0
        assert written(t).nonzero().view(-1).tolist() == [7]


# ---------------------------------------------------------------------------
# R6: structural + 0-1 certification over the port's descriptors
# ---------------------------------------------------------------------------
def test_r6_nonbijective_perm_fixture_is_structural_error():
    findings = _substage_findings(nonbijective_network())
    assert findings and all(f.severity == Severity.ERROR for f in findings)
    assert any("bijection" in f.message for f in findings)


def test_r6_inverted_keep_fixture_fails_zero_one_only():
    net = inverted_keep_network()
    assert not _substage_findings(net)
    witness = zero_one_certify(net)
    assert witness is not None and len(witness) == net.m
    assert witness == ref_fixtures_witness()


def ref_fixtures_witness():
    from repro.analysis import zero_one_certify as ref_zero_one
    return ref_zero_one(ref_fixtures.inverted_keep_network())


def test_r6_certificate_equals_the_reference():
    cert = certify_supported_meshes(max_devices=16)
    assert set(cert) == {"loc-static-local", "loc-static-hash",
                         "hier.hash-loc-static-local",
                         "hier.hash-loc-static-hash"}
    for rec in cert.values():
        assert rec["failed"] == [], rec
    assert cert == ref_certify(max_devices=16)


# ---------------------------------------------------------------------------
# check_workload / Locale.check on a CPU mesh: clean
# ---------------------------------------------------------------------------
WORKLOADS = {
    "sort-constraint-flat": ({"data": 8}, "data", None, "sort", "constraint"),
    "sort-shard_map-flat": ({"data": 8}, "data", None, "sort", "shard_map"),
    "engine-flat-hash": ({"data": 8}, "data", "hash", "engine", None),
    "engine-hier": ({"pod": 2, "data": 4}, ("pod", "data"), "hier",
                    "engine", None),
    "sort-constraint-hier": ({"pod": 2, "data": 4}, ("pod", "data"), "hier",
                             "sort", "constraint"),
    "microbench": ({"data": 8}, "data", None, "microbench", None),
}


@pytest.mark.parametrize("tag", sorted(WORKLOADS))
def test_check_workload_clean_on_cpu(tag):
    shape, axis, pol, workload, backend = WORKLOADS[tag]
    policy = {None: LocalisationPolicy(),
              "hash": LocalisationPolicy(homing=Homing.HASH_INTERLEAVED),
              "hier": LocalisationPolicy.hierarchical(inner="hash")}[pol]
    locale = Locale(HomeMesh(shape, device="cpu"), axis, policy)
    ops.reset_launches()
    rep = check_workload(locale, workload, backend=backend, logn=12)
    assert rep.clean, rep.format(verbose=True)
    assert rep.context["launches"] > 0 and rep.context["device"] == "cpu"
    assert not any(ops.launch_counts().values())
    skipped = {n.split()[0] for n in rep.notes if "skipped" in n}
    assert {"R1", "R2", "R9"} <= skipped
    assert not skipped & {"R4", "R10", "R11"}, rep.notes
    assert any(n.startswith("R10: device-live-range ok") for n in rep.notes)
    assert any("nothing ran a collective" in n for n in rep.notes)
    if backend == "shard_map" or workload == "engine":
        assert any("0-1 certified" in n for n in rep.notes)


def test_locale_check_is_check_workload():
    locale = Locale(HomeMesh({"data": 4}, device="cpu"))
    rep = locale.check("sort", rules=("R5", "R7"), logn=10)
    assert rep.clean and rep.target == "sort[constraint]"
    assert not any("R6" in n for n in rep.notes)
    rep = locale.check("microbench", reps=2, logn=10)
    assert rep.clean and rep.context["launches"] == 2


def test_check_artifacts_reports_the_mutants():
    _, launches = mutant_launches("overlapping_index_map", device="cpu")
    rep = check_artifacts("fixture", launches, rules=("R5",))
    assert not rep.clean and [f.rule for f in rep.errors] == ["R5"]
    assert rep.suppress(["R5"]).clean


# ---------------------------------------------------------------------------
# the CLI, in process
# ---------------------------------------------------------------------------
def test_cli_exit_codes(capsys, monkeypatch):
    assert cli.main(["--device", "cpu", "--pods", "2x4", "--workload",
                     "engine", "--logn", "10"]) == 0
    out = capsys.readouterr().out
    assert "R6 certificate [loc-static-local]: 10 mesh(es)" in out
    assert "0 error(s)" in out
    assert cli.main(["--device", "cpu", "--workload", "microbench",
                     "--rules", "R5", "R8", "--json"]) == 0
    assert '"clean": true' in capsys.readouterr().out
    assert cli.main(["--device", "cpu", "--workload", "all"]) == 0  # no mesh
    assert "3 target(s), 0 finding(s)" in capsys.readouterr().out

    def dirty(*a, **kw):
        return check_artifacts(
            "fixture", mutant_launches("oob_index_map", device="cpu")[1])
    monkeypatch.setattr("repro_torch.analysis.check_workload", dirty)
    assert cli.main(["--device", "cpu", "--rules", "R5"]) == 1
    monkeypatch.undo()
    # a driver failure: an unknown device
    assert cli.main(["--device", "nope", "--pods", "1x2"]) == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["--rules", "R12"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["--pods", "2x2x2x2"])         # PxD or PxDxM only
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# the copied findings module
# ---------------------------------------------------------------------------
def test_rules_and_severity_equal_the_reference():
    assert list(RULES) == list(REF_RULES)
    assert {s.name: s.value for s in Severity} == \
        {s.name: s.value for s in RefSeverity}


def test_normalize_rules():
    assert normalize_rules(None) == tuple(f"R{i}" for i in range(1, 12))
    assert normalize_rules("all") == normalize_rules(["all"])
    assert normalize_rules(["R5", "r6"]) == ("R5", "R6")
    assert normalize_rules("R5,R8") == ("R5", "R8")
    with pytest.raises(ValueError, match="unknown rule"):
        normalize_rules(["R12"])
    # every rule has its counterpart: none is noted as not ported
    assert not hasattr(port_homecheck, "NOT_PORTED")
    rep = port_homecheck.check_artifacts("all-rules", [])
    assert not any("no port counterpart" in n for n in rep.notes)
