"""The port's pure core held against the JAX reference, record for record.

Configs, ownership math, policies, padding and the engine's descriptors
(`exchange_network`, `exchange_schedule`, `collective_census`) are plain
Python on both sides, so they must be equal exactly, on every flat mesh
of 1-16 homes and every (pods, inner) split of them.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_sort as jax_paper_sort
from repro.core import engine as jeng
from repro.core import localisation as jloc
from repro.core import sort as jsort
from repro.core.homing import Homing as JHoming
from repro_torch.configs import paper_sort
from repro_torch.convert import make_sort_data, policy_from_reference
from repro_torch.core import engine, localisation, sort
from repro_torch.core.homing import Homing, logical_view, to_layout
from repro_torch.core.mesh import HomeMesh

FLAT = [(s,) for s in (1, 2, 4, 8, 16)]
SPLITS = [(p, m // p) for m in (2, 4, 8, 16) for p in (1, 2, 4, 8, 16)
          if p <= m]
PHASES = [("kernel", "pallas"), ("reference", "reference"), (None, None)]


def _pair(localised, static, homing, outer=None):
    """The same policy on both sides."""
    return (jloc.LocalisationPolicy(localised, static, JHoming(homing), outer),
            localisation.LocalisationPolicy(localised, static, Homing(homing),
                                            outer))


FLAT_POLICIES = [_pair(loc, st, h) for loc in (True, False)
                 for st in (True, False) for h in ("local", "hash")]
HIER_POLICIES = [_pair(True, True, h, o) for h in ("local", "hash")
                 for o in ("hash", "replicate")]


def test_paper_sort_config_is_the_reference_copy():
    assert (dataclasses.asdict(paper_sort.SortConfig())
            == dataclasses.asdict(jax_paper_sort.SortConfig()))
    assert paper_sort.SortConfig().array_size == 100_000_000
    assert set(paper_sort.CASES) == set(jax_paper_sort.CASES)
    for k, c in paper_sort.CASES.items():
        assert dataclasses.asdict(c) == dataclasses.asdict(
            jax_paper_sort.CASES[k])


@pytest.mark.parametrize("m", [1, 2, 3, 8, 16])
def test_chunk_bounds_match(m):
    for n in (0, 1, 7, 8, 100, 1001):
        assert localisation.chunk_bounds(n, m) == jloc.chunk_bounds(n, m)


def test_policy_names_and_validation_match():
    for jp, tp in FLAT_POLICIES + HIER_POLICIES:
        assert tp.name == jp.name
        fields = {"localised": jp.localised,
                  "static_mapping": jp.static_mapping,
                  "homing": jp.homing.value, "outer": jp.outer}
        assert policy_from_reference(fields) == tp
    for inner in ("localised", "hash"):
        for outer in ("hash", "replicate"):
            assert (localisation.LocalisationPolicy.hierarchical(inner, outer)
                    .name == jloc.LocalisationPolicy.hierarchical(inner, outer)
                    .name)
    bad = [dict(outer="ring"), dict(localised=False, outer="hash")]
    for kw in bad:
        with pytest.raises(ValueError) as ref:
            jloc.LocalisationPolicy(**kw)
        with pytest.raises(ValueError) as got:
            localisation.LocalisationPolicy(**kw)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jloc.LocalisationPolicy.hierarchical(inner="ring")
    with pytest.raises(ValueError) as got:
        localisation.LocalisationPolicy.hierarchical(inner="ring")
    assert str(got.value) == str(ref.value)


def test_engine_granule_matches():
    for m in (1, 2, 4, 8, 16):
        for w in (None, m, 2 * m, 8 * m):
            for hash_homed in (False, True):
                assert (engine.engine_granule(m, w, hash_homed)
                        == jeng.engine_granule(m, w, hash_homed))


def test_pad_value_and_pad_to_multiple_match():
    assert sort.pad_value(torch.int32) == jsort.pad_value(jnp.int32)
    assert sort.pad_value(torch.float32) == jsort.pad_value(jnp.float32)
    assert sort.pad_value(torch.int16) == jsort.pad_value(jnp.int16)
    for dt in ("int32", "float32"):
        for n, m in ((64, 8), (65, 8), (7, 8), (100, 64)):
            x = make_sort_data(n, dt, n)
            ref = np.asarray(jsort.pad_to_multiple(jnp.asarray(x), m))
            got = sort.pad_to_multiple(torch.from_numpy(x), m).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          ref.view(np.int32))


def test_nan_rejected_like_reference():
    x = np.asarray([1.0, np.nan, 2.0], np.float32)
    with pytest.raises(ValueError, match="NaN"):
        jsort.pad_to_multiple(jnp.asarray(x), 8)
    with pytest.raises(ValueError, match="NaN"):
        sort.pad_to_multiple(torch.from_numpy(x), 8)
    with pytest.raises(ValueError, match="NaN"):
        sort.check_nan_free(torch.from_numpy(x), "sort")
    sort.check_nan_free(torch.arange(3), "sort")      # ints: nothing to check


@pytest.mark.parametrize("sizes", FLAT + SPLITS, ids=str)
def test_exchange_network_matches_record_for_record(sizes):
    policies = FLAT_POLICIES + (HIER_POLICIES if len(sizes) > 1 else [])
    for jp, tp in policies:
        try:
            ref = jeng.exchange_network(jp, sizes)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                engine.exchange_network(tp, sizes)
            assert str(got.value) == str(e)
            continue
        net = engine.exchange_network(tp, sizes)
        assert dataclasses.asdict(net) == dataclasses.asdict(ref), jp.name
        assert ([type(lv).__name__ for lv in net.levels]
                == [type(lv).__name__ for lv in ref.levels])
        assert ([dataclasses.asdict(s) for s in net.substages()]
                == [dataclasses.asdict(s) for s in ref.substages()])
    for jp, tp in HIER_POLICIES[:1]:
        if len(sizes) == 1:
            with pytest.raises(ValueError):
                engine.exchange_network(tp, sizes)


@pytest.mark.parametrize("sizes", FLAT + SPLITS, ids=str)
def test_exchange_schedule_and_census_match(sizes):
    m = int(np.prod(sizes))
    policies = FLAT_POLICIES + (HIER_POLICIES if len(sizes) > 1 else [])
    for jp, tp in policies:
        for n in (1000, 4099, 2**16 + 3):
            for w in (None, 4 * m):
                for ours, theirs in PHASES:
                    kw = dict(num_workers=w, itemsize=4)
                    ref = jeng.exchange_schedule(n, sizes, jp,
                                                 local_phase=theirs, **kw)
                    got = engine.exchange_schedule(n, sizes, tp,
                                                   local_phase=ours, **kw)
                    assert got == ref, (jp.name, n, w, ours)
                    assert (engine.collective_census(
                        n, sizes, tp, local_phase=ours, **kw)
                        == jeng.collective_census(
                            n, sizes, jp, local_phase=theirs, **kw))


def test_local_phase_names_map_to_reference():
    assert dict(engine.LOCAL_PHASES) == {"kernel": "pallas",
                                         "reference": "reference"}
    assert set(engine.LOCAL_PHASES.values()) == set(jeng.LOCAL_PHASES)
    assert engine.resolve_local_phase(None, "bitonic") == "kernel"
    assert engine.resolve_local_phase(None, sorted) == "reference"
    with pytest.raises(ValueError):
        engine.resolve_local_phase("pallas", "bitonic")
    with pytest.raises(ValueError):
        engine.resolve_local_phase("kernel", sorted)


@pytest.mark.parametrize("homing", list(Homing))
def test_to_layout_rows_and_logical_view_round_trip(homing):
    mesh = HomeMesh({"pod": 2, "data": 4}, device="cpu")
    x = torch.arange(64, dtype=torch.int32)
    rows = to_layout(x, mesh, homing, ("pod", "data"))
    assert rows.shape == (8, 8)
    for d in range(8):
        expect = (x[d * 8:(d + 1) * 8] if homing == Homing.LOCAL_CHUNKED
                  else x.reshape(8, 8)[:, d])
        assert torch.equal(rows[d], expect)
    assert torch.equal(logical_view(rows, homing), x)
    with pytest.raises(ValueError, match="pad"):
        to_layout(torch.arange(63), mesh, homing, ("pod", "data"))


def test_home_mesh_validates_and_needs_a_card_by_default():
    mesh = HomeMesh({"pod": 2, "data": 4}, device="cpu")
    assert mesh.size == 8 and mesh.shape == {"pod": 2, "data": 4}
    with pytest.raises(ValueError, match="power of 2"):
        HomeMesh({"data": 6}, device="cpu")
    if torch.cuda.is_available():
        assert HomeMesh({"data": 8}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            HomeMesh({"data": 8})
