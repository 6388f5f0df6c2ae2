"""R9 of the port (`repro_torch.analysis.schedcheck`) against the reference's.

The port's scheduler certificate runs the same breadth-first search over
the same lattice on the port's copy of the scheduler transitions, so it
must give the reference's results exactly: on every lattice entry no
witness and the same count of canonical states, and on every scheduler
mutation the same invariant, the same minimal event script and the same
count.  The port's homecheck CLI then runs the reference's acceptance
sweep (`tests/test_homecheck.py`'s `SWEEP`) on the CPU, in this process,
so the full lattice is certified once for the file (`certify_lattice` is
memoized per entry).
"""
import contextlib
import dataclasses
import io

import pytest

from repro.analysis import schedcheck as ref_sc
from repro.analysis.findings import Report as RefReport
from repro.analysis.fixtures import mutant_scheduler as ref_mutant
from repro.runtime.scheduler import MUTATIONS as REF_MUTATIONS
from repro_torch.analysis import (DEFAULT_LATTICE, FAST_LATTICE, Report,
                                  Severity, certify_lattice)
from repro_torch.analysis.fixtures import MUTANT_INVARIANT, mutant_scheduler
from repro_torch.analysis.schedcheck import (MAX_STATES, certify,
                                             r9_scheduler_certification)
from repro_torch.launch import homecheck as cli
from repro_torch.runtime.scheduler import (MUTATIONS, SchedConfig, Served,
                                           complete_t, initial_state)


@pytest.fixture(scope="module")
def ref_cert():
    """The reference's full-lattice certificate (memoized there too)."""
    return ref_sc.certify_lattice(ref_sc.DEFAULT_LATTICE)


def test_lattice_equals_the_reference_field_by_field():
    assert MAX_STATES == ref_sc.MAX_STATES
    for ours, ref in ((DEFAULT_LATTICE, ref_sc.DEFAULT_LATTICE),
                      (FAST_LATTICE, ref_sc.FAST_LATTICE)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), a.name
    assert len(DEFAULT_LATTICE) == 11
    assert {e.name for e in FAST_LATTICE} < {e.name for e in DEFAULT_LATTICE}


def test_full_lattice_certifies_with_the_reference_state_counts(ref_cert):
    cert = certify_lattice(DEFAULT_LATTICE)
    assert list(cert) == list(ref_cert)
    for name, rec in cert.items():
        assert rec["witness"] is None, f"{name}: {rec['witness'].format()}"
        assert rec["witness"] is ref_cert[name]["witness"] is None
        assert rec["states"] == ref_cert[name]["states"], name
    assert sum(r["states"] for r in cert.values()) == sum(
        r["states"] for r in ref_cert.values())
    # memoized per entry: the CLI and the rule pay for the exploration once
    assert certify_lattice(DEFAULT_LATTICE) == cert


def test_r9_note_equals_the_reference(ref_cert):
    ours, ref = Report(target="r9"), RefReport(target="r9")
    r9_scheduler_certification(ours, DEFAULT_LATTICE)
    ref_sc.r9_scheduler_certification(ref, ref_sc.DEFAULT_LATTICE)
    assert ours.clean and ref.clean
    assert ours.notes == ref.notes
    assert "scheduler certified" in ours.notes[0]


def test_mutations_equal_the_reference():
    assert tuple(MUTATIONS) == tuple(REF_MUTATIONS)
    assert set(MUTANT_INVARIANT) == set(MUTATIONS)


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutant_witness_equals_the_reference(mutation):
    entry = mutant_scheduler(mutation)
    witness, states = certify(entry)
    ref_witness, ref_states = ref_sc.certify(ref_mutant(mutation))
    assert witness is not None, f"{entry.name}: mutant certified clean"
    assert witness.invariant == MUTANT_INVARIANT[mutation]
    assert witness.invariant == ref_witness.invariant
    assert witness.events == ref_witness.events
    assert witness.config == entry.name == ref_witness.config
    assert witness.violation == ref_witness.violation
    assert states == ref_states
    assert witness.format() == ref_witness.format()


def test_r9_rule_errors_carry_the_witness():
    rep = Report(target="r9-mutant")
    r9_scheduler_certification(rep, (mutant_scheduler("drop_charge"),))
    errs = [f for f in rep.errors if f.rule == "R9"]
    assert errs and errs[0].severity == Severity.ERROR, rep.format()
    assert "I1-uncharged-move" in errs[0].message
    assert "after [" in errs[0].message


def test_mutant_scheduler_rejects_unknown_mutation():
    with pytest.raises(ValueError, match="unknown scheduler mutation"):
        mutant_scheduler("teleport")


def test_complete_t_evicts_lru_prefix_in_one_stable_sort():
    big = SchedConfig(policy="homed", n_slots=2, owners=(0, 0),
                      bytes_per_token=2, session_capacity=8)
    st = initial_state(big)
    for i, t in enumerate([3.0, 1.0, 4.0, 2.0]):      # scrambled last_used
        st, ev = complete_t(big, st, [Served(i, f"s{i}", 0, 4)], now=t)
        assert ev == ()
    small = dataclasses.replace(big, session_capacity=2)
    st, evicted = complete_t(small, st, [Served(9, "new", 0, 4)], now=9.0)
    assert [b.session for b in evicted] == ["s1", "s3", "s0"]
    assert all(b.home == 0 for b in evicted)
    assert sorted(b.last_used for b in evicted) == [1.0, 2.0, 3.0]


# ---------------------------------------------------------------------------
# the reference's acceptance sweep through the port's CLI
# ---------------------------------------------------------------------------
SWEEP = [
    ("flat-all-policies",
     ["--workload", "all", "--pods", "1x4", "--policy", "all"]),
    ("hier-all-policies",
     ["--workload", "all", "--pods", "2x2x2", "--policy", "all"]),
    ("flat-constraint", ["--workload", "sort", "--pods", "1x4",
                         "--backend", "constraint"]),
    ("engine-hier", ["--workload", "engine", "--pods", "2x2",
                     "--policy", "hier"]),
    ("flat-new-rules", ["--workload", "sort", "--pods", "1x4",
                        "--policy", "all", "--rules", "R5", "R6", "R7",
                        "R8"]),
    ("serve-r9r10r11", ["--workload", "serve", "--pods", "1x4",
                        "--rules", "r9,r10,r11"]),
]


def test_sweep_is_the_reference_sweep():
    import test_homecheck
    assert SWEEP == test_homecheck.SWEEP


@pytest.mark.parametrize("name,argv", SWEEP, ids=[s[0] for s in SWEEP])
def test_homecheck_cli_sweep_clean(name, argv, ref_cert):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*argv, "--device", "cpu"])
    out = out.getvalue()
    assert rc == 0, out
    assert "0 finding(s), 0 error(s)" in out, out
    r9 = any("r9" in a.lower() for a in argv) or "--rules" not in argv
    assert ("R9 certificate [scheduler]" in out) == r9, out
    if r9:
        total = sum(r["states"] for r in ref_cert.values())
        assert (f"I1-I8 hold over 11 lattice config(s), {total} canonical "
                f"states") in out, out
    if argv[argv.index("--workload") + 1] in ("serve", "all"):
        assert "homecheck serve[decode]" in out, out


# ---------------------------------------------------------------------------
# (rule, severity) signatures on the targets the reference runs on one
# device
# ---------------------------------------------------------------------------
def _signature(report):
    return sorted((f.rule, f.severity.name) for f in report.findings)


@pytest.mark.parametrize("target", ["sort-flat", "sort-hash", "microbench",
                                    "serve"])
def test_one_device_signatures_equal_the_reference(target, ref_cert):
    """Each target at the reference's defaults; the decode target's R9
    runs the full lattice on both sides (memoized above) in place of the
    fast corner, a superset of it."""
    from repro.analysis import check_decode as ref_check_decode
    from repro.analysis import check_workload as ref_check_workload
    from repro.core.api import Locale as RefLocale
    from repro.core.homing import Homing as RefHoming
    from repro.core.localisation import LocalisationPolicy as RefPolicy
    from repro_torch.analysis import check_decode, check_workload
    from repro_torch.core import Homing, Locale, LocalisationPolicy

    if target == "serve":
        ref = ref_check_decode(sched_lattice=ref_sc.DEFAULT_LATTICE)
        ours = check_decode(device="cpu", sched_lattice=DEFAULT_LATTICE)
        assert any("scheduler certified" in n for n in ours.notes)
    elif target == "microbench":
        ref = ref_check_workload(RefLocale(mesh=None), "microbench")
        ours = check_workload(Locale(mesh=None), "microbench",
                              device="cpu")
    else:
        hashed = target == "sort-hash"
        ref = ref_check_workload(RefLocale(mesh=None, policy=RefPolicy(
            homing=RefHoming.HASH_INTERLEAVED) if hashed else RefPolicy()),
            "sort", backend="constraint")
        ours = check_workload(Locale(mesh=None, policy=LocalisationPolicy(
            homing=Homing.HASH_INTERLEAVED) if hashed
            else LocalisationPolicy()), "sort", backend="constraint",
            device="cpu")
    assert _signature(ours) == _signature(ref), (ours.format(),
                                                 ref.format())
    assert ours.target == ref.target
    for rule in ("R4", "R10", "R11"):
        assert not any(f"{rule} skipped" in n for n in ours.notes), ours.notes
    assert any(n.startswith("R10: device-live-range ok") for n in ours.notes)
    assert not any("no port counterpart" in n for n in ours.notes)
