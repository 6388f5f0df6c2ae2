"""R4, R10 and R11 of the port against the reference's fixtures and rules.

R10: the port's hog fixture (`analysis.fixtures.hbm_hog`: x of 4,194,304
f32, -x, exp(x) and their sum) runs under `mem_facts.call_facts`, and its
live scan must give exactly the reference's `hlo_facts.liveness` of the
same program as HLO text (64 MiB at the peak, 16 MiB of arguments, 4
buffers).  R4: the reference's ``b * 2.0`` step on a 2 MiB buffer and its
twin written in place must give the reference's verdicts
(`tests/test_homecheck.py:79-92`: a WARN that is not clean, clean when the
buffer is reused, clean under ``suppress=("R4",)``).  R11: the three
collective fixtures run on 2 gloo ranks; a branch that only one rank
takes is an ERROR, a data-dependent count of collectives a WARN,
consistent branches clean.  `check_decode` on a 2-rank gloo `RankMesh` is
clean under R2 and R11, and the trace CLI validates a traced CPU serve
and rejects the committed corrupt trace.

Spawned ranks import this module, so it imports no JAX at top level: the
reference is imported inside the tests.
"""
import json
import os

import pytest
import torch

from repro_torch.analysis import Report, Severity, check_artifacts
from repro_torch.analysis.fixtures import (HOG_ELEMENTS, R4_ELEMENTS,
                                           R11_FIXTURES, hbm_hog,
                                           hbm_hog_input, r4_step,
                                           r4_step_in_place, r11_rank_logs,
                                           r11_reports)
from repro_torch.analysis.livecheck import (log_signature,
                                            r10_device_live_range,
                                            r11_collective_control_flow)
from repro_torch.analysis.mem_facts import call_facts
from repro_torch.launch.mesh import spawn

MIB = 2 ** 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORRUPT = os.path.join(ROOT, "tests", "data", "corrupt_trace.jsonl")


def hog_facts():
    return call_facts(hbm_hog, hbm_hog_input("cpu"))[1]


# ---------------------------------------------------------------------------
# R10
# ---------------------------------------------------------------------------
def test_hog_liveness_equals_the_reference():
    from repro.analysis.fixtures import hbm_hog_module
    from repro.analysis.hlo_facts import liveness
    ref = liveness(hbm_hog_module())
    live = hog_facts()["liveness"]
    assert HOG_ELEMENTS * 4 == 16 * MIB
    assert live["peak_bytes"] == ref["peak_bytes"] == 64 * MIB
    assert live["param_bytes"] == ref["param_bytes"] == 16 * MIB
    assert live["n_buffers"] == ref["n_buffers"] == 4
    assert sorted(b for b, _, _ in live["live_at_peak"]) == sorted(
        b for b, _, _ in ref["live_at_peak"])
    assert {op for _, _, op in live["live_at_peak"]} == {
        "parameter", "neg", "exp", "add"}


def test_r10_hog_exceeds_32mib_ceiling():
    facts = hog_facts()
    rep = Report(target="r10-hog")
    r10_device_live_range(rep, facts["liveness"], ceiling=32 * MIB)
    errs = [f for f in rep.errors if f.rule == "R10"]
    assert errs, rep.format()
    assert errs[0].actual_bytes == 64 * MIB
    assert "per-device ceiling" in errs[0].message
    assert "largest at peak" in errs[0].message
    assert "liveness scan" in errs[0].message

    rep2 = Report(target="r10-ok")
    r10_device_live_range(rep2, facts["liveness"], ceiling=128 * MIB)
    assert rep2.clean, rep2.format()
    assert any("headroom" in n for n in rep2.notes)
    assert facts["memory_stats"] is None            # no allocator on the CPU


def test_r10_memory_stats_tightens_the_scan():
    from repro.analysis.findings import Report as RefReport
    from repro.analysis.fixtures import hbm_hog_module
    from repro.analysis.livecheck import r10_hbm_live_range
    ref = RefReport(target="r10-stats")
    r10_hbm_live_range(ref, hbm_hog_module(), ceiling=68 * MIB,
                       memory_stats={"argument_size_in_bytes": 48 * MIB,
                                     "output_size_in_bytes": 16 * MIB,
                                     "temp_size_in_bytes": 8 * MIB})
    rep = Report(target="r10-stats")
    r10_device_live_range(rep, hog_facts()["liveness"], ceiling=68 * MIB,
                          memory_stats={"allocated_bytes.all.peak": 72 * MIB})
    errs = [f for f in rep.errors if f.rule == "R10"]
    assert errs and errs[0].actual_bytes == 72 * MIB
    assert errs[0].actual_bytes == ref.errors[0].actual_bytes
    assert "cuda allocator" in errs[0].message


def test_r10_through_check_artifacts_takes_the_ceiling():
    facts = hog_facts()
    rep = check_artifacts("r10", [], mem_facts=facts, hbm_ceiling=32 * MIB,
                          rules="R10")
    assert [(f.rule, f.severity) for f in rep.findings] == [
        ("R10", Severity.ERROR)]
    rep = check_artifacts("r10", [], mem_facts=facts, rules="R10")
    assert rep.clean and "80,000,000,000B ceiling" in rep.notes[0]


# ---------------------------------------------------------------------------
# R4
# ---------------------------------------------------------------------------
def _r4_verdicts(report):
    return (sorted((f.rule, f.severity.name) for f in report.findings),
            report.clean, bool(report.errors))


def test_r4_verdicts_equal_the_reference():
    import jax
    import jax.numpy as jnp
    from repro.analysis import check_artifacts as ref_check

    x = jnp.zeros((1 << 19,), jnp.float32)                  # 2 MiB
    step = lambda b: b * 2.0                                # noqa: E731
    hlo = jax.jit(step).lower(x).compile().as_text()
    donated = jax.jit(step, donate_argnums=(0,)).lower(x).compile().as_text()
    ref = {"copy": ref_check("r4-fixture", hlo),
           "in_place": ref_check("r4-donated", donated),
           "suppressed": ref_check("r4-suppressed", hlo, suppress=("R4",))}

    b = torch.zeros(R4_ELEMENTS)
    assert R4_ELEMENTS * 4 == 2 * MIB
    copy = call_facts(r4_step, b)[1]
    in_place = call_facts(r4_step_in_place, b)[1]
    ours = {"copy": check_artifacts("r4-fixture", [], mem_facts=copy),
            "in_place": check_artifacts("r4-donated", [],
                                        mem_facts=in_place),
            "suppressed": check_artifacts("r4-suppressed", [],
                                          mem_facts=copy,
                                          suppress=("R4",))}
    for k in ref:
        assert _r4_verdicts(ours[k]) == _r4_verdicts(ref[k]), (
            k, ours[k].format(), ref[k].format())
    warn = ours["copy"].findings[0]
    assert warn.rule == "R4" and warn.severity == Severity.WARN
    assert warn.actual_bytes == 2 * MIB
    assert "copied every step; write it in place" in warn.message
    assert not ours["copy"].clean and not ours["copy"].errors
    assert ours["in_place"].clean
    assert ours["suppressed"].clean
    assert ours["suppressed"].suppressed == ["R4"]
    assert copy["aliasing"][0]["returned"] and \
        not copy["aliasing"][0]["in_place"]
    assert in_place["aliasing"][0]["in_place"]


def test_r4_threshold_and_donated_ok():
    small = call_facts(r4_step, torch.zeros(1 << 17))[1]     # 512 KiB
    assert check_artifacts("r4-small", [], mem_facts=small).clean
    from repro_torch.analysis.rules import r4_donation_audit
    rep = Report(target="r4-donated-ok")
    r4_donation_audit(rep, call_facts(r4_step, torch.zeros(R4_ELEMENTS))[1][
        "aliasing"], donated_ok=(0,))
    assert rep.clean


# ---------------------------------------------------------------------------
# R11
# ---------------------------------------------------------------------------
def test_r11_fixtures_on_two_gloo_ranks():
    ranks = spawn(r11_rank_logs, 2, "gloo", "cpu")
    reports = r11_reports(ranks)
    for name, (_, want) in R11_FIXTURES.items():
        got = sorted((f.rule, f.severity.name) for f in reports[name].findings)
        assert got == want, (name, reports[name].format())
    err = reports["branch_mismatch"].errors[0]
    assert "deadlock" in err.message and "ranks 0 and 1" in err.message
    warn = reports["data_dependent_loop"].findings[0]
    assert "trip count" in warn.message
    assert not reports["data_dependent_loop"].errors
    assert reports["consistent_branches"].clean
    assert any("collective-control-flow ok" in n
               for n in reports["consistent_branches"].notes)
    # the loop's count: 3 psums on run 0 (max 7), 4 on run 1 (max 15)
    assert [len(r) for r in ranks[0]["data_dependent_loop"]] == [3, 4]
    assert all(rec["payload_bytes"] == 32
               for run in ranks[1]["consistent_branches"] for rec in run)


def test_r11_without_ranks_notes_nothing_ran():
    rep = Report(target="r11-none")
    r11_collective_control_flow(rep, None)
    assert rep.clean and "nothing ran a collective" in rep.notes[0]


def test_r11_compares_uneven_all_to_all_without_bytes():
    a2a = {"kind": "all-to-all", "axes": ["data"], "groups": [[0, 1]],
           "payload_bytes": None}
    rep = Report(target="r11-v")
    r11_collective_control_flow(rep, [[a2a], [dict(a2a)]])
    assert rep.clean
    rep = Report(target="r11-len")
    r11_collective_control_flow(rep, [[a2a, a2a], [a2a]])
    assert [f.severity for f in rep.findings] == [Severity.ERROR]
    assert "rank 1 nothing" in rep.findings[0].message
    assert log_signature([dict(a2a, wire_bytes=4)]) == [a2a]


def decode_rank_work(device):
    """One rank of a 2-rank world: `check_decode` on ``{"data": 1,
    "model": 2}``, its report's findings and notes."""
    from repro_torch.analysis import check_decode
    from repro_torch.launch.mesh import make_rank_mesh
    rep = check_decode(make_rank_mesh(n_model=2, device=device))
    return {"findings": [f.format() for f in rep.findings],
            "notes": rep.notes, "collectives": rep.context["collectives"]}


def test_check_decode_on_two_gloo_ranks_is_clean():
    ranks = spawn(decode_rank_work, 2, "gloo", "cpu")
    for r in ranks:
        assert r["findings"] == [], r
        assert r["collectives"] > 0
        assert not any(n.startswith(("R2 skipped", "R11 skipped"))
                       for n in r["notes"]), r["notes"]
        assert any(n.startswith("R11: collective-control-flow ok — 2 rank(s)")
                   for n in r["notes"]), r["notes"]
        assert any("scheduler certified" in n for n in r["notes"])
    assert ranks[0]["collectives"] == ranks[1]["collectives"]


# ---------------------------------------------------------------------------
# the trace CLI
# ---------------------------------------------------------------------------
def test_tracelog_validates_a_traced_serve(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.launch.tracelog import main as tracelog_main
    trace = str(tmp_path / "serve.jsonl")
    serve.main(["--smoke", "--device", "cpu", "--trace", trace])
    capsys.readouterr()
    assert tracelog_main([trace, "--validate"]) == 0
    assert "checks: schema, I-bytes" in capsys.readouterr().out
    chrome = str(tmp_path / "chrome.json")
    assert tracelog_main([trace, "--chrome", chrome]) == 0
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    assert events and all("ph" in e for e in events)
    assert tracelog_main([trace]) == 0
    assert "sched.summary" in capsys.readouterr().out


def test_tracelog_rejects_the_corrupt_fixture(capsys):
    from repro_torch.launch.tracelog import main as tracelog_main
    assert tracelog_main([CORRUPT, "--validate"]) == 1
    assert "I-bytes" in capsys.readouterr().err
    assert tracelog_main([CORRUPT]) == 0          # summary mode still reads
