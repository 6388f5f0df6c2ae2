"""`launch/dryrun.py --save-trace`: the counted step as text.

The counterpart of the reference's ``--save-hlo``: the file lists the
step's ATen ops in dispatch order with their FLOPs and bytes, then its
kernel launches with their calls' work, then the rank's collective
records (`launch.step_cost.write_trace`).  Its FLOPs and bytes columns
must sum to the step's counts: on reduced cells (qwen3-0.6b at
`reduce_config` on a ``{"data": 2, "model": 2}`` rank, on ``meta``) of
each kind, and through the CLI on the production ``decode_32k`` cell.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs.base import ShapeSpec, get_config, reduce_config
from repro_torch.core.mesh import AbstractRankMesh
from repro_torch.launch import dryrun, step_cost
from repro_torch.models.common import MetaGen
from repro_torch.models.model import LM
from repro_torch.sharding.partition import make_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_trace(path):
    """``(ops, launches, collectives, totals)`` of a trace file."""
    parts = {"ops": [], "launches": [], "collectives": []}
    totals, part = None, None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("# total"):
                totals = {k: int(v) for k, v in
                          (kv.split("=") for kv in line.split()[2:])}
            elif line.startswith("# "):
                part = line[2:].split(":")[0]
            else:
                parts[part].append(line)
    return parts, totals


def sums(parts):
    ops = [ln.split("\t") for ln in parts["ops"]]
    launches = [ln.split("\t") for ln in parts["launches"]]
    return (sum(int(o[1]) for o in ops) + sum(int(k[4]) for k in launches),
            sum(int(o[2]) for o in ops) + sum(int(k[5]) for k in launches))


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_trace_sums_to_the_reduced_cell(kind, tmp_path):
    cfg = reduce_config(get_config("qwen3-0.6b"))
    shape = ShapeSpec(kind, 64, 4, kind)
    plan = make_plan(AbstractRankMesh({"data": 2, "model": 2}, 0), cfg,
                     shape)
    step, args = dryrun.build_cell(cfg, shape, plan, LM(cfg).init(MetaGen()))
    _, cost, _ = dryrun.cost_step(step, args, grad=kind == "train",
                                  trace=True)
    path = str(tmp_path / "step.txt")
    step_cost.write_trace(path, cost)
    parts, totals = read_trace(path)
    assert len(parts["ops"]) == len(cost["trace_ops"]) > 0
    assert len(parts["launches"]) == len(cost["launches"])
    assert (kind == "prefill") == bool(parts["launches"])
    assert len(parts["collectives"]) == len(cost["collective_ops"]) > 0
    assert [json.loads(r)["kind"] for r in parts["collectives"]] == [
        r["kind"] for r in cost["collective_ops"]]
    assert sums(parts) == (cost["flops"], cost["bytes"])
    assert totals == {"flops": cost["flops"], "bytes": cost["bytes"]}


def test_cli_saves_the_trace_of_a_production_cell(tmp_path):
    trace, out = str(tmp_path / "step.txt"), str(tmp_path / "cell.json")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--save-trace", trace, "--out", out], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as f:
        cell = json.load(f)
    parts, _ = read_trace(trace)
    assert sums(parts) == (cell["flops_per_device"], cell["bytes_per_device"])
    assert len(parts["collectives"]) == sum(
        cell["collective_counts"].values())
