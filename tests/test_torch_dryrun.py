"""The port's dry run of one rank's step (`launch.dryrun`, `launch.sweep`)
against the reference's committed cells and against a real rank.

* qwen3-0.6b's three cells of the production mesh ``{"data": 16,
  "model": 16}`` run on ``meta`` tensors: their ``model_flops_global``
  equals the reference's committed cells (`results/dryrun/`) exactly, each
  rank's collective log equals `train_schedule` / `serve_schedule` for the
  same plan, and every count equals the port's committed cell
  (`results/dryrun_torch/`: the dry run depends on no machine);
  ``long_500k`` is skipped with the reference's reason.
* On 4 gloo ranks of the CPU (``{"data": 2, "model": 2}``, a reduced
  qwen3-0.6b with the full config's parallel settings, so the residual
  of a train step and of a prefill is sequence-sharded): a train step, a decode step and a ``flash=False`` prefill
  built by `models.steps`' factories give, on rank 0, the FLOPs, HBM
  bytes, collective log and live-scan peak that the abstract mesh's
  rank 0 gives on ``meta`` (no step reaches a kernel wrapper: on the CPU a
  wrapper runs its plain version, whose ATen ops the counters would
  see); every rank's log equals its schedule; and the factories'
  prefill and decode logits, assembled from the ranks' rows and
  vocabulary blocks, equal one process's within rtol 1e-4 / atol 1e-5
  (`tests/test_torch_serve_ranks.py`'s tolerance): the factories carry
  the plan.  So do the sequence-sharded prefills of a reduced
  deepseek-moe-16b and mamba2-2.7b (the MoE and Mamba2 members).
* The sweep skips a cell whose JSON says ``ok``, runs a corrupt one
  again and carries on past a cell that ends in ``error``.

Spawned ranks import this module, so it imports no JAX.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import collectives
from repro_torch.core.mesh import AbstractRankMesh, RankMesh
from repro_torch.launch.dryrun import (COUNT_KEYS, SKIP_REASON, build_cell,
                                       cost_step, run_cell, schedule_diffs)
from repro_torch.launch.mesh import spawn
from repro_torch.launch.sweep import cell_path
from repro_torch.models import LM
from repro_torch.models.common import MetaGen
from repro_torch.sharding.partition import (NULL_PLAN, homes_of, make_plan,
                                            serving_plan, tp_of)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CELLS = os.path.join(ROOT, "results", "dryrun")
PORT_CELLS = os.path.join(ROOT, "results", "dryrun_torch")
RTOL, ATOL = 1e-4, 1e-5

#: the rank mesh and the reduced steps held to a real rank
MESH = {"data": 2, "model": 2}
SMALL = {"train": ShapeSpec("t", 16, 4, "train"),
         "prefill": ShapeSpec("p", 16, 4, "prefill"),
         "decode": ShapeSpec("d", 32, 4, "decode")}


#: the sequence-sharded prefills of the other member kinds, held to one
#: process as qwen3-0.6b's is
PREFILL_ARCHS = ("deepseek-moe-16b", "mamba2-2.7b")


def small_cfg(arch="qwen3-0.6b"):
    """`arch` reduced, with its full config's parallel settings (sequence
    sharding, remat)."""
    full = get_config(arch)
    return reduce_config(full).replace(parallel=full.parallel)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_qwen3_cells_equal_the_reference_and_the_schedule(shape):
    got = run_cell("qwen3-0.6b", shape, False)
    with open(os.path.join(REF_CELLS, f"qwen3-0.6b_{shape}_sp.json")) as f:
        ref = json.load(f)
    assert got["status"] == "ok" and got["n_chips"] == ref["n_chips"] == 256
    assert got["model_flops_global"] == ref["model_flops_global"]
    assert got["schedule_diffs"] == []
    assert got["collective_counts"]
    launches = sum(k["count"] for k in got["kernel_launches"])
    assert launches == (28 if shape == "prefill_32k" else 0)
    with open(cell_path(PORT_CELLS, "qwen3-0.6b", shape, False)) as f:
        committed = json.load(f)
    assert {k: got[k] for k in COUNT_KEYS} == {k: committed[k]
                                               for k in COUNT_KEYS}


def qwen3_terms(shape_name):
    """One rank's FLOPs and collective payloads of qwen3-0.6b's cell on
    ``{"data": 16, "model": 16}``, term by term, in the port's program:
    a rank holds 1 of the 16 q heads, all 8 KV heads (8 do not divide
    16), 192 of the 3072 MLP columns and 9504 of the 152064 vocabulary
    columns; the residual is sequence-sharded over "model" in training
    and prefill."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels.flash_attention import work
    cfg, shape = get_config("qwen3-0.6b"), SHAPES[shape_name]
    M = n = 16
    L, D, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads // M, cfg.num_kv_heads
    F, V = cfg.d_ff // M, cfg.vocab_padded // M
    B, S = shape.global_batch // n, shape.seq_len
    T = B * S

    def mm(m, k, n_):
        return 2 * m * k * n_
    t = {"kv": 2 * mm(T, D, KV * hd),
         "proj": mm(T, D, H * hd) + mm(T, H * hd, D) + 3 * mm(T, D, F),
         "all_pairs": 2 * mm(B * H * S, hd, S),
         "causal_pairs": work(B, H, KV, S, S, hd, 128, 128, True, 0,
                              cfg.dtype)["flops"],
         "head_all": mm(T, D, V), "head_last": mm(B, D, V),
         "activation": T * D, "L": L, "M": M}
    return t


#: where the reference's committed qwen3-0.6b cells (`results/dryrun/`)
#: count otherwise than the port's, each difference by name: FLOPs per
#: device, then collective bytes in the reference's convention (each
#: collective's result bytes, an all-reduce twice; `repro/launch/
#: hlo_cost.py`).  The reference's cells were compiled for placeholder
#: CPU devices, where XLA computes the bf16 dots in float32, so its
#: collectives carry float32 activations.
def reference_flops(shape_name, port):
    t = qwen3_terms(shape_name)
    L, M = t["L"], t["M"]
    # XLA projects K and V on each rank's sequence shard and gathers
    # them; the port projects all 8 KV heads on the whole gathered
    # sequence on each of the 16 ranks of "model"
    kv_once = L * t["kv"] * (M - 1) // M
    if shape_name == "train_4k":
        # forward, remat's recompute and the backward's two products:
        # four passes of every stack product in both; the chunked
        # attention computes every (query, key) pair in both.  Not
        # explained: one (4096 x 1024) x (1024 x 1024) product a layer,
        # which the reference's cell lacks (it keeps its 12 largest dots
        # only, so which one cannot be read from it)
        return port - 4 * kv_once - L * 2 * 4096 * 1024 * 1024
    if shape_name == "prefill_32k":
        # the reference's chunked attention also computes the masked
        # pairs that the kernel skips (`flash_attention.work`), and its
        # head gives logits at every position, the port's at the last
        return (port - kv_once + L * (t["all_pairs"] - t["causal_pairs"])
                + t["head_all"] - t["head_last"])
    return port                     # decode: the same program


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_qwen3_cells_against_the_reference_counts(shape):
    """The port's FLOPs a rank, rebuilt term by term, and the reference's
    committed FLOPs and collective bytes from the port's by the named
    differences (`reference_flops`)."""
    with open(os.path.join(REF_CELLS, f"qwen3-0.6b_{shape}_sp.json")) as f:
        ref = json.load(f)
    with open(cell_path(PORT_CELLS, "qwen3-0.6b", shape, False)) as f:
        port = json.load(f)
    t = qwen3_terms(shape)
    L = t["L"]
    if shape == "train_4k":
        assert port["flops_per_device"] == (
            4 * L * (t["kv"] + t["proj"] + t["all_pairs"])
            + 3 * t["head_all"])
    elif shape == "prefill_32k":
        assert port["flops_per_device"] == (
            L * (t["kv"] + t["proj"] + t["causal_pairs"]) + t["head_last"])
    assert ref["flops_per_device"] == reference_flops(
        shape, port["flops_per_device"])
    M, det = t["M"], port["collective_detail"]
    if shape == "decode_32k":
        # every collective is over "model" (g = 16): its payload from its
        # wire bytes; the reference's activations in float32 (2x), and it
        # merges the cache blocks' attention partials (float32 in both)
        # by an all-reduce where the port sends them by an all-to-all
        sums = det["all-reduce"] // (M - 1)
        gathered = det["all-gather"] * M // (M - 1)
        partials = det["all-to-all"] * M // (M - 1)
        assert ref["collective_detail"] == {
            "all-reduce": 2 * (2 * sums) + 2 * partials,
            "all-gather": 2 * gathered}
    if shape == "prefill_32k":
        # the two sums a layer over "model": XLA all-reduces the whole
        # float32 activation, the port reduce-scatters the bf16 one
        assert ref["collective_detail"]["all-reduce"] == \
            2 * L * 2 * 4 * t["activation"]
        assert port["collective_counts"]["reduce-scatter"] == 2 * L + 1
    # what is left unexplained (PERF.md section 7): the reference's
    # all-gathers and all-to-alls in prefill, and its training
    # collectives, which its cells give only as totals by kind


def reference_skip_reason() -> str:
    """The reason the reference's `run_cell` gives a skipped cell, read off
    its source (importing it would set its 512-device XLA flags here)."""
    with open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")) as f:
        tree = ast.parse(f.read())
    return next(v.value for node in ast.walk(tree)
                if isinstance(node, ast.Dict)
                for k, v in zip(node.keys, node.values)
                if isinstance(k, ast.Constant) and k.value == "reason")


def test_long_500k_is_skipped_with_the_reference_reason():
    got = run_cell("qwen3-0.6b", "long_500k", True)
    assert got["status"] == "skipped" and got["multi_pod"]
    assert got["reason"] == SKIP_REASON == reference_skip_reason()
    # a sub-quadratic arch runs it
    assert get_config("mamba2-2.7b").subquadratic


def _facts(out, cost, facts):
    live = facts["liveness"]
    return {"flops": cost["flops"], "bytes": cost["bytes"],
            "aten_flops": cost["aten_flops"], "log": cost["collective_ops"],
            "peak": live["peak_bytes"], "param_bytes": live["param_bytes"],
            "launches": len(cost["launches"])}


def rank_cells(device):
    """Each reduced step on this rank: its counts, its log against the
    schedule and its logits (this rank's rows and vocabulary block)."""
    cfg = small_cfg()
    mesh = RankMesh(MESH, device=device)
    out = {}
    for kind, shape in SMALL.items():
        # drawn anew: a train step updates the parameters in place
        whole = LM(cfg).init(torch.Generator().manual_seed(0))
        plan = make_plan(mesh, cfg, shape)
        step, args = build_cell(cfg, shape, plan, whole,
                                gen=torch.Generator().manual_seed(1),
                                flash=False)
        collectives.reset_collectives()
        res, cost, facts = cost_step(step, args, grad=kind == "train")
        out[kind] = _facts(res, cost, facts)
        out[kind]["schedule"] = schedule_diffs(cfg, shape, plan,
                                               cost["collective_ops"])
        if kind != "train":
            splan = serving_plan(plan)
            out[kind]["block"] = (homes_of(splan)[1], tp_of(splan)[1],
                                  res[0].numpy())
    for arch in PREFILL_ARCHS:
        acfg, shape = small_cfg(arch), SMALL["prefill"]
        plan = serving_plan(make_plan(mesh, acfg, shape))
        step, args = build_cell(acfg, shape, plan,
                                LM(acfg).init(torch.Generator().manual_seed(0)),
                                gen=torch.Generator().manual_seed(1),
                                flash=False)
        with torch.no_grad():
            res = step(*args)
        out[arch] = {"block": (homes_of(plan)[1], tp_of(plan)[1],
                               res[0].float().numpy())}
    assert "jax" not in sys.modules, "a rank process imported JAX"
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(rank_cells, 4, "gloo", "cpu")


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_abstract_rank_equals_a_gloo_rank(ranks, kind):
    cfg = small_cfg()
    mesh = AbstractRankMesh(MESH, rank=0)
    shape = SMALL[kind]
    step, args = build_cell(cfg, shape, make_plan(mesh, cfg, shape),
                            LM(cfg).init(MetaGen()), flash=False)
    collectives.reset_collectives()
    got = _facts(*cost_step(step, args, grad=kind == "train"))
    collectives.reset_collectives()
    want = {k: v for k, v in ranks[0][kind].items()
            if k not in ("schedule", "block")}
    assert got == want
    assert got["log"] and got["launches"] == 0 and got["flops"] > 0
    assert all(r[kind]["schedule"] == [] for r in ranks)


@pytest.mark.parametrize("kind", ["prefill", "decode", *PREFILL_ARCHS])
def test_step_factories_carry_the_plan(ranks, kind):
    cfg = small_cfg(kind if kind in PREFILL_ARCHS else "qwen3-0.6b")
    shape = SMALL[kind if kind in SMALL else "prefill"]
    assert shape.kind == "decode" or make_plan(
        AbstractRankMesh(MESH), cfg, shape).seq_axis == "model"
    step, args = build_cell(cfg, shape, NULL_PLAN,
                            LM(cfg).init(torch.Generator().manual_seed(0)),
                            gen=torch.Generator().manual_seed(1),
                            flash=False)
    with torch.no_grad():
        want = step(*args)[0].float().numpy()
    got = np.full_like(want, np.nan)
    b, v = want.shape[0] // MESH["data"], want.shape[1] // MESH["model"]
    for r in ranks:
        h, i, block = r[kind]["block"]
        got[h * b:(h + 1) * b, i * v:(i + 1) * v] = block
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sweep_restarts_and_carries_on(tmp_path):
    """An ``ok`` cell is skipped (its file untouched), a corrupt one runs
    again, and a cell that ends in ``error`` does not stop the sweep."""
    out = str(tmp_path)
    kept = cell_path(out, "qwen3-0.6b", "long_500k", False)
    with open(kept, "w") as f:
        json.dump({"status": "ok", "kept": True}, f)
    corrupt = cell_path(out, "qwen3-0.6b", "long_500k", True)
    with open(corrupt, "w") as f:
        f.write("{not json")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--outdir", out,
         "--archs", "no-such-arch,qwen3-0.6b", "--shapes", "long_500k",
         "--timeout", "300"], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "SKIP (exists, ok)" in r.stdout
    with open(kept) as f:
        assert json.load(f) == {"status": "ok", "kept": True}
    with open(corrupt) as f:
        assert json.load(f)["status"] == "skipped"
    for mp in (False, True):
        with open(cell_path(out, "no-such-arch", "long_500k", mp)) as f:
            cell = json.load(f)
        assert cell["status"] == "error" and "no-such-arch" in cell["error"]
    assert r.stdout.count("-> FAIL") == 2 and r.stdout.count("-> ok") == 1
