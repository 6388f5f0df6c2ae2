"""One (arch x shape x mesh) cell of the production mesh, costed without
allocating: the counterpart of `repro/launch/dryrun.py`'s ``run_cell``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multipod] [--rank R] [--out cell.json] \\
        [--save-trace step.txt]

The reference lowers and compiles the SPMD program of one cell for 256
(512) placeholder devices and reads its cost off the HLO.  The port runs
one rank's own program instead, on ``meta`` tensors: an
`core.mesh.AbstractRankMesh` of the production shape (``{"data": 16,
"model": 16}``, ``--multipod`` with ``"pod": 2`` before them) stands for
the world, `sharding.partition.make_plan` resolves the cell's plan on it,
the rank's parameter blocks (drawn by `models.common.MetaGen`, cut by
`convert.rank_params`), its batch rows, its decode cache and its AdamW
state are ``meta`` tensors, and the step that `models.steps` builds
(`make_train_step`, `make_prefill_step`, `make_decode_step`) runs once
under `launch.step_cost.counting` and `analysis.mem_facts.call_facts`.
Each collective appends the record a real rank would (`core.collectives`'
shape-only route) and `flash_attention` notes its launch and returns an
empty result, so nothing is computed and nothing is allocated.  Serving
cells run the plan the port serves with (`partition.serving_plan`:
parameters whole over the data axes) and the prefill through the kernel
(``LM(cfg)``); train cells run ``LM(cfg, flash=False)``, as training does
(the kernel has no backward pass).

The JSON keeps the reference's fields where they mean something here;
``trace_s`` replaces ``lower_s`` / ``compile_s``, ``step_flops_global``
replaces ``hlo_flops_global``, ``per_device_hbm_bytes`` is the live scan's
peak (`mem_facts.call_facts`), ``kernel_launches`` lists the launches
noted, ``schedule_diffs`` holds the rank's collective log against
`obs.schedule.train_schedule` / `serve_schedule` (empty: equal), and
``roofline`` uses the H100 hardware model below.  No figure of the cell
depends on the machine that runs it.  ``--save-trace PATH`` writes the
counted step as text (`step_cost.write_trace`: its ATen ops in order
with their FLOPs and bytes, its launches, its collective records), the
counterpart of the reference's ``--save-hlo``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.analysis.mem_facts import call_facts
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, get_config
from repro_torch.convert import rank_params
from repro_torch.core.mesh import AbstractRankMesh
from repro_torch.launch import step_cost
from repro_torch.launch.mesh import production_shape
from repro_torch.models.common import MetaGen, dt
from repro_torch.models.model import LM
from repro_torch.models.steps import (init_opt_state, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.optim import AdamW
from repro_torch.sharding.partition import (MeshPlan, cache_seq, homes_of,
                                            make_plan, serving_plan)
from repro_torch.tree import tree_leaves

# ---------------------------------------------------------------------------
# hardware model: one NVIDIA H100 SXM5 80 GB of an HGX H100 8-GPU node
# ---------------------------------------------------------------------------
#: dense bf16 tensor-core FLOP/s (NVIDIA H100 SXM datasheet: 1,979 TFLOP/s
#: with sparsity, half of it dense)
PEAK_FLOPS = 989e12
#: HBM3 bytes/s (NVIDIA H100 SXM datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: NVLink 4 bytes/s a direction inside a node (the datasheet's 900 GB/s
#: counts both directions)
NVLINK_BW = 450e9
#: bytes/s a GPU between nodes: one 400 Gb/s NDR InfiniBand port
#: (ConnectX-7) a GPU
IB_BW = 50e9

#: the figures of a cell that no machine changes: two runs of one cell
#: agree in all of them (``trace_s`` is the one that differs)
COUNT_KEYS = ("n_chips", "flops_per_device", "bytes_per_device",
              "aten_flops", "aten_bytes", "kernel_flops", "kernel_bytes",
              "collective_bytes_per_device", "collective_detail",
              "collective_counts", "collective_split", "schedule_diffs",
              "kernel_launches", "per_device_hbm_bytes", "param_bytes",
              "model_flops_global", "step_flops_global", "roofline")

SKIP_REASON = ("pure full-attention arch; long_500k needs sub-quadratic "
               "attention (DESIGN.md §4)")


def batch_rows(shape: ShapeSpec, plan: MeshPlan) -> int:
    """The rows of the global batch this rank holds: its home's share
    where the batch divides over the plan's batch axes, else all."""
    return shape.global_batch // (homes_of(plan)[0] if plan.batch_axes
                                  else 1)


def cell_batch(cfg: ArchConfig, shape: ShapeSpec, rows: int,
               device="meta", gen: Optional[torch.Generator] = None,
               home: int = 0) -> Dict[str, torch.Tensor]:
    """The rank's batch of the cell (the reference's `input_specs`, cut to
    `rows`): a train batch of S tokens with targets, a prefill of S
    tokens, or a decode step's one token a row.  Embeddings come in
    float32 to a train step, as the port's data pipeline gives them
    (`train_schedule` counts them so), and in the model's dtype to a
    serving step, as the reference's `input_specs` has them.  Empty
    tensors on `device`, or with `gen` (a CPU generator) values: the
    whole global batch drawn from it, of which the rows of `home` are
    kept, so that every rank and one process draw the same batch."""
    S = shape.seq_len if shape.kind != "decode" else 1
    n = rows if gen is None else shape.global_batch
    edt = torch.float32 if shape.kind == "train" else dt(cfg)

    def leaf(*size, dtype=torch.int32):
        if gen is None:
            return torch.empty(size, dtype=dtype, device=device)
        x = (torch.randint(0, cfg.vocab_size, size, generator=gen,
                           dtype=dtype) if dtype == torch.int32 else
             torch.randn(size, generator=gen).to(dtype))
        return x[home * rows:(home + 1) * rows].clone().to(device)

    batch = {"targets": leaf(n, S)} if shape.kind == "train" else {}
    if cfg.embed_input:
        batch["tokens"] = leaf(n, S)
    else:
        batch["embeds"] = leaf(n, S, cfg.d_model, dtype=edt)
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["image_embeds"] = leaf(n, cfg.num_image_tokens, cfg.d_model,
                                     dtype=edt)
    return batch


def build_cell(cfg: ArchConfig, shape: ShapeSpec, plan: MeshPlan,
               params, gen: Optional[torch.Generator] = None,
               flash: bool = True) -> Tuple:
    """``(step, args)`` of one rank of the cell: the step `models.steps`
    builds for `shape`'s kind on `plan` and its arguments, from the
    rank's whole parameters `params` (on ``meta`` for a dry run; on the
    CPU or the card, with `gen` for the batch's values, to hold it to a
    run), cut to the rank's blocks here.  `flash`: a serving step's
    prefill attention through the kernel (``LM(cfg)``); training always
    runs ``LM(cfg, flash=False)``."""
    dev = tree_leaves(params)[0].device
    kind = shape.kind
    plan = plan if kind == "train" else serving_plan(plan)
    rows = batch_rows(shape, plan)
    home = homes_of(plan)[1] if plan.batch_axes else 0
    batch = cell_batch(cfg, shape, rows, dev, gen, home)
    if kind == "train":
        mine = rank_params(params, plan, cfg, train=True)
        opt = AdamW(lr=3e-4)
        state = init_opt_state(cfg, opt, mine, plan)
        return (make_train_step(LM(cfg, flash=False), cfg, plan, opt),
                (mine, state, batch))
    model = LM(cfg, flash=flash)
    mine = rank_params(params, plan, cfg)
    if kind == "prefill":
        return make_prefill_step(model, cfg, plan), (mine, batch)
    caches = model.init_cache(rows, shape.seq_len, device=dev, plan=plan)
    slots = shape.seq_len if cache_seq(plan)[0] > 1 else None
    pos = torch.full((), shape.seq_len - 1, dtype=torch.int32, device=dev)
    return (make_decode_step(model, cfg, plan, cache_slots=slots),
            (mine, caches, batch, pos))


def cost_step(step, args, grad: bool,
              trace: bool = False) -> Tuple[Any, Dict, Dict]:
    """Run ``step(*args)`` once under `step_cost.counting` (with `trace`,
    listing every op) and `mem_facts.call_facts`; returns ``(its result,
    cost, facts)``.  Serving steps (``grad`` False) run under
    ``torch.no_grad``."""
    with torch.set_grad_enabled(grad), step_cost.counting(trace) as cost:
        out, facts = call_facts(step, *args)
    return out, cost, facts


def roofline(flops: float, nbytes: float, split: Dict) -> Dict:
    """Compute, memory and collective seconds of a step on the H100
    model, and which is largest."""
    terms = {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
             "collective": split["intra_node_bytes"] / NVLINK_BW
             + split["inter_node_bytes"] / IB_BW}
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "dominant": max(terms, key=terms.get)}


def schedule_diffs(cfg: ArchConfig, shape: ShapeSpec, plan: MeshPlan,
                   log) -> list:
    """The rank's collective log against its schedule (`obs.schedule`):
    the differences, empty when they agree."""
    from repro_torch.obs.schedule import (log_against_serve,
                                          log_against_train, serve_schedule,
                                          train_schedule)
    if shape.kind == "train":
        return log_against_train(log, train_schedule(cfg, plan, shape))
    splan = serving_plan(plan)
    call = {"call": shape.kind, "rows": batch_rows(shape, splan),
            "seq": shape.seq_len if shape.kind == "prefill" else 1}
    return log_against_serve(log, serve_schedule(cfg, splan, [call]))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rank: int = 0, save_trace: Optional[str] = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": SKIP_REASON}
    mesh = AbstractRankMesh(production_shape(multi_pod), rank)
    plan = make_plan(mesh, cfg, shape)
    t0 = time.time()
    params = LM(cfg).init(MetaGen())
    step, args = build_cell(cfg, shape, plan, params)
    _, cost, facts = cost_step(step, args, grad=shape.kind == "train",
                               trace=save_trace is not None)
    trace_s = time.time() - t0
    if save_trace:
        step_cost.write_trace(save_trace, cost)
    diffs = schedule_diffs(cfg, shape, plan, cost["collective_ops"])

    n_chips = mesh.size
    flops_dev, bytes_dev = float(cost["flops"]), float(cost["bytes"])
    counts = cfg.param_counts()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * counts["active"] \
        * tokens
    live = facts["liveness"]
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "n_chips": n_chips, "rank": rank,
        "mesh": mesh.shape, "trace_s": round(trace_s, 1),
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "aten_flops": float(cost["aten_flops"]),
        "aten_bytes": float(cost["aten_bytes"]),
        "kernel_flops": float(cost["kernel_flops"]),
        "kernel_bytes": float(cost["kernel_bytes"]),
        "collective_bytes_per_device": float(cost["collective_total"]),
        "collective_detail": cost["collective"],
        "collective_counts": cost["collective_counts"],
        "collective_split": cost["collective_split"],
        "schedule_diffs": diffs,
        "top_bytes_ops": [f"{b:.3e} {label} x{n}"
                          for b, label, n in cost["top_bytes"][:12]],
        "top_flops_ops": [f"{f:.3e} {label} x{n}"
                          for f, label, n in cost["top_flops"][:12]],
        "kernel_launches": cost["kernel_launches"],
        "per_device_hbm_bytes": live["peak_bytes"],
        "param_bytes": live["param_bytes"],
        "live_at_peak": [list(e) for e in live["live_at_peak"]],
        "model_flops_global": model_flops,
        "step_flops_global": flops_dev * n_chips,
        "useful_flops_ratio": (model_flops / (flops_dev * n_chips)
                               if flops_dev else 0.0),
        "roofline": roofline(flops_dev, bytes_dev, cost["collective_split"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-trace", default=None, metavar="PATH",
                    help="write the step's ops, launches and collectives")
    args = ap.parse_args(argv)
    try:
        res = run_cell(args.arch, args.shape, args.multipod, args.rank,
                       save_trace=args.save_trace)
    except Exception as e:  # noqa: BLE001 -- the sweep records failures
        # the checkout's own files by their paths in it
        root = str(Path(__file__).resolve().parents[3]) + os.sep
        res = {"arch": args.arch, "shape": args.shape,
               "multi_pod": args.multipod, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc().replace(root, "")[-4000:]}
    js = json.dumps(res, indent=1, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    print(js)
    if res["status"] == "ok":
        print(f"\n== cost ==\nflops/dev={res['flops_per_device']:.3e} "
              f"bytes/dev={res['bytes_per_device']:.3e} "
              f"coll/dev={res['collective_bytes_per_device']:.3e} "
              f"peak/dev={res['per_device_hbm_bytes']:.3e}")
    sys.exit(0 if res["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
