"""Serving launcher of the port: the batched decode server on a device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        [--requests 8] [--slots 4] [--policy fifo|homed] [--pods PxD[xM]] \
        [--ranks N [--backend gloo|nccl]] [--device cuda|cpu] [--ckpt DIR] \
        [--trace PATH] [--json] [--smoke]

The counterpart of `repro/launch/serve.py`, with the same synthetic
request stream and the same reduced model (``layers=4``; a config whose
superblock does not divide 4 -- jamba's 8 layers -- takes one
superblock), its parameters drawn from a `torch.Generator` seeded 0.
Under ``--ckpt`` they are restored from the latest step there, as the
reference restores them, at the depth that checkpoint holds (the
reference serves 4 layers, so it cannot restore its own `launch.train`'s
2-layer checkpoints): a `launch.train` checkpoint of the same ``--arch``,
or the reference's (the two packages read each other's files).
``--policy`` selects the serving
scheduler: ``fifo`` is the arrival-order oracle, ``homed`` routes/
batches/evicts by each slot's cache home.  ``--pods PxD[xM]`` serves over
a `HomeMesh` of ``{"pod": P, "data": D, "model": M}`` homes on the one
device, so the scheduler's inter-pod vs intra-pod relayout split shows.
``--ranks N`` serves across a world of N ``torch.distributed`` processes
on this host (`launch.mesh.spawn`, ``--backend`` gloo by default, or
nccl with one rank a card): without ``--pods`` on a flat ``{"data": N,
"model": 1}`` mesh, as the reference serves on a flat data mesh of every
device, and with ``--pods PxDxM`` (P*D*M = N) on that mesh, the model
split over "model" as `make_plan` says.  Each rank cuts the seeded
parameters to its blocks (`convert.rank_params`) and serves its home's
slots; rank 0 prints the summary, and every rank's scheduler must have
made the same decisions (`runtime.server.event_digest`).
``--device`` (default the card; ``cpu`` runs the plain versions).  The
per-home admission summary prints at exit; it is the reference's, request
for request (the scheduler sees arrivals, sessions and prompt lengths,
never the tokens).  The vision config is not served: the server, like the
reference's, has no image input.

``--trace PATH`` streams a structured JSONL trace of the whole run
(scheduler decisions, charges, pool pins, per-wave decode spans).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, manifest, restore
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.convert import rank_params
from repro_torch.core.mesh import HomeMesh, resolve_device
from repro_torch.models.blocks import superblock_spec
from repro_torch.models.model import LM
from repro_torch.obs import Tracer, set_tracer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.server import DecodeServer, Request, event_digest
from repro_torch.sharding.partition import NULL_PLAN, make_plan

#: the served cache length (the reference launcher's)
MAX_LEN = 96


def parse_pods(spec: str):
    """``PxD`` or ``PxDxM`` -> (n_pods, n_data, n_model)."""
    try:
        parts = [int(p) for p in spec.lower().split("x")]
    except ValueError:
        parts = []
    if len(parts) == 2:
        parts.append(1)
    if len(parts) != 3 or any(p < 1 for p in parts):
        raise argparse.ArgumentTypeError(
            f"--pods wants PxD or PxDxM with positive ints, got {spec!r}")
    return tuple(parts)


def serve_shape(slots: int) -> ShapeSpec:
    """The decode cell the serving plan is made for (the reference's)."""
    return ShapeSpec("serve", MAX_LEN, slots, "decode")


def build_plan(pods, slots: int, device, cfg: ArchConfig):
    """The serving plan on one device: no mesh (one home), or the
    emulated-pod mesh."""
    if pods is None:
        return NULL_PLAN
    p, d, m = pods
    return make_plan(HomeMesh({"pod": p, "data": d, "model": m},
                              device=device), cfg, serve_shape(slots))


def rank_plan(pods, slots: int, device, cfg: ArchConfig):
    """The serving plan on this rank's world: a flat data mesh over every
    rank, or ``{"pod": P, "data": D, "model": M}``."""
    from repro_torch.launch.mesh import make_rank_mesh
    if pods is None:
        mesh = make_rank_mesh(n_model=1, device=device)
    else:
        p, d, m = pods
        mesh = make_rank_mesh(n_pods=p, n_data=d, n_model=m, device=device)
    return make_plan(mesh, cfg, serve_shape(slots))


def served_config(arch: str, ckpt=None) -> ArchConfig:
    """The served reduced config: 4 layers (the reference's), one
    superblock where the superblock does not divide 4, or the depth of
    the latest checkpoint under `ckpt` when there is one."""
    cfg = get_config(arch)
    members = len(superblock_spec(cfg))
    layers = 4 if 4 % members == 0 else members
    step = latest_step(ckpt) if ckpt else None
    if step is not None:
        stack = manifest(ckpt, step).get("params/stack/m0/ln1")
        if stack is None:
            raise ValueError(f"--ckpt {ckpt}: step {step} holds no "
                             f"model parameters")
        layers = stack["shape"][0] * members
    return reduce_config(cfg, layers=layers)


def load_params(cfg: ArchConfig, device, ckpt=None):
    """The served parameters: drawn from a generator seeded 0 on `device`,
    then, when `ckpt` holds a checkpoint, its latest step's ``params``
    in their place.  A checkpoint of another config is refused."""
    params = LM(cfg).init(torch.Generator(device=device).manual_seed(0))
    step = latest_step(ckpt) if ckpt else None
    if step is None:
        return params
    try:
        return restore(ckpt, step, {"params": params})["params"]
    except (AssertionError, KeyError) as e:
        raise ValueError(f"--ckpt {ckpt}: step {step} does not fit "
                         f"{cfg.name}: {e!r}") from None


def requests(cfg: ArchConfig, args):
    """The reference launcher's synthetic stream (seeded 0)."""
    rng = np.random.RandomState(0)
    out = []
    for rid in range(args.requests):
        plen = rng.randint(2, 9)
        out.append(Request(
            rid=rid,
            prompt=rng.randint(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=int(rng.choice([args.max_new // 2 or 1, args.max_new])),
            session=f"s{rng.randint(args.sessions)}",
            t_arrive=float(rid // max(1, args.slots))))
    return out


def serve(cfg: ArchConfig, params, args, device, tracer=None, plan=None):
    """Serve `requests` with `params` (on ranks, the rank's blocks for
    `plan`) as ``args`` ask; returns the drained server (its scheduler
    holds the summary) and the served requests, by id."""
    if plan is None:
        plan = build_plan(args.pods, args.slots, device, cfg)
    srv = DecodeServer(cfg, params, batch_slots=args.slots, max_len=MAX_LEN,
                       plan=plan, scheduler=args.policy,
                       prompt_pad=args.prompt_pad or None, tracer=tracer)
    for r in requests(cfg, args):
        srv.submit(r)
    return srv, sorted(srv.run(), key=lambda r: r.rid)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--ckpt", default=None,
                    help="serve the latest checkpoint's params from here")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--policy", choices=("fifo", "homed"), default="fifo",
                    help="serving scheduler: arrival-order oracle vs "
                    "home-aware routing/batching/eviction")
    ap.add_argument("--pods", type=parse_pods, default=None, metavar="PxD[xM]",
                    help="serve over an emulated (pod, data, model) mesh")
    ap.add_argument("--sessions", type=int, default=4,
                    help="distinct affinity keys in the synthetic stream")
    ap.add_argument("--prompt-pad", type=int, default=16,
                    help="fixed prefill pad bucket (wave-composition-"
                    "independent numerics); 0 = per-wave max")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default the card)")
    ap.add_argument("--ranks", type=int, default=0, metavar="N",
                    help="serve across N torch.distributed ranks")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="the ranks' process group backend")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="stream a structured JSONL trace here")
    ap.add_argument("--json", action="store_true",
                    help="also print the summary as one JSON line")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: 8 requests, 4 slots, max-new 4")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.slots, args.max_new = 8, 4, 4
    return args


def report(srv, served, args) -> list:
    """The launcher's lines: each request, the summary (and its JSON)."""
    lines = [f"req {r.rid} (session {r.session}, home {r.home}, "
             f"wait {r.wait:.0f}): -> {r.out}" for r in served]
    summary = srv.scheduler.emit_summary()
    lines.append(obs_metrics.format_summary(summary))
    if args.json:
        lines.append(json.dumps(summary))
    return lines


def rank_main(device, args) -> dict:
    """One rank of ``--ranks``: serve this rank's home and return the
    report (printed by rank 0), the scheduler's event digest and the
    rank's collectives."""
    from repro_torch.core import collectives
    cfg = served_config(args.arch, args.ckpt)
    plan = rank_plan(args.pods, args.slots, device, cfg)
    params = rank_params(load_params(cfg, plan.mesh.device, args.ckpt),
                         plan, cfg)
    tracer = Tracer(args.trace if args.trace and plan.mesh.rank == 0
                    else None, tool="launch.serve", arch=args.arch,
                    policy=args.policy, slots=args.slots, pods=args.pods,
                    requests=args.requests, ranks=args.ranks)
    collectives.reset_collectives()
    srv, served = serve(cfg, params, args, device, tracer, plan=plan)
    lines = report(srv, served, args)
    tracer.close()
    return {"lines": lines, "digest": event_digest(tracer),
            "log": collectives.collective_log(), "calls": srv.calls,
            "records": len(tracer.records())}


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.ranks:
        from repro_torch.launch.mesh import spawn
        ranks = spawn(rank_main, args.ranks, args.backend, str(device), args)
        digests = {r["digest"] for r in ranks}
        if len(digests) != 1:
            raise SystemExit(f"the ranks' schedulers diverged: "
                             f"{len(digests)} event digests")
        print("\n".join(ranks[0]["lines"]))
        if args.trace:
            print(f"# trace: {args.trace} ({ranks[0]['records']} records)")
        return
    cfg = served_config(args.arch, args.ckpt)
    params = load_params(cfg, device, args.ckpt)
    tracer = None
    if args.trace:
        tracer = Tracer(args.trace, tool="launch.serve", arch=args.arch,
                        policy=args.policy, slots=args.slots,
                        pods=args.pods, requests=args.requests)
        set_tracer(tracer)
    srv, served = serve(cfg, params, args, device, tracer)
    print("\n".join(report(srv, served, args)))
    if tracer is not None:
        tracer.close()
        set_tracer(None)
        print(f"# trace: {args.trace} ({len(tracer.records())} records)")


if __name__ == "__main__":
    main()
