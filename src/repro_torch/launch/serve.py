"""Serving launcher of the port: the batched decode server on a device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        [--requests 8] [--slots 4] [--policy fifo|homed] [--pods PxD[xM]] \
        [--device cuda|cpu] [--trace PATH] [--json] [--smoke]

The counterpart of `repro/launch/serve.py`, with the same synthetic
request stream and the same reduced model (``layers=4``), its parameters
drawn from a `torch.Generator` seeded 0.  ``--policy`` selects the serving
scheduler: ``fifo`` is the arrival-order oracle, ``homed`` routes/
batches/evicts by each slot's cache home.  ``--pods PxD[xM]`` serves over
a `HomeMesh` of ``{"pod": P, "data": D, "model": M}`` homes on the one
device, so the scheduler's inter-pod vs intra-pod relayout split shows.
``--device`` (default the card; ``cpu`` runs the plain versions).  The
per-home admission summary prints at exit; it is the reference's, request
for request (the scheduler sees arrivals, sessions and prompt lengths,
never the tokens).  ``--ckpt`` waits for the training slice's checkpoints.

``--trace PATH`` streams a structured JSONL trace of the whole run
(scheduler decisions, charges, pool pins, per-wave decode spans).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.mesh import HomeMesh, resolve_device
from repro_torch.models.model import LM
from repro_torch.obs import Tracer, set_tracer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.server import DecodeServer, Request
from repro_torch.sharding.partition import NULL_PLAN, make_plan


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


def build_plan(pods, slots: int, device):
    """The serving plan: no mesh (one home), or the emulated-pod mesh."""
    if pods is None:
        return NULL_PLAN
    p, d, m = pods
    return make_plan(HomeMesh({"pod": p, "data": d, "model": m},
                              device=device), slots)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--ckpt", default=None)
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="stream a structured JSONL trace here")
    ap.add_argument("--json", action="store_true",
                    help="also print the summary as one JSON line")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: 8 requests, 4 slots, max-new 4")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.slots, args.max_new = 8, 4, 4
    if args.ckpt:
        raise NotImplementedError("--ckpt: checkpoints come with the "
                                  "training slice (ROADMAP.md Queue 1)")

    device = resolve_device(args.device)
    cfg = reduce_config(get_config(args.arch), layers=4)
    params = LM(cfg).init(torch.Generator(device=device).manual_seed(0))
    plan = build_plan(args.pods, args.slots, device)
    tracer = None
    if args.trace:
        tracer = Tracer(args.trace, tool="launch.serve", arch=args.arch,
                        policy=args.policy, slots=args.slots,
                        pods=args.pods, requests=args.requests)
        set_tracer(tracer)
    srv = DecodeServer(cfg, params, batch_slots=args.slots, max_len=96,
                       plan=plan, scheduler=args.policy,
                       prompt_pad=args.prompt_pad or None, tracer=tracer)
    rng = np.random.RandomState(0)
    for rid in range(args.requests):
        plen = rng.randint(2, 9)
        srv.submit(Request(
            rid=rid,
            prompt=rng.randint(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=int(rng.choice([args.max_new // 2 or 1, args.max_new])),
            session=f"s{rng.randint(args.sessions)}",
            t_arrive=float(rid // max(1, args.slots))))
    for r in sorted(srv.run(), key=lambda r: r.rid):
        print(f"req {r.rid} (session {r.session}, home {r.home}, "
              f"wait {r.wait:.0f}): -> {r.out}")
    summary = srv.scheduler.emit_summary()
    print(obs_metrics.format_summary(summary))
    if args.json:
        print(json.dumps(summary))
    if tracer is not None:
        tracer.close()
        set_tracer(None)
        print(f"# trace: {args.trace} ({len(tracer.records())} records)")


if __name__ == "__main__":
    main()
