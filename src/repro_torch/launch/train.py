"""Training launcher: the fault-tolerant `Trainer` on one device or across
``torch.distributed`` ranks; the counterpart of `repro/launch/train.py`.

The reduced config, on the CPU (a real end-to-end loop, seconds):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --device cpu --steps 30
The full config on one card (qwen3-0.6b at full width, bf16, remat):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --full --global-batch 2 --seq-len 4096 --steps 12
Across ranks (a world of N processes on this host, `launch.mesh.spawn`):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --ranks 4 [--pods PxD[xM]] [--backend gloo|nccl] [--device cpu]

``--ranks N`` trains on a flat ``{"data": N, "model": 1}`` mesh, or with
``--pods PxDxM`` (P*D*M = N) on ``{"pod": P, "data": D, "model": M}``,
the plan made for the run's global batch and sequence (`make_plan`): each
rank draws its blocks, builds its home's rows and checkpoints elastically
(`runtime.trainer`); rank 0 prints.  ``--backend`` is gloo by default
(ranks may share a card, every exchange staged through host memory) or
nccl (one rank a card).  ``--production`` (``--multipod``) trains the
full config on `make_production_mesh`'s 256 (512) ranks with the
reference's ``train_4k`` plan, and refuses a world of another size;
without ``--ranks`` it joins the world ``torchrun`` describes
(`init_from_env`).

Under ``--supervised`` the loop runs beneath the heartbeat `Supervisor`:
crashes and hangs relaunch the whole world from the latest atomic
checkpoint.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def parse_args(argv):
    from repro_torch.launch.serve import parse_pods
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_launch_train"))
    ap.add_argument("--device", default="cuda",
                    help="where to train (default the card; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="the unreduced config")
    ap.add_argument("--ranks", type=int, default=0,
                    help="train across a world of this many processes")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--pods", type=parse_pods, default=None,
                    help="PxD[xM]: the rank mesh's pod, data, model sizes")
    ap.add_argument("--production", action="store_true",
                    help="full config on the production mesh (256 ranks)")
    ap.add_argument("--multipod", action="store_true",
                    help="with --production: 2 pods, 512 ranks")
    ap.add_argument("--supervised", action="store_true")
    return ap.parse_args(argv)


def _train(args):
    """Train on this process's world, or alone; returns the run's
    result."""
    from repro_torch.sharding.partition import NULL_PLAN, make_plan
    cfg = get_config(args.arch)
    if not (args.full or args.production):
        cfg = reduce_config(cfg)
    t = TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                      seq_len=args.seq_len, ckpt_dir=args.ckpt,
                      ckpt_every=max(args.steps // 5, 1), log_every=10,
                      device=args.device)
    if args.production:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=args.multipod,
                                    device=args.device)
        plan = make_plan(mesh, cfg, SHAPES["train_4k"])
    elif args.ranks:
        from repro_torch.launch.mesh import make_rank_mesh
        if args.pods is None:
            mesh = make_rank_mesh(n_model=1, device=args.device)
        else:
            p, d, m = args.pods
            mesh = make_rank_mesh(n_pods=p, n_data=d, n_model=m,
                                  device=args.device)
        plan = make_plan(mesh, cfg, ShapeSpec("train", args.seq_len,
                                              args.global_batch, "train"))
    else:
        mesh, plan = None, NULL_PLAN
    return Trainer(cfg, t, plan=plan, mesh=mesh).run()


def rank_main(device, argv):
    """One rank of ``--ranks N`` (`launch.mesh.spawn`'s worker)."""
    res = _train(parse_args(argv))
    return {"final_step": res["final_step"], "final_loss": res["final_loss"]}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)

    if args.supervised:
        from repro_torch.runtime.ft import Supervisor
        cmd = [sys.executable, "-m", "repro_torch.launch.train"] + [
            a for a in argv if a != "--supervised"]
        out = Supervisor(cmd=cmd, max_restarts=3).run()
        print("\n".join(out["stdout"][-5:]))
        sys.exit(0 if out["ok"] else 1)

    if args.ranks:
        from repro_torch.launch.mesh import spawn
        res = spawn(rank_main, args.ranks, args.backend, args.device, argv)[0]
    else:
        if args.production:
            from repro_torch.launch.mesh import init_from_env
            init_from_env(args.backend)
        res = _train(args)
    print(f"done: step={res['final_step']} loss={res['final_loss']}")


if __name__ == "__main__":
    main()
