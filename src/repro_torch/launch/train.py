"""Training launcher: the fault-tolerant `Trainer` on one device; the
counterpart of `repro/launch/train.py`.

The reduced config, on the CPU (a real end-to-end loop, seconds):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --device cpu --steps 30
The full config on one card (qwen3-0.6b at full width, bf16, remat):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --full --global-batch 2 --seq-len 4096 --steps 12

Under `--supervised` the loop runs beneath the heartbeat `Supervisor`:
crashes and hangs relaunch from the latest atomic checkpoint.  The
reference's ``--production``/``--multipod`` (a TPU pod mesh) wait for the
``torch.distributed`` backend.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs import get_config, reduce_config
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
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
                    help="the unreduced config on one device")
    ap.add_argument("--supervised", action="store_true")
    args = ap.parse_args(argv)

    if args.supervised:
        from repro_torch.runtime.ft import Supervisor
        cmd = [sys.executable, "-m", "repro_torch.launch.train"] + [
            a for a in argv if a != "--supervised"]
        out = Supervisor(cmd=cmd, max_restarts=3).run()
        print("\n".join(out["stdout"][-5:]))
        sys.exit(0 if out["ok"] else 1)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduce_config(cfg)
    t = TrainerConfig(steps=args.steps, global_batch=args.global_batch,
                      seq_len=args.seq_len, ckpt_dir=args.ckpt,
                      ckpt_every=max(args.steps // 5, 1), log_every=10,
                      device=args.device)
    res = Trainer(cfg, t).run()
    print(f"done: step={res['final_step']} loss={res['final_loss']}")


if __name__ == "__main__":
    main()
