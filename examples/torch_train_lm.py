"""End-to-end run of the port: train a ~100M-param qwen3-family LM
for a few hundred steps with the full production stack (data pipeline,
AdamW + cosine, atomic checkpoints, loss-spike guard, resume).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \
          [--arch qwen3-0.6b] [--full] [--ckpt DIR] [--device cpu]

The counterpart of `examples/train_lm.py`, with its config and trainer
settings.  By default a width-reduced config (the reference's ~100M
``cfg.replace(...)``); ``--full`` trains the real config.  The metrics
file goes beside the checkpoint directory (``<ckpt>_metrics.json``), and
a run whose directory holds a checkpoint resumes from it.  It runs on
the card by default; ``--device cpu`` runs on the CPU.  With no card and
no ``--device cpu`` it raises.
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduce_config
from repro_torch.runtime.trainer import Trainer, TrainerConfig

from torch_quickstart import device_of


def config(arch: str, full: bool = False):
    cfg = get_config(arch)
    if not full:
        # ~100M-param qwen3-family config sized for a quick run
        cfg = cfg.replace(num_layers=12, d_model=640, num_heads=10,
                          num_kv_heads=2, head_dim=64, d_ff=2560,
                          vocab_size=2048,
                          dtype="float32", param_dtype="float32",
                          parallel=reduce_config(cfg).parallel)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    args, rest = ap.parse_known_args(argv)
    dev = device_of(rest)
    cfg = config(args.arch, args.full)
    n = cfg.param_counts()["total"]
    print(f"arch={cfg.name} params={n/1e6:.1f}M", flush=True)
    t = TrainerConfig(steps=args.steps, global_batch=4, seq_len=64,
                      ckpt_dir=args.ckpt, ckpt_every=50, log_every=10,
                      lr=2e-3, warmup=20, device=dev,
                      metrics_path=args.ckpt.rstrip(os.sep) + "_metrics.json")
    res = Trainer(cfg, t).run()
    print(f"done: step={res['final_step']} loss={res['final_loss']:.4f}")
    return res


if __name__ == "__main__":
    main()
