"""Dry-run sweep: every (arch x shape x mesh) cell in its own subprocess.

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        [--outdir results/dryrun_torch] [--archs a,b] [--shapes s,t] \\
        [--meshes sp,mp] [--timeout S] [--force]

The counterpart of `repro/launch/sweep.py`: the same cells, flags and
restart rule.  Each cell runs ``python -m repro_torch.launch.dryrun`` in
a process of its own under `--timeout` (a timed-out cell is written as
``"timeout"``), and a cell whose JSON already says ``ok`` or ``skipped``
is skipped unless `--force` is given, so the sweep is restartable; a
cell that says ``error``, ``timeout`` or cannot be read is run again.
The cells run on ``meta`` tensors (`launch.dryrun`), so the sweep needs
no card, and its figures depend on no machine.  It writes to
``results/dryrun_torch/``; ``results/dryrun/`` is the reference's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCH_ORDER = ["qwen3-0.6b", "granite-3-2b", "musicgen-medium", "mamba2-2.7b",
              "glm4-9b", "deepseek-moe-16b", "mixtral-8x7b", "granite-20b",
              "llama-3.2-vision-90b", "jamba-1.5-large-398b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cell_path(outdir, arch, shape, mp):
    return os.path.join(outdir, f"{arch}_{shape}_{'mp' if mp else 'sp'}.json")


def cell_status(path) -> str:
    """The status a cell's JSON records (``"corrupt"`` where it cannot be
    read, ``"missing"`` where there is none)."""
    if not os.path.exists(path):
        return "missing"
    try:
        with open(path) as f:
            return json.load(f).get("status", "corrupt")
    except (OSError, ValueError, AttributeError):
        return "corrupt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--archs", default=",".join(ARCH_ORDER))
    ap.add_argument("--shapes", default=",".join(SHAPE_ORDER))
    ap.add_argument("--meshes", default="sp,mp")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    cells = [(a, s, mp) for mp in [m == "mp" for m in args.meshes.split(",")]
             for a in args.archs.split(",") for s in args.shapes.split(",")]
    t00 = time.time()
    for i, (arch, shape, mp) in enumerate(cells):
        out = cell_path(args.outdir, arch, shape, mp)
        st = cell_status(out)
        if st in ("ok", "skipped") and not args.force:
            print(f"[{i+1}/{len(cells)}] SKIP (exists, {st}) {out}",
                  flush=True)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out]
        if mp:
            cmd.append("--multipod")
        t0 = time.time()
        print(f"[{i+1}/{len(cells)}] RUN {arch} {shape} "
              f"{'mp' if mp else 'sp'} ...", flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            status = "ok" if r.returncode == 0 else "FAIL"
            tail = (r.stdout + r.stderr).strip().splitlines()[-1:] \
                if status == "FAIL" else []
        except subprocess.TimeoutExpired:
            status, tail = "TIMEOUT", []
            with open(out, "w") as f:
                json.dump({"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "timeout"}, f)
        print(f"    -> {status} in {time.time()-t0:.0f}s "
              f"(total {time.time()-t00:.0f}s) {' '.join(tail)[:300]}",
              flush=True)


if __name__ == "__main__":
    main()
