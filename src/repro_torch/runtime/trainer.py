"""Fault-tolerant training loop: the counterpart of `repro/runtime/trainer.py`.

Failure model:
  * crash/preemption  -- atomic checkpoints every K steps; SIGTERM/SIGINT
    trigger a final save; restart resumes from the latest complete step
    and, because the data pipeline is a pure function of the step index,
    replays the exact same batches (bitwise-deterministic resume on the
    CPU; on the card under ``torch.use_deterministic_algorithms``).
  * bad steps         -- a non-finite loss or a gradient norm above
    `grad_spike` aborts the step, restores the last checkpoint in-process
    and skips the offending batch (loss-spike guard).  The step updates in
    place, so the guard is decided on the step's loss and gradient norm
    before anything is written (`models.steps.make_train_step`'s
    ``accept``); the skipped steps and the state after them are the
    reference's.
  * stragglers        -- per-step wall-time watchdog: steps slower than
    `straggler_factor` x running median are logged and counted; the
    `Supervisor` (ft.py) escalates to a restart.

The model is ``LM(cfg, flash=False)``: the `flash_attention` kernel has
no backward pass, and the reference trains on its chunked attention too.

Across ``torch.distributed`` ranks (`plan` on a `RankMesh`, the same
`mesh`) each rank draws only its blocks (`LM.init` with `convert.
rank_cut`), its data pipeline builds only its home's rows, checkpoints
are written and restored elastically (`checkpoint.save`/`restore` with
the specs), and everything that decides control flow is agreed: the
guard reads the step's loss and norm, the same bits on every rank; a
stop signal is summed over the mesh at each step boundary (one counted
`psum`), so every rank stops at the same step and saves together.  Rank
0 alone prints and writes the metrics file.
"""
from __future__ import annotations

import json
import os
import signal
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs.base import ArchConfig
from repro_torch.core.mesh import RankMesh, entry_device
from repro_torch.data import make_batch_iterator
from repro_torch.models.model import LM
from repro_torch.models.steps import init_opt_state, make_train_step
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.sharding.partition import (NULL_PLAN, MeshPlan,
                                            full_opt_specs, param_specs)


@dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    lr: float = 3e-4
    warmup: int = 10
    straggler_factor: float = 3.0
    schedule_total: Optional[int] = None   # decouple LR horizon from loop end
    grad_spike: float = 1e4
    metrics_path: Optional[str] = None
    device: str = "cuda"                   # where a mesh-less trainer runs


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 plan: MeshPlan = NULL_PLAN, mesh=None):
        self.cfg, self.tcfg, self.plan, self.mesh = cfg, tcfg, plan, mesh
        self.device = entry_device(mesh, None if mesh is not None
                                   else tcfg.device)
        self.model = LM(cfg, flash=False)
        total = tcfg.schedule_total or tcfg.steps
        self.opt = AdamW(lr=cosine_schedule(tcfg.lr, tcfg.warmup, total))
        self.step_fn = make_train_step(self.model, cfg, plan, self.opt)
        self.ranks = isinstance(mesh, RankMesh)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_every,
                                      mesh=mesh if self.ranks else None)
        self.lead = not self.ranks or mesh.rank == 0
        self.slow_steps = 0
        self._stop = False

    # ------------------------------------------------------------- lifecycle
    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._stop = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, handler)

    def init_or_restore(self):
        from repro_torch.convert import rank_cut
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(gen, cut=rank_cut(self.plan, self.cfg,
                                                   train=True)
                                 if self.ranks else None)
        opt_state = init_opt_state(self.cfg, self.opt, params, self.plan)
        start = 0
        last = latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            params, opt_state = self._restore(last, params, opt_state)
            start = last
        return params, opt_state, start

    def specs(self, params, opt_state):
        """The spec tree of the checkpointed state across ranks (None on
        one process)."""
        if not self.ranks:
            return None
        return {"params": param_specs(params, self.plan, self.cfg),
                "opt": full_opt_specs(opt_state, params, self.plan,
                                      self.cfg)}

    def _restore(self, step, params, opt_state):
        st = restore(self.tcfg.ckpt_dir, step,
                     {"params": params, "opt": opt_state},
                     self.specs(params, opt_state),
                     self.mesh if self.ranks else None)
        return st["params"], st["opt"]

    def _save(self, step, params, opt_state, force=False):
        tree = {"params": params, "opt": opt_state}
        if self.ranks:
            return self.ckpt.maybe_save(step, tree, force=force,
                                        specs=self.specs(params, opt_state))
        return self.ckpt.maybe_save(step, tree, force=force)

    def _stopping(self) -> bool:
        """The stop signal, agreed over the mesh across ranks."""
        if not self.ranks:
            return self._stop
        from repro_torch.core import collectives
        flag = torch.tensor([float(self._stop)], device=self.device)
        return float(collectives.psum(flag, self.mesh,
                                      tuple(self.mesh.shape))[0]) > 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        self._install_signal_handlers()
        t = self.tcfg
        params, opt_state, start = self.init_or_restore()
        data = make_batch_iterator(self.cfg, t.global_batch, t.seq_len,
                                   t.seed, self.mesh, start_step=start,
                                   device=self.device)
        durations, metrics_log = [], []
        step = start
        for step in range(start, t.steps):
            if self._stopping():
                break
            batch = next(data)
            self._sync()
            t0 = time.time()
            seen = {}

            # ---- loss-spike / NaN guard, decided before the update ----
            def accept(m):
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                seen.update(loss=loss, grad_norm=gnorm, ok=not (
                    not np.isfinite(loss) or gnorm > t.grad_spike))
                return seen["ok"]

            params, opt_state, _ = self.step_fn(params, opt_state, batch,
                                                accept=accept)
            self._sync()
            dt = time.time() - t0
            loss, gnorm = seen["loss"], seen["grad_norm"]
            if not seen["ok"]:
                last = latest_step(t.ckpt_dir)
                if last is not None:
                    params, opt_state = self._restore(last, params,
                                                      opt_state)
                continue  # skip the offending batch, keep going
            # ---- straggler watchdog ----
            durations.append(dt)
            med = statistics.median(durations[-50:])
            if len(durations) > 5 and dt > t.straggler_factor * med:
                self.slow_steps += 1
            if (step + 1) % t.log_every == 0 or step + 1 == t.steps:
                rec = {"step": step + 1, "loss": loss, "grad_norm": gnorm,
                       "step_time_s": round(dt, 4),
                       "slow_steps": self.slow_steps}
                metrics_log.append(rec)
                if self.lead:
                    print(json.dumps(rec), flush=True)
            self._save(step + 1, params, opt_state)
        if self.ckpt.saved_step != step + 1:     # not saved twice
            self._save(step + 1, params, opt_state, force=True)
        self.ckpt.wait()
        if t.metrics_path and self.lead:
            with open(t.metrics_path, "w") as f:
                json.dump(metrics_log, f, indent=1)
        return {"final_step": step + 1,
                "final_loss": metrics_log[-1]["loss"] if metrics_log else None,
                "params": params}
