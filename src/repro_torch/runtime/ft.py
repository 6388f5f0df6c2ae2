"""Process-level fault tolerance: the counterpart of `repro/runtime/ft.py`.

`evacuate_home` drops a lost home's pooled KV pages (serving).  The
`Supervisor` runs a training process under a heartbeat: a dead, hung or
straggling worker is killed and relaunched, and the trainer resumes from
its latest atomic checkpoint (see tests/test_torch_train.py: kill -9
mid-run, relaunch, the run completes from the checkpoint).
"""
from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.obs import NULL_TRACER


def evacuate_home(scheduler, home: Optional[int] = None,
                  store=None) -> dict:
    """Serving-side device-loss/drain hook: drop one home's pooled prompt
    pages (every home when ``home`` is None) and the host-side content
    backing them.

    The pool state is *accounting*, not truth: in-flight requests hold
    private copies of everything they attached, so they finish untouched
    and their completion-time release finds nothing to unpin.  The
    affected sessions' next requests find no pooled prefix and re-enter as
    fresh, *charged* prefills -- the cost of the loss is paid visibly, in
    the same relayout ledger as every other cross-home byte.
    """
    dropped = scheduler.invalidate_pages(home)
    pruned = 0
    if store is not None:
        homes = scheduler.homes if home is None else [home]
        for h in homes:
            pruned += store.prune(h, scheduler.pool_keys(h))
    rec = {"home": home, "pages_dropped": dropped,
           "content_pruned": pruned}
    getattr(scheduler, "tracer", NULL_TRACER).event(
        "ft.evacuate", cat="ft", **rec)
    return rec


@dataclass
class Supervisor:
    cmd: List[str]
    max_restarts: int = 3
    heartbeat_timeout_s: float = 300.0   # no stdout for this long == hung
    env: Optional[dict] = None
    tracer: object = None                # repro_torch.obs tracer; None == off

    def run(self) -> dict:
        """Supervise to completion; always returns a structured record.

        ``{"ok", "reason", "restarts", "hangs", "final_rc", "history",
        "stdout"}`` where ``reason`` is one of:

          completed            -- a clean exit within the restart budget
          max_restarts         -- the relaunch budget ran out
          hung_restart_budget  -- the final attempt exited 0, but only
                                  after `max_restarts` heartbeat-kill
                                  restarts: a worker that repeatedly hung
                                  and then limped to rc=0 is not a healthy
                                  run.

        Crashes (non-zero exits without a heartbeat kill) consume the
        restart budget but never poison a subsequent clean exit -- the
        kill -9 -> relaunch -> resume path is the designed recovery.  Each
        attempt is an ``ft.attempt`` event of `tracer`, the outcome an
        ``ft.result`` event.
        """
        tr = self.tracer if self.tracer is not None else NULL_TRACER
        restarts = 0
        hangs = 0
        history = []
        while True:
            t0 = time.time()
            last_beat = time.time()
            proc = subprocess.Popen(
                self.cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env={**os.environ, **(self.env or {})})
            lines = []
            hung = False
            while True:
                line = proc.stdout.readline()
                if line:
                    last_beat = time.time()
                    lines.append(line.rstrip())
                elif proc.poll() is not None:
                    break
                if time.time() - last_beat > self.heartbeat_timeout_s:
                    hung = True
                    proc.kill()          # hung / straggling worker
                    break
            rc = proc.wait()
            proc.stdout.close()
            hangs += int(hung)
            attempt = {"rc": rc, "hung": hung,
                       "seconds": round(time.time() - t0, 1),
                       "lines": len(lines)}
            history.append(attempt)
            tr.event("ft.attempt", cat="ft", attempt=len(history),
                     **attempt)

            def result(ok: bool, reason: str) -> dict:
                rec = {"ok": ok, "reason": reason, "restarts": restarts,
                       "hangs": hangs, "final_rc": rc,
                       "history": history, "stdout": lines}
                tr.event("ft.result", cat="ft", ok=ok, reason=reason,
                         restarts=restarts, hangs=hangs, final_rc=rc,
                         attempts=len(history))
                return rec

            if rc == 0 and not hung:
                if hangs >= self.max_restarts:
                    return result(False, "hung_restart_budget")
                return result(True, "completed")
            restarts += 1
            if restarts > self.max_restarts:
                return result(False, "max_restarts")
            # relaunch: the trainer resumes from the latest atomic checkpoint
