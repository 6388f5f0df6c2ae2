"""The port's training path (`repro_torch.models.steps`,
`runtime.trainer`, `runtime.ft.Supervisor`) against the JAX reference's.

The train step runs on `reduce_config(qwen3-0.6b)` in float32 from the
reference `LM.init`'s parameters (converted), on the reference
pipeline's batches.  Tolerances: the loss within rtol 1e-5, the gradient
norm within rtol 1e-4, every gradient leaf within rtol 1e-4 and atol
1e-6 x the leaf's largest |value|, a 5-step loss trajectory within rtol
1e-4.  The two frameworks sum in other orders, nothing more.

The trainer and the supervisor run in subprocesses, as the reference's
tests run theirs (`tests/test_runtime.py`), on the CPU at a tiny size:
resume is bit for bit there, and the loss-spike guard skips the steps the
reference's skips.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import steps as jsteps
from repro.models.model import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro.sharding.partition import NULL_PLAN as JNULL_PLAN

from repro_torch.checkpoint import ckpt
from repro_torch.configs import base
from repro_torch.convert import lm_params_from_reference, opt_state_from_reference
from repro_torch.models import LM
from repro_torch.models import steps
from repro_torch.obs import Tracer
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.ft import Supervisor
from repro_torch.sharding.partition import NULL_PLAN
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
ARCH = "qwen3-0.6b"
B, S = 4, 32


def configs(**parallel):
    """The reduced config of both packages, with `parallel` fields set."""
    jcfg = jbase.reduce_config(jbase.get_config(ARCH))
    cfg = base.reduce_config(base.get_config(ARCH))
    return (jcfg.replace(parallel=jcfg.parallel.__class__(
                **{**jcfg.parallel.__dict__, **parallel})),
            cfg.replace(parallel=cfg.parallel.__class__(
                **{**cfg.parallel.__dict__, **parallel})))


def setup(jcfg, cfg, seed: int = 0):
    """Both steps, the reference's jitted, on the same parameters and
    state.  The reference's `dequantize` takes ``int()`` of a shape's
    product, which tracing refuses: under `jax.ensure_compile_time_eval`
    that product of constants is computed while tracing, as it is when
    the step runs eagerly."""
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(seed))
    jopt = JAdamW(lr=jcosine(3e-4, 2, 10))
    js = jsteps.init_opt_state(jcfg, jopt, jp)
    jitted = jax.jit(jsteps.make_train_step(jm, jcfg, JNULL_PLAN, jopt))

    def jstep(*args):
        with jax.ensure_compile_time_eval():
            return jitted(*args)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    state = opt_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    step = steps.make_train_step(LM(cfg, flash=False), cfg, NULL_PLAN,
                                 AdamW(lr=cosine_schedule(3e-4, 2, 10)))
    return (jm, jp, js, jstep), (params, state, step)


def batches(jcfg, n: int):
    data = JSyntheticLM(jcfg, B, S, seed=0)
    for i in range(n):
        b = data.batch(i)
        yield b, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def leaf_close(got: torch.Tensor, want, what: str, rtol=1e-4, atol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


def metrics_close(got: dict, want: dict):
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-4)
    assert float(got["step"]) == float(want["step"])


# ---------------------------------------------------------------------------
# the loss and the train step
# ---------------------------------------------------------------------------
def test_loss_and_gradients_match_reference():
    """The loss and every gradient leaf of `make_loss_fn` against the
    reference's ``jax.value_and_grad``."""
    jcfg, cfg = configs()
    (jm, jp, _, _), (params, _, _) = setup(jcfg, cfg)
    jb, b = next(batches(jcfg, 1))
    (jloss, jnll), jg = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jm, jcfg, JNULL_PLAN), has_aux=True))(jp, jb)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, nll = steps.make_loss_fn(LM(cfg, flash=False), cfg)(params, b)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(nll.detach()), float(jnll), rtol=1e-5)
    assert len(grads) == len(jax.tree.leaves(jg))
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 grads):
        leaf_close(got, want, jax.tree_util.keystr(path))


@pytest.mark.parametrize("parallel", [
    {}, {"microbatches": 2},
    {"microbatches": 2, "accum_via_scan_grad": True}],
    ids=["M1", "M2-accumulate", "M2-scan-grad"])
def test_train_step_matches_reference(parallel):
    """One step from the reference's state: its metrics, and AdamW's first
    moment, which after one step from zero is 0.1 x the clipped gradient
    (so every gradient leaf is held to the reference's, whichever way the
    microbatches accumulated it), and the step count."""
    jcfg, cfg = configs(**parallel)
    (_, jp, js, jstep), (params, state, step) = setup(jcfg, cfg)
    jb, b = next(batches(jcfg, 1))
    _, js, jmet = jstep(jp, js, jb)
    out_p, out_s, met = step(params, state, b)
    assert out_p is params and out_s is state            # in place
    metrics_close(met, jmet)
    assert int(state["adam"]["step"]) == int(js["adam"]["step"]) == 1
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(js["adam"]["m"])[0],
            tree_leaves(state["adam"]["m"])):
        leaf_close(got, want, "m" + jax.tree_util.keystr(path))


def test_train_step_with_error_feedback_matches_reference():
    """``grad_compression``: the step quantises (gradient + residual) to
    int8 blocks.  Held as above, with the first moment (the dequantised
    gradient) and the new residual; where the two frameworks' gradients
    straddle a rounding boundary of the int8 grid, an element may land
    one quantum (its block's scale) apart, which moves the residual by
    the same amount the other way: so the dequantised gradient plus the
    residual, which is the gradient itself, is held to the tolerance
    above, and the dequantised gradient alone on all but 0.1 % of the
    elements, those within one quantum (at most the leaf's largest
    |gradient| / 127)."""
    jcfg, cfg = configs(grad_compression=True)
    (_, jp, js, jstep), (params, state, step) = setup(jcfg, cfg)
    jb, b = next(batches(jcfg, 1))
    _, js, jmet = jstep(jp, js, jb)
    _, _, met = step(params, state, b)
    metrics_close(met, jmet)
    clip = min(1.0, 1.0 / (float(jmet["grad_norm"]) + 1e-9))
    for (path, m_want), e_want, m_got, e_got in zip(
            jax.tree_util.tree_flatten_with_path(js["adam"]["m"])[0],
            jax.tree.leaves(js["ef"]), tree_leaves(state["adam"]["m"]),
            tree_leaves(state["ef"])):
        what = jax.tree_util.keystr(path)
        deq_want = np.asarray(m_want) / (0.1 * clip)
        deq_got = m_got.numpy() / (0.1 * clip)
        grad_want = deq_want + np.asarray(e_want)
        leaf_close(torch.from_numpy(deq_got + e_got.numpy()), grad_want,
                   "grad" + what)
        quantum = np.abs(grad_want).max() / 127.0
        off = np.abs(deq_got - deq_want) > (
            1e-4 * np.abs(deq_want) + 1e-6 * np.abs(deq_want).max())
        assert off.mean() <= 1e-3, (what, off.mean())
        assert (np.abs(deq_got - deq_want)[off] <= quantum * 1.001).all(), what


def test_five_step_loss_trajectory_matches_reference():
    """Five steps on the pipeline's batches 0-4: every step's loss within
    rtol 1e-4 of the reference's."""
    jcfg, cfg = configs()
    (_, jp, js, jstep), (params, state, step) = setup(jcfg, cfg)
    want, got = [], []
    for jb, b in batches(jcfg, 5):
        jp, js, jmet = jstep(jp, js, jb)
        _, _, met = step(params, state, b)
        want.append(float(jmet["loss"]))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(state["adam"]["step"]) == 5


def test_optimizer_state_converts_from_reference():
    """`opt_state_from_reference`: AdamW's m, v (float32), the int32 step
    and the error-feedback residual, with the reference's nesting."""
    jcfg, cfg = configs(grad_compression=True)
    jp = JLM(jcfg).init(jax.random.key(1))
    js = jsteps.init_opt_state(jcfg, JAdamW(), jp)
    got = opt_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    assert sorted(got) == ["adam", "ef"] and sorted(got["adam"]) == [
        "m", "step", "v"]
    assert got["adam"]["step"].dtype == torch.int32
    assert got["adam"]["step"].shape == ()
    want = steps.init_opt_state(cfg, AdamW(), lm_params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu"))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the trainer, in subprocesses
# ---------------------------------------------------------------------------
#: a trainer run: argv[1] is a JSON of TrainerConfig fields (``trainer``:
#: "port" or "reference"; ``kill_after``: SIGKILL the process once the
#: checkpoint of that step is written, on its first run only)
TRAIN_SCRIPT = """
import json, os, signal, sys
sys.path.insert(0, "src")
kw = json.loads(sys.argv[1])
which, kill_after = kw.pop("trainer"), kw.pop("kill_after", None)
if which == "port":
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.checkpoint import latest_step
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    kw["device"] = "cpu"
else:
    from repro.configs import get_config, reduce_config
    from repro.checkpoint import latest_step
    from repro.runtime.trainer import Trainer, TrainerConfig
trainer = Trainer(reduce_config(get_config("qwen3-0.6b")),
                  TrainerConfig(global_batch=4, seq_len=32, log_every=1, **kw))
marker = kw["ckpt_dir"] + ".killed"
if kill_after is not None and not os.path.exists(marker):
    save = trainer.ckpt.maybe_save
    def maybe_save(step, tree, force=False):
        saved = save(step, tree, force)
        if step == kill_after:
            trainer.ckpt.wait()
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return saved
    trainer.ckpt.maybe_save = maybe_save
print("START", latest_step(kw["ckpt_dir"]), flush=True)
res = trainer.run()
print("FINAL", json.dumps({"step": res["final_step"],
                           "loss": res["final_loss"]}), flush=True)
"""


def train_cmd(**kw):
    kw.setdefault("trainer", "port")
    return [sys.executable, "-c", TRAIN_SCRIPT, json.dumps(kw)]


def run_train(**kw) -> list:
    """Run a trainer to its end; its metrics log."""
    kw = dict(kw, metrics_path=kw["ckpt_dir"] + ".metrics.json")
    r = subprocess.run(train_cmd(**kw), capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0 and "FINAL" in r.stdout, r.stdout + r.stderr
    return json.load(open(kw["metrics_path"]))


def test_trainer_loss_decreases(tmp_path):
    log = run_train(ckpt_dir=str(tmp_path / "ck"), steps=30, ckpt_every=10)
    assert [r["step"] for r in log] == list(range(1, 31))
    assert log[-1]["loss"] < log[0]["loss"], log
    assert ckpt.latest_step(str(tmp_path / "ck")) == 30


def test_resume_is_bit_identical_on_the_cpu(tmp_path):
    """12 straight steps == 6 steps + restart + 6 more: the same loss and
    gradient norm at every step, and the same final checkpoint, file for
    file and byte for byte."""
    common = dict(steps=12, ckpt_every=6, schedule_total=12)
    straight = run_train(ckpt_dir=str(tmp_path / "a"), **common)
    run_train(ckpt_dir=str(tmp_path / "b"), **{**common, "steps": 6})
    resumed = run_train(ckpt_dir=str(tmp_path / "b"), **common)
    assert [r["step"] for r in resumed] == list(range(7, 13))
    strip = lambda log: [(r["step"], r["loss"], r["grad_norm"])  # noqa: E731
                         for r in log]
    assert strip(resumed) == strip(straight)[6:]
    a, b = (tmp_path / d / "step_00000012" for d in "ab")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


#: the guard's threshold: between the gradient norms of the steps it lets
#: through (at most 1.84 on this run) and those it stops (at least 1.95),
#: more than 2 % from each; the two trainers' norms agree within 1e-6
GRAD_SPIKE = 1.9


def test_loss_spike_guard_matches_reference(tmp_path):
    """With `grad_spike` low enough that steps spike, the port's trainer
    skips the steps the reference's skips (restoring the last checkpoint
    each time) and ends in the same state: the step count exactly, the
    losses of the steps taken within rtol 1e-4, the parameters within rtol
    1e-4, atol 1e-6 x each leaf's largest value -- but for the few
    elements whose gradient is at rounding level, where AdamW's
    normalised step m / sqrt(v) follows the two frameworks' rounding
    noise: at most 0.1 % of a leaf, each within twice the sum of the run's
    learning rates.  Both start from the reference's initial state,
    written as a step-0 checkpoint by the reference and restored by each
    trainer."""
    jcfg, _ = configs()
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(0))
    total = 10
    jopt = JAdamW(lr=jcosine(3e-4, 10, total))
    init = {"params": jp, "opt": jsteps.init_opt_state(jcfg, jopt, jp)}
    kw = dict(steps=total, ckpt_every=3, grad_spike=GRAD_SPIKE)
    logs = {}
    for which in ("reference", "port"):
        d = str(tmp_path / which)
        jckpt.save(d, 0, init)
        logs[which] = run_train(trainer=which, ckpt_dir=d, **kw)
    taken = {w: [r["step"] for r in log] for w, log in logs.items()}
    assert taken["port"] == taken["reference"]
    assert 0 < len(taken["port"]) < total, taken       # some steps spiked
    np.testing.assert_allclose([r["loss"] for r in logs["port"]],
                               [r["loss"] for r in logs["reference"]],
                               rtol=1e-4)
    ref = jckpt.restore(str(tmp_path / "reference"), total, init)
    ours = ckpt.restore(str(tmp_path / "port"), total, init)
    assert int(ours["opt"]["adam"]["step"]) == int(ref["opt"]["adam"]["step"])
    lr = jcosine(3e-4, 10, total)
    moved = 2 * sum(float(lr(jnp.int32(s))) for s in range(1, total + 1))
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(ref["params"])[0],
            tree_leaves(ours["params"])):
        want, got = np.asarray(want), got.numpy()
        diff = np.abs(got - want)
        off = diff > 1e-4 * np.abs(want) + 1e-6 * np.abs(want).max()
        what = jax.tree_util.keystr(path)
        assert off.mean() <= 1e-3 and (diff[off] <= moved).all(), (
            what, off.sum(), diff.max())


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------
def test_supervisor_relaunches_after_sigkill_and_resumes(tmp_path):
    """The first attempt is killed (SIGKILL) once its step-5 checkpoint is
    written; the supervisor relaunches it, the trainer resumes from step 5
    and completes; the attempts are `ft.attempt` events."""
    tracer = Tracer()
    out = Supervisor(cmd=train_cmd(ckpt_dir=str(tmp_path / "ck"), steps=10,
                                   ckpt_every=5, kill_after=5),
                     max_restarts=2, heartbeat_timeout_s=120,
                     env={"PYTHONPATH": str(SRC)}, tracer=tracer).run()
    assert out["ok"] and out["reason"] == "completed", out
    assert out["restarts"] == 1 and out["hangs"] == 0
    assert [h["rc"] for h in out["history"]] == [-9, 0]
    assert "START 5" in out["stdout"]
    final = [ln for ln in out["stdout"] if ln.startswith("FINAL")]
    assert json.loads(final[0][len("FINAL "):])["step"] == 10
    steps_run = [json.loads(ln)["step"] for ln in out["stdout"]
                 if ln.startswith("{")]
    assert steps_run == list(range(6, 11))
    events = [r for r in tracer.records() if r["cat"] == "ft"]
    assert [e["name"] for e in events] == ["ft.attempt", "ft.attempt",
                                           "ft.result"]


def test_supervisor_structured_record_and_hung_restart_budget(tmp_path):
    """`Supervisor.run` always returns a structured record; a worker that
    exits 0 only after exhausting `max_restarts` on heartbeat kills is a
    failure (the reference's test, on the port's supervisor)."""
    out = Supervisor(cmd=[sys.executable, "-c", "print('ok')"]).run()
    assert out["ok"] and out["reason"] == "completed"
    assert out["restarts"] == 0 and out["hangs"] == 0
    assert out["final_rc"] == 0 and len(out["history"]) == 1
    assert out["history"][0] == {"rc": 0, "hung": False,
                                 "seconds": out["history"][0]["seconds"],
                                 "lines": 1}

    out = Supervisor(cmd=[sys.executable, "-c", "import sys; sys.exit(3)"],
                     max_restarts=2).run()
    assert not out["ok"] and out["reason"] == "max_restarts"
    assert out["final_rc"] == 3 and out["restarts"] == 3
    assert [h["rc"] for h in out["history"]] == [3, 3, 3]

    flaky = ("import os, sys\n"
             "marker = sys.argv[1]\n"
             "if not os.path.exists(marker):\n"
             "    open(marker, 'w').write('x'); sys.exit(9)\n"
             "print('recovered')\n")
    out = Supervisor(cmd=[sys.executable, "-c", flaky,
                          str(tmp_path / "crashed")], max_restarts=2).run()
    assert out["ok"] and out["reason"] == "completed"
    assert out["restarts"] == 1 and out["hangs"] == 0

    hangy = ("import os, sys, time\n"
             "d = sys.argv[1]\n"
             "n = len(os.listdir(d))\n"
             "open(os.path.join(d, str(n)), 'w').write('x')\n"
             "print('beat', flush=True)\n"
             "if n < 2:\n"
             "    os.close(1); os.close(2)\n"   # silent from here on: hung
             "    time.sleep(30)\n"
             "print('DONE')\n")
    d = tmp_path / "attempts"
    d.mkdir()
    tracer = Tracer()
    out = Supervisor(cmd=[sys.executable, "-c", hangy, str(d)],
                     max_restarts=2, heartbeat_timeout_s=1.0,
                     tracer=tracer).run()
    assert not out["ok"] and out["reason"] == "hung_restart_budget"
    assert out["hangs"] == 2 and out["final_rc"] == 0
    assert [h["hung"] for h in out["history"]] == [True, True, False]
    assert any("DONE" in ln for ln in out["stdout"])
    result = [r for r in tracer.records() if r["name"] == "ft.result"]
    assert result[0]["args"]["reason"] == "hung_restart_budget"
