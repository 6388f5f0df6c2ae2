"""The port's serving stack (`repro_torch.runtime`, `launch.serve`) against
the JAX reference's.

Tokens are compared exactly: on one home the port's `DecodeServer` and the
reference's decode the same greedy tokens from the same (converted)
parameters in both serving modes and under both policies, and the
scheduler's summaries are equal dict for dict.  The copied pure-Python
modules (`kvpool`, `scheduler`, `obs.tracelog`, `obs.metrics`) are held to
their originals statement for statement (their docstrings and the listed
edits aside), and by behaviour: the same streams give the same trace events and stats on the
flat 8-home and the (pod 2, data 2, model 2) locales, whose reference
locales are built in one subprocess (jax 0.9.0's default mesh axes are
Explicit, which the reference's constraints reject: the subprocess builds
Auto axes).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.model import LM as JLM
from repro.runtime import ft as jft
from repro.runtime import scheduler as jsched
from repro.runtime.server import DecodeServer as JServer
from repro.runtime.server import Request as JRequest

from repro_torch.configs import base
from repro_torch.convert import lm_params_from_reference, make_serve_stream
from repro_torch.core import HomeMesh, Locale
from repro_torch.obs import Tracer
from repro_torch.runtime import ft, scheduler
from repro_torch.runtime.server import DecodeServer, Request, schedule_replay
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


# ---------------------------------------------------------------------------
# the copies, statement for statement
# ---------------------------------------------------------------------------
#: the code edits a copy carries, as (port text, reference text); its
#: docstrings may differ
COPY_EDITS = {
    "runtime/scheduler.py": [
        ("import numpy as np\nimport torch\n", "import numpy as np\n"),
        ("itemsize = getattr(torch, cfg.dtype).itemsize",
         "itemsize = np.dtype(cfg.dtype).itemsize")],
    "runtime/kvpool.py": [], "obs/tracelog.py": [], "obs/metrics.py": []}


def code_of(source: str) -> str:
    """The module's syntax tree without its docstrings, as text."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("path", sorted(COPY_EDITS))
def test_copied_module_equals_its_original(path):
    port = (SRC / "repro_torch" / path).read_text()
    port = port.replace("repro_torch.", "repro.")
    for ours, theirs in COPY_EDITS[path]:
        assert ours in port, ours
        port = port.replace(ours, theirs)
    assert code_of(port) == code_of((SRC / "repro" / path).read_text())


@pytest.mark.parametrize("name", ["qwen3-0.6b", "glm4-9b", "jamba-1.5-large-398b",
                                  "mamba2-2.7b"])
def test_kv_bytes_per_token_equals_reference(name):
    for reduce in (False, True):
        cfg, jcfg = base.get_config(name), jbase.get_config(name)
        if reduce:
            cfg, jcfg = base.reduce_config(cfg), jbase.reduce_config(jcfg)
        assert scheduler.kv_bytes_per_token(cfg) == \
            jsched.kv_bytes_per_token(jcfg)
    assert scheduler.kv_bytes_per_token(base.get_config("qwen3-0.6b")) \
        == 28 * 2 * 8 * 128 * 2


# ---------------------------------------------------------------------------
# the server on one home: the reference's tokens
# ---------------------------------------------------------------------------
def served_tokens(srv, reqs):
    for r in reqs:
        srv.submit(r)
    return {r.rid: list(r.out) for r in srv.run()}


def stream(cls, cfg, n=12, seed=4):
    return [cls(**d) for d in make_serve_stream(
        n, cfg.vocab_size, (2, 14), sessions=3, new_tokens=(2, 5), slots=4,
        seed=seed, prefix=8)]


@pytest.fixture(scope="module")
def reduced():
    jcfg = jbase.reduce_config(jbase.get_config("qwen3-0.6b"), layers=2)
    cfg = base.reduce_config(base.get_config("qwen3-0.6b"), layers=2)
    jp = JLM(jcfg).init(jax.random.key(1))
    return jcfg, jp, cfg, lm_params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("policy", ["fifo", "homed"])
@pytest.mark.parametrize("pad", [None, 16], ids=["waves", "paged"])
def test_server_decodes_the_reference_tokens(reduced, pad, policy):
    jcfg, jp, cfg, p = reduced
    kw = dict(batch_slots=4, max_len=40, scheduler=policy, prompt_pad=pad,
              page_size=4 if pad else None)
    js, ts = JServer(jcfg, jp, **kw), DecodeServer(cfg, p, **kw)
    assert ts.paged == js.paged == (pad is not None)
    want = served_tokens(js, stream(JRequest, cfg))
    got = served_tokens(ts, stream(Request, cfg))
    assert got == want
    summary = ts.scheduler.emit_summary()
    assert summary == js.scheduler.emit_summary()
    if pad:
        assert summary["pages_attached"] > 0        # the attach path ran


@pytest.mark.parametrize("name,layers,pad", [
    ("deepseek-moe-16b", 2, None), ("deepseek-moe-16b", 2, 16),
    ("mixtral-8x7b", 2, 16), ("mamba2-2.7b", 2, 16),
    ("jamba-1.5-large-398b", 8, 16)],
    ids=["moe-waves", "moe-paged", "window", "ssm", "hybrid"])
def test_server_decodes_the_reference_tokens_for_every_member(name, layers,
                                                              pad):
    """MoE, sliding-window, Mamba2 and hybrid stacks: the port's server
    decodes the reference server's tokens from the same parameters, in
    the mode the reference picks (paged only for the MoE: the others'
    decode state is sequential or a ring), with equal summaries."""
    jcfg = jbase.reduce_config(jbase.get_config(name), layers=layers)
    cfg = base.reduce_config(base.get_config(name), layers=layers)
    jp = jax.jit(JLM(jcfg).init)(jax.random.key(2))
    p = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(batch_slots=4, max_len=40, scheduler="homed", prompt_pad=pad,
              page_size=4 if pad else None)
    js, ts = JServer(jcfg, jp, **kw), DecodeServer(cfg, p, **kw)
    assert ts.paged == js.paged == (pad is not None and name.startswith(
        "deepseek"))
    want = served_tokens(js, stream(JRequest, cfg))
    got = served_tokens(ts, stream(Request, cfg))
    assert got == want
    assert ts.scheduler.emit_summary() == js.scheduler.emit_summary()


def test_paged_tokens_are_bit_identical_across_policies(reduced):
    _, _, cfg, p = reduced
    out = {pol: served_tokens(DecodeServer(
        cfg, p, batch_slots=4, max_len=40, scheduler=pol, prompt_pad=16,
        page_size=4, locale=Locale(HomeMesh({"data": 2}, device="cpu"),
                                   "data")), stream(Request, cfg, n=16))
        for pol in ("fifo", "homed")}
    assert out["fifo"] == out["homed"]


def test_server_rejects_prompt_longer_than_pad(reduced):
    _, _, cfg, p = reduced
    srv = DecodeServer(cfg, p, batch_slots=2, max_len=32, prompt_pad=4)
    with pytest.raises(ValueError, match="exceeds prompt_pad"):
        srv.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32)))


@pytest.mark.parametrize("pad", [None, 16], ids=["waves", "paged"])
def test_server_schedule_equals_its_model_free_replay(reduced, pad):
    """Over 2 homes of a CPU `HomeMesh` (the caches relaid out by
    `pin_tree` every step), the real server's stats equal
    `schedule_replay`'s, trace event for trace event."""
    _, _, cfg, p = reduced
    loc = Locale(HomeMesh({"data": 2}, device="cpu"), "data")
    kw = dict(batch_slots=4, max_len=40, prompt_pad=pad,
              page_size=4 if pad else None)
    for pol in ("fifo", "homed"):
        tr = Tracer()
        srv = DecodeServer(cfg, p, scheduler=pol, locale=loc, tracer=tr, **kw)
        served_tokens(srv, stream(Request, cfg, n=14, seed=9))
        rtr = Tracer()
        rep = schedule_replay(cfg, stream(Request, cfg, n=14, seed=9),
                              locale=loc, scheduler=pol, tracer=rtr, **kw)
        assert rep.summary() == srv.scheduler.summary()
        assert sched_events(rtr) == sched_events(tr)


# ---------------------------------------------------------------------------
# the scheduler and page pool on 8 homes: events and stats
# ---------------------------------------------------------------------------
def sched_events(tracer):
    """The scheduler's and pool's trace records, without clocks."""
    return json.loads(json.dumps(
        [{k: v for k, v in r.items() if k not in ("ts", "dur", "tid")}
         for r in tracer.records() if r["cat"] in ("sched", "pool")]))


def drive(sch, reqs, pad):
    """The scheduling loop with the aligned-wave cost model, no model."""
    for r in reqs:
        sch.submit(r)
    now = 0.0
    while sch.has_work():
        now = sch.clock(now)
        wave = sch.form_wave(now)
        if not wave:
            continue
        cost = pad + max(r.max_new for _, r in wave)
        for _, r in wave:
            r.out, r.done = list(range(r.max_new)), True
        sch.complete(wave, now, cost)
        now += cost


#: (name, mesh shape, locale axis)
MESHES = [("flat", {"data": 8}, "data"),
          ("pods", {"pod": 2, "data": 2, "model": 2}, ("pod", "data"))]
CASES = [(m, pol, paged) for m, _, _ in MESHES for pol in ("fifo", "homed")
         for paged in (False, True)]
DRIVE = dict(n=40, prompt_len=(2, 16), sessions=6, new_tokens=(3, 12),
             slots=16, seed=2, prefix=8)

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from repro.configs import get_config, reduce_config
from repro.core.api import Locale
from repro.obs import Tracer
from repro.runtime.scheduler import make_scheduler
from repro.runtime.server import Request
from repro_torch.convert import make_serve_stream
from test_torch_serve import CASES, DRIVE, MESHES, drive, sched_events

cfg = reduce_config(get_config("qwen3-0.6b"))
out = {}
for name, shape, axis in MESHES:
    mesh = jax.make_mesh(tuple(shape.values()), tuple(shape),
                         axis_types=(AxisType.Auto,) * len(shape))
    for mname, pol, paged in CASES:
        if mname != name:
            continue
        tr = Tracer()
        sch = make_scheduler(pol, n_slots=16, locale=Locale(mesh, axis), cfg=cfg,
                             prompt_pad=16, page_size=4 if paged else 0,
                             page_capacity=24 if paged else 0, tracer=tr)
        drive(sch, [Request(**d) for d in make_serve_stream(
            vocab=cfg.vocab_size, **DRIVE)], 16)
        summary = sch.emit_summary()
        out[f"{name}-{pol}-{paged}"] = {"events": sched_events(tr),
                                         "summary": summary}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference_schedules(tmp_path_factory):
    dst = tmp_path_factory.mktemp("sched") / "reference.json"
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(dst)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(dst.read_text())


@pytest.mark.parametrize("mesh,policy,paged", CASES)
def test_scheduler_events_and_stats_equal_reference_on_8_homes(
        reference_schedules, mesh, policy, paged):
    shape, axis = {m: (s, a) for m, s, a in MESHES}[mesh]
    cfg = base.reduce_config(base.get_config("qwen3-0.6b"))
    tr = Tracer()
    sch = scheduler.make_scheduler(
        policy, n_slots=16, locale=Locale(HomeMesh(shape, device="cpu"), axis),
        cfg=cfg, prompt_pad=16, page_size=4 if paged else 0,
        page_capacity=24 if paged else 0, tracer=tr)
    drive(sch, [Request(**d) for d in make_serve_stream(
        vocab=cfg.vocab_size, **DRIVE)], 16)
    want = reference_schedules[f"{mesh}-{policy}-{paged}"]
    summary = json.loads(json.dumps(sch.emit_summary()))
    assert summary == want["summary"]
    assert sched_events(tr) == want["events"]
    assert summary["relayout_bytes"] > 0 or policy == "homed"
    if paged:
        assert summary["pool_pages"] > 0


def test_evacuate_home_equals_reference():
    """Drop one home's pooled pages mid-run: the same record and the same
    pool afterwards."""
    cfg = base.reduce_config(base.get_config("qwen3-0.6b"))
    jcfg = jbase.reduce_config(jbase.get_config("qwen3-0.6b"))
    kw = dict(n_slots=4, owners=(0, 0, 1, 1), policy="homed",
              prompt_pad=16, page_size=4, page_capacity=16)
    ours = scheduler.Scheduler(
        bytes_per_token=scheduler.kv_bytes_per_token(cfg), **kw)
    theirs = jsched.Scheduler(
        bytes_per_token=jsched.kv_bytes_per_token(jcfg), **kw)
    reqs = make_serve_stream(8, cfg.vocab_size, (6, 16), sessions=2,
                             new_tokens=(2, 4), slots=4, seed=3, prefix=8)
    drive(ours, [Request(**d) for d in reqs], 16)
    drive(theirs, [JRequest(**d) for d in reqs], 16)
    for home in (1, None):
        assert ft.evacuate_home(ours, home) == jft.evacuate_home(theirs, home)
        assert {h: ours.pool_keys(h) for h in ours.homes} == \
            {h: theirs.pool_keys(h) for h in theirs.homes}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def summary_lines(module: str) -> list:
    r = subprocess.run([sys.executable, "-m", module, "--smoke", "--json"]
                       + (["--device", "cpu"] if "torch" in module else []),
                       capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.returncode == 0, r.stdout + r.stderr
    return [ln for ln in r.stdout.splitlines() if not ln.startswith("req ")]


def test_serve_launcher_prints_the_reference_summary():
    got = summary_lines("repro_torch.launch.serve")
    assert got == summary_lines("repro.launch.serve")
    assert json.loads(got[-1])["served"] == 8


SERVE_ARCH = "qwen3-0.6b"
SERVE_ARGS = ["--arch", SERVE_ARCH, "--smoke", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two training steps of the reduced qwen3-0.6b (2 layers) through each
    package's `launch.train`, in subprocesses: {package: checkpoint dir}."""
    out = {}
    for pkg in ("repro_torch", "repro"):
        d = tmp_path_factory.mktemp(pkg) / "ckpt"
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.train", "--arch", SERVE_ARCH,
             "--steps", "2", "--global-batch", "2", "--seq-len", "16",
             "--ckpt", str(d)] + (["--device", "cpu"] if pkg == "repro_torch"
                                  else []),
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stdout + r.stderr
        out[pkg] = str(d)
    return out




@pytest.mark.parametrize("pkg", ["repro_torch", "repro"])
def test_serve_from_ckpt(trained, pkg, capsys):
    """``launch.serve --ckpt`` restores the latest step's parameters (of a
    checkpoint the port's `launch.train` wrote, or the reference's) at
    the depth they were trained at, and serves the tokens that serving
    those parameters directly gives; they are the trained parameters, not
    the seeded ones."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.launch import serve
    d = trained[pkg]
    assert latest_step(d) == 2
    serve.main(SERVE_ARGS + ["--ckpt", d])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("req ")]
    cfg = serve.served_config(SERVE_ARCH, d)
    assert cfg.num_layers == 2 and serve.served_config(
        SERVE_ARCH).num_layers == 4
    init = serve.load_params(cfg, "cpu")
    params = restore(d, 2, {"params": init})["params"]
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(init)))
    _, served = serve.serve(cfg, params, serve.parse_args(SERVE_ARGS), "cpu")
    want = [f"req {r.rid} (session {r.session}, home {r.home}, "
            f"wait {r.wait:.0f}): -> {r.out}" for r in served]
    assert len(got) == 8 and got == want


def test_serve_launcher_refuses_a_checkpoint(trained):
    """A checkpoint of another config (qwen3-0.6b's served as mamba2-2.7b)
    is refused, not half restored."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="does not fit mamba2-2.7b"):
        serve.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                    "--ckpt", trained["repro_torch"]])
