"""The port's four examples against the reference's, on the CPU.

`examples/torch_quickstart.py`, `torch_distributed_sort.py`,
`torch_serve_decode.py` and `torch_train_lm.py` are the port's entry
points, beside the reference's `examples/*.py`.  Here each runs with
``--device cpu`` (the plain versions), at its default size (train_lm for
2 steps), and its printed lines are held to the reference example's, run
in a one-device subprocess, timings excepted:

* quickstart and distributed_sort: every line equal but for `NAMED`,
  where the port prints what the reference's wording does not fit (its
  kernels are CUDA, not Pallas; the port's hierarchical engine runs on
  its 8 homes, where the reference's needs 2 devices or more; the
  quickstart also prints the homings `pin` and `localise` give);
* serve_decode: every line equal, the reference's parameters (drawn from
  ``jax.random.key(0)``) converted by `convert.lm_params_from_reference`;
* train_lm: the printed parameter count is the reference config's
  ``param_counts()["total"]``, the loss finite, the metrics file beside
  the checkpoint directory.

Without a card and without ``--device cpu`` every example raises.
"""
import contextlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
NAMES = ("quickstart", "distributed_sort", "serve_decode", "train_lm")

#: the reference's line -> the port's in its place (None: the port's only)
NAMED = {
    "distributed_sort": {
        "shard_map engine + fused pallas local phase: ok (interpret mode)":
            "shard_map engine + fused kernel local phase: ok "
            "(plain versions)",
        "pallas kernels (bitonic / fused local_sort / merge_split): ok":
            "kernels (bitonic / fused local_sort / merge_split): ok "
            "(plain versions)",
        # the reference prints it on 2 devices or more; the port's 8 homes
        # run it on one process
        None: "hierarchical engine on 2x4 emulated pods: ok"},
    "quickstart": {None: "pinned: homing=hash  localised: homing=local"},
}

SERVE_REFERENCE = """
import contextlib, io, os, runpy, sys
import numpy as np
import jax
from repro.configs import get_config, reduce_config
from repro.models.model import LM
out = sys.argv[1]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    runpy.run_path(os.path.join("examples", "serve_decode.py"),
                   run_name="__main__")
open(out + ".txt", "w").write(buf.getvalue())
cfg = reduce_config(get_config("granite-3-2b"), layers=4)
params = LM(cfg).init(jax.random.key(0))
flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(out + ".npz", **flat)
print("REFERENCE_OK")
"""


def example(name):
    """The port's example module `examples/torch_<name>.py`."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(EXAMPLES, f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(name, argv, **kw):
    """(printed lines, result) of the port's example `name`."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = example(name).main(argv, **kw)
    return buf.getvalue().splitlines(), res


def untimed(lines):
    return [re.sub(r" +\d+\.\d ms", " <ms>", ln) for ln in lines]


def unflatten(d):
    out = {}
    for path, v in d.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = np.array(v)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's examples, each in a one-device subprocess."""
    d = str(tmp_path_factory.mktemp("examples"))
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    cmds = {"quickstart": [os.path.join("examples", "quickstart.py")],
            "distributed_sort": [os.path.join("examples",
                                              "distributed_sort.py")],
            "serve_decode": ["-c", SERVE_REFERENCE,
                             os.path.join(d, "serve")]}
    procs = {k: subprocess.Popen([sys.executable, *c], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=600)
            assert p.returncode == 0, (k, o + e)
            out[k] = o.splitlines()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    assert out["serve_decode"] == ["REFERENCE_OK"]
    with open(os.path.join(d, "serve.txt")) as f:
        out["serve_decode"] = f.read().splitlines()
    out["serve_params"] = os.path.join(d, "serve.npz")
    return out


def held_to_reference(name, got, want):
    named = NAMED.get(name, {})
    extra = named.get(None)
    want = [named.get(ln, ln) for ln in want]
    got = [ln for ln in got if ln != extra]
    assert untimed(got) == untimed(want), (name, got, want)


@pytest.mark.parametrize("name", ("quickstart", "distributed_sort"))
def test_sort_examples_print_the_reference_s_lines(reference, name):
    got, _ = run(name, ["--device", "cpu"])
    extra = NAMED.get(name, {}).get(None)
    assert extra is None or extra in got
    held_to_reference(name, got, reference[name])


def test_serve_decode_prints_the_reference_s_lines(reference):
    from repro_torch.convert import lm_params_from_reference
    params = lm_params_from_reference(
        unflatten(dict(np.load(reference["serve_params"]))), device="cpu")
    got, outs = run("serve_decode", ["--device", "cpu"], params=params)
    assert any(ln.startswith("req ") for ln in got)
    assert got == reference["serve_decode"]
    assert outs["fifo"] == outs["homed"]


def test_train_lm_prints_the_reference_config_s_parameters(tmp_path):
    from repro.configs import get_config, reduce_config
    cfg = get_config("qwen3-0.6b")
    cfg = cfg.replace(num_layers=12, d_model=640, num_heads=10,
                      num_kv_heads=2, head_dim=64, d_ff=2560, vocab_size=2048,
                      dtype="float32", param_dtype="float32",
                      parallel=reduce_config(cfg).parallel)
    n = cfg.param_counts()["total"]
    assert example("train_lm").config("qwen3-0.6b").param_counts()[
        "total"] == n
    ckpt = str(tmp_path / "ckpt")
    got, res = run("train_lm", ["--device", "cpu", "--steps", "2",
                                "--ckpt", ckpt])
    assert got[0] == f"arch=qwen3-0.6b params={n/1e6:.1f}M"
    assert res["final_step"] == 2 and math.isfinite(res["final_loss"])
    assert got[-1] == f"done: step=2 loss={res['final_loss']:.4f}"
    with open(ckpt + "_metrics.json") as f:
        assert json.load(f)[-1]["step"] == 2


@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_a_card(name, monkeypatch):
    """No fallback: asked for the card (the default) where there is none,
    an example raises before it runs anything (on a host with a card, its
    absence is feigned)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(name, [])
