"""The port's training substrate against the JAX reference's: the LR
schedule, AdamW, gradient compression, the data pipeline and checkpoints;
and two guards of the port as a whole (it imports neither JAX nor the
reference; `flash_attention` refuses autograd).

Inputs are made with numpy from seeds.  Tolerances, each stated where it
is used: schedule rtol 1e-6; AdamW float32 rtol 1e-6, atol 1e-7, bfloat16
params within one bfloat16 ulp, the step exactly, the norm rtol 1e-6;
`quantize`'s int8 payload bit for bit, its scales rtol 1e-7; the
error-feedback update rtol 1e-6.  Pipeline batches and checkpoints are
bit for bit.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jschedule

from repro_torch.checkpoint import ckpt
from repro_torch.configs import base
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import HomeMesh
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.optim import adamw, compression, schedule
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def to_np(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as numpy, bfloat16 as ml_dtypes' bfloat16 (its
    bits)."""
    t = t.detach().cpu().clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return to_np(tree) if isinstance(tree, torch.Tensor) else np.asarray(tree)


def ref_tree(tree):
    """A numpy tree as the reference's jnp arrays."""
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the port as a whole
# ---------------------------------------------------------------------------
def test_the_port_imports_neither_jax_nor_the_reference():
    """Every module of `repro_torch`, imported in a fresh interpreter,
    brings in neither `jax` nor anything of `repro`."""
    code = (
        "import pkgutil, importlib, sys, json\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], out["bad"]
    for name in ("repro_torch.optim.adamw", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.ckpt", "repro_torch.models.steps",
                 "repro_torch.runtime.trainer", "repro_torch.launch.train"):
        assert name in out["modules"]


def test_flash_attention_refuses_autograd_on_the_cpu():
    """The kernel has no backward pass: its wrapper raises when grad mode
    is on and q, k or v requires grad, on the CPU as on the card, and the
    model's attention with ``flash=True`` raises under autograd too.
    Without grad (serving) both run, and ``LM(cfg, flash=False)`` trains."""
    from repro_torch.models import LM
    from repro_torch.models.steps import make_loss_fn
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 16), np.float32))
            for _ in range(2))
    for which in range(3):
        args = [q.clone(), k.clone(), v.clone()]
        args[which].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward pass"):
            ops.flash_attention(*args, causal=True)
        with torch.no_grad():
            ops.flash_attention(*args, causal=True)

    cfg = base.reduce_config(base.get_config("qwen3-0.6b"))
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    assert not any(t.requires_grad for t in tree_leaves(params))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    logits, _ = LM(cfg).prefill(params, batch)      # serving: no grad needed
    assert torch.isfinite(logits).all()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        make_loss_fn(LM(cfg), cfg)(params, batch)
    loss, _ = make_loss_fn(LM(cfg, flash=False), cfg)(params, batch)
    loss.backward()
    wq = params["stack"]["m0"]["attn"]["wq"].grad
    assert wq is not None and float(wq.abs().max()) > 0


# ---------------------------------------------------------------------------
# the LR schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("peak, warmup, total, floor",
                         [(3e-4, 10, 100, 0.1), (1e-3, 0, 7, 0.0),
                          (5e-4, 4, 4, 0.2)])
def test_cosine_schedule_matches_reference(peak, warmup, total, floor):
    """Steps 0 to total + 5, as the int32 step comes in; rtol 1e-6."""
    ref = jschedule.cosine_schedule(peak, warmup, total, floor)
    ours = schedule.cosine_schedule(peak, warmup, total, floor)
    for step in range(total + 6):
        want = np.asarray(ref(jnp.int32(step)))
        got = ours(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adam_case(dtype: str, seed: int):
    """Params, grads and a mid-run state (step 3) as numpy trees."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (7, 33), "b": (33,)}, "z": (5, 2, 3)}

    def tree(scale, dt):
        def leaf(shape):
            x = (scale * rng.standard_normal(shape)).astype(np.float32)
            return x.astype(ml_dtypes.bfloat16) if dt == "bfloat16" else x
        return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))

    params, grads = tree(1.0, dtype), tree(0.3, dtype)
    state = {"m": tree(0.01, "float32"),
             "v": jax.tree.map(np.abs, tree(1e-3, "float32")),
             "step": np.int32(3)}
    return params, grads, state


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
@pytest.mark.parametrize("lr", ["schedule", 1e-2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, lr, clip):
    """One update from the same params, grads and state: float32 leaves
    within rtol 1e-6, atol 1e-7; bfloat16 params within one bfloat16 ulp
    of the reference's; the step exactly; the norm within rtol 1e-6."""
    params, grads, state = adam_case(dtype, seed=len(dtype) + int(clip))
    kw = dict(clip_norm=clip)
    ref = jadamw.AdamW(lr=jschedule.cosine_schedule(3e-2, 2, 10)
                       if lr == "schedule" else lr, **kw)
    ours = adamw.AdamW(lr=schedule.cosine_schedule(3e-2, 2, 10)
                       if lr == "schedule" else lr, **kw)
    jp, js, jn = ref.update(ref_tree(grads), ref_tree(state), ref_tree(params))
    tp = lm_params_from_reference(params, "cpu")
    ts = lm_params_from_reference(state, "cpu")
    out_p, out_s, gn = ours.update(lm_params_from_reference(grads, "cpu"), ts,
                                   tp)
    assert out_p is tp and out_s is ts                 # in place
    assert int(ts["step"]) == int(js["step"]) == 4
    assert ts["step"].dtype == torch.int32
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    for key in ("m", "v"):
        for got, want in zip(jax.tree.leaves(tree_np(ts[key])),
                             jax.tree.leaves(js[key])):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-7)
    for got, want in zip(jax.tree.leaves(tree_np(tp)), jax.tree.leaves(jp)):
        want = np.asarray(want)
        assert got.dtype == want.dtype
        if dtype == "bfloat16":
            gb = got.view(np.int16).astype(np.int32)
            wb = want.view(np.int16).astype(np.int32)
            assert np.abs(gb - wb).max() <= 1          # one ulp (same signs)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adamw_init_matches_reference():
    params, _, _ = adam_case("bfloat16", seed=0)
    want = jadamw.AdamW().init(ref_tree(params))
    got = adamw.AdamW().init(lm_params_from_reference(params, "cpu"))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    for g, w in zip(jax.tree.leaves(tree_np(got["m"])),
                    jax.tree.leaves(want["m"])):
        assert g.dtype == np.float32 and g.shape == w.shape and not g.any()


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n, block", [(1000, 256), (256, 256), (77, 32),
                                      (4096, 128)])
def test_quantize_matches_reference_bit_for_bit(n, block):
    """int8 payload bit for bit (ties to even, as ``jnp.round``), scales
    within rtol 1e-7; dequantised values and the tree helpers likewise."""
    rng = np.random.default_rng(n + block)
    x = rng.standard_normal(n).astype(np.float32) * 3
    x[::17] = 0.0
    x[5] = 127.5 / 127.0 * np.abs(x).max()        # a tie after scaling
    shape = (n // 7, 7) if n % 7 == 0 else (n,)
    x = x.reshape(shape)
    jq, js = jcomp.quantize(jnp.asarray(x), block)
    q, s = compression.quantize(torch.from_numpy(x), block)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(
        compression.dequantize(q, s, shape).numpy(),
        np.asarray(jcomp.dequantize(jq, js, shape)), rtol=1e-7)
    tree = {"a": x, "b": {"c": x[..., :1] * 2}}
    jc = jcomp.compress_tree(ref_tree(tree), block)
    c = compression.compress_tree(lm_params_from_reference(tree, "cpu"), block)
    np.testing.assert_array_equal(c["b"]["c"][0].numpy(),
                                  np.asarray(jc["b"]["c"][0]))
    back = compression.decompress_tree(c, lm_params_from_reference(tree, "cpu"))
    jback = jcomp.decompress_tree(jc, ref_tree(tree))
    for k in ("a",):
        np.testing.assert_allclose(back[k].numpy(), np.asarray(jback[k]),
                                   rtol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_error_feedback_update_matches_reference(dtype):
    """(dequantised grad, new residual) within rtol 1e-6 (bfloat16 grads:
    the same bits)."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((40, 13)).astype(np.float32)
    ef = (0.01 * rng.standard_normal((40, 13))).astype(np.float32)
    gj = g.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else g
    jd, je = jcomp.error_feedback_update(jnp.asarray(gj), jnp.asarray(ef))
    d, e = compression.error_feedback_update(
        lm_params_from_reference(gj, "cpu"), torch.from_numpy(ef))
    assert d.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(to_np(d).view(np.int16),
                                      np.asarray(jd).view(np.int16))
    else:
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
def function_code(module_path: Path, name: str) -> str:
    tree = ast.parse(module_path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    fn.body = [s for s in fn.body if not (isinstance(s, ast.Expr) and
                                          isinstance(s.value, ast.Constant))]
    return ast.dump(fn)


@pytest.mark.parametrize("name", ["_row_tokens", "_embed_rows",
                                  "_row_image_embeds"])
def test_row_content_functions_are_the_references(name):
    """The per-row content functions are copies, statement for statement
    (their docstrings aside)."""
    assert (function_code(SRC / "repro_torch/data/pipeline.py", name)
            == function_code(SRC / "repro/data/pipeline.py", name))


PIPE_ARCHS = {"qwen3-0.6b": "tokens", "musicgen-medium": "embeds",
              "llama-3.2-vision-90b": "image_embeds"}


@pytest.mark.parametrize("arch", sorted(PIPE_ARCHS))
def test_pipeline_batches_equal_reference_bit_for_bit(arch):
    """`SyntheticLM.batch(step)` for steps 0-3, striped over
    ``HomeMesh({"data": 2})`` and without a mesh, and the host-built
    oracle, each bit for bit the reference's; `make_batch_iterator` after
    a `start_step` likewise."""
    jcfg = jbase.reduce_config(jbase.get_config(arch))
    cfg = base.reduce_config(base.get_config(arch))
    B, S, seed = 4, 24, 5
    ref = jpipe.SyntheticLM(jcfg, B, S, seed)
    mesh = HomeMesh({"data": 2}, device="cpu")
    ours = [pipeline.SyntheticLM(cfg, B, S, seed, mesh=mesh),
            pipeline.SyntheticLM(cfg, B, S, seed, device="cpu"),
            pipeline.SyntheticLM(cfg, B, S, seed, mesh=mesh, striped=False),
            pipeline.SyntheticLM(cfg, B, S, seed, device="cpu",
                                 striped=False)]

    def same(got, want):
        assert sorted(got) == sorted(want) and PIPE_ARCHS[arch] in got
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=k)

    for step in range(4):
        want = ref.batch(step)
        for ds in ours:
            same(ds.batch(step), want)
    it = pipeline.make_batch_iterator(cfg, B, S, seed, mesh=mesh,
                                      start_step=6)
    for step in (6, 7):
        same(next(it), ref.batch(step))


def test_pipeline_lands_on_the_card_by_default():
    """Without a mesh or a device the batch goes to the card: here, with
    none, that raises instead of falling back to the CPU."""
    cfg = base.reduce_config(base.get_config("qwen3-0.6b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py covers it")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        pipeline.SyntheticLM(cfg, 2, 8).batch(0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def ckpt_tree(seed: int = 0):
    """A trainer-shaped numpy tree: bfloat16 and float32 params, float32
    moments, an int32 step."""
    rng = np.random.default_rng(seed)
    p = {"stack": {"m0": {"w": rng.standard_normal((2, 3, 4)).astype(
        ml_dtypes.bfloat16), "ln": np.ones(4, np.float32)}},
         "head": {"head_w": rng.standard_normal((4, 9)).astype(
             ml_dtypes.bfloat16)}}
    zeros = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3
                                    ).astype(np.float32), p)
    return {"params": p, "opt": {"adam": {"m": zeros, "v": zeros,
                                          "step": np.int32(7)}}}


def assert_bits_equal(got, want):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_checkpoint_round_trip_gc_and_bf16(tmp_path):
    """Save, restore (bfloat16 leaves bit for bit), keep the last
    `keep_last` steps, `latest_step` the newest."""
    tree = lm_params_from_reference(ckpt_tree(), "cpu")
    for step in (2, 4, 6, 8):
        ckpt.save(str(tmp_path), step, tree, keep_last=3)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000006",
                                            "step_00000008"]
    assert ckpt.latest_step(str(tmp_path)) == 8
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    back = ckpt.restore(str(tmp_path), 8, tree)
    assert back["params"]["stack"]["m0"]["w"].dtype == torch.bfloat16
    assert_bits_equal(tree_np(back), tree_np(tree))


def test_checkpoint_is_atomic(tmp_path):
    """A save cut before its rename leaves ``tmp.<step>``, which is never a
    step; the next save of that step replaces it; the manager snapshots
    the tree before returning, so an in-place update right after does not
    reach the checkpoint."""
    tree = lm_params_from_reference(ckpt_tree(), "cpu")
    ckpt.save(str(tmp_path), 3, tree)
    half = tmp_path / "tmp.9"
    half.mkdir()
    (half / "params__head__head_w.npy").write_bytes(b"partial")
    assert ckpt.latest_step(str(tmp_path)) == 3
    ckpt.restore(str(tmp_path), 3, tree)
    ckpt.save(str(tmp_path), 9, tree)
    assert not half.exists() and ckpt.latest_step(str(tmp_path)) == 9

    before = tree_np(tree)
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), every=2)
    assert not mgr.maybe_save(1, tree)
    assert mgr.maybe_save(2, tree)
    with torch.no_grad():
        tree["params"]["head"]["head_w"].add_(1.0)      # the next step
        tree["opt"]["adam"]["step"].add_(1)
    mgr.wait()
    assert_bits_equal(tree_np(ckpt.restore(str(tmp_path / "m"), 2, tree)),
                      before)
    assert [d for d in os.listdir(tmp_path / "m")] == ["step_00000002"]


def test_checkpoints_cross_restore_with_the_reference(tmp_path):
    """A checkpoint the reference writes restores in the port, and one the
    port writes restores in the reference, bit for bit; the two packages
    write the same files byte for byte."""
    tree = ckpt_tree(seed=1)
    jckpt.save(str(tmp_path / "ref"), 5, ref_tree(tree))
    ours = lm_params_from_reference(tree, "cpu")
    ckpt.save(str(tmp_path / "port"), 5, ours)
    ref_dir, port_dir = (tmp_path / d / "step_00000005" for d in ("ref",
                                                                  "port"))
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    for name in os.listdir(ref_dir):
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), \
            name

    got = ckpt.restore(str(tmp_path / "ref"), 5, ours)
    assert got["params"]["head"]["head_w"].dtype == torch.bfloat16
    assert got["opt"]["adam"]["step"].dtype == torch.int32
    assert_bits_equal(tree_np(got), tree)
    back = jckpt.restore(str(tmp_path / "port"), 5, ref_tree(tree))
    assert_bits_equal(jax.tree.map(np.asarray, back), tree)
