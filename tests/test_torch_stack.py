"""The rest of the port's model stack against the JAX reference: sliding
windows, mixture-of-experts, Mamba2 SSD and cross attention.

Each of the five configs that use them (mixtral-8x7b, deepseek-moe-16b,
mamba2-2.7b, jamba-1.5-large-398b, llama-3.2-vision-90b) runs at
`reduce_config` in float32 on parameters converted from the reference's
(`convert.lm_params_from_reference`), on inputs made with numpy from a
seed.  Tolerances: logits, caches and the MoE aux loss within rtol 1e-4,
atol 1e-5 of the reference's (the two frameworks sum in other orders),
positions exact; decode after prefill against the port's own forward
within the reference test's bounds (`tests/test_models.py`: 2e-4 for the
prefill's last logits, 2e-3 for each decode step); three train steps'
losses within rtol 1e-5 and gradient norms within rtol 1e-4, the bounds
of `tests/test_torch_train.py`.  The ring layout the reference builds
for a windowed prefill is reproduced, its fault included.  The member
functions are held to the reference's in
`tests/test_torch_stack_members.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import steps as jsteps
from repro.models.model import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.sharding.partition import NULL_PLAN as JNULL_PLAN

from repro_torch.configs import base
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import LM, steps
from repro_torch.optim import AdamW
from repro_torch.sharding.partition import NULL_PLAN
from repro_torch.tree import tree_leaves, tree_unflatten

NEW = ["mixtral-8x7b", "deepseek-moe-16b", "mamba2-2.7b",
       "jamba-1.5-large-398b", "llama-3.2-vision-90b"]
RTOL, ATOL = 1e-4, 1e-5


def close(got: torch.Tensor, want, what: str = "", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """The reduced config's reference model and its parameters (seed 0),
    drawn once for the file."""
    jm = JLM(jbase.reduce_config(jbase.get_config(name)))
    return jm, jax.jit(jm.init)(jax.random.key(0))


def pair(name: str):
    """The reference model and parameters, and the port's model on a fresh
    copy of the same parameters (a train step writes them in place)."""
    jm, jp = reference(name)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, LM(base.reduce_config(base.get_config(name))), params


def jitted(jm):
    """The reference model's forward, prefill and decode step, jitted."""
    return (jax.jit(jm.forward),
            jax.jit(jm.prefill, static_argnames=("max_len",)),
            jax.jit(jm.decode_step))


def batch(cfg, B: int, S: int, seed: int = 0, targets: bool = False):
    """Tokens (and targets, and a vision config's image embeddings) made
    with numpy: the reference's batch and the port's."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if targets:
        b["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        b["image_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v) for k, v in b.items()})


def cut(b: dict, lo: int, hi: int) -> dict:
    """Positions lo .. hi-1 of a batch; the image embeddings stay whole."""
    return {k: v if k == "image_embeds" else v[:, lo:hi] for k, v in b.items()}


def caches_close(tc, jc, what: str):
    """Every cache leaf: positions exactly, values within tolerance; the
    same tree of the same shapes and dtypes."""
    assert tc.keys() == jc.keys(), what
    for m in jc:
        assert tc[m].keys() == jc[m].keys(), (what, m)
        for leaf, want in jc[m].items():
            got = tc[m][leaf]
            assert tuple(got.shape) == want.shape, (what, m, leaf)
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            if leaf == "kpos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                close(got, want, f"{what} {m}.{leaf}")


# ---------------------------------------------------------------------------
# the LM of each new config against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NEW)
def test_lm_logits_caches_and_aux_match_reference(name):
    """Forward logits and aux; prefill's last logits and every cache leaf;
    three decode steps' logits and caches."""
    jm, jp, m, p = pair(name)
    jforward, jprefill, jdecode = jitted(jm)
    jb, tb = batch(m.cfg, 2, 32)
    jl, _, jaux = jforward(jp, jb)
    tl, _, aux = m.forward(p, tb)
    close(tl, jl, "forward")
    close(aux, jaux, "aux")
    if m.cfg.is_moe:
        assert float(aux) > 0
    jlast, jc = jprefill(jp, cut(jb, 0, 16), max_len=32)
    tlast, tc = m.prefill(p, cut(tb, 0, 16), max_len=32)
    close(tlast, jlast, "prefill")
    caches_close(tc, jc, "prefill cache")
    for pos in range(16, 19):
        jlg, jc = jdecode(jp, jc, cut(jb, pos, pos + 1), jnp.int32(pos))
        tlg, tc = m.decode_step(p, tc, cut(tb, pos, pos + 1), pos)
        close(tlg, jlg, f"decode {pos}")
        caches_close(tc, jc, f"decode {pos} cache")


@pytest.mark.parametrize("name", NEW)
def test_decode_matches_forward(name):
    """Prefill t0 = 16 tokens (a multiple of the reduced window), decode
    the rest: the logits of the full forward (the reference test's check,
    on the port alone)."""
    _, _, m, p = pair(name)
    _, tb = batch(m.cfg, 2, 32, seed=1)
    full, _, _ = m.forward(p, tb)
    last, caches = m.prefill(p, cut(tb, 0, 16), max_len=32)
    np.testing.assert_allclose(last.numpy(), full[:, 15].numpy(),
                               rtol=2e-4, atol=2e-4)
    for pos in range(16, 32):
        lg, caches = m.decode_step(p, caches, cut(tb, pos, pos + 1), pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"{pos}")


@pytest.mark.parametrize("name", NEW)
def test_three_train_steps_match_reference(name):
    """Three AdamW steps through `make_train_step` (the loss with the MoE
    aux term, the plain chunked attention) against the reference's jitted
    step from the same parameters, on the same batches."""
    jm, jp, m, p = pair(name)
    cfg, jcfg = m.cfg, jm.cfg
    jopt = JAdamW(lr=1e-3)
    js = jsteps.init_opt_state(jcfg, jopt, jp)
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, JNULL_PLAN, jopt))
    opt = AdamW(lr=1e-3)
    state = steps.init_opt_state(cfg, opt, p)
    step = steps.make_train_step(LM(cfg, flash=False), cfg, NULL_PLAN, opt)
    losses = []
    for i in range(3):
        jb, tb = batch(cfg, 2, 32, seed=10 + i, targets=True)
        jp, js, jmet = jstep(jp, js, jb)
        p, state, met = step(p, state, tb)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"step {i} loss")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4,
                                   err_msg=f"step {i} grad_norm")
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "jamba-1.5-large-398b"])
def test_remat_carries_the_moe_aux(name):
    """With ``remat`` each superblock runs under `torch.utils.checkpoint`,
    which must carry the MoE aux loss out with the activations: the loss
    and every gradient equal to the plain run's."""
    _, _, m, p = pair(name)
    cfg = m.cfg
    remat = cfg.replace(parallel=cfg.parallel.__class__(
        **{**cfg.parallel.__dict__, "remat": True}))
    _, tb = batch(cfg, 2, 32, seed=7, targets=True)
    got = {}
    for c in (cfg, remat):
        loss_fn = steps.make_loss_fn(LM(c, flash=False), c, NULL_PLAN)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(p)]
        q = tree_unflatten(p, leaves)
        loss, _ = loss_fn(q, tb)
        got[c.parallel.remat] = (loss, torch.autograd.grad(loss, leaves))
    assert float(got[True][0]) == pytest.approx(float(got[False][0]),
                                                rel=1e-6)
    for a, b in zip(got[True][1], got[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# sliding windows and cross attention in the LM
# ---------------------------------------------------------------------------
def test_ring_layout_quirk_is_the_reference_s():
    """A prefill of S = 24 > W = 16 with S % W != 0 keeps positions 8..23
    at ring slots 0..15, but decode writes position p at slot p % 16, so
    the first decode step evicts position 16, still inside the window.
    The port reproduces the reference's decode logits, and with them the
    reference's gap from `forward` (about 0.066 on this seed)."""
    jm, jp, m, p = pair("mixtral-8x7b")
    jforward, jprefill, jdecode = jitted(jm)
    jb, tb = batch(m.cfg, 2, 25)
    jfull, _, _ = jforward(jp, jb)
    full, _, _ = m.forward(p, tb)
    close(full, jfull, "forward")
    _, jc = jprefill(jp, cut(jb, 0, 24), max_len=32)
    _, tc = m.prefill(p, cut(tb, 0, 24), max_len=32)
    np.testing.assert_array_equal(tc["m0"]["kpos"][0, 0].numpy(),
                                  np.arange(8, 24))
    jlg, jc = jdecode(jp, jc, cut(jb, 24, 25), jnp.int32(24))
    tlg, tc = m.decode_step(p, tc, cut(tb, 24, 25), 24)
    close(tlg, jlg, "decode after the ring quirk")
    caches_close(tc, jc, "ring")
    gap = float((tlg - full[:, 24]).abs().max())
    jgap = float(jnp.abs(jlg - jfull[:, 24]).max())
    assert gap > 1e-2 and gap == pytest.approx(jgap, rel=1e-3), (gap, jgap)
    # at S % W == 0 the layouts agree and decode meets forward
    _, tc = m.prefill(p, cut(tb, 0, 16), max_len=32)
    for pos in range(16, 25):
        tlg, tc = m.decode_step(p, tc, cut(tb, pos, pos + 1), pos)
    np.testing.assert_allclose(tlg.numpy(), full[:, 24].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_cross_layer_has_no_qk_norm_and_reads_a_static_cache():
    """The vision config's cross member: no q/k norms; its prefill cache is
    the image K/V with every position 0, and decode leaves it as it was."""
    jm, jp, m, p = pair("llama-3.2-vision-90b")
    cross = p["stack"]["m4"]["attn"]
    assert set(cross) == {"wq", "wk", "wv", "wo"}
    _, tb = batch(m.cfg, 2, 9)
    _, caches = m.prefill(p, cut(tb, 0, 8), max_len=16)
    c = caches["m4"]
    assert c["kpos"].shape == (m.cfg.num_layers // 5, m.cfg.num_image_tokens)
    assert not c["kpos"].any()
    before = {k: v.clone() for k, v in c.items()}
    _, caches = m.decode_step(p, caches, cut(tb, 8, 9), 8)
    assert all(torch.equal(caches["m4"][k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# Mamba2 and the caches
# ---------------------------------------------------------------------------
def test_mamba_decode_refuses_more_than_one_token():
    _, _, m, p = pair("mamba2-2.7b")
    _, tb = batch(m.cfg, 2, 8)
    _, caches = m.prefill(p, tb, max_len=16)
    with pytest.raises(ValueError, match="one token per call"):
        m.decode_pages(p, caches, tb, torch.arange(8, 16).expand(2, 8),
                       torch.ones(2, 8, dtype=torch.bool))


@pytest.mark.parametrize("name", NEW)
def test_init_cache_has_the_reference_structure(name):
    """`init_cache` builds the reference's tree: KV rings, SSM and conv
    states, the cross layers' image K/V, of the same shapes and dtypes,
    and the same values."""
    jm, _, m, _ = pair(name)
    jc = jm.init_cache(3, 40)
    tc = m.init_cache(3, 40, device="cpu")
    caches_close(tc, jc, "init_cache")
