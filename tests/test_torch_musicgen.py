"""musicgen-medium's LM in the port against the JAX reference's.

musicgen-medium is the one config whose LM takes frame embeddings
(``embed_input=False``: the batch carries ``embeds`` (B, S, D), no token
table), with as many KV heads as query heads.  At `reduce_config`
float32, on parameters converted from the reference's
(`convert.lm_params_from_reference`) and the same seeded numpy frame
embeddings, with the tolerances of `tests/test_torch_stack.py`: forward
logits within rtol 1e-4 / atol 1e-5 of the reference's; one train step's
loss within rtol 1e-5 and gradient norm within rtol 1e-4; prefill's last
logits and its caches within rtol 1e-4 / atol 1e-5 of the reference's
prefill, and against the port's own forward within 2e-4 (the prefill's
last logits) and 2e-3 (each decode step), the bounds of
`tests/test_models.py`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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

NAME = "musicgen-medium"
RTOL, ATOL = 1e-4, 1e-5


def close(got, want, what: str = "", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@functools.lru_cache(maxsize=None)
def reference():
    jm = JLM(jbase.reduce_config(jbase.get_config(NAME)))
    return jm, jax.jit(jm.init)(jax.random.key(0))


def pair():
    """The reference model and parameters, and the port's model on a fresh
    copy of the same parameters (a train step writes them in place)."""
    jm, jp = reference()
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, LM(base.reduce_config(base.get_config(NAME))), params


def batch(cfg, B: int, S: int, seed: int = 0, targets: bool = False):
    """Frame embeddings (and targets) made with numpy: the reference's
    batch and the port's."""
    import torch
    rng = np.random.default_rng(seed)
    b = {"embeds": (0.1 * rng.standard_normal((B, S, cfg.d_model)))
         .astype(np.float32)}
    if targets:
        b["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v) for k, v in b.items()})


def cut(b: dict, lo: int, hi: int) -> dict:
    return {k: v[:, lo:hi] for k, v in b.items()}


def test_config_takes_frame_embeddings_over_whole_kv_heads():
    cfg = base.reduce_config(base.get_config(NAME))
    full = base.get_config(NAME)
    assert not cfg.embed_input and not full.embed_input
    assert full.num_heads == full.num_kv_heads == 24
    assert (full.num_layers, full.d_model, full.head_dim) == (48, 1536, 64)
    _, _, m, p = pair()
    assert "embed" not in p


def test_forward_logits_match_reference():
    jm, jp, m, p = pair()
    jb, tb = batch(m.cfg, 2, 32)
    jl, _, jaux = jax.jit(jm.forward)(jp, jb)
    tl, _, aux = m.forward(p, tb)
    assert tuple(tl.shape) == (2, 32, m.cfg.vocab_padded)
    close(tl, jl, "forward")
    close(aux, jaux, "aux")


@pytest.mark.parametrize("seed", (10, 11))
def test_one_train_step_matches_reference(seed):
    """One AdamW step through `make_train_step` (the plain chunked
    attention) against the reference's jitted step: loss and gradient
    norm."""
    jm, jp, m, p = pair()
    cfg = m.cfg
    jopt = JAdamW(lr=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jm, jm.cfg, JNULL_PLAN, jopt))
    js = jsteps.init_opt_state(jm.cfg, jopt, jp)
    opt = AdamW(lr=1e-3)
    state = steps.init_opt_state(cfg, opt, p)
    step = steps.make_train_step(LM(cfg, flash=False), cfg, NULL_PLAN, opt)
    jb, tb = batch(cfg, 2, 32, seed=seed, targets=True)
    _, _, jmet = jstep(jp, js, jb)
    _, _, met = step(p, state, tb)
    assert np.isfinite(float(met["loss"]))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5, err_msg="loss")
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4,
                               err_msg="grad_norm")


def test_prefill_matches_reference_and_forward():
    """Prefill of 16 frames: its last logits and caches against the
    reference's prefill, and against the port's forward; then 16 decode
    steps, one frame each, against the forward's logits."""
    jm, jp, m, p = pair()
    jb, tb = batch(m.cfg, 2, 32, seed=1)
    jlast, jc = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, cut(jb, 0, 16), max_len=32)
    last, caches = m.prefill(p, cut(tb, 0, 16), max_len=32)
    close(last, jlast, "prefill")
    for mem, leaves in jc.items():
        for leaf, want in leaves.items():
            got = caches[mem][leaf]
            assert tuple(got.shape) == want.shape, (mem, leaf)
            if leaf == "kpos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                close(got, want, f"prefill cache {mem}.{leaf}")
    full, _, _ = m.forward(p, tb)
    np.testing.assert_allclose(last.numpy(), full[:, 15].numpy(),
                               rtol=2e-4, atol=2e-4)
    for pos in range(16, 32):
        lg, caches = m.decode_step(p, caches, cut(tb, pos, pos + 1), pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"{pos}")
