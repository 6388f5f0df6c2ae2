"""The port's model stack (`repro_torch.models`) against the JAX `LM`.

Parameters are the reference's, converted from its pytree
(`convert.lm_params_from_reference`); inputs are made with numpy from a
seed.  Tolerance: float32 logits within rtol 1e-4, atol 1e-5 of the
reference's (the reduced configs run in float32; the two frameworks sum
in other orders), caches' positions exact; decode == forward within the
reference test's own bounds (`tests/test_models.py`).  Every copied config
is held equal to its original field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models.model import LM as JLM

from repro_torch import configs
from repro_torch.configs import base
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import KERNEL_TOL
from repro_torch.models import LM
from repro_torch.models.attention import (chunked_attention,
                                          flash_prefill_attention)

DENSE = ["qwen3-0.6b", "glm4-9b", "granite-20b", "granite-3-2b"]
RTOL, ATOL = 1e-4, 1e-5


def close(got: torch.Tensor, want, what: str = ""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def pair(name: str, layers=None, seed: int = 0):
    """The reduced config's reference model and parameters, and the port's
    model on the same parameters."""
    jcfg = jbase.reduce_config(jbase.get_config(name), layers=layers)
    cfg = base.reduce_config(base.get_config(name), layers=layers)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(seed))
    params = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, LM(cfg), params


def tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def both(toks: np.ndarray):
    """The same tokens for the reference and the port."""
    return ({"tokens": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks).long()})


# ---------------------------------------------------------------------------
# the configs: copies of the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_arch_config_copy_equals_reference(name):
    ref, got = jbase.get_config(name), base.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.vocab_padded == ref.vocab_padded
    assert got.attn_layers == ref.attn_layers
    assert got.param_counts() == ref.param_counts()
    for layers in (None, 4):
        assert (dataclasses.asdict(base.reduce_config(got, layers=layers))
                == dataclasses.asdict(jbase.reduce_config(ref,
                                                          layers=layers)))


def test_config_registry_and_shapes_equal_reference():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert set(base.list_configs()) == set(jbase.list_configs())
    assert base.pad_to(503, 256) == jbase.pad_to(503, 256) == 512
    with pytest.raises(KeyError, match="unknown arch"):
        base.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# the LM against the reference's, on converted parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", DENSE)
def test_lm_logits_and_caches_match_reference(name):
    jm, jp, m, p = pair(name)
    jb, tb = both(tokens(m.cfg, 2, 24))
    jl, _, _ = jm.forward(jp, jb)
    tl, _, aux = m.forward(p, tb)
    close(tl, jl, "forward")
    assert float(aux) == 0.0
    # prefill of the first 16, then decode steps at a shared clock
    jb16, tb16 = both(tokens(m.cfg, 2, 24)[:, :16])
    jlast, jc = jm.prefill(jp, jb16, max_len=24)
    tlast, tc = m.prefill(p, tb16, max_len=24)
    close(tlast, jlast, "prefill")
    for leaf in ("k", "v"):
        close(tc["m0"][leaf], jc["m0"][leaf], f"prefill cache {leaf}")
    np.testing.assert_array_equal(tc["m0"]["kpos"].numpy(),
                                  np.asarray(jc["m0"]["kpos"]))
    toks = tokens(m.cfg, 2, 24)
    for pos in range(16, 19):
        jb1, tb1 = both(toks[:, pos:pos + 1])
        jlg, jc = jm.decode_step(jp, jc, jb1, jnp.int32(pos))
        tlg, tc = m.decode_step(p, tc, tb1, pos)
        close(tlg, jlg, f"decode {pos}")
        np.testing.assert_array_equal(tc["m0"]["kpos"].numpy(),
                                      np.asarray(jc["m0"]["kpos"]))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "granite-3-2b"])
def test_lm_decode_pages_and_row_clocks_match_reference(name):
    """Page-stepped prefill into an empty cache with a write mask (ragged
    rows), then one decode step at per-row (B,) clocks."""
    jm, jp, m, p = pair(name, layers=2)
    B, ps, L = 3, 4, 16
    toks = tokens(m.cfg, B, 2 * ps, seed=3)
    plen = np.asarray([8, 5, 3])
    jc = jm.init_cache(B, L)
    tc = m.init_cache(B, L, device="cpu")
    for lv in range(2):
        positions = np.broadcast_to(lv * ps + np.arange(ps, dtype=np.int32),
                                    (B, ps))
        wm = positions < plen[:, None]
        jb, tb = both(toks[:, lv * ps:(lv + 1) * ps])
        jlg, jc = jm.decode_pages(jp, jc, jb, jnp.asarray(positions),
                                  jnp.asarray(wm))
        tlg, tc = m.decode_pages(p, tc, tb, torch.from_numpy(positions.copy()),
                                 torch.from_numpy(wm))
        close(tlg, jlg, f"page {lv}")
        np.testing.assert_array_equal(tc["m0"]["kpos"].numpy(),
                                      np.asarray(jc["m0"]["kpos"]))
        for leaf in ("k", "v"):
            close(tc["m0"][leaf], jc["m0"][leaf], f"page {lv} {leaf}")
    jb, tb = both(toks[:, :1])
    jlg, jc = jm.decode_step(jp, jc, jb, jnp.asarray(plen, jnp.int32))
    tlg, tc = m.decode_step(p, tc, tb, torch.from_numpy(plen))
    close(tlg, jlg, "row clocks")


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_forward(name):
    """Prefill t0 tokens, decode the rest: the logits of the full forward
    (the reference test's check, on the port alone)."""
    _, _, m, p = pair(name)
    toks = torch.from_numpy(tokens(m.cfg, 2, 32, seed=1)).long()
    full, _, _ = m.forward(p, {"tokens": toks})
    last, caches = m.prefill(p, {"tokens": toks[:, :16]}, max_len=32)
    np.testing.assert_allclose(last.numpy(), full[:, 15].numpy(),
                               rtol=2e-4, atol=2e-4)
    for pos in range(16, 32):
        lg, caches = m.decode_step(p, caches, {"tokens": toks[:, pos:pos + 1]},
                                   pos)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"{pos}")


def test_decode_writes_the_donated_cache_in_place_as_the_reference_updates_it():
    """The decode cache is donated: the step writes it in place, and what
    it holds afterwards is the reference's functional update."""
    jm, jp, m, p = pair("qwen3-0.6b", layers=2)
    toks = tokens(m.cfg, 2, 9)
    jb, tb = both(toks[:, :8])
    _, jc = jm.prefill(jp, jb, max_len=12)
    _, caches = m.prefill(p, tb, max_len=12)
    storage = {k: v.data_ptr() for k, v in caches["m0"].items()}
    jb1, tb1 = both(toks[:, 8:])
    _, jc = jm.decode_step(jp, jc, jb1, jnp.int32(8))
    _, new = m.decode_step(p, caches, tb1, 8)
    assert {k: v.data_ptr() for k, v in new["m0"].items()} == storage
    np.testing.assert_array_equal(new["m0"]["kpos"].numpy(),
                                  np.asarray(jc["m0"]["kpos"]))
    assert int(new["m0"]["kpos"][0, 0, 8]) == 8
    for leaf in ("k", "v"):
        close(new["m0"][leaf], jc["m0"][leaf], f"decode cache {leaf}")


# ---------------------------------------------------------------------------
# prefill attention: the kernel's layout, and the CPU path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("KV,Gq,hd", [(2, 2, 16), (8, 2, 128), (1, 4, 64)])
def test_flash_prefill_layout_matches_chunked_attention(KV, Gq, hd):
    """`flash_prefill_attention` on CPU tensors runs the kernel's plain
    version through the model's layout transposes: head kv * Gq + g must
    read KV head kv, as `chunked_attention` groups them (float32, within
    the kernel's own tolerance)."""
    rng = np.random.default_rng(KV * Gq + hd)
    B, S = 2, 37
    q = torch.from_numpy(rng.standard_normal((B, S, KV, Gq, hd),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, KV, hd),
                                                 dtype=np.float32))
            for _ in range(2))
    pos = torch.arange(S)
    want = chunked_attention(q, k, v, q_positions=pos, kv_positions=pos,
                             kv_chunk=16)
    got = flash_prefill_attention(q, k, v)
    rtol, atol = KERNEL_TOL[torch.float32]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)


def test_prefill_on_the_cpu_runs_the_plain_chunked_form():
    """A CPU prefill launches no kernel and gives the same bits with the
    kernel route on or off (both plain on the CPU)."""
    jm, jp, m, p = pair("qwen3-0.6b", layers=2)
    toks = torch.from_numpy(tokens(m.cfg, 2, 12)).long()
    ops.reset_launches()
    a, _ = m.prefill(p, {"tokens": toks}, max_len=16)
    b, _ = LM(m.cfg, flash=False).prefill(p, {"tokens": toks}, max_len=16)
    assert ops.launch_counts()["flash_attention"] == 0
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# parameters, and every member kind
# ---------------------------------------------------------------------------
def test_init_has_the_reference_structure_and_follows_the_seed():
    cfg = base.reduce_config(base.get_config("qwen3-0.6b"))
    ref = jax.eval_shape(JLM(jbase.reduce_config(
        jbase.get_config("qwen3-0.6b"))).init, jax.random.key(0))
    got = LM(cfg).init(torch.Generator().manual_seed(5))
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, got, is_leaf=torch.is_tensor))[0]
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in flat_ref] == \
        [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in flat_got]
    again = LM(cfg).init(torch.Generator().manual_seed(5))
    assert torch.equal(got["stack"]["m0"]["attn"]["wq"],
                       again["stack"]["m0"]["attn"]["wq"])


def test_params_from_reference_keep_bfloat16_bits():
    w = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16)
    t = lm_params_from_reference({"a": {"w": w}}, "cpu")["a"]["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16))


@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b"])
def test_every_member_kind_builds_with_the_reference_structure(name):
    """The members that `tests/test_torch_stack.py` holds to the reference
    (sliding windows, MoE, Mamba2, cross attention) build from a seed with
    the reference's parameter tree -- keys, shapes, dtypes -- and run
    forward, prefill and a decode step to finite logits."""
    jcfg = jbase.reduce_config(jbase.get_config(name))
    cfg = base.reduce_config(base.get_config(name))
    ref = jax.eval_shape(JLM(jcfg).init, jax.random.key(0))
    m = LM(cfg)
    got = m.init(torch.Generator().manual_seed(5))
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, got, is_leaf=torch.is_tensor))[0]
    assert [(k, tuple(v.shape), str(v.dtype)) for k, v in flat_ref] == \
        [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in flat_got]
    b = {"tokens": torch.from_numpy(tokens(cfg, 2, 17)).long()}
    if cfg.family == "vlm":
        b["image_embeds"] = 0.1 * torch.randn(
            2, cfg.num_image_tokens, cfg.d_model,
            generator=torch.Generator().manual_seed(1))
    logits, _, aux = m.forward(got, b)
    assert logits.shape == (2, 17, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    last, caches = m.prefill(got, {**b, "tokens": b["tokens"][:, :16]},
                             max_len=24)
    lg, _ = m.decode_step(got, caches, {**b, "tokens": b["tokens"][:, 16:]},
                          16)
    assert bool(torch.isfinite(last).all()) and bool(torch.isfinite(lg).all())
