"""The members of the rest of the port's model stack against the JAX
reference's: banded and windowed attention, the kernel layout for cross
and windowed prefill, mixture-of-experts (at a capacity that drops
tokens, so that the drop path is compared too) and Mamba2 SSD with a
carried-in state and its decode step.

Inputs are made with numpy from a seed; MoE and Mamba2 parameters are the
reference's (`init_moe`, `init_mamba` at `reduce_config`), converted
(`convert.lm_params_from_reference`).  Tolerance: float32 within rtol
1e-4, atol 1e-5 (the frameworks sum in other orders); the banded form
against the port's chunked one within 2e-5 (the reference test's own
bound, `tests/test_models.py::test_banded_swa_matches_chunked`); the
kernel's plain version within `KERNEL_TOL`.  The LM-level parity of the
five configs is `tests/test_torch_stack.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattention
from repro.models import mamba2 as jmamba2
from repro.models import moe as jmoe

from repro_torch.configs import base
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import KERNEL_TOL
from repro_torch.models import attention, mamba2, moe

RTOL, ATOL = 1e-4, 1e-5


def close(got: torch.Tensor, want, what: str = "", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# sliding windows
# ---------------------------------------------------------------------------
def _qkv(B, S, KV, Gq, hd, seed, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Skv or S
    return (rng.standard_normal((B, S, KV, Gq, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Skv, KV, hd), dtype=np.float32))


def test_banded_swa_matches_reference_and_windowed_chunked():
    """The banded O(S*W) form against the reference's, and against the
    port's chunked form with the window mask (which the banded one
    replaces where S % W == 0)."""
    B, S, KV, Gq, hd, W = 2, 128, 2, 2, 16, 32
    q, k, v = _qkv(B, S, KV, Gq, hd, 3)
    want = jattention.banded_swa_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), window=W)
    got = attention.banded_swa_attention(t(q), t(k), t(v), window=W)
    close(got, want, "banded")
    pos = torch.arange(S)
    # kv_chunk 16 and S = W keep the chunked form off the banded path
    chunked = torch.cat([attention.chunked_attention(
        t(q)[:, i:i + W], t(k), t(v), q_positions=pos[i:i + W],
        kv_positions=pos, causal=True, window=W, kv_chunk=16)
        for i in range(0, S, W)], dim=1)
    np.testing.assert_allclose(got.numpy(), chunked.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S,W", [(24, 16), (40, 16), (16, 16), (64, 16)])
def test_windowed_chunked_attention_matches_reference(S, W):
    """`chunked_attention` with a window, on and off the banded path."""
    q, k, v = _qkv(2, S, 2, 2, 16, S)
    pos = np.arange(S, dtype=np.int32)
    want = jattention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        causal=True, window=W, kv_chunk=16)
    got = attention.chunked_attention(
        t(q), t(k), t(v), q_positions=t(pos).long(),
        kv_positions=t(pos).long(), causal=True, window=W, kv_chunk=16)
    close(got, want)


# ---------------------------------------------------------------------------
# the kernel's layout for cross and windowed prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Skv,window", [(24, 40, 0), (33, 7, 0),
                                           (64, 64, 16), (40, 40, 16)])
def test_flash_prefill_layout_for_cross_and_window(Sq, Skv, window):
    """`flash_prefill_attention` on CPU tensors runs the kernel's plain
    version through the model's layout transposes, non-causal with Sq !=
    Skv (cross attention) and causal with a window: equal to
    `chunked_attention` within the kernel's float32 tolerance."""
    q, k, v = _qkv(2, Sq, 2, 2, 16, Sq + Skv, Skv=Skv)
    causal = Skv == Sq
    want = attention.chunked_attention(
        t(q), t(k), t(v), q_positions=torch.arange(Sq),
        kv_positions=torch.arange(Skv), causal=causal, window=window,
        kv_chunk=16)
    got = attention.flash_prefill_attention(t(q), t(k), t(v), causal=causal,
                                            window=window)
    rtol, atol = KERNEL_TOL[torch.float32]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# mixture-of-experts
# ---------------------------------------------------------------------------
def _moe_pair(name: str, seed: int, **fields):
    jcfg = jbase.reduce_config(jbase.get_config(name)).replace(**fields)
    cfg = base.reduce_config(base.get_config(name)).replace(**fields)
    jp = jax.jit(lambda k: jmoe.init_moe(k, jcfg))(jax.random.key(seed))
    return jcfg, cfg, jp, lm_params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_moe_drops_tokens_as_the_reference_does(name):
    """`apply_moe` at capacity_factor 0.5: buckets overflow and tokens
    drop; outputs and aux equal to the reference's, group by group (two
    groups of 32 tokens), and the same tokens dropped."""
    jcfg, cfg, jp, p = _moe_pair(name, 1, capacity_factor=0.5)
    x = np.random.default_rng(2).standard_normal((4, 16, cfg.d_model),
                                                 dtype=np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg, group_size=32))(
        jp, jnp.asarray(x))
    y, aux = moe.apply_moe(p, t(x), cfg, group_size=32)
    close(y, jy, "moe y")
    close(aux, jaux, "moe aux")
    # the drop path ran: fewer bucket slots than token-expert assignments
    C = moe._capacity(32, cfg)
    assert C * cfg.num_experts < 32 * cfg.top_k
    no_drop = cfg.replace(capacity_factor=4.0)
    y_all, _ = moe.apply_moe(p, t(x), no_drop, group_size=32)
    assert float((y_all - y).abs().max()) > 1e-3


def test_moe_decode_group_is_the_batch():
    """Decode runs the MoE with one group of B tokens (``group_size =
    B``), as the reference's `_decode_member`."""
    jcfg, cfg, jp, p = _moe_pair("deepseek-moe-16b", 3, capacity_factor=1.0)
    x = np.random.default_rng(4).standard_normal((6, 1, cfg.d_model),
                                                 dtype=np.float32)
    jy, _ = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, group_size=6)
    y, _ = moe.apply_moe(p, t(x), cfg, group_size=6)
    close(y, jy)
    with pytest.raises(AssertionError, match="not divisible"):
        moe.apply_moe(p, t(np.zeros((3, 5, cfg.d_model), np.float32)), cfg,
                      group_size=4)


def test_top_k_breaks_ties_to_the_lower_index():
    """`lax.top_k`'s order: equal gates go lowest index first."""
    gates = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25] * 4 + [0.0]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), 3)
    v, i = moe.top_k(t(gates), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
def _mamba_pair(name: str, seed: int):
    jcfg = jbase.reduce_config(jbase.get_config(name))
    cfg = base.reduce_config(base.get_config(name))
    jp = jax.jit(lambda k: jmamba2.init_mamba(k, jcfg))(jax.random.key(seed))
    return jcfg, cfg, jp, lm_params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_mamba_with_a_carried_state_and_decode_match_reference(name):
    """`apply_mamba` over three chunks from a carried-in SSM state, then
    `decode_mamba` steps from its final state: outputs and states equal to
    the reference's; decode writes the state in place."""
    jcfg, cfg, jp, p = _mamba_pair(name, 5)
    rng = np.random.default_rng(6)
    B, S = 2, 48
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    s0 = rng.standard_normal((B, cfg.ssm_nheads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=np.float32)
    japply = jax.jit(lambda p, x, s: jmamba2.apply_mamba(
        p, x, jcfg, state={"ssm": s}, chunk=16))
    jdecode = jax.jit(lambda p, x, s: jmamba2.decode_mamba(p, x, s, jcfg))
    jy, jst = japply(jp, jnp.asarray(x), jnp.asarray(s0))
    y, st = mamba2.apply_mamba(p, t(x), cfg, state={"ssm": t(s0)}, chunk=16)
    close(y, jy, "apply_mamba y")
    for leaf in ("ssm", "conv_x", "conv_bc"):
        close(st[leaf], jst[leaf], f"apply_mamba {leaf}")
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    for i in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        jy, jst = jdecode(jp, jnp.asarray(x1), jst)
        y, st = mamba2.decode_mamba(p, t(x1), st, cfg)
        close(y, jy, f"decode_mamba {i}")
        for leaf in ("ssm", "conv_x", "conv_bc"):
            close(st[leaf], jst[leaf], f"decode_mamba {i} {leaf}")
    assert {k: v.data_ptr() for k, v in st.items()} == ptrs




# ---------------------------------------------------------------------------
# a bfloat16 cross layer fed float32 image embeddings
# ---------------------------------------------------------------------------
def _bf16_vision(pkg):
    cfg = pkg.reduce_config(pkg.get_config("llama-3.2-vision-90b"))
    return cfg.replace(dtype="bfloat16", param_dtype="bfloat16")


def test_bf16_cross_layer_takes_float32_image_embeds(monkeypatch):
    """A bfloat16 vision cross layer over float32 `image_embeds` (what the
    data pipeline makes): K/V are promoted to float32, as the reference's
    einsum promotes them, and the kernel route runs the kernel at float32
    (one ``fa_kernel`` launch) where it raised on the mixed dtypes.  On
    ``meta`` tensors it notes that launch; on the CPU both the plain route
    and the kernel route (its plain version through the model's layout)
    match the reference's `apply_attention` on the same parameters within
    bfloat16 rounding: one bfloat16 step of the attention output, carried
    through the output projection (2**-6 of the largest output)."""
    from repro_torch.analysis.launches import record
    from repro_torch.tree import tree_map
    jcfg, cfg = _bf16_vision(jbase), _bf16_vision(base)
    jp = jattention.init_attention(jax.random.key(3), jcfg, cross=True)
    p = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    img = (0.1 * rng.standard_normal(
        (2, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    with record() as launches:
        y, _ = attention.apply_attention(
            tree_map(lambda a: a.to("meta"), p), xb.to("meta"), cfg=cfg,
            kv_src=torch.from_numpy(img).to("meta"), cross=True)
    assert y.is_meta and y.dtype == torch.bfloat16 and y.shape == xb.shape
    assert [(f.name, f.call[1][3:5] + f.call[1][-1:]) for f in launches] == [
        ("fa_kernel", (20, cfg.num_image_tokens, "float32"))]
    want, _ = jattention.apply_attention(
        jp, jnp.asarray(x, jnp.bfloat16), cfg=jcfg, plan=None,
        kv_src=jnp.asarray(img), cross=True)
    want = np.asarray(want, np.float32)
    plain, _ = attention.apply_attention(p, xb, cfg=cfg,
                                         kv_src=torch.from_numpy(img),
                                         cross=True)
    monkeypatch.setattr(
        attention, "prefill_attention",
        lambda q, k, v, *, causal, window, **kw:
        attention.flash_prefill_attention(q, k, v, causal=causal,
                                          window=window))
    routed, _ = attention.apply_attention(p, xb, cfg=cfg,
                                          kv_src=torch.from_numpy(img),
                                          cross=True)
    for got in (plain, routed):
        assert got.dtype == torch.bfloat16
        close(got, want, rtol=2.0 ** -7,
              atol=2.0 ** -6 * float(np.abs(want).max()))
