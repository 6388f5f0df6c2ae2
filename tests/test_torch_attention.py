"""The port's plain flash attention against the JAX kernel.

The plain blocked version (`flash_attention_reference`, what
`ops.flash_attention` runs on a CPU tensor) against the reference's
`ops.flash_attention` in interpret mode, over the six `ATTN_CASES` of
`tests/test_kernels.py` (causal, GQA, ragged + MQA, sliding window,
cross with Sq != Skv), float32 and bfloat16, on the same seeded inputs.
Tolerance: rtol = atol = 2e-5 for float32 and 2e-2 for bfloat16, the
reference test's own: both sides compute in float32, but their sums run
in another order (and bfloat16 outputs round at another place).  The dense
`attention_ref` is held to the reference's dense oracle the same way, and
tile skipping to the dense window mask.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference package)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import make_attention_inputs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_reference,
                                                 kernel_tiles, live_tiles,
                                                 smem_bytes)

ATTN_CASES = [
    # (B, H, KV, Sq, Skv, hd, causal, window, bq, bk)
    (1, 2, 2, 128, 128, 32, True, 0, 64, 64),
    (2, 4, 2, 128, 128, 64, True, 0, 64, 64),      # GQA
    (1, 2, 1, 96, 96, 32, True, 0, 64, 64),        # ragged tail + MQA
    (1, 2, 2, 128, 128, 32, True, 48, 64, 64),     # sliding window
    (2, 2, 2, 64, 192, 32, False, 0, 64, 64),      # cross (no mask), Sq != Skv
    (1, 8, 8, 256, 256, 16, True, 0, 128, 128),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(case, dtype, seed=0):
    B, H, KV, Sq, Skv, hd = case[:6]
    arrs = make_attention_inputs(B, H, KV, Sq, Skv, hd, dtype, seed)
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_plain_flash_attention_matches_jax_kernel(case, dtype):
    causal, window, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = inputs(case, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=bq, block_k=bk)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=bq, block_k=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    dense = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(as_f32(attention_ref(q, k, v, causal=causal,
                                                    window=window)),
                               as_f32(dense), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("window,causal", [(64, True), (100, True),
                                           (64, False)])
def test_tile_skipping_matches_the_dense_window_mask(window, causal):
    """Many KV tiles skipped, the result of the dense mask all the same."""
    case = (1, 2, 2, 512, 512, 32)
    _, (q, k, v) = inputs(case + (causal, window, 64, 64), "float32", 1)
    live = live_tiles(512, 512, causal=causal, window=window, block_q=64,
                      block_k=64)
    assert 0 < int(live.sum()) < live.numel()
    got = flash_attention_reference(q, k, v, causal=causal, window=window,
                                    block_q=64, block_k=64)
    want = attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_live_tiles_is_the_reference_predicate():
    """The reference's `live`: causal drops first_k > last_q, the window
    drops last_k <= first_q - window."""
    live = live_tiles(256, 256, causal=True, window=100, block_q=64,
                      block_k=64)
    for i in range(4):
        for j in range(4):
            fq, lq, fk, lk = 64 * i, 64 * i + 63, 64 * j, 64 * j + 63
            assert bool(live[i, j]) == (fk <= lq and lk > fq - 100)


def test_kernel_tiles_fit_shared_memory():
    from repro_torch.kernels import SMEM_BYTES_PER_BLOCK
    assert kernel_tiles(96, 96, 64, 64) == (64, 64)
    assert kernel_tiles(100, 50, 128, 128) == (112, 64)
    assert smem_bytes(128, 128, 128) == 198_144 <= SMEM_BYTES_PER_BLOCK
    assert smem_bytes(128, 128, 128) > 48 * 1024


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="meta"):
        m = q.to("meta")
        ops.flash_attention(m, m, m)
    ops.reset_launches()
    ops.flash_attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == 0      # CPU: plain
