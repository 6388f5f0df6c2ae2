"""The port's plain flash attention against the JAX kernel.

The plain blocked version (`flash_attention_reference`, what
`ops.flash_attention` runs on a CPU tensor) against the reference's
`ops.flash_attention` in interpret mode, over the six `ATTN_CASES` of
`tests/test_kernels.py` (causal, GQA, ragged + MQA, sliding window,
cross with Sq != Skv), float32 and bfloat16, on the same seeded inputs;
float16 and a non-default `scale` likewise.  Tolerance: rtol = atol =
2e-5 for float32 and 2e-2 for bfloat16, the reference test's own: both
sides compute in float32, but their sums run in another order (and
bfloat16 outputs round at another place); float16 one float16 step
(rtol = 2^-10, atol = 1e-5), as its output is rounded once.  The dense
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
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.convert import make_attention_inputs
from repro_torch.kernels import flash_attention as tflash
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


#: float16 against the reference kernel: both compute in float32 and round
#: the output once to float16, their sums in another order, so the two
#: may round to neighbouring float16 values: one float16 step (2^-10 of
#: the value), and 1e-5 for the outputs near zero (`KERNEL_TOL`)
F16_TOL = tflash.KERNEL_TOL[torch.float16]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_plain_flash_attention_in_float16_matches_jax_kernel(case):
    causal, window, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = inputs(case, "float16")
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=bq, block_k=bk)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=bq, block_k=bk)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=F16_TOL[0],
                               atol=F16_TOL[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", ATTN_CASES[:4], ids=str)
def test_plain_flash_attention_takes_a_scale_like_jax_kernel(case, dtype):
    """A non-default scale, 0.1, through the wrapper and the reference
    kernel (tolerances as above); it must move the result off the
    default's."""
    causal, window, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = inputs(case, dtype, seed=4)
    want = jflash(jq, jk, jv, causal=causal, window=window, block_q=bq,
                  block_k=bk, scale=0.1, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=bq, block_k=bk, scale=0.1)
    rtol, atol = F16_TOL if dtype == "float16" else (TOL[dtype], TOL[dtype])
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=rtol,
                               atol=atol)
    default = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=bq, block_k=bk)
    assert not np.allclose(as_f32(got), as_f32(default), rtol=rtol,
                           atol=atol)


def test_scale_is_kept_in_the_recorded_call():
    from repro_torch.analysis.launches import record
    q = torch.zeros(1, 2, 40, 16)
    with record() as launches:
        ops.flash_attention(q, q, q, block_q=32, block_k=32)
        ops.flash_attention(q, q, q, block_q=32, block_k=32, scale=0.1)
    assert [f.call[1][-1] for f in launches] == ["float32", 0.1]
    assert launches[0].launch_tuple() == launches[1].launch_tuple()
    assert tflash.KERNELS["float16"] == "fa_wgmma"


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
    # float32 (fa_kernel): the q tile, two K+V stages of 64 keys and a
    # 16 x 64 slice of P a warp
    assert kernel_tiles(4096, 4096, 128, 128) == (128, 64)
    assert smem_bytes(128, 64, 128) == (
        (128 + 4 * 64) * 128 * 4 + 128 * 64 * 4) == 229_376
    assert smem_bytes(128, 64, 128) <= SMEM_BYTES_PER_BLOCK
    assert smem_bytes(128, 64, 128) > 48 * 1024
    # bfloat16 (fa_wgmma): 1 KiB of alignment slack, the q tile, three
    # K+V stages and ten mbarriers
    assert smem_bytes(128, 128, 128, "bfloat16") == (
        1024 + 128 * 128 * 2 + 3 * 2 * 128 * 128 * 2 + 80) == 230_480
    assert smem_bytes(128, 128, 128, "bfloat16") <= SMEM_BYTES_PER_BLOCK
    assert smem_bytes(128, 256, 128, "bfloat16") > SMEM_BYTES_PER_BLOCK


@pytest.mark.parametrize("shape,want", [
    ((96, 96, 64, 64), (64, 64)),
    ((100, 50, 128, 128), (128, 64)),       # ragged Sq and Skv
    ((32, 32, 32, 32), (64, 64)),           # bq = 32 -> one wgmma tile
    ((20, 300, 128, 128), (64, 128)),       # Sq < 64
    ((200, 200, 128, 128), (128, 128)),
    ((512, 512, 64, 16), (64, 64)),
])
def test_bf16_kernel_tiles_are_whole_wgmma_tiles(shape, want):
    """bfloat16 rounds bq up to 64-row warpgroup tiles and bk to 64 keys;
    float32 keeps its 16-row rounding of bq and takes 64-key tiles."""
    assert kernel_tiles(*shape, "bfloat16") == want
    bq, bk = kernel_tiles(*shape, "float32")
    assert bq % 16 == 0 and bk == 64


@pytest.mark.parametrize("case", [
    # (B, H, KV, Sq, Skv, hd, bq, bk, causal, window)
    (1, 4, 2, 200, 200, 32, 64, 64, True, 0),
    (2, 6, 2, 300, 300, 128, 128, 128, True, 100),
    (1, 2, 1, 77, 130, 64, 128, 128, False, 0),
    (1, 2, 2, 512, 512, 16, 64, 64, True, 64),
])
def test_bf16_plan_states_the_wgmma_launch(case):
    """The bfloat16 plan: kernel fa_wgmma, (q tiles, H, B) grid, a consumer
    warpgroup per 64 rows plus a producer, its shared memory; every
    (q tile, head, batch) taken by one block, the last q tile by the first
    blocks; each block reads exactly the live KV tiles of its q tile (of
    KV head h // G) and writes its q tile."""
    from repro_torch.analysis.launches import grid_blocks, operand_tiles
    from repro_torch.analysis.probe import image
    B, H, KV, Sq, Skv, hd, bq, bk, causal, window = case
    (fc,) = tflash.plan(B, H, KV, Sq, Skv, hd, bq, bk, causal, window,
                        "bfloat16")
    kq, kk = kernel_tiles(Sq, Skv, bq, bk, "bfloat16")
    nq, nk = -(-Sq // kq), -(-Skv // kk)
    assert fc.name == "fa_wgmma" and fc.grid == (nq, H, B)
    assert fc.threads == (kq // 64 + 1) * 128
    assert (fc.smem_static, fc.smem_dynamic) == (
        0, smem_bytes(kq, kk, hd, "bfloat16"))
    blocks = grid_blocks(fc.grid)
    _, qt = operand_tiles(fc.outputs[0], blocks)
    assert sorted(map(tuple, qt.tolist())) == sorted(
        (b, h, i, 0) for b in range(B) for h in range(H) for i in range(nq))
    assert {tuple(t) for t in qt[:H * B].tolist()} == {
        (b, h, nq - 1, 0) for b in range(B) for h in range(H)}
    live = live_tiles(Sq, Skv, causal=causal, window=window, block_q=kq,
                      block_k=kk).numpy()
    for op in fc.inputs[1:]:
        blk, kt = operand_tiles(op, blocks)
        got = {(int(i), tuple(t)) for i, t in zip(blk, kt.tolist())}
        want = {(i, (int(qt[i, 0]), int(qt[i, 1]) // (H // KV), j, 0))
                for i in range(len(qt)) for j in range(nk)
                if live[qt[i, 2], j]}
        assert got == want
    assert bool(image([fc], "out", B * H * Sq * hd).all())


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), q.double(), q.double())
    # meta (a dry run's shapes): the same checks as on the card, then an
    # empty result, uncounted
    m = q.to("meta")
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(m, torch.zeros(1, 3, 8, 16, device="meta"),
                            torch.zeros(1, 3, 8, 16, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        t = m.transpose(2, 3)
        ops.flash_attention(t, t, t)
    ops.reset_launches()
    out = ops.flash_attention(m, m, m)
    assert out.is_meta and out.shape == q.shape
    ops.flash_attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == 0      # CPU: plain


def _pv_rounded(q, k, v, split: bool,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Causal attention (one KV head) with fa_wgmma's rounding of P before
    P V: `dtype` once, or hi + lo `dtype`; float64 sums otherwise."""
    S, hd = q.shape[-2:]
    s = q[0].double() @ k[0, 0].double().T * hd ** -0.5
    i = torch.arange(S)
    s = s.masked_fill(i[None, None, :] > i[None, :, None], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)).float()
    hi = p.to(dtype).float()
    pp = hi + (p - hi).to(dtype).float() if split else hi
    out = (pp.double() @ v[0, 0].double()) / p.double().sum(-1, keepdim=True)
    return out.float().to(dtype)[None]


def test_one_bf16_rounding_of_p_misses_the_kernel_tolerance():
    """Why fa_wgmma splits P: rounded once to bfloat16 before P V, the
    outputs of long rows leave `KERNEL_TOL` (one bfloat16 step); split
    into hi + lo they stay inside it."""
    from repro_torch.kernels.flash_attention import KERNEL_TOL
    _, (q, k, v) = inputs((1, 2, 1, 1024, 1024, 128), "bfloat16", 0)
    plain = flash_attention_reference(q, k, v, causal=True).float()
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    outside = {split: int((~torch.isclose(_pv_rounded(q, k, v, split).float(),
                                          plain, rtol=rtol, atol=atol)).sum())
               for split in (False, True)}
    assert outside[True] == 0
    assert outside[False] > plain.numel() // 50, outside


def test_one_f16_rounding_of_p_misses_the_kernel_tolerance():
    """float16 on fa_wgmma keeps the split too: its 11-bit
    significand rounds P to 2**-11 of its value, and the outputs near zero
    of long rows then leave `KERNEL_TOL` (one float16 step and 1e-5)
    by the thousand; split into hi + lo none does."""
    from repro_torch.kernels.flash_attention import KERNEL_TOL
    _, (q, k, v) = inputs((1, 2, 1, 1024, 1024, 128), "float16", 0)
    plain = flash_attention_reference(q, k, v, causal=True).float()
    rtol, atol = KERNEL_TOL[torch.float16]
    outside = {split: int((~torch.isclose(
        _pv_rounded(q, k, v, split, torch.float16).float(), plain,
        rtol=rtol, atol=atol)).sum()) for split in (False, True)}
    assert outside[True] == 0
    assert outside[False] > plain.numel() // 100, outside


# ---------------------------------------------------------------------------
# the launch facts of the two kernels
# ---------------------------------------------------------------------------
#: (Sq, Skv, block_q, block_k): ragged, short, long and every tile side
TILE_SHAPES = [(Sq, Skv, bq, bk) for Sq, Skv in ((4096, 4096), (753, 753),
                                                  (100, 333), (20, 7))
               for bq in (1, 16, 40, 64, 100, 128)
               for bk in (1, 32, 64, 128)]


@pytest.mark.parametrize("hd", tflash.HEAD_DIMS)
def test_f16_launch_facts_equal_bf16s(hd):
    """float16 runs fa_wgmma as bfloat16 does: the same tile sides,
    threads, shared memory and launch (grid, tiles read and written) at
    every tile side; only the dtype of the operands differs."""
    for Sq, Skv, bq, bk in TILE_SHAPES:
        tiles16 = kernel_tiles(Sq, Skv, bq, bk, "float16")
        assert tiles16 == kernel_tiles(Sq, Skv, bq, bk, "bfloat16")
        kq, kk = tiles16
        assert tflash.threads(kq, "float16") == tflash.threads(kq, "bfloat16")
        assert smem_bytes(kq, kk, hd, "float16") == smem_bytes(kq, kk, hd,
                                                               "bfloat16")
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        args = (2, 4, 2, 300, 300, hd, 128, 64, causal, window)
        (f16,) = tflash.plan(*args, "float16")
        (bf16,) = tflash.plan(*args, "bfloat16")
        assert f16.name == "fa_wgmma"
        assert f16.launch_tuple() == bf16.launch_tuple()
        for a, b in zip(f16.inputs + f16.outputs, bf16.inputs + bf16.outputs):
            assert a.dtype == "float16" and b.dtype == "bfloat16"
            assert (a.array_shape, a.tile_shape) == (b.array_shape,
                                                     b.tile_shape)
            blocks = np.arange(int(np.prod(f16.grid)))
            bx, rest = blocks % f16.grid[0], blocks // f16.grid[0]
            coords = (bx, rest % f16.grid[1], rest // f16.grid[1])
            ta, tb = a.tile_map(*coords), b.tile_map(*coords)
            for x, y in zip(ta if isinstance(ta, tuple) else (ta,),
                            tb if isinstance(tb, tuple) else (tb,)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("hd", tflash.HEAD_DIMS)
def test_f32_smem_fits_every_accepted_tile(hd):
    """Every (block_q, block_k) the wrapper accepts (1 to `MAX_BLOCK`)
    gives fa_kernel tiles whose shared memory fits one block, its warps
    whole 16-row slices, its KV tile 64 keys."""
    from repro_torch.kernels import SMEM_BYTES_PER_BLOCK
    worst = 0
    for bq in range(1, tflash.MAX_BLOCK + 1):
        for bk in range(1, tflash.MAX_BLOCK + 1):
            kq, kk = kernel_tiles(4096, 4096, bq, bk, "float32")
            assert kq % 16 == 0 and 16 <= kq <= 128 and kk == 64
            assert tflash.threads(kq) == kq // 16 * 32 <= 256
            worst = max(worst, smem_bytes(kq, kk, hd))
    assert worst == smem_bytes(128, 64, hd) <= SMEM_BYTES_PER_BLOCK


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("case", [
    # (B, H, KV, Sq, Skv, hd, bq, bk, causal, window)
    (1, 16, 8, 4096, 4096, 128, 128, 128, True, 0),    # qwen3-0.6b
    (16, 16, 8, 753, 753, 128, 128, 128, True, 0),     # the serve prefill
    (1, 32, 8, 8192, 8192, 128, 128, 128, True, 4096),  # mixtral's window
    (2, 64, 8, 512, 4096, 128, 128, 128, False, 0),    # vision cross
    (1, 4, 2, 200, 77, 16, 40, 32, True, 48),
], ids=str)
def test_flash_plans_are_clean(case, dtype):
    """R3 (shared memory), R5 (every output tile written by one block,
    every input tile inside its array) and R8 (no dead lane) find nothing
    in the plans of the new launches, at the main path's shapes; the image
    of the plan covers the output."""
    from repro_torch.analysis import check_artifacts
    from repro_torch.analysis.probe import image
    B, H, KV, Sq, Skv, hd = case[:6]
    facts = tflash.plan(*case, dtype)
    assert [f.name for f in facts] == [tflash.KERNELS[dtype]]
    rep = check_artifacts("flash_attention", facts,
                          rules=("R3", "R5", "R8"))
    assert rep.clean and not rep.notes, rep.format()
    assert bool(image(facts, "out", B * H * Sq * hd).all())
