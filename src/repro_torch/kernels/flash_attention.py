"""`flash_attention`: blocked online-softmax attention.

The counterpart of `repro/kernels/flash_attention.py`: q ``(B, H, Sq, hd)``
and k, v ``(B, KV, Skv, hd)`` give ``(B, H, Sq, hd)`` in q's dtype, with
causal masking, a sliding window (tiles that the mask empties are
skipped), grouped-query heads (head h reads KV head ``h // (H // KV)``)
and lengths that need not be block multiples.  On a CUDA tensor this
launches the kernel of ``csrc/flash_attention.cu``; on a CPU tensor it
runs the plain version, `flash_attention_reference`, which keeps the
reference kernel's tile schedule.  `attention_ref` is the dense oracle.

What the reference kernel fixes and both versions keep:

- scores are float32 products of float32-cast inputs, times `scale`
  (default ``hd ** -0.5``) after the product;
- a masked score is the finite ``NEG_INF = -1e30``, not ``-inf``: a row
  whose first live tile is all masked gets ``p = exp(0) = 1`` there, and
  its first real score wipes that with ``corr = exp(-1e30 - m) = 0``
  (with ``-inf``, ``-inf - -inf`` would be NaN);
- a tile is live unless causal masking (``first_k > last_q``) or the
  window (``last_k <= first_q - window``) empties it; skipping gives what
  the dense mask gives;
- ``l`` is clamped at ``1e-20`` before the division.

A query row with no unmasked key at all (possible only when a window
ends before the first key, or for the padding rows past Sq) averages the
masked entries of its live tiles, as the reference does; that value
depends on the tile sides, which the kernel rounds up (`kernel_tiles`).
Every other row's masked entries are wiped by its first real score.

Two kernels: float32 runs ``fa_kernel`` on the fp32 pipe, register-blocked
(each lane a 4 x 8 micro-tile of the scores and 4 rows of the output, a
two-stage cp.async K/V ring, 64-key tiles); bfloat16 and float16 run
``fa_wgmma``, one template over the 16-bit type, both products on the
tensor cores (wgmma) with the q tile and a 3-stage K/V ring brought by
TMA, P V taken as two products of a hi + lo split of P (one rounding of
P to bfloat16 or float16 misses `KERNEL_TOL`).  Their tile sides and
shared memory differ (`kernel_tiles`, `smem_bytes`); both need 16-byte
aligned q, k, v (cp.async and TMA).

`plan` states the kernel's one launch: a (q tiles, H, B) grid -- the
reference's KV grid axis is a loop inside the block here -- with the KV
tiles each block reads (its live ones), and the block's shared memory
(`smem_bytes`); `c_plan` reads the same launch from the C entry's
dry-run twin on the card.  Both kernels take their q tile from the
block's linear index, last tile first (`block_tiles`).

Neither kernel has a backward pass, and neither has the reference's (JAX
refuses to differentiate its `pallas_call`): under autograd, with any of
q, k, v requiring grad, the wrapper raises on both devices
(`needs_grad`), so that a CPU run cannot pass where the card would drop
the attention's share of every gradient.  Training runs the plain
chunked attention (`models.LM(cfg, flash=False)`), as the reference's
trains on its ``lax.scan`` form.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.launches import (LaunchFacts, OperandFacts,
                                          dtype_name, note, stack_tiles)
from repro_torch.kernels import SMEM_BYTES_PER_BLOCK, _build, _device

NEG_INF = -1e30

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: each dtype's code in the C entry
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: head dims the kernel is built for, and its largest tile sides
HEAD_DIMS = (16, 32, 64, 128)
MAX_BLOCK = 128

#: the kernel each dtype launches
KERNELS = {"float32": "fa_kernel", "bfloat16": "fa_wgmma",
           "float16": "fa_wgmma"}
#: the dtypes ``fa_wgmma`` takes
WGMMA_DTYPES = ("bfloat16", "float16")
#: ``fa_wgmma``: query rows of a consumer warpgroup (wgmma's M), threads of
#: a warpgroup, K/V stages of its ring, alignment slack of its tiles
WG_ROWS, WG, STAGES, SMEM_ALIGN = 64, 128, 3, 1024
#: ``fa_kernel``: query rows of a warp, keys of a KV tile
F32_WARP_ROWS, F32_BK = 16, 64

#: (rtol, atol) of the kernel against its plain version.  Its float32 sums
#: run in another order, so float32 agrees to 2e-5.  A bfloat16 output may
#: round the other way: one bfloat16 step, at most 2**-7 of its value; the
#: 1e-5 covers the float32 sums of outputs near zero.  At long rows the
#: outputs are about 0.02, so an absolute 2e-2 would pass a wrong kernel.
#: A float16 output likewise: one float16 step, at most 2**-10 of its
#: value, and the same 1e-5.
KERNEL_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5),
              torch.float16: (2.0 ** -10, 1e-5)}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.repro_flash_attention_plan.restype = ctypes.c_int
    lib.repro_flash_attention_plan.argtypes = (
        [ctypes.c_int] * 11 + [ctypes.POINTER(_build.Launch), ctypes.c_int])
    return lib


def needs_grad(*tensors) -> bool:
    """Whether autograd would differentiate through `tensors`: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check(q, k, v, window: int):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, hd) and k, v "
                         f"(B, KV, Skv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}:"
                         f" same B and hd, and KV dividing H")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float16, float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def tiles(Sq: int, Skv: int, block_q: int, block_k: int):
    """The reference's tile sides and counts: ``(bq, bk, nq, nk)``."""
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    return bq, bk, -(-Sq // bq), -(-Skv // bk)


def live_tiles(Sq: int, Skv: int, *, causal: bool, window: int,
               block_q: int, block_k: int) -> torch.Tensor:
    """The ``(nq, nk)`` bool map of the tiles the schedule computes."""
    bq, bk, nq, nk = tiles(Sq, Skv, block_q, block_k)
    first_q = torch.arange(nq)[:, None] * bq
    first_k = torch.arange(nk)[None, :] * bk
    live = torch.ones(nq, nk, dtype=torch.bool)
    if causal:
        live &= first_k <= first_q + bq - 1
    if window:
        live &= first_k + bk - 1 > first_q - window
    return live


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: int = 0, block_q: int = 128,
                              block_k: int = 128,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: the reference kernel's tile schedule, vectorised
    over (B, H, q-tiles), with a loop over the KV tiles in place of the
    TPU's sequential grid axis.  A q-tile takes a KV tile's update only
    where that tile is live, which is the reference's skipping."""
    _check(q, k, v, window)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    bq, bk, nq, nk = tiles(Sq, Skv, block_q, block_k)
    dev = q.device
    qf = torch.zeros(B, H, nq * bq, hd, dtype=torch.float32, device=dev)
    qf[:, :, :Sq] = q.float()
    qf = qf.view(B, H, nq, bq, hd)
    kf = torch.zeros(B, KV, nk * bk, hd, dtype=torch.float32, device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :, :Skv] = k.float()
    vf[:, :, :Skv] = v.float()
    kf = kf.repeat_interleave(G, dim=1)            # head h reads h // G
    vf = vf.repeat_interleave(G, dim=1)
    qpos = torch.arange(nq * bq, device=dev).view(nq, bq, 1)
    live = live_tiles(Sq, Skv, causal=causal, window=window,
                      block_q=block_q, block_k=block_k).to(dev)
    m = torch.full((B, H, nq, bq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, nq, bq, hd, dtype=torch.float32, device=dev)
    for j in range(nk):
        on = live[:, j]
        if not bool(on.any()):
            continue
        kj = kf[:, :, j * bk:(j + 1) * bk]               # (B, H, bk, hd)
        vj = vf[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bhqid,bhkd->bhqik", qf, kj) * scale
        kpos = j * bk + torch.arange(bk, device=dev).view(1, 1, bk)
        mask = (qpos < Sq) & (kpos < Skv)
        if causal:
            mask = mask & (kpos <= qpos)
        if window:
            mask = mask & ((qpos - kpos) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhqik,bhkd->bhqid",
                                                       p, vj)
        on = on.view(1, 1, nq, 1)
        m = torch.where(on, m_new, m)
        l = torch.where(on, l_new, l)
        acc = torch.where(on[..., None], acc_new, acc)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.view(B, H, nq * bq, hd)[:, :, :Sq].to(q.dtype)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention, the second oracle (`repro/kernels/ref.py`)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    kr = k.float().repeat_interleave(G, dim=1)
    vr = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def kernel_tiles(Sq: int, Skv: int, block_q: int, block_k: int,
                 dtype: str = "float32"):
    """The kernel's tile sides: float32 the reference's q side rounded up
    to whole 16-row warp slices and ``F32_BK`` keys (its one KV tile);
    bfloat16 and float16 the reference's rounded up to whole 64-row wgmma
    tiles (q) and 64-key tiles (k)."""
    bq, bk, _, _ = tiles(Sq, Skv, block_q, block_k)
    if dtype in WGMMA_DTYPES:
        return -(-bq // WG_ROWS) * WG_ROWS, -(-bk // 64) * 64
    return -(-bq // F32_WARP_ROWS) * F32_WARP_ROWS, F32_BK


def smem_bytes(bq: int, bk: int, hd: int, dtype: str = "float32") -> int:
    """Dynamic shared memory of one block.  float32: the q tile, two K+V
    stages and a 16 x bk slice of P a warp, unpadded (the tiles are
    XOR-swizzled).  bfloat16 and float16: alignment slack, the q tile,
    `STAGES` K+V stages and the mbarriers (q, then full K, full V and
    empty per stage)."""
    if dtype in WGMMA_DTYPES:
        return (SMEM_ALIGN + bq * hd * 2 + STAGES * 2 * bk * hd * 2
                + 8 * (1 + 3 * STAGES))
    return ((bq + 4 * bk) * hd + bq * bk) * 4


def threads(bq: int, dtype: str = "float32") -> int:
    """Threads of one block: a warp per 16 rows (float32); a consumer
    warpgroup per 64 rows and one producer warpgroup (bfloat16, float16)."""
    if dtype in WGMMA_DTYPES:
        return (bq // WG_ROWS + 1) * WG
    return (bq // F32_WARP_ROWS) * 32


def block_tiles(nq: int, H: int, B: int, bx, by, bz):
    """``(iq, h, b)`` of a block of either kernel: the linear block index
    ``bx + nq (by + H bz)`` read with the q tile slowest-varying, last
    tile first, so the heaviest causal tiles of every head start first."""
    lin = bx + nq * (by + H * bz)
    rest = lin % (H * B)
    return nq - 1 - lin // (H * B), rest % H, rest // H


def plan(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int,
         block_q: int, block_k: int, causal: bool, window: int,
         dtype: str, scale: Optional[float] = None) -> List[LaunchFacts]:
    """The launch `repro_flash_attention` makes (no check of the kernel's
    limits on hd and the blocks: R3 reads this plan for any tile sides).
    The launch does not depend on `scale`; a call that gives one keeps it
    in its ``call``, so that the probe repeats it.

    The block that takes (iq, h, b) (`block_tiles`) reads q tile iq of
    head h, the live KV tiles of KV head h // (H / KV) -- those that
    neither the causal mask nor the window empties for its rows, as the
    kernel's loop skips them -- and writes out tile iq of head h.
    """
    if B * H * Sq == 0 or Skv == 0:
        return []
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k, dtype)
    nq, nk = -(-Sq // bq), -(-Skv // bk)
    first_q = np.arange(nq)[:, None] * bq
    first_k = np.arange(nk)[None, :] * bk
    live = np.ones((nq, nk), dtype=bool)
    if causal:
        live &= first_k <= first_q + bq - 1
    if window:
        live &= first_k + bk - 1 > first_q - window
    G = H // KV

    def q_tile(bx, by, bz):
        iq, h, b = block_tiles(nq, H, B, bx, by, bz)
        return stack_tiles(iq, b, h, iq, 0)

    def kv_tiles(bx, by, bz):
        iq, h, b = block_tiles(nq, H, B, bx, by, bz)
        blk, ik = np.nonzero(live[iq])
        return blk, stack_tiles(blk, b[blk], h[blk] // G, ik, 0)

    kv = functools.partial(OperandFacts, "in", array_shape=(B, KV, Skv, hd),
                           dtype=dtype, tile_shape=(1, 1, bk, hd),
                           tile_map=kv_tiles)
    return [LaunchFacts(
        KERNELS[dtype], (nq, H, B), threads(bq, dtype), 0,
        smem_bytes(bq, bk, hd, dtype), "int32",
        inputs=(OperandFacts("in", "q", (B, H, Sq, hd), dtype, (1, 1, bq, hd),
                             q_tile), kv(buffer="k"), kv(buffer="v")),
        outputs=(OperandFacts("out", "out", (B, H, Sq, hd), dtype,
                              (1, 1, bq, hd), q_tile),),
        call=(__name__, (B, H, KV, Sq, Skv, hd, block_q, block_k, causal,
                         window, dtype) + (() if scale is None else (scale,))))]


def work(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int,
         block_q: int, block_k: int, causal: bool, window: int, dtype: str,
         scale: Optional[float] = None) -> Dict[str, int]:
    """What one call must do, whatever its tiles and scale (it takes
    `plan`'s arguments, so a recorded call's is ``work(*call[1])``):
    ``flops``, 4 hd for each unmasked (query, key) pair (q k and p v, a
    multiply and an add each), and ``bytes``, q, k, v read once and out
    written once.  Query i sees keys ``j < Skv`` with ``j <= i`` (causal)
    and ``j > i - window`` (window).  The one count behind
    `chip_smoke.py`'s bound and the dry run's (`launch.step_cost`)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    item = getattr(torch, dtype).itemsize
    return {"flops": 4 * hd * pairs * B * H,
            "bytes": (2 * B * H * Sq + 2 * B * KV * Skv) * hd * item}


def c_plan(B, H, KV, Sq, Skv, hd, block_q, block_k, causal, window, dtype,
           scale=None):
    """`plan`'s launch as the C entry's dry-run twin gives it (card)."""
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k, dtype)
    return _build.c_plan(_lib(), "flash_attention", B, H, KV, Sq, Skv, hd, bq,
                         bk, int(causal), int(window),
                         DTYPE_CODES[getattr(torch, dtype)])


def _launch(q, k, v, out, causal: bool, window: int, block_q: int,
            block_k: int, p_split: bool = True,
            scale: Optional[float] = None) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded), scores
    scaled by `scale` (default ``hd ** -0.5``).  ``p_split=False`` makes
    ``fa_wgmma`` round P once to the 16-bit type (outside `KERNEL_TOL`;
    only a measurement of what the split costs uses it); ``fa_kernel``
    ignores it."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k, dtype_name(q.dtype))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Skv, hd, bq, bk, int(causal), int(window),
            DTYPE_CODES[q.dtype], hd ** -0.5 if scale is None else scale,
            int(p_split), stream)
    _build.check(rc, lib, "repro_flash_attention_error", "flash_attention")


def probe(B, H, KV, Sq, Skv, hd, block_q, block_k, causal, window, dtype,
          scale=None, device="cuda") -> Dict[str, torch.Tensor]:
    """One launch on normal inputs (finite outputs) into an output filled
    with `analysis.probe.poisoned`; returns the output."""
    from repro_torch.analysis.probe import poisoned
    gen = torch.Generator(device=device).manual_seed(B * H * Sq + Skv)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, Sq, hd, generator=gen, device=device).to(dt)
    k, v = (torch.randn(B, KV, Skv, hd, generator=gen, device=device).to(dt)
            for _ in range(2))
    out = poisoned((B, H, Sq, hd), dt, device)
    _launch(q, k, v, out, causal, window, block_q, block_k, scale=scale)
    return {"out": out}


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, Skv, hd) -> (B, H, Sq, hd), the
    scores scaled by `scale` (default ``hd ** -0.5``).

    Raises under autograd (`needs_grad`): there is no backward pass.
    CPU tensors: `flash_attention_reference`.  CUDA tensors: the kernel,
    counted in ``flash_attention.launches``; it takes contiguous inputs,
    hd in `HEAD_DIMS`, blocks up to `MAX_BLOCK` and q, k and v on 16-byte
    boundaries (the rule of cp.async's 16-byte copies and of TMA).  ``meta`` tensors (a dry run):
    the card's checks and its launch noted as on the card, then an empty
    result, uncounted; nothing is computed, so no value comes from it.
    """
    if needs_grad(q, k, v):
        raise RuntimeError(
            "flash_attention has no backward pass (nor has the reference "
            "kernel): call it under torch.no_grad(), or train on the plain "
            "chunked attention, models.LM(cfg, flash=False)")
    _check(q, k, v, window)
    note(lambda: plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                      k.shape[2], q.shape[3], block_q, block_k, causal,
                      window, dtype_name(q.dtype), scale))
    kind = "meta" if q.is_meta else _device(q, "flash_attention")
    if kind == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         block_q=block_q, block_k=block_k,
                                         scale=scale)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: the kernel takes contiguous q, k, v")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if not (1 <= block_q <= MAX_BLOCK and 1 <= block_k <= MAX_BLOCK):
        raise ValueError(f"flash_attention: the kernel takes blocks of 1 to "
                         f"{MAX_BLOCK}, got ({block_q}, {block_k})")
    dtype = dtype_name(q.dtype)
    if kind == "meta":                   # shapes and costs: nothing runs
        return torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernels load q, k, v by "
                         "cp.async or TMA, which need 16-byte aligned "
                         "tensors")
    out = torch.empty_like(q)
    if q.numel() == 0 or Skv == 0:
        return out.zero_()
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k, dtype)
    assert smem_bytes(bq, bk, hd, dtype) <= SMEM_BYTES_PER_BLOCK
    _launch(q, k, v, out, causal, window, block_q, block_k, scale=scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
