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

- scores are float32 products of float32-cast inputs, times
  ``hd ** -0.5`` after the product;
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

`plan` states the kernel's one launch: a (q tiles, H, B) grid -- the
reference's KV grid axis is a loop inside the block here -- with the KV
tiles each block reads (its live ones), and the block's shared memory
(`smem_bytes`); `c_plan` reads the same launch from the C entry's
dry-run twin on the card.
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

DTYPES = (torch.float32, torch.bfloat16)

#: head dims the kernel is built for, and its largest tile sides
HEAD_DIMS = (16, 32, 64, 128)
MAX_BLOCK = 128

#: (rtol, atol) of the kernel against its plain version.  Its float32 sums
#: run in another order, so float32 agrees to 2e-5.  A bfloat16 output may
#: round the other way: one bfloat16 step, at most 2**-7 of its value; the
#: 1e-5 covers the float32 sums of outputs near zero.  At long rows the
#: outputs are about 0.02, so an absolute 2e-2 would pass a wrong kernel.
KERNEL_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.repro_flash_attention_plan.restype = ctypes.c_int
    lib.repro_flash_attention_plan.argtypes = (
        [ctypes.c_int] * 11 + [ctypes.POINTER(_build.Launch), ctypes.c_int])
    return lib


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
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
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


def kernel_tiles(Sq: int, Skv: int, block_q: int, block_k: int):
    """The kernel's tile sides: the reference's, rounded up to a whole
    number of 16-row warp slices (q) and 32-key lane slices (k)."""
    bq, bk, _, _ = tiles(Sq, Skv, block_q, block_k)
    return -(-bq // 16) * 16, -(-bk // 32) * 32


def smem_bytes(bq: int, bk: int, hd: int) -> int:
    """Dynamic shared memory of one block: the q tile and one K and one V
    tile in float32, rows padded by one word against bank conflicts."""
    return (bq + 2 * bk) * (hd + 1) * 4


def plan(B: int, H: int, KV: int, Sq: int, Skv: int, hd: int,
         block_q: int, block_k: int, causal: bool, window: int,
         dtype: str) -> List[LaunchFacts]:
    """The launch `repro_flash_attention` makes (no check of the kernel's
    limits on hd and the blocks: R3 reads this plan for any tile sides).

    Block (iq, h, b) reads q tile iq of head h, the live KV tiles of KV
    head h // (H / KV) -- those that neither the causal mask nor the
    window empties for its rows, as the kernel's loop skips them -- and
    writes out tile iq of head h.
    """
    if B * H * Sq == 0 or Skv == 0:
        return []
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k)
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
        return stack_tiles(bx, bz, by, bx, 0)

    def kv_tiles(bx, by, bz):
        blk, ik = np.nonzero(live[bx])
        return blk, stack_tiles(blk, bz[blk], by[blk] // G, ik, 0)

    kv = functools.partial(OperandFacts, "in", array_shape=(B, KV, Skv, hd),
                           dtype=dtype, tile_shape=(1, 1, bk, hd),
                           tile_map=kv_tiles)
    return [LaunchFacts(
        "fa_kernel", (nq, H, B), (bq // 16) * 32, 0, smem_bytes(bq, bk, hd),
        "int32",
        inputs=(OperandFacts("in", "q", (B, H, Sq, hd), dtype, (1, 1, bq, hd),
                             q_tile), kv(buffer="k"), kv(buffer="v")),
        outputs=(OperandFacts("out", "out", (B, H, Sq, hd), dtype,
                              (1, 1, bq, hd), q_tile),),
        call=(__name__, (B, H, KV, Sq, Skv, hd, block_q, block_k, causal,
                         window, dtype)))]


def c_plan(B, H, KV, Sq, Skv, hd, block_q, block_k, causal, window, dtype):
    """`plan`'s launch as the C entry's dry-run twin gives it (card)."""
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k)
    return _build.c_plan(_lib(), "flash_attention", B, H, KV, Sq, Skv, hd, bq,
                         bk, int(causal), int(window),
                         int(dtype == "bfloat16"))


def _launch(q, k, v, out, causal: bool, window: int, block_q: int,
            block_k: int) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Skv, hd, bq, bk, int(causal), int(window),
            int(q.dtype == torch.bfloat16), hd ** -0.5, stream)
    _build.check(rc, lib, "repro_flash_attention_error", "flash_attention")


def probe(B, H, KV, Sq, Skv, hd, block_q, block_k, causal, window, dtype,
          device="cuda") -> Dict[str, torch.Tensor]:
    """One launch on normal inputs (finite outputs) into an output filled
    with `analysis.probe.poisoned`; returns the output."""
    from repro_torch.analysis.probe import poisoned
    gen = torch.Generator().manual_seed(B * H * Sq + Skv)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, Sq, hd, generator=gen).to(dt).to(device)
    k, v = (torch.randn(B, KV, Skv, hd, generator=gen).to(dt).to(device)
            for _ in range(2))
    out = poisoned((B, H, Sq, hd), dt, device)
    _launch(q, k, v, out, causal, window, block_q, block_k)
    return {"out": out}


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, Skv, hd) -> (B, H, Sq, hd).

    CPU tensors: `flash_attention_reference`.  CUDA tensors: the kernel,
    counted in ``flash_attention.launches``; it takes contiguous inputs,
    hd in `HEAD_DIMS` and blocks up to `MAX_BLOCK`.
    """
    _check(q, k, v, window)
    note(lambda: plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                      k.shape[2], q.shape[3], block_q, block_k, causal,
                      window, dtype_name(q.dtype)))
    if _device(q, "flash_attention") == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         block_q=block_q, block_k=block_k)
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
    out = torch.empty_like(q)
    if q.numel() == 0 or Skv == 0:
        return out.zero_()
    bq, bk = kernel_tiles(Sq, Skv, block_q, block_k)
    assert smem_bytes(bq, bk, hd) <= SMEM_BYTES_PER_BLOCK
    _launch(q, k, v, out, causal, window, block_q, block_k)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
