"""The bitonic network, as plain PyTorch — the plain version of `local_sort`.

The counterpart of `repro/kernels/bitonic_sort.py`.  `bitonic_stages` is
the network itself (stage k sorts every aligned k-block, alternating
direction by bit k of the index, so stage 2k sees bitonic input; partners
are index ^ j).  It compares a total-order key, not the values: int32 as
is, float32 as its bits ``k ^ ((k >> 31) & 0x7fffffff)``.  That orders
``-0.0`` before ``+0.0``, as XLA's min/max do in the reference network
(``torch.minimum`` and ``torch.sort`` treat the two zeros as ties).

`bitonic_sort` is the wrapper over the `local_sort` kernel's device code
for rows whose length is a power of two: a row of up to TILE = 16384 keys
is one block's network, its keys in registers and warp shuffles (the
(8, 16384) rows of the reference's benchmark take one launch of 8
blocks); a longer row is sorted in 16384-key tiles and merged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _device

KEY_DTYPES = (torch.int32, torch.float32)


def to_key(x: torch.Tensor) -> torch.Tensor:
    """int32 total-order key of an int32 or float32 tensor."""
    if x.dtype == torch.int32:
        return x
    if x.dtype != torch.float32:
        raise TypeError(f"sort keys are int32 or float32, got {x.dtype}")
    k = x.view(torch.int32)
    return k ^ ((k >> 31) & 0x7fffffff)


def from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `to_key` (the float map is an involution)."""
    if dtype == torch.int32:
        return k
    return (k ^ ((k >> 31) & 0x7fffffff)).view(dtype)


def _network(k: torch.Tensor) -> torch.Tensor:
    """Sort each row of int32 keys (R, L), L a power of two."""
    R, L = k.shape
    s = 2
    while s <= L:
        j = s // 2
        while j >= 1:
            pairs = k.view(R, L // (2 * j), 2, j)
            lo = torch.minimum(pairs[:, :, 0], pairs[:, :, 1])
            hi = torch.maximum(pairs[:, :, 0], pairs[:, :, 1])
            start = torch.arange(L // (2 * j), device=k.device) * (2 * j)
            desc = ((start & s) != 0).view(1, -1, 1)
            k = torch.stack([torch.where(desc, hi, lo),
                             torch.where(desc, lo, hi)], dim=2).view(R, L)
            j //= 2
        s *= 2
    return k


def bitonic_stages(v: torch.Tensor) -> torch.Tensor:
    """Sort each row of v: (R, L) ascending, L a power of two."""
    R, L = v.shape
    if L & (L - 1):
        raise ValueError(f"bitonic length {L} not a power of 2")
    return from_key(_network(to_key(v).contiguous()), v.dtype)


def bitonic_sort(x: torch.Tensor) -> torch.Tensor:
    """Row-wise sort of (chunks, L), L a power of two.

    CPU: `bitonic_stages`.  CUDA: the `local_sort` kernel's device code
    (`csrc/local_sort.cu`: one block per row up to 16384 keys, tile and
    merge passes above), counted in ``bitonic_sort.launches``; its
    launches are `local_sort.plan`'s.
    """
    if x.dim() != 2 or x.shape[1] & (x.shape[1] - 1) or x.shape[1] == 0:
        raise ValueError(f"bitonic_sort takes (chunks, L) with L a power of "
                         f"2, got shape {tuple(x.shape)}")
    from repro_torch.analysis.launches import dtype_name, note
    from repro_torch.kernels.local_sort import launch_local_sort, plan
    note(lambda: plan(x.shape[0], x.shape[1], dtype_name(x.dtype)))
    if _device(x, "bitonic_sort") == "cpu":
        return bitonic_stages(x)
    out = launch_local_sort(x)
    bitonic_sort.launches += 1
    return out


bitonic_sort.launches = 0
