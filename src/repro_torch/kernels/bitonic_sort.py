"""The bitonic network, as plain PyTorch — the plain version of `local_sort`.

The counterpart of `repro/kernels/bitonic_sort.py`.  `bitonic_stages` is
the network itself (stage k sorts every aligned k-block, alternating
direction by bit k of the index, so stage 2k sees bitonic input; partners
are index ^ j).  It compares an int32 total-order key, not the values:
integers widened to int32, floats widened exactly to float32 and taken as
their bits ``k ^ ((k >> 31) & 0x7fffffff)``.  That orders ``-0.0`` before
``+0.0``, as XLA's min/max do in the reference network (``torch.minimum``
and ``torch.sort`` treat the two zeros as ties).

`bitonic_sort` is the wrapper over the `local_sort` kernel's device code
for rows whose length is a power of two: a row of up to TILE = 16384 keys
is one block's network, its keys in registers and warp shuffles (the
(8, 16384) rows of the reference's benchmark take one launch of 8
blocks); a longer row is sorted in 16384-key tiles and merged.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _device

#: the dtypes the sort kernels take: those the reference's
#: ``workload("sort")`` sorts
KEY_DTYPES = (torch.int8, torch.int16, torch.int32, torch.uint8,
              torch.uint16, torch.uint32, torch.float16, torch.bfloat16,
              torch.float32)
KEY_DTYPE_NAMES = ("int8, int16, int32, uint8, uint16, uint32, float16, "
                   "bfloat16 or float32")
#: each dtype's code in the sort kernels' C entries (``csrc/merge_path.cuh``)
DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.int16: 2,
               torch.int8: 3, torch.uint8: 4, torch.float16: 5,
               torch.bfloat16: 6, torch.uint16: 7, torch.uint32: 8}

INT32_MIN = torch.iinfo(torch.int32).min


def check_key_dtype(dtype: torch.dtype, what: str) -> None:
    """Raise TypeError unless `dtype` is one of `KEY_DTYPES`."""
    if dtype not in KEY_DTYPES:
        raise TypeError(f"{what} sorts {KEY_DTYPE_NAMES}, got {dtype}")


def widen(x: torch.Tensor) -> torch.Tensor:
    """`x` in a dtype that torch compares, searches and gathers on the CPU,
    exactly: uint16 as int32, uint32 as int64 (torch implements neither
    comparisons nor ``searchsorted`` for the two); any other dtype as is.
    Narrow back with ``.to(x.dtype)``."""
    if x.dtype == torch.uint16:
        return x.to(torch.int32)
    if x.dtype == torch.uint32:
        return x.to(torch.int64)
    return x


def to_key(x: torch.Tensor) -> torch.Tensor:
    """int32 total-order key of a tensor of a `KEY_DTYPES` dtype: integers
    widened, uint32 its bits with the top bit flipped (an order-preserving
    bijection onto int32), floats their float32 bits with the sign-magnitude
    map."""
    check_key_dtype(x.dtype, "sort keys")
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.uint32:
        return x.view(torch.int32) ^ INT32_MIN
    if not x.dtype.is_floating_point:
        return x.to(torch.int32)
    k = x.to(torch.float32).view(torch.int32)
    return k ^ ((k >> 31) & 0x7fffffff)


def from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `to_key` (the float and uint32 maps are involutions, and
    a narrow dtype's values survive the widening exactly)."""
    if dtype == torch.int32:
        return k
    if dtype == torch.uint32:
        return (k ^ INT32_MIN).view(torch.uint32)
    if not dtype.is_floating_point:
        return k.to(dtype)
    return (k ^ ((k >> 31) & 0x7fffffff)).view(torch.float32).to(dtype)


def _network(k: torch.Tensor) -> torch.Tensor:
    """Sort each row of int32 keys (R, L), L a power of two, into a copy.

    Stage (s, j) compares the pairs j apart inside blocks of 2j; the
    blocks of a run of s keys go ascending, those of the next run
    descending (one run at the last stage).  Each side is done in place:
    its low half takes the min and its high half the max (reversed when
    descending)."""
    R, L = k.shape
    k = k.clone()
    s = 2
    while s <= L:
        runs, sides = (L // (2 * s), 2) if s < L else (1, 1)
        j = s // 2
        while j >= 1:
            v = k.view(R, runs, sides, L // (runs * sides * 2 * j), 2, j)
            for side in range(sides):
                a, b = v[:, :, side, :, 0], v[:, :, side, :, 1]
                first, second = ((torch.minimum, torch.maximum) if side == 0
                                 else (torch.maximum, torch.minimum))
                t = first(a, b)
                second(a, b, out=b)
                a.copy_(t)
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
