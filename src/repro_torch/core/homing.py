"""Homing policies — which home owns each element of a 1-D array.

  * LOCAL_CHUNKED    — element i lives on home i // (n/N) (the paper's
                       "local homing": worker w's chunk is contiguous).
  * HASH_INTERLEAVED — element i lives on home i mod N (the paper's
                       "hash-for-home" at its finest granularity).

On a `HomeMesh` every home is one row of an ``(N, n/N)`` tensor on one
device, so a placement is an index operation: chunked gives row d =
``x[d*c:(d+1)*c]``; interleaved gives row d = column d of
``x.reshape(n/N, N)`` (the reference's ``(n/N, N)`` stripe view with its
minor axis sharded).  The counterpart of `repro/core/homing.py`.
"""
from __future__ import annotations

import enum
import math
from typing import Tuple, Union

import torch

# A placement axis: one mesh axis name, or a tuple of names linearised
# row-major (the hierarchical case — e.g. ("pod", "data"): pod-major home
# order, so home d = pod * n_data + data_index owns logical chunk d).
Axis = Union[str, Tuple[str, ...]]


class Homing(enum.Enum):
    LOCAL_CHUNKED = "local"
    HASH_INTERLEAVED = "hash"


def axis_tuple(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh, axis: Axis) -> int:
    """#homes along `axis` — the product over a tuple of mesh axes."""
    return math.prod(mesh.shape[a] for a in axis_tuple(axis))


def check_divisible(n: int, N: int, homing: Homing, axis: str) -> None:
    """Raise a clear error when n elements can't split over N homes."""
    if n % N != 0:
        raise ValueError(
            f"cannot home {n} elements as {homing.value!r} over the {N} "
            f"devices of mesh axis {axis!r}: {n} % {N} != 0 — pad with "
            f"pad_to_multiple(x, {N}) (sentinels sort to the tail) or pass "
            f"pad=True to Locale.put")


def to_layout(x: torch.Tensor, mesh, homing: Homing,
              axis: Axis = "data") -> torch.Tensor:
    """Place a 1-D tensor under `homing`: the ``(N, n/N)`` per-home rows,
    contiguous, on the mesh's device."""
    n = x.shape[0]
    N = axis_size(mesh, axis)
    check_divisible(n, N, homing, str(axis))
    x = x.to(mesh.device)
    if homing == Homing.LOCAL_CHUNKED:
        return x.reshape(N, n // N).contiguous()
    return x.reshape(n // N, N).t().contiguous()


def logical_view(rows: torch.Tensor, homing: Homing) -> torch.Tensor:
    """Recover the logical 1-D order from the per-home rows."""
    if homing == Homing.LOCAL_CHUNKED:
        return rows.reshape(-1)
    return rows.t().reshape(-1)
