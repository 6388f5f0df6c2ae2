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

The reference's in-jit sharding constraint (`constrain`) becomes a
*relayout* here: a real copy into the rows of the target `Layout`, counted
by the bytes of the elements whose home changes (`relayout_counts`).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

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


def rank_shard(x: torch.Tensor, mesh, homing: Homing,
               axis: Axis = "data") -> torch.Tensor:
    """This rank's shard of a 1-D tensor on a `RankMesh`, as a fresh
    ``(1, n/N)`` row on its device: row d of what `to_layout` gives on a
    `HomeMesh` of the same shape (chunk d, or column d of the ``(n/N, N)``
    view), d the rank's home on `axis`."""
    n = x.shape[0]
    N = axis_size(mesh, axis)
    check_divisible(n, N, homing, str(axis))
    d = mesh.index(axis_tuple(axis))
    if homing == Homing.LOCAL_CHUNKED:
        row = x[d * (n // N):(d + 1) * (n // N)]
    else:
        row = x.view(n // N, N)[:, d]
    return row.to(mesh.device, copy=True).contiguous().view(1, n // N)


def logical_view(rows: torch.Tensor, homing: Homing) -> torch.Tensor:
    """Recover the logical 1-D order from the per-home rows."""
    if homing == Homing.LOCAL_CHUNKED:
        return rows.reshape(-1)
    return rows.t().reshape(-1)


# ---------------------------------------------------------------------------
# layouts and relayouts: the constraint form
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Layout:
    """Which of `homes` homes holds each element of a value, by its flat
    (logical, row-major) index i of n:

      chunked      home i // (n/N)                 -- the reference's P(axis)
      interleaved  home i mod N                    -- P(None, axis) on (n/N, N)
      runs         home (i mod s) // (s/N), s = n/runs: each of `runs` runs
                   chunk-contiguous over the homes  -- P(None, axis) on
                   a (runs, s) run matrix
      replicated   every home holds all n: one copy per home -- P(None, None)

    A plain tensor is in the chunked layout: its rows are its consecutive
    chunks.  A layout is a map of the flat index, so it keeps its meaning
    when the value is reshaped.
    """
    kind: str
    homes: int
    runs: int = 1

    KINDS = ("chunked", "interleaved", "runs", "replicated")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown layout {self.kind!r}; want one of "
                             f"{self.KINDS}")


def chunked_sharding(mesh, axis: Axis = "data") -> Layout:
    """The row form of the reference's chunk-contiguous sharding."""
    return Layout("chunked", axis_size(mesh, axis))


def interleaved_sharding(mesh, axis: Axis = "data") -> Layout:
    """The row form of the reference's ``(n/N, N)`` stripe sharding."""
    return Layout("interleaved", axis_size(mesh, axis))


def homing_layout(homing: Homing, mesh, axis: Axis = "data") -> Layout:
    """The layout a homing places a value in over the homes of `axis`."""
    if homing == Homing.LOCAL_CHUNKED:
        return chunked_sharding(mesh, axis)
    return interleaved_sharding(mesh, axis)


def _intervals(n: int, lay: Layout) -> List[Tuple[int, int, int]]:
    """(lo, hi, home) cover of [0, n) for a chunked or runs layout."""
    N = lay.homes
    runs = 1 if lay.kind == "chunked" else lay.runs
    s = n // runs
    w = s // N
    return [(r * s + d * w, r * s + (d + 1) * w, d)
            for r in range(runs) for d in range(N)]


def _on_home(lo: int, hi: int, d: int, N: int) -> int:
    """#i in [lo, hi) with i mod N == d."""
    return (hi - 1 - d) // N - (lo - 1 - d) // N


def moved_elems(n: int, src: Layout, dst: Layout) -> int:
    """Elements a relayout of n elements from `src` to `dst` delivers to
    a home that did not hold them.  Into `replicated` every home receives
    what it lacks (an all-gather); out of it every home keeps its part."""
    if src == dst or dst.kind != "replicated" and src.kind == "replicated":
        return 0
    if dst.kind == "replicated":
        return (dst.homes - 1) * n
    if src.homes != dst.homes:
        raise ValueError(f"relayout between {src.homes} and {dst.homes} homes")
    N = src.homes
    if src.kind == "interleaved" or dst.kind == "interleaved":
        if src.kind == dst.kind:
            return 0
        other = dst if src.kind == "interleaved" else src
        stay = sum(_on_home(lo, hi, d, N) for lo, hi, d in _intervals(n, other))
        return n - stay
    a, b = _intervals(n, src), _intervals(n, dst)
    stay, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo and a[i][2] == b[j][2]:
            stay += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return n - stay


def to_rows(flat: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The per-home rows of a 1-D value under `lay`: a fresh ``(N, n/N)``
    tensor (``(N, n)``, one full copy per home, when replicated)."""
    n, N = flat.shape[0], lay.homes
    if lay.kind == "chunked":
        return flat.view(N, n // N).clone()
    if lay.kind == "interleaved":
        return flat.view(n // N, N).t().contiguous()
    if lay.kind == "runs":
        return (flat.view(lay.runs, N, n // (lay.runs * N)).transpose(0, 1)
                .reshape(N, n // N))
    return flat.expand(N, n).clone()


def from_rows(rows: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The logical 1-D order of `to_rows`'s rows (``(N, n)`` copies when
    replicated)."""
    if lay.kind == "replicated":
        return rows
    if lay.kind == "chunked":
        return rows.reshape(-1)
    if lay.kind == "interleaved":
        return rows.t().reshape(-1)
    return rows.view(lay.homes, lay.runs, -1).transpose(0, 1).reshape(-1)


#: relayouts that moved data, the elements moved and their bytes, since
#: the last `reset_relayouts`
RELAYOUTS: Dict[str, int] = {"relayouts": 0, "elems": 0, "bytes": 0}


def reset_relayouts() -> None:
    for k in RELAYOUTS:
        RELAYOUTS[k] = 0


def relayout_counts() -> Dict[str, int]:
    return dict(RELAYOUTS)


def relayout(x: torch.Tensor, mesh, dst: Layout,
             src: Optional[Layout] = None) -> torch.Tensor:
    """Move `x` (in layout `src`, default chunked) into layout `dst`.

    A relayout that moves elements is a real copy, on the mesh's device,
    into the rows of `dst`, returned in logical order; it adds the moved
    elements and their bytes to `RELAYOUTS`.  One that moves nothing
    copies nothing (out of `replicated` it returns copy 0).  `x` has any
    shape (``(N, *shape)`` when `src` is replicated); the result keeps the
    per-copy shape, with a leading ``N`` when `dst` is replicated.
    """
    src = src or Layout("chunked", dst.homes)
    x = x.to(mesh.device)
    one = x[0] if src.kind == "replicated" else x
    n = one.numel()
    moved = moved_elems(n, src, dst)
    if moved == 0:                      # one home: nothing can move
        if src == dst:
            return x
        return one[None] if dst.kind == "replicated" else one
    RELAYOUTS["relayouts"] += 1
    RELAYOUTS["elems"] += moved
    RELAYOUTS["bytes"] += moved * one.element_size()
    out = from_rows(to_rows(one.reshape(-1), dst), dst)
    return out.view(dst.homes, *one.shape) if dst.kind == "replicated" \
        else out.view(one.shape)


def constrain(x: torch.Tensor, mesh, homing: Homing, axis: Axis = "data",
              src: Optional[Layout] = None) -> torch.Tensor:
    """The reference's sharding constraint: relayout `x` (in `src`,
    default chunked) into `homing` over the homes of `axis`.  Identity
    without a mesh."""
    if mesh is None:
        return x
    one = x[0] if src is not None and src.kind == "replicated" else x
    check_divisible(one.numel(), axis_size(mesh, axis), homing, str(axis))
    return relayout(x, mesh, homing_layout(homing, mesh, axis), src)
