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
by the bytes of the elements whose home changes (`relayout_counts`).  On
a `RankMesh` every home is a rank holding its own elements of the value,
in ascending flat order (every layout's local order), and a relayout is
one counted collective over the locale's axes: an uneven all-to-all
(`collectives.all_to_all_v`) of what `send_counts` says, or an all-gather
into `replicated`.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.mesh import Axis, RankMesh, axis_tuple


class Homing(enum.Enum):
    LOCAL_CHUNKED = "local"
    HASH_INTERLEAVED = "hash"


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
      leaders      home (r * N) // runs, r = i // (n/runs): row r of a
                   (runs, n/runs) matrix wholly on its leader's home (the
                   paper's Algorithm 3: the leader of each pair merges);
                   for runs >= N, runs % N == 0, the map of chunked
      replicated   every home holds all n: one copy per home -- P(None, None)

    A plain tensor is in the chunked layout: its rows are its consecutive
    chunks.  A layout is a map of the flat index, so it keeps its meaning
    when the value is reshaped.  A home holds its elements in ascending
    flat order under every layout.  (In DTensor's names chunked is
    ``Shard(0)``, interleaved ``Shard(1)`` of the ``(n/N, N)`` view and
    replicated ``Replicate``; no placement says leaders, and the port
    moves every layout through its own counted collectives.)
    """
    kind: str
    homes: int
    runs: int = 1

    KINDS = ("chunked", "interleaved", "runs", "leaders", "replicated")

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
    """(lo, hi, home) cover of [0, n), ascending, for a chunked, runs or
    leaders layout."""
    N = lay.homes
    if lay.kind == "leaders":
        s = n // lay.runs
        return [(r * s, (r + 1) * s, (r * N) // lay.runs)
                for r in range(lay.runs)]
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
    a home that did not hold them: `send_counts`' off-diagonal sum.  Into
    `replicated` every home receives what it lacks (an all-gather); out of
    it every home keeps its part."""
    c = send_counts(n, src, dst)
    return int(c.sum() - np.trace(c))


def send_counts(n: int, src: Layout, dst: Layout) -> np.ndarray:
    """``(N, N)``: the elements home i sends home j when n elements are
    relaid out from `src` to `dst` (the diagonal: what stays).  Into
    `replicated` every home sends its share to every home (an
    all-gather); out of it every home keeps its part of `dst`.
    `moved_elems` is the off-diagonal sum."""
    if src.homes != dst.homes:
        raise ValueError(f"relayout between {src.homes} and {dst.homes} homes")
    N = src.homes
    out = np.zeros((N, N), np.int64)
    if src.kind == "replicated":
        np.fill_diagonal(out, shares(n, dst))
    elif dst.kind == "replicated":
        out[:] = shares(n, src)[:, None]
    elif src.kind == "interleaved" and dst.kind == "interleaved":
        np.fill_diagonal(out, n // N)
    elif "interleaved" in (src.kind, dst.kind):
        other = dst if src.kind == "interleaved" else src
        for lo, hi, h in _intervals(n, other):
            c = [_on_home(lo, hi, j, N) for j in range(N)]
            if src.kind == "interleaved":
                out[:, h] += c
            else:
                out[h, :] += c
    else:
        a, b = _intervals(n, src), _intervals(n, dst)
        i = j = 0
        while i < len(a) and j < len(b):
            lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
            if hi > lo:
                out[a[i][2], b[j][2]] += hi - lo
            if a[i][1] <= b[j][1]:
                i += 1
            else:
                j += 1
    return out


def shares(n: int, lay: Layout) -> np.ndarray:
    """The elements each of the homes holds under `lay` (n each when
    replicated)."""
    N = lay.homes
    if lay.kind == "replicated":
        return np.full(N, n, np.int64)
    if lay.kind == "interleaved":
        return np.full(N, n // N, np.int64)
    out = np.zeros(N, np.int64)
    for lo, hi, h in _intervals(n, lay):
        out[h] += hi - lo
    return out


def positions(n: int, lay: Layout, d: int, device=None) -> torch.Tensor:
    """The flat indices home d holds under `lay`, ascending: the order of
    its elements (int64, on `device`)."""
    if lay.kind == "replicated":
        return torch.arange(n, device=device)
    if lay.kind == "interleaved":
        return torch.arange(d, n, lay.homes, device=device)
    parts = [torch.arange(lo, hi, device=device)
             for lo, hi, h in _intervals(n, lay) if h == d]
    return torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64,
                                                      device=device)


def home_of(i: torch.Tensor, n: int, lay: Layout) -> torch.Tensor:
    """The home that holds each flat index of `i` under `lay` (not
    replicated)."""
    N = lay.homes
    if lay.kind == "chunked":
        return i // (n // N)
    if lay.kind == "interleaved":
        return i % N
    if lay.kind == "runs":
        return (i % (n // lay.runs)) // (n // (lay.runs * N))
    if lay.kind == "leaders":
        return (i // (n // lay.runs)) * N // lay.runs
    raise ValueError("every home holds every element when replicated")


def to_rows(flat: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The per-home rows of a 1-D value under `lay`: a fresh ``(N, n/N)``
    tensor (``(N, n)``, one full copy per home, when replicated; for
    leaders the ``(runs, n/runs)`` rows, row r on home ``(r*N)//runs``)."""
    n, N = flat.shape[0], lay.homes
    if lay.kind == "chunked":
        return flat.view(N, n // N).clone()
    if lay.kind == "leaders":
        return flat.view(lay.runs, n // lay.runs).clone()
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
    if lay.kind in ("chunked", "leaders"):
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
             src: Optional[Layout] = None, axis: Optional[Axis] = None,
             n: Optional[int] = None) -> torch.Tensor:
    """Move `x` (in layout `src`, default chunked) into layout `dst`.

    On a `HomeMesh`: a relayout that moves elements is a real copy, on the
    mesh's device, into the rows of `dst`, returned in logical order; it
    adds the moved elements and their bytes to `RELAYOUTS`.  One that
    moves nothing copies nothing (out of `replicated` it returns copy 0).
    `x` has any shape (``(N, *shape)`` when `src` is replicated); the
    result keeps the per-copy shape, with a leading ``N`` when `dst` is
    replicated.

    On a `RankMesh`: `x` is this rank's elements under `src` over the
    homes of `axis` (default every mesh axis), in ascending flat order,
    of a value of `n` elements (default: `x`'s count times the homes, or
    `x`'s count out of replicated); returns this rank's elements under
    `dst`, moved by one collective (`_rank_relayout`).
    """
    src = src or Layout("chunked", dst.homes)
    if isinstance(mesh, RankMesh):
        return _rank_relayout(x, mesh, dst, src, axis, n)
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


#: a signed integer dtype of each element width: index operations move a
#: value's bits as it (torch indexes uint16/uint32 on neither device)
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _partition(h: torch.Tensor, N: int) -> torch.Tensor:
    """The stable order that groups the indices of `h` (values < N) by
    value: every index with value 0 in order, then value 1, ..."""
    return torch.cat([torch.nonzero(h == j).view(-1) for j in range(N)])


def _rank_relayout(x: torch.Tensor, mesh, dst: Layout, src: Layout,
                   axis: Optional[Axis], n: Optional[int]) -> torch.Tensor:
    """`relayout` on a `RankMesh`: this rank's elements of the value under
    `src` -> its elements under `dst`.

    Into `replicated`: one all-gather (an uneven all-to-all of every
    rank's whole share when `src`'s shares differ).  Out of it: this
    rank's part of `dst`, sliced, nothing sent.  Otherwise one uneven
    all-to-all: this rank sends home j, in ascending flat order, its
    elements that `dst` puts on j (``send_counts`` row), and puts what it
    receives, stacked by source, in ascending flat order.  A relayout
    that moves nothing over the whole group makes no collective and
    returns `x`.  `RELAYOUTS` adds what this rank sent.
    """
    axes = axis_tuple(axis) if axis is not None else tuple(mesh.shape)
    N, d = axis_size(mesh, axes), mesh.index(axes)
    if src.homes != N or dst.homes != N:
        raise ValueError(f"layouts of {src.homes} and {dst.homes} homes on "
                         f"the {N} homes of axes {axes!r}")
    x = x.to(mesh.device)
    flat = x.reshape(-1)
    if n is None:
        if not _even(src):
            raise ValueError(f"give n to relayout out of {src}: its homes "
                             f"hold different counts")
        n = flat.numel() * (1 if src.kind == "replicated" else N)
    if flat.numel() != shares(n, src)[d]:
        raise ValueError(f"rank {mesh.rank} holds {flat.numel()} elements; "
                         f"{src} of {n} puts {shares(n, src)[d]} on home {d}")
    counts = send_counts(n, src, dst)
    if int(counts.sum() - np.trace(counts)) == 0:
        if src.kind == "replicated" and dst.kind != "replicated":
            return _take(flat, positions(n, dst, d, flat.device))
        return x
    sent = int(counts[d].sum() - counts[d, d])
    RELAYOUTS["relayouts"] += 1
    RELAYOUTS["elems"] += sent
    RELAYOUTS["bytes"] += sent * flat.element_size()
    if dst.kind == "replicated":
        if _even(src):
            rows = collectives.all_gather(flat, mesh, axes)
        else:
            rows = collectives.all_to_all_v(flat.repeat(N), mesh, axes,
                                            counts[d].tolist(),
                                            counts[:, d].tolist())
        if _monotone(src):          # stacked by source: the flat order
            return rows.reshape(-1)
        return _put(torch.cat([positions(n, src, i, flat.device)
                               for i in range(N)]), rows.reshape(-1), n)
    send = flat if _monotone(dst) else _take(flat, _partition(
        home_of(positions(n, src, d, flat.device), n, dst), N))
    recv = collectives.all_to_all_v(send, mesh, axes, counts[d].tolist(),
                                    counts[:, d].tolist())
    if not _monotone(src):
        q = positions(n, dst, d, flat.device)
        recv = _put(_partition(home_of(q, n, src), N), recv, q.numel())
    return recv.view(x.shape) if recv.numel() == x.numel() else recv


def _even(lay: Layout) -> bool:
    """Whether every home holds as many elements under `lay`."""
    return lay.kind != "leaders" or lay.runs >= lay.homes


def _monotone(lay: Layout) -> bool:
    """Whether `lay`'s home never decreases along the flat index: then a
    home's elements in flat order are already grouped by home."""
    return lay.kind in ("chunked", "leaders") or (lay.kind == "runs"
                                                  and lay.runs == 1)


def _take(flat: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``flat[index]``, moving the bits (`_BITS`)."""
    return flat.view(_BITS[flat.element_size()])[index].view(flat.dtype)


def _put(index: torch.Tensor, values: torch.Tensor, size: int
         ) -> torch.Tensor:
    """A fresh 1-D tensor of `size` with ``out[index] = values``, moving
    the bits (`_BITS`)."""
    bits = _BITS[values.element_size()]
    out = torch.empty(size, dtype=bits, device=values.device)
    out[index] = values.view(bits)
    return out.view(values.dtype)


def constrain(x: torch.Tensor, mesh, homing: Homing, axis: Axis = "data",
              src: Optional[Layout] = None) -> torch.Tensor:
    """The reference's sharding constraint: relayout `x` (in `src`,
    default chunked) into `homing` over the homes of `axis`.  Identity
    without a mesh.  On a `RankMesh` `x` is this rank's elements under
    `src` (`relayout`)."""
    if mesh is None:
        return x
    if isinstance(mesh, RankMesh):
        return relayout(x, mesh, homing_layout(homing, mesh, axis), src,
                        axis)
    one = x[0] if src is not None and src.kind == "replicated" else x
    check_divisible(one.numel(), axis_size(mesh, axis), homing, str(axis))
    return relayout(x, mesh, homing_layout(homing, mesh, axis), src)
