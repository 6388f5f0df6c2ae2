"""Meshes of homes: `HomeMesh` on one device, `RankMesh` over ranks.

Both are counterparts of `jax.sharding.Mesh` (and of `launch/mesh.py`'s
host meshes).  The reference runs its per-device bodies on a mesh of
devices.

* `HomeMesh`: the m homes of the sort axes are the rows of one
  ``(m, chunk)`` tensor on `device`, and every collective of the
  reference becomes the index operation it performs on those rows (an
  all-to-all is a block transpose, a ppermute a row gather, a pod
  all-gather a strided row view).
* `RankMesh`: every home is one ``torch.distributed`` rank of the default
  process group, holding its own row on its own device, and every
  collective is a real one (`repro_torch.core.collectives`).

Axes are ordered outer first and linearised pod-major: home (and rank) r
sits at ``unravel_index(r, sizes)``.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; ``"cuda"`` without a card raises here
    instead of carrying on somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA device and none is available; pass "
            "device='cpu' to run the plain versions")
    return device


def entry_device(mesh, device=None) -> torch.device:
    """Where an entry point runs: the mesh's device, or without a mesh
    `device` (default ``"cuda"``).  A `device` that differs from the
    mesh's raises."""
    if mesh is None:
        return resolve_device(device or "cuda")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device={device!r} differs from the mesh's "
                         f"{mesh.device}; a mesh runs on its own device")
    return mesh.device


def _check_shape(shape: Mapping[str, int], what: str) -> Dict[str, int]:
    shape = dict(shape)
    if not shape:
        raise ValueError(f"a {what} needs at least one axis")
    for a, s in shape.items():
        if not isinstance(s, int) or s < 1 or (s & (s - 1)) != 0:
            raise ValueError(f"axis {a!r} size {s} not a power of 2")
    return shape


class HomeMesh:
    """Named home axes (outer first) on one torch device.

    ``device`` defaults to ``"cuda"``; without a card that raises here
    instead of carrying on somewhere else.  Pass ``device="cpu"`` to run
    the plain versions of the kernels.
    """

    def __init__(self, shape: Mapping[str, int], device="cuda"):
        self._shape: Dict[str, int] = _check_shape(shape, "HomeMesh")
        self.device = resolve_device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    @property
    def size(self) -> int:
        return math.prod(self._shape.values())

    def __repr__(self) -> str:
        return f"HomeMesh({self._shape!r}, device={str(self.device)!r})"


def one_process(mesh, what: str) -> None:
    """Raise for what runs on one process's mesh only, given a
    `RankMesh`: the constraint form (relayouts) across ranks is still to
    port."""
    if isinstance(mesh, RankMesh):
        raise NotImplementedError(
            f"{what} on a RankMesh waits for the constraint backend across "
            f"ranks (DTensor placements, ROADMAP.md Queue 1 item 1)")


#: the mesh axis that stands for the slow cross-pod link (the reference's
#: DCN ``pod`` axis): a collective's bytes to a rank whose coordinate on it
#: differs from the sender's are inter-pod bytes
POD_AXIS = "pod"


def rank_device(device) -> torch.device:
    """The device of this rank: ``"cuda"`` without an index is
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK``, else the global
    rank); without a card it raises (`resolve_device`)."""
    import torch.distributed as dist

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


class RankMesh:
    """Named home axes (outer first) over the ranks of the default
    ``torch.distributed`` process group: rank r is home r, linearised
    pod-major (row-major over the axes), as the reference orders devices.

    The sizes are powers of two whose product is the world size.  Every
    subgroup a collective can run over (each set of axes of size > 1) is
    built once here, by every rank in the same order.  ``device`` defaults
    to ``"cuda"`` (`rank_device`); without a card that raises.  Pass
    ``device="cpu"`` to run the plain versions of the kernels (the gloo
    tests).
    """

    def __init__(self, shape: Mapping[str, int], device="cuda"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "a RankMesh needs an initialised torch.distributed default "
                "group: call launch.mesh.spawn or launch.mesh.init_from_env")
        self._shape: Dict[str, int] = _check_shape(shape, "RankMesh")
        if self.size != dist.get_world_size():
            raise ValueError(f"mesh shape {self._shape} needs {self.size} "
                             f"rank(s) but the world has "
                             f"{dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.device = rank_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.coords: Dict[str, int] = self.coords_of(self.rank)
        self.backend = dist.get_backend()
        big = tuple(a for a, s in self._shape.items() if s > 1)
        self._groups = {}
        for k in range(1, len(big) + 1):
            for axes in itertools.combinations(big, k):
                part = self.partition(axes)
                if len(part) == 1:           # the whole world
                    group = dist.group.WORLD
                else:
                    group, _ = dist.new_subgroups_by_enumeration(part)
                mine = next(g for g in part if self.rank in g)
                self._groups[axes] = (group, mine)
        if len(big) > 1:
            # every subgroup connected on every rank before any rank goes
            # on: gloo connects a subgroup rank by rank, and a rank that is
            # done may otherwise leave while a peer still connects to it
            dist.barrier(device_ids=[self.device.index]
                         if self.backend == "nccl" else None)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    @property
    def size(self) -> int:
        return math.prod(self._shape.values())

    def _axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """`axes` checked against the mesh, in mesh order."""
        axes = tuple(axes)
        names = tuple(self._shape)
        missing = [a for a in axes if a not in self._shape]
        if missing:
            raise ValueError(f"axes {missing!r} are not axes of {self!r}")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"axes {axes!r} are not in the mesh's order "
                             f"{names!r}: rank order is row-major over it")
        return axes

    def coords_of(self, rank: int) -> Dict[str, int]:
        """`rank`'s coordinate on every axis."""
        return dict(zip(self._shape, (int(c) for c in np.unravel_index(
            rank, tuple(self._shape.values())))))

    def rank_at(self, coords: Mapping[str, int],
                base: Optional[int] = None) -> int:
        """The rank at `coords`; the axes it leaves out keep `base`'s
        coordinates (default this rank's)."""
        full = {**self.coords_of(self.rank if base is None else base),
                **coords}
        return int(np.ravel_multi_index(tuple(full[a] for a in self._shape),
                                        tuple(self._shape.values())))

    def partition(self, axes: Sequence[str]) -> List[List[int]]:
        """The rank groups that vary over `axes` only (every other
        coordinate fixed), each in its linear order over `axes`."""
        axes = self._axes(axes)
        sizes = tuple(self._shape.values())
        ranks = np.arange(self.size).reshape(sizes)
        keep = [i for i, a in enumerate(self._shape) if a not in axes]
        inner = [i for i, a in enumerate(self._shape) if a in axes]
        ranks = ranks.transpose(keep + inner).reshape(
            -1, math.prod(self._shape[a] for a in axes))
        return [[int(r) for r in row] for row in ranks]

    def group(self, axes: Sequence[str]):
        """``(process group, my group's ranks)`` over `axes`: None and
        ``[rank]`` when every axis of `axes` has size 1."""
        axes = tuple(a for a in self._axes(axes) if self._shape[a] > 1)
        if not axes:
            return None, [self.rank]
        return self._groups[axes]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's linear index over `axes` (its home on them)."""
        return self.group(axes)[1].index(self.rank)

    def pod(self, rank: int) -> Optional[int]:
        """`rank`'s coordinate on the pod axis (None without one)."""
        return self.coords_of(rank).get(POD_AXIS)

    def __repr__(self) -> str:
        return (f"RankMesh({self._shape!r}, rank={self.rank}, "
                f"device={str(self.device)!r})")
