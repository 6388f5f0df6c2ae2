"""`HomeMesh`: a mesh of homes held on one device.

The counterpart of `jax.sharding.Mesh` (and of `launch/mesh.py`'s emulated
host mesh).  The reference runs its per-device bodies on a mesh of
devices; here the m homes of the sort axes are the rows of one
``(m, chunk)`` tensor on `device`, and every collective of the reference
becomes the index operation it performs on those rows (an all-to-all is a
block transpose, a ppermute a row gather, a pod all-gather a strided row
view).  Axes are ordered outer first and linearised pod-major.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

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


class HomeMesh:
    """Named home axes (outer first) on one torch device.

    ``device`` defaults to ``"cuda"``; without a card that raises here
    instead of carrying on somewhere else.  Pass ``device="cpu"`` to run
    the plain versions of the kernels.
    """

    def __init__(self, shape: Mapping[str, int], device="cuda"):
        shape = dict(shape)
        if not shape:
            raise ValueError("a HomeMesh needs at least one axis")
        for a, s in shape.items():
            if not isinstance(s, int) or s < 1 or (s & (s - 1)) != 0:
                raise ValueError(f"axis {a!r} size {s} not a power of 2")
        self._shape: Dict[str, int] = shape
        self.device = resolve_device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    @property
    def size(self) -> int:
        return math.prod(self._shape.values())

    def __repr__(self) -> str:
        return f"HomeMesh({self._shape!r}, device={str(self.device)!r})"
