"""The serving plan: where the decode slots are homed.

The counterpart of `MeshPlan` / `NULL_PLAN` in `repro/sharding/
partition.py`, with the fields the server reads: `mesh` (a `HomeMesh`, or
None) and `batch_axes` (the mesh axes the batch-slot dim is homed over).
Every home of a `HomeMesh` lies on one device, so the reference's
activation sharding constraints (``ws``) have nothing to move here; the
slot homing is `Locale.pin_tree`'s counted relayout.  Training runs on one
card too (`models.steps`): the reference's parameter and activation
layouts across devices (``param_specs``, ``ws``, its training
`make_plan`) come with the ``torch.distributed`` backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.mesh import HomeMesh


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolved placement plan of one serving cell."""

    mesh: Optional[HomeMesh]
    batch_axes: Optional[Tuple[str, ...]] = None


NULL_PLAN = MeshPlan(mesh=None)


def make_plan(mesh: Optional[HomeMesh], slots: int) -> MeshPlan:
    """The serving plan of `mesh` for `slots` decode slots: the slots homed
    over the data-parallel axes (every axis but ``"model"``) when they
    divide over them, else not homed -- the reference's `make_plan` for a
    decode shape of global batch `slots`."""
    if mesh is None:
        return NULL_PLAN
    dp = tuple(a for a in mesh.shape if a != "model")
    dp_n = math.prod(mesh.shape[a] for a in dp)
    return MeshPlan(mesh=mesh,
                    batch_axes=dp if dp_n and slots % dp_n == 0 else None)
