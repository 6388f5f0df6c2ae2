"""The placement API — the paper's technique as a first-class object.

The counterpart of `repro/core/api.py`, on a `HomeMesh`:

`Locale`
    A frozen bundle of ``(mesh, axis, LocalisationPolicy)``:
    ``locale.put(x)`` places a 1-D tensor under the policy's homing and
    returns a `Homed`; ``locale.workload(name, **kw)`` builds a registered
    workload (``"sort"``, ``"engine"``).

`Homed`
    ``(data, homing, axis)``: ``data`` is the ``(m, chunk)`` per-home
    tensor and ``.logical()`` gives the 1-D logical order.

The reference's ``pin``, ``pin_tree``, ``localise``, ``jit``, ``make`` and
the ``"microbench"`` workload are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.homing import (Axis, Homing, axis_size, logical_view,
                                     to_layout)
from repro_torch.core.localisation import LocalisationPolicy, chunk_bounds
from repro_torch.core.mesh import HomeMesh


@dataclass(frozen=True)
class Homed:
    """A per-home tensor plus the homing it was placed under.

    `data` is ``(m, chunk)``: row d is what home d holds (chunk-contiguous
    or interleaved, per `homing`).
    """
    data: torch.Tensor
    homing: Homing = Homing.LOCAL_CHUNKED
    axis: Axis = "data"

    def logical(self) -> torch.Tensor:
        """The logical 1-D order."""
        return logical_view(self.data, self.homing)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def size(self) -> int:
        return math.prod(self.data.shape)


# ---------------------------------------------------------------------------
# workload registry
# ---------------------------------------------------------------------------
_WORKLOADS: Dict[str, Callable] = {}


def register_workload(name: str):
    """Register a factory ``builder(locale, **kw) -> fn`` under `name`."""
    def deco(builder: Callable) -> Callable:
        _WORKLOADS[name] = builder
        return builder
    return deco


def workload_names() -> Tuple[str, ...]:
    """The registered workload names."""
    return tuple(sorted(_WORKLOADS))


@dataclass(frozen=True)
class Locale:
    """Where data lives: ``(mesh, axis, policy)`` as one value.

    ``mesh=None`` is one home on ``"cuda"``.  `axis` may be a tuple of mesh
    axes, outer (pod) axes first — ``Locale(mesh, axis=("pod", "data"))``
    linearises homes pod-major.
    """
    mesh: Optional[HomeMesh] = None
    axis: Axis = "data"
    policy: LocalisationPolicy = LocalisationPolicy()

    @classmethod
    def auto(cls, policy: LocalisationPolicy = LocalisationPolicy(),
             axis: str = "data", homes: int = 1, device="cuda") -> "Locale":
        """A locale of `homes` homes on one axis of `device`."""
        return cls(mesh=HomeMesh({axis: homes}, device=device), axis=axis,
                   policy=policy)

    def with_policy(self, policy: LocalisationPolicy) -> "Locale":
        """Same placement substrate, different Table-1 policy corner."""
        return Locale(mesh=self.mesh, axis=self.axis, policy=policy)

    @property
    def axis_size(self) -> int:
        """#homes along the locale's axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return axis_size(self.mesh, self.axis)

    def owners(self, size: int) -> Tuple[int, ...]:
        """Home index of each of `size` chunk-contiguously homed items
        (the ownership map of `chunk_bounds`)."""
        out: list = []
        for home, (lo, hi) in enumerate(chunk_bounds(size, self.axis_size)):
            out.extend([home] * (hi - lo))
        return tuple(out)

    def put(self, x, pad: bool = False) -> Homed:
        """Place a 1-D tensor or array under the policy's homing, on the
        mesh's device (without a mesh: one home on ``"cuda"``).

        Lengths must divide the axis size; with ``pad=True`` the input is
        extended with BIG sort-neutral sentinels first.
        """
        from repro_torch.core.sort import pad_to_multiple
        x = torch.as_tensor(x)
        if pad:
            x = pad_to_multiple(x, self.axis_size)
        mesh, axis = self.mesh, self.axis
        if mesh is None:                  # one home on the default device
            axis = axis if isinstance(axis, str) else axis[-1]
            mesh = HomeMesh({axis: 1})
        return Homed(to_layout(x, mesh, self.policy.homing, axis),
                     self.policy.homing, self.axis)

    def workload(self, name: str, **kw):
        """Build the entry point of a registered workload:

            locale.workload("sort", backend="shard_map")
        """
        try:
            builder = _WORKLOADS[name]
        except KeyError:
            raise ValueError(f"unknown workload {name!r}; registered: "
                             f"{sorted(_WORKLOADS)}") from None
        return builder(self, **kw)


# ---------------------------------------------------------------------------
# built-in workloads
# ---------------------------------------------------------------------------
@register_workload("sort")
def _sort_workload(locale: Locale, *, backend: str = "constraint",
                   num_workers=None, local_sort=None, local_phase: str = None):
    """The paper's validation app: distributed merge sort (Algorithms 1-3).

    The default backend is the reference's, ``"constraint"``, which is not
    ported yet and raises NotImplementedError; pass ``backend="shard_map"``
    for the per-home engine.  ``local_phase``: "kernel", "reference" or
    None (auto by ``local_sort``).
    """
    from repro_torch.core.sort import make_sort_fn
    axis = locale.axis if locale.mesh is not None else "data"
    return make_sort_fn(locale.mesh, locale.policy, num_workers=num_workers,
                        local_sort=local_sort, backend=backend, axis=axis,
                        local_phase=local_phase)


@register_workload("engine")
def _engine_workload(locale: Locale, **kw):
    """Alias: the explicit per-home engine backend."""
    kw.setdefault("backend", "shard_map")
    if kw["backend"] != "shard_map":
        raise ValueError("workload('engine') is the shard_map backend; use "
                         "workload('sort', backend=...) to choose freely")
    return _sort_workload(locale, **kw)
