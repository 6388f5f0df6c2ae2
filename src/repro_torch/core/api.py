"""The placement API — the paper's technique as a first-class object.

The counterpart of `repro/core/api.py`, on a `HomeMesh` (every home a row
of one tensor) or a `RankMesh` (every home a ``torch.distributed`` rank,
holding its own elements: `put` gives the rank its shard, `pin` and
`localise` move this rank's elements by counted collectives, `make`
builds its chunk, every workload runs per rank, and each workload's
``fn.place(x)`` gives the rank its share of the whole input; `check` adds
R2 on the collectives, and R1 for the engine; `pin_tree` keeps the rank's
home's slot rows, which never leave it):

`Locale`
    A frozen bundle of ``(mesh, axis, LocalisationPolicy)``:

    ==================  ====================================================
    ``locale.put(x)``       placement under the policy's homing; a `Homed`.
    ``locale.pin(x)``       the policy's layout, as a counted relayout; a
                            strict no-op without a mesh or under
                            ``static_mapping=False``.
    ``locale.localise(x)``  the one-shot Algorithm-2 relayout into the
                            chunk-contiguous layout.
    ``locale.pin_tree(t)``  chunk-contiguous homing of every leaf of a
                            dict/list/tuple tree along a chosen dim.
    ``locale.jit(fn)``      `fn` itself: PyTorch runs eagerly (step 5,
                            donation, is documented, not enforced).
    ``locale.make(s, cb)``  a tensor born locally homed, built home by home.
    ``locale.workload(n)``  a registered workload (``"sort"``, ``"engine"``,
                            ``"microbench"``).
    ``locale.check(n)``     homecheck: run the workload, check the kernel
                            launches it makes (R3/R5-R8) and, on a
                            `RankMesh`, its collectives (R1/R2); a
                            `Report`.
    ==================  ====================================================

`Homed`
    ``(data, homing, axis)``: ``data`` is the ``(m, chunk)`` per-home
    tensor and ``.logical()`` gives the 1-D logical order.  On a
    `RankMesh`, ``data`` is this rank's ``(1, chunk)`` row
    (`engine.gather_sorted` assembles an engine result's logical order,
    `sort.gather_sorted` a constraint tree's `sort.RankPart`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core.homing import (Axis, Homing, Layout, axis_size,
                                     axis_tuple, check_divisible,
                                     homing_layout,
                                     logical_view, rank_shard, relayout,
                                     to_layout)
from repro_torch.core.localisation import (LocalisationPolicy, chunk_bounds,
                                           donate_buffers, localise, place)
from repro_torch.core.mesh import HomeMesh, RankMesh, entry_device


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


#: storages that `Locale.pin_tree` homed on a `HomeMesh`: the storage's
#: ``_cdata`` -> (a weak reference to it, the homing and view it was given)
_HOMED: Dict[int, Tuple[StorageWeakRef, tuple]] = {}


def _view(x: torch.Tensor) -> tuple:
    """What makes two tensors of one storage the same view."""
    return (tuple(x.shape), tuple(x.stride()), x.storage_offset(), x.dtype)


def _homed(x: torch.Tensor) -> Optional[tuple]:
    """The homing and view `pin_tree` gave `x`'s storage, if it homed it
    and the storage is still the one it homed."""
    got = _HOMED.get(x.untyped_storage()._cdata)
    if got is None or got[0].expired():
        return None
    return got[1]


def _note_homed(y: torch.Tensor, key: tuple) -> None:
    for k in [k for k, (ref, _) in _HOMED.items() if ref.expired()]:
        del _HOMED[k]
    st = y.untyped_storage()
    _HOMED[st._cdata] = (StorageWeakRef(st), key)


@dataclass(frozen=True)
class Locale:
    """Where data lives: ``(mesh, axis, policy)`` as one value.

    ``mesh=None`` is one home on ``"cuda"``.  `axis` may be a tuple of mesh
    axes, outer (pod) axes first — ``Locale(mesh, axis=("pod", "data"))``
    linearises homes pod-major.
    """
    mesh: Optional[Union[HomeMesh, RankMesh]] = None
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
        extended with BIG sort-neutral sentinels first.  On a `RankMesh`
        every rank passes the whole input and keeps its own shard (a
        ``(1, n/N)`` row, `homing.rank_shard`).
        """
        from repro_torch.core.sort import pad_to_multiple
        x = torch.as_tensor(x)
        if pad:
            x = pad_to_multiple(x, self.axis_size)
        mesh, axis = self.mesh, self.axis
        if isinstance(mesh, RankMesh):
            return Homed(rank_shard(x, mesh, self.policy.homing, axis),
                         self.policy.homing, axis)
        if mesh is None:                  # one home on the default device
            axis = axis if isinstance(axis, str) else axis[-1]
            mesh = HomeMesh({axis: 1})
        return Homed(to_layout(x, mesh, self.policy.homing, axis),
                     self.policy.homing, self.axis)

    def pin(self, x):
        """The policy's layout for `x`, as a counted relayout (`place`).

        A strict no-op when ``mesh is None`` or ``static_mapping=False``:
        the 'leave it to the runtime' baseline stays a baseline.  A raw
        tensor is taken in its chunked layout and returned in logical
        order.  A `Homed` must carry the locale's homing (else TypeError);
        under a localised policy it comes back chunk-contiguous, as a
        LOCAL_CHUNKED `Homed` (the reference keeps the old tag on data it
        has constrained to the chunked sharding; here the tag says where
        the rows are), and otherwise unchanged.  On a `RankMesh` a raw
        tensor is this rank's chunk, and the result its elements under
        the policy's layout.
        """
        if self.mesh is None or not self.policy.static_mapping:
            return x                         # no-op before any checking
        if isinstance(x, Homed):
            if x.homing != self.policy.homing:
                raise TypeError(
                    f"cannot pin a {x.homing.value!r}-homed value under a "
                    f"{self.policy.homing.value!r} locale -- re-place it with "
                    f"Locale.put or relayout with Locale.localise")
            if self.policy.localised and x.homing != Homing.LOCAL_CHUNKED:
                return self.localise(x)
            return x
        return place(x, self.mesh, self.policy, self.axis)

    def localise(self, x):
        """The one-shot Algorithm-2 relayout into the locally-homed layout;
        a `Homed` comes back as a LOCAL_CHUNKED `Homed`.  On a `RankMesh`
        a raw tensor is this rank's chunk (nothing moves), and a `Homed`'s
        row is relaid out by one counted all-to-all."""
        if not isinstance(x, Homed):
            return localise(x, self.mesh, self.axis)
        if self.mesh is None:
            return Homed(x.logical().reshape(1, -1), Homing.LOCAL_CHUNKED,
                         self.axis)
        src = homing_layout(x.homing, self.mesh, self.axis)
        if isinstance(self.mesh, RankMesh):
            y = localise(x.data, self.mesh, self.axis, src)
            return Homed(y.view(1, -1), Homing.LOCAL_CHUNKED, self.axis)
        y = localise(x.logical(), self.mesh, self.axis, src)
        return Homed(to_layout(y, self.mesh, Homing.LOCAL_CHUNKED, self.axis),
                     Homing.LOCAL_CHUNKED, self.axis)

    def pin_tree(self, tree, dim: int = 0, size: Optional[int] = None):
        """Home every tensor leaf of a dict/list/tuple tree chunk-contiguously
        along `dim` (the KV-cache form of localisation: each slot along
        `dim` lives wholly on one home), by a counted relayout from its
        plain (chunked) layout; leaves keep their shapes.  Leaves where
        `dim` does not exist, does not match `size` or does not divide over
        the homes are left alone.  No-op without a mesh or under
        ``static_mapping=False``.

        On a `HomeMesh` data is copied into its home once: a leaf that an
        earlier `pin_tree` homed (the same view of the storage it returned,
        homed along the same `dim` over the same homes) comes back as it
        is, uncounted -- the reference's sharding constraint on a value
        that already has the sharding.  A decode step writes the cache in
        place, so its storage stays homed from step to step; a leaf that an
        op rebuilt in fresh storage is relaid out and counted again.

        On a `RankMesh` (the server across ranks) a rank holds its home's
        rows only, home h of the locale's axes owning rows ``[h*size/N,
        (h+1)*size/N)`` of `dim` (`size`, the whole count, is required):
        a leaf of ``size / N`` rows is those rows and stays as it is, so
        in steady state nothing moves; a leaf of all `size` rows (every
        rank passing the whole) is cut to its home's rows on the rank.
        No collective runs.
        """
        if self.mesh is None or not self.policy.static_mapping:
            return tree
        N = self.axis_size
        ranks = isinstance(self.mesh, RankMesh)
        if ranks:
            if size is None:
                raise ValueError("pin_tree on a RankMesh needs size=, the "
                                 "whole count of the homed dim")
            h = self.mesh.index(axis_tuple(self.axis))

        def leaf(x):
            if not isinstance(x, torch.Tensor) or x.dim() <= dim:
                return x
            if size is not None and x.shape[dim] != size:
                return x
            if x.shape[dim] % N != 0:
                return x
            if ranks:                   # this home's rows, on this rank
                return x.narrow(dim, h * size // N, size // N)
            key = (repr(self.mesh), axis_tuple(self.axis), dim, N) + _view(x)
            if _homed(x) == key:
                return x
            runs = math.prod(x.shape[:dim])
            y = relayout(x, self.mesh, Layout("runs", N, runs))
            _note_homed(y, key[:4] + _view(y))
            return y

        def walk(t):
            if isinstance(t, dict):
                return type(t)((k, walk(v)) for k, v in t.items())
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v) for v in t)
            return leaf(t)

        return walk(tree)

    def jit(self, fn, donate=(0,)):
        """`fn` itself: PyTorch runs eagerly, so there is nothing to
        compile.  Paper step 5 ('free as soon as finished') stays a
        contract: the arguments in `donate` (the reference's signature)
        may have their storage reused by `fn`, and the caller must not
        read them after the call (`donate_buffers`)."""
        return donate_buffers(fn)

    def make(self, shape: Tuple[int, ...], cb: Callable,
             device=None) -> torch.Tensor:
        """A tensor born locally homed: home d's rows are ``cb(index)`` over
        its chunk of dim 0 (`chunk_bounds`), built home by home on the
        mesh's device and returned as the logical ``shape`` tensor (the
        chunked layout's rows are its consecutive chunks).  Without a
        mesh, `cb` runs once over the full index, on `device` (default
        ``"cuda"``; `entry_device`).  On a `RankMesh` each rank builds
        and returns its own chunk only, ``(shape[0] / N, *shape[1:])``.
        """
        shape = tuple(shape)
        dev = entry_device(self.mesh, device)
        rest = tuple(slice(None) for _ in shape[1:])
        if self.mesh is None:
            return torch.as_tensor(cb((slice(None),) + rest)).to(dev).reshape(
                shape)
        check_divisible(shape[0], self.axis_size, Homing.LOCAL_CHUNKED,
                        str(self.axis))
        if isinstance(self.mesh, RankMesh):
            lo, hi = chunk_bounds(shape[0], self.axis_size)[
                self.mesh.index(axis_tuple(self.axis))]
            return torch.as_tensor(cb((slice(lo, hi),) + rest)).to(
                dev).reshape((hi - lo,) + shape[1:])
        rows = [torch.as_tensor(cb((slice(lo, hi),) + rest)).to(dev)
                for lo, hi in chunk_bounds(shape[0], self.axis_size)]
        return torch.stack(rows).view(shape)

    def workload(self, name: str, **kw):
        """Build the entry point of a registered workload:

            locale.workload("sort")                      # constraint backend
            locale.workload("sort", backend="shard_map")
            locale.workload("microbench", reps=R)

        On a `RankMesh` each rank calls ``fn(fn.place(x))`` with the same
        whole input `x` and gets its own part of the result.
        """
        try:
            builder = _WORKLOADS[name]
        except KeyError:
            raise ValueError(f"unknown workload {name!r}; registered: "
                             f"{sorted(_WORKLOADS)}") from None
        return builder(self, **kw)

    def check(self, workload: str = "sort", *, rules=None, suppress=(),
              **kw):
        """Check a workload against this locale.

        The homecheck hook (`repro_torch.analysis.check_workload`): runs
        ``self.workload(workload, ...)`` once on a representative input
        while recording every kernel launch it makes and every buffer it
        makes and returns, and runs rules R3 (shared memory per block),
        R5 (write races, coverage, out-of-bounds reads), R6
        (exchange-network certification), R7 (index arithmetic, sentinel)
        and R8 (dead ``blockIdx`` lanes) on the launches, R4 (arguments
        copied in place of written in place) and R10 (peak live device
        bytes against the device's memory) on the buffers, and on a
        `RankMesh` R1 (this rank's collectives against
        `collective_census`), R2 (their groups against the locale's axes)
        and R11 (every rank's collectives in one sequence); R9 (the
        serving scheduler) is the decode target's (`check_decode`), noted
        as skipped here.  Returns an `analysis.Report`;
        ``report.clean`` is the contract.  `rules` selects a subset (e.g.
        ``rules=("R5", "R6")``; None = all); `suppress` drops findings by
        rule id.
        """
        from repro_torch.analysis import check_workload
        return check_workload(self, workload, rules=rules, suppress=suppress,
                              **kw)


# ---------------------------------------------------------------------------
# built-in workloads
# ---------------------------------------------------------------------------
@register_workload("sort")
def _sort_workload(locale: Locale, *, backend: str = "constraint",
                   num_workers=None, local_sort=None, local_phase: str = None,
                   device=None):
    """The paper's validation app: distributed merge sort (Algorithms 1-3).

    The default backend is the reference's, ``"constraint"`` (the merge
    tree relaid out between levels as the policy says);
    ``backend="shard_map"`` is the per-home engine.  ``local_phase``:
    "kernel", "reference" or None (auto by ``local_sort``; the constraint
    tree takes None or "reference").  ``device``: where a mesh-less locale
    runs the constraint tree (default ``"cuda"``); the engine places on
    its mesh only.
    """
    from repro_torch.core.sort import make_sort_fn
    axis = locale.axis if locale.mesh is not None else "data"
    return make_sort_fn(locale.mesh, locale.policy, num_workers=num_workers,
                        local_sort=local_sort, backend=backend, axis=axis,
                        local_phase=local_phase, device=device)


@register_workload("engine")
def _engine_workload(locale: Locale, **kw):
    """Alias: the explicit per-home engine backend."""
    kw.setdefault("backend", "shard_map")
    if kw["backend"] != "shard_map":
        raise ValueError("workload('engine') is the shard_map backend; use "
                         "workload('sort', backend=...) to choose freely")
    return _sort_workload(locale, **kw)


@register_workload("microbench")
def _microbench_workload(locale: Locale, *, reps: int, device=None):
    """The Fig-1 repetitive-copy micro-benchmark (`core.microbench`).
    ``device``: where a mesh-less locale runs (default ``"cuda"``)."""
    from repro_torch.core.microbench import make_microbench_fn
    axis = locale.axis if locale.mesh is not None else "data"
    return make_microbench_fn(locale.mesh, locale.policy, reps, axis=axis,
                              device=device)
