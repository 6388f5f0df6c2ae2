"""Distributed parallel merge sort — the paper's validation application.

Structure mirrors Algorithm 3: a local sort per worker followed by a
log2(N)-level merge tree.  The counterpart of `repro/core/sort.py`: the
sentinel padding, the NaN guard, the gather-form stable merge, the
constraint backend (`distributed_merge_sort`, the default) and the
backend dispatch; the explicit engine (``backend="shard_map"``) is
`repro_torch.core.engine`.

The constraint backend keeps the reference's (count, size) run matrix in
logical order and, between tree levels, relayouts it as the policy says
(`_constrain_runs`): each of the reference's sharding constraints is a
counted relayout on the mesh's device (`repro_torch.core.homing`).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.core.homing import Axis, Homing, Layout, axis_size, relayout
from repro_torch.core.localisation import LocalisationPolicy
from repro_torch.core.mesh import entry_device, one_process
from repro_torch.kernels.bitonic_sort import widen

BIG = {torch.int32: torch.iinfo(torch.int32).max,
       torch.float32: float("inf")}

BACKENDS = ("constraint", "shard_map")


def check_nan_free(x: torch.Tensor, where: str) -> None:
    """Raise a clear ValueError if a float tensor contains NaN.

    NaN breaks both halves of the sort: it compares unordered in the rank
    merge, and it sorts *after* the inf BIG sentinel, so the post-sort tail
    strip would keep a sentinel and silently drop the NaN.
    """
    if not x.dtype.is_floating_point:
        return
    bad = int(torch.isnan(x).sum())
    if bad:
        raise ValueError(
            f"{where}: input contains {bad} NaN value(s) — NaN is unordered "
            f"under the rank merge and sorts after the inf padding sentinel, "
            f"so the result would silently drop it; filter NaNs out (e.g. "
            f"x[~torch.isnan(x)]) or sort with torch.sort directly")


def pad_value(dtype: torch.dtype):
    """Sort-neutral sentinel: sorts after every real element of `dtype`."""
    if dtype in BIG:
        return BIG[dtype]
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def pad_to_multiple(x: torch.Tensor, m: int,
                    nan_check: bool = True) -> torch.Tensor:
    """Pad a 1-D tensor with BIG sentinels up to the next multiple of m.

    Sentinels sort after (or tie with) every real element, so after sorting
    the original multiset occupies the first `len(x)` slots.  Float inputs
    are checked for NaN when padding occurs (``nan_check=False`` for callers
    that already checked).
    """
    n = x.shape[0]
    n_pad = (-n) % m
    if n_pad == 0:
        return x
    if nan_check:
        check_nan_free(x, "pad_to_multiple")
    fill = torch.full((n_pad,), pad_value(x.dtype), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill])


#: uint16 and uint32, and the signed dtype of their width: torch indexes
#: neither on the card, so the sort's index operations move their bits as
#: that dtype (`take`); the kernels take them as they are
BITS_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def bits_view(x: torch.Tensor) -> torch.Tensor:
    """`x` itself, or the bits of a uint16 or uint32 `x` viewed as the
    signed dtype of their width (undo with ``.view(x.dtype)``)."""
    bits = BITS_VIEW.get(x.dtype)
    return x if bits is None else x.view(bits)


def take(x: torch.Tensor, index) -> torch.Tensor:
    """``x[index]``, moving the bits of a uint16 or uint32 `x` as the
    signed dtype of their width (`bits_view`)."""
    return bits_view(x)[index].view(x.dtype)


def sort_entry(fn, granule: int, device):
    """NaN guard + sentinel pad + tail strip around a sort on `device`.

    Takes a 1-D tensor or array (anything `torch.as_tensor` takes), moves
    it to `device`, pads it to `granule` and strips the tail after `fn`.
    """
    @functools.wraps(fn)
    def call(x, *args, **kw):
        x = torch.as_tensor(x).to(device)
        if x.dim() != 1:
            raise ValueError(f"sort takes a 1-D input, got shape "
                             f"{tuple(x.shape)}")
        check_nan_free(x, "sort")       # pad skips its own scan: one pass
        n = x.shape[0]
        return fn(pad_to_multiple(x, granule, nan_check=False),
                  *args, **kw)[:n]
    call.__wrapped__ = fn
    return call


def merge_sorted_reference(a: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """The plain version of `merge_sorted`: the stable rank merge in
    gather form, as the reference.  `ia` (each a-element's output
    position) is inverted with one more searchsorted, so every output
    element is read from a or b.  Leading dims are batch dims (one merge
    per row).  Comparisons are IEEE (``-0.0 == +0.0``), through
    `torch.searchsorted` with ``side="left"``, so elements of `a` win
    ties; uint16 and uint32 are searched widened (`widen`) and narrowed
    back."""
    na, nb = a.shape[-1], b.shape[-1]
    if na == 0 or nb == 0:
        return torch.cat([a, b], dim=-1)
    lead = a.shape[:-1]
    dev, dtype = a.device, a.dtype
    a, b = widen(a.contiguous()), widen(b.contiguous())
    ia = torch.arange(na, device=dev) + torch.searchsorted(b, a, side="left")
    k = torch.arange(na + nb, device=dev).expand(*lead, na + nb).contiguous()
    ra = torch.searchsorted(ia, k, side="left")
    ra_c = ra.clamp(max=na - 1)
    is_a = (ra < na) & (torch.gather(ia, -1, ra_c) == k)
    rb = (k - ra).clamp(0, nb - 1)
    return torch.where(is_a, torch.gather(a, -1, ra_c),
                       torch.gather(b, -1, rb)).to(dtype)


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge sorted runs along the last dim (stable rank merge, ties to a,
    IEEE comparisons).  Leading dims are batch dims (one merge per row).

    The rows go to `kernels.merge_split.merge_runs` as ``(rows, n)``
    views (a copy only where the leading dims do not flatten into one
    stride): on a CPU tensor its plain version, `merge_sorted_reference`;
    on a CUDA tensor the merge kernel.
    """
    from repro_torch.kernels.merge_split import merge_runs  # local: cycle
    na, nb = a.shape[-1], b.shape[-1]
    if na == 0 or nb == 0:
        return torch.cat([a, b], dim=-1)
    lead = a.shape[:-1]
    out = merge_runs(a.reshape(-1, na), b.reshape(-1, nb))
    return out.view(*lead, na + nb)


def constraint_granule(mesh, policy: LocalisationPolicy,
                       num_workers: Optional[int], axis: Axis) -> int:
    """The constraint backend's padding granule: a chunk per worker, and,
    under static mapping, every merge level's run size divisible by the
    axis size, so no level falls back to a replicated layout.  Without a
    mesh the tree has 8 workers, as in the reference."""
    m = num_workers or (axis_size(mesh, axis) if mesh is not None else 8)
    if mesh is not None and policy.static_mapping:
        return m * axis_size(mesh, axis)
    return m


def check_pad_outside_trace(n: int, granule: int, mesh, axis: Axis,
                            where: str) -> None:
    """The reference's guard for padding inside a trace, kept as a
    contract: on a mesh with homes outside `axis`, a direct call of
    `distributed_merge_sort` takes only granular lengths (the reference's
    partitioner mis-compiles the padding there).  The entry points
    (`make_sort_fn`, `Locale.workload`) pad eagerly and never trip it."""
    if mesh is None or n % granule == 0:
        return
    if mesh.size > axis_size(mesh, axis):
        raise ValueError(
            f"{where}: input length {n} needs sentinel padding to a multiple "
            f"of {granule}, but mesh axes outside {axis!r} have size > 1. "
            f"Pre-pad with pad_to_multiple(x, {granule}), or call through "
            f"make_sort_fn / Locale.workload, which pad eagerly.")


def stable_zeros(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Give the zeros of `y`, rows of `x` sorted on the total-order key,
    the order a stable IEEE sort gives them (in place, returns `y`).

    The key puts every ``-0.0`` before every ``+0.0``; the reference's
    ``jnp.sort`` is stable and ties the two, keeping input order.  The
    zeros of a sorted row are one block at the same place in both orders,
    so the block is overwritten with the row's input zeros in input order
    (a boolean-mask compaction, row-major over all rows at once).
    """
    if x.dtype.is_floating_point:
        y[y == 0] = x[x == 0]
    return y


def _row_sort(runs: torch.Tensor, local_sort: Optional[Callable]):
    """The leaves: sort the last dim of `runs` as ``jnp.sort`` does.
    Default: the port's row sort (`kernels.ops.local_sort`: the kernel on
    the card, its plain version on the CPU) with `stable_zeros`."""
    if local_sort is not None:
        return local_sort(runs)
    from repro_torch.kernels import ops   # local: ops imports this module
    rows = runs.reshape(-1, runs.shape[-1]).contiguous()
    return stable_zeros(rows, ops.local_sort(rows)).view(runs.shape)


def _constrain_runs(runs: torch.Tensor, layout: Optional[Layout], mesh,
                    policy: LocalisationPolicy, axis: Axis = "data"):
    """Relayout the (count, size) run matrix per policy, between tree
    levels; returns ``(runs, layout)``.  ``layout=None`` is a plain tensor
    (chunked).

    Non-static or mesh-less: nothing moves.  Localised: runs homed on
    their leaders' homes (chunked) while the runs outnumber the homes,
    else each run chunked over the homes.  Non-localised hash homing:
    every run striped element-wise.  Non-localised local homing (cases 2
    and 4): replicated, the reference's ``P(None, None)`` -- one copy per
    home, counted as an all-gather, and the work after it runs over the m
    copies, a leading dim of `runs`, as the non-localised engine body does
    every home's replicated work.
    """
    if mesh is None or not policy.static_mapping:
        return runs, layout
    N = axis_size(mesh, axis)
    count, size = runs.shape[-2:]
    if not policy.localised and policy.homing == Homing.LOCAL_CHUNKED:
        dst = Layout("replicated", N)
    elif policy.localised:
        dst = (Layout("chunked", N) if count % N == 0 else
               Layout("runs", N, count) if size % N == 0 else
               Layout("replicated", N))
    elif size % N == 0:
        dst = Layout("interleaved", N)
    else:
        return runs, layout
    return relayout(runs, mesh, dst, layout), dst


def distributed_merge_sort(x: torch.Tensor, mesh=None,
                           policy: LocalisationPolicy = LocalisationPolicy(),
                           num_workers: Optional[int] = None,
                           local_sort: Optional[Callable] = None,
                           axis: Axis = "data") -> torch.Tensor:
    """Sort a 1-D tensor with an m-worker merge tree (m = #homes of `axis`,
    8 without a mesh), on the device it lies on.

    Arbitrary lengths: the input is padded with BIG sentinels to a
    multiple of `constraint_granule` and the padding stripped after the
    tree.  Float inputs must be NaN-free.  The merge tree is the stable
    IEEE rank merge `merge_sorted`, as in the reference: one `merge_runs`
    launch a level on the card.
    """
    n = x.shape[0]
    m = num_workers or (axis_size(mesh, axis) if mesh is not None else 8)
    if m < 1 or m & (m - 1):
        raise ValueError(f"num_workers={m} must be a power of two")
    granule = constraint_granule(mesh, policy, num_workers, axis)
    check_pad_outside_trace(n, granule, mesh, axis, "distributed_merge_sort")
    x = pad_to_multiple(x, granule)
    runs = x.reshape(m, x.shape[0] // m)
    runs, lay = _constrain_runs(runs, None, mesh, policy, axis)
    runs = _row_sort(runs, local_sort)                 # leaves of the tree
    runs, lay = _constrain_runs(runs, lay, mesh, policy, axis)
    while runs.shape[-2] > 1:
        merged = merge_sorted(runs[..., 0::2, :], runs[..., 1::2, :])
        runs, lay = _constrain_runs(merged, lay, mesh, policy, axis)
    out = runs[0] if lay is not None and lay.kind == "replicated" else runs
    return out[0][:n]


def make_sort_fn(mesh, policy, num_workers=None, local_sort=None,
                 backend: str = "constraint", axis="data",
                 local_phase: str = None, device=None):
    """Sort function for one Table-1 case: ``fn(x) -> sorted 1-D``.

    backend="constraint" (the default, as in the reference): the merge
    tree of `distributed_merge_sort`, relaid out between levels as the
    policy says.  backend="shard_map": the explicit per-home engine
    (`repro_torch.core.engine`).  The input is NaN-checked, moved to the
    mesh's device (without a mesh: `device`, default ``"cuda"``; the
    engine places only on its mesh) and padded eagerly.  ``local_sort=None`` picks the backend default (the
    row sort for the constraint tree, "bitonic" for the engine).  Callers
    normally reach this through `Locale.workload("sort", ...)`.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend == "shard_map":
        from repro_torch.core.engine import make_engine_fn  # local: cycle
        if mesh is None and device is not None:
            raise ValueError("backend='shard_map' places on its mesh; give "
                             "a HomeMesh(..., device=...) instead of device=")
        return make_engine_fn(mesh, policy, num_workers=num_workers,
                              local_sort=local_sort or "bitonic", axis=axis,
                              local_phase=local_phase)
    one_process(mesh, "the constraint backend")
    if local_phase not in (None, "reference"):
        raise ValueError(
            f"local_phase={local_phase!r} needs backend='shard_map' -- the "
            f"constraint tree's local phase is the reference's by nature")
    dev = entry_device(mesh, device)
    fn = functools.partial(distributed_merge_sort, mesh=mesh, policy=policy,
                           num_workers=num_workers, local_sort=local_sort,
                           axis=axis)
    granule = constraint_granule(mesh, policy, num_workers, axis)
    return sort_entry(fn, granule, dev)
