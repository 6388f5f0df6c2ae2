"""Distributed parallel merge sort — the paper's validation application.

Structure mirrors Algorithm 3: a local sort per worker followed by a
log2(N)-level merge tree.  The counterpart of `repro/core/sort.py`: the
sentinel padding, the NaN guard, the gather-form stable merge and the
backend dispatch.  Only the explicit engine (``backend="shard_map"``,
`repro_torch.core.engine`) is ported; the constraint backend is a later
slice (ROADMAP.md, "the constraint backend").
"""
from __future__ import annotations

import functools

import torch

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


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge sorted runs along the last dim (stable rank merge, ties to a).

    Gather form, as the reference: `ia` (each a-element's output position)
    is inverted with one more searchsorted, so every output element is
    read from a or b.  Leading dims are batch dims (one merge per row).
    Comparisons are IEEE (``-0.0 == +0.0``), through `torch.searchsorted`
    with ``side="left"``, so elements of `a` win ties.
    """
    na, nb = a.shape[-1], b.shape[-1]
    if na == 0 or nb == 0:
        return torch.cat([a, b], dim=-1)
    lead = a.shape[:-1]
    dev = a.device
    ia = (torch.arange(na, device=dev)
          + torch.searchsorted(b.contiguous(), a.contiguous(), side="left"))
    k = torch.arange(na + nb, device=dev).expand(*lead, na + nb).contiguous()
    ra = torch.searchsorted(ia, k, side="left")
    ra_c = ra.clamp(max=na - 1)
    is_a = (ra < na) & (torch.gather(ia, -1, ra_c) == k)
    rb = (k - ra).clamp(0, nb - 1)
    return torch.where(is_a, torch.gather(a, -1, ra_c),
                       torch.gather(b, -1, rb))


def make_sort_fn(mesh, policy, num_workers=None, local_sort=None,
                 backend: str = "constraint", axis="data",
                 local_phase: str = None):
    """Sort function for one Table-1 case.

    backend="shard_map": the explicit per-home engine
    (`repro_torch.core.engine`).  backend="constraint" is not ported yet and
    raises NotImplementedError.  Callers normally reach this through
    `Locale.workload("sort", ...)`.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend == "constraint":
        raise NotImplementedError(
            "backend='constraint' is not ported yet (ROADMAP.md Queue 1, "
            "'the constraint backend'); use backend='shard_map'")
    from repro_torch.core.engine import make_engine_fn   # local: avoid cycle
    return make_engine_fn(mesh, policy, num_workers=num_workers,
                          local_sort=local_sort or "bitonic", axis=axis,
                          local_phase=local_phase)
