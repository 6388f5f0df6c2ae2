"""The explicit per-home engine of the distributed merge sort.

The counterpart of `repro/core/engine.py` (the `shard_map` backend),
held on a `HomeMesh`: the m homes of the sort axes are the rows of one
``(m, chunk)`` tensor on one device, each collective of the reference is
the index operation it performs on those rows, and each per-device kernel
call is one launch over all m rows.  Per home, Algorithms 1-3:

  1. chunk ownership comes from `chunk_bounds` — after BIG padding every
     home owns one equal, contiguous logical chunk;
  2. the worker->home map is the mesh order (the engine *is* the static
     mapping; `policy.static_mapping` has no runtime-chosen analogue here);
  3. the log2(m)-level merge tree exchanges runs as `LocalisationPolicy`
     says:

       localised      — one-shot relayout into the locally-homed chunk
                        layout (the all-to-all, a block transpose of the
                        rows, when the input is hash-interleaved), ONE
                        `local_sort` launch over every home's chunk, then
                        the block-wise bitonic merge-split network of the
                        `exchange_network` descriptor: each substage pairs
                        home d with d XOR 2^j (the ppermute, a row gather)
                        and ends in ONE `merge_split` launch over all homes.
                        Hierarchical policies gather the n_pods chunks at
                        each home's inner index once per top stage (the pod
                        all-gather, a strided row view) and every home
                        replays the cross-pod merge-splits on them.
       non-localised  — every level gathers the whole array to every home
                        (m copies) and every home merges its copy there,
                        the replicated work that `exchange_schedule`
                        charges.

``local_phase`` selects the per-home compute: "kernel" (the counterpart of
the reference's "pallas": `local_sort` + `merge_split` kernels) or
"reference" (leaf `local_sort`, then the plain `merge_sorted` tree and
merge-everything-discard-half substages).  `LOCAL_PHASES` maps each to
the reference's name.  The trace spans of the reference's `engine.sort`
are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.homing import (Axis, Homing, axis_tuple, logical_view,
                                     to_layout)
from repro_torch.core.localisation import LocalisationPolicy, chunk_bounds
from repro_torch.core.mesh import HomeMesh
from repro_torch.core.sort import (bits_view, merge_sorted, pad_to_multiple,
                                   sort_entry, take)
from repro_torch.kernels import ops

AXIS = "data"

LocalSort = Union[str, Callable]

#: the port's local phases -> the reference's names for them
LOCAL_PHASES = {"kernel": "pallas", "reference": "reference"}


def resolve_local_phase(local_phase: Optional[str],
                        local_sort: LocalSort) -> str:
    """The ``local_phase`` contract, shared by the engine and the schedule.

    None auto-selects: "kernel" when the leaf sort is the default
    "bitonic", "reference" when a callable leaf sort was supplied (a
    callable cannot run inside the kernels).
    """
    if local_phase is None:
        return "kernel" if local_sort == "bitonic" else "reference"
    if local_phase not in LOCAL_PHASES:
        raise ValueError(f"unknown local_phase {local_phase!r}; "
                         f"want one of {tuple(LOCAL_PHASES)} (or None = auto)")
    if local_phase == "kernel" and callable(local_sort):
        raise ValueError(
            "local_phase='kernel' runs the whole local phase in the "
            "local_sort and merge_split kernels; a callable local_sort only "
            "applies to local_phase='reference'")
    return local_phase


def _axes_sizes(mesh: HomeMesh, axes: Tuple[str, ...]) -> Tuple[int, ...]:
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"axes {missing!r} are not axes of {mesh!r}")
    return tuple(mesh.shape[a] for a in axes)


def _axis_name(axes: Tuple[str, ...]):
    """The collective axis-name argument: bare name or tuple (linearised)."""
    return axes[0] if len(axes) == 1 else axes


def engine_granule(m: int, num_workers: Optional[int],
                   hash_homed: bool) -> int:
    """The engine's padding granule: the chunk must split into per-home
    leaves, and (when relaying out of the interleaved homing) into one
    all-to-all block per peer home."""
    w = num_workers or m
    if w % m or w & (w - 1):
        raise ValueError(f"num_workers={w} must be a power of two and a "
                         f"multiple of the {m} homes")
    return m * math.lcm(w // m, m if hash_homed else 1)


def _stride_axis(axes: Tuple[str, ...], sizes: Tuple[int, ...],
                 j: int) -> Tuple[str, int]:
    """Which mesh axis bit j of the linearised home index lives on.

    Row-major linearisation with power-of-two sizes means stride 2^j over
    the combined index toggles exactly one bit of exactly one axis's local
    index: returns (axis_name, local_stride).
    """
    bit = j
    for a, s in zip(reversed(axes), reversed(sizes)):
        la = s.bit_length() - 1
        if bit < la:
            return a, 1 << bit
        bit -= la
    raise ValueError(f"stride 2^{j} exceeds the {math.prod(sizes)}-device space")


def _leaf_sort(rows: torch.Tensor, local_sort: LocalSort) -> torch.Tensor:
    """Sort each leaf row: (k, leaf) -> (k, leaf).  "bitonic" is the
    `local_sort` kernel; a callable is applied as ``local_sort(rows)``."""
    if callable(local_sort):
        return local_sort(rows)
    if local_sort != "bitonic":
        raise ValueError(f"unknown local_sort {local_sort!r}")
    return ops.local_sort(rows)


def _merge_split(run: torch.Tensor, other: torch.Tensor,
                 keep_low: torch.Tensor) -> torch.Tensor:
    """The reference form of a compare-exchange: merge all 2C, keep half."""
    chunk = run.shape[-1]
    both = bits_view(merge_sorted(run, other))       # (rows, 2*chunk)
    return torch.where(keep_low[:, None], both[:, :chunk],
                       both[:, chunk:]).view(run.dtype)


# ---------------------------------------------------------------------------
# the exchange network, as data (a copy of the reference's descriptor)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NetExchange:
    """One pairwise compare-exchange substage: a ppermute + merge-split.

    `partner`/`keep_low` are the device-space view over all m linearised
    devices (partner[d] = d XOR 2^substage; keep_low[d] = low-half iff the
    bitonic direction bit says so); `axis`/`axis_stride`/`perm` are the
    on-axis routing of the reference's `lax.ppermute`.
    """
    stage: int                      # merge stage i (sorts runs of 2^(i+1))
    substage: int                   # j: global device-index bit toggled
    axis: str                       # mesh axis the ppermute runs over
    axis_stride: int                # stride on that axis's local index
    stride: int                     # global linearised stride == 2^substage
    perm: Tuple[Tuple[int, int], ...]   # on-axis (src, dst) pairs
    partner: Tuple[int, ...]        # device-space partner map (involution)
    keep_low: Tuple[bool, ...]      # device-space keep flag


@dataclass(frozen=True)
class NetReplay:
    """One cross-pod substage replayed locally per pod (hierarchical path).

    `pod_partner`/`pod_keep_low` index pod space (what the replay loop
    actually uses on the gathered rows); `partner`/`keep_low` are the
    equivalent device-space view — identical formulas to `NetExchange`,
    because toggling pod bit (substage - log_inner) of q toggles exactly
    bit `substage` of d = q * m_inner + inner.
    """
    stage: int
    substage: int
    stride: int                     # global stride == 2^substage >= m_inner
    pod_partner: Tuple[int, ...]
    pod_keep_low: Tuple[bool, ...]
    partner: Tuple[int, ...]
    keep_low: Tuple[bool, ...]


@dataclass(frozen=True)
class NetGatherReplay:
    """One hierarchical top stage: ONE all_gather over the pod axes, then
    the stage's cross-pod substages replayed per pod on the gathered rows,
    each device finally keeping its own pod's chunk."""
    stage: int
    axes: Union[str, Tuple[str, ...]]   # outer (pod) axes gathered over
    replays: Tuple[NetReplay, ...]


@dataclass(frozen=True)
class ExchangeNetwork:
    """The localised engine's full exchange plan for one (policy, mesh).

    `levels` holds `NetExchange` / `NetGatherReplay` entries in execution
    order; `substages()` flattens to the device-space compare-exchange
    sequence (the thing the 0-1 principle certifies).  `relayout` records
    whether the plan starts with the hash-homing all_to_all.
    """
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    m: int
    hier: bool
    relayout: bool
    levels: Tuple[Union[NetExchange, NetGatherReplay], ...]

    def substages(self):
        """Device-space compare-exchanges (NetExchange | NetReplay), in order."""
        for lv in self.levels:
            if isinstance(lv, NetGatherReplay):
                for rp in lv.replays:
                    yield rp
            else:
                yield lv


def _keep_low(m: int, i: int, j: int) -> np.ndarray:
    """Bitonic keep flags over device space: device d keeps the low half of
    the merged pair iff its low/high role (bit j) matches the run's
    direction (bit i+1)."""
    d = np.arange(m)
    ascending = ((d >> (i + 1)) & 1) == 0
    is_low = ((d >> j) & 1) == 0
    return is_low == ascending


def exchange_network(policy: LocalisationPolicy, sizes: Sequence[int],
                     axes: Optional[Sequence[str]] = None) -> ExchangeNetwork:
    """The merge-split network descriptor for one (policy, mesh-slice).

    `sizes` are the sort-axis sizes in axis order, inner (ICI) last —
    the same contract as `exchange_schedule`; `axes` the matching mesh axis
    names (synthesised as ax0.. when only the shape matters, e.g. for
    certification).  Raises ValueError for non-localised policies (their
    all_gather levels have no merge-split network to describe) and for a
    hierarchical policy on a single-axis shape — identical validation to
    `shard_map_sort`, so a descriptor exists exactly when the engine would
    run the network.
    """
    sizes = tuple(int(s) for s in sizes)
    if axes is None:
        axes = tuple(f"ax{k}" for k in range(len(sizes)))
    axes = tuple(axes)
    if len(axes) != len(sizes):
        raise ValueError(f"axes {axes!r} do not match sizes {sizes!r}")
    for a, s in zip(axes, sizes):
        if s < 1 or (s & (s - 1)) != 0:
            raise ValueError(f"axis {a!r} size {s} not a power of 2")
    if not policy.localised:
        raise ValueError(
            f"policy {policy.name!r} is non-localised: every level is an "
            f"all_gather full exchange — there is no merge-split network")
    hier = policy.outer is not None
    if hier and len(sizes) < 2:
        raise ValueError(
            f"hierarchical policy {policy.name!r} needs (pod, ..., inner) "
            f"axis sizes, got {sizes!r} — same contract as shard_map_sort")
    m = math.prod(sizes)
    m_inner = sizes[-1]
    log_inner = m_inner.bit_length() - 1
    n_pods = m // m_inner
    d = np.arange(m)
    levels: List[Union[NetExchange, NetGatherReplay]] = []
    for i in range(m.bit_length() - 1):
        j0 = i
        if hier and i >= log_inner:
            q = np.arange(n_pods)
            replays = []
            for j in range(i, log_inner - 1, -1):
                t = 1 << (j - log_inner)            # pod-index stride
                pod_keep = ((((q >> (j - log_inner)) & 1) == 0)
                            == (((q >> (i + 1 - log_inner)) & 1) == 0))
                replays.append(NetReplay(
                    stage=i, substage=j, stride=1 << j,
                    pod_partner=tuple(int(p) for p in q ^ t),
                    pod_keep_low=tuple(bool(b) for b in pod_keep),
                    partner=tuple(int(p) for p in d ^ (1 << j)),
                    keep_low=tuple(bool(b) for b in _keep_low(m, i, j))))
            levels.append(NetGatherReplay(
                stage=i, axes=_axis_name(axes[:-1]), replays=tuple(replays)))
            j0 = log_inner - 1
        for j in range(j0, -1, -1):
            ax, t = _stride_axis(axes, sizes, j)
            na = sizes[axes.index(ax)]
            levels.append(NetExchange(
                stage=i, substage=j, axis=ax, axis_stride=t, stride=1 << j,
                perm=tuple((a, a ^ t) for a in range(na)),
                partner=tuple(int(p) for p in d ^ (1 << j)),
                keep_low=tuple(bool(b) for b in _keep_low(m, i, j))))
    return ExchangeNetwork(
        axes=axes, sizes=sizes, m=m, hier=hier,
        relayout=policy.homing == Homing.HASH_INTERLEAVED,
        levels=tuple(levels))


def exchange_schedule(n: int, sizes: Sequence[int],
                      policy: LocalisationPolicy,
                      num_workers: Optional[int] = None,
                      itemsize: int = 4,
                      local_phase: Optional[str] = None) -> List[Dict]:
    """The engine's full execution plan as per-level byte counts (Fig 9).

    `sizes` are the sort-axis sizes in axis order, inner (ICI) last — e.g.
    (2, 4) for a ("pod", "data") mesh slice.  Returns one record per
    collective *and* per local compute step, in execution order.  Every
    record carries ``level`` (0 = relayout/leaves, k = merge level k),
    ``op``, ``inter_pod_bytes`` / ``intra_pod_bytes`` (collective traffic,
    0 for local ops), ``local_hbm_bytes`` (HBM read+write traffic of the
    local compute, 0 for collectives) and ``local_merge_elems`` (merge
    output elements materialised — the "compute only what you keep" count).
    All totals are summed across devices; bytes are hardware-independent
    facts of the schedule, the measurable form of both halves of the
    paper's argument (exchange locality AND cache-resident local phase).

    ``local_phase`` prices the local records ("kernel" = one-pass
    `local_sort` + kept-half merge-splits, "reference" = device-memory
    materialising tree + merge-everything-discard-half; None = "kernel",
    the engine default).
    The collective records are identical under both phases.  Local cost
    model, per device and per step (B = chunk bytes, C = chunk elems,
    T = log2(w_per_dev) local tree levels):

      local_sort   kernel:    2B traffic (one read, one write), C elems
                   reference: 2B*(1+T) traffic (leaves + every tree level
                              re-materialised), C*(1+T) elems
      merge_split  kernel:    3B traffic (read both runs, write kept half),
                              C elems
                   reference: 7B traffic (read 2B, write the 2C merge,
                              re-read it, write the kept half), 2C elems

    Must mirror the per-home bodies below, and equals the reference's
    `exchange_schedule` record for record (the port's core tests).
    """
    sizes = tuple(sizes)
    m = math.prod(sizes)
    m_inner = sizes[-1]
    n_pods = m // m_inner
    w = num_workers or m
    hash_homed = policy.homing == Homing.HASH_INTERLEAVED
    hier = policy.outer is not None
    local_phase = resolve_local_phase(local_phase, "bitonic")
    if hier and len(sizes) < 2:
        raise ValueError(
            f"hierarchical policy {policy.name!r} needs (pod, ..., inner) "
            f"axis sizes, got {sizes!r} — same contract as shard_map_sort")
    granule = engine_granule(m, num_workers, hash_homed)
    n_p = n + (-n) % granule
    chunk = n_p // m                                # one chunk, in elements
    B = chunk * itemsize                            # one chunk, in bytes
    log_inner = m_inner.bit_length() - 1
    kernel = local_phase == "kernel"
    out: List[Dict] = []

    def rec(level, op, inter, intra, hbm=0, elems=0):
        out.append({"level": level, "op": op,
                    "inter_pod_bytes": inter, "intra_pod_bytes": intra,
                    "local_hbm_bytes": hbm, "local_merge_elems": elems})

    def merge_split_rec(level, rows):
        """One network substage: every device merge-splits `rows` runs."""
        rec(level, "merge_split", 0, 0,
            hbm=(3 if kernel else 7) * m * rows * B,
            elems=(1 if kernel else 2) * m * rows * chunk)

    if not policy.localised:
        # leaf gather + one full gather per merge level: every device
        # re-reads everything it doesn't hold, at every level.  The local
        # work (each device sorts/merges the whole gathered array) is
        # always the reference tree — its levels are interleaved with the
        # gathers, so there is nothing for the fused kernel to keep
        # resident; ``local_phase`` changes nothing here.
        for lvl in range(w.bit_length()):
            rec(lvl, "all_gather",
                m * (m - m_inner) * B, m * (m_inner - 1) * B)
            rec(lvl, "local_sort" if lvl == 0 else "merge", 0, 0,
                hbm=2 * m * n_p * itemsize, elems=m * n_p)
        return out

    if hash_homed:
        # one-shot relayout: each device sends m-1 of its m chunk-blocks
        rec(0, "all_to_all",
            m * (m - m_inner) * (B // m), m * (m_inner - 1) * (B // m))
    tree = max(0, (w // m).bit_length() - 1)        # local merge-tree levels
    rec(0, "local_sort", 0, 0,
        hbm=2 * n_p * itemsize * (1 if kernel else 1 + tree),
        elems=n_p * (1 if kernel else 1 + tree))
    for i in range(m.bit_length() - 1):
        j0 = i
        if hier and i >= log_inner:
            rec(i + 1, "all_gather", m * (n_pods - 1) * B, 0)
            for _ in range(i, log_inner - 1, -1):
                # cross-pod substage replayed per pod on the gathered rows
                merge_split_rec(i + 1, n_pods)
            j0 = log_inner - 1
        for j in range(j0, -1, -1):
            cross = (1 << j) >= m_inner
            rec(i + 1, "ppermute", m * B if cross else 0,
                0 if cross else m * B)
            merge_split_rec(i + 1, 1)
    return out


#: exchange_schedule op name -> HLO collective opcode
SCHEDULE_TO_HLO = {"all_to_all": "all-to-all", "all_gather": "all-gather",
                   "ppermute": "collective-permute"}


def collective_census(n: int, sizes: Sequence[int],
                      policy: LocalisationPolicy,
                      num_workers: Optional[int] = None,
                      itemsize: int = 4,
                      local_phase: Optional[str] = None) -> Dict[str, Dict]:
    """The analytic collective budget, keyed by HLO opcode.

    Folds `exchange_schedule`'s per-level records into per-device totals:
    ``{hlo_kind: {"count": executions, "wire_bytes": bytes sent per
    device}}``.  Schedule bytes are summed across devices; the per-device
    wire share (total / m) is what each of the reference's collectives
    moves.  Equal to the reference's `collective_census`.
    """
    m = math.prod(tuple(sizes))
    out: Dict[str, Dict] = {}
    for r in exchange_schedule(n, sizes, policy, num_workers=num_workers,
                               itemsize=itemsize, local_phase=local_phase):
        kind = SCHEDULE_TO_HLO.get(r["op"])
        if kind is None:
            continue                       # local compute record
        e = out.setdefault(kind, {"count": 0, "wire_bytes": 0.0})
        e["count"] += 1
        e["wire_bytes"] += (r["inter_pod_bytes"] + r["intra_pod_bytes"]) / m
    return out


# ---------------------------------------------------------------------------
# the per-home bodies, vectorised over homes
# ---------------------------------------------------------------------------
@lru_cache(maxsize=64)
def _net_on_device(net: ExchangeNetwork, device: torch.device) -> tuple:
    """The network's routing as index tensors on `device`, built once per
    (network, device) instead of uploaded at every substage of every call.

    One entry per level: a NetExchange gives ``(partner, keep)``; a
    NetGatherReplay gives ``(gather, ((partner, keep), ...), own)``, where
    `gather` picks each home's n_pods rows of the pod all-gather, each
    replay pairs the gathered rows, and `own` picks every home's pod back.
    """
    m, m_inner = net.m, net.sizes[-1]
    n_pods = m // m_inner
    d = np.arange(m)

    def on(a):
        return torch.as_tensor(np.asarray(a), device=device)

    out = []
    for lv in net.levels:
        if isinstance(lv, NetGatherReplay):
            gather = d[:, None] % m_inner + m_inner * np.arange(n_pods)
            replays = tuple(
                (on((d[:, None] * n_pods
                     + np.asarray(rp.pod_partner)).reshape(-1)),
                 on(np.tile(rp.pod_keep_low, m)))
                for rp in lv.replays)
            own = d * n_pods + (d // m_inner)
            out.append((on(gather.reshape(-1)), replays, on(own)))
        else:
            out.append((on(lv.partner), on(lv.keep_low)))
    return tuple(out)


def _localised_shard(rows: torch.Tensor, *, m: int, chunk: int,
                     w_per_dev: int, hash_homed: bool, local_sort: LocalSort,
                     net: ExchangeNetwork, local_phase: str) -> torch.Tensor:
    """Per-home body, localised, over all homes at once: (m, chunk) rows in
    the input homing -> (m, chunk) sorted chunk-contiguous rows."""
    if hash_homed:
        # Algorithm 2's memcpy, the all-to-all: block j of home s goes to
        # home j, stacked by source (order scrambled; the sort fixes it)
        rows = rows.view(m, m, chunk // m).transpose(0, 1).reshape(m, chunk)
    if local_phase == "kernel":
        # ONE launch sorts every home's chunk: leaves and local merge tree
        run = ops.local_sort(rows)
        merge_split = ops.merge_split
    else:
        runs = _leaf_sort(rows.reshape(m * w_per_dev, chunk // w_per_dev),
                          local_sort).view(m, w_per_dev, -1)
        while runs.shape[1] > 1:          # merge my own leaves, no traffic
            runs = merge_sorted(runs[:, 0::2], runs[:, 1::2])
        run = runs[:, 0]
        merge_split = _merge_split
    # block-wise bitonic merge-split network, routed from the descriptor
    for lv, route in zip(net.levels, _net_on_device(net, rows.device)):
        if isinstance(lv, NetGatherReplay):
            # the pod all-gather: home d receives the n_pods chunks at its
            # inner index; every home replays this stage's cross-pod
            # merge-splits on its copy (one launch over all m * n_pods
            # rows), then keeps its own pod's chunk
            gather, replays, own = route
            pods = take(run, gather)
            for partner, keep in replays:
                pods = merge_split(pods, take(pods, partner), keep)
            run = take(pods, own)
        else:
            # the ppermute: home d receives its partner d ^ 2^j's chunk
            partner, keep = route
            run = merge_split(run, take(run, partner), keep)
    return run


def _unlocalised_shard(rows: torch.Tensor, *, w: int, homing: Homing,
                       local_sort: LocalSort) -> torch.Tensor:
    """Per-home body, non-localised: runs stay home-pinned between levels.

    Every level gathers the whole array to every home (m copies of it),
    each home does the level's merges on its copy and keeps only its own
    home shard, in the input homing.  The merge work is replicated across
    homes, as in the reference: without ownership there is no cheap way
    to partition it, which is the paper's point.  The leaves of all m
    copies are one `local_sort` launch, each merge level one batched merge.
    """
    m, chunk = rows.shape
    n_p = m * chunk
    d = torch.arange(m, device=rows.device)

    def gather(rows):                   # every home receives every shard
        return logical_view(rows, homing).expand(m, n_p)

    def scatter(full):                  # home d keeps its shard of copy d
        if homing == Homing.LOCAL_CHUNKED:
            return take(full.view(m, m, chunk), (d, d))
        return take(full.view(m, chunk, m), (d, slice(None), d))

    runs = _leaf_sort(gather(rows).reshape(m * w, n_p // w), local_sort)
    rows = scatter(runs.view(m, n_p))
    k = w
    while k > 1:                        # one full exchange a level
        runs = gather(rows).reshape(m, k, n_p // k)
        rows = scatter(merge_sorted(runs[:, 0::2], runs[:, 1::2])
                       .reshape(m, n_p))
        k //= 2
    return rows


def shard_map_sort(x: torch.Tensor, mesh: HomeMesh,
                   policy: LocalisationPolicy = LocalisationPolicy(),
                   num_workers: Optional[int] = None,
                   local_sort: LocalSort = "bitonic", axis: Axis = AXIS,
                   local_phase: Optional[str] = None) -> torch.Tensor:
    """Sort a 1-D tensor on the mesh's homes; returns the logical order.

    ``local_phase`` selects the per-home compute (see the module
    docstring): "kernel", "reference", or None = auto by ``local_sort``.
    """
    local_phase = resolve_local_phase(local_phase, local_sort)
    axes = axis_tuple(axis)
    sizes = _axes_sizes(mesh, axes)
    n = x.shape[0]
    m = math.prod(sizes)
    w = num_workers or m
    hash_homed = policy.homing == Homing.HASH_INTERLEAVED
    if policy.outer is not None and len(axes) < 2:
        raise ValueError(
            f"hierarchical policy {policy.name!r} needs a (pod, ..., inner) "
            f"axis tuple, got {axis!r} — use a flat policy on one axis")

    granule = engine_granule(m, num_workers, hash_homed)
    x = pad_to_multiple(x, granule)
    n_p = x.shape[0]
    bounds = chunk_bounds(n_p, m)                  # ownership, paper step 1
    chunk = bounds[0][1] - bounds[0][0]
    rows = to_layout(x, mesh, policy.homing, axes)

    if policy.localised:
        y = _localised_shard(rows, m=m, chunk=chunk, w_per_dev=w // m,
                             hash_homed=hash_homed, local_sort=local_sort,
                             net=exchange_network(policy, sizes, axes),
                             local_phase=local_phase)
        out_homing = Homing.LOCAL_CHUNKED          # chunk-contiguous output
    else:
        y = _unlocalised_shard(rows, w=w, homing=policy.homing,
                               local_sort=local_sort)
        out_homing = policy.homing                 # output stays home-pinned
    return logical_view(y, out_homing)[:n]


def make_engine_fn(mesh: Optional[HomeMesh], policy: LocalisationPolicy,
                   num_workers: Optional[int] = None,
                   local_sort: LocalSort = "bitonic", axis: Axis = AXIS,
                   local_phase: Optional[str] = None):
    """The engine sort for one Table-1 case: ``fn(x) -> sorted 1-D``.

    ``x`` is a 1-D tensor or array; it is NaN-checked, moved to the mesh's
    device, padded and sorted, and the result stays on that device.
    ``mesh=None`` is one home on the default device (``"cuda"``).
    """
    resolve_local_phase(local_phase, local_sort)    # fail fast, not at call
    if mesh is None:
        a = axis if isinstance(axis, str) else axis[-1]
        mesh = HomeMesh({a: 1})
        axis = a
    axes = axis_tuple(axis)
    m = math.prod(_axes_sizes(mesh, axes))
    hash_homed = policy.homing == Homing.HASH_INTERLEAVED
    granule = engine_granule(m, num_workers, hash_homed)
    fn = partial(shard_map_sort, mesh=mesh, policy=policy,
                 num_workers=num_workers, local_sort=local_sort, axis=axis,
                 local_phase=local_phase)
    return sort_entry(fn, granule, mesh.device)
