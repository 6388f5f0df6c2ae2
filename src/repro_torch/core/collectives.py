"""The collectives of the reference's per-device bodies, across ranks.

On a `RankMesh` every home is a ``torch.distributed`` rank, and the
collectives that the reference's ``shard_map`` bodies call become real
ones over the mesh's axis subgroups:

  ``all_to_all(x, mesh, axes)``       ``jax.lax.all_to_all``: block j of
                                      dim 0 goes to home j of `axes`
                                      (``dist.all_to_all_single``);
  ``all_to_all_v(x, mesh, axes, s, r)`` the uneven form, a relayout's
                                      move between two layouts
                                      (`homing.relayout`): s[j] elements
                                      to home j, r[i] from home i;
  ``ppermute(x, mesh, axis, perm)``   ``jax.lax.ppermute``: one
                                      ``dist.batch_isend_irecv`` with the
                                      partner on `axis` that `perm` names;
  ``all_gather(x, mesh, axes)``       ``jax.lax.all_gather(..., axis=0)``
                                      over the subgroup of `axes`;
  ``psum(x, mesh, axes)``             ``jax.lax.psum``: an all-gather of
                                      the summands, summed in home
                                      order (the same bits on every
                                      rank);
  ``reduce_scatter(x, mesh, axes)``   ``jax.lax.psum_scatter`` over dim
                                      0: one all-to-all of dim-0 blocks,
                                      each home's block summed in home
                                      order (``psum(x)`` sliced, bit for
                                      bit).

Training differentiates through them (`Enter`, `Exit`, `AllReduce`,
`Gather`, `Scatter`, below): each is a ``torch.autograd.Function`` whose backward is
itself a counted collective, Megatron's f/g pair and the sequence and
FSDP gathers.

Every call appends one record to this process's log (`collective_log`,
`reset_collectives`), the counterpart of the HLO collective list that the
reference's rules R1/R2 read: ``kind`` (the HLO opcode,
`engine.SCHEDULE_TO_HLO`), ``axes``, ``groups`` (the rank lists of every
group, or a collective-permute's ``[src, dst]`` pairs over the whole
mesh), ``mult`` (1), ``wire_bytes`` (the bytes this rank sent to other
ranks), ``inter_pod_bytes`` / ``intra_pod_bytes`` (the same bytes split
by whether the receiver sits in another pod, `mesh.POD_AXIS`),
``staged_bytes`` and ``payload_bytes`` (the bytes of this rank's operand,
which every rank of the group passes alike; None for `all_to_all_v`,
whose counts differ by rank).  Rule R11 (`analysis.livecheck`) holds the
ranks' logs to one sequence.

Transport: a tensor goes as its bytes (uint8), so every sort dtype takes
the same path.  On NCCL a CUDA tensor goes as it is.  gloo has no device
transport: there, and only in `_transport`, a CUDA tensor is staged
through pinned host buffers, and the bytes copied each way are counted
in ``staged_bytes``, never as wire bytes.  The backend is the process
group's, chosen by the caller; nothing switches backend on a failure.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.mesh import Axis, axis_tuple

#: this process's collective records since the last `reset_collectives`
LOG: List[Dict] = []

#: bytes staged between a CUDA tensor and pinned host memory for gloo
STAGED: Dict[str, int] = {"bytes": 0}


def reset_collectives() -> None:
    LOG.clear()
    STAGED["bytes"] = 0


def collective_log() -> List[Dict]:
    """The records since the last `reset_collectives`, in call order."""
    return [dict(r) for r in LOG]


def staged_bytes() -> int:
    """Bytes staged through pinned host memory since the last reset."""
    return STAGED["bytes"]


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """`x`'s bytes as a contiguous 1-D uint8 tensor."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _transport(op: Callable, send: torch.Tensor, recv_numel: int,
               backend: str) -> Tuple[torch.Tensor, int]:
    """Run ``op(recv, send)`` on uint8 buffers; returns ``(recv on send's
    device, staged bytes)``.

    The one place a CUDA tensor is staged: on gloo it is copied into a
    pinned host buffer, the op runs on host buffers, and the result is
    copied back to the card.
    """
    if send.is_cuda and backend == "gloo":
        host_send = torch.empty(send.numel(), dtype=torch.uint8,
                                pin_memory=True)
        host_send.copy_(send)
        host_recv = torch.empty(recv_numel, dtype=torch.uint8,
                                pin_memory=True)
        op(host_recv, host_send)
        recv = torch.empty(recv_numel, dtype=torch.uint8, device=send.device)
        recv.copy_(host_recv)
        return recv, send.numel() + recv_numel
    recv = torch.empty(recv_numel, dtype=torch.uint8, device=send.device)
    op(recv, send)
    return recv, 0


def _record(kind: str, mesh, axes, groups, sent: Dict[int, int],
            staged: int, payload: Optional[int]) -> None:
    """Append one record: `sent` maps each receiving rank to the bytes
    this rank sent it (itself excluded); `payload` is the operand's
    bytes."""
    me = mesh.pod(mesh.rank)
    inter = sum(b for r, b in sent.items() if mesh.pod(r) != me)
    wire = sum(sent.values())
    LOG.append({"kind": kind, "axes": list(axes), "groups": groups,
                "mult": 1, "wire_bytes": wire, "inter_pod_bytes": inter,
                "intra_pod_bytes": wire - inter, "staged_bytes": staged,
                "payload_bytes": payload})
    STAGED["bytes"] += staged


def _view(flat: torch.Tensor, like: torch.Tensor, lead=()) -> torch.Tensor:
    """uint8 bytes back as `like`'s dtype and shape, after `lead` dims."""
    return flat.view(like.dtype).view(*lead, *like.shape)


def all_to_all(x: torch.Tensor, mesh, axes: Axis) -> torch.Tensor:
    """Block j of `x`'s dim 0 (``g`` equal blocks, g the homes of `axes`)
    goes to home j; returns the g received blocks stacked by source."""
    axes = axis_tuple(axes)
    group, ranks = mesh.group(axes)
    g = len(ranks)
    if x.shape[0] != g:
        raise ValueError(f"all_to_all over {axes!r} takes dim 0 = {g} "
                         f"blocks, got shape {tuple(x.shape)}")
    send = _bytes(x)
    if g == 1:
        _record("all-to-all", mesh, axes, mesh.partition(axes), {}, 0,
                send.numel())
        return x.clone()
    recv, staged = _transport(
        lambda r, s: dist.all_to_all_single(r, s, group=group), send,
        send.numel(), dist.get_backend(group))
    block = send.numel() // g
    _record("all-to-all", mesh, axes, mesh.partition(axes),
            {r: block for r in ranks if r != mesh.rank}, staged,
            send.numel())
    return _view(recv, x)


def all_to_all_v(x: torch.Tensor, mesh, axes: Axis,
                 send_counts: Sequence[int],
                 recv_counts: Sequence[int]) -> torch.Tensor:
    """The uneven all-to-all: the 1-D `x` holds, in order, ``send_counts[j]``
    elements for home j of `axes` (itself included); returns the
    ``recv_counts[i]`` elements from each home i, stacked by source.  Both
    counts come from the layout maps, the same on every rank, so no
    sizes are exchanged (one ``dist.all_to_all_single`` with splits)."""
    axes = axis_tuple(axes)
    group, ranks = mesh.group(axes)
    if len(send_counts) != len(ranks) or sum(send_counts) != x.numel():
        raise ValueError(f"all_to_all_v over {axes!r}: {list(send_counts)} "
                         f"for {len(ranks)} homes, {x.numel()} elements")
    item = x.element_size()
    send = _bytes(x)
    if len(ranks) == 1:
        _record("all-to-all", mesh, axes, mesh.partition(axes), {}, 0, None)
        return x.reshape(-1).clone()
    out_splits = [int(c) * item for c in recv_counts]
    in_splits = [int(c) * item for c in send_counts]
    recv, staged = _transport(
        lambda r, s: dist.all_to_all_single(r, s, out_splits, in_splits,
                                            group=group),
        send, sum(out_splits), dist.get_backend(group))
    _record("all-to-all", mesh, axes, mesh.partition(axes),
            {r: b for r, b in zip(ranks, in_splits) if r != mesh.rank},
            staged, None)
    return recv.view(x.dtype)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`perm`'s ``(src, dst)`` pairs on `axis`'s index: this rank sends
    `x` to the rank at its destination and receives from its source, in
    one ``batch_isend_irecv``.  Returns what it received."""
    pairs = [(int(s), int(d)) for s, d in perm]
    c = mesh.coords[axis]
    dst = [d for s, d in pairs if s == c]
    src = [s for s, d in pairs if d == c]
    if len(dst) != 1 or len(src) != 1:
        raise ValueError(f"perm {pairs} on axis {axis!r} must send and "
                         f"receive exactly once at index {c}")
    to = mesh.rank_at({axis: dst[0]})
    frm = mesh.rank_at({axis: src[0]})
    groups = [[r, mesh.rank_at({axis: d}, base=r)]
              for r in range(mesh.size) for s, d in pairs
              if mesh.coords_of(r)[axis] == s]
    send = _bytes(x)
    if to == mesh.rank and frm == mesh.rank:
        _record("collective-permute", mesh, (axis,), groups, {}, 0,
                send.numel())
        return x.clone()

    def op(recv, s):
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, s, to),
                                         dist.P2POp(dist.irecv, recv, frm)]):
            w.wait()

    recv, staged = _transport(op, send, send.numel(), mesh.backend)
    _record("collective-permute", mesh, (axis,), groups,
            {to: send.numel()}, staged, send.numel())
    return _view(recv, x)


def all_gather(x: torch.Tensor, mesh, axes: Axis) -> torch.Tensor:
    """Every home of `axes` receives every home's `x`: ``(g, *x.shape)``,
    stacked in the homes' linear order over `axes`."""
    axes = axis_tuple(axes)
    group, ranks = mesh.group(axes)
    g = len(ranks)
    send = _bytes(x)
    if g == 1:
        _record("all-gather", mesh, axes, mesh.partition(axes), {}, 0,
                send.numel())
        return x[None].clone()
    recv, staged = _transport(
        lambda r, s: dist.all_gather_into_tensor(r, s, group=group), send,
        g * send.numel(), dist.get_backend(group))
    _record("all-gather", mesh, axes, mesh.partition(axes),
            {r: send.numel() for r in ranks if r != mesh.rank}, staged,
            send.numel())
    return _view(recv, x, (g,))


def psum(x: torch.Tensor, mesh, axes: Axis) -> torch.Tensor:
    """The sum of every home's `x` over `axes` (``jax.lax.psum``, the
    all-reduce a sharding constraint over a contracted axis implies), on
    every home alike: one all-gather of the summands, then their sum in
    the homes' linear order (floats in float32, cast back to `x`'s
    dtype), so that every rank gets the same bits.  Logged as one
    ``"all-reduce"`` record with the all-gather's byte convention (as
    `optim.compressed_psum`'s wire): this rank sends its `x` to each of
    the other g - 1 homes, ``(g - 1) * x.nbytes`` wire bytes."""
    axes = axis_tuple(axes)
    group, ranks = mesh.group(axes)
    g = len(ranks)
    if g == 1:
        _record("all-reduce", mesh, axes, mesh.partition(axes), {}, 0,
                x.numel() * x.element_size())
        return x.clone()
    send = _bytes(x)
    recv, staged = _transport(
        lambda r, s: dist.all_gather_into_tensor(r, s, group=group), send,
        g * send.numel(), dist.get_backend(group))
    _record("all-reduce", mesh, axes, mesh.partition(axes),
            {r: send.numel() for r in ranks if r != mesh.rank}, staged,
            send.numel())
    parts = _view(recv, x, (g,))
    if not x.is_floating_point():
        return parts.sum(dim=0).to(x.dtype)
    total = parts[0].float()
    for i in range(1, g):
        total = total + parts[i].float()
    return total.to(x.dtype)


def reduce_scatter(x: torch.Tensor, mesh, axes: Axis) -> torch.Tensor:
    """The sum of every home's `x` over `axes`, of which each home keeps
    its block of dim 0 (``jax.lax.psum_scatter(..., tiled=True)``, HLO
    ``"reduce-scatter"``): one all-to-all of the ``g`` dim-0 blocks, then
    the g blocks received summed in the homes' linear order (floats in
    float32, cast back to `x`'s dtype), so a block has the bits of
    ``psum(x)``'s same block.  This rank sends each other home its block:
    ``(g - 1) / g * x.nbytes`` wire bytes, where `psum` sends ``(g - 1) *
    x.nbytes``."""
    axes = axis_tuple(axes)
    group, ranks = mesh.group(axes)
    g = len(ranks)
    if x.shape[0] % g:
        raise ValueError(f"reduce_scatter over {axes!r} takes dim 0 in {g} "
                         f"blocks, got shape {tuple(x.shape)}")
    if g == 1:
        _record("reduce-scatter", mesh, axes, mesh.partition(axes), {}, 0,
                x.numel() * x.element_size())
        return x.clone()
    send = _bytes(x)
    recv, staged = _transport(
        lambda r, s: dist.all_to_all_single(r, s, group=group), send,
        send.numel(), dist.get_backend(group))
    block = send.numel() // g
    _record("reduce-scatter", mesh, axes, mesh.partition(axes),
            {r: block for r in ranks if r != mesh.rank}, staged,
            send.numel())
    parts = _view(recv, x).view(g, x.shape[0] // g, *x.shape[1:])
    if not x.is_floating_point():
        return parts.sum(dim=0).to(x.dtype)
    total = parts[0].float()
    for i in range(1, g):
        total = total + parts[i].float()
    return total.to(x.dtype)


# ---------------------------------------------------------------------------
# the counted collectives under autograd
# ---------------------------------------------------------------------------
def _lead(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` with `dim` moved to the front, contiguous."""
    return x.movedim(dim, 0).contiguous() if dim else x.contiguous()


def gather_dim(x: torch.Tensor, mesh, axes: Axis, dim: int) -> torch.Tensor:
    """`all_gather` of every home's `x` over `axes`, concatenated along
    `dim` in the homes' linear order (no autograd)."""
    parts = all_gather(_lead(x, dim), mesh, axes)
    whole = parts.reshape(-1, *parts.shape[2:])
    return whole.movedim(0, dim) if dim else whole


def scatter_dim(x: torch.Tensor, mesh, axes: Axis, dim: int) -> torch.Tensor:
    """`reduce_scatter` of `x` over `axes` along `dim` (no autograd)."""
    part = reduce_scatter(_lead(x, dim), mesh, axes)
    return part.movedim(0, dim) if dim else part


class Enter(torch.autograd.Function):
    """Megatron's f: the identity forward, a `psum` of the gradient
    backward -- where a value every rank of `axes` holds whole enters a
    region whose ranks each compute a part (their heads, columns or
    experts), so each rank's gradient of it is a part of the whole."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class Exit(torch.autograd.Function):
    """Megatron's g: a `psum` forward (a row-parallel product's partial
    sums), the identity backward (the gradient of a value every rank
    holds whole is already whole)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllReduce(torch.autograd.Function):
    """A `psum` both ways: a statistic every rank of `axes` needs whole,
    summed from the parts each rank computes from its own columns (the
    Mamba2 gated norm's sum of squares over ``d_inner``).  Every rank
    uses the whole sum, so each rank's gradient of it is a part of the
    whole gradient, which every part's gradient is: neither Megatron's f
    (`Enter`) nor g (`Exit`)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return psum(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class Gather(torch.autograd.Function):
    """`all_gather` along `dim` forward; `reduce_scatter` along `dim`
    backward: the gathered value feeds each rank's part of a computation,
    so each rank's gradient of it is a partial sum, and the sum of the
    parts, cut to this rank's block, is its block's gradient.  The
    sequence gather of the sequence-sharded residual and the FSDP gather
    of a parameter."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class Scatter(torch.autograd.Function):
    """`reduce_scatter` along `dim` forward (partial sums, each rank
    keeping its block: the row-parallel output onto the sequence-sharded
    residual); `all_gather` along `dim` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return scatter_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def log_against_schedule(log: Sequence[Dict], schedule: Sequence[Dict],
                         m: int) -> List[str]:
    """Where a rank's collective log differs from `exchange_schedule`'s
    collective records, op for op: the kind (as an HLO opcode) and the
    rank's wire, inter-pod and intra-pod bytes against the record's ÷ m,
    exactly.  Returns the differences (empty when they agree)."""
    from repro_torch.core.engine import SCHEDULE_TO_HLO   # local: cycle
    want = [r for r in schedule if r["op"] in SCHEDULE_TO_HLO]
    out = []
    if len(log) != len(want):
        out.append(f"{len(log)} collectives logged, the schedule has "
                   f"{len(want)}")
    for i, (got, w) in enumerate(zip(log, want)):
        exp = {"kind": SCHEDULE_TO_HLO[w["op"]],
               "inter_pod_bytes": w["inter_pod_bytes"] / m,
               "intra_pod_bytes": w["intra_pod_bytes"] / m,
               "wire_bytes": (w["inter_pod_bytes"] + w["intra_pod_bytes"])
               / m}
        bad = {k: (got[k], v) for k, v in exp.items() if got[k] != v}
        if bad:
            out.append(f"collective {i} (level {w['level']} {w['op']}): "
                       + ", ".join(f"{k} {a} != {b}"
                                   for k, (a, b) in bad.items()))
    return out


def log_against_moves(log: Sequence[Dict], moves: Sequence[Dict], d: int,
                      sizes: Sequence[int]) -> List[str]:
    """Where a rank's collective log differs from `sort.constraint_schedule`
    op for op, the rank at home d of homes of `sizes` (outer first; with
    more than one axis, the homes that share every outer coordinate
    share a pod): the kind and the wire, inter-pod and intra-pod bytes,
    row d of each move's ``send_counts`` off its diagonal, exactly.
    Returns the differences (empty when they agree)."""
    inner = sizes[-1] if len(sizes) > 1 else math.prod(sizes)
    out = []
    if len(log) != len(moves):
        out.append(f"{len(log)} collectives logged, the schedule has "
                   f"{len(moves)}")
    for i, (got, w) in enumerate(zip(log, moves)):
        row = [int(c) * w["itemsize"] for c in w["send_counts"][d]]
        inter = sum(b for j, b in enumerate(row) if j // inner != d // inner)
        intra = sum(row) - row[d] - inter
        exp = {"kind": w["collective"], "wire_bytes": inter + intra,
               "inter_pod_bytes": inter, "intra_pod_bytes": intra}
        bad = {k: (got[k], v) for k, v in exp.items() if got[k] != v}
        if bad:
            out.append(f"collective {i} (level {w['level']} {w['move']} "
                       f"{w['src']} -> {w['dst']}): " + ", ".join(
                           f"{k} {a} != {b}" for k, (a, b) in bad.items()))
    return out


def census(log: Sequence[Dict]) -> Dict[str, Dict]:
    """A log folded as `engine.collective_census` folds the schedule:
    ``{kind: {"count", "wire_bytes"}}``, this rank's bytes."""
    out: Dict[str, Dict] = {}
    for r in log:
        e = out.setdefault(r["kind"], {"count": 0, "wire_bytes": 0.0})
        e["count"] += r["mult"]
        e["wire_bytes"] += r["wire_bytes"] * r["mult"]
    return out


__all__ = ["all_to_all", "all_to_all_v", "ppermute", "all_gather", "psum",
           "reduce_scatter", "gather_dim", "scatter_dim", "Enter", "Exit",
           "AllReduce", "Gather", "Scatter",
           "collective_log", "reset_collectives", "staged_bytes",
           "log_against_schedule", "log_against_moves", "census"]
