"""The collectives of the reference's per-device bodies, across ranks.

On a `RankMesh` every home is a ``torch.distributed`` rank, and the
collectives that the reference's ``shard_map`` bodies call become real
ones over the mesh's axis subgroups:

  ``all_to_all(x, mesh, axes)``       ``jax.lax.all_to_all``: block j of
                                      dim 0 goes to home j of `axes`
                                      (``dist.all_to_all_single``);
  ``ppermute(x, mesh, axis, perm)``   ``jax.lax.ppermute``: one
                                      ``dist.batch_isend_irecv`` with the
                                      partner on `axis` that `perm` names;
  ``all_gather(x, mesh, axes)``       ``jax.lax.all_gather(..., axis=0)``
                                      over the subgroup of `axes`.

Every call appends one record to this process's log (`collective_log`,
`reset_collectives`), the counterpart of the HLO collective list that the
reference's rules R1/R2 read: ``kind`` (the HLO opcode,
`engine.SCHEDULE_TO_HLO`), ``axes``, ``groups`` (the rank lists of every
group, or a collective-permute's ``[src, dst]`` pairs over the whole
mesh), ``mult`` (1), ``wire_bytes`` (the bytes this rank sent to other
ranks), ``inter_pod_bytes`` / ``intra_pod_bytes`` (the same bytes split
by whether the receiver sits in another pod, `mesh.POD_AXIS`) and
``staged_bytes``.

Transport: a tensor goes as its bytes (uint8), so every sort dtype takes
the same path.  On NCCL a CUDA tensor goes as it is.  gloo has no device
transport: there, and only in `_transport`, a CUDA tensor is staged
through pinned host buffers, and the bytes copied each way are counted
in ``staged_bytes``, never as wire bytes.  The backend is the process
group's, chosen by the caller; nothing switches backend on a failure.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.homing import Axis, axis_tuple

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
            staged: int) -> None:
    """Append one record: `sent` maps each receiving rank to the bytes
    this rank sent it (itself excluded)."""
    me = mesh.pod(mesh.rank)
    inter = sum(b for r, b in sent.items() if mesh.pod(r) != me)
    wire = sum(sent.values())
    LOG.append({"kind": kind, "axes": list(axes), "groups": groups,
                "mult": 1, "wire_bytes": wire, "inter_pod_bytes": inter,
                "intra_pod_bytes": wire - inter, "staged_bytes": staged})
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
        _record("all-to-all", mesh, axes, mesh.partition(axes), {}, 0)
        return x.clone()
    recv, staged = _transport(
        lambda r, s: dist.all_to_all_single(r, s, group=group), send,
        send.numel(), dist.get_backend(group))
    block = send.numel() // g
    _record("all-to-all", mesh, axes, mesh.partition(axes),
            {r: block for r in ranks if r != mesh.rank}, staged)
    return _view(recv, x)


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
        _record("collective-permute", mesh, (axis,), groups, {}, 0)
        return x.clone()

    def op(recv, s):
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, s, to),
                                         dist.P2POp(dist.irecv, recv, frm)]):
            w.wait()

    recv, staged = _transport(op, send, send.numel(), mesh.backend)
    _record("collective-permute", mesh, (axis,), groups,
            {to: send.numel()}, staged)
    return _view(recv, x)


def all_gather(x: torch.Tensor, mesh, axes: Axis) -> torch.Tensor:
    """Every home of `axes` receives every home's `x`: ``(g, *x.shape)``,
    stacked in the homes' linear order over `axes`."""
    axes = axis_tuple(axes)
    group, ranks = mesh.group(axes)
    g = len(ranks)
    send = _bytes(x)
    if g == 1:
        _record("all-gather", mesh, axes, mesh.partition(axes), {}, 0)
        return x[None].clone()
    recv, staged = _transport(
        lambda r, s: dist.all_gather_into_tensor(r, s, group=group), send,
        g * send.numel(), dist.get_backend(group))
    _record("all-gather", mesh, axes, mesh.partition(axes),
            {r: send.numel() for r in ranks if r != mesh.rank}, staged)
    return _view(recv, x, (g,))


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


def census(log: Sequence[Dict]) -> Dict[str, Dict]:
    """A log folded as `engine.collective_census` folds the schedule:
    ``{kind: {"count", "wire_bytes"}}``, this rank's bytes."""
    out: Dict[str, Dict] = {}
    for r in log:
        e = out.setdefault(r["kind"], {"count": 0, "wire_bytes": 0.0})
        e["count"] += r["mult"]
        e["wire_bytes"] += r["wire_bytes"] * r["mult"]
    return out


__all__ = ["all_to_all", "ppermute", "all_gather", "collective_log",
           "reset_collectives", "staged_bytes", "log_against_schedule",
           "census"]
