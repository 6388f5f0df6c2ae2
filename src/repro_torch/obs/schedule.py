"""The analytic lists of a rank's serving and training collectives.

`serve_schedule(cfg, plan, calls)` gives, in order, the collectives that
one rank of a `DecodeServer` across ranks makes for the model calls it
listed (``srv.calls``: prefill, decode and page steps with their rows
and tokens a row, and each greedy pick), from the plan alone: the
counterpart for serving of `engine.exchange_schedule` and
`sort.constraint_schedule`.  `log_against_serve` holds a rank's
`collectives.collective_log` to it op for op.  Every record is a
model-axis sum (a Mamba2 member's norm statistic too), a pick, a count
of expert choices or, where the plan homes the decode cache by
sequence, a decode step's merge of the blocks' attention partials (and
the all-gather of q before it with the cache over "model"): none
carries a KV cache, which never crosses ranks (a session that lands off
its home is recomputed there, as in the reference).

`train_schedule(cfg, plan, shape)` does the same for one train step
across ranks (`models.steps.make_train_step` on a `RankMesh`): the
microbatch relayout, each microbatch's forward (the FSDP gathers, the
sequence gathers and reduce-scatters, a Mamba2 member's norm statistic,
the MoE's counts, the loss's "model" combine) and backward (the recompute's collectives again under
remat, each collective's transpose, the FSDP reduce-scatters), then the
gradient buckets' sums (a reduce-scatter and an all-gather each), the
loss's sum over the homes, the norm's sum
over the mesh and ZeRO-1's parameter gathers; `log_against_train` holds a
rank's log of one step to it.

Kept apart from `obs.reconcile`, which stays a copy of the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from repro_torch.configs.base import ArchConfig

#: the prefill's MoE group size (`moe.apply_moe`'s default)
PREFILL_GROUP = 2048


def _record(kind: str, axes, nbytes: int, plan) -> Dict:
    """This rank's record of a collective over `axes` that sends its
    `nbytes` to each other home of the group (all-gather and psum)."""
    mesh = plan.mesh
    g = math.prod(mesh.shape[a] for a in axes)
    in_pod = math.prod(mesh.shape[a] for a in axes if a != "pod")
    wire = (g - 1) * nbytes
    inter = (g - in_pod) * nbytes
    return {"kind": kind, "axes": list(axes), "wire_bytes": wire,
            "inter_pod_bytes": inter, "intra_pod_bytes": wire - inter}


def serve_schedule(cfg: ArchConfig, plan, calls: Sequence[Dict]) -> List[Dict]:
    """The collectives, in order, of the model calls `calls` on one rank
    of `plan`'s `RankMesh` (records of `_record`'s form: kind, axes, wire,
    inter- and intra-pod bytes).  A prefill on a plan with ``seq_axis``
    (made for a prefill shape) carries the residual sequence-sharded, as
    training does: each member gathers the sequence and reduce-scatters
    its sums back, and the last position is gathered for the head."""
    from repro_torch.models.attention import rank_heads
    from repro_torch.models.blocks import num_superblocks, superblock_spec
    from repro_torch.sharding.partition import homes_of, seq_split, tp_of
    par = getattr(torch, cfg.param_dtype).itemsize
    act = getattr(torch, cfg.dtype).itemsize
    M, n = tp_of(plan)[0], homes_of(plan)[0]
    tp, homes = (plan.tp,), tuple(plan.batch_axes or ())
    members = superblock_spec(cfg)
    D, K, E, hd = cfg.d_model, cfg.top_k, cfg.num_experts, cfg.head_dim
    rh = rank_heads(cfg, plan) if any(m.mixer != "mamba"
                                      for m in members) else None
    out: List[Dict] = []
    for c in calls:
        r, S = c["rows"], c["seq"]
        if c["call"] == "pick":
            if M > 1:
                out.append(_record("all-gather", tp, r * S * 2 * 8, plan))
            if n > 1:
                out.append(_record("all-gather", homes, r * S * 8, plan))
            continue
        Ms = seq_split(plan)[0] if c["call"] == "prefill" else 1
        x = r * S * D * act               # a (rows, seq, D) activation sum
        shard = r * (S // Ms) * D * act   # the rank's rows of it

        def summed():                     # a member's sum over "model"
            return (_record("reduce-scatter", tp, shard, plan) if Ms > 1
                    else _record("all-reduce", tp, x, plan))
        if M > 1 and cfg.embed_input:     # the lookup's sum, in its dtype
            emb = r * S * D * par
            out.append(_record("reduce-scatter", tp, emb // Ms, plan)
                       if Ms > 1 else _record("all-reduce", tp, emb, plan))
        group = PREFILL_GROUP if c["call"] == "prefill" else r * n
        for _ in range(num_superblocks(cfg)):
            for m in members:
                if Ms > 1:
                    out.append(_record("all-gather", tp, shard, plan))
                if m.mixer == "mamba":
                    if M > 1:
                        out.append(_record("all-reduce", tp, r * S * 4, plan))
                        out.append(summed())
                else:
                    if m.mixer == "attn" and c["call"] != "prefill" \
                            and rh.seq[0] > 1:
                        out += _merge_records(rh, plan, r, S, hd, act)
                    if M > 1 and rh.split:
                        out.append(summed())
                if m.ffn != "none" and Ms > 1:
                    out.append(_record("all-gather", tp, shard, plan))
                if m.ffn == "mlp" and M > 1:
                    out.append(summed())
                elif m.ffn == "moe":
                    T = r * S * n
                    gs = min(group, T)
                    if n > 1 and (r * S) % gs:
                        out.append(_record("all-gather", homes,
                                           (T // gs) * K * E * 4, plan))
                    if M > 1:
                        out.append(summed())
                        if cfg.num_shared_experts:
                            out.append(summed())
        if Ms > 1:
            out.append(_record("all-gather", tp, r * D * act, plan))
    return out


def _merge_records(rh, plan, r: int, S: int, hd: int, act: int
                   ) -> List[Dict]:
    """A decode step's collectives over a cache homed by sequence
    (`models.attention._decode_blocks`): the float32 partials (hd + 2
    numbers a query and head) all-gathered over the cache's axis, or,
    with ``by_head``, every head's q all-gathered over "model" and the
    partials sent to their heads' ranks by one all-to-all."""
    cax = (plan.cache_seq_axis,)
    part = r * rh.H * S * (hd + 2) * 4
    if rh.by_head:
        return [_record("all-gather", cax, r * S * rh.H * hd * act, plan),
                _record("all-to-all", cax, part, plan)]
    return [_record("all-gather", cax, part, plan)]


def log_against_serve(log: Sequence[Dict], schedule: Sequence[Dict]
                      ) -> List[str]:
    """Where a rank's collective log differs from its `serve_schedule`,
    op for op: the kind, the axes and the wire, inter- and intra-pod
    bytes, exactly.  Returns the differences (empty when they agree)."""
    out = []
    if len(log) != len(schedule):
        out.append(f"{len(log)} collectives logged, the schedule has "
                   f"{len(schedule)}")
    for i, (got, want) in enumerate(zip(log, schedule)):
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            out.append(f"collective {i}: " + ", ".join(
                f"{k} {a} != {b}" for k, (a, b) in bad.items()))
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _member_fwd(m, cfg, plan, r: int, S: int, n: int, act: int,
                train_moe: bool = True) -> List[Dict]:
    """One member's forward collectives on `r` home rows of `S` tokens."""
    from repro_torch.sharding.partition import seq_split, tp_of
    from repro_torch.models.attention import rank_heads
    M = tp_of(plan)[0]
    Ms = seq_split(plan)[0]
    tp = (plan.tp,)
    D = cfg.d_model
    shard = r * (S // Ms) * D * act           # a (r, S/Ms, D) activation
    whole = r * S * D * act
    out: List[Dict] = []
    if m.mixer == "mamba":
        split = M > 1
        stat = [_record("all-reduce", tp, r * S * 4, plan)] if split else []
    else:
        split = rank_heads(cfg, plan)[3] if M > 1 else False
        stat = []
    if Ms > 1:
        out.append(_record("all-gather", tp, shard, plan))
        out += stat
        if split:
            out.append(_record("reduce-scatter", tp, shard, plan))
    elif split:
        out += stat
        out.append(_record("all-reduce", tp, whole, plan))
    if m.ffn == "none":
        return out
    if Ms > 1:
        out.append(_record("all-gather", tp, shard, plan))
    if m.ffn == "moe" and n > 1:
        T = r * S * n
        gs = min(PREFILL_GROUP, T)
        out.append(_record("all-gather", tuple(plan.batch_axes),
                           (T // gs) * cfg.top_k * cfg.num_experts * 4, plan))
    if M > 1:
        sums = 1 + (m.ffn == "moe" and bool(cfg.num_shared_experts))
        for _ in range(sums):
            out.append(_record("reduce-scatter", tp, shard, plan)
                       if Ms > 1 else
                       _record("all-reduce", tp, whole, plan))
    return out


def _member_bwd(m, cfg, plan, r: int, S: int, act: int) -> List[Dict]:
    """One member's backward collectives (ffn, then mixer): each forward
    collective's transpose (a Mamba2 norm statistic's all-reduce is its
    own)."""
    from repro_torch.sharding.partition import seq_split, tp_of
    from repro_torch.models.attention import rank_heads
    M = tp_of(plan)[0]
    Ms = seq_split(plan)[0]
    tp = (plan.tp,)
    shard = r * (S // Ms) * cfg.d_model * act
    whole = r * S * cfg.d_model * act
    out: List[Dict] = []
    if M == 1:
        return out
    if m.ffn != "none":
        if Ms > 1:
            sums = 1 + (m.ffn == "moe" and bool(cfg.num_shared_experts))
            out += [_record("all-gather", tp, shard, plan)] * sums
            out.append(_record("reduce-scatter", tp, shard, plan))
        else:
            out.append(_record("all-reduce", tp, whole, plan))
    if m.mixer == "mamba":
        split, stat = True, [_record("all-reduce", tp, r * S * 4, plan)]
    else:
        split, stat = rank_heads(cfg, plan)[3], []
    if Ms > 1:
        if split:
            out.append(_record("all-gather", tp, shard, plan))
        out += stat
        out.append(_record("reduce-scatter", tp, shard, plan))
    elif split:
        out += stat
        out.append(_record("all-reduce", tp, whole, plan))
    return out


def _fsdp_gathers(tree, plan, cfg) -> List[Dict]:
    """The FSDP all-gathers of a (sub)tree of rank blocks, in its order:
    one a cut dim of each leaf FSDP cuts (`partition.gather_leaf`)."""
    from repro_torch.sharding.partition import (_map_paths, _at,
                                                param_specs, split_dims)
    if not plan.fsdp_axes or plan.axis_size(plan.fsdp_axes) == 1:
        return []
    specs = param_specs(tree, plan, cfg)
    out: List[Dict] = []

    def visit(path, leaf):
        for _, axes in split_dims(_at(specs, path), plan.mesh):
            over = tuple(a for a in axes if a in plan.fsdp_axes)
            if over:
                out.append(_record("all-gather", over, leaf.numel()
                                   * leaf.element_size(), plan))
        return leaf
    _map_paths(visit, tree)
    return out


def _as_scatters(gathers: List[Dict]) -> List[Dict]:
    """The backward of FSDP gathers: reduce-scatters of the same bytes,
    in reverse order."""
    return [dict(rec, kind="reduce-scatter") for rec in reversed(gathers)]


def _relayout(plan, shape, m: int, leaf_bytes: Dict[str, int]) -> List[Dict]:
    """`models.steps._micro_split`'s all-to-alls, one a batch leaf (in key
    order), `leaf_bytes` the bytes of one row of each."""
    import numpy as np
    from repro_torch.sharding.partition import homes_of, micro_home
    mesh = plan.mesh
    n, h = homes_of(plan)
    GB = shape.global_batch
    b = GB // n
    sends = np.bincount(micro_home(np.arange(h * b, (h + 1) * b), GB, m, n),
                        minlength=n)
    group = mesh.group(tuple(plan.batch_axes))[1]
    out = []
    for key in sorted(leaf_bytes):
        sent = {group[j]: int(c) * leaf_bytes[key] for j, c in
                enumerate(sends) if group[j] != mesh.rank}
        me = mesh.pod(mesh.rank)
        inter = sum(v for rk, v in sent.items() if mesh.pod(rk) != me)
        wire = sum(sent.values())
        out.append({"kind": "all-to-all", "axes": list(plan.batch_axes),
                    "wire_bytes": wire, "inter_pod_bytes": inter,
                    "intra_pod_bytes": wire - inter})
    return out


def train_schedule(cfg: ArchConfig, plan, shape) -> List[Dict]:
    """The collectives, in order, of one train step on this rank of
    `plan`'s `RankMesh` (records of `_record`'s form), the global batch
    and sequence of `shape` (`configs.base.ShapeSpec`), with AdamW's
    clipping on (`optim.AdamW`'s default)."""
    from repro_torch.models.blocks import num_superblocks, superblock_spec
    from repro_torch.models.common import MetaGen
    from repro_torch.models.model import LM
    from repro_torch.models.steps import RankGrads
    from repro_torch.convert import rank_cut
    from repro_torch.sharding.partition import (homes_of, micro_rows,
                                                seq_split, tp_of)
    from repro_torch.tree import tree_items
    par = getattr(torch, cfg.param_dtype).itemsize
    act = getattr(torch, cfg.dtype).itemsize
    M, _ = tp_of(plan)
    Ms = seq_split(plan)[0]
    n = homes_of(plan)[0]
    mb = max(cfg.parallel.microbatches, 1)
    GB, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    r = micro_rows(GB, mb, plan)             # this home's rows a microbatch
    tp = (plan.tp,)
    params = LM(cfg).init(MetaGen(), cut=rank_cut(plan, cfg, train=True))
    members = superblock_spec(cfg)
    sb = _unstack(params["stack"])
    sb_gathers = _fsdp_gathers(sb, plan, cfg)
    fwd_sb = list(sb_gathers)
    for m in members:
        fwd_sb += _member_fwd(m, cfg, plan, r, S, n, act)
    bwd_members = []
    for m in reversed(members):
        bwd_members += _member_bwd(m, cfg, plan, r, S, act)
    # under remat the recompute runs at the first saved tensor the
    # backward unpacks: after the transpose of the last member's output
    # reduce-scatter (which saves nothing), unless a MoE member's aux loss
    # (whose backward unpacks at once) is differentiated first
    pre = 0
    if cfg.parallel.remat and Ms > 1 \
            and not any(m.ffn == "moe" for m in members):
        pre = 1
    if cfg.parallel.remat:
        bwd_sb = bwd_members[:pre] + fwd_sb + bwd_members[pre:]
    else:
        bwd_sb = list(bwd_members)
    bwd_sb += _as_scatters(sb_gathers)

    out: List[Dict] = []
    if mb > 1 and n > 1:
        row = {"targets": S * 4}
        if cfg.embed_input:
            row["tokens"] = S * 4
        else:
            row["embeds"] = S * D * 4
        if cfg.family == "vlm":
            row["image_embeds"] = cfg.num_image_tokens * D * 4
        out += _relayout(plan, shape, mb, row)
    embed_g = _fsdp_gathers(params["embed"], plan, cfg) \
        if cfg.embed_input else []
    head_g = _fsdp_gathers(params["head"], plan, cfg)
    nsb = num_superblocks(cfg)
    for _ in range(mb):
        out += embed_g
        if cfg.embed_input and M > 1:
            out.append(_record("reduce-scatter", tp, r * (S // Ms) * D * par,
                               plan) if Ms > 1 else
                       _record("all-reduce", tp, r * S * D * par, plan))
        out += fwd_sb * nsb
        if Ms > 1:
            out.append(_record("all-gather", tp, r * (S // Ms) * D * act,
                               plan))
        out += head_g
        if M > 1:
            out.append(_record("all-gather", tp, r * S * 2 * 4, plan))
        # backward
        out += _as_scatters(head_g)
        if Ms > 1:
            out.append(_record("reduce-scatter", tp, r * (S // Ms) * D * act,
                               plan))
        elif M > 1:
            out.append(_record("all-reduce", tp, r * S * D * act, plan))
        out += bwd_sb * nsb
        if cfg.embed_input and Ms > 1:
            out.append(_record("all-gather", tp, r * (S // Ms) * D * par,
                               plan))
        out += _as_scatters(embed_g)
    # the step's reductions (`steps.RankGrads.reduce`), the loss, the norm
    grads = RankGrads(params, plan, cfg)
    leaves = [leaf for _, leaf in tree_items(params)]
    gsize = (getattr(torch, cfg.parallel.accum_dtype).itemsize
             if mb > 1 and not cfg.parallel.accum_via_scan_grad else None)
    buckets: Dict[tuple, int] = {}
    for leaf, axes in zip(leaves, grads.axes):
        if axes:
            key = (axes, gsize or leaf.element_size())
            buckets[key] = buckets.get(key, 0) + leaf.numel()
    for (axes, item), numel in buckets.items():
        k = plan.axis_size(axes)
        block = -(-numel // k) * item
        out.append(_record("reduce-scatter", axes, block, plan))
        out.append(_record("all-gather", axes, block, plan))
    if n > 1:
        out.append(_record("all-reduce", tuple(plan.batch_axes), mb * 4,
                           plan))
    out.append(_record("all-reduce", tuple(plan.mesh.shape), 4, plan))
    z = grads.leaves
    for i, leaf in enumerate(leaves):
        d = z.zero1_dims[i]
        if d is not None:
            k = math.prod(plan.mesh.shape[a] for a in z.zero1)
            out.append(_record("all-gather", z.zero1, leaf.numel()
                               * leaf.element_size() // k, plan))
    return out


def _unstack(stack):
    """One superblock's leaves (shapes) of a stacked tree."""
    if isinstance(stack, dict):
        return {k: _unstack(v) for k, v in stack.items()}
    return stack[0]


def log_against_train(log: Sequence[Dict], schedule: Sequence[Dict]
                      ) -> List[str]:
    """Where a rank's collective log of one train step differs from its
    `train_schedule`, op for op (as `log_against_serve`)."""
    return log_against_serve(log, schedule)
