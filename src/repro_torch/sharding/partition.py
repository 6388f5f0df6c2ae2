"""Static partitioning rules: the counterpart of `repro/sharding/
partition.py`.

`make_plan` resolves the same placement plan as the reference's, field
for field, for a mesh of homes on one device (`HomeMesh`) or of
``torch.distributed`` ranks (`RankMesh`).  A spec is a tuple with one
entry per dimension -- None (whole), an axis name, or a tuple of axis
names linearised row-major -- the counterpart of ``PartitionSpec``;
`param_specs`, `opt_specs`, `full_opt_specs`, `batch_specs` and
`cache_specs` build them for a tree as the reference builds its ``P``
trees, `shard_for_rank` cuts a whole tree down to one rank's blocks, and
`gather_leaf`/`cut_leaf` move one leaf between its whole and a spec's
block (FSDP, ZeRO-1, checkpoints).

What reads a plan:

* On a `HomeMesh` every home lies on one device, so only ``batch_axes``
  matters: the server homes its slots over them (`Locale.pin_tree`'s
  counted relayout); the model runs whole.
* On a `RankMesh` the model is split over ``"model"`` where the plan
  says (`tp_of`): heads and KV heads (`models.attention`, cross
  attention too), MLP columns (`models.common`), experts or their F
  columns (`models.moe`), the Mamba2 heads and their ``d_inner``
  columns (`models.mamba2`, the gated norm's statistic summed by
  `psum_stat`), the vocabulary (`models.model`), each followed by a
  counted sum (`core.collectives`).  Every other axis is data-parallel:
  each (pod, data) coordinate is a home holding its own batch or slot
  rows.
* Serving cuts the parameters with ``fsdp_axes`` and ``zero1_axes``
  cleared (`serving_plan`), as the reference never shards parameters
  over the data axes when it serves; its decode plan has no
  ``seq_axis``, and a prefill on a plan made for a prefill shape carries
  the residual sequence-sharded, as training does.  Where it sets ``cache_seq_axis`` (caches of 8192
  positions or more whose batch does not divide over the homes, or
  whose KV heads do not divide over "model") each rank keeps a block of
  the self-attention cache's slots (`cache_block`) and decode merges
  the blocks' partial softmaxes (`models.attention`).
* Training reads the whole plan: the residual stream between members
  sequence-sharded over ``seq_axis`` (`seq_split`; the members gather it
  and scatter their outputs, `enter_region`/`exit_region`), parameters
  cut over ``fsdp_axes`` and gathered a superblock at a time
  (`fsdp_gather`), AdamW's ``m`` and ``v`` cut further over
  ``zero1_axes`` (`opt_specs`), gradients reduced as `models.steps` says.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.mesh import RankMesh


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolved placement plan for one (arch x shape x mesh) cell."""

    mesh: Optional[object]
    dp: Tuple[str, ...] = ()          # data-parallel axes, e.g. ("pod", "data")
    tp: Optional[str] = None          # tensor-parallel axis ("model")
    # resolved per-cell decisions (None == replicate on that dim):
    batch_axes: Optional[Tuple[str, ...]] = None
    seq_axis: Optional[str] = None    # SP axis for the residual stream
    head_axis: Optional[str] = None
    kv_axis: Optional[str] = None
    expert_axis: Optional[str] = None
    fsdp_axes: Optional[Tuple[str, ...]] = None
    cache_seq_axis: Optional[object] = None  # str | tuple | None
    zero1_axes: Optional[Tuple[str, ...]] = None

    def axis_size(self, name) -> int:
        if self.mesh is None or name is None:
            return 1
        names = (name,) if isinstance(name, str) else name
        return math.prod(self.mesh.shape.get(a, 1) for a in names)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp) if self.dp else 1

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp) if self.tp else 1


NULL_PLAN = MeshPlan(mesh=None)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def make_plan(mesh, cfg: ArchConfig, shape: ShapeSpec) -> MeshPlan:
    """Resolve the static placement plan for one cell: the reference's
    decisions (`repro/sharding/partition.py:73-111`) on `mesh`'s axes."""
    if mesh is None:
        return NULL_PLAN
    names = tuple(mesh.shape)
    dp = tuple(a for a in names if a != "model")
    tp = "model"
    tp_n = mesh.shape.get(tp, 1)
    dp_n = math.prod(mesh.shape[a] for a in dp)

    batch_axes = dp if _div(shape.global_batch, dp_n) else None
    seq_len = shape.seq_len if shape.kind != "decode" else 1
    seq_axis = (tp if (cfg.parallel.sequence_shard and _div(seq_len, tp_n)
                       and shape.kind != "decode") else None)
    head_axis = tp if _div(cfg.num_heads, tp_n) else None
    kv_axis = tp if _div(cfg.num_kv_heads, tp_n) else None
    expert_axis = tp if _div(cfg.num_experts, tp_n) else None
    fsdp_axes = dp if (cfg.parallel.fsdp and _div(cfg.d_model, dp_n)) else None
    zero1_axes = dp if (cfg.parallel.zero1 and _div(cfg.d_model, dp_n)) else None

    cache_len = (min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window
                 else shape.seq_len)
    cache_seq_axis = None
    if shape.kind == "decode":
        if batch_axes is None and cache_len >= 8192:
            cache_seq_axis = "data" if "data" in names else None
        elif kv_axis is None and cache_len >= 8192:
            cache_seq_axis = tp
    return MeshPlan(mesh=mesh, dp=dp, tp=tp, batch_axes=batch_axes,
                    seq_axis=seq_axis, head_axis=head_axis, kv_axis=kv_axis,
                    expert_axis=expert_axis, fsdp_axes=fsdp_axes,
                    cache_seq_axis=cache_seq_axis, zero1_axes=zero1_axes)


def serving_plan(plan: MeshPlan) -> MeshPlan:
    """`plan` with ``fsdp_axes`` and ``zero1_axes`` cleared: serving keeps
    every parameter whole over the data axes (the reference never calls
    `param_specs` when it serves)."""
    return dataclasses.replace(plan, fsdp_axes=None, zero1_axes=None)


def tp_of(plan: Optional[MeshPlan]) -> Tuple[int, int]:
    """``(model-axis size, this rank's index on it)`` where the plan's mesh
    is a `RankMesh`; ``(1, 0)`` otherwise (a `HomeMesh` lies on one
    device, so nothing is split)."""
    if plan is None or not isinstance(plan.mesh, RankMesh) \
            or plan.tp_size == 1:
        return 1, 0
    return plan.tp_size, plan.mesh.index((plan.tp,))


def homes_of(plan: Optional[MeshPlan]) -> Tuple[int, int]:
    """``(homes over the batch axes, this rank's home)`` where the plan's
    mesh is a `RankMesh` and homes the batch; ``(1, 0)`` otherwise."""
    if plan is None or not isinstance(plan.mesh, RankMesh) \
            or not plan.batch_axes:
        return 1, 0
    return plan.axis_size(plan.batch_axes), plan.mesh.index(plan.batch_axes)


def micro_home(rows, global_batch: int, m: int, n: int):
    """The home of each of the global batch's `rows` (indices) in its
    microbatch of ``GB / m`` rows over `n` homes: blocks of
    ``ceil(GB / (m n))`` rows in home order, as GSPMD pads a dim the axes
    do not divide, so the last homes' blocks may be short or empty."""
    size = global_batch // m
    return (rows % size) // -(-size // n)


def micro_rows(global_batch: int, m: int, plan: Optional[MeshPlan]) -> int:
    """This rank's home's rows of each of the `m` microbatches of
    `global_batch` rows (`micro_home`; ``GB / (m n)`` where the `n` homes
    of `homes_of` divide a microbatch)."""
    n, h = homes_of(plan)
    return int((micro_home(np.arange(global_batch // m), global_batch, m,
                           n) == h).sum())


def psum_model(x: torch.Tensor, plan: Optional[MeshPlan]) -> torch.Tensor:
    """`x` summed over the ranks of the model axis (`collectives.psum`;
    under autograd Megatron's g, `collectives.Exit`: the gradient of the
    sum every rank holds whole is each part's); `x` itself where nothing
    is split."""
    if tp_of(plan)[0] == 1:
        return x
    from repro_torch.core import collectives
    if torch.is_grad_enabled() and x.requires_grad:
        return collectives.Exit.apply(x, plan.mesh, (plan.tp,))
    return collectives.psum(x, plan.mesh, (plan.tp,))


def seq_split(plan: Optional[MeshPlan]) -> Tuple[int, int]:
    """``(model-axis size, this rank's index)`` where a whole-sequence
    call (training, prefill) shards the residual's sequence over
    ``seq_axis`` across ranks; ``(1, 0)`` otherwise."""
    M, i = tp_of(plan)
    if M == 1 or plan.seq_axis is None:
        return 1, 0
    return M, i


def enter_region(x: torch.Tensor, plan: Optional[MeshPlan],
                 split: bool = True) -> torch.Tensor:
    """The input of a member whose ranks each compute a part over
    "model", from the residual: under `seq_split` the whole sequence
    gathered from the shards (`collectives.Gather`: its gradient
    reduce-scattered back); otherwise, where the region is `split`,
    Megatron's f (`collectives.Enter`: the gradient summed).  `x` itself
    with nothing split."""
    from repro_torch.core import collectives
    M, _ = tp_of(plan)
    if M == 1:
        return x
    if seq_split(plan)[0] > 1:
        return collectives.Gather.apply(x, plan.mesh, (plan.tp,), 1)
    if split and torch.is_grad_enabled():
        return collectives.Enter.apply(x, plan.mesh, (plan.tp,))
    return x


def exit_region(y: torch.Tensor, plan: Optional[MeshPlan],
                split: bool = True) -> torch.Tensor:
    """A member's output back onto the residual: its partial sums over
    "model" (`split`) reduce-scattered onto this rank's sequence shard
    under `seq_split` (`collectives.Scatter`), else summed (`psum_model`,
    Megatron's g under autograd).  A whole output (`split` False: every
    rank computed all of it) is cut to the rank's rows under `seq_split`
    -- its gradient is this rank's rows only, a partial sum like the
    split members' -- and is itself otherwise."""
    M, i = seq_split(plan)
    if M > 1:
        if not split:
            S = y.shape[1] // M
            return y[:, i * S:(i + 1) * S]
        from repro_torch.core import collectives
        return collectives.Scatter.apply(y, plan.mesh, (plan.tp,), 1)
    return psum_model(y, plan) if split else y


def psum_stat(x: torch.Tensor, plan: Optional[MeshPlan]) -> torch.Tensor:
    """A statistic summed over the ranks of the model axis from the parts
    each rank computes from its own columns (the gated norm's sum of
    squares over ``d_inner``): `collectives.psum`, and under autograd
    `collectives.AllReduce`, whose backward sums the gradient too -- each
    rank's gradient of the whole statistic is a part.  `x` itself where
    nothing is split."""
    if tp_of(plan)[0] == 1:
        return x
    from repro_torch.core import collectives
    if torch.is_grad_enabled() and x.requires_grad:
        return collectives.AllReduce.apply(x, plan.mesh, (plan.tp,))
    return collectives.psum(x, plan.mesh, (plan.tp,))


def cache_seq(plan: Optional[MeshPlan]) -> Tuple[int, int]:
    """``(ranks, this rank's index)`` over the axis that homes the decode
    cache's sequence (``cache_seq_axis``) where the plan's mesh is a
    `RankMesh`; ``(1, 0)`` otherwise."""
    if plan is None or plan.cache_seq_axis is None \
            or not isinstance(plan.mesh, RankMesh):
        return 1, 0
    n = plan.axis_size(plan.cache_seq_axis)
    if n == 1:
        return 1, 0
    return n, plan.mesh.index(_axes(plan.cache_seq_axis))


def cache_block(slots: int, plan: Optional[MeshPlan]) -> Tuple[int, int]:
    """``(first slot, slots a block)`` of this rank's block of a cache of
    `slots` positions homed by sequence (`cache_seq`): blocks of
    ``ceil(slots / n)``, as GSPMD pads a dim the axis does not divide (the
    last block's tail beyond `slots` stays empty); ``(0, slots)``
    otherwise."""
    n, i = cache_seq(plan)
    blk = -(-slots // n)
    return i * blk, blk


# ---------------------------------------------------------------------------
# specs (path-name driven)
# ---------------------------------------------------------------------------
def P(*dims) -> tuple:
    """A spec, normalised as ``PartitionSpec`` normalises its entries: a
    tuple of one axis name is that name."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                 for d in dims)


def _leaf_spec(name: str, ndim: int, plan: MeshPlan, cfg: ArchConfig):
    tp, f = plan.tp, plan.fsdp_axes
    h, kv, e = plan.head_axis, plan.kv_axis, plan.expert_axis
    table = {
        "tok_embed": (tp, f),            # (Vp, D)
        "head_w": (f, tp),               # (D, Vp)
        "wq": (f, h, None),
        "wk": (f, kv, None),
        "wv": (f, kv, None),
        "wo": (h, None, f),
        "w_gate": (f, tp),
        "w_up": (f, tp),
        "w_down": (tp, f),
        "we_gate": (e, f, None) if e else (None, f, tp),
        "we_up": (e, f, None) if e else (None, f, tp),
        "we_down": (e, None, f) if e else (None, tp, f),
        "router": (None, None),
        "wz": (f, tp),
        "wx": (f, tp),
        "wBC": (f, None),
        "wdt": (f, tp),
        "conv_x": (None, tp),
        "conv_bc": (None, None),
        "out_proj": (tp, f),
    }
    spec = table.get(name)
    if spec is not None and len(spec) == ndim:
        return P(*spec)
    return (None,) * ndim


def _map_paths(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict/list/tuple tree, keeping its shape."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, plan: MeshPlan, cfg: ArchConfig):
    """A spec tree matching a parameter (or shape) tree.  Leaves under the
    ``stack`` subtree carry a leading superblock axis: their spec gets a
    None prepended."""
    def spec_for(path, leaf):
        stacked = "stack" in path
        ndim = len(leaf.shape) - (1 if stacked else 0)
        spec = _leaf_spec(str(path[-1]), ndim, plan, cfg)
        return (None, *spec) if stacked else spec
    return _map_paths(spec_for, params)


def batch_specs(batch, plan: MeshPlan):
    """Chunk-contiguous local homing: the batch dim owned per home."""
    return _map_paths(lambda _p, leaf: P(plan.batch_axes, *(
        (None,) * (len(leaf.shape) - 1))), batch)


def cache_specs(cache, plan: MeshPlan, cfg: ArchConfig):
    """The decode cache's layout (the reference's `cache_specs`)."""
    b, tp, kv, cseq = (plan.batch_axes, plan.tp, plan.kv_axis,
                       plan.cache_seq_axis)
    hs_ax = tp if (cfg.ssm_nheads and cfg.ssm_nheads % plan.tp_size == 0) \
        else None
    di_ax = tp if (cfg.d_inner and cfg.d_inner % max(plan.tp_size, 1) == 0) \
        else None

    def spec(path, leaf):
        name, nd = path[-1], len(leaf.shape)
        if name in ("k", "v"):
            is_cross = (leaf.shape[2] == cfg.num_image_tokens
                        and cfg.num_image_tokens)
            return P(None, b, None if is_cross else cseq, kv, None)
        if name == "kpos":
            return P(None, b, cseq) if nd == 3 else P(None, cseq)
        if name == "ssm":
            return P(None, b, hs_ax, None, None)
        if name == "conv_x":
            return P(None, b, None, di_ax)
        if name == "conv_bc":
            return P(None, b, None, None)
        return (None,) * nd
    return _map_paths(spec, cache)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_of(shape, spec, mesh: RankMesh):
    """The slices of `mesh`'s rank's block of a `shape` tensor under
    `spec`: dim i cut into ``prod(sizes of its axes)`` equal blocks, the
    rank's the one at its linear index over them."""
    out = []
    for n, entry in zip(shape, spec):
        axes = tuple(a for a in _axes(entry) if mesh.shape.get(a, 1) > 1)
        if not axes:
            out.append(slice(None))
            continue
        k = math.prod(mesh.shape[a] for a in axes)
        if n % k:
            raise ValueError(f"dim of {n} does not split over {axes} "
                             f"({k} blocks)")
        i = mesh.index(axes)
        out.append(slice(i * n // k, (i + 1) * n // k))
    return tuple(out)


def shard_for_rank(tree, specs, mesh: RankMesh):
    """Each leaf of `tree` cut to `mesh`'s rank's block under the matching
    spec of `specs` (a contiguous copy; a whole leaf stays itself)."""
    def cut(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        sl = block_of(leaf.shape, spec, mesh)
        if all(s == slice(None) for s in sl):
            return leaf
        return leaf[sl].contiguous()
    return _map_paths(cut, tree)


# ---------------------------------------------------------------------------
# optimiser-state specs
# ---------------------------------------------------------------------------
def _used(spec) -> set:
    return {a for d in spec for a in _axes(d)}


def zero1_dim(spec, shape, plan: MeshPlan) -> Optional[int]:
    """The dim ZeRO-1 cuts over ``zero1_axes`` in a leaf of `spec` and
    (whole) `shape`: the first dim with no axis that the dp size divides,
    where the spec has no dp axis at all (the reference's `opt_specs`);
    None otherwise."""
    if plan.zero1_axes is None:
        return None
    dims = list(spec) + [None] * (len(shape) - len(spec))
    if set(plan.zero1_axes) & _used(dims):
        return None
    dp_n = plan.axis_size(plan.zero1_axes)
    for i, (d, n) in enumerate(zip(dims, shape)):
        if d is None and n % dp_n == 0:
            return i
    return None


def opt_specs(params, plan: MeshPlan, cfg: ArchConfig):
    """Optimiser-state specs (the reference's `opt_specs`): ``m`` and ``v``
    mirror the parameters' specs; ZeRO-1 also cuts the first dp-free dim
    the dp size divides over ``zero1_axes``; ``step`` is replicated."""
    pspecs = param_specs(params, plan, cfg)

    def zero1(path, leaf):
        spec = _at(pspecs, path)
        i = zero1_dim(spec, leaf.shape, plan)
        if i is None:
            return spec
        dims = list(spec) + [None] * (len(leaf.shape) - len(spec))
        dims[i] = plan.zero1_axes
        return P(*dims)

    mv = _map_paths(zero1, params)
    return {"adam": {"m": mv, "v": mv, "step": P()}}


def full_opt_specs(opt_state, params, plan: MeshPlan, cfg: ArchConfig):
    """The spec tree of `models.steps.init_opt_state`'s structure: `opt_specs`
    and, where the state has an error-feedback residual, ``ef`` mirroring
    the parameters."""
    out = {"adam": opt_specs(params, plan, cfg)["adam"]}
    if "ef" in opt_state:
        out["ef"] = param_specs(params, plan, cfg)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# one leaf between its whole and a spec's block
# ---------------------------------------------------------------------------
def split_dims(spec, mesh: RankMesh):
    """``[(dim, axes)]``: each dim of `spec` cut over axes of size > 1."""
    out = []
    for i, entry in enumerate(spec):
        axes = tuple(a for a in _axes(entry) if mesh.shape.get(a, 1) > 1)
        if axes:
            out.append((i, axes))
    return out


def whole_shape(block_shape, spec, mesh: RankMesh) -> Tuple[int, ...]:
    """The whole leaf's shape from one rank's block under `spec`."""
    shape = list(block_shape)
    for i, axes in split_dims(spec, mesh):
        shape[i] *= math.prod(mesh.shape[a] for a in axes)
    return tuple(shape)


def owns(spec, mesh: RankMesh) -> bool:
    """Whether this rank is its block's owner: the rank at index 0 on
    every axis the block is replicated over (each axis of size > 1 that
    `spec` does not cut by)."""
    used = _used(spec)
    return all(mesh.coords[a] == 0 for a, n in mesh.shape.items()
               if n > 1 and a not in used)


def gather_leaf(block: torch.Tensor, spec, mesh: RankMesh,
                axes=None) -> torch.Tensor:
    """The leaf gathered from every home's block over `axes` (default
    every axis `spec` cuts by): one counted all-gather per cut dim,
    differentiable (`collectives.Gather`, whose gradient is
    reduce-scattered back to the block)."""
    from repro_torch.core import collectives
    for i, dim_axes in split_dims(spec, mesh):
        over = dim_axes if axes is None else tuple(
            a for a in dim_axes if a in axes)
        if over:
            block = collectives.Gather.apply(block, mesh, over, i)
    return block


def cut_leaf(whole, spec, mesh: RankMesh):
    """This rank's block of a whole leaf (a tensor or an array) under
    `spec`: a view, which an assignment writes through."""
    return whole[block_of(whole.shape, spec, mesh)]


def fsdp_gather(tree, plan: MeshPlan, cfg: ArchConfig):
    """A (sub)tree of parameter blocks with every leaf that FSDP cuts
    gathered whole over ``fsdp_axes`` (its "model" cut kept): the
    all-gathers before use, whose backward reduce-scatters the gradient
    over the dp axes into the block.  The tree itself without FSDP."""
    if plan is None or not plan.fsdp_axes \
            or not isinstance(plan.mesh, RankMesh) \
            or plan.axis_size(plan.fsdp_axes) == 1:
        return tree
    specs = param_specs(tree, plan, cfg)
    return _map_paths(lambda path, leaf: gather_leaf(
        leaf, _at(specs, path), plan.mesh, plan.fsdp_axes), tree)


#: the Mamba2 leaves every "model" rank holds whole and uses in part: the
#: B/C projection and its conv (the groups the rank's heads read), the
#: per-head scalars and the norm scale (the rank's heads and columns)
MAMBA_WHOLE = ("wBC", "conv_bc", "A_log", "dt_bias", "D_skip", "ssm_norm")


def grad_partial_over_model(path, spec, plan: MeshPlan,
                            cfg: ArchConfig) -> bool:
    """Whether a rank's gradient of the leaf at `path` is a partial sum
    over "model" that the step must sum there: a leaf every "model" rank
    holds whole, used where each rank computes a part.  Under `seq_split`
    that is every such leaf of the stack and the final norm (norms act on
    the rank's rows; every member computes its own rows' part); without
    it, the router (each rank backpropagates its experts' part), the
    Mamba2 leaves of `MAMBA_WHOLE` and, where the heads are split, the
    q/k norms and KV projections the rank's q heads read."""
    if tp_of(plan)[0] == 1 or plan.tp in _used(spec):
        return False
    if seq_split(plan)[0] > 1:
        return "embed" not in path and "head" not in path
    name = str(path[-1])
    if name == "router" or (name in MAMBA_WHOLE and "mamba" in path):
        return True
    return plan.head_axis is not None and name in ("q_norm", "k_norm",
                                                   "wk", "wv")
