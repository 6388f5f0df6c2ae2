"""Static partitioning rules: the counterpart of `repro/sharding/
partition.py`.

`make_plan` resolves the same placement plan as the reference's, field
for field, for a mesh of homes on one device (`HomeMesh`) or of
``torch.distributed`` ranks (`RankMesh`).  A spec is a tuple with one
entry per dimension -- None (whole), an axis name, or a tuple of axis
names linearised row-major -- the counterpart of ``PartitionSpec``;
`param_specs`, `batch_specs` and `cache_specs` build them for a tree as
the reference builds its ``P`` trees, and `shard_for_rank` cuts a whole
tree down to one rank's blocks.

What reads a plan:

* On a `HomeMesh` every home lies on one device, so only ``batch_axes``
  matters: the server homes its slots over them (`Locale.pin_tree`'s
  counted relayout); the model runs whole.
* On a `RankMesh` serving splits the model over ``"model"`` where the
  plan says (`tp_of`): heads and KV heads (`models.attention`), MLP
  columns (`models.common`), experts or their F columns (`models.moe`),
  the vocabulary (`models.model`), each followed by a counted `psum`
  (`core.collectives`).  Every other axis is data-parallel: each
  (pod, data) coordinate is a home holding its own slot rows.  Serving
  cuts the parameters with ``fsdp_axes`` cleared (`serving_plan`): as in
  the reference, where serving never shards parameters over the data
  axes.  The sequence-sharded residual (``seq_axis``) and FSDP/ZeRO-1
  change no value and wait for training across ranks (`opt_specs` and
  `full_opt_specs` with them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def psum_model(x: torch.Tensor, plan: Optional[MeshPlan]) -> torch.Tensor:
    """`x` summed over the ranks of the model axis (`collectives.psum`);
    `x` itself where nothing is split."""
    if tp_of(plan)[0] == 1:
        return x
    from repro_torch.core import collectives
    return collectives.psum(x, plan.mesh, (plan.tp,))


def no_split(plan: Optional[MeshPlan], what: str) -> None:
    """Raise for a member the model axis does not split yet."""
    if tp_of(plan)[0] > 1:
        raise NotImplementedError(
            f"{what} over a \"model\" axis of {plan.tp_size} ranks is not "
            f"split yet (ROADMAP.md Queue 1); serve it with \"model\" = 1")


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
        axes = tuple(a for a in _axes(entry) if mesh.shape[a] > 1)
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
