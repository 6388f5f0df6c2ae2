"""Step functions: train / prefill / decode, the counterpart of
`repro/models/steps.py`.

They close over (model, plan, optimizer) and are what `runtime/trainer.py`
executes.  The model must be ``LM(cfg, flash=False)`` for training: the
`flash_attention` kernel has no backward pass and raises under autograd.

On one process (no plan, or a `HomeMesh`, whose homes all lie on one
device) the reference's layout constraints move nothing.  Across
``torch.distributed`` ranks (a plan on a `RankMesh`, the parameters and
optimiser state the rank's blocks, `convert.rank_params` /
`rank_opt_state`) the step keeps the reference's layouts, each move a
counted collective of `core.collectives`:

* `_micro_split` homes each microbatch over the batch axes, as the
  reference's ``ws`` does: one `all_to_all_v` a batch leaf from the
  batch's homing (home h: rows h*GB/n ..) to the microbatches' (home h:
  its block of rows of microbatch i, `partition.micro_rows`: GB/(m n)
  rows where the homes divide the microbatch, else blocks of
  ceil(GB/(m n)) in home order, the last short or empty, as GSPMD pads).
* Each home differentiates its rows' loss weighted by its share of the
  microbatch's rows (1/n where the homes divide it), so that the homes'
  sum is the batch mean; a home with no rows adds exactly 0 (its nll
  is the empty sum, not the NaN of an empty mean).  The loss takes its
  nll from the rank's vocabulary block (`vocab_nll`: each rank's
  log-sum-exp and target logit, one all-gather over "model").
* Gradients follow `_constrain_like_params`: an FSDP leaf's is
  reduce-scattered over the dp axes by its gather's backward, each
  microbatch, into the float32 accumulator of the rank's block.  Every
  other leaf's is summed locally over the microbatches (in their order)
  and then once a step over the dp axes -- and over "model" where the
  rank's gradient is a partial sum there (`partition.
  grad_partial_over_model`) -- a bucket of leaves of one dtype and set
  of axes at a time: one `reduce_scatter` (each home sums its block in
  home order) and one `all_gather` of the summed blocks, the bits of a
  `psum` for ``2 (g - 1) / g`` of the bucket's bytes where `psum` sends
  ``(g - 1)`` times them.
* Error feedback acts on the reduced gradient's blocks; the norm and
  ZeRO-1 are `optim.adamw`'s (`RankLeaves`).  The loss, the norm and the
  guard's inputs are the same bits on every rank.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import LM
from repro_torch.optim.adamw import AdamW, RankLeaves
from repro_torch.optim.compression import error_feedback_update
from repro_torch.sharding.partition import (NULL_PLAN, MeshPlan,
                                            grad_partial_over_model, homes_of,
                                            micro_home, micro_rows, owns,
                                            param_specs, tp_of, zero1_dim)
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten

AUX_WEIGHT = 0.01


def _mean(nll: torch.Tensor) -> torch.Tensor:
    """The mean of the tokens' nll; of no token (a home given no rows of a
    microbatch, `partition.micro_rows`), the empty sum, 0."""
    return nll.mean() if nll.numel() else nll.sum()


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              vocab_size: int) -> torch.Tensor:
    """The mean next-token nll of (B, S, Vp) logits: float32, the padded
    vocabulary masked to -1e30, ``logsumexp`` less the target's logit.  The
    target's logit is gathered: the reference's one-hot sum adds it to
    zeros only, the same value."""
    lf = logits.float()
    live = torch.arange(lf.shape[-1], device=lf.device) < vocab_size
    lf = torch.where(live, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    tl = lf.gather(-1, targets[..., None].long())[..., 0]
    return _mean(lse - tl)


class _VocabNLL(torch.autograd.Function):
    """Each token's nll from this rank's vocabulary block of the logits:
    the rank's float32 log-sum-exp and target logit (0 where the target
    lies in another block), all-gathered over "model" and combined alike
    on every rank.  The nll is then the same on every rank of the axis,
    so its gradient is whole, and the backward is the rank's block of
    ``(softmax - onehot) * g`` (Megatron's vocabulary-parallel loss),
    the softmax recomputed from the logits."""

    @staticmethod
    def forward(ctx, logits, targets, lo, vocab_size, mesh, axes):
        from repro_torch.core import collectives
        lf, local, inside = _masked(logits, targets, lo, vocab_size)
        lse = torch.logsumexp(lf, dim=-1)
        tl = torch.where(inside, lf.gather(-1, local[..., None])[..., 0], 0.0)
        parts = collectives.all_gather(torch.stack([lse, tl], dim=-1),
                                       mesh, axes)
        whole = torch.logsumexp(parts[..., 0], dim=0)
        ctx.save_for_backward(logits, targets, whole)
        ctx.lo, ctx.vocab_size = lo, vocab_size
        return whole - parts[..., 1].sum(dim=0)

    @staticmethod
    def backward(ctx, g):
        logits, targets, whole = ctx.saved_tensors
        lf, local, inside = _masked(logits, targets, ctx.lo, ctx.vocab_size)
        p = torch.exp(lf - whole[..., None])
        hit = (torch.arange(p.shape[-1], device=p.device) == local[..., None]
               ) & inside[..., None]
        p = torch.where(hit, p - 1.0, p)
        return ((p * g[..., None]).to(logits.dtype), None, None, None, None,
                None)


def _masked(logits, targets, lo: int, vocab_size: int):
    """(float32 logits with the padded vocabulary at -1e30, the target's
    column in this block, whether it lies in this block)."""
    lf = logits.float()
    col = lo + torch.arange(lf.shape[-1], device=lf.device)
    lf = torch.where(col < vocab_size, lf, -1e30)
    local = targets.long() - lo
    inside = (local >= 0) & (local < lf.shape[-1])
    return lf, local.clamp(0, lf.shape[-1] - 1), inside


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor, vocab_size: int,
              plan: Optional[MeshPlan] = None) -> torch.Tensor:
    """The mean next-token nll of logits that hold this rank's block of the
    vocabulary over "model" (`LM.forward` across ranks), without gathering
    the (B, S, Vp) logits (`_VocabNLL`); `token_nll` where the vocabulary
    is whole."""
    M, i = tp_of(plan)
    if M == 1:
        return token_nll(logits, targets, vocab_size)
    lo = i * logits.shape[-1]
    return _mean(_VocabNLL.apply(logits, targets, lo, vocab_size, plan.mesh,
                                 (plan.tp,)))


def make_loss_fn(model: LM, cfg: ArchConfig, plan: MeshPlan = NULL_PLAN):
    """``loss_fn(params, batch) -> (nll + AUX_WEIGHT * aux, nll)``
    (`vocab_nll`); across ranks both of the home's rows."""
    def loss_fn(params, batch):
        logits, _, aux = model.forward(params, batch, plan)
        nll = vocab_nll(logits, batch["targets"], cfg.vocab_size, plan)
        return nll + AUX_WEIGHT * aux, nll

    return loss_fn


def _micro_split(batch, m: int, plan: Optional[MeshPlan] = None):
    """(GB, ...) -> m microbatches of (GB/m, ...), in order.  Across ranks
    the batch holds the home's rows and each microbatch returned is the
    home's block of it (`partition.micro_rows`, possibly empty), moved
    there by one counted `all_to_all_v` a leaf (see the module
    docstring)."""
    n, h = homes_of(plan)
    if m == 1:
        return [batch]
    if n == 1:
        def split(x):
            assert x.shape[0] % m == 0, (x.shape, m)
            return x.reshape(m, x.shape[0] // m, *x.shape[1:])
        parts = tree_map(split, batch)
        return [tree_map(lambda x: x[i], parts) for i in range(m)]
    from repro_torch.core import collectives
    b = tree_leaves(batch)[0].shape[0]
    GB = b * n
    if GB % m:
        raise ValueError(f"{GB} rows do not split into {m} microbatches")
    piece = micro_rows(GB, m, plan)

    def dest(rows):
        return micro_home(rows, GB, m, n)

    mine = dest(np.arange(h * b, (h + 1) * b))
    order = torch.as_tensor(np.argsort(mine, kind="stable"))
    sends = np.bincount(mine, minlength=n)
    recvs = [int((dest(np.arange(s * b, (s + 1) * b)) == h).sum())
             for s in range(n)]

    def move(x):
        row = math.prod(x.shape[1:])
        flat = x[order.to(x.device)].reshape(-1)
        got = collectives.all_to_all_v(flat, plan.mesh, plan.batch_axes,
                                       [int(c) * row for c in sends],
                                       [c * row for c in recvs])
        return got.view(m, piece, *x.shape[1:])

    parts = {k: move(v) for k, v in sorted(batch.items())}
    return [{k: parts[k][i] for k in batch} for i in range(m)]


class RankGrads:
    """The layout of a rank's gradient leaves (`tree_leaves` order) on a
    plan's `RankMesh`: which leaves FSDP cuts (their gradients come
    reduced from their gathers' backward), the axes each other leaf's
    gradient is summed over, and the optimiser's `RankLeaves`."""

    def __init__(self, params, plan: MeshPlan, cfg: ArchConfig):
        mesh = plan.mesh
        self.plan = plan
        specs = param_specs(params, plan, cfg)
        dp = tuple(a for a in (plan.batch_axes or ()) if mesh.shape[a] > 1)
        names = tuple(mesh.shape)
        self.axes: List[tuple] = []
        owned, z1 = [], []
        for (path, leaf), (_, spec) in zip(tree_items(params),
                                           tree_items(specs)):
            used = {a for d in spec for a in ((d,) if isinstance(d, str)
                                              else (d or ()))}
            over = set() if set(dp) & used else set(dp)
            if grad_partial_over_model(path, spec, plan, cfg):
                over.add(plan.tp)
            self.axes.append(tuple(a for a in names if a in over))
            owned.append(owns(spec, mesh))
            # the dims ZeRO-1 may cut are whole in the rank's block
            z1.append(zero1_dim(spec, leaf.shape, plan))
        self.leaves = RankLeaves(mesh=mesh, owned=owned, zero1_dims=z1,
                                 zero1=tuple(plan.zero1_axes or ()))

    def reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf's gradient summed over its axes, a bucket at a time
        (leaves of one dtype and one set of axes, in tree order, flattened
        end to end and padded with zeros to whole blocks), buckets in the
        order of their first leaf: `reduce_scatter`, then `all_gather` of
        the blocks."""
        from repro_torch.core import collectives
        buckets: Dict[tuple, List[int]] = {}
        for i, (g, axes) in enumerate(zip(grads, self.axes)):
            if axes:
                buckets.setdefault((axes, g.dtype), []).append(i)
        out = list(grads)
        mesh = self.plan.mesh
        for (axes, _), idx in buckets.items():
            k = self.plan.axis_size(axes)
            size = sum(grads[i].numel() for i in idx)
            flat = torch.cat([grads[i].reshape(-1) for i in idx]
                             + [grads[idx[0]].new_zeros(-size % k)])
            block = collectives.reduce_scatter(flat, mesh, axes)
            summed = collectives.all_gather(block, mesh, axes).reshape(-1)
            at = 0
            for i in idx:
                n = grads[i].numel()
                out[i] = summed[at:at + n].view(grads[i].shape)
                at += n
        return out


def ranks_of(plan: Optional[MeshPlan]) -> bool:
    """Whether `plan` lies on a `RankMesh` (training across ranks)."""
    from repro_torch.core.mesh import RankMesh
    return plan is not None and isinstance(plan.mesh, RankMesh)


def make_train_step(model: LM, cfg: ArchConfig, plan: MeshPlan,
                    optimizer: AdamW):
    """``train_step(params, opt_state, batch, accept=None) -> (params,
    opt_state, metrics)``, params and state updated in place (the params'
    tensors are made to require grad: autograd differentiates them).

    Metrics are the reference's: ``loss`` (the nll), ``grad_norm`` (the
    global norm before clipping) and ``step`` (the optimiser step after
    this one), as tensors.  `accept`, when given, sees them before
    anything is written: if it returns False the step writes nothing --
    params, ``m``, ``v``, the step count and the error-feedback residual
    stay as they were -- which is the reference trainer's guard keeping
    its old state and dropping the step's outputs.

    Across ranks (`plan` on a `RankMesh`) see the module docstring; the
    metrics there are the whole batch's, the same bits on every rank.
    """
    loss_fn = make_loss_fn(model, cfg, plan)
    M = max(cfg.parallel.microbatches, 1)
    accum_dtype = getattr(torch, cfg.parallel.accum_dtype)
    on_ranks = ranks_of(plan)
    n = homes_of(plan)[0] if on_ranks else 1
    if on_ranks and M > 1 and n > 1 and plan.batch_axes is None:
        raise ValueError("the global batch does not split over the homes")
    layout: Dict[str, RankGrads] = {}

    def train_step(params, opt_state, batch, accept=None):
        leaves = tree_leaves(params)
        if on_ranks and "g" not in layout:
            layout["g"] = RankGrads(params, plan, cfg)
        # this home's share of each microbatch's rows, n times over: 1
        # where the homes divide the microbatch (`partition.micro_rows`)
        w = 1.0
        if on_ranks and M > 1 and n > 1:
            GB = tree_leaves(batch)[0].shape[0] * n
            w = micro_rows(GB, M, plan) * n / (GB // M)
            if w != 1.0 and cfg.is_moe:
                raise ValueError(
                    f"{GB // M} rows a microbatch do not divide over {n} "
                    f"homes: the MoE layers' token groups and load-balance "
                    f"loss take equal homes")

        def weighted(loss):
            # even homes skip the multiply: exact either way, but one more
            # elementwise op in the counts `launch.dryrun` holds
            return loss if w == 1.0 else loss * w
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            if M == 1:
                loss, nll = loss_fn(params, batch)
                grads = list(torch.autograd.grad(loss / n, leaves))
                nlls = [nll.detach()]
            elif cfg.parallel.accum_via_scan_grad:
                # the reference differentiates the scan over microbatches:
                # one gradient of sum(loss_i / M).  Here one backward a
                # microbatch on loss_i / M accumulates into the same .grad,
                # which is that gradient's math; .grad adds in the param
                # dtype where the reference's scan transpose keeps its own
                # accumulator, so the roundings differ (float32: within
                # rtol 1e-4 of the reference, tests/test_torch_train.py)
                for p in leaves:
                    p.grad = None
                nlls = []
                for one in _micro_split(batch, M, plan):
                    loss, one_nll = loss_fn(params, one)
                    (weighted(loss) / M / n).backward()
                    nlls.append(one_nll.detach())
                grads = [p.grad for p in leaves]
                for p in leaves:
                    p.grad = None
            else:
                acc = [torch.zeros(p.shape, dtype=accum_dtype,
                                   device=p.device) for p in leaves]
                nlls = []
                for one in _micro_split(batch, M, plan):
                    loss, one_nll = loss_fn(params, one)
                    for a, g in zip(acc, torch.autograd.grad(
                            weighted(loss) / n, leaves)):
                        a += g.to(accum_dtype)
                    nlls.append(one_nll.detach())
                grads = [a / M for a in acc]
        nll = torch.stack(nlls)
        if on_ranks:
            grads = layout["g"].reduce(grads)
            if n > 1:
                from repro_torch.core import collectives
                nll = collectives.psum(weighted(nll), plan.mesh,
                                       plan.batch_axes) / n
        nll = nll.mean()

        grads = tree_unflatten(params, grads)
        new_ef = None
        if cfg.parallel.grad_compression and "ef" in opt_state:
            pairs = tree_map(error_feedback_update, grads, opt_state["ef"])
            grads = tree_map(lambda p: p[0], pairs)
            new_ef = tree_map(lambda p: p[1], pairs)

        adam = opt_state["adam"]
        ranks = layout["g"].leaves if on_ranks else None
        gnorm = optimizer.global_norm(grads, ranks)
        metrics = {"loss": nll, "grad_norm": gnorm,
                   "step": (adam["step"] + 1).to(torch.float32)}
        if accept is not None and not accept(metrics):
            return params, opt_state, metrics
        optimizer.update(grads, adam, params, gnorm=gnorm, ranks=ranks)
        if new_ef is not None:
            tree_map(lambda ef, new: ef.copy_(new), opt_state["ef"], new_ef)
        return params, opt_state, metrics

    return train_step


def rank_leaves(params, plan: MeshPlan, cfg: ArchConfig) -> Optional[RankLeaves]:
    """The optimiser's `RankLeaves` of a rank's parameter blocks; None off
    ranks."""
    return RankGrads(params, plan, cfg).leaves if ranks_of(plan) else None


def init_opt_state(cfg: ArchConfig, optimizer: AdamW, params,
                   plan: MeshPlan = NULL_PLAN):
    """AdamW's state (and the error-feedback residual where the config
    compresses gradients) for `params`; across ranks for the rank's blocks,
    ``m`` and ``v`` cut further under ZeRO-1."""
    state = {"adam": optimizer.init(params, rank_leaves(params, plan, cfg))}
    if cfg.parallel.grad_compression:
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state


def make_prefill_step(model: LM, cfg: ArchConfig, plan: MeshPlan = NULL_PLAN):
    """The prefill of one rank of `plan` (every model-axis sum it implies
    included), as the reference's ``prefill_step``."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, plan=plan)
    return prefill_step


def make_decode_step(model: LM, cfg: ArchConfig, plan: MeshPlan = NULL_PLAN,
                     cache_slots: Optional[int] = None):
    """One decode step of one rank of `plan`, as the reference's
    ``decode_step``; `cache_slots` is the whole cache's slots where the
    plan homes it by sequence (`LM.decode_step`)."""
    def decode_step(params, caches, batch, pos):
        return model.decode_step(params, caches, batch, pos, plan=plan,
                                 cache_slots=cache_slots)
    return decode_step
