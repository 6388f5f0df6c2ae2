"""AdamW with float32 state over (possibly bf16) params + global-norm
clipping: the counterpart of `repro/optim/adamw.py`.

The math is the reference's, not `torch.optim.AdamW`'s: float32 ``m`` and
``v``; the gradients scaled by ``min(1, clip / (gnorm + 1e-9))``; bias
corrections from the int32 step; ``u = m̂ / (sqrt(v̂) + eps) + wd * p``,
then ``p - lr * u`` rounded back to the parameter's dtype
(`torch.optim.AdamW` decays as ``p * (1 - lr * wd)``, which rounds
otherwise).  `update` writes params and state in place, under
`torch.no_grad`: the counterpart of the reference trainer donating them
to its jitted step.

Across ranks (`RankLeaves`: each leaf a rank's block under its spec) the
norm counts each logical element once -- each rank sums the squares of
the blocks it owns (`partition.owns`), and one counted `psum` over the
whole mesh adds the ranks' sums in home order, the same bits on every
rank -- and under ZeRO-1 `update` steps the rank's block of ``m``, ``v``
and the parameter (its cut over ``zero1_axes``, `partition.zero1_dim`)
from the reduced gradient's block, then all-gathers the parameter's
blocks over ``zero1_axes``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import math

import torch

from repro_torch.tree import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class RankLeaves:
    """What the optimiser needs of each leaf's layout across ranks, in
    `tree_leaves` order: whether this rank owns its block (`owns`) and
    the dim ZeRO-1 cuts (None: not cut), on `mesh` with ``zero1_axes``
    `zero1`."""

    mesh: object
    owned: Sequence[bool]
    zero1_dims: Sequence[Optional[int]]
    zero1: tuple = ()

    def zero1_slice(self, i: int, shape) -> tuple:
        """The slices of leaf i's ZeRO-1 block within the rank's block of
        `shape`."""
        d = self.zero1_dims[i]
        k = math.prod(self.mesh.shape[a] for a in self.zero1)
        j = self.mesh.index(self.zero1)
        n = shape[d] // k
        return (slice(None),) * d + (slice(j * n, (j + 1) * n),)


@dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params, ranks: Optional[RankLeaves] = None):
        """``{"m", "v"}`` float32 zeros like `params` (a leaf ZeRO-1 cuts:
        like the rank's cut of it), ``"step"`` an int32 0 on the params'
        device."""
        leaves = tree_leaves(params)
        shapes = [p[ranks.zero1_slice(i, p.shape)].shape
                  if ranks is not None and ranks.zero1_dims[i] is not None
                  else p.shape for i, p in enumerate(leaves)]

        def zeros():
            return tree_unflatten(params, [
                torch.zeros(sh, dtype=torch.float32, device=p.device)
                for sh, p in zip(shapes, leaves)])
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaves[0].device)}

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def global_norm(self, grads,
                    ranks: Optional[RankLeaves] = None) -> torch.Tensor:
        """The float32 norm over every gradient leaf that clipping uses (0
        without clipping, as the reference reports it).  Across ranks
        (`ranks`), of the whole gradients: the owned blocks' squares
        summed over the mesh."""
        leaves = tree_leaves(grads)
        if not self.clip_norm:
            return torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        with torch.no_grad():
            if ranks is None:
                return torch.sqrt(sum(g.float().square().sum()
                                      for g in leaves))
            from repro_torch.core import collectives
            mine = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for g, own in zip(leaves, ranks.owned):
                if own:
                    mine = mine + g.float().square().sum()
            mesh = ranks.mesh
            return torch.sqrt(collectives.psum(mine, mesh, tuple(mesh.shape)))

    @torch.no_grad()
    def update(self, grads, state, params, gnorm: Optional[torch.Tensor] = None,
               ranks: Optional[RankLeaves] = None):
        """One step in place: returns ``(params, state, gnorm)``, the first
        two the objects passed in.  `gnorm` is `global_norm(grads)` when the
        caller has it already (the trainer decides its guard on it before
        anything is written).  `ranks`: each leaf is a rank's block, and
        a leaf ZeRO-1 cuts is stepped on the rank's cut of it, then
        gathered over the ZeRO-1 axes."""
        step = state["step"] + 1
        if gnorm is None:
            gnorm = self.global_norm(grads)
        scale = (torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
                 if self.clip_norm else None)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, stepf)
        bc2 = 1 - torch.pow(self.b2, stepf)
        lr = self._lr(step)
        for i, (g, m, v, p) in enumerate(zip(
                tree_leaves(grads), tree_leaves(state["m"]),
                tree_leaves(state["v"]), tree_leaves(params))):
            z = ranks is not None and ranks.zero1_dims[i] is not None
            if z:
                sl = ranks.zero1_slice(i, p.shape)
                g, whole, p = g[sl], p, p[sl]
            g32 = g.float()
            if scale is not None:
                g32 = g32 * scale
            m.mul_(self.b1).add_(g32 * (1 - self.b1))
            v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            p32 = p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p32
            p.copy_(p32 - lr * u)
            if z:
                from repro_torch.core import collectives
                whole.copy_(collectives.gather_dim(
                    p.contiguous(), ranks.mesh, ranks.zero1,
                    ranks.zero1_dims[i]))
        state["step"].copy_(step)
        return params, state, gnorm
