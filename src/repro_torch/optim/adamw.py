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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        """``{"m", "v"}`` float32 zeros like `params`, ``"step"`` an int32
        0 on the params' device."""
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def global_norm(self, grads) -> torch.Tensor:
        """The float32 norm over every gradient leaf that clipping uses (0
        without clipping, as the reference reports it)."""
        leaves = tree_leaves(grads)
        if not self.clip_norm:
            return torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        with torch.no_grad():
            return torch.sqrt(sum(g.float().square().sum() for g in leaves))

    @torch.no_grad()
    def update(self, grads, state, params, gnorm: Optional[torch.Tensor] = None):
        """One step in place: returns ``(params, state, gnorm)``, the first
        two the objects passed in.  `gnorm` is `global_norm(grads)` when the
        caller has it already (the trainer decides its guard on it before
        anything is written)."""
        step = state["step"] + 1
        if gnorm is None:
            gnorm = self.global_norm(grads)
        scale = (torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
                 if self.clip_norm else None)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, stepf)
        bc2 = 1 - torch.pow(self.b2, stepf)
        lr = self._lr(step)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g32 = g.float()
            if scale is not None:
                g32 = g32 * scale
            m.mul_(self.b1).add_(g32 * (1 - self.b1))
            v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            p32 = p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p32
            p.copy_(p32 - lr * u)
        state["step"].copy_(step)
        return params, state, gnorm
