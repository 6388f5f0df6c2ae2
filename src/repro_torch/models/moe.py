"""Token-choice MoE with GShard-style capacity dispatch.

The counterpart of `repro/models/moe.py`, in the reference's dense one-hot
form: each group of tokens is dispatched into ``(experts, capacity)``
buckets by a one-hot einsum, every expert runs its SwiGLU on its bucket,
and a combine einsum weighted by the renormalised gates brings the
results back.  A token whose expert bucket is full is dropped for that
expert, so within a group the tokens compete for capacity in their
order: a row's output depends on its group-mates wherever a bucket fills.

Where the reference's `lax.top_k` breaks a tie by the lower index, so
does the stable descending sort here (`torch.topk` promises no order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (apply_mlp, init_mlp, ninit, out_scale,
                                       pdt)


def init_moe(gen: torch.Generator, cfg: ArchConfig):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": ninit(gen, (D, E), torch.float32),
         "we_gate": ninit(gen, (E, D, Fd), pdt(cfg)),
         "we_up": ninit(gen, (E, D, Fd), pdt(cfg)),
         "we_down": ninit(gen, (E, Fd, D), pdt(cfg), out_scale(cfg))}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.num_shared_experts * Fd)
    return p


def _capacity(gs: int, cfg: ArchConfig) -> int:
    c = int(-(-gs * cfg.top_k * cfg.capacity_factor // cfg.num_experts))
    return max(4, -(-c // 4) * 4)


def top_k(gates: torch.Tensor, k: int):
    """The k largest gates of the last axis and their indices, ties to the
    lower index (`lax.top_k`'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p, x, cfg: ArchConfig, group_size: int = 2048):
    """x: (B, S, D) -> (y, aux_loss). Token-choice top-k with capacity drop.

    The B*S tokens, in row order, form groups of ``min(group_size, B*S)``,
    which must divide them; decode passes ``group_size = B``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    gs = min(group_size, T)
    assert T % gs == 0, f"token count {T} not divisible by group size {gs}"
    Gn = T // gs
    C = _capacity(gs, cfg)

    xg = x.reshape(Gn, gs, D)
    logits = xg.float() @ p["router"].float()                  # (Gn, gs, E)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, K)
    topv = topv / topv.sum(dim=-1, keepdim=True)               # renormalise

    # ---- capacity-bucketed dispatch/combine (GShard) ----
    slots = torch.arange(C, device=x.device)
    combine = torch.zeros((Gn, gs, E, C), dtype=torch.float32,
                          device=x.device)
    prev = torch.zeros((Gn, 1, E), dtype=torch.float32, device=x.device)
    for kk in range(K):
        mk = F.one_hot(topi[..., kk], E).float()                # (Gn, gs, E)
        posk = torch.cumsum(mk, dim=1) - mk + prev              # slot per token
        prev = prev + mk.sum(dim=1, keepdim=True)
        keep = mk * (posk < C)
        # one-hot of the slot; a slot past capacity is all zeros
        oh = (posk.long()[..., None] == slots).float()
        combine = combine + oh * (keep * topv[..., kk:kk + 1])[..., None]
    dispatch = (combine > 0).to(x.dtype)

    # ---- send tokens to their experts, run them, bring them back ----
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    g = torch.einsum("gecd,edf->gecf", xe, p["we_gate"].to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", xe, p["we_up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    ye = torch.einsum("gecf,efd->gecd", h, p["we_down"].to(x.dtype))
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    y = y.reshape(B, S, D)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)

    # ---- switch-style load-balance aux ----
    frac_tokens = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    frac_gates = gates.mean(dim=(0, 1))
    aux = E * (frac_tokens * frac_gates).sum()
    return y, aux
