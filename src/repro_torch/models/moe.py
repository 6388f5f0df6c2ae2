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
from repro_torch.sharding.partition import (enter_region, exit_region,
                                            homes_of, tp_of)


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


def apply_moe(p, x, cfg: ArchConfig, plan=None, group_size: int = 2048,
              train: bool = False):
    """x: (B, S, D) -> (y, aux_loss). Token-choice top-k with capacity drop.

    The B*S tokens, in row order, form groups of ``min(group_size, B*S)``,
    which must divide them; decode passes ``group_size = B``.

    Across ranks (`plan` on a `RankMesh`) `x` holds this home's rows,
    home h of n over the batch axes, and the groups are those of all n
    homes' ``n*B*S`` tokens in row order, as in the reference, where a
    decode step's group is every slot.  A token's place in its expert's
    bucket counts the tokens before it in its group, so where a group
    spans homes each home gathers the others' per-group counts of each
    (choice, expert) pair (one counted all-gather of (groups, K, E)
    integers) and starts its own tokens after the earlier homes'; no
    home sees another's tokens.  Over "model" each rank runs its own
    experts (``expert_axis``) or its F columns of every expert, then one
    `psum` sums the combine.  ``aux`` is this home's share of the
    load-balance loss (serving reads none).

    Training (`train`) takes the same route with the residual's sequence
    gathered first where it is sharded (`partition.enter_region`; the
    combine's partial sums reduce-scattered back, `exit_region`), and
    makes ``aux`` the whole batch's: the fraction of first choices of
    every home (from the gathered counts, gathered in training whenever
    there is more than one home) times this home's mean gates, so that
    the homes' mean is the reference's ``aux``; across "model" ranks,
    whose gradients of the gates are partial sums, each takes 1/M of it.
    """
    M, rank = tp_of(plan)
    x = enter_region(x, plan)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    n, home = homes_of(plan)
    Th = B * S                                   # this home's tokens
    T = Th * n
    gs = min(group_size, T)
    assert T % gs == 0, f"token count {T} not divisible by group size {gs}"
    Gn = T // gs
    C = _capacity(gs, cfg)
    t0 = home * Th
    g0 = t0 // gs                                # first group it touches
    Gl = (t0 + Th - 1) // gs + 1 - g0

    xf = x.reshape(Th, D)
    logits = xf.float() @ p["router"].float()                   # (Th, E)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, K)
    topv = topv / topv.sum(dim=-1, keepdim=True)                # renormalise

    # ---- capacity slots: the place of each (token, choice) in its bucket
    mk = F.one_hot(topi, E).float()                             # (Th, K, E)
    gid = torch.div(t0 + torch.arange(Th, device=x.device), gs,
                    rounding_mode="floor") - g0                 # local group
    starts = [max((g0 + g) * gs - t0, 0) for g in range(Gl)]
    before = torch.cumsum(mk, dim=0) - mk       # this home's earlier tokens
    mine = torch.zeros((Gn, K, E), dtype=torch.float32, device=x.device)
    mine[g0:g0 + Gl] = torch.stack(
        [mk[a:b].sum(dim=0) for a, b in zip(starts, starts[1:] + [Th])])
    if n > 1 and (Th % gs or train):             # groups span homes
        from repro_torch.core import collectives
        counts = collectives.all_gather(mine.to(torch.int32), plan.mesh,
                                        plan.batch_axes).float()
        earlier = counts[:home].sum(dim=0)                      # (Gn, K, E)
        total = counts.sum(dim=0)
    else:
        earlier, total = torch.zeros_like(mine), mine
    # the reference's ``prev``: the whole group's tokens of earlier choices
    prev = torch.cumsum(total, dim=1) - total                   # (Gn, K, E)
    first = before[torch.tensor(starts, device=x.device)]       # (Gl, K, E)
    posk = (before - first[gid] + earlier[g0:g0 + Gl][gid]
            + prev[g0:g0 + Gl][gid])                            # (Th, K, E)
    keep = mk * (posk < C)

    # ---- capacity-bucketed dispatch/combine (GShard) ----
    slots = torch.arange(C, device=x.device)
    combine = torch.zeros((Th, E, C), dtype=torch.float32, device=x.device)
    for kk in range(K):
        # one-hot of the slot; a slot past capacity is all zeros
        oh = (posk[:, kk].long()[..., None] == slots).float()   # (Th, E, C)
        combine = combine + oh * (keep[:, kk] * topv[:, kk:kk + 1])[..., None]
    El = E // M if (M > 1 and plan.expert_axis is not None) else E
    ex = slice(rank * El, (rank + 1) * El) if El < E else slice(None)
    combine = combine[:, ex]
    dispatch = (combine > 0).to(x.dtype)

    # ---- send tokens to their experts, run them, bring them back ----
    wg, wu, wd = (p[k].to(x.dtype) for k in ("we_gate", "we_up", "we_down"))
    parts = []
    for a, b in zip(starts, starts[1:] + [Th]):
        xe = torch.einsum("sec,sd->ecd", dispatch[a:b], xf[a:b])
        g = torch.einsum("ecd,edf->ecf", xe, wg)
        u = torch.einsum("ecd,edf->ecf", xe, wu)
        h = F.silu(g.float()).to(x.dtype) * u
        ye = torch.einsum("ecf,efd->ecd", h, wd)
        parts.append(torch.einsum("sec,ecd->sd", combine[a:b].to(x.dtype),
                                  ye))
    y = exit_region(torch.cat(parts).reshape(B, S, D), plan).to(x.dtype)

    if "shared" in p:
        y = y + exit_region(apply_mlp(p["shared"], x, cfg, plan,
                                      region=False), plan)

    # ---- switch-style load-balance aux ----
    if n > 1 and train:
        frac_tokens = total[:, 0].sum(dim=0) / T
    else:
        frac_tokens = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    frac_gates = gates.mean(dim=0)
    aux = E * (frac_tokens * frac_gates).sum()
    if train and M > 1:
        aux = aux / M
    return y, aux
