"""Mamba2 SSD (state-space duality) block -- chunked linear-time scan.

The counterpart of `repro/models/mamba2.py`.  The sequence is cut into
chunks of Q tokens; the heavy compute (the intra-chunk quadratic part) is
local to a chunk, and only a small (H, P, N) state crosses chunk
boundaries.  The reference's ``lax.scan`` over chunks is a Python loop
here that emits the state *entering* each chunk.  Decode is the recurrent
one-token step; it writes the layer's state ({ssm, conv_x, conv_bc}) in
place, as attention writes its KV cache.

Across the ranks of a "model" axis (a `plan` on a `RankMesh`) rank i of
M runs the SSD heads ``[i Hs/M, (i+1) Hs/M)`` (the reference's heads
over ``plan.tp``, `repro/models/mamba2.py:71`): its blocks of ``wz``,
``wx``, ``wdt`` and ``conv_x`` (columns) and ``out_proj`` (rows), the
whole ``wBC`` and ``conv_bc`` of which it keeps the groups its heads
read, and its heads' or columns' slices of the whole ``A_log``,
``dt_bias``, ``D_skip`` and ``ssm_norm``.  The gated norm sums its
statistic over "model" (`common.gated_rmsnorm`) and ``out_proj``'s
partial products are summed as ``wo``'s are (`partition.exit_region`);
training gathers the sequence first where the residual is
sequence-sharded (`enter_region`): the scan needs all of it.  The
decode state is the rank's block of the cache (`partition.cache_specs`:
``ssm`` over heads, ``conv_x`` over ``d_inner``, ``conv_bc`` whole).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (causal_conv1d, gated_rmsnorm, ninit,
                                       out_scale, pdt)
from repro_torch.sharding.partition import (enter_region, exit_region,
                                            tp_of, whole_rows, ws)


def init_mamba(gen: torch.Generator, cfg: ArchConfig):
    D, di = cfg.d_model, cfg.d_inner
    G, N, Hs, K = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "wz": ninit(gen, (D, di), pdt(cfg)),
        "wx": ninit(gen, (D, di), pdt(cfg)),
        "wBC": ninit(gen, (D, 2 * G * N), pdt(cfg)),
        "wdt": ninit(gen, (D, Hs), pdt(cfg)),
        "conv_x": ninit(gen, (K, di), pdt(cfg), 0.2),
        "conv_bc": ninit(gen, (K, 2 * G * N), pdt(cfg), 0.2),
        "A_log": torch.log(torch.linspace(1.0, 16.0, Hs, **f32)),
        "dt_bias": torch.full((Hs,), -4.6, **f32),
        "D_skip": torch.ones((Hs,), **f32),
        "ssm_norm": torch.ones((di,), **f32),
        "out_proj": ninit(gen, (di, D), pdt(cfg), out_scale(cfg)),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rank_ssm_heads(cfg: ArchConfig, plan=None):
    """``(heads, first head)`` of this rank's SSD heads: all of them
    unsplit, else the rank's ``Hs / M`` of the model axis.  Where M does
    not divide the heads this raises `ValueError`, as the reference does:
    its ``wdt`` spec ``(fsdp, "model")`` (`repro/sharding/partition.py:138`)
    cuts the ``(D, Hs)`` leaf over "model", and jax refuses to place or
    compile a leaf that does not divide evenly.  No config reaches it at
    M <= 8 (mamba2-2.7b has 80 heads, jamba 128)."""
    Hs = cfg.ssm_nheads
    M, i = tp_of(plan)
    if M == 1:
        return Hs, 0
    if Hs % M:
        raise ValueError(
            f"{cfg.name}: the (d_model, {Hs}) wdt leaf does not split "
            f"evenly over a \"model\" axis of {M} ranks (its spec cuts the "
            f"SSD heads over \"model\"; the reference refuses it too)")
    return Hs // M, i * (Hs // M)


def _project(p, x, cfg: ArchConfig, conv_state=None, heads=None):
    """Shared projection + causal conv for both train and decode paths.
    `heads` = (this rank's heads, first head): its columns of z, x and
    dt, and the groups of B and C its heads read."""
    Hl, h0 = heads or (cfg.ssm_nheads, 0)
    z = x @ p["wz"].to(x.dtype)
    xin = x @ p["wx"].to(x.dtype)
    bc = x @ p["wBC"].to(x.dtype)
    dtr = x @ p["wdt"].to(x.dtype)
    cs_x = conv_state["conv_x"] if conv_state else None
    cs_b = conv_state["conv_bc"] if conv_state else None
    xin, ns_x = causal_conv1d(xin, p["conv_x"], cs_x)
    bc, ns_b = causal_conv1d(bc, p["conv_bc"], cs_b)
    xin = F.silu(xin.float()).to(x.dtype)
    bc = F.silu(bc.float()).to(x.dtype)
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    B_, C_ = torch.chunk(bc, 2, dim=-1)
    B_ = B_.reshape(*B_.shape[:-1], G, N)
    C_ = C_.reshape(*C_.shape[:-1], G, N)
    dt = _softplus(dtr.float() + p["dt_bias"][h0:h0 + Hl])
    return z, xin, B_, C_, dt, {"conv_x": ns_x, "conv_bc": ns_b}


def _expand_groups(t, Hs: int, heads=None):
    """(B, S, G, N) -> (B, S, H, N) by broadcasting heads within groups:
    all Hs heads, or `heads` = (count, first) of them, each reading group
    ``h // (Hs / G)``."""
    B, S, G, N = t.shape
    rep = Hs // G
    Hl, h0 = heads or (Hs, 0)
    if Hl == Hs:
        return t[:, :, :, None, :].expand(B, S, G, rep, N).reshape(B, S, Hs, N)
    idx = torch.arange(h0, h0 + Hl, device=t.device) // rep
    return t.index_select(2, idx)


def apply_mamba(p, x, cfg: ArchConfig, plan=None, state=None,
                chunk: int = 256):
    """Train/prefill path. x: (B, S, D) -> (y, final_state_dict).

    ``state`` carries an SSM state in (its ``ssm``; the conv starts from
    zeros, as in the reference).  S must be a multiple of ``min(chunk,
    S)``.  Across ranks (`plan`) see the module docstring: the state
    returned is the rank's block."""
    heads = rank_ssm_heads(cfg, plan)
    Hs, h0 = heads
    x = enter_region(x, plan)
    Bb, S, D = x.shape
    P, N = cfg.ssm_headdim, cfg.ssm_state

    z, xin, B_, C_, dt, conv_state = _project(p, x, cfg, heads=heads)
    Bh = _expand_groups(B_, cfg.ssm_nheads, heads)
    Ch = _expand_groups(C_, cfg.ssm_nheads, heads)
    xh = xin.reshape(Bb, S, Hs, P)
    ws(xh, plan, plan and plan.batch_axes, None, plan and plan.tp,
       None, shape=lambda: (whole_rows(plan, Bb), S, cfg.ssm_nheads, P),
       site="models/mamba2.py:78")
    A = -torch.exp(p["A_log"][h0:h0 + Hs])                      # (Hs,)

    Q = min(chunk, S)
    assert S % Q == 0, f"seq {S} not divisible by ssd chunk {Q}"
    Cn = S // Q

    def r(t):
        return t.reshape(Bb, Cn, Q, *t.shape[2:])

    dtc, Bc, Cc, xc = r(dt), r(Bh), r(Ch), r(xh)
    dA = dtc * A                                                # (B,Cn,Q,Hs) f32
    cum = torch.cumsum(dA, dim=2)

    # ---- intra-chunk (local, quadratic-in-Q) ----
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,Cn,Q,Q,Hs)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc.float(), Bc.float())
    W = scores * L * dtc[:, :, None, :, :]                      # (B,Cn,Q,Q,Hs)
    Ydiag = torch.einsum("bcijh,bcjhp->bcihp", W.to(x.dtype).float(),
                         xc.float())

    # ---- chunk summary states (B,Cn,Hs,P,N) ----
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)           # (B,Cn,Q,Hs)
    wgt = (decay_states * dtc).to(x.dtype)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bc.float(), wgt.float(),
                          xc.float())

    # ---- inter-chunk recurrence (only the small state crosses chunks) ----
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B,Cn,Hs)
    s = (state["ssm"].float() if state is not None
         else torch.zeros((Bb, Hs, P, N), dtype=torch.float32,
                          device=x.device))
    entering = []
    for c in range(Cn):
        entering.append(s)                      # the state *entering* chunk c
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)                  # (B,Cn,Hs,P,N)

    Yoff = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc.float(),
                        prev_states.to(x.dtype).float(),
                        torch.exp(cum).to(x.dtype).float())
    Y = (Ydiag + Yoff).reshape(Bb, S, Hs, P)
    Y = Y + p["D_skip"][h0:h0 + Hs, None] * xh.float()
    y = Y.to(x.dtype).reshape(Bb, S, Hs * P)
    y = gated_rmsnorm(y, z, p["ssm_norm"][h0 * P:(h0 + Hs) * P],
                      cfg.norm_eps, plan)
    out = exit_region(y @ p["out_proj"].to(x.dtype), plan)
    new_state = {"ssm": s,
                 "conv_x": conv_state["conv_x"].to(x.dtype),
                 "conv_bc": conv_state["conv_bc"].to(x.dtype)}
    return out, new_state


def decode_mamba(p, x, state, cfg: ArchConfig, plan=None):
    """Single-token state update. x: (B, 1, D).  Writes `state` ({ssm,
    conv_x, conv_bc} of this layer; across ranks the rank's block) in
    place, the values the reference's functional update returns; returns
    (y, state)."""
    heads = rank_ssm_heads(cfg, plan)
    Hs, h0 = heads
    Bb = x.shape[0]
    P, N = cfg.ssm_headdim, cfg.ssm_state
    z, xin, B_, C_, dt, conv_state = _project(p, x, cfg, conv_state=state,
                                              heads=heads)
    Bh = _expand_groups(B_, cfg.ssm_nheads, heads)[:, 0]        # (B,Hs,N)
    Ch = _expand_groups(C_, cfg.ssm_nheads, heads)[:, 0]
    xh = xin.reshape(Bb, Hs, P)
    A = -torch.exp(p["A_log"][h0:h0 + Hs])
    dA = torch.exp(dt[:, 0] * A)                                # (B,Hs)
    s = state["ssm"].float()
    upd = torch.einsum("bhn,bh,bhp->bhpn", Bh.float(), dt[:, 0], xh.float())
    s_new = s * dA[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), s_new)
    y = y + p["D_skip"][h0:h0 + Hs, None] * xh.float()
    y = y.to(x.dtype).reshape(Bb, 1, Hs * P)
    y = gated_rmsnorm(y, z, p["ssm_norm"][h0 * P:(h0 + Hs) * P],
                      cfg.norm_eps, plan)
    out = exit_region(y @ p["out_proj"].to(x.dtype), plan)
    state["ssm"].copy_(s_new)
    state["conv_x"].copy_(conv_state["conv_x"])
    state["conv_bc"].copy_(conv_state["conv_bc"])
    return out, state
