"""Mamba2 SSD (state-space duality) block -- chunked linear-time scan.

The counterpart of `repro/models/mamba2.py`.  The sequence is cut into
chunks of Q tokens; the heavy compute (the intra-chunk quadratic part) is
local to a chunk, and only a small (H, P, N) state crosses chunk
boundaries.  The reference's ``lax.scan`` over chunks is a Python loop
here that emits the state *entering* each chunk.  Decode is the recurrent
one-token step; it writes the layer's state ({ssm, conv_x, conv_bc}) in
place, as attention writes its KV cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (causal_conv1d, gated_rmsnorm, ninit,
                                       out_scale, pdt)


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


def _project(p, x, cfg: ArchConfig, conv_state=None):
    """Shared projection + causal conv for both train and decode paths."""
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
    dt = _softplus(dtr.float() + p["dt_bias"])
    return z, xin, B_, C_, dt, {"conv_x": ns_x, "conv_bc": ns_b}


def _expand_groups(t, Hs: int):
    """(B, S, G, N) -> (B, S, Hs, N) by broadcasting heads within groups."""
    B, S, G, N = t.shape
    rep = Hs // G
    return t[:, :, :, None, :].expand(B, S, G, rep, N).reshape(B, S, Hs, N)


def apply_mamba(p, x, cfg: ArchConfig, state=None, chunk: int = 256):
    """Train/prefill path. x: (B, S, D) -> (y, final_state_dict).

    ``state`` carries an SSM state in (its ``ssm``; the conv starts from
    zeros, as in the reference).  S must be a multiple of ``min(chunk,
    S)``."""
    Bb, S, D = x.shape
    Hs, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state

    z, xin, B_, C_, dt, conv_state = _project(p, x, cfg)
    Bh = _expand_groups(B_, Hs)
    Ch = _expand_groups(C_, Hs)
    xh = xin.reshape(Bb, S, Hs, P)
    A = -torch.exp(p["A_log"])                                  # (Hs,)

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
    Y = Y + p["D_skip"][:, None] * xh.float()
    y = Y.to(x.dtype).reshape(Bb, S, cfg.d_inner)
    y = gated_rmsnorm(y, z, p["ssm_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    new_state = {"ssm": s,
                 "conv_x": conv_state["conv_x"].to(x.dtype),
                 "conv_bc": conv_state["conv_bc"].to(x.dtype)}
    return out, new_state


def decode_mamba(p, x, state, cfg: ArchConfig):
    """Single-token state update. x: (B, 1, D).  Writes `state` ({ssm,
    conv_x, conv_bc} of this layer) in place, the values the reference's
    functional update returns; returns (y, state)."""
    Bb = x.shape[0]
    Hs, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    z, xin, B_, C_, dt, conv_state = _project(p, x, cfg, conv_state=state)
    Bh = _expand_groups(B_, Hs)[:, 0]                           # (B,Hs,N)
    Ch = _expand_groups(C_, Hs)[:, 0]
    xh = xin.reshape(Bb, Hs, P)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0] * A)                                # (B,Hs)
    s = state["ssm"].float()
    upd = torch.einsum("bhn,bh,bhp->bhpn", Bh.float(), dt[:, 0], xh.float())
    s_new = s * dA[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), s_new)
    y = y + p["D_skip"][:, None] * xh.float()
    y = y.to(x.dtype).reshape(Bb, 1, cfg.d_inner)
    y = gated_rmsnorm(y, z, p["ssm_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    state["ssm"].copy_(s_new)
    state["conv_x"].copy_(conv_state["conv_x"])
    state["conv_bc"].copy_(conv_state["conv_bc"])
    return out, state
