"""Shared model building blocks: init helpers, RMSNorm, RoPE, SwiGLU MLP,
the causal depth-wise convolution of the Mamba2 block.

The counterpart of `repro/models/common.py`.  Parameters are plain dicts
of tensors, the reference's pytree: initialised from an explicit
`torch.Generator` (its numbers differ from ``jax.random``'s; parity runs
on parameters converted from the reference, `convert.lm_params_from_reference`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.partition import (enter_region, exit_region,
                                            psum_stat, tp_of)


def dt(cfg: ArchConfig) -> torch.dtype:
    """The activation dtype."""
    return getattr(torch, cfg.dtype)


def pdt(cfg: ArchConfig) -> torch.dtype:
    """The parameter dtype."""
    return getattr(torch, cfg.param_dtype)


class MetaGen:
    """A stand-in for a generator on the ``meta`` device: `LM.init` with
    it draws nothing and returns the parameters' shapes and dtypes
    (`obs.schedule.train_schedule` reads them)."""

    device = torch.device("meta")


def ninit(gen: torch.Generator, shape, dtype, scale: float = 0.02):
    """Scaled standard normals of `shape`, drawn in float32 on the
    generator's device, cast to `dtype` (shape only for a `MetaGen`)."""
    if isinstance(gen, MetaGen):
        return torch.empty(shape, dtype=dtype, device="meta")
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen.device)).to(dtype)


def out_scale(cfg: ArchConfig) -> float:
    """The init scale of an output projection: mild depth scaling."""
    return 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5) * 50


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float):
    """RMSNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def gated_rmsnorm(x, gate, scale, eps: float, plan=None):
    """Mamba2-style: norm(x * silu(gate)) over the whole ``d_inner``.

    Across the ranks of a "model" axis (`plan` on a `RankMesh`) `x`,
    `gate` and `scale` hold this rank's columns: each rank's float32 sum
    of squares (B, S, 1) is summed over "model" by one counted all-reduce
    (`partition.psum_stat`, whose gradient is summed too) and divided by
    the whole width."""
    g = x * F.silu(gate.float()).to(x.dtype)
    M = tp_of(plan)[0]
    if M == 1:
        return rmsnorm(g, scale, eps)
    gf = g.float()
    var = psum_stat(gf.square().sum(dim=-1, keepdim=True), plan) \
        / (gf.shape[-1] * M)
    return (gf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """Apply rotary embedding. x: (..., S, H, hd); positions: (S,) or (B, S).

    The frequencies are computed in float32, as the reference computes
    them (``log(theta) / half`` a float32 constant on the host)."""
    hd = x.shape[-1]
    half = hd // 2
    step = float(np.log(np.float32(theta)) / np.float32(half))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) * step)
    angles = positions.float()[..., None] * freqs        # (..., S, half)
    angles = angles[..., None, :]                        # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ArchConfig, d_ff=None):
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": ninit(gen, (D, Fd), pdt(cfg)),
            "w_up": ninit(gen, (D, Fd), pdt(cfg)),
            "w_down": ninit(gen, (Fd, D), pdt(cfg), out_scale(cfg))}


def apply_mlp(p, x, cfg: ArchConfig, plan=None, region: bool = True):
    """The SwiGLU MLP.  Across the ranks of a "model" axis (`plan` on a
    `RankMesh`) ``w_gate``/``w_up`` hold this rank's F columns and
    ``w_down`` its F rows: the partial products, in `x`'s dtype as the
    whole product is, are summed by one `psum` -- in training with the
    residual sequence-sharded, the sequence is gathered first and the
    partial products reduce-scattered back onto the rank's rows
    (`partition.enter_region`/`exit_region`).  ``region=False``: `x` is
    already the region's input and the partial products are returned
    unsummed (a MoE's shared experts)."""
    if region:
        x = enter_region(x, plan)
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    y = h @ p["w_down"].to(x.dtype)
    return exit_region(y, plan) if region else y


def causal_conv1d(u, w, state=None):
    """Depth-wise causal conv. u: (B, S, C); w: (K, C).

    Returns (y, new_state) where state holds the trailing K-1 inputs,
    (B, K-1, C).  The taps add in the reference's order, in u's dtype."""
    K = w.shape[0]
    S = u.shape[1]
    if state is not None:
        u_ext = torch.cat([state.to(u.dtype), u], dim=1)
    else:
        u_ext = F.pad(u, (0, 0, K - 1, 0))
    y = 0
    for j in range(K):
        y = y + u_ext[:, j:j + S, :] * w[j].to(u.dtype)
    new_state = u_ext[:, u_ext.shape[1] - (K - 1):, :] if K > 1 else u[:, :0]
    return y, new_state
