"""Superblock assembly: the layer stack, looped over superblocks.

The counterpart of `repro/models/blocks.py`.  A *superblock* is the
smallest repeating unit of an architecture (one layer for dense models).
Parameters are stacked with a leading superblock axis, as in the
reference's pytree, and the reference's ``lax.scan`` over it is a Python
loop here.  Decode caches are stacked the same way: (superblocks, B, ...).
Training rematerialises each superblock when ``cfg.parallel.remat``
(`apply_stack`), as the reference checkpoints its scan body.

Ported members: attention ("attn") with the SwiGLU MLP ("mlp").  Mamba2,
mixture-of-experts and cross-attention members raise `NotImplementedError`
(ROADMAP.md Queue 1: the rest of the model stack).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (NOT_PORTED, _rowwise_positions,
                                          apply_attention, init_attention)
from repro_torch.models.common import apply_mlp, init_mlp, rmsnorm


@dataclass(frozen=True)
class MemberSpec:
    mixer: str  # "attn" | "mamba" | "cross"
    ffn: str    # "mlp" | "moe" | "none"


def superblock_spec(cfg: ArchConfig) -> List[MemberSpec]:
    if cfg.family == "ssm":
        return [MemberSpec("mamba", "none")]
    if cfg.family == "hybrid":
        out = []
        for i in range(cfg.attn_every):
            mixer = "attn" if i == 0 else "mamba"
            ffn = "moe" if (cfg.is_moe and i % cfg.moe_every == 1) else "mlp"
            out.append(MemberSpec(mixer, ffn))
        return out
    if cfg.family == "vlm":
        n = cfg.cross_attn_every
        return [MemberSpec("attn", "mlp")] * (n - 1) + [MemberSpec("cross", "mlp")]
    ffn = "moe" if cfg.is_moe else "mlp"
    return [MemberSpec("attn", ffn)]


def num_superblocks(cfg: ArchConfig) -> int:
    n = len(superblock_spec(cfg))
    assert cfg.num_layers % n == 0, (cfg.num_layers, n)
    return cfg.num_layers // n


def check_ported(cfg: ArchConfig) -> None:
    """Raise `NotImplementedError` unless every member of the config's
    superblock is ported (attention with an MLP)."""
    for m in superblock_spec(cfg):
        if m.mixer != "attn":
            raise NotImplementedError(f"{cfg.name}: {m.mixer} members "
                                      f"{NOT_PORTED}")
        if m.ffn != "mlp":
            raise NotImplementedError(f"{cfg.name}: {m.ffn} feed-forward "
                                      f"members {NOT_PORTED}")


def tree_index(tree, i: int):
    """Superblock i of a stacked dict tree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_stack(trees):
    """Stack a list of dict trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_member(gen: torch.Generator, cfg: ArchConfig):
    D = cfg.d_model
    ones = lambda: torch.ones((D,), dtype=torch.float32, device=gen.device)  # noqa: E731
    return {"ln1": ones(), "attn": init_attention(gen, cfg), "ln2": ones(),
            "mlp": init_mlp(gen, cfg)}


def init_stack(gen: torch.Generator, cfg: ArchConfig):
    check_ported(cfg)
    members = superblock_spec(cfg)
    return tree_stack([{f"m{i}": _init_member(gen, cfg)
                        for i in range(len(members))}
                       for _ in range(num_superblocks(cfg))])


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def _apply_member(p, x, *, cfg, positions, build_cache: bool, cache_len,
                  flash: bool):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    mix, cache = apply_attention(p["attn"], h, cfg=cfg, positions=positions,
                                 build_cache=build_cache, cache_len=cache_len,
                                 flash=flash)
    x = x + mix
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg), cache


def tree_unbind(tree, n: int):
    """The n superblocks of a stacked dict tree, as views: one `unbind` a
    leaf, whose backward stacks the n gradients in one copy (indexing
    each superblock in turn would add n full-size gradients instead)."""
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def apply_stack(stack, x, *, cfg: ArchConfig, positions=None,
                build_cache: bool = False, cache_len=None, flash: bool = True):
    """x: (B, S, D) -> (y, caches_or_None): the superblocks in turn;
    caches stacked (superblocks, B, ...) when `build_cache`.

    With ``cfg.parallel.remat`` and grad enabled (training), each
    superblock runs under `torch.utils.checkpoint`: only its input is kept
    for the backward pass, which runs the superblock's forward again --
    the reference's ``jax.checkpoint`` of the scan body."""
    check_ported(cfg)
    members = superblock_spec(cfg)
    remat = (cfg.parallel.remat and torch.is_grad_enabled()
             and not build_cache)

    def superblock(sb, x):
        caches = {}
        for j in range(len(members)):
            x, caches[f"m{j}"] = _apply_member(
                sb[f"m{j}"], x, cfg=cfg, positions=positions,
                build_cache=build_cache, cache_len=cache_len, flash=flash)
        return x, caches

    caches = []
    for sb in tree_unbind(stack, num_superblocks(cfg)):
        if remat:
            x = checkpoint(lambda sb, x: superblock(sb, x)[0], sb, x,
                           use_reentrant=False)
        else:
            x, sb_caches = superblock(sb, x)
            caches.append(sb_caches)
    return x, (tree_stack(caches) if build_cache else None)


# ---------------------------------------------------------------------------
# decode (Sq tokens per row, cache update)
# ---------------------------------------------------------------------------
def decode_stack(stack, caches, x, pos, *, cfg: ArchConfig, write_mask=None):
    """x: (B, S, D); caches: dict tree with a leading superblock axis.

    ``pos`` is a scalar, (B,) or (B, S) of absolute query positions
    (per-slot clocks); ``write_mask`` (B, S) bool gates cache commits.
    Returns (x, caches): the caches are written in place, the bits the
    reference's functional update gives.  The cache is donated
    (`Locale.jit`): a caller that reads the old cache afterwards copies
    it first."""
    check_ported(cfg)
    members = superblock_spec(cfg)
    pos = _rowwise_positions(pos, x.shape[0], x.shape[1], x.device)
    for i in range(num_superblocks(cfg)):
        sb = tree_index(stack, i)
        for j in range(len(members)):
            p = sb[f"m{j}"]
            h = rmsnorm(x, p["ln1"], cfg.norm_eps)
            mix, _ = apply_attention(p["attn"], h, cfg=cfg,
                                     cache=tree_index(caches[f"m{j}"], i),
                                     pos=pos, write_mask=write_mask)
            x = x + mix
            h = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + apply_mlp(p["mlp"], h, cfg)
    return x, caches
