"""Superblock assembly: heterogeneous layer stacks, looped over superblocks.

The counterpart of `repro/models/blocks.py`.  A *superblock* is the
smallest repeating unit of an architecture (1 layer for dense/MoE/SSM
models; 8 layers for Jamba's 1:7 attn:mamba interleave; 5 for the vision
model's 4-self+1-cross pattern).  Parameters are stacked with a leading
superblock axis, as in the reference's pytree, and the reference's
``lax.scan`` over it is a Python loop here.  Decode caches are stacked the
same way: (superblocks, B, ...), and decode writes them in place.
Training rematerialises each superblock when ``cfg.parallel.remat``
(`apply_stack`), as the reference checkpoints its scan body.

Every function takes the ``plan`` and hands it to the members
(`attention.apply_attention`, `mamba2.apply_mamba`/`decode_mamba`,
`common.apply_mlp`, `moe.apply_moe`).
Serving keeps every rank of a home's residual whole (its decode plan has
no ``seq_axis``).  Training across ranks carries the reference's
constraint here (`repro/models/blocks.py:131`): the residual stream
between superblocks sequence-sharded over "model" (``seq_axis``), each
member gathering the sequence and scattering its output back; and under
FSDP each superblock's leaves are all-gathered over ``fsdp_axes`` inside
the rematerialised function (`apply_stack`), so the gathered weights live
for the superblock's forward only and are gathered again in the
recompute, as under the reference's ``jax.checkpoint`` of its scan body.
Every member kind is split over "model" as the plan says -- attention
and cross attention by heads, Mamba2 by SSD heads and their ``d_inner``
columns, the MLP by columns, the MoE by experts or columns -- and with
"model" = 1 every member runs data-parallel, each home running the whole
model on its own rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (_rowwise_positions, apply_attention,
                                          init_attention)
from repro_torch.models.common import apply_mlp, init_mlp, rmsnorm
from repro_torch.models.mamba2 import apply_mamba, decode_mamba, init_mamba
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.sharding.partition import (fsdp_gather, homes_of,
                                            whole_rows, ws)
from repro_torch.tree import tree_map


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
def _init_member(gen: torch.Generator, cfg: ArchConfig, spec: MemberSpec):
    D = cfg.d_model
    ones = lambda: torch.ones((D,), dtype=torch.float32, device=gen.device)  # noqa: E731
    p = {"ln1": ones()}
    if spec.mixer in ("attn", "cross"):
        p["attn"] = init_attention(gen, cfg, cross=spec.mixer == "cross")
    else:
        p["mamba"] = init_mamba(gen, cfg)
    if spec.ffn != "none":
        p["ln2"] = ones()
        if spec.ffn == "moe":
            p["moe"] = init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg)
    return p


def init_stack(gen: torch.Generator, cfg: ArchConfig, cut=None):
    """Each superblock's parameters drawn in turn, written into stacked
    leaves: the stack takes its own size and one superblock's, not twice
    its size (the full-width configs fill most of a card).  `cut`, where
    given, maps each drawn superblock to what is kept of it (a rank's
    blocks, `convert.rank_cut`) before it is stacked."""
    members = superblock_spec(cfg)
    nsb = num_superblocks(cfg)

    def draw():
        return {f"m{i}": _init_member(gen, cfg, m)
                for i, m in enumerate(members)}

    stack = None
    for i in range(nsb):
        sb = draw() if cut is None else cut(draw())
        if stack is None:
            stack = tree_map(lambda t: t.new_empty((nsb, *t.shape)), sb)
        tree_map(lambda dst, src: dst[i].copy_(src), stack, sb)
    return stack


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def _apply_member(p, spec: MemberSpec, x, *, cfg, positions, img_embeds,
                  build_cache: bool, cache_len, flash: bool, plan=None,
                  train: bool = False):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "mamba":
        mix, cache = apply_mamba(p["mamba"], h, cfg, plan)
    else:
        cross = spec.mixer == "cross"
        mix, cache = apply_attention(
            p["attn"], h, cfg=cfg, positions=positions,
            kv_src=img_embeds if cross else None, cross=cross,
            build_cache=build_cache, cache_len=cache_len, flash=flash,
            plan=plan)
    x = x + mix
    if spec.ffn != "none":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "moe":
            f, aux = apply_moe(p["moe"], h, cfg, plan, train=train)
        else:
            f = apply_mlp(p["mlp"], h, cfg, plan)
        x = x + f
    return x, cache, aux


def tree_unbind(tree, n: int):
    """The n superblocks of a stacked dict tree, as views: one `unbind` a
    leaf, whose backward stacks the n gradients in one copy (indexing
    each superblock in turn would add n full-size gradients instead)."""
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def apply_stack(stack, x, *, cfg: ArchConfig, positions=None, img_embeds=None,
                build_cache: bool = False, cache_len=None, flash: bool = True,
                plan=None):
    """x: (B, S, D) -> (y, caches_or_None, aux): the superblocks in turn;
    caches stacked (superblocks, B, ...) when `build_cache`; aux the MoE
    load-balance losses, summed over each superblock's members, then over
    the superblocks, as the reference sums them.

    With ``cfg.parallel.remat`` and grad enabled (training), each
    superblock runs under `torch.utils.checkpoint`: only its input is kept
    for the backward pass, which runs the superblock's forward again --
    the reference's ``jax.checkpoint`` of the scan body -- all of it,
    collectives included (no early stop), so the recompute's collectives
    are the forward's.  Training across ranks: `x` is the rank's rows of
    the sequence under `partition.seq_split` (`positions` the whole
    sequence's), and each superblock's FSDP-cut leaves are gathered
    inside that function (`partition.fsdp_gather`)."""
    members = superblock_spec(cfg)
    train = torch.is_grad_enabled() and not build_cache
    remat = cfg.parallel.remat and train
    S = positions.shape[-1] if positions is not None else x.shape[1]

    def superblock(sb, x):
        sb = fsdp_gather(sb, plan, cfg) if train and plan is not None else sb
        caches = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, m in enumerate(members):
            x, caches[f"m{j}"], a = _apply_member(
                sb[f"m{j}"], m, x, cfg=cfg, positions=positions,
                img_embeds=img_embeds, build_cache=build_cache,
                cache_len=cache_len, flash=flash, plan=plan, train=train)
            aux = aux + a
        return x, caches, aux

    caches, auxs = [], []
    for sb in tree_unbind(stack, num_superblocks(cfg)):
        if remat:
            with set_checkpoint_early_stop(False):
                x, aux = checkpoint(lambda sb, x: superblock(sb, x)[::2], sb,
                                    x, use_reentrant=False)
        else:
            x, sb_caches, aux = superblock(sb, x)
            caches.append(sb_caches)
        ws(x, plan, plan and plan.batch_axes, plan and plan.seq_axis, None,
           shape=lambda: (whole_rows(plan, x.shape[0]), S, cfg.d_model),
           site="models/blocks.py:131")
        auxs.append(aux)
    return (x, (tree_stack(caches) if build_cache else None),
            torch.stack(auxs).sum())


# ---------------------------------------------------------------------------
# decode (Sq tokens per row, cache update)
# ---------------------------------------------------------------------------
def _decode_member(p, spec: MemberSpec, x, cache, pos, *, cfg,
                   write_mask=None, plan=None, cache_slots=None):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "mamba":
        if x.shape[1] != 1:
            raise ValueError("mamba decode is strictly sequential: "
                             f"one token per call, got {x.shape[1]}")
        mix, _ = decode_mamba(p["mamba"], h, cache, cfg, plan)
    else:
        mix, _ = apply_attention(p["attn"], h, cfg=cfg, cache=cache, pos=pos,
                                 cross=spec.mixer == "cross",
                                 write_mask=write_mask, plan=plan,
                                 cache_slots=cache_slots)
    x = x + mix
    if spec.ffn != "none":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "moe":
            # one group of the whole batch's rows, every home's
            f, _ = apply_moe(p["moe"], h, cfg, plan,
                             group_size=x.shape[0] * homes_of(plan)[0])
        else:
            f = apply_mlp(p["mlp"], h, cfg, plan)
        x = x + f
    return x


def decode_stack(stack, caches, x, pos, *, cfg: ArchConfig, write_mask=None,
                 plan=None, cache_slots=None):
    """x: (B, S, D); caches: dict tree with a leading superblock axis.

    ``pos`` is a scalar, (B,) or (B, S) of absolute query positions
    (per-slot clocks); ``write_mask`` (B, S) bool gates cache commits.
    Returns (x, caches): the caches -- KV rings, SSM and conv states --
    are written in place, the bits the reference's functional update
    gives.  The cache is donated (`Locale.jit`): a caller that reads the
    old cache afterwards copies it first.  `cache_slots`: the whole
    self-attention cache's slots where the plan homes it by sequence
    (`attention.apply_attention`)."""
    members = superblock_spec(cfg)
    pos = _rowwise_positions(pos, x.shape[0], x.shape[1], x.device)
    for i in range(num_superblocks(cfg)):
        sb = tree_index(stack, i)
        for j, m in enumerate(members):
            x = _decode_member(sb[f"m{j}"], m, x,
                               tree_index(caches[f"m{j}"], i), pos, cfg=cfg,
                               write_mask=write_mask, plan=plan,
                               cache_slots=cache_slots)
    return x, caches
