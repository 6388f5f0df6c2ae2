"""LM: embedding/frontend + superblock stack + head; train/prefill/decode.

The counterpart of `repro/models/model.py`, for every member kind of the
reference (attention, sliding-window attention, cross attention, Mamba2,
the SwiGLU MLP and mixture-of-experts).  Parameters
are the reference's pytree as a dict of tensors (`init`, or
`convert.lm_params_from_reference`); every method takes them explicitly,
as the reference's do, and runs where they lie.

Across ``torch.distributed`` ranks every method takes the ``plan``
(`sharding.partition.make_plan` on a `RankMesh`) and the rank's blocks
of the parameters (`convert.rank_params`): the rows it is given are its
home's, and over the "model" axis ``tok_embed`` holds the rank's
vocabulary rows (a lookup of its range, zeros elsewhere, then one exact
`psum`) and ``head_w`` its vocabulary columns, so the logits the methods
return are the rank's vocabulary block (`runtime.server.greedy` picks
across them; `models.steps.vocab_nll` takes the loss from them).
A whole-sequence call (training, `forward`, `prefill`) reads the
plan's ``seq_axis``, as the reference's does: the embedding's lookup is
reduce-scattered onto the rank's rows of the sequence in place of the
`psum`, the members gather the sequence and scatter their outputs back
(`partition.enter_region`/`exit_region`), the final norm acts on the
rank's rows and the head gathers them back (`prefill`: the last position
only, from the last rank of "model").  Training (`forward` under
autograd) also reads ``fsdp_axes``: the FSDP-cut ``tok_embed`` and
``head_w`` are gathered over the dp axes before use.  Decode plans have
no ``seq_axis`` (`partition.make_plan`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.common import dt, ninit, pdt, rmsnorm
from repro_torch.sharding.partition import (cache_block, enter_region,
                                            fsdp_gather, psum_model,
                                            seq_split, tp_of)


class LM(nn.Module):
    """A decoder-only LM over tokens or precomputed frontend embeddings.

    ``flash``: prefill attention through the `flash_attention` kernel on
    the card (the default); False runs the plain chunked form there too,
    the yardstick the card check holds the kernel's logits to.  On the
    CPU the plain form runs either way.  The kernel has no backward pass,
    so under autograd ``flash=True`` raises on both devices: training
    (`models.steps`, `runtime.trainer`) builds ``LM(cfg, flash=False)``.
    """

    def __init__(self, cfg: ArchConfig, flash: bool = True):
        super().__init__()
        self.cfg = cfg
        self.flash = flash

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, cut=None):
        """Parameters drawn from `gen`, on the generator's device.  `cut`,
        where given, maps a part of the tree (each superblock as it is
        drawn, then the rest) to what is kept of it: a rank's blocks
        (`convert.rank_cut`) without the whole parameters at once."""
        cfg = self.cfg
        params = {"stack": blocks.init_stack(gen, cfg, cut),
                  "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                           device=gen.device),
                  "head": {"head_w": ninit(gen, (cfg.d_model,
                                                 cfg.vocab_padded), pdt(cfg))}}
        if cfg.embed_input:
            params["embed"] = {"tok_embed": ninit(
                gen, (cfg.vocab_padded, cfg.d_model), pdt(cfg))}
        if cut is not None:
            stack = params.pop("stack")
            params = {"stack": stack, **cut(params)}
        return params

    # ----------------------------------------------------------------- embed
    def _embed(self, params, batch, plan=None, train: bool = False):
        """The residual's input, cut to the rank's rows under
        `partition.seq_split` (never in decode: its plans have no
        ``seq_axis``)."""
        Ms, i_s = seq_split(plan)
        if not self.cfg.embed_input:
            x = batch["embeds"].to(dt(self.cfg))
            S = x.shape[1] // Ms
            return x[:, i_s * S:(i_s + 1) * S] if Ms > 1 else x
        emb = params["embed"]
        if train:
            emb = fsdp_gather(emb, plan, self.cfg)
        table, tokens = emb["tok_embed"], batch["tokens"]
        M, i = tp_of(plan)
        if M == 1:
            return table[tokens].to(dt(self.cfg))
        rows = table.shape[0]
        local = tokens - i * rows
        inside = (local >= 0) & (local < rows)
        x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)],
                        table.new_zeros(()))
        if Ms > 1:
            from repro_torch.core import collectives
            return collectives.Scatter.apply(x, plan.mesh, (plan.tp,),
                                             1).to(dt(self.cfg))
        return psum_model(x, plan).to(dt(self.cfg))

    def _head(self, params, x, plan=None, train: bool = False):
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        head = params["head"]
        x = enter_region(x, plan)
        if train:
            head = fsdp_gather(head, plan, self.cfg)
        return x @ head["head_w"].to(x.dtype)

    def _stack(self, params, batch, build_cache: bool, cache_len, plan=None,
               train: bool = False):
        x = self._embed(params, batch, plan, train)
        S = (batch["tokens"] if self.cfg.embed_input
             else batch["embeds"]).shape[1]
        positions = torch.arange(S, device=x.device)
        return blocks.apply_stack(params["stack"], x, cfg=self.cfg,
                                  positions=positions,
                                  img_embeds=batch.get("image_embeds"),
                                  build_cache=build_cache,
                                  cache_len=cache_len, flash=self.flash,
                                  plan=plan)

    # --------------------------------------------------------------- forward
    def forward(self, params, batch, plan=None, build_cache: bool = False,
                cache_len=None):
        """Returns (logits (B, S, Vp), caches_or_None, aux); aux is the
        MoE load-balancing loss summed over the layers (0 without MoE).
        A vision config's batch carries ``image_embeds`` (B, n, D).
        Across ranks (`plan`) the logits are the home's rows and the
        rank's vocabulary block, and under autograd (training, no cache)
        the plan's sequence and FSDP layouts hold (see the module
        docstring)."""
        train = torch.is_grad_enabled() and not build_cache
        x, caches, aux = self._stack(params, batch, build_cache, cache_len,
                                     plan, train)
        return self._head(params, x, plan, train), caches, aux

    def prefill(self, params, batch, max_len=None, plan=None):
        """(last-position logits (B, Vp), caches sized for `max_len`).  The
        head runs on the last position only: the reference computes every
        position's logits and keeps the last, the same per-row product."""
        x, caches, _ = self._stack(params, batch, True, max_len, plan)
        # under `seq_split` the last position is the last rank's last row
        last = enter_region(x[:, -1:], plan)[:, -1:]
        return self._head(params, last)[:, 0], caches

    def decode_step(self, params, caches, batch, pos, plan=None,
                    cache_slots=None):
        """One token per row; ``pos`` is a scalar (one shared clock) or a
        (B,) vector of per-slot position clocks (continuous batching: each
        row decodes at its own position).  Returns (logits (B, Vp),
        caches'): `caches` written in place (`blocks.decode_stack`).
        `cache_slots`: the whole self-attention cache's slots where the
        plan homes it by sequence (`attention.apply_attention`)."""
        x = self._embed(params, batch, plan)
        x, new_caches = blocks.decode_stack(params["stack"], caches, x, pos,
                                            cfg=self.cfg, plan=plan,
                                            cache_slots=cache_slots)
        return self._head(params, x)[:, 0], new_caches

    def decode_pages(self, params, caches, batch, positions, write_mask,
                     plan=None, cache_slots=None):
        """Page-stepped prefill: S new tokens per row written into the
        decode cache at ``positions`` (B, S), cache commits gated by
        ``write_mask`` (B, S) -- pad positions and non-refilling rows
        compute but never write.  Page p of a row attends only to cache
        entries at positions < its own, so a page's K/V content is a pure
        function of the row's earlier pages.  Returns (logits (B, S, Vp),
        caches'): `caches` written in place."""
        x = self._embed(params, batch, plan)
        x, new_caches = blocks.decode_stack(params["stack"], caches, x,
                                            positions, cfg=self.cfg,
                                            write_mask=write_mask, plan=plan,
                                            cache_slots=cache_slots)
        return self._head(params, x), new_caches

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int, img_len: int = 0,
                   device="cuda", plan=None):
        """Empty decode cache (the structure prefill builds), on `device`:
        zero K/V with every slot's position -1 (a ring of
        ``min(window, max_len)`` slots under a sliding window), zero SSM
        and conv states, and a cross layer's zero image K/V of `img_len`
        tokens (default the config's) at position 0.  Across ranks
        (`plan`) each leaf is the rank's block (`partition.cache_specs`):
        the KV heads where "model" splits them, the self-attention slots
        where the plan homes the cache by sequence (`cache_block`), the
        SSM heads and ``conv_x`` columns of the rank's Mamba2 heads."""
        cfg = self.cfg
        nsb = blocks.num_superblocks(cfg)
        Sc = min(cfg.sliding_window, max_len) if cfg.sliding_window \
            else max_len
        Sc = cache_block(Sc, plan)[1]
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        M = tp_of(plan)[0]
        if M > 1 and plan.kv_axis is not None:
            KV //= M
        members = blocks.superblock_spec(cfg)
        if any(m.mixer == "mamba" for m in members):
            from repro_torch.models.mamba2 import rank_ssm_heads
            Hs = rank_ssm_heads(cfg, plan)[0]
            di = Hs * cfg.ssm_headdim

        def zeros(*shape, dtype=dt(cfg)):
            return torch.zeros(shape, dtype=dtype, device=device)

        def member_cache(spec):
            if spec.mixer == "mamba":
                return {"ssm": zeros(nsb, batch_size, Hs,
                                     cfg.ssm_headdim, cfg.ssm_state,
                                     dtype=torch.float32),
                        "conv_x": zeros(nsb, batch_size, cfg.ssm_conv - 1,
                                        di),
                        "conv_bc": zeros(nsb, batch_size, cfg.ssm_conv - 1,
                                         2 * cfg.ssm_ngroups * cfg.ssm_state)}
            if spec.mixer == "cross":
                n = img_len or cfg.num_image_tokens
                return {"k": zeros(nsb, batch_size, n, KV, hd),
                        "v": zeros(nsb, batch_size, n, KV, hd),
                        "kpos": zeros(nsb, n, dtype=torch.int32)}
            return {"k": zeros(nsb, batch_size, Sc, KV, hd),
                    "v": zeros(nsb, batch_size, Sc, KV, hd),
                    "kpos": torch.full((nsb, batch_size, Sc), -1,
                                       dtype=torch.int32, device=device)}

        return {f"m{i}": member_cache(m) for i, m in enumerate(members)}
