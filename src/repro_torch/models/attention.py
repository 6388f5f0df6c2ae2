"""Attention: GQA + qk-norm + sliding window + cross attention + KV cache.

The counterpart of `repro/models/attention.py`.  Prefill attention is the
reference's *chunked* online softmax over KV blocks (`chunked_attention`,
the plain form, which takes the banded O(S*W) form,
`banded_swa_attention`, where the reference does) or, on a CUDA tensor,
the hand-written `flash_attention` kernel -- causal, windowed or (cross
attention) neither -- which the reference names as the drop-in for the
same computation (`prefill_attention` dispatches on where the tensor
lies).  Decode and the page-stepped prefill attend over the KV cache
(`decode_attention`, plain, as in the reference): a ring of ``W`` slots
under a sliding window, the static image K/V through a cross layer.
Where the reference's einsums accumulate in float32
(``preferred_element_type``), the operands are cast to float32 first, so
that a bfloat16 product is not rounded to bfloat16 in between.

Across ranks a plan that homes the decode cache by sequence
(``cache_seq_axis``, `partition.cache_block`) leaves each rank a block
of the self-attention cache's slots: decode writes a token on the rank
whose block holds its slot, each rank attends over its block in float32
(`decode_partials`: the block's max, sum of exponentials and weighted
values) and the blocks' partials are merged as a log-sum-exp combine
(`merge_partials`) after a counted all-gather -- or, with the cache over
"model" while ``wq``/``wo`` stay cut by heads, after an all-gather of q
and an all-to-all of the partials by head (`rank_heads`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import needs_grad
from repro_torch.models.common import ninit, out_scale, pdt, rmsnorm, rope
from repro_torch.sharding.partition import (cache_block, cache_seq,
                                            enter_region, exit_region, tp_of)

NEG_INF = -1e30

def init_attention(gen: torch.Generator, cfg: ArchConfig, cross: bool = False):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": ninit(gen, (D, H, hd), pdt(cfg)),
         "wk": ninit(gen, (D, KV, hd), pdt(cfg)),
         "wv": ninit(gen, (D, KV, hd), pdt(cfg)),
         "wo": ninit(gen, (H, hd, D), pdt(cfg), out_scale(cfg))}
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
    return p


def banded_swa_attention(q, k, v, *, window: int):
    """Sliding-window attention over a 2-block band: O(S*W) instead of
    O(S^2), the plain form (any device).

    Query block i touches only KV blocks {i-1, i} (block length ==
    window).  q: (B, Sq, KV, Gq, hd); k, v: (B, Sq, KV, hd); Sq % window
    == 0.  Returns (B, Sq, KV*Gq, hd) in q's dtype.
    """
    B, Sq, KV, Gq, hd = q.shape
    W = window
    nq = Sq // W
    scale = hd ** -0.5
    dev = q.device
    qb = q.reshape(B, nq, W, KV, Gq, hd).permute(0, 1, 3, 4, 2, 5).float()
    kb = k.reshape(B, nq, W, KV, hd)
    vb = v.reshape(B, nq, W, KV, hd)

    def prev(t):
        return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)

    # relative masks (W, W): diag block = causal & window; prev block = band
    qp = torch.arange(W, device=dev)[:, None]
    kp = torch.arange(W, device=dev)[None, :]
    mask_diag = (kp <= qp) & (qp - kp < W)
    mask_prev = (qp + W - kp) < W                      # kpos = kp - W
    block_valid = torch.arange(nq, device=dev) > 0     # block 0 has no prev

    m = l = acc = None
    for kj, vj, mask, valid in [
            (prev(kb), prev(vb), mask_prev, block_valid),
            (kb, vb, mask_diag, torch.ones((nq,), dtype=torch.bool,
                                           device=dev))]:
        kj = kj.permute(0, 1, 3, 2, 4)                 # (B, nq, KV, W, hd)
        vj = vj.permute(0, 1, 3, 2, 4)
        s = torch.einsum("bnkgqd,bnksd->bnkgqs", qb, kj.float()) * scale
        full_mask = mask[None, None, None] & valid[:, None, None, None, None]
        s = torch.where(full_mask[None], s, NEG_INF)
        mj = s.amax(dim=-1)
        pj = torch.exp(s - mj[..., None])
        lj = pj.sum(dim=-1)
        pvj = torch.einsum("bnkgqs,bnksd->bnkgqd", pj.to(vj.dtype).float(),
                           vj.float())
        if m is None:
            m, l, acc = mj, lj, pvj
        else:
            m_new = torch.maximum(m, mj)
            c1, c2 = torch.exp(m - m_new), torch.exp(mj - m_new)
            l = l * c1 + lj * c2
            acc = acc * c1[..., None] + pvj * c2[..., None]
            m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]   # (B,nq,KV,Gq,W,hd)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, KV * Gq, hd)
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, q_positions, kv_positions,
                      causal: bool = True, window: int = 0,
                      kv_chunk: int = 1024):
    """Online-softmax attention over KV chunks, the plain form (any
    device).

    q: (B, Sq, KV, Gq, hd); k, v: (B, Skv, KV, hd).  Positions are int
    vectors used for causal/sliding-window masking (a key at a negative
    position is masked).  Returns (B, Sq, KV*Gq, hd) in q's dtype.  Scores
    and P V accumulate in float32; P is rounded to v's dtype before P V,
    as in the reference.  A causal window over equal query and key
    lengths that the window divides into more than one block takes the
    banded form (`banded_swa_attention`), where the reference does.
    """
    B, Sq, KV, Gq, hd = q.shape
    Skv = k.shape[1]
    if (window and causal and Skv == Sq and Sq % window == 0
            and Sq // window > 1):
        return banded_swa_attention(q, k, v, window=window)
    scale = hd ** -0.5
    kc = min(kv_chunk, Skv)
    nkc = -(-Skv // kc)
    pad = nkc * kc - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-(10 ** 9))
    qt = q.permute(0, 2, 3, 1, 4).float()              # (B, KV, Gq, Sq, hd)
    m = torch.full((B, KV, Gq, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, Gq, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(nkc):
        kj = k[:, j * kc:(j + 1) * kc].transpose(1, 2)  # (B, KV, kc, hd)
        vj = v[:, j * kc:(j + 1) * kc].transpose(1, 2)
        kpj = kv_positions[j * kc:(j + 1) * kc]
        s = torch.einsum("bkgqd,bksd->bkgqs", qt, kj.float()) * scale
        mask = kpj[None, :] >= 0
        if causal:
            mask = mask & (kpj[None, :] <= q_positions[:, None])
        if window:
            mask = mask & ((q_positions[:, None] - kpj[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bksd->bkgqd", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * Gq, hd)
    return out.to(q.dtype)


def flash_prefill_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Prefill attention (queries at 0 .. Sq-1, keys at 0 .. Skv-1)
    through `ops.flash_attention`: causal self-attention, windowed or not,
    or (``causal=False``) cross attention over Skv != Sq keys.  q: (B, Sq,
    KV, Gq, hd) -> the kernel's contiguous (B, H, Sq, hd) with head ``h =
    kv * Gq + g``, which reads KV head ``h // Gq``, the kernel's grouping;
    k, v: (B, Skv, KV, hd) -> (B, KV, Skv, hd).  Returns (B, Sq, H, hd)
    in q's dtype.

    q, k and v of different dtypes (a cross layer fed float32 image
    embeddings promotes its K/V, as the reference's einsum does) run the
    kernel at their promoted dtype, as the reference's `chunked_attention`
    computes them, and the output is cast back to q's dtype: K/V are not
    rounded down to q's."""
    B, S, KV, Gq, hd = q.shape
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    qh = q.reshape(B, S, KV * Gq, hd).transpose(1, 2).to(dt).contiguous()
    kh = k.transpose(1, 2).to(dt).contiguous()
    vh = v.transpose(1, 2).to(dt).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=causal, window=window)
    return out.transpose(1, 2).reshape(B, S, KV * Gq, hd).to(q.dtype)


def prefill_attention(q, k, v, *, positions, kv_positions=None,
                      causal: bool = True, window: int = 0,
                      kv_chunk: int = 1024, flash: bool = True):
    """Prefill attention at query ``positions`` = 0 .. Sq-1 over keys at
    `kv_positions` (default the same): causal self-attention, with a
    sliding `window` or not, or cross attention (``causal=False``, keys
    at 0 .. Skv-1).

    On a CUDA tensor (with `flash`): the `flash_attention` kernel (on a
    ``meta`` tensor, a dry run, its shape-only route).  Otherwise -- any
    CPU tensor, or ``flash=False`` -- the plain `chunked_attention`.  The
    two round differently: the kernel keeps P as a bfloat16 hi + lo pair
    where the chunked form rounds it once, so in bfloat16 they differ by
    about one step of the output.
    The kernel has no backward pass: with `flash` under autograd this
    raises on either device (`flash_attention.needs_grad`), so train on
    ``flash=False``, as the reference trains on its chunked form.
    """
    if flash and (q.is_cuda or q.is_meta or needs_grad(q, k, v)):
        return flash_prefill_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(
        q, k, v, q_positions=positions,
        kv_positions=positions if kv_positions is None else kv_positions,
        causal=causal, window=window, kv_chunk=kv_chunk)


def _rowwise_positions(pos, B: int, Sq: int, device):
    """Normalise ``pos`` to a (B, Sq) int64 query-position matrix.

    Accepts a scalar (one shared clock), a (B,) per-row clock (continuous
    batching: each slot decodes at its own position), or the full (B, Sq)
    matrix a page-stepped prefill passes."""
    pos = torch.as_tensor(pos, device=device).long()
    if pos.dim() == 0:
        return pos.expand(B, Sq)
    if pos.dim() == 1:
        return pos[:, None].expand(B, Sq)
    return pos


def decode_attention(q, cache_k, cache_v, kpos, pos, *, window: int = 0):
    """Attention for Sq new tokens per row over a (ring-buffered) KV cache.

    q: (B, Sq, KV, Gq, hd); cache_k/v: (B, Sc, KV, hd); kpos: (B, Sc) or
    (Sc,) holding the absolute position stored in each cache slot
    (-1 == empty); pos: scalar, (B,) or (B, Sq) query positions.  Per-row
    masks keep every row's output a function of its own cache alone, so
    rows at different positions decode in one call.
    """
    B, Sq, KV, Gq, hd = q.shape
    Sc = cache_k.shape[1]
    if kpos.dim() == 1:
        kpos = kpos[None].expand(B, Sc)
    pos = _rowwise_positions(pos, B, Sq, q.device)
    scale = hd ** -0.5
    qt = q.permute(0, 2, 3, 1, 4).float()              # (B, KV, Gq, Sq, hd)
    s = torch.einsum("bkgqd,bskd->bkgqs", qt, cache_k.float()) * scale
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= pos[:, :, None])
    if window:
        mask = mask & ((pos[:, :, None] - kpos[:, None, :]) < window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bkgqd", (p / l).to(cache_v.dtype).float(),
                       cache_v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * Gq, hd)
    return out.to(q.dtype)


def decode_partials(q, cache_k, cache_v, kpos, pos, *, window: int = 0):
    """`decode_attention` over one block of a cache's slots, unnormalised:
    ``(B, KV, Gq, Sq, hd + 2)`` float32 holding each query's weighted
    values over the block (``sum exp(s - m) v``), then the block's max
    score ``m`` and sum of exponentials ``l`` -- the partial that
    `merge_partials` combines with the other blocks'.  A block with no
    live key has ``m`` = -1e30, which the merge weighs by 0."""
    B, Sq, KV, Gq, hd = q.shape
    Sc = cache_k.shape[1]
    if kpos.dim() == 1:
        kpos = kpos[None].expand(B, Sc)
    pos = _rowwise_positions(pos, B, Sq, q.device)
    qt = q.permute(0, 2, 3, 1, 4).float()              # (B, KV, Gq, Sq, hd)
    s = torch.einsum("bkgqd,bskd->bkgqs", qt, cache_k.float()) * hd ** -0.5
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= pos[:, :, None])
    if window:
        mask = mask & ((pos[:, :, None] - kpos[:, None, :]) < window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, cache_v.float())
    return torch.cat([acc, m[..., None], p.sum(dim=-1)[..., None]], dim=-1)


def merge_partials(parts):
    """The attention output from the blocks' partials stacked on dim 0
    (`decode_partials`' layout after it): the log-sum-exp combine, in
    block order, so every rank holding the same partials gets the same
    bits.  Returns (..., hd) float32."""
    acc, m, l = parts[..., :-2], parts[..., -2], parts[..., -1]
    top = m.amax(dim=0)
    c = torch.exp(m - top)
    total = (l * c).sum(dim=0)
    return (acc * c[..., None]).sum(dim=0) / torch.clamp(
        total, min=1e-20)[..., None]


def _project(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` in x's dtype."""
    B, S, D = x.shape
    return (x @ w.to(x.dtype).reshape(D, -1)).view(B, S, *w.shape[1:])


def write_cache(cache: dict, k_new, v_new, pos, write_mask=None,
                slots: Optional[int] = None, lo: int = 0) -> None:
    """Write the new tokens' K/V into `cache` ({k, v: (B, Sc, KV, hd),
    kpos: (B, Sc)}) in place, at slot ``pos % Sc`` of their own row;
    a token whose `write_mask` (B, Sq) is False leaves its slot as it was.
    The reference's masked one-hot scatter, as a gather and a scatter:
    the values committed are the same bits.  A row's Sq positions must
    fall on distinct slots (Sq <= Sc, as without a sliding window).

    `slots` given: `cache` is the block of a cache of that many slots
    homed by sequence that starts at slot `lo` (`partition.cache_block`),
    and only the tokens whose slot lies in it are written, at ``slot -
    lo``, one query column at a time (a token outside the block is
    clamped to a slot it leaves as it was, which may be one another
    column writes)."""
    B, Sq = pos.shape
    blk = cache["k"].shape[1]
    wmask = (torch.ones((B, Sq), dtype=torch.bool, device=pos.device)
             if write_mask is None else write_mask)
    if slots is None:
        _scatter_slots(cache, k_new, v_new, pos, pos % blk, wmask)
        return
    local = pos % slots - lo
    wmask = wmask & (local >= 0) & (local < blk)
    local = local.clamp(0, blk - 1)
    for j in range(Sq):
        c = slice(j, j + 1)
        _scatter_slots(cache, k_new[:, c], v_new[:, c], pos[:, c],
                       local[:, c], wmask[:, c])


def _scatter_slots(cache: dict, k_new, v_new, pos, slot, wmask) -> None:
    """`write_cache`'s gather and scatter at (B, Sq) cache `slot`s."""
    B, Sq = pos.shape
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = cache[name]
        idx = slot[:, :, None, None].expand(B, Sq, *leaf.shape[2:])
        keep = leaf.gather(1, idx)
        leaf.scatter_(1, idx, torch.where(wmask[:, :, None, None],
                                          new.to(leaf.dtype), keep))
    kp = cache["kpos"]
    kp.scatter_(1, slot, torch.where(wmask, pos.to(kp.dtype),
                                     kp.gather(1, slot)))


def _build_cache(k, v, positions, *, window: int, cache_len,
                 plan=None) -> dict:
    """The decode cache a prefill of (B, Sq) tokens builds from its K/V:
    sized for the decode horizon ``max(cache_len, Sq)``, or a ring of
    ``Sc = min(window, horizon)`` slots under a sliding window, holding
    the last ``keep = min(Sc, Sq)`` positions at slots 0 .. keep-1, the
    rest empty (position -1).  Per-row kpos: decode is per-slot-clocked,
    so each row carries its own occupancy map from here on.  Where the
    plan homes the cache by sequence, this rank's block of those slots
    (`partition.cache_block`).

    The reference's layout, kept as it is: decode writes position p at
    slot ``p % Sc``, which is where prefill put it only when ``Sq <= Sc``
    or ``Sq % Sc == 0``; otherwise decode evicts a key still inside the
    window (ROADMAP.md, reference caveats)."""
    B, Sq = k.shape[:2]
    total = max(cache_len or Sq, Sq)
    Sc = min(window, total) if window else total
    keep = min(Sc, Sq)
    lo, blk = cache_block(Sc, plan)
    ck = k.new_zeros((B, blk, *k.shape[2:]))
    cv = v.new_zeros((B, blk, *v.shape[2:]))
    kp = torch.full((B, blk), -1, dtype=torch.int32, device=k.device)
    a, b = lo, min(lo + blk, keep)         # the block's slots holding keys
    if b > a:
        src = slice(Sq - keep + a, Sq - keep + b)
        ck[:, a - lo:b - lo] = k[:, src]
        cv[:, a - lo:b - lo] = v[:, src]
        kp[:, a - lo:b - lo] = positions[src].to(torch.int32)
    return {"k": ck, "v": cv, "kpos": kp}


class RankHeads(NamedTuple):
    """This rank's share of an attention layer (`rank_heads`)."""

    H: int                 # q heads (its ``wq``/``wo`` block)
    KV: int                # KV heads those q heads read
    kv_sel: slice          # their range of the KV heads it holds
    split: bool            # whether ``wo``'s products are partial sums
    seq: Tuple[int, int]   # (ranks, index) homing the cache's sequence
    by_head: bool          # the cache over "model" with heads split there


def rank_heads(cfg: ArchConfig, plan=None) -> RankHeads:
    """This rank's heads, and the block of the decode cache it holds.

    Unsplit: all ``H`` q heads over all ``KV`` heads.  Across the ranks
    of a "model" axis where the plan sets ``head_axis``, rank i holds the
    q heads ``[i * H/M, (i + 1) * H/M)`` and attends over the KV heads
    they read, ``h // (H / KV)``: with ``kv_axis`` set its own block of
    KV heads (the whole selector), else the contiguous range of the
    whole (replicated) KV heads those q heads read.

    ``seq``: where the plan homes the decode cache's sequence over ranks
    (``cache_seq_axis``: over "data" when the batch does not divide over
    the homes, over "model" when the KV heads do not), each rank of that
    axis keeps a block of the self-attention cache's slots, with the KV
    heads its head split gives it.  ``by_head``: the cache over "model"
    while the heads are cut there too -- decode then gathers every
    head's q for its block and sends each rank its heads' partials (the
    reference keeps the heads whole on that axis,
    `repro/models/attention.py:276-283`)."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    M, i = tp_of(plan)
    seq = cache_seq(plan)
    if M == 1 or plan.head_axis is None:
        return RankHeads(H, KV, slice(None), False, seq, False)
    Hl, Gq = H // M, H // KV
    by_head = seq[0] > 1 and plan.cache_seq_axis == plan.tp
    if plan.kv_axis is not None:
        return RankHeads(Hl, KV // M, slice(None), True, seq, by_head)
    lo, hi = i * Hl // Gq, ((i + 1) * Hl - 1) // Gq + 1
    return RankHeads(Hl, hi - lo, slice(lo, hi), True, seq, by_head)


def _decode_blocks(q, cache: dict, pos, *, slots: int, rh: RankHeads,
                   window: int, plan):
    """Decode attention over a cache homed by sequence: this rank's
    partials over its block (its real slots: a padded tail is left out),
    merged across the cache's axis -- all-gathered there, or with
    ``rh.by_head`` every head's q all-gathered over "model" first and
    the partials sent to their heads' ranks by one all-to-all.  q: (B,
    Sq, H, hd) of the rank's heads; returns (B, Sq, H, hd) float32."""
    from repro_torch.core import collectives
    B, Sq, H, hd = q.shape
    n, ci = rh.seq
    kv_sel = rh.kv_sel
    lo, blk = cache_block(slots, plan)
    real = min(blk, slots - lo)
    if real <= 0:
        raise ValueError(f"a cache of {slots} slots leaves rank {ci} of "
                         f"{n} no slot")
    ck, cv, kp = (cache["k"][:, :real], cache["v"][:, :real],
                  cache["kpos"][:, :real])
    mesh, cax = plan.mesh, (plan.cache_seq_axis,)
    if rh.by_head:
        M = n
        qa = collectives.all_gather(q.contiguous(), mesh, cax)
        qa = qa.permute(1, 2, 0, 3, 4).reshape(B, Sq, M * H, hd)
        KV = ck.shape[2]
        part = decode_partials(qa.reshape(B, Sq, KV, M * H // KV, hd),
                               ck, cv, kp, pos, window=window)
        part = part.reshape(B, M, H, Sq, hd + 2).transpose(0, 1)
        parts = collectives.all_to_all(part.contiguous(), mesh, cax)
        out = merge_partials(parts)                    # (B, H, Sq, hd)
        return out.transpose(1, 2)
    KV = ck[:, :, kv_sel].shape[2]
    part = decode_partials(q.reshape(B, Sq, KV, H // KV, hd),
                           ck[:, :, kv_sel], cv[:, :, kv_sel], kp, pos,
                           window=window)
    out = merge_partials(collectives.all_gather(part, mesh, cax))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def apply_attention(p, x, *, cfg: ArchConfig, positions=None,
                    cache: Optional[dict] = None, pos=None, kv_src=None,
                    build_cache: bool = False, cross: bool = False,
                    kv_chunk: int = 1024, cache_len: Optional[int] = None,
                    write_mask=None, flash: bool = True, plan=None,
                    cache_slots: Optional[int] = None):
    """Full attention block body (no residual/norm -- the block adds those).

    Returns (y, new_cache).  Decode (`cache` given, {k, v, kpos} of this
    layer): Sq new tokens per row at ``pos``, written into `cache` in
    place (`write_cache`; `write_mask` (B, Sq) gates the commits), then
    attended over it, inside the sliding window if the config has one;
    returns `cache`.  Through a cross layer (`cross`) decode reads the
    static image cache {k, v, kpos: (n,)} and writes nothing.  Prefill
    (`build_cache`): returns the cache built from this call's K/V
    (`_build_cache`, sized for ``cache_len``; a cross layer's is the image
    K/V of `kv_src`, with no RoPE).  `flash`: prefill attention through
    the kernel on a CUDA tensor (`prefill_attention`).

    Across the ranks of a "model" axis (`plan` on a `RankMesh`, see
    `rank_heads`) the rank runs its own q heads over the KV heads they
    read: its ``wq``/``wo`` blocks, its ``wk``/``wv`` (and cache) block
    where the KV heads are split too, else the KV heads' contiguous
    range of the whole ones; ``wo``'s partial products are summed by one
    `psum`.  A cross layer's image K/V are projected at the rank's KV
    heads the same way, and its static cache holds them (the reference's
    ``P(None, b, None, kv, None)``; its kpos stays whole).  Training
    with the residual sequence-sharded (`partition.seq_split`) gathers
    `x`'s sequence first and reduce-scatters ``wo``'s partial products
    back onto the rank's rows (`enter_region`, `exit_region`);
    `positions` are the whole sequence's.

    A plan that homes the decode cache by sequence (``rank_heads(...)
    .seq``): prefill builds this rank's block of the cache it computes,
    and decode writes and attends as the module docstring says;
    `cache_slots` is the whole cache's slot count (default the block's
    times the ranks: pass it where they do not divide it).
    """
    hd = cfg.head_dim
    W = 0 if cross else cfg.sliding_window
    rh = rank_heads(cfg, plan)
    H, KV, kv_sel, split = rh.H, rh.KV, rh.kv_sel, rh.split
    Gq = H // KV
    x = enter_region(x, plan, split)
    B, Sq, D = x.shape

    q = _project(x, p["wq"])
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)

    new_cache = None
    if cache is not None and cross:
        # ---- decode through a cross layer: static image KV
        out = decode_attention(q.reshape(B, Sq, KV, Gq, hd),
                               cache["k"][:, :, kv_sel],
                               cache["v"][:, :, kv_sel], cache["kpos"],
                               2 ** 30)
        new_cache = cache
    elif cache is not None:
        # ---- decode / page-step: Sq new tokens per row, masked write
        k = _project(x, p["wk"])
        v = _project(x, p["wv"])
        if "k_norm" in p:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
        pos = _rowwise_positions(pos, B, Sq, x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        new_cache = cache
        if rh.seq[0] == 1:
            write_cache(cache, k, v, pos, write_mask)
            out = decode_attention(q.reshape(B, Sq, KV, Gq, hd),
                                   cache["k"][:, :, kv_sel],
                                   cache["v"][:, :, kv_sel], cache["kpos"],
                                   pos, window=W)
        else:
            slots = cache_slots or cache["k"].shape[1] * rh.seq[0]
            write_cache(cache, k, v, pos, write_mask, slots=slots,
                        lo=cache_block(slots, plan)[0])
            out = _decode_blocks(q, cache, pos, slots=slots, rh=rh,
                                 window=W, plan=plan).to(q.dtype)
    else:
        # ---- train / prefill
        if positions is None:
            positions = torch.arange(Sq, device=x.device)
        if cross:
            # the image embeddings keep their own dtype, as the
            # reference's einsum promotes them with the weights
            src = kv_src.to(torch.promote_types(kv_src.dtype, x.dtype))
            k = _project(src, p["wk"].to(x.dtype))
            v = _project(src, p["wv"].to(x.dtype))
            kv_positions = torch.arange(kv_src.shape[1], device=x.device)
        else:
            k = _project(x, p["wk"])
            v = _project(x, p["wv"])
            if "k_norm" in p:
                k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            kv_positions = positions
        out = prefill_attention(q.reshape(B, Sq, KV, Gq, hd),
                                k[:, :, kv_sel], v[:, :, kv_sel],
                                positions=positions,
                                kv_positions=kv_positions, causal=not cross,
                                window=W, kv_chunk=kv_chunk, flash=flash)
        if build_cache and cross:
            new_cache = {"k": k, "v": v,
                         "kpos": torch.zeros((kv_src.shape[1],),
                                             dtype=torch.int32,
                                             device=x.device)}
        elif build_cache:
            new_cache = _build_cache(k, v, positions, window=W,
                                     cache_len=cache_len, plan=plan)

    y = exit_region(out.reshape(B, Sq, H * hd)
                    @ p["wo"].to(x.dtype).reshape(H * hd, D), plan, split)
    return y, new_cache
