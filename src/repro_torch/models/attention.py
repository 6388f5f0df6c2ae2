"""Attention: GQA + qk-norm + KV cache, for prefill and decode.

The counterpart of `repro/models/attention.py`.  Prefill attention is the
reference's *chunked* online softmax over KV blocks (`chunked_attention`,
the plain form) or, on a CUDA tensor, the hand-written `flash_attention`
kernel, which the reference names as the drop-in for the same computation
(`prefill_attention` dispatches on where the tensor lies).  Decode and the
page-stepped prefill attend over the KV cache (`decode_attention`, plain,
as in the reference).  Where the reference's einsums accumulate in float32
(``preferred_element_type``), the operands are cast to float32 first, so
that a bfloat16 product is not rounded to bfloat16 in between.

Not ported yet: sliding windows (`banded_swa_attention`) and cross
attention; a config that needs them raises `NotImplementedError`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import needs_grad
from repro_torch.models.common import ninit, out_scale, pdt, rmsnorm, rope

NEG_INF = -1e30

#: what to say where a config needs a part of attention not ported yet
NOT_PORTED = ("is not ported yet (ROADMAP.md Queue 1: the rest of the model "
              "stack)")


def init_attention(gen: torch.Generator, cfg: ArchConfig):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": ninit(gen, (D, H, hd), pdt(cfg)),
         "wk": ninit(gen, (D, KV, hd), pdt(cfg)),
         "wv": ninit(gen, (D, KV, hd), pdt(cfg)),
         "wo": ninit(gen, (H, hd, D), pdt(cfg), out_scale(cfg))}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
    return p


def chunked_attention(q, k, v, *, q_positions, kv_positions,
                      kv_chunk: int = 1024):
    """Causal online-softmax attention over KV chunks, the plain form (any
    device).

    q: (B, Sq, KV, Gq, hd); k, v: (B, Skv, KV, hd).  Positions are int
    vectors used for the causal mask (a key at a negative position is
    masked).  Returns (B, Sq, KV*Gq, hd) in q's dtype.  Scores and P V
    accumulate in float32; P is rounded to v's dtype before P V, as in the
    reference.  (The reference's sliding-window masks and non-causal cross
    attention wait for the members that use them.)
    """
    B, Sq, KV, Gq, hd = q.shape
    Skv = k.shape[1]
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
        mask = (kpj[None, :] >= 0) & (kpj[None, :] <= q_positions[:, None])
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


def flash_prefill_attention(q, k, v):
    """Causal self-attention of a prefill (positions 0 .. S-1) through
    `ops.flash_attention`.  q: (B, S, KV, Gq, hd) -> the kernel's
    contiguous (B, H, S, hd) with head ``h = kv * Gq + g``, which reads KV
    head ``h // Gq``, the kernel's grouping; k, v: (B, S, KV, hd) ->
    (B, KV, S, hd).  Returns (B, S, H, hd)."""
    B, S, KV, Gq, hd = q.shape
    qh = q.reshape(B, S, KV * Gq, hd).transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=True)
    return out.transpose(1, 2).reshape(B, S, KV * Gq, hd)


def prefill_attention(q, k, v, *, positions, kv_chunk: int = 1024,
                      flash: bool = True):
    """Causal prefill self-attention at ``positions`` = 0 .. S-1.

    On a CUDA tensor (with `flash`): the `flash_attention` kernel.
    Otherwise -- any CPU tensor, or ``flash=False`` on the card -- the
    plain `chunked_attention`.  The two round differently: the kernel
    keeps P as a bfloat16 hi + lo pair where the chunked form rounds it
    once, so in bfloat16 they differ by about one step of the output.
    The kernel has no backward pass: with `flash` under autograd this
    raises on either device (`flash_attention.needs_grad`), so train on
    ``flash=False``, as the reference trains on its chunked form.
    """
    if flash and (q.is_cuda or needs_grad(q, k, v)):
        return flash_prefill_attention(q, k, v)
    return chunked_attention(q, k, v, q_positions=positions,
                             kv_positions=positions, kv_chunk=kv_chunk)


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


def decode_attention(q, cache_k, cache_v, kpos, pos):
    """Attention for Sq new tokens per row over a KV cache.

    q: (B, Sq, KV, Gq, hd); cache_k/v: (B, Sc, KV, hd); kpos: (B, Sc)
    holding the absolute position stored in each cache slot
    (-1 == empty); pos: scalar, (B,) or (B, Sq) query positions.  Per-row
    masks keep every row's output a function of its own cache alone, so
    rows at different positions decode in one call.
    """
    B, Sq, KV, Gq, hd = q.shape
    pos = _rowwise_positions(pos, B, Sq, q.device)
    scale = hd ** -0.5
    qt = q.permute(0, 2, 3, 1, 4).float()              # (B, KV, Gq, Sq, hd)
    s = torch.einsum("bkgqd,bskd->bkgqs", qt, cache_k.float()) * scale
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= pos[:, :, None])
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bkgqd", (p / l).to(cache_v.dtype).float(),
                       cache_v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * Gq, hd)
    return out.to(q.dtype)


def _project(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` in x's dtype."""
    B, S, D = x.shape
    return (x @ w.to(x.dtype).reshape(D, -1)).view(B, S, *w.shape[1:])


def write_cache(cache: dict, k_new, v_new, pos, write_mask=None) -> None:
    """Write the new tokens' K/V into `cache` ({k, v: (B, Sc, KV, hd),
    kpos: (B, Sc)}) in place, at slot ``pos % Sc`` of their own row;
    a token whose `write_mask` (B, Sq) is False leaves its slot as it was.
    The reference's masked one-hot scatter, as a gather and a scatter:
    the values committed are the same bits.  A row's Sq positions must
    fall on distinct slots (Sq <= Sc, as without a sliding window)."""
    B, Sq = pos.shape
    Sc = cache["k"].shape[1]
    slot = pos % Sc
    wmask = (torch.ones((B, Sq), dtype=torch.bool, device=pos.device)
             if write_mask is None else write_mask)
    for name, new in (("k", k_new), ("v", v_new)):
        leaf = cache[name]
        idx = slot[:, :, None, None].expand(B, Sq, *leaf.shape[2:])
        keep = leaf.gather(1, idx)
        leaf.scatter_(1, idx, torch.where(wmask[:, :, None, None],
                                          new.to(leaf.dtype), keep))
    kp = cache["kpos"]
    kp.scatter_(1, slot, torch.where(wmask, pos.to(kp.dtype),
                                     kp.gather(1, slot)))


def apply_attention(p, x, *, cfg: ArchConfig, positions=None,
                    cache: Optional[dict] = None, pos=None,
                    build_cache: bool = False, kv_chunk: int = 1024,
                    cache_len: Optional[int] = None, write_mask=None,
                    flash: bool = True):
    """Full attention block body (no residual/norm -- the block adds those).

    Returns (y, new_cache).  Decode (`cache` given, {k, v, kpos} of this
    layer): Sq new tokens per row at ``pos``, written into `cache` in
    place (`write_cache`; `write_mask` (B, Sq) gates the commits), then
    attended over it; returns `cache`.  Prefill (`build_cache`): returns
    the cache built from this call's K/V, sized for ``cache_len``.
    `flash`: prefill attention through the kernel on a CUDA tensor
    (`prefill_attention`).
    """
    if cfg.sliding_window:
        raise NotImplementedError(f"sliding-window attention {NOT_PORTED}")
    B, Sq, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Gq = H // KV

    q = _project(x, p["wq"])
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "k_norm" in p:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)

    new_cache = None
    if cache is not None:
        # ---- decode / page-step: Sq new tokens per row, masked write
        pos = _rowwise_positions(pos, B, Sq, x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        write_cache(cache, k, v, pos, write_mask)
        new_cache = cache
        out = decode_attention(q.reshape(B, Sq, KV, Gq, hd), cache["k"],
                               cache["v"], cache["kpos"], pos)
    else:
        # ---- train / prefill ----
        if positions is None:
            positions = torch.arange(Sq, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = prefill_attention(q.reshape(B, Sq, KV, Gq, hd), k, v,
                                positions=positions, kv_chunk=kv_chunk,
                                flash=flash)
        if build_cache:
            # cache sized for the full decode horizon; per-row kpos: decode
            # is per-slot-clocked, so each row carries its own occupancy
            Sc = max(cache_len or Sq, Sq)
            ck = k.new_zeros((B, Sc, KV, hd))
            cv = v.new_zeros((B, Sc, KV, hd))
            ck[:, :Sq] = k
            cv[:, :Sq] = v
            kp = torch.full((B, Sc), -1, dtype=torch.int32, device=x.device)
            kp[:, :Sq] = positions.to(torch.int32)
            new_cache = {"k": ck, "v": cv, "kpos": kp}

    y = out.reshape(B, Sq, H * hd) @ p["wo"].to(x.dtype).reshape(H * hd, D)
    return y, new_cache
