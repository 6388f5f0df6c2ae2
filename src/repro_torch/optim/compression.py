"""Gradient compression: int8 block quantisation + error feedback, the
counterpart of `repro/optim/compression.py`.

`quantize` is symmetric per-block int8 with round-half-to-even (as
``jnp.round``), so its payload equals the reference's bit for bit;
`error_feedback_update` keeps the quantisation bias from accumulating
across steps.  The reference's `compressed_psum` (an int8-wire all-gather
inside ``shard_map``) needs collectives across ranks: it comes with the
``torch.distributed`` backend (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map


def quantize(x: torch.Tensor, block: int = 256):
    """Symmetric per-block int8 quantisation. Returns (q int8 (blocks,
    block), scales float32 (blocks,))."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.view(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    deq = (q.float() * scale[:, None]).reshape(-1)
    return deq[:math.prod(shape)].reshape(shape)


def compress_tree(tree, block: int = 256):
    """Every tensor leaf as its ``(q, scales)`` pair."""
    return tree_map(lambda x: quantize(x, block), tree)


def decompress_tree(ctree, shapes_tree):
    """The inverse of `compress_tree`, each leaf shaped as in
    `shapes_tree`."""
    return tree_map(lambda qs, ref: dequantize(qs[0], qs[1], ref.shape),
                    ctree, shapes_tree)


def error_feedback_update(grad: torch.Tensor, ef: torch.Tensor,
                          block: int = 256):
    """Quantise (grad + ef); return (dequantised grad, new ef residual)."""
    g = grad.float() + ef
    q, s = quantize(g, block)
    deq = dequantize(q, s, g.shape)
    return deq.to(grad.dtype), g - deq
