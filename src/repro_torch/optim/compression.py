"""Gradient compression: int8 block quantisation + error feedback, the
counterpart of `repro/optim/compression.py`.

`quantize` is symmetric per-block int8 with round-half-to-even (as
``jnp.round``), so its payload equals the reference's bit for bit;
`error_feedback_update` keeps the quantisation bias from accumulating
across steps.  `compressed_psum` is the int8-wire sum over the ranks of a
`RankMesh` axis: an all-gather of the int8 payloads and the float32
scales (`core.collectives`, counted), then a local dequantise-and-sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.core.homing import Axis
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


def gather_quantized(x: torch.Tensor, mesh, axis: Axis, block: int = 256):
    """The wire of `compressed_psum`: every rank's `quantize` payload and
    scales, all-gathered over `axis` of a `RankMesh`: ``(g, blocks,
    block)`` int8 and ``(g, blocks)`` float32, in the ranks' order."""
    q, s = quantize(x, block)
    return (collectives.all_gather(q, mesh, axis),
            collectives.all_gather(s, mesh, axis))


def compressed_psum(x: torch.Tensor, mesh, axis: Axis,
                    block: int = 256) -> torch.Tensor:
    """int8-wire psum over the ranks of `axis` (`repro/optim/compression.py:
    52-64`): the all-gather moves 1 byte a (padded) element plus a float32
    scale a block, instead of 4 bytes an element.  The sum is exact up to
    the quantisation error (scale/2 an element)."""
    qg, sg = gather_quantized(x, mesh, axis, block)
    deq = qg.float() * sg[..., None]
    total = deq.sum(dim=0).reshape(-1)
    return total[:x.numel()].reshape(x.shape).to(x.dtype)
