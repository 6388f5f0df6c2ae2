"""Coverage probe: hold a plan's output tile maps to what the card writes.

A kernel's plan (`analysis.launches`) says which tiles of each output each
block writes; rule R5 proves race freedom and coverage from that claim.
The probe checks the claim itself, on the card: it runs the planned call
once with every output buffer filled with a poison bit pattern that the
call cannot write for the probe's inputs (each kernel module's ``probe``
picks such inputs: sort keys from [0, 2^20), finite floats), then compares
the set of elements that lost the poison with the image of the output tile
maps over all the call's launches.  They must be equal: an element written
outside the image, or an image element left poisoned, is a mismatch.
"""
from __future__ import annotations

import importlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.launches import (LaunchFacts, grid_blocks,
                                           operand_tiles)

#: the poison of each element size: a NaN payload no float kernel of the
#: port produces from finite inputs, above every sort key of the probes
POISON_BITS = {4: 0x7FBADBAD, 2: 0x7FAD}
_INT_OF = {4: torch.int32, 2: torch.int16}


def poisoned(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of `shape` and `dtype` whose every element is the poison."""
    size = torch.empty((), dtype=dtype).element_size()
    return torch.full(tuple(shape), POISON_BITS[size], dtype=_INT_OF[size],
                      device=device).view(dtype)


def written(t: torch.Tensor) -> torch.Tensor:
    """Flat bool mask of the elements of `t` that no longer hold the poison."""
    size = t.element_size()
    return t.reshape(-1).view(_INT_OF[size]) != POISON_BITS[size]


def image(facts: Sequence[LaunchFacts], buffer: str, numel: int,
          device="cpu") -> torch.Tensor:
    """Flat bool mask over `buffer` of the elements the launches' output
    tile maps write (tiles clipped to the array)."""
    out = torch.zeros(numel, dtype=torch.bool, device=device)
    for fc in facts:
        blocks = grid_blocks(fc.grid)
        for op in fc.outputs:
            if op.buffer != buffer:
                continue
            _, tiles = operand_tiles(op, blocks)
            cells = tuple(-(-a // b) for a, b in zip(op.array_shape,
                                                     op.tile_shape))
            ok = np.all((tiles >= 0) & (tiles < np.asarray(cells)), axis=1)
            mask = np.zeros(cells, dtype=bool)
            mask[tuple(tiles[ok].T)] = True
            m = torch.from_numpy(mask).to(device)
            for d, b in enumerate(op.tile_shape):
                m = m.repeat_interleave(b, dim=d)
            m = m[tuple(slice(0, a) for a in op.array_shape)].reshape(-1)
            out[op.offset:op.offset + m.numel()] |= m
    return out


def coverage_probe(call: Tuple, device="cuda") -> Dict[str, Dict[str, int]]:
    """Run one planned call (``LaunchFacts.call``) with poisoned outputs;
    per output buffer, the elements the image holds, the elements written,
    and the mismatches between the two (0 when the tile maps are exact)."""
    module, args = call
    mod = importlib.import_module(module)
    facts = mod.plan(*args)
    bufs = mod.probe(*args, device=device)
    out = {}
    for name, t in bufs.items():
        want = image(facts, name, t.numel(), t.device)
        got = written(t)
        out[name] = dict(image=int(want.sum()), written=int(got.sum()),
                         mismatches=int((want != got).sum()))
    return out
