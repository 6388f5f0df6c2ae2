"""Rules R5/R7/R8 over the port's kernel launches.

The counterpart of `repro/analysis/kernelcheck.py`.  Facts come from the
launch plans of the wrappers (`analysis.launches`: grid, operands with
tile maps, index type, lanes), recorded while a workload runs; nothing
here launches a kernel.

  R5 write-race/coverage -- replay every output tile map over the whole
      grid.  **The one semantic difference from the reference:** TPU grid
      steps run in order on one core, so the reference lets grid dims the
      block index ignores revisit a block (sequential accumulation, e.g.
      flash attention's KV axis).  CUDA blocks run concurrently and in no
      order, so there is no such exemption here: any output tile written
      by two distinct blocks is a write race (ERROR).  A tile cell of the
      output that no block writes is a gap (WARN -- uninitialised output).
      Input tiles that start wholly outside the array are out-of-bounds
      reads (ERROR).  Within one block, a tile written twice is no race.
  R7 index-arithmetic/sentinel -- a tile whose merged domain (2 x tile
      elements) exceeds the launch's declared index type overflows rank
      arithmetic (ERROR); `merge_split` computes merge-path ranks in 64
      bits and declares "int64".  The BIG sentinel
      (`repro_torch.core.sort.pad_value`) must cast into each key dtype
      without clipping (ERROR) and compare strictly after every finite
      key (a finite float sentinel is a WARN, an integer one below the
      dtype's max a WARN).
  R8 grid-dead-lane -- each declared lane ``(axis, comparison, value)`` is
      evaluated over the whole grid axis, exactly (one comparison holds
      somewhere on [0, size) iff it holds at 0, size - 1 or next to the
      value); one that no block index satisfies is code that never runs
      (WARN -- usually a stale grid constant).

The replay is vectorised (numpy over all blocks at once), so the grid
cap rises from the reference's 65,536 points to `MAX_GRID_POINTS` = 2^24
blocks: every launch of the n = 100 M sorts is replayed in full.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.findings import Finding, Report, Severity
from repro_torch.analysis.launches import (COMPARISONS, LaunchFacts,
                                           OperandFacts, grid_blocks,
                                           operand_tiles)

#: R5 replays tile maps over every block; cap the enumeration.
MAX_GRID_POINTS = 1 << 24

_AXES = "xyz"


def _block(fc: LaunchFacts, lin: int):
    """The (x, y, z) block index of linear block `lin`."""
    gx, gy, _ = fc.grid
    return (int(lin % gx), int(lin // gx % gy), int(lin // (gx * gy)))


def r5_block_coverage(report: Report, facts: Sequence[LaunchFacts]) -> None:
    """Prove each output's tile images partition it; bound input reads."""
    for fc in facts:
        if fc.blocks > MAX_GRID_POINTS:
            report.notes.append(
                f"R5 skipped for {fc.name}: grid {fc.grid} has "
                f"{fc.blocks:,} blocks (> {MAX_GRID_POINTS:,})")
            continue
        blocks = grid_blocks(fc.grid)
        for k, op in enumerate(fc.outputs):
            _check_output(report, fc, k, op, blocks)
        for k, op in enumerate(fc.inputs):
            _check_input(report, fc, k, op, blocks)


def _cells(op: OperandFacts):
    return tuple(max(1, -(-a // b)) for a, b in zip(op.array_shape,
                                                    op.tile_shape))


def _check_output(report: Report, fc: LaunchFacts, k: int, op: OperandFacts,
                  blocks) -> None:
    blk, tiles = operand_tiles(op, blocks)
    cells = _cells(op)
    inside = np.all((tiles >= 0) & (tiles < np.asarray(cells)), axis=1)
    lin = np.ravel_multi_index(tuple(tiles[inside].T), cells)
    blk = blk[inside]

    # write race: one tile, two distinct blocks (no sequential revisits)
    order = np.lexsort((blk, lin))
    lin_s, blk_s = lin[order], blk[order]
    fresh = np.ones(len(lin_s), dtype=bool)
    fresh[1:] = (lin_s[1:] != lin_s[:-1]) | (blk_s[1:] != blk_s[:-1])
    lin_s, blk_s = lin_s[fresh], blk_s[fresh]
    dup = np.flatnonzero(lin_s[1:] == lin_s[:-1])
    if dup.size:
        i = dup[0]
        tile = tuple(int(t) for t in np.unravel_index(lin_s[i], cells))
        report.add(Finding(
            "R5", Severity.ERROR, "launch", shape=fc.name,
            message=f"write race on output {k} ({op.buffer}): blocks "
                    f"{_block(fc, blk_s[i])} and {_block(fc, blk_s[i + 1])} "
                    f"of grid {tuple(fc.grid)} both write tile {tile} "
                    f"(tile {op.tile_shape}) -- CUDA blocks run "
                    f"concurrently, so the last writer is arbitrary"))

    # coverage: every tile cell of the output must be written
    hit = np.zeros(int(np.prod(cells, dtype=np.int64)), dtype=bool)
    hit[lin] = True
    gap = np.flatnonzero(~hit)
    if gap.size:
        cell = tuple(int(c) for c in np.unravel_index(gap[0], cells))
        report.add(Finding(
            "R5", Severity.WARN, "launch", shape=fc.name,
            message=f"coverage gap on output {k} ({op.buffer}): tile cell "
                    f"{cell} of {cells} (array {op.array_shape}, tile "
                    f"{op.tile_shape}) is never written -- that region of "
                    f"the output is uninitialised"))


def _check_input(report: Report, fc: LaunchFacts, k: int, op: OperandFacts,
                 blocks) -> None:
    blk, tiles = operand_tiles(op, blocks)
    tile = np.asarray(op.tile_shape)
    extent = np.maximum(np.asarray(op.array_shape), 1)
    bad = (tiles < 0) | (tiles * tile >= extent)
    rows = np.flatnonzero(bad.any(axis=1))
    if rows.size:
        r = rows[0]
        d = int(np.flatnonzero(bad[r])[0])
        report.add(Finding(
            "R5", Severity.ERROR, "launch", shape=fc.name,
            message=f"out-of-bounds read on input {k} ({op.buffer}): block "
                    f"{_block(fc, blk[r])} reads tile "
                    f"{tuple(int(t) for t in tiles[r])}, dim {d} at tile "
                    f"{int(tiles[r, d])} (tile size {int(tile[d])}, array "
                    f"extent {op.array_shape[d]}) -- the tile starts "
                    f"entirely outside the array"))


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype, torch dtype or its name as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and hasattr(torch, dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def r7_index_arith(report: Report, facts: Sequence[LaunchFacts],
                   index_dtype: Optional[str] = None,
                   sentinel: Optional[Any] = None) -> None:
    """Rank-domain overflow + BIG-sentinel safety per launch.

    Ranks are checked in each launch's declared index type unless
    `index_dtype` overrides it (fixture hook); `sentinel` overrides the
    port's `pad_value` the same way.
    """
    from repro_torch.core.sort import pad_value
    for fc in facts:
        idx = index_dtype or fc.index_dtype
        imax = torch.iinfo(_torch_dtype(idx)).max
        for k, op in enumerate(fc.inputs + fc.outputs):
            numel = int(np.prod(op.tile_shape, dtype=np.int64))
            if 2 * numel > imax:
                report.add(Finding(
                    "R7", Severity.ERROR, "launch", shape=fc.name,
                    actual_bytes=float(2 * numel),
                    predicted_bytes=float(imax),
                    message=f"operand {k} ({op.buffer}) tile "
                            f"{op.tile_shape} merges 2x{numel:,} elements "
                            f"but its ranks are {idx} (max {imax:,}) -- "
                            f"rank arithmetic overflows at this size"))
        for dt in sorted({op.dtype for op in fc.inputs + fc.outputs}):
            dtype = _torch_dtype(dt)
            if dtype == torch.bool:
                continue
            big = sentinel if sentinel is not None else pad_value(dtype)
            _check_sentinel(report, fc.name, dtype, big)


def _check_sentinel(report: Report, name: str, dtype, big: Any) -> None:
    dtype = _torch_dtype(dtype)
    if dtype.is_floating_point:
        lowered = float(torch.tensor(float(big), dtype=torch.float64)
                        .to(dtype))
        clipped = (np.isfinite(big) and
                   (np.isinf(lowered) or lowered != float(big)))
        limit = np.inf
    else:
        lowered = int(torch.tensor(int(big), dtype=torch.int64).to(dtype))
        clipped = lowered != int(big)
        limit = torch.iinfo(dtype).max
    dname = str(dtype).removeprefix("torch.")
    if clipped:
        report.add(Finding(
            "R7", Severity.ERROR, "launch", shape=name,
            message=f"sentinel {big!r} is not representable in key dtype "
                    f"{dname} (lowers to {lowered}) -- padding would "
                    f"corrupt real keys"))
    elif dtype.is_floating_point and not np.isinf(lowered):
        report.add(Finding(
            "R7", Severity.WARN, "launch", shape=name,
            message=f"sentinel {big!r} is finite in {dname}: real keys "
                    f"equal to it tie with padding and can be dropped by "
                    f"the merge-split keep rule -- use inf"))
    elif not dtype.is_floating_point and lowered != limit:
        report.add(Finding(
            "R7", Severity.WARN, "launch", shape=name,
            message=f"sentinel {big!r} is below {dname} max ({limit}): "
                    f"keys in ({big!r}, {limit}] sort after padding and "
                    f"leak into the kept halves"))


def _dead_lanes(fc: LaunchFacts) -> List[str]:
    """Messages for declared lanes that no block index satisfies."""
    dead = []
    for axis, cmp, value in fc.lanes:
        size = int(fc.grid[axis])
        ids = np.array([0, size - 1, value - 1, value, value + 1])
        ids = ids[(ids >= 0) & (ids < size)]
        if not bool(np.any(COMPARISONS[cmp](ids, value))):
            dead.append(f"predicate blockIdx.{_AXES[axis]} {cmp} {value} is "
                        f"false for every block index in [0, {size})")
    return dead


def r8_dead_lanes(report: Report, facts: Sequence[LaunchFacts]) -> None:
    """Flag declared lanes that provably never execute."""
    for fc in facts:
        for msg in _dead_lanes(fc):
            report.add(Finding(
                "R8", Severity.WARN, "launch", shape=fc.name,
                message=f"dead lane: {msg} -- the guarded code never runs "
                        f"on any block (stale grid constant?)"))
