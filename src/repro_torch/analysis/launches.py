"""Launch facts: what each kernel launch of the port runs, as data.

The counterpart of `repro/analysis/vmem.py`.  The reference reads its facts
off a traced program: every `pallas_call` of a jaxpr gives a grid, the
BlockSpec of every operand with an index map that can be evaluated per
grid point (`PallasCallFacts`, `OperandFacts`), and the VMEM footprint of
its blocks and scratch (`PallasFootprint`).  A CUDA launch has no
BlockSpecs: each kernel computes its own offsets from ``blockIdx``.  So
every wrapper of `repro_torch.kernels` states its launches as a *plan*,
``plan(...) -> [LaunchFacts]``, and the C entry it calls has a dry-run
twin of its launch code (``repro_<kernel>_plan``, `_build.c_plan`) that
the card holds the plan to, launch for launch; a coverage probe on the
card holds the tile maps to the elements the kernel really writes
(`probe`).

`LaunchFacts` carries what the rules read:

* the kernel's name, its grid ``(x, y, z)`` and threads per block;
* its static and dynamic shared memory per block (rule R3, in place of
  the reference's `PallasFootprint`);
* the integer type of its index arithmetic (rule R7);
* every operand: role, the tensor it names (``buffer``, and the offset
  of this view in it), its shape as the launch sees it, dtype, tile shape
  and *tile map* (rule R5).  A tile map takes the block indices ``(bx,
  by, bz)`` of every block of the grid, numpy arrays in CUDA's linear
  block order (`grid_blocks`), and returns the tile index of each block,
  an ``(N, ndim)`` array, or, where a block touches several tiles (a
  grid-stride loop, an in-place pair exchange) or none, a pair ``(blk,
  tiles)``: ``tiles[k]`` is touched by block ``blk[k]``.  A read tile map
  may give, for a contiguous run of reads, the tiles of its first and
  last element;
* `lanes`: the ``blockIdx`` predicates the kernel branches on, as
  ``(axis, comparison, value)`` (rule R8).

`record()` collects the facts of every launch that the wrappers issue
inside it, on either device: a CPU tensor runs the plain version but
records the plan of the launches the card would make.  It is the
counterpart of `pallas_call_facts(jaxpr)` walking a traced program.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np

#: comparisons a lane may use, as numpy ufuncs
COMPARISONS = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
               "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal}


@dataclass(frozen=True)
class OperandFacts:
    """One tensor a launch reads or writes, cut into tiles."""
    role: str                        # "in" | "out"
    buffer: str                      # the tensor it names ("x", "out", ...)
    array_shape: Tuple[int, ...]     # its shape as the launch indexes it
    dtype: str                       # torch dtype name, e.g. "int32"
    tile_shape: Tuple[int, ...]
    tile_map: Callable               # (bx, by, bz) -> tiles or (blk, tiles)
    offset: int = 0                  # first element of the view in `buffer`


@dataclass(frozen=True)
class LaunchFacts:
    """One kernel launch: grid, block, shared memory, operands, lanes.

    `call` names the wrapper call that issued it, ``(plan module, args)``,
    and `step` its place in that call's launch sequence; `probe` and the
    plan check re-issue the call from them.
    """
    name: str
    grid: Tuple[int, int, int]
    threads: int
    smem_static: int
    smem_dynamic: int
    index_dtype: str
    inputs: Tuple[OperandFacts, ...]
    outputs: Tuple[OperandFacts, ...]
    lanes: Tuple[Tuple[int, str, int], ...] = ()
    call: Tuple = ()
    step: int = 0

    @property
    def smem_bytes(self) -> int:
        return self.smem_static + self.smem_dynamic

    @property
    def blocks(self) -> int:
        return int(np.prod(self.grid, dtype=np.int64))

    def launch_tuple(self) -> Tuple:
        """The form `_build.c_plan` reports a launch in."""
        return (self.name, tuple(self.grid), self.threads, self.smem_static,
                self.smem_dynamic)


def dtype_name(dtype) -> str:
    """A torch dtype as the name `OperandFacts.dtype` keeps, e.g. "int32"."""
    return str(dtype).removeprefix("torch.")


def stack_tiles(like: np.ndarray, *coords) -> np.ndarray:
    """An ``(N, ndim)`` tile array from one index per dim, each an int or
    an array shaped like `like`."""
    return np.stack([np.broadcast_to(np.asarray(c, dtype=np.int64), like.shape)
                     for c in coords], axis=1)


def grid_blocks(grid: Sequence[int]) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """``(bx, by, bz)`` of every block of `grid`, x fastest (CUDA's linear
    block order)."""
    gx, gy, gz = (int(g) for g in grid)
    lin = np.arange(gx * gy * gz, dtype=np.int64)
    return lin % gx, (lin // gx) % gy, lin // (gx * gy)


def operand_tiles(op: OperandFacts, blocks) -> Tuple[np.ndarray, np.ndarray]:
    """``(blk, tiles)``: every (block, tile) pair the operand's tile map
    gives over `blocks`, ``blk`` indexing the block arrays."""
    got = op.tile_map(*blocks)
    if isinstance(got, tuple):
        blk, tiles = got
    else:
        tiles = got
        blk = np.arange(len(tiles), dtype=np.int64)
    tiles = np.asarray(tiles, dtype=np.int64).reshape(-1, len(op.tile_shape))
    return np.asarray(blk, dtype=np.int64), tiles


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
_RECORDERS: List[List[LaunchFacts]] = []


@contextlib.contextmanager
def record() -> Iterator[List[LaunchFacts]]:
    """Collect the `LaunchFacts` of every launch issued inside the block::

        with record() as launches:
            locale.workload("sort")(x)
        r5_block_coverage(report, launches)

    Recorders nest; each sees every launch made while it is open.
    """
    rec: List[LaunchFacts] = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS[:] = [r for r in _RECORDERS if r is not rec]


def note(plan: Callable[[], List[LaunchFacts]]) -> None:
    """Called by a wrapper at each call: hands its launch plan to the open
    recorders.  `plan` is evaluated only when one is open."""
    if not _RECORDERS:
        return
    facts = plan()
    for rec in _RECORDERS:
        rec.extend(facts)


def distinct_calls(facts: Sequence[LaunchFacts]) -> List[Tuple]:
    """The distinct wrapper calls (``LaunchFacts.call``) behind `facts`, in
    first-seen order."""
    seen = {}
    for f in facts:
        seen.setdefault(f.call, None)
    return list(seen)


def plan_of(call: Tuple) -> List[LaunchFacts]:
    """Re-derive the plan of one recorded call."""
    import importlib
    module, args = call
    return importlib.import_module(module).plan(*args)
