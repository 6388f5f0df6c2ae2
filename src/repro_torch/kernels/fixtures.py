"""The four mutant kernels of the analysis rules: broken (rows, cols) copies.

The counterparts of the Pallas fixtures of `repro/analysis/fixtures.py`,
each the reference's float32 row copy with its fault made real on the
card (``csrc/fixtures.cu``):

  `overlapping_index_map`  block i writes output row i // 2: blocks 2k and
                           2k + 1 race on row k (R5 ERROR, write race).
  `gapped_index_map`       a grid of rows // 2 blocks: the rows past it are
                           never written (R5 WARN, coverage gap).
  `oob_index_map`          block i reads input row i + rows // 2, past the
                           input's end for the last rows // 2 blocks (R5
                           ERROR, out-of-bounds read).
  `dead_lane_kernel`       the copy plus a lane taken when blockIdx.x ==
                           rows + 3, which no block has (R8 WARN, dead lane).

Each wrapper's launch takes its row map, grid and lane constant from
`spec`, the same values `plan` builds the tile maps and lanes from, so the
rules replay what the kernel runs.  The output starts as NaN, so rows no
block writes read NaN on both devices, as in interpret mode.

One stated difference from the reference: a Pallas block index is clamped
into the array, so the reference's `oob_index_map` rereads x[3]; a CUDA
kernel reads where it points.  The wrapper puts the input at the head of
a buffer with a guard band of rows // 2 NaN rows behind it, so the read
past the input lands in the guard, inside the allocation, and those
output rows read NaN.

The plain version, `mutant_reference`, runs the grid in order as interpret
mode does, so the last writer of a raced row wins (x[2k + 1]); on the card
the blocks run concurrently and either writer may win, element by element.
`run_mutant` also returns how many blocks entered the dead lane (a device
counter the kernel increments atomically; it is an instrument, not an
operand of the plan): it must read 0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.analysis.launches import (LaunchFacts, OperandFacts, note,
                                          stack_tiles)
from repro_torch.kernels import _build, _device

KINDS = ("overlapping", "gapped", "oob", "dead_lane")

#: threads of a block: one per column, striding past 128
FX_THREADS = 128


def spec(kind: str, rows: int) -> Tuple[int, int]:
    """``(grid, arg)`` of a mutant's launch: the blocks, and the constant
    its kernel takes (overlapping: the output row divisor 2; oob: the read
    shift rows // 2; dead lane: the lane rows + 3; gapped: none)."""
    return {"overlapping": (rows, 2), "gapped": (rows // 2, 0),
            "oob": (rows, rows // 2), "dead_lane": (rows, rows + 3)}[kind]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fixtures")
    lib.repro_fixtures.restype = ctypes.c_int
    lib.repro_fixtures.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.repro_fixtures_plan.restype = ctypes.c_int
    lib.repro_fixtures_plan.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(_build.Launch), ctypes.c_int])
    return lib


def plan(kind: str, rows: int, cols: int) -> List[LaunchFacts]:
    """The one launch of a mutant on a (rows, cols) float32 input: block i
    reads input row i (oob: i + rows // 2) and writes output row i
    (overlapping: i // 2); the dead lane is ``blockIdx.x == rows + 3``."""
    grid, arg = spec(kind, rows)
    if grid == 0 or cols == 0:
        return []
    shift = arg if kind == "oob" else 0
    div = arg if kind == "overlapping" else 1
    lanes = ((0, "eq", arg),) if kind == "dead_lane" else ()
    row = functools.partial(OperandFacts, array_shape=(rows, cols),
                            dtype="float32", tile_shape=(1, cols))
    return [LaunchFacts(
        kind, (grid, 1, 1), FX_THREADS, 0, 0, "int64",
        inputs=(row("in", "x", tile_map=lambda bx, by, bz:
                    stack_tiles(bx, bx + shift, 0)),),
        outputs=(row("out", "out", tile_map=lambda bx, by, bz:
                      stack_tiles(bx, bx // div, 0)),),
        lanes=lanes, call=(__name__, (kind, rows, cols)))]


def c_plan(kind: str, rows: int, cols: int):
    """`plan`'s launch as the C entry's dry-run twin gives it (card)."""
    grid, arg = spec(kind, rows)
    return _build.c_plan(_lib(), "fixtures", KINDS.index(kind), grid, cols,
                         arg)


def _check(kind: str, x: torch.Tensor):
    if kind not in KINDS:
        raise ValueError(f"unknown mutant {kind!r}; known: {KINDS}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"the mutants copy a (rows, cols) float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    return x.shape


def _source(kind: str, x: torch.Tensor) -> torch.Tensor:
    """What the kernel reads: x, or for oob x with its NaN guard band."""
    if kind != "oob":
        return x
    guard = torch.full((spec(kind, x.shape[0])[1], x.shape[1]), float("nan"),
                       dtype=x.dtype, device=x.device)
    return torch.cat([x, guard])


def mutant_reference(kind: str, x: torch.Tensor):
    """The plain version: the grid in order, as interpret mode runs it.
    Returns ``(y, entered)``, entered the dead lane's block count."""
    rows, cols = _check(kind, x)
    grid, arg = spec(kind, rows)
    src = _source(kind, x)
    y = torch.full((rows, cols), float("nan"), dtype=x.dtype, device=x.device)
    entered = torch.zeros(1, dtype=torch.int32, device=x.device)
    for i in range(grid):
        out_row = i // arg if kind == "overlapping" else i
        y[out_row] = src[i + arg if kind == "oob" else i]
        if kind == "dead_lane" and i == arg:
            entered += 1
            y[out_row] *= 2.0
    return y, entered


def _launch(kind: str, src: torch.Tensor, out: torch.Tensor,
            entered: torch.Tensor) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded)."""
    grid, arg = spec(kind, out.shape[0])
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.repro_fixtures(KINDS.index(kind), src.data_ptr(),
                                out.data_ptr(), entered.data_ptr(), grid,
                                out.shape[1], arg, stream)
    _build.check(rc, lib, "repro_fixtures_error", f"fixtures {kind}")


def run_mutant(kind: str, x: torch.Tensor):
    """Run one mutant: ``(y, entered)``.  CPU tensor: `mutant_reference`.
    CUDA tensor: the kernel, counted on the mutant's wrapper."""
    rows, cols = _check(kind, x)
    note(lambda: plan(kind, rows, cols))
    if _device(x, kind) == "cpu":
        return mutant_reference(kind, x)
    if not x.is_contiguous():
        raise ValueError(f"{kind}: the kernel takes a contiguous tensor")
    y = torch.full((rows, cols), float("nan"), dtype=x.dtype, device=x.device)
    entered = torch.zeros(1, dtype=torch.int32, device=x.device)
    _launch(kind, _source(kind, x), y, entered)
    MUTANTS[kind].launches += 1
    return y, entered


def probe(kind: str, rows: int, cols: int,
          device="cuda") -> Dict[str, torch.Tensor]:
    """One launch on normal rows into an output filled with
    `analysis.probe.poisoned` (the oob guard stays the canonical NaN, whose
    bits differ from the poison's); returns the output."""
    from repro_torch.analysis.probe import poisoned
    gen = torch.Generator().manual_seed(rows * 131 + cols)
    x = torch.randn(rows, cols, generator=gen).to(device)
    out = poisoned((rows, cols), torch.float32, device)
    entered = torch.zeros(1, dtype=torch.int32, device=device)
    _launch(kind, _source(kind, x), out, entered)
    return {"out": out}


def overlapping_index_map(x: torch.Tensor) -> torch.Tensor:
    """Copy whose block i writes output row i // 2 (a write race)."""
    return run_mutant("overlapping", x)[0]


def gapped_index_map(x: torch.Tensor) -> torch.Tensor:
    """Copy whose grid covers only the first half of the output rows."""
    return run_mutant("gapped", x)[0]


def oob_index_map(x: torch.Tensor) -> torch.Tensor:
    """Copy whose block i reads input row i + rows // 2 (past the end)."""
    return run_mutant("oob", x)[0]


def dead_lane_kernel(x: torch.Tensor) -> torch.Tensor:
    """Copy with a lane ``blockIdx.x == rows + 3`` that no block takes."""
    return run_mutant("dead_lane", x)[0]


#: each mutant's wrapper, by kind; their ``launches`` count the kernels
MUTANTS = {"overlapping": overlapping_index_map, "gapped": gapped_index_map,
           "oob": oob_index_map, "dead_lane": dead_lane_kernel}
for _fn in MUTANTS.values():
    _fn.launches = 0
