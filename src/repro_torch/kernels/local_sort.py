"""`local_sort`: sort every row of a (rows, C) tensor — the engine's local phase.

The counterpart of `repro/kernels/local_sort.py` (a TPU kernel that keeps a
device's chunk in VMEM for its leaf sorts and its whole local merge tree,
padding a row to the next power of two with the BIG sentinel in scratch
only).  On a CUDA tensor this launches the hand-written kernel of
``csrc/local_sort.cu``; on a CPU tensor it runs the plain version,
`local_sort_reference`, the same bitonic network in PyTorch.  Both order
floats by the total-order key of `bitonic_sort.to_key` (``-0.0`` before
``+0.0``), so both are bit-identical to the reference kernel.

Rows up to TILE keys are sorted in one block's shared memory; longer rows
go through a padded ``(rows, L)`` device scratch that the wrapper
allocates (see the source note in ``csrc/local_sort.cu``).

`plan` states the launches the C entry makes for a shape, each with its
tile maps: one for L <= TILE; above it the tile sort, then for each stage
k > TILE its substages j >= TILE and one tile finish, then the copy (67
launches at (8, 12.5 M)).  `c_plan` reads the same list from the entry's
dry-run twin on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import numpy as np
import torch

from repro_torch.analysis.launches import (LaunchFacts, OperandFacts,
                                          dtype_name, note, stack_tiles)
from repro_torch.core.sort import pad_value
from repro_torch.kernels import _build, _device
from repro_torch.kernels.bitonic_sort import (KEY_DTYPES, _network, from_key,
                                               to_key)

#: keys per shared-memory tile of the kernel (64 KB); must match the source
TILE = 16384
#: threads of a shared-memory pass, and of a global substage or the copy
SORT_THREADS = 1024
STEP_THREADS = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("local_sort")
    lib.repro_local_sort.restype = ctypes.c_int
    lib.repro_local_sort.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_local_sort_plan.restype = ctypes.c_int
    lib.repro_local_sort_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(_build.Launch), ctypes.c_int]
    lib.repro_local_sort_tile.restype = ctypes.c_int
    if lib.repro_local_sort_tile() != TILE:
        raise RuntimeError(
            f"csrc/local_sort.cu was built with TILE="
            f"{lib.repro_local_sort_tile()}, the wrapper expects {TILE}")
    return lib


def _check(x: torch.Tensor, what: str):
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{what} takes (rows, C) with C >= 1, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in KEY_DTYPES:
        raise TypeError(f"{what} sorts int32 or float32, got {x.dtype}")
    return x.shape


def padded_length(C: int) -> int:
    """The power-of-two length L >= C the network runs on."""
    return 1 << max(0, (C - 1).bit_length())


def local_sort_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: pad to L with the sentinel, run the network,
    keep the first C entries."""
    rows, C = _check(x, "local_sort")
    L = padded_length(C)
    keys = to_key(x.contiguous())
    if L != C:
        pad = to_key(torch.full((1, 1), pad_value(x.dtype), dtype=x.dtype,
                                device=x.device))
        keys = torch.cat([keys, pad.expand(rows, L - C)], dim=1)
    return from_key(_network(keys)[:, :C].contiguous(), x.dtype)


def plan(rows: int, C: int, dtype: str) -> List[LaunchFacts]:
    """The launches `repro_local_sort` makes for a (rows, C) `dtype` sort.

    Tiles: a row (L <= TILE); a TILE-key segment of a row for the
    shared-memory passes; for a global substage (k, j >= TILE), the two
    256-key runs of the scratch its block's 256 pairs exchange in place
    (i and i + j, each contiguous since j >= TILE); for the copy, 256
    output elements of the flat result, reading the tiles of the first
    and last of them from the scratch.
    """
    if rows == 0:
        return []
    call = (__name__, (rows, C, dtype))
    L = padded_length(C)
    x = functools.partial(OperandFacts, "in", "x", (rows, C), dtype)
    row_tile = (1, C)
    if L <= TILE:
        half = L // 2
        threads = SORT_THREADS if half >= SORT_THREADS else max(half, 32)
        rows_map = lambda bx, by, bz: stack_tiles(bx, bx, 0)  # noqa: E731
        return [LaunchFacts(
            "sort_rows_smem", (rows, 1, 1), threads, 0, L * 4, "int32",
            inputs=(x(row_tile, rows_map),),
            outputs=(OperandFacts("out", "out", (rows, C), dtype, row_tile,
                                  rows_map),), call=call)]
    tiles = L // TILE
    seg = (1, TILE)
    scratch = functools.partial(OperandFacts, buffer="scratch",
                                array_shape=(rows, L), dtype="int32")

    def segments(bx, by, bz):
        return stack_tiles(bx, bx // tiles, bx % tiles)

    def read_segments(bx, by, bz):       # segments past C read no input
        live = np.flatnonzero((bx % tiles) * TILE < C)
        return live, segments(bx[live], by, bz)

    out: List[LaunchFacts] = []

    def add(name, grid, threads, smem, idx, inputs, outputs):
        out.append(LaunchFacts(name, (grid, 1, 1), threads, 0, smem, idx,
                               inputs=inputs, outputs=outputs, call=call,
                               step=len(out)))

    add("tile_sort", rows * tiles, SORT_THREADS, TILE * 4, "int64",
        (x(seg, read_segments),),
        (scratch(role="out", tile_shape=seg, tile_map=segments),))
    half_row = L // 2
    step_blocks = -(-rows * half_row // STEP_THREADS)
    k = 2 * TILE
    while k <= L:
        j = k // 2
        while j >= TILE:
            def pair_runs(bx, by, bz, j=j):
                p0 = bx * STEP_THREADS             # first pair of the block
                row, q0 = p0 // half_row, p0 % half_row
                i0 = 2 * j * (q0 // j) + q0 % j
                blk = np.repeat(np.arange(len(bx)), 2)
                runs = np.stack([i0, i0 + j], axis=1).reshape(-1)
                return blk, stack_tiles(blk, row[blk], runs // STEP_THREADS)
            run = (1, STEP_THREADS)
            add("global_step", step_blocks, STEP_THREADS, 0, "int64",
                (scratch(role="in", tile_shape=run, tile_map=pair_runs),),
                (scratch(role="out", tile_shape=run, tile_map=pair_runs),))
            j //= 2
        add("tile_finish", rows * tiles, SORT_THREADS, TILE * 4, "int64",
            (scratch(role="in", tile_shape=seg, tile_map=segments),),
            (scratch(role="out", tile_shape=seg, tile_map=segments),))
        k *= 2
    total = rows * C

    def copied_from(bx, by, bz):
        first = bx * STEP_THREADS
        last = np.minimum(first + STEP_THREADS, total) - 1
        blk = np.repeat(np.arange(len(bx)), 2)
        idx = np.stack([first, last], axis=1).reshape(-1)
        return blk, stack_tiles(blk, idx // C, (idx % C) // STEP_THREADS)

    add("copy_out", -(-total // STEP_THREADS), STEP_THREADS, 0, "int64",
        (scratch(role="in", tile_shape=(1, STEP_THREADS),
                 tile_map=copied_from),),
        (OperandFacts("out", "out", (total,), dtype, (STEP_THREADS,),
                      lambda bx, by, bz: bx[:, None]),))
    return out


def c_plan(rows: int, C: int, dtype: str):
    """`plan`'s launches as the C entry's dry-run twin gives them (card)."""
    return _build.c_plan(_lib(), "local_sort", rows, C, padded_length(C),
                         int(dtype == "float32"))


def _launch(x: torch.Tensor, out: torch.Tensor, scratch: torch.Tensor) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded)."""
    rows, C = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_local_sort(x.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr(), rows, C,
                                  padded_length(C),
                                  int(x.dtype == torch.float32), stream)
    _build.check(rc, lib, "repro_local_sort_error", "local_sort")


def launch_local_sort(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA tensor (uncounted)."""
    rows, C = _check(x, "local_sort")
    if not x.is_contiguous():
        raise ValueError("local_sort: the kernel takes a contiguous tensor")
    L = padded_length(C)
    out = torch.empty_like(x)
    scratch = (torch.empty((rows, L), dtype=torch.int32, device=x.device)
               if L > TILE else out)
    _launch(x, out, scratch)
    return out


def probe(rows: int, C: int, dtype: str,
          device="cuda") -> Dict[str, torch.Tensor]:
    """One call on keys from [0, 2^20) with the output and scratch filled
    with `analysis.probe.poisoned`, which no such key can write; returns
    the buffers."""
    from repro_torch.analysis.probe import poisoned
    gen = torch.Generator().manual_seed(rows * 7919 + C)
    x = torch.randint(0, 1 << 20, (rows, C), generator=gen, dtype=torch.int32)
    x = x.to(getattr(torch, dtype)).to(device)
    bufs = {"out": poisoned((rows, C), x.dtype, device)}
    L = padded_length(C)
    if L > TILE:
        bufs["scratch"] = poisoned((rows, L), torch.int32, device)
    _launch(x, bufs["out"], bufs.get("scratch", bufs["out"]))
    return bufs


def local_sort(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of x: (rows, C) -> (rows, C), any C >= 1.

    CPU tensor: `local_sort_reference`.  CUDA tensor: the kernel, counted
    in ``local_sort.launches``.
    """
    rows, C = _check(x, "local_sort")
    note(lambda: plan(rows, C, dtype_name(x.dtype)))
    if _device(x, "local_sort") == "cpu":
        return local_sort_reference(x)
    out = launch_local_sort(x)
    local_sort.launches += 1
    return out


local_sort.launches = 0
