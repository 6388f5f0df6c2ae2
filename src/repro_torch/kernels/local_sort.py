"""`local_sort`: sort every row of a (rows, C) tensor — the engine's local phase.

The counterpart of `repro/kernels/local_sort.py` (a TPU kernel that keeps a
device's chunk in VMEM for its leaf sorts and its whole local merge tree,
padding a row to the next power of two with the BIG sentinel in scratch
only).  On a CUDA tensor this launches the hand-written kernel of
``csrc/local_sort.cu``; on a CPU tensor it runs the plain version,
`local_sort_reference`, the bitonic network in PyTorch.  Both order floats
by the total-order key of `bitonic_sort.to_key` (``-0.0`` before ``+0.0``),
so both are bit-identical to the reference kernel.

The kernel sorts TILE-key tiles with their keys in registers and warp
shuffles (one block per row when C <= TILE), then merges the sorted runs
of each row pairwise, one merge pass per doubling, ping-ponging between
the output and a ``(rows, C)`` int32 scratch (see the source note in
``csrc/local_sort.cu``).  `local_sort_schedule` emulates that schedule in
PyTorch, tile pass and merge passes with their merge-path co-ranks, for
the tests (the counterpart of Pallas ``interpret=True``); nothing on the
main path calls it.

`plan` states the launches the C entry makes for a shape, each with its
tile maps: one for C <= TILE; above it the tile sort, then for each merge
pass a partition and a merge (21 launches at (8, 12.5 M)).  `c_plan` reads
the same list from the entry's dry-run twin on the card.
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
from repro_torch.kernels.bitonic_sort import (DTYPE_CODES, _network,
                                               check_key_dtype, from_key,
                                               to_key)

#: keys per tile of the tile pass (1024 threads x 16 keys in registers,
#: 64 KB of shared memory); must match the source
TILE = 16384
#: keys a block-sort thread holds; the smallest block sort (one warp)
KPT = 16
MIN_N = 512
#: threads of a merge block and the outputs it writes; threads of a
#: partition block (one co-rank each)
MT_THREADS = 256
MT = MT_THREADS * 32
PART_THREADS = 256
#: co-ranks are stored as int32
MAX_C = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("local_sort")
    lib.repro_local_sort.restype = ctypes.c_int
    lib.repro_local_sort.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_local_sort_plan.restype = ctypes.c_int
    lib.repro_local_sort_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
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
    check_key_dtype(x.dtype, what)
    return x.shape


def _check_width(C: int) -> None:
    """The kernel's limit: merge-path co-ranks are stored as int32."""
    if C > MAX_C:
        raise ValueError(f"local_sort: the kernel sorts rows of at most "
                         f"{MAX_C} keys, got {C}")


def padded_length(C: int) -> int:
    """The power-of-two length L >= C the plain network runs on."""
    return 1 << max(0, (C - 1).bit_length())


def merge_passes(C: int, tile: int = TILE) -> int:
    """Merge passes after the tile pass: ceil(log2(ceil(C / tile)))."""
    return (-(-C // tile) - 1).bit_length()


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


def _pairs(o0, C: int, w: int):
    """(ps, la, lb) of the pair of width-w runs holding output o0: the pair
    starts at ps, its left run has la keys, its right run lb (0: none)."""
    ps = o0 // (2 * w) * (2 * w)
    return ps, (C - ps).clip(max=w), (C - ps - w).clip(0, w)


def _co_rank(keys, a0, na, b0, nb, d):
    """Of the first d outputs of the stable merge of keys[a0 : a0 + na]
    and keys[b0 : b0 + nb] (flat int32 keys, ties to a), how many come
    from a: the kernel's binary search, elementwise over int64 tensors."""
    lo = (d - nb).clamp(min=0)
    hi = torch.minimum(d, na)
    last = keys.numel() - 1
    while True:
        live = lo < hi
        if not bool(live.any()):
            return lo
        mid = (lo + hi) // 2
        take = (keys[(a0 + mid).clamp(0, last)]
                <= keys[(b0 + d - 1 - mid).clamp(0, last)])
        lo = torch.where(live & take, mid + 1, lo)
        hi = torch.where(live & ~take, mid, hi)


def local_sort_schedule(x: torch.Tensor, tile: int = TILE,
                        block: int = MT) -> torch.Tensor:
    """The kernel's schedule in PyTorch, for the tests: sort each
    tile-key segment of a row (padded with the sentinel key), then merge
    neighbouring runs pass by pass, each merge block of min(block, tile)
    outputs taking its first co-rank from a partition search and its last
    from the next block's (or the pair's end), and each output its own
    co-rank inside the block's two windows.  Equals `local_sort_reference`
    bit for bit."""
    rows, C = _check(x, "local_sort")
    for name, v in (("tile", tile), ("block", block)):
        if v & (v - 1) or v < 1:
            raise ValueError(f"{name} must be a power of two, got {v}")
    dev = x.device
    keys = to_key(x.contiguous())
    tiles = -(-C // tile)
    pad = to_key(torch.full((1, 1), pad_value(x.dtype), dtype=x.dtype,
                            device=dev))
    segs = torch.cat([keys, pad.expand(rows, tiles * tile - C)], dim=1)
    keys = _network(segs.view(rows * tiles, tile)).view(rows, -1)[:, :C]
    mt = min(block, tile)
    bpr = -(-C // mt)
    q = torch.arange(bpr, device=dev)
    o0 = q * mt
    row_base = (torch.arange(rows, device=dev) * C)[:, None]
    o = torch.arange(C, device=dev)              # every output of a row
    x_in_block = o - o // mt * mt
    w = tile
    while w < C:
        flat = keys.reshape(-1)
        ps, la, lb = _pairs(o0, C, w)
        # the partition launch: each block's first co-rank in its pair
        diag = _co_rank(flat, row_base + ps, la, row_base + ps + w, lb,
                        (o0 - ps).expand(rows, bpr))
        n_out = torch.clamp(C - o0, max=mt)
        d1 = o0 - ps + n_out
        nxt = torch.cat([diag[:, 1:], diag[:, -1:]], dim=1)
        a1 = torch.where(d1 < la + lb, nxt, la.expand(rows, bpr))
        # the merge launch: every output from the block's two windows
        blk = o // mt
        a0 = diag[:, blk]
        na = a1[:, blk] - a0
        nb = n_out[blk] - na
        wa = row_base + ps[blk] + a0               # window starts, flat
        wb = row_base + ps[blk] + w + (o0 - ps)[blk] - a0
        xi = x_in_block.expand(rows, C)
        c0 = _co_rank(flat, wa, na, wb, nb, xi)
        c1 = _co_rank(flat, wa, na, wb, nb, xi + 1)
        from_a = c1 > c0
        keys = torch.where(from_a, flat[(wa + c0).clamp(max=flat.numel() - 1)],
                           flat[(wb + xi - c0).clamp(max=flat.numel() - 1)])
        w *= 2
    return from_key(keys.contiguous(), x.dtype)


def block_keys(C: int) -> int:
    """Keys of the one-block sort of a row of C <= TILE keys."""
    return max(MIN_N, padded_length(C))


def plan(rows: int, C: int, dtype: str) -> List[LaunchFacts]:
    """The launches `repro_local_sort` makes for a (rows, C) `dtype` sort.

    C <= TILE: one block per row (``sort_rows_smem``), its N = max(512,
    next power of two) keys in dynamic shared memory, N / 16 threads.
    Above: ``tile_sort`` (block bx sorts TILE-key segment bx % tiles of
    row bx // tiles), then per merge pass of run width w a
    ``merge_partition`` (thread g writes co-rank g of the flat (rows *
    blocks per row) ``diag``; a block reads the pairs of runs from its
    first diagonal's to its last's, stated as those two) and a
    ``merge_pass`` (block g writes MT outputs of its row; it reads the two
    width-w runs of its pair, the second only where there is one, and
    ``diag[g]``, ``diag[g + 1]`` where the block ends inside its pair).
    Passes alternate between ``out`` and ``scratch``, the last one
    writing ``out``; for a dtype narrower than 4 bytes a second int32
    ``scratch2`` takes ``out``'s place before the last pass.  Array
    offsets are 64-bit.  Raises ValueError past
    `MAX_C`, as the kernel would refuse it.
    """
    _check_width(C)
    if rows == 0:
        return []
    call = (__name__, (rows, C, dtype))
    x = functools.partial(OperandFacts, "in", "x", (rows, C), dtype)
    if C <= TILE:
        n = block_keys(C)
        rows_map = lambda bx, by, bz: stack_tiles(bx, bx, 0)  # noqa: E731
        return [LaunchFacts(
            "sort_rows_smem", (rows, 1, 1), n // KPT, 0, n * 4, "int64",
            inputs=(x((1, C), rows_map),),
            outputs=(OperandFacts("out", "out", (rows, C), dtype, (1, C),
                                  rows_map),), call=call)]
    tiles = -(-C // TILE)
    passes = merge_passes(C)
    bpr = -(-C // MT)
    total = rows * bpr
    narrow = torch.empty((), dtype=getattr(torch, dtype)).element_size() < 4

    def keys(role, p, tile_shape, tile_map):
        """Pass p's buffer (0 = the tile pass's destination)."""
        if (passes - p) % 2:
            return OperandFacts(role, "scratch", (rows, C), "int32",
                                tile_shape, tile_map)
        if narrow and p < passes:
            return OperandFacts(role, "scratch2", (rows, C), "int32",
                                tile_shape, tile_map)
        return OperandFacts(role, "out", (rows, C), dtype, tile_shape,
                            tile_map)

    def segments(bx, by, bz):
        return stack_tiles(bx, bx // tiles, bx % tiles)

    diag = functools.partial(OperandFacts, buffer="diag", array_shape=(total,),
                             dtype="int32")
    out: List[LaunchFacts] = []

    def add(name, grid, threads, smem_static, smem_dynamic, inputs, outputs):
        out.append(LaunchFacts(name, (grid, 1, 1), threads, smem_static,
                               smem_dynamic, "int64", inputs=inputs,
                               outputs=outputs, call=call, step=len(out)))

    add("tile_sort", rows * tiles, TILE // KPT, 0, TILE * 4,
        (x((1, TILE), segments),), (keys("out", 0, (1, TILE), segments),))
    w = TILE
    for p in range(1, passes + 1):
        def runs(g, w=w):
            """Row, left run and last run read for the pair of block g."""
            row, o0 = g // bpr, g % bpr * MT
            ps, _, lb = _pairs(o0, C, w)
            return row, ps // w, ps // w + (lb > 0)

        def part_reads(bx, by, bz, runs=runs):
            first = bx * PART_THREADS
            r0, left, _ = runs(first)
            r1, _, right = runs(np.minimum(first + PART_THREADS, total) - 1)
            blk = np.repeat(np.arange(len(bx)), 2)
            return blk, np.stack([np.stack([r0, left], 1),
                                  np.stack([r1, right], 1)], 1).reshape(-1, 2)

        def merge_reads(bx, by, bz, runs=runs):
            row, left, right = runs(bx)
            two = right > left
            blk = np.concatenate([np.arange(len(bx)), np.flatnonzero(two)])
            return blk, np.stack([row[blk], np.concatenate([left,
                                                            right[two]])], 1)

        def diag_reads(bx, by, bz, w=w):
            o0 = bx % bpr * MT
            ps, la, lb = _pairs(o0, C, w)
            inner = o0 - ps + np.minimum(C - o0, MT) < la + lb
            blk = np.concatenate([np.arange(len(bx)), np.flatnonzero(inner)])
            return blk, np.concatenate([bx, bx[inner] + 1])[:, None]

        def blocks(bx, by, bz):
            return stack_tiles(bx, bx // bpr, bx % bpr)

        add("merge_partition", -(-total // PART_THREADS), PART_THREADS, 0, 0,
            (keys("in", p - 1, (1, w), part_reads),),
            (diag(role="out", tile_shape=(PART_THREADS,),
                  tile_map=lambda bx, by, bz: bx[:, None]),))
        add("merge_pass", total, MT_THREADS, (MT + MT // 32) * 4, 0,
            (keys("in", p - 1, (1, w), merge_reads),
             diag(role="in", tile_shape=(1,), tile_map=diag_reads)),
            (keys("out", p, (1, MT), blocks),))
        w *= 2
    return out


def c_plan(rows: int, C: int, dtype: str):
    """`plan`'s launches as the C entry's dry-run twin gives them (card)."""
    return _build.c_plan(_lib(), "local_sort", rows, C,
                         DTYPE_CODES[getattr(torch, dtype)])


def scratch_shapes(rows: int, C: int,
                   dtype: str = "int32") -> Dict[str, tuple]:
    """The int32 buffers the kernel needs beside its output: none for
    C <= TILE, else the (rows, C) ping-pong scratch, a second one where
    `dtype` is narrower than a 4-byte key (the output cannot hold keys),
    and the co-ranks."""
    if C <= TILE:
        return {}
    out = {"scratch": (rows, C), "diag": (rows * -(-C // MT),)}
    if torch.empty((), dtype=getattr(torch, dtype)).element_size() < 4:
        out["scratch2"] = (rows, C)
    return out


def _launch(x: torch.Tensor, out: torch.Tensor,
            bufs: Dict[str, torch.Tensor]) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded)."""
    rows, C = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptr = {name: t.data_ptr() for name, t in bufs.items()}
        rc = lib.repro_local_sort(
            x.data_ptr(), out.data_ptr(), ptr.get("scratch"),
            ptr.get("scratch2"), ptr.get("diag"), rows, C,
            DTYPE_CODES[x.dtype], stream)
    _build.check(rc, lib, "repro_local_sort_error", "local_sort")


def launch_local_sort(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA tensor (uncounted)."""
    rows, C = _check(x, "local_sort")
    if not x.is_contiguous():
        raise ValueError("local_sort: the kernel takes a contiguous tensor")
    _check_width(C)
    out = torch.empty_like(x)
    _launch(x, out, {name: torch.empty(shape, dtype=torch.int32,
                                       device=x.device)
                     for name, shape in scratch_shapes(
                         rows, C, dtype_name(x.dtype)).items()})
    return out


def probe(rows: int, C: int, dtype: str,
          device="cuda") -> Dict[str, torch.Tensor]:
    """One call on keys from [0, `PROBE_KEY_TOP`) with the output, the
    scratch and the co-ranks filled with `analysis.probe.poisoned`, which
    no such key and no co-rank can write; returns the buffers."""
    from repro_torch.analysis.probe import PROBE_KEY_TOP, poisoned
    gen = torch.Generator(device=device).manual_seed(rows * 7919 + C)
    dt = getattr(torch, dtype)
    top = PROBE_KEY_TOP[torch.empty((), dtype=dt).element_size()]
    x = torch.randint(0, top, (rows, C), generator=gen, dtype=torch.int32,
                      device=device).to(dt)
    bufs = {name: poisoned(shape, torch.int32, device)
            for name, shape in scratch_shapes(rows, C, dtype).items()}
    out = poisoned((rows, C), x.dtype, device)
    _launch(x, out, bufs)
    return {"out": out, **bufs}


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
