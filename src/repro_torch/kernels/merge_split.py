"""`merge_split` and `merge_runs`: the stable merge of two sorted runs.

The counterpart of `repro/kernels/merge_split.py`, and of the full merge
`repro/core/sort.py::merge_sorted`, which the reference runs as plain jnp
in its constraint tree.  Row r merges the sorted runs ``a[r]`` and ``b[r]``
(ties to a, IEEE comparisons, so ``-0.0 == +0.0``):

* `merge_split` keeps output ranks ``[0, C)`` (keep-low) or ``[C, 2C)``
  (keep-high) of two C-element runs, never materialising the 2C merge;
* `merge_runs` writes the whole ``(rows, na + nb)`` merge.

On a CUDA tensor both launch the kernel of ``csrc/merge_split.cu``; on a
CPU tensor they run the plain versions, `merge_split_reference` (the
reference kernel's gather-form rank merge at the kept ranks only) and
`merge_sorted_reference` (the reference's `merge_sorted`).  Both are
bit-exact against each other and against the kernel.  Rows of a and b may
be strided views (the last dim contiguous): the constraint tree passes
``runs[..., 0::2, :]`` and ``runs[..., 1::2, :]`` as they are.

The kernel's schedule (``csrc/merge_path.cuh``): a partition launch
writes the merge-path co-rank of every block boundary, then a flat grid of
TILE-output merge blocks over every row: each block's two co-ranks cut the
two windows it consumes, each of its threads finds its own co-rank inside
them and merges ITEMS outputs.
`merge_schedule` emulates that schedule in PyTorch for the tests (the
counterpart of Pallas ``interpret=True``); nothing on the main path calls
it.

`plan` states the launches for a shape, `c_plan` reads them from the C
entry's dry-run twin on the card, and `probe` runs a poisoned call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.launches import (LaunchFacts, OperandFacts,
                                          dtype_name, note, stack_tiles)
from repro_torch.core.sort import merge_sorted_reference
from repro_torch.kernels import _build, _device
from repro_torch.kernels.bitonic_sort import (DTYPE_CODES, check_key_dtype,
                                               widen)

#: threads of a merge block, the outputs each merges, the outputs of a
#: block; threads of a partition block (one co-rank each); must match
#: ``csrc/merge_path.cuh``
THREADS = 256
ITEMS = 32
TILE = THREADS * ITEMS
PART_THREADS = 256
#: padded shared-memory slots of a merge block (one pad word every 32)
SLOTS = TILE + TILE // 32
#: co-ranks inside a row are int32: a row merges at most this many elements
MAX_ROW = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("merge_split")
    lib.repro_merge_split.restype = ctypes.c_int
    lib.repro_merge_split.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_merge_split_plan.restype = ctypes.c_int
    lib.repro_merge_split_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_build.Launch), ctypes.c_int]
    return lib


def keep_vector(keep_low, rows: int, C: int, device) -> torch.Tensor:
    """The per-row keep flags as a bool (rows,) tensor on `device`.

    A scalar or a length-1 vector broadcasts; any other shape than a scalar
    or ``(rows,)`` raises ValueError, as the reference does.
    """
    keep = torch.as_tensor(keep_low)
    shape = tuple(keep.shape)
    if keep.dim() == 0:
        keep = keep[None]
    if keep.dim() != 1 or keep.shape[0] not in (1, rows):
        raise ValueError(
            f"keep_low must be a scalar or a length-{rows} vector of "
            f"per-row flags (one per merge-split row); got shape "
            f"{shape} for a/b of shape {(rows, C)}")
    return keep.to(device=device, dtype=torch.bool).expand(rows)


def _check_pair(a: torch.Tensor, b: torch.Tensor, what: str):
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] != a.shape[0]:
        raise ValueError(f"{what} takes a (rows, na) and b (rows, nb), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    check_key_dtype(a.dtype, what)
    if b.dtype != a.dtype:
        raise TypeError(f"{what} merges runs of one dtype, got {a.dtype} "
                        f"and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"{what}: a on {a.device}, b on {b.device}")


def _check(a: torch.Tensor, b: torch.Tensor):
    _check_pair(a, b, "merge_split")
    if b.shape != a.shape:
        raise ValueError(f"merge_split takes a, b of one (rows, C) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    return a.shape


def check_width(n: int) -> None:
    """The kernel's limit: co-ranks inside a row are int32."""
    if n > MAX_ROW:
        raise ValueError(f"merge_split: the kernel merges rows of at most "
                         f"2^31 - 1 elements (its co-ranks are int32), got "
                         f"{n}")


def merge_split_reference(a: torch.Tensor, b: torch.Tensor,
                          keep_low) -> torch.Tensor:
    """The plain version: the stable rank merge at the kept ranks only."""
    rows, C = _check(a, b)
    keep = keep_vector(keep_low, rows, C, a.device)
    if rows == 0 or C == 0:
        return a.clone()
    dtype = a.dtype
    a, b = widen(a.contiguous()), widen(b.contiguous())
    ar = torch.arange(C, device=a.device)
    k = ar + torch.where(keep, 0, C)[:, None]
    ia = ar + torch.searchsorted(b, a, side="left")
    ra = torch.searchsorted(ia, k, side="left")
    ra_c = ra.clamp(max=C - 1)
    is_a = (ra < C) & (torch.gather(ia, 1, ra_c) == k)
    rb = (k - ra).clamp(0, C - 1)
    return torch.where(is_a, torch.gather(a, 1, ra_c),
                       torch.gather(b, 1, rb)).to(dtype)


def diag_size(rows: int, n_row: int) -> int:
    """Co-ranks the partition launch writes: every block boundary of
    every row, ``rows * (ceil(n_row / TILE) + 1)``."""
    return rows * (-(-n_row // TILE) + 1)


def plan(rows: int, na: int, dtype: str,
         nb: Optional[int] = None) -> List[LaunchFacts]:
    """The launches `repro_merge_split` makes: ``nb=None`` for
    `merge_split` on (rows, na) runs (keep modes), else for `merge_runs`
    of (rows, na) and (rows, nb) runs (full mode).

    First ``merge_split_partition``: thread g writes co-rank g of the flat
    ``diag`` (`diag_size`), reading the rows of a, b (and keep) of its
    block's first and last thread.  Then ``merge_split_kernel`` over a
    flat grid of ``rows * ceil(n_row / TILE)`` blocks: block g writes
    outputs [q TILE, q TILE + TILE) of row g // bpr (q = g % bpr); it
    reads that row of a and b (the windows are data-dependent, stated as
    the whole rows), keep[row] in the keep modes, and ``diag`` entries
    row (bpr + 1) + q and + 1.  Static shared memory: the padded window.
    Array offsets are 64-bit.  Raises ValueError past `MAX_ROW`, as the
    kernel would refuse it.
    """
    split = nb is None
    nb_ = na if split else nb
    check_width(na + nb_)
    n_row = na if split else na + nb_
    if rows == 0 or n_row == 0:
        return []
    bpr = -(-n_row // TILE)
    call = (__name__, (rows, na, dtype) if split else (rows, na, dtype, nb))

    parts = diag_size(rows, n_row)

    def reads(rows_map, tile_of_row):
        def tile_map(bx, by, bz):
            blk, r = rows_map(bx)
            return blk, tile_of_row(r)
        return tile_map

    def runs(rows_map):
        """The operands a block reads: its rows of a and b (each only
        where its run is not empty) and, in the keep modes, of keep."""
        whole = reads(rows_map, lambda r: stack_tiles(r, r, 0))
        ops = [OperandFacts("in", name, (rows, n), dtype, (1, n), whole)
               for name, n in (("a", na), ("b", nb_)) if n]
        if split:
            ops.append(OperandFacts("in", "keep", (rows,), "int32", (1,),
                                    reads(rows_map, lambda r: r[:, None])))
        return ops

    def part_rows(bx):
        """The rows of a partition block's first and last thread (a
        contiguous run)."""
        first = bx * PART_THREADS
        last = np.minimum(first + PART_THREADS, parts) - 1
        blk = np.repeat(np.arange(len(bx)), 2)
        return blk, np.stack([first, last], 1).reshape(-1) // (bpr + 1)

    def diag_reads(bx, by, bz):
        at = bx // bpr * (bpr + 1) + bx % bpr
        blk = np.repeat(np.arange(len(bx)), 2)
        return blk, np.stack([at, at + 1], 1).reshape(-1, 1)

    diag = functools.partial(OperandFacts, buffer="diag",
                             array_shape=(parts,), dtype="int32")
    return [
        LaunchFacts(
            "merge_split_partition", (-(-parts // PART_THREADS), 1, 1),
            PART_THREADS, 0, 0, "int64", inputs=tuple(runs(part_rows)),
            outputs=(diag(role="out", tile_shape=(PART_THREADS,),
                          tile_map=lambda bx, by, bz: bx[:, None]),),
            call=call, step=0),
        LaunchFacts(
            "merge_split_kernel", (rows * bpr, 1, 1), THREADS, SLOTS * 4, 0,
            "int64", inputs=tuple(runs(lambda bx: (np.arange(len(bx)),
                                                   bx // bpr)))
            + (diag(role="in", tile_shape=(1,), tile_map=diag_reads),),
            outputs=(OperandFacts("out", "out", (rows, n_row), dtype,
                                  (1, TILE), lambda bx, by, bz: stack_tiles(
                                      bx, bx // bpr, bx % bpr)),),
            call=call, step=1)]


def c_plan(rows: int, na: int, dtype: str, nb: Optional[int] = None):
    """`plan`'s launches as the C entry's dry-run twin gives them (card)."""
    split = nb is None
    return _build.c_plan(_lib(), "merge_split", rows, na,
                         na if split else nb, int(split),
                         DTYPE_CODES[getattr(torch, dtype)])


def _row_stride(t: torch.Tensor) -> int:
    """Elements between rows of a (rows, n) view whose last dim is
    contiguous; raises ValueError for any other layout."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError("merge_split: the kernel takes rows whose last dim "
                         "is contiguous")
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _launch(a, b, keep, out, diag=None) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded).  `keep`:
    an int32 (rows,) tensor (keep modes) or None (full merge); `diag`:
    the co-rank buffer of the partition launch (allocated here if None)."""
    rows, na = a.shape
    nb = b.shape[1]
    if diag is None:
        diag = torch.empty(diag_size(rows, out.shape[1]), dtype=torch.int32,
                           device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.repro_merge_split(
            a.data_ptr(), _row_stride(a), b.data_ptr(), _row_stride(b),
            None if keep is None else keep.data_ptr(),
            diag.data_ptr(), out.data_ptr(), rows, na, nb,
            int(keep is not None), DTYPE_CODES[a.dtype], stream)
    _build.check(rc, lib, "repro_merge_split_error", "merge_split")


def probe(rows: int, na: int, dtype: str, nb: Optional[int] = None,
          device="cuda") -> Dict[str, torch.Tensor]:
    """One call on sorted runs of keys from [0, `PROBE_KEY_TOP`) -- for
    `merge_runs` strided views of one (rows, 2, max(na, nb) + 3) buffer,
    for `merge_split` alternate rows keeping the low half -- with the
    output and the co-ranks filled with `analysis.probe.poisoned`;
    returns them."""
    from repro_torch.analysis.probe import PROBE_KEY_TOP, poisoned
    split = nb is None
    nb_ = na if split else nb
    dt = getattr(torch, dtype)
    # drawn and sorted where the call runs: drawn and sorted on the host,
    # the probes of the 100 M-key sorts and merges took 91 s (H100 host)
    gen = torch.Generator(device=device).manual_seed(
        rows * 7919 + na + 31 * nb_)
    top = PROBE_KEY_TOP[torch.empty((), dtype=dt).element_size()]
    width = max(na, nb_) + 3
    buf = torch.randint(0, top, (rows, 2, width), generator=gen,
                        dtype=torch.int32, device=device).sort(dim=-1).values
    buf = buf.to(dt)
    a, b = buf[:, 0, :na], buf[:, 1, :nb_]
    keep = (torch.arange(rows, dtype=torch.int32) % 2).to(device) \
        if split else None
    n_row = na if split else na + nb_
    out = {"out": poisoned((rows, n_row), dt, device),
           "diag": poisoned((diag_size(rows, n_row),), torch.int32, device)}
    _launch(a, b, keep, out["out"], out["diag"])
    return out


# ---------------------------------------------------------------------------
# the kernel's schedule in PyTorch, for the tests
# ---------------------------------------------------------------------------
def _storage_view(t: torch.Tensor) -> torch.Tensor:
    """The whole storage under `t` as a flat tensor of its dtype, so that
    `t`'s elements are read at ``t.storage_offset() + row * stride + i``,
    as the kernel addresses them."""
    n = t.untyped_storage().nbytes() // t.element_size()
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), 0, (n,), (1,))


def _search(flat_a, base_a, na, flat_b, base_b, nb, d):
    """Co-rank of merge rank d of the runs flat_a[base_a : base_a + na] and
    flat_b[base_b : base_b + nb], elementwise over int64 tensors of one
    shape: the kernel's binary search (``co_rank``), step for step."""
    lo = (d - nb).clamp(min=0)
    hi = torch.minimum(d, na)

    def pred(i, j, live):
        ka = flat_a[torch.where(live, base_a + i, 0).clamp(0, len(flat_a) - 1)]
        kb = flat_b[torch.where(live, base_b + j, 0).clamp(0, len(flat_b) - 1)]
        return live & (ka <= kb)

    while True:
        live = lo < hi
        if not bool(live.any()):
            return lo
        mid = (lo + hi) // 2
        take = pred(mid, d - 1 - mid, live)
        lo = torch.where(take, mid + 1, lo)
        hi = torch.where(live & ~take, mid, hi)


def merge_schedule(a: torch.Tensor, b: torch.Tensor, keep_low=None,
                   block: int = TILE, items: int = ITEMS) -> torch.Tensor:
    """The kernel's schedule in PyTorch, for the tests: `merge_split`
    (``keep_low`` given) or `merge_runs` (None) of a and b, which may be
    strided views (read through their storage, as the kernel addresses
    them).  The block co-ranks come from a partition over every block
    boundary of every row (binary searches, as the partition launch);
    each block gathers its two windows, each of its
    ``block // items`` threads finds its co-rank inside them by a binary
    search and merges ``items`` outputs in turn.  Comparisons are on the
    widened values (int32, int64 for uint32, float32 for the float
    dtypes: the kernel's order).  Equals the
    plain versions bit for bit."""
    if keep_low is not None:
        rows, na = _check(a, b)
        nb, n_row = na, na
        keep = keep_vector(keep_low, rows, na, a.device)
        base = torch.where(keep, 0, na).to(torch.int64)  # keep-high: rank C
    else:
        _check_pair(a, b, "merge_schedule")
        rows, na = a.shape
        nb = b.shape[1]
        n_row = na + nb
        base = torch.zeros(rows, dtype=torch.int64, device=a.device)
    if block % items or block < items:
        raise ValueError(f"block {block} is not a multiple of items {items}")
    out = torch.empty((rows, n_row), dtype=a.dtype, device=a.device)
    if rows == 0 or n_row == 0:
        return out
    wide = (torch.float32 if a.dtype.is_floating_point else
            torch.int64 if a.dtype == torch.uint32 else torch.int32)
    fa, fb = _storage_view(a).to(wide), _storage_view(b).to(wide)
    dev = a.device
    I = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev)  # noqa
    row = torch.arange(rows, device=dev)
    ra = I(a.storage_offset()) + row * (a.stride(0) if rows > 1 else na)
    rb = I(b.storage_offset()) + row * (b.stride(0) if rows > 1 else nb)
    bpr = -(-n_row // block)
    # the partition: co-rank of every block boundary of every row
    q = torch.arange(bpr + 1, device=dev)
    d = base[:, None] + (q * block).clamp(max=n_row)
    diag = _search(fa, ra[:, None].expand_as(d), I(na), fb,
                   rb[:, None].expand_as(d), I(nb), d)
    # each block's windows, gathered into (G, block) with n_out real keys
    a0, a1 = diag[:, :-1].reshape(-1), diag[:, 1:].reshape(-1)
    g_row = row.repeat_interleave(bpr)
    o0 = (torch.arange(bpr, device=dev) * block).repeat(rows)
    n_out = (n_row - o0).clamp(max=block)
    d0 = base[g_row] + o0
    wa = a1 - a0
    wb = n_out - wa
    x = torch.arange(block, device=dev)
    from_a = x[None] < wa[:, None]
    addr_a = (ra[g_row] + a0)[:, None] + x
    addr_b = (rb[g_row] + d0 - a0)[:, None] + x - wa[:, None]
    real = x[None] < n_out[:, None]
    win = torch.where(
        from_a, fa[torch.where(from_a & real, addr_a, 0)],
        fb[torch.where(~from_a & real, addr_b, 0)])
    # each thread: its co-rank inside the windows, then `items` outputs
    G = rows * bpr
    flat = win.reshape(-1)
    t0 = (torch.arange(block // items, device=dev) * items)[None].expand(G, -1)
    gb = (torch.arange(G, device=dev) * block)[:, None]
    wa_t, wb_t = wa[:, None].expand_as(t0), wb[:, None].expand_as(t0)
    r0 = torch.minimum(t0, n_out[:, None])
    ia = _search(flat, gb.expand_as(t0), wa_t, flat, (gb + wa[:, None])
                 .expand_as(t0), wb_t, r0)
    ib = r0 - ia
    vals = torch.empty((G, block // items, items), dtype=wide, device=dev)
    for k in range(items):
        ka = flat[gb + ia.clamp(max=block - 1)]
        kb = flat[(gb + wa[:, None] + ib).clamp(max=flat.numel() - 1)]
        take_a = (ib >= wb_t) | ((ia < wa_t) & (ka <= kb))
        vals[:, :, k] = torch.where(take_a, ka, kb)
        ia = ia + take_a
        ib = ib + ~take_a
    staged = vals.reshape(G, block)      # output t items + k of each block
    # the staged, coalesced store of the real outputs, narrowed
    keep = real.reshape(-1)
    dest = (g_row * n_row + o0)[:, None] + x
    wout = torch.empty((rows, n_row), dtype=wide, device=dev)
    wout.view(-1)[dest.reshape(-1)[keep]] = staged.reshape(-1)[keep]
    return wout.to(a.dtype)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
def merge_split(a: torch.Tensor, b: torch.Tensor, keep_low) -> torch.Tensor:
    """Row-wise merge-split.  a, b: (rows, C) sorted rows; keep_low: a
    scalar or ``(rows,)`` flags — True keeps the low half.  Returns
    (rows, C).

    CPU tensors: `merge_split_reference`.  CUDA tensors: the kernel,
    counted in ``merge_split.launches``; ``merge_split.merged_elems`` adds
    the rows * C merge outputs each launch writes.  Rows may be strided
    (last dim contiguous).
    """
    rows, C = _check(a, b)
    note(lambda: plan(rows, C, dtype_name(a.dtype)))
    if _device(a, "merge_split") == "cpu":
        return merge_split_reference(a, b, keep_low)
    keep = keep_vector(keep_low, rows, C, a.device).to(torch.int32)
    keep = keep.contiguous()
    check_width(2 * C)
    out = torch.empty((rows, C), dtype=a.dtype, device=a.device)
    if rows == 0 or C == 0:
        return out
    _launch(a, b, keep, out)
    merge_split.launches += 1
    merge_split.merged_elems += rows * C
    return out


merge_split.launches = 0
merge_split.merged_elems = 0


def merge_runs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The whole stable merge of each row pair: a (rows, na) and b (rows,
    nb) sorted rows -> (rows, na + nb), ties to a.

    CPU tensors: `merge_sorted_reference`.  CUDA tensors: the kernel in
    its full mode, counted in ``merge_runs.launches``.  Rows may be
    strided (last dim contiguous).
    """
    _check_pair(a, b, "merge_runs")
    rows, na = a.shape
    nb = b.shape[1]
    note(lambda: plan(rows, na, dtype_name(a.dtype), nb))
    if _device(a, "merge_runs") == "cpu":
        return merge_sorted_reference(a, b)
    check_width(na + nb)
    out = torch.empty((rows, na + nb), dtype=a.dtype, device=a.device)
    if rows == 0 or na + nb == 0:
        return out
    _launch(a, b, None, out)
    merge_runs.launches += 1
    return out


merge_runs.launches = 0
