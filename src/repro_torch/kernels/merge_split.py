"""`merge_split`: the kept half of the stable merge of two sorted runs.

The counterpart of `repro/kernels/merge_split.py`.  Row r merges the sorted
runs ``a[r]`` and ``b[r]`` (ties to a) and keeps output ranks ``[0, C)``
(keep-low) or ``[C, 2C)`` (keep-high), never materialising the 2C merge.
On a CUDA tensor this launches the merge-path kernel of
``csrc/merge_split.cu``; on a CPU tensor it runs the plain version,
`merge_split_reference`, the reference kernel's gather-form rank merge
evaluated at the kept ranks only.  Comparisons are IEEE, so both are
bit-exact against ``merge_sorted(a, b)[:C]`` / ``[C:]``.

`plan` states the kernel's one launch: a (ceil(C / MS_TILE), rows) grid,
each block writing MS_TILE output ranks of its row; `c_plan` reads the
same launch from the C entry's dry-run twin on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch

from repro_torch.analysis.launches import (LaunchFacts, OperandFacts,
                                          dtype_name, note, stack_tiles)
from repro_torch.kernels import _build, _device
from repro_torch.kernels.bitonic_sort import KEY_DTYPES

#: the kernel's grid puts rows on gridDim.y
MAX_ROWS = 65535
#: threads of a block, and the output ranks each block writes
MS_THREADS = 256
MS_TILE = MS_THREADS * 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("merge_split")
    lib.repro_merge_split.restype = ctypes.c_int
    lib.repro_merge_split.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.repro_merge_split_plan.restype = ctypes.c_int
    lib.repro_merge_split_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(_build.Launch), ctypes.c_int]
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


def _check(a: torch.Tensor, b: torch.Tensor):
    if a.dim() != 2 or b.shape != a.shape:
        raise ValueError(f"merge_split takes a, b of one (rows, C) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in KEY_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"merge_split merges int32 or float32 runs of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"merge_split: a on {a.device}, b on {b.device}")
    return a.shape


def merge_split_reference(a: torch.Tensor, b: torch.Tensor,
                          keep_low) -> torch.Tensor:
    """The plain version: the stable rank merge at the kept ranks only."""
    rows, C = _check(a, b)
    keep = keep_vector(keep_low, rows, C, a.device)
    if rows == 0 or C == 0:
        return a.clone()
    a, b = a.contiguous(), b.contiguous()
    ar = torch.arange(C, device=a.device)
    k = ar + torch.where(keep, 0, C)[:, None]
    ia = ar + torch.searchsorted(b, a, side="left")
    ra = torch.searchsorted(ia, k, side="left")
    ra_c = ra.clamp(max=C - 1)
    is_a = (ra < C) & (torch.gather(ia, 1, ra_c) == k)
    rb = (k - ra).clamp(0, C - 1)
    return torch.where(is_a, torch.gather(a, 1, ra_c), torch.gather(b, 1, rb))


def check_rows(rows: int) -> None:
    """The grid's limit: rows ride on gridDim.y."""
    if rows > MAX_ROWS:
        raise ValueError(f"merge_split: the kernel takes at most {MAX_ROWS} "
                         f"rows, got {rows}")


def plan(rows: int, C: int, dtype: str) -> List[LaunchFacts]:
    """The launch `repro_merge_split` makes for (rows, C) `dtype` runs.

    Block (bx, by) writes output ranks [bx MS_TILE, (bx + 1) MS_TILE) of
    row by, and reads rows by of a and b (the merge-path searches range
    over the whole row) and keep[by].  Merge-path ranks are 64-bit.  Static
    shared memory: the MS_TILE-element window and two 64-bit diagonals.
    Raises ValueError past `MAX_ROWS`, as the kernel would refuse it.
    """
    check_rows(rows)
    if rows == 0 or C == 0:
        return []
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    whole_row = lambda bx, by, bz: stack_tiles(by, by, 0)  # noqa: E731
    run = functools.partial(OperandFacts, "in", array_shape=(rows, C),
                            dtype=dtype, tile_shape=(1, C), tile_map=whole_row)
    return [LaunchFacts(
        "merge_split_kernel", (-(-C // MS_TILE), rows, 1), MS_THREADS,
        MS_TILE * itemsize + 16, 0, "int64",
        inputs=(run(buffer="a"), run(buffer="b"),
                OperandFacts("in", "keep", (rows,), "int32", (1,),
                             lambda bx, by, bz: by[:, None])),
        outputs=(OperandFacts("out", "out", (rows, C), dtype, (1, MS_TILE),
                              lambda bx, by, bz: stack_tiles(by, by, bx)),),
        call=(__name__, (rows, C, dtype)))]


def c_plan(rows: int, C: int, dtype: str):
    """`plan`'s launch as the C entry's dry-run twin gives it (card)."""
    return _build.c_plan(_lib(), "merge_split", rows, C,
                         int(dtype == "float32"))


def _launch(a, b, keep, out) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded); `keep` is
    an int32 (rows,) tensor."""
    rows, C = a.shape
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.repro_merge_split(a.data_ptr(), b.data_ptr(), keep.data_ptr(),
                                   out.data_ptr(), rows, C,
                                   int(a.dtype == torch.float32), stream)
    _build.check(rc, lib, "repro_merge_split_error", "merge_split")


def probe(rows: int, C: int, dtype: str,
          device="cuda") -> Dict[str, torch.Tensor]:
    """One launch on sorted runs of keys from [0, 2^20), alternate rows
    keeping the low half, with the output filled with
    `analysis.probe.poisoned`; returns the output."""
    from repro_torch.analysis.probe import poisoned
    gen = torch.Generator().manual_seed(rows * 7919 + C)
    a, b = (torch.randint(0, 1 << 20, (rows, C), generator=gen,
                          dtype=torch.int32).sort(dim=-1).values
            .to(getattr(torch, dtype)).to(device) for _ in range(2))
    keep = (torch.arange(rows, dtype=torch.int32) % 2).to(device)
    out = poisoned((rows, C), a.dtype, device)
    _launch(a, b, keep, out)
    return {"out": out}


def merge_split(a: torch.Tensor, b: torch.Tensor, keep_low) -> torch.Tensor:
    """Row-wise merge-split.  a, b: (rows, C) sorted rows; keep_low: a
    scalar or ``(rows,)`` flags — True keeps the low half.  Returns
    (rows, C).

    CPU tensors: `merge_split_reference`.  CUDA tensors: the kernel,
    counted in ``merge_split.launches``; ``merge_split.merged_elems`` adds
    the rows * C merge outputs each launch writes.
    """
    rows, C = _check(a, b)
    note(lambda: plan(rows, C, dtype_name(a.dtype)))
    if _device(a, "merge_split") == "cpu":
        return merge_split_reference(a, b, keep_low)
    keep = keep_vector(keep_low, rows, C, a.device).to(torch.int32)
    keep = keep.contiguous()
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("merge_split: the kernel takes contiguous tensors")
    check_rows(rows)
    out = torch.empty_like(a)
    _launch(a, b, keep, out)
    merge_split.launches += 1
    merge_split.merged_elems += rows * C
    return out


merge_split.launches = 0
merge_split.merged_elems = 0
