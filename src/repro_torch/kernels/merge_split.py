"""`merge_split`: the kept half of the stable merge of two sorted runs.

The counterpart of `repro/kernels/merge_split.py`.  Row r merges the sorted
runs ``a[r]`` and ``b[r]`` (ties to a) and keeps output ranks ``[0, C)``
(keep-low) or ``[C, 2C)`` (keep-high), never materialising the 2C merge.
On a CUDA tensor this launches the merge-path kernel of
``csrc/merge_split.cu``; on a CPU tensor it runs the plain version,
`merge_split_reference`, the reference kernel's gather-form rank merge
evaluated at the kept ranks only.  Comparisons are IEEE, so both are
bit-exact against ``merge_sorted(a, b)[:C]`` / ``[C:]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _device
from repro_torch.kernels.bitonic_sort import KEY_DTYPES

#: the kernel's grid puts rows on gridDim.y
MAX_ROWS = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("merge_split")
    lib.repro_merge_split.restype = ctypes.c_int
    lib.repro_merge_split.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
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


def merge_split(a: torch.Tensor, b: torch.Tensor, keep_low) -> torch.Tensor:
    """Row-wise merge-split.  a, b: (rows, C) sorted rows; keep_low: a
    scalar or ``(rows,)`` flags — True keeps the low half.  Returns
    (rows, C).

    CPU tensors: `merge_split_reference`.  CUDA tensors: the kernel,
    counted in ``merge_split.launches``; ``merge_split.merged_elems`` adds
    the rows * C merge outputs each launch writes.
    """
    rows, C = _check(a, b)
    if _device(a, "merge_split") == "cpu":
        return merge_split_reference(a, b, keep_low)
    keep = keep_vector(keep_low, rows, C, a.device).to(torch.int32)
    keep = keep.contiguous()
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("merge_split: the kernel takes contiguous tensors")
    if rows > MAX_ROWS:
        raise ValueError(f"merge_split: the kernel takes at most {MAX_ROWS} "
                         f"rows, got {rows}")
    out = torch.empty_like(a)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.repro_merge_split(a.data_ptr(), b.data_ptr(), keep.data_ptr(),
                                   out.data_ptr(), rows, C,
                                   int(a.dtype == torch.float32), stream)
    _build.check(rc, lib, "repro_merge_split_error", "merge_split")
    merge_split.launches += 1
    merge_split.merged_elems += rows * C
    return out


merge_split.launches = 0
merge_split.merged_elems = 0
