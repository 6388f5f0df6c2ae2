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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sort import pad_value
from repro_torch.kernels import _build, _device
from repro_torch.kernels.bitonic_sort import (KEY_DTYPES, _network, from_key,
                                               to_key)

#: keys per shared-memory tile of the kernel (64 KB); must match the source
TILE = 16384


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("local_sort")
    lib.repro_local_sort.restype = ctypes.c_int
    lib.repro_local_sort.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
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


def launch_local_sort(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA tensor (uncounted)."""
    rows, C = _check(x, "local_sort")
    if not x.is_contiguous():
        raise ValueError("local_sort: the kernel takes a contiguous tensor")
    L = padded_length(C)
    out = torch.empty_like(x)
    scratch = (torch.empty((rows, L), dtype=torch.int32, device=x.device)
               if L > TILE else out)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_local_sort(x.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr(), rows, C, L,
                                  int(x.dtype == torch.float32), stream)
    _build.check(rc, lib, "repro_local_sort_error", "local_sort")
    return out


def local_sort(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of x: (rows, C) -> (rows, C), any C >= 1.

    CPU tensor: `local_sort_reference`.  CUDA tensor: the kernel, counted
    in ``local_sort.launches``.
    """
    _check(x, "local_sort")
    if _device(x, "local_sort") == "cpu":
        return local_sort_reference(x)
    out = launch_local_sort(x)
    local_sort.launches += 1
    return out


local_sort.launches = 0
