"""`localised_copy`: the paper's Fig-1 kernel, R passes in fp32, one write.

The counterpart of `repro/kernels/localised_copy.py`: every element of a
(chunks, L) float32 or bfloat16 tensor goes through R passes of
``y = y * 1.0001 + 1.0`` in float32, is cast back once and written once.
On a CUDA tensor this launches the kernel of ``csrc/localised_copy.cu``
(each thread keeps its values in registers for all R passes); on a CPU
tensor it runs the plain version, `localised_copy_reference`.

Each pass is one fused multiply-add, rounded once to float32: that is what
XLA computes for the reference's pass (bit for bit, jitted on the CPU),
and what the kernel computes with ``__fmaf_rn``.  The plain version
reproduces it exactly in PyTorch (`fma_pass`), so the kernel, the plain
version and the jitted reference agree bit for bit.  (Written unfused, as
an eager ``y * 1.0001 + 1.0`` in either framework runs it, the pass
rounds twice and differs in about a third of the values.)
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, _device

#: the pass's multiplier as the f32 constant the reference and kernel use
MULT = float(np.float32(1.0001))

DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("localised_copy")
    lib.repro_localised_copy.restype = ctypes.c_int
    lib.repro_localised_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    return lib


def fma_pass(y: torch.Tensor) -> torch.Tensor:
    """One pass on float32 `y`: ``fma(y, MULT, 1.0)`` rounded once to f32.

    The product of two floats is exact in float64; the float64 sum rounds
    once and the cast to float32 once more.  That double rounding can
    differ from one correct rounding only where the float64 sum lands
    exactly half-way between two floats with a non-zero rounding error;
    for this multiplier no float32 input does that
    (`tests/test_torch_fig1.py` checks every one), so this is the FMA.
    """
    return (y.double() * MULT + 1.0).float()


def localised_copy_reference(x: torch.Tensor, reps: int) -> torch.Tensor:
    """The plain version: R `fma_pass`es in float32, cast back once."""
    y = x.float()
    for _ in range(reps):
        y = fma_pass(y)
    return y.to(x.dtype)


def _check(x: torch.Tensor, reps: int):
    if x.dim() != 2:
        raise ValueError(f"localised_copy takes (chunks, L), got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"localised_copy takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if int(reps) != reps or reps < 0:
        raise ValueError(f"reps must be an int >= 0, got {reps!r}")


def localised_copy(x: torch.Tensor, reps: int) -> torch.Tensor:
    """(chunks, L) -> same shape and dtype, R passes per element.

    CPU tensor: `localised_copy_reference`.  CUDA tensor: the kernel,
    counted in ``localised_copy.launches``.
    """
    _check(x, reps)
    if _device(x, "localised_copy") == "cpu":
        return localised_copy_reference(x, reps)
    if not x.is_contiguous():
        raise ValueError("localised_copy: the kernel takes a contiguous "
                         "tensor")
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_localised_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                      int(reps), int(x.dtype == torch.bfloat16),
                                      stream)
    _build.check(rc, lib, "repro_localised_copy_error", "localised_copy")
    localised_copy.launches += 1
    return out


localised_copy.launches = 0
