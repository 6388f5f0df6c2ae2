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

`plan` states the kernel's one launch for n elements: a grid-stride loop
over 16-byte vectors when both buffers are 16-byte aligned (each block
takes every G-th run of 256 vectors), then element by element over the
rest; `c_plan` reads the same launch from the C entry's dry-run twin.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import numpy as np
import torch

from repro_torch.analysis.launches import (LaunchFacts, OperandFacts,
                                          dtype_name, note)
from repro_torch.kernels import _build, _device

#: the pass's multiplier as the f32 constant the reference and kernel use
MULT = float(np.float32(1.0001))

DTYPES = (torch.float32, torch.bfloat16)

#: threads of a block, and the most blocks a launch takes (16 per SM)
LC_THREADS = 256
LC_MAX_BLOCKS = 132 * 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("localised_copy")
    lib.repro_localised_copy.restype = ctypes.c_int
    lib.repro_localised_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_localised_copy_plan.restype = ctypes.c_int
    lib.repro_localised_copy_plan.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_build.Launch), ctypes.c_int]
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


def plan(n: int, reps: int, dtype: str, vec: bool) -> List[LaunchFacts]:
    """The launch `repro_localised_copy` makes for n `dtype` elements.

    Tiles: with `vec`, a run of 256 vectors (256 * 16 bytes) of the first
    n // per elements (per = 4 f32 or 8 bf16 values a vector), run r taken
    by block r % G; then a run of 256 elements of the rest (all of it
    without `vec`), run r by block r % G.
    """
    if n == 0:
        return []
    per = 16 // torch.empty((), dtype=getattr(torch, dtype)).element_size()
    work = -(-n // per) if vec else n
    G = min(-(-work // LC_THREADS), LC_MAX_BLOCKS)
    head = (n // per) * per if vec else 0

    def strided(count):
        def tile_map(bx, by, bz):
            runs = np.arange(count, dtype=np.int64)
            return runs % G, runs[:, None]
        return tile_map

    views = []
    if head:
        views.append(((head,), (LC_THREADS * per,), 0,
                      strided(-(-head // (LC_THREADS * per)))))
    if n > head:
        views.append(((n - head,), (LC_THREADS,), head,
                      strided(-(-(n - head) // LC_THREADS))))
    ops = {role: tuple(OperandFacts(role, buf, shape, dtype, tile, fn, off)
                       for shape, tile, off, fn in views)
           for role, buf in (("in", "x"), ("out", "out"))}
    name = "lc_bf16" if dtype == "bfloat16" else "lc_f32"
    return [LaunchFacts(name, (G, 1, 1), LC_THREADS, 0, 0, "int64",
                        inputs=ops["in"], outputs=ops["out"],
                        call=(__name__, (n, reps, dtype, vec)))]


def c_plan(n: int, reps: int, dtype: str, vec: bool):
    """`plan`'s launch as the C entry's dry-run twin gives it (card)."""
    return _build.c_plan(_lib(), "localised_copy", n, reps,
                         int(dtype == "bfloat16"), int(vec))


def _launch(x: torch.Tensor, out: torch.Tensor, reps: int) -> None:
    """Run the C entry on CUDA tensors (uncounted, unrecorded)."""
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_localised_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                      int(reps),
                                      int(x.dtype == torch.bfloat16), stream)
    _build.check(rc, lib, "repro_localised_copy_error", "localised_copy")


def probe(n: int, reps: int, dtype: str, vec: bool,
          device="cuda") -> Dict[str, torch.Tensor]:
    """One launch on values from [0, 1) (finite outputs) into an output
    filled with `analysis.probe.poisoned`; without `vec` the input starts
    one element into its buffer, so it is not 16-byte aligned."""
    from repro_torch.analysis.probe import poisoned
    gen = torch.Generator().manual_seed(n + reps)
    dt = getattr(torch, dtype)
    buf = torch.rand(n + 1, generator=gen).to(dt).to(device)
    x = buf[:n] if vec else buf[1:]
    out = poisoned((n,), dt, device)
    if (x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0) != vec:
        raise RuntimeError("localised_copy probe: the buffers' alignment does "
                           "not give the planned loop")
    _launch(x, out, reps)
    return {"out": out}


def localised_copy(x: torch.Tensor, reps: int) -> torch.Tensor:
    """(chunks, L) -> same shape and dtype, R passes per element.

    CPU tensor: `localised_copy_reference`.  CUDA tensor: the kernel,
    counted in ``localised_copy.launches``.
    """
    _check(x, reps)
    # the output of either device is a fresh allocation, 16-byte aligned
    note(lambda: plan(x.numel(), reps, dtype_name(x.dtype),
                      x.data_ptr() % 16 == 0))
    if _device(x, "localised_copy") == "cpu":
        return localised_copy_reference(x, reps)
    if not x.is_contiguous():
        raise ValueError("localised_copy: the kernel takes a contiguous "
                         "tensor")
    out = torch.empty_like(x)
    _launch(x, out, reps)
    localised_copy.launches += 1
    return out


localised_copy.launches = 0
