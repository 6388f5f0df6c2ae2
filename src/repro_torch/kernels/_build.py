"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` of the package is compiled on its own by ``nvcc`` into
a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The output goes to ``build/repro_torch/`` at the root of the checkout and
is named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  All sources are compiled
in parallel (one ``nvcc`` each).  A failed build raises with the compiler's
output.  Nothing here runs when the module is imported.

Every source has a dry-run twin of its launch entry, ``repro_<name>_plan``
(``csrc/launch_plan.cuh``): the same host code, recording each launch it
would make instead of making it.  `c_plan` reads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME; the CUDA kernels of "
            "repro_torch are built from csrc/ at first use and need it")
    return str(path)


def sources() -> Tuple[str, ...]:
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    text += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None) -> Dict[str, str]:
    """Compile the named sources (default: all) that are not built yet.

    Returns ``{name: ptxas report}`` for the sources compiled by this call.
    Raises RuntimeError naming every source that failed.
    """
    names = sources() if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failed))
    return reports


def build_all() -> Tuple[float, Dict[str, str]]:
    """Build every source; returns (seconds, ptxas reports)."""
    t0 = time.perf_counter()
    reports = build()
    return time.perf_counter() - t0, reports


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(_target(name)))


def check(rc: int, lib: ctypes.CDLL, error_fn: str, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        fn = getattr(lib, error_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({fn(rc).decode(errors='replace')})")


class Launch(ctypes.Structure):
    """One launch as a plan twin reports it (`ReproLaunch` of
    ``csrc/launch_plan.cuh``)."""
    _fields_ = [("name", ctypes.c_char * 32), ("grid", ctypes.c_uint * 3),
                ("threads", ctypes.c_int), ("smem_static", ctypes.c_int),
                ("smem_dynamic", ctypes.c_int)]


def c_plan(lib: ctypes.CDLL, name: str, *args) -> List[Tuple]:
    """The launches the C entry ``repro_<name>`` would make for `args`, from
    its dry-run twin ``repro_<name>_plan``: a list of ``(kernel, (gx, gy,
    gz), threads, static smem, dynamic smem)``.  Needs a card (the static
    shared memory is read from the compiled kernels)."""
    fn = getattr(lib, f"repro_{name}_plan")
    fn.restype = ctypes.c_int
    cap = 64
    while True:
        buf = (Launch * cap)()
        n = fn(*args, buf, cap)
        if n < 0:
            check(-n, lib, f"repro_{name}_error", f"{name} plan")
        if n <= cap:
            return [(r.name.decode(), tuple(r.grid), r.threads, r.smem_static,
                     r.smem_dynamic) for r in buf[:n]]
        cap = n
