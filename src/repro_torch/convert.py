"""Carry state from the JAX reference to the port, and make seeded data.

A sort has no weights: what crosses over is the data and the policy.
Everything here takes plain values or numpy arrays, so neither package
has to import the other; the tests hand the reference's numpy outputs in.
`make_sort_data`, `grid_rows`, `make_fig1_data` and `make_attention_inputs`
make the inputs that the tests and ``chip_smoke.py`` feed to both sides.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.api import Homed, Locale
from repro_torch.core.homing import Homing, to_layout
from repro_torch.core.localisation import LocalisationPolicy

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max


def policy_from_reference(fields: Mapping) -> LocalisationPolicy:
    """The port's policy from the reference policy's fields as plain
    values: ``localised``, ``static_mapping``, ``homing`` (its ``.value``,
    "local" or "hash") and ``outer``."""
    return LocalisationPolicy(localised=bool(fields["localised"]),
                              static_mapping=bool(fields["static_mapping"]),
                              homing=Homing(fields["homing"]),
                              outer=fields.get("outer"))


def homed_from_reference(array_np: np.ndarray, homing, locale: Locale) -> Homed:
    """The port's `Homed` from a reference ``Homed.data`` as numpy.

    ``(n,)`` for chunked homing, the ``(n/N, N)`` stripe view for
    interleaved homing; returns the same layout as per-home rows on the
    locale's device (row d = what device d held).
    """
    homing = Homing(homing) if not isinstance(homing, Homing) else homing
    arr = np.asarray(array_np)
    if homing == Homing.LOCAL_CHUNKED and arr.ndim != 1:
        raise ValueError(f"chunked data is 1-D, got shape {arr.shape}")
    if homing == Homing.HASH_INTERLEAVED and arr.ndim != 2:
        raise ValueError(f"interleaved data is (n/N, N), got shape {arr.shape}")
    x = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
    if locale.mesh is None:
        return Homed(x.reshape(1, -1), homing, locale.axis)
    if homing == Homing.HASH_INTERLEAVED and arr.shape[1] != locale.axis_size:
        raise ValueError(f"interleaved data has {arr.shape[1]} columns, the "
                         f"locale {locale.axis_size} homes")
    return Homed(to_layout(x, locale.mesh, homing, locale.axis), homing,
                 locale.axis)


def make_sort_data(n: int, dtype: str, seed: int) -> np.ndarray:
    """n values to sort, from `seed`.

    int32: the whole int32 range, with INT32_MIN and INT32_MAX (the BIG
    sentinel) present as data.  float32: normal values with +-inf, -0.0 and
    +0.0 present as data (the signed-zero order is what the sort kernels
    must reproduce).  No NaN.
    """
    rng = np.random.default_rng(seed)
    k = max(1, n // 100)
    if dtype == "int32":
        x = rng.integers(INT32_MIN, INT32_MAX, size=n, dtype=np.int32,
                         endpoint=True)
        specials = np.asarray([INT32_MAX, INT32_MIN, 0], np.int32)
    elif dtype == "float32":
        x = rng.standard_normal(n, dtype=np.float32)
        specials = np.asarray([np.inf, -np.inf, 0.0, -0.0], np.float32)
    else:
        raise ValueError(f"dtype must be 'int32' or 'float32', got {dtype!r}")
    if n:
        for v in specials:
            x[rng.integers(0, n, size=k)] = v
    return x


GRID_NAMES = ("dups_int", "rand_int", "sentinel_int", "rand_float",
              "sentinel_float", "sorted", "reversed")


def grid_rows(name: str, C: int, rows: int = 3, seed: int = 0) -> np.ndarray:
    """One corner of the property grid of the reference's local-phase
    tests, made with numpy: (rows, C) arrays worth sorting."""
    rng = np.random.default_rng(seed * 1_000_003 + C * 31 + rows)
    if name == "dups_int":               # heavy duplicates, int32
        return rng.integers(-4, 4, size=(rows, C), dtype=np.int32)
    if name == "rand_int":
        return rng.integers(-10**6, 10**6, size=(rows, C), dtype=np.int32)
    if name == "sentinel_int":           # BIG sentinel present as real data
        x = rng.integers(-9, 9, size=(rows, C), dtype=np.int32)
        x[:, ::3] = INT32_MAX
        return x
    if name == "rand_float":             # normals with zeros of both signs
        x = rng.standard_normal((rows, C), dtype=np.float32)
        x[:, 2::9] = 0.0
        x[:, 4::9] = -0.0
        return x
    if name == "sentinel_float":         # +/-inf present as real data
        x = rng.standard_normal((rows, C), dtype=np.float32)
        x[:, ::5] = np.inf
        x[:, 1::7] = -np.inf
        return x
    if name == "sorted":
        return np.broadcast_to(np.arange(C, dtype=np.int32), (rows, C)).copy()
    if name == "reversed":
        return np.broadcast_to(np.arange(C, 0, -1, dtype=np.int32),
                               (rows, C)).copy()
    raise ValueError(f"unknown grid corner {name!r}; want one of {GRID_NAMES}")


FLOAT_DTYPES = ("float32", "bfloat16")


def _as_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values; for "bfloat16", rounded (to nearest even) to values
    bfloat16 holds exactly, so both packages cast them without loss."""
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"dtype must be one of {FLOAT_DTYPES}, got {dtype!r}")
    if dtype == "float32":
        return x
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def make_fig1_data(shape, dtype: str, seed: int) -> np.ndarray:
    """The Fig-1 array: standard normals of `shape` (1-D for the
    workload, ``(chunks, L)`` for the kernel) as float32 numpy."""
    rng = np.random.default_rng(seed)
    return _as_dtype(rng.standard_normal(shape, dtype=np.float32), dtype)


def make_attention_inputs(B: int, H: int, KV: int, Sq: int, Skv: int,
                          hd: int, dtype: str, seed: int):
    """Attention's q ``(B, H, Sq, hd)`` and k, v ``(B, KV, Skv, hd)``:
    standard normals as float32 numpy."""
    rng = np.random.default_rng(seed)
    return tuple(_as_dtype(rng.standard_normal(s, dtype=np.float32), dtype)
                 for s in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)))
