"""Carry state from the JAX reference to the port, and make seeded data.

A sort has no weights: what crosses over is the data and the policy.
Everything here takes plain values or numpy arrays, so neither package
has to import the other; the tests hand the reference's numpy outputs in.
`make_sort_data`, `grid_rows`, `make_fig1_data`, `make_attention_inputs`
and `make_serve_stream` make the inputs that the tests and
``chip_smoke.py`` feed to both sides; `lm_params_from_reference` carries a
reference `LM`'s parameters over, `opt_state_from_reference` its
trainer's optimiser state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.api import Homed, Locale
from repro_torch.core.homing import Homing, rank_shard, to_layout
from repro_torch.core.localisation import LocalisationPolicy
from repro_torch.core.mesh import RankMesh

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
    locale's device (row d = what device d held).  On a `RankMesh` it is
    this rank's shard: the one row of what its device held.
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
    if isinstance(locale.mesh, RankMesh):
        return Homed(rank_shard(x, locale.mesh, homing, locale.axis), homing,
                     locale.axis)
    return Homed(to_layout(x, locale.mesh, homing, locale.axis), homing,
                 locale.axis)


#: the dtypes the sort takes beside int32 and float32
NARROW_SORT_DTYPES = ("int8", "int16", "uint8", "uint16", "uint32", "float16",
                      "bfloat16")


def make_sort_data(n: int, dtype: str, seed: int) -> np.ndarray:
    """n values to sort, from `seed`.

    int32: the whole int32 range, with INT32_MIN and INT32_MAX (the BIG
    sentinel) present as data.  float32: normal values with +-inf, -0.0 and
    +0.0 present as data (the signed-zero order is what the sort kernels
    must reproduce).  No NaN.  A dtype of `NARROW_SORT_DTYPES` gets the
    same treatment in its own range (its min and max, or +-inf and both
    zeros; float values normals times 100, rounded to the dtype), returned
    as numpy values that the dtype holds exactly -- int32 (int8, int16,
    uint8), the dtype itself (uint16, uint32) or float32: cast them with
    ``torch.from_numpy(x).to(dtype)`` or ``.astype``.
    """
    rng = np.random.default_rng(seed)
    k = max(1, n // 100)
    if dtype == "int32":
        x = rng.integers(INT32_MIN, INT32_MAX, size=n, dtype=np.int32,
                         endpoint=True)
        specials = np.asarray([INT32_MAX, INT32_MIN, 0], np.int32)
    elif dtype in ("int8", "int16", "uint8", "uint16", "uint32"):
        info = np.iinfo(dtype)
        held = np.dtype(dtype) if dtype in ("uint16", "uint32") else np.int32
        draw = np.int64 if dtype == "uint32" else np.int32
        x = rng.integers(info.min, info.max, size=n, dtype=draw,
                         endpoint=True).astype(held)
        specials = np.asarray([info.max, info.min, 0], held)
    elif dtype in ("float32", "float16", "bfloat16"):
        x = rng.standard_normal(n, dtype=np.float32)
        if dtype != "float32":
            x = torch.from_numpy(x * 100).to(getattr(torch, dtype)).float() \
                .numpy()
        specials = np.asarray([np.inf, -np.inf, 0.0, -0.0], np.float32)
    else:
        raise ValueError(f"dtype must be 'int32', 'float32' or one of "
                         f"{NARROW_SORT_DTYPES}, got {dtype!r}")
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


FLOAT_DTYPES = ("float32", "bfloat16", "float16")


def _as_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values; for "bfloat16" and "float16", rounded (to nearest
    even) to values the dtype holds exactly, so both packages cast them
    without loss."""
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"dtype must be one of {FLOAT_DTYPES}, got {dtype!r}")
    if dtype == "float32":
        return x
    return torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()


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


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A tensor with `a`'s values and dtype; a bfloat16 numpy array (the
    ``ml_dtypes`` type JAX hands out) goes through its bits."""
    a = np.array(a)                       # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_reference(tree, device="cuda"):
    """The port's `LM` parameters from the reference `LM`'s pytree, its
    leaves as numpy arrays (``jax.tree.map(np.asarray, params)``): the same
    nested dicts, each leaf a tensor of its dtype on `device`."""
    if isinstance(tree, Mapping):
        return {k: lm_params_from_reference(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(np.asarray(tree)).to(device)


def opt_state_from_reference(tree, device="cuda"):
    """The port's optimiser state (`models.steps.init_opt_state`'s
    structure) from the reference's, its leaves as numpy arrays: AdamW's
    float32 ``m`` and ``v``, its int32 ``step``, and ``ef`` when the
    config compresses gradients -- the same walk as the parameters'."""
    return lm_params_from_reference(tree, device)


def make_serve_stream(n: int, vocab: int, prompt_len, *, sessions: int,
                      new_tokens=(8, 32), slots: int, seed: int,
                      prefix: int = 0):
    """An open-loop request stream of the shape of
    ``benchmarks/bench_serve.py``'s: bursts of ``2 * slots`` arrivals,
    zipf-skewed sessions, bimodal decode lengths (30 % long).  Returns
    dicts of `runtime.server.Request`'s fields.

    ``prompt_len`` = (lo, hi): each prompt's length, uniform.  A prompt
    opens with its session's first `prefix` tokens (a shared prefix that
    the paged mode can attach from the pool), then random tokens."""
    lo, hi = prompt_len
    short, long_ = new_tokens
    rng = np.random.RandomState(seed)
    weights = 1.0 / (1.0 + np.arange(sessions))
    weights /= weights.sum()
    heads = rng.randint(0, vocab, (sessions, prefix)).astype(np.int32)
    out = []
    for rid in range(n):
        plen = int(rng.randint(lo, hi + 1))
        sess = int(rng.choice(sessions, p=weights))
        keep = min(plen, prefix)
        prompt = np.concatenate([heads[sess, :keep], rng.randint(
            0, vocab, plen - keep).astype(np.int32)])
        out.append(dict(rid=rid, prompt=prompt,
                        max_new=int(long_ if rng.rand() < 0.3 else short),
                        session=f"s{sess}",
                        t_arrive=float(rid // (2 * slots)) * (hi + short)))
    return out
