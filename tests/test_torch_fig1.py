"""The port's Fig-1 micro-benchmark and `localised_copy` against JAX.

`repetitive_copy` under the localised, the static non-localised and the
auto policy, and the ``"microbench"`` workload, against the reference's
`repetitive_copy` and `reference` (jitted, as the workload runs them);
the plain `localised_copy` against the reference kernel in interpret mode
and its jitted oracle `ref.localised_copy_ref`, at the shapes of
`tests/test_kernels.py`, float32 and bfloat16.

Tolerance: bit-exact.  Jitted, XLA fuses the reference's pass
``y * 1.0001 + 1.0`` into one fused multiply-add, and the port computes
that FMA (`localised_copy.fma_pass`); the last test proves that its
float64 form rounds like one FMA for every float32 input.  (Run eagerly,
``ref.localised_copy_ref`` rounds twice per pass and differs from both.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Homing as JHoming
from repro.core import Locale as JLocale
from repro.core import LocalisationPolicy as JPolicy
from repro.core import microbench as jmb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import make_fig1_data
from repro_torch.core import (HomeMesh, Homing, Locale, LocalisationPolicy,
                              microbench)
from repro_torch.core.homing import relayout_counts, reset_relayouts
from repro_torch.kernels import ops
from repro_torch.kernels.localised_copy import MULT, localised_copy_reference

#: the three policies of Fig 1: localised static chunked, non-localised
#: static hash, and the auto baseline
POLICIES = {"localised": (True, True, "local"),
            "nonlocalised": (False, True, "hash"),
            "auto": (False, False, "hash")}


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def bf16_bits(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16).view(jnp.int16))


@pytest.mark.parametrize("reps", [0, 1, 7, 32])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_repetitive_copy_matches_jax(name, reps):
    loc, static, homing = POLICIES[name]
    x = make_fig1_data(1024, "float32", reps)
    jpol = JPolicy(loc, static, JHoming(homing))
    ref = np.asarray(jax.jit(jmb.repetitive_copy, static_argnums=(1, 2, 3))(
        jnp.asarray(x), reps, None, jpol))
    oracle = np.asarray(jax.jit(jmb.reference, static_argnums=1)(
        jnp.asarray(x), reps))
    np.testing.assert_array_equal(bits(ref), bits(oracle))
    policy = LocalisationPolicy(loc, static, Homing(homing))
    for shape, axis in (({"data": 8}, "data"),
                        ({"pod": 2, "data": 4}, ("pod", "data"))):
        got = microbench.repetitive_copy(torch.from_numpy(x), reps,
                                         HomeMesh(shape, device="cpu"),
                                         policy, axis)
        np.testing.assert_array_equal(bits(got.numpy()), bits(ref))
    np.testing.assert_array_equal(
        bits(microbench.reference(torch.from_numpy(x), reps).numpy()),
        bits(oracle))


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_microbench_workload_matches_jax_workload(name):
    loc, static, homing = POLICIES[name]
    x = make_fig1_data(4096, "float32", 1)
    ref = np.asarray(JLocale(policy=JPolicy(loc, static, JHoming(homing)))
                     .workload("microbench", reps=8)(jnp.asarray(x)))
    policy = LocalisationPolicy(loc, static, Homing(homing))
    for locale in (Locale(policy=policy),
                   Locale(HomeMesh({"data": 8}, device="cpu"), "data", policy)):
        got = locale.workload("microbench", reps=8, device="cpu"
                              if locale.mesh is None else None)(x)
        np.testing.assert_array_equal(bits(got.numpy()), bits(ref))


@pytest.mark.parametrize("N", [2, 8])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_microbench_relayouts_per_policy(name, N):
    """Only the static non-localised policy relays out: to its homing and
    back to the homes' own chunks, every pass.  The localised policy
    localises a plain (chunked) input for free; the auto baseline never
    relays out."""
    loc, static, homing = POLICIES[name]
    n, reps = 1024, 5
    fn = Locale(HomeMesh({"data": N}, device="cpu"), "data",
                LocalisationPolicy(loc, static, Homing(homing))).workload(
        "microbench", reps=reps)
    ops.reset_launches()
    reset_relayouts()
    fn(make_fig1_data(n, "float32", 2))
    moved = 2 * reps * n * (N - 1) // N if name == "nonlocalised" else 0
    assert relayout_counts() == {"relayouts": 2 * reps if moved else 0,
                                 "elems": moved, "bytes": 4 * moved}
    assert ops.launch_counts()["localised_copy"] == 0     # CPU: plain version


@pytest.mark.parametrize("chunks,L,reps", [(4, 256, 1), (8, 512, 16),
                                           (2, 1024, 64), (3, 1001, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_localised_copy_matches_jax_kernel(chunks, L, reps, dtype):
    x = make_fig1_data((chunks, L), dtype, chunks * L + reps)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    kern = jops.localised_copy(jx, reps)                   # interpret mode
    oracle = jax.jit(jref.localised_copy_ref, static_argnums=1)(jx, reps)
    got = ops.localised_copy(torch.from_numpy(x).to(getattr(torch, dtype)),
                             reps)
    assert got.dtype == getattr(torch, dtype) and got.shape == (chunks, L)
    if dtype == "float32":
        want = bits(kern)
        np.testing.assert_array_equal(bits(oracle), want)
        np.testing.assert_array_equal(bits(got.numpy()), want)
    else:
        want = bf16_bits(kern)
        np.testing.assert_array_equal(bf16_bits(oracle), want)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), want)


def test_localised_copy_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.localised_copy(torch.zeros(2, 4, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="chunks, L"):
        ops.localised_copy(torch.zeros(8), 1)
    with pytest.raises(ValueError, match="reps"):
        ops.localised_copy(torch.zeros(2, 4), -1)
    with pytest.raises(ValueError, match="meta"):
        ops.localised_copy(torch.zeros(2, 4, device="meta"), 1)
    x = torch.zeros(2, 4)
    assert torch.equal(localised_copy_reference(x, 0), x)


def test_float64_pass_rounds_like_one_fma_for_every_float32():
    """``(y.double() * MULT + 1.0).float()`` rounds twice; it differs from
    one rounding only where the float64 sum lands exactly half-way between
    two floats while its own error is not zero.  The error is zero unless
    |y| < 2^-6 (the exact sum then fits 53 bits), so the half-way points
    in reach are ``1 +- odd * 2^-24`` (above 1) and ``1 - odd * 2^-25``
    (below).  With y = Y * 2^(e-23) (Y the 24-bit significand) and
    MULT = c * 2^-23, ``|y| * MULT = Y * c * 2^(e-46)``; the sum is within
    half a float64 ulp of a half-way point iff ``Y * c`` is within
    2^(-7-e) (above 1; 2^(-8-e) below) of an odd multiple of 2^(22-e)
    (2^(21-e)).  Every significand of every exponent that can reach one
    is checked, and none does.
    """
    c = int(np.float32(MULT).view(np.int32) & 0x7FFFFF | 0x800000)
    assert c * 2.0**-23 == MULT
    Y = np.arange(2**23, 2**24, dtype=np.int64)
    prod = Y * c
    hits = 0
    for e in range(-7, -40, -1):
        for sh, tol in ((22 - e, -7 - e), (21 - e, -8 - e)):
            if sh > 62:
                continue
            d = np.abs(prod % (2 ** (sh + 1)) - 2 ** sh)
            hits += int((d <= 2 ** tol).sum())
    assert hits == 0
    # and at the exponents where the float64 form is exact anyway, spot
    # check against a fused jnp pass
    y = make_fig1_data(1 << 16, "float32", 5) * np.float32(2.0**-8)
    fused = np.asarray(jax.jit(lambda v: v * 1.0001 + 1.0)(jnp.asarray(y)))
    np.testing.assert_array_equal(
        bits(localised_copy_reference(torch.from_numpy(y)[None], 1).numpy()[0]),
        bits(fused))
