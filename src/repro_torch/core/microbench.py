"""The paper's Fig-1 micro-benchmark: repetitive array passes, localised vs not.

The counterpart of `repro/core/microbench.py`.  Each of the m homes owns
a chunk of a 1-D float array and makes R elementwise passes over it.
Under localisation the array is relaid into the chunk-contiguous layout
once and every pass stays there; under static non-localised mapping each
pass reads the homing's (interleaved) layout and writes the homes' own
chunks, a relayout there and back every pass; the auto baseline makes
no relayout at all.  The gap grows with R: the one-shot localisation is
amortised, the paper's Figure 1.

A pass is one launch of the `localised_copy` kernel with ``reps=1`` on
the card (the one fused elementwise pass XLA makes of the reference's
``y * 1.0001 + 1.0``), its plain version on the CPU; the relayouts are
`repro_torch.core.homing.relayout`s.  On a `RankMesh` each rank passes
over the elements it holds, in whatever layout (a pass is elementwise),
and each relayout is one counted all-to-all.

Entry point: `Locale.workload("microbench", reps=R)` (`repro_torch.core.api`).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.homing import (Axis, Homing, constrain, homing_layout,
                                     rank_shard)
from repro_torch.core.localisation import LocalisationPolicy, localise
from repro_torch.core.mesh import RankMesh, entry_device
from repro_torch.kernels import ops


def _pass(y: torch.Tensor) -> torch.Tensor:
    """One elementwise 'copy with work' pass: one `localised_copy` launch."""
    return ops.localised_copy(y.reshape(1, -1), 1).view(y.shape)


def repetitive_copy(x: torch.Tensor, reps: int, mesh,
                    policy: LocalisationPolicy,
                    axis: Axis = "data") -> torch.Tensor:
    """R passes over a 1-D tensor under the policy; returns the output.
    On a `RankMesh` `x` and the output are this rank's chunk."""
    static = mesh is not None and policy.static_mapping
    if policy.localised:
        y = localise(x, mesh, axis)             # Algorithm 2's memcpy, once
        for _ in range(reps):
            y = localise(_pass(y), mesh, axis)  # stays local: no traffic
    elif static:
        homed = homing_layout(policy.homing, mesh, axis)
        y = x
        for _ in range(reps):
            y = constrain(y, mesh, policy.homing, axis)  # re-pin to the homing
            y = localise(_pass(y), mesh, axis, homed)  # write the own chunk
    else:
        # the 'leave it to the runtime' baseline: no relayout at all
        y = x
        for _ in range(reps):
            y = _pass(y)
    return localise(y, mesh, axis) if (policy.localised or static) else y


def reference(x: torch.Tensor, reps: int) -> torch.Tensor:
    """The plain oracle: R fused passes on one device, no relayouts."""
    from repro_torch.kernels.localised_copy import localised_copy_reference
    return localised_copy_reference(x.reshape(1, -1), reps).view(x.shape)


def make_microbench_fn(mesh, policy: LocalisationPolicy, reps: int,
                       axis: Axis = "data", device=None):
    """``fn(x)``: move `x` to the mesh's device (without a mesh: `device`,
    default ``"cuda"``) and run `repetitive_copy`.  On a `RankMesh`, `x`
    is this rank's chunk, and ``fn.place(x)`` gives it from the whole
    input."""
    dev = entry_device(mesh, device)

    @functools.wraps(repetitive_copy)
    def fn(x):
        x = torch.as_tensor(x).to(dev)
        if x.dim() != 1:
            raise ValueError(f"microbench takes a 1-D input, got shape "
                             f"{tuple(x.shape)}")
        return repetitive_copy(x, reps, mesh, policy, axis)
    if isinstance(mesh, RankMesh):
        fn.place = lambda x: rank_shard(torch.as_tensor(x), mesh,
                                        Homing.LOCAL_CHUNKED, axis).view(-1)
    return fn
