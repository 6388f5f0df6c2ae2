"""The paper's technique: Algorithm 1, on a `HomeMesh` or a `RankMesh`.

  1. Divide the input array of size n into m = #homes chunks.       (bounds)
  2. Assign each chunk to a worker by passing pointers.              (rows)
  3. Map each worker to a home — STATIC.                             (mesh order)
  4. Copy each part into a locally-homed buffer.                     (relayout)
  5. Free the dynamic memory as soon as possible.                    (donation)

The counterpart of `repro/core/localisation.py`: `chunk_bounds`,
`LocalisationPolicy`, and the constraint-backend mechanics `localise`,
`place` and `donate_buffers`.  Where the reference emits a sharding
constraint, the port makes the relayout it stands for
(`repro_torch.core.homing.relayout`): on a `HomeMesh` a copy between the
rows of one tensor, on a `RankMesh` one counted collective.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.homing import (Axis, Homing, Layout, chunked_sharding,
                                     constrain, relayout)


def chunk_bounds(n: int, m: int) -> Tuple[Tuple[int, int], ...]:
    """Ownership math: chunk w = [w*ceil(n/m), ...) clipped (paper step 1)."""
    c = -(-n // m)
    return tuple((min(w * c, n), min((w + 1) * c, n)) for w in range(m))


@dataclass(frozen=True)
class LocalisationPolicy:
    """The three building blocks, as independently switchable knobs.

    `outer` is the fourth knob for hierarchical (pod, data) meshes: ``None``
    treats the sort axes as one flat home space; ``"hash"`` /
    ``"replicate"`` confine the deep merge-split levels to intra-pod
    neighbour exchanges and run each top (cross-pod) merge level as one
    gather over the pod axis, with the cross-pod merge-split work
    replicated per pod.
    """
    localised: bool = True        # copy chunks into locally-homed buffers
    static_mapping: bool = True   # explicit layouts vs runtime-chosen
    homing: Homing = Homing.LOCAL_CHUNKED
    outer: Optional[str] = None   # None = flat; "hash" | "replicate"

    OUTER_MODES = (None, "hash", "replicate")

    def __post_init__(self):
        if self.outer not in self.OUTER_MODES:
            raise ValueError(f"unknown outer mode {self.outer!r}; "
                             f"want one of {self.OUTER_MODES}")
        if self.outer is not None and not self.localised:
            raise ValueError(
                "outer={!r} needs localised=True — the hierarchical engine "
                "is the localised path's merge-split network; non-localised "
                "gathers everything every level regardless".format(self.outer))

    @classmethod
    def hierarchical(cls, inner: str = "localised",
                     outer: str = "hash") -> "LocalisationPolicy":
        """The two-distance-class policy for (pod, data) meshes.

        ``inner="localised"`` starts from chunk-contiguous input,
        ``"hash"`` from element-interleaved input, which pays the one-shot
        all-to-all relayout first.
        """
        if inner not in ("localised", "hash"):
            raise ValueError(f"unknown inner mode {inner!r}; "
                             f"want 'localised' or 'hash'")
        homing = (Homing.LOCAL_CHUNKED if inner == "localised"
                  else Homing.HASH_INTERLEAVED)
        return cls(localised=True, static_mapping=True, homing=homing,
                   outer=outer)

    @property
    def name(self) -> str:
        hier = f"hier.{self.outer}-" if self.outer else ""
        return (f"{hier}{'loc' if self.localised else 'nonloc'}-"
                f"{'static' if self.static_mapping else 'auto'}-"
                f"{self.homing.value}")


def localise(x, mesh, axis: Axis = "data", src: Optional[Layout] = None):
    """One-shot relayout of `x` (in `src`, default chunked) into the
    chunk-contiguous locally-homed layout.  Identity without a mesh.  On a
    `RankMesh` `x` is this rank's elements under `src`, and the result its
    chunk (`homing.relayout`)."""
    if mesh is None:
        return x
    return relayout(x, mesh, chunked_sharding(mesh, axis), src, axis)


def place(x, mesh, policy: LocalisationPolicy, axis: Axis = "data",
          src: Optional[Layout] = None):
    """Layout an intermediate value according to the policy.

    - static+localised: chunk-contiguous (the technique).
    - static+non-localised: pinned to the input's homing.
    - non-static: no relayout at all; the runtime keeps whatever layout
      the value has (the 'leave it to the OS scheduler' baseline).
    """
    if mesh is None or not policy.static_mapping:
        return x
    if policy.localised:
        return localise(x, mesh, axis, src)
    return constrain(x, mesh, policy.homing, axis, src)


def donate_buffers(fn):
    """Paper step 5 ('free as soon as finished').

    PyTorch runs eagerly, so there is no jit to wrap: this returns `fn`
    itself, and documents that the function may reuse its first
    argument's storage (the caller must not read that argument after the
    call), as the reference's ``jax.jit(fn, donate_argnums=(0,))`` may.
    """
    return fn
