"""The paper's technique: Algorithm 1, for homes on a `HomeMesh`.

  1. Divide the input array of size n into m = #homes chunks.       (bounds)
  2. Assign each chunk to a worker by passing pointers.              (rows)
  3. Map each worker to a home — STATIC.                             (mesh order)
  4. Copy each part into a locally-homed buffer.                     (relayout)
  5. Free the dynamic memory as soon as possible.

The counterpart of `repro/core/localisation.py`: `chunk_bounds` and
`LocalisationPolicy`.  The reference's `localise`/`place` are constraint
backend mechanics (`with_sharding_constraint`) and are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.homing import Homing


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
