"""Known-bad fixtures the port's analyser must provably flag.

The counterpart of `repro/analysis/fixtures.py`, for the rules the port
has (R5, R6, R8):

  `overlapping_index_map`  -- R5 ERROR: blocks 2k and 2k + 1 write output
                              row k (a CUDA kernel, `kernels.fixtures`).
  `gapped_index_map`       -- R5 WARN: half the output rows never written.
  `oob_index_map`          -- R5 ERROR: blocks read input rows past the end.
  `dead_lane_kernel`       -- R8 WARN: a ``blockIdx`` lane no block takes.
  `nonbijective_network`   -- R6 ERROR (structural): one substage's
                              exchange sends every source to home 0.
  `inverted_keep_network`  -- R6 ERROR (0-1): keep flags swapped on a whole
                              substage -- still pairwise complementary, but
                              the network no longer sorts; only the 0-1
                              sweep catches it.

The four mutants are kernels that run: `mutant_launches` runs one under
`launches.record()` and returns its output and recorded launch facts, the
port's form of the reference's traced jaxpr.  The scheduler (R9) and HLO
(R10, R11) fixtures wait for their slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.analysis.launches import LaunchFacts, record
from repro_torch.core.mesh import entry_device
from repro_torch.kernels.fixtures import (KINDS, MUTANTS, dead_lane_kernel,
                                          gapped_index_map, oob_index_map,
                                          overlapping_index_map, run_mutant)

#: each mutant's wrapper name -> its kind
MUTANT_NAMES = {fn.__name__: kind for kind, fn in MUTANTS.items()}


def mutant_launches(name: str, rows: int = 4, cols: int = 128,
                    device=None, x=None) -> Tuple[torch.Tensor,
                                                  List[LaunchFacts]]:
    """Run the mutant `name` (a wrapper name or a kind) on `x` (default
    ``arange`` rows on `device`, by default the card, as every entry point:
    ``device="cpu"`` runs the plain versions); returns ``(y, launches
    recorded)``.  A given `x` runs where it lies."""
    kind = MUTANT_NAMES.get(name, name)
    if x is None:
        x = torch.arange(rows * cols, dtype=torch.float32).view(rows, cols)
        x = x.to(entry_device(None, device))
    with record() as launches:
        y, _ = run_mutant(kind, x)
    return y, list(launches)


def nonbijective_network(m: int = 4):
    """A flat exchange network whose first perm routes everyone to 0."""
    from repro_torch.core.engine import exchange_network
    from repro_torch.core.localisation import LocalisationPolicy
    net = exchange_network(LocalisationPolicy(), (m,))
    lv0 = net.levels[0]
    bad = dataclasses.replace(lv0, perm=tuple((s, 0) for s, _ in lv0.perm))
    return dataclasses.replace(net, levels=(bad,) + net.levels[1:])


def inverted_keep_network(m: int = 4):
    """A structurally-sound network that fails the 0-1 principle: the
    final stage's deepest substage keeps the wrong halves (flags still
    complementary across each pair, so only 0-1 certification can tell)."""
    from repro_torch.core.engine import exchange_network
    from repro_torch.core.localisation import LocalisationPolicy
    net = exchange_network(LocalisationPolicy(), (m,))
    last = m.bit_length() - 2           # final merge stage index
    levels = tuple(
        dataclasses.replace(lv, keep_low=tuple(not b for b in lv.keep_low))
        if (lv.stage, lv.substage) == (last, 0) else lv
        for lv in net.levels)
    return dataclasses.replace(net, levels=levels)


__all__ = ["KINDS", "MUTANTS", "dead_lane_kernel", "gapped_index_map",
           "inverted_keep_network", "mutant_launches", "nonbijective_network",
           "oob_index_map", "overlapping_index_map"]
