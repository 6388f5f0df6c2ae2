"""Known-bad fixtures the port's analyser must provably flag.

The counterpart of `repro/analysis/fixtures.py`:

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
  `mutant_scheduler`       -- R9 ERROR: the production scheduler
                              transitions with one named mutation
                              (`MUTANT_INVARIANT`), each caught by a
                              minimal witness.
  `hbm_hog`                -- R10 ERROR at a 32 MiB ceiling: x of
                              4,194,304 f32, its negation, its exponential
                              and their sum, 64 MiB live at once.
  `r4_step`                -- R4 WARN: ``b * 2.0`` on a 2 MiB buffer comes
                              back in fresh storage; its twin
                              `r4_step_in_place` (``b.mul_(2.0)``) is clean.
  `branch_mismatch`        -- R11 ERROR: one rank all-reduces under a branch
                              on its data, the other all-gathers.
  `data_dependent_loop`    -- R11 WARN: the count of psums depends on the
                              values (the same on every rank of a run).
  `consistent_branches`    -- R11 clean: both branches make the same psum.

The four kernel mutants are kernels that run: `mutant_launches` runs one
under `launches.record()` and returns its output and recorded launch
facts, the port's form of the reference's traced jaxpr.  The reference's
HLO texts of R10 and R11 become calls that run here: `call_facts` reads
the hog's buffers, and `r11_rank_logs` runs the three collective fixtures
on every rank of a world (`launch.mesh.spawn`) and returns each rank's
logs of two runs on other data, which `r11_reports` holds to R11.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

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


#: the invariant each scheduler mutation provably violates (the R9 tests
#: assert the witness carries exactly this tag)
MUTANT_INVARIANT = {
    "no_aging": "I2-starvation",
    "drop_charge": "I1-uncharged-move",
    "greedy_spill": "I7-spill-order",
    "leak_page": "I8-page-leak",
}

#: smallest DEFAULT_LATTICE entry on which each mutation is caught — the
#: witness search stops at the first violation, so these certify fast
_MUTANT_ENTRY = {
    "no_aging": "homed-1x2",
    "drop_charge": "homed-2x1",
    "greedy_spill": "homed-2x1",
    "leak_page": "homed-paged",
}


def mutant_scheduler(mutation: str):
    """A `LatticeEntry` running the production scheduler transitions with
    one named mutation enabled — `schedcheck.certify` must return a
    minimal witness tagged `MUTANT_INVARIANT[mutation]` for it."""
    from repro_torch.analysis.schedcheck import DEFAULT_LATTICE
    if mutation not in MUTANT_INVARIANT:
        raise ValueError(f"unknown scheduler mutation {mutation!r}; "
                         f"known: {', '.join(MUTANT_INVARIANT)}")
    entry = next(e for e in DEFAULT_LATTICE
                 if e.name == _MUTANT_ENTRY[mutation])
    return dataclasses.replace(
        entry, name=f"{entry.name}+{mutation}",
        cfg=dataclasses.replace(entry.cfg,
                                mutations=frozenset({mutation})))


#: the hog's input: 16 MiB of float32
HOG_ELEMENTS = 4_194_304

#: the R4 step's buffer: 2 MiB of float32
R4_ELEMENTS = 1 << 19


def hbm_hog(x: torch.Tensor) -> torch.Tensor:
    """x, -x, exp(x) and their sum live at once: 4 x 16 MiB at the peak
    for `HOG_ELEMENTS` (R10 against a 32 MiB ceiling)."""
    a = torch.neg(x)
    b = torch.exp(x)
    return a + b


def hbm_hog_input(device=None) -> torch.Tensor:
    return torch.zeros(HOG_ELEMENTS, dtype=torch.float32,
                       device=entry_device(None, device))


def r4_step(b: torch.Tensor) -> torch.Tensor:
    """A step that returns its buffer's shape in fresh storage (R4 WARN
    at `R4_ELEMENTS`)."""
    return b * 2.0


def r4_step_in_place(b: torch.Tensor) -> torch.Tensor:
    """The same step written in place (R4 clean)."""
    return b.mul_(2.0)


def branch_mismatch(x: torch.Tensor, mesh) -> torch.Tensor:
    """A rank whose data sums above 0 all-reduces; the others all-gather
    the same bytes.  (The gather is what lets the run end: one all-gather
    of the same size carries both on the wire.  A branch without any
    collective would hang the summing rank, which is what R11 is there
    to catch before a run does.)"""
    from repro_torch.core import collectives as coll
    if float(x.sum()) > 0:
        return coll.psum(x, mesh, "data")
    return coll.all_gather(x, mesh, "data")[0]


def data_dependent_loop(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the ranks and scale until every value is within 1: the
    count of psums is ceil(log2 max|x|) (the ranks of a run hold the same
    data, so they agree; two runs on other data do not)."""
    from repro_torch.core import collectives as coll
    g = mesh.shape["data"]
    while float(x.abs().max()) > 1.0:
        x = coll.psum(x, mesh, "data") / (2 * g)
    return x


def consistent_branches(x: torch.Tensor, mesh) -> torch.Tensor:
    """Both branches of a branch on the rank's data make the same psum."""
    from repro_torch.core import collectives as coll
    if float(x.sum()) > 0:
        return coll.psum(x, mesh, "data")
    return coll.psum(-x, mesh, "data")


#: the R11 fixtures, each with the findings (rule, severity) R11 gives
R11_FIXTURES = {
    "branch_mismatch": (branch_mismatch, [("R11", "ERROR")]),
    "data_dependent_loop": (data_dependent_loop, [("R11", "WARN")]),
    "consistent_branches": (consistent_branches, []),
}


def r11_input(name: str, rank: int, run: int) -> torch.Tensor:
    """f32[8] for `name` on `rank` in `run` (0 or 1): the branches'
    data has the rank's sign (rank 0 positive), the loop's is the same on
    every rank and 7 or 15 at its largest (3 or 4 psums)."""
    x = torch.arange(8, dtype=torch.float32)
    if name == "data_dependent_loop":
        return x * 2 + 1 if run else x
    return (x + 1 + run) * (1 if rank == 0 else -1)


def r11_rank_logs(device) -> Dict[str, List[List[Dict]]]:
    """One rank's part (`launch.mesh.spawn`): run each R11 fixture twice
    on a ``{"data": world}`` `RankMesh`; returns each fixture's
    `livecheck.log_signature` of both runs."""
    from repro_torch.analysis.livecheck import log_signature
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import make_rank_mesh
    mesh = make_rank_mesh(device=device)
    out: Dict[str, List[List[Dict]]] = {}
    for name, (fn, _) in R11_FIXTURES.items():
        out[name] = []
        for run in (0, 1):
            coll.reset_collectives()
            fn(r11_input(name, mesh.rank, run).to(mesh.device), mesh)
            out[name].append(log_signature(coll.collective_log()))
    coll.reset_collectives()
    return out


def r11_reports(ranks: Sequence[Dict]) -> Dict:
    """R11 over `r11_rank_logs`'s results of every rank, by fixture."""
    from repro_torch.analysis.findings import Report
    from repro_torch.analysis.livecheck import r11_collective_control_flow
    out = {}
    for name in R11_FIXTURES:
        rep = Report(target=f"r11-{name}")
        r11_collective_control_flow(rep, [r[name][0] for r in ranks],
                                    second=[r[name][1] for r in ranks])
        out[name] = rep
    return out


__all__ = ["HOG_ELEMENTS", "KINDS", "MUTANTS", "MUTANT_INVARIANT",
           "R11_FIXTURES", "R4_ELEMENTS", "branch_mismatch",
           "consistent_branches", "data_dependent_loop", "dead_lane_kernel",
           "gapped_index_map", "hbm_hog", "hbm_hog_input",
           "inverted_keep_network", "mutant_launches", "mutant_scheduler",
           "nonbijective_network", "oob_index_map", "overlapping_index_map",
           "r11_input", "r11_rank_logs", "r11_reports", "r4_step",
           "r4_step_in_place"]
