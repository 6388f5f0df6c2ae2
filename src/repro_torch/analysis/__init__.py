"""homecheck for the port: the rules over what a target does when it runs.

The counterpart of `repro.analysis`.  Every wrapper of
`repro_torch.kernels` states the launches it makes as data
(`launches.LaunchFacts`: grid, threads, shared memory, operand tile maps,
index type, ``blockIdx`` lanes); `launches.record()` collects them while a
target runs, `mem_facts.call_facts` the buffers it makes and returns, and
`core.collectives` the collectives of a `RankMesh`'s rank:

  R1 surprise-collective   a rank's collectives against collective_census
  R2 home-leak             no collective's ranks vary over an undeclared
                           mesh axis
  R3 smem-budget           shared memory per launch fits one block
  R4 donation-audit        large arguments are not copied every step
                           (they come back in their own storage)
  R5 write-race/coverage   output tile maps partition each output over
                           the blocks; input tiles stay in bounds
  R6 network-certification exchange network 0-1-certified as a sorter
  R7 index-arithmetic      ranks fit the launch's index type; the BIG
                           sentinel is representable and tie-stable
  R8 grid-dead-lane        no ``blockIdx`` lane that no block takes
  R9 scheduler-certification  serving-scheduler invariants I1-I8 proved
                           exhaustively over the small-config lattice
  R10 device-live-range    peak live device bytes fit the per-device
                           ceiling
  R11 collective-control-flow  every rank issues the same collectives
                           (no branch or trip count on a rank's data)

R1, R2 and R11 need the collectives of a `RankMesh`'s ranks; on a
one-process `HomeMesh` none runs, and the report says so.

Entry points: `Locale.check(...)` (`repro_torch.core.api`),
`check_workload` / `check_decode` / `check_artifacts` here, and the
`repro_torch.launch.homecheck` CLI.
"""
from repro_torch.analysis.findings import (RULES, Finding, Report, Severity,
                                           normalize_rules, summarize)
from repro_torch.analysis.homecheck import (check_artifacts, check_decode,
                                            check_workload)
from repro_torch.analysis.launches import record
from repro_torch.analysis.netverify import (certify_supported_meshes,
                                            zero_one_certify)
from repro_torch.analysis.schedcheck import (DEFAULT_LATTICE, FAST_LATTICE,
                                             certify_lattice)

__all__ = ["Finding", "Report", "Severity", "RULES", "normalize_rules",
           "summarize", "check_artifacts", "check_decode", "check_workload",
           "record", "certify_supported_meshes", "zero_one_certify",
           "DEFAULT_LATTICE", "FAST_LATTICE", "certify_lattice"]
