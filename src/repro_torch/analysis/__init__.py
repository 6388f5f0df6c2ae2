"""homecheck for the port: the rules over the kernel launches it makes.

The counterpart of `repro.analysis`.  Every wrapper of
`repro_torch.kernels` states the launches it makes as data
(`launches.LaunchFacts`: grid, threads, shared memory, operand tile maps,
index type, ``blockIdx`` lanes); `launches.record()` collects them while a
workload runs, and the rules check them, with R1 and R2 on the
collective log of a `RankMesh`'s rank (`core.collectives`):

  R1 surprise-collective   a rank's collectives against collective_census
  R2 home-leak             no collective's ranks vary over an undeclared
                           mesh axis
  R3 smem-budget           shared memory per launch fits one block
  R5 write-race/coverage   output tile maps partition each output over
                           the blocks; input tiles stay in bounds
  R6 network-certification exchange network 0-1-certified as a sorter
  R7 index-arithmetic      ranks fit the launch's index type; the BIG
                           sentinel is representable and tie-stable
  R8 grid-dead-lane        no ``blockIdx`` lane that no block takes

R4, R9, R10 and R11 have no counterpart yet (report notes), nor have R1
and R2 on a one-process `HomeMesh`, which makes no collective.

Entry points: `Locale.check(...)` (`repro_torch.core.api`),
`check_workload` / `check_artifacts` here, and the
`repro_torch.launch.homecheck` CLI.
"""
from repro_torch.analysis.findings import (RULES, Finding, Report, Severity,
                                           normalize_rules, summarize)
from repro_torch.analysis.homecheck import check_artifacts, check_workload
from repro_torch.analysis.launches import record
from repro_torch.analysis.netverify import (certify_supported_meshes,
                                            zero_one_certify)

__all__ = ["Finding", "Report", "Severity", "RULES", "normalize_rules",
           "summarize", "check_artifacts", "check_workload", "record",
           "certify_supported_meshes", "zero_one_certify"]
