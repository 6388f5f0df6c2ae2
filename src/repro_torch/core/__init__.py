"""The paper's contribution, on a mesh of homes: cache/locality-aware placement.

Public surface (`repro_torch.core.api`): `Locale` and `Homed`.  Building
blocks: `homing`, `localisation`, `mesh` (`HomeMesh`), `sort` (the
constraint backend), `engine` (the per-home engine) and `microbench` (the
Fig-1 repetitive copy).  The counterpart of `repro.core`.
"""
from repro_torch.core.api import (Homed, Locale, register_workload,
                                  workload_names)
from repro_torch.core.homing import Homing, check_divisible
from repro_torch.core.localisation import LocalisationPolicy, chunk_bounds
from repro_torch.core.mesh import HomeMesh
from repro_torch.core.sort import (BACKENDS, check_nan_free,
                                   distributed_merge_sort, merge_sorted,
                                   pad_to_multiple, pad_value)
from repro_torch.core.engine import (LOCAL_PHASES, collective_census,
                                     exchange_network, exchange_schedule,
                                     shard_map_sort)
from repro_torch.core.microbench import repetitive_copy

__all__ = ["Locale", "Homed", "register_workload", "workload_names",
           "Homing", "check_divisible", "HomeMesh",
           "LocalisationPolicy", "chunk_bounds",
           "BACKENDS", "check_nan_free", "distributed_merge_sort",
           "merge_sorted", "pad_to_multiple", "pad_value",
           "LOCAL_PHASES", "collective_census", "exchange_network",
           "exchange_schedule", "shard_map_sort",
           "repetitive_copy"]
