"""The paper's own workload: parallel merge sort over int32 arrays.

Table 1 cases = {localised, non-localised} x {static, runtime mapping} x
{local-homing (chunk-contiguous), hash-for-home (interleaved)}.

A copy of `repro/configs/paper_sort.py`: the port imports nothing of the
JAX package, and `tests/test_torch_core.py` holds the two equal.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class SortConfig:
    name: str = "paper-sort"
    array_size: int = 100_000_000   # paper Fig 2: 100M ints
    micro_array_size: int = 1_000_000  # paper Fig 1: 1M ints
    dtype: str = "int32"
    localised: bool = True          # copy chunks into locally-homed buffers
    static_mapping: bool = True     # explicit chunk->device ownership
    homing: str = "local"           # "local" (chunked) | "hash" (interleaved)


CASES = {
    # paper Table 1 (mapper "Tile Linux" == runtime-chosen layout;
    # hash "All but stack" == interleaved; "None" == local homing)
    1: SortConfig(localised=False, static_mapping=False, homing="hash"),
    2: SortConfig(localised=False, static_mapping=False, homing="local"),
    3: SortConfig(localised=False, static_mapping=True, homing="hash"),
    4: SortConfig(localised=False, static_mapping=True, homing="local"),
    5: SortConfig(localised=True, static_mapping=False, homing="hash"),
    6: SortConfig(localised=True, static_mapping=False, homing="local"),
    7: SortConfig(localised=True, static_mapping=True, homing="hash"),
    8: SortConfig(localised=True, static_mapping=True, homing="local"),
}
