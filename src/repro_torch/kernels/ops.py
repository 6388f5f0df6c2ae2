"""Public wrappers of the port's kernels and their launch counters.

The counterpart of `repro/kernels/ops.py`.  Each wrapper runs its plain
version on a CPU tensor and its CUDA kernel on a CUDA tensor.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.sort import merge_sorted
from repro_torch.kernels.bitonic_sort import bitonic_sort
from repro_torch.kernels.fixtures import (dead_lane_kernel, gapped_index_map,
                                          oob_index_map, overlapping_index_map)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.local_sort import local_sort
from repro_torch.kernels.localised_copy import localised_copy
from repro_torch.kernels.merge_split import merge_runs, merge_split

#: every counted wrapper, by name (the last four: the analysis mutants)
WRAPPERS = {"local_sort": local_sort, "merge_split": merge_split,
            "merge_runs": merge_runs, "bitonic_sort": bitonic_sort, "localised_copy": localised_copy,
            "flash_attention": flash_attention,
            "overlapping_index_map": overlapping_index_map,
            "gapped_index_map": gapped_index_map,
            "oob_index_map": oob_index_map,
            "dead_lane_kernel": dead_lane_kernel}


def chunked_sort(x: torch.Tensor) -> torch.Tensor:
    """Full 1-D sort of (chunks, L): bitonic leaf sort per chunk, then the
    `merge_sorted` tree (one `merge_runs` launch a level on the card)."""
    runs = bitonic_sort(x)
    while runs.shape[0] > 1:
        runs = merge_sorted(runs[0::2], runs[1::2])
    return runs[0]


def reset_launches() -> None:
    """Set every wrapper's launch count (and merged-element count) to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    WRAPPERS["merge_split"].merged_elems = 0


def launch_counts() -> Dict[str, int]:
    """{wrapper name: kernel launches since the last reset}."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def merged_elems() -> int:
    """Merge outputs written by `merge_split` launches since the last reset."""
    return WRAPPERS["merge_split"].merged_elems


__all__ = ["bitonic_sort", "chunked_sort", "dead_lane_kernel",
           "flash_attention", "gapped_index_map", "launch_counts",
           "local_sort", "localised_copy", "merge_runs", "merge_split",
           "merged_elems",
           "oob_index_map", "overlapping_index_map", "reset_launches"]
