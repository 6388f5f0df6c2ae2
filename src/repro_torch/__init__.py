"""PyTorch/CUDA port of the cache-aware parallel merge sort.

A second package beside the JAX reference (`repro`): it imports torch and
numpy, never jax and nothing of `repro`.  The homes of a mesh are rows of
one tensor on one device (`HomeMesh`), and the TPU kernels of the sort
engine's path are hand-written CUDA kernels for Hopper
(``repro_torch/csrc``), each beside its plain PyTorch version.
"""
from repro_torch.core import (LOCAL_PHASES, BACKENDS, HomeMesh, Homed, Homing,
                              Locale, LocalisationPolicy, chunk_bounds,
                              collective_census, exchange_network,
                              exchange_schedule, merge_sorted)

__all__ = ["LOCAL_PHASES", "BACKENDS", "HomeMesh", "Homed", "Homing", "Locale",
           "LocalisationPolicy", "chunk_bounds", "collective_census",
           "exchange_network", "exchange_schedule", "merge_sorted"]
