"""Configurations of the port: copies, never imports, of `repro.configs`.

Importing this package registers every architecture config, as the
reference's does; `paper_sort` is the sort workload's.
"""
from repro_torch.configs.base import (ArchConfig, ParallelConfig, ShapeSpec,
                                      SHAPES, get_config, list_configs,
                                      reduce_config, register)
from repro_torch.configs import (  # noqa: F401
    mixtral_8x7b,
    deepseek_moe_16b,
    qwen3_0_6b,
    glm4_9b,
    granite_20b,
    granite_3_2b,
    musicgen_medium,
    mamba2_2_7b,
    jamba_1_5_large_398b,
    llama_3_2_vision_90b,
)
from repro_torch.configs.paper_sort import CASES, SortConfig

ARCH_NAMES = [
    "mixtral-8x7b", "deepseek-moe-16b", "qwen3-0.6b", "glm4-9b",
    "granite-20b", "granite-3-2b", "musicgen-medium", "mamba2-2.7b",
    "jamba-1.5-large-398b", "llama-3.2-vision-90b",
]

__all__ = ["ArchConfig", "ParallelConfig", "ShapeSpec", "SHAPES", "get_config",
           "list_configs", "reduce_config", "register", "ARCH_NAMES", "CASES",
           "SortConfig"]
