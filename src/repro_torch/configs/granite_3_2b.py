"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]

A copy of `repro/configs/granite_3_2b.py`: the port imports nothing of the
JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,               # 2048 / 32
    d_ff=8192,
    vocab_size=49155,          # not 256-aligned -> padded internally to 49408
    parallel=ParallelConfig(fsdp=False, microbatches=1),
))
