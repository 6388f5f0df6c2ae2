"""granite-20b [dense] — llama-arch, code, MQA (kv=1). [arXiv:2405.04324; hf]

A copy of `repro/configs/granite_20b.py`: the port imports nothing of the
JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    parallel=ParallelConfig(fsdp=True, microbatches=4),
))
