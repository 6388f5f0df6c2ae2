"""glm4-9b [dense] — RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]

A copy of `repro/configs/glm4_9b.py`: the port imports nothing of the JAX
package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    parallel=ParallelConfig(fsdp=False, microbatches=8),
))
