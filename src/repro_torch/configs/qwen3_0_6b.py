"""qwen3-0.6b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]

A copy of `repro/configs/qwen3_0_6b.py`: the port imports nothing of the JAX
package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,              # decoupled head_dim (16*128 != d_model), as in HF
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    parallel=ParallelConfig(fsdp=False, microbatches=1),
))
