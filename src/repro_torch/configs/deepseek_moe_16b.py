"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066; hf]

A copy of `repro/configs/deepseek_moe_16b.py`: the port imports nothing of
the JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # fine-grained expert width
    vocab_size=102400,
    num_experts=64,            # divides the 16-way model axis: true EP
    num_shared_experts=2,
    top_k=6,
    parallel=ParallelConfig(fsdp=False, microbatches=4),
))
