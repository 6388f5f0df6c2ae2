"""mixtral-8x7b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]

A copy of `repro/configs/mixtral_8x7b.py`: the port imports nothing of the
JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1e6,
    subquadratic=True,  # sliding-window attention -> ring-buffer KV
    # 8 experts do not divide the 16-way model axis -> experts replicated over
    # TP, FFN dim TP-sharded, and FSDP over dp axes carries the memory.
    parallel=ParallelConfig(fsdp=True, microbatches=8),
))
