"""llama-3.2-vision-90b [vlm] — cross-attn image layers; vision tower is a
STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

100 layers total = 80 self-attention + 20 cross-attention (1 per 5).

A copy of `repro/configs/llama_3_2_vision_90b.py`: the port imports nothing
of the JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn_every=5,
    num_image_tokens=4096,     # precomputed patch embeddings (stub frontend)
    parallel=ParallelConfig(fsdp=True, microbatches=16),
))
