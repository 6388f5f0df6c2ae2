"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Superblock of 8 layers: 1 attention + 7 mamba; MoE FFN on every other layer
(36 MoE layers of 16 experts -> ~398B total params, ~94B active).

A copy of `repro/configs/jamba_1_5_large_398b.py`: the port imports nothing
of the JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,            # divides the 16-way model axis: true EP
    top_k=2,
    moe_every=2,
    attn_every=8,              # 1:7 attention:mamba interleave
    ssm_state=128,
    ssm_headdim=128,           # d_inner = 16384 -> 128 SSD heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=8,
    subquadratic=True,         # hybrid: SSM layers linear; few attn layers CP-sharded
    parallel=ParallelConfig(fsdp=True, microbatches=4, zero1=True),
))
