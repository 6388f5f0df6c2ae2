"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

A copy of `repro/configs/mamba2_2_7b.py`: the port imports nothing of the
JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # attention-free, no separate FFN (SSD blocks only)
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,            # d_inner = 5120 -> 80 SSD heads
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=1,
    subquadratic=True,         # O(1)-state decode, chunked linear-time prefill
    parallel=ParallelConfig(fsdp=False, microbatches=1),
))
