"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2306.05284; hf]

24 heads do not divide the 16-way model axis -> attention runs
head-replicated; TP applies to the FFN + vocab head (see DESIGN.md §4).

A copy of `repro/configs/musicgen_medium.py`: the port imports nothing of
the JAX package, and `tests/test_torch_models.py` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, ParallelConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,           # EnCodec codebook
    embed_input=False,         # frontend stub: inputs are frame embeddings
    parallel=ParallelConfig(fsdp=False, microbatches=2),
))
