"""Optimiser, schedule and gradient compression: the counterpart of
`repro.optim`, without ``compressed_psum`` (it needs collectives across
ranks: ROADMAP.md Queue 1)."""
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import (compress_tree, decompress_tree,
                                           dequantize, error_feedback_update,
                                           quantize)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamW", "cosine_schedule", "compress_tree", "decompress_tree",
           "dequantize", "error_feedback_update", "quantize"]
