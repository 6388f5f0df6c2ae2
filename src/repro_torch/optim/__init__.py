"""Optimiser, schedule and gradient compression: the counterpart of
`repro.optim` (`compressed_psum` runs over the ranks of a `RankMesh`)."""
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import (compress_tree, compressed_psum,
                                           decompress_tree, dequantize,
                                           error_feedback_update, quantize)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamW", "cosine_schedule", "compress_tree", "compressed_psum",
           "decompress_tree", "dequantize", "error_feedback_update",
           "quantize"]
