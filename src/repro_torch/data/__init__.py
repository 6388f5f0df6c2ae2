"""The synthetic LM data pipeline: the counterpart of `repro.data`."""
from repro_torch.data.pipeline import SyntheticLM, make_batch_iterator

__all__ = ["SyntheticLM", "make_batch_iterator"]
