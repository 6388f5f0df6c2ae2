"""Configurations of the port: copies, never imports, of `repro.configs`."""
from repro_torch.configs.paper_sort import CASES, SortConfig

__all__ = ["CASES", "SortConfig"]
