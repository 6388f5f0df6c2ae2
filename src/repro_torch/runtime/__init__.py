"""Serving: the KV page pool, the home-aware scheduler and the decode server.

The counterpart of `repro.runtime` for serving; the trainer comes with the
training slice.
"""
from repro_torch.runtime.scheduler import (Scheduler, kv_bytes_per_token,
                                           make_scheduler)

__all__ = ["Scheduler", "kv_bytes_per_token", "make_scheduler"]
