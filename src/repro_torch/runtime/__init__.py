"""Serving and training: the KV page pool, the home-aware scheduler, the
decode server (`server`), the fault-tolerant trainer (`trainer`) and its
`ft.Supervisor`.  The counterpart of `repro.runtime`.
"""
from repro_torch.runtime.scheduler import (Scheduler, kv_bytes_per_token,
                                           make_scheduler)

__all__ = ["Scheduler", "kv_bytes_per_token", "make_scheduler"]
