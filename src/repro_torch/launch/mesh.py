"""Rank meshes: the counterpart of `repro/launch/mesh.py`.

The reference builds a `jax.sharding.Mesh` over devices; the port builds
a `core.mesh.RankMesh` over the ranks of the ``torch.distributed`` world,
one rank a home.  Rank order is *static* -- the paper's static
thread->core mapping: chunk i of the data always lives on rank i.

* `make_rank_mesh` is `make_host_mesh`: ``("pod",) + ("data", "model")``
  over the world, with the same checks and messages (device counts read
  as rank counts).
* `make_production_mesh` builds ``(16, 16)`` or ``(2, 16, 16)`` and needs
  a world of 256 or 512 ranks.
* `spawn` starts a world of processes on this host (``torch.multiprocessing``
  with the spawn method, a `FileStore` in a temporary directory): the
  counterpart of ``--xla_force_host_platform_device_count``, which the
  tests and ``chip_smoke.py`` use.  `init_from_env` joins a world that
  ``torchrun`` started.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.mesh import RankMesh


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world: call spawn or "
                           "init_from_env first")
    return dist.get_world_size()


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axes: ``{"data": 16, "model": 16}``, or with
    a leading ``"pod": 2`` (the reference's `make_production_mesh`)."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> RankMesh:
    """``{"data": 16, "model": 16}``, or with a leading ``"pod": 2``; the
    world must have exactly its 256 (512) ranks."""
    prod = production_shape(multi_pod)
    shape, axes = tuple(prod.values()), tuple(prod)
    n = _world()
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {math.prod(shape)} ranks, the world has {n}")
    return RankMesh(dict(zip(axes, shape)), device=device)


def make_rank_mesh(n_data: Optional[int] = None, n_model: int = 1,
                   n_pods: Optional[int] = None, device="cuda") -> RankMesh:
    """A mesh over the whole world (tests, ``launch.sort``).

    With ``n_pods`` the mesh gains a leading ``pod`` axis.  The shape is
    checked up front, as `make_host_mesh` checks it: every requested
    factor must divide the world size and the full shape must use exactly
    the world's ranks.
    """
    n = _world()
    outer = (n_pods,) if n_pods is not None else ()
    for name, size in (("n_pods", n_pods), ("n_model", n_model),
                       ("n_data", n_data)):
        if size is not None and (not isinstance(size, int) or size < 1):
            raise ValueError(f"{name}={size!r} must be a positive int")
    fixed = n_model * (n_pods or 1)
    if n % fixed != 0:
        raise ValueError(
            f"cannot mesh {n} rank(s): n_model={n_model}"
            + (f" x n_pods={n_pods}" if n_pods is not None else "")
            + f" = {fixed} does not divide the world size {n}")
    n_data = n_data or (n // fixed)
    shape = outer + (n_data, n_model)
    axes = (("pod",) if n_pods is not None else ()) + ("data", "model")
    want = math.prod(shape)
    if want != n:
        raise ValueError(
            f"requested mesh shape {dict(zip(axes, shape))} needs {want} "
            f"rank(s) but the world has {n} — the shape must use exactly "
            f"the available ranks")
    return RankMesh(dict(zip(axes, shape)), device=device)


def _child(rank: int, fn: Callable, world: int, backend: str, device: str,
           store: str, out: str, timeout_s: float, args: tuple) -> None:
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(device, *args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        # no rank leaves while another still talks to it: a gloo peer
        # that exits closes its sockets under a rank still connecting a
        # subgroup or finishing a collective
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, device, *args,
          timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` on every rank of a new world of `world`
    processes on this host; returns the ranks' results in rank order.

    `fn` must be importable by name (a module-level function) and its
    result picklable.  `device` is what each rank's `RankMesh` is built on
    (``"cuda"`` or ``"cpu"``).  Each process joins the `backend` process
    group (``"gloo"`` or ``"nccl"``, as given: nothing is chosen for the
    caller)
    through a `FileStore` in a temporary directory; a collective waits at
    most `timeout_s`.  If any rank raises, the others are stopped and the
    error is raised here.
    """
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _child, args=(fn, world, backend, str(device),
                          os.path.join(tmp, "store"), tmp, timeout_s, args),
            nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def init_from_env(backend: str) -> int:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) on `backend` (``"nccl"`` or
    ``"gloo"``).  Returns the world size."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()
