"""The paper's merge-sort experiment across all Table-1 cases, on both
execution backends of the PyTorch/CUDA port, 8 homes of one card:

  * ``constraint`` -- the merge tree relaid out between levels as the
    policy says (the reference's `with_sharding_constraint` tree);
  * ``shard_map``  -- the explicit engine: per-home ownership, the
    `local_sort` kernel as the local phase and `merge_split` kernels in
    the exchanges of each `LocalisationPolicy`.

Every case is one `Locale` (same mesh + axis, different policy) and the
sort comes from ``locale.workload("sort", backend=...)``.

Run:  PYTHONPATH=src python examples/torch_distributed_sort.py [--device cpu]

The counterpart of `examples/distributed_sort.py`, with the same cases,
sizes, asserts and printed lines; on the card it also prints each
kernel wrapper's launch count.  It runs on the card by default;
``--device cpu`` runs the kernels' plain versions.  With no card and no
``--device cpu`` it raises.
"""
import time

import numpy as np
import torch

from repro_torch.configs.paper_sort import CASES
from repro_torch.core import (BACKENDS, HomeMesh, Homing, Locale,
                              LocalisationPolicy)
from repro_torch.kernels import ops

from torch_quickstart import device_of

HOMES = 8


def ints(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1 << 30, shape, dtype=np.int32))


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    dev = device_of(argv)
    mode = "cuda kernels" if dev == "cuda" else "plain versions"
    ops.reset_launches()
    locale = Locale.auto(homes=HOMES, device=dev)
    n = 1 << 18
    for backend in BACKENDS:
        for num, c in sorted(CASES.items()):
            pol = LocalisationPolicy(localised=c.localised,
                                     static_mapping=c.static_mapping,
                                     homing=Homing(c.homing))
            fn = locale.with_policy(pol).workload(
                "sort", backend=backend, num_workers=HOMES)
            x = ints(0, n)
            sync(dev)
            t0 = time.perf_counter()
            y = fn(x)
            sync(dev)
            dt = time.perf_counter() - t0
            assert bool((y[1:] >= y[:-1]).all())
            print(f"{backend:10s} case {num} ({pol.name:22s}): "
                  f"{dt*1e3:8.1f} ms  sorted=True")

    # the engine end to end with its real local phase: ONE `local_sort`
    # launch sorts every home's chunk (leaf sorts and the whole local
    # merge tree in shared memory) and the merge-path `merge_split`s
    # compute only the kept half (local_phase="kernel", the default)
    fn = locale.workload("engine", local_phase="kernel")
    y = fn(ints(1, 1 << 12))
    assert bool((y[1:] >= y[:-1]).all())
    print(f"shard_map engine + fused kernel local phase: ok ({mode})")

    # two distance classes: an emulated (pod, data) mesh, the deep
    # merge-split levels confined to intra-pod exchanges and ONE
    # all-gather over the pod axis per top level
    mesh = HomeMesh({"pod": 2, "data": HOMES // 2}, device=dev)
    hier = Locale(mesh=mesh, axis=("pod", "data"),
                  policy=LocalisationPolicy.hierarchical())
    y = hier.workload("sort", backend="shard_map")(ints(2, 1 << 14))
    assert bool((y[1:] >= y[:-1]).all())
    print(f"hierarchical engine on 2x{HOMES // 2} emulated pods: ok")

    # the kernels standalone: the leaf-only bitonic sort, the fused local
    # phase (rows that are not a power of two pad in shared memory, never
    # in device memory) and the kept-half-only merge split
    ys = ops.bitonic_sort(ints(1, (8, 512)).to(dev))
    assert bool((ys[:, 1:] >= ys[:, :-1]).all())
    zs = ops.local_sort(ints(3, (4, 384)).to(dev))
    assert bool((zs[:, 1:] >= zs[:, :-1]).all())
    lo = ops.merge_split(ys[:4], ys[4:], True)
    assert bool((lo[:, 1:] >= lo[:, :-1]).all())
    print(f"kernels (bitonic / fused local_sort / merge_split): ok ({mode})")
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    if dev == "cuda":
        print("launches: " + " ".join(f"{k}={v}" for k, v in
                                      sorted(counts.items())))
    return counts


if __name__ == "__main__":
    main()
