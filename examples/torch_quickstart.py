"""Quickstart of the PyTorch/CUDA port: the paper's technique through the
`Locale` API, on 8 homes of one card.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of `examples/quickstart.py`, with the same cases, sizes,
asserts and printed lines.  It runs on the card by default (the port's
CUDA kernels); ``--device cpu`` runs their plain versions.  With no card
and no ``--device cpu`` it raises.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Homing, Locale, LocalisationPolicy


def device_of(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the plain versions on the CPU")
    dev = ap.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run on the "
                           "card; pass --device cpu for their plain versions")
    return dev


def main(argv=None):
    dev = device_of(argv)
    # One object carries the whole placement decision: (mesh, axis, policy).
    locale = Locale.auto(homes=8, device=dev)                 # 8 homes

    # --- the paper's Table-1 extremes ---
    localised = locale.with_policy(LocalisationPolicy(
        localised=True, static_mapping=True,
        homing=Homing.LOCAL_CHUNKED))                         # Case 8
    conventional = locale.with_policy(LocalisationPolicy(
        localised=False, static_mapping=True,
        homing=Homing.HASH_INTERLEAVED))                      # Case 3

    x = np.random.default_rng(0).integers(0, 1 << 30, 1 << 18,
                                          dtype=np.int32)
    for name, loc in [("localised(case8)", localised),
                      ("conventional(case3)", conventional)]:
        sort = loc.workload("sort")      # the input may be consumed (step 5)
        y = sort(torch.from_numpy(x.copy()))
        ok = bool((y[1:] >= y[:-1]).all())
        assert ok
        print(f"sort {name:22s} sorted={ok}")

    # --- placement primitives: data carries its homing ---
    homed = conventional.put(torch.arange(1 << 16, dtype=torch.float32))
    print(f"homed: shape={tuple(homed.logical().shape)} "
          f"homing={homed.homing.value} "
          f"logical[:3]={homed.logical()[:3].tolist()}")
    pinned = conventional.pin(homed)          # already in its policy's layout
    local = conventional.localise(homed)      # Algorithm 2's one-shot relayout
    assert torch.equal(pinned.logical(), homed.logical())
    assert torch.equal(local.logical(), homed.logical())
    print(f"pinned: homing={pinned.homing.value}  "
          f"localised: homing={local.homing.value}")

    # --- Fig-1 micro-benchmark semantics ---
    for name, loc in [("localised", localised), ("hash-for-home", conventional)]:
        bench = loc.workload("microbench", reps=16)
        out = bench(torch.linspace(0, 1, 1 << 16))
        print(f"microbench {name:14s} checksum={float(out.sum()):.2f}")
    print("ok")


if __name__ == "__main__":
    main()
