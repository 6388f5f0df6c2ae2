"""The explicit sort engine across ranks, from the command line.

    PYTHONPATH=src python -m repro_torch.launch.sort --ranks 8 \
        [--pods PxD] [--backend gloo|nccl] [--device cpu|cuda] [--n N] \
        [--seed S] [--local-phase kernel|reference]

The counterpart of `examples/distributed_sort.py` for the engine: spawns a
world of ``--ranks`` processes (`launch.mesh.spawn`), one rank a home, on
``{"data": R}`` (or ``{"pod": P, "data": D}`` with ``--pods``), and sorts
the 8 Table-1 cases (and, with ``--pods``, the hierarchical hash policy)
through ``Locale(mesh, axis, policy).workload("sort", backend=
"shard_map")``, on n seeded int32 values.  Per case it prints the check of
the gathered result against ``torch.sort``, each rank's wire bytes held to
`exchange_schedule`'s share (its bytes ÷ m, op for op) and to
`collective_census`, and the findings of rules R1/R2 on each rank's
collectives (`rank_report`).  Exit 0 when every case sorts, every rank's
bytes equal the schedule's and R1/R2 find nothing; 1 otherwise.

``--device cuda`` puts every rank on the card ``cuda:{rank % cards}``:
with NCCL, one rank a card (run so on four H100s, flat and ``--pods
2x2``; no larger world has run); with gloo, the ranks may share a card
and every exchange is staged through pinned host memory (counted apart
as staged bytes), since gloo has no device transport.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Optional

import torch


def policies(pods: bool) -> Dict[str, object]:
    """The Table-1 cases by name, and the hierarchical policy on pods."""
    from repro_torch.configs import CASES
    from repro_torch.core import Homing, LocalisationPolicy
    out = {f"case{k}": LocalisationPolicy(c.localised, c.static_mapping,
                                          Homing(c.homing))
           for k, c in CASES.items()}
    if pods:
        out["hier"] = LocalisationPolicy.hierarchical(inner="hash")
    return out


def rank_report(log: List[Dict], mesh, axes, n: int, policy,
                itemsize: int = 4, local_phase: Optional[str] = None
                ) -> Dict:
    """One rank's collective log of one sort of `n` elements on `axes`:
    ``schedule``, where it differs from `exchange_schedule` (op for op,
    the record's bytes ÷ m exactly); ``census``, whether it folds to
    `collective_census`; ``findings`` and ``notes`` of rules R1/R2 on it
    (`analysis.check_artifacts`)."""
    from repro_torch.analysis import check_artifacts
    from repro_torch.core import collective_census, exchange_schedule
    from repro_torch.core import collectives as coll
    sizes = tuple(mesh.shape[a] for a in axes)
    budget = collective_census(n, sizes, policy, itemsize=itemsize,
                               local_phase=local_phase)
    rep = check_artifacts("ranks", [], collectives=log, predicted=budget,
                          mesh=mesh, allowed_axes=tuple(axes),
                          rules=("R1", "R2"))
    return {"schedule": coll.log_against_schedule(
                log, exchange_schedule(n, sizes, policy, itemsize=itemsize,
                                       local_phase=local_phase),
                math.prod(sizes)),
            "census": coll.census(log) == budget,
            "findings": [f.format() for f in rep.findings],
            "notes": rep.notes}


def rank_main(device: str, shape: dict, n: int, seed: int,
              local_phase: str) -> List[Dict]:
    """One rank: every case sorted, checked, and its collectives held to
    the schedule, the census and R1/R2; returns a row per case."""
    from repro_torch.convert import make_sort_data
    from repro_torch.core import Locale
    from repro_torch.core import collectives as coll
    from repro_torch.core.engine import gather_sorted
    from repro_torch.core.mesh import RankMesh

    mesh = RankMesh(shape, device=device)
    axes = tuple(shape)
    axis = axes if len(axes) > 1 else axes[0]
    x = torch.from_numpy(make_sort_data(n, "int32", seed))
    expect = torch.sort(x).values
    rows = []
    for tag, policy in policies("pod" in shape).items():
        fn = Locale(mesh, axis, policy).workload(
            "sort", backend="shard_map", local_phase=local_phase)
        shard = fn.place(x)
        coll.reset_collectives()
        y = fn(shard)
        log = coll.collective_log()
        staged = coll.staged_bytes()
        full = gather_sorted(y, mesh, n).cpu()
        rows.append({"case": tag, "sorted": bool(torch.equal(full, expect)),
                     "wire": [r["wire_bytes"] for r in log],
                     "kinds": [r["kind"] for r in log], "staged": staged,
                     **rank_report(log, mesh, axes, n, policy,
                                   local_phase=local_phase)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--pods", help="PxD: the mesh {'pod': P, 'data': D}")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--n", type=int, default=(1 << 16) + 5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--local-phase", choices=("kernel", "reference"),
                    default="kernel")
    args = ap.parse_args(argv)
    if args.pods:
        p, d = (int(v) for v in args.pods.lower().split("x"))
        shape = {"pod": p, "data": d}
    else:
        shape = {"data": args.ranks}
    if args.device == "cuda":
        from repro_torch.core.mesh import resolve_device
        resolve_device("cuda")                       # raises without a card
        from repro_torch.kernels import _build
        _build.build(("local_sort", "merge_split"))  # once, before the ranks
    from repro_torch.launch.mesh import spawn
    results = spawn(rank_main, args.ranks, args.backend, args.device, shape,
                    args.n, args.seed, args.local_phase)
    ok = True
    print(f"{args.ranks} rank(s) on {shape}, {args.backend} on "
          f"{args.device}, n={args.n} int32, local_phase={args.local_phase}")
    for i, row in enumerate(results[0]):
        ranks = [r[i] for r in results]
        good = all(r["sorted"] and not r["schedule"] and r["census"]
                   and not r["findings"] for r in ranks)
        ok &= good
        wires = [sum(r["wire"]) for r in ranks]
        print(f"{row['case']:>6}: {'ok ' if good else 'BAD'} sorted="
              f"{all(r['sorted'] for r in ranks)} collectives="
              f"{','.join(row['kinds']) or '-'}; wire bytes by rank {wires} "
              f"(each == exchange_schedule / m op for op: "
              f"{not any(r['schedule'] for r in ranks)}; census: "
              f"{all(r['census'] for r in ranks)}); R1/R2 findings "
              f"{sum(len(r['findings']) for r in ranks)}; staged bytes by "
              f"rank {[r['staged'] for r in ranks]}")
        for r, rk in enumerate(ranks):
            for m in rk["schedule"] + rk["findings"]:
                print(f"        rank {r}: {m}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
