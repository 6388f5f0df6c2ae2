"""homecheck CLI of the port: check workloads' kernel launches on a device.

    PYTHONPATH=src python -m repro_torch.launch.homecheck \
        --workload sort|engine|microbench|all \
        [--pods PxD] \
        [--policy flat|hash|nonloc|nonloc-hash|hier|hier-hash|all] \
        [--backend shard_map|constraint] [--logn N] [--num-workers W] \
        [--reps R] [--rules all|R3 R5 R6 ...] [--suppress R7 ...] \
        [--device cuda|cpu] [--json] [--verbose]

The counterpart of `repro/launch/homecheck.py`.  Runs the selected
workload(s) once on `--device` (default the card; ``--device cpu`` runs
the kernels' plain versions and records the launches the card would
make) over a `HomeMesh` of homes on that one device, records every kernel
launch, and runs rules R3/R5/R6/R7/R8 on them (`repro_torch.analysis`);
R1 and R2 read the collectives of a `RankMesh`'s ranks: `Locale.check`
called in every rank of a world, or ``python -m repro_torch.launch.sort``,
which runs them on every rank's collectives of every case
(`launch.sort.rank_report`).  On this one-process mesh they are noted as
skipped, as R4, R9, R10 and R11 are.  ``--pods PxD`` is the mesh's shape, ``{"pod": P, "data": D}``
(``{"data": D}`` for P = 1); it sets no environment variable.  Without it
the locale has no mesh: one home, as the reference on a one-device host.
When R6 is active the run also prints the repo-wide certificate: every
supported policy 0-1-certified over every mesh shape up to 16 homes.
Exit status 1 on any ERROR finding, 2 on a driver failure.
"""
from __future__ import annotations

import argparse
import sys
import traceback


def parse_pods(spec: str):
    """``PxD`` -> (n_pods, n_data)."""
    try:
        parts = [int(p) for p in spec.lower().split("x")]
    except ValueError:
        parts = []
    if len(parts) != 2 or any(p < 1 for p in parts):
        raise argparse.ArgumentTypeError(
            f"--pods wants PxD with positive ints, got {spec!r} (the port's "
            f"HomeMesh has no model axis yet)")
    return tuple(parts)


POLICIES = ("auto", "flat", "hash", "nonloc", "nonloc-hash",
            "hier", "hier-hash", "all")


def make_policy(name: str, n_pods: int):
    """Resolve a --policy name to a LocalisationPolicy."""
    from repro_torch.core.homing import Homing
    from repro_torch.core.localisation import LocalisationPolicy
    if name == "auto":
        name = "hier" if n_pods > 1 else "flat"
    return {
        "flat": LocalisationPolicy(),
        "hash": LocalisationPolicy(homing=Homing.HASH_INTERLEAVED),
        "nonloc": LocalisationPolicy(localised=False),
        "nonloc-hash": LocalisationPolicy(
            localised=False, homing=Homing.HASH_INTERLEAVED),
        "hier": LocalisationPolicy.hierarchical(),
        "hier-hash": LocalisationPolicy.hierarchical(inner="hash"),
    }[name]


def _reports(args, rules):
    from repro_torch.analysis import check_workload
    from repro_torch.core.api import Locale
    from repro_torch.core.mesh import HomeMesh

    if args.pods is not None:
        p, d = args.pods
        shape = {"pod": p, "data": d} if p > 1 else {"data": d}
        mesh = HomeMesh(shape, device=args.device)
        sort_axis = ("pod", "data") if p > 1 else "data"
        n_pods = p
        device = None
    else:
        mesh, sort_axis, n_pods, device = None, "data", 1, args.device

    def pol_names(workload: str):
        """--policy all: every policy the mesh supports for this workload."""
        if args.policy != "all":
            return (args.policy,)
        if workload == "microbench":            # Fig-1 bench: loc vs nonloc
            return ("flat", "nonloc")
        return (("hier", "hier-hash") if n_pods > 1
                else ("flat", "hash", "nonloc", "nonloc-hash"))

    names = (("sort", "microbench") if args.workload == "all"
             else (args.workload,))
    reports = []
    for name in names:
        for pname in pol_names(name):
            locale = Locale(mesh=mesh, axis=sort_axis,
                            policy=make_policy(pname, n_pods))
            reports.append(check_workload(
                locale, name, backend=args.backend,
                num_workers=args.num_workers, logn=args.logn, reps=args.reps,
                device=device, rules=rules, suppress=args.suppress))
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="kernel-launch analyser of the port (homecheck)")
    ap.add_argument("--workload", default="sort",
                    choices=("sort", "engine", "microbench", "all"))
    ap.add_argument("--pods", type=parse_pods, default=None, metavar="PxD",
                    help="the HomeMesh shape on the device: P pods of D homes")
    ap.add_argument("--policy", choices=POLICIES, default="auto",
                    help="localisation policy (auto = hier on a pod mesh; "
                         "all = every policy the mesh supports)")
    ap.add_argument("--backend", choices=("shard_map", "constraint"),
                    default="shard_map", help="sort backend")
    ap.add_argument("--logn", type=int, default=12,
                    help="~log2 of the representative input length")
    ap.add_argument("--num-workers", type=int, default=None)
    ap.add_argument("--reps", type=int, default=4, help="microbench passes")
    ap.add_argument("--rules", nargs="*", default=None, metavar="RULE",
                    help="rules to run (R1..R11 or 'all'; default all); with "
                         "R6 active the repo-wide mesh certificate is "
                         "printed too")
    ap.add_argument("--suppress", nargs="*", default=(), metavar="RULE",
                    help="rule ids to drop from the report")
    ap.add_argument("--device", default="cuda",
                    help="where the workloads run (default cuda; cpu runs "
                         "the plain versions)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.analysis import (certify_supported_meshes,
                                      normalize_rules, summarize)
    try:
        rules = normalize_rules(args.rules)
    except ValueError as e:
        ap.error(str(e))
    try:
        reports = _reports(args, rules)
    except Exception:           # the driver failed, not a rule: exit 2
        traceback.print_exc()
        print("homecheck: driver failure", file=sys.stderr)
        return 2

    for rep in reports:
        print(rep.to_json() if args.as_json
              else rep.format(verbose=args.verbose))

    cert_errors = 0
    if "R6" in rules:
        cert = certify_supported_meshes()
        for pname, rec in sorted(cert.items()):
            meshes = ", ".join("x".join(map(str, s))
                               for s in rec["certified"])
            line = (f"R6 certificate [{pname}]: "
                    f"{len(rec['certified'])} mesh(es) 0-1 certified"
                    f" ({meshes})")
            if rec["failed"]:
                cert_errors += len(rec["failed"])
                line += f"; FAILED: {rec['failed']}"
            print(line)

    _, errors = summarize(reports)
    errors += cert_errors
    total = sum(len(r.findings) for r in reports)
    print(f"homecheck: {len(reports)} target(s), {total} finding(s), "
          f"{errors} error(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
