"""homecheck CLI of the port: run workloads on a device and check them.

    PYTHONPATH=src python -m repro_torch.launch.homecheck \
        --workload sort|engine|microbench|serve|all \
        [--pods PxD[xM]] \
        [--policy flat|hash|nonloc|nonloc-hash|hier|hier-hash|all] \
        [--backend shard_map|constraint] [--logn N] [--num-workers W] \
        [--reps R] [--arch NAME] [--rules all|R3 R5 R6 ...|r9,r10,r11] \
        [--hbm-ceiling BYTES] [--suppress R4 ...] [--device cuda|cpu] \
        [--json] [--verbose]

The counterpart of `repro/launch/homecheck.py`.  Runs the selected
workload(s) once on `--device` (default the card; ``--device cpu`` runs
the kernels' plain versions and records the launches the card would
make) over a `HomeMesh` of homes on that one device -- ``serve`` one
decode step of `--arch`'s reduced server (`check_decode`) -- records
every kernel launch, buffer and collective, and runs rules R1-R11 on them
(`repro_torch.analysis`).  R1, R2 and R11 read the collectives of a
`RankMesh`'s ranks: `Locale.check` or `check_decode` called in every rank
of a world, or ``python -m repro_torch.launch.sort``, which runs R1/R2 on
every rank's collectives of every case (`launch.sort.rank_report`).  On
this one-process mesh R1 and R2 are noted as skipped and R11 notes that
no collective ran.  ``--pods PxD[xM]`` is the mesh's shape, ``{"pod": P,
"data": D, "model": M}`` (M = 1 when left out), the sorts homed over
``("pod", "data")`` (``"data"`` for P = 1); it sets no environment
variable.  Without it the locale has no mesh: one home, as the reference
on a one-device host.  ``--hbm-ceiling`` overrides R10's
`kernels.HBM_BYTES_PER_DEVICE`.  When R6 is active the run also prints
the repo-wide certificate: every supported policy 0-1-certified over
every mesh shape up to 16 homes.  When R9 is active it prints the
scheduler certificate: invariants I1-I8 proved by exhaustive
interleaving search over the full small-config lattice (the decode
target's own report runs the fast corner).  Exit status 1 on any ERROR
finding, 2 on a driver failure.
"""
from __future__ import annotations

import argparse
import sys
import traceback


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
    from repro_torch.analysis import check_decode, check_workload
    from repro_torch.core.api import Locale
    from repro_torch.core.mesh import HomeMesh

    if args.pods is not None:
        p, d, m = args.pods
        mesh = HomeMesh({"pod": p, "data": d, "model": m},
                        device=args.device)
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

    names = (("sort", "microbench", "serve") if args.workload == "all"
             else (args.workload,))
    reports = []
    for name in names:
        if name == "serve":
            reports.append(check_decode(
                mesh, cfg_name=args.arch, device=device,
                hbm_ceiling=args.hbm_ceiling, rules=rules,
                suppress=args.suppress))
            continue
        for pname in pol_names(name):
            locale = Locale(mesh=mesh, axis=sort_axis,
                            policy=make_policy(pname, n_pods))
            reports.append(check_workload(
                locale, name, backend=args.backend,
                num_workers=args.num_workers, logn=args.logn, reps=args.reps,
                device=device, hbm_ceiling=args.hbm_ceiling, rules=rules,
                suppress=args.suppress))
    return reports


def main(argv=None) -> int:
    from repro_torch.launch.serve import parse_pods
    ap = argparse.ArgumentParser(
        description="kernel-launch analyser of the port (homecheck)")
    ap.add_argument("--workload", default="sort",
                    choices=("sort", "engine", "microbench", "serve", "all"))
    ap.add_argument("--pods", type=parse_pods, default=None,
                    metavar="PxD[xM]",
                    help="the HomeMesh shape on the device: P pods of D "
                         "homes, M model ranks each")
    ap.add_argument("--policy", choices=POLICIES, default="auto",
                    help="localisation policy (auto = hier on a pod mesh; "
                         "all = every policy the mesh supports)")
    ap.add_argument("--backend", choices=("shard_map", "constraint"),
                    default="shard_map", help="sort backend")
    ap.add_argument("--logn", type=int, default=12,
                    help="~log2 of the representative input length")
    ap.add_argument("--num-workers", type=int, default=None)
    ap.add_argument("--reps", type=int, default=4, help="microbench passes")
    ap.add_argument("--arch", default="qwen3-0.6b", help="serve config")
    ap.add_argument("--rules", nargs="*", default=None, metavar="RULE",
                    help="rules to run (R1..R11 or 'all'; default all); "
                         "with R6/R9 active the repo-wide mesh and "
                         "scheduler certificates are printed too")
    ap.add_argument("--hbm-ceiling", type=int, default=None,
                    help="R10 per-device memory ceiling in bytes (default "
                         "repro_torch.kernels.HBM_BYTES_PER_DEVICE)")
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
    if "R9" in rules:
        from repro_torch.analysis import DEFAULT_LATTICE, certify_lattice
        cert = certify_lattice(DEFAULT_LATTICE)
        bad = {n: rec for n, rec in cert.items()
               if rec["witness"] is not None}
        total_states = sum(rec["states"] for rec in cert.values())
        if bad:
            cert_errors += len(bad)
            for n, rec in bad.items():
                print(f"R9 certificate FAILED [{n}]: "
                      f"{rec['witness'].format()}")
        else:
            configs = ", ".join(f"{n}({rec['states']})"
                                for n, rec in cert.items())
            print(f"R9 certificate [scheduler]: I1-I8 hold over "
                  f"{len(cert)} lattice config(s), {total_states} "
                  f"canonical states explored exhaustively ({configs})")
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
