#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py [--seed S] [--out results.json]

Run from the root of a checkout, on a machine with one CUDA card (an H100
is the target: the kernels are built for sm_90a).  Phases, one line each:

  1. device   — the card's name and `nvidia-smi` name and power limit;
  2. build    — every kernel of ``src/repro_torch/csrc`` built with nvcc;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bit for bit (floats as int32 bits), on the property grid and
                at the main path's shapes, with their times;
  4. engine   — the 8 Table-1 cases through
                ``Locale(...).workload("sort", backend="shard_map")`` on 8
                homes, checked against torch.sort, and held bit for bit
                against the same call on the CPU at a smaller n;
  5. flagship — the main path at the paper's size, n = 100,000,000 int32:
                case 8 on {"data": 8} (the launch counts below are this
                run's) and the hierarchical hash policy on {"pod": 2,
                "data": 4}, with launches, merged elements against
                `exchange_schedule`, times and peak memory.

Then one JSON line of kernels, the `nvidia-smi` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that.
Without a card, or without the repo's ``src/repro_torch`` beside this
file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_FLAGSHIP = 100_000_000          # SortConfig.array_size (paper Fig 2)
N_ENGINE = 2**24 + 5
N_ENGINE_CPU = 2**20 + 5
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory
OPS_32BIT_PER_S = 67e12           # H100 SXM float32 outside the tensor cores


class SmokeFailure(Exception):
    pass


def need(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(line: str) -> None:
    print(line, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bits(t):
    return t.view(torch.int32)


def mismatches(a, b) -> int:
    return int((bits(a) != bits(b)).sum())


def max_abs_err(a, b) -> float:
    diff = bits(a) != bits(b)
    if not bool(diff.any()):
        return 0.0
    return float((a[diff].double() - b[diff].double()).abs().max())


def check_sorted(y, x, what: str) -> None:
    """int32 bit-exact against torch.sort; float32 equal under == (value
    multiset preserved) and bit-exact off the zeros, whose signs the
    merge-split network may trade at a block boundary, as the JAX engine
    does."""
    expect = torch.sort(x).values
    need(y.shape == expect.shape, f"{what}: shape {tuple(y.shape)}")
    if x.dtype == torch.int32:
        need(torch.equal(y, expect), f"{what}: not sorted")
    else:
        need(bool((y == expect).all()), f"{what}: not sorted")
        nz = expect != 0
        need(torch.equal(bits(y[nz]), bits(expect[nz])),
             f"{what}: non-zero bits differ")


def phase_kernels(seed: int) -> dict:
    from repro_torch.convert import GRID_NAMES, grid_rows, make_sort_data
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitonic_sort import bitonic_stages
    from repro_torch.kernels.local_sort import TILE, local_sort_reference
    from repro_torch.kernels.merge_split import merge_split_reference

    cuda = torch.device("cuda")
    grid_c = (1, 5, 96, 256, 257, TILE - 1, TILE, TILE + 1, 3 * TILE + 7)
    bad = {"local_sort": 0, "merge_split": 0, "bitonic_sort": 0}
    cases = 0
    for name in GRID_NAMES:
        for C in grid_c:
            x = torch.from_numpy(grid_rows(name, C, seed=seed)).to(cuda)
            bad["local_sort"] += mismatches(ops.local_sort(x),
                                            local_sort_reference(x))
            a = torch.from_numpy(np.sort(grid_rows(name, C, 4, seed), -1))
            b = torch.from_numpy(np.sort(grid_rows(name, C, 4, seed + 7), -1))
            a, b = a.to(cuda), b.to(cuda)
            for keep in (torch.tensor([True, False, False, True]), True, False):
                bad["merge_split"] += mismatches(
                    ops.merge_split(a, b, keep),
                    merge_split_reference(a, b, keep))
            cases += 1
    for C in (1, 256, TILE, 4 * TILE):
        x = torch.from_numpy(grid_rows("rand_float", C, seed=seed)).to(cuda)
        bad["bitonic_sort"] += mismatches(ops.bitonic_sort(x),
                                          bitonic_stages(x))
    torch.cuda.synchronize()

    # the main path's shapes: local_sort (8, 12.5M); merge_split (8, 12.5M)
    # on every flat substage and (16, 12.5M) in the hierarchical replay
    rows, C = 8, N_FLAGSHIP // 8
    x = torch.from_numpy(make_sort_data(N_FLAGSHIP, "int32", seed)).to(cuda)
    x = x.view(rows, C)
    got, plain = ops.local_sort(x), local_sort_reference(x)
    ls_err = max_abs_err(got, plain)
    bad["local_sort"] += mismatches(got, plain)
    del got, plain
    ls_ms = cuda_ms(lambda: ops.local_sort(x), reps=5)
    ls_plain_ms = cuda_ms(lambda: local_sort_reference(x), reps=1)
    ls_lib_ms = cuda_ms(lambda: torch.sort(x, dim=-1), reps=5)
    ls_bytes_ms = 2 * rows * C * 4 / HBM_BYTES_PER_S * 1e3
    # the comparisons a sort of each row needs, C log2 C, not the padded
    # bitonic network's (that is this kernel's choice of algorithm)
    ls_ops_ms = rows * C * math.log2(C) / OPS_32BIT_PER_S * 1e3

    ms = {}
    ms_err = 0.0
    y = torch.from_numpy(make_sort_data(2 * N_FLAGSHIP, "int32", seed + 1))
    sorted_rows = torch.sort(y.to(cuda).view(16, C), dim=-1).values
    del y
    for r in (8, 16):
        a, b = sorted_rows[:r], sorted_rows[16 - r:].flip(0).contiguous()
        keep = torch.arange(r, device=cuda) % 2 == 0
        got, plain = ops.merge_split(a, b, keep), merge_split_reference(a, b,
                                                                        keep)
        bad["merge_split"] += mismatches(got, plain)
        ms_err = max(ms_err, max_abs_err(got, plain))
        del got, plain
        ms[r] = (cuda_ms(lambda: ops.merge_split(a, b, keep), reps=10),
                 cuda_ms(lambda: merge_split_reference(a, b, keep), reps=2))
    del sorted_rows, x
    torch.cuda.empty_cache()
    # read both runs, write the kept half; one comparison per output
    ms_bytes_ms, ms16_bytes_ms = (3 * r * C * 4 / HBM_BYTES_PER_S * 1e3
                                  for r in (8, 16))
    ms_ops_ms = 8 * C / OPS_32BIT_PER_S * 1e3
    say(f"phase kernels: grid cases={cases} (C in {list(grid_c)}, tile={TILE})"
        f" mismatches={bad}; local_sort (8, {C}) {ls_ms:.3f} ms "
        f"(plain {ls_plain_ms:.3f} ms, torch.sort {ls_lib_ms:.3f} ms); "
        f"merge_split (8, {C}) {ms[8][0]:.3f} ms (plain {ms[8][1]:.3f} ms), "
        f"(16, {C}) {ms[16][0]:.3f} ms (plain {ms[16][1]:.3f} ms)")
    need(not any(bad.values()), f"kernels disagree with plain versions: {bad}")
    return {
        "local_sort": dict(
            name="local_sort", route="cuda",
            source="src/repro_torch/csrc/local_sort.cu",
            replaces="src/repro/kernels/local_sort.py:71",
            max_abs_err=ls_err, ms=ls_ms, plain_ms=ls_plain_ms,
            bound_ms=max(ls_bytes_ms, ls_ops_ms),
            bound_by="bytes" if ls_bytes_ms >= ls_ops_ms else "operations",
            library_ms=ls_lib_ms, bytes_ms=ls_bytes_ms, ops_ms=ls_ops_ms,
            shape=[rows, C], mismatches=bad["local_sort"]),
        "merge_split": dict(
            name="merge_split", route="cuda",
            source="src/repro_torch/csrc/merge_split.cu",
            replaces="src/repro/kernels/merge_split.py:63",
            max_abs_err=ms_err, ms=ms[8][0], plain_ms=ms[8][1],
            bound_ms=max(ms_bytes_ms, ms_ops_ms),
            bound_by="bytes" if ms_bytes_ms >= ms_ops_ms else "operations",
            library_ms=None, bytes_ms=ms_bytes_ms, ops_ms=ms_ops_ms,
            shape=[8, C], ms_16_rows=ms[16][0], plain_ms_16_rows=ms[16][1],
            bound_ms_16_rows=ms16_bytes_ms,
            mismatches=bad["merge_split"]),
        "bitonic_sort_mismatches": bad["bitonic_sort"],
    }


def phase_engine(seed: int) -> dict:
    from repro_torch.configs import CASES
    from repro_torch.convert import make_sort_data
    from repro_torch.core import HomeMesh, Homing, Locale, LocalisationPolicy

    out = {}
    for k, c in CASES.items():
        policy = LocalisationPolicy(c.localised, c.static_mapping,
                                    Homing(c.homing))
        for dt in ("int32", "float32"):
            x = torch.from_numpy(make_sort_data(N_ENGINE, dt, seed + k))
            fn = Locale(HomeMesh({"data": 8}), "data", policy).workload(
                "sort", backend="shard_map")
            xc = x.cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(xc)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check_sorted(y, xc, f"case {k} {dt}")
            small = torch.from_numpy(make_sort_data(N_ENGINE_CPU, dt, seed + k))
            on_card = fn(small.cuda()).cpu()
            on_cpu = Locale(HomeMesh({"data": 8}, device="cpu"), "data",
                            policy).workload("sort", backend="shard_map")(small)
            need(torch.equal(bits(on_card), bits(on_cpu)),
                 f"case {k} {dt}: card and CPU differ at n={N_ENGINE_CPU}")
            out[f"case{k}_{dt}_s"] = secs
    say(f"phase engine: 8 Table-1 cases x (int32, float32) sorted at "
        f"n={N_ENGINE} on HomeMesh({{'data': 8}}) and bit-exact against the "
        f"CPU at n={N_ENGINE_CPU}; first-call seconds "
        + json.dumps({k: round(v, 4) for k, v in out.items()}))
    return out


def phase_flagship(seed: int, tag: str, shape: dict, axis,
                   policy) -> dict:
    from repro_torch.convert import make_sort_data
    from repro_torch.core import HomeMesh, Locale, exchange_schedule
    from repro_torch.kernels import ops

    x = torch.from_numpy(make_sort_data(N_FLAGSHIP, "int32", seed)).cuda()
    fn = Locale(HomeMesh(shape), axis, policy).workload("sort",
                                                        backend="shard_map")
    expect_merged = sum(r["local_merge_elems"] for r in exchange_schedule(
        N_FLAGSHIP, tuple(shape.values()), policy)
        if r["op"] == "merge_split")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    # the main path's counted run: counts to 0 just before, read just after
    ops.reset_launches()
    y = fn(x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    merged = ops.merged_elems()
    peak = torch.cuda.max_memory_allocated()
    check_sorted(y, x, tag)
    del y
    need(counts["local_sort"] > 0 and counts["merge_split"] > 0,
         f"{tag}: a kernel of the path was not launched: {counts}")
    need(merged == expect_merged,
         f"{tag}: merged {merged} elements, exchange_schedule {expect_merged}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    # one more call with CUDA events around every kernel launch
    events = {"local_sort": [], "merge_split": []}
    originals = {name: getattr(ops, name) for name in events}

    def timed(name):
        def call(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = originals[name](*a, **kw)
            e.record()
            events[name].append((s, e))
            return out
        return call

    try:
        for name in events:
            setattr(ops, name, timed(name))
        fn(x)
        torch.cuda.synchronize()
    finally:
        for name, f in originals.items():
            setattr(ops, name, f)
    kernel_ms = {name: sum(s.elapsed_time(e) for s, e in ev)
                 for name, ev in events.items()}
    res = {"median_s": statistics.median(times), "times_s": times,
           "launches": counts, "merged_elems": merged,
           "schedule_merge_elems": expect_merged,
           "peak_bytes": peak - base_mem, "kernel_ms": kernel_ms}
    say(f"phase flagship {tag}: n={N_FLAGSHIP} int32 on {shape} "
        f"policy={policy.name}: median {res['median_s'] * 1e3:.3f} ms of 3 "
        f"({', '.join(f'{t * 1e3:.3f}' for t in times)}); launches {counts}; "
        f"merged {merged} == exchange_schedule {expect_merged}; peak "
        f"{res['peak_bytes']} B above the input; kernel ms "
        + json.dumps({k: round(v, 3) for k, v in kernel_ms.items()}))
    del x
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    need(torch.cuda.is_available(), "no CUDA device: the port's kernels "
                                    "run on the card only")
    need((SRC / "repro_torch" / "csrc").is_dir(),
         f"no src/repro_torch beside {Path(__file__).name}: run it from a "
         f"checkout of the repo")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import LocalisationPolicy
    from repro_torch.kernels import _build, ops

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"phase device: {kind} ({smi}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    secs, reports = _build.build_all()
    regs = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
            if "Used" in ln or "Compiling entry" in ln]
    say(f"phase build: {sorted(_build.sources())} in {secs:.2f} s; ptxas: "
        + " | ".join(regs))

    kernels = phase_kernels(args.seed)
    engine = phase_engine(args.seed)
    flat = phase_flagship(args.seed, "flat", {"data": 8}, "data",
                          LocalisationPolicy())
    hier = phase_flagship(args.seed, "hier", {"pod": 2, "data": 4},
                          ("pod", "data"),
                          LocalisationPolicy.hierarchical(inner="hash"))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "mismatches")
    line = []
    for name in ("local_sort", "merge_split"):
        k = dict(kernels[name], launches=flat["launches"][name])
        line.append({key: k[key] for key in keys})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": kind, "smi": smi, "build_s": secs, "kernels": kernels,
             "engine": engine, "flat": flat, "hier": hier}, indent=1))
    say(json.dumps({"kernels": line}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
