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
                `exchange_schedule`, times and peak memory;
  6. constraint — the 8 Table-1 cases through the default
                ``Locale(...).workload("sort")`` (the constraint backend)
                at n = 2^24 + 5, int32 and float32, checked against
                torch.sort and (int32) bit for bit against the shard_map
                engine; then case 8 and case 3 at n = 100,000,000 int32,
                with launches, relayouts, times and peak memory;
  7. fig1     — the paper's Figure 1: the "microbench" workload under the
                localised, static non-localised and auto policies at
                n = 1,000,000 and 100,000,000 f32, R in {8, 32, 128}, bit
                for bit against the plain reference; the path's own launch,
                one pass on (1, 100 M); then the kernel form, one
                `localised_copy` launch of R passes on (8, 12.5 M) f32 and
                bf16 against R launches of one pass;
  8. attention — `ops.flash_attention` at the head layouts of qwen3-0.6b
                (S = 4096, causal, bf16 and f32) and mixtral-8x7b
                (S = 8192, causal, window 4096, bf16) against its plain
                blocked version (and the dense one at the qwen shape)
                within `KERNEL_TOL` (bf16: one rounding step), and two
                planted faults, a dropped KV tile and a scale 1 % off,
                that must fall outside it on the long rows;
  9. analysis — the analyser's path: the four mutant kernels of
                `repro_torch.kernels.fixtures` against their plain versions
                (bit for bit; the raced rows of `overlapping_index_map`
                element by element one of their two writers, with the
                winners counted over 100 launches), the rules on each
                mutant's recorded launch (the reference's findings by rule,
                severity and kind), `check_workload` clean on the card for
                both sort backends and the engine on {"data": 8} and
                {"pod": 2, "data": 4}, the microbench and the attention
                cells; the rules again over every launch recorded in the
                n = 100 M sorts, the 100 M Fig-1 run and the attention
                cells; and, for every kernel call recorded, the Python
                launch plan against the C entry's dry-run twin and the
                coverage probe of its output tile maps.

Every path's counted run sets the launch counts to 0 just before it and
reads them just after (`bitonic_sort`'s path is ``ops.chunked_sort``).

Then one JSON line of kernels, the `nvidia-smi` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that.
Without a card, or without the repo's ``src/repro_torch`` beside this
file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
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


#: the launches of every phase's untimed correctness runs (`untimed`); the
#: analysis phase holds each distinct call's plan to the C entry's dry run
#: and probes its tile maps
UNTIMED = []


class SmokeFailure(Exception):
    pass


@contextlib.contextmanager
def untimed():
    """Record the kernel launches of an untimed run into `UNTIMED`."""
    from repro_torch.analysis import record
    with record() as launches:
        yield
    UNTIMED.extend(launches)


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


def graph_ms(launch, count: int = 100) -> float:
    """Milliseconds a launch of `count` captured in one CUDA graph and
    replayed: the device's time per launch without the host's cost of
    issuing each one."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            launch()
    return cuda_ms(graph.replay, reps=5) / count


def peak_run(fn, x):
    """One call of fn(x) with the peak device memory above what was
    allocated before it; returns (y, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = fn(x)
    torch.cuda.synchronize()
    return y, torch.cuda.max_memory_allocated() - base


def median_ms(fn, x, calls: int = 3):
    """Median host-clock milliseconds of `calls` calls after one warm-up."""
    fn(x)
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


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
    with untimed():
        for name in GRID_NAMES:
            for C in grid_c:
                x = torch.from_numpy(grid_rows(name, C, seed=seed)).to(cuda)
                bad["local_sort"] += mismatches(ops.local_sort(x),
                                                local_sort_reference(x))
                a, b = (torch.from_numpy(np.sort(grid_rows(name, C, 4, sd),
                                                 -1)).to(cuda)
                        for sd in (seed, seed + 7))
                for keep in (torch.tensor([True, False, False, True]), True,
                             False):
                    bad["merge_split"] += mismatches(
                        ops.merge_split(a, b, keep),
                        merge_split_reference(a, b, keep))
                cases += 1
        for C in (1, 256, TILE, 4 * TILE):
            x = torch.from_numpy(grid_rows("rand_float", C,
                                           seed=seed)).to(cuda)
            bad["bitonic_sort"] += mismatches(ops.bitonic_sort(x),
                                              bitonic_stages(x))
    torch.cuda.synchronize()

    # bitonic_sort at (8, 1024) (the reference's kernel benchmark) and
    # (8, 16384) (one tile); its path is ops.chunked_sort, counted below
    bitonic = {}
    bs_err = 0.0
    for L in (1024, TILE):
        x = torch.from_numpy(grid_rows("rand_float", L, 8, seed)).to(cuda)
        got, plain = ops.bitonic_sort(x), bitonic_stages(x)
        bad["bitonic_sort"] += mismatches(got, plain)
        bs_err = max(bs_err, max_abs_err(got, plain))
        bitonic[L] = dict(
            ms=cuda_ms(lambda: ops.bitonic_sort(x), reps=50),
            plain_ms=cuda_ms(lambda: bitonic_stages(x), reps=3),
            library_ms=cuda_ms(lambda: torch.sort(x, dim=-1), reps=50),
            bytes_ms=2 * 8 * L * 4 / HBM_BYTES_PER_S * 1e3,
            ops_ms=8 * L * math.log2(L) / OPS_32BIT_PER_S * 1e3)
    ops.reset_launches()
    y = ops.chunked_sort(x)
    torch.cuda.synchronize()
    chunked_launches = ops.launch_counts()
    need(bool((y == torch.sort(x.reshape(-1)).values).all()),
         "ops.chunked_sort did not sort")
    need(chunked_launches["bitonic_sort"] == 1,
         f"ops.chunked_sort did not launch bitonic_sort: {chunked_launches}")

    # the main path's shapes: local_sort (8, 12.5M); merge_split (8, 12.5M)
    # on every flat substage and (16, 12.5M) in the hierarchical replay
    rows, C = 8, N_FLAGSHIP // 8
    x = torch.from_numpy(make_sort_data(N_FLAGSHIP, "int32", seed)).to(cuda)
    x = x.view(rows, C)
    with untimed():
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
        with untimed():
            got = ops.merge_split(a, b, keep)
        plain = merge_split_reference(a, b, keep)
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
        f"(16, {C}) {ms[16][0]:.3f} ms (plain {ms[16][1]:.3f} ms); "
        f"bitonic_sort (8, 1024) {bitonic[1024]['ms']:.4f} ms (torch.sort "
        f"{bitonic[1024]['library_ms']:.4f} ms), (8, {TILE}) "
        f"{bitonic[TILE]['ms']:.4f} ms (torch.sort "
        f"{bitonic[TILE]['library_ms']:.4f} ms); ops.chunked_sort launches "
        + json.dumps(chunked_launches))
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
        "bitonic_sort": dict(
            name="bitonic_sort", route="cuda",
            source="src/repro_torch/csrc/local_sort.cu",
            replaces="src/repro/kernels/bitonic_sort.py:56",
            launches=chunked_launches["bitonic_sort"],
            max_abs_err=bs_err, ms=bitonic[TILE]["ms"],
            plain_ms=bitonic[TILE]["plain_ms"],
            bound_ms=max(bitonic[TILE]["bytes_ms"], bitonic[TILE]["ops_ms"]),
            bound_by="bytes" if bitonic[TILE]["bytes_ms"]
            >= bitonic[TILE]["ops_ms"] else "operations",
            library_ms=bitonic[TILE]["library_ms"], shape=[8, TILE],
            at_1024=bitonic[1024], mismatches=bad["bitonic_sort"]),
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
            with untimed():
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
    from repro_torch.analysis import record
    from repro_torch.convert import make_sort_data
    from repro_torch.core import HomeMesh, Locale, exchange_schedule
    from repro_torch.kernels import ops

    x = torch.from_numpy(make_sort_data(N_FLAGSHIP, "int32", seed)).cuda()
    fn = Locale(HomeMesh(shape), axis, policy).workload("sort",
                                                        backend="shard_map")
    expect_merged = sum(r["local_merge_elems"] for r in exchange_schedule(
        N_FLAGSHIP, tuple(shape.values()), policy)
        if r["op"] == "merge_split")
    # the main path's counted run: counts to 0 just before, read just after
    ops.reset_launches()
    with record() as recorded:
        y, peak = peak_run(fn, x)
    counts = ops.launch_counts()
    merged = ops.merged_elems()
    check_sorted(y, x, tag)
    del y
    need(counts["local_sort"] > 0 and counts["merge_split"] > 0,
         f"{tag}: a kernel of the path was not launched: {counts}")
    need(merged == expect_merged,
         f"{tag}: merged {merged} elements, exchange_schedule {expect_merged}")

    med, times_ms = median_ms(fn, x)
    times = [t / 1e3 for t in times_ms]

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
    res = {"median_s": med / 1e3, "times_s": times,
           "launches": counts, "merged_elems": merged,
           "schedule_merge_elems": expect_merged,
           "peak_bytes": peak, "kernel_ms": kernel_ms,
           "recorded": recorded}
    say(f"phase flagship {tag}: n={N_FLAGSHIP} int32 on {shape} "
        f"policy={policy.name}: median {res['median_s'] * 1e3:.3f} ms of 3 "
        f"({', '.join(f'{t * 1e3:.3f}' for t in times)}); launches {counts}; "
        f"merged {merged} == exchange_schedule {expect_merged}; peak "
        f"{res['peak_bytes']} B above the input; kernel ms "
        + json.dumps({k: round(v, 3) for k, v in kernel_ms.items()}))
    del x
    torch.cuda.empty_cache()
    return res



def phase_constraint(seed: int) -> dict:
    from repro_torch.analysis import record
    from repro_torch.configs import CASES
    from repro_torch.convert import make_sort_data
    from repro_torch.core import HomeMesh, Homing, Locale, LocalisationPolicy
    from repro_torch.core.homing import relayout_counts, reset_relayouts
    from repro_torch.kernels import ops

    mesh = HomeMesh({"data": 8})
    out = {"cases": {}, "recorded": []}
    for k, c in CASES.items():
        locale = Locale(mesh, "data", LocalisationPolicy(
            c.localised, c.static_mapping, Homing(c.homing)))
        for dt in ("int32", "float32"):
            x = torch.from_numpy(make_sort_data(N_ENGINE, dt, seed + k)).cuda()
            fn = locale.workload("sort")
            reset_relayouts()
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(x)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts, moved = ops.launch_counts(), relayout_counts()
            check_sorted(y, x, f"constraint case {k} {dt}")
            need(counts["local_sort"] == 1,
                 f"constraint case {k} {dt}: local_sort launches {counts}")
            if dt == "int32":
                with untimed():
                    eng = locale.workload("sort", backend="shard_map")(x)
                need(torch.equal(y, eng), f"constraint case {k}: differs "
                                          f"from the shard_map engine")
            out["cases"][f"case{k}_{dt}"] = dict(first_call_s=secs,
                                                 launches=counts,
                                                 relayouts=moved)
            del x, y
    torch.cuda.empty_cache()
    say(f"phase constraint: 8 Table-1 cases x (int32, float32) through the "
        f"default workload('sort') at n={N_ENGINE} on HomeMesh({{'data': 8}})"
        f", sorted, int32 bit-exact against the shard_map engine; "
        "first-call s and relayouts " + json.dumps(
            {k: [round(v["first_call_s"], 4), v["relayouts"]["relayouts"],
                 v["relayouts"]["bytes"]] for k, v in out["cases"].items()}))

    for k in (8, 3):
        c = CASES[k]
        locale = Locale(mesh, "data", LocalisationPolicy(
            c.localised, c.static_mapping, Homing(c.homing)))
        fn = locale.workload("sort")
        x = torch.from_numpy(make_sort_data(N_FLAGSHIP, "int32", seed)).cuda()
        # the path's counted run: counts to 0 just before, read just after
        reset_relayouts()
        ops.reset_launches()
        with record() as recorded:
            y, peak = peak_run(fn, x)
        counts, moved = ops.launch_counts(), relayout_counts()
        out["recorded"] += recorded
        check_sorted(y, x, f"constraint flagship case {k}")
        del y
        need(counts["local_sort"] == 1,
             f"constraint flagship case {k}: local_sort launches {counts}")
        med, times = median_ms(fn, x)
        out[f"flagship_case{k}"] = dict(median_ms=med, times_ms=times,
                                        launches=counts, relayouts=moved,
                                        peak_bytes=peak)
        say(f"phase constraint flagship case {k} ({locale.policy.name}): "
            f"n={N_FLAGSHIP} int32 on {{'data': 8}}: median {med:.3f} ms of 3 "
            f"({', '.join(f'{t:.3f}' for t in times)}); launches {counts}; "
            f"relayouts {moved}; peak {peak} B above the input")
        del x
        torch.cuda.empty_cache()
    return out


FIG1_POLICIES = {"localised": (True, True, "local"),
                 "nonlocalised": (False, True, "hash"),
                 "auto": (False, False, "hash")}


def phase_fig1(seed: int) -> dict:
    from repro_torch.analysis import record
    from repro_torch.configs import SortConfig
    from repro_torch.convert import make_fig1_data
    from repro_torch.core import HomeMesh, Homing, Locale, LocalisationPolicy
    from repro_torch.core.homing import relayout_counts, reset_relayouts
    from repro_torch.core.microbench import reference
    from repro_torch.kernels import ops
    from repro_torch.kernels.localised_copy import localised_copy_reference

    mesh = HomeMesh({"data": 8})
    out = {"workload": {}, "kernel": {}}
    counted = None
    bad = {"workload": 0, "path": 0, "one": 0, "stream": 0}
    for n in (SortConfig().micro_array_size, N_FLAGSHIP):
        x = torch.from_numpy(make_fig1_data(n, "float32", seed)).cuda()
        for R in (8, 32, 128):
            want = reference(x, R)
            row = {}
            for name, (loc, static, h) in FIG1_POLICIES.items():
                fn = Locale(mesh, "data", LocalisationPolicy(
                    loc, static, Homing(h))).workload("microbench", reps=R)
                reset_relayouts()
                ops.reset_launches()           # the path's counted run
                with record() as recorded:
                    y = fn(x)
                torch.cuda.synchronize()
                counts, moved = ops.launch_counts(), relayout_counts()
                bad["workload"] += mismatches(y, want)
                need(counts["localised_copy"] == R,
                     f"fig1 {name} n={n} R={R}: launches {counts}")
                del y
                med, times = median_ms(fn, x)
                row[name] = dict(median_ms=med, times_ms=times,
                                 launches=counts["localised_copy"],
                                 relayouts=moved)
                if name == "localised" and n == N_FLAGSHIP and R == 128:
                    counted = counts
                    out["recorded"] = recorded
            row["gap"] = row["nonlocalised"]["median_ms"] / \
                row["localised"]["median_ms"]
            out["workload"][f"n{n}_R{R}"] = row
            del want
        if n == N_FLAGSHIP:
            # the path's own launch: one pass over the whole (1, n) array,
            # as `_pass` makes it, against its plain version
            x1 = x.view(1, n)
            with untimed():
                got = ops.localised_copy(x1, 1)
            plain = localised_copy_reference(x1, 1)
            bad["path"] += mismatches(got, plain)
            path_err = max_abs_err(got, plain)
            del got, plain
            path = dict(ms=cuda_ms(lambda: ops.localised_copy(x1, 1), reps=20),
                        plain_ms=cuda_ms(
                            lambda: localised_copy_reference(x1, 1), reps=3),
                        bytes_ms=2 * n * 4 / HBM_BYTES_PER_S * 1e3,
                        ops_ms=2 * n / OPS_32BIT_PER_S * 1e3)
            del x1
        del x
        torch.cuda.empty_cache()
    say("phase fig1 workload: median ms of 3 (localised, nonlocalised, auto; "
        "gap) " + json.dumps({k: [round(v[p]["median_ms"], 4) for p in
                                  FIG1_POLICIES] + [round(v["gap"], 3)]
                              for k, v in out["workload"].items()}))

    # the kernel form: one launch of R passes against R launches of one
    rows, C = 8, N_FLAGSHIP // 8
    for dt in ("float32", "bfloat16"):
        x = torch.from_numpy(make_fig1_data((rows, C), dt, seed)).to(
            getattr(torch, dt)).cuda()
        ib = torch.int16 if dt == "bfloat16" else torch.int32
        for R in (8, 32, 128):
            def stream(v=x, R=R):
                # the non-localised order of ref.localised_copy_ref: every
                # pass a full trip through device memory, in f32 (bf16 is
                # widened before the first pass and narrowed after the last)
                v = v.float()
                for _ in range(R):
                    v = ops.localised_copy(v, 1)
                return v.to(x.dtype)
            with untimed():
                one, many = ops.localised_copy(x, R), stream()
            plain = localised_copy_reference(x, R)
            bad["one"] += int((one.view(ib) != plain.view(ib)).sum())
            bad["stream"] += int((many.view(ib) != one.view(ib)).sum())
            del one, many, plain
            nbytes = 2 * x.numel() * x.element_size()
            rec = dict(ms=cuda_ms(lambda: ops.localised_copy(x, R), reps=10),
                       stream_ms=cuda_ms(stream, reps=3),
                       plain_ms=cuda_ms(
                           lambda: localised_copy_reference(x, R), reps=1),
                       bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       ops_ms=2 * R * x.numel() / OPS_32BIT_PER_S * 1e3)
            rec["bound_ms"] = max(rec["bytes_ms"], rec["ops_ms"])
            rec["bound_by"] = ("bytes" if rec["bytes_ms"] >= rec["ops_ms"]
                               else "operations")
            rec["gap"] = rec["stream_ms"] / rec["ms"]
            out["kernel"][f"{dt}_R{R}"] = rec
        del x
        torch.cuda.empty_cache()
    say("phase fig1 kernel: (8, 12.5M) ms one launch / R launches / gap / "
        "bound / plain " + json.dumps(
            {k: [round(v["ms"], 4), round(v["stream_ms"], 4),
                 round(v["gap"], 2), round(v["bound_ms"], 4),
                 round(v["plain_ms"], 2)] for k, v in out["kernel"].items()}))
    say(f"phase fig1 path launch: localised_copy (1, {N_FLAGSHIP}) f32 "
        f"reps=1 {path['ms']:.4f} ms (plain {path['plain_ms']:.3f} ms, bound "
        f"{max(path['bytes_ms'], path['ops_ms']):.4f} ms); mismatches {bad}")
    need(not any(bad.values()), f"fig1: localised_copy differs from its "
                                f"plain version or the reference: {bad}")
    # the line describes the path's launch: the counted run is the
    # localised policy at n = 100 M, R = 128, R launches of this call
    out["path"] = path
    out["line"] = dict(
        name="localised_copy", route="cuda",
        source="src/repro_torch/csrc/localised_copy.cu",
        replaces="src/repro/kernels/localised_copy.py:33",
        launches=counted["localised_copy"], max_abs_err=path_err,
        ms=path["ms"], plain_ms=path["plain_ms"],
        bound_ms=max(path["bytes_ms"], path["ops_ms"]),
        bound_by="bytes" if path["bytes_ms"] >= path["ops_ms"]
        else "operations", library_ms=None, shape=[1, N_FLAGSHIP], reps=1,
        mismatches=sum(bad.values()))
    return out


def attention_work(B, H, KV, S, hd, window, itemsize):
    """(flops, bytes) the function needs: 4 hd flops per unmasked
    (query, key) pair; q, k, v read once and out written once."""
    q = torch.arange(S, dtype=torch.float64)
    pairs = float((q + 1).clamp(max=window).sum()) if window else \
        S * (S + 1) / 2
    return 4 * hd * pairs * B * H, (2 * B * H + 2 * B * KV) * S * hd * itemsize


#: (B, H, KV, S, hd, window, dtype): the head layouts of
#: src/repro/configs/qwen3_0_6b.py and mixtral_8x7b.py, causal
ATTN_CELLS = {"qwen3-0.6b_bf16": (1, 16, 8, 4096, 128, 0, "bfloat16"),
              "qwen3-0.6b_f32": (1, 16, 8, 4096, 128, 0, "float32"),
              "mixtral-8x7b_bf16": (1, 32, 8, 8192, 128, 4096, "bfloat16")}
ATTN_BLOCK = 128
#: the tolerance this script replaced, the reference test's at its small
#: shapes; reported beside each planted fault
OLD_BF16_TOL = 2e-2


def beyond(got, want, rtol: float, atol: float, rows=slice(None)) -> int:
    """Elements of got[..., rows, :] outside rtol/atol of want's."""
    g, w = got[..., rows, :].float(), want[..., rows, :].float()
    return int((~torch.isclose(g, w, rtol=rtol, atol=atol)).sum())


def dropped_tile_attention(q, k, v, window: int, block: int):
    """A planted fault: dense causal attention in float32 with each query
    row's oldest live KV tile left out, unless it is the row's own
    diagonal tile -- what a kernel that skipped one live tile too many
    would give.  One head at a time, so the scores stay small."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    i = torch.arange(S, device=q.device)
    qi, kj = i[:, None], i[None, :]
    keep = kj <= qi
    oldest = torch.zeros_like(qi)
    if window:
        keep &= qi - kj < window
        oldest = (qi - window + 1).clamp(min=0)
    keep &= ~((kj // block == oldest // block) & (kj // block != qi // block))
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(H):
            s = q[b, h].float() @ k[b, h // G].float().T * hd ** -0.5
            p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
            out[b, h] = (p @ v[b, h // G].float()).to(q.dtype)
    return out


def phase_attention(seed: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.analysis import record
    from repro_torch.convert import make_attention_inputs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        KERNEL_TOL, attention_ref, flash_attention_reference, kernel_tiles,
        live_tiles)

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions: f32
    torch.backends.cudnn.allow_tf32 = False
    peak = {"float32": OPS_32BIT_PER_S, "bfloat16": 989e12}
    out = {}
    counted = None
    recorded = {}
    for tag, (B, H, KV, S, hd, window, dt) in ATTN_CELLS.items():
        q, k, v = (torch.from_numpy(a).to(getattr(torch, dt)).cuda() for a in
                   make_attention_inputs(B, H, KV, S, S, hd, dt, seed))
        rtol, atol = KERNEL_TOL[q.dtype]
        kw = dict(causal=True, window=window, block_q=ATTN_BLOCK,
                  block_k=ATTN_BLOCK)
        ops.reset_launches()                   # the path's counted run
        with record() as recorded[tag]:
            got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        need(counts["flash_attention"] == 1,
             f"attention {tag}: launches {counts}")
        if tag == "qwen3-0.6b_bf16":
            counted = counts
        plain = flash_attention_reference(q, k, v, **kw)
        rec = {"max_abs_err": float((got.float() - plain.float()).abs().max()),
               "rtol": rtol, "atol": atol,
               "beyond": beyond(got, plain, rtol, atol)}
        if tag.startswith("qwen"):
            dense = attention_ref(q, k, v, causal=True, window=window)
            rec["dense_max_abs_err"] = float(
                (got.float() - dense.float()).abs().max())
            rec["dense_beyond"] = beyond(got, dense, rtol, atol)
            del dense
        # planted faults, read against the plain version on the long rows
        # (the second half, each attending to S/2 keys or more), where the
        # outputs are smallest: each must fall outside the tolerance
        late = slice(S // 2, None)
        rec["faults"] = {}
        for fault, wrong in (
                ("dropped_tile", lambda: dropped_tile_attention(
                    q, k, v, window, ATTN_BLOCK)),
                ("scale_1pct", lambda: flash_attention_reference(
                    q, k, v, scale=1.01 * hd ** -0.5, **kw))):
            w = wrong()
            rec["faults"][fault] = dict(
                late_max_abs_err=float((w[..., late, :].float()
                                        - plain[..., late, :].float())
                                       .abs().max()),
                late_beyond=beyond(w, plain, rtol, atol, late),
                late_beyond_old_tol=beyond(w, plain, OLD_BF16_TOL,
                                           OLD_BF16_TOL, late),
                late_elems=w[..., late, :].numel())
            del w
        rec["late_rms"] = float(plain[..., late, :].float().square().mean()
                                .sqrt())
        del got, plain
        need(rec["beyond"] == 0 and rec.get("dense_beyond", 0) == 0,
             f"attention {tag}: kernel outside rtol={rtol} atol={atol}: "
             f"{rec['beyond']} against plain, {rec.get('dense_beyond')} "
             f"against dense, max err {rec['max_abs_err']}")
        need(all(f["late_beyond"] for f in rec["faults"].values()),
             f"attention {tag}: a planted fault passes the tolerance: "
             f"{rec['faults']}")
        mask = None
        if window:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                 < window)

        def library():
            if mask is None:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        flops, nbytes = attention_work(B, H, KV, S, hd, window,
                                       q.element_size())
        rec.update(
            ms=cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), reps=5),
            plain_ms=cuda_ms(lambda: flash_attention_reference(q, k, v, **kw),
                             reps=1),
            library_ms=cuda_ms(library, reps=5),
            ops_ms=flops / peak[dt] * 1e3,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, flops=flops)
        rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
        rec["bound_by"] = ("operations" if rec["ops_ms"] >= rec["bytes_ms"]
                           else "bytes")
        ref_live = live_tiles(S, S, causal=True, window=window,
                              block_q=ATTN_BLOCK, block_k=ATTN_BLOCK)
        kb = kernel_tiles(S, S, ATTN_BLOCK, ATTN_BLOCK)
        ker_live = live_tiles(S, S, causal=True, window=window,
                              block_q=kb[0], block_k=kb[1])
        rec["tiles"] = dict(live=int(ref_live.sum()),
                            skipped=int((~ref_live).sum()),
                            kernel_live=int(ker_live.sum()),
                            kernel_skipped=int((~ker_live).sum()))
        out[tag] = rec
        say(f"phase attention {tag}: B={B} H={H} KV={KV} S={S} hd={hd} "
            f"causal window={window} {dt}: kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, SDPA {rec['library_ms']:.3f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); max err "
            f"{rec['max_abs_err']:.3g} (rtol={rtol:.3g} atol={atol:.3g}); "
            f"late-row rms {rec['late_rms']:.4g}; planted faults "
            + json.dumps(rec["faults"]) + f"; tiles live/skipped "
            f"{rec['tiles']}")
        del q, k, v, mask
        torch.cuda.empty_cache()
    q = out["qwen3-0.6b_bf16"]
    out["line"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        launches=counted["flash_attention"], max_abs_err=max(
            v["max_abs_err"] for v in out.values()),
        ms=q["ms"], plain_ms=q["plain_ms"], bound_ms=q["bound_ms"],
        bound_by=q["bound_by"], library_ms=q["library_ms"],
        shape=list(ATTN_CELLS["qwen3-0.6b_bf16"][:4]),
        mismatches=sum(v["beyond"] + v.get("dense_beyond", 0)
                       for v in out.values()))
    out["recorded"] = recorded
    return out


#: the reference's findings on its four fixtures (pinned against the
#: reference's own rules in tests/test_torch_analysis.py), by rule,
#: severity and kind, and the pallas_call line of each fixture
MUTANT_FINDINGS = {
    "overlapping": ([("R5", "ERROR", "write race"),
                     ("R5", "WARN", "coverage gap")], 59),
    "gapped": ([("R5", "WARN", "coverage gap")], 72),
    "oob": ([("R5", "ERROR", "out-of-bounds read")], 85),
    "dead_lane": ([("R8", "WARN", "dead lane")], 105),
}
FINDING_KINDS = ("write race", "coverage gap", "out-of-bounds read",
                 "dead lane")


def run_rules(launches):
    """R3/R5/R7/R8 over recorded launches, the launches of a wrapper call
    made again with the same arguments replayed once (the rules are
    functions of the facts alone); returns (report, distinct calls)."""
    from repro_torch.analysis import check_artifacts
    seen = set()
    facts = []
    for f in launches:
        if (f.call, f.step) not in seen:
            seen.add((f.call, f.step))
            facts.append(f)
    rep = check_artifacts("launches", facts, rules=("R3", "R5", "R7", "R8"))
    return rep, {f.call for f in facts}


def signature(report):
    return sorted((f.rule, f.severity.name,
                   next(k for k in FINDING_KINDS if k in f.message))
                  for f in report.findings)


def phase_analysis(seed: int, full_width: dict) -> dict:
    """The analyser's path on the card (see the module docstring, 9)."""
    from repro_torch.analysis import record
    from repro_torch.analysis.fixtures import mutant_launches
    from repro_torch.analysis.kernelcheck import MAX_GRID_POINTS
    from repro_torch.analysis.launches import distinct_calls, plan_of
    from repro_torch.analysis.probe import coverage_probe
    from repro_torch.convert import grid_rows, make_fig1_data
    from repro_torch.core import HomeMesh, Locale, LocalisationPolicy
    from repro_torch.kernels import fixtures, ops
    from repro_torch.kernels.local_sort import TILE

    t0 = time.perf_counter()
    out = {"mutants": {}, "workloads": {}}
    all_recorded = []

    # 1-2. the mutants: the counted run drives each through the analyser's
    # path (run under record(), rules on the recorded launch), then each
    # is held against its plain version
    rows, cols = 4, 128
    x = torch.from_numpy(make_fig1_data((rows, cols), "float32", seed)).cuda()
    ops.reset_launches()
    reports = {}
    for kind in fixtures.KINDS:
        _, launches = mutant_launches(kind, x=x)
        all_recorded += launches
        reports[kind] = run_rules(launches)[0]
    torch.cuda.synchronize()
    counted = ops.launch_counts()
    for kind, fn in fixtures.MUTANTS.items():
        need(counted[fn.__name__] == 1,
             f"analysis: {fn.__name__} launches {counted}")
        want = MUTANT_FINDINGS[kind][0]
        need(signature(reports[kind]) == want,
             f"analysis: {kind} findings {signature(reports[kind])}, the "
             f"reference's {want}:\n{reports[kind].format()}")
    for kind, fn in fixtures.MUTANTS.items():
        got, entered = fixtures.run_mutant(kind, x)
        plain, plain_entered = fixtures.mutant_reference(kind, x)
        need(int(entered) == 0 and int(plain_entered) == 0,
             f"analysis: {kind} entered the dead lane {int(entered)} times")
        rec = {"entered": int(entered)}
        if kind == "overlapping":
            # a real race: every element of row k is x[2k]'s or x[2k+1]'s
            # (so its error against the nearer writer is 0)
            winners = {"whole_first": 0, "whole_second": 0, "mixed": 0}
            for _ in range(100):
                got, _ = fixtures.run_mutant(kind, x)
                for k in range(rows // 2):
                    a = bits(got[k]) == bits(x[2 * k])
                    b = bits(got[k]) == bits(x[2 * k + 1])
                    need(bool((a | b).all()), f"analysis: overlapping row "
                         f"{k} holds a value neither writer wrote")
                    winners["whole_first" if bool(a.all()) else
                            "whole_second" if bool(b.all()) else "mixed"] += 1
                need(bool(torch.isnan(got[rows // 2:]).all()),
                     "analysis: overlapping wrote a row no block maps to")
            rec.update(winners=winners, mismatches=0, max_abs_err=0.0)
        else:
            rec.update(mismatches=mismatches(got, plain),
                       max_abs_err=max_abs_err(got, plain))
            need(rec["mismatches"] == 0,
                 f"analysis: {kind} differs from its plain version")
        src = fixtures._source(kind, x)
        buf = torch.full_like(x, float("nan"))
        ctr = torch.zeros(1, dtype=torch.int32, device=x.device)
        grid, _ = fixtures.spec(kind, rows)
        rec.update(
            ms=graph_ms(lambda: fixtures._launch(kind, src, buf, ctr)),
            launch_ms=cuda_ms(lambda: fixtures._launch(kind, src, buf, ctr),
                              reps=100),
            wrapper_ms=cuda_ms(lambda: fixtures.run_mutant(kind, x), reps=100),
            plain_ms=cuda_ms(lambda: fixtures.mutant_reference(kind, x),
                             reps=20),
            bound_ms=(grid + rows) * cols * 4 / HBM_BYTES_PER_S * 1e3,
            findings=[f.format() for f in reports[kind].findings])
        out["mutants"][kind] = rec
    say("phase analysis mutants: (4, 128) f32 on the card, findings "
        + json.dumps({k: signature(r) for k, r in reports.items()})
        + "; ms per launch in a CUDA graph / per launch from the host / "
        "wrapper / plain / bound "
        + json.dumps({k: [round(v["ms"], 5), round(v["launch_ms"], 5),
                          round(v["wrapper_ms"], 5), round(v["plain_ms"], 4),
                          v["bound_ms"]]
                      for k, v in out["mutants"].items()})
        + "; overlapping row winners over 100 launches "
        + json.dumps(out["mutants"]["overlapping"]["winners"])
        + f"; dead-lane entries {out['mutants']['dead_lane']['entered']}")

    # 3. check_workload on the card, clean (each path's counted run: counts
    # to 0 just before, read just after)
    flat = Locale(HomeMesh({"data": 8}), "data", LocalisationPolicy())
    hier = Locale(HomeMesh({"pod": 2, "data": 4}), ("pod", "data"),
                  LocalisationPolicy.hierarchical(inner="hash"))
    cells = [(f"{m}-{w}-{b or 'shard_map'}", loc, w, b)
             for m, loc in (("flat", flat), ("hier", hier))
             for w, b in (("sort", "constraint"), ("sort", "shard_map"),
                          ("engine", None))]
    cells.append(("flat-microbench", flat, "microbench", None))
    for tag, locale, workload, backend in cells:
        ops.reset_launches()
        with record() as launches:
            rep = locale.check(workload, backend=backend, logn=20)
        counts = ops.launch_counts()
        all_recorded += launches
        kernel = "localised_copy" if workload == "microbench" else "local_sort"
        need(counts[kernel] > 0, f"analysis {tag}: {kernel} not launched")
        need(rep.clean, f"analysis {tag}: not clean:\n{rep.format()}")
        out["workloads"][tag] = dict(launches=len(launches), counts={
            k: v for k, v in counts.items() if v}, notes=rep.notes)
    for tag, launches in full_width["attention"].items():
        rep, _ = run_rules(launches)
        need(rep.clean, f"analysis attention {tag}:\n{rep.format()}")
        out["workloads"][f"attention-{tag}"] = dict(launches=len(launches))
    say("phase analysis check_workload: clean on the card, launches "
        + json.dumps({k: v["launches"] for k, v in out["workloads"].items()}))

    # 4. the rules over every launch of the full-width runs
    full = [f for group in (full_width["flagship"], full_width["fig1"],
                            *full_width["attention"].values())
            for f in group]
    rep, calls = run_rules(full)
    capped = sum(1 for f in full if f.blocks > MAX_GRID_POINTS)
    out["full_width"] = dict(launches=len(full), distinct_calls=len(calls),
                             skipped_over_cap=capped,
                             findings=[f.format() for f in rep.findings],
                             notes=rep.notes)
    need(capped == 0 and rep.clean,
         f"analysis full width: {capped} launches over the grid cap, "
         f"findings:\n{rep.format()}")
    say(f"phase analysis full width: {len(full)} launches of the n = 100 M "
        f"sorts, the 100 M Fig-1 run and the attention cells checked "
        f"({len(calls)} distinct calls, each replayed once); "
        f"{capped} skipped over the grid cap; "
        f"{len(rep.findings)} findings")

    # 5. every call recorded (and bitonic_sort's shapes): Python plan ==
    # the C entry's dry run, and the coverage probe of its tile maps
    with record() as bit:
        for L in (1024, TILE):
            ops.bitonic_sort(torch.from_numpy(
                grid_rows("rand_float", L, 8, seed)).cuda())
    probes = {}
    for call in distinct_calls(all_recorded + full + bit + UNTIMED):
        module, args = call
        mod = sys.modules[module]
        py = [f.launch_tuple() for f in plan_of(call)]
        c = mod.c_plan(*args)
        need(c == py, f"analysis: plan of {call} differs from the C entry's "
                      f"dry run:\n python {py[:4]}...\n C {c[:4]}...")
        probe = coverage_probe(call)
        need(all(p["mismatches"] == 0 for p in probe.values()),
             f"analysis: coverage probe of {call}: {probe}")
        probes[f"{module.rsplit('.', 1)[-1]}{list(args)}"] = dict(
            launches=len(py), probe=probe)
        torch.cuda.empty_cache()
    out["plans"] = probes
    per_kernel = {}
    for key, v in probes.items():
        rec = per_kernel.setdefault(key.split("[")[0], [0, 0, 0])
        rec[0] += 1
        rec[1] += v["launches"]
        rec[2] += sum(p["image"] for p in v["probe"].values())
    say(f"phase analysis plans: {len(probes)} distinct calls recorded in "
        f"the untimed runs of every phase; for each, the Python plan == the "
        f"C dry run launch for launch and the coverage probe exact; "
        f"[calls, launches, elements imaged] per kernel module "
        + json.dumps(per_kernel))
    out["seconds"] = time.perf_counter() - t0
    say(f"phase analysis: {out['seconds']:.2f} s")
    out["lines"] = [dict(
        name=fn.__name__, route="cuda",
        source="src/repro_torch/csrc/fixtures.cu",
        replaces=f"src/repro/analysis/fixtures.py:{MUTANT_FINDINGS[kind][1]}",
        launches=counted[fn.__name__],
        max_abs_err=out["mutants"][kind]["max_abs_err"],
        ms=out["mutants"][kind]["ms"],
        plain_ms=out["mutants"][kind]["plain_ms"],
        bound_ms=out["mutants"][kind]["bound_ms"], bound_by="bytes",
        library_ms=None, mismatches=out["mutants"][kind]["mismatches"])
        for kind, fn in fixtures.MUTANTS.items()]
    return out


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
    constraint = phase_constraint(args.seed)
    fig1 = phase_fig1(args.seed)
    attention = phase_attention(args.seed)
    full_width = {
        "flagship": flat.pop("recorded") + hier.pop("recorded")
        + constraint.pop("recorded"),
        "fig1": fig1.pop("recorded"), "attention": attention.pop("recorded")}
    analysis = phase_analysis(args.seed, full_width)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "mismatches")
    rows = [dict(kernels[name], launches=flat["launches"][name])
            for name in ("local_sort", "merge_split")]
    rows += [kernels["bitonic_sort"], fig1["line"], attention["line"]]
    rows += analysis.pop("lines")
    line = [{key: k[key] for key in keys} for k in rows]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": kind, "smi": smi, "build_s": secs, "kernels": kernels,
             "engine": engine, "flat": flat, "hier": hier,
             "constraint": constraint, "fig1": fig1, "attention": attention,
             "analysis": analysis},
            indent=1))
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
