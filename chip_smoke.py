#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py [--seed S] [--out results.json]

Run from the root of a checkout, on a machine with one CUDA card (an H100
is the target: the kernels are built for sm_90a).  Phases, one line each:

  1. device   — the card's name and `nvidia-smi` name and power limit;
  2. build    — every kernel of ``src/repro_torch/csrc`` built with nvcc,
                with `-Xptxas -v`'s registers and spills; the bf16
                attention kernel's (`fa_wgmma`) registers, spills and
                shared memory by instance, and its SASS (`cuobjdump`),
                which must hold HGMMA (wgmma) and UTMALDG (TMA loads);
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bit for bit (floats as bit patterns), on the property grid
                (with row lengths that take `local_sort` through 1, 2, 3
                and 6 merge passes), on every sort dtype (int8, int16,
                int32, uint8, uint16, uint32, float16, bfloat16, float32)
                and at the main
                path's shapes, with their times; `local_sort` at (8,
                12.5 M) also by kernel (tile pass, partitions, merge
                passes) from `torch.profiler`; `merge_split` at (8, 12.5 M)
                and (16, 12.5 M), and `merge_runs` at the constraint tree's
                three levels as strided views, each beside its bound, its
                plain version and (merge_runs, int32) a yardstick, one
                stable `torch.sort` of both runs;
  4. engine   — the 8 Table-1 cases through
                ``Locale(...).workload("sort", backend="shard_map")`` on 8
                homes, checked against torch.sort, and held bit for bit
                against the same call on the CPU at a smaller n;
  5. flagship — the main path at the paper's size, n = 100,000,000 int32:
                case 8 on {"data": 8} (the launch counts below are this
                run's) and the hierarchical hash policy on {"pod": 2,
                "data": 4}, with launches, merged elements against
                `exchange_schedule`, times, the kernels' device times
                from `torch.profiler` and peak memory;
  5b. ranks  — the engine with one torch.distributed rank a home: 8 gloo
                ranks sharing the card (`launch.mesh.spawn`; gloo has no
                device transport, so every exchange is staged through
                pinned host memory and counted apart), each launching
                `local_sort` and `merge_split` on its own row: (a) the 8
                Table-1 cases x (int32, float32) at n = 2^24 + 5 on
                {"data": 8}, each rank's row equal by SHA-256 to the
                one-process HomeMesh engine's; (b) the flagships at n =
                100,000,000 int32 (case 8 on {"data": 8}, hierarchical hash
                on {"pod": 2, "data": 4}): the median of 3 calls after a
                warm-up (a barrier before each, the slowest rank's time),
                launches by rank, merged elements, wire and staged bytes,
                peak memory by rank, rank 0's kernels by `torch.profiler`;
                (c) `compressed_psum` of a (1024, 3072) float32 a rank,
                equal by SHA-256 to the same arithmetic in one process,
                with its int8 wire; (d) every rank's collective log of
                every call of (a) and (b) equal to `exchange_schedule` / m
                op for op and to `collective_census`, and R1/R2 clean;
                then an NCCL world of `torch.cuda.device_count()` ranks,
                one a card (case 8 at n = 2^24 + 5, checked the same way;
                on one card one rank, with no exchange).  Any rank's
                failure fails the phase;
  6. constraint — the 8 Table-1 cases through the default
                ``Locale(...).workload("sort")`` (the constraint backend)
                at n = 2^24 + 5, int32 and float32, checked against
                torch.sort and (int32) bit for bit against the shard_map
                engine, each launching one `local_sort` and one
                `merge_runs` a tree level (3); then case 8 and case 3 at
                n = 100,000,000 int32, with launches, relayouts, times,
                the kernels' device times from `torch.profiler` and peak
                memory;
  7. fig1     — the paper's Figure 1: the "microbench" workload under the
                localised, static non-localised and auto policies at
                n = 1,000,000 and 100,000,000 f32, R in {8, 32, 128}, bit
                for bit against the plain reference; the path's own launch,
                one pass on (1, 100 M); then the kernel form, one
                `localised_copy` launch of R passes on (8, 12.5 M) f32 and
                bf16 against R launches of one pass;
  8. attention — `ops.flash_attention` at the head layouts of qwen3-0.6b
                (S = 4096, causal, bf16, f32 and f16) and mixtral-8x7b
                (S = 8192, causal, window 4096, bf16) against its plain
                blocked version (and the dense one at the qwen shape)
                within `KERNEL_TOL` (bf16: one rounding step), the kernel
                each dtype ran (`fa_wgmma` bf16, `fa_kernel` f32 and
                f16), a non-default `scale` (0.1) at qwen3-0.6b bf16 and
                f32, the bf16 kernel with P rounded once (no hi + lo
                split: its time and how far it leaves the tolerance), and
                two planted faults, a dropped KV tile and a scale 1 % off,
                that must fall outside it on the long rows;
  8b. serve   — the serving stack at qwen3-0.6b's full width in bf16
                (28 layers, seeded parameters) through `DecodeServer` with
                16 slots homed over {"data": 8} and a 1024-token cache: 32
                requests of an open-loop stream (8 sessions, 8 or 32 new
                tokens) in aligned waves (prompts of 128-768 tokens, the
                prefill's attention the `flash_attention` kernel) and paged
                (prompts of 16-128 tokens with a 32-token session prefix,
                16-token pages), each under fifo and homed: tokens/s,
                launches (28 `flash_attention` a prefill wave, none paged),
                paged tokens equal across the policies, the schedule equal
                to its model-free replay, the kernel launches
                `torch.profiler` sees; the kernel at the prefill's shape
                against its plain version within `KERNEL_TOL`, the
                prefill's logits through the kernel against the plain
                chunked form (bf16 and float32, within `LOGIT_TOL`) and
                with the attention phase's two planted faults in the
                kernel's place (outside it), and the costs of a wave:
                prefill, a decode step, the `pin_tree` copy of the cache;
  8c. train   — training at qwen3-0.6b's full width in bf16 through
                `Trainer` on the card (remat, the plain chunked attention,
                AdamW), batch 2 x 4096 tokens, in a child process under
                `torch.use_deterministic_algorithms(True)`: 12 steps with a
                checkpoint at step 6, then a second trainer resumed from it
                whose losses must equal the straight run's within rtol
                1e-5; the loss must fall; no kernel of the port launches
                (the kernel has no backward pass, and `LM(cfg)` with it
                must raise under autograd); step time (CUDA events and the
                host clock), tokens/s, the model-FLOPs share of the bf16
                peak, peak memory, one step's busy time by part
                (`torch.profiler`), the checkpoint's bytes and seconds;
  8d. dtypes  — int8, int16, uint8, uint16, uint32, float16 and bfloat16
                through both backends on {"data": 8} at n = 2^24 + 5:
                equal to torch.sort's values, and bit for bit the CPU
                port's result, computed after the analysis phase, so that
                no timed phase shares the host with it;
  9. analysis — the analyser's path: the four mutant kernels of
                `repro_torch.kernels.fixtures` against their plain versions
                (bit for bit; the raced rows of `overlapping_index_map`
                element by element one of their two writers, with the
                winners counted over 100 launches), the rules on each
                mutant's recorded launch (the reference's findings by rule,
                severity and kind), their times beside the card's least
                launch time (a one-element add_ in a CUDA graph), `check_workload` clean on the card for
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
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

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


#: the kernels of one `local_sort` call by the names the profiler gives
#: them (a substring of the demangled name) and the pass each runs
LOCAL_SORT_KERNELS = {"block_sort": "tile pass", "merge_partition":
                      "partition", "merge_pass": "merge pass"}


def profile_call(fn, warm=None, cpu: bool = False):
    """`torch.profiler` (device activity, and the host's with `cpu`) over
    one call of fn(), after a warm-up step that launches 64 small kernels
    and then calls warm(): a session loses the first kernels it records
    on the card."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    x = torch.zeros(1, device="cuda")
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(64):
            x.add_(1)
        if warm is not None:
            warm()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    return prof


def device_ms_by(prof, kernels: dict) -> dict:
    """{tag: {"ms", "launches"}} of a profile's device time, each kernel
    whose name holds a key of `kernels` under its tag."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        for key, tag in kernels.items():
            if key in ev.key and us:
                rec = out.setdefault(tag, {"ms": 0.0, "launches": 0})
                rec["ms"] += us / 1e3
                rec["launches"] += ev.count
    return out


def kernel_breakdown(fn, kernels: dict) -> dict:
    """Device milliseconds and launches of one call of fn() by kernel,
    from `torch.profiler`'s `key_averages()`; where the profiler shows no
    device time, the call's time by CUDA events instead, under "whole".

    The call runs twice under the profiler, a warm-up step and the active
    one (`profile_call`).  The launches seen must number those the
    wrappers record for the active call (`kernels` names them all)."""
    from repro_torch.analysis import record
    fn()
    torch.cuda.synchronize()
    recorded = []

    def active():
        with record() as launches:
            fn()
        recorded.extend(launches)
    prof = profile_call(active, warm=fn, cpu=True)
    out = device_ms_by(prof, kernels)
    if not out:
        return {"whole": {"ms": cuda_ms(fn, reps=1), "launches": None,
                          "note": "the profiler showed no device time"}}
    seen = sum(rec["launches"] for rec in out.values())
    need(seen == len(recorded), f"the profiler saw {seen} launches of "
                                f"{list(kernels)}, the wrappers made "
                                f"{len(recorded)}")
    return out


#: the kernels of the sorts' wrappers, by the wrapper that launches them:
#: the engine's (`local_sort`, `merge_split`) and the constraint tree's
#: (`local_sort`, `merge_runs`)
_LOCAL_SORT = dict.fromkeys(LOCAL_SORT_KERNELS, "local_sort")
_MERGE = ("merge_split_partition", "merge_split_kernel")
ENGINE_KERNELS = {**_LOCAL_SORT, **dict.fromkeys(_MERGE, "merge_split")}
CONSTRAINT_KERNELS = {**_LOCAL_SORT, **dict.fromkeys(_MERGE, "merge_runs")}


def by_wrapper(breakdown: dict) -> str:
    return json.dumps({k: [round(v["ms"], 3), v["launches"]]
                       for k, v in breakdown.items()})


def transient_bytes(fn) -> int:
    """Bytes one call of fn() asks the caching allocator for beyond what
    it returns: the peak of the requested bytes during the call less
    those still held after it, which include fn()'s output."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    y = fn()
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    del y
    return (stats["requested_bytes.all.peak"]
            - stats["requested_bytes.all.current"])


def bits(t):
    """The bit patterns of a tensor, as signed integers of its width."""
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


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


def ptxas_entries(report: str) -> dict:
    """`nvcc -Xptxas -v` output by kernel entry: registers, spill bytes
    (stores + loads), static shared memory (0 where ptxas names none), the
    `warpgroup.arrive`s ptxas injected around wgmma (C7519), and its
    warnings."""
    import re
    out, name = {}, None
    injected = {}
    for ln in report.splitlines():
        m = re.search(r"C7519.*in function '([^']+)'", ln)
        if m:
            injected[m.group(1)] = injected.get(m.group(1), 0) + 1
            continue
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {"smem": 0, "warnings": []}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            out[name]["smem"] = int(m.group(1))
        if "warning" in ln.lower():
            out[name]["warnings"].append(ln.strip())
    for name, rec in out.items():
        rec["arrives_injected"] = injected.get(name, 0)
    return out


def wgmma_instances(entries: dict) -> dict:
    """The `fa_wgmma<HD, BK>` entries of `ptxas_entries`, by "HD/BK"."""
    import re
    out = {}
    for name, rec in entries.items():
        m = re.search(r"fa_wgmmaILi(\d+)ELi(\d+)E", name)
        if m:
            out[f"{m.group(1)}/{m.group(2)}"] = rec
    return out


def sass_check() -> dict:
    """`cuobjdump -sass` of the built flash-attention library: each
    `fa_wgmma` instance must hold tensor-core (HGMMA) and TMA (UTMALDG)
    instructions, or the bf16 kernel never reached them."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    r = subprocess.run([str(tool), "-sass", str(_build._target(
        "flash_attention"))], capture_output=True, text=True, timeout=300)
    need(r.returncode == 0, f"cuobjdump failed: {r.stderr.strip()[:400]}")
    found = {}
    for part in r.stdout.split("Function : ")[1:]:
        m = re.search(r"fa_wgmmaILi(\d+)ELi(\d+)E", part.split("\n", 1)[0])
        if m:
            found[f"{m.group(1)}/{m.group(2)}"] = {
                op: part.count(op) for op in ("HGMMA", "UTMALDG")}
    need(len(found) == 8, f"cuobjdump: fa_wgmma instances {sorted(found)}")
    for key, n in found.items():
        need(n["HGMMA"] > 0 and n["UTMALDG"] > 0,
             f"fa_wgmma<{key}> SASS lacks HGMMA or UTMALDG: {n}")
    return found


#: the dtypes the sort kernels take
SORT_DTYPES = ("int32", "float32", "int8", "int16", "uint8", "uint16",
               "uint32", "float16", "bfloat16")


def dtype_sweep(seed: int, bad: dict) -> dict:
    """Every sort dtype through `local_sort` (a row length with three
    merge passes), `merge_split` and `merge_runs` (strided, unequal runs)
    on `make_sort_data` values (extremes, zeros of both signs, +-inf),
    held bit for bit to the plain versions on the same card tensors;
    mismatches go into `bad`.  Returns the shapes run."""
    from repro_torch.convert import make_sort_data
    from repro_torch.core.sort import merge_sorted_reference
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitonic_sort import widen
    from repro_torch.kernels.local_sort import TILE, local_sort_reference
    from repro_torch.kernels.merge_split import merge_split_reference
    C, (rows, na, nb) = 5 * TILE + 3, (3, 70_001, 9_000)
    for i, dt in enumerate(SORT_DTYPES):
        tdt = getattr(torch, dt)
        x = torch.from_numpy(make_sort_data(3 * C, dt, seed + i)).to(tdt)
        x = x.cuda().view(3, C)
        bad["local_sort"] += mismatches(ops.local_sort(x),
                                        local_sort_reference(x))
        buf = torch.from_numpy(make_sort_data(rows * 2 * na, dt, seed + 9 + i))
        buf = widen(buf.to(tdt).cuda().view(rows, 2, na)).sort(
            dim=-1).values.to(tdt)
        a, b = buf[:, 0], buf[:, 1, :nb]
        bad["merge_runs"] += mismatches(ops.merge_runs(a, b),
                                        merge_sorted_reference(a, b))
        keep = torch.tensor([True, False, True], device=x.device)
        bad["merge_split"] += mismatches(
            ops.merge_split(a, buf[:, 1], keep),
            merge_split_reference(a, buf[:, 1], keep))
    return {"dtypes": list(SORT_DTYPES), "local_sort": [3, C],
            "merge_runs": [rows, na, nb], "merge_split": [rows, na]}


def tree_merges(seed: int, bad: dict) -> dict:
    """`merge_runs` at the constraint tree's three levels at n = 100 M
    int32: (4, 2 x 12.5 M), (2, 2 x 25 M), (1, 2 x 50 M), each pair the
    strided views ``[:, 0]`` and ``[:, 1]`` of sorted rows, as the tree
    passes them: held bit for bit to the plain version, timed (CUDA
    events) beside the plain version, the bound (both runs read once,
    the merge written once) and a
    yardstick that is not the same function: one stable `torch.sort` of
    the two runs side by side."""
    from repro_torch.core.sort import merge_sorted_reference
    from repro_torch.kernels import ops
    cuda = torch.device("cuda")
    out = {}
    gen = torch.Generator(device=cuda).manual_seed(seed)
    for rows in (4, 2, 1):
        n = N_FLAGSHIP // (2 * rows)
        buf = torch.randint(-2**31, 2**31 - 1, (rows, 2, n), device=cuda,
                            dtype=torch.int32, generator=gen)
        buf = buf.sort(dim=-1).values
        a, b = buf[:, 0], buf[:, 1]
        with untimed():
            got = ops.merge_runs(a, b)
        plain = merge_sorted_reference(a, b)
        bad["merge_runs"] += mismatches(got, plain)
        rec = dict(max_abs_err=max_abs_err(got, plain))
        del got, plain
        rec.update(
            ms=cuda_ms(lambda: ops.merge_runs(a, b), reps=10),
            plain_ms=cuda_ms(lambda: merge_sorted_reference(a, b), reps=1),
            yardstick_ms=cuda_ms(lambda: torch.sort(
                torch.cat([a, b], -1), dim=-1, stable=True), reps=3),
            bound_ms=2 * rows * 2 * n * 4 / HBM_BYTES_PER_S * 1e3)
        out[f"{rows}x2x{n}"] = rec
        del buf, a, b
        torch.cuda.empty_cache()
    return out


def phase_kernels(seed: int) -> dict:
    from repro_torch.convert import GRID_NAMES, grid_rows, make_sort_data
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitonic_sort import bitonic_stages
    from repro_torch.kernels.local_sort import (TILE, local_sort_reference,
                                                scratch_shapes)
    from repro_torch.kernels.local_sort import plan as local_sort_plan
    from repro_torch.kernels.merge_split import merge_split_reference

    cuda = torch.device("cuda")
    # above TILE: 1, 2, 3 and 6 merge passes, odd run counts, ragged runs
    grid_c = (1, 5, 96, 256, 257, TILE - 1, TILE, TILE + 1, 3 * TILE + 7,
              5 * TILE + 3, 37 * TILE + 11)
    bad = {"local_sort": 0, "merge_split": 0, "merge_runs": 0,
           "bitonic_sort": 0}
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
        dtype_cases = dtype_sweep(seed, bad)
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
    ls_breakdown = kernel_breakdown(lambda: ops.local_sort(x), LOCAL_SORT_KERNELS)
    ls_scratch = transient_bytes(lambda: ops.local_sort(x))
    plan_scratch = sum(4 * math.prod(shape)
                       for shape in scratch_shapes(rows, C).values())
    need(ls_scratch == plan_scratch, f"local_sort requested {ls_scratch} B "
         f"beside its output, its plan states {plan_scratch} B")
    plan_launches = len(local_sort_plan(rows, C, "int32"))
    ls_launches = None
    if "whole" not in ls_breakdown:
        ls_launches = sum(k["launches"] for k in ls_breakdown.values())
        need(ls_launches == plan_launches,
             f"the profiler saw {ls_launches} local_sort launches, its plan "
             f"states {plan_launches}")
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
    # the kept half comes from C elements of the two runs (the windows of
    # its ranks) and is written once: 2 rows C 4 bytes; one comparison per
    # output
    ms_bytes_ms, ms16_bytes_ms = (2 * r * C * 4 / HBM_BYTES_PER_S * 1e3
                                  for r in (8, 16))
    ms_ops_ms = 8 * C / OPS_32BIT_PER_S * 1e3
    runs = tree_merges(seed, bad)
    level1 = f"4x2x{C}"                   # the tree's first level
    say(f"phase kernels: grid cases={cases} (C in {list(grid_c)}, tile={TILE})"
        f" mismatches={bad}; local_sort (8, {C}) {ls_ms:.3f} ms "
        f"(plain {ls_plain_ms:.3f} ms, torch.sort {ls_lib_ms:.3f} ms; "
        f"{ls_launches} launches (plan {plan_launches}), scratch "
        f"{ls_scratch} B (plan {plan_scratch} B); by kernel "
        + json.dumps(ls_breakdown) + "); "
        f"merge_split (8, {C}) {ms[8][0]:.3f} ms (plain {ms[8][1]:.3f} ms, "
        f"bound {ms_bytes_ms:.4f} ms), (16, {C}) {ms[16][0]:.3f} ms (plain "
        f"{ms[16][1]:.3f} ms, bound {ms16_bytes_ms:.4f} ms); merge_runs at the tree's levels "
        + json.dumps({k: {f: (round(v, 4) if isinstance(v, float) else v)
                          for f, v in r.items()} for k, r in runs.items()})
        + "; dtypes (mismatches counted above) " + json.dumps(dtype_cases)
        + "; "
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
            shape=[rows, C], mismatches=bad["local_sort"],
            scratch_bytes=ls_scratch, launches_per_call=ls_launches,
            by_kernel=ls_breakdown),
        "merge_split": dict(
            name="merge_split", route="cuda",
            source="src/repro_torch/csrc/merge_split.cu",
            replaces="src/repro/kernels/merge_split.py:63",
            max_abs_err=ms_err, ms=ms[8][0], plain_ms=ms[8][1],
            bound_ms=max(ms_bytes_ms, ms_ops_ms),
            bound_by="bytes" if ms_bytes_ms >= ms_ops_ms else "operations",
            library_ms=None, bytes_ms=ms_bytes_ms, ops_ms=ms_ops_ms,
            shape=[8, C], ms_16_rows=ms[16][0], plain_ms_16_rows=ms[16][1],
            bound_ms_16_rows=ms16_bytes_ms, mismatches=bad["merge_split"]),
        "merge_runs": dict(
            name="merge_runs", route="cuda",
            source="src/repro_torch/csrc/merge_split.cu",
            replaces="src/repro/kernels/merge_split.py:63",
            runs_in_place_of="src/repro/core/sort.py:155",
            max_abs_err=max(r["max_abs_err"] for r in runs.values()),
            ms=runs[level1]["ms"], plain_ms=runs[level1]["plain_ms"],
            bound_ms=runs[level1]["bound_ms"], bound_by="bytes",
            library_ms=None, yardstick_ms=runs[level1]["yardstick_ms"],
            yardstick="torch.sort(torch.cat([a, b], -1), stable=True)",
            shape=[4, 2, C], levels=runs, mismatches=bad["merge_runs"]),
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

    kernel_ms = kernel_breakdown(lambda: fn(x), ENGINE_KERNELS)
    res = {"median_s": med / 1e3, "times_s": times,
           "launches": counts, "merged_elems": merged,
           "schedule_merge_elems": expect_merged,
           "peak_bytes": peak, "kernel_ms": kernel_ms,
           "recorded": recorded}
    say(f"phase flagship {tag}: n={N_FLAGSHIP} int32 on {shape} "
        f"policy={policy.name}: median {res['median_s'] * 1e3:.3f} ms of 3 "
        f"({', '.join(f'{t * 1e3:.3f}' for t in times)}); launches {counts}; "
        f"merged {merged} == exchange_schedule {expect_merged}; peak "
        f"{res['peak_bytes']} B above the input; device ms and launches by "
        f"wrapper (torch.profiler) " + by_wrapper(kernel_ms))
    del x
    torch.cuda.empty_cache()
    return res



# ---------------------------------------------------------------------------
# ranks: the engine with one torch.distributed rank a home
# ---------------------------------------------------------------------------
RANKS = 8
PSUM_SHAPE = (1024, 3072)
#: tag: (mesh shape, axis, its policy's name in `launch.sort.policies`)
RANK_FLAGSHIPS = {"flat": ({"data": 8}, "data", "case8"),
                  "hier": ({"pod": 2, "data": 4}, ("pod", "data"), "hier")}


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (its bit patterns, row-major)."""
    import hashlib
    return hashlib.sha256(bits(t.contiguous()).cpu().numpy().tobytes()
                          ).hexdigest()


def row_digests(y: torch.Tensor, m: int, policy) -> list:
    """The digest of every home's row of a one-process engine result `y`
    (logical order): padded to the engine's granule, in its output
    homing."""
    from repro_torch.core.engine import engine_granule
    from repro_torch.core.homing import Homing
    from repro_torch.core.sort import pad_to_multiple
    hash_homed = policy.homing == Homing.HASH_INTERLEAVED
    y = pad_to_multiple(y, engine_granule(m, None, hash_homed),
                        nan_check=False)
    if policy.localised or not hash_homed:
        rows = y.view(m, -1)
    else:
        rows = y.view(-1, m).t()
    return [digest(r) for r in rows]


def psum_input(seed: int, rank: int, shape) -> np.ndarray:
    rng = np.random.default_rng([seed, 1000 + rank])
    return rng.standard_normal(shape, dtype=np.float32) * 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rank_child(device, seed: int, want: dict, sizes: dict) -> dict:
    """One rank of the ranks phase: (a) the 8 cases at n_engine, (b) the
    flagships at n_flagship, (c) compressed_psum (`sizes`); each sort's
    row held to the one-process engine's by digest, its collectives to the
    schedule, the census and R1/R2."""
    need("jax" not in sys.modules, "a rank process imported JAX")
    import torch.distributed as dist

    from repro_torch.convert import make_sort_data
    from repro_torch.core import Locale
    from repro_torch.core import collectives as coll
    from repro_torch.core.mesh import RankMesh
    from repro_torch.kernels import ops
    from repro_torch.launch.sort import policies, rank_report
    from repro_torch.optim.compression import (compressed_psum,
                                               gather_quantized)

    rank = dist.get_rank()
    cuda = torch.device(device).type == "cuda"
    flat = RankMesh({"data": RANKS}, device=device)
    meshes = {"flat": flat,
              "hier": RankMesh(RANK_FLAGSHIPS["hier"][0], device=device)}
    out = {"rank": rank, "device": str(flat.device), "cases": {},
           "flagships": {}}
    # (a) the 8 Table-1 cases
    for tag, policy in policies(False).items():
        k = int(tag.removeprefix("case"))
        for dt in ("int32", "float32"):
            fn = Locale(flat, "data", policy).workload("sort",
                                                       backend="shard_map")
            shard = fn.place(torch.from_numpy(
                make_sort_data(sizes["n_engine"], dt, seed + k)))
            ops.reset_launches()
            coll.reset_collectives()
            y = fn(shard)
            sync(device)
            out["cases"][f"case{k}_{dt}"] = {
                "equal": digest(y.data) == want["cases"][f"case{k}_{dt}"][rank],
                "launches": ops.launch_counts(),
                "staged": coll.staged_bytes(),
                **rank_report(coll.collective_log(), flat, ("data",),
                             sizes["n_engine"], policy, 4)}
    # (b) the flagships at the paper's size
    for tag, (shape, axis, pname) in RANK_FLAGSHIPS.items():
        mesh, policy = meshes[tag], policies(True)[pname]
        axes = (axis,) if isinstance(axis, str) else axis
        fn = Locale(mesh, axis, policy).workload("sort", backend="shard_map")
        shard = fn.place(torch.from_numpy(
            make_sort_data(sizes["n_flagship"], "int32", seed)))
        sync(device)
        # the main path's counted run: counts to 0 just before, read after
        ops.reset_launches()
        coll.reset_collectives()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        y = fn(shard)
        sync(device)
        res = {"peak_bytes": (torch.cuda.max_memory_allocated() - base
                              if cuda else None),
               "launches": ops.launch_counts(),
               "merged_elems": ops.merged_elems(),
               "staged": coll.staged_bytes(),
               "equal": digest(y.data) == want["flagships"][tag][rank],
               **rank_report(coll.collective_log(), mesh, axes,
                            sizes["n_flagship"], policy, 4)}
        res["wire"] = sum(r["wire_bytes"] for r in coll.LOG)
        del y
        fn(shard)                          # warm-up
        times = []
        for _ in range(3):
            dist.barrier()
            sync(device)
            t0 = time.perf_counter()
            fn(shard)
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        res["times_ms"] = times
        if rank == 0 and cuda:
            prof = profile_call(lambda: fn(shard))
            res["kernel_ms"] = device_ms_by(prof, ENGINE_KERNELS)
        else:
            fn(shard)
            sync(device)
        out["flagships"][tag] = res
        del shard
    # (c) compressed_psum over the 8 ranks
    x = torch.from_numpy(psum_input(seed, rank, sizes["psum"])).to(
        flat.device)
    qg, sg = gather_quantized(x, flat, "data")
    coll.reset_collectives()
    total = compressed_psum(x, flat, "data")
    sync(device)
    out["psum"] = {"sum": digest(total) == want["psum"]["sum"],
                   "q": digest(qg) == want["psum"]["q"],
                   "s": digest(sg) == want["psum"]["s"],
                   "log": [(r["kind"], r["wire_bytes"]) for r in coll.LOG]}
    out["jax_free"] = "jax" not in sys.modules
    return out


def nccl_child(device, seed: int, want: list, n: int) -> dict:
    """One rank of the NCCL world: case 8 at `n` on {"data": world}."""
    import torch.distributed as dist

    from repro_torch.convert import make_sort_data
    from repro_torch.core import Locale
    from repro_torch.core import collectives as coll
    from repro_torch.core.mesh import RankMesh
    from repro_torch.kernels import ops
    from repro_torch.launch.sort import policies, rank_report

    world = dist.get_world_size()
    mesh = RankMesh({"data": world}, device=device)
    policy = policies(False)["case8"]
    fn = Locale(mesh, "data", policy).workload("sort", backend="shard_map")
    shard = fn.place(torch.from_numpy(make_sort_data(n, "int32", seed + 8)))
    ops.reset_launches()
    coll.reset_collectives()
    y = fn(shard)
    sync(device)
    return {"backend": dist.get_backend(), "equal":
            digest(y.data) == want[dist.get_rank()],
            "launches": ops.launch_counts(), "staged": coll.staged_bytes(),
            "collectives": len(coll.LOG),
            **rank_report(coll.collective_log(), mesh, ("data",), n, policy,
                         4)}


def rank_wants(seed: int, device) -> dict:
    """What every rank must give, from the one-process engine (and the
    one-process compressed sum) on `device`: digests of each home's row."""
    from repro_torch.convert import make_sort_data
    from repro_torch.core import HomeMesh, Locale
    from repro_torch.launch.sort import policies
    from repro_torch.optim.compression import quantize

    want = {"cases": {}, "flagships": {}}
    mesh = HomeMesh({"data": RANKS}, device=device)
    for tag, policy in policies(False).items():
        k = int(tag.removeprefix("case"))
        fn = Locale(mesh, "data", policy).workload("sort",
                                                   backend="shard_map")
        for dt in ("int32", "float32"):
            x = torch.from_numpy(make_sort_data(N_ENGINE, dt, seed + k))
            want["cases"][f"case{k}_{dt}"] = row_digests(
                fn(x.to(device)), RANKS, policy)
    x = torch.from_numpy(make_sort_data(N_FLAGSHIP, "int32", seed))
    for tag, (shape, axis, pname) in RANK_FLAGSHIPS.items():
        policy = policies(True)[pname]
        fn = Locale(HomeMesh(shape, device=device), axis, policy).workload(
            "sort", backend="shard_map")
        want["flagships"][tag] = row_digests(fn(x.to(device)), RANKS, policy)
    # compressed_psum's arithmetic in one process
    parts = [quantize(torch.from_numpy(psum_input(seed, r, PSUM_SHAPE))
                      .to(device)) for r in range(RANKS)]
    qg = torch.stack([q for q, _ in parts])
    sg = torch.stack([s for _, s in parts])
    total = (qg.float() * sg[..., None]).sum(dim=0).reshape(-1)
    total = total[:math.prod(PSUM_SHAPE)].reshape(PSUM_SHAPE)
    want["psum"] = {"sum": digest(total), "q": digest(qg), "s": digest(sg),
                    "q_bytes": qg[0].numel(), "s_bytes": sg[0].numel() * 4}
    return want


def phase_ranks(seed: int, device="cuda") -> dict:
    """The engine with one rank a home: 8 gloo ranks sharing the card,
    then an NCCL world of every card (see the module docstring)."""
    from repro_torch.core import exchange_schedule
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.sort import policies

    t_phase = time.perf_counter()
    want = rank_wants(seed, device)
    t0 = time.perf_counter()
    sizes = {"n_engine": N_ENGINE, "n_flagship": N_FLAGSHIP,
             "psum": PSUM_SHAPE}
    ranks = spawn(rank_child, RANKS, "gloo", device, seed, want, sizes)
    spawn_s = time.perf_counter() - t0
    need(all(r["jax_free"] for r in ranks), "a rank imported JAX")
    for r in ranks:
        for key, res in list(r["cases"].items()) + list(
                r["flagships"].items()):
            what = f"ranks: rank {r['rank']} {key}"
            need(res["equal"], f"{what}: its row differs from the "
                               f"one-process engine's")
            need(not res["schedule"], f"{what}: {res['schedule']}")
            need(res["census"], f"{what}: the log's census differs")
            need(not res["findings"], f"{what}: R1/R2 {res['findings']}")
            if torch.device(device).type == "cuda":
                need(res["launches"]["local_sort"] == 1, f"{what}: "
                     f"{res['launches']}")
    out = {"spawn_s": spawn_s, "cases": len(ranks[0]["cases"]),
           "flagships": {}}
    say(f"phase ranks (a): {RANKS} gloo ranks on {ranks[0]['device']}, the "
        f"8 Table-1 cases x (int32, float32) at n={N_ENGINE}: every rank's "
        f"row equal by SHA-256 to the one-process HomeMesh engine's; every "
        f"rank's collectives equal to exchange_schedule / m op for op and to "
        f"collective_census; R1/R2 clean ({spawn_s:.1f} s for the world)")
    for tag, (shape, axis, pname) in RANK_FLAGSHIPS.items():
        rs = [r["flagships"][tag] for r in ranks]
        times = [max(r["times_ms"][i] for r in rs) for i in range(3)]
        policy = policies(True)[pname]
        merged = sum(r["merged_elems"] for r in rs)
        expect = sum(r["local_merge_elems"] for r in exchange_schedule(
            N_FLAGSHIP, tuple(shape.values()), policy)
            if r["op"] == "merge_split")
        if torch.device(device).type == "cuda":
            need(merged == expect, f"ranks {tag}: merged {merged}, the "
                                   f"schedule {expect}")
            kms = rs[0]["kernel_ms"]
            need({"local_sort", "merge_split"} <= set(kms), f"ranks {tag}: "
                 f"torch.profiler saw {kms} in rank 0")
        res = {"median_ms": statistics.median(times), "times_ms": times,
               "rank_times_ms": [r["times_ms"] for r in rs],
               "launches": [r["launches"] for r in rs],
               "merged_elems": merged, "schedule_merge_elems": expect,
               "wire_bytes": [r["wire"] for r in rs],
               "staged_bytes": [r["staged"] for r in rs],
               "peak_bytes": [r["peak_bytes"] for r in rs],
               "kernel_ms_rank0": rs[0].get("kernel_ms")}
        out["flagships"][tag] = res
        say(f"phase ranks (b) {tag}: n={N_FLAGSHIP} int32 on {shape}, "
            f"{policy.name}: median {res['median_ms']:.3f} ms of 3 (slowest "
            f"rank a call: {', '.join(f'{t:.3f}' for t in times)}); rows "
            f"equal to the HomeMesh engine's; launches by rank "
            f"local_sort {[c['local_sort'] for c in res['launches']]} "
            f"merge_split {[c['merge_split'] for c in res['launches']]}; "
            f"merged {merged} == schedule {expect}; wire bytes by rank "
            f"{res['wire_bytes']} (== exchange_schedule / m, op for op; "
            f"census equal; R1/R2 clean); staged bytes by rank "
            f"{res['staged_bytes']}; peak bytes by rank {res['peak_bytes']}; "
            f"rank 0's device ms and launches by wrapper (torch.profiler) "
            + (by_wrapper(res["kernel_ms_rank0"])
               if res["kernel_ms_rank0"] else "not profiled"))
    q_bytes, s_bytes = want["psum"]["q_bytes"], want["psum"]["s_bytes"]
    for r in ranks:
        p = r["psum"]
        need(p["sum"] and p["q"] and p["s"], f"ranks: rank {r['rank']}'s "
             f"compressed_psum differs from one process's: {p}")
        need(p["log"] == [("all-gather", (RANKS - 1) * q_bytes),
                          ("all-gather", (RANKS - 1) * s_bytes)],
             f"ranks: compressed_psum's wire {p['log']}")
    out["psum_wire"] = ranks[0]["psum"]["log"]
    say(f"phase ranks (c): compressed_psum over {RANKS} ranks of a "
        f"{PSUM_SHAPE} float32 each: the sum, the int8 payload and the "
        f"scales equal by SHA-256 to the same arithmetic in one process; "
        f"wire {ranks[0]['psum']['log']} (1 byte a padded element to each "
        f"of {RANKS - 1} ranks, then the float32 scales)")
    findings = sum(len(res["findings"]) for r in ranks for res in
                   list(r["cases"].values())
                   + list(r["flagships"].values()))
    say(f"phase ranks (d): R1/R2 over {RANKS} ranks x "
        f"{len(ranks[0]['cases']) + len(RANK_FLAGSHIPS)} calls: {findings} "
        f"finding(s)")
    out["rank_launches"] = {k: [c[k] for c in
                                out["flagships"]["flat"]["launches"]]
                            for k in ranks[0]["flagships"]["flat"]["launches"]}
    # the NCCL world: every card, one rank each
    world = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    from repro_torch.convert import make_sort_data
    from repro_torch.core import HomeMesh, Locale
    policy = policies(False)["case8"]
    fn = Locale(HomeMesh({"data": world}, device=device), "data",
                policy).workload("sort", backend="shard_map")
    y = fn(torch.from_numpy(make_sort_data(N_ENGINE, "int32", seed + 8))
           .to(device))
    nccl = spawn(nccl_child, world, backend, device, seed,
                 row_digests(y, world, policy), N_ENGINE)
    for i, r in enumerate(nccl):
        need(r["backend"] == backend and r["equal"] and not r["schedule"]
             and r["census"] and not r["findings"],
             f"ranks {backend} world, rank {i}: {r}")
    out["nccl"] = nccl
    say(f"phase ranks {backend}: a world of {world} rank(s), one a card: "
        f"case 8 at n={N_ENGINE} int32 equal by SHA-256 to the one-process "
        f"engine's row(s), launches {[r['launches']['local_sort'] for r in nccl]} "
        f"local_sort by rank, {[r['collectives'] for r in nccl]} collective(s) "
        f"by rank"
        + (" -- the world has one rank and no exchange" if world == 1
           else ""))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


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
            need(counts["local_sort"] == 1 and counts["merge_runs"] == 3,
                 f"constraint case {k} {dt}: launches {counts}, want one "
                 f"local_sort and one merge_runs a tree level (3)")
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
        need(counts["local_sort"] == 1 and counts["merge_runs"] == 3,
             f"constraint flagship case {k}: launches {counts}, want one "
             f"local_sort and one merge_runs a tree level (3)")
        med, times = median_ms(fn, x)
        kernel_ms = kernel_breakdown(lambda: fn(x), CONSTRAINT_KERNELS)
        out[f"flagship_case{k}"] = dict(median_ms=med, times_ms=times,
                                        launches=counts, relayouts=moved,
                                        peak_bytes=peak, kernel_ms=kernel_ms)
        say(f"phase constraint flagship case {k} ({locale.policy.name}): "
            f"n={N_FLAGSHIP} int32 on {{'data': 8}}: median {med:.3f} ms of 3 "
            f"({', '.join(f'{t:.3f}' for t in times)}); launches {counts}; "
            f"relayouts {moved}; peak {peak} B above the input; device ms "
            f"and launches by wrapper (torch.profiler) "
            + by_wrapper(kernel_ms))
        del x
        torch.cuda.empty_cache()
    return out


#: the backends the dtypes phase sorts with
SORT_BACKENDS = ("constraint", "shard_map")


def dtype_inputs(seed: int) -> dict:
    """The dtypes phase's inputs: n = 2^24 + 5 `make_sort_data` values of
    each narrow sort dtype, as CPU tensors."""
    from repro_torch.convert import NARROW_SORT_DTYPES, make_sort_data
    return {dt: torch.from_numpy(make_sort_data(N_ENGINE, dt, seed + 50 + i))
            .to(getattr(torch, dt))
            for i, dt in enumerate(NARROW_SORT_DTYPES)}


def cpu_reference(seed: int) -> dict:
    """The CPU port's sorts of `dtype_inputs`, both backends (the plain
    bitonic network over 2^21 + 1-key leaves takes ~30 s a sort)."""
    from repro_torch.core import HomeMesh, Locale, LocalisationPolicy
    return {f"{dt}_{backend}": Locale(
        HomeMesh({"data": 8}, device="cpu"), "data", LocalisationPolicy()
    ).workload("sort", backend=backend)(x)
        for dt, x in dtype_inputs(seed).items() for backend in SORT_BACKENDS}


def phase_dtypes(seed: int) -> dict:
    """The narrow sort dtypes through both backends on {"data": 8} at
    n = 2^24 + 5, on the card: values equal to torch.sort's (uint16 and
    uint32 sorted widened, `widen`: torch.sort takes neither on the card).
    Returns the results (on the CPU) for `check_dtypes_on_cpu`."""
    from repro_torch.core import HomeMesh, Locale, LocalisationPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitonic_sort import widen

    t0 = time.perf_counter()
    out = {"results": {}, "launches": {}}
    for dt, x in dtype_inputs(seed).items():
        xc = x.cuda()
        want = torch.sort(widen(xc)).values
        for backend in SORT_BACKENDS:
            tag = f"{dt}_{backend}"
            fn = Locale(HomeMesh({"data": 8}), "data", LocalisationPolicy()
                        ).workload("sort", backend=backend)
            ops.reset_launches()            # the path's counted run
            with untimed():
                y = fn(xc)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            need(y.dtype == x.dtype and y.shape == x.shape,
                 f"dtypes {tag}: {y.dtype} {tuple(y.shape)}")
            need(bool((widen(y) == want).all()),
                 f"dtypes {tag}: values differ from torch.sort's")
            merge = "merge_runs" if backend == "constraint" else "merge_split"
            need(counts["local_sort"] == 1 and counts[merge] > 0,
                 f"dtypes {tag}: launches {counts}")
            out["launches"][tag] = {k: v for k, v in counts.items() if v}
            out["results"][tag] = y.cpu()
            del y
        del xc, want
        torch.cuda.empty_cache()
    out["card_seconds"] = time.perf_counter() - t0
    say(f"phase dtypes: {list(out['results'])} sorted at n={N_ENGINE} on "
        f"HomeMesh({{'data': 8}}), equal to torch.sort, in "
        f"{out['card_seconds']:.1f} s; launches " + json.dumps(out["launches"]))
    return out


def check_dtypes_on_cpu(dtypes: dict, seed: int) -> None:
    """Hold each card result of `phase_dtypes` bit for bit to the CPU
    port's for the same input.  Runs after every timed phase."""
    t0 = time.perf_counter()
    cpu = cpu_reference(seed)
    dtypes["mismatches_vs_cpu"] = {
        tag: mismatches(y, cpu[tag]) for tag, y in dtypes.pop("results").items()}
    dtypes["cpu_seconds"] = time.perf_counter() - t0
    say(f"phase dtypes on the CPU: the CPU port's results in "
        f"{dtypes['cpu_seconds']:.1f} s, mismatches "
        + json.dumps(dtypes["mismatches_vs_cpu"]))
    need(not any(dtypes["mismatches_vs_cpu"].values()),
         "dtypes: card and CPU differ")


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
              "qwen3-0.6b_f16": (1, 16, 8, 4096, 128, 0, "float16"),
              "mixtral-8x7b_bf16": (1, 32, 8, 8192, 128, 4096, "bfloat16")}
#: a non-default scale, checked against the plain version in these cells
ATTN_SCALE = 0.1
ATTN_SCALE_CELLS = ("qwen3-0.6b_bf16", "qwen3-0.6b_f32")
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
        KERNEL_TOL, KERNELS, _launch, attention_ref, flash_attention_reference,
        kernel_tiles, live_tiles)

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions: f32
    torch.backends.cudnn.allow_tf32 = False
    # the peak of each input type (float16's tensor-core rate, although
    # this port's float16 kernel runs on the fp32 pipe)
    peak = {"float32": OPS_32BIT_PER_S, "bfloat16": 989e12,
            "float16": 989e12}
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
        ran = [f.name for f in recorded[tag]]
        need(ran == [KERNELS[dt]], f"attention {tag}: kernels {ran}, not "
                                   f"{KERNELS[dt]}")
        if tag == "qwen3-0.6b_bf16":
            counted = counts
        plain = flash_attention_reference(q, k, v, **kw)
        rec = {"kernel": ran[0],
               "max_abs_err": float((got.float() - plain.float()).abs().max()),
               "rtol": rtol, "atol": atol,
               "beyond": beyond(got, plain, rtol, atol)}
        if dt == "bfloat16":
            # the design not taken: P rounded once to bf16 before P V
            one = torch.empty_like(q)

            def single():
                _launch(q, k, v, one, True, window, ATTN_BLOCK, ATTN_BLOCK,
                        p_split=False)
            single()
            torch.cuda.synchronize()
            rec["single_p"] = dict(
                beyond=beyond(one, plain, rtol, atol), elems=one.numel(),
                max_abs_err=float((one.float() - plain.float()).abs().max()),
                ms=cuda_ms(single, reps=20))
            del one
        if tag in ATTN_SCALE_CELLS:
            with untimed():
                scaled = ops.flash_attention(q, k, v, scale=ATTN_SCALE, **kw)
            want = flash_attention_reference(q, k, v, scale=ATTN_SCALE, **kw)
            rec["scale"] = dict(
                scale=ATTN_SCALE, beyond=beyond(scaled, want, rtol, atol),
                max_abs_err=float((scaled.float() - want.float()).abs()
                                  .max()),
                moved_from_default=float((scaled.float() - got.float())
                                         .abs().max()))
            del scaled, want
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
        need("scale" not in rec or (rec["scale"]["beyond"] == 0 and
                                    rec["scale"]["moved_from_default"] > 0),
             f"attention {tag}: scale={ATTN_SCALE} outside the tolerance or "
             f"ignored: {rec.get('scale')}")
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
            ms=cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), reps=20),
            plain_ms=cuda_ms(lambda: flash_attention_reference(q, k, v, **kw),
                             reps=1),
            library_ms=cuda_ms(library, reps=5),
            ops_ms=flops / peak[dt] * 1e3,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, flops=flops)
        rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
        rec["bound_by"] = ("operations" if rec["ops_ms"] >= rec["bytes_ms"]
                           else "bytes")
        rec["bound_fraction"] = rec["bound_ms"] / rec["ms"]
        ref_live = live_tiles(S, S, causal=True, window=window,
                              block_q=ATTN_BLOCK, block_k=ATTN_BLOCK)
        kb = kernel_tiles(S, S, ATTN_BLOCK, ATTN_BLOCK, dt)
        ker_live = live_tiles(S, S, causal=True, window=window,
                              block_q=kb[0], block_k=kb[1])
        rec["tiles"] = dict(live=int(ref_live.sum()),
                            skipped=int((~ref_live).sum()),
                            kernel_live=int(ker_live.sum()),
                            kernel_skipped=int((~ker_live).sum()))
        # the products the kernel issues: every live tile whole, P V twice
        # in bf16 (the hi + lo split of P)
        issued = (int(ker_live.sum()) * B * H * 2 * kb[0] * kb[1] * hd
                  * (3 if dt == "bfloat16" else 2))
        rec["tflops"] = dict(needed=flops / rec["ms"] / 1e9,
                             issued=issued / rec["ms"] / 1e9)
        rec["profile"] = kernel_breakdown(
            lambda: ops.flash_attention(q, k, v, **kw),
            {name: name for name in KERNELS.values()})
        out[tag] = rec
        say(f"phase attention {tag}: B={B} H={H} KV={KV} S={S} hd={hd} "
            f"causal window={window} {dt}: kernel {rec['kernel']} "
            f"{rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, SDPA {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{rec['bound_fraction']:.3f} of it); "
            + f"TFLOP/s needed / issued {rec['tflops']['needed']:.1f} / "
            f"{rec['tflops']['issued']:.1f}; profiler "
            + json.dumps(rec["profile"]) + "; "
            + (f"one bf16 P (no split): {json.dumps(rec['single_p'])}; "
               if "single_p" in rec else "")
            + (f"scale={ATTN_SCALE}: {json.dumps(rec['scale'])}; "
               if "scale" in rec else "") + f"max err "
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


#: the serving cell: qwen3-0.6b at full width in bf16 (28 layers, d 1024,
#: H 16, KV 8, hd 128, vocab 152064 padded), 16 slots homed over
#: HomeMesh({"data": 8}), a 1024-token cache; 32 requests of
#: ``make_serve_stream`` (8 sessions, 8 or 32 new tokens) in each mode
SERVE_ARCH, SERVE_SLOTS, SERVE_MAX_LEN = "qwen3-0.6b", 16, 1024
SERVE_REQUESTS, SERVE_SESSIONS, SERVE_NEW = 32, 8, (8, 32)
#: per mode: the server's prompt_pad and page_size, the prompt lengths and
#: the shared session prefix of the stream
SERVE_MODES = {"waves": dict(prompt_pad=None, page_size=None,
                             prompt_len=(128, 768), prefix=0),
               "paged": dict(prompt_pad=128, page_size=16,
                             prompt_len=(16, 128), prefix=32)}
#: the prefill's last-position logits through the kernel against the plain
#: chunked form on the card, as the largest difference over the largest
#: |logit| of the plain run.  The kernel keeps P as a bf16 hi + lo pair
#: where the chunked form rounds it once, about one bf16 step (2^-8 of a
#: value) of every attention output, carried through 28 layers; float32
#: differs only in the order of the sums.  Each bound lies between the
#: sound run's reading and the planted faults' (H100, seed 0: bf16 0.0138
#: against a scale 1 % off 0.0170 and a dropped KV tile 1.32; float32
#: 1.06e-6 against 0.00342 and 1.32): in bf16 a 1 % scale sits barely
#: above the rounding the two correct forms differ by
LOGIT_TOL = {"bfloat16": 2.0 ** -6, "float32": 2.0 ** -12}
#: the serve phase's kernel numbers that the kernels line carries beside
#: the attention phase's, under ``serve_<key>``
SERVE_LINE_KEYS = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")
#: rows of the float32 logits check (its parameters take 3 GB)
LOGIT_ROWS_F32 = 4


def profiled_kernels(fn, names) -> dict:
    """{name: launches} of the kernels whose profiler key holds a name of
    `names`, seen by `torch.profiler` over one call of fn()."""
    seen = dict.fromkeys(names, 0)
    for ev in profile_call(fn).key_averages():
        for name in names:
            if name in ev.key:
                seen[name] += ev.count
    return seen


def device_busy_ms(fn) -> float:
    """Milliseconds of kernel time on the card over one call of fn(), from
    `torch.profiler`."""
    return sum(getattr(ev, "device_time_total", 0) or 0
               for ev in profile_call(fn).key_averages()) / 1e3


def phase_serve(seed: int) -> dict:
    """The serving stack at qwen3-0.6b full width (see the module
    docstring, 8b)."""
    import torch.nn.functional as F
    from repro_torch.analysis import record
    from repro_torch.configs import get_config
    from repro_torch.convert import make_attention_inputs, make_serve_stream
    from repro_torch.core import HomeMesh, Locale
    from repro_torch.core.homing import relayout_counts, reset_relayouts
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        KERNEL_TOL, KERNELS, flash_attention_reference)
    from repro_torch.models import LM
    from repro_torch.obs import Tracer
    from repro_torch.runtime.server import (DecodeServer, Request,
                                            schedule_replay)

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    L, H, KV, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    # serving needs no gradient: LM.init's tensors do not require grad, so
    # the kernel's autograd guard never fires on this path
    need(not any(t.requires_grad for t in tree_leaves(params)),
         "serve: LM.init's parameters require grad")
    out = {"arch": SERVE_ARCH, "params": n_params,
           "init_s": time.perf_counter() - t0, "runs": {}}
    locale = Locale(HomeMesh({"data": 8}), "data")
    streams = {mode: make_serve_stream(
        SERVE_REQUESTS, cfg.vocab_size, m["prompt_len"],
        sessions=SERVE_SESSIONS, new_tokens=SERVE_NEW, slots=SERVE_SLOTS,
        seed=seed, prefix=m["prefix"]) for mode, m in SERVE_MODES.items()}

    def server(mode, policy, tracer=None):
        m = SERVE_MODES[mode]
        srv = DecodeServer(cfg, params, batch_slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN, locale=locale,
                           scheduler=policy, prompt_pad=m["prompt_pad"],
                           page_size=m["page_size"], tracer=tracer)
        for d in streams[mode]:
            srv.submit(Request(**d))
        return srv

    # the counted runs: both modes, both policies
    recorded = []
    for mode in SERVE_MODES:
        for policy in ("fifo", "homed"):
            tag = f"{mode}-{policy}"
            tracer = Tracer()
            srv = server(mode, policy, tracer)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_relayouts()
            ops.reset_launches()                 # the path's counted run
            t0 = time.perf_counter()
            with record() as launches:
                served = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            moved = relayout_counts()
            recorded += launches
            summary = srv.scheduler.summary()
            rtr = Tracer()
            replay = schedule_replay(
                cfg, [Request(**d) for d in streams[mode]],
                batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                locale=locale, scheduler=policy,
                prompt_pad=SERVE_MODES[mode]["prompt_pad"],
                page_size=SERVE_MODES[mode]["page_size"], tracer=rtr)
            events = [sched_events(t) for t in (tracer, rtr)]
            toks = {r.rid: list(r.out) for r in served}
            n_tok = sum(len(v) for v in toks.values())
            prefills = summary["waves"] if mode == "waves" else 0
            rec = dict(
                wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                served=len(served), waves=summary["waves"],
                steps=summary["steps"], launches=counts,
                flash_expected=L * prefills,
                kernels=sorted({f.name for f in launches}),
                relayout_bytes=summary["relayout_bytes"],
                inter_pod_bytes=summary["inter_pod_bytes"],
                pages_attached=summary["pages_attached"],
                pin_tree=moved, peak_bytes=torch.cuda.max_memory_allocated()
                - base, replay_equal=replay.summary() == summary
                and events[0] == events[1], tokens_out=toks)
            out["runs"][tag] = rec
            need(len(served) == SERVE_REQUESTS and all(
                len(toks[d["rid"]]) == d["max_new"] for d in streams[mode])
                and all(0 <= t < cfg.vocab_padded for v in toks.values()
                        for t in v), f"serve {tag}: requests or tokens wrong")
            need(counts.get("flash_attention", 0) == L * prefills
                 and set(counts) <= {"flash_attention"},
                 f"serve {tag}: launches {counts}, want {L} flash_attention "
                 f"a prefill wave x {prefills}")
            need(rec["replay_equal"], f"serve {tag}: the schedule differs "
                 f"from its model-free replay: {summary} vs "
                 f"{replay.summary()}")
            say(f"phase serve {tag}: {len(served)} requests, {n_tok} tokens "
                f"in {wall:.3f} s ({n_tok / wall:.1f} tokens/s), "
                f"{summary['waves']} waves, {summary['steps']} steps, "
                f"launches {json.dumps(counts)} ({rec['kernels']}), "
                f"schedule == model-free replay, relayout "
                f"{summary['relayout_bytes']} B (inter-pod "
                f"{summary['inter_pod_bytes']}), pages attached "
                f"{summary['pages_attached']}, pin_tree "
                f"{json.dumps(moved)}, peak {rec['peak_bytes']} B")
            del srv, served
    need(out["runs"]["paged-fifo"]["tokens_out"]
         == out["runs"]["paged-homed"]["tokens_out"],
         "serve: paged tokens differ between fifo and homed")
    need(out["runs"]["waves-fifo"]["kernels"] == [KERNELS["bfloat16"]],
         f"serve: kernels {out['runs']['waves-fifo']['kernels']}")
    for rec in out["runs"].values():
        rec.pop("tokens_out")

    # torch.profiler over one more aligned-wave run: the kernel launches
    # it sees must be those the wrapper counts
    srv = server("waves", "fifo")
    ops.reset_launches()
    seen = profiled_kernels(srv.run, [KERNELS["bfloat16"]])
    counted = ops.launch_counts()["flash_attention"]
    out["profiler"] = dict(seen=seen, counted=counted)
    need(seen[KERNELS["bfloat16"]] == counted > 0,
         f"serve: the profiler saw {seen}, the wrapper counted {counted}")

    # the first aligned wave's prefill batch: the kernel's shapes there
    first = sorted(streams["waves"], key=lambda d: d["t_arrive"])
    wave = [d["prompt"] for d in first[:SERVE_SLOTS]]
    S = max(len(w) for w in wave)
    toks = torch.zeros(SERVE_SLOTS, S, dtype=torch.long)
    for i, w in enumerate(wave):
        toks[i, S - len(w):] = torch.from_numpy(w)
    toks = toks.cuda()
    shapes = sorted({f.call[1][:6] for f in recorded})
    out["kernel_shapes"] = [list(s) for s in shapes]

    # the kernel at every prefill shape of the serve runs against its plain
    # version; timed at the first wave's (the largest)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    out["kernel_checks"] = {}
    for (b, h, kv, sq, skv, d) in shapes:
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16).cuda() for a in
                   make_attention_inputs(b, h, kv, sq, skv, d, "bfloat16",
                                         seed))
        with untimed():
            got = ops.flash_attention(q, k, v, causal=True)
        plain = flash_attention_reference(q, k, v, causal=True)
        out["kernel_checks"][f"{b}x{h}x{kv}x{sq}x{d}"] = dict(
            beyond=beyond(got, plain, rtol, atol),
            max_abs_err=float((got.float() - plain.float()).abs().max()))
        del q, k, v, got, plain
    need(all(c["beyond"] == 0 for c in out["kernel_checks"].values()),
         f"serve: flash_attention outside rtol={rtol} atol={atol}: "
         f"{out['kernel_checks']}")
    B = SERVE_SLOTS
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).cuda() for a in
               make_attention_inputs(B, H, KV, S, S, hd, "bfloat16", seed))
    with untimed():
        got = ops.flash_attention(q, k, v, causal=True)
    plain = flash_attention_reference(q, k, v, causal=True)
    flops, nbytes = attention_work(B, H, KV, S, hd, 0, 2)
    kern = dict(
        shape=[B, H, KV, S, hd], beyond=beyond(got, plain, rtol, atol),
        max_abs_err=float((got.float() - plain.float()).abs().max()),
        ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                   reps=20),
        plain_ms=cuda_ms(lambda: flash_attention_reference(
            q, k, v, causal=True), reps=1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=10),
        ops_ms=flops / 989e12 * 1e3, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    kern["bound_ms"] = max(kern["ops_ms"], kern["bytes_ms"])
    kern["bound_by"] = ("operations" if kern["ops_ms"] >= kern["bytes_ms"]
                        else "bytes")

    def layout():
        # the model's four copies: q, k, v into the kernel's (B, H, S, hd),
        # the output back (the same bytes, the other way round here)
        return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), got.transpose(1, 2).contiguous())
    kern["layout_ms"] = cuda_ms(layout, reps=10)
    out["kernel"] = kern
    need(kern["beyond"] == 0, f"serve: flash_attention outside rtol={rtol} "
                              f"atol={atol} at {kern['shape']}: {kern}")
    del q, k, v, got, plain
    say(f"phase serve kernel: flash_attention at the prefill's (B, H, KV, S,"
        f" hd) = {kern['shape']} bf16 (shapes the serve runs gave it: "
        f"{out['kernel_shapes']}): {kern['ms']:.4f} ms, plain "
        f"{kern['plain_ms']:.3f} ms, SDPA {kern['library_ms']:.4f} ms, bound "
        f"{kern['bound_ms']:.4f} ms ({kern['bound_by']}), the model's layout "
        f"transposes {kern['layout_ms']:.4f} ms; max err "
        f"{kern['max_abs_err']:.3g} (rtol={rtol:.3g} atol={atol:.3g}); "
        f"against the plain version at every shape "
        + json.dumps(out["kernel_checks"]))

    # the prefill's logits through the kernel against the plain chunked
    # form on the card, bf16 (the served model) and float32; then the
    # attention phase's two planted faults in the kernel's place, which
    # must fall outside the same tolerance
    plain_model = LM(cfg, flash=False)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    runs = {"bfloat16": (model, plain_model, params, {"tokens": toks}),
            "float32": (LM(cfg32), LM(cfg32, flash=False), p32,
                        {"tokens": toks[:LOGIT_ROWS_F32]})}
    faults = {"dropped_tile": lambda q, k, v, causal: dropped_tile_attention(
                  q, k, v, 0, ATTN_BLOCK),
              "scale_1pct": lambda q, k, v, causal: flash_attention_reference(
                  q, k, v, causal=causal, scale=1.01 * q.shape[-1] ** -0.5)}
    out["logits"] = {}
    for dt, (flash_lm, plain_lm, prm, batch) in runs.items():
        with untimed():
            a, _ = flash_lm.prefill(prm, batch, max_len=SERVE_MAX_LEN)
        b, _ = plain_lm.prefill(prm, batch, max_len=SERVE_MAX_LEN)
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        rec = out["logits"][dt] = dict(
            max_abs_err=float((a - b).abs().max()), max_abs_logit=scale,
            tol=LOGIT_TOL[dt], argmax_agree=float(
                (a.argmax(-1) == b.argmax(-1)).float().mean()),
            finite=bool(torch.isfinite(a).all()), faults={})
        rec["rel"] = rec["max_abs_err"] / scale
        for fault, wrong in faults.items():
            with mock.patch.object(ops, "flash_attention", wrong):
                w, _ = flash_lm.prefill(prm, batch, max_len=SERVE_MAX_LEN)
            rec["faults"][fault] = float((w.float() - b).abs().max()) / scale
            del w
        del a, b
    del p32, runs
    say("phase serve logits: prefill through the kernel vs the plain chunked "
        "form on the card, and the planted faults, each as its largest "
        "difference over the largest |logit| " + json.dumps(out["logits"]))
    for dt, rec in out["logits"].items():
        need(rec["finite"] and rec["rel"] <= LOGIT_TOL[dt],
             f"serve: {dt} prefill logits through the kernel differ from the "
             f"plain chunked form by {rec['rel']} of the largest |logit| "
             f"(tolerance {LOGIT_TOL[dt]})")
        need(all(f > LOGIT_TOL[dt] for f in rec["faults"].values()),
             f"serve: a planted fault's {dt} prefill logits pass the "
             f"tolerance {LOGIT_TOL[dt]}: {rec['faults']}")

    # the costs of one wave: prefill, a decode step, the pin_tree copy
    srv = server("waves", "fifo")
    prefill = lambda: model.prefill(params, {"tokens": toks},  # noqa: E731
                                    max_len=SERVE_MAX_LEN)
    _, caches = prefill()
    batch = {"tokens": toks[:, -1:].contiguous()}
    reset_relayouts()
    pinned = locale.pin_tree(caches, dim=1, size=SERVE_SLOTS)
    moved = relayout_counts()
    del pinned
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    srv._decode(params, caches, batch, S)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        srv._decode(params, caches, batch, S)
    torch.cuda.synchronize()
    host_step = (time.perf_counter() - t0) / 3 * 1e3
    step = lambda: srv._decode(params, caches, batch, S)  # noqa: E731
    costs = dict(
        prefill_ms=cuda_ms(prefill, reps=3),
        prefill_busy_ms=device_busy_ms(prefill),
        decode_step_busy_ms=device_busy_ms(step),
        prefill_plain_ms=cuda_ms(lambda: plain_model.prefill(
            params, {"tokens": toks}, max_len=SERVE_MAX_LEN), reps=1),
        decode_step_ms=cuda_ms(step, reps=5),
        decode_step_host_ms=host_step,
        decode_model_ms=cuda_ms(lambda: model.decode_step(
            params, caches, batch, S), reps=5),
        pin_tree_ms=cuda_ms(lambda: locale.pin_tree(caches, dim=1,
                                                    size=SERVE_SLOTS), reps=5),
        pin_tree_moved=moved, cache_bytes=cache_bytes,
        param_bytes=sum(t.numel() * t.element_size()
                        for t in tree_leaves(params)),
        prefill_shape=[SERVE_SLOTS, S])
    out["costs"] = costs
    del caches, srv
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase serve costs: {SERVE_ARCH} ({n_params} parameters, "
        f"{costs['param_bytes']} B) prefill of ({SERVE_SLOTS}, {S}) "
        f"{costs['prefill_ms']:.2f} ms (plain attention "
        f"{costs['prefill_plain_ms']:.2f} ms; kernels busy "
        f"{costs['prefill_busy_ms']:.2f} ms of it); decode step "
        f"{costs['decode_step_ms']:.2f} ms by CUDA events, "
        f"{costs['decode_step_host_ms']:.2f} ms by the host clock (the model "
        f"alone {costs['decode_model_ms']:.2f} ms; kernels busy "
        f"{costs['decode_step_busy_ms']:.2f} ms of the step); pin_tree of the "
        f"{cache_bytes} B cache {costs['pin_tree_ms']:.2f} ms, moved "
        f"{json.dumps(moved)}; profiler saw {json.dumps(seen)} launches, the "
        f"wrapper counted {counted}; phase {out['seconds']:.1f} s")
    out["recorded"] = recorded
    out["line_launches"] = out["runs"]["waves-fifo"]["launches"].get(
        "flash_attention", 0)
    return out


#: the train phase: qwen3-0.6b at full width in bf16 (remat on, the plain
#: chunked attention: the kernel has no backward pass) through `Trainer` on
#: the card, at the sequence length of the reference's ``train_4k`` shape
#: with its global batch cut from 256 to 2 (8192 tokens a step: one card,
#: and the phase's time); 12 steps with a checkpoint at step 6, then a
#: second trainer resumes from it.  Both run in a child process with
#: ``torch.use_deterministic_algorithms(True)`` (the embedding's backward
#: accumulates with atomics otherwise), which needs CUBLAS_WORKSPACE_CONFIG
#: before CUDA starts, and keeps the setting out of the other phases
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "qwen3-0.6b", 4096, 2
#: a peak LR above `TrainerConfig`'s 3e-4: at 3e-4 twelve steps of two
#: rows each left the loss within its batch-to-batch spread (H100, seed 0:
#: 12.138 -> 12.174)
TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_WARMUP, TRAIN_LR = 12, 6, 2, 1e-3
#: the resumed run's losses against the straight run's: the reference's own
#: resume bound (tests/test_runtime.py)
TRAIN_RESUME_RTOL = 1e-5
TRAIN_TIMEOUT_S = 600
BF16_OPS_PER_S = 989e12           # H100 SXM bf16 dense, tensor cores


def train_flops(cfg, B: int, S: int) -> dict:
    """Model FLOPs of one train step: 6 x the matmul parameters (the
    projections, the MLP and the head; not the embedding's gather) x the
    tokens, plus causal attention's two products, 2 x 2 x B H S^2 hd a
    layer forward halved by the causal mask, x 3 for forward and
    backward."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, Fd, Vp = cfg.num_layers, cfg.d_ff, cfg.vocab_padded
    n_matmul = L * (D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * Fd) \
        + D * Vp
    matmul = 6 * n_matmul * B * S
    attention = 3 * L * 2 * B * H * S * S * hd
    return {"n_matmul": n_matmul, "tokens": B * S, "matmul": matmul,
            "attention": attention, "total": matmul + attention,
            "formula": "6 * n_matmul * tokens + 6 * L * B * H * S^2 * hd"}


def train_child(seed: int) -> dict:
    """The train phase's runs on the card (see `phase_train`): a straight
    run of `TRAIN_STEPS` steps, a resumed run from its step-6 checkpoint,
    the busy time of one step by part, the flash guard."""
    import shutil
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import LM, steps
    from repro_torch.runtime import trainer as trainer_mod
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves as ordered_leaves
    from repro_torch.tree import tree_unflatten

    torch.use_deterministic_algorithms(True)
    cfg = get_config(TRAIN_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    writes, reads = [], []
    real_save, real_restore = ckpt_mod.save, trainer_mod.restore

    def timed(fn, into):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            into.append(time.perf_counter() - t0)
            return r
        return call

    def trainer(tag):
        tr = Trainer(cfg, TrainerConfig(
            steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            ckpt_dir=tmp, ckpt_every=TRAIN_CKPT_AT, log_every=1, seed=seed,
            warmup=TRAIN_WARMUP, lr=TRAIN_LR, device="cuda",
            metrics_path=os.path.join(tmp, f"{tag}.json")))
        inner, times, copies = tr.step_fn, [], []

        def step_fn(params, opt_state, batch, accept=None):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            r = inner(params, opt_state, batch, accept)
            b.record()
            torch.cuda.synchronize()
            times.append((a, b, time.perf_counter() - t0))
            return r
        tr.step_fn = step_fn
        maybe_save = tr.ckpt.maybe_save

        def timed_save(*a, **kw):       # the blocking part: the host copy
            t0 = time.perf_counter()
            saved = maybe_save(*a, **kw)
            if saved:
                copies.append(time.perf_counter() - t0)
            return saved
        tr.ckpt.maybe_save = timed_save
        return tr, times, copies

    def log_of(tag):
        with open(os.path.join(tmp, f"{tag}.json")) as f:
            return json.load(f)

    out = {"arch": TRAIN_ARCH, "global_batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "deterministic": torch.are_deterministic_algorithms_enabled(),
           "flops": train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)}
    try:
        with mock.patch.object(ckpt_mod, "save", timed(real_save, writes)), \
                mock.patch.object(trainer_mod, "restore",
                                  timed(real_restore, reads)):
            tr, times, copies = trainer("straight")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = tr.run()
            out["straight_s"] = time.perf_counter() - t0
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            out["launches"] = {k: v for k, v in ops.launch_counts().items()
                               if v}
            leaves = tree_leaves(res["params"])
            out["params"] = sum(t.numel() for t in leaves)
            out["param_bytes"] = sum(t.numel() * t.element_size()
                                     for t in leaves)
            last = os.path.join(tmp, f"step_{TRAIN_STEPS:08d}")
            out["ckpt_bytes"] = sum(os.path.getsize(os.path.join(last, f))
                                    for f in os.listdir(last))
            out["ckpt_files"] = len(os.listdir(last))
            out["straight"] = log_of("straight")
            # the loss of step 1's batch before and after the run, the
            # same batch both times (the logged losses are of 12 batches)
            first = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed,
                                device="cuda").batch(0)
            loss_of = steps.make_loss_fn(tr.model, cfg)
            with torch.no_grad():
                init = tr.model.init(torch.Generator(
                    device=tr.device).manual_seed(seed))
                out["batch0_loss"] = [float(loss_of(p, first)[1])
                                      for p in (init, res["params"])]
            del init, first
            out["step_ms"] = [a.elapsed_time(b) for a, b, _ in times]
            out["step_host_ms"] = [h * 1e3 for _, _, h in times]
            out["save_host_copy_s"] = list(copies)
            del res, tr, leaves
            torch.cuda.empty_cache()
            shutil.rmtree(last)          # the second trainer resumes at 6
            tr, times, _ = trainer("resumed")
            t0 = time.perf_counter()
            res = tr.run()
            out["resumed_s"] = time.perf_counter() - t0
            out["resumed"] = log_of("resumed")
            out["resumed_step_ms"] = [a.elapsed_time(b) for a, b, _ in times]
            out["save_write_s"], out["restore_s"] = list(writes), list(reads)

        # one more step, by part, each part under its own profiler session
        params = res["params"]
        opt_state = steps.init_opt_state(cfg, tr.opt, params)
        batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed,
                            device="cuda").batch(TRAIN_STEPS)
        leaves = ordered_leaves(params)        # tree_unflatten's order
        ctx = {}

        def forward():
            with torch.enable_grad():
                ctx["logits"] = tr.model.forward(params, batch)[0]

        def loss():
            with torch.enable_grad():
                ctx["loss"] = steps.token_nll(ctx.pop("logits"),
                                              batch["targets"],
                                              cfg.vocab_size)

        def backward():
            ctx["grads"] = tree_unflatten(params, torch.autograd.grad(
                ctx.pop("loss"), leaves))

        def optimizer():
            tr.opt.update(ctx.pop("grads"), opt_state["adam"], params)

        out["busy_ms"] = {name: device_busy_ms(fn) for name, fn in (
            ("forward", forward), ("loss", loss),
            ("backward_with_recompute", backward), ("optimizer", optimizer))}
        out["busy_ms"]["whole_step"] = device_busy_ms(
            lambda: tr.step_fn(params, opt_state, batch))

        # the guard: LM(cfg) (flash=True) under autograd must raise
        small = {k: v[:1, :128] for k, v in batch.items()}
        ops.reset_launches()
        try:
            steps.make_loss_fn(LM(cfg), cfg)(params, small)
            out["guard"] = "did not raise"
        except RuntimeError as e:
            out["guard"] = str(e)
        out["guard_launches"] = ops.launch_counts()["flash_attention"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_train(seed: int, smi: str) -> dict:
    """Training at qwen3-0.6b full width (see the module docstring, 8c):
    the runs in a child process (`train_child`), checked here."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()          # the child needs ~33 GB of the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        path = os.path.join(d, "train.json")
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--train-child", path, "--seed", str(seed)],
                           env=env, timeout=TRAIN_TIMEOUT_S)
        need(r.returncode == 0, f"train: the child process exited "
                                f"{r.returncode}")
        with open(path) as f:
            out = json.load(f)
    out["seconds"] = time.perf_counter() - t_phase
    cfg_flops = out["flops"]
    straight = {rec["step"]: rec["loss"] for rec in out["straight"]}
    resumed = {rec["step"]: rec["loss"] for rec in out["resumed"]}
    need(sorted(straight) == list(range(1, TRAIN_STEPS + 1)),
         f"train: the straight run logged steps {sorted(straight)}")
    need(sorted(resumed) == list(range(TRAIN_CKPT_AT + 1, TRAIN_STEPS + 1)),
         f"train: the resumed run logged steps {sorted(resumed)} (it must "
         f"resume at step {TRAIN_CKPT_AT})")
    rel = max(abs(resumed[s] - straight[s]) / abs(straight[s])
              for s in resumed)
    out["resume_max_rel"] = rel
    finite = all(math.isfinite(v) for v in list(straight.values())
                 + list(resumed.values()))
    timed = out["step_ms"][2:]
    host = out["step_host_ms"][2:]
    med, med_host = statistics.median(timed), statistics.median(host)
    out.update(
        step_ms_median=med, step_host_ms_median=med_host,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (med_host / 1e3),
        mfu=cfg_flops["total"] / (med / 1e3) / BF16_OPS_PER_S,
        peak_above_params=out["peak_bytes"] - out["param_bytes"])
    say(f"phase train: {TRAIN_ARCH} bf16 ({out['params']} parameters, "
        f"{out['param_bytes']} B), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"remat, plain chunked attention, deterministic algorithms "
        f"{out['deterministic']}; {smi}: step {med:.1f} ms median of steps "
        f"3-{TRAIN_STEPS} by CUDA events, {med_host:.1f} ms by the host "
        f"clock, {out['tokens_per_s']:.0f} tokens/s, model FLOPs "
        f"{cfg_flops['total']:.4g} a step ({cfg_flops['formula']}: "
        f"n_matmul {cfg_flops['n_matmul']}, matmuls "
        f"{cfg_flops['matmul']:.4g}, attention {cfg_flops['attention']:.4g})"
        f" = {100 * out['mfu']:.2f} % of {BF16_OPS_PER_S:.3g} FLOP/s bf16; "
        f"peak {out['peak_bytes']} B, {out['peak_above_params']} B above the "
        f"parameters; launches of the port's kernels {out['launches']}")
    say(f"phase train busy ({smi}): one step's kernel time by part from "
        f"torch.profiler, ms " + json.dumps(
            {k: round(v, 3) for k, v in out["busy_ms"].items()}))
    say(f"phase train checkpoint ({smi}): {out['ckpt_bytes']} B in "
        f"{out['ckpt_files']} files; host copy s "
        f"{[round(v, 3) for v in out['save_host_copy_s']]}, writes s "
        f"{[round(v, 3) for v in out['save_write_s']]}, restore s "
        f"{[round(v, 3) for v in out['restore_s']]}")
    say(f"phase train losses ({smi}): straight "
        + json.dumps([round(straight[s], 5) for s in sorted(straight)])
        + f"; resumed from step {TRAIN_CKPT_AT} "
        + json.dumps([round(resumed[s], 5) for s in sorted(resumed)])
        + f", largest relative difference {rel:.3g} (rtol "
        f"{TRAIN_RESUME_RTOL}); step 1's batch before and after the run "
        f"{out['batch0_loss'][0]:.5f} -> {out['batch0_loss'][1]:.5f}; "
        f"guard: {out['guard']!r} with {out['guard_launches']} launches; "
        f"phase {out['seconds']:.1f} s")
    need(finite, "train: a loss is not finite")
    need(straight[TRAIN_STEPS] < straight[1],
         f"train: the loss went {straight[1]} -> {straight[TRAIN_STEPS]}")
    before, after = out["batch0_loss"]
    need(after < before, f"train: step 1's batch's loss went {before} -> "
                         f"{after} over the run")
    need(rel <= TRAIN_RESUME_RTOL, f"train: the resumed run's losses differ "
                                   f"from the straight run's by {rel}")
    need(not out["launches"], f"train: the training path launched the "
                              f"port's kernels {out['launches']}")
    need("no backward pass" in out["guard"] and out["guard_launches"] == 0,
         f"train: LM(cfg) with flash under autograd: {out['guard']}")
    return out


def tree_leaves(tree) -> list:
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def sched_events(tracer) -> list:
    """The scheduler's and page pool's trace records, without clocks."""
    return json.loads(json.dumps(
        [{k: v for k, v in r.items() if k not in ("ts", "dur", "tid")}
         for r in tracer.records() if r["cat"] in ("sched", "pool")]))


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
    one = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(lambda: one.add_(1.0))
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
            floor_ms=floor_ms,
            findings=[f.format() for f in reports[kind].findings])
        out["mutants"][kind] = rec
    say(f"phase analysis kernel floor: a one-element torch add_ in a CUDA "
        f"graph {floor_ms:.5f} ms a launch ({smi_line()}): the least time "
        f"any launch takes on this card, the floor under the mutants' byte "
        f"bounds")
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
        floor_ms=floor_ms, library_ms=None,
        mismatches=out["mutants"][kind]["mismatches"])
        for kind, fn in fixtures.MUTANTS.items()]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--train-child", metavar="PATH", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    need(torch.cuda.is_available(), "no CUDA device: the port's kernels "
                                    "run on the card only")
    need((SRC / "repro_torch" / "csrc").is_dir(),
         f"no src/repro_torch beside {Path(__file__).name}: run it from a "
         f"checkout of the repo")
    sys.path.insert(0, str(SRC))
    if args.train_child:                 # the train phase's child process
        Path(args.train_child).write_text(json.dumps(train_child(args.seed)))
        return 0
    from repro_torch.core import LocalisationPolicy
    from repro_torch.kernels import _build, ops

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"phase device: {kind} ({smi}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    secs, reports = _build.build_all()
    regs = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
            if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    say(f"phase build: {sorted(_build.sources())} in {secs:.2f} s; ptxas: "
        + " | ".join(regs))
    wgmma = wgmma_instances(ptxas_entries(reports.get("flash_attention",
                                                      "")))
    say("phase build fa_wgmma<HD/BK> (registers, spill bytes, static smem, "
        "ptxas warnings): " + (json.dumps(wgmma) if wgmma else
                               "not rebuilt in this run"))
    sass = sass_check()
    say("phase build fa_wgmma SASS (cuobjdump): " + json.dumps(sass))

    kernels = phase_kernels(args.seed)
    engine = phase_engine(args.seed)
    flat = phase_flagship(args.seed, "flat", {"data": 8}, "data",
                          LocalisationPolicy())
    hier = phase_flagship(args.seed, "hier", {"pod": 2, "data": 4},
                          ("pod", "data"),
                          LocalisationPolicy.hierarchical(inner="hash"))
    ranks = phase_ranks(args.seed)
    constraint = phase_constraint(args.seed)
    fig1 = phase_fig1(args.seed)
    attention = phase_attention(args.seed)
    serve = phase_serve(args.seed)
    train = phase_train(args.seed, smi)
    dtypes = phase_dtypes(args.seed)
    full_width = {
        "flagship": flat.pop("recorded") + hier.pop("recorded")
        + constraint.pop("recorded"),
        "fig1": fig1.pop("recorded"),
        "attention": {**attention.pop("recorded"),
                      "serve": serve.pop("recorded")}}
    analysis = phase_analysis(args.seed, full_width)
    # last: the CPU sorts would load the host under the timed phases
    check_dtypes_on_cpu(dtypes, args.seed)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "mismatches")
    rows = [dict(kernels[name], launches=flat["launches"][name])
            for name in ("local_sort", "merge_split")]
    # merge_runs' path is the default backend: the case 8 flagship's run
    rows.append(dict(kernels["merge_runs"], launches=constraint[
        "flagship_case8"]["launches"]["merge_runs"]))
    # flash_attention's path is the serve phase's prefill: its launches
    # there; its times stay at the attention phase's shape, as in earlier
    # lines, with the prefill's shape and times beside them
    attention["line"].update(
        launches=serve["line_launches"],
        attention_launches=attention["line"]["launches"],
        max_abs_err=max(attention["line"]["max_abs_err"],
                        serve["kernel"]["max_abs_err"]),
        **{f"serve_{k}": serve["kernel"][k]
           for k in SERVE_LINE_KEYS})
    rows += [kernels["bitonic_sort"], fig1["line"], attention["line"]]
    rows += analysis.pop("lines")
    # each kernel's launches in each rank of the ranks phase's counted
    # flat run (one rank a home, 8 ranks sharing the card)
    for row in rows:
        row["rank_launches"] = ranks["rank_launches"][row["name"]]
    extra = ("scratch_bytes", "launches_per_call", "by_kernel",
             "yardstick_ms", "yardstick", "shape", "attention_launches",
             "floor_ms", "rank_launches",
             *(f"serve_{k}" for k in SERVE_LINE_KEYS))
    line = [{key: k[key] for key in keys + extra if key in k} for k in rows]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": kind, "smi": smi, "build_s": secs, "kernels": kernels,
             "engine": engine, "flat": flat, "hier": hier, "ranks": ranks,
             "constraint": constraint, "fig1": fig1, "attention": attention,
             "serve": serve, "train": train, "dtypes": dtypes,
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
