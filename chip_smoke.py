#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py [--seed S] [--out results.json]

Run from the root of a checkout, on a machine with one CUDA card (an H100
is the target: the kernels are built for sm_90a).  Phases, one line each:

  1. device   — the card's name and `nvidia-smi` name and power limit;
  2. build    — every kernel of ``src/repro_torch/csrc`` built with nvcc,
                with `-Xptxas -v`'s registers and spills; the attention
                kernels' registers, spills and shared memory by instance
                (`fa_wgmma` bf16 and f16, `fa_kernel` f32), and their SASS
                (`cuobjdump`): `fa_wgmma` must hold HGMMA (wgmma) and
                UTMALDG (TMA loads), `fa_kernel` FFMA and LDGSTS
                (cp.async) and no HGMMA;
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
                (e) the constraint tree (the default ``workload("sort")``)
                on the same 8 ranks, the 8 cases x (int32, float32) at
                n = 2^24 + 5; (f) its flagships at n = 100,000,000 int32
                (cases 8, 3 and 4 on {"data": 8}, case 8 on {"pod": 2,
                "data": 4}), timed as (b), with launches (`local_sort`,
                `merge_runs`) by rank as the layouts predict, wire,
                inter-pod and staged bytes and peak by rank, rank 0's
                kernels by `torch.profiler`: every rank's elements equal
                by SHA-256 to the one-process tree's under the final
                layout, every log to `constraint_schedule` op for op, R2
                clean; (g) Fig 1 across the ranks (localised, static
                non-localised, auto; n = 2^24 f32 at R = 2, 8, 32 and
                100 M at R = 8): each rank's chunk equal by SHA-256 to
                the one-process microbench's, R `localised_copy` launches
                a rank, wire bytes the one-process relayout bytes / 8,
                and the gap against R;
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
                (S = 4096, causal, bf16, f32 and f16), the serve prefill
                (16 x 753, f16), mixtral-8x7b (S = 8192, causal, window
                4096, bf16 and f32) and the vision cross layer (512 rows
                over 4096 image tokens, f32) against its plain blocked
                version (and the dense one at the qwen shape) within
                `KERNEL_TOL` (bf16: one rounding step), the kernel each
                dtype ran (`fa_wgmma` bf16 and f16, `fa_kernel` f32) with
                its time, bound and share of it beside SDPA's in the same
                dtype, a non-default `scale` (0.1) at qwen3-0.6b bf16 and
                f32, `fa_wgmma` with P rounded once (no hi + lo split: its
                time and how far it leaves the tolerance, bf16 and f16),
                and two planted faults, a dropped KV tile and a scale 1 %
                off, that must fall outside it on the long rows;
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
                chunked form (bf16 on `fa_wgmma` and float32 on
                `fa_kernel`, 28 launches each, within `LOGIT_TOL`) and
                with the attention phase's two planted faults in the
                kernel's place (outside it), and the costs of a wave:
                prefill, the server's steady decode step (on the homed
                cache, no relayout), the one `pin_tree` copy of the
                cache and, planted, the step on a never-homed cache;
  8f. serve_ranks — `DecodeServer` across 8 gloo ranks sharing the card,
                each serving its home's slots with its blocks of the
                parameters: qwen3-0.6b at full width, 4 of 28 layers (the
                serve phase's stream, 16 slots) on {"data": 8} (8 homes) and on
                {"pod": 2, "data": 2, "model": 2} (4 homes of 2 ranks, the
                heads, KV heads, MLP and vocabulary split), both modes,
                both policies: every rank's collectives equal to
                `serve_schedule` (no cache bytes), the scheduler replicas'
                digests equal, the summary equal to `schedule_replay`'s,
                every request on its home's ranks, 4 `flash_attention`
                launches a prefill wave on every rank, and the picks held
                to the one-process runs on the same homes and depth
                (`SERVE_RANK_TOL`;
                a planted dropped partial sum outside it); tokens/s,
                prefill and decode-step ms, wire, staged and peak bytes by
                rank; then deepseek-moe-16b at full width, 7 of 28
                layers, on {"data": 2, "model": 4} (16 experts a rank) in
                aligned waves under homed, each wave replayed through the
                one-process plain model (`STACK_REPLAY_TOL`); and
                qwen3-0.6b at `reduce_config` in float32, card ranks
                against CPU ranks (a paged run's tokens equal, a prefill's
                and decode steps' logits within rtol 1e-4, atol 1e-5);
                `flash_attention` at every call shape the ranks made
                (their heads of both models, bf16 and float32) against its
                plain version within `KERNEL_TOL`.  With several cards,
                (a) again on an NCCL world of every card, untimed;
  8e. stack   — the rest of the model stack at full width in bf16:
                deepseek-moe-16b (28 layers, 64 experts, top-6, 2 shared)
                and mamba2-2.7b (64 layers) at full width and depth
                through `DecodeServer` in aligned waves, 8 slots homed
                over {"data": 8}, 16 requests of the mixed stream each
                under fifo and homed (deepseek: prompts of 128-256, at
                most 2048 tokens a wave; mamba: prompts of 128-512
                padded to 512, two SSD chunks): mamba's tokens equal
                across the policies, each of deepseek's waves replayed
                through the plain model (every served token the plain
                pick within `STACK_REPLAY_TOL`, a planted wrong token
                outside it), and deepseek's determinism run (prompts all
                256 tokens, a session a request: placements and tokens
                equal across the policies), launches (28
                `flash_attention` a deepseek wave, none for mamba),
                tokens/s, peak, prefill and decode-step
                time (CUDA events, host clock, kernels busy); mamba's
                state handoff (prefill(200) against prefill(199) and one
                decode step, logits and SSM states, a zeroed state as the
                planted fault); mixtral-8x7b at 4 layers of full width:
                a prefill of S = 8192 through the windowed kernel, each of
                its 4 launches against the plain banded form (float32) on
                its own inputs within `KERNEL_TOL`, 4 decode steps over
                the 4096-slot ring; llama-3.2-vision-90b at one superblock of
                full width: the non-causal kernel over 4096 image tokens
                and the causal one at the prompt's shape against their
                plain versions first, then a prefill of (2, 512) (4 causal
                and 1 cross launch) and 4 decode steps through the static
                cross cache, then the prefill again on float32 image
                embeddings (the data pipeline's), whose cross launch runs
                `fa_kernel` at float32, against the plain route within the
                bf16 `LOGIT_TOL`; for both, the prefill's last logits through
                the kernel against the plain chunked form in float32
                within `LOGIT_TOL`, and outside it with a planted fault
                in the windowed (a dropped tile, a scale 1 % off) or the
                cross launch (a dropped tile), the bf16 forms reported
                against the float32 plain one; and all five
                new configs (with jamba-1.5-large-398b, whose one
                full-width superblock does not fit the card) at
                `reduce_config` in float32, card against CPU within rtol
                1e-4, atol 1e-5;
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
                (`torch.profiler`), the checkpoint's bytes and seconds
                (the host shared with the dtypes check's CPU sorts);
  8g. train_ranks — training across 8 gloo ranks sharing the card, in
                bf16 with each config's own parallel knobs: (a) qwen3-0.6b
                at full width and depth on {"data": 2, "model": 4} (the
                sequence-sharded residual, remat), the train phase's rows
                and schedule through `Trainer`, with a checkpoint from
                which a second trainer replays the last step bit for bit;
                (b) granite-20b at full width, 1 of 52 layers, on {"pod":
                2, "data": 2, "model": 2} with FSDP over ("pod", "data")
                and 4 microbatches; (c) both at `reduce_config` in float32,
                card ranks against CPU ranks.  Every rank's collectives
                of every step equal to `train_schedule`, every replicated
                block equal by SHA-256 after every step, the losses and
                step 1's norm within `TRAIN_RANK_LOSS_RTOL` /
                `TRAIN_RANK_NORM_RTOL` of one process's on the same rows
                ((a) the train phase, (b) a child process), planted faults
                outside (rank 0's dp sums skipped, in a step; a gathered
                block from the wrong home, in the loss of a forward), no
                `flash_attention` launch; step time,
                tokens/s, rank 0's busy ms, collectives, wire, inter-pod,
                staged and peak bytes by rank, checkpoint bytes and
                seconds;
  8h. model_split — the members split over "model" and the decode cache
                homed by sequence, across 8 gloo ranks sharing the card,
                each run held to one process's at the same depth on the
                same homes: (a) mamba2-2.7b at full width, 16 of 64
                layers, on {"data": 2, "model": 4} (20 SSD heads a rank,
                the gated norm's statistic summed over "model"): the
                serve_ranks stream's first 16 requests in aligned waves
                padded to 768, 16 slots homed (picks within
                `SERVE_RANK_TOL`), then one
                train step of 2 x 1024 (loss within
                `TRAIN_RANK_LOSS_RTOL`, the norm within
                `TRAIN_RANK_NORM_RTOL` or NaN on both sides, the train
                forward's last logits within `SERVE_RANK_TOL`), the
                statistic left unsummed as the planted fault (outside
                the picks' and the train logits' bound); (b)
                llama-3.2-vision-90b at full width, one superblock, on
                the same mesh: a (2, 512) prefill over 4096 image tokens
                and 4 decode steps, logits within `SERVE_RANK_TOL`, a
                decode step's time and rank 0's busy ms; (c)
                the cache homed by sequence: qwen3-0.6b at 7 layers, one
                slot and a 12,000-token prompt on {"data": 8} (the cache
                over "data", keys on 6 of the 8 ranks' blocks) and
                glm4-9b at 2 layers, 2 slots and prompts of ~6,000 on
                {"data": 2, "model": 4} (over "model": q all-gathered,
                the partials sent to their heads' ranks), 8 decode steps
                each, picks within `SERVE_RANK_TOL`, each rank's cache
                bytes its block's, the blocks' merge against the plain
                attention over the whole cache (a dropped block's
                partial outside); every log equal to its schedule,
                `flash_attention` at every rank call shape (the cross
                layer's (1, 16, 2, 512 x 4096, 128)) against its plain
                version, timed beside SDPA and its bound; tokens/s, step
                ms, collectives and bytes by rank;
  8i. dryrun  — the cost model of one rank's step (`launch.dryrun`)
                held to the card: (a) qwen3-0.6b at full width, no mesh,
                the serve phase's first prefill wave (16, 753) in bf16,
                run by `models.steps.make_prefill_step` under
                `launch.step_cost` and `mem_facts.call_facts` on ``meta``
                (predicted) and then on the card: the 28
                `flash_attention` launches (`LaunchFacts`) equal launch
                for launch, the card's counted FLOPs, HBM bytes and
                live-scan peak equal the dry run's exactly, the
                allocator's peak at least that, the logits through the
                kernel within `LOGIT_TOL` of the plain chunked form, and
                the prefill's milliseconds beside the H100 model's
                compute and memory seconds; (b) the sweep's three
                qwen3-0.6b cells of ``{"data": 16, "model": 16}``, run on
                this host beside the build, equal to the committed
                `results/dryrun_torch/` cells in every count;
  8d. dtypes  — int8, int16, uint8, uint16, uint32, float16 and bfloat16
                through both backends on {"data": 8} at n = 2^24 + 5:
                equal to torch.sort's values, and bit for bit the CPU
                port's result, computed beside the train phase (whose
                child keeps the card busy while the host mostly waits)
                in `CPU_SORT_PROCS` processes sharing the host's cores;
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
                cells (but for R4, which reports the input each returns
                in fresh storage at n = 2^20, and with R10's peak by the
                live scan and the CUDA allocator); the rules again over
                every launch recorded in the
                n = 100 M sorts, the 100 M Fig-1 run and the attention
                cells; for every kernel call recorded, the Python
                launch plan against the C entry's dry-run twin and the
                coverage probe of its output tile maps; then (a) R10's hog
                fixture flagged at 32 MiB with 64 MiB by both the live scan
                and the allocator, (b) `check_decode` clean on the card
                with the CPU's R9 state count, (c) R4 and R10 on one decode
                step of the serve phase's full-width server (its facts
                taken there) on its steady-state cache, homed once by
                `pin_tree`: R4 silent; planted, the same step on a cache
                never homed: R4 reports the whole cache copied, (d) R11
                over every rank's collective log of each run of the
                serve_ranks, train_ranks and model_split phases (each
                run's signature returned by its ranks), and the three
                R11 fixtures on 2 gloo ranks of the card.

Every path's counted run sets the launch counts to 0 just before it and
reads them just after (`bitonic_sort`'s path is ``ops.chunked_sort``).

Then one JSON line of kernels, the `nvidia-smi` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that.
Without a card, or without the repo's ``src/repro_torch`` beside this
file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import gc
import json
import math
import os
import shutil
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


#: seconds the host idles on each side of the recorded step: a session
#: has lost the first kernels of that step (7 of 27 sort launches, and
#: once a rank's first kernel), as if their card timestamps fell before
#: the step's start
PROFILE_GAP_S = 0.05
#: sessions `kernel_breakdown` takes at most to see a call's launches
PROFILE_TRIES = 3


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
        time.sleep(PROFILE_GAP_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_GAP_S)
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
    wrappers record for the active call (`kernels` names them all), in
    one of `PROFILE_TRIES` sessions: a session that loses launches is
    taken again, and the sessions taken are kept under each kernel."""
    from repro_torch.analysis import record
    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
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
        if seen == len(recorded):
            break
    need(seen == len(recorded), f"the profiler saw {seen} launches of "
                                f"{list(kernels)}, the wrappers made "
                                f"{len(recorded)}, in each of {tries} "
                                f"sessions")
    for rec in out.values():
        rec["sessions"] = tries
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


#: the mangled flash-attention kernels' instances: `fa_wgmma<T, HD, BK>`
#: ("bf16/HD/BK", "f16/HD/BK") and `fa_kernel<HD>` ("f32/HD")
FA_INSTANCE = (r"fa_wgmmaI\d+(__nv_bfloat16|__half)Li(\d+)ELi(\d+)E"
               r"|fa_kernelILi(\d+)E")


def fa_instance(name: str):
    """"bf16/HD/BK", "f16/HD/BK" or "f32/HD" of a kernel's mangled name,
    or None."""
    import re
    m = re.search(FA_INSTANCE, name)
    if not m:
        return None
    if m.group(4):
        return f"f32/{m.group(4)}"
    kind = "f16" if m.group(1) == "__half" else "bf16"
    return f"{kind}/{m.group(2)}/{m.group(3)}"


def wgmma_instances(entries: dict) -> dict:
    """The flash-attention entries of `ptxas_entries` (`fa_instance`)."""
    out = {}
    for name, rec in entries.items():
        key = fa_instance(name)
        if key:
            out[key] = rec
    return out


def sass_check() -> dict:
    """`cuobjdump -sass` of the built flash-attention library: each
    `fa_wgmma` instance (bf16 and f16, 8 each) must hold tensor-core
    (HGMMA) and TMA (UTMALDG) instructions, or the 16-bit kernel never
    reached them; each `fa_kernel` instance (4) fp32 FMAs (FFMA) and
    cp.async copies (LDGSTS) and no tensor-core instruction."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    r = subprocess.run([str(tool), "-sass", str(_build._target(
        "flash_attention"))], capture_output=True, text=True, timeout=300)
    need(r.returncode == 0, f"cuobjdump failed: {r.stderr.strip()[:400]}")
    found = {}
    for part in r.stdout.split("Function : ")[1:]:
        key = fa_instance(part.split("\n", 1)[0])
        if key:
            found[key] = {op: part.count(op) for op in
                          ("HGMMA", "UTMALDG", "FFMA", "LDGSTS")}
    wg = {k: n for k, n in found.items() if not k.startswith("f32")}
    f32 = {k: n for k, n in found.items() if k.startswith("f32")}
    need(len(wg) == 16 and len(f32) == 4,
         f"cuobjdump: flash-attention instances {sorted(found)}")
    for key, n in wg.items():
        need(n["HGMMA"] > 0 and n["UTMALDG"] > 0,
             f"fa_wgmma<{key}> SASS lacks HGMMA or UTMALDG: {n}")
    for key, n in f32.items():
        need(n["FFMA"] > 0 and n["LDGSTS"] > 0 and n["HGMMA"] == 0,
             f"fa_kernel<{key}> SASS lacks FFMA or LDGSTS, or holds HGMMA: "
             f"{n}")
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
#: the constraint tree's flagships across ranks, at N_FLAGSHIP int32: tag:
#: (the `RANK_FLAGSHIPS` mesh it runs on, axis, policy name)
TREE_FLAGSHIPS = {"case8": ("flat", "data", "case8"),
                  "case3": ("flat", "data", "case3"),
                  "case4": ("flat", "data", "case4"),
                  "case8_pods": ("hier", ("pod", "data"), "case8")}
#: Fig 1 across ranks: (n float32, the R of each run)
RANK_FIG1 = ((2**24, (2, 8, 32)), (N_FLAGSHIP, (8,)))


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
    schedule, the census and R1/R2; then the constraint tree and Fig 1
    (`tree_child`)."""
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
    del x, qg, sg, total
    out["tree"] = tree_child(device, seed, want["tree"], sizes, meshes)
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


def tree_digests(y: torch.Tensor, shape: dict, axis, policy) -> list:
    """The digest of what each rank of `shape` holds of the one-process
    constraint tree's result `y` (logical order): padded to the rank
    tree's granule, its elements under the tree's final layout (the last
    move of `constraint_schedule`; replicated: the whole)."""
    from repro_torch.core.homing import Layout, positions
    from repro_torch.core.sort import (constraint_schedule, pad_to_multiple,
                                       rank_granule)
    axes = (axis,) if isinstance(axis, str) else axis
    N = math.prod(shape[a] for a in axes)
    y = pad_to_multiple(y, rank_granule(N, policy, None), nan_check=False)
    moves = constraint_schedule(y.numel(), tuple(shape[a] for a in axes),
                                policy)
    lay = moves[-1]["dst"] if moves else Layout("chunked", N)
    return [digest(y[positions(y.numel(), lay, d, y.device)])
            for d in range(N)]


def tree_launches(policy, N: int) -> dict:
    """The constraint tree's launches by home with m = N workers, as its
    layouts predict: a home sorts leaves and merges pair-rows where it
    leads rows (`Layout("leaders", N, rows)`), every home every row under
    replicated (case 4)."""
    from repro_torch.core.homing import Homing, Layout, shares
    levels = N.bit_length() - 1
    if policy.static_mapping and not policy.localised \
            and policy.homing == Homing.LOCAL_CHUNKED:
        return {"local_sort": [1] * N, "merge_runs": [levels] * N}
    leads = [shares(N * N, Layout("leaders", N, N >> j)) > 0
             for j in range(levels + 1)]
    return {"local_sort": [int(h) for h in leads[0]],
            "merge_runs": [int(sum(lv[d] for lv in leads[1:]))
                           for d in range(N)]}


def tree_wants(seed: int, device, sizes: dict) -> dict:
    """What every rank of the tree's part must give, from the one-process
    port on `device`: digests of each rank's elements of the constraint
    tree's result (the 8 cases at n_engine, the flagships at n_flagship),
    and for Fig 1 of each rank's chunk with the one-process relayout
    bytes."""
    from repro_torch.convert import make_fig1_data, make_sort_data
    from repro_torch.core import HomeMesh, Homing, Locale, LocalisationPolicy
    from repro_torch.core.homing import relayout_counts, reset_relayouts
    from repro_torch.launch.sort import policies

    want = {"cases": {}, "flagships": {}, "fig1": {}}
    flat = RANK_FLAGSHIPS["flat"][0]
    for tag, policy in policies(False).items():
        fn = Locale(HomeMesh(flat, device=device), "data", policy).workload(
            "sort")
        k = int(tag.removeprefix("case"))
        for dt in ("int32", "float32"):
            x = torch.from_numpy(make_sort_data(sizes["n_engine"], dt,
                                                seed + k))
            want["cases"][f"case{k}_{dt}"] = tree_digests(
                fn(x.to(device)), flat, "data", policy)
    x = torch.from_numpy(make_sort_data(sizes["n_flagship"], "int32", seed))
    for tag, (mesh_tag, axis, pname) in TREE_FLAGSHIPS.items():
        shape, policy = RANK_FLAGSHIPS[mesh_tag][0], policies(False)[pname]
        fn = Locale(HomeMesh(shape, device=device), axis, policy).workload(
            "sort")
        want["flagships"][tag] = tree_digests(fn(x.to(device)), shape, axis,
                                              policy)
    for n, reps in sizes["fig1"]:
        x = torch.from_numpy(make_fig1_data(n, "float32", seed)).to(device)
        for name, (loc, static, h) in FIG1_POLICIES.items():
            for R in reps:
                reset_relayouts()
                y = Locale(HomeMesh(flat, device=device), "data",
                           LocalisationPolicy(loc, static, Homing(h))
                           ).workload("microbench", reps=R)(x)
                want["fig1"][f"{name}_n{n}_R{R}"] = {
                    "digests": [digest(c) for c in y.view(RANKS, -1)],
                    "bytes": relayout_counts()["bytes"]}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return want


def timed_calls(call, device, calls: int = 3) -> list:
    """Host-clock ms of `calls` calls on every rank, a barrier before
    each (the caller has warmed up)."""
    import torch.distributed as dist
    times = []
    for _ in range(calls):
        dist.barrier()
        sync(device)
        t0 = time.perf_counter()
        call()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def tree_child(device, seed: int, want: dict, sizes: dict, meshes: dict
               ) -> dict:
    """One rank of the ranks phase's tree part: (e) the constraint tree,
    the 8 cases at n_engine; (f) its flagships at n_flagship; (g) Fig 1
    across ranks.  Each result held to the one-process port's by digest,
    each log to `constraint_schedule` and R2."""
    import torch.distributed as dist

    from repro_torch.convert import make_fig1_data, make_sort_data
    from repro_torch.core import Homing, Locale, LocalisationPolicy
    from repro_torch.core import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.launch.sort import policies, rank_report

    rank = dist.get_rank()
    cuda = torch.device(device).type == "cuda"
    flat = meshes["flat"]
    out = {"cases": {}, "flagships": {}, "fig1": {}}
    # (e) the 8 Table-1 cases through the default workload("sort")
    for tag, policy in policies(False).items():
        k = int(tag.removeprefix("case"))
        for dt in ("int32", "float32"):
            fn = Locale(flat, "data", policy).workload("sort")
            share = fn.place(torch.from_numpy(
                make_sort_data(sizes["n_engine"], dt, seed + k)))
            ops.reset_launches()
            coll.reset_collectives()
            y = fn(share)
            sync(device)
            out["cases"][f"case{k}_{dt}"] = {
                "equal": digest(y.data) == want["cases"][f"case{k}_{dt}"][rank],
                "launches": ops.launch_counts(),
                **rank_report(coll.collective_log(), flat, ("data",),
                              sizes["n_engine"], policy, 4,
                              backend="constraint")}
    # (f) the tree's flagships at the paper's size
    for tag, (mesh_tag, axis, pname) in TREE_FLAGSHIPS.items():
        mesh, policy = meshes[mesh_tag], policies(False)[pname]
        axes = (axis,) if isinstance(axis, str) else axis
        fn = Locale(mesh, axis, policy).workload("sort")
        share = fn.place(torch.from_numpy(
            make_sort_data(sizes["n_flagship"], "int32", seed)))
        sync(device)
        # the path's counted run: counts to 0 just before, read after
        ops.reset_launches()
        coll.reset_collectives()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        y = fn(share)
        sync(device)
        res = {"peak_bytes": (torch.cuda.max_memory_allocated() - base
                              if cuda else None),
               "launches": ops.launch_counts(),
               "staged": coll.staged_bytes(),
               "wire": sum(r["wire_bytes"] for r in coll.LOG),
               "inter_pod": sum(r["inter_pod_bytes"] for r in coll.LOG),
               "equal": digest(y.data) == want["flagships"][tag][rank],
               **rank_report(coll.collective_log(), mesh, axes,
                             sizes["n_flagship"], policy, 4,
                             backend="constraint")}
        del y
        res["times_ms"] = timed_calls(lambda: fn(share), device)
        if rank == 0 and cuda:
            prof = profile_call(lambda: fn(share))
            res["kernel_ms"] = device_ms_by(prof, CONSTRAINT_KERNELS)
        else:
            fn(share)
            sync(device)
        out["flagships"][tag] = res
        del share
    # (g) Fig 1 across ranks: each rank passes over its own chunk
    for n, reps in sizes["fig1"]:
        x = torch.from_numpy(make_fig1_data(n, "float32", seed))
        for name, (loc, static, h) in FIG1_POLICIES.items():
            for R in reps:
                key = f"{name}_n{n}_R{R}"
                fn = Locale(flat, "data", LocalisationPolicy(
                    loc, static, Homing(h))).workload("microbench", reps=R)
                chunk = fn.place(x)
                sync(device)
                ops.reset_launches()
                coll.reset_collectives()
                y = fn(chunk)
                sync(device)
                res = {"equal": digest(y) == want["fig1"][key]["digests"][rank],
                       "launches": ops.launch_counts()["localised_copy"],
                       "wire": sum(r["wire_bytes"] for r in coll.LOG),
                       "kinds": sorted({r["kind"] for r in coll.LOG}),
                       "collectives": len(coll.LOG),
                       "staged": coll.staged_bytes()}
                del y
                res["times_ms"] = timed_calls(lambda: fn(chunk), device)
                out["fig1"][key] = res
    return out


def tree_summary(ranks: list, device, sizes: dict) -> dict:
    """Check and print the ranks' tree part (`tree_child`): every rank's
    elements equal to the one-process port's, its log to
    `constraint_schedule`, R2 clean, its launches as the layouts predict;
    Fig 1's wire bytes the one-process relayout bytes / RANKS."""
    from repro_torch.launch.sort import policies
    cuda = torch.device(device).type == "cuda"
    for r in ranks:
        t = r["tree"]
        for key, res in list(t["cases"].items()) + list(
                t["flagships"].items()):
            what = f"ranks tree: rank {r['rank']} {key}"
            need(res["equal"], f"{what}: its elements differ from the "
                               f"one-process constraint tree's")
            need(not res["schedule"], f"{what}: {res['schedule']}")
            need(not res["findings"], f"{what}: R2 {res['findings']}")
    for key in ranks[0]["tree"]["cases"]:
        policy = policies(False)[key.split("_")[0]]
        want = tree_launches(policy, RANKS)
        for k in ("local_sort", "merge_runs"):
            got = [r["tree"]["cases"][key]["launches"][k] for r in ranks]
            need(not cuda or got == want[k], f"ranks tree {key}: {k} "
                 f"launches by rank {got}, the layouts predict {want[k]}")
    out = {"flagships": {}, "fig1": {}}
    say(f"phase ranks (e): the constraint tree (the default "
        f"workload('sort')) on {RANKS} gloo ranks, the 8 Table-1 cases x "
        f"(int32, float32) at n={sizes['n_engine']}: every rank's elements "
        f"equal by SHA-256 to the one-process HomeMesh tree's under the "
        f"final layout; every rank's collectives equal to "
        f"constraint_schedule op for op; R2 clean; launches by rank as the "
        f"layouts predict")
    for tag, (mesh_tag, axis, pname) in TREE_FLAGSHIPS.items():
        rs = [r["tree"]["flagships"][tag] for r in ranks]
        times = [max(r["times_ms"][i] for r in rs) for i in range(3)]
        policy = policies(False)[pname]
        launches = {k: [r["launches"][k] for r in rs]
                    for k in ("local_sort", "merge_runs")}
        want = tree_launches(policy, RANKS)
        if cuda:
            need(launches == want, f"ranks tree {tag}: launches by rank "
                                   f"{launches}, the layouts predict {want}")
            kms = rs[0]["kernel_ms"]
            need({"local_sort", "merge_runs"} <= set(kms),
                 f"ranks tree {tag}: torch.profiler saw {kms} in rank 0")
        res = {"median_ms": statistics.median(times), "times_ms": times,
               "rank_times_ms": [r["times_ms"] for r in rs],
               "launches": launches,
               "wire_bytes": [r["wire"] for r in rs],
               "inter_pod_bytes": [r["inter_pod"] for r in rs],
               "staged_bytes": [r["staged"] for r in rs],
               "peak_bytes": [r["peak_bytes"] for r in rs],
               "kernel_ms_rank0": rs[0].get("kernel_ms")}
        out["flagships"][tag] = res
        say(f"phase ranks (f) tree {tag}: n={sizes['n_flagship']} int32 on "
            f"{RANK_FLAGSHIPS[mesh_tag][0]}, {policy.name}: median "
            f"{res['median_ms']:.3f} ms of 3 (slowest rank a call: "
            f"{', '.join(f'{t:.3f}' for t in times)}); elements equal to the "
            f"HomeMesh tree's; launches by rank {launches}; wire bytes by "
            f"rank {res['wire_bytes']} (sum {sum(res['wire_bytes'])}; == "
            f"constraint_schedule, op for op; R2 clean); inter-pod "
            f"{res['inter_pod_bytes']}; staged bytes by rank "
            f"{res['staged_bytes']}; peak bytes by rank {res['peak_bytes']}; "
            f"rank 0's device ms and launches by wrapper (torch.profiler) "
            + (by_wrapper(res["kernel_ms_rank0"])
               if res["kernel_ms_rank0"] else "not profiled"))
    want_fig1 = ranks[0]["tree"]["fig1"]
    for key in want_fig1:
        rs = [r["tree"]["fig1"][key] for r in ranks]
        R = int(key.rsplit("_R", 1)[1])
        for i, r in enumerate(rs):
            need(r["equal"], f"ranks fig1 {key} rank {i}: its chunk differs "
                             f"from the one-process microbench's")
            need(not cuda or r["launches"] == R,
                 f"ranks fig1 {key} rank {i}: {r['launches']} launches")
        times = [max(r["times_ms"][i] for r in rs) for i in range(3)]
        out["fig1"][key] = {"median_ms": statistics.median(times),
                            "times_ms": times,
                            "wire_bytes": [r["wire"] for r in rs],
                            "staged_bytes": [r["staged"] for r in rs],
                            "collectives": rs[0]["collectives"]}
    return out


def check_fig1_bytes(out: dict, want: dict) -> None:
    """Each rank's Fig-1 wire bytes are the one-process relayout bytes /
    RANKS; print the gap, non-localised over localised, against R."""
    gaps = {}
    for key, res in out["fig1"].items():
        home = want["fig1"][key]["bytes"]
        need(all(w * RANKS == home for w in res["wire_bytes"]),
             f"ranks fig1 {key}: wire bytes by rank {res['wire_bytes']}, "
             f"the one-process relayouts {home} B / {RANKS}")
    for n, reps in RANK_FIG1:
        for R in reps:
            row = {p: out["fig1"][f"{p}_n{n}_R{R}"]["median_ms"]
                   for p in FIG1_POLICIES}
            row["gap"] = row["nonlocalised"] / row["localised"]
            gaps[f"n{n}_R{R}"] = row
    out["fig1_gap"] = gaps
    say(f"phase ranks (g) fig1 across {RANKS} ranks: median ms of 3, the "
        f"slowest rank (localised, nonlocalised, auto; gap), chunks equal by "
        f"SHA-256 to the one-process microbench's, wire bytes by rank == "
        f"the one-process relayout bytes / {RANKS} "
        + json.dumps({k: [round(v[p], 3) for p in FIG1_POLICIES]
                      + [round(v["gap"], 3)] for k, v in gaps.items()})
        + "; wire bytes a rank " + json.dumps(
            {k: v["wire_bytes"][0] for k, v in out["fig1"].items()
             if k.startswith("nonlocalised")}))


def phase_ranks(seed: int, device="cuda") -> dict:
    """The engine with one rank a home: 8 gloo ranks sharing the card,
    then an NCCL world of every card (see the module docstring)."""
    from repro_torch.core import exchange_schedule
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.sort import policies

    t_phase = time.perf_counter()
    sizes = {"n_engine": N_ENGINE, "n_flagship": N_FLAGSHIP,
             "psum": PSUM_SHAPE, "fig1": RANK_FIG1}
    want = rank_wants(seed, device)
    want["tree"] = tree_wants(seed, device, sizes)
    t0 = time.perf_counter()
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
    out["tree"] = tree_summary(ranks, device, sizes)
    check_fig1_bytes(out["tree"], want["tree"])
    # each kernel's launches by rank in the counted runs of the main paths
    # across ranks: the engine's flat flagship, the constraint tree's case
    # 8 flagship and Fig 1's localised run at the largest n
    fig1_key = "localised_n{}_R{}".format(*max(
        (n, max(reps)) for n, reps in RANK_FIG1))
    paths = {"engine": [r["flagships"]["flat"]["launches"] for r in ranks],
             "constraint": [r["tree"]["flagships"]["case8"]["launches"]
                            for r in ranks],
             "fig1": [{"localised_copy": r["tree"]["fig1"][fig1_key][
                 "launches"]} for r in ranks]}
    out["rank_launches"] = {
        k: {path: [c.get(k, 0) for c in counts]
            for path, counts in paths.items()}
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


#: processes the CPU reference sorts run in, each on its share of the cores
CPU_SORT_PROCS = 4


def cpu_sort(dt: str, backend: str, seed: int, n: int, threads: int):
    """One CPU port sort of `dtype_inputs`' `dt` input at `n` (a worker of
    `cpu_reference`): ``(result, seconds)``."""
    from repro_torch.convert import NARROW_SORT_DTYPES, make_sort_data
    from repro_torch.core import HomeMesh, Locale, LocalisationPolicy
    torch.set_num_threads(threads)
    i = NARROW_SORT_DTYPES.index(dt)
    x = torch.from_numpy(make_sort_data(n, dt, seed + 50 + i)).to(
        getattr(torch, dt))
    t0 = time.perf_counter()
    y = Locale(HomeMesh({"data": 8}, device="cpu"), "data",
               LocalisationPolicy()).workload("sort", backend=backend)(x)
    return y, time.perf_counter() - t0


def cpu_reference(seed: int, n: int = None) -> tuple:
    """The CPU port's sorts of `dtype_inputs` (at `n`, default
    ``N_ENGINE``), both backends, in `CPU_SORT_PROCS` processes of
    ``os.cpu_count() // CPU_SORT_PROCS`` threads each (the plain bitonic
    network over 2^21 + 1-key leaves is most of a sort).  Returns
    ``({tag: result}, {tag: seconds}, wall seconds)``."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from repro_torch.convert import NARROW_SORT_DTYPES
    n = n or N_ENGINE
    threads = max(1, (os.cpu_count() or 1) // CPU_SORT_PROCS)
    tags = [(dt, b) for dt in NARROW_SORT_DTYPES for b in SORT_BACKENDS]
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(CPU_SORT_PROCS,
                                mp_context=mp.get_context("spawn")) as pool:
        futs = {f"{dt}_{b}": pool.submit(cpu_sort, dt, b, seed, n, threads)
                for dt, b in tags}
        done = {tag: f.result() for tag, f in futs.items()}
    return ({tag: y for tag, (y, _) in done.items()},
            {tag: s for tag, (_, s) in done.items()},
            time.perf_counter() - t0)


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


def check_dtypes_on_cpu(dtypes: dict, cpu: tuple) -> None:
    """Hold each card result of `phase_dtypes` bit for bit to the CPU
    port's for the same input (`cpu`, what `cpu_reference` returned: it
    runs beside the train phase)."""
    cpu, dtypes["cpu_sort_seconds"], dtypes["cpu_seconds"] = cpu
    dtypes["mismatches_vs_cpu"] = {
        tag: mismatches(y, cpu[tag]) for tag, y in dtypes.pop("results").items()}
    say(f"phase dtypes on the CPU: the CPU port's {len(cpu)} results in "
        f"{dtypes['cpu_seconds']:.1f} s beside the train phase "
        f"({CPU_SORT_PROCS} processes of "
        f"{max(1, (os.cpu_count() or 1) // CPU_SORT_PROCS)} threads; "
        f"seconds by sort " + json.dumps(
            {k: round(v, 2) for k, v in dtypes["cpu_sort_seconds"].items()})
        + "), mismatches " + json.dumps(dtypes["mismatches_vs_cpu"]))
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


def attention_work(q, k, causal: bool = True, window: int = 0):
    """(flops, bytes) one `flash_attention` call on q, k needs:
    `flash_attention.work`, the count the dry run's cost uses too."""
    from repro_torch.analysis.launches import dtype_name
    from repro_torch.kernels.flash_attention import work
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    w = work(B, H, KV, Sq, Skv, hd, ATTN_BLOCK, ATTN_BLOCK, causal, window,
             dtype_name(q.dtype))
    return w["flops"], w["bytes"]


#: (B, H, KV, Sq, Skv, hd, causal, window, dtype): the head layouts of
#: src/repro/configs/qwen3_0_6b.py and mixtral_8x7b.py, causal; the serve
#: phase's prefill (16 slots of 753 tokens, qwen3-0.6b); the cross layer
#: of llama_3_2_vision_90b.py, 512 text rows over its 4096 image tokens
#: (float32: what the data pipeline's float32 image embeddings promote it
#: to)
ATTN_CELLS = {
    "qwen3-0.6b_bf16": (1, 16, 8, 4096, 4096, 128, True, 0, "bfloat16"),
    "qwen3-0.6b_f32": (1, 16, 8, 4096, 4096, 128, True, 0, "float32"),
    "qwen3-0.6b_f16": (1, 16, 8, 4096, 4096, 128, True, 0, "float16"),
    "serve-prefill_f16": (16, 16, 8, 753, 753, 128, True, 0, "float16"),
    "mixtral-8x7b_bf16": (1, 32, 8, 8192, 8192, 128, True, 4096, "bfloat16"),
    "mixtral-8x7b_f32": (1, 32, 8, 8192, 8192, 128, True, 4096, "float32"),
    "vision-cross_f32": (2, 64, 8, 512, 4096, 128, False, 0, "float32")}
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


def planted_faults() -> dict:
    """The attention phase's two planted faults as stand-ins for
    `ops.flash_attention` (same arguments): a dropped KV tile -- for
    self-attention the row's oldest live tile (`dropped_tile_attention`),
    for cross attention (not causal, keys 0 .. Skv-1 for every row) the
    first tile of keys -- and a scale 1 % off."""
    from repro_torch.kernels.flash_attention import flash_attention_reference

    def dropped_tile(q, k, v, causal=True, window=0):
        if causal:
            return dropped_tile_attention(q, k, v, window, ATTN_BLOCK)
        return flash_attention_reference(q, k[:, :, ATTN_BLOCK:],
                                         v[:, :, ATTN_BLOCK:], causal=False)

    def scale_1pct(q, k, v, causal=True, window=0):
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         scale=1.01 * q.shape[-1] ** -0.5)
    return {"dropped_tile": dropped_tile, "scale_1pct": scale_1pct}


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
    # the peak of each input type: bfloat16 and float16 run on the tensor
    # cores (fa_wgmma), float32 on the fp32 pipe (fa_kernel)
    peak = {"float32": OPS_32BIT_PER_S, "bfloat16": 989e12,
            "float16": 989e12}
    out = {}
    counted = None
    recorded = {}
    faults = planted_faults()
    for tag, (B, H, KV, S, Skv, hd, causal, window, dt) in \
            ATTN_CELLS.items():
        q, k, v = (torch.from_numpy(a).to(getattr(torch, dt)).cuda() for a in
                   make_attention_inputs(B, H, KV, S, Skv, hd, dt, seed))
        rtol, atol = KERNEL_TOL[q.dtype]
        kw = dict(causal=causal, window=window, block_q=ATTN_BLOCK,
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
        rec = {"kernel": ran[0], "launches": counts["flash_attention"],
               "max_abs_err": float((got.float() - plain.float()).abs().max()),
               "rtol": rtol, "atol": atol,
               "beyond": beyond(got, plain, rtol, atol)}
        if ran[0] == "fa_wgmma" and tag != "mixtral-8x7b_bf16":
            # the design not taken: P rounded once to the 16-bit type
            # before P V
            one = torch.empty_like(q)

            def single():
                _launch(q, k, v, one, causal, window, ATTN_BLOCK, ATTN_BLOCK,
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
        for fault, wrong in faults.items():
            w = wrong(q, k, v, causal=causal, window=window)
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
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        flops, nbytes = attention_work(q, k, causal=causal, window=window)
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
        ref_live = live_tiles(S, Skv, causal=causal, window=window,
                              block_q=ATTN_BLOCK, block_k=ATTN_BLOCK)
        kb = kernel_tiles(S, Skv, ATTN_BLOCK, ATTN_BLOCK, dt)
        ker_live = live_tiles(S, Skv, causal=causal, window=window,
                              block_q=kb[0], block_k=kb[1])
        rec["tiles"] = dict(live=int(ref_live.sum()),
                            skipped=int((~ref_live).sum()),
                            kernel_live=int(ker_live.sum()),
                            kernel_skipped=int((~ker_live).sum()))
        # the products the kernel issues: every live tile whole, P V twice
        # in fa_wgmma (the hi + lo split of P)
        issued = (int(ker_live.sum()) * B * H * 2 * kb[0] * kb[1] * hd
                  * (3 if ran[0] == "fa_wgmma" else 2))
        rec["tflops"] = dict(needed=flops / rec["ms"] / 1e9,
                             issued=issued / rec["ms"] / 1e9)
        rec["profile"] = kernel_breakdown(
            lambda: ops.flash_attention(q, k, v, **kw),
            {name: name for name in KERNELS.values()})
        out[tag] = rec
        say(f"phase attention {tag}: B={B} H={H} KV={KV} Sq={S} Skv={Skv} "
            f"hd={hd} causal={causal} window={window} {dt}: kernel "
            f"{rec['kernel']} "
            f"{rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, SDPA {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{rec['bound_fraction']:.3f} of it); "
            + f"TFLOP/s needed / issued {rec['tflops']['needed']:.1f} / "
            f"{rec['tflops']['issued']:.1f}; profiler "
            + json.dumps(rec["profile"]) + "; "
            + (f"one {dt} P (no split): {json.dumps(rec['single_p'])}; "
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
                       for v in out.values()),
        # each dtype's kernel at the qwen3-0.6b shape, its launches that
        # cell's counted run
        dtype_cells={dt: {"kernel": c["kernel"], "launches": c["launches"],
                          **{k: c[k] for k in (
                              "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "max_abs_err", "bound_fraction")}}
                     for dt, c in ((ATTN_CELLS[t][-1], c) for t, c in
                                   out.items() if t.startswith("qwen"))})
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


def device_events(prof) -> list:
    """``(name, microseconds)`` of every activity the card ran in a
    `profile_call` session (kernels, copies, fills), read from the trace
    as recorded: `key_averages()` first builds the profiler's event lists,
    which took 8.5 s for 100k events of a CPU trace where this takes 0.4 s
    (an 8-core Xeon), and tens of seconds over a whole serve run (H100)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]


def profiled_kernels(fn, names) -> dict:
    """{name: launches} of the kernels whose name holds a name of `names`,
    seen by `torch.profiler` over one call of fn()."""
    events = device_events(profile_call(fn))
    return {name: sum(name in ev for ev, _ in events) for name in names}


def device_busy_ms(fn) -> float:
    """Milliseconds of kernel time on the card over one call of fn(), from
    `torch.profiler`."""
    return sum(us for _, us in device_events(profile_call(fn))) / 1e3


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
    flops, nbytes = attention_work(q, k)
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
    faults = planted_faults()
    out["logits"] = {}
    for dt, (flash_lm, plain_lm, prm, batch) in runs.items():
        ops.reset_launches()                 # the prefill's counted run
        with untimed(), record() as ran:
            a, _ = flash_lm.prefill(prm, batch, max_len=SERVE_MAX_LEN)
        launches = ops.launch_counts()["flash_attention"]
        b, _ = plain_lm.prefill(prm, batch, max_len=SERVE_MAX_LEN)
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        rec = out["logits"][dt] = dict(
            max_abs_err=float((a - b).abs().max()), max_abs_logit=scale,
            tol=LOGIT_TOL[dt], argmax_agree=float(
                (a.argmax(-1) == b.argmax(-1)).float().mean()),
            finite=bool(torch.isfinite(a).all()), faults={},
            kernel=KERNELS[dt], launches=launches,
            kernels=dict(collections.Counter(f.name for f in ran)))
        need(launches == cfg.num_layers
             and rec["kernels"] == {KERNELS[dt]: cfg.num_layers},
             f"serve: the {dt} prefill launched {launches} "
             f"({rec['kernels']}), not {cfg.num_layers} {KERNELS[dt]}")
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

    # the costs of one wave: prefill, the server's steady decode step (on
    # a cache pin_tree has homed, each step's cache, written in place and
    # pinned again with nothing moved, threaded into the next), the one
    # pin_tree copy into the homes and, planted, the step on the
    # prefill's cache, never homed, which pin_tree copies every step
    srv = server("waves", "fifo")
    prefill = lambda: model.prefill(params, {"tokens": toks},  # noqa: E731
                                    max_len=SERVE_MAX_LEN)
    _, caches = prefill()
    batch = {"tokens": toks[:, -1:].contiguous()}
    reset_relayouts()
    steady = {"caches": locale.pin_tree(caches, dim=1, size=SERVE_SLOTS)}
    moved = relayout_counts()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))

    def step():
        _, steady["caches"] = srv._decode(params, steady["caches"], batch, S)
    step()                                           # warm-up
    reset_relayouts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    host_step = (time.perf_counter() - t0) / 3 * 1e3
    costs = dict(
        prefill_ms=cuda_ms(prefill, reps=3),
        prefill_busy_ms=device_busy_ms(prefill),
        decode_step_busy_ms=device_busy_ms(step),
        prefill_plain_ms=cuda_ms(lambda: plain_model.prefill(
            params, {"tokens": toks}, max_len=SERVE_MAX_LEN), reps=1),
        decode_step_ms=cuda_ms(step, reps=5),
        decode_step_host_ms=host_step,
        decode_model_ms=cuda_ms(lambda: model.decode_step(
            params, steady["caches"], batch, S), reps=5),
        pin_tree_ms=cuda_ms(lambda: locale.pin_tree(
            steady["caches"], dim=1, size=SERVE_SLOTS), reps=5),
        steady_moved=relayout_counts(),
        decode_step_unhomed_ms=cuda_ms(lambda: srv._decode(
            params, caches, batch, S), reps=5),
        pin_tree_first_ms=cuda_ms(lambda: locale.pin_tree(
            caches, dim=1, size=SERVE_SLOTS), reps=5),
        pin_tree_moved=moved, cache_bytes=cache_bytes,
        param_bytes=sum(t.numel() * t.element_size()
                        for t in tree_leaves(params)),
        prefill_shape=[SERVE_SLOTS, S])
    need(costs["steady_moved"]["bytes"] == 0,
         f"serve: the steady decode steps relaid out their homed cache "
         f"{costs['steady_moved']}")
    out["costs"] = costs
    # (analysis phase, (c)) one decode step of this server under the
    # memory facts, R4 and R10 run on them in the analysis phase: the
    # server's steady state, a cache pin_tree has homed (written in place,
    # pinned again with nothing moved), and, planted, the same step on the
    # prefill's cache, never homed (pin_tree copies it into fresh storage)
    from repro_torch.analysis.mem_facts import call_facts
    homed = steady.pop("caches")
    reset_relayouts()
    locale.pin_tree(homed, dim=1, size=SERVE_SLOTS)
    again = relayout_counts()
    need(again["bytes"] == 0, f"serve: pin_tree moved a homed cache {again}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, facts = call_facts(srv._decode, params, homed, batch, S)
    facts["seconds"] = time.perf_counter() - t0
    facts["cache_bytes"] = cache_bytes
    del homed
    _, facts["planted"] = call_facts(srv._decode, params, caches, batch, S)
    out["decode_facts"] = facts
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
        f"{costs['decode_step_busy_ms']:.2f} ms of the step; the relayouts "
        f"of its steps {json.dumps(costs['steady_moved'])}); planted, the "
        f"step on the never-homed cache {costs['decode_step_unhomed_ms']:.2f}"
        f" ms; pin_tree of the {cache_bytes} B cache: first "
        f"{costs['pin_tree_first_ms']:.2f} ms, moved {json.dumps(moved)}, "
        f"homed {costs['pin_tree_ms']:.4f} ms; profiler saw "
        f"{json.dumps(seen)} launches, the "
        f"wrapper counted {counted}; phase {out['seconds']:.1f} s")
    out["recorded"] = recorded
    out["line_launches"] = out["runs"]["waves-fifo"]["launches"].get(
        "flash_attention", 0)
    return out


#: the stack phase: the members the earlier phases never ran (MoE, Mamba2,
#: sliding windows, cross attention) at full width.  deepseek-moe-16b
#: (src/repro/configs/deepseek_moe_16b.py, 16.9 B parameters, 34 GB in
#: bf16) and mamba2-2.7b (2.8 B) at full width and depth through
#: `DecodeServer` in aligned waves, 8 slots over HomeMesh({"data": 8}), 16
#: requests of the serve phase's mixed stream (4 zipf-skewed sessions, 8 or
#: 16 new tokens): deepseek with prompts of 128-256 tokens (a wave pads to
#: its longest prompt, so 8 rows give at most 2048 tokens: one MoE group,
#: as the reference's ``T % 2048`` asks), mamba with prompts of 128-512
#: tokens padded to 512 (two SSD chunks of 256: the state crosses a chunk).
#: The MoE's capacity buckets couple the rows of a wave (a token past its
#: expert's capacity is dropped, in row order), so where the policies form
#: other waves deepseek's tokens may differ between them: each policy's
#: waves are replayed through the plain model (`replay_waves`) instead.
#: Mamba's rows are independent, so its tokens must be equal across them
STACK_SLOTS, STACK_REQUESTS = 8, 16
STACK_SERVE = {"deepseek-moe-16b": dict(prompt_len=(128, 256), pad=None,
                                        sessions=4, new=(8, 16), max_len=384),
               "mamba2-2.7b": dict(prompt_len=(128, 512), pad=512,
                                   sessions=4, new=(8, 16), max_len=640)}
#: deepseek's determinism run: every prompt 256 tokens (8 x 256 = 2048
#: tokens a wave), a session a request and 16 new tokens each, so that
#: fifo and homed place every request on the same slot of the same wave
#: and must give the same tokens; its first wave is the one timed
STACK_ALIGNED = dict(prompt_len=(256, 256), pad=None, sessions=STACK_REQUESTS,
                     new=(16, 16), max_len=384)
#: a served token against the plain model's logits for the same wave and
#: inputs: (the plain row's largest logit - its logit of the served token)
#: over the row's largest |logit|.  In bf16 the kernel and the chunked
#: form round apart (2^-6 of the logits for the dense qwen3-0.6b, the
#: serve phase's `LOGIT_TOL`), and in the MoE such a difference flips a
#: near-tie among a token's top 6 of 64 experts or a token at a bucket's
#: capacity, which moves its output by a whole expert's share: the logits
#: then differ by up to 0.14 of the largest and the greedy picks on 7-12 %
#: of the tokens, where the two picks are near-ties.  The bound lies
#: between the sound reading and the planted fault's (H100, seed 0: every
#: served token within 0.037 of the plain pick; the next token id at
#: least 0.32 away)
STACK_REPLAY_TOL = 2.0 ** -4
#: mamba2-2.7b's state handoff: prefill(S) against prefill(S - 1) and one
#: decode step, S < 256 (one SSD chunk), 2 rows
STACK_HANDOFF_S = 200
#: mixtral-8x7b at full width, depth cut to 4 layers (12.2 GB in bf16; the
#: 32 layers' 93 GB do not fit): a prefill of S = 8192 through the
#: windowed kernel (window 4096), then decode steps over the 4096-slot ring
STACK_MIXTRAL_LAYERS, STACK_MIXTRAL_S, STACK_DECODE = 4, 8192, 4
#: llama-3.2-vision-90b at full width, one superblock (4 self-attention
#: layers and one cross layer, 13 GB in bf16): prompts of 512 tokens over
#: 4096 image tokens
STACK_VISION_B, STACK_VISION_S = 2, 512
#: the five configs the float32 reduced run holds card against CPU
STACK_ARCHS = ("deepseek-moe-16b", "mamba2-2.7b", "mixtral-8x7b",
               "jamba-1.5-large-398b", "llama-3.2-vision-90b")
STACK_RTOL, STACK_ATOL = 1e-4, 1e-5
#: the state handoff's bound on the logits and the SSM states, as the
#: largest difference over the largest |value|: the chunked scan rounds
#: its weights, states and decays to bf16 where the recurrent step keeps
#: float32, across 64 layers.  It lies between the sound run's reading
#: and the planted fault's (H100, seed 0: logits 0.0292 and SSM states
#: 0.0332 against 0.154 for a decode step from a zeroed SSM state)
STACK_HANDOFF_TOL = 2.0 ** -4


def rel_err(a, b) -> float:
    """The largest difference over the largest |value| of b."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def kernel_cell(q, k, v, *, causal: bool, window: int = 0) -> dict:
    """The kernel against its plain version at one shape (untimed run
    first), then its time, the plain version's, SDPA's and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (KERNEL_TOL,
                                                     flash_attention_reference)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    rtol, atol = KERNEL_TOL[q.dtype]
    kw = dict(causal=causal, window=window)
    with untimed():
        got = ops.flash_attention(q, k, v, **kw)
    plain = flash_attention_reference(q, k, v, **kw)
    flops, nbytes = attention_work(q, k, causal, window)
    mask = None
    if window:
        i = torch.arange(Sq, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

    def library():
        if mask is not None:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    rec = dict(shape=[B, H, KV, Sq, Skv, hd], causal=causal, window=window,
               beyond=beyond(got, plain, rtol, atol), rtol=rtol, atol=atol,
               max_abs_err=float((got.float() - plain.float()).abs().max()),
               ms=cuda_ms(lambda: ops.flash_attention(q, k, v, **kw),
                          reps=20),
               plain_ms=cuda_ms(lambda: flash_attention_reference(
                   q, k, v, **kw), reps=1),
               library_ms=cuda_ms(library, reps=5),
               ops_ms=flops / 989e12 * 1e3,
               bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
    rec["bound_by"] = ("operations" if rec["ops_ms"] >= rec["bytes_ms"]
                       else "bytes")
    need(rec["beyond"] == 0, f"stack: flash_attention outside rtol={rtol} "
                             f"atol={atol} at {rec['shape']} causal={causal} "
                             f"window={window}: {rec}")
    return rec


def stack_float32(seed: int) -> dict:
    """Each new config at `reduce_config` in float32: forward, prefill and
    three decode steps on the card against the same on the CPU, from the
    same seeded parameters and tokens, within rtol 1e-4 / atol 1e-5."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    out = {}
    for name in STACK_ARCHS:
        cfg = reduce_config(get_config(name))
        m = LM(cfg)
        cpu = m.init(torch.Generator().manual_seed(seed))
        rng = np.random.default_rng(seed)
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 32)))}
        if cfg.family == "vlm":
            b["image_embeds"] = torch.from_numpy((0.1 * rng.standard_normal(
                (2, cfg.num_image_tokens, cfg.d_model))).astype(np.float32))
        res = {}
        ops.reset_launches()
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), cpu)
            bd = tree_map(lambda t: t.to(dev), b)
            cut = {k: v if k == "image_embeds" else v[:, :16]
                   for k, v in bd.items()}
            logits, _, aux = m.forward(p, bd)
            last, caches = m.prefill(p, cut, max_len=32)
            steps = []
            for pos in range(16, 19):
                one = {k: v if k == "image_embeds" else v[:, pos:pos + 1]
                       for k, v in bd.items()}
                lg, caches = m.decode_step(p, caches, one, pos)
                steps.append(lg)
            res[dev] = [logits, aux, last, *steps, *tree_leaves(caches)]
        launches = ops.launch_counts()["flash_attention"]
        errs = []
        for a, c in zip(res["cpu"], res["cuda"]):
            c = c.cpu()
            if a.dtype == torch.int32:
                errs.append(0.0 if torch.equal(a, c) else float("inf"))
                continue
            ok = torch.allclose(c.float(), a.float(), rtol=STACK_RTOL,
                                atol=STACK_ATOL)
            errs.append(float((c.float() - a.float()).abs().max())
                        if ok else float("inf"))
        out[name] = dict(compared=len(errs), max_abs_err=max(errs),
                         flash_launches=launches)
        need(all(e != float("inf") for e in errs),
             f"stack float32 {name}: the card differs from the CPU beyond "
             f"rtol={STACK_RTOL} atol={STACK_ATOL}: {errs}")
        del cpu, res
    torch.cuda.empty_cache()
    return out


def recording(srv) -> list:
    """Keep what `srv` computes, wave by wave: its placements (slot, rid),
    the prefill's tokens and last logits, and each decode step's fed
    tokens and logits.  Returns the list it fills."""
    waves = []
    serve_wave, prefill, decode = srv._serve_wave, srv.model.prefill, \
        srv._decode

    def _serve_wave(placements):
        waves.append(dict(placements=[(s, r.rid) for s, r in placements],
                          steps=[]))
        return serve_wave(placements)

    def _prefill(params, batch, max_len=None, plan=None):
        last, caches = prefill(params, batch, max_len=max_len, plan=plan)
        waves[-1]["prefill"] = (batch["tokens"].clone(), last.clone())
        return last, caches

    def _decode(params, caches, batch, pos):
        logits, caches = decode(params, caches, batch, pos)
        waves[-1]["steps"].append((batch["tokens"].clone(), logits.clone(),
                                   pos))
        return logits, caches
    srv._serve_wave, srv.model.prefill, srv._decode = (_serve_wave, _prefill,
                                                       _decode)
    return waves


def replay_waves(cfg, params, waves, served, max_len: int) -> dict:
    """Replay each recorded wave through the plain model (`LM(cfg,
    flash=False)`: the chunked attention) on the card: the prefill batch
    built anew from the placements and prompts, then every decode step on
    the inputs the server fed (those of empty and finished rows too, which
    share the MoE's capacity buckets).  Each served token is held to the
    plain logits of its row and step by `STACK_REPLAY_TOL`; the planted
    fault, the served token's id plus one, must fall outside it."""
    from repro_torch.models import LM
    plain = LM(cfg, flash=False)
    by_rid = {r.rid: r for r in served}
    margins, faults, errs, agree, n = [], [], [], 0, 0

    def hold(lp, ls, rows, t):
        nonlocal agree, n
        lp = lp.float()
        if ls is not None:                   # the served logits, if kept
            errs.append(rel_err(ls, lp))
        top, scale = lp.max(-1).values, lp.abs().max(-1).values
        for i, r in rows:
            if t >= len(r.out):
                continue
            tok = r.out[t]
            margins.append(float((top[i] - lp[i, tok]) / scale[i]))
            faults.append(float((top[i] - lp[i, (tok + 1) % lp.shape[-1]])
                                / scale[i]))
            agree += int(int(lp[i].argmax()) == tok)
            n += 1
    for w in waves:
        rows = [(s, by_rid[rid]) for s, rid in w["placements"]]
        plen = max(len(r.prompt) for _, r in rows)
        toks = torch.zeros(STACK_SLOTS, plen, dtype=torch.long)
        for s, r in rows:
            toks[s, plen - len(r.prompt):] = torch.from_numpy(r.prompt)
        fed, served_last = w["prefill"]
        need(torch.equal(fed.cpu(), toks), f"stack {cfg.name}: the server "
                                           f"built another prefill batch")
        last, caches = plain.prefill(params, {"tokens": toks.cuda()},
                                     max_len=max_len)
        hold(last, served_last, rows, 0)
        for t, (fed, logits, pos) in enumerate(w["steps"], 1):
            need(all(int(fed[s, 0]) == r.out[t - 1] for s, r in rows
                     if t - 1 < len(r.out)) and pos == plen + t - 1,
                 f"stack {cfg.name}: decode step {t} fed other tokens")
            lp, caches = plain.decode_step(params, caches, {"tokens": fed},
                                           pos)
            hold(lp, logits, rows, t)
        del caches
    rec = dict(tokens=n, argmax_agree=agree / n, max_margin=max(margins),
               fault_min_margin=min(faults),
               max_logit_rel=max(errs) if errs else None,
               tol=STACK_REPLAY_TOL)
    need(n == sum(len(r.out) for r in served),
         f"stack {cfg.name}: the replay held {n} tokens")
    need(rec["max_margin"] <= STACK_REPLAY_TOL,
         f"stack {cfg.name}: a served token is not the plain model's pick "
         f"within {STACK_REPLAY_TOL}: {rec}")
    need(rec["fault_min_margin"] > STACK_REPLAY_TOL,
         f"stack {cfg.name}: a planted wrong token passes the replay: {rec}")
    return rec


def stack_serve(name: str, seed: int, locale, smi: str) -> dict:
    """One config at full width and depth through `DecodeServer` in
    aligned waves under fifo and homed (see `STACK_SERVE`): the MoE's
    waves each replayed through the plain model, the rows of every other
    member equal across the policies; deepseek also in the determinism
    run `STACK_ALIGNED`."""
    from repro_torch.analysis import record
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import KERNELS
    from repro_torch.models import LM
    from repro_torch.obs import Tracer
    from repro_torch.runtime.server import DecodeServer, Request
    from repro_torch.convert import make_serve_stream

    cfg = get_config(name)
    moe = cfg.num_experts > 0
    attn_layers = len(cfg.attn_layers)
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    out = {"params": n_params, "param_bytes": sum(
        t.numel() * t.element_size() for t in tree_leaves(params)),
        "init_s": time.perf_counter() - t0, "runs": {}}
    streams = {"mixed": STACK_SERVE[name]}
    if moe:
        streams["aligned"] = STACK_ALIGNED

    def server(spec, reqs, policy, tracer=None):
        srv = DecodeServer(cfg, params, batch_slots=STACK_SLOTS,
                           max_len=spec["max_len"], locale=locale,
                           scheduler=policy, prompt_pad=spec["pad"],
                           tracer=tracer)
        for d in reqs:
            srv.submit(Request(**d))
        return srv

    recorded = []
    for stream, spec in streams.items():
        reqs = make_serve_stream(STACK_REQUESTS, cfg.vocab_size,
                                 spec["prompt_len"],
                                 sessions=spec["sessions"],
                                 new_tokens=spec["new"], slots=STACK_SLOTS,
                                 seed=seed)
        if spec["sessions"] == STACK_REQUESTS:
            for d in reqs:                   # a session a request
                d["session"] = f"r{d['rid']}"
        replay = moe and stream == "mixed"
        for policy in ("fifo", "homed"):
            srv = server(spec, reqs, policy, Tracer())
            need(not srv.paged, f"stack {name}: served paged, not in waves")
            waves = recording(srv) if replay else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ops.reset_launches()             # the path's counted run
            t0 = time.perf_counter()
            with record() as launches:
                served = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            recorded += launches
            summary = srv.scheduler.summary()
            toks = {r.rid: list(r.out) for r in served}
            n_tok = sum(len(v) for v in toks.values())
            tag = f"{stream}-{policy}"
            out["runs"][tag] = rec = dict(
                wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                waves=summary["waves"], steps=summary["steps"],
                launches=counts, kernels=sorted({f.name for f in launches}),
                homes={r.rid: r.home for r in served},
                peak_bytes=torch.cuda.max_memory_allocated() - base,
                tokens_out=toks)
            want = attn_layers * summary["waves"]
            need(len(served) == STACK_REQUESTS and all(
                len(toks[d["rid"]]) == d["max_new"] for d in reqs)
                and all(0 <= t < cfg.vocab_padded for v in toks.values()
                        for t in v), f"stack {name} {tag}: requests or "
                                     f"tokens wrong")
            need(counts.get("flash_attention", 0) == want
                 and set(counts) <= {"flash_attention"},
                 f"stack {name} {tag}: launches {counts}, want {want} "
                 f"flash_attention")
            need(rec["kernels"] == ([KERNELS["bfloat16"]] if want else []),
                 f"stack {name} {tag}: kernels {rec['kernels']}")
            if replay:
                rec["waves_placed"] = [w["placements"] for w in waves]
                rec["replay"] = replay_waves(cfg, params, waves, served,
                                             spec["max_len"])
                del waves
            say(f"phase stack {name} {tag}: {len(served)} requests, {n_tok} "
                f"tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s), "
                f"{summary['waves']} waves, {summary['steps']} steps, "
                f"launches {json.dumps(counts)}, peak {rec['peak_bytes']} B"
                + (f"; each wave replayed through the plain model: "
                   f"{json.dumps(rec['replay'])}" if replay else "")
                + f" [{smi}]")
            del srv, served
        fifo, homed = (out["runs"][f"{stream}-{p}"] for p in ("fifo",
                                                              "homed"))
        placed = sum(fifo["homes"][r] != homed["homes"][r]
                     for r in fifo["homes"])
        same = fifo.pop("tokens_out") == homed.pop("tokens_out")
        out[stream] = dict(homes_differ=placed, same_tokens=same)
        if stream == "aligned":
            # determinism: equal placements, so the same tokens
            need(placed == 0 and same, f"stack {name}: the aligned stream "
                 f"placed {placed} requests apart or its tokens differ "
                 f"between fifo and homed")
        elif not moe:
            need(same, f"stack {name}: tokens differ between fifo and homed")

    # the costs of the first wave: prefill, a decode step (CUDA events,
    # the host clock, kernels busy), the peak of the prefill
    first = sorted(reqs, key=lambda d: (d["t_arrive"], d["rid"]))
    S = spec["pad"] or max(len(d["prompt"]) for d in first[:STACK_SLOTS])
    toks = torch.zeros(STACK_SLOTS, S, dtype=torch.long)
    for i, d in enumerate(first[:STACK_SLOTS]):
        toks[i, S - len(d["prompt"]):] = torch.from_numpy(d["prompt"])
    toks = toks.cuda()
    srv = server(spec, reqs, "fifo")
    prefill = lambda: model.prefill(params, {"tokens": toks},  # noqa: E731
                                    max_len=spec["max_len"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    last, caches = prefill()
    torch.cuda.synchronize()
    prefill_peak = torch.cuda.max_memory_allocated() - base
    need(bool(torch.isfinite(last.float()).all()),
         f"stack {name}: prefill logits not finite")
    batch = {"tokens": last.argmax(-1)[:, None]}
    srv._decode(params, caches, batch, S)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        srv._decode(params, caches, batch, S)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    step = lambda: srv._decode(params, caches, batch, S)  # noqa: E731
    out["costs"] = dict(
        prefill_shape=[STACK_SLOTS, S], prefill_ms=cuda_ms(prefill, reps=3),
        prefill_busy_ms=device_busy_ms(prefill), prefill_peak_bytes=prefill_peak,
        decode_step_ms=cuda_ms(step, reps=5), decode_step_host_ms=host_ms,
        decode_step_busy_ms=device_busy_ms(step),
        cache_bytes=sum(t.numel() * t.element_size()
                        for t in tree_leaves(caches)))
    del caches, srv, last
    out["recorded"] = recorded
    out["params_ref"] = params
    return out


def mamba_handoff(params, seed: int) -> dict:
    """prefill(S)'s last logits and SSM states against prefill(S - 1) and
    one decode step, and a planted fault: the decode step from a zeroed
    SSM state, which must fall outside the tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config("mamba2-2.7b")
    model = LM(cfg)
    S = STACK_HANDOFF_S
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (2, S))).cuda()
    want, full = model.prefill(params, {"tokens": toks}, max_len=S)
    _, part = model.prefill(params, {"tokens": toks[:, :-1]}, max_len=S)
    _, fault = model.prefill(params, {"tokens": toks[:, :-1]}, max_len=S)
    fault["m0"]["ssm"].zero_()
    one = {"tokens": toks[:, -1:]}
    got, part = model.decode_step(params, part, one, S - 1)
    wrong, _ = model.decode_step(params, fault, one, S - 1)
    rec = dict(S=S, logits_rel=rel_err(got, want),
               ssm_rel=rel_err(part["m0"]["ssm"], full["m0"]["ssm"]),
               conv_rel=max(rel_err(part["m0"][k], full["m0"][k])
                            for k in ("conv_x", "conv_bc")),
               fault_rel=rel_err(wrong, want), tol=STACK_HANDOFF_TOL)
    need(rec["logits_rel"] <= STACK_HANDOFF_TOL
         and rec["ssm_rel"] <= STACK_HANDOFF_TOL,
         f"stack mamba2-2.7b: prefill(S) against prefill(S-1) + decode "
         f"beyond {STACK_HANDOFF_TOL}: {rec}")
    need(rec["fault_rel"] > STACK_HANDOFF_TOL,
         f"stack mamba2-2.7b: a zeroed SSM state passes the handoff "
         f"tolerance: {rec}")
    return rec


def release() -> None:
    """Give the card back what the last model held: a `DecodeServer` and
    its decode step refer to each other, so the parameters they hold go
    only at a garbage collection."""
    gc.collect()
    torch.cuda.empty_cache()


def prefill_logits(cfg, params, batch, last16, planted, required) -> dict:
    """A prefill's last logits through the kernel against the plain
    chunked form: in float32 (the same weights widened), bounded by
    `LOGIT_TOL`, and in bf16 (`last16`, the kernel's, from the counted
    run), where each of the two bf16 forms is reported against the
    float32 plain one.  The kernel keeps P as a bf16 hi + lo pair where
    the chunked form rounds it once, so in bf16 they differ by about one
    rounding step of every attention output.  The float32 prefill is run
    again with each of `planted_faults` in place of the kernel in the
    launches that ``planted(causal, window)`` picks; those named in
    `required` must fall outside the bound."""
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    b32 = {k: v.float() if v.is_floating_point() else v
           for k, v in batch.items()}
    with untimed():
        k32, _ = LM(c32).prefill(p32, b32)
    p32_last, _ = LM(c32, flash=False).prefill(p32, b32)
    kernel, faults = ops.flash_attention, {}
    for fault, wrong in planted_faults().items():
        def flash(q, k, v, causal=True, window=0, wrong=wrong):
            if planted(causal, window):
                return wrong(q, k, v, causal=causal, window=window)
            return kernel(q, k, v, causal=causal, window=window)
        with mock.patch.object(ops, "flash_attention", flash):
            w, _ = LM(c32).prefill(p32, b32)
        faults[fault] = rel_err(w, p32_last)
        del w
    del p32
    p16, _ = LM(cfg, flash=False).prefill(params, batch)
    rec = dict(float32=rel_err(k32, p32_last), tol=LOGIT_TOL["float32"],
               float32_faults=faults,
               bf16_kernel_vs_plain=rel_err(last16, p16),
               bf16_kernel_vs_float32=rel_err(last16, p32_last),
               bf16_plain_vs_float32=rel_err(p16, p32_last),
               argmax_equal=bool(torch.equal(last16.argmax(-1),
                                             p16.argmax(-1))))
    release()
    need(rec["float32"] <= LOGIT_TOL["float32"],
         f"stack {cfg.name}: float32 prefill through the kernel differs from "
         f"the plain chunked form: {rec}")
    need(all(faults[f] > LOGIT_TOL["float32"] for f in required),
         f"stack {cfg.name}: a planted fault's float32 prefill logits pass "
         f"the tolerance {LOGIT_TOL['float32']}: {rec}")
    return rec


def phase_stack(seed: int, smi: str) -> dict:
    """The rest of the model stack at full width (see the module
    docstring, 8e)."""
    from repro_torch.analysis import record
    from repro_torch.configs import get_config
    from repro_torch.convert import make_attention_inputs
    from repro_torch.core import HomeMesh, Locale
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (KERNEL_TOL,
                                                     flash_attention_reference)
    from repro_torch.models import LM, attention
    from repro_torch.models.attention import (banded_swa_attention,
                                              flash_prefill_attention)

    t_phase = time.perf_counter()
    release()
    out = {"recorded": [], "launches": {}, "cells": {},
           "allocated_at_start": torch.cuda.memory_allocated()}
    locale = Locale(HomeMesh({"data": 8}), "data")

    # 1. the served configs, at full width and depth
    for name in STACK_SERVE:
        rec = stack_serve(name, seed, locale, smi)
        params = rec.pop("params_ref")
        out["recorded"] += rec.pop("recorded")
        out["launches"][name] = rec["runs"]["mixed-fifo"]["launches"].get(
            "flash_attention", 0)
        if name == "mamba2-2.7b":
            rec["handoff"] = mamba_handoff(params, seed)
        del params
        release()
        out[name] = rec
        c = rec["costs"]
        say(f"phase stack {name}: {rec['params']} parameters "
            f"({rec['param_bytes']} B, init {rec['init_s']:.1f} s); fifo "
            f"against homed, by stream: " + json.dumps(
                {k: rec[k] for k in ("mixed", "aligned") if k in rec})
            + f"; prefill of {c['prefill_shape']} "
            f"{c['prefill_ms']:.2f} ms (kernels busy "
            f"{c['prefill_busy_ms']:.2f} ms, peak {c['prefill_peak_bytes']} "
            f"B); decode step {c['decode_step_ms']:.2f} ms by CUDA events, "
            f"{c['decode_step_host_ms']:.2f} ms by the host clock, kernels "
            f"busy {c['decode_step_busy_ms']:.2f} ms; cache "
            f"{c['cache_bytes']} B"
            + (f"; state handoff {json.dumps(rec['handoff'])}"
               if "handoff" in rec else "") + f" [{smi}]")

    # 2. mixtral-8x7b, 4 layers at full width: windowed prefill at S = 8192.
    # Every windowed launch of the prefill is held against the plain banded
    # form on its own inputs (in float32, the plain version's arithmetic),
    # within KERNEL_TOL; the logits against the plain chunked (banded)
    # model as `prefill_logits` holds them
    cfg = get_config("mixtral-8x7b").replace(num_layers=STACK_MIXTRAL_LAYERS)
    W, S = cfg.sliding_window, STACK_MIXTRAL_S
    model = LM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S))).cuda()
    seen = []

    def keep(q, k, v, **kw):
        o = flash_prefill_attention(q, k, v, **kw)
        seen.append((q, k, v, o, kw))
        return o
    ops.reset_launches()                     # the path's counted run
    with record() as launches, mock.patch.object(
            attention, "flash_prefill_attention", keep):
        last, caches = model.prefill(params, {"tokens": toks},
                                     max_len=S + STACK_DECODE)
        cur = last.argmax(-1)[:, None]
        for i in range(STACK_DECODE):
            lg, caches = model.decode_step(params, caches, {"tokens": cur},
                                           S + i)
            cur = lg.argmax(-1)[:, None]
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["recorded"] += launches
    out["launches"]["mixtral-8x7b"] = counts.get("flash_attention", 0)
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    win = []
    for q, k, v, o, kw in seen:
        need(kw == dict(causal=True, window=W), f"stack mixtral-8x7b: the "
                                                f"prefill called {kw}")
        banded = banded_swa_attention(q.float(), k.float(), v.float(),
                                      window=W).to(torch.bfloat16)
        win.append(dict(beyond=beyond(o, banded, rtol, atol),
                        max_abs_err=float((o.float() - banded.float()).abs()
                                          .max())))
        del banded
    del seen
    release()
    need(len(win) == cfg.num_layers and all(w["beyond"] == 0 for w in win),
         f"stack mixtral-8x7b: a windowed launch outside rtol={rtol} "
         f"atol={atol} of the banded form: {win}")
    kp = caches["m0"]["kpos"][0, 0]
    ring = torch.arange(S - W, S, device="cuda", dtype=torch.int32)
    ring[:STACK_DECODE] = torch.arange(S, S + STACK_DECODE, device="cuda",
                                       dtype=torch.int32)
    mix = dict(layers=cfg.num_layers, S=S, window=W,
               params=sum(t.numel() for t in tree_leaves(params)),
               launches=counts, windowed=win, rtol=rtol, atol=atol,
               ring_slots=int(caches["m0"]["k"].shape[2]),
               ring_ok=bool(torch.equal(kp, ring)),
               finite=bool(torch.isfinite(lg.float()).all()),
               logits=prefill_logits(cfg, params, {"tokens": toks}, last,
                                     lambda causal, window: window > 0,
                                     ("dropped_tile", "scale_1pct")),
               prefill_ms=cuda_ms(lambda: model.prefill(
                   params, {"tokens": toks}, max_len=S), reps=2))
    need(counts == {"flash_attention": cfg.num_layers},
         f"stack mixtral-8x7b: launches {counts}")
    need(mix["ring_ok"] and mix["ring_slots"] == W and mix["finite"],
         f"stack mixtral-8x7b: ring or logits wrong: {mix}")
    out["mixtral-8x7b"] = mix
    say(f"phase stack mixtral-8x7b ({cfg.num_layers} layers at full width, "
        f"{mix['params']} parameters): prefill of (1, {S}) through the "
        f"windowed kernel (window {W}) {mix['prefill_ms']:.2f} ms, launches "
        f"{json.dumps(counts)}, each against the float32 banded form "
        f"(rtol={rtol:.3g} atol={atol:.3g}) {json.dumps(win)}; last "
        f"logits against the plain model, as the largest difference over "
        f"the largest |logit| {json.dumps(mix['logits'])}; {STACK_DECODE} "
        f"decode steps over the "
        f"{mix['ring_slots']}-slot ring (positions as the ring predicts: "
        f"{mix['ring_ok']}) [{smi}]")
    del params, caches, last, lg
    release()

    # 3. llama-3.2-vision-90b, one superblock at full width: the
    # non-causal kernel over 4096 image tokens, held against its plain
    # version at that shape before the model runs it
    cfg = get_config("llama-3.2-vision-90b")
    cfg = cfg.replace(num_layers=cfg.cross_attn_every)
    B, S, n = STACK_VISION_B, STACK_VISION_S, cfg.num_image_tokens
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for tag, (sq, skv, causal) in {"cross": (S, n, False),
                                   "self": (S, S, True)}.items():
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16).cuda() for a in
                   make_attention_inputs(B, H, KV, sq, skv, hd, "bfloat16",
                                         seed))
        out["cells"][f"vision_{tag}"] = kernel_cell(q, k, v, causal=causal)
        del q, k, v
    model = LM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S))).cuda(),
        "image_embeds": (0.1 * torch.randn(
            B, n, cfg.d_model, generator=torch.Generator(
                device="cuda").manual_seed(seed + 2), device="cuda")).to(
                    torch.bfloat16)}
    seen = []

    def keep_cross(q, k, v, **kw):
        o = flash_prefill_attention(q, k, v, **kw)
        if not kw["causal"]:
            seen.append((q, k, v, o))
        return o
    ops.reset_launches()                     # the path's counted run
    with record() as launches, mock.patch.object(
            attention, "flash_prefill_attention", keep_cross):
        last, caches = model.prefill(params, batch, max_len=S + STACK_DECODE)
        before = caches["m4"]["k"].clone()
        cur = last.argmax(-1)[:, None]
        for i in range(STACK_DECODE):
            lg, caches = model.decode_step(params, caches, {"tokens": cur},
                                           S + i)
            cur = lg.argmax(-1)[:, None]
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["recorded"] += launches
    out["launches"]["llama-3.2-vision-90b"] = counts.get("flash_attention", 0)
    calls = sorted({f.call[1][:9] for f in launches})
    # every cross launch of the prefill against the plain version on its
    # own inputs, within KERNEL_TOL, and the planted dropped tile outside
    # it: in the logits the one cross layer's fault reads under the
    # float32 bound (the random image embeddings' cross output is small
    # against the residual), so the launch is where it is held
    rtol, atol = KERNEL_TOL[torch.bfloat16]
    dropped, cross = planted_faults()["dropped_tile"], []
    for q, k, v, o in seen:
        qh = q.reshape(B, S, H, hd).transpose(1, 2)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        want = flash_attention_reference(qh, kh, vh, causal=False)
        wrong = dropped(qh, kh, vh, causal=False)
        o = o.transpose(1, 2)
        cross.append(dict(beyond=beyond(o, want, rtol, atol),
                          max_abs_err=float((o.float() - want.float()).abs()
                                            .max()),
                          fault_beyond=beyond(wrong, want, rtol, atol)))
        del want, wrong
    del seen
    need(len(cross) == 1 and all(c["beyond"] == 0 and c["fault_beyond"] > 0
                                 for c in cross),
         f"stack vision: the cross launch outside rtol={rtol} atol={atol} of "
         f"its plain version, or the planted dropped tile inside: {cross}")
    vis = dict(layers=cfg.num_layers, B=B, S=S, image_tokens=n, cross=cross,
               params=sum(t.numel() for t in tree_leaves(params)),
               launches=counts, calls=[list(c) for c in calls],
               cross_cache_static=bool(torch.equal(before,
                                                   caches["m4"]["k"])),
               finite=bool(torch.isfinite(lg.float()).all()),
               logits=prefill_logits(cfg, params, batch, last,
                                     lambda causal, window: not causal,
                                     required=()),
               prefill_ms=cuda_ms(lambda: model.prefill(params, batch,
                                                        max_len=S), reps=2))
    need(counts == {"flash_attention": cfg.num_layers},
         f"stack vision: launches {counts}")
    need(any(not c[8] and c[3] != c[4] for c in calls),
         f"stack vision: no non-causal launch with Sq != Skv: {calls}")
    # the data pipeline's float32 image embeddings: the bf16 cross layer's
    # K/V promote to float32 and its launch runs fa_kernel at float32 (one
    # a cross layer), the self layers fa_wgmma.  The last logits against
    # the same model with the cross layer on its plain route (the chunked
    # form in float32), within the bf16 bound; against the all-plain
    # model they also carry the self layers' bf16 difference (the
    # kernel's hi + lo P against the chunked form's one rounding), which
    # the bf16 embeddings' `bf16_kernel_vs_plain` reports beside it
    b32 = dict(batch, image_embeds=batch["image_embeds"].float())
    ops.reset_launches()
    with untimed(), record() as ran:
        last32, _ = model.prefill(params, b32, max_len=S)
    torch.cuda.synchronize()
    launched = ops.launch_counts()["flash_attention"]
    real_prefill = attention.prefill_attention

    def plain_cross(q, k, v, **kw):
        return real_prefill(q, k, v, **dict(kw, flash=kw["causal"]))
    with untimed(), mock.patch.object(attention, "prefill_attention",
                                      plain_cross):
        cross32, _ = model.prefill(params, b32, max_len=S)
    plain32, _ = LM(cfg, flash=False).prefill(params, b32, max_len=S)
    n_cross = sum(1 for c in calls if not c[8])
    vis["f32_image_embeds"] = dict(
        kernels=dict(collections.Counter(
            (f.name, f.call[1][10]) for f in ran)),
        launches=launched,
        rel=rel_err(last32, cross32), tol=LOGIT_TOL["bfloat16"],
        rel_all_plain=rel_err(last32, plain32),
        bf16_embeds_kernel_vs_plain=vis["logits"]["bf16_kernel_vs_plain"],
        finite=bool(torch.isfinite(last32.float()).all()),
        ms=cuda_ms(lambda: model.prefill(params, b32, max_len=S), reps=2))
    vis["f32_image_embeds"]["kernels"] = {
        f"{k[0]} {k[1]}": n for k, n in
        vis["f32_image_embeds"]["kernels"].items()}
    need(vis["f32_image_embeds"]["kernels"] == {
        "fa_kernel float32": n_cross,
        "fa_wgmma bfloat16": cfg.num_layers - n_cross}
         and vis["f32_image_embeds"]["launches"] == cfg.num_layers
         and vis["f32_image_embeds"]["finite"]
         and vis["f32_image_embeds"]["rel"] <= LOGIT_TOL["bfloat16"],
         f"stack vision: float32 image embeddings: "
         f"{vis['f32_image_embeds']}")
    del b32, last32, cross32, plain32
    need(vis["cross_cache_static"] and vis["finite"],
         f"stack vision: the cross cache moved or logits not finite: {vis}")
    out["llama-3.2-vision-90b"] = vis
    say(f"phase stack llama-3.2-vision-90b ({cfg.num_layers} layers at full "
        f"width, {vis['params']} parameters): prefill of ({B}, {S}) over "
        f"{n} image tokens {vis['prefill_ms']:.2f} ms, launches "
        f"{json.dumps(counts)} (calls {vis['calls']}), the cross launch "
        f"against its plain version on its inputs (rtol={rtol:.3g} "
        f"atol={atol:.3g}) {json.dumps(cross)}, last logits against "
        f"the plain chunked form, as the largest difference over the "
        f"largest |logit| {json.dumps(vis['logits'])}, float32 image "
        f"embeddings through the kernel route (launches by kernel and "
        f"dtype; logits against the cross layer's plain route, bounded, "
        f"and against the all-plain model beside the bf16 embeddings' "
        f"kernel-vs-plain; prefill ms) "
        f"{json.dumps(vis['f32_image_embeds'])}, "
        f"{STACK_DECODE} decode steps through the static cross cache; "
        f"kernel cells " + json.dumps(out["cells"]) + f" [{smi}]")
    del params, caches, last, lg, before, batch
    release()

    # 4. float32 reduce_config, card against CPU, all five configs
    out["float32"] = stack_float32(seed)
    say("phase stack float32 reduce_config, card against CPU (rtol "
        f"{STACK_RTOL}, atol {STACK_ATOL}): " + json.dumps(out["float32"]))
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase stack: {out['seconds']:.1f} s, flash_attention launches by "
        f"path " + json.dumps(out["launches"]) + f", {out['allocated_at_start']}"
        f" B allocated on the card when it began [{smi}]")
    return out


#: the serve_ranks phase: `DecodeServer` across 8 gloo ranks sharing the
#: card (`launch.mesh.spawn`), each rank serving its home's slots with its
#: blocks of the parameters (`convert.rank_params`, `rank_cut`).
#: qwen3-0.6b at full width (the serve phase's model, seed, stream, 16
#: slots and 1024-token cache) on 8 homes of one rank, and on 4 homes of
#: 2 ranks with the heads, KV heads, MLP and vocabulary split over
#: "model"; both modes, both policies.  Its depth is cut from 28 to
#: `SERVE_RANK_LAYERS` for the script's time: on an H100 a pods222 run at
#: 28 layers took 22-26 s (3,776 collectives), the phase 206 s of 1073;
#: at 7 layers 5.9-7.4 s and 91 s, cut to 4 to make room for the dryrun
#: phase
SERVE_RANKS = 8
SERVE_RANK_LAYERS = 4
SERVE_RANK_MESHES = {"data8": {"data": 8, "model": 1},
                     "pods222": {"pod": 2, "data": 2, "model": 2}}
#: deepseek-moe-16b at full width on 2 homes of 4 ranks (16 of its 64
#: experts a rank, 4 of its 16 heads and KV heads), the stack phase's
#: mixed stream in aligned waves (8 slots), its depth cut from 28 to 14
#: layers: 8.6 B parameters, ~4.3 GB of bf16 blocks a rank beside the 8
#: contexts (28 layers would take ~8.5 GB a rank, 68 GB in all, on a card
#: the qwen3 runs and the replay share)
SERVE_RANK_MOE = dict(arch="deepseek-moe-16b", mesh={"data": 2, "model": 4},
                      layers=7)
#: its policy: the home-aware one (the stack phase serves both in one
#: process; a second policy here would take the phase past its 240 s)
SERVE_RANK_MOE_POLICIES = ("homed",)
#: the bf16 picks and logits across ranks against one process's on the
#: same homes (`compare_picks`), as a share of the row's largest |logit|.
#: A rank computes 2 or 4 of the 16 rows and its share of the heads and
#: MLP, so cuBLAS runs other shapes and the split sums add in another
#: order: the readings sit at bf16's rounding, above `LOGIT_TOL` (H100 at
#: 700 W, seed 0, 28 layers: the first prefill's logits 0.0176 apart with
#: "model" = 2, a decode step's 0.0136 with "model" = 1).  The
#: bound lies between those and the planted fault's, one rank's partial
#: sum dropped from the first attention all-reduce (`planted_psum`); a
#: fault as small as the attention phase's 1 % scale reads 0.017 in bf16
#: and is left to the float32 check below, card against CPU
SERVE_RANK_TOL = 2.0 ** -5
#: the float32 check at `reduce_config`: the card's ranks against the CPU
#: port's ranks, tokens equal and logits within rtol 1e-4 / atol 1e-5
SERVE_RANK_F32 = dict(requests=24, prompt_len=(2, 6), new=(3, 12),
                      max_len=32, pad=6)


def pick_recorder(srv) -> list:
    """Keep, for every greedy pick `srv` makes (`DecodeServer._pick`), its
    rows' two largest logits, first argmax (a global vocabulary id) and
    largest |logit| over this rank's vocabulary block, which of them a
    later step can read (a page step's last written position of each row;
    every row of a prefill or decode step), and the logits themselves at
    the first pick of a prefill or decode step."""
    from repro_torch.sharding.partition import tp_of
    calls, pick, page, wmask = [], srv._pick, getattr(srv, "_page", None), {}
    i = tp_of(srv.plan)[1]

    def _page(p, c, toks, positions, wm):
        wmask["last"] = wm
        return page(p, c, toks, positions, wm)

    def _pick(logits):
        lf = logits.float()
        first = lf.dim() == 2 and not any(c[4] is not None for c in calls)
        if lf.dim() == 3:               # a page step: its rows' last write
            wm = wmask["last"].cpu()
            last = wm.shape[1] - 1 - wm.flip(1).int().argmax(dim=1)
            read = (torch.arange(wm.shape[1]) == last[:, None]) & wm
        else:
            read = torch.ones(lf.shape[0], dtype=torch.bool)
        calls.append((lf.topk(2, dim=-1).values.cpu(),
                      (lf.argmax(dim=-1) + i * lf.shape[-1]).cpu(),
                      lf.abs().amax(dim=-1).cpu(), read,
                      lf.cpu() if first else None))
        return pick(logits)
    srv._pick = _pick
    if page is not None:
        srv._page = _page
    return calls


def rank_recording(srv) -> list:
    """The waves `srv` serves across ranks: each wave's placements (slot,
    rid) and every pick's tokens of all slots (the prefill's, then each
    decode step's), as `replay_waves` needs them."""
    waves, serve_wave, pick = [], srv._serve_wave, srv._pick

    def _serve_wave(placements):
        waves.append(dict(placements=[(s, r.rid) for s, r in placements],
                          picks=[]))
        return serve_wave(placements)

    def _pick(logits):
        tok = pick(logits)
        waves[-1]["picks"].append(tok.copy())
        return tok
    srv._serve_wave, srv._pick = _serve_wave, _pick
    return waves


def replay_form(waves, reqs) -> list:
    """`rank_recording`'s waves in `replay_waves`' form: the prefill batch
    rebuilt from the placements and prompts, each decode step fed the
    previous pick's tokens of every slot (no served logits: each rank
    holds only its rows' vocabulary block)."""
    prompts = {d["rid"]: d["prompt"] for d in reqs}
    out = []
    for w in waves:
        plen = max(len(prompts[rid]) for _, rid in w["placements"])
        toks = torch.zeros(STACK_SLOTS, plen, dtype=torch.long)
        for s, rid in w["placements"]:
            toks[s, plen - len(prompts[rid]):] = torch.from_numpy(
                prompts[rid])
        steps = [(torch.from_numpy(w["picks"][t - 1].astype(np.int64))
                  [:, None].cuda(), None, plen + t - 1)
                 for t in range(1, len(w["picks"]))]
        out.append(dict(placements=w["placements"], prefill=(toks, None),
                        steps=steps))
    return out


def serve_streams(cfg, seed: int) -> dict:
    """The serve phase's request streams, by mode."""
    from repro_torch.convert import make_serve_stream
    return {mode: make_serve_stream(
        SERVE_REQUESTS, cfg.vocab_size, m["prompt_len"],
        sessions=SERVE_SESSIONS, new_tokens=SERVE_NEW, slots=SERVE_SLOTS,
        seed=seed, prefix=m["prefix"]) for mode, m in SERVE_MODES.items()}


def rank_serve_run(cfg, params, plan, reqs, *, slots, max_len, pad,
                   page_size, policy, waves=False) -> dict:
    """One counted run of `DecodeServer` on this rank: its tokens, homes,
    summary, event digest, collectives against `serve_schedule`, bytes,
    launches, peak and time, and the picks (`pick_recorder`)."""
    import torch.distributed as dist
    from repro_torch.analysis.livecheck import log_signature
    from repro_torch.core import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.obs import Tracer
    from repro_torch.obs.schedule import log_against_serve, serve_schedule
    from repro_torch.runtime.server import (DecodeServer, Request,
                                            event_digest)
    from repro_torch.sharding.partition import homes_of, tp_of

    cuda = params["head"]["head_w"].is_cuda
    tracer = Tracer()
    srv = DecodeServer(cfg, params, batch_slots=slots, max_len=max_len,
                       plan=plan, scheduler=policy, prompt_pad=pad,
                       page_size=page_size, tracer=tracer)
    for d in reqs:
        srv.submit(Request(**d))
    picks = pick_recorder(srv)
    recorded = rank_recording(srv) if waves else None
    sync(plan.mesh.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    ops.reset_launches()                      # the path's counted run
    coll.reset_collectives()
    dist.barrier()
    t0 = time.perf_counter()
    served = srv.run()
    sync(plan.mesh.device)
    wall = time.perf_counter() - t0
    log = coll.collective_log()
    owners = srv.locale.owners(slots)
    places = [r["args"] for r in tracer.records()
              if r["name"] == "sched.place"]
    return dict(
        wall_s=wall, home=homes_of(plan)[1], tp=tp_of(plan)[1],
        tokens={r.rid: list(r.out) for r in served},
        homes={r.rid: r.home for r in served},
        summary=json.loads(json.dumps(srv.scheduler.summary())),
        digest=event_digest(tracer),
        schedule=log_against_serve(log, serve_schedule(cfg, plan,
                                                       srv.calls)),
        collectives=len(log), wire=sum(r["wire_bytes"] for r in log),
        signature=log_signature(log), staged=coll.staged_bytes(),
        kinds=sorted({r["kind"] for r in log}),
        on_home=all(owners[p["slot"]] == p["home"] for p in places),
        peak_bytes=(torch.cuda.max_memory_allocated() - base) if cuda
        else None,
        launches={k: v for k, v in ops.launch_counts().items() if v},
        picks=picks, waves=recorded)


class _FirstPick(Exception):
    """Raised by `planted_psum` at the run's first pick: every rank stops
    at the same point, so no collective is left waiting."""


def planted_psum(cfg, params, plan, reqs) -> torch.Tensor:
    """The first pick's logits (this rank's rows and vocabulary block) of
    the aligned-wave fifo run with a planted fault: one rank's partial sum
    dropped from the first attention all-reduce (each rank keeps its own
    partial there).  Every rank makes the same calls."""
    from repro_torch.core import collectives as coll
    from repro_torch.runtime.server import DecodeServer, Request
    real, count, got = coll.psum, [0], {}

    def psum(x, mesh, axes):
        count[0] += 1
        y = real(x, mesh, axes)
        return x.clone() if count[0] == 2 else y   # 1: the embedding's

    def _pick(logits):
        got["logits"] = logits.float().cpu()
        raise _FirstPick
    m = SERVE_MODES["waves"]
    srv = DecodeServer(cfg, params, batch_slots=SERVE_SLOTS,
                       max_len=SERVE_MAX_LEN, plan=plan, scheduler="fifo",
                       prompt_pad=m["prompt_pad"], page_size=m["page_size"])
    for d in reqs:
        srv.submit(Request(**d))
    srv._pick = _pick
    with mock.patch.object(coll, "psum", psum):
        try:
            srv.run()
        except _FirstPick:
            pass
    return got["logits"]


def rank_serve_costs(cfg, params, plan, reqs) -> dict:
    """The first aligned wave's prefill on this rank's rows and a decode
    step after it: CUDA events (every rank in lockstep: the model's
    collectives), kernels busy from `torch.profiler` on rank 0."""
    import torch.distributed as dist
    from repro_torch.models import LM
    from repro_torch.sharding.partition import homes_of
    first = sorted(reqs, key=lambda d: d["t_arrive"])[:SERVE_SLOTS]
    S = max(len(d["prompt"]) for d in first)
    toks = torch.zeros(SERVE_SLOTS, S, dtype=torch.long)
    for i, d in enumerate(first):
        toks[i, S - len(d["prompt"]):] = torch.from_numpy(d["prompt"])
    n, h = homes_of(plan)
    b = SERVE_SLOTS // n
    mine = toks[h * b:(h + 1) * b].to(plan.mesh.device)
    model = LM(cfg)

    def prefill():
        return model.prefill(params, {"tokens": mine}, max_len=SERVE_MAX_LEN,
                             plan=plan)
    _, caches = prefill()
    batch = {"tokens": mine[:, -1:].contiguous()}

    def step():
        return model.decode_step(params, caches, batch, S, plan=plan)
    dist.barrier()
    out = dict(shape=[b, S], prefill_ms=cuda_ms(prefill, reps=1),
               decode_step_ms=cuda_ms(step, reps=3))
    for name, fn in (("prefill", prefill), ("decode_step", step)):
        dist.barrier()
        if plan.mesh.rank == 0:
            out[f"{name}_busy_ms"] = device_busy_ms(fn)
        else:
            fn()
            torch.cuda.synchronize()
    return out


def rank_f32(seed: int, device) -> dict:
    """qwen3-0.6b at `reduce_config` in float32 across the ranks, on each
    mesh of `SERVE_RANK_MESHES`, on the card and on the CPU: a paged run
    (fifo; its page steps and decode steps) and the logits of a prefill
    and two decode steps of a fixed batch, this rank's rows and
    vocabulary block."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import make_serve_stream, rank_params
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models import LM
    from repro_torch.sharding.partition import homes_of, make_plan
    f = SERVE_RANK_F32
    cfg = reduce_config(get_config(SERVE_ARCH))
    whole = LM(cfg).init(torch.Generator().manual_seed(seed))
    reqs = make_serve_stream(f["requests"], cfg.vocab_size, f["prompt_len"],
                             sessions=4, new_tokens=f["new"],
                             slots=SERVE_SLOTS, seed=seed)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 6))
    fed = rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 2))
    out = {}
    for mname, shape in SERVE_RANK_MESHES.items():
        for dev in (device, "cpu"):
            mesh = RankMesh(shape, device=dev)
            plan = make_plan(mesh, cfg, ShapeSpec(
                "serve", f["max_len"], SERVE_SLOTS, "decode"))
            params = tree_map(lambda t: t.to(mesh.device),
                              rank_params(whole, plan, cfg))
            runs = rank_serve_run(
                cfg, params, plan, reqs, slots=SERVE_SLOTS,
                max_len=f["max_len"], pad=f["pad"], page_size=None,
                policy="fifo")["tokens"]
            n, h = homes_of(plan)
            b = SERVE_SLOTS // n
            rows = lambda a: torch.from_numpy(a[h * b:(h + 1) * b]).to(  # noqa: E731
                mesh.device)
            m = LM(cfg)
            last, caches = m.prefill(params, {"tokens": rows(toks)},
                                     max_len=f["max_len"], plan=plan)
            logits = [last]
            for t in range(fed.shape[1]):
                lg, caches = m.decode_step(
                    params, caches, {"tokens": rows(fed[:, t:t + 1])},
                    toks.shape[1] + t, plan=plan)
                logits.append(lg)
            out[mname, str(mesh.device.type)] = dict(
                tokens=runs, logits=torch.stack(logits).cpu())
    return out


def serve_rank_child(device, seed: int, spec: dict) -> dict:
    """One rank of the serve_ranks phase (see the module docstring, 8f):
    `serve_rank_work`, and the distinct shapes of every `flash_attention`
    call it made (``kernel_shapes``: the wrapper's call arguments), which
    the parent holds to the plain version."""
    from repro_torch.analysis import record
    with record() as launches:
        out = serve_rank_work(device, seed, spec)
    out["kernel_shapes"] = sorted({f.call[1] for f in launches
                                   if f.call[0].endswith("flash_attention")},
                                  key=repr)
    return out


def serve_rank_work(device, seed: int, spec: dict) -> dict:
    """qwen3-0.6b on each mesh of ``spec["meshes"]``, then (``spec
    ["moe"]``) deepseek-moe-16b with its waves recorded on rank 0, then
    (``spec["f32"]``) the float32 check; ``spec["costs"]`` (default on)
    times a prefill and a decode step a mesh."""
    need("jax" not in sys.modules, "a rank process imported JAX")
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import make_serve_stream, rank_cut, rank_params
    from repro_torch.core.mesh import RankMesh
    from repro_torch.models import LM
    from repro_torch.sharding.partition import make_plan

    rank = dist.get_rank()
    out = {"rank": rank, "meshes": {}}
    cfg = get_config(SERVE_ARCH).replace(num_layers=SERVE_RANK_LAYERS)
    streams = serve_streams(cfg, seed)
    for mname, shape in spec["meshes"].items():
        t0 = time.perf_counter()
        mesh = RankMesh(shape, device=device)
        plan = make_plan(mesh, cfg, ShapeSpec("serve", SERVE_MAX_LEN,
                                              SERVE_SLOTS, "decode"))
        params = rank_params(LM(cfg).init(torch.Generator(
            device=mesh.device).manual_seed(seed)), plan, cfg)
        sync(device)
        res = out["meshes"][mname] = {
            "init_s": time.perf_counter() - t0, "runs": {},
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params))}
        for mode, m in SERVE_MODES.items():
            for policy in ("fifo", "homed"):
                res["runs"][f"{mode}-{policy}"] = rank_serve_run(
                    cfg, params, plan, streams[mode], slots=SERVE_SLOTS,
                    max_len=SERVE_MAX_LEN, pad=m["prompt_pad"],
                    page_size=m["page_size"], policy=policy)
        if shape.get("model", 1) > 1:
            res["planted"] = planted_psum(cfg, params, plan,
                                          streams["waves"])
        if spec.get("costs", True):
            res["costs"] = rank_serve_costs(cfg, params, plan,
                                            streams["waves"])
        del params
        torch.cuda.empty_cache()
    moe = spec.get("moe")
    if moe:
        mcfg = get_config(moe["arch"]).replace(num_layers=moe["layers"])
        st = STACK_SERVE[moe["arch"]]
        mesh = RankMesh(moe["mesh"], device=device)
        plan = make_plan(mesh, mcfg, ShapeSpec("serve", st["max_len"],
                                               STACK_SLOTS, "decode"))
        t0 = time.perf_counter()
        params = LM(mcfg).init(torch.Generator(
            device=mesh.device).manual_seed(seed), cut=rank_cut(plan, mcfg))
        sync(device)
        reqs = make_serve_stream(STACK_REQUESTS, mcfg.vocab_size,
                                 st["prompt_len"], sessions=st["sessions"],
                                 new_tokens=st["new"], slots=STACK_SLOTS,
                                 seed=seed)
        out["moe"] = {"init_s": time.perf_counter() - t0, "runs": {},
                      "param_bytes": sum(t.numel() * t.element_size()
                                         for t in tree_leaves(params))}
        for policy in SERVE_RANK_MOE_POLICIES:
            run = rank_serve_run(mcfg, params, plan, reqs, slots=STACK_SLOTS,
                                 max_len=st["max_len"], pad=st["pad"],
                                 page_size=None, policy=policy, waves=True)
            run.pop("picks")
            if rank:
                run.pop("waves")
            out["moe"]["runs"][policy] = run
        del params
        torch.cuda.empty_cache()
    if spec.get("f32"):
        out["f32"] = rank_f32(seed, device)
    out["jax_free"] = "jax" not in sys.modules
    return out


def combine_picks(ranks: list, run: str, mname: str, M: int) -> list:
    """Each pick of a run across ranks as one process's: per call, the
    rows' (top two logits, argmax, largest |logit|) over the whole
    vocabulary, rows in slot order, and the first step's logits."""
    rs = [r["meshes"][mname]["runs"][run] for r in ranks]
    n = len({r["home"] for r in rs})
    calls = []
    for c in range(len(rs[0]["picks"])):
        vals, idx, scale, read, full = [], [], [], [], []
        for h in range(n):
            blocks = sorted(((r["tp"], r["picks"][c]) for r in rs
                             if r["home"] == h), key=lambda b: b[0])
            v = torch.cat([b[0] for _, b in blocks], dim=-1)
            a = torch.stack([b[1] for _, b in blocks], dim=-1)
            top = torch.stack([b[0][..., 0] for _, b in blocks], dim=-1)
            vals.append(v.topk(2, dim=-1).values)
            # the first block holding the largest logit: its first argmax
            idx.append(a.gather(-1, top.argmax(dim=-1, keepdim=True))[..., 0])
            scale.append(torch.stack([b[2] for _, b in blocks], -1).amax(-1))
            read.append(blocks[0][1][3])
            if blocks[0][1][4] is not None:
                full.append(torch.cat([b[4] for _, b in blocks], dim=-1))
        calls.append((torch.cat(vals), torch.cat(idx), torch.cat(scale),
                      torch.cat(read), torch.cat(full) if full else None))
    return calls


def compare_picks(one: list, ranks: list, tol: float) -> dict:
    """A run across ranks against the same run in one process, pick for
    pick: each row's largest logit within `tol` of the one-process row's
    (as a share of its largest |logit|), its token equal wherever the
    one-process top-2 margin exceeds `tol`, and the first prefill or
    decode step's logits within `tol` on the slots still compared.  A slot
    whose token legitimately differs (a near-tie) where a later step reads
    it is not compared again in that run: its inputs differ from then
    on."""
    need(len(one) == len(ranks), f"serve_ranks: {len(ranks)} picks across "
                                 f"ranks, {len(one)} in one process")
    live = torch.ones(SERVE_SLOTS, dtype=torch.bool)
    compared = equal = near_ties = 0
    top_rel, logits_rel, first_rows = 0.0, None, 0
    for (v1, i1, s1, read, f1), (v2, i2, s2, _, f2) in zip(one, ranks):
        B = i1.shape[0]
        if f1 is not None and f2 is not None and logits_rel is None:
            logits_rel = rel_err(f2[live[:B]], f1[live[:B]])
            first_rows = int(live[:B].sum())
        rows = live[:B].reshape(B, *([1] * (i1.dim() - 1))).expand(
            i1.shape)
        margin = (v1[..., 0] - v1[..., 1]) / s1
        rel = (v1[..., 0] - v2[..., 0]).abs() / s1
        if rows.any():
            top_rel = max(top_rel, float(rel[rows].max()))
        same = i1 == i2
        bad = ~same & rows & (margin > tol)
        if bad.any():
            need(False, f"serve_ranks: a token differs where the one-process "
                        f"margin {float(margin[bad].max())} exceeds {tol}")
        flips = ~same & rows
        compared += int(rows.sum())
        equal += int((same & rows).sum())
        near_ties += int(flips.sum())
        live[:B] &= ~(flips & read).reshape(B, -1).any(dim=1)
    return dict(compared=compared, equal=equal, near_ties=near_ties,
                top_logit_rel=top_rel, first_logits_rel=logits_rel,
                first_rows=first_rows, tol=tol)


def phase_serve_ranks(seed: int, smi: str) -> dict:
    """The server across ranks (see the module docstring, 8f)."""
    from repro_torch.configs import get_config
    from repro_torch.core import HomeMesh, Locale
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import LM
    from repro_torch.runtime.server import DecodeServer, Request

    t_phase = time.perf_counter()
    device = "cuda"
    spec = {"meshes": SERVE_RANK_MESHES, "moe": SERVE_RANK_MOE, "f32": True}
    cfg = get_config(SERVE_ARCH).replace(num_layers=SERVE_RANK_LAYERS)
    L = cfg.num_layers
    streams = serve_streams(cfg, seed)
    tol = SERVE_RANK_TOL
    # the one-process runs on each mesh's homes at the ranks' depth, before
    # the ranks start: nothing else on the card
    one = {}
    params = LM(cfg).init(torch.Generator(device=device).manual_seed(seed))
    pods = SERVE_RANK_MESHES["pods222"]
    homes = {"data8": Locale(HomeMesh({"data": 8}, device=device), "data"),
             "pods222": Locale(HomeMesh(pods, device=device),
                               ("pod", "data"))}
    for mname, locale in homes.items():
        for mode, m in SERVE_MODES.items():
            for policy in ("fifo", "homed"):
                srv = DecodeServer(cfg, params, batch_slots=SERVE_SLOTS,
                                   max_len=SERVE_MAX_LEN, locale=locale,
                                   scheduler=policy,
                                   prompt_pad=m["prompt_pad"],
                                   page_size=m["page_size"])
                for d in streams[mode]:
                    srv.submit(Request(**d))
                picks = pick_recorder(srv)
                srv.run()
                one[f"{mname}/{mode}-{policy}"] = picks
    del params, srv
    release()
    t0 = time.perf_counter()
    ranks = spawn(serve_rank_child, SERVE_RANKS, "gloo", device, seed, spec)
    spawn_s = time.perf_counter() - t0
    need(all(r["jax_free"] for r in ranks), "serve_ranks: a rank imported "
                                            "JAX")
    out = {"spawn_s": spawn_s, "meshes": {}, "rank_launches": {},
           "r11": r11_over_ranks(ranks),
           "kernel_checks": rank_kernel_checks(ranks, seed)}
    say("phase serve_ranks flash_attention at every shape the ranks "
        "launched it with, against its plain version: "
        + json.dumps(out["kernel_checks"]))
    for mname, shape in spec["meshes"].items():
        M = shape.get("model", 1)
        res = out["meshes"][mname] = {"runs": {}}
        for run in ranks[0]["meshes"][mname]["runs"]:
            rs = [r["meshes"][mname]["runs"][run] for r in ranks]
            what = f"serve_ranks {mname} {run}"
            need(len({r["digest"] for r in rs}) == 1,
                 f"{what}: the scheduler replicas diverged")
            for r in rs:
                need(not r["schedule"], f"{what}: rank collectives differ "
                                        f"from serve_schedule: "
                                        f"{r['schedule'][:3]}")
                need(r["on_home"], f"{what}: a request decoded off its home")
                need(r["tokens"] == rs[0]["tokens"]
                     and r["summary"] == rs[0]["summary"],
                     f"{what}: the ranks' tokens or summaries differ")
            summary = rs[0]["summary"]
            mode, policy = run.split("-")
            replay = schedule_replay_summary(cfg, streams[mode], mode,
                                             policy, shape)
            need(summary == replay, f"{what}: the summary differs from "
                                    f"schedule_replay's: {summary} vs "
                                    f"{replay}")
            waves = summary["waves"] if mode == "waves" else 0
            launches = [r["launches"].get("flash_attention", 0) for r in rs]
            need(launches == [L * waves] * len(rs),
                 f"{what}: flash_attention launches by rank {launches}, "
                 f"want {L} a prefill wave x {waves}")
            cmp = compare_picks(one[f"{mname}/{run}"],
                                combine_picks(ranks, run, mname, M), tol)
            if cmp["first_logits_rel"] is not None:
                need(cmp["first_logits_rel"] <= tol,
                     f"{what}: the first step's logits differ from one "
                     f"process's by {cmp['first_logits_rel']}")
            toks = rs[0]["tokens"]
            n_tok = sum(len(v) for v in toks.values())
            wall = max(r["wall_s"] for r in rs)
            res["runs"][run] = dict(
                wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                waves=summary["waves"], steps=summary["steps"],
                relayout_bytes=summary["relayout_bytes"],
                inter_pod_bytes=summary["inter_pod_bytes"],
                launches=launches, collectives=[r["collectives"] for r in rs],
                wire=[r["wire"] for r in rs], staged=[r["staged"] for r in rs],
                peak_bytes=[r["peak_bytes"] for r in rs],
                kinds=rs[0]["kinds"], vs_one_process=cmp)
            out["rank_launches"][f"serve_{mname}_{run}"] = launches
            if run == "waves-fifo" and "planted" in ranks[0]["meshes"][mname]:
                n = len({r["home"] for r in rs})
                full = [torch.cat([b for _, b in sorted(
                    (r["tp"], x["meshes"][mname]["planted"])
                    for r, x in zip(rs, ranks) if r["home"] == h)], dim=-1)
                    for h in range(n)]
                first = next(c[4] for c in one[f"{mname}/{run}"]
                             if c[4] is not None)
                cmp["planted_psum_rel"] = rel_err(torch.cat(full), first)
                need(cmp["planted_psum_rel"] > tol,
                     f"{what}: the planted dropped partial sum passes: "
                     f"{cmp['planted_psum_rel']} <= {tol}")
            say(f"phase serve_ranks {mname} {run}: {len(toks)} requests, "
                f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} "
                f"tokens/s), {summary['waves']} waves, {summary['steps']} "
                f"steps; flash_attention by rank {launches}; collectives "
                f"by rank {res['runs'][run]['collectives']} "
                f"({rs[0]['kinds']}), each == serve_schedule, no cache "
                f"bytes; wire B by rank {res['runs'][run]['wire']}, staged "
                f"{res['runs'][run]['staged']}, peak "
                f"{res['runs'][run]['peak_bytes']}; digests equal; against "
                f"one process " + json.dumps(cmp))
        c = ranks[0]["meshes"][mname]["costs"]
        res["costs"] = dict(c, rank_prefill_ms=[
            r["meshes"][mname]["costs"]["prefill_ms"] for r in ranks],
            rank_decode_step_ms=[r["meshes"][mname]["costs"][
                "decode_step_ms"] for r in ranks])
        say(f"phase serve_ranks {mname} costs (rank 0, 8 ranks at once): "
            f"prefill of {c['shape']} {c['prefill_ms']:.2f} ms (busy "
            f"{c['prefill_busy_ms']:.2f}), decode step "
            f"{c['decode_step_ms']:.2f} ms (busy "
            f"{c['decode_step_busy_ms']:.2f}); param bytes a rank "
            f"{ranks[0]['meshes'][mname]['param_bytes']} [{smi}]")
    out["moe"] = serve_ranks_moe(ranks, spec["moe"], seed, device, smi)
    out["f32"] = serve_ranks_f32(ranks, device)
    # the NCCL world of every card, one rank each: (a) once more, untimed
    cards = torch.cuda.device_count()
    if cards > 1:
        nccl = spawn(serve_rank_child, cards, "nccl", device, seed,
                     {"meshes": {"nccl": {"data": cards, "model": 1}},
                      "costs": False})
        out["r11"].update({f"nccl/{k}": v
                           for k, v in r11_over_ranks(nccl).items()})
        for run in nccl[0]["meshes"]["nccl"]["runs"]:
            rs = [r["meshes"]["nccl"]["runs"][run] for r in nccl]
            need(all(not r["schedule"] and r["on_home"] for r in rs)
                 and len({r["digest"] for r in rs}) == 1,
                 f"serve_ranks nccl {run}: schedule or digests differ")
        out["nccl"] = cards
        say(f"phase serve_ranks nccl: {cards} cards, one rank each, (a)'s "
            f"runs served with collectives == serve_schedule")
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase serve_ranks: {out['seconds']:.1f} s ({spawn_s:.1f} s for "
        f"the {SERVE_RANKS} ranks) [{smi}]")
    return out


def rank_kernel_checks(ranks, seed: int) -> dict:
    """`flash_attention` at every distinct call the ranks made (their
    ``kernel_shapes``: each rank's heads of qwen3-0.6b on both meshes and
    of deepseek-moe-16b, bf16 and the float32 check's), on seeded inputs
    of that shape against its plain version within `KERNEL_TOL`."""
    from repro_torch.convert import make_attention_inputs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (KERNEL_TOL,
                                                     flash_attention_reference)
    calls = sorted({tuple(c) for r in ranks for c in r["kernel_shapes"]},
                   key=repr)
    need(calls, "serve_ranks: the ranks made no flash_attention call")
    out = {}
    for call in calls:
        B, H, KV, Sq, Skv, hd, bq, bk, causal, window, dtype = call[:11]
        kw = dict(causal=causal, window=window, block_q=bq, block_k=bk,
                  scale=call[11] if len(call) > 11 else None)
        dt_ = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(a).to(dt_).cuda() for a in
                   make_attention_inputs(B, H, KV, Sq, Skv, hd, dtype, seed))
        with untimed():
            got = ops.flash_attention(q, k, v, **kw)
        plain = flash_attention_reference(q, k, v, **kw)
        rtol, atol = KERNEL_TOL[dt_]
        out[f"{B}x{H}x{KV}x{Sq}x{Skv}x{hd}/{dtype}"] = dict(
            beyond=beyond(got, plain, rtol, atol),
            max_abs_err=float((got.float() - plain.float()).abs().max()))
        del q, k, v, got, plain
    bad = {k: c for k, c in out.items() if c["beyond"]}
    need(not bad, f"serve_ranks: flash_attention outside KERNEL_TOL at the "
                  f"ranks' shapes: {bad}")
    return out


def schedule_replay_summary(cfg, reqs, mode: str, policy: str,
                            shape: dict) -> dict:
    """`schedule_replay`'s summary of a serve stream on `shape`'s homes."""
    from repro_torch.core import HomeMesh, Locale
    from repro_torch.runtime.server import Request, schedule_replay
    dp = tuple(a for a in shape if a != "model")
    m = SERVE_MODES[mode]
    sch = schedule_replay(cfg, [Request(**d) for d in reqs],
                          batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                          locale=Locale(HomeMesh(shape, device="cpu"), dp),
                          scheduler=policy, prompt_pad=m["prompt_pad"],
                          page_size=m["page_size"])
    return json.loads(json.dumps(sch.summary()))


def serve_ranks_moe(ranks, moe: dict, seed: int, device, smi: str) -> dict:
    """(c): deepseek-moe-16b's runs across ranks, each policy's waves
    replayed through the one-process plain model at the same depth."""
    from repro_torch.configs import get_config
    from repro_torch.convert import make_serve_stream
    from repro_torch.models import LM
    from repro_torch.runtime.server import Request
    cfg = get_config(moe["arch"]).replace(num_layers=moe["layers"])
    st = STACK_SERVE[moe["arch"]]
    reqs = make_serve_stream(STACK_REQUESTS, cfg.vocab_size, st["prompt_len"],
                             sessions=st["sessions"], new_tokens=st["new"],
                             slots=STACK_SLOTS, seed=seed)
    params = LM(cfg).init(torch.Generator(device=device).manual_seed(seed))
    out = {"layers": cfg.num_layers, "param_bytes_rank": [
        r["moe"]["param_bytes"] for r in ranks], "runs": {}}
    for policy in SERVE_RANK_MOE_POLICIES:
        rs = [r["moe"]["runs"][policy] for r in ranks]
        what = f"serve_ranks moe {policy}"
        need(len({r["digest"] for r in rs}) == 1
             and all(not r["schedule"] and r["on_home"] for r in rs)
             and all(r["tokens"] == rs[0]["tokens"] for r in rs),
             f"{what}: digests, schedule, homes or tokens differ")
        served = []
        for d in reqs:
            r = Request(**d)
            r.out = list(rs[0]["tokens"][d["rid"]])
            served.append(r)
        waves = replay_form(rs[0]["waves"], reqs)
        rec = replay_waves(cfg, params, waves, served, st["max_len"])
        summary = rs[0]["summary"]
        launches = [r["launches"].get("flash_attention", 0) for r in rs]
        need(launches == [cfg.num_layers * summary["waves"]] * len(rs),
             f"{what}: flash_attention launches by rank {launches}")
        n_tok = sum(len(v) for v in rs[0]["tokens"].values())
        wall = max(r["wall_s"] for r in rs)
        out["runs"][policy] = dict(
            wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
            waves=summary["waves"], launches=launches,
            collectives=[r["collectives"] for r in rs],
            wire=[r["wire"] for r in rs], staged=[r["staged"] for r in rs],
            peak_bytes=[r["peak_bytes"] for r in rs], replay=rec)
        say(f"phase serve_ranks moe {policy}: {cfg.name} at "
            f"{cfg.num_layers} layers on {moe['mesh']}, {n_tok} tokens in "
            f"{wall:.3f} s ({n_tok / wall:.1f} tokens/s), "
            f"{summary['waves']} waves, flash_attention by rank {launches}, "
            f"collectives by rank {out['runs'][policy]['collectives']} == "
            f"serve_schedule, wire B {out['runs'][policy]['wire']}, peak "
            f"{out['runs'][policy]['peak_bytes']}; replay through the plain "
            f"model " + json.dumps(rec) + f" [{smi}]")
    del params
    release()
    return out


def serve_ranks_f32(ranks, device) -> dict:
    """The float32 check: each rank's card tokens equal to its CPU tokens,
    the card's logits within rtol 1e-4 / atol 1e-5 of the CPU's."""
    out = {}
    dev = torch.device(device).type
    for mname in SERVE_RANK_MESHES:
        errs = []
        for r in ranks:
            card, cpu = r["f32"][mname, dev], r["f32"][mname, "cpu"]
            need(card["tokens"] == cpu["tokens"],
                 f"serve_ranks f32 {mname}: rank {r['rank']}'s card tokens "
                 f"differ from its CPU tokens")
            need(torch.allclose(card["logits"], cpu["logits"],
                                rtol=STACK_RTOL, atol=STACK_ATOL),
                 f"serve_ranks f32 {mname}: rank {r['rank']}'s logits "
                 f"outside rtol {STACK_RTOL} atol {STACK_ATOL}")
            errs.append(float((card["logits"] - cpu["logits"]).abs().max()))
        out[mname] = dict(max_abs_err=max(errs), ranks=len(ranks))
    say("phase serve_ranks float32 (reduce_config, card ranks against CPU "
        "ranks): tokens equal, logits " + json.dumps(out))
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

        def timed_save(step, *a, **kw):  # the blocking part: the host copy
            # only the checkpoint the resumed run reads is written: the
            # two runs' saves at step 12 (7.5 GB each) nothing reads
            if step != TRAIN_CKPT_AT:
                return False
            t0 = time.perf_counter()
            saved = maybe_save(step, *a, **kw)
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
            last = os.path.join(tmp, f"step_{TRAIN_CKPT_AT:08d}")
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
            tr, times, _ = trainer("resumed")   # it resumes at step 6

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


# ---------------------------------------------------------------------------
# train_ranks: training across torch.distributed ranks sharing the card
# ---------------------------------------------------------------------------
TRAIN_RANKS = 8
#: (a) qwen3-0.6b at full width and depth on 8 ranks, the train phase's
#: rows (one a home) and learning-rate schedule, 2 steps with a checkpoint
#: at step 1 from which a second trainer replays step 2 (cut from 4 steps
#: and a replay of 2 for the phase's time: a step takes ~13 s)
TRAIN_RANK_QWEN = dict(mesh={"data": 2, "model": 4}, steps=2, ckpt_at=1)
#: (a)'s planted fault on a fresh step 1 (another costs a step, ~16 s)
TRAIN_RANK_PLANTED = ("dp_skip",)
#: (b) granite-20b at full width, 1 of its 52 layers (52 layers' float32
#: AdamW state alone is 160 GB), FSDP over ("pod", "data"), its own
#: knobs (SP, remat, 4 microbatches); global batch 16 (one row a home a
#: microbatch), S cut from 4096 to 1024, 1 step (cut from 2) and 1 layer
#: (cut from 2) for the phase's time: at 2 layers a step took 40-60 s,
#: the FSDP gathers' 13.9 GB a rank through gloo; before it, the planted
#: wrong-home gather's forward (the loss alone: at 2 layers a whole step
#: read 8.7e-4 in the loss, 2.9e-3 in the norm, and took another 54 s on
#: an H100)
TRAIN_RANK_GRANITE = dict(arch="granite-20b", layers=1, batch=16, seq=1024,
                          mesh={"pod": 2, "data": 2, "model": 2}, steps=1)
#: the ranks' bf16 losses (each step) and step 1's gradient norm against
#: one process's on the same rows, relative.  The split products' partial
#: sums round to bfloat16 once per rank before they are added where one
#: process rounds the whole product once, and gloo's float32 sums add in
#: another order; the first readings on the card (H100) were 2.0e-6 to
#: 4.8e-6 for the losses and 1.1e-5 to 9.4e-5 for the norms.  A block
#: gathered from the wrong home read 8.7e-4 (loss) and 2.9e-3 (norm) at
#: full width, rank 0's skipped dp sums 6.2e-2 (norm): the bounds lie
#: between the two, ~50x and ~10x above the sound readings and ~3x below
#: the smallest fault's
TRAIN_RANK_LOSS_RTOL = 2.0 ** -12
TRAIN_RANK_NORM_RTOL = 2.0 ** -10
#: (c) float32 at reduce_config (the archs' parallel knobs kept), card
#: ranks against CPU ranks, 2 steps: losses, norms, m and v, and the
#: updated parameters (`held_f32`); on the card, granite's planted
#: wrong-home gather must move step 1's loss or norm beyond it
TRAIN_RANK_F32_TOL = 1e-5
TRAIN_RANK_F32 = {"qwen3-0.6b": ({"data": 2, "model": 4}, 4),
                  "granite-20b": ({"pod": 2, "data": 2, "model": 2}, 16)}
TRAIN_RANK_TIMEOUT_S = 900


def step_digests(params, state, specs, mesh, last: bool) -> dict:
    """`rank_digests` of the parameters after a step, and of the
    optimiser state too after a run's `last` step (hashing the float32
    state every step costs ~3 s a step a rank)."""
    if last:
        return rank_digests({"params": params, "opt": state}, specs, mesh)
    return rank_digests({"params": params}, {"params": specs["params"]},
                        mesh)


def rank_digests(tree, specs, mesh) -> dict:
    """``{path: [the rank's coordinates on the axes its spec cuts by,
    SHA-256 of the block]}``: ranks with equal coordinates hold the same
    block, so their digests must be equal."""
    import hashlib
    from repro_torch.tree import tree_items
    spec_of = dict(tree_items(specs))
    out = {}
    for path, t in tree_items(tree):
        used = {a for d in spec_of[path]
                for a in ((d,) if isinstance(d, str) else (d or ()))}
        where = sorted((a, mesh.coords[a]) for a in used if a in mesh.shape)
        data = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
        out["/".join(path)] = [where, hashlib.sha256(
            data.numpy().tobytes()).hexdigest()]
    return out


def replica_mismatches(ranks: list, key) -> list:
    """The blocks whose holders' digests differ, over `key(rank result)`
    (a `rank_digests` dict)."""
    held = {}
    for r in ranks:
        for path, (where, digest) in key(r).items():
            held.setdefault((path, json.dumps(where)), set()).add(digest)
    return sorted(k for k, v in held.items() if len(v) > 1)


def train_rank_state(cfg, plan, seed: int, device, lr, gen_device=None):
    """A rank's parameter blocks drawn from `seed` (`LM.init` cut a
    superblock at a time), AdamW over them and its state, the step."""
    from repro_torch.convert import rank_cut
    from repro_torch.models import LM, steps
    from repro_torch.optim import AdamW
    gen = torch.Generator(device=gen_device or device).manual_seed(seed)
    params = LM(cfg).init(gen, cut=rank_cut(plan, cfg, train=True))
    params = {k: v for k, v in params.items()}
    if gen_device is not None:
        from repro_torch.tree import tree_map
        params = tree_map(lambda t: t.to(device), params)
    opt = AdamW(lr=lr)
    state = steps.init_opt_state(cfg, opt, params, plan)
    return params, opt, state, steps.make_train_step(
        LM(cfg, flash=False), cfg, plan, opt)


@contextlib.contextmanager
def planted_train_fault(kind: str, mesh):
    """A planted fault of the train step across ranks: ``"dp_skip"``,
    rank 0 keeps its own gradients (their sums over the dp axes and
    "model" skipped, the collectives still made); ``"wrong_home"``, every
    superblock's gathered ``w_down`` rolled by one FSDP block (blocks
    from the wrong home)."""
    from repro_torch.models import blocks, steps
    with contextlib.ExitStack() as stack:
        if kind == "dp_skip":
            real = steps.RankGrads.reduce

            def reduce(self, grads):
                out = real(self, grads)        # rank 0 still takes part
                return list(grads) if mesh.rank == 0 else out
            stack.enter_context(mock.patch.object(steps.RankGrads, "reduce",
                                                  reduce))
        elif kind == "wrong_home":
            real = blocks.fsdp_gather

            def gather(tree, plan, cfg):
                out = real(tree, plan, cfg)
                w = out["m0"]["mlp"]["w_down"]
                k = plan.axis_size(plan.fsdp_axes)
                out["m0"]["mlp"]["w_down"] = torch.roll(
                    w, w.shape[1] // k, dims=1)
                return out
            stack.enter_context(mock.patch.object(blocks, "fsdp_gather",
                                                  gather))
        yield


def timed_step(fn, params, state, batch, device, sched=None, accept=None):
    """One train step on this rank: its host ms (between synchronises),
    metrics, collective log against `sched` and peak memory."""
    from repro_torch.analysis.livecheck import log_signature
    from repro_torch.core import collectives
    from repro_torch.obs.schedule import log_against_train
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_collectives()
    t0 = time.perf_counter()
    params, state, m = fn(params, state, batch, accept=accept)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    log = collectives.collective_log()
    return params, state, {
        "ms": ms, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "step": float(m["step"]),
        "schedule": log_against_train(log, sched)[:3] if sched else None,
        "collectives": len(log), "signature": log_signature(log),
        "wire": sum(r["wire_bytes"] for r in log),
        "inter_pod": sum(r["inter_pod_bytes"] for r in log),
        "staged": sum(r["staged_bytes"] for r in log),
        "peak_bytes": torch.cuda.max_memory_allocated()}


def progress(mesh, line: str) -> None:
    """Rank 0's progress line, with the seconds since the rank started
    (the ranks' results come back only at the end of the spawn)."""
    if mesh.rank == 0:
        say(f"train_ranks progress: {time.perf_counter() - T0_RANK:.1f} s: "
            f"{line}")


#: when this rank process started its phase work (`train_rank_child`)
T0_RANK = 0.0


def train_rank_qwen(mesh, seed: int, ckpt_dir: str) -> dict:
    """(a): the planted fault on step 1, the straight `Trainer` run, the
    resumed one (its step rank 0's under `torch.profiler`)."""
    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.schedule import train_schedule
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime import trainer as trainer_mod
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding import partition
    cfg = get_config(TRAIN_ARCH)
    spec = TRAIN_RANK_QWEN
    device = mesh.device
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = partition.make_plan(mesh, cfg, shape)
    sched = train_schedule(cfg, plan, shape)
    lr = cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, mesh)
    out = {"planted": {}}
    for kind in TRAIN_RANK_PLANTED:
        params, opt, state, fn = train_rank_state(cfg, plan, seed, device, lr)
        with planted_train_fault(kind, mesh):
            params, state, rec = timed_step(fn, params, state, data.batch(0),
                                            device)
        rec["digests"] = rank_digests(
            {"params": params},
            {"params": partition.param_specs(params, plan, cfg)}, mesh)
        out["planted"][kind] = rec
        progress(mesh, f"qwen planted {kind} {rec['ms']:.1f} ms")
        del params, state, fn, opt
        release()

    def trainer(profiled: bool):
        tr = Trainer(cfg, TrainerConfig(
            steps=spec["steps"], global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            ckpt_dir=ckpt_dir, ckpt_every=spec["ckpt_at"], log_every=1,
            seed=seed, warmup=TRAIN_WARMUP, lr=TRAIN_LR,
            schedule_total=TRAIN_STEPS, device=device), plan, mesh)
        inner, recs, saves = tr.step_fn, [], []

        def step_fn(params, state, batch, accept=None):
            if profiled and mesh.rank == 0:
                got = {}

                def one():
                    got["r"] = timed_step(inner, params, state, batch,
                                          device, sched, accept)
                busy = device_busy_ms(one)
                params, state, rec = got["r"]
                rec["busy_ms"] = busy
            else:
                params, state, rec = timed_step(inner, params, state, batch,
                                                device, sched, accept)
            t0 = time.perf_counter()
            rec["digests"] = step_digests(
                params, state, tr.specs(params, state), mesh,
                float(rec["step"]) == spec["steps"])
            rec["digest_s"] = time.perf_counter() - t0
            recs.append(rec)
            progress(mesh, f"qwen step {rec['step']:.0f} {rec['ms']:.1f} ms "
                           f"(digests {rec['digest_s']:.1f} s)")
            return params, state, {k: torch.tensor(rec[k]) for k in
                                   ("loss", "grad_norm", "step")}
        tr.step_fn = step_fn
        real_save = tr.ckpt.maybe_save

        def maybe_save(step, *a, **kw):
            # only the checkpoint the resume reads is written: the
            # trainer's final saves take 12-16 s each on 8 ranks
            if step != spec["ckpt_at"]:
                return False
            t0 = time.perf_counter()
            saved = real_save(step, *a, **kw)
            if saved:
                saves.append(time.perf_counter() - t0)
                progress(mesh, f"qwen save {saves[-1]:.1f} s")
            return saved
        tr.ckpt.maybe_save = maybe_save
        return tr, recs, saves

    tr, recs, saves = trainer(False)
    t0 = time.perf_counter()
    tr.run()
    out["straight_s"] = time.perf_counter() - t0
    out["straight"], out["save_s"] = recs, saves
    saved = os.path.join(ckpt_dir, f"step_{spec['ckpt_at']:08d}")
    out["ckpt_bytes"] = sum(os.path.getsize(os.path.join(saved, f))
                            for f in os.listdir(saved))
    del tr
    release()
    dist.barrier()
    tr, recs, saves = trainer(True)
    reads = []
    real_restore = ckpt_mod.restore

    def restore(*a, **kw):
        t0 = time.perf_counter()
        r = real_restore(*a, **kw)
        reads.append(time.perf_counter() - t0)
        return r
    with mock.patch.object(trainer_mod, "restore", restore):
        tr.run()
    out["resumed"], out["restore_s"] = recs, reads
    if mesh.rank == 0:
        out["busy_ms"] = recs[-1]["busy_ms"]
    del tr
    release()
    return out


def forward_loss(cfg, plan, params, batch) -> float:
    """The train step's loss metric from its forward alone: the nll of
    each microbatch (`steps._micro_split`, homed as the step homes them),
    averaged over the homes as the step does.  Grad stays enabled, so the
    model takes its training layout (FSDP gathers, the sequence split,
    the MoE's training route); no backward runs and nothing is written."""
    from repro_torch.core import collectives
    from repro_torch.models import LM, steps
    from repro_torch.sharding.partition import homes_of
    loss_fn = steps.make_loss_fn(LM(cfg, flash=False), cfg, plan)
    n = homes_of(plan)[0]
    with torch.enable_grad():
        nll = torch.stack([loss_fn(params, one)[1].detach() for one in
                           steps._micro_split(
                               batch, max(cfg.parallel.microbatches, 1),
                               plan)])
        if n > 1:
            nll = collectives.psum(nll, plan.mesh, plan.batch_axes) / n
    return float(nll.mean())


def train_rank_granite(mesh, seed: int) -> dict:
    """(b): the loss of step 1's batch under the planted wrong-home gather
    (a forward only, nothing written), then the steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.schedule import train_schedule
    from repro_torch.optim import cosine_schedule
    from repro_torch.sharding import partition
    g = TRAIN_RANK_GRANITE
    cfg = get_config(g["arch"]).replace(num_layers=g["layers"])
    device = mesh.device
    shape = ShapeSpec("train", g["seq"], g["batch"], "train")
    plan = partition.make_plan(mesh, cfg, shape)
    sched = train_schedule(cfg, plan, shape)
    lr = cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    params, opt, state, fn = train_rank_state(cfg, plan, seed, device, lr)
    data = SyntheticLM(cfg, g["batch"], g["seq"], seed, mesh)
    out = {"steps": [], "param_bytes": sum(
        t.numel() * t.element_size() for t in tree_leaves(params))}
    specs = {"params": partition.param_specs(params, plan, cfg),
             "opt": partition.full_opt_specs(state, params, plan, cfg)}
    with planted_train_fault("wrong_home", mesh):
        sync(device)
        t0 = time.perf_counter()
        loss = forward_loss(cfg, plan, params, data.batch(0))
        out["planted"] = {"loss": loss,
                          "ms": (time.perf_counter() - t0) * 1e3}
    progress(mesh, f"granite planted wrong_home {out['planted']['ms']:.1f} "
                   f"ms (forward)")
    for i in range(g["steps"]):
        params, state, rec = timed_step(fn, params, state, data.batch(i),
                                        device, sched)
        rec["digests"] = step_digests(params, state, specs, mesh, False)
        out["steps"].append(rec)
        progress(mesh, f"granite step {i + 1} {rec['ms']:.1f} ms")
    del params, state, fn, opt
    release()
    return out


def cpu_twin(mesh):
    """`mesh` (its process groups) with its tensors on the CPU: gloo takes
    both, and a second `RankMesh` would connect every subgroup again."""
    twin = copy.copy(mesh)
    twin.device = torch.device("cpu")
    return twin


def train_rank_f32(seed: int, meshes: dict) -> dict:
    """(c): each arch of `TRAIN_RANK_F32` at `reduce_config` in float32
    (its parallel knobs kept), 2 steps on the card and on the CPU from the
    same draw, on `meshes` (by arch) and their CPU twins: losses, norms and
    this rank's blocks of the parameters and of AdamW's m and v."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import cosine_schedule
    from repro_torch.sharding import partition
    from repro_torch.tree import tree_items
    out = {}
    for arch, (shape, GB) in TRAIN_RANK_F32.items():
        full = get_config(arch)
        cfg = reduce_config(full).replace(parallel=full.parallel)
        for mesh in (meshes[arch], cpu_twin(meshes[arch])):
            need(mesh.shape == shape, f"train_ranks f32: {mesh!r}")
            dev = mesh.device
            sh = ShapeSpec("train", 32, GB, "train")
            plan = partition.make_plan(mesh, cfg, sh)
            params, _, state, fn = train_rank_state(
                cfg, plan, seed, dev, cosine_schedule(TRAIN_LR, TRAIN_WARMUP,
                                                      TRAIN_STEPS),
                gen_device="cpu")
            data = SyntheticLM(cfg, GB, 32, seed, mesh)
            if plan.fsdp_axes and dev.type != "cpu":
                with planted_train_fault("wrong_home", mesh):
                    _, _, m = fn(params, state, data.batch(0),
                                 accept=lambda m: False)
                out[arch, "planted"] = [float(m["loss"]),
                                        float(m["grad_norm"])]
            metrics = []
            for i in range(2):
                params, state, m = fn(params, state, data.batch(i))
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            adam = state["adam"]
            out[arch, dev.type] = {
                "metrics": metrics,
                "params": {"/".join(p): t.detach().cpu().clone()
                           for p, t in tree_items(params)},
                "moments": {"/".join(p): t.detach().cpu().clone()
                            for p, t in tree_items({"m": adam["m"],
                                                    "v": adam["v"]})}}
    return out


def train_rank_child(device, seed: int, ckpt_dir: str) -> dict:
    """One rank of the train_ranks phase (see the module docstring, 8g)."""
    need("jax" not in sys.modules, "a rank process imported JAX")
    import torch.distributed as dist
    from repro_torch.kernels import ops
    global T0_RANK
    T0_RANK = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    ops.reset_launches()
    from repro_torch.core.mesh import RankMesh
    out = {"rank": dist.get_rank()}
    meshes = {TRAIN_ARCH: RankMesh(TRAIN_RANK_QWEN["mesh"], device=device),
              TRAIN_RANK_GRANITE["arch"]: RankMesh(TRAIN_RANK_GRANITE["mesh"],
                                                   device=device)}
    out["qwen"] = train_rank_qwen(meshes[TRAIN_ARCH], seed, ckpt_dir)
    out["granite"] = train_rank_granite(meshes[TRAIN_RANK_GRANITE["arch"]],
                                        seed)
    out["f32"] = train_rank_f32(seed, meshes)
    if out["rank"] == 0:
        say("train_ranks progress: float32 done")
    out["flash_launches"] = ops.launch_counts()["flash_attention"]
    out["jax_free"] = "jax" not in sys.modules
    return out


def train_ranks_one(seed: int) -> dict:
    """(b)'s yardstick in its own process (`--train-ranks-child`): the
    same 2-layer granite-20b in one process on the same rows, step 1's
    loss and gradient norm (nothing written)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM, steps
    from repro_torch.optim import AdamW, cosine_schedule
    g = TRAIN_RANK_GRANITE
    torch.use_deterministic_algorithms(True)
    cfg = get_config(g["arch"]).replace(num_layers=g["layers"])
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(seed))
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    fn = steps.make_train_step(LM(cfg, flash=False), cfg, steps.NULL_PLAN,
                               opt)
    batch = SyntheticLM(cfg, g["batch"], g["seq"], seed,
                        device="cuda").batch(0)
    state = {"adam": {"step": torch.zeros((), dtype=torch.int32,
                                          device="cuda")}}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, m = fn(params, state, batch, accept=lambda m: False)
    torch.cuda.synchronize()
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "s": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def held_f32(got: torch.Tensor, want: torch.Tensor, far: float) -> int:
    """Elements of `got` outside `TRAIN_RANK_F32_TOL` of `want` (absolute
    and relative); each must lie within `far` and they may be at most
    0.1 %.  A parameter's `far` is the learning rate a step: AdamW's step
    ``m / (sqrt(v) + eps)`` turns on the rounding where a gradient element
    is near zero, though its m and v agree (they are held with `far` 0,
    no element outside)."""
    d = (got - want).abs()
    off = d > TRAIN_RANK_F32_TOL * (1 + want.abs())
    need(off.float().mean() <= 1e-3 and (d[off] <= far).all(),
         f"train_ranks f32: {int(off.sum())} of {off.numel()} elements "
         f"outside {TRAIN_RANK_F32_TOL}, largest {float(d.max())}")
    return int(off.sum())


def phase_train_ranks(seed: int, smi: str, train: dict) -> dict:
    """Training across ranks (see the module docstring, 8g).  `train`
    holds the train phase's one-process run, whose rows (a) trains."""
    from repro_torch.launch.mesh import spawn
    t_phase = time.perf_counter()
    release()
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_ranks_")
    path, ckpt_dir = os.path.join(tmp, "one.json"), os.path.join(tmp, "ck")
    # (b)'s yardstick runs beside the ranks (18.5 GB beside their ~48 GB)
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                              "--train-ranks-child", path, "--seed",
                              str(seed)], env=env)
    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t0 = time.perf_counter()
    try:
        ranks = spawn(train_rank_child, TRAIN_RANKS, "gloo", "cuda", seed,
                      ckpt_dir, timeout_s=TRAIN_RANK_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        rc = child.wait(timeout=TRAIN_TIMEOUT_S)
        need(rc == 0, f"train_ranks: the one-process granite child exited "
                      f"{rc}")
        with open(path) as f:
            one = json.load(f)
    finally:
        if child.poll() is None:
            child.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        if old is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old
    one_s = one["s"]
    need(all(r["jax_free"] for r in ranks), "train_ranks: a rank imported "
                                            "JAX")
    out = {"one_s": one_s, "spawn_s": spawn_s, "one": one,
           "r11": r11_over_ranks(ranks),
           "flash_launches": [r["flash_launches"] for r in ranks]}
    need(not any(out["flash_launches"]), f"train_ranks: flash_attention "
         f"launched in training: {out['flash_launches']}")

    def per_rank(recs, key):
        return [r[key] for r in recs]

    # ---- (a) qwen3-0.6b ----
    a = {}
    straight = {rec["step"]: rec for rec in train["straight"]}
    qs = [r["qwen"] for r in ranks]
    for run in ("straight", "resumed"):
        for i in range(len(qs[0][run])):
            recs = [q[run][i] for q in qs]
            for rec in recs:
                need(rec["schedule"] == [], f"train_ranks qwen {run} step "
                     f"{i}: rank collectives differ from train_schedule: "
                     f"{rec['schedule']}")
            need(len({(rec["loss"], rec["grad_norm"]) for rec in recs}) == 1,
                 f"train_ranks qwen {run}: the ranks' metrics differ")
        bad = replica_mismatches(qs, lambda q: q[run][-1]["digests"])
        need(not bad, f"train_ranks qwen {run}: replicas differ {bad[:3]}")
        for i in range(len(qs[0][run])):
            bad = replica_mismatches(qs, lambda q: q[run][i]["digests"])
            need(not bad, f"train_ranks qwen {run} step {i + 1}: replicas "
                          f"differ {bad[:3]}")
    losses = [rec["loss"] for rec in qs[0]["straight"]]
    a["losses"] = losses
    a["loss_rel"] = [rel(l, straight[s + 1]["loss"])
                     for s, l in enumerate(losses)]
    a["norm_rel"] = rel(qs[0]["straight"][0]["grad_norm"],
                        straight[1]["grad_norm"])
    need(max(a["loss_rel"]) <= TRAIN_RANK_LOSS_RTOL,
         f"train_ranks qwen: losses {losses} against the one-process "
         f"{[straight[s + 1]['loss'] for s in range(len(losses))]}: "
         f"{a['loss_rel']}")
    need(a["norm_rel"] <= TRAIN_RANK_NORM_RTOL,
         f"train_ranks qwen: step 1's norm {a['norm_rel']} apart")
    at = TRAIN_RANK_QWEN["ckpt_at"]
    resumed = [(rec["loss"], rec["grad_norm"]) for rec in qs[0]["resumed"]]
    need(resumed == [(rec["loss"], rec["grad_norm"])
                     for rec in qs[0]["straight"][at:]],
         f"train_ranks qwen: the resumed run's steps {resumed} differ")
    for q in qs:
        need(q["resumed"][-1]["digests"] == q["straight"][-1]["digests"],
             f"train_ranks qwen: rank {ranks[qs.index(q)]['rank']}'s "
             f"resumed parameters differ from the straight run's")
    a["planted"] = {}
    for kind, rec in qs[0]["planted"].items():
        caught = bool(replica_mismatches(
            qs, lambda q: q["planted"][kind]["digests"]))
        a["planted"][kind] = dict(
            norm_rel=rel(rec["grad_norm"], straight[1]["grad_norm"]),
            loss_rel=rel(rec["loss"], straight[1]["loss"]),
            digests_caught=caught)
        need(caught, f"train_ranks qwen: the planted {kind} fault passes "
                     f"the replica digests")
    need(a["planted"]["dp_skip"]["norm_rel"] > TRAIN_RANK_NORM_RTOL,
         f"train_ranks qwen: the planted dp_skip fault passes the norm "
         f"bound: {a['planted']['dp_skip']}")
    a["step_ms"] = [max(q["straight"][i]["ms"] for q in qs)
                    for i in range(len(qs[0]["straight"]))]
    a["step_ms_median"] = statistics.median(a["step_ms"][1:])
    a["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (a["step_ms_median"] / 1e3)
    a["busy_ms"] = qs[0]["busy_ms"]
    last = [q["straight"][-1] for q in qs]
    for key in ("collectives", "wire", "inter_pod", "staged", "peak_bytes"):
        a[key] = per_rank(last, key)
    a["ckpt_bytes"] = qs[0]["ckpt_bytes"]
    a["save_s"], a["restore_s"] = qs[0]["save_s"], qs[0]["restore_s"]
    out["qwen"] = a

    # ---- (b) granite-20b, 2 layers ----
    g = TRAIN_RANK_GRANITE
    b = {}
    gs = [r["granite"] for r in ranks]
    for i in range(g["steps"]):
        for rec in (x["steps"][i] for x in gs):
            need(rec["schedule"] == [], f"train_ranks granite step {i + 1}: "
                 f"rank collectives differ from train_schedule: "
                 f"{rec['schedule']}")
        bad = replica_mismatches(gs, lambda x: x["steps"][i]["digests"])
        need(not bad, f"train_ranks granite step {i + 1}: replicas differ "
                      f"{bad[:3]}")
    first = gs[0]["steps"][0]
    b["loss_rel"] = rel(first["loss"], one["loss"])
    b["norm_rel"] = rel(first["grad_norm"], one["grad_norm"])
    need(b["loss_rel"] <= TRAIN_RANK_LOSS_RTOL
         and b["norm_rel"] <= TRAIN_RANK_NORM_RTOL,
         f"train_ranks granite: step 1 {first['loss']}, {first['grad_norm']}"
         f" against one process's {one['loss']}, {one['grad_norm']}")
    planted = [x["planted"]["loss"] for x in gs]
    need(len(set(planted)) == 1, f"train_ranks granite: the ranks' planted "
                                 f"losses differ: {planted}")
    b["planted"] = {"wrong_home": dict(
        loss_rel=rel(planted[0], one["loss"]),
        forward_ms=max(x["planted"]["ms"] for x in gs))}
    p = b["planted"]["wrong_home"]
    need(p["loss_rel"] > TRAIN_RANK_LOSS_RTOL,
         f"train_ranks granite: the planted wrong-home gather passes the "
         f"loss bound: {p}")
    b["losses"] = [x["loss"] for x in gs[0]["steps"]]
    b["step_ms"] = [max(x["steps"][i]["ms"] for x in gs)
                    for i in range(g["steps"])]
    b["step_ms_median"] = statistics.median(b["step_ms"][1:]
                                            or b["step_ms"])
    b["tokens_per_s"] = g["batch"] * g["seq"] / (b["step_ms_median"] / 1e3)
    last = [x["steps"][-1] for x in gs]
    for key in ("collectives", "wire", "inter_pod", "staged", "peak_bytes"):
        b[key] = per_rank(last, key)
    b["param_bytes"] = per_rank(gs, "param_bytes")
    out["granite"] = b

    # ---- (c) float32, card ranks against CPU ranks ----
    c = {}
    for arch in TRAIN_RANK_F32:
        errs, moment_errs, outliers = [], [], 0
        for r in ranks:
            card, cpu = r["f32"][arch, "cuda"], r["f32"][arch, "cpu"]
            for (lc, nc), (lp, np_) in zip(card["metrics"], cpu["metrics"]):
                need(abs(lc - lp) <= TRAIN_RANK_F32_TOL * (1 + abs(lp)),
                     f"train_ranks f32 {arch}: losses {lc} and {lp}")
                need(abs(nc - np_) <= TRAIN_RANK_F32_TOL * (1 + abs(np_)),
                     f"train_ranks f32 {arch}: norms {nc} and {np_}")
            for k, t in card["params"].items():
                outliers += held_f32(t, cpu["params"][k], 2 * TRAIN_LR * 2)
                errs.append(float((t - cpu["params"][k]).abs().max()))
            for k, t in card["moments"].items():
                held_f32(t, cpu["moments"][k], 0.0)
                moment_errs.append(float((t - cpu["moments"][k]).abs().max()))
        planted = ranks[0]["f32"].get((arch, "planted"))
        if planted is not None:
            step1 = ranks[0]["f32"][arch, "cuda"]["metrics"][0]
            moved = max(rel(planted[0], step1[0]), rel(planted[1], step1[1]))
            need(moved > TRAIN_RANK_F32_TOL, f"train_ranks f32 {arch}: the "
                 f"planted wrong-home gather moves step 1 by {moved}")
            planted = moved
        pairs = [(x, y) for r in ranks for x, y in zip(
            r["f32"][arch, "cuda"]["metrics"],
            r["f32"][arch, "cpu"]["metrics"])]
        c[arch] = dict(planted_rel=planted, max_abs_err=max(errs),
                       outliers=outliers, moment_err=max(moment_errs),
                       loss_err=max(abs(x[0] - y[0]) for x, y in pairs),
                       norm_err=max(abs(x[1] - y[1]) for x, y in pairs))
    out["f32"] = c
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase train_ranks qwen ({smi}): {TRAIN_ARCH} bf16 at full width "
        f"and depth on {TRAIN_RANK_QWEN['mesh']} ({TRAIN_RANKS} gloo ranks "
        f"sharing the card), batch {TRAIN_BATCH} x {TRAIN_SEQ}: step ms by "
        f"the slowest rank's host clock {[round(x, 1) for x in a['step_ms']]}"
        f", median of steps 2- {a['step_ms_median']:.1f} ms, "
        f"{a['tokens_per_s']:.0f} tokens/s; rank 0 busy "
        f"{a['busy_ms']:.1f} ms a step (torch.profiler); losses "
        f"{[round(x, 5) for x in losses]} against one process's "
        f"{[round(straight[s + 1]['loss'], 5) for s in range(len(losses))]}"
        f" (relative "
        f"{[f'{x:.3g}' for x in a['loss_rel']]} <= {TRAIN_RANK_LOSS_RTOL}), "
        f"step 1's norm {a['norm_rel']:.3g} apart (<= "
        f"{TRAIN_RANK_NORM_RTOL}); resumed from step {at}: bit-identical; "
        f"every "
        f"rank's log == train_schedule, replicas equal by SHA-256 after "
        f"every step; planted " + json.dumps(a["planted"]))
    say(f"phase train_ranks qwen bytes ({smi}): by rank, a step's "
        f"collectives {a['collectives']}, wire {a['wire']}, inter-pod "
        f"{a['inter_pod']}, staged {a['staged']}, peak {a['peak_bytes']}; "
        f"checkpoint {a['ckpt_bytes']} B, saves s "
        f"{[round(x, 2) for x in a['save_s']]}, restore s "
        f"{[round(x, 2) for x in a['restore_s']]}")
    say(f"phase train_ranks granite ({smi}): granite-20b bf16 at full "
        f"width, {g['layers']} of 52 layers, on {g['mesh']} (FSDP over "
        f"pod and data), batch {g['batch']} x {g['seq']}, 4 microbatches: "
        f"step ms {[round(x, 1) for x in b['step_ms']]}, "
        f"{b['tokens_per_s']:.0f} tokens/s; step 1 loss "
        f"{b['losses'][0]:.5f} against one process's {one['loss']:.5f} "
        f"({b['loss_rel']:.3g}), norm {b['norm_rel']:.3g} apart; planted "
        + json.dumps(b["planted"]) + "; collectives "
        f"{b['collectives']}, wire {b['wire']}, inter-pod {b['inter_pod']},"
        f" staged {b['staged']}, peak {b['peak_bytes']}, parameter bytes "
        f"{b['param_bytes']}; one process {one['peak_bytes']} B peak, "
        f"{one['s']:.1f} s")
    say("phase train_ranks float32 (reduce_config, card ranks against CPU "
        "ranks, 2 steps): " + json.dumps(c) + f"; flash_attention launches "
        f"by rank {out['flash_launches']}; phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# model_split: Mamba2 and cross attention over "model", and decode caches
# homed by sequence, across torch.distributed ranks sharing the card
# ---------------------------------------------------------------------------
MODEL_SPLIT_RANKS = 8
MODEL_SPLIT_MESH = {"data": 2, "model": 4}
#: (a) mamba2-2.7b at full width on `MODEL_SPLIT_MESH` (20 of its 80 SSD
#: heads a rank), its depth cut from 64 to 16 layers and the serve_ranks
#: phase's aligned-wave stream to its first 16 requests (one wave of the
#: 16 slots homed over the 2 homes; prompts of 128-768 padded to 768,
#: three SSD chunks) for the phase's time, under the homed policy; one
#: train step of 2 x 1024 (its own knobs: the sequence-sharded residual,
#: remat, no FSDP)
MODEL_SPLIT_MAMBA = dict(arch="mamba2-2.7b", layers=16, policy="homed",
                         requests=16, pad=768, batch=2, seq=1024)
#: (b) llama-3.2-vision-90b at full width, one superblock (4 self and 1
#: cross layer), the stack phase's (2, 512) prompts over 4096 image
#: tokens and 4 decode steps, on `MODEL_SPLIT_MESH` (16 q and 2 KV heads a
#: rank, a home's one row)
MODEL_SPLIT_VISION_STEPS = 4
#: (c) the decode cache homed by sequence (caches of 8192 positions or
#: more): qwen3-0.6b at 7 of 28 layers, 1 slot (it does not divide over 8
#: homes: the cache over "data", 2048 slots a rank), one 12,000-token
#: prompt; glm4-9b at 2 of 40 layers, 2 slots on `MODEL_SPLIT_MESH` (its
#: 2 KV heads do not divide over 4: the cache over "model", 2048 slots a
#: rank), prompts of about 6,000 tokens; each served in aligned waves
#: (fifo), 9 tokens a request (8 decode steps)
MODEL_SPLIT_SEQ = {
    "qwen_data": dict(arch="qwen3-0.6b", layers=7, mesh="data8", axis="data",
                      slots=1, max_len=16384, prompt=(12000, 12000), new=9),
    "glm_model": dict(arch="glm4-9b", layers=2, mesh="d2m4", axis="model",
                      slots=2, max_len=8192, prompt=(5800, 6200), new=9)}
#: the merge check's planted fault: block 1's partial dropped from every
#: merge (its max score set to -1e30, so its weight is 0)
MODEL_SPLIT_DROPPED = 1


def model_split_inputs(cfg, seed: int, device):
    """(b)'s inputs: the stack phase's prompt tokens and image embeddings,
    and the tokens fed to the decode steps (whole batches, on `device`)."""
    rng = np.random.default_rng(seed)
    B, S, n = STACK_VISION_B, STACK_VISION_S, cfg.num_image_tokens
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S))).to(device),
        "image_embeds": (0.1 * torch.randn(
            B, n, cfg.d_model, generator=torch.Generator(
                device=device).manual_seed(seed + 2), device=device)).to(
                    torch.bfloat16)}
    fed = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, MODEL_SPLIT_VISION_STEPS))).to(device)
    return batch, fed


def model_split_stream(cfg, spec: dict, seed: int) -> list:
    """(c)'s requests: one a slot, all arriving at once."""
    from repro_torch.convert import make_serve_stream
    return make_serve_stream(spec["slots"], cfg.vocab_size, spec["prompt"],
                             sessions=1, new_tokens=(spec["new"],) * 2,
                             slots=spec["slots"], seed=seed)


@contextlib.contextmanager
def unsummed_stat():
    """(a)'s planted fault: the gated norm's statistic left unsummed over
    "model" (each rank normalises by its own columns' sum of squares)."""
    from repro_torch.models import common
    with mock.patch.object(common, "psum_stat", lambda x, plan: x):
        yield


@contextlib.contextmanager
def dropped_partial():
    """(c)'s planted fault: block `MODEL_SPLIT_DROPPED`'s partial dropped
    from every merge of the blocks' attention."""
    from repro_torch.models import attention
    real = attention.merge_partials

    def merge(parts):
        parts = parts.clone()
        parts[MODEL_SPLIT_DROPPED, ..., -2] = attention.NEG_INF
        return real(parts)
    with mock.patch.object(attention, "merge_partials", merge):
        yield


def first_pick_logits(cfg, params, plan, reqs, *, slots, max_len, pad,
                      policy) -> torch.Tensor:
    """The first pick's logits (this rank's rows and vocabulary block) of
    an aligned-wave run; every rank stops at the same pick."""
    from repro_torch.runtime.server import DecodeServer, Request
    got = {}

    def _pick(logits):
        got["logits"] = logits.float().cpu()
        raise _FirstPick
    srv = DecodeServer(cfg, params, batch_slots=slots, max_len=max_len,
                       plan=plan, scheduler=policy, prompt_pad=pad)
    for d in reqs:
        srv.submit(Request(**d))
    srv._pick = _pick
    try:
        srv.run()
    except _FirstPick:
        pass
    return got["logits"]


def merge_check(cfg, plan, slots: int, live: int, seed: int) -> dict:
    """The blocks' merge (`attention._decode_blocks`, this rank's block of
    a seeded bf16 cache of `slots` slots with `live` keys, one query a
    row at position ``live - 1``) against the plain `decode_attention`
    over the whole cache, on the rank's heads: the largest difference
    over the largest |value|, sound and with `dropped_partial`."""
    from repro_torch.models.attention import (_decode_blocks,
                                              decode_attention, rank_heads)
    from repro_torch.sharding.partition import cache_block, tp_of
    dev = plan.mesh.device
    rh = rank_heads(cfg, plan)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B = 1
    g = torch.Generator(device=dev).manual_seed(seed + 5)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = draw(B, 1, H, hd), draw(B, slots, KV, hd), draw(B, slots, KV,
                                                              hd)
    kpos = torch.full((B, slots), -1, dtype=torch.int32, device=dev)
    kpos[:, :live] = torch.arange(live, dtype=torch.int32, device=dev)
    pos = torch.full((B, 1), live - 1, dtype=torch.long, device=dev)
    want = decode_attention(q.reshape(B, 1, KV, H // KV, hd), k, v, kpos,
                            pos)
    M, i = tp_of(plan)
    heads = slice(i * rh.H, (i + 1) * rh.H) if rh.split else slice(None)
    kv = (slice(i * KV // M, (i + 1) * KV // M)
          if rh.split and plan.kv_axis is not None else slice(None))
    lo, blk = cache_block(slots, plan)
    block = {"k": k[:, lo:lo + blk, kv], "v": v[:, lo:lo + blk, kv],
             "kpos": kpos[:, lo:lo + blk]}
    out = {}
    for tag in ("sound", "planted"):
        with (dropped_partial() if tag == "planted"
              else contextlib.nullcontext()):
            got = _decode_blocks(q[:, :, heads], block, pos, slots=slots,
                                 rh=rh, window=0, plan=plan)
        out[tag] = rel_err(got, want[:, :, heads])
    return out


def train_forward(cfg, plan, params, batch, last: int = 16):
    """The train forward on this rank (one process with no `plan`): its
    loss metric (averaged over the homes, as the step averages it) and
    its logits at the last `last` positions (its rows and vocabulary
    block), under autograd so that the model takes its training layout,
    with nothing differentiated."""
    from repro_torch.core import collectives
    from repro_torch.models import LM, steps
    from repro_torch.sharding.partition import homes_of
    with torch.enable_grad():
        logits = LM(cfg, flash=False).forward(params, batch, plan)[0]
        nll = steps.vocab_nll(logits, batch["targets"], cfg.vocab_size,
                              plan).detach()
    n = homes_of(plan)[0]
    if n > 1:
        nll = collectives.psum(nll[None], plan.mesh, plan.batch_axes)[0] / n
    return float(nll), logits[:, -last:].detach().float().cpu()


def assemble(blocks, n: int, M: int) -> torch.Tensor:
    """``[(home, vocabulary block, tensor (rows, ..., V / M))]`` of every
    rank as the whole (n * rows, ..., V), rows by home."""
    rows = {}
    for h, i, t in blocks:
        rows.setdefault(h, {})[i] = t
    return torch.cat([torch.cat([rows[h][i] for i in range(M)], dim=-1)
                      for h in range(n)])


def model_split_mamba(mesh, seed: int, progress) -> dict:
    """(a) on this rank: the served stream and the planted unsummed
    statistic in its first pick; then the train forward's loss and last
    logits, sound and with that fault, and the train step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_cut
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM
    from repro_torch.obs.schedule import train_schedule
    from repro_torch.sharding import partition
    m = MODEL_SPLIT_MAMBA
    cfg = get_config(m["arch"]).replace(num_layers=m["layers"])
    plan = partition.make_plan(mesh, cfg, ShapeSpec(
        "serve", SERVE_MAX_LEN, SERVE_SLOTS, "decode"))
    params = LM(cfg).init(torch.Generator(device=mesh.device).manual_seed(
        seed), cut=rank_cut(plan, cfg))
    reqs = serve_streams(cfg, seed)["waves"][:m["requests"]]
    kw = dict(slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, pad=m["pad"])
    out = {"runs": {"waves-" + m["policy"]: rank_serve_run(
        cfg, params, plan, reqs, page_size=None, policy=m["policy"], **kw)}}
    progress("(a) served")
    with unsummed_stat():
        out["planted"] = first_pick_logits(cfg, params, plan, reqs,
                                           policy=m["policy"], **kw)
    progress("(a) planted in serving")
    del params
    release()
    shape = ShapeSpec("train", m["seq"], m["batch"], "train")
    plan = partition.make_plan(mesh, cfg, shape)
    params, _, state, fn = train_rank_state(cfg, plan, seed, mesh.device,
                                            TRAIN_LR)
    batch = SyntheticLM(cfg, m["batch"], m["seq"], seed, mesh).batch(0)
    _, logits = train_forward(cfg, plan, params, batch)
    with unsummed_stat():
        planted_loss, planted = train_forward(cfg, plan, params, batch)
    specs = {"params": partition.param_specs(params, plan, cfg),
             "opt": partition.full_opt_specs(state, params, plan, cfg)}
    params, state, rec = timed_step(fn, params, state, batch, mesh.device,
                                    train_schedule(cfg, plan, shape))
    rec["digests"] = step_digests(params, state, specs, mesh, False)
    n, h = partition.homes_of(plan)
    out["train"] = dict(rec, home=h, tp=partition.tp_of(plan)[1],
                        logits=logits, planted_loss=planted_loss,
                        planted_logits=planted)
    del params, state, fn
    release()
    return out


def model_split_vision(mesh, seed: int) -> dict:
    """(b) on this rank: its rows and vocabulary block of the prefill's and
    decode steps' logits, its log against `serve_schedule`."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.analysis.livecheck import log_signature
    from repro_torch.convert import rank_cut
    from repro_torch.core import collectives as coll
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.obs.schedule import log_against_serve, serve_schedule
    from repro_torch.sharding import partition
    cfg = get_config("llama-3.2-vision-90b")
    cfg = cfg.replace(num_layers=cfg.cross_attn_every)
    B, S = STACK_VISION_B, STACK_VISION_S
    steps = MODEL_SPLIT_VISION_STEPS
    plan = partition.make_plan(mesh, cfg, ShapeSpec("serve", S + steps, B,
                                                    "decode"))
    # a rank draws each superblock whole before it cuts its blocks: the
    # vision superblock is 9 GB in bf16, so the ranks draw in turn
    for r in range(mesh.size):
        if r == mesh.rank:
            params = LM(cfg).init(torch.Generator(
                device=mesh.device).manual_seed(seed), cut=rank_cut(plan,
                                                                    cfg))
            release()
        dist.barrier()
    batch, fed = model_split_inputs(cfg, seed, mesh.device)
    n, h = partition.homes_of(plan)
    rows = slice(h * B // n, (h + 1) * B // n)
    mine = {k: v[rows] for k, v in batch.items()}
    model = LM(cfg)
    sync(mesh.device)
    ops.reset_launches()                      # the path's counted run
    coll.reset_collectives()
    dist.barrier()
    t0 = time.perf_counter()
    last, caches = model.prefill(params, mine, max_len=S + steps, plan=plan)
    logits, calls = [last], [{"call": "prefill", "rows": B // n, "seq": S}]
    for t in range(steps):
        lg, caches = model.decode_step(params, caches,
                                       {"tokens": fed[rows, t:t + 1]}, S + t,
                                       plan=plan)
        logits.append(lg)
        calls.append({"call": "decode", "rows": B // n, "seq": 1})
    sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3
    log = coll.collective_log()

    def step():                      # the last decode step again, timed
        return model.decode_step(params, caches, {
            "tokens": fed[rows, -1:]}, S + steps - 1, plan=plan)
    dist.barrier()
    step_ms = cuda_ms(step, reps=3)
    dist.barrier()
    if mesh.rank == 0:
        busy = device_busy_ms(step)
    else:
        step()
        sync(mesh.device)
    out = dict(home=h, tp=partition.tp_of(plan)[1], ms=ms,
               decode_step_ms=step_ms,
               decode_step_busy_ms=busy if mesh.rank == 0 else None,
               logits=torch.stack(logits).float().cpu(),
               cross_kv=list(caches[f"m{cfg.cross_attn_every - 1}"]["k"]
                             .shape),
               schedule=log_against_serve(log, serve_schedule(cfg, plan,
                                                              calls))[:3],
               collectives=len(log), wire=sum(r["wire_bytes"] for r in log),
               signature=log_signature(log),
               launches=ops.launch_counts()["flash_attention"])
    del params, caches
    release()
    return out


def model_split_seq(mesh, name: str, seed: int) -> dict:
    """(c) on this rank: the served stream (its picks, every pick's logits,
    its log against `serve_schedule`), the self-attention cache bytes and
    live slots its prefill built, and the merge check."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import rank_cut
    from repro_torch.models import LM
    from repro_torch.sharding import partition
    spec = MODEL_SPLIT_SEQ[name]
    cfg = get_config(spec["arch"]).replace(num_layers=spec["layers"])
    plan = partition.make_plan(mesh, cfg, ShapeSpec(
        "serve", spec["max_len"], spec["slots"], "decode"))
    need(plan.cache_seq_axis == spec["axis"], f"model_split {name}: the "
         f"plan homes the cache over {plan.cache_seq_axis!r}")
    params = LM(cfg).init(torch.Generator(device=mesh.device).manual_seed(
        seed), cut=rank_cut(plan, cfg))
    reqs = model_split_stream(cfg, spec, seed)
    built = {}
    real = LM.prefill

    def prefill(self, *a, **kw):
        last, caches = real(self, *a, **kw)
        attn = [c for c in caches.values()
                if "kpos" in c and c["kpos"].dim() == 3]
        built["bytes"] = sum(t.numel() * t.element_size() for c in attn
                             for t in c.values())
        built["blocks"] = [list(c["k"].shape) for c in attn]
        built["live"] = bool(any((c["kpos"] >= 0).any() for c in attn))
        return last, caches
    with mock.patch.object(LM, "prefill", prefill):
        run = rank_serve_run(cfg, params, plan, reqs, slots=spec["slots"],
                             max_len=spec["max_len"], pad=None,
                             page_size=None, policy="fifo")
    run["cache"] = built
    run["merge"] = merge_check(cfg, plan, spec["max_len"],
                               max(len(d["prompt"]) for d in reqs), seed)
    del params
    release()
    return run


def model_split_child(device, seed: int) -> dict:
    """One rank of the model_split phase (see the module docstring, 8h),
    and the distinct shapes of every `flash_attention` call it made."""
    need("jax" not in sys.modules, "a rank process imported JAX")
    import torch.distributed as dist
    from repro_torch.analysis import record
    from repro_torch.core.mesh import RankMesh
    meshes = {"d2m4": RankMesh(MODEL_SPLIT_MESH, device=device),
              "data8": RankMesh({"data": 8, "model": 1}, device=device)}
    out = {"rank": dist.get_rank()}
    t0 = time.perf_counter()

    def progress(what):
        if out["rank"] == 0:
            say(f"model_split progress: {time.perf_counter() - t0:.1f} s: "
                f"{what} done (rank 0 holds "
                f"{torch.cuda.memory_allocated()} B)")
    # (b) first: its superblock is drawn whole on each rank in turn, and
    # wants the card's memory free
    with record() as launches:
        out["vision"] = model_split_vision(meshes["d2m4"], seed)
        progress("(b) llama-3.2-vision-90b")
        for name, spec in MODEL_SPLIT_SEQ.items():
            out[name] = model_split_seq(meshes[spec["mesh"]], name, seed)
            progress(f"(c) {name}")
        out["mamba"] = model_split_mamba(meshes["d2m4"], seed, progress)
        progress("(a) trained")
    out["kernel_shapes"] = sorted({f.call[1] for f in launches
                                   if f.call[0].endswith("flash_attention")},
                                  key=repr)
    out["jax_free"] = "jax" not in sys.modules
    return out


def model_split_one(seed: int) -> dict:
    """The one-process runs the ranks are held to, at the same depths and
    on the same homes: (a)'s served stream and train step (loss and norm,
    nothing written), (b)'s logits, (c)'s served streams."""
    from repro_torch.configs import get_config
    from repro_torch.core import HomeMesh, Locale
    from repro_torch.data import SyntheticLM
    from repro_torch.models import LM, steps
    from repro_torch.optim import AdamW
    from repro_torch.runtime.server import DecodeServer, Request
    one = {}

    def served(cfg, params, reqs, *, slots, max_len, pad, policy, homes):
        locale = (Locale(HomeMesh({"data": homes}, device="cuda"), "data")
                  if homes > 1 else None)
        srv = DecodeServer(cfg, params, batch_slots=slots, max_len=max_len,
                           locale=locale, scheduler=policy, prompt_pad=pad)
        for d in reqs:
            srv.submit(Request(**d))
        picks = pick_recorder(srv)
        srv.run()
        return picks

    m = MODEL_SPLIT_MAMBA
    cfg = get_config(m["arch"]).replace(num_layers=m["layers"])
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(seed))
    one["mamba"] = served(cfg, params, serve_streams(cfg, seed)["waves"][
        :m["requests"]],
                          slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                          pad=m["pad"], policy=m["policy"],
                          homes=MODEL_SPLIT_MESH["data"])
    fn = steps.make_train_step(LM(cfg, flash=False), cfg, steps.NULL_PLAN,
                               AdamW(lr=TRAIN_LR))
    state = {"adam": {"step": torch.zeros((), dtype=torch.int32,
                                          device="cuda")}}
    batch = SyntheticLM(cfg, m["batch"], m["seq"], seed,
                        device="cuda").batch(0)
    _, _, mt = fn(params, state, batch, accept=lambda mt: False)
    one["mamba_train"] = {"loss": float(mt["loss"]),
                          "grad_norm": float(mt["grad_norm"]),
                          "logits": train_forward(cfg, None, params,
                                                  batch)[1]}
    del params, fn
    release()

    cfg = get_config("llama-3.2-vision-90b")
    cfg = cfg.replace(num_layers=cfg.cross_attn_every)
    S, steps_ = STACK_VISION_S, MODEL_SPLIT_VISION_STEPS
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(seed))
    batch, fed = model_split_inputs(cfg, seed, "cuda")
    model = LM(cfg)
    last, caches = model.prefill(params, batch, max_len=S + steps_)
    logits = [last]
    for t in range(steps_):
        lg, caches = model.decode_step(params, caches,
                                       {"tokens": fed[:, t:t + 1]}, S + t)
        logits.append(lg)
    one["vision"] = torch.stack(logits).float().cpu()
    del params, caches
    release()

    for name, spec in MODEL_SPLIT_SEQ.items():
        cfg = get_config(spec["arch"]).replace(num_layers=spec["layers"])
        params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(
            seed))
        homes = (spec["slots"] if spec["mesh"] == "d2m4" else 1)
        one[name] = served(cfg, params, model_split_stream(cfg, spec, seed),
                           slots=spec["slots"], max_len=spec["max_len"],
                           pad=None, policy="fifo", homes=homes)
        del params
        release()
    return one


def unique_blocks(ranks: list, key) -> list:
    """One rank of each (home, vocabulary block) pair, over `key(rank
    result)`: where the batch is not homed every rank holds the same
    rows, and `combine_picks` takes each block once."""
    seen, out = set(), []
    for r in ranks:
        run = key(r)
        if (run["home"], run["tp"]) not in seen:
            seen.add((run["home"], run["tp"]))
            out.append(r)
    return out


def phase_model_split(seed: int, smi: str) -> dict:
    """Mamba2 and cross attention over "model" and the decode cache homed
    by sequence, across 8 gloo ranks sharing the card (see the module
    docstring, 8h)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import make_attention_inputs
    from repro_torch.launch.mesh import spawn
    t_phase = time.perf_counter()
    release()
    tol = SERVE_RANK_TOL
    one = model_split_one(seed)
    release()
    t0 = time.perf_counter()
    say(f"model_split progress: one-process runs in {t0 - t_phase:.1f} s")
    # the ranks' allocators map their blocks in expandable segments: the
    # vision superblock each draws whole in turn needs the card's memory
    # in one piece
    old_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn(model_split_child, MODEL_SPLIT_RANKS, "gloo", "cuda",
                      seed)
    finally:
        if old_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old_conf
    out = {"one_s": t0 - t_phase, "spawn_s": time.perf_counter() - t0,
           "r11": r11_over_ranks(ranks)}
    need(all(r["jax_free"] for r in ranks), "model_split: a rank imported "
                                            "JAX")

    def run_checks(what, rs):
        for r in rs:
            need(not r["schedule"], f"model_split {what}: rank collectives "
                                    f"differ from serve_schedule: "
                                    f"{r['schedule'][:3]}")
            need(r["tokens"] == rs[0]["tokens"], f"model_split {what}: the "
                                                 f"ranks' tokens differ")
        need(len({r["digest"] for r in rs}) == 1,
             f"model_split {what}: the scheduler replicas diverged")

    def summary(rs):
        n_tok = sum(len(v) for v in rs[0]["tokens"].values())
        wall = max(r["wall_s"] for r in rs)
        return dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                    collectives=[r["collectives"] for r in rs],
                    wire=[r["wire"] for r in rs],
                    staged=[r["staged"] for r in rs],
                    peak_bytes=[r["peak_bytes"] for r in rs])

    # ---- (a) mamba2-2.7b ----
    m = MODEL_SPLIT_MAMBA
    run = "waves-" + m["policy"]
    rs = [r["mamba"]["runs"][run] for r in ranks]
    run_checks("mamba", rs)
    view = [{"meshes": {"mamba": r["mamba"]}} for r in ranks]
    cmp = compare_picks(one["mamba"], combine_picks(
        view, run, "mamba", MODEL_SPLIT_MESH["model"]), tol)
    need(cmp["first_logits_rel"] is not None
         and cmp["first_logits_rel"] <= tol,
         f"model_split mamba: the first pick's logits differ from one "
         f"process's by {cmp['first_logits_rel']}")
    first = next(c[4] for c in one["mamba"] if c[4] is not None)
    n = MODEL_SPLIT_MESH["data"]
    planted = torch.cat([torch.cat([b for _, b in sorted(
        (x["mamba"]["runs"][run]["tp"], x["mamba"]["planted"])
        for x in ranks if x["mamba"]["runs"][run]["home"] == h)], dim=-1)
        for h in range(n)])
    cmp["planted_stat_rel"] = rel_err(planted, first)
    need(cmp["planted_stat_rel"] > tol, f"model_split mamba: the planted "
         f"unsummed statistic passes: {cmp['planted_stat_rel']} <= {tol}")
    a = out["mamba"] = dict(summary(rs), vs_one_process=cmp)
    tr = [r["mamba"]["train"] for r in ranks]
    for rec in tr:
        need(rec["schedule"] == [], f"model_split mamba train: rank "
             f"collectives differ from train_schedule: {rec['schedule']}")
    bad = replica_mismatches(tr, lambda x: x["digests"])
    need(not bad, f"model_split mamba train: replicas differ {bad[:3]}")
    ot = one["mamba_train"]
    M = MODEL_SPLIT_MESH["model"]
    a["train"] = dict(
        step_ms=max(x["ms"] for x in tr), loss=tr[0]["loss"],
        norm=tr[0]["grad_norm"], norm_one=ot["grad_norm"],
        loss_rel=rel(tr[0]["loss"], ot["loss"]),
        norm_rel=rel(tr[0]["grad_norm"], ot["grad_norm"]),
        logits_rel=rel_err(assemble([(x["home"], x["tp"], x["logits"])
                                     for x in tr], n, M), ot["logits"]),
        planted_loss_rel=rel(tr[0]["planted_loss"], ot["loss"]),
        planted_logits_rel=rel_err(assemble(
            [(x["home"], x["tp"], x["planted_logits"]) for x in tr], n, M),
            ot["logits"]),
        collectives=[x["collectives"] for x in tr],
        wire=[x["wire"] for x in tr], staged=[x["staged"] for x in tr],
        peak_bytes=[x["peak_bytes"] for x in tr])
    a["train"]["tokens_per_s"] = m["batch"] * m["seq"] / (
        a["train"]["step_ms"] / 1e3)
    t = a["train"]
    # at full width the SSD's masked exp(seg) overflows in float32, and
    # its backward (0 * inf) makes the norm NaN, one process's as the
    # ranks' -- the reference's arithmetic: the norms must agree as NaN
    norm_ok = (math.isnan(t["norm"]) and math.isnan(t["norm_one"])) or (
        t["norm_rel"] <= TRAIN_RANK_NORM_RTOL)
    need(t["loss_rel"] <= TRAIN_RANK_LOSS_RTOL and norm_ok
         and t["logits_rel"] <= tol,
         f"model_split mamba train: loss, norm or logits from one "
         f"process's: {t} ")
    # at random weights the loss stays near log(vocabulary) whatever the
    # stack computes: the unsummed statistic moves it 1.6e-4 (H100, seed
    # 0), under the loss bound, so the train forward's logits hold it
    need(t["planted_logits_rel"] > tol, f"model_split mamba train: the "
         f"planted unsummed statistic passes: {t['planted_logits_rel']}")

    # ---- (b) llama-3.2-vision-90b ----
    vs = [r["vision"] for r in ranks]
    for r in vs:
        need(not r["schedule"], f"model_split vision: rank collectives "
             f"differ from serve_schedule: {r['schedule']}")
    want = one["vision"]
    got = torch.full_like(want, float("nan"))
    b, v = want.shape[1] // n, want.shape[2] // MODEL_SPLIT_MESH["model"]
    for r in vs:
        got[:, r["home"] * b:(r["home"] + 1) * b,
            r["tp"] * v:(r["tp"] + 1) * v] = r["logits"]
    out["vision"] = dict(logits_rel=rel_err(got, want),
                         ms=max(r["ms"] for r in vs),
                         decode_step_ms=max(r["decode_step_ms"] for r in vs),
                         decode_step_busy_ms=vs[0]["decode_step_busy_ms"],
                         cross_cache=vs[0]["cross_kv"],
                         collectives=[r["collectives"] for r in vs],
                         wire=[r["wire"] for r in vs])
    need(out["vision"]["logits_rel"] <= tol, f"model_split vision: logits "
         f"{out['vision']['logits_rel']} from one process's")

    # ---- (c) caches homed by sequence ----
    for name, spec in MODEL_SPLIT_SEQ.items():
        rs = [r[name] for r in ranks]
        run_checks(name, rs)
        view = [{"meshes": {name: {"runs": {"fifo": r[name]}}}}
                for r in unique_blocks(ranks, lambda r: r[name])]
        M = MODEL_SPLIT_MESH["model"] if spec["mesh"] == "d2m4" else 1
        cmp = compare_picks(one[name], combine_picks(view, "fifo", name, M),
                            tol)
        need(cmp["first_logits_rel"] is not None
             and cmp["first_logits_rel"] <= tol,
             f"model_split {name}: the first pick's logits differ from one "
             f"process's by {cmp['first_logits_rel']}")
        need(cmp["compared"] >= spec["slots"] * spec["new"],
             f"model_split {name}: {cmp['compared']} picks compared")
        cfg = get_config(spec["arch"])
        shards = 8 // M if spec["axis"] == "data" else M
        rows = spec["slots"] // (2 if spec["mesh"] == "d2m4" else 1)
        blk = spec["max_len"] // shards
        item = getattr(torch, cfg.dtype).itemsize
        want_bytes = spec["layers"] * rows * blk * (
            2 * cfg.num_kv_heads * cfg.head_dim * item + 4)
        for r in rs:
            need(r["cache"]["bytes"] == want_bytes, f"model_split {name}: "
                 f"a rank's cache holds {r['cache']['bytes']} B, its block "
                 f"{want_bytes} B")
        live = sum(r["cache"]["live"] for r in rs)
        merges = [r["merge"] for r in rs]
        need(max(x["sound"] for x in merges) <= tol, f"model_split {name}: "
             f"the blocks' merge {merges} from the plain attention")
        need(min(x["planted"] for x in merges) > tol, f"model_split {name}: "
             f"the dropped partial passes: {merges}")
        out[name] = dict(summary(rs), vs_one_process=cmp,
                         cache_bytes=want_bytes, block=rs[0]["cache"][
                             "blocks"][0], ranks_with_keys=live,
                         merge_rel=max(x["sound"] for x in merges),
                         planted_rel=min(x["planted"] for x in merges),
                         kinds=rs[0]["kinds"])
    need(out["qwen_data"]["ranks_with_keys"] == 6,
         f"model_split qwen_data: keys on "
         f"{out['qwen_data']['ranks_with_keys']} ranks, want 6")

    # ---- every flash_attention call the ranks made, timed ----
    calls = sorted({tuple(c) for r in ranks for c in r["kernel_shapes"]},
                   key=repr)
    need(calls, "model_split: the ranks made no flash_attention call")
    out["cells"] = {}
    for call in calls:
        B, H, KV, Sq, Skv, hd, _, _, causal, window, dtype = call[:11]
        q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
                   for x in make_attention_inputs(B, H, KV, Sq, Skv, hd,
                                                  dtype, seed))
        out["cells"][f"{B}x{H}x{KV}x{Sq}x{Skv}x{hd}"] = kernel_cell(
            q, k, v, causal=causal, window=window)
        del q, k, v
    need(any(not c["causal"] and c["shape"] == [1, 16, 2, 512, 4096, 128]
             for c in out["cells"].values()),
         f"model_split: no cross launch at the rank shape: "
         f"{list(out['cells'])}")
    # flash_attention's launches by rank in each counted run: none for
    # mamba, 4 causal and 1 cross a vision prefill, a layer a wave for (c)
    out["rank_launches"] = {
        "model_split_mamba": [r["mamba"]["runs"][run]["launches"].get(
            "flash_attention", 0) for r in ranks],
        "model_split_vision": [r["vision"]["launches"] for r in ranks],
        **{f"model_split_{k}": [r[k]["launches"].get("flash_attention", 0)
                                for r in ranks] for k in MODEL_SPLIT_SEQ}}
    want_launches = {"model_split_mamba": 0, "model_split_vision": 5,
                     **{f"model_split_{k}": spec["layers"]
                        for k, spec in MODEL_SPLIT_SEQ.items()}}
    for k, got_l in out["rank_launches"].items():
        need(got_l == [want_launches[k]] * MODEL_SPLIT_RANKS,
             f"model_split: flash_attention launches by rank in {k} "
             f"{got_l}, want {want_launches[k]} each")
    out["seconds"] = time.perf_counter() - t_phase

    say(f"phase model_split mamba ({smi}): mamba2-2.7b bf16 at full width, "
        f"{m['layers']} of 64 layers, on {MODEL_SPLIT_MESH} ({MODEL_SPLIT_RANKS}"
        f" gloo ranks sharing the card), the serve_ranks stream in aligned "
        f"waves padded to {m['pad']}, {m['policy']}: {a['tokens']} tokens in "
        f"{a['wall_s']:.3f} s ({a['tokens_per_s']:.1f} tokens/s); "
        f"collectives by rank "
        f"{a['collectives']}, wire {a['wire']}, staged {a['staged']}, peak "
        f"{a['peak_bytes']}; each log == serve_schedule; against one "
        f"process " + json.dumps(a["vs_one_process"]))
    t = a["train"]
    say(f"phase model_split mamba train ({smi}): one step of "
        f"{m['batch']} x {m['seq']} on {MODEL_SPLIT_MESH} (sequence-sharded "
        f"residual, remat): {t['step_ms']:.1f} ms by the slowest rank, "
        f"{t['tokens_per_s']:.0f} tokens/s; loss {t['loss']:.5f}, "
        f"{t['loss_rel']:.3g} from one process's (<= "
        f"{TRAIN_RANK_LOSS_RTOL}), norm {t['norm']} (one process "
        f"{t['norm_one']}), the forward's last 16 positions' logits "
        f"{t['logits_rel']:.3g} (<= {tol}); planted unsummed statistic: "
        f"loss {t['planted_loss_rel']:.3g}, logits "
        f"{t['planted_logits_rel']:.3g}, first pick "
        f"{a['vs_one_process']['planted_stat_rel']:.3g}; "
        f"collectives {t['collectives']}, wire {t['wire']}, staged "
        f"{t['staged']}, peak {t['peak_bytes']}; log == train_schedule, "
        f"replicas equal")
    vv = out["vision"]
    say(f"phase model_split vision ({smi}): llama-3.2-vision-90b bf16 at "
        f"full width, one superblock, prefill (2, 512) over 4096 image "
        f"tokens and {MODEL_SPLIT_VISION_STEPS} decode steps on "
        f"{MODEL_SPLIT_MESH} in {vv['ms']:.1f} ms, a decode step "
        f"{vv['decode_step_ms']:.2f} ms (rank 0 busy "
        f"{vv['decode_step_busy_ms']:.2f}): logits "
        f"{vv['logits_rel']:.3g} from one process's (<= {tol}); the cross "
        f"cache a rank {vv['cross_cache']}; collectives {vv['collectives']},"
        f" wire {vv['wire']}; each log == serve_schedule")
    for name in MODEL_SPLIT_SEQ:
        r = out[name]
        say(f"phase model_split {name} ({smi}): {r['tokens']} tokens in "
            f"{r['wall_s']:.3f} s ({r['tokens_per_s']:.1f} tokens/s); cache "
            f"block {r['block']} a rank ({r['cache_bytes']} B), keys on "
            f"{r['ranks_with_keys']} ranks after the prefill; collectives "
            f"{r['collectives']} ({r['kinds']}), wire {r['wire']}, staged "
            f"{r['staged']}, peak {r['peak_bytes']}; each log == "
            f"serve_schedule; merge {r['merge_rel']:.3g}, dropped partial "
            f"{r['planted_rel']:.3g} (bound {tol}); against one process "
            + json.dumps(r["vs_one_process"]))
    say("phase model_split flash_attention at the ranks' call shapes "
        "(kernel, plain, SDPA ms; bound): " + json.dumps(
            {k: {f: c[f] for f in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err")}
             for k, c in out["cells"].items()})
        + f"; phase {out['seconds']:.1f} s ({out['one_s']:.1f} s one "
        f"process, {out['spawn_s']:.1f} s the ranks) [{smi}]")
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


def pop_log_signatures(tree, path: str = "") -> dict:
    """Take every ``"signature"`` (a run's `livecheck.log_signature` on a
    rank) out of a rank's result tree: ``{path: signature}``."""
    out = {}
    if isinstance(tree, dict):
        if "signature" in tree:
            out[path] = tree.pop("signature")
        for k, v in tree.items():
            out.update(pop_log_signatures(v, f"{path}/{k}" if path else k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(pop_log_signatures(v, f"{path}/{i}"))
    return out


def r11_over_ranks(ranks: list) -> dict:
    """R11 over every run's collective logs of a spawn's ranks (their
    signatures taken out of the results): ``{run: {"collectives": n,
    "findings": [...]}}``; the analysis phase holds each run clean."""
    from repro_torch.analysis import Report
    from repro_torch.analysis.livecheck import r11_collective_control_flow
    sigs = [pop_log_signatures(r) for r in ranks]
    runs = set().union(*sigs)
    need(all(set(s) == runs for s in sigs),
         f"analysis R11: the ranks' runs differ: "
         f"{[sorted(s) for s in sigs]}")
    out = {}
    for run in sorted(runs):
        logs = [s[run] for s in sigs]
        rep = Report(target=f"r11 {run}")
        r11_collective_control_flow(rep, logs)
        out[run] = {"collectives": max(len(log) for log in logs),
                    "findings": [f.format() for f in rep.findings]}
    return out


#: the rank phases whose every run R11 holds (each must give runs)
R11_PHASES = ("serve_ranks", "train_ranks", "model_split")

#: the state count of `analysis.FAST_LATTICE`, the reference's
#: (tests/test_torch_schedcheck.py holds the port's certificate to it)
R9_FAST_STATES = 59169

#: the hog fixture's peak at 4,194,304 f32, and the ceiling it is flagged at
HOG_PEAK = 64 * 2 ** 20
HOG_CEILING = 32 * 2 ** 20

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


# ---------------------------------------------------------------------------
# dryrun: the cost model of one rank's step, held to the card
# ---------------------------------------------------------------------------
#: (a)'s prefill: the serve phase's first wave, 16 slots of 753 tokens
DRYRUN_PREFILL = (SERVE_SLOTS, 753)
#: (b)'s cells: the sweep's qwen3-0.6b cells of the one-pod mesh
DRYRUN_CELLS = ("train_4k", "prefill_32k", "decode_32k")
#: the processes this script starts beside its phases, stopped at exit
CHILDREN = []


def start_dryrun_cells(outdir: str) -> dict:
    """(b)'s cells, each `launch.dryrun` in a process of its own on this
    host, started here and read by `phase_dryrun`."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    for shape in DRYRUN_CELLS:
        path = os.path.join(outdir, f"{shape}.json")
        with open(path + ".err", "w") as err:
            procs[shape] = (path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", SERVE_ARCH, "--shape", shape, "--out", path],
                env=env, stdout=subprocess.DEVNULL, stderr=err))
        CHILDREN.append(procs[shape][1])
    return procs


def phase_dryrun(seed: int, smi: str, cells: dict) -> dict:
    """The dry run held to the card (see the module docstring, 8i)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.sweep import cell_path
    from repro_torch.models import LM
    from repro_torch.models.common import MetaGen
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.sharding.partition import NULL_PLAN

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    B, S = DRYRUN_PREFILL
    shape = ShapeSpec("serve_prefill", S, B, "prefill")

    # (a) predicted on meta, then run on the card
    t0 = time.perf_counter()
    step, args = dryrun.build_cell(cfg, shape, NULL_PLAN,
                                   LM(cfg).init(MetaGen()))
    _, pred, pfacts = dryrun.cost_step(step, args, grad=False)
    trace_s = time.perf_counter() - t0
    params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(seed))
    step, args = dryrun.build_cell(cfg, shape, NULL_PLAN, params,
                                   gen=torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    before = ops.launch_counts()["flash_attention"]
    (logits, _), got, facts = dryrun.cost_step(step, args, grad=False)
    launched = ops.launch_counts()["flash_attention"] - before
    with torch.no_grad():
        plain = make_prefill_step(LM(cfg, flash=False), cfg)(*args)[0]
        ms = cuda_ms(lambda: step(*args), reps=3)
    roof = dryrun.roofline(pred["flops"], pred["bytes"],
                           pred["collective_split"])
    rel = rel_err(logits, plain)
    peak = facts["liveness"]["peak_bytes"]
    alloc = facts["memory_stats"]["allocated_bytes.all.peak"]
    tuples = [(f.launch_tuple(), f.call) for f in got["launches"]]
    out = {"shape": [B, S], "trace_s": trace_s, "ms": ms, "rel": rel,
           "launches": len(tuples), "launched": launched,
           "kernel_launches": got["kernel_launches"],
           "predicted": {k: pred[k] for k in ("flops", "bytes", "aten_flops",
                                              "aten_bytes", "kernel_flops",
                                              "kernel_bytes")},
           "measured": {k: got[k] for k in ("flops", "bytes", "aten_flops",
                                             "aten_bytes", "kernel_flops",
                                             "kernel_bytes")},
           "peak": {"predicted": pfacts["liveness"]["peak_bytes"],
                    "scan": peak, "allocator": alloc},
           "roofline": roof,
           "ms_over_bound": ms / (1e3 * max(roof["compute_s"],
                                            roof["memory_s"]))}
    del params, args, logits, plain
    need(tuples == [(f.launch_tuple(), f.call) for f in pred["launches"]]
         and len(tuples) == launched == cfg.num_layers,
         f"dryrun: the card's launches differ from the dry run's "
         f"({len(tuples)} and {len(pred['launches'])} noted, {launched} "
         f"launched)")
    need(out["measured"] == out["predicted"],
         f"dryrun: the card's counts differ from the dry run's: "
         f"{out['measured']} against {out['predicted']}")
    need(peak == out["peak"]["predicted"] and alloc >= peak,
         f"dryrun: live-scan peak {peak} on the card, "
         f"{out['peak']['predicted']} predicted, allocator {alloc}")
    need(rel <= LOGIT_TOL["bfloat16"],
         f"dryrun: the prefill's logits through the kernel differ from the "
         f"plain chunked form by {rel} (tolerance {LOGIT_TOL['bfloat16']})")
    say(f"phase dryrun (a) ({smi}): {SERVE_ARCH} prefill ({B}, {S}) bf16, "
        f"no mesh; predicted on meta in {trace_s:.2f} s then run on the "
        f"card: {launched} flash_attention launches equal to the dry run's "
        f"LaunchFacts ({json.dumps(got['kernel_launches'])}); FLOPs "
        f"{got['flops']} (kernel {got['kernel_flops']}), HBM bytes "
        f"{got['bytes']} (kernel {got['kernel_bytes']}), live-scan peak "
        f"{peak} B: each equal to the prediction; allocator peak {alloc} "
        f"B; logits {rel:.3g} from the plain chunked form; {ms:.3f} ms "
        f"measured against compute_s {roof['compute_s'] * 1e3:.3f} ms and "
        f"memory_s {roof['memory_s'] * 1e3:.3f} ms "
        f"({out['ms_over_bound']:.2f}x the larger)")

    # (b) the sweep's cells, run on this host, against the committed ones
    out["cells"] = {}
    for name, (path, proc) in cells.items():
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise SmokeFailure(f"dryrun: the {name} cell did not end")
        with open(path + ".err") as f:
            err = f.read()
        need(proc.returncode == 0, f"dryrun: the {name} cell exited "
             f"{proc.returncode}: {err[-2000:]}")
        with open(path) as f:
            cell = json.load(f)
        with open(cell_path(str(ROOT / "results" / "dryrun_torch"),
                            SERVE_ARCH, name, False)) as f:
            committed = json.load(f)
        diff = [k for k in dryrun.COUNT_KEYS if cell[k] != committed[k]]
        need(not diff, f"dryrun: the {name} cell differs from the committed "
                       f"one in {diff}")
        out["cells"][name] = {k: cell[k] for k in (
            "trace_s", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "per_device_hbm_bytes",
            "roofline")}
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase dryrun (b): the sweep's {SERVE_ARCH} cells on "
        f"{{'data': 16, 'model': 16}}, run on this host, equal to the "
        f"committed ones in every count " + json.dumps(
            {n: {k: c[k] for k in ("trace_s", "flops_per_device",
                                   "per_device_hbm_bytes")}
             for n, c in out["cells"].items()})
        + f"; phase {out['seconds']:.1f} s")
    return out


def phase_analysis(seed: int, full_width: dict, decode_facts: dict,
                   r11_runs: dict) -> dict:
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
        # R4 reports the input that comes back in fresh storage (the port's
        # sorts and Fig 1 write a new output); every other rule is clean
        r4 = [f for f in rep.findings if f.rule == "R4"]
        need(len(r4) == len(rep.findings) and all(
            f.severity.name == "WARN" and f.shape.startswith("0 ")
            for f in r4), f"analysis {tag}: not clean:\n{rep.format()}")
        need(any(n.startswith("R10: device-live-range ok") for n in rep.notes)
             and "allocator_peak_bytes" in rep.context,
             f"analysis {tag}: no R10 peak:\n{rep.format(verbose=True)}")
        out["workloads"][tag] = dict(
            launches=len(launches), counts={
                k: v for k, v in counts.items() if v}, notes=rep.notes,
            r4=[f.format() for f in r4], peak_bytes=rep.context["peak_bytes"],
            allocator_peak_bytes=rep.context["allocator_peak_bytes"])
    for tag, launches in full_width["attention"].items():
        rep, _ = run_rules(launches)
        need(rep.clean, f"analysis attention {tag}:\n{rep.format()}")
        out["workloads"][f"attention-{tag}"] = dict(launches=len(launches))
    say("phase analysis check_workload: clean on the card but for R4, "
        "launches "
        + json.dumps({k: v["launches"] for k, v in out["workloads"].items()})
        + "; logn 20: R4 findings, R10 peak by the live scan / the CUDA "
        "allocator (B) "
        + json.dumps({k: [len(v["r4"]), v["peak_bytes"],
                          v["allocator_peak_bytes"]]
                      for k, v in out["workloads"].items() if "r4" in v}))

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
    out.update(rules_r4_r9_r10_r11(decode_facts, r11_runs))
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


def memory_and_scheduler_checks(decode_facts: dict, smi: str) -> dict:
    """(a) R10 on the hog fixture, (b) check_decode on the card, (c) R4
    and R10 on the serve phase's full-width decode step."""
    from repro_torch.analysis import (FAST_LATTICE, certify_lattice,
                                      check_artifacts, check_decode)
    from repro_torch.analysis.fixtures import hbm_hog, hbm_hog_input
    from repro_torch.analysis.mem_facts import call_facts
    out = {}

    # (a) R10 on the hog: the live scan and the allocator, both 64 MiB
    _, hog = call_facts(hbm_hog, hbm_hog_input())
    rep = check_artifacts("r10-hog", [], mem_facts=hog,
                          hbm_ceiling=HOG_CEILING, rules=("R10",))
    scan = hog["liveness"]["peak_bytes"]
    stats = hog["memory_stats"]["allocated_bytes.all.peak"]
    out["hog"] = dict(scan=scan, allocator=stats,
                      findings=[f.format() for f in rep.findings])
    need(scan == stats == HOG_PEAK and [
        (f.rule, f.severity.name, f.actual_bytes) for f in rep.findings]
        == [("R10", "ERROR", HOG_PEAK)],
        f"analysis R10 hog: scan {scan}, allocator {stats}, "
        f"findings:\n{rep.format()}")
    say(f"phase analysis R10 hog: peak {scan:.0f} B by the live scan, "
        f"{stats} B by the CUDA allocator, flagged at {HOG_CEILING} B: "
        f"{rep.findings[0].format()} [{smi}]")

    # (b) check_decode on the card at the CPU test's size
    t0 = time.perf_counter()
    states = sum(r["states"] for r in certify_lattice(FAST_LATTICE).values())
    r9_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = check_decode()
    out["decode"] = dict(
        r9_states=states, r9_s=r9_s, s=time.perf_counter() - t0,
        notes=rep.notes, findings=[f.format() for f in rep.findings],
        peak_bytes=rep.context["peak_bytes"],
        allocator_peak_bytes=rep.context["allocator_peak_bytes"],
        launches=rep.context["launches"])
    need(rep.clean and states == R9_FAST_STATES and any(
        f"{R9_FAST_STATES} canonical states" in n for n in rep.notes)
        and any(n.startswith("R10: device-live-range ok") for n in rep.notes),
        f"analysis check_decode: {states} states:\n"
        f"{rep.format(verbose=True)}")
    say(f"phase analysis check_decode: clean on the card; R9 "
        f"{states} canonical states (the CPU's {R9_FAST_STATES}) in "
        f"{r9_s:.2f} s on this host; the step's {rep.context['launches']} "
        f"kernel launches, peak {rep.context['peak_bytes']} B by the live "
        f"scan, {rep.context['allocator_peak_bytes']} B by the allocator; "
        f"check_decode {out['decode']['s']:.2f} s [{smi}]")

    # (c) R4 and R10 on one decode step of the serve phase's server, on
    # its steady-state cache (homed once by pin_tree, written in place):
    # R4 silent; planted, the same step on a cache never homed: R4 reports
    # the copy, the whole cache
    rep = check_artifacts("serve[decode] full width", [],
                          mem_facts=decode_facts, rules=("R4", "R10"))
    planted = check_artifacts("serve[decode] full width, never homed", [],
                              mem_facts=decode_facts["planted"],
                              rules=("R4",))
    r4 = [f for f in planted.findings if f.rule == "R4"]
    out["full_width_decode"] = dict(
        findings=[f.format() for f in rep.findings],
        planted_r4=[f.format() for f in r4],
        planted_r4_bytes=sum(f.actual_bytes for f in r4),
        scan=decode_facts["liveness"]["peak_bytes"],
        planted_scan=decode_facts["planted"]["liveness"]["peak_bytes"],
        allocator=decode_facts["memory_stats"]["allocated_bytes.all.peak"],
        cache_bytes=decode_facts["cache_bytes"], notes=rep.notes,
        s=decode_facts["seconds"])
    fw = out["full_width_decode"]
    need(not rep.findings
         and any(n.startswith("R10: device-live-range ok") for n in rep.notes)
         and fw["allocator"] > 0,
         f"analysis full-width decode step on a homed cache:\n"
         f"{rep.format(verbose=True)}")
    need(len(r4) == len(planted.findings) and all(
        f.severity.name == "WARN" for f in r4)
        and fw["planted_r4_bytes"] == fw["cache_bytes"],
        f"analysis full-width decode step on a cache never homed: R4 "
        f"{fw['planted_r4_bytes']:.0f} B, the cache {fw['cache_bytes']} B:\n"
        f"{planted.format(verbose=True)}")
    say(f"phase analysis full-width decode step ({SERVE_ARCH}, "
        f"{SERVE_SLOTS} slots over HomeMesh data 8, cache "
        f"{fw['cache_bytes']} B): on the homed cache R4 silent, R10 peak "
        f"{fw['scan']:.0f} B by the live scan, {fw['allocator']} B by the "
        f"allocator, the step under the facts {fw['s']:.2f} s; planted, "
        f"never homed: R4 {len(r4)} finding(s), "
        f"{fw['planted_r4_bytes']:.0f} B a step copied ("
        + "; ".join(f.shape for f in r4) + f"), R10 peak "
        f"{fw['planted_scan']:.0f} B [{smi}]")
    return out


def rules_r4_r9_r10_r11(decode_facts: dict, r11_runs: dict) -> dict:
    """The analysis phase's checks of R4, R9, R10 and R11 on the card (see
    the module docstring, 9): (a)-(c) in `memory_and_scheduler_checks`,
    then (d) the rank phases' logs and the three R11 fixtures on 2 gloo
    ranks, which run beside (a)-(c)."""
    from repro_torch.analysis.fixtures import (R11_FIXTURES, r11_rank_logs,
                                               r11_reports)
    from repro_torch.launch.mesh import spawn
    smi = smi_line()
    with concurrent.futures.ThreadPoolExecutor(1) as beside:
        t_fix = time.perf_counter()
        fixture_ranks = beside.submit(spawn, r11_rank_logs, 2, "gloo",
                                      "cuda")
        out = memory_and_scheduler_checks(decode_facts, smi)
        reports = r11_reports(fixture_ranks.result())
    fixture_s = time.perf_counter() - t_fix

    # (d) R11 over the rank phases' logs, and the fixtures on 2 gloo ranks:
    # every phase gave runs, every run made collectives, and none differs
    need(set(r11_runs) == set(R11_PHASES) and all(r11_runs.values()),
         "analysis R11: runs a phase "
         + json.dumps({ph: len(v) for ph, v in r11_runs.items()}))
    empty = [f"{ph}/{run}" for ph, runs in r11_runs.items()
             for run, r in runs.items() if r["collectives"] == 0]
    need(not empty, f"analysis R11: runs with no collective: {empty}")
    bad = {f"{ph}/{run}": r["findings"] for ph, runs in r11_runs.items()
           for run, r in runs.items() if r["findings"]}
    need(not bad, f"analysis R11 on the rank phases: {bad}")
    out["r11_runs"] = {ph: {run: r["collectives"] for run, r in runs.items()}
                       for ph, runs in r11_runs.items()}
    got = {n: sorted((f.rule, f.severity.name) for f in r.findings)
           for n, r in reports.items()}
    out["r11_fixtures"] = dict(
        signatures=got, s=fixture_s,
        findings={n: [f.format() for f in r.findings]
                  for n, r in reports.items()})
    need(got == {n: want for n, (_, want) in R11_FIXTURES.items()},
         f"analysis R11 fixtures: {got}")
    say(f"phase analysis R11: every rank's log equal in "
        + json.dumps({ph: len(v) for ph, v in out["r11_runs"].items()})
        + " runs of the rank phases (collectives a run "
        + json.dumps({ph: [min(v.values()), max(v.values())]
                      for ph, v in out["r11_runs"].items() if v})
        + "); the fixtures on 2 gloo ranks of the card "
        + json.dumps(got) + f" in {out['r11_fixtures']['s']:.1f} s (beside "
        f"(a)-(c))")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--train-child", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--train-ranks-child", metavar="PATH",
                    help=argparse.SUPPRESS)
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
    if args.train_ranks_child:           # the train_ranks phase's yardstick
        Path(args.train_ranks_child).write_text(json.dumps(
            train_ranks_one(args.seed)))
        return 0
    from repro_torch.core import LocalisationPolicy
    from repro_torch.kernels import _build, ops

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"phase device: {kind} ({smi}); torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # the dryrun phase's cells run on the host beside the build, which
    # times nothing of the port's
    cells_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    cells = start_dryrun_cells(cells_dir)
    secs, reports = _build.build_all()
    regs = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
            if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    say(f"phase build: {sorted(_build.sources())} in {secs:.2f} s; ptxas: "
        + " | ".join(regs))
    wgmma = wgmma_instances(ptxas_entries(reports.get("flash_attention",
                                                      "")))
    say("phase build fa_wgmma<T/HD/BK> and fa_kernel<HD> (registers, spill "
        "bytes, static smem, ptxas warnings): " + (
            json.dumps(wgmma) if wgmma else "not rebuilt in this run"))
    sass = sass_check()
    say("phase build flash-attention SASS (cuobjdump): " + json.dumps(sass))

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
    serve_ranks = phase_serve_ranks(args.seed, smi)
    stack = phase_stack(args.seed, smi)
    dryrun = phase_dryrun(args.seed, smi, cells)
    shutil.rmtree(cells_dir, ignore_errors=True)
    # the dtypes check's CPU sorts run beside the train phase, whose child
    # keeps the card busy while the host mostly waits on it; they end
    # before train_ranks' 8 ranks take the host
    with concurrent.futures.ThreadPoolExecutor(1) as beside:
        cpu_sorts = beside.submit(cpu_reference, args.seed)
        train = phase_train(args.seed, smi)
        cpu_sorts = cpu_sorts.result()
    train_ranks = phase_train_ranks(args.seed, smi, train)
    model_split = phase_model_split(args.seed, smi)
    dtypes = phase_dtypes(args.seed)
    full_width = {
        "flagship": flat.pop("recorded") + hier.pop("recorded")
        + constraint.pop("recorded"),
        "fig1": fig1.pop("recorded"),
        "attention": {**attention.pop("recorded"),
                      "serve": serve.pop("recorded"),
                      "stack": stack.pop("recorded")}}
    analysis = phase_analysis(
        args.seed, full_width, serve.pop("decode_facts"),
        {"serve_ranks": serve_ranks.pop("r11"),
         "train_ranks": train_ranks.pop("r11"),
         "model_split": model_split.pop("r11")})
    check_dtypes_on_cpu(dtypes, cpu_sorts)

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
           for k in SERVE_LINE_KEYS},
        stack_launches=stack["launches"], stack_cells={
            tag: {k: c[k] for k in ("shape", "causal", "window", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "max_abs_err")}
            for tag, c in stack["cells"].items()})
    attention["line"]["max_abs_err"] = max(
        attention["line"]["max_abs_err"],
        *(c["max_abs_err"] for c in stack["cells"].values()))
    # the serve phase's prefill logits check, each dtype's kernel and
    # the launches of its counted prefill (bf16 fa_wgmma, float32
    # fa_kernel, once a layer)
    attention["line"]["serve_logits_launches"] = {
        dt: {k: rec[k] for k in ("kernel", "launches")}
        for dt, rec in serve["logits"].items()}
    rows += [kernels["bitonic_sort"], fig1["line"], attention["line"]]
    rows += analysis.pop("lines")
    # each kernel's launches by rank, {path: [launches of rank 0..7]}, in
    # the ranks phase's three counted runs (one rank a home, 8 ranks
    # sharing the card): the engine's flat flagship, the constraint tree's
    # case 8 flagship and Fig 1's localised run at n = 100 M, R = 8
    for row in rows:
        row["rank_launches"] = ranks["rank_launches"][row["name"]]
    # flash_attention's serving launches by rank: the serve_ranks phase's
    # counted runs, {run: [launches of rank 0..7]}
    attention["line"]["rank_launches"] = dict(
        attention["line"]["rank_launches"], **serve_ranks["rank_launches"],
        **{f"serve_moe_{p}": r["launches"]
           for p, r in serve_ranks["moe"]["runs"].items()},
        **model_split["rank_launches"])
    # the rank call shapes of the model_split phase, timed
    attention["line"]["model_split_cells"] = {
        tag: {k: c[k] for k in ("shape", "causal", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "max_abs_err")}
        for tag, c in model_split["cells"].items()}
    attention["line"]["max_abs_err"] = max(
        attention["line"]["max_abs_err"],
        *(c["max_abs_err"] for c in model_split["cells"].values()))
    extra = ("scratch_bytes", "launches_per_call", "by_kernel",
             "yardstick_ms", "yardstick", "shape", "attention_launches",
             "floor_ms", "rank_launches", "stack_launches", "stack_cells",
             "model_split_cells", "dtype_cells", "serve_logits_launches",
             *(f"serve_{k}" for k in SERVE_LINE_KEYS))
    line = [{key: k[key] for key in keys + extra if key in k} for k in rows]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": kind, "smi": smi, "build_s": secs, "kernels": kernels,
             "engine": engine, "flat": flat, "hier": hier, "ranks": ranks,
             "constraint": constraint, "fig1": fig1, "attention": attention,
             "serve": serve, "serve_ranks": serve_ranks, "stack": stack,
             "train": train, "train_ranks": train_ranks,
             "model_split": model_split, "dtypes": dtypes,
             "dryrun": dryrun, "analysis": analysis},
            indent=1))
    say(json.dumps({"kernels": line}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def stop_children() -> None:
    """Stop the processes this script started beside its phases."""
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    finally:
        stop_children()
