#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc, at
first use), then runs twenty-one phases, each printing JSON lines (phases 19
and 20 run after phase 1, phase 16 after phase 4, phase 18 after phase 6,
phase 17 after phase 7, phase 21 after phase 17):

1. env      — the card's name and power limit (nvidia-smi), torch/CUDA
              versions, the kernels' build time, and ptxas's registers and
              spills of the tensor-core flash kernels, the backward kernels
              and the WKV6 kernels (a spill in the WKV6 forward kernel or
              in a flash-attention backward kernel fails the run).
2. kernels  — every kernel at the serve path's shapes and at prefill
              sizes, held against its plain PyTorch version on the card
              (tolerance stated per line), timed beside the plain version,
              one PyTorch library call where one computes the same
              function, and its bound (bytes or operations at the H100's
              published peaks); the wrapper's host cost a launch (enqueue
              time on the host clock, no synchronise) beside it, and where
              that cost goes at the serve shapes (``host_us_a_call``); K3
              at one query a sequence against strided views of a stacked
              cache (4096 and 32768 keys) in two forms, one query row a
              head and GQA folded, and K4 at one token from a carried
              state (decode's shapes). bf16 attention at 1024 keys or
              more is also held by relative Frobenius, beside a control a
              key tile off that must miss that bound. The
              backward kernels (RMSNorm, flash attention) at the training
              shapes, each held against its plain backward and against
              autograd of the plain forward (relative Frobenius), with
              each kernel's device time; the flash-attention backward also
              with its route (bf16 and fp32 on the tensor cores), its
              launch plan and a bit-for-bit repeat. fp32 attention's bound
              is at the 3xTF32 line (the TF32 peak over three). The WKV6
              backward (B3) at rwkv6-7b's serve prompt, (1, 512), (1,
              2048), a (1, 4096) training microbatch and a ragged (1, 100)
              from a state with a cotangent on the final state, in the
              three decay regimes: each gradient against autograd of the
              plain forward within 1e-5 relative Frobenius, or twice the
              plain version's own gap from an fp64 run where that is
              larger, bit for bit on a repeat.
3. serve    — ``repro_torch.launch.serve`` with its default services,
              gemma-2b, qwen3-8b and rwkv6-7b, at full width and depth
              (random weights from fixed seeds) on one ``SalusExecutor``:
              every request served, no failures, and the kernels' launch
              counters rise by exactly the count the path implies; one
              more request a service under the profiler, where each of
              its kernels must show device time.
4. parity   — qwen3-8b and rwkv6-7b at full width and depth, prefill of a
              (1, 512) prompt through the kernels against the plain
              versions, in bf16 and fp32, logits and caches.
5. paging   — two gemma-2b-width services (depth 2) on one executor with
              paging on and a capacity that forces the first out to host
              and back; its next tokens after the round trip must equal
              those before.
6. train    — gemma-2b at full width and depth, a training session on
              ``SalusExecutor``: three AdamW steps of ``make_train_step``
              at the runtime tables' settings (4 microbatches of one
              4096-token sequence, remat, bf16 compute) fed by
              ``SyntheticLM``, its profile from ``profile_model``; finite
              losses, the launch counts a step imply, step time, peak
              memory, and one more step under the profiler.
7. train_parity — the same model, one (1, 4096) batch: loss and every
              gradient leaf through the kernels against the plain path, in
              fp32 (held) and bf16 (beside the plain bf16-fp32 gap).
8. serve_train — ``repro_torch.launch.serve`` with a gemma-2b service and a
              gemma-2b background trainer under PRIORITY: every request
              served, trainer iterations and preemptions, no failure.
9. decode   — gemma-2b, qwen3-8b and rwkv6-7b at full width, the checks
              8 layers deep (DECODE_CHECK_DEPTH), the timing at full depth:
              the decode step of token 511 after a 511-token prefill
              against the full forward (fp32, through the kernels); 16
              greedy tokens through ``serve_step`` (``make_prefill_step``,
              ``make_decode_step``, ``sample_token``, ``greedy_generate``)
              through the kernels against the plain path in fp32 and bf16
              (logits at the parity phase's tolerances, tokens identical
              or a near tie); the int8 cache at the runtime tables'
              settings against the bf16 cache, both through the plain
              path and as served (K3 on the bf16 cache), within twice
              bf16 compute's own error (the parity phase's rule). Then
              DECODE_32K (32768 cached tokens) with bf16 params and a
              random cache, the batch cut to fit 40 GB: ms a step, tokens
              a second, launches a step, a profiled step's busy share and
              device time by kind, and the bytes bound.
10. moe     — the MoE family at full width, depth cut to fit the card:
              a mixtral-8x22b service (depth 4) beside gemma-2b on one
              ``SalusExecutor`` (the serve phase's checks, device time by
              kind with the dispatch apart); prefill parity of mixtral at
              (1, 6144), past its 4096 window, and of qwen3-moe-235b-a22b
              (depth 4) at (1, 512), kernels against plain in bf16 and
              fp32 (fp32 routes every token alike and drops the same
              assignments; bf16 on the plain run's routing, and free, its
              tokens sent to other experts within twice those plain bf16
              sends apart from plain fp32); mixtral's decode
              checks (token 511 against a full forward that drops
              nothing, 16 greedy tokens across the ring's wrap, the int8
              cache); a mixtral decode step at depth 8, bf16 params and a
              random bf16 ring cache at batch 64, timed as in decode.
11. families — the last three families at full width: hymba-1.5b
              (hybrid, full depth) served beside gemma-2b (the serve
              cell's traffic, SSM chunks of 8), prefill parity at
              (1, 2560) (its 1024 window binds, the ring is rolled, 20
              SSM chunks), a profiled prefill with the SSM scan's share
              of device time, the decode checks of the decode phase, 8
              layers deep (16 greedy tokens from 2560 across the ring's
              wrap) and a timed
              step at DECODE_32K's positions, batch 128, bf16 ring, with
              its bytes bound (params, ring, the SSM state read and
              written); musicgen-medium (audio: frame embeddings, full
              depth) prefill parity at (1, 2048), the decode step fed a
              frame embedding against the full forward, a timed step with
              a bf16 cache cut to 40 GB; qwen2-vl-72b (vlm, 4 of 80
              layers) prefill parity at (1, 1024) with 256 patch
              embeddings spliced in and distinct grid M-RoPE ids, and the
              decode step fed (1, 3, 1) ids.
12. differential — the live ``SalusExecutor`` against the port's own
              ``Simulator`` (``repro_torch.core.simulator``) on the same
              JobSpecs (measured profiles, declared iteration times),
              nominal accounting, gemma-2b at full width and depth in fp32
              through K1 and K3: D1, three sessions of the serve driver's
              (4, 16) prefill, each on params from its own seed, at a
              capacity of two sessions' persistent bytes and the largest
              ephemeral (the third's arrival pages one out), under FIFO,
              SRTF and FAIR; D2, two services on the request streams of
              the port's ``request_trace`` beside a background SGD trainer,
              PRIORITY. Decision logs, each lane's iteration order (FAIR:
              the lane's iterations, and their order against a nominal
              replay on the CPU) and request latencies equal the
              Simulator's; a page-out and page-in in D1, tokens bit for
              bit across the round trip, the page-out freeing 0.99 of the
              victim's bytes; every request served; exact launch counts.
              Page moves in seconds and GB/s beside the paging phase's,
              the device's busy share of each run, the card and its
              power limit.
13. fleet   — Salus's live fleet, ``ClusterExecutor``, against the port's
              own ``Cluster`` on the same JobSpecs, nominal accounting:
              three executors all on the one card (``device="cuda"``
              binds executor i to ``cuda:{i % cards}``), SRTF,
              least-loaded placement, a consolidating ``Rebalancer`` at
              epoch boundaries; four fp32 gemma-2b sessions at full width
              and depth of the serve driver's (4, 16) prefill through K1
              and K3, in ``tests/test_migration.py``'s shape (two of 40
              requests, two of 6). F1, paging off (profiled) and on; F2,
              the first migration failing (``FailureInjector``) and
              rolled back; F3, F1's threaded run against the sequential
              driver. Migration, placement and every device's decision
              log equal the Cluster's, something migrates, every session
              completes with its tokens bit for bit, threads and
              sequential identical in their nominal data, exact launch
              counts; each migration's page-out and page-in seconds and
              GB beside the paging and differential phases' moves.
14. ckpt    — checkpoints, the dist layer and gradient compression
              (``phase_ckpt``): gemma-2b at full width and 1 layer on a
              one-rank (1, 1) mesh; A, 4 steps from a seed; B, the same
              saved after every step, killed at step 2 and restored onto
              the mesh (``restore_on_mesh``), bit for bit A's; C, a
              trainer session migrated between two executors through a
              checkpoint (``migrate_in``'s ``put_fn``), bit for bit an
              unmigrated one; D, int8 error-feedback compression of one
              gradient tree, its payload equal to the CPU's; save, write
              and restore seconds and GB/s, exact launch counts.
15. cli     — the training CLI (``repro_torch.launch.train``, the loop its
              ``main`` runs) and the example twins (``phase_cli``):
              gemma-2b at full width and depth, 3 steps of the train
              phase's shape on a one-rank (1, 1) mesh, then with
              ``--compress-grads``, each step's seconds and the peak
              memory; at the ckpt phase's depth, a run saved every 2 steps,
              the same killed at step 3 and resumed, its final checkpoint
              bit for bit the first's, and a second call resuming from a
              meta template; ``examples/torch``'s train_lm (300 steps,
              ``loss < 4.0``), hyperparam_tuning (PACK and FIFO),
              inference_packing (12 services) and quickstart; exact launch
              counts.
16. tp      — tensor parallelism on the model axis (``phase_tp``, run
              after parity, before the phases that page through the
              host's memory, which the ranks share): two
              rank processes of a gloo group on the one card, a (1, 2)
              ``data, model`` mesh, params drawn a layer at a time and
              placed as drawn; qwen3-8b at full depth served (16 greedy
              bf16 tokens of a (4, 16) prompt, a (1, 512) fp32 prefill),
              rwkv6-7b, hymba-1.5b and mixtral-8x22b (4 layers) fp32
              prefills, and a 4-layer qwen3-8b fp32 AdamW step at (1,
              4096), each held against the one-process port on the same
              params; K1/K3/K4/B1/B2 launched on each rank's local heads;
              params resident and the step's peak a rank.
17. rwkv_train — rwkv6-7b at full width, 4 of 32 layers (run after
              train_parity): (a) three AdamW steps as a ``SalusExecutor``
              session at the runtime tables' settings (4 microbatches of
              one 4096-token sequence, remat, fp32 params, bf16 compute),
              exact K1/B1/K4/B3 launch counts, a profiled step with B3's
              device time, step seconds, tokens a second and the peak;
              (b) one (1, 4096) batch's fp32 loss and every gradient leaf
              through the kernels against the plain path (1e-5, 1e-4);
              (c) the train CLI and ``make_trainer``'s session at smoke
              size on the card.
18. dryrun  — the dry run (``repro_torch.launch.dryrun``) against the
              card (``phase_dryrun``, after train): the serve phase's
              qwen3-8b (4, 16) prefill (bf16 params) and the train phase's
              gemma-2b step, each counted on one rank under fake tensors
              (kernels by their ``cost``), then run once timed and once
              under ``torch.profiler`` with its FLOPs: the count's peak
              within 10% of ``max_memory_allocated``, its products' FLOPs
              within 1% of the profiler's (ops that ran a kernel), each
              kernel's launches equal to the wrappers' counters; the
              roofline terms, the measured time and the share of the
              bound. The CLI on qwen2-72b train_4k, mixtral-8x22b
              decode_32k and rwkv6-7b long_500k on the 16x16 fake mesh,
              kernel mode, meanwhile (started once the step is timed).
19. ctl     — the persistent control plane (``repro_torch.ctl``, which takes
              no device and imports no torch) in a tree without JAX, as
              ``tests/test_ctl_recovery.py``'s SIGKILL test: ``python -m
              repro_torch.ctl ... start`` (capacity 4 GB, epoch 20, 0.05 s
              a paced epoch), three 300-iteration jobs submitted through
              the CLI, the daemon SIGKILLed after its first committed epoch,
              a second daemon on the same store waited on until quiet: the
              decision log before the kill a prefix of the log after it,
              every job FINISHED once with 300 iterations, ``status`` equal
              to the store, ``replay()`` clean; at most 20 s.
20. lint    — the repo's linter in the port (``repro_torch.analysis``,
              standard library: no torch, no JAX), run after ctl: ``src/repro_torch`` under ``analysis_torch.toml``
              clean with every suppression used, then each of the 14
              rules' fixture pairs under ``tests/fixtures/analysis``, the
              bad file tripping its rule and the good file clean; files,
              findings, suppressed, the rules held, seconds; at most 60 s.
21. families_train — every attention family trains at full width
              (``phase_families_train``): musicgen-medium at full depth,
              hymba-1.5b (2 of 32 layers), qwen2-vl-72b (4 of 80),
              mixtral-8x22b (2 of 56) and qwen3-moe-235b-a22b (1 of 94),
              each (a) three
              AdamW steps as a ``SalusExecutor`` session at TRAIN_4K x 4
              and its runtime-table options (bf16 params and moments for
              the 100B-class archs), fed ``make_batch_for``'s batches
              (frame embeddings, spliced patch embeddings, M-RoPE ids):
              finite losses, optimizer steps 1..3, exact launches, device
              time in each kernel, step seconds, tokens a second, busy
              share, top kernels, the peak beside the dry run's count;
              (b) one sequence at 2 layers (mixtral's (1, 6144), where its
              window binds): the fp32 loss and every gradient leaf through
              K1/K3/B1/B2 against the plain path (1e-5, 1e-4), MoE routing
              traced, 0 tokens apart in fp32, and bf16 on one routing
              within 2e-2; (c) the train CLI and ``make_trainer`` of
              hymba and mixtral at smoke size; at most 240 s.
Then each phase's seconds and the ``{"kernels": [...]}`` summary line.

Any failed check raises and the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or run outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import NamedTuple

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the JAX kernel tests' tolerances (tests/test_kernels_rmsnorm.py, _flash.py)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
WKV_TOL = 2e-3  # tests/test_kernels_rwkv.py
# K3 at one query against thousands of keys, bf16: relative Frobenius
# against the plain version. Outputs there average V over ~sk/e keys, so
# they are ~sqrt(e/sk) (0.009 at 32768 keys) and FLASH_TOL's 2e-2 floor
# would hide a dropped key tile. Both sides round P and the output to bf16
# (unit roundoff 2^-9 each): ~3e-3 apart on random inputs; the bound is 2^-7.
# Dropping the last 64 keys moves the output by ~sqrt(64 / sk): 0.044 at 32768.
# bf16 prefill rows at LONG_KEYS keys or more are held so too, with a
# control a tile off: a windowed row's band 64 keys narrower (0.032 at
# mixtral's 4096 of 6144), another row without its first 64 keys.
DECODE_REL_TOL = 2.0 ** -7
DECODE_DROPPED_KEYS = 64  # the control: the kernel without the last 64 keys
LONG_KEYS = 1024
# backward kernels: relative Frobenius, fp32 / bf16 (the JAX tests' bf16)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RMS_SRC = "src/repro_torch/csrc/rmsnorm.cu"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
FLASH_BWD_SRC = "src/repro_torch/csrc/flash_attention_bwd.cu"
WKV_SRC = "src/repro_torch/csrc/wkv6.cu"
WKV_BWD_SRC = "src/repro_torch/csrc/wkv6_bwd.cu"
RMS_TPU = "src/repro/kernels/fused_rmsnorm/kernel.py:19"
RMS_RES_TPU = "src/repro/kernels/fused_rmsnorm/kernel.py:27"
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:35"
WKV_TPU = "src/repro/kernels/rwkv_scan/kernel.py:31"
SERVE_ARCHS = ["gemma-2b", "qwen3-8b", "rwkv6-7b"]
TRAIN_ARCH = "gemma-2b"
TRAIN_BATCH = 4  # global batch of TRAIN_4K-length sequences
TRAIN_STEPS = 3
RWKV_ARCH = "rwkv6-7b"
RWKV_TRAIN_DEPTH = 4  # phase rwkv_train: 4 of 32 layers, as phase tp cuts rwkv (1.42e9 params)
DECODE_PROMPT = 511  # tokens prefilled before the decode checks
DECODE_NEW = 16  # greedy tokens
DECODE_CACHE_GB = 40  # the decode shape's batch is halved until its state fits
DECODE_STEPS = 4  # timed steps at the decode shape
# the decode checks (decode_correctness) of the full-depth archs run at
# full width, 8 layers deep, to keep the whole run well inside its limit;
# the timed steps stay at full depth
DECODE_CHECK_DEPTH = 8
MOE_ARCH = "mixtral-8x22b"
QWEN3_MOE_ARCH = "qwen3-moe-235b-a22b"
# full width, depth cut from 56 (mixtral) and 94 (qwen3-moe) layers: 4
# layers of fp32 params are 41.7 and 44.8 GB, 8 of bf16 (mixtral) 40.9 GB;
# one card holds 80 GB
MOE_DEPTH = 4
MOE_TIMING_DEPTH = 8
MOE_PARITY_PROMPT = 6144  # past mixtral's 4096 window, and no multiple of it
MOE_RING_PROMPT = 4104  # fills the 4096-slot ring and wraps it by 8
MOE_DECODE_BATCH = 64  # a bf16 ring cache of 8.6 GB at depth 8
# bf16 MoE prefill with routing free: the kernels' tokens flipped to other
# experts a route call, at most this many times the plain bf16 path's
# against the plain fp32 path
MOE_FLIP_FACTOR = 2
HYMBA_ARCH = "hymba-1.5b"
MUSICGEN_ARCH = "musicgen-medium"
QWEN2_VL_ARCH = "qwen2-vl-72b"
# hymba's parity and greedy prompt: past its 1024 window and no multiple
# of it (the ring is rolled, and decode writes into a wrapped ring), and
# 20 SSM chunks of 128 (the chunked scan runs, not its fallback)
HYMBA_PROMPT = 2560
HYMBA_DECODE_BATCH = 128  # DECODE_32K's: a bf16 ring of 5.37 GB
MUSICGEN_PROMPT = 2048
# qwen2-vl-72b at full width, depth cut from 80: 4 layers of fp32 params
# are 14.0 GB, its untied embedding and head 10.0 GB
QWEN2_VL_DEPTH = 4
QWEN2_VL_PROMPT = 1024
PATCH_GRID_WIDTH = 16  # qwen2-vl's 256 patches as a 16 x 16 grid
# phase families_train: each family's training step at full width, at
# TRAIN_4K's sequence, TRAIN_BATCH and its runtime-table options; a depth
# of None is the arch's own, else a cut: qwen3-moe's step at 2 layers
# counts 75.93 GiB (scripts/families_train_count.py), inside the count's
# error of the card's 76, so 1; hymba's plain SSM scan dispatches ~59k
# ops a layer and microbatch (its doubling passes, their slices'
# backward), 0.22-0.37 s a layer and microbatch on the card, so its 32
# layers would take ~30-50 s a step: 2 here, the parity passes' depth
FAMILIES_TRAIN = ((HYMBA_ARCH, 2), (MUSICGEN_ARCH, None), (QWEN2_VL_ARCH, 4),
                  (MOE_ARCH, 2), (QWEN3_MOE_ARCH, 1))
# its fp32 parity passes, one sequence: 2 layers, or 1 where
# scripts/families_train_count.py counts 2 past the card; mixtral's
# sequence is the moe phase's prompt, where its 4096 window binds
FAMILIES_PARITY_DEPTH = 2
FAMILIES_PARITY_SEQ = {MOE_ARCH: MOE_PARITY_PROMPT}
# their options: fp32 params (the runtime table holds bf16 ones for the
# 100B-class archs) and the plain path's queries in chunks of 1024 (its
# scores' memory; the same function)
PARITY_OPTS = dict(param_dtype="float32", attn_q_chunk=1024)
FAMILIES_ENTRY_ARCHS = (HYMBA_ARCH, MOE_ARCH)  # the train CLI and make_trainer at smoke
FAMILIES_TRAIN_LIMIT_S = 240.0  # the phase's budget inside the script's 1200 s
# the dry run's count of each session step's peak, GiB
# (scripts/families_train_count.py, printed beside the card's)
FAMILIES_TRAIN_COUNTED_GIB = {HYMBA_ARCH: 15.800, MUSICGEN_ARCH: 34.222, QWEN2_VL_ARCH: 62.890,
                              MOE_ARCH: 68.394, QWEN3_MOE_ARCH: 52.762}
# its kernels' shapes at a (1, 4096) microbatch, for the kernels phase:
# the norm rows at each width (hymba, musicgen, qwen2-vl, mixtral,
# qwen3-moe) and qwen3-moe's q- and k-norm rows (64 and 4 heads of 128);
# each family's heads, and mixtral's at the parity prompt, where its
# window binds
FAMILIES_TRAIN_NORMS = ((4096, 1600), (4096, 1536), (4096, 8192), (4096, 6144), (4096, 4096),
                        (4096 * 64, 128), (4096 * 4, 128))
FAMILIES_TRAIN_FLASH = (
    dict(b=1, sq=4096, sk=4096, hq=25, hkv=5, d=64, window=1024),
    dict(b=1, sq=4096, sk=4096, hq=24, hkv=24, d=64),
    dict(b=1, sq=4096, sk=4096, hq=64, hkv=8, d=128),
    dict(b=1, sq=4096, sk=4096, hq=48, hkv=8, d=128, window=4096),
    dict(b=1, sq=MOE_PARITY_PROMPT, sk=MOE_PARITY_PROMPT, hq=48, hkv=8, d=128, window=4096),
    dict(b=1, sq=4096, sk=4096, hq=64, hkv=4, d=128),
)
# profiler spans around the SSM branch and its scan (``ssm_spans``)
SSM_SPANS = {"ssm_apply": "ssm_branch", "ssm_decode": "ssm_branch",
             "ssm_scan_chunked": "ssm_scan", "ssm_scan_ref": "ssm_scan"}
# w = sigmoid(z) * span + low: the JAX kernel test's slow and fast decay
# regimes, and a faster one with decays down to 0.05
DECAY_REGIMES = {"slow": (0.1, 0.88), "fast": (0.5, 0.15), "faster": (0.9, 0.05)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    one warm-up call."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host-clock milliseconds to enqueue one call of ``fn``, with no
    synchronise inside the window (the wrapper's cost a launch), after one
    warm-up call."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    sync()
    return ms


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over the whole tensor, in fp32."""
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def worst_element(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Where |a - b| is largest: the index, both values, and the largest
    |b| in the same row of the last dimension."""
    a, b = a.float(), b.float()
    flat = int((a - b).abs().argmax().item())
    idx = []
    for n in reversed(b.shape):
        idx.insert(0, flat % n)
        flat //= n
    row = b[tuple(idx[:-1])]
    return {"index": idx, "kernel": a[tuple(idx)].item(), "plain": b[tuple(idx)].item(),
            "row_max_abs": row.abs().max().item()}


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``x``: 2^-7 of its power of two."""
    return torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(math.log2(abs(x) or 1.0))


def within(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    """|a - b| <= tol + tol * |b| everywhere (the JAX tests' rtol = atol)."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all().item())


def bound(cost, dtype, attention: bool = False):
    """``(ms, "bytes" or "operations")``: the least time of a kernel call's
    ``cost`` (``(operations, bytes)``, its wrapper's ``cost``), its bytes
    read or written once, at the H100's figures (``launch/roofline.py``):
    fp32 arithmetic for the norms and WKV6, ``dtype``'s products for
    attention (fp32 attention at the 3xTF32 line)."""
    from repro_torch.launch.roofline import (
        HBM_BYTES_PER_S,
        PEAK_FLOPS,
        PEAK_FLOPS_FP32_ATTENTION,
    )

    rate = PEAK_FLOPS_FP32_ATTENTION if attention and dtype == torch.float32 else PEAK_FLOPS[dtype]
    t_bytes, t_ops = cost[1] / HBM_BYTES_PER_S, cost[0] / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: env
# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_env() -> dict:
    smi = nvidia_smi()
    print(smi, flush=True)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = ptxas_report((_build.BUILD_ROOT / _build.build_key() / _build.LOG_NAME).read_text())
    info = {
        "phase": "env",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "kernel_build_s": build_s,
        "flash_wgmma_ptxas": {k: v for k, v in regs.items() if "flash_fwd_kernel_wgmma" in k},
        "wkv6_ptxas": {k: v for k, v in regs.items() if "wkv6_fwd_kernel" in k},
        "wkv6_bwd_ptxas": {k: v for k, v in regs.items() if "wkv6_bwd_" in k},
        "backward_ptxas": {k: v for k, v in regs.items()
                           if "flash_bwd_" in k or "rmsnorm_bwd_kernel" in k},
        "kernels_with_spills": sorted(k for k, v in regs.items() if v.get("spill_stores")),
    }
    emit(info)
    check(bool(info["wkv6_ptxas"]), "no ptxas report of the WKV6 kernel")
    check(all(any(n in k for k in info["wkv6_bwd_ptxas"]) for n in WKV_BWD_KERNELS),
          f"no ptxas report of every WKV6 backward kernel {WKV_BWD_KERNELS}")
    check(any("flash_bwd_dkdv_kernel_wgmma" in k for k in info["backward_ptxas"]),
          "no ptxas report of the tensor-core flash backward")
    for name, v in (*info["wkv6_ptxas"].items(), *info["wkv6_bwd_ptxas"].items(),
                    *((k, v) for k, v in info["backward_ptxas"].items() if "flash_bwd_" in k)):
        check(not v.get("spill_stores") and not v.get("spill_loads"),
              f"{name} spills: {v}")
    return info


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel, from ``nvcc -Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rmsnorm_case(rows: int, d: int, dtype, residual: bool, iters: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.fused_rmsnorm import ops
    from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(rows * 7 + d)
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    scale = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0).to(dtype)
    r = torch.randn(rows, d, generator=gen, device="cuda").to(dtype) if residual else None
    out = ops.rmsnorm(x, scale, r)
    ref = rmsnorm_ref(x, scale, r)
    sync()
    tol = TOL[dtype]
    err = max_err(out, ref)
    ok = within(out, ref, tol)
    ms = time_ms(lambda: ops.rmsnorm(x, scale, r), iters)
    launch_ms = host_ms(lambda: ops.rmsnorm(x, scale, r), iters)
    plain_ms = time_ms(lambda: rmsnorm_ref(x, scale, r), iters)
    library_ms = None
    if not residual and hasattr(F, "rms_norm"):
        library_ms = time_ms(lambda: F.rms_norm(x, (d,), scale, 1e-6), iters)
    bound_ms, bound_by = bound(ops.cost(rows, d, x.element_size(), scale.element_size(),
                                        residual=residual), torch.float32)
    res = {
        "phase": "kernels",
        "kernel": "rmsnorm_residual" if residual else "rmsnorm",
        "shape": [rows, d],
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": tol,
        "ok": ok,
        "ms": ms,
        "host_ms": launch_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "launch_shape": ops.launch_shape(d, x.element_size())._asdict(),
    }
    emit(res)
    check(ok, f"rmsnorm {rows}x{d} {dtype} residual={residual}: err {err} > tol {tol}")
    return res


def flash_case(b, sq, sk, hq, hkv, d, dtype, *, causal=True, window=None,
               q_offset=0, iters=10) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(sq * 31 + hq * 7 + d)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    run = lambda: ops.flash_attention(q, k, v, block_q=sq, block_k=sk, **kw)
    plain = lambda: attention_ref(q, k, v, **kw)
    out, ref = run(), plain()
    sync()
    tol = FLASH_TOL[dtype]
    err = max_err(out, ref)
    ok = within(out, ref, tol)
    held = {}
    if dtype == torch.bfloat16 and sk >= LONG_KEYS:
        # FLASH_TOL is as large as a typical output here: also held as a
        # whole, with a control a key tile off that must miss the bound
        m = DECODE_DROPPED_KEYS
        if window:  # the band a tile narrower
            control = ops.flash_attention(q, k, v, block_q=sq, block_k=sk, causal=causal,
                                          window=window - m, q_offset=q_offset)
            kind, control_ref = f"window {window - m}", ref
        else:  # without the first key tile (and the queries that see only it)
            a = max(0, m - q_offset)
            control = ops.flash_attention(q[:, a:], k[:, m:], v[:, m:], block_q=sq - a,
                                          block_k=sk - m, causal=causal, q_offset=q_offset + a - m)
            kind, control_ref = f"without the first {m} keys", ref[:, a:]
        held = {"rel_fro": rel_fro(out, ref), "rel_tol": DECODE_REL_TOL, "control": kind,
                "control_rel_fro": rel_fro(control, control_ref)}
        del control, control_ref
        ok = ok and held["rel_fro"] <= DECODE_REL_TOL
    ms = time_ms(run, iters)
    launch_ms = host_ms(run, iters)
    plain_ms = time_ms(plain, iters)
    qpos = torch.arange(sq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    library_ms = None
    if q_offset == 0 and sq == sk:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if window is None:
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=hq != hkv
                ),
                iters,
            )
        else:  # the band as a boolean mask (True: attend), K/V per query head
            ke = kt.repeat_interleave(hq // hkv, dim=1)
            ve = vt.repeat_interleave(hq // hkv, dim=1)
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(qt, ke, ve, attn_mask=mask), iters)
            del ke, ve
    cost = ops.cost(b, sq, sk, hq, hkv, d, q.element_size(), **kw)  # the pairs the mask needs
    flops = cost[0]
    bound_ms, bound_by = bound(cost, dtype, attention=True)
    res = {
        "phase": "kernels",
        "kernel": "flash_attention",
        "shape": {"b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv, "d": d,
                  "causal": causal, "window": window, "q_offset": q_offset},
        "dtype": str(dtype).removeprefix("torch."),
        "route": ops.route(dtype, d),
        "max_abs_err": err,
        "tol": tol,
        **held,
        "ok": ok and held.get("control_rel_fro", math.inf) > DECODE_REL_TOL,
        "ms": ms,
        "host_ms": launch_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "gflop": flops / 1e9,
    }
    emit(res)
    check(ok, f"flash {res['shape']} {dtype}: err {err} > tol {tol} or "
              f"rel_fro {held.get('rel_fro')} > {DECODE_REL_TOL}")
    if held:
        check(held["control_rel_fro"] > DECODE_REL_TOL,
              f"flash {res['shape']}: {held['control']} rel_fro {held['control_rel_fro']} "
              f"<= tol {DECODE_REL_TOL}: the check is blind")
    return res


def flash_decode_case(b, sk, hq, hkv, d, iters=10) -> dict:
    """K3 at one query a sequence against the first ``sk`` keys of layer 1
    of a stacked bf16 cache ``(2, b, cap, hkv, d)`` (a strided view, as a
    decode step reads it), non-causal, in two forms: one query row a head,
    and GQA folded (the ``hq / hkv`` query heads of a kv head as that many
    query rows of one head, legal because every row has the same keys;
    what the model runs, ``attention.attend_prefix_folded``). Both held
    against the plain version by relative Frobenius within DECODE_REL_TOL
    (and elementwise within FLASH_TOL), with a control that must miss it (the folded form without the last
    DECODE_DROPPED_KEYS keys), timed in turns, beside SDPA on the same
    views and the bytes bound (K and V read once)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dtype, cap, n_rep = torch.bfloat16, sk + 64, hq // hkv
    gen = torch.Generator(device="cuda").manual_seed(sk + hq * 7 + d)
    cache_k = torch.randn(2, b, cap, hkv, d, generator=gen, device="cuda", dtype=dtype)
    cache_v = torch.randn(2, b, cap, hkv, d, generator=gen, device="cuda", dtype=dtype)
    k, v = cache_k[1, :, :sk], cache_v[1, :, :sk]
    q = torch.randn(b, 1, hq, d, generator=gen, device="cuda", dtype=dtype)
    # query head g n_rep + r is row r of kv head g
    q_folded = q.view(b, hkv, n_rep, d).transpose(1, 2)
    forms = {
        "head_rows": lambda: ops.flash_attention(q, k, v, causal=False, block_q=1, block_k=sk),
        "gqa_folded": lambda: ops.flash_attention(
            q_folded, k, v, causal=False, block_q=n_rep, block_k=sk
        ).transpose(1, 2).reshape(b, 1, hq, d),
    }
    plain = lambda: attention_ref(q, k, v, causal=False)
    ref = plain()
    tol = DECODE_REL_TOL
    outs = {name: fn() for name, fn in forms.items()}
    err = {name: max_err(out, ref) for name, out in outs.items()}
    rel = {name: rel_fro(out, ref) for name, out in outs.items()}
    ok = {name: r <= tol and within(outs[name], ref, FLASH_TOL[dtype])
          for name, r in rel.items()}
    kept = sk - DECODE_DROPPED_KEYS
    control = ops.flash_attention(
        q_folded, k[:, :kept], v[:, :kept], causal=False, block_q=n_rep, block_k=kept
    ).transpose(1, 2).reshape(b, 1, hq, d)
    control_rel = rel_fro(control, ref)
    sync()
    del outs, control
    form_ms = {}
    for name in ("head_rows", "gqa_folded", "gqa_folded", "head_rows"):
        form_ms.setdefault(name, []).append(time_ms(forms[name], iters))
    launch_ms = host_ms(forms["gqa_folded"], iters)
    plain_ms = time_ms(plain, max(1, iters // 5))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=hq != hkv), iters)
    cost = ops.cost(b, 1, sk, hq, hkv, d, q.element_size(), causal=False)
    flops = cost[0]
    bound_ms, bound_by = bound(cost, dtype, attention=True)
    res = {
        "phase": "kernels", "kernel": "flash_attention", "decode": True,
        "shape": {"b": b, "sq": 1, "sk": sk, "hq": hq, "hkv": hkv, "d": d, "causal": False,
                  "cache_capacity": cap, "window": None, "q_offset": 0},
        "dtype": "bfloat16", "route": ops.route(dtype, d),
        "max_abs_err": err["gqa_folded"], "max_abs_err_by_form": err,
        "rel_fro_by_form": rel, "tol": tol, "tol_kind": "rel_fro",
        "ref_max_abs": ref.abs().max().item(),
        "control_dropped_keys": DECODE_DROPPED_KEYS, "control_rel_fro": control_rel,
        "ok": all(ok.values()) and control_rel > tol,
        "ms": sum(form_ms["gqa_folded"]) / 2, "ms_by_form": form_ms,
        "host_ms": launch_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
    }
    emit(res)
    check(all(ok.values()), f"flash decode {res['shape']}: rel_fro {rel} > tol {tol}")
    check(control_rel > tol, f"flash decode {res['shape']}: without the last "
          f"{DECODE_DROPPED_KEYS} keys rel_fro {control_rel} <= tol {tol}: the check is blind")
    del cache_k, cache_v, k, v, q, q_folded, ref
    return res


def wkv6_case(b, s, h, d, chunk, regime, iters=10, plain_iters=2, carried=False) -> dict:
    """``carried``: from a random state ``s0`` (a decode step's), which the
    plain chunked path does not take."""
    from repro_torch.kernels.rwkv_scan import ops
    from repro_torch.kernels.rwkv_scan.ref import wkv6_ref
    from repro_torch.models.rwkv import wkv_chunked

    gen = torch.Generator(device="cuda").manual_seed(s * 13 + chunk)
    r = torch.randn(b, s, h, d, generator=gen, device="cuda")
    k = torch.randn(b, s, h, d, generator=gen, device="cuda")
    v = torch.randn(b, s, h, d, generator=gen, device="cuda")
    span, low = DECAY_REGIMES[regime]
    w = torch.sigmoid(torch.randn(b, s, h, d, generator=gen, device="cuda")) * span + low
    u = torch.randn(h, d, generator=gen, device="cuda") * 0.1
    s0 = torch.randn(b, h, d, d, generator=gen, device="cuda") if carried else None
    run = lambda: ops.wkv6(r, k, v, w, u, chunk=chunk, s0=s0)
    plain = lambda: wkv6_ref(r, k, v, w, u, s0)
    chunked = None if carried else (lambda: wkv_chunked(r, k, v, w, u, chunk=chunk))
    (o, sf), (o_ref, s_ref) = run(), plain()
    sync()
    finite = bool(torch.isfinite(o).all().item() and torch.isfinite(sf).all().item())
    err = max(max_err(o, o_ref), max_err(sf, s_ref))
    ok = finite and within(o, o_ref, WKV_TOL) and within(sf, s_ref, WKV_TOL)
    # the state's columns a block: the whole head (scores once a head), or
    # half (twice the blocks, each computing the scores); the kernel's own
    # choice is what ``ops.wkv6`` runs. Timed in turns, each held to the
    # plain version too
    tiles = {"head": d, "half": d // 2}
    tile_ms = {}
    for name in ("head", "half", "half", "head"):
        tiled = lambda: ops._wkv6(r, k, v, w, u, chunk, s0, False, tiles[name])
        o_t, s_t = tiled()
        sync()
        check(within(o_t, o_ref, WKV_TOL) and within(s_t, s_ref, WKV_TOL),
              f"wkv6 column tile {tiles[name]}: off the plain version")
        tile_ms.setdefault(name, []).append(time_ms(tiled, iters))
    ms = time_ms(run, iters)
    launch_ms = host_ms(run, iters)
    plain_ms = time_ms(plain, plain_iters)
    chunked_ms = time_ms(chunked, plain_iters) if chunked else None
    bound_ms, bound_by = bound(ops.cost(b, s, h, d, d, carried=carried), torch.float32)
    res = {
        "phase": "kernels",
        "kernel": "wkv6",
        "shape": {"b": b, "s": s, "h": h, "dk": d, "dv": d, "chunk": chunk, "decay": regime,
                  "s0": carried},
        "dtype": "float32",
        "max_abs_err": err,
        "tol": WKV_TOL,
        "finite": finite,
        "ok": ok,
        "ms": ms,
        "host_ms": launch_ms,
        "plain_ms": plain_ms,
        "plain_chunked_ms": chunked_ms,
        "ms_by_column_tile": tile_ms,
        "library_ms": None,  # no PyTorch call computes WKV6
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(res)
    check(ok, f"wkv6 {res['shape']}: err {err} > tol {WKV_TOL} or not finite")
    return res


WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")
# B3's three kernels: passes A and B (boundary states and cotangents), pass
# C (every chunk), du's sum
WKV_BWD_KERNELS = ("wkv6_bwd_bound_kernel", "wkv6_bwd_chunk_kernel", "wkv6_bwd_du_kernel")


def wkv6_bwd_occupancy(dk: int, dv: int) -> dict:
    """Blocks resident an SM of each B3 kernel at these head sizes (the
    occupancy calculator, through ``wkv6_bwd_occupancy``), and pass C's
    threads a block."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.library().wkv6_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    _build.check(fn(dk, dv, torch.cuda.current_device(), ctypes.addressof(out)),
                 "wkv6_bwd_occupancy")
    return {**dict(zip(WKV_BWD_KERNELS, out[:3])), "chunk_threads": out[3],
            "chunk_warps_an_sm": out[1] * out[3] // 32}


def wkv6_bwd_case(b, s, h, d, regime, iters=10, carried=False) -> dict:
    """The WKV6 backward (B3) against its plain version, autograd through
    ``ref.wkv6_ref``, on the same CUDA tensors: a cotangent on the output,
    and with ``carried`` a random ``s0`` and a cotangent on the final state
    too (a training loss never reads the state). The control is the plain
    version's own gap from the same function in fp64: each gradient is held
    within BWD_TOL, or twice its control where that is larger."""
    from repro_torch.kernels.rwkv_scan import ops
    from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref

    gen = torch.Generator(device="cuda").manual_seed(s * 17 + b)
    r, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(3))
    span, low = DECAY_REGIMES[regime]
    w = torch.sigmoid(torch.randn(b, s, h, d, generator=gen, device="cuda")) * span + low
    u = torch.randn(h, d, generator=gen, device="cuda") * 0.1
    s0 = torch.randn(b, h, d, d, generator=gen, device="cuda") if carried else None
    do = torch.randn(b, s, h, d, generator=gen, device="cuda")
    dstate = torch.randn(b, h, d, d, generator=gen, device="cuda") if carried else None
    args = (do, dstate, r, k, v, w, u, s0)
    run = lambda: ops.wkv6_bwd(*args)
    before = ops.wkv6_bwd.launches
    got = run()
    again = run()
    sync()
    launched = ops.wkv6_bwd.launches - before
    repeat = all(x is None or torch.equal(x, y) for x, y in zip(got, again))
    del again
    # the plain version timed on the call that checks (events around one
    # call, after the kernel's warm-up; at (1, 4096) it is a 4096-step loop)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = wkv6_bwd_ref(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    exact = wkv6_bwd_ref(*(None if t is None else t.double() for t in args))
    rel, control, tol, errs = {}, {}, {}, []
    for name, a, p, x in zip(WKV_GRADS, got, want, exact):
        if p is None:
            continue
        rel[name] = rel_fro(a, p)
        control[name] = ((p.double() - x).norm() / x.norm().clamp_min(1e-30)).item()
        tol[name] = max(BWD_TOL[torch.float32], 2 * control[name])
        errs.append(max_err(a, p))
    finite = all(bool(torch.isfinite(t).all().item()) for t in got if t is not None)
    del want, exact
    ok = finite and repeat and launched == 2 and all(rel[n] <= tol[n] for n in rel)
    ms = time_ms(run, iters)
    launch_ms = host_ms(run, iters)
    by_kernel = kernel_device_us(run) if s >= 2048 else None
    bound_ms, bound_by = bound(ops.cost(b, s, h, d, d, carried=carried, backward=True),
                               torch.float32)
    res = {
        "phase": "kernels", "kernel": "wkv6_bwd",
        "shape": {"b": b, "s": s, "h": h, "dk": d, "dv": d, "decay": regime, "s0": carried,
                  "state_cotangent": carried},
        "dtype": "float32", "max_abs_err": max(errs), "rel_fro": rel,
        "plain_fp32_vs_fp64": control, "tol": tol, "finite": finite,
        "repeat_bit_for_bit": repeat, "launches_a_call": launched / 2, "ok": ok,
        "ms": ms, "host_ms": launch_ms, "plain_ms": plain_ms,
        "library_ms": None,  # no PyTorch call computes the WKV6 backward
        "bound_ms": bound_ms, "bound_by": bound_by, "device_us_by_kernel": by_kernel,
    }
    emit(res)
    check(ok, f"wkv6_bwd {res['shape']}: {rel} against {tol}, finite {finite}, "
              f"repeat {repeat}, launches {launched} for 2 calls")
    return res


def grad_time_ms(out: torch.Tensor, inputs, grad: torch.Tensor, iters: int) -> float:
    """Event time of one backward of ``out`` (built once, with its graph
    retained) with respect to ``inputs``."""
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True), iters)


def rmsnorm_bwd_case(rows: int, d: int, dtype, iters: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.fused_rmsnorm import ops
    from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    scale = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0).to(dtype)
    g = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    run = lambda: ops.rmsnorm_bwd(g, x, scale)
    dx, ds = run()
    rdx, rds = rmsnorm_bwd_ref(g, x, scale)
    xa, sa = x.clone().requires_grad_(), scale.clone().requires_grad_()
    rmsnorm_ref(xa, sa).backward(g)
    sync()
    tol = BWD_TOL[dtype]
    rel = {"dx": rel_fro(dx, rdx), "dscale": rel_fro(ds, rds)}
    rel_autograd = {"dx": rel_fro(dx, xa.grad), "dscale": rel_fro(ds, sa.grad)}
    ok = all(v <= tol for v in (*rel.values(), *rel_autograd.values()))
    ok = ok and bool(torch.isfinite(dx.float()).all().item() and torch.isfinite(ds.float()).all().item())
    ms = time_ms(run, iters)
    launch_ms = host_ms(run, iters)
    plain_ms = time_ms(lambda: rmsnorm_bwd_ref(g, x, scale), iters)
    library_ms = None
    if hasattr(F, "rms_norm"):
        xl, sl = x.clone().requires_grad_(), scale.clone().requires_grad_()
        library_ms = grad_time_ms(F.rms_norm(xl, (d,), sl, 1e-6), (xl, sl), g, iters)
    by_kernel = kernel_device_us(run)
    es = x.element_size()
    bound_ms, bound_by = bound(ops.cost(rows, d, es, scale.element_size(), backward=True),
                               torch.float32)
    res = {
        "phase": "kernels", "kernel": "rmsnorm_bwd", "shape": [rows, d],
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": max(max_err(dx, rdx), max_err(ds, rds)),
        "rel_fro": rel, "rel_fro_vs_autograd": rel_autograd, "tol": tol, "ok": ok,
        "ms": ms, "host_ms": launch_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "launch_shape": ops.bwd_launch_shape(d, es)._asdict(),
        "device_us_by_kernel": by_kernel, "device_us": sum(by_kernel.values()),
    }
    emit(res)
    check(ok, f"rmsnorm_bwd {rows}x{d} {dtype}: {rel} / {rel_autograd} > {tol}")
    return res


def kernel_device_us(fn, calls: int = 3) -> dict:
    """Device microseconds a call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = re.sub(r"^(void )?\(anonymous namespace\)::", "", evt.key).split("(")[0]
        out[name] = out.get(name, 0.0) + us / calls
    return out


def flash_bwd_case(b, sq, sk, hq, hkv, d, dtype, *, window=None, q_offset=0, iters=5) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

    gen = torch.Generator(device="cuda").manual_seed(sq * 17 + hq + d)
    q = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, sq, hq, d, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = ops._forward(q, k, v, True, window, q_offset, want_lse=True)
    run = lambda: ops.flash_attention_bwd(g, q, k, v, out, lse, **kw)
    got = run()
    again = run()
    sync()
    # no atomics: a second call gives the same bits
    repeat = all(torch.equal(a, c) for a, c in zip(got, again))
    del again
    want = attention_bwd_ref(g, q, k, v, out, lse, **kw)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    attention_ref(qa, ka, va, **kw).backward(g)
    sync()
    names = ("dq", "dk", "dv")
    tol = BWD_TOL[dtype]
    rel = {n: rel_fro(a, w) for n, a, w in zip(names, got, want)}
    rel_autograd = {n: rel_fro(a, w) for n, a, w in zip(names, got, (qa.grad, ka.grad, va.grad))}
    del qa, ka, va
    finite = all(bool(torch.isfinite(t.float()).all().item()) for t in got)
    ok = finite and repeat and all(v <= tol for v in (*rel.values(), *rel_autograd.values()))
    ms = time_ms(run, iters)
    launch_ms = host_ms(run, iters)
    plain_ms = time_ms(lambda: attention_bwd_ref(g, q, k, v, out, lse, **kw), max(1, iters // 2))
    qpos = torch.arange(sq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    # the library call: SDPA's backward under autograd, the causal flag
    # where that is the whole mask, else the same mask as a boolean
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    if window is None and q_offset == 0 and sq == sk:
        y = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=hq != hkv)
    else:
        y = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=hq != hkv)
    library_ms = grad_time_ms(y, (qt, kt, vt), g.transpose(1, 2), iters)
    del qt, kt, vt, y
    route = ops.bwd_route(dtype, d)
    plan = ops.bwd_plan(b, sq, sk, hq, hkv, d, True)._asdict() if route != "simt" else None
    by_kernel = kernel_device_us(run) if route != "simt" and sq >= 512 else None
    cost = ops.cost(b, sq, sk, hq, hkv, d, q.element_size(), window=window, q_offset=q_offset,
                    backward=True)  # the pairs the mask needs
    flops = cost[0]
    bound_ms, bound_by = bound(cost, dtype, attention=True)
    res = {
        "phase": "kernels", "kernel": "flash_attention_bwd",
        "shape": {"b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv, "d": d,
                  "causal": True, "window": window, "q_offset": q_offset},
        "dtype": str(dtype).removeprefix("torch."), "route": route, "plan": plan,
        "max_abs_err": max(max_err(a, w) for a, w in zip(got, want)),
        "rel_fro": rel, "rel_fro_vs_autograd": rel_autograd, "tol": tol, "finite": finite,
        "repeat_bit_for_bit": repeat,
        "ok": ok, "ms": ms, "host_ms": launch_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
        "device_us_by_kernel": by_kernel,
    }
    emit(res)
    check(ok, f"flash_attention_bwd {res['shape']} {dtype}: {rel} / {rel_autograd} > {tol}"
              f" or repeat {repeat}")
    del got, want, out, lse
    return res


def host_breakdown() -> dict:
    """Where a wrapper's host cost a launch goes, at the serve shapes:
    host-clock microseconds a call, no synchronise inside the window."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_rmsnorm import ops as rms
    from repro_torch.kernels.rwkv_scan import ops as wkv

    lib = _build.library()
    x = torch.randn(64, 4096, device="cuda").bfloat16()
    scale = torch.ones(4096, device="cuda").bfloat16()
    out = torch.empty_like(x)
    q = torch.randn(4, 16, 32, 128, device="cuda").bfloat16()
    k = torch.randn(4, 16, 8, 128, device="cuda").bfloat16()
    o = torch.empty_like(q)
    dev = torch.cuda.current_device()
    stream = _build.current_stream(dev)
    shape = rms.launch_shape(4096, 2)
    tma = fa._tma_args(q, k, k)
    fa_args = (q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(), 4, 16, 16, 32, 8, 128,
               *q.stride()[:3], *k.stride()[:3], *k.stride()[:3], 128 ** -0.5, 1, 0, 0, 1, tma,
               None, dev, stream)
    rkvwu = [torch.rand(4, 16, 64, 64, device="cuda") for _ in range(4)]
    rkvwu.append(torch.rand(64, 64, device="cuda"))
    wo = torch.empty(4, 16, 64, 64, device="cuda")
    wst = torch.empty(4, 64, 64, 64, device="cuda")
    strides = [x for t in rkvwu[:4] for x in t.stride()[:3]]
    wkv_args = (*(t.data_ptr() for t in rkvwu), None, wo.data_ptr(), wst.data_ptr(),
                4, 16, 64, 64, 64, 8, *strides, dev, stream)
    pieces = {
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_build.current_stream": lambda: _build.current_stream(dev),
        "torch.empty_like (64, 4096)": lambda: torch.empty_like(x),
        "rmsnorm_fwd through ctypes, arguments ready": lambda: lib.rmsnorm_fwd(
            x.data_ptr(), None, scale.data_ptr(), out.data_ptr(), 64, 4096, 1e-6, 1, 1,
            *shape[:3], dev, stream),
        "ops.rmsnorm (64, 4096)": lambda: rms.rmsnorm(x, scale),
        "F.rms_norm (64, 4096)": lambda: torch.nn.functional.rms_norm(x, (4096,), scale, 1e-6),
        "tensor-map geometry (cached)": lambda: fa._tma_args(q, k, k),
        "flash_attention_fwd through ctypes, arguments ready (3 encodes + launch)":
            lambda: lib.flash_attention_fwd(*fa_args),
        "ops.flash_attention (4, 16) 32/8 d 128": lambda: fa.flash_attention(
            q, k, k, block_q=16, block_k=16),
        "wkv6_fwd through ctypes, arguments ready": lambda: lib.wkv6_fwd(*wkv_args),
        "ops.wkv6 (4, 16) 64 heads of 64, chunk 8": lambda: wkv.wkv6(*rkvwu, chunk=8),
    }
    res = {"phase": "kernels", "host_us_a_call": {
        name: 1e3 * host_ms(fn, 500) for name, fn in pieces.items()}}
    emit(res)
    return res


def phase_kernels() -> dict:
    bf16, f32 = torch.bfloat16, torch.float32
    results = {"host": host_breakdown()}
    for dtype in (f32, bf16):
        # serve path (b*s = 64 rows): attn/mlp norm qwen3 (4096), gemma
        # (2048); qk-norm rows b*s*heads; and a prefill-sized input
        for rows, d in ((64, 4096), (64, 2048), (2048, 128), (512, 128), (8192, 4096)):
            res = rmsnorm_case(rows, d, dtype, residual=False, iters=50)
            results[("rmsnorm", rows, d, res["dtype"])] = res
        # the families phase's widths: a hymba request (4 x 16 rows of
        # 1600) and prefill, musicgen's and qwen2-vl's prefill rows
        for rows, d in ((64, 1600), (HYMBA_PROMPT, 1600), (MUSICGEN_PROMPT, 1536),
                        (QWEN2_VL_PROMPT, 8192)):
            res = rmsnorm_case(rows, d, dtype, residual=False, iters=50)
            results[("rmsnorm", rows, d, res["dtype"])] = res
        # the tp phase's qk-norm rows: qwen3-8b's local 16 heads at (1, 4096)
        res = rmsnorm_case(TP_TRAIN_SEQ * 16, 128, dtype, residual=False, iters=50)
        results[("rmsnorm", TP_TRAIN_SEQ * 16, 128, res["dtype"])] = res
        for rows, d in ((64, 4096), (8192, 4096)):
            res = rmsnorm_case(rows, d, dtype, residual=True, iters=50)
            results[("rmsnorm_residual", rows, d, res["dtype"])] = res
    cases = [
        # serve prompt (4, 16): qwen3-8b, gemma-2b
        dict(b=4, sq=16, sk=16, hq=32, hkv=8, d=128, dtype=bf16, iters=50),
        dict(b=4, sq=16, sk=16, hq=8, hkv=1, d=256, dtype=bf16, iters=50),
        # prefill of 2048 tokens: qwen3-8b, gemma-2b
        dict(b=1, sq=2048, sk=2048, hq=32, hkv=8, d=128, dtype=bf16, iters=5),
        dict(b=1, sq=2048, sk=2048, hq=8, hkv=1, d=256, dtype=bf16, iters=5),
        # the parity phase's prompt, fp32 at the JAX tests' 2e-5
        dict(b=1, sq=512, sk=512, hq=32, hkv=8, d=128, dtype=f32, iters=5),
        # sliding window, and a query suffix at an offset
        dict(b=1, sq=1024, sk=1024, hq=8, hkv=2, d=128, dtype=bf16, window=256, iters=10),
        # mixtral-8x22b's prefill: 48/8 heads of 128, its window of 4096
        # at the moe phase's (1, 6144) prompt
        dict(b=1, sq=MOE_PARITY_PROMPT, sk=MOE_PARITY_PROMPT, hq=48, hkv=8, d=128, dtype=bf16,
             window=4096, iters=5),
        dict(b=1, sq=512, sk=1024, hq=8, hkv=2, d=128, dtype=bf16, q_offset=512, iters=10),
        # the families phase: hymba's 25/5 heads of 64 under its window of
        # 1024 at the serve prompt and the parity prompt; musicgen's 24
        # full heads of 64; qwen2-vl's 64/8 heads of 128
        dict(b=4, sq=16, sk=16, hq=25, hkv=5, d=64, dtype=bf16, window=1024, iters=50),
        dict(b=1, sq=HYMBA_PROMPT, sk=HYMBA_PROMPT, hq=25, hkv=5, d=64, dtype=bf16,
             window=1024, iters=10),
        dict(b=1, sq=MUSICGEN_PROMPT, sk=MUSICGEN_PROMPT, hq=24, hkv=24, d=64, dtype=bf16,
             iters=10),
        dict(b=1, sq=QWEN2_VL_PROMPT, sk=QWEN2_VL_PROMPT, hq=64, hkv=8, d=128, dtype=bf16,
             iters=10),
        # the tp phase's heads on a model axis of 2: qwen3-8b's local 16/4
        # (its serve prompt and its fp32 prefill), mixtral-8x22b's local
        # 24/4 under its window, hymba's 25/5, which stay whole
        *TP_FLASH_CASES,
    ]
    for c in cases:
        res = flash_case(**c)
        s = res["shape"]
        results[("flash_attention", s["b"], s["sq"], s["hq"], s["d"], s["window"],
                 s["q_offset"], res["dtype"])] = res
    # decode: one query a sequence against 4096 and 32768 cached keys, at
    # the decode phase's bf16-cache batches (qwen3-8b 8, gemma-2b 64)
    for b, hq, hkv, d in ((8, 32, 8, 128), (64, 8, 1, 256)):
        for sk in (4096, 32768):
            res = flash_decode_case(b, sk, hq, hkv, d, iters=10)
            results[("flash_decode", b, sk, hq, d)] = res
    # hymba's decode step at DECODE_32K: its full ring of 1024, five query
    # rows a kv head
    res = flash_decode_case(HYMBA_DECODE_BATCH, 1024, 25, 5, 64, iters=10)
    results[("flash_decode", HYMBA_DECODE_BATCH, 1024, 25, 64)] = res
    # a decode step of qwen3-8b's local 16/4 heads (the tp phase's split)
    results[("flash_decode", 8, 4096, 16, 128)] = flash_decode_case(8, 4096, 16, 4, 128, iters=10)
    wkv_cases = [
        # rwkv6-7b's serve prompt (4, 16), 64 heads of 64: the serve chunk
        # of 8 and a chunk of 16
        dict(b=4, s=16, h=64, d=64, chunk=8, regime="slow", iters=50, plain_iters=10),
        dict(b=4, s=16, h=64, d=64, chunk=16, regime="slow", iters=50, plain_iters=10),
        # the parity phase's prompt, and a 2048-token prefill
        dict(b=1, s=512, h=64, d=64, chunk=64, regime="slow"),
        dict(b=1, s=2048, h=64, d=64, chunk=64, regime="slow", iters=5, plain_iters=1),
        # fast decays: finite, and on the oracle
        dict(b=1, s=512, h=64, d=64, chunk=64, regime="fast"),
        dict(b=1, s=512, h=64, d=64, chunk=64, regime="faster"),
        # a decode step: one token from a carried state, rwkv6-7b's 64
        # heads at the decode batch of 128
        dict(b=128, s=1, h=64, d=64, chunk=1, regime="slow", iters=50, plain_iters=10,
             carried=True),
        # the tp phase's prefill: rwkv6-7b's local 32 of 64 heads
        dict(b=1, s=TP_PREFILL, h=32, d=64, chunk=64, regime="slow"),
    ]
    for c in wkv_cases:
        res = wkv6_case(**c)
        s = res["shape"]
        results[("wkv6", s["b"], s["s"], s["h"], s["chunk"], s["decay"])] = res
    # the WKV6 backward (B3) at rwkv6-7b's 64 heads of 64: the serve prompt,
    # the parity and prefill prompts, a TRAIN_4K microbatch, and a ragged
    # length from a state with the final state's cotangent (the backward
    # takes no chunk argument: its chunks are 32 steps), in all three
    # regimes; first, the blocks each of its kernels keeps resident an SM
    emit({"phase": "kernels", "kernel": "wkv6_bwd", "blocks_an_sm": wkv6_bwd_occupancy(64, 64)})
    for regime in DECAY_REGIMES:
        for c in (dict(b=4, s=16, iters=50), dict(b=1, s=512), dict(b=1, s=2048, iters=5),
                  dict(b=1, s=4096, iters=3), dict(b=1, s=100, carried=True)):
            res = wkv6_bwd_case(h=64, d=64, regime=regime, **c)
            results[("wkv6_bwd", c["b"], c["s"], regime)] = res
    # backward kernels at the training shapes: gemma-2b's norm rows (one
    # 4096-token microbatch), qwen3-8b's q-norm rows at (1, 4096), and a
    # large fp32 case
    # and the tp phase's: qwen3-8b's q-norm rows of its local 16 heads at
    # (1, 4096), fp32
    for rows, d, dtype in ((4096, 2048, bf16), (131072, 128, bf16), (8192, 4096, f32),
                           (TP_TRAIN_SEQ * 16, 128, f32)):
        res = rmsnorm_bwd_case(rows, d, dtype, iters=20)
        results[("rmsnorm_bwd", rows, d, res["dtype"])] = res
    bwd_cases = [
        # (1, 4096): gemma-2b's 8/1 heads of 256, qwen3-8b's 32/8 of 128
        dict(b=1, sq=4096, sk=4096, hq=8, hkv=1, d=256, dtype=bf16, iters=3),
        dict(b=1, sq=4096, sk=4096, hq=32, hkv=8, d=128, dtype=bf16, iters=3),
        dict(b=1, sq=512, sk=512, hq=32, hkv=8, d=128, dtype=f32, iters=3),
        # fp32 (3xTF32) at the training shapes: gemma-2b's (train_parity's)
        # and qwen3-8b's heads
        dict(b=1, sq=4096, sk=4096, hq=8, hkv=1, d=256, dtype=f32, iters=3),
        dict(b=1, sq=4096, sk=4096, hq=32, hkv=8, d=128, dtype=f32, iters=3),
        dict(b=1, sq=1024, sk=1024, hq=8, hkv=2, d=128, dtype=bf16, window=256),
        dict(b=1, sq=512, sk=1024, hq=8, hkv=2, d=128, dtype=bf16, q_offset=512),
        dict(b=2, sq=256, sk=256, hq=4, hkv=2, d=16, dtype=f32),
        dict(b=1, sq=256, sk=256, hq=4, hkv=1, d=32, dtype=bf16),
        # the tp phase's step: qwen3-8b's local 16/4 heads at (1, 4096), fp32
        dict(b=1, sq=TP_TRAIN_SEQ, sk=TP_TRAIN_SEQ, hq=16, hkv=4, d=128, dtype=f32, iters=3),
    ]
    # the families_train phase's shapes, bf16 (its sessions' compute): K1
    # and B1 at its norm rows, K3 and B2 at its heads
    for rows, d in FAMILIES_TRAIN_NORMS:
        res = rmsnorm_case(rows, d, bf16, residual=False, iters=20)
        results[("rmsnorm", rows, d, res["dtype"])] = res
        res = rmsnorm_bwd_case(rows, d, bf16, iters=20)
        results[("rmsnorm_bwd", rows, d, res["dtype"])] = res
    bwd_cases += [dict(c, dtype=bf16, iters=3) for c in FAMILIES_TRAIN_FLASH]
    # K3: mixtral's window binds only at the (1, 6144) case above; at 4096
    # it is the causal mask (whose control a tile narrower is blind)
    for c in FAMILIES_TRAIN_FLASH[:3] + FAMILIES_TRAIN_FLASH[5:]:
        res = flash_case(**c, dtype=bf16, iters=5)
        s = res["shape"]
        results[("flash_attention", s["b"], s["sq"], s["hq"], s["d"], s["window"],
                 s["q_offset"], res["dtype"])] = res
    for c in bwd_cases:
        res = flash_bwd_case(**c)
        s = res["shape"]
        results[("flash_attention_bwd", s["b"], s["sq"], s["hq"], s["d"], s["window"],
                 s["q_offset"], res["dtype"])] = res
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3: serve at full width
# ---------------------------------------------------------------------------


def launches_per_request(cfg) -> dict:
    """Kernel launches of one prefill. Dense: attn + mlp norm per layer,
    q/k norm per layer when the arch has qk-norm, the final norm; one
    attention per layer. rwkv: the two norms per layer and the final norm;
    one WKV6 scan per layer."""
    if cfg.family == "ssm":
        return {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": 0, "wkv6": cfg.n_layers}
    norms = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    return {"rmsnorm": norms, "flash_attention": cfg.n_layers, "wkv6": 0}


# profiler kernel names -> kinds, first match wins (the backward names
# first: they share prefixes with the forward ones)
KERNEL_KINDS = (
    ("rmsnorm_bwd", ("rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel")),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("wkv6_bwd", WKV_BWD_KERNELS),
    ("wkv6", ("wkv6_fwd_kernel",)),
    ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
)


# decode: dtype conversions and strided copies (PyTorch's copy kernels:
# the int8 cache's dequantization, the slot writes) as a kind of their own
DECODE_KERNEL_KINDS = (("cast", ("copy_kernel",)),) + KERNEL_KINDS

# MoE: the casts, and the dispatch (routing's sort, the slot tables'
# histogram, scan and scatters, the gathers in and out of the expert
# blocks) apart from the expert GEMMs
MOE_KERNEL_KINDS = DECODE_KERNEL_KINDS[:-1] + (
    ("dispatch", ("sort", "scatter", "gather", "index", "histogram", "scan", "where")),
) + DECODE_KERNEL_KINDS[-1:]


def device_time_by_kind(averages, kinds=KERNEL_KINDS):
    """Device milliseconds and kernel counts by kind from a profiler run's
    ``key_averages()`` (kinds with no kernel stay at 0), and the total
    kernel count. A span's own device-side record (``SSM_SPANS``) is no
    kernel and is skipped."""
    groups = {kind: 0.0 for kind, _ in kinds}
    groups["other"] = 0.0
    counts = dict.fromkeys(groups, 0)
    n_kernels = 0
    for evt in averages:
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key in SSM_SPANS.values():
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key.lower()
        key = next((kind for kind, marks in kinds if any(m in name for m in marks)), "other")
        groups[key] += us / 1e3
        counts[key] += evt.count
        n_kernels += evt.count
    return groups, counts, n_kernels


def profile_request(sess, kinds=KERNEL_KINDS) -> dict:
    """One more request of a served session under ``torch.profiler``: wall
    time, the device time of its kernels grouped by kind, and the device's
    busy share of the wall time. Runs after the launch counts are read, so
    it adds nothing to them."""
    batch = sess.data_fn(0)
    sess.step_fn(sess.state, batch)
    sync()
    return profiled(lambda: sess.step_fn(sess.state, batch), kinds)


@contextlib.contextmanager
def ssm_spans():
    """Around a run: each call of the SSM branch (``ssm.ssm_apply``,
    ``ssm.ssm_decode``) and of its scan (``ssm_scan_chunked``,
    ``ssm_scan_ref``) inside a ``torch.profiler.record_function`` span
    named by ``SSM_SPANS`` (the outermost call only, so the scan's
    fallback to its oracle is one span). It wraps the module's functions,
    which the blocks and ``ssm_apply`` call through the module."""
    from torch.profiler import record_function

    from repro_torch.models import ssm

    saved = {name: getattr(ssm, name) for name in SSM_SPANS}
    open_spans = dict.fromkeys(SSM_SPANS.values(), 0)

    def wrap(fn, span):
        def spanned(*args, **kw):
            if open_spans[span]:
                return fn(*args, **kw)
            open_spans[span] += 1
            try:
                with record_function(span):
                    return fn(*args, **kw)
            finally:
                open_spans[span] -= 1
        return spanned

    for name, span in SSM_SPANS.items():
        setattr(ssm, name, wrap(saved[name], span))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ssm, name, fn)


def span_device_ms(averages) -> dict:
    """Device milliseconds of the kernels launched inside each SSM span
    (the span's host-side event, its children's kernels included), from a
    profiler run's ``key_averages()``."""
    out = dict.fromkeys(SSM_SPANS.values(), 0.0)
    for evt in averages:
        if evt.key in out and evt.device_type == torch.autograd.DeviceType.CPU:
            us = getattr(evt, "device_time_total", None)
            out[evt.key] += (evt.cuda_time_total if us is None else us) / 1e3
    return out


def profiled(fn, kinds=KERNEL_KINDS, cpu: bool = True) -> dict:
    """``fn()`` once under ``torch.profiler``, synchronised: wall time, the
    device time of its kernels grouped by ``kinds``, the device's busy
    share of the wall time and the kernels with the most device time;
    with ``cpu`` (host events recorded too), for a hybrid model also the
    device time of the kernels its SSM branch and scan launch
    (``ssm_spans``), which fall in the "other" kind (elementwise) and
    "gemm" (projections). Without it the profiler records the device's
    kernels only: a training step of hymba dispatches ~0.5M host ops,
    whose events took the profiler minutes to gather."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof, ssm_spans():
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    groups, counts, n_kernels = device_time_by_kind(averages, kinds)
    device_ms = sum(groups.values())
    res = {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "device_ms_by_kind": groups,
        "launches_by_kind": counts,
        "device_us_per_launch": {k: 1e3 * groups[k] / counts[k] for k in groups if counts[k]},
        "kernels_launched": n_kernels,
    }
    res["top_kernels"] = top_kernels(averages)
    spans = span_device_ms(averages)
    if any(spans.values()):
        res["span_device_ms"] = spans
        res["span_share_of_device_ms"] = {k: v / device_ms for k, v in spans.items()}
    return res


def phase_serve(archs=SERVE_ARCHS, configs=None, kinds=KERNEL_KINDS) -> dict:
    """``repro_torch.launch.serve`` with ``archs`` at full width on one
    ``SalusExecutor`` under PRIORITY; ``configs`` maps a service to the
    config it serves in place of the registry's (a depth cut), ``kinds``
    groups the profiled request's kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rms_ops
    from repro_torch.kernels.rwkv_scan import ops as wkv_ops
    from repro_torch.launch import serve

    # 68.1 GiB of fp32 params for the three default services, each
    # request's ephemeral memory on top; the card holds ~79 GiB
    argv = [
        "--archs", ",".join(archs), "--no-smoke", "--device", "cuda",
        "--capacity-gb", "76", "--rps", "4", "--duration", "3", "--requests", "4",
        "--policy", "priority", "--seed", "0",
    ]
    configs = configs or {}
    config_of = lambda name: configs.get(name) or get_config(name)  # noqa: E731
    counters = {"rmsnorm": rms_ops.rmsnorm, "flash_attention": fa_ops.flash_attention,
                "wkv6": wkv_ops.wkv6}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    report, ex = serve.serve(serve.build_parser().parse_args(argv), configs)
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check(not report.failures, f"serve failures: {report.failures}")
    expected = {name: 0 for name in counters}
    services = {}
    for jid, st in report.stats.items():
        sess = ex.sessions[jid]
        job = sess.job
        cfg = config_of(job.name)
        check(st.iterations_done == sess.n_iters,
              f"{job.name}: served {st.iterations_done} of {sess.n_iters} requests")
        for m in sess.metrics_log:
            tok = m["next_token"]
            check(tok.shape == (serve.PROMPT_SHAPE[0],), f"{job.name}: token shape {tok.shape}")
            check(bool(((tok >= 0) & (tok < cfg.vocab_size)).all().item()),
                  f"{job.name}: token out of range")
        # one profiling step at session creation plus one prefill a request
        per = launches_per_request(cfg)
        for name in expected:
            expected[name] += per[name] * (st.iterations_done + 1)
        services[job.name] = {
            "n_layers": cfg.n_layers,
            "d_model": cfg.d_model,
            "requests": st.iterations_done,
            "latency_ms": [x * 1e3 for x in st.request_latencies],
            "p50_ms": st.p50_latency * 1e3,
            "p99_ms": st.p99_latency * 1e3,
            "profile_gb": {"persistent": job.profile.persistent / 2**30,
                           "ephemeral": job.profile.ephemeral / 2**30},
            "launches_per_request": per,
        }
    check(set(services) == set(archs), f"served {sorted(services)}, not {archs}")
    check(launches == expected, f"launch counts {launches} != expected {expected}")
    for jid in report.stats:
        sess = ex.sessions[jid]
        prof = profile_request(sess, kinds)
        services[sess.job.name]["profiled_request"] = prof
        # the profiler's grouping caught each of the path's kernels
        per = launches_per_request(config_of(sess.job.name))
        for name in ("rmsnorm", "flash_attention", "wkv6"):
            if per[name]:
                check(prof["device_ms_by_kind"][name] > 0,
                      f"{sess.job.name}: no {name} device time in the profiled request")
    res = {
        "phase": "serve",
        "wall_s": wall_s,
        "services": services,
        "launches": launches,
        "expected_launches": expected,
        "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(res)
    del report, ex, sess, job
    gc.collect()
    torch.cuda.empty_cache()
    return res


def kernels_line(k: dict, serve_res: dict, train_res: dict, decode_res: dict,
                 moe_res: dict, families_res: dict, fleet_res: dict, ckpt_res: dict,
                 cli_res: dict, tp_res: dict, rwkv_res: dict, fam_train: dict) -> None:
    """The summary line: each kernel the serve and train paths launch. The
    forward kernels at their largest serve-path shape (bf16 for the norm
    and attention, whose largest is qwen3-8b's; fp32 for WKV6, rwkv6-7b's
    prompt at the serve chunk), with the serve path's count; beside it,
    the norm at (8192, 4096) and attention at (1, 2048) for qwen3-8b's and
    gemma-2b's heads. The backward kernels (no TPU counterpart: the JAX
    package trains through jnp) at the training path's shapes, gemma-2b's
    norm rows and heads at (1, 4096), with the train path's count; the
    attention backward's fp32 route (3xTF32, the train_parity phase's) at
    gemma-2b's and qwen3-8b's heads at (1, 4096) and at the (1, 512)
    parity prompt. The decode phase's timed launches beside them, with K3
    at one query against 4096 and 32768 cached keys (qwen3-8b's and
    gemma-2b's heads, both forms) and K4 at one token from a carried
    state. K3 also at mixtral-8x22b's windowed prefill (``at_moe``), with
    the moe phase's serve launches. The families phase's shapes
    (``at_families``): K1 at widths 1600 (hymba), 1536 (musicgen) and
    8192 (qwen2-vl), K3 at hymba's 25/5 heads of 64 under its window (its
    serve prompt, (1, 2560), and one query against its ring at batch
    128), musicgen's 24/24 and qwen2-vl's 64/8 heads, with the families
    serve run's launches and a hymba request's. The fleet phase's launches
    of K1 and K3, a run each (``launches_fleet``), the ckpt phase's of
    every kernel, a run each (``launches_ckpt``), and the cli phase's, a
    run each (``launches_cli``: the full-depth CLI runs, the resume's A,
    B and C, each example). The tp phase's local-head shapes and each
    rank's launches there (``at_tp``: its serve, prefill and train runs).
    The WKV6 backward (B3) at a (1, 4096) training microbatch with the
    rwkv_train phase's launches (K4's there beside it), and at its other
    shapes and regimes (``at``). K1, B1, K3 and B2 at the families_train
    phase's shapes, with its launches a step of each arch
    (``at_families_train``)."""
    rms = k[("rmsnorm", 64, 4096, "bfloat16")]
    rms_res = k[("rmsnorm_residual", 64, 4096, "bfloat16")]
    fa = k[("flash_attention", 4, 16, 32, 128, None, 0, "bfloat16")]
    wkv = k[("wkv6", 4, 16, 64, 8, "slow")]
    rms_bwd = k[("rmsnorm_bwd", 4096, 2048, "bfloat16")]
    fa_bwd = k[("flash_attention_bwd", 1, 4096, 8, 256, None, 0, "bfloat16")]
    fa_moe = k[("flash_attention", 1, MOE_PARITY_PROMPT, 48, 128, 4096, 0, "bfloat16")]
    wkv_bwd = k[("wkv6_bwd", 1, 4096, "slow")]
    rwkv_steps, rwkv_entry = rwkv_res["steps"], rwkv_res["entry_points"]
    keys = ("max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def at(res):
        return {"shape": res["shape"], **{x: res[x] for x in keys}}

    train = train_res["launches"]
    per_step = train_res["launches_per_step"]
    moe_serve = moe_res["serve"]
    fam_serve = families_res["serve"]
    hymba_per = fam_serve["services"][HYMBA_ARCH]["launches_per_request"]
    fam_norms = [at(k[("rmsnorm", rows, d, "bfloat16")]) for rows, d in (
        (64, 1600), (HYMBA_PROMPT, 1600), (MUSICGEN_PROMPT, 1536), (QWEN2_VL_PROMPT, 8192))]
    fam_flash = [at(k[("flash_attention", b, s, hq, d, w, 0, "bfloat16")]) for b, s, hq, d, w in (
        (4, 16, 25, 64, 1024), (1, HYMBA_PROMPT, 25, 64, 1024), (1, MUSICGEN_PROMPT, 24, 64, None),
        (1, QWEN2_VL_PROMPT, 64, 128, None))]
    hymba_decode = k[("flash_decode", HYMBA_DECODE_BATCH, 1024, 25, 64)]
    fam_flash.append({**at(hymba_decode), **{x: hymba_decode[x] for x in (
        "ms_by_form", "rel_fro_by_form", "control_rel_fro")}})
    decode = decode_res["launches"]
    ckpt = lambda name: {run: n[name] for run, n in ckpt_res["launches"].items()}
    cli_runs = {**{f"full_depth_{r}": v for r, v in cli_res["full_depth"].items()},
                **{f"resume_{r}": cli_res["resume"][r] for r in "ABC"},
                **{f"example_{r}": v for r, v in cli_res["examples"].items()}}
    cli = lambda name: {run: v["launches"][name] for run, v in cli_runs.items()}
    fa_decode = [{**at(k[("flash_decode", b, sk, hq, d)]),
                  **{x: k[("flash_decode", b, sk, hq, d)][x]
                     for x in ("ms_by_form", "rel_fro_by_form", "control_rel_fro")}}
                 for b, hq, d in ((8, 32, 128), (64, 8, 256)) for sk in (4096, 32768)]
    def at_tp(name: str, shapes: list) -> dict:
        runs = lambda r: {"serve": r["serve"]["launches"][name],  # noqa: E731
                          **{f["arch"]: f["launches"][name] for f in r["families"]},
                          "train": r["train"]["launches"][name]}
        return {"shapes": [at(x) for x in shapes],
                "launches_by_rank": [runs(r) for r in tp_res["ranks"]]}

    tp_flash = [k[("flash_attention", c["b"], c["sq"], c["hq"], c["d"], c.get("window"), 0,
                   str(c["dtype"]).removeprefix("torch."))] for c in TP_FLASH_CASES]
    tp_flash.append(k[("flash_decode", 8, 4096, 16, 128)])
    tp_rows = TP_TRAIN_SEQ * 16

    def at_fam_train(name: str) -> dict:
        if name.startswith("rmsnorm"):
            shapes = [at(k[(name, rows, d, "bfloat16")]) for rows, d in FAMILIES_TRAIN_NORMS]
        else:
            cases = [(name, c["b"], c["sq"], c["hq"], c["d"], c.get("window"), 0, "bfloat16")
                     for c in FAMILIES_TRAIN_FLASH]
            shapes = [at(k[c]) for c in cases if c in k]  # K3 at 4096 under w 4096: none
        return {"shapes": shapes,
                "launches_a_step": {a: r["launches_per_step"][name]
                                    for a, r in fam_train["steps"].items()},
                "launches": {a: r["launches"][name] for a, r in fam_train["steps"].items()}}

    emit({"kernels": [
        {"name": "rmsnorm", "route": "cuda", "source": RMS_SRC,
         "replaces": RMS_TPU, "also_replaces": RMS_RES_TPU,
         "launches": serve_res["launches"]["rmsnorm"], "shape": rms["shape"],
         "dtype": "bfloat16", **{x: rms[x] for x in keys},
         "residual_form": {x: rms_res[x] for x in keys},
         "launches_train": train["rmsnorm"], "launches_a_train_step": per_step["rmsnorm"],
         "launches_decode": decode["rmsnorm"],
         "at_prefill": [at(k[("rmsnorm", 8192, 4096, "bfloat16")]),
                        {"residual_form": True,
                         **at(k[("rmsnorm_residual", 8192, 4096, "bfloat16")])}],
         "at_families": {"shapes": fam_norms,
                         "launches_families_serve": fam_serve["launches"]["rmsnorm"],
                         "launches_a_hymba_request": hymba_per["rmsnorm"]},
         "launches_fleet": {run: n["rmsnorm"] for run, n in fleet_res["launches"].items()},
         "launches_ckpt": ckpt("rmsnorm"),
         "launches_cli": cli("rmsnorm"),
         "at_tp": at_tp("rmsnorm", [k[("rmsnorm", tp_rows, 128, "float32")]]),
         "at_families_train": at_fam_train("rmsnorm")},
        {"name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
         "replaces": FLASH_TPU,
         "launches": serve_res["launches"]["flash_attention"], "shape": fa["shape"],
         "dtype": "bfloat16", **{x: fa[x] for x in keys},
         "launches_train": train["flash_attention"],
         "launches_a_train_step": per_step["flash_attention"],
         "launches_decode": decode["flash_attention"],
         "at_prefill": [at(k[("flash_attention", 1, 2048, 32, 128, None, 0, "bfloat16")]),
                        at(k[("flash_attention", 1, 2048, 8, 256, None, 0, "bfloat16")])],
         "at_decode": fa_decode,
         "at_moe": {**at(fa_moe), **{x: fa_moe[x] for x in ("rel_fro", "control_rel_fro")},
                    "launches_moe_serve": moe_serve["launches"]["flash_attention"],
                    "launches_a_mixtral_request":
                        moe_serve["services"][MOE_ARCH]["launches_per_request"]["flash_attention"]},
         "at_families": {"shapes": fam_flash,
                         "launches_families_serve": fam_serve["launches"]["flash_attention"],
                         "launches_a_hymba_request": hymba_per["flash_attention"]},
         "launches_fleet": {run: n["flash_attention"]
                            for run, n in fleet_res["launches"].items()},
         "launches_ckpt": ckpt("flash_attention"),
         "launches_cli": cli("flash_attention"),
         "at_tp": at_tp("flash_attention", tp_flash),
         "at_families_train": at_fam_train("flash_attention")},
        {"name": "wkv6", "route": "cuda", "source": WKV_SRC, "replaces": WKV_TPU,
         "launches": serve_res["launches"]["wkv6"], "shape": wkv["shape"],
         "dtype": "float32", **{x: wkv[x] for x in keys},
         "plain_chunked_ms": wkv["plain_chunked_ms"],
         "launches_decode": decode["wkv6"], "at_decode": at(k[("wkv6", 128, 1, 64, 1, "slow")]),
         "launches_ckpt": ckpt("wkv6"),
         "launches_cli": cli("wkv6"),
         "at_tp": at_tp("wkv6", [k[("wkv6", 1, TP_PREFILL, 32, 64, "slow")]]),
         "launches_rwkv_train": rwkv_steps["launches"]["wkv6"],
         "launches_a_rwkv_train_step": rwkv_steps["launches_per_step"]["wkv6"]},
        {"name": "wkv6_bwd", "route": "cuda", "source": WKV_BWD_SRC, "replaces": WKV_TPU,
         "backward_of": "wkv6 (K4); no TPU counterpart",
         "launches": rwkv_steps["launches"]["wkv6_bwd"],
         "launches_a_train_step": rwkv_steps["launches_per_step"]["wkv6_bwd"],
         "shape": wkv_bwd["shape"], "dtype": "float32", **{x: wkv_bwd[x] for x in keys},
         "rel_fro": wkv_bwd["rel_fro"], "plain_fp32_vs_fp64": wkv_bwd["plain_fp32_vs_fp64"],
         "at": [{**at(v), "rel_fro": v["rel_fro"]} for key, v in k.items()
                if key[0] == "wkv6_bwd" and v is not wkv_bwd],
         "launches_rwkv_entry_points": {n: r["launches"]["wkv6_bwd"]
                                        for n, r in rwkv_entry.items()}},
        {"name": "rmsnorm_bwd", "route": "cuda", "source": RMS_SRC, "replaces": RMS_TPU,
         "backward_of": "rmsnorm (K1); no TPU counterpart",
         "launches": train["rmsnorm_bwd"], "launches_a_train_step": per_step["rmsnorm_bwd"],
         "shape": rms_bwd["shape"], "dtype": "bfloat16", **{x: rms_bwd[x] for x in keys},
         "at_qk_norm": at(k[("rmsnorm_bwd", 131072, 128, "bfloat16")]),
         "launches_ckpt": ckpt("rmsnorm_bwd"),
         "launches_cli": cli("rmsnorm_bwd"),
         "at_tp": at_tp("rmsnorm_bwd", [k[("rmsnorm_bwd", tp_rows, 128, "float32")]]),
         "at_families_train": at_fam_train("rmsnorm_bwd")},
        {"name": "flash_attention_bwd", "route": "cuda", "source": FLASH_BWD_SRC,
         "replaces": FLASH_TPU, "backward_of": "flash_attention (K3); no TPU counterpart",
         "launches": train["flash_attention_bwd"],
         "launches_a_train_step": per_step["flash_attention_bwd"],
         "kernel_route": fa_bwd["route"],
         "shape": fa_bwd["shape"], "dtype": "bfloat16", **{x: fa_bwd[x] for x in keys},
         "at_qwen3_heads": at(k[("flash_attention_bwd", 1, 4096, 32, 128, None, 0, "bfloat16")]),
         "fp32_route": {
             "kernel_route": k[("flash_attention_bwd", 1, 4096, 8, 256, None, 0, "float32")]["route"],
             "at": [at(k[("flash_attention_bwd", 1, s, hq, d, None, 0, "float32")])
                    for s, hq, d in ((4096, 8, 256), (4096, 32, 128), (512, 32, 128))]},
         "launches_ckpt": ckpt("flash_attention_bwd"),
         "launches_cli": cli("flash_attention_bwd"),
         "at_tp": at_tp("flash_attention_bwd", [k[("flash_attention_bwd", 1, TP_TRAIN_SEQ, 16, 128,
                                                   None, 0, "float32")]]),
         "at_families_train": at_fam_train("flash_attention_bwd")},
    ]})


# ---------------------------------------------------------------------------
# phase 4: full-depth model parity, kernels against plain versions
# ---------------------------------------------------------------------------


class Routing(NamedTuple):
    """One MoE group block's routing: ``experts`` (groups, group size, k)
    int32, and each expert's ``capacity`` a group of ``n_experts``."""

    experts: torch.Tensor
    n_experts: int
    capacity: int


@contextlib.contextmanager
def moe_trace(replay=None):
    """Around a run: the routing of every MoE group block it runs recorded
    (yielded: a list of ``Routing``, in order), and, when ``replay`` (such
    a log of the same computation) is given, its experts handed back in
    order in place of the top-k, the gates renormalised from the block's
    own probabilities: two numerics can then be held against each other on
    one routing. It wraps ``moe.route`` and ``moe._dispatch_indices``,
    which ``moe_apply`` calls through the module; a replayed block
    that does not fit raises."""
    from repro_torch.models import moe

    log, replayed, current = [], None if replay is None else iter(replay), []
    route, dispatch = moe.route, moe._dispatch_indices

    def traced_route(router_w, x, top_k):
        gate_vals, expert_idx, probs = route(router_w, x, top_k)
        if replayed is not None:
            r = next(replayed, None)
            if r is None or r.experts.shape != expert_idx.shape or r.n_experts != probs.shape[-1]:
                raise RuntimeError("moe_trace: the replayed routing does not fit this block")
            current[:] = [r]
            expert_idx = r.experts
            gate_vals = probs.gather(-1, expert_idx.long())
            gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
        return gate_vals, expert_idx, probs

    def traced_dispatch(expert_idx, n_experts, capacity, base=None):
        if current and current.pop().capacity != capacity:
            raise RuntimeError("moe_trace: the replayed routing's capacity differs")
        log.append(Routing(expert_idx, n_experts, capacity))
        return dispatch(expert_idx, n_experts, capacity, base)

    moe.route, moe._dispatch_indices = traced_route, traced_dispatch
    try:
        yield log
    finally:
        moe.route, moe._dispatch_indices = route, dispatch


def dropped(log: list) -> int:
    """Assignments past their expert's capacity in a routing log: what
    the dispatch dropped (one host read)."""
    parts = []
    for r in log:
        flat = r.experts.reshape(r.experts.shape[0], -1).long()  # a row a group
        base = r.n_experts * torch.arange(flat.shape[0], device=flat.device)[:, None]
        counts = torch.bincount((flat + base).reshape(-1), minlength=flat.shape[0] * r.n_experts)
        parts.append((counts - r.capacity).clamp(min=0).sum())
    return int(torch.stack(parts).sum()) if parts else 0


def flipped_tokens(a: list, b: list) -> list:
    """Tokens sent to another set of experts, group block by group block,
    between two routing logs of the same computation."""
    sets = lambda r: r.experts.sort(-1).values  # noqa: E731
    return [int((sets(x) != sets(y)).any(-1).sum().item()) for x, y in zip(a, b)]


def grid_positions(b: int, s: int, n_patches: int, grid_w: int = PATCH_GRID_WIDTH,
                   device=None) -> torch.Tensor:
    """(b, 3, s) int32 M-RoPE ids: ``n_patches`` patches on a grid
    ``grid_w`` wide (t 0, h ``i // grid_w``, w ``i % grid_w``), then text
    at ``max + 1 + j`` on all three axes (the first ``s`` of them). The
    three axes differ, so a wrong section split shows (equal ids make
    M-RoPE plain RoPE)."""
    i = torch.arange(n_patches, device=device)
    patches = torch.stack([torch.zeros_like(i), i // grid_w, i % grid_w])
    text = (patches.max() + 1 + torch.arange(max(s - n_patches, 0), device=device)).expand(3, -1)
    return torch.cat([patches, text], dim=1)[:, :s].expand(b, 3, s).int().contiguous()


def model_inputs(cfg, b: int, s: int, gen: torch.Generator) -> dict:
    """A (b, s) batch of ``cfg``'s frontend on ``gen``'s device: tokens
    (uniform over the vocabulary), or standard normal frame embeddings
    for audio; for vision also standard normal patch embeddings over the
    first ``n_frontend_tokens`` slots, and grid M-RoPE ids."""
    dev = gen.device
    if cfg.frontend == "audio_frames":
        out = {"frame_embeds": torch.randn(b, s, cfg.d_model, generator=gen, device=dev)}
    else:
        out = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = torch.randn(b, cfg.n_frontend_tokens, cfg.d_model, generator=gen,
                                          device=dev)
    if cfg.rope_variant == "mrope":
        out["positions"] = grid_positions(b, s, cfg.n_frontend_tokens, device=dev)
    return out


def steps(batch: dict, start: int, stop: int) -> dict:
    """Positions ``[start, stop)`` of a ``model_inputs`` batch; the patch
    embeddings go only with the first position (decode takes none)."""
    out = {}
    for name, t in batch.items():
        if name == "positions":
            out[name] = t[:, :, start:stop]
        elif name != "patch_embeds":
            out[name] = t[:, start:stop]
        elif start == 0:
            out[name] = t
    return out


def spread_decay(params, cfg) -> None:
    """rwkv: overwrite ``decay_base`` so that the decays span about
    0.15-0.99 across channels (the init's -6 gives w ~ 0.9975 everywhere,
    which barely exercises the chunk math)."""
    base = torch.linspace(math.log(-math.log(0.99)), math.log(-math.log(0.15)), cfg.d_model,
                          device="cuda")
    params["layers"]["tmix"]["decay_base"] = base.expand(cfg.n_layers, -1).contiguous()


def phase_parity(arch: str, seq: int = 512, cfg=None, **opts) -> dict:
    """One arch at full width and depth (or ``cfg``, a depth cut), one (1,
    seq) prompt: the kernels against the plain versions, in bf16 (the
    serving dtype) and in fp32, each also held against the plain fp32
    prefill; the logits and every cache leaf. ``opts`` are further
    ``ModelOptions``. MoE: in fp32 both paths run free and must route
    every token alike (so drop the same assignments); in bf16 a router
    near tie sends tokens to other experts in any two numerics, so the
    kernels and the plain fp32 yardstick replay the plain bf16 run's
    routing; a free-running bf16 kernel run is held by the tokens it
    sends to other experts than the plain bf16 run does, within
    MOE_FLIP_FACTOR times those the plain bf16 run sends apart from the
    plain fp32 run. Each run's dropped assignments are printed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rms_ops
    from repro_torch.kernels.rwkv_scan import ops as wkv_ops
    from repro_torch.models import ModelOptions, build_model

    cfg = cfg or get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = build_model(cfg).init(gen)
    if cfg.family == "ssm":
        spread_decay(params, cfg)
    batch = model_inputs(cfg, 1, seq, gen)
    counters = {"rmsnorm": rms_ops.rmsnorm, "flash_attention": fa_ops.flash_attention,
                "wkv6": wkv_ops.wkv6}

    drops, routes = {}, {}

    def prefill(label: str, kernel_mode: str, dtype: str, replay=None):
        model = build_model(cfg, ModelOptions(kernel_mode=kernel_mode, compute_dtype=dtype,
                                              **opts))
        sync()
        t0 = time.perf_counter()
        with moe_trace(replay) as log:
            logits, cache = model.prefill(params, batch)
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        drops[label], routes[label] = dropped(log), log
        return logits.float(), cache, ms

    prefill("warm-up", "kernel", "bfloat16")  # cuBLAS handles and workspaces
    r16, cache_r16, plain_ms = prefill("reference bfloat16", "reference", "bfloat16")
    same16 = routes["reference bfloat16"] if cfg.is_moe else None
    before = {name: fn.launches for name, fn in counters.items()}
    k16, cache_k16, kernel_ms = prefill("kernel bfloat16", "kernel", "bfloat16", same16)
    launched = {name: fn.launches - before[name] for name, fn in counters.items()}
    k32, cache_k32, kernel32_ms = prefill("kernel float32", "kernel", "float32")
    r32, cache_r32, plain32_ms = prefill("reference float32", "reference", "float32")
    # bf16's yardstick: the plain fp32 path on the plain bf16 run's routing
    y32 = prefill("reference float32, bf16 routing", "reference", "float32", same16)[0] \
        if cfg.is_moe else r32
    per = launches_per_request(cfg)
    check(launched == per, f"parity prefill launched {launched}, expected {per}")
    for name, t in (("kernel bf16", k16), ("kernel fp32", k32)):
        check(bool(torch.isfinite(t).all().item()), f"{name}: non-finite logits")
        check(t.shape == (1, cfg.vocab_size), f"{name}: logits shape {tuple(t.shape)}")
    # bf16 through the stack: the kernels round at other places than the
    # plain versions (attention rounds its probabilities to bf16 before
    # the running sum normalises them, where the plain path, as the JAX
    # oracle, rounds them after; the WKV kernel sums in another order), so the two
    # drift apart by the order of bf16's own rounding error through the
    # stack. That error is measured here as the plain bf16 path's distance
    # from the plain fp32 path; the kernels may differ from the plain path
    # by twice it, and must land no further than 1.25 times it from fp32.
    err_plain16 = max_err(r16, y32)
    err_kernel16 = max_err(k16, y32)
    diff16 = max_err(k16, r16)
    tol16 = 2.0 * err_plain16
    # fp32: the kernels do the plain versions' arithmetic in another order
    tol32 = 1e-3
    diff32 = max_err(k32, r32)
    top2 = torch.topk(r16, 2, dim=-1).values[0]
    # the plain logit of the kernels' choice below the plain max: the
    # argmaxes may differ only where the plain logits tie at the top within
    # one bf16 ulp (musicgen's plain top two were equal in bf16)
    gap16 = float(r16.max() - r16[0, k16.argmax()])
    ulp16 = bf16_ulp(float(r16.max()))
    tie16 = int(k16.argmax().item()) != int(r16.argmax().item()) and gap16 <= ulp16
    res = {
        "phase": "parity",
        "arch": cfg.name,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "prompt": [1, seq],
        "bf16": {
            "logits_max_abs_diff": diff16,
            "tol": tol16,
            "kernel_vs_fp32": err_kernel16,
            "plain_vs_fp32": err_plain16,
            "argmax_kernel": int(k16.argmax().item()),
            "argmax_plain": int(r16.argmax().item()),
            "plain_top2_gap": float(top2[0] - top2[1]),
            "plain_gap_at_kernel_argmax": gap16,
            "bf16_ulp_at_plain_max": ulp16,
            "plain_tie_at_top": tie16,
            "cache_max_abs_diff": {n: max_err(cache_k16[n], cache_r16[n]) for n in cache_k16},
        },
        "fp32": {
            "logits_max_abs_diff": diff32,
            "tol": f"{tol32} (1 + |plain|)",
            "argmax_kernel": int(k32.argmax().item()),
            "argmax_plain": int(r32.argmax().item()),
            "cache_max_abs_diff": {n: max_err(cache_k32[n], cache_r32[n]) for n in cache_k32},
            "cache_rel_fro": {n: rel_fro(cache_k32[n], cache_r32[n]) for n in cache_k32},
            "cache_tol": f"{tol32} relative Frobenius",
            "cache_worst": {n: worst_element(cache_k32[n], cache_r32[n]) for n in cache_k32},
        },
        "logits_std": r32.std().item(),
        "prefill_ms": {"kernel_bf16": kernel_ms, "plain_bf16": plain_ms,
                       "kernel_fp32": kernel32_ms, "plain_fp32": plain32_ms},
        "launches": launched,
    }
    if cfg.is_moe:
        free16 = prefill("kernel bfloat16, free-running", "kernel", "bfloat16")[0]
        res["bf16"]["routing"] = "the plain bf16 run's, replayed"
        res.update(
            options=opts, sliding_window=cfg.sliding_window, dropped_assignments=drops,
            fp32_flipped_tokens_a_route_call=flipped_tokens(routes["kernel float32"],
                                                            routes["reference float32"]),
            bf16_free_running={
                "flip_factor": MOE_FLIP_FACTOR,
                "logits_max_abs_diff_vs_plain_bf16": max_err(free16, r16),
                "argmax": int(free16.argmax().item()),
                "flipped_tokens_a_route_call": flipped_tokens(
                    routes["kernel bfloat16, free-running"], routes["reference bfloat16"]),
                "plain_bf16_vs_plain_fp32_flipped_tokens_a_route_call": flipped_tokens(
                    routes["reference bfloat16"], routes["reference float32"])})
    emit(res)
    if cfg.is_moe:
        check(not any(res["fp32_flipped_tokens_a_route_call"]),
              f"{cfg.name} fp32: the paths route tokens apart")
        check(drops["kernel float32"] == drops["reference float32"],
              f"{cfg.name} float32: dropped assignments {drops}")
        # bf16 as served, routing free: the kernels may send no more tokens
        # to other experts than twice bf16's own rounding does (the plain
        # bf16 path against the plain fp32 path), route call by route call
        free = res["bf16_free_running"]
        flips = free["flipped_tokens_a_route_call"]
        yardstick = free["plain_bf16_vs_plain_fp32_flipped_tokens_a_route_call"]
        check(all(f <= MOE_FLIP_FACTOR * y for f, y in zip(flips, yardstick)),
              f"{cfg.name} bf16 free-running: {flips} tokens flipped a route call, "
              f"more than {MOE_FLIP_FACTOR} x the plain bf16 path's {yardstick}")
    check(diff16 <= tol16, f"bf16 logits differ by {diff16} > {tol16}")
    check(err_kernel16 <= 1.25 * err_plain16,
          f"bf16 kernels {err_kernel16} from fp32, plain {err_plain16}")
    check(res["bf16"]["argmax_kernel"] == res["bf16"]["argmax_plain"] or tie16,
          f"bf16 argmax differs beyond a tie within one ulp: {res['bf16']}")
    check(within(k32, r32, tol32), f"fp32 logits differ by {diff32}")
    check(res["fp32"]["argmax_kernel"] == res["fp32"]["argmax_plain"], "fp32 argmax differs")
    # a cache leaf is held as a whole, ||kernel - plain|| / ||plain||: the
    # wkv state sums k v over the prompt in another order than the plain
    # path; ``cache_worst`` shows where the largest single gap sits
    for n in cache_k32:
        check(bool(torch.isfinite(cache_k16[n].float()).all().item()), f"bf16 cache {n} not finite")
        rel = res["fp32"]["cache_rel_fro"][n]
        check(rel <= tol32, f"fp32 cache {n}: relative Frobenius gap {rel} > {tol32}")
    del params, cache_k16, cache_r16, cache_k32, cache_r32
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: paging round trip
# ---------------------------------------------------------------------------


def phase_paging() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import MemoryConfig, SalusExecutor, VirtualDevice, get_policy
    from repro_torch.core.profiles import profile_step
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = replace(get_config("gemma-2b"), name="gemma-2b-depth2", n_layers=2)
    model = build_model(cfg)

    def handle(state, request):
        logits, _ = model.prefill(state, request)
        return state, {"next_token": torch.argmax(logits, dim=-1)}

    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=gen, device=dev)}
    data_fn = lambda i: prompt
    params_a = model.init(torch.Generator(device=dev).manual_seed(1))
    params_b = model.init(torch.Generator(device=dev).manual_seed(2))
    before = handle(params_a, prompt)[1]["next_token"].cpu()
    prof_a = profile_step(handle, params_a, prompt, dev)
    prof_b = profile_step(handle, params_b, prompt, dev)
    # both fit alone; together only with one's persistent state on host
    capacity = prof_a.persistent + prof_b.persistent + max(prof_a.ephemeral, prof_b.ephemeral) - 1
    ex = SalusExecutor(capacity, get_policy("fifo"), memory=MemoryConfig(paging=True), device=dev)
    vdev = VirtualDevice(ex)
    sess_a = vdev.create_session("A", handle, params_a, data_fn, n_iters=2, profile=prof_a)
    del params_a
    sync()
    mem_before = torch.cuda.memory_allocated()
    vdev.create_session("B", handle, params_b, data_fn, n_iters=2, profile=prof_b)
    del params_b
    sync()
    mem_after_out = torch.cuda.memory_allocated()
    report = vdev.run()
    kinds = [(kind, name) for kind, _o, name, _l in report.decision_log]
    check(("page_out", "A") in kinds and ("page_in", "A") in kinds,
          f"no page-out/page-in round trip of A: {kinds}")
    check(not report.failures, f"paging failures: {report.failures}")
    after = [m["next_token"].cpu() for m in sess_a.metrics_log]
    check(len(after) == 2 and all(torch.equal(t, before) for t in after),
          f"A's tokens changed over the round trip: {before} vs {after}")
    freed = mem_before - mem_after_out
    check(freed >= 0.99 * prof_a.persistent,
          f"page-out freed {freed} bytes of A's {prof_a.persistent}")
    res = {
        "phase": "paging",
        "decisions": kinds,
        "persistent_gb": prof_a.persistent / 2**30,
        "device_bytes_freed_by_page_out_gb": freed / 2**30,
        "transfer_latencies_s": report.transfer_latencies,
        "transfer_gb_per_s": [prof_a.persistent / t / 1e9 for t in report.transfer_latencies],
        "tokens_before": before.tolist(),
        "tokens_after": [t.tolist() for t in after],
    }
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phases 6-8: training
# ---------------------------------------------------------------------------


def kernel_counters() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rms_ops
    from repro_torch.kernels.rwkv_scan import ops as wkv_ops

    return {"rmsnorm": rms_ops.rmsnorm, "rmsnorm_bwd": rms_ops.rmsnorm_bwd,
            "flash_attention": fa_ops.flash_attention,
            "flash_attention_bwd": fa_ops.flash_attention_bwd, "wkv6": wkv_ops.wkv6,
            "wkv6_bwd": wkv_ops.wkv6_bwd}


def zero_counts(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def launches_per_microbatch(cfg) -> dict:
    """Kernel launches of one loss-and-gradient pass of a model with
    remat: each layer's norms and its attention, or WKV6 scan, run forward
    twice (the pass and the checkpoint's recompute, which reaches every
    kernel of a block: each lies before the block's MLP or MoE) and
    backward once; the final norm, outside the checkpoints, once each way.
    An attention block (dense, moe, hybrid, audio, vlm) has two norms, four
    with qk-norms (qwen3-8b, qwen3-moe), and one attention; its other
    branches launch none of the kernels (hymba's SSM branch, the MoE
    dispatch and experts, the frontends' splice, M-RoPE). An rwkv block
    has two norms and one WKV6 scan."""
    norms = cfg.n_layers * (4 if cfg.qk_norm else 2)
    mixers = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
              "wkv6": 0, "wkv6_bwd": 0}
    if cfg.family == "ssm":
        mixers = {"flash_attention": 0, "flash_attention_bwd": 0, "wkv6": 2 * cfg.n_layers,
                  "wkv6_bwd": cfg.n_layers}
    return {"rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1, **mixers}


def train_model(kernel_mode: str = "kernel", compute_dtype: str = "bfloat16", n_layers=None,
                arch: str = TRAIN_ARCH, **opts):
    """``arch`` (gemma-2b) at full width and depth (or ``n_layers`` deep)
    with the runtime tables' options for TRAIN_4K (``opts`` replacing
    some), its run config at a global batch of TRAIN_BATCH, and its AdamW
    config."""
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.models import build_model
    from repro_torch.train.runtime import (
        adamw_config_for,
        model_options_for,
        train_run_config_for,
    )

    cfg = get_config(arch) if n_layers is None else depth_cut(arch, n_layers)
    shape = replace(TRAIN_4K, global_batch=TRAIN_BATCH)
    opts = replace(model_options_for(cfg, shape), kernel_mode=kernel_mode,
                   compute_dtype=compute_dtype, **opts)
    return cfg, shape, build_model(cfg, opts), train_run_config_for(cfg, shape), adamw_config_for(cfg)


def phase_train() -> dict:
    return train_session("train", *train_model())


def family_batch(cfg, shape, step: int, device, seed: int = 0) -> dict:
    """``make_batch_for``'s batch of ``cfg`` at ``shape`` on ``device``: the
    JAX package's own batch for each family (tokens and labels; frame
    embeddings for audio; patch embeddings and M-RoPE ids for vlm)."""
    from repro_torch.data.pipeline import make_batch_for

    return {k: torch.from_numpy(v).to(device)
            for k, v in make_batch_for(cfg, shape, step, seed).items()}


def train_session(phase: str, cfg, shape, model, run, ocfg) -> dict:
    """TRAIN_STEPS AdamW steps of ``make_train_step`` as a training session
    on a ``SalusExecutor``, fed ``make_batch_for``'s batches
    (``family_batch``: ``SyntheticLM`` tokens, or the family's frontend
    inputs), its profile from ``profile_model``: finite losses, optimizer
    steps 1.., exactly the launches a step implies, and one more step
    under the profiler (device events), where each kernel the step
    launches must show device time."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import GB, SalusExecutor, VirtualDevice, get_policy, profile_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(15))
    opt = AdamW(ocfg)
    opt_state = opt.init(params)
    data_fn = lambda i: family_batch(cfg, shape, i, dev)  # noqa: E731
    step = make_train_step(model, opt, run)
    step_s = []

    def session_step(state, batch):
        t0 = time.perf_counter()
        p, o, metrics = step(state[0], state[1], batch)
        sync()
        step_s.append(time.perf_counter() - t0)
        return (p, o), metrics

    param_gb = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params)) / 2**30
    sync()
    t0 = time.perf_counter()
    prof = profile_model(model, params, data_fn(0), opt, run)
    profile_s = time.perf_counter() - t0
    check(int(opt_state["step"]) == 0, "profiling took an optimizer step")
    ex = SalusExecutor(int(76 * GB), get_policy("fifo"), device=dev)
    vdev = VirtualDevice(ex)
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    sess = vdev.create_session(f"train:{cfg.name}", session_step, (params, opt_state), data_fn,
                               n_iters=TRAIN_STEPS, profile=prof, kind="train")
    report = vdev.run()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(not report.failures, f"{phase} failures: {report.failures}")
    check(sess.finished and len(sess.metrics_log) == TRAIN_STEPS,
          f"{phase} ran {len(sess.metrics_log)} of {TRAIN_STEPS} steps")
    metrics = [{k: float(v) for k, v in m.items()} for m in sess.metrics_log]
    losses = [m["loss"] for m in metrics]
    check(all(math.isfinite(x) for x in losses), f"{phase}: non-finite losses {losses}")
    check([int(m["step"]) for m in metrics] == list(range(1, TRAIN_STEPS + 1)),
          f"optimizer steps {[m['step'] for m in metrics]}: profiling took a hidden step")
    per_step = {k: run.num_microbatches * v for k, v in launches_per_microbatch(cfg).items()}
    expected = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    check(launches == expected, f"{phase} launches {launches} != expected {expected}")
    # one more step under the profiler (after the counts were read)
    batch = data_fn(TRAIN_STEPS)
    prof_step = profiled(lambda: step(params, opt_state, batch), cpu=False)
    for name, n in per_step.items():
        if n:
            check(prof_step["device_ms_by_kind"][name] > 0,
                  f"{phase}: no {name} device time in the profiled step")
    res = {
        "phase": phase,
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "param_gb": param_gb,
        "shape": {"seq_len": shape.seq_len, "global_batch": shape.global_batch,
                  "microbatches": run.num_microbatches, "accum_dtype": run.accum_dtype},
        "model_options": {"remat": model.opts.remat, "loss_chunk": model.opts.loss_chunk,
                          "compute_dtype": model.opts.compute_dtype,
                          "param_dtype": model.opts.param_dtype,
                          "kernel_mode": model.opts.kernel_mode},
        "adamw": {"lr": ocfg.lr, "warmup_steps": ocfg.warmup_steps, "state_dtype": ocfg.state_dtype},
        "losses": losses, "metrics": metrics,
        "step_s": step_s,
        "tokens_per_s": [shape.seq_len * shape.global_batch / t for t in step_s],
        "peak_gb": peak_gb,
        "profile_gb": {"persistent": prof.persistent / 2**30, "ephemeral": prof.ephemeral / 2**30},
        # params + m + v; the accumulator, one microbatch's gradients and
        # <= ~5 GiB of transients
        "reckoned_gb": {"persistent": 3 * param_gb, "ephemeral_at_most": 2 * param_gb + 5},
        "profile_s": profile_s,
        "launches": launches, "launches_per_step": per_step,
        "profiled_step": prof_step,
    }
    emit(res)
    del sess, ex, report, vdev, params, opt_state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def loss_and_grads(arch: str, n_layers, params, batch, kernel_mode: str, dtype: str,
                   **opts) -> tuple:
    """The training model's loss and gradients on ``batch`` with
    ``kernel_mode``, compute ``dtype`` and ``opts``, its seconds; the
    kernels' launches must be one pass's (none on the plain path). Each
    layer's gradient stays apart, as the step takes them (``leaf_gaps``
    reads such a tuple as the stacked leaf): a stacked copy of them all
    would not fit beside two runs' gradients at mixtral's and qwen3-moe's
    width."""
    from repro_torch.train.train_step import value_and_grad

    cfg, _, m, _, _ = train_model(kernel_mode, dtype, n_layers, arch, **opts)
    per_mb = launches_per_microbatch(cfg)
    counters = kernel_counters()
    zero_counts(counters)
    sync()
    t0 = time.perf_counter()
    loss, g = value_and_grad(m, params, batch)
    sync()
    launched = {name: fn.launches for name, fn in counters.items()}
    want = per_mb if kernel_mode == "kernel" else dict.fromkeys(per_mb, 0)
    check(launched == want, f"{arch} {kernel_mode} {dtype}: launches {launched} != {want}")
    return float(loss), g, time.perf_counter() - t0


def leaf_gaps(a, b) -> dict:
    """Relative Frobenius gap of each leaf, by its path. A leaf may be a
    tuple of per-layer tensors (unstacked gradients): its gap is the
    stacked leaf's, from the layers' squared norms, with no stacked copy."""
    from torch.utils import _pytree as pytree

    out = {}
    is_tuple = lambda t: isinstance(t, tuple)  # noqa: E731
    for (path, x), y in zip(pytree.tree_flatten_with_path(a, is_leaf=is_tuple)[0],
                            pytree.tree_leaves(b, is_leaf=is_tuple)):
        if is_tuple(x):
            diff = sum(float((p.float() - q.float()).norm()) ** 2 for p, q in zip(x, y))
            ref = sum(float(q.float().norm()) ** 2 for q in y)
            out[pytree.keystr(path)] = math.sqrt(diff) / max(math.sqrt(ref), 1e-30)
        else:
            out[pytree.keystr(path)] = rel_fro(x, y)
    return out


def phase_train_parity() -> dict:
    """The training model on one (1, 4096) batch: loss and every gradient
    leaf through the kernels against the plain path, in fp32 (loss within
    1e-5 relative, each leaf within 1e-4 relative Frobenius) and in bf16
    (printed beside the plain bf16 path's gap from the plain fp32 path)."""
    from torch.utils import _pytree as pytree

    from repro_torch.data.pipeline import SyntheticLM

    dev = torch.device("cuda")
    cfg, shape, model, _, _ = train_model()
    params = model.init(torch.Generator(device=dev).manual_seed(15))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(cfg.vocab_size, shape.seq_len, 1, seed=1).batch(0).items()}

    def grads(kernel_mode, dtype):
        return loss_and_grads(TRAIN_ARCH, None, params, batch, kernel_mode, dtype)

    l_r32, g_r32, s_r32 = grads("reference", "float32")
    l_k32, g_k32, s_k32 = grads("kernel", "float32")
    gap32 = leaf_gaps(g_k32, g_r32)
    del g_k32
    worst32 = max(gap32, key=gap32.get)
    l_k16, g_k16, s_k16 = grads("kernel", "bfloat16")
    l_r16, g_r16, s_r16 = grads("reference", "bfloat16")
    gap_k16_r16 = leaf_gaps(g_k16, g_r16)
    gap_k16_r32 = leaf_gaps(g_k16, g_r32)
    gap_r16_r32 = leaf_gaps(g_r16, g_r32)
    finite16 = all(bool(torch.isfinite(t).all().item()) for t in pytree.tree_leaves(g_k16))
    del g_k16, g_r16, g_r32
    loss_rel32 = abs(l_k32 - l_r32) / abs(l_r32)
    res = {
        "phase": "train_parity", "arch": cfg.name, "batch": [1, shape.seq_len],
        "fp32": {"loss_kernel": l_k32, "loss_plain": l_r32, "loss_rel": loss_rel32,
                 "loss_tol": 1e-5, "grad_rel_fro": gap32, "grad_tol": 1e-4,
                 "worst_leaf": [worst32, gap32[worst32]]},
        "bf16": {"loss_kernel": l_k16, "loss_plain": l_r16,
                 "kernel_vs_plain_bf16": gap_k16_r16, "kernel_vs_plain_fp32": gap_k16_r32,
                 "plain_bf16_vs_plain_fp32": gap_r16_r32, "finite": finite16},
        "seconds": {"plain_fp32": s_r32, "kernel_fp32": s_k32, "kernel_bf16": s_k16,
                    "plain_bf16": s_r16},
    }
    emit(res)
    check(loss_rel32 <= 1e-5, f"fp32 loss kernel {l_k32} vs plain {l_r32}")
    check(gap32[worst32] <= 1e-4, f"fp32 gradient {worst32}: relative gap {gap32[worst32]}")
    check(finite16 and math.isfinite(l_k16), "bf16 kernel gradients not finite")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


RWKV_CONTROL_CHUNKS = (32, 16)  # the plain path's other WKV chunkings
# two fp32 ulps, relative: about the plain WKV output's own error from an
# fp64 recurrence at rwkv6-7b's initial decays (2.2e-7 for wkv_chunked, K4
# 3.4e-7, the step-by-step oracle 4.5e-7; PERF.md, PR 28)
RWKV_WKV_NOISE = 2.0 ** -22


@contextlib.contextmanager
def wkv_output_noise(rel: float, seed: int = 0):
    """Around a plain-path run: its WKV output (``models.rwkv.wkv_chunked``,
    which ``tmix_apply`` calls through the module) times ``1 + rel z``, z
    standard normal from a seeded generator: the gradients' sensitivity to
    noise at the WKV output's own fp32 error level."""
    from repro_torch.models import rwkv

    chunked = rwkv.wkv_chunked
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(r, k, v, w, u, *, chunk=64):
        o, state = chunked(r, k, v, w, u, chunk=chunk)
        return o * (1 + rel * torch.randn(o.shape, generator=gen, device=o.device)), state

    rwkv.wkv_chunked = noisy
    try:
        yield
    finally:
        rwkv.wkv_chunked = chunked


def rwkv_train_parity() -> dict:
    """rwkv6-7b at RWKV_TRAIN_DEPTH on one (1, 4096) batch: the fp32 loss
    and every gradient leaf through K1/B1/K4/B3 against the plain path
    (``wkv_chunked`` at the runtime's chunk of 64, and autograd). The loss
    is held within 1e-5 relative. The model's fp32 gradients carry more
    noise than train_parity's 1e-4 bar: the plain path itself, at WKV
    chunks of 32 and 16 (the same function, other sums), moves leaves by up
    to ~2e-3, and noise of RWKV_WKV_NOISE on its WKV output by up to ~5e-4.
    So, as the kernels phase holds B3 beside the plain version's own fp64
    gap, each leaf is held within 1e-4, or twice the largest of those three
    gaps of the plain path from itself where that is larger; all are
    printed."""
    from repro_torch.data.pipeline import SyntheticLM

    dev = torch.device("cuda")
    cfg, shape, model, _, _ = train_model(n_layers=RWKV_TRAIN_DEPTH, arch=RWKV_ARCH)
    params = model.init(torch.Generator(device=dev).manual_seed(16))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(cfg.vocab_size, shape.seq_len, 1, seed=1).batch(0).items()}

    def grads(mode, **opts):
        return loss_and_grads(RWKV_ARCH, RWKV_TRAIN_DEPTH, params, batch, mode, "float32", **opts)

    l_r, g_r, s_r = grads("reference")
    l_k, g_k, s_k = grads("kernel")
    gaps = leaf_gaps(g_k, g_r)
    del g_k
    control = {}

    def plain_gap(name, **opts):
        l_c, g_c, _ = grads("reference", **opts)
        control[name] = {"loss_rel": abs(l_c - l_r) / abs(l_r), "grad_rel_fro": leaf_gaps(g_c, g_r)}

    for chunk in RWKV_CONTROL_CHUNKS:
        plain_gap(f"chunk_{chunk}", wkv_chunk=chunk)
    with wkv_output_noise(RWKV_WKV_NOISE):
        plain_gap("wkv_output_noise")
    tol = {x: max(1e-4, 2 * max(c["grad_rel_fro"][x] for c in control.values())) for x in gaps}
    worst = max(gaps, key=lambda x: gaps[x] / tol[x])
    loss_rel = abs(l_k - l_r) / abs(l_r)
    res = {"batch": [1, shape.seq_len], "loss_kernel": l_k, "loss_plain": l_r,
           "loss_rel": loss_rel, "loss_tol": 1e-5, "grad_rel_fro": gaps,
           "plain_against_itself": control, "wkv_output_noise": RWKV_WKV_NOISE,
           "grad_tol": tol, "worst_leaf": [worst, gaps[worst], tol[worst]],
           "largest_gap": max(gaps.values()), "seconds": {"plain": s_r, "kernel": s_k}}
    check(loss_rel <= 1e-5, f"rwkv fp32 loss kernel {l_k} vs plain {l_r}")
    check(gaps[worst] <= tol[worst],
          f"rwkv fp32 gradient {worst}: relative gap {gaps[worst]} > {tol[worst]}")
    del params, g_r
    gc.collect()
    torch.cuda.empty_cache()
    return res


def entry_points(arch: str) -> dict:
    """``arch`` at smoke size on the card through the user's entry points:
    the train CLI's ``main`` (3 steps) and ``make_trainer``'s background
    trainer stepping as a session on an executor (3 iterations); finite
    losses and exactly a pass's launches a microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.core import GB, SalusExecutor, VirtualDevice, get_policy
    from repro_torch.launch import train as cli
    from repro_torch.launch.serve import make_trainer

    cfg = get_config(arch).smoke()
    per = launches_per_microbatch(cfg)
    counters = kernel_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    rec = cli.main(["--arch", arch, "--smoke", "--steps", "3", "--device", "cuda"])
    sync()
    cli_s = time.perf_counter() - t0
    cli_launches = {name: fn.launches for name, fn in counters.items()}
    cli_losses = [rec["losses"][i] for i in sorted(rec["losses"])]
    dev = torch.device("cuda")
    step, params, data_fn = make_trainer(arch, smoke=True, device=dev)
    vdev = VirtualDevice(SalusExecutor(int(8 * GB), get_policy("fifo"), device=dev))
    zero_counts(counters)
    sess = vdev.create_session(f"train:{cfg.name}", step, params, data_fn, n_iters=3,
                               kind="train")
    report = vdev.run()
    trainer_launches = {name: fn.launches for name, fn in counters.items()}
    trainer_losses = [float(m["loss"]) for m in sess.metrics_log]
    res = {"cli": {"losses": cli_losses, "wall_s": cli_s, "launches": cli_launches},
           "trainer": {"losses": trainer_losses, "launches": trainer_launches,
                       "failures": report.failures}}
    want = {k: 3 * v for k, v in per.items()}
    check(cli_launches == want, f"{arch} CLI launches {cli_launches} != {want}")
    check(len(cli_losses) == 3 and all(math.isfinite(x) for x in cli_losses),
          f"{arch} CLI losses {cli_losses}")
    # three iterations and the profiling step ``create_session`` takes
    want = {k: 4 * v for k, v in per.items()}
    check(not report.failures and trainer_launches == want,
          f"{arch} trainer launches {trainer_launches} != {want}, failures {report.failures}")
    check(len(trainer_losses) == 3 and all(math.isfinite(x) for x in trainer_losses),
          f"{arch} trainer losses {trainer_losses}")
    return res


def phase_rwkv_train() -> dict:
    """rwkv6-7b trains on the card: the session's steps, the kernels
    against the plain path, and the CLI and serve trainer at smoke size."""
    cut = train_model(n_layers=RWKV_TRAIN_DEPTH, arch=RWKV_ARCH)
    res = train_session("rwkv_train", *cut)
    del cut
    res = {"phase": "rwkv_train", "steps": res, "parity_fp32": rwkv_train_parity(),
           "entry_points": entry_points(RWKV_ARCH), "nvidia_smi": nvidia_smi()}
    emit({k: v for k, v in res.items() if k != "steps"})
    return res


def top_kernels(averages, n: int = 8) -> list:
    """The ``n`` kernels with the most device time in a profiler run's
    ``key_averages()``: ``[name, device ms, launches]``."""
    rows = []
    for evt in averages:
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key in SSM_SPANS.values():
            continue
        us = getattr(evt, "self_device_time_total", None)
        rows.append([evt.key[:120], (evt.self_cuda_time_total if us is None else us) / 1e3,
                     evt.count])
    return sorted(rows, key=lambda r: -r[1])[:n]


def family_train_parity(arch: str) -> dict:
    """One ``make_batch_for`` sequence of ``arch`` (mixtral: the moe phase's
    (1, 6144), where its window binds) at FAMILIES_PARITY_DEPTH layers and
    full width, fp32 params: the fp32 loss and every gradient leaf
    through the kernels against the plain path (loss within 1e-5
    relative, each leaf within 1e-4 relative Frobenius), then bf16 compute,
    kernels against plain within 2e-2. An MoE arch's routing is traced
    (``moe_trace``): in fp32 the two runs must route every token alike
    (else the kernel run is held again on the plain run's routing, and
    that is what must pass); in bf16 the kernel run takes the plain run's
    routing. Each run's dropped assignments are printed, and whether a
    second fp32 kernel run of an MoE arch repeats the first bit for bit
    (reported, not held: its gathers' backward accumulates)."""
    from torch.utils import _pytree as pytree

    dev = torch.device("cuda")
    depth = FAMILIES_PARITY_DEPTH
    cfg, shape, model, _, _ = train_model("reference", "float32", depth, arch, **PARITY_OPTS)
    seq = FAMILIES_PARITY_SEQ.get(arch, shape.seq_len)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    batch = family_batch(cfg, replace(shape, seq_len=seq, global_batch=1), 1, dev)
    del model

    def grads(mode, dtype, replay=None):
        trace = moe_trace(replay) if cfg.is_moe else contextlib.nullcontext([])
        with trace as log:
            loss, g, secs = loss_and_grads(arch, depth, params, batch, mode, dtype,
                                           **PARITY_OPTS)
        return loss, g, secs, list(log)

    res = {"arch": arch, "n_layers": depth, "batch": [1, seq], "keys": sorted(batch)}
    l_r, g_r, s_r, log_r = grads("reference", "float32")
    l_k, g_k, s_k, log_k = grads("kernel", "float32")
    flips = flipped_tokens(log_r, log_k)
    if cfg.is_moe:
        res["fp32_routing"] = {"flipped_tokens_a_route_call": flips,
                               "dropped": {"plain": dropped(log_r), "kernel": dropped(log_k)}}
        if any(flips):  # held again on the plain run's routing
            del g_k
            l_k, g_k, s_k, _ = grads("kernel", "float32", log_r)
            res["fp32_routing"]["held_on_plain_routing"] = True
    gaps = leaf_gaps(g_k, g_r)
    del g_r
    worst = max(gaps, key=gaps.get)
    loss_rel = abs(l_k - l_r) / abs(l_r)
    res["fp32"] = {"loss_kernel": l_k, "loss_plain": l_r, "loss_rel": loss_rel, "loss_tol": 1e-5,
                   "grad_rel_fro": gaps, "grad_tol": 1e-4, "worst_leaf": [worst, gaps[worst]],
                   "seconds": {"plain": s_r, "kernel": s_k}}
    if cfg.is_moe:  # the dispatch's gathers take their backward through an accumulating index_put
        l_k2, g_k2, _, _ = grads("kernel", "float32", log_r if any(flips) else None)
        res["fp32"]["kernel_run_repeats_bit_for_bit"] = l_k2 == l_k and trees_equal(g_k, g_k2)
        del g_k2
    del g_k
    l_r16, g_r16, s_r16, log_r16 = grads("reference", "bfloat16")
    l_k16, g_k16, s_k16, log_k16 = grads("kernel", "bfloat16", log_r16 if cfg.is_moe else None)
    gaps16 = leaf_gaps(g_k16, g_r16)
    finite16 = all(bool(torch.isfinite(t).all().item()) for t in pytree.tree_leaves(g_k16))
    del g_k16, g_r16
    worst16 = max(gaps16, key=gaps16.get)
    loss_rel16 = abs(l_k16 - l_r16) / abs(l_r16)
    res["bf16"] = {"loss_kernel": l_k16, "loss_plain": l_r16, "loss_rel": loss_rel16,
                   "grad_rel_fro": gaps16, "tol": 2e-2, "worst_leaf": [worst16, gaps16[worst16]],
                   "finite": finite16, "seconds": {"plain": s_r16, "kernel": s_k16}}
    if cfg.is_moe:
        res["bf16"]["dropped"] = {"plain": dropped(log_r16), "kernel": dropped(log_k16)}
    emit({"phase": "families_train", "part": "parity", **res})
    check(loss_rel <= 1e-5, f"{arch} fp32 loss kernel {l_k} vs plain {l_r}")
    check(gaps[worst] <= 1e-4, f"{arch} fp32 gradient {worst}: relative gap {gaps[worst]}")
    check(finite16 and loss_rel16 <= 2e-2 and gaps16[worst16] <= 2e-2,
          f"{arch} bf16: loss {l_k16} vs {l_r16}, gradient {worst16} {gaps16[worst16]}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_families_train() -> dict:
    """Every attention family trains on the card at full width
    (``FAMILIES_TRAIN``: musicgen-medium at full depth; hymba-1.5b,
    qwen2-vl-72b, mixtral-8x22b and qwen3-moe-235b-a22b cut): (a) each a
    ``train_session`` of TRAIN_STEPS AdamW steps at TRAIN_4K's sequence,
    TRAIN_BATCH rows and its runtime-table options (microbatches, param,
    moment and accumulation dtypes), fed ``make_batch_for``'s batches
    (frame embeddings, patch embeddings and M-RoPE ids): finite losses,
    optimizer steps 1..3, exact launches a step, device time in each
    launched kernel; step seconds, tokens a second, the profiled step's
    busy share and top kernels, the peak beside the dry run's count
    (``scripts/families_train_count.py``); (b) ``family_train_parity``;
    (c) ``entry_points`` of hymba and mixtral at smoke size. At most
    FAMILIES_TRAIN_LIMIT_S seconds."""
    smi = nvidia_smi()
    t0 = time.perf_counter()
    steps, parity = {}, {}
    for arch, depth in FAMILIES_TRAIN:
        cut = train_model(n_layers=depth, arch=arch)
        r = train_session("families_train", *cut)
        del cut
        prof = r["profiled_step"]
        steps[arch] = {k: r[k] for k in (
            "n_layers", "params", "param_gb", "shape", "model_options", "adamw", "losses",
            "step_s", "tokens_per_s", "peak_gb", "profile_gb", "launches", "launches_per_step")}
        count = FAMILIES_TRAIN_COUNTED_GIB[arch]
        steps[arch].update(busy_share=prof["device_busy_share"],
                           device_ms_by_kind=prof["device_ms_by_kind"],
                           top_kernels=prof["top_kernels"], counted_peak_gib=count,
                           peak_over_count=r["peak_gb"] / count)
        parity[arch] = family_train_parity(arch)
    entry = {arch: entry_points(arch) for arch in FAMILIES_ENTRY_ARCHS}
    wall_s = time.perf_counter() - t0
    res = {"phase": "families_train", "nvidia_smi": smi, "steps": steps,
           "parity": {a: {"fp32_worst_leaf": p["fp32"]["worst_leaf"],
                          "fp32_loss_rel": p["fp32"]["loss_rel"],
                          "bf16_worst_leaf": p["bf16"]["worst_leaf"],
                          "fp32_routing": p.get("fp32_routing"),
                          "fp32_kernel_run_repeats_bit_for_bit":
                              p["fp32"].get("kernel_run_repeats_bit_for_bit")}
                      for a, p in parity.items()},
           "entry_points": entry, "wall_s": wall_s}
    emit(res)
    check(wall_s <= FAMILIES_TRAIN_LIMIT_S,
          f"families_train took {wall_s:.1f} s, over {FAMILIES_TRAIN_LIMIT_S}")
    return res


def phase_serve_train() -> dict:
    """Salus's serve regime: a gemma-2b service and a gemma-2b background
    trainer on one executor under PRIORITY."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(TRAIN_ARCH)
    argv = [
        "--archs", TRAIN_ARCH, "--no-smoke", "--device", "cuda",
        "--train-background", TRAIN_ARCH, "--train-iters", "30",
        "--capacity-gb", "76", "--rps", "4", "--duration", "4", "--requests", "8",
        "--policy", "priority", "--seed", "0",
    ]
    counters = kernel_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    report, ex = serve.serve(serve.build_parser().parse_args(argv))
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check(not report.failures, f"serve_train failures: {report.failures}")
    out = {"phase": "serve_train", "wall_s": wall_s, "launches": launches}
    expected = dict.fromkeys(counters, 0)
    for jid, st in report.stats.items():
        sess = ex.sessions[jid]
        if sess.job.kind == "inference":
            check(st.iterations_done == sess.n_iters,
                  f"{sess.name}: served {st.iterations_done} of {sess.n_iters} requests")
            per = launches_per_request(cfg)
            for name, n in per.items():
                expected[name] += n * (st.iterations_done + 1)  # + the profiling step
            out["service"] = {"name": sess.name, "requests": st.iterations_done,
                              "attempted": sess.n_iters,
                              "latency_ms": [x * 1e3 for x in st.request_latencies],
                              "p50_ms": st.p50_latency * 1e3, "p99_ms": st.p99_latency * 1e3,
                              "profile_gb": {"persistent": sess.job.profile.persistent / 2**30,
                                             "ephemeral": sess.job.profile.ephemeral / 2**30}}
        else:
            losses = [float(m["loss"]) for m in sess.metrics_log]
            check(st.iterations_done > 0, "the background trainer took no iteration")
            check(all(math.isfinite(x) for x in losses), f"trainer losses {losses}")
            for name, n in launches_per_microbatch(cfg).items():
                expected[name] += n * (st.iterations_done + 1)  # + the profiling step
            out["trainer"] = {"name": sess.name, "iterations": st.iterations_done,
                              "preemptions": st.preemptions, "losses": losses,
                              "iteration_s": [r.end - r.start for r in report.records
                                              if r.job_id == jid],
                              "profile_gb": {"persistent": sess.job.profile.persistent / 2**30,
                                             "ephemeral": sess.job.profile.ephemeral / 2**30}}
    out["expected_launches"] = expected
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit(out)
    check({"service", "trainer"} <= set(out), "serve_train lacks the service or the trainer")
    check(launches == expected, f"serve_train launches {launches} != expected {expected}")
    del report, ex, sess
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: decode
# ---------------------------------------------------------------------------


def decode_launches_per_step(cfg, quantized: bool) -> dict:
    """Kernel launches of one decode step: the norms as in a prefill, one
    attention a layer against an unquantized cache (an int8 cache takes
    the plain chunked scan), one WKV6 step a layer for rwkv."""
    per = launches_per_request(cfg)
    if quantized:
        per["flash_attention"] = 0
    return per


def generate(model, params, tokens, n: int, max_len: int, feed=None):
    """``tokens`` (b, s) prefilled into a cache of ``max_len`` through
    ``make_prefill_step``, then ``n - 1`` steps of ``make_decode_step``:
    greedy (``sample_token`` at temperature 0), or fed the tokens ``feed``
    (b, n). Returns (argmax tokens (b, n), fp32 logits (n, b, vocab))."""
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step, sample_token

    logits, cache = make_prefill_step(model, max_len=max_len)(params, {"tokens": tokens})
    decode = make_decode_step(model)
    outs, toks = [logits.float()], [sample_token(logits, None, 0.0)]
    pos = tokens.shape[1]
    for i in range(n - 1):
        tok = toks[-1] if feed is None else feed[:, i]
        logits, cache = decode(params, {"tokens": tok[:, None]}, cache, pos + i)
        outs.append(logits[:, 0].float())
        toks.append(sample_token(logits[:, 0], None, 0.0))
    return torch.stack(toks, dim=1), torch.stack(outs)


def first_difference(a: torch.Tensor, b: torch.Tensor):
    """The first step (column) where two token tensors differ, or None."""
    diff = (a != b).any(dim=0).nonzero()
    return int(diff[0].item()) if diff.numel() else None


def decode_correctness(arch: str, cfg=None, one_step_opts=None, greedy_prompt=None) -> dict:
    """One arch at full width and depth (or ``cfg``, a depth cut), random
    weights (rwkv decays spread as in the parity phase), a (1, 512) batch
    of its frontend (``model_inputs``) in a cache of 512 + 16: (1) the
    decode step of position 511, fed that position's own input (a token,
    a frame embedding, M-RoPE ids (1, 3, 1)), against the full forward's
    logits there, through the kernels in fp32, with the launches of the
    three calls (``one_step_opts``: further ``ModelOptions``; an MoE
    forward must drop no assignment there, or decode could not equal it).
    Where the model takes tokens alone (greedy decoding feeds them back):
    (2) 16 greedy tokens through the kernels and through the plain path,
    fp32 and bf16, logits held at the parity phase's tolerances, tokens
    identical (where they first differ the plain path's top-2 gap there
    must be under the logits' tolerance: a near tie), and
    ``greedy_generate`` giving the kernels' tokens; (3) with a KV cache,
    at the runtime tables' decode settings (bf16 params and compute, an
    int8 cache), fed the bf16-cache run's tokens: the int8 cache against
    the bf16 cache through the same plain path, as a share of max |logit|,
    within twice bf16 compute's own error (the plain path against itself
    in fp32 compute on the same params and tokens), as the parity phase
    holds the kernels, and so is the gap as served (the int8 cache's
    plain attention against K3 on the bf16 cache); the path gaps (kernels
    against plain) and tests/test_kv_quant.py's 5% (an fp32 bound)
    beside them.
    ``greedy_prompt``: (2) and (3) prefill a fresh prompt of that many
    tokens in place of the 511 (past a sliding window, so that the ring
    fills and wraps). MoE: the bf16 kernel run and the fp32 yardstick fed
    its tokens replay the plain bf16 run's routing, and the runs of (3)
    the bf16-cache kernel run's (see ``phase_parity``); fp32 runs free."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import DECODE_32K, get_config
    from repro_torch.models import ModelOptions, attention, build_model
    from repro_torch.train.runtime import model_options_for
    from repro_torch.train.serve_step import greedy_generate

    t_start = time.perf_counter()
    cfg = cfg or get_config(arch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    params = build_model(cfg).init(gen)
    if cfg.family == "ssm":
        spread_decay(params, cfg)
    seq = DECODE_PROMPT + 1
    batch = model_inputs(cfg, 1, seq, gen)
    max_len = seq + DECODE_NEW
    counters = kernel_counters()
    tol32 = 1e-3  # the parity phase's fp32 tolerance, (1 + |plain|)

    def model(kernel_mode, dtype, **kw):
        return build_model(cfg, ModelOptions(kernel_mode=kernel_mode, compute_dtype=dtype, **kw))

    # (1) decode of position 511 against the full forward
    m32 = model("kernel", "float32", **(one_step_opts or {}))
    zero_counts(counters)
    with moe_trace() as log:
        full, _ = m32.apply(params, batch)
        _, cache = m32.prefill(params, steps(batch, 0, seq - 1), max_len=max_len)
        step, _ = m32.decode(params, steps(batch, seq - 1, seq), cache, seq - 1)
        sync()
    del cache
    want = full[:, -1].float()
    got = step[:, 0].float()
    del full, step
    per_step = decode_launches_per_step(cfg, quantized=False)
    one_step = {"inputs": sorted(batch),
                "decode_inputs": {n: list(t.shape) for n, t in steps(batch, seq - 1, seq).items()},
                "max_abs_diff": max_err(got, want), "tol": f"{tol32} (1 + |full|)",
                "argmax_decode": int(got.argmax().item()), "argmax_full": int(want.argmax().item()),
                "launches": {n: fn.launches for n, fn in counters.items()},
                "expected_launches": {**dict.fromkeys(counters, 0),
                                      **{n: 2 * launches_per_request(cfg)[n] + per_step[n]
                                         for n in per_step}}}
    if cfg.is_moe:
        one_step.update(options=one_step_opts, dropped_assignments=dropped(log))
        check(dropped(log) == 0,
              f"{arch}: the full forward dropped {dropped(log)} assignments")
    check(bool(torch.isfinite(got).all().item()), f"{arch}: decode logits not finite")
    check(within(got, want, tol32), f"{arch}: decode of position {seq - 1} vs full forward "
                                    f"{one_step['max_abs_diff']}")
    check(one_step["argmax_decode"] == one_step["argmax_full"], f"{arch}: decode argmax differs")
    check(one_step["launches"] == one_step["expected_launches"],
          f"{arch}: launches {one_step['launches']} != {one_step['expected_launches']}")
    out = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "decode_of_token_511": one_step}
    if set(batch) != {"tokens"}:
        # frame embeddings, or patches with M-RoPE ids: greedy decoding
        # feeds back tokens alone, which such a model does not take
        del params
        out["seconds"] = time.perf_counter() - t_start
        emit({"phase": "decode", "part": "correctness", **out})
        gc.collect()
        torch.cuda.empty_cache()
        return out

    # (2) greedy decoding, kernels against plain, fp32 and bf16
    if greedy_prompt is None:
        prompt = batch["tokens"][:, :-1]
    else:
        prompt = torch.randint(0, cfg.vocab_size, (1, greedy_prompt), generator=gen, device=dev)
        max_len = greedy_prompt + DECODE_NEW
    runs, launches, drops, routes = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        for kernel_mode in ("reference", "kernel"):
            replay = None
            if cfg.is_moe and dtype == "bfloat16" and kernel_mode == "kernel":
                replay = routes["reference", dtype]
            zero_counts(counters)
            with moe_trace(replay) as log:
                runs[kernel_mode, dtype] = generate(model(kernel_mode, dtype), params, prompt,
                                                    DECODE_NEW, max_len)
                sync()
            launches[kernel_mode, dtype] = {n: fn.launches for n, fn in counters.items()}
            drops[f"{kernel_mode} {dtype}"] = dropped(log)
            routes[kernel_mode, dtype] = log
    same16 = routes["reference", "bfloat16"] if cfg.is_moe else None
    # the plain fp32 path fed the plain bf16 path's tokens: bf16's own
    # rounding error on the same inputs (the parity phase's yardstick)
    with moe_trace(same16):
        _, plain32_fed = generate(model("reference", "float32"), params, prompt, DECODE_NEW,
                                  max_len, feed=runs["reference", "bfloat16"][0])
    want_launch = {n: launches_per_request(cfg)[n] + (DECODE_NEW - 1) * per_step[n]
                   for n in per_step}
    greedy = {}
    out.update(prompt=[1, prompt.shape[1]], max_len=max_len, new_tokens=DECODE_NEW,
               expected_launches_a_run=want_launch)
    if cfg.is_moe:
        out.update(sliding_window=cfg.sliding_window,
                   cache_slots=attention.cache_capacity(cfg, max_len),
                   dropped_assignments_a_run=drops, bf16_routing="the plain bf16 run's, replayed",
                   fp32_flipped_tokens_a_route_call=flipped_tokens(
                       routes["kernel", "float32"], routes["reference", "float32"]))
    for dtype in ("float32", "bfloat16"):
        (k_tok, k_log), (p_tok, p_log) = runs["kernel", dtype], runs["reference", dtype]
        check(launches["kernel", dtype] == {**dict.fromkeys(counters, 0), **want_launch},
              f"{arch} {dtype}: launches {launches['kernel', dtype]} != {want_launch}")
        check(not any(launches["reference", dtype].values()),
              f"{arch} {dtype}: the plain path launched {launches['reference', dtype]}")
        diverge = first_difference(k_tok, p_tok)
        upto = DECODE_NEW if diverge is None else diverge + 1  # same inputs up to there
        for name, t in (("kernel", k_log), ("plain", p_log)):
            check(bool(torch.isfinite(t).all().item()), f"{arch} {dtype} {name}: non-finite logits")
        diff = max_err(k_log[:upto], p_log[:upto])
        res = {"tokens_identical": diverge is None, "first_difference": diverge,
               "logits_max_abs_diff": diff, "tokens_kernel": k_tok[0].tolist(),
               "tokens_plain": p_tok[0].tolist(), "launches": launches["kernel", dtype]}
        if dtype == "float32":
            res["tol"] = f"{tol32} (1 + |plain|)"
            ok = within(k_log[:upto], p_log[:upto], tol32)
            tie_tol = tol32 * (1 + p_log.abs().max().item())
        else:
            err_plain16 = max_err(p_log, plain32_fed)
            err_kernel16 = max_err(k_log[:upto], plain32_fed[:upto])
            res.update(tol=2.0 * err_plain16, plain_vs_fp32=err_plain16,
                       kernel_vs_fp32=err_kernel16)
            ok = diff <= 2.0 * err_plain16 and err_kernel16 <= 1.25 * err_plain16
            tie_tol = 2.0 * err_plain16
        if diverge is not None:
            top2 = torch.topk(p_log[diverge, 0], 2).values
            res["plain_top2_gap_at_difference"] = float(top2[0] - top2[1])
            res["near_tie_tol"] = tie_tol
            ok = ok and res["plain_top2_gap_at_difference"] < tie_tol
        res["ok"] = bool(ok)
        out[dtype] = res
        with moe_trace(same16 if dtype == "bfloat16" else None):
            greedy[dtype] = greedy_generate(model("kernel", dtype), params, {"tokens": prompt},
                                            DECODE_NEW, max_len)
        res["greedy_generate_equals_loop"] = bool(torch.equal(greedy[dtype].long(), k_tok.long()))
    del runs, plain32_fed
    # (3) int8 cache at the runtime tables' decode settings
    if cfg.family != "ssm":
        opts = model_options_for(cfg, DECODE_32K)
        params16 = pytree.tree_map(lambda t: t.to(getattr(torch, opts.param_dtype)), params)
        del params
        gc.collect()

        def run(quantized: bool, kernel_mode: str, feed=None, replay=None, **kw):
            m = build_model(cfg, replace(opts, kv_quantized=quantized, kernel_mode=kernel_mode,
                                         **kw))
            zero_counts(counters)
            with moe_trace(replay) as routing:
                tok, logits = generate(m, params16, prompt, DECODE_NEW, max_len, feed=feed)
                sync()
            check(bool(torch.isfinite(logits).all().item()),
                  f"{arch} kv_quantized={quantized} {kernel_mode}: logits not finite")
            return tok, logits, routing, {n: fn.launches for n, fn in counters.items()}

        def rel(a, b):
            return max_err(a, b) / b.abs().max().item()

        # the bf16 cache as served (K3) picks the tokens every other run is fed
        bf_tok, bf_log, bf_routes, bf_launch = run(False, "kernel")
        replay = bf_routes if cfg.is_moe else None
        _, q_log, _, q_launch = run(True, "kernel", bf_tok, replay)
        _, bf_plain, _, _ = run(False, "reference", bf_tok, replay)
        _, q_plain, _, _ = run(True, "reference", bf_tok, replay)
        # the plain path in fp32 compute on the same params and tokens:
        # bf16 compute's own error, under which no bf16 comparison resolves
        _, f32_plain, _, _ = run(False, "reference", bf_tok, replay, compute_dtype="float32")
        own16 = rel(bf_plain, f32_plain)
        q_per_step = decode_launches_per_step(cfg, quantized=True)
        want_q = {**dict.fromkeys(counters, 0),
                  **{n: launches_per_request(cfg)[n] + (DECODE_NEW - 1) * q_per_step[n]
                     for n in q_per_step}}
        out["int8"] = {
            "options": {"param_dtype": opts.param_dtype, "kv_quantized": opts.kv_quantized,
                        "compute_dtype": opts.compute_dtype},
            # twice bf16 compute's own error, as the parity phase holds the
            # kernels: under 5% (tests/test_kv_quant.py's fp32 bound) for
            # every arch but hymba-1.5b, whose bf16 error is 5.0% (ROADMAP
            # queue C)
            "tol": 2.0 * own16, "bf16_compute_vs_fp32": own16,
            "within_test_kv_quant_5pct": rel(q_plain, bf_plain) < 0.05,
            # each a max |difference| over max |logit| of the second run
            "same_plain_path": rel(q_plain, bf_plain),
            "as_served": rel(q_log, bf_log),
            "bf16_cache_kernels_vs_plain": rel(bf_log, bf_plain),
            "int8_cache_kernels_vs_plain": rel(q_log, q_plain),
            "launches": q_launch, "bf16_cache_launches": bf_launch, "expected_launches": want_q}
        del params16
    else:
        out["int8"] = "no KV cache: kv_quantized changes nothing for rwkv"
        del params
    out["seconds"] = time.perf_counter() - t_start
    emit({"phase": "decode", "part": "correctness", **out})
    for dtype in ("float32", "bfloat16"):
        check(out[dtype]["ok"], f"{arch} {dtype} greedy decode: {out[dtype]}")
        check(out[dtype]["greedy_generate_equals_loop"],
              f"{arch} {dtype}: greedy_generate's tokens differ from the decode loop's")
    if isinstance(out["int8"], dict):
        q = out["int8"]
        check(q["launches"] == q["expected_launches"],
              f"{arch} int8: launches {q['launches']} != {q['expected_launches']}")
        for name in ("same_plain_path", "as_served"):
            check(q[name] < q["tol"],
                  f"{arch} int8 cache {name}: {q[name]} of max |logit| from the bf16 cache, "
                  f"over twice bf16's own error {q['tol']}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_state_bytes(cfg, quantized: bool, cap: int) -> int:
    """Bytes of one sequence's decode state at ``cap`` slots: K and V (and
    their fp16 scales when int8), with a hybrid's SSM state
    (``ssm_state_bytes``), or rwkv's shift carries and wkv state."""
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.rwkv_head_dim
        return cfg.n_layers * (2 * cfg.d_model * 2 + h * cfg.rwkv_head_dim ** 2 * 4)
    per_slot = cfg.n_kv_heads * (cfg.head_dim + 2 if quantized else 2 * cfg.head_dim)
    return cfg.n_layers * cap * 2 * per_slot + ssm_state_bytes(cfg)


def ssm_state_bytes(cfg) -> int:
    """A hybrid's SSM state of one sequence, 0 for other families: h (fp32
    d_inner x ssm_state) and the conv window (bf16, ssm_conv - 1 rows of
    d_inner) a layer."""
    if cfg.family != "hybrid":
        return 0
    d_inner = cfg.ssm_expand * cfg.d_model
    return cfg.n_layers * d_inner * (cfg.ssm_state * 4 + (cfg.ssm_conv - 1) * 2)


def fill_random(cache: dict, gen: torch.Generator) -> None:
    """Random values of each leaf's dtype: int8 values in [-127, 127],
    fp16 scales in [0.005, 0.02], normal elsewhere (wkv and SSM states
    scaled to 0.1)."""
    for name, t in cache.items():
        if t.dtype == torch.int8:
            t.random_(-127, 128, generator=gen)
        elif t.dtype == torch.float16:
            t.uniform_(0.005, 0.02, generator=gen)
        else:
            t.normal_(0.0, 0.1 if name in ("wkv", "h") else 1.0, generator=gen)


def decode_timings(arch: str) -> list:
    """``decode_timing`` of one arch's caches (int8 and bf16; rwkv's
    recurrent state), sharing one draw of bf16 params."""
    from repro_torch.configs import DECODE_32K, get_config
    from repro_torch.models import build_model
    from repro_torch.train.runtime import model_options_for

    cfg = get_config(arch)
    opts = model_options_for(cfg, DECODE_32K)
    params = build_model(cfg, opts).init(torch.Generator(device="cuda").manual_seed(19))
    caches = (False,) if cfg.family == "ssm" else (True, False)
    out = [decode_timing(cfg, replace(opts, kv_quantized=q), params) for q in caches]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_timing(cfg, opts, params, batch=None, kinds=DECODE_KERNEL_KINDS) -> dict:
    """The decode shape, DECODE_32K (32768 cached tokens, batch 128), with
    ``opts`` (the runtime tables' bf16 params; an int8 cache, or bf16
    where ``kv_quantized`` is off): the batch halved until the state is
    at most DECODE_CACHE_GB (or ``batch``), a cache of random values of
    its dtype (a sliding window's ring of ``window`` slots, all valid at
    these positions), and DECODE_STEPS steps timed from pos = 32767 - DECODE_STEPS;
    launches a step, one more step under the profiler (kernels grouped by
    ``kinds``), and the bytes bound (params and the valid cache read
    once)."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import DECODE_32K
    from repro_torch.models import attention, build_model

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    cap = DECODE_32K.seq_len
    slots = cap if cfg.family == "ssm" else attention.cache_capacity(cfg, cap)
    quantized = opts.kv_quantized
    b = batch or DECODE_32K.global_batch
    while batch is None and b > 1 and (
            b * decode_state_bytes(cfg, quantized, slots) > DECODE_CACHE_GB * 1e9):
        b //= 2
    model = build_model(cfg, opts)
    gen = torch.Generator(device=dev).manual_seed(20)
    cache = model.init_cache(b, cap, device=dev)
    fill_random(cache, gen)
    inputs = model_inputs(cfg, b, 1, gen)  # one token, or one frame embedding, a sequence
    pos0 = cap - 1 - DECODE_STEPS
    counters = kernel_counters()
    logits, cache = model.decode(params, inputs, cache, pos0 - 1)  # warm-up
    sync()
    zero_counts(counters)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(DECODE_STEPS):
        logits, cache = model.decode(params, inputs, cache, pos0 + i)
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    ms = start.elapsed_time(end) / DECODE_STEPS
    launches = {n: fn.launches for n, fn in counters.items()}
    per_step = decode_launches_per_step(cfg, quantized)
    expected = {**dict.fromkeys(counters, 0), **{n: DECODE_STEPS * v for n, v in per_step.items()}}
    finite = bool(torch.isfinite(logits.float()).all().item())
    prof = profiled(lambda: model.decode(params, inputs, cache, cap - 1), kinds=kinds)
    param_bytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(params))
    if cfg.family == "ssm":
        state_bytes = b * decode_state_bytes(cfg, False, cap)
    else:  # the valid slots of each timed step, on average; an SSM state
        # is read and written whole
        n_valid = sum(min(pos0 + i + 1, slots) for i in range(DECODE_STEPS)) / DECODE_STEPS
        ssm = ssm_state_bytes(cfg)
        state_bytes = b * ((decode_state_bytes(cfg, quantized, 1) - ssm) * n_valid + 2 * ssm)
    from repro_torch.launch.roofline import HBM_BYTES_PER_S

    bound_ms = (param_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    if batch is not None:
        batch_cut = f"set to {batch}"
    elif b < DECODE_32K.global_batch:
        batch_cut = f"halved until the state is <= {DECODE_CACHE_GB} GB"
    else:
        batch_cut = None
    res = {
        "phase": "decode", "part": "timing", "arch": cfg.name,
        "n_layers": cfg.n_layers,
        "cache": "recurrent state" if cfg.family == "ssm" else ("int8" if quantized else "bf16"),
        "shape": {"cached_tokens": cap, "batch": b, "batch_from": DECODE_32K.global_batch,
                  "batch_cut": batch_cut, "cache_slots": slots,
                  "pos": [pos0, pos0 + DECODE_STEPS - 1]},
        "state_gb": b * decode_state_bytes(cfg, quantized, slots) / 1e9,
        "param_gb": param_bytes / 1e9,
        "options": {"param_dtype": opts.param_dtype, "compute_dtype": opts.compute_dtype,
                    "kv_quantized": opts.kv_quantized, "kernel_mode": opts.kernel_mode},
        "ms_a_step": ms, "host_ms_a_step": wall_ms, "tokens_per_s": b / ms * 1e3,
        "launches": launches, "expected_launches": expected,
        "launches_a_step": per_step,
        "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms,
        "profiled_step": prof, "finite": finite,
        "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
        "seconds": time.perf_counter() - t_start,
    }
    emit(res)
    name = f"{cfg.name} {res['cache']}"
    check(finite and logits.shape == (b, 1, cfg.vocab_size), f"{name} decode timing: logits")
    check(launches == expected, f"{name} decode timing: launches {launches} != {expected}")
    for kind, n in per_step.items():
        if n:
            check(prof["device_ms_by_kind"][kind] > 0, f"{name}: no {kind} device time in a step")
    del cache, logits, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_decode() -> dict:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = {"correctness": {arch: decode_correctness(arch, cfg=depth_cut(arch, DECODE_CHECK_DEPTH))
                           for arch in SERVE_ARCHS}}
    res["timing"] = [r for arch in SERVE_ARCHS for r in decode_timings(arch)]
    res["wall_s"] = time.perf_counter() - t0
    launches = dict.fromkeys(kernel_counters(), 0)
    for r in res["timing"]:
        for n, v in r["launches"].items():
            launches[n] += v
    res["launches"] = launches
    emit({"phase": "decode", "wall_s": res["wall_s"], "timed_launches": launches})
    return res


# ---------------------------------------------------------------------------
# phase 10: MoE
# ---------------------------------------------------------------------------


def depth_cut(arch: str, n_layers: int):
    """The registry's config of ``arch`` at full width, ``n_layers`` deep."""
    from repro_torch.configs import get_config

    return replace(get_config(arch), n_layers=n_layers)


def phase_moe() -> dict:
    """The MoE family at full width, depth cut to fit one card: a
    mixtral-8x22b service (depth 4, fp32 params) beside gemma-2b on one
    ``SalusExecutor`` (the serve phase's checks and profile, dispatch as a
    kind of its own); prefill parity of mixtral at (1, 6144) (its 4096
    window binds and the ring is rolled) and of qwen3-moe-235b-a22b (depth
    4, 128 experts top-8, qk-norm) at (1, 512), kernels against plain in
    bf16 and fp32 with the dropped assignments of each run; mixtral's
    decode checks (token 511 against a full forward in groups of 8, which
    drop nothing; 16 greedy tokens from a 4104-token prompt that fills and
    wraps the ring; the int8 cache); and a timed mixtral decode step at
    depth 8, bf16 params, a random bf16 ring cache at batch 64."""
    from repro_torch.configs import DECODE_32K
    from repro_torch.models import build_model
    from repro_torch.train.runtime import model_options_for

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emit({"phase": "moe", "part": "start"})  # the serve, parity and decode lines below
    mixtral = depth_cut(MOE_ARCH, MOE_DEPTH)
    res = {"serve": phase_serve([MOE_ARCH, "gemma-2b"], {MOE_ARCH: mixtral},
                                kinds=MOE_KERNEL_KINDS)}
    res["parity"] = [
        # the plain path's queries in chunks of 1024 (its scores' memory)
        phase_parity(MOE_ARCH, MOE_PARITY_PROMPT, cfg=mixtral, attn_q_chunk=1024),
        phase_parity(QWEN3_MOE_ARCH, 512, cfg=depth_cut(QWEN3_MOE_ARCH, MOE_DEPTH)),
    ]
    res["decode"] = decode_correctness(MOE_ARCH, cfg=mixtral, one_step_opts={"moe_group": 8},
                                       greedy_prompt=MOE_RING_PROMPT)
    timed = depth_cut(MOE_ARCH, MOE_TIMING_DEPTH)
    opts = replace(model_options_for(timed, DECODE_32K), kv_quantized=False)
    params = build_model(timed, opts).init(torch.Generator(device="cuda").manual_seed(19))
    res["timing"] = decode_timing(timed, opts, params, batch=MOE_DECODE_BATCH,
                                  kinds=MOE_KERNEL_KINDS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    emit({"phase": "moe", "part": "end", "wall_s": res["wall_s"],
          "peak_gb": torch.cuda.max_memory_allocated() / 2**30})
    return res


# ---------------------------------------------------------------------------
# phase 11: the last three families (hybrid, audio, vlm)
# ---------------------------------------------------------------------------


def hymba_prefill_profile() -> dict:
    """One hymba-1.5b prefill of a (1, HYMBA_PROMPT) prompt at full width
    and depth, bf16 compute through the kernels, under the profiler: its
    device time by kind and the share of the kernels its SSM branch and
    scan launch (``ssm_spans``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(HYMBA_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = build_model(cfg).init(gen)
    batch = model_inputs(cfg, 1, HYMBA_PROMPT, gen)
    model = build_model(cfg)
    model.prefill(params, batch)  # warm-up
    sync()
    prof = profiled(lambda: model.prefill(params, batch))
    res = {"phase": "families", "part": "hymba_prefill_profile", "prompt": [1, HYMBA_PROMPT],
           "ssm_chunk": model.opts.ssm_chunk, **prof}
    emit(res)
    check(prof.get("span_device_ms", {}).get("ssm_scan", 0) > 0,
          "hymba prefill: no device time inside the SSM scan's span")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_families() -> dict:
    """The families no earlier phase runs, at full width: hymba-1.5b
    (hybrid: attention under a 1024 window beside parallel SSM heads) at
    full depth, served beside gemma-2b through ``launch.serve`` (the serve
    cell's traffic, SSM chunks of 8), prefill parity at (1, 2560) in bf16
    and fp32, a profiled (1, 2560) prefill (the SSM scan's share), the
    decode checks, ``DECODE_CHECK_DEPTH`` layers deep (token 511 against
    the full forward; 16 greedy tokens
    from 2560 across the ring's wrap; the int8 cache) and a timed decode
    step at DECODE_32K's positions, batch 128, bf16 params and ring;
    musicgen-medium (audio: frame embeddings, no embedding table) at full
    depth, prefill parity at (1, 2048), the decode step fed a frame
    embedding, and a timed step at DECODE_32K with a bf16 cache, the
    batch cut to 40 GB; qwen2-vl-72b (vlm: 256 patch embeddings spliced
    over the first tokens, M-RoPE on grid ids) at 4 of 80 layers,
    prefill parity at (1, 1024) and the decode step fed (1, 3, 1) ids."""
    from repro_torch.configs import DECODE_32K, get_config
    from repro_torch.models import build_model
    from repro_torch.train.runtime import model_options_for

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emit({"phase": "families", "part": "start"})  # the serve, parity and decode lines below
    res = {"serve": phase_serve([HYMBA_ARCH, "gemma-2b"])}
    hymba_serve = res["serve"]["services"][HYMBA_ARCH]["profiled_request"]
    check(hymba_serve.get("span_device_ms", {}).get("ssm_scan", 0) > 0,
          "hymba request: no device time inside the SSM scan's span")
    qwen2_vl = depth_cut(QWEN2_VL_ARCH, QWEN2_VL_DEPTH)
    res["parity"] = [
        phase_parity(HYMBA_ARCH, HYMBA_PROMPT),
        phase_parity(MUSICGEN_ARCH, MUSICGEN_PROMPT),
        phase_parity(QWEN2_VL_ARCH, QWEN2_VL_PROMPT, cfg=qwen2_vl),
    ]
    res["hymba_prefill_profile"] = hymba_prefill_profile()
    res["decode"] = [
        decode_correctness(HYMBA_ARCH, cfg=depth_cut(HYMBA_ARCH, DECODE_CHECK_DEPTH),
                           greedy_prompt=HYMBA_PROMPT),
        decode_correctness(MUSICGEN_ARCH),
        decode_correctness(QWEN2_VL_ARCH, cfg=qwen2_vl),
    ]
    res["timing"] = []
    for arch, batch in ((HYMBA_ARCH, HYMBA_DECODE_BATCH), (MUSICGEN_ARCH, None)):
        cfg = get_config(arch)
        # bf16 caches: the path through K3 (an int8 cache takes the plain scan)
        opts = replace(model_options_for(cfg, DECODE_32K), kv_quantized=False)
        params = build_model(cfg, opts).init(torch.Generator(device="cuda").manual_seed(19))
        res["timing"].append(decode_timing(cfg, opts, params, batch=batch))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    check(res["timing"][0]["profiled_step"].get("span_device_ms", {}).get("ssm_branch", 0) > 0,
          "hymba decode step: no device time inside the SSM branch's span")
    res["wall_s"] = time.perf_counter() - t0
    emit({"phase": "families", "part": "end", "wall_s": res["wall_s"],
          "peak_gb": torch.cuda.max_memory_allocated() / 2**30})
    return res


# ---------------------------------------------------------------------------
# phase 12: differential — the live executor against the port's Simulator
# ---------------------------------------------------------------------------

DIFF_ARCH = "gemma-2b"
DIFF_POLICIES = ("fifo", "srtf", "fair")
# D1's three sessions: prefill requests each, and declared seconds an
# iteration (distinct, so that SRTF's and FAIR's picks depend on them)
DIFF_ITERS = (3, 2, 3)
DIFF_ITER_TIMES = (0.03, 0.05, 0.02)
# D2's arrivals: two services' request streams and a background trainer's
# iteration count, from the port's request_trace; the services take the
# trace's request times and iteration times, the trainer its iterations
DIFF_TRACE = dict(n_services=2, seed=0, rps=4.0, duration=2.0, names=["resnet50_25"],
                  train_background="resnet50_25", train_iters=8)
DIFF_OPEN_CAPACITY_GB = 76  # two fp32 services and the trainer's step, no paging


def nominal_replay(sessions, capacity: int, policy: str, memory) -> dict:
    """Each lane's iteration order when a nominal ``SalusExecutor`` on the
    CPU runs stand-in sessions of the same JobSpecs (a step that returns
    its state): under nominal accounting the order is a function of the
    JobSpecs alone."""
    from repro_torch.core import SalusExecutor, Session, get_policy

    cpu = torch.device("cpu")
    ex = SalusExecutor(capacity, get_policy(policy), memory=memory, accounting="nominal",
                       device=cpu)
    names = {}
    for j in (s.job for s in sessions):
        stub = Session(j.name, lambda state, batch: state, torch.zeros(1), lambda i: None,
                       j.n_iters, profile=j.profile, iter_time=j.iter_time,
                       utilization=j.utilization, arrival_time=j.arrival_time, kind=j.kind,
                       priority=j.priority, request_times=j.request_times, device=cpu)
        names[stub.job.job_id] = j.name
        ex.submit(stub)
    return lane_orders(ex.run().records, names)


def lane_orders(records, names: dict) -> dict:
    """Each lane's iterations in the order they ran, as (job name, index)."""
    lanes = {}
    for r in records:
        lanes.setdefault(r.lane_id, []).append((names[r.job_id], r.index))
    return lanes


def drive_executor(ex, vdev, sessions, policy: str, counters: dict) -> dict:
    """Run the executor: on the card under ``profiled`` (the device's busy
    share of the run's wall time) with the kernels' launch counts zeroed
    just before and read just after. Then hold its decision log, the order
    of iterations in each lane and the request latencies against the port's
    ``Simulator`` run on the sessions' own JobSpecs (measured profiles,
    declared iteration times, request streams; raises on a difference), and
    return its page moves as (kind, session, seconds, GB, GB/s)."""
    from repro_torch.core import MemoryEventKind, Simulator, get_policy

    zero_counts(counters)
    out = {}

    def go():
        out["report"] = vdev.run()

    if ex.device.type == "cuda":
        busy = profiled(go)
        busy = {k: busy[k] for k in ("wall_ms", "device_ms", "device_busy_share")}
    else:
        go()
        busy = None
    report = out["report"]
    launches = {name: fn.launches for name, fn in counters.items()}
    check(not report.failures, f"differential {policy}: failures {report.failures}")
    names = {s.job.job_id: s.name for s in sessions}
    for s in sessions:
        st = report.stats[s.job.job_id]
        check(st.iterations_done == s.n_iters and s.finished,
              f"differential {policy}: {s.name} ran {st.iterations_done} of {s.n_iters}")
    sim = Simulator(ex.registry.capacity, get_policy(policy), memory=ex.memory.config).run(
        [s.job for s in sessions])
    check(list(report.decision_log) == list(sim.decision_log),
          f"differential {policy}: decision log {list(report.decision_log)} != the "
          f"Simulator's {list(sim.decision_log)}")
    lanes, sim_lanes = lane_orders(report.records, names), lane_orders(sim.records, names)
    if policy == "fair":
        # FAIR equalises service rates. The Simulator's service includes
        # the modeled page-in delay, the nominal executor's only declared
        # iteration times, so near ties inside a lane may resolve apart:
        # the JAX package's two engines differ so on this run too, and its
        # differential suite holds FAIR to the lane's iterations, not their
        # order. The order is held against the nominal executor's replay of
        # the same JobSpecs on the CPU: the card's timing took no decision.
        same = {k: sorted(v) for k, v in lanes.items()} == {
            k: sorted(v) for k, v in sim_lanes.items()}
        check(same, f"differential fair: lane iterations {lanes} != {sim_lanes}")
        replay = nominal_replay(sessions, ex.registry.capacity, policy, ex.memory.config)
        check(lanes == replay, f"differential fair: lane order {lanes} != the replay's {replay}")
    else:
        check(lanes == sim_lanes, f"differential {policy}: lane order {lanes} != {sim_lanes}")
    lat = {names[j]: st.request_latencies for j, st in report.stats.items()}
    sim_lat = {names[j]: st.request_latencies for j, st in sim.stats.items()}
    check(set(lat) == set(sim_lat) and all(
        len(lat[n]) == len(sim_lat[n])
        and all(abs(a - b) <= 1e-9 for a, b in zip(lat[n], sim_lat[n])) for n in lat),
        f"differential {policy}: request latencies {lat} != the Simulator's {sim_lat}")
    moves = []
    for ev in report.memory_events:
        if ev.kind in (MemoryEventKind.PAGE_OUT, MemoryEventKind.PAGE_IN):
            gb = (ev.nbytes or ev.job.profile.persistent) / 1e9
            moves.append({"kind": ev.kind.value, "session": ev.name, "s": ev.cost, "gb": gb,
                          "gb_per_s": gb / ev.cost if ev.cost else None})
    return {"policy": policy, "decision_log": list(report.decision_log), "lanes": lanes,
            "page_moves": moves, "launches": launches, "busy": busy, "report": report}


def differential_closed_loop(cfg, dev, policy: str, counters: dict) -> dict:
    """D1: three sessions of ``cfg`` on one ``SalusExecutor`` (nominal
    accounting, paging on), each the serve driver's (4, 16) prefill handle
    on params from its own seed (``make_service`` seeds by name), with its
    measured ``profile_step`` profile and a declared iteration time. The
    capacity holds two sessions' persistent bytes and the largest
    ephemeral, so the third's arrival pages one out. Checks (raising):
    the Simulator's decisions and lane order (``drive_executor``), a
    page-out and page-in, every session's tokens equal to those of its
    params before they were handed over, bit for bit, and on the card the
    page-out freeing 0.99 of the victim's persistent bytes."""
    from repro_torch.core import MemoryConfig, SalusExecutor, VirtualDevice, get_policy
    from repro_torch.core.profiles import profile_step
    from repro_torch.core.session import synchronize
    from repro_torch.launch import serve

    specs = []
    for i, (n, iter_time) in enumerate(zip(DIFF_ITERS, DIFF_ITER_TIMES)):
        name = f"{cfg.name}#{i}"
        handle, params, data_fn = serve.make_service(name, smoke=False, device=dev, cfg=cfg)
        with torch.no_grad():
            before = [handle(params, data_fn(k))[1]["next_token"].cpu() for k in range(n)]
        specs.append({"name": name, "handle": handle, "params": params, "data_fn": data_fn,
                      "n": n, "iter_time": iter_time, "before": before,
                      "profile": profile_step(handle, params, data_fn(0), dev)})
        del params
    persistent = sorted(s["profile"].persistent for s in specs)
    capacity = persistent[-1] + persistent[-2] + max(s["profile"].ephemeral for s in specs)
    ex = SalusExecutor(capacity, get_policy(policy), memory=MemoryConfig(paging=True),
                       accounting="nominal", device=dev)
    vdev = VirtualDevice(ex)
    sessions, allocated = [], []
    for spec in specs:
        state = spec.pop("params")  # the session holds the only reference
        synchronize(dev)
        if dev.type == "cuda":
            allocated.append(torch.cuda.memory_allocated(dev))
        sessions.append(vdev.create_session(spec["name"], spec["handle"], state, spec["data_fn"],
                                            n_iters=spec["n"], profile=spec["profile"],
                                            iter_time=spec["iter_time"]))
        del state
    synchronize(dev)
    freed = allocated[-1] - torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    res = drive_executor(ex, vdev, sessions, policy, counters)
    kinds = [(k, name) for k, _o, name, _l in res["decision_log"]]
    paged = [name for k, name in kinds if k == "page_out"]
    check(bool(paged) and any(k == "page_in" for k, _ in kinds),
          f"differential {policy}: no page-out/page-in pair: {kinds}")
    for spec, sess in zip(specs, sessions):
        after = [m["next_token"].cpu() for m in sess.metrics_log]
        check(len(after) == spec["n"] and all(torch.equal(a, b)
                                              for a, b in zip(after, spec["before"])),
              f"differential {policy}: {sess.name}'s tokens changed: {spec['before']} -> {after}")
    victim = next(s for s in specs if s["name"] == paged[0])["profile"].persistent
    if freed is not None:
        check(freed >= 0.99 * victim,
              f"differential {policy}: the page-out freed {freed} of {victim} bytes")
    res.update(capacity_gb=capacity / 2**30, persistent_gb=[p / 2**30 for p in persistent],
               ephemeral_gb=[s["profile"].ephemeral / 2**30 for s in specs],
               freed_by_arrival_page_out_gb=None if freed is None else freed / 2**30,
               victim_persistent_gb=victim / 2**30,
               expected_launches={n: per * sum(DIFF_ITERS)
                                  for n, per in launches_per_request(cfg).items()})
    return res


def differential_open_loop(cfg, smoke: bool, dev, counters: dict) -> dict:
    """D2, the Fig. 9/10 regime: two services of ``cfg`` on the request
    streams of the port's ``request_trace`` (``DIFF_TRACE``) and a
    background SGD trainer of the same arch (``make_trainer``, its
    iteration count from the trace) under PRIORITY, nominal accounting,
    no paging. Every request served, the trainer's iterations all run,
    and ``drive_executor``'s checks."""
    from repro_torch.core import SalusExecutor, VirtualDevice, get_policy
    from repro_torch.core.profiles import profile_step
    from repro_torch.core.tracegen import request_trace
    from repro_torch.launch import serve

    trace = request_trace(**DIFF_TRACE)
    ex = SalusExecutor(int(DIFF_OPEN_CAPACITY_GB * 2**30), get_policy("priority"),
                       accounting="nominal", device=dev)
    vdev = VirtualDevice(ex)
    sessions = []
    for i, job in enumerate(j for j in trace if j.kind == "inference"):
        name = f"svc{i}:{cfg.name}"
        handle, params, data_fn = serve.make_service(name, smoke=False, device=dev, cfg=cfg)
        prof = profile_step(handle, params, data_fn(0), dev)
        sessions.append(vdev.create_session(
            name, handle, params, data_fn, n_iters=job.n_iters, profile=prof, kind="inference",
            utilization=job.utilization, iter_time=job.iter_time,
            request_times=job.request_times))
        del params
    train = next(j for j in trace if j.kind == "train")
    step, params, data_fn = serve.make_trainer(DIFF_ARCH, smoke, device=dev)
    prof = profile_step(step, params, data_fn(0), dev)
    sessions.append(vdev.create_session(
        f"train:{cfg.name}", step, params, data_fn, n_iters=train.n_iters, profile=prof,
        kind="train", utilization=train.utilization, iter_time=train.iter_time))
    del params
    res = drive_executor(ex, vdev, sessions, "priority", counters)
    trainer = res["report"].stats[sessions[-1].job.job_id]
    losses = [float(m["loss"]) for m in sessions[-1].metrics_log]
    check(all(math.isfinite(x) for x in losses), f"differential trainer losses {losses}")
    per_req, per_step = launches_per_request(cfg), launches_per_microbatch(cfg)
    requests = sum(s.n_iters for s in sessions[:-1])
    res.update(requests=requests, trainer_iterations=trainer.iterations_done,
               trainer_preemptions=trainer.preemptions, losses=losses,
               latency_ms=[x * 1e3 for x in res["report"].request_latencies],
               expected_launches={n: per_req.get(n, 0) * requests
                                  + per_step[n] * trainer.iterations_done for n in per_step})
    return res


def phase_differential(paging_res: dict) -> dict:
    """The live ``SalusExecutor`` on the card against the port's own
    ``Simulator``: D1 (closed loop with paging, FIFO, SRTF and FAIR) and
    D2 (open loop under PRIORITY with a background trainer), gemma-2b at
    full width and depth in fp32, every session through K1 and K3. Its
    page moves are printed beside the paging phase's (``paging_res``)."""
    from repro_torch.configs import get_config

    if not torch.cuda.is_available():
        raise RuntimeError("the differential phase runs on the card")
    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi()
    cfg = get_config(DIFF_ARCH)
    dev = torch.device("cuda")
    counters = kernel_counters()
    t0 = time.perf_counter()
    runs = []

    def record(r: dict) -> None:
        del r["report"]
        emit({"phase": "differential", "nvidia_smi": smi, **r})
        want = {**dict.fromkeys(counters, 0), **r["expected_launches"]}
        check(r["launches"] == want,
              f"differential {r['policy']}: launches {r['launches']} != {want}")
        check(r["launches"]["rmsnorm"] > 0 and r["launches"]["flash_attention"] > 0,
              f"differential {r['policy']}: K1 or K3 never launched")
        runs.append(r)
        gc.collect()
        torch.cuda.empty_cache()

    for policy in DIFF_POLICIES:
        record(differential_closed_loop(cfg, dev, policy, counters))
    record(differential_open_loop(cfg, False, dev, counters))
    wall_s = time.perf_counter() - t0
    res = {"phase": "differential", "part": "end", "nvidia_smi": smi, "wall_s": wall_s,
           "busy_share": {r["policy"]: r["busy"]["device_busy_share"] for r in runs},
           "page_moves": {r["policy"]: r["page_moves"] for r in runs},
           "paging_phase": {k: paging_res[k] for k in ("persistent_gb", "transfer_latencies_s",
                                                       "transfer_gb_per_s")}}
    emit(res)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 13: fleet — three live executors on one card against the port's Cluster
# ---------------------------------------------------------------------------

FLEET_DEVICES = 3
# tests/test_migration.py's SPECS: two long sessions and two of 6 iterations
FLEET_SPECS = (("longA", 40), ("medB", 6), ("medC", 6), ("longD", 40))
FLEET_ITER_TIME = 0.02  # declared seconds an iteration, about a (4, 16) request's
FLEET_INTERVAL = 10 * FLEET_ITER_TIME  # ten iterations an epoch: the JAX test's 0.02 / 0.002
# capacity over the persistent bytes of a session: the JAX test's 16 GB over 2.4 GB
FLEET_CAPACITY = (20, 3)
FLEET_FAIL_AT = 1  # F2: the first migration attempt fails
# the live executor's stats that are wall measurements: the four wall
# stamps, and the seconds a move spent on the host link
FLEET_WALL_STATS = frozenset(
    {"arrival_time", "admit_time", "first_run_time", "finish_time", "transfer_time"})


def fleet_sessions(cfg, dev) -> list:
    """The makings of the fleet's four sessions (``FLEET_SPECS``): the
    serve driver's (4, 16) prefill handle of ``cfg`` on params from its own
    seed (``make_service`` seeds by name), its measured ``profile_step``
    profile, and the tokens each of its requests gives before the params
    are handed over. Between runs a spec keeps the params under
    ``"state"``; a run takes them and hands them back."""
    from repro_torch.core.profiles import profile_step
    from repro_torch.launch import serve

    specs = []
    for name, n in FLEET_SPECS:
        full = f"{cfg.name}:{name}"
        handle, params, data_fn = serve.make_service(full, smoke=False, device=dev, cfg=cfg)
        with torch.no_grad():
            before = [handle(params, data_fn(k))[1]["next_token"].cpu() for k in range(n)]
        specs.append({"name": full, "handle": handle, "state": params, "data_fn": data_fn,
                      "n": n, "before": before,
                      "profile": profile_step(handle, params, data_fn(0), dev)})
        del params
    return specs


def migration_moves(report) -> list:
    """Each migration attempt of a fleet run, in the order the migration
    log holds them: the session, its source and destination, and the
    measured seconds and GB of its page-out (the source's MIGRATE_OUT)
    and page-in (the destination's MIGRATE_IN)."""
    from repro_torch.core import MemoryEventKind

    events = {}
    for d, rep in enumerate(report.device_reports):
        for ev in rep.memory_events:
            if ev.kind in (MemoryEventKind.MIGRATE_OUT, MemoryEventKind.MIGRATE_IN):
                events.setdefault((ev.kind, ev.name, d), []).append(ev)
    moves = []
    for kind, _o, name, src, dst in report.migration_log():
        out = events[(MemoryEventKind.MIGRATE_OUT, name, src)].pop(0)
        inn = events[(MemoryEventKind.MIGRATE_IN, name, dst)].pop(0)
        moves.append({"kind": kind, "session": name, "src": src, "dst": dst,
                      "out_s": out.cost, "out_gb": out.nbytes / 1e9,
                      "in_s": inn.cost, "in_gb": inn.nbytes / 1e9,
                      "out_gb_per_s": out.nbytes / 1e9 / out.cost if out.cost else None,
                      "in_gb_per_s": inn.nbytes / 1e9 / inn.cost if inn.cost else None})
    return moves


def fleet_run(specs, dev, paging: bool, counters: dict, concurrency: str = "threads",
              fail_at=None, busy: bool = False) -> dict:
    """One fleet run: a ``ClusterExecutor`` of ``FLEET_DEVICES`` executors
    on ``dev`` (``"cuda"`` binds executor i to ``cuda:{i % cards}``, so
    with one card all three share it and a migration is a real page-out
    to pinned host memory and a page-in), SRTF, least-loaded placement, a
    consolidating ``Rebalancer`` every ``FLEET_INTERVAL``, nominal
    accounting, paging as given, and ``FailureInjector([fail_at])`` when
    given. The capacity of an executor is ``FLEET_CAPACITY`` times the
    sessions' measured persistent bytes (the JAX test's 16 GB over 2.4
    GB; the measured ephemeral is smaller than the test's, so it does not
    bind). Each session takes its spec's params, the only reference, and
    hands them back after the run. The kernels' launch counts are zeroed
    just before the run and read just after; with ``busy`` on the card the
    run is profiled (the device's busy share of its wall time).
    Checks (raising): the migration log is non-empty, and it, the
    placement log and every device's decision log equal those of the
    port's ``Cluster`` run on the sessions' own JobSpecs; every session
    completes, with no failure; ``len(report.migrations)`` is the number
    of "migrate" entries; every session's tokens, migrated or rolled back
    or not, equal those its params gave before the hand-over, bit for
    bit."""
    from repro_torch.core import Cluster, ClusterExecutor, MemoryConfig, Rebalancer, Session
    from repro_torch.dist.fault import FailureInjector
    from torch.utils import _pytree as pytree

    persistent = max(s["profile"].persistent for s in specs)
    capacity = -(-persistent * FLEET_CAPACITY[0] // FLEET_CAPACITY[1])

    def fleet(cls, **kw):
        return cls(FLEET_DEVICES, capacity, "srtf", strategy="least_loaded",
                   memory=MemoryConfig(paging=paging), rebalancer=Rebalancer(mode="consolidate"),
                   rebalance_interval=FLEET_INTERVAL,
                   fault_injector=FailureInjector([fail_at]) if fail_at else None, **kw)

    tag = f"fleet {concurrency} paging={paging}" + (f" fail_at={fail_at}" if fail_at else "")
    cex = fleet(ClusterExecutor, accounting="nominal", concurrency=concurrency, device=dev)
    sessions = []
    for spec in specs:
        state = spec.pop("state")
        sessions.append(Session(spec["name"], spec["handle"], state, spec["data_fn"], spec["n"],
                                profile=spec["profile"], iter_time=FLEET_ITER_TIME,
                                utilization=1.0, device=dev))
        del state
        cex.submit(sessions[-1])
    out = {}

    def go():
        out["report"] = cex.run()

    zero_counts(counters)
    t0 = time.perf_counter()
    if busy and dev.type == "cuda":
        prof = profiled(go)
        busy_res = {k: prof[k] for k in ("wall_ms", "device_ms", "device_busy_share")}
    else:
        go()
        busy_res = None
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    report = out["report"]
    for spec, sess in zip(specs, sessions):
        # the params go back to the spec, on the card, for the next run
        spec["state"] = pytree.tree_map(
            lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, sess.state)
        sess.state = None
    sim = fleet(Cluster).run([s.job for s in sessions])
    log = report.migration_log()
    check(bool(log), f"{tag}: nothing migrated")
    check(log == sim.migration_log(),
          f"{tag}: migration log {log} != the Cluster's {sim.migration_log()}")
    check(report.placement_log() == sim.placement_log(),
          f"{tag}: placement log {report.placement_log()} != {sim.placement_log()}")
    for d in range(FLEET_DEVICES):
        got, want = report.device_reports[d].decision_log, sim.device_results[d].decision_log
        check(list(got) == list(want), f"{tag}: device {d} decisions {list(got)} != {list(want)}")
    check(not report.failures, f"{tag}: failures {report.failures}")
    check(report.completed == sim.completed == len(sessions),
          f"{tag}: {report.completed} and the Cluster's {sim.completed} completed "
          f"of {len(sessions)}")
    check(len(report.migrations) == sum(e[0] == "migrate" for e in log),
          f"{tag}: {len(report.migrations)} migrations applied for the log {log}")
    for spec, sess in zip(specs, sessions):
        after = [m["next_token"].cpu() for m in sess.metrics_log]
        check(len(after) == spec["n"] and all(torch.equal(a, b)
                                              for a, b in zip(after, spec["before"])),
              f"{tag}: {sess.name}'s tokens changed: {spec['before']} -> {after}")
    names = {s.job.job_id: s.name for s in sessions}
    return {"concurrency": concurrency, "paging": paging, "fail_at": fail_at,
            "capacity_gb": capacity / 1e9, "persistent_gb": persistent / 1e9,
            "ephemeral_gb": [s["profile"].ephemeral / 1e9 for s in specs],
            "placement_log": report.placement_log(), "migration_log": log,
            "decision_logs": [list(r.decision_log) for r in report.device_reports],
            "records": [[(names[r.job_id], r.index, r.lane_id) for r in rep.records]
                        for rep in report.device_reports],
            "stats": {names[j]: {k: v for k, v in vars(st).items()
                                 if k not in FLEET_WALL_STATS}
                      for j, st in report.stats.items()},
            "moves": migration_moves(report), "launches": launches, "busy": busy_res,
            "wall_s": wall_s, "iterations": sum(s["n"] for s in specs)}


def fleet_nominal_equal(a: dict, b: dict) -> None:
    """F3: two fleet runs (threads, sequential) leave the same nominal
    data: placement log, every device's decision log and iteration records
    (session, index, lane), and every per-job stat that is no wall
    measurement (``FLEET_WALL_STATS``). Raises on a difference."""
    for key in ("placement_log", "migration_log", "decision_logs", "records", "stats"):
        check(a[key] == b[key], f"fleet {a['concurrency']} and {b['concurrency']} differ in "
                                f"{key}: {a[key]} != {b[key]}")


def phase_fleet(paging_res: dict, diff_res: dict) -> dict:
    """Salus's live fleet on the card: ``ClusterExecutor`` against the
    port's own ``Cluster``, gemma-2b at full width and depth in fp32, four
    sessions (``FLEET_SPECS``, the shape of
    ``tests/test_migration.py``'s differential) of the serve driver's (4,
    16) prefill through K1 and K3, each on params from its own seed, with
    measured profiles and a declared ``FLEET_ITER_TIME`` a request.

    Capacity and epoch: an executor holds ``FLEET_CAPACITY`` (20 / 3) times
    a session's measured persistent bytes (10.02 GB: 66.8 GB), the JAX
    test's 16 GB over its 2.4 GB; the measured ephemeral (1.06 GB) is well
    under the test's 4 GB, so bytes never bind and placement and the
    consolidate pass go by load alone, as in the test. tau =
    ``FLEET_INTERVAL`` = ten declared iterations, the test's 0.02 s over
    its 0.002 s. With those, least-loaded placement puts longA, medB and
    medC on one executor each and longD beside medB, and the first
    consolidate pass moves longA beside them; the phase holds whatever
    the ``Cluster`` decides, and fails if nothing migrates.

    F1: the fleet with paging off (profiled: the device's busy share) and
    on; F2: paging off with ``FailureInjector([FLEET_FAIL_AT])``, a logged
    ``migrate_failed`` whose session rolls back to its source; F3: F1's
    paging-on run (threads, the default) against the same fleet under
    ``concurrency="sequential"``, identical in their nominal data
    (``fleet_nominal_equal``). ``fleet_run``'s checks in every run, and
    exact K1/K3 launch counts (zeroed just before each run). Each
    migration's page-out and page-in seconds and GB are printed beside the
    paging phase's round trip (``paging_res``) and the differential
    phase's page moves (``diff_res``), with the card and its power limit."""
    from repro_torch.configs import get_config

    if not torch.cuda.is_available():
        raise RuntimeError("the fleet phase runs on the card")
    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi()
    cfg = get_config(DIFF_ARCH)
    dev = torch.device("cuda")
    counters = kernel_counters()
    per_req = launches_per_request(cfg)
    t0 = time.perf_counter()
    specs = fleet_sessions(cfg, dev)
    sessions_s = time.perf_counter() - t0
    runs = {}

    def record(key: str, r: dict) -> None:
        emit({"phase": "fleet", "run": key, "nvidia_smi": smi,
              **{k: v for k, v in r.items() if k not in ("records", "stats", "decision_logs")}})
        want = {**dict.fromkeys(counters, 0),
                **{n: per * r["iterations"] for n, per in per_req.items()}}
        check(r["launches"] == want, f"fleet {key}: launches {r['launches']} != {want}")
        check(r["launches"]["rmsnorm"] > 0 and r["launches"]["flash_attention"] > 0,
              f"fleet {key}: K1 or K3 never launched")
        runs[key] = r

    record("F1 paging off", fleet_run(specs, dev, False, counters, busy=True))
    record("F1 paging on", fleet_run(specs, dev, True, counters))
    f2 = fleet_run(specs, dev, False, counters, fail_at=FLEET_FAIL_AT)
    check(any(e[0] == "migrate_failed" for e in f2["migration_log"]),
          f"fleet F2: no migrate_failed in {f2['migration_log']}")
    record("F2 failure", f2)
    record("F3 sequential", fleet_run(specs, dev, True, counters, concurrency="sequential"))
    fleet_nominal_equal(runs["F1 paging on"], runs["F3 sequential"])
    del specs
    gc.collect()
    torch.cuda.empty_cache()
    moves = [{"run": key, **m} for key, r in runs.items() for m in r["moves"]]
    res = {"phase": "fleet", "part": "end", "nvidia_smi": smi,
           "wall_s": time.perf_counter() - t0, "sessions_s": sessions_s,
           "run_wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "busy_f1": runs["F1 paging off"]["busy"],
           # the profiler slows the run it traces: the same device time over
           # the wall time of F1's unprofiled run (paging on, the same work)
           "busy_f1_over_unprofiled_wall": runs["F1 paging off"]["busy"]["device_ms"]
           / (1e3 * runs["F1 paging on"]["wall_s"]),
           "first_out_s": moves[0]["out_s"], "later_out_s": [m["out_s"] for m in moves[1:]],
           "in_s": [m["in_s"] for m in moves], "moves": moves,
           "launches": {k: r["launches"] for k, r in runs.items()},
           "paging_phase": {k: paging_res[k] for k in ("persistent_gb", "transfer_latencies_s",
                                                       "transfer_gb_per_s")},
           "differential_page_moves": diff_res["page_moves"]}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 14: checkpoints, elastic restore, migration through a checkpoint,
# gradient compression
# ---------------------------------------------------------------------------

# gemma-2b at full width, 1 of 18 layers (phase_ckpt, and the cli phase's
# resume): a checkpoint of 7.61 GB, 2 layers' 8.94 less the room phase
# families_train needs in the script's time
CKPT_DEPTH = 1
CKPT_STEPS = 4
CKPT_FAIL_AT = 2  # run B is killed as it reaches this step
CKPT_KEEP = 2
CKPT_MIN_FREE_GB = 30
CKPT_SEED = 25
CKPT_ITER_TIME = 0.02  # declared seconds an iteration (nominal accounting)
CKPT_BLOCK = 256  # the compressor's block


def meta_template(tree):
    """Shapes and dtypes of ``tree`` on the meta device (a restore's
    template: no bytes)."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def trees_equal(a, b) -> bool:
    """Leaf for leaf, bit for bit (``DTensor`` leaves by their local
    piece)."""
    from torch.utils import _pytree as pytree

    local = lambda t: t.to_local() if hasattr(t, "to_local") else t
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(local(x), local(y)) for x, y in zip(la, lb))


def overlapped(spans, writes) -> bool:
    """Whether any step span overlapped a checkpoint write in flight."""
    return any(s0 < w["end"] and w["start"] < s1 for s0, s1 in spans for w in writes)


def ckpt_runs(cfg, shape, model, run, ocfg, dev, mesh, workdir: str) -> dict:
    """The ``ckpt`` phase's runs on ``dev`` and the one-device ``mesh``
    (``phase_ckpt`` says what each holds), with their checks; also runs
    on the CPU at a smoke config beside a gloo group of one rank."""
    from pathlib import Path

    from torch.utils import _pytree as pytree

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core import GB, SalusExecutor, Session, get_policy, profile_model
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.api import place
    from repro_torch.dist.elastic import restore_on_mesh
    from repro_torch.dist.fault import FailureInjector, RestartSupervisor
    from repro_torch.dist.sharding import batch_shardings, param_shardings
    from repro_torch.train.grad_compress import ErrorFeedbackCompressor, compress, wire_bytes
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import (
        is_sharded,
        make_train_step,
        stack_grads,
        value_and_grad,
    )

    opt = AdamW(ocfg)
    step = make_train_step(model, opt, run)
    pipe = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch, seed=0)
    data_fn = lambda i: {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(i).items()}
    b_sh = batch_shardings(cfg, shape, mesh)
    counters = kernel_counters()
    per_mb = launches_per_microbatch(cfg)
    per_step = {k: run.num_microbatches * v for k, v in per_mb.items()}
    launches = {}

    def fresh():
        params = model.init(torch.Generator(device=dev).manual_seed(CKPT_SEED))
        return params, opt.init(params)

    def on_mesh(tree):
        return place(tree, param_shardings(tree, cfg, mesh))

    def train(state, batch):  # plain tensors, or DTensors on the mesh
        if is_sharded(state[0]):
            batch = place(batch, b_sh)
        params, opt_state, metrics = step(state[0], state[1], batch)
        return (params, opt_state), metrics

    def counted(key: str, n_steps: int, fn, per=per_step):
        zero_counts(counters)
        out = fn()
        sync()
        launches[key] = got = {name: c.launches for name, c in counters.items()}
        want = {k: n_steps * v for k, v in per.items()}
        check(got == want, f"ckpt {key}: launches {got} != {want}")
        return out

    # A: uninterrupted, on the mesh
    def run_a():
        state, losses = on_mesh(fresh()), []
        for i in range(CKPT_STEPS):
            state, m = train(state, data_fn(i))
            losses.append(float(m["loss"]))
        return state, losses

    state_a, losses_a = counted("A", CKPT_STEPS, run_a)
    check(all(math.isfinite(x) for x in losses_a), f"ckpt A: losses {losses_a}")

    # B: saved after every step, killed at CKPT_FAIL_AT, restored onto the mesh
    mgr = CheckpointManager(str(Path(workdir) / "B"), keep=CKPT_KEEP)
    injector, sup = FailureInjector([CKPT_FAIL_AT]), RestartSupervisor(max_restarts=1)
    b = {"losses": {}, "spans": [], "save_s": [], "restore": None}

    def resume() -> int:
        mgr.wait()  # drain the writes in flight before picking the latest
        latest = mgr.latest_step()
        if latest is None:
            b["state"] = on_mesh(fresh())
            return 0
        template = meta_template(b["state"])  # the lost state's shapes only
        b["state"] = None
        gc.collect()
        t0 = time.perf_counter()
        got, b["state"], _ = restore_on_mesh(mgr, template, cfg, mesh)
        sync()
        nbytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(b["state"]))
        b["restore"] = {"step": got, "s": time.perf_counter() - t0, "gb": nbytes / 1e9}
        return got

    def body(start: int) -> int:
        for i in range(start, CKPT_STEPS):
            injector.maybe_fail(i)
            t0 = time.perf_counter()
            b["state"], m = train(b["state"], data_fn(i))
            b["losses"][i] = float(m["loss"])  # waits for the step
            b["spans"].append((t0, time.perf_counter()))
            t0 = time.perf_counter()
            mgr.save(i + 1, b["state"])
            b["save_s"].append(time.perf_counter() - t0)
        mgr.wait()
        return CKPT_STEPS

    counted("B", CKPT_STEPS, lambda: sup.run(body, resume))
    losses_b = [b["losses"][i] for i in range(CKPT_STEPS)]
    check(sup.restarts == 1 and b["restore"]["step"] == CKPT_FAIL_AT,
          f"ckpt B: {sup.restarts} restarts, restored {b['restore']}")
    check(losses_b == losses_a, f"ckpt B: losses {losses_b} != A's {losses_a}")
    check(trees_equal(b["state"], state_a), "ckpt B: params or state differ from A's")
    left = sorted(p.name for p in mgr.dir.iterdir())
    check(left == [f"step_{s:08d}" for s in range(CKPT_STEPS - CKPT_KEEP + 1, CKPT_STEPS + 1)],
          f"ckpt B: {left} left in the checkpoint directory")
    writes = [{"step": w["step"], "s": w["end"] - w["start"], "gb": w["bytes"] / 1e9,
               "gb_per_s": w["bytes"] / 1e9 / (w["end"] - w["start"])} for w in mgr.writes]
    overlap = overlapped(b["spans"], mgr.writes)
    del state_a, b["state"]
    gc.collect()

    # C: a trainer session migrated between two executors through a checkpoint
    params, opt_state = fresh()
    prof = profile_model(model, params, data_fn(0), opt, run)
    del params, opt_state
    mgr_c = CheckpointManager(str(Path(workdir) / "C"), keep=CKPT_KEEP)

    def executor():
        return SalusExecutor(int(76 * GB), get_policy("fifo"), accounting="nominal", device=dev)

    def session(name):
        return Session(name, train, fresh(), data_fn, CKPT_STEPS, profile=prof,
                       iter_time=CKPT_ITER_TIME, device=dev)

    c = {}

    def run_c():
        ex0, ex1, ex2 = executor(), executor(), executor()
        still = session(f"{cfg.name}:stays")
        ex0.submit(still)
        check(not ex0.run().failures, "ckpt C: the unmigrated session failed")
        moved = session(f"{cfg.name}:moves")
        ex1.submit(moved)
        ex1.run_epoch(until=1.5 * CKPT_ITER_TIME)  # two iterations, then the boundary
        check(moved.iterations_run == CKPT_FAIL_AT, f"ckpt C: {moved.iterations_run} iterations "
                                                    f"before the migration")
        sess, stats, delay = ex1.migrate_out(moved.job.job_id)
        t0 = time.perf_counter()
        mgr_c.save(CKPT_FAIL_AT, sess.state)
        mgr_c.wait()
        c["save_and_write_s"] = time.perf_counter() - t0
        put = lambda tree: restore_on_mesh(mgr_c, meta_template(tree), cfg, mesh,
                                           step=CKPT_FAIL_AT)[1]
        ex2.migrate_in(sess, stats, delay, put_fn=put)
        c["in_s"] = ex2.transfer_latencies[-1]
        check(not ex2.run().failures, "ckpt C: the migrated session failed")
        return still, moved

    still, moved = counted("C", 2 * CKPT_STEPS, run_c)
    losses_c = [[float(m["loss"]) for m in s.metrics_log] for s in (still, moved)]
    check(is_sharded(moved.state[0]), "ckpt C: the migrated session's state is not on the mesh")
    check(losses_c[0] == losses_c[1] == losses_a,
          f"ckpt C: losses {losses_c} (stays, moves) != A's {losses_a}")
    check(trees_equal(moved.state, still.state), "ckpt C: the migrated session's state differs")
    del still, moved
    gc.collect()

    # D: int8 error-feedback compression of one gradient tree
    params, opt_state = fresh()
    one = SyntheticLM(cfg.vocab_size, shape.seq_len, 1, seed=1).batch(0)
    one = {k: torch.from_numpy(v).to(dev) for k, v in one.items()}

    def grad_pass():
        loss, g = value_and_grad(model, params, one)
        return loss, stack_grads(g)

    loss_d, grads = counted("D", 1, grad_pass, per=per_mb)
    comp = ErrorFeedbackCompressor(CKPT_BLOCK)
    resid = comp.init(grads)
    sync()
    t0 = time.perf_counter()
    deq, new_r = comp.apply(grads, resid)
    sync()
    apply_ms = 1e3 * (time.perf_counter() - t0)
    worst, floored, residual_exact = 0.0, 0, True
    for g, d, r in zip(*(pytree.tree_leaves(t) for t in (grads, deq, new_r))):
        pad = (-g.numel()) % CKPT_BLOCK
        blocks = torch.nn.functional.pad(g.reshape(-1), (0, pad)).reshape(-1, CKPT_BLOCK)
        err = torch.nn.functional.pad((d - g).abs().reshape(-1), (0, pad)).reshape(-1, CKPT_BLOCK)
        # half the block's scale, max|x| / 254, or half the scale's floor
        # 1e-12 where max|x| is under 1.27e-10
        scale = blocks.abs().amax(dim=1) / 127
        floored += int((scale < 1e-12).sum())
        worst = max(worst, float((err.amax(dim=1) / (torch.clamp(scale, min=1e-12) / 2)).max()))
        residual_exact &= torch.equal(r, g.float() - d)
    embed = grads["embed"]["table"]
    t0 = time.perf_counter()
    on_card = compress(embed, CKPT_BLOCK)
    sync()
    compress_ms = 1e3 * (time.perf_counter() - t0)
    on_cpu = compress(embed.cpu(), CKPT_BLOCK)
    payload_equal = torch.equal(on_card["q"].cpu(), on_cpu["q"]) and torch.equal(
        on_card["scale"].cpu().view(torch.int32), on_cpu["scale"].view(torch.int32))
    full, wire = wire_bytes(grads, False, CKPT_BLOCK), wire_bytes(grads, True, CKPT_BLOCK)
    del on_card, on_cpu, resid, new_r, grads
    _, _, metrics_d = opt.update(deq, opt_state, params)
    del deq
    params_finite = all(bool(torch.isfinite(t).all()) for t in pytree.tree_leaves(params))
    loss_after = counted("D_step", 1, lambda: grad_pass()[0], per=per_mb)  # after the step
    check(worst <= 1 + 1e-4, f"ckpt D: an element {worst} x its block's max|x|/254 off "
                             f"({floored} blocks at the scale floor)")
    check(residual_exact, "ckpt D: the residual is not corrected - deq")
    check(payload_equal, "ckpt D: the embedding gradient's payload differs from the CPU's")
    check(4 * CKPT_BLOCK * wire == (CKPT_BLOCK + 4) * full,  # 1/4 + 1/block
          f"ckpt D: wire bytes {wire} over {full} != 0.25 + 1/{CKPT_BLOCK}")
    check(math.isfinite(float(loss_after)) and params_finite and int(metrics_d["step"]) == 1,
          f"ckpt D: loss after the step {float(loss_after)}, params finite {params_finite}")
    del params, opt_state
    gc.collect()
    return {
        "losses": losses_a, "launches": launches, "launches_per_step": per_step,
        "restarts": sup.restarts, "left": left,
        "save_return_s": b["save_s"], "writes": writes, "step_overlapped_write": overlap,
        "step_s": [s1 - s0 for s0, s1 in b["spans"]], "restore": b["restore"],
        "migration": {**c, "checkpoint_gb": mgr_c.writes[-1]["bytes"] / 1e9,
                      "write_s": mgr_c.writes[-1]["end"] - mgr_c.writes[-1]["start"]},
        "compression": {"apply_ms": apply_ms, "embed_compress_ms": compress_ms,
                        "embed_elements": embed.numel(), "worst_err_over_bound": worst,
                        "blocks_at_scale_floor": floored,
                        "residual_exact": residual_exact, "payload_equals_cpu": payload_equal,
                        "wire_ratio": wire / full, "loss": float(loss_d),
                        "loss_after_step": float(loss_after)},
    }


def phase_ckpt() -> dict:
    """Checkpoints, the dist layer and gradient compression on the card:
    gemma-2b at full width, depth cut from 18 to ``CKPT_DEPTH`` layers
    (0.634e9 params: params and fp32 AdamW m and v are 7.61 GB a
    checkpoint, where full depth would write 30 GB to a disk of unknown
    size), fp32 params, the train phase's runtime-table options (4
    microbatches of one 4096-token sequence, remat, bf16 compute) through
    K1, K3, B1 and B2, on a one-rank NCCL group (a ``HashStore``: no
    network) and its (1, 1) ``data, model`` mesh; ``CheckpointManager``
    keeping ``CKPT_KEEP`` in a temporary directory with at least
    ``CKPT_MIN_FREE_GB`` free, removed at the end.

    A: ``CKPT_STEPS`` steps on the mesh from ``CKPT_SEED``. B: the same,
    saved asynchronously after every step, killed at ``CKPT_FAIL_AT`` by
    ``FailureInjector`` under ``RestartSupervisor``; the resume waits for
    the writer, then ``restore_on_mesh`` from a meta-device template, and
    runs the rest: losses, params and AdamW state equal A's bit for bit,
    ``CKPT_KEEP`` step directories and no ``.tmp`` left. C: a trainer
    session on one ``SalusExecutor`` migrated out after ``CKPT_FAIL_AT``
    iterations, saved, and migrated in on a second executor through a
    ``put_fn`` that is ``restore_on_mesh`` of that checkpoint: its losses
    and final state equal an unmigrated session's (plain tensors, not on
    the mesh) bit for bit. D: ``ErrorFeedbackCompressor`` on one
    gradient tree of a (1, 4096) batch: each element within its block's
    max|x|/254 (half its scale; a block under the scale floor 1e-12 within
    half the floor), the residual exactly corrected - deq, the embedding
    gradient's payload equal to the CPU's, wire bytes 0.25 + 1/256 of
    fp32's, and an AdamW step on the compressed gradients after which the
    loss (one more gradient pass, ``D_step``) is finite. The kernels'
    launches are counted a run: the train phase's per-step counts at this
    depth times its steps. Printed with the card and its power limit:
    ``save()``'s return time (the host snapshot), the writer's seconds and
    GB/s and whether a step overlapped a write in flight, the restore's
    seconds and GB/s, the compressor's ms, and the phase's wall time."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    if not torch.cuda.is_available():
        raise RuntimeError("the ckpt phase runs on the card")
    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    cfg, shape, model, run, ocfg = train_model(n_layers=CKPT_DEPTH)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        free_gb = shutil.disk_usage(workdir).free / 1e9
        check(free_gb >= CKPT_MIN_FREE_GB,
              f"{workdir}: {free_gb:.1f} GB free; the ckpt phase needs {CKPT_MIN_FREE_GB}")
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        res = ckpt_runs(cfg, shape, model, run, ocfg, torch.device("cuda"), mesh, workdir)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    res = {"phase": "ckpt", "nvidia_smi": smi, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(), "free_gb": free_gb,
           "microbatches": run.num_microbatches, **res, "wall_s": time.perf_counter() - t0}
    emit(res)
    return res


CLI_STEPS = 3  # the full-depth runs' steps
# the CLI's flags at the train phase's shape: TRAIN_4K, batch 4, 4 microbatches
CLI_SHAPE = ("--seq-len", "4096", "--batch", "4", "--microbatches", "4", "--log-every", "1")
CLI_RESUME_STEPS, CLI_CKPT_EVERY, CLI_FAIL_AT, CLI_MORE_STEPS = 4, 2, 3, 6
EXAMPLES = ("train_lm", "hyperparam_tuning", "inference_packing", "quickstart")


def cli_run(cfg, argv, counters: dict, want: dict) -> dict:
    """One call of the training CLI's loop (``repro_torch.launch.train.run``,
    what its ``main`` hands the parsed flags to) on ``cfg`` with the flags
    ``argv``: its record (each step's loss and seconds, the steps resumed
    from, restarts), its printed lines, its wall seconds, each
    ``restore_on_mesh``'s seconds, and the kernels' launches, which must
    equal ``want``."""
    import contextlib
    import io

    from repro_torch.launch import train as cli

    args = cli.build_parser().parse_args(["--arch", cfg.name, *argv])
    restore, restores = cli.restore_on_mesh, []

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = restore(*a, **k)
        sync()
        restores.append(time.perf_counter() - t0)
        return out

    zero_counts(counters)
    printed = io.StringIO()
    t0 = time.perf_counter()
    cli.restore_on_mesh = timed_restore
    try:
        with contextlib.redirect_stdout(printed):
            rec = cli.run(cfg, args)
        sync()
    finally:
        cli.restore_on_mesh = restore
    rec.update(wall_s=time.perf_counter() - t0, restore_s=restores,
               printed=printed.getvalue().splitlines(),
               launches={name: c.launches for name, c in counters.items()})
    check(rec["launches"] == want, f"cli {argv}: launches {rec['launches']} != {want}")
    losses = [rec["losses"][i] for i in sorted(rec["losses"])]
    check(all(math.isfinite(x) for x in losses), f"cli {argv}: losses {losses}")
    return rec


def read_checkpoint(directory: str) -> tuple:
    """The latest step of a checkpoint directory and its leaves as bytes."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    step, leaves, _ = CheckpointManager(directory, async_save=False).restore()
    return step, {k: (str(a.dtype), a.shape, a.tobytes()) for k, a in leaves.items()}


def cli_resume(cfg, shape_argv, workdir: str, counters: dict, per_step: dict) -> dict:
    """The CLI's checkpointed runs on ``cfg``: A, ``CLI_RESUME_STEPS`` steps
    saved every ``CLI_CKPT_EVERY``; B, the same killed at ``CLI_FAIL_AT``
    by ``--inject-failure``, resumed from the step before it with the live
    state as the template, its final checkpoint equal to A's bit for bit
    (A's read back and its directory removed before B runs); C, a second
    call on B's directory to ``CLI_MORE_STEPS`` steps, resumed through a
    meta-device template. ``per_step``: a step's launches."""
    import shutil
    from pathlib import Path

    from repro_torch.ckpt.checkpoint import CheckpointManager

    def argv(steps, d, *extra):
        return [*shape_argv, "--steps", str(steps), "--ckpt-every", str(CLI_CKPT_EVERY),
                "--ckpt-dir", str(Path(workdir) / d), *extra]

    steps = lambda n: {k: n * v for k, v in per_step.items()}
    a = cli_run(cfg, argv(CLI_RESUME_STEPS, "A"), counters, steps(CLI_RESUME_STEPS))
    step_a, leaves_a = read_checkpoint(str(Path(workdir) / "A"))
    shutil.rmtree(Path(workdir) / "A")
    resumed_at = CLI_FAIL_AT - CLI_FAIL_AT % CLI_CKPT_EVERY
    b = cli_run(cfg, argv(CLI_RESUME_STEPS, "B", "--inject-failure", str(CLI_FAIL_AT)), counters,
                steps(CLI_FAIL_AT + CLI_RESUME_STEPS - resumed_at))
    check(b["restarts"] == 1 and b["resumed"] == [resumed_at],
          f"cli B: {b['restarts']} restarts, resumed from {b['resumed']}")
    check(f"[train] resumed from checkpoint step {resumed_at}" in b["printed"]
          and "[train] completed after 1 restart(s)" in b["printed"], f"cli B printed {b['printed']}")
    check(b["losses"] == a["losses"], f"cli B: losses {b['losses']} != A's {a['losses']}")
    step_b, leaves_b = read_checkpoint(str(Path(workdir) / "B"))
    check(step_a == step_b == CLI_RESUME_STEPS and leaves_b == leaves_a,
          f"cli B: its step-{step_b} checkpoint is not A's step-{step_a} bit for bit")
    gb = sum(len(v[2]) for v in leaves_a.values()) / 1e9
    del leaves_a, leaves_b
    c = cli_run(cfg, argv(CLI_MORE_STEPS, "B"), counters, steps(CLI_MORE_STEPS - CLI_RESUME_STEPS))
    latest = CheckpointManager(str(Path(workdir) / "B"), async_save=False).latest_step()
    check(c["resumed"] == [CLI_RESUME_STEPS] and latest == CLI_MORE_STEPS
          and sorted(c["losses"]) == list(range(CLI_RESUME_STEPS, CLI_MORE_STEPS)),
          f"cli C: resumed from {c['resumed']}, latest step {latest}")
    shutil.rmtree(Path(workdir) / "B")
    return {"checkpoint_gb": gb, "A": a, "B": b, "C": c}


def load_example(name: str):
    """``examples/torch/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cli_examples(workdir: str, counters: dict) -> dict:
    """The four example twins on the card at their JAX sizes: train_lm's
    300 steps (its ``loss < 4.0`` assert), hyperparam_tuning's PACK and
    FIFO makespans, inference_packing's 12 services (rwkv's K4 under
    ``no_grad``), quickstart; each one's launches, which must cover the
    kernels its path runs (train_lm's exactly a step's count a step)."""
    import contextlib
    import io
    from pathlib import Path

    from repro_torch.configs import get_config

    out = {}
    for name in EXAMPLES:
        mod = load_example(name)
        argv = ["--device", "cuda"]
        if name == "train_lm":
            argv += ["--ckpt-dir", str(Path(workdir) / name)]
        zero_counts(counters)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = mod.main(argv)
        sync()
        rec = {"wall_s": time.perf_counter() - t0, "printed": printed.getvalue().splitlines(),
               "launches": {k: c.launches for k, c in counters.items()}}
        got = rec["launches"]
        if name == "train_lm":
            cfg = mod.hundred_m_config()
            per = launches_per_microbatch(cfg)
            want = {k: 300 * 2 * v for k, v in per.items()}
            check(got == want, f"train_lm launches {got} != {want}")
            rec.update(final_loss=res, params=cfg.param_count())
        elif name == "hyperparam_tuning":
            per = launches_per_microbatch(get_config("gemma-2b").smoke())
            want = {k: 2 * len(mod.LRS) * mod.N_ITERS * v for k, v in per.items()}
            check(got == want, f"hyperparam_tuning launches {got} != {want}")
            rec.update(pack_s=res["pack_s"], fifo_s=res["fifo_s"],
                       fifo_over_pack=res["fifo_s"] / res["pack_s"],
                       final_losses={s.name: float(s.metrics_log[-1]["loss"])
                                     for s in res["sessions"]})
        elif name == "inference_packing":
            check(got["rmsnorm"] > 0 and got["flash_attention"] > 0 and got["wkv6"] > 0
                  and got["rmsnorm_bwd"] == got["flash_attention_bwd"] == 0,
                  f"inference_packing launches {got}")
            check(res["packed"] == res["services"] == 12 and not res["report"].failures
                  and res["requests"] == 12 * mod.REQUESTS,
                  f"inference_packing packed {res['packed']}, served {res['requests']}")
            rec.update(packed=res["packed"], requests=res["requests"],
                       ms_a_request={s.name: 1e3 * res["report"].stats[s.job.job_id].service_time
                                     / res["report"].stats[s.job.job_id].iterations_done
                                     for s in res["sessions"]})
        else:
            check(not res.failures and sorted(s.iterations_done for s in res.stats.values())
                  == [5, 20, 20], "quickstart: a job failed or did not finish")
        out[name] = rec
        del res, mod
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_cli(train_res=None) -> dict:
    """The training CLI (``repro_torch.launch.train``) and the four example
    twins on the card. (a) The CLI's loop on gemma-2b at full width and
    depth (fp32 params, AdamW, the train phase's shape through the CLI's
    flags: ``--seq-len 4096 --batch 4 --microbatches 4``), ``CLI_STEPS``
    steps on a one-rank (1, 1) mesh, no checkpoints; then the same with
    ``--compress-grads`` (one gradient of the whole batch, the int8
    compressor, AdamW): exact K1/K3/B1/B2 launches a step, finite losses
    falling from step 0, each step's seconds, the peak memory. (b) The
    resume (``cli_resume``) at the ckpt phase's depth (``CKPT_DEPTH``
    layers, 7.61 GB a checkpoint) in a temporary directory with at least
    ``CKPT_MIN_FREE_GB`` free, at most 23 GB written at once. (c) The
    example twins (``cli_examples``). Printed with the card and its power
    limit, and beside the train phase's step seconds of the same call
    (``train_res``, when given)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    counters = kernel_counters()
    cfg = get_config(TRAIN_ARCH)
    per_mb = launches_per_microbatch(cfg)
    full = {}
    for name, extra, passes in (("plain", (), 4), ("compressed", ("--compress-grads",), 1)):
        torch.cuda.reset_peak_memory_stats()
        rec = cli_run(cfg, [*CLI_SHAPE, "--steps", str(CLI_STEPS), *extra], counters,
                      {k: CLI_STEPS * passes * v for k, v in per_mb.items()})
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        losses = [rec["losses"][i] for i in range(CLI_STEPS)]
        check(all(x < losses[0] for x in losses[1:]), f"cli {name}: losses {losses} do not fall")
        rec["launches_per_step"] = {k: passes * v for k, v in per_mb.items()}
        full[name] = rec
        gc.collect()
        torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        free_gb = shutil.disk_usage(workdir).free / 1e9
        check(free_gb >= CKPT_MIN_FREE_GB,
              f"{workdir}: {free_gb:.1f} GB free; the cli phase needs {CKPT_MIN_FREE_GB}")
        cut = depth_cut(TRAIN_ARCH, CKPT_DEPTH)
        resume = cli_resume(cut, CLI_SHAPE, workdir, counters,
                            {k: 4 * v for k, v in launches_per_microbatch(cut).items()})
        examples = cli_examples(workdir, counters)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    res = {"phase": "cli", "nvidia_smi": smi, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "full_depth": full, "train_phase_step_s": train_res and train_res["step_s"],
           "resume": {"n_layers": CKPT_DEPTH, "free_gb": free_gb, **resume},
           "examples": examples, "wall_s": time.perf_counter() - t0}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism, two ranks on the one card
# ---------------------------------------------------------------------------

TP_MESH = (1, 2)  # (data, model): the model axis splits the work
TP_SEED = 27
TP_ARCH = "qwen3-8b"
TP_SERVE_PROMPT = (4, 16)
TP_NEW = 16  # greedy tokens
TP_PREFILL = 512  # the fp32 prefill's prompt, as phase parity
# fp32 prefill at full width: full depth, and mixtral at the moe phase's depth
TP_FAMILIES = (("rwkv6-7b", None), (HYMBA_ARCH, None), (MOE_ARCH, MOE_DEPTH))
TP_TRAIN_DEPTH = 4  # qwen3-8b's step: 4 of 36 layers, fp32, one (1, 4096) sequence
TP_TRAIN_SEQ = 4096
# relative Frobenius of the loss, the gradient tree and the updated params'
# tree, as C2's step was held; and of each leaf, phase train_parity's fp32
# bar: the flash backward's 3xTF32 error differs between the launch plans
# of 16/4 and 32/8 heads, and a leaf such as a qk-norm scale, summed over
# every row and head, lands ~1e-5 apart
TP_TRAIN_TOL = 1e-5
TP_TRAIN_LEAF_TOL = 1e-4
TP_PREFILL_TOL = 1e-3  # phase parity's fp32 tolerance, (1 + |one process|)
TP_TIMEOUT_S = 900
TP_FLASH_CASES = (
    dict(b=4, sq=16, sk=16, hq=16, hkv=4, d=128, dtype=torch.bfloat16, iters=50),
    dict(b=1, sq=TP_PREFILL, sk=TP_PREFILL, hq=16, hkv=4, d=128, dtype=torch.float32, iters=5),
    dict(b=1, sq=TP_PREFILL, sk=TP_PREFILL, hq=24, hkv=4, d=128, dtype=torch.float32,
         window=4096, iters=5),
    dict(b=1, sq=TP_PREFILL, sk=TP_PREFILL, hq=25, hkv=5, d=64, dtype=torch.float32,
         window=1024, iters=5),
)


def tp_params(cfg, dtype: str, mesh=None, serve: bool = False):
    """``cfg``'s params drawn a layer at a time: layer i's leaves are those
    of a one-layer model drawn from seed ``TP_SEED * 1000 + i`` (layer 0's
    with the embedding, final norm and head), rwkv's decays spread
    (``spread_decay``). Without ``mesh``, whole and stacked (the one-process
    run). On ``mesh``, each layer is placed as it is drawn (``place`` with
    ``param_shardings``), so a rank holds its pieces and one layer whole at
    a time, never the tree."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    from repro_torch.dist.api import place
    from repro_torch.dist.sharding import param_shardings
    from repro_torch.models import ModelOptions, build_model, transformer

    one = replace(cfg, n_layers=1)

    def drawn(i: int):
        gen = torch.Generator(device="cuda").manual_seed(TP_SEED * 1000 + i)
        if i == 0:
            tree = build_model(one, ModelOptions(param_dtype=dtype)).init(gen)
        else:
            tree = {"layers": transformer.layer_init(gen, one, getattr(torch, dtype))}
        if cfg.family == "ssm":
            spread_decay(tree, one)
        return tree if mesh is None else place(tree, param_shardings(tree, one, mesh, serve=serve))

    local = (lambda t: t) if mesh is None else (lambda t: t.to_local())
    top = drawn(0)
    first, spec = pytree.tree_flatten(top["layers"])
    stacks = [torch.empty((cfg.n_layers, *local(t).shape[1:]), dtype=t.dtype, device="cuda")
              for t in first]
    for i in range(cfg.n_layers):
        for stack, t in zip(stacks, first if i == 0 else pytree.tree_leaves(drawn(i))):
            stack[i] = local(t)[0]
    if mesh is not None:
        stacks = [DTensor.from_local(x, mesh, t.placements, run_check=False)
                  for x, t in zip(stacks, first)]
    layers = pytree.tree_unflatten(stacks, spec)
    return {name: layers if name == "layers" else leaf for name, leaf in top.items()}


def resident_bytes(params) -> int:
    """Bytes of the params this process holds (a ``DTensor``'s local piece)."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in pytree.tree_leaves(params))


def gloo_probe() -> dict:
    """Whether gloo runs each collective the port uses on CUDA tensors
    here, fp32 and bf16, with the right sums: all_reduce, all_gather, and
    broadcast besides."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((4,), float(rank + 1), dtype=dtype, device="cuda")
        red = x.clone()
        dist.all_reduce(red)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        cast = x.clone()
        dist.broadcast(cast, src=0)
        name = str(dtype).removeprefix("torch.")
        out[name] = {"all_reduce": red.float().tolist(), "all_gather": [p[0].item() for p in parts],
                     "broadcast": cast[0].item(), "devices": sorted({str(t.device) for t in
                                                                      (red, *parts, cast)})}
        check(red.float().eq(world * (world + 1) / 2).all().item()
              and [p[0].item() for p in parts] == [float(r + 1) for r in range(world)]
              and cast[0].item() == 1.0, f"gloo on CUDA {name}: {out[name]}")
    return out


def tp_whole(piece: torch.Tensor, like, mesh) -> torch.Tensor:
    """A leaf whole from the ranks' ``piece``s laid out as ``like`` (a
    ``DTensor``), by ``all_gather`` over the model axis: every rank calls it."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    pl = like.placements[mesh.mesh_dim_names.index("model")]
    if not isinstance(pl, Shard):
        return piece
    parts = [torch.empty_like(piece) for _ in range(mesh.size(mesh.mesh_dim_names.index("model")))]
    dist.all_gather(parts, piece.contiguous(), group=mesh.get_group("model"))
    return torch.cat(parts, pl.dim)


def tp_serve(mesh, rank: int) -> dict:
    """qwen3-8b at full width and depth, bf16 params placed for serving:
    16 greedy tokens of a (4, 16) prompt through ``make_prefill_step`` /
    ``make_decode_step`` (``generate``) and ``greedy_generate``, bf16
    compute; a (1, 512) prefill in fp32 compute. Rank 0 then runs the same
    on the whole params in one process and holds the two."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train.serve_step import greedy_generate, make_prefill_step

    cfg = get_config(TP_ARCH)
    counters = kernel_counters()
    m16 = build_model(cfg, ModelOptions(param_dtype="bfloat16"))
    m32 = build_model(cfg, ModelOptions(param_dtype="bfloat16", compute_dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    prompt = torch.randint(0, cfg.vocab_size, TP_SERVE_PROMPT, generator=gen, device="cuda")
    long = torch.randint(0, cfg.vocab_size, (1, TP_PREFILL), generator=gen, device="cuda")
    max_len = TP_SERVE_PROMPT[1] + TP_NEW

    def runs(params) -> dict:
        zero_counts(counters)
        sync()
        t0 = time.perf_counter()
        tokens, logits = generate(m16, params, prompt, TP_NEW, max_len)
        sync()
        t1 = time.perf_counter()
        greedy = greedy_generate(m16, params, {"tokens": prompt}, TP_NEW, max_len)
        l32 = make_prefill_step(m32, TP_PREFILL)(params, {"tokens": long})[0].float()
        sync()
        return {"tokens": tokens, "logits": logits, "greedy": greedy, "logits32": l32,
                "generate_s": t1 - t0, "prefill32_s": time.perf_counter() - t1,
                "launches": {n: fn.launches for n, fn in counters.items()}}

    params = tp_params(cfg, "bfloat16", mesh, serve=True)
    out = {"param_bytes_rank": resident_bytes(params)}
    tp = runs(params)  # the serve steps install the mesh's sharding context
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out.update(launches=tp["launches"], generate_s=tp["generate_s"],
               prefill32_s=tp["prefill32_s"],
               greedy_equals_generate=bool(torch.equal(tp["greedy"].long(), tp["tokens"].long())))
    dist.barrier()
    if rank == 0:
        whole = tp_params(cfg, "bfloat16")
        out["param_bytes_one_process"] = resident_bytes(whole)
        ref = runs(whole)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        j = first_difference(tp["tokens"], ref["tokens"])
        upto = TP_NEW if j is None else j + 1  # the same inputs up to there
        out.update(tokens_tp=tp["tokens"].tolist(), tokens_one_process=ref["tokens"].tolist(),
                   first_difference=j, one_process_generate_s=ref["generate_s"],
                   logits_bf16_max_abs_diff=max_err(tp["logits"][:upto], ref["logits"][:upto]),
                   logits32_max_abs_diff=max_err(tp["logits32"], ref["logits32"]),
                   logits32_tol=f"{TP_PREFILL_TOL} (1 + |one process|)",
                   logits32_within=within(tp["logits32"], ref["logits32"], TP_PREFILL_TOL),
                   argmax32=[int(tp["logits32"].argmax()), int(ref["logits32"].argmax())])
        if j is not None:  # a tie at the top of the one-process logits, within one bf16 ulp
            rows = (tp["tokens"][:, j] != ref["tokens"][:, j]).nonzero()[:, 0].tolist()
            lg = ref["logits"][j]
            gaps = [float(lg[r].max() - lg[r, tp["tokens"][r, j]]) for r in rows]
            ulps = [bf16_ulp(float(lg[r].max())) for r in rows]
            out.update(rows_at_difference=rows, one_process_gap=gaps, bf16_ulp=ulps,
                       tie=all(g <= u for g, u in zip(gaps, ulps)))
    dist.barrier()
    return out


def tp_prefill(mesh, rank: int, arch: str, depth) -> dict:
    """``arch`` at full width (``depth`` layers if given), bf16 params
    placed for serving, a (1, 512) prefill in fp32 compute on the ranks;
    rank 0 then runs it on the whole params in one process and holds the
    logits. MoE: the tokens each route call sends to other experts than
    the one-process run does, recorded (``moe_trace``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train.serve_step import make_prefill_step

    cfg = get_config(arch) if depth is None else depth_cut(arch, depth)
    counters = kernel_counters()
    model = build_model(cfg, ModelOptions(param_dtype="bfloat16", compute_dtype="float32"))
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, TP_PREFILL), generator=gen,
                                     device="cuda")}

    def run(params):
        zero_counts(counters)
        sync()
        t0 = time.perf_counter()
        with moe_trace() as log:
            logits = make_prefill_step(model, TP_PREFILL)(params, batch)[0].float()
        sync()
        return logits, log, time.perf_counter() - t0, {n: fn.launches for n, fn in counters.items()}

    params = tp_params(cfg, "bfloat16", mesh, serve=True)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "param_bytes_rank": resident_bytes(params)}
    tp, tp_log, out["prefill_s"], out["launches"] = run(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        whole = tp_params(cfg, "bfloat16")
        out["param_bytes_one_process"] = resident_bytes(whole)
        ref, ref_log, out["one_process_prefill_s"], _ = run(whole)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        out.update(logits_max_abs_diff=max_err(tp, ref), tol=f"{TP_PREFILL_TOL} (1 + |one process|)",
                   within=within(tp, ref, TP_PREFILL_TOL), argmax=[int(tp.argmax()), int(ref.argmax())],
                   finite=bool(torch.isfinite(tp).all().item()))
        if cfg.is_moe:
            out["flipped_tokens_a_route_call"] = flipped_tokens(tp_log, ref_log)
            out["dropped"] = [dropped(tp_log), dropped(ref_log)]
    dist.barrier()
    return out


def tp_train_step(mesh, cfg, params, batch):
    """One AdamW step of ``cfg`` (fp32 compute, the default options) on
    ``params``, on ``mesh`` when they are placed there: the loss, the
    gradients as the step hands them to AdamW (copied before its clipping),
    the step's seconds and its peak of allocated bytes."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainRunConfig, local_pieces, make_train_step

    kept = []
    model = build_model(cfg, ModelOptions(compute_dtype="float32"))
    opt = AdamW()
    state = opt.init(local_pieces(params))
    if mesh is not None:  # m and v laid out as the params
        for key in ("m", "v"):
            state[key] = pytree.tree_map(
                lambda z, p: DTensor.from_local(z, mesh, p.placements, run_check=False),
                state[key], params)
    run = TrainRunConfig(grad_transform=lambda g: kept.append(pytree.tree_map(torch.clone, g)) or g)
    step = make_train_step(model, opt, run)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = step(params, state, batch)[2]  # on a mesh the step installs its context
    sync()
    return {"loss": float(metrics["loss"]), "grads": kept[0], "step_s": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def tp_train(mesh, rank: int) -> dict:
    """qwen3-8b at full width, ``TP_TRAIN_DEPTH`` layers, fp32 params and
    compute: one AdamW step of a (1, 4096) sequence on the ranks, B1 and B2
    on local heads; rank 0 then takes it in one process and holds the loss,
    the gradients and the updated params (each leaf gathered whole from the
    ranks, one at a time): relative Frobenius of each tree and each leaf."""
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.api import place
    from repro_torch.dist.sharding import batch_shardings

    cfg = depth_cut(TP_ARCH, TP_TRAIN_DEPTH)
    counters = kernel_counters()
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, TP_TRAIN_SEQ), generator=gen, device="cuda")
             for k in ("tokens", "labels")}
    params = tp_params(cfg, "float32", mesh)
    out = {"n_layers": cfg.n_layers, "seq": TP_TRAIN_SEQ, "param_bytes_rank": resident_bytes(params)}
    zero_counts(counters)
    placed = place(batch, batch_shardings(cfg, ShapeConfig("tp", "train", TP_TRAIN_SEQ, 1), mesh))
    tp = tp_train_step(mesh, cfg, params, placed)
    out.update(launches={n: fn.launches for n, fn in counters.items()}, loss=tp["loss"],
               step_s=tp["step_s"], peak_bytes_rank=tp["peak_bytes"])
    paths, like = zip(*pytree.tree_flatten_with_path(params)[0])
    new = [t.to_local() for t in like]
    grads = pytree.tree_leaves(tp.pop("grads"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    ref = None
    if rank == 0:
        whole = tp_params(cfg, "float32")
        one = tp_train_step(None, cfg, whole, batch)
        out.update(one_process_loss=one["loss"], one_process_step_s=one["step_s"],
                   one_process_peak_bytes=one["peak_bytes"],
                   loss_rel=abs(tp["loss"] - one["loss"]) / abs(one["loss"]))
        ref = {"grads": pytree.tree_leaves(one.pop("grads")), "params": pytree.tree_leaves(whole)}
        del whole, one
    # squared norms of the differences and of the one-process values, a leaf
    sq = {"grads": [], "params": []}
    for i, lk in enumerate(like):
        for key, pieces in (("grads", grads), ("params", new)):
            t = tp_whole(pieces[i], lk, mesh)
            if ref is not None:
                b = ref[key][i].float()
                sq[key].append(((t.float() - b).square().sum().item(), b.square().sum().item()))
            del t
    if ref is not None:
        for key, rows in sq.items():
            leaf = {pytree.keystr(p): math.sqrt(d / max(n, 1e-60)) for p, (d, n) in zip(paths, rows)}
            worst = max(leaf, key=leaf.get)
            out[key] = {"rel_fro": math.sqrt(sum(d for d, _ in rows) / sum(n for _, n in rows)),
                        "rel_fro_a_leaf": leaf, "worst_leaf": [worst, leaf[worst]]}
    dist.barrier()
    return out


def tp_rank(rank: int, world: int, workdir: str) -> int:
    """One rank of phase ``tp`` (``chip_smoke.py --tp-rank RANK WORLD DIR``):
    a gloo group over a ``FileStore`` in ``DIR``, every rank on the one
    card; the probe, serve, prefill and train runs; rank 0 writes every
    rank's record to ``DIR/tp.json``."""
    import resource
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    store = dist.FileStore(str(Path(workdir) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TP_TIMEOUT_S))
    try:
        out = {"rank": rank, "gloo_cuda": gloo_probe()}
        mesh = make_mesh(TP_MESH, ("data", "model"), "cuda")
        out["serve"] = tp_serve(mesh, rank)
        out["families"] = [tp_prefill(mesh, rank, arch, depth) for arch, depth in TP_FAMILIES]
        out["train"] = tp_train(mesh, rank)
        out["max_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        ranks = [None] * world
        dist.all_gather_object(ranks, out)
        if rank == 0:
            (Path(workdir) / "tp.json").write_text(json.dumps(ranks))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_tp() -> dict:
    """Tensor parallelism on the model axis (``dist.api``): two rank
    processes of a gloo group on the one card (NCCL refuses two ranks on
    one device), a (1, 2) ``data, model`` mesh. The port's collectives
    pass CUDA tensors to gloo, which stages them through the host, so the
    seconds here are no speed figure. Rank 0 holds each run against the
    one-process port on the same params (``tp_params``, drawn from one
    seed): qwen3-8b's 16 greedy bf16 tokens of a (4, 16) prompt equal, or
    apart only from a tie within one bf16 ulp at the top of the
    one-process logits, and its fp32 (1, 512) prefill within phase
    parity's tolerance; the same prefill of rwkv6-7b, hymba-1.5b (full
    depth) and mixtral-8x22b (4 layers); a 4-layer qwen3-8b AdamW step at
    (1, 4096), fp32, loss, gradients and updated params within 1e-5
    relative Frobenius (each leaf within 1e-4, phase train_parity's fp32
    bar). Per rank: the bytes of params resident
    (prediction: within 1% of half the one-process bytes) and the step's
    peak allocation; K1/K3/K4/B1/B2 launched on local heads; each
    process's peak resident host memory."""
    import resource
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    smi = nvidia_smi()
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    world = TP_MESH[0] * TP_MESH[1]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-rank", str(r),
                               str(world), workdir], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        for r, (p, o) in enumerate(zip(procs, outs)):
            print(f"tp rank {r} rc {p.returncode}:\n{o[-6000:]}", file=sys.stderr)
        raise RuntimeError("chip_smoke check failed: a tp rank failed")
    ranks = json.loads((Path(workdir) / "tp.json").read_text())
    r0 = ranks[0]
    res = {"phase": "tp", "nvidia_smi": smi, "mesh": list(TP_MESH), "ranks": ranks,
           "launcher_max_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "wall_s": time.perf_counter() - t0}
    emit(res)
    serve, train = r0["serve"], r0["train"]
    for r in ranks:
        for key, want in (("serve", ("rmsnorm", "flash_attention")),
                          ("train", ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                                     "flash_attention_bwd"))):
            check(all(r[key]["launches"][n] > 0 for n in want),
                  f"tp rank {r['rank']} {key}: launches {r[key]['launches']}")
        check(r["families"][0]["launches"]["wkv6"] > 0, f"tp rank {r['rank']}: no K4 launch")
        check(abs(r["serve"]["param_bytes_rank"] / serve["param_bytes_one_process"] - 0.5) <= 0.005,
              f"tp rank {r['rank']}: {r['serve']['param_bytes_rank']} param bytes of "
              f"{serve['param_bytes_one_process']}")
        check(r["serve"]["greedy_equals_generate"], "tp: greedy_generate != the step loop")
    check(serve["first_difference"] is None or serve["tie"],
          f"tp: qwen3-8b tokens differ beyond a tie: {serve}")
    check(serve["logits32_within"] and serve["argmax32"][0] == serve["argmax32"][1],
          f"tp: qwen3-8b fp32 prefill {serve['logits32_max_abs_diff']}")
    for fam in r0["families"]:
        check(fam["finite"] and fam["within"] and fam["argmax"][0] == fam["argmax"][1],
              f"tp: {fam['arch']} fp32 prefill {fam}")
    for key in ("grads", "params"):
        check(train[key]["rel_fro"] <= TP_TRAIN_TOL
              and train[key]["worst_leaf"][1] <= TP_TRAIN_LEAF_TOL, f"tp: train step {key} {train}")
    check(train["loss_rel"] <= TP_TRAIN_TOL, f"tp: train step loss {train}")
    return res


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 18: dryrun
# ---------------------------------------------------------------------------

# the dry-run CLI's cells on the 16x16 fake mesh, one process each
DRYRUN_CELLS = (("qwen2-72b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
                ("rwkv6-7b", "long_500k"))
DRYRUN_PEAK_TOL = 0.10  # the count's peak against max_memory_allocated
DRYRUN_PRODUCT_TOL = 0.01  # its products' FLOPs against the profiler's
PRODUCT_OPS = ("mm", "addmm", "bmm", "baddbmm")


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    from torch.utils import _pytree as pytree

    sts = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
           for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)}
    return sum(sts.values())


def dryrun_held(name: str, step, fake_args, args, microbatches: int = 1, then=None) -> dict:
    """``step`` counted on one rank (``launch.dryrun.count`` on the fake
    tensors ``fake_args()`` makes, the kernels by their ``cost``), then run
    on the card on ``args``: once timed, ``then()`` called, once under
    ``torch.profiler`` with its FLOPs. The count's peak is held against
    ``max_memory_allocated`` over the profiled call (the allocations alive
    before it other than ``args`` taken out), its products' FLOPs against
    the profiler's, and each kernel's launches against the wrappers'
    counters."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    with FakeTensorMode():
        counter, _, memory = dryrun.count(step, fake_args(), microbatches)
    count_s = time.perf_counter() - t0
    counters = kernel_counters()
    sync()
    t0 = time.perf_counter()
    step(*args)
    sync()
    measured_s = time.perf_counter() - t0
    if then is not None:
        then()
    others = torch.cuda.memory_allocated() - storage_bytes(args)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        step(*args)
        sync()
    peak = torch.cuda.max_memory_allocated() - others
    launches = {n: fn.launches for n, fn in counters.items()}
    counted = {n: counter.kernels.get(n, {}).get("launches", 0) for n in counters}
    # a product whose op ran a kernel; the profiler also gives FLOPs to the
    # ops a remat recompute opens and stops before they run (the
    # checkpoint's early stop, once the tensors the backward needs exist)
    names = {f"aten::{k}" for k in PRODUCT_OPS}
    events = [e for e in prof.events() if e.name in names]
    card_products = sum(e.flops for e in events if e.device_time_total > 0)
    stopped = sum(e.flops for e in events if e.device_time_total <= 0)
    products = sum(counter.flops_by_op.get(k, 0) for k in PRODUCT_OPS)
    terms = roofline.roofline_terms(counter.flops, counter.hbm_bytes, 0.0)
    res = {
        "phase": "dryrun", "cell": name, "microbatches": microbatches, "count_s": count_s,
        "peak_gb": {"count": counter.peak / 1e9, "card": peak / 1e9,
                    "ratio": counter.peak / peak},
        "memory": memory,
        "product_flops": {"count": products, "profiler": card_products,
                          "ratio": products / card_products if card_products else None,
                          "profiler_not_run": stopped},
        "flops": counter.flops, "hbm_bytes": counter.hbm_bytes,
        "kernels": counter.kernels, "launches": {"count": counted, "card": launches},
        "roofline": terms, "measured_s": measured_s,
        "bound_share": terms["step_lower_bound_s"] / measured_s,
    }
    emit(res)
    check(abs(res["peak_gb"]["ratio"] - 1) <= DRYRUN_PEAK_TOL,
          f"dryrun {name}: peak {counter.peak} counted against {peak} on the card")
    check(card_products > 0 and abs(res["product_flops"]["ratio"] - 1) <= DRYRUN_PRODUCT_TOL,
          f"dryrun {name}: product FLOPs {products} counted against {card_products}")
    check(counted == launches, f"dryrun {name}: launches {counted} counted against {launches}")
    return res


def phase_dryrun(train_res: dict) -> dict:
    """The dry run (``repro_torch.launch.dryrun``) against the card: the
    serve phase's qwen3-8b prefill of a (4, 16) prompt (bf16 params) and
    the train phase's gemma-2b step (full depth, TRAIN_BATCH x 4096 tokens
    in 4 microbatches, kernel mode), each counted on one rank and held
    against a real call (``dryrun_held``); the CLI on DRYRUN_CELLS on the
    16x16 fake mesh, kernel mode, one process a cell, started once the
    train step has been timed, each report read."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.dryrun import DEVICE, abstract_params
    from repro_torch.launch.serve import PROMPT_SHAPE, SERVE_OPTS, stable_seed
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    dev = torch.device("cuda")
    qcfg = get_config("qwen3-8b")
    serve_model = build_model(qcfg, replace(SERVE_OPTS, param_dtype="bfloat16"))
    prefill = lambda p, batch: serve_model.prefill(p, batch, max_len=64)  # noqa: E731
    fake_prompt = lambda: {"tokens": torch.zeros(PROMPT_SHAPE, dtype=torch.int32,  # noqa: E731
                                                 device=DEVICE)}
    qparams = serve_model.init(torch.Generator(device=dev).manual_seed(stable_seed("qwen3-8b")))
    prompt = {"tokens": torch.randint(0, qcfg.vocab_size, PROMPT_SHAPE, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(0))}
    serve = dryrun_held("qwen3-8b prefill", prefill,
                        lambda: (abstract_params(serve_model), fake_prompt()), (qparams, prompt))
    del qparams
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    cli = []

    def start_cli():
        cli.extend(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", sh,
             "--kernel-mode", "kernel", "--out", str(out_dir)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for a, sh in DRYRUN_CELLS)

    cfg, shape, model, run, ocfg = train_model()
    opt = AdamW(ocfg)
    step = make_train_step(model, opt, run)
    b, s = shape.global_batch, shape.seq_len

    def fake_train():
        p = abstract_params(model)
        tok = torch.zeros(b, s, dtype=torch.int32, device=DEVICE)
        return p, opt.init(p), {"tokens": tok, "labels": tok}

    params = model.init(torch.Generator(device=dev).manual_seed(18))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(cfg.vocab_size, s, b, seed=0).batch(0).items()}
    try:
        train = dryrun_held(f"{cfg.name} train", step, fake_train,
                            (params, opt.init(params), batch), run.num_microbatches, start_cli)
    finally:
        outs = []
        for p in cli:
            try:
                outs.append(p.communicate(timeout=600)[0])
            except subprocess.TimeoutExpired:
                for q in cli:
                    q.kill()
                raise
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    # the train phase's steps, through SalusExecutor sessions
    train_s = sorted(train_res["step_s"])[len(train_res["step_s"]) // 2]
    train.update(train_phase_step_s=train_s,
                 train_phase_bound_share=train["roofline"]["step_lower_bound_s"] / train_s)
    emit({"phase": "dryrun", "cell": train["cell"], "train_phase_step_s": train_s,
          "train_phase_bound_share": train["train_phase_bound_share"]})
    cells = {}
    for (a, sh), p, out in zip(DRYRUN_CELLS, cli, outs):
        check(p.returncode == 0, f"dryrun CLI {a} {sh}: rc {p.returncode}\n{out[-3000:]}")
        r = json.loads((out_dir / f"{a}__{sh}__16x16.json").read_text())
        cells[f"{a} {sh}"] = {k: r[k] for k in (
            "peak_bytes_per_device", "fits_80GB", "flops_per_device", "hbm_bytes_per_device",
            "roofline", "useful_flops_ratio", "kernels", "count_s")}
        cells[f"{a} {sh}"]["collective_bytes"] = r["collectives"]["total_bytes"]
        check(r["n_devices"] == 256 and r["roofline"]["step_lower_bound_s"] > 0,
              f"dryrun CLI {a} {sh}: {r['n_devices']} devices, roofline {r['roofline']}")
    check(len(cells) == len(DRYRUN_CELLS), f"dryrun CLI: {len(cells)} of {len(DRYRUN_CELLS)} cells")
    res = {"phase": "dryrun", "cli_cells": cells}
    emit(res)
    return {"train": train, "serve": serve, **res}


# ---------------------------------------------------------------------------
# phase 19: ctl — the persistent control plane, killed and recovered
# ---------------------------------------------------------------------------

CTL_JOBS = 3
CTL_ITERS = 300
CTL_LIMIT_S = 20.0  # the phase's budget inside the script's 1200 s
CTL_START_S = 12.0  # a daemon's socket must appear within this (torch's import)


def ctl_start(workdir: str, store: str, sock: str, epoch_sleep: float) -> subprocess.Popen:
    """``python -m repro_torch.ctl --socket SOCK start`` with
    ``tests/test_ctl_recovery.py``'s SIGKILL flags, once its socket is up."""
    if os.path.exists(sock):
        os.unlink(sock)  # left behind by a SIGKILLed daemon
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.ctl", "--socket", sock, "start", "--store", store,
         "--capacity-gb", "4.0", "--epoch", "20", "--epoch-sleep", str(epoch_sleep)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=workdir)
    deadline = time.monotonic() + CTL_START_S
    while not os.path.exists(sock):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            out = proc.communicate(timeout=10)[0].decode(errors="replace")
            check(False, f"ctl daemon socket not up within {CTL_START_S} s (rc {proc.returncode}):"
                         f"\n{out[-2000:]}")
        time.sleep(0.02)
    return proc


def phase_ctl() -> dict:
    """The port's control plane in a tree without JAX: a daemon is
    SIGKILLed after its first committed epoch, a second recovers the store,
    and every job finishes once with the decision log extended as a prefix."""
    import contextlib
    import io
    import shutil
    import signal
    import tempfile

    from repro_torch.ctl import CtlClient, CtlState, JobStore
    from repro_torch.ctl.cli import main as ctl_main

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ctl_")
    store, sock = os.path.join(workdir, "jobs.sqlite"), os.path.join(workdir, "s")
    check(len(sock.encode()) < 100, f"unix socket path too long: {sock}")
    procs, secs, reader = [], {}, None
    try:
        procs.append(ctl_start(workdir, store, sock, epoch_sleep=0.05))
        secs["first_start"] = time.perf_counter() - t0
        client = CtlClient(sock, timeout=10.0)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            for i in range(CTL_JOBS):
                check(ctl_main(["--socket", sock, "submit", "--name", f"t{i}", "--iters",
                                str(CTL_ITERS), "--iter-time", "1.0", "--persistent-mb", "200",
                                "--ephemeral-mb", "800"]) == 0, "ctl submit")
        ids = [int(x) for x in out.getvalue().split()]
        reader = JobStore(store)
        deadline = time.monotonic() + 10.0
        while not (any(r["iterations_done"] > 0 for r in reader.list_jobs())
                   and reader.decision_count() > 0):
            check(time.monotonic() < deadline, "ctl: no epoch committed within 10 s")
            time.sleep(0.01)
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait(timeout=10)
        secs["to_kill"] = time.perf_counter() - t0
        pre_log = reader.decision_log()
        pre = {r["job_id"]: (r["state"].value, r["iterations_done"]) for r in reader.list_jobs()}
        check(any(st != "finished" for st, _ in pre.values()), f"ctl: all finished before the kill {pre}")

        procs.append(ctl_start(workdir, store, sock, epoch_sleep=0.0))
        secs["second_start"] = time.perf_counter() - t0
        status = client.wait_quiet(timeout=max(1.0, CTL_LIMIT_S - (time.perf_counter() - t0)))
        secs["quiet"] = time.perf_counter() - t0
        post_log = reader.decision_log()
        check(post_log[: len(pre_log)] == pre_log and len(post_log) > len(pre_log),
              f"ctl: the log after recovery ({len(post_log)}) does not extend the log before "
              f"the kill ({len(pre_log)}) as a prefix")
        reasons = [t[4] for t in reader.transitions()]
        check("crash-recovery requeue" in reasons, "ctl: no job was requeued by recovery")
        rows = {r["job_id"]: r for r in reader.list_jobs()}
        check(sorted(rows) == sorted(ids) == list(range(CTL_JOBS)), f"ctl: jobs {sorted(rows)}")
        for jid, r in rows.items():
            finished = sum(1 for t in reader.transitions(jid) if t[2] == "finished")
            check(r["state"] is CtlState.FINISHED and r["iterations_done"] == CTL_ITERS
                  and finished == 1, f"ctl: job {jid} {r['state']} {r['iterations_done']}/"
                                     f"{CTL_ITERS}, finished {finished} times")
        by_id = {j["job_id"]: j for j in status["jobs"]}
        for jid, r in rows.items():
            check(by_id[jid]["state"] == r["state"].value
                  and by_id[jid]["iterations_done"] == r["iterations_done"],
                  f"ctl: status {by_id[jid]} disagrees with the store")
        replayed = reader.replay()
        check(all(s is CtlState.FINISHED for s in replayed.values()), f"ctl: replay {replayed}")
        with contextlib.redirect_stdout(io.StringIO()):
            check(ctl_main(["--socket", sock, "shutdown"]) == 0, "ctl shutdown")
        procs[1].wait(timeout=10)
    finally:
        if reader is not None:
            reader.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    res = {"phase": "ctl", "jobs": CTL_JOBS, "iters": CTL_ITERS,
           "at_kill": {str(j): it for j, (_, it) in sorted(pre.items())},
           "states_at_kill": sorted({st for st, _ in pre.values()}),
           "log_before_kill": len(pre_log), "log_after": len(post_log),
           "requeued": reasons.count("crash-recovery requeue"),
           "seconds": seconds, "marks_s": secs, "nvidia_smi": nvidia_smi()}
    emit(res)
    check(seconds <= CTL_LIMIT_S, f"ctl phase took {seconds:.1f} s, over {CTL_LIMIT_S}")
    return res


# ---------------------------------------------------------------------------
# phase 20: lint — the repo's linter in the port, over the port's tree
# ---------------------------------------------------------------------------

LINT_LIMIT_S = 60.0  # the phase's budget inside the script's 1200 s


def phase_lint() -> dict:
    """``repro_torch.analysis``, standard library only: the port's tree is
    clean under ``analysis_torch.toml`` with no unused suppression, and
    every rule's bad fixture trips it while the good twin is clean."""
    from repro_torch.analysis import RULES, load_config, run_analysis

    t0 = time.perf_counter()
    report = run_analysis([SRC / "repro_torch"], load_config(ROOT / "analysis_torch.toml"))
    check(report.clean, "lint: the port's tree has findings:\n" + "\n".join(
        f"{f.location()}: {f.rule} {f.message}" for f in report.all_findings()))
    check(not report.unused_suppressions,
          f"lint: unused suppressions {[(s.rule, s.path) for s in report.unused_suppressions]}")
    tree_s = time.perf_counter() - t0
    fixtures = ROOT / "tests" / "fixtures" / "analysis"
    fixture_cfg = load_config(fixtures / "analysis.toml")
    held = []
    for rule in sorted(RULES):
        good, bad = [f"{rule}/good.py"], [f"{rule}/bad.py"]
        if rule == "RPL020":  # an engine pair spans two files
            good, bad = ["RPL020/good_left.py", "RPL020/good_right.py"], [
                "RPL020/bad_left.py", "RPL020/bad_right.py"]
        tripped = run_analysis([fixtures / f for f in bad], fixture_cfg)
        check(rule in {f.rule for f in tripped.findings}, f"lint: {rule}'s bad fixture gave "
              f"{sorted({f.rule for f in tripped.findings})}")
        clean = run_analysis([fixtures / f for f in good], fixture_cfg)
        check(clean.clean, f"lint: {rule}'s good fixture has findings "
              f"{[(f.location(), f.rule) for f in clean.all_findings()]}")
        held.append(rule)
    seconds = time.perf_counter() - t0
    res = {"phase": "lint", "files_checked": report.files_checked,
           "findings": len(report.all_findings()), "suppressed": len(report.suppressed),
           "rules_held": held, "tree_s": tree_s, "seconds": seconds, "nvidia_smi": nvidia_smi()}
    emit(res)
    check(len(held) == len(RULES) == 14, f"lint: {len(held)} of {len(RULES)} rules held")
    check(seconds <= LINT_LIMIT_S, f"lint phase took {seconds:.1f} s, over {LINT_LIMIT_S}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--tp-rank"]:  # one rank of phase tp
        return tp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    t0 = time.perf_counter()
    seconds = {}

    def timed(name: str, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - start
        return out

    timed("env", phase_env)
    timed("ctl", phase_ctl)  # no device work: first, and quick to fail
    timed("lint", phase_lint)
    k = timed("kernels", phase_kernels)
    serve_res = timed("serve", phase_serve)
    for arch in ("qwen3-8b", "rwkv6-7b"):
        timed(f"parity {arch}", phase_parity, arch)
    # before the phases that page, migrate and checkpoint through host
    # memory: the ranks and this process share the machine's 96 GiB
    tp_res = timed("tp", phase_tp)
    paging_res = timed("paging", phase_paging)
    train_res = timed("train", phase_train)
    timed("dryrun", phase_dryrun, train_res)
    timed("train_parity", phase_train_parity)
    rwkv_res = timed("rwkv_train", phase_rwkv_train)
    fam_train_res = timed("families_train", phase_families_train)
    timed("serve_train", phase_serve_train)
    decode_res = timed("decode", phase_decode)
    moe_res = timed("moe", phase_moe)
    families_res = timed("families", phase_families)
    diff_res = timed("differential", phase_differential, paging_res)
    fleet_res = timed("fleet", phase_fleet, paging_res, diff_res)
    ckpt_res = timed("ckpt", phase_ckpt)
    cli_res = timed("cli", phase_cli, train_res)
    emit({"phase_seconds": seconds})
    kernels_line(k, serve_res, train_res, decode_res, moe_res, families_res, fleet_res, ckpt_res,
                 cli_res, tp_res, rwkv_res, fam_train_res)
    emit({"phase": "done", "wall_s": time.perf_counter() - t0})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
