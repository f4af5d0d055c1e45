#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives the port in phases and exits non-zero if any fails:

  (a) device   needs CUDA; prints the card's name and power limit; TF32 off;
  (b) build    builds the CUDA flash-attention, grouped-matmul, SSD-scan and
               RG-LRU-scan kernels from src/repro_torch/csrc with nvcc for
               sm_90a, one nvcc per source, started together; prints each
               kernel's registers, static shared memory and spills (fails
               on a spill in a bf16 tensor-core kernel or in a kernel of
               either scan), and the dynamic shared memory a block of
               flash and moe_gmm takes per dtype (bf16 runs on the tensor
               cores, f32 on the FMA kernels) and a block of ssd_scan's
               chunk-parallel scan takes;
  (c) kernel   holds the flash kernel against its plain PyTorch version on
               the shapes of tests/test_kernels.py and on the serve paths'
               prefill shapes (qwen2-7b: Hq 28, Hkv 4, D 128; olmoe-1b-7b:
               Hq = Hkv = 16, D 128; causal, S 32/200/1024; recurrentgemma-
               9b: Hq 16, Hkv 1, D 256, window 2048, S 32/200/300/1024, and
               a window of 256 that binds at S 1024), and on the edges of
               the bf16 tensor-core path (S not a multiple of 16 or 64,
               every head dim, GQA groups 1/4/7/16, rows all masked in a
               kv tile), f32 and bf16, tolerance 2e-5 (f32) / 3e-2 (bf16);
               times kernel, plain version and torch's
               scaled_dot_product_attention (a yardstick the port never
               calls) with CUDA events, beside the bound, with the kernel /
               library ratio and the achieved TFLOP/s and TB/s;
  (c2) kernel  holds moe_gmm against its plain version on the shapes of
               tests/test_kernels.py, two ragged ones, the edges of the
               bf16 tensor-core paths (C of 1, 8, 9 and 160, D and F not
               multiples of 8, every count 0, every count C) and
               olmoe-1b-7b's serve shapes (decode C=8 with 32 of 64 experts in use, prefill
               C=160 and C=48 with counts from routing 1024 and 300 random
               tokens), f32 and bf16, inputs at the model's scale; tolerance
               1e-4 (f32, TF32 off) / 3e-2 (bf16: output rounding); times
               kernel, plain version and torch.bmm on the capacity buffer (a
               yardstick the port never calls) beside the bound, which counts
               the rows in use and the weights of the experts in use only,
               with the kernel / library ratio, TFLOP/s and TB/s;
  (c3) kernel  holds ssd_scan (y and the final state h) against its plain
               version (the chunked scan of the JAX model) on the shapes of
               tests/test_kernels.py, two ragged ones (S not a chunk
               multiple), the chunk-parallel kernel's structure (8 and 16
               chunks at S 2048 and 4096, B=4 at mamba2's widths, P of 40:
               not a multiple of a block's 32 columns) and mamba2-1.3b's
               serve shapes (B=1, H 64, P 64, N 128, chunk 256, S 32/200/
               300/1024), f32 and bf16, inputs at the model's scale, TF32
               off; tolerance atol 1e-3 (f32, as tests/test_kernels.py) and
               for bf16 y also rtol 2^-8 (y is rounded to bf16 once: half an
               ulp is 2^-9 of |y|); times kernel and plain version beside
               the bound, the kernel also in a CUDA graph (device time
               only: back-to-back calls of a short kernel time its
               wrapper's host dispatch), with the achieved GFLOP/s and the
               share of the bound on the device time (no single PyTorch
               call computes this function, so no library time);
  (c4) kernel  holds rglru_scan (every h and the last, f32) against its
               plain version (the sequential recurrence in f32) on the shapes
               of tests/test_kernels.py (strong decay included), two ragged
               ones with an initial state, the chunk-parallel kernel's
               edges (S of 1, 7, 9, 257 and 4096 around its 8-step chunks
               and 256-step rounds, C of 4097, B=4 with h0) and
               recurrentgemma-9b's serve shapes (B=1, C 4096, S 32/200/300/
               1024, log_a and gx at the model's scale), f32 and bf16;
               tolerance atol 1e-5 (as tests/test_kernels.py) and for bf16 h
               also rtol 2^-8 (h is rounded to bf16 once); times kernel and
               plain version beside the bound, and the kernel in a CUDA
               graph as in (c3), with the achieved GB/s and the share of
               the bound on the device time (no single PyTorch call
               computes this recurrence);
  (d) serving  qwen2-7b at full width and depth in bf16, random weights from
               a seed drawn on the card, served through repro_torch.launch.
               serve.run (GangExecutor -> ServingEngine -> dense transformer
               with the flash kernel as its prefill attention): 6 requests of
               mixed prompt lengths, 16 new tokens each; every request must
               finish and the launch counts over the run must be n_layers x
               prefills (flash) and 0 (moe_gmm);
  (e) oracle   the engine's greedy tokens equal a greedy rollout that
               re-prefills the whole sequence each step (port against port),
               at full width in f32 on the same weights, where the two paths
               agree to rounding and near-ties cannot flip the argmax;
  (d2) serving olmoe-1b-7b (64 experts, top-8) at full width and depth in
               bf16, the same way and the same 6 prompts: the flash kernel is
               the prefill attention and moe_gmm the expert FFN; launch
               counts must be n_layers x prefills (flash) and 3 x n_layers x
               (prefills + decode steps) (moe_gmm);
  (e2) oracle  the f32 engine's tokens equal a one-request-at-a-time rollout
               through prefill_fn then decode_fn at batch 1. Not the
               re-prefill oracle of (e): a re-prefill routes every earlier
               token again under a capacity that grows with the sequence,
               so the MoE layer may drop other (token, expert) pairs than the
               engine did (JAX's semantics, not a fault); a decode step
               routes at most B <= 8 tokens to an expert whose capacity is 8,
               so it never drops, and the batch-1 rollout and the slot engine
               compute the same function. Random weights give near-constant
               greedy tokens, so the tokens alone check little: then the f32
               logits through the kernels equal those through the kernels'
               plain versions within 1e-3, at a prefill and at 4 decode steps
               over 4 slots at different positions (capacity buffers of 8
               rows, moe_gmm at C=8, in-place cache writes), and so do the
               caches after them;
  (d3) gang    mamba2-1.3b (SSM) at full width and depth in bf16, random
               weights from seed 0 drawn on the card, through ModelApi.
               prefill_fn / decode_fn (the slot engine serves attention
               caches only, as in JAX): the batched decode step over 4
               sequences is the RT job of a GangExecutor (one step per
               quantum on lane 0, through device.Lanes.on_lane) beside the
               best-effort 512^2 matmul job on lanes 0 and 1, bound by
               launch/serve.run_gang as serve.run binds the engine's step;
               the first quantum prefills prompts of 32, 200, 1024
               and 300 tokens at batch 1 and concatenates their state
               caches; then each quantum decodes until every sequence has
               16 new tokens. ssd_scan must launch n_layers x prefills
               times, the other kernels never;
  (e3) oracle  at full width in f32: the logits through the kernel equal
               those of the same calls with ssd_scan swapped for its plain
               version within 1e-3, at the 4 prefills and at 4 decode steps
               over the 4 sequences, and so do the caches after them; each
               sequence's batched greedy tokens equal its batch-1 rollout
               (prefill_fn, then decode_fn); how far they equal a re-prefill
               rollout is reported (they agree up to rounding);
  (d4) gang    recurrentgemma-9b (RG-LRU + local attention hybrid, 38
               layers: 12 groups of (rec, rec, attn) and 2 rec) at full
               width and depth in bf16, the same way and the same prompts;
               the attention layers' k/v go into (12, 4, 2048, 1, 256)
               buffers at rows [0, len), zeros beyond, the rec caches are
               concatenated. rglru_scan must launch 26 x 4 times, flash
               12 x 4, moe_gmm and ssd_scan never;
  (e4) oracle  as (e3) at full width in f32, with both scans' and the flash
               kernel's plain versions, every cache leaf after the prefills
               and after the decode steps checked;
  (f) dave2    the paper's DAVE-2 control-loop CNN (repro_torch.models.
               dave2, f32, TF32 off) on the card at B=1 and B=8, random
               images from a seed, against the same module on the CPU with
               the same weights, atol 1e-5: once with make_dave2's weights
               (the init rule, seed 0) and once with weights at std
               1/sqrt(fan_in) and nonzero biases, where tanh does not
               saturate; the B=1 forward's time back to back (CUDA events)
               and in a CUDA graph (device time), and its device launches
               and busy time a forward (torch.profiler);
  (g) fig1     repro_torch.benchmarks.fig1_parallelization.run() (the batch
               of 8 split over 1/2/4 streams; the DNN solo and beside a
               1024^2 memory co-runner thread on a stream of its own), then
               one co-run traced with torch.profiler: fails unless the
               co-runner's kernels run beside the DNN's;
  (h) fig6     repro_torch.benchmarks.fig6_dnn_cdf.run(duration=6): the
               DAVE-2 quantum's p50/p95/p99/max, n and best-effort quanta
               under Solo, Co-Sched and RT-Gang on the executor, and its
               time on the lane's stream (CUDA events) beside p50 and p99;
               fails if a mode ran no DNN quantum or a quantum raised. The
               latency ordering is reported, not checked. Then the DNN
               alone on the executor at its period (the baseline RT-Gang
               can match: Solo's calls run back to back), and each mode
               again under torch.profiler: the DNN's kernels' busy time a
               quantum and its overlap with the best-effort kernels. None
               of the four kernels may launch in (f)-(h);
  (i) vgang    virtual gangs on the card: repro_torch.benchmarks.
               bench_executor_vgang at its full default duration with
               --reclaim (solo, vgang, rtgT, rtgT+dr; five members whose
               quanta are 3 x tanh(x @ x) * 0.5 on 64-160^2 f32 tensors on
               their lanes' CUDA streams), its JSON in build/; fails on a
               max response above its RTA bound, an RTA verdict not ok, a
               member with no response, a gang-invariant or budget-ordering
               violation or a raised quantum, and, from each quantum's CUDA
               events on its lane's stream, on any quantum of one vgang
               overlapping one of another vgang on the device (reports how
               long members of one vgang ran side by side); then
               repro_torch.examples.vgang_fleet for 2 s plain, with
               --rtg-throttle and with --reclaim: fails unless the gang
               invariant holds and every member ran jobs;
  (j) rta      the batched RTA's torch backend (float64 lockstep fixed
               point on the card) against its numpy backend on the 500
               seeded task sets of tests/test_batched_rta.py (also with
               blocking and CRPD) and on the vgang grid's full default
               shard (3 core counts x 3 width distributions x 9
               utilizations x 50 sets = 4050 sets, up to 11 gangs each),
               and vgang/rta's batched_accepts through it: fails unless
               every verdict is equal, the same lanes settle and every
               finite WCRT agrees within a relative 1e-12; reports both
               backends' times. None of the four kernels may launch in (i)
               or (j);
  (k) train    qwen2-7b at full width, depth cut 28 -> 8 layers (2.954 B
               parameters: 53 GB of f32 AdamW state with bf16 compute; 28
               layers would be 137 GB), through repro_torch.training's
               TrainRunner: f32 masters, bf16 compute, AdamW, remat "block",
               the synthetic TokenSource at B=4, S=1024, 30 steps, no
               checkpoint; reports the step time (median without the first
               3), tokens/s, 6 N tokens / step time against 989 TFLOP/s,
               peak memory, the loss first -> last and the four kernels'
               launches, and one more step under torch.profiler (device
               busy time, idle share, the top kernels); fails unless the
               loss is finite and falls and no kernel launches (JAX's
               training reaches no Pallas kernel).
               Then one f32 loss + gradient at full width (2 layers, B=1,
               S=256, TF32 off) on the card and on the CPU from the same
               weights: the loss within 1e-5 relative, every gradient leaf
               within 1e-4 of that leaf's largest |g|; and the restart path
               at reduced size under build/ (fail at step 10, resume from
               the step-8 checkpoint): every loss within 1e-5 relative of
               the uninterrupted run's;
  (l) serve+train  repro_torch.examples.serve_with_background_training.run
               at full width, under RT-Gang and under Co-Sched, 6 s each:
               the RT gang serves qwen2-7b bf16 at full depth (8 requests
               of 16-token prompts, 12 new tokens, max_batch 2, max_seq
               128), the BE job trains olmoe-1b-7b at full width, depth cut
               16 -> 4 (f32 masters, bf16 compute, AdamW, 4 x 64 tokens a
               microstep); reports per mode the decode quantum's time and
               response p50/p99/max, requests finished, microsteps and
               their median, be_quanta, and from CUDA events on both lanes'
               streams the share of decode stream time beside a microstep;
               fails on a raised quantum, a mode with no decode quantum, a
               non-finite loss, Co-Sched with no microstep (RT-Gang admits
               none once the gang leads: 1e6 B declared a microstep against
               the gang's 5e5 B budget, as in JAX's example) or launch
               counts other than flash = 28 x prefills and 0 for the rest.

Each serving and training phase sets the kernels' launch counts to 0
just before it drives the path and reads them just after; ssd_scan must launch 0 times on
the qwen2-7b, olmoe-1b-7b and recurrentgemma-9b paths, rglru_scan on all
but recurrentgemma-9b's. Before the last line it prints
one JSON object {"kernels": [...]} with each kernel's launches on the serve
paths, error, times and bound (``ms`` from calls back to back, and for the
two scans also ``graph_ms``, the device time in a CUDA graph); the last
line is {"ok": true, "device": {...}}. Details go to build/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import random
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import batched_rta as BRTA  # noqa: E402
from repro_torch.benchmarks import bench_executor_vgang as vbench  # noqa: E402
from repro_torch.benchmarks import fig1_parallelization as fig1  # noqa: E402
from repro_torch.benchmarks import fig6_dnn_cdf as fig6  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.deeppicar import CONFIG as DAVE2  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core.gang import RTTask  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.examples import serve_with_background_training as swbt  # noqa: E402
from repro_torch.examples import vgang_fleet  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import naive_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_reference  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import dave2 as DV  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.training.optimizer import OptConfig, Optimizer  # noqa: E402
from repro_torch.training.runner import (RunnerConfig,  # noqa: E402
                                         SimulatedFailure, TrainRunner)
from repro_torch.training.step import loss_and_grads  # noqa: E402
from repro_torch.vgang import rta as VRTA  # noqa: E402
from repro_torch.vgang.formation import (assign_priorities,  # noqa: E402
                                         intensity_interference,
                                         singleton_vgangs)

# H100 SXM published peaks (dense): bf16 tensor cores, f32 without them,
# HBM3 bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}

# (B, S, Hq, Hkv, D, causal, window, dtype): tests/test_kernels.py's cases,
# then the serve path's prefill shapes and a local-window case
KERNEL_CASES = [
    (2, 256, 4, 2, 64, True, 0, torch.float32),
    (1, 128, 8, 1, 32, True, 0, torch.float32),
    (2, 256, 4, 4, 64, True, 64, torch.float32),
    (1, 256, 2, 2, 128, False, 0, torch.float32),
    (1, 128, 4, 2, 64, True, 0, torch.bfloat16),
]
MAIN_SHAPES = [(1, S, Hq, Hkv, 128, True, 0, dt)
               for Hq, Hkv in ((28, 4), (16, 16))      # qwen2-7b, olmoe-1b-7b
               for dt in (torch.bfloat16, torch.float32)
               for S in (32, 200, 1024)]
WINDOW_CASE = (1, 1024, 28, 4, 128, True, 64, torch.bfloat16)
# recurrentgemma-9b's local attention (Hq 16, Hkv 1, D 256, window 2048,
# which never binds at these lengths), then a window that binds at D 256
HYBRID_SHAPES = [(1, S, 16, 1, 256, True, 2048, dt)
                 for dt in (torch.bfloat16, torch.float32)
                 for S in (32, 200, 300, 1024)]
HYBRID_WINDOW_CASE = (1, 1024, 16, 1, 256, True, 256, torch.bfloat16)
TIMED = MAIN_SHAPES + [WINDOW_CASE] + HYBRID_SHAPES + [HYBRID_WINDOW_CASE]
# the edges of the bf16 tensor-core path (tests/test_torch_flash_attention.
# py's EDGES): S not a multiple of 16 or 64, every head dim, GQA groups 1,
# 4, 7 and 16, one warp's q rows all masked in the first kv tile visited
FLASH_EDGES = [(1, 77, 4, 4, 16, True, 0, torch.bfloat16),
               (1, 100, 8, 2, 32, True, 8, torch.bfloat16),
               (2, 129, 14, 2, 64, True, 0, torch.bfloat16),
               (1, 200, 16, 1, 128, True, 16, torch.bfloat16),
               (1, 150, 16, 1, 256, True, 40, torch.bfloat16),
               (1, 65, 4, 4, 128, False, 0, torch.bfloat16),
               (1, 1, 4, 1, 64, True, 0, torch.bfloat16),
               (1, 300, 16, 1, 256, False, 0, torch.bfloat16)]
REPORTED = (1, 1024, 28, 4, 128, True, 0, torch.bfloat16)

# moe_gmm: (label, E, C, D, F, counts, dtype); counts "random" (uniform in
# [0, C]), "decode" (32 of the 64 experts hold one row) or "route<T>" (the
# rows T random tokens give each expert under top-8 routing, at most C)
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
GMM_CASES = [
    ("test", 4, 32, 16, 24, "random", torch.float32),
    ("test", 2, 64, 32, 32, "random", torch.float32),
    ("test", 3, 16, 8, 8, "random", torch.bfloat16),
    ("ragged", 5, 21, 37, 45, "random", torch.float32),
    ("ragged", 3, 70, 50, 130, "random", torch.bfloat16),
]
# the edges of the bf16 tensor-core paths (tests/test_torch_moe_gmm.py's
# EDGES): C of 1, 8, 9 and 160, D and F not multiples of 8, every count 0,
# every count C
GMM_EDGES = [("edge", E, C, D, F, kind, torch.bfloat16)
             for E, C, D, F in ((4, 1, 64, 128), (3, 8, 72, 136),
                                (3, 9, 40, 100), (2, 160, 96, 264),
                                (3, 21, 37, 45))
             for kind in ("random", "zero", "full")]
GMM_SERVE = [(label, 64, C, D, F, counts, dt)
             for dt in (torch.bfloat16, torch.float32)
             for label, C, D, F, counts in (
                 ("decode gate/up", 8, 2048, 1024, "decode"),
                 ("decode down", 8, 1024, 2048, "decode"),
                 ("prefill T=1024 gate/up", 160, 2048, 1024, "route1024"),
                 ("prefill T=1024 down", 160, 1024, 2048, "route1024"),
                 ("prefill T=300 gate/up", 48, 2048, 1024, "route300"))]
GMM_REPORTED = GMM_SERVE[0]

# ssd_scan: (label, B, S, H, P, N, chunk, dtype); the first four are
# tests/test_kernels.py's, the serve shapes mamba2-1.3b's prefills
SSD_TOL = 1e-3
SSD_BF16_RTOL = 2.0 ** -8
SSD_CASES = [(label, *shape, dt)
             for dt in (torch.float32, torch.bfloat16)
             for label, shape in (("test", (2, 64, 3, 16, 32, 16)),
                                  ("test", (1, 128, 2, 32, 16, 32)),
                                  ("test", (2, 32, 1, 8, 8, 8)),
                                  ("test", (1, 64, 4, 16, 16, 64)),
                                  ("ragged", (2, 77, 3, 24, 40, 32)),
                                  ("ragged", (1, 300, 2, 40, 128, 256)),
                                  ("chunks", (1, 2048, 64, 64, 128, 256)),
                                  ("chunks", (1, 4096, 64, 64, 128, 256)),
                                  ("batch", (4, 300, 64, 64, 128, 256)),
                                  ("P slice", (2, 600, 8, 40, 128, 256)))]
SSD_SERVE = [("serve", 1, S, 64, 64, 128, 256, dt)
             for dt in (torch.float32, torch.bfloat16)
             for S in (32, 200, 300, 1024)]
SSD_REPORTED = ("serve", 1, 1024, 64, 64, 128, 256, torch.float32)

# rglru_scan: (label, B, S, C, scale, h0, dtype); the first four are
# tests/test_kernels.py's (scale 8: strong decay), "model" draws log_a and
# gx at recurrentgemma-9b's scale (log_a = -8 softplus(1) r, down to -10.5
# a step), the serve shapes are its prefills (B=1, lru_width 4096)
RG_TOL = 1e-5
RG_BF16_RTOL = 2.0 ** -8
RG_CASES = [(label, *shape, dt)
            for dt in (torch.float32, torch.bfloat16)
            for label, shape in (("test", (2, 64, 16, 2.0, False)),
                                 ("test", (1, 128, 32, 2.0, False)),
                                 ("test", (3, 32, 8, 8.0, False)),
                                 ("test", (1, 256, 16, 8.0, False)),
                                 ("ragged", (2, 77, 45, 2.0, True)),
                                 ("ragged", (1, 300, 130, 2.0, True)),
                                 ("edge", (1, 1, 4096, "model", True)),
                                 ("edge", (1, 7, 4096, "model", False)),
                                 ("edge", (1, 9, 4096, "model", True)),
                                 ("edge", (1, 257, 4096, "model", True)),
                                 ("long", (1, 4096, 4096, "model", False)),
                                 ("edge", (1, 300, 4097, "model", True)),
                                 ("batch", (4, 1024, 4096, "model", True)))]
RG_SERVE = [("serve", 1, S, 4096, "model", False, dt)
            for dt in (torch.float32, torch.bfloat16)
            for S in (32, 200, 300, 1024)]
RG_REPORTED = ("serve", 1, 1024, 4096, "model", False, torch.float32)

# the gang runs of the state-cache families: batch-1 prefills of these
# prompts in the first quantum, then the batched decode step as the RT job
GANG_PROMPTS = (32, 200, 1024, 300)
GANG_NEW = 16
GANG_ORACLE_NEW = 8
MAMBA_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_MAX_SEQ = 2048

# f32 prefill and decode logits (and caches) through the kernels vs through
# their plain versions, full width and depth: sums taken in another order,
# nothing else
PLAIN_PATH_TOL = 1e-3
PLAIN_PATH_PROMPTS = (32, 20, 45, 9)      # one per slot: 4 decode positions
PLAIN_PATH_STEPS = 4

# DAVE-2 (f): the card vs the CPU in f32 with TF32 off; (h): the Fig.6 run
DAVE2_BATCHES = (1, 8)
DAVE2_TOL = 1e-5
FIG6_DURATION = 6.0
FIG6_TRACED_S = 2.0

# (i): the fleet example's three dispatch modes, 2 s each
FLEET_RUNS = ([], ["--rtg-throttle"], ["--reclaim"])
FLEET_DURATION = 2.0
# (j): the grid's full default shard (vgang/grid.py run_grid): cores x
# width distributions x utilizations x 50 sets, seed 0, gamma 0.5
GRID_CORES = (4, 8, 16)
GRID_DISTS = ("light", "mixed", "heavy")
GRID_UTILS = (0.4, 0.7, 0.9, 1.0, 1.1, 1.2, 1.4, 1.6, 2.0)
GRID_SETS = 50
RTA_RTOL = 1e-12

SERVE_PROMPTS = (32, 200, 1024, 77, 512, 300)
SERVE_MAX_NEW = 16
# (k): qwen2-7b at full width, depth cut 28 -> 8 (18 B a parameter under
# f32 AdamW with bf16 compute: 8 layers 53 GB, 28 layers 137 GB)
TRAIN_ARCH = "qwen2-7b"
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 30
TRAIN_SKIP = 3                          # steps left out of the median
# the f32 card-vs-CPU step: 2 layers, B=1, S=256 (TF32 off)
CHECK_LAYERS, CHECK_SEQ = 2, 256
CHECK_LOSS_RTOL = 1e-5
CHECK_GRAD_TOL = 1e-4                   # of each leaf's largest |g|
# the restart path at reduced size: 12 steps, checkpoints every 4, a
# failure at step 10. cuBLAS and the sorted index_put of the embedding's
# backward repeat their sums on one card, so the losses should agree bit
# for bit; the check allows 1e-5 relative for the order of any atomic add
RESTART_RTOL = 1e-5
# (l): the example's RT side (qwen2-7b bf16, full depth) beside its BE
# side (olmoe-1b-7b at full width, bf16 compute / f32 masters, depth cut
# 16 -> 4: 34 GB of training state beside the serving gang's 18 GB)
BE_TRAIN_LAYERS = 4
SERVE_TRAIN_DURATION = 6.0
# (l)'s modes: the example's RT-Gang run declares 1e6 B a microstep against
# the gang's 5e5 B budget and so admits none once the gang leads; a second
# RT-Gang run declares half the budget, so that the regulator admits real
# microsteps beside the gang (a declared cost: the cost estimate is A4)
BE_FIT_BYTES = 2.5e5
SERVE_TRAIN_MODES = (("rtgang", True, swbt.TRAIN_BYTES),
                     ("rtgang_fit", True, BE_FIT_BYTES),
                     ("cosched", False, swbt.TRAIN_BYTES))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls captured in a CUDA
    graph and replayed ``replays`` times, so no host dispatch is timed (a
    short kernel's time_ms is its wrapper's host time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def unmasked_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= k > q - window
    return int(mask.sum())


def flash_work(case) -> tuple[int, int]:
    """Operations (4 x Hq x D per unmasked pair) and bytes (q, k, v read
    once, o written once) of one flash call."""
    B, S, Hq, Hkv, D, causal, window, dt = case
    ops = 4 * B * Hq * D * unmasked_pairs(S, S, causal, window)
    elt = torch.tensor([], dtype=dt).element_size()
    return ops, elt * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)


def bound(case) -> tuple[float, str]:
    """Least time the card could take: the larger of the operations over
    the peak rate of the input type and the bytes (each input read once,
    the output written once) over the memory rate."""
    ops, nbytes = flash_work(case)
    dt = case[-1]
    t_ops, t_bytes = ops / PEAK_OPS[dt], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def case_name(case) -> str:
    B, S, Hq, Hkv, D, causal, window, dt = case
    return (f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
            f"{'causal' if causal else 'full'}"
            f"{f' window={window}' if window else ''} {DT_NAME[dt]}")


def phase_kernel(dev, smi: str) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for case in KERNEL_CASES + FLASH_EDGES + TIMED:
        B, S, Hq, Hkv, D, causal, window, dt = case
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dt)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = naive_attention(q, k, v, causal=causal, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dt]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        row = {"case": case_name(case), "max_abs_err": err, "tol": tol,
               "ok": bool(ok)}
        if case in TIMED:
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if window:
                i = torch.arange(S, device=dev)
                mask = (i[None, :] <= i[:, None]) & \
                    (i[None, :] > i[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, attn_mask=mask, enable_gqa=True)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qh, kh, vh, is_causal=causal, enable_gqa=True)
            bound_ms, bound_by = bound(case)
            row.update(
                ms=time_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, window=window)),
                plain_ms=time_ms(lambda: naive_attention(
                    q, k, v, causal=causal, window=window)),
                library_ms=time_ms(lib), bound_ms=bound_ms,
                bound_by=bound_by, reported=case == REPORTED)
            ops, nbytes = flash_work(case)
            row.update(ratio=row["ms"] / row["library_ms"],
                       tflops=ops / row["ms"] / 1e9,
                       tbps=nbytes / row["ms"] / 1e9)
            print(f"[kernel] {row['case']}: kernel {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, sdpa "
                  f"{row['library_ms']:.4f} ms, kernel/sdpa "
                  f"{row['ratio']:.2f}x, {row['tflops']:.1f} TFLOP/s, "
                  f"{row['tbps']:.3f} TB/s, bound {bound_ms:.4f} ms "
                  f"({bound_by}), max_abs_err {err:.3g} [{smi}]")
        else:
            print(f"[kernel] {row['case']}: max_abs_err {err:.3g}")
        if not ok:
            fail(f"flash_attention disagrees with its plain version on "
                 f"{row['case']}: max_abs_err {err} > {tol}")
        rows.append(row)
    return rows


def gmm_counts(kind: str, E: int, C: int, gen, dev) -> torch.Tensor:
    if kind in ("zero", "full"):
        return torch.full((E,), 0 if kind == "zero" else C,
                          dtype=torch.int32, device=dev)
    if kind == "random":
        return torch.randint(0, C + 1, (E,), generator=gen, device=dev,
                             dtype=torch.int32)
    if kind == "decode":
        used = torch.randperm(E, generator=gen, device=dev)[:E // 2]
        return torch.zeros((E,), dtype=torch.int32, device=dev).index_fill_(
            0, used, 1)
    T = int(kind.removeprefix("route"))
    probs = torch.softmax(torch.randn((T, E), generator=gen, device=dev), -1)
    tope = torch.topk(probs, 8, dim=-1).indices.reshape(-1)
    return torch.bincount(tope, minlength=E).clamp(max=C).to(torch.int32)


def gmm_work(E, C, D, F, counts, dt) -> tuple[int, int]:
    """Operations, 2 x (rows in use) x D x F, and the bytes a call must
    move: the rows in use of x, the weights of the experts in use, the
    whole output, the counts."""
    rows = int(counts.sum())
    used = int((counts > 0).sum())
    elt = torch.tensor([], dtype=dt).element_size()
    return (2 * rows * D * F,
            elt * (rows * D + used * D * F + E * C * F) + 4 * E)


def gmm_bound(E, C, D, F, counts, dt) -> tuple[float, str]:
    """Least time for this call: its operations over the peak rate of the
    type against its bytes over the memory rate (gmm_work)."""
    ops, nbytes = gmm_work(E, C, D, F, counts, dt)
    t_ops, t_bytes = ops / PEAK_OPS[dt], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_gmm(dev, smi: str) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    for case in GMM_CASES + GMM_EDGES + GMM_SERVE:
        label, E, C, D, F, kind, dt = case
        x = torch.randn((E, C, D), generator=gen, device=dev).to(dt)
        w = (torch.randn((E, D, F), generator=gen, device=dev)
             * D ** -0.5).to(dt)
        counts = gmm_counts(kind, E, C, gen, dev)
        out = gmm.grouped_matmul(x, w, counts)
        torch.cuda.synchronize()
        ref = gmm_reference(x, w, counts)
        err = (out.float() - ref.float()).abs().max().item()
        tol = GMM_TOL[dt]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        name = (f"{label} E={E} C={C} D={D} F={F} {DT_NAME[dt]} "
                f"rows in use {int(counts.sum())}, experts in use "
                f"{int((counts > 0).sum())}")
        row = {"case": name, "max_abs_err": err, "tol": tol, "ok": bool(ok)}
        if case in GMM_SERVE:
            bound_ms, bound_by = gmm_bound(E, C, D, F, counts, dt)
            row.update(
                ms=time_ms(lambda: gmm.grouped_matmul(x, w, counts)),
                plain_ms=time_ms(lambda: gmm_reference(x, w, counts)),
                library_ms=time_ms(lambda: torch.bmm(x, w)),
                bound_ms=bound_ms, bound_by=bound_by,
                reported=case == GMM_REPORTED)
            ops, nbytes = gmm_work(E, C, D, F, counts, dt)
            row.update(ratio=row["ms"] / row["library_ms"],
                       tflops=ops / row["ms"] / 1e9,
                       tbps=nbytes / row["ms"] / 1e9)
            print(f"[gmm] {name}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, bmm {row['library_ms']:.4f} "
                  f"ms, kernel/bmm {row['ratio']:.2f}x, "
                  f"{row['tflops']:.1f} TFLOP/s, {row['tbps']:.3f} TB/s, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), max_abs_err "
                  f"{err:.3g} [{smi}]")
        else:
            print(f"[gmm] {name}: max_abs_err {err:.3g}")
        if not ok:
            fail(f"moe_gmm disagrees with its plain version on {name}: "
                 f"max_abs_err {err} > {tol}")
        rows.append(row)
    return rows


def ssd_inputs(B, S, H, P, N, dt, gen, dev):
    """Inputs at mamba2's scale: x, B and C are silu of the causal conv's
    output (std 0.5 under the model's init), dt is softplus of a unit
    normal (dt_bias 0), A = -exp(A_log) with A_log uniform in [0, log 16]
    (from -1, the init, to -16)."""
    def act(shape):
        return F.silu(0.5 * torch.randn(shape, generator=gen, device=dev))
    x = act((B, S, H, P)).to(dt)
    dtv = F.softplus(torch.randn((B, S, H), generator=gen,
                                 device=dev)).to(dt)
    Bm, Cm = act((B, S, N)).to(dt), act((B, S, N)).to(dt)
    A = -torch.exp(torch.rand((H,), generator=gen, device=dev)
                   * float(np.log(16.0)))
    return x, dtv, Bm, Cm, A


def ssd_work(B, S, H, P, N, chunk, dt) -> tuple[int, int]:
    """Operations: per chunk of q tokens inside the sequence, only the
    q (q + 1) / 2 pairs j <= i of the causal triangle, C B^T once per
    (b, chunk) (B and C are shared across heads, 2 pairs N) and per head
    the intra-chunk product (2 pairs P), the inter-chunk term and the state
    update (2 q N P each). Bytes: x, dt, B, C and A read once, y and the
    final state written once."""
    Q = min(chunk, S)
    elt = torch.tensor([], dtype=dt).element_size()
    ops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        pairs = unmasked_pairs(q, q, True, 0)
        ops += 2 * B * (pairs * N + H * (pairs * P + 2 * q * N * P))
    nbytes = elt * (2 * B * S * H * P + B * S * H + 2 * B * S * N) \
        + 4 * H + 4 * B * H * P * N
    return ops, nbytes


def ssd_bound(B, S, H, P, N, chunk, dt) -> tuple[float, str]:
    """Least time for this call: ssd_work's operations over the peak rate
    of the input type against its bytes over the memory rate."""
    ops, nbytes = ssd_work(B, S, H, P, N, chunk, dt)
    t_ops, t_bytes = ops / PEAK_OPS[dt], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_ssd(dev, smi: str) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows = []
    for case in SSD_CASES + SSD_SERVE:
        label, B, S, H, P, N, chunk, dt = case
        args = ssd_inputs(B, S, H, P, N, dt, gen, dev)
        y, h = ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        yr, hr = ssd_chunked_reference(*args, chunk=chunk)
        rtol = SSD_BF16_RTOL if dt == torch.bfloat16 else 0.0
        err = max((y.float() - yr).abs().max().item(),
                  (h - hr).abs().max().item())
        ok = (y.dtype == dt and h.dtype == torch.float32 and
              torch.allclose(y.float(), yr, atol=SSD_TOL, rtol=rtol) and
              torch.allclose(h, hr, atol=SSD_TOL, rtol=0.0))
        name = (f"{label} B={B} S={S} H={H} P={P} N={N} chunk={chunk} "
                f"{DT_NAME[dt]}")
        row = {"case": name, "max_abs_err": err, "tol": SSD_TOL,
               "rtol": rtol, "ok": bool(ok)}
        if case in SSD_SERVE:
            bound_ms, bound_by = ssd_bound(B, S, H, P, N, chunk, dt)
            row.update(
                ms=time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk)),
                plain_ms=time_ms(lambda: ssd_chunked_reference(
                    *args, chunk=chunk)),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                reported=case == SSD_REPORTED)
            ops, _ = ssd_work(B, S, H, P, N, chunk, dt)
            row.update(graph_ms=graph_ms(lambda: ssd.ssd_scan(
                *args, chunk=chunk)))
            row.update(gflops=ops / row["graph_ms"] / 1e6,
                       bound_share=bound_ms / row["graph_ms"])
            print(f"[ssd] {name}: kernel {row['ms']:.4f} ms (calls back to "
                  f"back), {row['graph_ms']:.4f} ms (CUDA graph, device "
                  f"only), plain {row['plain_ms']:.4f} ms, library none, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{row['gflops']:.0f} GFLOP/s and "
                  f"{100 * row['bound_share']:.1f}% of the bound on the "
                  f"device time, max_abs_err {err:.3g} [{smi}]")
        else:
            print(f"[ssd] {name}: max_abs_err {err:.3g}")
        if not ok:
            fail(f"ssd_scan disagrees with its plain version on {name}: "
                 f"max_abs_err {err} (atol {SSD_TOL}, rtol {rtol})")
        rows.append(row)
    return rows


def rglru_inputs(B, S, C, scale, with_h0, dt, gen, dev):
    """log_a = -|N(0,1)| x scale and gx = N(0,1), as tests/test_kernels.py
    draws them; or, for scale "model", at recurrentgemma-9b's scale:
    log_a = -8 softplus(lam) r with lam = 1 (the init) and r = sigmoid(N),
    gx = sqrt(1 - a^2) i x with i = sigmoid(N), x = N (the mixer's
    formulas). An optional f32 initial state."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    if scale == "model":
        log_a = -8.0 * float(F.softplus(torch.tensor(1.0))) * torch.sigmoid(
            randn(B, S, C))
        gx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                    min=1e-12)) * torch.sigmoid(
            randn(B, S, C)) * randn(B, S, C)
    else:
        log_a = -randn(B, S, C).abs() * scale
        gx = randn(B, S, C)
    h0 = randn(B, C) if with_h0 else None
    return log_a.to(dt), gx.to(dt), h0


def rglru_work(B, S, C, with_h0, dt) -> tuple[int, int]:
    """Operations, an exp and an FMA (3) per element, and bytes: log_a and
    gx read once, h written once in the input type, h0 read and the last h
    written in f32."""
    elt = torch.tensor([], dtype=dt).element_size()
    return (3 * B * S * C,
            elt * 3 * B * S * C + 4 * B * C * (2 if with_h0 else 1))


def rglru_bound(B, S, C, with_h0, dt) -> tuple[float, str]:
    """Least time for this call: rglru_work's bytes over the memory rate
    against its operations at the f32 rate (the arithmetic is f32 in
    either type)."""
    ops, nbytes = rglru_work(B, S, C, with_h0, dt)
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_rglru(dev, smi: str) -> list[dict]:
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    for case in RG_CASES + RG_SERVE:
        label, B, S, C, scale, with_h0, dt = case
        log_a, gx, h0 = rglru_inputs(B, S, C, scale, with_h0, dt, gen, dev)
        y, h = rg.rglru_scan(log_a, gx, h0)
        torch.cuda.synchronize()
        # the plain version in f32 on the same widened inputs: a bf16 h is
        # rounded once, half an ulp, at most 2^-8 of |h|
        yr, hr = rglru_scan_reference(log_a.float(), gx.float(), h0)
        rtol = RG_BF16_RTOL if dt == torch.bfloat16 else 0.0
        err = max((y.float() - yr).abs().max().item(),
                  (h - hr).abs().max().item())
        ok = (y.dtype == dt and h.dtype == torch.float32 and
              torch.allclose(y.float(), yr, atol=RG_TOL, rtol=rtol) and
              torch.allclose(h, hr, atol=RG_TOL, rtol=0.0))
        name = (f"{label} B={B} S={S} C={C} log_a scale {scale}"
                f"{' h0' if with_h0 else ''} {DT_NAME[dt]}")
        row = {"case": name, "max_abs_err": err, "tol": RG_TOL,
               "rtol": rtol, "ok": bool(ok)}
        if case in RG_SERVE:
            bound_ms, bound_by = rglru_bound(B, S, C, with_h0, dt)
            row.update(
                ms=time_ms(lambda: rg.rglru_scan(log_a, gx, h0)),
                plain_ms=time_ms(lambda: rglru_scan_reference(log_a, gx, h0),
                                 iters=3, warmup=1),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                reported=case == RG_REPORTED)
            _, nbytes = rglru_work(B, S, C, with_h0, dt)
            row.update(graph_ms=graph_ms(lambda: rg.rglru_scan(
                log_a, gx, h0)))
            row.update(gbps=nbytes / row["graph_ms"] / 1e6,
                       bound_share=bound_ms / row["graph_ms"])
            print(f"[rglru] {name}: kernel {row['ms']:.4f} ms (calls back "
                  f"to back), {row['graph_ms']:.4f} ms (CUDA graph, device "
                  f"only), plain {row['plain_ms']:.4f} ms, library none, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{row['gbps']:.0f} GB/s and "
                  f"{100 * row['bound_share']:.1f}% of the bound on the "
                  f"device time, max_abs_err {err:.3g} [{smi}]")
        else:
            print(f"[rglru] {name}: max_abs_err {err:.3g}")
        if not ok:
            fail(f"rglru_scan disagrees with its plain version on {name}: "
                 f"max_abs_err {err} (atol {RG_TOL}, rtol {rtol})")
        rows.append(row)
    return rows


def batch_caches(caches, lens, max_seq: int) -> dict:
    """Batch-1 prefill caches -> one batched decode cache, as the engine
    fills its slots: every attention leaf ("k", "v": (L, 1, S_i, Hkv, D))
    zero-padded into an (L, B, max_seq, Hkv, D) buffer at rows [0, S_i),
    every state leaf concatenated along the batch. Rows past a sequence's
    length are never read (decode_attention masks kpos > pos)."""
    def walk(name, leaves):
        if isinstance(leaves[0], dict):
            return {k: walk(k, [c[k] for c in leaves]) for k in leaves[0]}
        if name in ("k", "v"):
            a = leaves[0]
            out = a.new_zeros((a.shape[0], len(leaves), max_seq)
                              + tuple(a.shape[3:]))
            for i, (c, n) in enumerate(zip(leaves, lens)):
                out[:, i, :n] = c[:, 0]
            return out
        return torch.cat(leaves, dim=1)
    return walk(None, list(caches))


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, path + (k,))]
    return [("/".join(path), tree)]


def greedy_oracle(api, params, prompt, n_new: int, dev) -> list[int]:
    """Greedy rollout by re-prefilling the whole sequence each step."""
    toks = list(int(t) for t in prompt)
    out = []
    for _ in range(n_new):
        logits, _ = api.prefill_fn(
            params, {"tokens": torch.tensor([toks], device=dev)})
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


def rollout_oracle(api, params, prompt, n_new: int, dev,
                   max_seq: int) -> list[int]:
    """Greedy rollout of one request at batch 1: prefill_fn once, then
    decode_fn on a max_seq attention cache, as the engine does for its
    slots (state leaves are taken as prefill_fn returns them)."""
    logits, pre = api.prefill_fn(
        params, {"tokens": torch.tensor([[int(t) for t in prompt]],
                                        device=dev)})
    S_p = len(prompt)
    caches = batch_caches([pre], [S_p], max_seq)
    out = [int(torch.argmax(logits[0, -1]))]
    for i in range(n_new - 1):
        logits, caches = api.decode_fn(
            params, caches, torch.tensor([[out[-1]]], device=dev),
            torch.tensor([S_p + i], device=dev))
        out.append(int(torch.argmax(logits[0, -1])))
    return out


KERNELS = {"flash_attention": fa, "moe_gmm": gmm, "ssd_scan": ssd,
           "rglru_scan": rg}


def reset_launches() -> None:
    for m in KERNELS.values():
        m.reset_launches()


def read_launches() -> dict:
    return {name: m.launches for name, m in KERNELS.items()}


def phase_serving(dev, smi: str, arch: str, duration: float) -> dict:
    cfg = get_config(arch)
    moe = cfg.family == "moe"
    parallel = ParallelConfig(param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    api = build_model(cfg, parallel, dev)
    t0 = time.perf_counter()
    params = api.init(seed=0)
    torch.cuda.synchronize()
    print(f"[serve] {arch} full width, {cfg.n_layers} layers, "
          f"{api.n_params() / 1e9:.3f} B params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    lines = []

    def log(line):
        lines.append(line)
        print(f"{line} [{smi}]")

    reset_launches()
    t0 = time.perf_counter()
    res = serve.run(cfg, parallel, device=dev, n_requests=len(SERVE_PROMPTS),
                    max_new=SERVE_MAX_NEW, prompt_lens=SERVE_PROMPTS,
                    max_batch=4, max_seq=2048, duration=duration, api=api,
                    params=params, log=log)
    launches = read_launches()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reqs = res["requests"]
    lat = res["latency_ms"]
    busy = res["busy_quantum_ms"]
    prefills = len(reqs) + 1                    # + the warm-up request
    decode_steps = res["engine"].decode_steps + 1   # + the warm-up's step
    expect = {"flash_attention": cfg.n_layers * prefills,
              "moe_gmm": 3 * cfg.n_layers * (prefills + decode_steps)
              if moe else 0, "ssd_scan": 0, "rglru_scan": 0}
    print(f"[serve] {arch} launches {launches} (expected {expect}: "
          f"{prefills} prefills, {decode_steps} decode steps); "
          f"decode quantum response p50 {np.percentile(lat, 50):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms over {len(lat)} quanta; "
          f"busy quanta (refill + decode) p50 "
          f"{np.percentile(busy, 50):.3f} ms, p99 "
          f"{np.percentile(busy, 99):.3f} ms, max {busy.max():.3f} ms over "
          f"{len(busy)}; "
          f"be_quanta {res['stats']['be_quanta']}; peak memory "
          f"{peak_gb:.2f} GB; run {wall:.1f} s [{smi}]")
    not_done = [r.rid for r in reqs
                if not r.done or len(r.out) != SERVE_MAX_NEW]
    if not_done:
        fail(f"{arch}: requests {not_done} did not finish with "
             f"{SERVE_MAX_NEW} tokens")
    for name, n in expect.items():
        if launches[name] != n:
            fail(f"{arch}: {name} launched {launches[name]} times on the "
                 f"serve path, expected {n}")
    # the engine alone (no executor, no best-effort thread): one decode
    # step over 4 busy slots and one 1024-token prefill, host clock around
    # work that ends in a synchronize
    engine = ServingEngine(api, params, max_batch=4, max_seq=2048)
    rng = np.random.default_rng(5)
    for i in range(4):
        engine.add_request(Request(rid=i, max_new=10**6, prompt=rng.integers(
            0, cfg.vocab_size, size=(32,)).astype(np.int32)))
    steps = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.decode_step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                             device=dev)
    pre = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    del engine
    step_ms = float(np.median(steps[2:]))
    prefill_ms = float(np.median(pre[1:]))
    print(f"[serve] {arch} engine alone: decode step (4 slots) median "
          f"{step_ms:.3f} ms of {len(steps) - 2}, 1024-token prefill median "
          f"{prefill_ms:.3f} ms of {len(pre) - 1} [{smi}]")
    # bf16 oracle, reported only: bf16 rounding differs between the batched
    # decode step and the oracle, so near-ties may flip (phase e/e2 checks)
    r0 = reqs[0]
    o16 = rollout_oracle(api, params, r0.prompt, SERVE_MAX_NEW, dev, 2048) \
        if moe else greedy_oracle(api, params, r0.prompt, SERVE_MAX_NEW, dev)
    agree = next((i for i, (a, b) in enumerate(zip(r0.out, o16)) if a != b),
                 SERVE_MAX_NEW)
    kind = "batch-1 rollout" if moe else "re-prefill rollout"
    print(f"[serve] {arch} bf16 request 0: first {agree}/{SERVE_MAX_NEW} "
          f"tokens equal the bf16 {kind} (reported, not checked)")
    return {"api": api, "params": params, "launches": launches,
            "prefills": prefills, "decode_steps": decode_steps,
            "decode_p50_ms": float(np.percentile(lat, 50)),
            "decode_p99_ms": float(np.percentile(lat, 99)),
            "decode_quanta": int(len(lat)),
            "busy_p50_ms": float(np.percentile(busy, 50)),
            "busy_p99_ms": float(np.percentile(busy, 99)),
            "busy_max_ms": float(busy.max()), "busy_quanta": int(len(busy)),
            "be_quanta": res["stats"]["be_quanta"], "peak_gb": peak_gb,
            "bf16_oracle_prefix": agree, "engine_decode_step_ms": step_ms,
            "engine_prefill_1024_ms": prefill_ms, "lines": lines}


def plain_ssd_scan(xh, dt, Bm, Cm, A, *, chunk):
    """ssd_scan's plain version with the wrapper's interface."""
    y, h = ssd_chunked_reference(xh, dt, Bm, Cm, A, chunk=chunk)
    return y.to(xh.dtype), h


def through_plain(fn):
    """fn() run with each kernel's wrapper swapped for its plain version."""
    saved = M.grouped_matmul, L.flash_attention, MB.ssd_scan, RG.rglru_scan
    M.grouped_matmul, L.flash_attention, MB.ssd_scan, RG.rglru_scan = \
        gmm_reference, naive_attention, plain_ssd_scan, rglru_scan_reference
    try:
        return fn()
    finally:
        M.grouped_matmul, L.flash_attention, MB.ssd_scan, \
            RG.rglru_scan = saved


def check_plain_path(api, params, dev, max_seq: int) -> dict:
    """The f32 logits through the kernels equal those of the same calls with
    each kernel's wrapper swapped for its plain version, within
    PLAIN_PATH_TOL: a prefill, then PLAIN_PATH_STEPS decode steps over one
    slot per prompt of PLAIN_PATH_PROMPTS, each slot at its own position,
    on the same teacher-forced tokens; the caches after them too. The whole
    model checked at full width, beyond what the greedy tokens of random
    weights show."""
    cfg = api.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=(n,))
               for n in PLAIN_PATH_PROMPTS]
    feed = torch.as_tensor(rng.integers(
        1, cfg.vocab_size, size=(PLAIN_PATH_STEPS, len(prompts), 1)),
        device=dev)
    lens = torch.tensor(PLAIN_PATH_PROMPTS, device=dev)
    errs = {}

    def check(what, got, want):
        err = (got - want).abs().max().item()
        errs[what] = max(errs.get(what, 0.0), err)
        if not torch.allclose(got, want, atol=PLAIN_PATH_TOL,
                              rtol=PLAIN_PATH_TOL):
            fail(f"{cfg.name}: f32 {what} through the kernels differ from "
                 f"the plain versions' by {err}")

    batch = {"tokens": torch.as_tensor(prompts[0][None], device=dev)}
    got, _ = api.prefill_fn(params, batch)
    want, _ = through_plain(lambda: api.prefill_fn(params, batch))
    check("prefill logits", got, want)
    # slot caches filled by batch-1 prefills, as the engine fills them
    caches = batch_caches(
        [api.prefill_fn(params, {"tokens": torch.as_tensor(
            p[None], device=dev)})[1] for p in prompts],
        PLAIN_PATH_PROMPTS, max_seq)

    def decode():
        c = {n: t.clone() for n, t in caches.items()}
        logits = []
        for j in range(PLAIN_PATH_STEPS):
            out, c = api.decode_fn(params, c, feed[j], lens + j)
            logits.append(out)
        return torch.stack(logits), c

    got, got_c = decode()
    want, want_c = through_plain(decode)
    check("decode logits", got, want)
    for n in ("k", "v"):
        check("decode caches", got_c[n], want_c[n])
    print(f"[oracle] {cfg.name} f32, kernels vs plain versions: max_abs_err "
          + ", ".join(f"{w} {e:.3g}" for w, e in errs.items())
          + f" (prefill, then {PLAIN_PATH_STEPS} decode steps over "
          f"{len(prompts)} slots at positions {PLAIN_PATH_PROMPTS}; logits "
          f"std {want.std().item():.3g}, tolerance {PLAIN_PATH_TOL})")
    return errs


def phase_oracle(dev, api16, params16) -> dict:
    """(e) for the dense model: the re-prefill oracle; (e2) for MoE: the
    batch-1 prefill + decode rollout (see the module docstring)."""
    moe = api16.cfg.family == "moe"
    cfg = dataclasses.replace(api16.cfg, dtype="float32")
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg, parallel, dev)
    params = api.load(L.tree_map(lambda _, a: a.float(), params16))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (32, 20)]
    reqs = [Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(zip(prompts, (16, 8)))]
    engine = ServingEngine(api, params, max_batch=2, max_seq=128)
    engine.run_until_done(reqs, max_steps=100)
    kind = "batch-1 rollout" if moe else "re-prefill"
    for r in reqs:
        oracle = rollout_oracle(api, params, r.prompt, r.max_new, dev, 128) \
            if moe else greedy_oracle(api, params, r.prompt, r.max_new, dev)
        print(f"[oracle] {cfg.name} f32 request {r.rid}: engine {r.out}")
        print(f"[oracle] {cfg.name} f32 request {r.rid}: {kind} {oracle}")
        if not r.done or r.out != oracle:
            fail(f"{cfg.name}: f32 engine tokens of request {r.rid} differ "
                 f"from the {kind} greedy oracle")
    print(f"[oracle] {cfg.name} f32 engine tokens equal the {kind} oracle on "
          f"both requests")
    errs = check_plain_path(api, params, dev, 128) if moe else {}
    del params
    return errs


def gang_expect(cfg, n_prefills: int) -> dict:
    """Kernel launches of a gang run: per prefill, one scan for each
    recurrent layer (ssd_scan for Mamba2, rglru_scan for RG-LRU) and one
    flash for each attention layer; a decode step launches no kernel."""
    kinds = cfg.layer_kinds()
    return {"flash_attention": kinds.count("attn") * n_prefills,
            "moe_gmm": 0, "ssd_scan": kinds.count("ssm") * n_prefills,
            "rglru_scan": kinds.count("rec") * n_prefills}


def phase_gang(dev, smi: str, arch: str, duration: float,
               max_seq: int) -> dict:
    """(d3) / (d4): the batched decode step of a state-cache model
    (mamba2-1.3b, recurrentgemma-9b) as the RT gang."""
    cfg = get_config(arch)
    parallel = ParallelConfig(param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    api = build_model(cfg, parallel, dev)
    t0 = time.perf_counter()
    params = api.init(seed=0)
    torch.cuda.synchronize()
    print(f"[{arch}] full width, {cfg.n_layers} layers, "
          f"{api.n_params() / 1e9:.3f} B params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, n)),
                               device=dev) for n in GANG_PROMPTS]
    lens = torch.tensor(GANG_PROMPTS, device=dev)
    # warm-up, outside the counted run: a prefill and a decode step
    _, c = api.prefill_fn(params, {"tokens": prompts[0]})
    api.decode_fn(params, batch_caches([c], GANG_PROMPTS[:1], max_seq),
                  prompts[0][:, :1], lens[:1])
    del c
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    state = {"caches": None, "tok": None}
    out, busy_ms = [], []

    def decode_quantum(lane, idx):
        """The first quantum prefills the 4 prompts; each later one decodes
        one token of all 4 sequences, until each has GANG_NEW."""
        if len(out) == GANG_NEW:
            return
        t0 = time.perf_counter()
        if state["caches"] is None:
            pre = [api.prefill_fn(params, {"tokens": p}) for p in prompts]
            state["caches"] = batch_caches([c for _, c in pre], GANG_PROMPTS,
                                           max_seq)
            state["tok"] = torch.cat([lg[:, -1].argmax(-1, keepdim=True)
                                      for lg, _ in pre])
        else:
            logits, _ = api.decode_fn(params, state["caches"], state["tok"],
                                      lens + len(out) - 1)
            state["tok"] = logits[:, -1].argmax(-1, keepdim=True)
        out.append(state["tok"])
        busy_ms.append((time.perf_counter() - t0) * 1e3)

    reset_launches()
    t0 = time.perf_counter()
    stats = serve.run_gang(decode_quantum, dev, duration)
    launches = read_launches()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lat = np.array(stats["response_times"].get("decode", [0.0])) * 1e3
    busy = np.array(busy_ms)
    expect = gang_expect(cfg, len(GANG_PROMPTS))
    print(f"[{arch}] gang: launches {launches} (expected {expect}: "
          f"{len(GANG_PROMPTS)} prefills, {max(len(out) - 1, 0)} decode "
          f"steps over {len(GANG_PROMPTS)} sequences); decode quantum "
          f"response p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms over {len(lat)} quanta; busy "
          f"quanta (prefill + decode) p50 {np.percentile(busy, 50):.3f} ms, "
          f"p99 {np.percentile(busy, 99):.3f} ms, max {busy.max():.3f} ms "
          f"over {len(busy)}; be_quanta {stats['be_quanta']}; peak memory "
          f"{peak_gb:.2f} GB; run {wall:.1f} s [{smi}]")
    if len(out) != GANG_NEW:
        fail(f"{arch}: the gang made {len(out)} of {GANG_NEW} tokens per "
             f"sequence in {duration} s")
    for name, n in expect.items():
        if launches[name] != n:
            fail(f"{arch}: {name} launched {launches[name]} times on the "
                 f"gang path, expected {n}")
    tokens = torch.cat(out, dim=1)
    if tokens.shape != (len(GANG_PROMPTS), GANG_NEW) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"{arch}: gang tokens of shape {tuple(tokens.shape)} out of "
             f"range")
    # alone (no executor, no best-effort thread): one decode step over the
    # 4 sequences and one 1024-token prefill, host clock around work that
    # ends in a synchronize
    caches = L.tree_map(lambda _, t: t.clone(), state["caches"])
    steps = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_fn(params, caches, state["tok"], lens + GANG_NEW + i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    del caches
    p1024 = prompts[GANG_PROMPTS.index(1024)]
    pre = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill_fn(params, {"tokens": p1024})
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(steps[2:]))
    prefill_ms = float(np.median(pre[1:]))
    print(f"[{arch}] alone: decode step (4 sequences) median {step_ms:.3f} "
          f"ms of {len(steps) - 2}, 1024-token prefill median "
          f"{prefill_ms:.3f} ms of {len(pre) - 1} [{smi}]")
    return {"api": api, "params": params, "launches": launches,
            "prefills": len(GANG_PROMPTS), "decode_steps": len(out) - 1,
            "decode_p50_ms": float(np.percentile(lat, 50)),
            "decode_p99_ms": float(np.percentile(lat, 99)),
            "decode_quanta": int(len(lat)),
            "busy_p50_ms": float(np.percentile(busy, 50)),
            "busy_p99_ms": float(np.percentile(busy, 99)),
            "busy_max_ms": float(busy.max()), "busy_quanta": int(len(busy)),
            "be_quanta": stats["be_quanta"], "peak_gb": peak_gb,
            "decode_step_ms": step_ms, "prefill_1024_ms": prefill_ms,
            "tokens": tokens.tolist()}


def phase_gang_oracle(dev, api16, params16, max_seq: int) -> dict:
    """(e3) / (e4): f32 at full width on the gang's weights (the bf16 copy
    is let go once the f32 one exists)."""
    cfg = dataclasses.replace(api16.cfg, dtype="float32")
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg, parallel, dev)
    params = api.load(L.tree_map(lambda _, a: a.float(), params16))
    del params16
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=(n,))
               for n in GANG_PROMPTS]
    feed = torch.as_tensor(rng.integers(
        1, cfg.vocab_size, size=(PLAIN_PATH_STEPS, len(prompts), 1)),
        device=dev)
    lens = torch.tensor(GANG_PROMPTS, device=dev)
    errs = {}

    def check(what, got, want):
        err = (got - want).abs().max().item()
        errs[what] = max(errs.get(what, 0.0), err)
        if not torch.allclose(got, want, atol=PLAIN_PATH_TOL,
                              rtol=PLAIN_PATH_TOL):
            fail(f"{cfg.name}: f32 {what} through the kernels differ from "
                 f"the plain versions' by {err}")

    def run():
        """The 4 prefills, then PLAIN_PATH_STEPS teacher-forced decode
        steps over the 4 sequences: (prefill logits, caches after the
        prefills, decode logits, caches after the decode steps)."""
        pre = [api.prefill_fn(params, {"tokens": torch.as_tensor(
            p[None], device=dev)}) for p in prompts]
        caches = batch_caches([c for _, c in pre], GANG_PROMPTS, max_seq)
        first = L.tree_map(lambda _, t: t.clone(), caches)
        logits = []
        for j in range(PLAIN_PATH_STEPS):
            out, caches = api.decode_fn(params, caches, feed[j], lens + j)
            logits.append(out)
        return (torch.cat([lg for lg, _ in pre]), first,
                torch.stack(logits), caches)

    reset_launches()
    got = run()
    expect = gang_expect(cfg, len(prompts))
    if read_launches() != expect:
        fail(f"{cfg.name}: f32 prefills launched {read_launches()}, "
             f"expected {expect}")
    want = through_plain(run)
    check("prefill logits", got[0], want[0])
    check("decode logits", got[2], want[2])
    for what, i in (("prefill caches", 1), ("decode caches", 3)):
        for (path, g), (_, w) in zip(leaves(got[i]), leaves(want[i])):
            check(f"{what} {path}", g, w)
    del got, want
    print(f"[oracle] {cfg.name} f32, kernels vs plain versions: max_abs_err "
          + ", ".join(f"{w} {e:.3g}" for w, e in errs.items())
          + f" (prefills of {GANG_PROMPTS} tokens, then {PLAIN_PATH_STEPS} "
          f"decode steps over the {len(prompts)} sequences; tolerance "
          f"{PLAIN_PATH_TOL})")

    # batched greedy decode == each sequence's batch-1 rollout
    pre = [api.prefill_fn(params, {"tokens": torch.as_tensor(
        p[None], device=dev)}) for p in prompts]
    caches = batch_caches([c for _, c in pre], GANG_PROMPTS, max_seq)
    tok = torch.cat([lg[:, -1].argmax(-1, keepdim=True) for lg, _ in pre])
    del pre
    batched = [tok]
    for i in range(GANG_ORACLE_NEW - 1):
        logits, caches = api.decode_fn(params, caches, tok, lens + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        batched.append(tok)
    del caches
    batched = torch.cat(batched, dim=1).tolist()
    reprefill = []
    for i, p in enumerate(prompts):
        alone = rollout_oracle(api, params, p, GANG_ORACLE_NEW, dev, max_seq)
        print(f"[oracle] {cfg.name} f32 sequence {i}: batched {batched[i]}")
        print(f"[oracle] {cfg.name} f32 sequence {i}: batch-1 rollout "
              f"{alone}")
        if batched[i] != alone:
            fail(f"{cfg.name}: f32 batched greedy tokens of sequence {i} "
                 f"differ from its batch-1 rollout")
        again = greedy_oracle(api, params, p, GANG_ORACLE_NEW, dev)
        reprefill.append(next((k for k, (a, b) in enumerate(
            zip(batched[i], again)) if a != b), GANG_ORACLE_NEW))
    print(f"[oracle] {cfg.name} f32 batched tokens equal the batch-1 rollout "
          f"on all {len(prompts)} sequences; they equal a re-prefill rollout "
          f"for the first {reprefill} of {GANG_ORACLE_NEW} tokens "
          f"(reported, not checked)")
    del params
    return {"plain_path_err": errs, "reprefill_prefix": reprefill}


def device_events(fn, name: str) -> list[dict]:
    """The device events (kernels, copies, memsets) of ``fn()`` under
    ``torch.profiler``, from its chrome trace (``build/trace_<name>.json``):
    name, stream, start and duration in µs (device clock)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / f"trace_{name}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    return [{"name": e["name"], "stream": e.get("args", {}).get("stream"),
             "ts": float(e["ts"]), "dur": float(e["dur"])}
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def dave2_flops(cfg, batch: int) -> int:
    """Operations of one forward: 2 per multiply-add of the convs and the
    fc products (bias adds and tanh not counted)."""
    h, w = cfg.input_hw
    c_in, ops = cfg.in_channels, 0
    for c_out, k, s in cfg.conv:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        ops += 2 * k * k * c_in * c_out * h * w
        c_in = c_out
    dims = (h * w * c_in,) + cfg.fc + (cfg.n_outputs,)
    ops += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return batch * ops


def dave2_scaled_params(cfg, gen) -> dict:
    """DAVE-2 weights at std 1/sqrt(fan_in) of the HWIO / (in, out) shape
    and biases N(0, 0.1): unlike the init rule's (zero biases, conv
    pre-activations of std ~k that saturate tanh), a dropped bias or a
    flipped kernel changes the output."""
    out = {}
    for k, d in DV.dave2_defs(cfg).items():
        if k.endswith("_b"):
            out[k] = torch.randn(d.shape, generator=gen) * 0.1
        else:
            v = torch.randn(d.shape, generator=gen) / np.sqrt(
                np.prod(d.shape[:-1]))
            out[k] = DV.conv_weight(v) if v.dim() == 4 else v
    return out


def phase_dave2(dev, smi: str) -> dict:
    """(f) DAVE-2 on the card against the same module on the CPU, and its
    B=1 forward's time back to back, in a CUDA graph and as device
    events."""
    cfg = DAVE2
    params, model = DV.make_dave2(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    weights = {"init rule": params,
               "scaled": {k: v.to(dev) for k, v in
                          dave2_scaled_params(cfg, gen).items()}}
    errs = {}
    for label, p in weights.items():
        card = DV.Dave2(cfg, p)
        cpu = DV.Dave2(cfg, {k: v.cpu() for k, v in p.items()})
        for b in DAVE2_BATCHES:
            x = torch.rand((b, *cfg.input_hw, cfg.in_channels), generator=gen)
            got, want = card(x.to(dev)).cpu(), cpu(x)
            if got.shape != (b, cfg.n_outputs) or \
                    not torch.isfinite(got).all():
                fail(f"dave2 {label} B={b}: output {tuple(got.shape)}, "
                     f"finite {bool(torch.isfinite(got).all())}")
            errs[f"{label} B={b}"] = float((got - want).abs().max())
            if errs[f"{label} B={b}"] > DAVE2_TOL:
                fail(f"dave2 {label} B={b}: card vs CPU max_abs_err "
                     f"{errs[f'{label} B={b}']:.3g} > {DAVE2_TOL}")
    print("[dave2] f32 (TF32 off), card vs the same module on the CPU: "
          "max_abs_err " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f" (tolerance {DAVE2_TOL})")

    x1 = torch.ones((1, *cfg.input_hw, cfg.in_channels), device=dev)
    fwd = functools.partial(model, x1)
    ms, g_ms = time_ms(fwd, iters=100), graph_ms(fwd, iters=20)
    n_fwd = 20
    events = device_events(lambda: [fwd() for _ in range(n_fwd)], "dave2")
    busy_ms = sum(e["dur"] for e in events) / 1e3 / n_fwd
    names = sorted({e["name"] for e in events})
    by_name: dict = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    mflop = dave2_flops(cfg, 1) / 1e6
    print(f"[dave2] B=1 forward: {ms:.4f} ms back to back (CUDA events, 100 "
          f"calls), {g_ms:.4f} ms in a CUDA graph (device time), "
          f"{len(events) / n_fwd:g} device launches a forward ({busy_ms:.4f} "
          f"ms of them busy, torch.profiler, {len(names)} distinct kernels); "
          f"{mflop:.2f} MFLOP a frame [{smi}]")
    print("[dave2] B=1 top device events, ms a forward: " + "; ".join(
        f"{d / 1e3 / n_fwd:.4f} {n[:60]}" for n, d in top))
    return {"max_abs_err": errs, "tol": DAVE2_TOL, "b1_ms": ms,
            "b1_graph_ms": g_ms, "launches_per_forward": len(events) / n_fwd,
            "b1_busy_ms": busy_ms, "kernels": names, "mflop_per_frame": mflop,
            "b1_top_ms": {n: d / 1e3 / n_fwd for n, d in top}}


def overlap(dnn: list[dict], others: list[dict]) -> dict:
    """How much of the DNN's kernel time the other kernels ran beside it."""
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in others):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    dnn_us = sum(e["dur"] for e in dnn)
    both_us = sum(max(0.0, min(b, e["ts"] + e["dur"]) - max(a, e["ts"]))
                  for e in dnn for a, b in merged)
    return {"dnn_kernel_ms": dnn_us / 1e3, "overlap_ms": both_us / 1e3,
            "share": both_us / dnn_us if dnn_us else 0.0,
            "dnn_kernels": len(dnn), "other_kernels": len(others),
            "other_busy_ms": sum(b - a for a, b in merged) / 1e3}


def phase_fig1(dev, smi: str) -> dict:
    """(g) the port's Fig.1 benchmark; then one co-run traced, to show that
    the memory co-runner's kernels run beside the DNN's (streams of their
    own) rather than queue behind them."""
    rows = fig1.run(dev)
    for r in rows:
        print(f"[fig1] {r}")
    _, model = DV.make_dave2(DAVE2, device=dev)
    img = torch.ones((fig1.BATCH, *DAVE2.input_hw, DAVE2.in_channels),
                     device=dev)
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()

    def dnn():
        with torch.cuda.stream(stream):
            model(img)

    def corun():
        with fig1.hammering(dev):
            fig1.time_fn(dnn, stream, iters=10)
    by_stream: dict = {}
    for e in device_events(corun, "fig1_corun"):
        by_stream.setdefault(e["stream"], []).append(e)
    if len(by_stream) < 2:
        fail(f"fig1: the co-run trace holds kernels on {len(by_stream)} "
             f"stream(s)")
    # the DNN's stream has the most distinct kernels, the co-runner's is
    # the busiest other one
    mine = max(by_stream, key=lambda s: len({e["name"]
                                             for e in by_stream[s]}))
    hog = max((s for s in by_stream if s != mine),
              key=lambda s: sum(e["dur"] for e in by_stream[s]))
    ov = overlap(by_stream[mine], by_stream[hog])
    print(f"[fig1] co-run traced (torch.profiler): the DNN's "
          f"{ov['dnn_kernels']} kernels take {ov['dnn_kernel_ms']:.4f} ms, "
          f"{ov['overlap_ms']:.4f} ms of it ({ov['share']:.3f}) beside the "
          f"co-runner's {ov['other_kernels']} kernels "
          f"({ov['other_busy_ms']:.4f} ms busy) [{smi}]")
    if ov["overlap_ms"] <= 0:
        fail("fig1: the co-runner's kernels never ran beside the DNN's: "
             "the co-run measured queueing, not contention")
    return {"rows": rows, "overlap": ov}


def phase_fig6(dev, smi: str, dnn_kernels: list[str]) -> dict:
    """(h) the port's Fig.6 benchmark: Solo, Co-Sched and RT-Gang; then the
    DNN alone on the executor at its period, and each mode again under
    torch.profiler for the DNN's kernel time a quantum and its overlap with
    the best-effort kernels (the DNN's kernels are those of phase (f))."""
    rows = fig6.run(duration=FIG6_DURATION, device=dev)
    modes = ("solo",) + tuple(m for m, _, _ in fig6.MODES)
    for mode in modes:
        r = rows.get(mode, {})
        if not r.get("n"):
            fail(f"fig6 {mode}: no DNN quantum ran ({r})")
        print(f"[fig6] {mode}: p50 {r['p50_ms']} ms, p95 {r['p95_ms']} ms, "
              f"p99 {r['p99_ms']} ms, max {r['max_ms']} ms, n {r['n']}, "
              f"be_quanta {r.get('be_quanta', '-')}")
    for mode in modes:
        r = rows[mode]
        print(f"[fig6] {mode}: DNN quantum on its lane's stream (CUDA "
              f"events) p50 {r['dev_p50_ms']} ms, p99 {r['dev_p99_ms']} ms; "
              f"of the wall p50 / p99 {r['dev_p50_ms'] / r['p50_ms']:.3f} / "
              f"{r['dev_p99_ms'] / r['p99_ms']:.3f} [{smi}]")
    solo = rows["solo"]
    print(f"[fig6] against Solo (reported, not checked): p50 Co-Sched "
          f"{rows['cosched']['p50_ms'] / solo['p50_ms']:.3f}x, RT-Gang "
          f"{rows['rtgang']['p50_ms'] / solo['p50_ms']:.3f}x; p99 Co-Sched "
          f"{rows['cosched']['p99_ms'] / solo['p99_ms']:.3f}x, RT-Gang "
          f"{rows['rtgang']['p99_ms'] / solo['p99_ms']:.3f}x")

    bench = fig6.Fig6(dev)
    alone = bench.gang(True, 0.0, FIG6_DURATION, best_effort=False)
    print(f"[fig6] the DNN alone on the executor at its 20 ms period (no "
          f"best-effort job): p50 {alone['p50_ms']} ms, p99 "
          f"{alone['p99_ms']} ms, max {alone['max_ms']} ms, n {alone['n']}; "
          f"lane stream p50 {alone['dev_p50_ms']} ms [{smi}]")
    traced = {}
    for mode in modes:
        out = {}
        if mode == "solo":
            def go():
                out["row"] = bench.solo()
        else:
            enabled, budget = next((e, b) for m, e, b in fig6.MODES
                                   if m == mode)

            def go():
                out["row"] = bench.gang(enabled, budget, FIG6_TRACED_S)
        events = device_events(go, f"fig6_{mode}")
        row = out["row"]
        n = row["n"]
        mine = [e for e in events if e["name"] in dnn_kernels]
        ov = overlap(mine, [e for e in events
                            if e["name"] not in dnn_kernels])
        t = traced[mode] = dict(
            ov, n=n, dnn_busy_ms=ov["dnn_kernel_ms"] / n,
            dnn_launches=ov["dnn_kernels"] / n, wall_p50_ms=row["p50_ms"],
            stream_p50_ms=row["dev_p50_ms"])
        span = "100 calls" if mode == "solo" else f"{FIG6_TRACED_S} s"
        print(f"[fig6] {mode} traced ({span}, torch.profiler): a DNN "
              f"quantum's {t['dnn_launches']:g} device launches are busy "
              f"{t['dnn_busy_ms']:.4f} ms, "
              f"{ov['share']:.3f} of it beside other kernels "
              f"(busy {ov['other_busy_ms']:.3f} ms in {ov['other_kernels']}"
              f"); traced wall p50 {row['p50_ms']} ms, lane stream p50 "
              f"{row['dev_p50_ms']} ms; the DNN's busy time / untraced wall "
              f"p50 {t['dnn_busy_ms'] / rows[mode]['p50_ms']:.3f} [{smi}]")
    return dict(rows, alone=alone, traced=traced)


def phase_vgang(dev, smi: str) -> dict:
    """(i) virtual gangs on the card: the port's executor vgang bench at
    its full default duration with --reclaim (solo, vgang, rtgT, rtgT+dr),
    its JSON under build/; then the fleet example plain, with
    --rtg-throttle and with --reclaim."""
    out = ROOT / "build" / "BENCH_executor_vgang_torch.json"
    out.parent.mkdir(exist_ok=True)
    rc = vbench.main(["--reclaim", "--out", str(out)])
    doc = json.loads(out.read_text())
    if rc or not doc["ok"]:
        fail(f"vgang bench: rc {rc}, failures {doc['failures']}")
    print(f"[vgang] {doc['device']}; lanes {doc['n_lanes']}, regulation "
          f"window {doc['interval_s'] * 1e3:g} ms, {doc['duration_s']:.3f} "
          f"s a mode, WCET margin {doc['margin']}, blocking "
          f"{doc['blocking_ms']:.3f} ms, periods {doc['periods_ms']}; "
          f"RTG-throttle bytes declared (not measured) [{smi}]")
    for name in vbench.MEMBERS:
        print(f"[vgang] {name}: calibrated quantum "
              f"{doc['quanta_ms'][name]:.4f} ms, WCET "
              f"{doc['wcet_ms'][name]:.4f} ms")
    for mode, row in doc["modes"].items():
        for name, e in row["members"].items():
            # the bench's own checks, held again here
            if not e["rta_ok"] or e["rta_bound_ms"] is None:
                fail(f"vgang {mode}:{name}: RTA verdict not ok")
            if not e["jobs"]:
                fail(f"vgang {mode}:{name}: no response recorded")
            if e["max_response_ms"] > e["rta_bound_ms"]:
                fail(f"vgang {mode}:{name}: max response "
                     f"{e['max_response_ms']} ms > bound "
                     f"{e['rta_bound_ms']} ms")
            print(f"[vgang] {mode} {name} ({e['vgang']}): jobs {e['jobs']}, "
                  f"first {e['first_response_ms']:.3f} ms, max "
                  f"{e['max_response_ms']:.3f} ms, bound "
                  f"{e['rta_bound_ms']:.3f} ms, worst margin "
                  f"{e['worst_margin_ms']:.3f} ms")
        if row["invariant_violations"] or row["budget_violations"]:
            fail(f"vgang {mode}: {row['invariant_violations']} invariant, "
                 f"{row['budget_violations']} budget-ordering violations")
        ov = row["device_overlap"]
        if ov["cross_pairs"]:
            fail(f"vgang {mode}: {ov['cross_pairs']} pairs of quanta of "
                 f"different vgangs overlap on the device "
                 f"({ov['cross_ms']:.4f} ms)")
        print(f"[vgang] {mode}: vgangs {row['vgangs']}, acquisitions "
              f"{row['acquisitions']}, preemptions {row['preemptions']}, "
              f"be_quanta {row['be_quanta']}, rt_stalls {row['rt_stalls']}, "
              f"reclaimed {row['reclaimed_bytes']:g} B; device (CUDA "
              f"events): {ov['quanta']} quanta, 0 cross-vgang overlaps, "
              f"same-vgang members side by side {ov['same_ms']:.4f} ms of "
              f"{ov['same_busy_ms']:.4f} ms busy ({ov['same_share']:.3f}, "
              f"{ov['same_pairs']} pairs) [{smi}]")
    fleet = []
    for flags in FLEET_RUNS:
        stats = vgang_fleet.main(flags + ["--duration", str(FLEET_DURATION)])
        jobs = {n: len(r) for n, r in stats["response_times"].items()}
        if not stats["invariant_ok"]:
            fail(f"vgang_fleet {flags}: the gang invariant broke")
        if set(jobs) != {"perception", "fusion", "planner"} or \
                not all(jobs.values()):
            fail(f"vgang_fleet {flags}: a member ran no job ({jobs})")
        worst = {n: max(r) * 1e3 for n, r in stats["response_times"].items()}
        fleet.append({"flags": flags, "jobs": jobs, "worst_ms": worst,
                      "acquisitions": stats["acquisitions"],
                      "preemptions": stats["preemptions"],
                      "be_quanta": stats["be_quanta"],
                      "rt_stalls": stats["rt_stalls"],
                      "reclaimed_bytes": stats["reclaimed_bytes"]})
    summary = {m: {k: v for k, v in row.items() if k != "device_quanta"}
               for m, row in doc["modes"].items()}
    return {"bench": dict(doc, modes=summary), "fleet": fleet}


def uunifast(rng: random.Random, n: int, total_util: float) -> list:
    """UUniFast (Bini & Buttazzo): the sweep's and the grid's split of a
    total utilization over n tasks."""
    utils, remaining = [], total_util
    for i in range(n - 1):
        nxt = remaining * rng.random() ** (1.0 / (n - 1 - i))
        utils.append(remaining - nxt)
        remaining = nxt
    utils.append(remaining)
    return utils


def taskset_seed(seed: int, k: int, total_util: float) -> int:
    """The per-taskset seed of the sweep and the grid."""
    return seed + 7919 * k + int(1e6 * total_util)


def random_gang_taskset(rng, n_cores: int, n_tasks: int, total_util: float):
    """The Monte-Carlo sweep's random gang task set: UUniFast utilizations,
    periods from a pool, random widths, rate-monotonic priorities."""
    utils = uunifast(rng, n_tasks, total_util)
    periods = [rng.choice((10.0, 20.0, 25.0, 40.0, 50.0, 100.0))
               for _ in range(n_tasks)]
    by_rm = sorted(range(n_tasks), key=lambda i: (periods[i], i))
    prio_of = {idx: n_tasks - rank for rank, idx in enumerate(by_rm)}
    tasks = []
    for i in range(n_tasks):
        width = rng.randint(1, n_cores)
        cores = tuple(rng.sample(range(n_cores), width))
        tasks.append(RTTask(
            name=f"g{i}", wcet=max(utils[i] * periods[i], 1e-3),
            period=periods[i], cores=cores, prio=prio_of[i],
            release_offset=rng.uniform(0, periods[i])))
    return tasks


GRID_WIDTHS = {"light": lambda rng, m: rng.randint(1, max(1, m // 4)),
               "mixed": lambda rng, m: rng.randint(1, max(1, m // 2)),
               "heavy": lambda rng, m: rng.randint(max(1, m // 2), m)}


def random_vgang_taskset(rng, n_cores: int, n_tasks: int, total_util: float,
                         dist: str = "mixed"):
    """The vgang grid's random task set: UUniFast utilizations, widths from
    the named distribution, periods 20/40/80, memory intensity in [0, 1]."""
    utils = uunifast(rng, n_tasks, total_util)
    tasks = []
    for i in range(n_tasks):
        period = rng.choice((20.0, 40.0, 80.0))
        width = GRID_WIDTHS[dist](rng, n_cores)
        tasks.append(RTTask(
            name=f"g{i}", wcet=max(utils[i] * period, 1e-3), period=period,
            cores=tuple(range(width)), prio=n_tasks - i,
            mem_intensity=rng.random()))
    return tasks


def n_tasks_for(n_cores: int) -> int:
    """The grid's gangs a task set: 4 -> 5, 8 -> 7, 16 -> 11."""
    return 3 + (n_cores + 1) // 2


def rta_shards():
    """(j)'s two shards as (name, C, P, prio) rows: the 500 seeded task sets
    of tests/test_batched_rta.py, and the grid's full default shard (4050
    sets) collapsed as its rtgang column analyzes them (singleton vgangs,
    priorities by rate, WCETs inflated by intensity interference)."""
    def draw(n_sets, seed, n_cores=4, max_tasks=8, max_util=2.2):
        out = []
        for k in range(n_sets):
            rng = random.Random(taskset_seed(seed, k, 1.0))
            n = rng.randint(1, max_tasks)
            out.append(random_gang_taskset(rng, n_cores, n,
                                           rng.uniform(0.1, max_util)))
        return out
    sets = draw(250, 0) + draw(150, 1, max_tasks=12, max_util=3.0) + \
        draw(100, 2, n_cores=8, max_util=1.5)
    rows = [[(t.name, t.wcet, t.period, t.prio) for t in ts] for ts in sets]
    grid = []
    for m in GRID_CORES:
        for dist in GRID_DISTS:
            for u in GRID_UTILS:
                for k in range(GRID_SETS):
                    tasks = random_vgang_taskset(
                        random.Random(taskset_seed(0, k, u)), m,
                        n_tasks_for(m), u, dist)
                    vgangs = assign_priorities(singleton_vgangs(tasks))
                    eq = VRTA.vgang_taskset(
                        vgangs, intensity_interference(tasks, 0.5))
                    grid.append([(t.name, t.wcet, t.period, t.prio)
                                 for t in eq])
    return rows, grid


def phase_rta(dev, smi: str) -> dict:
    """(j) the batched RTA's torch backend on the card (float64, lockstep
    over the whole shard) against the numpy backend, on the 500 seeded
    task sets and on the grid's full default shard: equal verdicts, the
    same lanes settled, finite WCRTs within a relative 1e-12; both
    backends' times (host clock, the torch call ends with its copy back)."""
    rows, grid = rta_shards()
    out = {}
    for label, shard, kw in (("500 sets", rows, {}),
                             ("500 sets, blocking 0.7, crpd 0.25", rows,
                              {"blocking": 0.7, "crpd": 0.25}),
                             ("grid 4050 sets", grid, {})):
        batch = BRTA.pad_rows(shard)
        t0 = time.perf_counter()
        a = BRTA.fixed_point(batch, backend="numpy", **kw)
        np_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(2):               # the first call, then again
            t0 = time.perf_counter()
            b = BRTA.fixed_point(batch, backend="torch", device=dev, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
        same_nan = bool(np.array_equal(np.isnan(a), np.isnan(b)))
        fin = np.isfinite(a)
        rel = float(np.max(np.abs(b[fin] - a[fin]) / np.abs(a[fin]))) \
            if fin.any() else 0.0
        bits_a, bits_b = BRTA.accept_bits(batch, a), BRTA.accept_bits(batch, b)
        print(f"[rta] {label}: shape {batch.shape}, lanes settled "
              f"{int(fin.sum())} of {int(batch.valid.sum())}, accepted "
              f"{int(bits_a.sum())}; numpy {np_ms:.3f} ms, torch on {dev} "
              f"{times[0]:.3f} ms first, {times[1]:.3f} ms again; max rel "
              f"WCRT difference {rel:.3g}, exactly equal "
              f"{int((a[fin] == b[fin]).sum())} [{smi}]")
        if not same_nan or rel > RTA_RTOL or \
                not np.array_equal(bits_a, bits_b):
            fail(f"rta {label}: the torch backend disagrees with numpy "
                 f"(same lanes {same_nan}, max rel {rel}, verdicts equal "
                 f"{np.array_equal(bits_a, bits_b)})")
        out[label] = {"shape": list(batch.shape), "numpy_ms": np_ms,
                      "torch_ms": times, "max_rel": rel,
                      "settled": int(fin.sum()),
                      "accepted": int(bits_a.sum())}
    # the vgang entry point the grid calls, through the torch backend on
    # the card (its default device)
    work = []
    for k in range(GRID_SETS):
        tasks = random_vgang_taskset(random.Random(taskset_seed(0, k, 1.1)),
                                     16, n_tasks_for(16), 1.1, "mixed")
        work.append((assign_priorities(singleton_vgangs(tasks)),
                     intensity_interference(tasks, 0.5)))
    vs, intfs = [w[0] for w in work], [w[1] for w in work]
    got = VRTA.batched_accepts(vs, intfs, backend="torch")
    if got != VRTA.batched_accepts(vs, intfs, backend="numpy"):
        fail("rta: vgang batched_accepts differs between torch and numpy")
    return out


def phase_train_check(dev) -> dict:
    """One f32 loss + gradient at full width (2 layers, B=1, S=256), on
    the card and on the CPU from the same weights (drawn on the card):
    the loss within CHECK_LOSS_RTOL, each gradient leaf within
    CHECK_GRAD_TOL of its largest |g| on the CPU."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CHECK_LAYERS,
                              dtype="float32")
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg, parallel, dev)
    params = L.init_params(api.defs, seed=1, dtype=torch.float32,
                           device=dev)
    b = TokenSource(DataConfig(seq_len=CHECK_SEQ, global_batch=1,
                               vocab_size=cfg.vocab_size)).train_batch(0)
    loss_card, _, g_card = loss_and_grads(
        api, params, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    g_card = [g.cpu() for g in L.tree_leaves(g_card)]
    cpu_params = L.tree_map(lambda _, p: p.cpu(), params)
    del params
    t0 = time.perf_counter()
    loss_cpu, _, g_cpu = loss_and_grads(
        build_model(cfg, parallel, "cpu"), cpu_params,
        {k: torch.from_numpy(v) for k, v in b.items()})
    cpu_s = time.perf_counter() - t0
    loss_card, loss_cpu = float(loss_card), float(loss_cpu)
    names = []
    L.tree_map(lambda path, _: names.append("/".join(path)), g_cpu)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = max((float((a - c).abs().max()) / max(float(c.abs().max()),
                                                   1e-30), path)
                for a, c, path in zip(g_card, L.tree_leaves(g_cpu), names))
    print(f"[train] f32 check, {TRAIN_ARCH} full width {CHECK_LAYERS} "
          f"layers, B=1, S={CHECK_SEQ}: loss card {loss_card:.7f} / CPU "
          f"{loss_cpu:.7f} (relative {rel:.3g}, limit {CHECK_LOSS_RTOL}); "
          f"worst gradient leaf {worst[1]} at {worst[0]:.3g} of its largest "
          f"|g| (limit {CHECK_GRAD_TOL}); CPU step {cpu_s:.1f} s")
    if not rel <= CHECK_LOSS_RTOL:
        fail(f"train f32 check: loss card {loss_card} vs CPU {loss_cpu}")
    if not worst[0] <= CHECK_GRAD_TOL:
        fail(f"train f32 check: gradient {worst[1]} off by {worst[0]:.3g} "
             f"of its largest |g|")
    return {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel": rel,
            "worst_grad_rel": worst[0], "worst_grad_leaf": worst[1],
            "cpu_s": cpu_s}


def phase_train_restart(dev) -> dict:
    """TrainRunner at reduced size under build/: a run that fails at step
    10 and resumes from its step-8 checkpoint against one that does not
    fail; every step's loss within RESTART_RTOL."""
    cfg = reduced(get_config(TRAIN_ARCH))
    parallel = ParallelConfig(param_dtype="float32", compute_dtype="float32",
                              q_block=64, kv_block=64)
    api = build_model(cfg, parallel, dev)
    opt = Optimizer(OptConfig(lr=3e-3, warmup=2, decay_steps=20))
    data = DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
    base = ROOT / "build" / "train_restart"
    shutil.rmtree(base, ignore_errors=True)

    def runner(name, fail_at=None):
        return TrainRunner(api, opt, data, RunnerConfig(
            total_steps=12, ckpt_every=4, ckpt_dir=str(base / name),
            fail_at_step=fail_at))
    clean = runner("clean")
    clean.run()
    want = {m["step"]: m["loss"] for m in clean.metrics_log}
    first = runner("ft", fail_at=10)
    try:
        first.run()
        fail("train restart: the injected failure did not raise")
    except SimulatedFailure:
        pass
    second = runner("ft")
    second.run()
    got = first.metrics_log + second.metrics_log
    steps = [m["step"] for m in got]
    if steps != list(range(10)) + [8, 9, 10, 11]:
        fail(f"train restart: steps {steps}")
    rel = max(abs(m["loss"] - want[m["step"]]) / abs(want[m["step"]])
              for m in got)
    print(f"[train] restart at reduced size: failed at step 10, resumed "
          f"from the step-8 checkpoint; losses vs the uninterrupted run: "
          f"max relative difference {rel:.3g} (limit {RESTART_RTOL}); "
          f"loss {want[0]:.4f} -> {want[11]:.4f}")
    if not rel <= RESTART_RTOL:
        fail(f"train restart: losses differ by {rel:.3g} relative")
    shutil.rmtree(base, ignore_errors=True)
    return {"max_rel": rel, "losses": [want[i] for i in range(12)]}


def phase_train(dev, smi: str) -> dict:
    """(k): qwen2-7b at full width (depth 28 -> 8) through TrainRunner,
    bf16 compute / f32 masters, AdamW, remat "block", B=4, S=1024, 30
    steps; then the f32 card-vs-CPU step and the restart path."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    parallel = ParallelConfig(param_dtype="float32",
                              compute_dtype="bfloat16", remat="block")
    api = build_model(cfg, parallel, dev)
    n = api.n_params()
    opt = Optimizer(OptConfig(name="adamw", lr=1e-3, warmup=5,
                              decay_steps=TRAIN_STEPS))
    data = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=cfg.vocab_size)
    runner = TrainRunner(api, opt, data, RunnerConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1,
        ckpt_dir=str(ROOT / "build" / "train_full_width")))
    print(f"[train] {TRAIN_ARCH} full width (d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
          f"{cfg.vocab_size}), depth cut {get_config(TRAIN_ARCH).n_layers} "
          f"-> {TRAIN_LAYERS} layers: {n / 1e9:.3f} B params, f32 masters, "
          f"bf16 compute, AdamW, remat block, B={TRAIN_BATCH}, "
          f"S={TRAIN_SEQ}, {TRAIN_STEPS} steps, no checkpoint")
    t0 = time.perf_counter()
    state = runner.init_state(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = runner.run(state, 0)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log = runner.metrics_log
    losses = [m["loss"] for m in log]
    step_s = float(np.median([m["dur_s"] for m in log[TRAIN_SKIP:]]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the input table is a lookup and does no matrix product: N leaves it
    # out (the tied table is the lm_head's, and stays)
    n_mm = n - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    mfu = 6 * n_mm * tokens / step_s / PEAK_OPS[torch.bfloat16]
    mfu_all = 6 * n * tokens / step_s / PEAK_OPS[torch.bfloat16]
    print(f"[train] step median {step_s * 1e3:.1f} ms (steps {TRAIN_SKIP}-"
          f"{TRAIN_STEPS - 1}; first {log[0]['dur_s'] * 1e3:.1f} ms), "
          f"{tokens / step_s:.0f} tokens/s, 6 N tokens / step with N = "
          f"{n_mm / 1e9:.3f} B (no input table) "
          f"{6 * n_mm * tokens / step_s / 1e12:.1f} TFLOP/s = {mfu:.3f} of "
          f"989 TFLOP/s bf16 ({mfu_all:.3f} with all {n / 1e9:.3f} B); "
          f"peak memory {peak_gb:.3f} GB; state drawn in "
          f"{init_s:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"launches {launches}; stragglers {len(runner.straggler_steps)} "
          f"[{smi}]")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} are not finite or did not fall")
    if any(launches.values()):
        fail(f"train: the train path launched {launches}; JAX's training "
             f"reaches no Pallas kernel")
    trace = trace_train_step(runner, state, smi)
    del state, runner
    gc.collect()
    torch.cuda.empty_cache()
    check = phase_train_check(dev)
    restart = phase_train_restart(dev)
    return {"launches": launches, "n_params": n, "step_ms": step_s * 1e3,
            "first_step_ms": log[0]["dur_s"] * 1e3,
            "step_ms_all": [m["dur_s"] * 1e3 for m in log],
            "tokens_per_s": tokens / step_s, "n_matmul_params": n_mm,
            "mfu": mfu, "mfu_all_params": mfu_all, "peak_gb": peak_gb,
            "losses": losses, "init_s": init_s, "trace": trace,
            "f32_check": check, "restart": restart}


def trace_train_step(runner, state, smi: str, top: int = 8) -> dict:
    """One more step of (k) under torch.profiler: the device's busy time
    (the traced device events' durations summed: one stream), its idle
    share of the step and the kernels that take the most device time."""
    step, batch = next(runner.loader.iterate(TRAIN_STEPS))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = runner.step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time_total / 1e3)
    kernels = sorted(((sum(ts), len(ts), n) for n, ts in by_name.items()),
                     reverse=True)[:top]
    print(f"[train] step {step} traced: wall {wall_ms:.1f} ms (profiler "
          f"on), device busy {busy_ms:.1f} ms in {len(events)} device "
          f"events, idle share {1 - busy_ms / wall_ms:.3f} [{smi}]")
    for ms, n, name in kernels:
        print(f"[train]   {ms:8.2f} ms in {n:5d} launches: {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "events": len(events),
            "top": [{"ms": ms, "launches": n, "name": name}
                    for ms, n, name in kernels]}


def stream_overlap(intervals: list[dict], name: str, other: str) -> dict:
    """How much of ``name``'s stream time (CUDA events on its lane's
    stream) ran beside ``other``'s: ``overlap`` on the intervals in µs."""
    def events(n):
        return [{"ts": q["start_ms"] * 1e3,
                 "dur": (q["end_ms"] - q["start_ms"]) * 1e3}
                for q in intervals if q["name"] == n]
    ov = overlap(events(name), events(other))
    return {"stream_ms": ov["dnn_kernel_ms"], "overlap_ms": ov["overlap_ms"],
            "share": ov["share"]}


def phase_serve_train(dev, smi: str) -> dict:
    """(l): examples/serve_with_background_training.run at full width,
    SERVE_TRAIN_DURATION s in each of SERVE_TRAIN_MODES: RT-Gang with the
    example's declared cost, RT-Gang with one within the budget, and
    Co-Sched."""
    serve_cfg = get_config("qwen2-7b")
    train_cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                                    n_layers=BE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    models = swbt.build(
        serve_cfg, train_cfg, device=dev,
        serve_parallel=ParallelConfig(param_dtype="bfloat16",
                                      compute_dtype="bfloat16"),
        train_parallel=ParallelConfig(param_dtype="float32",
                                      compute_dtype="bfloat16"))
    print(f"[serve+train] RT: qwen2-7b bf16, {serve_cfg.n_layers} layers; "
          f"BE: olmoe-1b-7b full width, depth cut "
          f"{get_config('olmoe-1b-7b').n_layers} -> {BE_TRAIN_LAYERS}, "
          f"{models['train_api'].n_params() / 1e9:.3f} B params, f32 "
          f"masters, bf16 compute, AdamW, 4 x 64 tokens a microstep; built "
          f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    rows = {}
    for mode, enabled, train_bytes in SERVE_TRAIN_MODES:
        reset_launches()
        res = swbt.run(models, enabled=enabled,
                       duration=SERVE_TRAIN_DURATION,
                       train_bytes=train_bytes,
                       log=lambda line: print(f"{line} [{smi}]"))
        launches = read_launches()
        expect = {"flash_attention": serve_cfg.n_layers * res["prefills"],
                  "moe_gmm": 0, "ssd_scan": 0, "rglru_scan": 0}
        q, r, t = res["decode_ms"], res["response_ms"], res["train_ms"]
        busy = res["busy_ms"]
        ov = stream_overlap(res["intervals"], "serve-decode", "train-be")
        rows[mode] = row = {
            "decode_quanta": int(len(q)),
            "quantum_p50_ms": float(np.percentile(q, 50)) if len(q) else None,
            "quantum_p99_ms": float(np.percentile(q, 99)) if len(q) else None,
            "quantum_max_ms": float(q.max()) if len(q) else None,
            "response_p50_ms": float(np.percentile(r, 50)) if len(r) else None,
            "response_p99_ms": float(np.percentile(r, 99)) if len(r) else None,
            "response_max_ms": float(r.max()) if len(r) else None,
            "busy_quanta": int(len(busy)),
            "busy_p50_ms": float(np.percentile(busy, 50)) if len(busy)
            else None,
            "busy_p99_ms": float(np.percentile(busy, 99)) if len(busy)
            else None,
            "requests_done": sum(x.done for x in res["requests"]),
            "prefills": res["prefills"], "microsteps": int(len(t)),
            "train_bytes": train_bytes,
            "microstep_p50_ms": float(np.median(t)) if len(t) else None,
            "warmup_loss": res["warmup_loss"], "losses": res["losses"],
            "be_quanta": res["stats"]["be_quanta"],
            "decode_overlap": ov, "launches": launches}
        print(f"[serve+train] {mode} (train declared {train_bytes:g} B a "
              f"quantum): decode quantum p50 / p99 / max "
              f"{row['quantum_p50_ms']} / {row['quantum_p99_ms']} / "
              f"{row['quantum_max_ms']} ms over {len(q)} quanta; busy "
              f"quanta (refill + decode) p50 / p99 {row['busy_p50_ms']} / "
              f"{row['busy_p99_ms']} ms over {len(busy)}; response "
              f"p50 / p99 / max {row['response_p50_ms']} / "
              f"{row['response_p99_ms']} / {row['response_max_ms']} ms; "
              f"requests done {row['requests_done']}/8; train microsteps "
              f"{len(t)} (median {row['microstep_p50_ms']} ms) after the "
              f"warm-up's; be_quanta {row['be_quanta']}; decode stream time "
              f"beside a microstep {ov['overlap_ms']:.3f} of "
              f"{ov['stream_ms']:.3f} ms ({ov['share']:.3f}); launches "
              f"{launches} (expected {expect}) [{smi}]")
        if not len(q):
            fail(f"serve+train {mode}: no decode quantum ran")
        if not all(np.isfinite([res["warmup_loss"]] + res["losses"])):
            fail(f"serve+train {mode}: a non-finite loss")
        if launches != expect:
            fail(f"serve+train {mode}: launches {launches}, expected "
                 f"{expect}")
    # RT-Gang's regime (the example's 5e5 B budget against 1e6 B declared
    # a microstep) admits no microstep once the gang has led: training's
    # progress there is its warm-up microstep, as in JAX's example. Under
    # a declared cost within the budget, RT-Gang must train too
    for mode in ("rtgang_fit", "cosched"):
        if not rows[mode]["microsteps"]:
            fail(f"serve+train {mode}: no train microstep ran")
    rows["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve+train] peak memory {rows['peak_gb']:.3f} GB; decode "
          f"quantum p99 RT-Gang {rows['rtgang']['quantum_p99_ms']} ms, "
          f"RT-Gang with training admitted "
          f"{rows['rtgang_fit']['quantum_p99_ms']} ms, Co-Sched "
          f"{rows['cosched']['quantum_p99_ms']} ms (reported, not checked) "
          f"[{smi}]")
    del models
    return rows


def ptxas_report(log: str) -> list[dict]:
    """Registers, static shared memory and spills of each kernel in an
    ``nvcc -Xptxas -v`` log, names demangled where c++filt is there."""
    kernels, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": 0, "static_smem": 0,
                   "spill_stores": 0, "spill_loads": 0}
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(k["kernel"] for k in kernels),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
        if len(names) == len(kernels):
            for k, n in zip(kernels, names):   # name<template args>
                n = n.replace("(anonymous namespace)::", "")
                k["kernel"] = n.removeprefix("void ").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return kernels


def kernel_entry(name, source, replaces, launches, rep) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": rep["max_abs_err"],
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            "graph_ms": rep.get("graph_ms")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        builds = dict(zip(KERNELS, pool.map(lambda m: m.build(),
                                            KERNELS.values())))
    build_report = {}
    for name, built in builds.items():
        print(f"[build] {name}: nvcc {built.seconds:.1f} s -> "
              f"{built.path.relative_to(ROOT)}")
        build_report[name] = ptxas_report(built.log)
        for k in build_report[name]:
            print(f"[build]   {k['kernel']}: {k['registers']} registers, "
                  f"{k['static_smem']} B static shared memory, spills "
                  f"{k['spill_stores']} B stored / {k['spill_loads']} B "
                  f"loaded")
            if (re.search(r"_tc[<I]", k["kernel"]) or
                    name in ("ssd_scan", "rglru_scan")) and \
                    k["spill_stores"] + k["spill_loads"]:
                fail(f"kernel {k['kernel']} spills registers")
    for dt in (torch.float32, torch.bfloat16):
        path = "tensor cores" if dt == torch.bfloat16 else "FMA"
        print(f"[build] dynamic shared memory a block, {DT_NAME[dt]} "
              f"({path}): flash_attention " + ", ".join(
                  f"D={d} {fa.smem_bytes(dt, d)} B" for d in fa.HEAD_DIMS)
              + "; moe_gmm " + ", ".join(
                  f"C={c} {gmm.smem_bytes(dt, c)} B" for c in (8, 16, 160)))
    print(f"[build] dynamic shared memory a block, ssd_scan's chunk-parallel "
          f"scan (both dtypes): {ssd.smem_bytes()} B")
    phase_s = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] phase {name}: {phase_s[name]:.1f} s")
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    rows = timed("c", phase_kernel, dev, smi)
    gmm_rows = timed("c2", phase_gmm, dev, smi)
    ssd_rows = timed("c3", phase_ssd, dev, smi)
    rg_rows = timed("c4", phase_rglru, dev, smi)
    sv = timed("d", phase_serving, dev, smi, "qwen2-7b", duration=6.0)
    timed("e", phase_oracle, dev, sv.pop("api"), sv.pop("params"))
    free()                                        # qwen2-7b's weights go
    sv2 = timed("d2", phase_serving, dev, smi, "olmoe-1b-7b", duration=12.0)
    sv2["plain_path_err"] = timed("e2", phase_oracle, dev, sv2.pop("api"),
                                  sv2.pop("params"))
    free()                                        # olmoe's weights go
    sv3 = timed("d3", phase_gang, dev, smi, MAMBA_ARCH, duration=6.0,
                max_seq=0)
    sv3.update(timed("e3", phase_gang_oracle, dev, sv3.pop("api"),
                     sv3.pop("params"), max_seq=0))
    free()                                        # mamba2's weights go
    sv4 = timed("d4", phase_gang, dev, smi, HYBRID_ARCH, duration=6.0,
                max_seq=HYBRID_MAX_SEQ)
    sv4.update(timed("e4", phase_gang_oracle, dev, sv4.pop("api"),
                     sv4.pop("params"), max_seq=HYBRID_MAX_SEQ))
    free()                                        # recurrentgemma's go
    reset_launches()                              # DAVE-2 runs no kernel
    dave2 = timed("f", phase_dave2, dev, smi)
    fig1_rep = timed("g", phase_fig1, dev, smi)
    fig6_rep = timed("h", phase_fig6, dev, smi, dave2["kernels"])
    if any(read_launches().values()):
        fail(f"phases (f)-(h) launched {read_launches()}: DAVE-2's path "
             f"has none of the four kernels")
    vgang_rep = timed("i", phase_vgang, dev, smi)
    if any(read_launches().values()):
        fail(f"phase (i) launched {read_launches()}: the vgang path has "
             f"none of the four kernels")
    rta_rep = timed("j", phase_rta, dev, smi)
    if any(read_launches().values()):
        fail(f"phase (j) launched {read_launches()}")
    train_rep = timed("k", phase_train, dev, smi)
    free()
    st_rep = timed("l", phase_serve_train, dev, smi)
    free()

    reported = {
        "flash_attention": next(r for r in rows if r.get("reported")),
        "moe_gmm": next(r for r in gmm_rows if r.get("reported")),
        "ssd_scan": next(r for r in ssd_rows if r.get("reported")),
        "rglru_scan": next(r for r in rg_rows if r.get("reported"))}
    serve_train = {k: sum(st_rep[m]["launches"][k]
                          for m, _, _ in SERVE_TRAIN_MODES) for k in KERNELS}
    by_path = {"qwen2-7b": sv["launches"], "olmoe-1b-7b": sv2["launches"],
               MAMBA_ARCH: sv3["launches"], HYBRID_ARCH: sv4["launches"],
               "train (k)": train_rep["launches"],
               "serve+train (l)": serve_train}
    replaces = {
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:82",
        "moe_gmm": "src/repro/kernels/moe_gmm/moe_gmm.py:51",
        "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:74",
        "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:55"}
    kernels = [kernel_entry(name, f"src/repro_torch/csrc/{name}.cu",
                            replaces[name],
                            {p: n[name] for p, n in by_path.items()},
                            reported[name]) for name in KERNELS]
    detail = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "build_s": {n: b.seconds for n, b in builds.items()},
              "ptxas": build_report,
              "kernel_rows": rows, "gmm_rows": gmm_rows,
              "ssd_rows": ssd_rows, "rglru_rows": rg_rows,
              "reported_cases": {n: r["case"] for n, r in reported.items()},
              "serve": sv, "serve_olmoe": sv2, "gang_mamba2": sv3,
              "gang_recurrentgemma": sv4, "dave2": dave2, "fig1": fig1_rep,
              "fig6": fig6_rep, "vgang": vgang_rep, "rta": rta_rep,
              "train": train_rep, "serve_train": st_rep,
              "phase_s": phase_s,
              "wall_s": time.perf_counter() - t_start}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"kernels: [flash_attention: pass ({len(rows)} shapes), moe_gmm: "
          f"pass ({len(gmm_rows)} shapes), ssd_scan: pass ({len(ssd_rows)} "
          f"shapes), rglru_scan: pass ({len(rg_rows)} shapes)]; dave2: "
          f"pass (card vs CPU, B {DAVE2_BATCHES}); fig1: "
          f"{len(fig1_rep['rows'])} rows; fig6: solo / cosched / rtgang n "
          f"{[fig6_rep[m]['n'] for m in ('solo', 'cosched', 'rtgang')]}; "
          f"vgang: pass ({len(vgang_rep['bench']['modes'])} modes, "
          f"{len(vgang_rep['fleet'])} fleet runs); rta: pass "
          f"({len(rta_rep)} shards); train: pass (loss "
          f"{train_rep['losses'][0]:.3f} -> {train_rep['losses'][-1]:.3f}, "
          f"f32 card vs CPU, restart); serve+train: pass (RT-Gang, "
          f"RT-Gang with training admitted, Co-Sched)")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
