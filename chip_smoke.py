#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the checkout's sources (the
Hanoi step machine K1, the SM issue scheduler K2, flash attention K3, the
RG-LRU scan K4, the RWKV-6 scan K5) and reports each kernel's ptxas
registers and spills; shows that K3's bf16 kernel runs on the
tensor cores (its HMMA instructions, and no register spills); holds each
kernel against its plain PyTorch version on the card (K3 at hd 64, 128, 256
and 320, in bf16 and f32, with GQA groups of 1 to 10, windowed or not,
and on a rank's own query rows at offsets on and off its q tile; K4
and K5, split over time, against twins that
walk the same segments: K4's h and K5's s_last bit for bit, also at a
length of many resident waves, and the same bits from two launches; K1
against its plain twin bit for bit in every field of the simulator's
state, at 4, 8 and 32 threads, 2 and 8 Bx registers, majority-first on and
off, with oracle skips, over the paper's figures, the spinlock and the
suite, and at the shapes that take its other layouts: 16,384 words of
memory, a 2,048-row program, 512 registers, 40 predicates, and the memory
image, the program and the registers in global memory; K2 against its twin
bit for bit in every output, cells of 1, 8, 32 and 64 warps, every issue
policy, two latency tables, two launches alike); and drives the port's
main paths at full width, with random weights or data drawn from a seed:

- llama3.2-1b: a bf16 prefill of 4 x 2048 tokens through K3 (hd 64);
- recurrentgemma-2b: a bf16 prefill of 4 x 2048 through K3 (hd 256) and
  K4 (its 18 RG-LRU layers take the kernel by default on the card), held
  against the reference-attention prefill, and layer 0's RG-LRU with
  ``use_kernel=True`` through K4, held against ``use_kernel=False``;
- rwkv6-3b: a bf16 prefill of 4 x 2048 through K5 (one launch a layer),
  held in f32 against the chunked form, and layer 0's time mix with
  ``use_kernel=True`` through K5, held against ``use_kernel=False``;
- ``serve`` of 4 requests on each of the three models, in f32;
- deepseek-moe-16b, whole (28 layers, 16.4 B parameters): a bf16 prefill
  of 4 x 2048 through K3 (hd 128, 16 heads, 16 kv heads), held against
  the reference-attention prefill in bf16 and, at 8 layers, in f32; its
  first MoE layer on the card against the same layer on the CPU (routing,
  kept slots and dispatch order identical); ``serve`` of 4 requests on
  its bf16 weights;
- mixtral-8x7b at full width, 8 of its 32 layers: a bf16 prefill of
  1 x 8192 through K3 with its 4096-token window, held the same way (in
  f32 at 4 layers);
- gemma3-4b, minitron-4b, internlm2-20b (19.9 B parameters), internvl2-2b
  and hubert-xlarge, each whole at full width on bf16 weights drawn on the
  card one leaf at a time: a prefill of 4 x 2048 positions from the
  port's ``synthetic_batch`` (internvl2-2b: 256 patches, then 1,792
  tokens; hubert-xlarge: 2,048 f32 frames, so its layers run in f32),
  through K3 (hd 320 with and without gemma3's 1024 window; hd 128 at GQA
  3:1, 6:1 and 2:1) but in hubert's non-causal encoder, the decoders held
  against the reference attention layer by layer in bf16 and end to end
  in f32 (internlm2-20b at 8 of its 48 layers); each cut to its first layers
  (gemma3-4b: one whole 5-local-1-global pattern) in f32 at 1 x 512 on the
  card against the CPU; ``serve`` of 4 requests on gemma3-4b and
  minitron-4b in f32 and internlm2-20b on its bf16 weights; ``serve``
  refusing hubert-xlarge and internvl2-2b; and ``python -m
  repro_torch.examples.serve_lm`` as a subprocess that must exit 0;
- the simulator: ``Simulator().run_batch`` (its default mechanism,
  ``hanoi_torch``, on the card) over 8,448 simulated warps (one full residency of the card, 132 SMs x 64
  warps; the suite's 23 programs in turn, each warp with its own memory)
  at the paper's evaluation config, in one launch of K1, every warp held
  to the twin and one warp of each program to the numpy ``run_hanoi``;
  then Fig 9 through ``compare``: ``hanoi_torch`` against ``hanoi``
  (discrepancy 0) and against ``turing_oracle`` (the numpy ``hanoi``'s
  discrepancies, row for row);
- the SM model: ``run_batch(mechanism="sm_torch")`` over 1,056 SM cells of
  8 warps under greedy-then-oldest, and a ``run_cells`` grid of 264
  heterogeneous cells of 32 warps under round robin, each in one launch of
  K1 and one of K2, every SmResult held to the twins' and the longest cell
  of each policy to ``sm_interleave`` (the third policy through
  ``Simulator().run_sm``'s defaults, ``sm_torch``); then Fig 10 through
  ``compare(timing="cycle")``, row for row the numpy ``hanoi``'s;
- static analysis: ``analyze_program`` over the suite's 23 programs, then
  each stripped (``strip_annotations``) and synthesized again, and
  ``Simulator().run_batch(..., synthesize=True, verify=True)`` on the card,
  one launch of K1 a signature group, every warp held to K1's twin;
- the archive: ``Simulator(sink=RotatingJsonlSink(...)).run_batch`` over
  2,112 of the simulator's warps in one launch of K1, read back by
  ``ArchiveReader``, self-replayed by ``Replayer()`` through K1 at exactly
  0.0, and 23 runs fetched through ``ArchiveIndex``; the suite archived
  under ``turing_oracle`` and replayed by ``Replayer("hanoi_torch")``, Fig
  9's rows; one 8-warp cell a policy through ``run_sm`` with a sink (K1
  and K2), its warps self-replayed and each cell's cycles and stalls
  re-derived from the archive, equal to K2's stamp; the archive's runs
  replayed again through ``Replayer(service=SimulationService())``, the
  same report;
- the simulation service: the simulator's 8,448 warps submitted one by one
  to ``SimulationService()`` with its defaults (``hanoi_torch`` on the
  card, 64 a batch, two workers), every result equal to
  ``Simulator().run_batch``'s, then 4,224 of them as Poisson arrivals at
  half the measured rate (latency percentiles); 24 SM cells of 8 warps
  through ``run_sm_grid`` (K1 and K2 a cell), each equal to
  ``Simulator().run_sm``'s; 2,112 warps through two shard processes with a
  persistent kernel cache under ``build/``, cold and then restarted, the
  restarted service taking no kernel-cache miss;
- the paper's benchmarks and the quickstart: ``bench_control_flow``'s
  summary (Fig 9, Fig 10; equal to the numpy ``hanoi``'s) and engine
  throughput, ``bench_sm``'s ``sm_torch`` gate (every bench and policy
  bit-equal to ``sm_interleave``; the 10x speedup reported, met or
  missed), ``bench_timing --smoke``, ``run --engine-api`` and the full
  ``run`` rows, and ``python -m repro_torch.examples.quickstart``, the
  last four as subprocesses that must exit 0;
- training: llama3.2-1b whole at full width (1.24 B parameters, f32
  weights and AdamW state, ``remat="full"``, the reference attention)
  for 6 steps of 4 x 2048 tokens through ``build_train_state``,
  ``make_step`` and ``StragglerMonitor``, with each step's loss, grad
  norm, lr and wall, tokens/s and the peak memory, and no kernel launched
  (no kernel has a backward pass); its first 2 layers for 3 steps of 1 x
  256 on the card against the CPU (TF32 off); ``quantize_int8`` of the
  token table's gradient bit-equal to the CPU's and compressed smoke
  steps; ``train()`` at the smoke config run twice, then failed at step
  18 and resumed from its step-16 checkpoint under ``build/``, held to
  the uninterrupted run; and ``python -m repro_torch.examples.train_lm``
  and ``python -m repro_torch.benchmarks.bench_analysis --smoke`` (its
  three gates on the card's host) as subprocesses;
- the cells and the dry run: [train]'s step once more under
  ``FlopCounterMode``, held to the dry run's count of the same step on the
  meta device (FLOPs equal, peak within 10% of the card's); llama3.2-1b
  whole through ``train_cell``'s step (bf16 compute from f32 masters, 3
  steps of 4 x 2048, with 1 and 2 microbatches held to each other, wall,
  tokens/s and peak beside the dry run's estimate), cut to 2 layers on the
  card against the CPU; ``python -m repro_torch.launch.dryrun`` over the
  single-pod mesh's 40 cells (33 ok, 7 skipped: no cell refused) and
  three ``train_4k`` cells of the (2, 16, 16) mesh (llama3.2-1b,
  mixtral-8x7b, recurrentgemma-2b), as subprocesses on the card's host
  while the distribution phases run, their roofline table printed; and ``examples/dryrun_cell.py``'s control-flow cell (BFSD,
  ``hanoi_torch`` against ``turing_oracle``) on the card, one launch of
  K1, equal to the CPU's row;
- distribution, ranks spawned by this script on the one card (gloo; NCCL
  for a world of one): llama3.2-1b at full width, cut to 2 layers,
  trained at (2, 2) and, whole, prefilled at (1, 2) through K3 on each
  rank's heads and, with
  ``score_shard="qseq"``, on each rank's query rows at offsets 0 and
  1024; recurrentgemma-2b and rwkv6-3b at full width on (1, 4), cut to 3
  and 2 layers (the prefill, through K4 / K5 on a rank's share once a
  recurrent layer; layer 0 with ``use_kernel=True`` through K4 / K5; one
  ``train_cell`` step), and rwkv6-3b's time mix at (1, 16), a head split
  over two ranks, through K5; each held to one rank (the layers to one
  rank's ``use_kernel=False``).

Every kernel's launch count is set to 0 just before each path and read just
after it; a path that launches a kernel another number of times than it
should fails the run.  Then it times each kernel beside its bound, its
plain version and, where one exists, one PyTorch call computing the same
function, prints one JSON line of kernel numbers and, last, one JSON line
naming the device.  Any failed phase, or no GPU, exits non-zero before
that last line.  Each numbered section of :func:`main` prints its host
wall (``[section_time]``), and the run's total (``[wall]``) comes just
before the kernels line.

    python3 chip_smoke.py --k1k2-times [--src DIR]

times only K1 at the simulator phase's shape (and at 4,096 slots of fuel,
its stepping with a 16th of the fill) and K2 at the SM model's grids (a)
and (b), on the operands those phases build, and the host walls of the
simulator phase's ``run_batch`` and of grids (a) and (b) (each run once
untimed, then timed), with the package under ``DIR`` (a directory inside
this checkout; default: its ``src``), and prints them as one JSON line:
unpack another tree inside the checkout and run both in one call, in
turns, to compare them on one card.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SEED = 0

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16 and CUDA-core f32
# peaks, and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

PREFILL_B, PREFILL_S = 4, 2048
# K3 on a rank's own query rows [a, b) of S (q_offset a): (name, B, S,
# rows, H, K, hd, window, dtype).  recurrentgemma-2b's local layer as rank
# 1 of 4 sees it (qseq: 10 heads do not divide 4); hd 64 GQA 4:1 at rows
# that start and end off the 64-row q tile; the CUDA-core kernel (f32)
# off its 128-row tile with a window
OFFSET_CASES = [
    ("rgemma_tp4_rank1_bf16", 4, 2048, (512, 1024), 10, 1, 256, 2048,
     torch.bfloat16),
    ("gqa_off_tile_bf16", 4, 2048, (1000, 2000), 32, 8, 64, 0,
     torch.bfloat16),
    ("gqa_off_tile_f32", 2, 2048, (1000, 1600), 8, 2, 64, 300,
     torch.float32),
]
RAGGED_S = 1000          # a sequence length no kernel tile divides
LONG_S = 16384           # K4/K5: many more segments than one resident wave
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K4 rounds each product and sum as its plain twin does (bit-equal
# expected); K5 carries the same state bit for bit and sums out over k in
# another order.  These are the JAX package's own kernel tolerances.
RGLRU_TOL, RWKV_TOL = 1e-5, 1e-4
# last-position logits of two prefills of one model (flash vs reference
# attention in bf16; K5 vs the chunked wkv in f32), relative to the
# largest logit.  rwkv6-3b is compared in f32: through its 32 bf16 layers
# one rounding flip grows to ~10% of the logits whichever form is right.
PREFILL_LOGITS_RTOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
# a layer with use_kernel=True against its plain branch, f32, on layer 0's
# weights: the log-depth RG-LRU scan and the per-token wkv scan round in
# other orders than the kernels
LAYER_TOL = 1e-4
# the simulator's full-size batch: one full residency of an H100 (132 SMs x
# 64 warps), and the paper's evaluation config (Simulator.compare's default)
SIM_WARPS = 132 * 64
# one dependent shared-memory round trip a scheduler slot, at the data
# sheet's 1.98 GHz boost clock: the latency half of K1's bound
SLOT_CYCLES, CLOCK_HZ = 30, 1.98e9
# the SM model's grids: (a) 1,056 cells of 8 warps (8,448 warps, one full
# residency of the card, as the simulator phase), greedy-then-oldest, the
# paper's Table III scheduler; (b) 264 cells of 32 warps, each warp its
# own program and memory, round robin
SM_CELLS_A, SM_WARPS_A = 1056, 8
SM_CELLS_B, SM_WARPS_B = 264, 32
# the archive phase: a quarter of the simulator phase's warps (132 SMs x
# 16), written through a sink, read, replayed and indexed on the host
ARCHIVE_WARPS = 132 * 16
POLICIES = ("greedy_then_oldest", "round_robin", "oldest_first")
# the service phases: the simulator phase's warps through the simulation
# service one request at a time; half of them again as an open-loop Poisson
# arrival process; 24 SM cells of 8 warps (8 a policy); the archive
# phase's 2,112 warps through two shard processes, cold and restarted
SERVICE_OPEN_WARPS = 132 * 32
SERVICE_SM_CELLS, SERVICE_SM_WARPS = 24, 8
SERVICE_PROC_WARPS = ARCHIVE_WARPS
# the MoE models: deepseek-moe-16b whole (16.4 B parameters, 32.8 GB in
# bf16) at 4 x 2048; mixtral-8x7b (46.7 B, 93 GB in bf16, more than one
# card) at full width with its depth cut to 8 of 32 layers, at 1 x 8192
# tokens so that its 4096-token window bites.  An f32 copy of either does
# not fit beside the bf16 one: the f32 holds run at the cut depths below,
# each on its own after the bf16 model is freed.  internlm2-20b's f32
# hold (config_phases) cuts its own weights, beside its bf16 model.
MIXTRAL_LAYERS = 8
MIXTRAL_S = 8192
F32_DEPTH = {"deepseek-moe-16b": 8, "mixtral-8x7b": 4, "internlm2-20b": 8}
# one MoE layer on the card against the same layer on the CPU, in f32:
# the largest output difference, relative to the largest output
MOE_RTOL = 1e-4
# a capacity factor small enough that the layer drops slots
MOE_DROP_FACTOR = 0.5
# the other configs, whole at full width: four token decoders through K3
# (hd 320 local and global; hd 128 at GQA 3:1, 6:1 and 2:1, internvl2-2b
# with 256 patches ahead of 1,792 tokens) and hubert-xlarge's non-causal
# encoder, which launches no K3 in either package.  The decoders are
# held as the MoE models are: in bf16 layer by layer (their 24 to 48
# layers' roundings take the two attention paths' last logits 4-14% apart,
# while each path stays as close to the f32 logits as the other), and end
# to end in f32 on the same weights, whole where an f32 copy fits beside
# the bf16 one (internlm2-20b's 79.4 GB does not: its first F32_DEPTH
# layers).  Each model is also cut to its first CUT_LAYERS layers
# (gemma3-4b to one whole pattern, so that a global layer is among them),
# and that cut runs CUT_S positions in f32 on the card against the CPU:
# the largest last-logit difference relative to the largest logit.
CONFIG_ARCHS = ("gemma3-4b", "minitron-4b", "internlm2-20b", "internvl2-2b",
                "hubert-xlarge")
CUT_LAYERS, CUT_S, CARD_CPU_RTOL = 2, 512, 1e-4
# training: llama3.2-1b whole at full width, f32 weights and AdamW state,
# TRAIN_STEPS steps of TRAIN_B x TRAIN_S tokens; its first CUT_LAYERS layers
# at 1 x CARD_CPU_TRAIN_S for 3 steps on the card against the CPU, the
# losses and grad norms within TRAIN_CARD_CPU_RTOL and every parameter
# within TRAIN_CARD_CPU_ATOL (f32 products and sums in other orders: ~1e-6
# relative; AdamW's lr at step 3 is 3e-5, so a gradient sign flipped by
# rounding near zero would show); COMPRESS_STEPS compressed smoke steps
TRAIN_STEPS, TRAIN_B, TRAIN_S = 6, 4, 2048
CARD_CPU_TRAIN_S, TRAIN_CARD_CPU_RTOL, TRAIN_CARD_CPU_ATOL = 256, 1e-5, 1e-5
COMPRESS_STEPS = 8
# the dry run's estimator (launch/steps.py::lower_fn: FlopCounterMode's
# formulas, MemTracker's live bytes, on the meta device) on [train]'s own
# step: its FLOPs equal to the card's FlopCounterMode count, its peak
# within DRYRUN_PEAK_RTOL of the card's measured peak
DRYRUN_PEAK_RTOL = 0.10
# the dry-run sweep: the single-pod mesh's 40 cells spread over
# DRYRUN_JOBS processes of the card's host and, at the same time, two
# multi-pod cells over two more (the host has 8 cores)
DRYRUN_JOBS = 6
DRYRUN_MULTI = ("llama3.2-1b,mixtral-8x7b,recurrentgemma-2b", "train_4k")
# [cell_train]: train_cell's step (bf16 compute from f32 masters, AdamW at
# its constant default lr) on llama3.2-1b whole, CELL_STEPS steps of
# TRAIN_B x TRAIN_S, with 1 and with 2 microbatches from the same
# weights; then cut to CUT_LAYERS layers at 1 x CELL_CARD_CPU_S on the
# card against the CPU (the CPU's bf16 steps take ~16 s a 100 tokens
# there, so 256 of them, as [train_card_vs_cpu]).  The two runs of each
# pair round their bf16 products in other orders (two microbatches sum
# two half-batch bf16 gradients in f32; the CPU's bf16 products
# accumulate otherwise).  Held, each limit about 2 to 3 times the larger
# of the two pairs' readings on an NVIDIA H100 80GB HBM3 at 700 W:
# * the losses and grad norms within CELL_RTOL relative (read: 1.588e-03
#   for mb 2 vs 1, 4.011e-04 card vs CPU);
# * each parameter leaf's difference within CELL_LEAF_NORM_RTOL of the
#   leaf's norm (read: 2.370e-03, 1.551e-03);
# * each leaf's mean absolute difference within CELL_LEAF_MEAN_LR * lr
#   (read: 2.444e-02, 2.459e-02).  AdamW moves an element by about lr a
#   step whatever the size of its gradient, so a gradient that is dropped
#   or taken from the wrong rows moves the elements it touches by up to
#   lr a step: one layer's slice of a stacked leaf's gradient dropped
#   moves that leaf by up to CELL_STEPS * lr / 16 (0.19 lr) in mean;
# * every parameter within AdamW's sign-flip bound (_flip_bound), which
#   only a layout or update fault passes.
CELL_STEPS, CELL_CARD_CPU_S = 3, 256
CELL_RTOL, CELL_LEAF_NORM_RTOL, CELL_LEAF_MEAN_LR = 5e-3, 5e-3, 0.06
# distribution: llama3.2-1b at full width cut to its first DIST_TRAIN_LAYERS
# layers (so that the whole run keeps its time limit), DIST_TRAIN_STEPS
# steps of DIST_TRAIN_B x DIST_TRAIN_S at (data 2, model 2) on 4 ranks
# sharing the card, against
# the one-rank step (TP and FSDP sum the products and the gradients in
# other orders).  Held: the losses and grad norms within DIST_TRAIN_RTOL
# relative; each parameter leaf within DIST_TRAIN_RTOL relative in norm
# (|p - p1| / |p1|), which a systematic difference in the updates fails;
# every parameter within the sign-flip bound of _adamw_flip_bound.  A
# gradient at the reductions' rounding noise can take either sign, and
# AdamW's per-element step then differs by up to 2 * lr * u_max: no
# gradient error can move an element further, so that hold checks the
# layout (each shard back in its place), not the gradients.  The lr is 0,
# 1.5e-5 and 3e-5 in these steps (warmup from DIST_TRAIN_LR).
# compressed_allreduce of a tensor the size of the token table's gradient
# over the 4 ranks
DIST_TRAIN_STEPS, DIST_TRAIN_B, DIST_TRAIN_S = 3, 4, 512
DIST_TRAIN_LAYERS = 2
DIST_TRAIN_LR, DIST_TRAIN_RTOL = 3e-3, 1e-5
DIST_COMPRESS_SHAPE = (128256, 2048)
# [dist_recurrent]: the recurrent archs at full width on (1, 4), cut to
# recurrentgemma-2b's first pattern (RG-LRU, RG-LRU, local attention) and
# rwkv6-3b's first 2 layers: the prefill of PREFILL_B x PREFILL_S (held
# as [dist_prefill] holds its own: recurrentgemma-2b in bf16, rwkv6-3b in
# f32, as its one-rank prefill is held; K4 / K5 once a recurrent layer
# on each rank), layer 0's temporal mix with use_kernel=True in f32
# (within LAYER_TOL of one rank's use_kernel=False) and one train_cell
# step of DIST_REC_TRAIN_B x DIST_REC_TRAIN_S
# (held as [cell_train] holds two runs); then rwkv6-3b's time mix at
# (1, 16), 2.5 heads a rank, 1 x SPLIT_HEAD_S in f32 through K5
DIST_REC_LAYERS = {"recurrentgemma-2b": 3, "rwkv6-3b": 2}
DIST_REC_TRAIN_B, DIST_REC_TRAIN_S = 2, 256
# The train step's hold.  One AdamW step from the draw moves every element
# by about lr whatever its gradient, so an element whose gradient sign
# rounding flips moves 2 lr apart: a zero-initialized leaf (conv_b,
# mu_base, decay_base, bonus) is then far apart in norm (reported, not
# held).  rwkv6-3b's grad norm stands 5.79e-3 from one rank's and one
# leaf 0.073 lr in mean (read at 2 x 256 on an NVIDIA H100 80GB HBM3 at
# 700 W; at 2 x 512, 4.47e-3 and 0.078), past [cell_train]'s 5e-3, by
# bf16 rounding: the Finch LoRA's interpolation weights
# (recurrent._lora_mu) are a product over the LoRA width that the mesh
# splits, and each rank's bf16 partial is rounded before the all-reduce
# sums them, which doubles the error of mu against one rank's single
# product (tests/test_torch_steps.py::
# test_lora_combine_on_a_mesh_rounds_each_partial_sum).  mu scales every
# interpolated input, so the r and k paths' gradients (wr, wk, the LoRA,
# mu_base, the token table) shrink more than one rank's bf16 ones do
# against f32 gradients; in f32 the mesh's step is one rank's to ~1e-6.
# A rank's shard of a leaf's gradient dropped or misplaced at (1, 4)
# moves a quarter of the leaf by lr or more: 0.25 lr in mean at least.
DIST_REC_RTOL, DIST_REC_MEAN_LR = 1e-2, 0.15
SPLIT_HEAD_RANKS, SPLIT_HEAD_S = 16, 2048


def phase(name: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {body}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


class SectionClock:
    """The host wall of each numbered section of :func:`main`: ``start``
    closes the open section with a ``[section_time]`` line and opens the
    next; ``total_s`` is the wall since this module was imported."""

    def __init__(self):
        self.name, self.t = None, 0.0

    def start(self, name: str | None) -> None:
        now = time.perf_counter()
        if self.name is not None:
            phase("section_time", section=self.name, s=f"{now - self.t:.1f}")
        self.name, self.t = name, now

    @staticmethod
    def total_s() -> float:
        return time.perf_counter() - _T0


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call of ``fn`` on the card, over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each entry function in an ``nvcc
    -Xptxas -v`` log, by its short name (``rwkv6_scan_kernel<64>``,
    ``hanoi_kernel``) where those are unique, else by its mangled name."""
    report, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            report[entry] = {}
        elif entry and "spill stores" in line:
            words = line.replace(",", "").split()
            report[entry]["spill_stores"] = int(
                words[words.index("spill") - 2])
            report[entry]["spill_loads"] = int(words[-4])
        elif entry and "Used" in line and "registers" in line:
            words = line.split()
            report[entry]["registers"] = int(words[words.index("Used") + 1])
    short = {}
    for entry in report:
        # the template's name, after its length in the mangled name
        names = [entry[i + 2:i + 2 + int(entry[i:i + 2])]
                 for i in range(len(entry) - 1) if entry[i:i + 2].isdigit()]
        name = next((n for n in names if n.endswith("kernel")
                     and n[0].isalpha() and (n + "I" in entry
                                             or n + "E" in entry)), None)
        if name and name + "I" in entry:        # a template's instance
            name = "{}<{}>".format(name, ",".join(
                re.findall(r"L[ib](\d+)E", entry)))
        short[entry] = name
    if all(short.values()) and len(set(short.values())) == len(short):
        return {short[e]: v for e, v in report.items()}
    return report


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def bound(flops: int, nbytes: int, dtype) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sim_requests(SimRequest, programs, sim_cfg, n):
    """n warp requests: warp w runs the suite's program w mod 23 on memory
    drawn by the suite's own generator from SEED + w.  A program the suite
    runs on zeroed memory (the spinlock, CALLS, the figures) keeps it: a
    spinlock whose lock word starts taken spins until its 60,000 slots are
    spent."""
    suite = programs.make_suite(sim_cfg)
    return [SimRequest(program=b.program, cfg=sim_cfg, name=b.name,
                       init_mem=None if b.init_mem is None
                       else programs._mem(sim_cfg, SEED + w))
            for w, b in ((w, suite[w % len(suite)]) for w in range(n))]


def hanoi_operands(reqs, cfg, skip_pcs=None, dev="cuda"):
    """K1's operands for a batch of warp requests, as ``run_batch`` packs
    them, with the given BSYNC pcs of warp i as oracle skips: the padded
    program length and the tensors on ``dev``."""
    from repro_torch.engine.adapters import _batch_arrays, padded_len
    L = padded_len(max(r.program.shape[0] for r in reqs))
    arrays = _batch_arrays(reqs, cfg, L)
    for i, pcs in enumerate(skip_pcs or ()):
        arrays[1][i, list(pcs)] = True
    return L, [torch.from_numpy(a).to(dev) for a in arrays]


def k1_times(ops, ins, cfg, short_cfg):
    """K1's ms on the operands at ``cfg`` and at ``short_cfg``."""
    return (cuda_time_ms(lambda: ops.hanoi_run(*ins, cfg), 5, warmup=1),
            cuda_time_ms(lambda: ops.hanoi_run(*ins, short_cfg), 5,
                         warmup=1))


def grid_kernel_times(ops, sm_torch, grid):
    """K1's and K2's ms on an SM grid's operands (K2 on K1's traces), and
    K2's launch on them."""
    k1_ms = cuda_time_ms(lambda: ops.hanoi_run(*grid.warp_operands,
                                               grid.cfg), 5, warmup=1)
    st = ops.hanoi_run(*grid.warp_operands, grid.cfg)
    warp_map, trace_n, out_cap = sm_torch.schedule_operands(grid, st)
    lat, is_mem = sm_torch._latency_tables(grid.ccfg)

    def k2():
        return ops.sm_schedule(warp_map, trace_n, grid.ops, st.trace_pc,
                               st.trace_mask, lat, is_mem, out_cap=out_cap,
                               policy=grid.policy)
    return k1_ms, cuda_time_ms(k2, 5, warmup=1), k2


def grid_b_cells(reqs):
    """The SM model's grid (b): 264 cells of 32 warps, each warp its own
    request of the simulator phase's batch."""
    return [reqs[c * SM_WARPS_B:(c + 1) * SM_WARPS_B]
            for c in range(SM_CELLS_B)]


def same_results(got, want) -> bool:
    """Every field of two lists of SimResults equal, but the wall time and
    the meta (the service annotates its results)."""
    def fields(r):
        return (r.mechanism, r.status, r.finished, r.steps, r.fuel_left,
                r.trace, r.utilization, r.error,
                *((a.dtype.str, a.shape, a.tobytes())
                  for a in (r.regs, r.preds, r.mem)))
    return len(got) == len(want) and all(
        fields(a) == fields(b) for a, b in zip(got, want))


def served(svc, reqs, arrivals=None):
    """Submit ``reqs`` to a running service one at a time (at ``arrivals``,
    seconds after the first, when given: an open loop), flush, and wait.
    Returns the results, each request's latency (sorted) from its
    submission or, in an open loop, from when it was due, the seconds from
    the first submission to the last resolution, and how late the
    generator submitted at worst."""
    done = [None] * len(reqs)
    tickets = []
    t0 = time.monotonic()
    due = [t0] * len(reqs) if arrivals is None else [t0 + a for a in arrivals]
    for i, req in enumerate(reqs):
        delay = due[i] - time.monotonic()
        if arrivals is not None and delay > 0:
            time.sleep(delay)
        ticket = svc.submit(req)
        ticket._future.add_done_callback(
            lambda _, i=i: done.__setitem__(i, time.monotonic()))
        tickets.append(ticket)
    svc.flush()
    results = [t.result(600) for t in tickets]
    deadline = time.monotonic() + 60
    while None in done and time.monotonic() < deadline:
        time.sleep(0.001)          # the last callbacks run after result()
    check(None not in done, "a ticket's resolution was not observed")
    start = ([t.submitted_at for t in tickets] if arrivals is None
             else due)
    lat = sorted(d - s for d, s in zip(done, start))
    late = max(t.submitted_at - d for t, d in zip(tickets, due)) \
        if arrivals is not None else 0.0
    return results, lat, max(done) - t0, late


def cut_depth(cfg, n_layers: int):
    """``cfg`` at full width with its uniform layer plan cut to
    ``n_layers``."""
    (pattern, _), = cfg.layer_plan
    return cfg.replace(n_layers=n_layers,
                       layer_plan=((pattern, n_layers),)).validate()


def f32_prefill_check(cfg, other_cfg, toks, gen, dev, *, init_params,
                      model_struct, Transformer, prefill) -> dict:
    """The last-position logits of ``cfg``'s prefill against
    ``other_cfg``'s on the same f32 weights: the largest difference, the
    largest logit, and whether the first is within PREFILL_LOGITS_RTOL."""
    model = Transformer(cfg, init_params(model_struct(cfg), gen,
                                         dtype=torch.float32, device=dev))
    batch = {"tokens": toks % cfg.vocab_size}
    got = prefill(model, cfg, batch)[0][:, -1].float()
    want = prefill(model, other_cfg, batch)[0][:, -1].float()
    err, ref_max = max_err(got, want), want.abs().max().item()
    rtol = PREFILL_LOGITS_RTOL[torch.float32]
    return {"err": err, "ref_max": ref_max, "rtol": rtol,
            "ok": bool(torch.isfinite(got).all()) and err <= rtol * ref_max}


def layerwise_hold(model, cfg, ref_cfg, batch, *, L, tm, moe_mod) -> dict:
    """A model's two bf16 prefills of ``batch``, layer by layer: the main
    path's (``cfg``: flash attention, K3) and the reference attention's
    (``ref_cfg``), each stream on its own hidden state.  In bf16 the two
    streams' hidden states differ by roundings that compound over the
    layers, and an MoE model routes some tokens to other experts (a top-k
    choice near a tie flips), so the logits of a deep or an MoE model part
    by more than a 16-layer dense model's.  Held here instead: each layer's
    attention through K3 against the reference attention on the main
    stream's own hidden state (``attn_rel``: the largest difference over
    the largest reference output).  Reported: the share of tokens whose
    expert set differs between the streams at each MoE layer, and the two
    streams' last-position logits."""
    cfgs = {"main": cfg, "ref": ref_cfg}
    attn_rel, flips, layer = [], {}, 0
    with torch.inference_mode():
        streams = {"main": tm._embed(model, cfg, batch)}
        streams["ref"] = streams["main"].clone()
        positions = torch.arange(streams["main"].shape[1],
                                 dtype=torch.int32,
                                 device=streams["main"].device)
        for seg, layers in zip(tm._segments(cfg), model.segments):
            for lp in layers:
                for j, kind in enumerate(seg["pattern"]):
                    p, experts = getattr(lp, str(j)), {}
                    for name, x in streams.items():
                        h = L.rmsnorm(p.ln1, x, cfg.norm_eps)
                        a, _ = L.attention(p.attn, h, cfg=cfgs[name],
                                           kind=kind, positions=positions)
                        if name == "main":
                            want, _ = L.attention(p.attn, h, cfg=ref_cfg,
                                                  kind=kind,
                                                  positions=positions)
                            attn_rel.append(max_err(a, want)
                                            / want.abs().max().item())
                            del want
                        x = x + a
                        h2 = L.rmsnorm(p.ln2, x, cfg.norm_eps)
                        if seg["moe"]:
                            eidx = moe_mod.route(p.ffn, h2, cfg)[2]
                            experts[name] = torch.sort(eidx, -1).values
                            out, _ = moe_mod.moe(p.ffn, h2, cfg)
                        else:
                            out = L.mlp(p.ffn, h2)
                        streams[name] = x + out
                    if experts:
                        flips[layer] = (experts["main"] != experts["ref"]) \
                            .any(-1).float().mean().item()
                    layer += 1
        last = {name: L.lm_logits(
            model.head, model.embed,
            L.rmsnorm(model.final_norm, x[:, -1:], cfg.norm_eps),
            cfg)[:, 0].float() for name, x in streams.items()}
    return {"attn_rel": attn_rel, "flips": flips,
            "e2e_err": max_err(last["main"], last["ref"]),
            "e2e_max": last["ref"].abs().max().item()}


def moe_layer_check(ffn, cfg, shape, dev, *, Params, moe_mod) -> dict:
    """One MoE layer (``ffn``, its Params block) on ``dev`` against the same
    layer on the CPU, in f32.  The router is rounded to multiples of 2^-10
    and the input drawn from {-1, 0, 1}, so the router logits are exact in
    f32 whatever the order of their sums, on either device: a difference
    in routing would be the dispatch's.  Returns the comparison, the
    dropped share of the slots and both walls."""
    def tree(p, to):
        out = {n: t.detach().float().to(to) for n, t in p._parameters.items()}
        out.update({n: tree(m, to) for n, m in p._modules.items()})
        return out

    x = torch.randint(-1, 2, shape, generator=torch.Generator()
                      .manual_seed(SEED)).float()
    runs = {}
    for where in (dev, torch.device("cpu")):
        t = tree(ffn, where)
        t["router"] = torch.round(t["router"] * 1024) / 1024
        params, xs = Params(t), x.to(where)
        _, slots, _, eidx, C = moe_mod.dispatch(params, xs, cfg)
        if where.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux = moe_mod.moe(params, xs, cfg)
        if where.type == "cuda":
            torch.cuda.synchronize()
        runs[where.type] = {
            "wall": time.perf_counter() - t0, "out": out.cpu(),
            "aux": aux.item(), "eidx": eidx.cpu(), "C": C,
            "slots": type(slots)(*(a.cpu() for a in slots))}
        del params, t, xs, out
    card, host = runs[dev.type], runs["cpu"]
    E, C = cfg.n_experts, host["C"]
    cs, hs = card["slots"], host["slots"]
    same = {
        "eidx": torch.equal(card["eidx"], host["eidx"]),
        "dest": torch.equal(cs.dest, hs.dest),
        "kept": torch.equal(cs.dest < E * C, hs.dest < E * C),
        "src_token": torch.equal(cs.src_token, hs.src_token),
        "by_token": torch.equal(cs.by_token, hs.by_token)}
    dropped = int((hs.dest == E * C).sum())
    n_slots = hs.dest.numel()
    out_max = host["out"].abs().max().item()
    return {"same": same, "C": C, "dropped": dropped, "slots": n_slots,
            "out_err": max_err(card["out"], host["out"]), "out_max": out_max,
            "aux_err": abs(card["aux"] - host["aux"]),
            "card_s": card["wall"], "cpu_s": host["wall"]}


def cut_params(cfg, params, n_layers: int, device):
    """``cfg`` and its ``params`` cut to the first ``n_layers`` layers, a
    whole number of repeats of the plan's first pattern, in f32 on
    ``device``."""
    from repro_torch.models.base import tree_map

    pattern, _ = cfg.layer_plan[0]
    r = n_layers // len(pattern)
    cut = cfg.replace(n_layers=r * len(pattern), layer_plan=((pattern, r),),
                      attn_dtype="f32").validate()
    f32 = lambda t: t.float().to(device)     # noqa: E731
    return cut, {"embed": tree_map(f32, params["embed"]),
                 "segments": [tree_map(lambda t: f32(t[:r]),
                                       params["segments"][0])],
                 "final_norm": tree_map(f32, params["final_norm"]),
                 "head": tree_map(f32, params["head"])}


def config_phases(*, prefill_phase, run_path, dev, gen) -> dict:
    """The configs of CONFIG_ARCHS on the card: each whole at full width, a
    bf16 prefill of 4 x 2048 positions from ``synthetic_batch`` as a main
    path (its K3 launches counted; the decoders held against the
    reference attention layer by layer in bf16 and end to end in f32),
    the peak while its weights are drawn one leaf at a time and while it
    prefills, its cut in f32 on the card against the CPU; then ``serve``
    of the token decoders (internlm2-20b on its bf16 weights), ``serve``
    refusing the frontend models, and the ``serve_lm`` example.  Returns
    their numbers."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import prefill, prefill_config
    from repro_torch.models import Transformer, init_params, model_struct
    from repro_torch.models.base import tree_map

    def inputs(batch, where):
        return {k: torch.from_numpy(batch[k]).to(where)
                for k in ("tokens", "frames", "patches") if k in batch}

    def last(model, cfg, batch):
        return prefill(model, cfg, batch)[0][:, -1].float()

    def rel(got, want):
        return max_err(got, want) / want.abs().max().item()

    def f32_hold(arch, cfg, params, model, batch) -> float:
        """[prefill_f32]: K3 (f32) against the reference attention on the
        weights in f32, and, whole, both bf16 paths against those f32
        logits."""
        depth = min(F32_DEPTH.get(arch, cfg.n_layers), cfg.n_layers)
        if depth < cfg.n_layers:
            cut, p32 = cut_params(cfg, params, depth, dev)
        else:
            cut = cfg.replace(attn_dtype="f32")
            p32 = tree_map(lambda t: t.float(), params)
        m32 = Transformer(cut, p32)
        ref32 = last(m32, cut.replace(attn_impl="reference"), batch)
        r = {"err": rel(last(m32, cut, batch), ref32),
             "ref_max": ref32.abs().max().item()}
        del m32, p32
        fields = {}
        if depth == cfg.n_layers:
            for name, c in (("k3", cfg),
                            ("reference", cfg.replace(attn_impl="reference"))):
                fields[f"bf16_{name}_vs_f32"] = \
                    f"{rel(last(model, c, batch), ref32):.3e}"
        rtol = PREFILL_LOGITS_RTOL[torch.float32]
        phase("prefill_f32", arch=arch,
              layers=f"{cut.n_layers} of {cfg.n_layers}",
              tokens="{}x{}".format(PREFILL_B, PREFILL_S),
              last_logits_max_rel_err=f"{r['err']:.3e}",
              ref_logits_max_abs=f"{r['ref_max']:.3e}", rtol=rtol, **fields)
        check(r["err"] <= rtol, f"{arch} f32 prefill at {cut.n_layers} "
              f"layers: last logits differ by {r['err']} of the largest")
        torch.cuda.empty_cache()
        return r["err"]

    numbers = {}
    for arch in CONFIG_ARCHS:
        cfg = prefill_config(arch, attn_impl="flash")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(model_struct(cfg), gen, dtype=torch.bfloat16,
                             device=dev)
        draw_gb = torch.cuda.max_memory_allocated() / 1e9
        batch = inputs(synthetic_batch(cfg, PREFILL_B, PREFILL_S), dev)
        model, caches = prefill_phase(
            arch, cfg, cfg.replace(attn_impl="reference") if cfg.causal
            else None, {"flash_attention": cfg.n_layers} if cfg.causal
            else {}, torch.bfloat16, batch=batch, params=params,
            layerwise=cfg.causal, layers=f"{cfg.n_layers} of {cfg.n_layers}",
            draw_peak_gb=f"{draw_gb:.2f}")
        check((caches is None) == (not cfg.is_decoder),
              f"{arch} prefill caches: {caches is None}")
        del caches
        numbers[arch] = {"draw_peak_gb": draw_gb}
        if cfg.causal:
            numbers[arch]["f32_rel_err"] = f32_hold(arch, cfg, params, model,
                                                    batch)
        del batch

        # [prefill_card_vs_cpu]: the same weights cut, f32, 1 x CUT_S
        cut, cut_p = cut_params(cfg, params, max(CUT_LAYERS,
                                                 len(cfg.layer_plan[0][0])),
                                torch.device("cpu"))
        small = synthetic_batch(cut, 1, CUT_S)
        lasts, walls = {}, {}
        for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
            m = Transformer(cut, tree_map(lambda t: t.to(where), cut_p))
            t0 = time.perf_counter()
            logits = prefill(m, cut, inputs(small, where))[0]
            torch.cuda.synchronize()
            walls[key] = time.perf_counter() - t0
            lasts[key] = logits[:, -1].float().cpu()
            del m, logits
        del cut_p
        err = max_err(lasts["card"], lasts["cpu"])
        ref_max = lasts["cpu"].abs().max().item()
        phase("prefill_card_vs_cpu", arch=arch,
              layers=f"{cut.n_layers} of {cfg.n_layers}", dtype="float32",
              tokens=f"1x{CUT_S}", last_logits_max_abs_err=f"{err:.3e}",
              ref_logits_max_abs=f"{ref_max:.3e}", rtol=CARD_CPU_RTOL,
              card_s=f"{walls['card']:.4f}", cpu_s=f"{walls['cpu']:.4f}")
        check(bool(torch.isfinite(lasts["card"]).all())
              and err <= CARD_CPU_RTOL * ref_max,
              f"{arch} cut to {cut.n_layers} layers, f32: card vs CPU last "
              f"logits differ by {err} (largest {ref_max})")
        numbers[arch]["card_vs_cpu_rel_err"] = err / ref_max

        if arch == "internlm2-20b":
            # [serve] on the bf16 weights: 79.4 GB in f32 does not fit
            numbers[arch]["serve_tok_per_s"] = serve_phase(
                arch, run_path, dev, model=model)
        del model, params
        torch.cuda.empty_cache()

    for arch in ("gemma3-4b", "minitron-4b"):
        numbers[arch]["serve_tok_per_s"] = serve_phase(arch, run_path, dev)
        torch.cuda.empty_cache()

    for arch in ("hubert-xlarge", "internvl2-2b"):
        try:
            serve(arch, smoke=False, batch=4, prompt_len=16, gen_len=32,
                  seed=SEED, device=dev)
            refused = ""
        except AssertionError as e:
            refused = str(e)
        phase("serve", arch=arch, refused=repr(refused))
        check("not a token decoder" in refused,
              f"serve did not refuse {arch}")

    subprocess_phase("serve_lm", ["repro_torch.examples.serve_lm"], 600)
    return numbers


def serve_phase(arch, run_path, dev, model=None) -> float:
    """A full-width ``serve`` of 4 requests (16 prompt tokens, 32 made) as
    a main path, after a short one that warms cuBLAS's plans: on
    ``model``'s bf16 weights when given, else on f32 weights drawn from
    SEED.  Prints its numbers, checks its tokens, returns its tokens/s."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    kw = dict(smoke=False, batch=4, seed=SEED, params=model, device=dev)
    serve(arch, prompt_len=2, gen_len=2, **kw)
    res, _, got = run_path(f"{arch} serve", lambda: serve(
        arch, prompt_len=16, gen_len=32, **kw), {})
    gen_tokens = res["generated"]
    phase("serve", arch=arch, params="f32" if model is None else "bf16",
          batch=4, prompt_len=16, gen_len=32, shape=gen_tokens.shape,
          wall_s=f"{res['wall_s']:.4f}",
          tok_per_s=f"{res['tokens_per_s']:.1f}", launches=got)
    print(f"  tokens[0]={gen_tokens[0].tolist()}")
    vocab = get_config(arch).vocab_size
    check(gen_tokens.shape == (4, 32)
          and bool(((gen_tokens >= 0) & (gen_tokens < vocab)).all()),
          f"{arch} serve tokens: shape {gen_tokens.shape} or out of the "
          f"vocabulary")
    return res["tokens_per_s"]


def subprocess_phase(name: str, args: list, timeout: int) -> str:
    """Run ``python -m <args>`` from the checkout with its ``src`` on the
    path; fail unless it exits 0.  Returns its standard output."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    tail = (res.stdout + res.stderr).strip().splitlines()[-12:]
    phase(name, command=" ".join(args), exit=res.returncode,
          wall_s=f"{wall:.2f}")
    for line in tail:
        print(f"  {line}")
    check(res.returncode == 0, f"{' '.join(args)} exited {res.returncode}")
    return res.stdout


def bench_phases(*, run_path, get_mechanism, as_request,
                 plan_dispatch) -> dict:
    """The port's benchmarks on the card: bench_control_flow's summary and
    engine throughput and bench_sm's sm_torch gate as main paths (their K1
    and K2 launches counted), bench_timing's smoke gates, run.py's rows
    (--engine-api, then the full run) and the quickstart, each as a
    subprocess.  Returns their numbers."""
    from repro_torch.benchmarks import bench_control_flow as bcf
    from repro_torch.benchmarks import bench_sm

    hanoi = get_mechanism("hanoi_torch")
    groups = len(plan_dispatch(hanoi, [as_request(b, bcf.CFG)
                                       for b in bcf._suite()]))
    report, wall, got = run_path(
        "bench_control_flow summary", bcf.compare_report,
        {"hanoi_run": groups})
    summary = bcf.summary(report)
    host = bcf.compare_report(mechanism="hanoi")
    same = {"fig9_rows": bcf.trace_discrepancy_rows(report)
            == bcf.trace_discrepancy_rows(host),
            "fig10_rows": bcf.ipc_rows(report) == bcf.ipc_rows(host),
            "summary": summary == bcf.summary(host)}
    phase("bench_control_flow", table="summary", launches=got,
          wall_s=f"{wall:.4f}", equal_to_numpy_hanoi=same,
          executions=summary["executions"],
          zero_discrepancy=summary["zero_discrepancy"],
          fig9_avg_pct=f"{summary['avg_discrepancy_pct']:.4f}",
          fig10_avg_abs_ipc_delta_pct=
          f"{summary['avg_abs_ipc_delta_pct']:.4f}",
          bfsd_ipc_gain_pct=f"{summary['bfsd_ipc_gain_pct']:.4f}")
    check(all(same.values()), f"bench_control_flow on the card differs from "
          f"the numpy hanoi: {same}")
    reps = 3
    thr, _, got = run_path("bench_control_flow engine_throughput",
                           lambda: bcf.engine_throughput(reps=reps),
                           {"hanoi_run": reps + 1})
    phase("bench_control_flow", table="engine_throughput", launches=got,
          warps=thr["n_warps"],
          torch_warps_per_s=f"{thr['torch_warps_per_s']:.1f}",
          numpy_warps_per_s=f"{thr['numpy_warps_per_s']:.1f}",
          speedup=f"{thr['speedup']:.3f}")

    smoke, wall, got = run_path(
        "bench_sm sm_torch_smoke", bench_sm.sm_torch_smoke,
        lambda r: {"hanoi_run": r["sm_torch_batches"],
                   "sm_schedule": r["sm_torch_batches"]})
    phase("bench_sm", launches=got, wall_s=f"{wall:.2f}",
          equality_cells=smoke["equality_cells"],
          policies=",".join(smoke["policies"]),
          mismatches=len(smoke["mismatches"]),
          timed=f"{smoke['cells']} cells x {smoke['n_warps']} warps GTO",
          t_sm_torch_s=f"{smoke['t_sm_torch_s']:.4f}",
          t_sm_interleave_s=f"{smoke['t_sm_interleave_s']:.4f}",
          speedup=f"{smoke['speedup']:.2f}",
          gate=f">= {smoke['min_speedup']:.0f}x",
          gate_met=smoke["speedup"] >= smoke["min_speedup"])
    check(not smoke["mismatches"], f"sm_torch diverged from sm_interleave "
          f"on {smoke['mismatches']}")

    timing_out = subprocess_phase(
        "bench_timing", ["repro_torch.benchmarks.bench_timing", "--smoke"],
        300)
    check(timing_out.count("[gate]") == 3, "bench_timing: a gate line is "
          "missing")
    api = subprocess_phase("run", ["repro_torch.benchmarks.run",
                                   "--engine-api"], 300)
    from repro_torch.benchmarks.run import engine_api_smoke
    want = engine_api_smoke(device="cpu")[0][2]
    got_api = next(line.split(",", 2)[2] for line in api.splitlines()
                   if line.startswith("engine_api_smoke,"))
    check(got_api == want, f"run --engine-api on the card: {got_api!r}, "
          f"its plain twin: {want!r}")
    full = subprocess_phase("run", ["repro_torch.benchmarks.run"], 600)
    names = [line.split(",", 1)[0] for line in full.splitlines()[1:]
             if "," in line]
    check(len(names) == 25 and names[0] == "fig9_trace_discrepancy"
          and names[-1] == "kernel[rwkv6_scan(plain)]",
          f"run rows: {names}")
    quick = subprocess_phase("quickstart",
                             ["repro_torch.examples.quickstart"], 600)
    check(quick.rstrip().endswith("quickstart OK"), "quickstart's last line")
    return {"summary": summary, "engine_throughput": thr,
            "sm_torch_smoke": {k: v for k, v in smoke.items()
                               if k != "mismatches"},
            "run_rows": [line for line in full.splitlines()
                         if "," in line]}


def train_phases(*, run_path, dev) -> None:
    """The port's training path on the card: llama3.2-1b whole at full
    width through ``build_train_state`` + ``make_step`` +
    ``StragglerMonitor`` as ``train()`` runs them, as a main path (no
    kernel launches: the JAX package differentiates through none); two
    layers of it on the card against the CPU; ``train()``'s failure and
    resume under ``build/``; int8 compression; the ``train_lm`` example and
    ``bench_analysis --smoke`` as subprocesses."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.train import build_train_state, make_step, train
    from repro_torch.models import (Transformer, init_params, loss_fn,
                                    model_struct)
    from repro_torch.models.base import tree_leaves, tree_map
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   cosine_schedule)
    from repro_torch.runtime import StragglerMonitor, quantize_int8

    # [train]: f32 weights and AdamW state, remat="full" (train_cell's
    # default), the reference attention, TRAIN_B x TRAIN_S a step
    cfg = get_config("llama3.2-1b").replace(remat="full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt = build_train_state(cfg, SEED, dev)
    state_gb = torch.cuda.memory_allocated() / 1e9
    step_fn = make_step(cfg, AdamWConfig(lr=3e-3), total_steps=TRAIN_STEPS)
    pipe = SyntheticPipeline(cfg, TRAIN_B, TRAIN_S)
    mon = StragglerMonitor()

    def steps():
        nonlocal model, opt
        rows = []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.get(i).items()}
            model, opt, _, m = step_fn(model, opt, None, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mon.record(0, wall)
            rows.append({"loss": m["loss"].item(),
                         "grad_norm": m["grad_norm"].item(),
                         "lr": m["lr"].item(), "wall_s": wall})
        return rows

    rows, _, got = run_path("llama3.2-1b train", steps, {})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, r in enumerate(rows):
        phase("train", arch="llama3.2-1b", step=i + 1,
              loss=f"{r['loss']:.4f}", grad_norm=f"{r['grad_norm']:.4f}",
              lr=f"{r['lr']:.3e}", wall_s=f"{r['wall_s']:.4f}")
    walls = [r["wall_s"] for r in rows]
    median = float(np.median(walls[1:]))
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    phase("train", arch="llama3.2-1b", layers=cfg.n_layers,
          params=sum(t.numel() for t in tree_leaves(model.tree)),
          dtype="float32", remat=cfg.remat, attn_impl=cfg.attn_impl,
          tokens=f"{TRAIN_B}x{TRAIN_S}", first_step_s=f"{walls[0]:.4f}",
          median_step_s=f"{median:.4f}",
          tok_per_s=f"{tokens / median:.1f}",
          flops_per_step=f"{flops:.4e}",
          tflop_per_s=f"{flops / median / 1e12:.2f}",
          state_gb=f"{state_gb:.2f}", peak_gb=f"{peak_gb:.2f}",
          stragglers=mon.stragglers(), launches=got)
    check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in rows),
          f"llama3.2-1b train: a loss or grad norm is not finite: {rows}")
    # where a step's time goes, on host clocks (no trace): the forward and
    # loss (its graph built, then dropped) and the AdamW update alone; the
    # rest of a step is the backward, with the layers' recompute
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.get(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = loss_fn(model, cfg, batch)
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    del loss, batch
    t0 = time.perf_counter()
    adamw_update(model.tree, model.grads, opt, AdamWConfig(lr=3e-3),
                 lr=cosine_schedule(opt["step"], peak_lr=3e-3,
                                    total=TRAIN_STEPS))
    torch.cuda.synchronize()
    upd = time.perf_counter() - t0
    phase("train_split", arch="llama3.2-1b", step_s=f"{median:.4f}",
          forward_loss_s=f"{fwd:.4f}", adamw_s=f"{upd:.4f}",
          backward_and_rest_s=f"{median - fwd - upd:.4f}")
    dryrun_hold(cfg, model, opt, step_fn, pipe.get(TRAIN_STEPS + 1), dev,
                median_s=median, peak_gb=peak_gb)
    tok_grad = model.grads["embed"]["tok"]
    del model, opt, step_fn
    torch.cuda.empty_cache()

    # [train_compress]: quantize_int8 of the last step's gradient of the
    # (tied) token table on the card and on the CPU, bit for bit; then
    # train() with compress=True
    q, s = quantize_int8(tok_grad)
    q_cpu, s_cpu = quantize_int8(tok_grad.cpu())
    same = (torch.equal(q.cpu(), q_cpu)
            and s.cpu().view(torch.int32).item()
            == s_cpu.view(torch.int32).item())
    del tok_grad, q
    res = train("llama3.2-1b", smoke=True, steps=COMPRESS_STEPS, batch=4,
                seq=128, compress=True, lr=1e-2, log_every=1000,
                device=dev)
    phase("train_compress",
          quantized=f"embed.tok grad {tuple(q_cpu.shape)}",
          bit_equal_to_cpu=same, scale=f"{s_cpu.item():.6e}",
          smoke_steps=COMPRESS_STEPS,
          losses=",".join(f"{x:.4f}" for x in res["losses"]))
    check(same, "quantize_int8 on the card differs from the CPU's")
    check(bool(np.isfinite(res["losses"]).all()),
          f"compressed training: {res['losses']}")

    # [train_card_vs_cpu]: full width cut to 2 layers, 1 x CARD_CPU_TRAIN_S,
    # 3 steps from
    # the same weights; TF32 off and f32 products at "highest"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cut = get_config("llama3.2-1b").replace(
        n_layers=CUT_LAYERS, layer_plan=((("global",), CUT_LAYERS),))
    params = init_params(model_struct(cut), torch.Generator().manual_seed(
        SEED), device="cpu")
    step_fn = make_step(cut, AdamWConfig(lr=3e-3), total_steps=10)
    pipe = SyntheticPipeline(cut, 1, CARD_CPU_TRAIN_S)
    runs = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        m = Transformer(cut, tree_map(lambda t: t.to(where, copy=True),
                                      params))
        m.trainable()
        o = adamw_init(m.tree)
        t0 = time.perf_counter()
        metrics = []
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(where)
                     for k, v in pipe.get(i).items()}
            m, o, _, mt = step_fn(m, o, None, batch)
            metrics.append((mt["loss"].item(), mt["grad_norm"].item()))
        torch.cuda.synchronize()
        runs[key] = (metrics, [t.cpu() for t in tree_leaves(m.tree)],
                     time.perf_counter() - t0)
        del m, o
    del params
    torch.cuda.empty_cache()
    (mc, pc, wc), (mh, ph, wh) = runs["card"], runs["cpu"]
    metric_rel = float(np.max(np.abs(np.array(mc) - np.array(mh))
                              / np.abs(np.array(mh))))
    param_err = max(max_err(a, b) for a, b in zip(pc, ph, strict=True))
    phase("train_card_vs_cpu", arch="llama3.2-1b",
          layers=f"{CUT_LAYERS} of 16", tokens=f"1x{CARD_CPU_TRAIN_S}",
          steps=3, tf32=torch.backends.cuda.matmul.allow_tf32,
          matmul_precision=torch.get_float32_matmul_precision(),
          losses_card=",".join(f"{x:.6f}" for x, _ in mc),
          losses_cpu=",".join(f"{x:.6f}" for x, _ in mh),
          loss_gnorm_max_rel_err=f"{metric_rel:.3e}",
          rtol=TRAIN_CARD_CPU_RTOL,
          params_max_abs_err=f"{param_err:.3e}",
          atol=TRAIN_CARD_CPU_ATOL, card_s=f"{wc:.3f}", cpu_s=f"{wh:.3f}")
    check(metric_rel <= TRAIN_CARD_CPU_RTOL
          and param_err <= TRAIN_CARD_CPU_ATOL,
          f"training on the card vs the CPU: losses and grad norms "
          f"{metric_rel}, parameters {param_err}")
    del pc, ph

    # [train_resume]: train() on the card at the smoke config, uninterrupted
    # twice (its determinism), then failed at step 18 and resumed from the
    # step-16 checkpoint under build/
    ck = ROOT / "build" / "train_resume"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(smoke=True, steps=24, batch=4, seq=32, ckpt_every=8, lr=1e-3,
              log_every=1000, device=dev)
    full = [train("llama3.2-1b", **kw) for _ in range(2)]
    try:
        train("llama3.2-1b", ckpt_dir=str(ck), fail_at_step=18, **kw)
        failed = ""
    except RuntimeError as e:
        failed = str(e)
    from repro_torch.checkpoint import latest_step
    at = latest_step(str(ck))
    resumed = train("llama3.2-1b", ckpt_dir=str(ck), resume=True, **kw)
    shutil.rmtree(ck, ignore_errors=True)

    def diff(a, b):
        return max(max_err(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b),
                                                  strict=True))

    rerun = diff(full[0]["params"], full[1]["params"])
    loss_diff = abs(resumed["losses"][-1] - full[0]["losses"][-1])
    param_diff = diff(resumed["params"], full[0]["params"])
    opt_diff = diff(resumed["opt_state"], full[0]["opt_state"])
    phase("train_resume", arch="llama3.2-1b smoke", steps=24,
          failed=repr(failed), resumed_from=at,
          final_loss=f"{full[0]['losses'][-1]:.6f}",
          final_loss_resumed=f"{resumed['losses'][-1]:.6f}",
          loss_abs_diff=f"{loss_diff:.3e}",
          params_max_abs_diff=f"{param_diff:.3e}",
          opt_max_abs_diff=f"{opt_diff:.3e}",
          two_uninterrupted_runs_params_max_abs_diff=f"{rerun:.3e}",
          held_to="rtol 1e-4 / atol 1e-5 (loss), rtol 2e-3 / atol 2e-4 "
                  "(params): tests/test_runtime.py")
    want = [t.float() for t in tree_leaves(full[0]["params"])]
    got_p = [t.float() for t in tree_leaves(resumed["params"])]
    check("injected failure at step 18" in failed and at == 16
          and len(resumed["losses"]) == 8
          and loss_diff <= 1e-5 + 1e-4 * abs(full[0]["losses"][-1])
          and all(bool(((g - w).abs() <= 2e-4 + 2e-3 * w.abs()).all())
                  for g, w in zip(got_p, want)),
          f"train resume: failed={failed!r} at={at} loss diff {loss_diff} "
          f"params {param_diff}")
    del full, resumed
    torch.cuda.empty_cache()

    out = subprocess_phase("train_lm", ["repro_torch.examples.train_lm"],
                           600)
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[example] loss"))
    first, last = (float(x) for x in line.split()[2:5:2])
    check(last < first, f"train_lm: {line}")

    out = subprocess_phase("bench_analysis",
                           ["repro_torch.benchmarks.bench_analysis",
                            "--smoke"], 600)
    gates = [ln for ln in out.splitlines() if ln.startswith("gate OK")]
    phase("bench_analysis", gates=len(gates))
    for ln in gates:
        print(f"  {ln}")
    check(len(gates) == 3, "bench_analysis: a gate line is missing")


def dryrun_hold(cfg, model, opt, step_fn, host_batch, dev, *,
                median_s: float, peak_gb: float) -> None:
    """[dryrun_hold]: the dry run's estimator on [train]'s own step.  One
    more step of it on the card under ``FlopCounterMode``; the same step
    on the meta device through ``launch/steps.py::lower_fn`` (the dry
    run's counter and ``MemTracker``), from a model and optimizer state
    of [train]'s shapes.  Held: the FLOPs equal, the estimated peak within
    DRYRUN_PEAK_RTOL of [train]'s measured one.  Reported: the roofline
    bound of the counts (``launch/hlo_analysis.py``: compute at the bf16
    tensor-core peak, which the dry run's cells use; the step runs in f32,
    so also with compute at the f32 CUDA-core peak) as a share of the
    measured step, and the MFU."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.hlo_analysis import Roofline
    from repro_torch.launch.steps import lower_fn
    from repro_torch.models import Transformer, init_params, model_struct
    from repro_torch.models.base import tree_leaves
    from repro_torch.optim import adamw_init

    batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
    with FlopCounterMode(display=False) as fc:
        step_fn(model, opt, None, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()

    meta = Transformer(cfg, init_params(model_struct(cfg), None,
                                        device="meta"))
    grads = meta.trainable()
    mopt = adamw_init(meta.tree)
    mbatch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in batch.items()}
    est = lower_fn(lambda: step_fn(meta, mopt, None, mbatch), (),
                   track=tree_leaves(meta.tree) + tree_leaves(grads)
                   + tree_leaves(mopt) + list(mbatch.values()))
    roof = Roofline(est.cost.flops, est.cost.hbm_bytes, 0.0)

    def mfu(dtype):
        return card_flops / median_s / PEAK_FLOPS[dtype]

    f32_bound = max(est.cost.flops / PEAK_FLOPS[torch.float32], roof.memory_s)
    est_gb = est.memory["peak_bytes"] / 1e9
    peak_rel = est_gb / peak_gb - 1
    phase("dryrun_hold", step="[train] llama3.2-1b 4x2048 f32 remat full",
          flops_card=card_flops, flops_estimate=int(est.cost.flops),
          peak_gb_card=f"{peak_gb:.2f}", peak_gb_estimate=f"{est_gb:.2f}",
          peak_rel_err=f"{peak_rel:+.4f}", rtol=DRYRUN_PEAK_RTOL,
          hbm_bytes_estimate=f"{est.cost.hbm_bytes:.4e}",
          roofline_bound_s=f"{roof.step_time_s:.4f}",
          dominant=roof.dominant, step_s=f"{median_s:.4f}",
          bound_share=f"{roof.step_time_s / median_s:.4f}",
          bound_f32_s=f"{f32_bound:.4f}",
          bound_f32_share=f"{f32_bound / median_s:.4f}",
          mfu_bf16_peak=f"{mfu(torch.bfloat16):.4f}",
          mfu_f32_peak=f"{mfu(torch.float32):.4f}",
          estimate_s=f"{est.seconds:.2f}")
    check(card_flops == est.cost.flops,
          f"dry-run FLOPs {est.cost.flops} != the card's {card_flops}")
    check(abs(peak_rel) <= DRYRUN_PEAK_RTOL,
          f"dry-run peak {est_gb:.2f} GB vs the card's {peak_gb:.2f} GB")
    del batch


def _cell_run(cell, params, opt, batches, timed: bool):
    """``cell.fn`` over ``batches``; (loss, grad norm, wall) a step."""
    rows = []
    for b in batches:
        t0 = time.perf_counter()
        _, _, m = cell.fn(params, opt, b)
        if timed:
            torch.cuda.synchronize()
        rows.append((m["loss"].item(), m["grad_norm"].item(),
                     time.perf_counter() - t0))
    return rows


def _pair_stats(rows, ref_rows, params, ref_params, lr: float) -> dict:
    """Two runs of ``train_cell``'s step apart: the losses' and grad
    norms' largest relative difference; each parameter leaf's difference
    in norm (relative to the leaf's) and in mean (in units of ``lr``), the
    worst leaf of each by its index; the largest element's."""
    metric_rel = float(np.max(np.abs(
        np.array([r[:2] for r in rows]) - np.array([r[:2] for r in ref_rows]))
        / np.abs(np.array([r[:2] for r in ref_rows]))))
    worst, norm_rel, mean_lr = 0.0, (0.0, -1), (0.0, -1)
    for i, (a, b) in enumerate(zip(params, ref_params, strict=True)):
        d = (a.double() - b.double()).abs()
        worst = max(worst, d.max().item())
        norm_rel = max(norm_rel, ((torch.linalg.vector_norm(d)
                                   / torch.linalg.vector_norm(b.double())
                                   ).item(), i))
        mean_lr = max(mean_lr, (d.mean().item() / lr, i))
    return {"metric_rel": metric_rel, "worst": worst, "norm_rel": norm_rel,
            "mean_lr": mean_lr}


def _pair_hold(name: str, rows, ref_rows, params, ref_params, lr: float,
               stats=None, phase_name="cell_train", rtol=CELL_RTOL,
               norm_rtol=CELL_LEAF_NORM_RTOL, mean_lr=CELL_LEAF_MEAN_LR,
               **fields) -> None:
    """Hold two runs of ``train_cell``'s step: losses and grad norms within
    ``rtol`` relative; each parameter leaf within ``norm_rtol`` of its
    norm (None: reported only) and ``mean_lr`` * lr in mean; every
    parameter within AdamW's sign-flip bound.  ``stats``:
    :func:`_pair_stats` already taken (where the parameters are elsewhere:
    a rank)."""
    s = stats or _pair_stats(rows, ref_rows, params, ref_params, lr)
    flip = _flip_bound([lr] * len(rows))
    phase(phase_name, compare=name,
          losses=",".join(f"{r[0]:.6f}" for r in rows),
          losses_ref=",".join(f"{r[0]:.6f}" for r in ref_rows),
          loss_gnorm_max_rel_err=f"{s['metric_rel']:.3e}", rtol=rtol,
          worst_leaf_norm_rel_err=f"{s['norm_rel'][0]:.3e}",
          worst_leaf_norm=s["norm_rel"][1], leaf_norm_rtol=norm_rtol,
          worst_leaf_mean_abs_err_in_lr=f"{s['mean_lr'][0]:.3e}",
          worst_leaf_mean=s["mean_lr"][1], leaf_mean_lr=mean_lr,
          params_max_abs_err=f"{s['worst']:.3e}", flip_bound=f"{flip:.3e}",
          **fields)
    check(s["metric_rel"] <= rtol
          and (norm_rtol is None or s["norm_rel"][0] <= norm_rtol)
          and s["mean_lr"][0] <= mean_lr and s["worst"] <= flip,
          f"{phase_name} {name}: losses and grad norms {s['metric_rel']}, "
          f"leaf {s['norm_rel']} in norm, {s['mean_lr']} lr in mean, "
          f"parameters {s['worst']} (bound {flip})")


def cell_train_phase(*, run_path, dev) -> dict:
    """[cell_train]: llama3.2-1b whole through ``train_cell``'s step, the
    path the dry run's training cells count, on one card (``mesh=None``):
    bf16 compute from f32 masters, CELL_STEPS steps of TRAIN_B x TRAIN_S
    with 1 and 2 microbatches from the same weights, held to each other;
    the dry run's estimate of the same step (FLOPs, bound, peak) beside
    the card's; the step cut to CUT_LAYERS layers, card against CPU."""
    from repro_torch.configs import Shape, get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.dryrun import HBM_BUDGET
    from repro_torch.launch.hlo_analysis import analyze_cell
    from repro_torch.launch.steps import lower_cell, train_cell
    from repro_torch.models import init_params, model_struct
    from repro_torch.models.base import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init

    numbers: dict = {}
    shape = Shape("cell_train", TRAIN_S, TRAIN_B, "train")
    full = get_config("llama3.2-1b")
    pipe = SyntheticPipeline(full, TRAIN_B, TRAIN_S)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                pipe.get(i).items()} for i in range(CELL_STEPS)]
    lr = AdamWConfig().lr
    bf16_peak = PEAK_FLOPS[torch.bfloat16]
    runs = {}
    for mb in (1, 2):
        cell = train_cell("llama3.2-1b", shape, None, microbatches=mb)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(model_struct(cell.cfg), torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        opt = adamw_init(params)
        rows, _, got = run_path(
            f"llama3.2-1b cell_train mb{mb}",
            lambda: _cell_run(cell, params, opt, batches, True), {})
        peak = torch.cuda.max_memory_allocated() / 1e9
        walls = [r[2] for r in rows]
        median = float(np.median(walls[1:]))
        est = lower_cell(cell, None)
        roof = analyze_cell(est)
        tokens = TRAIN_B * TRAIN_S
        for i, r in enumerate(rows):
            phase("cell_train", arch="llama3.2-1b", microbatches=mb,
                  step=i + 1, loss=f"{r[0]:.4f}", grad_norm=f"{r[1]:.4f}",
                  wall_s=f"{r[2]:.4f}")
        phase("cell_train", arch="llama3.2-1b", microbatches=mb,
              compute="bf16 from f32 masters", remat=cell.cfg.remat,
              attn_dtype=cell.cfg.attn_dtype, tokens=f"{TRAIN_B}x{TRAIN_S}",
              first_step_s=f"{walls[0]:.4f}", median_step_s=f"{median:.4f}",
              tok_per_s=f"{tokens / median:.1f}", peak_gb=f"{peak:.2f}",
              estimate_peak_gb=f"{est.memory['peak_bytes'] / 1e9:.2f}",
              estimate_flops=f"{roof.flops:.4e}",
              tflop_per_s=f"{roof.flops / median / 1e12:.2f}",
              mfu_bf16_peak=f"{roof.flops / median / bf16_peak:.4f}",
              roofline_bound_s=f"{roof.step_time_s:.4f}",
              dominant=roof.dominant,
              bound_share=f"{roof.step_time_s / median:.4f}",
              fits_budget=est.memory["peak_bytes"] <= HBM_BUDGET,
              launches=got)
        check(all(np.isfinite(r[:2]).all() for r in rows),
              f"cell_train mb{mb}: {rows}")
        runs[mb] = (rows, [t.cpu() for t in tree_leaves(params)])
        numbers[f"mb{mb}"] = {"median_step_s": median, "peak_gb": peak,
                              "estimate_peak_gb":
                                  est.memory["peak_bytes"] / 1e9}
        del params, opt, cell
    del batches
    torch.cuda.empty_cache()
    _pair_hold("microbatches 2 vs 1", runs[2][0], runs[1][0], runs[2][1],
               runs[1][1], lr)
    del runs

    # the step cut to CUT_LAYERS layers, 1 x CELL_CARD_CPU_S, card vs CPU
    cut = full.replace(n_layers=CUT_LAYERS,
                       layer_plan=((("global",), CUT_LAYERS),))
    cut_shape = Shape("cell_cut", CELL_CARD_CPU_S, 1, "train")
    cpipe = SyntheticPipeline(cut, 1, CELL_CARD_CPU_S)
    host = init_params(model_struct(cut), torch.Generator().manual_seed(SEED),
                       device="cpu")
    pair = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        cell = train_cell(cut, cut_shape, None)
        params = tree_map(lambda t: t.to(where, copy=True), host)
        opt = adamw_init(params)
        bs = [{k: torch.from_numpy(v).to(where) for k, v in
               cpipe.get(i).items()} for i in range(CELL_STEPS)]
        t0 = time.perf_counter()
        rows = _cell_run(cell, params, opt, bs, where.type == "cuda")
        pair[key] = (rows, [t.cpu() for t in tree_leaves(params)],
                     time.perf_counter() - t0)
    _pair_hold("card vs cpu", pair["card"][0], pair["cpu"][0],
               pair["card"][1], pair["cpu"][1], lr,
               layers=f"{CUT_LAYERS} of 16", tokens=f"1x{CELL_CARD_CPU_S}",
               card_s=f"{pair['card'][2]:.3f}", cpu_s=f"{pair['cpu'][2]:.3f}")
    del pair, host
    return numbers


def cell_phases(*, run_path, dev) -> dict:
    """The cells on the card: [cell_train] (:func:`cell_train_phase`);
    [dryrun_cell]: the example's control-flow cell on the card (one K1
    launch), held to the CPU's row."""
    from repro_torch.examples.dryrun_cell import run_cf_cell

    numbers = cell_train_phase(run_path=run_path, dev=dev)
    pair_names = ["hanoi_torch", "turing_oracle"]
    row, wall, got = run_path("dryrun_cell", lambda: run_cf_cell(
        "BFSD", pair_names, dev), {"hanoi_run": 1})
    cpu_row = run_cf_cell("BFSD", pair_names, "cpu")
    same = dataclasses.asdict(row) == dataclasses.asdict(cpu_row)
    phase("dryrun_cell", bench="BFSD", pair="hanoi_torch/turing_oracle",
          discrepancy_pct=f"{row.discrepancy_pct:.4f}",
          ipc_delta_pct=f"{row.ipc_delta_pct:.4f}", wall_s=f"{wall:.3f}",
          equal_to_cpu=same, launches=got)
    check(same, f"dryrun_cell: the card's row {row} != the CPU's {cpu_row}")
    return numbers


def dryrun_start() -> dict:
    """[dryrun], started: ``python -m repro_torch.launch.dryrun`` over the
    single-pod mesh's 40 cells and, at once, DRYRUN_MULTI's cells of the
    (2, 16, 16) mesh, as subprocesses on the card's host (no card), their
    records under build/ (never results/).  They run while the
    distribution phases do (:func:`dryrun_finish` waits for them)."""
    out = ROOT / "build" / "repro_torch"
    single, multi = out / "dryrun.json", out / "dryrun_multi.json"
    for p in (single, multi):
        p.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = {"single": ["--all", "--single-only", "--jobs", str(DRYRUN_JOBS),
                       "--out", str(single)],
            "multi": ["--arch", DRYRUN_MULTI[0], "--shape", DRYRUN_MULTI[1],
                      "--multipod-only", "--jobs", "2", "--out", str(multi)]}
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *a], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k, a in args.items()}
    return {"procs": procs, "t0": time.perf_counter(), "single": single,
            "multi": multi}


def dryrun_finish(run) -> dict:
    """[dryrun], finished: wait for :func:`dryrun_start`'s sweeps, print
    their tails and roofline table, and hold the records: 40 single-pod
    records, 33 ok and the registry's 7 skipped, no other status, and
    DRYRUN_MULTI's cells ok at (2, 16, 16)."""
    from repro_torch.configs import skipped_cells

    outs, walls = {}, {}
    try:
        for k, proc in run["procs"].items():
            outs[k], _ = proc.communicate(timeout=900)
            walls[k] = time.perf_counter() - run["t0"]
    finally:
        for proc in run["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, proc in run["procs"].items():
        phase("dryrun", command=" ".join(proc.args[2:]),
              exit=proc.returncode, wall_s=f"{walls[k]:.2f}")
        for line in outs[k].strip().splitlines()[-4:]:
            print(f"  {line}")
        check(proc.returncode == 0, f"the {k} dry run exited "
              f"{proc.returncode}")
    recs = (json.loads(run["single"].read_text())
            + json.loads(run["multi"].read_text()))
    counts = collections.Counter((r["mesh"], r["status"]) for r in recs)
    from repro_torch.benchmarks.roofline import fmt_table
    for line in fmt_table(recs, "single").splitlines():
        print(f"  {line}")
    for r in recs:
        if r["mesh"] == "multi":
            ro = r["roofline"]
            phase("dryrun", mesh="multi (2, 16, 16)", arch=r["arch"],
                  shape=r["shape"], status=r["status"],
                  flops=f"{ro['flops']:.4e}",
                  peak_gb=f"{r['memory']['peak_bytes'] / 1e9:.2f}",
                  coll_count=json.dumps(ro["coll_count_by_kind"]))
    by_status = {f"{m}_{st}": n for (m, st), n in sorted(counts.items())}
    phase("dryrun", single_s=f"{walls['single']:.1f}",
          multi_s=f"{walls['multi']:.1f}", jobs=DRYRUN_JOBS,
          beside="the distribution phases", **by_status)
    skips = {(r["arch"], r["shape"]) for r in recs
             if r["mesh"] == "single" and r["status"] == "skipped"}
    check(sum(1 for r in recs if r["mesh"] == "single") == 40
          and counts[("single", "ok")] == 33
          and skips == {(a, s) for a, s, _ in skipped_cells()}
          and all(r["status"] in ("ok", "skipped") for r in recs)
          and counts[("multi", "ok")] == 3,
          f"dry run: {dict(counts)}")
    check(not (ROOT / "results" / "dryrun.json").exists()
          and not (ROOT / "results" / "perf.json").exists(),
          "the dry run wrote under results/")
    return {"counts": by_status, "single_s": walls["single"],
            "multi_s": walls["multi"]}


# ---------------------------------------------------------------------------
# distribution: ranks spawned here, each a module-level function of this
# file (spawn_world pickles it by name), all on the one card
# ---------------------------------------------------------------------------

def _dist_train_cfg():
    """[dist_nccl1], [dist_train] and [dist_elastic]'s model."""
    from repro_torch.configs import get_config
    return cut_depth(get_config("llama3.2-1b"),
                     DIST_TRAIN_LAYERS).replace(remat="full")


def _dist_setup():
    """A rank's common set-up: f32 products in full f32, two host threads
    (the ranks share the host's cores), its card."""
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _dist_batches(cfg, steps: int):
    from repro_torch.data import SyntheticPipeline
    pipe = SyntheticPipeline(cfg, DIST_TRAIN_B, DIST_TRAIN_S)
    return [pipe.get(i) for i in range(steps)]


def _dist_train_run(cfg, dev, mesh=None):
    """DIST_TRAIN_STEPS steps of ``make_step`` as ``train()`` runs them, on
    one rank (``mesh`` None) or sharded on ``mesh``: (rows of loss and
    grad norm, step walls, resident state bytes, peak bytes above what
    was resident before, model)."""
    from repro_torch.launch.steps import mesh_config
    from repro_torch.launch.train import build_train_state, make_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import local_batch

    if mesh is not None:
        cfg = mesh_config(cfg, mesh, DIST_TRAIN_B)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, opt = build_train_state(cfg, SEED, dev, mesh)
    state = torch.cuda.memory_allocated() - base
    step_fn = make_step(cfg, AdamWConfig(lr=DIST_TRAIN_LR),
                        total_steps=DIST_TRAIN_STEPS)
    rows, walls = [], []
    for b in _dist_batches(cfg, DIST_TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if mesh is not None:
            batch = local_batch(batch, cfg, mesh)
        model, opt, _, m = step_fn(model, opt, None, batch)
        rows.append((m["loss"].item(), m["grad_norm"].item()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    del opt
    model.grads = None
    return rows, walls, state, peak, model


def _adamw_flip_bound(steps: int, peak_lr: float) -> float:
    """:func:`_flip_bound` over ``steps`` steps of ``make_step``'s
    schedule."""
    from repro_torch.optim.schedule import cosine_schedule
    return _flip_bound([cosine_schedule(t, peak_lr=peak_lr,
                                        total=steps).item()
                        for t in range(steps)])


def _flip_bound(lrs) -> float:
    """The most AdamW (``optim.adamw``'s defaults) can move one parameter
    apart in two runs over steps at the learning rates ``lrs``, whatever
    their gradients: the update m_hat / sqrt(v_hat) at Adam step n is at
    most u_max(n) = sqrt(sum_s a_s^2 / b_s) in size (Cauchy-Schwarz over
    the moments' weights a_s, b_s), so two runs' updates differ by at most
    2 * lr * u_max(n) a step; weight decay adds lr * 0.1 times the
    difference already made, which the factor (1 + 0.1) covers."""
    from repro_torch.optim import AdamWConfig
    c = AdamWConfig()
    total = 0.0
    for t, lr in enumerate(lrs):
        n = t + 1
        u2 = sum(((1 - c.b1) * c.b1 ** (n - s) / (1 - c.b1 ** n)) ** 2
                 / ((1 - c.b2) * c.b2 ** (n - s) / (1 - c.b2 ** n))
                 for s in range(1, n + 1))
        total += 2 * lr * u2 ** 0.5 * (1 + c.weight_decay)
    return total


def _params_vs(tree, ref_tree) -> tuple[float, float, float, int, int]:
    """(max abs error, the worst leaf's error relative to its largest
    value, the worst leaf's error norm relative to its norm, leaves
    bit-equal, leaves) of a sharded tree against a whole one
    (``ref_tree``: on one rank, None on the others), each leaf gathered
    on every rank in turn."""
    from repro_torch.models.base import tree_leaves
    from repro_torch.runtime import full_tensor
    leaves = tree_leaves(tree)
    refs = None if ref_tree is None else tree_leaves(ref_tree)
    abs_err, leaf_rel, norm_rel, equal = 0.0, 0.0, 0.0, 0
    for i, t in enumerate(leaves):
        full = full_tensor(t)
        if refs is not None:
            e = max_err(full, refs[i])
            abs_err = max(abs_err, e)
            leaf_rel = max(leaf_rel,
                           e / max(refs[i].abs().max().item(), 1e-30))
            norm_rel = max(norm_rel, (
                torch.linalg.vector_norm((full - refs[i]).double())
                / max(torch.linalg.vector_norm(refs[i].double()).item(),
                      1e-30)).item())
            equal += bool(torch.equal(full, refs[i]))
        del full
    return abs_err, leaf_rel, norm_rel, equal, len(leaves)


def _rel(rows, ref_rows) -> float:
    return float(np.max(np.abs(np.array(rows) - np.array(ref_rows))
                        / np.abs(np.array(ref_rows))))


def _dist_world1(rank, world):
    """[dist_nccl1]: the one-rank step, then the same steps on a (1, 1)
    mesh over NCCL."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    dev = _dist_setup()
    cfg = _dist_train_cfg()
    ref_rows, _, _, _, ref = _dist_train_run(cfg, dev)
    mesh = make_host_mesh(1, dev)
    comm.STATS.reset()
    rows, walls, state, peak, model = _dist_train_run(cfg, dev, mesh)
    stats = comm.STATS.as_dict()
    abs_err, leaf_rel, norm_rel, equal, n = _params_vs(model.tree, ref.tree)
    return {"backend": dist.get_backend(), "rows": rows, "ref_rows": ref_rows,
            "walls": walls, "state": state, "peak": peak,
            "rel": _rel(rows, ref_rows), "abs_err": abs_err,
            "leaf_rel": leaf_rel, "norm_rel": norm_rel, "equal": equal,
            "leaves": n,
            "comm": stats, "bit_equal_metrics": rows == ref_rows}


def _dist_world4(rank, world, ckpt: str):
    """[dist_train] at (2, 2) against rank 0's one-rank run;
    [dist_compress] over the 4 ranks; the save half of [dist_elastic];
    then [dist_recurrent]'s (1, 4) phases (:func:`_dist_recurrent_ranks`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, model_struct
    from repro_torch.runtime import compressed_allreduce
    from repro_torch.sharding import comm, param_pspecs
    dev = _dist_setup()
    out = {"backend": dist.get_backend()}
    cfg = _dist_train_cfg()
    ref = ref_rows = None
    if rank == 0:
        ref_rows, _, out["ref_state"], _, ref = _dist_train_run(cfg, dev)
        torch.cuda.empty_cache()
    ref_rows = [None] if ref_rows is None else [ref_rows]
    dist.broadcast_object_list(ref_rows, src=0)
    mesh = make_host_mesh(2, dev)
    comm.STATS.reset()
    rows, walls, state, peak, model = _dist_train_run(cfg, dev, mesh)
    out.update(comm=comm.STATS.as_dict(), rows=rows, walls=walls,
               state=state, peak=peak, mesh=list(mesh.mesh.shape))
    # the final parameters against rank 0's one-rank run
    abs_err, leaf_rel, norm_rel, equal, n = _params_vs(
        model.tree, None if ref is None else ref.tree)
    out.update(rel=_rel(rows, ref_rows[0]), abs_err=abs_err,
               leaf_rel=leaf_rel, norm_rel=norm_rel, equal=equal, leaves=n,
               ref_rows=ref_rows[0])
    del model, ref
    torch.cuda.empty_cache()

    # [dist_compress]: every rank its own tensor the size of the token
    # table's gradient; the int8 all-reduce on the card and, over the same
    # group, on the CPU, against the f32 sum
    mesh1 = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
    g = torch.Generator(device=dev).manual_seed(SEED + rank)
    x = torch.randn(DIST_COMPRESS_SHAPE, generator=g, device=dev)
    exact = comm.all_reduce(x, mesh1.get_group("data"))
    comm.STATS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compressed_allreduce(x, mesh1, "data")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wire = comm.STATS.as_dict()
    rel_c = max_err(got, exact) / exact.abs().max().item()
    got_cpu = compressed_allreduce(x.cpu(), mesh1, "data")
    out["compress"] = {
        "rel_err": rel_c, "wall_s": wall, "wire": wire,
        "n": x.numel(), "equal_cpu": bool(torch.equal(got.cpu(), got_cpu)),
        "cpu_max_abs_diff": max_err(got.cpu(), got_cpu)}
    del x, exact, got, got_cpu
    torch.cuda.empty_cache()

    # [dist_elastic], save: the f32 parameters drawn at (2, 2), each rank
    # writing its own shards
    struct = model_struct(cfg)
    params = init_params(struct, torch.Generator(device=dev).manual_seed(
        SEED), device=dev, mesh=mesh, specs=param_pspecs(struct, cfg, mesh))
    t0 = time.perf_counter()
    save_checkpoint(ckpt, 1, params, process_index=rank,
                    process_count=world)
    out["save_s"] = time.perf_counter() - t0
    dist.barrier()
    del params
    torch.cuda.empty_cache()

    # [dist_recurrent] at (1, 4), in this world (no second spawn)
    t0 = time.perf_counter()
    out["recurrent"] = _dist_recurrent_ranks(rank, world)
    out["recurrent_s"] = time.perf_counter() - t0
    return out


def _dist_world2(rank, world, ckpt: str):
    """[dist_prefill] at (1, 2) through K3, against rank 0's one-rank
    prefill; the restore half of [dist_elastic] on ``survivors_mesh``."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import prefill, prefill_config
    from repro_torch.models import Transformer, init_params, model_struct
    from repro_torch.models.base import tree_leaves, tree_map
    from repro_torch.runtime import full_tensor, survivors_mesh
    from repro_torch.sharding import (comm, local_batch, param_pspecs,
                                      placements)
    dev = _dist_setup()
    out = {"backend": dist.get_backend()}
    mesh = make_host_mesh(2, dev)
    lcfg = get_config("llama3.2-1b")
    tokens = torch.randint(0, lcfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED), device=dev)
    batch = {"tokens": tokens}
    struct = model_struct(lcfg)

    def bf16_params(m=None, cfg=None):
        return init_params(struct, torch.Generator(device=dev).manual_seed(
            SEED), dtype=torch.bfloat16, device=dev, mesh=m,
            specs=None if m is None else param_pspecs(struct, cfg, m))

    ref = None
    if rank == 0:
        cfg1 = prefill_config("llama3.2-1b", attn_impl="flash")
        model1 = Transformer(cfg1, bf16_params())
        ref = prefill(model1, cfg1, batch)[0]
        del model1
        torch.cuda.empty_cache()
    dist.barrier()
    cfg = prefill_config("llama3.2-1b", attn_impl="flash", mesh=mesh,
                         batch=PREFILL_B)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Transformer(cfg, bf16_params(mesh, cfg))
    out["weights"] = torch.cuda.memory_allocated() - base
    mine = local_batch(batch, cfg, mesh)
    prefill(model, cfg, mine)                           # warm-up
    torch.cuda.reset_peak_memory_stats()
    comm.STATS.reset()
    ops.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(model, cfg, mine)
    torch.cuda.synchronize()
    out.update(wall=time.perf_counter() - t0,
               k3_launches=ops.flash_attention.launches,
               peak=torch.cuda.max_memory_allocated() - base,
               comm=comm.STATS.as_dict())
    k0 = caches[0]["0"]["k"]
    out["cache"] = {"placements": str(k0.placements),
                    "local_shape": list(k0.to_local().shape),
                    "global_shape": list(k0.shape)}
    out["cfg"] = {k: getattr(cfg, k) for k in (
        "batch_axes", "act_shard", "kv_shard", "score_shard", "attn_dtype",
        "attn_impl")}
    full = full_tensor(logits)[..., :lcfg.vocab_size]     # padded vocab
    finite = bool(torch.isfinite(full).all())
    if rank == 0:
        out["logits_max_abs_err"] = max_err(full, ref)
        out["ref_logits_max_abs"] = ref.abs().max().item()
    out["finite"] = finite
    del full, caches, logits

    # [dist_qseq]: the same weights under score_shard="qseq": each rank
    # projects q, k and v of its own 2048 / 2 rows, all-gathers k and v,
    # and attends with its rows through K3 at their offset
    qcfg = cfg.replace(score_shard="qseq")
    prefill(model, qcfg, mine)                          # warm-up
    comm.STATS.reset()
    ops.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill(model, qcfg, mine)
    torch.cuda.synchronize()
    out["qseq"] = {"wall": time.perf_counter() - t0,
                   "k3_launches": ops.flash_attention.launches,
                   "q_offset": mesh.get_local_rank("model")
                   * PREFILL_S // mesh["model"].size(),
                   "comm": comm.STATS.as_dict()}
    full = full_tensor(logits)[..., :lcfg.vocab_size]
    out["qseq"]["finite"] = bool(torch.isfinite(full).all())
    if rank == 0:
        out["qseq"]["logits_max_abs_err"] = max_err(full, ref)
    del full, ref, logits, model
    torch.cuda.empty_cache()

    # [dist_elastic], restore: the 4 ranks' (2, 2) checkpoint onto the
    # survivors' mesh; each leaf bit-equal to the same draw made on it
    cfg32 = _dist_train_cfg()
    struct = model_struct(cfg32)
    new = survivors_mesh(list(range(world)), ("data", "model"), 2, dev)
    specs = param_pspecs(struct, cfg32, new)
    like = tree_map(lambda p: torch.empty(p.shape, device="meta"), struct)
    t0 = time.perf_counter()
    got = restore_checkpoint(ckpt, 1, like, shardings=specs, mesh=new)
    restore_s = time.perf_counter() - t0
    want = init_params(struct, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev, mesh=new, specs=specs)
    equal = placed = 0
    for g_, w_, s_ in zip(tree_leaves(got), tree_leaves(want),
                          tree_leaves(specs), strict=True):
        equal += bool(torch.equal(g_.to_local(), w_.to_local()))
        placed += list(g_.placements) == placements(new, s_)
    out["elastic"] = {"mesh": list(new.mesh.shape), "leaves":
                      len(tree_leaves(got)), "bit_equal": equal,
                      "placed_as_specified": placed,
                      "restore_s": restore_s}
    return out


def _value_major(wkv):
    """A one-rank RWKV-6 state [B, H, hd, hd] value-major, [B, hd, d]: the
    layout the mesh keeps it in."""
    B, H, hd, _ = wkv.shape
    return wkv.transpose(1, 2).reshape(B, hd, H * hd)


def _layer_on_mesh(fn, params, x, cfg, lay, kernel):
    """``fn`` (a temporal-mix layer) with ``use_kernel=True`` on this
    rank's rows of ``x`` on ``lay``: (output and state gathered, wall, the
    kernel's launches)."""
    from repro_torch.sharding import comm
    with torch.inference_mode():
        fn(params, comm.chunk(x, 1, lay.model), cfg=cfg, use_kernel=True,
           lay=lay)                                     # warm-up
        kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, state = fn(params, comm.chunk(x, 1, lay.model), cfg=cfg,
                        use_kernel=True, lay=lay)
        torch.cuda.synchronize()
        wall, n = time.perf_counter() - t0, kernel.launches
        got = comm.all_gather(got, 1, lay.model)
        state = {k: comm.all_gather(t, t.dim() - 1, lay.model)
                 for k, t in state.items()}
    return got, state, wall, n


def _layer_errs(got, state, want, want_state) -> dict:
    """A layer's gathered output and state on a mesh against one rank's:
    the largest differences (the RWKV-6 state compared value-major)."""
    if "wkv" in want_state:
        want_state = dict(want_state, wkv=_value_major(want_state["wkv"]))
    return {"out_err": max_err(got, want),
            "out_max": want.abs().max().item(),
            "state_err": {k: max_err(state[k], want_state[k])
                          for k in want_state}}


def _f32_block(src):
    """A layer's parameter block in f32, each tensor marked as ``src``'s
    (the mesh dimensions it is split over)."""
    from repro_torch.models.base import Params
    from repro_torch.sharding.layout import mark, shard_of
    p = Params({n: t.float() for n, t in src.named_parameters()})
    if hasattr(next(src.parameters()), "_mesh_shard"):
        for n, t in src.named_parameters():
            mark(getattr(p, n), shard_of(t))
    return p


def _dist_recurrent_ranks(rank, world):
    """[dist_recurrent] at (1, 4), run by [dist_train]'s 4 ranks: recurrentgemma-2b (10 heads over 4:
    qseq; 640 LRU channels a rank) and rwkv6-3b (40 heads, 10 a rank) at
    full width, cut as DIST_REC_LAYERS says: the prefill through the mesh
    (recurrentgemma-2b's local layer through K3 at each rank's offset),
    layer 0's temporal mix with use_kernel=True (K4 on a rank's 640
    channels, K5 on its 10 heads) and one train_cell step, each against
    rank 0's one-rank run on the same draw."""
    import torch.distributed as dist

    from repro_torch.configs import Shape, get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import mesh_config, prefill, train_cell
    from repro_torch.models import Transformer, init_params, model_struct
    from repro_torch.models import recurrent
    from repro_torch.models.base import (LOCAL, RECURRENT, RWKV, cycle_plan,
                                         tree_leaves)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import full_tensor
    from repro_torch.sharding import comm, local_batch, param_pspecs
    from repro_torch.sharding.layout import Layout
    dev = _dist_setup()
    mesh = make_host_mesh(4, dev)
    lay = Layout(mesh, batch=True, seq=True)
    out = {"backend": dist.get_backend()}

    def gen(seed=SEED):
        return torch.Generator(device=dev).manual_seed(seed)

    tokens = torch.randint(0, 1 << 16, (PREFILL_B, PREFILL_S),
                           generator=gen(), device=dev)
    for arch in DIST_REC_LAYERS:
        n = DIST_REC_LAYERS[arch]
        full = get_config(arch)
        if arch == "recurrentgemma-2b":
            cut = full.replace(n_layers=n, layer_plan=cycle_plan(
                (RECURRENT, RECURRENT, LOCAL), n), attn_impl="flash")
            dtype, fn, sub, kernel = (torch.bfloat16, recurrent.rglru,
                                      "rglru", ops.rglru_scan)
        else:
            cut = cut_depth(full, n)
            dtype, fn, sub, kernel = (torch.float32,
                                      recurrent.rwkv6_time_mix, "tm",
                                      ops.rwkv6_scan)
        cut = cut.replace(attn_dtype="bf16").validate()
        batch = {"tokens": tokens % cut.vocab_size}
        struct = model_struct(cut)
        res = {"layers": n}
        one = ref = None
        if rank == 0:
            one = Transformer(cut, init_params(struct, gen(), dtype=dtype,
                                               device=dev))
            ref = prefill(one, cut, batch)[0]
        mcfg = mesh_config(cut, mesh, PREFILL_B)
        model = Transformer(mcfg, init_params(
            struct, gen(), dtype=dtype, device=dev, mesh=mesh,
            specs=param_pspecs(struct, mcfg, mesh)))
        mine = local_batch(batch, mcfg, mesh)
        prefill(model, mcfg, mine)                      # warm-up
        comm.STATS.reset()
        ops.flash_attention.launches = kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(model, mcfg, mine)
        torch.cuda.synchronize()
        res["prefill"] = {"wall": time.perf_counter() - t0,
                          "k3_launches": ops.flash_attention.launches,
                          "scan_launches": kernel.launches,
                          "scan_layers": sum(k in (RECURRENT, RWKV)
                                             for k in cut.kinds),
                          "score_shard": mcfg.score_shard,
                          "dtype": str(dtype)[6:],
                          "comm_gb": comm.STATS.bytes / 1e9}
        # the last position's logits, gathered over the vocab's split
        loc = logits.to_local()
        last = loc[:, -1].contiguous()
        if loc.shape[-1] != cut.padded_vocab:
            last = comm.all_gather(last, 1, lay.model)
        last = last[:, :cut.vocab_size]
        res["prefill"]["finite"] = bool(torch.isfinite(loc).all())
        if rank == 0:
            res["prefill"]["err"] = max_err(last, ref[:, -1])
            res["prefill"]["ref_max"] = ref[:, -1].abs().max().item()
        del logits, caches, loc, last, ref

        # layer 0's temporal mix, f32, use_kernel=True
        x = torch.randn((PREFILL_B, PREFILL_S, cut.d_model), generator=gen(
            SEED + 1), device=dev)
        params = _f32_block(getattr(getattr(model.segments[0][0], "0"), sub))
        got, state, wall, k = _layer_on_mesh(fn, params, x, mcfg, lay,
                                             kernel)
        res["layer"] = {"wall": wall, "launches": k}
        if rank == 0:
            with torch.inference_mode():
                want, want_state = fn(_f32_block(getattr(
                    getattr(one.segments[0][0], "0"), sub)), x, cfg=cut,
                    use_kernel=False)
            res["layer"].update(_layer_errs(got, state, want, want_state))
        del one, model, params, got, state, x
        torch.cuda.empty_cache()

        # one train_cell step, bf16 compute from f32 masters
        tcut = cut.replace(attn_impl="reference")
        shape = Shape("dist_recurrent", DIST_REC_TRAIN_S, DIST_REC_TRAIN_B,
                      "train")
        tb = [{k_: torch.from_numpy(v).to(dev) for k_, v in SyntheticPipeline(
            tcut, DIST_REC_TRAIN_B, DIST_REC_TRAIN_S).get(0).items()}]
        ref_rows = ref_leaves = None
        if rank == 0:
            cell = train_cell(tcut, shape, None)
            p1 = init_params(model_struct(cell.cfg), gen(), device=dev)
            ref_rows = _cell_run(cell, p1, adamw_init(p1), tb, True)
            ref_leaves = tree_leaves(p1)
        cell = train_cell(tcut, shape, mesh)
        pm = init_params(model_struct(cell.cfg), gen(), device=dev,
                         mesh=mesh, specs=cell.in_shardings[0])
        comm.STATS.reset()
        rows = _cell_run(cell, pm, adamw_init(pm), tb, True)
        res["train"] = {"rows": rows, "comm_gb": comm.STATS.bytes / 1e9}
        leaves = [full_tensor(t) for t in tree_leaves(pm)]
        if rank == 0:
            res["train"].update(ref_rows=ref_rows, stats=_pair_stats(
                rows, ref_rows, leaves, ref_leaves, AdamWConfig().lr))
        del pm, leaves, ref_leaves, cell
        torch.cuda.empty_cache()
        out[arch] = res
    return out


def _dist_world_split_head(rank, world):
    """[dist_recurrent], the split head: rwkv6-3b's time mix at (1, 16),
    full width, 1 x SPLIT_HEAD_S, f32: each rank's 160 channels are 2.5
    heads, and it runs K5 on the 3 heads they touch, v zero outside them;
    against rank 0's one-rank layer (K5 on all 40 heads)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.models import recurrent
    from repro_torch.models.base import Params, partition_specs
    from repro_torch.models.transformer import local_params
    from repro_torch.sharding.layout import Layout
    from repro_torch.sharding.specs import logical_rules
    dev = _dist_setup()
    torch.set_num_threads(1)             # 16 ranks on the host's cores
    mesh = make_host_mesh(world, dev)
    lay = Layout(mesh, batch=False, seq=True)
    cfg = get_config("rwkv6-3b")
    struct = recurrent.rwkv6_struct(cfg)["tm"]
    specs = partition_specs(struct, logical_rules(cfg, mesh))
    params = local_params(init_params(
        struct, torch.Generator(device=dev).manual_seed(SEED), device=dev,
        mesh=mesh, specs=specs))
    x = torch.randn((1, SPLIT_HEAD_S, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 1))
    got, state, wall, n = _layer_on_mesh(recurrent.rwkv6_time_mix, params,
                                         x, cfg, lay, ops.rwkv6_scan)
    c = cfg.d_model // world
    c0, hd = lay.tp_rank * c, cfg.rwkv_head_dim
    out = {"backend": dist.get_backend(), "wall": wall, "launches": n,
           "channels": (c0, c0 + c),
           "heads": (c0 // hd, -(-(c0 + c) // hd))}
    if rank == 0:
        whole = Params(init_params(
            struct, torch.Generator(device=dev).manual_seed(SEED),
            device=dev))
        with torch.inference_mode():
            want, want_state = recurrent.rwkv6_time_mix(
                whole, x, cfg=cfg, use_kernel=False)
        out.update(_layer_errs(got, state, want, want_state))
    return out


def dist_phases(*, launches) -> dict:
    """The distribution phases: ranks spawned by this script on the one
    card, (1, 1) over NCCL, (2, 2) and (1, 2) over gloo (NCCL refuses two
    ranks on one GPU).  Returns the K3 numbers of [dist_prefill]."""
    from repro_torch.launch.mesh import spawn_world

    torch.cuda.empty_cache()
    ck = ROOT / "build" / "dist_elastic"
    shutil.rmtree(ck, ignore_errors=True)
    gb = 1e9

    t0 = time.perf_counter()
    flip = _adamw_flip_bound(DIST_TRAIN_STEPS, DIST_TRAIN_LR)
    [r1] = spawn_world(_dist_world1, 1, device="cuda")
    phase("dist_nccl1", arch="llama3.2-1b", mesh="(1, 1)",
          layers=f"{DIST_TRAIN_LAYERS} of 16",
          backend=r1["backend"], steps=DIST_TRAIN_STEPS,
          tokens=f"{DIST_TRAIN_B}x{DIST_TRAIN_S}",
          losses=",".join(f"{x:.6f}" for x, _ in r1["rows"]),
          losses_one_rank=",".join(f"{x:.6f}" for x, _ in r1["ref_rows"]),
          loss_gnorm_max_rel_err=f"{r1['rel']:.3e}",
          loss_gnorm_bit_equal=r1["bit_equal_metrics"],
          params_max_abs_err=f"{r1['abs_err']:.3e}",
          params_worst_leaf_norm_rel_err=f"{r1['norm_rel']:.3e}",
          params_bit_equal_leaves=r1["equal"],
          state_gb=f"{r1['state'] / gb:.3f}",
          step_s=",".join(f"{w:.3f}" for w in r1["walls"]),
          collectives=json.dumps(r1["comm"]["by_op"]),
          wall_s=f"{time.perf_counter() - t0:.1f}")
    check(r1["backend"] == "nccl", f"dist_nccl1 ran over {r1['backend']}")
    check(r1["rel"] <= DIST_TRAIN_RTOL and r1["norm_rel"] <= DIST_TRAIN_RTOL
          and r1["abs_err"] <= flip,
          f"dist_nccl1: losses/grad norms {r1['rel']}, params "
          f"{r1['norm_rel']} in norm, {r1['abs_err']} at most")

    t0 = time.perf_counter()
    r4 = spawn_world(_dist_world4, 4, str(ck), device="cuda")
    a = r4[0]
    for r, res in enumerate(r4):
        phase("dist_train", rank=r, backend=res["backend"],
              mesh=tuple(res["mesh"]), state_gb=f"{res['state'] / gb:.3f}",
              peak_gb=f"{res['peak'] / gb:.3f}",
              step_s=",".join(f"{w:.3f}" for w in res["walls"]),
              collectives=res["comm"]["calls"],
              collective_gb=f"{res['comm']['bytes'] / gb:.3f}")
    phase("dist_train", arch="llama3.2-1b", mesh="(data 2, model 2)",
          layers=f"{DIST_TRAIN_LAYERS} of 16",
          dtype="float32", remat="full", steps=DIST_TRAIN_STEPS,
          tokens=f"{DIST_TRAIN_B}x{DIST_TRAIN_S}",
          losses=",".join(f"{x:.6f}" for x, _ in a["rows"]),
          losses_one_rank=",".join(f"{x:.6f}" for x, _ in a["ref_rows"]),
          grad_norms=",".join(f"{g:.6f}" for _, g in a["rows"]),
          loss_gnorm_max_rel_err=f"{a['rel']:.3e}", rtol=DIST_TRAIN_RTOL,
          params_worst_leaf_norm_rel_err=f"{a['norm_rel']:.3e}",
          params_max_abs_err=f"{a['abs_err']:.3e}",
          params_max_err_rel_to_leaf_max=f"{a['leaf_rel']:.3e}",
          sign_flip_bound=f"{flip:.3e}",
          params_bit_equal_leaves=f"{a['equal']}/{a['leaves']}",
          one_rank_state_gb=f"{a['ref_state'] / gb:.3f}",
          collectives_by_op=json.dumps(a["comm"]["by_op"]),
          wall_note="gloo through host memory on one card, not NVLink")
    check(all(r["rows"] == a["rows"] for r in r4),
          "dist_train: the ranks report different losses")
    check(a["rel"] <= DIST_TRAIN_RTOL and a["norm_rel"] <= DIST_TRAIN_RTOL
          and a["abs_err"] <= flip,
          f"dist_train: losses/grad norms {a['rel']}, params "
          f"{a['norm_rel']} in norm, {a['abs_err']} at most")
    check(all(r["state"] <= 0.3 * a["ref_state"] for r in r4),
          "dist_train: a rank's resident state is not near a quarter")
    c = a["compress"]
    wire = sum(b for _, b in c["wire"]["by_op"].values())
    phase("dist_compress", ranks=4, shape=DIST_COMPRESS_SHAPE,
          rel_err=f"{c['rel_err']:.4e}", bound=0.05,
          equal_to_cpu=c["equal_cpu"],
          cpu_max_abs_diff=f"{c['cpu_max_abs_diff']:.3e}",
          wire_bytes_per_rank=wire, by_op=json.dumps(c["wire"]["by_op"]),
          f32_ring_bytes_per_rank=2 * 4 * c["n"],
          ratio=f"{2 * 4 * c['n'] / wire:.3f}", wall_s=f"{c['wall_s']:.3f}")
    check(all(r["compress"]["rel_err"] < 0.05 and r["compress"]["equal_cpu"]
              for r in r4), "dist_compress: error or card/CPU mismatch")
    world4_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    r2 = spawn_world(_dist_world2, 2, str(ck), device="cuda")
    shutil.rmtree(ck, ignore_errors=True)
    b = r2[0]
    for r, res in enumerate(r2):
        launches["flash_attention"][f"llama3.2-1b dist_prefill rank {r}"] = \
            res["k3_launches"]
        phase("dist_prefill", rank=r, backend=res["backend"],
              k3_launches=res["k3_launches"], wall_s=f"{res['wall']:.4f}",
              weights_gb=f"{res['weights'] / gb:.3f}",
              peak_gb=f"{res['peak'] / gb:.3f}",
              collectives=res["comm"]["calls"],
              collective_gb=f"{res['comm']['bytes'] / gb:.3f}",
              cache=json.dumps(res["cache"]))
    rtol = PREFILL_LOGITS_RTOL[torch.bfloat16]
    phase("dist_prefill", arch="llama3.2-1b", mesh="(data 1, model 2)",
          tokens=f"{PREFILL_B}x{PREFILL_S}", params="bf16",
          cfg=json.dumps(b["cfg"]),
          logits_max_abs_err=f"{b['logits_max_abs_err']:.3e}",
          ref_logits_max_abs=f"{b['ref_logits_max_abs']:.3e}", rtol=rtol)
    check(all(r["k3_launches"] == 16 and r["finite"] for r in r2),
          "dist_prefill: a rank did not launch K3 16 times")
    check(b["logits_max_abs_err"] <= rtol * b["ref_logits_max_abs"],
          f"dist_prefill: logits differ by {b['logits_max_abs_err']}")
    check(all(r["cache"]["placements"] == "(Shard(dim=1), Shard(dim=3))"
              and r["cache"]["local_shape"][3] == 4 for r in r2),
          f"dist_prefill: caches {b['cache']}")
    e = b["elastic"]
    phase("dist_elastic", saved="(2, 2) by 4 ranks", restored=tuple(e["mesh"]),
          leaves=e["leaves"], bit_equal=e["bit_equal"],
          placed_as_specified=e["placed_as_specified"],
          save_s=f"{a['save_s']:.2f}", restore_s=f"{e['restore_s']:.2f}")
    check(all(r["elastic"]["bit_equal"] == e["leaves"]
              and r["elastic"]["placed_as_specified"] == e["leaves"]
              for r in r2), f"dist_elastic: {e}")
    for r, res in enumerate(r2):
        q = res["qseq"]
        launches["flash_attention"][f"llama3.2-1b dist_qseq rank {r}"] = \
            q["k3_launches"]
        phase("dist_qseq", rank=r, q_offset=q["q_offset"],
              k3_launches=q["k3_launches"], wall_s=f"{q['wall']:.4f}",
              collectives=q["comm"]["calls"],
              collective_gb=f"{q['comm']['bytes'] / gb:.3f}")
    q = b["qseq"]
    phase("dist_qseq", arch="llama3.2-1b", mesh="(data 1, model 2)",
          score_shard="qseq (forced: 32 heads divide 2)",
          tokens=f"{PREFILL_B}x{PREFILL_S}", params="bf16",
          logits_max_abs_err=f"{q['logits_max_abs_err']:.3e}",
          ref_logits_max_abs=f"{b['ref_logits_max_abs']:.3e}", rtol=rtol)
    check(all(r["qseq"]["k3_launches"] == 16 and r["qseq"]["finite"]
              for r in r2), "dist_qseq: a rank did not launch K3 16 times")
    check(sorted(r["qseq"]["q_offset"] for r in r2) == [0, PREFILL_S // 2],
          "dist_qseq: the ranks' query rows are not [0, S/2) and [S/2, S)")
    check(q["logits_max_abs_err"] <= rtol * b["ref_logits_max_abs"],
          f"dist_qseq: logits differ by {q['logits_max_abs_err']}")
    world2_s = time.perf_counter() - t0
    rec = dist_recurrent_phases([r["recurrent"] for r in r4],
                                launches=launches)
    phase("dist", world4_s=f"{world4_s:.1f}", world2_s=f"{world2_s:.1f}",
          recurrent_1x4_s=f"{a['recurrent_s']:.1f}",
          world_split_head_s=f"{rec['split_head']['world_s']:.1f}")
    return {"k3_launches_per_rank": [r["k3_launches"] for r in r2],
            "prefill_wall_s": [r["wall"] for r in r2],
            "qseq_k3_launches_per_rank": [r["qseq"]["k3_launches"]
                                          for r in r2],
            "qseq_prefill_wall_s": [r["qseq"]["wall"] for r in r2],
            "recurrent": rec}


def dist_recurrent_phases(rr, *, launches) -> dict:
    """[dist_recurrent]: the recurrent archs at (1, 4) (``rr``, each
    rank's :func:`_dist_recurrent_ranks`), then the split head at (1, 16)
    (:func:`_dist_world_split_head`).  Returns their K4 / K5 numbers."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.optim import AdamWConfig

    lr = AdamWConfig().lr
    rec: dict = {}
    for arch in DIST_REC_LAYERS:
        kname = "rglru_scan" if arch == "recurrentgemma-2b" else "rwkv6_scan"
        for r, res in enumerate(rr):
            x = res[arch]
            if x["prefill"]["k3_launches"]:
                launches["flash_attention"][
                    f"{arch} dist_recurrent prefill rank {r}"] = \
                    x["prefill"]["k3_launches"]
            launches[kname][f"{arch} dist_recurrent prefill rank {r}"] = \
                x["prefill"]["scan_launches"]
            launches[kname][f"{arch} dist_recurrent layer 0 rank {r}"] = \
                x["layer"]["launches"]
            phase("dist_recurrent", arch=arch, rank=r,
                  prefill_wall_s=f"{x['prefill']['wall']:.4f}",
                  k3_launches=x["prefill"]["k3_launches"],
                  **{f"prefill_{kname}_launches":
                     x["prefill"]["scan_launches"]},
                  prefill_collective_gb=f"{x['prefill']['comm_gb']:.3f}",
                  layer_wall_s=f"{x['layer']['wall']:.4f}",
                  **{f"{kname}_launches": x["layer"]["launches"]},
                  train_step_s=f"{x['train']['rows'][0][2]:.4f}",
                  train_collective_gb=f"{x['train']['comm_gb']:.3f}")
        a0 = rr[0][arch]
        pf, ly = a0["prefill"], a0["layer"]
        dtype = getattr(torch, pf["dtype"])
        ptol = PREFILL_LOGITS_RTOL[dtype]
        phase("dist_recurrent", arch=arch, mesh="(data 1, model 4)",
              part="prefill", layers=f"{a0['layers']} at full width",
              tokens=f"{PREFILL_B}x{PREFILL_S}", dtype=pf["dtype"],
              score_shard=pf["score_shard"],
              last_logits_max_abs_err=f"{pf['err']:.3e}",
              ref_logits_max_abs=f"{pf['ref_max']:.3e}", rtol=ptol)
        k3 = 1 if arch == "recurrentgemma-2b" else 0
        got = [(res[arch]["prefill"]["k3_launches"],
                res[arch]["prefill"]["scan_launches"]) for res in rr]
        check(all(res[arch]["prefill"]["finite"] for res in rr)
              and all(n == (k3, pf["scan_layers"]) for n in got),
              f"dist_recurrent {arch}: prefill not finite, or K3 / {kname} "
              f"launches {got} not {k3} / {pf['scan_layers']} a rank")
        check(pf["err"] <= ptol * pf["ref_max"],
              f"dist_recurrent {arch}: prefill logits differ by {pf['err']}")
        phase("dist_recurrent", arch=arch,
              part="layer 0, use_kernel=True vs one rank's False",
              dtype="float32", shape=(PREFILL_B, PREFILL_S),
              out_max_abs_err=f"{ly['out_err']:.3e}",
              out_max_abs=f"{ly['out_max']:.3e}",
              state_max_abs_err={k: f"{e:.3e}" for k, e in
                                 ly["state_err"].items()}, tol=LAYER_TOL)
        check(all(res[arch]["layer"]["launches"] == 1 for res in rr),
              f"dist_recurrent {arch}: a rank did not launch {kname} once")
        check(max(ly["out_err"], *ly["state_err"].values()) <= LAYER_TOL,
              f"dist_recurrent {arch}: layer 0 differs from one rank {ly}")
        tr = a0["train"]
        _pair_hold(f"{arch} (1, 4) vs one rank", tr["rows"], tr["ref_rows"],
                   None, None, lr, stats=tr["stats"],
                   phase_name="dist_recurrent", rtol=DIST_REC_RTOL,
                   norm_rtol=None, mean_lr=DIST_REC_MEAN_LR,
                   tokens=f"{DIST_REC_TRAIN_B}x{DIST_REC_TRAIN_S}",
                   step_s=f"{tr['rows'][0][2]:.3f}",
                   one_rank_step_s=f"{tr['ref_rows'][0][2]:.3f}")
        rec[arch] = {"layer_wall_s": [res[arch]["layer"]["wall"]
                                      for res in rr],
                     "layer_launches": [res[arch]["layer"]["launches"]
                                        for res in rr],
                     "layer_max_abs_err": ly["out_err"]}
    t0 = time.perf_counter()
    rs = spawn_world(_dist_world_split_head, SPLIT_HEAD_RANKS, device="cuda")
    for r, res in enumerate(rs):
        launches["rwkv6_scan"][f"rwkv6-3b dist_recurrent split head rank "
                               f"{r}"] = res["launches"]
    s0 = rs[0]
    phase("dist_recurrent", arch="rwkv6-3b", part="time mix, split head",
          mesh=f"(data 1, model {SPLIT_HEAD_RANKS})", dtype="float32",
          tokens=f"1x{SPLIT_HEAD_S}", backend=s0["backend"],
          channels=[tuple(r["channels"]) for r in rs[:3]],
          heads=[tuple(r["heads"]) for r in rs[:3]],
          k5_launches=[r["launches"] for r in rs],
          wall_s=",".join(f"{r['wall']:.4f}" for r in rs),
          out_max_abs_err=f"{s0['out_err']:.3e}",
          out_max_abs=f"{s0['out_max']:.3e}",
          state_max_abs_err={k: f"{e:.3e}" for k, e in
                             s0["state_err"].items()}, tol=LAYER_TOL)
    check(all(r["launches"] == 1 for r in rs),
          "dist_recurrent split head: a rank did not launch K5 once")
    check(max(s0["out_err"], *s0["state_err"].values()) <= LAYER_TOL,
          f"dist_recurrent split head: differs from one rank {s0}")
    rec["split_head"] = {"wall_s": [r["wall"] for r in rs],
                         "heads": [list(r["heads"]) for r in rs],
                         "max_abs_err": s0["out_err"],
                         "world_s": time.perf_counter() - t0}
    return rec



def train_flops(cfg, B: int, S: int) -> float:
    """FLOPs of one training step of a dense decoder with remat="full":
    forward (2 a weight and token, 4·S·H·hd a token and layer for the
    scores and the weighted sum over all S positions, as the reference
    attention computes them), backward (twice the forward) and the
    layers' recompute (one more forward of them)."""
    d, L = cfg.d_model, cfg.n_layers
    layer = (2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
             + 3 * d * cfg.d_ff)
    head = d * cfg.padded_vocab
    tokens = B * S
    layers_fwd = 2 * L * layer * tokens + 4 * L * S * cfg.n_heads * cfg.hd \
        * tokens
    return 3 * (layers_fwd + 2 * head * tokens) + layers_fwd


def service_phases(*, run_path, launches, reqs, sim, suite_req, scratch,
                   SimulationService, nearest_rank, smi) -> dict:
    """The ``[service]``, ``[service_sm]`` and ``[service_proc]`` phases:
    the simulation service on the card, every result held to the
    Simulator's.  Returns their numbers."""
    numbers = {}
    want = sim.run_batch(reqs)             # the reference: one K1 launch

    # [service]: closed loop, the SimulationService defaults
    svc = SimulationService()
    try:
        (results, lat, wall, _), _, got = run_path(
            "service closed loop", lambda: served(svc, reqs),
            lambda out: {"hanoi_run": svc.stats().native_batches})
        closed = svc.stats()
        check(same_results(results, want), "the service's results differ "
              "from Simulator().run_batch's")
        rate = len(reqs) / wall
        # open loop: Poisson arrivals at half the closed loop's rate
        n_open = SERVICE_OPEN_WARPS
        gaps = np.random.default_rng(SEED).exponential(2.0 / rate, n_open)
        arrivals = np.concatenate([[0.0], np.cumsum(gaps[1:])])
        batches0 = svc.stats().native_batches
        (open_results, open_lat, open_wall, open_late), _, open_got = \
            run_path(
            "service open loop",
            lambda: served(svc, reqs[:n_open], arrivals),
            lambda out: {"hanoi_run": svc.stats().native_batches
                         - batches0})
        opened = svc.stats()
        check(same_results(open_results, want[:n_open]), "the open-loop "
              "service's results differ from Simulator().run_batch's")
    finally:
        check(svc.stop() == [], "service threads outlived stop()")
    numbers["service"] = {
        "warps": len(reqs), "wall_s": wall, "warps_per_s": rate,
        "k1_launches": got["hanoi_run"],
        "native_batches": closed.native_batches,
        "mean_fill": closed.mean_fill,
        "flush_size": closed.flush_size,
        "flush_deadline": closed.flush_deadline,
        "latency_p50_s": nearest_rank(lat, 0.50),
        "latency_p99_s": nearest_rank(lat, 0.99),
        "exec_s": sum(r.wall_time_s for r in results),
        "open_loop": {
            "warps": n_open, "offered_warps_per_s": rate / 2,
            "achieved_warps_per_s": n_open / open_wall,
            "k1_launches": open_got["hanoi_run"],
            "native_batches": opened.native_batches - batches0,
            "latency_p50_s": nearest_rank(open_lat, 0.50),
            "latency_p99_s": nearest_rank(open_lat, 0.99),
            "generator_late_max_s": open_late}}
    phase("service", held_to="Simulator().run_batch, every field",
          launches=got, open_loop_launches=open_got,
          **{k: (f"{v:.4f}" if isinstance(v, float) else v)
             for k, v in numbers["service"].items() if k != "open_loop"},
          open_loop={k: (f"{v:.4f}" if isinstance(v, float) else v)
                     for k, v in numbers["service"]["open_loop"].items()},
          card=repr(smi))

    # [service_sm]: a grid of SM cells through run_sm_grid, sm_torch: one
    # K1 and one K2 launch a cell
    cells = [dict(programs=[suite_req(SERVICE_SM_WARPS * c + w)
                            for w in range(SERVICE_SM_WARPS)],
                  policy=POLICIES[c * len(POLICIES) // SERVICE_SM_CELLS])
             for c in range(SERVICE_SM_CELLS)]
    svc = SimulationService()
    try:
        grid, sm_wall, sm_got = run_path(
            "service_sm run_sm_grid",
            lambda: svc.run_sm_grid(cells, timeout=600),
            {"hanoi_run": SERVICE_SM_CELLS, "sm_schedule": SERVICE_SM_CELLS})
    finally:
        check(svc.stop() == [], "service_sm threads outlived stop()")
    fields = ("sm_trace", "cycles", "thread_instructions", "busy_cycles",
              "issue_stall_cycles", "scoreboard_stall_cycles",
              "memory_stall_cycles")
    for cell, sm in zip(cells, grid):
        ref = sim.run_sm(cell["programs"], policy=cell["policy"])
        check(sm.mechanism == ref.mechanism == "sm_torch"
              and all(getattr(sm, f) == getattr(ref, f) for f in fields)
              and same_results(list(sm.warps), list(ref.warps)),
              f"service_sm: a {cell['policy']} cell differs from "
              "Simulator().run_sm's")
    numbers["service_sm"] = {
        "cells": len(cells), "warps": len(cells) * SERVICE_SM_WARPS,
        "wall_s": sm_wall, "cells_per_s": len(cells) / sm_wall,
        "k1_launches": sm_got["hanoi_run"],
        "k2_launches": sm_got["sm_schedule"],
        "cycles": sum(sm.cycles for sm in grid)}
    phase("service_sm", launches=sm_got,
          held_to="Simulator().run_sm, sm_trace, cycles and stalls",
          **{k: (f"{v:.4f}" if isinstance(v, float) else v)
             for k, v in numbers["service_sm"].items()})

    # [service_proc]: two shard processes with a persistent kernel cache,
    # cold and restarted; groups form at max_batch and on the final flush,
    # never on a deadline, so both runs take the same signatures
    warm_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_warm_", dir=scratch))
    proc_reqs = reqs[:SERVICE_PROC_WARPS]
    numbers["service_proc"] = {}
    try:
        for label in ("cold", "restarted"):
            def drive():
                svc = SimulationService(procs=2, warm_start=str(warm_dir),
                                        max_wait_s=600.0)
                t0 = time.perf_counter()
                svc.start()                    # spawn, warm, ready
                ready_s = time.perf_counter() - t0
                try:
                    first, first_lat, _, _ = served(svc, proc_reqs[:1])
                    rest, lat, wall, _ = served(svc, proc_reqs[1:])
                finally:
                    stragglers = svc.stop(timeout=120)
                return (first + rest, first_lat[0], lat, ready_s, wall,
                        svc.stats(), stragglers)
            out, total_s, got = run_path(f"service_proc {label}", drive, {})
            results, first_s, lat, ready_s, wall, st, stragglers = out
            check(not stragglers, f"service_proc: {stragglers} outlived "
                  "stop()")
            check(same_results(results, want[:SERVICE_PROC_WARPS]),
                  f"service_proc {label}: results differ from [service]'s")
            shard_k1 = sum(dict(sh.launches).get("hanoi_run", 0)
                           for sh in st.shards)
            shard_k2 = sum(dict(sh.launches).get("sm_schedule", 0)
                           for sh in st.shards)
            check(shard_k1 == st.native_batches + st.warm_signatures
                  and shard_k2 == 0,
                  f"service_proc {label}: the shards launched K1 {shard_k1} "
                  f"and K2 {shard_k2} times for {st.native_batches} "
                  f"batches and {st.warm_signatures} warmed signatures")
            launches["hanoi_run"][f"service_proc {label} (shards)"] = \
                shard_k1
            if label == "cold":
                check(st.cache_misses >= 1, "service_proc cold: no miss")
            else:
                check(st.warm_signatures >= 1 and st.warm_loaded >= 1
                      and st.cache_misses == st.warm_retraced == 0,
                      f"service_proc restarted: {st.warm_signatures} "
                      f"signatures, {st.warm_loaded} loaded, "
                      f"{st.warm_retraced} missed at warm time, "
                      f"{st.cache_misses} serve-time misses")
            numbers["service_proc"][label] = {
                "warps": len(results), "start_s": ready_s,
                "first_ticket_s": first_s, "serve_s": wall,
                "warps_per_s": (len(results) - 1) / wall,
                "latency_p50_s": nearest_rank(lat, 0.50),
                "latency_p99_s": nearest_rank(lat, 0.99),
                "k1_launches_in_shards": shard_k1,
                "native_batches": st.native_batches,
                "cache_hits": st.cache_hits,
                "cache_misses": st.cache_misses,
                "cache_disk_hits": st.cache_disk_hits,
                "cache_trace_time_s": st.cache_trace_time_s,
                "warm_signatures": st.warm_signatures,
                "warm_loaded": st.warm_loaded,
                "warm_retraced": st.warm_retraced,
                "shards": [{"shard": sh.shard, "pid": sh.pid,
                            "completed": sh.completed,
                            "cache_hits": sh.cache_hits,
                            "cache_misses": sh.cache_misses,
                            "cache_disk_hits": sh.cache_disk_hits,
                            "launches": dict(sh.launches)}
                           for sh in st.shards]}
            phase("service_proc", run=label, launches_parent=got,
                  **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                     for k, v in numbers["service_proc"][label].items()})
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)
    return numbers


def k1k2_times(src: Path) -> int:
    """K1's ms at the simulator phase's shape and K2's at grids (a) and
    (b), and the host walls of those three paths, with the package under
    ``src``; one JSON line."""
    if ROOT not in (src, *src.parents):
        print(f"chip_smoke: --src {src} is not inside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core import programs
    from repro_torch.core.isa import MachineConfig
    from repro_torch.engine import SimRequest, Simulator
    from repro_torch.engine.mechanisms import sm_torch
    from repro_torch.kernels import ops

    sim_cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    reqs = sim_requests(SimRequest, programs, sim_cfg, SIM_WARPS)
    _, ins = hanoi_operands(reqs, sim_cfg)
    k1_ms, k1_short_ms = k1_times(ops, ins, sim_cfg,
                                  sim_cfg._replace(max_steps=4096))
    del ins
    # grid (a) as run_batch forms it from 1,056 requests of 8 warps each
    grids = {"a": ([[r] * SM_WARPS_A for r in reqs[:SM_CELLS_A]],
                   "greedy_then_oldest"),
             "b": (grid_b_cells(reqs), "round_robin")}
    k2 = {g: grid_kernel_times(ops, sm_torch, sm_torch.grid_of(
        cells, policy=policy, inner_label="hanoi_torch"))[1]
        for g, (cells, policy) in grids.items()}
    # the main paths' host walls, as the simulator and sm phases drive them
    sim = Simulator()
    sm_meta = {"sm_warps": SM_WARPS_A, "sm_policy": "greedy_then_oldest",
               "sm_inner": "hanoi_torch"}
    sm_reqs = [dataclasses.replace(r, meta=sm_meta)
               for r in reqs[:SM_CELLS_A]]
    paths = {"run_batch": lambda: sim.run_batch(reqs),
             "sm_a": lambda: sim.run_batch(sm_reqs, mechanism="sm_torch"),
             "sm_b": lambda: sm_torch.run_cells(grids["b"][0],
                                                policy="round_robin")}
    walls = {}
    for name, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[f"{name}_wall_s"] = time.perf_counter() - t0
    print(json.dumps({"src": str(src), "k1_ms": k1_ms,
                      "k1_ms_fuel_4096": k1_short_ms, "k2_ms": k2["a"],
                      "k2_ms_grid_b": k2["b"], **walls}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 1
    if "--k1k2-times" in sys.argv:
        at = sys.argv.index("--src") + 1 if "--src" in sys.argv else 0
        return k1k2_times(Path(sys.argv[at]).resolve() if at
                          else ROOT / "src")
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.analysis import (analyze_program, strip_annotations,
                                      synthesize_annotations)
    from repro_torch.archive import ArchiveIndex, ArchiveReader, Replayer
    from repro_torch.configs import get_config
    from repro_torch.core import hanoi as hanoi_core
    from repro_torch.core import interp, programs
    from repro_torch.core.isa import MachineConfig, Op
    from repro_torch.engine import SimRequest, Simulator, as_request
    from repro_torch.engine import RotatingJsonlSink, get_mechanism
    from repro_torch.core.trace import nearest_rank
    from repro_torch.service import SimulationService
    from repro_torch.service.planner import plan_dispatch
    from repro_torch.engine.adapters import _batch_arrays, state_results
    from repro_torch.engine.mechanisms import sm_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import hanoi_step as hs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import sm_sched
    from repro_torch.launch.steps import prefill, prefill_config
    from repro_torch.timing import CycleConfig
    from repro_torch.models import Transformer, init_params, model_struct
    from repro_torch.models import layers as layers_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import recurrent
    from repro_torch.models import transformer as tm
    from repro_torch.models.base import Params, tree_map
    from repro_torch.models.layers import embed, rmsnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    clock = SectionClock()
    counters = {"flash_attention": ops.flash_attention,
                "rglru_scan": ops.rglru_scan, "rwkv6_scan": ops.rwkv6_scan,
                "hanoi_run": ops.hanoi_run, "sm_schedule": ops.sm_schedule}
    launches = {name: {} for name in counters}     # kernel -> path -> count

    def run_path(path: str, fn, expect):
        """Drive one main path with every launch count set to 0 just before
        it; read the counts just after and hold them to ``expect`` (a dict,
        or a function of fn's result returning one, for a path whose launch
        count the run decides: a service's native batches).  Returns (fn's
        result, wall seconds, the counts)."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: c.launches for name, c in counters.items()}
        if callable(expect):
            expect = expect(out)
        for name, n in got.items():
            if n:
                launches[name][path] = n
            check(n == expect.get(name, 0),
                  f"{path} launched {name} {n} times, expected "
                  f"{expect.get(name, 0)}")
        return out, wall, got

    clock.start("1")
    # 1. device ------------------------------------------------------------
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    phase("device", kind=repr(kind), count=count, torch=torch.__version__,
          cuda=torch.version.cuda)
    print(smi, flush=True)

    clock.start("2")
    # 2. build: one nvcc per kernel, all started together --------------------
    t0 = time.perf_counter()
    logs = _build.build()
    phase("build", kernels=",".join(logs),
          seconds=f"{time.perf_counter() - t0:.1f}")
    ptxas = {name: ptxas_report(log) for name, log in logs.items()}
    for name in ("rglru_scan", "rwkv6_scan", "hanoi_step", "sm_sched"):
        phase("ptxas", kernel=name, report=json.dumps(ptxas[name]))
        check(bool(ptxas[name]) and all("registers" in v and "spill_stores"
                                        in v for v in ptxas[name].values()),
              f"{name}: no ptxas registers and spills in its build log")
    entry = ""
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line:
                entry = line.split("'")[1]
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
            # no tensor-core (bf16) instantiation of K3 may spill
            if "tc_kernel" in entry and "spill" in line:
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{entry} spills: {line.strip()}")
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    n_mma = {op: sum(f" {op}." in ln for ln in sass.splitlines())
             for op in ("HMMA", "HGMMA")}
    phase("sass", kernel="flash_attention", **n_mma)
    check(n_mma["HMMA"] + n_mma["HGMMA"] > 0,
          "the flash-attention library has no tensor-core instruction")

    clock.start("3")
    # 3. kernel check: each kernel vs its plain twin on the same inputs -----
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def qkv(B, S, H, K, hd, dtype):
        return tuple(randn(B, S, n, hd, dtype=dtype) for n in (H, K, K))

    def rglru_inputs(B, S, W):
        a = torch.rand((B, S, W), generator=gen, device=dev) * 0.499 + 0.5
        return a, randn(B, S, W)

    def rwkv_inputs(B, S, H, hd):
        r, k, v = (randn(B, S, H, hd) for _ in range(3))
        # the model's decay form: w = exp(-exp(z)), z clipped to [-8, 4]
        w = torch.exp(-torch.exp(randn(B, S, H, hd).clamp(-8.0, 4.0)))
        return r, k, v, w, randn(H, hd) * 0.1

    lcfg, gcfg, rcfg = (get_config(a) for a in
                        ("llama3.2-1b", "recurrentgemma-2b", "rwkv6-3b"))
    B, S = PREFILL_B, PREFILL_S
    llama_attn = (lcfg.n_heads, lcfg.n_kv_heads, lcfg.hd)
    llama_tp2_attn = (lcfg.n_heads // 2, lcfg.n_kv_heads // 2, lcfg.hd)
    rgemma_attn = (gcfg.n_heads, gcfg.n_kv_heads, gcfg.hd)
    # hd 128 with GQA 4:1 (llama3-8b's 32/8 heads: no config of the repo
    # has it), and gemma3-4b's layers (d 2560 over 8 heads is hd 320, 4 kv
    # heads; window 1024 on its local layers, none on its global ones)
    hd128_attn = (32, 8, 128)
    g3cfg = get_config("gemma3-4b")
    gemma3_attn, gemma3_window = ((g3cfg.n_heads, g3cfg.n_kv_heads,
                                   g3cfg.hd), g3cfg.window_size)
    # hd 128 at GQA 6:1, 3:1 and 2:1: internlm2-20b, minitron-4b and
    # internvl2-2b
    gqa_attn = {arch: (c.n_heads, c.n_kv_heads, c.hd) for arch, c in (
        (a, get_config(a)) for a in ("internlm2-20b", "minitron-4b",
                                     "internvl2-2b"))}
    # the MoE models' attention at hd 128: deepseek-moe-16b's full
    # multi-head (16 heads, 16 kv heads) and mixtral-8x7b's GQA 4:1 with a
    # 4096-token window at 8192 tokens
    dcfg, mcfg = get_config("deepseek-moe-16b"), get_config("mixtral-8x7b")
    mha_attn = (dcfg.n_heads, dcfg.n_kv_heads, dcfg.hd)
    swa_attn, swa_window = ((mcfg.n_heads, mcfg.n_kv_heads, mcfg.hd),
                            mcfg.window_size)
    rwkv_heads = (rcfg.d_model // rcfg.rwkv_head_dim, rcfg.rwkv_head_dim)
    errs = {}
    attn_cases = [
        ("llama_causal_f32", B, S, *llama_attn, True, 0, torch.float32),
        ("llama_causal_bf16", B, S, *llama_attn, True, 0, torch.bfloat16),
        # a rank's heads in [dist_prefill]: llama3.2-1b at model 2
        ("llama_tp2_bf16", B, S, *llama_tp2_attn, True, 0, torch.bfloat16),
        ("window_s/8", 2, S // 2, *llama_attn, True, S // 8, torch.bfloat16),
        ("non_causal", 2, S // 4, *llama_attn, False, 0, torch.float32),
        ("ragged", 2, RAGGED_S, *llama_attn, True, 0, torch.float32),
        ("rgemma_bf16", B, S, *rgemma_attn, True, gcfg.window_size,
         torch.bfloat16),
        ("rgemma_ragged_f32", 1, RAGGED_S, *rgemma_attn, True,
         RAGGED_S * 3 // 10, torch.float32),
        ("hd128_bf16", B, S, *hd128_attn, True, 0, torch.bfloat16),
        ("hd128_ragged_f32", 1, RAGGED_S, *hd128_attn, True, 0,
         torch.float32),
        ("gemma3_local_bf16", B, S, *gemma3_attn, True, gemma3_window,
         torch.bfloat16),
        ("gemma3_global_bf16", B, S, *gemma3_attn, True, 0, torch.bfloat16),
        ("gemma3_global_ragged_bf16", 2, RAGGED_S, *gemma3_attn, True, 0,
         torch.bfloat16),
        ("gemma3_local_ragged_f32", 1, RAGGED_S, *gemma3_attn, True,
         RAGGED_S * 3 // 10, torch.float32),
        ("deepseek_mha_bf16", B, S, *mha_attn, True, 0, torch.bfloat16),
        ("deepseek_mha_ragged_f32", 1, RAGGED_S, *mha_attn, True, 0,
         torch.float32),
        ("mixtral_swa_bf16", 1, MIXTRAL_S, *swa_attn, True, swa_window,
         torch.bfloat16),
        ("mixtral_swa_ragged_f32", 1, RAGGED_S + 2 * 2048 + 500, *swa_attn,
         True, swa_window, torch.float32),
        *((f"{arch}_bf16", B, S, *attn, True, 0, torch.bfloat16)
          for arch, attn in gqa_attn.items()),
        ("internlm2-20b_ragged_f32", 1, RAGGED_S, *gqa_attn["internlm2-20b"],
         True, 0, torch.float32),
    ]
    for name, B, S, H, K, hd, causal, window, dtype in attn_cases:
        q, k, v = qkv(B, S, H, K, hd, dtype)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        bq, bk = fa.tiles(S, S, hd, dtype=dtype)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, bq=bq, bk=bk)
        torch.cuda.synchronize()
        err = errs[name] = max_err(got, want)
        tol = TOLERANCE[dtype]
        phase("kernel_check", kernel="flash_attention", case=name,
              shape=f"B{B}xS{S}xH{H}xK{K}xhd{hd}", dtype=str(dtype)[6:],
              causal=causal, window=window, tiles=f"{bq}x{bk}",
              max_abs_err=f"{err:.3e}", tol=tol)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
        del q, k, v, got, want

    # K3 on a rank's own query rows [a, b) of S at q_offset a, over every
    # key: recurrentgemma-2b's local layer as rank 1 of 4 sees it
    # ([dist_recurrent]), hd 64 GQA off the q tile, and the CUDA-core
    # kernel (f32) off the tile with a window; against the twin at the
    # offset and the whole-row kernel's rows
    for name, B, S, (a, b), H, K, hd, window, dtype in OFFSET_CASES:
        q, k, v = qkv(B, S, H, K, hd, dtype)
        qr = q[:, a:b].contiguous()
        got = ops.flash_attention(qr, k, v, causal=True, window=window,
                                  q_offset=a)
        bq, bk = fa.tiles(b - a, S, hd, dtype=dtype)
        want = fa.flash_attention_plain(qr, k, v, causal=True,
                                        window=window, bq=bq, bk=bk,
                                        q_offset=a)
        rows = ops.flash_attention(q, k, v, causal=True,
                                   window=window)[:, a:b]
        torch.cuda.synchronize()
        err = errs[name] = max_err(got, want)
        tol = TOLERANCE[dtype]
        phase("kernel_check", kernel="flash_attention", case=name,
              shape=f"B{B}xS{S}xH{H}xK{K}xhd{hd}", rows=f"[{a}, {b})",
              q_offset=a, dtype=str(dtype)[6:], causal=True, window=window,
              tiles=f"{bq}x{bk}", max_abs_err=f"{err:.3e}",
              whole_rows_max_abs_err=f"{max_err(got, rows):.3e}", tol=tol)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= tol and max_err(got, rows) <= tol,
              f"{name}: max abs err {err} (whole rows "
              f"{max_err(got, rows)}) > {tol}")
        del q, k, v, qr, got, want, rows

    # K4 and K5 split time into segments; each twin walks the kernel's
    # segments, so K4's h and K5's s_last must be bit-equal to it.  The
    # long cases have many more segments than the card holds at once: the
    # ticketed carry chain must make progress, and a second launch must
    # give the same bits.
    bits = {}
    for name, (B, S, W) in [
            ("rglru_prefill", (PREFILL_B, PREFILL_S, gcfg.lru_width)),
            ("rglru_ragged", (PREFILL_B, RAGGED_S, gcfg.lru_width - 60)),
            ("rglru_long", (PREFILL_B, LONG_S, gcfg.lru_width))]:
        a, b = rglru_inputs(B, S, W)
        got = ops.rglru_scan(a, b, seg=rg.DEFAULT_SEG)
        want = rg.rglru_scan_plain(a, b, seg=rg.DEFAULT_SEG)
        again = ops.rglru_scan(a, b, seg=rg.DEFAULT_SEG)
        torch.cuda.synchronize()
        err = errs[name] = max_err(got, want)
        bits[name] = {"bit_equal": bool(torch.equal(got, want)),
                      "repeat_bit_equal": bool(torch.equal(got, again))}
        phase("kernel_check", kernel="rglru_scan", case=name,
              shape=f"B{B}xS{S}xW{W}", dtype="float32", seg=rg.DEFAULT_SEG,
              max_abs_err=f"{err:.3e}", tol=RGLRU_TOL, **bits[name])
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= RGLRU_TOL, f"{name}: max abs err {err} > {RGLRU_TOL}")
        check(all(bits[name].values()), f"{name}: h not bit-equal {bits}")
        del a, b, got, want, again

    for name, (B, S, H, hd) in [
            ("rwkv_prefill", (PREFILL_B, PREFILL_S, *rwkv_heads)),
            ("rwkv_ragged", (PREFILL_B, RAGGED_S, *rwkv_heads)),
            ("rwkv_long", (PREFILL_B, LONG_S, *rwkv_heads))]:
        ins = rwkv_inputs(B, S, H, hd)
        out, s_last = ops.rwkv6_scan(*ins, seg=rw.DEFAULT_SEG)
        want, s_want = rw.rwkv6_scan_plain(*ins, seg=rw.DEFAULT_SEG)
        out2, s_last2 = ops.rwkv6_scan(*ins, seg=rw.DEFAULT_SEG)
        torch.cuda.synchronize()
        out_err, s_err = max_err(out, want), max_err(s_last, s_want)
        err = errs[name] = max(out_err, s_err)
        bits[name] = {"bit_equal": bool(torch.equal(s_last, s_want)),
                      "repeat_bit_equal": bool(torch.equal(out, out2)
                                               and torch.equal(s_last,
                                                               s_last2))}
        phase("kernel_check", kernel="rwkv6_scan", case=name,
              shape=f"B{B}xS{S}xH{H}xhd{hd}", dtype="float32",
              seg=rw.DEFAULT_SEG, out_max_abs_err=f"{out_err:.3e}",
              s_last_max_abs_err=f"{s_err:.3e}",
              out_max_abs=f"{want.abs().max().item():.3e}", tol=RWKV_TOL,
              **bits[name])
        check(bool(torch.isfinite(out).all() and torch.isfinite(s_last).all()),
              f"{name}: non-finite output")
        check(err <= RWKV_TOL, f"{name}: max abs err {err} > {RWKV_TOL}")
        check(all(bits[name].values()),
              f"{name}: s_last not bit-equal {bits}")
        del ins, out, s_last, want, s_want, out2, s_last2
    torch.cuda.empty_cache()

    # K1 against its twin on the same operands, bit for bit in every field
    # of the state: the figures, the spinlock and the suite (also with every
    # BSYNC an oracle skip), at 4, 8 and 32 threads; 8 Bx registers with
    # majority-first, 2 without.  Two launches must give the same bits.
    def state_diff(a, b):
        """The fields in which two states differ, and the largest
        difference there."""
        bad, err = [], 0
        for k in hanoi_core.HanoiState._fields:
            x, y = getattr(a, k), getattr(b, k)
            if not torch.equal(x, y):
                bad.append(k)
                err = max(err, (x.long() - y.long()).abs().max().item())
        return bad, err

    k1_checks = {}
    for W in (4, 8, 32):
        for n_bx, majority in ((8, True), (2, False)):
            cfg = MachineConfig(n_threads=W, n_bx=n_bx, max_steps=4096)
            reqs, skip_pcs = [], []
            for prog in (programs.fig5_program(), programs.fig6_program(),
                         programs.warpsync_program(W),
                         programs.spinlock_program()):
                reqs.append(SimRequest(program=prog, cfg=cfg))
                skip_pcs.append(())
            for b in programs.make_suite(cfg):
                bsyncs = np.flatnonzero(b.program[:, 0] == 4).tolist()
                for pcs in (b.skip_bsync_pcs, bsyncs):   # and every BSYNC
                    reqs.append(SimRequest(program=b.program, cfg=cfg,
                                           init_mem=b.init_mem))
                    skip_pcs.append(pcs)
            _, ins = hanoi_operands(reqs, cfg, skip_pcs)
            got = ops.hanoi_run(*ins, cfg, majority_first=majority)
            again = ops.hanoi_run(*ins, cfg, majority_first=majority)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = hanoi_core.hanoi_run_plain(*ins, cfg,
                                              majority_first=majority)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            bad, err = state_diff(got, want)
            repeat_bad, _ = state_diff(got, again)
            case = f"w{W}_bx{n_bx}_{'majority' if majority else 'minority'}"
            k1_checks[case] = {"bit_equal": not bad,
                               "repeat_bit_equal": not repeat_bad,
                               "max_abs_err": err}
            phase("kernel_check", kernel="hanoi_step", case=case,
                  warps=len(reqs), longest_warp_slots=int(
                      (cfg.max_steps - want.fuel).max()),
                  twin_s=f"{twin_s:.2f}", differing_fields=bad,
                  **k1_checks[case])
            check(not bad, f"K1 {case}: {bad} differ from the twin")
            check(not repeat_bad, f"K1 {case}: a second launch differs "
                  f"in {repeat_bad}")
            del ins, got, again, want
    torch.cuda.empty_cache()

    # K1 at the shapes that take its other layouts (hanoi_step.layout):
    # 16,384 words (2 warps a CTA), a 2,048-row program, 512 registers, 40
    # predicates, and the memory image, then also the program and the
    # registers, in global memory.  The figures and 12 suite programs, and
    # programs that write the highest registers and predicates and walk
    # every row of the program.
    from repro_torch.core.asm import assemble

    def wide_programs(cfg, L):
        r = min(cfg.n_regs, 512) - 1
        progs = [assemble(f"LANEID R1\nIADDI R{r}, R1, 5\n"
                          f"IADDI R{r - 1}, R{r}, 7\n"
                          f"STG [R1+3], R{r - 1}\nEXIT")]
        if cfg.n_preds > 32:
            progs.append(assemble(
                "LANEID R1\nISETP.GE P35, R1, 9\nISETP.LT P39, R1, 20\n"
                "@P35 IADDI R2, R1, 7\n@!P39 IADDI R3, R1, 9\n"
                "BSSY B0, join\n@P35 BRA right\nIADDI R4, R1, 1\n"
                "BRA join\nright:\nIADDI R4, R1, 2\njoin:\nBSYNC B0\n"
                "ISETP.EQ P33, R4, 11\n@P33 MOV R5, 11\nEXIT"))
        if L > 32:
            line = np.zeros((L, 8), np.int32)
            line[:, :3], line[:, 5] = (int(Op.IADDI), 2, 2), 1
            line[-1] = 0
            line[-1, 0] = int(Op.EXIT)
            progs.append(line)
        return progs

    base = MachineConfig(n_threads=32, mem_size=256, max_steps=512)
    k1_layouts = {}
    for case, cfg, L in (
            ("mem_size_16384", base._replace(mem_size=16_384), 32),
            ("program_2048_rows", base, 2048),
            ("n_regs_512", base._replace(n_regs=512), 32),
            ("n_preds_40", base._replace(n_preds=40), 32),
            ("global_memory", base._replace(mem_size=65_536), 32),
            ("global_program_and_registers",
             base._replace(mem_size=65_536, n_regs=2048), 8192)):
        reqs = [SimRequest(program=p, cfg=cfg) for p in (
            programs.fig5_program(), programs.fig6_program(),
            *wide_programs(cfg, L))]
        reqs += [SimRequest(program=b.program, cfg=cfg, init_mem=b.init_mem)
                 for b in programs.make_suite(cfg)[:12]]
        arrays = _batch_arrays(reqs, cfg, L)
        ins = [torch.from_numpy(a).to(dev) for a in arrays]
        lay = hs.layout(cfg, L)
        got = ops.hanoi_run(*ins, cfg)
        want = hanoi_core.hanoi_run_plain(*ins, cfg)
        torch.cuda.synchronize()
        bad, err = state_diff(got, want)
        k1_layouts[case] = {"layout": lay._asdict(), "bit_equal": not bad,
                            "max_abs_err": err}
        phase("kernel_check", kernel="hanoi_step", case=case, warps=len(reqs),
              rows=L, layout=json.dumps(lay._asdict()),
              longest_warp_slots=int((cfg.max_steps - want.fuel).max()),
              differing_fields=bad, bit_equal=not bad)
        check(not bad, f"K1 {case}: {bad} differ from the twin")
        del ins, got, want
    torch.cuda.empty_cache()

    # K2 against its twin on K1's traces, bit for bit in every output (the
    # fill past each cell's total included), and a second launch alike:
    # cells of 1, 8, 32 (one hardware warp a cell) and 64 warps (a CTA a
    # cell), drawn from 46 rows (the suite on two memories each, 512 slots
    # of fuel: the twin's host loop takes a slot of the longest cell at a
    # time), every policy with the default latencies and
    # greedy-then-oldest with ALU 4 and memory 100.
    k2_cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=512)
    k2_suite = programs.make_suite(k2_cfg)
    k2_reqs = [SimRequest(program=b.program, cfg=k2_cfg,
                          init_mem=None if b.init_mem is None
                          else programs._mem(k2_cfg, SEED + 7 * i + k))
               for k in range(2) for i, b in enumerate(k2_suite)]
    _, k2_ins = hanoi_operands(k2_reqs, k2_cfg)
    k2_state = ops.hanoi_run(*k2_ins, k2_cfg)
    k2_code = k2_ins[0][:, :, 0].contiguous()
    rng = np.random.default_rng(SEED)
    k2_checks = {}
    latencies = {"default": sm_torch._latency_tables(
        CycleConfig(scoreboard=False)),
        "alu4_mem100": sm_torch._latency_tables(CycleConfig(
            scoreboard=False, alu_latency=4, memory_latency=100))}
    for n_warps in (1, 8, 32, 64):
        warp_map = torch.from_numpy(rng.integers(
            0, len(k2_reqs), (24, n_warps)).astype(np.int32)).to(dev)
        trace_n = k2_state.trace_n[warp_map.long()]
        out_cap = sm_torch._out_capacity(int(trace_n.sum(1).max()))
        for policy, lat_name in [(p, "default") for p in
                                 ("greedy_then_oldest", "round_robin",
                                  "oldest_first")] + [
                ("greedy_then_oldest", "alu4_mem100")]:
            args = (warp_map, trace_n, k2_code, k2_state.trace_pc,
                    k2_state.trace_mask, *latencies[lat_name])
            got = ops.sm_schedule(*args, out_cap=out_cap, policy=policy)
            again = ops.sm_schedule(*args, out_cap=out_cap, policy=policy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = sm_sched.sm_schedule_plain(*args, out_cap=out_cap,
                                              policy=policy)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            bad = [k for k in want._fields
                   if not torch.equal(getattr(got, k), getattr(want, k))]
            repeat_bad = [k for k in want._fields if not torch.equal(
                getattr(got, k), getattr(again, k))]
            err = max(max_err(getattr(got, k), getattr(want, k))
                      for k in want._fields)
            case = f"w{n_warps}_{policy}_{lat_name}"
            k2_checks[case] = {"bit_equal": not bad,
                               "repeat_bit_equal": not repeat_bad,
                               "max_abs_err": err}
            phase("kernel_check", kernel="sm_sched", case=case, cells=24,
                  out_cap=out_cap, longest_cell_slots=int(got.issued.max()),
                  twin_s=f"{twin_s:.2f}", differing_outputs=bad,
                  **k2_checks[case])
            check(not bad, f"K2 {case}: {bad} differ from the twin")
            check(not repeat_bad, f"K2 {case}: a second launch differs in "
                  f"{repeat_bad}")
            del got, again, want
    del k2_ins, k2_state, k2_code
    torch.cuda.empty_cache()

    clock.start("4")
    # 4. full-width bf16 prefills: the main paths through K3, K4 and K5 -----
    tokens = torch.randint(0, 65536, (PREFILL_B, PREFILL_S), generator=gen,
                           device=dev)

    def last_logits(model, cfg, batch):
        logits, _ = prefill(model, cfg, batch)
        return logits[:, -1].float()

    def prefill_phase(arch, cfg, other_cfg, expect, check_dtype,
                      toks=None, batch=None, params=None, layerwise=False,
                      **fields):
        """Warm up, drive the bf16 prefill of ``batch`` (default: the
        tokens ``toks``, default 4 x 2048) as a main path, and hold the
        last-position logits of ``cfg``'s prefill against ``other_cfg``'s
        on the same weights, in ``check_dtype`` (``other_cfg`` None: no
        hold); with ``layerwise``, hold each layer's attention instead
        (:func:`layerwise_hold`).  ``params`` defaults to bf16 weights
        drawn here.  Returns the model and the main path's caches."""
        if batch is None:
            toks = tokens if toks is None else toks
            batch = {"tokens": toks % cfg.vocab_size}
        if params is None:
            params = init_params(model_struct(cfg), gen,
                                 dtype=torch.bfloat16, device=dev)
        model = Transformer(cfg, params)
        # positions: the frames, or the patches and then the tokens
        n_batch = next(iter(batch.values())).shape[0]
        n_pos = sum(batch[k].shape[1] for k in ("frames", "patches",
                                                "tokens") if k in batch)
        # warm-up: cuBLAS plans, allocator
        warm_last = prefill(model, cfg, batch)[0][:, -1].float()
        torch.cuda.reset_peak_memory_stats()
        (logits, caches), wall, got = run_path(
            f"{arch} prefill", lambda: prefill(model, cfg, batch), expect)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(logits.shape == (n_batch, n_pos, cfg.vocab_size),
              f"{arch} prefill logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits[:, -1]).all()),
              f"{arch}: logits not finite")
        last = logits[:, -1].float()
        fields.update(tokens=f"{n_batch}x{n_pos}", launches=got,
                      wall_s=f"{wall:.4f}",
                      tok_per_s=f"{n_batch * n_pos / wall:.1f}",
                      peak_gb=f"{peak_gb:.2f}",
                      activations=str(logits.dtype)[6:])
        del logits
        if other_cfg is None:
            phase("prefill", arch=arch, params="bf16", **fields,
                  check="none (no K3 launch: no second path to hold)",
                  rerun_last_logits_max_abs_err=
                  f"{max_err(last, warm_last):.3e}")
            return model, caches
        if layerwise:
            h = layerwise_hold(model, cfg, other_cfg, batch, L=layers_mod,
                               tm=tm, moe_mod=moe_mod)
            rtol = PREFILL_LOGITS_RTOL[torch.bfloat16]
            worst = max(range(len(h["attn_rel"])),
                        key=h["attn_rel"].__getitem__)
            phase("prefill", arch=arch, params="bf16", **fields,
                  check="layerwise bf16",
                  attn_max_rel_err=f"{h['attn_rel'][worst]:.3e}",
                  attn_worst_layer=worst, rtol=rtol,
                  expert_set_flips={i: f"{f:.4f}" for i, f in
                                    h["flips"].items()},
                  e2e_last_logits_max_abs_err=f"{h['e2e_err']:.3e}",
                  e2e_ref_logits_max_abs=f"{h['e2e_max']:.3e}",
                  rerun_last_logits_max_abs_err=
                  f"{max_err(last, warm_last):.3e}")
            check(h["attn_rel"][worst] <= rtol,
                  f"{arch} prefill: layer {worst}'s attention differs from "
                  f"the reference by {h['attn_rel'][worst]} of its largest")
            return model, caches
        check_model = model
        if check_dtype != torch.bfloat16:
            check_model = Transformer(cfg, tree_map(
                lambda t: t.to(check_dtype), params))
            last = last_logits(check_model, cfg, batch)
        ref_last = last_logits(check_model, other_cfg, batch)
        del check_model
        err, ref_max = max_err(last, ref_last), ref_last.abs().max().item()
        rtol = PREFILL_LOGITS_RTOL[check_dtype]
        phase("prefill", arch=arch, params="bf16", **fields,
              check_dtype=str(check_dtype)[6:],
              last_logits_max_abs_err=f"{err:.3e}",
              ref_logits_max_abs=f"{ref_max:.3e}", rtol=rtol)
        check(err <= rtol * ref_max,
              f"{arch} prefill: last logits differ by {err} "
              f"(largest {ref_max})")
        return model, caches

    def layer_phase(arch, model, cfg, layer_fn, sub, kernel):
        """Layer 0's temporal mix at 4 x 2048 in f32 with use_kernel=True,
        as a main path, against its plain branch on the same weights."""
        lp = getattr(model.segments[0][0], "0")
        params = Params({n: t.float()
                         for n, t in getattr(lp, sub).named_parameters()})
        with torch.inference_mode():
            x = rmsnorm(lp.ln1, embed(model.embed, tokens % cfg.vocab_size,
                                      cfg).float(), cfg.norm_eps)
            (out, state), wall, got = run_path(
                f"{arch} layer 0", lambda: layer_fn(params, x, cfg=cfg,
                                                    use_kernel=True),
                {kernel: 1})
            want, want_state = layer_fn(params, x, cfg=cfg,
                                        use_kernel=False)
        state_errs = {n: max_err(state[n], want_state[n]) for n in want_state}
        out_err = max_err(out, want)
        phase("layer", arch=arch, layer=f"0.{sub}", dtype="float32",
              shape=tuple(x.shape), launches=got, wall_s=f"{wall:.4f}",
              out_max_abs_err=f"{out_err:.3e}",
              out_max_abs=f"{want.abs().max().item():.3e}",
              state_max_abs_err={n: f"{e:.3e}" for n, e in
                                 state_errs.items()}, tol=LAYER_TOL)
        check(bool(torch.isfinite(out).all()), f"{arch} layer: not finite")
        check(max(out_err, *state_errs.values()) <= LAYER_TOL,
              f"{arch} layer 0 with use_kernel=True differs from the plain "
              f"branch: out {out_err}, state {state_errs}")

    cfg = prefill_config("llama3.2-1b", attn_impl="flash")
    model, caches = prefill_phase("llama3.2-1b", cfg,
                                  cfg.replace(attn_impl="reference"),
                                  {"flash_attention": cfg.n_layers},
                                  torch.bfloat16)
    check(caches[0]["0"]["k"].shape == (cfg.n_layers, PREFILL_B, PREFILL_S,
                                        cfg.n_kv_heads, cfg.hd),
          "llama prefill cache shape")
    del model, caches
    torch.cuda.empty_cache()

    cfg = prefill_config("recurrentgemma-2b", attn_impl="flash")
    n_local = cfg.kinds.count("local")
    model, caches = prefill_phase("recurrentgemma-2b", cfg,
                                  cfg.replace(attn_impl="reference"),
                                  {"flash_attention": n_local,
                                   "rglru_scan": cfg.kinds.count("recurrent")},
                                  torch.bfloat16)
    repeat = cfg.layer_plan[0][1]
    check(caches[0]["0"]["h"].shape == (repeat, PREFILL_B, cfg.lru_width)
          and caches[0]["2"]["k"].shape == (repeat, PREFILL_B, PREFILL_S,
                                            cfg.n_kv_heads, cfg.hd),
          "recurrentgemma prefill cache shapes")
    del caches
    layer_phase("recurrentgemma-2b", model, cfg, recurrent.rglru, "rglru",
                "rglru_scan")
    del model
    torch.cuda.empty_cache()

    # The chunked form is exact only while a chunk's summed log-decay stays
    # above its -30 clip; at this init's decays (~e^-1 a step) that holds
    # for 16-token chunks and not for the default 64.
    cfg = prefill_config("rwkv6-3b")
    model, caches = prefill_phase(
        "rwkv6-3b", cfg, cfg.replace(rwkv_impl="chunked", rwkv_chunk=16),
        {"rwkv6_scan": cfg.n_layers}, torch.float32)
    check(caches[0]["0"]["wkv"].shape == (cfg.n_layers, PREFILL_B,
                                          *rwkv_heads, rwkv_heads[1]),
          "rwkv6 prefill cache shape")
    del caches
    layer_phase("rwkv6-3b", model, cfg, recurrent.rwkv6_time_mix, "tm",
                "rwkv6_scan")
    del model
    torch.cuda.empty_cache()

    clock.start("5")
    # 5. serve: full width, f32, greedy decode of 4 requests -----------------
    for arch in ("llama3.2-1b", "recurrentgemma-2b", "rwkv6-3b"):
        serve_phase(arch, run_path, dev)
        torch.cuda.empty_cache()

    clock.start("5a")
    # 5a. MoE serving: deepseek-moe-16b whole and mixtral-8x7b at full width,
    # through K3 at hd 128 (full multi-head; a 4096 window at 8192 tokens) --
    f32_fields = dict(init_params=init_params, model_struct=model_struct,
                      Transformer=Transformer, prefill=prefill)
    arch = "deepseek-moe-16b"
    cfg = prefill_config(arch, attn_impl="flash")
    model, caches = prefill_phase(arch, cfg,
                                  cfg.replace(attn_impl="reference"),
                                  {"flash_attention": cfg.n_layers},
                                  torch.bfloat16, layerwise=True,
                                  layers=f"{cfg.n_layers} of {cfg.n_layers}")
    check(caches[1]["0"]["k"].shape == (cfg.n_layers - cfg.first_dense_layers,
                                        PREFILL_B, PREFILL_S,
                                        cfg.n_kv_heads, cfg.hd),
          "deepseek prefill cache shape")
    del caches
    # [moe]: the first MoE layer (layer 1) at full width, card vs CPU, at
    # the config's capacity factor and at one small enough to drop slots
    for factor in (cfg.capacity_factor, MOE_DROP_FACTOR):
        n = moe_layer_check(
            getattr(model.segments[1][0], "0").ffn,
            cfg.replace(capacity_factor=factor),
            (PREFILL_B, PREFILL_S, cfg.d_model), dev, Params=Params,
            moe_mod=moe_mod)
        phase("moe", arch=arch, layer=1, dtype="float32",
              shape=(PREFILL_B, PREFILL_S, cfg.d_model),
              experts=f"{cfg.n_experts} top {cfg.experts_per_token} + "
                      f"{cfg.n_shared_experts} shared",
              capacity_factor=factor, capacity=n["C"],
              identical=n["same"], dropped=f"{n['dropped']}/{n['slots']}",
              dropped_share=f"{n['dropped'] / n['slots']:.4f}",
              out_max_abs_err=f"{n['out_err']:.3e}",
              out_max_abs=f"{n['out_max']:.3e}", rtol=MOE_RTOL,
              aux_abs_err=f"{n['aux_err']:.3e}", card_s=f"{n['card_s']:.4f}",
              cpu_s=f"{n['cpu_s']:.4f}")
        check(all(n["same"].values()),
              f"deepseek MoE layer: routing or dispatch differs card vs CPU "
              f"{n['same']}")
        check(n["out_err"] <= MOE_RTOL * n["out_max"]
              and n["aux_err"] <= MOE_RTOL,
              f"deepseek MoE layer: card vs CPU out differs by "
              f"{n['out_err']} (largest {n['out_max']}), aux by "
              f"{n['aux_err']}")
    check(n["dropped"] > 0, "the small capacity factor dropped no slot")
    # [serve]: 4 requests on the bf16 weights (an f32 copy and its caches
    # do not fit beside them)
    serve_phase(arch, run_path, dev, model=model)
    del model
    torch.cuda.empty_cache()

    def f32_phase(arch, cfg, toks):
        """The f32 hold of a prefill at the cut depth F32_DEPTH[arch]."""
        cut = cut_depth(cfg, F32_DEPTH[arch])
        r = f32_prefill_check(cut.replace(attn_dtype="f32"),
                              cut.replace(attn_dtype="f32",
                                          attn_impl="reference"),
                              toks, gen, dev, **f32_fields)
        phase("prefill_f32", arch=arch,
              layers=f"{cut.n_layers} of {cfg.n_layers}",
              tokens="{}x{}".format(*toks.shape),
              last_logits_max_abs_err=f"{r['err']:.3e}",
              ref_logits_max_abs=f"{r['ref_max']:.3e}", rtol=r["rtol"])
        check(r["ok"], f"{arch} f32 prefill at {cut.n_layers} layers: last "
              f"logits differ by {r['err']} (largest {r['ref_max']})")
        torch.cuda.empty_cache()

    f32_phase(arch, cfg, tokens)

    arch = "mixtral-8x7b"
    full = prefill_config(arch, attn_impl="flash")
    cfg = cut_depth(full, MIXTRAL_LAYERS)
    mix_tokens = torch.randint(0, 65536, (1, MIXTRAL_S), generator=gen,
                               device=dev)
    model, caches = prefill_phase(arch, cfg,
                                  cfg.replace(attn_impl="reference"),
                                  {"flash_attention": cfg.n_layers},
                                  torch.bfloat16, toks=mix_tokens,
                                  layerwise=True,
                                  layers=f"{cfg.n_layers} of {full.n_layers}",
                                  window=cfg.window_size)
    check(caches[0]["0"]["k"].shape == (cfg.n_layers, 1, MIXTRAL_S,
                                        cfg.n_kv_heads, cfg.hd),
          "mixtral prefill cache shape")
    del model, caches
    torch.cuda.empty_cache()
    f32_phase(arch, full, mix_tokens)

    clock.start("5b")
    # 5b. the other configs: gemma3-4b, minitron-4b, internlm2-20b and the
    # frontend models internvl2-2b and hubert-xlarge, whole ----------------
    config_numbers = config_phases(prefill_phase=prefill_phase,
                                   run_path=run_path, dev=dev, gen=gen)

    clock.start("5c")
    # 5c. the simulator at full size: one launch of K1 through run_batch ----
    sim_cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    suite = programs.make_suite(sim_cfg)
    reqs = sim_requests(SimRequest, programs, sim_cfg, SIM_WARPS)
    sim = Simulator()             # hanoi_torch on the card: the defaults
    check(sim.mechanism == "hanoi_torch", f"Simulator()'s default "
          f"mechanism is {sim.mechanism}")
    warm = sim.run_batch(reqs[:len(suite)])
    results, sim_wall, got = run_path(
        "simulator run_batch", lambda: sim.run_batch(reqs), {"hanoi_run": 1})
    check(all(r.mechanism == "hanoi_torch" for r in results),
          "Simulator().run_batch did not run hanoi_torch")
    check(len(results) == SIM_WARPS, "run_batch lost results")
    L, ins = hanoi_operands(reqs, sim_cfg)
    k1_state = ops.hanoi_run(*ins, sim_cfg)       # the kernel's whole state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = hanoi_core.hanoi_run_plain(*ins, sim_cfg)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    bad, k1_err = state_diff(k1_state, twin)
    check(not bad, f"K1 at full size: {bad} differ from the twin")
    # run_batch's results against the twin, warp by warp
    n = twin.trace_n.long()
    width = int(n.max())
    keep = torch.arange(width, device=dev) < n.unsqueeze(1)
    twin_pcs = twin.trace_pc[:, :width][keep].cpu().numpy()
    twin_masks = twin.trace_mask[:, :width][keep].cpu().numpy() \
        .view(np.uint32)
    host = {k: getattr(twin, k).cpu().numpy() for k in
            ("regs", "preds", "mem", "finished", "steps", "fuel", "error")}
    got_pcs = np.fromiter((pc for r in results for pc, _ in r.trace),
                          np.int64, int(n.sum()))
    got_masks = np.fromiter((m for r in results for _, m in r.trace),
                            np.int64, int(n.sum()))
    check(np.array_equal(got_pcs, twin_pcs)
          and np.array_equal(got_masks, twin_masks)
          and [len(r.trace) for r in results] == n.tolist(),
          "run_batch traces differ from the twin's")
    for f, k in (("regs", "regs"), ("preds", "preds"), ("mem", "mem")):
        check(np.array_equal(np.stack([getattr(r, f) for r in results]),
                             host[k]), f"run_batch {f} differ from the twin")
    check([(r.finished, r.steps, r.fuel_left, r.error is None)
           for r in results]
          == [(int(a), int(b), int(c), int(d) == 0) for a, b, c, d in zip(
              host["finished"], host["steps"], host["fuel"],
              host["error"])], "run_batch counters differ from the twin")
    # one warp of each program against the numpy run_hanoi, timed
    t0 = time.perf_counter()
    refs = [interp.run_hanoi(r.program, sim_cfg, init_mem=r.init_mem)
            for r in reqs[:len(suite)]]
    numpy_s = time.perf_counter() - t0
    for r, ref in zip(results, refs):
        check(r.trace == tuple(ref.trace)
              and np.array_equal(r.regs, ref.regs)
              and np.array_equal(r.preds, ref.preds)
              and np.array_equal(r.mem, ref.mem)
              and (r.finished, r.steps, r.fuel_left)
              == (ref.finished, ref.steps, ref.fuel_left),
              f"{r.mechanism} {reqs[results.index(r)].name} differs from "
              "the numpy run_hanoi")
    slots = (sim_cfg.max_steps - twin.fuel).long()
    numpy_slots = sum(sim_cfg.max_steps - ref.fuel_left for ref in refs)
    # the trace buffers' -1 / 0 fill alone, as PyTorch's fill kernels do it
    fill_ms = cuda_time_ms(lambda: (k1_state.trace_pc.fill_(-1),
                                    k1_state.trace_mask.fill_(0)), 5)
    fill_bytes = 8 * int((sim_cfg.max_steps - twin.trace_n.long()).sum())
    # K1's stepping with a 16th of the fill: the same warps at 4,096 slots
    # of fuel, which every one of them halts within (the same traces)
    short_cfg = sim_cfg._replace(max_steps=4096)
    check(int(slots.max()) < short_cfg.max_steps, "a warp runs past 4096 "
          "slots: the short-fuel run would cut its trace")
    short = ops.hanoi_run(*ins, short_cfg)
    check(torch.equal(short.trace_n, twin.trace_n)
          and torch.equal(short.trace_pc, twin.trace_pc[:, :4096]),
          "K1 at 4096 slots of fuel: traces differ from the full run's")
    del short
    k1_ms, k1_short_ms = k1_times(ops, ins, sim_cfg, short_cfg)
    k1_bytes = hs.run_bytes(k1_state, L)
    t_bytes = k1_bytes / PEAK_BYTES_PER_S * 1e3
    t_slots = int(slots.max()) * SLOT_CYCLES / CLOCK_HZ * 1e3
    k1_bound = (max(t_bytes, t_slots),
                "bytes" if t_bytes >= t_slots else "operations")
    sim_numbers = {
        "warps": SIM_WARPS, "cfg": dict(sim_cfg._asdict()), "L": L,
        "slots": int(slots.sum()), "longest_warp_slots": int(slots.max()),
        "run_batch_wall_s": sim_wall,
        "run_batch_exec_s": sum(r.wall_time_s for r in results),
        "warps_per_s": SIM_WARPS / sim_wall,
        "slots_per_s": int(slots.sum()) / sim_wall,
        "k1_ms": k1_ms, "twin_s": twin_s, "trace_fill_ms": fill_ms,
        "trace_fill_bytes": fill_bytes, "k1_ms_fuel_4096": k1_short_ms,
        "trace_fill_share_of_k1_bytes": fill_bytes / k1_bytes,
        "numpy_run_hanoi_s": numpy_s,
        "numpy_host_slots_per_s": numpy_slots / numpy_s,
        "k1_bytes": k1_bytes, "bound_ms_bytes": t_bytes,
        "bound_ms_slots": t_slots,
        "layout": hs.layout(sim_cfg, L)._asdict()}
    phase("kernel_time", kernel="hanoi_step",
          shape=f"{SIM_WARPS} warps x 32 threads, max_steps 60000",
          ms=f"{k1_ms:.4f}", plain_ms=f"{twin_s * 1e3:.4f}", library_ms=None,
          trace_fill_ms=f"{fill_ms:.4f}", trace_fill_bytes=fill_bytes,
          ms_fuel_4096=f"{k1_short_ms:.4f}",
          bytes=k1_bytes, bound_ms=f"{k1_bound[0]:.4f}",
          bound_by=k1_bound[1], roofline_share=f"{k1_bound[0] / k1_ms:.4f}",
          ptxas=json.dumps(ptxas["hanoi_step"]))
    phase("simulator", mechanism="hanoi_torch", launches=got,
          statuses=dict(collections.Counter(r.status.value for r in results)),
          **{k: (f"{v:.4f}" if isinstance(v, float) else v)
             for k, v in sim_numbers.items()})
    del warm, results, k1_state, twin, ins, host, got_pcs, got_masks
    torch.cuda.empty_cache()

    clock.start("5d")
    # 5d. Fig 9 through compare, on the card ------------------------------------
    groups = len(plan_dispatch(get_mechanism("hanoi_torch"), [
        as_request(b, sim_cfg) for b in suite]))
    same, _, got = run_path(
        "fig9 hanoi_torch vs hanoi",
        lambda: sim.compare(["hanoi_torch", "hanoi"], timing=False),
        {"hanoi_run": groups})
    check(len(same.rows) == 2 * len(suite)
          and all(r.discrepancy == 0.0 for r in same.rows),
          "hanoi_torch and hanoi traces differ")
    oracle, _, got = run_path(
        "fig9 hanoi_torch vs turing_oracle",
        lambda: sim.compare("hanoi_torch", baseline="turing_oracle",
                            timing=False), {"hanoi_run": groups})
    ref = sim.compare("hanoi", baseline="turing_oracle", timing=False)
    rows = oracle.pair("hanoi_torch", "turing_oracle")
    ref_rows = ref.pair("hanoi", "turing_oracle")
    check([(r.program, r.discrepancy) for r in rows]
          == [(r.program, r.discrepancy) for r in ref_rows],
          "hanoi_torch's Fig 9 rows differ from the numpy hanoi's")
    fig9_mean = oracle.mean_discrepancy("hanoi_torch", "turing_oracle")
    phase("fig9", pair="hanoi_torch/turing_oracle", launches=got,
          mean_discrepancy_pct=f"{100 * fig9_mean:.4f}", paper_pct=1.03,
          rows={r.program: f"{100 * r.discrepancy:.4f}" for r in rows},
          hanoi_torch_vs_hanoi_max=max(r.discrepancy for r in same.rows))

    clock.start("5e")
    # 5e. the SM model at full size: sm_torch, one K1 and one K2 launch a
    # grid --------------------------------------------------------------------
    def suite_req(i, **kw):
        """Suite program i mod 23 on memory drawn from SEED + i, as the
        simulator phase draws it."""
        b = suite[i % len(suite)]
        return SimRequest(program=b.program, cfg=sim_cfg, name=b.name,
                          init_mem=None if b.init_mem is None
                          else programs._mem(sim_cfg, SEED + i), **kw)

    def sm_twins(cells, policy):
        """The grid's SmResults from K1's and K2's plain twins on the card,
        with the twins' seconds and K2's trace lengths and slots."""
        grid = sm_torch.grid_of(cells, policy=policy,
                                inner_label="hanoi_torch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = hanoi_core.hanoi_run_plain(*grid.warp_operands, grid.cfg,
                                           majority_first=grid.majority_first)
        torch.cuda.synchronize()
        k1_s = time.perf_counter() - t0
        warp_map, trace_n, out_cap = sm_torch.schedule_operands(grid, state)
        lat, is_mem = sm_torch._latency_tables(grid.ccfg)
        t0 = time.perf_counter()
        sched = sm_sched.sm_schedule_plain(
            warp_map, trace_n, grid.ops, state.trace_pc, state.trace_mask,
            lat, is_mem, out_cap=out_cap, policy=grid.policy)
        torch.cuda.synchronize()
        k2_s = time.perf_counter() - t0
        return grid, sm_torch.assemble(grid, state, sched), (k1_s, k2_s), \
            (trace_n, out_cap)

    def sm_diff(a, b) -> list:
        """The fields in which two SmResults differ (every simulated
        field, each warp's included)."""
        bad = [f for f in ("sm_trace", "steps", "cycles",
                           "thread_instructions", "utilization",
                           "busy_cycles", "issue_stall_cycles",
                           "scoreboard_stall_cycles", "memory_stall_cycles",
                           "status", "policy") if getattr(a, f) != getattr(b, f)]
        if len(a.warps) != len(b.warps):
            return bad + ["warps"]
        for wa, wb in zip(a.warps, b.warps):
            for f in ("trace", "steps", "fuel_left", "finished", "status",
                      "error", "utilization"):
                if getattr(wa, f) != getattr(wb, f):
                    bad.append(f"warp.{f}")
            for f in ("regs", "preds", "mem"):
                if not np.array_equal(getattr(wa, f), getattr(wb, f)):
                    bad.append(f"warp.{f}")
        return sorted(set(bad))

    def segments() -> int:
        """Device memory segments the caching allocator has taken so far
        (one cudaMalloc each)."""
        return torch.cuda.memory_stats()["segment.all.allocated"]

    def sm_runs(path, fn):
        """A grid run twice at its full shape: the first run, its execution
        seconds and the segments it took; then the run that is held and
        timed, through run_path (one K1 and one K2 launch), and its
        segments.  Returns (the second run's results, its wall, its
        launches, the two runs' numbers)."""
        seg = segments()
        exec_first = sum(r.wall_time_s for r in fn())
        seg_first = segments() - seg
        seg = segments()
        out, wall, got = run_path(path, fn, {"hanoi_run": 1,
                                             "sm_schedule": 1})
        return out, wall, got, {"exec_s_first_run": exec_first,
                                "new_segments_first_run": seg_first,
                                "new_segments": segments() - seg}

    def sm_grid_phase(label, sms, wall, got, cells, policy, runs):
        """Hold a grid's SmResults to the twins' and its longest cell to
        sm_interleave, time K1 and K2 on its operands, print its numbers
        with ``runs``, sm_runs' numbers of the two runs."""
        grid, twin_sms, (k1_twin_s, k2_twin_s), (trace_n, out_cap) = \
            sm_twins(cells, policy)
        check(len(sms) == len(cells), f"{label}: lost cells")
        for c, (a, b) in enumerate(zip(sms, twin_sms)):
            bad = sm_diff(a, b)
            check(not bad, f"{label} cell {c}: {bad} differ from the twins'")
        longest = max(range(len(sms)), key=lambda c: sms[c].steps)
        ref = sim.run_sm(list(sms[longest].requests), policy=policy,
                         inner="hanoi_torch", sm_mechanism="sm_interleave")
        bad = sm_diff(sms[longest], ref)
        check(ref.mechanism == "sm_interleave" and not bad,
              f"{label} longest cell: {bad} differ from sm_interleave")
        k1_ms, k2_ms, k2 = grid_kernel_times(ops, sm_torch, grid)
        slots = sum(sm.steps for sm in sms)
        exec_s = sum(sm.wall_time_s for sm in sms)
        numbers = {
            "cells": len(sms), "warps_per_cell": len(cells[0]),
            "policy": grid.policy, "unique_warp_rows": len(grid.first),
            "slots": slots, "longest_cell_slots": sms[longest].steps,
            "out_cap": out_cap, "wall_s": wall, "exec_s": exec_s, **runs,
            "cells_per_s": len(sms) / wall, "slots_per_s": slots / wall,
            "k1_ms": k1_ms, "k2_ms": k2_ms, "k1_twin_s": k1_twin_s,
            "k2_twin_s": k2_twin_s,
            "k2_bytes": sm_sched.schedule_bytes(trace_n, out_cap)}
        phase("sm", grid=label, launches=got,
              statuses=dict(collections.Counter(sm.status.value
                                                for sm in sms)),
              held_to="twins, sm_interleave (longest cell)",
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in numbers.items()})
        return numbers, (k2, trace_n, out_cap, sms[longest])

    sm_meta = {"sm_warps": SM_WARPS_A, "sm_policy": "greedy_then_oldest",
               "sm_inner": "hanoi_torch"}
    sm_reqs = [suite_req(c, meta=sm_meta) for c in range(SM_CELLS_A)]
    res_a, wall_a, got, runs_a = sm_runs(
        "sm run_batch", lambda: sim.run_batch(sm_reqs, mechanism="sm_torch"))
    sms_a = [r.meta["sm"] for r in res_a]
    check(all(r.trace == tuple((pc, m) for _, pc, m in sm.sm_trace)
              for r, sm in zip(res_a, sms_a)),
          "sm_torch's SimResults do not mirror their SM traces")
    sm_a, (k2_a, trace_n_a, out_cap_a, _) = sm_grid_phase(
        "a: run_batch 1056 x 8", sms_a, wall_a, got,
        [list(sm.requests) for sm in sms_a], "greedy_then_oldest", runs_a)
    del res_a, sms_a

    cells_b = grid_b_cells(reqs)
    sms_b, wall_b, got, runs_b = sm_runs(
        "sm run_cells", lambda: sm_torch.run_cells(cells_b,
                                                   policy="round_robin"))
    sm_b, (_, _, _, longest_b) = sm_grid_phase(
        "b: run_cells 264 x 32", sms_b, wall_b, got, cells_b, "round_robin",
        runs_b)
    # the third policy on the heterogeneous grid's longest cell, through
    # run_sm's defaults: sm_torch over hanoi_torch, on the card
    cell = list(longest_b.requests)
    oldest, _, got = run_path(
        "sm run_sm", lambda: sim.run_sm(cell, policy="oldest_first"),
        {"hanoi_run": 1, "sm_schedule": 1})
    ref = sim.run_sm(cell, policy="oldest_first", inner="hanoi_torch",
                     sm_mechanism="sm_interleave")
    bad = sm_diff(oldest, ref)
    check(oldest.mechanism == "sm_torch" and not bad,
          f"oldest_first on the longest cell: {oldest.mechanism}, {bad} "
          "differ from sm_interleave")
    phase("sm", grid="b: longest cell, oldest_first, run_sm defaults",
          mechanism=oldest.mechanism, launches=got, slots=oldest.steps,
          cycles=oldest.cycles, held_to="sm_interleave", bit_equal=not bad)
    del sms_b, cells_b
    torch.cuda.empty_cache()

    clock.start("5f")
    # 5f. Fig 10 through compare(timing="cycle"), on the card -------------------
    fig10, _, got = run_path(
        "fig10 hanoi_torch vs turing_oracle",
        lambda: sim.compare("hanoi_torch", baseline="turing_oracle",
                            timing="cycle"), {"hanoi_run": groups})
    ref10 = sim.compare("hanoi", baseline="turing_oracle", timing="cycle")
    rows10 = fig10.pair("hanoi_torch", "turing_oracle")
    fields10 = ("program", "discrepancy", "ipc_a", "ipc_b", "ipc_delta",
                "util_a", "util_b", "status_a", "status_b", "trace_len_a",
                "trace_len_b")
    check([tuple(getattr(r, f) for f in fields10) for r in rows10]
          == [tuple(getattr(r, f) for f in fields10)
              for r in ref10.pair("hanoi", "turing_oracle")],
          "hanoi_torch's Fig 10 rows differ from the numpy hanoi's")
    fig10_mean = fig10.mean_abs_ipc_delta("hanoi_torch", "turing_oracle")
    phase("fig10", pair="hanoi_torch/turing_oracle", timing="cycle",
          launches=got, mean_abs_ipc_delta_pct=f"{100 * fig10_mean:.4f}",
          paper_pct=0.19,
          rows={r.program: f"{100 * r.ipc_delta:.4f}" for r in rows10})

    clock.start("5g")
    # 5g. static analysis and annotation synthesis, then the synthesized
    # suite on the card ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = [analyze_program(b.program, sim_cfg, name=b.name)
               for b in suite]
    analyze_s = time.perf_counter() - t0
    for r in reports:
        print(f"  {r.name}: ok={r.ok} errors={len(r.errors)} "
              f"warnings={len(r.warnings)} codes={list(r.codes())}")
    check(all(r.ok and not r.warnings for r in reports),
          "a suite program has static errors or warnings")
    t0 = time.perf_counter()
    stripped = [strip_annotations(b.program, sim_cfg) for b in suite]
    synthesized = [synthesize_annotations(s.program, sim_cfg, name=b.name)
                   for b, s in zip(suite, stripped)]
    synth_s = time.perf_counter() - t0
    deviated = [b.name for b, r in zip(suite, synthesized)
                if not np.array_equal(r.program, b.program)]
    check(deviated == ["FIG5"], f"strip -> synthesize is not bit-equal "
          f"outside FIG5: {deviated}")
    # the stripped programs go in; run_batch synthesizes and verifies them
    bare = [SimRequest(program=s.program, cfg=sim_cfg, name=b.name,
                       init_mem=b.init_mem) for b, s in zip(suite, stripped)]
    syn_reqs = [dataclasses.replace(q, program=r.program)
                for q, r in zip(bare, synthesized)]
    groups_syn = len(plan_dispatch(get_mechanism("hanoi_torch"), syn_reqs))
    syn_results, syn_wall, got = run_path(
        "analysis run_batch", lambda: sim.run_batch(
            bare, synthesize=True, verify=True), {"hanoi_run": groups_syn})
    _, syn_ins = hanoi_operands(syn_reqs, sim_cfg)
    syn_twin = state_results(syn_reqs, hanoi_core.hanoi_run_plain(
        *syn_ins, sim_cfg), 0.0)
    del syn_ins
    for a, b in zip(syn_results, syn_twin):
        check(a.mechanism == "hanoi_torch"
              and (a.trace, a.steps, a.fuel_left, a.finished, a.status,
                   a.error) == (b.trace, b.steps, b.fuel_left, b.finished,
                                b.status, b.error)
              and all(np.array_equal(getattr(a, f), getattr(b, f))
                      for f in ("regs", "preds", "mem")),
              f"synthesized {a.mechanism} run differs from K1's twin")
    phase("analysis", programs=len(suite), cfg="32 threads, 256 words, "
          "60000 fuel", launches=got, groups=groups_syn,
          analyze_s=f"{analyze_s:.4f}",
          analyzer_programs_per_s=f"{len(suite) / analyze_s:.1f}",
          synthesize_s=f"{synth_s:.4f}",
          synthesizer_programs_per_s=f"{len(suite) / synth_s:.1f}",
          regions=sum(r.regions for r in synthesized),
          spills=sum(r.spills for r in synthesized),
          yields=sum(r.yields for r in synthesized),
          run_batch_wall_s=f"{syn_wall:.4f}",
          deviations=deviated, held_to="K1's twin, bit for bit",
          card=repr(smi))

    clock.start("5h")
    # 5h. trace sinks and the archive, on the card ----------------------------
    archive_numbers = {}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    archive_root = Path(tempfile.mkdtemp(prefix="chip_smoke_archive_",
                                         dir=scratch))
    try:
        # [archive]: write 2,112 warps of the simulator phase through a
        # rotating sink, read them back, self-replay and index them
        arch_reqs = reqs[:ARCHIVE_WARPS]
        plain, plain_wall, got = run_path(
            "archive run_batch without a sink",
            lambda: sim.run_batch(arch_reqs), {"hanoi_run": 1})
        sink = RotatingJsonlSink(str(archive_root / "suite"))

        def write():
            out = Simulator(sink=sink).run_batch(arch_reqs)
            sink.flush()
            return out
        written, write_wall, got = run_path(
            "archive run_batch with a sink", write, {"hanoi_run": 1})
        sink.close()
        check(sink.write_error is None and sink.runs_written == len(
            arch_reqs), f"the sink wrote {sink.runs_written} runs "
            f"({sink.write_error})")
        check([r.trace for r in written] == [r.trace for r in plain],
              "a sink changed run_batch's results")
        events = sum(len(r.trace) for r in written)
        reader = ArchiveReader(str(archive_root / "suite"))
        t0 = time.perf_counter()
        runs = reader.runs()
        read_s = time.perf_counter() - t0
        check(reader.report.clean and len(runs) == len(arch_reqs),
              f"archive read back: {len(runs)} runs, clean="
              f"{reader.report.clean}")
        check(all(r.trace == w.trace and r.steps == w.steps
                  and r.status == w.status.value
                  for r, w in zip(runs, written)),
              "an archived run differs from its result")
        replayed, replay_s, got_replay = run_path(
            "archive self-replay", lambda: Replayer().replay(runs),
            {"hanoi_run": 1})
        check(replayed.replayed == len(arch_reqs)
              and replayed.mean_discrepancy() == 0.0
              and all(r.discrepancy == 0.0 for r in replayed.rows)
              and {r.replay_mechanism for r in replayed.rows}
              == {"hanoi_torch"},
              f"self-replay: {replayed.replayed} runs, mean "
              f"{replayed.mean_discrepancy()}")
        t0 = time.perf_counter()
        index = ArchiveIndex.build(str(archive_root / "suite"))
        index_s = time.perf_counter() - t0
        picks = [len(runs) * i // len(suite) for i in range(len(suite))]
        t0 = time.perf_counter()
        got_runs = [reader.get(index.entries[i].run_id) for i in picks]
        get_s = time.perf_counter() - t0
        check(all(g.trace == runs[i].trace and dict(g.meta)
                  == dict(runs[i].meta) and g.status == runs[i].status
                  for g, i in zip(got_runs, picks)),
              "an indexed get differs from the scan")
        archive_numbers["archive"] = {
            "warps": len(arch_reqs), "issue_events": events,
            "files": len(sink.paths), "bytes": sink.bytes_written,
            "run_batch_wall_s_no_sink": plain_wall,
            "write_wall_s": write_wall,
            "sink_s": write_wall - plain_wall,
            "write_runs_per_s": len(arch_reqs) / write_wall,
            "read_s": read_s, "read_runs_per_s": len(runs) / read_s,
            "replay_s": replay_s,
            "replay_runs_per_s": len(runs) / replay_s,
            "index_build_s": index_s, "gets": len(picks),
            "get_ms": 1e3 * get_s / len(picks),
            "mean_discrepancy": replayed.mean_discrepancy()}
        phase("archive", launches_write=got, launches_replay=got_replay,
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in archive_numbers["archive"].items()},
              card=repr(smi))

        # [archive_fig9]: the suite archived under turing_oracle (numpy, one
        # warp a program, as the fig9 phase runs it), replayed through
        # hanoi_torch: the fig9 phase's discrepancies, row for row
        t0 = time.perf_counter()
        sink = RotatingJsonlSink(str(archive_root / "fig9"))
        Simulator("turing_oracle", sink=sink).run_batch(suite, sim_cfg)
        sink.close()
        oracle_write_s = time.perf_counter() - t0
        fig9_replay, fig9_replay_s, got = run_path(
            "archive_fig9 replay", lambda: Replayer("hanoi_torch").replay(
                str(archive_root / "fig9")), {"hanoi_run": groups})
        replay_rows = [(r.program, r.discrepancy) for r in fig9_replay.rows]
        check(replay_rows == [(r.program, r.discrepancy) for r in rows],
              "the oracle archive's replay differs from the fig9 phase's "
              "rows")
        fig9_archive_mean = fig9_replay.mean_discrepancy()
        check(f"{100 * fig9_archive_mean:.4f}" == f"{100 * fig9_mean:.4f}",
              f"archive Fig 9 {fig9_archive_mean} against {fig9_mean}")
        archive_numbers["archive_fig9"] = {
            "programs": fig9_replay.replayed,
            "oracle_write_s": oracle_write_s, "replay_s": fig9_replay_s,
            "mean_discrepancy_pct": 100 * fig9_archive_mean,
            "fig9_phase_pct": 100 * fig9_mean,
            "equal_bits": fig9_archive_mean == fig9_mean}
        phase("archive_fig9", pair="hanoi_torch/turing_oracle (archived)",
              launches=got,
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in archive_numbers["archive_fig9"].items()})

        # [archive_sm]: one 8-warp cell a policy through run_sm with a sink
        # (sm_torch: one K1 and one K2 launch a cell); every archived warp
        # self-replays standalone, and each cell's cycles and stalls are
        # re-derived from the archive by the numpy interleave_cycle
        sink = RotatingJsonlSink(str(archive_root / "sm"))
        sm_sim = Simulator(sink=sink)
        cells, cell_got = {}, {}
        t0 = time.perf_counter()
        for k, policy in enumerate(POLICIES):
            cell_reqs = [suite_req(8 * k + w) for w in range(8)]
            cells[policy], _, cell_got[policy] = run_path(
                f"archive_sm run_sm {policy}",
                lambda: sm_sim.run_sm(cell_reqs, policy=policy),
                {"hanoi_run": 1, "sm_schedule": 1})
            check(cells[policy].mechanism == "sm_torch",
                  f"run_sm ran {cells[policy].mechanism}")
        sink.close()
        sm_write_s = time.perf_counter() - t0
        sm_reader = ArchiveReader(str(archive_root / "sm"))
        sm_runs = sm_reader.runs()
        check(sm_reader.report.clean and len(sm_runs) == 8 * len(POLICIES),
              f"SM archive read back {len(sm_runs)} warps")
        sm_replay, sm_replay_s, got = run_path(
            "archive_sm self-replay", lambda: Replayer().replay(sm_runs),
            {"hanoi_run": 1})
        check(sm_replay.replayed == len(sm_runs)
              and all(r.discrepancy == 0.0 for r in sm_replay.rows),
              "an archived SM warp does not self-replay to 0.0")
        t0 = time.perf_counter()
        rederived = Replayer().rederive_timing(sm_runs)
        rederive_s = time.perf_counter() - t0
        fields = ("cycles", "thread_instructions", "busy_cycles",
                  "issue_stall_cycles", "scoreboard_stall_cycles",
                  "memory_stall_cycles")
        check(len(rederived) == len(POLICIES), "lost an SM cell")
        for td in rederived:
            sm = cells[td.policy]
            stamp = td.archived
            check(td.matches_archive and all(
                getattr(td.result, f) == stamp[f] == getattr(sm, f)
                for f in fields),
                f"{td.policy}: re-derived timing differs from K2's stamp")
        archive_numbers["archive_sm"] = {
            "cells": len(rederived), "warps": len(sm_runs),
            "write_s": sm_write_s, "replay_s": sm_replay_s,
            "rederive_s": rederive_s,
            "cycles": {p: cells[p].cycles for p in POLICIES}}
        phase("archive_sm", launches_run_sm=cell_got,
              launches_replay=got,
              held_to="numpy interleave_cycle over the archive "
                      "(cycles, instructions, busy, stalls), each cell",
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in archive_numbers["archive_sm"].items()})

        # [replay_service]: the [archive] phase's runs replayed through a
        # running SimulationService (its defaults: hanoi_torch on the
        # card), one K1 launch a native batch; the report must be
        # Replayer()'s, at exactly 0.0
        rsvc = SimulationService()
        try:
            via_service, rs_wall, rs_got = run_path(
                "replay_service", lambda: Replayer(service=rsvc).replay(runs),
                lambda out: {"hanoi_run": rsvc.stats().native_batches})
            rs_stats = rsvc.stats()
        finally:
            check(rsvc.stop() == [], "replay_service: service threads "
                  "outlived stop()")

        def report_rows(rep):
            return [(r.program, r.archived_mechanism, r.replay_mechanism,
                     r.discrepancy, r.archived_status, r.replayed_status)
                    for r in rep.rows]
        check(via_service.mean_discrepancy() == 0.0
              and via_service.replayed == replayed.replayed == len(runs)
              and report_rows(via_service) == report_rows(replayed),
              f"replay through the service: {via_service.replayed} runs, "
              f"mean {via_service.mean_discrepancy()}, rows equal "
              f"{report_rows(via_service) == report_rows(replayed)}")
        archive_numbers["replay_service"] = {
            "runs": via_service.replayed, "replay_s": rs_wall,
            "runs_per_s": via_service.replayed / rs_wall,
            "replayer_s": replay_s,
            "native_batches": rs_stats.native_batches,
            "mean_fill": rs_stats.mean_fill,
            "mean_discrepancy": via_service.mean_discrepancy()}
        phase("replay_service", launches=rs_got,
              held_to="Replayer()'s report, row for row",
              **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in archive_numbers["replay_service"].items()})
    finally:
        shutil.rmtree(archive_root, ignore_errors=True)
    torch.cuda.empty_cache()

    clock.start("5i")
    # 5i. the simulation service on the card ----------------------------------
    service_numbers = service_phases(
        run_path=run_path, launches=launches, reqs=reqs, sim=sim,
        suite_req=suite_req, scratch=scratch,
        SimulationService=SimulationService, nearest_rank=nearest_rank,
        smi=smi)

    clock.start("5j")
    # 5j. the paper's benchmarks and the quickstart on the card --------------
    bench_numbers = bench_phases(
        run_path=run_path, get_mechanism=get_mechanism,
        as_request=as_request, plan_dispatch=plan_dispatch)

    clock.start("5k")
    # 5k. training on the card ------------------------------------------------
    train_phases(run_path=run_path, dev=dev)

    clock.start("5l'")
    # 5l'. the cells; the dry run's sweeps, on the host beside the next ------
    cell_phases(run_path=run_path, dev=dev)
    dryrun = dryrun_start()

    clock.start("5l")
    # 5l. distribution: ranks sharing the card ---------------------------------
    try:
        dist_numbers = dist_phases(launches=launches)
    except BaseException:
        for proc in dryrun["procs"].values():
            proc.kill()
            proc.wait()
        raise
    dryrun_finish(dryrun)

    clock.start("6")
    # 6. kernel times at the main paths' shapes ------------------------------
    def attention_times(B, S, H, K, hd, window, rows=None):
        """K3's times at a main path's shape; ``rows`` (a, b): a rank's
        query rows [a, b) at q_offset a, SDPA given the same rows' mask."""
        q, k, v = qkv(B, S, H, K, hd, torch.bfloat16)
        a, b = rows or (0, S)
        q = q[:, a:b].contiguous()
        bq, bk = fa.tiles(b - a, S, hd, dtype=torch.bfloat16)
        ms = cuda_time_ms(lambda: ops.flash_attention(
            q, k, v, causal=True, window=window, q_offset=a), 20)
        # the plain twin is a host loop over tiles (0.07-1.8 s a call):
        # one call, its first, is its time
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=window, bq=bq, bk=bk, q_offset=a),
            1, warmup=0)
        # whole rows with a window that reaches past S: the causal mask
        # SDPA takes; else the rows' mask
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if rows is not None or 0 < window < S:
            diff = (torch.arange(a, b, device=dev)[:, None]
                    - torch.arange(S, device=dev)[None, :])
            mask = diff >= 0
            if window > 0:
                mask &= diff < window
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True), 20)
        flops = fa.attention_flops(B, b - a, S, H, hd, causal=True,
                                   window=window, q_offset=a)
        nbytes = fa.attention_bytes(q, k, v)
        bound_ms, bound_by = bound(flops, nbytes, torch.bfloat16)
        shape = f"B{B}xS{S}xH{H}xK{K}xhd{hd}" + (
            f" rows [{a}, {b})" if rows else "")
        phase("kernel_time", kernel="flash_attention", shape=shape,
              dtype="bf16", window=window, ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
              flops=flops, bytes=nbytes, bound_ms=f"{bound_ms:.4f}",
              bound_by=bound_by, roofline_share=f"{bound_ms / ms:.4f}")
        return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    attn_llama = attention_times(PREFILL_B, PREFILL_S, *llama_attn, 0)
    attn_tp2 = attention_times(PREFILL_B, PREFILL_S, *llama_tp2_attn, 0)
    attn_rgemma = attention_times(PREFILL_B, PREFILL_S, *rgemma_attn,
                                  gcfg.window_size)
    attn_hd128 = attention_times(PREFILL_B, PREFILL_S, *hd128_attn, 0)
    attn_gemma3 = attention_times(PREFILL_B, PREFILL_S, *gemma3_attn,
                                  gemma3_window)
    attn_mha = attention_times(PREFILL_B, PREFILL_S, *mha_attn, 0)
    attn_swa = attention_times(1, MIXTRAL_S, *swa_attn, swa_window)
    attn_gemma3_global = attention_times(PREFILL_B, PREFILL_S, *gemma3_attn,
                                         0)
    attn_gqa = {arch: attention_times(PREFILL_B, PREFILL_S, *attn, 0)
                for arch, attn in gqa_attn.items()}
    attn_rows = {name: attention_times(B, S, H, K, hd, window, rows=rows)
                 for name, B, S, rows, H, K, hd, window, dtype in OFFSET_CASES
                 if dtype == torch.bfloat16}

    # K4 and K5 at the prefill shape, at their default segment length and
    # at the others the kernels take (the sweep the defaults come from)
    def scan_sweep(kernel, fn, segs, iters):
        sweep = {seg: cuda_time_ms(lambda: fn(seg), iters) for seg in segs}
        phase("kernel_sweep", kernel=kernel,
              ms={seg: f"{ms:.4f}" for seg, ms in sweep.items()})
        return sweep

    a, b = rglru_inputs(PREFILL_B, PREFILL_S, gcfg.lru_width)
    rglru_shape = f"B{PREFILL_B}xS{PREFILL_S}xW{gcfg.lru_width}"
    rglru_sweep = scan_sweep(
        "rglru_scan", lambda seg: ops.rglru_scan(a, b, seg=seg),
        (4, 8, rg.DEFAULT_SEG, rg.MAX_SEG), 20)
    rglru_ms = cuda_time_ms(lambda: ops.rglru_scan(a, b), 20)
    rglru_plain_ms = cuda_time_ms(lambda: rg.rglru_scan_plain(a, b), 3,
                                  warmup=1)
    rglru_bound = bound(rg.scan_flops(a), rg.scan_bytes(a), torch.float32)
    rglru_scratch = sum(4 * n for n in rg.scratch_shape(
        PREFILL_B, PREFILL_S, gcfg.lru_width, rg.DEFAULT_SEG))
    phase("kernel_time", kernel="rglru_scan", shape=rglru_shape,
          dtype="float32", seg=rg.DEFAULT_SEG, ms=f"{rglru_ms:.4f}",
          plain_ms=f"{rglru_plain_ms:.4f}", library_ms=None,
          flops=rg.scan_flops(a), bytes=rg.scan_bytes(a),
          scratch_bytes=rglru_scratch, bound_ms=f"{rglru_bound[0]:.4f}",
          bound_by=rglru_bound[1],
          roofline_share=f"{rglru_bound[0] / rglru_ms:.4f}")
    del a, b

    ins = rwkv_inputs(PREFILL_B, PREFILL_S, *rwkv_heads)
    rwkv_shape = "B{}xS{}xH{}xhd{}".format(PREFILL_B, PREFILL_S, *rwkv_heads)
    rwkv_sweep = scan_sweep(
        "rwkv6_scan", lambda seg: ops.rwkv6_scan(*ins, seg=seg),
        (16, 32, rw.DEFAULT_SEG, 128), 10)
    rwkv_ms = cuda_time_ms(lambda: ops.rwkv6_scan(*ins), 10)
    rwkv_plain_ms = cuda_time_ms(lambda: rw.rwkv6_scan_plain(*ins), 2,
                                 warmup=1)
    rwkv_bound = bound(rw.scan_flops(ins[0]), rw.scan_bytes(ins[0]),
                       torch.float32)
    rwkv_scratch = sum(4 * n for n in rw.scratch_shape(
        PREFILL_B, PREFILL_S, *rwkv_heads, rw.DEFAULT_SEG))
    phase("kernel_time", kernel="rwkv6_scan",
          shape=rwkv_shape, dtype="float32", seg=rw.DEFAULT_SEG,
          ms=f"{rwkv_ms:.4f}", plain_ms=f"{rwkv_plain_ms:.4f}",
          library_ms=None, flops=rw.scan_flops(ins[0]),
          bytes=rw.scan_bytes(ins[0]), scratch_bytes=rwkv_scratch,
          bound_ms=f"{rwkv_bound[0]:.4f}", bound_by=rwkv_bound[1],
          roofline_share=f"{rwkv_bound[0] / rwkv_ms:.4f}")
    del ins

    # K4 and K5 at a rank's share in [dist_recurrent]: K4 on 640 of the
    # 2560 channels (1, 4); K5 on 10 of the 40 heads (1, 4) and on the 3
    # heads a rank of (1, 16) touches at 1 x 2048
    def share_times(kernel, fn, plain_fn, ins, flops, nbytes, shape):
        ms = cuda_time_ms(lambda: fn(*ins), 20)
        plain_ms = cuda_time_ms(lambda: plain_fn(*ins), 2, warmup=1)
        bound_ms, bound_by = bound(flops, nbytes, torch.float32)
        phase("kernel_time", kernel=kernel, shape=shape,
              case="a rank's share", dtype="float32", ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=None,
              bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
              roofline_share=f"{bound_ms / ms:.4f}")
        return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}

    w4 = gcfg.lru_width // 4
    ins = rglru_inputs(PREFILL_B, PREFILL_S, w4)
    rglru_share = share_times(
        "rglru_scan", ops.rglru_scan, rg.rglru_scan_plain, ins,
        rg.scan_flops(ins[0]), rg.scan_bytes(ins[0]),
        f"B{PREFILL_B}xS{PREFILL_S}xW{w4}")
    rwkv_share = {}
    for key, (B_, S_, H_) in (("1x4", (PREFILL_B, PREFILL_S,
                                       rwkv_heads[0] // 4)),
                              ("1x16", (1, SPLIT_HEAD_S, 3))):
        ins = rwkv_inputs(B_, S_, H_, rwkv_heads[1])
        rwkv_share[key] = share_times(
            "rwkv6_scan", ops.rwkv6_scan, rw.rwkv6_scan_plain, ins,
            rw.scan_flops(ins[0]), rw.scan_bytes(ins[0]),
            f"B{B_}xS{S_}xH{H_}xhd{rwkv_heads[1]}")
    del ins

    # K2 at shape (a), the SM model's main grid
    k2_ms = cuda_time_ms(k2_a, 10)
    t_bytes = sm_a["k2_bytes"] / PEAK_BYTES_PER_S * 1e3
    # the latency half of K2's bound: the longest cell's slots, each one
    # link of the function's shortest dependent chain (one warp-wide
    # minimum and the issued warp's update; sm_sched.slot_chain_cycles),
    # measured on this card, at the data sheet's boost clock
    slot_cycles = sm_sched.slot_chain_cycles(dev)
    # the narrow slot's own chain as built, without its memory traffic and
    # counters: what K2's cycles a slot lose beyond it is the rest
    link_cycles = sm_sched.slot_chain_cycles(dev, narrow_link=True)
    t_slots = sm_a["longest_cell_slots"] * slot_cycles / CLOCK_HZ * 1e3
    k2_bound = (max(t_bytes, t_slots),
                "bytes" if t_bytes >= t_slots else "operations")
    # the kernel's own cycles a slot of the longest cell, at the same clock
    k2_slot_cycles = k2_ms * 1e-3 * CLOCK_HZ / sm_a["longest_cell_slots"]
    phase("kernel_time", kernel="sm_sched",
          shape=f"{SM_CELLS_A} cells x {SM_WARPS_A} warps, out_cap "
                f"{out_cap_a}", ms=f"{k2_ms:.4f}",
          plain_ms=f"{1e3 * sm_a['k2_twin_s']:.4f}", library_ms=None,
          bytes=sm_a["k2_bytes"], bound_ms=f"{k2_bound[0]:.4f}",
          bound_by=k2_bound[1], bound_ms_bytes=f"{t_bytes:.4f}",
          bound_ms_slots=f"{t_slots:.4f}",
          slot_chain_cycles=f"{slot_cycles:.2f}",
          cycles_per_slot=f"{k2_slot_cycles:.2f}",
          narrow_link_cycles=f"{link_cycles:.2f}",
          share_of_slot_chain=f"{slot_cycles / k2_slot_cycles:.4f}",
          roofline_share=f"{k2_bound[0] / k2_ms:.4f}",
          ptxas=json.dumps(ptxas["sm_sched"]))

    clock.start("7")
    # 7. kernels line, device line -------------------------------------------
    no_library = ("no single PyTorch call computes this recurrence "
                  "(torch has no scan)")
    kernels_line = json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "status": "redesigned",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:110",
         "launches": sum(launches["flash_attention"].values()),
         "launches_by_path": launches["flash_attention"],
         "max_abs_err": errs["llama_causal_bf16"], **attn_llama,
         "hd64_tp2_rank": {"max_abs_err": errs["llama_tp2_bf16"],
                           **attn_tp2, **dist_numbers},
         "hd256": {"max_abs_err": errs["rgemma_bf16"], **attn_rgemma},
         "hd128": {"max_abs_err": errs["hd128_bf16"], **attn_hd128},
         "hd320": {"max_abs_err": errs["gemma3_local_bf16"],
                   **attn_gemma3},
         "hd128_mha": {"max_abs_err": errs["deepseek_mha_bf16"],
                       **attn_mha},
         "hd128_swa": {"max_abs_err": errs["mixtral_swa_bf16"],
                       **attn_swa},
         "hd320_global": {"max_abs_err": errs["gemma3_global_bf16"],
                          **attn_gemma3_global},
         **{f"hd128_gqa{H // K}": {"max_abs_err": errs[f"{arch}_bf16"],
                                   **attn_gqa[arch]}
            for arch, (H, K, _) in gqa_attn.items()},
         **{f"rows_{name}": {"max_abs_err": errs[name], **attn_rows[name]}
            for name in attn_rows},
         "prefills": config_numbers},
        {"name": "rglru_scan", "route": "cuda",
         "status": "redesigned",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:46",
         "launches": sum(launches["rglru_scan"].values()),
         "launches_by_path": launches["rglru_scan"],
         "max_abs_err": errs["rglru_prefill"],
         "shape": rglru_shape, "seg": rg.DEFAULT_SEG,
         "ms": rglru_ms, "plain_ms": rglru_plain_ms,
         "bound_ms": rglru_bound[0], "bound_by": rglru_bound[1],
         "library_ms": None, "library_note": no_library,
         "sweep_ms": rglru_sweep, "scratch_bytes": rglru_scratch,
         "ptxas": ptxas["rglru_scan"],
         "rank_share_1x4": {**rglru_share, **dist_numbers["recurrent"][
             "recurrentgemma-2b"]},
         **{case: bits[case] for case in bits if case.startswith("rglru")}},
        {"name": "rwkv6_scan", "route": "cuda",
         "status": "redesigned",
         "source": "src/repro_torch/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:52",
         "launches": sum(launches["rwkv6_scan"].values()),
         "launches_by_path": launches["rwkv6_scan"],
         "max_abs_err": errs["rwkv_prefill"],
         "shape": rwkv_shape, "seg": rw.DEFAULT_SEG,
         "ms": rwkv_ms, "plain_ms": rwkv_plain_ms,
         "bound_ms": rwkv_bound[0], "bound_by": rwkv_bound[1],
         "library_ms": None, "library_note": no_library,
         "sweep_ms": rwkv_sweep, "scratch_bytes": rwkv_scratch,
         "ptxas": ptxas["rwkv6_scan"],
         "rank_share_1x4": {**rwkv_share["1x4"],
                            **dist_numbers["recurrent"]["rwkv6-3b"]},
         "split_head_1x16": {**rwkv_share["1x16"],
                             **dist_numbers["recurrent"]["split_head"]},
         **{case: bits[case] for case in bits if case.startswith("rwkv")}},
        {"name": "hanoi_step", "route": "cuda",
         "status": "redesigned",
         "source": "src/repro_torch/csrc/hanoi_step.cu",
         "replaces": "src/repro/core/hanoi.py:470",
         "launches": sum(launches["hanoi_run"].values()),
         "launches_by_path": launches["hanoi_run"],
         "max_abs_err": k1_err,
         "shape": f"{SIM_WARPS} warps x 32 threads, max_steps 60000",
         "ms": k1_ms, "plain_ms": twin_s * 1e3,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None,
         "library_note": "no PyTorch call interprets a program; "
                         "trace_fill_ms is torch's fill_ of the trace "
                         "buffers alone",
         "trace_fill_ms": fill_ms, "trace_fill_bytes": fill_bytes,
         "ptxas": ptxas["hanoi_step"], "checks": k1_checks,
         "layout_checks": k1_layouts,
         "simulator": sim_numbers, "fig9_mean_discrepancy": fig9_mean,
         "archive": archive_numbers, "service": service_numbers,
         "benchmarks": bench_numbers},
        {"name": "sm_sched", "route": "cuda",
         "status": "redesigned",
         "source": "src/repro_torch/csrc/sm_sched.cu",
         "replaces": "src/repro/engine/mechanisms/sm_jax.py:137",
         "launches": sum(launches["sm_schedule"].values()),
         "launches_by_path": launches["sm_schedule"],
         "max_abs_err": max(c["max_abs_err"] for c in k2_checks.values()),
         "shape": f"{SM_CELLS_A} cells x {SM_WARPS_A} warps, paper config",
         "ms": k2_ms, "plain_ms": 1e3 * sm_a["k2_twin_s"],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None,
         "library_note": "no PyTorch call schedules warps",
         "slot_chain_cycles": slot_cycles,
         "cycles_per_slot": k2_slot_cycles,
         "narrow_link_cycles": link_cycles,
         "ptxas": ptxas["sm_sched"], "checks": k2_checks,
         "sm_a": sm_a, "sm_b": sm_b,
         "fig10_mean_abs_ipc_delta": fig10_mean},
    ]})
    clock.start(None)
    phase("wall", total_s=f"{clock.total_s():.1f}")
    print(kernels_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
