#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device (an H100):
    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card's name and power limit (nvidia-smi) and torch's view of it;
  build    nvcc builds the four kernels, the Mamba2 decode, the solvers'
           ordered scan, port chain and numpy sum, and the empty launch-floor
           kernel (ptxas register / shared-memory lines);
  kernels  each kernel against its plain version at its path's shapes (and
           gemv / gemv_tiles at the reference's sweeps, in both layouts of A),
           timed with CUDA events beside the plain version and a library call;
           device time per launch of each kernel and of its library call from
           one torch.profiler run; for gemv / gemv_tiles at both shard shapes
           the plan (slices, items, blocks, stages, bytes in flight), achieved
           TB/s and share of the bound, at the gemma3-27b shard also cold (A
           rotated over copies the L2 cannot hold), gemv row-major, and the
           measured plan variants; for decode_attention at S 544 and 512 the
           plan (chunk, splits, CTAs, CTAs an SM, waves), warm and cold device
           time beside SDPA's, the chunk variants (cold), and the kernel at
           three more head layouts beside SDPA; faulty controls the bf16
           tolerance must reject; rmsnorm and decode_attention at the main
           path's shapes (olmoe-1b-7b: x [4, 1, 2048]; q [4, 16, 128] against
           k/v [4, 544, 16, 128]) beside their plain versions and library
           calls; rmsnorm in one profile with F.rms_norm and the empty
           kernel (the launch floor) at D 2048, 1152, 768 and 2560, and
           rmsnorm against its plain version at every width the port's norms
           take, bf16 and float32; decode_attention at the head layout of each
           GQA config of the families phase and of zamba2-2.7b's shared block
           (32, 32, 80) beside SDPA (S 40 and 544); the ordered scan bit for
           bit against its plain version at the flat solver's shapes; at the
           end, in the closed loop's process (below), a second kernels line:
           the port chain at 256 ports of 65,280 touches (fat_tree's up
           ports at 4,096 devices) and numpy's sum at every length 1-8,193
           and at 65,280, bit for bit against their plain versions, each
           rejecting a faulty control (a pairwise queued sum; a left-to-right
           sum); mamba_decode (the Mamba2 decode between its projections)
           at zamba2-2.7b's serve shape (B 4, 80 heads of 64, d_state 64,
           a window of 5,248 channels) and at one rank's 20 heads, 8 steps
           carrying the state against its plain version, rejecting two faulty
           controls (the conv taps reversed; D x left out), timed beside the
           plain version at B 4 and at the benchmark's B 512;
  gemv_allreduce  the fused GEMV+AllReduce and the unfused psum_matmul on 4
           ranks (4 processes sharing the card, a gloo group exchanging
           through host memory) at the paper's Table-1 shape and at
           gemma3-27b's tensor-parallel down-projection: every rank checks
           its result, its owner_served schedule and its kernel launches;
  scans    the Eidola model's replay_lane and spin_reads on the card against
           their numpy closed forms, exactly;
  cluster  last, with the analysis phase and the tiered kernels' checks, in
           a spawned process of its own: the closed-loop simulator, all 144
           rows of BENCH_multi_device.json (the reference's own record of its
           counters), 4 scenarios x 4-4096 devices x flat / two_tier /
           fat_tree / rail_optimized at 64 workgroups under SPIN.  Every row
           the record shows engaged runs a lockstep solver with its tensors on
           the card: the flat one on the single-tier ring (the ordered scan),
           the tiered one on the tiered presets (the port chain, numpy's sum
           and the ordered scan); every other row runs the host timeline
           engine.  Each row's counters (flag and non-flag reads, xGMI writes
           in, WTT enacted, kernel span, cycles) and its lockstep reason must
           equal the record exactly; the card solver's report must equal the
           CPU solver's up to 1,024 devices, field for field but the walls,
           and the host timeline engine's counters up to 256; each of the
           three solver kernels must have launched; a result with one flag
           read added must be rejected.  The host runs go to 6 worker
           processes beside the card's rows.  One line a scenario (each
           row's wall, compile and solve time on the card and on the CPU, or
           on the host for the host engine's rows) and a phase line;
  analysis the port's static analyzer gate, python -m repro_torch.analysis at
           its defaults (verifier, timeline path on the card, loop-space
           verifier at 1,024 devices, layout prover up to 4,096): its four
           summary lines, each "ok";
  eidola   the open-loop Eidola simulator (repro_torch.core) at the paper's
           Table 1 (4 CUs, 3 eGPUs, 208 workgroups, M 256, K 8192): Fig. 6
           (SPIN, flag delays 0-40 us in steps of 5), Fig. 9 (SYNCMON with
           10 ns Gaussian write jitter, seed i*7+1), Fig. 10 (M 256-4096),
           Fig. 11 (3-255 eGPUs, weak scaling at K 2048) and Fig. 12 (two
           peers held up 30 us); at every point the vector engine with its
           tensors on the card equals the CPU vector engine field for field
           and the host's event and cycle engines on every field but the
           engine-specific ones (name, head polls, monitor stats, wall); the
           paper's claims (Fig. 6 linear, r^2 > 0.99, 65,792 non-flag reads;
           SyncMon's flag reads in 728-788; Fig. 11's normalised event time
           at 255 eGPUs below 128x; Fig. 12's wait inflated over 10x); a
           report with one flag read added must be rejected.  One line a
           figure with every engine's wall at each point beside the card;
  serve    gemma3-1b (slice 1's path), the main path olmoe-1b-7b (6.92 B
           parameters, 64 experts top-8), then zamba2-2.7b (2.42 B, 54 Mamba2
           layers and one shared attention block applied 9 times) and
           xlstm-125m, all at full width and depth (random bf16 weights from a
           seeded generator) through ServeEngine: 4 requests x (480 + 64)
           tokens, asserting the launches of each kernel per step (53 / 26
           rmsnorm / decode_attention for gemma3-1b, 33 / 16 for olmoe, 73 / 9
           for zamba2, 13 / 0 for xlstm), with parameter and cache bytes;
  profile  after each serve phase, device time by kernel over the last
           decode steps (torch.profiler), beside the wall of the same steps
           run without the profiler; for olmoe the grouped GEMMs' device time
           per step beside their byte bound from the experts touched;
  families the other attention configs at full width with their depth cut
           (gemma3-27b to 6 layers, the rest to 2): 4 x (32 + 8) tokens each,
           exact launches, ms per step, peak memory and a profile;
  parity   every family's reduced config (the nine attention configs,
           zamba2 and xlstm) in float32 through the decode step and
           ServeEngine on the card and on the CPU: first-step logits close,
           MoE routing identical at every step, greedy tokens and stats
           identical;
  train    the training paths at full width and depth through Trainer (bf16
           weights from a seeded generator, float32 master, AdamW, the
           synthetic data through prefetch): gemma3-1b (999,812,736
           parameters; B 4 x S 1024 in 2 microbatches, 8 steps, lr 3e-3,
           warmup 5) and xlstm-125m (B 8 x S 128, 6 steps): the loss falls,
           exact rmsnorm forward / backward launches a step (106 / 106, 13 /
           13), ms a step, tokens/s, peak memory beside the 16 bytes a
           parameter of state, and one profiled step (device busy, idle
           share, top rows);
  train_parity  the reduced gemma3-1b, xlstm-125m, zamba2-2.7b, minicpm3-4b
           and olmoe-1b-7b in float32 on the card and the CPU: the loss and
           every gradient, and the parameters after 3 AdamW steps; then a
           checkpoint/restart drill on the card (a failure before step 4,
           restored bit for bit);
  sharded  gemma3-1b at full width and depth on a (2, 2) mesh: 4 ranks, one
           process each, sharing the card in a gloo group that exchanges
           through the host; the train phase's run for 3 steps from the same
           seed and batches: each step's loss within 0.05 of the one-rank
           run's, the gradient norm within 1% at steps 1 and 2, and at step 1
           each tensor kind's norm within 1% of a one-rank rerun's; step 3's
           beside a one-rank control cut into 4 microbatches; exact rmsnorm
           launches a step and rank (106 / 106); per rank the peak memory
           beside its bytes of parameters, gradient buffers and ZeRO-1 state,
           and the bytes it hands each collective a step;
  capture  the capture bridge: each rank's collective schedule of the sharded
           phase's step 2, recorded as it ran, equals op for op (kind, dtype,
           bytes, group size, mesh axes, order) the abstract capture of that
           rank (full gemma3-1b on meta tensors, no world, the same mesh,
           batch and microbatches), whose kernel calls are 106 / 106 a step;
           the abstract parameter, gradient-buffer and ZeRO-1 bytes equal the
           measured ones, the abstract peak beside max_memory_allocated; the
           dry runs of gemma3-1b and olmoe-1b-7b x train_4k x single (per-kind
           counts and bytes, the H100_SXM roofline terms, predict_step's
           envelope, the trace's writes and span, host seconds); the one-card
           train cell's compute_s + memory_s on H100_SXM beside the train
           phase's device busy ms a step; and the card's bf16 8192^3 matmul
           and device-to-device copy rates beside H100_SXM's 989 TFLOP/s and
           3.35 TB/s.  Its seven abstract traces run at once, each in a
           spawned process of its own with no world and no card.  Each rank's
           abstract schedule, lowered to an Eidola trace on H100_SXM, is
           replayed open-loop in the port's simulator under SPIN and SYNCMON
           (the event engine on the host, the vector engine on the card,
           equal; span above 0), its counters printed;
  moe_ep   olmoe-1b-7b's MoE layer at full width expert-parallel on (1, 4),
           float32: the scatter path (B 4 x S 512) and the gather path (B 4 x
           S 1) against moe_apply on one rank, outputs and gradients; the
           dropped pairs at capacity 1.25 and 0.25 against a plain count;
  pipeline pipeline_apply over 4 ranks (8 layers at d 2048, 8 microbatches)
           against the layers run in sequence;
  remat    gemma3-1b's one-rank step at full width under "none", "full",
           "dots" and "dots_no_batch": exact rmsnorm launches (210 / 106 a
           step under remat), ms a step, peak memory, losses equal;
  sharded_serve  serving on a (2, 2) mesh: 4 ranks, one process each,
           sharing the card in a gloo group, at full width and depth in
           float32 (seed-0 weights drawn whole and sliced) through
           ServeEngine: gemma3-1b 4 x (8 + 8) tokens (head-parallel, the
           one KV head read by both model ranks) and olmoe-1b-7b 4 x (8 + 8)
           (the expert-parallel gather path); then gemma3-1b 1 x (504 + 16)
           through Model.prefill of the prompt into caches of 520 slots and
           16 decode steps (the row does not divide over data: every cache's
           slots are cut over data, sequence-parallel through the kernel's
           partial entry, the local layers' 512-slot rings wrapping at step
           9).  Each is first run on one rank in this process and freed.
           Every rank: tokens exactly the one-rank run's, every step's
           logits within 1e-4, rmsnorm and decode_attention launches
           a step as decode_launches gives them (and the prefill's norms),
           and the executed schedule of its last decode step equal, op for
           op, to its abstract capture (trace_cell on meta tensors); ms a step
           (the gloo host exchange), the bytes handed to each collective a
           step (a prefill's apart), peak memory beside the rank's parameter
           and cache bytes;
  sharded_blocks  the Mamba2, mLSTM and MLA blocks computing their heads'
           share on a (2, 2) mesh (4 ranks sharing the card, float32, seed-0
           weights drawn whole and sliced), one line a case: zamba2-2.7b at
           full width and depth 4 x (8 + 8) through ServeEngine (its Mamba2
           blocks and shared block head-parallel, each state the rank's
           heads'); minicpm3-4b at full width and depth 4 x (32 + 8) through
           Model.prefill and 8 decode steps (MLA head-parallel, the latents'
           slots cut over model); each first on one rank and on a float64
           anchor (the one-rank model with float64 parameters and products
           and the kernels' plain versions), then every rank's tokens exactly
           the one-rank run's and each step's logits no further from the
           anchor than twice the one-rank run's distance at that step + 1e-5
           (the distance from the one-rank run printed beside), exact
           launches and schedules as in sharded_serve; and xlstm-125m at full
           width and depth trained 2 steps (B 4 x S 64, one microbatch, lr
           1e-3 warming up over 2 steps; its mLSTM cells head-parallel, the
           sLSTM cells whole) against the one-rank run and its anchor: losses
           within 1e-3 and step 1's gradient norm within 1e-4 relative of the
           one-rank run's; each step's gradient norm no further from the
           anchor's than twice the one-rank run's relative distance + 1e-4;
           after each step, in each leaf of each rank's parameter shards, no
           more entries outside 1e-5 + 1e-5 |p| of the anchor's than twice the
           one-rank run's on the same entries + 8, a leaf with its step-1
           update undone (blocks.0.cell.w_if) failing that bound; 13 / 13
           rmsnorm launches a step and rank.  Every rank's rmsnorm calls are
           recorded and must be exactly the shapes the kernels phase held.
           Each case prints its per-rank peak memory beside the same work's
           with those blocks replicated over model (their specs without the
           axis: whole on every rank, weights and compute; the engine's
           caches and two steps, the prefill and a step, or one train step;
           its first logits held to the anchor as above, its loss to the
           one-rank run's), its launches a step and rank and its collectives
           a step.
The kernels phase also holds decode_attention's partial entry (a slice of S:
float32 output and log-sum-exp) from bf16 and float32 inputs at olmoe's and
gemma3-1b's head layouts over 2 and 4 slices of S 544, an empty slice among
them, each slice against its plain version and the slices combined against
the whole attention, all at the float32 tolerance (two faulty combines and
bf16 softmax weights or accumulators rejected); then both entries in
float32 at the shapes and lengths sharded_serve's ranks give them, derived
from its runs and mesh (the whole kernel on each rank's rows and heads, the
partial entry on each data rank's slice of the 520-slot global caches and
the 512-slot local rings, wrapped, at every decode position and at 0 and 1
tokens; and the whole kernel at zamba2-2.7b's shared block, 16 heads a
rank over 40 slots, for sharded_blocks), which those phases' ranks then show
they met; and the partial's device time on half of S 544 beside the whole
kernel's.
The kernels phase also holds the rmsnorm backward (the port's own kernel: the
reference differentiates rms_norm through XLA) against its plain version at
the training shapes, bits repeating over 5 calls and a bf16 dgamma
accumulator rejected, beside the backward of F.rms_norm, and the forward at
the gemma3-1b training shape [2048, 1152]; and both in float32 at the shapes
sharded_blocks gives them on one rank and on each rank of its meshes,
derived from its runs and the configs (forward and backward against their
plain versions, bits repeating, the plain version on bf16-rounded inputs and
a bf16 dgamma accumulator rejected).
Then a timing line (seconds from the start to the end of each phase), the
kernel summary line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure raises: the script exits non-zero
and prints no result.  Without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
# (float64 outside the tensor cores: 34 TFLOP/s, the same data sheet)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "float64": 34e12}
# bf16 kernel output against the float32 plain version on the same inputs: the
# kernel rounds its float32 result to bf16 (relative error <= 2^-9), so this is
# about 5x that rounding; it rejects a dropped slot or a bf16 accumulator
# (see ATTENTION_CONTROLS), which the reference's 3e-2 let through
BF16_TOL = dict(rtol=1e-2, atol=4e-3)
F32_LOGIT_TOL = 1e-4                   # card vs CPU, float32, one decode step
PROMPT_LEN, NEW_TOKENS, REQUESTS = 480, 64, 4
F32_TOL = dict(rtol=3e-5, atol=3e-5)  # float32 kernels: the reference's own _tol
SOURCES = {  # kernel: (CUDA source, the TPU kernel's pallas_call site)
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:44"),
    # the port's own kernel: the reference differentiates rms_norm through XLA
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/models/common.py:244"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:83"),
    "gemv": ("src/repro_torch/kernels/csrc/gemv.cu", "src/repro/kernels/gemv.py:53"),
    "gemv_tiles": ("src/repro_torch/kernels/csrc/gemv_tiles.cu",
                   "src/repro/kernels/gemv_tiles.py:92"),
    # the port's own kernel: the reference's flat lockstep solver adds its
    # busy chains and queued sums with numpy's sequential np.cumsum
    "ordered_scan": ("src/repro_torch/kernels/csrc/ordered_scan.cu",
                     "src/repro/core/lockstep.py:828"),
    # the port's own kernels: the reference's tiered lockstep solver prices a
    # port's touches with _chain (the scalar busy recurrence) and adds its
    # queued times with numpy's pairwise float(q.sum())
    "port_chain": ("src/repro_torch/kernels/csrc/port_chain.cu",
                   "src/repro/core/lockstep_tiered.py:1390"),
    "numpy_sum": ("src/repro_torch/kernels/csrc/numpy_sum.cu",
                  "src/repro/core/lockstep_tiered.py:1400"),
    # the port's own kernel: the reference's Mamba2 decode is plain jnp
    "mamba_decode": ("src/repro_torch/kernels/csrc/mamba_decode.cu",
                     "src/repro/models/ssm.py:140"),
}
SOLVER_KERNELS = ("ordered_scan", "port_chain", "numpy_sum")  # the cluster phase's
SERVE_KERNELS = ("rmsnorm", "decode_attention", "mamba_decode")  # the serve paths'; gemv's
# run in the kernels and gemv_allreduce phases
MAMBA_ARCH = "zamba2-2.7b"  # the serve path that runs mamba_decode
# the serve paths: slice 1's gemma3-1b, and this slice's main path, olmoe-1b-7b
# (src/repro/configs/olmoe_1b_7b.py, arXiv:2409.02060), both at full width
MAIN_ARCH = "olmoe-1b-7b"
OLMOE_HEADS = {"d_model": 2048, "H": 16, "KV": 16, "D": 128}
# the other attention-family configs at full width, depth cut to these layers:
# gemma3-27b keeps one global layer (every 6th), kimi-k2 one dense and one MoE
# layer with all 384 experts (about 19.6 B parameters, 39 GB in bf16)
FAMILIES = {"gemma3-27b": 6, "starcoder2-7b": 2, "qwen2-vl-7b": 2, "minicpm3-4b": 2,
            "musicgen-large": 2, "kimi-k2-1t-a32b": 2, "kimi-k2-1t-mla": 2}
FAMILY_PROMPT, FAMILY_NEW = 32, 8
# every family, reduced, in float32 on the card and on the CPU
PARITY_ARCHS = ("gemma3-1b", "gemma3-27b", "starcoder2-7b", "qwen2-vl-7b", "minicpm3-4b",
                "musicgen-large", "olmoe-1b-7b", "kimi-k2-1t-a32b", "kimi-k2-1t-mla",
                "zamba2-2.7b", "xlstm-125m")
# the serve paths at full width and full depth, in order: slice 1's, the main
# path, then this slice's two recurrent configs
SERVE_ARCHS = ("gemma3-1b", MAIN_ARCH, "zamba2-2.7b", "xlstm-125m")
# kernel launches a decode step on each serve path: zamba2's 54 Mamba ln1,
# 9 x 2 in the shared block and the final norm, and one mamba_decode a Mamba2
# layer; xlstm's 12 ln1 and the final
SERVE_LAUNCHES_PER_STEP = {
    "gemma3-1b": {"rmsnorm": 53, "decode_attention": 26},
    MAIN_ARCH: {"rmsnorm": 33, "decode_attention": 16},
    "zamba2-2.7b": {"rmsnorm": 73, "decode_attention": 9, "mamba_decode": 54},
    "xlstm-125m": {"rmsnorm": 13, "decode_attention": 0},
}
# rmsnorm timed beside F.rms_norm and the empty kernel at these widths too
# (olmoe's 2048 and gemma3-1b's 1152 are timed as the paths' own): xlstm-125m's
# and zamba2-2.7b's d_model
RMSNORM_WIDTHS = (768, 2560)

# The fused GEMV+AllReduce's shapes: y[B, N] = x[B, K] @ w[K, N], K split over
# RANKS ranks, so each rank's kernels see A = w_shard.T [N, K / RANKS] and x.T
# [K / RANKS, B]:
#  - table1: the paper's Table 1 (src/repro/core/config.py:39-47), M = 256,
#    K = 8192, N = 1 in float32: a rank's slice is [256, 2048], the "2 MB slice";
#  - gemma3_27b_tp4: gemma3-27b's MLP down-projection (d_model 5376, d_ff 21504:
#    src/repro/configs/gemma3_27b.py, and Google's public gemma-3-27b config)
#    under 4-way tensor parallelism, at slice 1's decode batch of 4: a rank's
#    w shard is [5376, 5376] bf16 (57,802,752 bytes), 84 tiles of 64 rows.
RANKS = 4
ALLREDUCE_SHAPES = {  # name: (B, K, N, dtype)
    "table1": (1, 8192, 256, "float32"),
    "gemma3_27b_tp4": (4, 21504, 5376, "bfloat16"),
}
BF16_UNIT_ROUNDOFF = 2.0 ** -8  # bf16 keeps 8 significant bits
GEMV_SWEEP = [(128, 512, 1), (256, 1024, 1), (256, 2048, 4), (64, 256, 8)]  # test_kernels.py:19
GEMV_SCHEDULES = [(4, 0), (4, 1), (4, 3), (8, 5)]                           # test_kernels.py:32
GEMV_CONTROLS = ("acc_bf16_per_slab", "one_slab_dropped")  # must be rejected
COLD_COPIES = 4  # copies of the 57.8 MB shard a cold timing rotates over (L2: 50 MB)
ATTENTION_COLD_BYTES = 100e6  # K and V copies a cold attention timing rotates over: 2x the L2
# head layouts (name: H, KV, D) of configs a later slice ports, timed at B 4, S 1024,
# bf16: gemma3-27b (src/repro/configs/gemma3_27b.py), qwen2-vl-7b, kimi-k2
ATTENTION_HEADS = {"gemma3_27b": (32, 16, 128), "qwen2_vl_7b": (28, 4, 128),
                   "kimi_k2": (64, 8, 112)}
ATTENTION_CHUNKS = (16, 32, 64, 128)  # the measured plan variants at the serve shape


# the training paths (slice 4a): gemma3-1b, the main path, B 4 x S 1024 in 2
# microbatches, 8 AdamW steps; xlstm-125m, repro.launch.train's defaults (B 8
# x S 128, one microbatch), 6 steps.  Both at full width and depth, the data's
# token ids from a vocabulary of 4096 (the data's vocab x vocab transition
# table does not fit at the models' vocabularies).  rmsnorm forward / backward
# launches a step: a norm's forward once a microbatch, its backward once
TRAIN_MAIN = "gemma3-1b"
TRAIN_RUNS = {  # arch: (batch, seq, microbatches, steps, lr, warmup)
    TRAIN_MAIN: (4, 1024, 2, 8, 3e-3, 5),
    "xlstm-125m": (8, 128, 1, 6, 3e-3, 5),
}
TRAIN_LAUNCHES_PER_STEP = {TRAIN_MAIN: {"rmsnorm": 106, "rmsnorm_bwd": 106},
                           "xlstm-125m": {"rmsnorm": 13, "rmsnorm_bwd": 13}}
TRAIN_DATA_VOCAB = 4096
# card against CPU in float32 on the reduced configs: every gradient after one
# step, parameters after 3 AdamW steps
TRAIN_PARITY_ARCHS = ("gemma3-1b", "xlstm-125m", "zamba2-2.7b", "minicpm3-4b", "olmoe-1b-7b")
TRAIN_PARITY_TOL = 1e-4  # of each gradient tensor's largest entry; of the loss, relative
G_NOISE = 1e-5  # a nonzero float32 gradient below this is near-cancelling noise (AdamW)
# the training paths' rows x D: gemma3-1b's microbatch, a rank of its sharded
# step, xlstm-125m's batch
RMSNORM_BWD_SHAPES = ((2048, 1152), (1024, 1152), (1024, 768))
# the sharded substrate (slice 4b): gemma3-1b at full width and depth on a
# (2, 2) mesh of 4 ranks sharing the card (a gloo group exchanging through the
# host), the train phase's run (TRAIN_RUNS) for SHARDED_STEPS steps from the
# same seed and batches: each step's loss within 0.05 of the one-rank run's
# (the reference's bf16 cross-mesh bound, tests/test_distributed.py), the
# gradient norm within 1% over the first SHARDED_GNORM_STEPS steps, and at the
# first step (both runs at the same weights) each tensor kind's gradient norm
# (embed, attn.w_k, ... over the layers) within 1% too, so that a wrong sum
# over an axis in one small tensor cannot hide in the global norm.  The third
# step's norm is printed beside a control: the one-rank run with its batch cut
# into 4 microbatches instead of 2, the same steps with only their bf16
# roundings moved.  This run is chaotic in bf16 by its third step (lr 3e-3;
# the norm jumps 5.4 -> 12.4): any such perturbation, sharded or not, moves
# every tensor's gradient norm there by several percent alike, and in float32
# the sharded run's does not move (tools/sharded_divergence.py --float32)
SHARDED_MESH = {"data": 2, "model": 2}
CAPTURE_STEP = 2  # the sharded step whose schedules the capture phase holds
CAPTURE_CELLS = (("gemma3-1b", "train_4k", "single"), ("olmoe-1b-7b", "train_4k", "single"))
MATMUL_N = 8192
COPY_BYTES = 2 << 30
SHARDED_CONTROL_MICROBATCHES = 4
SHARDED_STEPS = 3
SHARDED_LOSS_TOL = 0.05
SHARDED_GNORM_RTOL = 0.01
SHARDED_GNORM_STEPS = 2
# olmoe-1b-7b's MoE layer at full width (64 experts top-8, d 2048, ff 1024)
# expert-parallel on (1, 4), float32: the scatter path at B 4 x S 512, the
# gather path at B 4 x S 1, against moe_apply on one rank (the reference
# test's bounds); at capacity factor 4 nothing drops, at the config's 1.25 and
# at 0.25 (the reference test's, where pairs do drop) the dropped pairs must
# equal a plain count from the routing
MOE_EP_SHAPES = {"scatter": (4, 512), "gather": (4, 1)}
MOE_EP_CAPACITY = {"config": None, "tight": 0.25}  # beside the dropless run
MOE_EP_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_EP_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
# pipeline_apply over 4 ranks: 8 tanh layers at d 2048, 8 microbatches of 16
# rows, float32, against the layers run in sequence on one rank: the output
# against the whole batch's, the gradients against the microbatches' summed
# in the pipeline's order (last microbatch first); summed over the whole
# batch at once instead, float32 sums of 128 rows differ by about 1e-5 of a
# layer's largest gradient, which the line reports
PIPE_LAYERS, PIPE_D, PIPE_MICRO, PIPE_MB = 8, 2048, 8, 16
PIPE_TOL = dict(rtol=1e-5, atol=1e-5)
# the remat policies on gemma3-1b's one-rank step (TRAIN_RUNS' batch): the
# forward of each block runs again in the backward, so rmsnorm's forward
# launches a step are 106 + 2 microbatches x 26 blocks x 2 norms = 210 under
# every policy but "none" (the final norm is outside the blocks); the backward
# stays 106
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")
REMAT_STEPS = 2
REMAT_LAUNCHES_PER_STEP = {p: {"rmsnorm": 106 if p == "none" else 210, "rmsnorm_bwd": 106}
                           for p in REMAT_POLICIES}
# sharded serving (slice 4d) on a (2, 2) mesh in float32, each run (arch,
# requests, prompt tokens, new tokens, how the prompt goes in): gemma3-1b and
# olmoe-1b-7b batched through the engine (the prompt a token a step, 8 of
# them: each step is ~130-250 gloo exchanges through the host), then
# gemma3-1b's one request past its 512-slot window (sequence-parallel), its
# prompt through one prefill (a step a token would take 504 steps of about
# 130 exchanges through the host); every step's logits against the one-rank
# run's
SERVE_MESH = {"data": 2, "model": 2}
SHARDED_SERVE_RUNS = (("gemma3-1b", 4, 8, 8, "engine"), (MAIN_ARCH, 4, 8, 8, "engine"),
                      ("gemma3-1b", 1, 504, 16, "prefill"))
SHARDED_SERVE_TOL = 1e-4
# partitioned compute for the Mamba2, mLSTM and MLA blocks (slice 4e), float32,
# 4 ranks on the card: zamba2-2.7b served through the engine (its Mamba2 blocks
# and shared block head-parallel) and minicpm3-4b through one prefill (MLA
# head-parallel; a token a step would take 32 steps of ~250 exchanges through
# the host); xlstm-125m trained BLOCK_TRAIN_STEPS steps (its mLSTM cells
# head-parallel, the sLSTM cells whole).  Each run is held at every step to a
# float64 anchor (the one-rank model with float64 parameters and products):
# no further from it than BLOCK_ANCHOR_FACTOR x the one-rank float32 run's own
# distance at that step, plus BLOCK_SERVE_TOL for logits, the test's relative
# 1e-4 for a gradient norm, BLOCK_LEAF_SLACK entries for a leaf's count of
# entries outside 1e-5 + 1e-5 |p|; after step 1 the leaf BLOCK_PLANTED_LEAF
# with its update undone must fail that bound.  Each case's peak beside the
# same work with those blocks replicated over model (whole on every rank)
BLOCK_SERVE_RUNS = (("zamba2-2.7b", 4, 8, 8, "engine"), ("minicpm3-4b", 4, 32, 8, "prefill"))
BLOCK_SERVE_TOL = 1e-5
BLOCK_ANCHOR_FACTOR = 2.0
BLOCK_LEAF_SLACK = 8  # entries: a small leaf's few near-zero gradients that rounding flips
BLOCK_PLANTED_LEAF = "blocks.0.cell.w_if"  # an mLSTM cell's gates, cut over model
BLOCK_TRAIN = ("xlstm-125m", 4, 64)  # arch, batch, seq: one microbatch, rows over data
BLOCK_TRAIN_STEPS = 2
BLOCK_TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 6}
BLOCK_TRAIN_TOL = {"loss": 1e-3, "grad_norm_rtol": 1e-4, "param_atol": 1e-5,
                   "param_rtol": 1e-5}  # the test's float32 bounds
BLOCK_TRAIN_DIR = Path("build") / "chip_smoke_blocks"
# the partial entry at olmoe's and gemma3-1b's head layouts, S 544 cut in
# PARTIAL_SLICES, the valid prefix PARTIAL_LENGTHS (200 leaves slices empty)
PARTIAL_HEADS = {"olmoe": (16, 16, 128), "gemma3_1b": (4, 1, 256)}
PARTIAL_SLICES = (2, 4)
PARTIAL_LENGTHS = (PROMPT_LEN + NEW_TOKENS, 200)
PARTIAL_CONTROLS = ("slice_dropped", "lse_ignored", "p_bf16", "acc_bf16")  # rejected

# torch.profiler on the card drops activity records now and then, in bursts
# that can span several sessions in a row (a session may lose a few of its
# launches or all of them; a long session can lose its first records).  A
# profile whose launches do not add up is made again, after a pause that
# grows, up to this many sessions in all.
PROFILE_ATTEMPTS = 8
PROFILE_PAUSE_S = 0.25


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call over back-to-back calls, by CUDA events."""
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


def in_spawned_process(fn, *args):
    """``fn(*args)`` in a spawned process of its own, which has its own CUDA
    context.  For the lockstep solvers' work, which runs last: after it
    (millions of small launches, the plain versions' among them), later
    profiles of other kernels on an H100 missed launches (20 calls seen as
    19, or none seen), so it runs where no profile follows it."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(fn, *args).result()


def launch_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call by CUDA events recorded right around it,
    one call at a time: for a kernel far longer than its dispatch, where the
    profiler dropped some of the launches it was given."""
    fn()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# torch.cuda._sleep ahead of a queued timing: ~0.1 ms at ~1.98 GHz, longer
# than a call's host dispatch
QUEUE_CYCLES = 200_000


def queued_ms(fn, iters: int = 3) -> float:
    """Median device ms of one call by CUDA events around it, queued behind
    ``torch.cuda._sleep``: the card is busy while the host dispatches the
    call, so the events time the kernel (and its launch), not the dispatch."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound_ms(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: bytes over HBM rate or ops over peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _attention_controls(q, k, v, length: int) -> dict:
    """Plain attention with one fault each, in bf16 like the kernel's output."""
    B, H, D = q.shape
    KV = k.shape[2]
    qh = q.float().reshape(B, KV, H // KV, D) * D ** -0.5
    kf, vf = k[:, :length].float(), v[:, :length].float()
    w = torch.softmax(torch.einsum("bgrd,bsgd->bgrs", qh, kf), dim=-1)

    def pv(weights):
        return torch.einsum("bgrs,bsgd->bgrd", weights, vf).reshape(B, H, D)

    acc = torch.zeros(B, KV, H // KV, D, dtype=torch.bfloat16, device=q.device)
    for j in range(length):  # accumulator kept in bf16, slot by slot
        acc = (acc.float() + w[..., j:j + 1] * vf[:, j, :, None, :]).to(torch.bfloat16)
    from repro_torch.kernels import ref
    return {
        # the reference attention_decode's rounding: a sound bf16 variant
        "p_bf16": pv(w.to(torch.bfloat16).float()).to(torch.bfloat16),
        "acc_bf16_serial": acc.reshape(B, H, D),
        "one_slot_dropped": ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                                     length - 1).to(torch.bfloat16),
    }


ATTENTION_CONTROLS = ("acc_bf16_serial", "one_slot_dropped")  # must be rejected


def _worst_ratio(out: torch.Tensor, want: torch.Tensor, tol: dict = BF16_TOL) -> float:
    """Largest |out - want| over the tolerance's limit; above 1 fails assert_close."""
    lim = tol["atol"] + tol["rtol"] * want.abs()
    return ((out.float() - want).abs() / lim).max().item()


def _device_rows(events) -> list:
    """The device events of a profile summed by kernel name: ``(name, µs,
    launches)``, the profiler's step annotation left out."""
    totals = {}
    for evt in events:
        name = evt.name()
        if str(evt.device_type()).endswith("CUDA") and not name.startswith("ProfilerStep"):
            us, n = totals.get(name, (0.0, 0))
            totals[name] = (us + evt.duration_ns() / 1e3, n + 1)
    return [(name, us, n) for name, (us, n) in totals.items()]


_ROWS_HELD = []  # whether this process has held _device_rows to key_averages()


def _averaged_rows(averages) -> list:
    """``_device_rows`` from the profiler's own key_averages()."""

    def device_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    return [(evt.key, device_us(evt), evt.count) for evt in averages
            if str(getattr(evt, "device_type", "")).endswith("CUDA")
            and not evt.key.startswith("ProfilerStep")]


def _profile_rows(prof) -> list:
    """A finished profile's device rows (``_device_rows``), summed from its
    raw events: key_averages() first builds every event into Python objects,
    which took ~0.15 ms an event, up to a minute for the 10^5 launches of
    a few decode steps or of one train step.  The first profile of a process
    is also read through key_averages(), and the two must agree."""
    rows = _device_rows(prof.profiler.kineto_results.events())
    if not _ROWS_HELD:
        want = {key: (us, n) for key, us, n in _averaged_rows(prof.key_averages())}
        got = {key: (us, n) for key, us, n in rows}
        if got.keys() != want.keys() or any(
                got[k][1] != want[k][1] or abs(got[k][0] - want[k][0]) > 1e-6 * want[k][0] + 1e-3
                for k in got):
            raise AssertionError(f"the profile's raw device events {sorted(got.items())[:8]} "
                                 f"differ from its key_averages() {sorted(want.items())[:8]}")
        _ROWS_HELD.append(True)
    return rows


def _profiled(warmup, run, host_ops: bool = True) -> tuple:
    """``(device rows, run's result)``: ``run()`` under torch.profiler after
    one warm-up cycle of ``warmup()`` whose events are dropped: a long
    session can miss its first records, so the measured calls come only
    after the tracer has run for a cycle.  The rows are ``_profile_rows``.
    ``host_ops=False`` records the device's activity alone (a train step's
    10^5 host ops)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    ready = []
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: ready.append(_profile_rows(p))) as prof:
        warmup()
        torch.cuda.synchronize()
        prof.step()
        out = run()
        torch.cuda.synchronize()
        prof.step()
    return ready[0], out


def _device_ms_per_launch(rows, names) -> tuple[list, dict]:
    """A profile's device rows ``(name, µs, count)`` (``_profiled``), longest
    first, and the mean device time per launch of each named kernel (None if
    it is absent)."""
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    per_kernel = {}
    for name in names:  # summed over the kernel's instantiations (rmsnorm: one per width class)
        mine = [(us, n) for key, us, n in rows if f"{name}_kernel" in key]
        n = sum(c for _, c in mine)
        per_kernel[name] = ({"device_ms_per_launch": sum(us for us, _ in mine) / 1e3 / n,
                             "launches": n} if n else None)
    return rows, per_kernel


def _gemv_controls(a: torch.Tensor, x: torch.Tensor, y_plain: torch.Tensor) -> dict:
    """The plain product with one fault each, in bf16 like the kernel's output."""
    M, K = a.shape
    vec = 16 // a.element_size()
    slabs = torch.einsum("msv,svn->smn", a.float().reshape(M, K // vec, vec),
                         x.float().reshape(K // vec, vec, x.shape[1]))  # one per 16-byte slab
    acc = torch.zeros_like(y_plain, dtype=torch.bfloat16)
    for part in slabs:  # the accumulator kept in bf16, one 16-byte slab at a time
        acc = (acc.float() + part).to(torch.bfloat16)
    return {"acc_bf16_per_slab": acc,
            "one_slab_dropped": (y_plain - slabs[K // vec // 2]).to(torch.bfloat16)}


def _profile_calls(calls: dict, operands: list, reps: int = 20,
                   attempts: int = PROFILE_ATTEMPTS, launch_rows: dict | None = None) -> dict:
    """Device ms per call of each labelled call, from one torch.profiler run.

    ``calls`` maps a label to a function of one operand: a kernel of the port
    (its label is the kernel's name) or ``"library"``, the PyTorch call it is held
    against.  The calls take turns, each on the next of ``operands``, so
    with copies enough that the L2 cannot hold them every call finds its
    operand cold.  Device rows of the port's kernels are matched by name,
    memsets (the kernels' counters) apart, and every other device row is the
    library call's.  Also returns ``"memset"``: memset ms per profiled call of
    a port kernel.  ``launch_rows``, if given, receives for each port kernel
    its device rows of the returned profile: kernel, ms per launch, launches
    per call.  A run in which the profiler missed launches (it can drop
    activity records) is made again after a pause, up to ``attempts`` runs in
    all.
    """
    ours = [k for k in calls if k != "library"]

    def warmup():
        for fn in calls.values():
            fn(operands[0])

    def run():
        j = 0
        for _ in range(reps):
            for fn in calls.values():
                fn(operands[j % len(operands)])
                j += 1

    warmup()  # outside the profile too: builds, plans, allocator
    seen = None
    for attempt in range(attempts):
        time.sleep(PROFILE_PAUSE_S * attempt)
        torch.cuda.synchronize()
        found, _ = _profiled(warmup, run)
        rows, _ = _device_ms_per_launch(found, ())
        out = {k: 0.0 for k in calls}
        out["memset"] = 0.0
        if launch_rows is not None:
            launch_rows.clear()
        seen = {}
        total_us = {}
        for key, us, n in rows:
            mine = next((k for k in ours if f"::{k}_kernel<" in key), None)
            if mine is not None:  # a kernel may show under more than one key
                seen[mine] = seen.get(mine, 0) + n
                total_us[mine] = total_us.get(mine, 0.0) + us
                if launch_rows is not None:
                    launch_rows.setdefault(mine, []).append(
                        {"kernel": key.replace("(anonymous namespace)::", "").split("(")[0],
                         "device_ms_per_launch": us / 1e3 / n,
                         "launches_per_call": n / reps})
            elif "memset" in key.lower():
                out["memset"] += us / 1e3 / (reps * len(ours))
            elif "library" in calls:
                out["library"] += us / 1e3 / reps
            else:
                raise AssertionError(f"unexpected device work {key!r} in a profile of {ours}")
        for k in seen:
            out[k] = total_us[k] / 1e3 / seen[k]
        if all(seen.get(k) == reps for k in ours) and out.get("library", 1.0) > 0.0:
            return out
    raise AssertionError(f"in {attempts} profiles of {reps} calls the profiler saw "
                         f"{seen} launches of {ours}; the last profile's device rows: "
                         f"{[(key[:100], n) for key, _, n in rows]}")


def _rates(nbytes: int, b_ms: float, ms: float) -> dict:
    return {"achieved_TBps": nbytes / (ms * 1e-3) / 1e12, "bound_share": b_ms / ms}


def _blocks_per_sm(kernel: str, plan, dtype, N: int) -> int:
    from repro_torch.kernels.gemv import blocks_per_sm
    from repro_torch.kernels.gemv_tiles import blocks_per_sm as tiles_blocks_per_sm

    return (blocks_per_sm if kernel == "gemv" else tiles_blocks_per_sm)(plan, dtype, N, 1)


def _plan_line(kernel: str, plan, per_sm: int, sms: int) -> dict:
    """The plan of a launch as the phase line prints it (A = w.T layout).

    ``blocks``: gemv launches one block an item, gemv_tiles a persistent grid
    of what the card holds at once.
    """
    from repro_torch.kernels.gemv import STAGE_BYTES, STAGES

    return {"rows": plan.rows, "group": plan.group, "splits": plan.splits,
            "slice_k": plan.slice_k, "items": plan.items,
            "blocks": plan.items if kernel == "gemv" else min(plan.items, per_sm * sms),
            "blocks_per_sm": per_sm, "stages": STAGES, "stage_bytes": STAGE_BYTES,
            "in_flight_bytes_per_sm": per_sm * (STAGES - 1) * STAGE_BYTES}


def _gemv_kernel_checks(gen: torch.Generator) -> dict:
    """gemv and gemv_tiles against the plain product, in both layouts of A, at
    the reference's sweeps and at the collective's shard shapes; the exact
    owner_served schedules; times, bounds and device time per launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemv import TILE_ROWS, gemv_cuda, gemv_plan, sm_count
    from repro_torch.kernels.gemv_tiles import (GROUP, gemv_tiles_cuda, remote_first_order,
                                                tile_plan)

    tol = {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL}

    def operands(M, K, N, dtype, layout):
        a = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        if layout == "w.T":  # a view of a row-major w [K, M], as the collectives pass it
            a = a.T.contiguous().T
        return a, torch.randn(K, N, generator=gen, device="cuda").to(dtype)

    checks = []

    def check(kernel, a, x, layout, **schedule):
        if kernel == "gemv":
            y = gemv_cuda(a, x)
        else:
            y, owner_served = gemv_tiles_cuda(a, x, **schedule)
        y_plain = ref.gemv_ref(a.float(), x.float())
        torch.testing.assert_close(y.float(), y_plain, **tol[a.dtype])
        entry = {"kernel": kernel, "M_K_N": [*a.shape, x.shape[1]], "layout": layout,
                 "dtype": str(a.dtype).removeprefix("torch."), **schedule,
                 "max_abs_err": (y.float() - y_plain).abs().max().item(),
                 "worst_ratio": _worst_ratio(y, y_plain, tol[a.dtype])}
        if kernel == "gemv_tiles":
            n_dev, my_dev = schedule["n_dev"], schedule["my_dev"]
            _, tiles_per_dev = tile_plan(a.shape[0], n_dev, my_dev, schedule.get("bm", 64))
            expect = [t // tiles_per_dev for t in remote_first_order(n_dev, my_dev, tiles_per_dev)]
            if owner_served.tolist() != expect:
                raise AssertionError(f"owner_served {owner_served.tolist()} != {expect}")
        checks.append(entry)

    for layout in ("row_major", "w.T"):
        for M, K, N in GEMV_SWEEP:
            for dtype in (torch.float32, torch.bfloat16):
                check("gemv", *operands(M, K, N, dtype, layout), layout)
        for n_dev, my_dev in GEMV_SCHEDULES:
            check("gemv_tiles", *operands(256, 1024, 1, torch.float32, layout), layout,
                  n_dev=n_dev, my_dev=my_dev, bm=32)
        for B, K, N, dt in ALLREDUCE_SHAPES.values():  # a rank's A = w_shard.T
            a, x = operands(N, K // RANKS, B, getattr(torch, dt), layout)
            check("gemv", a, x, layout)
            for my_dev in range(RANKS):
                check("gemv_tiles", a, x, layout, n_dev=RANKS, my_dev=my_dev)

    sms = sm_count(torch.device("cuda"))
    timings, extra = {}, {}
    for name, (B, K, N, dt) in ALLREDUCE_SHAPES.items():
        a, x = operands(N, K // RANKS, B, getattr(torch, dt), "w.T")
        M, Kr = a.shape
        nbytes = (M * Kr + Kr * B + M * B) * a.element_size()
        bm, tiles_per_dev = tile_plan(M, RANKS, 0, 64)
        n_tiles = M // bm
        plans = {"gemv": gemv_plan(M, Kr, B, a.element_size(), TILE_ROWS, sms),
                 "gemv_tiles": gemv_plan(M, Kr, B, a.element_size(), bm, sms, group=GROUP,
                                         tiles_per_dev=tiles_per_dev)}
        calls = {"gemv": lambda aa: gemv_cuda(aa, x),
                 "gemv_tiles": lambda aa: gemv_tiles_cuda(aa, x, n_dev=RANKS, my_dev=0),
                 "library": lambda aa: torch.matmul(aa, x)}
        warm = _profile_calls(calls, [a])
        library_ms = time_ms(lambda: torch.matmul(a, x))
        bounds = {"gemv": bound_ms(nbytes, 2 * M * Kr * B, dt),
                  "gemv_tiles": bound_ms(nbytes + 4 * n_tiles, 2 * M * Kr * B, dt)}
        timings[name] = {}
        for kernel, plan in plans.items():
            per_sm = _blocks_per_sm(kernel, plan, a.dtype, B)
            b_ms, b_by = bounds[kernel]
            timings[name][kernel] = {
                "shape": {"A": [M, Kr], "x": [Kr, B]}, "dtype": dt, "tiles": n_tiles,
                "ms": time_ms(lambda k=kernel: calls[k](a)),
                "plain_ms": time_ms(lambda: ref.gemv_ref(a, x)) if kernel == "gemv" else
                time_ms(lambda: ref.gemv_tiles_ref(a, x, RANKS, 0)),
                "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                "device_ms": warm[kernel], "library_device_ms": warm["library"],
                "memset_device_ms_per_call": warm["memset"],
                **_rates(nbytes, b_ms, warm[kernel]),
                "plan": _plan_line(kernel, plan, per_sm, sms),
            }
        if name != "gemma3_27b_tp4":
            continue
        # cold: every call reads a copy of A that the three calls before it
        # pushed out of the 50 MB L2 (4 copies, 231 MB), as a decode step would
        copies = [a] + [a.T.clone().T for _ in range(COLD_COPIES - 1)]
        cold = _profile_calls(calls, copies)
        for kernel in plans:
            timings[name][kernel].update({
                "cold_device_ms": cold[kernel], "library_cold_device_ms": cold["library"],
                **{f"cold_{k}": v for k, v in _rates(nbytes, bounds[kernel][0],
                                                     cold[kernel]).items()}})
        a_rm = a.contiguous()  # gemv's row-major layout, once
        timings[name]["gemv"]["row_major_device_ms"] = _profile_calls(
            {"gemv": lambda aa: gemv_cuda(aa, x)}, [a_rm])["gemv"]
        del a_rm
        # the measured variants, cold: box rows (gemv) or tiles an item
        # (gemv_tiles) against the items an SM the plan aims at
        variants = []
        sweeps = [({"gemv": {"rows": r}, "gemv_tiles": {"group": g}}, {"items_per_sm": i})
                  for r, g in ((64, 1), (128, 2), (256, 4)) for i in (1, 2, 3, 4, 8)]
        for shape_kw, plan_kw in sweeps:
            for kernel in ("gemv", "gemv_tiles"):
                if kernel == "gemv":
                    plan = gemv_plan(M, Kr, B, a.element_size(), shape_kw[kernel]["rows"],
                                     sms, **plan_kw)
                    fn = (lambda aa, p=plan: gemv_cuda(aa, x, plan=p))
                else:
                    plan = gemv_plan(M, Kr, B, a.element_size(), bm, sms,
                                     tiles_per_dev=tiles_per_dev, **shape_kw[kernel],
                                     **plan_kw)
                    fn = (lambda aa, p=plan: gemv_tiles_cuda(aa, x, n_dev=RANKS, my_dev=0,
                                                             plan=p))
                variants.append({
                    "kernel": kernel, **shape_kw[kernel], **plan_kw,
                    "cold_device_ms": _profile_calls({kernel: fn}, copies)[kernel],
                    "plan": _plan_line(kernel, plan, _blocks_per_sm(kernel, plan, a.dtype, B),
                                       sms)})
        # a quarter of the shard's K, 14.5 MB, held in the L2 between calls:
        # what the kernels and cuBLAS reach when DRAM is out of the way
        a_l2 = a[:, :Kr // 4]
        x_l2 = x[:Kr // 4].contiguous()
        l2 = _profile_calls({"gemv": lambda aa: gemv_cuda(aa, x_l2),
                             "gemv_tiles": lambda aa: gemv_tiles_cuda(aa, x_l2, n_dev=RANKS,
                                                                      my_dev=0),
                             "library": lambda aa: torch.matmul(aa, x_l2)}, [a_l2])
        extra["gemv_l2_resident"] = {"A": list(a_l2.shape), "bytes": a_l2.numel() * 2, **{
            k: {"device_ms": ms, "TBps": a_l2.numel() * 2 / (ms * 1e-3) / 1e12}
            for k, ms in l2.items() if k != "memset"}}
        extra["gemv_variants"] = variants
        del copies
        y_plain = ref.gemv_ref(a.float(), x.float())
        controls = {c: {"max_abs_err": (out.float() - y_plain).abs().max().item(),
                        "worst_ratio": _worst_ratio(out, y_plain)}
                    for c, out in _gemv_controls(a, x, y_plain).items()}
        passed = [c for c in GEMV_CONTROLS if controls[c]["worst_ratio"] <= 1.0]
        if passed:
            raise AssertionError(f"tolerance {BF16_TOL} lets faulty gemv controls {passed} pass")
    out = {"gemv_checks": checks, "gemv_controls": controls, **extra}
    for kernel in ("gemv", "gemv_tiles"):
        out[kernel] = {**timings["gemma3_27b_tp4"][kernel],
                       "max_abs_err": max(c["max_abs_err"] for c in checks
                                          if c["kernel"] == kernel),
                       "at_table1": timings["table1"][kernel]}
    return out


def _attention_copies(gen: torch.Generator, B: int, H: int, KV: int, D: int, S: int,
                      copies: int) -> tuple:
    """bf16 q [B, H, D] and ``copies`` of (k, v) [B, S, KV, D], each beside
    SDPA's layout of it, [B, KV, S, D]."""

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = randn(B, H, D)
    out = []
    for _ in range(copies):
        k, v = randn(B, S, KV, D), randn(B, S, KV, D)
        out.append((k, v, k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()))
    return q, out


def _attention_device_ms(q, copies, length: int, plan=None) -> dict:
    """Device ms per call of the kernel and of SDPA (``enable_gqa``) in one
    profile, each call on the next of ``copies``."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    q4 = q[:, :, None, :].contiguous()  # [B, H, 1, D]
    return _profile_calls(
        {"decode_attention": lambda c: decode_attention_cuda(q, c[0], c[1], length, plan=plan),
         "library": lambda c: F.scaled_dot_product_attention(q4, c[2], c[3], enable_gqa=True)},
        copies)


def _attention_plan_line(plan, H: int, KV: int, D: int, B: int, sms: int) -> dict:
    from repro_torch.kernels.decode_attention import blocks_per_sm

    per_sm = blocks_per_sm(plan, H, KV, D, torch.bfloat16)
    return {"chunk": plan.chunk, "splits": plan.splits, "block": plan.block,
            "ctas": plan.ctas(B, KV), "blocks_per_sm": per_sm,
            "waves": plan.ctas(B, KV) / (per_sm * sms)}


def _attention_sweep(gen: torch.Generator, sms: int) -> dict:
    """The kernel at the head layouts of ATTENTION_HEADS (B 4, S = length =
    1024, bf16): checked against the plain version, then warm and cold device
    time beside SDPA's under the default plan, and cold under chunk variants."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plan

    B, S = REQUESTS, 1024
    out = {}
    for name, (H, KV, D) in ATTENTION_HEADS.items():
        nbytes = 2 * B * S * KV * D * 2
        q, copies = _attention_copies(gen, B, H, KV, D, S, -(-int(ATTENTION_COLD_BYTES) // nbytes))
        k, v = copies[0][:2]
        o = decode_attention_cuda(q, k, v, S)
        o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), S)
        torch.testing.assert_close(o.float(), o_plain, **BF16_TOL)
        plan = decode_attention_plan(B, KV, H // KV, D, 2, S, sms)
        warm, cold = _attention_device_ms(q, copies[:1], S), _attention_device_ms(q, copies, S)
        b_ms, b_by = bound_ms(nbytes + 2 * q.numel() * 2, 4 * B * H * S * D, "bfloat16")
        variants = []
        for chunk in (16, 64, 256):
            p = decode_attention_plan(B, KV, H // KV, D, 2, S, sms, chunk=chunk)
            variants.append({**_attention_plan_line(p, H, KV, D, B, sms), "cold_device_ms":
                             _attention_device_ms(q, copies, S, p)["decode_attention"]})
        out[name] = {"H_KV_D": [H, KV, D], "rep": H // KV, "B": B, "S": S, "copies": len(copies),
                     "worst_ratio": _worst_ratio(o, o_plain), "bound_ms": b_ms, "bound_by": b_by,
                     "device_ms": warm["decode_attention"], "library_device_ms": warm["library"],
                     "cold_device_ms": cold["decode_attention"],
                     "library_cold_device_ms": cold["library"],
                     "memset_device_ms_per_call": warm["memset"],
                     "plan": _attention_plan_line(plan, H, KV, D, B, sms), "variants": variants}
        del q, copies
    return out


def _rmsnorm_at(gen: torch.Generator, d: int, rows: int = REQUESTS) -> dict:
    """rmsnorm at a path's shape, x [rows, 1, d] bf16 (a serve path's decode
    batch by default): checked against the
    plain version, timed by events beside the plain version and F.rms_norm,
    and by device time per launch in one profile with F.rms_norm and the
    empty kernel (the launch floor)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.empty import empty_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plan

    x = torch.randn(rows, 1, d, generator=gen, device="cuda").to(torch.bfloat16)
    g = (torch.randn(d, generator=gen, device="cuda") * 0.2).to(torch.bfloat16)
    y = rmsnorm_cuda(x, g)
    y_plain = ref.rmsnorm_ref(x.float(), g.float())
    torch.testing.assert_close(y.float(), y_plain, **BF16_TOL)
    w = (1.0 + g.float()).to(torch.bfloat16)  # F.rms_norm scales by weight, not 1 + weight
    b_ms, b_by = bound_ms(2 * x.numel() * 2 + g.numel() * 2, 5 * x.numel(), "float32")
    rms = {
        "shape": list(x.shape), "dtype": "bfloat16",
        "vectors_per_thread": rmsnorm_plan(d, x.element_size()),
        "max_abs_err": (y.float() - y_plain).abs().max().item(),
        "ms": time_ms(lambda: rmsnorm_cuda(x, g)),
        "plain_ms": time_ms(lambda: ref.rmsnorm_ref(x, g)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (d,), weight=w, eps=1e-6)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    same_run = _profile_calls(
        {"rmsnorm": lambda xx: rmsnorm_cuda(xx, g),
         "empty": lambda xx: empty_cuda(xx.device),
         "library": lambda xx: F.rms_norm(xx, (d,), weight=w, eps=1e-6)}, [x])
    floor = same_run["empty"]
    mine = same_run["rmsnorm"]
    rms.update(device_ms=mine, library_device_ms=same_run["library"],
               launch_floor_device_ms=floor,
               reaches_half_of_max_bound_and_floor=mine <= 2 * max(b_ms, floor))
    return rms


def _dgamma_bf16_accumulator(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """The faulty control of the backward: dgamma summed over rows with a
    bf16 accumulator, row by row."""
    x32 = x.float().reshape(-1, x.shape[-1])
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    prod = dy.float().reshape(x32.shape) * (x32 * r)
    acc = torch.zeros(x.shape[-1], dtype=torch.bfloat16, device=x.device)
    for row in prod:
        acc = (acc.float() + row).to(torch.bfloat16)
    return acc


def _rmsnorm_bwd_at(gen: torch.Generator, rows: int, d: int) -> dict:
    """The rmsnorm backward at a training path's shape, x, g, dy [rows, d]
    bf16: checked against its plain version (dx and dgamma), the same bits
    over 5 launches, a faulty control (a bf16 dgamma accumulator) the
    tolerance must reject, the tickets back at 0; timed by events beside the
    plain version and the backward of F.rms_norm with weight 1 + gamma
    (autograd, the same dx and dgamma), and by device time per call of both,
    and of each launch, in one profile."""
    from repro_torch.kernels.gemv import sm_count
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda, rmsnorm_bwd_plan, rmsnorm_bwd_ref,
                                             rmsnorm_bwd_workspace)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = randn(rows, d).to(torch.bfloat16)
    g = (randn(d) * 0.2).to(torch.bfloat16)
    dy = randn(rows, d).to(torch.bfloat16)
    dx, dg = rmsnorm_bwd_cuda(x, g, dy)
    want_dx, want_dg = rmsnorm_bwd_ref(x.float(), g.float(), dy.float())
    torch.testing.assert_close(dx.float(), want_dx, **BF16_TOL)
    torch.testing.assert_close(dg.float(), want_dg, **BF16_TOL)
    for _ in range(5):
        again = rmsnorm_bwd_cuda(x, g, dy)
        if not (torch.equal(again[0], dx) and torch.equal(again[1], dg)):
            raise AssertionError(f"rmsnorm backward [{rows}, {d}]: bits differ between launches")
    _, tickets = rmsnorm_bwd_workspace(x.device, torch.cuda.current_stream().cuda_stream)
    if tickets.tolist() != [0, 0]:
        raise AssertionError(f"rmsnorm backward [{rows}, {d}]: tickets {tickets.tolist()} not "
                             f"back at 0 after a call")
    control = _worst_ratio(_dgamma_bf16_accumulator(x, g, dy), want_dg)
    if control <= 1.0:
        raise AssertionError(f"tolerance {BF16_TOL} lets a bf16 dgamma accumulator pass "
                             f"(worst ratio {control})")
    xr = x.detach().clone().requires_grad_(True)
    wr = (1.0 + g.float()).to(torch.bfloat16).requires_grad_(True)
    y_lib = F.rms_norm(xr, (d,), weight=wr, eps=1e-6)

    def library(_=None):
        return torch.autograd.grad(y_lib, (xr, wr), dy, retain_graph=True)

    lib_dx, lib_dw = library()
    # x, g and dy read once, dx written once; gamma read and dgamma written once
    nbytes = 3 * rows * d * 2 + 2 * d * 2
    b_ms, b_by = bound_ms(nbytes, 12 * rows * d, "float32")
    launch_rows = {}
    same_run = _profile_calls({"rmsnorm_bwd": lambda _: rmsnorm_bwd_cuda(x, g, dy),
                               "library": library}, [None], launch_rows=launch_rows)
    plan = rmsnorm_bwd_plan(rows, d, 2, sm_count(x.device))
    return {
        "shape": [rows, d], "dtype": "bfloat16",
        "plan": {**plan.__dict__, "threads": plan.threads(d, 2),
                 "workspace_bytes": plan.ctas * d * 4 + 8},
        "device_ms_by_launch": launch_rows["rmsnorm_bwd"],
        "max_abs_err": max((dx.float() - want_dx).abs().max().item(),
                           (dg.float() - want_dg).abs().max().item()),
        "worst_ratio_dx": _worst_ratio(dx, want_dx), "worst_ratio_dgamma": _worst_ratio(dg, want_dg),
        "bits_repeat": 5, "control_bf16_dgamma_accumulator_worst_ratio": control,
        "library_worst_ratio_dx": _worst_ratio(lib_dx, want_dx),
        "library_worst_ratio_dgamma": _worst_ratio(lib_dw, want_dg),
        "ms": time_ms(lambda: rmsnorm_bwd_cuda(x, g, dy)),
        "plain_ms": time_ms(lambda: rmsnorm_bwd_ref(x, g, dy)),
        "library_ms": time_ms(library),
        "bound_ms": b_ms, "bound_by": b_by,
        "device_ms": same_run["rmsnorm_bwd"], "library_device_ms": same_run["library"],
        **_rates(nbytes, b_ms, same_run["rmsnorm_bwd"]),
    }


def _rmsnorm_bwd_checks(gen: torch.Generator) -> list:
    """The backward against its plain version in float32 at every width the
    train_parity configs' norms take (d_model, MLA's latent ranks), 48 rows
    (2 x 24 tokens); two calls give the same bits."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_bwd_ref

    widths = set()
    for arch in TRAIN_PARITY_ARCHS:
        cfg = reduced(get_config(arch))
        widths.add(cfg.d_model)
        if cfg.attn_kind == "mla":
            widths.update(r for r in (cfg.mla_kv_rank, cfg.mla_q_rank) if r)
    out = []
    for d in sorted(widths):
        x = torch.randn(48, d, generator=gen, device="cuda")
        g = torch.randn(d, generator=gen, device="cuda") * 0.2
        dy = torch.randn(48, d, generator=gen, device="cuda")
        dx, dg = rmsnorm_bwd_cuda(x, g, dy)
        want_dx, want_dg = rmsnorm_bwd_ref(x, g, dy)
        torch.testing.assert_close(dx, want_dx, **F32_TOL)
        torch.testing.assert_close(dg, want_dg, **F32_TOL)
        again = rmsnorm_bwd_cuda(x, g, dy)
        if not (torch.equal(again[0], dx) and torch.equal(again[1], dg)):
            raise AssertionError(f"rmsnorm backward D {d} float32: bits differ between calls")
        out.append({"D": d, "rows": 48, "dtype": "float32",
                    "worst_ratio_dx": _worst_ratio(dx, want_dx, F32_TOL),
                    "worst_ratio_dgamma": _worst_ratio(dg, want_dg, F32_TOL)})
    return out


def _block_norm_cases(ranks_only: bool = False) -> set:
    """The rmsnorm calls of the sharded_blocks phase, float32, derived from
    BLOCK_SERVE_RUNS, BLOCK_TRAIN, their meshes and the configs: ``{(entry,
    rows, D)}``, entry "forward" or "backward", on one rank and (alone with
    ``ranks_only``) on each rank of the mesh.  A norm sees its block's tokens:
    the rank's rows of the batch (cut over data where they divide), times the
    prompt at a prefill, one at a decode step (the final norm of a prefill
    sees the last token); D is d_model, and MLA's latent ranks (the latents
    computed whole on every rank)."""
    from repro_torch.configs import get_config

    out = set()
    for arch, B, P, n_new, how in BLOCK_SERVE_RUNS:
        cfg = get_config(arch)
        widths = {cfg.d_model}
        if cfg.attn_kind == "mla":
            widths.update(r for r in (cfg.mla_kv_rank, cfg.mla_q_rank) if r)
        for d in (SERVE_MESH["data"],) if ranks_only else (1, SERVE_MESH["data"]):
            rows = B // d if B % d == 0 else B
            out.update(("forward", rows, w) for w in widths)
            if how == "prefill":
                out.update(("forward", rows * P, w) for w in widths)
    arch, batch, seq = BLOCK_TRAIN
    width = get_config(arch).d_model
    for d in (SHARDED_MESH["data"],) if ranks_only else (1, SHARDED_MESH["data"]):
        out.update((entry, batch // d * seq, width) for entry in ("forward", "backward"))
    return out


def _block_norm_checks(gen: torch.Generator) -> list:
    """rmsnorm and its backward in float32 at the sharded_blocks phase's
    shapes (:func:`_block_norm_cases`) against their plain versions at
    F32_TOL, two calls giving the same bits; the plain version on the inputs
    rounded to bf16 (forward) and a bf16 dgamma accumulator (backward) are
    faulty controls the tolerance must reject."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda, rmsnorm_bwd_ref, rmsnorm_cuda,
                                             rmsnorm_ref)

    out = []
    for entry, rows, d in sorted(_block_norm_cases()):
        x = torch.randn(rows, d, generator=gen, device="cuda")
        g = torch.randn(d, generator=gen, device="cuda") * 0.2
        if entry == "forward":
            got, want = (rmsnorm_cuda(x, g),), (rmsnorm_ref(x, g),)
            again = (rmsnorm_cuda(x, g),)
            control = rmsnorm_ref(x.bfloat16().float(), g.bfloat16().float())
        else:
            dy = torch.randn(rows, d, generator=gen, device="cuda")
            got, want = rmsnorm_bwd_cuda(x, g, dy), rmsnorm_bwd_ref(x, g, dy)
            again = rmsnorm_bwd_cuda(x, g, dy)
            control = _dgamma_bf16_accumulator(x, g, dy)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **F32_TOL)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"rmsnorm {entry} [{rows}, {d}] float32: bits differ")
        control_ratio = _worst_ratio(control, want[-1], F32_TOL)
        if control_ratio <= 1.0:
            raise AssertionError(f"rmsnorm {entry} [{rows}, {d}]: F32_TOL lets the faulty "
                                 f"control pass (worst ratio {control_ratio})")
        out.append({"entry": entry, "rows": rows, "D": d, "dtype": "float32",
                    "worst_ratio": max(_worst_ratio(a, w, F32_TOL) for a, w in zip(got, want)),
                    "control_worst_ratio": control_ratio})
    return out


def _rmsnorm_checks(gen: torch.Generator) -> list:
    """rmsnorm against its plain version at every width the port's norms
    take (each config's d_model, MLA's latent ranks), in bf16 and float32;
    two launches give the same bits."""
    from repro_torch.configs import REGISTRY, get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    widths = set()
    for arch in REGISTRY:
        cfg = get_config(arch)
        widths.add(cfg.d_model)
        if cfg.attn_kind == "mla":
            widths.update(r for r in (cfg.mla_kv_rank, cfg.mla_q_rank) if r)
    out = []
    for d in sorted(widths):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            x = torch.randn(REQUESTS, 1, d, generator=gen, device="cuda").to(dtype)
            g = (torch.randn(d, generator=gen, device="cuda") * 0.2).to(dtype)
            y_plain = ref.rmsnorm_ref(x.float(), g.float())
            y = rmsnorm_cuda(x, g)
            torch.testing.assert_close(y.float(), y_plain, **tol)
            if not torch.equal(rmsnorm_cuda(x, g), y):
                raise AssertionError(f"rmsnorm D {d} {dtype}: bits differ between two launches")
            out.append({"D": d, "dtype": str(dtype).removeprefix("torch."),
                        "max_abs_err": (y.float() - y_plain).abs().max().item(),
                        "worst_ratio": _worst_ratio(y, y_plain, tol)})
    return out


def _attention_path(gen: torch.Generator, H: int, KV: int, D: int, S: int) -> dict:
    """decode_attention at a serve path's head layout (B 4, bf16, cache of S
    slots): checked against the plain version at lengths 1, S/2 and S, timed
    at length S by events beside the plain version and SDPA, and by device
    time per launch beside SDPA in one profile, warm and cold (K and V
    rotated over copies that exceed twice the L2)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plan
    from repro_torch.kernels.gemv import sm_count

    nbytes_kv = 2 * REQUESTS * S * KV * D * 2
    q, copies = _attention_copies(gen, REQUESTS, H, KV, D, S,
                                  -(-int(ATTENTION_COLD_BYTES) // nbytes_kv))
    k, v, k4, v4 = copies[0]
    checks = []
    for length in (1, S // 2, S):
        o = decode_attention_cuda(q, k, v, length)
        o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), length)
        torch.testing.assert_close(o.float(), o_plain, **BF16_TOL)
        checks.append({"length": length, "max_abs_err": (o.float() - o_plain).abs().max().item(),
                       "worst_ratio": _worst_ratio(o, o_plain)})
    q4 = q[:, :, None, :].contiguous()
    o_lib = F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)[:, :, 0]
    torch.testing.assert_close(o_lib.float(), o_plain, **BF16_TOL)
    nbytes = (2 * q.numel() + 2 * REQUESTS * S * KV * D) * 2
    b_ms, b_by = bound_ms(nbytes, 4 * REQUESTS * H * S * D, "bfloat16")
    warm = _attention_device_ms(q, copies[:1], S)
    cold = _attention_device_ms(q, copies, S)
    sms = sm_count(q.device)
    return {
        "shape": {"q": list(q.shape), "k": list(k.shape), "length": S}, "rep": H // KV,
        "checks": checks, "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": time_ms(lambda: decode_attention_cuda(q, k, v, S)),
        "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, S)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                     enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "device_ms": warm["decode_attention"], "library_device_ms": warm["library"],
        "cold_device_ms": cold["decode_attention"], "library_cold_device_ms": cold["library"],
        "copies": len(copies), "memset_device_ms_per_call": warm["memset"],
        **_rates(nbytes, b_ms, warm["decode_attention"]),
        "plan": _attention_plan_line(decode_attention_plan(REQUESTS, KV, H // KV, D, 2, S, sms),
                                     H, KV, D, REQUESTS, sms),
    }


def _partials(q, k, v, length: int, R: int, partial) -> list:
    """``partial`` (the kernel's entry or its plain version) on each of R
    consecutive slices of S: ``(o, lse, valid slots)``."""
    L = k.shape[1] // R
    out = []
    for r in range(R):
        n = min(max(length - r * L, 0), L)
        ks, vs = k[:, r * L:(r + 1) * L].contiguous(), v[:, r * L:(r + 1) * L].contiguous()
        out.append((*partial(q, ks, vs, n), n))
    return out


def _held_slices(got: list, want: list, tol: dict, what: str) -> float:
    """Each slice's ``(o, lse)`` from the kernel against its plain version
    (:func:`_partials`), an empty slice exactly o = 0 and lse below -1e38:
    the worst ratio of o to the tolerance."""
    worst = 0.0
    for (o, lse, n), (o_p, lse_p, _) in zip(got, want):
        torch.testing.assert_close(o, o_p, **tol)
        torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
        if n == 0 and not (torch.equal(o, torch.zeros_like(o)) and (lse < -1e38).all()):
            raise AssertionError(f"{what}: an empty slice wrote o != 0 or a finite lse")
        worst = max(worst, _worst_ratio(o, o_p, tol))
    return worst


def _partial_faulty(q, k, v, length: int, at: str) -> tuple:
    """A faulty control of the partial entry: its plain version with the
    softmax weights (``at="p"``) or the output accumulator (``at="acc"``)
    rounded to bf16, as a kernel that kept either in bf16 would."""
    from repro_torch.kernels.decode_attention import decode_attention_partial_ref

    o, lse = decode_attention_partial_ref(q.float(), k.float(), v.float(), length)
    if length == 0:
        return o, lse
    if at == "acc":
        return o.to(torch.bfloat16).float(), lse
    B, H, D = q.shape
    KV = k.shape[2]
    qh = q.float().reshape(B, KV, H // KV, D) * D ** -0.5
    s = torch.einsum("bgrd,bsgd->bgrs", qh, k[:, :length].float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bgrs,bsgd->bgrd", p.to(torch.bfloat16).float(), v[:, :length].float())
    return (o / p.sum(dim=-1)[..., None]).reshape(B, H, D), lse


def _attention_partial_checks(gen: torch.Generator) -> dict:
    """decode_attention's partial entry against its plain version: bf16 and
    float32 inputs at olmoe's and gemma3-1b's head layouts over
    PARTIAL_SLICES of S 544; the float32 output (accumulated in float32
    from either input) and the combined result held at F32_TOL; faulty
    combines and bf16 weights or accumulators rejected."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (combine_partials,
                                                      decode_attention_partial_cuda,
                                                      decode_attention_partial_ref)

    S, checks, controls, tol = PROMPT_LEN + NEW_TOKENS, [], {}, F32_TOL
    for name, (H, KV, D) in PARTIAL_HEADS.items():
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(shape, generator=gen, device=gen.device).to(dt)
                       for shape in ((REQUESTS, H, D), (REQUESTS, S, KV, D), (REQUESTS, S, KV, D)))
            for R in PARTIAL_SLICES:
                for length in PARTIAL_LENGTHS:
                    got = _partials(q, k, v, length, R, decode_attention_partial_cuda)
                    want = _partials(q.float(), k.float(), v.float(), length, R,
                                     decode_attention_partial_ref)
                    worst = _held_slices(got, want, tol, f"{name} {dtype}")
                    os_ = torch.stack([o for o, _, _ in got])
                    lses = torch.stack([lse for _, lse, _ in got])
                    whole = ref.decode_attention_ref(q.float(), k.float(), v.float(), length)
                    joined = combine_partials(os_, lses)
                    torch.testing.assert_close(joined, whole, **tol)
                    checks.append({"heads": name, "dtype": dtype, "slices": R, "length": length,
                                   "empty_slices": sum(n == 0 for *_, n in got),
                                   "slice_worst_ratio": worst,
                                   "combined_worst_ratio": _worst_ratio(joined, whole, tol),
                                   "combined_max_abs_err": (joined - whole).abs().max().item()})
                    if (dtype, R, length) == ("bfloat16", 4, S):
                        faulty = {"slice_dropped": combine_partials(os_[:-1], lses[:-1]),
                                  "lse_ignored": os_.mean(dim=0)}
                        controls[name] = {c: _worst_ratio(out, whole, tol)
                                          for c, out in faulty.items()}
                        for at in ("p", "acc"):
                            bad = _partials(q, k, v, length, R,
                                            lambda *a, at=at: _partial_faulty(*a, at=at))
                            controls[name][f"{at}_bf16"] = max(
                                _worst_ratio(o, o_p, tol) for (o, _, _), (o_p, _, _)
                                in zip(bad, want))
                        passed = [c for c in PARTIAL_CONTROLS if controls[name][c] <= 1.0]
                        if passed:
                            raise AssertionError(f"tolerance {tol} lets faulty partials "
                                                 f"{passed} pass")
            del q, k, v
    return {"checks": checks, "tolerance": tol, "controls": controls,
            "max_combined_worst_ratio": max(c["combined_worst_ratio"] for c in checks),
            "max_slice_worst_ratio": max(c["slice_worst_ratio"] for c in checks)}


def _serve_attention_cases(runs: tuple = SHARDED_SERVE_RUNS + BLOCK_SERVE_RUNS) -> list:
    """The decode_attention calls the ranks of the sharded_serve and
    sharded_blocks phases make (``runs``: both phases' by default), derived
    from their runs, SERVE_MESH and the configs (MLA attends in plain torch
    and makes none): for each
    run, rank and attention layer, the entry ("whole" where the rows divide
    over data, else "partial" on the rank's slice of S), the shapes of q and
    of its K/V, the cache's slots S, the slices R it is cut in, and the
    positions decoded (the engine's prompt a token a step; after a prefill,
    which attends in plain torch, the new tokens alone).  Equal entries
    merged: ``[{"entry", "q", "kv", "S", "R", "positions"}]``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.attention import kv_heads_read
    from repro_torch.models.model import layer_blocks

    mesh, d, m = Mesh(SERVE_MESH), SERVE_MESH["data"], SERVE_MESH["model"]
    cases = {}
    for arch, B, P, n_new, how in runs:
        cfg = get_config(arch)
        if cfg.attn_kind == "mla":
            continue
        if cfg.n_heads % m:
            raise AssertionError(f"{arch}: the cases assume head-parallel GQA attention")
        rows_cut, L = B % d == 0, P + n_new
        Bl, Hl, D = (B // d if rows_cut else B), cfg.n_heads // m, cfg.hd
        for rank in range(d * m):
            KVl = (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0
                   else kv_heads_read(cfg, mesh.bind_abstract(rank)).numel())
            for li, (block, _) in enumerate(layer_blocks(cfg)):
                if block not in ("dense", "moe"):
                    continue
                local = cfg.attn_kind == "sliding" and not cfg.is_global_attn(li)
                S = min(L, cfg.sliding_window) if local else L
                R = 1 if rows_cut else d
                key = ("whole" if rows_cut else "partial", (Bl, Hl, D), (Bl, S // R, KVl, D), S)
                cases.setdefault(key, set()).update(range(P if how == "prefill" else 0, L))
    return [{"entry": e, "q": q, "kv": kv, "S": S, "R": S // kv[1], "positions": sorted(pos)}
            for (e, q, kv, S), pos in cases.items()]


def _serve_attention_calls(cases: list) -> set:
    """``(entry, q shape, K/V shape, length)`` of every call the cases make
    on some rank: the valid slots of each rank's slice at each position."""
    calls = set()
    for c in cases:
        Sl = c["kv"][1]
        for pos in c["positions"]:
            for r in range(c["R"]):
                n = min(max(min(pos + 1, c["S"]) - r * Sl, 0), Sl)
                calls.add((c["entry"], tuple(c["q"]), tuple(c["kv"]), n))
    return calls


def _serve_attention_checks(gen: torch.Generator) -> dict:
    """decode_attention at the shapes and lengths the sharded_serve ranks
    give it (:func:`_serve_attention_cases`), float32 as there, against the
    plain versions at F32_TOL.  Each position's cache holds the tokens up to
    it at slot ``pos % S`` (a local layer's ring wraps past S) and random
    values in the slots not yet written; the whole kernel over it, or the
    partial entry over each of its R slices combined in rank order, against
    the plain attention over the ordered window of the last ``min(pos + 1,
    S)`` tokens.  The partial cases also at no token and at one (a slice
    with no valid slot)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (combine_partials, decode_attention_cuda,
                                                      decode_attention_partial_cuda,
                                                      decode_attention_partial_ref)

    out, tol, dev = [], F32_TOL, gen.device
    for c in _serve_attention_cases():
        (B, H, D), (_, _, KV, _), S, R = c["q"], c["kv"], c["S"], c["R"]
        q = torch.randn((B, H, D), generator=gen, device=dev)
        hist_k, hist_v = (torch.randn((B, c["positions"][-1] + 1, KV, D), generator=gen,
                                      device=dev) for _ in range(2))
        positions = ([-1, 0] if c["entry"] == "partial" else []) + c["positions"]
        worst, err, empty = 0.0, 0.0, 0
        for pos in positions:
            lo = max(0, pos + 1 - S)
            ks, vs = (torch.randn((B, S, KV, D), generator=gen, device=dev) for _ in range(2))
            idx = torch.arange(lo, pos + 1, device=dev)
            ks[:, idx % S], vs[:, idx % S] = hist_k[:, idx], hist_v[:, idx]
            n = pos + 1 - lo
            if c["entry"] == "whole":
                o = decode_attention_cuda(q, ks, vs, n)
            else:
                got = _partials(q, ks, vs, n, R, decode_attention_partial_cuda)
                want = _partials(q, ks, vs, n, R, decode_attention_partial_ref)
                worst = max(worst, _held_slices(got, want, tol, str(c)))
                empty += sum(m == 0 for *_, m in got)
                o = combine_partials(torch.stack([g[0] for g in got]),
                                     torch.stack([g[1] for g in got]))
            if n == 0:
                if not torch.equal(o, torch.zeros_like(o)):
                    raise AssertionError(f"{c}: no valid slot combined to o != 0")
                continue
            whole = ref.decode_attention_ref(q, hist_k[:, lo:pos + 1], hist_v[:, lo:pos + 1], n)
            torch.testing.assert_close(o, whole, **tol)
            worst = max(worst, _worst_ratio(o, whole, tol))
            err = max(err, (o - whole).abs().max().item())
        out.append({**c, "positions": [positions[0], positions[-1]], "checked": len(positions),
                    "empty_slices": empty, "worst_ratio": worst, "max_abs_err": err})
        del q, hist_k, hist_v, ks, vs
    return {"dtype": "float32", "tolerance": tol, "cases": out,
            "max_worst_ratio": max(c["worst_ratio"] for c in out)}


def _attention_partial(gen: torch.Generator) -> dict:
    """decode_attention's partial entry (see the module's doc): the checks of
    :func:`_attention_partial_checks` and :func:`_serve_attention_checks`,
    and device time on half of S 544 at olmoe's layout beside the whole
    kernel on all of it."""
    from repro_torch.kernels.decode_attention import decode_attention_partial_cuda

    S = PROMPT_LEN + NEW_TOKENS
    checks = _attention_partial_checks(gen)
    serve = _serve_attention_checks(gen)
    # device time: the partial on half of S (a data rank's slice) beside the
    # whole kernel on all of S, olmoe's layout in bf16, each beside SDPA
    H, KV, D = OLMOE_HEADS["H"], OLMOE_HEADS["KV"], OLMOE_HEADS["D"]
    q, copies = _attention_copies(gen, REQUESTS, H, KV, D, S, 1)
    k, v = copies[0][:2]
    half = [(k[:, :S // 2].contiguous(), v[:, :S // 2].contiguous(),
             k[:, :S // 2].permute(0, 2, 1, 3).contiguous(),
             v[:, :S // 2].permute(0, 2, 1, 3).contiguous())]
    q4 = q[:, :, None, :].contiguous()
    part = _profile_calls(
        {"decode_attention": lambda c: decode_attention_partial_cuda(q, c[0], c[1], S // 2),
         "library": lambda c: F.scaled_dot_product_attention(q4, c[2], c[3], enable_gqa=True)},
        half)
    whole = _attention_device_ms(q, copies, S)
    nbytes = q.numel() * 2 + 2 * REQUESTS * (S // 2) * KV * D * 2 + q.numel() * 4 + 4 * REQUESTS * H
    b_ms, b_by = bound_ms(nbytes, 4 * REQUESTS * H * (S // 2) * D, "bfloat16")
    return {**checks, "sharded_serve_shapes": serve,
            "timed": {"q": [REQUESTS, H, D], "slice": [REQUESTS, S // 2, KV, D],
                      "partial_device_ms": part["decode_attention"],
                      "sdpa_on_slice_device_ms": part["library"],
                      "whole_S_device_ms": whole["decode_attention"],
                      "sdpa_whole_S_device_ms": whole["library"],
                      "partial_bound_ms": b_ms, "partial_bound_by": b_by}}


def _family_heads(gen: torch.Generator) -> dict:
    """decode_attention at the head layout of each GQA config of FAMILIES and
    of zamba2-2.7b's shared block (B 4, bf16), at the families phase's S
    (32 + 8) and at 544: checked against the plain version, and its device
    time per launch beside SDPA's (``enable_gqa``) in one profile, warm."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    out = {}
    for arch in (*FAMILIES, "zamba2-2.7b"):
        cfg = get_config(arch)
        if cfg.attn_kind == "mla":
            out[arch] = None  # MLA attends in plain torch, not through the kernel
            continue
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        entry = {"H_KV_D": [H, KV, D], "rep": H // KV}
        for S in (FAMILY_PROMPT + FAMILY_NEW, PROMPT_LEN + NEW_TOKENS):
            q, copies = _attention_copies(gen, REQUESTS, H, KV, D, S, 1)
            k, v = copies[0][:2]
            o = decode_attention_cuda(q, k, v, S)
            o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), S)
            torch.testing.assert_close(o.float(), o_plain, **BF16_TOL)
            warm = _attention_device_ms(q, copies, S)
            entry[f"S{S}"] = {"device_ms": warm["decode_attention"],
                              "library_device_ms": warm["library"],
                              "worst_ratio": _worst_ratio(o, o_plain)}
            del q, copies
        out[arch] = entry
    return out


# the ordered scan's path shapes in the cluster phase's card rows (entry, L,
# R, read cold), from tools/tiered_kernels.py --census: the all_to_all
# fan-out's busy chains (lockstep.py:921) and their queued totals (:928) at
# 4,096 ranks, x past the L2; a block of 256 stages' queued totals (:666,
# 64 of 91 launches) and a shorter one, each just written; a block's total
# (:669); the tiered solver's tallest g_q and cls_q flushes
# (lockstep_tiered.py:1223, :1228) and a [1, 1] term
ORDERED_SCAN_PATHS = (("ordered_scan", 2049, 4096, True), ("ordered_total", 2048, 4096, True),
                      ("ordered_total", 4096, 256, False), ("ordered_total", 1024, 256, False),
                      ("ordered_total", 257, 1, False), ("ordered_total", 12_289, 1, False),
                      ("ordered_total", 12_289, 2, False), ("ordered_total", 8_835, 3, False),
                      ("ordered_total", 1, 1, False))
# checked beside them, both entries: odd R (wide and narrow), a tall column,
# x 8 bytes past a 16-byte boundary, one row
ORDERED_SCAN_CHECKS = ((257, 4097, False), (1000, 5, False), (100_000, 1, False),
                       (300, 256, True), (1, 4096, False), (1, 1, False))
DADD_CYCLES = 8.1  # a float64 add's latency (tools/tiered_kernels.py --latency)


def _ordered_scan_x(gen: torch.Generator, L: int, R: int, unaligned: bool = False):
    """Columns like [1e16, 1, -1e16, 1, ...] with noise, where any order of
    the adds but left to right gives other bits; ``unaligned``: the data 8
    bytes past a 16-byte boundary."""
    flat = torch.randn(L * R + 1, generator=gen, device="cuda", dtype=torch.float64)
    x = (flat[1:] if unaligned else flat[1:].clone()).view(L, R)
    x[0::4] += 1e16
    x[1::4] = 1.0
    x[2::4] -= 1e16
    return x


def _ordered_scan_check(entry: str, x: torch.Tensor, plain: bool = True) -> dict:
    """One entry bit for bit against np.add.accumulate (its last row for
    the totals) and, where ``plain``, its plain version on the card."""
    from repro_torch.kernels import ordered_scan as mod

    got = getattr(mod, f"{entry}_cuda")(x)
    want = np.add.accumulate(x.cpu().numpy(), axis=0)
    if entry == "ordered_total":
        want = want[-1]
    same = np.array_equal(got.cpu().numpy().view(np.int64), want.view(np.int64))
    if plain:
        same = same and torch.equal(got.view(torch.int64),
                                    getattr(mod, f"{entry}_ref")(x).view(torch.int64))
    L, R = x.shape
    if not same:
        raise AssertionError(f"{entry} [{L}, {R}] differs from np.add.accumulate or its "
                             "plain version")
    lib = torch.cumsum(x, 0)[-1] if entry == "ordered_scan" else torch.sum(x, 0)
    last = got[-1] if entry == "ordered_scan" else got
    return {"entry": entry, "shape": [L, R], "aligned": x.data_ptr() % 16 == 0,
            "plan": mod.ordered_scan_plan(L, R, x.data_ptr() % 16 == 0), "exact": True,
            "plain_checked": plain, "library_columns_off": int((lib != last).sum())}


def _ordered_scan_at(gen: torch.Generator) -> dict:
    """Both entries of the ordered scan bit for bit against np.add.accumulate
    and their plain versions at the cluster phase's path shapes and at
    ORDERED_SCAN_CHECKS.  Each path shape timed: device time of the kernel
    alone (torch.profiler, in turns with the library call: torch.cumsum(x,
    0) for the scan, torch.sum(x, 0) for the totals, which adds in other
    bits), events around each launch (host dispatch included) and events
    queued behind torch.cuda._sleep; cold over 3 copies of x (past the L2)
    where the solver reads it cold, else on the one x just written.  Beside
    each: the bound by bytes and the chain floor, (L - 1) float64 adds of
    DADD_CYCLES at the SM clock measured under load.  The summary keys are
    the [2049, 4096] scan's."""
    from repro_torch.kernels.ordered_scan import (ordered_scan_cuda, ordered_scan_ref,
                                                  ordered_total_cuda)

    checks = []
    for L, R, unaligned in ORDERED_SCAN_CHECKS:
        x = _ordered_scan_x(gen, L, R, unaligned)
        checks += [_ordered_scan_check(e, x, plain=L <= 20_000)
                   for e in ("ordered_scan", "ordered_total")]
    entries = {"ordered_scan": ordered_scan_cuda, "ordered_total": ordered_total_cuda}
    x_tall = _ordered_scan_x(gen, 12_289, 1)  # a chain long enough to hold the clock up
    mhz = _sm_clock_under_load(lambda: ordered_total_cuda(x_tall))
    paths = []
    for entry, L, R, cold in ORDERED_SCAN_PATHS:
        x = _ordered_scan_x(gen, L, R)
        checks.append(_ordered_scan_check(entry, x))
        fn = entries[entry]
        lib, lib_name = ((lambda xx: torch.cumsum(xx, 0)), "torch.cumsum(x, 0)") \
            if entry == "ordered_scan" else ((lambda xx: torch.sum(xx, 0)),
                                             "torch.sum(x, 0), other bits")
        copies = [x, x.clone(), x.clone()] if cold else [x]
        prof = _profile_calls({"ordered_scan": fn, "library": lib}, copies)
        turn = itertools.cycle(copies)
        out_bytes = L * R * 8 if entry == "ordered_scan" else R * 8
        b_ms, b_by = bound_ms(L * R * 8 + out_bytes, max(L - 1, 1) * R, "float64")
        paths.append({"entry": entry, "shape": [L, R], "read": "cold" if cold else "warm",
                      "device_ms": prof["ordered_scan"], "library": lib_name,
                      "library_device_ms": prof["library"],
                      "events_ms": launch_ms(lambda: fn(next(turn)), iters=10),
                      "queued_ms": queued_ms(lambda: fn(next(turn)), iters=5),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "chain_floor_ms": (L - 1) * DADD_CYCLES / mhz * 1e-3})
        del x, copies
    head = paths[0]
    L, R = head["shape"]
    x = _ordered_scan_x(gen, L, R)
    return {"shape": [L, R], "dtype": "float64", "checks": checks, "max_abs_err": 0.0,
            "ms": time_ms(lambda: ordered_scan_cuda(x), iters=50, warmup=5),
            "plain_ms": time_ms(lambda: ordered_scan_ref(x), iters=3, warmup=1),
            "library_ms": time_ms(lambda: torch.cumsum(x, dim=0), iters=50, warmup=5),
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "device_ms": head["device_ms"], "library_device_ms": head["library_device_ms"],
            "device_ms_by": "torch.profiler, kernel alone, x read cold",
            "sm_clock_mhz": mhz, "dadd_cycles": DADD_CYCLES, "paths": paths}


# the tiered solver's shapes at 4,096 devices on fat_tree (16 a node, 256
# nodes): one node's up port carries 16 x 4,080 touches, and one dependency
# level prices every node's up port in one launch; all_to_all's widest
# launch is 130 ports of 130,048 touches
PORT_CHAIN_TOUCHES = 16 * 4080
PORT_CHAIN_LEVEL = 256
PORT_CHAIN_WIDEST = (130, 130_048)
# numpy's sum: every length from 1 to one block past numpy's 8,192, and the
# longest chunk (one up port's queued times)
NUMPY_SUM_LENGTHS = (*range(1, 8194), PORT_CHAIN_TOUCHES)


def _sm_clock_under_load(call, seconds: float = 0.3) -> float:
    """The SM clock in MHz, read by nvidia-smi while ``seconds`` of ``call``'s
    launches are queued on the card."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    for _ in range(max(1, int(seconds / max(time.perf_counter() - t0, 1e-5)))):
        call()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           check=True, capture_output=True, text=True, timeout=60).stdout
    torch.cuda.synchronize()
    return float(clock.split()[0])


def _port_chain_at(gen: torch.Generator) -> dict:
    """Kernel A against its plain version, bit for bit (starts, busy and
    queued times), at a level of 256 ports of the solver's longest chain; a
    control whose queued sum is added pairwise (numpy_sum) must be rejected.
    Timed at that shape beside the plain version (the checked call), and
    alone at the widest launch (130 x 130,048; the plain version would take
    ~13 s there), with ns and SM cycles a touch of the longest chain; no
    single PyTorch call computes a max-plus chain."""
    from repro_torch.kernels.numpy_sum import numpy_sum_cuda
    from repro_torch.kernels.port_chain import port_chain_cuda, port_chain_ref

    def case(n_ports, k=PORT_CHAIN_TOUCHES):
        ser = 0.5 + torch.rand(n_ports, generator=gen, device="cuda", dtype=torch.float64)
        # arrivals in queue order, a little faster than the port drains them:
        # busy runs with restarts between
        rdy = torch.rand(n_ports, k, generator=gen, device="cuda", dtype=torch.float64)
        rdy = (rdy.sort(dim=1).values * (0.9 * k) * ser[:, None]).flatten()
        offs = torch.arange(0, (n_ports + 1) * k, k, device="cuda")
        port = torch.randperm(4 * n_ports, generator=gen, device="cuda")[:n_ports]
        busy = torch.rand(4 * n_ports, generator=gen, device="cuda", dtype=torch.float64)
        qd = torch.rand(4 * n_ports, generator=gen, device="cuda", dtype=torch.float64)
        return rdy, offs, port, ser, busy, qd

    rdy, offs, port, ser, busy, qd = case(PORT_CHAIN_LEVEL)
    qd0 = qd[port].clone()
    busy_k, qd_k = busy.clone(), qd.clone()
    got = port_chain_cuda(rdy, offs, port, ser, busy_k, qd_k)
    ran = {}  # the plain version runs once, timed: it advances busy and qd
    plain_ms = time_ms(lambda: ran.setdefault("plain", port_chain_ref(
        rdy, offs, port, ser, busy, qd)), iters=1, warmup=0)
    if not (torch.equal(got, ran["plain"]) and torch.equal(busy_k, busy)
            and torch.equal(qd_k, qd)):
        raise AssertionError(f"port_chain at {PORT_CHAIN_LEVEL} x {PORT_CHAIN_TOUCHES} "
                             "touches differs from its plain version")
    # the control adds each port's queued times pairwise, then onto its total
    control = qd0 + numpy_sum_cuda(got - rdy, offs)
    rejected = int((control != qd_k[port]).sum())
    if rejected == 0:
        raise AssertionError("port_chain: a pairwise queued sum went unnoticed")
    checks = {"ports": PORT_CHAIN_LEVEL, "touches_per_port": PORT_CHAIN_TOUCHES, "exact": True,
              "control_pairwise_queued_sum_ports_off": rejected}
    T = rdy.numel()
    # each ready time read once, each start written once; max, sub, add, add
    b_ms, b_by = bound_ms(T * 16, 4 * T, "float64")
    call = lambda: port_chain_cuda(rdy, offs, port, ser, busy, qd)  # noqa: E731
    device_ms = launch_ms(call, iters=10)
    mhz = _sm_clock_under_load(call)
    w_rdy, w_offs, w_port, w_ser, w_busy, w_qd = case(*PORT_CHAIN_WIDEST)
    widest = lambda: port_chain_cuda(w_rdy, w_offs, w_port, w_ser, w_busy, w_qd)  # noqa: E731
    w_ms = launch_ms(widest, iters=10)
    w_mhz = _sm_clock_under_load(widest)
    k_w = PORT_CHAIN_WIDEST[1]
    w_bound, _ = bound_ms(w_rdy.numel() * 16, 4 * w_rdy.numel(), "float64")
    return {"shape": [PORT_CHAIN_LEVEL, PORT_CHAIN_TOUCHES], "dtype": "float64",
            "checks": checks, "max_abs_err": 0.0,
            "ms": time_ms(call, iters=10, warmup=2), "plain_ms": plain_ms,
            "library_ms": None, "library": "none: no PyTorch call computes a max-plus chain",
            "bound_ms": b_ms, "bound_by": b_by, "device_ms": device_ms,
            "device_ms_by": "CUDA events around each launch", "library_device_ms": None,
            "sm_clock_mhz": mhz, "ns_per_touch": device_ms * 1e6 / PORT_CHAIN_TOUCHES,
            "cycles_per_touch": device_ms * 1e3 * mhz / PORT_CHAIN_TOUCHES,
            "widest": {"shape": list(PORT_CHAIN_WIDEST), "device_ms": w_ms,
                       "ms": time_ms(widest, iters=10, warmup=1), "bound_ms": w_bound,
                       "sm_clock_mhz": w_mhz, "ns_per_touch": w_ms * 1e6 / k_w,
                       "cycles_per_touch": w_ms * 1e3 * w_mhz / k_w}}


def _numpy_sum_at(gen: torch.Generator) -> dict:
    """Kernel B against its plain version, bit for bit, at every length from
    1 to 8,193 and at the solver's longest chunk (65,280), and against this
    machine's np.sum up to 8,192; a left-to-right sum, the control, must
    differ.  Timed at the longest chunk beside the plain version and
    torch.sum, at the level of 256 such chunks beside torch.sum of its rows,
    and over all 8,194 segments in one launch, as a flush gives many short
    ones.  ``device_ms`` is by CUDA events around each launch (at the level
    over copies of x, so that each call reads cold); the ``profiler_*`` keys
    are torch.profiler's, each pair from one profile in turns, warm on one x
    and cold over copies of x that exceed the L2.

    The port reproduces the reference's numpy (2.0), which sums a
    contiguous vector in blocks of 8,192 elements; numpy 2.3 sums it in one
    pairwise tree, so above 8,192 elements this machine's np.sum may differ
    from both in the last bit.  The plain version is held to numpy 2.0's
    np.sum at every length in the CPU tests (tests/test_torch_tiered.py)."""
    from repro_torch.kernels.numpy_sum import BLOCK, numpy_sum_cuda, numpy_sum_ref

    lens = torch.tensor(NUMPY_SUM_LENGTHS)
    offs = torch.zeros(len(lens) + 1, dtype=torch.int64)
    torch.cumsum(lens, 0, out=offs[1:])
    # magnitudes over eight decades: any other order of the adds shows
    x = torch.rand(int(offs[-1]), generator=gen, device="cuda", dtype=torch.float64)
    x *= 10.0 ** torch.randint(-4, 4, x.shape, generator=gen, device="cuda")
    offs_d = offs.cuda()
    got = numpy_sum_cuda(x, offs_d)
    plain = numpy_sum_ref(x, offs_d)
    xh, oh = x.cpu().numpy(), offs.tolist()
    segs = [xh[oh[i]:oh[i + 1]] for i in range(len(lens))]
    want = np.array([np.sum(v) for v in segs])
    if not torch.equal(got, plain):
        raise AssertionError("numpy_sum differs from its plain version")
    blocked = lens.numpy() <= BLOCK  # one pairwise tree in every numpy version
    got_h = got.cpu().numpy()
    if not np.array_equal(got_h[blocked], want[blocked]):
        raise AssertionError("numpy_sum differs from np.sum at 8,192 elements or fewer")
    left_to_right = np.array([np.add.accumulate(v)[-1] for v in segs])
    off = int((left_to_right != got_h).sum())
    if off == 0:
        raise AssertionError("numpy_sum: a left-to-right sum went unnoticed")
    one = x[oh[-2]:oh[-1]]
    one_offs = torch.tensor([0, one.numel()], device="cuda")
    n = one.numel()
    b_ms, b_by = bound_ms(n * 8 + 8, n, "float64")
    one_calls = {"numpy_sum": lambda xx: numpy_sum_cuda(xx, one_offs), "library": torch.sum}
    warm = _profile_calls(one_calls, [one])
    # cold: copies that together exceed twice the L2, taken in turns
    cold = _profile_calls(one_calls, [one.clone() for _ in range(192)])
    # the level: 256 chunks of 65,280 in one launch, beside torch.sum of the rows
    L = PORT_CHAIN_LEVEL
    xl = torch.rand(L * n, generator=gen, device="cuda", dtype=torch.float64)
    xl *= 10.0 ** torch.randint(-4, 4, xl.shape, generator=gen, device="cuda")
    offs_l = torch.arange(0, (L + 1) * n, n, device="cuda")
    if not torch.equal(numpy_sum_cuda(xl, offs_l), numpy_sum_ref(xl, offs_l)):
        raise AssertionError(f"numpy_sum at [{L} x {n}] differs from its plain version")
    rows = lambda xx: xx.view(L, -1).sum(1)  # noqa: E731
    level_calls = {"numpy_sum": lambda xx: numpy_sum_cuda(xx, offs_l), "library": rows}
    copies = [xl, xl.clone(), xl.clone()]  # 401 MB: no call finds its x in the 50 MB L2
    level_warm = _profile_calls(level_calls, copies[:1])
    level_cold = _profile_calls(level_calls, copies)
    turn = itertools.cycle(copies)
    lb_ms, _ = bound_ms(L * n * 8 + L * 8, L * n, "float64")
    level = {"shape": [L, n], "exact": True, "bound_ms": lb_ms,
             "library": "torch.sum(x.view(256, -1), 1)",
             "device_ms": launch_ms(lambda: numpy_sum_cuda(next(turn), offs_l), iters=21),
             "library_device_ms": launch_ms(lambda: rows(next(turn)), iters=21),
             "device_ms_by": "CUDA events around each launch, over 3 copies of x in turns",
             "profiler_warm_device_ms": level_warm["numpy_sum"],
             "library_profiler_warm_device_ms": level_warm["library"],
             "profiler_cold_device_ms": level_cold["numpy_sum"],
             "library_profiler_cold_device_ms": level_cold["library"],
             "ms": time_ms(lambda: numpy_sum_cuda(xl, offs_l), iters=50, warmup=5),
             "library_ms": time_ms(lambda: rows(xl), iters=50, warmup=5)}
    return {"shape": [n], "dtype": "float64", "max_abs_err": 0.0,
            "checks": {"segments": len(lens), "elements": int(offs[-1]), "exact": True,
                       "control_left_to_right_segments_off": off, "numpy": np.__version__,
                       "np_sum_off_above_8192": int((got_h[~blocked] != want[~blocked]).sum()),
                       "all_segments_ms": time_ms(lambda: numpy_sum_cuda(x, offs_d), iters=10,
                                                  warmup=2)},
            "ms": time_ms(lambda: numpy_sum_cuda(one, one_offs), iters=50, warmup=5),
            "plain_ms": time_ms(lambda: numpy_sum_ref(one, one_offs), iters=3, warmup=1),
            "library_ms": time_ms(lambda: torch.sum(one), iters=50, warmup=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "device_ms": launch_ms(lambda: numpy_sum_cuda(one, one_offs), iters=20),
            "device_ms_by": "CUDA events around each launch",
            "library_device_ms": launch_ms(lambda: torch.sum(one), iters=20),
            "profiler_warm_device_ms": warm["numpy_sum"],
            "library_profiler_warm_device_ms": warm["library"],
            "profiler_cold_device_ms": cold["numpy_sum"],
            "library_profiler_cold_device_ms": cold["library"], "level": level}


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name, log in logs.items()}
    return {"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas}


def _mamba_decode_operands(gen: torch.Generator, B: int, H: int, ds: int = 64, K: int = 4,
                            dtype=torch.bfloat16) -> tuple:
    """A Mamba2 block's decode operands on the card in Mamba2's ranges, 64
    columns a head: ``(proj, conv, h, weights)``, ``weights`` the kernel's
    conv_w, dt_bias, a_log, d_skip and norm_z."""
    d_inner = H * 64
    C = d_inner + 2 * ds

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    dt = torch.exp(torch.rand(H, generator=gen, device="cuda") * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3))
    weights = ((randn(K, C, scale=0.5)).to(dtype), dt + torch.log(-torch.expm1(-dt)),
               torch.log(1 + 15 * torch.rand(H, generator=gen, device="cuda")),
               1 + randn(H, scale=0.1), randn(d_inner, scale=0.1).to(dtype))
    return (randn(B, 1, 2 * d_inner + 2 * ds + H).to(dtype), randn(B, K - 1, C),
            randn(B, H, 64, ds, scale=0.1), weights)


MAMBA_CONTROLS = ("taps_reversed", "skip_dropped")  # must be rejected
MAMBA_STEPS = 8  # decode steps a check carries its state over


def _mamba_decode_check(gen: torch.Generator, B: int, H: int) -> dict:
    """The kernel against its plain version for MAMBA_STEPS steps from one
    state, each side carrying its own: y every step, h and the window after,
    within BF16_TOL; and each MAMBA_CONTROLS fault (the plain version with
    the conv taps reversed, or with D x left out) rejected at the first."""
    from repro_torch.kernels.mamba_decode import mamba_decode_cuda, mamba_decode_ref

    proj, conv, h, w = _mamba_decode_operands(gen, B, H)
    mine, plain, worst, err = [conv.clone(), h.clone()], [conv.clone(), h.clone()], 0.0, 0.0
    faults = {"taps_reversed": (w[0].flip(0), *w[1:]),
              "skip_dropped": (*w[:3], torch.zeros_like(w[3]), w[4])}
    for step in range(MAMBA_STEPS):
        x = proj if step == 0 else torch.randn(proj.shape, generator=gen,
                                               device="cuda").to(proj.dtype)
        if step == 0:  # each fault on the first step's inputs, the plain state kept
            faulty = {name: mamba_decode_ref(x, plain[0], plain[1].clone(), *fw)[0]
                      for name, fw in faults.items()}
        y, mine[0] = mamba_decode_cuda(x, mine[0], mine[1], *w)
        y_plain, plain[0] = mamba_decode_ref(x, plain[0], plain[1], *w)
        torch.testing.assert_close(y.float(), y_plain.float(), **BF16_TOL)
        worst = max(worst, _worst_ratio(y, y_plain.float()))
        err = max(err, (y.float() - y_plain.float()).abs().max().item())
        if step == 0:
            controls = {name: {"max_abs_err": (out.float() - y_plain.float()).abs().max().item(),
                               "worst_ratio": _worst_ratio(out, y_plain.float())}
                        for name, out in faulty.items()}
    for got, want in zip(mine, plain):
        torch.testing.assert_close(got, want, **BF16_TOL)
    passed = [name for name in MAMBA_CONTROLS if controls[name]["worst_ratio"] <= 1.0]
    if passed:
        raise AssertionError(f"tolerance {BF16_TOL} lets faulty mamba_decode controls {passed} "
                             "pass")
    return {"B": B, "heads": H, "steps": MAMBA_STEPS, "max_abs_err": err, "worst_ratio": worst,
            "state_worst_ratio": max(_worst_ratio(g, p_) for g, p_ in zip(mine, plain)),
            "controls": controls}


def _mamba_decode_at(gen: torch.Generator, B: int, H: int = 80, ds: int = 64,
                     K: int = 4) -> dict:
    """mamba_decode at B rows of H heads of 64 (bf16): timed by CUDA events
    beside its plain version, and by device time per launch in a profile of
    its own, against the bound of its bytes (the state and the window read
    and written, the projection and weights read, y written) or operations."""
    from repro_torch.kernels.mamba_decode import mamba_decode_cuda, mamba_decode_ref

    proj, conv, h, w = _mamba_decode_operands(gen, B, H, ds, K)
    d_inner, C = H * 64, H * 64 + 2 * ds
    nbytes = (2 * 4 * B * d_inner * ds + 2 * 4 * B * (K - 1) * C
              + 2 * B * (d_inner + C + H) + 2 * (K * C + d_inner) + 4 * 3 * H
              + 2 * B * d_inner)
    b_ms, b_by = bound_ms(nbytes, B * (2 * K * C + 5 * d_inner * ds), "float32")
    device_ms = _profile_calls({"mamba_decode": lambda _: mamba_decode_cuda(proj, conv, h, *w)},
                               [None])["mamba_decode"]
    return {"shape": {"proj": list(proj.shape), "h": list(h.shape), "conv": list(conv.shape)},
            "dtype": "bfloat16", "bytes": nbytes,
            "ms": time_ms(lambda: mamba_decode_cuda(proj, conv, h, *w), iters=50, warmup=5),
            "plain_ms": time_ms(lambda: mamba_decode_ref(proj, conv, h, *w), iters=20,
                                warmup=2),
            "library_ms": None, "library_device_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "device_ms": device_ms,
            **_rates(nbytes, b_ms, device_ms)}


def _mamba_decode_kernel(gen: torch.Generator) -> dict:
    """The kernels phase's mamba_decode entry: at the serve path's B 4 (the
    line's numbers), its checks at B 4 with zamba2-2.7b's 80 heads and one
    rank's 20, and the benchmark's B 512."""
    checks = [_mamba_decode_check(gen, REQUESTS, H) for H in (80, 20)]
    at = _mamba_decode_at(gen, REQUESTS)
    at512 = _mamba_decode_at(gen, 512)
    torch.cuda.empty_cache()
    return {**at, "max_abs_err": max(c["max_abs_err"] for c in checks),
            "checks": checks, "at_B512": at512}


def phase_kernels() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plan
    from repro_torch.kernels.gemv import sm_count

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rms_gemma = _rmsnorm_at(gen, 1152)
    # decode_attention: q [B, 4, 256], k/v [B, S, 1, 256] bf16; the 22 local
    # layers see S = 512, the 4 global layers S = plen + new = 544
    checks = []
    for S in (512, 544):
        q, k, v = randn(REQUESTS, 4, 256), randn(REQUESTS, S, 1, 256), randn(REQUESTS, S, 1, 256)
        for length in (1, 300, 512, 544):
            if length > S:
                continue
            o = decode_attention_cuda(q, k, v, length)
            o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), length)
            torch.testing.assert_close(o.float(), o_plain, **BF16_TOL)
            checks.append({"S": S, "length": length,
                           "max_abs_err": (o.float() - o_plain).abs().max().item(),
                           "worst_ratio": _worst_ratio(o, o_plain)})
    # timed at the global layers' last step, S = length = 544, and at a
    # local layer's full ring, S = length = 512; cold: K and V rotated over
    # copies that exceed twice the L2, as the serve path's 26 layers do
    timings = {}
    sms = sm_count(dev)
    for S in (PROMPT_LEN + NEW_TOKENS, 512):
        length = S
        nbytes_kv = 2 * REQUESTS * S * 256 * 2
        q, copies = _attention_copies(gen, REQUESTS, 4, 1, 256, S,
                                      -(-int(ATTENTION_COLD_BYTES) // nbytes_kv))
        k, v, k4, v4 = copies[0]
        q4 = q[:, :, None, :].contiguous()       # [B, H, 1, D]
        o_lib = F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)[:, :, 0]
        o_plain = ref.decode_attention_ref(q.float(), k.float(), v.float(), length)
        torch.testing.assert_close(o_lib.float(), o_plain, **BF16_TOL)
        if S == PROMPT_LEN + NEW_TOKENS:
            controls = {name: {"max_abs_err": (out.float() - o_plain).abs().max().item(),
                               "worst_ratio": _worst_ratio(out, o_plain)}
                        for name, out in _attention_controls(q, k, v, length).items()}
            passed = [name for name in ATTENTION_CONTROLS
                      if controls[name]["worst_ratio"] <= 1.0]
            if passed:
                raise AssertionError(f"tolerance {BF16_TOL} lets faulty controls {passed} pass")
        nbytes = (q.numel() + 2 * REQUESTS * length * 256 + q.numel()) * 2
        b_ms, b_by = bound_ms(nbytes, 4 * REQUESTS * 4 * length * 256, "bfloat16")
        timings[S] = {
            "shape": {"q": list(q.shape), "k": list(k.shape), "length": length},
            "ms": time_ms(lambda: decode_attention_cuda(q, k, v, length)),
            "plain_ms": time_ms(lambda: ref.decode_attention_ref(q, k, v, length)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        warm = _attention_device_ms(q, copies[:1], length)
        cold = _attention_device_ms(q, copies, length)
        timings[S].update(device_ms=warm["decode_attention"], library_device_ms=warm["library"],
                          cold_device_ms=cold["decode_attention"],
                          library_cold_device_ms=cold["library"], copies=len(copies),
                          memset_device_ms_per_call=warm["memset"],
                          **_rates(nbytes, b_ms, warm["decode_attention"]),
                          plan=_attention_plan_line(
                              decode_attention_plan(REQUESTS, 1, 4, 256, 2, length, sms),
                              4, 1, 256, REQUESTS, sms))
        if S == PROMPT_LEN + NEW_TOKENS:  # the measured plan variants, cold
            variants = [{**_attention_plan_line(plan, 4, 1, 256, REQUESTS, sms),
                         "cold_device_ms": _attention_device_ms(q, copies, length,
                                                                plan)["decode_attention"]}
                        for plan in (decode_attention_plan(REQUESTS, 1, 4, 256, 2, length, sms,
                                                           chunk=c) for c in ATTENTION_CHUNKS)]
        del q, k, v, k4, v4, copies
    att = {"dtype": "bfloat16", "max_abs_err": max(c["max_abs_err"] for c in checks),
           **timings[PROMPT_LEN + NEW_TOKENS], "at_S512": timings[512]}
    # this slice's main path, olmoe-1b-7b: x [4, 1, 2048]; q [4, 16, 128] and
    # k/v [4, S, 16, 128], S = 480 + 64 on every layer
    olmoe = OLMOE_HEADS
    rms_bwd = {f"{r}x{d}": _rmsnorm_bwd_at(gen, r, d) for r, d in RMSNORM_BWD_SHAPES}
    return {"phase": "kernels", "tolerance": BF16_TOL, "f32_tolerance": F32_TOL,
            "rmsnorm_bwd": rms_bwd[f"{RMSNORM_BWD_SHAPES[0][0]}x{RMSNORM_BWD_SHAPES[0][1]}"],
            "rmsnorm_bwd_by_shape": rms_bwd, "rmsnorm_bwd_checks": _rmsnorm_bwd_checks(gen),
            "rmsnorm_train_gemma3_1b": _rmsnorm_at(gen, 1152, rows=2048),
            "rmsnorm": _rmsnorm_at(gen, olmoe["d_model"]),
            "rmsnorm_by_width": {d: _rmsnorm_at(gen, d) for d in RMSNORM_WIDTHS},
            "rmsnorm_checks": _rmsnorm_checks(gen),
            "rmsnorm_block_checks": _block_norm_checks(gen),
            "decode_attention": _attention_path(gen, olmoe["H"], olmoe["KV"], olmoe["D"],
                                                PROMPT_LEN + NEW_TOKENS),
            "decode_attention_checks": checks, "decode_attention_controls": controls,
            "decode_attention_partial": _attention_partial(gen),
            "rmsnorm_gemma3_1b": rms_gemma, "decode_attention_gemma3_1b": att,
            "decode_attention_variants": variants,
            "decode_attention_heads": _attention_sweep(gen, sms),
            "decode_attention_families": _family_heads(gen),
            "ordered_scan": _ordered_scan_at(gen), "mamba_decode": _mamba_decode_kernel(gen),
            **_gemv_kernel_checks(gen)}


def _allreduce_rank(rank: int, world: int, shapes: dict, reps: int) -> dict:
    """One rank of the gemv_allreduce phase, in its own spawned process.

    Every rank makes the whole x and w from one seed on the card, keeps its
    K slice, runs fused_gemv_allreduce and psum_matmul once (counting their
    kernel launches), and holds both against the plain float32 product x @ w
    on the card.  Tolerance: float32 keeps the JAX test's 1e-4.  In bf16 each
    rank's partial p_r is rounded once (world roundings) and the ring adds
    world - 1 times in bf16, as the reference's does (collectives.py:92); the
    all-reduce adds world - 1 times too.  Each of those 2 world - 1 roundings
    errs by at most 2^-8 of a value no larger than sum_r |p_r|, so the limit
    is (2 world - 1) 2^-8 sum_r |p_r|, plus the float32 1e-4 for the sums.
    A control with the successor's partial dropped must break it.
    """
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.distributed import fused_gemv_allreduce, psum_matmul
    from repro_torch.distributed.collectives import exchange_device
    from repro_torch.kernels.gemv import gemv_cuda
    from repro_torch.kernels.gemv_tiles import gemv_tiles_cuda, remote_first_order, tile_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"backend": str(dist.get_backend()), "shapes": {}}
    for name, (B, K, N, dt) in shapes.items():
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(B, K, generator=gen, device=dev).to(dtype)
        w = (torch.randn(K, N, generator=gen, device=dev) * 0.05).to(dtype)
        ks = K // world
        xs, ws = x[:, rank * ks:(rank + 1) * ks], w[rank * ks:(rank + 1) * ks]
        gemv_cuda.launches = gemv_tiles_cuda.launches = 0
        y_fused, owner_served = fused_gemv_allreduce(xs, ws)
        y_psum = psum_matmul(xs, ws)
        torch.cuda.synchronize()
        launches = {"gemv_tiles": gemv_tiles_cuda.launches, "gemv": gemv_cuda.launches}
        if launches != {"gemv_tiles": 1, "gemv": 1}:
            raise AssertionError(f"rank {rank}, {name}: kernel launches {launches}")
        out["exchange_device"] = str(exchange_device(y_fused))

        partials = [x[:, r * ks:(r + 1) * ks].float() @ w[r * ks:(r + 1) * ks].float()
                    for r in range(world)]
        plain = x.float() @ w.float()
        limit = 1e-4 + 1e-4 * plain.abs()
        if dtype == torch.bfloat16:
            limit += (2 * world - 1) * BF16_UNIT_ROUNDOFF * sum(p.abs() for p in partials)

        def ratio(y, lim=limit):
            return ((y.float() - plain).abs() / lim).max().item()

        res = {"fused_worst_ratio": ratio(y_fused), "psum_worst_ratio": ratio(y_psum),
               "fused_vs_psum_worst_ratio": ((y_fused.float() - y_psum.float()).abs()
                                             / (2 * limit)).max().item(),
               "fused_max_abs_err": (y_fused.float() - plain).abs().max().item(),
               "psum_max_abs_err": (y_psum.float() - plain).abs().max().item(),
               "dropped_partial_worst_ratio":
                   ratio((plain - partials[(rank + 1) % world]).to(dtype)),
               "launches": launches}
        if max(res["fused_worst_ratio"], res["psum_worst_ratio"],
               res["fused_vs_psum_worst_ratio"]) > 1.0:
            raise AssertionError(f"rank {rank}, {name}: out of tolerance {res}")
        if res["dropped_partial_worst_ratio"] <= 1.0:
            raise AssertionError(f"rank {rank}, {name}: the tolerance lets a dropped "
                                 f"partial pass {res}")
        _, tiles_per_dev = tile_plan(N, world, rank, 64)
        expect = [t // tiles_per_dev for t in remote_first_order(world, rank, tiles_per_dev)]
        if owner_served.tolist() != expect:
            raise AssertionError(f"rank {rank}, {name}: owner_served "
                                 f"{owner_served.tolist()} != {expect}")
        res["owner_served"] = owner_served.tolist()
        # the ranks share one card and the host: walls, not kernel speeds
        for label, fn in (("fused", lambda: fused_gemv_allreduce(xs, ws)),
                          ("psum", lambda: psum_matmul(xs, ws))):
            dist.barrier()
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            res[f"{label}_wall_ms_median"] = float(np.median(walls))
            res[f"{label}_wall_ms_min"] = min(walls)
        out["shapes"][name] = res
        del x, w, partials, plain, limit
        torch.cuda.empty_cache()
    return out


def phase_gemv_allreduce() -> dict:
    from repro_torch.distributed import run_world

    t0 = time.perf_counter()
    ranks = run_world(_allreduce_rank, RANKS, ALLREDUCE_SHAPES, 10, timeout=300)
    backends = {r["backend"] for r in ranks}
    places = {r["exchange_device"] for r in ranks}
    if len(backends) != 1 or len(places) != 1:
        raise AssertionError(f"ranks disagree on the exchange: {backends}, {places}")
    place = places.pop()
    exchange = f"{backends.pop()} " + ("via host" if place == "cpu" else f"on {place}")
    shapes = {}
    for name, (B, K, N, dt) in ALLREDUCE_SHAPES.items():
        per_rank = [r["shapes"][name] for r in ranks]
        shapes[name] = {
            "x": [B, K], "w": [K, N], "dtype": dt, "shard": [K // RANKS, N],
            **{key: max(p[key] for p in per_rank)
               for key in ("fused_worst_ratio", "psum_worst_ratio",
                           "fused_vs_psum_worst_ratio", "fused_max_abs_err",
                           "psum_max_abs_err")},
            "dropped_partial_worst_ratio_min": min(p["dropped_partial_worst_ratio"]
                                                   for p in per_rank),
            "per_rank": per_rank,
        }
    return {"phase": "gemv_allreduce", "ranks": RANKS, "exchange": exchange,
            "note": "the ranks are processes sharing one card: walls, not kernel speeds",
            "seconds": time.perf_counter() - t0, "shapes": shapes,
            "launches": {k: sum(r["shapes"][name]["launches"][k] for r in ranks
                                for name in ALLREDUCE_SHAPES)
                         for k in ("gemv", "gemv_tiles")}}


def _replay_lane_numpy(dispatch, is_wait, val, poll, check):
    """The script's own copy of repro/core/cohort_timeline.py::replay_lane_numpy."""
    t = np.array(dispatch, np.int64, copy=True)
    reads = np.zeros_like(t)
    for w, v in zip(is_wait, val):
        if w:
            nticks = np.maximum((v - t + poll - 1) // poll, 0)
            reads += nticks + 1
            t += nticks * poll + check
        else:
            t += v
    return reads, t


def _spin_reads_numpy(wait_start, flag_T, poll, check):
    """The script's own copy of the SPIN branch of repro/core/vector_engine.py:129-135."""
    c = np.array(wait_start, np.int64, copy=True)
    reads = np.zeros_like(c)
    for T in flag_T:
        already = T <= c
        nticks = np.where(already, 0, np.ceil(np.maximum(T - c, 0) / poll).astype(np.int64))
        reads += np.where(already, 1, nticks + 1)
        c = np.where(already, c + check, c + nticks * poll + check)
    return reads, c


def phase_scans() -> dict:
    """The model's two scans on the card at pod scale, against numpy, exactly."""
    from repro_torch.core import replay_lane, spin_reads

    rng = np.random.default_rng(0)
    cohorts, steps, poll, check = 4096, 64, 64, 4  # poll / check: SimConfig's defaults
    dispatch = rng.integers(0, 5000, cohorts)
    is_wait = rng.random(steps) < 0.5
    val = np.where(is_wait, rng.integers(0, 2_000_000, steps), rng.integers(1, 4000, steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reads, end = replay_lane(dispatch, is_wait, val, poll=poll, check=check)
    torch.cuda.synchronize()
    lane_wall = time.perf_counter() - t0
    if not (reads.is_cuda and end.is_cuda and reads.dtype == torch.int64):
        raise AssertionError("replay_lane did not run in int64 on the card")
    r_np, t_np = _replay_lane_numpy(dispatch, is_wait, val, poll, check)
    if not (np.array_equal(reads.cpu().numpy(), r_np) and np.array_equal(end.cpu().numpy(), t_np)):
        raise AssertionError("replay_lane on the card differs from the numpy closed form")

    wait_start = rng.integers(0, 200_000, cohorts)
    flag_T = rng.integers(0, 400_000, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_reads, cursor = spin_reads(wait_start, flag_T, 52, check)
    torch.cuda.synchronize()
    spin_wall = time.perf_counter() - t0
    s_np, c_np = _spin_reads_numpy(wait_start, flag_T, 52, check)
    if not (s_reads.is_cuda and np.array_equal(s_reads.cpu().numpy(), s_np)
            and np.array_equal(cursor.cpu().numpy(), c_np)):
        raise AssertionError("spin_reads on the card differs from the numpy closed form")
    return {"phase": "scans", "cohorts": cohorts, "steps": steps, "exact": True,
            "replay_lane_wall_s": lane_wall, "spin_reads_wall_s": spin_wall,
            "flag_reads": int(r_np.sum()), "end_cycle_max": int(t_np.max()),
            "spin_flag_reads": int(s_np.sum())}


# The open-loop simulator's figures (benchmarks/paper_figs.py of the reference):
# Fig. 6 SPIN over the wakeupTime sweep, Fig. 9 SYNCMON with 10 ns write jitter,
# Fig. 10 the rows M, Fig. 11 the eGPUs (per-device K held at 2048), Fig. 12
# two peers held up by 30 us.  Every point runs on every engine.
EIDOLA_SWEEP_US = tuple(range(0, 41, 5))
EIDOLA_M = (256, 512, 1024, 2048, 4096)
EIDOLA_EGPUS = (3, 7, 15, 31, 63, 127, 255)
EIDOLA_SCALING_DELAY_NS = 10_000.0
EIDOLA_PEER_DELAY_NS = {2: 30_000.0, 3: 30_000.0}
EIDOLA_RUNS = (("cycle", "cpu"), ("event", "cpu"), ("vector", "cpu"), ("vector", "cuda"))
# the fields each engine accounts its own way, in the reference too: the cycle
# engine's per-cycle head polls, the vector engine's closed-form monitor stats
EIDOLA_ENGINE_SPECIFIC = ("engine", "wall_time_s", "wtt_head_polls", "monitor_stats")
EIDOLA_PAPER = {"fig6_r2": 0.99, "nonflag_reads": 65_792, "fig9_reads": (728, 788),
                "fig11_normalized_below": 128.0, "fig12_inflation_above": 10.0}


def _report_fields(report, drop=("wall_time_s",)) -> dict:
    d = dataclasses.asdict(report)
    for key in drop:
        d.pop(key)
    return d


def _eidola_disagreement(reports: dict) -> str | None:
    """None when the vector engine on the card equals the CPU vector engine
    on every field but the wall, and the host's event and cycle engines on
    every field but the engine-specific ones; else what differs."""
    card = reports[("vector", "cuda")]
    for key, other in reports.items():
        drop = ("wall_time_s",) if key == ("vector", "cpu") else EIDOLA_ENGINE_SPECIFIC
        a, b = _report_fields(card, drop), _report_fields(other, drop)
        if a != b:
            return f"vector on cuda against {key}: fields {[k for k in a if a[k] != b[k]]}"
    return None


def _eidola_point(card: str, delay, perturb=None, runs=EIDOLA_RUNS, bundle=None,
                  **cfg_kw) -> tuple:
    """One point on every engine (``runs``: (engine, device) pairs), the
    gemv_allreduce trace at ``delay`` or a given ``bundle``; fails unless they
    agree.  Returns (the event engine's report, the row)."""
    from repro_torch.core import EngineKind, Eidola, SimConfig, run_gemv_allreduce

    reports = {}
    for engine, device in runs:
        cfg = SimConfig(engine=EngineKind(engine), **cfg_kw)
        reports[(engine, device)] = (
            run_gemv_allreduce(cfg, delay, perturb=perturb, device=device) if bundle is None
            else Eidola(cfg, bundle, perturb=perturb, device=device).run())
    if not reports[("vector", "cuda")].segments:
        raise AssertionError("eidola: the vector engine on the card collected no segments")
    wrong = _eidola_disagreement(reports)
    if wrong:
        raise AssertionError(f"eidola {cfg_kw} delay {delay}: {wrong}")
    r = reports[("event", "cpu")]
    return r, {"flag_reads": r.flag_reads, "nonflag_reads": r.nonflag_reads,
               "kernel_span_ns": r.kernel_span_ns, "sim_cycles": r.sim_cycles,
               "wall_s": {f"{e}/{d}": rep.wall_time_s for (e, d), rep in reports.items()},
               "card": card}


def _linear_fit(xs, ys) -> tuple:
    """Slope and r^2 of the least-squares line, as paper_figs' _linfit_r2."""
    fit = np.polyfit(xs, ys, 1)
    ss_res = float(((np.array(ys) - np.polyval(fit, xs)) ** 2).sum())
    ss_tot = float(((np.array(ys) - np.mean(ys)) ** 2).sum())
    return float(fit[0]), 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0


def phase_eidola(card: str) -> list:
    """The open-loop Eidola simulator: the paper's Figs. 6 and 9-12 with the
    vector engine's tensors on the card, each point held field for field to
    the same engine on the CPU and to the event and cycle engines on the host;
    the paper's claims; a report with one flag read added, rejected.  One
    line a figure (every engine's wall at each point, beside the card), then
    the phase's line."""
    from repro_torch.core import GaussianPerturb, PeerDelayPerturb, SyncPolicy
    from repro_torch.core.trace_render import phase_totals

    t0 = time.perf_counter()
    for sync in SyncPolicy:  # warm: the CUDA context, each sync's first launches
        _eidola_point(card, 0.0, sync=sync)
    lines = []
    fig6 = [_eidola_point(card, d * 1000.0, sync=SyncPolicy.SPIN) for d in EIDOLA_SWEEP_US]
    slope, r2 = _linear_fit(list(EIDOLA_SWEEP_US), [r.flag_reads for r, _ in fig6])
    nonflag = {r.nonflag_reads for r, _ in fig6}
    lines.append({"phase": "eidola", "figure": 6, "sync": "spin", "slope_per_us": slope,
                  "r2": r2, "rows": [dict(row, wakeup_us=d)
                                     for d, (_, row) in zip(EIDOLA_SWEEP_US, fig6)]})
    if not (r2 > EIDOLA_PAPER["fig6_r2"] and slope > 0
            and nonflag == {EIDOLA_PAPER["nonflag_reads"]}):
        raise AssertionError(f"eidola Fig. 6: r2 {r2}, slope {slope}, non-flag {nonflag}")

    fig9 = [_eidola_point(card, d * 1000.0,
                          GaussianPerturb(seed=i * 7 + 1, write_sigma_ns=10.0),
                          sync=SyncPolicy.SYNCMON)
            for i, d in enumerate(EIDOLA_SWEEP_US)]
    reads9 = [r.flag_reads for r, _ in fig9]
    lines.append({"phase": "eidola", "figure": 9, "sync": "syncmon",
                  "rows": [dict(row, wakeup_us=d, monitor_wakes=r.monitor_stats["wakes"])
                           for d, (r, row) in zip(EIDOLA_SWEEP_US, fig9)]})
    lo, hi = EIDOLA_PAPER["fig9_reads"]
    if not (lo <= min(reads9) and max(reads9) <= hi
            and {r.nonflag_reads for r, _ in fig9} == {EIDOLA_PAPER["nonflag_reads"]}):
        raise AssertionError(f"eidola Fig. 9: flag reads {reads9} outside [{lo}, {hi}]")

    fig10 = [_eidola_point(card, EIDOLA_SCALING_DELAY_NS, M=M, sync=SyncPolicy.SPIN)
             for M in EIDOLA_M]
    lines.append({"phase": "eidola", "figure": 10, "sync": "spin",
                  "rows": [dict(row, M=M) for M, (_, row) in zip(EIDOLA_M, fig10)]})

    fig11 = [_eidola_point(card, EIDOLA_SCALING_DELAY_NS, n_egpus=n, weak_scaling=True,
                           K=2048, sync=SyncPolicy.SPIN) for n in EIDOLA_EGPUS]
    normalized = {}
    for key in (f"{e}/{d}" for e, d in EIDOLA_RUNS):
        walls = np.array([row["wall_s"][key] for _, row in fig11])
        t1, _te = np.linalg.lstsq(np.stack([np.ones(len(walls)), np.array(EIDOLA_EGPUS, float)],
                                           axis=1), walls, rcond=None)[0]
        normalized[key] = float(walls[-1] / max(t1, 1e-9))  # paper Eq. 1, at 255 eGPUs
    lines.append({"phase": "eidola", "figure": 11, "sync": "spin", "K": 2048,
                  "weak_scaling": True, "normalized_at_255": normalized,
                  "rows": [dict(row, egpus=n, wtt_writes=r.wtt_registered)
                           for n, (r, row) in zip(EIDOLA_EGPUS, fig11)]})
    # the paper's claim is about the simulator's design: held on the event
    # engine (paper_figs' default), the others printed beside it
    if not normalized["event/cpu"] < EIDOLA_PAPER["fig11_normalized_below"]:
        raise AssertionError(f"eidola Fig. 11: normalized time {normalized}")

    ideal, ideal_row = _eidola_point(card, 0.0, sync=SyncPolicy.SPIN)
    slow, slow_row = _eidola_point(card, 0.0, PeerDelayPerturb(dict(EIDOLA_PEER_DELAY_NS)),
                                   sync=SyncPolicy.SPIN)
    wait_i = phase_totals(ideal.segments).get("wait_flags", 0.0)
    wait_s = phase_totals(slow.segments).get("wait_flags", 0.0)
    inflation = wait_s / max(wait_i, 1.0)
    lines.append({"phase": "eidola", "figure": 12, "sync": "spin",
                  "peer_delay_ns": EIDOLA_PEER_DELAY_NS, "ideal_wait_ns_total": wait_i,
                  "contended_wait_ns_total": wait_s, "wait_inflation": inflation,
                  "rows": [dict(ideal_row, case="ideal"), dict(slow_row, case="contended")]})
    if not inflation > EIDOLA_PAPER["fig12_inflation_above"]:
        raise AssertionError(f"eidola Fig. 12: wait inflation {inflation}")

    # a planted fault: the comparison must reject one flag read too many
    planted = dataclasses.replace(ideal, flag_reads=ideal.flag_reads + 1)
    rejected = _eidola_disagreement({("vector", "cuda"): planted, ("event", "cpu"): ideal})
    if rejected is None:
        raise AssertionError("eidola: a report with one flag read added was not rejected")
    points = len(fig6) + len(fig9) + len(fig10) + len(fig11) + 2
    lines.append({"phase": "eidola", "points": points, "runs_per_point": len(EIDOLA_RUNS),
                  "engines_equal": True, "paper": EIDOLA_PAPER, "planted_fault": rejected,
                  "seconds": time.perf_counter() - t0, "card": card})
    return lines


def _eidola_replay(card: str, bundles: dict) -> list:
    """Each capture trace replayed open-loop in the port's Eidola, SPIN and
    SYNCMON: the event engine on the host and the vector engine on the card,
    which must agree; the span must be above 0."""
    from repro_torch.core import SyncPolicy

    rows = []
    for name, bundle in bundles.items():
        for sync in SyncPolicy:
            t0 = time.perf_counter()
            r, row = _eidola_point(card, None, runs=(("event", "cpu"), ("vector", "cuda")),
                                   bundle=bundle, sync=sync)
            if not r.kernel_span_ns > 0:
                raise AssertionError(f"eidola replay of {name} ({sync.value}): span 0")
            rows.append(dict(row, trace=name, sync=sync.value, writes=len(bundle),
                             wtt_enacted=r.wtt_enacted, monitor_stats=r.monitor_stats,
                             seconds=time.perf_counter() - t0))
    return rows


# The closed loop: every row of BENCH_multi_device.json (written by the
# reference's benchmarks/multi_device_bench.py: SimConfig(workgroups=64,
# engine=EVENT), SPIN, collect_segments=False), flat and tiered, up to 4,096
# devices.  The record's engaged rows run the lockstep solvers on the card:
# the flat one on the single-tier ring, the tiered one on two_tier, fat_tree
# and rail_optimized.
CLUSTER_BENCH = Path(__file__).resolve().parent / "BENCH_multi_device.json"
CLUSTER_COUNTERS = ("flag_reads", "nonflag_reads", "xgmi_writes_in", "wtt_enacted",
                    "kernel_span_ns", "sim_cycles")
CLUSTER_CPU_MAX = 1024  # the card solver held to the CPU solver up to here
CLUSTER_TIMELINE_MAX = 256  # and to the host timeline engine up to here
CLUSTER_ROWS = 144
CLUSTER_HOST_WORKERS = 6  # processes running the host checks beside the card rows


def _cluster_rows() -> list:
    return json.loads(CLUSTER_BENCH.read_text())["rows"]


def _cluster_counters(report) -> dict:
    return {"flag_reads": report.flag_reads, "nonflag_reads": report.nonflag_reads,
            "xgmi_writes_in": report.traffic.get("xgmi_writes_in", 0),
            "wtt_enacted": report.wtt_enacted, "kernel_span_ns": report.kernel_span_ns,
            "sim_cycles": report.sim_cycles}


def _cluster_mismatch(got: dict, row: dict) -> list:
    """The counters of ``got`` that differ from the recorded row's."""
    return [k for k in CLUSTER_COUNTERS if got[k] != row[k]]


def _cluster_fields(report) -> dict:
    d = dataclasses.asdict(report)
    d.pop("wall_time_s")
    d["meta"].pop("wall_breakdown", None)
    d["meta"]["program_stats"].pop("construct_wall_s")
    return d


def _cluster_engine_counters(report) -> dict:
    """What the solver and the timeline engine both account exactly: every
    counter, per device, and the fabric's but its float queued aggregates."""
    fabric = {k: v for k, v in report.meta["fabric"].items() if not k.endswith("queued_ns")}
    return {**_cluster_counters(report), "traffic": report.traffic,
            "per_device": report.per_device, "fabric": fabric}


def _cluster_run(row: dict, device: str, **kw) -> tuple:
    from repro_torch.core import EngineKind, SimConfig, simulate

    cfg = SimConfig(workgroups=row["workgroups"], engine=EngineKind.EVENT)
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = simulate(row["scenario"], cfg, devices=row["devices"], closed_loop=True,
                      devices_per_node=row["devices_per_node"], fabric=row["fabric"],
                      collect_segments=False, device=device, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return report, time.perf_counter() - t0


def _cluster_host_check(row: dict, kind: str) -> tuple:
    """One host run of a row, in a worker process: ``"record"`` a row the
    record shows on the host engines (its counters and lockstep reason),
    ``"cpu"`` the CPU solver (its report's fields and solve time),
    ``"timeline"`` the host timeline engine (its counters); with the run's
    wall."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    if kind == "record":
        report, wall = _cluster_run(row, "cpu")
        return _cluster_counters(report), report.meta["lockstep_reason"], wall
    if kind == "cpu":
        report, wall = _cluster_run(row, "cpu")
        return _cluster_fields(report), report.meta["wall_breakdown"]["solve_s"], wall
    report, wall = _cluster_run(row, "cpu", lockstep=False)
    return _cluster_engine_counters(report), None, wall


def _cluster_out(row: dict, reason: str, got: dict) -> dict:
    """A row's line, and the fields that differ from the record's: its
    counters, and the lockstep reason if it does."""
    wrong = _cluster_mismatch(got, row)
    if reason != row["lockstep_reason"]:
        wrong.append("lockstep_reason")
    tiered = row["devices_per_node"] is not None
    return {"devices": row["devices"], "devices_per_node": row["devices_per_node"],
            "fabric": row["fabric"] or ("two_tier" if tiered else "ring"),
            "lockstep_reason": reason, "reference_wall_s": row["wall_time_s"]}, wrong


def _solver_kernels() -> dict:
    from repro_torch.kernels.numpy_sum import numpy_sum_cuda
    from repro_torch.kernels.ordered_scan import ordered_scan_cuda
    from repro_torch.kernels.port_chain import port_chain_cuda

    return {"ordered_scan": ordered_scan_cuda, "port_chain": port_chain_cuda,
            "numpy_sum": numpy_sum_cuda}


def phase_cluster(card: str) -> list:
    """The closed loop: every row of the record, its counters and its
    lockstep reason equal to the reference's; every engaged row solved on the
    card, equal to the CPU solver up to CLUSTER_CPU_MAX devices and to the
    host timeline engine up to CLUSTER_TIMELINE_MAX; a planted read rejected.
    The host runs (those checks, and the rows the record shows on the host
    engines, which touch no card) go to CLUSTER_HOST_WORKERS worker
    processes at once while the card runs its rows, so their walls are taken
    side by side.  The card runs all its rows before the first host result
    is read, so it never waits on the host.  One line a scenario, then the
    phase's line."""
    import concurrent.futures
    import multiprocessing

    t0 = time.perf_counter()
    rows = _cluster_rows()
    if len(rows) != CLUSTER_ROWS:
        raise AssertionError(f"cluster: {len(rows)} rows in the record, not {CLUSTER_ROWS}")
    pool = concurrent.futures.ProcessPoolExecutor(
        CLUSTER_HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        host = {}
        for i, row in enumerate(rows):
            if row["lockstep_reason"] != "engaged":
                host[i, "record"] = pool.submit(_cluster_host_check, row, "record")
            else:
                if row["devices"] <= CLUSTER_CPU_MAX:
                    host[i, "cpu"] = pool.submit(_cluster_host_check, row, "cpu")
                if row["devices"] <= CLUSTER_TIMELINE_MAX:
                    host[i, "timeline"] = pool.submit(_cluster_host_check, row, "timeline")
        # warm: the CUDA context and both solvers' first launches, outside the count
        _cluster_run(rows[0], "cuda")
        _cluster_run(next(r for r in rows if r["devices_per_node"] is not None
                          and r["lockstep_reason"] == "engaged"), "cuda")
        kernels = _solver_kernels()
        for fn in kernels.values():
            fn.launches = 0
        kernels["ordered_scan"].by_shape.clear()
        # the card rows first, without waiting on the host: their checks'
        # results are read in the second pass, once the card is done
        outs, mine = {}, {}
        for i, row in enumerate(rows):
            if (i, "record") in host:
                continue
            report, wall = _cluster_run(row, "cuda")
            outs[i] = _cluster_out(row, report.meta["lockstep_reason"], _cluster_counters(report))
            if row["lockstep_reason"] == "engaged" and outs[i][0]["lockstep_reason"] == "engaged":
                outs[i][0].update(solver="tiered" if row["devices_per_node"] is not None
                               else "flat", wall_card_s=wall,
                               solve_card_s=report.meta["wall_breakdown"]["solve_s"],
                               compile_card_s=report.meta["wall_breakdown"].get("compile_s"))
                if (i, "cpu") in host:
                    mine[i, "cpu"] = _cluster_fields(report)
                if (i, "timeline") in host:
                    mine[i, "timeline"] = _cluster_engine_counters(report)
            else:
                outs[i][0]["wall_host_s"] = wall
            del report
        lines, mismatches = {}, []
        for i, row in enumerate(rows):
            if (i, "record") in host:
                got, reason, wall = host[i, "record"].result()
                outs[i] = _cluster_out(row, reason, got)
                outs[i][0]["wall_host_s"] = wall
            out, wrong = outs[i]
            where = f"cluster {row['scenario']} {out['fabric']} {row['devices']}"
            if wrong:
                mismatches.append({"row": {k: row[k] for k in ("scenario", "devices",
                                                               "devices_per_node", "fabric")},
                                   "fields": wrong})
            if (i, "cpu") in mine:
                cpu, solve_cpu, cpu_wall = host[i, "cpu"].result()
                if mine[i, "cpu"] != cpu:
                    raise AssertionError(f"{where}: the card's {out['solver']} solver differs "
                                         "from the CPU solver")
                out.update(wall_cpu_s=cpu_wall, solve_cpu_s=solve_cpu)
            if (i, "timeline") in mine:
                counters, _, host_wall = host[i, "timeline"].result()
                if counters != mine[i, "timeline"]:
                    raise AssertionError(f"{where}: the card's {out['solver']} solver differs "
                                         "from the host timeline engine")
                out["wall_timeline_host_s"] = host_wall
            lines.setdefault(row["scenario"], []).append(out)
    finally:
        pool.shutdown(cancel_futures=True)
    launches = {k: fn.launches for k, fn in kernels.items()}
    if mismatches:
        raise AssertionError(f"cluster: {len(mismatches)} rows differ from "
                             f"BENCH_multi_device.json: {mismatches[:5]}")
    if not all(launches.values()):
        raise AssertionError(f"cluster: a solver kernel never launched: {launches}")
    # a planted fault: the comparison must reject one flag read too many
    row = rows[0]
    planted = dict(_cluster_counters(_cluster_run(row, "cpu")[0]))
    planted["flag_reads"] += 1
    rejected = _cluster_mismatch(planted, row)
    if rejected != ["flag_reads"]:
        raise AssertionError(f"cluster: a result with one flag read added gave {rejected}")
    out_lines = [{"phase": "cluster", "scenario": name, "rows": rs, "card": card}
                 for name, rs in lines.items()]
    # the ordered scan's launches by entry and shape: [entry, L, R, launches]
    out_lines.append({"phase": "cluster", "ordered_scan_launches_by_shape": [
        [*key, n] for key, n in sorted(kernels["ordered_scan"].by_shape.items())]})
    engaged = [r for rs in lines.values() for r in rs if "solver" in r]
    out_lines.append({"phase": "cluster", "rows": len(rows), "equal_to_record": True,
                      "lockstep_reason_equal_to_record": True,
                      "solved_on_card": {s: sum(r["solver"] == s for r in engaged)
                                         for s in ("flat", "tiered")},
                      "card_solver_equals_cpu_up_to": CLUSTER_CPU_MAX,
                      "timeline_checked_up_to": CLUSTER_TIMELINE_MAX,
                      "host_workers": CLUSTER_HOST_WORKERS,
                      "launches": launches, "planted_fault": rejected,
                      "seconds": time.perf_counter() - t0, "card": card})
    return out_lines


def _closed_loop_phases(card: str) -> tuple:
    """The tiered solver's two kernels at its shapes (the ``kernels``
    phase's entries for them), then the cluster phase, with the analysis
    phase beside it in a spawned process of its own; run in a process of
    their own, last (see ``in_spawned_process``)."""
    import concurrent.futures
    import multiprocessing

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiered = {"port_chain": _port_chain_at(gen), "numpy_sum": _numpy_sum_at(gen)}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        analysis = pool.submit(phase_analysis, card)
        cluster = phase_cluster(card)
        return tiered, cluster, analysis.result()


def phase_analysis(card: str) -> dict:
    """The port's static analyzer gate, ``python -m repro_torch.analysis`` at
    its defaults (its timeline stage simulating on the card): the verifier
    over every scenario x fabric, the timeline path, the loop-space verifier
    at 1,024 devices and the layout prover up to 4,096.  Its four summary
    lines must each end in "ok"."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.analysis.__main__ import main as gate

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = gate([])
    summary = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith(("verified ", "proved "))]
    if code != 0 or len(summary) != 4 or not all(ln.endswith(": ok") for ln in summary):
        raise AssertionError(f"analysis: the gate exited {code}: {buf.getvalue()[-2000:]}")
    return {"phase": "analysis", "gate": "python -m repro_torch.analysis", "exit": code,
            "summary": summary, "lines": len(buf.getvalue().splitlines()),
            "seconds": time.perf_counter() - t0, "card": card}


def _mamba_launches(counted) -> dict:
    """``{"mamba_decode": launches}`` of ``counted`` (``mamba_decode_cuda``)
    where it launched, else nothing: only a Mamba2 model's
    ``decode_launches`` names the kernel."""
    return {"mamba_decode": counted.launches} if counted.launches else {}


def phase_serve(card: str, arch: str) -> tuple:
    """``arch`` at full width (random bf16 weights from a seeded generator)
    through ServeEngine: REQUESTS x (PROMPT_LEN + NEW_TOKENS) tokens, greedy,
    with each kernel's launches counted from 0 over the run and held to
    ``decode_launches`` a step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.mamba_decode import mamba_decode_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import Model
    from repro_torch.models.model import decode_launches, init_caches
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = get_config(arch)  # full width, bf16
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (REQUESTS, PROMPT_LEN)).tolist()

    # one decode step on its own: finite logits of the expected shape
    caches = model.init_caches(REQUESTS, 8)
    logits = model.decode_step(caches, torch.tensor([p[0] for p in prompts], device=dev), 0)[0]
    if logits.shape != (REQUESTS, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: bad first-step logits {tuple(logits.shape)}")
    del caches
    ServeEngine(model, ServeConfig(max_batch=REQUESTS)).generate(
        [p[:8] for p in prompts], 2)  # warm-up: cuBLAS handles, allocator

    eng = ServeEngine(model, ServeConfig(max_batch=REQUESTS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    rmsnorm_cuda.launches = decode_attention_cuda.launches = mamba_decode_cuda.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm_cuda.launches,
                "decode_attention": decode_attention_cuda.launches,
                **_mamba_launches(mamba_decode_cuda)}

    steps = eng.stats["prefill_tokens"] // REQUESTS + eng.stats["decode_steps"]
    if steps != PROMPT_LEN + NEW_TOKENS:
        raise AssertionError(f"{steps} decode steps, expected {PROMPT_LEN + NEW_TOKENS}")
    per_step = decode_launches(cfg)
    if per_step != SERVE_LAUNCHES_PER_STEP[arch]:
        raise AssertionError(f"{arch}: decode_launches gives {per_step}, the path has "
                             f"{SERVE_LAUNCHES_PER_STEP[arch]}")
    expect = {k: n * steps for k, n in per_step.items()}
    if launches != expect:
        raise AssertionError(f"{arch}: kernel launches {launches} != {expect}")
    if not all(len(o) == PROMPT_LEN + NEW_TOKENS and all(0 <= t < cfg.vocab for t in o)
               for o in outs):
        raise AssertionError(f"{arch}: served outputs have the wrong length or token range")
    # the caches of the run by kind, from their shapes alone
    cache_bytes = {"kv": 0, "recurrent_state": 0}
    for c in init_caches(cfg, REQUESTS, PROMPT_LEN + NEW_TOKENS, torch.device("meta")):
        kind = "kv" if {"k", "c_kv"} & set(c) else "recurrent_state"
        cache_bytes[kind] += sum(t.numel() * t.element_size() for t in c.values())
    return model, {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers, "params": model.n_params(),
        "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
        "cache_bytes": cache_bytes,
        "dtype": "bfloat16", "requests": REQUESTS, "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS, "decode_steps": steps, "stats": eng.stats,
        "launches": launches, "launches_per_step": per_step, "expected_launches": expect,
        "wall_s": wall, "new_tokens_per_s": REQUESTS * NEW_TOKENS / wall,
        "ms_per_step": wall * 1e3 / steps, "init_s": init_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "allocated_at_start_bytes": allocated_at_start, "card": card,
    }


def _grouped_gemm_keys(block, reps: int = 5, attempts: int = PROFILE_ATTEMPTS) -> set:
    """Names of the device kernels that ``torch._grouped_mm`` runs for a MoE
    block's two product shapes (gate / up, and down) at the decode batch,
    from a profile of those calls alone; made again, up to ``attempts``
    profiles, if the profiler dropped their activity records."""
    p, cfg = block.moe, block.cfg
    rows = REQUESTS * cfg.experts_per_token
    offs = torch.linspace(0, rows, cfg.n_experts + 1, device="cuda")[1:].to(torch.int32)
    xs = torch.randn(rows, cfg.d_model, device="cuda").to(p["w_gate"].dtype)
    h = torch.randn(rows, cfg.d_ff, device="cuda").to(p["w_gate"].dtype)

    def calls():
        for _ in range(reps):
            torch._grouped_mm(xs, p["w_gate"], offs=offs)
            torch._grouped_mm(h, p["w_down"], offs=offs)

    calls()
    for attempt in range(attempts):
        time.sleep(PROFILE_PAUSE_S * attempt)
        torch.cuda.synchronize()
        profiled, _ = _profiled(calls, calls)
        found, _ = _device_ms_per_launch(profiled, ())
        if found:
            return {key for key, _, _ in found}
    raise AssertionError(f"in {attempts} profiles the profiler saw no device kernel of "
                         "torch._grouped_mm")


def phase_profile(model, end: int = PROMPT_LEN + NEW_TOKENS, steps: int = 32) -> dict:
    """Device time by kernel over the decode steps at positions [end - steps, end).

    The same steps also run without the profiler just before and just after
    it.  The idle share reads the profiled device busy time against the run
    before; the run after shows how far the host-bound wall of the same
    device work moves inside one call.  The profiled run follows one warm-up
    step whose events are dropped, and is made again (up to
    PROFILE_ATTEMPTS runs) until the profile holds every launch of the
    port's kernels that the steps made.  The caches hold zeros, which changes
    no kernel's work: attention reads min(pos + 1, S) slots whatever they
    hold.  The tokens are drawn from a seeded generator, a new one for every
    row and step, so a MoE model routes them as it would a real batch; for
    one, the grouped GEMMs' device time per step stands beside their byte
    bound, counted from the experts that each step's routing touches.
    """
    from repro_torch.models.model import MoEBlock, decode_launches

    cfg = model.cfg
    caches = model.init_caches(REQUESTS, end)
    toks = torch.randint(1, cfg.vocab, (steps + 1, REQUESTS),
                         generator=torch.Generator().manual_seed(5)).cuda()
    warm_step = lambda: model.decode_step(caches, toks[-1], end - steps - 1)  # noqa: E731
    warm_step()
    moe_blocks = [b for b in model.blocks if isinstance(b, MoEBlock)]
    routes = []

    def run_steps() -> float:
        routes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, pos in enumerate(range(end - steps, end)):
            model.decode_step(caches, toks[i], pos)
            routes.append([b.routing for b in moe_blocks])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_before = run_steps()
    expect = {k: n * steps for k, n in decode_launches(cfg).items() if n}
    for attempt in range(PROFILE_ATTEMPTS):
        time.sleep(PROFILE_PAUSE_S * attempt)
        profiled, wall_ms = _profiled(warm_step, run_steps)
        rows, per_kernel = _device_ms_per_launch(profiled, SERVE_KERNELS)
        seen = {k: (per_kernel[k] or {}).get("launches") for k in expect}
        if seen == expect:
            break
    else:
        raise AssertionError(f"{cfg.name}: in {PROFILE_ATTEMPTS} profiles of {steps} steps the "
                             f"profiler saw {seen} launches of the port's kernels, not {expect}")
    plain_after = run_steps()

    busy_ms = sum(r[1] for r in rows) / 1e3
    out = {"phase": "profile", "arch": cfg.name, "layers": cfg.n_layers, "steps": steps,
           "profile_sessions": attempt + 1,
           "positions": [end - steps, end - 1],
           "wall_ms_per_step_profiled": wall_ms / steps,
           "wall_ms_per_step_unprofiled": plain_before / steps,
           "wall_ms_per_step_after_profiler": plain_after / steps,
           "device_busy_ms_per_step": busy_ms / steps,
           "device_launches_per_step": sum(r[2] for r in rows) / steps,
           "device_idle_share_profiled": 1 - busy_ms / wall_ms,
           "device_idle_share": 1 - busy_ms / plain_before,
           "kernels": per_kernel,
           "top": [{"name": key[:80], "device_ms_per_step": us / 1e3 / steps, "count": n}
                   for key, us, n in rows[:12]]}
    if moe_blocks:
        keys = _grouped_gemm_keys(moe_blocks[0])
        gemm_ms = sum(us for key, us, _ in rows if key in keys) / 1e3 / steps
        touched = [[int(torch.unique(r).numel()) for r in step] for step in routes]
        d, ff = cfg.d_model, cfg.d_ff
        expert_bytes = 3 * d * ff * 2
        tk = REQUESTS * cfg.experts_per_token  # rows of the grouped products a layer
        act_bytes = (tk * d + 2 * tk * ff + tk * ff + tk * d) * 2  # xs, g, u, h, y
        nbytes = sum(n * expert_bytes + act_bytes for step in touched for n in step)
        flops = 2 * 3 * tk * d * ff * len(moe_blocks) * steps
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        out["grouped_gemm"] = {
            "device_ms_per_step": gemm_ms, "bound_ms_per_step": b_ms / steps, "bound_by": b_by,
            "kernels": sorted(k[:80] for k in keys),
            "launches_per_step": sum(n for key, _, n in rows if key in keys) / steps,
            "expert_bytes": expert_bytes,
            "experts_touched_per_layer_mean": float(np.mean(touched)),
            "experts_touched_per_layer_min_max": [int(np.min(touched)), int(np.max(touched))],
            "bytes_per_step": nbytes / steps}
    return out


def phase_families(card: str) -> dict:
    """Every other attention-family config at full width with its depth cut
    (FAMILIES): REQUESTS x (FAMILY_PROMPT + FAMILY_NEW) tokens through
    ServeEngine with exact kernel launches, ms per step, peak memory and a
    profile of the last decode steps.  decode_attention at each config's head
    layout beside SDPA is timed in the kernels phase (_family_heads)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.mamba_decode import mamba_decode_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import Model
    from repro_torch.models.model import decode_launches
    from repro_torch.serving import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    out, t_start = {}, time.perf_counter()
    for arch, layers in FAMILIES.items():
        full = get_config(arch)
        cfg = full.with_(n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = np.random.default_rng(0).integers(1, cfg.vocab,
                                                    (REQUESTS, FAMILY_PROMPT)).tolist()
        caches = model.init_caches(REQUESTS, 8)
        logits = model.decode_step(caches, torch.tensor([p[0] for p in prompts], device=dev), 0)[0]
        if logits.shape != (REQUESTS, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{arch}: bad first-step logits {tuple(logits.shape)}")
        del caches
        ServeEngine(model, ServeConfig(max_batch=REQUESTS)).generate([p[:4] for p in prompts], 2)
        eng = ServeEngine(model, ServeConfig(max_batch=REQUESTS))
        torch.cuda.synchronize()
        rmsnorm_cuda.launches = decode_attention_cuda.launches = mamba_decode_cuda.launches = 0
        t0 = time.perf_counter()
        outs = eng.generate(prompts, FAMILY_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = FAMILY_PROMPT + FAMILY_NEW
        launches = {"rmsnorm": rmsnorm_cuda.launches,
                    "decode_attention": decode_attention_cuda.launches,
                    **_mamba_launches(mamba_decode_cuda)}
        expect = {k: n * steps for k, n in decode_launches(cfg).items()}
        if launches != expect:
            raise AssertionError(f"{arch}: kernel launches {launches} != {expect}")
        if not all(len(o) == steps and all(0 <= t < cfg.vocab for t in o) for o in outs):
            raise AssertionError(f"{arch}: served outputs have the wrong length or token range")
        entry = {"layers": layers, "cut": {"n_layers": [full.n_layers, layers]},
                 "params": model.n_params(), "init_s": init_s, "launches": launches,
                 "wall_s": wall, "ms_per_step": wall * 1e3 / steps,
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        prof = phase_profile(model, end=steps, steps=8)
        entry["profile"] = {k: prof[k] for k in ("device_busy_ms_per_step",
                                                 "wall_ms_per_step_unprofiled",
                                                 "device_idle_share", "kernels", "top")}
        if "grouped_gemm" in prof:
            entry["profile"]["grouped_gemm"] = prof["grouped_gemm"]
        del model, eng
        torch.cuda.empty_cache()
        out[arch] = entry
    return {"phase": "families", "requests": REQUESTS, "prompt_len": FAMILY_PROMPT,
            "new_tokens": FAMILY_NEW, "dtype": "bfloat16", "card": card,
            "seconds": time.perf_counter() - t_start, "configs": out}


def phase_parity() -> dict:
    """Each family's reduced config in float32 on the card and on the CPU, on
    the same weights: first-step logits within F32_LOGIT_TOL,
    the MoE routing indices of every step identical, and greedy tokens and
    engine stats identical."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    from repro_torch.models.model import MoEBlock
    from repro_torch.serving import ServeConfig, ServeEngine

    out = {}
    for arch in PARITY_ARCHS:
        cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32)
        gpu = Model(cfg).init(torch.Generator().manual_seed(1))
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        gc, cc = gpu.init_caches(2, 12), cpu.init_caches(2, 12)
        err, routes_equal = 0.0, 0
        for pos in range(8):
            toks = torch.tensor([5 + pos, 9])
            lg, _ = gpu.decode_step(gc, toks.cuda(), pos)
            lc, _ = cpu.decode_step(cc, toks, pos)
            if pos == 0:
                err = (lg.cpu() - lc).abs().max().item()
            for gb, cb in zip(gpu.blocks, cpu.blocks):
                if isinstance(cb, MoEBlock):
                    if not torch.equal(gb.routing.cpu(), cb.routing):
                        raise AssertionError(f"{arch}: routing differs at step {pos}")
                    routes_equal += 1
        if not err <= F32_LOGIT_TOL:
            raise AssertionError(f"{arch}: first-step logits differ by {err} > {F32_LOGIT_TOL}")
        prompts = [[5, 6, 7], [9, 10], [1, 2, 3, 4],
                   np.random.default_rng(1).integers(1, cfg.vocab, 21).tolist()]
        res = {}
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            eng = ServeEngine(model, ServeConfig(max_batch=2))
            res[name] = (eng.generate(prompts, 12), dict(eng.stats))
        if res["cuda"] != res["cpu"]:
            raise AssertionError(f"{arch}: greedy tokens or stats differ between card and CPU")
        out[arch] = {"first_step_logit_max_abs_err": err, "routing_checks": routes_equal,
                     "greedy_tokens_identical": True, "stats": res["cuda"][1]}
    return {"phase": "parity", "dtype": "float32", "tolerance": F32_LOGIT_TOL, "configs": out}


def _train_profile(trainer, batch, expect: dict) -> tuple:
    """Device time by kernel over one train step (torch.profiler), after one
    warm-up step whose events are dropped; made again (up to PROFILE_ATTEMPTS
    profiles) until the profile holds the step's rmsnorm forward and
    backward launches.  Returns (device rows, metrics of the profiled step,
    profiles made)."""
    for attempt in range(PROFILE_ATTEMPTS):
        time.sleep(PROFILE_PAUSE_S * attempt)
        profiled, (trainer.opt_state, metrics) = _profiled(
            lambda: trainer.step_fn(trainer.opt_state, batch["tokens"], batch["labels"]),
            lambda: trainer.step_fn(trainer.opt_state, batch["tokens"], batch["labels"]),
            host_ops=False)
        rows, _ = _device_ms_per_launch(profiled, ())
        seen = {"rmsnorm": sum(n for key, _, n in rows if "::rmsnorm_kernel<" in key),
                "rmsnorm_bwd": sum(n for key, _, n in rows if "::rmsnorm_bwd_kernel<" in key)}
        if seen == expect:
            return rows, metrics, attempt + 1
    raise AssertionError(f"in {PROFILE_ATTEMPTS} profiles of a train step the profiler saw "
                         f"{seen} rmsnorm launches, not {expect}")


def phase_train(card: str, arch: str) -> dict:
    """``arch`` at full width and depth trained on the card through Trainer:
    seeded bf16 weights with float32 master, AdamW, the synthetic data
    (vocabulary TRAIN_DATA_VOCAB) through prefetch, as launch/train.py runs
    it.  The kernels' counts are set to 0 just before the run and read just
    after: exact rmsnorm forward and backward launches a step.  Then one
    profiled step: device busy ms, idle share against the median unprofiled
    step, the top device rows."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, prefetch
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, Trainer

    batch, seq, mb, steps, lr, warmup = TRAIN_RUNS[arch]
    cfg = get_config(arch)  # full width and depth, bf16
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)
    tcfg = TrainConfig(microbatches=mb, optim=AdamWConfig(lr=lr, warmup_steps=warmup,
                                                          total_steps=steps))
    trainer = Trainer(model, tcfg)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLMDataset(DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=seq,
                                         global_batch=batch))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    # bf16 parameter and gradient, float32 master, mu and nu
    state_bytes = 2 * param_bytes + 12 * n_params
    batches = prefetch(iter(data))

    torch.cuda.synchronize()
    allocated_at_start = torch.cuda.memory_allocated()
    rmsnorm_cuda.launches = rmsnorm_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.run(batches, steps, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm_cuda.launches, "rmsnorm_bwd": rmsnorm_bwd_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    per_step = TRAIN_LAUNCHES_PER_STEP[arch]
    expect = {k: n * steps for k, n in per_step.items()}
    if launches != expect:
        raise AssertionError(f"{arch} train: kernel launches {launches} != {expect}")
    losses = [h["loss"] for h in history]
    if len(history) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} train: history {history}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} train: loss did not fall, {losses}")
    step_ms = [h["dt"] * 1e3 for h in history]
    median_ms = float(np.median(step_ms[1:]))
    tokens_per_step = batch * seq

    rows, metrics, sessions = _train_profile(trainer, next(batches), per_step)
    busy_ms = sum(r[1] for r in rows) / 1e3
    bwd_ms = sum(us for key, us, _ in rows if "::rmsnorm_bwd" in key) / 1e3
    fwd_ms = sum(us for key, us, _ in rows if "::rmsnorm_kernel<" in key) / 1e3
    grad_norm = float(metrics["grad_norm"])
    if not np.isfinite(grad_norm):
        raise AssertionError(f"{arch} train: grad norm {grad_norm}")
    out = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "dtype": "bfloat16", "master": "float32", "batch": batch, "seq": seq,
           "microbatches": mb, "steps": steps, "lr": lr, "warmup_steps": warmup,
           "data_vocab": TRAIN_DATA_VOCAB, "model_vocab": cfg.vocab, "remat": "none",
           "init_s": init_s, "wall_s": wall, "step_ms": step_ms,
           "ms_per_step_median_2_on": median_ms,
           "tokens_per_s": tokens_per_step / (median_ms * 1e-3),
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "grad_norms": [h["grad_norm"] for h in history],
           "grad_norm_profiled_step": grad_norm,
           "launches": launches, "launches_per_step": per_step, "expected_launches": expect,
           "peak_mem_bytes": peak, "allocated_at_start_bytes": allocated_at_start,
           "param_bytes": param_bytes, "param_grad_optimizer_bytes": state_bytes,
           "profile": {"sessions": sessions, "device_busy_ms": busy_ms,
                       "device_idle_share": 1 - busy_ms / median_ms,
                       "device_launches": sum(r[2] for r in rows),
                       "rmsnorm_device_ms": fwd_ms, "rmsnorm_bwd_device_ms": bwd_ms,
                       "top": [{"name": key[:80], "device_ms": us / 1e3, "count": n}
                               for key, us, n in rows[:15]]},
           "card": card}
    del trainer, model, batches
    torch.cuda.empty_cache()
    return out


def _near_zero_grads(model, tokens, labels) -> dict:
    """Entries whose gradient at the model's current weights is nonzero and
    below G_NOISE: AdamW's first updates are about lr times their sign, so
    float32 rounding there can move the update by up to a whole one."""
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss_fn(tokens, labels)
    loss.backward()
    out = {n: (p.grad != 0) & (p.grad.abs() < G_NOISE) for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def phase_train_parity() -> dict:
    """Each TRAIN_PARITY_ARCHS config reduced, float32, on the card and on
    the CPU from the same weights: the loss and every gradient of one batch;
    then the parameters after 3 AdamW steps through build_train_step.  Then a
    checkpoint/restart drill on the card: Trainer with ckpt_every 2 and a
    SimulatedFailure before step 4, the restored tensors bit for bit those
    saved, and the history longer than its steps."""
    from repro_torch.checkpoint import load_tree
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.ft import SimulatedFailure
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import TrainConfig, Trainer, build_train_step

    out = {}
    for arch in TRAIN_PARITY_ARCHS:
        cfg = reduced(get_config(arch)).with_(param_dtype=torch.float32)
        gpu = Model(cfg).init(torch.Generator().manual_seed(1))
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        rng = np.random.default_rng(0)
        batches = [(torch.from_numpy(rng.integers(0, cfg.vocab, (4, 24))),
                    torch.from_numpy(rng.integers(0, cfg.vocab, (4, 24)))) for _ in range(3)]
        res = {}
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            model.requires_grad_(True)
            loss, _ = model.loss_fn(batches[0][0].to(model.device), batches[0][1].to(model.device))
            loss.backward()
            res[name] = (loss.item(), {n: p.grad.detach().cpu() for n, p in
                                       model.named_parameters()})
            model.zero_grad(set_to_none=True)
        loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        grad_ratio = max(((res["cuda"][1][n] - g).abs().max() /
                          (TRAIN_PARITY_TOL * max(g.abs().max().item(), 1e-6))).item()
                         for n, g in res["cpu"][1].items())
        if loss_err > TRAIN_PARITY_TOL or grad_ratio > 1.0:
            raise AssertionError(f"{arch}: loss differs by {loss_err}, gradients' worst ratio "
                                 f"{grad_ratio}")
        tcfg = TrainConfig(optim=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6))
        noisy = {n: torch.zeros(p.shape, dtype=torch.bool) for n, p in cpu.named_parameters()}
        lr_sum = 0.0
        steps = {name: build_train_step(m, tcfg) for name, m in (("cuda", gpu), ("cpu", cpu))}
        states = {name: adamw_init(dict(m.named_parameters()), tcfg.optim)
                  for name, m in (("cuda", gpu), ("cpu", cpu))}
        for tokens, labels in batches:
            for n, m in _near_zero_grads(cpu, tokens, labels).items():
                noisy[n] |= m
            for name, m in (("cuda", gpu), ("cpu", cpu)):
                states[name], metrics = steps[name](states[name], tokens.to(m.device),
                                                    labels.to(m.device))
            lr_sum += float(metrics["lr"])
        param_ratio, outside, n_total = 0.0, 0, 0
        cpu_params = dict(cpu.named_parameters())
        for n, p in gpu.named_parameters():
            want = cpu_params[n].detach()
            diff = (p.detach().cpu() - want).abs()
            lim = TRAIN_PARITY_TOL * (1 + want.abs())
            out_mask = diff > lim
            if not (bool(noisy[n][out_mask].all()) and bool((diff[out_mask] <= 2 * lr_sum).all())):
                raise AssertionError(f"{arch}: parameter {n} differs beyond {TRAIN_PARITY_TOL} "
                                     f"at an entry whose gradient is not near zero")
            outside += int(out_mask.sum())
            n_total += p.numel()
            param_ratio = max(param_ratio, (diff[~out_mask] / lim[~out_mask]).max().item()
                              if (~out_mask).any() else 0.0)
        if outside > 1e-4 * n_total:
            raise AssertionError(f"{arch}: {outside} of {n_total} parameters outside the bound")
        out[arch] = {"loss_rel_err": loss_err, "grad_worst_ratio": grad_ratio,
                     "params_after_3_steps_worst_ratio": param_ratio,
                     "entries_held_to_2_lr_sum": outside, "params": n_total,
                     "gradients": len(res["cpu"][1])}
        del gpu, cpu

    # the drill: reduced gemma3-1b in bf16 (float32 state) on the card
    cfg = reduced(get_config("gemma3-1b"))
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    if ckpt_dir.exists():
        import shutil
        shutil.rmtree(ckpt_dir)
    fails = {3}

    def inject(step):
        if step in fails:
            fails.discard(step)
            raise SimulatedFailure(f"injected before step {step + 1}")

    n_steps = 6
    model = Model(cfg)
    tr = Trainer(model, TrainConfig(optim=AdamWConfig(lr=1e-2, warmup_steps=2,
                                                      total_steps=n_steps)),
                 ckpt_dir=str(ckpt_dir), ckpt_every=2, failure_injector=inject)
    tr.init_state(torch.Generator(device="cuda").manual_seed(0))
    data = iter(SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)))
    hist = tr.run(data, n_steps, log_every=0)
    if not (len(hist) > n_steps and [h["step"] for h in hist] == [1, 2, 3, 3, 4, 5, 6]):
        raise AssertionError(f"drill history {hist}")
    shapes = {n: torch.empty_like(p, device="meta") for n, p in model.named_parameters()}
    saved = load_tree({"params": shapes, "state": adamw_init(shapes, tr.tcfg.optim)},
                      str(ckpt_dir / f"step_{n_steps:07d}"), torch.device("cuda"))
    same = all(torch.equal(saved["params"][n], p) for n, p in model.named_parameters())
    same &= torch.equal(saved["state"]["step"], tr.opt_state["step"])
    same &= all(torch.equal(saved["state"][k][n], tr.opt_state[k][n])
                for k in ("mu", "nu", "master") for n in shapes)
    if not same:
        raise AssertionError("the checkpoint does not give back the trained tensors bit for bit")
    # a restart restores those tensors into a fresh model
    model2 = Model(cfg)
    tr2 = Trainer(model2, tr.tcfg, ckpt_dir=str(ckpt_dir), ckpt_every=2)
    if not (tr2.maybe_restore() and tr2.step == n_steps and all(
            torch.equal(p, saved["params"][n]) for n, p in model2.named_parameters())):
        raise AssertionError("maybe_restore did not restore the last checkpoint bit for bit")
    drill = {"arch": cfg.name, "dtype": "bfloat16", "steps": n_steps, "failure_before_step": 4,
             "history_steps": [h["step"] for h in hist], "checkpoints": tr.ckpt.steps(),
             "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
             "restored_bit_for_bit": True}
    return {"phase": "train_parity", "dtype": "float32", "tolerance": TRAIN_PARITY_TOL,
            "g_noise": G_NOISE, "configs": out, "drill": drill}


def _sharded_rank(rank: int, world: int, arch: str) -> dict:
    """One rank of the sharded phase, in its own spawned process: ``arch``
    at full width and depth on SHARDED_MESH through Trainer, its parameters
    drawn whole from the train phase's seed and sliced, the train phase's
    batches.  The kernels' counts and the exchanged bytes are set to 0 just
    before the steps and read just after."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.capture import capture_collectives
    from repro_torch.data import DataConfig, SyntheticLMDataset, prefetch
    from repro_torch.distributed.collectives import EXCHANGED, exchange_device
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    batch, seq, mb, steps, lr, warmup = TRAIN_RUNS[arch]
    mesh = Mesh(SHARDED_MESH).bind()
    t0 = time.perf_counter()
    model = Model(get_config(arch))
    tcfg = TrainConfig(microbatches=mb, optim=AdamWConfig(lr=lr, warmup_steps=warmup,
                                                          total_steps=steps))
    trainer = Trainer(model, tcfg, mesh=mesh)
    trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLMDataset(DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=seq,
                                         global_batch=batch))
    batches = prefetch(iter(data))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    n_local = sum(p.numel() for p in params.values())
    state_bytes = sum(t.numel() * t.element_size() for key in ("mu", "nu", "master")
                      for t in trainer.opt_state[key].values())
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_cuda.launches = rmsnorm_bwd_cuda.launches = 0
    EXCHANGED.clear()
    schedules, step_fn = [], trainer.step_fn

    def capturing(*args, **kwargs):  # each step's schedule, as the rank ran it
        with capture_collectives() as ops:
            out = step_fn(*args, **kwargs)
        schedules.append([dataclasses.asdict(o) for o in ops])
        return out

    trainer.step_fn = capturing
    with recording_grad_squares(trainer) as squares:
        history = trainer.run(batches, SHARDED_STEPS, log_every=0)
    torch.cuda.synchronize()
    launches = {"rmsnorm": rmsnorm_cuda.launches, "rmsnorm_bwd": rmsnorm_bwd_cuda.launches}
    exchanged = {k: v / SHARDED_STEPS for k, v in EXCHANGED.items()}
    return {"rank": rank, "coord": mesh.coord, "backend": str(dist.get_backend()),
            "exchange_device": str(exchange_device(params["embed"])),
            "init_s": init_s, "history": history, "squares": squares, "launches": launches,
            "bytes_exchanged_per_step": exchanged,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "param_bytes": param_bytes,
            # .grad in the param dtype and the float32 microbatch buffers
            "grad_buffer_bytes": param_bytes + 4 * n_local,
            "zero1_state_bytes": state_bytes,
            "schedules": schedules, "exchanged": dict(EXCHANGED),
            "unpartitioned": step_fn.unpartitioned,
            "fallbacks": trainer.fallbacks}


def phase_sharded(card: str, single: dict) -> tuple:
    """gemma3-1b at full width and depth on a (2, 2) mesh: 4 ranks, one
    process each, sharing the card; each step's loss and the first steps'
    gradient norms held to the one-rank train phase's (``single``), the first
    step's norm of each tensor kind to a one-rank rerun's.  Returns the
    phase's line and the ranks' results (their schedules for the capture)."""
    from repro_torch.distributed import run_world

    arch = TRAIN_MAIN
    t0 = time.perf_counter()
    world = SHARDED_MESH["data"] * SHARDED_MESH["model"]
    ranks = run_world(_sharded_rank, world, arch, timeout=900)
    seconds = time.perf_counter() - t0
    base = _one_rank(arch, TRAIN_RUNS[arch][2])
    control = _one_rank(arch, SHARDED_CONTROL_MICROBATCHES)
    per_step = TRAIN_LAUNCHES_PER_STEP[arch]
    expect = {k: n * SHARDED_STEPS for k, n in per_step.items()}
    want_loss = single["losses"][:SHARDED_STEPS]
    want_gnorm = single["grad_norms"][:SHARDED_STEPS]
    control_dev = [(a - b) / b for a, b in zip(control["grad_norms"], want_gnorm)]
    # each kind's norm a step: the pieces that count are spread over the ranks
    kinds = [{k: sum(r["squares"][i].get(k, 0.0) for r in ranks) ** 0.5
              for k in base["kinds"][i]} for i in range(SHARDED_STEPS)]
    kind_dev = [{k: (v - b[k]) / b[k] for k, v in got.items()}
                for got, b in zip(kinds, base["kinds"])]
    if max(abs(v) for v in kind_dev[0].values()) >= SHARDED_GNORM_RTOL:
        raise AssertionError(f"step 1's gradient norms by tensor kind moved {kind_dev[0]}")
    for r in ranks:
        if r["launches"] != expect:
            raise AssertionError(f"rank {r['rank']}: rmsnorm launches {r['launches']} != "
                                 f"{expect}")
        losses = [h["loss"] for h in r["history"]]
        gnorm_dev = [(h["grad_norm"] - b) / b for h, b in zip(r["history"], want_gnorm)]
        loss_err = max(abs(a - b) for a, b in zip(losses, want_loss))
        if (not loss_err < SHARDED_LOSS_TOL
                or not max(map(abs, gnorm_dev[:SHARDED_GNORM_STEPS])) < SHARDED_GNORM_RTOL):
            raise AssertionError(f"rank {r['rank']}: losses {losses} against {want_loss}, "
                                 f"grad norms moved {gnorm_dev}")
        r.update(loss_max_abs_err=loss_err, grad_norm_rel_dev=gnorm_dev)
    if len({tuple(h["loss"] for h in r["history"]) for r in ranks}) != 1:
        raise AssertionError("the ranks disagree on the loss")
    step_ms = [[h["dt"] * 1e3 for h in r["history"]] for r in ranks]
    return {"phase": "sharded", "arch": arch, "mesh": SHARDED_MESH, "ranks": world,
            "exchange": f"{ranks[0]['backend']} "
                        + ("via host" if ranks[0]["exchange_device"] == "cpu" else "on card"),
            "note": "4 ranks are 4 processes sharing one card; the walls measure the "
                    "host exchange, not a speed",
            "steps": SHARDED_STEPS, "losses": [h["loss"] for h in ranks[0]["history"]],
            "single_rank_losses": want_loss,
            "grad_norms": [h["grad_norm"] for h in ranks[0]["history"]],
            "single_rank_grad_norms": want_gnorm,
            "grad_norm_by_kind_rel_dev": kind_dev,
            "grad_norm_by_kind_max_abs_rel_dev": [max(abs(v) for v in d.values())
                                                  for d in kind_dev],
            "rerun_grad_norms": base["grad_norms"],
            "control": {"microbatches": SHARDED_CONTROL_MICROBATCHES,
                        "losses": control["losses"], "grad_norms": control["grad_norms"],
                        "grad_norm_rel_dev": control_dev},
            "loss_tolerance": SHARDED_LOSS_TOL,
            "grad_norm_rtol": SHARDED_GNORM_RTOL,
            "grad_norm_steps_held": SHARDED_GNORM_STEPS,
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in per_step},
            "launches_per_step_and_rank": per_step,
            "step_ms_rank0": step_ms[0],
            "ms_per_step_median_2_on": float(np.median([ms[1:] for ms in step_ms])),
            "per_rank": [{key: r[key] for key in (
                "rank", "coord", "init_s", "peak_mem_bytes", "param_bytes",
                "grad_buffer_bytes", "zero1_state_bytes", "bytes_exchanged_per_step",
                "launches", "loss_max_abs_err", "grad_norm_rel_dev")}
                for r in ranks],
            "unpartitioned": ranks[0]["unpartitioned"], "fallbacks": ranks[0]["fallbacks"],
            "seconds": seconds, "card": card}, ranks


def _first_difference(got: list, want: list) -> str:
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"op {i}: executed {a} against abstract {b}"
    return f"{len(got)} ops executed against {len(want)} abstract"


def _card_rates() -> dict:
    """The card's bf16 matmul and device-to-device copy rates, by CUDA events,
    beside H100_SXM's data-sheet peaks."""
    from repro_torch.core.interconnect import H100_SXM

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(MATMUL_N, MATMUL_N, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(MATMUL_N, MATMUL_N, device="cuda", generator=gen).to(torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(a, b), iters=20, warmup=5)
    tflops = 2 * MATMUL_N ** 3 / (mm_ms * 1e-3) / 1e12
    del a, b
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cp_ms = time_ms(lambda: dst.copy_(src), iters=20, warmup=5)
    tbs = 2 * COPY_BYTES / (cp_ms * 1e-3) / 1e12  # each byte read once and written once
    del src, dst
    torch.cuda.empty_cache()
    return {"matmul": {"n": MATMUL_N, "dtype": "bfloat16", "ms": mm_ms, "tflops": tflops,
                       "spec_tflops": H100_SXM.peak_flops_bf16 / 1e12,
                       "share_of_spec": tflops * 1e12 / H100_SXM.peak_flops_bf16},
            "copy": {"bytes": COPY_BYTES, "ms": cp_ms, "tb_per_s": tbs,
                     "spec_tb_per_s": H100_SXM.hbm_bw / 1e12,
                     "share_of_spec": tbs * 1e12 / H100_SXM.hbm_bw}}


def _abstract_trace(job: tuple) -> tuple:
    """One abstract trace of the capture phase, in a spawned process of its
    own with no world and no card: ``("rank", r)`` the sharded step of rank r
    on SHARDED_MESH, ``("cell", arch, shape, mesh)`` a dry-run cell's record,
    ``("one_card",)`` the train phase's step with no mesh.  Returns (result,
    host seconds)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import run_cell, trace_cell
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    batch, seq, mb = TRAIN_RUNS[TRAIN_MAIN][:3]
    shape = ShapeSpec("chip_train", seq, batch, "train")
    if job[0] == "cell":
        out = run_cell(*job[1:], verbose=False)
    else:
        mesh = Mesh(SHARDED_MESH) if job[0] == "rank" else None
        out = trace_cell(get_config(TRAIN_MAIN), shape, mesh, job[1] if mesh else 0,
                         {"microbatches": mb})
    return out, time.perf_counter() - t0


def phase_capture(card: str, ranks: list, single: dict) -> dict:
    """The capture bridge against the card (see the module's doc): the
    sharded ranks' recorded schedules (``ranks``) against their abstract
    captures, the dry-run cells on H100_SXM, the one-card train cell against
    the train phase's device busy time (``single``), and the card's rates.
    The abstract traces run at once, one spawned process each."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.core.capture import CollectiveOp, KINDS, by_kind, schedule_to_trace
    from repro_torch.core.interconnect import H100_SXM
    from repro_torch.core.predictor import predict_step, roofline
    from repro_torch.launch.dryrun import schedule_of
    from repro_torch.launch.roofline import topo_for

    t_start = time.perf_counter()
    arch = TRAIN_MAIN
    batch, seq, mb = TRAIN_RUNS[arch][:3]
    per_step = TRAIN_LAUNCHES_PER_STEP[arch]
    names = {v: k for k, v in KINDS.items()}
    jobs = ([("rank", r["rank"]) for r in ranks] + [("cell", *c) for c in CAPTURE_CELLS]
            + [("one_card",)])
    with concurrent.futures.ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        traced = dict(zip(jobs, pool.map(_abstract_trace, jobs)))
    traces_s = time.perf_counter() - t_start
    per_rank, rank_traces = [], {}
    rank_topo = topo_for("x".join(str(n) for n in SHARDED_MESH.values()), H100_SXM)
    for r in ranks:
        tr, trace_s = traced[("rank", r["rank"])]
        rank_traces[f"rank {r['rank']}"] = schedule_to_trace(tr["ops"], rank_topo)
        steps = [[CollectiveOp(**{**d, "axes": tuple(d["axes"])}) for d in ops]
                 for ops in r["schedules"]]
        executed = steps[CAPTURE_STEP - 1]
        if executed != tr["ops"]:
            raise AssertionError(f"rank {r['rank']}: step {CAPTURE_STEP}'s schedule is not "
                                 f"the abstract capture: "
                                 f"{_first_difference(executed, tr['ops'])}")
        if any(ops != executed for ops in steps):
            raise AssertionError(f"rank {r['rank']}: the steps' schedules differ")
        sums = {}
        for o in (o for ops in steps for o in ops):
            sums[names[o.kind]] = sums.get(names[o.kind], 0) + o.operand_bytes
        if sums != r["exchanged"]:
            raise AssertionError(f"rank {r['rank']}: captured bytes {sums} != EXCHANGED "
                                 f"{r['exchanged']}")
        cost = tr["cost"]
        if cost.kernel_calls != per_step:
            raise AssertionError(f"rank {r['rank']}: abstract kernel calls "
                                 f"{cost.kernel_calls} != {per_step}")
        measured = {"param_bytes": r["param_bytes"], "grad_buffer_bytes": r["grad_buffer_bytes"],
                    "state_bytes": r["zero1_state_bytes"]}
        if tr["bytes"] != measured:
            raise AssertionError(f"rank {r['rank']}: abstract bytes {tr['bytes']} != "
                                 f"measured {measured}")
        per_rank.append({
            "rank": r["rank"], "coord": tr["coord"], "ops_per_step": len(executed),
            "by_kind": {k: {"count": c, "bytes": b} for k, (c, b) in by_kind(executed).items()},
            "equal_to_abstract": True, "abstract_kernel_calls": cost.kernel_calls,
            "abstract_bytes": tr["bytes"], "measured_bytes": measured,
            "abstract_peak_bytes": cost.peak_live_bytes,
            "measured_peak_bytes": r["peak_mem_bytes"],
            "abstract_over_measured_peak": cost.peak_live_bytes / r["peak_mem_bytes"],
            "trace_s": trace_s})

    cells = []
    for cell_arch, shape_name, mesh_name in CAPTURE_CELLS:
        rec, host_s = traced[("cell", cell_arch, shape_name, mesh_name)]
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {cell_arch} x {shape_name} x {mesh_name}: "
                                 f"{rec.get('error')}")
        topo = topo_for(mesh_name, H100_SXM)
        ops = schedule_of(rec)
        terms = roofline(arch=cell_arch, shape=shape_name, mesh=mesh_name, topo=topo,
                         hlo_flops_per_device=rec["flops_per_device"],
                         hlo_bytes_per_device=rec["bytes_per_device"], collective_ops=ops,
                         model_flops_total=rec["model_flops"],
                         bytes_per_device_hbm=rec["hbm_bytes_per_device"])
        bundle = schedule_to_trace(ops, topo)
        cells.append({"arch": cell_arch, "shape": shape_name, "mesh": mesh_name,
                      "topology": topo.describe(), "collectives": rec["collectives"],
                      "kernel_calls": rec["kernel_calls"], "memory": rec["memory"],
                      "roofline": {k: v for k, v in terms.as_dict().items()
                                   if k not in ("arch", "shape", "mesh", "note")},
                      "predict_step": predict_step(terms, topo, ops).as_dict(),
                      "trace_writes": len(bundle), "trace_span_ns": bundle.span_ns(),
                      "trace_s": rec["lower_s"], "host_s": host_s})

    one, one_s = traced[("one_card",)]
    compute_s = one["cost"].dot_flops / H100_SXM.peak_flops_bf16
    memory_s = one["cost"].bytes / H100_SXM.hbm_bw
    busy_ms = single["profile"]["device_busy_ms"]
    one_card = {"arch": arch, "batch": batch, "seq": seq, "microbatches": mb, "mesh": "1x1",
                "dot_flops": one["cost"].dot_flops, "bytes": one["cost"].bytes,
                "kernel_calls": one["cost"].kernel_calls, "compute_ms": compute_s * 1e3,
                "memory_ms": memory_s * 1e3, "compute_plus_memory_ms": (compute_s + memory_s) * 1e3,
                "measured_device_busy_ms": busy_ms,
                "measured_over_model": busy_ms / ((compute_s + memory_s) * 1e3),
                "abstract_peak_bytes": one["cost"].peak_live_bytes,
                "measured_peak_bytes": single["peak_mem_bytes"], "host_s": one_s}
    if one["cost"].kernel_calls != per_step:
        raise AssertionError(f"one-card cell: kernel calls {one['cost'].kernel_calls}")
    return {"phase": "capture", "step_held": CAPTURE_STEP, "mesh": SHARDED_MESH,
            "ranks": per_rank, "cells": cells, "one_card_cell": one_card,
            "card_rates": _card_rates(), "abstract_traces_s": traces_s,
            "eidola_replay": _eidola_replay(card, rank_traces),
            "seconds": time.perf_counter() - t_start,
            "card": card}


def grad_kind(name: str) -> str:
    """A parameter's kind: its name without the layer (``attn.w_k``, ``embed``)."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "blocks" else parts[0]


@contextlib.contextmanager
def recording_grad_squares(trainer):
    """Within it, each step of ``trainer`` appends ``{kind: squared gradient
    norm}`` to the list it yields, over the gradients that count in the
    step's norm on this rank (under a mesh, its ZeRO-1 pieces at coordinate 0
    of every axis along which a piece is repeated), summed over the layers.
    It wraps the trainer module's ``adamw_step``, which sees every step's
    gradients, and puts it back on leaving."""
    import repro_torch.training.trainer as trainer_mod
    from repro_torch.distributed.sharding import spec_axes

    mesh, step, out = trainer.mesh, trainer_mod.adamw_step, []

    def counted(name: str) -> bool:
        axes = spec_axes(trainer.shardings["state"][name]) if mesh is not None else ()
        return mesh is None or all(mesh.coord[a] == 0 for a in mesh.shape if a not in axes)

    def recording(params, grads, state, cfg, **kw):
        names = [k for k in grads if counted(k)]
        squares = torch.stack([torch.sum(torch.square(grads[k].float())) for k in names])
        kinds: dict = {}
        for k, v in zip(names, squares.tolist()):
            kinds[grad_kind(k)] = kinds.get(grad_kind(k), 0.0) + v
        out.append(kinds)
        return step(params, grads, state, cfg, **kw)

    trainer_mod.adamw_step = recording
    try:
        yield out
    finally:
        trainer_mod.adamw_step = step


def _one_rank(arch: str, microbatches: int) -> dict:
    """The one-rank run of the sharded phase's steps with the batch cut into
    ``microbatches``: losses, gradient norms, and each tensor kind's gradient
    norm a step."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, Trainer

    batch, seq, _, steps, lr, warmup = TRAIN_RUNS[arch]
    torch.cuda.empty_cache()
    model = Model(get_config(arch))
    trainer = Trainer(model, TrainConfig(microbatches=microbatches,
                                         optim=AdamWConfig(lr=lr, warmup_steps=warmup,
                                                           total_steps=steps)))
    trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLMDataset(DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=seq, global_batch=batch))
    with recording_grad_squares(trainer) as squares:
        history = trainer.run(iter(data), SHARDED_STEPS, log_every=0)
    del trainer, model
    torch.cuda.empty_cache()
    return {"losses": [h["loss"] for h in history],
            "grad_norms": [h["grad_norm"] for h in history],
            "kinds": [{k: v ** 0.5 for k, v in sq.items()} for sq in squares]}


def _slices(x: torch.Tensor, n: int) -> list:
    """The tokens of ``x [B, S, d]`` cut in n consecutive slices ``[1, T / n, d]``
    where there are enough to cut (the scatter path's), else x whole."""
    T, d = x.shape[0] * x.shape[1], x.shape[2]
    if T % n or T // n < 8:
        return [x]
    return list(x.reshape(n, 1, T // n, d))


def _plain_drops(cfg, idx: torch.Tensor, msz: int, T: int) -> float:
    """The scatter path's dropped pairs from the routing, counted plainly: the
    mean over the model ranks of each token slice's pairs past the capacity of
    their destination."""
    import math

    k, E_loc, Tm = cfg.experts_per_token, cfg.n_experts // msz, T // msz
    C = int(math.ceil(Tm * k / msz * cfg.capacity_factor))
    drops = 0
    for m in range(msz):
        dest = idx[m * Tm:(m + 1) * Tm].reshape(-1) // E_loc
        counts = torch.bincount(dest, minlength=msz)
        drops += int(torch.clamp(counts - C, min=0).sum())
    return drops / msz


def _substrate_rank(rank: int, world: int) -> dict:
    """One rank of the moe_ep and pipeline phases, in its own spawned process."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.distributed import pipeline_apply, stack_stage_params
    from repro_torch.distributed.collectives import EXCHANGED, raw_all_gather
    from repro_torch.distributed.sharding import shard_tensor
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.common import materialize
    from repro_torch.models.moe import moe_apply, moe_specs, route
    from repro_torch.models.moe_ep import ep_specs, moe_apply_ep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"rank": rank}

    # -- expert-parallel MoE ---------------------------------------------------
    mesh = Mesh({"data": 1, "model": world}).bind()
    base = get_config("olmoe-1b-7b").with_(param_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    full = materialize(moe_specs(base), gen, dev)
    out["moe_ep"] = {}
    for path, (B, S) in MOE_EP_SHAPES.items():
        x = torch.randn(B, S, base.d_model, generator=gen, device=dev) * 0.5
        res = {"x": [B, S, base.d_model]}
        runs = {"dropless": float(world),
                **{k: v or base.capacity_factor for k, v in MOE_EP_CAPACITY.items()}}
        for tag, cf in runs.items():
            cfg = base.with_(capacity_factor=cf)
            specs = ep_specs(cfg, mesh)
            p = {k: shard_tensor(v, specs[k], mesh).clone().requires_grad_()
                 for k, v in full.items()}
            EXCHANGED.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux = moe_apply_ep(cfg, p, x, mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            res[f"{tag}_capacity_factor"] = cf
            res[f"{tag}_ms"] = ms
            res[f"{tag}_bytes_exchanged"] = dict(EXCHANGED)
            res[f"{tag}_dropped"] = float(aux["moe_dropped"])
            if tag == "dropless":
                # moe_apply on the same token slices the ranks route, so a
                # near tie sees the same router product on both sides
                pl = {k: v.detach().clone().requires_grad_() for k, v in full.items()}
                y_ref = torch.cat([moe_apply(cfg, pl, xs)[0] for xs in _slices(x, world)])
                y_ref = y_ref.reshape(x.shape)
                with torch.no_grad():
                    _, aux_ref, _ = moe_apply(cfg, full, x)
                err = ((y - y_ref).abs() - MOE_EP_TOL["rtol"] * y_ref.abs()).max().item()
                res.update(max_abs_err=(y - y_ref).abs().max().item(),
                           within_tol=err <= MOE_EP_TOL["atol"],
                           aux_rel_err=max(abs(aux[k].item() - aux_ref[k].item())
                                           / abs(aux_ref[k].item())
                                           for k in ("moe_load_balance", "moe_z")))
                (y ** 2).sum().backward()
                (y_ref ** 2).sum().backward()
                worst = 0.0
                for k, v in p.items():
                    want = shard_tensor(pl[k].grad, specs[k], mesh)
                    lim = MOE_EP_GRAD_TOL["atol"] + MOE_EP_GRAD_TOL["rtol"] * want.abs()
                    worst = max(worst, ((v.grad - want).abs() / lim).max().item())
                res["grad_worst_ratio"] = worst
                del pl, y_ref
            elif path == "scatter":
                with torch.no_grad():
                    idx = torch.cat([route(cfg, full, xs.reshape(-1, cfg.d_model), aux=False)[0]
                                     for xs in _slices(x, world)])
                res[f"{tag}_plain_dropped"] = _plain_drops(cfg, idx, world, B * S)
            del p, y
        out["moe_ep"][path] = res
    del full
    torch.cuda.empty_cache()

    # -- the GPipe pipeline -------------------------------------------------------
    pipe = Mesh({"pipe": world}).bind()
    gen = torch.Generator(device=dev).manual_seed(1)
    W = torch.randn(PIPE_LAYERS, PIPE_D, PIPE_D, generator=gen, device=dev) / PIPE_D ** 0.5
    b = torch.randn(PIPE_LAYERS, PIPE_D, generator=gen, device=dev) * 0.1
    x = torch.randn(PIPE_MICRO * PIPE_MB, PIPE_D, generator=gen, device=dev)

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    local = {k: shard_tensor(v, ("pipe",), pipe).clone().requires_grad_()
             for k, v in stack_stage_params({"w": W, "b": b}, world).items()}
    apply = pipeline_apply(pipe, layer, n_micro=PIPE_MICRO)
    (apply(local, x) ** 2).sum().backward()  # a first run: the exchanges' set-up
    for t in local.values():
        t.grad = None
    EXCHANGED.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = apply(local, x)
    (y ** 2).sum().backward()
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    exchanged = dict(EXCHANGED)
    Wr, br = W.clone().requires_grad_(), b.clone().requires_grad_()
    t0 = time.perf_counter()
    ref = x
    for i in range(PIPE_LAYERS):
        ref = layer({"w": Wr[i], "b": br[i]}, ref)
    (ref ** 2).sum().backward()
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    whole = {"w": Wr.grad.clone(), "b": br.grad.clone()}
    summed = {"w": torch.zeros_like(W), "b": torch.zeros_like(b)}
    for m in reversed(range(PIPE_MICRO)):  # the pipeline's order of the sums
        Wr.grad = br.grad = None
        h = x[m * PIPE_MB:(m + 1) * PIPE_MB]
        for i in range(PIPE_LAYERS):
            h = layer({"w": Wr[i], "b": br[i]}, h)
        (h ** 2).sum().backward()
        summed["w"] += Wr.grad
        summed["b"] += br.grad
    got = {"w": raw_all_gather(local["w"].grad, pipe, "pipe", 0).reshape(W.shape),
           "b": raw_all_gather(local["b"].grad, pipe, "pipe", 0).reshape(b.shape)}

    def ratio(got, want):
        return ((got - want).abs() / (PIPE_TOL["atol"] + PIPE_TOL["rtol"] * want.abs())
                ).max().item()

    def of_largest(got, want):  # each layer's worst difference over 1e-5 of its largest
        return ((got - want).abs().flatten(1).amax(1)
                / (1e-5 * want.abs().flatten(1).amax(1))).max().item()

    out["pipeline"] = {"forward_worst_ratio": ratio(y.detach(), ref.detach()),
                       "grad_worst_ratio": max(ratio(got[k], summed[k]) for k in got),
                       "grad_vs_whole_batch_of_largest": max(of_largest(got[k], whole[k])
                                                             for k in got),
                       "wall_ms": pipe_ms, "sequential_wall_ms": seq_ms,
                       "bytes_exchanged": exchanged}
    return out


def phase_moe_ep_and_pipeline(card: str) -> tuple:
    """olmoe-1b-7b's MoE layer expert-parallel on (1, 4), and pipeline_apply
    over 4 stages, on one world of 4 ranks sharing the card."""
    from repro_torch.distributed import bubble_fraction, run_world

    t0 = time.perf_counter()
    ranks = run_world(_substrate_rank, RANKS, timeout=600)
    seconds = time.perf_counter() - t0
    for r in ranks:
        for path, res in r["moe_ep"].items():
            if not (res["within_tol"] and res["grad_worst_ratio"] <= 1.0
                    and res["dropless_dropped"] == 0 and res["aux_rel_err"] < 1e-4):
                raise AssertionError(f"rank {r['rank']} moe_ep {path}: {res}")
            for tag in MOE_EP_CAPACITY:
                want = res.get(f"{tag}_plain_dropped", 0.0)  # the gather path drops none
                if res[f"{tag}_dropped"] != want:
                    raise AssertionError(f"rank {r['rank']} {path}: dropped "
                                         f"{res[f'{tag}_dropped']} != plain count {want}")
        if not r["moe_ep"]["scatter"]["tight_dropped"] > 0:
            raise AssertionError(f"rank {r['rank']}: capacity 0.25 dropped nothing")
        pipe = r["pipeline"]
        if max(pipe["forward_worst_ratio"], pipe["grad_worst_ratio"]) > 1.0:
            raise AssertionError(f"rank {r['rank']} pipeline: {pipe}")
    moe = {"phase": "moe_ep", "arch": "olmoe-1b-7b", "layer": "one MoE layer, full width",
           "mesh": {"data": 1, "model": RANKS}, "dtype": "float32", "tolerance": MOE_EP_TOL,
           "grad_tolerance": MOE_EP_GRAD_TOL,
           "paths": {path: {**ranks[0]["moe_ep"][path],
                            "max_abs_err_all_ranks": max(r["moe_ep"][path]["max_abs_err"]
                                                         for r in ranks),
                            "grad_worst_ratio_all_ranks": max(
                                r["moe_ep"][path]["grad_worst_ratio"] for r in ranks)}
                     for path in MOE_EP_SHAPES},
           "seconds_with_pipeline": seconds, "card": card}
    pipe = {"phase": "pipeline", "stages": RANKS, "layers": PIPE_LAYERS, "d": PIPE_D,
            "n_micro": PIPE_MICRO, "microbatch_rows": PIPE_MB, "dtype": "float32",
            "tolerance": PIPE_TOL, "bubble_fraction": bubble_fraction(RANKS, PIPE_MICRO),
            "forward_worst_ratio": max(r["pipeline"]["forward_worst_ratio"] for r in ranks),
            "grad_worst_ratio": max(r["pipeline"]["grad_worst_ratio"] for r in ranks),
            "grad_vs_whole_batch_of_largest": max(
                r["pipeline"]["grad_vs_whole_batch_of_largest"] for r in ranks),
            "per_rank": [{"rank": r["rank"], **{k: r["pipeline"][k] for k in (
                "wall_ms", "sequential_wall_ms", "bytes_exchanged")}} for r in ranks],
            "note": "walls with the exchange through the host; the sequential stack is one "
                    "rank's reference",
            "card": card}
    return moe, pipe


def phase_remat(card: str) -> dict:
    """gemma3-1b's one-rank train step at full width under each remat policy,
    from the same seed and batches: exact rmsnorm launches a step, ms a step,
    peak memory, and the losses against "none"'s."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, build_train_step

    batch, seq, mb, _, lr, warmup = TRAIN_RUNS[TRAIN_MAIN]
    dev = torch.device("cuda")
    data = iter(SyntheticLMDataset(DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=seq,
                                              global_batch=batch)))
    batches = [next(data) for _ in range(REMAT_STEPS)]
    out = {}
    for policy in REMAT_POLICIES:
        torch.cuda.empty_cache()
        model = Model(get_config(TRAIN_MAIN)).init(torch.Generator(device=dev).manual_seed(0))
        tcfg = TrainConfig(microbatches=mb, remat_policy=policy,
                           optim=AdamWConfig(lr=lr, warmup_steps=warmup,
                                             total_steps=TRAIN_RUNS[TRAIN_MAIN][3]))
        step = build_train_step(model, tcfg)
        state = step.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rmsnorm_cuda.launches = rmsnorm_bwd_cuda.launches = 0
        losses, ms = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, b["tokens"], b["labels"])
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = {"rmsnorm": rmsnorm_cuda.launches, "rmsnorm_bwd": rmsnorm_bwd_cuda.launches}
        expect = {k: n * REMAT_STEPS for k, n in REMAT_LAUNCHES_PER_STEP[policy].items()}
        if launches != expect:
            raise AssertionError(f"remat {policy}: launches {launches} != {expect}")
        out[policy] = {"losses": losses, "step_ms": ms,
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "launches": launches,
                       "launches_per_step": REMAT_LAUNCHES_PER_STEP[policy]}
        del model, step, state
    base = out["none"]["losses"]
    for policy, res in out.items():
        res["loss_rel_err_vs_none"] = [abs(a - b) / abs(b) for a, b in zip(res["losses"], base)]
        # the first step's forward is the same computation under every policy
        if res["losses"][0] != base[0] or max(res["loss_rel_err_vs_none"]) > 1e-4:
            raise AssertionError(f"remat {policy}: losses {res['losses']} against none's {base}")
    torch.cuda.empty_cache()
    return {"phase": "remat", "arch": TRAIN_MAIN, "batch": batch, "seq": seq,
            "microbatches": mb, "steps": REMAT_STEPS, "policies": out, "card": card}


def _serve_recording(model, engine, prompts, n_new: int) -> dict:
    """``engine.generate(prompts, n_new)`` with the logits of each decode step
    and the collectives of its last step recorded."""
    from repro_torch.core.capture import capture_collectives

    step, seen = model.decode_step, {"logits": [], "ops": None, "steps": 0}

    def recording(*args, **kwargs):
        with capture_collectives() as ops:
            out = step(*args, **kwargs)
        seen["steps"] += 1
        seen["ops"] = ops
        seen["logits"].append(out[0].float().cpu())
        return out

    model.decode_step = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(prompts, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.decode_step  # the class's method again (no cycle holds the model)
    return {"outputs": outs, "wall_s": wall, **seen}


def _prefill_and_decode(model, prompts, n_new: int) -> dict:
    """The prompts through ``Model.prefill`` into caches of prompt + n_new
    slots, then greedy decode steps: the same record as
    :func:`_serve_recording` (the prefill's logits first, then each step's;
    the last step's collectives)."""
    from repro_torch.core.capture import capture_collectives
    from repro_torch.distributed.collectives import EXCHANGED, raw_all_gather
    from repro_torch.distributed.sharding import rows_spec, shard_tensor

    mesh, (B, P) = model.mesh, np.shape(prompts)
    tokens = torch.tensor(prompts, device=model.device)
    rows = None if mesh is None else rows_spec(mesh, B)
    mine = tokens if rows is None else shard_tensor(tokens, (rows,), mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(mine, batch=B, max_len=P + n_new)
    kept, new = [logits.float().cpu()], []
    prefill_exchanged = dict(EXCHANGED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k in range(n_new):
        nxt = torch.argmax(logits, dim=-1)
        new.append(nxt)
        with capture_collectives() as ops:
            logits, caches = model.decode_step(caches, nxt, P + k)
        kept.append(logits.float().cpu())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    new = torch.stack(new, 1)
    if rows is not None:  # every row's tokens, as the engine gathers them
        new = raw_all_gather(new, mesh, rows, dim=0)
    outs = [list(p) + seq for p, seq in zip(prompts, new.cpu().tolist())]
    return {"outputs": outs, "logits": kept, "ops": ops,
            "steps": n_new, "wall_s": t2 - t1, "prefill_s": t1 - t0,
            "prefill_exchanged": prefill_exchanged}


def _serve_run(model, B: int, P: int, n_new: int, how: str) -> dict:
    """One run of SHARDED_SERVE_RUNS or BLOCK_SERVE_RUNS on ``model``, seed-0
    prompts."""
    from repro_torch.serving import ServeConfig, ServeEngine

    prompts = np.random.default_rng(0).integers(1, model.cfg.vocab, (B, P)).tolist()
    if how == "prefill":
        return _prefill_and_decode(model, prompts, n_new)
    return _serve_recording(model, ServeEngine(model, ServeConfig(max_batch=B)), prompts, n_new)


def _one_rank_serve(arch: str, B: int, P: int, n_new: int, how: str) -> dict:
    """One run of SHARDED_SERVE_RUNS or BLOCK_SERVE_RUNS on one rank, float32,
    seed-0 weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(arch).with_(param_dtype=torch.float32)
    model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    res = _serve_run(model, B, P, n_new, how)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"outputs": res["outputs"], "logits": res["logits"], "steps": res["steps"],
            "ms_per_step": res["wall_s"] * 1e3 / res["steps"]}


def _recording_norms(seen: set):
    """Put wrappers of the rmsnorm kernels in ``kernels.ops`` that add each
    call's ``(entry, rows, D)`` to ``seen`` (float32 only: the kernels phase
    checks that); returns a function that puts the kernels back."""
    from repro_torch.kernels import ops

    fns = {"forward": ops.rmsnorm_cuda, "backward": ops.rmsnorm_bwd_cuda}

    def recording(entry: str):
        def call(x, *args, **kwargs):
            if x.dtype != torch.float32:
                raise AssertionError(f"rmsnorm {entry} on {x.dtype}: the kernels phase checks "
                                     f"float32")
            seen.add((entry, x.numel() // x.shape[-1], x.shape[-1]))
            return fns[entry](x, *args, **kwargs)
        return call

    ops.rmsnorm_cuda, ops.rmsnorm_bwd_cuda = recording("forward"), recording("backward")

    def restore():
        ops.rmsnorm_cuda, ops.rmsnorm_bwd_cuda = fns["forward"], fns["backward"]
    return restore


def _sharded_serve_rank(rank: int, world: int, runs: tuple) -> list:
    """One rank of the sharded_serve phase (or of sharded_blocks'), in its
    own spawned process: each run at full width on SERVE_MESH in float32,
    its weights drawn whole from seed 0 and sliced; the kernels' counts and
    the exchanged bytes set to 0 just before the engine's run and read just
    after; then the abstract capture of
    its decode step.  Each call to the attention kernels in the run is
    recorded, ``(entry, q shape, K/V shape, length)``, and each to the norm
    kernels, ``(entry, rows, D)``, for the phase to hold against the shapes
    the kernels phase checked."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.collectives import EXCHANGED
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_partial_cuda)
    from repro_torch.kernels.mamba_decode import mamba_decode_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model
    from repro_torch.models.model import decode_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = Mesh(SERVE_MESH).bind()
    out = []

    def recording(entry: str, fn, seen: set):
        def call(q, k, v, length):
            if q.dtype != torch.float32:
                raise AssertionError(f"{entry} on {q.dtype}: the kernels phase checks float32")
            seen.add((entry, tuple(q.shape), tuple(k.shape), int(length)))
            return fn(q, k, v, length)
        return call

    for arch, B, P, n_new, how in runs:
        cfg = get_config(arch).with_(param_dtype=torch.float32)
        t0 = time.perf_counter()
        model = Model(cfg, mesh=mesh).init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        caches = model.init_caches(B, P + n_new)
        cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
        del caches
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        rmsnorm_cuda.launches = decode_attention_cuda.launches = mamba_decode_cuda.launches = 0
        decode_attention_partial_cuda.launches = 0
        EXCHANGED.clear()
        calls, norms = set(), set()
        ops.decode_attention_cuda = recording("whole", decode_attention_cuda, calls)
        ops.decode_attention_partial_cuda = recording("partial", decode_attention_partial_cuda,
                                                      calls)
        restore_norms = _recording_norms(norms)
        try:
            res = _serve_run(model, B, P, n_new, how)
        finally:
            ops.decode_attention_cuda = decode_attention_cuda
            ops.decode_attention_partial_cuda = decode_attention_partial_cuda
            restore_norms()
        launches = {"rmsnorm": rmsnorm_cuda.launches,
                    "decode_attention": decode_attention_cuda.launches,
                    **_mamba_launches(mamba_decode_cuda)}
        partial = decode_attention_partial_cuda.launches
        steps = res["steps"]
        # the decode steps' (a prefill's apart), read before the trace adds its own
        pre = res.get("prefill_exchanged", {})
        exchanged = {k: (v - pre.get(k, 0)) / steps for k, v in EXCHANGED.items()}
        per_step = decode_launches(cfg)
        # a prefill applies each norm once and attends in plain torch
        expect = {k: n * steps + (n if (how, k) == ("prefill", "rmsnorm") else 0)
                  for k, n in per_step.items()}
        if launches != expect:
            raise AssertionError(f"rank {rank} {arch} B {B}: launches {launches} in {steps} "
                                 f"steps ({how}), not {expect}")
        # the first attention entry's (a KV cache's slots cut: sequence-parallel)
        specs = model.cache_specs(B, P + n_new)
        spec = next(s for s in specs if "k" in s or "c_kv" in s)
        state_spec = next((s for s in specs if "k" not in s and "c_kv" not in s), None)
        sequence_parallel = any(len(s) > 1 and s[1] is not None for s in spec.values())
        if partial != (launches["decode_attention"] if sequence_parallel else 0):
            raise AssertionError(f"rank {rank} {arch}: {partial} partial launches")
        t1 = time.perf_counter()
        abstract = trace_cell(cfg, ShapeSpec("serve", P + n_new, B, "decode"), Mesh(SERVE_MESH),
                              rank)
        trace_s = time.perf_counter() - t1
        if res["ops"] != abstract["ops"]:
            raise AssertionError(f"rank {rank} {arch} B {B}: the last decode step's schedule "
                                 f"is not the abstract capture: "
                                 f"{_first_difference(res['ops'], abstract['ops'])}")
        if abstract["cost"].kernel_calls != {k: n for k, n in per_step.items() if n}:
            raise AssertionError(f"rank {rank} {arch}: abstract kernel calls "
                                 f"{abstract['cost'].kernel_calls}")
        out.append({
            "rank": rank, "coord": mesh.coord, "arch": arch, "requests": B, "prompt_by": how,
            "prefill_s": res.get("prefill_s"), "expected_launches": expect,
            "bytes_exchanged_by_prefill": pre,
            "outputs": res["outputs"], "logits": [t.numpy() for t in res["logits"]],
            "steps": steps, "ms_per_step": res["wall_s"] * 1e3 / steps, "init_s": init_s,
            "launches": launches, "partial_launches": partial,
            "attention_calls": sorted(calls), "norm_calls": sorted(norms),
            "launches_per_step": per_step,
            "attention_cache_spec": spec, "state_cache_spec": state_spec,
            "sequence_parallel": sequence_parallel,
            "bytes_exchanged_per_step": exchanged,
            "ops_per_step": len(res["ops"]), "schedule_equal_to_abstract": True,
            "abstract_trace_s": trace_s,
            "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "cache_bytes": cache_bytes, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "unpartitioned": model.unpartitioned()})
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_sharded_serve(card: str) -> dict:
    """SHARDED_SERVE_RUNS on SERVE_MESH (see the module's doc): the one-rank
    runs first, in this process, each freed before the next; then one world
    of 4 ranks for all of them."""
    from repro_torch.distributed import run_world

    t0 = time.perf_counter()
    single = [_one_rank_serve(*run) for run in SHARDED_SERVE_RUNS]
    single_s = time.perf_counter() - t0
    world = SERVE_MESH["data"] * SERVE_MESH["model"]
    ranks = run_world(_sharded_serve_rank, world, SHARDED_SERVE_RUNS, timeout=900)
    # the kernels phase held the attention kernels at these calls' shapes
    checked = _serve_attention_calls(_serve_attention_cases(SHARDED_SERVE_RUNS))
    seen = {(e, tuple(q), tuple(kv), n) for r in ranks for run in r
            for e, q, kv, n in run["attention_calls"]}
    if not seen <= checked or {c[:3] for c in seen} != {c[:3] for c in checked}:
        raise AssertionError(f"the ranks' attention calls are not those the kernels phase "
                             f"checked: {sorted(seen - checked)[:4]} unchecked, shapes "
                             f"{sorted({c[:3] for c in checked} - {c[:3] for c in seen})} unseen")
    runs = []
    for i, (arch, B, P, n_new, how) in enumerate(SHARDED_SERVE_RUNS):
        want = single[i]
        per_rank, errs = [], []
        for r in ranks:
            got = r[i]
            if got["outputs"] != want["outputs"]:
                raise AssertionError(f"rank {got['rank']} {arch} B {B}: tokens differ from "
                                     f"the one-rank run's")
            d, m = got["coord"]["data"], got["coord"]["model"]
            n = SERVE_MESH["data"]
            rows = slice(None) if B % n else slice(d * B // n, (d + 1) * B // n)
            err = [float((torch.from_numpy(a) - b[rows]).abs().max())
                   for a, b in zip(got["logits"], want["logits"])]
            if not max(err) <= SHARDED_SERVE_TOL:
                raise AssertionError(f"rank {got['rank']} {arch} B {B}: a step's logits "
                                     f"differ by {max(err)} > {SHARDED_SERVE_TOL}")
            errs.append(max(err))
            per_rank.append({k: got[k] for k in (
                "rank", "coord", "ms_per_step", "prefill_s", "init_s", "launches",
                "partial_launches", "bytes_exchanged_per_step", "bytes_exchanged_by_prefill",
                "ops_per_step", "abstract_trace_s", "param_bytes", "cache_bytes",
                "peak_mem_bytes")} | {"logit_max_abs_err_by_step": err})
        first = ranks[0][i]
        runs.append({
            "arch": arch, "requests": B, "prompt_len": P, "new_tokens": n_new, "prompt_by": how,
            "steps": first["steps"], "sequence_parallel": first["sequence_parallel"],
            "attention_cache_spec": first["attention_cache_spec"],
            "launches_per_step_and_rank": first["launches_per_step"],
            "launches_all_ranks": {k: sum(r[i]["launches"][k] for r in ranks)
                                   for k in first["launches"]},
            "tokens_equal": True, "schedules_equal_to_abstract": True,
            "logit_max_abs_err": max(errs), "one_rank_ms_per_step": want["ms_per_step"],
            "ms_per_step_median": float(np.median([r[i]["ms_per_step"] for r in ranks])),
            "per_rank": per_rank})
    return {"phase": "sharded_serve", "mesh": SERVE_MESH, "ranks": world, "dtype": "float32",
            "tolerance": SHARDED_SERVE_TOL, "attention_calls_checked": len(seen),
            "attention_shapes": sorted({c[:3] for c in seen}), "exchange": "gloo via host",
            "note": "4 ranks are 4 processes sharing one card; ms a step measures the host "
                    "exchange, not a speed",
            "runs": runs, "one_rank_s": single_s, "seconds": time.perf_counter() - t0,
            "card": card}


def _blocks_replicated(cfg, mesh):
    """The model of ``cfg`` on the bound ``mesh`` from seed 0, with its Mamba2
    blocks, mLSTM cells and MLA attention replicated over ``model`` (their
    specs without the axis, as the rules leave a block whose heads ``model``
    does not divide): every rank holds and computes them whole, their states
    cut by their rows alone; all else placed by the rules.  The control of
    the sharded_blocks phase's peaks."""
    from repro_torch.models import Model

    model = Model(cfg, mesh=mesh)
    parts = {"mamba": "mamba", "xlstm_m": "cell", "dense": "attn", "moe": "attn"}
    named = [(f"blocks.{i}", b) for i, b in enumerate(model.blocks)]
    named += [("shared", model.shared)] if hasattr(model, "shared") else []
    whole = tuple(f"{name}.{parts[b.kind]}." for name, b in named if b.kind in parts
                  and (parts[b.kind] != "attn" or cfg.attn_kind == "mla"))
    shardings = {}
    for name, spec in model.shardings.items():
        if name.startswith(whole):
            spec = tuple(None if part == "model" else part for part in spec)
            while spec and spec[-1] is None:
                spec = spec[:-1]
        shardings[name] = spec
    shapes = {name: spec.shape for name, spec in model.param_specs().items()}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if shardings[name] != model.shardings[name]:
                p.data = torch.zeros(shapes[name], dtype=p.dtype, device=p.device)
    model.bind_mesh(mesh, shardings)
    return model.init(torch.Generator(device="cuda").manual_seed(0))


def _anchored(arch: str, fn):
    """``fn(model)`` on the one-rank model of ``arch`` from seed 0 in float64
    parameters and products (the model's own float32 states, gates and
    scores stay float32), with the kernels' plain versions in place of the
    kernels, which take float32 and bf16 only: the sharded_blocks phase's
    reference for what float32 rounding alone moves.  The model is freed
    before this returns."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.mamba_decode import mamba_decode_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.models import Model

    cfg = get_config(arch)
    single = Model(cfg.with_(param_dtype=torch.float32)).init(
        torch.Generator(device="cuda").manual_seed(0))
    model = Model(cfg.with_(param_dtype=torch.float64))
    with torch.no_grad():
        for p, q in zip(model.parameters(), single.parameters()):
            p.copy_(q)
    del single
    with mock.patch.multiple(ops, rmsnorm=rmsnorm_ref, decode_attention=decode_attention_ref,
                             mamba_decode=mamba_decode_ref):
        out = fn(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _block_serve_rank(rank: int, world: int) -> list:
    """One rank of the sharded_blocks phase's serving, in its own spawned
    process: BLOCK_SERVE_RUNS through :func:`_sharded_serve_rank` with each
    step's logits; then each run's work with the blocks replicated over
    ``model`` (:func:`_blocks_replicated`): the engine's caches and two
    decode steps, or the prefill and a decode step, its peak memory and first
    logits."""
    runs = _sharded_serve_rank(rank, world, BLOCK_SERVE_RUNS)
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import EXCHANGED
    from repro_torch.distributed.sharding import rows_spec, shard_tensor
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(SERVE_MESH).bind()
    for run, (arch, B, P, n_new, how) in zip(runs, BLOCK_SERVE_RUNS):
        cfg = get_config(arch).with_(param_dtype=torch.float32)
        model = _blocks_replicated(cfg, mesh)
        prompts = torch.tensor(np.random.default_rng(0).integers(1, cfg.vocab, (B, P)),
                               device="cuda")
        rows = rows_spec(mesh, B)
        mine = prompts if rows is None else shard_tensor(prompts, (rows,), mesh)
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        EXCHANGED.clear()
        if how == "prefill":
            first, caches = model.prefill(mine, batch=B, max_len=P + n_new)
            model.decode_step(caches, torch.argmax(first, dim=-1), P)
        else:
            caches = model.init_caches(B, P + n_new)
            first, caches = model.decode_step(caches, mine[:, 0], 0)
            model.decode_step(caches, mine[:, 1], 1)
        torch.cuda.synchronize()
        run["whole_blocks"] = {
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "unpartitioned": len(model.unpartitioned()),
            "bytes_exchanged": dict(EXCHANGED),
            "first_logits": first.float().cpu().numpy()}
        del model, caches, first
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def _block_train_batches() -> list:
    """BLOCK_TRAIN_STEPS batches of the synthetic data, ``(tokens, labels)``."""
    from repro_torch.data import DataConfig, SyntheticLMDataset

    _, batch, seq = BLOCK_TRAIN
    data = SyntheticLMDataset(DataConfig(vocab=TRAIN_DATA_VOCAB, seq_len=seq, global_batch=batch))
    return [(b["tokens"], b["labels"]) for b, _ in zip(data, range(BLOCK_TRAIN_STEPS))]


def _block_train_steps(model, step, batches, after=None) -> dict:
    """The steps of one train run: losses, gradient norms, learning rates,
    ms and collectives a step, and the peak memory so far at the end of
    each; ``after(i)`` called after step i (from 0), outside all of them."""
    from repro_torch.core.capture import capture_collectives

    state, out = step.init_state(), {"losses": [], "grad_norms": [], "lrs": [], "ms": [],
                                     "collectives": [], "peaks": []}
    for i, (tokens, labels) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with capture_collectives() as ops:
            state, metrics = step(state, tokens, labels)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["collectives"].append(len(ops))
        out["peaks"].append(torch.cuda.max_memory_allocated())
        for key, name in (("losses", "loss"), ("grad_norms", "grad_norm"), ("lrs", "lr")):
            out[key].append(float(metrics[name]))
        if after is not None:
            after(i)
            torch.cuda.reset_peak_memory_stats()  # the next step's peak without after's
    return out


def _params_apart(got: dict, want: dict) -> dict:
    """How far the tensors ``got`` lie from ``want`` (``{name: tensor}`` of
    equal shapes): each leaf's entries outside 1e-5 + 1e-5 |p|
    (BLOCK_TRAIN_TOL) and its entries, and over all of them the share
    outside and the largest difference."""
    tol, outside, entries, worst = BLOCK_TRAIN_TOL, {}, {}, 0.0
    for name, p in got.items():
        w = want[name].double()
        diff = (p.detach().double() - w).abs()
        outside[name] = int((diff > tol["param_atol"] + tol["param_rtol"] * w.abs()).sum())
        entries[name] = w.numel()
        worst = max(worst, float(diff.max()))
    return {"outside": outside, "entries": entries,
            "share": sum(outside.values()) / sum(entries.values()), "max_abs_diff": worst}


def _leaves_over(got: dict, one: dict) -> list:
    """The leaves of ``got`` (a :func:`_params_apart` from the anchor) with
    more entries outside than BLOCK_ANCHOR_FACTOR x the one-rank run's on the
    same entries (``one``) + BLOCK_LEAF_SLACK."""
    return [(name, n, one["outside"][name]) for name, n in got["outside"].items()
            if n > BLOCK_ANCHOR_FACTOR * one["outside"][name] + BLOCK_LEAF_SLACK]


def _params_line(rec: dict) -> dict:
    """One step's :func:`_params_apart` records for the printed line: each
    comparison's share outside and largest difference, the leaf nearest its
    bound (its outside entries over BLOCK_ANCHOR_FACTOR x the one-rank run's
    + BLOCK_LEAF_SLACK: at most 1 holds) and, after step 1, the planted
    leaf's ratio (above 1: rejected)."""
    def ratio(got, name):
        one = rec["one_rank_from_anchor"]["outside"][name]
        return got["outside"][name] / (BLOCK_ANCHOR_FACTOR * one + BLOCK_LEAF_SLACK)

    out = {k: {"share": v["share"], "max_abs_diff": v["max_abs_diff"]} for k, v in rec.items()}
    worst = max(rec["anchor"]["outside"], key=lambda name: ratio(rec["anchor"], name))
    out["nearest_leaf"] = {"name": worst, "outside": rec["anchor"]["outside"][worst],
                           "one_rank_outside": rec["one_rank_from_anchor"]["outside"][worst],
                           "entries": rec["anchor"]["entries"][worst],
                           "ratio_to_bound": ratio(rec["anchor"], worst)}
    if "planted" in rec:
        out["planted"] = {"name": BLOCK_PLANTED_LEAF,
                          "outside": rec["planted"]["outside"][BLOCK_PLANTED_LEAF],
                          "entries": rec["planted"]["entries"][BLOCK_PLANTED_LEAF],
                          "ratio_to_bound": ratio(rec["planted"], BLOCK_PLANTED_LEAF)}
    return out


def _block_train_rank(rank: int, world: int) -> dict:
    """One rank of the sharded_blocks phase's training, in its own spawned
    process: BLOCK_TRAIN at full width and depth on SHARDED_MESH in float32,
    its weights drawn whole from seed 0 and sliced; the kernels' counts and
    the exchanged bytes set to 0 just before the steps and read just after;
    after each step (outside its time and peak) its parameter shards, and
    the one-rank run's on the same entries, against the anchor's
    (BLOCK_TRAIN_DIR, :func:`_params_apart`; after step 1 also the planted
    leaf); its rmsnorm calls recorded; then one step with the mLSTM cells
    replicated over model (:func:`_blocks_replicated`), and its peak."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import EXCHANGED
    from repro_torch.distributed.sharding import shard_tensor
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = Mesh(SHARDED_MESH).bind()
    arch = BLOCK_TRAIN[0]
    cfg = get_config(arch).with_(param_dtype=torch.float32)
    tcfg = TrainConfig(optim=AdamWConfig(**BLOCK_TRAIN_OPT))
    batches = _block_train_batches()
    model = Model(cfg, mesh=mesh).init(torch.Generator(device="cuda").manual_seed(0))
    step = build_train_step(model, tcfg, mesh)
    params = []  # after each step: its shards against the one-rank run's and the anchor's
    planted = model.get_parameter(BLOCK_PLANTED_LEAF).detach().clone()  # before any step

    def held(i):
        def shards(ref):
            whole = torch.load(BLOCK_TRAIN_DIR / f"{arch}_{ref}{i + 1}.pt", map_location="cuda")
            return {k: shard_tensor(t, model.shardings[k], mesh) for k, t in whole.items()}

        mine = {k: p.detach() for k, p in model.named_parameters()}
        one, anchor = shards("step"), shards("anchor_step")
        params.append({"one_rank": _params_apart(mine, one),
                       "anchor": _params_apart(mine, anchor),
                       "one_rank_from_anchor": _params_apart(one, anchor)})
        if i == 0:  # the leaf as a step that left it alone would: it must be rejected
            params[-1]["planted"] = _params_apart({BLOCK_PLANTED_LEAF: planted},
                                                  {BLOCK_PLANTED_LEAF: anchor[BLOCK_PLANTED_LEAF]})

    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm_cuda.launches = rmsnorm_bwd_cuda.launches = 0
    EXCHANGED.clear()
    norms = set()
    restore_norms = _recording_norms(norms)
    try:
        out = _block_train_steps(model, step, batches, after=held)
    finally:
        restore_norms()
    out.update(rank=rank, coord=mesh.coord, peak_mem_bytes=max(out.pop("peaks")),
               launches={"rmsnorm": rmsnorm_cuda.launches,
                         "rmsnorm_bwd": rmsnorm_bwd_cuda.launches},
               bytes_exchanged_per_step={k: v / len(batches) for k, v in EXCHANGED.items()},
               unpartitioned=step.unpartitioned, params=params, norm_calls=sorted(norms),
               param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    model = _blocks_replicated(cfg, mesh)
    step = build_train_step(model, tcfg, mesh)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    EXCHANGED.clear()
    whole = _block_train_steps(model, step, batches[:1])
    out["whole_blocks"] = {"peak_mem_bytes": whole["peaks"][0],
                           "unpartitioned": len(step.unpartitioned),
                           "loss": whole["losses"][0], "ms": whole["ms"][0],
                           "collectives": whole["collectives"][0],
                           "bytes_exchanged": dict(EXCHANGED)}
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _block_serve_lines(card: str) -> list:
    """The serving cases of sharded_blocks: BLOCK_SERVE_RUNS first on one rank
    in this process, each freed before the next, and its float64 anchor
    (:func:`_anchored`); then one world of 4 ranks."""
    from repro_torch.distributed import run_world

    t0 = time.perf_counter()
    single, anchors = [], []
    for run in BLOCK_SERVE_RUNS:
        single.append(_one_rank_serve(*run))
        anchors.append(_anchored(run[0], lambda model: _serve_run(model, *run[1:])))
    world = SERVE_MESH["data"] * SERVE_MESH["model"]
    ranks = run_world(_block_serve_rank, world, timeout=900)
    checked = _serve_attention_calls(_serve_attention_cases(BLOCK_SERVE_RUNS))
    seen = {(e, tuple(q), tuple(kv), n) for r in ranks for run in r
            for e, q, kv, n in run["attention_calls"]}
    if not seen <= checked or {c[:3] for c in seen} != {c[:3] for c in checked}:
        raise AssertionError(f"the ranks' attention calls are not those the kernels phase "
                             f"checked: {sorted(seen - checked)[:4]} unchecked")
    n = SERVE_MESH["data"]
    lines = []
    for i, (arch, B, P, n_new, how) in enumerate(BLOCK_SERVE_RUNS):
        want, anchor, per_rank = single[i], anchors[i]["logits"], []
        if (len(want["logits"]) != want["steps"] + (how == "prefill")
                or len(anchor) != len(want["logits"])):
            raise AssertionError(f"{arch}: {len(want['logits'])} and {len(anchor)} steps' "
                                 f"logits kept")
        for r in ranks:
            got = r[i]
            if got["outputs"] != want["outputs"]:
                raise AssertionError(f"rank {got['rank']} {arch}: tokens differ from the "
                                     f"one-rank run's")
            d = got["coord"]["data"]
            rows = slice(None) if B % n else slice(d * B // n, (d + 1) * B // n)
            err = [float((torch.from_numpy(a) - b[rows]).abs().max())
                   for a, b in zip(got["logits"], want["logits"])]
            off = [float((torch.from_numpy(a).double() - b[rows].double()).abs().max())
                   for a, b in zip(got["logits"], anchor)]
            # how far float32 alone moves the one-rank run from the anchor, step by step
            one_off = [float((a[rows].double() - b[rows].double()).abs().max())
                       for a, b in zip(want["logits"], anchor)]
            bound = [BLOCK_ANCHOR_FACTOR * o + BLOCK_SERVE_TOL for o in one_off]
            over = [(i, o, b) for i, (o, b) in enumerate(zip(off, bound)) if not o <= b]
            if len(off) != len(anchor) or over:
                raise AssertionError(f"rank {got['rank']} {arch}: (step, distance, bound) "
                                     f"{over[:4]}: logits further from the float64 anchor "
                                     f"than {BLOCK_ANCHOR_FACTOR} x the one-rank run's + "
                                     f"{BLOCK_SERVE_TOL}")
            whole = got["whole_blocks"]
            first_logits = torch.from_numpy(whole.pop("first_logits"))
            ctl = float((first_logits - want["logits"][0][rows]).abs().max())
            ctl_off = float((first_logits.double() - anchor[0][rows].double()).abs().max())
            if not ctl_off <= bound[0]:
                raise AssertionError(f"rank {got['rank']} {arch}: the whole-block control's "
                                     f"first logits are {ctl_off} from the anchor")
            if got["unpartitioned"] or not whole["unpartitioned"]:
                raise AssertionError(f"rank {got['rank']} {arch}: blocks whole "
                                     f"{got['unpartitioned']}, control {whole['unpartitioned']}")
            per_rank.append({k: got[k] for k in (
                "rank", "coord", "ms_per_step", "prefill_s", "init_s", "launches",
                "bytes_exchanged_per_step", "bytes_exchanged_by_prefill", "ops_per_step",
                "param_bytes", "cache_bytes", "peak_mem_bytes")}
                | {"logit_max_abs_err": max(err), "logit_err_by_step": err,
                   "anchor_err_by_step": off, "one_rank_anchor_err_by_step": one_off,
                   "anchor_ratio_to_bound": max(o / b for o, b in zip(off, bound)),
                   "whole_blocks": {**whole, "logit_err": ctl, "anchor_err": ctl_off}})
        first = ranks[0][i]
        lines.append({
            "phase": "sharded_blocks", "case": f"{arch} serve", "mesh": SERVE_MESH,
            "dtype": "float32", "requests": B, "prompt_len": P, "new_tokens": n_new,
            "prompt_by": how, "tokens_equal": True, "steps_held": len(want["logits"]),
            "schedules_equal_to_abstract": True,
            "logit_max_abs_err": max(p["logit_max_abs_err"] for p in per_rank),
            "anchor": "one rank, float64 parameters and products, the kernels' plain versions",
            "one_rank_anchor_err": max(max(p["one_rank_anchor_err_by_step"]) for p in per_rank),
            "anchor_max_abs_err": max(max(p["anchor_err_by_step"]) for p in per_rank),
            "anchor_tolerance": f"each step: {BLOCK_ANCHOR_FACTOR} x the one-rank run's "
                                f"+ {BLOCK_SERVE_TOL}",
            "anchor_max_ratio_to_bound": max(p["anchor_ratio_to_bound"] for p in per_rank),
            "issue_tolerance_vs_one_rank": BLOCK_SERVE_TOL,
            "anchor_tokens_equal": anchors[i]["outputs"] == want["outputs"],
            "launches_per_step_and_rank": first["launches_per_step"],
            "launches_all_ranks": {k: sum(p["launches"][k] for p in per_rank)
                                   for k in first["launches"]},
            "norm_calls": sorted({tuple(c) for r in ranks for c in r[i]["norm_calls"]}),
            "collectives_per_step": first["ops_per_step"],
            "attention_cache_spec": first["attention_cache_spec"],
            "state_cache_spec": first["state_cache_spec"],
            "peak_mem_bytes_per_rank": [p["peak_mem_bytes"] for p in per_rank],
            "whole_blocks_peak_mem_bytes_per_rank": [p["whole_blocks"]["peak_mem_bytes"]
                                                    for p in per_rank],
            "one_rank_ms_per_step": want["ms_per_step"],
            "ms_per_step_median": float(np.median([p["ms_per_step"] for p in per_rank])),
            "per_rank": per_rank, "exchange": "gloo via host",
            "note": "4 ranks are 4 processes sharing one card; ms a step measures the host "
                    "exchange, not a speed",
            "seconds": time.perf_counter() - t0, "card": card})
    return lines


def _block_train_line(card: str) -> dict:
    """The training case of sharded_blocks: the one-rank run in this process
    (its parameters after each step saved for the ranks) and its float64
    anchor (:func:`_anchored`), then one world of 4 ranks."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import run_world
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.models import Model
    from repro_torch.models.model import decode_launches
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import TrainConfig, build_train_step

    t0 = time.perf_counter()
    arch, batch, seq = BLOCK_TRAIN
    cfg = get_config(arch).with_(param_dtype=torch.float32)
    tcfg = TrainConfig(optim=AdamWConfig(**BLOCK_TRAIN_OPT))
    batches = _block_train_batches()
    BLOCK_TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    model = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    step = build_train_step(model, tcfg)

    def saving(model, name):
        def saved(i):
            torch.save({k: p.detach() for k, p in model.named_parameters()},
                       BLOCK_TRAIN_DIR / f"{arch}_{name}{i + 1}.pt")
        return saved

    torch.cuda.reset_peak_memory_stats()
    rmsnorm_cuda.launches = rmsnorm_bwd_cuda.launches = 0
    single = _block_train_steps(model, step, batches, after=saving(model, "step"))
    single.update(peak_mem_bytes=max(single.pop("peaks")),
                  launches={"rmsnorm": rmsnorm_cuda.launches,
                            "rmsnorm_bwd": rmsnorm_bwd_cuda.launches})
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    anchor = _anchored(arch, lambda model: _block_train_steps(
        model, build_train_step(model, tcfg), batches, after=saving(model, "anchor_step")))
    world = SHARDED_MESH["data"] * SHARDED_MESH["model"]
    ranks = run_world(_block_train_rank, world, timeout=900)
    tol = BLOCK_TRAIN_TOL
    norms = decode_launches(cfg)["rmsnorm"]  # each norm once forward, once backward
    expect = {"rmsnorm": norms * BLOCK_TRAIN_STEPS, "rmsnorm_bwd": norms * BLOCK_TRAIN_STEPS}
    # how far float32 alone moves the one-rank run's gradient norm from the anchor's
    one_off = [abs(a - b) / b for a, b in zip(single["grad_norms"], anchor["grad_norms"])]
    whole_cells = [f"blocks.{i}.cell" for i, b in enumerate(cfg.xlstm_pattern) if b == "s"]
    for r in ranks:
        loss_err = max(abs(a - b) for a, b in zip(r["losses"], single["losses"]))
        gnorm_dev = [abs(a - b) / b for a, b in zip(r["grad_norms"], single["grad_norms"])]
        off = [abs(a - b) / b for a, b in zip(r["grad_norms"], anchor["grad_norms"])]
        faults = []
        if r["launches"] != expect or single["launches"] != expect:
            faults.append(f"launches {r['launches']} (one rank {single['launches']}), "
                          f"want {expect}")
        if not loss_err < tol["loss"]:
            faults.append(f"losses {r['losses']} against {single['losses']}")
        if not gnorm_dev[0] < tol["grad_norm_rtol"]:
            faults.append(f"step 1's gradient norm {r['grad_norms'][0]} against "
                          f"{single['grad_norms'][0]}")
        for i, (got, one) in enumerate(zip(off, one_off)):
            if not got <= BLOCK_ANCHOR_FACTOR * one + tol["grad_norm_rtol"]:
                faults.append(f"step {i + 1}'s gradient norm {got} from the anchor's, the "
                              f"one-rank run's {one}")
        for i, rec in enumerate(r["params"]):
            over = _leaves_over(rec["anchor"], rec["one_rank_from_anchor"])
            if over:
                faults.append(f"after step {i + 1}, leaves (name, outside, one rank's) "
                              f"{over[:4]} past the anchor")
        planted = r["params"][0]["planted"]
        if not _leaves_over(planted, r["params"][0]["one_rank_from_anchor"]):
            faults.append(f"a planted wrong {BLOCK_PLANTED_LEAF} passes: {planted['outside']}")
        if abs(r["whole_blocks"]["loss"] - single["losses"][0]) >= tol["loss"]:
            faults.append(f"whole-block loss {r['whole_blocks']['loss']}")
        if r["unpartitioned"] != whole_cells:
            faults.append(f"whole on every rank: {r['unpartitioned']}")
        if faults:
            raise AssertionError(f"rank {r['rank']} {arch}: " + "; ".join(faults))
        r.update(loss_max_abs_err=loss_err, grad_norm_rel_dev=gnorm_dev,
                 grad_norm_anchor_rel_dev=off, params=[_params_line(rec) for rec in r["params"]])
    keys = ("rank", "coord", "losses", "grad_norms", "ms", "collectives", "launches",
            "loss_max_abs_err", "grad_norm_rel_dev", "grad_norm_anchor_rel_dev", "params",
            "peak_mem_bytes", "param_bytes", "bytes_exchanged_per_step", "whole_blocks")
    return {"phase": "sharded_blocks", "case": f"{arch} train", "mesh": SHARDED_MESH,
            "dtype": "float32", "batch": batch, "seq": seq, "microbatches": 1,
            "steps": BLOCK_TRAIN_STEPS, "optim": BLOCK_TRAIN_OPT, "tolerance": tol,
            "losses": ranks[0]["losses"], "single_rank_losses": single["losses"],
            "grad_norms": ranks[0]["grad_norms"],
            "single_rank_grad_norms": single["grad_norms"],
            "anchor_losses": anchor["losses"], "anchor_grad_norms": anchor["grad_norms"],
            "one_rank_grad_norm_anchor_rel_dev": one_off,
            "params_after_each_step": ranks[0]["params"],
            "leaf_bound": f"{BLOCK_ANCHOR_FACTOR} x the one-rank run's outside entries "
                          f"+ {BLOCK_LEAF_SLACK}, per leaf and step",
            "single_rank_peak_mem_bytes": single["peak_mem_bytes"],
            "launches_per_step_and_rank": {k: v // BLOCK_TRAIN_STEPS for k, v in expect.items()},
            "launches_all_ranks": {k: sum(r["launches"][k] for r in ranks) for k in expect},
            "norm_calls": sorted({tuple(c) for r in ranks for c in r["norm_calls"]}),
            "collectives_per_step": ranks[0]["collectives"],
            "unpartitioned": ranks[0]["unpartitioned"],
            "peak_mem_bytes_per_rank": [r["peak_mem_bytes"] for r in ranks],
            "whole_blocks_peak_mem_bytes_per_rank": [r["whole_blocks"]["peak_mem_bytes"]
                                                    for r in ranks],
            "per_rank": [{k: r[k] for k in keys} for r in ranks], "exchange": "gloo via host",
            "note": "4 ranks are 4 processes sharing one card; ms a step measures the host "
                    "exchange, not a speed",
            "seconds": time.perf_counter() - t0, "card": card}


def phase_sharded_blocks(card: str) -> list:
    """Partitioned compute for the Mamba2, mLSTM and MLA blocks (see the
    module's doc): one line a case."""
    lines = _block_serve_lines(card)
    torch.cuda.empty_cache()
    lines.append(_block_train_line(card))
    # the kernels phase held the norms at the shapes the ranks gave them
    seen, want = {c for line in lines for c in line["norm_calls"]}, _block_norm_cases(True)
    if seen != want:
        raise AssertionError(f"the ranks' rmsnorm calls are not those the kernels phase "
                             f"checked: {sorted(seen - want)} unchecked, {sorted(want - seen)} "
                             f"unseen")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails before any output outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    ended = {}  # seconds from the start to the end of each phase

    def done(name: str, line: dict) -> dict:
        emit(line)
        ended[name] = time.perf_counter() - t_start
        return line

    card = card_line()
    done("device", {"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count()})
    done("build", phase_build())
    kernels = done("kernels", phase_kernels())
    torch.cuda.empty_cache()
    allreduce = done("gemv_allreduce", phase_gemv_allreduce())
    done("scans", phase_scans())
    eidola = phase_eidola(card)
    for line in eidola[:-1]:
        emit(line)
    done("eidola", eidola[-1])
    serves, profiles = {}, {}
    for arch in SERVE_ARCHS:
        model, serves[arch] = phase_serve(card, arch)
        emit(serves[arch])
        profiles[arch] = done(f"{arch} serve", phase_profile(model))
        del model
        torch.cuda.empty_cache()
    done("families", phase_families(card))
    done("parity", phase_parity())
    trains = {arch: done(f"{arch} train", phase_train(card, arch)) for arch in TRAIN_RUNS}
    done("train_parity", phase_train_parity())
    torch.cuda.empty_cache()
    sharded, sharded_ranks = phase_sharded(card, trains[TRAIN_MAIN])
    done("sharded", sharded)
    done("capture", phase_capture(card, sharded_ranks, trains[TRAIN_MAIN]))
    del sharded_ranks
    moe_ep, pipeline = phase_moe_ep_and_pipeline(card)
    emit(moe_ep)
    done("moe_ep and pipeline", pipeline)
    remat = done("remat", phase_remat(card))
    torch.cuda.empty_cache()
    serve_sharded = done("sharded_serve", phase_sharded_serve(card))
    torch.cuda.empty_cache()
    blocks = phase_sharded_blocks(card)
    for line in blocks:
        emit(line)
    ended["sharded_blocks"] = time.perf_counter() - t_start
    tiered, cluster, analysis = in_spawned_process(_closed_loop_phases, card)
    emit({"phase": "kernels", "tiered_solver": tiered})
    kernels.update(tiered)
    for line in cluster[:-1]:
        emit(line)
    cluster = done("cluster", cluster[-1])
    done("analysis", analysis)
    emit({"phase": "timing", "seconds_at_end_of": ended})

    def launches_and_device_ms(name):
        # the serve paths' kernels: launches in the main path's serve phase
        # (olmoe-1b-7b), mean device time per launch on that path (its profile
        # phase); the backward's: launches on this slice's main path, the
        # gemma3-1b train phase, device time per call at its shape (kernels
        # phase); gemv's: launches over every rank of the gemv_allreduce phase,
        # device time per launch at the gemma3-27b shard (kernels phase).
        # `ms` is back-to-back calls by CUDA events, host dispatch included.
        if name == "mamba_decode":  # the Mamba2 serve path's, zamba2-2.7b
            return (serves[MAMBA_ARCH]["launches"][name],
                    profiles[MAMBA_ARCH]["kernels"][name]["device_ms_per_launch"])
        if name in SERVE_KERNELS:
            return (serves[MAIN_ARCH]["launches"][name],
                    profiles[MAIN_ARCH]["kernels"][name]["device_ms_per_launch"])
        if name == "rmsnorm_bwd":
            return trains[TRAIN_MAIN]["launches"][name], kernels[name]["device_ms"]
        if name in SOLVER_KERNELS:  # the solvers' rows of the cluster phase
            return cluster["launches"][name], kernels[name]["device_ms"]
        return allreduce["launches"][name], kernels[name]["device_ms"]

    def by_path(name):
        if name in SOLVER_KERNELS:
            return {"launches_by_path": {"cluster, lockstep solvers":
                                         cluster["launches"][name]}}
        paths = {f"{a} serve": serves[a]["launches"][name] for a in serves
                 if name in serves[a]["launches"]}
        paths.update({f"{a} train": trains[a]["launches"][name] for a in trains
                      if name in trains[a]["launches"]})
        if name in sharded["launches"]:
            paths[f"{TRAIN_MAIN} sharded train"] = sharded["launches"][name]
            paths.update({f"{TRAIN_MAIN} remat {p} train": r["launches"][name]
                          for p, r in remat["policies"].items()})
        for run in serve_sharded["runs"]:  # all 4 ranks
            if name in run["launches_all_ranks"]:
                tag = ", sequence-parallel" if run["sequence_parallel"] else ""
                paths[f"{run['arch']} sharded serve B {run['requests']}{tag}"] = \
                    run["launches_all_ranks"][name]
        for line in blocks:  # all 4 ranks, the blocks head-parallel
            if name in line["launches_all_ranks"]:
                paths[f"{line['case']}, partitioned blocks"] = line["launches_all_ranks"][name]
        return {"launches_by_path": paths} if paths else {}

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         **dict(zip(("launches", "device_ms"), launches_and_device_ms(name))),
         **by_path(name),
         **{key: kernels[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "library_device_ms")},
         **{key: kernels[name][key] for key in ("cold_device_ms", "library_cold_device_ms",
                                                "plan") if key in kernels[name]}}
        for name, (src, tpu) in SOURCES.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
