#!/usr/bin/env python3
"""Smoke run of the PyTorch port (newsrecommendation_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
version, serves NRMS at its published width over HTTP, then trains it at
its published width, with 50-, 300- and 512-news histories, and with the
fused encoder tail, the 2-D-I/O attention and the batch-in-lanes
attention; drives multi-head self-attention at unequal q/k/v widths, and
every kernel at the head widths and lengths it once refused; then runs the
command line (train_test, checkpoints, test, serve with /reload); NAML
at its benchmark width (train, serve, the command line), which runs no
kernel row; and data parallelism with row-sharded tables over ranks.
Every behaviors shard the command line reads goes through the native
parser (csrc/mindio.cpp, built with g++), held against the Python one.

    python3 chip_smoke.py        # from the repo root, on a machine with
                                 # one CUDA card and nvcc

Phases, each printing one line with its elapsed seconds:
  device   nvidia-smi name and power limit; TF32 off for matmuls and convs
  build    one nvcc per kernel source (csrc/*.cu) for sm_90a, all started
           together (skipped if built)
  native-parse  the native behaviors parser (csrc/mindio.cpp) built with
           g++ (fails if it cannot be); a prepared train shard of at least
           PARSE_TRAIN_MB and a raw dev shard of at least PARSE_DEV_MB
           (cli_corpus's files repeated) parsed at L = 50, K = 4, C = 384
           by the native and the Python parser: every array equal in
           value and dtype. A "[parse numbers]" line gives each parser's
           seconds and MB/s, the speedup and the build's seconds, with
           the card
  kernel   row 1 (the forward without probs), both variants vs the plain
           version, f32 and bf16, at the shapes the serving path gives it
           and past T = 64 at 128 x 300 and 64 x 511, with the count of
           elements that differ at all and the launch's regime, which must
           be fwd_launch_plan's (resident at T <= 64, past it tensor cores
           in bf16, tiled in f32); controls with a planted fault (bias
           dropped, inputs scaled, mask dropped, and on tensor cores the
           output from the unrounded f32 a, rejected by its count of
           differing elements) that the comparison must reject; kernel /
           plain / scaled_dot_product_attention times and the memory/flop
           bound
  kernel-train  rows 2 (the forward that writes probs) and 3 (the backward
           from probs) vs their plain versions, f32 and bf16, at the
           training path's shapes (news encoder 7040 x 20, user encoder
           128 x 50, masked 128 x 50 with fully masked rows) and at
           64 x 202, 128 x 300 and 64 x 511 (bf16 on tensor cores): row 2's
           context bit-equal to row 1's, its probs, row 3's dqkv; controls
           (probs transposed per head, ds without its row-sum term, past
           one staged chunk r summed over the first chunk only, and in bf16
           dv from the unrounded a); kernel / plain times and bounds; bf16
           counts of differing elements; rows 1, 2 and 3 each in its plan's
           regime, and on tensor cores a context from the unrounded f32 a
           as a further control
  kernel-recompute  row 4 (the backward that recomputes the probs) vs its
           plain version at 7040 x 20, 128 x 50, 128 x 300 and 64 x 511,
           masked and not, f32 and bf16, with the count of elements that
           differ from row 3's dqkv fed row 2's probs; controls (ds without
           its row-sum term, mask dropped, past one chunk r or den summed
           over the first chunk only, in bf16 dv from the unrounded a);
           each launch in its plan's regime; bf16 counts of differing
           elements
  kernel-flash  rows 9-10 (the key-blocked forward and backward) vs their
           plain versions at 128 x 512, 128 x 513 (one key block of 513),
           128 x 1000 (key blocks of 200, not a multiple of the kernels'
           16-key step) and 32 x 2048, masked and not, f32 and bf16, on q,
           k, v cut from one projection; controls (the forward without the
           running-max rescale where there are two key blocks or more; in
           bf16 dv from the unrounded a, and e rounded against a max taken
           per 64-key tile inside each key block and rescaled, whose count
           of elements of o that differ from the plain version must be at
           least 10x the kernel's); each launch in its plan's regime
           (tensor cores in bf16, CUDA cores in f32); bf16 counts of
           differing elements
  kernel-2d  rows 11-12 (the 2-D-I/O forward and backward) at 7040 x 20
           and 128 x 50, f32 and bf16: equal to rows 2-3 on the 3-D view in
           every element, and vs their plain versions; each launch in its
           plan's regime; times and bounds (the backward's beside
           scaled_dot_product_attention's)
  kernel-fused-tail  rows 13-14 (the fused encoder tail) vs their plain
           versions at TAIL_SHAPES: 7040 x 20 and 128 x 50 (masked and
           not), 1024 x 20 in f32, 128 x 64 (the resident regime's
           longest row) and 128 x 65 (the tiled regime), masked, f32
           and bf16, dropout off and 0.2; each launch in its plan's regime;
           the pooling gradients held to a share of their largest element
           and equal bit for bit over two runs; the count of elements of
           out, dqkv and dw1 that differ from the plain version;
           controls (keep mask from another hash constant or a per-block
           index, dropout scale left out, alpha without the key mask, and
           in bf16 dw1 from the rounded ctx and d_z unrounded before w1^T)
  kernel-fused-tail-long  rows 13-14, masked, at 128 x 87, 128 x 512 (with
           dropout), 32 x 1000 and 64 x 512 (serving: f32, dropout off),
           f32 and bf16, in the tiled regime: a row's work spread over
           blocks, its context in a global scratch; also the control of a
           scratch shared between two rows, and in bf16 those of
           kernel-fused-tail (d_z unrounded before w1^T held where row 4
           does not run on tensor cores); a "[tail-long]" line per case
           with its regimes, its counts of differing out and dqkv
           elements, and each row's ms beside its plain version's and its
           bound
  kernel-sep  rows 5-8 (separate q, k, v; 7-8 with the key mask) vs their
           plain versions at 7040 x 20 with d_v = 20 and d_v = 32, and at
           128 x 300 and 64 x 511 with d_v = 32, f32 and bf16, on q, k, v
           cut from one projection; each launch in its plan's regime
           (forward: row-wise at T = 20; past 64 tensor cores in bf16,
           the tiled kernel in f32; backward: resident at T = 20; past 64
           tensor cores in bf16, the wide kernel in f32); controls (mask
           dropped, v sliced at q's width as the TPU kernels slice it, ds
           without its row-sum term, in bf16 dv from the unrounded a, and
           past T = 64 out from the unrounded a); kernel / plain /
           scaled_dot_product_attention times
  kernel-blanes  rows 15-16 (the batch-in-lanes forward and backward) vs
           their plain versions at 7040 x 20, 128 x 50 (both masks), 64 x
           511 (both) and 128 x T masked for T in 64, 65 (the two sides of
           the regime switch), 128, 200, f32 and bf16; controls as rows 1
           and 4's, and past T = 64 a max and den taken per 64-key tile
           without rescaling; kernel / plain / scaled_dot_product_attention
           times, forward and backward
  kernel-limits  the shapes the kernels once refused, f32 and bf16, masked
           and not, against the plain versions: rows 1-4 (and 11-12) at 8
           heads of 50 and T = 300, 400; rows 9-10 at D = 80, 400 and 1100,
           T = 512; rows 15-16 at f32 D = 64, T = 400 and at D = 80; rows
           13-14 at T = 5000 and 7000
  mhsa-unequal  multi_head_self_attention at d_k = 20, d_v = 32 (1024 x
           20, 20 heads, both masks), forward and backward on the card
           against the CPU, launching rows 5-8 only (the row-wise and
           resident regimes); each run keeps a diagnosis (the card's
           q, k, v projection against the CPU's and each against float64,
           each side's output against the plain version on the float64
           projection, rows 5-8 on the card's projection against their
           plain versions on the same values, the host), which a mismatch
           prints first, on both streams, and carries in its failure
  corpus   a 65,536-news synthetic corpus, full-width NRMS params from a
           seed, and two draws of its behaviors prepared into training
           samples: histories of up to 80 news cut to 50, and of up to 600
           news cut to 512 and to 300
  serve    Recommender.from_state on cuda, the HTTP server on a free
           localhost port, /score (C up to 300) and /recommend (k=10)
           requests, once with user_log_mask False and once True; served
           scores checked against the same params run on the CPU through
           the plain versions; launch counts read around both runs
  serve fused_tail  the same once with fused_tail "on" and user_log_mask
           True: row 13 only, both variants
  serve attention_layout=blanes  the same with attention_layout "blanes":
           row 15 only, both variants
  serve-long  the same with user_log_length 512: the user encoder takes
           the flash forward (row 9) in f32, on CUDA cores, whose launches
           and their regime are counted; the device and wall ms of one
           score_batch of 64 users with 512-news histories x 300
           candidates (profiler); then once with fused_tail "on": row 13
           on both encoders, no flash
  serve heads=8  the same with 8 heads of 50 and user_log_length 400: row
           1 only, on the tiled kernel past T = 64 on the user encoder
  train-check  one f32 train step (dropout off, B=16, full width) on the
           card and on the CPU from the same params and batch: loss, every
           leaf's gradient, the frozen table unchanged; for user_log_mask
           False and True, with bwd_residuals "recompute", with fused_tail
           "on" (both masks), with attention_layout "blanes" (both
           masks), with the word table trained, and at a 512-news history
           (B=8, 5 heads of 20)
  train    fit() at the headline training step (bf16 over f32 params,
           B=128, 1+4 candidates, 50-news history, dropout 0.2, Adam lr
           3e-4, frozen table, device gather, prefetch depth 2) for one
           epoch of at least 30 steps: step ms and ex/s after the first
           step, finite losses, the launches each kernel must have (2
           row-2 and 2 row-3 launches per step and no other) and none
           else; then 20 steps on one batch with dropout off, whose loss
           must fall. Again with bwd_residuals "recompute" (2 row-1 and 2
           row-4 launches per step), the same for 6 steps in f32 (row 4's
           f32 launches), with the word table trained, with
           fused_tail "on" (2 row-13 and 2 row-14 launches per step), with
           attention_io "2d" (2 row-11 and 2 row-12 launches per step),
           with attention_layout "blanes" (2 row-15 and 2 row-16 launches
           per step), for 12 steps with 512-news histories (one row-9 and
           one row-10 launch per step, rows 2-3 once per step for the news
           encoder), the same 12 steps in f32 (the CLI's default dtype:
           rows 9-10 on CUDA cores, each launch counted in that regime),
           for 6 steps with 512-news histories and fused_tail
           "on" (2 row-13 and 2 row-14 launches per step, no flash), and for
           12 steps with 300-news histories (rows 2-3 twice per step, the
           user encoder's on tensor cores)
  naml-train-check  NAML (bench.py:381-388 with both category views: T =
           20, 300-d words, 400-d news) one f32 step (dropout off, B=16)
           on the card and on the CPU from the same params and batch, as
           train-check, every leaf's gradient held (the category tables,
           their dense layers and final_attn included): word ids with a
           frozen table (both masks) and a trained one, and the doc_table
           (both masks) holding the same titles' word vectors
  naml-train  fit() at the NAML benchmark step (bf16, B=128, dropout 0.2,
           lr 3e-4, frozen table) for one epoch, then 20 steps on one
           batch whose loss must fall; again with the word table trained;
           no kernel row may launch
  naml-serve  Recommender.from_state over the 65,536 news with category
           columns (f32), the HTTP server, both masks, answers checked
           against the CPU; no kernel row may launch
  profile  device time, top kernels and device busy share (torch.profiler
           against an unprofiled wall clock) of one served batch of 64
           users x 300 candidates, of a 64-user corpus top-10, of one
           1024-row news-encoder chunk and of the headline, recompute,
           trained-table, fused-tail, 2-D-I/O, blanes, 512-history (bf16
           and f32), 512-history fused-tail and 300-history train steps,
           and of
           the NAML served batch and train steps (frozen and trained
           table)
  cli      the command-line path at the published width, user_log_mask
           on, on a synthetic corpus of 4,000 news (dev impressions of 40
           candidates): cli.main --mode train_test for one epoch (bf16,
           B=128, 3k+1 steps, a save every k steps): the mid-epoch and
           epoch-end checkpoints, train and eval lines in metrics.jsonl,
           2 row-2 and 2 row-3 launches per step and no other in training,
           row 1 (both variants) in the test; the newest checkpoint loaded
           into a fresh state, every param and Adam moment bit-equal to
           the live state; --mode test --load_ckpt_name latest, the same
           eval line to its four decimals, launching row 1 only; again
           with --fused_tail on, launching row 13 only, its metrics within
           1e-3 of those; run_server from the newest checkpoint (f32),
           /score against a CPU Recommender on the checkpoint's params; a
           second epoch resumed from it through the CLI; POST /reload
           (200, then the new checkpoint's scores; 409 while a reload is
           in flight); every behaviors parse of each cli.main call
           native. A "[cli numbers]" line gives the train ex/s through the
           CLI, the checkpoint's size, save and load seconds, eval
           impressions/s, the reload's seconds and train_test's seconds,
           with the card
  naml-cli the fork's NAML demo flags (examples/demo.sh:15-19: doc_table,
           both views, frozen table, user_log_mask False) at the published
           width on cli's corpus: --mode create_embeddings with the hash
           backend, train_test for one epoch (bf16, B=128), run_server from
           the newest checkpoint against a CPU Recommender, a resumed epoch,
           POST /reload; no kernel row may launch; every behaviors parse
           native. A "[naml numbers]" line gives the NAML train ex/s and
           step ms, the profiled NAML steps and served batch, and the
           CLI's AUC, eval impressions/s, train ex/s and reload seconds,
           with the card
  ddp-nccl-1  an NCCL group of one rank on cuda:0: one f32 spmd step
           (its collectives issued) at the headline width against the
           plain step (loss rel 1e-5, each gradient as train-check, every
           leaf rtol 1e-4 / atol 1e-6, an element whose gradient is
           summation noise within Adam's bound), rows 2-3 twice each;
           then DDP_BF16_STEPS bf16 steps: finite losses, step ms, ex/s,
           and one step's device ms and busy share (profiler)
  ddp-gloo two spawned gloo ranks sharing cuda:0 at meshes (2, 1) (64
           rows a rank, frozen table) and (1, 2) (64 rows, the word table
           trained and split over the ranks): one f32 step against the
           one-process step on the same rows, as ddp-nccl-1, the table's
           rows from both ranks; rows 2-3 twice each; at (1, 2) a bf16
           step too (gloo all-reduces the gathered rows in bf16)
  ddp-eval the same two ranks at (1, 2) over a 65,536-news doc_table
           (1.57 GB f32, half a rank): phase 1 with the sharded encoder
           against the one-process cache, phase 2 over each rank's half
           of 2,048 impressions with cross_process_sum against one pass;
           row 1 only
  ddp-cli  the same two ranks: cli.main --mode train_test --table_shards
           2 on cli's corpus: one metrics.jsonl, every checkpoint's two
           shard files, rows 1-3 launched; then --mode test on one
           process from the newest checkpoint repeats the eval line
           (within 1e-3 of a percentage point); every behaviors parse, on
           each rank and in the one process, native. With two cards or
           more, also the CLI's own spawn over NCCL (--nGPU 2); with one, a
           line saying it was not run. A "[ddp numbers]" line gives each
           phase's step ms and ex/s with the card
Every backward row's library time is scaled_dot_product_attention's
backward alone on the same q, k, v (its forward run outside the timed
window), a yardstick the port never calls. Then one JSON line of
per-kernel numbers, and last the line
{"ok": true, "device": {...}}. Any failed phase raises: the exit code is
then not 0 and no result line is printed. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# A bf16 kernel against its plain version (rtol, atol). Both round at the
# same points (a or e, ds, the output) and differ only in the f32 order of
# their sums, which can flip one rounding: an output moves by one ulp (at
# most 2^-7 of it), or dq / dk by one ulp of a rounded ds times k. On the
# card the largest difference was 1.95e-3 in most cases and 3.9e-3 (2^-8)
# in the worst, over outputs that reach 1-9. rtol is two ulps, atol that
# worst difference: a kernel 10% off fails on every element above 0.05
# (outputs at T = 512 are about 0.07 typical, and up to 1.5).
BF16_TOL = (2 ** -6, 2 ** -8)
# Kernel vs plain version on the card. f32: the two sum in another order.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": BF16_TOL}  # (rtol, atol)
# Served scores vs the same params on the CPU (f32, two devices' orders).
SERVE_TOL = (1e-4, 1e-4)
# Kernel rows 2-4 and 9-10 vs their plain versions: (forward, backward).
TRAIN_TOL = {"float32": ((1e-5, 1e-5), (1e-4, 1e-4)),
             "bfloat16": (BF16_TOL, BF16_TOL)}
# Every comparison also runs against the plain result scaled by this
# factor, a kernel a few percent off, and must reject it on many elements.
OFF_SCALE = 1.0 + 2 ** -4
# Train step on the card vs the CPU (f32): loss rtol; each leaf's gradient
# within this share of that leaf's largest |gradient|.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_SHARE = 1e-4
# ... or within this share of the largest gradient of any leaf, whichever
# is larger. Some leaves' gradients nearly cancel: the key bias of each
# MHSA and the score bias of each pooling are 0 analytically (they shift
# all scores of a row alike), and on near-uniform attention the news
# pooling's gradients are tiny too. What is left of them is f32 rounding
# noise of two summation orders, about 1e-9 of the largest gradient.
TRAIN_GRAD_FLOOR = 1e-6
TPU_KERNELS = "newsrecommendation_tpu/ops/pallas/fused_attention.py"
FLASH_KERNELS = "newsrecommendation_tpu/ops/pallas/blockwise.py"
REPLACES = f"{TPU_KERNELS}:199"
CSRC = "newsrecommendation_tpu_torch/csrc"
SOURCE = f"{CSRC}/qkv_fwd.cu"
BWD_PROBS_SOURCE = f"{CSRC}/qkv_bwd_probs.cu"
BWD_SOURCE = f"{CSRC}/qkv_bwd.cu"
FLASH_FWD_SOURCE = f"{CSRC}/flash_fwd.cu"
FLASH_BWD_SOURCE = f"{CSRC}/flash_bwd.cu"
QKV2D_KERNELS = "newsrecommendation_tpu/ops/pallas/experimental_qkv2d.py"
TAIL_KERNELS = ("newsrecommendation_tpu/ops/pallas/"
                "experimental_fused_encoder.py")
BLANES_KERNELS = "newsrecommendation_tpu/ops/pallas/experimental_blanes.py"
TAIL_FWD_SOURCE = f"{CSRC}/fused_tail_fwd.cu"
TAIL_BWD_SOURCE = f"{CSRC}/fused_tail_bwd.cu"
SEP_SOURCE = f"{CSRC}/mhsa_sep.cu"
BLANES_SOURCE = f"{CSRC}/blanes.cu"
# Rows 3-4 past the resident kernel (T > 201 at D = 20): (N, T) of a
# user encoder over 202-, 300- and 511-news histories; in bf16 the
# tensor-core kernels, which stage the keys in chunks.
LONG_T = ((64, 202), (128, 300), (64, 511))
# A user history below flash_min_seq that rows 2-3 take at full width.
MID_L = 300
MID_STEPS = 12  # train steps at MID_L
# A long user history: flash_min_seq keys, so MHSA takes rows 9-10.
LONG_L = 512
LONG_STEPS = 12  # train steps at LONG_L
# Rows 13-14 past the resident regime, in the tiled one (the per-row
# kernels once kept a row in shared memory up to T = 86 / 85 at the NRMS
# width), masked: (N, T, dropout, dtypes) one position past that, the
# user encoder at LONG_L in training, the flash cases' 1000 (past row 4's
# 599, so row 14's attention part stages its operands in global memory
# too; the tiled attention's sub-tile of 16 queries), and the served user
# encoder at LONG_L (64 users, f32, dropout off). At 1000, 32 rows lie
# within one block of the planted per-block keep mask, so dropout is off;
# and in bf16 the pooled output of 1000 positions moves by less than the
# 2^-8 atol when alpha loses the key mask, so only f32 there.
TAIL_LONG = ((128, 87, True, ("float32", "bfloat16")),
             (128, LONG_L, True, ("float32", "bfloat16")),
             (32, 1000, False, ("float32",)),
             (64, LONG_L, False, ("float32",)))
FUSED_LONG_STEPS = 6  # train steps with the fused tail at LONG_L
# train steps of the headline step in f32 with bwd_residuals "recompute":
# row 4's f32 launches on its main path
F32_RECOMPUTE_STEPS = 6
# Rows 13-14 at the main paths' shapes and on both sides of the resident
# regime's end (T = 64): (masked, N, T, dtypes) -- the headline step's news
# and user encoders, the corpus encoder's chunk (f32, serving), then
# (128, 64) resident and (128, 65) on the per-row kernels.
TAIL_SHAPES = ((False, 7040, 20, ("float32", "bfloat16")),
               (False, 128, 50, ("float32", "bfloat16")),
               (True, 128, 50, ("float32", "bfloat16")),
               (False, 1024, 20, ("float32",)),
               (True, 128, 64, ("float32", "bfloat16")),
               (True, 128, 65, ("float32", "bfloat16")))
# Rows 15-16 besides the main paths' T (20, 50, 511): both sides of the
# regime switch (T <= 64 holds a head's T x T in shared memory), and two
# lengths past it.
BLANES_T = (64, 65, 128, 200)
# The shapes the card once refused and the JAX route runs: (rows, N, T,
# heads, D), each in f32 and bf16, masked and not. Rows 1-4 (and 11-12) at
# 8 heads of 50 (examples/demo.sh) past what shared memory once held (rows
# 1-2 and 11 there now tiled in f32, on tensor cores in bf16); rows 9-10 at
# news_dim 400 in 5 heads and 1 (D = 80, 400) and at a head of 1100 (two
# slices of the wide kernels); rows 15-16 at f32 D = 64 past one head's K
# and V in a block, and at D = 80. Rows 13-14 (TAIL_LIMITS: T, heads of
# 20) at T = 5000, past the 4,470 row 4's tiled kernel held, and at
# T = 7000, past the rows the tail kept in shared memory (6,456 forward,
# 5,771 backward at the NRMS width; 4 heads keep the plain version small).
LIMIT_CASES = (("rows1-4", 16, 300, 8, 50), ("rows1-4", 16, 400, 8, 50),
               ("flash", 8, 512, 5, 80), ("flash", 4, 512, 1, 400),
               ("flash", 2, 512, 1, 1100),
               ("blanes", 8, 400, 2, 64), ("blanes", 8, 512, 5, 80))
TAIL_LIMITS = ((5000, 20), (7000, 4))
# Serving at 8 heads of 50 over 400-news histories: row 1 on the tiled
# kernel on the user encoder.
MID_SERVE_L = 400
# Rows 5-8 at the news encoder's shape with d_v = d_k and d_v = 32, and
# past T = 64 (on tensor cores in bf16; in f32 rows 5 and 7 on the tiled
# kernel, rows 6 and 8 on the wide one) at the user encoder's long shapes
# with d_v = 32.
SEP_DV = (20, 32)
SEP_LONG = ((128, 300), (64, 511))
# The long train-check's reduced width (heads of 20 as published).
LONG_CHECK = {"news_dim": 100, "num_attention_heads": 5,
              "news_query_vector_dim": 50, "user_query_vector_dim": 50,
              "batch_size": 8}
# Longest synthetic history of the long phases' behaviors: past LONG_L, so
# some histories fill it.
MAX_HISTORY = 600
NUM_NEWS = 65536
MAX_BATCH = 64
# Impressions of the synthetic corpus: about 2.4 training samples each,
# enough for one epoch of more than 30 steps at batch 128.
TRAIN_IMPRESSIONS = 2400
TRAIN_STEPS_MIN = 30
# The device the training phases run on; a rehearsal without a card sets
# it to "cpu" (the plain versions then stand in for the kernels).
DEVICE = "cuda"
# The cli phase: a synthetic corpus of CLI_NEWS news, at most
# CLI_TRAIN_IMPRESSIONS training impressions (the longest head whose epoch
# of B = 128 has 3k+1 steps, so the newest save, after step 3k, is the
# final state), dev impressions of CLI_CANDIDATES candidates each.
CLI_NEWS = 4000
CLI_TRAIN_IMPRESSIONS = 1500
CLI_DEV_IMPRESSIONS = 400
CLI_CANDIDATES = 40
CLI_ROUTE_TOL = 1e-3  # fused tail vs default route: metrics (not percent)
CLI_FLAGS = []  # appended to every cli command line (a rehearsal's widths)
# native-parse: the shards' least sizes in MB (10^6 bytes): about
# MIND-small's prepared train shard at K = 4, and a large dev shard
PARSE_TRAIN_MB = 200
PARSE_DEV_MB = 50
# the single-card cli phases stay on one card where there are more: with
# --data_parallel 0 the CLI spawns a rank on every card, as JAX's mesh
ONE_CARD = ["--data_parallel", "1"]

_T0 = time.perf_counter()


def phase(label: str, t_start: float, **info) -> None:
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{label}] {time.perf_counter() - t_start:.3f}s "
          f"(total {time.perf_counter() - _T0:.3f}s) {extra}", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

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


def profile_device(fn, reps: int = 10) -> dict:
    """Device time of ``fn`` per call by torch.profiler, its top kernels,
    and its share of the same loop's wall time measured without the
    profiler (the device's busy share; 1 - that is its idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's entry repeats its kernels' time,
    # and so does a range annotated on the device (Optimizer.step's)
    dev = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in dev)
    if device_ms <= 0:
        fail("the profiler saw no device time")
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall_s * 1e3),
            "top_ms": [[k[:60], ms] for k, ms in dev[:8]]}


def n_outside(out, ref, rtol, atol) -> int:
    """Elements of out not within atol + rtol * |ref| of ref; a NaN on
    either side counts as outside."""
    err = (out.float() - ref.float()).abs()
    return int((~(err <= atol + rtol * ref.float().abs())).sum().item())


def kernel_case(fa, variant, n, t, heads, d, dtype, seed):
    """One kernel-vs-plain comparison with timings and the bound."""
    import torch
    import torch.nn.functional as F

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hd = heads * d
    qkv = torch.randn((n, t, 3 * hd), generator=gen, device="cuda").to(tdt)
    bias = (0.5 * torch.randn((3 * hd,), generator=gen, device="cuda")).to(tdt)
    mask = None
    if variant == "bias_masked":
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: its output is 0
    call = ((lambda: fa.exp_mhsa_qkv_bias(qkv, bias, heads)) if mask is None
            else (lambda: fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, heads)))
    fa.reset_launch_counts()
    out = call()
    regimes = fa.regime_counts("qkv_fwd")
    want = fa.fwd_launch_plan(n, t, heads, d, tdt).regime
    if regimes != {want: 1}:
        fail(f"{variant} {dtype} N={n} T={t}: row 1 launched {regimes}, its "
             f"plan {want}")
    ref = fa.exp_mhsa_qkv_bias_reference(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    rtol, atol = TOL[dtype]
    if not torch.isfinite(out.float()).all():
        fail(f"{variant} {dtype} N={n} T={t}: non-finite kernel output")
    if n_outside(out, ref, rtol, atol):
        fail(f"{variant} {dtype} N={n} T={t}: max |kernel - plain| "
             f"{err.max().item():.3e} over rtol {rtol} atol {atol}")
    if mask is not None and out[::7].abs().max().item() != 0.0:
        fail(f"{variant} {dtype}: fully masked rows are not 0")
    # controls: the same comparison must reject plain versions with a
    # planted fault, so a clean result above is not a blind check
    scale = 1.0 + 10 * rtol
    faults = {"bias dropped": (qkv, torch.zeros_like(bias), mask),
              f"inputs scaled by {scale}": (qkv * scale, bias * scale, mask)}
    if mask is not None:
        faults["mask dropped"] = (qkv, bias, None)
    caught = {}
    for name, args in faults.items():
        caught[name] = n_outside(
            out, fa.exp_mhsa_qkv_bias_reference(*args, heads), rtol, atol)
        if not caught[name]:
            fail(f"{variant} {dtype}: a plain version with {name} passed "
                 "the comparison")
    if dtype == "bfloat16" and want == "mma":
        # the tensor-core forward rounds a into the A fragment of a@V
        caught["out from the f32 a (differing elements)"] = rounding_fault(
            out, qkv_fwd_unrounded(qkv, bias, mask, heads),
            n_differ(out, ref), rtol, atol)
        check_caught(f"{variant} {dtype} N={n} T={t}", caught)
    kernel_ms = time_ms(call)
    plain_ms = time_ms(
        lambda: fa.exp_mhsa_qkv_bias_reference(qkv, bias, mask, heads))
    # yardstick only: softmax attention on the same q, k, v (equal to this
    # function on rows with a key left, up to eps); the port never calls it
    x = (qkv + bias).view(n, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        x[0], x[1], x[2], attn_mask=attn_mask))
    item = qkv.element_size()
    n_bytes = item * (n * t * 3 * hd + 3 * hd + n * t * hd)
    if mask is not None:
        n_bytes += 4 * n * t
    flops = 4 * n * heads * t * t * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "variant": variant, "shape": [n, t, heads, d], "dtype": dtype,
        "regime": want,
        "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
        "n_differ": int((err != 0).sum().item()), "n_elems": err.numel(),
        "max_abs_ref": ref.float().abs().max().item(),
        "faults_caught": caught,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def n_differ(a, b) -> int:
    return int((a.float() != b.float()).sum().item())


def qkv_fwd_unrounded(qkv, bias, mask, heads):
    """Rows 1-2's plain context with a fault: a meets v in f32, not rounded
    to v's dtype first."""
    import torch

    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    n, t, w3 = qkv.shape
    d = w3 // (3 * heads)
    _, probs = fa.attend_f32(qkv, bias, mask, heads)
    a = probs.view(n, t, heads, t)
    v = (qkv + bias)[..., 2 * heads * d:].view(n, t, heads, d).float()
    ctx = torch.einsum("bqhk,bkhd->bqhd", a, v)
    return ctx.reshape(n, t, heads * d).to(qkv.dtype)


def bwd_plain_with_fault(qkv, bias, probs, g, heads, *, rowsum=True,
                         round_a=True, round_ds=True, r_keys=None):
    """The plain backward of row 3 with a planted fault: the ds row-sum
    term dropped, dv computed from the f32 a instead of a rounded to g's
    dtype, dq and dk from the f32 ds instead of ds rounded to k's dtype,
    or (``r_keys``) the row sum r taken over the first r_keys keys only,
    as a kernel that summed one staged chunk would."""
    import torch

    n, t, w3 = qkv.shape
    d = w3 // (3 * heads)
    x = (qkv + bias).view(n, t, 3, heads, d).float()
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    gh = g.view(n, t, heads, d).float()
    a = probs.view(n, t, heads, t).permute(0, 2, 1, 3)
    al = a.to(g.dtype).float() if round_a else a
    dv = torch.einsum("bhqk,bqhd->bkhd", al, gh)
    da = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    keys = t if r_keys is None else r_keys
    r = (da * a)[..., :keys].sum(-1, keepdim=True) if rowsum else 0.0
    ds = (da - r) * a * (1.0 / d ** 0.5)
    if round_ds:
        ds = ds.to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([y.reshape(n, t, heads * d) for y in (dq, dk, dv)],
                     -1).to(qkv.dtype)


def probs_with_chunk_den(qkv, bias, mask, heads, keys):
    """Rows 1-2's plain probs with den summed over the first ``keys`` keys
    only (m still over all keys), as a kernel that normalised by one staged
    chunk would: a planted fault of row 4."""
    import torch

    n, t, w3 = qkv.shape
    d = w3 // (3 * heads)
    x = (qkv + bias).view(n, t, 3, heads, d).float()
    s = torch.einsum("bqhd,bkhd->bhqk", x[:, :, 0], x[:, :, 1]) / d ** 0.5
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    if mask is not None:
        e = e * mask[:, None, None, :]
    den = e[..., :keys].sum(-1, keepdim=True) + 1e-8 * torch.exp(-m)
    a = torch.where(den > 0, e / den, torch.zeros_like(e))
    return a.permute(0, 2, 1, 3).reshape(n, t, heads * t)


def chunk_keys(fa, n, t, heads, d, dtype, probs=False):
    """Keys of one staged chunk of row 4's (``probs``: row 3's) query side
    on tensor cores, or 256 where the kernel stages none; None when T fits
    in one."""
    import torch

    plan = fa.bwd_launch_plan(n, t, heads, d, getattr(torch, dtype),
                              probs=probs)
    keys = plan.query.chunk if plan.regime == "mma" else 256
    return keys if t > keys else None


def bwd_rounding_faults(dqkv, qkv, bias, probs, g, heads, base_differ,
                        tol) -> dict:
    """The bf16 rounding faults of rows 3-4: dv from the f32 a, dq and dk
    from the f32 ds. Each moves the result by less than an ulp, so each is
    rejected by its count of differing elements (rounding_fault)."""
    return {f"{name} (differing elements)": rounding_fault(
                dqkv, bwd_plain_with_fault(qkv, bias, probs, g, heads, **kw),
                base_differ, *tol)
            for name, kw in (("dv from the f32 a", {"round_a": False}),
                             ("dq, dk from the f32 ds", {"round_ds": False}))}


def train_kernel_case(fa, variant, n, t, heads, d, dtype, seed):
    """Rows 2 and 3 against their plain versions on the card, with planted
    faults, timings and bounds."""
    import torch

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(100 + seed)
    hd = heads * d
    qkv = torch.randn((n, t, 3 * hd), generator=gen, device=DEVICE).to(tdt)
    bias = (0.5 * torch.randn((3 * hd,), generator=gen, device=DEVICE)).to(tdt)
    g = torch.randn((n, t, hd), generator=gen, device=DEVICE).to(tdt)
    mask = None
    if variant == "bias_masked":
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: probs and output 0
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL[dtype]
    where = f"{variant} {dtype} N={n} T={t}"

    fa.reset_launch_counts()
    ctx, probs = fa.qkv_fwd_probs(qkv, bias, mask, heads)
    row1 = (fa.exp_mhsa_qkv_bias(qkv, bias, heads) if mask is None
            else fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, heads))
    check_fwd_regimes(where, fa, n, t, heads, d, tdt, ("qkv_fwd",
                                                       "qkv_fwd_probs"))
    ref_ctx, ref_probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias,
                                                              mask, heads)
    dqkv = fa.qkv_bwd_probs(qkv, bias, ref_probs, g, heads)
    check_bwd_regime(where, fa, "qkv_bwd_probs", n, t, heads, d, tdt, True)
    ref_dqkv = fa.qkv_bwd_probs_reference(qkv, bias, ref_probs, g, heads)
    dqkv.sum().item()  # waits for the kernels
    if not torch.equal(ctx, row1):
        fail(f"{where}: row 2's context is not row 1's bit for bit")
    out = {"variant": variant, "shape": [n, t, heads, d], "dtype": dtype,
           "ctx": compare(where, "ctx", ctx, ref_ctx, f_rtol, f_atol),
           "probs": compare(where, "probs", probs, ref_probs,
                            *TRAIN_TOL["float32"][0]),
           "dqkv": compare(where, "dqkv", dqkv, ref_dqkv, b_rtol, b_atol)}
    if mask is not None and (probs[::7].abs().max().item() != 0.0
                             or dqkv[::7].abs().max().item() != 0.0):
        fail(f"{where}: fully masked rows have probs or dqkv not 0")
    # controls: the same comparisons must reject plain versions with a
    # planted fault
    transposed = ref_probs.view(n, t, heads, t).permute(0, 3, 2, 1).reshape(
        n, t, heads * t)
    caught = {"probs transposed per head": n_outside(
        probs, transposed, *TRAIN_TOL["float32"][0])}
    no_rowsum = bwd_plain_with_fault(qkv, bias, ref_probs, g, heads,
                                     rowsum=False)
    caught["ds without its row-sum term"] = n_outside(dqkv, no_rowsum,
                                                      b_rtol, b_atol)
    keys = chunk_keys(fa, n, t, heads, d, dtype, probs=True)
    if keys:
        caught[f"r over the first {keys} keys only"] = n_outside(
            dqkv, bwd_plain_with_fault(qkv, bias, ref_probs, g, heads,
                                       r_keys=keys), b_rtol, b_atol)
    if dtype == "bfloat16":
        caught.update(bwd_rounding_faults(dqkv, qkv, bias, ref_probs, g,
                                          heads, out["dqkv"]["n_differ"],
                                          (b_rtol, b_atol)))
    if dtype == "bfloat16" and fa.fwd_launch_plan(
            n, t, heads, d, tdt).regime == "mma":
        caught["ctx from the f32 a (differing elements)"] = rounding_fault(
            ctx, qkv_fwd_unrounded(qkv, bias, mask, heads),
            out["ctx"]["n_differ"], f_rtol, f_atol)
    check_caught(where, caught)
    out["faults_caught"] = caught

    item = qkv.element_size()
    mask_bytes = 0 if mask is None else 4 * n * t
    fwd_bytes = (item * (n * t * 3 * hd + 3 * hd + n * t * hd)
                 + 4 * n * t * heads * t + mask_bytes)
    bwd_bytes = (item * (2 * n * t * 3 * hd + 3 * hd + n * t * hd)
                 + 4 * n * t * heads * t)
    out["fwd"] = timed(lambda: fa.qkv_fwd_probs(qkv, bias, mask, heads),
                       lambda: fa.exp_mhsa_qkv_bias_probs_reference(
                           qkv, bias, mask, heads),
                       fwd_bytes, 4 * n * heads * t * t * d, dtype)
    out["bwd"] = timed(lambda: fa.qkv_bwd_probs(qkv, bias, ref_probs, g,
                                                heads),
                       lambda: fa.qkv_bwd_probs_reference(qkv, bias,
                                                          ref_probs, g,
                                                          heads),
                       bwd_bytes, 8 * n * heads * t * t * d, dtype,
                       library=sdpa_bwd_of_qkv(qkv, bias, mask, g, heads))
    return out


def recompute_kernel_case(fa, variant, n, t, heads, d, dtype, seed):
    """Row 4 (the backward that recomputes the probs) against its plain
    version on the card, with planted faults, the count of elements that
    differ from row 3's dqkv fed row 2's probs, timings and the bound."""
    import torch

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(200 + seed)
    hd = heads * d
    qkv = torch.randn((n, t, 3 * hd), generator=gen, device=DEVICE).to(tdt)
    bias = (0.5 * torch.randn((3 * hd,), generator=gen, device=DEVICE)).to(tdt)
    g = torch.randn((n, t, hd), generator=gen, device=DEVICE).to(tdt)
    mask = None
    if variant == "bwd_masked":
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: its dqkv is 0
    _, b_tol = TRAIN_TOL[dtype]
    where = f"{variant} {dtype} N={n} T={t}"

    fa.reset_launch_counts()
    dqkv = fa.qkv_bwd(qkv, bias, mask, g, heads)
    check_bwd_regime(where, fa, "qkv_bwd", n, t, heads, d, tdt, False)
    ref = fa.qkv_bwd_reference(qkv, bias, mask, g, heads)
    fa.reset_launch_counts()
    _, probs = fa.qkv_fwd_probs(qkv, bias, mask, heads)
    check_fwd_regimes(where, fa, n, t, heads, d, tdt, ("qkv_fwd_probs",))
    row3 = fa.qkv_bwd_probs(qkv, bias, probs, g, heads)
    dqkv.sum().item()  # waits for the kernels
    out = {"variant": variant, "shape": [n, t, heads, d], "dtype": dtype,
           "dqkv": compare(where, "dqkv", dqkv, ref, *b_tol),
           "n_differ_from_row3": n_differ(dqkv, row3)}
    if mask is not None and dqkv[::7].abs().max().item() != 0.0:
        fail(f"{where}: fully masked rows have dqkv not 0")
    _, ref_probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, mask,
                                                        heads)
    caught = {"ds without its row-sum term": n_outside(
        dqkv, bwd_plain_with_fault(qkv, bias, ref_probs, g, heads,
                                   rowsum=False), *b_tol)}
    if mask is not None:
        caught["mask dropped"] = n_outside(
            dqkv, fa.qkv_bwd_reference(qkv, bias, None, g, heads), *b_tol)
    keys = chunk_keys(fa, n, t, heads, d, dtype)
    if keys:
        caught[f"r over the first {keys} keys only"] = n_outside(
            dqkv, bwd_plain_with_fault(qkv, bias, ref_probs, g, heads,
                                       r_keys=keys), *b_tol)
        caught[f"den over the first {keys} keys only"] = n_outside(
            dqkv, fa.qkv_bwd_probs_reference(
                qkv, bias, probs_with_chunk_den(qkv, bias, mask, heads, keys),
                g, heads), *b_tol)
    if dtype == "bfloat16":
        caught.update(bwd_rounding_faults(dqkv, qkv, bias, ref_probs, g,
                                          heads, out["dqkv"]["n_differ"],
                                          b_tol))
    check_caught(where, caught)
    out["faults_caught"] = caught
    item = qkv.element_size()
    n_bytes = (item * (2 * n * t * 3 * hd + 3 * hd + n * t * hd)
               + (0 if mask is None else 4 * n * t))
    out["bwd"] = timed(lambda: fa.qkv_bwd(qkv, bias, mask, g, heads),
                       lambda: fa.qkv_bwd_reference(qkv, bias, mask, g,
                                                    heads),
                       n_bytes, 10 * n * heads * t * t * d, dtype,
                       library=sdpa_bwd_of_qkv(qkv, bias, mask, g, heads))
    return out


def flash_fwd_plain_without_rescale(q, k, v, key_mask, heads, bkv):
    """Row 9's plain version with a planted fault: the accumulator of the
    earlier key blocks of bkv keys (the last one may be shorter) is not
    rescaled when the running max grows. Also row 15's fault of a max and
    a den taken per key tile."""
    import torch

    n, t, hd = q.shape
    d = hd // heads
    qh, kh = (x.reshape(n, t, heads, d).float() for x in (q, k))
    vh = v.reshape(n, t, heads, d)
    m = q.new_full((n, heads, t), -1e30, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = q.new_zeros((n, heads, t, d), dtype=torch.float32)
    for b0 in range(0, t, bkv):
        s = torch.einsum("nqhd,nkhd->nhqk", qh, kh[:, b0:b0 + bkv]) * (
            1.0 / d ** 0.5)
        m_new = torch.maximum(m, s.amax(-1))
        scale = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        if key_mask is not None:
            e = e * key_mask[:, None, None, b0:b0 + bkv]
        l = l * scale + e.sum(-1)
        acc = acc + torch.einsum("nhqk,nkhd->nhqd", e.to(v.dtype).float(),
                                 vh[:, b0:b0 + bkv].float())
        m = m_new
    den = l + 1e-8 * torch.exp(-m)
    o = torch.where(den[..., None] > 0, acc / den[..., None],
                    torch.zeros_like(acc))
    return o.permute(0, 2, 1, 3).reshape(n, t, hd).to(q.dtype)


def flash_fwd_plain_tile_max(q, k, v, key_mask, heads, bkv, tile=64):
    """Row 9's plain version with e rounded at another point: inside each
    key block the max is taken per tile of ``tile`` keys and the sums are
    rescaled as it grows (an online max per tile, as a flash kernel that
    ignored the key block would take it). In exact arithmetic it equals
    the plain version; in bf16 only its rounding of e differs, so only its
    count of differing elements shows it."""
    import torch

    n, t, hd = q.shape
    d = hd // heads
    qh, kh = (x.reshape(n, t, heads, d).float() for x in (q, k))
    vh = v.reshape(n, t, heads, d)
    m = q.new_full((n, heads, t), -1e30, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = q.new_zeros((n, heads, t, d), dtype=torch.float32)
    for b0 in range(0, t, bkv):
        for t0 in range(b0, min(b0 + bkv, t), tile):
            t1 = min(t0 + tile, b0 + bkv, t)
            s = torch.einsum("nqhd,nkhd->nhqk", qh, kh[:, t0:t1]) * (
                1.0 / d ** 0.5)
            m_new = torch.maximum(m, s.amax(-1))
            scale = torch.exp(m - m_new)
            e = torch.exp(s - m_new[..., None])
            if key_mask is not None:
                e = e * key_mask[:, None, None, t0:t1]
            l = l * scale + e.sum(-1)
            acc = acc * scale[..., None] + torch.einsum(
                "nhqk,nkhd->nhqd", e.to(v.dtype).float(),
                vh[:, t0:t1].float())
            m = m_new
    den = l + 1e-8 * torch.exp(-m)
    o = torch.where(den[..., None] > 0, acc / den[..., None],
                    torch.zeros_like(acc))
    return o.permute(0, 2, 1, 3).reshape(n, t, hd).to(q.dtype)


def flash_bwd_plain_with_fault(q, k, v, key_mask, g, m, den, delta, heads,
                               *, round_a=True, use_delta=True,
                               round_ds=True):
    """Row 10's plain version with a planted fault: dv from the f32 a, not
    from a rounded to g's dtype; ds without delta; or dq and dk from the
    f32 ds, not from ds rounded to k's dtype. Returns (dq, dk, dv)."""
    import torch

    from newsrecommendation_tpu_torch.ops import blockwise as bw

    n, t, hd = q.shape
    d = hd // heads
    bkv = bw.kv_block(t)
    inv = 1.0 / d ** 0.5
    qh, kh, vh = (x.reshape(n, t, heads, d).float() for x in (q, k, v))
    gh = g.reshape(n, t, heads, d).float()
    mt, dent, deltat = (x.permute(0, 2, 1)[..., None] for x in (m, den,
                                                                 delta))
    dq = torch.zeros_like(qh)
    dks, dvs = [], []
    for b0 in range(0, t, bkv):
        kb, vb = kh[:, b0:b0 + bkv], vh[:, b0:b0 + bkv]
        e = torch.exp(torch.einsum("nqhd,nkhd->nhqk", qh, kb) * inv - mt)
        if key_mask is not None:
            e = e * key_mask[:, None, None, b0:b0 + bkv]
        a = torch.where(dent > 0, e / dent, torch.zeros_like(e))
        al = a.to(g.dtype).float() if round_a else a
        dvs.append(torch.einsum("nhqk,nqhd->nkhd", al, gh))
        da = torch.einsum("nqhd,nkhd->nhqk", gh, vb)
        ds = (da - (deltat if use_delta else 0.0)) * a * inv
        if round_ds:
            ds = ds.to(k.dtype).float()
        dq = dq + torch.einsum("nhqk,nkhd->nqhd", ds, kb)
        dks.append(torch.einsum("nhqk,nqhd->nkhd", ds, qh))
    return tuple(x.reshape(n, t, hd).to(q.dtype)
                 for x in (dq, torch.cat(dks, 1), torch.cat(dvs, 1)))


def flash_kernel_case(bw, masked, n, t, heads, d, dtype, seed):
    """Rows 9 and 10 against their plain versions on the card, on q, k, v
    cut from one fused projection as the model cuts them, with planted
    faults, timings (row 9's beside scaled_dot_product_attention) and
    bounds."""
    import torch
    import torch.nn.functional as F

    from newsrecommendation_tpu_torch.ops import kernels

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(300 + seed)
    hd = heads * d
    qkv = torch.randn((n, t, 3 * hd), generator=gen, device=DEVICE).to(tdt)
    q, k, v = torch.split(qkv, hd, dim=-1)
    g = torch.randn((n, t, hd), generator=gen, device=DEVICE).to(tdt)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: o and grads 0
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL[dtype]
    where = f"flash{'_masked' if masked else ''} {dtype} N={n} T={t}"
    bkv = bw.kv_block(t)

    kernels.reset_launch_counts()
    o, m, den = bw.flash_fwd(q, k, v, mask, heads)
    ro, rm, rden = bw.flash_fwd_reference(q, k, v, mask, heads)
    delta = bw.delta_of(g, ro, heads)
    grads = bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, heads)
    refs = bw.flash_bwd_reference(q, k, v, mask, g, rm, rden, delta, heads)
    grads[0].sum().item()  # waits for the kernels
    regime = bw.launch_plan(n, t, heads, d, tdt).regime
    for kernel in FLASH_REGIME_KERNELS:
        if kernels.regime_counts(kernel) != {regime: 1}:
            fail(f"{where}: {kernel} launched "
                 f"{kernels.regime_counts(kernel)}, its plan {regime}")
    stat_tol = TRAIN_TOL["float32"][0]
    out = {"variant": "flash_masked" if masked else "flash",
           "shape": [n, t, heads, d], "dtype": dtype, "block_kv": bkv,
           "regime": regime,
           "o": compare(where, "o", o, ro, f_rtol, f_atol),
           "m": compare(where, "m", m, rm, *stat_tol),
           "den": compare(where, "den", den, rden, *stat_tol)}
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        out[name] = compare(where, name, got, want, b_rtol, b_atol)
    if mask is not None and (o[::7].abs().max().item() != 0.0 or any(
            x[::7].abs().max().item() != 0.0 for x in grads)):
        fail(f"{where}: fully masked rows have o or grads not 0")
    caught = {}
    if t // bkv > 1:  # with one key block nothing is ever rescaled
        caught["acc not rescaled by the running max"] = n_outside(
            o, flash_fwd_plain_without_rescale(q, k, v, mask, heads, bkv),
            f_rtol, f_atol)
    no_delta = flash_bwd_plain_with_fault(q, k, v, mask, g, rm, rden, delta,
                                          heads, use_delta=False)
    for i, name in ((0, "dq"), (1, "dk")):
        caught[f"ds without delta ({name})"] = n_outside(
            grads[i], no_delta[i], b_rtol, b_atol)
    if dtype == "bfloat16":
        # e rounded against a per-64-key-tile max: the kernel must round
        # where the plain version does, against the key block's max
        tiled = n_differ(flash_fwd_plain_tile_max(q, k, v, mask, heads, bkv),
                         ro)
        out["o_n_differ_tile_max_control"] = tiled
        caught["e rounded against a per-64-key-tile max (differing "
               "elements, 10x the kernel's)"] = (
            tiled if tiled >= 10 * out["o"]["n_differ"] else 0)
        caught["dv from the f32 a (differing elements)"] = rounding_fault(
            grads[2], flash_bwd_plain_with_fault(
                q, k, v, mask, g, rm, rden, delta, heads, round_a=False)[2],
            out["dv"]["n_differ"], b_rtol, b_atol)
        f32_ds = flash_bwd_plain_with_fault(q, k, v, mask, g, rm, rden, delta,
                                            heads, round_ds=False)
        for i, name in ((0, "dq"), (1, "dk")):
            caught[f"{name} from the f32 ds (differing elements)"] = (
                rounding_fault(grads[i], f32_ds[i], out[name]["n_differ"],
                               b_rtol, b_atol))
    check_caught(where, caught)
    out["faults_caught"] = caught
    item = q.element_size()
    q_bytes = item * n * t * hd
    stat_bytes = 4 * n * t * heads
    mask_bytes = 0 if mask is None else 4 * n * t
    flops = n * heads * t * t * d
    iters = 10 if t * t * n > 2 ** 25 else 20
    # library: softmax attention on the same q, k, v, equal to this
    # function on rows with a key left (up to its 1e-8 term); timed as a
    # yardstick, never called by the port
    qh, kh, vh = (x.view(n, t, heads, d).transpose(1, 2) for x in (q, k, v))
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    out["fwd"] = timed(lambda: bw.flash_fwd(q, k, v, mask, heads),
                       lambda: bw.flash_fwd_reference(q, k, v, mask, heads),
                       4 * q_bytes + 2 * stat_bytes + mask_bytes, 4 * flops,
                       dtype, iters,
                       library=lambda: F.scaled_dot_product_attention(
                           qh, kh, vh, attn_mask=attn_mask))
    out["bwd"] = timed(
        lambda: bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, heads),
        lambda: bw.flash_bwd_reference(q, k, v, mask, g, rm, rden, delta,
                                       heads),
        7 * q_bytes + 3 * stat_bytes + mask_bytes, 10 * flops, dtype, iters,
        library=sdpa_bwd(qh, kh, vh, attn_mask,
                         g.view(n, t, heads, d).transpose(1, 2)))
    return out


def qkv2d_kernel_case(q2, fa, n, t, heads, d, dtype, seed):
    """Rows 11 and 12 (the 2-D-I/O forward and backward) against rows 2-3
    on the (N, T, 3HD) view, element for element, and against their plain
    versions, with timings and bounds."""
    import torch

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(400 + seed)
    hd = heads * d
    qkv2d = torch.randn((n * t, 3 * hd), generator=gen,
                        device=DEVICE).to(tdt)
    bias = (0.5 * torch.randn((3 * hd,), generator=gen, device=DEVICE)).to(tdt)
    g = torch.randn((n, t, hd), generator=gen, device=DEVICE).to(tdt)
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL[dtype]
    where = f"qkv2d {dtype} N={n} T={t}"

    fa.reset_launch_counts()
    out, probs = q2.qkv2d_fwd(qkv2d, bias, heads, t)
    dqkv = q2.qkv2d_bwd(qkv2d, bias, probs, g, heads, t)
    check_fwd_regimes(where, fa, n, t, heads, d, tdt, ("qkv2d_fwd",))
    check_bwd_regime(where, fa, "qkv2d_bwd", n, t, heads, d, tdt, True)
    out3, probs3 = fa.qkv_fwd_probs(qkv2d.view(n, t, -1), bias, None, heads)
    dqkv3 = fa.qkv_bwd_probs(qkv2d.view(n, t, -1), bias, probs3, g, heads)
    ref, ref_probs = q2.qkv2d_fwd_reference(qkv2d, bias, heads, t)
    ref_dqkv = q2.qkv2d_bwd_reference(qkv2d, bias, ref_probs, g, heads, t)
    dqkv.sum().item()  # waits for the kernels
    differ = {"ctx": n_differ(out, out3), "probs": n_differ(probs, probs3),
              "dqkv": n_differ(dqkv.view_as(dqkv3), dqkv3)}
    if any(differ.values()):
        fail(f"{where}: rows 11-12 differ from rows 2-3 in {differ} elements")
    out_case = {"shape": [n, t, heads, d], "dtype": dtype,
                "n_differ_from_rows_2_3": differ,
                "ctx": compare(where, "ctx", out, ref, f_rtol, f_atol),
                "probs": compare(where, "probs", probs, ref_probs,
                                 *TRAIN_TOL["float32"][0]),
                "dqkv": compare(where, "dqkv", dqkv, ref_dqkv, b_rtol,
                                b_atol)}
    item = qkv2d.element_size()
    out_case["fwd"] = timed(
        lambda: q2.qkv2d_fwd(qkv2d, bias, heads, t),
        lambda: q2.qkv2d_fwd_reference(qkv2d, bias, heads, t),
        item * (n * t * 3 * hd + 3 * hd + n * t * hd) + 4 * n * t * heads * t,
        4 * n * heads * t * t * d, dtype)
    out_case["bwd"] = timed(
        lambda: q2.qkv2d_bwd(qkv2d, bias, probs, g, heads, t),
        lambda: q2.qkv2d_bwd_reference(qkv2d, bias, ref_probs, g, heads, t),
        item * (2 * n * t * 3 * hd + 3 * hd + n * t * hd)
        + 4 * n * t * heads * t, 8 * n * heads * t * t * d, dtype,
        library=sdpa_bwd_of_qkv(qkv2d.view(n, t, -1), bias, None, g, heads))
    return out_case


# The summed pooling gradients (dw1, db1, dw2, db2 of row 14) against the
# plain version's: each element within this share of the largest element
# of the four, plus rtol. They are sums over every position (140,800 at the
# news encoder), so an element near 0 is a difference of large terms, and
# db2 is 0 analytically (alpha sums to 1 on a row, or is 0): a relative
# bound per element would hold noise to itself. f32: two summation orders;
# bf16: also a rounding flip of a bf16 operand (ctx for fc1, e for fc2,
# d_z for w1^T) in a term.
POOL_GRAD_SHARE = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -6, 2 ** -8)}
TAIL_BLOCK = 64  # rows per block of the planted per-block keep mask


def tail_inputs(n, t, heads, d, q, dtype, masked, seed, v_scale=1.0):
    """Biased qkv, the key mask (every 7th row fully masked) or None, the
    pooling params as the model feeds them (w1, w2 in the input dtype, b1,
    b2 f32) and the output's gradient g, on DEVICE. g is scaled by T / 20
    past T = 20: the pooling weights spread it over T positions, and at
    T = 512 unscaled every bf16 dqkv element lies below the 2^-8 atol,
    where no comparison could tell a kernel 6% off. v is scaled by
    ``v_scale``."""
    import torch

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(500 + seed)
    hd = heads * d

    def rnd(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=DEVICE)

    qkv = rnd((n, t, 3 * hd))
    qkv[..., 2 * hd:] *= v_scale
    qkv = qkv.to(tdt)
    pool = (rnd((hd, q), (6.0 / (hd + q)) ** 0.5).to(tdt), rnd((1, q), 0.1),
            rnd((q, 1), (6.0 / (q + 1)) ** 0.5).to(tdt), rnd((1, 1), 0.1))
    g = rnd((n, hd), max(1.0, t / 20)).to(tdt)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0
    return qkv, mask, pool, g


def tail_faults(fe, dropout, masked, long_rows=False):
    """Planted faults of row 13's plain version: {name: patches of the
    module's functions or constants}, each to be rejected by the forward's
    comparison. ``long_rows``: the rows live in a global scratch, and one
    fault lets two rows share a slot (the second row pools the first's
    context)."""
    import torch

    keep = fe.keep_mask
    context = fe._context

    def shared_slot(*args, **kw):
        ctx, probs = context(*args, **kw)
        ctx = ctx.clone()
        ctx[1::2] = ctx[0::2][:ctx[1::2].shape[0]]
        return ctx, probs

    def per_block(shape, rate, seed, row0=0):
        n, t, hd = shape
        return torch.cat([keep((min(TAIL_BLOCK, n - r), t, hd), rate, seed)
                          for r in range(0, n, TAIL_BLOCK)])

    faults = {}
    if dropout:
        faults["keep mask from another hash constant"] = {
            "_MIX1": fe._MIX1 ^ 0x10}
        faults["keep mask from a per-block index"] = {"keep_mask": per_block}
        faults["dropout scale left out"] = {
            "keep_mask": lambda *a, **k: (keep(*a, **k) > 0).float()}
    if masked:
        pool_fwd = fe._pool_fwd
        faults["alpha without the key mask"] = {
            "_pool_fwd": lambda ctx, key_mask, *p: pool_fwd(ctx, None, *p)}
    if long_rows:
        faults["scratch shared between two rows"] = {"_context": shared_slot}
    return faults


def tail_kernel_case(fe, masked, n, t, heads, d, q, dtype, dropout, seed):
    """Rows 13 and 14 (the fused encoder tail) against their plain versions
    on the card, row 14's outputs equal over two runs, planted faults,
    timings and bounds."""
    import torch

    qkv, mask, pool, g = tail_inputs(n, t, heads, d, q, dtype, masked, seed)
    rate = 0.2
    sd = torch.tensor([1234567 + seed], dtype=torch.int32, device=DEVICE)
    args = (qkv, mask, *pool, sd, heads, rate, not dropout)
    bargs = (*args[:7], g, *args[7:])
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL[dtype]
    where = (f"tail{'_masked' if masked else ''} {dtype} N={n} T={t} "
             f"dropout={dropout}")

    fe.kernels.reset_launch_counts()
    out = fe.fused_tail_fwd(*args)
    grads = fe.fused_tail_bwd(*bargs)
    again = fe.fused_tail_bwd(*bargs)
    ref = fe.fused_tail_fwd_reference(*args)
    refs = fe.fused_tail_bwd_reference(*bargs)
    out.sum().item()  # waits for the kernels
    regimes = {k: fe.kernels.regime_counts(f"fused_tail_{k}")
               for k in ("fwd", "bwd")}
    tdt = getattr(torch, dtype)
    want = {k: {fe.tail_launch_plan(k, n, t, heads, d, q, tdt).regime: c}
            for k, c in (("fwd", 1), ("bwd", 2))}
    if regimes != want:
        fail(f"{where}: launches per regime {regimes}, the plans' {want}")
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail(f"{where}: two runs of row 14 differ")
    flat = torch.cat([x.reshape(-1) for x in grads[1:]])
    ref_flat = torch.cat([x.reshape(-1) for x in refs[1:]])
    p_rtol, share = POOL_GRAD_SHARE[dtype]
    largest = ref_flat.abs().max().item()
    case = {"variant": "tail_masked" if masked else "tail",
            "shape": [n, t, heads, d, q], "dtype": dtype,
            "dropout": rate if dropout else 0.0,
            "out": compare(where, "out", out, ref, f_rtol, f_atol),
            "dqkv": compare(where, "dqkv", grads[0], refs[0], b_rtol, b_atol),
            "pool_grads": compare(where, "pool grads", flat, ref_flat, p_rtol,
                                  share * largest),
            "repeat_equal": True, "regimes": regimes,
            "dw1_n_differ": n_differ(grads[1], refs[1])}
    if mask is not None and (out[::7].abs().max().item() != 0.0
                             or grads[0][::7].abs().max().item() != 0.0):
        fail(f"{where}: fully masked rows have out or dqkv not 0")
    caught = {}
    # the context lives in a global scratch: plant a slot shared by two rows
    long_rows = want["fwd"].keys() & {"tiled", "global"} != set()
    case["long_rows"] = long_rows
    # row 4 on tensor cores (bf16 past T = 201 at D = 20) sums dqkv in
    # another order than the plain version, which leaves a count of sub-ulp
    # dqkv elements like the d_z fault's; everywhere else that fault is held
    row4 = fe.fa.bwd_launch_plan(n, t, heads, d, tdt).regime
    case["row4_regime"] = row4
    for name, attrs in tail_faults(fe, dropout, masked, long_rows).items():
        with mock.patch.multiple(fe, **attrs):
            caught[name] = n_outside(out, fe.fused_tail_fwd_reference(*args),
                                     f_rtol, f_atol)
    if dtype == "bfloat16":
        dw1 = fe._dw1
        with mock.patch.multiple(fe, _dw1=lambda ctx, d_z: dw1(
                ctx.to(torch.bfloat16).float(), d_z)):
            fault = fe.fused_tail_bwd_reference(*bargs)[1]
        # dw1 reaches the bf16 weights rounded to bf16, as the Function
        # returns it: count the elements that differ there
        got16, ref16 = grads[1].bfloat16(), refs[1].bfloat16()
        caught["dw1 from the bf16-rounded ctx (differing elements)"] = (
            rounding_fault(got16, fault.bfloat16(), n_differ(got16, ref16),
                           p_rtol, share * largest))
        with mock.patch.multiple(fe, _dctx_of_dz=lambda d_z, w1: torch.matmul(
                d_z, w1.float().t())):
            fault = fe.fused_tail_bwd_reference(*bargs)[0]
        name = "d_z not rounded before w1^T (differing elements)"
        if row4 != "mma":
            caught[name] = rounding_fault(grads[0], fault,
                                          case["dqkv"]["n_differ"], b_rtol,
                                          b_atol)
        else:
            # the same rounding code as the shorter tiled rows, which hold
            # this fault: here its count is recorded, not held
            case["d_z_fault_differ"] = [n_differ(grads[0], fault),
                                        case["dqkv"]["n_differ"]]
    check_caught(where, caught)
    case["faults_caught"] = caught

    item = qkv.element_size()
    hd = heads * d
    param_bytes = item * (hd * q + q) + 4 * (q + 1)
    mask_bytes = 0 if mask is None else 4 * n * t
    attn = n * heads * t * t * d
    pool_flops = n * t * hd * q
    iters = 3 if t > 100 else 10 if n * t > 50000 else 20
    case["fwd"] = timed(
        lambda: fe.fused_tail_fwd(*args),
        lambda: fe.fused_tail_fwd_reference(*args),
        item * (n * t * 3 * hd + n * hd) + param_bytes + mask_bytes + 4,
        4 * attn + 2 * pool_flops + 2 * n * t * (q + hd), dtype, iters)
    case["bwd"] = timed(
        lambda: fe.fused_tail_bwd(*bargs),
        lambda: fe.fused_tail_bwd_reference(*bargs),
        item * (2 * n * t * 3 * hd + n * hd) + param_bytes + mask_bytes + 4
        + 4 * (hd * q + 2 * q + 1), 10 * attn + 6 * pool_flops, dtype, iters)
    return case

def blanes_kernel_case(bl, fa, masked, n, t, heads, d, dtype, seed):
    """Rows 15 and 16 (batch-in-lanes forward and backward) against their
    plain versions on the card, with planted faults, timings (row 15's
    beside scaled_dot_product_attention) and bounds."""
    import torch
    import torch.nn.functional as F

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(600 + seed)
    hd = heads * d
    qkv = (torch.randn((n, t, 3 * hd), generator=gen, device=DEVICE)
           + 0.5 * torch.randn((3 * hd,), generator=gen,
                               device=DEVICE)).to(tdt)
    g = torch.randn((n, t, hd), generator=gen, device=DEVICE).to(tdt)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: its output is 0
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL[dtype]
    where = f"blanes{'_masked' if masked else ''} {dtype} N={n} T={t}"

    out = bl.blanes_fwd(qkv, mask, heads)
    dqkv = bl.blanes_bwd(qkv, mask, g, heads)
    ref = bl.blanes_fwd_reference(qkv, mask, heads)
    ref_dqkv = bl.blanes_bwd_reference(qkv, mask, g, heads)
    dqkv.sum().item()  # waits for the kernels
    case = {"variant": "blanes_masked" if masked else "blanes",
            "shape": [n, t, heads, d], "dtype": dtype,
            "ctx": compare(where, "ctx", out, ref, f_rtol, f_atol),
            "dqkv": compare(where, "dqkv", dqkv, ref_dqkv, b_rtol, b_atol)}
    if mask is not None and (out[::7].abs().max().item() != 0.0
                             or dqkv[::7].abs().max().item() != 0.0):
        fail(f"{where}: fully masked rows have ctx or dqkv not 0")
    zero = torch.zeros(3 * hd, dtype=tdt, device=DEVICE)
    _, probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, zero, mask, heads)
    caught = {"ds without its row-sum term": n_outside(
        dqkv, bwd_plain_with_fault(qkv, zero, probs, g, heads, rowsum=False),
        b_rtol, b_atol)}
    if mask is not None:
        caught["mask dropped"] = n_outside(
            out, bl.blanes_fwd_reference(qkv, None, heads), f_rtol, f_atol)
    if t > bl.TILE:
        # a design that walks the keys in tiles of the long regime's rows
        # and takes the max and den of each tile without rescaling
        caught[f"max and den per {bl.TILE}-key tile, not rescaled"] = (
            n_outside(out, flash_fwd_plain_without_rescale(
                *torch.split(qkv, hd, dim=-1), mask, heads, bl.TILE),
                f_rtol, f_atol))
    if dtype == "bfloat16":
        caught.update(bwd_rounding_faults(dqkv, qkv, zero, probs, g, heads,
                                          case["dqkv"]["n_differ"],
                                          (b_rtol, b_atol)))
    check_caught(where, caught)
    case["faults_caught"] = caught
    item = qkv.element_size()
    mask_bytes = 0 if mask is None else 4 * n * t
    iters = 3 if t > 100 else 20
    # library: softmax attention on the same q, k, v, equal to this
    # function on rows with a key left (up to its 1e-8 term); timed as a
    # yardstick, never called by the port
    x = qkv.view(n, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    case["fwd"] = timed(
        lambda: bl.blanes_fwd(qkv, mask, heads),
        lambda: bl.blanes_fwd_reference(qkv, mask, heads),
        item * (n * t * 3 * hd + n * t * hd) + mask_bytes,
        4 * n * heads * t * t * d, dtype, iters,
        library=lambda: F.scaled_dot_product_attention(
            x[0], x[1], x[2], attn_mask=attn_mask))
    case["bwd"] = timed(
        lambda: bl.blanes_bwd(qkv, mask, g, heads),
        lambda: bl.blanes_bwd_reference(qkv, mask, g, heads),
        item * (2 * n * t * 3 * hd + n * t * hd) + mask_bytes,
        10 * n * heads * t * t * d, dtype, iters,
        library=sdpa_bwd_of_qkv(qkv, None, mask, g, heads))
    return case


def sep_fwd_unrounded(fa, q, k, v, mask, heads):
    """Rows 5 and 7's plain version with a fault: a meets v in f32, not
    rounded to v's dtype first."""
    import torch

    n, t, _, dv = fa._check_sep(q, k, v, mask, heads)
    a, _, _ = fa._sep_probs(q, k, mask, heads)
    ctx = torch.einsum("bhqk,bkhd->bqhd", a,
                       v.reshape(n, t, heads, dv).float())
    return ctx.reshape(n, t, heads * dv).to(q.dtype)


def sep_kernel_case(fa, masked, n, t, heads, dk, dv, dtype, seed):
    """Rows 5-8 (separate q, k, v; rows 7-8 with the key mask) against
    their plain versions on the card, on q, k, v cut from one projection,
    at d_v = d_k and d_v != d_k, with planted faults, timings (each
    beside scaled_dot_product_attention, the backward's alone) and
    bounds; each launch must take its plan's regime."""
    import torch
    import torch.nn.functional as F

    from newsrecommendation_tpu_torch.ops import kernels

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(700 + seed)
    hdk, hdv = heads * dk, heads * dv
    proj = torch.randn((n, t, 2 * hdk + hdv), generator=gen,
                       device=DEVICE).to(tdt)
    q, k, v = torch.split(proj, [hdk, hdk, hdv], dim=-1)
    g = torch.randn((n, t, hdv), generator=gen, device=DEVICE).to(tdt)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: output and grads 0
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL[dtype]
    where = (f"mhsa{'_masked' if masked else ''} {dtype} N={n} T={t} "
             f"dk={dk} dv={dv}")

    kernels.reset_launch_counts()
    out = fa.mhsa_sep_fwd(q, k, v, mask, heads)
    grads = fa.mhsa_sep_bwd(q, k, v, mask, g, heads)
    regimes = kernels.regime_counts("mhsa_bwd")
    fwd_regimes = kernels.regime_counts("mhsa_fwd")
    want = fa.sep_bwd_launch_plan(n, t, heads, dk, dv, tdt).regime
    if regimes != {want: 1}:
        fail(f"{where}: the backward launched {regimes}, its plan {want}")
    want = fa.sep_fwd_launch_plan(n, t, heads, dk, dv, tdt).regime
    if fwd_regimes != {want: 1}:
        fail(f"{where}: the forward launched {fwd_regimes}, its plan {want}")
    ref = fa.exp_mhsa_reference(q, k, v, mask, heads)
    refs = fa.exp_mhsa_bwd_reference(q, k, v, mask, g, heads)
    grads[0].sum().item()  # waits for the kernels
    case = {"variant": "mhsa_masked" if masked else "mhsa",
            "shape": [n, t, heads, dk, dv], "dtype": dtype,
            "regimes": regimes, "fwd_regimes": fwd_regimes,
            "ctx": compare(where, "ctx", out, ref, f_rtol, f_atol)}
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        case[name] = compare(where, name, got, want, b_rtol, b_atol)
    if mask is not None and (out[::7].abs().max().item() != 0.0 or any(
            x[::7].abs().max().item() != 0.0 for x in grads)):
        fail(f"{where}: fully masked rows have ctx or grads not 0")
    caught = {}
    if mask is not None:
        caught["mask dropped"] = n_outside(
            out, fa.exp_mhsa_reference(q, k, v, None, heads), f_rtol, f_atol)
    if dv != dk:
        # the JAX package's rows 5-8: the output sized by q's width and v
        # sliced with q's per-head slice (zero past that width here)
        sliced = fa.exp_mhsa_reference(q, k, v[..., :hdk], mask, heads)
        caught["v sliced at q's width"] = n_outside(
            out, F.pad(sliced, (0, hdv - hdk)), f_rtol, f_atol)
    if dtype == "bfloat16" and t > fa.SEP_SHORT_T:
        # the tensor-core forward rounds a into the A fragment of a@V
        caught["out from the f32 a (differing elements)"] = rounding_fault(
            out, sep_fwd_unrounded(fa, q, k, v, mask, heads),
            case["ctx"]["n_differ"], f_rtol, f_atol)
    if dv == dk:
        qkv = proj.contiguous()
        zero = torch.zeros(3 * hdk, dtype=tdt, device=DEVICE)
        _, probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, zero, mask,
                                                        heads)
        got = torch.cat(grads, -1)
        caught["ds without its row-sum term"] = n_outside(
            got, bwd_plain_with_fault(qkv, zero, probs, g, heads,
                                      rowsum=False), b_rtol, b_atol)
        if dtype == "bfloat16":
            caught.update(bwd_rounding_faults(
                got, qkv, zero, probs, g, heads,
                sum(case[x]["n_differ"] for x in ("dq", "dk", "dv")),
                (b_rtol, b_atol)))
    check_caught(where, caught)
    case["faults_caught"] = caught
    item = q.element_size()
    mask_bytes = 0 if mask is None else 4 * n * t
    in_bytes = item * n * t * (2 * hdk + hdv)
    qh, kh = (x.view(n, t, heads, dk).transpose(1, 2) for x in (q, k))
    vh = v.view(n, t, heads, dv).transpose(1, 2)
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    case["fwd"] = timed(
        lambda: fa.mhsa_sep_fwd(q, k, v, mask, heads),
        lambda: fa.exp_mhsa_reference(q, k, v, mask, heads),
        in_bytes + item * n * t * hdv + mask_bytes,
        2 * n * heads * t * t * (dk + dv), dtype,
        library=lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=attn_mask))
    case["bwd"] = timed(
        lambda: fa.mhsa_sep_bwd(q, k, v, mask, g, heads),
        lambda: fa.exp_mhsa_bwd_reference(q, k, v, mask, g, heads),
        2 * in_bytes + item * n * t * hdv + mask_bytes,
        n * heads * t * t * (6 * dk + 4 * dv), dtype,
        library=sdpa_bwd(qh, kh, vh, attn_mask,
                         g.view(n, t, heads, dv).transpose(1, 2)))
    return case


def limits_case(fa, bw, bl, q2, which, n, t, heads, d, dtype, masked, seed):
    """One shape of LIMIT_CASES: each kernel of ``which`` against its plain
    version on the same inputs (every 7th row fully masked when
    ``masked``). Returns the comparisons' numbers."""
    import torch

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(900 + seed)
    hd = heads * d
    qkv = torch.randn((n, t, 3 * hd), generator=gen, device=DEVICE).to(tdt)
    bias = (0.5 * torch.randn((3 * hd,), generator=gen, device=DEVICE)).to(tdt)
    g = torch.randn((n, t, hd), generator=gen, device=DEVICE).to(tdt)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0
    f_tol, b_tol = TRAIN_TOL[dtype]
    where = f"kernel-limits {which} {dtype} N={n} T={t} D={d} m={masked}"
    out = {"rows": which, "shape": [n, t, heads, d], "dtype": dtype,
           "masked": masked}
    if which == "rows1-4":
        with torch.inference_mode():
            row1 = (fa.exp_mhsa_qkv_bias(qkv, bias, heads) if mask is None
                    else fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, heads))
        ctx, probs = fa.qkv_fwd_probs(qkv, bias, mask, heads)
        ref_ctx, ref_probs = fa.exp_mhsa_qkv_bias_probs_reference(
            qkv, bias, mask, heads)
        ref_d = fa.qkv_bwd_probs_reference(qkv, bias, ref_probs, g, heads)
        out["row1"] = compare(where, "row 1 ctx", row1, ref_ctx, *f_tol)
        out["row2"] = compare(where, "row 2 probs", probs, ref_probs,
                              *TRAIN_TOL["float32"][0])
        if not torch.equal(ctx, row1):
            fail(f"{where}: row 2's context is not row 1's bit for bit")
        out["row3"] = compare(where, "row 3 dqkv", fa.qkv_bwd_probs(
            qkv, bias, ref_probs, g, heads), ref_d, *b_tol)
        out["row4"] = compare(where, "row 4 dqkv", fa.qkv_bwd(
            qkv, bias, mask, g, heads), ref_d, *b_tol)
        if mask is None:  # rows 11-12 are unmasked only
            flat = qkv.view(n * t, -1)
            ctx2, probs2 = q2.qkv2d_fwd(flat, bias, heads, t)
            if not (torch.equal(ctx2, ctx) and torch.equal(probs2, probs)):
                fail(f"{where}: row 11 is not row 2 bit for bit")
            out["row12"] = compare(where, "row 12 dqkv", q2.qkv2d_bwd(
                flat, bias, ref_probs, g, heads, t).view(n, t, -1), ref_d,
                *b_tol)
    elif which == "flash":
        q, k, v = torch.split(qkv, hd, dim=-1)  # views of one projection
        o, m, den = bw.flash_fwd(q, k, v, mask, heads)
        ro, rm, rden = bw.flash_fwd_reference(q, k, v, mask, heads)
        out["row9"] = compare(where, "row 9 o", o, ro, *f_tol)
        out["row9_den"] = compare(where, "row 9 den", den, rden,
                                  *TRAIN_TOL["float32"][0])
        delta = bw.delta_of(g, ro, heads)
        got = bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, heads)
        want = bw.flash_bwd_reference(q, k, v, mask, g, rm, rden, delta,
                                      heads)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            out[f"row10_{name}"] = compare(where, f"row 10 {name}", x, y,
                                           *b_tol)
    else:
        out["row15"] = compare(where, "row 15 ctx", bl.blanes_fwd(
            qkv, mask, heads), bl.blanes_fwd_reference(qkv, mask, heads),
            *f_tol)
        out["row16"] = compare(where, "row 16 dqkv", bl.blanes_bwd(
            qkv, mask, g, heads), bl.blanes_bwd_reference(qkv, mask, g,
                                                          heads), *b_tol)
    return out


def tail_pool_f64(qkv, mask, w1, b1, w2, b2, g, heads):
    """Row 14's pooling gradients (dw1, db1, dw2, db2) in float64 from the
    same inputs, dropout off, flattened as tail_kernel_case flattens them:
    the exp-normalised attention per head, then the pooling through
    autograd (its max detached: it carries no gradient in the kernels)."""
    import torch

    x = qkv.double()
    n, t, w3 = x.shape
    hd = w3 // 3
    d = hd // heads
    ctx = torch.empty((n, t, hd), dtype=torch.float64, device=x.device)
    for h in range(heads):
        q, k, v = (x[..., i * hd + h * d:i * hd + (h + 1) * d]
                   for i in range(3))
        s = torch.einsum("nid,njd->nij", q, k) / d ** 0.5
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m) * mask[:, None, :].double()
        a = e / (e.sum(-1, keepdim=True) + 1e-8 * torch.exp(-m))
        ctx[..., h * d:(h + 1) * d] = torch.einsum("nij,njd->nid", a, v)
    w1, b1, w2, b2 = (p.double().requires_grad_() for p in (w1, b1, w2, b2))
    score = (torch.tanh(ctx @ w1 + b1[0]) @ w2)[..., 0] + b2[0, 0]
    m = score.amax(-1, keepdim=True).detach()
    num = torch.exp(score - m) * mask.double()
    alpha = num / (num.sum(-1, keepdim=True) + 1e-8 * torch.exp(-m))
    out = torch.einsum("nt,ntc->nc", alpha, ctx)
    grads = torch.autograd.grad((out * g.double()).sum(), (w1, b1, w2, b2))
    return torch.cat([x.reshape(-1) for x in grads])


def tail_limit_case(fe, t, heads, dtype, seed):
    """Rows 13-14 at T = t with ``heads`` heads of 20, masked, dropout off,
    against their plain versions: the pooled output, dqkv and the pooling
    gradients. The pooled output averages thousands of positions, a few
    hundredths, where bf16's atol cannot tell a kernel 6% off: the output
    and the pooling gradients are held on inputs whose v is scaled by
    sqrt(T / 20), where every comparison must reject the plain version
    scaled by OFF_SCALE; dqkv on the unscaled ones (the same draws), since
    its bf16 atol is an ulp of an O(1) ds carried into dq and dk, and v
    scales ds. In f32 the pooling gradients, sums over 2T positions, are
    also held against a float64 reference (tail_pool_f64), within the
    larger of POOL_GRAD_SHARE's share of the largest and four times the
    f32 plain version's own distance from it."""
    import torch

    seed_t = torch.zeros(1, dtype=torch.int32, device=DEVICE)

    def args_of(v_scale):
        qkv, mask, pool, g = tail_inputs(2, t, heads, 20, 200, dtype, True,
                                         seed, v_scale=v_scale)
        args = (qkv, mask, *pool, seed_t, heads, 0.0, True)
        return args, (*args[:7], g, *args[7:])

    f_tol, b_tol = TRAIN_TOL[dtype]
    where = f"kernel-limits tail {dtype} T={t} H={heads}"
    res = {"rows": "tail", "shape": [2, t, heads, 20], "dtype": dtype,
           "masked": True}
    _, bargs = args_of(1.0)
    res["row14"] = compare(where, "row 14 dqkv", fe.fused_tail_bwd(*bargs)[0],
                           fe.fused_tail_bwd_reference(*bargs)[0], *b_tol)
    args, bargs = args_of((t / 20) ** 0.5)
    res["row13"] = compare(where, "row 13 out", fe.fused_tail_fwd(*args),
                           fe.fused_tail_fwd_reference(*args), *f_tol)
    grads = fe.fused_tail_bwd(*bargs)
    refs = fe.fused_tail_bwd_reference(*bargs)
    flat = torch.cat([x.reshape(-1) for x in grads[1:]])
    ref_flat = torch.cat([x.reshape(-1) for x in refs[1:]])
    p_rtol, share = POOL_GRAD_SHARE[dtype]
    largest = ref_flat.abs().max().item()
    res["pool_grads"] = compare(where, "pool grads", flat, ref_flat, p_rtol,
                                share * largest)
    if dtype == "float32":
        exact = tail_pool_f64(*bargs[:2], *bargs[2:6], bargs[7], heads)
        spread = (ref_flat.double() - exact).abs().max().item()
        res["pool_grads_f64"] = compare(
            where, "pool grads vs float64", flat, exact, p_rtol,
            max(share * largest, 4 * spread))
        res["pool_grads_f64"]["plain_max_abs_err"] = spread
    return res


def unequal_run(masked, n=1024, t=20, heads=20, dk=20, dv=32, d_model=300):
    """multi_head_self_attention at d_v != d_k, forward and backward, on
    the card and on the CPU from the same params and input: the card's
    route is rows 5-8 (launch counts reset just before and read just
    after), the CPU's their plain versions. Output and the input's
    gradient held as a kernel to its plain version (f32), each projection
    weight's gradient within TRAIN_GRAD_SHARE of its largest element. Each
    run keeps its own projection and forward operands (references, and a
    copy of the forward's output before the backward) for
    unequal_diagnosis, which every run keeps in its result and a mismatch
    prints first, on both streams, and carries in its failure."""
    import torch

    from newsrecommendation_tpu_torch.ops import attention, kernels
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator().manual_seed(800 + masked)
    params = attention.init_multi_head_self_attention(gen, d_model, heads,
                                                      dk, dv)
    x = torch.randn((n, t, d_model), generator=gen)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0
    g = torch.randn((n, t, heads * dv), generator=gen)
    real_qkv = attention._fused_qkv

    def run(dev):
        """One forward and backward on ``dev``: (its own kept values, its
        results, its regime counts)."""
        own = {}
        # the forward rows 5 and 7 take there: the kernel, or on the CPU
        # the plain version
        fwd_name = ("exp_mhsa_reference" if torch.device(dev).type == "cpu"
                    else "mhsa_sep_fwd")

        def fused_qkv(p, xs):
            r = real_qkv(p, xs)
            own["qkv_2d"] = r[0].detach()
            return r

        def fwd(q, k, v, m, h, _fwd=getattr(fa, fwd_name)):
            o = _fwd(q, k, v, m, h)
            own["qkv"] = [y.detach() for y in (q, k, v)]
            own["out"] = o.detach().clone()
            return o

        # leaves of this run only: a CPU run's gradients start from none
        p = {k: {nm: w.detach().to(dev).requires_grad_()
                 for nm, w in v.items()} for k, v in params.items()}
        xx = x.detach().to(dev).requires_grad_()
        kernels.reset_launch_counts()
        with mock.patch.object(attention, "_fused_qkv", fused_qkv), \
                mock.patch.object(fa, fwd_name, fwd):
            out = attention.multi_head_self_attention(
                p, xx, None if mask is None else mask.to(dev),
                n_heads=heads)
            out.backward(g.to(dev))
        xx.grad.sum().item()  # waits for the kernels
        launches = {k: kernels.launch_counts(k) for k in kernels.KERNELS
                    if any(kernels.launch_counts(k).values())}
        regime = {k: kernels.regime_counts(k)
                  for k in ("mhsa_fwd", "mhsa_bwd")}
        return own, (out.detach().cpu(), xx.grad.cpu(),
                     {k: p[k]["w"].grad.cpu() for k in p}, launches), regime

    res, kept, regimes = {}, {}, {}
    kept[DEVICE], res[DEVICE], regimes[DEVICE] = run(DEVICE)
    kept["cpu"], res["cpu"], regimes["cpu"], cpu_vote = cpu_reference(
        run, f"mhsa-unequal masked={masked}")
    where = f"mhsa-unequal masked={masked}"
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL["float32"]
    diagnosis = unequal_diagnosis(kept, res, mask, g, heads, params, x)
    if (n_outside(res[DEVICE][0], res["cpu"][0], f_rtol, f_atol)
            or n_outside(res[DEVICE][1], res["cpu"][1], b_rtol, b_atol)):
        line = f"  {where} diagnosis " + json.dumps(diagnosis)
        print(line, flush=True)
        print(line, file=sys.stderr, flush=True)
    try:
        out = {"shape": [n, t, heads, dk, dv],
               "ctx": compare(where, "ctx", res[DEVICE][0], res["cpu"][0],
                              f_rtol, f_atol),
               "dx": compare(where, "dx", res[DEVICE][1], res["cpu"][1],
                             b_rtol, b_atol)}
    except RuntimeError as e:
        fail(f"{e}; diagnosis {json.dumps(diagnosis)}")
    out["diagnosis"] = diagnosis
    out["cpu_reference"] = cpu_vote
    worst = 0.0
    for k, got in res[DEVICE][2].items():
        want = res["cpu"][2][k]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not err <= TRAIN_GRAD_SHARE * scale:
            fail(f"{where}: {k} gradient differs by {err:.3e}, over "
                 f"{TRAIN_GRAD_SHARE} of its max {scale:.3e}")
        worst = max(worst, err / scale)
    out["worst_weight_grad_share"] = worst
    variant = "_masked" if masked else ""
    launches = res[DEVICE][3]
    if set(launches) != {"mhsa_fwd", "mhsa_bwd"} or not (
            launches["mhsa_fwd"]["mhsa" + variant]
            and launches["mhsa_bwd"]["mhsa_bwd" + variant]):
        fail(f"{where}: launches {launches}, expected rows 5-8 only")
    # at T = 20 rows 5 and 7 take the row-wise kernel, rows 6 and 8 the
    # resident one
    want = {"mhsa_fwd": {"rowwise": 1}, "mhsa_bwd": {"resident": 1}}
    if regimes[DEVICE] != want:
        fail(f"{where}: regimes {regimes[DEVICE]}, expected {want}")
    if res["cpu"][3]:
        fail(f"{where}: the CPU counted launches {res['cpu'][3]}")
    out["launches"] = launches
    out["regimes"] = regimes[DEVICE]
    return out


def cpu_reference(run, where):
    """The CPU side of a card-against-CPU check, voted: ``run("cpu")``
    twice, and a third time if the two differ in any bit; the result two
    runs give bit for bit, else a failure. The same code on the same
    inputs repeats its bits on one host, so a run that does not is a fault
    of that run, not of the program under test: on the card's host one in
    forty fresh processes gave an output 8.1e-5 off in its first CPU run
    while the card and every recomputation agreed with the float64
    reference (scripts/mismatch_repeat.py --fresh). Returns run's triple
    and the vote (runs, and where the odd one differed), which a
    disagreement also prints on both streams."""
    runs = [run("cpu"), run("cpu")]
    vote = {"runs": 2}
    if not _same_bits(runs[0][1], runs[1][1]):
        runs.append(run("cpu"))
        vote["runs"] = 3
        pairs = [(i, j) for i in range(3) for j in range(i + 1, 3)
                 if _same_bits(runs[i][1], runs[j][1])]
        if not pairs:
            fail(f"{where}: three CPU reference runs differ: "
                 + json.dumps([_bits_apart(runs[0][1], r[1])
                               for r in runs[1:]]))
        i, _ = pairs[0]
        odd = ({0, 1, 2} - set(pairs[0])).pop()
        vote["odd_run"] = odd
        vote["odd_apart"] = _bits_apart(runs[i][1], runs[odd][1])
        line = f"  {where} CPU reference vote " + json.dumps(vote)
        print(line, flush=True)
        print(line, file=sys.stderr, flush=True)
        return (*runs[i], vote)
    return (*runs[0], vote)


def _same_bits(a, b) -> bool:
    """Whether two of unequal_run's results (out, dx, weight grads) are
    equal bit for bit."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))


def _bits_apart(a, b) -> dict:
    """Where two of unequal_run's results differ: per output the count of
    differing elements, the largest difference and the first and last
    batch row that differ."""
    import torch

    out = {}
    for name, x, y in (("out", a[0], b[0]), ("dx", a[1], b[1]),
                       *((k, a[2][k], b[2][k]) for k in a[2])):
        diff = (x - y).abs()
        rows = torch.nonzero(diff.reshape(diff.shape[0], -1).amax(1))
        out[name] = {"n": int((diff > 0).sum()), "max": diff.max().item(),
                     "rows": [int(rows.min()), int(rows.max())]
                     if rows.numel() else []}
    return out


def unequal_diagnosis(kept, res, mask, g, heads, params, x) -> dict:
    """Where a card/CPU mismatch of unequal_run entered, from each run's own
    values (``kept``: the un-biased projection qkv_2d, the forward's q, k,
    v and its output before the backward; ``res``: unequal_run's results
    after the backward): the card's projection against the CPU's (the
    GEMM), and each against the projection in float64 from the same
    ``params`` and ``x``; each side's output against rows 5 and 7's plain
    version on the float64 projection rounded to f32 (which side moved);
    the card's forward output against rows 5 and 7's plain version on the
    card's own q, k, v, copied to the CPU, and the same for rows 6 and 8
    with g (the kernels); whether the forward's output changed during the
    backward; whether the forward repeats its bits; the worst output
    element (row, position, lane) and the count outside the tolerance;
    and the host (torch's CPU capability and threads, the f32 matmul
    settings). Largest differences throughout."""
    import torch

    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL["float32"]
    card, cpu = kept[DEVICE], kept["cpu"]
    q, k, v = card["qkv"]
    dmask = None if mask is None else mask.to(DEVICE)
    with torch.no_grad():
        names = ("wq", "wk", "wv")
        w = torch.cat([params[nm]["w"].detach() for nm in names], 1)
        bias = torch.cat([params[nm]["b"].detach() for nm in names])
        exact = x.detach().reshape(-1, x.shape[-1]).double() @ w.double()
        qkv_exact = exact.float().reshape(*x.shape[:2], -1) + bias
        ctx_exact = fa.exp_mhsa_reference(
            *torch.split(qkv_exact, [q.shape[-1], k.shape[-1], v.shape[-1]],
                         dim=-1), mask, heads)
        qc, kc, vc = (y.cpu() for y in (q, k, v))
        ctx_ref = fa.exp_mhsa_reference(qc, kc, vc, mask, heads)
        refs = fa.exp_mhsa_bwd_reference(qc, kc, vc, mask, g, heads)
        grads = [y.cpu() for y in fa.mhsa_sep_bwd(q, k, v, dmask,
                                                  g.to(DEVICE), heads)]
        again = fa.mhsa_sep_fwd(q, k, v, dmask, heads)
        out0 = card["out"].cpu()
        err = (res[DEVICE][0] - res["cpu"][0]).abs()
        worst = divmod(int(err.argmax()), err.shape[-1])
    return {
        "proj_max_err": (card["qkv_2d"].cpu() - cpu["qkv_2d"]).abs().max()
        .item(),
        "proj_card_vs_f64": (card["qkv_2d"].cpu().double() - exact).abs()
        .max().item(),
        "proj_cpu_vs_f64": (cpu["qkv_2d"].double() - exact).abs().max()
        .item(),
        "ctx_card_vs_f64_proj": (res[DEVICE][0] - ctx_exact).abs().max()
        .item(),
        "ctx_cpu_vs_f64_proj": (res["cpu"][0] - ctx_exact).abs().max()
        .item(),
        "proj_outside": n_outside(card["qkv_2d"].cpu(), cpu["qkv_2d"],
                                  f_rtol, f_atol),
        "rows_5_7_max_err": (out0 - ctx_ref).abs().max().item(),
        "rows_5_7_outside": n_outside(out0, ctx_ref, f_rtol, f_atol),
        "cpu_ctx_vs_plain_on_card_proj": (res["cpu"][0] - ctx_ref).abs()
        .max().item(),
        "rows_6_8_max_err": max((a - b).abs().max().item()
                                for a, b in zip(grads, refs)),
        "rows_6_8_outside": sum(n_outside(a, b, b_rtol, b_atol)
                                for a, b in zip(grads, refs)),
        "out_changed_in_backward": (res[DEVICE][0] - out0).abs().max()
        .item(),
        "fwd_repeats_bits": bool(torch.equal(again, card["out"])),
        "ctx_outside": n_outside(res[DEVICE][0], res["cpu"][0], f_rtol,
                                 f_atol),
        "ctx_worst": {"row": worst[0] // err.shape[1],
                      "pos": worst[0] % err.shape[1], "lane": worst[1],
                      "err": err.max().item()},
        "host": {"cpu_capability": torch.backends.cpu.get_cpu_capability(),
                 "threads": torch.get_num_threads(),
                 "cuda_matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "f32_matmul_precision":
                 torch.get_float32_matmul_precision()}}


def compare(where, name, got, want, rtol, atol):
    """got against want: fails on a non-finite value or an element outside
    atol + rtol * |want|, and unless the same comparison rejects want
    scaled by OFF_SCALE; returns the numbers a kernel case prints
    (tol_share: the largest |got - want| over its allowance)."""
    import torch

    if not torch.isfinite(got.float()).all():
        fail(f"{where}: non-finite {name}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if n_outside(got, want, rtol, atol):
        fail(f"{where}: {name} max |kernel - plain| {err:.3e} over rtol "
             f"{rtol} atol {atol}")
    off = n_outside(got, want.float() * OFF_SCALE, rtol, atol)
    if not off:
        fail(f"{where}: {name}'s comparison passes the plain version "
             f"scaled by {OFF_SCALE}")
    share = (diff / (atol + rtol * want.float().abs())).max().item()
    return {"max_abs_err": err, "tol_share": share,
            "n_differ": n_differ(got, want), "n_elems": got.numel(),
            "max_abs_ref": want.float().abs().max().item(),
            "rtol": rtol, "atol": atol, "off_scale_caught": off}


def rounding_fault(got, fault, base_differ, rtol, atol) -> int:
    """A planted rounding fault that moves bf16 results by less than the
    tolerance is rejected when it differs from the kernel in more than 10x
    as many elements as the plain version does: a kernel that lacked the
    rounding would differ as much. Returns the count that rejects it, or
    0."""
    count = n_differ(got, fault)
    return count if (n_outside(got, fault, rtol, atol)
                     or count > 10 * max(base_differ, 1)) else 0


def check_fwd_regimes(where, fa, n, t, heads, d, dtype, kernels) -> None:
    """Each of rows 1-2's ``kernels`` launched once since the counts were
    reset, in the regime of fwd_launch_plan."""
    want = fa.fwd_launch_plan(n, t, heads, d, dtype).regime
    for k in kernels:
        if fa.regime_counts(k) != {want: 1}:
            fail(f"{where}: {k} launched {fa.regime_counts(k)}, its plan "
                 f"{want}")


def check_bwd_regime(where, fa, kernel, n, t, heads, d, dtype,
                     probs) -> None:
    """Rows 3-4's (or 12's) ``kernel`` launched once since the counts were
    reset, in the regime of bwd_launch_plan (``probs``: row 3's plan)."""
    want = fa.bwd_launch_plan(n, t, heads, d, dtype, probs=probs).regime
    if fa.regime_counts(kernel) != {want: 1}:
        fail(f"{where}: {kernel} launched {fa.regime_counts(kernel)}, its "
             f"plan {want}")


def check_caught(where, caught) -> None:
    for name, count in caught.items():
        if not count:
            fail(f"{where}: a plain version with {name} passed the "
                 "comparison")


def sdpa_bwd(q, k, v, attn_mask, g):
    """The library yardstick of a backward row: scaled_dot_product_attention's
    backward alone on leaves q, k, v (N, H, T, D), the forward run once here,
    outside the timed window; g (N, H, T, D_v). The port never calls it."""
    import torch
    import torch.nn.functional as F

    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def sdpa_bwd_of_qkv(qkv, bias, mask, g, heads):
    """sdpa_bwd on the heads of a fused projection (N, T, 3HD) plus bias
    (or None), the boolean key mask as the forward yardstick takes it."""
    n, t, w3 = qkv.shape
    d = w3 // (3 * heads)
    x = (qkv if bias is None else qkv + bias).view(n, t, 3, heads, d).permute(
        2, 0, 3, 1, 4)
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    return sdpa_bwd(x[0], x[1], x[2], attn_mask,
                    g.view(n, t, heads, d).transpose(1, 2))


def timed(fn, plain, n_bytes, flops, dtype, iters=20, library=None) -> dict:
    """Kernel, plain and (where one PyTorch call computes the same
    function) library times, and the bound: the larger of the bytes over
    the memory rate and the flops over the dtype's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"ms": time_ms(fn, iters), "plain_ms": time_ms(plain, iters),
            "library_ms": None if library is None else time_ms(library,
                                                               iters),
            "bytes": n_bytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def train_setup(cfg, table, seed, device, num_category=0,
                num_subcategory=0):
    """cfg.model's params from ``seed`` around ``table`` (NAML's category
    tables of the given vocabulary sizes) and a train state over them."""
    from newsrecommendation_tpu_torch.models import get_model
    from newsrecommendation_tpu_torch.train import create_train_state

    model = get_model(cfg.model)
    params = model.init(cfg, table, num_category=num_category,
                        num_subcategory=num_subcategory, seed=seed,
                        device=device)
    return model, create_train_state(cfg, params)


def train_check(ctx, user_log_mask, samples="samples", **overrides):
    """One f32 step with dropout off on the card and on the CPU from the
    same params and batch: loss, every leaf's gradient (the word table's
    too when it trains), the frozen table unchanged. ``overrides`` change
    the config (bwd_residuals, freeze_embedding, a long history at a
    reduced width); ``samples`` names the context's samples to batch."""
    import torch

    from newsrecommendation_tpu_torch.train import make_train_step

    cfg = ctx["cfg"].replace(batch_size=16, deterministic=True, lr=3e-4,
                             freeze_embedding=True,
                             user_log_mask=user_log_mask)
    cfg = cfg.replace(**overrides)
    host = next(ctx[samples].iter_batches(ctx["feats"], cfg.batch_size,
                                          epoch=0, seed=0))
    results = {}
    for device in (DEVICE, "cpu"):
        model, state = train_setup(cfg, ctx["table"], 1, device,
                                   *ctx["vocab_sizes"])
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        state, metrics = make_train_step(cfg, model)(state, batch, 0)
        results[device] = (float(metrics["loss"]), state.params)
    (loss, params), (cpu_loss, cpu_params) = results[DEVICE], results["cpu"]
    if not abs(loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss):
        fail(f"train-check: loss {loss} on the card, {cpu_loss} on the CPU")
    table = params["embedding_table"]
    if cfg.freeze_embedding and (table.grad is not None or not torch.equal(
            table.cpu(), torch.from_numpy(ctx["table"]))):
        fail("train-check: the frozen table took a gradient or moved")
    grads = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], path + (key,))
            return
        if (a.grad is None) != (b.grad is None):
            fail(f"train-check: {path} has a gradient on one device only")
        if a.grad is not None:
            grads[path] = (a.grad.cpu(), b.grad)

    walk(params, cpu_params, ())
    if (("embedding_table",) in grads) == cfg.freeze_embedding:
        fail("train-check: the word table's gradient does not follow "
             "freeze_embedding")
    largest = max(g.abs().max().item() for _, g in grads.values())
    floor = TRAIN_GRAD_FLOOR * largest
    worst, under_floor = {}, {}
    for path, (g, cpu_g) in grads.items():
        scale = cpu_g.abs().max().item()
        err = (g - cpu_g).abs().max().item()
        if TRAIN_GRAD_SHARE * scale < floor:
            under_floor["/".join(path)] = [scale, err]
        else:
            worst["/".join(path)] = err / scale
        if not err <= max(TRAIN_GRAD_SHARE * scale, floor):
            fail(f"train-check: {path} gradient differs by {err:.3e}, "
                 f"over {TRAIN_GRAD_SHARE} of its max {scale:.3e} and "
                 f"over {TRAIN_GRAD_FLOOR} of the largest {largest:.3e}")
    return {"loss": loss, "cpu_loss": cpu_loss,
            "worst_grad_share": max(worst.values()),
            "worst_leaf": max(worst, key=worst.get),
            "largest_grad": largest,
            "under_floor_max_and_err": under_floor}


def expected_launches(steps, cfg, attention_io="3d"):
    """Launches per kernel variant of an epoch of ``steps`` train steps
    with user_log_mask off: none for NAML, which has no attention kernel;
    for NRMS the news encoder (20-word titles) and the user encoder each
    run one forward and one backward per step: with fused_tail "on"
    through rows 13-14 (the whole tail, at any length); else, for a
    history of flash_min_seq keys or more, the user encoder through rows
    9-10, and each shorter sequence through rows 15-16 (attention_layout
    "blanes"), rows 11-12 (attention_io "2d"), rows 2-3 ("probs") or rows
    1 and 4 ("recompute")."""
    from newsrecommendation_tpu_torch.ops import kernel_config, kernels

    want = {k: {v: 0 for v in variants}
            for k, variants in kernels.KERNELS.items()}
    if cfg.model == "NAML":
        return want
    if cfg.fused_tail == "on":
        want["fused_tail_fwd"]["tail"] = 2 * steps
        want["fused_tail_bwd"]["tail_bwd"] = 2 * steps
        return want
    fused = 1 + int(cfg.user_log_length < kernel_config.flash_min_seq())
    if cfg.attention_layout == "blanes":
        want["blanes_fwd"]["blanes"] = fused * steps
        want["blanes_bwd"]["blanes_bwd"] = fused * steps
    elif attention_io == "2d":
        want["qkv2d_fwd"]["fwd2d"] = fused * steps
        want["qkv2d_bwd"]["bwd2d"] = fused * steps
    elif cfg.bwd_residuals == "probs":
        want["qkv_fwd_probs"]["bias_probs"] = fused * steps
        want["qkv_bwd_probs"]["bwd_probs"] = fused * steps
    else:
        want["qkv_fwd"]["bias"] = fused * steps
        want["qkv_bwd"]["bwd"] = fused * steps
    if fused == 1:
        want["flash_fwd"]["flash"] = steps
        want["flash_bwd"]["flash_bwd"] = steps
    return want


# Kernels whose launch takes one of several regimes, counted per regime
# (kernels.regime_counts): rows 1, 2, 11 (fwd_launch_plan), 3, 4, 12
# (bwd_launch_plan), 13, 14 (tail_launch_plan) and 9, 10
# (blockwise.launch_plan: "mma", "cuda_core", "wide").
FWD_REGIME_KERNELS = ("qkv_fwd", "qkv_fwd_probs", "qkv2d_fwd")
TAIL_REGIME_KERNELS = {"fused_tail_fwd": "fwd", "fused_tail_bwd": "bwd"}
FLASH_REGIME_KERNELS = ("flash_fwd", "flash_bwd")
REGIME_KERNELS = FWD_REGIME_KERNELS + ("qkv_bwd_probs", "qkv_bwd",
                                       "qkv2d_bwd", *TAIL_REGIME_KERNELS,
                                       *FLASH_REGIME_KERNELS)


def expected_regimes(steps, cfg, attention_io="3d"):
    """Launches per regime of REGIME_KERNELS in an epoch of ``steps``
    train steps (as expected_launches routes them): each launch takes its
    plan's regime at its encoder's length (fwd_launch_plan for rows 1, 2
    and 11, bwd_launch_plan for rows 3, 4 and 12, tail_launch_plan for
    rows 13-14, blockwise.launch_plan for rows 9-10, which run on the user
    encoder alone), the news encoder at num_words_title, the user encoder
    at user_log_length."""
    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import (
        experimental_fused_encoder as fe,
    )
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    want = expected_launches(steps, cfg, attention_io)
    heads = cfg.num_attention_heads
    d = cfg.news_dim // heads
    dtype = torch_dtype(cfg.compute_dtype)
    out = {}
    for k in REGIME_KERNELS:
        n = sum(want[k].values())
        if not n:
            continue
        if k in FLASH_REGIME_KERNELS:
            out[k] = {bw.launch_plan(1, cfg.user_log_length, heads, d,
                                     dtype).regime: n}
            continue
        # one launch per encoder and step; the first is the news encoder
        encoders = [(cfg.num_words_title, cfg.news_query_vector_dim),
                    (cfg.user_log_length, cfg.user_query_vector_dim)]
        for t, q in encoders[:n // steps]:
            if k in TAIL_REGIME_KERNELS:
                regime = fe.tail_launch_plan(TAIL_REGIME_KERNELS[k], 1, t,
                                             heads, d, q, dtype).regime
            elif k in FWD_REGIME_KERNELS:
                regime = fa.fwd_launch_plan(1, t, heads, d, dtype).regime
            else:
                regime = fa.bwd_launch_plan(1, t, heads, d, dtype).regime
            out.setdefault(k, {})
            out[k][regime] = out[k].get(regime, 0) + steps
    return out


def torch_dtype(name):
    import torch

    return getattr(torch, name)


@contextlib.contextmanager
def attention_io(mode):
    """kernel_config's attention_io set to ``mode`` inside, "3d" after: it
    is no Config field, so no entry point sets it."""
    from newsrecommendation_tpu_torch.ops import kernel_config

    kernel_config.set_attention_io(mode)
    try:
        yield
    finally:
        kernel_config.set_attention_io("3d")


def train_run(ctx, fa, samples="samples", fixed_batch=True, max_steps=None,
              io="3d", **overrides):
    """The headline training step through fit(), with launch counts reset
    just before fit and read just after; then, with ``fixed_batch``, 20
    steps on one batch with dropout off. ``overrides`` change the config;
    ``samples`` names the context's samples, ``max_steps`` cuts them to
    that many batches; ``io`` is the attention_io of the run."""
    import torch

    from newsrecommendation_tpu_torch.data.loader import TrainSamples
    from newsrecommendation_tpu_torch.train import fit, make_train_step

    cfg = ctx["cfg"].replace(
        compute_dtype="bfloat16", batch_size=128, npratio=4, lr=3e-4,
        drop_rate=0.2, freeze_embedding=True, device_gather=True,
        prefetch_depth=2, log_steps=10, epochs=1, seed=0,
        deterministic=False)
    cfg = cfg.replace(**overrides)
    samples, feats = ctx[samples], ctx["feats"]
    if max_steps is not None:
        cut = max_steps * cfg.batch_size
        samples = TrainSamples(history=samples.history[:cut],
                               history_mask=samples.history_mask[:cut],
                               pos=samples.pos[:cut], neg=samples.neg[:cut])
    model, state = train_setup(cfg, ctx["table"], 2, DEVICE,
                               *ctx["vocab_sizes"])
    step = make_train_step(cfg, model, device_gather=True)
    losses = []

    def recorded(*args):
        st, metrics = step(*args)
        losses.append(metrics["loss"])  # stays on the card
        return st, metrics

    on_card = DEVICE == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with attention_io(io):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, stats = fit(cfg, model, state, samples, feats,
                           train_step=recorded, device_gather=True)
        float(losses[-1])  # waits for the last step
        wall_s = time.perf_counter() - t0
        launches = {k: fa.launch_counts(k) for k in fa.KERNELS}
        regimes = {k: fa.regime_counts(k) for k in REGIME_KERNELS
                   if fa.regime_counts(k)}
    steps = stats["steps"]
    min_steps = TRAIN_STEPS_MIN if max_steps is None else max_steps
    if steps < min_steps or steps != len(losses):
        fail(f"train: {steps} steps ({len(losses)} recorded), fewer than "
             f"{min_steps}")
    if not torch.isfinite(torch.stack(losses)).all():
        fail("train: a non-finite loss")
    want = expected_launches(steps, cfg, io)
    if launches != want:
        fail(f"train: launches {launches}, expected {want}")
    want = expected_regimes(steps, cfg, io)
    if regimes != want:
        fail(f"train: launches per regime {regimes}, expected {want}")
    ex_s = stats["examples_per_sec"]
    out = {"steps": steps, "samples": samples.num_samples,
           "user_log_length": cfg.user_log_length,
           "bwd_residuals": cfg.bwd_residuals,
           "fused_tail": cfg.fused_tail, "attention_io": io,
           "attention_layout": cfg.attention_layout,
           "freeze_embedding": cfg.freeze_embedding,
           "examples_per_sec": ex_s,
           "step_ms": 1e3 * cfg.batch_size / ex_s if ex_s else None,
           "fit_wall_s": wall_s, "first_loss": float(losses[0]),
           "final_loss": stats["final_loss"],
           "final_acc": stats["final_acc"],
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
               else None,
           "launches": {k: v for k, v in launches.items() if any(v.values())},
           "regimes": regimes}
    if fixed_batch:
        fixed_cfg = cfg.replace(deterministic=True)
        _, fixed = train_setup(fixed_cfg, ctx["table"], 3, DEVICE,
                               *ctx["vocab_sizes"])
        fixed_step = make_train_step(fixed_cfg, model, device_gather=True)
        feats_dev = torch.from_numpy(feats).to(DEVICE)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in next(
            samples.iter_index_batches(cfg.batch_size, epoch=0,
                                       seed=1)).items()}
        fixed_losses = []
        for _ in range(20):
            fixed, metrics = fixed_step(fixed, batch, 0, feats_dev)
            fixed_losses.append(metrics["loss"])
        fixed_losses = [float(x) for x in fixed_losses]
        if not (np.isfinite(fixed_losses).all()
                and fixed_losses[-1] < fixed_losses[0]):
            fail(f"train: fixed-batch loss did not fall: {fixed_losses}")
        out["fixed_batch_loss"] = [fixed_losses[0], fixed_losses[-1]]
    return out, (cfg, model, state, step)


def http_call(port, method, path, payload=None, expect=200):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request(method, path,
                     body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    if resp.status != expect:
        fail(f"{method} {path} -> {resp.status} (expected {expect}): {body}")
    return body, ms


def cpu_scores(model, cpu_params, cfg, feats, news_index, history, cands):
    """Scores of one request from the same params on the CPU, through the
    plain versions, encoding only the news rows the request touches."""
    import torch

    from newsrecommendation_tpu_torch.data.loader import (
        pad_to_fix_len,
        trans_to_nindex,
    )

    hist, mask = pad_to_fix_len(trans_to_nindex(history, news_index),
                                cfg.user_log_length)
    cand = trans_to_nindex(cands, news_index)
    rows = sorted(set(hist) | set(cand) | {0})
    pos = {r: i for i, r in enumerate(rows)}
    with torch.inference_mode():
        vecs = model.news_encoder(cpu_params, cfg,
                                 torch.from_numpy(feats[rows]))
        hv = vecs[[pos[r] for r in hist]][None]
        user = model.user_encoder(cpu_params, cfg, hv,
                                 torch.from_numpy(mask)[None])[0]
        return (vecs[[pos[r] for r in cand]] @ user).numpy()


def check_close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = SERVE_TOL
    err = np.abs(got - want)
    if got.shape != want.shape or not np.isfinite(got).all() or (
            err > atol + rtol * np.abs(want)).any():
        fail(f"{name}: served scores disagree with the CPU plain run "
             f"(max abs err {err.max() if err.size else 'n/a'})")
    return float(err.max())


def serve_run(ctx, user_log_mask, user_log_length=None, **overrides):
    """One serving run: build the Recommender on the card, start the HTTP
    server, answer requests, check some against the CPU. With
    user_log_length, the model takes histories that long (the requests'
    histories are scaled by user_log_length / 50 from the ones of the
    published length); ``overrides`` change the config (fused_tail)."""
    import torch

    from newsrecommendation_tpu_torch.serve import Recommender
    from newsrecommendation_tpu_torch.server import serve

    cfg = ctx["cfg"].replace(user_log_mask=user_log_mask, **overrides)
    hist_scale = 1.0
    if user_log_length is not None:
        cfg = cfg.replace(user_log_length=user_log_length)
        hist_scale = user_log_length / 50
    t0 = time.perf_counter()
    rec = Recommender.from_state(cfg, ctx["params"], ctx["news_index"],
                                 ctx["feats"], device="cuda")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cache = rec.news_scoring[:rec.corpus_size + 1]
    if not torch.isfinite(cache).all() or cache.shape != (NUM_NEWS + 1, 400):
        fail(f"corpus cache {tuple(cache.shape)} not finite or mis-shaped")
    srv = serve(rec, port=0, max_batch=MAX_BATCH, max_delay_ms=2.0)
    port = srv.server_address[1]
    try:
        rng = np.random.default_rng(7 + user_log_mask)
        ids = [f"N{i}" for i in range(1, NUM_NEWS + 1)]

        def request(c, h):
            h = int(h * hist_scale)
            return ([ids[j] for j in rng.integers(0, NUM_NEWS, h)],
                    [ids[j] for j in rng.choice(NUM_NEWS, c, replace=False)])

        lat = {"score": [], "recommend": [], "score_concurrent": []}
        checked = []
        for c, h in [(10, 5), (50, 20), (100, 50), (300, 30), (300, 80)]:
            hist, cands = request(c, h)
            body, ms = http_call(port, "POST", "/score",
                                 {"history": hist, "candidates": cands})
            lat["score"].append(ms)
            if len(body["scores"]) != c or len(body["ranked"]) != c:
                fail(f"/score returned {len(body['scores'])} of {c} scores")
            if c == 300 and len(checked) < 1:
                checked.append(check_close(
                    "/score", body["scores"], cpu_scores(
                        ctx["model"], ctx["cpu_params"], cfg, ctx["feats"],
                        ctx["news_index"], hist, cands)))
        # concurrent requests coalesce into one padded MAX_BATCH batch
        reqs = [request(100, 40) for _ in range(16)]
        results = [None] * len(reqs)

        def worker(i):
            results[i] = http_call(port, "POST", "/score",
                                   {"history": reqs[i][0],
                                    "candidates": reqs[i][1]})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        if any(th.is_alive() for th in threads) or None in results:
            fail("concurrent /score requests did not all complete")
        lat["score_concurrent"] = [ms for _, ms in results]
        checked.append(check_close(
            "/score (batched)", results[3][0]["scores"], cpu_scores(
                ctx["model"], ctx["cpu_params"], cfg, ctx["feats"],
                ctx["news_index"], *reqs[3])))
        for h in (3, 25, 60):
            hist, _ = request(1, h)
            body, ms = http_call(port, "POST", "/recommend",
                                 {"history": hist, "k": 10})
            lat["recommend"].append(ms)
            if len(body["doc_ids"]) != 10 or len(set(body["doc_ids"])) != 10:
                fail(f"/recommend returned {body['doc_ids']}")
            got = np.asarray(body["scores"])
            if (np.diff(got) > 0).any():
                fail("/recommend scores are not in descending order")
            checked.append(check_close(
                "/recommend", got, cpu_scores(
                    ctx["model"], ctx["cpu_params"], cfg, ctx["feats"],
                    ctx["news_index"], hist, body["doc_ids"])))
        health, _ = http_call(port, "GET", "/healthz")
        stats, _ = http_call(port, "GET", "/stats")
        if health["corpus_size"] != NUM_NEWS or stats["errors"] != 0:
            fail(f"healthz {health} stats {stats}")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
    return {"encode_s": encode_s, "latency_ms": lat,
            "max_abs_err_vs_cpu": max(checked), "stats": stats}, rec


def cli_corpus(root):
    """Synthetic MIND-format train and dev dirs under ``root`` for the cli
    phase. The train dir keeps the longest head of its CLI_TRAIN_IMPRESSIONS
    impressions whose training samples (one per click of an impression
    with a click and a skip, as prepare_training_data makes them) fill
    3k+1 batches of 128. Returns (train_dir, dev_dir, steps)."""
    from newsrecommendation_tpu_torch.data.synthetic import generate_corpus

    train_dir, dev_dir = (os.path.join(root, d) for d in ("train", "dev"))
    generate_corpus(dev_dir, num_news=CLI_NEWS, num_users=200,
                    num_impressions=CLI_DEV_IMPRESSIONS, title_len=20,
                    max_history=80,
                    candidates_per_impression=CLI_CANDIDATES, seed=2,
                    split="dev")
    generate_corpus(train_dir, num_news=CLI_NEWS, num_users=200,
                    num_impressions=CLI_TRAIN_IMPRESSIONS, title_len=20,
                    max_history=80, seed=1)
    path = os.path.join(train_dir, "behaviors.tsv")
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    samples = 0
    keep = steps = None
    for i, line in enumerate(lines):
        labels = [x.rsplit("-", 1)[1] for x in line.split("\t")[4].split()]
        if "0" in labels and "1" in labels:
            samples += labels.count("1")
        if samples > 3 * 128 and -(-samples // 128) % 3 == 1:
            keep, steps = i + 1, -(-samples // 128)
    if keep is None:
        fail("cli: no head of the impressions gives 3k+1 > 1 steps")
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(lines[:keep])
    return train_dir, dev_dir, steps


def eval_line(model_dir, index=-1):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    evals = [x for x in lines if x["kind"] == "eval"]
    return evals[index] if evals else None, lines


def cli_logging():
    """The CLI's log on stderr, stdout kept short."""
    import logging

    root = logging.getLogger()
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
        root.addHandler(handler)


def reset_parses() -> None:
    from newsrecommendation_tpu_torch.data import native_loader

    native_loader.reset_parser_counts()


def check_native_parses(where, want) -> dict:
    """Fail unless the behaviors parses since reset_parses() were ``want``
    parses, every one by the native parser."""
    from newsrecommendation_tpu_torch.data import native_loader

    got = native_loader.parser_counts()
    if got != {"native": want, "python": 0}:
        fail(f"{where}: behaviors parses {got}; expected {want}, every one "
             f"by the native parser")
    return got


def native_parse_run(card) -> dict:
    """The port's native behaviors parser on the card's host: built with
    g++ (fail if it cannot be); then a prepared train shard of at least
    PARSE_TRAIN_MB and a raw dev shard of at least PARSE_DEV_MB, cli_corpus's
    files repeated, parsed at L = 50, K = 4, C = 384 by the native and the
    Python parser, whose arrays must be equal in every element and
    dtype. Both parsers read files this process just wrote (warm page
    cache)."""
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.data import (
        EvalSamples,
        TrainSamples,
        native_loader,
        prepare_testing_data,
        prepare_training_data,
        read_news,
    )

    t = time.perf_counter()
    if not native_loader.available():
        fail("native-parse: the native parser did not build (the warning "
             "above says why)")
    out = {"card": card, "build_s": native_loader.build_seconds,
           "build_and_load_s": time.perf_counter() - t,
           "so": os.path.relpath(native_loader.so_path())}
    cfg = Config(user_log_length=50, npratio=4, max_candidates=384)
    keys = {"train": ("history", "history_mask", "pos", "neg"),
            "eval": ("history", "history_mask", "candidates", "labels",
                     "candidate_mask")}
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, dev_dir, _ = cli_corpus(tmp)
        prepare_training_data(train_dir, 1, cfg.npratio, 0)
        prepare_testing_data(dev_dir, 1)
        reset_parses()
        for kind, d, name, mb in (
                ("train", train_dir, f"behaviors_np{cfg.npratio}_0.tsv",
                 PARSE_TRAIN_MB),
                ("eval", dev_dir, "behaviors_0.tsv", PARSE_DEV_MB)):
            with open(os.path.join(d, name), "rb") as f:
                chunk = f.read()
            path = os.path.join(tmp, f"{kind}_big.tsv")
            with open(path, "wb") as f:
                f.write(chunk * -(-mb * 10 ** 6 // len(chunk)))
            del chunk
            index = read_news(os.path.join(d, "news.tsv"), cfg).news_index
            parsed, secs = {}, {}
            for parser in ("native", "python"):
                t0 = time.perf_counter()
                if kind == "train":
                    parsed[parser] = TrainSamples.from_file(
                        path, index, cfg, use_native=parser == "native")
                else:
                    parsed[parser] = EvalSamples.from_file(
                        path, index, cfg, max_candidates=cfg.max_candidates,
                        use_native=parser == "native")
                secs[parser] = time.perf_counter() - t0
            for k in keys[kind]:
                a, b = (getattr(parsed[p], k) for p in ("native", "python"))
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f"native-parse {kind}: {k} differs between the "
                         f"parsers ({a.dtype} {a.shape}, {b.dtype} "
                         f"{b.shape})")
            size = os.path.getsize(path) / 1e6
            out[kind] = {
                "mb": size, "rows": parsed["native"].num_samples,
                "native_s": secs["native"], "python_s": secs["python"],
                "native_mb_per_s": size / secs["native"],
                "python_mb_per_s": size / secs["python"],
                "speedup": secs["python"] / secs["native"]}
            del parsed
            os.remove(path)
        if native_loader.parser_counts() != {"native": 2, "python": 2}:
            fail(f"native-parse: parses {native_loader.parser_counts()}")
    return out


def timed_evaluate(real_eval, timed):
    """``real_eval`` (cli.evaluate_impressions) timed on the host clock
    from a synchronised device: each call appends (seconds, impressions)
    to ``timed``."""
    import torch

    def evaluate(*args, **kw):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_eval(*args, **kw)
        timed.append((time.perf_counter() - t0, res["samples_seen"]))
        return res

    return evaluate


def cli_requests(seed):
    """Three /score requests of 30 history and 60 candidate news of the
    cli corpus."""
    rng = np.random.default_rng(seed)
    ids = [f"N{i}" for i in rng.permutation(CLI_NEWS)[:400] + 1]
    return [(ids[i:i + 30], ids[100 + 3 * i:160 + 3 * i])
            for i in range(0, 60, 20)]


def served_err_vs_cpu(srv, scfg, ckpt, data_dir, reqs, label):
    """The largest difference of ``srv``'s /score answers from a CPU
    Recommender on checkpoint ``ckpt`` (check_close fails past
    SERVE_TOL)."""
    from newsrecommendation_tpu_torch.serve import Recommender

    cpu = Recommender.from_checkpoint(ckpt, scfg, data_dir, device="cpu")
    errs = []
    for hist, cands in reqs:
        body, _ = http_call(srv.server_address[1], "POST", "/score",
                            {"history": hist, "candidates": cands})
        errs.append(check_close(f"{label} /score", body["scores"],
                                cpu.score(hist, cands)))
    return max(errs)


def cli_run(fa, card) -> dict:
    """The command-line path at NRMS's published width on the card:
    train_test through cli.main (bf16, B = 128, user_log_mask on, a third
    of the epoch between saves), the newest checkpoint loaded back bit for
    bit, --mode test from it (the same eval line), again with the fused
    tail (row 13), then run_server from the newest checkpoint, a second
    epoch resumed from it, POST /reload (200, then 409 with a reload in
    flight), each served answer held against a CPU Recommender on the
    checkpoint's params. Launch counts are reset just before each main
    call and read just after."""
    import torch

    from newsrecommendation_tpu_torch import cli
    from newsrecommendation_tpu_torch.ckpt import (
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from newsrecommendation_tpu_torch.config import Config, config_from_args
    from newsrecommendation_tpu_torch.data import read_news
    from newsrecommendation_tpu_torch.models import get_model
    from newsrecommendation_tpu_torch.ops import kernel_config
    from newsrecommendation_tpu_torch.server import run_server

    cli_logging()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        train_dir, dev_dir, steps = cli_corpus(tmp)
        save_steps = (steps - 1) // 3
        model_dir = os.path.join(tmp, "model")
        dirs = ["--train_data_dir", train_dir, "--test_data_dir", dev_dir,
                "--model_dir", model_dir, "--user_log_mask", "True"
                ] + ONE_CARD + CLI_FLAGS
        train_argv = dirs + ["--compute_dtype", "bfloat16", "--batch_size",
                             "128", "--save_steps", str(save_steps),
                             "--lr", "3e-4", "--log_steps", "10"]
        out["corpus_s"] = time.perf_counter() - t
        out["steps"], out["save_steps"] = steps, save_steps

        # ---- train_test ---------------------------------------------------
        captured, timed_eval = {}, []
        real_train = cli.run_train
        evaluate = timed_evaluate(cli.evaluate_impressions, timed_eval)

        def run_train(cfg, **kw):
            captured["train"] = real_train(cfg, **kw)
            return captured["train"]

        def sync():
            if DEVICE == "cuda":
                torch.cuda.synchronize()

        t = time.perf_counter()
        fa.reset_launch_counts()
        reset_parses()
        with mock.patch.multiple(cli, run_train=run_train,
                                 evaluate_impressions=evaluate):
            cli.main(["--mode", "train_test"] + train_argv, device=DEVICE)
        launches = {k: fa.launch_counts(k) for k in fa.KERNELS}
        regimes = {k: fa.regime_counts(k) for k in REGIME_KERNELS
                   if fa.regime_counts(k)}
        out["train_test_s"] = time.perf_counter() - t
        out["parses"] = check_native_parses("cli train_test", 2)
        state, _, stats = captured["train"]
        first, lines = eval_line(model_dir)
        summary = [x for x in lines if x["kind"] == "train_summary"]
        names = sorted(f for f in os.listdir(model_dir)
                       if f.endswith(".ckpt"))
        want_names = sorted([f"epoch-1-{save_steps * i}.ckpt"
                             for i in (1, 2, 3)] + ["epoch-1.ckpt"])
        if stats["steps"] != steps or names != want_names:
            fail(f"cli train_test: {stats['steps']} steps of {steps}, "
                 f"checkpoints {names}, expected {want_names}")
        if (not [x for x in lines if x["kind"] == "train"] or not summary
                or first is None or len([x for x in lines
                                         if x["kind"] == "eval"]) != 1
                or not all(np.isfinite(first[k]) and 0 < first[k] <= 100
                           for k in ("auc", "mrr", "ndcg5", "ndcg10"))):
            fail(f"cli train_test: metrics.jsonl holds {lines}")
        tcfg = config_from_args(["--mode", "train_test"] + train_argv)
        want = expected_launches(steps, tcfg)
        want["qkv_fwd_probs"] = {"bias_probs": steps,
                                 "bias_masked_probs": steps}
        row1 = launches.pop("qkv_fwd")
        want.pop("qkv_fwd")
        if launches != want or min(row1.values()) < 1:
            fail(f"cli train_test: launches {launches}, row 1 {row1}; "
                 f"expected {want} and row 1 in the test, both variants")
        want_regimes = expected_regimes(steps, tcfg)
        regimes.pop("qkv_fwd", None)
        want_regimes.pop("qkv_fwd", None)
        if regimes != want_regimes:
            fail(f"cli train_test: regimes {regimes}, expected "
                 f"{want_regimes}")
        out.update(train_examples_per_sec=summary[0]["examples_per_sec"],
                   train_final_loss=summary[0]["final_loss"],
                   eval_line=first, launches={
                       "qkv_fwd": row1, "qkv_fwd_probs":
                           launches["qkv_fwd_probs"],
                       "qkv_bwd_probs": launches["qkv_bwd_probs"]})

        # ---- the newest checkpoint, loaded back -----------------------------
        newest = latest_checkpoint(model_dir)
        if not newest.endswith(f"epoch-1-{steps - 1}.ckpt"):
            fail(f"cli: newest checkpoint {newest}")
        corpus = read_news(os.path.join(train_dir, "news.tsv"), tcfg)
        table = cli.build_embedding_table(tcfg, train_dir, corpus)
        fresh = cli.init_state(tcfg, get_model("NRMS"), table, DEVICE)
        sync()
        t = time.perf_counter()
        loaded, _ = load_checkpoint(newest, fresh, tcfg)
        sync()
        out["load_s"] = time.perf_counter() - t
        if loaded.step != state.step:
            fail(f"cli: loaded step {loaded.step}, live {state.step}")
        for (path, a), (_, b) in zip(param_leaves(loaded.params),
                                     param_leaves(state.params)):
            if a.device != b.device or not torch.equal(a, b):
                fail(f"cli: loaded param {path} differs from the live one")
            sa = loaded.optimizer.state.get(a, {})
            sb = state.optimizer.state.get(b, {})
            if set(sa) != set(sb):
                fail(f"cli: Adam state of {path}: {set(sa)} loaded, "
                     f"{set(sb)} live")
            for key in sb:
                if not torch.equal(sa[key].cpu(), sb[key].cpu()):
                    fail(f"cli: loaded Adam {key} of {path} differs")
        t = time.perf_counter()
        path = save_checkpoint(tmp, "save-timing.ckpt", state, tcfg)
        out["save_s"] = time.perf_counter() - t
        out["checkpoint_mb"] = os.path.getsize(newest) / 2 ** 20
        os.remove(path)

        # ---- --mode test from the newest checkpoint -------------------------
        test_argv = ["--mode", "test", "--load_ckpt_name", "latest"]
        for route, extra in (("default", []), ("fused_tail", [
                "--fused_tail", "on"])):
            t = time.perf_counter()
            timed_eval.clear()
            fa.reset_launch_counts()
            reset_parses()
            with mock.patch.object(cli, "evaluate_impressions", evaluate):
                cli.main(test_argv + train_argv + extra, device=DEVICE)
            check_native_parses(f"cli test {route}", 1)
            got = {k: fa.launch_counts(k) for k in fa.KERNELS
                   if any(fa.launch_counts(k).values())}
            line, _ = eval_line(model_dir)
            s_eval, n_eval = timed_eval[0]
            out[f"test_{route}"] = {
                "s": time.perf_counter() - t, "eval_line": line,
                "eval_impressions_per_sec": n_eval / s_eval,
                "launches": got}
            keys = ("auc", "mrr", "ndcg5", "ndcg10")
            if route == "default":
                if (set(got) != {"qkv_fwd"} or min(got["qkv_fwd"].values())
                        < 1 or any(line[k] != first[k] for k in keys)):
                    fail(f"cli test from {newest}: {line} with launches "
                         f"{got}; train_test gave {first}")
            elif (set(got) != {"fused_tail_fwd"}
                  or min(got["fused_tail_fwd"].values()) < 1
                  or any(abs(line[k] - first[k]) / 100 > CLI_ROUTE_TOL
                         for k in keys)):
                fail(f"cli test, fused tail: {line} with launches {got}; "
                     f"the default route gave {first}")
        kernel_config.apply(Config())

        # ---- serve from the newest checkpoint, then /reload -----------------
        scfg = config_from_args(["--mode", "serve", "--serve_port", "0",
                                 "--load_ckpt_name", "latest",
                                 "--serve_max_batch", str(MAX_BATCH),
                                 "--serve_max_delay_ms", "2"] + dirs)
        reqs = cli_requests(5)

        def check(srv, ckpt, label):
            return served_err_vs_cpu(srv, scfg, ckpt, dev_dir, reqs,
                                     f"cli {label}")

        t = time.perf_counter()
        srv = run_server(scfg, block=False, device=DEVICE)
        try:
            port = srv.server_address[1]
            out["serve_start_s"] = time.perf_counter() - t
            out["serve_err_vs_cpu"] = check(srv, newest, "before /reload")
            t = time.perf_counter()
            reset_parses()
            cli.main(["--mode", "train", "--epochs", "2", "--start_epoch",
                      "1", "--load_ckpt_name", "latest", "--prepare",
                      "False"] + train_argv, device=DEVICE)
            out["resume_train_s"] = time.perf_counter() - t
            check_native_parses("cli resumed train", 1)
            kernel_config.apply(Config())
            newer = latest_checkpoint(model_dir)
            if not newer.endswith(f"epoch-2-{steps - 1}.ckpt"):
                fail(f"cli: after the resumed epoch the newest is {newer}")
            t = time.perf_counter()
            body, _ = http_call(port, "POST", "/reload", {})
            out["reload_s"] = time.perf_counter() - t
            if body.get("status") != "reloaded":
                fail(f"cli /reload: {body}")
            out["reload_err_vs_cpu"] = check(srv, newer, "after /reload")
            if not srv.reload_lock.acquire(blocking=False):
                fail("cli: the reload lock is held with no reload running")
            try:
                http_call(port, "POST", "/reload", {}, expect=409)
            finally:
                srv.reload_lock.release()
            stats, _ = http_call(port, "GET", "/stats")
            if stats["errors"]:
                fail(f"cli serve: {stats}")
        finally:
            srv.shutdown()
            srv.server_close()
            srv.batcher.close()
    return out


def naml_config(cfg):
    """NAML at the JAX benchmark's width (bench.py:381-388 with
    ``model="NAML", use_category=True, use_subcategory=True``): the NRMS
    config's T = 20, L = 50, 300-d words, 400-d news, 200-d queries, and
    both category views (100-d)."""
    return cfg.replace(model="NAML", use_category=True, use_subcategory=True)


def naml_context(ctx, corpus, nrms_corpus):
    """The NAML phases' context beside NRMS's ``ctx``: the same news,
    samples and word table; features with the category columns of
    ``corpus`` (the news of ``nrms_corpus`` read with the views on);
    full-width NAML params from a seed on the card and their CPU copy."""
    from newsrecommendation_tpu_torch.data import build_news_features
    from newsrecommendation_tpu_torch.models import naml
    from newsrecommendation_tpu_torch.utils import to_device

    cfg = naml_config(ctx["cfg"])
    if corpus.word_dict != nrms_corpus.word_dict or (
            corpus.news_index != nrms_corpus.news_index):
        fail("naml: the corpus read with category views has other words "
             "or news")
    sizes = (len(corpus.category_dict), len(corpus.subcategory_dict))
    feats = build_news_features(corpus, cfg)
    params = naml.init(cfg, ctx["table"], num_category=sizes[0],
                       num_subcategory=sizes[1], seed=0, device=DEVICE)
    return dict(ctx, cfg=cfg, feats=feats, params=params, model=naml,
                vocab_sizes=sizes, cpu_params=to_device(params, "cpu"))


def doc_table_context(ctx):
    """``ctx`` (NAML) with title_source "doc_table": one doc-pointer
    column and a frozen (num_news+1, T * 300) per-title table whose row i
    is title i's word vectors, so both formats give one title tensor."""
    cfg = ctx["cfg"].replace(title_source="doc_table")
    t = cfg.num_words_title
    table = ctx["table"][ctx["feats"][:, :t]].reshape(len(ctx["feats"]), -1)
    feats = np.concatenate([np.arange(len(ctx["feats"]), dtype=np.int32)[
        :, None], ctx["feats"][:, t:]], axis=1)
    return dict(ctx, cfg=cfg, feats=feats, table=table)


def naml_phases(ctx, fa) -> dict:
    """naml-train-check, naml-train and naml-serve: NAML at the JAX
    benchmark's width on the smoke's corpus, launching no kernel. Returns
    the runs (train states and the served Recommender for the profile)."""
    out = {}
    checks = [("word_ids", {"user_log_mask": False}),
              ("word_ids", {"user_log_mask": True}),
              ("word_ids", {"user_log_mask": False,
                            "freeze_embedding": False}),
              ("doc_table", {"user_log_mask": False}),
              ("doc_table", {"user_log_mask": True})]
    doc_ctx = None
    for title_source, kw in checks:
        t = time.perf_counter()
        if title_source == "doc_table" and doc_ctx is None:
            doc_ctx = doc_table_context(ctx)
        fa.reset_launch_counts()
        res = train_check(ctx if title_source == "word_ids" else doc_ctx,
                          **kw)
        check_no_launch(fa, f"naml-train-check {title_source} {kw}")
        label = " ".join(f"{k}={v}" for k, v in kw.items())
        phase(f"naml-train-check title_source={title_source} {label}", t,
              **{k: json.dumps(v) for k, v in res.items()})
    del doc_ctx
    for name, kw in (("naml", {}),
                     ("naml_trainable", {"freeze_embedding": False,
                                         "fixed_batch": False})):
        t = time.perf_counter()
        out[name] = train_run(ctx, fa, **kw)  # zero launches expected
        phase(f"naml-train {name}", t,
              **{k: json.dumps(v) for k, v in out[name][0].items()})
    for user_log_mask in (False, True):
        t = time.perf_counter()
        fa.reset_launch_counts()
        res, out["rec"] = serve_run(ctx, user_log_mask)
        check_no_launch(fa, f"naml-serve user_log_mask={user_log_mask}")
        phase(f"naml-serve user_log_mask={user_log_mask}", t,
              **{k: json.dumps(v) for k, v in res.items()})
    return out


def check_no_launch(fa, where):
    got = {k: fa.launch_counts(k) for k in fa.KERNELS
           if any(fa.launch_counts(k).values())}
    if got:
        fail(f"{where}: NAML launched kernels {got}")


def naml_cli_run(fa, card) -> dict:
    """NAML through the command line on the card, the fork's demo flags
    (examples/demo.sh:15-19) at the published width: --mode
    create_embeddings with the hash backend on both dirs of cli_corpus,
    train_test for one epoch (bf16, B = 128), --mode test from the newest
    checkpoint (the same eval line), serve from it (f32) with /score
    against a CPU Recommender, a second epoch resumed through the CLI,
    POST /reload, /score again. No kernel launches in any of it."""
    from newsrecommendation_tpu_torch import cli
    from newsrecommendation_tpu_torch.ckpt import latest_checkpoint
    from newsrecommendation_tpu_torch.config import Config, config_from_args
    from newsrecommendation_tpu_torch.ops import kernel_config
    from newsrecommendation_tpu_torch.server import run_server

    cli_logging()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        train_dir, dev_dir, steps = cli_corpus(tmp)
        model_dir = os.path.join(tmp, "naml")
        dirs = ["--train_data_dir", train_dir, "--test_data_dir", dev_dir,
                "--model_dir", model_dir, "--model", "NAML",
                "--title_source", "doc_table", "--use_category", "True",
                "--use_subcategory", "True", "--freeze_embedding", "True",
                "--user_log_mask", "False", "--embedding_backend", "hash"
                ] + ONE_CARD + CLI_FLAGS
        train_argv = dirs + ["--compute_dtype", "bfloat16", "--batch_size",
                             "128", "--lr", "3e-4", "--log_steps", "10"]
        out["corpus_s"] = time.perf_counter() - t
        t = time.perf_counter()
        fa.reset_launch_counts()
        cli.main(["--mode", "create_embeddings"] + dirs, device=DEVICE)
        out["create_embeddings_s"] = time.perf_counter() - t

        timed_eval = []
        evaluate = timed_evaluate(cli.evaluate_impressions, timed_eval)

        t = time.perf_counter()
        reset_parses()
        with mock.patch.object(cli, "evaluate_impressions", evaluate):
            cli.main(["--mode", "train_test"] + train_argv, device=DEVICE)
        out["train_test_s"] = time.perf_counter() - t
        out["parses"] = check_native_parses("naml-cli train_test", 2)
        check_no_launch(fa, "naml-cli train_test")
        line, lines = eval_line(model_dir)
        summary = [x for x in lines if x["kind"] == "train_summary"]
        if (line is None or not summary or summary[0]["steps"] != steps
                or not all(np.isfinite(line[k]) and 0 < line[k] <= 100
                           for k in ("auc", "mrr", "ndcg5", "ndcg10"))):
            fail(f"naml-cli train_test: {steps} steps expected; "
                 f"metrics.jsonl holds {lines}")
        s_eval, n_eval = timed_eval[0]
        out.update(steps=steps, eval_line=line,
                   eval_impressions_per_sec=n_eval / s_eval,
                   train_examples_per_sec=summary[0]["examples_per_sec"],
                   train_final_loss=summary[0]["final_loss"])
        newest = latest_checkpoint(model_dir)
        if not newest.endswith("epoch-1.ckpt"):
            fail(f"naml-cli: newest checkpoint {newest}")
        t = time.perf_counter()
        timed_eval.clear()
        reset_parses()
        with mock.patch.object(cli, "evaluate_impressions", evaluate):
            cli.main(["--mode", "test", "--load_ckpt_name", "latest"]
                     + train_argv, device=DEVICE)
        check_native_parses("naml-cli test", 1)
        again, _ = eval_line(model_dir)
        if any(again[k] != line[k] for k in ("auc", "mrr", "ndcg5",
                                             "ndcg10")):
            fail(f"naml-cli test from {newest}: {again}; train_test gave "
                 f"{line}")
        s_eval, n_eval = timed_eval[0]
        out.update(test_s=time.perf_counter() - t,
                   test_eval_impressions_per_sec=n_eval / s_eval)
        kernel_config.apply(Config())

        scfg = config_from_args(["--mode", "serve", "--serve_port", "0",
                                 "--load_ckpt_name", "latest",
                                 "--serve_max_batch", str(MAX_BATCH),
                                 "--serve_max_delay_ms", "2"] + dirs)
        reqs = cli_requests(6)

        def check(srv, ckpt, label):
            return served_err_vs_cpu(srv, scfg, ckpt, dev_dir, reqs,
                                     f"naml-cli {label}")

        t = time.perf_counter()
        srv = run_server(scfg, block=False, device=DEVICE)
        try:
            out["serve_start_s"] = time.perf_counter() - t
            out["serve_err_vs_cpu"] = check(srv, newest, "before /reload")
            t = time.perf_counter()
            reset_parses()
            cli.main(["--mode", "train", "--epochs", "2", "--start_epoch",
                      "1", "--load_ckpt_name", "latest", "--prepare",
                      "False"] + train_argv, device=DEVICE)
            out["resume_train_s"] = time.perf_counter() - t
            check_native_parses("naml-cli resumed train", 1)
            kernel_config.apply(Config())
            newer = latest_checkpoint(model_dir)
            if not newer.endswith("epoch-2.ckpt"):
                fail(f"naml-cli: after the resumed epoch the newest is "
                     f"{newer}")
            t = time.perf_counter()
            body, _ = http_call(srv.server_address[1], "POST", "/reload",
                                {})
            out["reload_s"] = time.perf_counter() - t
            if body.get("status") != "reloaded":
                fail(f"naml-cli /reload: {body}")
            out["reload_err_vs_cpu"] = check(srv, newer, "after /reload")
            stats, _ = http_call(srv.server_address[1], "GET", "/stats")
            if stats["errors"]:
                fail(f"naml-cli serve: {stats}")
        finally:
            srv.shutdown()
            srv.server_close()
            srv.batcher.close()
        check_no_launch(fa, "naml-cli")
    return out


def param_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from param_leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


# ---- data parallelism and row-sharded tables ------------------------------

DDP_ROWS = 64  # rows each rank takes in the ddp-gloo phases
DDP_TIME_STEPS = 3  # timed steps after each check step
DDP_BF16_STEPS = 8  # bf16 steps of ddp-nccl-1
DDP_LEAF_TOL = (1e-4, 1e-6)  # every updated leaf (tests/test_sharding.py)
DDP_EVAL_IMPRESSIONS = 2048
DDP_EVAL_CANDIDATES = 40
DDP_CLI_TOL = 1e-3  # two-rank eval line vs one process: percentage points
DDP_TIMEOUT_S = 300  # every collective of the ddp phases


def ddp_state_of(state, metrics) -> dict:
    """Loss, accuracy, every leaf and its gradient of a state after one
    step, on the host."""
    return {"loss": float(metrics["loss"]), "acc": float(metrics["acc"]),
            "params": {k: v.detach().cpu().clone() for k, v in
                       param_leaves(state.params)},
            "grads": {k: v.grad.detach().cpu().clone() for k, v in
                      param_leaves(state.params) if v.grad is not None}}


def ddp_sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ddp_reference(cfg, table, host):
    """The single-process card step (dropout off) on ``host``."""
    import torch

    from newsrecommendation_tpu_torch.train import make_train_step

    model, state = train_setup(cfg, table, 1, DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    state, metrics = make_train_step(cfg, model)(state, batch, 0)
    return ddp_state_of(state, metrics)


def ddp_compare(where, want, got, lr) -> dict:
    """A data-parallel step held to the single-process one: loss and
    accuracy within rel 1e-5; each gradient within TRAIN_GRAD_SHARE of
    its largest element (or TRAIN_GRAD_FLOOR of the largest of all), as
    train-check holds the card to the CPU; every updated leaf within
    DDP_LEAF_TOL. Adam's first step moves an element by lr g / (|g| +
    eps), so a gradient element off by a share r of itself moves the
    update by up to 2 r lr (2 lr at most, where the signs differ): an
    element whose gradient is at the level of the summation noise passes
    the leaf check within that bound, and is counted."""
    import torch

    if not abs(got["loss"] - want["loss"]) <= TRAIN_LOSS_RTOL * abs(
            want["loss"]):
        fail(f"{where}: loss {got['loss']}, single process {want['loss']}")
    if not abs(got["acc"] - want["acc"]) <= 1e-5 * abs(want["acc"]):
        fail(f"{where}: acc {got['acc']}, single process {want['acc']}")
    if set(got["grads"]) != set(want["grads"]):
        fail(f"{where}: gradients of {sorted(got['grads'])}, single "
             f"process {sorted(want['grads'])}")
    largest = max(g.abs().max().item() for g in want["grads"].values())
    worst, noise = 0.0, 0
    rtol, atol = DDP_LEAF_TOL
    for key, w in want["params"].items():
        gw, gg = want["grads"].get(key), got["grads"].get(key)
        if gw is not None:
            scale = gw.abs().max().item()
            err = (gg - gw).abs().max().item()
            if not err <= max(TRAIN_GRAD_SHARE * scale,
                              TRAIN_GRAD_FLOOR * largest):
                fail(f"{where}: {key} gradient differs by {err:.3e} "
                     f"(max {scale:.3e})")
            worst = max(worst, err / max(scale, 1e-30))
        diff = (got["params"][key] - w).abs()
        bad = ~(diff <= atol + rtol * w.abs())
        if not bad.any():
            continue
        if gw is None:
            fail(f"{where}: {key} (no gradient) differs by "
                 f"{diff.max().item():.3e}")
        share = (gg - gw).abs() / gw.abs()  # inf where gw is 0
        bound = atol + rtol * w.abs() + lr * torch.clamp(2 * share, max=2.0)
        if (diff[bad] > bound[bad] * (1 + 1e-3)).any():
            fail(f"{where}: {key} differs by {diff.max().item():.3e} in "
                 f"{int(bad.sum())} elements")
        noise += int(bad.sum())
    return {"loss": got["loss"], "single_loss": want["loss"],
            "worst_grad_share": worst, "noise_elements": noise}


def ddp_timed_steps(step, state, batches, device, feats=()) -> tuple:
    """(state, losses, ms a step) over ``batches``: the wall time of all
    but the first (not timed), from a synchronised device to one."""
    losses = []
    state, m = step(state, batches[0], 0, *feats)
    losses.append(float(m["loss"]))
    ddp_sync(device)
    t = time.perf_counter()
    outs = []
    for b in batches[1:]:
        state, m = step(state, b, 0, *feats)
        outs.append(m["loss"])
    ddp_sync(device)
    ms = (time.perf_counter() - t) * 1e3 / max(len(batches) - 1, 1)
    return state, losses + [float(x) for x in outs], ms


def ddp_launched(fa) -> dict:
    return {k: sum(fa.launch_counts(k).values()) for k in fa.KERNELS
            if sum(fa.launch_counts(k).values())}


def ddp_nccl_one(ctx, fa, tmp, device) -> dict:
    """An NCCL group of one rank on cuda:0: the spmd step (its collectives
    issued, not the one-rank shortcut) at the headline width, in f32
    against the plain step, then DDP_BF16_STEPS bf16 steps. (gloo on the
    CPU, for a rehearsal.)"""
    import datetime

    import torch
    import torch.distributed as dist

    from newsrecommendation_tpu_torch.parallel import make_mesh
    from newsrecommendation_tpu_torch.parallel.spmd import (
        make_spmd_train_step,
        place_state,
    )

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/nccl_init", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))
    try:
        cfg = ctx["cfg"].replace(batch_size=2 * DDP_ROWS, deterministic=True,
                                 lr=3e-4, freeze_embedding=True)
        mesh = make_mesh(cfg, device=device)
        if mesh.trivial or dist.get_backend() != backend:
            fail(f"ddp-nccl-1: the mesh has no {backend} group")
        host = next(ctx["samples"].iter_batches(
            ctx["feats"], cfg.batch_size, epoch=0, seed=0))
        want = ddp_reference(cfg, ctx["table"], host)
        model, state = train_setup(cfg, ctx["table"], 1, DEVICE)
        state = place_state(state, cfg, mesh)
        batch = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in host.items()}
        fa.reset_launch_counts()
        state, metrics = make_spmd_train_step(cfg, model, mesh)(
            state, batch, 0)
        out = {"f32": ddp_compare("ddp-nccl-1 f32", want,
                                  ddp_state_of(state, metrics), cfg.lr),
               "f32_launches": ddp_launched(fa)}
        if out["f32_launches"] != {"qkv_fwd_probs": 2, "qkv_bwd_probs": 2}:
            fail(f"ddp-nccl-1: launches {out['f32_launches']}, expected "
                 "rows 2-3 twice each")
        bcfg = ctx["cfg"].replace(batch_size=2 * DDP_ROWS,
                                  compute_dtype="bfloat16", lr=3e-4,
                                  freeze_embedding=True)
        model, state = train_setup(bcfg, ctx["table"], 1, DEVICE)
        state = place_state(state, bcfg, mesh)
        it = ctx["samples"].iter_index_batches(bcfg.batch_size, epoch=0,
                                               seed=1)
        batches = [{k: torch.from_numpy(v).to(mesh.device)
                    for k, v in next(it).items()}
                   for _ in range(DDP_BF16_STEPS)]
        feats = (torch.from_numpy(ctx["feats"]).to(mesh.device),)
        fa.reset_launch_counts()
        step = make_spmd_train_step(bcfg, model, mesh, device_gather=True)
        state, losses, ms = ddp_timed_steps(step, state, batches, device,
                                            feats)
        launched = ddp_launched(fa)
        if launched != {"qkv_fwd_probs": 2 * DDP_BF16_STEPS,
                        "qkv_bwd_probs": 2 * DDP_BF16_STEPS}:
            fail(f"ddp-nccl-1 bf16: launches {launched}")
        if not np.isfinite(losses).all():
            fail(f"ddp-nccl-1 bf16: losses {losses}")
        out.update(bf16_losses=losses, bf16_step_ms=ms,
                   bf16_examples_per_sec=bcfg.batch_size / ms * 1e3,
                   bf16_launches=launched)
        if torch.device(device).type == "cuda":
            prof = profile_device(lambda: step(state, batches[0], 0, *feats),
                                  reps=5)
            out["bf16_profile"] = {k: prof[k] for k in (
                "wall_ms", "device_ms", "busy_share")}
        return out
    finally:
        dist.destroy_process_group()


def ddp_gloo_case(cfg, dp, ts, host, table, fa, device) -> dict:
    """One rank of a (dp, ts) mesh of gloo ranks on cuda:0: one f32 spmd
    step on its rows of ``host`` (DDP_ROWS x dp rows), then
    DDP_TIME_STEPS more for time; at ts = 2 a bf16 step too: gloo
    all-reduces the gathered rows in bf16, on the card."""
    import torch

    from newsrecommendation_tpu_torch.parallel import make_mesh, shard_batch
    from newsrecommendation_tpu_torch.parallel.spmd import (
        make_spmd_train_step,
        place_state,
    )

    mcfg = cfg.replace(data_parallel=dp, table_shards=ts)
    mesh = make_mesh(mcfg, device=device)
    rows = {k: v[:DDP_ROWS * dp] for k, v in host.items()}
    model, state = train_setup(mcfg, table, 1, mesh.device)
    state = place_state(state, mcfg, mesh)
    local = shard_batch(mesh, rows)
    step = make_spmd_train_step(mcfg, model, mesh)
    fa.reset_launch_counts()
    state, metrics = step(state, local, 0)
    got = ddp_state_of(state, metrics)
    launched = ddp_launched(fa)
    _, _, ms = ddp_timed_steps(step, state, [local] * (DDP_TIME_STEPS + 1),
                               device)
    out = {"got": got, "launches": launched, "step_ms": ms,
           "examples_per_sec": DDP_ROWS * dp / ms * 1e3,
           "table_rows": int(state.params["embedding_table"].shape[0])}
    if ts > 1:
        bcfg = mcfg.replace(compute_dtype="bfloat16")
        model, state = train_setup(bcfg, table, 1, mesh.device)
        state = place_state(state, bcfg, mesh)
        state, metrics = make_spmd_train_step(bcfg, model, mesh)(
            state, local, 0)
        out["bf16_loss"] = float(metrics["loss"])
    return out


def ddp_eval_table(cfg, num_news, device):
    """The num_news-news doc_table (num_news + 1 rows of T x D, row 0
    zero), drawn on the device from a seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(7)
    table = torch.randn((num_news + 1, cfg.num_words_title
                         * cfg.word_embedding_dim), generator=gen,
                        device=device) * 0.1
    table[0] = 0.0
    return table


def ddp_eval_samples(cfg, num_news):
    """DDP_EVAL_IMPRESSIONS impressions over the doc_table's news: 50-news
    histories (some shorter), DDP_EVAL_CANDIDATES candidates with both
    labels, a few padded slots."""
    from newsrecommendation_tpu_torch.data.loader import EvalSamples

    rng = np.random.default_rng(17)
    n, L, c = DDP_EVAL_IMPRESSIONS, cfg.user_log_length, DDP_EVAL_CANDIDATES
    hist = rng.integers(1, num_news + 1, size=(n, L)).astype(np.int32)
    mask = np.ones((n, L), np.float32)
    for i, k in enumerate(rng.integers(0, L, size=n)):
        hist[i, :k] = 0
        mask[i, :k] = 0.0
    cands = rng.integers(1, num_news + 1, size=(n, c)).astype(np.int32)
    labels = (rng.random((n, c)) < 0.1).astype(np.float32)
    labels[:, 0] = 1.0
    cmask = np.ones((n, c), np.float32)
    cmask[::7, -5:] = 0.0
    cands[cmask == 0] = 0
    labels[cmask == 0] = 0.0
    return EvalSamples(history=hist, history_mask=mask, candidates=cands,
                       labels=labels, candidate_mask=cmask)


def ddp_eval_case(rank, fa, device, num_news) -> dict:
    """Mesh (1, 2) over the num_news-news doc_table: phase 1 with the
    sharded encoder (each rank holds half the table), phase 2 over the
    rank's half of the impressions with cross_process_sum; rank 0 then
    runs both phases in one pass over the whole table and impressions."""
    import torch

    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.eval import (
        compute_news_scoring,
        evaluate_impressions,
        summarize_metric_sums,
    )
    from newsrecommendation_tpu_torch.models import nrms
    from newsrecommendation_tpu_torch.parallel import make_mesh
    from newsrecommendation_tpu_torch.parallel.sharded_embedding import (
        local_rows,
    )
    from newsrecommendation_tpu_torch.parallel.spmd import (
        make_spmd_news_encoder,
    )

    cfg = Config(title_source="doc_table", freeze_embedding=True,
                 user_log_mask=True, table_shards=2)
    mesh = make_mesh(cfg, device=device)
    whole = ddp_eval_table(cfg, num_news, mesh.device)
    params = nrms.init(cfg, np.zeros((1, whole.shape[1]), np.float32),
                       seed=3, device=mesh.device)
    params["embedding_table"] = local_rows(whole, 2, mesh.table_index
                                           ).clone()
    feats = np.arange(num_news + 1, dtype=np.int32)[:, None]
    samples = ddp_eval_samples(cfg, num_news)
    mine = type(samples)(**{k: getattr(samples, k)[rank::2] for k in (
        "history", "history_mask", "candidates", "labels",
        "candidate_mask")})
    fa.reset_launch_counts()
    ddp_sync(device)
    t = time.perf_counter()
    cache = compute_news_scoring(
        nrms, params, cfg, feats,
        encode_fn=make_spmd_news_encoder(cfg, nrms, mesh))
    ddp_sync(device)
    out = {"phase1_s": time.perf_counter() - t,
           "table_bytes_rank": params["embedding_table"].numel() * 4,
           "table_bytes": whole.numel() * 4}
    t = time.perf_counter()
    out["metrics"] = evaluate_impressions(nrms, params, cfg, mine, cache)
    out["phase2_s"] = time.perf_counter() - t
    out["launches"] = ddp_launched(fa)
    if rank == 0:
        params["embedding_table"] = whole
        dense = compute_news_scoring(nrms, params, cfg, feats)
        out["cache_max_abs_err"] = (cache - dense).abs().max().item()
        out["cache_n_differ"] = int((cache != dense).sum().item())
        sums = evaluate_impressions(nrms, params, cfg, samples, dense,
                                    return_sums=True)
        seen = sums.pop("samples_seen")
        out["one_pass"] = summarize_metric_sums(sums, seen)
    return out


def ddp_worker(rank, tmp, cfg, cli_argv, device, num_news):
    """One of two gloo ranks sharing ``device`` (cuda:0; spawned by
    ddp_spawn_phases): the ddp-gloo cases at (2, 1) and (1, 2), ddp-eval,
    and ddp-cli's two-rank train_test; what each returns goes to
    tmp/ddp_rank{rank}.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    from newsrecommendation_tpu_torch import cli
    from newsrecommendation_tpu_torch.data import native_loader
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/gloo_init", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))
    try:
        with np.load(os.path.join(tmp, "inputs.npz")) as z:
            table = z["table"]
            host = {k[5:]: z[k] for k in z.files if k.startswith("host/")}
        out = {"gloo": {}}
        for dp, ts in ((2, 1), (1, 2)):
            out["gloo"][f"{dp}x{ts}"] = ddp_gloo_case(
                cfg.replace(freeze_embedding=ts == 1), dp, ts, host, table,
                fa, device)
        out["eval"] = ddp_eval_case(rank, fa, device, num_news)
        fa.reset_launch_counts()
        reset_parses()
        ddp_sync(device)
        t = time.perf_counter()
        cli.main(cli_argv, device=device)
        out["cli"] = {"s": time.perf_counter() - t,
                      "launches": {k: fa.launch_counts(k)
                                   for k in fa.KERNELS
                                   if any(fa.launch_counts(k).values())},
                      "parses": native_loader.parser_counts()}
        torch.save(out, os.path.join(tmp, f"ddp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ddp_spawn_phases(ctx, fa, card, device="cuda:0",
                     num_news=NUM_NEWS) -> dict:
    """ddp-nccl-1 here; ddp-gloo, ddp-eval and ddp-cli in two spawned gloo
    ranks sharing ``device``, each phase's results checked here; the
    CLI's own spawn over NCCL where there are two cards or more. (A
    rehearsal passes device "cpu" and a small num_news.)"""
    import torch
    import torch.multiprocessing as mp

    from newsrecommendation_tpu_torch import cli

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        res["nccl1"] = ddp_nccl_one(ctx, fa, tmp, device)
        phase("ddp-nccl-1", t, **{k: json.dumps(v)
                                  for k, v in res["nccl1"].items()})

        cfg = ctx["cfg"].replace(batch_size=DDP_ROWS, deterministic=True,
                                 lr=3e-4)
        host = next(ctx["samples"].iter_batches(
            ctx["feats"], 2 * DDP_ROWS, epoch=0, seed=0))
        refs = {"2x1": ddp_reference(cfg.replace(
                    batch_size=2 * DDP_ROWS, freeze_embedding=True),
                    ctx["table"], host),
                "1x2": ddp_reference(cfg.replace(freeze_embedding=False),
                                     ctx["table"], {
                    k: v[:DDP_ROWS] for k, v in host.items()})}
        np.savez(os.path.join(tmp, "inputs.npz"), table=ctx["table"],
                 **{f"host/{k}": v for k, v in host.items()})
        cli_logging()
        train_dir, dev_dir, steps = cli_corpus(os.path.join(tmp, "cli"))
        model_dir = os.path.join(tmp, "cli", "model")
        flags = (["--train_data_dir", train_dir, "--test_data_dir", dev_dir,
                  "--user_log_mask", "True", "--compute_dtype", "bfloat16",
                  "--batch_size", "128", "--lr", "3e-4", "--log_steps", "10",
                  "--save_steps", str((steps - 1) // 3)] + ONE_CARD
                 + CLI_FLAGS)
        argv = ["--model_dir", model_dir] + flags
        t = time.perf_counter()
        mp.spawn(ddp_worker, nprocs=2, args=(
            tmp, cfg, ["--mode", "train_test", "--table_shards", "2"]
            + argv, device, num_news))
        ranks = [torch.load(os.path.join(tmp, f"ddp_rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        res["spawn_s"] = time.perf_counter() - t

        t = time.perf_counter()
        gloo = {}
        for mesh, want in refs.items():
            outs = [r["gloo"][mesh] for r in ranks]
            got = outs[0]["got"]
            if mesh == "1x2":  # the table's rows from both ranks
                got = dict(got, params=dict(got["params"]),
                           grads=dict(got["grads"]))
                for key in ("params", "grads"):
                    whole = torch.cat([o["got"][key]["embedding_table"]
                                       for o in outs])
                    got[key]["embedding_table"] = whole[
                        :want[key]["embedding_table"].shape[0]]
            gloo[mesh] = ddp_compare(f"ddp-gloo {mesh}", want, got, cfg.lr)
            for o in outs:
                if o["launches"] != {"qkv_fwd_probs": 2, "qkv_bwd_probs": 2}:
                    fail(f"ddp-gloo {mesh}: launches {o['launches']}")
                if o["got"]["loss"] != got["loss"]:
                    fail(f"ddp-gloo {mesh}: the ranks' losses differ")
            for key, v in outs[0]["got"]["params"].items():
                if not (mesh == "1x2" and key == "embedding_table") and (
                        not torch.equal(v, outs[1]["got"]["params"][key])):
                    fail(f"ddp-gloo {mesh}: {key} differs between the ranks")
            gloo[mesh].update(
                step_ms=outs[0]["step_ms"],
                examples_per_sec=outs[0]["examples_per_sec"],
                table_rows_rank=outs[0]["table_rows"])
            if mesh == "1x2":
                if not np.isfinite(outs[0]["bf16_loss"]):
                    fail(f"ddp-gloo 1x2 bf16: loss {outs[0]['bf16_loss']}")
                gloo[mesh]["bf16_loss"] = outs[0]["bf16_loss"]
            phase(f"ddp-gloo {mesh}", t, **{
                k: json.dumps(v) for k, v in gloo[mesh].items()})
        res["gloo"] = gloo

        t = time.perf_counter()
        ev = [r["eval"] for r in ranks]
        one = ev[0]["one_pass"]
        for k in ("auc", "mrr", "ndcg5", "ndcg10", "count", "samples_seen"):
            for e in ev:
                if not abs(e["metrics"][k] - one[k]) <= 1e-5 * abs(one[k]):
                    fail(f"ddp-eval: {k} {e['metrics'][k]} over two ranks, "
                         f"{one[k]} in one pass")
        if not ev[0]["cache_max_abs_err"] <= 1e-5:
            fail(f"ddp-eval: sharded cache vs dense {ev[0]}")
        for e in ev:
            if set(e["launches"]) != {"qkv_fwd"}:
                fail(f"ddp-eval: launches {e['launches']}, expected row 1")
        res["eval"] = {
            "metrics": ev[0]["metrics"], "one_pass": one,
            "cache_max_abs_err": ev[0]["cache_max_abs_err"],
            "cache_n_differ": ev[0]["cache_n_differ"],
            "phase1_s": ev[0]["phase1_s"], "phase2_s": ev[0]["phase2_s"],
            "news_per_sec_phase1": (num_news + 1) / ev[0]["phase1_s"],
            "table_gb": ev[0]["table_bytes"] / 1e9,
            "table_gb_rank": ev[0]["table_bytes_rank"] / 1e9,
            "launches": ev[0]["launches"]}
        phase("ddp-eval", t, **{k: json.dumps(v)
                                for k, v in res["eval"].items()})

        t = time.perf_counter()
        files = sorted(os.listdir(model_dir))
        line, lines = eval_line(model_dir)
        ckpts = [f for f in files if f.endswith(".ckpt")]
        evals = [x for x in lines if x["kind"] == "eval"]
        if (len(evals) != 1 or not ckpts
                or not [x for x in lines if x["kind"] == "train"]
                or any(f"{c}.shards{i}.pt" not in files
                       for c in ckpts for i in range(2))):
            fail(f"ddp-cli: files {files}, metrics.jsonl {lines}")
        for rank, r in enumerate(ranks):
            if r["cli"]["parses"] != {"native": 2, "python": 0}:
                fail(f"ddp-cli rank {rank}: behaviors parses "
                     f"{r['cli']['parses']}; expected 2, both native")
            got = r["cli"]["launches"]
            if (sum(got.get("qkv_fwd_probs", {}).values()) < 2 * steps
                    or sum(got.get("qkv_bwd_probs", {}).values()) != 2 * steps
                    or min(got.get("qkv_fwd", {"x": 0}).values()) < 1):
                fail(f"ddp-cli: launches {got}")
        os.remove(os.path.join(model_dir, "metrics.jsonl"))
        reset_parses()
        cli.main(["--mode", "test", "--load_ckpt_name", "latest"] + argv,
                 device=device)
        check_native_parses("ddp-cli one-process test", 1)
        single, _ = eval_line(model_dir)
        keys = ("auc", "mrr", "ndcg5", "ndcg10")
        if single["samples"] != line["samples"] or any(
                abs(single[k] - line[k]) > DDP_CLI_TOL for k in keys):
            fail(f"ddp-cli: one process {single}, two ranks {line}")
        summary = [x for x in lines if x["kind"] == "train_summary"][0]
        res["cli"] = {"eval_line": line, "one_process": single,
                      "checkpoints": ckpts, "train_test_s":
                          ranks[0]["cli"]["s"],
                      "train_examples_per_sec": summary["examples_per_sec"],
                      "launches": ranks[0]["cli"]["launches"],
                      "parses": [r["cli"]["parses"] for r in ranks]}
        phase("ddp-cli", t, **{k: json.dumps(v)
                               for k, v in res["cli"].items()})

        t = time.perf_counter()
        if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
            spawn_dir = os.path.join(tmp, "cli", "model_nccl")
            cli.main(["--mode", "train_test", "--model_dir", spawn_dir]
                     + flags + ["--data_parallel", "0", "--nGPU", "2"],
                     device="cuda")
            line2, _ = eval_line(spawn_dir)
            if line2 is None:
                fail("ddp-spawn-nccl: no eval line")
            res["spawn_nccl"] = {"eval_line": line2}
            phase("ddp-spawn-nccl", t, eval_line=json.dumps(line2))
        else:
            print("[ddp-spawn-nccl] not run: one card; the CLI's own spawn "
                  "route puts one NCCL rank on each card and NCCL takes no "
                  "two ranks on one card", flush=True)
    print("[ddp numbers] " + json.dumps({
        "card": card, "note": "ranks share one card: correctness, not "
                              "scaling",
        "nccl1_bf16_step_ms": res["nccl1"]["bf16_step_ms"],
        "nccl1_bf16_device_ms": res["nccl1"].get("bf16_profile", {}).get(
            "device_ms"),
        "nccl1_bf16_examples_per_sec": res["nccl1"]["bf16_examples_per_sec"],
        **{f"gloo_{m}_{k}": g[k] for m, g in res["gloo"].items()
           for k in ("step_ms", "examples_per_sec")},
        "eval_phase1_s": res["eval"]["phase1_s"],
        "eval_phase2_s": res["eval"]["phase2_s"],
        "cli_train_examples_per_sec": res["cli"]["train_examples_per_sec"],
        "spawn_s": res["spawn_s"]}), flush=True)
    return res


def kernel_phases(fa, bw, bl, fe, q2) -> dict:
    """The kernel phases (kernel through kernel-limits): every kernel
    case against its plain version, in the order main runs them.
    Returns {name: cases} under the names main reads."""
    # ---- kernel vs plain -------------------------------------------------
    t = time.perf_counter()
    cases = []
    shapes = [("bias", 1024, 20), ("bias", 7040, 20), ("bias", MAX_BATCH, 50),
              ("bias_masked", 512, 50), ("bias_masked", MAX_BATCH, 50)]
    # past T = 64: the user encoder over 300- and 511-news histories
    shapes += [(v, n, tl) for n, tl in LONG_T[1:]
               for v in ("bias", "bias_masked")]
    for i, (variant, n, tl) in enumerate(shapes):
        for dtype in ("float32", "bfloat16"):
            c = kernel_case(fa, variant, n, tl, 20, 20, dtype, seed=i)
            cases.append(c)
            print("  kernel " + json.dumps(c), flush=True)
    phase("kernel", t, cases=len(cases))

    # ---- kernel rows 2-3 vs plain (row 3 at every T row 2 takes) ----------
    t = time.perf_counter()
    train_cases = []
    shapes = [("bias", 7040, 20), ("bias", 128, 50), ("bias_masked", 128, 50)]
    shapes += [(v, n, tl) for n, tl in LONG_T
               for v in ("bias", "bias_masked")]
    for i, (variant, n, tl) in enumerate(shapes):
        for dtype in ("float32", "bfloat16"):
            c = train_kernel_case(fa, variant, n, tl, 20, 20, dtype, seed=i)
            train_cases.append(c)
            print("  kernel-train " + json.dumps(c), flush=True)
    # bf16: elements of dqkv that differ from the plain version
    phase("kernel-train", t, cases=len(train_cases), bf16_n_differ=json.dumps(
        {f"{c['variant']} {c['shape'][0]}x{c['shape'][1]}":
         c["dqkv"]["n_differ"] for c in train_cases
         if c["dtype"] == "bfloat16"}))

    # ---- kernel row 4 vs plain ---------------------------------------------
    t = time.perf_counter()
    recompute_cases = []
    for i, (n, tl) in enumerate([(7040, 20), (128, 50), (128, MID_L),
                                 (64, 511)]):
        for variant in ("bwd", "bwd_masked"):
            for dtype in ("float32", "bfloat16"):
                c = recompute_kernel_case(fa, variant, n, tl, 20, 20, dtype,
                                          seed=i)
                recompute_cases.append(c)
                print("  kernel-recompute " + json.dumps(c), flush=True)
    phase("kernel-recompute", t, cases=len(recompute_cases),
          n_differ_from_row3=sum(c["n_differ_from_row3"]
                                 for c in recompute_cases),
          bf16_n_differ=json.dumps(
              {f"{c['variant']} {c['shape'][0]}x{c['shape'][1]}":
               c["dqkv"]["n_differ"] for c in recompute_cases
               if c["dtype"] == "bfloat16"}))

    # ---- kernel rows 9-10 vs plain -----------------------------------------
    t = time.perf_counter()
    flash_cases = []
    for i, (n, tl) in enumerate([(128, 512), (128, 513), (128, 1000),
                                 (32, 2048)]):
        for masked in (False, True):
            for dtype in ("float32", "bfloat16"):
                c = flash_kernel_case(bw, masked, n, tl, 20, 20, dtype,
                                      seed=i)
                flash_cases.append(c)
                print("  kernel-flash " + json.dumps(c), flush=True)
    # bf16: elements that differ from the plain version (o, dq, dk, dv),
    # and o's count for the per-64-key-tile-max control
    phase("kernel-flash", t, cases=len(flash_cases), bf16_n_differ=json.dumps(
        {f"{c['variant']} {c['shape'][0]}x{c['shape'][1]}":
         [c[x]["n_differ"] for x in ("o", "dq", "dk", "dv")]
         + [c["o_n_differ_tile_max_control"]]
         for c in flash_cases if c["dtype"] == "bfloat16"}))

    # ---- kernel rows 11-12 vs rows 2-3 and plain ----------------------------
    t = time.perf_counter()
    qkv2d_cases = []
    for i, (n, tl) in enumerate([(7040, 20), (128, 50)]):
        for dtype in ("float32", "bfloat16"):
            c = qkv2d_kernel_case(q2, fa, n, tl, 20, 20, dtype, seed=i)
            qkv2d_cases.append(c)
            print("  kernel-2d " + json.dumps(c), flush=True)
    phase("kernel-2d", t, cases=len(qkv2d_cases))

    # ---- kernel rows 13-14 vs plain -----------------------------------------
    t = time.perf_counter()
    tail_cases = []
    for i, (masked, n, tl, dtypes) in enumerate(TAIL_SHAPES):
        for dtype in dtypes:
            for dropout in (False, True):
                c = tail_kernel_case(fe, masked, n, tl, 20, 20, 200, dtype,
                                     dropout, seed=i)
                tail_cases.append(c)
                print("  kernel-fused-tail " + json.dumps(c), flush=True)
    phase("kernel-fused-tail", t, cases=len(tail_cases))

    # ---- kernel rows 13-14 past the resident regime ------------------------
    t = time.perf_counter()
    tail_long_cases = []
    for i, (n, tl, dropout, dtypes) in enumerate(TAIL_LONG):
        for dtype in dtypes:
            c = tail_kernel_case(fe, True, n, tl, 20, 20, 200, dtype,
                                 dropout, seed=10 + i)
            tail_long_cases.append(c)
            print("  kernel-fused-tail-long " + json.dumps(c), flush=True)
            print("  [tail-long] " + json.dumps({
                "shape": [n, tl], "dtype": dtype, "dropout": c["dropout"],
                "regimes": c["regimes"],
                "n_differ": {k: c[k]["n_differ"] for k in ("out", "dqkv")},
                **{f"{k}_{x}": c[k][x] for k in ("fwd", "bwd")
                   for x in ("ms", "plain_ms", "bound_ms")}}), flush=True)
    phase("kernel-fused-tail-long", t, cases=len(tail_long_cases))

    # ---- kernel rows 5-8 vs plain -------------------------------------------
    t = time.perf_counter()
    sep_cases = []
    sep_shapes = [(7040, 20, dv) for dv in SEP_DV]
    sep_shapes += [(n, tl, SEP_DV[1]) for n, tl in SEP_LONG]
    for i, (n, tl, dv) in enumerate(sep_shapes):
        for masked in (False, True):
            for dtype in ("float32", "bfloat16"):
                c = sep_kernel_case(fa, masked, n, tl, 20, 20, dv, dtype,
                                    seed=i)
                sep_cases.append(c)
                print("  kernel-sep " + json.dumps(c), flush=True)
    phase("kernel-sep", t, cases=len(sep_cases))

    # ---- kernel rows 15-16 vs plain -----------------------------------------
    t = time.perf_counter()
    blanes_cases = []
    shapes = [(False, 7040, 20), (False, 128, 50), (True, 128, 50),
              (False, 64, 511), (True, 64, 511)]
    shapes += [(True, 128, tl) for tl in BLANES_T]
    for i, (masked, n, tl) in enumerate(shapes):
        for dtype in ("float32", "bfloat16"):
            c = blanes_kernel_case(bl, fa, masked, n, tl, 20, 20, dtype,
                                   seed=i)
            blanes_cases.append(c)
            print("  kernel-blanes " + json.dumps(c), flush=True)
    phase("kernel-blanes", t, cases=len(blanes_cases))

    # ---- the shapes the card once refused ----------------------------------
    t = time.perf_counter()
    limit_cases = []
    for i, (which, n, tl, heads, d) in enumerate(LIMIT_CASES):
        for dtype in ("float32", "bfloat16"):
            for masked in (False, True):
                c = limits_case(fa, bw, bl, q2, which, n, tl, heads, d,
                                dtype, masked, seed=i)
                limit_cases.append(c)
                print("  kernel-limits " + json.dumps(c), flush=True)
    for i, (tl, heads) in enumerate(TAIL_LIMITS):
        for j, dtype in enumerate(("float32", "bfloat16")):
            c = tail_limit_case(fe, tl, heads, dtype, seed=40 + 2 * i + j)
            limit_cases.append(c)
            print("  kernel-limits " + json.dumps(c), flush=True)
    phase("kernel-limits", t, cases=len(limit_cases))
    return {"cases": cases, "train_cases": train_cases,
            "recompute_cases": recompute_cases, "flash_cases": flash_cases,
            "qkv2d_cases": qkv2d_cases, "tail_cases": tail_cases,
            "tail_long_cases": tail_long_cases, "sep_cases": sep_cases,
            "blanes_cases": blanes_cases, "limit_cases": limit_cases}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    # ---- device ----------------------------------------------------------
    t = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    # which card and host this run had, to match a failure to its machine
    gpu_id = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,driver_version,vbios_version",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    phase("device", t, name=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, gpu=repr(gpu_id.strip()),
          cpu=torch.backends.cpu.get_cpu_capability(),
          cpu_threads=torch.get_num_threads())

    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
    from newsrecommendation_tpu_torch.ops import (
        experimental_fused_encoder as fe,
    )
    from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    # ---- build -----------------------------------------------------------
    t = time.perf_counter()
    sos = fa.build()  # one nvcc per source, all started together
    phase("build", t, **{k: os.path.relpath(v) for k, v in sos.items()})
    print("[build seconds] " + json.dumps(
        {k: round(v, 1) for k, v in fa.kernels.build_seconds.items()}),
        flush=True)

    # ---- the native behaviors parser ---------------------------------------
    t = time.perf_counter()
    parse = native_parse_run(card)
    phase("native-parse", t, **{k: json.dumps(v) for k, v in parse.items()})
    print("[parse numbers] " + json.dumps(parse), flush=True)

    kc = kernel_phases(fa, bw, bl, fe, q2)
    cases, train_cases, recompute_cases = (
        kc["cases"], kc["train_cases"], kc["recompute_cases"])
    flash_cases, qkv2d_cases, tail_cases, tail_long_cases = (
        kc["flash_cases"], kc["qkv2d_cases"], kc["tail_cases"],
        kc["tail_long_cases"])
    sep_cases, blanes_cases = kc["sep_cases"], kc["blanes_cases"]

    # ---- multi_head_self_attention at d_v != d_k: rows 5-8 ------------------
    unequal = {}
    for masked in (False, True):
        t = time.perf_counter()
        unequal[masked] = unequal_run(masked)
        phase(f"mhsa-unequal masked={masked}", t,
              **{k: json.dumps(v) for k, v in unequal[masked].items()})

    # ---- serve at NRMS's published width ----------------------------------
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.data import (
        build_news_features,
        random_word_embeddings,
        read_news,
    )
    from newsrecommendation_tpu_torch.data.loader import TrainSamples
    from newsrecommendation_tpu_torch.data.prepare import (
        prepare_training_data,
    )
    from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
    from newsrecommendation_tpu_torch.models import nrms
    from newsrecommendation_tpu_torch.train import make_train_step
    from newsrecommendation_tpu_torch.utils import to_device

    t = time.perf_counter()
    cfg = Config()  # 300-d words, 400-d news, 20 heads x 20, T=20, L=50
    with tempfile.TemporaryDirectory() as tmp:
        # the same seed draws the same news first, then behaviors whose
        # histories run up to max_history: 80 for the 50-news phases, 600
        # (past LONG_L) for the long ones
        shards = {}
        for key, max_history in (("samples", 80),
                                 ("samples_long", MAX_HISTORY)):
            out = os.path.join(tmp, key)
            generate_corpus(out, num_news=NUM_NEWS, num_users=100,
                            num_impressions=TRAIN_IMPRESSIONS,
                            title_len=cfg.num_words_title,
                            max_history=max_history, seed=0)
            prepare_training_data(out, 1, cfg.npratio, seed=0)
            shards[key] = os.path.join(out, f"behaviors_np{cfg.npratio}_0.tsv")
        news = [os.path.join(tmp, key, "news.tsv") for key in shards]
        with open(news[0], "rb") as a, open(news[1], "rb") as b:
            if a.read() != b.read():
                fail("the two draws of the corpus differ in their news")
        corpus = read_news(news[0], cfg)
        # NAML reads the same news with its category views on
        naml_corpus = read_news(news[0], naml_config(cfg))
        samples = TrainSamples.from_file(shards["samples"],
                                         corpus.news_index, cfg)
        samples_long = TrainSamples.from_file(
            shards["samples_long"], corpus.news_index,
            cfg.replace(user_log_length=LONG_L))
        samples_mid = TrainSamples.from_file(
            shards["samples_long"], corpus.news_index,
            cfg.replace(user_log_length=MID_L))
    feats = build_news_features(corpus, cfg)
    table = random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim)
    params = nrms.init(cfg, table, seed=0, device="cuda")
    ctx = {"cfg": cfg, "params": params, "feats": feats, "model": nrms,
           "vocab_sizes": (0, 0),
           "news_index": corpus.news_index, "table": table,
           "samples": samples, "samples_long": samples_long,
           "samples_mid": samples_mid,
           "cpu_params": to_device(params, "cpu")}
    phase("corpus", t, news=corpus.num_news, vocab=len(corpus.word_dict),
          train_samples=samples.num_samples,
          full_long_histories=int((samples_long.history_mask.sum(1)
                                   == LONG_L).sum()))

    fa.reset_launch_counts()
    runs = {}
    for user_log_mask in (False, True):
        t = time.perf_counter()
        before = fa.launch_counts()
        runs[user_log_mask], rec = serve_run(ctx, user_log_mask)
        after = fa.launch_counts()
        runs[user_log_mask]["launches"] = {k: after[k] - before[k]
                                           for k in after}
        phase(f"serve user_log_mask={user_log_mask}", t,
              **{k: json.dumps(v) for k, v in runs[user_log_mask].items()})
    launches = fa.launch_counts("qkv_fwd")
    if min(launches.values()) < 1:
        fail(f"a kernel of the serving path never launched: {launches}")
    if runs[False]["launches"]["bias_masked"] or not (
            runs[True]["launches"]["bias_masked"]):
        fail(f"masked kernel launches do not follow user_log_mask: {runs}")

    # ---- serve with the fused encoder tail: row 13 only ---------------------
    t = time.perf_counter()
    fa.reset_launch_counts()
    serve_tail, _ = serve_run(ctx, True, fused_tail="on")
    serve_tail["launches"] = {k: fa.launch_counts(k) for k in fa.KERNELS
                              if any(fa.launch_counts(k).values())}
    tail_fwd = serve_tail["launches"].get("fused_tail_fwd", {})
    if set(serve_tail["launches"]) != {"fused_tail_fwd"} or not (
            tail_fwd["tail"] and tail_fwd["tail_masked"]):
        fail(f"serve fused_tail: launches {serve_tail['launches']}, expected "
             "row 13 only, both variants")
    phase("serve fused_tail=on user_log_mask=True", t,
          **{k: json.dumps(v) for k, v in serve_tail.items()})

    # ---- serve with the batch-in-lanes attention: rows 15 only --------------
    t = time.perf_counter()
    fa.reset_launch_counts()
    serve_blanes, _ = serve_run(ctx, True, attention_layout="blanes")
    serve_blanes["launches"] = {k: fa.launch_counts(k) for k in fa.KERNELS
                                if any(fa.launch_counts(k).values())}
    got = serve_blanes["launches"].get("blanes_fwd", {})
    if set(serve_blanes["launches"]) != {"blanes_fwd"} or not (
            got["blanes"] and got["blanes_masked"]):
        fail(f"serve blanes: launches {serve_blanes['launches']}, expected "
             "row 15 only, both variants")
    phase("serve attention_layout=blanes user_log_mask=True", t,
          **{k: json.dumps(v) for k, v in serve_blanes.items()})

    # ---- serve with a history of LONG_L news: the flash forward ------------
    long_scores = {}
    for user_log_mask in (False, True):
        t = time.perf_counter()
        fa.reset_launch_counts()
        run, rec_long = serve_run(ctx, user_log_mask, user_log_length=LONG_L)
        run["launches"] = {k: fa.launch_counts(k)
                           for k in ("qkv_fwd", "flash_fwd")}
        run["flash_regimes"] = fa.regime_counts("flash_fwd")
        flash = run["launches"]["flash_fwd"]
        if not flash["flash_masked" if user_log_mask else "flash"] or (
                flash["flash" if user_log_mask else "flash_masked"]):
            fail(f"serve-long: flash launches {flash} do not follow "
                 f"user_log_mask={user_log_mask}")
        if run["flash_regimes"] != {"cuda_core": sum(flash.values())}:
            fail(f"serve-long: flash launches per regime "
                 f"{run['flash_regimes']}, expected cuda_core only (f32)")
        # one served batch at full size: 64 users, LONG_L-news histories
        rng = np.random.default_rng(13)
        ids = [f"N{i}" for i in range(1, NUM_NEWS + 1)]
        hists = [[ids[j] for j in rng.integers(0, NUM_NEWS, LONG_L)]
                 for _ in range(MAX_BATCH)]
        cands = [[ids[j] for j in rng.choice(NUM_NEWS, 300, replace=False)]
                 for _ in range(MAX_BATCH)]
        long_scores[user_log_mask] = profile_device(
            lambda: rec_long.score_batch(hists, cands))
        run["score_batch_64x300"] = long_scores[user_log_mask]
        del rec_long
        phase(f"serve-long user_log_mask={user_log_mask}", t,
              **{k: json.dumps(v) for k, v in run.items()})
    t = time.perf_counter()
    fa.reset_launch_counts()
    run, _ = serve_run(ctx, True, user_log_length=LONG_L, fused_tail="on")
    run["launches"] = {k: fa.launch_counts(k) for k in fa.KERNELS
                       if any(fa.launch_counts(k).values())}
    got = run["launches"].get("fused_tail_fwd", {})
    if set(run["launches"]) != {"fused_tail_fwd"} or not (
            got["tail"] and got["tail_masked"]):
        fail(f"serve-long fused_tail: launches {run['launches']}, expected "
             "row 13 only, on both encoders")
    phase("serve-long fused_tail=on user_log_mask=True", t,
          **{k: json.dumps(v) for k, v in run.items()})

    # ---- serve 8 heads of 50 over MID_SERVE_L-news histories: row 1 -------
    t = time.perf_counter()
    fa.reset_launch_counts()
    run, _ = serve_run(ctx, True, user_log_length=MID_SERVE_L,
                       num_attention_heads=8)
    run["launches"] = {k: fa.launch_counts(k) for k in fa.KERNELS
                       if any(fa.launch_counts(k).values())}
    got = run["launches"].get("qkv_fwd", {})
    if set(run["launches"]) != {"qkv_fwd"} or not got["bias_masked"]:
        fail(f"serve heads=8: launches {run['launches']}, expected row 1 "
             "only, masked on the user encoder")
    phase(f"serve heads=8 user_log_length={MID_SERVE_L} user_log_mask=True",
          t, **{k: json.dumps(v) for k, v in run.items()})

    # ---- training ------------------------------------------------------------
    checks = [({"user_log_mask": False}, {}), ({"user_log_mask": True}, {}),
              ({"user_log_mask": False}, {"bwd_residuals": "recompute"}),
              ({"user_log_mask": True}, {"bwd_residuals": "recompute"}),
              ({"user_log_mask": False}, {"freeze_embedding": False}),
              ({"user_log_mask": False}, {"fused_tail": "on"}),
              ({"user_log_mask": True}, {"fused_tail": "on"}),
              ({"user_log_mask": False}, {"attention_layout": "blanes"}),
              ({"user_log_mask": True}, {"attention_layout": "blanes"}),
              ({"user_log_mask": False, "samples": "samples_long"},
               dict(LONG_CHECK, user_log_length=LONG_L)),
              ({"user_log_mask": True, "samples": "samples_long"},
               dict(LONG_CHECK, user_log_length=LONG_L))]
    for args, overrides in checks:
        t = time.perf_counter()
        res = train_check(ctx, **args, **overrides)
        label = " ".join(f"{k}={v}" for k, v in {**args, **overrides}.items()
                         if k not in LONG_CHECK)
        phase(f"train-check {label}", t,
              **{k: json.dumps(v) for k, v in res.items()})
    trains = {}
    for name, kw in [("probs", {}),
                     ("recompute", {"bwd_residuals": "recompute"}),
                     ("recompute_f32", {"bwd_residuals": "recompute",
                                        "compute_dtype": "float32",
                                        "max_steps": F32_RECOMPUTE_STEPS,
                                        "fixed_batch": False}),
                     ("trainable", {"freeze_embedding": False,
                                    "fixed_batch": False}),
                     ("fused_tail", {"fused_tail": "on"}),
                     ("2d", {"io": "2d", "fixed_batch": False}),
                     ("blanes", {"attention_layout": "blanes",
                                 "fixed_batch": False}),
                     ("fused_tail_long", {"fused_tail": "on",
                                          "user_log_length": LONG_L,
                                          "samples": "samples_long",
                                          "max_steps": FUSED_LONG_STEPS,
                                          "fixed_batch": False}),
                     ("long", {"user_log_length": LONG_L,
                               "samples": "samples_long",
                               "max_steps": LONG_STEPS,
                               "fixed_batch": False}),
                     ("long_f32", {"user_log_length": LONG_L,
                                   "compute_dtype": "float32",
                                   "samples": "samples_long",
                                   "max_steps": LONG_STEPS,
                                   "fixed_batch": False}),
                     ("mid", {"user_log_length": MID_L,
                              "samples": "samples_mid",
                              "max_steps": MID_STEPS,
                              "fixed_batch": False}),
                     ("mid_recompute", {"bwd_residuals": "recompute",
                                        "user_log_length": MID_L,
                                        "samples": "samples_mid",
                                        "max_steps": MID_STEPS,
                                        "fixed_batch": False})]:
        t = time.perf_counter()
        trains[name] = train_run(ctx, fa, **kw)
        phase(f"train {name}", t,
              **{k: json.dumps(v) for k, v in trains[name][0].items()})
    train = trains["probs"][0]

    # ---- NAML at the JAX benchmark's width: no kernel on its path ----------
    naml_ctx = naml_context(ctx, naml_corpus, corpus)
    naml = naml_phases(naml_ctx, fa)
    trains.update(naml=naml["naml"], naml_trainable=naml["naml_trainable"])

    # ---- where the device time goes (after the counts were read) ----------
    t = time.perf_counter()
    rng = np.random.default_rng(11)
    ids = [f"N{i}" for i in range(1, NUM_NEWS + 1)]
    hists = [[ids[j] for j in rng.integers(0, NUM_NEWS, 50)]
             for _ in range(MAX_BATCH)]
    cands = [[ids[j] for j in rng.choice(NUM_NEWS, 300, replace=False)]
             for _ in range(MAX_BATCH)]
    chunk = torch.from_numpy(feats[1:cfg.eval_news_chunk + 1]).cuda()

    def encode_chunk():
        with torch.inference_mode():
            nrms.news_encoder(rec.params, cfg, chunk)

    train_feats = torch.from_numpy(feats).cuda()
    naml_feats = torch.from_numpy(naml_ctx["feats"]).cuda()

    def step_of(name, io="3d", feats=train_feats):
        # built again: building a step sets the kernel switches its config
        # carries (kernel_config.apply), which the later runs have changed
        tcfg, tmodel, tstate, _ = trains[name][1]
        tstep = make_train_step(tcfg, tmodel, device_gather=True)
        key = {LONG_L: "samples_long", MID_L: "samples_mid"}.get(
            tcfg.user_log_length, "samples")
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(
            ctx[key].iter_index_batches(tcfg.batch_size, epoch=0,
                                        seed=2)).items()}

        def run():
            with attention_io(io):
                return tstep(tstate, batch, tcfg.seed, feats)

        return run

    prof = {"score_batch_64x300": profile_device(
                lambda: rec.score_batch(hists, cands)),
            "recommend_batch_64_k10": profile_device(
                lambda: rec.recommend_batch(hists, k=10)),
            "news_encoder_chunk_1024": profile_device(encode_chunk),
            "train_step_b128_bf16": profile_device(step_of("probs")),
            "train_step_recompute_b128_bf16": profile_device(
                step_of("recompute")),
            "train_step_trainable_b128_bf16": profile_device(
                step_of("trainable")),
            "train_step_fused_tail_b128_bf16": profile_device(
                step_of("fused_tail")),
            "train_step_2d_b128_bf16": profile_device(step_of("2d", "2d")),
            "train_step_blanes_b128_bf16": profile_device(step_of("blanes")),
            f"train_step_fused_tail_l{LONG_L}_b128_bf16": profile_device(
                step_of("fused_tail_long"), reps=2),
            f"train_step_l{LONG_L}_b128_bf16": profile_device(
                step_of("long"), reps=3),
            f"train_step_l{LONG_L}_b128_f32": profile_device(
                step_of("long_f32"), reps=3),
            f"train_step_l{MID_L}_b128_bf16": profile_device(
                step_of("mid"), reps=3),
            "naml_score_batch_64x300": profile_device(
                lambda: naml["rec"].score_batch(hists, cands)),
            "naml_train_step_b128_bf16": profile_device(
                step_of("naml", feats=naml_feats)),
            "naml_train_step_trainable_b128_bf16": profile_device(
                step_of("naml_trainable", feats=naml_feats))}
    phase("profile", t, **{k: json.dumps(v) for k, v in prof.items()})
    print("[flash f32 numbers] " + json.dumps({
        "card": card,
        "train_long_f32": {k: trains["long_f32"][0][k] for k in (
            "steps", "step_ms", "examples_per_sec", "first_loss",
            "final_loss", "max_memory_allocated_gb", "launches",
            "regimes")},
        "train_step_l512_f32": prof[f"train_step_l{LONG_L}_b128_f32"],
        "serve_long_score_batch": {str(k): v
                                   for k, v in long_scores.items()}}),
          flush=True)

    # ---- the command-line path: train_test, checkpoints, test, /reload ----
    t = time.perf_counter()
    cli = cli_run(fa, card)
    phase("cli", t, **{k: json.dumps(v) for k, v in cli.items()})
    print("[cli numbers] " + json.dumps({
        "card": card, "train_examples_per_sec":
            cli["train_examples_per_sec"],
        "checkpoint_mb": cli["checkpoint_mb"], "save_s": cli["save_s"],
        "load_s": cli["load_s"],
        "eval_impressions_per_sec":
            cli["test_default"]["eval_impressions_per_sec"],
        "eval_impressions_per_sec_fused_tail":
            cli["test_fused_tail"]["eval_impressions_per_sec"],
        "reload_s": cli["reload_s"],
        "train_test_s": cli["train_test_s"]}), flush=True)

    # ---- NAML through the command line: the fork's demo flags ---------------
    t = time.perf_counter()
    naml_cli = naml_cli_run(fa, card)
    phase("naml-cli", t, **{k: json.dumps(v) for k, v in naml_cli.items()})
    naml_prof = {k: prof[k] for k in ("naml_score_batch_64x300",
                                      "naml_train_step_b128_bf16",
                                      "naml_train_step_trainable_b128_bf16")}
    print("[naml numbers] " + json.dumps({
        "card": card,
        "train_examples_per_sec": naml["naml"][0]["examples_per_sec"],
        "train_step_ms": naml["naml"][0]["step_ms"],
        "trainable_examples_per_sec":
            naml["naml_trainable"][0]["examples_per_sec"],
        **{k: {x: v[x] for x in ("wall_ms", "device_ms", "busy_share")}
           for k, v in naml_prof.items()},
        "cli_auc": naml_cli["eval_line"]["auc"],
        "cli_eval_impressions_per_sec":
            naml_cli["eval_impressions_per_sec"],
        "cli_test_eval_impressions_per_sec":
            naml_cli["test_eval_impressions_per_sec"],
        "cli_train_examples_per_sec": naml_cli["train_examples_per_sec"],
        "cli_reload_s": naml_cli["reload_s"]}), flush=True)

    # ---- data parallelism and row-sharded tables ----------------------------
    ddp_spawn_phases(ctx, fa, card)

    # ---- summary -----------------------------------------------------------
    def find(found_in, **key):
        return next(c for c in found_in if all(
            (c["shape"][:2] if k == "shape" else c[k]) == v
            for k, v in key.items()))

    def row(name, source, replaces, n_launch, err, timing, c):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err["max_abs_err"],
                "n_differ": err["n_differ"], "n_elems": err["n_elems"],
                "max_abs_ref": err["max_abs_ref"], "ms": timing["ms"],
                "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"],
                "bound_by": timing["bound_by"],
                "library_ms": timing["library_ms"], "shape": c["shape"],
                "dtype": c["dtype"]}

    kernels = []
    for variant, (n, tl) in {"bias": (1024, 20),
                             "bias_masked": (MAX_BATCH, 50)}.items():
        c = find(cases, variant=variant, shape=[n, tl], dtype="float32")
        kernels.append(row(f"exp_mhsa_qkv_{variant}", SOURCE, REPLACES,
                           launches[variant], c, c, c))
    # rows 2-4 at the news encoder's shape in the headline step, rows 9-10
    # at a user encoder over a LONG_L-news history (bf16)
    c = find(train_cases, variant="bias", shape=[7040, 20], dtype="bfloat16")
    kernels.append(row("exp_mhsa_qkv_bias_probs", SOURCE,
                       f"{TPU_KERNELS}:601",
                       train["launches"]["qkv_fwd_probs"]["bias_probs"],
                       c["probs"], c["fwd"], c))
    kernels.append(row("qkv_bwd_probs", BWD_PROBS_SOURCE,
                       f"{TPU_KERNELS}:642",
                       train["regimes"]["qkv_bwd_probs"]["resident"],
                       c["dqkv"], c["bwd"], c))
    # and in f32 (the CLI's default dtype), launched on the news encoder of
    # the f32 LONG_L run
    c = find(train_cases, variant="bias", shape=[7040, 20], dtype="float32")
    kernels.append(row("qkv_bwd_probs_f32", BWD_PROBS_SOURCE,
                       f"{TPU_KERNELS}:642",
                       trains["long_f32"][0]["regimes"]["qkv_bwd_probs"][
                           "resident"], c["dqkv"], c["bwd"], c))
    # row 2 at the user encoder over MID_L-news histories (bf16, tensor
    # cores), with its tensor-core launches in the MID_L run
    c = find(train_cases, variant="bias", shape=[128, MID_L],
             dtype="bfloat16")
    kernels.append(row("exp_mhsa_qkv_bias_probs_long", SOURCE,
                       f"{TPU_KERNELS}:601",
                       trains["mid"][0]["regimes"]["qkv_fwd_probs"]["mma"],
                       c["probs"], c["fwd"], c))
    c = find(recompute_cases, variant="bwd", shape=[7040, 20],
             dtype="bfloat16")
    kernels.append(row("qkv_bwd", BWD_SOURCE, f"{TPU_KERNELS}:712",
                       trains["recompute"][0]["regimes"]["qkv_bwd"][
                           "resident"], c["dqkv"], c["bwd"], c))
    c = find(recompute_cases, variant="bwd", shape=[7040, 20],
             dtype="float32")
    kernels.append(row("qkv_bwd_f32", BWD_SOURCE, f"{TPU_KERNELS}:712",
                       trains["recompute_f32"][0]["regimes"]["qkv_bwd"][
                           "resident"], c["dqkv"], c["bwd"], c))
    # rows 3-4 at a user encoder over 511-news histories (bf16, tensor
    # cores), with the launches of their tensor-core regime in the MID_L
    # runs (row 3 in "probs" mode, row 4 in "recompute")
    c = find(train_cases, variant="bias", shape=[64, 511], dtype="bfloat16")
    kernels.append(row("qkv_bwd_probs_long", BWD_PROBS_SOURCE,
                       f"{TPU_KERNELS}:642",
                       trains["mid"][0]["regimes"]["qkv_bwd_probs"]["mma"],
                       c["dqkv"], c["bwd"], c))
    c = find(recompute_cases, variant="bwd", shape=[64, 511],
             dtype="bfloat16")
    kernels.append(row("qkv_bwd_long", BWD_SOURCE, f"{TPU_KERNELS}:712",
                       trains["mid_recompute"][0]["regimes"]["qkv_bwd"][
                           "mma"], c["dqkv"], c["bwd"], c))
    # rows 5-8 at the news encoder's shape with d_v = 32 != d_k, launched
    # on their own path (multi_head_self_attention at unequal widths)
    for masked, (fwd_line, bwd_line) in ((False, (391, 415)),
                                         (True, (443, 468))):
        variant = "mhsa_masked" if masked else "mhsa"
        c = next(x for x in sep_cases if x["variant"] == variant
                 and x["dtype"] == "bfloat16" and x["shape"][4] == SEP_DV[1]
                 and x["shape"][:2] == [7040, 20])
        n_fwd = unequal[masked]["launches"]["mhsa_fwd"][variant]
        n_bwd = unequal[masked]["launches"]["mhsa_bwd"][
            "mhsa_bwd_masked" if masked else "mhsa_bwd"]
        grads = [c[x] for x in ("dq", "dk", "dv")]
        err = {"max_abs_err": max(x["max_abs_err"] for x in grads),
               "n_differ": sum(x["n_differ"] for x in grads),
               "n_elems": sum(x["n_elems"] for x in grads),
               "max_abs_ref": max(x["max_abs_ref"] for x in grads)}
        name = "exp_mhsa_masked" if masked else "exp_mhsa"
        kernels.append(row(f"{name}_fwd", SEP_SOURCE,
                           f"{TPU_KERNELS}:{fwd_line}", n_fwd, c["ctx"],
                           c["fwd"], c))
        kernels.append(row(f"{name}_bwd", SEP_SOURCE,
                           f"{TPU_KERNELS}:{bwd_line}", n_bwd, err,
                           c["bwd"], c))
    c = find(flash_cases, variant="flash", shape=[128, LONG_L],
             dtype="bfloat16")
    long_launches = trains["long"][0]["launches"]
    kernels.append(row("flash_exp_mhsa_fwd", FLASH_FWD_SOURCE,
                       f"{FLASH_KERNELS}:156",
                       sum(long_launches["flash_fwd"].values()), c["o"],
                       c["fwd"], c))
    kernels.append(row("flash_exp_mhsa_bwd", FLASH_BWD_SOURCE,
                       f"{FLASH_KERNELS}:215",
                       sum(long_launches["flash_bwd"].values()), c["dq"],
                       c["bwd"], c))
    # and in f32 (CUDA cores), launched in the f32 LONG_L run
    c = find(flash_cases, variant="flash", shape=[128, LONG_L],
             dtype="float32")
    f32_launches = trains["long_f32"][0]["launches"]
    kernels.append(row("flash_exp_mhsa_fwd_f32", FLASH_FWD_SOURCE,
                       f"{FLASH_KERNELS}:156",
                       sum(f32_launches["flash_fwd"].values()), c["o"],
                       c["fwd"], c))
    kernels.append(row("flash_exp_mhsa_bwd_f32", FLASH_BWD_SOURCE,
                       f"{FLASH_KERNELS}:215",
                       sum(f32_launches["flash_bwd"].values()), c["dq"],
                       c["bwd"], c))
    # rows 11-12 and 13-14 at the news encoder's shape in the headline step,
    # launched on their own paths (attention_io "2d", fused_tail "on")
    c = find(qkv2d_cases, shape=[7040, 20], dtype="bfloat16")
    io_launches = trains["2d"][0]["launches"]
    kernels.append(row("exp_mhsa_qkv_bias_2d_fwd", SOURCE,
                       f"{QKV2D_KERNELS}:145",
                       sum(io_launches["qkv2d_fwd"].values()), c["ctx"],
                       c["fwd"], c))
    kernels.append(row("exp_mhsa_qkv_bias_2d_bwd", BWD_PROBS_SOURCE,
                       f"{QKV2D_KERNELS}:193",
                       sum(io_launches["qkv2d_bwd"].values()), c["dqkv"],
                       c["bwd"], c))
    c = find(tail_cases, variant="tail", shape=[7040, 20], dtype="bfloat16",
             dropout=0.2)
    tail_launches = trains["fused_tail"][0]["launches"]
    kernels.append(row("exp_mhsa_pool_fwd", TAIL_FWD_SOURCE,
                       f"{TAIL_KERNELS}:257",
                       sum(tail_launches["fused_tail_fwd"].values()), c["out"],
                       c["fwd"], c))
    kernels.append(row("exp_mhsa_pool_bwd", TAIL_BWD_SOURCE,
                       f"{TAIL_KERNELS}:309",
                       sum(tail_launches["fused_tail_bwd"].values()),
                       c["dqkv"], c["bwd"], c))
    # rows 15-16 at the news encoder's shape, launched on their own path
    # (attention_layout "blanes")
    c = find(blanes_cases, variant="blanes", shape=[7040, 20],
             dtype="bfloat16")
    blanes_launches = trains["blanes"][0]["launches"]
    kernels.append(row("exp_mhsa_qkv_blanes_fwd", BLANES_SOURCE,
                       f"{BLANES_KERNELS}:143",
                       sum(blanes_launches["blanes_fwd"].values()), c["ctx"],
                       c["fwd"], c))
    kernels.append(row("exp_mhsa_qkv_blanes_bwd", BLANES_SOURCE,
                       f"{BLANES_KERNELS}:171",
                       sum(blanes_launches["blanes_bwd"].values()),
                       c["dqkv"], c["bwd"], c))
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        fail(f"kernels never launched on their main path: {idle}")
    print(json.dumps({"kernels": kernels, "card": card,
                      "total_s": time.perf_counter() - _T0}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
