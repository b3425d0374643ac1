#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one or more printed lines each; any failure exits non-zero:
  1. device        -- card name, count, and nvidia-smi's name and power limit;
  2. build         -- nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
                      each kernel's ptxas registers, shared memory and spills;
                      fails unless every bf16 attention (head dims 32, 64, 80,
                      128 and 256) and ssd_scan kernel's SASS holds HMMA
                      (tensor-core) instructions and none spills at head dim
                      64, nor attention at 80 or 256 (forward, and the bf16 and
                      f32 backward; their lines, the f32 forward's at 256 and
                      the dh-128 backward's are printed), unless both gate-window
                      kernels build unspilled in all four row buckets, and
                      unless all 24 RMSNorm backward kernels (four buckets of
                      warps a row and the chunked path, four dtype pairs)
                      and all 20 SSD backward kernels build unspilled, and
                      the SASS of each of the 10 bf16 ones (inter, intra and
                      finish on the tensor cores) holds HMMA;
  3. rmsnorm       -- the kernel against its plain PyTorch version on the card;
  4. attention     -- the kernel against its plain PyTorch version on the card,
                      f32 (CUDA cores) and bf16 (tensor cores), the bf16 edges
                      of ``ATTN_BF16_EDGES``; at head dim 80 (zamba2-2.7b's
                      shared attention) its served strided layout and the
                      edges again, in f32 and bf16; at head dim 128 the moe
                      slice's served layouts (qwen2-moe-a2.7b's prefill, and
                      mixtral-8x22b's 4,608-token prompt under its window of
                      4,096), in f32 and bf16; at head dim 256 paligemma-3b's
                      served MQA 8/1 prefill and the bf16 edges again, and
                      hubert-xlarge's non-causal (8, 16, 500, 80), in f32 and
                      bf16;
  5. gc_coding     -- the coded-combine kernel against its plain version;
  6. rmsnorm-bwd,  -- the backward kernels against the plain versions' autograd,
     attention-bwd    at the training shapes, in f32 and bf16, and attention's
                      bf16 edges, and its head-dim-80 cases in f32 and bf16;
                      at head dim 256 the edges again and paligemma-3b's GC
                      and M-SGC coded steps' (64 | 48, 8, 320, 256) with kv
                      (.., 1, 320, 256), f32 and bf16, bit-identical on a
                      second call;
                      bf16 with q = k = v (a near one-hot softmax)
                      against autograd of the f32 plain version.  The RMSNorm
                      backward also at d 2048, 4096 and 8192, with gamma in
                      f32 and bf16; its dgamma (and dx) bit-identical over 10
                      calls on each path; its barrier counters back at 0; and
                      exactly one device kernel a call in a profiled run;
  7. ssd_scan      -- both SSD kernel entries (the intra-chunk block, and the
                      fused chunk scan with the inter-chunk term, D skip and
                      cast in its epilogue) against their plain versions, f32
                      and bf16: tests/test_ssd_kernel.py's shapes, a ragged
                      final chunk, odd Q and head_dim, strided views,
                      mamba2-1.3b's and zamba2-2.7b's full widths, and a steep
                      decay whose unmasked exp would overflow; misaligned
                      views refused;
  7b. ssd-bwd      -- the fused chunk scan's backward kernels against the
                      plain backward and against autograd of the plain
                      forward, f32 (CUDA cores) and bf16 (tensor cores; bf16
                      inputs with an f32 dy on the CUDA cores): the forward's
                      sweep, a ragged Q and head_dim, steep decay, 4 chunks
                      with a nonzero h_prev, s 150 of 3 x 64, mamba2-1.3b's
                      training shape (512 batch-chunks), zamba2-2.7b's widths,
                      and x, B and C as strided views of a conv output at
                      mamba2's widths; each called twice, bit for bit the
                      same;
  8. slice         -- full-width qwen2-0.5b serving through ``serve()`` (prefill
                      of 8 x 500 prompt tokens, 31 greedy decode steps), with
                      the kernels' launch counts read around that run; then a
                      float32 teacher-forced run through the kernels and
                      through the plain versions, whose logits must agree.
                      A profiled prefill and decode step give the device's
                      busy time by kernel category and its idle share.  The
                      same for full-width llama3.2-1b (16 layers, GQA 32/8,
                      tied head, rope theta 5e5): 16 attention and 1,056
                      rmsnorm launches a request;
  9. slice-ssm     -- the same for full-width mamba2-1.3b (48 Mamba2 blocks,
                      attention-free): exactly 48 ``ssd_scan`` launches, all
                      of the fused chunk-scan entry, and 3,104 ``rmsnorm``
                      launches around the served request, prefill ms, decode
                      tok/s, peak memory, a profiled prefill and decode step,
                      and f32 teacher-forced logits through the kernels and
                      through ``plain=True``; then [profile ssd_chunked]: one
                      block's prefill, device ms and launches per pass of
                      ``ssd_chunked`` (its profiler ranges), the
                      non-vectorised elementwise launches named;
  9b. slice-hybrid -- the same for full-width zamba2-2.7b (54 Mamba2 blocks and
                      one shared attention + MLP block after every 6, its
                      attention at head dim 80): exactly 9 attention, 54 fused
                      ``ssd_scan`` (0 intra) and 127 x 32 = 4,064 rmsnorm
                      launches around the served request; f32 teacher-forced
                      logits through the kernels and through ``plain=True``;
  9c. slice-moe    -- the same for full-width qwen2-moe-a2.7b (24 layers of MHA
                      attention at head dim 128 and 60 routed top-4 + 4 shared
                      experts): exactly 24 attention and 1,568 rmsnorm launches
                      a request, the moe layers' device time as categories of
                      their own; and for mixtral-8x22b at full width with its
                      depth cut to 2 of 56 layers, one 4,608-token prompt past
                      its 4,096 window and 8 tokens: 2 attention and 40
                      rmsnorm launches, the (token, expert) pairs each layer
                      dropped (groups of 512 keep 160 an expert).  The f32
                      logits check pins the plain path's experts to the
                      kernel path's, then runs the plain path unpinned: each
                      routing that differs with no difference upstream must
                      be a near tie (K-th-place gap within 1e-4);
  9d. slice-vlm    -- the same for full-width paligemma-3b (18 layers, MQA 8/1
                      at head dim 256, a tied vocab of 257,216): 8 prompts of
                      256 seeded patch embeddings (the stubbed vision tower's
                      output) + 244 text tokens, 32 new tokens; exactly 18
                      attention and 1,184 rmsnorm launches a request;
  9e. slice-audio  -- full-width hubert-xlarge (48 non-causal encoder layers,
                      head dim 80), whose path is ``forward``: 8 x 500 seeded
                      frames (the stubbed feature extractor's output) under
                      inference mode, exactly 48 attention and 97 rmsnorm
                      launches, wall and device busy, peak memory, a profiled
                      forward, and f32 logits through the kernels and through
                      ``plain=True``;
 10. train-demo    -- ``train_demo()`` (the multi-model coded MLP training of
                      ``launch/train.py --demo``) for gc, sr-sgc, m-sgc and
                      uncoded: every decoded gradient against the full-batch
                      one, and one ``coded_combine`` launch per encode and
                      decode the driver made;
 11. train-full    -- ``VectorizedCodedTrainer`` on full-width qwen2-0.5b in
                      bf16 (2 models, 8 workers, 4 jobs, GE stragglers) for gc
                      and m-sgc: simulated clock, coded-step time, peak memory,
                      exact launches per step (each layer body rematerialised:
                      its forward kernels run again in the backward), finite
                      losses; a profiled step; GC's step profiled with and
                      without remat, in turns; how often the RMSNorm
                      backward's dy came non-contiguous;
                      then one f32 coded gradient at 2 layers (full widths and
                      vocab) against the full-batch gradient and the plain path;
 11b. slice-ssm-train -- the same trainer at full mamba2-1.3b width over
                      sequences of 256 tokens (4 chunks of 64): exactly 96 /
                      48 fused-scan forward / backward and 193 / 97 RMSNorm
                      launches a step, 0 attention and 0 intra, finite losses,
                      step ms, peak memory, a profiled step; then
                      ``train_arch("mamba2-1.3b", full=True, coded=True)``, 3
                      steps; then loss_fn's f32 gradient at full width cut to
                      2 layers, 2 x 500 tokens, kernels against plain=True;
 11c. slice-hybrid-train -- ``train_arch("zamba2-2.7b", full=True, coded=True)``,
                      3 steps: exactly 108 / 54 fused-scan, 18 / 9 attention
                      (head dim 80) and 253 / 127 RMSNorm launches a step,
                      finite losses, step ms, peak memory;
 11d. slice-moe-train -- the same trainer at full qwen2-moe-a2.7b width, its
                      depth the largest at which two models' training state
                      and a step's activations (read from train-full's GC
                      peak) fit the card, the reckoning printed: exactly 2L /
                      L attention (head dim 128) and 4L+1 / 2L+1 RMSNorm
                      launches a step, each layer's routing recorded once a
                      step and no (token, expert) pair dropped (each coded
                      chunk is its own capacity groups), a profiled step with
                      the moe layers as categories; two identical bf16 coded
                      gradients bit for bit the same; the launch entry point's
                      uncoded and (4, 1)-GC steps at that depth and at full
                      mixtral-8x22b width cut to 1 layer (the uncoded group of
                      512 tokens drops pairs, the coded chunks none); then the
                      f32 coded gradient at 2 layers against the plain path,
                      routing pinned, and against the sum of each chunk's
                      chunk_loss_sum gradient, each chunk in its own forward;
 11e. slice-vlm-train -- ``make_coded_train_step`` on one full-width, full-depth
                      paligemma-3b (18 layers, MQA 8/1 at head dim 256, tied
                      vocab of 257,216) in bf16: sequences of 256 seeded patch
                      embeddings + 64 text tokens, GC (s 3, 64 sequences a
                      step) and M-SGC (B 1, W 2, lambda 2, 48), 3 steps each:
                      exactly 36 / 18 attention and 73 / 37 RMSNorm launches
                      a step, finite losses, step ms, the peak beside the
                      printed reckoning and under TRAIN_MEMORY_SHARE, a
                      profiled step; two identical bf16 coded gradients bit
                      for bit the same; the f32 coded gradient at 2 layers
                      against the plain path and against the sum of each
                      chunk's chunk_loss_sum gradient;
 12. gate_window   -- both gate-window kernels against their plain versions,
                      exact, over windows of 0-32 rows (every row bucket's
                      edges), ragged n, (4096, 3, 256) and 5,000 cells (past
                      one wave of blocks), strided, misaligned and stride-2
                      views (the byte path); fails unless the gate's
                      own tails and concatenated windows at (64, rows, 256)
                      take the wide path (16-byte loads);
 13. sim           -- ``simulate_batch`` on the Table-1 grid (n 256, 4 schemes,
                      and the clustered baselines dc-gc and sb-gc at C 4, s 32;
                      64 Gilbert-Elliott traces of 44 rounds) in both wait-outs,
                      on the card and on the CPU: equal under the simulator's
                      device contract, and equal to the descriptor ``simulate``
                      on 4 traces; the kernels launch exactly as often as the
                      CPU run calls their plain versions, all on the wide
                      path.  Wall per scheme, host syncs per round, a profiled
                      run's busy time per round;
 14. grid          -- grid fusion: m-sgc's whole App.-J grid (``default_grid``
                      at n 256, 132 candidates in 4 shape buckets) over the
                      same 64 traces x 44 rounds, both wait-outs: fused on the
                      card equals ``fuse=False`` on the card bit for bit and
                      the fused CPU run under the device contract; gate-window
                      launches = the CPU run's plain calls, all wide.  Both
                      walls, round loops, host syncs per bucket-round, and a
                      profiled fused run's busy time per bucket-round;
     select        -- App.-J ``select_parameters`` on the card for m-sgc and gc
                      at n 256 (30-round probe), grid-fused and with
                      ``REPRO_GRID_FUSE=0`` (walls and round loops of both),
                      the same candidate, which equals
                      ``select_parameters_legacy``'s;
 15. adaptive      -- ``run_adaptive`` at Fig. 18's configuration (n 64, 60 jobs,
                      a 20-round uncoded probe, 4 models) beats never switching;
 16. scenarios     -- ``launch.scenarios.scenario_sweep`` (Sec. 6) at n 256 over
                      ``trace_library(256, 40, 16)``'s seven scenarios with
                      ``scheme_grid(256)``'s 7 schemes, on the card and on the
                      CPU: every cell equal under the device contract, the
                      equal-load and dominance gates, gate-window launches =
                      the CPU's plain calls, all wide; wall per scenario and
                      each scheme's mean per-job time;
 17. multimodel    -- ``multimodel_training`` (examples/multimodel_training.py)
                      at 64 workers, 4 models, batch 256, 16 jobs, 7 schemes:
                      every decoded gradient against the full-batch one, and
                      one ``coded_combine`` launch per encode and decode;
 18. coded-train   -- ``coded_train`` (benchmarks/run.py coded-train) at full
                      qwen2-0.5b width in bf16: 7 schemes x {ge-bursty,
                      replayed-waves}, 2 models, n 8, batch 32 x 64 tokens, 8
                      jobs; simulated clocks, step ms, peak memory, exact
                      launches per step, its three gates; a profiled dc-gc step;
 18b. harness      -- ``repro_torch.dist.run_harness`` (the paper's master and
                      worker processes): 4 grad-mode worker processes on the
                      card compute chunk gradients of full-width qwen2-0.5b cut
                      to 2 of 24 layers, in f32 (a 664 MB vector a task, over
                      pipes), and GC-encode them in one coded_combine launch an
                      item; the master gates on the wall clock, decodes 4 jobs
                      and holds each to its full-batch gradient on the card
                      (decode_atol from a printed reckoning), on the GE-bursty
                      trace of examples/dist_execution.py: GC (s 1), M-SGC (B 1,
                      W 3, lambda 4), and GC with worker 0 killed after round 2
                      and one respawn, whose replacement must rejoin.  First an
                      in-process TaskComputer: exact launches of a GC row, an
                      M-SGC d1 part and a d2 row, their values against the plain
                      path, one reply's time through a pipe; the memory
                      reckoning; then per run the rounds, measured and analytic
                      makespan, each round's compute, wire legs and injected
                      delay, the master's launches (its truth, exact), the
                      fault-free runs' patterns replayed bit for bit by
                      simulate_fast and by simulate_lockstep on the card (its
                      gate launches = the CPU's plain calls), and the card's
                      compute processes mid-run (the master and 4 workers);
 19. timings      -- each kernel, its plain version and the nearest PyTorch
                      library call at the main path's shapes: device time from
                      the profiler (CUDA events per call beside it), the least
                      time the card could take (published H100 peaks), achieved
                      rates and share of that bound; attention in bf16 and f32
                      at the prefill's and the coded step's shapes, with SDPA
                      (or its autograd) and each kernel's ptxas line, at
                      head dim 80 at zamba2-2.7b's prefill shape, the bf16
                      backward at qwen2-moe-a2.7b's coded step's (128, 16, 64,
                      128), and its forward at qwen2-moe-a2.7b's (8, 16, 500,
                      128), at
                      paligemma-3b's (8, 8, 500, 256) with kv (8, 1, 500,
                      256), causal, and hubert-xlarge's non-causal (8, 16,
                      500, 80); both
                      ssd_scan entries, the fused one beside the torch passes
                      it replaces; both gate-window kernels also at (4096, 3,
                      256), each beside a one-element fill_ (the launch floor)
                      in one profiler session, and the wrappers' four output
                      allocations against one carved into the four; the
                      RMSNorm backward at the GC and M-SGC coded steps'
                      (8192, 896) and (3072, 896), bf16 and f32, with the
                      same kernel built without its dgamma tail and the same
                      bytes through torch.add beside it; the SSD backward at
                      [slice-ssm-train]'s shape beside the plain backward and
                      autograd of the plain forward, and each of its three
                      launches' device time; the bf16 attention backward at
                      head dim 256 at [slice-vlm-train]'s GC shape (64, 8,
                      320, 256), kv (64, 1, 320, 256), and at one 64-key
                      tile (64, 8, 64, 256), beside autograd of its plain
                      version and of SDPA; the bf16 attention forward and
                      backward at head dim 64 at [launch]'s step shape (8,
                      14, 4096, 64), kv (8, 2, 4096, 64), 64 key tiles,
                      beside SDPA and its autograd (printed, not in the
                      kernels line).
The line before the last is nvidia-smi's name and power limit again; the
last line is ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the repository's sources; it imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32": 67e12}

ARCH = "qwen2-0.5b"
DENSE_ARCHS = (ARCH, "llama3.2-1b")   # [slice] serves both
SSM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "zamba2-2.7b"
MOE_ARCH = "qwen2-moe-a2.7b"
VLM_ARCH = "paligemma-3b"
AUDIO_ARCH = "hubert-xlarge"
# mixtral-8x22b at full width with its depth cut to 2 of 56 layers (281 GB of
# bf16 weights at 56), one prompt longer than its window of 4,096: groups of
# 512 tokens keep at most 160 (token, expert) pairs an expert (moe_groups)
MIXTRAL = dict(arch="mixtral-8x22b", layers=2, batch=1, prompt=4608, new_tokens=8)
# a routing that differs between the kernel and plain paths with no earlier
# difference upstream must be a near tie: its K-th minus (K+1)-th probability
ROUTE_GAP_TOL = 1e-4
BATCH, PROMPT_LEN, NEW_TOKENS = 8, 500, 32
MAX_SEQ = PROMPT_LEN + NEW_TOKENS
LOGIT_TOL = 2e-3          # tests/test_prefill.py's prefill/decode tolerance
RMSNORM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}   # tests/test_kernels.py
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}       # tests/test_kernels.py
# the bf16 (tensor-core) attention kernels' edges, forward and backward:
# (b, hq, hkv, sq, sk, dh, causal, window, valid_k) as (b, s, h, dh) views --
# head dims 32/64/128, single-row and ragged q tiles, sq != sk with valid_k <
# sk, windows 32/96/200, GQA groups 1, 2, 7, 8, non-causal, and queries from
# 131 on that window 32 plus valid_k 100 leave without a key
ATTN_BF16_EDGES = [
    *[(2, 4, 2, 64, 64, dh, True, 0, None) for dh in (32, 64, 128)],
    *[(2, 14, 2, sq, sq, 64, True, 0, None) for sq in (1, 33, 64, 500)],
    (2, 14, 2, 100, 300, 64, False, 0, 250),
    (2, 7, 1, 300, 180, 128, True, 0, 150),
    (2, 8, 2, 200, 77, 128, False, 0, None),
    *[(1, 4, 2, 256, 256, 64, True, w, None) for w in (32, 96, 200)],
    *[(2, 2 * group, 2, 130, 130, 64, True, 0, None) for group in (1, 2, 7, 8)],
    *[(1, 4, 2, 300, 300, 64, causal, 32, 100) for causal in (False, True)],
]
# the same edges at zamba2-2.7b's head dim 80, and its served layout: q, k and
# v (8, 32, 500, 80) views of the (8, 500, 32, 80) projections, causal
ATTN_DH80_CASES = list(dict.fromkeys(c[:5] + (80,) + c[6:] for c in ATTN_BF16_EDGES))
ATTN_DH80_SERVED = (BATCH, 32, 32, PROMPT_LEN, PROMPT_LEN, 80, True, 0, None)
# the moe slice's served attention at head dim 128: qwen2-moe-a2.7b's MHA 16/16
# prefill, and mixtral-8x22b's GQA 48/8 prompt under its window of 4,096
ATTN_DH128_SERVED = (BATCH, 16, 16, PROMPT_LEN, PROMPT_LEN, 128, True, 0, None)
ATTN_MIXTRAL_SERVED = (1, 48, 8, MIXTRAL["prompt"], MIXTRAL["prompt"], 128, True, 4096, None)
# paligemma-3b's prefill at head dim 256: MQA 8/1 over its 500 positions (256
# patch embeddings and 244 text tokens), and the bf16 edges at 256; hubert-
# xlarge's encoder: MHA 16/16 at head dim 80, non-causal, over 500 frames (10 s
# of audio at its 20 ms frame rate)
ATTN_DH256_SERVED = (BATCH, 8, 1, PROMPT_LEN, PROMPT_LEN, 256, True, 0, None)
ATTN_DH256_CASES = list(dict.fromkeys(c[:5] + (256,) + c[6:] for c in ATTN_BF16_EDGES))
ATTN_AUDIO_SERVED = (BATCH, 16, 16, PROMPT_LEN, PROMPT_LEN, 80, False, 0, None)
# [launch]'s step: qwen2-0.5b's GQA 14/2 at head dim 64 over 8 x 4,096 tokens
ATTN_LAUNCH = (8, 14, 2, 4096, 4096, 64, True, 0, None)
GC_TOL = {"float32": 1e-5, "bfloat16": 3e-2}         # tests/test_kernels.py
SSD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}        # tests/test_ssd_kernel.py
# the SSD backward against the plain backward and autograd: rtol, and atol times
# the output's largest magnitude (sums of up to thousands of f32 terms in
# another order; for bf16 inputs dx, dB and dC are rounded to bf16 once)
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# f32 gradients, kernels against plain autograd: sums over thousands of rows
# taken in other orders (tests/test_torch_kernels.py GRAD_TOL)
RMSNORM_BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# train-demo: decoded gradient sums over 256 examples (entries up to ~1e2)
# against the direct full-batch gradient, in f32
DECODE_TOL = 1e-3
# train-full's f32 coded gradient at 2 layers: weighted sums of 32 chunk
# gradients with GC coefficients up to ~5 against the full-batch gradient
# (tests/test_coded_master.py's rtol; a looser atol for the 151936-row embedding)
CODED_GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
DEMO_SCHEMES = ("gc", "sr-sgc", "m-sgc", "uncoded")
DEMO_JOBS = 8
TRAIN = dict(n=8, models=2, batch=32, seq=64, jobs=4)
TRAIN_SCHEMES = {"gc": dict(s=3, prefer_rep=False), "m-sgc": dict(B=1, W=2, lam=2)}
# GC's coded view of a job: n workers x (s+1) slots x batch/n sequences
TRAIN_SEQS = TRAIN["n"] * (TRAIN_SCHEMES["gc"]["s"] + 1) * TRAIN["batch"] // TRAIN["n"]
TRAIN_ROWS = TRAIN_SEQS * TRAIN["seq"]
# M-SGC's coded view (B 1, W 2, lambda 2): 48 sequences a step
MSGC_ROWS = 48 * TRAIN["seq"]
# [slice-moe-train]: qwen2-moe-a2.7b's attention in GC's coded step, q, k, v
# (128, 16, 64, 128) causal, and in M-SGC's (48 sequences); the trainer's
# depth, fixed so that the cell compares across changes (two models' training
# state is 56.0 GB at 3 layers, 69.7 GB at 4, see _slice_moe_train); the depth
# of the f32 gradient checks; mixtral-8x22b cut to 1 layer (one model's
# training state, ~35 GB)
ATTN_DH128_TRAIN = (TRAIN_SEQS, 16, 16, TRAIN["seq"], TRAIN["seq"], 128, True, 0, None)
ATTN_DH128_MSGC = (MSGC_ROWS // TRAIN["seq"], *ATTN_DH128_TRAIN[1:])
MOE_TRAIN = dict(layers=3, grad_layers=2, mixtral_layers=1)
# [slice-vlm-train]: paligemma-3b at full width and depth, one model (two
# models' training state alone is 60.2 GB); a sequence is 256 seeded patch
# embeddings then 64 text tokens, the labels the text.  GC's job batch is 16
# (64 sequences a coded step: at TRAIN's 32 the head's logits, their sliced
# gradient and the text's f32 log-softmax would take ~59 GB beside 30.1 GB of
# state, past TRAIN_MEMORY_SHARE), M-SGC's 32, the least its grid of 32 chunks
# divides (48 sequences); the reckoning is printed beside the measured peaks.
# The f32 gradient checks at 2 layers over GC's view of a job of 8.
VLM_TRAIN = dict(text=64, batch={"gc": 16, "m-sgc": 32}, steps=3, grad_layers=2, grad_batch=8)
VLM_SEQ = 256 + VLM_TRAIN["text"]
VLM_SEQS = {"gc": (TRAIN_SCHEMES["gc"]["s"] + 1) * VLM_TRAIN["batch"]["gc"],
            "m-sgc": 48 * VLM_TRAIN["batch"]["m-sgc"] // TRAIN["batch"]}
# its attention in the GC and M-SGC coded steps, MQA 8/1 at head dim 256, and
# the GC step's shape cut to one 64-key tile (the dq kernel's first pass for D
# runs over more than one of its 16-key tiles: timed at both)
ATTN_DH256_TRAIN = (VLM_SEQS["gc"], 8, 1, VLM_SEQ, VLM_SEQ, 256, True, 0, None)
ATTN_DH256_MSGC = (VLM_SEQS["m-sgc"], *ATTN_DH256_TRAIN[1:])
ATTN_DH256_TILE = (VLM_SEQS["gc"], 8, 1, 64, 64, 256, True, 0, None)
# the share of the card's memory a trainer run's peak may fill
TRAIN_MEMORY_SHARE = 0.9
# [launch]: the sharded train step at full qwen2-0.5b width and depth over
# sequences of train_4k's length, three steps; the GC step as [train-full]'s
LAUNCH = dict(seq=4096, steps=3, seed=7, coded_seq=TRAIN["seq"])
# the simulator: benchmarks/run.py's Table-1 grid (PARAMS, the GE chain calibrated
# to Fig. 1, 64 traces of 44 rounds at n 256, alpha 8 = the source's slope)
SIM = dict(n=256, traces=64, rounds=44, alpha=8.0, seed0=60, parity_traces=4)
SIM_GE = dict(p_ns=0.035, p_sn=0.85, slow_factor=6.0, jitter=0.05)
SIM_PARAMS = {"m-sgc": dict(B=2, W=3, lam=27), "sr-sgc": dict(B=2, W=3, lam=23),
              "gc": dict(s=15), "uncoded": {},
              # the clustered baselines at scheme_grid(256)'s operating point
              "dc-gc": dict(C=4, s=32), "sb-gc": dict(C=4, s=32)}
# App.-J selection: benchmarks/run.py's small grids on a 30-round probe
SELECT_GRIDS = {
    "m-sgc": [{"B": B, "W": W, "lam": lam} for B, W in ((1, 2), (2, 3))
              for lam in (8, 16, 24, 27, 32)],
    "gc": [{"s": s} for s in (4, 8, 12, 15, 20, 24)],
}
# Sec. 6: the scenario sweep at the paper's cluster size over the trace library,
# with scheme_grid(256)'s 7 schemes as the specs (benchmarks/run.py scenario-sweep)
SCENARIOS = dict(n=256, rounds=40, traces=16, seed=0)
# the multi-model experiment of examples/multimodel_training.py over 16 jobs
MULTIMODEL = dict(jobs=16, workers=64, models=4)
# [slice-ssm-train]: TRAIN's trainer at full mamba2-1.3b width over sequences
# of 256 tokens, 4 of its 64-token chunks, so that the state entering a chunk
# (h_prev) is not 0 and the backward's inter-chunk terms run
SSM_TRAIN_SEQ = 256
# the f32 gradient of mamba2-1.3b at full width, 2 layers, 2 x 500 tokens (8
# chunks, the last padded), kernels against plain=True
SSM_GRAD = dict(layers=2, batch=2, seq=500)
# bench_coded_train at full qwen2-0.5b width, [train-full]'s shapes
CODED_TRAIN = dict(n=8, models=2, jobs=8, seq=64)
# [harness]: run_harness with grad-mode workers at full qwen2-0.5b width, its
# depth cut to 2 of 24 layers, in f32: 165,960,320 parameters, a 664 MB
# gradient vector through the pipes per task (the tied embedding alone is 545
# MB; full depth would be 1.98 GB a vector and about 95 GB through the pipes
# over the two fault-free runs).  4 worker processes on the card and 4 jobs of
# 32 x 64 tokens (a GC chunk is 8 sequences), over pipes: a vector is 10x the
# TCP wire's 64 MiB frame bound, so TCP is held on the CPU.
HARNESS = dict(layers=2, n=4, jobs=4, batch=32, seq=64, seed=0, time_scale=0.02)
# the GE-bursty trace of examples/dist_execution.py
HARNESS_GE = dict(seed=0, p_ns=0.09, p_sn=0.5, slow_factor=6.0, jitter=0.05)
HARNESS_RUNS = (("gc", {"s": 1}), ("m-sgc", {"B": 1, "W": 3, "lam": 4}))
# the third run: GC with worker 0 killed after round 2 and one respawn
HARNESS_KILL = dict(worker=0, kill_after=2, respawns=1)
# decode tolerance, relative to the largest entry of a job's full-batch f32
# gradient: the decode sums the workers' f32 vectors, each a sum over chunk
# gradients taken in other orders than the full batch's (2,048 token rows: about
# sqrt(2048) * 2^-24 = 2.7e-6 relative), under decode weights of magnitude <= 2
# and coefficients <= 1 (GC s 1, M-SGC lambda n: 0/1 sums), so ~1e-5 relative;
# 1e-4 leaves 10x
HARNESS_DECODE_REL = 1e-4
# host memory the harness may plan to hold: its vectors' reckoning must fit
# this share of MemAvailable at the phase's start
HARNESS_HOST_SHARE = 0.8
# Fig. 18: run_adaptive's switch from uncoded to m-sgc (benchmarks/run.py)
ADAPTIVE = dict(n=64, J=60, t_probe=20, models=4, seed=11,
                grid=[{"B": B, "W": B + 1, "lam": lam} for B in (1, 2) for lam in (8, 16, 24)])


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """``attn_fwd_bf16_kernel<64>`` from a kernel's mangled name (its innermost
    name and template arguments); the name cut to 70 characters where it does
    not parse."""
    m, i = mangled, 2

    def number(i):
        j = i
        while m[j].isdigit():
            j += 1
        return int(m[i:j]), j

    try:
        if m[i] == "N":
            i += 1
        name = ""
        while m[i].isdigit():
            n, i = number(i)
            name, i = m[i:i + n], i + n
        if m[i] == "I":
            args, i = [], i + 1
            while m[i] != "E":
                if m[i] == "L":  # a literal: L<type><value>E
                    j = m.index("E", i)
                    args.append(m[i + 2:j])
                    i = j + 1
                elif m[i].isdigit():
                    n, i = number(i)
                    args.append(m[i:i + n])
                    i += n
                elif m[i] == "S":  # a substitution: S_, S0_, ...
                    j = m.index("_", i)
                    args.append(m[i:j + 1])
                    i = j + 1
                else:
                    args.append({"f": "float", "b": "bool", "i": "int"}.get(m[i], m[i]))
                    i += 1
            name += "<" + ", ".join(args) + ">"
        return name or m[:70]
    except (IndexError, ValueError):
        return m[:70]


def ptxas_info(log: str) -> dict[str, str]:
    """Kernel label -> its registers, shared memory and spills (nvcc -Xptxas -v)."""
    info, name, spill = {}, None, ""
    for raw in log.splitlines():
        if "Compiling entry function" in raw:
            name = raw.split("'")[1]
        elif "spill" in raw:
            spill = raw.strip()
        elif "Used" in raw and name:
            info[kernel_label(name)] = f"{raw.split(':', 1)[1].strip()}; {spill}"
            name, spill = None, ""
    return info


def sass_hmma_counts(lib: Path, nvcc: str) -> dict[str, int]:
    """Kernel label -> HMMA (tensor-core) instructions in its SASS (cuobjdump)."""
    tool = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = kernel_label(line.split("Function :", 1)[1].strip())
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch.nn.functional as F

        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention.flash_attention import flash_attention as fa_kernel
        from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd as fa_bwd
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.gc_coding import ref as gc_ref
        from repro_torch.kernels.gc_coding.gc_coding import coded_combine as gc_kernel
        from repro_torch.kernels.rmsnorm import ref as rn_ref
        from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm as rn_kernel
        from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan as scan_kernel
        from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk as ssd_kernel
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    say("device", f"{kind}; count {count}; nvidia-smi: {smi}; torch {torch.__version__} "
                  f"cuda {torch.version.cuda}")

    # 2. build
    info = _build.build()
    say("build", f"{info.path.relative_to(ROOT)} in {info.seconds:.1f} s")
    ptxas = ptxas_info(info.ptxas_log)
    for label, line in ptxas.items():
        say("build", f"{label}: {line}")
    # the bf16 attention kernels run on the tensor cores, without spills at the
    # model's head dim
    hmma = sass_hmma_counts(info.path, _build._nvcc())
    attn = {label: n for label, n in sorted(hmma.items()) if label.startswith("attn_")}
    say("build", f"HMMA instructions in the SASS: {attn}")
    bf16_attn = [label for label in attn if "_bf16_kernel<" in label]
    if len(bf16_attn) != 15 or not all(attn[label] for label in bf16_attn):
        fail(f"the bf16 attention kernels' SASS lacks tensor-core instructions: {attn}")
    # ... and so do both products of the bf16 SSD chunk scan
    ssd = {label: n for label, n in sorted(hmma.items()) if label.startswith("ssd_")}
    say("build", f"HMMA instructions in the SASS: {ssd}")
    bf16_ssd = [label for label in ssd if label.startswith("ssd_bf16_kernel<")]
    if len(bf16_ssd) != 12 or not all(ssd[label] for label in bf16_ssd):
        fail(f"the bf16 ssd_scan kernels' SASS lacks tensor-core instructions: {ssd}")
    # both gate-window kernels in every row bucket (<= 4, 8, 16, 32), unspilled
    gate = {label: line for label, line in ptxas.items()
            if label.startswith(("window_stats_kernel<", "buffer_stats_kernel<"))}
    if len(gate) != 8 or any("0 bytes spill stores, 0 bytes spill loads" not in line
                             for line in gate.values()):
        fail(f"the gate-window kernels spill or lack a row bucket: {gate}")
    # the RMSNorm backward in every bucket and on both paths, unspilled
    rn_bwd_built = {label: line for label, line in ptxas.items()
                    if label.startswith(("rmsnorm_bwd_kernel<", "rmsnorm_bwd_chunked_kernel<"))}
    if len(rn_bwd_built) != 24 or any("0 bytes spill stores, 0 bytes spill loads" not in line
                                      for line in rn_bwd_built.values()):
        fail(f"the RMSNorm backward kernels spill or lack a bucket: {rn_bwd_built}")
    # the SSD backward, three launches each: on the CUDA cores (f32, and bf16
    # inputs with an f32 dy; intra 1-3 causal tiles a thread) and on the tensor
    # cores (bf16: inter at 128- and 64-column state tiles and Q 128, intra at
    # Q 64 and 128 and head dims 32, 64, 128, finish), all unspilled, and the
    # bf16 ones' SASS holds HMMA
    ssd_bwd_built = {label: line for label, line in ptxas.items()
                     if label.startswith("ssd_bwd_")}
    say("build", f"the SSD backward's kernels: {ssd_bwd_built}")
    if len(ssd_bwd_built) != 20 or any("0 bytes spill stores, 0 bytes spill loads" not in line
                                       for line in ssd_bwd_built.values()):
        fail(f"the SSD backward kernels spill or lack an instantiation: {ssd_bwd_built}")
    bf16_ssd_bwd = {label: hmma.get(label, 0) for label in ssd_bwd_built
                    if "_bf16_kernel" in label}
    say("build", f"HMMA instructions in the SASS of the bf16 SSD backward: {bf16_ssd_bwd}")
    if len(bf16_ssd_bwd) != 10 or not all(bf16_ssd_bwd.values()):
        fail(f"the bf16 SSD backward kernels' SASS lacks tensor-core instructions: "
             f"{bf16_ssd_bwd}")
    dh256 = ["attn_fwd_bf16_kernel<256>", "attn_bwd_dq_bf16_kernel<256>",
             "attn_bwd_dkdv_bf16_kernel<256>", "attn_bwd_dq_kernel<float, 256>",
             "attn_bwd_dkdv_kernel<float, 256>"]
    for label in (*[f"{k}<{dh}>" for dh in (64, 80) for k in (
                      "attn_fwd_bf16_kernel", "attn_bwd_dq_bf16_kernel",
                      "attn_bwd_dkdv_bf16_kernel")],
                  *dh256,
                  *[label for label in bf16_ssd if ", 64, " in label]):
        if "0 bytes spill stores, 0 bytes spill loads" not in ptxas.get(label, ""):
            fail(f"{label} spills at its model's head dim: {ptxas.get(label)}")
    for label in (*dh256, "attn_fwd_kernel<float, 256>", "attn_bwd_dq_bf16_kernel<128>",
                  "attn_bwd_dkdv_bf16_kernel<128>"):
        say("build", f"{label}: {ptxas.get(label)}; HMMA {hmma.get(label)}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs: dict[str, float] = {}

    def compare(phase, name, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        say(phase, f"{name}: max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{phase} {name}: kernel disagrees with the plain version")
        return err

    # 3. rmsnorm kernel vs plain, at every width a serving slice runs it (the
    # moe slice's prefill and decode rows too, and hubert-xlarge's forward),
    # at qwen2-moe-a2.7b's GC and M-SGC coded steps, and a few others
    for rows, d in [(BATCH * PROMPT_LEN, 896), (BATCH, 896), (130, 640), (1, 8192),
                    (BATCH * PROMPT_LEN, 2048), (BATCH, 2048), (TRAIN_ROWS, 2048),
                    (MSGC_ROWS, 2048), *[(n * VLM_SEQ, 2048) for n in VLM_SEQS.values()],
                    (MIXTRAL["batch"] * MIXTRAL["prompt"], 6144), (MIXTRAL["batch"], 6144),
                    (BATCH * PROMPT_LEN, 1280)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(rows, d, dtype=dtype)
            for gdtype in sorted({torch.float32, dtype}, key=str):
                g = randn(d, dtype=gdtype)
                tol = RMSNORM_TOL[str(dtype).split(".")[1]]
                err = compare("rmsnorm", f"({rows}, {d}) {dtype} gamma {gdtype}",
                              rn_kernel(x, g), rn_ref.rmsnorm(x, g), tol)
                if (rows, d, dtype, gdtype) == (BATCH * PROMPT_LEN, 896, torch.bfloat16,
                                                torch.bfloat16):
                    errs["rmsnorm"] = err
    torch.cuda.synchronize()

    # 4. attention kernel vs plain
    def heads_view(b, h, s, dh, dtype):
        """(b, h, s, dh) view of a (b, s, h, dh) buffer, as the model passes it."""
        return randn(b, s, h, dh, dtype=dtype).transpose(1, 2)

    cases = [  # b, hq, hkv, sq, sk, dh, causal, window, valid_k, dtype, strided
        (BATCH, 14, 2, PROMPT_LEN, PROMPT_LEN, 64, True, 0, None, torch.float32, True),
        (BATCH, 14, 2, PROMPT_LEN, PROMPT_LEN, 64, True, 0, None, torch.bfloat16, True),
    ]
    for b, hq, hkv, sq, sk, dh in [(1, 4, 2, 256, 256, 64), (2, 8, 8, 128, 128, 32),
                                   (1, 8, 1, 128, 256, 64), (1, 4, 4, 384, 384, 128)]:
        for causal in (True, False):
            cases.append((b, hq, hkv, sq, sk, dh, causal, 0, None, torch.float32, False))
    for window in (32, 96, 200):
        cases.append((1, 4, 2, 256, 256, 64, True, window, None, torch.float32, False))
    cases += [
        (1, 2, 2, 200, 200, 64, False, 0, None, torch.float32, False),
        (1, 4, 2, 256, 256, 64, False, 0, 200, torch.float32, False),
        (1, 4, 2, 128, 128, 64, True, 0, None, torch.bfloat16, False),
        (1, 14, 2, 200, 200, 64, True, 0, None, torch.float32, True),
    ]
    cases += [c + (torch.bfloat16, True) for c in ATTN_BF16_EDGES]
    cases += [c + (dtype, True) for c in (ATTN_DH80_SERVED, *ATTN_DH80_CASES)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [c + (dtype, True) for c in (ATTN_DH128_SERVED, ATTN_MIXTRAL_SERVED,
                                          ATTN_DH128_TRAIN, ATTN_DH128_MSGC,
                                          ATTN_DH256_SERVED, *ATTN_DH256_CASES,
                                          ATTN_DH256_TRAIN, ATTN_DH256_MSGC,
                                          ATTN_AUDIO_SERVED)
              for dtype in (torch.float32, torch.bfloat16)]
    for b, hq, hkv, sq, sk, dh, causal, window, valid_k, dtype, strided in cases:
        if strided:
            q, k, v = (heads_view(b, hq, sq, dh, dtype), heads_view(b, hkv, sk, dh, dtype),
                       heads_view(b, hkv, sk, dh, dtype))
        else:
            q, k, v = (randn(b, hq, sq, dh, dtype=dtype), randn(b, hkv, sk, dh, dtype=dtype),
                       randn(b, hkv, sk, dh, dtype=dtype))
        kw = dict(causal=causal, window=window, valid_k=valid_k)
        err = compare(
            "attention",
            f"q {tuple(q.shape)} kv {tuple(k.shape)} {dtype} {kw}{' strided' if strided else ''}",
            fa_kernel(q, k, v, **kw), fa_ref.attention(q, k, v, **kw),
            ATTN_TOL[str(dtype).split(".")[1]],
        )
        if (b, sq, dtype) == (BATCH, PROMPT_LEN, torch.bfloat16):
            errs[_attn_err_key(dh, causal)] = err
    torch.cuda.synchronize()

    cfg = get_config(ARCH)

    # 5. gc_coding kernel vs plain: tests/test_kernels.py's sweep, and the
    # --demo MLP's gradient size (9,610 values)
    for k in (1, 3, 16, 28):
        for d in (128, 1000, 9610, 16384, 40000):
            for dtype in (torch.float32, torch.bfloat16):
                parts, w = randn(k, d, dtype=dtype), randn(k)
                err = compare("gc_coding", f"k {k} d {d} {dtype}", gc_kernel(parts, w),
                              gc_ref.coded_combine(parts, w), GC_TOL[_dtype_name(dtype)])
                if (k, d, dtype) == (28, 40000, torch.bfloat16):
                    errs["coded_combine"] = err
    torch.cuda.synchronize()

    # 6. backward kernels vs the plain versions' autograd, at the training
    # shapes (the coded GC and M-SGC views) and a few others
    errs["rmsnorm_bwd"] = _rmsnorm_bwd_check(dev, cfg, randn, compare)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    bwd_cases = [  # b, hq, hkv, sq, sk, dh, causal, window, valid_k, dtype
        (TRAIN_SEQS, hq, hkv, TRAIN["seq"], TRAIN["seq"], dh, True, 0, None, torch.float32),
        (TRAIN_SEQS, hq, hkv, TRAIN["seq"], TRAIN["seq"], dh, True, 0, None, torch.bfloat16),
        (2, hq, hkv, 33, 33, dh, True, 0, None, torch.float32),
        (1, 4, 2, 256, 256, dh, True, 96, None, torch.float32),
        (1, 8, 1, 200, 200, dh, False, 0, None, torch.float32),
    ] + [c + (torch.bfloat16,) for c in ATTN_BF16_EDGES] + \
        [c + (dtype,) for c in (ATTN_DH80_SERVED, *ATTN_DH80_CASES, ATTN_DH128_TRAIN,
                                ATTN_DH128_MSGC, ATTN_DH256_TRAIN, ATTN_DH256_MSGC,
                                ATTN_DH256_TILE, *ATTN_DH256_CASES)
         for dtype in (torch.float32, torch.bfloat16)]
    for b, h, g_kv, sq, sk, dh_, causal, window, valid_k, dtype in bwd_cases:
        q, do = (heads_view(b, h, sq, dh_, dtype) for _ in range(2))
        k, v = (heads_view(b, g_kv, sk, dh_, dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, valid_k=valid_k)
        out, lse = fa_kernel(q, k, v, return_lse=True, **kw)
        got = fa_bwd(q, k, v, out, lse, do, **kw)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        want = torch.autograd.grad(fa_ref.attention(qr, kr, vr, **kw), (qr, kr, vr), do)
        err = max(compare("attention-bwd", f"{name} q {tuple(q.shape)} kv {tuple(k.shape)} "
                          f"{dtype} {kw}", a, bb, ATTN_TOL[_dtype_name(dtype)])
                  for name, a, bb in zip(("dq", "dk", "dv"), got, want))
        if (b, dh_, dtype) == (TRAIN_SEQS, dh, torch.bfloat16):
            errs["flash_attention_bwd"] = err
        if (b, sq, dh_, dtype) == (BATCH, PROMPT_LEN, 80, torch.bfloat16):
            errs["flash_attention_bwd dh80"] = err
        if (b, h, sq, dh_, dtype) == (*ATTN_DH128_TRAIN[:2], TRAIN["seq"], 128, torch.bfloat16):
            errs["flash_attention_bwd dh128"] = err
        if (b, sq, dh_, dtype) == (ATTN_DH256_TRAIN[0], VLM_SEQ, 256, torch.bfloat16):
            errs["flash_attention_bwd dh256"] = err
    # head dim 256 at the vlm's GC training shape: a second call bit for bit the
    # same (no atomics), in f32 and bf16
    b, h, g_kv, sq = ATTN_DH256_TRAIN[:4]
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (heads_view(b, h, sq, 256, dtype) for _ in range(2))
        k, v = (heads_view(b, g_kv, sq, 256, dtype) for _ in range(2))
        out, lse = fa_kernel(q, k, v, return_lse=True)
        first, second = (fa_bwd(q, k, v, out, lse, do) for _ in range(2))
        if not all(torch.equal(a, bb) for a, bb in zip(first, second)):
            fail(f"attention-bwd: head dim 256 {dtype}: dq, dk or dv changed between calls")
        say("attention-bwd", f"head dim 256 q {tuple(q.shape)} kv {tuple(k.shape)} "
                             f"{_dtype_name(dtype)}: dq, dk, dv bit-identical on a second call")
        del q, do, k, v, out, lse, first, second
    torch.cuda.empty_cache()
    # q = k = v in bf16: a near one-hot softmax, where dP - D cancels on the
    # diagonal; against autograd of the f32 plain version on the same values
    for b, h, g_kv in ((2, 4, 4), (TRAIN_SEQS, hq, hkv)):
        for causal in (True, False):
            kv = heads_view(b, g_kv, TRAIN["seq"], dh, torch.bfloat16)
            q = kv.repeat_interleave(h // g_kv, dim=1)
            do = heads_view(b, h, TRAIN["seq"], dh, torch.bfloat16)
            out, lse = fa_kernel(q, kv, kv, return_lse=True, causal=causal)
            got = fa_bwd(q, kv, kv, out, lse, do, causal=causal)
            leaves = [t.float().requires_grad_(True) for t in (q, kv, kv)]
            want = torch.autograd.grad(fa_ref.attention(*leaves, causal=causal), leaves,
                                       do.float())
            for name, a, bb in zip(("dq", "dk", "dv"), got, want):
                compare("attention-bwd", f"{name} q = k = v {tuple(q.shape)} kv "
                        f"{tuple(kv.shape)} bf16 causal {causal}", a, bb, ATTN_TOL["bfloat16"])
    torch.cuda.synchronize()

    # 7. ssd_scan kernel vs plain, both entries; 7b. the backward kernel
    errs.update(_ssd_check(dev))
    errs.update(_ssd_bwd_check(dev))

    # 8. slice: full-width qwen2-0.5b and llama3.2-1b serving through the
    # port's entry point (the JSON line's launches are qwen2-0.5b's)
    for arch in DENSE_ARCHS:
        L = get_config(arch).num_layers
        got = _serve_slice("slice", dev, get_config(arch),
                           {"flash_attention": fa_kernel, "rmsnorm": rn_kernel},
                           {"flash_attention": L, "rmsnorm": (2 * L + 1) * NEW_TOKENS})
        if arch == ARCH:
            launches = got

    # 9. slice-ssm: the same for full-width mamba2-1.3b
    scfg = get_config(SSM_ARCH)
    L = scfg.num_layers
    # one fused chunk-scan launch a block, none of the intra entry; the
    # ssd_scan row counts both entries of ssd_scan.cu (one kernel template)
    ssm_launches = _serve_slice(
        "slice-ssm", dev, scfg,
        {"ssd_chunk_scan": scan_kernel, "ssd_intra_chunk": ssd_kernel, "rmsnorm": rn_kernel},
        {"ssd_chunk_scan": L, "ssd_intra_chunk": 0, "rmsnorm": (2 * L + 1) * NEW_TOKENS})
    launches["ssd_chunk_scan"] = ssm_launches["ssd_chunk_scan"]
    launches["ssd_scan"] = ssm_launches["ssd_chunk_scan"] + ssm_launches["ssd_intra_chunk"]

    # where one mamba2-1.3b block's prefill time goes, pass by pass
    _profile_ssd_chunked(dev)

    # 9b. slice-hybrid: full-width zamba2-2.7b, the shared block's attention
    # at head dim 80; per forward 2 norms a Mamba2 layer and a shared call, and
    # the final norm
    hcfg = get_config(HYBRID_ARCH)
    L, G = hcfg.num_layers, hcfg.num_layers // hcfg.attn_every
    hybrid_launches = _serve_slice(
        "slice-hybrid", dev, hcfg,
        {"flash_attention": fa_kernel, "ssd_chunk_scan": scan_kernel,
         "ssd_intra_chunk": ssd_kernel, "rmsnorm": rn_kernel},
        {"flash_attention": G, "ssd_chunk_scan": L, "ssd_intra_chunk": 0,
         "rmsnorm": (2 * L + 2 * G + 1) * NEW_TOKENS})

    # 9c. slice-moe: full-width qwen2-moe-a2.7b, and mixtral-8x22b at full width
    # cut to 2 layers, its prompt past the 4,096 window; per forward 2 norms a
    # layer and the final norm
    L = get_config(MOE_ARCH).num_layers
    moe_counters = {"flash_attention": fa_kernel, "rmsnorm": rn_kernel}
    moe_launches = _serve_slice("slice-moe", dev, get_config(MOE_ARCH), moe_counters,
                                {"flash_attention": L, "rmsnorm": (2 * L + 1) * NEW_TOKENS})
    mcfg = get_config(MIXTRAL["arch"])
    say("slice-moe", f"{mcfg.name}: depth cut from {mcfg.num_layers} to {MIXTRAL['layers']} "
                     f"layers ({mcfg.param_count()} params at full depth); widths as published")
    L = MIXTRAL["layers"]
    _serve_slice("slice-moe", dev, mcfg.replace(num_layers=L), moe_counters,
                 {"flash_attention": L, "rmsnorm": (2 * L + 1) * MIXTRAL["new_tokens"]},
                 batch=MIXTRAL["batch"], prompt_len=MIXTRAL["prompt"],
                 new_tokens=MIXTRAL["new_tokens"])

    # 9d. slice-vlm: full-width paligemma-3b, attention at head dim 256 over
    # 256 patch embeddings and 244 text tokens; per forward 2 norms a layer
    # and the final norm
    L = get_config(VLM_ARCH).num_layers
    vlm_launches = _serve_slice("slice-vlm", dev, get_config(VLM_ARCH),
                                {"flash_attention": fa_kernel, "rmsnorm": rn_kernel},
                                {"flash_attention": L, "rmsnorm": (2 * L + 1) * NEW_TOKENS})

    # 9e. slice-audio: full-width hubert-xlarge's non-causal encoder forward
    L = get_config(AUDIO_ARCH).num_layers
    audio_launches = _audio_slice("slice-audio", dev, get_config(AUDIO_ARCH), gen,
                                  {"flash_attention": fa_kernel, "rmsnorm": rn_kernel},
                                  {"flash_attention": L, "rmsnorm": 2 * L + 1})

    # 10. train-demo: the multi-model coded MLP training of launch/train.py --demo
    launches["coded_combine"] = _train_demo(dev)

    # 11. train-full: VectorizedCodedTrainer at full qwen2-0.5b width, bf16
    launches.update(_train_full(dev, cfg))
    _coded_gradient_check(dev, cfg)

    # 11b. slice-ssm-train: the same trainer at full mamba2-1.3b width over
    # sequences of 4 chunks, then the launch entry point, then an f32 gradient
    launches.update(_train_full(dev, scfg, "slice-ssm-train", SSM_TRAIN_SEQ,
                                ("ssd_chunk_scan_bwd",)))
    _train_arch_phase("slice-ssm-train", dev, scfg)
    _ssm_gradient_check(dev, scfg)

    # 11c. slice-hybrid-train: full-width zamba2-2.7b through the launch entry point
    _train_arch_phase("slice-hybrid-train", dev, hcfg)

    # 11d. slice-moe-train: the trainer at full qwen2-moe-a2.7b width and 3
    # layers (two models fit), the entry point's steps there and at
    # mixtral-8x22b's full width, the f32 gradient checks
    moe_train_launches = _slice_moe_train(dev)

    # 11e. slice-vlm-train: full-width, full-depth paligemma-3b through
    # make_coded_train_step (GC and M-SGC), attention at head dim 256 forward
    # and backward; bit-identical bf16 gradients; the f32 checks at 2 layers
    vlm_train_launches = _slice_vlm_train(dev)

    # 12-15. the simulator's device path: the gate-window kernels, the
    # Table-1 grid, App.-J selection and the adaptive trainer
    errs.update(_gate_window_check(dev))
    launches.update(_sim(dev))
    # 14b. grid: m-sgc's whole App.-J grid grid-fused, against one loop a spec
    t_grid = time.perf_counter()
    grid_launches = _grid(dev)
    say("grid", f"phase wall {time.perf_counter() - t_grid:.1f} s; launches {grid_launches}")
    _select(dev)
    _adaptive(dev)

    # 16-18. the Sec.-6 comparison: the scenario sweep over the trace library,
    # the 7-scheme multi-model training and the 7-scheme coded training
    _scenarios(dev)
    _multimodel(dev)
    _coded_train(dev, cfg)

    # 18b. harness: real master/worker coded rounds, grad-mode workers on the
    # card at full qwen2-0.5b width
    _harness(dev)

    # 18c. launch: the launch tooling's sharded step on a one-rank NCCL mesh,
    # bit-identical to the plain step, against the dry-run's count on meta
    _launch(dev, heads_view)

    # 19. timings at the main paths' shapes (bf16, as served and trained)
    rows = []
    x = randn(BATCH * PROMPT_LEN, cfg.d_model, dtype=torch.bfloat16)
    g = randn(cfg.d_model, dtype=torch.bfloat16)
    rn_bytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
    rn_ops = 4 * x.numel()  # square, sum, scale, gamma: f32 arithmetic on CUDA cores
    rows.append(_timed(
        "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/rmsnorm.py:22", tuple(x.shape),
        lambda: rn_kernel(x, g), lambda: rn_ref.rmsnorm(x, g),
        lambda: F.rms_norm(x, (cfg.d_model,), weight=g, eps=1e-6),
        rn_bytes, rn_ops, "f32", iters=500,
    ))
    xd = randn(BATCH, cfg.d_model, dtype=torch.bfloat16)
    say("timings", f"rmsnorm at the decode shape {tuple(xd.shape)}: device "
                   f"{_device_ms(lambda: rn_kernel(xd, g), 500)} ms, per call "
                   f"{_cuda_ms(lambda: rn_kernel(xd, g), 500):.5f} ms")

    rows += _attention_timings(cfg, heads_view, ptxas)
    for row in _attention_dh80_timings(heads_view, ptxas):
        # not on the main path of [slice]: launches from the hybrid's request
        row["launches"] = hybrid_launches.get(row["name"], 0)
        row["launches_of"] = f"[slice-hybrid] ({HYBRID_ARCH} serving)"
        row["max_abs_err"] = errs[f"{row['name']} dh80"]
        rows.append(row)
    for served, got, of in ((ATTN_DH128_SERVED, moe_launches, f"[slice-moe] ({MOE_ARCH} serving)"),
                            (ATTN_DH256_SERVED, vlm_launches, f"[slice-vlm] ({VLM_ARCH} serving)"),
                            (ATTN_AUDIO_SERVED, audio_launches,
                             f"[slice-audio] ({AUDIO_ARCH} forward)")):
        row = _attention_served_timing(served, heads_view, ptxas)
        row["launches"] = got["flash_attention"]
        row["launches_of"] = of
        row["max_abs_err"] = errs[_attn_err_key(served[5], served[6])]
        rows.append(row)
    row = _attention_bwd_timing(ATTN_DH128_TRAIN, heads_view, ptxas)
    row["launches"] = moe_train_launches["flash_attention_bwd"]
    row["launches_of"] = f"[slice-moe-train] ({MOE_ARCH} coded training, gc and m-sgc)"
    row["max_abs_err"] = errs["flash_attention_bwd dh128"]
    rows.append(row)
    row = _attention_bwd_timing(ATTN_DH256_TRAIN, heads_view, ptxas)
    row["launches"] = vlm_train_launches["flash_attention_bwd"]
    row["launches_of"] = f"[slice-vlm-train] ({VLM_ARCH} coded training, gc and m-sgc)"
    row["max_abs_err"] = errs["flash_attention_bwd dh256"]
    rows.append(row)
    _attention_bwd_timing(ATTN_DH256_TILE, heads_view, ptxas)  # printed: one 64-key tile
    # printed: the dh-64 forward and backward at [launch]'s step shape, 64 key tiles
    _attention_served_timing(ATTN_LAUNCH, heads_view, ptxas, iters=10)
    _attention_bwd_timing(ATTN_LAUNCH, heads_view, ptxas, iters=10)
    rows += _training_timings(dev, cfg, randn, ptxas)
    rows += _gate_window_timings(dev)
    rows += _ssd_timing(dev)
    row = _ssd_bwd_timing(dev)
    row["launches_of"] = f"[slice-ssm-train] ({SSM_ARCH} coded training, gc and m-sgc)"
    rows.append(row)
    _rmsnorm_bwd_turn()
    for r in rows:
        if r["launches"] is None:
            r["launches"] = launches[r["name"]]
            r["max_abs_err"] = errs[r["name"]]
        say("timings", f"{r['name']} {r['shape']}: kernel {r['ms']:.5f} ms, "
                       f"plain {r['plain_ms']:.5f} ms, library {_ms(r['library_ms'])}, bound "
                       f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({_rates(r)}); per call with host "
                       f"overhead: kernel {r['call_ms']:.5f}, plain {r['plain_call_ms']:.5f}, "
                       f"library {_ms(r['library_call_ms'])}")
    n = SPIN_COUNTS["sessions"]
    say("timings", f"profiler sessions {n}: spins recorded {SPIN_COUNTS['lead']} of {2 * SPINS * n}"
                   f" before the work, {SPIN_COUNTS['trail']} of {SPINS * n} after it")
    say("done", f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


def _rmsnorm_bwd_check(dev, cfg, randn, compare) -> float:
    """The RMSNorm backward kernel against autograd of the plain version, in f32
    and bf16 with gamma in f32 and bf16: the coded steps' shapes (qwen2-0.5b's,
    qwen2-moe-a2.7b's and paligemma-3b's), every bucket
    of warps a row (d 896 to 8192), the chunked path (f32 at 8192, a bf16 row of
    200 bytes); dgamma and dx bit-identical over 10 calls; the barrier counters
    at 0 after; one device kernel a call.  Returns the error at the GC step's
    shape in bf16."""
    import torch

    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import _counter, rmsnorm_bwd

    worst = None
    for rows, d in [(TRAIN_ROWS, cfg.d_model), (MSGC_ROWS, cfg.d_model), (TRAIN_ROWS, 2048),
                    (MSGC_ROWS, 2048), *[(n * VLM_SEQ, 2048) for n in VLM_SEQS.values()],
                    (130, 640), (3, 100), (2048, 2048), (1024, 4096), (512, 8192)]:
        for dtype in (torch.float32, torch.bfloat16):
            for gdtype in (torch.float32, torch.bfloat16):
                x, dy = randn(rows, d, dtype=dtype), randn(rows, d, dtype=dtype)
                g = randn(d, dtype=gdtype)
                got = rmsnorm_bwd(x, g, dy)
                xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
                want = torch.autograd.grad(rn_ref.rmsnorm(xr, gr), (xr, gr), dy)
                tol = RMSNORM_BWD_TOL[_dtype_name(dtype if dtype == gdtype else torch.bfloat16)]
                err = max(compare("rmsnorm-bwd", f"{name} ({rows}, {d}) {_dtype_name(dtype)} gamma "
                                  f"{_dtype_name(gdtype)}", a, b, tol)
                          for name, a, b in zip(("dx", "dgamma"), got, want))
                if (rows, dtype, gdtype) == (TRAIN_ROWS, torch.bfloat16, torch.bfloat16):
                    worst = err
    for rows, d, dtype in [(TRAIN_ROWS, cfg.d_model, torch.bfloat16),
                           (TRAIN_ROWS, cfg.d_model, torch.float32), (77, 8192, torch.float32),
                           (300, 100, torch.bfloat16)]:
        x, g, dy = randn(rows, d, dtype=dtype), randn(d, dtype=dtype), randn(rows, d, dtype=dtype)
        first = rmsnorm_bwd(x, g, dy)
        for _ in range(10):
            again = rmsnorm_bwd(x, g, dy)
            if not (torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])):
                fail(f"rmsnorm-bwd ({rows}, {d}) {dtype}: dx or dgamma changed between calls")
    say("rmsnorm-bwd", "dx and dgamma bit-identical over 10 calls at (8192, 896) bf16 and f32, "
                       "(77, 8192) f32 and (300, 100) bf16 (the chunked path)")
    stream = torch.cuda.current_stream(dev).cuda_stream
    torch.cuda.synchronize()
    if _counter(dev, stream).tolist() != [0, 0]:
        fail(f"rmsnorm-bwd: the barrier counters are {_counter(dev, stream).tolist()} after "
             f"the calls, not 0")
    # device kernels a call: every activity of a profiled run of 20 calls must be
    # the kernel, and all 20 recorded (the profiler can lose activities: three tries)
    x, g, dy = (randn(TRAIN_ROWS, cfg.d_model, dtype=torch.bfloat16),
                randn(cfg.d_model, dtype=torch.bfloat16),
                randn(TRAIN_ROWS, cfg.d_model, dtype=torch.bfloat16))
    calls, seen = 20, []
    for _ in range(3):
        names = [name for name, _, _ in
                 _device_events(lambda: [rmsnorm_bwd(x, g, dy) for _ in range(calls)])]
        kernels = sum("rmsnorm_bwd" in name for name in names)
        seen.append(kernels)
        if kernels > calls or kernels < len(names):
            fail(f"rmsnorm-bwd: {calls} calls ran {len(names)} device activities "
                 f"{sorted(set(kernel_label(n) for n in names))}, not one kernel a call")
        if kernels == calls:
            break
    else:
        fail(f"rmsnorm-bwd: the profiler recorded {seen} kernels for {calls} calls")
    say("rmsnorm-bwd", f"one device kernel a call ({calls} in {calls} calls, "
                       f"{kernel_label(names[0])}); counters at 0")
    torch.cuda.synchronize()
    return worst


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def _ms(value) -> str:
    return "none" if value is None else f"{value:.5f} ms"


def _train_demo(dev) -> int:
    """train_demo() for each scheme, every decode checked; returns the
    coded_combine launches of the four runs."""
    import numpy as np

    from repro_torch.kernels.gc_coding.gc_coding import coded_combine
    from repro_torch.launch.train import train_demo

    total = 0
    for name in DEMO_SCHEMES:
        coded_combine.launches = 0
        res = train_demo(name, jobs=DEMO_JOBS, device=dev, check_decodes=True)
        launched, drv = coded_combine.launches, res.driver
        say("train-demo", f"{name}: {DEMO_JOBS} jobs, n {drv.scheme.n}, batch {drv.batch_size}: "
                          f"simulated clock {res.clock:.6f} s, wall {res.wall_s:.3f} s; "
                          f"coded_combine launches {launched} = {drv.encodes} encodes + "
                          f"{drv.decodes} decodes; decoded vs full-batch gradient max_abs_err "
                          f"{res.max_decode_err:.3e} (tol {DECODE_TOL:g}); final losses "
                          f"{[round(x, 4) for x in res.final_losses]}")
        if launched != drv.encodes + drv.decodes:
            fail(f"train-demo {name}: {launched} coded_combine launches for "
                 f"{drv.encodes} encodes and {drv.decodes} decodes")
        if not res.max_decode_err <= DECODE_TOL:
            fail(f"train-demo {name}: a decoded gradient is off by {res.max_decode_err:.3e}")
        if not np.isfinite(res.final_losses).all():
            fail(f"train-demo {name}: non-finite losses {res.final_losses}")
        total += launched
    return total


def _train_counters() -> dict:
    """The training path's kernel wrappers by name (each keeps its launches)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.gc_coding.gc_coding import coded_combine
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssd_scan.ssd_scan import (
        ssd_chunk_scan,
        ssd_chunk_scan_bwd,
        ssd_intra_chunk,
    )

    return {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd, "coded_combine": coded_combine,
            "ssd_chunk_scan": ssd_chunk_scan, "ssd_chunk_scan_bwd": ssd_chunk_scan_bwd,
            "ssd_intra_chunk": ssd_intra_chunk}


def _per_step(cfg) -> dict:
    """Kernel launches of one coded step of ``cfg``.  Each layer body is
    rematerialised (cfg.remat), so its forward kernels run twice, once in the
    forward and once again in the backward, and its backward kernels once; the
    final norm's forward runs once.  A dense layer runs two norms and one
    attention; a Mamba2 layer two norms (before the block and the gated norm)
    and one fused chunk scan; the hybrid's shared block, after every
    ``attn_every`` Mamba2 layers, two norms and one attention."""
    L = cfg.num_layers
    if cfg.family in ("ssm", "hybrid"):
        G = L // cfg.attn_every if cfg.attn_every else 0
        norms, attn, scans = 2 * L + 2 * G, G, L
    else:
        norms, attn, scans = 2 * L, L, 0
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn, "rmsnorm": 2 * norms + 1,
            "rmsnorm_bwd": norms + 1, "ssd_chunk_scan": 2 * scans, "ssd_chunk_scan_bwd": scans,
            "ssd_intra_chunk": 0, "coded_combine": 0}


def _train_full(dev, cfg, phase="train-full", seq=TRAIN["seq"],
                report=("rmsnorm_bwd", "flash_attention_bwd"), peaks=None) -> dict:
    """VectorizedCodedTrainer at full width for each scheme, over sequences of
    ``seq`` tokens; returns the launches of the ``report`` kernels over both
    runs, and puts each scheme's peak memory into ``peaks`` where given.  A
    run fails past ``TRAIN_MEMORY_SHARE`` of the card's memory.  A moe model
    runs under a route log: each step records each layer once and drops no
    (token, expert) pair, its chunks being its groups; its profiled step
    shows the moe layers as categories of their own."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.core import GilbertElliotSource, make_scheme
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.models.layers import moe_groups, route_log
    from repro_torch.train import VectorizedCodedTrainer

    counters = _train_counters()
    per_step = _per_step(cfg)
    totals = dict.fromkeys(report, 0)
    moe = cfg.family == "moe"
    for name, kw in TRAIN_SCHEMES.items():
        sch = make_scheme(name, TRAIN["n"], TRAIN["jobs"], **kw)
        tr = VectorizedCodedTrainer(scheme=sch, cfg=cfg, num_models=TRAIN["models"],
                                    batch_size=TRAIN["batch"], seq_len=seq, lr=1e-4,
                                    seed=0, device=dev)
        delays = GilbertElliotSource(n=TRAIN["n"], seed=0).sample_delays(
            TRAIN["jobs"] + sch.T + 1)
        step, times, last = tr._step, [], {}

        def timed(*args, step=step, times=times, last=last):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            last["args"] = args
            return out

        tr._step = timed
        # how often the RMSNorm backward's dy arrives non-contiguous (ops.py then
        # copies it before the kernel)
        dys = {"calls": 0, "strided": 0}
        backward = rn_ops._RMSNormFn.backward

        def counted(ctx, dy, backward=backward, dys=dys):
            dys["calls"] += 1
            dys["strided"] += not dy.is_contiguous()
            return backward(ctx, dy)

        rn_ops._RMSNormFn.backward = staticmethod(counted)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        try:
            with route_log() if moe else contextlib.nullcontext() as log:
                clock = tr.run(TRAIN["jobs"], delays)
        finally:
            rn_ops._RMSNormFn.backward = staticmethod(backward)
        launches = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        if peaks is not None:
            peaks[name] = peak
        room = TRAIN_MEMORY_SHARE * torch.cuda.get_device_properties(dev).total_memory
        if peak > room:
            fail(f"{phase} {name}: peak memory {peak} B past {TRAIN_MEMORY_SHARE:g} of the "
                 f"card's ({room:.0f} B)")
        steps = len(times)
        n_seq = TRAIN["n"] * tr.slots * TRAIN["batch"] // tr.num_chunks
        losses = [x for m in range(TRAIN["models"]) for x in tr.losses[m]]
        median_ms = statistics.median(times[1:]) * 1e3
        say(phase, f"{cfg.name} {name} {kw}: {steps} coded steps of {n_seq} sequences x "
                   f"{seq} tokens ({TRAIN['models']} models, n {TRAIN['n']}, "
                   f"batch {TRAIN['batch']}); simulated clock {clock:.6f} s; "
                   f"job_done_time {tr.job_done_time}")
        say(phase, f"{name}: coded step {median_ms:.3f} ms median after a warm-up step "
                   f"(all: {[round(t * 1e3, 3) for t in times]} ms); "
                   f"max_memory_allocated {peak} B; losses {[round(x, 4) for x in losses]}")
        say(phase, f"{name}: launches per step "
                   f"{ {k: v / steps for k, v in launches.items()} } (expected {per_step}); "
                   f"the RMSNorm backward's dy non-contiguous in {dys['strided']} of "
                   f"{dys['calls']} calls")
        if any(launches[k] != per_step[k] * steps for k in per_step):
            fail(f"{phase} {name}: launches {launches} over {steps} steps, expected "
                 f"{per_step} per step")
        if steps != TRAIN["jobs"] or not np.isfinite(losses).all():
            fail(f"{phase} {name}: {steps} steps, losses {losses}")
        if moe:
            L, drops = cfg.num_layers, log.drops()
            chunk = TRAIN["batch"] // tr.num_chunks * seq
            Tg, Cg = moe_groups(chunk, cfg)
            say(phase, f"{name}: (token, expert) pairs dropped per coded step, by layer, in "
                       f"chunks of {chunk} tokens (groups Tg {Tg}, Cg {Cg}): "
                       f"{[drops[i:i + L] for i in range(0, len(drops), L)]}; "
                       f"{len(log.calls)} routings recorded for {steps} steps x {L} layers")
            if log.layers != list(range(L)) * steps or any(drops):
                fail(f"{phase} {name}: routings of layers {log.layers} over {steps} steps, "
                     f"drops {drops}; expected each layer once a step and no drop")
            del log
        for k in totals:
            totals[k] += launches[k]
        _breakdown(f"profile {phase} {name} step",
                   _device_events(lambda: step(*last["args"]), "moe" if moe else None),
                   median_ms)
        if name == "gc" and phase == "train-full":
            _remat_turns(cfg, tr, step, last["args"])
        del tr, last
        torch.cuda.empty_cache()
    return totals


def _train_arch_phase(phase, dev, cfg) -> None:
    """``train_arch(cfg.name, full=True, coded=True, steps=3)``, the launch
    entry point's (4, 1)-GC steps on 8 sequences of 64 tokens: exact launches
    per step, finite losses, each step's ms and the peak memory."""
    import numpy as np
    import torch

    import repro_torch.launch.train as launch_train

    counters = _train_counters()
    per_step = _per_step(cfg)
    steps, times = 3, []
    make = launch_train.make_coded_train_step

    def make_timed(*args, **kw):
        step = make(*args, **kw)

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        return timed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    launch_train.make_coded_train_step = make_timed
    try:
        losses = launch_train.train_arch(cfg.name, steps=steps, coded=True, full=True,
                                         device=dev)
    finally:
        launch_train.make_coded_train_step = make
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    say(phase, f"train_arch({cfg.name!r}, full=True, coded=True, steps={steps}): "
               f"{cfg.param_count()} params in {cfg.dtype}; step ms "
               f"{[round(t * 1e3, 3) for t in times]} (the first with its warm-up); "
               f"max_memory_allocated {peak} B; losses {[round(x, 4) for x in losses]}")
    say(phase, f"launches per step { {k: v / steps for k, v in launches.items()} } "
               f"(expected {per_step})")
    if any(launches[k] != per_step[k] * steps for k in per_step):
        fail(f"{phase}: launches {launches} over {steps} steps, expected {per_step} per step")
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"{phase}: losses {losses}")
    torch.cuda.empty_cache()


def _ssm_gradient_check(dev, cfg) -> None:
    """The f32 gradient of ``loss_fn`` at full ``cfg`` width, depth cut to
    SSM_GRAD's layers, over SSM_GRAD's batch of sequences of several chunks
    with a padded tail: through the kernels (fused scan forward and backward)
    against the plain path on the card."""
    import torch

    from repro_torch.data import token_batch
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan, ssd_chunk_scan_bwd
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.coded import value_and_grad
    from repro_torch.tree import tree_leaves

    cfg32 = cfg.replace(dtype="float32", num_layers=SSM_GRAD["layers"])
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(1))
    batch = token_batch(0, 1, SSM_GRAD["batch"], SSM_GRAD["seq"], cfg32.vocab_size, device=dev)
    ssd_chunk_scan.launches = ssd_chunk_scan_bwd.launches = 0
    got = value_and_grad(lambda p: loss_fn(p, cfg32, batch), params)
    launches = (ssd_chunk_scan.launches, ssd_chunk_scan_bwd.launches)
    want = value_and_grad(lambda p: loss_fn(p, cfg32, batch, plain=True), params)
    worst = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(got[1]), tree_leaves(want[1])))
    ok = all(torch.allclose(a, b, **CODED_GRAD_TOL) for a, b in
             zip(tree_leaves(got[1]), tree_leaves(want[1])))
    L = cfg32.num_layers
    chunks = -(-SSM_GRAD["seq"] // cfg32.ssm_chunk)
    say("slice-ssm-train", f"f32 {L}-layer {cfg.name} gradient, {SSM_GRAD['batch']} x "
                           f"{SSM_GRAD['seq']} tokens ({chunks} chunks of {cfg32.ssm_chunk}, the "
                           f"last padded), kernels vs plain: loss {float(got[0]):.6f} vs "
                           f"{float(want[0]):.6f}, max_abs_err {worst:.3e} ({CODED_GRAD_TOL}) "
                           f"{'ok' if ok else 'MISMATCH'}; fused scan launches forward / "
                           f"backward {launches}")
    if not ok or abs(float(got[0]) - float(want[0])) > 1e-4:
        fail("slice-ssm-train: the f32 gradient through the kernels disagrees with the plain path")
    if launches != (2 * L, L):
        fail(f"slice-ssm-train: fused scan launches {launches}, expected {(2 * L, L)}")
    del got, want, params
    torch.cuda.empty_cache()


def _remat_turns(cfg, tr, step, args) -> None:
    """The coded step's device time and peak memory with its layer bodies
    rematerialised (``cfg.remat``, as the JAX package's step does) and
    without, in turns (remat, none, none, remat), on the same inputs."""
    import torch

    from repro_torch.train.coded import make_coded_train_step

    plain_step = make_coded_train_step(cfg.replace(remat=False), tr.scheme.n,
                                       getattr(tr.scheme, "s", 0), lr=tr.lr,
                                       num_chunks=tr.num_chunks)
    got = {"remat": [], "none": []}
    for label in ("remat", "none", "none", "remat"):
        fn = step if label == "remat" else plain_step
        fn(*args)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        busy = sum(t for _, t, _ in _device_events(lambda: fn(*args))) / 1e3
        got[label].append((busy, torch.cuda.max_memory_allocated()))
    say("train-full", "gc step with its layer bodies rematerialised and without, in turns: "
                      + "; ".join(f"{k}: device busy {[round(b, 3) for b, _ in v]} ms, "
                                  f"max_memory_allocated {[m for _, m in v]} B"
                                  for k, v in got.items()))


def _coded_gradient_check(dev, cfg) -> None:
    """One f32 coded gradient at 2 layers (full widths and vocab): through
    the kernels against the full-batch gradient and against the plain path."""
    import torch

    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.coded import coded_loss, value_and_grad

    cfg32 = cfg.replace(dtype="float32", num_layers=2)
    n = TRAIN["n"]
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(1))
    batch, coded, w, _ = _coded_job(dev, cfg32.vocab_size)
    got = value_and_grad(lambda p: coded_loss(p, cfg32, coded, w, n), params)
    for what, fn in (
        ("full-batch gradient", lambda p: loss_fn(p, cfg32, batch, aux_weight=0.0)),
        ("plain path's coded gradient", lambda p: coded_loss(p, cfg32, coded, w, n, plain=True)),
    ):
        _check_coded_gradient("train-full", f"f32 2-layer coded gradient (stragglers 1, 4, 6)"
                                            f" vs {what}", got, value_and_grad(fn, params))
    del got, params
    torch.cuda.empty_cache()


def _check_coded_gradient(phase, what, got, want) -> None:
    """A coded step's (loss, gradient tree) ``got`` against ``want``: every
    leaf allclose at ``CODED_GRAD_TOL`` and the losses within 1e-4."""
    import torch

    from repro_torch.tree import tree_leaves

    pairs = list(zip(tree_leaves(got[1]), tree_leaves(want[1])))
    worst = max(float((a - b).abs().max()) for a, b in pairs)
    ok = all(torch.allclose(a, b, **CODED_GRAD_TOL) for a, b in pairs)
    say(phase, f"{what}: loss {float(got[0]):.6f} vs {float(want[0]):.6f}, max_abs_err "
               f"{worst:.3e} ({CODED_GRAD_TOL}) {'ok' if ok else 'MISMATCH'}")
    if not ok or abs(float(got[0]) - float(want[0])) > 1e-4:
        fail(f"{phase}: {what}: the f32 coded gradient disagrees")


def _slice_moe_train(dev) -> dict:
    """[slice-moe-train]: the moe family's training on the card.
    ``VectorizedCodedTrainer`` at full qwen2-moe-a2.7b width, 2 models, at
    ``MOE_TRAIN["layers"]`` layers (the reckoning of the depth is printed),
    GC and M-SGC, no pair dropped; two identical coded gradients bit for bit
    the same; the launch entry point's uncoded and (4, 1)-GC steps at that
    depth and at full mixtral-8x22b width cut to 1 layer (the uncoded ones
    drop pairs, the coded ones none); then the f32 gradient checks at 2
    layers.  Returns the trainer runs' attention and RMSNorm backward
    launches."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    L, models = MOE_TRAIN["layers"], TRAIN["models"]
    cut = cfg.replace(num_layers=L)
    peaks = {}
    totals = _train_full(dev, cut, "slice-moe-train", peaks=peaks)
    total = torch.cuda.get_device_properties(dev).total_memory

    def state(layers):  # bf16 weight and gradient, f32 AdamW moments
        return models * 12 * cfg.replace(num_layers=layers).param_count()

    rest = peaks["gc"] - state(L)
    say("slice-moe-train", f"{cut.name}: depth {L} of {cfg.num_layers}, fixed; {models} models "
                           f"x 12 B a parameter = {state(L)} B of training state at {L} layers "
                           f"({cut.param_count()} parameters a model), {state(L + 1)} B at "
                           f"{L + 1}; max_memory_allocated {peaks} B, the GC step's {rest} B "
                           f"above its state; {TRAIN_MEMORY_SHARE:g} of the card is "
                           f"{TRAIN_MEMORY_SHARE * total:.0f} B of {total} B")
    _determinism("slice-moe-train", dev, cut, *_coded_job(dev, cut.vocab_size)[1:3])
    mixtral = get_config(MIXTRAL["arch"])
    say("slice-moe-train", f"{mixtral.name}: depth cut from {mixtral.num_layers} to "
                           f"{MOE_TRAIN['mixtral_layers']} layer ({mixtral.param_count()} "
                           f"params at full depth); its window of {mixtral.sliding_window} "
                           f"does not bind over sequences of 64 tokens")
    for c in (cut, mixtral.replace(num_layers=MOE_TRAIN["mixtral_layers"])):
        _moe_steps(dev, c)
    _moe_gradient_check(dev, cfg.replace(dtype="float32", num_layers=MOE_TRAIN["grad_layers"]))
    return totals


def _moe_steps(dev, cfg, steps=2) -> None:
    """The launch entry point's steps (``train_arch``) at ``cfg``'s depth,
    which ``train_arch`` does not cut: ``make_train_step`` on 8 sequences of
    64 tokens, uncoded, whose one group of 512 tokens drops pairs, as the JAX
    package's uncoded step does; then ``make_coded_train_step`` at (4, 1)-GC
    with a random straggler, whose chunks of 2 x 64 tokens drop none.  Exact
    launches, drops by layer, step ms, peak memory and finite losses."""
    import numpy as np
    import torch

    from repro_torch.core import make_gradient_code
    from repro_torch.data import gc_chunked_batch, token_batch
    from repro_torch.models.layers import moe_groups, route_log
    from repro_torch.train import (gc_round_weights, init_train_state, make_coded_train_step,
                                   make_train_step)

    counters = _train_counters()
    per_step = _per_step(cfg)
    L = cfg.num_layers
    params, opt = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    n, s = 4, 1
    code, rng = make_gradient_code(n, s), np.random.default_rng(0)
    runs = {"uncoded": (make_train_step(cfg), lambda b: (b,), 8 * 64),
            "(4, 1)-GC": (make_coded_train_step(cfg, n, s),
                          lambda b: (gc_chunked_batch(b, n, s), gc_round_weights(
                              code, sorted(rng.choice(n, n - 1, replace=False).tolist())
                          ).to(dev)), 8 // n * 64)}
    for what, (step, inputs, group_tokens) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        times, losses = [], []
        with route_log() as log:
            for i in range(steps):
                args = inputs(token_batch(0, i, 8, 64, cfg.vocab_size, device=dev))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, *args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
        launches = {k: c.launches for k, c in counters.items()}
        drops = log.drops()
        Tg, Cg = moe_groups(group_tokens, cfg)
        pairs = group_tokens * cfg.num_experts_per_tok
        say("slice-moe-train", f"{cfg.name} ({L} layers) {what} steps: step ms "
                               f"{[round(t * 1e3, 3) for t in times]} (the first with its "
                               f"warm-up); max_memory_allocated "
                               f"{torch.cuda.max_memory_allocated()} B; losses "
                               f"{[round(x, 4) for x in losses]}; pairs dropped by layer in "
                               f"groups of Tg {Tg} / Cg {Cg} (of {pairs} a group): "
                               f"{[drops[i:i + L] for i in range(0, len(drops), L)]}")
        say("slice-moe-train", f"{what}: launches per step "
                               f"{ {k: v / steps for k, v in launches.items()} } "
                               f"(expected {per_step})")
        if any(launches[k] != per_step[k] * steps for k in per_step):
            fail(f"slice-moe-train {cfg.name} {what}: launches {launches} over {steps} steps, "
                 f"expected {per_step} per step")
        if not np.isfinite(losses).all() or log.layers != list(range(L)) * steps:
            fail(f"slice-moe-train {cfg.name} {what}: losses {losses}, routings of layers "
                 f"{log.layers}")
        if (what == "uncoded") != (sum(drops) > 0):
            fail(f"slice-moe-train {cfg.name} {what}: drops {drops}; pairs drop in the "
                 f"uncoded step's group of 512 tokens and in no coded chunk")
    del params, opt, log
    torch.cuda.empty_cache()


def _coded_job(dev, vocab: int):
    """GC's coded view of job 1 (TRAIN's n, s and batch) with s stragglers
    (workers 1, 4, 6): (its batch, the coded view, the decode weights, the
    (n, slots) chunk of each slot)."""
    import numpy as np
    import torch

    from repro_torch.core import make_scheme
    from repro_torch.data import coded_slot_batch, token_batch

    n = TRAIN["n"]
    sch = make_scheme("gc", n, 1, **TRAIN_SCHEMES["gc"])
    stragglers = np.zeros(n, dtype=bool)
    stragglers[[1, 4, 6]] = True
    sch.step(1, stragglers)
    (jd,) = sch.collect_decodes(1)
    batch = token_batch(0, 1, TRAIN["batch"], TRAIN["seq"], vocab, device=dev)
    slots = sch.chunk_slots(1)
    w = torch.from_numpy(sch.decode_weights(jd)).to(dev)
    return batch, coded_slot_batch(batch, slots, n), w, slots


def _determinism(phase, dev, cfg, coded, w) -> None:
    """Two identical bf16 coded gradients (value and gradient of
    ``coded_loss`` over the coded view ``coded`` with weights ``w``, from the
    same parameters), through the kernels: every leaf bit for bit the same."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.train.coded import coded_loss, value_and_grad
    from repro_torch.tree import tree_leaves

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(2))
    runs = [value_and_grad(lambda p: coded_loss(p, cfg, coded, w, TRAIN["n"]), params)
            for _ in range(2)]
    leaves = list(zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])))
    differ = sum(not torch.equal(a, b) for a, b in leaves)
    n, slots, cb, seq = coded["labels"].shape
    say(phase, f"{cfg.name} ({cfg.num_layers} layers) bf16 coded gradient twice from the same "
               f"state, {n * slots * cb} x {seq} labels: {len(leaves) - differ} of {len(leaves)} "
               f"leaves bit-identical, losses {float(runs[0][0])!r} / {float(runs[1][0])!r}")
    if differ or float(runs[0][0]) != float(runs[1][0]):
        fail(f"{phase}: {differ} gradient leaves differ between two identical steps")
    del runs, leaves, params
    torch.cuda.empty_cache()


def _moe_gradient_check(dev, cfg32) -> None:
    """f32 coded gradient of ``cfg32`` (full width, cut depth) at GC's coded
    shape with s stragglers: through the kernels against the plain path with
    the routing pinned to the kernel path's, and against the sum of each
    chunk's ``chunk_loss_sum`` gradient, each chunk in a forward of its own
    with its rows' routing pinned to the coded forward's: the JAX package's
    identity for a coded step, whose chunks are their own capacity groups."""
    import torch

    from repro_torch.models import init_params
    from repro_torch.models.layers import RouteLog, route_log
    from repro_torch.train.coded import chunk_loss_sum, coded_loss, value_and_grad
    from repro_torch.tree import tree_leaves

    counters = _train_counters()
    per_step = _per_step(cfg32)
    n, L = TRAIN["n"], cfg32.num_layers
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(1))
    batch, coded, w, slots = _coded_job(dev, cfg32.vocab_size)
    for c in counters.values():
        c.launches = 0
    with route_log() as k_log:
        got = value_and_grad(lambda p: coded_loss(p, cfg32, coded, w, n), params)
    launches = {k: c.launches for k, c in counters.items()}
    if any(launches[k] != per_step[k] for k in per_step):
        fail(f"slice-moe-train: f32 coded gradient launches {launches}, expected {per_step}")
    what = (f"f32 {L}-layer {cfg32.name} coded gradient (stragglers 1, 4, 6; drops "
            f"{k_log.drops()}) vs")

    with route_log(RouteLog(replay=k_log)):
        want = value_and_grad(lambda p: coded_loss(p, cfg32, coded, w, n, plain=True), params)
    _check_coded_gradient("slice-moe-train", f"{what} plain path's, routing pinned", got, want)
    del want
    # each chunk alone, pinned to the rows of its first slot in the coded forward
    cb = TRAIN["batch"] // n
    rows = cb * TRAIN["seq"]
    total_loss, total = 0.0, None
    for chunk in range(n):
        i, j = (int(x[0]) for x in (slots == chunk).nonzero())
        start = (i * slots.shape[1] + j) * rows
        pin = RouteLog()
        for layer in range(L):
            idx, _, gap = k_log.call(layer)
            pin.record(layer, idx[start:start + rows], None, gap[start:start + rows])
        part = {k: v[chunk * cb:(chunk + 1) * cb] for k, v in batch.items()}
        with route_log(RouteLog(replay=pin)):
            loss, grads = value_and_grad(lambda p: chunk_loss_sum(p, cfg32, part), params)
        total_loss += float(loss)
        if total is None:
            total = grads
        else:
            for a, b in zip(tree_leaves(total), tree_leaves(grads)):
                a.add_(b)
        del grads
    for a in tree_leaves(total):
        a.div_(n * cb)
    _check_coded_gradient("slice-moe-train", f"{what} sum of the {n} chunks' chunk_loss_sum "
                                             f"gradients, each chunk alone",
                          got, (total_loss / (n * cb), total))
    del got, total, params
    torch.cuda.empty_cache()


def _vlm_batch(dev, cfg, job: int, batch: int) -> dict:
    """One vlm job's batch: ``batch`` sequences of ``cfg.num_prefix_tokens``
    seeded f32 patch embeddings (the stubbed vision tower's output, cast by
    the model) and ``VLM_TRAIN["text"]`` text tokens from ``token_batch``,
    whose labels are the text."""
    import torch

    from repro_torch.data import token_batch

    gen = torch.Generator(device=dev).manual_seed(1_000 + job)
    text = token_batch(0, job, batch, VLM_TRAIN["text"], cfg.vocab_size, device=dev)
    prefix = torch.randn((batch, cfg.num_prefix_tokens, cfg.d_model), generator=gen, device=dev)
    return {"prefix_embeds": prefix, **text}


def _vlm_jobs(dev, cfg, name):
    """(step, [(coded batch, weights), ...]) for ``VLM_TRAIN["steps"]`` jobs
    of ``name``: GC (s 3) on ``gc_chunked_batch`` with ``gc_round_weights``
    of 5 random survivors of 8, or M-SGC (B 1, W 2, lambda 2) on
    ``coded_slot_batch`` with its decode weights, worker t % n straggling in
    round t (within its tolerance)."""
    import numpy as np
    import torch

    from repro_torch.core import make_gradient_code, make_scheme
    from repro_torch.data import coded_slot_batch, gc_chunked_batch
    from repro_torch.train import gc_round_weights, make_coded_train_step

    n, steps, b = TRAIN["n"], VLM_TRAIN["steps"], VLM_TRAIN["batch"][name]
    if name == "gc":
        s = TRAIN_SCHEMES["gc"]["s"]
        code, rng = make_gradient_code(n, s, prefer_rep=False), np.random.default_rng(0)
        jobs = [(gc_chunked_batch(_vlm_batch(dev, cfg, job, b), n, s), gc_round_weights(
            code, sorted(rng.choice(n, n - s, replace=False).tolist())).to(dev))
            for job in range(1, steps + 1)]
        return make_coded_train_step(cfg, n, s), jobs
    sch = make_scheme(name, n, steps, **TRAIN_SCHEMES[name])
    num_chunks, _ = sch.chunk_grid()
    jobs = []
    for t in range(1, steps + sch.T + 1):
        stragglers = np.zeros(n, dtype=bool)
        stragglers[t % n] = True
        sch.step(t, stragglers)
        for jd in sch.collect_decodes(t):
            jobs.append((coded_slot_batch(_vlm_batch(dev, cfg, jd.job, b),
                                          sch.chunk_slots(jd.job), num_chunks),
                         torch.from_numpy(sch.decode_weights(jd)).to(dev)))
    return make_coded_train_step(cfg, n, 0, num_chunks=num_chunks), jobs


def _slice_vlm_train(dev) -> dict:
    """[slice-vlm-train]: the vlm family's coded training on the card.  One
    full-width, full-depth paligemma-3b in bf16 from seed 0 through
    ``make_coded_train_step`` (``coded_loss`` -> ``token_nll``: the tied head
    over every patch and text position, then the text's slice -> per layer
    under ``_remat`` RMSNorm, attention at head dim 256, MQA 8/1, forward and
    backward kernels, RMSNorm, SwiGLU -> AdamW), GC and M-SGC for
    ``VLM_TRAIN["steps"]`` steps each: exact launches a step, finite losses,
    step ms, the peak against the reckoning printed and ``TRAIN_MEMORY_SHARE``,
    a profiled step; two identical bf16 coded gradients bit for bit the same;
    the f32 coded gradient at 2 layers against the plain path and against the
    sum of each chunk's ``chunk_loss_sum`` gradient.  Returns the trainer
    steps' attention backward launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train import init_train_state

    phase = "slice-vlm-train"
    cfg = get_config(VLM_ARCH)
    counters = _train_counters()
    per_step = _per_step(cfg)
    total = torch.cuda.get_device_properties(dev).total_memory
    room = TRAIN_MEMORY_SHARE * total
    seq = cfg.num_prefix_tokens + VLM_TRAIN["text"]
    state = 12 * cfg.param_count()  # bf16 weight and gradient, f32 AdamW moments

    def head_bytes(seqs):
        """The head's logits over every position (bf16) and the zero-filled
        gradient of their text slice, and the f32 log-softmax of the text
        positions and its gradient."""
        text = VLM_TRAIN["text"] - 1
        return 2 * 2 * seqs * seq * cfg.vocab_size + 2 * 4 * seqs * text * cfg.vocab_size

    seqs = VLM_SEQS
    say(phase, f"{cfg.name}: {cfg.num_layers} layers (full depth), {cfg.param_count()} params in "
               f"{cfg.dtype}; sequences of {cfg.num_prefix_tokens} patch embeddings + "
               f"{VLM_TRAIN['text']} text tokens; reckoning: training state {state} B (12 B a "
               f"parameter; two models {2 * state} B), the head's logits, their sliced "
               f"gradient and the text's f32 log-softmax with its gradient {head_bytes(128)} B "
               f"at TRAIN's batch {TRAIN['batch']} a job (128 sequences), "
               f"{head_bytes(seqs['gc'])} B at {VLM_TRAIN['batch']['gc']} ({seqs['gc']} "
               f"sequences, GC) and {head_bytes(seqs['m-sgc'])} B at "
               f"{VLM_TRAIN['batch']['m-sgc']} ({seqs['m-sgc']}, M-SGC: its grid has 32 "
               f"chunks); {TRAIN_MEMORY_SHARE:g} of the card is {room:.0f} B of {total} B")
    params, opt = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0))
    totals, last = {"flash_attention_bwd": 0}, {}
    for name in VLM_TRAIN["batch"]:
        step, jobs = _vlm_jobs(dev, cfg, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        times, losses = [], []
        for coded, w in jobs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, coded, w)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        launches = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        steps = len(times)
        median_ms = statistics.median(times[1:]) * 1e3
        n_seq = coded["labels"].shape[0] * coded["labels"].shape[1] * coded["labels"].shape[2]
        say(phase, f"{name} {TRAIN_SCHEMES[name]}: {steps} coded steps of {n_seq} sequences x "
                   f"{seq} positions (job batch {VLM_TRAIN['batch'][name]}); coded step "
                   f"{median_ms:.3f} ms median of steps 2-{steps} (all: "
                   f"{[round(t * 1e3, 3) for t in times]} ms); max_memory_allocated {peak} B "
                   f"(reckoned {state + head_bytes(n_seq)} B of state and head, "
                   f"{peak - state} B above the state); losses {[round(x, 4) for x in losses]}")
        say(phase, f"{name}: launches per step "
                   f"{ {k: v / steps for k, v in launches.items()} } (expected {per_step})")
        if any(launches[k] != per_step[k] * steps for k in per_step):
            fail(f"{phase} {name}: launches {launches} over {steps} steps, expected "
                 f"{per_step} per step")
        if steps != VLM_TRAIN["steps"] or n_seq != seqs[name] or not np.isfinite(losses).all():
            fail(f"{phase} {name}: {steps} steps of {n_seq} sequences, losses {losses}")
        if peak > room:
            fail(f"{phase} {name}: peak memory {peak} B past {TRAIN_MEMORY_SHARE:g} of the "
                 f"card's ({room:.0f} B)")
        totals["flash_attention_bwd"] += launches["flash_attention_bwd"]
        _breakdown(f"profile {phase} {name} step",
                   _device_events(lambda: step(params, opt, coded, w)), median_ms)
        if name == "gc":
            last = {"coded": coded, "w": w}
        del jobs, coded, w
        torch.cuda.empty_cache()
    del params, opt
    torch.cuda.empty_cache()
    _determinism(phase, dev, cfg, last["coded"], last["w"])
    del last
    _vlm_gradient_check(dev, cfg.replace(dtype="float32", num_layers=VLM_TRAIN["grad_layers"]))
    return totals


def _vlm_gradient_check(dev, cfg32) -> None:
    """f32 coded gradient of ``cfg32`` (full width, cut depth) at GC's coded
    view of a job of ``VLM_TRAIN["grad_batch"]`` with s stragglers: through
    the kernels against the plain path, and against the sum of each chunk's
    ``chunk_loss_sum`` gradient, each chunk in a forward of its own."""
    import torch

    from repro_torch.core import make_gradient_code
    from repro_torch.data import gc_chunked_batch
    from repro_torch.models import init_params
    from repro_torch.train import gc_round_weights
    from repro_torch.train.coded import chunk_loss_sum, coded_loss, value_and_grad
    from repro_torch.tree import tree_leaves

    counters = _train_counters()
    per_step = _per_step(cfg32)
    n, s, b = TRAIN["n"], TRAIN_SCHEMES["gc"]["s"], VLM_TRAIN["grad_batch"]
    params = init_params(cfg32, torch.Generator(device=dev).manual_seed(1))
    batch = _vlm_batch(dev, cfg32, 1, b)
    survivors = [0, 2, 3, 5, 7]
    w = gc_round_weights(make_gradient_code(n, s, prefer_rep=False), survivors).to(dev)
    coded = gc_chunked_batch(batch, n, s)
    for c in counters.values():
        c.launches = 0
    got = value_and_grad(lambda p: coded_loss(p, cfg32, coded, w, n), params)
    launches = {k: c.launches for k, c in counters.items()}
    if any(launches[k] != per_step[k] for k in per_step):
        fail(f"slice-vlm-train: f32 coded gradient launches {launches}, expected {per_step}")
    what = (f"f32 {cfg32.num_layers}-layer {cfg32.name} coded gradient ({n * (s + 1)} x "
            f"{b // n} sequences, survivors {survivors}) vs")
    _check_coded_gradient("slice-vlm-train", f"{what} plain path's", got,
                          value_and_grad(lambda p: coded_loss(p, cfg32, coded, w, n, plain=True),
                                         params))
    cb = b // n
    total_loss, total = 0.0, None
    for chunk in range(n):
        part = {k: v[chunk * cb:(chunk + 1) * cb] for k, v in batch.items()}
        loss, grads = value_and_grad(lambda p: chunk_loss_sum(p, cfg32, part), params)
        total_loss += float(loss)
        if total is None:
            total = grads
        else:
            for a, g in zip(tree_leaves(total), tree_leaves(grads)):
                a.add_(g)
        del grads
    for a in tree_leaves(total):
        a.div_(n * cb)
    _check_coded_gradient("slice-vlm-train", f"{what} sum of the {n} chunks' chunk_loss_sum "
                                             f"gradients, each chunk alone",
                          got, (total_loss / (n * cb), total))
    del got, total, params
    torch.cuda.empty_cache()


def _rates(row) -> str:
    """Achieved operation and byte rates of a timing row, and its share of the bound."""
    s = row["ms"] / 1e3
    return (f"{row['ops'] / s / 1e12:.2f} TFLOP/s, {row['bytes'] / s / 1e9:.1f} GB/s, "
            f"{row['bound_ms'] / row['ms']:.3f} of the bound")


def _attention_timings(cfg, heads_view, ptxas) -> list:
    """Both attention kernels at the serving prefill's shape (forward) and the
    coded step's (forward with lse, backward), in bf16 (tensor cores) and f32
    (CUDA cores), each beside SDPA or its autograd, with its achieved rates and
    ptxas line.  Returns the JSON rows: the bf16 forward at the prefill's
    shape and the bf16 backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    replaces = "src/repro/kernels/flash_attention/flash_attention.py:45"
    rows = []

    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        op_type, sfx = ("bf16_tensor", "bf16_kernel<") if bf16 else ("f32", "kernel<float, ")
        for b, s, with_lse in ((BATCH, PROMPT_LEN, False), (TRAIN_SEQS, TRAIN["seq"], True)):
            q = heads_view(b, hq, s, dh, dtype)
            k, v = (heads_view(b, hkv, s, dh, dtype) for _ in range(2))
            pairs = b * hq * s * (s + 1) // 2  # causal (q, k) pairs
            n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q)) + \
                (4 * b * hq * s if with_lse else 0)
            row = _timed(
                "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu", replaces,
                tuple(q.shape), lambda: flash_attention(q, k, v, causal=True, return_lse=with_lse),
                lambda: fa_ref.attention(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
                n_bytes, 4 * dh * pairs, op_type, iters=100)  # q.k and p.v
            _say_attention(row, f"forward {_dtype_name(dtype)}{' with lse' if with_lse else ''}",
                           ptxas, f"attn_fwd_{sfx}{dh}>")
            if bf16 and not with_lse:
                rows.append(row)

        q, do = (heads_view(TRAIN_SEQS, hq, TRAIN["seq"], dh, dtype) for _ in range(2))
        k, v = (heads_view(TRAIN_SEQS, hkv, TRAIN["seq"], dh, dtype) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        y_plain = fa_ref.attention(qr, kr, vr, causal=True)
        y_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, enable_gqa=True)
        pairs = TRAIN_SEQS * hq * TRAIN["seq"] * (TRAIN["seq"] + 1) // 2
        # the bf16 kernels take D from P and dP and never read out
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (q, k, v, do, q, k, v, *(() if bf16 else (out,)))) + \
            lse.numel() * 4
        row = _timed(
            "flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            replaces, tuple(q.shape), lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=True),
            lambda: torch.autograd.grad(y_plain, (qr, kr, vr), do, retain_graph=True),
            lambda: torch.autograd.grad(y_lib, (qr, kr, vr), do, retain_graph=True),
            n_bytes, 10 * dh * pairs, op_type, iters=100)  # S again, dP, dV, dQ, dK
        _say_attention(row, f"backward {_dtype_name(dtype)}", ptxas, f"attn_bwd_dq_{sfx}{dh}>",
                       f"attn_bwd_dkdv_{sfx}{dh}>")
        if bf16:
            rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _attention_dh80_timings(heads_view, ptxas) -> list:
    """Both attention kernels at zamba2-2.7b's shared attention, q, k, v (8,
    32, 500, 80) strided, causal, bf16 (the forward as served, the backward at
    the same shape) beside SDPA or its autograd and the bound; the f32
    forward beside them.  Returns the two bf16 JSON rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    b, hq, hkv, s, _, dh = ATTN_DH80_SERVED[:6]
    replaces = "src/repro/kernels/flash_attention/flash_attention.py:45"
    pairs = b * hq * s * (s + 1) // 2  # causal (q, k) pairs
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        op_type, sfx = ("bf16_tensor", "bf16_kernel<") if bf16 else ("f32", "kernel<float, ")
        q, do = (heads_view(b, hq, s, dh, dtype) for _ in range(2))
        k, v = (heads_view(b, hkv, s, dh, dtype) for _ in range(2))
        row = _timed(
            "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu", replaces,
            tuple(q.shape), lambda: flash_attention(q, k, v, causal=True),
            lambda: fa_ref.attention(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            sum(t.numel() * t.element_size() for t in (q, k, v, q)), 4 * dh * pairs, op_type,
            iters=50)
        _say_attention(row, f"forward {_dtype_name(dtype)} at head dim 80", ptxas,
                       f"attn_fwd_{sfx}{dh}>")
        if not bf16:
            break
        rows.append(row)
        rows.append(_attention_bwd_timing(ATTN_DH80_SERVED, heads_view, ptxas, (q, k, v, do)))
    torch.cuda.empty_cache()
    return rows


def _attention_bwd_timing(case, heads_view, ptxas, qkv_do=None, iters=50) -> dict:
    """The bf16 attention backward at ``case`` (b, hq, hkv, s, s, dh, causal,
    ...; q, k, v and dO strided as the model passes them, or ``qkv_do``)
    beside autograd of its plain version and of SDPA, the device time of
    each of its two launches (dq, dkdv), and the bound: q, k,
    v, dO and lse read once, dq, dk, dv written once (the bf16 kernels take
    D = rowsum(P * dP) from their own P and dP and never read the forward's
    output); S again, dP, dV, dQ and dK over the causal (q, k) pairs.  Returns
    the JSON row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    b, hq, hkv, s, _, dh, causal = case[:7]
    if qkv_do is None:
        q, do = (heads_view(b, hq, s, dh, torch.bfloat16) for _ in range(2))
        k, v = (heads_view(b, hkv, s, dh, torch.bfloat16) for _ in range(2))
    else:
        q, k, v, do = qkv_do
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    y_plain = fa_ref.attention(qr, kr, vr, causal=causal)
    y_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal, enable_gqa=True)
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, do, q, k, v)) + \
        lse.numel() * 4
    row = _timed(
        "flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:45", tuple(q.shape),
        lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=causal),
        lambda: torch.autograd.grad(y_plain, (qr, kr, vr), do, retain_graph=True),
        lambda: torch.autograd.grad(y_lib, (qr, kr, vr), do, retain_graph=True),
        n_bytes, 10 * dh * pairs, "bf16_tensor", iters=iters)
    _say_attention(row, f"backward bf16 at head dim {dh}, kv {tuple(k.shape)}, causal {causal}",
                   ptxas, f"attn_bwd_dq_bf16_kernel<{dh}>", f"attn_bwd_dkdv_bf16_kernel<{dh}>")
    say("timings", f"backward bf16 at head dim {dh} {tuple(q.shape)}, device ms a call by launch: "
                   + ", ".join(f"{name} {ms:.5f}" for name, ms in _launch_ms(
                       lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=causal),
                       20).items()))
    del y_plain, y_lib, qr, kr, vr
    torch.cuda.empty_cache()
    return row


def _attention_served_timing(served, heads_view, ptxas, iters=50) -> dict:
    """The bf16 attention forward at a served shape (``ATTN_DH128_SERVED``,
    ``ATTN_DH256_SERVED``, ``ATTN_AUDIO_SERVED``: q, k, v strided, causal or
    not as served) beside its plain version, SDPA and the bound (q, k, v and
    o once each; the products over the causal half or every pair).  Returns
    the JSON row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    b, hq, hkv, s, _, dh, causal = served[:7]
    q = heads_view(b, hq, s, dh, torch.bfloat16)
    k, v = (heads_view(b, hkv, s, dh, torch.bfloat16) for _ in range(2))
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    row = _timed(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:45", tuple(q.shape),
        lambda: flash_attention(q, k, v, causal=causal),
        lambda: fa_ref.attention(q, k, v, causal=causal),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True),
        sum(t.numel() * t.element_size() for t in (q, k, v, q)), 4 * dh * pairs,
        "bf16_tensor", iters=iters)
    _say_attention(row, f"forward bf16 at head dim {dh}, kv {tuple(k.shape)}, causal {causal}",
                   ptxas, f"attn_fwd_bf16_kernel<{dh}>")
    torch.cuda.empty_cache()
    return row


def _attn_err_key(dh: int, causal: bool) -> str:
    """The ``errs`` key of the bf16 attention forward at a served shape."""
    key = "flash_attention" if dh == 64 else f"flash_attention dh{dh}"
    return key if causal else f"{key} noncausal"


def _say_attention(row, what, ptxas, *labels) -> None:
    built = "; ".join(f"{label}: {ptxas.get(label, 'not in the build log')}" for label in labels)
    say("timings", f"{what} {row['shape']}: kernel {row['ms']:.5f} ms, {_rates(row)} "
                   f"({row['bound_ms']:.5f} ms by {row['bound_by']}); library "
                   f"{_ms(row['library_ms'])} (kernel / library "
                   f"{row['ms'] / row['library_ms']:.3f}); plain {row['plain_ms']:.5f} ms; "
                   f"ptxas {built}")


def _training_timings(dev, cfg, randn, ptxas) -> list:
    """Timing rows of the training path's other kernels, at its shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.gc_coding import coded_combine_tree
    from repro_torch.kernels.gc_coding import ref as gc_ref
    from repro_torch.kernels.gc_coding.gc_coding import coded_combine
    from repro_torch.train.driver import _tree_weighted_sum

    rows = []

    def combine_case(k, d, dtype, iters):
        parts, w = randn(k, d, dtype=dtype), randn(k)
        wl = w.to(dtype)
        n_bytes = parts.numel() * parts.element_size() + d * parts.element_size() + 4 * k
        return _timed(
            "coded_combine", "src/repro_torch/kernels/csrc/gc_coding.cu",
            "src/repro/kernels/gc_coding/gc_coding.py:33", (k, d),
            lambda: coded_combine(parts, w), lambda: gc_ref.coded_combine(parts, w),
            lambda: wl @ parts, n_bytes, 2 * k * d, "f32", iters=iters,
        )

    # the design size: a whole qwen2-0.5b gradient, bf16
    D = cfg.param_count()
    row = combine_case(8, D, torch.bfloat16, 20)
    rows.append(row)
    for k, d, dtype in ((4, D, torch.bfloat16), (3, 9610, torch.float32),
                        (14, 9610, torch.float32), (32, 9610, torch.float32)):
        r = combine_case(k, d, dtype, 20 if d == D else 500)
        say("timings", f"coded_combine k {k} D {d} {_dtype_name(dtype)}: kernel {r['ms']:.5f} ms, "
                       f"plain {r['plain_ms']:.5f} ms, library (w @ parts) {r['library_ms']:.5f} "
                       f"ms, bound {r['bound_ms']:.5f} ms; per call kernel {r['call_ms']:.5f} ms")
    # the driver's tree combine: stack k MLP gradients, concatenate the leaves
    # into one (k, 9610) buffer, one kernel, split back
    shapes = {"w1": (64, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)}
    trees = [{name: randn(*shape) for name, shape in shapes.items()} for _ in range(14)]
    ws = [float(i + 1) for i in range(14)]
    stacked = {name: torch.stack([t[name] for t in trees]) for name in shapes}
    say("timings", f"driver combine of 14 MLP gradients: _tree_weighted_sum "
                   f"{_device_ms(lambda: _tree_weighted_sum(trees, ws), 500):.5f} ms device, "
                   f"{_cuda_ms(lambda: _tree_weighted_sum(trees, ws), 500):.5f} ms per call; "
                   f"coded_combine_tree of the stacked tree "
                   f"{_device_ms(lambda: coded_combine_tree(stacked, ws), 500):.5f} ms device, "
                   f"{_cuda_ms(lambda: coded_combine_tree(stacked, ws), 500):.5f} ms per call")
    torch.cuda.empty_cache()

    rows += _rmsnorm_bwd_timings(dev, cfg, randn, ptxas)
    return rows


def _rmsnorm_bwd_timings(dev, cfg, randn, ptxas) -> list:
    """The RMSNorm backward at the GC and M-SGC coded steps' (8192, 896) and
    (3072, 896), bf16 and f32 (gamma in x's dtype): the kernel, its plain
    version, autograd of ``F.rms_norm`` and the bound, and beside them the same
    kernel built with -DRMSNORM_BWD_TAIL=0 (no barrier, no dgamma sums: the tail
    is the difference) and ``torch.add`` over the same bytes (reads two
    (rows, d) tensors, writes one).  Returns the JSON row: (8192, 896) bf16."""
    import ctypes
    import subprocess

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import _bwd_fn, _plan, rmsnorm_bwd

    lib = _build.BUILD_ROOT / "variants" / f"rmsnorm_bwd_notail_{_build._digest()}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DRMSNORM_BWD_TAIL=0", "-shared", "-I",
                    str(_build.CSRC), str(_build.CSRC / "rmsnorm_bwd.cu"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    notail = ctypes.CDLL(str(lib)).rmsnorm_bwd
    notail.argtypes, notail.restype = _bwd_fn().argtypes, ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    zeros = torch.zeros(2, dtype=torch.int32, device=dev)

    def without_tail(x, g, dy):
        rows, d = x.shape
        dx, dg = torch.empty_like(x), torch.empty_like(g)
        plan = _plan(rows, d, 16 // x.element_size(), sms)
        part = torch.empty((plan.slabs, d), dtype=torch.float32, device=dev)
        code = notail(x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(), dg.data_ptr(),
                      part.data_ptr(), zeros.data_ptr(), rows, d, plan.slabs, plan.rows_per_slab,
                      plan.bucket, True, 1e-6, _build.DTYPE_CODES[x.dtype],
                      _build.DTYPE_CODES[g.dtype], dev.index,
                      ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _build.check(code, "rmsnorm_bwd without its tail")

    out = []
    for rows in (TRAIN_ROWS, MSGC_ROWS):
        for dtype in (torch.bfloat16, torch.float32):
            d = cfg.d_model
            x, dy = randn(rows, d, dtype=dtype), randn(rows, d, dtype=dtype)
            g = randn(d, dtype=dtype)
            xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
            y_plain = rn_ref.rmsnorm(xr, gr)
            y_lib = F.rms_norm(xr, (d,), weight=gr, eps=1e-6)
            row = _timed(
                "rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:22", tuple(x.shape),
                lambda: rmsnorm_bwd(x, g, dy),
                lambda: torch.autograd.grad(y_plain, (xr, gr), dy, retain_graph=True),
                lambda: torch.autograd.grad(y_lib, (xr, gr), dy, retain_graph=True),
                3 * x.numel() * x.element_size() + 2 * g.numel() * g.element_size(),
                10 * x.numel(), "f32", iters=200,
            )
            plan = _plan(rows, d, 16 // x.element_size(), sms)
            pair = "__nv_bfloat16, S1_" if dtype == torch.bfloat16 else "float, float"
            label = f"rmsnorm_bwd_kernel<{pair}, {plan.bucket}>"
            no_tail = _device_ms(lambda: without_tail(x, g, dy), 200)
            sum_out = torch.empty_like(x)
            add = _device_ms(lambda: torch.add(x, dy, out=sum_out), 200)
            ms, bound = row["ms"], row["bound_ms"]
            say("timings", f"rmsnorm_bwd ({rows}, {d}) {_dtype_name(dtype)}: kernel {ms:.5f} ms "
                           f"({bound / ms:.3f} of the {bound:.5f} ms bound); library "
                           f"{row['library_ms']:.5f} ms (kernel / library "
                           f"{ms / row['library_ms']:.3f}); plain {row['plain_ms']:.5f} ms; "
                           f"call_ms {row['call_ms']:.5f}; built without its tail {no_tail:.5f} ms "
                           f"(tail {ms - no_tail:.5f} ms); torch.add over the same bytes "
                           f"{add:.5f} ms; {plan}; ptxas {label}: "
                           f"{ptxas.get(label, 'not in the build log')}")
            if (rows, dtype) == (TRAIN_ROWS, torch.bfloat16):
                out.append(row)
            del x, dy, xr, y_plain, y_lib, sum_out
    torch.cuda.empty_cache()
    return out


def _rmsnorm_bwd_turn(src: str = str(ROOT / "src")) -> None:
    """One turn of comparing two trees' RMSNorm backward in one call: with the
    tree's ``src`` first on sys.path, the device time of ``rmsnorm_bwd`` a call
    and of each kernel it launches, at the coded steps' shapes in bf16 and f32
    (profiler, 200 calls after 20, L2-warm).  Run as
    ``python3 -c "import chip_smoke as c; c._rmsnorm_bwd_turn('build/parent/src')"``."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    import repro_torch
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    say("turn", f"{repro_torch.__file__}; {nvidia_smi()}")
    for rows in (TRAIN_ROWS, MSGC_ROWS):
        for dtype in (torch.bfloat16, torch.float32):
            x, dy = (torch.randn((rows, 896), generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            g = torch.randn(896, generator=gen, device=dev).to(dtype)
            for _ in range(20):
                rmsnorm_bwd(x, g, dy)
            calls = 200
            per: dict[str, list] = {}
            for name, us, _ in _device_events(lambda: [rmsnorm_bwd(x, g, dy)
                                                       for _ in range(calls)]):
                per.setdefault(kernel_label(name), []).append(us)
            total = sum(sum(v) for v in per.values()) / calls
            launches = "; ".join(f"{k}: {len(v)} recorded, mean {statistics.mean(v):.3f} us, "
                                 f"median {statistics.median(v):.3f}" for k, v in per.items())
            say("turn", f"({rows}, 896) {_dtype_name(dtype)}: {total:.3f} us a call; {launches}")


def _ssd_bwd_turn(src: str = str(ROOT / "src")) -> None:
    """One turn of comparing two trees' SSD backward in one call: with the
    tree's ``src`` first on sys.path, the device time of ``ssd_chunk_scan_bwd``
    a call and by launch at [slice-ssm-train]'s shape in bf16, as
    :func:`_ssd_bwd_timing` draws it (profiler, 10 calls after a warm-up).  Run
    as ``python3 -c "import chip_smoke as c; c._ssd_bwd_turn('build/parent/src')"``."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch

    import repro_torch
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan_bwd as scan_bwd

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    say("turn", f"{repro_torch.__file__}; {nvidia_smi()}")
    b, nc, Q, nh, hd, st = TRAIN_SEQS, SSM_TRAIN_SEQ // 64, 64, 64, 64, 128
    bc, s = b * nc, SSM_TRAIN_SEQ
    args = _ssd_inputs(dev, gen, b, nc, Q, nh, hd, st, torch.bfloat16)
    h_prev = torch.randn((bc, nh, hd, st), generator=gen, device=dev) * 0.5
    D = torch.randn(nh, generator=gen, device=dev)
    dy = torch.randn((b, s, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
    per = _launch_ms(lambda: scan_bwd(*args, h_prev, D, dy, nc, s), 10)
    say("turn", f"ssd_chunk_scan_bwd {(bc, Q, nh, hd, st)} bf16: {sum(per.values()):.5f} ms a "
                f"call; " + ", ".join(f"{k} {v:.5f} ms" for k, v in per.items()))


def _sim_parity(ref, got, exact: bool) -> bool:
    """The simulator's parity contract (the JAX package's
    ``core.testing.assert_sim_parity``): exact on done rounds, wait-outs and
    effective patterns; ``exact`` or allclose on the float times."""
    import numpy as np

    same = (ref.scheme == got.scheme and ref.job_done_round == got.job_done_round
            and ref.waitouts == got.waitouts and ref.normalized_load == got.normalized_load
            and ref.effective_pattern.shape == got.effective_pattern.shape
            and bool((ref.effective_pattern == got.effective_pattern).all())
            and sorted(ref.job_done_time) == sorted(got.job_done_time))
    if not same:
        return False
    if exact:
        return (ref.total_time == got.total_time and bool((ref.round_times == got.round_times)
                .all()) and ref.job_done_time == got.job_done_time)
    return (bool(np.isclose(ref.total_time, got.total_time))
            and bool(np.allclose(ref.round_times, got.round_times))
            and all(np.isclose(v, got.job_done_time[j]) for j, v in ref.job_done_time.items()))


def _gate_window_check(dev) -> dict:
    """Both gate-window kernels against their plain versions on the card,
    exact: windows of 0-32 rows (every row bucket's edges), B from 1 to past the
    window, ragged and small n, one cell, the main path's (64, rows, 256),
    (4096, 3, 256) and 5,000 cells (past one wave of blocks), strided,
    misaligned and stride-2 views, a folded spec axis;
    and the views the gate builds (each window's tail at every fill, the
    windows it concatenates), which must take the wide path.  Returns the
    largest integer difference per kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels.gate_window import gate_window as gwk
    from repro_torch.kernels.gate_window import ops, ref

    rng = np.random.default_rng(0)
    worst = {"window_stats": 0, "buffer_stats": 0}
    checked = 0
    paths = {True: 0, False: 0}

    def check(which, x, B, wide=None):
        nonlocal checked
        kernel = getattr(gwk, which)
        before = kernel.wide_launches
        got = getattr(ops, which)(x, B)
        want = getattr(ref, which)(x, B)
        took = kernel.wide_launches > before
        if wide is not None and took != wide:
            fail(f"gate_window {which} {tuple(x.shape)} strides {x.stride()}: the "
                 f"{'wide' if took else 'byte'} path, not the {'wide' if wide else 'byte'} one")
        paths[took] += 1
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"gate_window {which} {tuple(x.shape)} B {B}: {g.dtype} {tuple(g.shape)} "
                     f"vs plain {w.dtype} {tuple(w.shape)}")
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            worst[which] = max(worst[which], err)
            if err:
                fail(f"gate_window {which} {tuple(x.shape)} B {B}: kernel differs from the plain "
                     f"version by {err}")
        checked += 1

    for rows in (0, 1, 2, 3, 4, 5, 8, 9, 10, 16, 17, 32):
        for cells, n in ((1, 7), (5, 33), (37, 130), (64, 256), (3000, 40)):
            x = torch.from_numpy(rng.random((cells, rows, n)) < 0.3).to(dev)
            for B in sorted({1, 2, 3, max(rows, 1), rows + 1}):
                check("buffer_stats", x, B)
                if rows:
                    check("window_stats", x, B)
    # (4096, 3, 256), and more cells than the one wave of blocks the grid holds
    for cells in (4096, 5000):
        x = torch.from_numpy(rng.random((cells, 3, 256)) < 0.05).to(dev)
        for B in (1, 2, 4):
            for which in ("window_stats", "buffer_stats"):
                check(which, x, B, wide=True)
    x = torch.from_numpy(rng.random((3, 37, 5, 130)) < 0.3).to(dev)
    for view in (x, x[1][:, 2:], x[:, :, 1:4].transpose(0, 1)[5], x[2, ::2, ::2, 1::3]):
        for which in ("window_stats", "buffer_stats"):
            check(which, view, 2)
    # views that cannot take 16-byte loads: a misaligned start, a stride-2
    # worker axis, rows off 16 bytes; and aligned rows whose last run n cuts
    x = torch.from_numpy(rng.random((37, 5, 320)) < 0.3).to(dev)
    for view, wide in ((x[:, :, 1:257], False), (x[:, :, ::2], False),
                       (x[:, :, :260].contiguous(), False), (x[:, :, :250], True)):
        for which in ("window_stats", "buffer_stats"):
            check(which, view, 2, wide=wide)
    # the gate's own views at the main path's (64, rows, 256): each window's
    # tail buf[:, w-1-filled:] at every fill, and torch.cat([tail, cand[:, None]])
    gate_views = 0
    cand = torch.from_numpy(rng.random((64, 256)) < 0.3).to(dev)
    for w in (2, 3, 4, 11):
        buf = torch.from_numpy(rng.random((64, w - 1, 256)) < 0.3).to(dev)
        for filled in range(w):
            tail = buf[:, w - 1 - min(filled, w - 1):]
            win = torch.cat([tail, cand[:, None]], dim=1) if tail.shape[1] else cand[:, None]
            for B in (1, 2, tail.shape[1] + 1):
                check("buffer_stats", tail, B, wide=True)
                check("window_stats", win, B, wide=True)
                gate_views += 2
    for fn in (gwk.window_stats, gwk.buffer_stats):
        try:
            fn(torch.zeros(2, 33, 8, dtype=torch.bool, device=dev), 1)
            fail("gate_window: a 33-row window did not raise")
        except ValueError:
            pass
    torch.cuda.synchronize()
    say("gate_window", f"{checked} cases of both kernels exact against their plain versions "
                       f"(largest difference {max(worst.values())}); wide path {paths[True]}, "
                       f"byte path {paths[False]} launches; the gate's {gate_views} "
                       f"tails and windows at (64, rows, 256) all wide; 33 rows refused")
    return worst


def _sim(dev) -> dict:
    """The Table-1 grid through ``simulate_batch`` on the card and on the CPU,
    in both wait-outs; returns the gate-window launches on the card."""
    import numpy as np
    import torch

    from repro_torch.core import make_scheme, simulate, simulate_batch
    from repro_torch.core.kernel import GateKernel
    from repro_torch.kernels.gate_window import gate_window as gwk
    from repro_torch.kernels.gate_window import ref as gwr

    n = SIM["n"]
    traces = _sim_traces()
    simulate_batch([("m-sgc", SIM_PARAMS["m-sgc"])], traces[:2, :8], alpha=SIM["alpha"],
                   device=dev)  # warm-up
    totals = {"window_stats": 0, "buffer_stats": 0}
    exact_cells = cells = 0
    for waitout in ("selective", "all"):
        for name, params in SIM_PARAMS.items():
            spec = [(name, params)]
            for k in (gwk.window_stats, gwk.buffer_stats):
                k.launches = k.wide_launches = 0
            GateKernel.host_syncs = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = simulate_batch(spec, traces, alpha=SIM["alpha"], waitout=waitout,
                                 device=dev)[0, 0]
            wall = time.perf_counter() - t0
            launched = (gwk.window_stats.launches, gwk.buffer_stats.launches)
            if (gwk.window_stats.wide_launches, gwk.buffer_stats.wide_launches) != launched:
                fail(f"sim {name} {waitout}: of the launches {launched}, "
                     f"{gwk.window_stats.wide_launches} and {gwk.buffer_stats.wide_launches} "
                     f"took the wide path")
            syncs = GateKernel.host_syncs
            gwr.window_stats.calls = gwr.buffer_stats.calls = 0
            t0 = time.perf_counter()
            want = simulate_batch(spec, traces, alpha=SIM["alpha"], waitout=waitout,
                                  device="cpu")[0, 0]
            cpu_wall = time.perf_counter() - t0
            plain = (gwr.window_stats.calls, gwr.buffer_stats.calls)
            if launched != plain:
                fail(f"sim {name} {waitout}: kernel launches {launched} on the card, plain "
                     f"calls {plain} on the CPU")
            for c, (w, g) in enumerate(zip(want, got)):
                if not _sim_parity(w, g, exact=False):
                    fail(f"sim {name} {waitout}: cell {c} differs between the card and the CPU")
                exact_cells += _sim_parity(w, g, exact=True)
                cells += 1
            rounds = got[0].rounds
            J = len(got[0].job_done_round)
            for k in range(SIM["parity_traces"]):
                ref = simulate(make_scheme(name, n, J, **params), traces[k], alpha=SIM["alpha"],
                               J=J, waitout=waitout)
                if not _sim_parity(ref, got[k], exact=False):
                    fail(f"sim {name} {waitout}: trace {k} differs from the descriptor simulate")
            totals["window_stats"] += launched[0]
            totals["buffer_stats"] += launched[1]
            mean = float(np.mean([r.total_time for r in got]))
            say("sim", f"{name} {params} {waitout}: {SIM['traces']} cells x {rounds} rounds at n "
                       f"{n} in {wall * 1e3:.3f} ms on the card ({cpu_wall * 1e3:.3f} ms on the "
                       f"CPU); {syncs / rounds:.3f} host syncs per round; launches window_stats "
                       f"{launched[0]}, buffer_stats {launched[1]} (= plain calls on the CPU, all on "
                       f"the wide path); "
                       f"mean total time {mean:.6f} s, waitouts "
                       f"{sum(r.waitouts for r in got)}")
    say("sim", f"card vs CPU: {cells} cells agree (exact on {exact_cells}); descriptor simulate "
               f"agrees on {SIM['parity_traces']} traces per scheme and wait-out")
    if not all(totals.values()):
        fail(f"sim: a gate-window kernel never launched ({totals})")
    # where the device time of a run goes: m-sgc's selective run, profiled
    spec = [("m-sgc", SIM_PARAMS["m-sgc"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate_batch(spec, traces, alpha=SIM["alpha"], device=dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(lambda: simulate_batch(spec, traces, alpha=SIM["alpha"],
                                                   device=dev))
    busy_ms = sum(t for _, t, _ in events) / 1e3
    _breakdown(f"profile sim m-sgc selective, {SIM['rounds']} rounds", events, wall_ms)
    say("profile sim m-sgc selective", f"per round: device busy {busy_ms / SIM['rounds']:.4f} ms "
                                       f"of {wall_ms / SIM['rounds']:.4f} ms wall, "
                                       f"{len(events) / SIM['rounds']:.1f} device activities")
    return totals


def _sim_traces():
    """``[sim]``'s 64 Gilbert-Elliott traces of 44 rounds at n 256."""
    import numpy as np

    from repro_torch.core import GilbertElliotSource

    return np.stack([GilbertElliotSource(n=SIM["n"], seed=SIM["seed0"] + k, **SIM_GE)
                     .sample_delays(SIM["rounds"]) for k in range(SIM["traces"])])


def _grid(dev) -> dict:
    """m-sgc's App.-J grid (``default_grid`` at n 256: 132 candidates) over
    ``[sim]``'s 64 traces x 44 rounds, both wait-outs, grid-fused: on the card
    against ``fuse=False`` on the card (bit for bit) and against the fused run
    on the CPU (the simulator's device contract); gate-window launches = the
    CPU run's plain calls, all on the wide path.  Prints both walls, the round
    loops, the host syncs per bucket-round and a profiled fused run's device
    busy time per round; returns the gate-window launches of the fused runs."""
    import torch

    from repro_torch.core import batch, default_grid, grid_plan, simulate_batch
    from repro_torch.core.kernel import GateKernel
    from repro_torch.kernels.gate_window import gate_window as gwk
    from repro_torch.kernels.gate_window import ref as gwr

    n, rounds, alpha = SIM["n"], SIM["rounds"], SIM["alpha"]
    traces = _sim_traces()
    specs = [("m-sgc", p) for p in default_grid("m-sgc", n)]
    plan = grid_plan(specs, traces)
    sizes = [len(b["specs"]) for b in plan["buckets"]]
    say("grid", f"m-sgc default_grid at n {n}: {len(specs)} candidates in {len(sizes)} buckets "
                f"{sizes} (J {[b['J'] for b in plan['buckets']]}, fused "
                f"{plan['buckets'][0]['fused']}), fallback {plan['fallback']}, infeasible "
                f"{plan['infeasible']}; {SIM['traces']} traces x {rounds} rounds")
    if plan["fallback"] or len(sizes) != 4:
        fail(f"grid: plan {plan}")

    def run(device, **kw):
        loops0, GateKernel.host_syncs = batch._round_loop.calls, 0
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = simulate_batch(specs, traces, alpha=alpha, strict=False, device=device, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, batch._round_loop.calls - loops0, \
            GateKernel.host_syncs

    totals = {"window_stats": 0, "buffer_stats": 0}
    walls = {}
    for waitout in ("selective", "all"):
        for k in (gwk.window_stats, gwk.buffer_stats):
            k.launches = k.wide_launches = 0
        fused, wall, loops, syncs = run(dev, waitout=waitout)
        walls[waitout] = wall
        launched = (gwk.window_stats.launches, gwk.buffer_stats.launches)
        if (gwk.window_stats.wide_launches, gwk.buffer_stats.wide_launches) != launched:
            fail(f"grid {waitout}: of the launches {launched}, {gwk.window_stats.wide_launches} "
                 f"and {gwk.buffer_stats.wide_launches} took the wide path")
        gwr.window_stats.calls = gwr.buffer_stats.calls = 0
        cpu, cpu_wall, cpu_loops, _ = run("cpu", waitout=waitout)
        plain = (gwr.window_stats.calls, gwr.buffer_stats.calls)
        if launched != plain:
            fail(f"grid {waitout}: kernel launches {launched} on the card, plain calls {plain} "
                 f"on the CPU")
        perspec, per_wall, per_loops, per_syncs = run(dev, waitout=waitout, fuse=False)
        if (loops, cpu_loops, per_loops) != (len(sizes), len(sizes), len(specs)):
            fail(f"grid {waitout}: round loops fused {loops}, CPU {cpu_loops}, per spec "
                 f"{per_loops}")
        cells = dead = exact = 0
        for si in range(len(specs)):
            for c in range(SIM["traces"]):
                f, p, w = fused[si, 0, c], perspec[si, 0, c], cpu[si, 0, c]
                if (f is None) != (p is None) or (f is None) != (w is None):
                    fail(f"grid {waitout}: {specs[si]} trace {c}: dead in one run only")
                if f is None:
                    dead += 1
                    continue
                if not _sim_parity(p, f, exact=True):
                    fail(f"grid {waitout}: {specs[si]} trace {c}: fused differs from "
                         f"fuse=False on the card")
                # bits imply the device contract, and are the cheaper check
                same = _sim_parity(w, f, exact=True)
                if not (same or _sim_parity(w, f, exact=False)):
                    fail(f"grid {waitout}: {specs[si]} trace {c}: the card differs from the CPU")
                cells += 1
                exact += same
        totals["window_stats"] += launched[0]
        totals["buffer_stats"] += launched[1]
        say("grid", f"{waitout}: fused {wall * 1e3:.3f} ms on the card in {loops} round loops, "
                    f"{syncs} host syncs ({syncs / (loops * rounds):.3f} per bucket-round); "
                    f"fuse=False {per_wall * 1e3:.3f} ms in {per_loops} loops, {per_syncs} host "
                    f"syncs ({per_syncs / (per_loops * rounds):.3f} per spec-round); "
                    f"{per_wall / wall:.2f}x; CPU fused {cpu_wall * 1e3:.3f} ms; launches "
                    f"window_stats {launched[0]}, buffer_stats {launched[1]} (= plain calls "
                    f"on the CPU, all wide); {cells} cells bit for bit = fuse=False and = the "
                    f"CPU under the device contract (bit for bit on {exact}), {dead} dead in "
                    f"all three [{nvidia_smi()}]")
    # where the device time of the fused selective run goes
    wall_ms = walls["selective"] * 1e3
    events = _device_events(lambda: run(dev))
    busy_ms = sum(t for _, t, _ in events) / 1e3
    bucket_rounds = len(sizes) * rounds
    _breakdown(f"profile grid m-sgc selective, {bucket_rounds} bucket-rounds", events, wall_ms)
    say("profile grid m-sgc selective",
        f"per bucket-round: device busy {busy_ms / bucket_rounds:.4f} ms of "
        f"{wall_ms / bucket_rounds:.4f} ms wall, {len(events) / bucket_rounds:.1f} device "
        f"activities ({sum(sizes) // len(sizes) * SIM['traces']} cells a bucket)")
    return totals


def _select(dev) -> None:
    """App.-J selection on the card, grid-fused and with ``REPRO_GRID_FUSE=0``
    (one round loop a candidate), against the legacy per-candidate loop."""
    import numpy as np

    from repro_torch.core import (
        GilbertElliotSource,
        batch,
        select_parameters,
        select_parameters_legacy,
    )

    n = SIM["n"]
    src = GilbertElliotSource(n=n, seed=100, **SIM_GE)
    probe = src.sample_delays(30)
    for name, grid in SELECT_GRIDS.items():
        got = {}
        prior = os.environ.get("REPRO_GRID_FUSE")
        for fuse in ("1", "0"):
            os.environ["REPRO_GRID_FUSE"] = fuse
            loops0 = batch._round_loop.calls
            t0 = time.perf_counter()
            try:
                got[fuse] = select_parameters(name, n, probe, alpha=src.alpha, grid=grid,
                                              device=dev)
            finally:
                if prior is None:
                    del os.environ["REPRO_GRID_FUSE"]
                else:
                    os.environ["REPRO_GRID_FUSE"] = prior
            got[fuse + "wall"] = time.perf_counter() - t0
            got[fuse + "loops"] = batch._round_loop.calls - loops0
        t0 = time.perf_counter()
        want = select_parameters_legacy(name, n, probe, alpha=src.alpha, grid=grid)
        t_legacy = time.perf_counter() - t0
        fused, unfused = got["1"], got["0"]
        say("select", f"{name} over {len(grid)} candidates at n {n}: {fused.params} (load "
                      f"{fused.load:.6f}, {fused.est_time:.6f} s per job); on the card fused "
                      f"{got['1wall'] * 1e3:.3f} ms in {got['1loops']} round loops, fuse=False "
                      f"{got['0wall'] * 1e3:.3f} ms in {got['0loops']}; legacy {want.params} "
                      f"({want.est_time:.6f} s per job) in {t_legacy * 1e3:.3f} ms")
        if (fused.params, fused.load, fused.est_time) != \
                (unfused.params, unfused.load, unfused.est_time):
            fail(f"select {name}: fused chose {fused}, fuse=False {unfused}")
        if got["0loops"] != len(grid) or not got["1loops"] < len(grid):
            fail(f"select {name}: round loops fused {got['1loops']}, fuse=False "
                 f"{got['0loops']}")
        if (fused.params, fused.load) != (want.params, want.load) or \
                not np.isclose(fused.est_time, want.est_time):
            fail(f"select {name}: the card chose {fused}, the legacy loop {want}")


def _adaptive(dev) -> None:
    """run_adaptive at Fig. 18's configuration, against never switching."""
    import numpy as np

    from repro_torch.core import GilbertElliotSource, make_scheme, simulate
    from repro_torch.kernels.gate_window import gate_window as gwk
    from repro_torch.kernels.gc_coding.gc_coding import coded_combine
    from repro_torch.train import run_adaptive

    a = ADAPTIVE
    delays = GilbertElliotSource(n=a["n"], p_ns=SIM_GE["p_ns"], p_sn=SIM_GE["p_sn"],
                                 slow_factor=SIM_GE["slow_factor"],
                                 seed=a["seed"]).sample_delays(a["J"] + 8)
    for c in (coded_combine, gwk.window_stats, gwk.buffer_stats):
        c.launches = 0
    t0 = time.perf_counter()
    total, probe, params, drv = run_adaptive(a["models"], a["J"], delays, scheme_name="m-sgc",
                                             t_probe=a["t_probe"], grid=a["grid"], device=dev)
    wall = time.perf_counter() - t0
    launched = (coded_combine.launches, gwk.buffer_stats.launches)
    never = simulate(make_scheme("uncoded", a["n"], a["J"]), delays, alpha=8.0,
                     J=a["J"]).total_time
    final = [drv.losses[m][-1] for m in range(a["models"])]
    say("adaptive", f"n {a['n']}, {a['J']} jobs, {a['t_probe']}-round uncoded probe, "
                    f"{a['models']} models: selected {params}; simulated clock {total:.6f} s "
                    f"(probe {probe:.6f} s) vs never switching {never:.6f} s; wall {wall:.3f} s; "
                    f"coded_combine launches {launched[0]}, buffer_stats {launched[1]}; final "
                    f"losses {[round(x, 4) for x in final]}")
    if not total < never:
        fail(f"adaptive: switching ({total:.6f} s) does not beat never switching ({never:.6f} s)")
    if not np.isfinite(final).all() or not all(launched):
        fail(f"adaptive: losses {final}, launches {launched}")


def _scenarios(dev) -> None:
    """``scenario_sweep`` over ``trace_library(256, 40, 16)`` with
    ``scheme_grid(256)``'s specs on the card and on the CPU: every cell equal
    under the simulator's device contract, the dominance and equal-load gates,
    and the gate-window launches equal to the CPU run's plain calls, all wide."""
    import numpy as np

    from repro_torch.kernels.gate_window import gate_window as gwk
    from repro_torch.kernels.gate_window import ref as gwr
    from repro_torch.launch.scenarios import scenario_sweep, scheme_grid

    sc = SCENARIOS
    specs = scheme_grid(sc["n"])
    args = (sc["n"], sc["rounds"], sc["traces"], specs)
    for k in (gwk.window_stats, gwk.buffer_stats):
        k.launches = k.wide_launches = 0
    try:
        t0 = time.perf_counter()
        got = scenario_sweep(*args, seed=sc["seed"], device=dev, quiet=True)
        wall = time.perf_counter() - t0
        launched = (gwk.window_stats.launches, gwk.buffer_stats.launches)
        wide = (gwk.window_stats.wide_launches, gwk.buffer_stats.wide_launches)
        gwr.window_stats.calls = gwr.buffer_stats.calls = 0
        t0 = time.perf_counter()
        want = scenario_sweep(*args, seed=sc["seed"], device="cpu", quiet=True)
        cpu_wall = time.perf_counter() - t0
    except AssertionError as err:
        fail(f"scenarios: a gate of the sweep failed: {err}")
    plain = (gwr.window_stats.calls, gwr.buffer_stats.calls)
    # the selective gate checks its members through buffer_stats alone
    if launched != plain or wide != launched or not launched[1]:
        fail(f"scenarios: gate-window launches {launched} (wide {wide}) on the card, plain "
             f"calls {plain} on the CPU")
    cells = exact = 0
    for name, grid in got.grids.items():
        for w, g in zip(want.grids[name].ravel(), grid.ravel()):
            if not _sim_parity(w, g, exact=False):
                fail(f"scenarios {name} {g.scheme}: a cell differs between the card and the CPU")
            exact += _sim_parity(w, g, exact=True)
            cells += 1
    labels = [label for label, _, _ in specs]
    gc_s = {label: params for label, _, params in specs}["gc"]["s"]
    for name in got.grids:
        means = {label: got.means[(name, label)] for label in labels}
        say("scenarios", f"{name}: {got.walls[name] * 1e3:.3f} ms on the card "
                         f"({want.walls[name] * 1e3:.3f} ms on the CPU); mean per-job s "
                         f"{ {k: round(v, 6) for k, v in means.items()} }; fastest "
                         f"{min(means, key=means.get)}")
        for lb in ("dc-gc", "sb-gc"):
            if not means[lb] <= means["gc"] + 1e-9:
                fail(f"scenarios {name}: {lb} {means[lb]} slower than gc {means['gc']}")
    loads = {label: got.grids[next(iter(got.grids))][i, 0, 0].normalized_load
             for i, label in enumerate(labels)}
    say("scenarios", f"n {sc['n']}, {len(got.grids)} scenarios x {len(specs)} schemes x "
                     f"{sc['traces']} traces of {sc['rounds']} rounds: {wall:.3f} s on the card, "
                     f"{cpu_wall:.3f} s on the CPU; {cells} cells agree (exact on {exact}); "
                     f"equal load {(gc_s + 1) / sc['n']:.6f} for {got.eq_load}; "
                     f"loads {loads}; dc-gc and sb-gc never slower than gc; launches "
                     f"window_stats {launched[0]}, buffer_stats {launched[1]} (= plain calls on "
                     f"the CPU, all on the wide path)")
    if not np.isfinite(list(got.means.values())).all():
        fail("scenarios: non-finite per-job times")


def _multimodel(dev) -> None:
    """``multimodel_training`` at the example's 64 workers and 4 models over 16
    jobs: every decoded gradient of the 7 schemes within DECODE_TOL of the
    full-batch one, and one ``coded_combine`` launch per encode and decode."""
    import numpy as np

    from repro_torch.kernels.gc_coding.gc_coding import coded_combine
    from repro_torch.launch.scenarios import multimodel_training

    m = MULTIMODEL
    coded_combine.launches = 0
    t0 = time.perf_counter()
    runs = multimodel_training(m["jobs"], m["workers"], m["models"], check_decodes=True,
                               device=dev, quiet=True)
    wall = time.perf_counter() - t0
    launched = coded_combine.launches
    combines = sum(r.driver.encodes + r.driver.decodes for r in runs.values())
    for label, r in runs.items():
        drv = r.driver
        say("multimodel", f"{label}: load {r.load:.6f}, T {r.T}, simulated clock "
                          f"{r.clock:.6f} s; {drv.encodes} encodes + {drv.decodes} decodes; "
                          f"decoded vs full-batch gradient max_abs_err {r.max_decode_err:.3e} "
                          f"(tol {DECODE_TOL:g}); final losses "
                          f"{[round(x, 4) for x in r.final_losses]}")
        if not r.max_decode_err <= DECODE_TOL:
            fail(f"multimodel {label}: a decoded gradient is off by {r.max_decode_err:.3e}")
        if not np.isfinite(r.final_losses).all():
            fail(f"multimodel {label}: non-finite losses {r.final_losses}")
    gain = 1 - runs["m-sgc"].clock / runs["gc"].clock
    say("multimodel", f"{m['workers']} workers, {m['models']} models, batch 256, "
                      f"{m['jobs']} jobs, 7 schemes in {wall:.3f} s; coded_combine launches "
                      f"{launched} = {combines} encodes + decodes; M-SGC vs GC simulated-clock "
                      f"gain {gain:.4f}")
    if launched != combines or not launched:
        fail(f"multimodel: {launched} coded_combine launches for {combines} encodes + decodes")


def _coded_train(dev, cfg) -> None:
    """``coded_train`` (bench_coded_train) at full qwen2-0.5b width in bf16:
    the 7 schemes through VectorizedCodedTrainer on ge-bursty and
    replayed-waves, its three gates, exact launches per step, peak memory, and
    a profiled dc-gc step."""
    import numpy as np
    import torch

    from repro_torch.core import make_scheme, trace_library
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.launch.scenarios import CODED_BATCH, coded_train, scheme_grid
    from repro_torch.train import VectorizedCodedTrainer

    c = CODED_TRAIN
    counters = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
                "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd}
    L = cfg.num_layers
    # as [train-full]: the layer bodies' forward kernels run again in the backward
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd": L, "rmsnorm": 4 * L + 1,
                "rmsnorm_bwd": 2 * L + 1}
    profiled = {}

    def device_ms(fn, reps):
        # the isolated step's device time: the eager step's wall is set by the
        # host's ~7,000 launches a step, which the bench's jitted step never
        # pays; its launches stay out of the counts the path is held to.  One
        # profiled call after the warm-ups: a step's device time is steady
        # from call to call, and each call is ~6,900 activities to trace
        before = {k: v.launches for k, v in counters.items()}
        got = _profiled(fn, 1)
        for k, v in counters.items():
            v.launches = before[k]
        if got["ms"] is None:
            fail("coded-train: the profiler recorded no device time for an isolated step")
        profiled[len(profiled)] = got
        return got["ms"]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    try:
        res = coded_train(c["n"], c["models"], c["jobs"], cfg=cfg, seq_len=c["seq"], lr=1e-4,
                          step_timer=device_ms, device=dev, quiet=True)
    except AssertionError as err:
        fail(f"coded-train: a gate failed: {err}")
    wall = time.perf_counter() - t0
    launched = {k: v.launches for k, v in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for (trace, label), clock in res.sim_clock.items():
        say("coded-train", f"{trace} {label}: load {res.loads[label]:.4f}, simulated clock "
                           f"{clock:.6f} s, coded step {res.step_ms[(trace, label)]:.3f} ms "
                           f"median after a warm-up, final loss "
                           f"{res.final_loss[(trace, label)]:.4f}")
    say("coded-train", f"qwen2-0.5b bf16, {c['models']} models, n {c['n']}, batch "
                       f"{CODED_BATCH} x {c['seq']} tokens, {c['jobs']} jobs, trace_library(n="
                       f"{c['n']}, rounds={c['jobs'] + 8}): {res.steps} coded steps in "
                       f"{wall:.3f} s; "
                       f"max_memory_allocated {peak} B; launches per step "
                       f"{ {k: v / res.steps for k, v in launched.items()} } (expected "
                       f"{per_step})")
    wall_ratio = res.step_ms[("ge-bursty", "m-sgc")] / res.step_ms[("ge-bursty", "gc")]
    say("coded-train", f"isolated coded step, device ms from the profiler (job 1, unit "
                       f"weights, one call after 10): "
                       f"{ {k: round(v, 3) for k, v in res.isolated_ms.items()} }; M-SGC/GC "
                       f"{res.ratio:.4f} (the gate); on the host clock in the ge-bursty runs "
                       f"{wall_ratio:.4f}; activities recorded "
                       f"{[(p['recorded'], p['expected']) for p in profiled.values()]}")
    if any(launched[k] != per_step[k] * res.steps for k in per_step):
        fail(f"coded-train: launches {launched} over {res.steps} steps, expected {per_step} "
             "per step")
    if not (res.sim_clock[("ge-bursty", "m-sgc")] < res.sim_clock[("ge-bursty", "gc")]
            and res.ratio < 1.0 and np.isfinite(list(res.final_loss.values())).all()
            and res.steps == 7 * 2 * c["jobs"]):
        fail(f"coded-train: gates or steps do not hold ({res.steps} steps, ratio {res.ratio})")
    # one dc-gc step profiled: the coded view of a re-clustered GC round
    (label, name, kw), = [s for s in scheme_grid(c["n"]) if s[0] == "dc-gc"]
    sc = trace_library(n=c["n"], rounds=c["jobs"] + 8, num_traces=1, seed=0)[0]
    tr = VectorizedCodedTrainer(scheme=make_scheme(name, c["n"], 4, **kw), cfg=cfg,
                                num_models=c["models"], batch_size=CODED_BATCH,
                                seq_len=c["seq"], lr=1e-4, seed=0, device=dev)
    step, times, last = tr._step, [], {}

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        last["args"] = args
        return out

    tr._step = timed
    tr.run(4, sc.delays[0])
    _breakdown("profile coded-train dc-gc step", _device_events(lambda: step(*last["args"])),
               statistics.median(times[1:]) * 1e3)
    del tr, last
    torch.cuda.empty_cache()


def _meminfo_gb(key: str = "MemAvailable") -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _compute_apps() -> list[tuple[int, float]]:
    """(pid, used MiB) of every process nvidia-smi lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [(int(p), float(m)) for p, m in (line.split(",") for line in out.strip().splitlines()
                                            if line.strip())]


def _card_used_gb() -> float:
    """Memory in use on the card, every process's (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return float(out.strip().splitlines()[0]) * 2**20 / 1e9


def _harness_replay(name, params, delays, alpha, J):
    """Walk a scheme over its simulated pattern: the vectors each round ships
    (items per worker), the simulator's result."""
    import numpy as np
    from repro_torch.core import make_scheme, simulate_fast
    from repro_torch.dist.master import _item_for

    n = delays.shape[1]
    sim = simulate_fast(make_scheme(name, n, J, **params), delays, mu=1.0, alpha=alpha, J=J)
    sch = make_scheme(name, n, J, **params)
    per_round = []
    for t in range(1, J + sch.T + 1):
        per = [0] * n
        for mt in sch.assign(t):
            if _item_for(sch, mt, list(range(1, J + 1))) is not None:
                per[mt.worker] += 1
        per_round.append(per)
        sch.observe(t, sim.effective_pattern[t - 1])
        sch.collect(t)
    return np.array(per_round), sim


def _pipe_s(obj, recv) -> float:
    """Seconds to receive ``obj`` with ``recv`` from a pipe that a thread of
    this process sends it into."""
    import multiprocessing as mp
    import threading

    a, b = mp.Pipe()
    sender = threading.Thread(target=b.send, args=({"values": [("v", obj)]},))
    t0 = time.perf_counter()
    sender.start()
    recv(a)
    dt = time.perf_counter() - t0
    sender.join()
    a.close()
    b.close()
    return dt


def _harness_probe(dev, cfg, counters) -> dict:
    """An in-process grad-mode TaskComputer on the card, as a worker runs it:
    exact launches and the plain path's values for a GC row (k 2), an M-SGC
    d1 part (k 1) and an M-SGC d2 row (k lambda+1 = 2; lambda = n has no D2,
    so this row comes from the same B, W at lambda 1); the value's time and a
    pickle round trip of its vector, which size the round timeouts; the
    full-batch gradient's scale, which sizes the decode tolerance."""
    import pickle

    import numpy as np
    import torch

    from repro_torch.core import make_scheme
    from repro_torch.data.synthetic import chunk_boundaries
    from repro_torch.dist import TaskComputer
    from repro_torch.dist.master import _chunk_fractions, _item_for
    from repro_torch.dist.transport import _recv
    from repro_torch.dist.worker import ravel_into
    from repro_torch.kernels.gc_coding import ref as gc_ref
    from repro_torch.models import loss_fn
    from repro_torch.train.coded import value_and_grad

    h, phase = HARNESS, "harness"
    n, J, B = h["n"], h["jobs"], h["batch"]
    per = _per_step(cfg)
    names = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "coded_combine")

    def first(sch, kind):
        for t in range(1, J + sch.T + 1):
            for mt in sch.assign(t):
                if mt.kind == kind and not mt.trivial:
                    return sch, _item_for(sch, mt, list(range(1, J + 1)))
            sch.observe(t, np.zeros(n, dtype=bool))
            sch.collect(t)
        fail(f"{phase}: no {kind} task in {sch.name}")

    probes = [("gc row", *first(make_scheme("gc", n, J, **HARNESS_RUNS[0][1]), "ell")),
              ("m-sgc d1", *first(make_scheme("m-sgc", n, J, **HARNESS_RUNS[1][1]), "d1")),
              ("m-sgc d2 (lambda 1)",
               *first(make_scheme("m-sgc", n, J, **{**HARNESS_RUNS[1][1], "lam": 1}), "d2"))]
    tc = None
    out = {}
    for label, sch, item in probes:
        bounds = tuple(chunk_boundaries(B, _chunk_fractions(sch)))
        if tc is None:
            tc = TaskComputer(h["seed"], "grad", 8, B, bounds, model_cfg=cfg, batch_size=B,
                              seq_len=h["seq"], device="cuda")
        tc.set_bounds(bounds)
        tc.warmup()
        torch.cuda.synchronize()
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        got = tc.value(item)
        t_value = time.perf_counter() - t0
        launches = {k: counters[k].launches for k in names}
        k_chunks = len(item["chunks"])
        want = {k: k_chunks * per[k] for k in names}
        want["coded_combine"] = 1
        say(phase, f"in-process TaskComputer, {label} {item['key']} (k {k_chunks}, rows "
                   f"{[tc.bounds[c] for c in item['chunks']]}): launches {launches}; "
                   f"value {t_value:.3f} s")
        if launches != want:
            fail(f"{phase}: {label} launched {launches}, want {want}")
        # the plain path on the card: autograd of the plain versions, the plain
        # combine
        params, batch = tc._grad_data(item["job"])
        parts = torch.empty((k_chunks, got.size), dtype=torch.float32, device=dev)
        for r, c in enumerate(item["chunks"]):
            lo, hi = tc.bounds[c]
            cb = {key: v[lo:hi] for key, v in batch.items()}
            _, grads = value_and_grad(
                lambda p: loss_fn(p, cfg, cb, aux_weight=0.0, plain=True) * (hi - lo), params)
            ravel_into(parts[r], grads)
        plain = gc_ref.coded_combine(parts, torch.tensor(item["coeffs"], device=dev)).cpu().numpy()
        err = float(np.abs(got - plain).max())
        ok = np.allclose(got, plain, **CODED_GRAD_TOL)
        say(phase, f"{label}: value against the plain path on the card: max_abs_err {err:.3e} "
                   f"(rtol {CODED_GRAD_TOL['rtol']}, atol {CODED_GRAD_TOL['atol']}) "
                   f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{phase}: {label}: the kernels' value disagrees with the plain path")
        del parts, params, batch
        if label == "gc row":
            t0 = time.perf_counter()
            back = pickle.loads(pickle.dumps(got, protocol=pickle.HIGHEST_PROTOCOL))
            out.update(value_s=t_value, pickle_s=time.perf_counter() - t0, bytes=got.nbytes,
                       size=got.size)
            del back
            # a reply through a pipe, as the master receives it: the port's
            # bounded reads, and Connection.recv at a tenth of the size (its
            # whole-remainder reads cost the square of the size)
            tenth = got[:got.size // 10].copy()
            conn_s = _pipe_s(tenth, lambda c: c.recv())
            tenth_s = _pipe_s(tenth, _recv)
            out["pipe_s"] = _pipe_s(got, _recv)
            say(phase, f"one reply through a pipe: {got.nbytes / 1e6:.0f} MB in "
                       f"{out['pipe_s']:.3f} s (bounded reads); {tenth.nbytes / 1e6:.0f} MB in "
                       f"{tenth_s:.3f} s (bounded reads), {conn_s:.3f} s (Connection.recv); "
                       f"a pickle round trip of the vector {out['pickle_s']:.3f} s")
            chunk_sum = sum(tc.chunk_grad(1, c) for c in range(len(tc.bounds)))
            full = tc.full_grad(1)
            out["gmax"] = float(np.abs(full).max())
            out["chunk_sum_err"] = float(np.abs(chunk_sum - full).max())
            del chunk_sum, full
    del tc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _harness(dev) -> dict:
    """[harness]: ``run_harness`` end to end on the card (module docstring)."""
    import threading

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import GilbertElliotSource, simulate_lockstep
    from repro_torch.dist import FaultSpec, HarnessConfig, run_harness
    from repro_torch.kernels.gate_window import gate_window as gwk
    from repro_torch.kernels.gate_window import ref as gwr

    h, phase = HARNESS, "harness"
    n, J, B, S = h["n"], h["jobs"], h["batch"], h["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    host_avail = _meminfo_gb()
    say(phase, f"before the phase: card {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB "
               f"(this process holds {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved); "
               f"host MemAvailable {host_avail:.2f} GB")
    cfg = get_config(ARCH).replace(num_layers=h["layers"], dtype="float32")
    counters = _train_counters()
    probe = _harness_probe(dev, cfg, counters)
    vec_gb = probe["bytes"] / 1e9
    say(phase, f"{ARCH} at full width, {h['layers']} of {get_config(ARCH).num_layers} layers, "
               f"f32: {probe['size']:,} parameters, {vec_gb:.3f} GB a vector; {n} workers, "
               f"{J} jobs of {B} x {S} tokens")

    src = GilbertElliotSource(n=n, **HARNESS_GE)
    delays = src.sample_delays(J + 8)
    alpha = src.alpha
    plans = {name: _harness_replay(name, params, delays, alpha, J)
             for name, params in HARNESS_RUNS}
    # host memory: the master keeps every non-straggler result until the run
    # ends, each worker caches its last 5 rounds' values (the resend path), and
    # a vector in flight is a pickled copy on each side of its pipe
    plan_gb = {}
    for name, (per_round, sim) in plans.items():
        shipped = int(per_round.sum())
        kept = int((per_round * ~sim.effective_pattern[:len(per_round)]).sum())
        cached = max(int(per_round[max(0, t - 4):t + 1, w].sum())
                     for w in range(n) for t in range(len(per_round)))
        plan_gb[name] = (kept + n * cached + 2 * n) * vec_gb
        say(phase, f"reckoning {name}: {len(per_round)} rounds, {shipped} vectors through the "
                   f"pipes ({shipped * vec_gb:.1f} GB), the master keeps {kept} "
                   f"({kept * vec_gb:.1f} GB), a worker caches <= {cached}; host peak "
                   f"<= {plan_gb[name]:.1f} GB of {host_avail:.1f} GB available")
    if max(plan_gb.values()) > HARNESS_HOST_SHARE * host_avail:
        fail(f"{phase}: the reckoning {plan_gb} exceeds {HARNESS_HOST_SHARE} of MemAvailable")

    atol = HARNESS_DECODE_REL * probe["gmax"]
    say(phase, f"decode_atol {atol:.3e} = {HARNESS_DECODE_REL:g} x max|g| {probe['gmax']:.4e} "
               f"(job 1's full-batch gradient); the chunks' sum against it: "
               f"{probe['chunk_sum_err']:.3e}")
    if probe["chunk_sum_err"] > atol:
        fail(f"{phase}: the chunk gradients do not add up to the full-batch gradient")
    # round timeouts from the probe: a worker's items computed in turn, then
    # every vector of the round read by the master one after another (its
    # pipe and a pickle round trip each), at 2x
    max_items = max(int(p.max()) for p, _ in plans.values())
    max_vectors = max(int(p.sum(axis=1).max()) for p, _ in plans.values())
    wire_s = probe["pipe_s"] + probe["pickle_s"]

    def timeouts(scale):
        planned = float(delays.max()) + alpha
        timeout = 2 * (planned * scale + max_items * probe["value_s"]
                       + max_vectors * wire_s) + 5.0
        return timeout, 3 * timeout + 30.0

    base = dict(alpha=alpha, seed=h["seed"], compute="grad", model_cfg=cfg, batch_size=B,
                seq_len=S, device="cuda", decode_atol=atol)
    # polled while a run goes on: the card's compute processes (the first
    # run), the card's memory in use by every process, the host's available
    def poll(mon):
        while not mon["stop"].is_set():
            if mon["apps"]:
                mon["snaps"].append(_compute_apps())
            mon["card"] = max(mon["card"], _card_used_gb())
            mon["host"] = min(mon["host"], _meminfo_gb())
            mon["stop"].wait(0.5)

    per_step = _per_step(cfg)
    names = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "coded_combine")
    runs = [(name, params, h["time_scale"], {}) for name, params in HARNESS_RUNS]
    kill = HARNESS_KILL
    runs.append(("gc", HARNESS_RUNS[0][1], None, dict(
        faults={kill["worker"]: FaultSpec(kill_after=kill["kill_after"])},
        respawn_max_attempts=kill["respawns"])))
    startup = None
    results = {}
    for k, (name, params, scale, extra) in enumerate(runs):
        label = name if not extra else f"{name} kill {kill['worker']}@{kill['kill_after']}"
        if scale is None:
            # the rounds after the kill must outlast a worker's start-up (the
            # first run's fleet start-up, 4 at once: an upper bound for 1), so
            # the replacement rejoins before the run ends: their analytic
            # time, scaled, is at least that
            after = float(plans[name][1].round_times[kill["kill_after"]:J].sum())
            scale = max(h["time_scale"], startup / after)
        timeout, hard = timeouts(scale)
        cfg_h = HarnessConfig(**base, time_scale=scale, round_timeout=timeout,
                              round_hard_timeout=hard, **extra)
        for c in counters.values():
            c.launches = 0
        gc.collect()
        torch.cuda.empty_cache()
        if k == 0:
            apps_before = _compute_apps()
        mon = {"apps": k == 0, "snaps": [], "stop": threading.Event(), "card": 0.0,
               "host": _meminfo_gb()}
        card0, host0 = _card_used_gb(), mon["host"]
        thread = threading.Thread(target=poll, args=(mon,), daemon=True)
        thread.start()
        torch.cuda.reset_peak_memory_stats(dev)
        t_call = time.perf_counter()
        try:
            res = run_harness(name, n, J, delays, params=params, config=cfg_h)
        finally:
            mon["stop"].set()
            thread.join()
        wall = time.perf_counter() - t_call
        fleet_s = res.ledger.records[0].start - t_call if res.ledger.records else float("nan")
        if k == 0:
            startup = fleet_s
        results[label] = res
        say(phase, f"{label}: time_scale {scale:.4g}, round_timeout {timeout:.1f} s, hard "
                   f"{hard:.1f} s; fleet start-up {fleet_s:.2f} s, run {wall:.2f} s; rounds "
                   f"{res.ledger.rounds}, measured makespan {res.measured_makespan:.3f} s, "
                   f"analytic {res.analytic_makespan:.3f} s (agreement {res.agreement:.3f}); "
                   f"decoded {res.decoded_jobs}, decode_max_err {res.decode_max_err:.3e} (atol "
                   f"{atol:.3e}); retries {res.retries}, waitouts {res.waitouts}, deaths "
                   f"{res.deaths}, respawns {res.respawns}, rejoins {res.rejoins}; peaks: "
                   f"the master's allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} "
                   f"GB, the card's in use {mon['card']:.2f} GB (before the run {card0:.2f}), "
                   f"the host's used {host0 - mon['host']:.2f} GB over the run")
        for rec in res.ledger.records:
            cols = {f: [getattr(st, f) for st in rec.stats if getattr(st, f) is not None]
                    for f in ("compute_s", "wire_send_s", "wire_recv_s", "delay_s")}
            # the master's own share: the round's end after its last result
            # (the gate, the loop, the mu-rule floor's sleep)
            last = max((st.reported for st in rec.stats if st.reported is not None),
                       default=rec.start)
            say(phase, f"  round {rec.t}: {rec.duration_s:.3f} s (analytic {rec.analytic_s:.3f}),"
                       f" stragglers {np.flatnonzero(rec.effective_row).tolist()}, waited "
                       f"{rec.waited}; after the last result {rec.start + rec.duration_s - last:.3f}"
                       f" s; per worker " + ", ".join(
                           f"{f} {' '.join(f'{v:.3f}' for v in vals)}" for f, vals in cols.items()))
        if res.aborted:
            fail(f"{phase}: {label} aborted: {res.abort_reason}")
        if sorted(res.decoded_jobs) != list(range(1, J + 1)) or res.decode_max_err > atol:
            fail(f"{phase}: {label}: decoded {res.decoded_jobs}, err {res.decode_max_err}")
        # the master's full-batch truth: one gradient a decoded job, on the card
        launches = {c: counters[c].launches for c in names}
        want = {c: J * per_step[c] for c in names}
        want["coded_combine"] = 0
        say(phase, f"{label}: the master's launches (its truth: one full-batch gradient a "
                   f"job) {launches}")
        if launches != want:
            fail(f"{phase}: {label}: the master launched {launches}, want {want}")
        if k == 0:
            # nvidia-smi lists the processes of a container by PIDs of another
            # namespace (every one as 1 on the card's host), so the check
            # counts them, against the count before the run (the master)
            snap = max(mon["snaps"], key=len, default=[])
            say(phase, f"compute processes on the card (pid, MiB as nvidia-smi lists them): "
                       f"before the run {apps_before}; mid-run, the fullest of "
                       f"{len(mon['snaps'])} polls, {snap}")
            if len(apps_before) != 1 or len(snap) < n + 1:
                fail(f"{phase}: the master and {n} workers are not all on the card: {snap}")
        if extra:
            kinds = [ev["kind"] for ev in res.events if ev.get("worker") == kill["worker"]]
            say(phase, f"{label}: worker {kill['worker']}'s events {res.events}")
            if res.respawns < 1 or res.rejoins < 1 or not (
                    "death" in kinds and "rejoin" in kinds
                    and kinds.index("death") < kinds.index("respawn") < kinds.index("rejoin")):
                fail(f"{phase}: {label}: the respawned worker did not rejoin: {res.events}")
            continue
        # fault-free: the recording replays bit for bit through the simulator,
        # and through the lockstep engine on the card (its gate kernels)
        sim = plans[name][1]
        same = (np.array_equal(res.trace_model.pattern, sim.effective_pattern)
                and res.decoded_jobs == sim.job_done_round
                and np.allclose(res.analytic_round_times, sim.round_times * scale))
        gwr.window_stats.calls = gwr.buffer_stats.calls = 0
        cpu = simulate_lockstep(name, params, delays[None], mu=1.0, alpha=alpha, J=J,
                                device="cpu")[0]
        for g in (gwk.window_stats, gwk.buffer_stats):
            g.launches = 0
        card = simulate_lockstep(name, params, delays[None], mu=1.0, alpha=alpha, J=J,
                                 device=dev)[0]
        gate = (gwk.window_stats.launches, gwk.buffer_stats.launches)
        plain_calls = (gwr.window_stats.calls, gwr.buffer_stats.calls)
        lock_ok = (_sim_parity(sim, card, exact=False)
                   and np.array_equal(card.effective_pattern, res.trace_model.pattern)
                   and gate == plain_calls)
        say(phase, f"{label}: recorded pattern {res.trace_model.pattern.astype(int).tolist()}; "
                   f"simulate_fast replay {'bit for bit' if same else 'MISMATCH'}; "
                   f"simulate_lockstep on the card {'equal' if lock_ok else 'MISMATCH'} (gate "
                   f"launches window/buffer {gate}, the CPU's plain calls {plain_calls})")
        if not (same and lock_ok):
            fail(f"{phase}: {label}: the recording does not replay")
    return {"startup_s": startup}


def _launch(dev, heads_view) -> None:
    """[launch]: the launch tooling on the card (``repro_torch.launch``).

    (b) first, on meta tensors over a (1, 1) mesh of the rank-only group: the
    dry-run's count of one train step at full qwen2-0.5b width and depth over
    b x 4,096 tokens, b the largest >= 2 whose reckoned peak (the counted
    arguments and temporaries, one sequence's worth from the counts at b = 1
    and 2, and the sharded run's parameters and moments kept for the
    comparison) stays under ``TRAIN_MEMORY_SHARE`` of the card.  (a) On a real
    one-rank NCCL mesh (``make_local_mesh(1, 1)``) the parameters, AdamW moments
    and batch are placed by ``params_shardings`` / ``opt_shardings`` /
    ``batch_shardings``: the bytes the card's live tensors ask for grow by the
    counted argument bytes exactly (the allocator's own rounding, printed
    beside, gives each block up to 1 MiB more).  Three steps
    of ``make_train_step`` on the DTensors and three on plain tensors from the
    same seed: the loss and every updated leaf bit-identical, the kernels'
    launches equal and equal to ``_per_step``'s for 24 layers; then one GC
    step (n 8, s 3, 64 tokens a sequence) the same way.  The counted
    operations over the sharded step's time (CUDA events, mean of steps 2-3)
    give its TFLOP/s and its share of 989 TFLOP/s bf16, a reading and not a
    gate.  (c) The bf16 attention backward at the step's shape, its two
    launches' device time, beside autograd of SDPA.  (d) ``run_pair`` of
    qwen2-0.5b train_4k on both production meshes, plain and GC, on this
    host's CPU: per-device operations, argument and collective bytes."""
    import statistics

    import torch

    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import local_group, make_local_mesh, make_mesh, rank_only_group
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train.coded import make_coded_train_step, make_train_step
    from repro_torch.tree import tree_leaves

    phase, t0 = "launch", time.perf_counter()
    cfg = get_config(ARCH)
    S, steps, seed = LAUNCH["seq"], LAUNCH["steps"], LAUNCH["seed"]
    smi = nvidia_smi()
    total = torch.cuda.get_device_properties(dev).total_memory

    def shape(b, seq=S):
        return InputShape("launch", seq, b, "train")

    # (b) the count on meta tensors, before this phase makes a card tensor
    with rank_only_group(1):
        mesh = make_mesh((1, 1))
        one, two = (dryrun.trace_pair(cfg, shape(b), mesh) for b in (1, 2))
        held = [r["argument_bytes"] + r["temp_bytes"] for r in (one, two)]
        per_seq, kept = held[1] - held[0], one["argument_bytes"]
        room = TRAIN_MEMORY_SHARE * total
        traced = {}

        def reckon(b):
            if b not in traced:
                traced[b] = dryrun.trace_pair(cfg, shape(b), mesh)
            return traced[b]["argument_bytes"] + traced[b]["temp_bytes"] + kept

        # the linear guess from b = 1 and 2, then halving to the largest b that fits
        lo, hi = 2, max(2, int((room - kept - held[0]) // max(per_seq, 1)) + 1)
        if reckon(lo) > room:
            fail(f"{phase}: two sequences of {S} tokens reckon {reckon(lo)} B, past {room} B")
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if reckon(mid) <= room else (lo, mid - 1)
        b, rec = lo, traced[lo]
        reckoned = reckon(b)
    say(phase, f"reckoning (counted on meta tensors, torch {torch.__version__}): "
               f"arguments + peak temporaries {held[0]} B at b=1, {held[1]} B at b=2, "
               f"{per_seq} B a sequence of {S} tokens (the f32 log-softmax over "
               f"{cfg.vocab_size} tokens alone is {S * cfg.vocab_size * 4} B); with the sharded "
               f"run's {kept} B kept, b={b} reckons {reckoned} B of {TRAIN_MEMORY_SHARE:g} x "
               f"{total} B; trace {rec['seconds']:.1f} s")
    T, L, d, f, V = b * S, cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layer = 2 * T * (d * (hq + 2 * hkv) * dh + hq * dh * d + 3 * d * f) + 4 * b * hq * S * S * dh
    formula = 4 * L * layer - L * 2 * T * f * d + 6 * T * d * V
    n_layers = cfg.param_count() - V * d - d
    say(phase, f"counted operations a step {rec['flops']} (the plain path on meta: its attention "
               f"takes every (q, k) pair); formula {formula} (remat: each layer's forward again "
               f"but its w_down, the head once and its backward twice); 8 N T = {8 * n_layers * T} "
               f"with N {n_layers} layer parameters, + 16 b hq S^2 dh = "
               f"{16 * b * hq * S * S * dh} attention, + 6 T d V = {6 * T * d * V} head")
    if rec["flops"] != formula:
        fail(f"{phase}: the count {rec['flops']} is not the formula's {formula}")

    counters = {k: v for k, v in _train_counters().items()
                if k in ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")}
    want = {k: v * steps for k, v in _per_step(cfg).items() if k in counters}

    def launched(fn):
        before = {k: c.launches for k, c in counters.items()}
        fn()
        torch.cuda.synchronize()
        return {k: c.launches - before[k] for k, c in counters.items()}

    def inputs(batch_shape):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen)
        tokens = torch.randint(0, V, batch_shape, generator=gen, device=dev, dtype=torch.int32)
        return params, {"tokens": tokens, "labels": tokens.clone()}

    def run(step, params, opt, batch, extra=(), n=steps):
        losses, ms = [], []
        for _ in range(n):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            params, opt, metrics = step(params, opt, batch, *extra)
            end.record()
            losses.append(metrics["loss"])
            ms.append((start, end))
        torch.cuda.synchronize()
        return params, opt, losses, [s.elapsed_time(e) for s, e in ms]

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def same(phase_what, got, want_):
        bad = [i for i, (x, y) in enumerate(zip(got, want_)) if not torch.equal(full(x), y)]
        if len(got) != len(want_) or bad:
            fail(f"{phase}: {phase_what} differ from the plain step's at leaves {bad[:8]}")

    # (a) the sharded step on a one-rank NCCL mesh, then the plain one
    with local_group("cuda"):
        mesh = make_local_mesh(1, 1)
        def held():
            """(bytes the live tensors asked for, bytes the allocator gave
            them): its blocks round each request up, a large one by up to 1
            MiB, where the rest of its segment is too small to split off."""
            torch.cuda.synchronize()
            return (torch.cuda.memory_stats(dev)["requested_bytes.all.current"],
                    torch.cuda.memory_allocated(dev))

        base = held()
        params, batch = inputs((b, S))
        p_shard = sh.params_shardings(cfg, params, mesh)
        params = sh.place(params, p_shard, mesh)
        opt = adamw_init(params)
        opt = sh.place(opt, sh.opt_shardings(cfg, opt, mesh, p_shard), mesh)
        batch = sh.place(batch, sh.batch_shardings(cfg, batch, mesh), mesh)
        asked, given = (now - then for now, then in zip(held(), base))
        n_tensors = len(tree_leaves((params, opt.m, opt.v, batch)))
        say(phase, f"placed on make_local_mesh(1, 1), {n_tensors} tensors: the card's live "
                   f"tensors asked for {asked} B more (allocated {given} B), the count "
                   f"{rec['argument_bytes']} B")
        if asked != rec["argument_bytes"]:
            fail(f"{phase}: the placed arguments hold {asked} B on the card, the count says "
                 f"{rec['argument_bytes']} B")
        torch.cuda.reset_peak_memory_stats(dev)
        out = []
        with sh.step_context(params):
            got = launched(lambda: out.append(run(make_train_step(cfg), params, opt, batch)))
        params, opt, d_losses, d_ms = out[0]
        d_peak = torch.cuda.max_memory_allocated(dev)
        del batch
        p2, b2 = inputs((b, S))
        out = []
        plain = launched(lambda: out.append(run(make_train_step(cfg), p2, adamw_init(p2), b2)))
        p2, o2, p_losses, p_ms = out[0]
        same("the losses", d_losses, p_losses)
        same("the updated parameters", tree_leaves(params), tree_leaves(p2))
        same("the AdamW moments", tree_leaves((opt.m, opt.v)), tree_leaves((o2.m, o2.v)))
        if got != plain or got != want:
            fail(f"{phase}: launches sharded {got}, plain {plain}, _per_step x {steps} {want}")
        step_ms = statistics.mean(d_ms[1:])
        rate = rec["flops"] / step_ms / 1e9
        say(phase, f"{steps} steps at b={b} x {S}, loss {[float(full(x)) for x in d_losses]}: "
                   f"sharded and plain bit-identical (loss, {len(tree_leaves(params))} parameters,"
                   f" moments); launches {got} = plain = _per_step x {steps}; step ms sharded "
                   f"{[round(x, 2) for x in d_ms]}, plain {[round(x, 2) for x in p_ms]}; peak "
                   f"{d_peak} B; {rate:.1f} TFLOP/s counted over the sharded step (mean of steps "
                   f"2-{steps}), {rate / 989:.4f} of 989 TFLOP/s bf16 [{smi}]")
        del params, opt, p2, o2, b2, out
        torch.cuda.empty_cache()

        # the GC step, n 8, s 3, chunks of TRAIN["batch"] // n sequences of 64 tokens
        n, s_ = TRAIN["n"], TRAIN_SCHEMES["gc"]["s"]
        grid = (n, s_ + 1, TRAIN["batch"] // n, LAUNCH["coded_seq"])
        weights = torch.rand((n, s_ + 1), generator=torch.Generator().manual_seed(seed)).to(dev)
        step = make_coded_train_step(cfg, n, s_)
        params, batch = inputs(grid)
        p_shard = sh.params_shardings(cfg, params, mesh)
        params = sh.place(params, p_shard, mesh)
        opt = adamw_init(params)
        opt = sh.place(opt, sh.opt_shardings(cfg, opt, mesh, p_shard), mesh)
        batch = sh.place(batch, sh.batch_shardings(cfg, batch, mesh), mesh)
        w = sh.place(weights, sh.replicated(mesh), mesh)
        out = []
        with sh.step_context(params):
            got = launched(lambda: out.append(run(step, params, opt, batch, (w,), n=1)))
        params, opt, d_losses, _ = out[0]
        p2, b2 = inputs(grid)
        out = []
        plain = launched(lambda: out.append(run(step, p2, adamw_init(p2), b2, (weights,), n=1)))
        p2, o2, p_losses, _ = out[0]
        same("the GC step's loss", d_losses, p_losses)
        same("the GC step's parameters", tree_leaves((params, opt.m, opt.v)),
             tree_leaves((p2, o2.m, o2.v)))
        want1 = {k: v // steps for k, v in want.items()}
        if got != plain or got != want1:
            fail(f"{phase}: GC launches sharded {got}, plain {plain}, _per_step {want1}")
        say(phase, f"GC step (n {n}, s {s_}, {grid}): sharded and plain bit-identical, "
                   f"launches {got}")
        del params, opt, p2, o2, batch, b2, out
        torch.cuda.empty_cache()

    # (c) the bf16 attention backward at the step's shape, beside SDPA's
    q, do = (heads_view(b, hq, S, dh, torch.bfloat16) for _ in range(2))
    k, v = (heads_view(b, hkv, S, dh, torch.bfloat16) for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    def bwd():
        return flash_attention_bwd(q, k, v, out, lse, do, causal=True)

    by_launch = _launch_ms(bwd, 5)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    y_lib = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                                             enable_gqa=True)

    def lib():
        return torch.autograd.grad(y_lib, (qr, kr, vr), do, retain_graph=True)

    # CUDA events beside the profiler, which at times records no activity
    say(phase, f"attention backward bf16 at head dim {dh} {tuple(q.shape)}, kv {tuple(k.shape)}, "
               f"causal, {S // 64} key tiles: device ms a call by launch "
               + (", ".join(f"{name} {ms:.5f}" for name, ms in by_launch.items()) or "none recorded")
               + f"; CUDA events {_cuda_ms(bwd, 5):.5f} ms a call; autograd of SDPA "
               f"{_ms(_device_ms(lib, 5))} (CUDA events {_cuda_ms(lib, 5):.5f}) [{smi}]")
    del q, k, v, do, out, lse, qr, kr, vr, y_lib
    torch.cuda.empty_cache()

    # (d) the dry-run's production pairs on this host
    for multi_pod in (False, True):
        for coded in (False, "gc"):
            r = dryrun.run_pair(ARCH, "train_4k", multi_pod=multi_pod, coded=coded,
                                verbose=False)
            if r["status"] != "ok":
                fail(f"{phase}: dry-run {r}")
            say(phase, f"dry-run {ARCH} train_4k {r['mesh']} coded {coded}: operations a "
                       f"device {r['flops_per_device']}, argument bytes "
                       f"{r['memory']['argument_bytes']}, collective bytes "
                       f"{r['collectives']['total_bytes']}, trace {r['lower_s']} s (counted on "
                       f"meta tensors, torch {r['torch_version']})")
    say(phase, f"phase wall {time.perf_counter() - t0:.1f} s")


def _gate_window_timings(dev) -> list:
    """Timing rows of the gate-window kernels at the Table-1 grid's shapes:
    m-sgc's 2-row bursty buffer and its 3-row all-or-nothing window.  Printed
    beside them: both at (4096, 3, 256), where the bytes begin to count; the
    launch floor, a one-element ``fill_``, profiled in the same session as each
    kernel; and the host cost of the wrappers' four ``torch.empty`` calls
    against one allocation carved into the four outputs."""
    import numpy as np
    import torch

    from repro_torch.kernels.gate_window import gate_window as gwk
    from repro_torch.kernels.gate_window import ref as gwr

    rng = np.random.default_rng(1)
    n = SIM["n"]
    rows, extra, floors = [], [], []
    one = torch.zeros(1, device=dev)
    for cells in (SIM["traces"], 4096):
        for name, fn, plain, k, replaces in (
            ("buffer_stats", gwk.buffer_stats, gwr.buffer_stats, 2, 72),
            ("window_stats", gwk.window_stats, gwr.window_stats, 3, 54),
        ):
            k = k if cells == SIM["traces"] else 3
            x = torch.from_numpy(rng.random((cells, k, n)) < 0.05).to(dev)
            outs = fn(x, 2)
            n_bytes = x.numel() + sum(o.numel() * o.element_size() for o in outs)
            # per byte: an OR, an add, the first/last updates and a dp4a share,
            # about 4 integer operations; about 8 a worker for stores and sums
            row = _timed(
                name, "src/repro_torch/kernels/csrc/gate_window.cu",
                f"src/repro/kernels/gate_window/gate_window.py:{replaces}", tuple(x.shape),
                lambda fn=fn, x=x: fn(x, 2), lambda plain=plain, x=x: plain(x, 2), None,
                n_bytes, 4 * x.numel() + 8 * cells * n, "f32", iters=500,
            )
            (rows if cells == SIM["traces"] else extra).append(row)
            # the launch floor in the same profiler session: fill_ and the
            # kernel in turns, told apart by name
            events = _device_events(lambda fn=fn, x=x: [(one.fill_(1.0), fn(x, 2))
                                                        for _ in range(500)])
            kern = [t for e, t, _ in events if "stats_kernel" in e]
            fill = [t for e, t, _ in events if "stats_kernel" not in e]
            floors += fill
            if not kern or not fill:
                say("timings", f"FLAG {name} {tuple(x.shape)}: the profiler recorded {len(kern)} "
                               f"kernel and {len(fill)} fill_ activities beside the floor")
                continue
            say("timings", f"{name} {tuple(x.shape)} beside the floor, one profiler session: "
                           f"kernel median {statistics.median(kern):.3f} us (mean "
                           f"{statistics.mean(kern):.3f}, {len(kern)} recorded), one-element "
                           f"fill_ median {statistics.median(fill):.3f} us (mean "
                           f"{statistics.mean(fill):.3f}, {len(fill)} recorded); bound "
                           f"{row['bound_ms'] * 1e3:.4f} us by bytes")
    if floors:
        say("timings", f"gate floor: one-element fill_ median {statistics.median(floors):.3f} us "
                       f"over {len(floors)} launches in {len(rows + extra)} sessions")
    for r in extra:
        say("timings", f"{r['name']} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
                       f"{r['plain_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
                       f"({_rates(r)}); per call with host overhead: kernel {r['call_ms']:.5f}, "
                       f"plain {r['plain_call_ms']:.5f}")
    # host cost of the outputs: the wrappers make four torch.empty calls, which
    # measured cheaper than one allocation carved into the four
    cells, m = SIM["traces"], SIM["traces"] * n

    def carved():
        block = torch.empty(6 * m + cells, dtype=torch.uint8, device=dev)
        act, md = block[4 * m:6 * m].view(torch.bool).view(2, cells, n)
        return act, block[:4 * m].view(torch.int32).view(cells, n), md, block[6 * m:].view(
            torch.bool)

    def four():
        return (torch.empty((cells, n), dtype=torch.bool, device=dev),
                torch.empty((cells, n), dtype=torch.int32, device=dev),
                torch.empty((cells, n), dtype=torch.bool, device=dev),
                torch.empty(cells, dtype=torch.bool, device=dev))

    x = torch.from_numpy(rng.random((cells, 2, n)) < 0.05).to(dev)
    t = [_cuda_ms(lambda f=f: gwk._launch("gate_buffer_stats", x, 2, f()), 500)
         for f in (carved, four, carved, four)]
    say("timings", f"buffer_stats outputs and launch per call, host-bound: one carved "
                   f"allocation {t[0]:.5f}, {t[2]:.5f} ms; four torch.empty {t[1]:.5f}, "
                   f"{t[3]:.5f} ms")
    torch.cuda.synchronize()
    return rows


def _ssd_inputs(dev, gen, b, nc, Q, nh, hd, st, dtype, A_scale=1.0, tail=0):
    """Intra-chunk inputs on the card, flattened to (b*nc, ...), drawn as
    tests/test_ssd_kernel.py draws them; the last ``tail`` rows of the last
    chunk are a sequence's zero padding (zero x, B, C and dt)."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, Bm, Cm = rn(b, nc, Q, nh, hd), rn(b, nc, Q, st), rn(b, nc, Q, st)
    dt = torch.rand((b, nc, Q, nh), generator=gen, device=dev) * 0.5 + 0.05
    A = -(torch.rand(nh, generator=gen, device=dev) + 0.1) * A_scale
    if tail:
        for t in (x, Bm, Cm, dt):
            t[:, -1, Q - tail:] = 0
    cum = torch.cumsum(dt * A, dim=2)
    return tuple(t.reshape((b * nc,) + t.shape[2:]) for t in
                 (x.to(dtype), dt, cum, Bm.to(dtype), Cm.to(dtype)))


def _ssd_check(dev) -> dict:
    """Both SSD kernel entries against their plain versions on the card: the
    intra-chunk block (y_intra, f32) and the fused chunk scan (y in f32, and
    in bf16 for bf16 inputs, with an h_prev, D and a ragged sequence end);
    returns each entry's error at mamba2-1.3b's full width in bf16."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan as scan_kernel
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk as ssd_kernel

    gen = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    full = (BATCH, -(-PROMPT_LEN // 64), 64, 64, 64, 128)   # as [slice-ssm] gives it,
    full_tail = full[1] * 64 - PROMPT_LEN                    # with s = PROMPT_LEN
    hybrid = (BATCH, full[1], 64, 80, 64, 64)                # as [slice-hybrid] gives it
    cases = [  # (b, nc, Q, nh, hd, st), dtype, A_scale, tail rows, note
        *[(s, dt, 1.0, 0, "") for s in [(2, 2, 16, 3, 8, 5), (1, 4, 64, 4, 32, 16),
                                        (2, 1, 128, 2, 64, 32), (1, 2, 64, 8, 8, 128)]
          for dt in (f32, bf16)],
        ((1, 2, 32, 2, 16, 8), bf16, 1.0, 0, ""),
        *[((2, 3, 64, 4, 32, 16), dt, 1.0, 64 * 3 - 150, " ragged final chunk") for dt in (f32, bf16)],
        *[((2, 3, 50, 3, 20, 5), dt, 1.0, 0, " odd Q and head_dim") for dt in (f32, bf16)],
        (full, f32, 1.0, full_tail, " full width"),
        (full, bf16, 1.0, full_tail, " full width"),
        *[(hybrid, dt, 1.0, full_tail, f" {HYBRID_ARCH}'s full width") for dt in (f32, bf16)],
        *[((1, 2, 64, 4, 16, 8), dt, 200.0, 0, " steep decay") for dt in (f32, bf16)],
    ]

    def check(what, got, want, tol):
        if not torch.isfinite(got.float()).all():
            fail(f"ssd_scan {what}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        say("ssd_scan", f"{what}: max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"ssd_scan {what}: kernel disagrees with the plain version")
        return err

    worst = {}
    for shape, dtype, A_scale, tail, note in cases:
        b, nc, Q, nh, hd, st = shape
        args = _ssd_inputs(dev, gen, *shape, dtype, A_scale, tail)
        tol = SSD_TOL[_dtype_name(dtype)]
        err = check(f"intra {shape} {_dtype_name(dtype)}{note}", ssd_kernel(*args),
                    ssd_ref.ssd_intra_chunk(*args), tol)
        if (shape, dtype) == (full, bf16):
            worst["ssd_scan"] = err
        err = 0.0
        h_prev = torch.randn((b * nc, nh, hd, st), generator=gen, device=dev) * 0.5
        D = torch.randn(nh, generator=gen, device=dev)
        s = nc * Q - tail
        chunked = [t.unflatten(0, (b, nc)) for t in (*args, h_prev)]
        for out in sorted({f32, dtype}, key=str):
            got = scan_kernel(*args, h_prev, D, nc, s, out)
            torch.cuda.synchronize()
            want = ssd_ref.ssd_chunk_scan(*chunked[:5], chunked[5], D, s, out)
            err = max(err, check(f"fused {shape} {_dtype_name(dtype)} -> {_dtype_name(out)}, "
                                 f"s {s}{note}", got, want, tol))
        if (shape, dtype) == (full, bf16):
            worst["ssd_chunk_scan"] = err
    # the model's layout: x, B and C are strided slices of one projection
    nh, hd, st = 4, 16, 8
    for dtype in (f32, bf16):
        xbc = torch.randn((6, 64, nh * hd + 2 * st), generator=gen, device=dev).to(dtype)
        x = xbc[..., :nh * hd].reshape(6, 64, nh, hd)
        Bm, Cm = xbc[..., nh * hd:nh * hd + st], xbc[..., nh * hd + st:]
        dt = torch.rand((6, 64, nh), generator=gen, device=dev) * 0.5
        cum = torch.cumsum(-dt, dim=1)
        check(f"intra, strided slices of a (6, 64, {nh * hd + 2 * st}) {_dtype_name(dtype)} "
              f"projection", ssd_kernel(x, dt, cum, Bm, Cm),
              ssd_ref.ssd_intra_chunk(x, dt, cum, Bm, Cm), SSD_TOL[_dtype_name(dtype)])
    refused = {
        "a 129-row chunk": lambda z=torch.zeros(1, 129, 1, 8, device=dev):
            ssd_kernel(z, z[..., 0], z[..., 0], z[:, :, 0], z[:, :, 0]),
        "a bf16 view one element off 16 bytes": lambda v=xbc[..., 1:1 + nh * hd]:
            ssd_kernel(v.reshape(6, 64, nh, hd), dt, cum, Bm, Cm),
    }
    for what, call in refused.items():
        try:
            call()
        except ValueError:
            say("ssd_scan", f"{what} refused")
        else:
            fail(f"ssd_scan: {what} did not raise")
    torch.cuda.synchronize()
    return worst


def _ssd_bwd_check(dev) -> dict:
    """The SSD backward kernel (``ssd_chunk_scan_bwd``) against the plain
    backward (``ref.ssd_chunk_scan_bwd``) and against autograd of the plain
    forward, f32 and bf16 (dy in the inputs' dtype, and once f32 dy for bf16
    inputs), each called twice and bit-identical; returns the largest
    absolute error at mamba2-1.3b's training shape in bf16."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan_bwd as scan_bwd

    gen = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    train = (TRAIN_SEQS, SSM_TRAIN_SEQ // 64, 64, 64, 64, 128)   # as [slice-ssm-train] gives it
    cases = [  # (b, nc, Q, nh, hd, st), dtype, dy dtype, A_scale, tail rows, note
        *[(sh, dt, dt, 1.0, 0, "") for sh in [(2, 2, 16, 3, 8, 5), (1, 4, 64, 4, 32, 16),
                                              (2, 1, 128, 2, 64, 32), (1, 2, 64, 8, 8, 128)]
          for dt in (f32, bf16)],
        ((1, 4, 64, 4, 32, 16), bf16, f32, 1.0, 0, " f32 dy"),
        *[((2, 3, 50, 3, 20, 5), dt, dt, 1.0, 11, " ragged Q and head_dim") for dt in (f32, bf16)],
        *[((1, 2, 64, 4, 16, 8), dt, dt, 200.0, 0, " steep decay") for dt in (f32, bf16)],
        *[((2, 4, 64, 4, 32, 16), dt, dt, 1.0, 0, " 4 chunks") for dt in (f32, bf16)],
        *[((2, 3, 64, 4, 32, 16), dt, dt, 1.0, 64 * 3 - 150, " s 150") for dt in (f32, bf16)],
        *[(train, dt, dt, 1.0, 0, f" {SSM_ARCH}'s training shape") for dt in (f32, bf16)],
        *[((16, 4, 64, 80, 64, 64), dt, dt, 1.0, 0, f" {HYBRID_ARCH}'s widths")
          for dt in (f32, bf16)],
        ((8, 4, 64, 64, 64, 128), bf16, bf16, 1.0, 20,
         f" strided views at {SSM_ARCH}'s widths"),
    ]
    names = ("dx", "ddt", "dcum", "dB", "dC", "dh_prev", "dD")
    worst = {}
    for shape, dtype, dy_dtype, A_scale, tail, note in cases:
        b, nc, Q, nh, hd, st = shape
        args = _ssd_inputs(dev, gen, *shape, dtype, A_scale, tail)
        if "strided" in note:  # x, B and C as the model slices them from its conv output
            xbc = torch.cat([args[0].flatten(2), args[3], args[4]], dim=-1)
            args = (xbc[..., :nh * hd].unflatten(-1, (nh, hd)), args[1], args[2],
                    xbc[..., nh * hd:nh * hd + st], xbc[..., nh * hd + st:])
        h_prev = torch.randn((b * nc, nh, hd, st), generator=gen, device=dev) * 0.5
        D = torch.randn(nh, generator=gen, device=dev)
        s = nc * Q - tail
        dy = torch.randn((b, s, nh, hd), generator=gen, device=dev).to(dy_dtype)
        got = scan_bwd(*args, h_prev, D, dy, nc, s)
        again = scan_bwd(*args, h_prev, D, dy, nc, s)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fail(f"ssd-bwd {shape}{note}: a second call gave other bits")
        chunked = [t.unflatten(0, (b, nc)) for t in (*args, h_prev)]
        want = ssd_ref.ssd_chunk_scan_bwd(*chunked, D, s, dy)
        leaves = [t.detach().clone().requires_grad_(True) for t in (*chunked, D)]
        y = ssd_ref.ssd_chunk_scan(*leaves[:6], leaves[6], s, dy_dtype)
        autograd = torch.autograd.grad(y, leaves, dy)
        del y, leaves
        tol = SSD_BWD_TOL[_dtype_name(dtype)]
        errs = []
        for name, g, w, a in zip(names, got, want, autograd):
            g = g.reshape(w.shape)
            if not torch.isfinite(g.float()).all():
                fail(f"ssd-bwd {shape}{note}: non-finite {name}")
            scale = max(1.0, float(w.float().abs().max()))
            for what, ref_ in (("plain", w), ("autograd", a)):
                err = float((g.float() - ref_.float()).abs().max())
                if not torch.allclose(g.float(), ref_.float(), rtol=tol, atol=tol * scale):
                    fail(f"ssd-bwd {shape}{note} {name}: kernel disagrees with the {what} "
                         f"backward by {err:.3e} (scale {scale:.3e}, tol {tol:g})")
            errs.append(f"{name} {float((g.float() - w.float()).abs().max()):.2e}/{scale:.1e}")
        say("ssd-bwd", f"{shape} {_dtype_name(dtype)} dy {_dtype_name(dy_dtype)}, s {s}{note}: "
                       f"max_abs_err / scale vs plain {', '.join(errs)} (tol {tol:g} x scale; "
                       f"autograd likewise); bit-identical on a second call")
        if (shape, dtype) == (train, bf16):
            worst["ssd_chunk_scan_bwd"] = max(
                float((g.reshape(w.shape).float() - w.float()).abs().max())
                for g, w in zip(got, want))
        del got, again, want, autograd
    torch.cuda.empty_cache()
    return worst


def _serve_slice(phase, dev, cfg, counters, want, batch=BATCH, prompt_len=PROMPT_LEN,
                 new_tokens=NEW_TOKENS) -> dict:
    """Full-width serving of ``cfg`` through ``serve()`` (random weights from
    seed 0): the launches of each kernel in ``counters`` (name -> wrapper)
    around one request, which must equal ``want``; prefill ms, decode tok/s and
    peak memory; for a moe model, the pairs the same request drops, counted in
    an untimed rerun under a route log; a profiled prefill and decode step (a
    moe model's layers as categories of their own); then float32
    teacher-forced logits through the kernels and through ``plain=True``
    (:func:`_f32_logits_check`).  Returns the request's launches."""
    import torch

    from repro_torch.launch.serve import request, serve
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.layers import moe_groups, route_log

    moe = cfg.family == "moe"
    max_seq = prompt_len + new_tokens
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    say(phase, f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
               f"{cfg.param_count()} params in {cfg.dtype}")
    warm = 16 + cfg.prefix_len
    serve(cfg, params, batch=batch, prompt_len=warm, tokens=4, max_seq=warm + 16,
          device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    res = serve(cfg, params, batch=batch, prompt_len=prompt_len, tokens=new_tokens,
                max_seq=max_seq, seed=0, device=dev)
    launches = {name: c.launches for name, c in counters.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    say(phase, f"launches {launches} (expected {want})")
    if launches != want:
        fail(f"{phase}: kernel launches {launches}, expected {want}")
    toks = res.tokens
    if toks.shape != (batch, new_tokens) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{phase}: bad tokens, shape {toks.shape}, range [{toks.min()}, {toks.max()}]")
    say(phase, f"{cfg.dtype} serve: prefill {batch}x{prompt_len} in {res.prefill_s * 1e3:.3f} "
               f"ms; {new_tokens - 1} decode steps at {res.decode_tokens_per_s:.1f} tok/s; "
               f"total {res.total_s * 1e3:.3f} ms; max_memory_allocated {peak_mem} B")
    say(phase, f"first sequence: {toks[0].tolist()}")
    if moe:
        # the same request again, untimed, under a route log (check-only work
        # that serve() does not do for a user)
        with route_log() as log:
            serve(cfg, params, batch=batch, prompt_len=prompt_len, tokens=new_tokens,
                  max_seq=max_seq, seed=0, device=dev)
        L, drops = cfg.num_layers, log.drops()
        if len(drops) != L * new_tokens:
            fail(f"{phase}: {len(drops)} moe calls in the request, expected {L * new_tokens}")
        Tg, Cg = moe_groups(batch * prompt_len, cfg)
        say(phase, f"(token, expert) pairs dropped in groups of Tg {Tg} / Cg {Cg}"
                   f"{' (dropless)' if Cg >= Tg else ''}: prefill {drops[:L]} of "
                   f"{batch * prompt_len * cfg.num_experts_per_tok} a layer; decode steps "
                   f"{sum(drops[L:])} in all")
        del log

    # where the device time goes: one prefill and one decode step, profiled
    prompt = request(cfg, batch=batch, prompt_len=prompt_len, seed=1, device=dev)
    _, cache = prefill(params, cfg, prompt, max_seq=max_seq)
    span = "moe" if moe else None
    _breakdown(f"profile {cfg.name} prefill",
               _device_events(lambda: prefill(params, cfg, prompt, max_seq=max_seq), span),
               res.prefill_s * 1e3)
    token = prompt["tokens"][:, -1:]
    _breakdown(f"profile {cfg.name} decode step",
               _device_events(lambda: decode_step(params, cfg, cache, token, prompt_len), span),
               (res.total_s - res.prefill_s) / (new_tokens - 1) * 1e3)
    del params, cache
    torch.cuda.empty_cache()
    _f32_logits_check(phase, dev, cfg, batch, prompt_len, new_tokens)
    return launches


def _f32_logits_check(phase, dev, cfg, batch, prompt_len, new_tokens) -> None:
    """float32, teacher-forced on the kernel path's tokens: the prefill's and
    every decode step's logits through the kernels and through ``plain=True``
    within ``LOGIT_TOL``, and their final caches.  A moe model's plain path
    takes the kernel path's experts, call by call (``route_log``): its ~1e-6
    differences in attention and RMSNorm could tip a near tie at the K-th place
    and move that token's output, and the later tokens', by O(1).  Then the
    plain path runs again unpinned, and each routing that differs with no
    earlier difference upstream (:func:`_routing_diffs`) must be a near tie,
    its K-th-place gap within ``ROUTE_GAP_TOL``."""
    import contextlib

    import torch

    from repro_torch.launch.serve import request
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.layers import RouteLog, route_log

    moe = cfg.family == "moe"
    max_seq = prompt_len + new_tokens
    cfg32 = cfg.replace(dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    prompt = request(cfg, batch=batch, prompt_len=prompt_len, seed=2, device=dev)
    k_log = RouteLog()
    p_log = RouteLog(replay=k_log)

    def pinned(log):
        return route_log(log) if moe else contextlib.nullcontext()

    fed = []
    with torch.inference_mode():
        with pinned(k_log):
            k_logits, k_cache = prefill(p32, cfg32, prompt, max_seq=max_seq)
        with pinned(p_log):
            p_logits, p_cache = prefill(p32, cfg32, prompt, max_seq=max_seq, plain=True)
        worst = _logit_check("prefill", k_logits, p_logits, phase=phase)
        token = k_logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        del k_logits, p_logits
        for i in range(new_tokens - 1):
            fed.append(token)
            with pinned(k_log):
                k_logits, k_cache = decode_step(p32, cfg32, k_cache, token, prompt_len + i)
            with pinned(p_log):
                p_logits, p_cache = decode_step(p32, cfg32, p_cache, token, prompt_len + i,
                                                plain=True)
            worst = max(worst, _logit_check(f"decode {i}", k_logits, p_logits, quiet=True,
                                            phase=phase))
            token = k_logits.argmax(-1)[:, None].to(torch.int32)
        caches = max((k_cache[k] - p_cache[k]).abs().max().item() for k in k_cache)
    say(phase, f"f32 teacher-forced logits, kernels vs plain"
               f"{' (routing pinned to the kernel path)' if moe else ''}: prefill and "
               f"{new_tokens - 1} decode steps within {LOGIT_TOL:g} (max_abs_err {worst:.3e}); "
               f"final caches differ by {caches:.3e}")
    del k_cache, p_cache, p_log
    torch.cuda.empty_cache()
    if moe:
        # the plain path again, unpinned, fed the same tokens
        with torch.inference_mode(), route_log() as free_log:
            _, cache = prefill(p32, cfg32, prompt, max_seq=max_seq, plain=True)
            for i, token in enumerate(fed):
                _, cache = decode_step(p32, cfg32, cache, token, prompt_len + i, plain=True)
        del cache
        n, differ, first, gap = _routing_diffs(k_log, free_log, cfg.num_layers, batch,
                                               prompt_len)
        say(phase, f"f32 plain path unpinned: {differ} of {n} (token, layer) routings chose "
                   f"another expert set than the kernel path; {first} of them with no "
                   f"earlier difference upstream, their largest K-th-place probability gap "
                   f"{gap:.3e} (limit {ROUTE_GAP_TOL:g}); the rest follow from those")
        if gap > ROUTE_GAP_TOL:
            fail(f"{phase}: a routing differs between the kernel and plain paths at a "
                 f"K-th-place gap of {gap:.3e}, not a near tie")
    del p32
    torch.cuda.empty_cache()


def _audio_slice(phase, dev, cfg, gen, counters, want) -> dict:
    """Full-width encoder forward of ``cfg`` (random weights from seed 0) on
    BATCH x PROMPT_LEN seeded frames, under inference mode, bf16: the
    launches of each kernel in ``counters`` around one forward, which must
    equal ``want``; wall (the median of five forwards after a warm-up at the
    same shape), peak memory; a profiled forward; then float32 logits through
    the kernels and through ``plain=True`` within ``LOGIT_TOL``.  Returns the
    forward's launches."""
    import torch

    from repro_torch.models import forward, init_params

    def infer(params, c, frames, plain=False):
        with torch.inference_mode():
            return forward(params, c, {"frames": frames}, plain=plain)[0]

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    say(phase, f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
               f"{cfg.param_count()} params in {cfg.dtype}, causal {cfg.causal}")
    frames = torch.randn((BATCH, PROMPT_LEN, cfg.d_model), generator=gen, device=dev)
    infer(params, cfg, frames)  # warm-up at the timed shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def timed():
        t0 = time.perf_counter()
        out = infer(params, cfg, frames)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for c in counters.values():
        c.launches = 0
    logits, first = timed()
    launches = {name: c.launches for name, c in counters.items()}
    walls = [first] + [timed()[1] for _ in range(4)]
    wall = statistics.median(walls)
    peak_mem = torch.cuda.max_memory_allocated()
    say(phase, f"launches {launches} (expected {want})")
    if launches != want:
        fail(f"{phase}: kernel launches {launches}, expected {want}")
    if logits.shape != (BATCH, PROMPT_LEN, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"{phase}: bad logits, shape {tuple(logits.shape)}")
    say(phase, f"{cfg.dtype} forward of {BATCH}x{PROMPT_LEN} frames in {wall * 1e3:.3f} ms "
               f"(median of {[round(w * 1e3, 3) for w in walls]}); "
               f"max_memory_allocated {peak_mem} B")
    _breakdown(f"profile {cfg.name} forward", _device_events(lambda: infer(params, cfg, frames)),
               wall * 1e3)
    del params, logits
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    p32 = init_params(cfg32, torch.Generator(device=dev).manual_seed(0))
    err = _logit_check("forward", infer(p32, cfg32, frames), infer(p32, cfg32, frames, True),
                       phase=phase)
    say(phase, f"f32 logits, kernels vs plain: within {LOGIT_TOL:g} (max_abs_err {err:.3e})")
    del p32
    torch.cuda.empty_cache()
    return launches


def _routing_diffs(k_log, p_log, L, batch, prompt_len):
    """Compare two runs' routing, call by call: the L calls of a prefill of
    ``batch`` x ``prompt_len`` tokens, then L calls a decode step.  A (token,
    layer) routing differs where the two expert sets differ.  A difference at
    layer l and position t of a sequence moves that token's output, and
    through attention every later layer's at positions >= t; so a difference
    counts as *first* only where no earlier layer of its sequence differed at
    a position <= t.  Returns (routings, differing, first, the kernel path's
    largest K-th-place gap among the first)."""
    import torch

    never = prompt_len + len(k_log.calls)
    first_pos = torch.full((batch, L), never)  # per sequence and layer: first difference
    n = differ = first = 0
    gap = 0.0
    for c, ((k_idx, _, k_gap), (p_idx, _, _)) in enumerate(zip(k_log.calls, p_log.calls)):
        step, layer = divmod(c, L)
        rows = torch.arange(k_idx.shape[0])
        if step == 0:
            seq, pos = rows // prompt_len, rows % prompt_len
        else:
            seq, pos = rows, torch.full_like(rows, prompt_len + step - 1)
        diff = (k_idx.sort(-1).values != p_idx.sort(-1).values).any(-1).cpu()
        upstream = first_pos[:, :layer].amin(1) if layer else torch.full((batch,), never)
        is_first = diff & (pos < upstream[seq])
        n, differ, first = n + len(rows), differ + int(diff.sum()), first + int(is_first.sum())
        if is_first.any():
            gap = max(gap, float(k_gap.cpu()[is_first].max()))
        for b in seq[diff].unique().tolist():
            first_pos[b, layer] = min(int(first_pos[b, layer]), int(pos[diff & (seq == b)].min()))
    return n, differ, first, gap


def _profile_ssd_chunked(dev) -> dict:
    """One full-width mamba2-1.3b block's prefill (``ssm_apply`` with its
    cache, bf16, [slice-ssm]'s 8 x 500 tokens), profiled.  ``ssd_chunked``
    and ``ssm_apply`` name each pass with a profiler range (``ssd.*``,
    ``models/ssm.py:_span``); every device activity is attributed to the
    innermost range around the host call that launched it, and the rest of
    the block to ``ssm_apply``.  Prints device ms and launches per range and
    names the non-vectorised ``elementwise_kernel`` launches; returns
    {range: (ms, launches)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config(SSM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(5)
    p = ssm.ssm_init(gen, cfg, torch.bfloat16)
    x = torch.randn((BATCH, PROMPT_LEN, cfg.d_model), generator=gen, device=dev)
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        ssm.ssm_apply(p, x, cfg, return_cache=True)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SPINS):
                torch.cuda._sleep(1000)
            with record_function("ssm_apply"):
                ssm.ssm_apply(p, x, cfg, return_cache=True)
            for _ in range(SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = [e for e in cpu if e.name == "ssm_apply" or e.name.startswith("ssd.")]
    # a device activity and the runtime call that issued it (cudaLaunchKernel,
    # cudaMemcpyAsync, ...) share the CUPTI correlation id
    issued = {e.id: e.time_range.start for e in cpu if e.name.startswith("cu")}
    per: dict[str, list] = {r.name: [0.0, 0, {}] for r in ranges}
    names = {r.name for r in ranges}  # their device-side spans are not activities
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and "spin_kernel" not in e.name and e.name not in names]
    lost = []
    for k in device:
        t = issued.get(k.id)
        inside = [r for r in ranges if t is not None and r.time_range.start <= t <= r.time_range.end]
        if not inside:
            lost.append(k.name)
            continue
        acc = per[max(inside, key=lambda r: r.time_range.start).name]
        ms = k.time_range.elapsed_us() / 1e3
        acc[0] += ms
        acc[1] += 1
        if "elementwise_kernel" in k.name and "vectorized" not in k.name:
            n, total = acc[2].get(k.name[:110], (0, 0.0))
            acc[2][k.name[:110]] = (n + 1, total + ms)
    total = sum(v[0] for v in per.values())
    say("profile ssd_chunked", f"one {cfg.name} block, prefill {BATCH}x{PROMPT_LEN}, bf16: "
                               f"device {total:.3f} ms in {len(device) - len(lost)} of "
                               f"{len(device)} device activities, attributed to a range")
    if lost:
        say("profile ssd_chunked", f"  not attributed: {sorted(set(n[:60] for n in lost))}")
    for name, (ms, n, elem) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        say("profile ssd_chunked", f"  {name}: {ms:.3f} ms in {n} launches")
        for kname, (m, dur) in sorted(elem.items(), key=lambda kv: -kv[1][1]):
            say("profile ssd_chunked", f"    non-vectorised: {m} x {dur:.3f} ms {kname}")
    del p, x
    torch.cuda.empty_cache()
    return {name: (v[0], v[1]) for name, v in per.items()}


def _ssd_timing(dev) -> list:
    """The two ``ssd_scan`` timing rows at [slice-ssm]'s prefill shape, bf16:
    the intra-chunk entry (y_intra in f32, the TPU kernel's counterpart) and
    the fused chunk scan (y in bf16).  Beside the fused row, the torch passes
    it replaces (``ref.chunk_output``: the inter-chunk einsum, the sums, the
    D skip and the cast) after the intra entry, as ``ssd_chunked`` ran them.
    Both entries launch one kernel template of ``ssd_scan.cu``; the main
    path launches only the fused one, so the intra row's ``launches`` are
    the source's (``launches_of`` says so)."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan as scan_kernel
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_intra_chunk as ssd_kernel

    gen = torch.Generator(device=dev).manual_seed(4)
    b, nc, Q, nh, hd, st = BATCH, -(-PROMPT_LEN // 64), 64, 64, 64, 128
    bf16 = torch.bfloat16
    args = _ssd_inputs(dev, gen, b, nc, Q, nh, hd, st, bf16, tail=nc * Q - PROMPT_LEN)
    bc = b * nc
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    # the function's work over the causal half, each product once: C.B^T, per
    # head the decay (subtract, multiply, exp, two multiplies) and w @ x.  The
    # bf16 kernel runs C.B^T and w' @ x on the tensor cores, over whole 16 x 16
    # tiles, with w' split into bf16 hi + lo (two w' @ x): ``kernel_ops``.
    causal = Q * (Q + 1) // 2
    tiles = (Q // 16) * (Q // 16 + 1) // 2 * 256
    n_ops = bc * (2 * causal * st + nh * causal * (5 + 2 * hd))
    kernel_ops = [bc * (2 * tiles * st + nh * tiles * (5 + 2 + 2 * 2 * hd))]
    rows = [_timed("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan/ssd_scan.py:30", (bc, Q, nh, hd, st),
                   lambda: ssd_kernel(*args), lambda: ssd_ref.ssd_intra_chunk(*args), None,
                   in_bytes + bc * Q * nh * hd * 4, n_ops, "bf16_tensor", iters=100)]
    rows[0]["launches_of"] = "ssd_scan.cu, both entries: on the main path all ssd_chunk_scan"
    h_prev = torch.randn((bc, nh, hd, st), generator=gen, device=dev) * 0.5
    D = torch.randn(nh, generator=gen, device=dev)
    chunked = [t.unflatten(0, (b, nc)) for t in (*args, h_prev)]
    x, _, cum, _, Cc, hp = chunked
    n_bytes = in_bytes + h_prev.numel() * 4 + D.numel() * 4 + b * PROMPT_LEN * nh * hd * 2
    # + C . h_prev^T, exp(cum) per row, the sums and the D skip; the kernel
    # runs C . h_prev^T on the tensor cores twice (h_prev split into bf16 hi + lo)
    n_ops += bc * nh * (2 * Q * st * hd + Q + 3 * Q * hd)
    kernel_ops.append(kernel_ops[0] + bc * nh * (2 * 2 * Q * st * hd + Q + 3 * Q * hd))
    rows.append(_timed(
        "ssd_chunk_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:30 (+ src/repro/models/ssm.py:131-140)",
        (b, PROMPT_LEN, nh, hd, st),
        lambda: scan_kernel(*args, h_prev, D, nc, PROMPT_LEN, bf16),
        lambda: ssd_ref.ssd_chunk_scan(*chunked[:5], hp, D, PROMPT_LEN, bf16), None,
        n_bytes, n_ops, "bf16_tensor", iters=100))
    y_intra = ssd_kernel(*args).unflatten(0, (b, nc))
    passes = _device_ms(lambda: ssd_ref.chunk_output(y_intra, x, cum, Cc, hp, D, PROMPT_LEN,
                                                     bf16), 50)
    rows[1]["replaced_ms"] = rows[0]["ms"] + passes
    for r, ops in zip(rows, kernel_ops):
        say("timings", f"{r['name']}: the bf16 kernel runs {ops:.4g} operations (split bf16, "
                       f"whole 16 x 16 tiles) for the function's {r['ops']:.4g}")
    say("timings", f"ssd_chunk_scan replaces the intra entry ({rows[0]['ms']:.5f} ms) and the "
                   f"torch passes after it ({passes:.5f} ms device): {rows[1]['replaced_ms']:.5f} "
                   f"ms, against the fused entry's {rows[1]['ms']:.5f} ms")
    torch.cuda.synchronize()
    return rows


def _ssd_bwd_timing(dev) -> dict:
    """The SSD backward at [slice-ssm-train]'s shape (GC's 128 sequences of 4
    chunks: 512 batch-chunks of Q 64, 64 heads of 64, d_state 128), bf16 x,
    B, C and dy, beside the plain backward (``ref.ssd_chunk_scan_bwd``) and
    autograd of the plain forward; no one PyTorch call computes it.  The
    bound: every input read once and every output written once, against the
    function's products at the bf16 tensor-core rate.  Returns the JSON row."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_scan_bwd as scan_bwd

    gen = torch.Generator(device=dev).manual_seed(6)
    b, nc, Q, nh, hd, st = TRAIN_SEQS, SSM_TRAIN_SEQ // 64, 64, 64, 64, 128
    bf16, bc, s = torch.bfloat16, TRAIN_SEQS * SSM_TRAIN_SEQ // 64, SSM_TRAIN_SEQ
    args = _ssd_inputs(dev, gen, b, nc, Q, nh, hd, st, bf16)
    h_prev = torch.randn((bc, nh, hd, st), generator=gen, device=dev) * 0.5
    D = torch.randn(nh, generator=gen, device=dev)
    dy = torch.randn((b, s, nh, hd), generator=gen, device=dev).to(bf16)
    chunked = [t.unflatten(0, (b, nc)) for t in (*args, h_prev)]
    outs = scan_bwd(*args, h_prev, D, dy, nc, s)
    n_bytes = sum(t.numel() * t.element_size() for t in (*args, h_prev, D, dy, *outs))
    # the function's work: S = C B^T, dW and W^T dy over the causal half; dB
    # and dC from dS; G = dy . h_prev and dh_prev per head; the elementwise
    # terms (W, dW * W, dS, the inter-chunk dcum and dC, dx, ddt, dD)
    causal = Q * (Q + 1) // 2
    n_ops = bc * (3 * 2 * causal * st + nh * (2 * 2 * causal * hd + 2 * 2 * Q * hd * st
                                              + 6 * causal + 4 * Q * st + 6 * Q * hd))
    del outs
    row = _timed("ssd_chunk_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                 "src/repro/kernels/ssd_scan/ssd_scan.py:30 (no backward there: C-2)",
                 (bc, Q, nh, hd, st), lambda: scan_bwd(*args, h_prev, D, dy, nc, s),
                 lambda: ssd_ref.ssd_chunk_scan_bwd(*chunked, D, s, dy), None,
                 n_bytes, n_ops, "bf16_tensor", iters=10)
    leaves = [t.detach().clone().requires_grad_(True) for t in (*chunked, D)]
    y = ssd_ref.ssd_chunk_scan(*leaves[:6], leaves[6], s, bf16)
    autograd = _device_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), 5)
    del y, leaves
    row["launch_ms"] = _launch_ms(lambda: scan_bwd(*args, h_prev, D, dy, nc, s), 5)
    say("timings", f"ssd_chunk_scan_bwd {row['shape']}: kernel {row['ms']:.5f} ms, "
                   f"{_rates(row)} ({row['bound_ms']:.5f} ms by {row['bound_by']}; the bf16 "
                   f"kernels run its products on the tensor cores); plain backward "
                   f"{row['plain_ms']:.5f} ms, autograd of the plain forward {_ms(autograd)}; "
                   f"by launch "
                   + ", ".join(f"{k} {v:.5f} ms" for k, v in row["launch_ms"].items()))
    torch.cuda.empty_cache()
    return row


def _launch_ms(fn, calls: int) -> dict:
    """Device ms a call of each kernel that fn launches, by its name (the
    profiler's, cut to the kernel and its template arguments), over ``calls``
    profiled calls after a warm-up."""
    import re

    fn()
    times: dict[str, float] = {}
    for name, us, _ in _device_events(lambda: [fn() for _ in range(calls)]):
        m = re.search(r"\w+_kernel(<[^>]*>)?", name)
        key = m.group(0) if m else name[:60]
        times[key] = times.get(key, 0.0) + us / 1e3 / calls
    return times


def _logit_check(name, got, want, quiet=False, phase="slice") -> float:
    import torch

    if not torch.isfinite(got).all():
        fail(f"{phase} {name}: non-finite logits")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL):
        fail(f"{phase} {name}: kernel-path logits differ from the plain path by {err:.3e}")
    if not quiet:
        say(phase, f"f32 {name} logits {tuple(got.shape)}: max_abs_err {err:.3e}")
    return err


def _cuda_ms(fn, iters: int) -> float:
    """Per-call time between CUDA events around ``iters`` back-to-back calls.

    When a call's host work (Python, launch) outlasts its device work, this
    is the host's rate, not the device's.
    """
    import torch

    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: spin kernels (``torch.cuda._sleep``) launched before and after the work of a
#: profiled session, and the counts of those the profiler recorded
SPINS = 16
SPIN_COUNTS = {"sessions": 0, "lead": 0, "trail": 0}


def _device_events(fn, span=None):
    """(name, microseconds, span) of every device activity the profiler records in fn().

    The profiler can lose the first or last device activities of a session
    (on the H100 a single call profiled alone came back empty, and 494 of 500
    calls were recorded), so fn runs between spin kernels that absorb the
    loss: SPINS before and after a 50 ms pause, and SPINS after fn.  The
    spins are left out of the result and counted in ``SPIN_COUNTS``.  With
    ``span``, host calls are traced too, and an activity launched inside a
    profiler range of that name (``models/layers.py:_span``) has ``span`` as
    its third field; every other activity has None there."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if span else [])
    with profile(activities=activities) as prof:
        for lead in range(2 * SPINS):
            torch.cuda._sleep(1000)
            if lead == SPINS - 1:
                time.sleep(0.05)
        fn()
        for _ in range(SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    names = {}
    if span:
        # a device activity and the runtime call that issued it (cudaLaunchKernel,
        # cudaMemcpyAsync, ...) share the CUPTI correlation id
        cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        ranges = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == span)
        starts = [r[0] for r in ranges]
        for e in cpu:
            if e.name.startswith("cu"):
                i = bisect.bisect_right(starts, e.time_range.start) - 1
                if i >= 0 and e.time_range.start <= ranges[i][1]:
                    names[e.id] = span
    events = sorted((e.time_range.start, e.name, e.time_range.elapsed_us(), names.get(e.id))
                    for e in prof.events() if e.device_type == DeviceType.CUDA and e.name != span)
    work = [event for event in events if "spin_kernel" not in event[1]]
    first = work[0][0] if work else float("inf")
    SPIN_COUNTS["sessions"] += 1
    for start, name, _, _ in events:
        if "spin_kernel" in name:
            SPIN_COUNTS["lead" if start < first else "trail"] += 1
    return [(name, t, in_span) for _, name, t, in_span in work]


def _device_ms(fn, iters: int) -> float:
    """Device time per call from the profiler (see :func:`_profiled`); where
    the profiler recorded no device time at all, CUDA-event time per call, with
    a ``FLAG`` line, as ``_timed`` does."""
    ms = _profiled(fn, iters)["ms"]
    if ms is None:
        ms = _cuda_ms(fn, iters)
        say("timings", f"FLAG the profiler recorded no device time; CUDA events per call "
                       f"{ms:.5f} ms")
    return ms


def _profiled(fn, iters: int) -> dict:
    """The profiler's reading of ``iters`` calls of fn after 10 warm-up calls:
    ``ms``, the device time of one call, host overhead excluded (None when the
    profiler records no device time); ``recorded``, the device activities it
    recorded; ``expected``, ``iters`` times the activities of one call profiled
    alone; ``each_us``, the durations of the recorded activities.  Where it
    recorded fewer than expected, ``ms`` is the mean over the calls it recorded,
    so a lost activity does not count as a call that took no time."""
    for _ in range(10):
        fn()
    expected = iters * len(_device_events(fn))

    def run():
        for _ in range(iters):
            fn()

    each = [t for _, t, _ in _device_events(run)]
    calls = iters * min(1.0, len(each) / expected) if expected else iters
    ms = sum(each) / calls / 1e3 if sum(each) > 0 else None
    return {"ms": ms, "recorded": len(each), "expected": expected, "each_us": each}


def _category(name: str) -> str:
    if "attn_bwd" in name:
        return "flash_attention backward kernels"
    if "rmsnorm_bwd" in name:
        return "rmsnorm backward kernels"
    if "coded_combine_kernel" in name:
        return "coded_combine kernel"
    if "attn_fwd" in name:
        return "flash_attention kernel"
    if "rmsnorm_kernel" in name:
        return "rmsnorm kernel"
    if "window_stats_kernel" in name or "buffer_stats_kernel" in name:
        return "gate_window kernels"
    if "ssd_bwd_" in name:
        return "ssd_scan backward kernels"
    if "ssd_bf16_kernel" in name or "ssd_f32_kernel" in name:
        return "ssd_scan kernel"
    if any(w in name.lower() for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, softmax, argmax)"


def _breakdown(phase: str, events, wall_ms: float) -> None:
    busy = sum(t for _, t, _ in events) / 1e3
    say(phase, f"device busy {busy:.3f} ms of {wall_ms:.3f} ms wall (idle share "
               f"{max(0.0, 1 - busy / wall_ms):.3f}); {len(events)} device activities")
    cats: dict[str, float] = {}
    spans: dict[str, list] = {}
    names: dict[str, list] = {}  # the "other" category's activities, by name
    for name, t, span in events:
        cat = _category(name)
        if span is None and cat.startswith("other"):
            names.setdefault(name, []).append(t / 1e3)
        if span is not None:
            spans.setdefault(span, []).append(t / 1e3)
            cat = f"{span} layers: {cat}"
        cats[cat] = cats.get(cat, 0.0) + t / 1e3
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        say(phase, f"  {cat}: {ms:.3f} ms ({ms / busy:.3f} of busy)")
    for span, ts in spans.items():
        say(phase, f"  {span} layers in all: {sum(ts):.3f} ms ({sum(ts) / busy:.3f} of busy) "
                   f"in {len(ts)} device activities")
    # the largest single device activities, by name, of the "other" category,
    # their functors named (PyTorch's templates put them past the first 90
    # characters)
    for name, ts in sorted(names.items(), key=lambda kv: -sum(kv[1]))[:5]:
        short = name.replace("void ", "").replace("at::native::", "").replace("c10::", "")
        say(phase, f"    {sum(ts):.3f} ms in {len(ts)} x {short[:150]}")


def _timed(name, source, replaces, shape, kernel, plain, library, n_bytes, n_ops, op_type,
           iters):
    """One kernel's timing row: device time per call from the profiler for
    the kernel, its plain version and the library call, CUDA-event time per
    call beside each, and the bound.  Anything the profiler did not record
    as it should is flagged in ``notes`` and on the ``[timings]`` line."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    bound = max(t_bytes, t_ops)
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": None, "max_abs_err": None}
    notes = []
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        call_key = key.replace("ms", "call_ms")
        row[key] = row[call_key] = None
        if fn is None:
            continue
        row[call_key] = _cuda_ms(fn, iters)
        prof = _profiled(fn, iters)
        row[key] = prof["ms"]
        if prof["ms"] is None:
            notes.append(f"{key}: the profiler recorded no device time; CUDA events per call")
            row[key] = row[call_key]
        elif prof["recorded"] != prof["expected"]:
            notes.append(f"{key}: the profiler recorded {prof['recorded']} of "
                         f"{prof['expected']} device activities over {iters} calls; "
                         f"mean over the recorded calls")
        if key == "ms":
            each = prof["each_us"]
            row["profiler"] = {k: prof[k] for k in ("recorded", "expected")}
            if each:
                row["profiler"].update(activity_us_min=min(each), activity_us_max=max(each),
                                       activity_us_median=statistics.median(each))
    if row["ms"] < bound:
        notes.append(f"ms: the kernel's {row['ms']:.5f} ms is below its {bound:.5f} ms bound")
    for note in notes:
        say("timings", f"FLAG {name}: {note} (profiler {row.get('profiler')})")
    row.update({
        "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "timing": "profiler device time" if row["ms"] != row["call_ms"] else "cuda events",
        "notes": notes,
        "shape": list(shape), "bytes": n_bytes, "ops": n_ops,
    })
    return row


if __name__ == "__main__":
    main()
