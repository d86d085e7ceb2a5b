#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. build   — compile every CUDA source of the port with nvcc (sm_90a), one
             nvcc per source, in parallel (the five libraries: flash bf16
             with f32, flash f16, flash past 128 columns, matmul bf16 with
             f32, matmul f16), logging each source's seconds; log registers
             per instantiation and spills, and fail on a spill in any
             library or an ignored setmaxnreg; count each library's wgmma
             (HGMMA), TMA (UTMALDG), mma.sync (HMMA) and wgmma-wait
             (WARPGROUP.DEPBAR) instructions in its SASS and fail without
             HGMMA or TMA, with any HMMA, or with a wait after every HGMMA
             (serialized by ptxas) or a C7515 serialization note, and fail
             unless every 16-bit kernel's own SASS has HGMMA and UTMALDG and
             no HMMA; expect the 16-bit flash instantiations (in bf16 and in
             f16: 12 built head dims, 8 generic ones of padded width 64 or
             128; in each type 5 of width 192 or 256), the 24 matmul ones in
             each type, the 6 f32 flash and the 21 f32 matmul ones, and fail
             unless each f32 kernel's SASS has FFMA and no HGMMA or HMMA;
             check that the shared memory each library reports for every
             instantiation is what ``flash_attention.smem_bytes`` (the block
             picker's pruning) and ``matmul.smem_bytes`` (the tuner's
             ``sm90`` accounting) say, at 2 bytes and, for the f32 kernels,
             at 4 (-1 where none is built).
2. kernels — hold the flash-attention kernel against its plain torch version
             on the card, in bf16, at yi-6b shapes (B=1, Hq=32, Hkv=4,
             D=128) for every prompt length the serve phase prefills and a
             few more, and one D=64 case, with the blocks the main path
             picks; show that the limit would catch a dropped tail tile;
             then at stablelm-3b's head dim 80 (Hq=Hkv=32, causal and not,
             the same lengths), where the kernel pads its tiles to 128
             columns, and show that the limit would catch a kernel that
             lost the second column atom (columns 64-79 zero); then the
             generic builds at D = 16, 32, 48 and 96 (32/4 heads, S = 1, 77,
             513, 1024, causal and not), where the limit must catch a
             kernel that dropped the last 8 columns. Then, with TF32 off
             everywhere, the f32 flash kernel at every block pair it is
             built for against its plain version and the oracle at the
             reference's grid (tests/test_kernels.py, causal and not) and at
             the reduced configs' shapes (4/2 and 4/4 heads of 16, S = 1,
             12, 64, 77), and the f32 matmul kernel at every built
             configuration of the reference's matmul grid and dense_256/512
             (the tuner's pick at 4 bytes among them), at the reference's
             f32 limits, which must flag the plain version run on
             TF32-rounded inputs at the reference's grids.
3. timing  — at every prompt length of the serve, causal: the kernel, its
             plain version and, as a yardstick only, torch's
             scaled_dot_product_attention (the port never calls it), with
             CUDA events: the kernel and SDPA as device time (a CUDA graph of
             the calls, replayed) and as back-to-back eager calls, the plain
             version eagerly; the bound from the data sheet. Then the f32
             flash kernel at S=1024 (32/4 heads of 128, causal) and at the
             reduced shape (8 x 64 tokens, 4/2 heads of 16) against SDPA in
             f32 (efficient or math backend), the bf16 generic builds at
             D=16 and 96 against SDPA, and the f32 matmul at 2048x4096x4096
             and 256^3 against torch.matmul with TF32 off, each in turns by
             graph replay, beside its plain version and its bound (f32 at
             the FP32 rate, 67 TFLOP/s).
3b. reduced — the ten archs' ``.reduced()`` configs (f32, head dim 16) on
             the card through their normal entry points, counted: see
             ``reduced_phase``. One ``reduced {...}`` JSON line.
4. matmul  — hold the matmul kernel against its plain version in bf16 at
             every yi-6b projection of a 2048-token prefill, the unembed and
             the reference's matmul_{1024,2048,4096}_bf16 presets, with every
             configuration of the Hopper space (the tuner's pick among them);
             show that the limit would catch a dropped last K block.
4b. f16-wide — the float16 kernels and the head dims past 128, from a
             generator of their own (F16_SEED): the bf16 builds' outputs at
             ``benchmarks/flash_ab``'s cases against the parent's digests
             (PARENT_BF16_DIGESTS: the templating on the element type left
             bf16's code as it was); the f16 flash kernel at yi-6b's heads
             at every prompt length, causal and not, and at D=64, at every
             built block pair, within F16_RTOL*|want| +
             F16_FLIP*softmax(.)|v| (one f16 ulp of every p, times |v|) of
             its plain version and at the pick of the f32 oracle, with a
             dropped tail tile and a lost last column atom that the limit
             must flag; the f16 matmul at every configuration at
             2048x4096x4096 (a dropped last K block must be flagged) and at
             the ragged shapes; the wide builds at WIDE_HEADS (Gemma 7B's
             16/16 heads of 256, 16/8 of 256, 32/4 of 192) at S = 1, 77,
             513, 1024, 2047 causal and 1500 non-causal, in bf16 and f16, at
             every block pair built for them; then the main path counted
             (``ops.attention`` at the wide shapes, ``ops.matmul`` in f16 at
             yi-6b's shapes) and the timing (``time_f16_wide``: f16 beside
             bf16 on the same values, each wide shape in both types, each
             against SDPA or torch.matmul in the same dtype, in turns).
5. tuner   — the slice's main path, counted: first the calibration, the
             gpu_h100 fit of the static features to seconds at the probe
             4096x2048x4096 (16 configurations, seed 123, timed by CUDA-graph
             replay; finite and non-negative coefficients, r2 logged), its
             measurements kept as cm1-meas rows; then at each yi-6b shape
             the ES search (tune, seed 0) against the exhaustive best,
             ops.matmul with the statically picked blocks, and the paper's
             top-k ratio (every configuration timed on the card, as device
             time by CUDA-graph replay, kept as cm1-meas rows); then those
             same times ranked three ways with no launch: static (data
             sheet), calibrated (the fit) and hybrid (the static top 12
             re-ranked by a learned ranker trained with ``train_from_store``
             on the cm1-meas rows of the probe and the other four shapes,
             never its own, and round-tripped through its artifact), each a
             permutation of the measured configurations; top1, ratio@5 and
             rank_corr per ranking, and topk --check as a reading. The
             matmul launches must equal the probe's 16 x (3 + iters) plus,
             per shape, 1 + configs x (3 + iters). Then, at every yi-6b shape,
             the kernel and torch.matmul (a yardstick the port never calls)
             by graph replay and as back-to-back eager calls, and the
             data-sheet bound; the plain version at 2048x4096x4096.
6. serve   — yi-6b at full width and depth with random weights from a seeded
             generator: 8 requests of mixed prompt lengths through the
             continuous engine; every request gets its tokens and the flash
             kernel launches once per layer per prefill.
   schedule-store — the same model, weights and requests with the block
             picks served from the schedule store: cold, an empty DB takes
             one record per distinct signature (flash at every prompt
             length, matmul at every yi-6b shape), each the pick the
             earlier phases made with no store; a snapshot built by
             ``python -m repro_torch.tuna snapshot`` in a subprocess, its
             sha1 checked, installed with the DB off; the 8 requests served
             again with the cost model counted, the flash blocks per S
             recorded and the snapshot republished (one more record) by the
             refresh hook after the first admission: zero evaluations, the
             cold blocks, 32 flash launches per prefill, the earlier
             serve's tokens, at least one hot reload, the new record
             served.
   golden-bundle — the store's DB promoted into a golden release under
             build/golden: re-promoting identical content is a no-op, a
             record made slower is refused by the regression gate and then
             promoted under a waiver recorded in the release; a kernel
             bundle built by ``python -m repro_torch.tuna golden --bundle``
             in a subprocess (its size, library sha1s and skips logged); a
             torn, a stale, a CPU and a source-edited bundle each refused
             at load; then two cold starts, each a fresh process running a
             copy of src/repro_torch whose build/kernels is empty: one with
             the snapshot installed, one with the bundle. Each makes one
             ops.matmul call at a bundled yi-6b shape without blocks, then
             serves full-width yi-6b (the phase-6 seed) on the same 8
             requests; seconds to the first token and to the end, nvcc
             runs, cost-model evaluations, bundle hits and launches are
             logged. The unbundled start must run nvcc, the bundled one
             none, with no evaluation and at least one bundled hit; both
             give the phase-6 tokens; the bundled matmul equals the
             explicit-blocks launch and the unbundled start's bit for bit.
             Before the cold starts, an f16 ops.matmul at a bundled yi-6b
             shape with the bundle installed in this process: it must miss
             the bf16 records' entries and launch the f16 kernel once, from
             the bundle's matmul_f16 library, with no nvcc run, bit for bit
             the explicit f16 launch at the record's blocks.
7. parity  — the last logits of one prefill through the kernel and through
             the plain version agree within a stated bf16 tolerance; then
             yi-6b's weights are freed.
7a. f16-serve — yi-6b uncut with float16 parameters and compute
             (``serve_arch(..., dtype="float16")``): the same 8 requests,
             every request gets its tokens, the f16 flash kernel launches
             once per layer per prefill (256) and the bf16 one never, and
             the S=513 parity of phase 7 at F16_LOGIT_TOL; no profiled rerun.
8. groups  — the flash kernel against its plain version and the oracle at
             the head groups of the later serves, (Hq, Hkv) = (64, 4),
             (48, 8), (40, 8) and (32, 8), D=128, causal, at every prompt
             length they prefill; at whisper-large-v3's 20/20 heads of 64,
             non-causal over its encoder's 1500 frames (a ragged last tile)
             and causal at its decoder's prompts; at internvl2-1b's 14/2
             heads of 64 (group 7), causal over its 256 patches and each
             prompt; the kernel, SDPA and the plain version at S=1024 at
             the first groups and at (32, 32) with D=80 (the bound from the
             unpadded work), at S=1500 non-causal (whisper's encoder) and at
             S=256+1024 (internvl2).
9. moe-serve, hybrid-serve — qwen3-moe-235b-a22b (8 of 94 layers) and
             jamba-v0.1-52b (one period, 8 of 32 layers) at full width with
             seeded random weights, the same 8 requests through the
             continuous engine: every request gets its tokens, the flash
             kernel launches once per attention layer per prefill; a
             profiled second run split into MoE routing and ranks,
             gather/scatter, expert products, attention, mamba and the rest,
             with the share of MoE assignments dropped per prefill and
             whether slot (0, 0) was emptied, and the device time of the
             MoE gather/scatter span (dispatch gather and combine); the
             parity of phase 7 with the kernel run's MoE routing pinned in
             the plain run. Both also serve the same 8 requests a second
             time and fail unless every token equals the first serve's (the
             MoE combine sums in a fixed order, with no atomics).
10. dense-serve — nemotron-4-15b (32 layers), qwen2.5-14b (48) and
             stablelm-3b (32), uncut, one after another, each freed before
             the next: the same 8 requests, every request gets its tokens,
             flash launches = prefills x layers, a profiled second run, the
             parity of phase 7.
11. recurrent-serve — xlstm-1.3b uncut (48 layers: 42 mLSTM, 6 sLSTM, no
             attention) through the same serve: the first mLSTM layer's
             chunkwise prefill at S=300 (4 tokens per chunk) and S=77 (one)
             and the first sLSTM layer's scan against their decode stepped
             in f32 (in f32, output and final state; in bf16, the output
             error against the bf16 stepped decode's own); the same 8
             requests (the 1024-token prompt is the mLSTM head dim, where
             the reference's prefill breaks its own decode), every request
             gets its tokens, no flash launch; a profiled second run of one
             of them (S=77: the whole serve launches about 6 M kernels)
             split into mlstm, slstm and the rest. The parity of phase 7
             compares attention, which this arch has none of: skipped, and
             logged.
7b. train — the flash kernel under autograd on the card: dq, dk, dv through
             ``ops.attention`` (the kernel's forward, then
             ``flash_attention_backward``) in bf16 against autograd through
             the plain version on f32 copies, at yi-6b's heads (S=77, 513,
             2048 causal), whisper's encoder (20/20 of 64, S=1500,
             non-causal) and stablelm's head dim 80, with the forward's
             limit, which must catch a backward that drops the last key
             block, and the forward's output against the plain version's;
             the forward kernel held against its plain version at the
             training shape (B=2), then it and the backward timed there.
             Then yi-6b uncut (32 layers) through
             ``launch.train.train``: B=2 x 2048 tokens, bf16 moments, 4
             steps, per-group remat; each step's loss and gradient norm
             finite, flash launches = 4 x 32 x 2 (forward and recompute),
             the first step within stated limits of the same step with
             attention through the plain version (loss, gradient norm, each
             parameter's gradient norm), limits that must catch the same
             step with a backward whose dq is halved (a second control, a
             backward that drops the last key block, is logged); the median
             step seconds, tokens/s, peak memory, and a profiled fifth
             step's device idle share (against its own wall time) and
             device time by span (attention forward, attention
             backward, cross-entropy, optimizer, the rest). Then a resume at
             yi-6b's widths with 2 layers: ``train_with_recovery`` with int8
             moments, two microbatches, int8 gradient compression, a
             checkpoint every 2 steps and a failure at step 3 must end
             bit-equal to an uninterrupted run, and two uninterrupted runs
             must be bit-equal to each other. The uncut run's parameter
             and moment leaves are digested (sha1 of each leaf's bytes, on
             the host) before the profiled fifth step updates them.
7c. mesh  — the same yi-6b run (steps, batch, length, seed, bf16 moments)
             through ``train(..., mesh_shape=(1, 1))`` on a one-rank NCCL
             group (``launch/mesh.init_process_group``: a store on
             127.0.0.1): parameters and moments are DTensors placed by
             the sharding rules and the flash kernel takes the local
             shards through ``local_map``. Its loss history must equal the
             ``train`` phase's bit for bit, every leaf digest the ``train``
             phase's, and its flash launches 4 x 32 x 2; the median step
             seconds beside the meshless median (DTensor's host cost), the
             peak memory, a profiled fifth step's idle share and device
             time by span. Then at the resume's 2 layers: a meshless run
             saved at step 2, restored onto the 1x1 mesh by
             ``elastic.restore_on_mesh`` inside ``train`` and continued to
             step 4, must end bit-equal to an uninterrupted meshless run.
             Then ``psum_int8`` over the one-rank group must equal
             ``int8_compress_decompress`` bit for bit, and a one-stage
             ``pipeline_apply`` its stage function applied per microbatch.
7d. dryrun — the dry run (``launch/dryrun.run_cell``), which runs no step
             on any device: the step traced on meta tensors over a fake
             process group on the host. First the card's own cell, the
             ``train``/``mesh`` phases' configuration (yi-6b uncut, B=2 x
             2048, bf16 moments, one microbatch) on a one-rank group: its
             predicted per-device peak (arguments + temporaries) against
             the ``mesh`` phase's measured ``max_memory_allocated``, within
             DRYRUN_PEAK_RTOL, and no collective; its counted flops beside
             the 6 N T of the analytic MFU. Then yi-6b x train_4k,
             prefill_32k and decode_32k on the 16x16 production mesh (256
             fake ranks): each ``status == "ok"``, with its trace seconds,
             per-device GiB against the card's memory and collectives by
             kind. Before those, the reference's three mini cells
             (reduced yi-6b on 2x4 and 2x2x2, reduced qwen3-moe on 2x4, at
             train_4k): each one's scaled collective operand and link
             bytes at most DRYRUN_RATIO (qwen3-moe DRYRUN_MOE_RATIO) times
             the reference's (DRYRUN_MINI), so the count is held on the
             card's torch too; and reduced xlstm-1.3b's decode_32k on 2x4
             must trace. The production cells must fit the card's memory,
             and train_4k's operand bytes may not exceed theirs before
             the layout regions (DRYRUN_BEFORE). One ``dryrun {...}`` JSON line.
7e. controller — the fleet controller (``python -m repro_torch.tuna
             controller --smoke --targets gpu_h100 --num-shards 2``, process
             workers, shard 0's first worker crashed, over a dir:// channel
             under build/controller, its snapshots published to another,
             ``--exit-when-converged --port 0``): exit 0, converged, one
             shard healed, a snapshot published. Then a third host joins
             with its own store (the schedule-store phase's, yi-6b's matmul
             shapes among its records) pushed as shard 2, and a controller
             in this process over the same store and channel, three shards
             wide, resumes all three, converges with no dispatch and serves
             HTTP: ``GET /schedule`` for each yi-6b matmul shape equals
             ``python -m repro_torch.tuna query --json`` for it, and the
             matmul kernel launched at the served blocks is within the
             matmul limit of its plain version (the launches join the
             ``kernels`` line's matmul count). One ``controller {...}``
             JSON line.
12. encdec-vision — whisper-large-v3 (32 encoder and 32 decoder layers)
             and internvl2-1b (24 layers), uncut, one after the other, each
             freed before the next, through ``Model.prefill`` and
             ``Model.decode_step`` (the reference's only entry for them: its
             serve takes tokens only), B=1, with seeded stub frames or
             patches at 0.1 N(0, 1): a greedy decode of 16 tokens per prompt
             (whisper at the prompts that fit its 448-token decoder context,
             internvl2 at all 8 after its 256 patches); every request gets
             its tokens, flash launches = prefills x 64 (encoder and decoder)
             and x 24; a profiled second run of the first request (whisper's
             four requests launch about a million kernels) split into
             attention, cross-attention and the rest; the parity of phase 7.

Prints a ``reduced``, a ``train``, a ``mesh``, a ``dryrun`` and a ``controller`` JSON line, a ``topk`` JSON line (top1, ratio@5 and rank_corr
per shape for the static, calibrated and hybrid rankings, the check, the fit), a
``kernels`` JSON line,
then the card's name and power limit, then ``{"ok": true, "device": {...}}``
as the last line. Needs one card; imports no jax and nothing of the
reference package. ``python3 chip_smoke.py --cold-start-arm SPEC`` is one
cold start of the golden-bundle phase, which runs it in a subprocess.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "yi-6b"
# the dry run's predicted peak of the card's training cell against the
# measured one (PERF.md section 5, written before the first chip run)
DRYRUN_PEAK_RTOL = 0.05
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# those cells' operand bytes before the explicit layout regions
# (parallel/context.region); the train cell's may not grow past them
DRYRUN_BEFORE = {"train_4k": 6.971e11, "prefill_32k": 3.689e10, "decode_32k": 1.135e8}
# the reference's mini cells (reduced configs at train_4k): its scaled
# operand and link bytes per device, from the reference's run_cell on the
# CPU (jax 0.9), as tests/test_torch_dryrun.py compares them; the card has
# no jax. The port's may be at most DRYRUN_RATIO times either (qwen3-moe's
# DRYRUN_MOE_RATIO, as the test holds them)
DRYRUN_MINI = {"yi_6b 2x4": ("yi_6b", {"data": 2, "model": 4}, 827164736.0, 1614497870.0),
               "yi_6b 2x2x2": ("yi_6b", {"pod": 2, "data": 2, "model": 2}, 572752968.0,
                               574498376.0),
               "qwen3_moe 2x4": ("qwen3_moe_235b_a22b", {"data": 2, "model": 4},
                                 2974380102.0, 4707666005.0)}
DRYRUN_RATIO = 2.0
DRYRUN_MOE_RATIO = 1.15
PROMPT_LENS = (64, 77, 128, 300, 513, 1000, 1024, 2047)
MAX_NEW = 16
SLOTS = 4
SEED = 0
# An element passes when |got - want| <= RTOL * |want| + ATOL_RMS * rms(want).
# Against the plain version: one bf16 ulp of the output (both round the same
# f32 softmax, summed in another order), plus a floor for outputs near zero.
KERNEL_RTOL, KERNEL_ATOL_RMS = 2**-7, 0.02
# Against the f32 full-softmax oracle: also the bf16 cast of p before p.v.
ORACLE_RTOL, ORACLE_ATOL_RMS = 2**-6, 0.05
# At the head groups of the MoE and hybrid serves, against the plain version:
# two bf16 ulps. Both round p to bf16 before p.v and the output once; where
# ex2.approx and torch.exp put one p on two sides of a bf16 rounding point in
# a row of few keys, the f32 outputs differ by up to an ulp before their own
# rounding, so by up to two after. At Hq=64, S=2047 (16.8 M outputs, twice
# yi-6b's) one element reached 1.051 of the one-ulp limit. The oracle limit
# stays as it is.
GROUP_RTOL = 2**-6
KERNEL_S = (1, 77, 513, 1024, 2047)
LOGIT_TOL = 0.25   # |logit| ~ N(0, 1): 32 bf16 layers amplify ulp differences
TIMED_S = 1024
# matmul: an element passes when |kernel - plain| <= MM_RTOL * |plain| +
# MM_ATOL_RMS * rms(plain). Both sum exact bf16 products in f32 (in another
# order) and round once, so they differ by at most about one bf16 ulp;
# dropping a bk slice of K moves an output by about sqrt(bk/K) * rms.
MM_RTOL, MM_ATOL_RMS = 2**-7, 0.01
MM_PRESETS = ((1024, 1024, 1024), (2048, 2048, 2048), (4096, 4096, 4096))
MM_TIMED = (2048, 4096, 4096)
TOPK_ITERS = 10
# the MoE and hybrid serves: full width, depth cut to fit one card (80 GB):
# qwen3-moe 8 of 94 layers (21.15 B parameters, 42.3 GB in bf16; 94 layers
# would be about 470 GB), jamba one period, 8 of 32 layers (1 attention, 7
# mamba, 4 MoE and 4 dense MLPs; 13.3 B parameters, 26.6 GB; 32 layers
# would be about 103 GB)
NEW_SERVES = (("qwen3-moe-235b-a22b", 8), ("jamba-v0.1-52b", 8))
# the dense decoders, uncut (every layer, every width): nemotron-4-15b (32
# layers, 15.63 B parameters, 29.1 GiB in bf16; layernorm, squared ReLU,
# 48/8 heads), qwen2.5-14b (48 layers, 14.77 B, 27.5 GiB; QKV bias, 40/8
# heads) and stablelm-3b (32 layers, 2.80 B, 5.2 GiB; layernorm, 32 heads
# of 80, MHA)
DENSE_SERVES = (("nemotron-4-15b", 32), ("qwen2.5-14b", 48), ("stablelm-3b", 32))
# stablelm-3b's attention: head dim 80, which the kernel stages padded to
# 128 columns; held to the one-ulp limit KERNEL_RTOL (32 heads of 80 give
# fewer outputs per case than yi-6b's 32 of 128)
D80_HEADS = (32, 32, 80)
# The MoE layer at full width against a loop over its kept assignments in
# f32: the layer rounds h, g, their product, the expert output and its
# gate-weighted copy to bf16 (2^-8 relative each) and adds the top-k
# contributions in bf16, so about 2^-6 relative to a contribution, with
# random signs; limit 2^-5*|loop| + 0.05*rms(loop).
MOE_RTOL, MOE_ATOL_RMS = 2**-5, 0.05
# The mamba mixer at full width: its bf16 chunked prefill and its bf16
# decode stepped token by token, each against the decode stepped in f32 (on
# f32 copies of the weights and input). The output as tests/test_torch_cuda.py
# argues: 2^-6*|f32| + 0.05*rms(f32). The final state compounds the bf16
# rounding of its inputs over its memory, up to 1/(1 - dA), about 100 steps
# for the slowest channel: dt carries about 2^-9 of relative error, about
# 3e-4 in log dA per step, about 3e-3 over 100 steps with random signs, and
# the tails of 131,072 elements reach five times that (two elements of the prefill-vs-
# decode state reached 1.100 of a 2^-6 limit in this PR's first full-width
# run): 2^-5*|f32| + 0.05*rms(f32).
MAMBA_RTOL, MAMBA_ATOL_RMS = 2**-6, 0.05
STATE_RTOL = 2**-5
# The xLSTM mixers at full width, against their decode stepped in f32 on f32
# copies of the weights and input. In f32 the prefill (chunkwise for the
# mLSTM) and the stepped decode compute one function summed in another
# order: output and final state (mLSTM C, n, m; sLSTM c, n, h, m) within
# 2^-10*|f32| + 2^-10*rms(f32) (a rehearsal on the CPU at full width: the
# mLSTM at S=300 within 9.2e-5, with rms(f32) 1.45). In bf16 the mLSTM is
# ill-conditioned at a few positions (h = num / max(|den|, exp(-m)), with
# q, k, v rounded to bf16): in that rehearsal its bf16 prefill and its bf16
# stepped decode both erred by 0.369 at one position, 2.5 times the mamba
# output limit. So the bf16 prefill's max |bf16 - f32| output error is held
# to at most XLSTM_BF16_MULTIPLE times the bf16 stepped decode's own (two
# bf16 computations of one function, rounding at other places, as the CPU
# tests bound the port's bf16 error by twice the reference's), and its final
# state to STATE_RTOL*|f32| + MAMBA_ATOL_RMS*rms(f32), as the mamba state.
XLSTM_F32_RTOL, XLSTM_F32_ATOL_RMS = 2**-10, 2**-10
XLSTM_BF16_MULTIPLE = 2.0
MLSTM_S = (300, 77)   # 4 tokens per chunk, and one (77 is odd)
RECURRENT_SERVES = (("xlstm-1.3b", 48),)
# whisper-large-v3's published decoder context (max_target_positions): its
# prompts are the PROMPT_LENS whose 16 new tokens fit in it
WHISPER_CONTEXT = 448
# The train phase: yi-6b uncut (32 layers), B=2 x 2048 tokens (under 4096, so
# every attention layer takes the flash kernel), bf16 moments, 4 steps.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 4
# Its first step through the kernel against the same step with attention
# through the plain version (autograd through ``flash_attention_plain``),
# both in bf16: the loss (about ln(64000) = 11.07 at random init, a mean over
# 4096 tokens) within TRAIN_LOSS_TOL absolute, the global gradient norm
# within TRAIN_GNORM_RTOL relative and each parameter leaf's gradient norm
# within TRAIN_LEAF_RTOL relative. The two differ in where attention rounds
# to bf16 (the plain backward rounds dP at its p cast), not in what they
# compute. The limits must catch the same step with a kernel that lost its
# batch offset and with a backward whose dq is halved (``faulty_attention``;
# a faulty backward leaves the loss bit-equal, as it is computed before any
# backward). On the card (H100 80GB HBM3, 700 W; yi-6b uncut; the readings
# repeat bit for bit) the sound step read |d loss| 2.460e-4, relative d norm
# 3.282e-4 and largest relative d leaf norm 6.856e-4; the lost batch offset
# 7.648e-4 / 4.972e-3 / 8.363e-2, the halved dq - / 2.603e-2 / 5.079e-1.
# Each limit lies between the sound reading and the nearest control's.
TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_RTOL = 5e-4, 3e-3, 1e-2
# The flash gradient check: dq, dk, dv through ``ops.attention`` (the
# kernel's forward, then ``flash_attention_backward``) in bf16 against
# autograd through the plain version on f32 copies of the same inputs (in
# bf16 the plain version's own backward rounds dP to bf16 before dP - rowsum
# cancels, erring by up to 0.14 rms(dq) at S=2048 in a CPU rehearsal), held
# to the forward's limit KERNEL_RTOL*|plain| + KERNEL_ATOL_RMS*rms(plain):
# the gradients are rounded to bf16 once. yi-6b's heads at three lengths,
# whisper's encoder and stablelm's head dim 80.
GRAD_CASES = ([(1, 32, 4, s, 128, True) for s in (77, 513, TRAIN_S)]
              + [(1, 20, 20, 1500, 64, False), (1, 32, 32, 513, 80, True)])
# The resume check: yi-6b's widths at 2 layers, int8 moments, two
# microbatches of one row of 1024 tokens, int8 gradient compression, a
# checkpoint every 2 steps, a failure injected at step 3.
RESUME_LAYERS, RESUME_B, RESUME_S, RESUME_STEPS = 2, 2, 1024, 4
# The f32 kernels against their plain versions in f32 (TF32 off on both
# sides), at the reference's own limits (tests/test_kernels.py): flash
# |kernel - plain| <= F32_FLASH_ATOL + F32_FLASH_RTOL*|plain|, matmul
# F32_MM_TOL*sqrt(K) + F32_MM_TOL*|plain|. Both sum exact f32 products in
# another order. A product on TF32-rounded inputs (10 mantissa bits) must
# fall outside them at the reference's grids.
F32_FLASH_ATOL, F32_FLASH_RTOL = 3e-5, 3e-4
F32_MM_TOL = 2e-4
# the reference's TestFlashAttentionKernel grid (B, Hq, Hkv, S, D) and its
# TestMatmulKernel shapes, then the dense_256 / dense_512 presets
F32_FLASH_GRID = ((1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 32),
                  (2, 4, 4, 512, 128))
F32_MM_SHAPES = ((128, 128, 128), (256, 128, 512), (64, 256, 128), (384, 256, 256),
                 (256, 256, 256), (512, 512, 512))
F32_MM_TIMED = ((2048, 4096, 4096), (256, 256, 256))
# the bf16 head dims of the generic builds the smoke checks and times
OTHER_HEAD_DIMS = (16, 32, 48, 96)
# The reduced phase: the ten archs' .reduced() configs (f32, 4 heads of 16,
# 2 or 4 key heads) on the card, 4 requests at these prompt lengths; the last
# logits of a prefill through the f32 kernel within REDUCED_LOGIT_RTOL *
# rms of the same prefill through the plain version (f32 against f32: the
# summation order only), and train_tiny's first step, loss and every
# gradient leaf, within REDUCED_GRAD_RTOL relative.
REDUCED_LENS = (1, 12, 64, 77)
# the seed of the generator the checks and timings of the kernels' other
# inputs draw from (the earlier phases' own stays SEED, its draws as before)
NEW_INPUTS_SEED = 1
REDUCED_LOGIT_RTOL = 1e-4
REDUCED_GRAD_RTOL = 1e-4
# Ragged tiles: (M, N, K) that no built matmul tile divides (decode-sized M
# against yi-6b's 4096 x 4096 projection, K = 80, N = 8). Both kernels run
# every configuration of each shape's space against the plain version at
# MM_RTOL / MM_ATOL_RMS (f32 also at the reference's f32 limit), and the
# limit must flag a kernel that dropped the ragged last rows, the last
# columns or the last K slice. RAGGED_MM_TIMED are timed at the static pick.
# Their inputs come from their own generator, so the earlier draws stay.
RAGGED_MM_SHAPES = ((1, 4096, 4096), (8, 4096, 4096), (32, 4096, 4096), (96, 4096, 4096),
                    (256, 256, 80), (64, 8, 64))
RAGGED_MM_TIMED = ((1, 4096, 4096), (8, 4096, 4096), (32, 4096, 4096), (96, 4096, 4096),
                   (256, 256, 80))
RAGGED_SEED = 2
# f16 (the float16 kernels) and head dims past 128 (the wide builds, both
# 16-bit types). The f16 flash kernel against its plain version and the f32
# oracle, per element: |kernel - want| <= F16_RTOL*|want| + F16_FLIP *
# (softmax(scale q k^T) |v|). F16_RTOL is two f16 ulps of the output (2^-9:
# its rounding on each side). F16_FLIP * softmax(.)|v| is one f16 ulp
# (2^-10 relative) of every probability times |v|: the most the f16 cast of
# p can move an output when ex2.approx and torch.exp (or the oracle's exact
# p) put each p on the other side of a rounding point (a subnormal p moves
# by 2^-24 at most). An rms floor cannot bound those flips in a row of few
# keys: on an H100 (700 W), 2^-9 with bf16's floor scaled by 2^-3 (0.0025
# rms) put 8 elements of 12.6 M at 32/4 heads of 192, S=2047, at 1.609 of
# the limit, every other case at 0.68 or less. The matmul: two
# ulps and bf16's floor scaled by the 2^-3 between the unit roundoffs
# (2^-11 and 2^-8). The f16 prefill's last logits: LOGIT_TOL scaled so.
F16_RTOL, F16_FLIP = 2**-9, 2**-10
F16_MM_RTOL, F16_MM_ATOL_RMS = 2**-9, MM_ATOL_RMS / 8
F16_LOGIT_TOL = LOGIT_TOL / 8
# the float16 serve: yi-6b uncut with float16 parameters and compute
F16_SERVE = ("yi-6b", 32)
# head dims past 128 at published widths: (Hq, Hkv, D, where it comes from)
WIDE_HEADS = ((16, 16, 256, "Gemma 7B's attention, arXiv:2403.08295"),
              (16, 8, 256, "16/8 heads of 256 (GQA at Gemma 7B's width)"),
              (32, 4, 192, "32/4 heads of 192 (yi-6b's heads at 192)"))
WIDE_S = (1, 77, 513, 1024, 2047)   # causal, and WIDE_NONCAUSAL_S non-causal
WIDE_NONCAUSAL_S = 1500
F16_SEED = 3
# The bf16 builds' outputs at repro_torch.benchmarks.flash_ab's cases
# (numpy-seeded inputs; flash at head dims 128, 80 and 64, matmul at
# yi-6b's five shapes), as sha1, from the commit before the f16 and wide
# builds were added (its libraries built from its own sources on an H100):
# the templating on the element type must leave bf16's code as it was.
PARENT_BF16_DIGESTS = {
    "flash_attention": {
        '{"B": 1, "D": 128, "Hkv": 4, "Hq": 32, "S": 1024, "blocks": [128, 128], "causal": true}':
            "ea8d335e25a2532e84ee26d997032c7f08b34e24",
        '{"B": 1, "D": 80, "Hkv": 32, "Hq": 32, "S": 1024, "blocks": [128, 128], "causal": true}':
            "ef7d5eefdedf05a098f3756750850ba34e14d0ae",
        '{"B": 1, "D": 64, "Hkv": 20, "Hq": 20, "S": 1500, "blocks": [128, 128], "causal": false}':
            "c4859a7b5b5966e3b2880ec4a7b27344ef27f47f",
        '{"B": 1, "D": 64, "Hkv": 2, "Hq": 8, "S": 1024, "blocks": [128, 128], "causal": true}':
            "5dd648ee2f1860640cbb62261f4c30d7c3593de8",
    },
    "matmul": {
        '{"K": 4096, "M": 2048, "N": 4096, "blocks": [128, 256, 128, true]}':
            "47c52abe1619fb84c98bf4828e7a2b079fcd7dff",
        '{"K": 4096, "M": 2048, "N": 512, "blocks": [128, 128, 128, true]}':
            "c2b3a6845d413516571b0617b3230a4e9ec4daf2",
        '{"K": 4096, "M": 2048, "N": 11008, "blocks": [128, 256, 128, true]}':
            "3fed65f3b5be69852f7b9cc613d6d9f1620a9bcd",
        '{"K": 11008, "M": 2048, "N": 4096, "blocks": [128, 256, 128, true]}':
            "9c1d0cf6b137663d8434eec02635c0bebead87b8",
        '{"K": 4096, "M": 2048, "N": 64000, "blocks": [128, 256, 128, true]}':
            "6cbecc0d6e49f9bbe4f99e71694a666905473750",
    },
}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: ``iters`` calls captured in
    a CUDA graph, replayed ``reps`` times between CUDA events (the top-k
    benchmark's ``measure.time_fn``). Unlike back-to-back eager calls this
    leaves out the host's dispatch, which is longer than a short kernel."""
    import torch
    from repro_torch.benchmarks.measure import time_fn

    return time_fn(fn, torch.device("cuda"), iters=iters, reps=reps) * 1e3


def outside(got, want, rtol: float, atol_rms: float, atol=None):
    """(elements outside the limit, max |got - want| / limit): rtol*|want|
    plus ``atol`` (a tensor of ``want``'s shape) where given, else
    ``atol_rms``*rms(want)."""
    got, want = got.float(), want.float()
    floor = atol if atol is not None else atol_rms * want.pow(2).mean().sqrt()
    limit = rtol * want.abs() + floor
    ratio = (got - want).abs() / limit
    return int((ratio > 1).sum()), float(ratio.max())


def drop_tail(q, k, v, causal: bool, keep: int):
    """The attention a kernel that skipped keys >= ``keep`` (its ragged last
    KV tile) would give, in f32: the error the kernel check must catch."""
    import torch

    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    seen = (pos[None, :] < keep) & ((pos[None, :] <= pos[:, None]) if causal else True)
    p = torch.softmax(logits.masked_fill(~seen, float("-inf")), dim=-1).nan_to_num(0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def tail_keep(s: int, bk: int) -> int:
    """The keys a dropped-last-key-block control keeps: all but the last
    (ragged or whole) block of ``bk`` keys, or where one block holds every
    key (S <= bk), all but the last min(bk, S // 4)."""
    return (s - 1) // bk * bk if s > bk else s - min(bk, s // 4)


def flash_work(b, hq, hkv, s, d, causal, size: int = 2):
    """(flops, bytes) the attention forward must do/move with ``size``-byte
    elements (bf16: 2): q.k and p.v over the (causal) pairs, each input read
    once and the output written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * size
    return flops, nbytes


def bound(flops, nbytes, peak_flops):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the work at ``peak_flops`` and the bytes at the HBM rate."""
    from repro_torch.hw.gpu_h100 import GPU_H100

    t_ops, t_bytes = flops / peak_flops, nbytes / GPU_H100.hbm_bandwidth
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def time_new_kernels(gen) -> dict:
    """The timing phase's part for the kernels' other inputs, each by graph
    replay beside its plain version (eager) and a yardstick the port never
    calls, with its bound: the f32 flash kernel at yi-6b's heads (S=1024,
    causal) and at the reduced shape (train_tiny's 8 x 64 tokens, 4/2 heads
    of 16), against SDPA in f32 through its efficient or math backend (its
    flash backend refuses f32) on key heads expanded to the query heads; the
    bf16 generic builds at D=16 and 96 against SDPA in bf16; the f32 matmul
    at 2048x4096x4096 and 256^3 (the tuner's pick) against torch.matmul in
    f32 with TF32 off. f32 bounds at the FP32 rate, bf16 at the tensor
    cores'. Returns {name: [entries]}."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops

    out = {"flash_attention_f32": [], "flash_attention": [], "matmul_f32": []}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (b, hq, hkv, s, d), dtype in (
            ("flash_attention_f32", (1, 32, 4, TIMED_S, 128), torch.float32),
            ("flash_attention_f32", (8, 4, 2, 64, 16), torch.float32),
            ("flash_attention", (1, 32, 4, TIMED_S, 16), torch.bfloat16),
            ("flash_attention", (1, 32, 4, TIMED_S, 96), torch.bfloat16)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        size = q.element_size()
        bq, bk = ops.tuned_flash_blocks(s, d, size)
        kern = lambda: fa.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
        if dtype == torch.float32:
            kx, vx = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))

            def lib_fn():
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
                    return sdpa(q, kx, vx, is_causal=True)
        else:
            lib_fn = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        k1, l1, l2, k2 = (graph_ms(f, iters=20) for f in (kern, lib_fn, lib_fn, kern))
        ms, lib = (k1 + k2) / 2, (l1 + l2) / 2
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, block_q=bq,
                                                         block_k=bk), iters=3, warmup=1)
        flops, nbytes = flash_work(b, hq, hkv, s, d, True, size)
        peak = GPU_H100.peak_flops_f32 if dtype == torch.float32 else GPU_H100.peak_flops_bf16
        bound_ms, by = bound(flops, nbytes, peak)
        out[name].append({"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": True,
                          "dtype": str(dtype), "blocks": [bq, bk], "ms": ms,
                          "plain_ms": plain, "library_ms": lib, "bound_ms": bound_ms,
                          "bound_by": by, "tflops": flops / ms / 1e9})
        log(f"timing {name} {dtype} B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal "
            f"blocks=({bq},{bk}), graph replay: kernel {ms:.4f} ms [{k1:.4f}, {k2:.4f}] "
            f"({flops / ms / 1e9:.2f} TFLOP/s), sdpa (yardstick) {lib:.4f} ms [{l1:.4f}, "
            f"{l2:.4f}] ({ms / lib:.2f}x); plain {plain:.4f} ms; bound {bound_ms:.4f} ms "
            f"by {by} ({nvidia_smi('name,power.limit')})")
    for m, n, k in F32_MM_TIMED:
        x = torch.randn((m, k), generator=gen, device="cuda")
        y = torch.randn((k, n), generator=gen, device="cuda")
        blocks = ops.tuned_matmul_blocks(m, n, k, 4)
        kern = lambda: ops.matmul(x, y)
        lib_fn = lambda: torch.matmul(x, y)
        k1, l1, l2, k2 = (graph_ms(f) for f in (kern, lib_fn, lib_fn, kern))
        ms, lib = (k1 + k2) / 2, (l1 + l2) / 2
        plain = cuda_ms(lambda: km.matmul_plain(x, y, *blocks[:3]), iters=3)
        flops, nbytes = matmul_work(m, n, k, 4)
        bound_ms, by = bound(flops, nbytes, GPU_H100.peak_flops_f32)
        out["matmul_f32"].append({"shape": [m, n, k], "blocks": list(blocks), "ms": ms,
                                  "plain_ms": plain, "library_ms": lib,
                                  "bound_ms": bound_ms, "bound_by": by,
                                  "tflops": flops / ms / 1e9})
        log(f"timing matmul_f32 {m}x{n}x{k} blocks={blocks}, graph replay: kernel "
            f"{ms:.4f} ms [{k1:.4f}, {k2:.4f}] ({flops / ms / 1e9:.2f} TFLOP/s), "
            f"torch.matmul f32, TF32 off (yardstick) {lib:.4f} ms [{l1:.4f}, {l2:.4f}] "
            f"({ms / lib:.2f}x); plain {plain:.4f} ms; bound {bound_ms:.4f} ms by {by} "
            f"({nvidia_smi('name,power.limit')})")
    return out


def nvidia_smi(query: str) -> str:
    """First line of ``nvidia-smi --query-gpu=<query>`` (csv, no header)."""
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


SASS_WORDS = ("HGMMA", "UTMALDG", "HMMA", "WARPGROUP.DEPBAR", "FFMA", "LDL", "STL")


def sass_counts(lib):
    """wgmma (HGMMA), tensor-map TMA load (UTMALDG), mma.sync (HMMA),
    wgmma-wait (WARPGROUP.DEPBAR), FFMA and local-memory (LDL, STL)
    instruction counts in the SASS of the library ``lib``, from the
    toolkit's cuobjdump (or the copy Triton ships): (the library's totals,
    the counts per kernel function by its mangled name)."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tools = [Path(CUDA_HOME) / "bin" / "cuobjdump"] if CUDA_HOME else []
    tools.append(shutil.which("cuobjdump"))
    try:
        import triton

        tools.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    tool = next((str(t) for t in tools if t and Path(t).exists()), None)
    if tool is None:
        fail("no cuobjdump to read the kernels' SASS")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[:300]}")
    per_fn = {}
    for part in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        name, body = part.split("\n", 1)
        per_fn[name.strip()] = {w: body.count(w) for w in SASS_WORDS}
    return {w: out.stdout.count(w) for w in SASS_WORDS}, per_fn


def check_flash(cases, qkv, rtol: float = KERNEL_RTOL) -> float:
    """Hold the flash kernel against its plain version (relative limit
    ``rtol``) and the f32 oracle at each (B, Hq, Hkv, S, D, causal), with the
    blocks the main path picks; fail on an element outside a limit. Logs
    where the worst element is and how far the plain version itself is from
    the oracle. Returns max |kernel - plain|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    max_err = 0.0
    for b, hq, hkv, s, d, causal in cases:
        q, k, v = qkv(b, hq, hkv, s, d)
        bq, bk = ops.tuned_flash_blocks(s, d, 2)
        got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
        oracle = ref.attention(q, k, v, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        bad, worst = outside(got, want, rtol, KERNEL_ATOL_RMS)
        bad_o, worst_o = outside(got, oracle, ORACLE_RTOL, ORACLE_ATOL_RMS)
        _, plain_o = outside(want, oracle, ORACLE_RTOL, ORACLE_ATOL_RMS)
        limit = rtol * want.float().abs() + KERNEL_ATOL_RMS * want.float().pow(2).mean().sqrt()
        at = int(((got.float() - want.float()).abs() / limit).argmax())
        head, row = divmod(at // d, s)
        line = (f"kernel B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} "
                f"blocks=({bq},{bk}): max|kernel-plain|={err:.3e} "
                f"rms(plain)={float(want.float().pow(2).mean().sqrt()):.3e}, "
                f"{bad} outside {rtol:.4g}*|plain| + {KERNEL_ATOL_RMS}*rms, worst at "
                f"{worst:.3f} of the limit (head {head}, row {row}: kernel "
                f"{float(got.flatten()[at]):.5f}, plain {float(want.flatten()[at]):.5f}, "
                f"oracle {float(oracle.flatten()[at]):.5f}); oracle: {bad_o} outside, worst "
                f"at {worst_o:.3f} (the plain version's own worst {plain_o:.3f})")
        keep = tail_keep(s, bk)
        if s % bk and keep < s:
            dropped = drop_tail(q, k, v, causal, keep)
            n_drop, worst_drop = outside(dropped, want, rtol, KERNEL_ATOL_RMS)
            line += (f"; a dropped tail tile ({s - keep} of {s} keys) would give "
                     f"max err {float((dropped.float() - want.float()).abs().max()):.3e}, "
                     f"{n_drop} outside, worst at {worst_drop:.1f} of the limit")
            # a tail of 5% of the keys or more must not slip through
            if n_drop == 0 and (s - keep) * 20 >= s:
                fail(f"the kernel limit would miss a dropped tail tile at S={s}")
        if d not in fa.HEAD_DIMS:
            # a generic build (the head dim at run time): a kernel that
            # stored 8 columns too few would leave the last 8 at zero
            short = got.clone()
            short[..., d - 8:] = 0
            n_short, worst_short = outside(short, want, rtol, KERNEL_ATOL_RMS)
            line += (f"; a kernel that dropped the last 8 columns ({d - 8}-{d - 1} zero) "
                     f"would give {n_short} outside, worst at {worst_short:.1f} of the limit")
            if n_short == 0:
                fail(f"the kernel limit would miss dropped last columns at S={s} D={d}")
        if d % 64 and d > 64:
            # a head dim padded to whole 64-column atoms: a kernel that lost
            # the second atom would leave columns 64.. of the output at zero
            lost = got.clone()
            lost[..., 64:] = 0
            n_lost, worst_lost = outside(lost, want, rtol, KERNEL_ATOL_RMS)
            line += (f"; a kernel that lost the second column atom (columns 64-{d - 1} "
                     f"zero) would give {n_lost} outside, worst at {worst_lost:.1f} of "
                     f"the limit")
            if n_lost == 0:
                fail(f"the kernel limit would miss a lost second column atom at S={s}")
        log(line)
        if bad or bad_o or not torch.isfinite(got).all():
            fail(f"flash kernel disagrees at Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}")
    return max_err


def matmul_work(m, n, k, size: int = 2):
    """(flops, bytes) of C = A @ B with ``size``-byte elements (bf16: 2):
    each input read once, C written once."""
    return 2 * m * n * k, size * (m * k + k * n + m * n)


def f32_outside(got, want, atol: float, rtol: float):
    """(elements outside |got - want| <= atol + rtol*|want|, max share of
    the limit): the reference's assert_allclose."""
    err = (got.float() - want.float()).abs()
    ratio = err / (atol + rtol * want.float().abs())
    return int((ratio > 1).sum()), float(ratio.max())


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even), as a tensor
    core's TF32 product reads it."""
    import torch

    i = x.float().contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


def check_flash_f32(cases, gen, control: bool = True) -> float:
    """Hold the f32 flash kernel against its plain version and the f32
    oracle at each (B, Hq, Hkv, S, D, causal), at every block pair it is
    built for, within the reference's f32 limit; with ``control``, fail
    unless the limit flags the plain version run on TF32-rounded inputs.
    Returns max |kernel - plain|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    max_err = 0.0
    for b, hq, hkv, s, d, causal in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        oracle = ref.attention(q, k, v, causal=causal)
        blocks = [(bq, bk) for bq in fa.BLOCKS for bk in fa.BLOCKS
                  if fa.built(bq, bk, d, torch.float32)]
        parts, worst, n_tf = [], 0.0, None
        for bq, bk in blocks:
            got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
            bad, w = f32_outside(got, want, F32_FLASH_ATOL, F32_FLASH_RTOL)
            bad_o, w_o = f32_outside(got, oracle, F32_FLASH_ATOL, F32_FLASH_RTOL)
            max_err = max(max_err, float((got - want).abs().max()))
            worst = max(worst, w, w_o)
            parts.append(f"({bq},{bk}) {bad}/{bad_o} outside, worst {w:.3f}/{w_o:.3f}")
            if n_tf is None:
                tf = fa.flash_attention_plain(tf32(q), tf32(k), tf32(v), causal=causal,
                                              block_q=bq, block_k=bk)
                n_tf, w_tf = f32_outside(tf, want, F32_FLASH_ATOL, F32_FLASH_RTOL)
            if bad or bad_o or got.dtype != torch.float32 or not torch.isfinite(got).all():
                log(f"kernel f32 B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: "
                    + "; ".join(parts))
                fail(f"the f32 flash kernel disagrees at B={b} Hq={hq} Hkv={hkv} S={s} "
                     f"D={d} causal={causal} blocks=({bq},{bk})")
        log(f"kernel f32 B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}, limit "
            f"{F32_FLASH_ATOL} + {F32_FLASH_RTOL}*|want| (vs plain / vs oracle): "
            + "; ".join(parts) + f"; TF32-rounded inputs (plain): {n_tf} outside, worst "
            f"{w_tf:.1f} of the limit")
        if control and n_tf == 0:
            fail(f"the f32 flash limit would miss TF32 products at S={s} D={d}")
    return max_err


def check_matmul_f32(shapes, gen) -> float:
    """Hold the f32 matmul kernel against its plain version at each shape,
    at every configuration of the sm90 space at 4 bytes that it is built
    for (the tuner's pick among them, which must be one), and ops.matmul
    (the pick) against the f32 oracle, within the reference's f32 limit;
    fail unless the limit flags the plain version on TF32-rounded inputs.
    Returns max |kernel - plain|."""
    import torch
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops, ref

    max_err = 0.0
    for m, n, k in shapes:
        cfgs = [c for c in MatmulSpace(m, n, k, 4, target_kind="sm90").enumerate(None)
                if km.built(c["bm"], c["bn"], c["bk"], c["double_buffer"], torch.float32)]
        pick = dict(zip(("bm", "bn", "bk", "double_buffer"), ops.tuned_matmul_blocks(m, n, k, 4)))
        if pick not in cfgs:
            fail(f"the f32 pick {pick} at {m}x{n}x{k} is not a built configuration")
        x = torch.randn((m, k), generator=gen, device="cuda")
        y = torch.randn((k, n), generator=gen, device="cuda")
        atol = F32_MM_TOL * k ** 0.5
        got = ops.matmul(x, y)
        bad_o, w_o = f32_outside(got, ref.matmul(x, y), atol, F32_MM_TOL)
        worst, err = 0.0, 0.0
        for c in cfgs:
            got = km.matmul(x, y, **c)
            torch.cuda.synchronize()
            want = km.matmul_plain(x, y, c["bm"], c["bn"], c["bk"])
            bad, w = f32_outside(got, want, atol, F32_MM_TOL)
            worst, err = max(worst, w), max(err, float((got - want).abs().max()))
            if bad or got.dtype != torch.float32 or not torch.isfinite(got).all():
                fail(f"the f32 matmul kernel disagrees at {m}x{n}x{k} {c}: {bad} outside")
        max_err = max(max_err, err)
        tf = km.matmul_plain(tf32(x), tf32(y), pick["bm"], pick["bn"], pick["bk"])
        n_tf, w_tf = f32_outside(tf, km.matmul_plain(x, y, pick["bm"], pick["bn"], pick["bk"]),
                                 atol, F32_MM_TOL)
        log(f"matmul f32 {m}x{n}x{k}: {len(cfgs)} configs, 0 outside {F32_MM_TOL}*sqrt(K) "
            f"+ {F32_MM_TOL}*|plain|, worst {worst:.3f}, max err {err:.3e}; the pick {pick} "
            f"vs the oracle {bad_o} outside, worst {w_o:.3f}; TF32-rounded inputs (plain): "
            f"{n_tf} outside, worst {w_tf:.1f} of the limit")
        if bad_o:
            fail(f"the f32 matmul kernel disagrees with the oracle at {m}x{n}x{k}")
        if n_tf == 0:
            fail(f"the f32 matmul limit would miss TF32 products at {m}x{n}x{k}")
    return max_err


def dropped_tails(x, y, bm, bn, bk, want):
    """What a kernel that dropped the last (ragged) tile of rows, of
    columns or the last K slice at tiles (bm, bn, bk) would give, beside
    ``want`` (the plain version): {name: tensor}."""
    import torch
    from repro_torch.kernels import matmul as km

    m, k = x.shape
    n = y.shape[1]
    rows, cols = want.clone(), want.clone()
    rows[(m - 1) // bm * bm:] = 0
    cols[:, (n - 1) // bn * bn:] = 0
    k0 = (k - 1) // bk * bk
    kslice = (km.k_slices(x[:, :k0], y[:k0], bk) if k0 else torch.zeros_like(want))
    return {"last rows": rows, "last columns": cols, "last K slice": kslice}


def check_ragged_matmul(gen, kinds=None, timed: bool = True) -> dict:
    """The matmul kernels ``kinds`` ((dtype, launch-count name) pairs; by
    default bf16's and f32's) at the shapes no built tile divides
    (``RAGGED_MM_SHAPES``): every configuration of the shape's sm90 space
    (f32: those built) against the plain version at MM_RTOL / MM_ATOL_RMS
    (f16 at F16_MM_RTOL / F16_MM_ATOL_RMS; f32 also at the reference's f32
    limit), the tuner's pick through ops.matmul against the f32 oracle, and
    controls at the pick's tiles that the limit must flag; then, with
    ``timed``, each kernel at the pick of ``RAGGED_MM_TIMED`` by graph
    replay, beside torch.matmul (its yardstick), the plain version and the
    bound. Returns {"launches": {name: n}, "max_abs_err": {name: x},
    "timed": {name: [rows]}, "s": seconds}; the launches are the checks'."""
    import torch
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops, ref

    t0 = time.perf_counter()
    kinds = kinds or ((torch.bfloat16, "matmul"), (torch.float32, "matmul_f32"))
    out = {"launches": {name: 0 for _, name in kinds},
           "max_abs_err": {name: 0.0 for _, name in kinds},
           "timed": {name: [] for _, name in kinds}}
    for dtype, name in kinds:
        size = torch.empty((), dtype=dtype).element_size()
        rtol, atol_rms = ((F16_MM_RTOL, F16_MM_ATOL_RMS) if dtype == torch.float16
                          else (MM_RTOL, MM_ATOL_RMS))
        for m, n, k in RAGGED_MM_SHAPES:
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            y = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            cfgs = [c for c in MatmulSpace(m, n, k, size, target_kind="sm90").enumerate(None)
                    if km.built(c["bm"], c["bn"], c["bk"], c["double_buffer"], dtype)]
            pick = ops.tuned_matmul_blocks(m, n, k, size)
            if dict(zip(("bm", "bn", "bk", "double_buffer"), pick)) not in cfgs:
                fail(f"the {dtype} pick {pick} at {m}x{n}x{k} is not a built configuration")
            worst, err = 0.0, 0.0
            ops.reset_launch_counts()
            for c in cfgs:
                got = km.matmul(x, y, **c)
                torch.cuda.synchronize()
                want = km.matmul_plain(x, y, c["bm"], c["bn"], c["bk"])
                bad, w = outside(got, want, rtol, atol_rms)
                if dtype == torch.float32:
                    bad32, w32 = f32_outside(got, want, F32_MM_TOL * k ** 0.5, F32_MM_TOL)
                    bad, w = bad + bad32, max(w, w32)
                worst, err = max(worst, w), max(err, float((got.float() - want.float())
                                                           .abs().max()))
                if bad or got.shape != (m, n) or not torch.isfinite(got).all():
                    fail(f"the {dtype} matmul kernel disagrees at {m}x{n}x{k} {c}: "
                         f"{bad} outside")
            got = ops.matmul(x, y)
            torch.cuda.synchronize()
            bad_o, w_o = outside(got, ref.matmul(x, y), rtol, atol_rms)
            out["launches"][name] += ops.launch_counts()[name]
            if ops.launch_counts()[name] != len(cfgs) + 1:
                fail(f"{name} at {m}x{n}x{k}: {ops.launch_counts()[name]} launches for "
                     f"{len(cfgs)} configurations and the pick")
            out["max_abs_err"][name] = max(out["max_abs_err"][name], err)
            want = km.matmul_plain(x, y, *pick[:3])
            controls = []
            for what, dropped in dropped_tails(x, y, *pick[:3], want).items():
                n_drop, w_drop = outside(dropped, want, rtol, atol_rms)
                controls.append(f"dropped {what} {n_drop} outside (worst {w_drop:.1f}x)")
                if n_drop == 0:
                    fail(f"the matmul limit would miss a kernel that dropped the {what} "
                         f"at {m}x{n}x{k} {dtype} tiles {pick[:3]}")
            log(f"ragged {name} {m}x{n}x{k}: {len(cfgs)} configs, 0 outside, worst "
                f"{worst:.3f}, max err {err:.3e}; pick {pick} vs the oracle {bad_o} "
                f"outside (worst {w_o:.3f}); " + "; ".join(controls))
            if bad_o:
                fail(f"the {dtype} matmul kernel disagrees with the oracle at {m}x{n}x{k}")
        peak = GPU_H100.peak_flops_f32 if dtype == torch.float32 else GPU_H100.peak_flops_bf16
        for m, n, k in (RAGGED_MM_TIMED if timed else ()):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            y = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            blocks = ops.tuned_matmul_blocks(m, n, k, size)
            kern = lambda: ops.matmul(x, y)
            lib_fn = lambda: torch.matmul(x, y)
            k1, l1, l2, k2 = (graph_ms(f) for f in (kern, lib_fn, lib_fn, kern))
            ms, lib = (k1 + k2) / 2, (l1 + l2) / 2
            plain = cuda_ms(lambda: km.matmul_plain(x, y, *blocks[:3]), iters=3)
            flops, nbytes = matmul_work(m, n, k, size)
            bound_ms, by = bound(flops, nbytes, peak)
            out["timed"][name].append({
                "shape": [m, n, k], "blocks": list(blocks), "ms": ms, "plain_ms": plain,
                "library_ms": lib, "bound_ms": bound_ms, "bound_by": by,
                "tiles": -(-m // blocks[0]) * -(-n // blocks[1])})
            log(f"timing ragged {name} {m}x{n}x{k} blocks={blocks} "
                f"({out['timed'][name][-1]['tiles']} output tiles), graph replay: kernel "
                f"{ms:.4f} ms [{k1:.4f}, {k2:.4f}], torch.matmul (yardstick) {lib:.4f} ms "
                f"[{l1:.4f}, {l2:.4f}] ({ms / lib:.2f}x); plain {plain:.4f} ms; bound "
                f"{bound_ms:.4f} ms by {by} ({nvidia_smi('name,power.limit')})")
    out["s"] = time.perf_counter() - t0
    log(f"ragged matmul checks and timing: {out['launches']} check launches, "
        f"{out['s']:.1f} s")
    return out


def check_flash_pairs(cases, gen, dtype) -> float:
    """Hold the flash kernel in ``dtype`` (bf16 or f16) against its plain
    version at each (B, Hq, Hkv, S, D, causal) at every block pair built
    for it, and at the picked blocks against the f32 oracle; fail on an
    element outside a limit. bf16: KERNEL_RTOL*|plain| +
    KERNEL_ATOL_RMS*rms(plain), the oracle at ORACLE_RTOL / ORACLE_ATOL_RMS;
    f16: F16_RTOL*|want| + F16_FLIP*softmax(.)|v| against both. Controls at
    the picked blocks that the limit must flag: a dropped tail tile (a tail
    of 5% of the keys or more), and at a head dim past 64 columns a kernel
    that lost its last 64-column atom (columns 64*(ceil(D/64)-1)..D-1
    zero). Returns max |kernel - plain|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    max_err = 0.0
    for b, hq, hkv, s, d, causal in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        if dtype == torch.float16:
            # the floor: one f16 ulp of every p, times |v|
            rtol, atol_rms, oracle_limit = F16_RTOL, 0.0, (F16_RTOL, 0.0)
            floor = F16_FLIP * ref.attention(q.float(), k.float(), v.float().abs(),
                                             causal=causal)
        else:
            rtol, atol_rms, floor = KERNEL_RTOL, KERNEL_ATOL_RMS, None
            oracle_limit = (ORACLE_RTOL, ORACLE_ATOL_RMS)
        pairs = [(bq, bk) for bq in fa.BLOCKS for bk in fa.BLOCKS if fa.built(bq, bk, d, dtype)]
        pick = ops.tuned_flash_blocks(s, d, 2)
        if pick not in pairs:
            fail(f"the {dtype} pick {pick} at S={s} D={d} is not a built block pair")
        parts, worst = [], 0.0
        for bq, bk in pairs:
            got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
            bad, w = outside(got, want, rtol, atol_rms, floor)
            err = float((got.float() - want.float()).abs().max())
            max_err, worst = max(max_err, err), max(worst, w)
            parts.append(f"({bq},{bk}) {bad} outside, worst {w:.3f}, max err {err:.3e}")
            if bad or got.dtype != dtype or not torch.isfinite(got).all():
                fail(f"the {dtype} flash kernel disagrees at Hq={hq} Hkv={hkv} S={s} D={d} "
                     f"causal={causal} blocks=({bq},{bk}): " + "; ".join(parts))
            if (bq, bk) == pick:
                at_pick = (got, want)
        got, want = at_pick
        bad_o, w_o = outside(got, ref.attention(q, k, v, causal=causal), *oracle_limit, floor)
        line = (f"kernel {dtype} B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: "
                + "; ".join(parts) + f"; pick {pick} vs the oracle {bad_o} outside, worst "
                f"{w_o:.3f}")
        keep = tail_keep(s, pick[1])
        if s % pick[1] and keep < s:
            n_drop, w_drop = outside(drop_tail(q, k, v, causal, keep), want, rtol, atol_rms,
                                     floor)
            line += f"; dropped tail tile ({s - keep} keys) {n_drop} outside ({w_drop:.1f}x)"
            if n_drop == 0 and (s - keep) * 20 >= s:
                fail(f"the {dtype} limit would miss a dropped tail tile at S={s} D={d}")
        if d > 64:
            last = (fa.padded_head_dim(d) - 64)
            lost = got.clone()
            lost[..., last:] = 0
            n_lost, w_lost = outside(lost, want, rtol, atol_rms, floor)
            line += (f"; lost last atom (columns {last}-{d - 1} zero) {n_lost} outside "
                     f"({w_lost:.1f}x)")
            if n_lost == 0:
                fail(f"the {dtype} limit would miss a lost last column atom at S={s} D={d}")
        log(line)
        if bad_o:
            fail(f"the {dtype} flash kernel disagrees with the oracle at Hq={hq} Hkv={hkv} "
                 f"S={s} D={d} causal={causal}")
    return max_err


def check_f16_matmul(gen) -> float:
    """The f16 matmul kernel at every built configuration at MM_TIMED (a
    yi-6b projection) against its plain version at F16_MM_RTOL /
    F16_MM_ATOL_RMS, the pick through ops.matmul against the f32 oracle,
    and a dropped last K block per bk that the limit must flag; then both
    ragged phases' shapes (``check_ragged_matmul``'s, in f16). Returns max
    |kernel - plain|."""
    import torch
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops, ref

    m, n, k = MM_TIMED
    x = torch.randn((m, k), generator=gen, device="cuda").half()
    y = torch.randn((k, n), generator=gen, device="cuda").half()
    cfgs = list(MatmulSpace(m, n, k, 2, target_kind="sm90").enumerate(None))
    if not all(km.built(c["bm"], c["bn"], c["bk"], c["double_buffer"], torch.float16)
               for c in cfgs):
        fail("an sm90 configuration is not built in f16")
    bad_o, w_o = outside(ops.matmul(x, y), ref.matmul(x, y), F16_MM_RTOL, F16_MM_ATOL_RMS)
    line, max_err = [f"matmul f16 {m}x{n}x{k}: pick vs the oracle {bad_o} outside "
                     f"(worst {w_o:.3f})"], 0.0
    for bk in sorted({c["bk"] for c in cfgs}):
        group = [c for c in cfgs if c["bk"] == bk]
        want = km.matmul_plain(x, y, group[0]["bm"], group[0]["bn"], bk)
        worst, err = 0.0, 0.0
        for c in group:
            got = km.matmul(x, y, **c)
            torch.cuda.synchronize()
            bad, w = outside(got, want, F16_MM_RTOL, F16_MM_ATOL_RMS)
            worst, err = max(worst, w), max(err, float((got.float() - want.float()).abs().max()))
            if bad or got.dtype != torch.float16 or not torch.isfinite(got).all():
                fail(f"the f16 matmul kernel disagrees at {m}x{n}x{k} {c}: {bad} outside")
        max_err = max(max_err, err)
        dropped = km.matmul_plain(x[:, :k - bk], y[:k - bk], group[0]["bm"], group[0]["bn"], bk)
        n_drop, w_drop = outside(dropped, want, F16_MM_RTOL, F16_MM_ATOL_RMS)
        line.append(f"bk={bk}: {len(group)} configs, 0 outside, worst {worst:.3f}, max err "
                    f"{err:.3e}; dropped last K block {n_drop} outside ({w_drop:.1f}x)")
        if n_drop == 0:
            fail(f"the f16 matmul limit would miss a dropped last K block at bk={bk}")
    log("; ".join(line))
    if bad_o:
        fail(f"the f16 matmul kernel disagrees with the oracle at {m}x{n}x{k}")
    ragged = check_ragged_matmul(gen, kinds=((torch.float16, "matmul_f16"),), timed=False)
    return max(max_err, ragged["max_abs_err"]["matmul_f16"])


def time_f16_wide(gen) -> dict:
    """The f16 kernels and the wide builds timed by graph replay, in turns,
    beside a yardstick the port never calls, the plain version (eager) and
    the bound at the tensor cores' 16-bit rate: f16 flash at yi-6b's heads
    (S=TIMED_S, causal) beside the bf16 kernel on the same values and SDPA
    in f16; the f16 matmul at MM_TIMED beside the bf16 kernel and
    torch.matmul in f16; each WIDE_HEADS shape at S=TIMED_S, causal, in bf16
    and f16, against SDPA in the same dtype. Returns {name: [rows]}."""
    import torch
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops

    card = nvidia_smi("name,power.limit")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"flash_attention_f16": [], "matmul_f16": [], "flash_attention_wide": []}
    shapes = [("flash_attention_f16", (1, 32, 4, TIMED_S, 128), torch.float16, "yi-6b's heads")]
    shapes += [("flash_attention_wide", (1, hq, hkv, TIMED_S, d), dtype, what)
               for hq, hkv, d, what in WIDE_HEADS for dtype in (torch.bfloat16, torch.float16)]
    for name, (b, hq, hkv, s, d), dtype, what in shapes:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        bq, bk = ops.tuned_flash_blocks(s, d, 2)
        kern = lambda: fa.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
        lib_fn = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        row = {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": True, "model": what,
               "dtype": str(dtype), "blocks": [bq, bk]}
        if name == "flash_attention_f16":
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            bf16 = lambda: fa.flash_attention(qb, kb, vb, causal=True, block_q=bq, block_k=bk)
            k1, b1, l1, l2, b2, k2 = (graph_ms(f, iters=20) for f in (kern, bf16, lib_fn,
                                                                      lib_fn, bf16, kern))
            row["bf16_ms"], row["bf16_turns_ms"] = (b1 + b2) / 2, [b1, b2]
        else:
            k1, l1, l2, k2 = (graph_ms(f, iters=20) for f in (kern, lib_fn, lib_fn, kern))
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, block_q=bq,
                                                         block_k=bk), iters=3, warmup=1)
        flops, nbytes = flash_work(b, hq, hkv, s, d, True, 2)
        bound_ms, by = bound(flops, nbytes, GPU_H100.peak_flops_bf16)
        ms, lib = (k1 + k2) / 2, (l1 + l2) / 2
        row.update({"ms": ms, "turns_ms": [k1, k2], "plain_ms": plain, "library_ms": lib,
                    "bound_ms": bound_ms, "bound_by": by, "of_bound": ms / bound_ms,
                    "tflops": flops / ms / 1e9, "card": card})
        out[name].append(row)
        log(f"timing {name} {dtype} {what} B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal "
            f"blocks=({bq},{bk}), graph replay: kernel {ms:.4f} ms [{k1:.4f}, {k2:.4f}] "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {ms / bound_ms:.2f}x the bound)"
            + (f", bf16 kernel {row['bf16_ms']:.4f} ms" if "bf16_ms" in row else "")
            + f", sdpa (yardstick) {lib:.4f} ms [{l1:.4f}, {l2:.4f}] ({ms / lib:.2f}x); plain "
            f"{plain:.4f} ms; bound {bound_ms:.4f} ms by {by} ({card})")
    m, n, k = MM_TIMED
    x = torch.randn((m, k), generator=gen, device="cuda").half()
    y = torch.randn((k, n), generator=gen, device="cuda").half()
    xb, yb = x.bfloat16(), y.bfloat16()
    blocks = ops.tuned_matmul_blocks(m, n, k, 2)
    kern, bf16 = lambda: ops.matmul(x, y), lambda: ops.matmul(xb, yb)
    lib_fn = lambda: torch.matmul(x, y)
    k1, b1, l1, l2, b2, k2 = (graph_ms(f) for f in (kern, bf16, lib_fn, lib_fn, bf16, kern))
    plain = cuda_ms(lambda: km.matmul_plain(x, y, *blocks[:3]), iters=3)
    flops, nbytes = matmul_work(m, n, k, 2)
    bound_ms, by = bound(flops, nbytes, GPU_H100.peak_flops_bf16)
    ms, lib = (k1 + k2) / 2, (l1 + l2) / 2
    out["matmul_f16"].append({"shape": [m, n, k], "blocks": list(blocks), "ms": ms,
                              "turns_ms": [k1, k2], "bf16_ms": (b1 + b2) / 2,
                              "bf16_turns_ms": [b1, b2], "plain_ms": plain, "library_ms": lib,
                              "bound_ms": bound_ms, "bound_by": by, "of_bound": ms / bound_ms,
                              "tflops": flops / ms / 1e9, "card": card})
    log(f"timing matmul_f16 {m}x{n}x{k} blocks={blocks}, graph replay: kernel {ms:.4f} ms "
        f"[{k1:.4f}, {k2:.4f}] ({flops / ms / 1e9:.1f} TFLOP/s), bf16 kernel "
        f"{(b1 + b2) / 2:.4f} ms [{b1:.4f}, {b2:.4f}], torch.matmul f16 (yardstick) "
        f"{lib:.4f} ms [{l1:.4f}, {l2:.4f}] ({ms / lib:.2f}x); plain {plain:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {by} ({card})")
    return out


def f16_wide_phase(gen) -> dict:
    """The float16 kernels and the head dims past 128, after the ragged
    matmul checks (its own generator, so every other phase's draws stay):
    the bf16 builds' outputs against the parent's digests; the f16 flash
    kernel at yi-6b's lengths (32/4 heads of 128, causal and not) and at
    D=64, at every built block pair; the f16 matmul (``check_f16_matmul``);
    the wide builds at WIDE_HEADS, S in WIDE_S causal and
    WIDE_NONCAUSAL_S non-causal, in bf16 and f16, at every block pair built
    for them; then the main path counted (``ops.attention`` at each wide
    shape in both types and ``ops.matmul`` in f16 at yi-6b's shapes, no
    blocks given, counts reset just before) and the timing
    (``time_f16_wide``). Returns its summary."""
    import torch
    from repro_torch.benchmarks import flash_ab
    from repro_torch.benchmarks.topk_ratio import YI6B_SHAPES
    from repro_torch.kernels import build, ops

    t_phase = time.perf_counter()
    digests = {kern: flash_ab.digests(kern, build.load(kern)) for kern in ("flash_attention",
                                                                           "matmul")}
    same = {kern: sum(PARENT_BF16_DIGESTS.get(kern, {}).get(case) == sha
                      for case, sha in d.items()) for kern, d in digests.items()}
    log(f"bf16 builds against the parent's output digests: {same} of "
        f"{ {kern: len(d) for kern, d in digests.items()} } bit-equal; this build's "
        f"{json.dumps(digests)}")
    if any(same[kern] != len(digests[kern]) for kern in digests):
        fail(f"a bf16 build's output differs from the parent's: {same}")

    log(f"kernel f16: limit {F16_RTOL:.4g}*|want| + {F16_FLIP:.4g}*softmax(scale q k^T)|v| "
        f"against the plain version and the f32 oracle; every built block pair")
    f16_cases = ([(1, 32, 4, s, 128, c) for s in sorted(set(KERNEL_S) | set(PROMPT_LENS))
                  for c in (True, False)] + [(1, 8, 2, 300, 64, True), (1, 8, 2, 77, 64, False)])
    err_f16 = check_flash_pairs(f16_cases, gen, torch.float16)
    t_f16 = time.perf_counter() - t_phase
    err_mm16 = check_f16_matmul(gen)
    t_mm = time.perf_counter() - t_phase - t_f16
    wide_cases = [(1, hq, hkv, s, d, True) for hq, hkv, d, _ in WIDE_HEADS for s in WIDE_S]
    wide_cases += [(1, hq, hkv, WIDE_NONCAUSAL_S, d, False) for hq, hkv, d, _ in WIDE_HEADS]
    log("kernel at head dims past 128: " + "; ".join(f"{hq}/{hkv} heads of {d}: {what}"
                                                     for hq, hkv, d, what in WIDE_HEADS))
    err_wide = {"bfloat16": check_flash_pairs(wide_cases, gen, torch.bfloat16),
                "float16": check_flash_pairs(wide_cases, gen, torch.float16)}
    t_wide = time.perf_counter() - t_phase - t_f16 - t_mm

    # the main path, counted: the entry points a user calls, blocks picked
    ops.reset_launch_counts()
    for hq, hkv, d, _ in WIDE_HEADS:
        for dtype in (torch.bfloat16, torch.float16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((1, hq, TIMED_S, d), (1, hkv, TIMED_S, d),
                                     (1, hkv, TIMED_S, d)))
            if not torch.isfinite(ops.attention(q, k, v, causal=True)).all():
                fail(f"ops.attention {dtype} at {hq}/{hkv} heads of {d}: non-finite output")
    for m, n, k in YI6B_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").half()
        y = torch.randn((k, n), generator=gen, device="cuda").half()
        if ops.matmul(x, y).shape != (m, n):
            fail(f"ops.matmul f16 at {m}x{n}x{k}: wrong shape")
    torch.cuda.synchronize()
    counted = ops.launch_counts()
    log(f"f16-wide main path (ops.attention at the wide shapes in bf16 and f16, ops.matmul "
        f"in f16 at yi-6b's shapes): launches {counted}")
    want = {"flash_attention": len(WIDE_HEADS), "flash_attention_f16": len(WIDE_HEADS),
            "matmul_f16": len(YI6B_SHAPES)}
    if {key: counted[key] for key in want} != want or counted["matmul"] or counted["matmul_f32"]:
        fail(f"f16-wide main path: launches {counted}, want {want}")
    del x, y, q, k, v
    timing = time_f16_wide(gen)
    summary = {"max_abs_err": {"flash_attention_f16": err_f16, "matmul_f16": err_mm16,
                               "flash_attention_wide": err_wide},
               "launches": {"flash_attention_wide": counted["flash_attention"]
                            + counted["flash_attention_f16"],
                            "matmul_f16": counted["matmul_f16"]},
               "timing": timing, "digests_equal": same,
               "s": {"f16_flash": t_f16, "f16_matmul": t_mm, "wide": t_wide,
                     "phase": time.perf_counter() - t_phase}}
    log(f"f16-wide: {summary['s']} s, max errors {summary['max_abs_err']}")
    torch.cuda.empty_cache()
    return summary


def main() -> None:
    import numpy as np
    import torch

    t_smoke = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are missing under {SRC}")
    sys.path.insert(0, str(SRC))

    from repro_torch.benchmarks.topk_ratio import YI6B_SHAPES
    from repro_torch.configs.base import get_config
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as km
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    # every f32 product of the smoke in true f32: the plain versions, the
    # oracles and the yardsticks, as the f32 kernels are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    log(f"device {props.name}: {props.multi_processor_count} SMs "
        f"(target {GPU_H100.name}: {GPU_H100.num_cores}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {secs} ({time.perf_counter() - t0:.1f} s wall)")
    for name in secs:
        text = build.log_path(name).read_text() if build.log_path(name).exists() else ""
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and any(
                      w.isdigit() and int(w) > 0 and nxt == "bytes"
                      and "spill" in after for w, nxt, after in zip(
                          line.split(), line.split()[1:], line.split()[2:]))]
        if regs:
            log(f"build {name}: {len(regs)} kernels, registers max {max(regs)} "
                f"min {min(regs)}; lines with spills: {spills[:3] or 'none'}")
        if spills:
            fail(f"the {name} kernel spills: {spills[:3]}")
        if "setmaxnreg ignored" in text:
            fail(f"ptxas ignored setmaxnreg in {name}")
        # ptxas serializes wgmma where it cannot keep the pipeline (C7515)
        serialized = [line.strip() for line in text.splitlines() if "C7515" in line]
        if serialized:
            fail(f"ptxas serialized wgmma in {name}: {serialized[:2]}")

    def registers(name, kernel, fmt, elem=None):
        """{instantiation: registers} of ``kernel`` in library ``name``; for
        a 16-bit kernel, those of element type ``elem`` (its mangled name)."""
        text = build.log_path(name).read_text()
        found = {}
        for entry, used in zip(re.findall(r"Compiling entry function '([^']+)'", text),
                               re.findall(r"Used (\d+) registers", text)):
            m = re.search(kernel + r"I(?:\d+(__nv_bfloat16|__half))?"
                          r"Li(\d+)ELi(\d+)ELi(\d+)E(?:Li(\d+)E)?", entry)
            if m and m.group(1) == elem:
                found[fmt.format(*m.groups()[1:])] = int(used)
        return found

    pad = fa.padded_head_dim
    narrow = ({f"bq{bq}_bk{bk}_d{d}_dp{pad(d)}" for bq in fa.BLOCKS for bk in fa.BLOCKS
               for d in fa.HEAD_DIMS}
              | {f"bq{bq}_bk{bk}_d0_dp{dp}" for bq in fa.BLOCKS for bk in fa.BLOCKS
                 for dp in (64, 128)})
    wide = {f"bq{bq}_bk{bk}_d0_dp{dp}" for bq in fa.BLOCKS for bk in fa.BLOCKS
            for dp in (192, 256) if fa.built(bq, bk, dp, torch.bfloat16)}
    # (library, element type) -> the 16-bit flash instantiations it must hold
    want_16 = {("flash_attention", "__nv_bfloat16"): narrow,
               ("flash_attention_f16", "__half"): narrow,
               ("flash_attention_wide", "__nv_bfloat16"): wide,
               ("flash_attention_wide", "__half"): wide}
    regs_16 = {}
    for (lib, elem), want in want_16.items():
        regs_16[lib, elem] = registers(lib, "flash_fwd_wgmma_kernel", "bq{}_bk{}_d{}_dp{}",
                                       elem)
        if set(regs_16[lib, elem]) != want:
            fail(f"expected the {len(want)} {elem} flash instantiations {sorted(want)} in "
                 f"{lib}, found {sorted(regs_16[lib, elem])}")
    flash_regs = regs_16["flash_attention", "__nv_bfloat16"]
    log(f"build flash registers per instantiation (launch count; the consumer "
        f"warpgroups of BQ=128 raise theirs to 240 with setmaxnreg; d0 is the generic "
        f"build of its padded width dp, the head dim passed at run time): bf16 {flash_regs}; "
        f"f16 {regs_16['flash_attention_f16', '__half']}; wide bf16 "
        f"{regs_16['flash_attention_wide', '__nv_bfloat16']}, wide f16 "
        f"{regs_16['flash_attention_wide', '__half']}")
    flash32_regs = registers("flash_attention", "flash_fwd_f32_kernel", "bq{}_bk{}_dp{}")
    log(f"build f32 flash registers per instantiation (SIMT, BQ/8 warps): {flash32_regs}")
    want_flash32 = {f"bq{bq}_bk{bk}_dp{dp}" for bq in fa.BLOCKS for bk in fa.BLOCKS
                    for dp in fa.PADDED_WIDTHS if fa.built(bq, bk, dp, torch.float32)}
    if set(flash32_regs) != want_flash32:
        fail(f"expected the f32 flash instantiations {sorted(want_flash32)}, found "
             f"{sorted(flash32_regs)}")
    mm_configs = [(bm, bn, bk, db) for bm in km.BLOCKS["bm"] for bn in km.BLOCKS["bn"]
                  for bk in km.BLOCKS["bk"] for db in (False, True)]
    want_mm = sorted(f"bm{bm}_bn{bn}_bk{bk}_s{2 if db else 1}" for bm, bn, bk, db in mm_configs)
    mm_regs = registers("matmul", "matmul_wgmma_kernel", "bm{}_bn{}_bk{}_s{}", "__nv_bfloat16")
    mm16_regs = registers("matmul_f16", "matmul_wgmma_kernel", "bm{}_bn{}_bk{}_s{}", "__half")
    log(f"build matmul registers per instantiation (launch count; the consumer "
        f"warpgroups of bm=128 raise theirs to 240 with setmaxnreg): bf16 {mm_regs}; "
        f"f16 {mm16_regs}")
    if sorted(mm_regs) != want_mm or sorted(mm16_regs) != want_mm:
        fail(f"expected the {len(mm_configs)} matmul instantiations of {km.BLOCKS} in bf16 "
             f"and in f16, found {sorted(mm_regs)} and {sorted(mm16_regs)}")
    mm32_configs = [c for c in mm_configs if km.built(*c, torch.float32)]
    mm32_regs = registers("matmul", "matmul_f32_kernel", "bm{}_bn{}_bk{}_s{}")
    log(f"build f32 matmul registers per instantiation (SIMT, 256 threads): {mm32_regs}")
    if sorted(mm32_regs) != sorted(f"bm{bm}_bn{bn}_bk{bk}_s{2 if db else 1}"
                                   for bm, bn, bk, db in mm32_configs):
        fail(f"expected the {len(mm32_configs)} f32 matmul instantiations, found "
             f"{sorted(mm32_regs)}")
    lib_sass = {name: sass_counts(build.library_path(name)) for name in build.SOURCES}
    sass, sass_fn = lib_sass["flash_attention"]
    mm_sass, mm_sass_fn = lib_sass["matmul"]
    log("build SASS: " + ", ".join(f"{name} {totals}" for name, (totals, _) in lib_sass.items()))
    for name, (counts, _) in lib_sass.items():
        if counts["HGMMA"] == 0 or counts["UTMALDG"] == 0:
            fail(f"the {name} library has no wgmma or no TMA instruction: {counts}")
        if counts["HMMA"]:
            fail(f"the {name} library still has mma.sync (HMMA): {counts}")
        # ptxas may serialize wgmma without a warning: a wait after every one
        if counts["WARPGROUP.DEPBAR"] >= counts["HGMMA"]:
            fail(f"the {name} library waits on every wgmma alone: {counts}")
    # every 16-bit kernel: wgmma and TMA in its own SASS, no mma.sync
    sass_16 = {fn: c for _, (_, per_fn) in lib_sass.items() for fn, c in per_fn.items()
               if "flash_fwd_wgmma_kernel" in fn or "matmul_wgmma_kernel" in fn}
    n_16 = sum(len(w) for w in want_16.values()) + 2 * len(mm_configs)
    short16 = [fn for fn, c in sass_16.items()
               if c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"]]
    log(f"build SASS of the {len(sass_16)} 16-bit kernels: each has HGMMA and UTMALDG and no "
        f"HMMA: {not short16}")
    if len(sass_16) != n_16 or short16:
        fail(f"{len(sass_16)} 16-bit kernels in the SASS (want {n_16}); without wgmma or TMA, "
             f"or with HMMA: {short16[:3]}")
    # the f32 kernels: true f32, FFMA and no tensor-core product of any kind
    f32_sass = {fn: c for fn, c in {**sass_fn, **mm_sass_fn}.items()
                if "flash_fwd_f32_kernel" in fn or "matmul_f32_kernel" in fn}
    short = {fn: re.sub(r".*?(flash_fwd_f32|matmul_f32)_kernel", r"\1", fn)[:40]
             for fn in f32_sass}
    log("build SASS of the f32 kernels (FFMA/HGMMA/HMMA/LDL+STL local memory) per "
        "instantiation: " + ", ".join(
            f"{short[fn]} {c['FFMA']}/{c['HGMMA']}/{c['HMMA']}/{c['LDL'] + c['STL']}"
            for fn, c in sorted(f32_sass.items())))
    if len(f32_sass) != len(want_flash32) + len(mm32_configs):
        fail(f"found {len(f32_sass)} f32 kernels in the SASS, want "
             f"{len(want_flash32) + len(mm32_configs)}")
    for fn, c in f32_sass.items():
        if c["FFMA"] == 0 or c["HGMMA"] or c["HMMA"]:
            fail(f"the f32 kernel {fn} is not FFMA alone: {c}")
    smem_dims = fa.HEAD_DIMS + OTHER_HEAD_DIMS + (136, 192, 200, 256, 264)
    for bq in fa.BLOCKS:
        for bk in fa.BLOCKS:
            for d in smem_dims:
                for dtype, size in ((torch.bfloat16, 2), (torch.float16, 2), (torch.float32, 4)):
                    lib_bytes = fa.kernel_smem_bytes(bq, bk, d, dtype)
                    want = fa.smem_bytes(bq, bk, d, size) if fa.built(bq, bk, d, dtype) else -1
                    if lib_bytes != want or lib_bytes > GPU_H100.fast_mem_bytes:
                        fail(f"{dtype} flash ({bq},{bk}) d={d}: the library launches with "
                             f"{lib_bytes} B of shared memory, the pickers count {want}")
    log(f"build flash shared memory: library = smem_bytes <= {GPU_H100.fast_mem_bytes} B "
        f"at every bf16 and f16 instantiation (d {smem_dims}, the wide library past 128) "
        f"and, at 4 bytes, the {len(flash32_regs)} f32 ones (-1 where none is built)")
    for bm, bn, bk, db in mm_configs:
        staged = (2 if db else 1) * km.smem_bytes(bm, bn, bk, 2)
        for dtype in (torch.bfloat16, torch.float16):
            lib_bytes = km.kernel_smem_bytes(bm, bn, bk, db, dtype)
            if lib_bytes != staged or lib_bytes > GPU_H100.fast_mem_bytes:
                fail(f"{dtype} matmul ({bm},{bn},{bk}, {2 if db else 1} stages): the library "
                     f"stages {lib_bytes} B of shared memory, the sm90 model counts {staged}")
        lib32 = km.kernel_smem_bytes(bm, bn, bk, db, torch.float32)
        want32 = ((2 if db else 1) * km.smem_bytes(bm, bn, bk, 4)
                  if km.built(bm, bn, bk, db, torch.float32) else -1)
        if lib32 != want32:
            fail(f"f32 matmul ({bm},{bn},{bk}, {2 if db else 1} stages): the library stages "
                 f"{lib32} B, the sm90 model counts {want32}")
    log(f"build matmul shared memory: library = stages x smem_bytes <= "
        f"{GPU_H100.fast_mem_bytes} B at all {len(mm_configs)} bf16 and f16 instantiations "
        f"and, at 4 bytes, the {len(mm32_configs)} f32 ones (-1 where none is built)")

    # -------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(b, hq, hkv, s, d):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                     for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))

    # the checks and timings of the kernels' other inputs (the generic
    # builds, the f32 kernels) draw from a generator of their own, so that
    # every later phase sees the inputs it saw before they were added
    gen_new = torch.Generator(device=dev).manual_seed(NEW_INPUTS_SEED)

    def qkv_new(b, hq, hkv, s, d):
        return tuple(torch.randn(shape, generator=gen_new, device=dev).to(torch.bfloat16)
                     for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))

    # every (S, blocks) the serve phase launches, at its head counts
    cases = [(1, 32, 4, s, 128, c) for s in sorted(set(KERNEL_S) | set(PROMPT_LENS))
             for c in (True, False)] + [(1, 8, 2, 300, 64, True)]
    log(f"kernel limit: |kernel-plain| <= {KERNEL_RTOL}*|plain| + "
        f"{KERNEL_ATOL_RMS}*rms(plain); |kernel-oracle| <= {ORACLE_RTOL}*|oracle| + "
        f"{ORACLE_ATOL_RMS}*rms(oracle)")
    max_err = check_flash(cases, qkv)
    log(f"kernel at stablelm-3b's head dim 80 (Hq, Hkv, D) = {D80_HEADS}, padded to "
        f"{fa.padded_head_dim(80)} columns in shared memory, at every prompt length "
        f"and KERNEL_S, causal and not, limit {KERNEL_RTOL}*|plain|")
    max_err = max(max_err, check_flash(
        [(1, *D80_HEADS[:2], s, D80_HEADS[2], c)
         for s in sorted(set(KERNEL_S) | set(PROMPT_LENS)) for c in (True, False)], qkv))
    log(f"kernel at the generic builds' head dims {OTHER_HEAD_DIMS} (32/4 heads, the head "
        f"dim at run time, padded to {fa.PADDED_WIDTHS} columns), causal and not, limit "
        f"{KERNEL_RTOL}*|plain|")
    max_err = max(max_err, check_flash(
        [(1, 32, 4, s, d, c) for d in OTHER_HEAD_DIMS for s in (1, 77, 513, 1024)
         for c in (True, False)], qkv_new))

    # ------------------------------------------------------------ f32 kernels
    t_f32 = time.perf_counter()
    log(f"kernel f32 at the reference's grid {F32_FLASH_GRID} (B, Hq, Hkv, S, D), causal "
        f"and not, then at the reduced configs' shapes (4/2 and 4/4 heads of 16)")
    max_err32 = check_flash_f32([(*g, c) for g in F32_FLASH_GRID for c in (True, False)],
                                gen_new)
    max_err32 = max(max_err32, check_flash_f32(
        [(1, 4, hkv, s, 16, c) for hkv in (2, 4) for s in REDUCED_LENS for c in (True, False)],
        gen_new, control=False))
    mm_err32 = check_matmul_f32(F32_MM_SHAPES, gen_new)
    log(f"f32 kernels checked in {time.perf_counter() - t_f32:.1f} s")

    # --------------------------------------------------------------- timing
    cfg = get_config(ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sweep = []
    for s in sorted(set(PROMPT_LENS)):
        q, k, v = qkv(1, hq, hkv, s, d)
        bq, bk = ops.tuned_flash_blocks(s, d, 2)
        kern = lambda: fa.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
        sdpa_fn = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        ms, sdpa = graph_ms(kern), graph_ms(sdpa_fn)
        ms_eager, sdpa_eager = cuda_ms(kern, iters=20), cuda_ms(sdpa_fn, iters=20)
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                         block_q=bq, block_k=bk),
                        iters=3, warmup=1)
        flops, nbytes = flash_work(1, hq, hkv, s, d, True)
        bound = max(flops / GPU_H100.peak_flops_bf16, nbytes / GPU_H100.hbm_bandwidth) * 1e3
        sweep.append({"S": s, "Hq": hq, "Hkv": hkv, "blocks": [bq, bk], "ms": ms,
                      "sdpa_ms": sdpa,
                      "eager_ms": ms_eager, "sdpa_eager_ms": sdpa_eager,
                      "plain_ms": plain, "bound_ms": bound,
                      "tflops": flops / ms / 1e9})
        log(f"timing S={s} causal blocks=({bq},{bk}), graph replay: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), sdpa (yardstick) {sdpa:.4f} ms "
            f"({ms / sdpa:.2f}x); eager back-to-back: kernel {ms_eager:.4f}, sdpa "
            f"{sdpa_eager:.4f}; plain {plain:.4f} ms; bound {bound:.4f} ms")
    q, k, v = qkv(1, hq, hkv, TIMED_S, d)
    bq, bk = ops.tuned_flash_blocks(TIMED_S, d, 2)
    kern_ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=True, block_q=bq,
                                                  block_k=bk), iters=50)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                        block_q=bq, block_k=bk),
                       iters=5)
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=50)
    flops, nbytes = flash_work(1, hq, hkv, TIMED_S, d, True)
    t_ops, t_bytes = flops / GPU_H100.peak_flops_bf16, nbytes / GPU_H100.hbm_bandwidth
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"timing S={TIMED_S} causal blocks=({bq},{bk}), graph replay: kernel "
        f"{kern_ms:.4f} ms, sdpa (yardstick) {lib_ms:.4f} ms ({kern_ms / lib_ms:.2f}x); "
        f"plain (eager) {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    del q, k, v

    # --------------------------------------------------------------- matmul
    log(f"matmul limit: |kernel-plain| <= {MM_RTOL}*|plain| + "
        f"{MM_ATOL_RMS}*rms(plain), per element; the same against the f32 oracle")
    mm_err = 0.0
    mm_spaces = {}
    for m, n, k in YI6B_SHAPES + MM_PRESETS:
        cfgs = list(MatmulSpace(m, n, k, 2, target_kind=GPU_H100.kind).enumerate(None))
        pick = dict(zip(("bm", "bn", "bk", "double_buffer"),
                        ops.tuned_matmul_blocks(m, n, k, 2)))
        if pick not in cfgs:
            fail(f"the static pick {pick} at {m}x{n}x{k} is not a built configuration")
        mm_spaces[(m, n, k)] = cfgs
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        got = ops.matmul(x, y)
        oracle = ref.matmul(x, y)
        bad_o, worst_o = outside(got, oracle, MM_RTOL, MM_ATOL_RMS)
        line = [f"matmul {m}x{n}x{k}: pick {pick}, oracle {bad_o} outside "
                f"(worst {worst_o:.3f})"]
        if bad_o:
            fail(f"matmul kernel disagrees with the oracle at {m}x{n}x{k}")
        del oracle
        for bk in sorted({c["bk"] for c in cfgs}):
            group = [c for c in cfgs if c["bk"] == bk]
            want = km.matmul_plain(x, y, group[0]["bm"], group[0]["bn"], bk)
            worst, err = 0.0, 0.0
            for sched in group:
                got = km.matmul(x, y, **sched)
                torch.cuda.synchronize()
                bad, w = outside(got, want, MM_RTOL, MM_ATOL_RMS)
                err = max(err, float((got.float() - want.float()).abs().max()))
                worst = max(worst, w)
                if bad or not torch.isfinite(got).all():
                    fail(f"matmul kernel disagrees at {m}x{n}x{k} {sched}: {bad} outside")
            mm_err = max(mm_err, err)
            dropped = (km.matmul_plain(x[:, :k - bk], y[:k - bk], group[0]["bm"],
                                       group[0]["bn"], bk)
                       if k > bk else torch.zeros_like(want))
            n_drop, w_drop = outside(dropped, want, MM_RTOL, MM_ATOL_RMS)
            line.append(f"bk={bk}: {len(group)} configs, 0 outside, worst "
                        f"{worst:.3f}, max err {err:.3e}; dropped last K block "
                        f"{n_drop} outside (worst {w_drop:.1f}x)")
            if n_drop == 0:
                fail(f"the matmul limit would miss a dropped last K block at "
                     f"{m}x{n}x{k} bk={bk}")
        log("; ".join(line))
    del x, y, got, want, dropped
    ragged = check_ragged_matmul(torch.Generator(device=dev).manual_seed(RAGGED_SEED))
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- f16-wide
    f16w = f16_wide_phase(torch.Generator(device=dev).manual_seed(F16_SEED))

    # ---------------------------------------------------------------- tuner
    tuner = tuner_phase(gen, mm_spaces)
    topk, topk_check, fit, mm_launches = (tuner[key] for key in (
        "topk", "check", "fit", "launches"))
    mm_sweep = []
    for m, n, k in YI6B_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        blocks = ops.tuned_matmul_blocks(m, n, k, 2)
        kern = lambda: ops.matmul(x, y)
        lib_fn = lambda: torch.matmul(x, y)
        # in turns (kernel, library, library, kernel): under load the card
        # runs at its power limit, and its clock drifts from one call to the next
        k1, l1, l2, k2 = (graph_ms(f) for f in (kern, lib_fn, lib_fn, kern))
        ms, lib = (k1 + k2) / 2, (l1 + l2) / 2
        ms_eager, lib_eager = cuda_ms(kern, iters=20), cuda_ms(lib_fn, iters=20)
        flops, nbytes = matmul_work(m, n, k)
        t_ops, t_bytes = flops / GPU_H100.peak_flops_bf16, nbytes / GPU_H100.hbm_bandwidth
        bound = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        mm_sweep.append({"shape": [m, n, k], "blocks": list(blocks), "ms": ms,
                         "eager_ms": ms_eager, "library_ms": lib,
                         "library_eager_ms": lib_eager, "bound_ms": bound,
                         "tflops": flops / ms / 1e9})
        log(f"timing matmul {m}x{n}x{k} blocks={blocks}, graph replay: kernel "
            f"{ms:.4f} ms [{k1:.4f}, {k2:.4f}] ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"torch.matmul (yardstick) {lib:.4f} ms [{l1:.4f}, {l2:.4f}] "
            f"({ms / lib:.2f}x); eager back-to-back: kernel "
            f"{ms_eager:.4f}, torch.matmul {lib_eager:.4f}; bound {bound:.4f} ms by {by}")
        if (m, n, k) == MM_TIMED:
            mm_ms, mm_lib_ms, mm_bound_ms, mm_bound_by = ms, lib, bound, by
            mm_plain_ms = cuda_ms(lambda: km.matmul_plain(x, y, *blocks[:3]), iters=3)
            log(f"timing matmul {m}x{n}x{k}: plain {mm_plain_ms:.4f} ms")
    log("card after the matmul timing (clocks.sm, clocks.max.sm, power.draw, "
        f"temperature.gpu): {nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')}")
    del x, y
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    new_timing = time_new_kernels(gen_new)
    log(f"timing of the f32 kernels and the generic builds: "
        f"{time.perf_counter() - t_new:.1f} s")

    # -------------------------------------------------------------- reduced
    reduced = reduced_phase()
    log(f"reduced: {reduced['phase_s']:.1f} s")

    # ---------------------------------------------------------------- serve
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init {ARCH}: {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED)
    cap = max(PROMPT_LENS) + MAX_NEW + 2

    def requests():
        return [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, n)], MAX_NEW)
                for i, n in enumerate(PROMPT_LENS)]

    # warm-up (library handles, first launches); not counted
    serve(model, params, [Request(0, list(range(1, 65)), 2)], slots=SLOTS,
          cap=cap, scheduler="continuous")
    reqs = requests()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats = serve(model, params, reqs, slots=SLOTS, cap=cap, scheduler="continuous")
    launches = ops.launch_counts()
    log(f"serve: {stats['tokens']} tokens in {stats['wall_s']:.3f} s "
        f"({stats['tok_per_s']:.1f} tok/s), TTFT p50 {stats['ttft_s']['p50']:.4f} s "
        f"p99 {stats['ttft_s']['p99']:.4f} s, latency p50 "
        f"{stats['latency_s']['p50']:.4f} s p99 {stats['latency_s']['p99']:.4f} s, "
        f"{stats['engine_steps']} decode steps, {stats['prefills']} prefills, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("serve blocks per S: " + ", ".join(
        f"{s}->{ops.tuned_flash_blocks(s, d, 2)}" for s in PROMPT_LENS))
    log(f"serve launches: {launches}")
    if any(len(r.out) != MAX_NEW for r in reqs):
        fail(f"a request got too few tokens: {[len(r.out) for r in reqs]}")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.out):
        fail("a token outside the vocabulary")
    if stats["prefills"] != len(PROMPT_LENS):
        fail(f"{stats['prefills']} prefills for {len(PROMPT_LENS)} requests")
    if launches["flash_attention"] != stats["prefills"] * cfg.n_layers:
        fail(f"flash launches {launches['flash_attention']} != prefills x layers "
             f"{stats['prefills'] * cfg.n_layers}")

    _profile_serve(model, params, requests(), cap, serve, stats["wall_s"])

    # -------------------------------------------------------- schedule-store
    check_schedule_store(cfg, model, params, reqs, cap)

    # --------------------------------------------------------- golden-bundle
    f16_bundle_launches = check_golden_bundle(reqs, cap)

    # --------------------------------------------------------------- parity
    prompt = torch.tensor([[int(t) for t in rng.integers(0, cfg.vocab, 513)]],
                          dtype=torch.int32, device=dev)
    _, _, got = model.prefill(params, {"tokens": prompt}, 513)
    with plain_flash():  # this phase only
        _, _, want = model.prefill(params, {"tokens": prompt}, 513)
    check_logits(ARCH, cfg, got, want)
    serve_launches = {ARCH: launches["flash_attention"]}
    del model, params, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ f16-serve
    t_phase = time.perf_counter()
    f16_serve = serve_arch(*F16_SERVE, dtype="float16")
    log(f"f16-serve {F16_SERVE[0]}: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------------- train
    t_phase = time.perf_counter()
    train = train_phase(qkv)
    log(f"train: {time.perf_counter() - t_phase:.1f} s")

    # ----------------------------------------------------------------- mesh
    t_phase = time.perf_counter()
    mesh = mesh_phase(train)
    log(f"mesh: {time.perf_counter() - t_phase:.1f} s")

    # --------------------------------------------------------------- dryrun
    t_phase = time.perf_counter()
    dryrun = dryrun_phase(train, mesh)
    log(f"dryrun: {time.perf_counter() - t_phase:.1f} s")

    # ----------------------------------------------------------- controller
    t_phase = time.perf_counter()
    ctl = controller_phase(gen)
    log(f"controller: {time.perf_counter() - t_phase:.1f} s")
    mm_launches += ctl["launches"]
    mm_err = max(mm_err, ctl["max_abs_err"])

    # ------------------------------------------------- the new head groups
    groups = sorted({(c.n_heads, c.n_kv_heads, c.head_dim)
                     for c in (get_config(a) for a, _ in NEW_SERVES + DENSE_SERVES)},
                    reverse=True)
    checked = [g for g in groups if g != D80_HEADS]  # D=80: the kernel phase
    log(f"kernel at the later serves' head groups (Hq, Hkv, D) {checked}, causal, "
        f"at every prompt length they prefill (the two-ulp argument of GROUP_RTOL "
        f"holds at any group: it needs only many outputs)")
    max_err = max(max_err, check_flash(
        [(1, hq, hkv, s, d, True) for hq, hkv, d in checked for s in sorted(set(PROMPT_LENS))],
        qkv, rtol=GROUP_RTOL))

    def time_flash(hq, hkv, d, s, causal):
        q, k, v = qkv(1, hq, hkv, s, d)
        bq, bk = ops.tuned_flash_blocks(s, d, 2)
        ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                                 block_k=bk), iters=50)
        sdpa = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), iters=50)
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                                         block_q=bq, block_k=bk),
                        iters=3, warmup=1)
        # at D=80 the bound is the unpadded work: the padding is the kernel's
        flops, nbytes = flash_work(1, hq, hkv, s, d, causal)
        t_ops, t_bytes = flops / GPU_H100.peak_flops_bf16, nbytes / GPU_H100.hbm_bandwidth
        bound = max(t_ops, t_bytes) * 1e3
        entry = {"S": s, "Hq": hq, "Hkv": hkv, "D": d, "causal": causal,
                 "blocks": [bq, bk], "ms": ms, "sdpa_ms": sdpa, "plain_ms": plain,
                 "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "tflops": flops / ms / 1e9}
        sweep.append(entry)
        log(f"timing Hq={hq} Hkv={hkv} (group {hq // hkv}) D={d} S={s} "
            f"{'causal' if causal else 'non-causal'} blocks=({bq},{bk}), graph replay: "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), sdpa (yardstick) "
            f"{sdpa:.4f} ms ({ms / sdpa:.2f}x); plain {plain:.4f} ms; bound {bound:.4f} ms "
            f"by {entry['bound_by']}")
        return entry

    for hq, hkv, d in groups:
        entry = time_flash(hq, hkv, d, TIMED_S, True)
        if (hq, hkv, d) == D80_HEADS:
            d80 = entry

    # the ninth slice's configurations: whisper's encoder, non-causal over
    # its frames (1500: a ragged last tile at either block_k), and its
    # decoder, MHA; internvl2's group 7 over its patches and each prompt
    t_new = time.perf_counter()
    whisper, intern = get_config("whisper-large-v3"), get_config("internvl2-1b")
    wh = (whisper.n_heads, whisper.n_kv_heads, whisper.head_dim)
    iv = (intern.n_heads, intern.n_kv_heads, intern.head_dim)
    frames, patches = whisper.n_frontend_tokens, intern.n_frontend_tokens
    new_cases = ([(1, wh[0], wh[1], frames, wh[2], False)]
                 + [(1, wh[0], wh[1], s, wh[2], True) for s in whisper_lens()]
                 + [(1, iv[0], iv[1], patches + s, iv[2], True) for s in PROMPT_LENS])
    log(f"kernel at the encoder-decoder's and the vision prefix's configurations: "
        f"(Hq, Hkv, D) = {wh} non-causal at S={frames} and causal at "
        f"{list(whisper_lens())}; {iv} causal at {patches} + each prompt length; limit "
        f"{GROUP_RTOL}*|plain| (the two-ulp argument of GROUP_RTOL)")
    max_err = max(max_err, check_flash(new_cases, qkv, rtol=GROUP_RTOL))
    time_flash(*wh, frames, False)
    time_flash(*iv, patches + TIMED_S, True)
    log(f"groups: the new configurations took {time.perf_counter() - t_new:.1f} s")

    # ------------------------------------------- moe-serve and hybrid-serve
    for arch, n_layers in NEW_SERVES:
        serve_launches[arch] = serve_arch(arch, n_layers)

    # ------------------------------------------------------- dense-serve
    for arch, n_layers in DENSE_SERVES:
        serve_launches[arch] = serve_arch(arch, n_layers)

    # -------------------------------------------------------- recurrent-serve
    for arch, n_layers in RECURRENT_SERVES:
        t_phase = time.perf_counter()
        serve_launches[arch] = serve_arch(arch, n_layers)
        log(f"recurrent-serve {arch}: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- encdec-vision
    for arch, lens in (("whisper-large-v3", whisper_lens()), ("internvl2-1b", PROMPT_LENS)):
        t_phase = time.perf_counter()
        serve_launches[arch] = serve_prefixed(arch, lens)
        log(f"encdec-vision {arch}: {time.perf_counter() - t_phase:.1f} s")
    log(f"flash launches per serve: {serve_launches}")

    # -------------------------------------------------------------- results
    log(f"smoke: {time.perf_counter() - t_smoke:.1f} s from the start of main to the "
        f"results; the build's seconds per source {secs}, the f16-wide phase's "
        f"{f16w['s']} ({nvidia_smi('name,power.limit')})")
    print(json.dumps({"topk": {s: {how: row[how] for how in ("static", "calibrated", "hybrid")}
                               for s, row in topk.items()},
                      "check": topk_check, "fit": fit}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": (sum(serve_launches.values()) + sum(train["launches"].values())
                     + mesh["launches"]),
        "launches_by_serve": serve_launches,
        "launches_by_train": train["launches"], "launches_by_mesh": mesh["launches"],
        "train_shape": train["kernel"],
        "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms, "dtypes": ["bfloat16"],
        "head_dims": (f"every multiple of 8 from 8 to {fa.MAX_HEAD_DIM[torch.bfloat16]} in "
                      f"bf16 and f16 ({fa.MAX_HEAD_DIM[torch.float32]} in f32): "
                      f"{list(fa.HEAD_DIMS)} built, the rest at run time in the generic "
                      f"builds of {list(fa.PADDED_WIDTHS)} columns (192 and 256 in "
                      f"flash_attention_wide); see flash_attention_f16 and "
                      f"flash_attention_wide for the float16 launches"),
        "d80": d80, "other_head_dims": new_timing["flash_attention"], "sass": sass,
        "registers": flash_regs, "sweep": sweep}, {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": reduced["launches"]["flash_attention_f32"],
        "launches_by_reduced": {a: r["launches"] for a, r in reduced["archs"].items()},
        "max_abs_err": max_err32,
        **{key: new_timing["flash_attention_f32"][0][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "scaled_dot_product_attention, f32, efficient or math backend",
        "dtypes": ["float32"],
        "head_dims": f"every multiple of 8 from 8 to {fa.MAX_HEAD_DIM[torch.float32]} "
                     f"(padded to 64 or 128 columns)",
        "registers": flash32_regs, "sweep": new_timing["flash_attention_f32"]}, {
        "name": "flash_attention_f16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_f16.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": f16_serve, "launches_by_serve": {F16_SERVE[0]: f16_serve},
        "max_abs_err": f16w["max_abs_err"]["flash_attention_f16"],
        **{key: f16w["timing"]["flash_attention_f16"][0][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bf16_ms")},
        "library": "scaled_dot_product_attention, f16", "dtypes": ["float16"],
        "head_dims": (f"as bf16: every multiple of 8 from 8 to 128 here, 136-256 in "
                      f"flash_attention_wide"),
        "registers": regs_16["flash_attention_f16", "__half"],
        "sass": lib_sass["flash_attention_f16"][0]}, {
        "name": "flash_attention_wide", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_wide.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": f16w["launches"]["flash_attention_wide"],
        "max_abs_err": max(f16w["max_abs_err"]["flash_attention_wide"].values()),
        "max_abs_err_by_dtype": f16w["max_abs_err"]["flash_attention_wide"],
        **{key: f16w["timing"]["flash_attention_wide"][0][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "timed_at": {key: f16w["timing"]["flash_attention_wide"][0][key]
                     for key in ("Hq", "Hkv", "S", "D", "dtype", "model")},
        "library": "scaled_dot_product_attention in the same dtype",
        "dtypes": ["bfloat16", "float16"],
        "head_dims": "every multiple of 8 from 136 to 256 (padded to 192 or 256 columns)",
        "registers": {f"{elem}_{key}": r for (lib, elem), regs in regs_16.items()
                      if lib == "flash_attention_wide" for key, r in regs.items()},
        "sass": lib_sass["flash_attention_wide"][0],
        "sweep": f16w["timing"]["flash_attention_wide"]}, {
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:28",
        "launches": mm_launches, "launches_by_controller": ctl["launches"],
        "max_abs_err": mm_err,
        "ms": mm_ms, "plain_ms": mm_plain_ms, "bound_ms": mm_bound_ms,
        "bound_by": mm_bound_by, "library_ms": mm_lib_ms, "dtypes": ["bfloat16"],
        "ragged_check_launches": ragged["launches"]["matmul"],
        "ragged_max_abs_err": ragged["max_abs_err"]["matmul"],
        "ragged": ragged["timed"]["matmul"],
        "sass": mm_sass, "registers": mm_regs, "sweep": mm_sweep}, {
        "name": "matmul_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:28",
        "launches": reduced["launches"]["matmul_f32"], "max_abs_err": mm_err32,
        **{key: new_timing["matmul_f32"][0][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "torch.matmul, f32, TF32 off", "dtypes": ["float32"],
        "ragged_check_launches": ragged["launches"]["matmul_f32"],
        "ragged_max_abs_err": ragged["max_abs_err"]["matmul_f32"],
        "ragged": ragged["timed"]["matmul_f32"],
        "registers": mm32_regs, "sweep": new_timing["matmul_f32"]}, {
        "name": "matmul_f16", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul_f16.cu",
        "replaces": "src/repro/kernels/matmul.py:28",
        "launches": f16w["launches"]["matmul_f16"] + f16_bundle_launches,
        "launches_by": {"ops.matmul at yi-6b's shapes": f16w["launches"]["matmul_f16"],
                        "the bf16 bundle's miss": f16_bundle_launches},
        "max_abs_err": f16w["max_abs_err"]["matmul_f16"],
        **{key: f16w["timing"]["matmul_f16"][0][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bf16_ms")},
        "library": "torch.matmul, f16", "dtypes": ["float16"],
        "registers": mm16_regs, "sass": lib_sass["matmul_f16"][0]}]}), flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def tuner_phase(gen, mm_spaces) -> dict:
    """Phase 5, counted: the calibration, then per yi-6b shape the ES
    search, ops.matmul and the top-k measurement, then the three-way
    rankings. ``mm_spaces`` maps each shape to the configurations the
    matmul phase checked. Returns the three-way ``topk``, ``check``,
    ``fit`` and the matmul ``launches``."""
    import numpy as np
    import torch

    from repro_torch.benchmarks.topk_ratio import YI6B_SHAPES, three_way, topk_ratio_matmul
    from repro_torch.core import calibrate
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.core.tuner import best_schedule, record_version, tune
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import ops
    from repro_torch.tuna.learned import iter_log_records

    dev = gen.device
    ops.reset_launch_counts()
    topk_dir = ROOT / "build" / "topk"
    shutil.rmtree(topk_dir, ignore_errors=True)
    store = str(topk_dir / "measured.jsonl")
    t0 = time.perf_counter()
    fit = calibrate.cached_coeffs(GPU_H100.name, dev, refit=True, iters=TOPK_ITERS,
                                  db=store)
    # measure's eager warm-up + the calls captured in its graph, per config
    expected = fit["_n_configs"] * (3 + TOPK_ITERS)
    coef = {name: fit[name] for name in calibrate.FEATURES + ("intercept",)}
    if not all(np.isfinite(v) and v >= 0 for v in coef.values()) or \
            not np.isfinite(fit["_r2_on_probe"]):
        fail(f"the gpu_h100 fit is not finite and non-negative: {fit}")
    log(f"calibrate {GPU_H100.name} on {fit['_card']}: probe {fit['_probe']} bf16, "
        f"{fit['_n_configs']} configs (seed {fit['_seed']}) by graph replay; "
        f"coefficients {coef}; r2 on the probe {fit['_r2_on_probe']:.4f}; "
        f"lineage {record_version(calibrate.coeffs_for_scoring(fit))}; "
        f"{time.perf_counter() - t0:.1f} s")
    log("calibrate probe times [ms]: " + ", ".join(
        f"({c['bm']},{c['bn']},{c['bk']},{int(c['double_buffer'])}) {r.score * 1e3:.4f}"
        for r in iter_log_records(store) for c in (r.config,)))
    measured = {}
    for m, n, k in YI6B_SHAPES:
        space = MatmulSpace(m, n, k, 2, target_kind=GPU_H100.kind)
        res = tune(space, GPU_H100, seed=SEED)
        best, best_score = best_schedule(space, GPU_H100)
        log(f"tune {m}x{n}x{k}: ES {res.config} score {res.score * 1e3:.4f} ms "
            f"({res.evaluations} evaluations, {res.wall_seconds:.3f} s); "
            f"exhaustive best {best} {best_score * 1e3:.4f} ms; "
            f"{'equal' if res.config == best else 'differs'}")
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        out = ops.matmul(x, y)
        torch.cuda.synchronize()
        expected += 1
        if out.shape != (m, n) or not torch.isfinite(out).all():
            fail(f"ops.matmul at {m}x{n}x{k} gave {tuple(out.shape)} or non-finite values")
        r = topk_ratio_matmul(m, n, k, iters=TOPK_ITERS, seed=SEED, device=dev,
                              db=store, collect=True)
        measured[(m, n, k)] = r
        # measure's eager warm-up + the calls captured in its graph (a replay
        # runs the kernel without calling the wrapper, so it is not counted)
        expected += r["n_configs"] * (3 + TOPK_ITERS)
        ratios = {key: v for key, v in r.items()
                  if key.startswith(("ratio@", "top1", "rank_corr"))}
        if not all(np.isfinite(v) and (v > 0 or key == "rank_corr")
                   for key, v in ratios.items()):
            fail(f"non-finite top-k ratio at {m}x{n}x{k}: {ratios}")
        if sorted(str(e["config"]) for e in r["ranking"]) != \
                sorted(map(str, mm_spaces[(m, n, k)])):
            fail(f"top-k at {m}x{n}x{k} measured configurations the check did not")
        by_ms = sorted(r["ranking"], key=lambda e: e["ms"])
        short = lambda e: (f"({e['config']['bm']},{e['config']['bn']},{e['config']['bk']},"
                           f"{int(e['config']['double_buffer'])}) {e['ms']:.4f}")
        log(f"topk {m}x{n}x{k}: " + ", ".join(f"{key}={v:.4f}" for key, v in ratios.items())
            + f"; best static {r['best_static_ms']:.4f} ms, best measured "
            f"{r['best_oracle_ms']:.4f} ms; static {r['static_s']:.3f} s vs measure "
            f"{r['measure_s']:.3f} s over {r['n_configs']}/{r['space_size']} configs")
        twins = {}
        for e in r["ranking"]:
            c = e["config"]
            twins.setdefault((c["bm"], c["bn"], c["bk"]), {})[c["double_buffer"]] = e
        static2 = sum(v[True]["score"] < v[False]["score"] for v in twins.values())
        card2 = sum(v[True]["ms"] < v[False]["ms"] for v in twins.values())
        log(f"topk {m}x{n}x{k}: two stages preferred over one by the model in "
            f"{static2}/{len(twins)} tiles, on the card in {card2}/{len(twins)}; "
            "overflow-penalised: "
            + str([e["config"] for e in r["ranking"] if e["score"] > 1.0]))
        log(f"topk {m}x{n}x{k} static top5 [ms]: "
            + ", ".join(short(e) for e in r["ranking"][:5])
            + " | measured top5: " + ", ".join(short(e) for e in by_ms[:5]))
    # the same times ranked three ways: no launch
    t0 = time.perf_counter()
    try:
        topk, check = three_way(measured, store, topk_dir, device=dev)
    except AssertionError as e:
        fail(f"three-way top-k: {e}")
    for shape, row in topk.items():
        log(f"topk {shape} three ways: " + "; ".join(
            f"{how} " + ", ".join(f"{key}={v:.4f}" for key, v in row[how].items())
            for how in ("static", "calibrated", "hybrid"))
            + f"; hybrid {row['learned_version']} trained on {row['train_rows']} "
            f"cm1-meas rows of {len(row['train_ops'])} other ops")
    log(f"topk --check (a reading, not a gate): {check}; three-way ranking "
        f"{time.perf_counter() - t0:.1f} s")
    launches = ops.launch_counts()["matmul"]
    log(f"tuner path launches: {ops.launch_counts()} (expected matmul {expected}: "
        f"the probe's {fit['_n_configs']} x (3 + {TOPK_ITERS}), then per shape 1 + "
        f"configs x (3 + {TOPK_ITERS}))")
    if launches != expected or launches == 0:
        fail(f"matmul launches {launches} != {expected} on the tuner path")
    return {"topk": topk, "check": check, "fit": fit, "launches": launches}


def whisper_lens():
    """The serve's prompt lengths whose new tokens fit whisper's decoder."""
    return tuple(s for s in PROMPT_LENS if s + MAX_NEW <= WHISPER_CONTEXT)


def check_schedule_store(cfg, model, params, served, cap) -> None:
    """The yi-6b serve with its block picks served from the schedule store
    (the ``schedule-store`` phase): cold search into an empty DB, a snapshot
    built by the CLI in a subprocess, then the same requests served warm
    through the snapshot, republished by the refresh hook mid-serve. Fails
    on any gate; logs one ``schedule-store`` line. The store lives under
    ``build/schedule_store`` and the defaults are off again at the end."""
    import torch
    from repro_torch.benchmarks.topk_ratio import YI6B_SHAPES
    from repro_torch.core import cost_model, op_registry, tuner
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import serve
    from repro_torch.tuna.cache import ScheduleCache, SnapshotManager, read_snapshot_header
    from repro_torch.tuna.db import ScheduleDatabase, ScheduleRecord

    d = cfg.head_dim
    shapes = tuple(YI6B_SHAPES)
    # the picks the earlier phases made with no store (memoised there)
    plain_flash = {s: ops.tuned_flash_blocks(s, d, 2) for s in PROMPT_LENS}
    plain_mm = {m: ops.tuned_matmul_blocks(*m, 2) for m in shapes}
    flash_sig = {s: op_registry.make_space("flash", {"s": s, "d": d, "dtype_bytes": 2},
                                           GPU_H100.kind).signature() for s in PROMPT_LENS}
    mm_sig = {m: MatmulSpace(*m, 2, target_kind=GPU_H100.kind).signature() for m in shapes}
    # the record the republish adds: a shape the serve never uses, ranked
    # here, before the evaluations are counted
    space = MatmulSpace(4096, 4096, 4096, 2, target_kind=GPU_H100.kind)
    best, score = tuner.best_schedule(space, GPU_H100, db=False)
    extra = ScheduleRecord(op=space.signature(), target=GPU_H100.name, config=best,
                           score=score, evaluations=space.size(),
                           meta={"strategy": "exhaustive"})

    store = ROOT / "build" / "schedule_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    db_path, snaps = str(store / "db.jsonl"), store / "snaps"

    # cold: an empty DB, the memos cleared; every pick searches and writes back
    ops.use_schedule_db(db_path)
    t0 = time.perf_counter()
    cold_flash = {s: ops.tuned_flash_blocks(s, d, 2) for s in PROMPT_LENS}
    cold_mm = {m: ops.tuned_matmul_blocks(*m, 2) for m in shapes}
    cold_s = time.perf_counter() - t0
    db = ScheduleDatabase(db_path)
    sigs = set(flash_sig.values()) | set(mm_sig.values())
    if len(db) != len(sigs) or db.lines_read != len(sigs) or \
            {r.op for r in db.records()} != sigs:
        fail(f"schedule-store: the cold DB holds {len(db)} keys in {db.lines_read} "
             f"lines for {len(sigs)} distinct signatures")
    for s in PROMPT_LENS:
        rec = db.best(flash_sig[s], GPU_H100.name)
        got = (rec.config["block_q"], rec.config["block_k"])
        if got != plain_flash[s] or cold_flash[s] != plain_flash[s]:
            fail(f"schedule-store: flash record at S={s} {rec.config} is not the "
                 f"store-less pick {plain_flash[s]}")
    for m in shapes:
        rec = db.best(mm_sig[m], GPU_H100.name)
        got = tuple(rec.config[x] for x in ("bm", "bn", "bk", "double_buffer"))
        if got != plain_mm[m] or cold_mm[m] != plain_mm[m]:
            fail(f"schedule-store: matmul record at {m} {got} is not the store-less "
                 f"pick {plain_mm[m]}")

    # snapshot: the CLI in its own process, the sha1 checked, the DB off
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.tuna", "snapshot", "--db",
                          db_path, "--dir", str(snaps)], env=env, capture_output=True,
                         text=True, timeout=300)
    snap_s = time.perf_counter() - t0
    if res.returncode:
        fail(f"schedule-store: python -m repro_torch.tuna snapshot exited "
             f"{res.returncode}: {res.stderr[-2000:]}")
    latest = str(snaps / "schedule_cache.latest.json")
    want_sha = ScheduleCache.from_db(ScheduleDatabase(db_path)).payload_sha1()
    if read_snapshot_header(latest)["sha1"] != want_sha:
        fail("schedule-store: the snapshot's sha1 is not the DB's payload digest")
    ops.use_schedule_db(None)
    ops.use_schedule_cache(latest)
    first = tuner.get_default_cache()
    if first.sha1 != want_sha or len(first) != len(sigs):
        fail(f"schedule-store: the installed snapshot holds {len(first)} records, "
             f"sha1 {first.sha1}")

    # warm: the cost model counted, the flash blocks recorded, the snapshot
    # republished by the refresh hook after the first admission
    evals, seen, republished = [0], {}, []
    evaluate, flash = cost_model.evaluate, ops.flash_attention

    def counting(*a, **kw):
        evals[0] += 1
        return evaluate(*a, **kw)

    def recording(q, k, v, **kw):
        seen.setdefault(q.shape[2], set()).add((kw["block_q"], kw["block_k"]))
        return flash(q, k, v, **kw)

    def refresh():
        if not republished:
            ScheduleDatabase(db_path).add(extra)
            republished.append(SnapshotManager(db_path, str(snaps)).ensure())
        return ops.refresh_schedule_cache()

    cost_model.evaluate, ops.flash_attention = counting, recording
    try:
        t0 = time.perf_counter()
        warm_flash = {s: ops.tuned_flash_blocks(s, d, 2) for s in PROMPT_LENS}
        warm_mm = {m: ops.tuned_matmul_blocks(*m, 2) for m in shapes}
        warm_s = time.perf_counter() - t0
        ops.use_schedule_cache(latest)  # the same instance; the memos cleared
        again = [Request(r.rid, list(r.prompt), MAX_NEW) for r in served]
        ops.reset_launch_counts()
        stats = serve(model, params, again, slots=SLOTS, cap=cap, refresh=refresh,
                      scheduler="continuous")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        served_extra = tuner.lookup_best(extra.op, GPU_H100.name)
    finally:
        cost_model.evaluate, ops.flash_attention = evaluate, flash
    swapped = tuner.get_default_cache()
    hits, misses = first.hits + swapped.hits, first.misses + swapped.misses
    ops.use_schedule_cache(None)  # the later phases pick with no store

    differ = sum(a != b for r, r2 in zip(served, again) for a, b in zip(r.out, r2.out))
    summary = {
        "records": len(sigs), "flash_records": len(set(flash_sig.values())),
        "matmul_records": len(shapes), "snapshot_sha1": want_sha,
        "evaluations_warm": evals[0], "cache_reloads": stats["cache_reloads"],
        "republished_records": republished[0].count if republished else None,
        "hits": hits, "misses": misses, "tokens_differ": differ,
        "tokens": sum(len(r.out) for r in again),
        "flash_launches": launches["flash_attention"], "prefills": stats["prefills"],
        "cold_search_s": cold_s, "warm_lookup_s": warm_s, "snapshot_cli_s": snap_s,
        "serve_wall_s": stats["wall_s"], "card": nvidia_smi("name,power.limit"),
    }
    log("schedule-store " + json.dumps(summary))
    if evals[0]:
        fail(f"schedule-store: {evals[0]} cost-model evaluations with a warm snapshot")
    if warm_flash != cold_flash or warm_mm != cold_mm:
        fail("schedule-store: the warm picks are not the cold ones")
    if any(seen.get(s) != {cold_flash[s]} for s in PROMPT_LENS):
        fail(f"schedule-store: flash blocks per S {seen} are not the cold picks {cold_flash}")
    if stats["prefills"] != len(PROMPT_LENS) or \
            launches["flash_attention"] != stats["prefills"] * cfg.n_layers:
        fail(f"schedule-store: {launches['flash_attention']} flash launches for "
             f"{stats['prefills']} prefills x {cfg.n_layers} layers")
    if differ or any(len(r.out) != MAX_NEW for r in again):
        fail(f"schedule-store: {differ} tokens differ from the serve with no store")
    if stats["cache_reloads"] < 1 or swapped is first:
        fail(f"schedule-store: {stats['cache_reloads']} hot reloads after the republish")
    if served_extra != extra or misses:
        fail(f"schedule-store: the republished record is served as {served_extra}; "
             f"{misses} snapshot misses")


COLD_MM_SHAPE = (2048, 4096, 4096)   # a bundled yi-6b shape (the store's)


def check_golden_bundle(served, cap) -> int:
    """The ``golden-bundle`` phase: the schedule-store phase's DB promoted
    into a golden release (no-op re-promotion, the regression gate, a
    waiver), a kernel bundle built by the CLI in a subprocess and refused
    when torn, stale, for the CPU or from other sources; an f16 call at a
    bundled bf16 shape, which must miss and launch the f16 kernel from the
    bundle's matmul_f16 library; then the two cold starts of yi-6b. Fails
    on any gate; logs one ``golden-bundle`` line. Everything lives under
    ``build/golden`` and ``build/cold_start``. Returns the f16 call's
    matmul_f16 launches."""
    import torch
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.kernels import build, ops
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.tuna.cache import StaleSnapshotError
    from repro_torch.tuna.db import ScheduleDatabase
    from repro_torch.tuna.golden import (BundleError, GoldenManager,
                                         GoldenRegressionError, KernelBundle)

    t_phase = time.perf_counter()
    store = ROOT / "build" / "schedule_store"
    db_path, snapshot = str(store / "db.jsonl"), str(store / "snaps" / "schedule_cache.latest.json")
    gdir = ROOT / "build" / "golden"
    shutil.rmtree(gdir, ignore_errors=True)
    records = ScheduleDatabase(db_path).records()
    target = GPU_H100.name
    mm_sig = MatmulSpace(*COLD_MM_SHAPE, 2, target_kind=GPU_H100.kind).signature()
    mm_rec = next((r for r in records if r.op == mm_sig), None)
    if mm_rec is None:
        fail(f"golden-bundle: the store holds no record for {mm_sig}")

    # promote: a lineage of its own for the gate's checks
    mgr = GoldenManager(str(gdir / "gate"))
    first = mgr.promote(records, target, source=db_path)
    again = mgr.promote(records, target, source=db_path)
    if again.rebuilt or again.repointed or again.name != first.name:
        fail(f"golden-bundle: re-promoting the same records was not a no-op: {again}")
    slower = [dataclasses.replace(r, score=r.score * 2) if r.op == mm_sig else r
              for r in records]
    try:
        mgr.promote(slower, target, source="slower")
        fail("golden-bundle: a slower record was promoted past the gate")
    except GoldenRegressionError as e:
        regs = [(r.op, r.kind) for r in e.regressions]
        if regs != [(mm_sig, "slower")]:
            fail(f"golden-bundle: the gate refused {regs}, want [({mm_sig!r}, 'slower')]")
    if mgr.current(target)["release"] != first.name:
        fail("golden-bundle: a refused promotion moved the latest pointer")
    spec = f"{mm_sig}@{target}"
    waived = mgr.promote(slower, target, waive=[spec], source="slower")
    hdr, _ = mgr.load_release(waived.latest)
    if [w["waived_by"] for w in hdr["waivers"]] != [spec] or hdr["predecessor"] != first.name:
        fail(f"golden-bundle: the waiver is not in the release: {hdr['waivers']}")

    # the bundle: the CLI in its own process, on the card
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.tuna", "golden", "--db", db_path,
                          "--dir", str(gdir / "release"), "--bundle"], env=env,
                         capture_output=True, text=True, timeout=300)
    bundle_cli_s = time.perf_counter() - t0
    if res.returncode:
        fail(f"golden-bundle: python -m repro_torch.tuna golden --bundle exited "
             f"{res.returncode}: {res.stderr[-2000:]}")
    for line in res.stdout.splitlines():
        log(f"golden-bundle cli: {line}")
    latest = gdir / "release" / f"bundle.{target}.latest.json"
    bundle = KernelBundle.load(str(latest))
    path = Path(bundle.source)
    obj = json.loads(path.read_text())
    log(f"golden-bundle: {bundle.describe()}; {path.stat().st_size} B; libraries "
        + ", ".join(f"{n} {lib['bytes']} B sha1 {lib['sha1']}"
                    for n, lib in sorted(obj["libraries"].items()))
        + f"; skipped {obj['skipped'] or 'none'}")
    if len(bundle) != len(records) or bundle.golden is None:
        fail(f"golden-bundle: {len(bundle)} entries for {len(records)} bf16 records")

    # refusals at load: torn, stale, another device, other kernel sources
    refused = {}
    cases = {"torn": (lambda o: None, path.read_text()[: path.stat().st_size // 2], "cuda"),
             "stale": (lambda o: o.update(cost_model_version="cm0"), None, "cuda"),
             "cpu": (lambda o: None, None, "cpu"),
             "sources": (lambda o: o.update(source_digest="0" * 12), None, "cuda")}
    for name, (edit, text, device) in cases.items():
        bad = gdir / f"refused-{name}.json"
        o = json.loads(path.read_text())
        edit(o)
        bad.write_text(text if text is not None else json.dumps(o))
        try:
            KernelBundle.load(str(bad), device=device)
            fail(f"golden-bundle: a {name} bundle loaded")
        except (BundleError, StaleSnapshotError) as e:
            refused[name] = f"{type(e).__name__}: {str(e)[len(str(bad)) + 2:][:90]}"
        bad.unlink()
    log(f"golden-bundle refusals: {refused}")
    want_words = {"torn": "not JSON", "stale": "cost-model version", "cpu": "backend",
                  "sources": "kernel sources"}
    if any(want_words[n] not in refused[n] for n in cases):
        fail(f"golden-bundle: a refusal did not name its cause: {refused}")

    # an f16 call at a bundled bf16 shape: the entries are keyed by
    # "bfloat16", so it misses, takes the record's blocks from the bundle's
    # index and launches the f16 kernel from the bundle's matmul_f16 library
    gen16 = torch.Generator(device="cuda").manual_seed(F16_SEED)
    m, n, k = COLD_MM_SHAPE
    x = torch.randn((m, k), generator=gen16, device="cuda").half()
    y = torch.randn((k, n), generator=gen16, device="cuda").half()
    explicit = ops.matmul(x, y, blocks=tuple(mm_rec.config[key] for key in
                                             ("bm", "bn", "bk", "double_buffer")))
    t0 = time.perf_counter()
    ops.use_kernel_bundle(str(latest))
    try:
        in_use = ops.get_kernel_bundle()
        builds, before = ops.kernel_build_counts(), ops.launch_counts()
        got = ops.matmul(x, y)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        f16_row = {"hits": in_use.exec_hits, "misses": in_use.exec_misses,
                   "nvcc": {n_: c - builds[n_] for n_, c in ops.kernel_build_counts().items()},
                   "launches": {n_: c - before[n_] for n_, c in after.items() if c != before[n_]},
                   "library": str(build.installed().get("matmul_f16")),
                   "equal_explicit": bool(torch.equal(got, explicit)),
                   "s": time.perf_counter() - t0}
    finally:
        ops.use_kernel_bundle(None)
    log(f"golden-bundle f16 call at {m}x{n}x{k} with the bf16 records' bundle installed: "
        f"{f16_row}")
    if (f16_row["hits"], f16_row["misses"]) != (0, 1) or f16_row["launches"] != {
            "matmul_f16": 1} or any(f16_row["nvcc"].values()) or not f16_row["equal_explicit"] \
            or "bundled" not in f16_row["library"]:
        fail(f"golden-bundle: the f16 call did not miss and launch the bundled f16 kernel: "
             f"{f16_row}")
    del x, y, got, explicit

    # the two cold starts, each in a fresh process over a copy of the port
    prompts = [list(r.prompt) for r in served]
    arms = {}
    for arm in ("unbundled", "bundled"):
        home = ROOT / "build" / "cold_start" / arm
        shutil.rmtree(home, ignore_errors=True)
        shutil.copytree(SRC / "repro_torch", home / "src" / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        spec = {"arm": arm, "root": str(home), "prompts": prompts, "cap": cap,
                "cache": snapshot if arm == "unbundled" else None,
                "bundle": str(latest) if arm == "bundled" else None,
                "mm_shape": list(COLD_MM_SHAPE),
                "mm_blocks": [mm_rec.config[k] for k in ("bm", "bn", "bk", "double_buffer")]}
        spec_path = home / "spec.json"
        spec_path.write_text(json.dumps(spec))
        arm_env = {k: v for k, v in os.environ.items()
                   if k not in ("REPRO_TUNA_DB", "REPRO_TUNA_CACHE", "REPRO_TUNA_BUNDLE")}
        arm_env["PYTHONPATH"] = str(home / "src")
        launched = time.time()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--cold-start-arm",
                              str(spec_path)], env=arm_env, capture_output=True, text=True,
                             timeout=600)
        done = [l for l in res.stdout.splitlines() if l.startswith("cold-start-arm ")]
        if res.returncode or not done:
            fail(f"golden-bundle: the {arm} cold start exited {res.returncode}: "
                 f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
        r = json.loads(done[-1][len("cold-start-arm "):])
        for key in ("imported", "first_token", "end"):
            r[f"{key}_s"] = r.pop(key) - launched
        arms[arm] = r
        shutil.rmtree(home, ignore_errors=True)

    want = [list(r.out) for r in served]
    summary = {"records": len(records), "release": first.name, "waived_release": waived.name,
               "bundle": path.name, "bundle_bytes": path.stat().st_size,
               "libraries": {n: lib["sha1"] for n, lib in obj["libraries"].items()},
               "entries": len(bundle), "skipped": len(obj["skipped"]), "f16_call": f16_row,
               "bundle_cli_s": bundle_cli_s, "phase_s": time.perf_counter() - t_phase,
               "card": nvidia_smi("name,power.limit")}
    for arm, r in arms.items():
        same = sum(a == b for got, ref in zip(r.pop("tokens"), want) for a, b in zip(got, ref))
        r["tokens_equal"] = same
        summary[arm] = r
    log("golden-bundle " + json.dumps(summary))
    un, bu = arms["unbundled"], arms["bundled"]
    total = sum(len(t) for t in want)
    if sum(un["nvcc"].values()) < 1:
        fail(f"golden-bundle: the unbundled cold start ran no nvcc: {un['nvcc']}")
    if sum(bu["nvcc"].values()) or bu["evaluations"] or bu["exec_hits"] < 1:
        fail(f"golden-bundle: the bundled cold start ran nvcc {bu['nvcc']}, made "
             f"{bu['evaluations']} evaluations, {bu['exec_hits']} bundled hits")
    if un["tokens_equal"] != total or bu["tokens_equal"] != total:
        fail(f"golden-bundle: tokens equal to the phase-6 serve: unbundled "
             f"{un['tokens_equal']}, bundled {bu['tokens_equal']} of {total}")
    if not bu["mm_equals_explicit"] or bu["mm_sha1"] != un["mm_sha1"]:
        fail("golden-bundle: the bundled matmul differs from the explicit-blocks launch "
             "or from the unbundled start's")
    return f16_row["launches"]["matmul_f16"]


def cold_start_arm(spec_path: str) -> None:
    """One cold start of the golden-bundle phase, in its own process over a
    copy of the port (``$PYTHONPATH``) whose build/kernels is empty: the
    snapshot or the bundle installed, one ops.matmul at a bundled shape
    without blocks, then yi-6b served on the given prompts. Prints one
    ``cold-start-arm {...}`` line with wall-clock stamps (``time.time()``)."""
    import hashlib

    import torch

    import repro_torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import cost_model, tuner
    from repro_torch.kernels import build, ops
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    imported = time.time()
    spec = json.loads(Path(spec_path).read_text())
    home = Path(spec["root"]).resolve()
    if home not in Path(repro_torch.__file__).resolve().parents or \
            home not in build.BUILD_DIR.parents:
        fail(f"cold start: repro_torch from {repro_torch.__file__}, not the copy under {home}")
    if build.BUILD_DIR.exists() and any(build.BUILD_DIR.iterdir()):
        fail(f"cold start: {build.BUILD_DIR} is not empty")
    evals = [0]
    evaluate = cost_model.evaluate

    def counting(*a, **kw):
        evals[0] += 1
        return evaluate(*a, **kw)

    cost_model.evaluate = counting
    if spec["bundle"]:
        ops.use_kernel_bundle(spec["bundle"])
    else:
        ops.use_schedule_cache(spec["cache"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m, n, k = spec["mm_shape"]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    out = ops.matmul(x, y)
    explicit = ops.matmul(x, y, blocks=tuple(spec["mm_blocks"]))
    torch.cuda.synchronize()
    mm_sha1 = hashlib.sha1(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    mm_equal = bool(torch.equal(out, explicit))
    del x, y, out, explicit

    cfg = get_config(ARCH)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    reqs = [Request(i, list(p), MAX_NEW) for i, p in enumerate(spec["prompts"])]
    t_serve = time.time()
    stats = serve(model, params, reqs, slots=SLOTS, cap=spec["cap"], scheduler="continuous")
    end = time.time()
    # t_first counts from the start of the engine's run, a few ms after t_serve
    first = t_serve + min(r.t_first for r in reqs)
    bundle = ops.get_kernel_bundle()
    picks = bundle if bundle is not None else tuner.get_default_cache()
    print("cold-start-arm " + json.dumps({
        "imported": imported, "first_token": first, "end": end,
        "nvcc": ops.kernel_build_counts(), "evaluations": evals[0],
        "exec_hits": bundle.exec_hits if bundle else 0,
        "exec_misses": bundle.exec_misses if bundle else 0,
        "schedule_hits": picks.hits, "schedule_misses": picks.misses,
        "launches": ops.launch_counts(), "installed": {n: str(p) for n, p in build.installed().items()},
        "mm_sha1": mm_sha1, "mm_equals_explicit": mm_equal, "prefills": stats["prefills"],
        "tokens": [list(r.out) for r in reqs], "serve_wall_s": stats["wall_s"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# record_function ranges the port's blocks open: the profile's split
SPANS = {"moe.route": "MoE routing and ranks", "moe.gather_scatter": "MoE gather/scatter",
         "moe.experts": "MoE expert products", "attention": "attention (prefill + decode)",
         "cross_attention": "cross-attention (prefill + decode)", "mamba": "mamba mixer",
         "mlstm": "mLSTM mixer", "slstm": "sLSTM mixer",
         "flash.backward": "attention backward", "cross_entropy": "cross-entropy",
         "optimizer": "optimizer"}
# the train profile's split: the attention mixer's forward (run twice under
# remat: the forward and its recompute), the flash backward, the
# cross-entropy chunks (forward and recompute) and the optimizer
TRAIN_SPANS = {"attention": "attention forward", "flash.backward": "attention backward",
               "cross_entropy": "cross-entropy", "optimizer": "optimizer"}


def trace_device_time(path) -> tuple:
    """Device time from a Chrome trace that ``torch.profiler`` wrote (its
    C++ export, which skips the Python post-processing of ``key_averages``,
    minutes at a million launches): every kernel, memcpy and memset as
    (name, ms), and the device ms of each ``SPANS`` range, the sum of the
    kernels whose launch (the CUDA API call with the kernel's correlation
    id) lies inside it on the same thread."""
    import bisect

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, spans, kernels = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kernels.append((e["name"], e["dur"] / 1e3, e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], e["ts"])
        elif cat == "user_annotation" and e["name"] in SPANS:
            spans.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    starts = {}
    for tid, ranges in spans.items():
        ranges.sort()
        starts[tid] = [r[0] for r in ranges]
    span_ms = {}
    for _, ms, corr in kernels:
        tid, ts = launches.get(corr, (None, None))
        if tid not in spans:
            continue
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and ts <= spans[tid][i][1]:
            name = spans[tid][i][2]
            span_ms[name] = span_ms.get(name, 0.0) + ms
    return [(name, ms) for name, ms, _ in kernels], span_ms


def _profile_serve(model, params, reqs, cap, serve, wall_unprofiled: float) -> dict:
    """Device time by kernel over a second, profiled run of the same serve,
    and by the port's profiler ranges (``SPANS``), each the device time of
    the kernels launched inside it (``trace_device_time``). Returns the
    ranges' device ms."""
    from torch.profiler import ProfilerActivity, profile

    trace = ROOT / "build" / "profile" / "trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(model, params, reqs, slots=SLOTS, cap=cap, scheduler="continuous")
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(trace))
    kernels, spans = trace_device_time(trace)
    trace_mb = trace.stat().st_size / 1e6
    trace.unlink()
    by_name = {}
    for key, ms in kernels:
        acc = by_name.setdefault(key, [0.0, 0])
        acc[0] += ms
        acc[1] += 1
    rows = [(key, ms, n) for key, (ms, n) in by_name.items()]
    total = sum(r[1] for r in rows)
    log(f"profile (second serve run, profiler on): wall {wall * 1e3:.1f} ms, device "
        f"busy {total:.1f} ms over {len(kernels)} kernels; against the unprofiled run's "
        f"wall {wall_unprofiled * 1e3:.1f} ms the device is idle "
        f"{100 * (1 - total / (wall_unprofiled * 1e3)):.1f}% of the time (trace "
        f"{trace_mb:.0f} MB, read in {time.perf_counter() - t0:.1f} s)")
    groups = {}
    for key, ms, n in rows:
        if "flash_fwd_wgmma_kernel" in key:
            g = "flash kernel (prefill attention)"
        elif any(w in key for w in ("gemm", "gemv", "nvjet", "xmma", "Gemv")):
            g = "cuBLAS matrix products"
        elif "copy" in key or "Memcpy" in key:
            g = "copies and casts"
        else:
            g = "other elementwise/reduction"
        acc = groups.setdefault(g, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"profile group {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{n:<6} {g}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"profile  {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{n:<6} {key[:90]}")
    rest = total - sum(spans.values())
    for key, ms in sorted(spans.items(), key=lambda kv: -kv[1]) + [("rest", rest)]:
        log(f"profile split {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  "
            f"{SPANS.get(key, 'the rest (norms, MLPs, embed, unembed, cache copies)')}")
    return spans


@contextlib.contextmanager
def plain_flash():
    """Prefill attention through the flash kernel's plain version instead of
    the kernel, inside the block (the parity phases only)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as tattn

    def plain_attention(q, k, v, *, causal=True, scale=None, blocks=None):
        bq, bk = blocks or ops.tuned_flash_blocks(q.shape[2], q.shape[3], q.element_size())
        return fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                        block_q=bq, block_k=bk)

    kernel_attention = tattn.kops.attention
    tattn.kops.attention = plain_attention
    try:
        yield
    finally:
        tattn.kops.attention = kernel_attention


def check_logits(arch, cfg, got, want, note: str = "", s: int = 513,
                 tol: float = LOGIT_TOL) -> None:
    """Fail unless the kernel prefill's last logits are finite, [1, 1, V] and
    within ``tol`` of the plain prefill's (a prompt of ``s`` tokens)."""
    import torch

    dtype = got.dtype
    got, want = got.float(), want.float()
    diff = float((got - want).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0))
    log(f"parity {arch} S={s} last logits {tuple(got.shape)} {dtype}{note}: "
        f"max|kernel-plain|={diff:.4e} (tol {tol}), cosine {cos:.6f}, |logits| max "
        f"{float(want.abs().max()):.3f}, argmax {int(got.argmax())} vs {int(want.argmax())}")
    if not torch.isfinite(got).all() or got.shape != (1, 1, cfg.vocab) or diff > tol:
        fail(f"{arch}: prefill through the kernel disagrees with the plain version")


@contextlib.contextmanager
def recorded(module, name, record):
    """Wrap ``module.name`` so that ``record(args, out)`` sees every call
    inside the block (the port's blocks look it up at call time)."""
    orig = getattr(module, name)

    def wrapper(*args):
        out = orig(*args)
        return record(args, out) or out

    setattr(module, name, wrapper)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def moe_loop(cfg, p, x):
    """The MoE layer for x [1, S, D] as a loop over its kept assignments, in
    f32 on the card: an assignment is kept when fewer than the capacity
    earlier ones (token-major, then k) went to its expert, and the first
    one to expert 0 is lost when a drop follows it, as in the reference
    (ROADMAP Queue C). Routing is the port's (held against the reference on
    the CPU). Returns (y [S, D] f32, dropped, whether slot (0, 0) emptied)."""
    import torch
    from repro_torch.models import moe as moe_mod

    idx, gates, _ = moe_mod.route(cfg, p, x)
    s, k, e = x.shape[1], cfg.moe.top_k, cfg.moe.n_experts
    cap = max(1, int(s * k * cfg.moe.capacity_factor / e))
    flat, flat_g = idx[0].reshape(-1).tolist(), gates[0].reshape(-1).float()
    seen, kept, drops = {}, [], []
    for j, ex in enumerate(flat):
        seen[ex] = seen.get(ex, 0) + 1
        (kept if seen[ex] <= cap else drops).append(j)
    first0 = flat.index(0) if 0 in flat else None
    emptied = first0 is not None and bool(drops) and drops[-1] > first0
    if emptied:
        kept.remove(first0)
    y = torch.zeros((s, cfg.d_model), device=x.device)
    for ex in sorted({flat[j] for j in kept}):
        js = torch.tensor([j for j in kept if flat[j] == ex], device=x.device)
        xt = x[0, js // k].float()
        h, g = xt @ p["w1"][ex].float(), xt @ p["w3"][ex].float()
        out = (torch.nn.functional.silu(h) * g) @ p["w2"][ex].float()
        y.index_add_(0, js // k, out * flat_g[js, None])
    return y, len(drops), emptied


def check_mixers(arch, cfg, layers) -> None:
    """At full width on the card, where the pattern has one: the first MoE
    layer against ``moe_loop`` at S=77 (capacity drops included), the first
    mamba layer's chunked prefill at S=300 (a whole chunk and a ragged one)
    against its decode stepped token by token, and the first mLSTM and
    sLSTM layers' prefill against their decode stepped in f32."""
    import torch
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.transformer import group_views

    dev = layers[0]["norm1"]["w"].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    pattern = cfg.pattern()
    first = lambda kind: next((i for i, kinds in enumerate(pattern) if kind in kinds), None)
    mixer = lambda pp: group_views(layers[pp])[0]["mixer"]
    if first("moe") is not None:
        check_moe_layer(arch, cfg, group_views(layers[first("moe")])[0]["mlp"],
                        first("moe"), gen)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    randn = lambda s: torch.randn((1, s, cfg.d_model), generator=gen,
                                  device=dev).to(torch.bfloat16)
    if first("mlstm") is not None:
        pp = first("mlstm")
        for s in MLSTM_S:
            r = min(cfg.mlstm_chunk, s)
            while s % r:
                r //= 2
            check_recurrent(arch, f"mLSTM layer {pp} at S={s} (chunks of {r})",
                            cfg, cfg32, mixer(pp), randn(s), xlstm.mlstm_forward,
                            xlstm.mlstm_decode,
                            lambda c, dt: xlstm.init_mlstm_cache(c, 1, dev),
                            f32_prefill=True)
    if first("slstm") is not None:
        pp = first("slstm")
        check_recurrent(arch, f"sLSTM layer {pp} at S=300", cfg, cfg32, mixer(pp),
                        randn(300), xlstm.slstm_forward, xlstm.slstm_decode,
                        lambda c, dt: xlstm.init_slstm_cache(c, 1, dev),
                        f32_prefill=True)
    if first("mamba") is not None:
        pp = first("mamba")
        check_recurrent(arch, f"mamba layer {pp} at S=300 (chunk {cfg.ssm_chunk}: one "
                        f"whole, one ragged)", cfg, cfg32, mixer(pp), randn(300),
                        ssm.mamba_forward, ssm.mamba_decode,
                        lambda c, dt: ssm.init_mamba_cache(c, 1, dt, dev), state=("h",))


def check_recurrent(arch, what, cfg, cfg32, p, x, forward, decode, init_cache,
                    state=None, f32_prefill=False) -> None:
    """A recurrent mixer's bf16 prefill of ``x`` against its decode stepped
    token by token in f32 (on f32 copies of the weights and input): each
    final state leaf (``state``, default all) within STATE_RTOL*|f32| +
    MAMBA_ATOL_RMS*rms(f32); the output within MAMBA_RTOL*|f32| +
    MAMBA_ATOL_RMS*rms(f32), or with ``f32_prefill`` (the xLSTM mixers) with
    a max error at most XLSTM_BF16_MULTIPLE times the bf16 stepped decode's
    own, and then also the f32 prefill's output and state within
    XLSTM_F32_RTOL*|f32| + XLSTM_F32_ATOL_RMS*rms(f32)."""
    import torch

    def stepped(cfg_, p_, x_, dtype):
        cache = init_cache(cfg_, dtype)
        steps = []
        for t in range(x_.shape[1]):
            yt, cache = decode(cfg_, p_, x_[:, t:t + 1], cache)
            steps.append(yt)
        return torch.cat(steps, dim=1), cache

    p32 = {k: v.float() for k, v in p.items()}
    want, want_st = stepped(cfg32, p32, x.float(), torch.float32)
    y, st = forward(cfg, p, x, return_state=True)
    y_dec, st_dec = stepped(cfg, p, x, torch.bfloat16)
    keys = state or sorted(st)
    err = float((y.float() - want).abs().max())
    err_dec = float((y_dec.float() - want).abs().max())
    bad, worst = outside(y, want, MAMBA_RTOL, MAMBA_ATOL_RMS)
    _, worst_dec = outside(y_dec, want, MAMBA_RTOL, MAMBA_ATOL_RMS)
    states = {key: outside(st[key], want_st[key], STATE_RTOL, MAMBA_ATOL_RMS) for key in keys}
    states_dec = {key: outside(st_dec[key], want_st[key], STATE_RTOL, MAMBA_ATOL_RMS)[1]
                  for key in keys}
    line = (f"mixers {arch}: {what} in bf16 against the decode stepped in f32: prefill "
            f"output max|bf16-f32|={err:.3e} (the bf16 stepped decode's {err_dec:.3e}), "
            f"rms(f32) {float(want.pow(2).mean().sqrt()):.3e}, {bad} outside "
            f"{MAMBA_RTOL}*|f32| + {MAMBA_ATOL_RMS}*rms, worst at {worst:.3f}; final state "
            f"(outside {STATE_RTOL}*|f32| + {MAMBA_ATOL_RMS}*rms, worst): "
            + ", ".join(f"{k} {n} ({w:.3f})" for k, (n, w) in states.items())
            + f"; the bf16 stepped decode's own worst: output {worst_dec:.3f}, state "
            + ", ".join(f"{k} {w:.3f}" for k, w in states_dec.items()))
    failed = any(n for n, _ in states.values()) or not torch.isfinite(y).all()
    if f32_prefill:
        y32, st32 = forward(cfg32, p32, x.float(), return_state=True)
        exact = {key: outside(val, ref, XLSTM_F32_RTOL, XLSTM_F32_ATOL_RMS)
                 for key, val, ref in [("output", y32, want)]
                 + [(k, st32[k], want_st[k]) for k in keys]}
        line += (f"; the f32 prefill (outside {XLSTM_F32_RTOL:.3g}*|f32| + "
                 f"{XLSTM_F32_ATOL_RMS:.3g}*rms, worst): "
                 + ", ".join(f"{k} {n} ({w:.3f})" for k, (n, w) in exact.items())
                 + f"; bf16 output error {err / max(err_dec, 1e-30):.3f} of the stepped "
                 f"decode's (limit {XLSTM_BF16_MULTIPLE})")
        failed |= any(n for n, _ in exact.values()) or err > XLSTM_BF16_MULTIPLE * err_dec
    else:
        failed |= bool(bad)
    log(line)
    if failed:
        fail(f"{arch}: the {what} prefill disagrees with the f32 stepped decode")


def check_moe_layer(arch, cfg, p, pp, gen) -> None:
    """The MoE layer at pattern position ``pp`` against ``moe_loop`` at S=77."""
    import torch
    from repro_torch.models import moe as moe_mod

    x = torch.randn((1, 77, cfg.d_model), generator=gen, device=gen.device).to(torch.bfloat16)
    y, _ = moe_mod.apply_moe(cfg, p, x)
    want, dropped, emptied = moe_loop(cfg, p, x)
    bad, worst = outside(y[0], want, MOE_RTOL, MOE_ATOL_RMS)
    log(f"mixers {arch}: MoE layer {pp} at S=77 against the loop over kept assignments "
        f"({dropped} of {77 * cfg.moe.top_k} dropped, slot (0, 0) emptied: {emptied}): "
        f"max|layer-loop|={float((y[0].float() - want).abs().max()):.3e}, rms(loop) "
        f"{float(want.pow(2).mean().sqrt()):.3e}, {bad} outside {MOE_RTOL}*|loop| + "
        f"{MOE_ATOL_RMS}*rms, worst at {worst:.3f} of the limit")
    if bad or not torch.isfinite(y).all():
        fail(f"{arch}: the MoE layer disagrees with the loop over its kept assignments")


def serve_arch(arch: str, n_layers: int, dtype: str = "") -> int:
    """Serve ``arch`` at full width with ``n_layers`` layers (its own depth,
    or cut to fit the card): init from a seeded generator, the 8 requests
    through the continuous engine (checked and counted), a profiled second
    run, and the S=513 parity of kernel and plain attention. With MoE layers
    also: the same 8 requests served again with the tokens that differ
    counted, the profiled run's MoE drop record, and the parity with the
    kernel run's routing pinned. With ``dtype`` ("float16") the config's
    parameters and compute take that dtype: its flash launches are that
    dtype's kernel's (the bf16 kernel must launch none), the parity limit
    is F16_LOGIT_TOL, and there is no profiled second run. Frees the
    weights. Returns the flash launches of the counted serve."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    key = {"": "flash_attention", "float16": "flash_attention_f16"}[dtype]
    kinds = [(cfg.mixer_kind(i), cfg.mlp_kind(i)) for i in range(n_layers)]
    count = lambda kind: sum(kind in k for k in kinds)
    n_attn, n_moe = count("attention"), count("moe")
    depth = (f"depth cut {full.n_layers} -> {n_layers} layers (dataclasses.replace(cfg, "
             f"n_layers={n_layers}))" if n_layers < full.n_layers
             else f"uncut ({n_layers} layers)")
    experts = (f", experts {cfg.moe.n_experts} top-{cfg.moe.top_k} of width "
               f"{cfg.moe.d_expert}, capacity factor {cfg.moe.capacity_factor}"
               if cfg.moe else "")
    log(f"{arch}: {depth}, every width as published "
        f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}{experts}; {cfg.norm}, {cfg.activation}, "
        f"QKV bias {cfg.qkv_bias}); layers: "
        f"{n_attn} attention, {count('mamba')} mamba, {count('mlstm')} mLSTM, "
        f"{count('slstm')} sLSTM, {n_moe} MoE, {count('dense')} dense; "
        f"{cfg.param_count() / 1e9:.3f} B of {full.param_count() / 1e9:.3f} B parameters "
        f"by the config's count; parameters {cfg.param_dtype}, compute {cfg.compute_dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device=model.device).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init {arch}: {n_params / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, peak during init "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}, "
        f"{time.perf_counter() - t0:.3f} s")
    check_mixers(arch, cfg, params["layers"])
    rng = np.random.default_rng(SEED)
    cap = max(PROMPT_LENS) + MAX_NEW + 2

    def requests():
        return [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, n)], MAX_NEW)
                for i, n in enumerate(PROMPT_LENS)]

    # warm-up (library handles, first launches); not counted
    serve(model, params, [Request(0, list(range(1, 65)), 2)], slots=SLOTS,
          cap=cap, scheduler="continuous")
    reqs = requests()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats = serve(model, params, reqs, slots=SLOTS, cap=cap, scheduler="continuous")
    launches = ops.launch_counts()
    log(f"serve {arch}: {stats['tokens']} tokens in {stats['wall_s']:.3f} s "
        f"({stats['tok_per_s']:.1f} tok/s), TTFT p50 {stats['ttft_s']['p50']:.4f} s "
        f"p99 {stats['ttft_s']['p99']:.4f} s, latency p50 "
        f"{stats['latency_s']['p50']:.4f} s p99 {stats['latency_s']['p99']:.4f} s, "
        f"{stats['engine_steps']} decode steps, {stats['prefills']} prefills, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    if any(len(r.out) != MAX_NEW for r in reqs):
        fail(f"{arch}: a request got too few tokens: {[len(r.out) for r in reqs]}")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.out):
        fail(f"{arch}: a token outside the vocabulary")
    if stats["prefills"] != len(PROMPT_LENS):
        fail(f"{arch}: {stats['prefills']} prefills for {len(PROMPT_LENS)} requests")
    if launches[key] != stats["prefills"] * n_attn:
        fail(f"{arch}: {key} launches {launches[key]} != prefills x "
             f"attention layers {stats['prefills'] * n_attn}")
    if dtype and launches["flash_attention"]:
        fail(f"{arch} in {dtype}: the bf16 flash kernel launched "
             f"{launches['flash_attention']} times")

    if dtype:
        log(f"profile {arch} {dtype}: no profiled second run (the bf16 serve's covers "
            f"the same path)")
    elif n_moe:
        # run-to-run determinism: the combine gathers each token's k slot
        # outputs and sums them in f32 in top-k order, with no atomics, so
        # the same requests must give the same tokens
        again = [Request(r.rid, list(r.prompt), MAX_NEW) for r in reqs]
        serve(model, params, again, slots=SLOTS, cap=cap, scheduler="continuous")
        differ = [sum(a != b for a, b in zip(r.out, r2.out)) for r, r2 in zip(reqs, again)]
        first = [next((i for i, (a, b) in enumerate(zip(r.out, r2.out)) if a != b), None)
                 for r, r2 in zip(reqs, again)]
        log(f"determinism {arch}: the same {len(reqs)} requests served again: "
            f"{sum(differ)} of {sum(len(r.out) for r in reqs)} tokens differ (per "
            f"request {differ}; first differing position {first})")
        if sum(differ):
            fail(f"{arch}: a second serve of the same requests gave other tokens")
        # profiled second run, with every MoE dispatch plan recorded on the card
        plans = []
        with recorded(moe_mod, "dispatch_plan", lambda args, out: plans.append(
                (args[0].shape[0], args[0].shape[1], args[2], (~out[2]).sum(),
                 out[2].numel(), out[3].sum()))):
            spans = _profile_serve(model, params, requests(), cap, serve, stats["wall_s"])
        log(f"combine {arch}: moe.gather_scatter span (the dispatch gather and the "
            f"f32 gather-and-reduce combine) {spans.get('moe.gather_scatter', 0.0):.3f} ms "
            f"of device time over the profiled serve ({nvidia_smi('name,power.limit')})")
        log_moe_plans(arch, plans, n_moe)
    elif n_attn:
        _profile_serve(model, params, requests(), cap, serve, stats["wall_s"])
    else:
        # the recurrent serve launches about 6 M kernels (the mLSTM runs one
        # token per chunk at 77, 513 and 2047 tokens): too many to trace in
        # the smoke's time. Its profile is one of those requests, S=77,
        # against the same request served unprofiled
        one = lambda: [Request(0, list(reqs[PROMPT_LENS.index(77)].prompt), MAX_NEW)]
        t0 = time.perf_counter()
        serve(model, params, one(), slots=SLOTS, cap=cap, scheduler="continuous")
        wall_one = time.perf_counter() - t0
        log(f"profile {arch}: the second run is cut to one request (S=77, chunks of 1, "
            f"{MAX_NEW} tokens): unprofiled {wall_one:.3f} s")
        _profile_serve(model, params, one(), cap, serve, wall_one)

    # parity: with MoE layers the routing of the kernel prefill is recorded
    # and pinned in the plain prefill. Routing is a discontinuous function of
    # the hidden state: an ulp of difference in attention can move a near-tie
    # assignment to another expert, a different computation rather than an
    # error of the kernel, so the limit is held with the kernel run's
    # routing; the plain prefill's own routing is reported beside it.
    prompt = torch.tensor([[int(t) for t in rng.integers(0, cfg.vocab, 513)]],
                          dtype=torch.int32, device=model.device)
    if not n_attn:
        log(f"parity {arch}: skipped: the kernel-vs-plain prefill parity compares "
            f"attention, and {arch} has no attention layer (its flash launches are 0)")
    else:
        got, want, note = prefill_parity(model, params, {"tokens": prompt}, 513, n_moe > 0)
        check_logits(arch, cfg, got, want, note, tol=F16_LOGIT_TOL if dtype else LOGIT_TOL)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches[key]


def prefill_parity(model, params, batch, cap: int, pin: bool):
    """The last logits of one prefill of ``batch`` through the kernel and
    through the plain version: (kernel, plain, note). With ``pin`` (MoE
    layers) the kernel run's routing is recorded and pinned in the plain
    run. Routing is a discontinuous function of the hidden state: an ulp of
    difference in attention can move a near-tie assignment to another
    expert, a different computation rather than an error of the kernel, so
    the limit is held with the kernel run's routing; the note reports the
    plain run's own routing beside it."""
    import torch
    from repro_torch.models import moe as moe_mod

    if not pin:
        _, _, got = model.prefill(params, batch, cap)
        with plain_flash():
            _, _, want = model.prefill(params, batch, cap)
        return got, want, ""
    routes = []
    with recorded(moe_mod, "route", lambda args, out: routes.append(out[0])):
        _, _, got = model.prefill(params, batch, cap)
    with plain_flash():
        _, _, free = model.prefill(params, batch, cap)
        moved, it = [], iter(routes)

        def pin_route(args, out):
            (_, p, x), want = args, next(it)
            moved.append(int((out[0].sort(-1).values != want.sort(-1).values)
                             .any(-1).sum()))
            probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
            g = probs.gather(-1, want)
            return want, (g / g.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype), out[2]

        with recorded(moe_mod, "route", pin_route):
            _, _, want = model.prefill(params, batch, cap)
    free_diff = float((got.float() - free.float()).abs().max())
    return got, want, (f", routing of the kernel run pinned (tokens whose top-k set the "
                       f"plain attention would move, per MoE layer: {moved}; unpinned max "
                       f"|kernel-plain| {free_diff:.4e})")


def serve_prefixed(arch: str, lens) -> int:
    """The encdec-vision phase for one arch, uncut: init from a seeded
    generator, then per prompt length in ``lens`` one request (B=1, with a
    seeded stub of frames or patches at 0.1 N(0, 1)) greedily decoded to
    MAX_NEW tokens through ``Model.prefill`` and ``Model.decode_step``, the
    reference's only entry for these archs (checked and counted); a
    profiled second run of the first request; the parity of phase 7 at the
    longest prompt (513 where it fits). Frees the weights. Returns the flash launches of the
    counted run."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import latency_summary
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    dev = torch.device("cuda")
    n_attn = cfg.n_layers + cfg.n_encoder_layers
    n_prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    stub = "frames" if cfg.frontend == "audio" else "patches"
    log(f"{arch}: uncut ({cfg.n_layers} decoder layers, {cfg.n_encoder_layers} encoder "
        f"layers), every width as published (d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{cfg.norm}, {cfg.activation}, QKV bias {cfg.qkv_bias}, tied embeddings "
        f"{cfg.tie_embeddings}); {cfg.frontend} stub of {cfg.n_frontend_tokens} "
        f"{stub}; {cfg.param_count() / 1e9:.3f} B parameters by the config's count; "
        f"prompts {list(lens)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"init {arch}: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED)
    stub_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cap = max(lens) + n_prefix + MAX_NEW + 2

    def batch(n):
        tokens = torch.tensor([[int(t) for t in rng.integers(0, cfg.vocab, n)]],
                              dtype=torch.int32, device=dev)
        return {"tokens": tokens, stub: 0.1 * torch.randn(
            (1, cfg.n_frontend_tokens, cfg.d_model), generator=stub_gen, device=dev)}

    def greedy(b, max_new=MAX_NEW):
        """(tokens, seconds to the first token)."""
        t_start = time.perf_counter()
        cache, pos, last = model.prefill(params, b, cap)
        out = [int(torch.argmax(last[0, 0]))]
        ttft = time.perf_counter() - t_start
        for t in range(max_new - 1):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([out[-1]], dtype=torch.int32), pos + t)
            out.append(int(torch.argmax(logits[0])))
        return out, ttft

    greedy(batch(min(lens)), 2)  # warm-up (library handles, first launches); not counted
    batches = [batch(n) for n in lens]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    runs = [greedy(b) for b in batches]
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    tokens = sum(len(out) for out, _ in runs)
    ttft = latency_summary([t for _, t in runs])
    log(f"serve {arch} (prefill + decode_step, B=1, one request after another): {tokens} "
        f"tokens in {wall:.3f} s ({tokens / wall:.1f} tok/s), TTFT p50 {ttft['p50']:.4f} s "
        f"p99 {ttft['p99']:.4f} s, {len(runs)} prefills, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    if any(len(out) != MAX_NEW for out, _ in runs):
        fail(f"{arch}: a request got too few tokens: {[len(out) for out, _ in runs]}")
    if any(not 0 <= t < cfg.vocab for out, _ in runs for t in out):
        fail(f"{arch}: a token outside the vocabulary")
    if launches["flash_attention"] != len(runs) * n_attn:
        fail(f"{arch}: flash launches {launches['flash_attention']} != prefills x "
             f"attention layers {len(runs) * n_attn}")
    # the second run is cut to the first request: whisper's four launch
    # about a million kernels, whose trace took most of the phase to read.
    # Its profile is against the same request served unprofiled
    t0 = time.perf_counter()
    greedy(batches[0])
    wall_one = time.perf_counter() - t0
    log(f"profile {arch}: the second run is cut to one request (S={lens[0]}): "
        f"unprofiled {wall_one:.3f} s")
    _profile_serve(model, params, batches[:1], cap,
                   lambda m, p, reqs, **kw: [greedy(b) for b in reqs], wall_one)
    s = max(n for n in lens if n <= 513)
    b = batch(s)
    _, _, got = model.prefill(params, b, cap)
    with plain_flash():
        _, _, want = model.prefill(params, b, cap)
    check_logits(arch, cfg, got, want, s=s)
    del model, params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def log_moe_plans(arch, plans, n_moe) -> None:
    """The share of MoE assignments dropped per prefill and per MoE layer,
    and whether slot (0, 0) was emptied, from the recorded dispatch plans;
    fail on a drop at decode."""
    prefill_plans = [p for p in plans if p[1] > 1]
    decode_drops = sum(int(p[3]) for p in plans if p[1] == 1)
    if len(prefill_plans) != len(PROMPT_LENS) * n_moe:
        fail(f"{arch}: {len(prefill_plans)} MoE prefill plans for "
             f"{len(PROMPT_LENS)} prefills x {n_moe} MoE layers")
    for i in range(0, len(prefill_plans), n_moe):
        layer_plans = prefill_plans[i:i + n_moe]
        dropped = sum(int(p[3]) for p in layer_plans)
        assigned = sum(int(p[4]) for p in layer_plans)
        emptied = sum(int(p[5]) for p in layer_plans)
        per_layer = ", ".join(f"{100 * int(p[3]) / int(p[4]):.1f}" for p in layer_plans)
        log(f"moe {arch} prefill S={layer_plans[0][1]} capacity {layer_plans[0][2]}: "
            f"{dropped} of {assigned} assignments dropped ({100 * dropped / assigned:.2f}%; "
            f"per MoE layer, in order: {per_layer} %); slot (0, 0) emptied in {emptied} "
            f"of {n_moe} layers")
    log(f"moe {arch} decode: {len(plans) - len(prefill_plans)} plans at capacity 1, "
        f"{decode_drops} assignments dropped")
    if decode_drops:
        fail(f"{arch}: a decode step dropped an assignment (its top-k experts are distinct)")



def check_flash_grad(cases, qkv) -> float:
    """Hold dq, dk, dv through ``ops.attention`` (one kernel launch, then
    ``flash_attention_backward``) in bf16 against autograd through the plain
    version on f32 copies of the same inputs, per element within
    KERNEL_RTOL*|plain| + KERNEL_ATOL_RMS*rms(plain), and the forward's
    output against the plain version's in bf16 (``check_flash``'s limit,
    since the backward recomputes P and never reads it); log how far autograd
    through the plain version in bf16 is from the same f32 gradient, and
    fail unless the limit would catch a backward that drops the last key
    block (where that block holds 5% of the keys or more). Returns max
    |got - plain|."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def grads(fn, inputs, do):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, do)

    max_err = 0.0
    for b, hq, hkv, s, d, causal in cases:
        q, k, v = qkv(b, hq, hkv, s, d)
        do = qkv(b, hq, hkv, s, d)[0]
        bq, bk = ops.tuned_flash_blocks(s, d, 2)
        plain = lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=causal,
                                                         block_q=bq, block_k=bk)
        out, got = grads(lambda q, k, v: ops.attention(q, k, v, causal=causal), (q, k, v), do)
        f32 = [t.float() for t in (q, k, v)]
        want = grads(plain, f32, do.float())[1]
        out_plain, plain_bf16 = grads(plain, (q, k, v), do)
        keep = tail_keep(s, bk)
        dropped = [g.nan_to_num(0.0) for g in grads(
            lambda q, k, v: drop_tail(q, k, v, causal, keep), f32, do.float())[1]]
        bad_out, worst_out = outside(out, out_plain, KERNEL_RTOL, KERNEL_ATOL_RMS)
        parts, caught = [f"output {bad_out} outside, worst {worst_out:.3f} of the limit"], False
        if bad_out or not torch.isfinite(out).all():
            log(f"grad B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: {parts[0]}")
            fail(f"the flash forward under autograd disagrees at Hq={hq} Hkv={hkv} S={s} D={d}")
        for name, g, w, pb, dr in zip(("dq", "dk", "dv"), got, want, plain_bf16, dropped):
            bad, worst = outside(g, w, KERNEL_RTOL, KERNEL_ATOL_RMS)
            _, worst_pb = outside(pb, w, KERNEL_RTOL, KERNEL_ATOL_RMS)
            n_drop, worst_drop = outside(dr, w, KERNEL_RTOL, KERNEL_ATOL_RMS)
            caught = caught or n_drop > 0
            err = float((g.float() - w).abs().max())
            max_err = max(max_err, err)
            parts.append(f"{name} max err {err:.3e}, {bad} outside, worst {worst:.3f} of "
                         f"the limit (bf16 autograd through plain: {worst_pb:.3f}); a "
                         f"dropped last key block: {n_drop} outside, worst {worst_drop:.1f}")
            if bad or g.dtype != q.dtype or not torch.isfinite(g).all():
                log(f"grad B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal}: "
                    + "; ".join(parts))
                fail(f"the flash gradient {name} disagrees at Hq={hq} Hkv={hkv} S={s} D={d}")
        log(f"grad B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal={causal} blocks=({bq},{bk}), "
            f"limit {KERNEL_RTOL}*|plain f32| + {KERNEL_ATOL_RMS}*rms: " + "; ".join(parts)
            + f" (keys {keep}..{s - 1} dropped)")
        if not caught and (s - keep) * 20 >= s:
            fail(f"the gradient limit would miss a dropped last key block at S={s}")
    return max_err


@contextlib.contextmanager
def step_metrics(record: list):
    """Inside the block, every train step built by ``make_train_step``
    appends its metrics (as floats) to ``record``."""
    from repro_torch.launch import steps as steps_mod

    make = steps_mod.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch)
            record.append({k: float(v) for k, v in metrics.items()})
            return params, opt_state, metrics

        return wrapped

    steps_mod.make_train_step = recording
    try:
        yield
    finally:
        steps_mod.make_train_step = make


@contextlib.contextmanager
def leaf_grad_norms(record: list):
    """Inside the block, every optimizer update first appends the f32 norm
    of each parameter leaf's gradient to ``record``, keyed by its path (the
    leaves walked in slices of 2^26 elements, a bounded transient)."""
    from repro_torch import tree
    from repro_torch.optim import adamw

    apply = adamw.apply_updates

    def norm(g):
        return sum(float(c.float().square().sum()) for c in g.reshape(-1).split(2**26)) ** 0.5

    def recording(cfg, params, grads, *args, **kwargs):
        record.append(dict(zip(tree.paths(grads), map(norm, tree.leaves(grads)))))
        return apply(cfg, params, grads, *args, **kwargs)

    adamw.apply_updates = recording
    try:
        yield
    finally:
        adamw.apply_updates = apply


@contextlib.contextmanager
def faulty_attention(kind: str):
    """Inside the block attention is wrong, the controls of the train
    parity: ``"batch_offset"`` attends every batch row to row 0's keys and
    values (a kernel that lost its batch offset), ``"half_dq"`` halves the
    backward's dq, and ``"drop_last_block"`` gives the backward of an
    attention that skips the last key block (``tail_keep``), by autograd
    through ``drop_tail`` in f32."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as tattn

    backward, kernel_attention = fa.flash_attention_backward, tattn.kops.attention

    def batch_offset(q, k, v, **kwargs):
        first = lambda t: t[:1].expand_as(t).contiguous()
        return kernel_attention(q, first(k), first(v), **kwargs)

    def half_dq(q, k, v, do, **kwargs):
        dq, dk, dv = backward(q, k, v, do, **kwargs)
        return dq * 0.5, dk, dv

    def drop_last_block(q, k, v, do, *, causal, scale):
        s, d = q.shape[2], q.shape[3]
        keep = tail_keep(s, ops.tuned_flash_blocks(s, d, 2)[1])
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            grads = torch.autograd.grad(drop_tail(*leaves, causal, keep), leaves, do.float())
        return tuple(g.nan_to_num(0.0).to(t.dtype) for g, t in zip(grads, (q, k, v)))

    if kind == "batch_offset":
        tattn.kops.attention = batch_offset
    else:
        fa.flash_attention_backward = {"half_dq": half_dq,
                                       "drop_last_block": drop_last_block}[kind]
    try:
        yield
    finally:
        fa.flash_attention_backward, tattn.kops.attention = backward, kernel_attention


def _train_state(out):
    """The leaves of a train run's (params, opt_state) in the reference's
    order (dict keys sorted: a restored tree's dicts are built in that
    order, a drawn one's in insertion order)."""
    from repro_torch import tree

    return tree.leaves((out["params"], out["opt_state"]))


def _bit_diff(a, b) -> list:
    """Leaves (by index) whose dtype or bits differ between two train runs."""
    import torch

    return [i for i, (x, y) in enumerate(zip(_train_state(a), _train_state(b)))
            if x.dtype != y.dtype or not torch.equal(x, y)]


def _digests(out) -> list:
    """The sha1 of each leaf's bytes of a train run's (params, opt_state),
    in leaf order, taken on the host (a DTensor's whole tensor; bf16 as
    its 16-bit patterns), hashed on 8 threads while the next leaves copy."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    def host(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()

    with ThreadPoolExecutor(8) as pool:
        futures = []
        for t in _train_state(out):
            futures.append(pool.submit(lambda a: hashlib.sha1(memoryview(a).cast("B"))
                                       .hexdigest(), host(t)))
            while sum(not f.done() for f in futures) > 16:  # bound the host copies
                time.sleep(0.01)
        return [f.result() for f in futures]


def _local_state(out) -> list:
    """A train run's leaves as local tensors (a one-rank mesh's DTensors
    whole)."""
    return [t.to_local() if hasattr(t, "to_local") else t for t in _train_state(out)]


def mesh_phase(train: dict) -> dict:
    """The mesh phase (7c of the docstring): yi-6b uncut on a 1x1 mesh
    against the ``train`` phase's run, the elastic resume, the collectives.
    Returns its flash launches and readings."""
    import statistics

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import collectives
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.pipeline import pipeline_apply

    mesh_mod.init_process_group("cuda")
    log(f"mesh: a one-rank {dist.get_backend()} group, world {dist.get_world_size()}")
    cfg = get_config(ARCH)
    opts = train_mod.TrainOptions(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                                  state_dtype="bfloat16", log_every=1, seed=SEED,
                                  mesh_shape=(1, 1))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    steps_seen = []
    t0 = time.perf_counter()
    with step_metrics(steps_seen):
        out = train_mod.train(cfg, opts)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [loss for _, loss, _ in out["history"]]
    secs = [dt for _, _, dt in out["history"]]
    med = statistics.median(secs)
    leaf = _train_state(out)[0]
    t_dig = time.perf_counter()
    digests = _digests(out)
    differ = [i for i, (a, b) in enumerate(zip(digests, train["digests"])) if a != b]
    log(f"mesh {ARCH} uncut on a 1x1 mesh ({type(leaf).__name__} leaves, placements "
        f"{tuple(leaf.placements)}): {TRAIN_STEPS} steps in {wall:.1f} s (init included); "
        f"step seconds {[round(x, 4) for x in secs]}, median {med:.4f} s against the "
        f"meshless {train['median_step_s']:.4f} s ({med - train['median_step_s']:+.4f} s); "
        f"peak {peak:.2f} GiB (meshless {train['peak_gib']:.2f}); flash launches {launches}; "
        f"losses {losses} against {train['losses']}; {len(differ)} of {len(digests)} leaf "
        f"digests differ {differ[:8]} ({time.perf_counter() - t_dig:.1f} s)")
    want = TRAIN_STEPS * cfg.n_layers * 2
    if launches != want:
        fail(f"mesh flash launches {launches} != steps x layers x 2 = {want}")
    if losses != train["losses"]:
        fail("the 1x1 mesh's loss history is not bit-equal to the meshless run's")
    if differ or len(digests) != len(train["digests"]):
        fail("a 1x1 mesh leaf is not bit-equal to the meshless run's")

    # a fifth step, profiled, on the mesh (its context installed, as train does)
    mesh = leaf.device_mesh
    model = Model(cfg)
    step_fn = steps_mod.make_train_step(
        model, AdamWConfig(lr=opts.lr, state_dtype="bfloat16"),
        grad_shardings=sh.params_sharding(out["params"], mesh))
    batch = SyntheticTokens(SyntheticConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=SEED)).batch(
        TRAIN_STEPS)
    trace = ROOT / "build" / "profile" / "mesh_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    pctx.install(("data",), tp_size=1, sp_seq=False, mesh=mesh)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(out["params"], out["opt_state"], batch)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    finally:
        pctx.clear()
    prof.export_chrome_trace(str(trace))
    kernels, spans = trace_device_time(trace)
    trace.unlink()
    busy = sum(ms for _, ms in kernels)
    idle = 1 - busy / (prof_wall * 1e3)
    split = {name: spans.get(key, 0.0) for key, name in TRAIN_SPANS.items()}
    split["the rest"] = busy - sum(split.values())
    log(f"mesh profile (a fifth step on the 1x1 mesh, profiler on): device busy "
        f"{busy:.1f} ms over {len(kernels)} kernels in the step's own wall "
        f"{prof_wall * 1e3:.1f} ms: idle {100 * idle:.1f}% (meshless "
        f"{100 * train['idle']:.1f}%); by span: " + ", ".join(
            f"{name} {ms:.1f} ms ({100 * ms / busy:.1f}%)" for name, ms in split.items()))
    del out, model, step_fn, leaf, mesh
    gc.collect()
    torch.cuda.empty_cache()

    # -- elastic: saved meshless at step 2, restored onto the 1x1 mesh
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    kw = dict(steps=RESUME_STEPS, batch=RESUME_B, seq=RESUME_S, state_dtype="int8",
              accum_steps=2, grad_compression="int8", log_every=1, seed=SEED)
    first = train_mod.train(cfg2, train_mod.TrainOptions(**kw))
    ckpt = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        train_mod.train(cfg2, train_mod.TrainOptions(
            ckpt_dir=str(ckpt), ckpt_every=2, **dict(kw, steps=2)))
        resumed = train_mod.train(cfg2, train_mod.TrainOptions(
            ckpt_dir=str(ckpt), ckpt_every=RESUME_STEPS, mesh_shape=(1, 1), **kw))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    differ = [i for i, (a, b) in enumerate(zip(_local_state(first), _local_state(resumed)))
              if a.dtype != b.dtype or not torch.equal(a, b)]
    n_leaves = len(_train_state(first))
    log(f"mesh elastic: meshless to step 2, restored onto the 1x1 mesh, ended at step "
        f"{resumed['final_step']}: {len(differ)} of {n_leaves} leaves differ from the "
        f"uninterrupted meshless run {differ[:8]}; {time.perf_counter() - t0:.1f} s")
    if resumed["final_step"] != RESUME_STEPS or differ:
        fail("the resume onto the 1x1 mesh is not bit-equal to the uninterrupted run")
    del first, resumed
    gc.collect()
    torch.cuda.empty_cache()

    # -- the collectives on the one-rank group
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g = torch.randn(cfg.d_model, cfg.d_ff, generator=gen, device="cuda").to(torch.bfloat16)
    want_g = collectives.int8_compress_decompress({"g": g.clone()})["g"]
    got_g = collectives.psum_int8(g)
    pmesh = mesh_mod.make_mesh((1, 1), ("pod", "model"))
    d = cfg.d_model
    w = (torch.randn(1, d, d, generator=gen, device="cuda") * d ** -0.5).to(torch.bfloat16)
    b = (torch.randn(1, d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    x = torch.randn(4, 2, 128, d, generator=gen, device="cuda").to(torch.bfloat16)
    stage_fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    placed = sh.distribute({"w": w, "b": b}, {"w": (Shard(0), Replicate()),
                                              "b": (Shard(0), Replicate())}, pmesh)
    got_p = pipeline_apply(stage_fn, placed, x, mesh=pmesh, axis="pod")
    want_p = torch.stack([stage_fn({"w": w[0], "b": b[0]}, x[i]) for i in range(x.shape[0])])
    psum_ok, pipe_ok = torch.equal(got_g, want_g), torch.equal(got_p, want_p)
    log(f"mesh collectives: psum_int8 over the one-rank group of a [{cfg.d_model}, "
        f"{cfg.d_ff}] bf16 gradient {'equals' if psum_ok else 'differs from'} "
        f"int8_compress_decompress; a one-stage pipeline_apply of 4 microbatches "
        f"{'equals' if pipe_ok else 'differs from'} its stage function")
    if not psum_ok:
        fail("psum_int8 over one rank is not int8_compress_decompress")
    if not pipe_ok:
        fail("a one-stage pipeline is not its stage function")
    dist.destroy_process_group()

    result = {"arch": ARCH, "mesh": [1, 1], "step_s": secs, "median_step_s": med,
              "meshless_median_step_s": train["median_step_s"], "peak_gib": peak,
              "device_busy_ms": busy, "idle": idle, "spans_ms": split,
              "profiled_step_s": prof_wall, "losses": losses, "launches": launches,
              "digests_equal": len(digests)}
    print("mesh " + json.dumps(result), flush=True)
    return result


def dryrun_phase(train: dict, mesh: dict) -> dict:
    """The dry-run phase (7d of the docstring): the card's own training cell
    predicted and held against the ``mesh`` phase's measured peak, then the
    production cells. Touches no card."""
    from repro_torch.configs.base import get_config
    from repro_torch.hw.gpu_h100 import HBM_BYTES
    from repro_torch.launch import dryrun

    cfg = get_config(ARCH)
    card = dryrun.run_cell(
        "yi_6b", "train_4k", mesh={"data": 1, "model": 1}, verbose=False,
        variant={"state_dtype": "bfloat16", "accum_steps": 1},
        spec={"kind": "train", "seq": TRAIN_S, "batch": TRAIN_B})
    mem = card["mem"]
    predicted = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
    measured = mesh["peak_gib"]
    n_params = cfg.param_count()
    analytic = 6 * n_params * TRAIN_B * TRAIN_S
    colls = sum(card["collective_counts"].values())
    log(f"dryrun card cell {ARCH} uncut B={TRAIN_B} x S={TRAIN_S}, bf16 moments, 1x1 "
        f"(traced in {card['lower_s']} s on the host): predicted peak {predicted:.2f} GiB "
        f"(arguments {mem['argument_bytes'] / 2**30:.2f} + temporaries "
        f"{mem['temp_bytes'] / 2**30:.2f}) against the mesh phase's measured "
        f"{measured:.2f} GiB ({100 * (predicted / measured - 1):+.2f}%; meshless "
        f"{train['peak_gib']:.2f} GiB), limit {DRYRUN_PEAK_RTOL:.0%}; counted flops "
        f"{card['hlo_flops']:.4e} against the analytic 6 N T {analytic:.4e} "
        f"({card['hlo_flops'] / analytic:.3f}x: the remat recompute and attention); "
        f"{colls} collectives")
    if card["status"] != "ok" or colls:
        fail(f"the one-rank dry run did not trace clean: {card['status']}, {colls} "
             "collectives")
    if abs(predicted - measured) > DRYRUN_PEAK_RTOL * measured:
        fail(f"the dry run's peak {predicted:.2f} GiB is not within "
             f"{DRYRUN_PEAK_RTOL:.0%} of the measured {measured:.2f} GiB")
    # the reference's mini cells, reduced, and reduced xlstm's meshed decode
    mini = {}
    for name, (arch, cell_mesh, ref_op, ref_link) in DRYRUN_MINI.items():
        rec = dryrun.run_cell(arch, "train_4k", mesh=cell_mesh, verbose=False,
                              cfg=get_config(arch).reduced())
        op = sum(rec.get("collective_operand_bytes_scaled", {}).values())
        link = sum(rec.get("collective_link_bytes_scaled", {}).values())
        top = DRYRUN_MOE_RATIO if arch.startswith("qwen3_moe") else DRYRUN_RATIO
        log(f"dryrun mini cell {name} (reduced, train_4k): {rec['status']} in "
            f"{rec.get('lower_s')} s; scaled operand bytes {op:.4e} against the "
            f"reference's {ref_op:.4e} ({op / ref_op:.3f}x), link bytes {link:.4e} against "
            f"{ref_link:.4e} ({link / ref_link:.3f}x), limit {top}x")
        if rec["status"] != "ok" or op > top * ref_op or link > top * ref_link:
            fail(f"the mini cell {name} moves more than {top}x the reference's bytes "
                 f"or did not trace: {rec.get('status')}, {op / ref_op:.3f}x, "
                 f"{link / ref_link:.3f}x")
        mini[name] = {"operand": op, "link": link, "ref_operand": ref_op,
                      "ref_link": ref_link, "lower_s": rec["lower_s"]}
    rec = dryrun.run_cell("xlstm_13b", "decode_32k", mesh={"data": 2, "model": 4},
                          verbose=False, cfg=get_config("xlstm_13b").reduced())
    log(f"dryrun xlstm-1.3b reduced x decode_32k x 2x4: {rec['status']} in "
        f"{rec.get('lower_s')} s (the sLSTM's and mLSTM's decode steps on each rank's "
        f"rows)")
    if rec["status"] != "ok":
        fail(f"reduced xlstm's meshed decode did not trace: {rec}")
    mini["xlstm decode 2x4"] = {"status": rec["status"], "lower_s": rec["lower_s"]}
    cells = {}
    for shape in DRYRUN_SHAPES:
        rec = dryrun.run_cell("yi_6b", shape, verbose=False)
        m = rec.get("mem", {})
        gib = (m.get("argument_bytes", 0) + m.get("temp_bytes", 0)) / 2**30
        kinds = {k: v for k, v in rec.get("collective_counts_scaled", {}).items() if v}
        op = sum(rec.get("collective_operand_bytes_scaled", {}).values())
        log(f"dryrun {ARCH} x {shape} x {rec['mesh']} ({rec['n_devices']} fake ranks): "
            f"{rec['status']} in {rec.get('lower_s')} s; per device {gib:.2f} GiB of the "
            f"card's {HBM_BYTES / 2**30:.0f} (arguments "
            f"{m.get('argument_bytes', 0) / 2**30:.2f}, temporaries "
            f"{m.get('temp_bytes', 0) / 2**30:.2f}); flops {rec.get('hlo_flops', 0):.4e}; "
            f"collectives (scaled) {kinds}, operand bytes {op:.4e} (before the "
            f"layout regions: {DRYRUN_BEFORE[shape]:.4e})")
        if rec["status"] != "ok" or gib * 2**30 > HBM_BYTES:
            fail(f"the dry run of {ARCH} x {shape} on 16x16 did not trace or does not "
                 f"fit: {rec}")
        if shape == "train_4k" and op > DRYRUN_BEFORE[shape]:
            fail(f"the train cell's operand bytes {op:.4e} exceed the "
                 f"{DRYRUN_BEFORE[shape]:.4e} before the layout regions")
        cells[shape] = {k: rec[k] for k in (
            "status", "lower_s", "n_devices", "accum_steps", "hlo_flops", "hlo_bytes", "mem",
            "collective_counts", "collective_counts_scaled",
            "collective_operand_bytes_scaled", "collective_link_bytes_scaled") if k in rec}
    result = {"mini": mini, "card": {"predicted_peak_gib": predicted, "measured_peak_gib": measured,
                       "meshless_peak_gib": train["peak_gib"], "rtol": DRYRUN_PEAK_RTOL,
                       "mem": mem, "flops": card["hlo_flops"], "analytic_flops": analytic,
                       "lower_s": card["lower_s"]},
              "production": cells}
    print("dryrun " + json.dumps(result, default=float), flush=True)
    return result


def controller_phase(gen) -> dict:
    """The controller phase (7e of the docstring). Returns the matmul
    launches at the served blocks and the worst error against the plain
    version."""
    import urllib.parse
    import urllib.request

    import torch

    from repro_torch.benchmarks.topk_ratio import YI6B_SHAPES
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops
    from repro_torch.tuna.controller import ControllerConfig, FleetController, start_http

    from repro_torch.tuna import fleet
    from repro_torch.tuna.transport import resolve_transport

    base = ROOT / "build" / "controller"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    db = base / "fleet.jsonl"
    bucket, published = f"dir://{base / 'bucket'}", f"dir://{base / 'published'}"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_TUNA_DB", None)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tuna", "controller", "--db", str(db), "--smoke",
         "--targets", "gpu_h100", "--num-shards", "2", "--transport", bucket,
         "--publish", published, "--worker-mode", "process", "--inject-crash-shard", "0",
         "--exit-when-converged", "--port", "0"],
        env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    exit_line = next((line for line in res.stdout.splitlines() if "exit:" in line), "")
    pushed = sorted(p.name for p in (base / "published").glob("*"))
    log(f"controller CLI ({cli_s:.1f} s): exit {res.returncode}; {exit_line.strip()}; "
        f"published {pushed}")
    if res.returncode or "exit: converged" not in exit_line:
        fail(f"the controller did not converge: {res.stdout[-2000:]} {res.stderr[-2000:]}")
    healed = int(exit_line.split(" shards healed")[0].rsplit(", ", 1)[-1])
    if healed < 1:
        fail(f"the controller healed no shard: {exit_line}")
    if not any(name.startswith("schedule_cache") for name in pushed):
        fail(f"the controller published no snapshot: {pushed}")

    # a third host joins with its own store (the schedule-store phase's,
    # yi-6b's matmul shapes among its records), pushed as shard 2
    resolve_transport(bucket).push(str(ROOT / "build" / "schedule_store" / "db.jsonl"),
                                   fleet.shard_object_name(str(db), 2))
    ctl = FleetController(ControllerConfig(
        db=str(db), ops=["dense_256", "batch_matmul"], targets=["gpu_h100"], num_shards=3,
        transport=bucket, quiet=True))
    if ctl.run(exit_when_converged=True) != 0 or not ctl.converged \
            or ctl.metrics.get("jobs_dispatched_total"):
        fail("the resumed controller did not converge without dispatching")
    server = start_http(ctl)
    port = server.server_address[1]
    launches, worst, served = 0, 0.0, {}
    try:
        for m, n, k in YI6B_SHAPES:
            sig = MatmulSpace(m, n, k, 2, target_kind="sm90").signature()
            url = f"http://127.0.0.1:{port}/schedule?op={urllib.parse.quote(sig)}&target=gpu_h100"
            with urllib.request.urlopen(url, timeout=30) as resp:
                body = json.loads(resp.read().decode("utf-8"))
            q = subprocess.run([sys.executable, "-m", "repro_torch.tuna", "query", "--db",
                                str(db), "--op", sig, "--target", "gpu_h100", "--json"],
                               env=env, capture_output=True, text=True, timeout=120)
            if q.returncode or json.loads(q.stdout) != body["records"]:
                fail(f"GET /schedule for {sig} differs from query --json: "
                     f"{body['records']} vs {q.stdout[:500]}")
            cfg = [r for r in body["records"] if r["op"] == sig][0]["config"]
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            y = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
            ops.reset_launch_counts()
            got = km.matmul(x, y, bm=cfg["bm"], bn=cfg["bn"], bk=cfg["bk"],
                            double_buffer=cfg["double_buffer"])
            torch.cuda.synchronize()
            launches += ops.launch_counts()["matmul"]
            want = km.matmul_plain(x, y, cfg["bm"], cfg["bn"], cfg["bk"])
            bad, w = outside(got, want, MM_RTOL, MM_ATOL_RMS)
            worst = max(worst, float((got.float() - want.float()).abs().max()))
            served[f"{m}x{n}x{k}"] = {"config": cfg, "outside": bad, "worst": w}
            if bad:
                fail(f"the matmul kernel at the served blocks {cfg} disagrees with its "
                     f"plain version at {m}x{n}x{k}")
    finally:
        server.shutdown()
        server.server_close()
    if launches != len(YI6B_SHAPES):
        fail(f"{launches} matmul launches at the served blocks, not one per yi-6b shape")
    health = ctl.health()
    log(f"controller HTTP: /schedule = query --json at {len(served)} yi-6b shapes; the "
        f"kernel at the served blocks within the matmul limit of its plain version "
        f"{served}; {launches} launches; store {health['store_records']} records, "
        f"snapshot {health['snapshot']['name']}")
    result = {"cli_s": cli_s, "exit": exit_line.strip(), "healed": healed,
              "published": pushed, "served": served, "launches": launches,
              "max_abs_err": worst, "store_records": health["store_records"]}
    print("controller " + json.dumps(result, default=float), flush=True)
    return result


def train_phase(qkv) -> dict:
    """The train phase (phase 7b of the docstring). Returns the flash
    launches of the uncut run and the kernel's times at its shape."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticTokens
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.failure import FailureInjector

    # -- the flash gradient, and the kernel and the backward at the train shape
    t0 = time.perf_counter()
    grad_err = check_flash_grad(GRAD_CASES, qkv)
    cfg = get_config(ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv(TRAIN_B, hq, hkv, TRAIN_S, d)
    do = qkv(TRAIN_B, hq, hkv, TRAIN_S, d)[0]
    bq, bk = ops.tuned_flash_blocks(TRAIN_S, d, 2)
    check_flash([(TRAIN_B, hq, hkv, TRAIN_S, d, True)], qkv)
    fwd_ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=True, block_q=bq,
                                                 block_k=bk), iters=20)
    bwd_ms = cuda_ms(lambda: fa.flash_attention_backward(q, k, v, do, causal=True),
                     iters=5, warmup=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(
        torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                         enable_gqa=True), leaves, do),
        iters=5, warmup=1)
    flops, nbytes = flash_work(TRAIN_B, hq, hkv, TRAIN_S, d, True)
    bwd_bound = max(2.5 * flops / GPU_H100.peak_flops_bf16,
                    2 * nbytes / GPU_H100.hbm_bandwidth) * 1e3
    fwd_bound = max(flops / GPU_H100.peak_flops_bf16, nbytes / GPU_H100.hbm_bandwidth) * 1e3
    kernel = {"B": TRAIN_B, "S": TRAIN_S, "Hq": hq, "Hkv": hkv, "D": d, "blocks": [bq, bk],
              "fwd_ms": fwd_ms, "fwd_bound_ms": fwd_bound, "bwd_ms": bwd_ms,
              "bwd_bound_ms": bwd_bound, "sdpa_fwd_bwd_ms": sdpa_ms, "grad_max_abs_err": grad_err}
    log(f"train kernel at B={TRAIN_B} S={TRAIN_S} causal blocks=({bq},{bk}): forward "
        f"kernel {fwd_ms:.4f} ms (graph replay; bound {fwd_bound:.4f}), backward "
        f"(plain torch, eager) {bwd_ms:.4f} ms (bound {bwd_bound:.4f} at bf16 rates); "
        f"SDPA forward + backward (yardstick) {sdpa_ms:.4f} ms; checks "
        f"{time.perf_counter() - t0:.1f} s")
    del q, k, v, do, leaves
    torch.cuda.empty_cache()

    # -- yi-6b uncut through train()
    opts = train_mod.TrainOptions(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                                  state_dtype="bfloat16", log_every=1, seed=SEED)
    kernel_steps = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with step_metrics(kernel_steps):
        out = train_mod.train(cfg, opts)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in _leaves(out["params"]))
    secs = [dt for _, _, dt in out["history"]]
    out_history = out["history"]
    med = statistics.median(secs)
    log(f"train {ARCH} uncut: {n_params / 1e9:.3f} B parameters, {TRAIN_STEPS} steps "
        f"of B={TRAIN_B} x S={TRAIN_S} in {wall:.1f} s (init included); step seconds "
        f"{[round(x, 4) for x in secs]}, median {med:.4f} s, "
        f"{TRAIN_B * TRAIN_S / med:.1f} tokens/s; peak {peak:.2f} GiB; flash launches "
        f"{launches}; per step {kernel_steps}")
    want = TRAIN_STEPS * cfg.n_layers * 2
    if launches != want:
        fail(f"train flash launches {launches} != steps x layers x 2 = {want}")
    if len(kernel_steps) != TRAIN_STEPS or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in kernel_steps):
        fail(f"a train step's loss or gradient norm is not finite: {kernel_steps}")
    # the mesh phase's reference: every leaf's digest before the fifth step
    t_dig = time.perf_counter()
    digests = _digests(out)
    log(f"train: {len(digests)} leaf digests in {time.perf_counter() - t_dig:.1f} s")

    # a fifth step, profiled: device time by span against the median step
    model = Model(cfg)
    step_fn = steps_mod.make_train_step(model, AdamWConfig(lr=opts.lr, state_dtype="bfloat16"))
    batch = SyntheticTokens(SyntheticConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=SEED)).batch(
        TRAIN_STEPS)
    trace = ROOT / "build" / "profile" / "train_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(out["params"], out["opt_state"], batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    kernels, spans = trace_device_time(trace)
    trace.unlink()
    busy = sum(ms for _, ms in kernels)
    idle = 1 - busy / (prof_wall * 1e3)
    split = {name: spans.get(key, 0.0) for key, name in TRAIN_SPANS.items()}
    split["the rest"] = busy - sum(split.values())
    log(f"train profile (a fifth step, profiler on): device busy {busy:.1f} ms over "
        f"{len(kernels)} kernels in the step's own wall {prof_wall * 1e3:.1f} ms: the device "
        f"is idle {100 * idle:.1f}% of it (against the unprofiled median step "
        f"{med * 1e3:.1f} ms, a different run: {100 * (1 - busy / (med * 1e3)):.1f}%); "
        f"by span: " + ", ".join(
            f"{name} {ms:.1f} ms ({100 * ms / busy:.1f}%)" for name, ms in split.items()))
    del out, model, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # the first step again, with each parameter leaf's gradient norm: through
    # the kernel, through the plain version, and through the kernel with a
    # faulty forward or backward (the controls)
    t0 = time.perf_counter()
    first_step = {}
    for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_flash()),
                      ("batch_offset", faulty_attention("batch_offset")),
                      ("half_dq", faulty_attention("half_dq")),
                      ("drop_last_block", faulty_attention("drop_last_block"))):
        metrics, norms = [], []
        with ctx, step_metrics(metrics), leaf_grad_norms(norms):
            gc.collect()
            train_mod.train(cfg, dataclasses.replace(opts, steps=1))
        gc.collect()
        torch.cuda.empty_cache()
        first_step[name] = dict(metrics[0], leaves=norms[0])
    p1 = first_step["plain"]

    def gaps(run):
        """(|d loss|, relative d gradient norm, the largest relative d leaf
        gradient norm, that leaf) of a first step against the plain one."""
        rel = {key: abs(n - p1["leaves"][key]) / max(p1["leaves"][key], 1e-30)
               for key, n in run["leaves"].items()}
        worst = max(rel, key=rel.get)
        return (abs(run["loss"] - p1["loss"]),
                abs(run["grad_norm"] - p1["grad_norm"]) / p1["grad_norm"], rel[worst], worst)

    limits = (TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_RTOL)
    within = lambda g: all(x <= lim for x, lim in zip(g, limits))
    readings = {name: gaps(run) for name, run in first_step.items() if name != "plain"}
    for name, (d_loss, d_norm, d_leaf, leaf) in readings.items():
        run = first_step[name]
        log(f"train parity, first step {name}: loss {run['loss']:.6f} grad norm "
            f"{run['grad_norm']:.6f} against plain {p1['loss']:.6f} / "
            f"{p1['grad_norm']:.6f}: |d loss| {d_loss:.3e} (limit {TRAIN_LOSS_TOL}), "
            f"relative d norm {d_norm:.3e} (limit {TRAIN_GNORM_RTOL}), largest relative d "
            f"leaf norm {d_leaf:.3e} at {leaf} (limit {TRAIN_LEAF_RTOL}): "
            f"{'within' if within(readings[name]) else 'outside'}")
    log(f"train parity: the main run's first step loss {kernel_steps[0]['loss']:.6f} grad "
        f"norm {kernel_steps[0]['grad_norm']:.6f}, the rerun's {first_step['kernel']['loss']:.6f} / "
        f"{first_step['kernel']['grad_norm']:.6f}; {time.perf_counter() - t0:.1f} s")
    if not within(readings["kernel"]):
        fail("the first train step through the kernel disagrees with the plain version's")
    if within(readings["half_dq"]):
        fail("the train parity limits would miss a backward whose dq is halved")
    if within(readings["batch_offset"]):
        fail("the train parity limits would miss a kernel that lost its batch offset")

    # -- the resume: bit-equal to an uninterrupted run
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    kw = dict(steps=RESUME_STEPS, batch=RESUME_B, seq=RESUME_S, state_dtype="int8",
              accum_steps=2, grad_compression="int8", log_every=1, seed=SEED)
    first = train_mod.train(cfg2, train_mod.TrainOptions(**kw))
    second = train_mod.train(cfg2, train_mod.TrainOptions(**kw))
    differ = _bit_diff(first, second)
    log(f"resume: two uninterrupted runs ({RESUME_LAYERS} layers, int8 moments, 2 "
        f"microbatches, int8 compression): {len(differ)} of "
        f"{len(list(_train_state(first)))} leaves differ {differ[:8]}")
    if differ:
        fail("two uninterrupted train runs differ: a step is not deterministic")
    del second
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        recovered = train_mod.train_with_recovery(
            cfg2, train_mod.TrainOptions(ckpt_dir=str(ckpt), ckpt_every=2, **kw),
            injector=FailureInjector(fail_at_steps={3}))
        ckpt_mb = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file()) / 1e6
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    differ = _bit_diff(first, recovered)
    log(f"resume: failure at step 3, restored from step 2, ended at step "
        f"{recovered['final_step']}: {len(differ)} leaves differ from the uninterrupted "
        f"run {differ[:8]}; checkpoints {ckpt_mb:.0f} MB on disk at the end; "
        f"{time.perf_counter() - t0:.1f} s")
    if recovered["final_step"] != RESUME_STEPS or differ:
        fail("the resumed run is not bit-equal to the uninterrupted one")
    del first, recovered
    gc.collect()
    torch.cuda.empty_cache()

    result = {"arch": ARCH, "layers": cfg.n_layers, "params_b": n_params / 1e9,
              "batch": TRAIN_B, "seq": TRAIN_S, "steps": kernel_steps,
              "step_s": secs, "median_step_s": med, "tokens_per_s": TRAIN_B * TRAIN_S / med,
              "peak_gib": peak, "device_busy_ms": busy, "idle": idle, "spans_ms": split,
              "profiled_step_s": prof_wall, "first_step": {
                  name: {"loss": run["loss"], "grad_norm": run["grad_norm"]}
                  for name, run in first_step.items()},
              "first_step_gaps": {name: list(g[:3]) for name, g in readings.items()},
              "launches": {ARCH: launches}, "kernel": kernel}
    print("train " + json.dumps(result), flush=True)
    result["losses"] = [loss for _, loss, _ in out_history]
    result["digests"] = digests
    return result


def attention_layers(cfg) -> int:
    """The layers whose prefill launches the flash kernel: the decoder's
    attention mixers and, for the encoder-decoder, the encoder's layers
    (its cross-attention runs the chunked version, not the kernel)."""
    n = sum(cfg.mixer_kind(i) == "attention" for i in range(cfg.n_layers))
    return n + (cfg.n_encoder_layers if cfg.encoder_decoder else 0)


def reduced_phase(dev: str = "cuda") -> dict:
    """The reduced phase: the port's entry points at the reduced configs on
    the card, whose attention runs the f32 kernel at head dim 16. For each
    of the ten archs' ``.reduced()`` configs: weights from a seeded CPU
    generator moved to the card, one serve of 4 requests (REDUCED_LENS)
    through ``launch.serve.serve`` (whisper and internvl2, with seeded stub
    frames or patches, greedily through ``Model.prefill``/``decode_step``,
    the reference's only entry for them): every request gets its tokens,
    f32 flash launches = prefills x attention layers (0 for xlstm), and the
    last logits of one prefill (77 tokens) within REDUCED_LOGIT_RTOL*rms of
    the same prefill through the plain version (MoE routing pinned). Then
    train_tiny's first step, its loss and every gradient leaf against the
    same step through the plain version within REDUCED_GRAD_RTOL relative;
    ``examples.train_tiny.main(["--steps", "40"])`` must collapse the loss
    (ce < 0.5 ln V), ``examples.serve_batched``, ``examples.quickstart``
    (the f32 matmul kernel at the f32 pick), ``launch.serve --reduced`` and
    ``launch.train --reduced`` run at their defaults; and the f32 store
    path: ``python -m repro_torch.tuna tune --smoke`` into a fresh DB, its
    records promoted and bundled on the card, and an f32 ``ops.matmul``
    without blocks launched from the bundle's library with no nvcc run.
    Each counted run's launches are read just after it; returns the
    phase's summary with the f32 kernels' main-path launches."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.core.spaces import MatmulSpace
    from repro_torch.examples import quickstart, serve_batched, train_tiny
    from repro_torch.hw.gpu_h100 import GPU_H100
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.engine import Request
    from repro_torch.models.model import Model
    from repro_torch.tuna.db import ScheduleDatabase
    from repro_torch.tuna.golden import GoldenManager, build_kernel_bundle

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    defaults = [] if dev == "cuda" else ["--device", dev]
    t_phase = time.perf_counter()
    main_path = {"flash_attention_f32": 0, "matmul_f32": 0}

    def counted(fn):
        """fn() with the launch counts set to 0 just before and read just
        after; the f32 kernels' launches join the main path's."""
        sync()
        ops.reset_launch_counts()
        out = fn()
        sync()
        got = ops.launch_counts()
        for key in main_path:
            main_path[key] += got[key]
        return out, got

    def within(got, want, rtol):
        diff = float((got.float() - want.float()).abs().max())
        rms = float(want.float().pow(2).mean().sqrt())
        return diff, rms, diff <= rtol * rms and bool(torch.isfinite(got).all())

    archs = {}
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        n_attn, n_moe = attention_layers(cfg), sum(
            cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
        params = tree.map(lambda t: t.to(dev), Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(SEED)))
        model = Model(cfg, device=dev)
        rng = np.random.default_rng(SEED)
        n_prefix = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
        cap = max(REDUCED_LENS) + n_prefix + MAX_NEW + 2
        stub = {"audio": "frames", "vision": "patches"}.get(cfg.frontend)
        stub_gen = torch.Generator().manual_seed(SEED + 2)

        def batch(n):
            b = {"tokens": torch.tensor([[int(t) for t in rng.integers(0, cfg.vocab, n)]],
                                        dtype=torch.int32, device=dev)}
            if stub:
                b[stub] = (0.1 * torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
                                             generator=stub_gen)).to(dev)
            return b

        if stub is None:
            reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, n)], MAX_NEW)
                    for i, n in enumerate(REDUCED_LENS)]
            stats, got = counted(lambda: serve_mod.serve(model, params, reqs, slots=SLOTS,
                                                         cap=cap, scheduler="continuous"))
            outs, prefills = [list(r.out) for r in reqs], stats["prefills"]
        else:
            def greedy(b):
                cache, pos, last = model.prefill(params, b, cap)
                out = [int(torch.argmax(last[0, 0]))]
                for t in range(MAX_NEW - 1):
                    logits, cache = model.decode_step(
                        params, cache, torch.tensor([out[-1]], dtype=torch.int32), pos + t)
                    out.append(int(torch.argmax(logits[0])))
                return out

            batches = [batch(n) for n in REDUCED_LENS]
            outs, got = counted(lambda: [greedy(b) for b in batches])
            prefills = len(batches)
        if [len(o) for o in outs] != [MAX_NEW] * len(REDUCED_LENS) or any(
                not 0 <= t < cfg.vocab for o in outs for t in o):
            fail(f"reduced {arch}: a request got too few tokens or one outside the "
                 f"vocabulary: {outs}")
        if prefills != len(REDUCED_LENS) or got["flash_attention_f32"] != prefills * n_attn \
                or got["flash_attention"]:
            fail(f"reduced {arch}: f32 flash launches {got['flash_attention_f32']} (bf16 "
                 f"{got['flash_attention']}) != prefills x attention layers {prefills} x "
                 f"{n_attn}")
        row = {"prefills": prefills, "attention_layers": n_attn,
               "launches": got["flash_attention_f32"], "tokens": sum(map(len, outs))}
        if n_attn:
            g, w, note = prefill_parity(model, params, batch(77), cap, n_moe > 0)
            diff, rms, ok = within(g, w, REDUCED_LOGIT_RTOL)
            row.update(logits_max_diff=diff, logits_rms=rms)
            log(f"reduced {arch}: parity S=77 last logits {tuple(g.shape)}: max|kernel-plain| "
                f"{diff:.3e} against a limit of {REDUCED_LOGIT_RTOL}*rms = "
                f"{REDUCED_LOGIT_RTOL * rms:.3e}{note}")
            if not ok or g.shape != (1, 1, cfg.vocab):
                fail(f"reduced {arch}: the kernel prefill disagrees with the plain one")
        row["s"] = time.perf_counter() - t0
        archs[arch] = row
        log(f"reduced {arch} ({cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads "
            f"of {cfg.head_dim}, {cfg.param_dtype}): {row}")
        del model, params

    # train_tiny's first step through the kernel against the plain version
    cfg = get_config("yi-6b").reduced()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    toks = ((torch.arange(65, dtype=torch.int32) * 7) % cfg.vocab)[None].repeat(8, 1).to(dev)
    tiny = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_and_grads():
        leaves = [t.detach().clone().requires_grad_() for t in tree.leaves(params)]
        loss, _ = model.loss(tree.unflatten_like(params, leaves), tiny)
        return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)

    loss_k, grads_k = loss_and_grads()
    with plain_flash():
        loss_p, grads_p = loss_and_grads()
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    leaf_rel = [float((gk - gp).norm() / gp.norm().clamp_min(1e-30))
                for gk, gp in zip(grads_k, grads_p) if gp is not None]
    log(f"reduced train_tiny first step: loss {float(loss_k):.6f} vs plain "
        f"{float(loss_p):.6f} (relative {loss_rel:.3e}); {len(leaf_rel)} gradient leaves, "
        f"largest relative |g_kernel - g_plain| / |g_plain| {max(leaf_rel):.3e}; limit "
        f"{REDUCED_GRAD_RTOL}")
    if loss_rel > REDUCED_GRAD_RTOL or max(leaf_rel) > REDUCED_GRAD_RTOL or any(
            g is None or not torch.isfinite(g).all() for g in grads_k):
        fail("reduced: train_tiny's first step through the kernel disagrees with the plain one")
    del model, params

    t0 = time.perf_counter()
    tiny_out, got = counted(lambda: train_tiny.main(["--steps", "40"] + defaults))
    tiny_row = {"ce_first": tiny_out["ce"][0], "ce_last": tiny_out["ce"][-1],
                "floor": tiny_out["floor"], "launches": got["flash_attention_f32"],
                "loss_rel": loss_rel, "max_leaf_rel": max(leaf_rel),
                "s": time.perf_counter() - t0}
    log(f"reduced examples.train_tiny --steps 40: {tiny_row}")
    if not tiny_out["ce"][-1] < 0.5 * tiny_out["floor"] or got["flash_attention_f32"] < 40 * 2:
        fail(f"reduced: train_tiny did not collapse the loss or launch the f32 kernel: "
             f"{tiny_row}")

    t0 = time.perf_counter()
    sb, got = counted(lambda: serve_batched.main(defaults))
    sb_row = {"tokens": sb["stats"]["tokens"], "prefills": sb["stats"]["prefills"],
              "launches": got["flash_attention_f32"], "s": time.perf_counter() - t0}
    log(f"reduced examples.serve_batched: {sb_row}")
    if sb_row["launches"] != sb_row["prefills"] * attention_layers(cfg) or not sb_row["tokens"]:
        fail(f"reduced: serve_batched launched the f32 kernel {sb_row['launches']} times "
             f"for {sb_row['prefills']} prefills")

    t0 = time.perf_counter()
    qs, got = counted(lambda: quickstart.main(defaults))
    qs_row = {"config": qs["config"], "blocks": list(qs["blocks"]),
              "max_abs_err": qs["max_abs_err"], "launches": got["matmul_f32"],
              "s": time.perf_counter() - t0}
    log(f"reduced examples.quickstart (f32): {qs_row}")
    if got["matmul_f32"] != 1 or not qs["max_abs_err"] <= F32_MM_TOL * 256 ** 0.5:
        fail(f"reduced: the quickstart's f32 matmul did not launch once within the "
             f"reference's f32 limit: {qs_row}")

    launchers = {}
    for name, fn, argv, want in (
            ("launch.serve", serve_mod.main, ["--arch", "yi-6b", "--reduced"], 6),
            ("launch.train", train_mod.main, ["--arch", "yi-6b", "--reduced"], 50)):
        t0 = time.perf_counter()
        _, got = counted(lambda: fn(argv + defaults))
        launchers[name] = {"launches": got["flash_attention_f32"],
                           "s": time.perf_counter() - t0}
        log(f"reduced python -m repro_torch.{name} {' '.join(argv)}: {launchers[name]}")
        # the serve prefills its 6 requests once each; each train step
        # runs the forward at least once per attention layer
        if got["flash_attention_f32"] < want * attention_layers(cfg):
            fail(f"reduced: {name} --reduced launched the f32 kernel "
                 f"{got['flash_attention_f32']} times")

    # the f32 store path: tune --smoke, promoted, bundled, launched from it
    t0 = time.perf_counter()
    store = ROOT / "build" / "reduced_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    db_path = str(store / "db.jsonl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("REPRO_TUNA_DB", None)
    res = subprocess.run([sys.executable, "-m", "repro_torch.tuna", "tune", "--smoke",
                          "--db", db_path], env=env, capture_output=True, text=True,
                         timeout=300)
    if res.returncode:
        fail(f"reduced: python -m repro_torch.tuna tune --smoke exited {res.returncode}: "
             f"{res.stderr[-1500:]}")
    records = ScheduleDatabase(db_path).records()
    sig = MatmulSpace(256, 256, 256, 4, target_kind=GPU_H100.kind).signature()
    mgr = GoldenManager(str(store / "golden"))
    info = mgr.promote(records, GPU_H100.name, source=db_path)
    _, release = mgr.load_release(info.path)
    binfo = build_kernel_bundle(release, str(store / "golden"), GPU_H100.name,
                                golden_name=info.name, device=dev)
    x, y = (torch.randn(shape, generator=torch.Generator().manual_seed(SEED)).to(dev)
            for shape in ((256, 256), (256, 256)))
    builds = ops.kernel_build_counts()
    ops.use_kernel_bundle(binfo.path, device=dev)
    try:
        bundled, got = counted(lambda: ops.matmul(x, y))
        bundle = ops.get_kernel_bundle()
        hits, nvcc = bundle.exec_hits, {n: ops.kernel_build_counts()[n] - builds[n]
                                        for n in builds}
    finally:
        ops.use_kernel_bundle(None)
    rec = next(r for r in records if r.op == sig)
    explicit = ops.matmul(x, y, blocks=tuple(rec.config[k] for k in
                                             ("bm", "bn", "bk", "double_buffer")))
    store_row = {"records": [r.op for r in records], "entries": binfo.entries,
                 "skipped": binfo.skipped, "hits": hits, "nvcc": nvcc,
                 "launches": got["matmul_f32"], "config": rec.config,
                 "equal_explicit": bool(torch.equal(bundled, explicit)),
                 "s": time.perf_counter() - t0}
    log(f"reduced f32 store path: {store_row}")
    if (sig not in [r.op for r in records] or binfo.entries < 1 or hits != 1
            or any(nvcc.values()) or got["matmul_f32"] != 1 or not store_row["equal_explicit"]):
        fail(f"reduced: the f32 dense_256 record did not launch from the bundle: {store_row}")
    shutil.rmtree(store, ignore_errors=True)

    summary = {"archs": archs, "train_tiny": tiny_row, "serve_batched": sb_row,
               "quickstart": qs_row, "launchers": launchers, "store": store_row,
               "launches": dict(main_path), "phase_s": time.perf_counter() - t_phase,
               "card": nvidia_smi("name,power.limit") if dev == "cuda" else dev}
    print("reduced " + json.dumps(summary, default=str), flush=True)
    return summary

if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-start-arm"]:
        cold_start_arm(sys.argv[2])
    else:
        main()
