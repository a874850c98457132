#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card: name and power limit from ``nvidia-smi``; no CUDA device is a
   failure; the H100 sheets (``H100_KERNEL``, ``H100_RUNTIME``) beside what
   the card reports (multiprocessors, shared memory a multiprocessor,
   ``total_memory``, the maximum SM clock), a failure where a sheet claims
   more, and a 256 MiB pinned copy each way beside the sheet's host link;
2. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (a ptxas spill in a tiled source fails the run), and print the backward
   attention kernels' and the bf16 forward pair's shared memory, registers
   and blocks an SM at each head width;
3. the main paths, one after the other, on the u200 sheet.  Staged (one
   frame at a
   time): the paper-width UNet (widths 64-1024, 368x480 input), then X3D-M
   at its published stage widths (24-192, 16 frames of 128x128), both on
   their DSE plans; then X3D-M on three hand-cut one-stage plans that
   BFP8-evict every edge deeper than 4096, 96 and 0 words (the skips only,
   then the mid-depth streams, then every stream), each compiled on the
   CPU, written with ``Compiled.save`` and run from ``Compiled.load`` on
   the card (the saved-artifact entry point); a few seeded frames each,
   with the kernel launches counted from 0 around every frame and held
   against the path's own table, every vertex held to its plain version on
   the kernel route's own inputs within VERTEX_PARITY_TOL (``oracle.
   vertex_parity``, which names the first vertex past it), and the output
   held against the same plan in ``kernel_mode="reference"`` on the card
   within max(KERNEL_PARITY_TOL x max|ref|, 2 S), S reference mode's change
   when its input moves one ulp up (``oracle.frame_bound``; the first
   vertex where the two part free-running is named if the frame fails).
   Pipelined (the 1F1B streamer over 8 microbatches): the YOLO head at
   YOLOv8n's neck widths (64-256, P3 = 160x160) on its DSE plan and on a
   hand-cut 3-stage plan; seeded streams, with the launches counted from 0
   around every stream and held against ticks x the plan's table per tick,
   every microbatch held bit for bit against the staged executor on the
   same plan, every vertex of that staged executor to its plain version on
   its own inputs, and the microbatch to pipelined reference mode within
   the same bound as a staged frame.
   The ring (``ring_phase``, ``yolo-3stage-ring``): the 3-stage plan with
   the same weights through ``lower_plan_pipelined(placement="shard_map",
   devices=[cuda:0] * 3)``, each stage on a CUDA stream of its own on the
   one card, crossings ordered by events; the same seeded streams, every
   microbatch bit for bit the interleave's, the launches held to ticks x
   the same table, every stage's weights read on its own stream (a ring
   that ran on one stream fails); then each stream again with one stage's
   stream held back RING_SPIN_CYCLES at every tick, first the last stage
   (a consumer only), then the first (a producer only), bit for bit
   again.  Phase 5 times the interleave and the ring in turns (CUDA
   events), with both executors' measured stage latencies and profiles.
   Served (``Compiled.serve`` -> ``GraphStreamServer``): the same YOLO
   head on its DSE plan with an SLO attached; 20 seeded frames, one flush
   (two full streams and one with 4 bubbles), ``resident_limit=4``; every
   result bit for bit the staged executor's, the counters read back from
   the Prometheus exposition, the launches of every stream held to the
   table; one ``Compiled.trace`` (outputs, Chrome trace, ModelCheck); the
   served frames/s, latency percentiles, SLO verdicts and idle share.
   Fuzzed: the port's conformance fuzzer on the card (seed 0, 12 cases,
   every case on the kernel route), zero violations, with the act
   decode-alone launches held to the lowering's count.
   LM served (``ServingEngine``): yi-6b at its published widths (about
   6.06 B parameters in f32, from a seeded generator on the card), 8
   seeded prompts of 64-512 tokens through 4 slots, 32 new tokens each,
   finished requests' KV pages BFP8-evicted to the host past 2 parked on
   the card; the counters from the Prometheus exposition against the
   schedule worked out beforehand, 32 x 8 flash_attention launches and no
   other kernel, every prefill against ``kernel_mode="reference"`` on the
   same weights (first-token logits, KV pages, then the token streams), a
   parked restore bit for bit and a host restore within the BFP8 bound;
   prefill and decode times, decode against its byte bound, one profiled
   prefill and decode step, peak memory; then the model is released.
   Then olmoe-1b-7b at its published widths (about 6.92 B parameters, 64
   experts top 8) the same way, 16 x 8 flash_attention launches, with the
   router's choices of every prefill and decode step held on both routes:
   a flip (another expert or queue slot) only at a plain-route near-tie
   (``testing.routing.hold_routing``), the token streams in lockstep until
   the routes part, the dropped (token, k) pairs printed.
   Then xlstm-1.3b at its published widths and depth (48 layers, mLSTM :
   sLSTM 7 : 1, about 1.41 B parameters; ``lm-xlstm``), its 8 prompts
   multiples of 64 in 64-512 (the mLSTM chunk rule): the counters worked
   out from the cache leaves' own sizes (each slot's recurrent state is
   705 MB), no kernel launched, every leaf's parked restore bit for bit
   and host restore within the BFP8 bound, the host codec's seconds a
   page-set, and the decode-equivalence invariant (prefill 56 of 64 tokens
   and 448 of 512, decode the rest, every step's logits against the full
   forward's within LM_DECODE_TOL); then one period of jamba-v0.1-52b's
   pattern at its published widths (8 of 32 layers, Mamba, attention and
   16 experts top 2; about 13.3 B parameters, reckoned and printed before
   the weights are made; ``lm-jamba``), served and held to the plain route
   as olmoe is, 1 x 8 flash_attention launches; then the first 8 of
   qwen2-vl-72b's 80 layers at its published widths (M-RoPE sections 16,
   24, 24; 64 heads / 8 KV of 128; about 9.51 B parameters;
   ``lm-qwen2vl``), served on text positions and held to the plain route
   as yi-6b is, 8 x 8 flash_attention launches, and one 1536-token prefill
   through ``make_prefill_step`` whose first 1024 positions are seeded
   patch embeddings, held to the plain route.  Then whisper-large-v3 at
   its published widths and depth (32 encoder and 32 decoder layers,
   about 1.60 B parameters; ``lm-whisper``) through ``make_prefill_step``
   and ``make_decode_step`` (the engine takes no encoder frames): 4 seeded
   frame embeddings of 1500 frames, 4 prompts of 64 tokens, s_max 448, 32
   greedy tokens; exactly 96 flash_attention launches in the prefill (32
   encoder, 32 self, 32 cross, non-causal over the 1500 encoder keys) and
   32 a decode step, no other kernel; the encoder output, the first-token
   logits and the k, v, xk and xv caches held to the plain route within
   LM_TOL x max|plain|, the token streams in lockstep until a plain-route
   near-tie, and decode equivalence (56 of 64 tokens prefilled); encoder,
   prefill and decode times, decode against its byte bound, peak memory
   and profiles.  Every LM path prints
   prefill and decode times, decode against its byte bound, peak memory,
   a device profile of a prefill and a decode step and a host profile of
   each, with the recurrent mixers' share of the host time.
   LM trained (``train_phase``, ``lm-train``): yi-6b at its published
   widths, nothing reduced, f32 with int8 AdamW states (``quantize_states``),
   ``remat="full"``, one microbatch of 1 x 1024 tokens of
   ``TokenPipeline.batch_at(0)``, repeated: the loss, every leaf's gradient
   norm and the full gradients of ``embed`` and layers 0 and 31's
   ``wq``, ``wk``, ``wv``, ``wo`` on the kernel route held to the plain
   route's on the same weights within TRAIN_TOL x max(1, max|plain|);
   four optimizer steps through ``make_train_step`` inside
   ``FaultTolerantLoop`` (a ``CheckpointStore`` in a temporary directory),
   every loss finite and the fourth below the first, every int8 state
   leaf still int8, the launches exactly 2 x 32 ``flash_attention_lse``
   (step and recompute) and 32 of each backward kernel a step and no other
   kernel; ms a step, tokens/s, peak memory, one profiled step and the
   step's bound.  Then the same path at yi-6b's reduced size
   (``lm-train-reduced``): every gradient leaf on the kernel route held to
   the plain route, two microbatches accumulated in bf16 bit for bit
   their definition, and four steps with a save after step 2 and a
   restore into a fresh loop, steps 3-4 bit for bit the uninterrupted
   run's (raw checkpoints) or within the BFP8 bound (BFP8 ones).  After
   ``lm-train-bf16`` (below), training on the recurrent mixers
   (``train_recurrent_phase``), the same
   step, batch and checks of progress, launches and int8 states:
   xlstm-1.3b at its published widths, 16 of its 48 layers
   (``lm-train-xlstm``, no kernel launched; the reduced xlstm's loss and every gradient leaf on
   the card held to the CPU's within TRAIN_TOL x max(1, max|cpu|)) and
   one period of jamba-v0.1-52b at its published widths with its experts
   cut from 16 to 4 (``lm-train-jamba``: the loss, every leaf's gradient
   norm and the full gradients of the attention layer's projections and
   the first Mamba layer's ``in_proj`` and ``A_log`` held across the
   routes as ``lm-train``'s; 8 ``flash_attention_lse`` and 4 of each
   backward kernel over the 4 steps); for each, where one step's gradient
   spends its host time (``recurrent_step_breakdown``: the scan chunks'
   passes, the garbage collector, the same gradient without the scans'
   checkpoints).  Then the encoder-decoder trained
   (``train_whisper_phase``, ``lm-train-whisper`` and
   ``lm-train-whisper-bf16``): whisper-large-v3 at its published widths
   and depth, one microbatch of 4 x 448 tokens over 4 x 1500 seeded frame
   embeddings, int8 AdamW states, remat "full" (the decoder's groups),
   f32 then bf16; the routes held on one gradient of the batch
   accumulated over 4 microbatches of 1 (the loss, every leaf's gradient
   norm, the full projections of encoder layer 0 and decoder layer 31's
   self and cross attention; TRAIN_TOL, bf16_route_tol(64), the bf16
   full gradients beside both routes' distances from an f32 run); 4 steps,
   the fourth loss below the first, exactly 160 flash_attention_lse (or
   _bf16) and 96 of each backward kernel a step (32 encoder, and 2 x 32
   decoder self and cross, forward and recompute), the peak below the
   card's memory; ms a step, tokens/s, the step's bound, one profiled
   step.  Then
   yi-6b in bf16 (``lm-train-bf16``: the same step with bf16 parameters,
   the bf16 attention instances, routes held to bf16_route_tol (2^-7
   sqrt(depth) of max|plain|), 4 steps of
   TRAIN_BF16_OPT, the fourth loss below the first, the launches counted).
   Then the train step on a device mesh (``mesh_phase``): (a)
   ``lm-mesh-1``, yi-6b whole, one TRAIN_OPT step of ``lm-train``'s batch
   on ``make_host_mesh()`` (a 1x1 mesh, NCCL, a world of one) held bit for
   bit to the unsharded step (loss, grad_norm, embed and every layer's
   attention projections after the update) with the same launches, then
   ``lm-mesh-serve``, yi-6b whole served on that mesh: one prefill of 1 x
   1024 tokens and 4 decode steps through make_prefill_step /
   make_decode_step(mesh=), bit for bit the unsharded steps (the last
   logits, every decode's logits, every cache leaf) with the unsharded
   prefill's flash_attention launches, and ``lm-mesh-turns``, the train
   step on the mesh timed against the unsharded one in turns on one
   state, medians of steps 2-4; (c)
   ``lm-mesh-pod``, ``make_pod_compressed_grad_fn`` on two gloo ranks
   spawned by ``repro_torch.testing.ranks`` forming the pod axis, yi-6b
   at its published widths cut to 2 layers, each leaf within 0.02 of the
   exact mean and every new error exact.  A 2x2 mesh of ranks sharing the
   card runs only in the CPU tests: gloo's functional all-gather of CUDA
   tensors ends its process (``examples/torch_gloo_cuda_collectives.py``).
   bf16 is served too (``lm-serve-bf16``, after ``lm-serve``: yi-6b
   through ``ServingEngine(dtype=bf16)``, the same prompts, schedule and
   counters).  The staged executor (``lm-staged``): (a) yi-6b f32 on
   ``lm-serve``'s weights in 4 stages, bit for bit the monolithic forward
   with the boundary codec off, the reference's agreement and compression
   checks with it on; (b) after the training paths, jamba-v0.1-52b in bf16
   at its published widths, as many whole periods as half the host's
   MemTotal holds (the cut printed), weights made on the card a group at a
   time and kept in host memory, one period a stage: eq5_latency,
   per-stage times and boundary bytes, peak memory below the card's and
   the weights' bytes, the routes held with the measured near-tie rule;
4. hold each kernel against its plain PyTorch version on the card, at every
   shape a path launched it with in phase 3 plus ragged shapes (c = 3, 24,
   40 for the codec variants, payloads with random padding bytes) and the
   edge cases (the BFP8 exponent's, 'same'-padding rows and +-0.0 for
   dwconv); a codec variant's y also bit for bit the un-fused kernel's on
   the decode kernel's output, its payload the codec's of that y; a pool
   over more than 8 rows (one launch, its sum order fixed) within POOL_TOL
   of the plain mean and a second launch bit for bit the first; each pool
   launch shape against ``view(...).mean``, and each launch shape of the
   standalone codec (an (r, c) stripe and its 32 ceil(c / 32)-wide
   payload, no padded copy) against its bound; dwconv over 9 and 11 taps
   (more than its window kernel is built for); act_relu_decode alone at
   the YOLO head's act shape and at ACT_DECODE_AT's largest
   act_relu_decode_encode shape, timed against its bound;
   flash_attention at the LM paths' shapes (causal, and non-causal over
   keys of their own length: whisper's encoder, cross attention and cross
   decode) and at ragged S with head widths 16-128, causal and not, and
   over ragged Sk (1, 37, 1499) against Sq = 1 and 64, those timed against
   their bound and SDPA at the same shapes; its lse instance and the two backward kernels
   at the train paths' shapes and at the same ragged shapes, within
   TRAIN_TOL x max(1, max|plain|) of their plain versions (the lse too)
   and a second launch bit for bit the first; the four bf16 instances
   (flash_attention_bf16, flash_attention_lse_bf16,
   flash_attention_bwd_dq_bf16, flash_attention_bwd_dkdv_bf16) at the bf16
   paths' shapes and the same ragged ones, and all six training
   instances over ragged keys of their own length (Sk 1, 37, 1499 against
   Sq 1 and 64, non-causal; whisper's train shapes come from its paths),
   every bf16 element within one
   bf16 ulp of its plain version (lse and delta as the f32 instances'),
   two launches bit for bit, timed against SDPA in bf16 (forward; the
   whole autograd backward for the pair) and bound by the bf16 tensor
   cores' 989 TFLOP/s, and by the bf16 products they issue themselves, P
   and dS in two pieces (``bound_products_ms``: the forward pair's
   ``csrc/flash_attention_bf16.cu``, the backward pair's
   ``csrc/flash_attention_bwd_bf16.cu``); every tile
   choice of every tiled kernel bit for bit its untiled launch; and time
   kernel, plain version and one PyTorch call as a yardstick (CUDA events,
   L2 flushed before every launch, median of REPS launches).  Besides the
   f32 bound, the kernels that run on the tensor cores through the 3xTF32
   split (``csrc/tf32x3.cuh``: streamed_matmul, flash_attention and its
   lse instance in f32, the two f32 backward kernels, the
   four conv2d variants) get
   the split's bound, the larger of the bytes' time
   and 3 x operations at 495 TFLOP/s dense TF32 (``bound_tf32x3_ms``):
   their times may fall below the f32 FMA bound; they are also held bit
   for bit from one launch to the next;
5. each staged path's frame time and peak device memory, with its spills
   evicted as planned and with the same plan's spills kept on the device,
   its frame time in reference mode, and the device's busy time and idle
   share in one profiled frame (for the YOLO head: ms per microbatch
   pipelined and staged, peak memory of one stream, the 3-stage plan's
   measured stage latencies, one profiled stream; then the 3-stage plan's
   interleave and ring in turns, ms per microbatch by CUDA events and the
   host clock, both executors' stage latencies, a profiled stream of each
   with the time its device events cover);
6. the autotuned path: ``GraphStreamServer.autotuned`` on the same YOLO
   head (the closed-loop search, ``repro_torch.optim.autotune``: 12
   candidates from the u200 DSE plan, each lowered and measured over a
   stream of 8 on the kernel route); the trajectory, baseline and best
   fps, the calibration, the search's seconds and peak device memory; the
   winner's staged frames held to its launch table and to reference mode,
   20 served frames bit for bit the staged executor's, and its artifact
   saved and loaded;
   then the public wrapper and the walkthroughs (``walkthrough_phase``):
   ``kernels.ops.fragmented_matmul`` at the UNet path's streamed_matmul
   launch with the most weights, at static fractions 0, 0.25, 0.5 and 1,
   each call exactly one streamed_matmul launch within VERTEX_PARITY_TOL
   x max(1, max|plain|) of its plain version, and timed; then the four
   walkthroughs' ``main`` in-process on the card (``examples/
   torch_quickstart.py`` costing the paper UNet on zcu102 and executing
   unet_exec pipelined under a starved channel, ``torch_serve_batched.py``
   on its LM and graph paths, ``torch_train_small.py`` with its restart,
   ``torch_long_context.py`` on xlstm), each held to the lines
   WALKTHROUGHS names, its launches printed;
   then the dry-run (``dryrun_phase``): ``python -m
   repro_torch.launch.dryrun`` for yi-6b's train_4k, prefill_32k and
   decode_32k on the 16x16 and 2x16x16 production meshes (fake worlds of
   256 and 512 ranks, meta tensors, no device), one niced process a cell
   started after the build and run beside the card phases; each cell's
   run time, per-device bytes, fits_hbm, operations and collective bytes
   printed, every cell required to succeed;
7. one JSON line of per-kernel numbers, then the result line.

Imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): f32 outside
# the tensor cores and HBM3 bandwidth.  bound_ms is the larger of the two
# times for a call's operations and bytes.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12
# dense TF32 on the tensor cores; the kernels that split each f32 operand
# into two TF32 terms (csrc/tf32x3.cuh) issue three products per product
PEAK_TF32_FLOPS = 495e12
# dense bf16 on the tensor cores (f32 accumulation): the least time for a
# bf16 instance's work, whose bf16 products are exact in f32
PEAK_BF16_FLOPS = 989e12
TF32X3_KERNELS = ("streamed_matmul", "flash_attention", "conv2d",
                  "conv2d_encode", "conv2d_decode", "conv2d_decode_encode",
                  "flash_attention_lse", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkdv")
# the bf16 attention kernels issue their own bf16 products: s (and dP) once,
# and each product of an f32 intermediate once a piece of it (PIECES = 2 of
# P or dS, csrc/bf16_mma.cuh).  The forward pair
# (csrc/flash_attention_bf16.cu) takes s and P v, 1 + PIECES products where
# 2 are counted; the backward pair (csrc/flash_attention_bwd_bf16.cu) s, dP
# and dQ (dq) or dV and dK (dkdv), against the counted 3 and 4.  Their own
# bound (bound_products_ms) takes the counted operations times these at
# PEAK_BF16_FLOPS.
PIECES = 2
BF16_PRODUCTS = {"flash_attention_bf16": (1 + PIECES) / 2,
                 "flash_attention_lse_bf16": (1 + PIECES) / 2,
                 "flash_attention_bwd_dq_bf16": (2 + PIECES) / 3,
                 "flash_attention_bwd_dkdv_bf16": (2 + 2 * PIECES) / 4}

FRAMES = 3
REPS = 20
SPIN_CYCLES = 2_000_000    # about 1 ms at the H100's boost clock
# the global pool's tree vs the plain mean: two f32 trees that sum in
# different orders, |kernel - plain| <= POOL_TOL * mean |x| per channel
POOL_TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Path:
    name: str
    builder: str
    kwargs: dict
    launches: dict          # per frame, kernels not named launch 0 times
    bfp8_edges: int
    #: None for the DSE plan; else the hand-cut plan
    #: ``hand_cut_plan(g, 1, depth_thresh=...)``, saved with
    #: ``Compiled.save`` and run from ``Compiled.load``
    depth_thresh: float | None = None


# X3D-M's stage widths (build_x3d_m), 16 frames of 128 x 128 after the stem
X3D_M = dict(positions=16 * 128 * 128, cin=3, widths=(24, 48, 96, 192),
             expansion=2, depth=2)


PATHS = (
    # the 8 weight layers with K > 128, 9 relus (4 encode a skip), 4 pools,
    # 4 skip decodes at the concats
    Path("unet", "build_unet_exec",
         dict(positions=368 * 480, base=64, levels=5),
         {"streamed_matmul": 8, "act_relu": 5, "act_relu_encode": 4,
          "pool": 4, "bfp8_dequant": 4}, 4),
    # X3D-M's stage widths (build_x3d_m) at expansion 2 and depth 2: the 8
    # SE bottleneck convs at m = 1 and the head through conv2d, 9 dwconvs,
    # 4 standalone encodes (add_14 and three fragmented stage-end convs),
    # the feature-bank skip encoded by its pool, 9 pools (4 global), 13
    # relus (1 encodes), 6 decodes, 5 fragmented layers with K > 128
    Path("x3d", "build_x3d_exec", X3D_M,
         {"conv2d": 9, "dwconv": 9, "bfp8_quant": 4, "pool_encode": 1,
          "pool": 9, "act_relu": 12, "act_relu_encode": 1,
          "bfp8_dequant": 6, "streamed_matmul": 5}, 6),
    # the hand-cut plans, nothing fragmented: the 10 edges deeper than 4096
    # words (the skips; 3 encoded by a conv, 4 by a dwconv, 1 each by a
    # relu, a pool and the standalone quant)
    Path("x3d-evict-deep", "build_x3d_exec", X3D_M,
         {"conv2d": 23, "conv2d_encode": 3, "dwconv": 5, "dwconv_encode": 4,
          "pool": 9, "pool_encode": 1, "act_relu": 12, "act_relu_encode": 1,
          "bfp8_quant": 1, "bfp8_dequant": 10}, 10, 4096.0),
    # ... and the streams at 128 and 64 words: single-input consumers
    # decode inside their own launch
    Path("x3d-evict-mid", "build_x3d_exec", X3D_M,
         {"conv2d": 18, "conv2d_decode": 5, "conv2d_decode_encode": 3,
          "dwconv": 1, "dwconv_decode": 4, "dwconv_decode_encode": 4,
          "pool": 5, "pool_encode": 1, "pool_decode": 4, "act_relu": 4,
          "act_relu_encode": 9, "bfp8_quant": 11, "bfp8_dequant": 11},
         31, 96.0),
    # every stream: every op with one input decodes and encodes in one
    # launch, the SE global pools among them (k up to 262144)
    Path("x3d-evict-all", "build_x3d_exec", X3D_M,
         {"conv2d_decode_encode": 26, "dwconv_decode_encode": 9,
          "pool_decode_encode": 10, "act_relu_decode_encode": 13,
          "bfp8_quant": 11, "bfp8_dequant": 21}, 79, 0.0),
)


@dataclasses.dataclass(frozen=True)
class StreamPath:
    """A pipelined path: ``launches`` per tick (every stage runs at every
    tick, bubbles included, so a stream launches ticks x the table)."""
    name: str
    builder: str
    kwargs: dict
    plan: str               # "dse" or "three-stage" (hand_cut_plan)
    microbatches: int
    ticks: int
    launches: dict          # per tick, kernels not named launch 0 times
    bfp8_edges: int
    crossings: int          # stage-crossing edges (shift registers)


# YOLOv8n's neck widths at the 1280 setting's P3 (160x160 positions)
YOLO = dict(positions=160 * 160, widths=(64, 128, 256), head=64)
STREAM_PATHS = (
    # the DSE plan: one stage, conv_24 and conv_27 BFP8-evicted and encoded
    # by their own conv2d launch; 4 fragmented convs with K > 128 (conv_8,
    # K = 128, is a plain dot), 6 relus, 4 pools, 2 decodes at the output
    StreamPath("yolo", "build_yolo_head_exec", YOLO, "dse", 8, 8,
               {"conv2d": 6, "conv2d_encode": 2, "streamed_matmul": 4,
                "act_relu": 6, "pool": 4, "bfp8_dequant": 2}, 2, 0),
    # the 3-stage plan: 6 BFP8 edges (3 decoded from the crossing shift
    # registers at the tick), 3 raw crossings, nothing fragmented
    StreamPath("yolo-3stage", "build_yolo_head_exec", YOLO, "three-stage",
               8, 10,
               {"conv2d": 10, "conv2d_encode": 3, "act_relu": 3,
                "act_relu_encode": 3, "pool": 4, "bfp8_dequant": 6}, 6, 6),
)
STREAMS = 2
# the ring placement of the 3-stage plan on the one card: its stages on
# streams of their own (``devices=[cuda:0] * 3``).  The delayed runs hold
# one stage's stream back at every tick by about 10 ms, several ticks of
# the host's enqueueing, so that stream falls behind the others
RING_PATH = "yolo-3stage"
RING_DELAYS = (("consumer", -1), ("producer", 0))
RING_SPIN_CYCLES = 10 * SPIN_CYCLES

# the fuzz path: the port's conformance fuzzer on the card, seed 0, every
# case on the kernel route (the generator's last draw, so no other draw
# moves); its act decode-alone launches, counted from the lowering on the
# CPU by tests/test_torch_fuzz.py (cases 0-6, 0-10, 0-11: 4 + 3 + 4 frames)
FUZZ_SEED = 0
FUZZ_CASES = 12
FUZZ_P_PALLAS = 1.0
FUZZ_ACT_DECODE_LAUNCHES = 11
# phase 4 also times the act decode alone at this path's largest
# act_relu_decode_encode launch shape (the fuzz launches are launch-bound)
ACT_DECODE_AT = "x3d-evict-all"

# the served path: the YOLO head's DSE stream behind GraphStreamServer
SERVE_FRAMES = 20           # 2 full streams of 8 and one with 4 bubbles
SERVE_RESIDENT = 4          # results kept on the card; the rest go to host
SERVE_ROUNDS = 3            # timed flushes of SERVE_FRAMES, fresh server
# the SLO the served path is scored against: submit -> result of 20 frames
# queued at once, three streams deep
SERVE_SLO = dict(p50_target_s=0.25, p99_target_s=0.5)

# the autotuned path: the closed-loop search (GraphStreamServer.autotuned)
# on the YOLO head at YOLOv8n's neck widths, planned on the u200 sheet, 12
# candidates (the seed DSE plan, then SA moves, tile moves among them) each
# measured over a stream of 8 microbatches on the kernel route
AUTOTUNE = dict(n_candidates=12, microbatches=8, seed=0, repeats=3,
                warmup=1, kernel_mode="cuda")
AUTOTUNE_SERVED = 20

# the LM serving path: yi-6b at its published widths (32 layers, d_model
# 4096, 32 heads, 4 KV heads of 128, d_ff 11008, vocab 64000; f32, about
# 6.06 B parameters) behind ServingEngine, weights from a seeded generator
# on the card; 8 seeded prompts of 64-512 tokens (the first 512) through 4
# slots, 32 new tokens each, no EOS; finished requests' KV pages BFP8-evicted
# to the host past 2 parked on the card
# then olmoe-1b-7b at its published widths (16 layers, d_model 2048, 16
# heads of 128, 64 experts top 8 of d_ff 1024, vocab 50304; about 6.92 B
# parameters) the same way, after yi-6b is released; then xlstm-1.3b at its
# published widths and full depth (48 layers, 7 mLSTM : 1 sLSTM, d_model
# 2048, 4 heads, mLSTM inner width 4096; about 1.41 B parameters), its
# prompts multiples of 64 (the mLSTM chunk rule); then one period of
# jamba-v0.1-52b's pattern at its published widths (8 of its 32 layers:
# Mamba x4, attention, Mamba x3, d_model 4096, Mamba inner 8192 with d_state
# 16, 32 heads / 8 KV of 128, 16 experts top 2 of d_ff 14336 at the odd
# positions, vocab 65536; about 13.3 B parameters, 53 GB in f32); then
# qwen2-vl-72b at its published widths (d_model 8192, 64 heads / 8 KV of
# 128, d_ff 29568, vocab 152064, M-RoPE sections (16, 24, 24)) with its depth
# cut to 8 of its 80 layers (about 9.51 B parameters, 38 GB in f32; the whole
# model's 291 GB does not fit), served on text positions as the reference's
# engine serves it, plus one prefill with patch embeddings.  Each entry:
# (arch, tag, layers kept or None for the published depth, working type).
# lm-serve-bf16 serves yi-6b in bf16, the reference's default working type,
# through the bf16 instance of flash_attention, on the same prompts and
# schedule as lm-serve
LM_PATHS = (("yi-6b", "lm-serve", None, "float32"),
            ("yi-6b", "lm-serve-bf16", None, "bfloat16"),
            ("olmoe-1b-7b", "lm-moe", None, "float32"),
            ("xlstm-1.3b", "lm-xlstm", None, "float32"),
            ("jamba-v0.1-52b", "lm-jamba", 8, "float32"),
            ("qwen2-vl-72b", "lm-qwen2vl", 8, "float32"))
# qwen2-vl's prefill with patches: (prompt tokens, patch positions), the
# config's 1024 patch embeddings in place of the first token embeddings
LM_PATCH_PROMPT = (1536, 1024)
LM_SEED = 0
LM_REQUESTS = 8
LM_SLOTS = 4
LM_S_MAX = 1024
LM_MAX_NEW = 32
LM_RESIDENT = 2
# kernel route vs plain route on first-token logits and KV pages: f32 sums
# in another order through 32 layers; also a router near-tie (the two
# experts' plain-route logits within LM_TOL x max |logit|) under which a
# mixture of experts may choose another expert
LM_TOL = 2e-4              # of max |plain|
# bf16's unit round-off: a rounding to bf16 moves x by at most BF16_U |x|,
# and one bf16 ulp of x is at most 2 BF16_U |x|
BF16_U = 2.0 ** -8
# a bf16 path's kernel route against its plain route: the two differ only
# in attention, whose kernel output is within one ulp of its plain version
# (phase 4), and each layer passes that on through its own bf16 roundings:
# a layer adds at most one ulp of the largest magnitude, 2 BF16_U of it.
# Whether an element's rounding goes up or down on one route and not the
# other is decided by f32 sums taken in another order, so the layers' ulps
# come with independent signs and add in quadrature, not in line: L layers
# (in training, and their backward, 2 L) stand at 2 BF16_U sqrt(L) of max
# |plain|
def bf16_route_tol(depth: int) -> float:
    return 2 * BF16_U * math.sqrt(depth)


# a host-evicted page back through the BFP8 codec, relative to max |page|
# (the reference's test_bfp8_page_roundtrip_numerics)
LM_BFP8_REL = 0.05
FLASH_TOL = 2e-4           # rtol = atol, the reference's for its kernel
# the decode-equivalence invariant of a recurrent model without experts
# (xlstm): (tokens, tokens prefilled) pairs; each step's logits against the
# full forward's at its position.  mLSTM takes a prompt of S <= 64 tokens or
# a multiple of 64, so S - 8 and S are both allowed only up to S = 64; the
# longer pair carries the state across 7 chunks and decodes 64 steps
LM_DECODE_EQ = ((64, 56), (512, 448))
# the encoder-decoder path: whisper-large-v3 at its published widths and
# depth (32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64, 1500
# encoder frames, d_ff 5120, vocab 51866; about 1.60 B parameters, 6.4 GB in
# f32), served through make_prefill_step / make_decode_step (the engine
# takes no encoder frames): a batch of 4 seeded frame embeddings (4, 1500,
# 1280) and 4 seeded prompts of 64 tokens, s_max 448 (the published decoder
# context), 32 greedy new tokens; its decode equivalence prefills 56 of 64
WHISPER = dict(arch="whisper-large-v3", tag="lm-whisper", batch=4,
               prompt=64, s_max=448, new=32, decode_eq=((64, 56),))
# rtol = atol, elementwise, the reference's own for this invariant
# (tests/test_archs.py::test_decode_matches_full_forward, at its reduced
# size): the chunkwise mLSTM and the step-by-step decode sum in different
# orders by construction, here through 48 layers
LM_DECODE_TOL = 2e-3

# the LM training path (lm-train; lm-train-xlstm and lm-train-jamba take the
# same TRAIN_SEQ, TRAIN_STEPS and TRAIN_OPT, below): yi-6b at its published
# widths, f32, int8 AdamW states, remat "full", one microbatch of 1 x 1024
# tokens (the batch of
# TokenPipeline(DataConfig(vocab=64000, seq_len=1024, global_batch=1)) at
# step 0, repeated), 4 optimizer steps; then its reduced form, 2 x 128
# tokens in two microbatches.  The schedule is the train launcher's
# (AdamWConfig(lr=3e-4, total_steps=4, quantize_states=True): 100 warmup
# steps).  With one warmup step the first step raises yi-6b's loss on both
# attention routes and the fourth stays above the first
# (examples/torch_train_schedules.py, PERF.md)
TRAIN_ARCH = "yi-6b"
TRAIN_SEQ = 1024
TRAIN_STEPS = 4
TRAIN_OPT = dict(lr=3e-4, total_steps=4, quantize_states=True)
TRAIN_KEEP = ("mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo")
TRAIN_REDUCED = dict(seq_len=128, global_batch=2, microbatches=2)
# lm-train-bf16: the same yi-6b step in bf16 (parameters and gradients
# bf16, int8 AdamW states, the bf16 attention instances), the same batch.
# Its schedule holds the first step's learning rate, 3e-6, and decays it.
# Under TRAIN_OPT's growing warmup (3e-6, 6e-6, 9e-6) the fourth bf16 loss
# rises past the first on both attention routes alike
# (examples/torch_train_schedules.py --dtype bfloat16, PERF.md §6): with
# int8 states a row's v rounds to 0 where its gradient is small, the update
# there is amplified (m / (sqrt(v) + eps)), and a bf16 weight moves by
# little else (lr is below half an ulp of every weight above 1.5e-3).  The
# port's bf16 update equals the reference's to one ulp at every element,
# amplified ones included (tests/test_torch_bf16.py); the port's first
# rises at a depth of 29 to 32 of the 32 layers (torch_train_schedules.py
# --layers), and whether the reference's own bf16 step overshoots alike
# there is open (ROADMAP.md, Queue 3, fault 7)
TRAIN_BF16_TAG = "lm-train-bf16"
TRAIN_BF16_OPT = dict(lr=3e-6, warmup_steps=1, total_steps=4,
                      quantize_states=True)
# lm-train-xlstm and lm-train-jamba: training on the recurrent mixers, f32,
# the same step and batch as lm-train (int8 AdamW states, TRAIN_OPT, remat
# "full", 1 x TRAIN_SEQ tokens of TokenPipeline batch 0, repeated,
# TRAIN_STEPS steps): xlstm-1.3b at its published widths, its depth cut
# from 48 to 16 layers (2 of its 6 periods of 7 mLSTM and 1 sLSTM; the 48
# layers, 1,415,287,120 parameters, took 25.7-39.0 s a step, a third of the
# script's time; 16 mLSTM chunks of 64 in 4 outer groups of 4 and 8 sLSTM
# chunks of 128 steps a layer); jamba-v0.1-52b at its
# published widths, one period (8 of 32 layers) with its experts cut from 16
# to 4, top 2 kept (4,868,567,040 parameters, 19.5 GB; 16 experts make 53
# GB of weights before a gradient).  Each entry: (arch, tag, layers kept or
# None, experts kept or None)
TRAIN_RECURRENT = (("xlstm-1.3b", "lm-train-xlstm", 16, None),
                   ("jamba-v0.1-52b", "lm-train-jamba", 8, 4))
# lm-train-jamba's full gradients held across the routes: the attention
# layer's projections (position 4 of the period) and the first Mamba
# layer's in_proj and A_log
TRAIN_JAMBA_KEEP = ("pos_4/mixer/wq", "pos_4/mixer/wk", "pos_4/mixer/wv",
                    "pos_4/mixer/wo", "pos_0/mixer/in_proj",
                    "pos_0/mixer/A_log")
# xlstm has no kernel, so lm-train-xlstm holds the card to the CPU in place
# of a route: the reduced xlstm's loss and every gradient leaf from one
# tree on both, B x S tokens of TokenPipeline batch 0 (S = 256: 4 mLSTM
# chunks in 2 outer groups, 2 sLSTM chunks), within TRAIN_TOL x max(1,
# max|cpu|); the CPU tests hold that CPU gradient to the reference
TRAIN_XLSTM_CHECK = dict(seq_len=256, global_batch=2)
# lm-train-whisper: the encoder-decoder trained, whisper-large-v3 at its
# published widths and depth (32 encoder and 32 decoder layers, d_model
# 1280, 20 heads of 64, 1500 encoder frames; 1,601,198,080 parameters),
# f32, int8 AdamW states, TRAIN_OPT, remat "full" (the decoder's groups;
# the encoder keeps its activations, as the reference), one microbatch of 4
# x 448 tokens of TokenPipeline batch 0 (448 the decoder's context,
# WHISPER["s_max"]) over 4 x 1500 seeded frame embeddings, repeated,
# TRAIN_STEPS steps; then the same in bf16 (lm-train-whisper-bf16,
# TRAIN_BF16_OPT).  A step launches flash_attention_lse 32 times in the
# encoder and 2 x 2 x 32 in the decoder (self and cross, forward and
# recompute), and each backward kernel 32 + 2 x 32 times.  The routes are
# held on one gradient of the batch accumulated in f32 over 4 microbatches
# of 1 (the plain route keeps the encoder's attention probabilities, about
# 46 GB at batch 4): the loss, every leaf's gradient norm and the full
# gradients of TRAIN_WHISPER_KEEP (bf16: each full gradient also beside
# both routes' distances from the plain route's f32 run, whisper_bf16_full)
TRAIN_WHISPER = dict(tag="lm-train-whisper", batch=4, seq=448, route_mbs=4)
TRAIN_WHISPER_KEEP = tuple(
    (f"{stack}/pos_0/{part}/{w}", layer)
    for stack, part, layer in (("encoder/groups", "mixer", 0),
                               ("groups", "mixer", 31),
                               ("groups", "cross", 31))
    for w in ("wq", "wk", "wv", "wo"))
# the staged executor (runtime/reconfigure.py): lm-staged runs yi-6b in f32
# on the weights lm-serve made, through STAGED_YI_STAGES stages, and then
# jamba-v0.1-52b in bf16 at its published widths, as many whole periods of
# its pattern (each a layer group of 8: a stage) as fit in half the host's
# memory (all 4, the full depth, from 160 GB up; at least 2), on
# STAGED_TOKENS seeded tokens
STAGED_YI_STAGES = 4
STAGED_TOKENS = (2, 512)
STAGED_ARCH = "jamba-v0.1-52b"
STAGED_MIN_PERIODS = 2
STAGED_AGREE = 0.9          # the reference's own argmax agreement, codec on
STAGED_COMPRESSION = 0.6    # and its boundary compression bound
# kernel route vs plain route (lm-train, lm-train-reduced, lm-train-jamba)
# or the card vs the CPU (lm-train-xlstm's reduced check), a gradient, a
# norm or the loss: of max(1, max|plain|), the port's vertex tolerance (f32
# sums in another order through the layers and their recompute)
TRAIN_TOL = 2e-4
# a BFP8 checkpoint round trip, of max|w| (the reference's
# test_bfp8_roundtrip_close)
TRAIN_BFP8_REL = 0.02
# the train step on a device mesh (mesh_phase): (a) a world of one, yi-6b
# whole, one TRAIN_OPT step of lm-train's batch on make_host_mesh() against
# the unsharded step, bit for bit; (c) make_pod_compressed_grad_fn on two
# gloo ranks forming the pod axis, yi-6b at its published widths cut to
# MESH_POD_LAYERS layers, MESH_POD x MESH_POD_SEQ tokens, held within
# MESH_POD_REL of the exact mean (the reference's TestPodCompression
# bound).  Part (b), the 2x2 mesh of four gloo ranks sharing the card, runs
# only in the CPU tests (tests/test_torch_mesh.py): on the card gloo's
# functional all-gather of CUDA tensors, which DTensor's redistribution
# calls, ends its process with a segmentation fault (PERF.md §6;
# examples/torch_gloo_cuda_collectives.py)
MESH_ONE_TAG = "lm-mesh-1"
MESH_KEEP = ("embed",) + TRAIN_KEEP
# (a) also serves on that mesh (lm-mesh-serve): yi-6b whole, one prefill of
# 1 x MESH_SERVE_SEQ tokens (TokenPipeline batch 0) and MESH_SERVE_DECODES
# decode steps of seeded tokens through make_prefill_step /
# make_decode_step(mesh=), a cache of MESH_SERVE_S_MAX, bit for bit the
# unsharded steps (the last logits, every decode's logits, every cache
# leaf after each step) with the unsharded prefill's flash_attention
# launches; and times the train step on the mesh against the unsharded one
# in turns, MESH_TURNS steps each alternating on one training state,
# medians of steps 2-4 as train_phase reports
MESH_SERVE_TAG = "lm-mesh-serve"
MESH_SERVE_SEQ = 1024
MESH_SERVE_DECODES = 4
MESH_SERVE_S_MAX = 2048
MESH_TURNS = 4
# the dry-run (dryrun_phase): python -m repro_torch.launch.dryrun for
# DRYRUN_ARCH's DRYRUN_SHAPES on both production meshes (fake worlds of 256
# and 512 ranks, meta tensors, no device), one process a cell, started
# niced beside the card phases (after the build) and collected at the end;
# every cell must succeed.  Records under results/dryrun_smoke/
DRYRUN_ARCH = "yi-6b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_OUT = ROOT / "results" / "dryrun_smoke"
DRYRUN_TIMEOUT = 900
MESH_POD = 2
MESH_POD_LAYERS = 2
MESH_POD_SEQ = 512
MESH_POD_REL = 0.02
MESH_TIMEOUT = 240

# the walkthroughs (examples/torch_*.py), each main run in-process on the
# card at the arguments their docstrings and the README give, and the lines
# each must print: the counters its schedule fixes, the same as the
# reference package's example prints at these arguments
WALK_GRAPH = ("--channel", "weighted-fair", "--channel-gbps", "0.5",
              "--onchip-kbits", "300")
WALKTHROUGHS = (
    ("torch_quickstart", ("--device", "zcu102"),
     ("  evictions  : 1 edges", "  fragmented : 23 layers (mean m=1.00)")),
    ("torch_quickstart", ("--model", "unet_exec", "--mode", "pipelined",
                          "--execute") + WALK_GRAPH,
     ("executed (pipelined): output shape (2048,)",
      "  prefetch deadline misses: 8 {0: 8}")),
    ("torch_serve_batched", ("--arch", "yi-6b", "--requests", "6",
                             "--max-new", "12"),
     ("  prefills      : 6", "  decode steps  : 22 (continuous batching: "
      "66 tokens through 3 slots)", "  evicted pages : 12 ")),
    ("torch_serve_batched", ("--model", "unet_exec") + WALK_GRAPH,
     ("served 6/6 frames of unet_exec (pipelined, u200)",
      "  prefetch deadline misses: 4 {0: 4}")),
    ("torch_train_small", ("--steps", "60", "--arch", "yi-6b"),
     ("  restored at step 20",)),
    ("torch_long_context", ("--arch", "xlstm-1.3b"),
     ("  ctx= 1024:", "  stages=1 ")),
)
# fragmented_matmul on the card at one of the UNet path's streamed_matmul
# launch shapes (the one with the most weights, then the most weight rows),
# at these fractions
FRAG_PATH = "unet"
FRAG_FRACTIONS = (0.0, 0.25, 0.5, 1.0)

TPU_SRC = {
    "streamed_matmul": "src/repro/kernels/streamed_matmul.py:31",
    "act_relu": "src/repro/kernels/streaming_conv.py:409",
    "act_relu_encode": "src/repro/kernels/streaming_conv.py:418",
    "pool": "src/repro/kernels/streaming_conv.py:320",
    "bfp8_dequant": "src/repro/kernels/bfp8.py:55",
    "conv2d": "src/repro/kernels/streaming_conv.py:81",
    "dwconv": "src/repro/kernels/streaming_conv.py:200",
    "bfp8_quant": "src/repro/kernels/bfp8.py:51",
    "pool_encode": "src/repro/kernels/streaming_conv.py:330",
    "conv2d_encode": "src/repro/kernels/streaming_conv.py:91",
    "conv2d_decode": "src/repro/kernels/streaming_conv.py:86",
    "conv2d_decode_encode": "src/repro/kernels/streaming_conv.py:97",
    "dwconv_encode": "src/repro/kernels/streaming_conv.py:217",
    "dwconv_decode": "src/repro/kernels/streaming_conv.py:209",
    "dwconv_decode_encode": "src/repro/kernels/streaming_conv.py:229",
    "pool_decode": "src/repro/kernels/streaming_conv.py:325",
    "pool_decode_encode": "src/repro/kernels/streaming_conv.py:339",
    "act_relu_decode_encode": "src/repro/kernels/streaming_conv.py:426",
    "act_relu_decode": "src/repro/kernels/streaming_conv.py:413",
    "flash_attention": "src/repro/kernels/flash_attention.py:24",
    "flash_attention_lse": "src/repro/kernels/flash_attention.py:24",
    # no Pallas counterpart: the gradient XLA takes of chunked_attention
    "flash_attention_bwd_dq": "src/repro/models/attention.py:68",
    "flash_attention_bwd_dkdv": "src/repro/models/attention.py:68",
    # the bf16 instances: the Pallas kernel is type-generic (its blocks in
    # f32, its output in o_ref's type); the backward pair is XLA's gradient
    # of chunked_attention in bf16
    "flash_attention_bf16": "src/repro/kernels/flash_attention.py:24",
    "flash_attention_lse_bf16": "src/repro/kernels/flash_attention.py:24",
    "flash_attention_bwd_dq_bf16": "src/repro/models/attention.py:68",
    "flash_attention_bwd_dkdv_bf16": "src/repro/models/attention.py:68",
}
CUDA_SRC = {
    "streamed_matmul": "src/repro_torch/csrc/streamed_matmul.cu",
    "act_relu": "src/repro_torch/csrc/streaming_conv.cu",
    "act_relu_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "pool": "src/repro_torch/csrc/streaming_conv.cu",
    "bfp8_dequant": "src/repro_torch/csrc/bfp8.cu",
    "conv2d": "src/repro_torch/csrc/conv2d.cu",
    "dwconv": "src/repro_torch/csrc/dwconv.cu",
    "bfp8_quant": "src/repro_torch/csrc/bfp8.cu",
    "pool_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "conv2d_encode": "src/repro_torch/csrc/conv2d.cu",
    "conv2d_decode": "src/repro_torch/csrc/conv2d_decode.cu",
    "conv2d_decode_encode": "src/repro_torch/csrc/conv2d_decode.cu",
    "dwconv_encode": "src/repro_torch/csrc/dwconv.cu",
    "dwconv_decode": "src/repro_torch/csrc/dwconv.cu",
    "dwconv_decode_encode": "src/repro_torch/csrc/dwconv.cu",
    "pool_decode": "src/repro_torch/csrc/streaming_conv.cu",
    "pool_decode_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "act_relu_decode_encode": "src/repro_torch/csrc/streaming_conv.cu",
    "act_relu_decode": "src/repro_torch/csrc/streaming_conv.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_lse": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkdv": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bf16": "src/repro_torch/csrc/flash_attention_bf16.cu",
    "flash_attention_lse_bf16":
        "src/repro_torch/csrc/flash_attention_bf16.cu",
    "flash_attention_bwd_dq_bf16":
        "src/repro_torch/csrc/flash_attention_bwd_bf16.cu",
    "flash_attention_bwd_dkdv_bf16":
        "src/repro_torch/csrc/flash_attention_bwd_bf16.cu",
}
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
BF16_KERNELS = ("flash_attention_bf16", "flash_attention_lse_bf16",
                "flash_attention_bwd_dq_bf16", "flash_attention_bwd_dkdv_bf16")


def sheet_phase(torch) -> None:
    """The H100 sheets of ``repro_torch.core`` beside what the card
    reports; raises where a sheet claims more than the card has.  Then a
    256 MiB pinned copy each way (CUDA events, median of 10 after one
    warm-up), printed beside ``H100_RUNTIME.offchip_gbps`` and not gated."""
    from repro_torch.core import resources as R
    props = torch.cuda.get_device_properties(0)
    max_sm = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    claims = (("multiprocessors", R.H100_SMS, props.multi_processor_count),
              ("shared memory a multiprocessor, bytes",
               R.H100_SMEM_PER_SM_BYTES,
               props.shared_memory_per_multiprocessor),
              ("HBM, bytes (total_memory)", R.H100_HBM_BYTES,
               props.total_memory),
              ("max SM clock, MHz (clocks.max.sm)", R.H100_FREQ_MHZ, max_sm))
    for what, sheet, has in claims:
        print(f"sheet: {what}: H100 sheets {sheet}, the card {has}")
        if sheet > has:
            raise AssertionError(f"the H100 sheet claims {sheet} {what}, the "
                                 f"card has {has}")
    for dev in (R.H100_KERNEL, R.H100_RUNTIME):
        print(f"sheet: {dev.name}: compute_units {dev.compute_units:.1f} MACs "
              f"a cycle at {dev.freq_mhz} MHz, onchip_bits "
              f"{dev.onchip_bits:.0f}, offchip_gbps {dev.offchip_gbps}")
    n = 256 * 2**20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    for label, dst, src in (("host -> device", dev, host),
                            ("device -> host", host, dev)):
        times = []
        for _ in range(11):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times[1:])
        print(f"sheet: pinned copy of 256 MiB {label}: {ms:.4f} ms, "
              f"{n * 8 / ms / 1e6:.2f} Gbit/s (H100_RUNTIME.offchip_gbps "
              f"{R.H100_RUNTIME.offchip_gbps})")
    del host, dev


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device time of a call over ``reps`` launches, L2 flushed
    before each.  A spin kernel of about 1 ms runs between the flush and
    the first event, so the host has enqueued the whole call before the
    card reaches it and the events time the card's work, not the host's
    wrapper and launch overhead (which phase 5's frame times include); the
    median keeps out a host stall longer than the spin, which puts the
    card's wait into one launch's time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")

    def __call__(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float,
             peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_tf32x3_ms(nbytes: float, flops: float) -> float:
    """The bound of a kernel that runs its products through the 3xTF32
    split: the larger of the bytes' time and the operations' at the split's
    peak, three TF32 products per f32 product.  Below bound_ms where the
    f32 FMA rate sets that."""
    return max(nbytes / PEAK_HBM_BYTES_S, 3.0 * flops / PEAK_TF32_FLOPS) * 1e3


def kernel_phase(torch, timer, path_shapes):
    """Hold every kernel against its plain version at each ``(name, tensor
    shapes)`` a path launched, and time kernel, plain version and
    yardstick.  ``path_shapes`` maps each path to its launch shapes and
    their counts per frame (a staged path) or per stream (a pipelined
    path); a kernel's times and bounds are summed over one frame or stream
    of each path (and kept per path under ``by_path``).  Returns per-kernel
    rows."""
    from repro_torch.kernels import ref, streaming_conv as SC
    from repro_torch.kernels.bfp8 import (bfp8_dequant, bfp8_quant,
                                          bfp8_quant_values)
    from repro_torch.kernels.library import reset_launches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.streamed_matmul import (streamed_matmul,
                                                     streamed_matmul_padded)
    from repro_torch.models.attention import chunked_attention
    # kernel vs plain, f32 sums in another order (streamed_matmul, conv2d):
    # rtol = atol = the tolerance phase 3 holds every vertex of a path to
    from repro_torch.testing.oracle import VERTEX_PARITY_TOL as MATMUL_TOL
    from repro_torch.testing.ulp import bf16_ulp, f32_slack

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def randi8(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    rows = {n: dict(name=n, route="cuda", source=CUDA_SRC[n],
                    replaces=TPU_SRC[n], launches=0, max_abs_err=0.0, ms=0.0,
                    plain_ms=0.0, bound_ms=0.0, bound_by="bytes",
                    library_ms=0.0, by_path={})
            for n in TPU_SRC}
    for n in TF32X3_KERNELS:
        rows[n]["bound_tf32x3_ms"] = 0.0
    for n in BF16_PRODUCTS:
        rows[n]["bound_products_ms"] = 0.0

    def note_err(name, err):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        float(err.max()) if err.numel()
                                        else 0.0)

    def close(name, got, want, rtol, atol):
        err = (got.double() - want.double()).abs()
        note_err(name, err)
        bad = int((err > atol + rtol * want.double().abs()).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} values outside "
                                 f"atol={atol} rtol={rtol}")

    def exact(name, got, want, nan_bits=True):
        """Bit for bit, NaN and the sign of zero included (with
        ``nan_bits=False`` a NaN need only be a NaN where the plain
        version has one: arithmetic on a NaN may set other payload bits)."""
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        if got.dtype == torch.float32:
            if not nan_bits:
                nan = torch.isnan(want)
                if not torch.equal(torch.isnan(got), nan):
                    raise AssertionError(f"{name}: NaN at other places")
                got, want = got[~nan], want[~nan]
            got, want = got.view(torch.int32), want.view(torch.int32)
        elif got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-exact")

    def close_and_repeatable(name, kern, plain, tol):
        """Within rtol = atol = tol of the plain version, and a second
        launch on the same inputs bit for bit the first."""
        got = kern()
        close(name, got, plain(), tol, tol)
        exact(name, kern(), got)

    def within_and_repeatable(name, kern, plain):
        """Every output within TRAIN_TOL x max(1, max|plain|) of the plain
        version's, and a second launch bit for bit the first."""
        got = kern()
        for g, w in zip(got, plain()):
            err = (g.double() - w.double()).abs()
            note_err(name, err)
            lim = TRAIN_TOL * max(1.0, float(w.abs().max()))
            if float(err.max()) > lim:
                raise AssertionError(f"{name}: max abs err "
                                     f"{float(err.max())} > {lim}")
        for a, b in zip(kern(), got):
            exact(name, a, b)

    def within_ulp_and_repeatable(name, kern, plain, slack):
        """A bf16 instance: every bf16 output within one bf16 ulp of the
        plain version's value plus twice its f32 sums' slack (``slack``,
        one per bf16 output in order: testing.ulp.f32_slack), every f32
        output (lse,
        delta) within TRAIN_TOL x max(1, max|plain|), as the f32
        instances, and a second launch bit for bit the first."""
        got = kern()
        slack = iter(slack)
        for g, w in zip(got, plain()):
            w64 = w.double()
            err = (g.double() - w64).abs()
            note_err(name, err)
            top = max(1.0, float(w64.abs().max()))
            if w.dtype == torch.bfloat16:
                bad = int((err > bf16_ulp(w) + 2 * next(slack)).sum())
            else:
                bad = int((err > TRAIN_TOL * top).sum())
            if bad:
                raise AssertionError(f"{name}: {bad} of {err.numel()} "
                                     f"values past one bf16 ulp (f32: "
                                     f"{TRAIN_TOL} x max(1, max|plain|)); "
                                     f"max abs err {float(err.max())}")
        for a, b in zip(kern(), got):
            exact(name, a, b)

    def train_attention(kind, B, S, H, D, causal=True, Sk=None):
        """Inputs of one training-attention launch, q and dO (B, S, H, D)
        over k, v (B, Sk, H, D) (Sk == S unless given; keys of their own
        length are non-causal): (check, kernel, plain, yardstick or None,
        bytes, operations).  o and lse come from the plain forward; the
        yardstick is F.scaled_dot_product_attention in the instance's type,
        forward for the lse instance, its autograd backward (dq, dk and dv
        together) for each backward kernel.  A ``_bf16`` kind takes bf16 q,
        k, v, o and dO (lse and delta f32)."""
        base = kind.removesuffix("_bf16")
        dtype = torch.float32 if kind == base else torch.bfloat16
        es = 4.0 if kind == base else 2.0      # bytes an operand value
        Sk = S if Sk is None else Sk
        q, do = (randn(B, S, H, D).to(dtype) for _ in range(2))
        k, v = (randn(B, Sk, H, D).to(dtype) for _ in range(2))
        # o in f32 before its rounding, as FlashAttention keeps it for the
        # backward
        _, lse, o = chunked_attention(q, k, v, causal=causal,
                                      chunk=min(1024, Sk), skip_masked=causal,
                                      return_lse=True)
        n, nk = B * S * H * D, B * Sk * H * D   # values of q, of k

        def check(kern, plain):
            if dtype == torch.float32:
                return lambda: within_and_repeatable(kind, kern, plain)

            def held():
                sl = f32_slack(q, k, v, causal, do)
                within_ulp_and_repeatable(kind, kern, plain, {
                    "flash_attention_lse": (sl["o"],),
                    "flash_attention_bwd_dq": (sl["dq"],),
                    "flash_attention_bwd_dkdv": (sl["dk"], sl["dv"]),
                }[base])
            return held
        # the forward's two products over the causal triangle (diagonal
        # included) or the S x Sk rectangle
        fwd = 2.0 * B * H * D * (S * (S + 1) if causal else 2 * S * Sk)
        if base == "flash_attention_lse":
            kern = lambda: FA.flash_attention_lse(     # noqa: E731
                q, k, v, causal=causal)
            plain = lambda: chunked_attention(          # noqa: E731
                q, k, v, causal=causal, chunk=min(1024, Sk),
                skip_masked=causal, return_lse=True)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal)
            # q, k, v in; o, lse (and a bf16 instance's f32 o) out
            return (check(kern, plain), kern, plain, lib,
                    es * (2 * n + 2 * nk) + (4.0 * n if es < 4 else 0.0)
                    + 4.0 * B * H * S, fwd)
        if base == "flash_attention_bwd_dq":
            kern = lambda: FA.flash_attention_bwd_dq(  # noqa: E731
                q, k, v, o, do, lse, causal)
            plain = lambda: FA.flash_attention_bwd_dq_plain(  # noqa: E731
                q, k, v, o, do, lse, causal)
            # q, k, v, dO, lse and o (f32) in; dq, delta out; s, dP and dQ
            nbytes = es * (3 * n + 2 * nk) + 4.0 * n + 8.0 * B * H * S
            ops = 1.5 * fwd
        else:
            delta = FA.flash_attention_bwd_dq_plain(q, k, v, o, do, lse,
                                                    causal)[1]
            kern = lambda: FA.flash_attention_bwd_dkdv(  # noqa: E731
                q, k, v, do, lse, delta, causal)
            plain = lambda: FA.flash_attention_bwd_dkdv_plain(  # noqa: E731
                q, k, v, do, lse, delta, causal)
            # q, k, v, dO, lse, delta in; dk, dv out; s, dP, dV and dK
            nbytes = es * (2 * n + 4 * nk) + 8.0 * B * H * S
            ops = 2.0 * fwd
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(     # noqa: E731
            ot, (qt, kt, vt), dot, retain_graph=True)
        return check(kern, plain), kern, plain, lib, nbytes, ops

    def flash_case(B, S, Sk, H, D, causal, dtype=torch.float32):
        """Inputs of one flash_attention launch, q (B, S, H, D) over k, v
        (B, Sk, H, D) of ``dtype`` (bf16: the flash_attention_bf16
        instance): (check, kernel, plain, SDPA at the same shapes and type,
        bytes, operations)."""
        q = randn(B, S, H, D).to(dtype)
        k, v = (randn(B, Sk, H, D).to(dtype) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kern = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: chunked_attention(                 # noqa: E731
            q, k, v, causal=causal, chunk=min(1024, Sk), skip_masked=causal)
        # bytes: q, k, v read and o written once; operations: the two
        # products over the causal triangle, diagonal included, or the
        # S x Sk rectangle
        ops = (2.0 * B * H * D * S * (S + 1) if causal
               else 4.0 * B * H * D * S * Sk)
        if dtype == torch.float32:
            check = lambda: close_and_repeatable(        # noqa: E731
                "flash_attention", kern, plain, FLASH_TOL)
        else:
            check = lambda: within_ulp_and_repeatable(   # noqa: E731
                "flash_attention_bf16", lambda: (kern(),),
                lambda: (plain(),), (f32_slack(q, k, v, causal)["o"],))
        es = q.element_size()
        return (check, kern, plain,
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal),
                2.0 * es * B * H * D * (S + Sk), ops)

    def pool_close(name, got, x, m_out):
        """The global pool: within POOL_TOL * mean |x| of each channel of
        the plain mean of ``x``."""
        m, c = x.shape
        want = ref.pool_ref(x, m_out)
        err = (got.double() - want.double()).abs()
        note_err(name, err)
        lim = POOL_TOL * x.abs().double().reshape(m_out, m // m_out,
                                                  c).mean(1)
        if bool((err > lim).any()):
            raise AssertionError(f"{name}: global pool outside "
                                 f"{POOL_TOL} x mean|x|")

    def flat(out):
        """A wrapper's outputs as a list: y, or y and its payload."""
        return [out] if isinstance(out, torch.Tensor) else [out[0], *out[1]]

    def repeatable(name, kern, got):
        """A second launch bit for bit the first's outputs ``got``."""
        for a, b in zip(flat(kern()), flat(got)):
            exact(name, a, b)

    def check_pool(x, m_out):
        kern = lambda: SC.pool(x, m_out)                       # noqa: E731
        if x.shape[0] // m_out == 2:
            exact("pool", kern(), ref.pool_ref(x, m_out))
            return
        got = kern()
        pool_close("pool", got, x, m_out)
        if x.shape[0] // m_out > SC.POOL_SERIAL_MAX_K:
            repeatable("pool", kern, got)

    def check_dwconv(x, w):
        exact("dwconv", SC.dwconv(x, w), ref.dwconv_ref(x, w))

    # -- the fused-codec variants ----------------------------------------------
    def payload_of(m, c):
        """The codec's payload of a random (m, c) stripe, with random bytes
        in its padding channels: the kernels and the plain versions read
        only the first c."""
        man, exp = bfp8_quant_values(randn(m, c) * 2, block=32,
                                     width=32 * -(-c // 32))
        if c % 32:
            man[:, c:] = randi8(-127, 127, m, man.shape[1] - c)
        return man, exp

    def variant(kind, c, m_out=None, w=None):
        """(kernel, plain version, the un-fused kernel or None) of a codec
        variant; the first two take (x, payload)."""
        op = kind.split("_decode")[0].removesuffix("_encode")
        enc = kind.endswith("_encode")
        if op == "conv2d":
            def body(h):
                return ref.conv2d_ref(h, w)
            fn = functools.partial(SC.conv2d, w=w)
            unfused = lambda h: SC.conv2d(h, w)                 # noqa: E731
        elif op == "dwconv":
            def body(h):
                return ref.dwconv_ref(h, w)
            fn = functools.partial(SC.dwconv, w=w)
            unfused = lambda h: SC.dwconv(h, w)                 # noqa: E731
        elif op == "pool":
            def body(h):
                return ref.pool_ref(h, m_out)
            fn = functools.partial(SC.pool, m_out=m_out, c=c)
            unfused = lambda h: SC.pool(h, m_out)               # noqa: E731
        else:
            body, unfused = ref.act_relu_ref, SC.act_relu
            fn = functools.partial(SC.act_relu, c=c)

        def kern(x, pay):
            return fn(x, payload=pay, encode=enc)

        def plain(x, pay):
            return SC._plain(body, x, c, pay, enc, 32)
        return kern, plain, unfused

    def check_variant(kind, x, pay, c, m_out=None, w=None, nan_bits=True):
        """y bit for bit the un-fused kernel's on the input (the standalone
        decode kernel's output, for a decoding variant) and the payload bit
        for bit the codec's of that y, a conv2d variant's and a pool's over
        more than POOL_SERIAL_MAX_K rows second launch bit for bit its
        first; y within MATMUL_TOL (conv2d) or POOL_TOL (pool, k > 2) of the
        plain version, else bit for bit."""
        kern, plain, unfused = variant(kind, c, m_out, w)
        enc = kind.endswith("_encode")
        got, want = kern(x, pay), plain(x, pay)
        (y, ypay), (py, ppay) = ((got, want) if enc
                                 else ((got, None), (want, None)))
        if kind in TF32X3_KERNELS:
            # the tensor-core kernels: a second launch bit for bit the first
            repeatable(kind, lambda: kern(x, pay), got)
        xin = x if pay is None else bfp8_dequant(*pay, c=c)
        exact(kind, y, unfused(xin), nan_bits)
        if enc:
            ppay = bfp8_quant_values(y, block=32,
                                     width=32 * -(-y.shape[1] // 32))
        if kind.startswith("conv2d"):
            close(kind, y, py, MATMUL_TOL, MATMUL_TOL)
        elif kind.startswith("pool") and xin.shape[0] // m_out > 2:
            pool_close(kind, y, xin, m_out)
            if xin.shape[0] // m_out > SC.POOL_SERIAL_MAX_K:
                repeatable(kind, lambda: kern(x, pay), got)
        else:
            exact(kind, y, py, nan_bits)
        if enc:
            exact(kind, ypay[0], ppay[0])
            exact(kind, ypay[1], ppay[1])

    def codec_case(kind, arg_shapes):
        """A codec variant at one launch's shapes: the input (x, or its
        payload) and y give m, c and m_out, the weight its shape."""
        dec = "_decode" in kind
        ins, rest = arg_shapes[:1 + dec], arg_shapes[1 + dec:]
        m = ins[0][0]
        weighted = kind.startswith(("conv2d", "dwconv"))
        wshape = rest[0] if weighted else None
        m_out, c_out = rest[1] if weighted else rest[0]
        c = wshape[0] if kind.startswith("conv2d") else c_out
        w = None
        if kind.startswith("conv2d"):
            w = randn(*wshape) / math.sqrt(c)
            ops = 2.0 * m * c * c_out
        elif weighted:
            w = randn(*wshape)
            ops = 2.0 * wshape[0] * m * c
        else:
            ops = float(m * c)
        pay = payload_of(m, c) if dec else None
        x = None if dec else randn(m, c)
        kern, plain, _ = variant(kind, c, m_out, w)
        cq, nq = 32 * -(-c // 32), 32 * -(-c_out // 32)
        nbytes = ((m * (cq + cq // 32) if dec else 4.0 * m * c)
                  + (4.0 * w.numel() if w is not None else 0.0)
                  + 4.0 * m_out * c_out)
        if kind.endswith("_encode"):
            nbytes += m_out * (nq + nq // 32)
            ops += 6.0 * m_out * nq
        if dec:
            ops += m * c
        return ((lambda: check_variant(kind, x, pay, c, m_out, w)),
                lambda: kern(x, pay), lambda: plain(x, pay), None, nbytes,
                ops)

    def case(kind, arg_shapes):
        """Inputs at one launch's shapes: (check, kernel, plain, yardstick
        or None, bytes moved, operations)."""
        base = kind.removesuffix("_bf16")
        if base == "flash_attention_lse" or base in BWD_KERNELS:
            # the shapes of q and k first, the causal flag last
            (B, S, H, D), (_, Sk, _, _) = arg_shapes[:2]
            return train_attention(kind, B, S, H, D, arg_shapes[-1], Sk)
        if base == "flash_attention":
            (B, S, H, D), (_, Sk, _, _), _, _, causal = arg_shapes
            return flash_case(B, S, Sk, H, D, causal, torch.float32
                              if kind == base else torch.bfloat16)
        if kind.endswith("_encode") or "_decode" in kind:
            return codec_case(kind, arg_shapes)
        if kind == "streamed_matmul":
            (m, k), (ks, n), (kd, _), _ = arg_shapes
            x = randn(m, k)
            ws, wd = randn(ks, n) / math.sqrt(k), randn(kd, n) / math.sqrt(k)
            w = torch.cat([ws, wd])
            kern = lambda: streamed_matmul(x, ws, wd)          # noqa: E731
            plain = lambda: ref.streamed_matmul_ref(x, ws, wd)  # noqa: E731
            return ((lambda: close_and_repeatable(kind, kern, plain,
                                                  MATMUL_TOL)),
                    kern, plain, lambda: torch.matmul(x, w),
                    4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
        if kind == "conv2d":
            (m, k), (_, n), _ = arg_shapes
            x, w = randn(m, k), randn(k, n) / math.sqrt(k)
            kern = lambda: SC.conv2d(x, w)                     # noqa: E731
            plain = lambda: ref.conv2d_ref(x, w)               # noqa: E731
            return ((lambda: close_and_repeatable(kind, kern, plain,
                                                  MATMUL_TOL)),
                    kern, plain, lambda: torch.matmul(x, w),
                    4.0 * (m * k + k * n + m * n), 2.0 * m * k * n)
        if kind == "dwconv":
            (m, c), (taps, _), _ = arg_shapes
            x, w = randn(m, c), randn(taps, c)
            xt, wt = x.t().contiguous()[None], w.t().contiguous()[:, None]
            return ((lambda: check_dwconv(x, w)),
                    lambda: SC.dwconv(x, w),
                    lambda: ref.dwconv_ref(x, w),
                    lambda: F.conv1d(xt, wt, padding=taps // 2, groups=c),
                    4.0 * (2 * m * c + taps * c), 2.0 * taps * m * c)
        if kind == "act_relu":
            (m, c), _ = arg_shapes
            x = randn(m, c)
            kern = lambda: SC.act_relu(x)                      # noqa: E731
            plain = lambda: ref.act_relu_ref(x)                # noqa: E731
            return ((lambda: exact(kind, kern(), plain())), kern, plain,
                    lambda: torch.relu(x), 8.0 * m * c, m * c)
        if kind == "pool":
            (m, c), (m_out, _), *_ = arg_shapes
            x = randn(m, c)
            kern = lambda: SC.pool(x, m_out)                   # noqa: E731
            plain = lambda: ref.pool_ref(x, m_out)             # noqa: E731
            return ((lambda: check_pool(x, m_out)), kern, plain,
                    lambda: x.view(m_out, m // m_out, c).mean(1),
                    4.0 * (m * c + m_out * c), m * c)
        # the codec: an (r, c) stripe and its payload, w = 32 nb wide; the
        # quant reads the stripe and writes the whole payload, the dequant
        # reads the c mantissas a row it decodes and writes the stripe
        if kind == "bfp8_quant":
            (r, c), (_, w), (_, nb) = arg_shapes
            x = randn(r, c) * 4
            kern = lambda: bfp8_quant(x, width=w)              # noqa: E731
            plain = lambda: bfp8_quant_values(                 # noqa: E731
                x, block=32, width=w)

            def check():
                (man, exp), (pman, pexp) = kern(), plain()
                exact(kind, man, pman)
                exact(kind, exp, pexp)
            return (check, kern, plain, None, 4.0 * r * c + r * (w + nb),
                    6.0 * r * c)
        (r, w), (_, nb), (_, c) = arg_shapes                   # bfp8_dequant
        man, exp = randi8(-127, 127, r, w), randi8(-30, 20, r, nb)
        kern = lambda: bfp8_dequant(man, exp, c=c)             # noqa: E731
        plain = lambda: ref.bfp8_dequant_ref(man, exp, c=c)    # noqa: E731
        return ((lambda: exact(kind, kern(), plain())), kern, plain, None,
                5.0 * r * c + r * nb, r * c)

    # -- at the paths' shapes: correctness, then times per frame or stream ----
    # a kernel's bound_by: what bounds most of its summed bound time
    bound_parts = collections.defaultdict(collections.Counter)
    union = collections.Counter()
    for shapes in path_shapes.values():
        union.update(shapes)
    pool_shapes = []        # (input, m_out, bytes, ms, library ms, launches)
    codec_shapes = []       # (kind, stripe, width, bytes, ms, bound, launches)
    for key in sorted(union):
        kind, arg_shapes = key
        check, kern, plain, lib, nbytes, ops = case(kind, arg_shapes)
        check()
        t_kern, t_plain = timer(kern), timer(plain)
        t_lib = None if lib is None else timer(lib)
        if kind == "pool":
            pool_shapes.append((arg_shapes[0], arg_shapes[1][0], nbytes,
                                t_kern, t_lib, union[key]))
        b, bound_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS
                               if kind in BF16_KERNELS else PEAK_F32_FLOPS)
        if kind in ("bfp8_quant", "bfp8_dequant"):
            stripe, payload = ((arg_shapes[0], arg_shapes[1]) if kind ==
                               "bfp8_quant" else (arg_shapes[2],
                                                  arg_shapes[0]))
            codec_shapes.append((kind, stripe, payload[1], nbytes, t_kern, b,
                                 union[key]))
        b3 = (bound_tf32x3_ms(nbytes, ops) if kind in TF32X3_KERNELS
              else None)
        bp = (bound_ms(nbytes, ops * BF16_PRODUCTS[kind], PEAK_BF16_FLOPS)[0]
              if kind in BF16_PRODUCTS else None)
        print(f"  {kind} {arg_shapes}: ms {t_kern:.4f} plain {t_plain:.4f} "
              f"library {'-' if t_lib is None else f'{t_lib:.4f}'} bound "
              f"{b:.4f} ({bound_by})"
              f"{'' if b3 is None else f', 3xTF32 bound {b3:.4f}'}"
              f"{'' if bp is None else f', own products bound {bp:.4f}'}, "
              f"on the paths x{union[key]}")
        row = rows[kind]
        for pname, shapes in path_shapes.items():
            n = shapes.get(key, 0)
            if not n:
                continue
            row["ms"] += n * t_kern
            row["plain_ms"] += n * t_plain
            row["library_ms"] = None if t_lib is None else (
                row["library_ms"] + n * t_lib)
            row["bound_ms"] += n * b
            if b3 is not None:
                row["bound_tf32x3_ms"] += n * b3
            if bp is not None:
                row["bound_products_ms"] += n * bp
            bound_parts[kind][bound_by] += n * b
            row["bound_by"] = max(bound_parts[kind],
                                  key=bound_parts[kind].get)
            p = row["by_path"].setdefault(pname, dict(
                launches=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                library_ms=None if t_lib is None else 0.0))
            p["launches"] += n
            p["ms"] += n * t_kern
            p["plain_ms"] += n * t_plain
            p["bound_ms"] += n * b
            if t_lib is not None:
                p["library_ms"] += n * t_lib
    print("  pool against view(...).mean, per launch shape (input -> output "
          "rows, MB moved, ms, library ms, ratio, launches on the paths):")
    for shape, m_out, nbytes, t_kern, t_lib, n in sorted(
            pool_shapes, key=lambda r: -r[2]):
        print(f"    {shape} -> {m_out}: {nbytes / 1e6:.2f} MB, ms "
              f"{t_kern:.4f}, library {t_lib:.4f}, ratio "
              f"{t_kern / t_lib:.3f}, x{n}"
              f"{' SLOWER' if t_kern > t_lib else ''}")
    print("  the standalone codec per launch shape (stripe, payload width, "
          "MB moved, ms, bound ms, ratio, launches on the paths):")
    for kind, stripe, w, nbytes, t_kern, b, n in sorted(
            codec_shapes, key=lambda r: (r[0], -r[3])):
        print(f"    {kind} {stripe} w {w}: {nbytes / 1e6:.2f} MB, ms "
              f"{t_kern:.4f}, bound {b:.4f}, ratio {t_kern / b:.2f}, x{n}")

    # -- ragged shapes and edge cases ----------------------------------------
    for m, k, n, f in ((1000, 300, 200, 0.0), (77, 1536, 130, 0.5),
                       (22080, 1024, 512, 0.5), (11040, 512, 1024, 0.25)):
        x, w = randn(m, k), randn(k, n) / math.sqrt(k)
        close("streamed_matmul", streamed_matmul_padded(x, w,
                                                        static_fraction=f),
              ref.conv2d_ref(x, w), MATMUL_TOL, MATMUL_TOL)
    for m, k, n in ((77, 45, 130), (300, 17, 5), (1, 1, 1)):
        x, w = randn(m, k), randn(k, n) / math.sqrt(k)
        close("conv2d", SC.conv2d(x, w), ref.conv2d_ref(x, w), MATMUL_TOL,
              MATMUL_TOL)
        check_variant("conv2d_encode", x, None, k, w=w)
    for m, c in ((77, 45), (3, 1), (129, 96)):
        x = randn(m, c)
        exact("act_relu", SC.act_relu(x), ref.act_relu_ref(x))
        check_variant("act_relu_encode", x, None, c)
        check_variant("pool_encode", randn(2 * m, c), None, c, m)
    # every variant at c = 3, 24 and 40 (a payload's padding channels
    # hold random bytes), rows not a multiple of any tile: m = 77 and
    # 4099, and for pool k = 2 and k = m (the global pool)
    for c in (3, 24, 40):
        for m in (77, 4099):
            for kind in ("conv2d_decode", "conv2d_decode_encode"):
                check_variant(kind, None, payload_of(m, c), c,
                              w=randn(c, 130) / math.sqrt(c))
            for kind in ("dwconv_encode", "dwconv_decode",
                         "dwconv_decode_encode"):
                for taps in (3, 5):
                    dec = "_decode" in kind
                    check_variant(kind, None if dec else randn(m, c),
                                  payload_of(m, c) if dec else None, c,
                                  w=randn(taps, c))
            check_variant("act_relu_decode_encode", None, payload_of(m, c), c)
            check_variant("act_relu_decode", None, payload_of(m, c), c)
            for m_out in (m, 1):
                for kind in ("pool_decode", "pool_decode_encode",
                             "pool_encode"):
                    k = 2 if m_out == m else 2 * m
                    dec = "_decode" in kind
                    check_variant(kind, None if dec else randn(k * m_out, c),
                                  payload_of(k * m_out, c) if dec else None,
                                  c, m_out)
    # flash attention at ragged S (tail rows and key tiles masked inside the
    # kernel), every head width it is built for, causal and not
    for B, S, H, D in ((2, 1, 3, 16), (1, 63, 4, 64), (2, 300, 2, 16),
                       (1, 77, 32, 128), (1, 1000, 2, 64), (1, 130, 2, 32)):
        q, k, v = (randn(B, S, H, D) for _ in range(3))
        for causal in (True, False):
            close("flash_attention", flash_attention(q, k, v, causal=causal),
                  chunked_attention(q, k, v, causal=causal,
                                    chunk=min(1024, S), skip_masked=causal),
                  FLASH_TOL, FLASH_TOL)
            # the training instances at the same shapes, and every bf16
            # instance
            for kind in ("flash_attention_lse", *BWD_KERNELS):
                train_attention(kind, B, S, H, D, causal)[0]()
                train_attention(kind + "_bf16", B, S, H, D, causal)[0]()
            flash_case(B, S, S, H, D, causal, torch.bfloat16)[0]()
    # keys of their own length (non-causal, the cross attention's): ragged
    # Sk against a decode step's one query row and a 64-token prompt, at
    # whisper's 20 heads of 64, held and timed against the bound and SDPA
    print("  flash_attention, keys of their own length (B, Sq, Sk, H, D): "
          "ms, plain ms, SDPA ms, bound ms (f32: 3xTF32 bound; bf16: own "
          "products bound)")
    for Sq in (1, 64):
        for Sk in (1, 37, 1499):
            for dtype in (torch.float32, torch.bfloat16):
                check, kern, plain, lib, nbytes, ops = flash_case(
                    4, Sq, Sk, 20, 64, False, dtype)
                check()
                t_kern, t_plain, t_lib = timer(kern), timer(plain), timer(lib)
                if dtype == torch.float32:
                    b, bound_by = bound_ms(nbytes, ops, PEAK_F32_FLOPS)
                    own = bound_tf32x3_ms(nbytes, ops)
                else:
                    b, bound_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
                    own = bound_ms(nbytes, ops * BF16_PRODUCTS[
                        "flash_attention_bf16"], PEAK_BF16_FLOPS)[0]
                print(f"    (4, {Sq}, {Sk}, 20, 64) {dtype}: ms "
                      f"{t_kern:.4f} plain {t_plain:.4f} SDPA {t_lib:.4f} "
                      f"bound {b:.5f} ({bound_by}, {own:.5f})")
    # the six training instances over the same keys (non-causal): every
    # output held to its plain version (f32: TRAIN_TOL; bf16: the ulp
    # rule), two launches bit for bit, timed against SDPA in the same type,
    # forward for the lse instances, its autograd backward for each
    # backward kernel; whisper's train shapes, (4, 448, 1500, 20, 64) and
    # (4, 1500, 1500, 20, 64), come from the lm-train-whisper paths above
    print("  training instances, keys of their own length (B, Sq, Sk, H, "
          "D), non-causal: ms, plain ms, SDPA ms, bound ms (f32: 3xTF32 "
          "bound; bf16: own products bound)")
    for Sq in (1, 64):
        for Sk in (1, 37, 1499):
            for kind in ("flash_attention_lse", *BWD_KERNELS):
                for inst in (kind, kind + "_bf16"):
                    check, kern, plain, lib, nbytes, ops = train_attention(
                        inst, 4, Sq, 20, 64, False, Sk)
                    check()
                    t_kern, t_plain = timer(kern), timer(plain)
                    t_lib = timer(lib)
                    if inst in BF16_PRODUCTS:
                        b, bound_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
                        own = bound_ms(nbytes, ops * BF16_PRODUCTS[inst],
                                       PEAK_BF16_FLOPS)[0]
                    else:
                        b, bound_by = bound_ms(nbytes, ops, PEAK_F32_FLOPS)
                        own = bound_tf32x3_ms(nbytes, ops)
                    print(f"    {inst} (4, {Sq}, {Sk}, 20, 64): ms "
                          f"{t_kern:.4f} plain {t_plain:.4f} SDPA "
                          f"{t_lib:.4f} bound {b:.5f} ({bound_by}, "
                          f"{own:.5f})")
    tile_checks(torch, SC, randn, exact)
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -1.0],
                            device="cuda")
    exact("act_relu", SC.act_relu(specials[None, :]),
          ref.act_relu_ref(specials[None, :]))
    # dwconv: 'same'-padding rows at both ends of x and of a block's tile,
    # +-0.0 in x and w (the plain tap sum starts from 0 + w0 x0, so a -0.0
    # product becomes +0.0), taps other than 3
    for m, c, taps in ((1, 24, 3), (2, 48, 3), (86, 24, 3), (4097, 384, 3),
                       (300, 40, 5), (77, 96, 2), (300, 40, 9)):
        x, w = randn(m, c), randn(taps, c)
        x[0, :4] = -0.0
        x[-1, 4:8] = 0.0
        x[m // 2, 8:12] = -0.0
        w[:, 0] = -0.0
        check_dwconv(x, w)
        check_variant("dwconv_encode", x, None, c, w=w)
    # BFP8 exponent edge cases: block amax at 2^k (1 + j 2^-23), j in
    # -3..3, across the normal range and into the subnormals, plus all-zero
    # blocks (exp 0), blocks whose values round half-way, and blocks that
    # hold a NaN or an infinity (exp 0, a NaN's mantissa 0); the same rows
    # through the relu encode, the standalone quant and the pool encode (a
    # mean of two equal rows is the row)
    k = torch.arange(-140, 40, device="cuda", dtype=torch.float32)
    j = torch.arange(-3, 4, device="cuda", dtype=torch.float32)
    amax = (torch.exp2(k)[:, None] * (1 + j[None, :] * 2.0**-23)).reshape(-1)
    x = randn(amax.numel(), 64).clamp(-1, 1) * amax[:, None] * 0.999
    x[:, 0] = amax
    x[:, 33] = -amax
    x[::5, 32:] = 0.0
    x[1::7, 1] = amax[1::7] * (2.5 / 64)        # x / scale = 2.5: ties
    x[2::11, 7] = float("nan")
    x[3::11, 40] = float("inf")
    x[4::11, 9], x[4::11, 50] = float("nan"), float("inf")
    x[5::11, 60] = -float("inf")
    check_variant("act_relu_encode", x, None, 64)
    man, exp = bfp8_quant(x)
    pman, pexp = bfp8_quant_values(x, block=32)
    exact("bfp8_quant", man, pman)
    exact("bfp8_quant", exp, pexp)
    # the same rows cut to c % 32 != 0 (45: float4 loads; 43: one by one),
    # quantised into the 64-wide payload, and decoded back to c channels
    for c in (45, 43):
        xc = x[:, :c].contiguous()
        cman, cexp = bfp8_quant(xc, width=64)
        pman, pexp = bfp8_quant_values(xc, block=32, width=64)
        exact("bfp8_quant", cman, pman)
        exact("bfp8_quant", cexp, pexp)
        exact("bfp8_dequant", bfp8_dequant(cman, cexp, c=c),
              ref.bfp8_dequant_ref(cman, cexp, c=c))
    check_variant("pool_encode", x.repeat_interleave(2, dim=0), None, 64,
                  x.shape[0], nan_bits=False)
    # the same blocks as payloads: the decode of every exponent from the
    # subnormals up, through relu's decode (alone and -> encode) and a k = 2
    # pool's
    check_variant("act_relu_decode_encode", None, (man, exp), 64)
    check_variant("act_relu_decode", None, (man, exp), 64)
    check_variant("pool_decode_encode", None,
                  (man.repeat_interleave(2, dim=0),
                   exp.repeat_interleave(2, dim=0)), 64, x.shape[0])
    # the conv encode's epilogue on the same blocks: x @ I is x within the
    # 3xTF32 split's 2^-22 |x| (every other product is +-0), so the finite
    # rows reach it nearly unchanged through the product, in a ragged last
    # row tile
    fin = x[torch.isfinite(x).all(1)][:1000]
    check_variant("conv2d_encode", fin, None, 64,
                  w=torch.eye(64, device="cuda"))
    for m, c, m_out in ((4096, 96, 1), (3 * 70001, 40, 3)):
        g = randn(m, c)
        check_pool(g, m_out)
    man, exp = randi8(-128, 127, 300, 96), randi8(-128, 127, 300, 3)
    exact("bfp8_dequant", bfp8_dequant(man, exp),
          ref.bfp8_dequant_ref(man, exp))
    for c in (77, 40, 1):       # rows cut inside a block, c % 4 != 0
        exact("bfp8_dequant", bfp8_dequant(man, exp, c=c),
              ref.bfp8_dequant_ref(man, exp, c=c))
    # dwconv over more taps than the window kernel's instances: the
    # any-taps route, all four variants
    for taps in (9, 11):
        for kind in ("dwconv_decode", "dwconv_decode_encode"):
            check_variant(kind, None, payload_of(300, 40), 40,
                          w=randn(taps, 40))
    # the decode alone at the shape the YOLO head's acts run at, beside its
    # siblings there (no path launches it at this shape)
    check, kern, plain, _, nbytes, ops = case(
        "act_relu_decode", ((25600, 64), (25600, 2), (25600, 64)))
    check()
    t_kern, t_plain = timer(kern), timer(plain)
    b, bound_by = bound_ms(nbytes, ops)
    rows["act_relu_decode"]["at_25600x64"] = dict(
        ms=t_kern, plain_ms=t_plain, bound_ms=b, bound_by=bound_by)
    print(f"  act_relu_decode at 25600 x 64: ms {t_kern:.4f} plain "
          f"{t_plain:.4f} bound {b:.4f} ({bound_by})")
    # ... and at the size of x3d-evict-all's largest act_relu_decode_encode
    # launch (its payload in, y out), where bytes, not the launch, should
    # set its time
    m, c = max((s[2] for k, s in path_shapes.get(ACT_DECODE_AT, {})
                if k == "act_relu_decode_encode"),
               key=lambda mc: mc[0] * mc[1])
    check, kern, plain, _, nbytes, ops = case(
        "act_relu_decode", ((m, 32 * -(-c // 32)), (m, -(-c // 32)), (m, c)))
    check()
    t_kern, t_plain = timer(kern), timer(plain)
    b, bound_by = bound_ms(nbytes, ops)
    rows["act_relu_decode"][f"at_{m}x{c}"] = dict(
        ms=t_kern, plain_ms=t_plain, bound_ms=b, bound_by=bound_by)
    print(f"  act_relu_decode at {m} x {c} ({ACT_DECODE_AT}'s largest "
          f"act_relu_decode_encode): ms {t_kern:.4f} plain {t_plain:.4f} "
          f"bound {b:.4f} ({bound_by}), {b / t_kern:.3f} of its bound")
    torch.cuda.synchronize()
    reset_launches()        # the comparisons above are not path launches
    return rows


def tile_checks(torch, SC, randn, exact) -> None:
    """The plan's tiles as launch parameters: for each tiled kernel variant
    at ragged shapes (m = 300, c = 40, conv n = 130; pool k = 2 and the
    tree passes at k = 300), every TILE_BM_CHOICES x TILE_BC_CHOICES value
    it takes gives output bit for bit that of tile 0."""
    from repro_torch.kernels.bfp8 import bfp8_quant_values
    n_cases = 0
    for op in ("conv2d", "dwconv", "pool", "pool_tree", "act_relu"):
        for dec in (False, True):
            for enc in (False, True):
                m, c = (900 if op == "pool_tree" else 300), 40
                x = randn(m, c) * 3
                pay = (bfp8_quant_values(x, block=32, width=64)
                       if dec else None)
                kw = dict(payload=pay, encode=enc)
                xin = None if dec else x
                bcs = (0,)
                if op == "conv2d":
                    w = randn(c, 130) / math.sqrt(c)
                    bcs = SC.TILE_BC_CHOICES

                    def fn(bm, bc, w=w, kw=kw, xin=xin):
                        return SC.conv2d(xin, w, bm=bm, bc=bc, **kw)
                elif op == "dwconv":
                    w = randn(3, c)

                    def fn(bm, bc, w=w, kw=kw, xin=xin):
                        return SC.dwconv(xin, w, bm=bm, **kw)
                elif op.startswith("pool"):
                    m_out = 3 if op == "pool_tree" else m // 2

                    def fn(bm, bc, m_out=m_out, kw=kw, xin=xin, c=c):
                        return SC.pool(xin, m_out, c=c, bm=bm, **kw)
                else:
                    def fn(bm, bc, kw=kw, xin=xin, c=c):
                        return SC.act_relu(xin, c=c, bm=bm, **kw)

                def flat(out, enc=enc):
                    return [out[0], *out[1]] if enc else [out]
                name = (op.replace("pool_tree", "pool")
                        + ("_decode" if dec else "")
                        + ("_encode" if enc else ""))
                want = flat(fn(0, 0))
                for bm in SC.TILE_BM_CHOICES:
                    for bc in bcs:
                        for g, w_ in zip(flat(fn(bm, bc)), want):
                            exact(name, g, w_)
                        n_cases += 1
    torch.cuda.synchronize()
    print(f"  tiles: {n_cases} (kernel variant, bm, bc) cases bit for bit "
          f"the untiled launch (bm in {SC.TILE_BM_CHOICES}, bc in "
          f"{SC.TILE_BC_CHOICES} for conv2d)")


def frame_stats(torch, comp, x) -> tuple[float, int]:
    """Median host-clock ms of 5 frames, and the peak device memory one
    frame allocates above what is held before it (weights, input)."""
    comp.run(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    comp.run(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        comp.run(x)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), peak


def first_divergence(torch, main, refc, x) -> str:
    """The first vertex, in topological order, where the two compiled
    designs' outputs part by more than oracle.KERNEL_PARITY_TOL x max
    |reference|."""
    from repro_torch.testing.oracle import KERNEL_PARITY_TOL
    got = main.executor.run_intermediates(x)
    want = refc.executor.run_intermediates(x)
    for name, w in want.items():
        err = float((got[name] - w).abs().max()) if w.numel() else 0.0
        lim = KERNEL_PARITY_TOL * float(w.abs().max()) if w.numel() else 0.0
        if err > lim:
            return (f"{name} ({main.graph.vertex(name).kind}, max|y - "
                    f"ref| {err:.3e} > {lim:.3e})")
    return "no vertex"


def compile_path(repro_torch, path: Path, g):
    """The path's compiled design on the card: the DSE plan through
    ``compile``, or the hand-cut plan compiled on the CPU, written with
    ``Compiled.save`` and read back with ``Compiled.load``."""
    if path.depth_thresh is None:
        return repro_torch.compile(repro_torch.CompileSpec(
            model=g, device="u200", strategy="dse", mode="staged"))
    from repro_torch.core import hand_cut_plan
    saved = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="manual-plan", mode="staged",
        plan=hand_cut_plan(g, 1, depth_thresh=path.depth_thresh),
        torch_device="cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        art = saved.save(pathlib.Path(tmp) / f"{path.name}.smof.json")
        print(f"[{path.name}] artifact: {art.stat().st_size} bytes")
        return repro_torch.Compiled.load(art)


def hold_frame(torch, label, main_exec, plain_exec, ref_run, x, y, yr, *,
               bound=None, values=None):
    """``oracle.hold_to_reference`` on one frame or microbatch, its
    failure raised as an AssertionError under ``label``.  Returns (the
    printed summary, its ``FrameHold``)."""
    from repro_torch.testing import oracle
    try:
        h = oracle.hold_to_reference(main_exec, plain_exec, ref_run, x, y,
                                     yr, bound=bound, values=values)
    except oracle.OracleViolation as e:
        raise AssertionError(f"{label}: {e}") from e
    return (f"max|y - ref| {h.err / h.tol:.4f} of the tolerance "
            f"({oracle.KERNEL_PARITY_TOL} x max|ref| = {h.tol:.3e}), S "
            f"{h.s / h.tol:.4f} of it, bound {h.bound / h.tol:.4f} of it; "
            f"every vertex within {h.worst:.4f} of "
            f"{oracle.VERTEX_PARITY_TOL} x max(1, max|plain|) (worst "
            f"{h.where})"), h


def run_path(torch, repro_torch, library, path: Path):
    """Phase 3 for one path: compile, then FRAMES seeded frames, each with
    its launches counted from 0, every vertex held to its plain version on
    the kernel route's own inputs and the output held against reference
    mode (``hold_frame``).  Returns (compiled, reference-mode compiled,
    launches per frame, launch shapes per frame)."""
    from repro_torch.core import builders
    from repro_torch.testing import oracle
    g = getattr(builders, path.builder)(**path.kwargs)
    t0 = time.perf_counter()
    main = compile_path(repro_torch, path, g)
    kind = "DSE" if path.depth_thresh is None else "hand-cut"
    print(f"[{path.name}] compile ({kind} plan + lowering): "
          f"{time.perf_counter() - t0:.2f} s; kernel_mode "
          f"{main.spec.kernel_mode} on {main.executor.device}")
    if main.executor.device.type != "cuda":
        raise AssertionError(f"[{path.name}] not on the card")
    rep = main.report()
    bfp8 = [s for s in main.executor.report.spills
            if s.codec == "bfp8" and s.reason == "evicted"]
    print(f"[{path.name}] spill report: {json.dumps(rep['traffic'])}")
    print(f"[{path.name}] bfp8-evicted edges ({len(bfp8)}): "
          f"{[(s.src, s.dst) for s in bfp8]}, "
          f"{sum(s.offchip_bits for s in bfp8) // 8} bytes each way")
    if len(bfp8) != path.bfp8_edges:
        raise AssertionError(f"[{path.name}] expected {path.bfp8_edges} "
                             f"BFP8-evicted edges, got {len(bfp8)}")
    refc = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, device="u200", strategy="manual-plan",
        plan=main.plan, mode="staged", kernel_mode="reference"))
    refc.executor.params = main.executor.params
    expected = dict.fromkeys(library.SIGNATURES, 0) | path.launches
    m, c = main.input_shape()
    shapes = None
    for f in range(FRAMES):
        x = torch.randn((m, c), generator=torch.Generator().manual_seed(f))
        xd = x.cuda()
        torch.cuda.synchronize()
        library.reset_launches()
        y = main.run(xd)
        torch.cuda.synchronize()
        counts = library.launches()
        if shapes is None:
            shapes = library.launch_shapes()
        elif library.launch_shapes() != shapes:
            raise AssertionError(f"[{path.name}] frame {f}: launch shapes "
                                 f"changed")
        if counts != expected:
            raise AssertionError(f"[{path.name}] frame {f}: launches "
                                 f"{counts}, expected {expected}")
        yr = refc.run(xd)
        torch.cuda.synchronize()
        label = f"[{path.name}] frame {f}"
        try:
            summary, _ = hold_frame(torch, label, main.executor,
                                    refc.executor, refc.run, xd, y, yr)
        except AssertionError as e:
            raise AssertionError(
                f"{e}; first vertex past {oracle.KERNEL_PARITY_TOL} x "
                f"max|ref| free-running: "
                f"{first_divergence(torch, main, refc, xd)}") from e
        print(f"{label}: output {tuple(y.shape)} {summary}")
    print(f"[{path.name}] launches per frame: "
          f"{ {k: n for k, n in counts.items() if n} }")
    for (name, arg_shapes), n in sorted(shapes.items()):
        print(f"  {name} {arg_shapes} x{n}")
    return main, refc, counts, shapes


def bit_equal(torch, a, b) -> bool:
    """Same shape, type and bits (NaNs and the sign of zero included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(bits[a.element_size()]),
                       b.view(bits[b.element_size()]))


def run_stream_path(torch, repro_torch, library, path: StreamPath):
    """Phase 3 for a pipelined path: compile, then STREAMS seeded streams
    of ``path.microbatches``, each with its launches counted from 0, every
    microbatch held bit for bit against the staged executor on the same
    plan, every vertex of that staged executor to its plain version on its
    own inputs, and the microbatch to the pipelined reference mode within
    its ``oracle.stream_bounds`` bound (``hold_frame``).  Returns
    (compiled, staged, reference-mode compiled, launches per stream,
    launch shapes per stream)."""
    from repro_torch.core import builders, hand_cut_plan
    from repro_torch.testing import oracle
    g = getattr(builders, path.builder)(**path.kwargs)
    B = path.microbatches
    spec = dict(model=g, device="u200", mode="pipelined", microbatches=B)
    if path.plan == "dse":
        spec["strategy"] = "dse"
    else:
        spec.update(strategy="manual-plan", plan=hand_cut_plan(g))
    t0 = time.perf_counter()
    main = repro_torch.compile(repro_torch.CompileSpec(**spec))
    print(f"[{path.name}] compile ({path.plan} plan + lowering): "
          f"{time.perf_counter() - t0:.2f} s")
    sx = main.executor
    print(f"[{path.name}] stream report: "
          f"{json.dumps(main.report()['traffic'])}")
    bfp8 = [r for r in sx.report.spills if r.codec == "bfp8"]
    print(f"[{path.name}] bfp8-evicted edges: "
          f"{[(r.src, r.dst) for r in bfp8]}, "
          f"{sum(r.offchip_bits for r in bfp8) // 8} bytes each way; "
          f"crossings {sx._crossing}; off-chip "
          f"{sum(r.offchip_bits for r in sx.report.spills) // 8} bytes "
          f"per microbatch each way")
    if len(bfp8) != path.bfp8_edges or len(sx._crossing) != path.crossings:
        raise AssertionError(f"[{path.name}] expected {path.bfp8_edges} "
                             f"BFP8 edges and {path.crossings} crossings")
    if sx.report.ticks != path.ticks:
        raise AssertionError(f"[{path.name}] {sx.report.ticks} ticks, "
                             f"expected {path.ticks}")
    plan_spec = dict(model=g, device="u200", strategy="manual-plan",
                     plan=main.plan)
    staged = repro_torch.compile(repro_torch.CompileSpec(**plan_spec))
    refc = repro_torch.compile(repro_torch.CompileSpec(
        **plan_spec, mode="pipelined", microbatches=B,
        kernel_mode="reference"))
    staged_ref = repro_torch.compile(repro_torch.CompileSpec(
        **plan_spec, kernel_mode="reference"))
    staged.executor.params = refc.executor.params = sx.params
    staged_ref.executor.params = sx.params
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        k: path.ticks * n for k, n in path.launches.items()}
    m, c = main.input_shape()
    shapes = None
    for st in range(STREAMS):
        xs = torch.randn((B, m, c),
                         generator=torch.Generator().manual_seed(100 + st))
        xd = xs.cuda()
        torch.cuda.synchronize()
        library.reset_launches()
        ys = main.run(xd)
        torch.cuda.synchronize()
        counts = library.launches()
        if shapes is None:
            shapes = library.launch_shapes()
        elif library.launch_shapes() != shapes:
            raise AssertionError(f"[{path.name}] stream {st}: launch "
                                 f"shapes changed")
        if counts != expected:
            raise AssertionError(f"[{path.name}] stream {st}: launches "
                                 f"{counts}, expected {expected}")
        if ys.shape[0] != B or not bool(torch.isfinite(ys).all()):
            raise AssertionError(f"[{path.name}] stream {st}: bad output "
                                 f"{tuple(ys.shape)}")
        yr = refc.run(xd)
        bounds = oracle.stream_bounds(refc.run, xd, yr)
        torch.cuda.synchronize()
        held = []
        for b in range(B):
            # one staged kernel-route run a microbatch, every vertex kept:
            # its last vertex is held bit for bit to the pipelined output,
            # and all of them to their plain versions
            vals = staged.executor.run_intermediates(xd[b])
            if not bit_equal(torch, ys[b],
                             vals[staged.executor.analysis.topo[-1]]):
                raise AssertionError(f"[{path.name}] stream {st}, "
                                     f"microbatch {b}: pipelined and "
                                     f"staged part")
            held.append(hold_frame(
                torch, f"[{path.name}] stream {st}, microbatch {b}",
                staged.executor, staged_ref.executor, refc.run, xd[b],
                ys[b], yr[b], bound=bounds[b], values=vals)[1])
        print(f"[{path.name}] stream {st}: output {tuple(ys.shape)}, every "
              f"microbatch bit-equal to the staged executor; max|y - ref| "
              f"at most {max(h.err / h.tol for h in held):.4f} of its "
              f"tolerance ({oracle.KERNEL_PARITY_TOL} x max|ref|), S at "
              f"most {max(h.s / h.tol for h in held):.4f} of it; every "
              f"vertex within {max(h.worst for h in held):.4f} of "
              f"{oracle.VERTEX_PARITY_TOL} x max(1, max|plain|)")
    print(f"[{path.name}] launches per stream ({path.ticks} ticks): "
          f"{ {k: n for k, n in counts.items() if n} }")
    for (name, arg_shapes), n in sorted(shapes.items()):
        print(f"  {name} {arg_shapes} x{n}")
    return main, staged, refc, counts, shapes


class StageWeights(dict):
    """A ring's weights as its stages read them: the streams each stage read
    its weights on (``seen``), and for stage ``delay`` a spin of ``spin``
    cycles on the current stream before the stage reads its first weight,
    once a tick.  The executor reads a vertex's weight as ``params[name]``
    where its stage runs, so this holds back the stage's own stream and
    nothing else."""

    def __init__(self, torch, params, stage_of, first, delay=None, spin=0):
        super().__init__(params)
        self.torch = torch
        self.stage_of = stage_of
        self.first = first
        self.delay = delay
        self.spin = spin
        self.seen = collections.defaultdict(set)

    def __getitem__(self, name):
        j = self.stage_of[name]
        self.seen[j].add(self.torch.cuda.current_stream().cuda_stream)
        if j == self.delay and name == self.first[j]:
            self.torch.cuda._sleep(self.spin)
        return super().__getitem__(name)


def ring_phase(torch, library, path: StreamPath, main):
    """Phase 3 for the ring placement of ``path``'s plan: the compiled
    interleave ``main``'s plan and weights lowered with
    ``placement="shard_map"`` on ``[cuda:0] * S``, each stage on a stream
    of its own.  STREAMS seeded streams (the interleave's seeds), each run
    as is and then with one stage's stream held back RING_SPIN_CYCLES a
    tick (RING_DELAYS); every run's launches counted from 0 and held to
    ticks x the table, every stage's weights read on its own stream, every
    microbatch bit for bit the interleave's.  A ring that fell back (to
    the interleave, or to one stream) fails.  Returns (the ring, launches
    per stream, launch shapes per stream) of the undelayed runs."""
    from repro_torch.runtime.streamer import lower_plan_pipelined
    tag = f"{path.name}-ring"
    sx = main.executor
    B, S = path.microbatches, sx.n_stages
    t0 = time.perf_counter()
    ring = lower_plan_pipelined(
        main.graph, main.plan, microbatches=B, placement="shard_map",
        devices=[torch.device("cuda", 0)] * S)
    streams = [st.cuda_stream for st in ring.streams or ()]
    print(f"[{tag}] lowering {time.perf_counter() - t0:.2f} s; placement "
          f"{ring.placement} (report {ring.report.placement}); stage "
          f"devices {[str(d) for d in ring.devices]}, stage streams "
          f"{streams}; {torch.cuda.device_count()} device(s) on the host")
    if (ring.placement != "shard_map" or ring.report.placement != "shard_map"
            or len(set(streams)) != S
            or torch.cuda.current_stream().cuda_stream in streams):
        raise AssertionError(f"[{tag}] the ring fell back: placement "
                             f"{ring.placement}, stage streams {streams}")
    stage_of = ring._stage_of
    if not (any(stage_of[u] == 0 for u, _ in ring._crossing)
            and any(stage_of[w] == S - 1 for _, w in ring._crossing)):
        raise AssertionError(f"[{tag}] stage 0 produces no crossing or "
                             f"stage {S - 1} consumes none")
    first: dict = {}
    for v in main.graph.topo():
        if v in sx.params:
            first.setdefault(stage_of[v], v)
    if len(first) != S:
        raise AssertionError(f"[{tag}] a stage holds no weights: {first}")
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        k: path.ticks * n for k, n in path.launches.items()}
    m, c = main.input_shape()
    counts = shapes = None
    for st in range(STREAMS):
        xd = torch.randn((B, m, c), generator=torch.Generator().manual_seed(
            100 + st)).cuda()
        want = main.run(xd)
        torch.cuda.synchronize()
        for label, delay in (("as is", None),) + RING_DELAYS:
            j = None if delay is None else delay % S
            ring.params = StageWeights(torch, sx.params, stage_of, first,
                                       delay=j, spin=RING_SPIN_CYCLES)
            library.reset_launches()
            t0 = time.perf_counter()
            ys = ring(xd)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            got = library.launches()
            if got != expected:
                raise AssertionError(f"[{tag}] stream {st}, {label}: "
                                     f"launches {got}, expected {expected}")
            if delay is None:
                counts = got
                if shapes is None:
                    shapes = library.launch_shapes()
                elif library.launch_shapes() != shapes:
                    raise AssertionError(f"[{tag}] stream {st}: launch "
                                         f"shapes changed")
            seen = ring.params.seen
            off = {i: sorted(seen[i]) for i in range(S)
                   if seen[i] != {streams[i]}}
            if off:
                raise AssertionError(f"[{tag}] stream {st}, {label}: stages "
                                     f"read their weights on streams {off}, "
                                     f"not their own {streams}")
            parted = [b for b in range(B)
                      if not bit_equal(torch, ys[b], want[b])]
            if parted or ys.device != ring.out_device:
                raise AssertionError(f"[{tag}] stream {st}, {label}: "
                                     f"microbatches {parted} part from the "
                                     f"interleave (output on {ys.device})")
            held = ("" if j is None else f", stage {j} ({label}) held "
                    f"{RING_SPIN_CYCLES} cycles a tick")
            print(f"[{tag}] stream {st}{held}: every microbatch bit-equal "
                  f"to the interleave, launches ticks x the table, each "
                  f"stage's weights read on its own stream; {wall:.3f} ms "
                  f"host clock")
    ring.params = sx.params
    return ring, counts, shapes


def serve_phase(torch, repro_torch, library, path: StreamPath):
    """The served path: ``Compiled.serve`` over the YOLO head's DSE stream,
    SERVE_FRAMES seeded frames in one flush with ``resident_limit``; every
    result (resident or restored) bit for bit the staged executor's, the
    counters read back from ``metrics_text()``, each stream's launches
    counted from 0 and held to the table, one ``Compiled.trace``; then the
    served frames/s, latency percentiles and SLO verdicts, and the idle
    share of one served stream.  Returns (launches, launch shapes) summed
    over the checked flush's streams."""
    from repro_torch.core import builders
    from repro_torch.obs.metrics import MetricsRegistry, parse_metrics_text
    from repro_torch.obs.slo import SloConfig
    from repro_torch.obs.trace import ObsConfig, validate_chrome_trace
    from repro_torch.serving import GraphStreamServer
    g = getattr(builders, path.builder)(**path.kwargs)
    B = path.microbatches
    t0 = time.perf_counter()
    comp = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="dse", mode="pipelined",
        microbatches=B, obs=ObsConfig(slo=SloConfig(**SERVE_SLO))))
    staged = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device="u200", strategy="manual-plan", plan=comp.plan))
    print(f"[serve] compile (DSE plan, pipelined B={B}, and staged): "
          f"{time.perf_counter() - t0:.2f} s")
    srv = comp.serve(resident_limit=SERVE_RESIDENT)
    if srv.executor is not comp.executor or srv.slo is None:
        raise AssertionError("[serve] serve() did not reuse the pipelined "
                             "executor or attach the SLO")
    m, c = comp.input_shape()
    frames = [torch.randn((m, c), generator=torch.Generator().manual_seed(
        200 + i)) for i in range(SERVE_FRAMES)]
    inner = srv.executor
    per_stream, shapes = [], collections.Counter()

    def counted(xs):
        torch.cuda.synchronize()
        library.reset_launches()
        ys = inner(xs)
        torch.cuda.synchronize()
        per_stream.append(library.launches())
        shapes.update(library.launch_shapes())
        return ys
    srv.executor = counted
    tickets = [srv.submit(f) for f in frames]
    t0 = time.perf_counter()
    srv.flush()
    flush_s = time.perf_counter() - t0
    srv.executor = inner
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        k: path.ticks * n for k, n in path.launches.items()}
    n_streams = -(-SERVE_FRAMES // B)
    if len(per_stream) != n_streams or any(n != expected
                                           for n in per_stream):
        raise AssertionError(f"[serve] launches per stream {per_stream}, "
                             f"expected {n_streams} x {expected}")
    resident = set(tickets[-SERVE_RESIDENT:])   # the oldest go to host
    for t, f in zip(tickets, frames):
        y = srv.result(t)
        where = "resident" if t in resident else "restored"
        if y.device.type != comp.executor.device.type or not bit_equal(
                torch, y, staged.run(f.cuda())):
            raise AssertionError(f"[serve] ticket {t} ({where}) is not the "
                                 f"staged executor's result")
    fams = parse_metrics_text(comp.metrics_text())

    def total(fam):
        return sum(fams[fam]["samples"].values())
    got = {k: total(f"smof_server_{k}_total") for k in (
        "frames_in", "frames_out", "streams", "padded_frames",
        "evicted_results", "restored_results")}
    n_pad = n_streams * B - SERVE_FRAMES
    n_host = SERVE_FRAMES - SERVE_RESIDENT
    want = dict(frames_in=SERVE_FRAMES, frames_out=SERVE_FRAMES,
                streams=n_streams, padded_frames=n_pad,
                evicted_results=n_host, restored_results=n_host)
    if got != want:
        raise AssertionError(f"[serve] counters {got}, expected {want}")
    verdicts = fams["smof_server_slo_evaluations_total"]["samples"]
    print(f"[serve] {SERVE_FRAMES} frames, one flush: every result bit-equal "
          f"to the staged executor ({len(resident)} resident, {n_host} "
          f"restored from the host); counters {got}; launches per stream "
          f"{ {k: n for k, n in per_stream[0].items() if n} } x "
          f"{n_streams}")
    print(f"[serve] checked flush (launches counted around each stream): "
          f"{flush_s * 1e3:.3f} ms host clock, submit -> flush delivery p50 "
          f"{srv.latency.quantile(0.5) * 1e3:.3f} ms p99 "
          f"{srv.latency.quantile(0.99) * 1e3:.3f} ms; SLO verdicts "
          f"{verdicts}; last report "
          f"{json.dumps(srv.slo.last_report.summary())}")

    # -- one traced stream ---------------------------------------------------
    xs = torch.stack(frames[:B]).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        tpath = pathlib.Path(tmp) / "served.trace.json"
        ys, mc = comp.trace(xs, path=tpath)
        stats = validate_chrome_trace(json.loads(tpath.read_text()))
    want_ys = comp.run(xs)
    if not all(bit_equal(torch, ys[b], want_ys[b]) for b in range(B)):
        raise AssertionError("[serve] traced outputs are not run's")
    S = comp.plan.n_stages
    if (not (mc.ticks_ok and mc.queues_ok)
            or mc.ticks_measured != B + S - 1):
        raise AssertionError(f"[serve] ModelCheck {mc.violations()}")
    print(f"[serve] trace: outputs bit-equal to run; Chrome trace "
          f"{ {k: v for k, v in stats.items() if k != 'tracks'} }; "
          f"ModelCheck ticks {mc.ticks_measured} = B + S - 1, queues ok")

    # -- served rate and latency on a fresh server -----------------------------
    timed = GraphStreamServer(executor=comp.executor,
                              metrics=MetricsRegistry(),
                              resident_limit=SERVE_RESIDENT)
    fps = []
    for _ in range(SERVE_ROUNDS):
        ts = [timed.submit(f) for f in frames]
        t0 = time.perf_counter()
        timed.flush()
        for t in ts:
            timed.result(t)
        torch.cuda.synchronize()
        fps.append(SERVE_FRAMES / (time.perf_counter() - t0))
    print(f"[serve] {SERVE_ROUNDS} timed rounds of {SERVE_FRAMES} frames "
          f"(flush and every claim, to a synchronize): "
          f"{statistics.median(fps):.2f} frames/s median "
          f"({', '.join(f'{f:.2f}' for f in fps)}), submit -> flush "
          f"delivery p50 "
          f"{timed.latency.quantile(0.5) * 1e3:.3f} ms p99 "
          f"{timed.latency.quantile(0.99) * 1e3:.3f} ms (host clock, "
          f"after the stream's results are on the card)")
    one = frames[:B]

    def one_stream():
        ts = [timed.submit(f) for f in one]
        timed.flush()
        for t in ts:
            timed.result(t)
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_stream()
        ms.append((time.perf_counter() - t0) * 1e3)
    profile_device(torch, "[serve] profile of one served stream (8 frames "
                   "submitted, flushed, claimed)", one_stream,
                   statistics.median(ms))
    summed = collections.Counter()
    for n in per_stream:
        summed.update(n)
    return dict(summed), dict(shapes)


def fuzz_phase(torch, library):
    """The fuzz path: the port's conformance fuzzer on the card through its
    API, FUZZ_CASES cases of seed FUZZ_SEED with every case on the kernel
    route; zero violations, and ``act_relu_decode`` launched exactly
    FUZZ_ACT_DECODE_LAUNCHES times.  Returns (launches, launch shapes)
    over the phase."""
    from repro_torch.testing import GenConfig
    from repro_torch.testing.fuzz import fuzz
    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        failures = fuzz(GenConfig(p_pallas=FUZZ_P_PALLAS), seed=FUZZ_SEED,
                        budget=FUZZ_CASES, max_shrink_runs=6, out=tmp,
                        torch_device="cuda")
        # a shrunk repro, printed so that it can be replayed elsewhere
        for repro in sorted(pathlib.Path(tmp).glob("*.json")):
            print(f"[fuzz] repro {repro.name}: "
                  f"{json.dumps(json.loads(repro.read_text()))}")
    torch.cuda.synchronize()
    counts, shapes = library.launches(), library.launch_shapes()
    print(f"[fuzz] {FUZZ_CASES} cases in {time.perf_counter() - t0:.2f} s, "
          f"{failures} violation(s); launches "
          f"{ {k: n for k, n in counts.items() if n} }")
    if failures:
        raise AssertionError(f"[fuzz] {failures} violation(s)")
    if counts["act_relu_decode"] != FUZZ_ACT_DECODE_LAUNCHES:
        raise AssertionError(f"[fuzz] act_relu_decode launched "
                             f"{counts['act_relu_decode']} times, expected "
                             f"{FUZZ_ACT_DECODE_LAUNCHES}")
    return counts, shapes


def walkthrough_phase(torch, library, timer, path_shapes) -> None:
    """``kernels.ops.fragmented_matmul`` on the card at the shapes of one
    of FRAG_PATH's ``streamed_matmul`` launches (``path_shapes``, its
    launch shapes), at FRAG_FRACTIONS:
    each call exactly one ``streamed_matmul`` launch and nothing else, its
    result within VERTEX_PARITY_TOL x max(1, max|plain|) of its plain
    version, and its time.  Then every walkthrough of WALKTHROUGHS through
    its ``main`` in-process on the card: it must finish (its own
    assertions hold) and print the lines the table names; its launches are
    printed."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import fragmented_matmul
    from repro_torch.testing.oracle import VERTEX_PARITY_TOL as tol
    t0 = time.perf_counter()
    (m, k), (ks, n), (kd, _), *_ = max(
        (s for kind, s in path_shapes if kind == "streamed_matmul"),
        key=lambda s: ((s[1][0] + s[2][0]) * s[1][1], s[1][0] + s[2][0]))
    k = ks + kd
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    plain = ref.conv2d_ref(x, w)
    bound = max(1.0, float(plain.abs().max()))
    for f in FRAG_FRACTIONS:
        torch.cuda.synchronize()
        library.reset_launches()
        y = fragmented_matmul(x, w, static_fraction=f)
        torch.cuda.synchronize()
        got = {name: c for name, c in library.launches().items() if c}
        if got != {"streamed_matmul": 1}:
            raise AssertionError(f"[walk] fragmented_matmul at fraction {f}"
                                 f" launched {got}, not one streamed_matmul")
        err = float((y - plain).abs().max())
        if not err <= tol * bound:
            raise AssertionError(f"[walk] fragmented_matmul at fraction {f}"
                                 f": max abs err {err:.3e} over "
                                 f"{tol} x {bound:.3e}")
        ms = timer(lambda: fragmented_matmul(x, w, static_fraction=f))
        print(f"[walk] fragmented_matmul ({m}, {k}) @ ({k}, {n}) "
              f"static_fraction {f}: one streamed_matmul launch, max abs err "
              f"{err:.3e} (tol {tol} x {bound:.3e}), ms {ms:.4f}")
    t1 = time.perf_counter()
    for name, argv, lines in WALKTHROUGHS:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        torch.cuda.synchronize()
        library.reset_launches()
        out = io.StringIO()
        t2 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                mod.main(list(argv))
            torch.cuda.synchronize()
        finally:
            text = out.getvalue()
            for line in text.splitlines():
                print(f"[walk] {name}: {line}")
        dt = time.perf_counter() - t2
        missing = [ln for ln in lines if ln not in text]
        if missing:
            raise AssertionError(f"[walk] {name} {' '.join(argv)}: printed "
                                 f"no line with {missing}")
        print(f"[walk] {name} {' '.join(argv)}: {dt:.2f} s, launches "
              f"{ {kern: c for kern, c in library.launches().items() if c} }")
    library.reset_launches()
    print(f"[walk] fragmented_matmul {t1 - t0:.1f} s, walkthroughs "
          f"{time.perf_counter() - t1:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s")


def lm_schedule(lengths, slots: int, max_new: int, resident: int,
                page_values) -> dict:
    """The engine's counters worked out beforehand from the schedule (every
    request runs to ``max_new`` tokens; a prefill gives the first, each
    lockstep step one more to every active slot) and the page sizes
    (``page_values``: the values of each cache leaf's page of one slot; raw
    bytes count bf16 words, as the reference; compressed one int8 mantissa
    a value, padded to the 32-value block, and one exponent a block), with
    the requests host-evicted and left parked (retirement order, oldest
    spilled first)."""
    queue, active, retired, steps = list(range(len(lengths))), {}, [], 0
    while True:
        for b in range(slots):
            if b not in active and queue:
                active[b] = [queue.pop(0), 1]
        if not active:
            break
        steps += 1
        for b in sorted(active):
            active[b][1] += 1
            if active[b][1] >= max_new:
                retired.append(active.pop(b)[0])
    host = retired[:max(len(retired) - resident, 0)]
    blocks = sum(-(-v // 32) for v in page_values)
    return dict(prefills=len(lengths), decode_steps=steps,
                generated_tokens=len(lengths) * (max_new - 1),
                evicted_pages=len(host) * len(page_values),
                evicted_bytes_raw=len(host) * sum(page_values) * 2,
                evicted_bytes_compressed=len(host) * 33 * blocks,
                host=host, parked=retired[len(host):])


def lm_config(arch: str, tag: str, n_layers, n_experts=None):
    """The path's config: the published one, its depth cut to ``n_layers``
    and its experts to ``n_experts`` when given (each printed as a cut);
    its parameters reckoned from the shapes and printed before any weight
    is made."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import param_shapes
    cfg = ARCHS[arch]
    if n_experts is not None:
        print(f"[{tag}] {cfg.name}: experts cut from {cfg.moe.n_experts} to "
              f"{n_experts}, top {cfg.moe.top_k} kept")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_experts))
    if n_layers is not None:
        gs = cfg.group_size
        if gs == 1:
            what = (f"{n_layers} of its {cfg.n_layers} layers, a homogeneous "
                    f"stack of {cfg.pattern[0]} layers")
        else:
            n = ("one period" if n_layers == gs
                 else f"{n_layers // gs} periods")
            what = f"{n} of its pattern {list(cfg.pattern)}"
        print(f"[{tag}] {cfg.name}: depth cut from {cfg.n_layers} to "
              f"{n_layers} layers ({what}), every width published")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n = sum(math.prod(s) for s in param_shapes(cfg).values())
    print(f"[{tag}] {cfg.name}: {n} parameters reckoned from the shapes, "
          f"{4 * n} bytes in f32, before the weights are made")
    return cfg


def lm_prompts(cfg, tag, rng):
    """LM_REQUESTS seeded prompt lengths in 64-512, the first 512.  With
    mLSTM layers they are multiples of 64 (its chunk rule); otherwise at
    least two are off the flash kernel's 64-row blocks."""
    if "mlstm" in cfg.pattern:
        lengths = 64 * rng.integers(1, 9, LM_REQUESTS)
        lengths[0] = 512
    else:
        lengths = rng.integers(64, 513, LM_REQUESTS)
        lengths[0] = 512
        if sum(int(n) % 64 != 0 for n in lengths) < 2:
            raise AssertionError(f"[{tag}] prompt lengths {lengths}: fewer "
                                 f"than two off the kernel's 64-row blocks")
    return lengths, [rng.integers(0, cfg.vocab, n) for n in lengths]


def decode_equivalence(torch, cfg, params, tag, pairs=LM_DECODE_EQ,
                       **inputs) -> None:
    """The reference's decode-equivalence invariant at published width on
    the card: for each (S, prefill) of ``pairs``, one seeded sequence of S
    tokens through the full forward (with ``inputs``, an encoder-decoder's
    ``enc_frames``), then the first ``prefill`` tokens prefilled and the
    rest decoded one by one, each step's logits held to the full forward's
    at that position within rtol = atol = LM_DECODE_TOL, elementwise."""
    import numpy as np
    from repro_torch.models import (decode_step, forward, init_cache,
                                    project_logits)
    rng = np.random.default_rng(LM_SEED + 1)
    for S, pre in pairs:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)),
                               device="cuda")
        with torch.no_grad():
            x, _, _ = forward(params, cfg, toks, **inputs)
        full = project_logits(params, cfg, x[0])             # (S, vocab)
        del x
        cache = init_cache(cfg, 1, S, device="cuda")
        _, cache, _ = forward(params, cfg, toks[:, :pre], cache=cache,
                              **inputs)
        worst = 0.0
        for t in range(pre, S):
            logits, cache = decode_step(params, cfg, toks[:, t:t + 1],
                                        torch.full((1,), t, device="cuda"),
                                        cache)
            ref = full[t]
            ratio = float(((logits[0] - ref).abs()
                           / (LM_DECODE_TOL * (1 + ref.abs()))).max())
            worst = max(worst, ratio)
        print(f"[{tag}] decode equivalence, {S} tokens: {pre} prefilled, "
              f"{S - pre} decoded; max |decode - full| / (tol x (1 + "
              f"|full|)) {worst:.4f} (tol {LM_DECODE_TOL}, fails above 1; "
              f"max |full logit| {float(full.abs().max()):.3f})")
        if not worst <= 1.0:
            raise AssertionError(f"[{tag}] decode logits part from the full "
                                 f"forward's ({worst:.3f} of the tolerance)")
        del cache, full


def lm_serve_phase(torch, library, arch: str, tag: str, n_layers=None,
                   dtype: str = "float32", keep: bool = False):
    """An LM serving path: ``ServingEngine`` on ``arch`` at its published
    widths on the card (its depth cut to ``n_layers`` where given), the
    prefill attention through the flash_attention kernel (weights, cache
    and the kernel instance of ``dtype``; bf16 paths hold the routes to
    ``bf16_route_tol`` of their depth).  Checks the
    counters (read from ``metrics_text()``) against the schedule, worked
    out with the cache leaves' own sizes; one flash launch per attention
    layer and prompt and no other kernel; a resident restore of every leaf
    bit for bit and a host restore within the BFP8 bound.  With attention
    layers, the kernel route against the plain route (``lm_routes``);
    a model without attention, which launches no kernel, is held to the
    decode-equivalence invariant instead (``decode_equivalence``).  Then
    times prefill and decode and the host BFP8 codec, profiles one of each
    on the device and the host, and reads the peak memory.  Returns
    (launches, launch shapes) of the served run, and with ``keep`` the
    config and the weights too."""
    import numpy as np
    from repro_torch.models import init_cache, init_params, param_count
    from repro_torch.models.model import _leaves, decode_step
    from repro_torch.obs.metrics import parse_metrics_text
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import _page_names
    on = card()             # every time below is named with the card
    cfg = lm_config(arch, tag, n_layers)
    kinds = [cfg.layer_kind(j) for j in range(cfg.group_size)]
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    wt = getattr(torch, dtype)
    flash = "flash_attention" + ("" if wt == torch.float32 else "_bf16")
    tol = LM_TOL if wt == torch.float32 else bf16_route_tol(cfg.n_layers)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                         cfg, dtype=wt)
    torch.cuda.synchronize()
    n_params = param_count(params)
    w_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    experts = ("" if cfg.moe is None else
               f", {cfg.moe.n_experts} experts top {cfg.moe.top_k} "
               f"(capacity factor {cfg.moe.capacity_factor})")
    mixers = ("" if kinds == ["attn"] else
              f", mixers {kinds} (d_inner {cfg.d_inner}, d_state "
              f"{cfg.d_state})")
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
          f"{cfg.hd}{mixers}, d_ff {cfg.d_ff}{experts}, vocab {cfg.vocab}: "
          f"{n_params} parameters, {dtype} {w_bytes} bytes on the card, "
          f"made in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(LM_SEED)
    lengths, prompts = lm_prompts(cfg, tag, rng)
    kw = dict(max_batch=LM_SLOTS, s_max=LM_S_MAX, device="cuda", dtype=wt)
    eng = ServingEngine(cfg, params, evict_to_host=True,
                        resident_limit=LM_RESIDENT, **kw)
    # one slot's page of every cache leaf, from init_cache's own shapes
    pages = dict(_page_names(init_cache(cfg, 1, LM_S_MAX, dtype=wt,
                                           device="meta")))
    page_values = [t.numel() for t in pages.values()]
    state = [n for n in pages if not n.endswith(("/k", "/v"))]
    want = lm_schedule(lengths, LM_SLOTS, LM_MAX_NEW, LM_RESIDENT,
                       page_values)
    host_rid, parked_rid = want.pop("host")[0], want.pop("parked")[-1]
    # the pages as they leave for the host (a copy on the card), to hold the
    # BFP8 restore against; the host seconds of every page-set's crossing
    evicted, evict_s = {}, []
    host_evict = eng._host_evict

    def keep_evicted(rid, pages):
        if rid == host_rid:
            evicted.update({k: v.clone() for k, v in pages.items()})
        torch.cuda.synchronize()
        t = time.perf_counter()
        host_evict(rid, pages)
        evict_s.append(time.perf_counter() - t)
    eng._host_evict = keep_evicted
    reqs = [eng.submit(p, max_new_tokens=LM_MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    library.reset_launches()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    counts, shapes = library.launches(), library.launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        flash: n_attn * LM_REQUESTS}
    if counts != expected:
        raise AssertionError(f"[{tag}] launches {counts}, expected "
                             f"{expected}")
    parked = {k: v.clone() for k, v in eng.resident_store[parked_rid].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.restore_request(host_rid, 0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    eng.restore_request(parked_rid, 1)
    fams = parse_metrics_text(eng.metrics_text())
    got = {k: int(sum(fams[f"smof_engine_{k}_total"]["samples"].values()))
           for k in ("prefills", "decode_steps", "generated_tokens",
                     "evicted_pages", "restored_pages")}
    raw = fams["smof_engine_evicted_bytes_total"]["samples"]
    got["evicted_bytes_raw"] = int(raw['smof_engine_evicted_bytes_total'
                                       '{kind="raw"}'])
    got["evicted_bytes_compressed"] = int(raw[
        'smof_engine_evicted_bytes_total{kind="compressed"}'])
    want["restored_pages"] = 2 * len(page_values)
    print(f"[{tag}] counters from metrics_text(): {got}; worked out "
          f"beforehand from {len(page_values)} leaves of "
          f"{dict(zip(pages, page_values))} values a slot: {want}")
    if got != want:
        raise AssertionError(f"[{tag}] counters differ from the schedule")
    if [len(r.out_tokens) for r in reqs] != [LM_MAX_NEW] * LM_REQUESTS:
        raise AssertionError(f"[{tag}] a request did not get its tokens")
    worst, worst_at = 0.0, None
    for name, c in _page_names(eng.cache):
        if not bit_equal(torch, c[:, 1], parked[name]):
            raise AssertionError(f"[{tag}] resident restore of {name} is "
                                 f"not bit for bit")
        page = evicted[name]
        rel = float((c[:, 0] - page).abs().max().float()
                    / page.abs().max().float())
        if not 0.0 < rel < LM_BFP8_REL:
            raise AssertionError(f"[{tag}] host restore of {name} off by "
                                 f"{rel}")
        if rel > worst:
            worst, worst_at = rel, name
    state_set = sum(v * pages[n].element_size()
                    for n, v in zip(pages, page_values) if n in state)
    set_bytes = sum(v * pages[n].element_size()
                    for n, v in zip(pages, page_values))
    print(f"[{tag}] restores of all {len(page_values)} leaves: resident bit "
          f"for bit; host (request {host_rid}) max|restored - page| / "
          f"max|page| at most {worst:.4f} ({worst_at}; bound {LM_BFP8_REL}); "
          f"host BFP8 codec on one slot's page-set ({set_bytes} bytes, "
          f"{state_set} of them recurrent state): device -> host "
          f"copy and encode {statistics.median(evict_s):.3f} s a set "
          f"(median of {len(evict_s)}), decode and restore {restore_s:.3f} "
          f"s; {on}")
    print(f"[{tag}] {LM_REQUESTS} requests ({list(map(int, lengths))} prompt "
          f"tokens) through {LM_SLOTS} slots: {served_s:.3f} s to drain "
          f"({sum(evict_s):.3f} s of it in host evictions), "
          f"{got['generated_tokens'] / served_s:.1f} generated tokens/s; "
          f"launches {({k: n for k, n in counts.items() if n})}; peak device "
          f"memory {peak} bytes ({peak - base} above weights and cache); "
          f"{on}")
    del evicted, parked

    if n_attn == 0:
        print(f"[{tag}] no attention layer: the path launches no kernel, and "
              f"its kernel route and plain route are one computation")
        decode_equivalence(torch, cfg, params, tag)
    else:
        lm_routes(torch, cfg, tag, params, eng, prompts, reqs, kw, tol,
                  measured_ties=wt != torch.float32)
    if cfg.vlm_patches:
        patch_check(torch, library, cfg, tag, params)

    # -- times ----------------------------------------------------------------
    ms = []
    for p in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_prefill(p)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[{tag}] prefill ms per request (host clock, kernel route, "
          f"{on}): " + ", ".join(f"{n}: {t:.3f}"
                                 for n, t in zip(lengths, ms)))
    token = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((LM_SLOTS,), 600, dtype=torch.int64, device="cuda")

    def one_step():
        logits, _ = decode_step(params, cfg, token, pos, eng.cache)
        return logits.argmax(-1).cpu()
    one_step()
    torch.cuda.synchronize()
    steps = []
    for _ in range(10):
        t0 = time.perf_counter()
        one_step()
        steps.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(steps)
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in _page_names(eng.cache))
    state_bytes = sum(t.numel() * t.element_size()
                      for n, t in _page_names(eng.cache) if n in state)
    emb = params["embed"]
    read = (w_bytes - emb.numel() * emb.element_size() + cache_bytes
            + state_bytes)
    b_ms = read / PEAK_HBM_BYTES_S * 1e3
    print(f"[{tag}] decode: {step_ms:.3f} ms per lockstep step of "
          f"{LM_SLOTS} slots (median of 10, host clock to the sampled "
          f"tokens), bound {b_ms:.3f} ms ({read} bytes: every weight but the "
          f"embedding table, of which 4 rows are read, the cache read once "
          f"and its {state_bytes} bytes of recurrent state written once, at "
          f"3.35 TB/s); {LM_SLOTS / step_ms * 1e3:.1f} tokens/s in steady "
          f"decode; {on}")
    profile_device(torch, f"[{tag}] profile of one decode step", one_step,
                   step_ms)
    profile_host(torch, f"[{tag}] host profile of one decode step",
                 one_step)
    long = prompts[0]
    profile_device(torch, f"[{tag}] profile of one prefill ({len(long)} "
                   f"tokens)", lambda: eng.run_prefill(long), ms[0])
    if state:
        profile_host(torch, f"[{tag}] host profile of one prefill "
                     f"({len(long)} tokens)", lambda: eng.run_prefill(long))
    del eng
    if keep:
        return counts, shapes, cfg, params
    del params
    return counts, shapes


def lm_routes(torch, cfg, tag, params, eng, prompts, reqs, kw,
              tol=LM_TOL, measured_ties: bool = False) -> None:
    """The kernel route against the plain route on the same weights: every
    prefill again on both (first-token logits and every cache leaf within
    ``tol`` of max|plain|), then the token streams (parted only at a
    plain-route top-2 margin below ``tol`` x max|logit|); with a mixture
    of experts the router's choices of every prefill and decode step
    (``moe_prefill_check``, ``moe_streams``).  ``measured_ties`` takes the
    near-tie margin from the routes' own logits instead: a greedy choice
    swaps two tokens only where their plain-route margin is at most the
    two logits' moves together, so the first token may part only at a
    margin of at most 2 max|kernel - plain| of that prefill's logits, and
    a stream only at 2 delta, delta the largest such difference over the
    prefills (its decode steps part on caches that differ alike)."""
    import numpy as np
    from repro_torch.serving import ServingEngine
    log = LastLogits(torch)
    plain = ServingEngine(cfg, params, kernel_mode="reference", sampler=log,
                          **kw)
    worst = delta = 0.0
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        if cfg.moe is not None:
            lk, ck, lp, cp, held = moe_prefill_check(torch, cfg, tag, i, eng,
                                                     plain, p)
        else:
            lk, ck = eng.run_prefill(p)
            lp, cp = plain.run_prefill(p)
            held = None
        if int(lk.argmax()) != r.out_tokens[0]:
            raise AssertionError(f"[{tag}] request {i}: rerun's first token "
                                 f"is not the served one")
        pages = [(f"{pj}/{n}", ck[pj][n], cp[pj][n]) for pj in cp
                 for n in cp[pj]]
        if held is not None:
            # the layers before the one whose routing parted (layer g *
            # group_size + j holds group g of position j): their caches are
            # computed before the flipped experts' output
            kept = []
            for what, g, w in pages:
                j = int(what.split("/")[0][len("pos_"):])
                n = max(-(-(held - j) // cfg.group_size), 0)
                if n:
                    kept.append((f"{what}[:{n}]", g[:n], w[:n]))
            pages = kept
        else:
            pages.insert(0, ("logits", lk, lp))
        for what, g, w in pages:
            err = float((g - w).abs().max().float()) / max(
                float(w.abs().max().float()), 1e-30)
            worst = max(worst, err)
            if err > tol:
                raise AssertionError(f"[{tag}] request {i} {what}: kernel vs "
                                     f"plain {err:.3e} of max|plain|")
        moved = float((lk - lp).abs().max())
        if held is None:
            delta = max(delta, moved)
        if int(lk.argmax()) != int(lp.argmax()) and held is None:
            top = lp[0].topk(2).values
            margin = float(top[0] - top[1])
            lim = (2 * moved if measured_ties
                   else tol * float(lp.abs().max()))
            print(f"[{tag}] request {i}: first tokens differ; the plain "
                  f"route's top-2 logit margin {margin:.3e} (tol {lim:.3e})")
            if not (margin <= lim if measured_ties else margin < lim):
                raise AssertionError(f"[{tag}] request {i}: first tokens "
                                     f"differ past a tie")
        del ck, cp
    print(f"[{tag}] kernel vs plain route, first-token logits and every "
          f"cache leaf of the 8 prefills: max|kernel - plain| at most "
          f"{worst:.3e} of max|plain| (tol {tol})")
    if cfg.moe is not None:
        moe_streams(torch, cfg, tag, params, prompts, reqs, plain, log, kw)
    else:
        plain_reqs = [plain.submit(p, max_new_tokens=LM_MAX_NEW)
                      for p in prompts]
        plain.run_until_drained()
        for i, (r, q) in enumerate(zip(reqs, plain_reqs)):
            if r.out_tokens == q.out_tokens:
                continue
            t = next(j for j, (a, b) in enumerate(zip(r.out_tokens,
                                                      q.out_tokens))
                     if a != b)
            logits, _ = plain.run_prefill(np.concatenate(
                [prompts[i], q.out_tokens[:t]]))
            top = logits[0].topk(2).values
            margin = float(top[0] - top[1])
            lim = (2 * delta if measured_ties
                   else tol * float(logits.abs().max()))
            print(f"[{tag}] request {i}: token streams part at token {t}; "
                  f"the plain route's top-2 logit margin there {margin:.3e} "
                  f"(tol {lim:.3e}"
                  + (f": 2 x the prefills' largest logit difference "
                     f"{delta:.3e})" if measured_ties else ")"))
            if not (margin <= lim if measured_ties else margin < lim):
                raise AssertionError(f"[{tag}] request {i}: streams part at "
                                     f"token {t} past a tie")
        print(f"[{tag}] token streams of the two routes: "
              f"{sum(r.out_tokens == q.out_tokens for r, q in zip(reqs, plain_reqs))}"
              f" of {LM_REQUESTS} equal")
    del plain


def whisper_phase(torch, library):
    """The encoder-decoder path: whisper-large-v3 at its published widths
    and depth on the card, served through ``make_prefill_step`` /
    ``make_decode_step`` (WHISPER).  One prefill of a batch of 4 (the
    encoder over 1500 frames, the decoder over 64 tokens) and 31 greedy
    decode steps, the launches counted from 0 around them: exactly 32
    encoder + 32 self + 32 cross ``flash_attention`` launches in the
    prefill, 32 (the cross attention over the cached encoder keys) a
    decode step, no other kernel.  Then held to the plain route
    (``use_kernels=False``) on the same weights: the encoder output, the
    first-token logits and the k, v, xk and xv caches within LM_TOL x
    max|plain|, and the token streams in lockstep until a plain-route
    near-tie; the decode-equivalence invariant (56 of 64 tokens
    prefilled); times of the encoder, the prefill and a decode step
    against its byte bound; peak memory; a device profile of a prefill and
    a decode step.  Returns (launches, launch shapes) of the counted
    run."""
    import numpy as np
    from repro_torch.models import init_cache, init_params, param_count
    from repro_torch.models.model import _encoder_forward, _leaves
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    on = card()
    tag, B, S = WHISPER["tag"], WHISPER["batch"], WHISPER["prompt"]
    s_max, new = WHISPER["s_max"], WHISPER["new"]
    cfg = lm_config(WHISPER["arch"], tag, None)
    L, E = cfg.n_layers, cfg.encoder_layers
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                         cfg)
    torch.cuda.synchronize()
    n_params = param_count(params)
    formula = int(cfg.param_counts()["total"])
    print(f"[{tag}] {cfg.name}: {E} encoder and {L} decoder layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, {cfg.enc_frames} "
          f"encoder frames, d_ff {cfg.d_ff} ({cfg.act}, {cfg.norm}), vocab "
          f"{cfg.vocab}: {n_params} parameters ({formula} by param_counts, "
          f"which leaves the norms out), f32 "
          f"{4 * n_params} bytes on the card, made in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(LM_SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device="cuda")
    frames = torch.randn((B, cfg.enc_frames, cfg.d_model),
                         generator=torch.Generator(device="cuda").manual_seed(
                             LM_SEED + 2), device="cuda")
    batch_in = {"tokens": toks, "enc_frames": frames}
    steps = {k: (make_prefill_step(cfg, B, s_max, use_kernels=k),
                 make_decode_step(cfg, B, s_max, use_kernels=k))
             for k in (True, False)}
    (prefill, decode), (plain_prefill, plain_decode) = steps[True], \
        steps[False]
    pos0 = torch.full((B,), S, dtype=torch.int64, device="cuda")

    # -- the counted run ------------------------------------------------------
    cache = init_cache(cfg, B, s_max, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    library.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, batch_in)
    torch.cuda.synchronize()
    first = library.launches()
    stream = [logits.argmax(-1)]
    for t in range(new - 1):
        logits, cache = decode(params, cache, stream[-1][:, None], pos0 + t)
        stream.append(logits.argmax(-1))
    stream = torch.stack(stream, 1).cpu()                   # (B, new)
    served_s = time.perf_counter() - t0
    counts, shapes = library.launches(), library.launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    none = dict.fromkeys(library.SIGNATURES, 0)
    for what, got, want in (
            ("the prefill", first, none | {"flash_attention": E + 2 * L}),
            ("the run", counts, none | {
                "flash_attention": E + 2 * L + (new - 1) * L})):
        if got != want:
            raise AssertionError(f"[{tag}] launches of {what} {got}, "
                                 f"expected {want}")
    print(f"[{tag}] one prefill of {B} x {S} tokens over {B} x "
          f"{cfg.enc_frames} frames and {new - 1} decode steps: "
          f"{served_s:.3f} s, {B * new / served_s:.1f} generated tokens/s; "
          f"launches: the prefill {first['flash_attention']} flash_attention "
          f"({E} encoder, {L} self, {L} cross), the run "
          f"{counts['flash_attention']} ({L} cross a decode step), no other "
          f"kernel; peak device memory {peak} bytes ({peak - base} above "
          f"the {base} bytes of weights, frames and cache); {on}")

    # -- the kernel route against the plain route ----------------------------
    worst = {}

    def held(what, got, want):
        err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                    1e-30)
        worst[what] = err
        if err > LM_TOL:
            raise AssertionError(f"[{tag}] {what}: kernel vs plain {err:.3e} "
                                 f"of max|plain|")
    with torch.no_grad():
        held("encoder output", _encoder_forward(params, cfg, frames, True),
             _encoder_forward(params, cfg, frames, False))
    lk, ck = prefill(params, init_cache(cfg, B, s_max, device="cuda"),
                     batch_in)
    lp, cp = plain_prefill(params, init_cache(cfg, B, s_max, device="cuda"),
                           batch_in)
    if not torch.equal(lk.argmax(-1).cpu(), stream[:, 0]):
        raise AssertionError(f"[{tag}] a rerun's first tokens are not the "
                             f"served ones")
    held("first-token logits", lk, lp)
    for n in ("k", "v", "xk", "xv"):
        held(f"cache {n}", ck["pos_0"][n], cp["pos_0"][n])
    del ck
    print(f"[{tag}] kernel vs plain route, max|kernel - plain| of "
          f"max|plain|: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       worst.items()) + f" (tol {LM_TOL})")
    # the plain route's own greedy streams beside the kernel route's: a row
    # may part only where the plain route's top-2 margin is a near-tie
    tok, parted = lp.argmax(-1), {}
    for t in range(new):
        if t:
            lp, cp = plain_decode(params, cp, tok[:, None], pos0 + t - 1)
            tok = lp.argmax(-1)
        for b in range(B):
            if b in parted or int(tok[b]) == int(stream[b, t]):
                continue
            top = lp[b].topk(2).values
            margin, lim = (float(top[0] - top[1]),
                           LM_TOL * float(lp[b].abs().max()))
            parted[b] = t
            print(f"[{tag}] row {b}: token streams part at token {t}; the "
                  f"plain route's top-2 logit margin {margin:.3e} (tol "
                  f"{lim:.3e})")
            if margin >= lim:
                raise AssertionError(f"[{tag}] row {b}: streams part at "
                                     f"token {t} past a tie")
    print(f"[{tag}] token streams of the two routes, in lockstep: "
          f"{B - len(parted)} of {B} rows equal over {new} tokens")
    del cp
    decode_equivalence(torch, cfg, params, tag, WHISPER["decode_eq"],
                       enc_frames=frames[:1])

    # -- times -----------------------------------------------------------------
    def host_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def run_encoder():
        with torch.no_grad():
            return _encoder_forward(params, cfg, frames)

    def run_prefill():
        return prefill(params, init_cache(cfg, B, s_max, device="cuda"),
                       batch_in)

    def one_step():
        logits, _ = decode(params, cache, stream[:, -1:].to("cuda"),
                           pos0 + new)
        return logits.argmax(-1).cpu()
    enc_ms, pre_ms = host_ms(run_encoder, 5), host_ms(run_prefill, 5)
    step_ms = host_ms(one_step, 10)
    # a decode step reads every decoder weight but the cross keys' and
    # values' projections (their products are cached) and the embedding
    # table (of which B rows), and the whole cache once
    w = sum(t.numel() for n, t in _leaves(params)
            if not n.startswith(("encoder/", "embed"))
            and not n.endswith(("cross/wk", "cross/wv")))
    cache_bytes = sum(t.numel() * 4 for pj in cache.values()
                      for t in pj.values())
    read = 4 * (w + B * cfg.d_model) + cache_bytes
    b_ms = read / PEAK_HBM_BYTES_S * 1e3
    print(f"[{tag}] encoder {enc_ms:.3f} ms, prefill (encoder included) "
          f"{pre_ms:.3f} ms for {B} x {S} tokens (median of 5, host clock); "
          f"decode {step_ms:.3f} ms a step of {B} (median of 10, host clock "
          f"to the sampled tokens), bound {b_ms:.3f} ms ({read} bytes: the "
          f"decoder's weights but the cross k / v projections and the "
          f"embedding table, {B} of its rows, and the cache's {cache_bytes} "
          f"bytes once, at 3.35 TB/s); {B / step_ms * 1e3:.1f} tokens/s in "
          f"steady decode; {on}")
    profile_device(torch, f"[{tag}] profile of one prefill", run_prefill,
                   pre_ms)
    profile_device(torch, f"[{tag}] profile of one decode step", one_step,
                   step_ms)
    profile_host(torch, f"[{tag}] host profile of one decode step",
                 one_step)
    del params, cache
    return counts, shapes


def patch_check(torch, library, cfg, tag, params) -> None:
    """A VLM's prefill with patch embeddings (LM_PATCH_PROMPT): one seeded
    prompt whose first P positions are seeded patch embeddings, through
    ``make_prefill_step`` on both routes; one ``flash_attention`` launch an
    attention layer on the kernel route, and the last logits and every
    cache leaf within LM_TOL x max|plain|."""
    import numpy as np
    from repro_torch.models import init_cache
    from repro_torch.runtime.steps import make_prefill_step
    S, P = LM_PATCH_PROMPT
    toks = torch.as_tensor(np.random.default_rng(LM_SEED + 3).integers(
        0, cfg.vocab, (1, S)), device="cuda")
    patches = torch.randn((1, P, cfg.d_model),
                          generator=torch.Generator(device="cuda").manual_seed(
                              LM_SEED + 4), device="cuda")
    batch_in = {"tokens": toks, "patch_embeds": patches}
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    out = {}
    for kernels in (True, False):
        step = make_prefill_step(cfg, 1, S, use_kernels=kernels)
        torch.cuda.synchronize()
        library.reset_launches()
        t0 = time.perf_counter()
        out[kernels] = step(params, init_cache(cfg, 1, S, device="cuda"),
                            batch_in)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = library.launches()["flash_attention"]
        if sum(library.launches().values()) != n or n != (
                n_attn if kernels else 0):
            raise AssertionError(f"[{tag}] launches of the patch prefill "
                                 f"{library.launches()}")
        print(f"[{tag}] prefill of {S} tokens, the first {P} patch "
              f"embeddings, {'kernel' if kernels else 'plain'} route: "
              f"{ms:.3f} ms (host clock, one run), {n} flash_attention "
              f"launches; {card()}")
    (lk, ck), (lp, cp) = out[True], out[False]
    worst = 0.0
    for what, g, w in [("logits", lk, lp)] + [
            (f"{pj}/{n}", ck[pj][n], cp[pj][n]) for pj in cp for n in cp[pj]]:
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, err)
        if err > LM_TOL:
            raise AssertionError(f"[{tag}] patch prefill {what}: kernel vs "
                                 f"plain {err:.3e} of max|plain|")
    print(f"[{tag}] patch prefill, kernel vs plain route: last logits and "
          f"every cache leaf within {worst:.3e} of max|plain| (tol {LM_TOL})")
    library.reset_launches()


def train_held(tag, what, got, want,
               against: str = "kernel route vs plain route",
               tol: float = TRAIN_TOL, floor: float = 1.0) -> float:
    """|got - want| (floats, or tensors on any devices, compared in f32 or
    wider) within ``tol`` x max(``floor``, max|want|); the error's
    fraction of that bound."""
    if isinstance(want, float):
        err, scale = abs(got - want), abs(want)
    else:
        wide = torch_wide(want)
        err = float((torch_wide(got.to(want.device)) - wide).abs().max())
        scale = float(wide.abs().max())
    lim = tol * max(floor, scale)
    if not err <= lim:
        raise AssertionError(f"[{tag}] {what}: {against} {err:.3e} > "
                             f"{lim:.3e}")
    return err / lim if lim else 0.0


def torch_wide(t):
    """t in f32 if its type is narrower (bf16), else as it is."""
    return t.float() if t.element_size() < 4 else t


def train_steps(torch, library, cfg, params, batch, tag, opt: dict,
                expected: dict, dtype=None, microbatches=None) -> dict:
    """TRAIN_STEPS steps of make_train_step (remat "full", AdamW ``opt``,
    parameters of ``dtype``) in FaultTolerantLoop on the repeated
    ``batch``, a CheckpointStore in a temporary directory: the launches
    counted from 0 around them and held to ``expected`` (every other
    kernel 0), every loss finite and the last below the first, every
    parameter of the type it was made in, every int8 state int8.  Returns
    the losses, the loop's events, each step's host-clock seconds to the
    loss (``walls``; ``step_s`` their median past the first), the launches
    and their shapes, the peak device memory and ``one_step``, one more
    step on the final state (for a profile)."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.models.model import _leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.fault import FaultConfig, FaultTolerantLoop
    from repro_torch.runtime.steps import make_train_step
    opt_cfg = AdamWConfig(**opt)
    opt_state = init_opt_state(params, opt_cfg)
    dtypes = {name: t.dtype for name, t in _leaves(params)}
    step = make_train_step(cfg, opt_cfg, remat="full", device="cuda",
                           dtype=dtype or torch.float32,
                           microbatches=microbatches)
    losses = []

    def run_step(state, b):
        p, o = state
        p, o, metrics = step(p, o, b)
        losses.append(float(metrics["loss"]))     # synchronises
        return (p, o)

    with tempfile.TemporaryDirectory() as tmp:
        loop = FaultTolerantLoop(run_step, CheckpointStore(tmp),
                                 FaultConfig(checkpoint_every=50))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        library.reset_launches()
        state = loop.run((params, opt_state), lambda s: batch, start_step=0,
                         num_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        counts, shapes = library.launches(), library.launch_shapes()
        peak = torch.cuda.max_memory_allocated()
    expected = dict.fromkeys(library.SIGNATURES, 0) | expected
    if counts != expected:
        raise AssertionError(f"[{tag}] launches {counts}, expected "
                             f"{expected}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite, or the "
                             f"last not below the first")
    for name, t in _leaves(state[0]):
        if t.dtype != dtypes[name]:
            raise AssertionError(f"[{tag}] parameter {name} is {t.dtype}, "
                                 f"made {dtypes[name]}")
    for name, t in _leaves(state[1]):
        if name.endswith("/q") and t.dtype != torch.int8:
            raise AssertionError(f"[{tag}] state {name} is {t.dtype}")
    walls = [r.wall_s for r in loop.records]
    return dict(losses=list(losses), events=[e["kind"] for e in loop.events],
                walls=walls, step_s=statistics.median(walls[1:]),
                counts=counts, shapes=shapes, peak=peak,
                one_step=lambda: run_step(state, batch))


def train_phase(torch, library):
    """The LM training path: yi-6b at its published widths on the card
    (``lm-train``), then at its reduced size (``lm-train-reduced``).
    Returns {tag: (launches, launch shapes)} of each path's four-step run
    (counted from 0 around it)."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, param_count
    from repro_torch.models.model import _leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.fault import FaultConfig, FaultTolerantLoop
    from repro_torch.runtime.steps import (accumulate_grads, loss_and_grads,
                                           make_train_step)
    cfg = ARCHS[TRAIN_ARCH]
    on = card()
    tag = "lm-train"
    t_phase = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                         cfg)
    n_params = param_count(params)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                     global_batch=1)).batch_at(0)
    toks, labs = (torch.from_numpy(batch[k]).cuda()
                  for k in ("tokens", "labels"))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params} f32 "
          f"parameters; one microbatch of 1 x {TRAIN_SEQ} tokens, remat "
          f"full, AdamW {TRAIN_OPT}")

    # -- the kernel route against the plain route, one gradient ----------------
    def kept(use_kernels):
        """(loss, {leaf: gradient norm}, {name: full gradient}) of one
        backward on the route; the rest of the gradients is dropped."""
        loss, grads = loss_and_grads(params, cfg, toks, labs, remat="full",
                                     use_kernels=use_kernels)
        norms, full = {}, {}
        for name, g in _leaves(grads):
            norms[name] = float(torch.linalg.vector_norm(g))
            if name == "embed":
                full[name] = g
            for leaf in TRAIN_KEEP:
                if name.endswith(leaf):
                    for layer in (0, cfg.n_layers - 1):
                        full[f"{name}[{layer}]"] = g[layer].clone()
        del grads
        return float(loss), norms, full

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, nk, fk = kept(True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lp, np_, fp = kept(False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    worst = [train_held(tag, "loss", lk, lp)]
    worst += [train_held(tag, f"norm of {n}", nk[n], np_[n]) for n in np_]
    worst += [train_held(tag, n, fk[n], fp[n]) for n in fp]
    print(f"[{tag}] kernel vs plain route on one backward from the same "
          f"weights: loss {lk:.6f} vs {lp:.6f}, {len(np_)} gradient norms "
          f"and {len(fp)} full gradients ({', '.join(fp)}) within "
          f"{TRAIN_TOL} x max(1, max|plain|), the worst at "
          f"{max(worst):.3f} of it; backward {t1 - t0:.3f} s kernel route, "
          f"{t2 - t1:.3f} s plain route (host clock, the first of each)")
    del fk, fp

    # -- four optimizer steps in the fault-tolerant loop ------------------------
    L = cfg.n_layers
    run = train_steps(torch, library, cfg, params, batch, tag, TRAIN_OPT, {
        "flash_attention_lse": 2 * L * TRAIN_STEPS,
        "flash_attention_bwd_dq": L * TRAIN_STEPS,
        "flash_attention_bwd_dkdv": L * TRAIN_STEPS})
    counts, shapes, step_s = run["counts"], run["shapes"], run["step_s"]
    # the step's f32 operations: every matrix product forward, again in
    # the recompute (remat "full": each layer group and each loss chunk),
    # and twice in the backward; attention's two products forward, twice
    # (step and recompute), and its backward's five
    mm = n_params - cfg.vocab * cfg.d_model          # all but the lookup
    attn = 2.0 * L * cfg.n_heads * cfg.hd * TRAIN_SEQ * (TRAIN_SEQ + 1)
    ops = 8.0 * mm * TRAIN_SEQ + (2 + 2.5) * attn
    b_s = ops / PEAK_F32_FLOPS
    print(f"[{tag}] {TRAIN_STEPS} steps in FaultTolerantLoop, losses "
          f"{[round(x, 6) for x in run['losses']]} (the last below the "
          f"first), events {run['events']}; {step_s * 1e3:.3f} "
          f"ms a step (host clock to the loss, median of steps 2-"
          f"{TRAIN_STEPS}: {[round(w * 1e3, 3) for w in run['walls']]}), "
          f"{TRAIN_SEQ / step_s:.1f} tokens/s; bound {b_s * 1e3:.3f} ms "
          f"({ops:.4e} f32 operations at 67 TFLOP/s), "
          f"{b_s / step_s:.3f} of it; peak device memory {run['peak']} "
          f"bytes; launches {({k: n for k, n in counts.items() if n})}; "
          f"{on}")
    profile_device(torch, f"[{tag}] profile of one step", run["one_step"],
                   step_s * 1e3)
    del run, params
    gc.collect()
    torch.cuda.empty_cache()
    out = {tag: (counts, shapes)}
    print(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")

    # -- the reduced size: every leaf, bf16 accumulation, a resume --------------
    tag = "lm-train-reduced"
    cfg = ARCHS[TRAIN_ARCH].reduced()
    R = TRAIN_REDUCED
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=R["seq_len"],
                                    global_batch=R["global_batch"]))

    def fresh():
        p = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                        cfg)
        return (p, init_opt_state(p, opt_cfg))
    params = fresh()[0]
    b0 = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    lk, gk = loss_and_grads(params, cfg, b0["tokens"], b0["labels"])
    lp, gp = loss_and_grads(params, cfg, b0["tokens"], b0["labels"],
                            use_kernels=False)
    worst = [train_held(tag, "loss", float(lk), float(lp))]
    worst += [train_held(tag, n, g, w)
              for (n, g), (_, w) in zip(_leaves(gk), _leaves(gp))]
    print(f"[{tag}] {cfg.name}: every gradient leaf ({len(worst) - 1}) and "
          f"the loss on the kernel route within {TRAIN_TOL} x max(1, "
          f"max|plain|) of the plain route, the worst at {max(worst):.3f} "
          f"of it")
    # two microbatches accumulated in bf16: bit for bit (0 + g1) + g2, / 2
    mbs = R["microbatches"]
    _, acc = accumulate_grads(params, cfg, b0, mbs, torch.bfloat16)
    rows = R["global_batch"] // mbs
    want = {n: torch.zeros(t.shape, dtype=torch.bfloat16, device="cuda")
            for n, t in _leaves(params)}
    for i in range(mbs):
        sl = slice(i * rows, (i + 1) * rows)
        _, g = loss_and_grads(params, cfg, b0["tokens"][sl],
                              b0["labels"][sl])
        for n, t in _leaves(g):
            want[n] += t.to(torch.bfloat16)
    for n, t in _leaves(acc):
        if not bit_equal(torch, t, want[n] / mbs):
            raise AssertionError(f"[{tag}] bf16 accumulation of {n} is not "
                                 f"(0 + g1) + g2, / {mbs}, bit for bit")
    print(f"[{tag}] {mbs} microbatches accumulated in bf16: every leaf bit "
          f"for bit its definition")

    step = make_train_step(cfg, opt_cfg, microbatches=mbs, device="cuda")

    def run(state, b):
        p, o = state
        p, o, _ = step(p, o, b)
        return (p, o)

    with tempfile.TemporaryDirectory() as tmp:
        loop = FaultTolerantLoop(run, CheckpointStore(f"{tmp}/whole"),
                                 FaultConfig(checkpoint_every=50))
        library.reset_launches()
        whole = loop.run(fresh(), data.batch_at, start_step=0,
                         num_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        counts, shapes = library.launches(), library.launch_shapes()
        L = cfg.n_layers
        expected = dict.fromkeys(library.SIGNATURES, 0) | {
            "flash_attention_lse": 2 * L * mbs * TRAIN_STEPS,
            "flash_attention_bwd_dq": L * mbs * TRAIN_STEPS,
            "flash_attention_bwd_dkdv": L * mbs * TRAIN_STEPS}
        if counts != expected:
            raise AssertionError(f"[{tag}] launches {counts}, expected "
                                 f"{expected}")
        for bfp8 in (False, True):
            store = CheckpointStore(f"{tmp}/bfp8-{bfp8}", bfp8=bfp8)
            saved = FaultTolerantLoop(run, store,
                                      FaultConfig(checkpoint_every=2)).run(
                fresh(), data.batch_at, start_step=0, num_steps=2)
            again = FaultTolerantLoop(run, store,
                                      FaultConfig(checkpoint_every=50))
            state, start = again.try_restore(fresh())
            if start != 2:
                raise AssertionError(f"[{tag}] resumed at {start}, not 2")
            # the round trip: raw bit for bit; BFP8 every float leaf within
            # TRAIN_BFP8_REL of its max, the int8 mantissas and the step
            # exact
            worst = 0.0
            for (n, a), (_, b) in zip(_leaves({"p": saved[0],
                                               "o": saved[1]}),
                                      _leaves({"p": state[0],
                                               "o": state[1]})):
                if bfp8 and a.is_floating_point():
                    rel = float((a - b).abs().max()) / max(
                        float(a.abs().max()), 1e-30)
                    worst = max(worst, rel)
                    if not (b.dtype == a.dtype and rel < TRAIN_BFP8_REL):
                        raise AssertionError(f"[{tag}] BFP8 restore of {n} "
                                             f"off by {rel} of its max")
                elif not bit_equal(torch, a, b):
                    raise AssertionError(f"[{tag}] restore of {n} is not "
                                         f"bit for bit")
            resumed = again.run(state, data.batch_at, start_step=2,
                                num_steps=TRAIN_STEPS - 2)
            n_bad = 0
            for (n, a), (_, b) in zip(_leaves({"p": whole[0], "o": whole[1]}),
                                      _leaves({"p": resumed[0],
                                               "o": resumed[1]})):
                if not bfp8 and not bit_equal(torch, a, b):
                    raise AssertionError(f"[{tag}] resumed {n} is not bit "
                                         f"for bit the uninterrupted run")
                if a.is_floating_point() and not bool(b.isfinite().all()):
                    raise AssertionError(f"[{tag}] resumed {n} not finite")
                n_bad += not bit_equal(torch, a, b)
            print(f"[{tag}] save after step 2, restore into a fresh loop, "
                  f"steps 3-4: " + (
                      f"the BFP8 restore within {worst:.4f} of each float "
                      f"leaf's max (bound {TRAIN_BFP8_REL}), int8 and step "
                      f"exact; after steps 3-4 {n_bad} leaves differ from "
                      f"the uninterrupted run, all finite" if bfp8 else
                      "restore and steps 3-4 bit for bit the uninterrupted "
                      "run (raw checkpoint), states included"))
    out[tag] = (counts, shapes)
    return out


def recurrent_train_ops(cfg, n_params: int, seq: int) -> float:
    """f32 operations of one lm-train-xlstm / -jamba step, the matrix
    products only (the scans' elementwise steps left out): each product's
    forward, the group's recompute (remat "full") and the backward's two,
    8 x its weights x its rows (a token each, an expert's its capacity
    slots); attention as lm-train's; the mLSTM chunk products (q k^T, s v,
    q C, k^T v) and the sLSTM recurrence 2 + 4 and 2 + 3 times their
    forward, for the scans' own checkpoints recompute them once more in the
    backward (mLSTM twice: its outer and inner levels)."""
    from repro_torch.models import param_shapes
    from repro_torch.models.moe import GROUP, capacity
    from repro_torch.models.ssm import MLSTM_CHUNK
    experts = sum(math.prod(sh) for n, sh in param_shapes(cfg).items()
                  if "/moe/w_" in n)
    dense = n_params - cfg.vocab * cfg.d_model - experts
    ops = 8.0 * dense * seq
    if experts:
        g = min(GROUP, seq)
        ops += 8.0 * experts / cfg.moe.n_experts * (seq // g) * capacity(
            g, cfg)
    kinds = [cfg.layer_kind(j) for j in range(cfg.group_size)]
    H = cfg.n_heads
    attn = 2.0 * H * cfg.hd * seq * (seq + 1)
    dh = cfg.d_inner // H
    mlstm = seq * H * (4.0 * min(MLSTM_CHUNK, seq) * dh + 4.0 * dh * dh)
    slstm = seq * 2.0 * cfg.d_model * 4 * (cfg.d_model // H)
    per_group = (kinds.count("attn") * (2 + 2.5) * attn
                 + kinds.count("mlstm") * (4 + 2) * mlstm
                 + kinds.count("slstm") * (3 + 2) * slstm)
    return ops + cfg.n_groups * per_group


def recurrent_step_breakdown(torch, tag: str, cfg, params, batch) -> None:
    """Where a recurrent train step's host time goes: ``loss_and_grads``
    (remat "full", the step's gradient) twice, with the scans' own
    checkpoints and without them (``ssm._chunked`` giving each chunk as it
    is; the group's checkpoint stays), each split into the forward to the
    loss and the backward, a synchronisation between.  In both, every call
    of a scan chunk (``ssm._slstm_chunk``, ``_mlstm_chunk``,
    ``_mamba_chunk``) is timed between two synchronisations, by mixer and
    by pass: the first forward, or a recompute in the backward (the
    group's and the chunks' own).  The Python garbage collector's passes
    are timed through ``gc.callbacks``."""
    from repro_torch.models import ssm
    from repro_torch.models.model import _leaves, _tree, lm_loss
    toks, labs = (torch.from_numpy(batch[k]).cuda()
                  for k in ("tokens", "labels"))
    phase = ["forward"]
    chunks = collections.defaultdict(lambda: [0.0, 0])
    collected = collections.defaultdict(lambda: [0.0, 0])
    gc_t0 = []

    def on_gc(phase, info):
        if phase == "start":
            gc_t0.append(time.perf_counter())
        elif gc_t0:
            row = collected[info["generation"]]
            row[0] += time.perf_counter() - gc_t0.pop()
            row[1] += 1

    def timed(name, fn):
        def chunk(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:        # a recompute stops early by raising
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                row = chunks[(name, phase[0])]
                row[0] += time.perf_counter() - t0
                row[1] += 1
        return chunk

    real = {n: getattr(ssm, n) for n in ("_slstm_chunk", "_mlstm_chunk",
                                         "_mamba_chunk", "_chunked")}
    walls = {}
    gc.callbacks.append(on_gc)
    try:
        for n in ("_slstm_chunk", "_mlstm_chunk", "_mamba_chunk"):
            setattr(ssm, n, timed(n[1:-6], real[n]))
        for label in ("with", "without"):
            if label == "without":
                ssm._chunked = lambda fn, remat: fn
            chunks.clear()
            collected.clear()
            phase[0] = "forward"
            leaves = {n: t.detach().requires_grad_(True)
                      for n, t in _leaves(params)}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = lm_loss(_tree(leaves), cfg, toks, labs, remat="full")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            phase[0] = "recompute"
            grads = torch.autograd.grad(loss, list(leaves.values()))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            del loss, grads, leaves
            walls[label] = (t1 - t0, t2 - t1,
                            torch.cuda.max_memory_allocated())
            print(f"[{tag}] host breakdown of one loss_and_grads, {label} "
                  f"the scans' checkpoints: forward {(t1 - t0) * 1e3:.3f} "
                  f"ms, backward {(t2 - t1) * 1e3:.3f} ms, peak "
                  f"{walls[label][2]} bytes; scan chunks (each between two "
                  f"synchronisations): " + "; ".join(
                      f"{m} {w} {sec * 1e3:.3f} ms x{n}"
                      for (m, w), (sec, n) in sorted(chunks.items()))
                  + "; the garbage collector " + ("; ".join(
                      f"generation {g} {sec * 1e3:.3f} ms x{n}"
                      for g, (sec, n) in sorted(collected.items()))
                      or "no pass"))
    finally:
        gc.callbacks.remove(on_gc)
        for n, fn in real.items():
            setattr(ssm, n, fn)
    (f1, b1, _), (f0, b0, _) = walls["with"], walls["without"]
    print(f"[{tag}] with the scans' checkpoints less without them: forward "
          f"{(f1 - f0) * 1e3:.3f} ms, backward {(b1 - b0) * 1e3:.3f} ms; the "
          f"gradient with them {(f1 + b1) / (f0 + b0):.3f} x its time "
          f"without them")


def train_recurrent_phase(torch, library):
    """lm-train-xlstm and lm-train-jamba (TRAIN_RECURRENT): the train step
    on the recurrent mixers' checkpointed training scans, f32, int8 AdamW
    states, remat "full", TRAIN_STEPS steps of 1 x TRAIN_SEQ tokens in
    FaultTolerantLoop, every loss finite and the fourth below the first.
    xlstm launches no kernel: the reduced xlstm's gradients on the card
    are held to the CPU's instead (TRAIN_XLSTM_CHECK).  jamba's attention
    layer trains through flash_attention_lse and the f32 backward pair: its
    kernel route is held to the plain route on one backward from the same
    weights (the loss, every leaf's gradient norm and the full gradients of
    TRAIN_JAMBA_KEEP).  Returns {tag: (launches, launch shapes)} of each
    path's four-step run (counted from 0 around it)."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import (init_params, param_count,
                                    params_from_numpy)
    from repro_torch.models.model import _leaves, _tree
    from repro_torch.runtime.steps import loss_and_grads
    on = card()
    out = {}

    for arch, tag, n_layers, n_experts in TRAIN_RECURRENT:
        t_phase = time.perf_counter()
        cfg = lm_config(arch, tag, n_layers, n_experts)
        n_attn = cfg.n_groups * sum(cfg.layer_kind(j) == "attn"
                                    for j in range(cfg.group_size))
        if not n_attn:
            # -- no kernel route: the card against the CPU, reduced size ------
            rc = ARCHS[arch].reduced()
            tree = {n: t.numpy() for n, t in _leaves(init_params(
                torch.Generator().manual_seed(LM_SEED), rc))}
            b = TokenPipeline(DataConfig(vocab=rc.vocab,
                                         **TRAIN_XLSTM_CHECK)).batch_at(0)
            runs = {}
            for dev in ("cuda", "cpu"):
                p = params_from_numpy(_tree(tree), rc, dev)
                t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                loss, grads = loss_and_grads(p, rc, t["tokens"], t["labels"])
                runs[dev] = (float(loss), dict(_leaves(grads)))
            (l_card, g_card), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
            vs = "card vs CPU"
            worst = [train_held(tag, "loss", l_card, l_cpu, vs)]
            worst += [train_held(tag, n, g, g_cpu[n], vs)
                      for n, g in g_card.items()]
            print(f"[{tag}] {rc.name}, {TRAIN_XLSTM_CHECK}: the loss "
                  f"{l_card:.6f} (CPU {l_cpu:.6f}) and every gradient leaf "
                  f"({len(g_card)}) on the card within {TRAIN_TOL} x max(1, "
                  f"max|cpu|) of the CPU's, the worst at {max(worst):.3f} "
                  f"of it")
            del runs, g_card, g_cpu
        params = init_params(torch.Generator(device="cuda").manual_seed(
            LM_SEED), cfg)
        n_params = param_count(params)
        batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                         global_batch=1)).batch_at(0)
        print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers "
              f"{list(cfg.pattern)}, d_model {cfg.d_model}, {n_params} f32 "
              f"parameters; one microbatch of 1 x {TRAIN_SEQ} tokens, remat "
              f"full, AdamW {TRAIN_OPT}")
        if n_attn:
            # -- the kernel route against the plain route, one gradient -------
            toks, labs = (torch.from_numpy(batch[k]).cuda()
                          for k in ("tokens", "labels"))

            def kept(use_kernels):
                loss, grads = loss_and_grads(params, cfg, toks, labs,
                                             remat="full",
                                             use_kernels=use_kernels)
                norms, full = {}, {}
                for name, g in _leaves(grads):
                    norms[name] = float(torch.linalg.vector_norm(g))
                    if name.endswith(TRAIN_JAMBA_KEEP):
                        full[name] = g.clone()
                del grads
                return float(loss), norms, full
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lk, nk, fk = kept(True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lp, np_, fp = kept(False)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if len(fp) != len(TRAIN_JAMBA_KEEP):
                raise AssertionError(f"[{tag}] kept {sorted(fp)}, not "
                                     f"{TRAIN_JAMBA_KEEP}")
            worst = [train_held(tag, "loss", lk, lp)]
            worst += [train_held(tag, f"norm of {n}", nk[n], np_[n])
                      for n in np_]
            worst += [train_held(tag, n, fk[n], fp[n]) for n in fp]
            print(f"[{tag}] kernel route vs plain route on one backward "
                  f"from the same weights: "
                  f"loss {lk:.6f} vs {lp:.6f}, {len(np_)} gradient norms "
                  f"and {len(fp)} full gradients ({', '.join(fp)}) within "
                  f"{TRAIN_TOL} x max(1, max|plain|), the worst at "
                  f"{max(worst):.3f} of it; backward {t1 - t0:.3f} s kernel "
                  f"route, {t2 - t1:.3f} s plain route (host clock, the "
                  f"first of each)")
            del fk, fp

        # -- four optimizer steps in the fault-tolerant loop ------------------
        run = train_steps(torch, library, cfg, params, batch, tag, TRAIN_OPT,
                          {"flash_attention_lse": 2 * n_attn * TRAIN_STEPS,
                           "flash_attention_bwd_dq": n_attn * TRAIN_STEPS,
                           "flash_attention_bwd_dkdv": n_attn * TRAIN_STEPS}
                          if n_attn else {})
        counts, shapes, step_s = run["counts"], run["shapes"], run["step_s"]
        ops = recurrent_train_ops(cfg, n_params, TRAIN_SEQ)
        b_s = ops / PEAK_F32_FLOPS
        print(f"[{tag}] {TRAIN_STEPS} steps in FaultTolerantLoop, losses "
              f"{[round(x, 6) for x in run['losses']]} (the last below the "
              f"first), int8 states; {step_s * 1e3:.3f} ms a step (host "
              f"clock to the loss, median of steps 2-{TRAIN_STEPS}: "
              f"{[round(w * 1e3, 3) for w in run['walls']]}), "
              f"{TRAIN_SEQ / step_s:.1f} tokens/s; bound {b_s * 1e3:.3f} ms "
              f"({ops:.4e} f32 operations of the matrix products at 67 "
              f"TFLOP/s), {b_s / step_s:.3f} of it; peak device memory "
              f"{run['peak']} bytes; launches "
              f"{({k: n for k, n in counts.items() if n})}; {on}")
        profile_device(torch, f"[{tag}] profile of one step",
                       run["one_step"], step_s * 1e3)
        del run
        gc.collect()
        recurrent_step_breakdown(torch, tag, cfg, params, batch)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[tag] = (counts, shapes)
        print(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def whisper_train_ops(cfg, B: int, S: int) -> float:
    """f32 operations of one lm-train-whisper step, counted as lm-train's:
    a decoder matrix product 8 x its weights x its rows (forward, the
    group's recompute and the backward's two; the cross attention's keys
    and values on the T encoder frames, the rest on the S tokens, the head
    too), an encoder product 6 x (no recompute: the encoder keeps its
    activations); attention's two products forward (twice in the decoder:
    step and recompute) and the five of its backward, over the T x T
    square (the encoder), the S x T rectangle (the cross attention) and
    the causal triangle, diagonal included (the decoder's self-attention)."""
    d, T, H, D = cfg.d_model, cfg.enc_frames, cfg.n_heads, cfg.hd
    E, L = cfg.encoder_layers, cfg.n_layers
    q_o = 2 * d * H * D                              # wq, wo
    k_v = 2 * d * cfg.n_kv_heads * D                 # wk, wv
    ffn = (3 if cfg.act in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    mm = (6.0 * E * T * (q_o + k_v + ffn)
          + 8.0 * L * (S * (q_o + k_v + q_o + ffn) + T * k_v)
          + 8.0 * S * cfg.vocab * d)
    attn = (E * (1 + 2.5) * 4.0 * H * D * T * T
            + L * (2 + 2.5) * (2.0 * H * D * S * (S + 1)
                               + 4.0 * H * D * S * T))
    return B * (mm + attn)


def whisper_bf16_full(torch, tag, tol, got, want, want32) -> list:
    """The bf16 run's full gradients, kernel route ``got`` against plain
    route ``want``, each within ``tol`` x max|want| (the route rule of the
    loss and the norms); beside it each leaf's e = max|want - want32|, the
    plain route's own distance from its f32 run on the same bf16 values
    (tests/test_torch_bf16.py's noise), and the kernel route's.  A sum that
    cancels far below its terms, such as the last decoder layer's wq
    gradient where attention is near uniform, shows there whether the
    kernel route is as close to the f32 gradient as the plain route
    (rowsum(dO * O) from the bf16 o in place of the f32 o put it four
    times further).  Returns the errors' fractions of their bounds."""
    out = []
    for n, w in want.items():
        err = float((got[n].float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        e = float((w.float() - want32[n]).abs().max())
        e_got = float((got[n].float() - want32[n]).abs().max())
        lim = tol * top
        print(f"[{tag}] {n}: kernel vs plain {err:.3e} within {lim:.3e} "
              f"({tol} x max|plain| {top:.3e}); from the f32 run: plain "
              f"route {e:.3e}, kernel route {e_got:.3e}")
        if not err <= lim:
            raise AssertionError(f"[{tag}] {n}: kernel route vs plain route "
                                 f"{err:.3e} > {lim:.3e}")
        out.append(err / lim if lim else 0.0)
    return out


def train_whisper_phase(torch, library):
    """lm-train-whisper and lm-train-whisper-bf16 (TRAIN_WHISPER): the
    encoder-decoder trained at its published widths and depth, f32 then
    bf16.  On each: the kernel route held to the plain route on one
    gradient of the batch from the same weights (the loss, every leaf's
    gradient norm, the full gradients of TRAIN_WHISPER_KEEP; f32 within
    TRAIN_TOL x max(1, max|plain|), bf16 within bf16_route_tol(64: 32
    encoder and 32 decoder layers) x max|plain|, its full gradients also
    read against an f32 run, whisper_bf16_full), then TRAIN_STEPS steps of
    make_train_step (one microbatch of the whole batch) in
    FaultTolerantLoop: finite losses, the fourth below the first, int8
    states, parameters of their type, the launches exactly the step's
    table times the steps, the peak below the card's memory; ms a step,
    tokens/s, the step's bound, one profiled step.  Returns {tag:
    (launches, launch shapes)} of each four-step run."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, param_count
    from repro_torch.models.model import _leaves, _tree
    from repro_torch.runtime.steps import accumulate_grads
    on = card()
    W = TRAIN_WHISPER
    B, S = W["batch"], W["seq"]
    cfg = lm_config(WHISPER["arch"], W["tag"], None)
    E, L = cfg.encoder_layers, cfg.n_layers
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B)).batch_at(0)
    tokens = {k: torch.from_numpy(data[k]).cuda() for k in ("tokens",
                                                           "labels")}
    frames = torch.randn(
        (B, cfg.enc_frames, cfg.d_model), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(LM_SEED + 3))
    total = torch.cuda.get_device_properties(0).total_memory
    ops = whisper_train_ops(cfg, B, S)
    out = {}
    for dtype, tag, opt, tol, floor in (
            (torch.float32, W["tag"], TRAIN_OPT, TRAIN_TOL, 1.0),
            (torch.bfloat16, W["tag"] + "-bf16", TRAIN_BF16_OPT,
             bf16_route_tol(E + L), 0.0)):
        t_phase = time.perf_counter()
        sfx = "" if dtype == torch.float32 else "_bf16"
        # the frames in the step's working type, as the reference's
        # input_specs give them
        batch = tokens | {"enc_frames": frames.to(dtype)}
        params = init_params(torch.Generator(device="cuda").manual_seed(
            LM_SEED), cfg, dtype=dtype)
        w_bytes = sum(t.numel() * t.element_size()
                      for _, t in _leaves(params))
        print(f"[{tag}] {cfg.name}: {E} encoder and {L} decoder layers, "
              f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, "
              f"{cfg.enc_frames} frames: {param_count(params)} parameters, "
              f"{w_bytes} bytes in {dtype}; one microbatch of {B} x {S} "
              f"tokens over {B} x {cfg.enc_frames} frames, remat full, "
              f"AdamW {opt}")

        def kept(use_kernels, p=None, b=None):
            """(loss, {leaf: gradient norm}, {name: full gradient}) of the
            batch's gradient (or ``b``'s at ``p``), accumulated in f32 over
            microbatches."""
            loss, grads = accumulate_grads(
                params if p is None else p, cfg, batch if b is None else b,
                W["route_mbs"], torch.float32, remat="full",
                use_kernels=use_kernels)
            flat = dict(_leaves(grads))
            norms = {n: float(torch.linalg.vector_norm(g.float()))
                     for n, g in flat.items()}
            full = {f"{n}[{layer}]": flat[n][layer].clone()
                    for n, layer in TRAIN_WHISPER_KEEP}
            del grads, flat
            return float(loss), norms, full

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, nk, fk = kept(True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lp, np_, fp = kept(False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not any(n.startswith("encoder/") for n in np_):
            raise AssertionError(f"[{tag}] no encoder leaf in the gradient")
        held = functools.partial(train_held, tag, tol=tol, floor=floor)
        worst = [held("loss", lk, lp)]
        worst += [held(f"norm of {n}", nk[n], np_[n]) for n in np_]
        if dtype == torch.float32:
            worst += [held(n, fk[n], fp[n]) for n in fp]
            rule = f"{tol} x max(1, max|plain|)"
        else:
            worst += whisper_bf16_full(torch, tag, tol, fk, fp, kept(
                False, _tree({n: t.float() for n, t in _leaves(params)}),
                batch | {"enc_frames": batch["enc_frames"].float()})[2])
            rule = (f"{tol} x max|plain| (the full gradients beside their "
                    f"distances from the plain route's f32 run)")
        print(f"[{tag}] kernel vs plain route on one gradient of the batch "
              f"from the same weights ({W['route_mbs']} microbatches "
              f"accumulated in f32): loss {lk:.6f} vs {lp:.6f}, {len(np_)} "
              f"gradient norms and {len(fp)} full gradients "
              f"({', '.join(fp)}) within {rule}, the worst at "
              f"{max(worst):.4f} of it; {t1 - t0:.3f} s kernel route, "
              f"{t2 - t1:.3f} s plain route (host clock)")
        del fk, fp
        run = train_steps(torch, library, cfg, params, batch, tag, opt, {
            f"flash_attention_lse{sfx}": (E + 2 * 2 * L) * TRAIN_STEPS,
            f"flash_attention_bwd_dq{sfx}": (E + 2 * L) * TRAIN_STEPS,
            f"flash_attention_bwd_dkdv{sfx}": (E + 2 * L) * TRAIN_STEPS},
            dtype=dtype, microbatches=1)
        counts, shapes, step_s = run["counts"], run["shapes"], run["step_s"]
        if not run["peak"] < total:
            raise AssertionError(f"[{tag}] peak {run['peak']} bytes, the "
                                 f"card has {total}")
        peak_flops = PEAK_F32_FLOPS if dtype == torch.float32 else \
            PEAK_BF16_FLOPS
        b_s = ops / peak_flops
        print(f"[{tag}] {TRAIN_STEPS} steps in FaultTolerantLoop, losses "
              f"{[round(x, 6) for x in run['losses']]} (the last below the "
              f"first), events {run['events']}; {step_s * 1e3:.3f} ms a "
              f"step (host clock to the loss, median of steps 2-"
              f"{TRAIN_STEPS}: {[round(w * 1e3, 3) for w in run['walls']]}"
              f"), {B * S / step_s:.1f} tokens/s "
              f"({B * cfg.enc_frames / step_s:.1f} frames/s); bound {b_s * 1e3:.3f} ms ({ops:.4e} "
              f"operations at {peak_flops / 1e12:g} TFLOP/s), "
              f"{b_s / step_s:.3f} of it; peak device memory {run['peak']} "
              f"bytes of {total}; launches "
              f"{({k: n for k, n in counts.items() if n})}; {on}")
        profile_device(torch, f"[{tag}] profile of one step",
                       run["one_step"], step_s * 1e3)
        del run, params
        gc.collect()
        torch.cuda.empty_cache()
        out[tag] = (counts, shapes)
        print(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def mesh_one(torch, library, cfg, batch, mesh):
    """One TRAIN_OPT step of make_train_step on yi-6b made from LM_SEED,
    unsharded (``mesh`` None) or on ``mesh``: (metrics, the kept leaves on
    the host, launches, launch shapes, seconds, peak memory).  Weights,
    states and gradients are released before it returns."""
    from repro_torch.models import init_params
    from repro_torch.models.model import _leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.testing.mesh_cases import _whole
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    params = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                         cfg)
    state = init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat="full", device="cuda",
                           mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    library.reset_launches()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    metrics = {k: float(v) for k, v in m.items()}      # synchronises
    secs = time.perf_counter() - t0
    counts, shapes = library.launches(), library.launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    kept = {n: _whole(t) for n, t in _leaves(params)
            if any(n.endswith(k) for k in MESH_KEEP)}
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, kept, counts, shapes, secs, peak


def mesh_serve(torch, library, cfg, mesh):
    """lm-mesh-serve: one prefill and MESH_SERVE_DECODES decode steps of
    yi-6b made from LM_SEED, unsharded, then on ``mesh``, each mesh step
    held bit for bit to the unsharded one.  Returns (the mesh run's
    launches and launch shapes), the unsharded and the mesh seconds of the
    prefill and of each decode step, and the number of cache leaves."""
    import numpy as np
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.model import _leaves
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    B, S, S_MAX = 1, MESH_SERVE_SEQ, MESH_SERVE_S_MAX
    tag = MESH_SERVE_TAG
    tokens = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B)).batch_at(0)["tokens"]
    decode = np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (MESH_SERVE_DECODES, B))
    params = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                         cfg)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def run(m, held=None):
        """[(logits, {leaf: copy})] after each step (or each step held to
        ``held``'s), launches, launch shapes and seconds."""
        prefill = make_prefill_step(cfg, B, S_MAX, device="cuda", mesh=m)
        step = make_decode_step(cfg, B, S_MAX, device="cuda", mesh=m)
        cache = init_cache(cfg, B, S_MAX, device="cuda")
        outs, secs = [], []

        def keep(i, logits, cache):
            got = (whole(logits).clone(),
                   {n: whole(t).clone() for n, t in _leaves(cache)})
            if held is None:
                outs.append(got)
                return
            want = held[i]
            what = "the prefill" if i == 0 else f"decode step {i}"
            if not bit_equal(torch, got[0], want[0]):
                raise AssertionError(f"[{tag}] logits of {what} on the "
                                     f"mesh differ from the unsharded's")
            bad = [n for n in want[1] if not bit_equal(torch, got[1][n],
                                                       want[1][n])]
            if bad:
                raise AssertionError(f"[{tag}] cache leaves {bad} after "
                                     f"{what} differ on the mesh")
        torch.cuda.synchronize()
        library.reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cache, {"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts, shapes = library.launches(), library.launch_shapes()
        keep(0, logits, cache)
        for i, tok in enumerate(decode):
            t0 = time.perf_counter()
            logits, cache = step(params, cache,
                                 torch.as_tensor(tok, device="cuda")[:, None],
                                 torch.full((B,), S + i, device="cuda"))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            keep(i + 1, logits, cache)
        return outs, counts, shapes, secs

    plain, p_counts, _, p_secs = run(None)
    _, m_counts, m_shapes, m_secs = run(mesh, plain)
    want = dict.fromkeys(library.SIGNATURES, 0) | {
        "flash_attention": cfg.n_layers}
    if m_counts != p_counts or m_counts != want:
        raise AssertionError(f"[{tag}] prefill launches {m_counts} on the "
                             f"mesh, {p_counts} unsharded, expected {want}")
    n_leaves = len(plain[0][1])
    del plain, params
    gc.collect()
    torch.cuda.empty_cache()
    return (m_counts, m_shapes), p_secs, m_secs, n_leaves


def mesh_turns(torch, cfg, batch, mesh):
    """The train step unsharded and on ``mesh`` in turns on one training
    state (yi-6b from LM_SEED, TRAIN_OPT): MESH_TURNS steps of each,
    alternating, each timed on the host clock to its loss.  Returns
    {"unsharded": [s, ...], "mesh": [s, ...]} and the losses."""
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.steps import _local, make_train_step
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    params = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                         cfg)
    state = init_opt_state(params, opt_cfg)
    steps = {"unsharded": make_train_step(cfg, opt_cfg, remat="full",
                                          device="cuda"),
             "mesh": make_train_step(cfg, opt_cfg, remat="full",
                                     device="cuda", mesh=mesh)}
    times: dict = {"unsharded": [], "mesh": []}
    losses = []
    for i in range(2 * MESH_TURNS):
        label = ("unsharded", "mesh")[i % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = steps[label](params, state, batch)
        losses.append(float(m["loss"]))                 # synchronises
        times[label].append(time.perf_counter() - t0)
        if label == "mesh":
            # a 1x1 mesh's local shards are the whole tensors, the same
            # storage: the next unsharded step takes them as they are
            params, state = _local(params), _local(state)
    del params, state, steps
    gc.collect()
    torch.cuda.empty_cache()
    return times, losses


def mesh_phase(torch, library):
    """The train step on a device mesh (``make_train_step(..., mesh=)``):
    (a) a world of one, (c) pod compression on two ranks (constants
    MESH_*).  Returns {tag: (launches, launch shapes)} of (a)."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.testing.mesh_cases import config
    from repro_torch.testing.ranks import run_ranks
    on = card()
    out = {}
    t_phase = time.perf_counter()
    tag = MESH_ONE_TAG
    cfg = ARCHS[TRAIN_ARCH]
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                     global_batch=1)).batch_at(0)
    mesh = make_host_mesh()
    ref = mesh_one(torch, library, cfg, batch, None)
    got = mesh_one(torch, library, cfg, batch, mesh)
    if got[0] != ref[0]:
        raise AssertionError(f"[{tag}] metrics {got[0]} on the 1x1 mesh, "
                             f"{ref[0]} unsharded")
    for n, w in ref[1].items():
        if not np.array_equal(got[1][n], w):
            raise AssertionError(f"[{tag}] {n} after the step differs "
                                 f"from the unsharded step's")
    L = cfg.n_layers
    want = dict.fromkeys(library.SIGNATURES, 0) | {
        "flash_attention_lse": 2 * L, "flash_attention_bwd_dq": L,
        "flash_attention_bwd_dkdv": L}
    if got[2] != ref[2] or got[2] != want:
        raise AssertionError(f"[{tag}] launches {got[2]} on the mesh, "
                             f"{ref[2]} unsharded, expected {want}")
    print(f"[{tag}] {cfg.name} whole ({L} layers), one TRAIN_OPT step "
          f"of 1 x {TRAIN_SEQ} tokens on make_host_mesh() (NCCL, a "
          f"world of one) bit for bit the unsharded step: loss "
          f"{got[0]['loss']!r}, grad_norm {got[0]['grad_norm']!r}, "
          f"{len(ref[1])} kept leaves ({', '.join(MESH_KEEP)}) equal; "
          f"launches {({k: n for k, n in got[2].items() if n})} both; "
          f"{got[4]:.3f} s vs {ref[4]:.3f} s a step (host clock, the "
          f"first), peak {got[5]} vs {ref[5]} bytes; {on}")
    out[tag] = (got[2], got[3])
    del ref, got
    gc.collect()
    torch.cuda.empty_cache()
    tag = MESH_SERVE_TAG
    launched, p_secs, m_secs, n_leaves = mesh_serve(torch, library, cfg,
                                                    mesh)
    print(f"[{tag}] {cfg.name} whole, one prefill of 1 x {MESH_SERVE_SEQ} "
          f"tokens and {MESH_SERVE_DECODES} decode steps (cache of "
          f"{MESH_SERVE_S_MAX}) through make_prefill_step / "
          f"make_decode_step(mesh=make_host_mesh()) bit for bit the "
          f"unsharded steps: the last logits, every decode's logits and all "
          f"{n_leaves} cache leaves (each stacked over {cfg.n_groups} layer "
          f"groups) after each step; launches "
          f"{({k: n for k, n in launched[0].items() if n})} both; prefill "
          f"{m_secs[0]:.3f} s vs {p_secs[0]:.3f} s unsharded, decode "
          f"steps {[round(x, 4) for x in m_secs[1:]]} vs "
          f"{[round(x, 4) for x in p_secs[1:]]} s (host clock, first "
          f"call of each); {on}")
    out[tag] = launched
    tag = "lm-mesh-turns"
    times, losses = mesh_turns(torch, cfg, batch, mesh)
    med = {k: statistics.median(v[1:]) for k, v in times.items()}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[{tag}] losses {losses}")
    print(f"[{tag}] the train step in turns on one state, {MESH_TURNS} "
          f"steps each (unsharded first): median of steps 2-{MESH_TURNS} "
          f"{med['mesh']:.4f} s on the mesh vs {med['unsharded']:.4f} s "
          f"unsharded, {med['mesh'] / med['unsharded']:.4f} x; steps "
          f"{[round(x, 4) for x in times['mesh']]} vs "
          f"{[round(x, 4) for x in times['unsharded']]} s (host clock to "
          f"the loss); losses {[round(x, 6) for x in losses]}; {on}")
    torch.distributed.destroy_process_group()
    tag = "lm-mesh-pod"
    arch, layers = TRAIN_ARCH, MESH_POD_LAYERS
    cfg = config(arch, reduced=False, layers=layers)
    print(f"[{tag}] {cfg.name}: depth cut from {ARCHS[arch].n_layers} "
          f"to {layers} layers, every width published")
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=MESH_POD_SEQ,
                                     global_batch=MESH_POD)).batch_at(0)
    res = run_ranks("repro_torch.testing.mesh_cases:pod_lm", MESH_POD,
                    arch, batch, layers=layers, reduced=False,
                    seed=LM_SEED, device="cuda", backend="gloo",
                    timeout=MESH_TIMEOUT)
    worst = max(max(r["rel"].values()) for r in res)
    if not worst < MESH_POD_REL or not all(r["exact_error"]
                                           for r in res):
        raise AssertionError(f"[{tag}] compressed gradient {worst:.4f} "
                             f"of max|exact| (bound {MESH_POD_REL}); new "
                             f"errors exact: "
                             f"{[r['exact_error'] for r in res]}")
    print(f"[{tag}] make_pod_compressed_grad_fn on {MESH_POD} gloo ranks "
          f"forming the pod axis, {cfg.name} cut to {layers} layers, "
          f"{MESH_POD} x {MESH_POD_SEQ} tokens: every leaf within "
          f"{worst:.5f} of max|exact mean| (bound {MESH_POD_REL}), every "
          f"new error exactly corrected - q scale, loss "
          f"{res[0]['loss']!r}; {on}")
    print(f"mesh phase {time.perf_counter() - t_phase:.1f} s")
    return out


def dryrun_start() -> list:
    """Start ``python -m repro_torch.launch.dryrun`` for every
    DRYRUN_SHAPES cell of DRYRUN_ARCH on both production meshes, one
    niced process a cell (one intra-op thread, no device), beside the
    card phases.  Returns [(cell, process, start time, log path)]."""
    import atexit
    import os
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    procs = []
    for multi in (False, True):
        for shape in DRYRUN_SHAPES:
            cell = (DRYRUN_ARCH, shape, "multipod" if multi else "singlepod")
            log = DRYRUN_OUT / f"{'__'.join(cell)}.log"
            (DRYRUN_OUT / f"{'__'.join(cell)}.json").unlink(missing_ok=True)
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", DRYRUN_ARCH, "--shape", shape, "--out",
                    str(DRYRUN_OUT)]
            with open(log, "w") as f:
                procs.append((cell, subprocess.Popen(
                    argv + (["--multi-pod"] if multi else []), stdout=f,
                    stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                    preexec_fn=lambda: os.nice(19)),
                    time.perf_counter(), log))

    def stop():
        for _, proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)
    return procs


def dryrun_phase(procs: list) -> None:
    """Wait for :func:`dryrun_start`'s cells (at most DRYRUN_TIMEOUT
    seconds from their start) and print each record's line: its run's
    seconds, per-device bytes, fits_hbm, operations and collective bytes
    by kind.  Raises if a cell errors or does not finish."""
    failed = []
    for cell, proc, t0, log in procs:
        try:
            proc.wait(max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failed.append(f"{cell} not finished in {DRYRUN_TIMEOUT} s")
            continue
        path = DRYRUN_OUT / f"{'__'.join(cell)}.json"
        if proc.returncode or not path.exists():
            tail = log.read_text()[-2000:]
            failed.append(f"{cell} exit {proc.returncode}: {tail}")
            continue
        rec = json.loads(path.read_text())
        coll = rec["collectives"]
        print(f"[dryrun] {'/'.join(cell)}: {rec['n_devices']} ranks, step "
              f"{rec['lower_s']} s on meta tensors, per-device bytes "
              f"{rec['per_device_bytes']} (arguments "
              f"{rec['memory']['argument_size_in_bytes']}, peak temporaries "
              f"{rec['memory']['temp_size_in_bytes']}), fits_hbm "
              f"{rec['fits_hbm']}, {rec['cost']['flops']:.6e} operations a "
              f"device, collective bytes {coll['total_bytes']:.6e} "
              f"({json.dumps(coll['by_kind'])}) in {coll['n_ops']} ops")
    if failed:
        raise AssertionError("dry-run cells failed: " + "; ".join(failed))


def train_bf16_phase(torch, library):
    """lm-train-bf16: yi-6b at its published widths in bf16 (parameters and
    gradients bf16, int8 AdamW states, remat full, the same one microbatch
    of 1 x TRAIN_SEQ tokens as lm-train, AdamW TRAIN_BF16_OPT).  The
    kernel route's loss, every
    gradient norm and the full gradients of embed and layers 0 and 31's
    attention projections held to the plain route's within
    bf16_route_tol(2 x 32 layers) of max|plain| (the forward's layers and
    the backward's); then TRAIN_STEPS steps of make_train_step(dtype=bf16)
    in FaultTolerantLoop: finite losses, the fourth below the first, every
    parameter still bf16, exactly 2 x 32 flash_attention_lse_bf16 and 32
    of each bf16 backward kernel a step; ms a step and the peak memory
    beside lm-train's f32 run.  Returns {tag: (launches, launch shapes)}."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, param_count
    from repro_torch.models.model import _leaves
    from repro_torch.runtime.steps import loss_and_grads
    tag, on = TRAIN_BF16_TAG, card()
    cfg = ARCHS[TRAIN_ARCH]
    L = cfg.n_layers
    t_phase = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(LM_SEED),
                         cfg, dtype=torch.bfloat16)
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                     global_batch=1)).batch_at(0)
    toks, labs = (torch.from_numpy(batch[k]).cuda()
                  for k in ("tokens", "labels"))
    w_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    print(f"[{tag}] {cfg.name}: {param_count(params)} parameters, "
          f"{w_bytes} bytes in bf16; one microbatch of 1 x {TRAIN_SEQ} "
          f"tokens, remat full, AdamW {TRAIN_BF16_OPT}")
    tol = bf16_route_tol(2 * L)

    def kept(use_kernels):
        loss, grads = loss_and_grads(params, cfg, toks, labs, remat="full",
                                     use_kernels=use_kernels)
        norms, full = {}, {}
        for name, g in _leaves(grads):
            norms[name] = float(torch.linalg.vector_norm(g.float()))
            if name == "embed":
                full[name] = g
            for leaf in TRAIN_KEEP:
                if name.endswith(leaf):
                    for layer in (0, L - 1):
                        full[f"{name}[{layer}]"] = g[layer].clone()
        del grads
        return float(loss), norms, full

    def held(what, got, want):
        if isinstance(want, float):
            err, scale = abs(got - want), abs(want)
        else:
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
        lim = tol * scale
        if not err <= lim:
            raise AssertionError(f"[{tag}] {what}: kernel route vs plain "
                                 f"route {err:.3e} > {lim:.3e}")
        return err / lim if lim else 0.0

    lk, nk, fk = kept(True)
    lp, np_, fp = kept(False)
    worst = [held("loss", lk, lp)]
    worst += [held(f"norm of {n}", nk[n], np_[n]) for n in np_]
    worst += [held(n, fk[n], fp[n]) for n in fp]
    print(f"[{tag}] kernel vs plain route on one backward from the same "
          f"bf16 weights: loss {lk:.6f} vs {lp:.6f}, {len(np_)} gradient "
          f"norms and {len(fp)} full gradients within {tol} x max|plain| "
          f"(2 x 2^-8 x sqrt({2 * L}) layers, forward and backward), the "
          f"worst at "
          f"{max(worst):.4f} of it")
    del fk, fp

    run = train_steps(torch, library, cfg, params, batch, tag,
                      TRAIN_BF16_OPT, {
                          "flash_attention_lse_bf16": 2 * L * TRAIN_STEPS,
                          "flash_attention_bwd_dq_bf16": L * TRAIN_STEPS,
                          "flash_attention_bwd_dkdv_bf16": L * TRAIN_STEPS},
                      dtype=torch.bfloat16)
    counts, shapes, step_s = run["counts"], run["shapes"], run["step_s"]
    print(f"[{tag}] {TRAIN_STEPS} steps in FaultTolerantLoop, losses "
          f"{[round(x, 6) for x in run['losses']]} (the last below the "
          f"first); {step_s * 1e3:.3f} ms a step (host clock to the loss, "
          f"median of steps 2-{TRAIN_STEPS}: "
          f"{[round(w * 1e3, 3) for w in run['walls']]}), "
          f"{TRAIN_SEQ / step_s:.1f} tokens/s; peak device memory "
          f"{run['peak']} bytes (lm-train's f32 run: 66552842240 in "
          f"PERF.md); launches {({k: n for k, n in counts.items() if n})}; "
          f"{on}")
    profile_device(torch, f"[{tag}] profile of one step", run["one_step"],
                   step_s * 1e3,
                   both_ways=True)
    del run, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return {tag: (counts, shapes)}


def staged_yi_phase(torch, library, cfg, params):
    """lm-staged, part (a): yi-6b in f32 on the weights lm-serve made,
    copied to host memory, through StagedExecutor(n_stages=4) on the kernel
    route: with the boundary codec off the logits of 2 x 512 seeded tokens
    bit for bit the monolithic forward + project_logits on the card; with
    it on, argmax agreement above STAGED_AGREE and boundary_compression
    below STAGED_COMPRESSION (the reference's own checks).  Returns
    (launches, launch shapes) of the two staged runs."""
    import numpy as np
    from repro_torch.models import forward, project_logits
    from repro_torch.runtime.reconfigure import StagedExecutor
    tag, on = "lm-staged", card()
    toks = torch.as_tensor(np.random.default_rng(LM_SEED + 2).integers(
        0, cfg.vocab, STAGED_TOKENS), device="cuda")
    with torch.no_grad():
        x, _, _ = forward(params, cfg, toks)
        want = project_logits(params, cfg, x)
    del x
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the executor copies the card's weights to host memory once
    raw = StagedExecutor(cfg, params, n_stages=STAGED_YI_STAGES,
                         compress_boundary=False, device="cuda")
    copy_s = time.perf_counter() - t0
    library.reset_launches()
    got = raw.forward_logits(toks)
    comp = StagedExecutor(cfg, raw.host_params, n_stages=STAGED_YI_STAGES,
                          compress_boundary=True, device="cuda")
    got_c = comp.forward_logits(toks)
    torch.cuda.synchronize()
    counts, shapes = library.launches(), library.launch_shapes()
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        "flash_attention_lse": 2 * cfg.n_layers}
    if counts != expected:
        raise AssertionError(f"[{tag}] launches {counts}, expected "
                             f"{expected}")
    if not bit_equal(torch, got, want):
        raise AssertionError(f"[{tag}] staged logits are not bit for bit "
                             f"the monolithic forward's (max abs diff "
                             f"{float((got - want).abs().max())})")
    agree = float((got_c.argmax(-1) == got.argmax(-1)).float().mean())
    eq5 = comp.eq5_latency(batch=STAGED_TOKENS[0])
    print(f"[{tag}] (a) {cfg.name} f32, {STAGED_YI_STAGES} stages "
          f"{raw.stages} on {STAGED_TOKENS[0]} x {STAGED_TOKENS[1]} seeded "
          f"tokens: codec off, logits bit for bit the monolithic forward; "
          f"codec on, argmax agreement {agree:.4f} (above {STAGED_AGREE}), "
          f"eq5 {json.dumps(eq5)}; per stage (compute_s, reconfig_s) "
          f"codec off {[(round(t.compute_s, 4), round(t.reconfig_s, 4)) for t in raw.timings]}, "
          f"on {[(round(t.compute_s, 4), round(t.reconfig_s, 4)) for t in comp.timings]}; "
          f"weights to host {copy_s:.2f} s; {on}")
    if not (agree > STAGED_AGREE
            and eq5["boundary_compression"] < STAGED_COMPRESSION):
        raise AssertionError(f"[{tag}] codec on: agreement {agree}, "
                             f"compression {eq5['boundary_compression']}")
    del raw, comp
    gc.collect()
    return counts, shapes


def _mem_total() -> int:
    """The host's MemTotal, bytes (/proc/meminfo)."""
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) * 1024
    raise AssertionError("no MemTotal in /proc/meminfo")


def staged_jamba_phase(torch, library):
    """lm-staged, part (b): jamba-v0.1-52b in bf16 at its published widths
    through StagedExecutor, one period of its pattern (a layer group of 8)
    a stage: the whole depth where half the host's memory holds its
    weights, else the most whole periods (at least STAGED_MIN_PERIODS)
    that fit, the cut printed with MemTotal.  The weights are made on the
    card a group at a time from the seeded generator and moved to host
    memory.  The kernel route with the codec on is the path (its launches
    counted, eq5_latency, per-stage compute_s / reconfig_s, the boundary
    bytes and the peak device memory, below the card's and the weights'
    bytes); then the kernel route and the plain route with the codec off,
    the router's choices held by testing.routing.hold_routing, measured
    (the parting layer's router logits within bf16_route_tol of the depth,
    a flip only within twice their largest difference), the logits within
    bf16_route_tol of the depth where no choice flips; the codec's argmax agreement with the raw
    kernel route is printed.  Returns (launches, launch shapes) of the
    path's run."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.models.common import dense_init, norm_params
    from repro_torch.models.model import _leaves, _stack, _tree
    from repro_torch.runtime.reconfigure import StagedExecutor
    from repro_torch.testing.routing import RoutingTape, hold_routing
    tag, on = "lm-staged", card()
    t_phase = time.perf_counter()
    full = ARCHS[STAGED_ARCH]
    gs, bf16 = full.group_size, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)

    def group():
        """One layer group's leaves on the card, (1, ...) each."""
        return dict(_leaves(_stack(gen, full, bf16, 1, cross=False)))
    first = group()
    period = sum(t.numel() * t.element_size() for t in first.values())
    d, V = full.d_model, full.vocab
    rest = 2 * V * d * 2 + 2 * d            # embed, lm_head, final norm
    mem = _mem_total()
    fit = int((mem // 2 - rest) // period)
    periods = (full.n_layers // gs if mem >= 160e9 else
               max(STAGED_MIN_PERIODS, min(full.n_layers // gs, fit)))
    cfg = dataclasses.replace(full, n_layers=periods * gs)
    w_bytes = periods * period + rest
    print(f"[{tag}] (b) {full.name} bf16: host MemTotal {mem} bytes; a "
          f"period of its pattern {list(full.pattern)} holds {period} bytes "
          f"of weights, embedding, head and norm {rest}; "
          + (f"the whole model ({full.n_layers} layers, {w_bytes} bytes) "
             f"fits in half of it" if periods * gs == full.n_layers else
             f"depth cut from {full.n_layers} to {cfg.n_layers} layers "
             f"({periods} periods, {w_bytes} bytes; {fit} fit within half "
             f"of MemTotal, at least {STAGED_MIN_PERIODS} are run)")
          + f"; {periods} stages of one period each, every width published")
    groups = {n: torch.empty((periods,) + tuple(t.shape[1:]), dtype=t.dtype)
              for n, t in first.items()}
    t0 = time.perf_counter()
    for g in range(periods):
        made = first if g == 0 else group()
        for n, t in made.items():
            groups[n][g].copy_(t[0])
        del made
    del first
    host = {"embed": dense_init(gen, (V, d), bf16, scale=0.02).cpu(),
            "groups": _tree(groups),
            "final_norm": norm_params(full.norm, d, bf16, "cpu"),
            "lm_head": dense_init(gen, (V, d), bf16, scale=0.02).cpu()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[{tag}] (b) weights made on the card a group at a time and moved "
          f"to host memory in {time.perf_counter() - t0:.2f} s: "
          f"{sum(t.numel() * t.element_size() for _, t in _leaves(host))} "
          f"bytes")
    toks = torch.as_tensor(np.random.default_rng(LM_SEED + 3).integers(
        0, cfg.vocab, STAGED_TOKENS), device="cuda")
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))

    def staged(**kw):
        return StagedExecutor(cfg, host, n_stages=periods, dtype=bf16,
                              device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    library.reset_launches()
    ex = staged()
    t0 = time.perf_counter()
    got_c = ex.forward_logits(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, shapes = library.launches(), library.launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    expected = dict.fromkeys(library.SIGNATURES, 0) | {
        "flash_attention_lse_bf16": n_attn}
    if counts != expected:
        raise AssertionError(f"[{tag}] launches {counts}, expected "
                             f"{expected}")
    eq5 = ex.eq5_latency(batch=STAGED_TOKENS[0])
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    print(f"[{tag}] (b) {STAGED_TOKENS[0]} x {STAGED_TOKENS[1]} seeded "
          f"tokens, kernel route, codec on: {wall:.3f} s host clock; eq5 "
          f"{json.dumps(eq5)}; per stage (compute_s, reconfig_s, boundary "
          f"raw, sent bytes) "
          f"{[(round(t.compute_s, 4), round(t.reconfig_s, 4), t.boundary_bytes_raw, t.boundary_bytes_sent) for t in ex.timings]}; "
          f"peak device memory {peak} bytes ({peak - base} above what was "
          f"held before), the card {card_bytes}, the weights {w_bytes}; "
          f"launches {({k: n for k, n in counts.items() if n})}; {on}")
    if not (peak < card_bytes and peak < w_bytes):
        raise AssertionError(f"[{tag}] peak {peak} not below the card's "
                             f"{card_bytes} and the weights' {w_bytes}")
    if not eq5["boundary_compression"] < STAGED_COMPRESSION:
        raise AssertionError(f"[{tag}] boundary compression "
                             f"{eq5['boundary_compression']}")
    del ex
    tol = bf16_route_tol(cfg.n_layers)
    with RoutingTape() as tape:
        got = staged(compress_boundary=False).forward_logits(toks)
        rk = tape.take()
        plain = staged(compress_boundary=False,
                       use_kernels=False).forward_logits(toks)
        rp = tape.take()
    layers = [n for n in range(cfg.n_layers) if cfg.layer_is_moe(n)]
    hold = hold_routing(rk, rp, tol, measured=True)
    agree = float((got_c.argmax(-1) == got.argmax(-1)).float().mean())
    if hold.parted is None:
        err = float((got - plain).abs().max() / plain.abs().max())
        if not err <= tol:
            raise AssertionError(f"[{tag}] kernel vs plain route logits "
                                 f"{err:.3e} of max|plain| > {tol}")
        what = (f"every router choice alike; logits within {err:.3e} of "
                f"max|plain| (tol {tol})")
    else:
        top = float(rp[hold.parted].logits.float().abs().max())
        what = (f"the routes part in layer {layers[hold.parted]} at "
                f"{len(hold.flips)} near-tie(s) (plain logit gaps "
                f"{[f'{f.gap:.3e}' for f in hold.flips]}, each at most 2 x "
                f"the layer's largest router-logit difference "
                f"{hold.delta:.3e}, which is {hold.delta / top:.3e} of "
                f"max|plain router logit| (tol {tol})), the logits past it "
                f"not compared")
    print(f"[{tag}] (b) kernel vs plain route, codec off: {what}; dropped "
          f"(token, k) pairs kernel {sum(r.dropped for r in rk)}, plain "
          f"{sum(r.dropped for r in rp)}; codec on vs off argmax agreement "
          f"{agree:.4f} (printed: the codec's step moves the routers' "
          f"inputs by far more than a near-tie); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    del host, groups, got, got_c, plain
    gc.collect()
    torch.cuda.empty_cache()
    return counts, shapes


class LastLogits:
    """An engine's sampler (argmax) that keeps the logits of its last call:
    within one ``step`` the decode's (B, vocab) come last."""

    def __init__(self, torch):
        self.torch = torch
        self.last = None

    def __call__(self, logits):
        self.last = logits
        return self.torch.argmax(logits, -1)


def moe_prefill_check(torch, cfg, tag, i, eng, plain, prompt):
    """One prompt through both routes with the router's choices recorded,
    held by ``testing.routing.hold_routing`` (every changed choice a
    near-tie on the plain route, capacity verdicts changed only after a
    changed choice).  Prints the pairs each route dropped and any flip.
    Returns (kernel logits, kernel cache, plain logits, plain cache, the
    number of layers to hold to LM_TOL, None where the routes never
    part)."""
    from repro_torch.testing.routing import RoutingTape, hold_routing
    with RoutingTape() as tape:
        lk, ck = eng.run_prefill(prompt)
        rk = tape.take()
        lp, cp = plain.run_prefill(prompt)
        rp = tape.take()
    hold = hold_routing(rk, rp, LM_TOL)
    layers = [n for n in range(cfg.n_layers) if cfg.layer_is_moe(n)]
    print(f"[{tag}] prefill {i} ({len(prompt)} tokens, capacity "
          f"{rk[0].capacity}): dropped (token, k) pairs, kernel route "
          f"{sum(r.dropped for r in rk)}, plain {sum(r.dropped for r in rp)} "
          f"(per layer {[r.dropped for r in rk]})")
    if hold.parted is None:
        return lk, ck, lp, cp, None
    layer = layers[hold.parted]
    for f in hold.flips:
        print(f"[{tag}] prefill {i}: the routes part in layer {layer}: "
              f"token {f.token} rank {f.rank} expert {f.kernel} (kernel) / "
              f"{f.plain} (plain), plain logit gap {f.gap:.3e} (near-tie "
              f"below {f.limit:.3e}); {hold.keep_changes} capacity verdicts "
              f"follow")
    return lk, ck, lp, cp, layer + 1


def moe_streams(torch, cfg, tag, params, prompts, served, plain, log, kw):
    """The token streams of a mixture of experts on both routes.  The
    slots of one decode step share the router's capacity, so a changed
    token or choice in one slot moves the others: a fresh engine on the
    kernel route and the plain engine run in lockstep, and every step is
    held until the routes part (the first step whose tokens or decode
    routing differ), which must be at a near-tie: a routing flip held by
    ``hold_routing``, else the plain route's top-2 logit margin of the
    parting slot below LM_TOL x max|logit|.  After that both drain
    unchecked.  The fresh kernel engine's streams must be the served
    ones.  Prints the pairs dropped at every decode step."""
    from repro_torch.models.moe import capacity
    from repro_torch.serving import ServingEngine
    from repro_torch.testing.routing import RoutingTape, hold_routing
    kern = ServingEngine(cfg, params, **kw)
    # the slot each plain request decodes in, to read its logits row
    slot_of = {}
    prefill = plain._prefill

    def note_slot(slot, r):
        slot_of[r.rid] = slot
        prefill(slot, r)
    plain._prefill = note_slot
    engines = {"kernel": kern, "plain": plain}
    reqs = {k: [e.submit(p, max_new_tokens=LM_MAX_NEW) for p in prompts]
            for k, e in engines.items()}
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    drops, step, parted = [], 0, None
    with RoutingTape() as tape:
        while True:
            live, recs = {}, {}
            for k, e in engines.items():
                tape.take()
                live[k] = e.step()
                recs[k] = tape.take()[-n_moe:]
            if live["kernel"] != live["plain"]:
                raise AssertionError(f"[{tag}] the routes' schedules differ")
            if not live["kernel"]:
                break
            step += 1
            drops.append(sum(r.dropped for r in recs["kernel"]))
            if parted is not None:
                continue
            hold = hold_routing(recs["kernel"], recs["plain"], LM_TOL)
            toks = {k: [r.out_tokens for r in rs] for k, rs in reqs.items()}
            if hold.parted is None and toks["kernel"] == toks["plain"]:
                continue
            parted = f"decode step {step}"
            if hold.parted is not None:
                f = hold.flips[0] if hold.flips else None
                parted += (f": the decode routing parts in MoE layer "
                           f"{hold.parted}" + (
                               "" if f is None else
                               f", slot {f.token} rank {f.rank} expert "
                               f"{f.kernel} / {f.plain}, plain logit gap "
                               f"{f.gap:.3e} (near-tie below {f.limit:.3e})"))
                continue
            for b, (a, q) in enumerate(zip(toks["kernel"], toks["plain"])):
                if a == q:
                    continue
                t = next(j for j, (x, y) in enumerate(zip(a, q)) if x != y)
                if t == 0:
                    # a first token: held with its prefill above
                    parted += f"; request {b}'s first token"
                    continue
                row = log.last[slot_of[reqs["plain"][b].rid]]
                top = row.topk(2).values
                margin = float(top[0] - top[1])
                lim = LM_TOL * float(row.abs().max())
                parted += (f"; request {b} at token {t}, the plain route's "
                           f"top-2 logit margin {margin:.3e} (tol {lim:.3e})")
                if margin >= lim:
                    raise AssertionError(f"[{tag}] request {b}: streams part "
                                         f"at token {t} past a tie")
    if [r.out_tokens for r in reqs["kernel"]] != [r.out_tokens
                                                  for r in served]:
        raise AssertionError(f"[{tag}] a fresh kernel-route engine's token "
                             f"streams differ from the served ones")
    equal = sum(a.out_tokens == b.out_tokens
                for a, b in zip(reqs["kernel"], reqs["plain"]))
    print(f"[{tag}] token streams of the two routes, in lockstep: {equal} of "
          f"{LM_REQUESTS} equal; "
          + (f"the routes part at {parted}" if parted else
             f"every decode step of {step} routes alike"))
    print(f"[{tag}] dropped (token, k) pairs per decode step (kernel route, "
          f"capacity {capacity(LM_SLOTS, cfg)}): {drops}")
    del kern


def autotune_phase(torch, repro_torch, library) -> None:
    """The autotuned path: ``GraphStreamServer.autotuned`` on the YOLO head
    (one search through the façade, every candidate lowered and measured
    on the card), then the winner: FRAMES seeded staged frames, each
    launching exactly ``launch_table`` of its plan, every vertex and the
    frame held to reference mode as phase 3 holds a frame;
    AUTOTUNE_SERVED seeded frames through the server, one flush, every
    result bit for bit the staged executor's and every kernel of the table
    launched; ``Compiled.save`` of the design and ``Compiled.load``, bit for
    bit on one frame, its strategy and digest kept.  Prints the trajectory,
    the calibration, the search's seconds and peak device memory.  Runs
    after phase 5: phase 4 replays none of its launches."""
    from repro_torch.api import CompileSpec, Compiled
    from repro_torch.core import builders, exec_input_shape
    from repro_torch.optim import autotune as AT
    from repro_torch.runtime.executor import launch_table
    from repro_torch.serving import GraphStreamServer
    t_phase = time.perf_counter()
    g = builders.build_yolo_head_exec(**YOLO)
    cfg = AT.AutotuneConfig(**AUTOTUNE)
    # every candidate's plan, in the order the search lowers them (the
    # records carry no tiles)
    lowered, lower = [], AT.lower_plan_pipelined

    def recording(graph, plan, **kw):
        lowered.append(plan)
        return lower(graph, plan, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    library.reset_launches()
    AT.lower_plan_pipelined = recording
    t0 = time.perf_counter()
    try:
        srv = GraphStreamServer.autotuned(g, "u200", autotune_cfg=cfg,
                                          kernel_mode="cuda")
        torch.cuda.synchronize()
    finally:
        AT.lower_plan_pipelined = lower
    search_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    search_launches = library.launches()
    res = srv.autotune_result
    cal = res.calibration
    best = res.best_plan
    traj = res.trajectory
    print(f"[autotune] search (seed DSE, {len(traj)} candidates lowered and "
          f"measured, the winner lowered for the server): {search_s:.2f} s "
          f"host clock; peak device memory {peak} bytes ({peak - held} "
          f"above the {held} held before it)")
    if len(lowered) != len(traj):
        raise AssertionError(f"[autotune] {len(lowered)} lowerings for "
                             f"{len(traj)} candidates")
    for r, p in zip(traj, lowered):
        print(f"[autotune] candidate {r.index:2d} {r.move:8s} accepted "
              f"{str(r.accepted):5s} stages {r.n_stages} evicted "
              f"{r.n_evicted} fragged {r.n_fragged} tiles (bm {p.tile_bm}, "
              f"bc {p.tile_bc}) fps measured {r.fps_measured:.2f} "
              f"calibrated Eq. 6 {r.fps_eq6_cal:.2f} bottleneck stage "
              f"{r.bottleneck_stage}")
    print(f"[autotune] baseline {res.baseline_fps:.2f} fps, best "
          f"{res.best_fps:.2f} fps (pipelined, CUDA events, ticks over the "
          f"best of {cfg.repeats} streams of {cfg.microbatches}); "
          f"s_per_cycle {cal.s_per_cycle:.6e}; Eq. 6 error |log(pred / "
          f"meas)| before calibration {cal.pre_err:.4f}, after "
          f"{cal.post_err:.4f} (improved: {cal.improved})")
    fragged = {n: lp.weight_static_fraction for n, lp in best.layers.items()
               if lp.weight_static_fraction < 1.0}
    print(f"[autotune] winner: {json.dumps(res.summary())}; tiles (bm "
          f"{best.tile_bm}, bc {best.tile_bc}); evicted "
          f"{[(s.src, s.dst) for s in best.streams if s.evicted]}; "
          f"fragmented {fragged}")
    # the tile move always applies on the card, so _propose never ends the
    # search early: exactly n_candidates
    if traj[0].move != "seed" or res.best_fps < res.baseline_fps:
        raise AssertionError("[autotune] the seed is not candidate 0 or the "
                             "winner is slower than it")
    if not (math.isfinite(cal.s_per_cycle) and cal.s_per_cycle > 0):
        raise AssertionError(f"[autotune] s_per_cycle {cal.s_per_cycle}")
    if len(traj) != cfg.n_candidates:
        raise AssertionError(f"[autotune] {len(traj)} candidates, expected "
                             f"{cfg.n_candidates}")
    # the seed was measured first: the seed and the winner again, in turns
    # (seed, winner, winner, seed), each lowered afresh, so a gain that is
    # only the first candidate's start-up shows
    again = {"seed": [], "winner": []}
    xs = torch.randn((cfg.microbatches,) + exec_input_shape(g),
                     generator=torch.Generator().manual_seed(500)).cuda()
    for label in ("seed", "winner", "winner", "seed"):
        sx = lower(g, lowered[0] if label == "seed" else best,
                   microbatches=cfg.microbatches, kernel_mode="cuda",
                   device="cuda")
        again[label].append(AT.measure_pipelined_fps(
            sx, xs, repeats=cfg.repeats, warmup=cfg.warmup))
        del sx
    print(f"[autotune] measured again after the search, in turns: seed "
          f"{again['seed'][0]:.2f}, {again['seed'][1]:.2f} fps; winner "
          f"{again['winner'][0]:.2f}, {again['winner'][1]:.2f} fps")
    table = {k: n for k, n in launch_table(g, best).items()
             if k != "plain_dot"}
    if any(search_launches[k] == 0 for k in table):
        raise AssertionError(f"[autotune] the search launched "
                             f"{search_launches}, not every kernel of the "
                             f"winner's table {table}")

    # -- the winner, staged: launches, vertices, frame bound -----------------
    staged = repro_torch.compile(CompileSpec(
        model=g, device="u200", strategy="manual-plan", plan=best,
        kernel_mode="cuda"))
    refc = repro_torch.compile(CompileSpec(
        model=g, device="u200", strategy="manual-plan", plan=best,
        kernel_mode="reference"))
    staged.executor.params = refc.executor.params = srv.executor.params
    expected = dict.fromkeys(library.SIGNATURES, 0) | table
    m, c = staged.input_shape()
    for f in range(FRAMES):
        xd = torch.randn((m, c), generator=torch.Generator().manual_seed(
            300 + f)).cuda()
        torch.cuda.synchronize()
        library.reset_launches()
        y = staged.run(xd)
        torch.cuda.synchronize()
        if library.launches() != expected:
            raise AssertionError(f"[autotune] staged frame {f}: launches "
                                 f"{library.launches()}, expected "
                                 f"{expected}")
        yr = refc.run(xd)
        summary, _ = hold_frame(torch, f"[autotune] staged frame {f}",
                                staged.executor, refc.executor, refc.run,
                                xd, y, yr)
        print(f"[autotune] staged frame {f}: launches {table}; {summary}")

    # -- the winner, served ---------------------------------------------------
    frames = [torch.randn((m, c), generator=torch.Generator().manual_seed(
        400 + i)) for i in range(AUTOTUNE_SERVED)]
    tickets = [srv.submit(f) for f in frames]
    torch.cuda.synchronize()
    library.reset_launches()
    t0 = time.perf_counter()
    srv.flush()
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t0) * 1e3
    served = library.launches()
    missing = [k for k in table if served[k] == 0]
    if missing:
        raise AssertionError(f"[autotune] served flush launched none of "
                             f"{missing}")
    for t, f in zip(tickets, frames):
        if not bit_equal(torch, srv.result(t), staged.run(f.cuda())):
            raise AssertionError(f"[autotune] served ticket {t} is not the "
                                 f"staged executor's result")
    print(f"[autotune] {AUTOTUNE_SERVED} frames served in one flush "
          f"({flush_ms:.3f} ms host clock, launches counted): every result "
          f"bit-equal to the staged executor; launches "
          f"{ {k: n for k, n in served.items() if n} }")

    # -- the winner, saved and loaded -----------------------------------------
    design = Compiled(spec=CompileSpec(
        model=g, device="u200", strategy="autotune", mode="pipelined",
        kernel_mode="cuda", microbatches=cfg.microbatches, seed=0,
        autotune_cfg=cfg), graph=g, device="u200", plan=best,
        executor=srv.executor, autotune_result=res)
    with tempfile.TemporaryDirectory() as tmp:
        art = design.save(pathlib.Path(tmp) / "yolo-autotuned.smof.json")
        loaded = Compiled.load(art)
    x = frames[0].cuda()
    digest = best.provenance["autotune_digest"]
    if (loaded.strategy != "autotune"
            or loaded.plan.provenance.get("autotune_digest") != digest
            or not bit_equal(torch, loaded.run(x), design.run(x))):
        raise AssertionError("[autotune] the loaded artifact lost its "
                             "strategy or digest, or its output")
    print(f"[autotune] artifact saved and loaded: strategy "
          f"{loaded.strategy}, digest {digest}, one frame bit-equal; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def profile_device(torch, label: str, fn, ms: float,
                   both_ways: bool = False) -> None:
    """``fn`` once under ``torch.profiler``: the device-side events'
    busy time against ``ms``, the median unprofiled time of the same work
    (the profiler itself slows the host).  The events are read from the
    profiler's own results (``kineto_results``, a private attribute of
    ``torch.profiler.profile`` read on PyTorch 2.11), not through
    ``key_averages()``, whose Python event objects take minutes over the
    million launches of a recurrent train step.  ``both_ways`` also sums
    the same profile through ``key_averages()`` and prints both sums.
    Where device events overlap (streams running at once), it also prints
    the time some event covers (the union of their intervals, which the
    sum counts twice where they overlap) and the idle share that leaves."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    # the device-side events (kernels, copies): a host op's own device
    # time repeats its kernels'
    by_name = collections.defaultdict(lambda: [0, 0])
    spans = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                and not e.is_user_annotation()):
            row = by_name[e.name()]
            row[0] += e.duration_ns()
            row[1] += 1
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    read_s = time.perf_counter() - t1
    busy = sum(ns for ns, _ in by_name.values()) / 1e6
    if busy == 0:
        print(f"{label}: the profiler saw no device time; device busy and "
              f"idle share not measured")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"{label}: device busy {busy:.3f} ms, idle share "
          f"{1 - busy / ms:.3f} of {ms:.3f} ms ({wall:.3f} ms under the "
          f"profiler, its events read in {read_s:.1f} s); by device time: "
          + "; ".join(f"{name[:60]} {ns / 1e6:.3f} ms x{n}"
                      for name, (ns, n) in top))
    cover, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            cover += b - a
            end = b
        elif b > end:
            cover += b - end
            end = b
    if cover < sum(ns for ns, _ in by_name.values()):
        print(f"{label}: device events cover {cover / 1e6:.3f} ms of "
              f"{ms:.3f} (idle share {1 - cover / 1e6 / ms:.3f}); summed "
              f"they take {busy:.3f} ms, {busy - cover / 1e6:.3f} ms of it "
              f"beside another event")
    if both_ways:
        t1 = time.perf_counter()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        kbusy = sum(e.self_device_time_total for e in events) / 1e3
        print(f"{label}: the same profile through key_averages(): device "
              f"busy {kbusy:.3f} ms in {sum(e.count for e in events)} "
              f"events (read in {time.perf_counter() - t1:.1f} s), the "
              f"events' own {busy:.3f} ms in "
              f"{sum(n for _, n in by_name.values())}; torch "
              f"{torch.__version__}")


def profile_host(torch, label: str, fn, top: int = 8) -> None:
    """``fn`` once under ``cProfile``, synchronised at the end: the host
    functions with the most time of their own (Python and the C calls it
    makes; a call that waits for the card shows its wait here)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"{label}: host {st.total_tt * 1e3:.3f} ms under cProfile; most "
          f"time of their own: " + "; ".join(
              f"{pstats.func_std_string(f)[-60:]} {tt * 1e3:.3f} ms x{nc}"
              for f, (_, nc, tt, _, _) in rows))
    # the recurrent mixers' share of the host time: the cumulative time of
    # each models/ssm.py function that no other function of that file calls
    # (a generator expression is inside its function's time already)
    ssm = {f: v for f, v in st.stats.items()
           if f[0].endswith("models/ssm.py") and not f[2].startswith("<")}
    entries = {f: v[3] for f, v in ssm.items()
               if not any(c in ssm for c in v[4])}
    if entries:
        inside = sum(entries.values())
        print(f"{label}: host time inside the recurrent mixers "
              f"(models/ssm.py) {inside * 1e3:.3f} ms, share "
              f"{inside / st.total_tt:.3f} of the host time; by entry: "
              + "; ".join(f"{f[2]} {ct * 1e3:.3f} ms x{ssm[f][1]}"
                          for f, ct in sorted(entries.items(),
                                              key=lambda kv: -kv[1])))


def stream_phase(torch, repro_torch, path: StreamPath, main, staged, refc):
    """Phase 5 for a pipelined path: ms per microbatch, pipelined (spills
    evicted, spills resident, reference mode) and staged; peak device
    memory of one stream; the measured stage latencies; one profiled
    stream (DSE plan)."""
    from repro_torch.runtime.streamer import measured_stage_latencies
    plan = main.plan
    resident = dataclasses.replace(
        plan, provenance=dict(plan.provenance),
        streams=[dataclasses.replace(s, evicted=False, codec="none")
                 for s in plan.streams])
    resc = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, device="u200", strategy="manual-plan",
        plan=resident, mode="pipelined", microbatches=path.microbatches))
    resc.executor.params = main.executor.params
    B = path.microbatches
    m, c = main.input_shape()
    xs = torch.randn((B, m, c),
                     generator=torch.Generator().manual_seed(99)).cuda()
    per_mb = {}
    for label, comp in (("pipelined, spills evicted", main),
                        ("pipelined, spills resident", resc),
                        ("pipelined, reference mode", refc)):
        ms, peak = frame_stats(torch, comp, xs)
        per_mb[label] = ms / B
        print(f"[{path.name}] {label}: {ms / B:.3f} ms per microbatch "
              f"({ms:.3f} ms per stream of {B}, median of 5, host clock), "
              f"peak device memory of one stream above weights and input "
              f"{peak} bytes")
    ms, peak = frame_stats(torch, staged, xs[0])
    print(f"[{path.name}] staged, spills evicted: {ms:.3f} ms per "
          f"microbatch (median of 5, host clock), peak device memory of one "
          f"frame {peak} bytes")
    lat = measured_stage_latencies(main.executor, xs[0], repeats=5,
                                   warmup=2)
    print(f"[{path.name}] measured stage latencies (CUDA events, median of "
          f"5): {[round(t * 1e3, 4) for t in lat]} ms; Eq. 5 sum "
          f"{sum(lat) * 1e3:.4f} ms, Eq. 6 max {max(lat) * 1e3:.4f} ms")
    if path.plan == "dse":
        profile_device(torch, f"[{path.name}] profile of one evicted stream",
                       lambda: main.run(xs),
                       per_mb["pipelined, spills evicted"] * B)
        for label, comp in (("evicted", main), ("resident", resc)):
            profile_host(torch, f"[{path.name}] host profile of one "
                         f"{label} stream", lambda c=comp: c.run(xs))


def event_ms(torch, fn, reps: int = 5) -> float:
    """Median ms of ``fn`` between CUDA events on the current stream (one
    warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def ring_time_phase(torch, path: StreamPath, main, ring):
    """Phase 5 for the ring: ms per microbatch of ``path``'s stream, the
    interleave and the ring in turns (interleave, ring, ring, interleave),
    each by CUDA events on the current stream around a stream (median of
    5) and by the host clock; both executors' measured stage latencies
    (the ring's each on its stage stream between the events) and
    ``measure_pipelined_fps`` (the autotuner's clock); one profiled
    stream of each, its device time summed and covered (the union of the
    events' intervals: the ring's streams may overlap)."""
    from repro_torch.optim.autotune import measure_pipelined_fps
    from repro_torch.runtime.streamer import measured_stage_latencies
    tag = f"{path.name}-ring"
    B = path.microbatches
    m, c = main.input_shape()
    xs = torch.randn((B, m, c),
                     generator=torch.Generator().manual_seed(99)).cuda()
    fns = {"interleave": lambda: main.executor(xs), "ring": lambda: ring(xs)}
    ev = collections.defaultdict(list)
    host = collections.defaultdict(list)
    for label in ("interleave", "ring", "ring", "interleave"):
        ev[label].append(event_ms(torch, fns[label]) / B)
        run = main if label == "interleave" else types.SimpleNamespace(
            run=ring)
        host[label].append(frame_stats(torch, run, xs)[0] / B)
    print(f"[{tag}] ms per microbatch over a stream of {B} ({card()}; "
          f"{torch.cuda.device_count()} device(s) on the host), in turns, "
          f"CUDA events median of 5 / host clock median of 5: interleave "
          f"{[round(t, 4) for t in ev['interleave']]} / "
          f"{[round(t, 4) for t in host['interleave']]}, ring on "
          f"{[str(d) for d in ring.devices]} "
          f"{[round(t, 4) for t in ev['ring']]} / "
          f"{[round(t, 4) for t in host['ring']]}")
    for label, sx in (("interleave", main.executor), ("ring", ring)):
        lat = measured_stage_latencies(sx, xs[0], repeats=5, warmup=2)
        fps = measure_pipelined_fps(sx, xs)
        print(f"[{tag}] {label}: measured stage latencies (CUDA events, "
              f"median of 5): {[round(t * 1e3, 4) for t in lat]} ms; "
              f"measure_pipelined_fps {fps:.1f} (ticks over the best of 3 "
              f"streams)")
    for label in ("interleave", "ring"):
        profile_device(torch, f"[{tag}] profile of one {label} stream",
                       fns[label], statistics.median(host[label]) * B)


def memory_phase(torch, repro_torch, path: Path, main, refc):
    """Phase 5 for one path: frame time and peak memory with the spills
    evicted, with the same plan's spills resident (no encode, no off-chip
    hop, no decode), and in reference mode; then one evicted frame under
    ``torch.profiler`` for the device's busy time and idle share."""
    plan = main.plan
    resident = dataclasses.replace(
        plan, provenance=dict(plan.provenance),
        streams=[dataclasses.replace(s, evicted=False, codec="none")
                 for s in plan.streams])
    resc = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, device="u200", strategy="manual-plan",
        plan=resident, mode="staged"))
    resc.executor.params = main.executor.params
    m, c = main.input_shape()
    x = torch.randn((m, c), generator=torch.Generator().manual_seed(99))
    xd = x.cuda()
    frame_ms = {}
    for label, comp in (("kernels, spills evicted", main),
                        ("kernels, spills resident", resc),
                        ("reference mode, spills evicted", refc)):
        frame_ms[label], peak = frame_stats(torch, comp, xd)
        print(f"[{path.name}] frame ({label}): {frame_ms[label]:.3f} ms "
              f"(median of 5, host clock), peak device memory above "
              f"weights and input {peak} bytes")
    # where the evicted frame's time goes on the device
    profile_device(torch, f"[{path.name}] profile of one evicted frame",
                   lambda: main.run(xd), frame_ms["kernels, spills evicted"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import library
    from repro_torch.testing.oracle import VERTEX_PARITY_TOL as MATMUL_TOL

    # -- 1. the card -----------------------------------------------------------
    name_limit = card()
    print(name_limit)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    sheet_phase(torch)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    kl = library.load_library()
    print(f"build: {kl.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kl.build_s:.2f} s)")
    source = kernel = ""
    spills = []
    for line in kl.log.splitlines():
        if line.startswith("=="):
            source = line[2:].strip()
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]  # ptxas's own (mangled) name
        if "registers" in line:
            print(f"  {line.strip()} [{kernel}]")
        elif line.startswith("==") or "spill" in line:
            print(f"  {line.strip()}")
        # the tensor-core kernels keep their tiles in registers, the pool
        # and dwconv families their sums and tap windows, the codec its
        # blocks: no spills
        if (source in ("streamed_matmul.cu", "flash_attention.cu",
                       "flash_attention_bf16.cu", "flash_attention_bwd.cu",
                       "flash_attention_bwd_bf16.cu", "conv2d.cu",
                       "conv2d_decode.cu", "streaming_conv.cu", "dwconv.cu",
                       "bfp8.cu")
                and "spill" in line
                and any(int(w) for w in line.split() if w.isdigit())):
            spills.append(f"{source} [{kernel}]: {line.strip()}")
    if spills:
        raise AssertionError("spills: " + "; ".join(spills))
    # the dry-run's cells run on the host beside the card phases
    dry = dryrun_start()
    # the attention kernels' tiles: shared memory, registers and blocks an
    # SM of each backward instance and of the bf16 forward pair, as the card
    # reports them
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     backward_occupancy,
                                                     forward_occupancy)
    for d in HEAD_DIMS:
        for name, (nbytes, regs, blocks) in (forward_occupancy(d)
                                             | backward_occupancy(d)).items():
            print(f"  {name} D={d}: {nbytes} bytes of shared memory, "
                  f"{regs} registers, {blocks} block(s) an SM")

    # -- 3. the main paths, one after the other -------------------------------
    runs = {p.name: run_path(torch, repro_torch, library, p) for p in PATHS}
    streams = {p.name: run_stream_path(torch, repro_torch, library, p)
               for p in STREAM_PATHS}
    ring_path = next(p for p in STREAM_PATHS if p.name == RING_PATH)
    ring, ring_counts, ring_shapes = ring_phase(
        torch, library, ring_path, streams[RING_PATH][0])
    t0 = time.perf_counter()
    served = serve_phase(torch, repro_torch, library, STREAM_PATHS[0])
    t1 = time.perf_counter()
    fuzzed = fuzz_phase(torch, library)
    t2 = time.perf_counter()
    lm, lm_s = {}, {}
    for arch, tag, n_layers, dtype in LM_PATHS:
        t3 = time.perf_counter()
        if tag == "lm-serve":
            # lm-staged's first part runs on the weights this path made
            c, sh, cfg, params = lm_serve_phase(
                torch, library, arch, tag, n_layers, dtype, keep=True)
            lm[tag] = (c, sh)
            lm["lm-staged-yi"] = staged_yi_phase(torch, library, cfg, params)
            del params
        else:
            lm[tag] = lm_serve_phase(torch, library, arch, tag, n_layers,
                                     dtype)
        # the model is released: the next LM path, then phase 4, start
        # with the card's memory free
        gc.collect()
        torch.cuda.empty_cache()
        lm_s[tag] = time.perf_counter() - t3
    t3 = time.perf_counter()
    lm[WHISPER["tag"]] = whisper_phase(torch, library)
    gc.collect()
    torch.cuda.empty_cache()
    lm_s[WHISPER["tag"]] = time.perf_counter() - t3
    t3 = time.perf_counter()
    trained = train_phase(torch, library)
    gc.collect()
    torch.cuda.empty_cache()
    trained |= train_bf16_phase(torch, library)
    gc.collect()
    torch.cuda.empty_cache()
    trained |= train_recurrent_phase(torch, library)
    gc.collect()
    torch.cuda.empty_cache()
    trained |= train_whisper_phase(torch, library)
    gc.collect()
    torch.cuda.empty_cache()
    trained |= mesh_phase(torch, library)
    t4 = time.perf_counter()
    lm["lm-staged-jamba"] = staged_jamba_phase(torch, library)
    lm_s["lm-staged-jamba"] = time.perf_counter() - t4
    print(f"served path {t1 - t0:.1f} s, fuzz path {t2 - t1:.1f} s, LM "
          f"serving paths " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in lm_s.items())
          + f", LM training paths {t4 - t3:.1f} s; device "
          f"memory held after them {torch.cuda.memory_allocated()} bytes")
    # launches and launch shapes per frame (staged), per stream
    # (pipelined), per flush (served) or over the phase (fuzz)
    counts = {n: r[-2] for n, r in (runs | streams).items()}
    shapes = {n: r[-1] for n, r in (runs | streams).items()}
    for name, (c, sh) in ((f"{RING_PATH}-ring", (ring_counts, ring_shapes)),
                          ("yolo-served", served), ("fuzz", fuzzed),
                          *lm.items(), *trained.items()):
        counts[name], shapes[name] = c, sh

    # -- 4. kernels against their plain versions --------------------------------
    timer = Timer(torch)
    rows = kernel_phase(torch, timer, shapes)
    for name, row in rows.items():
        row["launches"] = sum(c[name] for c in counts.values())
        if row["launches"] == 0:
            raise AssertionError(f"kernel {name} never launched on a path")
    for r in rows.values():
        name = r["name"]
        if name in ("conv2d", "streamed_matmul"):
            tol = f"{MATMUL_TOL}; two launches bit-exact"
        elif name == "flash_attention":
            tol = (f"rtol = atol = {FLASH_TOL} vs plain; two launches "
                   f"bit-exact")
        elif name == "flash_attention_lse" or name in BWD_KERNELS:
            tol = (f"{TRAIN_TOL} x max(1, max|plain|) vs plain, every "
                   f"output; two launches bit-exact")
        elif name in BF16_KERNELS:
            tol = (f"one bf16 ulp of plain + 2 x 2^-24 (n + D) x each "
                   f"element's sum of absolute terms, lse and delta "
                   f"{TRAIN_TOL} x max(1, max|plain|); two launches "
                   f"bit-exact")
        elif name.startswith("conv2d"):
            tol = (f"bit-exact vs the conv2d kernel on the decode kernel's "
                   f"output and the codec, {MATMUL_TOL} vs plain; two "
                   f"launches bit-exact")
        elif name.startswith("pool"):
            tol = (f"bit-exact vs the pool kernel on the decode kernel's "
                   f"output and the codec; vs plain bit-exact at k=2, "
                   f"{POOL_TOL} x mean|x| above")
        else:
            tol = "bit-exact"
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        b3 = ("" if "bound_tf32x3_ms" not in r
              else f"3xTF32 bound {r['bound_tf32x3_ms']:.4f} ")
        if "bound_products_ms" in r:
            b3 += f"own products bound {r['bound_products_ms']:.4f} "
        print(f"kernel {name:22s} launches {r['launches']:3d} "
              f"max_abs_err {r['max_abs_err']:.3e} (tol {tol}) "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library {lib} "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}) {b3}"
              f"by path {json.dumps(r['by_path'])}")
    for pname in counts:
        kern_sum = sum(r["by_path"].get(pname, {}).get("ms", 0.0)
                       for r in rows.values())
        print(f"[{pname}] sum of the path's kernel times (L2 flushed): "
              f"{kern_sum:.3f} ms")

    # -- 5. time and memory per frame or microbatch ----------------------------
    for p in PATHS:
        main_c, refc, _, _ = runs[p.name]
        memory_phase(torch, repro_torch, p, main_c, refc)
    for p in STREAM_PATHS:
        main_c, staged, refc, _, _ = streams[p.name]
        stream_phase(torch, repro_torch, p, main_c, staged, refc)
    ring_time_phase(torch, ring_path, streams[RING_PATH][0], ring)
    print(f"phases 2-5: {time.perf_counter() - t_start:.1f} s")

    # -- the autotuned path (after phase 5: phase 4 replays none of it) -------
    autotune_phase(torch, repro_torch, library)
    # -- the public wrapper and the walkthroughs (phase 4 replays none) ------
    walkthrough_phase(torch, library, timer, shapes[FRAG_PATH])
    t0 = time.perf_counter()
    dryrun_phase(dry)
    print(f"dry-run phase: waited {time.perf_counter() - t0:.1f} s after "
          f"the card phases")

    # -- 6. results -------------------------------------------------------------
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
