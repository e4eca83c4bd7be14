#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (serl_tpu_torch) runs on one GPU.

    python3 chip_smoke.py              # every phase, and the result lines
    python3 chip_smoke.py --kernels    # phases 1 and 2 and K5's times only

Phases, each fatal (non-zero exit, no result line) on failure:
  1. device: the card's name and power limit; build the CUDA kernels from the
     sources in this checkout, one nvcc per source started together (K1, the
     control step, serl_tpu_torch/csrc/control_step.cu; K2, the renderer,
     csrc/render.cu, and a second build of it with the other -fmad flag; K3,
     the random crop, csrc/random_crop.cu; K4, the replay gather,
     csrc/replay_gather.cu; K5, Dense + LayerNorm + tanh forward and
     backward, csrc/dense_layer_norm_tanh.cu) while g++ builds K1's and K2's
     code for the host to count their operations (tests/k1_host.cpp,
     tests/k2_host.cpp); print the build times and ptxas lines;
  2. every kernel against its plain version on the card: K1 at N = 128,
     2048 and 101 (not a multiple of the envs per block) env states from two
     sources (a plain-version rollout with random actions, and constructed
     grasp states with the cube between the pads), which must include active
     floor and pad contacts: one control step, field by field and env by env,
     and a 100-step kernel-vs-plain rollout, under the tolerance rule of
     tests/torch_k1.py; two more launches on each input, at N = 2048 a
     launch on its first 101 envs and at N = 128 launches on its first 30
     and 32 (the RLPD path's widths), equal bit for bit; K1 also at pose-task
     inputs (the peg env's settled resets with their per-env yaw, and after
     10 noisy pose-expert steps through the Euler box) at N = 16 and 2048,
     under the same rule, and at the cable-route env's inputs at 8, 16, 20 and
     2048 envs, where K2 is held too; K1 with the bin walls (its obstacle
     input, M = 8) at N = 32 and 2048 at bin states (cubes pressed into
     walls and corners, sunk into a wall's top, at its top edge: every set
     with active obstacle contacts) under the same rule, repeated launches
     bit for bit, and a launch with M = 0 equal bit for bit to one with no
     table and to a build with the obstacle code compiled out; K2 (both -fmad builds)
     at N = 16 and 128, 128 px, on rollout and grasp states (cube in the
     wrist camera's view), and at the fwbw paths' 32 chained envs on bin
     states and on the chained env's states after a reset and 15, 40 and 80
     expert steps (cube in the front camera's view), under the pixel rule of tests/torch_k2.py (failing
     the phase for the shipped build only), its scene rows (the kernel's
     debug output) within tests/torch_k2.py's SCENE_ATOL of pack_scene's,
     and one render under torch.cuda.set_sync_debug_mode("error"); K3 at
     (1024, 1, 128, 128, 3) and (1024, 3, 128, 128, 3), four image batches
     per launch, and at K3_PATHS, which reach its word and byte paths
     (frames 4 bytes off, 252- and 33-byte rows) and float frames, and the
     classifier's and VICE's (128, 1, 128, 128, 3) crops: exactly
     equal; K4 at the state path's shapes (782 slots x 128 streams, 2048
     rows, next_observations stored and not), the RLPD path's online half
     (6,250 x 32, 1,024 rows) and at the pixel path's (625 x
     16, 1024 rows of 128 px frames, frame stacks T = 1 and 3), on wrapped
     rings with episode boundaries and the seam, and on fields that reach
     each of its copy paths (16-byte, word and byte units, wide and narrow
     rows, a base address 4 bytes off), and at the pixel RLPD path's
     online half (3,125 x 16, 512 rows of 128 px frames) and that half on
     the pixel path's ring, and at the pose tasks' pixel ring (1,250 x 16,
     10-dim state, 7-dim actions; 512 rows and VICE's 80), and on the fwbw
     path's routed rings (6,250 x 32 from states, 625 x 32 of 128 px
     frames, and the 600 x 16 demo rings of both; 512 rows each; unequal
     stream sizes, one
     stream never written): exactly equal; K5 forward
     and backward at every (form, E, M, K, D) of K5_SHAPES (the ResNet heads'
     bottleneck at K = 4,096 among them, and the shapes where the forward
     splits K over blocks) under the rule of tests/torch_k5.py, its
     forward (split or not) and its weight-grad sums repeating bit for
     bit; K5_SHAPES holds every shape that a path of phase 3 gives K5:
     each path's run logs K5's calls, and one at a shape outside
     K5_SHAPES fails it;
  3. the actor path: make_state_sim_experiment with 128 envs and the
     full-width networks, 20 loop iterations (8 random, 12 policy) and a
     128-episode evaluate; the state learner path: bench.py::bench_state's
     configuration (128 envs, UTD 8, batch 256, 10 critics subsampled to 2,
     buffer 100,000) warmed up past its training threshold, then 3 chunks of
     50 iterations timed as bench.py does (best of 3, ending in a sync), then
     a 128-episode evaluate; the pixel learner path: bench.py::bench_pixels'
     configuration through make_drq_sim_experiment (16 envs, two 128 px
     cameras, small encoders, UTD 4, batch 256, 2 updates per iteration,
     buffer 10,000) warmed up in chunks of 25 past its threshold, then 3
     chunks of 25 timed, then a 16-episode evaluate; the RLPD path:
     examples/fused_sac_state_sim.py --rlpd at the state_sim preset (32
     envs, batch 256 x UTD 8, 4 update_high_utd calls per iteration, buffer
     200,000): the example's scripted_demos, 30 expert episodes through K1
     (at least 15 must succeed), the successful ones' first 2,000
     transitions as a 20-stream demo ring, 64 warm-up iterations past the
     2,048-row threshold, then run_fused for 3 chunks of 10 iterations with
     a 32-episode evaluate after each; sample_mixed on the card's rings must
     equal, bit for bit, the same draws on CPU copies of both rings (the
     plain path), its even rows must be rows of the online ring and its odd
     rows rows of the demo ring, and a learner step with sample_mixed
     runs under torch.cuda.set_sync_debug_mode("error"); the pixel RLPD
     path: examples/fused_drq_sim.py --rlpd at the drq_rlpd preset (16
     envs, two 128 px cameras, small encoders, batch 256 x UTD 4, 2
     update_high_utd calls per iteration, buffer 50,000): the example's
     scripted_pixel_demos, 30 expert episodes through K1 and K2 (at least
     15 must succeed), 20 selected on the card as a 20-stream uint8 demo
     ring, a warm-up past the training threshold, run_fused for 2 chunks of
     5 with a 32-episode evaluate after each, sample_mixed over the two
     uint8 rings with explicit draws bit for bit equal to the same draws
     on CPU copies of the rings, the interleave and a sync-free learner
     step; the ResNet path: bench.py::bench_pixels("resnet-pretrained")'s
     configuration, the frozen ResNet-10 grafted from resnet10_params.pkl
     (every backbone tensor and its target copy equal to the pickle's
     values cast to fp32), warmed up past its threshold, 3 chunks of 10
     iterations timed (bench.py's 25 cut to 10), the backbones bit for bit
     unchanged after them, a 16-episode evaluate, the card's backbone
     features of 32 rendered frames against the CPU's fp32 features under
     tests/torch_resnet.py's rule, where an iteration's time goes and the
     loop's busy share; the trained ResNet: a DrQ agent with the "resnet"
     encoder (a bf16 ResNet-10 per camera, trained through the critic
     loss), 3 update_high_utd calls (batch 256 x UTD 4) on batches of the
     ResNet path's ring, every parameter moving, the backbones' included;
     the pose-task paths: examples/fused_pcb_insert.py from states with the
     BC term, cosine learning rates and the demo reset bank (16 envs, batch
     256 x UTD 4, buffer 100,000): 20 auto-reset expert demo streams through
     the pose expert (their successful episodes counted; at least 20), the
     8-stream state bank, then run_fused with a checkpoint directory three
     times: uninterrupted for 6 chunks of 16 iterations, paused by the pause
     file after 4, and resumed to the end, whose loop carry must equal the
     uninterrupted one's bit for bit in every leaf; the uninterrupted run's
     last checkpoint restored onto a CPU agent and by eval_from_checkpoint
     onto a card agent must equal its params; and
     examples/fused_peg_insert.py --pixels at full width (16 envs, two 128
     px cameras, small encoders, batch 256 x UTD 4, the 20,000-row uint8
     ring): 20 pixel expert demo streams, a warm-up past the threshold, 3
     timed chunks of 10 (env-steps/s and updates/s, best of 3), the busy
     share and device ms by kernel; a pose env step launches K1 six times
     (the step and every env's 5-step settled reset); the learned-reward
     paths: examples/fused_cable_route.py at full width (the classifier's
     frames from 8 + 8 + 8 streams of the cable env, 20 classifier steps
     with the loss falling, the wrapper at threshold 0.75 over 20 expert
     demo streams, the loop warmed up past its threshold and 3 timed chunks
     of 10: env-steps/s, updates/s, the busy share and device ms by kernel;
     a wrapped step renders twice and runs the classifier; the wrapper's
     reward equal to classifier_fn's verdict on the stepped frames, env by
     env; the classifier saved on the card and loaded on the CPU by
     load_classifier_func: params bit for bit, logits within 4 x what bf16
     convolutions change on the CPU), examples/vice_online.py at full width
     (create_vice, the loop past its threshold and a chunk of 10 with VICE
     rewards, 4 update_vice calls, the last under
     torch.cuda.set_sync_debug_mode("error"), the double backward on the
     card; the vice head moves, its encoders do not; bce_loss and grad_norm
     finite; a 16-episode evaluation) and record_demo.py -> bc_policy.py
     (20 expert demos of the pick env, 500 BC steps with the NLL falling,
     evaluate_batched over 32 episodes; no K5 launch: the BC MLP has no
     LayerNorm); the fwbw paths: examples/fused_fwbw_bin_relocation.py at
     full width (32 chained envs, two learners at batch 256 x UTD 4, the
     docstring's recipe): from states (16 demo streams of 100 of the
     recipe's 600 chained-expert steps, the loop until both learners'
     gates open, 3 timed chunks of 10, one evaluate_chained_env of 32
     chains, where an iteration's time goes, the busy share), --pixels (3
     chunks of 5) and --classifier_reward (the classifiers' frames, 20 of
     800 steps, 1 chunk); a chained env step launches K1 six times, an
     updating learner K4 twice; both learners' steps under
     torch.cuda.set_sync_debug_mode("error"). Around each path
     every launch count is read and checked against the count that its loss
     functions and loop give (on the RLPD path K4's from the demo ring's
     stream count: a half takes K4 only when it divides over its ring's
     streams); outputs must be finite and non-zero and the params must move;
  4. times on the card: each kernel and its plain version at its path's
     shapes (calls back to back between one pair of CUDA events, and the
     kernel's device time from torch.profiler; K4's pixel gather also with
     L2 flushed before each call) beside its bound (K1 also beside its
     critical path and ptxas's registers and spills, and with and without
     the bin walls at N = 32 and 2048; K2 beside its
     operations per pixel, per (env, camera) and per env, the unhoisted
     count, and the device time of both -fmad builds), K5 also
     beside the torch sequence it replaced (Dense, bias, tanh(layer_norm),
     and that sequence's autograd backward), per call and on the device, where an
     actor step's, a state learner iteration's and a pixel iteration's time
     go, the learner steps run under torch.cuda.set_sync_debug_mode("error"),
     sample_mixed against sample (per call, device time, K4's share), an RLPD
     iteration's host-clock time, and the device busy share of the loops
     (torch.profiler). A trace that
     records no device time for a kernel it times, or a loop's window in
     which a kernel of that path has none, fails the phase.
It prints the kernel table as one JSON line, then the card's name and power
limit, and last {"ok": true, "device": {...}}. It needs one CUDA card and the
repository around it (serl_tpu_torch/, tests/torch_k1.py, tests/torch_k2.py,
tests/torch_k5.py, tests/torch_resnet.py, resnet10_params.pkl); it never
imports JAX or serl_tpu.
"""

import copy
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores, dense TF32 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12
BOUND_N = (128, 2048)
K1_ODD_N = 101  # not a multiple of K1's envs per block (control_step.cu)
K1_RLPD_N = (30, 32)  # the RLPD path's demo collection and its loop and evaluation
MAIN_ENVS = 128
# bench.py::bench_state's configuration, passed to make_state_sim_experiment
BENCH_STATE = dict(seed=0, num_envs=128, updates_per_iter=1, utd_ratio=8, training_starts=1000,
                   random_steps=1000, buffer_capacity=100_000)
CHUNK = 50  # loop iterations per timed chunk, as bench_state
K4_SHAPE = dict(slots=782, streams=128, rows_per_stream=16)  # 100,096 rows, batch 2048
# the RLPD path's online half: 200,000 rows over 32 streams, 1,024 of a 2,048-row batch
K4_RLPD_SHAPE = dict(slots=6250, streams=32, rows_per_stream=32)
K4_PIXEL_SHAPE = dict(slots=625, streams=16, rows_per_stream=64)  # 10,000 rows, batch 1024
# the pixel rings K4 gathers from: bench_pixels' (small encoder and ResNet),
# the pixel RLPD path's online half (50,000 rows over 16 streams, 512 of a
# 1,024-row batch), and that half on bench_pixels' ring
K4_PIXEL_SHAPES = (K4_PIXEL_SHAPE, dict(slots=3125, streams=16, rows_per_stream=32),
                   dict(slots=625, streams=16, rows_per_stream=32))
# the pose tasks' pixel rings (10-dim state, 7-dim actions): 20,000 rows over
# 16 streams, sampled 512 rows (sample_mixed's online half on the peg and
# cable-route paths) and 80 (VICE's classifier batches)
K4_POSE_PIXEL_SHAPES = (dict(slots=1250, streams=16, rows_per_stream=32),
                        dict(slots=1250, streams=16, rows_per_stream=5))
# bench.py::bench_pixels' configuration, passed to make_drq_sim_experiment
BENCH_PIXELS = dict(seed=0, encoder_type="small", num_envs=16, batch_size=256, utd_ratio=4,
                    updates_per_iter=2, training_starts=0, random_steps=0,
                    buffer_capacity=10_000)
PIXEL_CHUNK = 25  # loop iterations per timed chunk, as bench_pixels
PIXEL_SIZE = 128
IMAGE_KEYS = ("front", "wrist")
K2_N = (16, 128)
K2_KERNELS = ("render_scene_kernel", "render_pixels_kernel")  # a render launches both
# The RLPD path: examples/fused_sac_state_sim.py --rlpd at the state_sim
# preset (32 envs, batch 256 x UTD 8, 4 update_high_utd calls per
# iteration, 10 critics subsampled to 2, buffer 200,000) with the scripted
# expert's demos mixed 50/50: overrides of WorkloadConfig.preset("state_sim")
RLPD_PRESET = dict(demo_fraction=0.5)
RLPD_DEMO_MIN_SUCCESS = 15  # fewer successful expert episodes fail the phase
RLPD_CHUNK, RLPD_CHUNKS, RLPD_EVAL_EPISODES = 10, 3, 32
# The pixel RLPD path: examples/fused_drq_sim.py --rlpd at the drq_rlpd
# preset (16 envs, two 128 px cameras, small encoders, batch 256 x UTD 4, 2
# update_high_utd calls per iteration, buffer 50,000) with 30 scripted pixel
# demos (20 kept): overrides of WorkloadConfig.preset("drq_rlpd")
PIXEL_RLPD_PRESET = dict(demo_fraction=0.5)
PIXEL_RLPD_CHUNK, PIXEL_RLPD_CHUNKS = 5, 2
# bench.py::bench_pixels("resnet-pretrained"): the frozen ResNet-10 from
# resnet10_params.pkl, timed in chunks of RESNET_CHUNK (bench.py's 25 cut to
# 10 to keep the whole run short); RESNET_FRAMES frames for the feature check
BENCH_RESNET = dict(BENCH_PIXELS, encoder_type="resnet-pretrained")
RESNET_CHUNK = 10
RESNET_FRAMES = 32
# the trained "resnet" encoder's update_high_utd calls on the ResNet path's ring
RESNET_TRAINED_UPDATES = 3
# The pose-task paths. PCB from states: examples/fused_pcb_insert.py with
# PCB_ARGV (the BC term, cosine learning rates, the demo reset bank), run_fused
# in POSE_CHUNKS chunks of POSE_CHUNK iterations (evaluations every
# POSE_EVAL_PERIOD chunks), paused after POSE_PAUSE_AT and resumed; peg from
# pixels: examples/fused_peg_insert.py --pixels, timed in chunks of
# PEG_PIXEL_CHUNK. Their demo rings have POSE_DEMO_STREAMS streams; K1 is held
# at pose-task inputs at POSE_K1_N envs (the loop's 16, and 2,048, whose
# N // 100 budget covers the rare mat_to_quat sign flip at the tasks' roll of
# pi: 2 of 2,048 envs in a CPU rehearsal with K1's host build).
PCB_ARGV = ["--bc_weight", "0.1", "--lr_decay", "--demo_reset_prob", "0.2"]
POSE_CHUNK, POSE_CHUNKS, POSE_PAUSE_AT, POSE_EVAL_PERIOD = 16, 6, 4, 3
POSE_DEMO_STREAMS, POSE_DEMO_MIN_SUCCESS = 20, 20
POSE_K1_N = (16, 2048)
# The fwbw path (examples/fused_fwbw_bin_relocation.py): K1 with the bin
# walls held at FWBW_K1_N envs (the loop's 32 chained envs, and 2,048), and
# beside the build with its obstacle code compiled out
FWBW_K1_N = (32, 2048)
K1_NO_OBSTACLES = ("-DSERL_NO_OBSTACLES",)
# the fwbw phases: the recipe of the example's docstring (FWBW_ARGV), its
# demos cut to FWBW_DEMO_STEPS of 600 steps a stream; timed chunks
# (FWBW_CHUNK(S) from states, FWBW_PIXEL_CHUNK(S) from pixels; one chunk
# with the classifiers after FWBW_CLASSIFIER_EPOCHS of the recipe's 800
# steps); the pixel and classifier phases start training at the batch's
# 1,024 rows (FWBW_CUT_ARGV) instead of 2,000; one evaluation of
# FWBW_EVAL_CHAINS chains from states
FWBW_ARGV = ["--bc_weight", "0.3", "--discount", "0.98", "--intervention_mode", "rescue",
             "--intervention_prob", "0.02", "--intervention_decay_steps", "1500000",
             "--intervention_min_prob", "0.008", "--fresh_reset_prob", "0.1"]
FWBW_CUT_ARGV = ["--training_starts", "1024", "--random_steps", "1024"]
FWBW_DEMO_STEPS = 100
FWBW_CHUNK, FWBW_CHUNKS, FWBW_PIXEL_CHUNK, FWBW_PIXEL_CHUNKS = 10, 3, 5, 3
FWBW_CLASSIFIER_EPOCHS, FWBW_EVAL_CHAINS, FWBW_MAX_WARMUP = 20, 32, 400
FWBW_NOISE_LEVELS = (0.05, 0.2, 0.4, 0.8)  # the classifier frames' (the example's)
# the routed rings: (slots, streams, rows) of the state ring's and the pixel
# ring's online halves
FWBW_K4_STATE = (6250, 32, 512)
FWBW_K4_PIXEL = (625, 32, 512)
# the demo rings: 600 slots (--demo_steps) x 16 streams, the 512-row demo half
FWBW_K4_DEMO = (600, 16, 512)
# K2 held at the 32 chained envs, after a reset and FWBW_K2_STEPS expert steps
FWBW_K2_N = 32
FWBW_K2_STEPS = (15, 40, 80)
# K5 forwards of the pixel learner's Q-filtered BC term, per update_high_utd
FWBW_PIXEL_BC_FWD = 5
PEG_PIXEL_ARGV = ["--pixels"]
PEG_PIXEL_CHUNK = 10
# The learned-reward paths. Cable route (examples/fused_cable_route.py at its
# defaults): LEARNED_REWARD_EPOCHS classifier steps (the recipe's 300 cut to
# keep the run short), timed chunks of LEARNED_REWARD_CHUNK; VICE
# (examples/vice_online.py): a chunk of LEARNED_REWARD_CHUNK, then
# VICE_UPDATES update_vice calls; BC: BC_STEPS steps. K1 and K2 are held at
# the cable env's inputs at LEARNED_REWARD_N envs: the classifier frames' 8
# streams, the loop's 16 envs, the 20 demo streams. The classifier saved on
# the card and loaded on the CPU may differ from the card's logits by
# CLASSIFIER_FILE_FACTOR x what bf16 convolutions change there (fp32 vs bf16
# on the CPU), as tests/torch_resnet.py's rule holds TF32.
LEARNED_REWARD_EPOCHS, LEARNED_REWARD_CHUNK, VICE_UPDATES, BC_STEPS = 20, 10, 4, 500
LEARNED_REWARD_N = (8, 16, 20)
CABLE_ARGV, VICE_ARGV = [], []  # the examples' defaults: full width
CLASSIFIER_FILE_FACTOR = 4.0
# K2's two builds, the shipped one (nvcc's default flags) first: (label,
# extra nvcc flags)
K2_BUILDS = (("-fmad=true", None), ("-fmad=false", ("-fmad=false",)))
K3_SHAPES = ((1024, 1, PIXEL_SIZE, PIXEL_SIZE, 3), (1024, 3, PIXEL_SIZE, PIXEL_SIZE, 3))
# K3's other copy paths: (shape, dtype, base bytes past 16-byte alignment,
# images per launch, the unit the kernel must take)
K3_PATHS = (
    ((1024, 1, PIXEL_SIZE, PIXEL_SIZE, 3), "uint8", 4, 2, 4),  # frames 4 bytes off: words
    ((1024, 1, 84, 84, 3), "uint8", 0, 2, 4),                  # 252-byte rows: words
    ((256, 1, 33, 33, 1), "uint8", 0, 2, 1),                   # 33-byte rows: bytes
    ((256, 1, PIXEL_SIZE, PIXEL_SIZE, 3), "float32", 0, 2, 16),  # float frames
    # the classifier's 64 + 64 frames (one image a launch) and VICE's crop of
    # both cameras' 128 next observations
    ((128, 1, PIXEL_SIZE, PIXEL_SIZE, 3), "uint8", 0, 1, 16),
    ((128, 1, PIXEL_SIZE, PIXEL_SIZE, 3), "uint8", 0, 2, 16),
)
# K5's calls on the main paths, (form, E, M, K, D) -> (whether that call's
# backward computes the weight grads, dgamma, dbeta, dbias and dW: not in
# the actor loss's pass through the critic's constants; whether it needs
# dx: not where x is an observation or a replayed action). Forms: "shared",
# one x through the E members of the ensemble's first layer; "member", an x
# per member; "linear", one nn.Linear weight.
K5_SHAPES = {
    ("shared", 10, 256, 14, 256): (True, False),   # state critic, layer 1 (obs 10 + action 4)
    ("member", 10, 256, 256, 256): (True, True),   # critic, layer 2
    ("shared", 10, 2048, 14, 256): (False, True),  # the actor update's pass through the critic
    ("member", 10, 2048, 256, 256): (False, True),
    ("linear", 1, 2048, 10, 256): (True, False),   # state policy, layer 1, actor update
    ("linear", 1, 2048, 256, 256): (True, True),   # policy, layer 2
    ("linear", 1, 256, 10, 256): (True, False),    # state policy, layer 1: next actions
    # the state policy acting on 128 envs and evaluating 128 episodes
    ("linear", 1, 128, 10, 256): (True, False),
    ("linear", 1, 128, 256, 256): (True, True),
    ("shared", 10, 256, 580, 256): (True, True),   # pixel critic, layer 1 (2 x 256 + 64 + 4)
    ("linear", 1, 256, 7, 64): (True, False),      # pixel proprio Dense
    ("linear", 1, 256, 256, 256): (True, True),    # pixel bottleneck, per camera; policy 2
    ("linear", 1, 256, 576, 256): (True, False),   # pixel policy, layer 1: next actions
    # the pixel actor update (1,024 rows): the policy, the encoder's
    # bottleneck and proprio (forward only there), the pass through the critic
    ("linear", 1, 1024, 576, 256): (True, False),
    ("linear", 1, 1024, 256, 256): (True, True),
    ("linear", 1, 1024, 7, 64): (True, False),
    ("shared", 10, 1024, 580, 256): (False, True),
    ("member", 10, 1024, 256, 256): (False, True),
    # pixel acting on 16 envs (and evaluating 16 episodes), the pixel RLPD
    # path's 32-episode evaluations: forward only
    ("linear", 1, 16, 576, 256): (True, False),
    ("linear", 1, 16, 256, 256): (True, True),
    ("linear", 1, 16, 7, 64): (True, False),
    ("linear", 1, 32, 576, 256): (True, False),
    ("linear", 1, 32, 7, 64): (True, False),
    # the RLPD path's policy acting on 32 envs and evaluating 32 episodes:
    # forward only there; the backward is held and timed as an update's
    ("linear", 1, 32, 10, 256): (True, False),
    ("linear", 1, 32, 256, 256): (True, True),
    # the ResNet heads' bottleneck over the learned spatial embeddings
    # (512 channels x 8): a critic minibatch (it trains, and the embeddings'
    # kernel below it needs dx), the actor update's batch and acting on 16
    # envs (forward only there; the backward is held and timed as an update's)
    ("linear", 1, 256, 4096, 256): (True, True),
    ("linear", 1, 1024, 4096, 256): (True, True),
    ("linear", 1, 16, 4096, 256): (True, True),
    # the pose tasks from states (13-dim observations, 7-dim actions): the
    # critic's first layer on a minibatch and in the actor update's pass
    # (the BC term's pass too), the policy's first layer on next actions,
    # the actor update, acting on 16 envs and evaluating 32 episodes
    ("shared", 10, 256, 20, 256): (True, False),
    ("shared", 10, 1024, 20, 256): (False, True),
    ("linear", 1, 256, 13, 256): (True, False),
    ("linear", 1, 1024, 13, 256): (True, False),
    ("linear", 1, 16, 13, 256): (True, False),
    ("linear", 1, 32, 13, 256): (True, False),
    # peg from pixels: the critic's first layer (2 x 256 + 64 + 7 = 583, an
    # odd K: the 4-byte copy path), the 10-dim proprio Dense
    ("shared", 10, 256, 583, 256): (True, True),
    ("shared", 10, 1024, 583, 256): (False, True),
    ("linear", 1, 256, 10, 64): (True, False),
    ("linear", 1, 1024, 10, 64): (True, False),
    ("linear", 1, 16, 10, 64): (True, False),
    # the reward classifier's bottleneck on the 20 demo streams' stepped frames
    # (its train step's 128 rows and the loop's 16 envs are held above)
    ("linear", 1, 20, 256, 256): (True, True),
    # the fwbw pixel policies' proprio Dense acting on the 32 chained envs
    # (their other layers, and the classifiers' bottleneck there, are held above)
    ("linear", 1, 32, 10, 64): (True, False),
}
K5_MAIN = ("member", 10, 256, 256, 256)  # the shape of most K5 launches: the critic updates
# K5's float operations per output element outside the product, counted in
# its kernels' code (the per-row divisions and square root left out):
# forward 15 (bias 1, mean sum 1, variance 3, centre, scale and shift 4,
# tanh by exp 6); backward 14 (g 3, x_hat 2, g*gamma 1, the two row sums 3,
# dh 5), plus 4 for the weight grads' column sums. The product itself is
# 2 * K per element, three times over in 3xTF32 on the tensor cores.
K5_OPS_PER_ELEMENT = {"fwd": 15, "bwd": 14, "bwd_weight_grads": 4}

# Launches per learner-loop iteration, from the loss functions
# (serl_tpu_torch/agents/sac.py). The policy MLP and the critic EnsembleMLP
# each run 2 Dense+LayerNorm+tanh (K5) layers per forward pass.
#   critic update (x utd_ratio): next actions from the policy (2 fwd, no
#     grad), the target critic (2 fwd, no grad), the critic (2 fwd) and its
#     backward (2 bwd): 6 fwd, 2 bwd;
#   actor+temperature update: the policy (2 fwd) and the critic on detached
#     params (2 fwd), backward through both (4 bwd, the critic's without
#     weight grads); the temperature loss's next actions (2 fwd, no grad):
#     6 fwd, 4 bwd;
#   acting: one policy sample (2 fwd), all iterations being past random_steps.
# One sample (1 K4 launch) and one control step (1 K1 launch) per iteration.
def learner_launches_per_iter(utd_ratio: int, updates_per_iter: int = 1) -> dict:
    return {"control_step": 1, "render": 0, "random_crop": 0,
            "replay_gather": updates_per_iter,
            "dense_layer_norm_tanh_fwd": updates_per_iter * (6 * utd_ratio + 6) + 2,
            "dense_layer_norm_tanh_bwd": updates_per_iter * (2 * utd_ratio + 4)}


# The actor path (phase 3): 20 control steps + 100 evaluate steps of K1; 2
# K5 forwards per policy call: 12 policy iterations + 100 evaluate steps.
ACTOR_LAUNCHES = {"control_step": 120, "render": 0, "random_crop": 0, "replay_gather": 0,
                  "dense_layer_norm_tanh_fwd": 2 * (12 + 100), "dense_layer_norm_tanh_bwd": 0}


# Launches per pixel-loop iteration (DrQ, serl_tpu_torch/agents/{drq,sac}.py).
# An ObsEncoder pass runs 3 K5 forwards: one bottleneck Dense+LayerNorm+tanh
# per camera and the proprio's; a policy or critic MLP pass runs 2.
#   critic update (x utd_ratio): next actions (encode 3 + policy 2, no
#     grad), the target critic on next_obs (target encoder 3 + critic 2, no
#     grad), the critic on obs (encoder 3 + critic 2) and its backward
#     through the critic (2) and the encoder (3), all with weight grads:
#     15 fwd, 5 bwd;
#   actor+temperature update: the policy (encode 3 under no_grad + policy 2),
#     the critic on detached params (encode 3 + critic 2), backward through
#     the critic (2, no weight grads) and the policy (2, weight grads); the
#     temperature loss's next actions (encode 3 + policy 2): 15 fwd, 4 bwd;
#   acting: one policy sample (encode 3 + policy 2), random_steps being 0.
# Per update_high_utd one sample (K4) and one crop launch (K3: obs and
# next_obs of both cameras); per iteration one control step (K1) and one
# render (K2: the post-reset observation; the terminal one is not rendered,
# as the pixel buffer does not store next observations), which launches two
# kernels: the scene, then the pixels.
def pixel_launches_per_iter(utd_ratio: int, updates_per_iter: int) -> dict:
    return {"control_step": 1, "render": 2, "random_crop": updates_per_iter,
            "replay_gather": updates_per_iter,
            "dense_layer_norm_tanh_fwd": updates_per_iter * (15 * utd_ratio + 15) + 5,
            "dense_layer_norm_tanh_bwd": updates_per_iter * (5 * utd_ratio + 4)}


def rlpd_launches_per_update(config, demo_streams: int) -> dict:
    """Launches per updating RLPD iteration: the state learner's, with
    sample_mixed's two halves in place of one sample. A half takes K4 only
    when its rows divide over its ring's streams (the JAX package's
    `sample`); otherwise it is the plain unaligned gather, no kernel."""
    rows = config.batch_size * config.utd_ratio
    half = rows // 2
    per_sample = int(half % config.num_envs == 0) + int((rows - half) % demo_streams == 0)
    per_iter = learner_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    return {**per_iter, "replay_gather": config.updates_per_iter * per_sample}


def rlpd_launches(config, demo_streams: int, warmup: int, iters: int, evals: int,
                  demo_steps: int = 100, eval_steps: int = 100) -> dict:
    """Launches over the RLPD path: the expert's demo collection (K1 only),
    `warmup` iterations of which the last is the first to update, `iters`
    updating iterations, and `evals` argmax evaluations (K1 and 2 K5
    forwards a step). Iterations before random_steps act at random, the
    others sample the policy (2 K5 forwards)."""
    per_update = rlpd_launches_per_update(config, demo_streams)
    updating = 1 + iters
    random_iters = -(-config.random_steps // config.num_envs)
    policy_steps = warmup + iters - random_iters + evals * eval_steps
    train = {k: v * updating for k, v in per_update.items()}
    return {**train,
            "control_step": demo_steps + warmup + iters + evals * eval_steps,
            "dense_layer_norm_tanh_fwd": train["dense_layer_norm_tanh_fwd"] - 2 * updating
            + 2 * policy_steps}


def pixel_rlpd_launches(config, demo_streams: int, warmup: int, iters: int, evals: int,
                        demo_steps: int = 100, eval_steps: int = 100) -> dict:
    """Launches over the pixel RLPD path: the expert's pixel demos (a reset
    render, then K1 and a render a step), the loop's reset render, `warmup`
    iterations of which the last is the first to update, `iters` updating
    iterations, and `evals` argmax evaluations (a reset render, then K1, a
    render and a policy pass of 5 K5 forwards a step). A render call
    launches two kernels; an updating iteration is the pixel path's, with
    sample_mixed's halves in place of one sample (K4 for a half that divides
    over its ring's streams); iterations before random_steps act at random."""
    per_update = pixel_rlpd_launches_per_update(config, demo_streams)
    updating = 1 + iters
    random_iters = -(-config.random_steps // config.num_envs)
    policy_steps = warmup + iters - random_iters + evals * eval_steps
    return {"control_step": demo_steps + warmup + iters + evals * eval_steps,
            "render": 2 * (1 + demo_steps) + 2 + 2 * (warmup + iters)
            + evals * 2 * (1 + eval_steps),
            "random_crop": updating * per_update["random_crop"],
            "replay_gather": updating * per_update["replay_gather"],
            "dense_layer_norm_tanh_fwd": updating * (per_update["dense_layer_norm_tanh_fwd"] - 5)
            + 5 * policy_steps,
            "dense_layer_norm_tanh_bwd": updating * per_update["dense_layer_norm_tanh_bwd"]}


def pixel_rlpd_launches_per_update(config, demo_streams: int) -> dict:
    """Launches per updating pixel RLPD iteration: the pixel path's, with
    sample_mixed's halves in place of one sample."""
    rows = config.batch_size * config.utd_ratio
    half = rows // 2
    per_sample = int(half % config.num_envs == 0) + int((rows - half) % demo_streams == 0)
    per_iter = pixel_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    return {**per_iter, "replay_gather": config.updates_per_iter * per_sample}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_checks(name: str = "torch_k1"):
    """tests/<name>.py (torch_k1 or torch_k2), loaded by its path (a package
    named `tests` that is installed elsewhere must not shadow it)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fmt(d: dict) -> str:
    return json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})


# ---------------------------------------------------------------- measuring


def per_call_ms(fn, calls: int, repeats: int = 5) -> float:
    """Time per call of fn: `calls` calls back to back between one pair of
    CUDA events, after one warm-up call; the median over `repeats`. The host
    queues K1's launches faster than the card runs them, so for K1 this is
    device time; for the plain version it is what a call costs in all."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def profiled_kernel_ms(fn, calls: int, kernels):
    """Device time per call of fn spent in kernels whose names contain one
    of `kernels` ("" for every kernel), from a torch.profiler trace of
    `calls` calls; raises when three traces record no device time for them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    for _ in range(3):  # a trace now and then records no device time: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and any(k in e.key for k in kernels)]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            return total_us / 1e3 / calls
    raise AssertionError(f"torch.profiler recorded no device time for kernels {kernels}")


def busy_share(torch, run, iters: int):
    """(wall ms unprofiled, device busy ms, {kernel name: ms}, {host op name:
    device ms of the kernels it launched}) of `run(iters)`: kernel time from
    a torch.profiler trace of the same number of iterations that a host
    clock times unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(iters)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(iters)
        torch.cuda.synchronize()
    events = prof.key_averages()
    by_name = {e.key: e.self_device_time_total / 1e3 for e in events
               if e.device_type == DeviceType.CUDA}
    by_op = {e.key: getattr(e, "device_time_total", 0.0) / 1e3 for e in events
             if e.device_type == DeviceType.CPU and e.key.startswith("aten::")}
    return wall_ms, sum(by_name.values()), by_name, by_op


def bound(bytes_moved: float, ops: float, tf32_ops: float = 0.0):
    """(bound ms, what bounds it) on an H100 SXM at its data-sheet rates:
    `ops` fp32 operations on the CUDA cores, `tf32_ops` on the tensor cores
    (the two units may overlap, so the larger of their times counts)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_FP32_OPS_PER_S, tf32_ops / PEAK_TF32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def launch_counters():
    """Every kernel wrapper of the port, by the kernel's name in the counts;
    each counts its launches in `.launches`."""
    from serl_tpu_torch.data import replay_buffer
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    from serl_tpu_torch.vision import augmentations

    return {"control_step": engine.control_step,
            "render": rendering.render_cameras,
            "random_crop": augmentations.crop_images,
            "replay_gather": replay_buffer.gather_batch_aligned,
            "dense_layer_norm_tanh_fwd": k5.dense_layer_norm_tanh_forward,
            "dense_layer_norm_tanh_bwd": k5.dense_layer_norm_tanh_backward}


def reset_launches() -> None:
    """Every count to 0, and K5's calls logged from here (check_k5_shapes)."""
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    for wrapper in launch_counters().values():
        wrapper.launches = 0
    k5.shape_log = set()


def read_launches() -> dict:
    """The counts since reset_launches; K5's calls since then must all be
    at shapes that phase 2 held (check_k5_shapes)."""
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    counts = {name: wrapper.launches for name, wrapper in launch_counters().items()}
    log, k5.shape_log = k5.shape_log, None
    if log is not None:
        check_k5_shapes(log)
    return counts


def check_k5_shapes(log) -> None:
    """Fails unless every (form, E, M, K, D) that K5 ran at since
    reset_launches is one of K5_SHAPES, where phase 2 held the kernels
    against their plain versions (both directions) and phase 4 timed them."""
    calls = sorted(s for s in log if len(s) == 5)
    backward = sorted(s for s in log if len(s) == 7)
    missing = sorted({s[:5] for s in log} - set(K5_SHAPES))
    print(f"K5 on this path: forward at {[k5_label(s) for s in calls]}; backward (weight grads, "
          f"dx) at {[f'{k5_label(s[:5])} {s[5:]}' for s in backward]}; "
          + ("every shape held in phase 2" if not missing else f"NOT held: {missing}"))
    if missing:
        raise AssertionError(f"K5 ran at shapes that K5_SHAPES does not hold: {missing}")


# ---------------------------------------------------------------- phases


def phase_kernel_vs_plain(torch, engine, checks, device):
    g = torch.Generator(device=device).manual_seed(0)
    main_path_err = 0.0
    for n in BOUND_N + (K1_ODD_N,):
        for source, make in (("rollout", checks.rollout_states), ("grasp", checks.grasp_states)):
            s = make(n, g, device)
            floor, pad = engine.active_contacts(s)
            n_floor, n_pad = int(floor.sum()), int(pad.sum())
            failures, summary, _ = checks.compare_step(engine.control_step_cuda, s)
            # two more launches on the same input; at N = 2048 also the first
            # K1_ODD_N envs alone (a partial block), at N = 128 the first
            # K1_RLPD_N envs alone, against the same envs' outputs of the
            # whole launch (which the plain version judged)
            first, second = engine.control_step_cuda(s), engine.control_step_cuda(s)
            repeats = all(torch.equal(a, b) for a, b in zip(first, second))
            parts = {BOUND_N[-1]: (K1_ODD_N,), MAIN_ENVS: K1_RLPD_N}.get(n, ())
            for m in parts:
                part = engine.control_step_cuda(type(s)(*(x[:m] for x in s)))
                repeats = repeats and all(torch.equal(a, b[:m]) for a, b in zip(part, first))
            print(f"K1 vs plain, N={n}, {source} states: active floor corners {n_floor}, "
                  f"active pad points {n_pad}; max abs err {fmt(summary['max_err'])}; envs "
                  f"beyond the tight tolerance {summary['envs_over_atol']} (at most "
                  f"{summary['budget']}); two more launches on the same input"
                  + "".join(f" and a launch on its first {m} envs" for m in parts)
                  + f" equal bit for bit: {repeats}")
            if failures:
                raise AssertionError(f"N={n} {source}: " + "; ".join(failures))
            if not repeats:
                raise AssertionError(f"N={n} {source}: K1 launches on one input differ")
            if n == MAIN_ENVS:
                main_path_err = max(main_path_err, max(summary["max_err"].values()))
            if source == "rollout" and n_floor == 0:
                raise AssertionError(f"no active floor contact in the N={n} rollout states")
            if source == "grasp" and n_pad == 0:
                raise AssertionError(f"no active pad contact in the N={n} grasp states")
    print("K1 vs plain: env e's field f may differ by min(STEP_ATOL[f] + 3 x spread[e, f], "
          "STEP_CAP[f]) (spread: plain float32 vs float64 on the same state); at most N // 100 "
          f"envs may exceed STEP_ATOL; STEP_ATOL {fmt(checks.STEP_ATOL)}; STEP_CAP "
          f"{fmt(checks.STEP_CAP)}")

    # 100-step kernel-vs-plain rollout with the same random actions, beside a
    # float64 plain rollout that measures float32 rounding's own drift
    n = MAIN_ENVS
    sk = sp = checks.reset_states(n, g, device)
    s64 = checks.to_f64(sp)
    drift = {f: torch.zeros(n, dtype=torch.float64, device=device) for f in checks.DRIFT_ATOL}
    spread = {f: torch.zeros_like(v) for f, v in drift.items()}

    def track(acc, a, b):
        errs = checks.per_env_errors(a, b)
        errs["tcp_pos"] = (engine.observe(a)[0].double()
                           - engine.observe(b)[0].double()).abs().amax(1)
        for f in acc:
            acc[f] = torch.maximum(acc[f], errs[f])

    for _ in range(100):
        a = 2.0 * torch.rand((n, 4), generator=g, device=device) - 1.0
        sk = engine.control_step_cuda(checks.apply_action(sk, a))
        sp = engine.control_step_plain(checks.apply_action(sp, a))
        s64 = engine.control_step_plain(checks.apply_action(s64, a.double()))
        track(drift, sk, sp)
        track(spread, sp, s64)
    failures, summary = checks.judge(drift, spread, checks.DRIFT_ATOL, checks.DRIFT_CAP)
    print(f"K1 vs plain, 100-step rollout at N={n}: max drift {fmt(summary['max_err'])}; plain "
          f"float32-vs-float64 drift {fmt({f: float(v.max()) for f, v in spread.items()})}; envs "
          f"beyond DRIFT_ATOL {fmt(checks.DRIFT_ATOL)}: {summary['envs_over_atol']} (at most "
          f"{summary['budget']}); DRIFT_CAP {fmt(checks.DRIFT_CAP)}")
    if failures:
        raise AssertionError("100-step rollout: " + "; ".join(failures))
    return main_path_err


def phase_k4_vs_plain(torch, device):
    """K4 against its plain version at the state paths' shapes: the learner
    path's (K4_SHAPE) and the RLPD path's online half (K4_RLPD_SHAPE)."""
    g = torch.Generator(device=device).manual_seed(4)
    return max(_k4_state_vs_plain(torch, device, g, **shape)
               for shape in (K4_SHAPE, K4_RLPD_SHAPE))


def _k4_state_vs_plain(torch, device, g, slots, streams, rows_per_stream):
    """K4 against its plain version on a full ring that has wrapped (cursor
    mid-ring), 100-step episodes that end at another slot in every stream,
    next_observations stored and not."""
    from serl_tpu_torch.data import replay_buffer as rbm

    r = rows_per_stream
    data = {k: torch.randn((slots, streams) + shape, generator=g, device=device)
            for k, shape in (("observations", (10,)), ("actions", (4,)),
                             ("next_observations", (10,)), ("rewards", ()), ("masks", ()),
                             ("dones", ()))}
    insert_slot = 300  # slot 299 is the newest, 300 the oldest
    age = (torch.arange(slots, device=device) - insert_slot) % slots
    stream = torch.arange(streams, device=device)
    ep_id = (((age[:, None] + 7 * stream[None, :]) // 100) * streams + stream[None, :]).to(torch.int32)
    err, boundary_rows = 0.0, 0
    for store_next_obs in (True, False):
        fields = data if store_next_obs else {k: v for k, v in data.items()
                                              if k != "next_observations"}
        n_valid = slots if store_next_obs else slots - 1
        u = torch.randint(0, n_valid, (r, streams), generator=g, device=device)
        s2 = (insert_slot - slots + u) % slots
        s2[0] = (insert_slot - 1 - int(not store_next_obs)) % slots  # the ring's seam
        got = rbm.gather_batch_aligned_cuda(fields, ep_id, s2, store_next_obs)
        want = rbm.gather_batch_aligned_plain(fields, ep_id, s2, store_next_obs)
        torch.cuda.synchronize()
        for k in want:
            if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
                raise AssertionError(f"K4 differs from plain in {k} (store_next_obs="
                                     f"{store_next_obs})")
            err = max(err, float((got[k] - want[k]).abs().max()))
        if not store_next_obs:
            nxt = (s2 + 1) % slots
            boundary_rows = int((ep_id[nxt, stream] != ep_id[s2, stream]).sum())
    if boundary_rows == 0:
        raise AssertionError("K4 check sampled no episode-boundary row")
    print(f"K4 vs plain at {slots} slots x {streams} streams, {r * streams} rows, next_obs "
          f"stored and not ({boundary_rows} rows at an episode boundary): exactly equal")
    return err


def k5_label(shape) -> str:
    form, e, m, k, d = shape
    return f"{form} (E, M, K, D) = ({e}, {m}, {k}, {d})"


def phase_k5_vs_plain(torch, k5_checks, device):
    """K5 forward and backward against the plain versions at K5_SHAPES, under
    the rule of tests/torch_k5.py: the forward that stores what autograd
    needs and the one that does not; the backward with and without weight
    grads, its dgamma, dbeta and dbias repeating bit for bit."""
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    g = torch.Generator(device=device).manual_seed(5)
    worst = {}
    for shape in K5_SHAPES:
        form, e, m, k, d = shape
        x, kernel, bias, gamma, beta, dy = k5_checks.inputs(form, e, m, k, d, g, device)
        x3, w3, b2, _ = k5.member_views(x, kernel, bias, form == "member")
        out = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True)
        y_only = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta)
        py, ph, pmean, prstd = k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta)
        grads = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma)
        again = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma)
        dh_only = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma,
                                                    need_weight_grads=False)
        torch.cuda.synchronize()
        errs, limits = k5_checks.forward_errors(x3, w3, b2, gamma, beta, *out)
        berrs, blimits = k5_checks.backward_errors(dy, py, ph, pmean, prstd, gamma, *grads)
        errs.update(berrs)
        limits.update(blimits)
        bad = k5_checks.failures(errs, limits)
        if not torch.equal(y_only[0], out[0]):
            bad.append("y of the forward without autograd differs from y with it")
        if not all(torch.equal(a, b) for a, b in zip(grads[1:], again[1:])):
            bad.append("dgamma, dbeta or dbias differ between two calls")
        if dh_only[1] is not None or not torch.equal(dh_only[0], grads[0]):
            bad.append("the backward without weight grads differs in dh or gave weight grads")
        print(f"K5 vs plain at {k5_label(shape)}: errors "
              f"{json.dumps({n: float(f'{v:.3g}') for n, v in errs.items()})} within limits "
              f"{json.dumps({n: float(f'{v:.3g}') for n, v in limits.items()})}; y without "
              "autograd, dh without weight grads: equal; dgamma, dbeta, dbias over two calls: "
              "bit for bit")
        if bad:
            raise AssertionError(f"K5 differs from plain at {k5_label(shape)}: {bad}")
        for name, v in errs.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def phase_actor_path(torch, device):
    from serl_tpu_torch.envs.panda_pick import STATE_OBS_DIM
    from serl_tpu_torch.training.launcher import make_state_sim_experiment
    from serl_tpu_torch.training.loop import evaluate

    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
        seed=0, device="cuda", num_envs=MAIN_ENVS, buffer_capacity=100_000,
        random_steps=1000, training_starts=10**9,
    )
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    carry, metrics = run_chunk(carry, 20)
    torch.cuda.synchronize()
    actor_s = time.perf_counter() - t0
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(2), num_episodes=128)
    torch.cuda.synchronize()
    launches = read_launches()

    print(f"actor path: 20 loop iterations (8 random, 12 policy) x {MAIN_ENVS} envs + "
          f"evaluate(num_episodes=128): launches {json.dumps(launches)}; actor "
          f"{20 * MAIN_ENVS / actor_s:.1f} env-steps/s (host clock, {actor_s:.3f} s); "
          f"eval {json.dumps(ev)}")
    if launches != ACTOR_LAUNCHES:
        raise AssertionError(f"expected launches {ACTOR_LAUNCHES} on the actor path, got {launches}")
    buf = carry.rb_state
    obs = buf.data["observations"][: buf.size]
    checks = {
        "buffer_size": int(metrics["buffer_size"][-1]) == 20 * MAIN_ENVS,
        "obs shape": tuple(obs.shape) == (20, MAIN_ENVS, STATE_OBS_DIM),
        "obs finite": bool(torch.isfinite(obs).all()),
        "next_obs finite": bool(torch.isfinite(buf.data["next_observations"][: buf.size]).all()),
        "rewards in [0, 1]": bool(((buf.data["rewards"][: buf.size] >= 0)
                                   & (buf.data["rewards"][: buf.size] <= 1)).all()),
        "actions in [-1, 1]": bool((buf.data["actions"][: buf.size].abs() <= 1).all()),
        "loop state finite": bool(torch.isfinite(carry.obs).all()),
        "eval finite": all(math.isfinite(v) and 0 <= v <= 100 for v in ev.values()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"actor path output checks failed: {bad}")
    return launches, env, agent, carry, run_chunk


def phase_learner_path(torch, device, card):
    """bench_state's configuration end to end, timed as bench.py's
    _bench_fused times it: best of 3 chunks of CHUNK iterations, each ending
    in a device-to-host read of a metric."""
    from serl_tpu_torch.training.launcher import make_state_sim_experiment
    from serl_tpu_torch.training.loop import evaluate

    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(device="cuda",
                                                                           **BENCH_STATE)
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(6))
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = -(-threshold // config.num_envs)  # its last iteration runs the first update
    carry, m = run_chunk(carry, warmup)
    if int(m["buffer_size"][-1]) < threshold or float(m["critic_loss"][-1]) == 0.0:
        raise AssertionError("the learner did not start at the training threshold")
    before = [p.detach().clone() for p in agent.parameters()]
    torch.cuda.synchronize()
    reset_launches()
    best, chunks = float("inf"), []
    for _ in range(3):
        t0 = time.perf_counter()
        carry, m = run_chunk(carry, CHUNK)
        float(m["reward_mean"][-1])  # waits for the chunk, as bench.py's fetch
        best = min(best, time.perf_counter() - t0)
        chunks.append(m)
    launches = read_launches()
    iters = 3 * CHUNK
    per_iter = learner_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    want = {k: v * iters for k, v in per_iter.items()}
    env_steps_s = CHUNK * config.num_envs / best
    updates_s = CHUNK * config.updates_per_iter * config.utd_ratio / best
    print(f"learner path (bench_state: {json.dumps(BENCH_STATE)}, {warmup} warm-up iterations, "
          f"then 3 chunks of {CHUNK}): best chunk {best:.4f} s (host clock ending in a sync): "
          f"{env_steps_s:.1f} env-steps/s, {updates_s:.1f} critic updates/s; launches over the "
          f"{iters} iterations {json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the learner path, got {launches}")
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(7), num_episodes=128)
    metrics = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    learner = {k: metrics[k] for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    params = list(agent.parameters())
    checks = {
        "losses finite": all(bool(torch.isfinite(v).all()) for v in learner.values()),
        "losses non-zero": all(bool((v != 0).all()) for v in learner.values()),
        "temperature > 0": bool((learner["temperature"] > 0).all()),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
        "targets finite": all(bool(torch.isfinite(p).all())
                              for p in agent.state.target_params["critic"]),
        "params moved": all(not torch.equal(p, q) for p, q in zip(params, before)),
        "eval finite": all(math.isfinite(v) and 0 <= v <= 100 for v in ev.values()),
    }
    print(f"learner path outputs: critic_loss {float(learner['critic_loss'][-1]):.5g}, "
          f"actor_loss {float(learner['actor_loss'][-1]):.5g}, temperature "
          f"{float(learner['temperature'][-1]):.5g}, entropy {float(learner['entropy'][-1]):.5g} "
          f"(last iteration); optimizer steps {agent.state.step}; eval {json.dumps(ev)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"learner path output checks failed: {bad}")
    return launches, dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best), \
        env, agent, rb, config, carry, run_chunk


def phase_times(torch, engine, checks, device, card, env, agent, carry, run_chunk):
    g = torch.Generator(device=device).manual_seed(3)
    noobs = _k1_no_obstacles_library(engine)
    rows = {}
    for n in BOUND_N:
        s = checks.rollout_states(n, g, device, steps=5)
        step = lambda: engine.control_step_cuda(s)
        ms = per_call_ms(step, calls=50)
        prof_ms = profiled_kernel_ms(step, calls=50, kernels="control_step_kernel")
        # the build with the obstacle code compiled out, in the same run
        step_free = lambda: engine.control_step_cuda(s, lib=noobs)
        free_ms = per_call_ms(step_free, calls=50)
        free_prof_ms = profiled_kernel_ms(step_free, calls=50, kernels="control_step_kernel")
        plain_ms = per_call_ms(lambda: engine.control_step_plain(s), calls=2, repeats=3)
        ops_per_env, path_per_env = checks.op_and_path_counts(s)
        ops = int(ops_per_env.sum())
        bytes_moved = 2 * sum(x.numel() * 4 for x in s) + engine.kernel_constants().nbytes
        bound_ms, bound_by = bound(bytes_moved, ops)
        rows[n] = dict(ms=ms, profiler_ms=prof_ms, plain_ms=plain_ms, ops=ops,
                       bytes=bytes_moved, bound_ms=bound_ms, bound_by=bound_by,
                       critical_path_ops=int(path_per_env.max()),
                       no_obstacle_code_ms=free_ms, no_obstacle_code_profiler_ms=free_prof_ms)
        print(f"K1 time, N={n}: kernel {ms:.4f} ms per launch (50 back to back, CUDA events; "
              f"torch.profiler kernel time {prof_ms:.4f} ms; the build with the obstacle code "
              f"compiled out {free_ms:.4f}, device {free_prof_ms:.4f}), plain {plain_ms:.3f} "
              f"ms per control "
              f"step; bound {bound_ms:.6f} ms by {bound_by} ({ops} fp32 ops "
              f"= {ops_per_env.min()}-{ops_per_env.max()} per env, counted in the kernel's code "
              f"by tests/k1_host.cpp; {bytes_moved} bytes); critical path (per phase the most "
              f"ops of one lane, summed) {path_per_env.min()}-{path_per_env.max()} ops per env; "
              f"no single PyTorch call computes K1, so library_ms is null [{card}]")

    # where an actor step's time goes, at the main path's 128 envs (policy
    # phase); each call between its own CUDA events, so a call's host launch
    # time is included, as the loop pays it
    obs = carry.obs
    states = carry.env_states
    act = agent.sample_actions(obs, generator=carry.rng)
    parts = {
        "policy sample_actions": lambda: agent.sample_actions(obs, generator=carry.rng),
        "K1 control_step": lambda: engine.control_step_cuda(states.physics),
        "env step_auto_reset (K1 + obs, reward, reset)": lambda: env.step_auto_reset(
            states, act, generator=carry.rng),
        "obs (plain fk + pinch velocity)": lambda: env._obs(states),
        "reward (plain fk)": lambda: env._reward(states),
    }
    split = {k: per_call_ms(fn, calls=1, repeats=20) for k, fn in parts.items()}
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print(f"actor step at N={MAIN_ENVS}, ms per call (median of 20 single calls between CUDA "
          "events, host launch time included): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}) + f" [{card}]")
    print_busy_share(torch, "actor loop", run, card, ("K1", "K5"))
    return rows


def print_busy_share(torch, what: str, run, card: str, path_kernels, iters: int = 10) -> None:
    """The loop's device busy share over `iters` iterations; fails when the
    trace gives no device time to a kernel of `path_kernels` (K1 .. K5)."""
    wall_ms, busy_ms, by_name, by_op = busy_share(torch, run, iters)
    ours = {name: sum(ms for k, ms in by_name.items() if any(part in k for part in kernels))
            for name, kernels in (("K1", ("control_step_kernel",)), ("K2", K2_KERNELS),
                                  ("K3", ("random_crop_kernel",)),
                                  ("K4", ("replay_gather_kernel",)), ("K5", ("dense_ln_tanh_",)))}
    missing = [k for k in path_kernels if not ours[k] > 0]
    if not busy_ms > 0 or missing:
        raise AssertionError(f"{what}: torch.profiler recorded no device time for "
                             f"{missing or 'any kernel'} in {iters} iterations")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    print(f"{what}, {iters} iterations: wall {wall_ms:.2f} ms (host clock, unprofiled), device "
          f"busy {busy_ms:.3f} ms (torch.profiler), busy share {busy_ms / wall_ms:.4f}, idle "
          f"share {1 - busy_ms / wall_ms:.4f}; device ms of our kernels "
          f"{json.dumps({k: round(v, 4) for k, v in ours.items()})}; largest kernels "
          f"{json.dumps([(k[:60], round(v, 4)) for k, v in top])}; host ops by the device ms "
          f"of their kernels (nested ops count again) "
          f"{json.dumps([(k, round(v, 4)) for k, v in top_ops])} [{card}]")


def phase_learner_times(torch, device, card, agent, rb, config, carry, run_chunk):
    """K4 at the main path's shape, and where a learner iteration's time goes."""
    from serl_tpu_torch.data import replay_buffer as rbm

    g = torch.Generator(device=device).manual_seed(8)
    rows = {}
    # K4 on the learner's own ring (782 x 128, next_observations stored)
    buf = carry.rb_state
    batch = config.batch_size * config.utd_ratio
    s2 = (buf.insert_slot - buf.size
          + torch.randint(0, buf.size, (batch // config.num_envs, config.num_envs),
                          generator=g, device=device)) % buf.ep_id.shape[0]
    gather = lambda: rbm.gather_batch_aligned_cuda(buf.data, buf.ep_id, s2, True)
    width = sum(v[0, 0].numel() for v in buf.data.values())
    bytes_moved = 2 * batch * width * 4 + s2.numel() * 8
    bound_ms, bound_by = bound(bytes_moved, 0)
    rows["replay_gather"] = dict(
        ms=per_call_ms(gather, calls=50),
        profiler_ms=profiled_kernel_ms(gather, 50, "replay_gather_kernel"),
        plain_ms=per_call_ms(lambda: rbm.gather_batch_aligned_plain(buf.data, buf.ep_id, s2, True),
                             calls=10),
        bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, library_ms=None)

    for key, row in rows.items():
        print(f"{key} time: kernel {row['ms']:.4f} ms per call (50 back to back, CUDA events; "
              f"torch.profiler kernel time {row['profiler_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.4f} ms, library null, bound {row['bound_ms']:.6f} ms by {row['bound_by']} ({row['bytes']} "
              f"bytes) [{card}]")

    # where a learner iteration's time goes: single calls between CUDA events
    full = rb.sample(buf, batch, generator=g)
    mini = {k: v[: config.batch_size] for k, v in full.items()}
    parts = {
        "sample (K4)": lambda: rb.sample(buf, batch, generator=g),
        "critic update (1 of utd_ratio)": lambda: agent.update(
            mini, networks_to_update=frozenset({"critic"}), generator=g),
        "actor+temperature update": lambda: agent.update(
            full, networks_to_update=frozenset({"actor", "temperature"}), generator=g),
        "update_high_utd": lambda: agent.update_high_utd(full, utd_ratio=config.utd_ratio,
                                                         generator=g),
    }
    split = {k: per_call_ms(fn, calls=1, repeats=10) for k, fn in parts.items()}
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print("learner iteration, ms per call (median of 10 single calls between CUDA events, host "
          "launch time included): " + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f" [{card}]")
    # the learner's step never waits for the device: a synchronizing call
    # raises in this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        agent.update_high_utd(rb.sample(buf, batch, generator=g), utd_ratio=config.utd_ratio,
                              generator=g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sample + update_high_utd ran under torch.cuda.set_sync_debug_mode('error'): no host "
          "sync in the learner step")
    print_busy_share(torch, "learner loop", run, card, ("K1", "K4", "K5"))
    return rows


def phase_k5_times(torch, k5_checks, device, card):
    """K5 at each of K5_SHAPES: the kernels' wrappers, the plain versions,
    the op end to end (the forward through autograd; the backward with its
    two products), and the torch sequence the op replaced (the Dense as
    F.linear or matmul/bmm plus the bias, then tanh(F.layer_norm); its
    autograd backward), each per call (calls back to back between CUDA
    events) and on the device (torch.profiler: our kernel alone for the
    wrappers, every kernel for the op and the sequence)."""
    import torch.nn.functional as F

    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    g = torch.Generator(device=device).manual_seed(8)
    rows = {}
    for shape, (wg, need_dx) in K5_SHAPES.items():
        form, e, m, k, d = shape
        member = form == "member"
        x, kernel, bias, gamma, beta, dy = k5_checks.inputs(form, e, m, k, d, g, device)
        x3, w3, b2, out_shape = k5.member_views(x, kernel, bias, member)
        y, h, mean, rstd = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True)
        dy_out = dy.view(out_shape)

        def leaves():
            ts = [t.detach().clone().requires_grad_(need)
                  for t, need in zip((x, kernel, bias, gamma, beta), (need_dx,) + (wg,) * 4)]
            return ts, [t for t in ts if t.requires_grad]

        def sequence(xs, ks, bs, gs, bes):
            if form == "linear":
                hh = F.linear(xs, ks, bs)
            elif member:
                hh = torch.bmm(xs, ks) + bs[:, None, :]
            else:
                hh = torch.matmul(xs.reshape(1, -1, k), ks) + bs[:, None, :]
            return torch.tanh(F.layer_norm(hh, (d,), gs, bes, k5.LAYER_NORM_EPS))

        op_args, op_needed = leaves()
        op = lambda: k5.dense_layer_norm_tanh(*op_args, member_inputs=member)
        op_y = op()
        seq_args, seq_needed = leaves()
        seq = lambda: sequence(*seq_args)
        seq_y = seq()
        fwd_bytes = 4 * (x3.numel() + w3.numel() + b2.numel() + 2 * d + 2 * e * m * d + 2 * e * m)
        bwd_bytes = 4 * (4 * e * m * d + 2 * e * m + d + ((2 + e) * d if wg else 0))
        cases = {
            "fwd": dict(
                kernel=lambda: k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True),
                kernel_name="dense_ln_tanh_fwd_kernel",
                plain=lambda: k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta),
                op=op, sequence=seq, bytes=fwd_bytes,
                ops=K5_OPS_PER_ELEMENT["fwd"] * e * m * d, tf32_ops=3 * 2 * e * m * k * d),
            "bwd": dict(
                kernel=lambda: k5.dense_layer_norm_tanh_backward(dy, y, h, mean, rstd, gamma, wg),
                kernel_name="dense_ln_tanh_bwd_kernel",
                plain=lambda: k5.dense_layer_norm_tanh_backward_plain(dy, y, h, mean, rstd, gamma,
                                                                      wg),
                op=lambda: torch.autograd.grad(op_y, op_needed, dy_out, retain_graph=True),
                sequence=lambda: torch.autograd.grad(seq_y, seq_needed, dy_out,
                                                     retain_graph=True),
                bytes=bwd_bytes, tf32_ops=0,
                ops=(K5_OPS_PER_ELEMENT["bwd"] + wg * K5_OPS_PER_ELEMENT["bwd_weight_grads"])
                * e * m * d),
        }
        for direction, c in cases.items():
            bound_ms, bound_by = bound(c["bytes"], c["ops"], c["tf32_ops"])
            rows[(direction, shape)] = row = dict(
                ms=per_call_ms(c["kernel"], calls=50),
                profiler_ms=profiled_kernel_ms(c["kernel"], 50, c["kernel_name"]),
                plain_ms=per_call_ms(c["plain"], calls=20),
                op_ms=per_call_ms(c["op"], calls=50),
                op_profiler_ms=profiled_kernel_ms(c["op"], 50, ""),
                sequence_ms=per_call_ms(c["sequence"], calls=50),
                sequence_profiler_ms=profiled_kernel_ms(c["sequence"], 50, ""),
                bound_ms=bound_ms, bound_by=bound_by, bytes=c["bytes"],
                tf32_ops=c["tf32_ops"], fp32_ops=c["ops"], library_ms=None)
            what = ("y, h, mean, rstd stored" if direction == "fwd" else
                    "dh" + (", dgamma, dbeta, dbias" if wg else " only (as on the main path)"))
            print(f"K5 {direction} at {k5_label(shape)} ({what}): kernel {row['ms']:.4f} ms per "
                  f"call (50 back to back, CUDA events), {row['profiler_ms']:.4f} ms on the "
                  f"device (torch.profiler); plain {row['plain_ms']:.4f} ms; the op through "
                  f"autograd{' with its dx, dW products' if direction == 'bwd' else ''} "
                  f"{row['op_ms']:.4f} ms per call, {row['op_profiler_ms']:.4f} ms on the "
                  f"device; the replaced torch sequence {row['sequence_ms']:.4f} ms per call, "
                  f"{row['sequence_profiler_ms']:.4f} ms on the device; bound "
                  f"{row['bound_ms']:.6f} ms by {row['bound_by']} ({row['bytes']} bytes, "
                  f"{row['tf32_ops']} TF32 tensor-core ops at 495 TFLOP/s, {row['fp32_ops']} "
                  f"fp32 ops at 67 TFLOP/s) [{card}]")
    return rows


def _cube_frames(torch, frames) -> int:
    """How many of the (N, H, W, 3) frames show the cube (purple: red = blue
    > green)."""
    w = frames.to(torch.int16)
    cube = ((w[..., 0] - w[..., 2]).abs() <= 2) & (w[..., 0] > w[..., 1] + 10)
    return int(cube.flatten(1).any(1).sum())


def _k2_hold(torch, k2, builds, s, where: str, rule: dict):
    """K2 on the states `s` against its plain version under the pixel rule
    of tests/torch_k2.py, each build of `builds` (the first, the shipped one,
    must hold), and each build's scene rows against pack_scene's. Returns
    (the shipped build's worst level difference, the worst scene row error,
    the plain frames); `rule` records which builds held."""
    from serl_tpu_torch.envs import rendering

    n = s.cube_pos.shape[0]
    want = rendering.render_cameras_plain(s, PIXEL_SIZE)
    shipped, worst, scene_err = next(iter(builds)), 0, 0.0
    for label, lib in builds.items():
        rows = torch.empty((n, rendering.SCENE_FLOATS), device=s.cube_pos.device)
        got = rendering.render_cameras_cuda(s, PIXEL_SIZE, scene_out=rows, lib=lib)
        torch.cuda.synchronize()
        err = float((rows - rendering.pack_scene(s)).abs().max())
        print(f"K2 ({label}) scene rows vs pack_scene, {where}: max abs err {err:.3g} "
              f"(tolerance {k2.SCENE_ATOL})")
        if err > k2.SCENE_ATOL:
            raise AssertionError(f"K2 ({label}) scene rows, {where}: {err}")
        scene_err = max(scene_err, err)
        for cam, a, b in zip(IMAGE_KEYS, got, want):
            failures, summary = k2.pixel_rule(a, b)
            print(f"K2 ({label}) vs plain, {where}, {cam}: {json.dumps(summary)}")
            rule[label] = rule[label] and not failures
            if label == shipped:
                if failures:
                    raise AssertionError(f"K2, {where}, {cam}: " + "; ".join(failures))
                worst = max(worst, summary["max_level_diff"])
    return worst, scene_err, want


def phase_k2_vs_plain(torch, checks, k2, builds, device):
    """K2 against its plain version at K2_N envs, 128 px, on rollout and
    grasp states, and at the fwbw paths' 32 chained envs on bin states
    (phase_k2_bin_vs_plain), under the pixel rule of tests/torch_k2.py, both
    -fmad builds; the kernel's scene rows (its debug output) against
    pack_scene's; one render under torch.cuda.set_sync_debug_mode("error")."""
    from serl_tpu_torch.envs import rendering

    g = torch.Generator(device=device).manual_seed(2)
    worst, scene_err = 0, 0.0
    rule = {label: True for label in builds}
    for n in K2_N:
        for source, make in (("rollout", checks.rollout_states), ("grasp", checks.grasp_states)):
            s = make(n, g, device)
            w, e, want = _k2_hold(torch, k2, builds, s, f"N={n}, {source} states", rule)
            worst, scene_err = max(worst, w), max(scene_err, e)
            if source == "grasp":
                envs = _cube_frames(torch, want[1])  # the cube in the wrist camera's view
                print(f"K2 grasp states at N={n}: the cube is in {envs} of {n} wrist frames")
                if envs < n // 2:
                    raise AssertionError(f"the cube is in view in only {envs} of {n} grasp frames")
    w, e = phase_k2_bin_vs_plain(torch, checks, k2, builds, device, rule)
    worst, scene_err = max(worst, w), max(scene_err, e)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rendering.render_cameras(s, PIXEL_SIZE)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"K2 vs plain: at most {k2.FLIP_SHARE:.3%} of the pixels may differ by more than one "
          f"level, each on an edge (3x3 span > {k2.EDGE_LEVELS} levels); worst level "
          f"difference {worst} (shipped build); the rule held for "
          f"{json.dumps(rule)}; scene rows within {scene_err:.3g} of pack_scene's; a render ran "
          "under torch.cuda.set_sync_debug_mode('error'): nothing copied from the host")
    return worst, scene_err, rule


def _chained_render_states(torch, device, n: int, g):
    """The chained env's physics states at n envs, as the fwbw paths render
    them: after a reset (each env's task drawn, the arm at its task's reset
    pose, the cube in its source bin) and after FWBW_K2_STEPS steps of the
    relocation expert with Gaussian noise (0.1) on its actions (the cube
    grasped, lifted over the walls, carried, set down in the other bin)."""
    from serl_tpu_torch.envs.chained_bin import ChainedBinEnv
    from serl_tpu_torch.training.fwbw import chained_expert_action

    env = ChainedBinEnv(device=device)
    state, _ = env.reset(n, g)
    out = {"chained reset": state.env.physics}
    for step in range(1, max(FWBW_K2_STEPS) + 1):
        noise = 0.1 * torch.randn((n, 7), generator=g, device=device)
        state, *_ = env.step_auto_reset(state, chained_expert_action(env, state) + noise,
                                        generator=g, final_obs=False)
        if step in FWBW_K2_STEPS:
            out[f"chained, {step} expert steps"] = state.env.physics
    return out


def phase_k2_bin_vs_plain(torch, checks, k2, builds, device, rule):
    """K2 at the fwbw paths' width (FWBW_K2_N: the 32 chained envs whose
    front frames the classifiers judge) on bin states: tests/torch_k1.py's
    bin_states (cubes against the walls, in corners, over a wall's top, at
    its top edge) and the chained env's own states (_chained_render_states),
    both builds under the pixel rule; the cube must be in view of the front
    camera in most envs. Returns (worst level difference, worst scene row
    error)."""
    g = torch.Generator(device=device).manual_seed(71)
    n, worst, scene_err = FWBW_K2_N, 0, 0.0
    sets = {f"{kind} bin states": s for kind, s in checks.bin_states(n, g, device).items()}
    sets.update(_chained_render_states(torch, device, n, g))
    for source, s in sets.items():
        w, e, want = _k2_hold(torch, k2, builds, s, f"N={n}, {source}", rule)
        worst, scene_err = max(worst, w), max(scene_err, e)
        envs = _cube_frames(torch, want[0])
        print(f"K2 {source} at N={n}: the cube is in {envs} of {n} front frames")
        if envs < n // 2:
            raise AssertionError(f"the cube is in view in only {envs} of {n} front frames "
                                 f"({source})")
    return worst, scene_err


def phase_k3_vs_plain(torch, device):
    """K3 against its plain version: four image batches per launch (obs and
    next_obs of both cameras, as DrQ crops them) at K3_SHAPES, and batches
    that reach each copy path of the kernel (K3_PATHS): exactly equal."""
    from serl_tpu_torch.vision import augmentations as aug

    g = torch.Generator(device=device).manual_seed(3)
    lib = aug._crop_library()
    cases = [(shape, torch.uint8, 0, 4, 16) for shape in K3_SHAPES] + [
        (shape, getattr(torch, dtype), off, jobs, unit) for shape, dtype, off, jobs, unit in K3_PATHS]
    for shape, dtype, base_offset, jobs, unit in cases:
        n = math.prod(shape)
        imgs = []
        for _ in range(jobs):
            raw = torch.randint(0, 256, (n * torch.tensor([], dtype=dtype).element_size()
                                         + base_offset,), generator=g, device=device,
                                dtype=torch.uint8)
            imgs.append(raw[base_offset:].view(dtype).view(shape))
        offs = [aug.crop_offsets(shape[0] * shape[1], 4, g, device) for _ in imgs]
        got = aug.crop_images(imgs, offs, padding=4, num_batch_dims=2)
        ptrs = lambda ts: (ctypes.c_void_p * jobs)(*(t.data_ptr() for t in ts))
        took = lib.serl_random_crop_unit(ptrs(imgs), ptrs(got), jobs, shape[3],
                                         shape[4] * imgs[0].element_size())
        if took != unit:
            raise AssertionError(f"K3 at {shape} {dtype} {base_offset} bytes off took "
                                 f"{took}-byte units, not {unit}")
        for img, off, out in zip(imgs, offs, got):
            want = aug.batched_random_crop_gather(img, off, padding=4, num_batch_dims=2)
            if not torch.equal(out.view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"K3 differs from plain at {shape} {dtype}")
        print(f"K3 vs plain at {jobs} x {shape} {dtype}, base {base_offset} bytes past 16-byte "
              f"alignment, one launch, {unit}-byte units: exactly equal")
    return 0.0


def _pixel_ring(torch, device, g, slots=K4_PIXEL_SHAPE["slots"],
                streams=K4_PIXEL_SHAPE["streams"], state_dim=7, action_dim=4):
    """A full, wrapped ring of slots x streams with 100-slot episodes that end
    at another slot in every stream: (data, ep_id, insert_slot)."""
    frame = (PIXEL_SIZE, PIXEL_SIZE, 3)
    data = {"observations": {"state": torch.randn((slots, streams, state_dim), generator=g,
                                                  device=device),
                             **{k: torch.randint(0, 256, (slots, streams) + frame, generator=g,
                                                 device=device, dtype=torch.uint8)
                                for k in IMAGE_KEYS}},
            **{k: torch.randn((slots, streams) + shape, generator=g, device=device)
               for k, shape in (("actions", (action_dim,)), ("rewards", ()), ("masks", ()),
                                ("dones", ()))}}
    insert_slot = 300  # slot 299 is the newest, 300 the oldest
    age = (torch.arange(slots, device=device) - insert_slot) % slots
    stream = torch.arange(streams, device=device)
    ep_id = (((age[:, None] + 7 * stream[None, :]) // 100) * streams
             + stream[None, :]).to(torch.int32)
    return data, ep_id, insert_slot


def phase_k4_pixel_vs_plain(torch, device):
    """K4's pixel gather against its plain version at the pixel paths'
    shapes (K4_PIXEL_SHAPES): T = 1 and 3, rows at episode starts (clamped
    stacks), at episode ends (successor fallback) and at the ring's seam:
    exactly equal."""
    g = torch.Generator(device=device).manual_seed(44)
    return max([_k4_pixel_vs_plain(torch, device, g, **shape) for shape in K4_PIXEL_SHAPES]
               + [_k4_pixel_vs_plain(torch, device, g, **shape, state_dim=10, action_dim=7)
                  for shape in K4_POSE_PIXEL_SHAPES])


def _k4_pixel_vs_plain(torch, device, g, slots, streams, rows_per_stream, state_dim=7,
                       action_dim=4):
    from serl_tpu_torch.data import replay_buffer as rbm

    r = rows_per_stream
    data, ep_id, insert_slot = _pixel_ring(torch, device, g, slots, streams, state_dim,
                                           action_dim)
    stream = torch.arange(streams, device=device)
    starts = ((ep_id != ep_id.roll(1, 0)).to(torch.int32).argmax(0))  # an episode's first slot
    u = torch.randint(0, slots - 1, (r, streams), generator=g, device=device)
    s2 = (insert_slot - slots + u) % slots
    s2[0] = (insert_slot - 2) % slots  # the seam: the newest sampleable slot
    s2[1], s2[2], s2[3] = starts, (starts + 1) % slots, (starts - 1) % slots
    for num_stack in (1, 3):
        got = rbm.gather_batch_aligned_cuda(data, ep_id, s2, False, IMAGE_KEYS, num_stack)
        want = rbm.gather_batch_aligned_plain(data, ep_id, s2, False, IMAGE_KEYS, num_stack)
        torch.cuda.synchronize()
        for part in want:
            for k, w in (want[part].items() if isinstance(want[part], dict) else [(None, want[part])]):
                x = got[part] if k is None else got[part][k]
                if x.shape != w.shape or x.dtype != w.dtype or not torch.equal(x, w):
                    raise AssertionError(f"K4 pixel differs from plain in {part}/{k} (T={num_stack})")
    raw = (s2[:, :, None] - torch.arange(2, -1, -1, device=device)) % slots
    clamped = int((ep_id[raw, stream[None, :, None]] != ep_id[s2, stream][..., None]).sum())
    boundary = int((ep_id[(s2 + 1) % slots, stream] != ep_id[s2, stream]).sum())
    if clamped == 0 or boundary == 0:
        raise AssertionError("K4 pixel check sampled no clamped stack or no episode end")
    print(f"K4 pixel vs plain at {slots} slots x {streams} streams ({state_dim}-dim state, "
          f"{action_dim}-dim actions), {r * streams} rows of "
          f"{PIXEL_SIZE} px frames, T = 1 and 3 ({clamped} clamped stack frames at T = 3, "
          f"{boundary} rows at an episode end): exactly equal")
    return 0.0


def phase_k4_copy_paths_vs_plain(torch, device):
    """K4 against its plain version on fields that reach every copy path of
    the kernel: wide rows (1024 bytes or more) in 16-byte units (aligned
    frames), in 4-byte words (frames whose base address is 4 bytes off, a
    contiguous view into a larger buffer) and in bytes (27 x 27 x 3 frames,
    2,187 bytes a row); narrow rows in words (fp32) and in bytes (a 27-byte
    uint8 field). T = 1 and 3, at the pixel path's ring shape: exactly equal."""
    from serl_tpu_torch.data import replay_buffer as rbm

    slots, streams, r = (K4_PIXEL_SHAPE[k] for k in ("slots", "streams", "rows_per_stream"))
    g = torch.Generator(device=device).manual_seed(45)

    def frames(shape, offset=0):
        n = slots * streams * math.prod(shape)
        flat = torch.randint(0, 256, (n + offset,), generator=g, device=device, dtype=torch.uint8)
        return flat[offset:].view((slots, streams) + shape)

    _, ep_id, insert_slot = _pixel_ring(torch, device, g)
    data = {"observations": {"state": torch.randn((slots, streams, 7), generator=g, device=device),
                             "bytes27": frames((27,)),
                             "aligned": frames((64, 64, 3)),
                             "off_by_4": frames((64, 64, 3), offset=4),
                             "odd": frames((27, 27, 3))},
            **{k: torch.randn((slots, streams) + shape, generator=g, device=device)
               for k, shape in (("actions", (4,)), ("rewards", ()), ("masks", ()), ("dones", ()))}}
    image_keys = ("aligned", "off_by_4", "odd")
    if data["observations"]["off_by_4"].data_ptr() % 16 != 4:
        raise AssertionError("the off-by-4 view is not 4 bytes off a 16-byte boundary")
    starts = ((ep_id != ep_id.roll(1, 0)).to(torch.int32).argmax(0))
    s2 = (insert_slot - slots + torch.randint(0, slots - 1, (r, streams), generator=g,
                                              device=device)) % slots
    s2[0], s2[1] = starts, (starts - 1) % slots  # clamped stacks, episode ends
    for num_stack in (1, 3):
        got = rbm.gather_batch_aligned_cuda(data, ep_id, s2, False, image_keys, num_stack)
        want = rbm.gather_batch_aligned_plain(data, ep_id, s2, False, image_keys, num_stack)
        torch.cuda.synchronize()
        for part in want:
            for k, w in (want[part].items() if isinstance(want[part], dict) else [(None, want[part])]):
                x = got[part] if k is None else got[part][k]
                if x.shape != w.shape or x.dtype != w.dtype or not torch.equal(x, w):
                    raise AssertionError(f"K4 differs from plain in {part}/{k} (T={num_stack})")
    print(f"K4 copy paths vs plain at {slots} slots x {streams} streams, {r * streams} rows, T = 1 "
          "and 3: wide rows in 16-byte units (64x64x3 frames), 4-byte words (the same 4 bytes off "
          "alignment), bytes (27x27x3 frames); narrow rows in words (fp32) and bytes (27 uint8): "
          "exactly equal")
    return 0.0


def phase_pixel_path(torch, device, card):
    """bench_pixels' configuration end to end, timed as bench.py's
    _bench_fused times it: warm-up chunks of PIXEL_CHUNK iterations until the
    buffer holds the training threshold, then the best of 3 chunks, each
    ending in a device-to-host read of a metric."""
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment
    from serl_tpu_torch.training.loop import evaluate

    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(device=device,
                                                                         **BENCH_PIXELS)
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(9))
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = 0
    while True:
        carry, m = run_chunk(carry, PIXEL_CHUNK)
        warmup += PIXEL_CHUNK
        if int(m["buffer_size"][-1]) >= threshold:
            break
    if float(m["critic_loss"][-1]) == 0.0:
        raise AssertionError("the pixel learner did not start at the training threshold")
    before = [p.detach().clone() for p in agent.parameters()]
    torch.cuda.synchronize()
    reset_launches()
    best, chunks = float("inf"), []
    for _ in range(3):
        t0 = time.perf_counter()
        carry, m = run_chunk(carry, PIXEL_CHUNK)
        float(m["reward_mean"][-1])  # waits for the chunk, as bench.py's fetch
        best = min(best, time.perf_counter() - t0)
        chunks.append(m)
    launches = read_launches()
    iters = 3 * PIXEL_CHUNK
    per_iter = pixel_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    want = {k: v * iters for k, v in per_iter.items()}
    env_steps_s = PIXEL_CHUNK * config.num_envs / best
    updates_s = PIXEL_CHUNK * config.updates_per_iter * config.utd_ratio / best
    print(f"pixel path (bench_pixels: {json.dumps(BENCH_PIXELS)}, {warmup} warm-up iterations, "
          f"then 3 chunks of {PIXEL_CHUNK}): best chunk {best:.4f} s (host clock ending in a "
          f"sync): {env_steps_s:.1f} env-steps/s, {updates_s:.1f} critic updates/s; launches "
          f"over the {iters} iterations {json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the pixel path, got {launches}")
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(10), num_episodes=16,
                  pixel_keys=rb.image_keys)
    metrics = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    learner = {k: metrics[k] for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    params = list(agent.parameters())
    buf = carry.rb_state
    frames = [buf.data["observations"][k][: buf.size] for k in rb.image_keys]
    checks = {
        "losses finite": all(bool(torch.isfinite(v).all()) for v in learner.values()),
        "losses non-zero": all(bool((v != 0).all()) for v in learner.values()),
        "temperature > 0": bool((learner["temperature"] > 0).all()),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
        "targets finite": all(bool(torch.isfinite(p).all())
                              for p in agent.state.target_params["critic"]),
        "params moved, the encoders' included": all(not torch.equal(p, q)
                                                    for p, q in zip(params, before)),
        "frames rendered": all(f.dtype == torch.uint8 and float(f[:, :2].float().std()) > 1
                               for f in frames),
        "eval finite": all(math.isfinite(v) and 0 <= v <= 100 for v in ev.values()),
    }
    print(f"pixel path outputs: critic_loss {float(learner['critic_loss'][-1]):.5g}, actor_loss "
          f"{float(learner['actor_loss'][-1]):.5g}, temperature "
          f"{float(learner['temperature'][-1]):.5g}, entropy {float(learner['entropy'][-1]):.5g} "
          f"(last iteration); optimizer steps {agent.state.step}; buffer {buf.size} slots; eval "
          f"(16 episodes) {json.dumps(ev)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"pixel path output checks failed: {bad}")
    return launches, dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best), \
        env, agent, rb, config, carry, run_chunk


def phase_pixel_times(torch, device, card, k2, builds, env, agent, rb, config, carry, run_chunk):
    """K2 (both -fmad builds), K3 and K4's pixel gather at the pixel path's
    shapes, and where a pixel iteration's time goes."""
    from serl_tpu_torch.data import replay_buffer as rbm
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.vision import augmentations as aug

    g = torch.Generator(device=device).manual_seed(11)
    rows = {}
    # K2 on the loop's own states (16 envs, both cameras, 128 px), both builds
    s = carry.env_states.physics
    n, pixels = s.qpos.shape[0], PIXEL_SIZE * PIXEL_SIZE
    render = lambda: rendering.render_cameras_cuda(s, PIXEL_SIZE)
    ops = k2.render_ops(s, PIXEL_SIZE)
    own = ops["scene"] + ops["camera"] + ops["pixel"]
    nbytes = (n * (7 + 1 + 3 + 4) * 4 + rendering.kernel_constants().nbytes
              + 2 * 2 * pixels * 4 + 2 * n * pixels * 3)
    bound_ms, bound_by = bound(nbytes, own)
    fmad = {label: [] for label in builds}
    for label in list(builds) + list(builds)[::-1]:  # shipped, other, other, shipped
        fmad[label].append(profiled_kernel_ms(
            lambda: rendering.render_cameras_cuda(s, PIXEL_SIZE, lib=builds[label]), 50,
            K2_KERNELS))
    rows["render"] = dict(
        ms=per_call_ms(render, calls=50), profiler_ms=profiled_kernel_ms(render, 50, K2_KERNELS),
        profiler_ms_by_kernel={k: profiled_kernel_ms(render, 50, k) for k in K2_KERNELS},
        plain_ms=per_call_ms(lambda: rendering.render_cameras_plain(s, PIXEL_SIZE), calls=5),
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=own, library_ms=None,
        ops_per_pixel=ops["pixel"] / (2 * n * pixels), ops_per_env_camera=ops["camera"] / (2 * n),
        ops_per_env=ops["scene"] / n, ops_unhoisted=ops["unhoisted"],
        bound_ms_unhoisted=bound(nbytes, ops["unhoisted"])[0], fmad=fmad)
    print(f"K2 operations (counted in the kernel's code by tests/k2_host.cpp): "
          f"{rows['render']['ops_per_pixel']:.2f} per pixel, "
          f"{rows['render']['ops_per_env_camera']:.1f} per (env, camera), "
          f"{rows['render']['ops_per_env']:.1f} per env, {own} in all; the unhoisted count "
          f"{ops['unhoisted'] / (2 * n * pixels):.2f} per pixel, bound "
          f"{rows['render']['bound_ms_unhoisted']:.6f} ms; device ms of the two builds "
          f"(torch.profiler, 50 calls each, in turns) {json.dumps(fmad)}; the shipped build's "
          f"by kernel {json.dumps(rows['render']['profiler_ms_by_kernel'])} [{card}]")

    # K3 at the main path's call: obs and next_obs of both cameras, 1024 x T = 1
    buf = carry.rb_state
    batch_rows = config.batch_size * config.utd_ratio
    batch = rb.sample(buf, batch_rows, generator=g)
    parts = ("observations", "next_observations")
    imgs = [batch[p][k] for p in parts for k in rb.image_keys]
    offs = [aug.crop_offsets(batch_rows, 4, g, device) for _ in imgs]
    crop = lambda: aug.crop_images(imgs, offs, padding=4, num_batch_dims=2)
    nbytes = 2 * sum(i.numel() for i in imgs) + sum(o.numel() * 8 for o in offs)
    bound_ms, bound_by = bound(nbytes, 0)
    rows["random_crop"] = dict(
        ms=per_call_ms(crop, calls=50), profiler_ms=profiled_kernel_ms(crop, 50, "random_crop_kernel"),
        plain_ms=per_call_ms(lambda: [aug.batched_random_crop_gather(i, o, padding=4,
                                                                     num_batch_dims=2)
                                      for i, o in zip(imgs, offs)], calls=10),
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, library_ms=None)

    # K4's pixel gather at the main path's sample: 1024 rows, T = 1, on the loop's ring
    slots, streams = buf.ep_id.shape
    s2 = (buf.insert_slot - buf.size
          + torch.randint(0, buf.size - 1, (batch_rows // streams, streams), generator=g,
                          device=device)) % slots
    gather = lambda: rbm.gather_batch_aligned_cuda(buf.data, buf.ep_id, s2, False, rb.image_keys,
                                                   rb.num_stack)
    out = gather()
    row_bytes = sum(v.numel() * v.element_size() for v in
                    [out[k] for k in out if not isinstance(out[k], dict)]
                    + list(out["observations"].values()) + list(out["next_observations"].values()))
    nbytes = 2 * row_bytes + s2.numel() * 8
    bound_ms, bound_by = bound(nbytes, 0)
    rows["replay_gather_pixel"] = dict(
        ms=per_call_ms(gather, calls=50),
        profiler_ms=profiled_kernel_ms(gather, 50, "replay_gather_kernel"),
        plain_ms=per_call_ms(lambda: rbm.gather_batch_aligned_plain(
            buf.data, buf.ep_id, s2, False, rb.image_keys, rb.num_stack), calls=10),
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, library_ms=None)
    # the same gather from a cold L2: before each call a 256 MB read evicts
    # the 50 MB L2, and each call takes other rows, as the loop's samples do
    flush = torch.zeros(2**26, device=device)
    fresh = [(buf.insert_slot - buf.size
              + torch.randint(0, buf.size - 1, s2.shape, generator=g, device=device)) % slots
             for _ in range(5)]
    calls = [0]

    def cold_gather():
        flush.sum()
        calls[0] += 1
        rbm.gather_batch_aligned_cuda(buf.data, buf.ep_id, fresh[calls[0] % len(fresh)], False,
                                      rb.image_keys, rb.num_stack)

    cold_ms = profiled_kernel_ms(cold_gather, 50, "replay_gather_kernel")
    rows["replay_gather_pixel"]["profiler_ms_cold_l2"] = cold_ms
    del flush
    for name, row in rows.items():
        cold = (f"; from a cold L2, other rows each call, {cold_ms:.4f} ms"
                if name == "replay_gather_pixel" else "")
        print(f"{name} time: kernel {row['ms']:.4f} ms per call (50 back to back, CUDA events; "
              f"torch.profiler kernel time {row['profiler_ms']:.4f} ms{cold}), plain "
              f"{row['plain_ms']:.4f} ms, library null (no single PyTorch call computes it), "
              f"bound {row['bound_ms']:.6f} ms by {row['bound_by']} ({row['bytes']} bytes"
              + (f", {row['ops']} fp32 ops counted in the kernel's code by tests/k2_host.cpp"
                 if "ops" in row else "") + f") [{card}]")

    # where a pixel iteration's time goes: single calls between CUDA events
    mini = rbm._map(lambda v: v[: config.batch_size], batch)
    obs = carry.obs
    states = carry.env_states
    from serl_tpu_torch.envs.wrappers import add_stack_axis

    act = agent.sample_actions(add_stack_axis(obs, rb.image_keys), generator=g)

    def encode():
        with torch.no_grad():
            return agent.encoder(mini["observations"])

    parts = {
        "render (K2, both cameras)": render,
        "env step_auto_reset (K1 + K2 + obs, reward, reset)": lambda: env.step_auto_reset(
            states, act, generator=g, final_obs=False),
        "policy sample_actions (encoder + policy)": lambda: agent.sample_actions(
            add_stack_axis(obs, rb.image_keys), generator=g),
        "sample (K4, 1024 rows)": lambda: rb.sample(buf, batch_rows, generator=g),
        "crop (K3, one update's 4 image batches)": crop,
        "encoder forward (256-row minibatch, no grad)": encode,
        "critic update (1 of utd_ratio, minibatch 256)": lambda: agent.update(
            mini, networks_to_update=frozenset({"critic"}), generator=g),
        "actor+temperature update (batch 1024)": lambda: agent.update(
            batch, networks_to_update=frozenset({"actor", "temperature"}), generator=g),
        "update_high_utd (crop + 4 critic + 1 actor)": lambda: agent.update_high_utd(
            batch, utd_ratio=config.utd_ratio, generator=g),
    }
    split = {k: per_call_ms(fn, calls=1, repeats=10) for k, fn in parts.items()}
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print("pixel iteration, ms per call (median of 10 single calls between CUDA events, host "
          "launch time included): " + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f" [{card}]")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        agent.update_high_utd(rb.sample(buf, batch_rows, generator=g), utd_ratio=config.utd_ratio,
                              generator=g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("pixel sample + update_high_utd (crop included) ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync in the learner step")
    print_busy_share(torch, "pixel loop", run, card, ("K1", "K2", "K3", "K4", "K5"))
    return rows


def _ring_on_cpu(state):
    """A replay ring's state with CPU copies of its tensors (nested dicts too)."""
    def cpu(tree):
        return {k: cpu(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cpu()

    return dataclasses.replace(state, data=cpu(state.data), ep_id=state.ep_id.cpu())


def _sample_draws(torch, g, rb, state, n, device):
    """`sample`'s draws for n rows of `state`: (u, e), e None when aligned."""
    streams = state.ep_id.shape[1]
    n_valid = state.size if rb.store_next_obs else state.size - 1
    if n % streams == 0:
        return torch.randint(0, n_valid, (n // streams, streams), generator=g, device=device), None
    return (torch.randint(0, n_valid, (n,), generator=g, device=device),
            torch.randint(0, streams, (n,), generator=g, device=device))


def _unequal(got, want, path=""):
    """Paths where two (nested) batches differ; `got` on the card."""
    if isinstance(want, dict):
        return [p for k in want for p in _unequal(got[k], want[k], f"{path}/{k}")]
    same = got.shape == want.shape and got.dtype == want.dtype and bool((got.cpu() == want).all())
    return [] if same else [path]


def _rows_in(rows: "torch.Tensor", ring: "torch.Tensor") -> "torch.Tensor":
    """(B,) whether each of the (B, F) rows equals some row of the (R, F) ring."""
    return (rows[:, None, :] == ring[None, :, :]).all(-1).any(-1)


def phase_rlpd_path(torch, device, card):
    """examples/fused_sac_state_sim.py --rlpd at the state_sim preset: the
    scripted expert's demos (the example's scripted_demos: num_demos + 10
    episodes through K1, noise 0.02, one vector for every env), the
    successful ones' first num_demos x 100 transitions as a demo ring, a
    warm-up past the training threshold, then run_fused for RLPD_CHUNKS
    chunks of RLPD_CHUNK iterations with an evaluation after each. Launches
    are counted over the whole path."""
    from serl_tpu_torch.common.logger import Logger
    from serl_tpu_torch.data.demos import demos_to_buffer
    from serl_tpu_torch.examples.fused_sac_state_sim import scripted_demos
    from serl_tpu_torch.training.config import WorkloadConfig
    from serl_tpu_torch.training.launcher import make_state_sim_experiment
    from serl_tpu_torch.training.runner import run_fused

    cfg = WorkloadConfig.preset("state_sim", **RLPD_PRESET)
    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
        seed=cfg.seed, device=device, **cfg.loop_overrides())
    episodes = cfg.num_demos + 10
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    demos, succeeded = scripted_demos(env, cfg.seed, cfg.num_demos)
    torch.cuda.synchronize()
    demo_ms = (time.perf_counter() - t0) * 1e3
    print(f"RLPD demos: {episodes} expert episodes x 100 steps collected in "
          f"{demo_ms:.1f} ms (host clock, ending in a sync); {succeeded} succeeded [{card}]")
    if succeeded < RLPD_DEMO_MIN_SUCCESS:
        raise AssertionError(f"only {succeeded} of {episodes} expert episodes "
                             f"succeeded (at least {RLPD_DEMO_MIN_SUCCESS} needed)")
    demo_state = demos_to_buffer(rb, demos)
    demo_streams = demo_state.ep_id.shape[1]
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = -(-threshold // config.num_envs)  # its last iteration runs the first update
    before = []

    def warm_init(agent, rng, demo_state=None):
        carry = init_fn(agent, rng, demo_state=demo_state)
        carry, m = run_chunk(carry, warmup)
        if int(m["buffer_size"][-1]) < threshold or float(m["critic_loss"][-1]) == 0.0:
            raise AssertionError("the RLPD learner did not start at the training threshold")
        before.extend(p.detach().clone() for p in agent.parameters())
        return carry

    logs = []
    carry, best = run_fused(
        env, agent, rb, config, warm_init, run_chunk,
        total_env_steps=(warmup + RLPD_CHUNKS * RLPD_CHUNK) * config.num_envs,
        chunk_iters=RLPD_CHUNK, eval_period_chunks=1, eval_episodes=RLPD_EVAL_EPISODES,
        seed=cfg.seed, demo_state=demo_state, logger=Logger(debug=True),
        log_fn=lambda log, carry: logs.append(log))
    torch.cuda.synchronize()
    launches = read_launches()
    want = rlpd_launches(config, demo_streams, warmup, RLPD_CHUNKS * RLPD_CHUNK, RLPD_CHUNKS)
    print(f"RLPD path (WorkloadConfig.preset('state_sim', **{json.dumps(RLPD_PRESET)}): "
          f"{json.dumps(config._asdict())}; demo ring {demo_state.ep_id.shape[0]} slots x "
          f"{demo_streams} streams; {warmup} warm-up iterations, then run_fused for "
          f"{RLPD_CHUNKS} chunks of {RLPD_CHUNK} with a {RLPD_EVAL_EPISODES}-episode evaluate "
          f"after each): launches over the path {json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the RLPD path, got {launches}")

    # the path's sample against its plain version: the same draws through
    # sample_mixed on the card's rings (K4 for a half that divides over its
    # ring's streams) and on CPU copies of both rings (the plain gather)
    rows = config.batch_size * config.utd_ratio
    half = rows // 2
    g = torch.Generator(device=device).manual_seed(12)
    online, demo = carry.rb_state, demo_state
    (u_a, e_a), (u_b, e_b) = (_sample_draws(torch, g, rb, online, half, device),
                              _sample_draws(torch, g, rb, demo, rows - half, device))
    batch = rb.sample_mixed(online, demo, rows, u_a=u_a, e_a=e_a, u_b=u_b, e_b=e_b)
    on_cpu = lambda x: None if x is None else x.cpu()
    plain = rb.sample_mixed(_ring_on_cpu(online), _ring_on_cpu(demo), rows, u_a=on_cpu(u_a),
                            e_a=on_cpu(e_a), u_b=on_cpu(u_b), e_b=on_cpu(e_b))
    torch.cuda.synchronize()
    unequal = _unequal(batch, plain)
    print(f"RLPD sample_mixed of {rows} rows ({half} online over {online.ep_id.shape[1]} "
          f"streams{' through K4' if e_a is None else ''}, {rows - half} demo over "
          f"{demo_streams} streams{' through K4' if e_b is None else ' by plain indexing'}) "
          f"on the card against the same draws on CPU copies of both rings: "
          f"{'bit for bit equal' if not unequal else f'differs in {unequal}'}")
    if unequal:
        raise AssertionError(f"sample_mixed on the card differs from the plain path in {unequal}")

    # the interleave: even rows from the online ring, odd rows from the demo ring
    def flat(data, size):
        return torch.cat([data["observations"][:size], data["actions"][:size]], -1).flatten(0, 1)

    sampled = torch.cat([batch["observations"], batch["actions"]], -1)
    in_online = _rows_in(sampled, flat(online.data, online.size))
    in_demo = _rows_in(sampled, flat(demo.data, demo.size))
    odd = torch.arange(rows, device=device) % 2 == 1
    params = list(agent.parameters())
    learner = {k: [log[f"train/{k}"] for log in logs]
               for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    evals = [{k: log[k] for k in ("eval/success_rate", "eval/return_mean")} for log in logs]
    checks = {
        "even rows from the online ring only": bool((in_online & ~in_demo)[~odd].all()),
        "odd rows from the demo ring only": bool((in_demo & ~in_online)[odd].all()),
        "one log and one evaluation per chunk": len(logs) == RLPD_CHUNKS,
        "losses finite": all(math.isfinite(v) for vs in learner.values() for v in vs),
        "losses non-zero": all(v != 0 for vs in learner.values() for v in vs),
        "temperature > 0": all(v > 0 for v in learner["temperature"]),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
        "params moved": all(not torch.equal(p, q) for p, q in zip(params, before)),
        "best params kept": best["params"] is not None,
        "evals finite": all(math.isfinite(v) and 0 <= v <= 100 for e in evals for v in e.values()),
    }
    print(f"RLPD path outputs: {json.dumps({k: [round(v, 5) for v in vs] for k, vs in learner.items()})} "
          f"(per chunk); optimizer steps {agent.state.step}; evals {json.dumps(evals)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"RLPD path output checks failed: {bad}")

    # the learner's step with sample_mixed never waits for the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        agent.update_high_utd(rb.sample_mixed(online, demo, rows, generator=g),
                              utd_ratio=config.utd_ratio, generator=g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sample_mixed + update_high_utd ran under torch.cuda.set_sync_debug_mode('error'): no "
          "host sync in the RLPD learner step")
    return launches, rlpd_launches_per_update(config, demo_streams), \
        dict(demo_ms=demo_ms, demo_episodes=episodes, demo_success=succeeded,
             demo_streams=demo_streams), \
        agent, rb, config, carry, run_chunk


def phase_rlpd_times(torch, device, card, agent, rb, config, carry, run_chunk):
    """sample_mixed against sample alone (per call, device time, K4's share
    of it), and where an RLPD iteration's time goes."""
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(13)
    rows = config.batch_size * config.utd_ratio
    calls = {"sample_mixed": lambda: rb.sample_mixed(carry.rb_state, carry.demo_state, rows,
                                                     generator=g),
             "sample": lambda: rb.sample(carry.rb_state, rows, generator=g)}
    out = {}
    for name, fn in calls.items():
        device_ms = profiled_kernel_ms(fn, 50, "")
        k4_ms = profiled_kernel_ms(fn, 50, "replay_gather_kernel")
        out[name] = dict(ms=per_call_ms(fn, calls=50), device_ms=device_ms, k4_ms=k4_ms,
                         k4_share=k4_ms / device_ms)
    print(f"RLPD sample, {rows} rows: " + json.dumps(
        {k: {f: round(v, 5) for f, v in r.items()} for k, r in out.items()})
        + " (ms per call: 50 back to back between CUDA events; device ms per call and K4's "
        f"share of it from torch.profiler) [{card}]")
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    t1 = time.perf_counter()
    out["iteration_ms"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print(f"RLPD loop iteration: {out['iteration_ms']:.3f} ms (median of 10 single iterations "
          f"between CUDA events, host launch time included) [{card}]")
    t2 = time.perf_counter()
    print_busy_share(torch, "RLPD loop", run, card, ("K1", "K4", "K5"))
    out["seconds"] = {"samples": t1 - t0, "iteration": t2 - t1,
                      "busy_share": time.perf_counter() - t2}
    return out


def phase_pixel_rlpd_path(torch, device, card):
    """examples/fused_drq_sim.py --rlpd at the drq_rlpd preset, small
    encoder: the example's scripted_pixel_demos (num_demos + 10 expert
    episodes with both cameras rendered by K2 a step, noise 0.02 shared by
    every env; the first num_demos successful ones selected on the card), a
    demo ring of one stream per episode, a warm-up past the training
    threshold, then run_fused for PIXEL_RLPD_CHUNKS chunks of
    PIXEL_RLPD_CHUNK iterations with an evaluation after each. Launches are
    counted over the whole path. Then sample_mixed over the two uint8 rings
    with explicit draws against the same draws on CPU copies of the rings,
    the interleave, and a learner step with no host sync."""
    from serl_tpu_torch.common.logger import Logger
    from serl_tpu_torch.data.demos import demos_to_buffer
    from serl_tpu_torch.examples.fused_drq_sim import scripted_pixel_demos
    from serl_tpu_torch.training.config import WorkloadConfig
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment
    from serl_tpu_torch.training.runner import run_fused

    cfg = WorkloadConfig.preset("drq_rlpd", **PIXEL_RLPD_PRESET)
    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(
        seed=cfg.seed, encoder_type=cfg.encoder_type, image_size=cfg.image_size, device=device,
        **cfg.loop_overrides())
    episodes = cfg.num_demos + 10
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    demos, succeeded = scripted_pixel_demos(env, cfg.seed, cfg.num_demos)
    torch.cuda.synchronize()
    demo_ms = (time.perf_counter() - t0) * 1e3
    print(f"pixel RLPD demos: {episodes} expert episodes x 100 steps, two {cfg.image_size} px "
          f"cameras, collected in {demo_ms:.1f} ms (host clock, ending in a sync); "
          f"{succeeded} succeeded [{card}]")
    if succeeded < RLPD_DEMO_MIN_SUCCESS:
        raise AssertionError(f"only {succeeded} of {episodes} pixel expert episodes "
                             f"succeeded (at least {RLPD_DEMO_MIN_SUCCESS} needed)")
    demo_state = demos_to_buffer(rb, demos)
    demo_streams = demo_state.ep_id.shape[1]
    frames = demo_state.data["observations"][rb.image_keys[0]]
    if (frames.dtype != torch.uint8 or tuple(frames.shape) != (100, cfg.num_demos, cfg.image_size,
                                                               cfg.image_size, 3)
            or frames.device.type != device.type or float(frames[:, :4].float().std()) <= 1):
        raise AssertionError(f"the demo ring's frames: {frames.dtype} {tuple(frames.shape)}")
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = -(-threshold // config.num_envs)  # its last iteration runs the first update
    before = []

    def warm_init(agent, rng, demo_state=None):
        carry = init_fn(agent, rng, demo_state=demo_state)
        carry, m = run_chunk(carry, warmup)
        if int(m["buffer_size"][-1]) < threshold or float(m["critic_loss"][-1]) == 0.0:
            raise AssertionError("the pixel RLPD learner did not start at the training threshold")
        before.extend(p.detach().clone() for p in agent.parameters())
        return carry

    logs = []
    t1 = time.perf_counter()
    carry, best = run_fused(
        env, agent, rb, config, warm_init, run_chunk,
        total_env_steps=(warmup + PIXEL_RLPD_CHUNKS * PIXEL_RLPD_CHUNK) * config.num_envs,
        chunk_iters=PIXEL_RLPD_CHUNK, eval_period_chunks=1, eval_episodes=cfg.eval_episodes,
        seed=cfg.seed, demo_state=demo_state, logger=Logger(debug=True),
        log_fn=lambda log, carry: logs.append(log))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = read_launches()
    want = pixel_rlpd_launches(config, demo_streams, warmup, PIXEL_RLPD_CHUNKS * PIXEL_RLPD_CHUNK,
                               PIXEL_RLPD_CHUNKS)
    print(f"pixel RLPD path (WorkloadConfig.preset('drq_rlpd', **{json.dumps(PIXEL_RLPD_PRESET)}):"
          f" {json.dumps(config._asdict())}; demo ring {demo_state.ep_id.shape[0]} slots x "
          f"{demo_streams} streams; {warmup} warm-up iterations, then run_fused for "
          f"{PIXEL_RLPD_CHUNKS} chunks of {PIXEL_RLPD_CHUNK} with a {cfg.eval_episodes}-episode "
          f"evaluate after each, {run_s:.2f} s in all): launches over the path "
          f"{json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the pixel RLPD path, got {launches}")

    rows = config.batch_size * config.utd_ratio
    half = rows // 2
    g = torch.Generator(device=device).manual_seed(14)
    online = carry.rb_state
    (u_a, e_a), (u_b, e_b) = (_sample_draws(torch, g, rb, online, half, device),
                              _sample_draws(torch, g, rb, demo_state, rows - half, device))
    batch = rb.sample_mixed(online, demo_state, rows, u_a=u_a, e_a=e_a, u_b=u_b, e_b=e_b)
    on_cpu = lambda x: None if x is None else x.cpu()
    plain = rb.sample_mixed(_ring_on_cpu(online), _ring_on_cpu(demo_state), rows,
                            u_a=on_cpu(u_a), e_a=on_cpu(e_a), u_b=on_cpu(u_b), e_b=on_cpu(e_b))
    torch.cuda.synchronize()
    unequal = _unequal(batch, plain)
    print(f"pixel RLPD sample_mixed of {rows} rows ({half} online over {online.ep_id.shape[1]} "
          f"streams of {online.ep_id.shape[0]} slots{' through K4' if e_a is None else ''}, "
          f"{rows - half} demo over {demo_streams} streams"
          f"{' through K4' if e_b is None else ' by plain indexing'}; uint8 frames, T = "
          f"{rb.num_stack}) on the card against the same draws on CPU copies of both rings: "
          f"{'bit for bit equal' if not unequal else f'differs in {unequal}'}")
    if unequal:
        raise AssertionError(f"pixel sample_mixed on the card differs from the plain path in "
                             f"{unequal}")

    def flat(data, size):
        return torch.cat([data["observations"]["state"][:size], data["actions"][:size]],
                         -1).flatten(0, 1)

    sampled = torch.cat([batch["observations"]["state"], batch["actions"]], -1)
    in_online = _rows_in(sampled, flat(online.data, online.size))
    in_demo = _rows_in(sampled, flat(demo_state.data, demo_state.size))
    odd = torch.arange(rows, device=device) % 2 == 1
    params = list(agent.parameters())
    learner = {k: [log[f"train/{k}"] for log in logs]
               for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    evals = [{k: log[k] for k in ("eval/success_rate", "eval/return_mean")} for log in logs]
    checks = {
        "even rows from the online ring only": bool((in_online & ~in_demo)[~odd].all()),
        "odd rows from the demo ring only": bool((in_demo & ~in_online)[odd].all()),
        "one log and one evaluation per chunk": len(logs) == PIXEL_RLPD_CHUNKS,
        "losses finite": all(math.isfinite(v) for vs in learner.values() for v in vs),
        "losses non-zero": all(v != 0 for vs in learner.values() for v in vs),
        "temperature > 0": all(v > 0 for v in learner["temperature"]),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
        "params moved, the encoders' included": all(not torch.equal(p, q)
                                                    for p, q in zip(params, before)),
        "best params kept": best["params"] is not None,
        "evals finite": all(math.isfinite(v) and 0 <= v <= 100 for e in evals for v in e.values()),
    }
    print(f"pixel RLPD path outputs: "
          f"{json.dumps({k: [round(v, 5) for v in vs] for k, vs in learner.items()})} (per "
          f"chunk); optimizer steps {agent.state.step}; evals {json.dumps(evals)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"pixel RLPD path output checks failed: {bad}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        agent.update_high_utd(rb.sample_mixed(online, demo_state, rows, generator=g),
                              utd_ratio=config.utd_ratio, generator=g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("pixel sample_mixed + update_high_utd ran under torch.cuda.set_sync_debug_mode('error')"
          ": no host sync in the pixel RLPD learner step")
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    iteration_ms = per_call_ms(lambda: run(1), calls=1, repeats=5)
    print(f"pixel RLPD loop iteration: {iteration_ms:.3f} ms (median of 5 single iterations "
          f"between CUDA events, host launch time included) [{card}]")
    info = dict(demo_ms=demo_ms, demo_episodes=episodes, demo_success=succeeded,
                demo_streams=demo_streams, iteration_ms=iteration_ms, run_s=run_s)
    return launches, pixel_rlpd_launches_per_update(config, demo_streams), info


def _backbone_graft_errors(torch, agent, raw):
    """Paths of the backbones' (and the target backbones') tensors that
    differ from the pickle's values cast to fp32 (kernels HWIO -> OIHW)."""
    from serl_tpu_torch.utils.jax_params import resnet_pairs

    group, targets = agent.state.params["critic"], agent.state.target_params["critic"]
    bad = []
    for key, enc in agent.encoder.encoders.items():
        for path, tensor, layout in resnet_pairs(enc.pretrained_encoder):
            node = raw
            for k in path:
                node = node[k]
            want = torch.from_numpy(node.astype("float32"))
            if layout == "HWIO":
                want = want.permute(3, 2, 0, 1)
            target = targets[next(i for i, p in enumerate(group) if p is tensor)]
            for what, t in (("", tensor), ("target ", target)):
                if t.dtype != torch.float32 or not torch.equal(t.detach().cpu(), want):
                    bad.append(f"{what}{key}/{'/'.join(path)}")
    return bad


def phase_resnet_path(torch, device, card, resnet_checks):
    """bench.py::bench_pixels("resnet-pretrained")'s configuration through
    make_drq_sim_experiment: the frozen ResNet-10 grafted from
    resnet10_params.pkl into both cameras' backbones (checked: every tensor,
    and the target critic's copy, equal to the pickle's values cast to
    fp32), warm-up chunks of RESNET_CHUNK past the training threshold, then
    3 timed chunks of RESNET_CHUNK; the backbones unchanged after them; the
    card's backbone features of rendered frames against the CPU's fp32
    features under tests/torch_resnet.py's rule; where an iteration's time
    goes and the loop's device busy share."""
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment
    from serl_tpu_torch.training.loop import evaluate
    from serl_tpu_torch.utils.pretrained import find_params_file, read_params

    path = find_params_file()
    if path is None:
        raise AssertionError("resnet10_params.pkl is not in the working directory")
    raw = read_params(path)
    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(device=device,
                                                                         **BENCH_RESNET)
    bad = _backbone_graft_errors(torch, agent, raw)
    n_tensors = sum(len(list(e.pretrained_encoder.parameters()))
                    for e in agent.encoder.encoders.values())
    print(f"ResNet graft from {path}: {n_tensors} backbone tensors over "
          f"{len(agent.encoder.encoders)} cameras and their target copies {'equal to' if not bad else 'differ from'} the "
          f"pickle's float16 values cast to fp32" + (f": {bad[:4]}" if bad else ""))
    if bad:
        raise AssertionError(f"the graft differs from the pickle in {bad[:4]}")
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(15))
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = 0
    while True:
        carry, m = run_chunk(carry, RESNET_CHUNK)
        warmup += RESNET_CHUNK
        if int(m["buffer_size"][-1]) >= threshold:
            break
    if float(m["critic_loss"][-1]) == 0.0:
        raise AssertionError("the ResNet learner did not start at the training threshold")
    before = [p.detach().clone() for p in agent.parameters()]
    torch.cuda.synchronize()
    reset_launches()
    best, chunks = float("inf"), []
    for _ in range(3):
        t0 = time.perf_counter()
        carry, m = run_chunk(carry, RESNET_CHUNK)
        float(m["reward_mean"][-1])  # waits for the chunk, as bench.py's fetch
        best = min(best, time.perf_counter() - t0)
        chunks.append(m)
    launches = read_launches()
    iters = 3 * RESNET_CHUNK
    per_iter = pixel_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    want = {k: v * iters for k, v in per_iter.items()}
    env_steps_s = RESNET_CHUNK * config.num_envs / best
    updates_s = RESNET_CHUNK * config.updates_per_iter * config.utd_ratio / best
    print(f"ResNet path (bench_pixels('resnet-pretrained'): {json.dumps(BENCH_RESNET)}, {warmup} "
          f"warm-up iterations, then 3 chunks of {RESNET_CHUNK}): best chunk {best:.4f} s (host "
          f"clock ending in a sync): {env_steps_s:.1f} env-steps/s, {updates_s:.1f} critic "
          f"updates/s; launches over the {iters} iterations {json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the ResNet path, got {launches}")
    frozen_bad = _backbone_graft_errors(torch, agent, raw)
    frozen_bad = [b for b in frozen_bad if not b.startswith("target ")]
    backbone = {id(p) for e in agent.encoder.encoders.values()
                for p in e.pretrained_encoder.parameters()}
    params = list(agent.parameters())
    moved = [not torch.equal(p, q) for p, q in zip(params, before) if id(p) not in backbone]
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(16), num_episodes=16,
                  pixel_keys=rb.image_keys)
    metrics = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    learner = {k: metrics[k] for k in ("critic_loss", "actor_loss", "temperature", "entropy")}

    # the card's backbone features against the CPU's, on the ring's frames
    enc = agent.encoder.encoders[rb.image_keys[0]].pretrained_encoder
    ring = carry.rb_state.data["observations"][rb.image_keys[0]]
    frames = ring[: RESNET_FRAMES // config.num_envs].flatten(0, 1)
    with torch.no_grad():
        card_features = enc(frames)
    cpu_enc = copy.deepcopy(enc).cpu()
    cpu_frames = frames.cpu()
    cpu_features = cpu_enc(cpu_frames)
    emulated = resnet_checks.tf32_features(cpu_enc, cpu_frames)
    failures, summary = resnet_checks.judge(card_features, cpu_features, emulated)
    print(f"ResNet backbone features of {frames.shape[0]} rendered frames, (B, h, w, c) = "
          f"{tuple(card_features.shape)}, the card's (TF32 convolutions) against the CPU's fp32: "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in summary.items()})}; the rule "
          f"(tests/torch_resnet.py): at most {resnet_checks.FACTOR} x the CPU's TF32 emulation's "
          f"error, largest and mean [{card}]")
    checks = {
        "backbones unchanged, bit for bit": not frozen_bad,
        "the heads, the critic and the policy moved": all(moved),
        "losses finite": all(bool(torch.isfinite(v).all()) for v in learner.values()),
        "losses non-zero": all(bool((v != 0).all()) for v in learner.values()),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
        "backbone features within the rule": not failures,
        "eval finite": all(math.isfinite(v) and 0 <= v <= 100 for v in ev.values()),
    }
    print(f"ResNet path outputs: critic_loss {float(learner['critic_loss'][-1]):.5g}, actor_loss "
          f"{float(learner['actor_loss'][-1]):.5g}, temperature "
          f"{float(learner['temperature'][-1]):.5g}; optimizer steps {agent.state.step}; eval "
          f"(16 episodes) {json.dumps(ev)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"ResNet path checks failed: {bad} {frozen_bad[:4]} {failures}")

    # where a ResNet iteration's time goes
    g = torch.Generator(device=device).manual_seed(17)
    buf = carry.rb_state
    rows = config.batch_size * config.utd_ratio
    batch = rb.sample(buf, rows, generator=g)
    mini = {k: ({kk: vv[: config.batch_size] for kk, vv in v.items()} if isinstance(v, dict)
                else v[: config.batch_size]) for k, v in batch.items()}
    obs = mini["observations"]
    imgs = obs[rb.image_keys[0]][:, 0]

    def encode():
        with torch.no_grad():
            return agent.encoder(obs)

    parts = {
        "frozen backbone, one camera, 256 frames": lambda: enc(imgs),
        "encoder forward (both cameras + heads, 256 rows, no grad)": encode,
        "critic update (1 of utd_ratio, minibatch 256)": lambda: agent.update(
            mini, networks_to_update=frozenset({"critic"}), generator=g),
        "actor+temperature update (batch 1024)": lambda: agent.update(
            batch, networks_to_update=frozenset({"actor", "temperature"}), generator=g),
        "update_high_utd (crop + 4 critic + 1 actor)": lambda: agent.update_high_utd(
            batch, utd_ratio=config.utd_ratio, generator=g),
    }
    split = {k: per_call_ms(fn, calls=1, repeats=5) for k, fn in parts.items()}
    box = [carry]

    def run(n):
        box[0], _ = run_chunk(box[0], n)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=5)
    print("ResNet iteration, ms per call (median of 5 single calls between CUDA events, host "
          "launch time included): " + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f" [{card}]")
    print_busy_share(torch, "ResNet loop", run, card, ("K1", "K2", "K3", "K4", "K5"), iters=5)
    return launches, dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best,
                          features=summary, split=split, ring=(rb, carry.rb_state, config))


def phase_resnet_trained(torch, device, card, rb, buf, config):
    """The trained "resnet" encoder (a bf16 ResNet-10 per camera, trained
    through the critic loss) on the card: a DrQ agent built as
    make_drq_sim_experiment(encoder_type="resnet") builds it, then
    RESNET_TRAINED_UPDATES update_high_utd calls (batch 256 x UTD 4) on
    batches sampled from the ResNet path's ring. Launches counted against
    the pixel learner's per update; losses finite and non-zero; every
    parameter moved, the backbones' included; params finite."""
    from serl_tpu_torch.training import launcher

    size = buf.data["observations"][rb.image_keys[0]].shape[-2]
    sample = {"state": torch.zeros((1, launcher.PIXEL_STATE_DIM)),
              **{k: torch.zeros((1, 1, size, size, 3), dtype=torch.uint8) for k in rb.image_keys}}
    agent = launcher.make_drq_agent(0, sample, torch.zeros((1, launcher.ACTION_DIM)),
                                    image_keys=rb.image_keys, encoder_type="resnet",
                                    device=device)
    encoders = list(agent.encoder.encoders.values())
    if any(e.compute_dtype != torch.bfloat16 for e in encoders):
        raise AssertionError("the resnet encoder should convolve in bf16")
    backbone = {id(p) for e in encoders for m in (e.conv_init, e.norm_init, e.blocks)
                for p in m.parameters()}
    before = [p.detach().clone() for p in agent.parameters()]
    g = torch.Generator(device=device).manual_seed(18)
    rows = config.batch_size * config.utd_ratio
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    infos = []
    for _ in range(RESNET_TRAINED_UPDATES):
        batch = rb.sample(buf, rows, generator=g)
        _, info = agent.update_high_utd(batch, utd_ratio=config.utd_ratio, generator=g)
        infos.append(info)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    per = pixel_launches_per_iter(config.utd_ratio, 1)
    want = {"control_step": 0, "render": 0,
            **{k: RESNET_TRAINED_UPDATES * per[k] for k in ("random_crop", "replay_gather",
                                                             "dense_layer_norm_tanh_bwd")},
            "dense_layer_norm_tanh_fwd": RESNET_TRAINED_UPDATES
            * (per["dense_layer_norm_tanh_fwd"] - 5)}  # no acting
    losses = {k: torch.stack([i[group][k] for i in infos]) for group, k in
              (("critic", "critic_loss"), ("actor", "actor_loss"), ("actor", "entropy"))}
    params = list(agent.parameters())
    moved = [not torch.equal(p, q) for p, q in zip(params, before)]
    checks = {
        "launches as the pixel learner's": launches == want,
        "losses finite": all(bool(torch.isfinite(v).all()) for v in losses.values()),
        "losses non-zero": all(bool((v != 0).all()) for v in losses.values()),
        "every parameter moved": all(moved),
        "the backbones moved": all(m for p, m in zip(params, moved) if id(p) in backbone),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
    }
    print(f"ResNet trained (\"resnet\", bf16): {RESNET_TRAINED_UPDATES} update_high_utd calls "
          f"(batch {config.batch_size} x UTD {config.utd_ratio}) in {seconds:.3f} s, the first "
          f"with cuDNN's bf16 set-up; {len(backbone)} backbone tensors, {sum(moved)} of "
          f"{len(params)} parameters moved; critic_loss "
          f"{[round(float(v), 5) for v in losses['critic_loss']]}; launches {json.dumps(launches)} "
          f"[{card}]")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"trained ResNet checks failed: {bad}; launches {launches}, "
                             f"expected {want}")
    return launches


def _pose_run_launches(config, start: int, stop: int, evals: int, bc: bool) -> dict:
    """Launches of one run_fused over loop iterations [start, stop) of the
    state pose path, from its init_fn's reset, with `evals` 32-episode
    evaluations. An env step launches K1 once, then 5 times for every env's
    fresh reset (tasks.SETTLE_STEPS); iterations before random_steps act at
    random, the others sample the policy (2 K5 forwards); an updating
    iteration is one update_high_utd (the state learner's K5 calls, 2 more
    forwards for the BC term's critic pass) on sample_mixed's halves (K4 for
    a half that divides over its ring's streams)."""
    from serl_tpu_torch.envs.tasks import SETTLE_STEPS

    random_iters = -(-config.random_steps // config.num_envs)
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    first_update = -(-threshold // config.num_envs) - 1
    policy = len([i for i in range(start, stop) if i >= random_iters])
    updating = len([i for i in range(start, stop) if i >= first_update])
    per = _pose_per_update(config, bc)
    return {"control_step": SETTLE_STEPS + (1 + SETTLE_STEPS) * (stop - start)
            + evals * (SETTLE_STEPS + 100),
            "render": 0, "random_crop": 0, "replay_gather": per["replay_gather"] * updating,
            "dense_layer_norm_tanh_fwd": 2 * policy + updating * (per["dense_layer_norm_tanh_fwd"]
                                                                  - 2) + evals * 200,
            "dense_layer_norm_tanh_bwd": updating * per["dense_layer_norm_tanh_bwd"]}


def _pose_k4(config) -> int:
    """K4 launches of one sample_mixed on the pose paths: the online half
    divides over its 16 streams, the 20-stream demo half does not (plain)."""
    rows = config.batch_size * config.utd_ratio
    return (int((rows // 2) % config.num_envs == 0)
            + int((rows - rows // 2) % POSE_DEMO_STREAMS == 0))


def _pose_per_update(config, bc: bool) -> dict:
    """Launches per updating iteration of the state pose path (acting included)."""
    per = learner_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    return {**per, "control_step": 6, "replay_gather": config.updates_per_iter * _pose_k4(config),
            "dense_layer_norm_tanh_fwd": per["dense_layer_norm_tanh_fwd"]
            + 2 * bc * config.updates_per_iter}


def _sum_launches(*counts) -> dict:
    """Per kernel of launch_counters(), the sum of the partial counts."""
    return {k: sum(c.get(k, 0) for c in counts) for k in launch_counters()}


def _pose_pre_step_states(torch, device, n: int, g, steps: int = 10, config=None):
    """Pose-task K1 inputs (the peg task unless `config` names another): the
    mocap target after `steps` noisy pose-expert actions (rotations through
    the Euler box) from settled resets, as the env hands them to the control
    step."""
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.envs.tasks import PEG_INSERT_CONFIG, PandaPoseTaskEnv
    from serl_tpu_torch.examples.fused_peg_insert import pose_expert

    config = config or PEG_INSERT_CONFIG
    env = PandaPoseTaskEnv(config, device=device)
    expert = pose_expert(config)
    state = env._reset_state(env.sample_reset_draws(n, g))
    captured, control_step = [], engine.control_step

    def spy(p, obstacles=None):  # the kernel wrapper counts on the module's name
        captured.append(p)
        return control_step(p)

    spy.launches = 0
    engine.control_step = spy
    try:
        for _ in range(steps):
            noise = 0.3 * torch.randn((n, 7), generator=g, device=device)
            state, _ = env._apply_action(state, expert(state, noise=noise))
    finally:
        engine.control_step = control_step
    return captured[0], captured[-1]


def _k1_no_obstacles_library(engine):
    """K1 built with its obstacle code compiled out (SERL_NO_OBSTACLES),
    bound like the shipped build: the witness that a launch without
    obstacles runs only the obstacle-free arithmetic."""
    from serl_tpu_torch.native import build

    return engine.bind_library(build.load_library("control_step", K1_NO_OBSTACLES))


def phase_k1_bin_vs_plain(torch, engine, checks, device) -> float:
    """K1 with the bin walls (the fwbw path's obstacle table) against its
    plain version at bin states (tests/torch_k1.py::bin_states: cubes pressed
    into walls and corners, sunk into a wall's top as when carried over it,
    at a wall's top edge) at FWBW_K1_N envs, under tests/torch_k1.py's rule,
    with active obstacle contacts in every set; two more launches equal bit
    for bit; a launch with M = 0 equal bit for bit to one with
    obstacles=None, and both to the build with the obstacle code compiled
    out."""
    from serl_tpu_torch.envs import tasks

    walls = torch.as_tensor(tasks.bin_walls(), device=device)
    noobs = _k1_no_obstacles_library(engine)
    g = torch.Generator(device=device).manual_seed(41)
    worst = 0.0
    for n in FWBW_K1_N:
        for kind, s in checks.bin_states(n, g, device).items():
            active = engine.active_obstacle_contacts(s, walls)
            envs = int(active.any(-1).any(-1).sum())
            failures, summary, _ = checks.compare_step(engine.control_step_cuda, s, walls)
            first = engine.control_step_cuda(s, walls)
            again = engine.control_step_cuda(s, walls)
            repeats = all(torch.equal(a, b) for a, b in zip(first, again))
            none = engine.control_step_cuda(s)
            m0 = engine.control_step_cuda(s, walls[:0])
            before = engine.control_step_cuda(s, lib=noobs)
            same = (all(torch.equal(a, b) for a, b in zip(m0, none))
                    and all(torch.equal(a, b) for a, b in zip(none, before)))
            print(f"K1 vs plain with the bin walls (M = {walls.shape[0]}), N={n}, {kind} states: "
                  f"{int(active.sum())} corner-box contacts in {envs} envs; max abs err "
                  f"{fmt(summary['max_err'])}; envs beyond the tight tolerance "
                  f"{summary['envs_over_atol']} (at most {summary['budget']}); repeated launches "
                  f"equal bit for bit: {repeats}; M = 0, obstacles=None and the build without "
                  f"obstacle code equal bit for bit: {same}")
            if failures or not repeats or not same:
                raise AssertionError(f"K1 bin N={n} {kind}: {failures or 'launches differ'}")
            if envs < n // 2:
                raise AssertionError(f"K1 bin N={n} {kind}: only {envs} envs touch a wall")
            worst = max(worst, max(summary["max_err"].values()))
    return worst


def phase_k1_pose_vs_plain(torch, engine, checks, device) -> float:
    """K1 against its plain version at pose-task inputs (per-env orientation
    targets: yaw +-pi/6 on peg, roll at pi) under tests/torch_k1.py's rule,
    at the pose paths' widths (POSE_K1_N); repeated launches equal bit for bit."""
    g = torch.Generator(device=device).manual_seed(21)
    worst = 0.0
    for n in POSE_K1_N:
        for source, s in zip(("first step after the settled reset", "after 10 expert steps"),
                             _pose_pre_step_states(torch, device, n, g)):
            failures, summary, _ = checks.compare_step(engine.control_step_cuda, s)
            repeats = all(torch.equal(a, b) for a, b in zip(engine.control_step_cuda(s),
                                                            engine.control_step_cuda(s)))
            print(f"K1 vs plain, pose task N={n}, {source}: max abs err "
                  f"{fmt(summary['max_err'])}; envs beyond the tight tolerance "
                  f"{summary['envs_over_atol']} (at most {summary['budget']}); two more launches "
                  f"equal bit for bit: {repeats}")
            if failures:
                raise AssertionError(f"pose N={n} {source}: " + "; ".join(failures))
            if not repeats:
                raise AssertionError(f"pose N={n}: K1 launches on one input differ")
            worst = max(worst, max(summary["max_err"].values()))
    return worst


def phase_pcb_path(torch, device, card):
    """examples/fused_pcb_insert.py from states with PCB_ARGV (the BC term,
    cosine learning rates, the demo reset bank): 20 expert demo streams
    (auto-reset, 100 steps each; the successful episodes counted), the
    8-stream state bank, then three run_fused calls of POSE_CHUNK-iteration
    chunks with agent checkpoints: A uninterrupted for POSE_CHUNKS chunks;
    B paused by its pause file after POSE_PAUSE_AT chunks; C resumed from
    B's pause checkpoint to the same end. C's loop carry must equal A's bit
    for bit, every leaf. A's final checkpoint restored onto a CPU agent must
    equal A's params, and eval_from_checkpoint on a fresh card agent must
    restore them too. Launches are counted over the whole path."""
    import tempfile

    from serl_tpu_torch.common.logger import Logger
    from serl_tpu_torch.examples import fused_pcb_insert
    from serl_tpu_torch.training.checkpointing import CheckpointManager, flatten
    from serl_tpu_torch.training.runner import eval_from_checkpoint, run_fused

    args = fused_pcb_insert.parser().parse_args(PCB_ARGV + ["--device", str(device)])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    env, agent, rb, config, init_fn, run_chunk, demo_state, info = fused_pcb_insert.build(args)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    print(f"PCB path: {'; '.join(info['lines'])}; {info['demo_successes']} of "
          f"{info['demo_episodes']} expert episodes succeeded; demos and bank collected in "
          f"{demo_s:.2f} s (host clock) [{card}]")
    if info["demo_successes"] < POSE_DEMO_MIN_SUCCESS:
        raise AssertionError(f"only {info['demo_successes']} PCB expert episodes succeeded")
    per_chunk = POSE_CHUNK * config.num_envs
    total = POSE_CHUNKS * per_chunk
    kw = dict(total_env_steps=total, chunk_iters=POSE_CHUNK, eval_period_chunks=POSE_EVAL_PERIOD,
              eval_episodes=args.eval_episodes, seed=args.seed, demo_state=demo_state,
              checkpoint_period_chunks=2)
    with tempfile.TemporaryDirectory() as tmp:
        dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        t1 = time.perf_counter()
        carry_a, best_a = run_fused(env, agent, rb, config, init_fn, run_chunk,
                                    logger=Logger(debug=True), checkpoint_dir=dir_a, **kw)

        def pause(log, carry):
            if log["env_steps"] == POSE_PAUSE_AT * per_chunk:
                open(os.path.join(dir_b, "PAUSE"), "w").close()

        carry_b, _ = run_fused(env, fused_pcb_insert.make_agent(args, device), rb, config,
                               init_fn, run_chunk, logger=Logger(debug=True),
                               checkpoint_dir=dir_b, log_fn=pause, **kw)
        carry_c, _ = run_fused(env, fused_pcb_insert.make_agent(args, device), rb, config,
                               init_fn, run_chunk, logger=Logger(debug=True),
                               checkpoint_dir=dir_b, resume=True, **kw)
        torch.cuda.synchronize()
        runs_s = time.perf_counter() - t1
        want, got = flatten(carry_a), flatten(carry_c)
        unequal = sorted(set(want) ^ set(got)) + [
            k for k in want if k in got and not (torch.equal(got[k], want[k])
                                                 if isinstance(want[k], torch.Tensor)
                                                 else got[k] == want[k])]
        print(f"PCB resume: run A {POSE_CHUNKS} chunks of {POSE_CHUNK} uninterrupted; run B "
              f"paused at {carry_b.env_steps} env steps; run C resumed to {carry_c.env_steps}: "
              f"{len(want)} leaves of the loop carry (params, targets, Adam moments and counts, "
              f"env states, both rings and their cursors, the generator, counters), "
              f"{'every one bit for bit equal' if not unequal else f'{len(unequal)} differ: {unequal[:8]}'};"
              f" three runs in {runs_s:.2f} s [{card}]")
        if unequal or carry_b.env_steps != POSE_PAUSE_AT * per_chunk:
            raise AssertionError(f"the resumed PCB run differs from the uninterrupted one in "
                                 f"{unequal[:8]}")
        step = CheckpointManager(dir_a).latest_step()
        cpu_agent = fused_pcb_insert.make_agent(args, "cpu")
        CheckpointManager(dir_a).restore(step, target={"agent_params": cpu_agent.state.params})
        live = flatten(carry_a.agent.state.params)
        on_cpu = flatten(cpu_agent.state.params)
        cpu_equal = live.keys() == on_cpu.keys() and all(torch.equal(on_cpu[k], live[k])
                                                         for k in live)
        fresh = fused_pcb_insert.make_agent(args, device)
        _, mean = eval_from_checkpoint(env, fresh, rb, dir_a, num_episodes=args.eval_episodes)
        restored = flatten(fresh.state.params)
        card_equal = all(torch.equal(restored[k], live[k]) for k in live)
        steps_a = CheckpointManager(dir_a).steps()
    torch.cuda.synchronize()
    launches = read_launches()
    stop = POSE_CHUNKS * POSE_CHUNK
    pause_stop = POSE_PAUSE_AT * POSE_CHUNK
    bc = args.bc_weight > 0
    want_launches = _sum_launches(
        {"control_step": 2 * (5 + 6 * 100)},  # the demos' and the bank's resets and steps
        _pose_run_launches(config, 0, stop, POSE_CHUNKS // POSE_EVAL_PERIOD, bc),
        _pose_run_launches(config, 0, pause_stop, pause_stop // POSE_CHUNK // POSE_EVAL_PERIOD, bc),
        _pose_run_launches(config, pause_stop, stop, (POSE_CHUNKS - POSE_PAUSE_AT)
                           // POSE_EVAL_PERIOD, bc),
        {"control_step": 5 + 100, "dense_layer_norm_tanh_fwd": 200})  # eval_from_checkpoint
    print(f"PCB checkpoints: run A's steps {steps_a}; its step {step} restored onto a CPU agent: "
          f"{'params equal' if cpu_equal else 'params DIFFER'}; eval_from_checkpoint on a fresh "
          f"card agent: {'params equal' if card_equal else 'params DIFFER'}, success {mean:.3f}; "
          f"launches over the PCB path {json.dumps(launches)} [{card}]")
    if not (cpu_equal and card_equal and math.isfinite(mean)):
        raise AssertionError("a restored PCB checkpoint differs from the params it saved")
    if launches != want_launches:
        raise AssertionError(f"expected launches {want_launches} on the PCB path, got {launches}")
    params = list(carry_a.agent.parameters())
    checks = {"params finite": all(bool(torch.isfinite(p).all()) for p in params),
              "best params kept": best_a["params"] is not None,
              "the BC term on": carry_a.agent.config.bc_regularization == 0.1,
              "cosine learning rate": carry_a.agent.state.txs["actor"].cosine_decay_steps
              == args.total_steps // args.num_envs}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"PCB path checks failed: {bad}")
    return launches, _pose_per_update(config, bc), dict(demo_successes=info["demo_successes"],
                                      demo_episodes=info["demo_episodes"], demo_s=demo_s,
                                      runs_s=runs_s)


def phase_peg_pixel_path(torch, device, card):
    """examples/fused_peg_insert.py --pixels at full width (16 envs, two 128 px
    cameras, small encoders, batch 256 x UTD 4, one update_high_utd an
    iteration, the 20,000-row uint8 ring): its 20 pixel expert demo streams
    (auto-reset; a step renders the terminal and the next observation), a
    warm-up past the training threshold, then 3 chunks of PEG_PIXEL_CHUNK
    iterations timed on the host clock (best of 3, each ending in a read);
    launches over all of it; then where an iteration's device time goes."""
    from serl_tpu_torch.examples import fused_peg_insert

    args = fused_peg_insert.parser().parse_args(PEG_PIXEL_ARGV + ["--device", str(device)])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    env, agent, rb, config, init_fn, run_chunk, demo_state, info = fused_peg_insert.build(args)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    # the pixel agent's constructor runs its encoder once on a one-row sample
    # while its weights are still on the CPU (no launch): not a shape of the path
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    k5.shape_log = {s for s in k5.shape_log if s[2] != 1}
    carry = init_fn(agent, args.seed, demo_state=demo_state)
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = -(-threshold // config.num_envs)
    carry, m = run_chunk(carry, warmup)
    if float(m["critic_loss"][-1]) == 0.0:
        raise AssertionError("the peg pixel learner did not start at the training threshold")
    before = [p.detach().clone() for p in agent.parameters()]
    best, chunks = float("inf"), []
    for _ in range(3):
        t1 = time.perf_counter()
        carry, m = run_chunk(carry, PEG_PIXEL_CHUNK)
        float(m["reward_mean"][-1])  # waits for the chunk
        best = min(best, time.perf_counter() - t1)
        chunks.append(m)
    torch.cuda.synchronize()
    launches = read_launches()
    iters = warmup + 3 * PEG_PIXEL_CHUNK
    random_iters = -(-config.random_steps // config.num_envs)
    updating = iters - (warmup - 1)
    per = {**pixel_launches_per_iter(config.utd_ratio, config.updates_per_iter),
           "control_step": 6, "replay_gather": config.updates_per_iter * _pose_k4(config)}
    want = {"control_step": 5 + 6 * 100 + 5 + 6 * iters,
            "render": 2 * (1 + 2 * 100) + 2 + 2 * iters,
            "random_crop": updating * per["random_crop"],
            "replay_gather": updating * per["replay_gather"],
            "dense_layer_norm_tanh_fwd": 5 * (iters - random_iters)
            + updating * (per["dense_layer_norm_tanh_fwd"] - 5),
            "dense_layer_norm_tanh_bwd": updating * per["dense_layer_norm_tanh_bwd"]}
    env_steps_s = PEG_PIXEL_CHUNK * config.num_envs / best
    updates_s = PEG_PIXEL_CHUNK * config.utd_ratio * config.updates_per_iter / best
    print(f"peg pixel path ({'; '.join(info['lines'])}; {info['demo_successes']} of "
          f"{info['demo_episodes']} expert episodes succeeded; demos in {demo_s:.2f} s; ring "
          f"{carry.rb_state.ep_id.shape[0]} slots x {carry.rb_state.ep_id.shape[1]} streams; "
          f"{warmup} warm-up iterations, then 3 chunks of {PEG_PIXEL_CHUNK}): best chunk "
          f"{best:.4f} s (host clock ending in a read): {env_steps_s:.1f} env-steps/s, "
          f"{updates_s:.1f} critic updates/s; launches {json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the peg pixel path, got {launches}")
    learner = {k: torch.cat([c[k] for c in chunks])
               for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    params = list(agent.parameters())
    checks = {"losses finite and non-zero": all(bool((torch.isfinite(v) & (v != 0)).all())
                                                for v in learner.values()),
              "params moved, the encoders' included": all(not torch.equal(p, q)
                                                          for p, q in zip(params, before)),
              "params finite": all(bool(torch.isfinite(p).all()) for p in params),
              "frames rendered": float(carry.obs["front"].float().std()) > 1}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"peg pixel path checks failed: {bad}")
    box = [carry]

    def run(n):
        box[0], _ = run_chunk(box[0], n)

    print_busy_share(torch, "peg pixel loop", run, card, ("K1", "K2", "K3", "K4", "K5"))
    return launches, per, dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best,
                               demo_s=demo_s, demo_successes=info["demo_successes"],
                               demo_episodes=info["demo_episodes"])



# ---------------------------------------------------------------- learned reward


def _cable_pre_step_states(torch, device, n: int, g):
    """Cable-route K1 inputs and frames: (the first control step after the
    settled reset, the one after 10 noisy pose-expert steps), as the cable
    env hands them to the control step."""
    from serl_tpu_torch.envs.tasks import CABLE_ROUTE_CONFIG

    return _pose_pre_step_states(torch, device, n, g, config=CABLE_ROUTE_CONFIG)


def phase_learned_reward_kernels_vs_plain(torch, engine, checks, k2, device) -> float:
    """K1 and K2 at the cable-route env's own inputs (CABLE_ROUTE_CONFIG's
    reset and targets) at the learned-reward paths' widths (LEARNED_REWARD_N:
    the classifier frames' 8 streams, the loop's 16 envs, the 20 demo
    streams) and at 2,048: K1 under tests/torch_k1.py's rule, repeated
    launches bit for bit; K2 (the shipped build) under tests/torch_k2.py's
    pixel rule."""
    from serl_tpu_torch.envs import rendering

    g = torch.Generator(device=device).manual_seed(31)
    worst = 0.0
    for n in LEARNED_REWARD_N + (2048,):
        for source, s in zip(("first step after the settled reset", "after 10 expert steps"),
                             _cable_pre_step_states(torch, device, n, g)):
            failures, summary, _ = checks.compare_step(engine.control_step_cuda, s)
            repeats = all(torch.equal(a, b) for a, b in zip(engine.control_step_cuda(s),
                                                            engine.control_step_cuda(s)))
            print(f"K1 vs plain, cable route N={n}, {source}: max abs err "
                  f"{fmt(summary['max_err'])}; envs beyond the tight tolerance "
                  f"{summary['envs_over_atol']} (at most {summary['budget']}); two more launches "
                  f"equal bit for bit: {repeats}")
            if failures or not repeats:
                raise AssertionError(f"K1 cable N={n} {source}: {failures or 'launches differ'}")
            worst = max(worst, max(summary["max_err"].values()))
            if n == 2048:
                continue
            got = rendering.render_cameras_cuda(s, PIXEL_SIZE)
            want = rendering.render_cameras_plain(s, PIXEL_SIZE)
            torch.cuda.synchronize()
            for cam, a, b in zip(IMAGE_KEYS, got, want):
                failures, summary = k2.pixel_rule(a, b)
                print(f"K2 vs plain, cable route N={n}, {source}, {cam}: {json.dumps(summary)}")
                if failures:
                    raise AssertionError(f"K2 cable N={n} {source} {cam}: " + "; ".join(failures))
    return worst


class _Lines:
    """A file-like sink that keeps the lines an example prints."""

    def __init__(self):
        self.lines = []

    def write(self, s):
        self.lines.append(s)

    def flush(self):
        pass


def _cable_launches(config, epochs: int, iters: int, warmup: int) -> dict:
    """Launches over the cable-route path: the classifier's frames (the
    noisy expert's 8 streams by env.step: a reset's 5 settle steps and a
    render, then K1 and a render a step; the near-miss and random streams by
    step_auto_reset: K1 six times and two renders a step), `epochs`
    classifier steps (a K3 crop, the bottleneck's K5 forward and backward),
    the wrapped demos (K1 six times, two renders, one classifier forward a
    step), then the loop: its reset, and per iteration K1 six times, two
    renders (the stepped frame for the classifier, then the post-reset
    observation), the classifier's forward, the policy past random_steps (5
    K5 forwards) and per updating iteration two update_high_utd calls on
    sample_mixed batches (the pixel learner's K5 calls, a K3 crop, K4 for
    the online half: 512 rows over 16 streams; the 20-stream demo half is
    plain). A render call launches two kernels. The counts do not depend on
    the number of streams."""
    from serl_tpu_torch.envs.tasks import SETTLE_STEPS

    steps = 100
    per = pixel_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    random_iters = -(-config.random_steps // config.num_envs)
    updating = iters - (warmup - 1)
    policy = iters - random_iters
    k1_auto = SETTLE_STEPS + (1 + SETTLE_STEPS) * steps
    return {
        "control_step": (SETTLE_STEPS + steps) + 2 * k1_auto  # classifier frames
        + k1_auto  # wrapped demos
        + SETTLE_STEPS + (1 + SETTLE_STEPS) * iters,
        "render": (2 + 2 * steps) + 2 * (2 + 4 * steps) + (2 + 4 * steps) + 2 + 4 * iters,
        "random_crop": epochs + updating * config.updates_per_iter,
        "replay_gather": updating * config.updates_per_iter * _pose_k4(config),
        "dense_layer_norm_tanh_fwd": epochs + steps + iters + 5 * policy
        + updating * (per["dense_layer_norm_tanh_fwd"] - 5),
        "dense_layer_norm_tanh_bwd": epochs + updating * per["dense_layer_norm_tanh_bwd"]}


def _vice_launches(config, iters: int, warmup: int, vice_updates: int) -> dict:
    """Launches over the VICE path: the goal frames (8 parked streams by
    env.step), the loop's reset, per iteration K1 six times and one render
    (the pixel buffer stores no next observation), the policy past
    random_steps (its encoder's 3 K5 forwards: the MLPs have no LayerNorm),
    per updating iteration two update_high_utd calls (the classifier's
    bottleneck on the cropped next observations, then per critic update 9
    K5 forwards and 3 backwards through the encoder, per actor update 9
    forwards; a K3 crop and a K4 sample each), `vice_updates` update_vice
    calls (a K4 sample of 80 rows, a K3 crop, the classifier's bottleneck on
    2 x 128 frames) and one evaluation (a reset, then K1, a render, the
    policy's 3 and the classifier's 1 K5 forwards a step)."""
    from serl_tpu_torch.envs.tasks import SETTLE_STEPS

    steps = 100
    random_iters = -(-config.random_steps // config.num_envs)
    updating = iters - (warmup - 1)
    policy = iters - random_iters
    u, utd = config.updates_per_iter, config.utd_ratio
    return {
        "control_step": (SETTLE_STEPS + steps) + SETTLE_STEPS + (1 + SETTLE_STEPS) * iters
        + SETTLE_STEPS + steps,
        "render": (2 + 2 * steps) + 2 + 2 * iters + 2 + 2 * steps,
        "random_crop": updating * u + vice_updates,
        "replay_gather": updating * u + vice_updates,
        "dense_layer_norm_tanh_fwd": 3 * policy + updating * u * (1 + 9 * utd + 9) + vice_updates
        + 4 * steps,
        "dense_layer_norm_tanh_bwd": updating * u * 3 * utd}


def _bc_launches(eval_steps: int = 100) -> dict:
    """BC's path: the pick env's demos (a K1 launch a step) and the
    evaluation (a K1 launch a step); its MLP has no LayerNorm, so no K5."""
    return {"control_step": 100 + eval_steps, "render": 0, "random_crop": 0, "replay_gather": 0,
            "dense_layer_norm_tanh_fwd": 0, "dense_layer_norm_tanh_bwd": 0}


def _drop_cpu_shapes(k5):
    """An agent's constructor runs its encoder once on a one-row sample while
    its weights are still on the CPU (no launch): not a shape of the path."""
    k5.shape_log = {s for s in k5.shape_log if s[2] != 1}


def phase_cable_route_path(torch, device, card):
    """examples/fused_cable_route.py at full width: the classifier's frames
    (8 + 8 + 8 streams), LEARNED_REWARD_EPOCHS classifier steps with the loss
    falling, the wrapper at threshold 0.75 over 20 expert demo streams, the
    loop warmed up past its threshold, then 3 timed chunks of
    LEARNED_REWARD_CHUNK; launches over all of it; the wrapper's reward
    against classifier_fn on the stepped frames, env by env; the saved
    classifier loaded on the CPU; where an iteration's device time goes."""
    from serl_tpu_torch.envs.wrappers import add_stack_axis, serl_obs
    from serl_tpu_torch.examples import fused_cable_route as fcr
    from serl_tpu_torch.networks import classifier as cls
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    args = fcr.parser().parse_args(CABLE_ARGV + ["--device", str(device)])
    out = _Lines()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    env = fcr.PandaPoseTaskEnv(config=fcr.CABLE_ROUTE_CONFIG, image_obs=True,
                               render_size=args.image_size, device=args.device)
    expert = fcr.pose_expert(fcr.CABLE_ROUTE_CONFIG)
    frames = fcr.classifier_frames(env, expert, args.seed)
    state, cinfo = fcr.train_classifier(env, expert, args, out, frames=frames,
                                        epochs=LEARNED_REWARD_EPOCHS)
    torch.cuda.synchronize()
    classifier_s = time.perf_counter() - t0
    env, wrapped, agent, rb, config, init_fn, run_chunk, demo_state, info = fcr.build(
        args, out, classifier=state)
    _drop_cpu_shapes(k5)
    carry = init_fn(agent, args.seed, demo_state=demo_state)
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = -(-threshold // config.num_envs)
    carry, m = run_chunk(carry, warmup)
    if float(m["critic_loss"][-1]) == 0.0:
        raise AssertionError("the cable-route learner did not start at the training threshold")
    before = [p.detach().clone() for p in agent.parameters()]
    best, chunks = float("inf"), []
    for _ in range(3):
        t1 = time.perf_counter()
        carry, m = run_chunk(carry, LEARNED_REWARD_CHUNK)
        float(m["reward_mean"][-1])  # waits for the chunk
        best = min(best, time.perf_counter() - t1)
        chunks.append(m)
    torch.cuda.synchronize()
    launches = read_launches()
    iters = warmup + 3 * LEARNED_REWARD_CHUNK
    want = _cable_launches(config, LEARNED_REWARD_EPOCHS, iters, warmup)
    env_steps_s = LEARNED_REWARD_CHUNK * config.num_envs / best
    updates_s = LEARNED_REWARD_CHUNK * config.utd_ratio * config.updates_per_iter / best
    demo_frac = info["demo_successes"] / (args.num_demos * env.time_limit_steps)
    print(f"cable route path: classifier data {cinfo['positives']} positives, "
          f"{cinfo['negatives']} negatives; {LEARNED_REWARD_EPOCHS} classifier steps, loss "
          f"{cinfo['first_loss']:.4f} -> {cinfo['loss']:.4f}, accuracy {cinfo['accuracy']:.3f} "
          f"({classifier_s:.2f} s with the frames); {args.num_demos} demo streams through the "
          f"wrapper: {info['demo_episodes']} episodes, classifier-success-step frac "
          f"{demo_frac:.3f}; {warmup} warm-up iterations, then 3 chunks of "
          f"{LEARNED_REWARD_CHUNK}): best chunk {best:.4f} s (host clock ending in a read): "
          f"{env_steps_s:.1f} env-steps/s, {updates_s:.1f} critic updates/s; launches "
          f"{json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the cable-route path, got {launches}")
    if not cinfo["loss"] < cinfo["first_loss"]:
        raise AssertionError(f"the classifier's loss did not fall: {cinfo}")
    learner = {k: torch.cat([c[k] for c in chunks])
               for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    params = list(agent.parameters())
    checks = {"losses finite and non-zero": all(bool((torch.isfinite(v) & (v != 0)).all())
                                                for v in learner.values()),
              "params moved": all(not torch.equal(p, q) for p, q in zip(params, before)),
              "params finite": all(bool(torch.isfinite(p).all()) for p in params)}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"cable route path checks failed: {bad}")

    # the wrapper's reward is classifier_fn's verdict on the stepped frames, env by env
    fn = cls.classifier_fn(state)
    with torch.no_grad():
        actions = carry.agent.sample_actions(add_stack_axis(carry.obs, fcr.IMAGE_KEYS),
                                             generator=carry.rng)
    _, _, reward, done, winfo = wrapped.step_auto_reset(carry.env_states, actions,
                                                        generator=carry.rng)
    frames16 = winfo["final_obs"]["images"][fcr.CLS_KEY]
    logits = fn({fcr.CLS_KEY: frames16.unsqueeze(1)})
    prob = torch.sigmoid(logits)
    clear = (prob - fcr.THRESHOLD).abs() > 1e-6
    verdict = (prob >= fcr.THRESHOLD).float()
    if not torch.equal(reward[clear], verdict[clear]) or not torch.equal(reward, winfo["success"]):
        raise AssertionError(f"the wrapper's reward {reward.tolist()} is not classifier_fn's "
                             f"verdict {verdict.tolist()} on the stepped frames")

    # the classifier's file, loaded on the CPU
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "classifier.pkl")
        cls.save_classifier(state, path)
        sample = {fcr.CLS_KEY: frames16[:1].unsqueeze(1).cpu()}
        cpu_state = cls.create_classifier(sample, (fcr.CLS_KEY,), encoder_type="small",
                                          device="cpu")
        cls.load_classifier_params(cpu_state, cls.classifier_tree(state))
        cpu_fn = cls.load_classifier_func(sample, (fcr.CLS_KEY,), path, encoder_type="small",
                                          device="cpu")
    cpu_frames = {fcr.CLS_KEY: frames16.unsqueeze(1).cpu()}
    cpu_logits = cpu_fn(cpu_frames)
    exact = all(torch.equal(a.cpu(), b) for a, b in zip(state.params, cpu_state.params))
    # the allowance: what bf16 convolutions alone change, on the CPU (fp32 vs bf16)
    enc = cpu_state.classifier.encoder_def.encoders[fcr.CLS_KEY]
    enc.compute_dtype = torch.float32
    fp32_logits = cls.classifier_fn(cpu_state)(cpu_frames)
    allowed = (cpu_logits - fp32_logits).abs()
    err = (logits.cpu() - cpu_logits).abs()
    file_summary = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                    "bf16_max": float(allowed.max()), "bf16_mean": float(allowed.mean()),
                    "factor": CLASSIFIER_FILE_FACTOR, "max_abs_logit": float(logits.abs().max())}
    print(f"cable route: the wrapper's reward equals classifier_fn's verdict on the stepped "
          f"frames in all {int(clear.sum())} of {reward.numel()} envs outside 1e-6 of the "
          f"threshold ({int(reward.sum())} successes); the saved classifier loaded on the CPU by "
          f"load_classifier_func: params {'bit for bit' if exact else 'DIFFER'}, logits of "
          f"{reward.numel()} frames against the card's {json.dumps(file_summary)} (the card may "
          f"differ by {CLASSIFIER_FILE_FACTOR} x what bf16 convolutions change on the CPU)")
    if not exact or not (err.max() <= CLASSIFIER_FILE_FACTOR * allowed.max() + 1e-6
                         and err.mean() <= CLASSIFIER_FILE_FACTOR * allowed.mean() + 1e-6):
        raise AssertionError(f"the classifier's file on the CPU disagrees: {file_summary}")
    # what the wrapper adds to an env step: the classifier's pass and a
    # second render (per call between CUDA events, host launch time included;
    # device time from torch.profiler)
    from serl_tpu_torch.envs import rendering

    states, g = carry.env_states, torch.Generator(device=device).manual_seed(7)
    cls_in = {fcr.CLS_KEY: frames16.unsqueeze(1)}
    split = {
        "classifier_ms": per_call_ms(lambda: fn(cls_in), 50),
        "classifier_device_ms": profiled_kernel_ms(lambda: fn(cls_in), 20, ""),
        "render_ms": per_call_ms(lambda: rendering.render_cameras(states.physics, PIXEL_SIZE), 50),
        "wrapped_step_ms": per_call_ms(lambda: wrapped.step_auto_reset(
            states, actions, generator=g, final_obs=False), 10),
        "env_step_ms": per_call_ms(lambda: env.step_auto_reset(
            states, actions, generator=g, final_obs=False), 10)}
    print(f"cable route: a wrapped env step against the inner env's, {config.num_envs} envs: "
          f"{json.dumps({k: round(v, 4) for k, v in split.items()})} [{card}]")
    box = [carry]

    def run(n):
        box[0], _ = run_chunk(box[0], n)

    print_busy_share(torch, "cable route loop", run, card, ("K1", "K2", "K3", "K4", "K5"))
    return launches, want, dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best,
                                step_split=split,
                                classifier=cinfo, demo_frac=demo_frac,
                                demo_episodes=info["demo_episodes"], file=file_summary)


def phase_vice_path(torch, device, card):
    """examples/vice_online.py at full width: the goal frames, create_vice,
    the loop warmed up past its threshold and one chunk of
    LEARNED_REWARD_CHUNK (VICE rewards in update_high_utd), then
    VICE_UPDATES update_vice calls, the last under
    torch.cuda.set_sync_debug_mode("error"), and one 16-episode evaluation;
    exact launches; the vice head moved, its encoders did not (no gradient
    reaches them, and Adam's zero-gradient steps on zero moments move
    nothing); bce_loss and grad_norm finite."""
    from serl_tpu_torch.examples import vice_online as vo
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    args = vo.parser().parse_args(VICE_ARGV + ["--device", str(device)])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    env, agent, rb, config, init_fn, run_chunk, goals, n_goals = vo.build(args, _Lines())
    _drop_cpu_shapes(k5)
    carry = init_fn(agent, args.seed)
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = -(-threshold // config.num_envs)
    carry, _ = run_chunk(carry, warmup + LEARNED_REWARD_CHUNK)
    vice_params = dict(agent.vice.named_parameters())
    before = {k: p.detach().clone() for k, p in vice_params.items()}
    g = torch.Generator(device=device).manual_seed(5)
    infos = []
    for i in range(VICE_UPDATES):
        if i == VICE_UPDATES - 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            batch = vo.vice_batch(rb, carry.rb_state, goals, n_goals, args.num_envs,
                                  args.vice_batch, g)
            _, vinfo = agent.update_vice(batch, generator=g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        infos.append(vinfo["vice"])
    p_succ, v_rate = vo.eval_rollout(env, agent, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = _vice_launches(config, warmup + LEARNED_REWARD_CHUNK, warmup, VICE_UPDATES)
    head = {k for k in vice_params if k.startswith("head.")}
    moved = {k for k, p in vice_params.items() if not torch.equal(p, before[k])}
    bce = [float(i["bce_loss"]) for i in infos]
    gn = [float(i["grad_norm"]) for i in infos]
    print(f"VICE path ({n_goals} goal frames; {warmup} warm-up iterations and a chunk of "
          f"{LEARNED_REWARD_CHUNK}; {VICE_UPDATES} update_vice calls, the last under "
          f"set_sync_debug_mode('error')): bce_loss {bce}, grad_norm {gn}; the vice head's "
          f"{len(head)} tensors moved: {moved == head}; evaluation: pose success {p_succ:.3f}, "
          f"VICE-rated share {v_rate:.3f}; {seconds:.2f} s; launches {json.dumps(launches)} "
          f"[{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the VICE path, got {launches}")
    if moved != head or not all(math.isfinite(x) for x in bce + gn):
        raise AssertionError(f"VICE path checks failed: moved {sorted(moved)}, bce {bce}, "
                             f"grad_norm {gn}")
    return launches, want, dict(bce=bce, grad_norm=gn, seconds=seconds, goals=n_goals)


def phase_bc_path(torch, device, card):
    """record_demo.py -> bc_policy.py on the pick env: 20 expert demos (30
    episodes recorded), BC_STEPS BC steps (batch 256) with the NLL falling,
    then evaluate_batched over 32 episodes; exact launches, no K5."""
    from serl_tpu_torch.common.evaluation import evaluate_batched
    from serl_tpu_torch.data.dataset import Dataset
    from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
    from serl_tpu_torch.examples import bc_policy, record_demo

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rargs = record_demo.parser().parse_args(["--device", str(device)])
    trs, keep = record_demo.record(rargs)
    trs = {k: v for k, v in trs.items() if k not in ("ep_ids", "success")}
    ds = Dataset(trs, device=device)
    agent = bc_policy.make_agent(ds, 0)
    nll = bc_policy.train(agent, ds, BC_STEPS, 256, 0, log=lambda s: None)
    env = PandaPickCubeEnv(device=device)
    stats = evaluate_batched(env, agent, torch.Generator(device=device).manual_seed(99),
                             num_episodes=32)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = _bc_launches()
    first, last = float(nll[:50].mean()), float(nll[-50:].mean())
    print(f"BC path: {keep} demo transitions ({keep // 100} successful demos of 30), {BC_STEPS} "
          f"steps: NLL {first:.3f} (first 50) -> {last:.3f} (last 50); evaluate_batched over 32 "
          f"episodes {json.dumps(stats)}; {seconds:.2f} s; launches {json.dumps(launches)} "
          f"[{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the BC path, got {launches}")
    if not (last < first and math.isfinite(stats["return_mean"])):
        raise AssertionError("BC's NLL did not fall or its evaluation is not finite")
    return launches, want, dict(nll_first=first, nll_last=last, eval=stats, seconds=seconds,
                                demos=keep // 100)



# ---------------------------------------------------------------- fwbw


def phase_k4_routed_vs_plain(torch, device):
    """K4 on the fwbw path's routed rings against its plain version, exactly:
    the state ring (FWBW_K4_STATE: 6,250 x 32 slots, the 512-row online half
    of a 1,024-row batch), the pixel ring (FWBW_K4_PIXEL: 625 x 32, 128 px,
    512 rows) and the state and pixel demo rings (FWBW_K4_DEMO: 600 x 16,
    the 512-row demo half), each with
    unequal stream sizes: a stream never written (it samples its cursor
    slot, a zero row with ep_id -1), short ones, full wrapped ones, and
    cursors anywhere; offsets drawn by RoutedReplayBuffer.sample."""
    from serl_tpu_torch.data import replay_buffer as rbm
    from serl_tpu_torch.data.routed_buffer import RoutedBufferState, RoutedReplayBuffer

    g = torch.Generator(device=device).manual_seed(61)
    for label, slots, streams, rows, pixels in (
            ("state", *FWBW_K4_STATE, False), ("state demo", *FWBW_K4_DEMO, False),
            ("pixel", *FWBW_K4_PIXEL, True), ("pixel demo", *FWBW_K4_DEMO, True)):
        if pixels:
            data, _, _ = _pixel_ring(torch, device, g, slots, streams, state_dim=10, action_dim=7)
            example = {"observations": {"state": torch.zeros(10),
                                        **{k: torch.zeros((PIXEL_SIZE, PIXEL_SIZE, 3),
                                                          dtype=torch.uint8) for k in IMAGE_KEYS}},
                       "actions": torch.zeros(7), "rewards": torch.zeros(()),
                       "masks": torch.zeros(()), "dones": torch.zeros(())}
            rb = RoutedReplayBuffer(example, slots * streams, store_next_obs=False,
                                    image_keys=IMAGE_KEYS, device=device)
        else:
            data = {k: torch.randn((slots, streams) + shape, generator=g, device=device)
                    for k, shape in (("observations", (13,)), ("actions", (7,)),
                                     ("next_observations", (13,)), ("rewards", ()),
                                     ("masks", ()), ("dones", ()))}
            rb = RoutedReplayBuffer({k: v[0, 0] for k, v in data.items()}, slots * streams,
                                    device=device)
        size = torch.randint(2, slots + 1, (streams,), generator=g, device=device)
        size[0], size[1], size[2], size[3:6] = 0, 1, 2, slots  # empty, short, full
        cursor = torch.randint(0, slots, (streams,), generator=g, device=device)
        # each stream's rows: 100-slot episodes over its window, -1 outside it
        age = (torch.arange(slots, device=device)[:, None] - cursor[None]) % slots  # 0 = oldest
        first = slots - size
        valid = age >= first[None]
        stream = torch.arange(streams, device=device)
        ep = ((age - first[None]) // 100) * streams + stream[None]
        ep_id = torch.where(valid, ep, -1).to(torch.int32)
        for leaf in [data] if not pixels else [data, data["observations"]]:
            for k, v in leaf.items():
                if isinstance(v, torch.Tensor):
                    v[:, 0] = 0  # the never-written stream holds zeros
        state = RoutedBufferState(data=data, insert_slot=cursor.long(), size=size.long(),
                                  ep_id=ep_id)
        r = rows // streams
        sub = 0 if rb.store_next_obs else 1
        n_valid = torch.clamp(state.size - sub, min=1)
        u = torch.floor(torch.rand((r, streams), generator=g, device=device)
                        * n_valid.float()).long()
        before = rbm.gather_batch_aligned.launches
        got = rb.sample(state, rows, u=u)
        launched = rbm.gather_batch_aligned.launches - before
        s2 = (state.insert_slot - state.size + u) % slots
        want = rbm.gather_batch_aligned_plain(state.data, state.ep_id, s2, rb.store_next_obs,
                                              rb.image_keys, rb.num_stack)
        torch.cuda.synchronize()
        if launched != 1:
            raise AssertionError(f"K4 routed {label}: {launched} launches, want 1")
        want = _to_cpu(want)
        if _unequal(got, want):
            raise AssertionError(f"K4 routed {label} differs from plain: {_unequal(got, want)}")
        if not bool((want["rewards"][:r] == 0).all()) or not bool((s2[:, 0] == cursor[0]).all()):
            raise AssertionError(f"K4 routed {label}: the empty stream did not sample its cursor")
        print(f"K4 vs plain on the fwbw path's routed {label} ring ({slots} x {streams}, {rows} "
              f"rows, stream sizes {size.min().item()}-{size.max().item()}, one stream empty): "
              "exactly equal, one launch")
    return 0.0


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def phase_k1_bin_times(torch, engine, checks, device, card):
    """K1 per call with and without the wall table at FWBW_K1_N envs (corner
    bin states: every env in contact), beside its plain version with the
    walls and its bound from the operation count with the walls."""
    from serl_tpu_torch.envs import tasks

    walls = torch.as_tensor(tasks.bin_walls(), device=device)
    g = torch.Generator(device=device).manual_seed(43)
    rows = {}
    for n in FWBW_K1_N:
        s = checks.bin_states(n, g, device)["corner"]
        with_walls = lambda: engine.control_step_cuda(s, walls)
        without = lambda: engine.control_step_cuda(s)
        ops = int(checks.op_counts(s, walls).sum())
        ops_free = int(checks.op_counts(s).sum())
        bytes_moved = (2 * sum(x.numel() * 4 for x in s) + engine.kernel_constants().nbytes
                       + walls.numel() * 4)
        bound_ms, bound_by = bound(bytes_moved, ops)
        rows[n] = dict(ms=per_call_ms(with_walls, calls=50),
                       profiler_ms=profiled_kernel_ms(with_walls, 50, "control_step_kernel"),
                       ms_no_walls=per_call_ms(without, calls=50),
                       profiler_ms_no_walls=profiled_kernel_ms(without, 50, "control_step_kernel"),
                       plain_ms=per_call_ms(lambda: engine.control_step_plain(s, walls), calls=2,
                                            repeats=3),
                       ops=ops, ops_no_walls=ops_free, bytes=bytes_moved, bound_ms=bound_ms,
                       bound_by=bound_by)
        r = rows[n]
        print(f"K1 time with the bin walls, N={n} (corner states): {r['ms']:.4f} ms per launch "
              f"(device {r['profiler_ms']:.4f}); without the walls {r['ms_no_walls']:.4f} "
              f"(device {r['profiler_ms_no_walls']:.4f}); plain with the walls "
              f"{r['plain_ms']:.3f} ms; bound {bound_ms:.6f} ms by {bound_by} ({ops} fp32 ops with "
              f"the walls, {ops_free} without; {bytes_moved} bytes) [{card}]")
    return rows


def _fwbw_per_update(args, config) -> dict:
    """Launches of one learner's update per updating iteration: sample_mixed
    (K4 for each half: the online half over its 32 streams, the demo half
    over its 16), then update_high_utd (the state learner's K5 calls with the
    BC term's critic pass, or the pixel learner's with a K3 crop)."""
    u, k = config.utd_ratio, config.updates_per_iter
    if args.pixels:
        per = pixel_launches_per_iter(u, k)
        fwd = per["dense_layer_norm_tanh_fwd"] - 5 + k * FWBW_PIXEL_BC_FWD * (args.bc_weight > 0)
        return {"control_step": 0, "render": 0, "random_crop": k, "replay_gather": 2 * k,
                "dense_layer_norm_tanh_fwd": fwd,
                "dense_layer_norm_tanh_bwd": per["dense_layer_norm_tanh_bwd"]}
    per = learner_launches_per_iter(u, k)
    return {"control_step": 0, "render": 0, "random_crop": 0, "replay_gather": 2 * k,
            "dense_layer_norm_tanh_fwd": per["dense_layer_norm_tanh_fwd"] - 2
            + 2 * k * (args.bc_weight > 0),
            "dense_layer_norm_tanh_bwd": per["dense_layer_norm_tanh_bwd"]}


def _fwbw_launches(args, config, demo_steps: int, iters: int, updates: int, evals: int,
                   limit: int = 100, classifier=None) -> dict:
    """Launches over a fwbw path: the demos (a reset, then `demo_steps`
    chained steps of the ground-truth env), the loop's reset, `iters`
    iterations (a chained step: K1 six times, the observation's render with
    pixels, with classifiers a front render and each classifier's K5
    forward; both policies past random_steps: 2 K5 forwards each from
    states, 5 from pixels), `updates` learner updates (both learners'
    updating iterations), `evals` chained evaluations of FWBW_EVAL_CHAINS
    (a reset, 2 x `limit` steps with both policies, a reset, `limit` with
    the backward one; `limit` the episode length), and with `classifier` (epochs, frame
    blocks, frame steps) their
    frames (K1 six times and a render a step after a reset), train steps (K3,
    K5 forward and backward) and the FP/FN report (a K5 forward a block).
    A render call launches two kernels."""
    from serl_tpu_torch.envs.tasks import SETTLE_STEPS as S

    step = 1 + S
    pixels, cls = int(args.pixels), classifier is not None
    per_policy = 5 if pixels else 2
    n = 2 * config.envs_per_task
    random_iters = -(-config.random_steps // n)
    acting = max(iters - random_iters, 0)
    per = _fwbw_per_update(args, config)
    counts = {
        "control_step": S + step * demo_steps + S + step * iters
        + evals * (2 * S + step * 3 * limit),
        "render": 2 * (pixels * (1 + demo_steps) + pixels + (pixels + cls) * iters
                       + evals * pixels * (2 + 3 * limit)),
        "random_crop": updates * per["random_crop"],
        "replay_gather": updates * per["replay_gather"],
        "dense_layer_norm_tanh_fwd": 2 * per_policy * acting + 2 * cls * iters
        + updates * per["dense_layer_norm_tanh_fwd"] + evals * per_policy * 5 * limit,
        "dense_layer_norm_tanh_bwd": updates * per["dense_layer_norm_tanh_bwd"]}
    if cls:
        epochs, blocks, frame_steps = classifier
        counts["control_step"] += len(FWBW_NOISE_LEVELS) * S + step * frame_steps
        counts["render"] += 2 * frame_steps
        counts["random_crop"] += 2 * epochs
        counts["dense_layer_norm_tanh_fwd"] += 2 * epochs + blocks
        counts["dense_layer_norm_tanh_bwd"] += 2 * epochs
    return counts


def phase_fwbw_path(torch, device, card, mode: str):
    """examples/fused_fwbw_bin_relocation.py at full width (32 chained envs,
    batch 256 x UTD 4 per learner, 10 critics subsampled to 2, the recipe of
    the docstring), in `mode` "state", "pixels" (--pixels: DrQ on both 128
    px cameras) or "classifier" (--classifier_reward: FWBW_CLASSIFIER_EPOCHS
    of the recipe's 800 classifier steps, on the frames of 16 chained envs x
    150 steps at each noise level): the demos (FWBW_DEMO_STEPS of the
    recipe's 600 steps a stream), the loop warmed up until both learners'
    gates are open (read on the host until then), timed chunks, and in state
    mode one evaluate_chained_env of FWBW_EVAL_CHAINS chains. Exact launches
    over the whole path (a chained step launches K1 six times; an updating
    learner K4 twice), finite losses, both agents' params moved, a learner
    step of each under torch.cuda.set_sync_debug_mode("error"); in state
    mode where an iteration's time goes and the busy share."""
    from serl_tpu_torch.examples import fused_fwbw_bin_relocation as ex
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    from serl_tpu_torch.training.fwbw import evaluate_chained_env

    chunk, chunks = {"state": (FWBW_CHUNK, FWBW_CHUNKS), "pixels": (FWBW_PIXEL_CHUNK,
                                                                    FWBW_PIXEL_CHUNKS),
                     "classifier": (FWBW_CHUNK, 1)}[mode]
    argv = FWBW_ARGV + ["--device", str(device), "--demo_steps", str(FWBW_DEMO_STEPS)] + {
        "state": [], "pixels": ["--pixels"] + FWBW_CUT_ARGV,
        "classifier": ["--classifier_reward"] + FWBW_CUT_ARGV}[mode]
    args = ex.parser().parse_args(argv)
    out = _Lines()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    classifiers, cls_counts, cls_info = None, None, None
    if mode == "classifier":
        data = ex.classifier_frames(args, device, ex.CLASSIFIER_STREAMS, ex.CLASSIFIER_STEPS)
        classifiers, cls_info = ex.train_fwbw_classifiers(args, out, device, data=data,
                                                          epochs=FWBW_CLASSIFIER_EPOCHS)
        block = 2 * ex.CLASSIFIER_HALF
        blocks = sum(-(-int(lab.sum()) // block) + -(-int((1 - lab).sum()) // block)
                     for lab in data[2:])
        frame_steps = len(FWBW_NOISE_LEVELS) * ex.CLASSIFIER_STEPS
        cls_counts = (FWBW_CLASSIFIER_EPOCHS, blocks, frame_steps)
    (env, eval_env, rb, config, fw, bw, init_fn, run_chunk, demos,
     info) = ex.build(args, out, classifiers=classifiers)
    _drop_cpu_shapes(k5)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fw_demo, bw_demo, demo_rb = demos
    carry = init_fn(fw, bw, args.seed, fw_demo=fw_demo, bw_demo=bw_demo, demo_rb=demo_rb)
    history, warmup = [], 0
    while carry.training != (True, True):
        carry, m = run_chunk(carry, 1)
        history.append(m)
        warmup += 1
        if warmup > FWBW_MAX_WARMUP:
            raise AssertionError(f"fwbw {mode}: the gates did not open in {warmup} iterations")
    before = [p.detach().clone() for a in (fw, bw) for p in a.parameters()]
    n = 2 * config.envs_per_task
    best = float("inf")
    for _ in range(chunks):
        t1 = time.perf_counter()
        carry, m = run_chunk(carry, chunk)
        float(m["reward_mean"][-1])  # waits for the chunk
        best = min(best, time.perf_counter() - t1)
        history.append(m)
    evals, ev = 0, None
    if mode == "state":
        t1 = time.perf_counter()
        ev = evaluate_chained_env(eval_env, carry.fw_agent, carry.bw_agent, 0,
                                  num_episodes=FWBW_EVAL_CHAINS)
        eval_s = time.perf_counter() - t1
        evals = 1
    torch.cuda.synchronize()
    launches = read_launches()
    iters = warmup + chunks * chunk
    hist = {k: torch.cat([h[k].reshape(h[k].shape[0], -1) for h in history]).cpu()
            for k in history[0]}
    updating = {t: int((hist[f"{t}/critic_loss"] != 0).sum()) for t in ("fw", "bw")}
    want = _fwbw_launches(args, config, FWBW_DEMO_STEPS, iters, sum(updating.values()), evals,
                          env.time_limit_steps, cls_counts)
    env_steps_s = chunk * n / best
    updates_s = chunk * config.utd_ratio * 2 / best
    print(f"fwbw {mode} path: build (demos {info['demos']}{', classifiers' if cls_info else ''}) "
          f"{build_s:.2f} s; {warmup} warm-up iterations until both gates opened (fw updated "
          f"{updating['fw']}, bw {updating['bw']} iterations), then {chunks} chunks of {chunk}: "
          f"best chunk {best:.4f} s (host clock ending in a read): {env_steps_s:.1f} env-steps/s, "
          f"{updates_s:.1f} critic updates/s (both learners); launches {json.dumps(launches)} "
          f"[{card}]")
    if cls_info:
        print(f"fwbw classifiers: " + json.dumps(
            {t: {k: v for k, v in c.items() if k != "state"} for t, c in cls_info.items()}))
    if ev is not None:
        print(f"fwbw evaluate_chained_env, {FWBW_EVAL_CHAINS} chains: {json.dumps(ev)} "
              f"({eval_s:.2f} s)")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the fwbw {mode} path, got {launches}")
    last = {k: hist[k][-chunks * chunk:] for k in ("fw/critic_loss", "bw/critic_loss",
                                                   "fw/actor_loss", "bw/actor_loss")}
    params = [p for a in (carry.fw_agent, carry.bw_agent) for p in a.parameters()]
    checks = {"losses finite and non-zero": all(bool((torch.isfinite(v) & (v != 0)).all())
                                                for v in last.values()),
              "params moved": all(not torch.equal(p, q) for p, q in zip(params, before)),
              "params finite": all(bool(torch.isfinite(p).all()) for p in params),
              "rows in both rings": all(int(r.size.sum()) > 0 for r in (carry.fw_rb, carry.bw_rb)),
              "evaluation in [0, 1]": ev is None or all(0.0 <= v <= 1.0 for v in ev.values())}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"fwbw {mode} path checks failed: {bad}")

    # each learner's step never waits for the device once its gate is open
    g = torch.Generator(device=device).manual_seed(17)
    rows = config.batch_size * config.utd_ratio
    steps = {"fw": lambda: carry.fw_agent.update_high_utd(
                 rb.sample_mixed(carry.fw_rb, carry.fw_demo, rows, generator=g, buffer_b=demo_rb),
                 utd_ratio=config.utd_ratio, generator=g),
             "bw": lambda: carry.bw_agent.update_high_utd(
                 rb.sample_mixed(carry.bw_rb, carry.bw_demo, rows, generator=g, buffer_b=demo_rb),
                 utd_ratio=config.utd_ratio, generator=g)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in steps.values():
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # a chained env step launches K1 six times
    k1_before = launch_counters()["control_step"].launches
    acts = torch.zeros((n, env.ACTION_DIM), device=device)
    env.step_auto_reset(carry.env_states, acts, generator=g, final_obs=False)
    k1_step = launch_counters()["control_step"].launches - k1_before
    print(f"fwbw {mode}: both learners' sample_mixed + update_high_utd ran under "
          f"torch.cuda.set_sync_debug_mode('error'); a chained env step launched K1 {k1_step} "
          "times")
    if k1_step != 6:
        raise AssertionError(f"a chained env step launched K1 {k1_step} times, want 6")
    result = dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best,
                  warmup=warmup, updating=updating, build_s=build_s, demos=info["demos"],
                  evaluation=ev)
    if mode != "state":
        return launches, want, result
    # where an iteration's time goes (single calls between CUDA events, host
    # launch time included), and the loop's busy share
    states, obs = carry.env_states, carry.obs
    tr = {"observations": obs, "actions": acts, "rewards": acts[:, 0],
          "masks": acts[:, 0], "dones": acts[:, 0], "next_observations": obs}
    ep_ids = states.env.ep_id
    parts = {
        "acting (both policies)": lambda: (carry.fw_agent.sample_actions(obs, generator=g),
                                           carry.bw_agent.sample_actions(obs, generator=g)),
        "chained env step (6 K1, obs, reward, task graph, reset)": lambda: env.step_auto_reset(
            states, acts, generator=g, final_obs=True),
        "two masked inserts": lambda: (rb.insert(carry.fw_rb, tr, ep_ids, mask=states.task == 0),
                                       rb.insert(carry.bw_rb, tr, ep_ids, mask=states.task == 1)),
        "fw learner (sample_mixed + update_high_utd)": steps["fw"],
        "bw learner (sample_mixed + update_high_utd)": steps["bw"],
    }
    split = {k: per_call_ms(fn, calls=1, repeats=10) for k, fn in parts.items()}
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print(f"fwbw iteration at {n} chained envs, ms per call (median of 10 single calls between "
          "CUDA events, host launch time included): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}) + f" [{card}]")
    print_busy_share(torch, "fwbw loop", run, card, ("K1", "K4", "K5"))
    result["split"] = split
    return launches, want, result


def kernel_table(rows, lrows, prows, k5rows, errs, launches_by_path, per_iter, ptxas):
    """The kernel table's entries. `launches` is each kernel's count over the
    timed iterations of the path its row describes: the state learner path
    for K1, K4's state row and K5 (as in earlier runs), the pixel path for
    K2, K3 and K4's pixel row; every path's count stands beside it."""

    def launches(name, path):
        return {"launches": launches_by_path[path][name],
                "launches_by_path": {p: c[name] for p, c in launches_by_path.items()},
                "launches_per_iteration": {p: per_iter[p][name] for p in per_iter}}

    main = rows[MAIN_ENVS]
    kernels = [{
        "name": "control_step",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/control_step.cu",
        "replaces": "serl_tpu/envs/physics/engine.py:348",
        **launches("control_step", "learner"),
        "max_abs_err": errs["K1"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "profiler_ms": main["profiler_ms"],
        "ms_by_envs": {str(n): rows[n]["ms"] for n in BOUND_N},
        "profiler_ms_by_envs": {str(n): rows[n]["profiler_ms"] for n in BOUND_N},
        "plain_ms_by_envs": {str(n): rows[n]["plain_ms"] for n in BOUND_N},
        "bound_ms_by_envs": {str(n): rows[n]["bound_ms"] for n in BOUND_N},
        "ops_per_env": main["ops"] // MAIN_ENVS,
        "critical_path_ops_per_env": main["critical_path_ops"],
        "ptxas": ptxas["control_step"],
    }]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "profiler_ms")
    kernels.append({
        "name": "render",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/render.cu",
        "replaces": "serl_tpu/envs/rendering.py:329",
        **launches("render", "pixel"),
        "max_abs_err": errs["K2"][0],  # uint8 levels, under the pixel rule of tests/torch_k2.py
        **{k: prows["render"][k] for k in timed},
        "shape": [BENCH_PIXELS["num_envs"], 2, PIXEL_SIZE, PIXEL_SIZE, 3],
        "scene_max_abs_err": errs["K2"][1],
        "pixel_rule_by_build": errs["K2"][2],
        **{k: prows["render"][k] for k in ("ops", "ops_per_pixel", "ops_per_env_camera",
                                           "ops_per_env", "ops_unhoisted",
                                           "bound_ms_unhoisted", "fmad")},
        "ptxas": ptxas["render"],
    })
    kernels.append({
        "name": "random_crop",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/random_crop.cu",
        "replaces": "serl_tpu/vision/augmentations.py:34",
        **launches("random_crop", "pixel"),
        "max_abs_err": errs["K3"],
        **{k: prows["random_crop"][k] for k in timed},
        "shape": [4, 1024, 1, PIXEL_SIZE, PIXEL_SIZE, 3],
    })
    kernels.append({
        "name": "replay_gather",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/replay_gather.cu",
        "replaces": "serl_tpu/data/replay_buffer.py:317",
        **launches("replay_gather", "learner"),
        "max_abs_err": errs["K4"],
        **{k: lrows["replay_gather"][k] for k in timed},
        "shape": "2048 rows x 6 fp32 fields (state path)",
    })
    kernels.append({
        "name": "replay_gather_pixel",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/replay_gather.cu",
        "replaces": "serl_tpu/data/replay_buffer.py:317",
        **launches("replay_gather", "pixel"),
        "max_abs_err": errs["K4 pixel"],
        **{k: prows["replay_gather_pixel"][k] for k in timed},
        "profiler_ms_cold_l2": prows["replay_gather_pixel"]["profiler_ms_cold_l2"],
        "shape": "1024 rows of state, two 128 px uint8 frames (T = 1) for obs and next_obs, "
                 "actions, rewards, masks, dones (pixel path)",
    })
    for direction, err in (("fwd", errs["K5"]["y_end_to_end"]), ("bwd", errs["K5"]["dh"])):
        name = f"dense_layer_norm_tanh_{direction}"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "serl_tpu_torch/csrc/dense_layer_norm_tanh.cu",
            "replaces": "serl_tpu/networks/mlp.py:95",
            **launches(name, "learner"),
            "max_abs_err": err,  # y abs; dh relative to its largest |dh| (tests/torch_k5.py)
            **{k: k5rows[(direction, K5_MAIN)][k] for k in timed},
            "shape": k5_label(K5_MAIN),
            "errors": errs["K5"],
            "by_shape": {k5_label(shape): k5rows[(direction, shape)] for shape in K5_SHAPES},
        })
    return kernels


def main(kernels_only: bool = False) -> int:
    """The whole run; with `kernels_only` (--kernels) phases 1 and 2 and K5's
    times only, and no result lines."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    for part in ("serl_tpu_torch", os.path.join("tests", "torch_k1.py"),
                 os.path.join("tests", "torch_k2.py"), os.path.join("tests", "torch_k5.py"),
                 os.path.join("tests", "torch_resnet.py"), "resnet10_params.pkl"):
        if not os.path.exists(os.path.join(HERE, part)):
            return fail(f"{part} is not beside chip_smoke.py: run it from the repository")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # phase 1: device and builds (one nvcc per kernel source, all started
    # together, in a thread, while g++ builds the op-counting host code here)
    card = card_line()
    import numpy

    print(f"card: {card}; python {sys.version.split()[0]}, torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}), numpy {numpy.__version__}")
    # the pretrained backbone's pickle beside this script, unless the caller names another
    os.environ.setdefault("SERL_RESNET10_PARAMS", os.path.join(HERE, "resnet10_params.pkl"))
    from serl_tpu_torch.data import replay_buffer as rbm
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.native import build
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    from serl_tpu_torch.vision import augmentations

    checks = load_checks("torch_k1")
    k2 = load_checks("torch_k2")
    k5_checks = load_checks("torch_k5")
    resnet_checks = load_checks("torch_resnet")
    t0 = time.perf_counter()
    built = {}

    def nvcc():
        try:
            build.build_all(build.KERNEL_SOURCES, [("render", K2_BUILDS[1][1]),
                                                   ("control_step", K1_NO_OBSTACLES)])
            built["s"] = time.perf_counter() - t0
        except Exception as exc:  # re-raised below, after the join
            built["error"] = exc

    thread = threading.Thread(target=nvcc)
    thread.start()
    s1 = checks.reset_states(1, torch.Generator().manual_seed(0), "cpu")
    checks.op_counts(s1)
    k2.render_ops(s1, 8)
    host_s = time.perf_counter() - t0
    thread.join()
    if "error" in built:
        raise built["error"]
    engine._kernel_library()
    k2_libs = {label: rendering._render_library() if extra is None
               else rendering.bind_library(build.load_library("render", extra))
               for label, extra in K2_BUILDS}
    augmentations._crop_library()
    rbm._gather_library()
    k5._library()
    t1 = time.perf_counter()
    ptxas = {}
    for name, extra in ([(name, None) for name in build.KERNEL_SOURCES]
                        + [("render", K2_BUILDS[1][1]), ("control_step", K1_NO_OBSTACLES)]):
        with open(build.ptxas_path(name, extra)) as f:
            ptxas[name if extra is None else f"{name} {' '.join(extra)}"] = " | ".join(
                line.strip() for line in f if "registers" in line or "spill" in line)
    print(f"K1-K5 built with nvcc ({', '.join(build.KERNEL_SOURCES)}, render.cu with "
          f"{K2_BUILDS[1][0]} beside the shipped {K2_BUILDS[0][0]}, and control_step.cu with "
          f"{' '.join(K1_NO_OBSTACLES)}, in parallel) in "
          f"{built['s']:.2f} s, all loaded after {t1 - t0:.2f} s; ptxas {json.dumps(ptxas)}; "
          f"K1's and K2's op-counting host builds (g++) meanwhile, done after {host_s:.2f} s")

    # phase 2: every kernel against its plain version
    errs = {"K1": max(phase_kernel_vs_plain(torch, engine, checks, device),
                      phase_k1_pose_vs_plain(torch, engine, checks, device),
                      phase_learned_reward_kernels_vs_plain(torch, engine, checks, k2, device),
                      phase_k1_bin_vs_plain(torch, engine, checks, device)),
            "K2": phase_k2_vs_plain(torch, checks, k2, k2_libs, device),
            "K3": phase_k3_vs_plain(torch, device),
            "K4": max(phase_k4_vs_plain(torch, device), phase_k4_routed_vs_plain(torch, device)),
            "K4 pixel": max(phase_k4_pixel_vs_plain(torch, device),
                            phase_k4_copy_paths_vs_plain(torch, device)),
            "K5": phase_k5_vs_plain(torch, k5_checks, device)}
    if kernels_only:
        phase_k5_times(torch, k5_checks, device, card)
        print(f"--kernels: every kernel built and held against its plain version; "
              f"{time.perf_counter() - t0:.1f} s from the first build")
        return 0

    # phase 3: the actor path, the state learner path, the pixel path
    actor_launches, env, agent, carry, run_chunk = phase_actor_path(torch, device)
    learner_launches, rates, l_env, l_agent, l_rb, l_config, l_carry, l_run = \
        phase_learner_path(torch, device, card)
    pixel_launches, p_rates, p_env, p_agent, p_rb, p_config, p_carry, p_run = \
        phase_pixel_path(torch, device, card)
    t_rlpd = time.perf_counter()
    rlpd_launches_path, rlpd_per_update, rlpd_info, r_agent, r_rb, r_config, r_carry, r_run = \
        phase_rlpd_path(torch, device, card)
    rlpd_s = {"path": time.perf_counter() - t_rlpd}
    t_new = time.perf_counter()
    pixel_rlpd_launches_path, pixel_rlpd_per_update, pixel_rlpd_info = \
        phase_pixel_rlpd_path(torch, device, card)
    new_s = {"pixel_rlpd": time.perf_counter() - t_new}
    t_new = time.perf_counter()
    resnet_launches, resnet_info = phase_resnet_path(torch, device, card, resnet_checks)
    new_s["resnet"] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    trained_launches = phase_resnet_trained(torch, device, card, *resnet_info.pop("ring"))
    new_s["resnet_trained"] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    pcb_launches, pcb_per_update, pcb_info = phase_pcb_path(torch, device, card)
    new_s["pcb"] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    peg_launches, peg_per_update, peg_info = phase_peg_pixel_path(torch, device, card)
    new_s["peg_pixels"] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    cable_launches, cable_want, cable_info = phase_cable_route_path(torch, device, card)
    new_s["cable_route"] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    vice_launches, vice_want, vice_info = phase_vice_path(torch, device, card)
    new_s["vice"] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    bc_launches, bc_want, bc_info = phase_bc_path(torch, device, card)
    new_s["bc"] = time.perf_counter() - t_new
    fwbw = {}
    for mode in ("state", "pixels", "classifier"):
        t_new = time.perf_counter()
        fwbw[mode] = phase_fwbw_path(torch, device, card, mode)
        new_s[f"fwbw_{mode}"] = time.perf_counter() - t_new

    # phase 4: times
    rows = phase_times(torch, engine, checks, device, card, env, agent, carry, run_chunk)
    lrows = phase_learner_times(torch, device, card, l_agent, l_rb, l_config, l_carry, l_run)
    prows = phase_pixel_times(torch, device, card, k2, k2_libs, p_env, p_agent, p_rb, p_config,
                              p_carry, p_run)
    t_k5 = time.perf_counter()
    k5rows = phase_k5_times(torch, k5_checks, device, card)
    new_s["k5_times"] = time.perf_counter() - t_k5
    t_rlpd = time.perf_counter()
    rlpd_rows = phase_rlpd_times(torch, device, card, r_agent, r_rb, r_config, r_carry, r_run)
    rlpd_s["times"] = time.perf_counter() - t_rlpd
    t_new = time.perf_counter()
    k1_walls = phase_k1_bin_times(torch, engine, checks, device, card)
    new_s["k1_walls_times"] = time.perf_counter() - t_new

    per_iter = {"actor": ACTOR_LAUNCHES,  # the whole actor path, not per iteration
                "learner": learner_launches_per_iter(l_config.utd_ratio,
                                                     l_config.updates_per_iter),
                "pixel": pixel_launches_per_iter(p_config.utd_ratio, p_config.updates_per_iter),
                "rlpd": rlpd_per_update,  # per updating iteration
                "pixel_rlpd": pixel_rlpd_per_update,  # per updating iteration
                "resnet": pixel_launches_per_iter(BENCH_RESNET["utd_ratio"],
                                                  BENCH_RESNET["updates_per_iter"]),
                "resnet_trained": {k: v // RESNET_TRAINED_UPDATES
                                   for k, v in trained_launches.items()},  # per update_high_utd
                "pcb": pcb_per_update, "peg_pixels": peg_per_update,  # per updating iteration
                # the learned-reward paths: whole paths, as the actor's
                "cable_route": cable_want, "vice": vice_want, "bc": bc_want,
                # the fwbw paths: whole paths
                **{f"fwbw_{m}": fwbw[m][1] for m in fwbw}}
    kernels = kernel_table(rows, lrows, prows, k5rows, errs,
                           {"actor": actor_launches, "learner": learner_launches,
                            "pixel": pixel_launches, "rlpd": rlpd_launches_path,
                            "pixel_rlpd": pixel_rlpd_launches_path, "resnet": resnet_launches,
                            "resnet_trained": trained_launches, "pcb": pcb_launches,
                            "peg_pixels": peg_launches, "cable_route": cable_launches,
                            "vice": vice_launches, "bc": bc_launches,
                            **{f"fwbw_{m}": fwbw[m][0] for m in fwbw}},
                           per_iter, ptxas)
    for kernel in kernels:
        if kernel["name"] == "replay_gather":
            kernel["rlpd_sample"] = {k: rlpd_rows[k] for k in ("sample_mixed", "sample")}
        if kernel["name"] == "control_step":
            # the obstacle input (the bin walls, M = 8) on the fwbw path
            kernel["with_walls_by_envs"] = {str(n): r for n, r in k1_walls.items()}
    print(f"learner rates: {rates['env_steps_s']:.1f} env-steps/s, {rates['updates_s']:.1f} "
          f"critic updates/s [{card}]")
    print(f"pixel rates: {p_rates['env_steps_s']:.1f} env-steps/s, {p_rates['updates_s']:.1f} "
          f"critic updates/s [{card}]")
    print(f"RLPD: demo collection {rlpd_info['demo_ms']:.1f} ms ({rlpd_info['demo_success']} of "
          f"{rlpd_info['demo_episodes']} expert episodes succeeded, demo ring of "
          f"{rlpd_info['demo_streams']} streams); sample_mixed "
          f"{rlpd_rows['sample_mixed']['ms']:.4f} ms per call against sample's "
          f"{rlpd_rows['sample']['ms']:.4f}; iteration {rlpd_rows['iteration_ms']:.3f} ms; "
          f"the RLPD path's phase took {rlpd_s['path']:.1f} s and its times' "
          f"{rlpd_s['times']:.1f} s (host clock; the times' parts "
          f"{json.dumps({k: round(v, 1) for k, v in rlpd_rows['seconds'].items()})}) [{card}]")
    print(f"pixel RLPD: demo collection {pixel_rlpd_info['demo_ms']:.1f} ms "
          f"({pixel_rlpd_info['demo_success']} of {pixel_rlpd_info['demo_episodes']} expert "
          f"episodes succeeded, demo ring of {pixel_rlpd_info['demo_streams']} streams); "
          f"iteration {pixel_rlpd_info['iteration_ms']:.3f} ms [{card}]")
    print(f"ResNet rates: {resnet_info['env_steps_s']:.1f} env-steps/s, "
          f"{resnet_info['updates_s']:.1f} critic updates/s [{card}]")
    print(f"PCB (state): {pcb_info['demo_successes']} of {pcb_info['demo_episodes']} expert "
          f"episodes succeeded; demos and bank {pcb_info['demo_s']:.2f} s; three runs with pause "
          f"and resume {pcb_info['runs_s']:.2f} s. Peg (pixels): {peg_info['demo_successes']} of "
          f"{peg_info['demo_episodes']} expert episodes succeeded; {peg_info['env_steps_s']:.1f} "
          f"env-steps/s, {peg_info['updates_s']:.1f} critic updates/s [{card}]")
    print(f"cable route: {cable_info['env_steps_s']:.1f} env-steps/s, "
          f"{cable_info['updates_s']:.1f} critic updates/s; classifier "
          f"{json.dumps(cable_info['classifier'])}; demo classifier-success-step frac "
          f"{cable_info['demo_frac']:.3f}. VICE: bce_loss {vice_info['bce']}, grad_norm "
          f"{vice_info['grad_norm']}. BC: NLL {bc_info['nll_first']:.3f} -> "
          f"{bc_info['nll_last']:.3f}, eval {json.dumps(bc_info['eval'])} [{card}]")
    for mode, (_, _, info) in fwbw.items():
        print(f"fwbw {mode}: {info['env_steps_s']:.1f} env-steps/s, {info['updates_s']:.1f} critic "
              f"updates/s (both learners), {info['warmup']} warm-up iterations, demos "
              f"{json.dumps(info['demos'])}" + (f", evaluation {json.dumps(info['evaluation'])}"
                                                if info["evaluation"] else "") + f" [{card}]")
    print("the pixel RLPD, ResNet, trained ResNet, pose, learned-reward, fwbw and timing phases' "
          "seconds (host clock): "
          + json.dumps({k: round(v, 1) for k, v in new_s.items()}))
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax", "serl_tpu."))
           or m == "serl_tpu"]
    if bad:
        return fail(f"the port pulled in JAX or serl_tpu modules: {bad[:5]}")
    print(f"total {time.perf_counter() - t0:.1f} s from the first build")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main(kernels_only=sys.argv[1:] == ["--kernels"])
    except Exception as exc:  # every phase failure ends the run with no result line
        import traceback

        traceback.print_exc()
        code = fail(f"{type(exc).__name__}: {exc}")
    sys.exit(code)
