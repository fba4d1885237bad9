#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ldso_tpu_torch``) once on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one result line each (any failure raises and exits non-zero):
  1. device: the card's name and power limit, torch/CUDA versions and the
     float32 precision flags;
  2. build: compile every kernel of the main path from ``ldso_tpu_torch/csrc``
     (the pyramid, the tracker levels, the trace and activation kernels
     of ``trace.cu`` (built with ``-fmad=false``), the BA linearization of
     ``ba.cu``, the bootstrap's GN loop of ``init_level.cu`` and the motion
     prediction of ``predict.cu`` (``-fmad=false``), each source its own
     nvcc, started together, with the tracker's, the trace source's, the BA
     source's, the bootstrap's and the prediction's ``ptxas -v`` reports
     beside them: registers, shared memory, spills of each kernel),
     and the tracker kernel again with ``-DTRACK_LEVEL_PHASES`` (its clock64
     phase stamps)
     and the native image loader ``ldso_tpu_torch/native/loader.cc``
     (host C++; if it cannot be built the reason is printed and the Python
     decoders serve phase 7); meanwhile a pool of worker processes, one
     per CPU core up to 8, renders the bench and loop sequences and phase
     7's dataset in chunks of frames, and the dataset is written to a
     temporary directory (``scripts/torch_tum_fixture.py``);
  3. kernel vs plain: the one-launch pyramid kernel against
     ``build_pyramid_torch`` at every shape the drives below give it
     (640x480 at B = 1 and at the batch of phase 6 (b), 320x240 loop
     frames at B = 1, an undistorted float32 640x480 frame of phase 7's
     reader at B = 1), at B = 8 and at the partial-tile size 208x176, on
     rendered frames (uint8) and random float32 images, at 5 levels; then
     CUDA-event timings at 640x480 uint8: the
     kernel's device time at B = 1 and B = 8 (launches queued behind a
     spin kernel, so the host's launch rate does not pace them), the time
     of a whole call of the wrapper, the plain version, and the bytes
     bound computed from the shapes;
  4. main path: sync ``FullSystem`` at the untouched ``preset("default")``
     (corner-biased seeding on) over the 120-frame bench sequence (seed 3,
     corridor, forward_arc, 640x480, uint8), checked against the
     ground-truth trajectory (ATE <= 6% of extent) and for corner-seeded
     activations; the prediction kernel once and the tracker kernel 2
     times per tracked frame (the coarse levels of every hypothesis, then
     the winner's fine levels), the trace kernel once per tracked frame and the activation
     kernel once per keyframe built, the BA kernel once an evaluation
     (``count_ba``) and the bootstrap kernel once a level of each tracked
     bootstrap frame (``count_bootstrap``), as in every later drive; the
     frames to initialize and the bootstrap's seconds, whole (first
     ``add_frame`` to initialized) and a frame; frames 40..59 traced with
     torch.profiler (device kernels per frame, the device's busy share,
     host and device ms of the pyramid, the tracker, the trace and the
     keyframe path, and of the keyframe path's stages per keyframe:
     activation, BA, the finish with its marginalization, the seeding and
     tracker-ref rebuild; ``run_ba``'s host time split by part,
     ``ba_split``, with the calls of ``precompute_pairs``, the pair tables
     in torch, that the kernel's path no longer makes; each hand kernel's
     device ms a frame), the tracking and
     trace inputs of frames 20, 60 and 100 kept, the activation and
     ``run_ba`` inputs of the first two keyframes after frame 20 and one
     point fold's, and the bootstrap's: the pyramids of ``set_first`` and
     of each ``CoarseInitializer.track`` call, and the arguments of every
     ``init2f.init_level`` call;
  4b. the tracker kernel on those real inputs: at each of the five levels,
     as ``track_frame`` chains them, the kernel (a one-level launch)
     against ``track_level_torch`` (T, ab, the rmse of every lane, the
     counts), the iterations each level ran; on each frame the two-launch
     frame bit for bit against one-level launches chained on their own
     outputs (the winner too) and against a second run, and the whole
     ``track_frame`` against the plain chain; on frame 60 each level's
     device ms, microseconds an iteration and cluster size beside its bound
     and the plain version's ms, the two launches' device ms, the clock64
     phase breakdown of each level (the instrumented library), the device
     kernels of one ``track_frame`` call of each version and of one whole
     ``fused_step`` (torch.profiler; the kernel path under STEP_MAX_EVENTS,
     beside the plain tracker's and the plain tracker and trace's); one
     ``track_frame`` under ``torch.cuda.set_sync_debug_mode("error")`` (no
     host sync);
  4c. the trace and activation kernels on those real inputs: on frames 20,
     60 and 100 the trace kernel against ``frame_step._trace_core_torch``
     (``check_trace``: every bank field, best_uv and best_idepth of GOOD
     rows, rows that part only at a tie of the plain run's own numbers,
     at most TRACE_MAX_TIES a frame) and bit for bit against a second
     launch; on the two keyframes the activation kernel against
     ``trace.activate_candidates_torch`` (``check_activate``), a second
     launch and, bit for bit, its order replayed in torch
     (``activate_replay``); the slot tables each kernel makes against the
     torch tables, bit for bit (``trace_table_compare``,
     ``activation_table_compare``; phase 4 also counts 0 calls of
     ``trace_slot_tables`` and ``activation_slot_tables`` on the main
     path); on frame 60 and the first keyframe each kernel's device ms
     beside the bound this run's data needs and the plain version's ms, and
     the device kernels of one ``activate_candidates_device`` call of each
     version;
  4d. the BA linearization kernel on those real windows: ``assemble`` in
     modes active and fej and ``energy_only`` on the two ``run_ba`` windows,
     and mode fej on the point fold's, against the plain versions
     (``check_ba``: H, b, H_xd, H_dd, b_d, e_pair, the energy, the masks
     and the count, the tie rule, bit for bit against a second launch, and
     the pair tables the kernel makes against ``ba_slot_tables``,
     ``ba_table_compare``), each whole ``run_ba`` against the plain one
     (``check_run_ba``: the same lambda ladder unless it parts at an
     energy tie, then the state); on the first window the launch's device
     ms beside the bound this window's data needs, the whole call's ms and
     host ms and the plain version's ms, and the device kernels of one
     ``run_ba`` call of each version (none of them ``precompute_pairs``'
     on the kernel's path);
  4e. the bootstrap kernel (K6) on those real inputs: each bootstrap
     frame's levels, on the plain chain's inputs, against
     ``init2f.init_level_torch`` (``check_init_frame``: T, energy, good and
     the depths to the bounds of tests/test_torch_init.py, a level whose
     accept ladders part at a tie held to G1's bounds, bit for bit against
     a second launch), the whole bootstrap on the kept pyramids against the
     plain one (``check_bootstrap``: the same frames snap and finish, G1's
     bounds on ``results()``), one level at 2048 points, a width the main
     path never reaches (``wide_init_levels``, ``check_init_frame``), and
     on the last bootstrap frame each level's device ms, microseconds an
     iteration, plain ms and bound, with the launch's cluster shape;
  4f. the motion prediction kernel (K7) on the T_last and T_prelast of
     frames 20, 60 and 100: its hypotheses bit for bit the plain chain's
     (``tracker.predict_hypotheses_torch`` on the card) and a second
     launch's (``check_predict``), and on frame 60 the launch's device ms,
     the whole call's host ms, the plain chain's host ms and device kernels,
     and the bound;
  5. loop closure: the loop sequence of the JAX package's
     ``bench.py::bench_loop_closure`` (``preset("default")``, 320x240, 240
     frames, seed 5, out_and_back, uint8) driven twice, loop closure off
     and then on (a synchronous ``LoopClosing(train_after=4)`` attached
     through ``on_keyframe`` / ``loop_closing``), then relocalization on a
     revisited view. The loop-on drive must close >= 1 loop, run the pose
     graph and keep ATE <= 6% of extent;
  6. async modes, each on a fresh ``FullSystem`` at ``preset("default")``,
     fed free-running and ended by ``finish_mapping()`` and ``shutdown()``:
     (a) ``async_mapping=True`` over the first 80 frames of the 640x480
     bench sequence (cut from 120 to keep the script near ten minutes: the
     mapping thread also runs in (b) and the per-frame async path in (c),
     both at full length); (b) ``async_mapping=True, pipeline_depth=8,
     batch_size=4`` over all 120 ((b) drops the last frame if the tracked
     frames would otherwise be a multiple of 4, so that the tail flush of
     fewer than 4 frames runs);
     (c) ``async_mapping=True`` with an ``AsyncLoopClosing(train_after=4)``
     over the loop sequence. Each must lose no frame, export a pose per
     frame, build >= 3 keyframes with >= 1 marginalized, keep ATE <=
     max(1.5 x the sync ATE of the same sequence in this run, 6%), leave no
     worker thread alive, and launch the pyramid kernel exactly as often
     as expected (once per frame; in (b) once per bootstrap frame, per
     full batch and per tail frame) and the tracker, trace and activation
     kernels as phase 4 does; (c) must close >= 1 loop and run the
     pose graph. Frames/s (host clock, whole drive with its drain) and the
     submit-to-pose latency are printed beside the sync drive's;
  7. dataset path: 120 frames of the bench sequence written to disk in the
     TUM-monoVO layout (640x480 PNGs in a zip, through an FOV lens with
     omega 0.5, a gamma 2.2 response, a radial vignette and per-frame
     exposures; ``camera.txt`` in crop mode), then
     (a) ``ldso_tpu_torch.cli.main(["run", "--dataset", "tum", ...])``
     in-process at ``--preset default`` with the default flags (sync, loop
     closing attached), writing a trajectory, a metrics file and the viz
     dumps: return code 0, no frame lost, >= 110 finite poses read back
     from the trajectory file, ATE against the renderer's ground truth <=
     6% of extent, one metrics line per tracked frame (frame ids
     consecutive from the end of the bootstrap to the last frame), a PLY
     with > 0 points, one pyramid launch per frame fed, the tracker, trace
     and activation kernels as phase 4 does (in (b) too);
     (b) resume through the Python API: run A takes frames 0..119 with
     ``save_checkpoint`` after frame 59, run B is ``load_checkpoint`` on the
     card and frames 60..119; the positions of the two trajectories must
     agree to 1e-3 (the bound of tests/test_system.py::TestCheckpointResume);
     printed beside them: the decoder that served the frames, decode ms,
     device ms of response + vignette + remap, whole ``get_image`` ms,
     checkpoint bytes and save / load seconds.
  8. distributed solvers (``ldso_tpu_torch/distributed``, ``graft_entry``):
     the toy window of ``eval/toys.make_synthetic_window`` at
     ``preset("default")`` (10 slots, 2048 points, D = 84), 640x480, 10
     frames, each a one-level pyramid build (K1's one-level branch, also
     held against the plain version in phase 3 at 640x480, 320x240 and
     128x96 on float32), built once here and written through
     ``convert.to_numpy``; then ``distributed_rank`` in (a, c, d, e) 4 gloo
     ranks sharing the card (NCCL refuses two ranks on one device) and (b)
     1 NCCL rank, started with ``spawn`` and held by ``check_distributed``:
     the sharded BA step against the single-process ``_solve_core`` step
     (the JAX package's bounds: x 3e-3, idepth 5e-3, energy 2%), one
     all-reduce of 7,225 floats per step, energy down over 3 steps, a 2x2
     mesh against 1-D; the edge-sharded PGO on a 24-KF test circle and
     the block-halo PGO on the 4096-KF, 40-loop test curve against
     ``optimize_pose_graph``, solved twice with bitwise-equal results (its
     scatter-adds sum in a fixed order); ``graft_entry.dryrun_multichip``;
     replicated results bitwise equal on every rank; the BA kernel launched
     once a sharded step in every rank and once an evaluation of the
     references. A rank that fails, or has not ended within
     ``DIST_TIMEOUT_S``, fails the phase.
Then a JSON line of per-kernel results (pyramid, track_level, trace,
activate, ba_assemble, init_level, predict), the card line again, and as the
last line ``{"ok": true, "device": {...}}``. There is no CPU path; the CPU
tests (tests/test_torch_distributed.py) run phase 8's rank program at
``preset("tiny")``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

N_FRAMES = 120
N_WARM = 10                  # frames excluded from the steady-state rate
W, H, LEVELS = 640, 480, 5
# |kernel - plain| <= atol + RTOL·|plain|, the bounds of the JAX package's
# Pallas-vs-XLA pyramid check (tests/test_frontend.py): the 2x2 means are
# summed in another order, and a one-ulp difference in a level's
# intensity moves gsq (up to ~1.6e4 on 8-bit images) by more than 1e-3
PYR_ATOL, GSQ_ATOL, RTOL = 1e-4, 1e-3, 1e-6
ATE_MAX_PCT = 6.0            # the repo's ATE qualification floor (README)
# the JAX package's own accuracy on the same sequences, measured on a TPU
# (BENCH_r05.json): sync bench ATE, and the loop pair off -> on
REF_SYNC_ATE, REF_LOOP_OFF_ATE, REF_LOOP_ON_ATE = 1.93, 3.09, 2.80
LOOP_FRAMES, LOOP_W, LOOP_H = 240, 320, 240
PART_W, PART_H = 208, 176    # not a multiple of the kernel's 64x32 tile; 13 wide at level 4
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores, data sheet
SPIN_CYCLES = 20_000_000     # ~10 ms: holds the stream while the host queues the launches
BATCH = 4
N_ASYNC_A = 80               # frames of phase 6 (a)
TUM_OMEGA = 0.5              # FOV lens of phase 7's dataset
N_RESUME = 60                # phase 7 (b): the checkpoint is taken after frame 59
RESUME_ATOL = 1e-3           # tests/test_system.py::TestCheckpointResume's bound
MIN_POSES = 110              # of 120, in the trajectory file of phase 7 (a)
DIST_RANKS = 4               # phase 8: gloo ranks sharing the one card
DIST_FRAMES = 10             # phase 8's toy window: 640x480, one per slot of the default preset
DIST_TIMEOUT_S = 300.0       # a phase-8 rank run that has not ended by then fails
# phase 8's problems, of the JAX package's tests (tests/test_distributed.py):
# a circle (seed, LM, CG), the one of its recovery test, on which the energy
# and S are held to the single process too; the 4096-KF, 40-loop curve
# (K, loops, LM, CG)
DIST_SPEC = dict(preset="default", ba_steps=3, circle=[(3, 15, 80)],
                 curve=(4096, 40, 6, 40), dryrun=True)
# the tracker kernel against its plain version (phase 4's check): the
# bounds of tests/test_torch_tracker.py::test_track_frame (float32 LM on
# both sides, sums in another order), counts within 1% of the level's points
TRACK_T_ATOL, TRACK_AB_ATOL, TRACK_RMSE_RTOL, TRACK_COUNT_FRAC = 2e-4, 2e-3, 2e-3, 0.01
# an accept decision on a step that changes the energy per point by at most
# this much (relative) is a tie: the two versions' energies at one state
# differ by up to ~2e-6 relative (sums of up to 2048 float32 terms in
# another order). A lane whose runs part at such a tie keeps T, rmse and
# counts to the bounds above and ab to TRACK_TIE_AB_ATOL: on bench frame 60,
# level 2, the kernel and the plain version end 8.4e-3 apart in ab, and the
# JAX package and the port's plain version part the same way on one CPU,
# 4.2e-3 apart (scripts/parity_track_level_replay.py; PERF.md, Findings).
# More than TRACK_MAX_TIES such lanes in one frame fail the check.
TRACK_TIE_RTOL, TRACK_TIE_AB_ATOL, TRACK_MAX_TIES = 1e-5, 2e-2, 2
TRACK_CAPTURE = (20, 60, 100)     # bench frames whose tracking inputs phase 4 keeps
TRACK_PROFILE = tuple(range(40, 60))   # bench frames phase 4 traces with torch.profiler
TRACK_MAX_EVENTS = 50             # device kernels one track_frame call may take (42-44 seen)
TRACK_LAUNCHES = 2                # tracker kernel launches a tracked frame: coarse, then fine
# device kernels and copies one fused_step may take, the port's aim (ROADMAP):
# 352-353 on the card while the prediction (one se3_log, 27 se3_exp) took
# ~270 eager torch launches; since it is one launch (K7), the tracker's 42-44,
# the trace's one and the score, affine and diag's ~21 are most of the rest
STEP_MAX_EVENTS = 200
# flops of one point evaluation in csrc/track_level.cu's evaluate: every
# point xh 4, X 18, z test 2, projection 3 + 4, bounds 4, bilinear sample
# 33, residual and Huber 9 (77); a point with omega > 0 also J 31 and the
# H / b / E sums 99 (130)
TRACK_FLOPS_POINT, TRACK_FLOPS_OK = 77, 130
# flops of one LM step (lm_step_warp and the accept test, counted once for
# the lane, as one thread would do them):
# damping 27, LU of the 8x9 system 372, back substitution 64, negation 8,
# the SE(3) exponential and T_new 260, accept / lambda / max|step| 20
TRACK_FLOPS_STEP = 751
# the trace and activation kernels against their plain versions (phase 4c),
# on the _trace_core arguments of TRACK_CAPTURE's frames and the activation
# arguments of the first ACT_KEEP keyframes after bench frame ACT_AFTER.
# Both follow torch's rounding operator by operator, but the small matrix
# products (cuBLAS) and torch's reductions fix their own orders: a bank
# field within TRACE_ATOL + TRACE_RTOL |plain| (best_uv within TRACE_UV_ATOL
# px on GOOD rows), an activation's idepth within ACT_IDEPTH_ATOL +
# ACT_IDEPTH_RTOL |plain| and its sums (80 terms here in the JAX package's
# order, there in one reduction) within ACT_SUM_ATOL + ACT_SUM_RTOL |plain|.
# A row whose plain run decides within TRACE_TIE_RTOL of a threshold (or
# samples within TRACE_TIE_PX of the in-bounds border) is a tie, which two
# correct float32 versions may decide apart (trace_ties); more than
# TRACE_MAX_TIES (ACT_MAX_TIES) such rows parting in one frame (keyframe)
# fail the check
ACT_AFTER, ACT_KEEP = 20, 2
TRACE_RTOL, TRACE_ATOL, TRACE_UV_ATOL = 1e-5, 1e-6, 1e-3
ACT_IDEPTH_RTOL, ACT_IDEPTH_ATOL, ACT_SUM_RTOL, ACT_SUM_ATOL = 1e-4, 1e-6, 1e-3, 1e-2
TRACE_TIE_RTOL, TRACE_TIE_PX, TRACE_MAX_TIES, ACT_MAX_TIES = 1e-5, 1e-3, 4, 4
# flops of csrc/trace.cu's trace_bank, as one thread does them: a valid
# row's ray, segment, predictions, interval and status 191; a sample's
# position 5 and per sweep point its bounds test 6; per sweep point of an
# in-bounds sample the bilinear intensity 15, the difference, its square
# and the sum 3; a GN step 8 x 45 (the (I, dx, dy) sample 37, residual,
# gradient and products 8) + 25 (sums and step); a slot's table row once
# (lie.cuh's se3_exp times T_eval 240, the inverse 15, the product by
# T_new_cw 84, the affine transfer 8: ~350)
TRACE_FLOPS_ROW, TRACE_FLOPS_SAMPLE, TRACE_FLOPS_BOUNDS = 191, 5, 6
TRACE_FLOPS_SAMPLE_IN, TRACE_FLOPS_GN, TRACE_FLOPS_SLOT = 18, 385, 350
# flops of its activate_bank, per evaluation of a candidate row: a sample
# of a valid target slot, its projection and bounds test 32; an in-bounds
# sample's (I, dx, dy) 37, residual, Jd, Huber weight and the four terms
# 27; a slot's four 8-point sums and their addition 32; an entry of the
# [F, F] tables once (the product 84, the affine transfer 4, with the
# slots' inverses and gains)
ACT_FLOPS_SAMPLE, ACT_FLOPS_IN, ACT_FLOPS_SLOT, ACT_FLOPS_PAIR = 32, 64, 32, 100
# the BA linearization kernel against its plain version (phase 4d), on the
# windows of the first ACT_KEEP run_ba calls after bench frame ACT_AFTER and
# of one marginalize_points call that folds. The kernel sums in another
# order than torch's einsums (float32 sums of up to 163,840 terms: a point's
# samples in lane order, then the points of 32 slices in point order, then
# the slices), so an entry moves by a few float32 roundings of the sum of
# its absolute terms, however far they cancel: every entry within K4_RTOL
# |plain| + K4_ATOL_FRAC x the Cauchy-Schwarz bound on that sum
# (ba_compare; a gradient entry of b can be 1e-4 of its terms, and the
# plain version itself moves by up to 8e-6 of them between the CPU and the
# card), H_dd and e_pair (sums of non-negative terms) against their
# array's largest, the energy within K4_E_RTOL. The
# masks and the residual count are decisions on the same projections, so
# equal, but for a pair with a sample (or its FEJ centre) within
# TRACE_TIE_PX of the in-bounds border, where the two versions'
# coordinates, a few ulps apart, may fall on either side (a tie). Pairs
# that part at a tie are dropped from res_mask and both versions run again,
# held as above; more than K4_MAX_TIES such pairs in one window fail the
# check
K4_RTOL, K4_ATOL_FRAC, K4_E_RTOL, K4_MAX_TIES = 1e-4, 1e-5, 1e-5, 4
# a whole run_ba against the plain one: the same lambda ladder, unless the
# runs part at a step whose trial energy is within K4_LADDER_TIE_RTOL of the
# energy it is tested against (a tie, reported); then x within K4_X_ATOL, c
# within K4_C_RTOL |plain| and p_idepth within K4_IDEPTH_ATOL +
# K4_IDEPTH_RTOL |plain| (tests/test_torch_ba.py's bounds for a few float32
# LM steps from one state), the masks after the tail equal but for at most
# K4_MAX_TIES pairs
K4_LADDER_TIE_RTOL, K4_X_ATOL, K4_C_RTOL, K4_IDEPTH_RTOL, K4_IDEPTH_ATOL = (
    1e-5, 2e-4, 1e-4, 2e-3, 1e-4)
# flops of csrc/ba.cu's ba_kernel, per sample as one lane does them: a
# requested sample's projection and bounds test 32; a valid sample's FEJ
# centre 35, (I, dx, dy) 37, residual and weights 15, Jacobians 190, its
# terms of the pair's 149 words 430 and of the point's 106 words 290 (1000;
# the transported residual of mode fej 45 more); in energy_only a valid
# sample's (I, dx, dy), residual, weight and energy 60. The pair-table
# entry each lane of a slot group makes again (~130) is not work the
# evaluation needs: the [F, F] tables are ~150 flops an entry
K4_FLOPS_REQ, K4_FLOPS_VALID, K4_FLOPS_FEJ, K4_FLOPS_ENERGY = 32, 1000, 45, 60
# the bootstrap kernel (K6) against its plain version (phase 4e), level by
# level on the plain chain's inputs of every bench bootstrap frame: the
# bounds of tests/test_torch_init.py::test_init_level (T atol, idepth and iR
# atol + rtol |plain|, energy rtol; float32 GN over 1024 points x 8 samples,
# sums in another order), good equal but for INIT_POINTS_PARTED points, and
# idepth and iR within their bounds but for INIT_POINTS_PARTED points: a
# weakly held point's depth moves by more than its bound when the plain
# version's own idepth0 moves by one ulp (up to 373 points of 1024 on a
# bench level: scripts/torch_init_sensitivity.py). Where a level misses the
# depth bounds and the two accept ladders part first at an energy tie (E' within
# INIT_TIE_RTOL of E, relative, in both runs: a decision the float32 sums
# cannot resolve), the level is counted and its depths are held to G1's
# bounds instead (tests/test_torch_init.py::test_bootstrap_sequence, after
# results()'s scale normalization: INIT_G1_*), T, energy and good still to
# the bounds above. After the snap the joint scale of t and the depths is a
# free gauge (ROADMAP G1): the energy is flat along it, the last steps of a
# level are ties, and any level may part; before the snap the priors pin
# the gauge, and more than INIT_MAX_PARTED such levels in one bootstrap
# frame fail the check
INIT_T_ATOL, INIT_ID_RTOL, INIT_ID_ATOL, INIT_E_RTOL, INIT_POINTS_PARTED = (
    1e-4, 2e-3, 2e-4, 1e-3, 2)
INIT_TIE_RTOL, INIT_MAX_PARTED = 1e-5, 1
# phase 4e's check at a width the main path never reaches: one level (L2,
# the third of the chain) of the first bootstrap frame at 2048 points
WIDE_POINTS, WIDE_LEVEL = 2048, 2
INIT_G1_BOTH, INIT_G1_IDEPTH, INIT_G1_ROT, INIT_G1_COS = 0.98, 0.01, 5e-3, 0.999
# flops of csrc/init_level.cu, as one thread does them: a sample's ray,
# projection and bounds test 36 in every evaluation; a sample with om > 0
# also its bilinear (I, dx, dy) 33, residual and Huber weight 9, Jx and Jd
# 49, its terms of the sums 124 (215); a point's level coordinates, prior
# and counts 12 an evaluation; a point's Schur terms 100 and update 30 an
# iteration, beside its median (K (K - 1) / 2 compare-swaps of 2); a step
# (the damped 8x9 system 99, LU 400, back substitution 64, the exponential
# and T' 260, the rest 17) 840 an iteration
INIT_FLOPS_SAMPLE, INIT_FLOPS_OK, INIT_FLOPS_POINT = 36, 215, 12
INIT_FLOPS_UPDATE, INIT_FLOPS_STEP = 130, 840
# flops of csrc/predict.cu (K7), as one thread does them (a product, sum,
# division, square root or transcendental 1, a fused multiply-add 2): once,
# the inverse 21, the two pose products 192 and the logarithm 231 (the
# quaternion 51, so3_log 30, so3_left_jacobian 99, solve33 51); a
# hypothesis, its tangent 6 and the exponential 167 (coefficients 17, K K 54,
# R and V 72, V rho 18, the tangent's squares 6)
PREDICT_FLOPS_ONCE, PREDICT_FLOPS_HYP = 444, 173


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _kernel_name(symbol: str) -> str:
    """The function's own name in an Itanium-mangled symbol (``_Z17f...``, or
    ``_ZN<scope...>1fE...`` for a function in a namespace)."""
    import re

    nested, names, i = symbol.startswith("_ZN"), [], 3 if symbol.startswith("_ZN") else 2
    while i < len(symbol):
        m = re.match(r"\d+", symbol[i:])
        if not m:
            break
        n, i = int(m.group()), i + len(m.group())
        names.append(symbol[i:i + n])
        i += n
        if not nested:
            break
    return names[-1] if names else symbol


def ptxas_kernels(report: str) -> str:
    """Each kernel's registers, shared memory and spills from a ``ptxas
    -v`` report, as "name: ..."."""
    import re

    out, name = [], "?"
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", ln)
        if m:
            name = _kernel_name(m.group(1))
            continue
        if "registers" in ln or "spill" in ln:
            out.append(f"{name}: {ln.split('info    : ')[-1].strip()}")
    return "; ".join(out)


def _time_ms(fn, reps: int = 20, inner: int = 20) -> float:
    """Median per-call device time (CUDA events) after warm-up."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _host_ms(fn, n: int = 50) -> float:
    """Median host-clock ms of one call of ``fn`` (no synchronize: what the
    call costs the calling thread), after warm-up; the stream is drained
    every 10 calls."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
        if i % 10 == 9:
            torch.cuda.synchronize()
    return statistics.median(times)


def _device_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Median device time per call: ``n`` calls are queued behind a spin
    kernel that holds the stream, so they run back to back on the card
    however slowly the host launches them."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def pyramid_bound_ms(b: int, h: int, w: int, levels: int, in_bytes: int) -> tuple:
    """The least time the card could take for one pyramid build: the
    larger of its bytes (the frame read once; 12 B of stack and 4 B of gsq
    written per pixel of every level) over the memory rate and its
    operations (per pixel 2 subtractions, 2 halvings, 2 products and a
    sum, and 4 operations per pooled pixel) over the float32 rate."""
    px = sum((h >> l) * (w >> l) for l in range(levels))
    t_bytes = b * (h * w * in_bytes + 16 * px) / HBM_BYTES_PER_S
    t_ops = b * (7 * px + 4 * (px - h * w)) / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_pyramid(name: str, img, levels: int = LEVELS) -> tuple:
    """Hold one launch of the pyramid kernel against the plain version on
    ``img`` ([H, W] or [B, H, W], uint8 or float32, on the card): shapes,
    |kernel - plain| <= atol + RTOL·|plain|, and exactly one launch.
    Returns (max|err| of the stacks, max|err| of gsq)."""
    import torch

    from ldso_tpu_torch.kernels import pallas_pyramid
    from ldso_tpu_torch.kernels.pyramid import build_pyramid_torch

    n0 = pallas_pyramid.LAUNCHES
    pyr_k, gsq_k = pallas_pyramid.build_pyramid_cuda(img, levels)
    if pallas_pyramid.LAUNCHES != n0 + 1:
        raise RuntimeError(f"one pyramid build must be one launch, counted "
                           f"{pallas_pyramid.LAUNCHES - n0} on {name}")
    pyr_p, gsq_p = build_pyramid_torch(img, levels)
    torch.cuda.synchronize()
    if any(a.shape != b.shape for a, b in zip(pyr_k + gsq_k, pyr_p + gsq_p)):
        raise RuntimeError(f"pyramid kernel output shapes differ on {name}")
    e_pyr = max(float((a - b).abs().max()) for a, b in zip(pyr_k, pyr_p))
    e_gsq = max(float((a - b).abs().max()) for a, b in zip(gsq_k, gsq_p))
    ok = all(bool(((a - b).abs() <= atol + RTOL * b.abs()).all())
             for outs_k, outs_p, atol in ((pyr_k, pyr_p, PYR_ATOL),
                                          (gsq_k, gsq_p, GSQ_ATOL))
             for a, b in zip(outs_k, outs_p))
    if not ok:
        raise RuntimeError(f"pyramid kernel disagrees on {name}: max|err| pyr "
                           f"{e_pyr} gsq {e_gsq} (atol {PYR_ATOL} / {GSQ_ATOL}, "
                           f"rtol {RTOL})")
    print(f"kernel pyramid vs plain [{name}]: max|err| pyr {e_pyr:.3g}, "
          f"gsq {e_gsq:.3g} (bounds: atol {PYR_ATOL} / {GSQ_ATOL} + rtol {RTOL}"
          f"·|plain|)", flush=True)
    return e_pyr, e_gsq


def _sequence(n: int, w: int, h: int, seed: int, traj_kind: str):
    from ldso_tpu_torch.io.synthetic import SyntheticDataset

    return SyntheticDataset(w=w, h=h, n=n, seed=seed, scene_kind="corridor",
                            traj_kind=traj_kind, supersample=1, cache=False)


def _render_frames(n: int, w: int, h: int, seed: int, traj_kind: str, lo: int,
                   hi: int) -> list:
    """Frames lo..hi-1 of an n-frame sequence, as (uint8 image, ts, exposure)."""
    import numpy as np

    ds = _sequence(n, w, h, seed, traj_kind)
    frames = []
    for i in range(lo, hi):
        img, ts, expo = ds.get_image(i)
        frames.append((np.clip(np.round(img), 0, 255).astype(np.uint8), ts, expo))
    return frames


def _render_bench(n: int, w: int = W, h: int = H, seed: int = 3,
                  traj_kind: str = "forward_arc", pool=None):
    """A sequence as bench.py::_render_frames renders it: corridor,
    supersample 1, uint8 (default: the 640x480 bench sequence, seed 3,
    forward_arc). With an executor ``pool``, chunks of 30 frames are
    rendered on its workers. Returns (dataset, frames)."""
    if pool is None:
        frames = _render_frames(n, w, h, seed, traj_kind, 0, n)
    else:
        parts = [pool.submit(_render_frames, n, w, h, seed, traj_kind, lo, min(lo + 30, n))
                 for lo in range(0, n, 30)]
        frames = [f for p in parts for f in p.result()]
    return _sequence(n, w, h, seed, traj_kind), frames


def _ate_pct(system, ds) -> float:
    import numpy as np

    from ldso_tpu_torch.eval.ate import ate_rmse

    _, poses = system.export_trajectory()
    if not np.isfinite(poses).all():
        raise RuntimeError("non-finite poses in the exported trajectory")
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt = [ds.gt_pose_c_w(i) for i in ids]
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    return 100.0 * rmse / float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))


def drive_bench(cfg, ds, frames, dev, sync, probe=None) -> dict:
    """Phase 4: sync FullSystem over ``frames``; fails on a lost frame, no
    initialization, no marginalization, no corner-seeded activation or
    ATE above the floor. A ``probe`` (``BenchProbe``) is called before and
    after each frame; the frames it profiles stay out of the rate."""
    from ldso_tpu_torch.system import FullSystem

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    t_frames, statuses, n_corner_act = [], [], 0
    t0 = time.perf_counter()
    for i, (img_np, ts, expo) in enumerate(frames):
        if probe is not None:
            probe.before(i)
        t_a = time.perf_counter()
        st = system.add_frame(img_np, ts, expo)
        sync()
        t_frames.append(time.perf_counter() - t_a)
        if probe is not None:
            probe.after(i)
        statuses.append(st["status"])
        n_corner_act += st.get("n_corner_act", 0)
        if st["status"] == "lost":
            raise RuntimeError(f"lost at frame {st['frame_id']}: {st}")
    system.finish_mapping()
    system.shutdown()
    fps_all = len(frames) / (time.perf_counter() - t0)
    if not system.initialized or system.is_lost:
        raise RuntimeError(f"not initialized or lost: {statuses}")
    n_marg = sum(1 for k in system.kfs.values() if not k.in_window)
    if n_marg < 1:
        raise RuntimeError("no keyframe left the window: marginalization never ran")
    if cfg.selector.corner_fraction > 0 and n_corner_act < 1:
        raise RuntimeError("no corner-seeded activation: the corner path never ran")
    ate = _ate_pct(system, ds)
    if not ate <= ATE_MAX_PCT:
        raise RuntimeError(f"ATE {ate:.3f}% of extent > {ATE_MAX_PCT}%")
    profiled = set(probe.profile) if probe is not None else set()
    t_rate = [t for i, t in enumerate(t_frames) if i >= N_WARM and i not in profiled]
    return dict(ate=ate, n_tracked=statuses.count("tracked"), n_kf=len(system.kfs),
                n_marg=n_marg, n_corner_act=n_corner_act,
                n_init=statuses.index("initialized") + 1,
                t_boot=t_frames[:statuses.index("initialized") + 1],
                fps=len(t_rate) / sum(t_rate), n_rate=len(t_rate),
                fps_all=fps_all, latency_ms=list(system.frame_latency_ms))


def _clone(x):
    """A copy of a call's arguments: tensors cloned, numpy arrays copied,
    (named) tuples and lists rebuilt, anything else as it is."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, tuple):
        items = [_clone(a) for a in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, list):
        return [_clone(a) for a in x]
    return x


class BenchProbe:
    """Phase 4's instruments, switched on around chosen frames of the drive.

    On the frames of ``capture`` it keeps (cloned) the arguments of
    ``tracker.track_frame``, ``frame_step.fused_step`` and
    ``frame_step._trace_core``: the system's real tracker ref, pyramid,
    hypotheses, bank and state. From frame ``act_after`` + 1 on it keeps
    the arguments (and keywords) of the first ``act_keep`` calls of
    ``trace.activate_candidates_device`` (one a keyframe), of the first
    ``act_keep`` calls of ``ba.solve.run_ba`` and of the first call of
    ``ba.marginal.marginalize_points`` that folds points. Over the frames
    of ``profile`` it runs ``torch.profiler`` with the pyramid build, the
    tracker, the trace and the keyframe path each under a
    ``record_function`` label, and inside the keyframe path the
    activation, the BA, the finish (marginalization) and the seeding and
    tracker-ref rebuild, and inside the BA its parts (``BA_LABELS``); it
    keeps the host-clock wall time. From frame 0 to the end of the
    bootstrap it keeps the arguments of the bootstrap's calls
    (``_watch_bootstrap``: ``boot``)."""

    LABELS = ("pyramid", "tracker", "trace", "keyframe", "kf_activate", "run_ba", "finish_kf",
              "seed_ref")
    KF_STAGES = LABELS[4:]
    # inside run_ba: each assemble, the pair tables in torch (only the plain
    # version makes them there: 0 calls on the kernel's path), the damped
    # solve, the step, the state deltas of the energy and the loop
    BA_LABELS = ("ba_assemble", "ba_precompute", "ba_solve_core", "ba_apply_step",
                 "ba_state_delta")
    # the hand kernels, by the name torch.profiler gives their device events
    # (ba_assemble: this source's, and the two of the earlier two-launch
    # version, which a parent checkout driven with these instruments
    # launches)
    KERNELS = {"pyramid": ("pyramid_kernel",), "track_level": ("track_levels_kernel",),
               "trace": ("trace_bank_kernel",), "activate": ("activate_bank_kernel",),
               "ba_assemble": ("ba_kernel", "ba_linearize_kernel", "ba_reduce_kernel"),
               "init_level": ("init_level_kernel",), "predict": ("predict_kernel",)}

    def __init__(self, capture, profile, act_after: int = ACT_AFTER, act_keep: int = ACT_KEEP):
        self.capture, self.profile = tuple(capture), tuple(profile)
        self.act_after, self.act_keep = act_after, act_keep
        self.inputs, self.activations, self.ba_calls, self.marg_calls = {}, [], [], []
        self.boot, self._boot_undo, self._n_boot = [], [], 0
        self.prof, self.wall_s, self._t0 = None, 0.0, 0.0
        self._undo, self._keepers = [], {}

    def _patch(self, obj, name, wrap):
        orig = getattr(obj, name)
        setattr(obj, name, wrap(orig))
        self._undo.append((obj, name, orig))

    def _restore(self):
        while self._undo:
            obj, name, orig = self._undo.pop()
            setattr(obj, name, orig)

    def _keep(self, i: int, obj, name: str, store: list, n: int, wanted=None) -> None:
        """From frame act_after + 1 on, keep (cloned) the arguments and
        keywords of the first ``n`` calls of ``obj.name`` (those for which
        ``wanted(*args)`` holds), then unpatch."""
        key = (id(obj), name)
        orig = self._keepers.get(key)
        if orig is not None and len(store) >= n:
            setattr(obj, name, orig)
            del self._keepers[key]
        elif orig is None and i > self.act_after and len(store) < n:
            orig = self._keepers[key] = getattr(obj, name)

            def kept(*args, **kw):
                if len(store) < n and (wanted is None or wanted(*args)):
                    store.append((_clone(args), _clone(dict(kw))))
                return orig(*args, **kw)

            setattr(obj, name, kept)

    def _keepers_step(self, i: int) -> None:
        import numpy as np

        from ldso_tpu_torch import trace as trace_mod
        from ldso_tpu_torch.ba import marginal, solve

        self._keep(i, trace_mod, "activate_candidates_device", self.activations, self.act_keep)
        self._keep(i, solve, "run_ba", self.ba_calls, self.act_keep)
        self._keep(i, marginal, "marginalize_points", self.marg_calls, 1,
                   lambda win, mask, *rest: bool(np.asarray(mask).any()))

    def _watch_bootstrap(self) -> None:
        """Keep (cloned) the arguments of every ``CoarseInitializer.set_first``
        and ``track`` call, a record each in ``boot`` (``pyr``, with
        set_first's ``gsq``), and of every ``init2f.init_level`` call, as
        (args, keywords) in the ``levels`` of the record of the call it
        serves."""
        from ldso_tpu_torch import init2f

        cls, boot = init2f.CoarseInitializer, self.boot
        first, track, level = cls.set_first, cls.track, init2f.init_level

        def kept_first(init, pyr, gsq):
            boot.append(dict(pyr=_clone(pyr), gsq=_clone(gsq), levels=[]))
            return first(init, pyr, gsq)

        def kept_track(init, pyr_new):
            boot.append(dict(pyr=_clone(pyr_new), levels=[]))
            return track(init, pyr_new)

        def kept_level(*args, **kw):
            boot[-1]["levels"].append((_clone(args), _clone(kw)))
            return level(*args, **kw)

        for obj, name, fn in ((cls, "set_first", kept_first), (cls, "track", kept_track),
                              (init2f, "init_level", kept_level)):
            self._boot_undo.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)

    def before(self, i: int) -> None:
        import torch

        from ldso_tpu_torch import frame_step, lifecycle, tracker
        from ldso_tpu_torch.ba import residuals, solve
        from ldso_tpu_torch.system import FullSystem

        if i == 0:
            self._watch_bootstrap()
        self._n_boot = len(self.boot)
        self._keepers_step(i)
        if i in self.capture:
            rec = self.inputs.setdefault(i, {})

            def keep(key):
                def wrap(fn):
                    def kept(*args):
                        rec[key] = _clone(args)
                        return fn(*args)
                    return kept
                return wrap

            self._patch(tracker, "track_frame", keep("track"))
            self._patch(frame_step, "fused_step", keep("step"))
            self._patch(frame_step, "_trace_core", keep("trace"))
        if self.profile and i == self.profile[0]:
            def label(name):
                def wrap(fn):
                    def labelled(*args, **kw):
                        with torch.profiler.record_function(name):
                            return fn(*args, **kw)
                    return labelled
                return wrap

            for obj, attr, name in ((frame_step, "build_pyramid", "pyramid"),
                                    (tracker, "track_frame", "tracker"),
                                    (frame_step, "_trace_core", "trace"),
                                    (FullSystem, "_make_keyframe", "keyframe"),
                                    (lifecycle, "kf_activate", "kf_activate"),
                                    (solve, "run_ba", "run_ba"),
                                    (FullSystem, "_finish_kf", "finish_kf"),
                                    (FullSystem, "_dispatch_seed", "seed_ref"),
                                    (FullSystem, "_seed_new_kf", "seed_ref"),
                                    (FullSystem, "_update_tracker_ref", "seed_ref"),
                                    (solve, "assemble", "ba_assemble"),
                                    (residuals, "precompute_pairs", "ba_precompute"),
                                    (solve, "_solve_core", "ba_solve_core"),
                                    (solve, "apply_step", "ba_apply_step"),
                                    (solve, "state_delta", "ba_state_delta")):
                self._patch(obj, attr, label(name))
            act = torch.profiler.ProfilerActivity
            self.prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
            self.prof.__enter__()
            self._t0 = time.perf_counter()

    def after(self, i: int) -> None:
        # the bootstrap ends at the first frame that neither selects nor tracks
        while self._boot_undo and len(self.boot) == self._n_boot:
            obj, name, orig = self._boot_undo.pop()
            setattr(obj, name, orig)
        self._keepers_step(i)
        if self.profile and i == self.profile[-1]:
            self.wall_s = time.perf_counter() - self._t0
            self.prof.__exit__(None, None, None)
            self._restore()
        elif i in self.capture:
            self._restore()

    def summary(self) -> dict:
        """Launches per frame, the device's busy share of the window, host
        and device ms per frame of each label (and per call), the hand
        kernels' device ms per frame (``kernels``) and the split of
        ``run_ba`` (``ba_split``)."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        labels = self.LABELS + self.BA_LABELS
        dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in labels]
        n = len(self.profile)
        busy_us = sum(e.device_time_total for e in dev)
        out = dict(frames=n, launches_per_frame=len(dev) / n, wall_ms=1e3 * self.wall_s / n,
                   busy=busy_us / (1e6 * self.wall_s) if dev else None)
        for name in labels:
            ev = [e for e in events if e.name == name and e.device_type == DeviceType.CPU]
            host = sum(e.cpu_time_total for e in ev) / 1e3
            device = sum(e.device_time_total for e in ev) / 1e3
            out[name] = dict(calls=len(ev), host_ms=host / n, device_ms=device / n,
                             host_ms_call=host / max(len(ev), 1),
                             device_ms_call=device / max(len(ev), 1))
        out["kernels"] = {k: sum(e.device_time_total for e in dev
                                 if any(sym in e.name for sym in syms)) / (1e3 * n)
                          for k, syms in self.KERNELS.items()}
        out["ba_split"] = ba_split(events, out, labels)
        return out


def ba_split(events, out: dict, labels) -> dict:
    """``run_ba``'s host ms per call, split by what it runs: the labelled
    parts (``BenchProbe.BA_LABELS``; ``precompute_pairs``, the pair tables
    in torch, is called only by the plain version: ``precompute_calls``),
    the host syncs made directly in ``run_ba`` (``aten::item``: the
    energies' and the tail's ``float()`` / ``int()``), its copies between
    host and card (the outermost ``aten::to``: the prior's upload and the
    tail's ``.cpu()`` readbacks), and the rest (the energy expressions, the
    tail's masks, the loop-invariant set-up). Device ms per call: the torch
    ops under the label, and the hand kernel's own device time (its
    launches go through ctypes, outside every label)."""
    from torch.autograd import DeviceType

    def owner(e):
        """The nearest labelled ancestor's name, and whether an ``aten::to``
        lies between (so that only the outermost copy counts)."""
        nested, p = False, e.cpu_parent
        while p is not None and p.name not in labels:
            nested |= p.name in ("aten::to", "aten::_to_copy")
            p = p.cpu_parent
        return (p.name if p is not None else None), nested

    calls = max(out["run_ba"]["calls"], 1)
    syncs = copies = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or e.name not in ("aten::item", "aten::to",
                                                              "aten::_to_copy"):
            continue
        name, nested = owner(e)
        if name != "run_ba" or nested:
            continue
        if e.name == "aten::item":
            syncs += e.cpu_time_total
        elif e.cpu_parent is None or e.cpu_parent.name != "aten::to":
            copies += e.cpu_time_total
    n = out["frames"]
    part = {k: out[k]["host_ms"] * n / calls for k in BenchProbe.BA_LABELS}
    split = dict(calls=out["run_ba"]["calls"], host_ms=out["run_ba"]["host_ms"] * n / calls,
                 device_ms=out["run_ba"]["device_ms"] * n / calls,
                 kernel_device_ms=out["kernels"]["ba_assemble"] * n / calls,
                 assemble_calls=out["ba_assemble"]["calls"] / calls,
                 precompute_calls=out["ba_precompute"]["calls"] / calls, syncs=syncs / 1e3 / calls,
                 copies=copies / 1e3 / calls, **part)
    split["rest"] = split["host_ms"] - sum(part[k] for k in BenchProbe.BA_LABELS
                                           if k != "ba_precompute") - split["syncs"] \
        - split["copies"]
    return split


def _hand_launches() -> int:
    """Launches of every hand kernel so far, by their wrappers' counters."""
    from ldso_tpu_torch.kernels import ba, pallas_pyramid, track_level
    from ldso_tpu_torch.kernels import trace as trace_kernel

    # a package without the bootstrap or the prediction kernel (an earlier
    # checkout), or one that has not imported it yet, has launched none
    later = [sys.modules.get(f"ldso_tpu_torch.kernels.{m}") for m in ("init_level", "predict")]
    return (pallas_pyramid.LAUNCHES + track_level.LAUNCHES + trace_kernel.LAUNCHES_TRACE
            + trace_kernel.LAUNCHES_ACTIVATE + ba.LAUNCHES
            + sum(m.LAUNCHES for m in later if m is not None))


def _reset_launches() -> None:
    """Zero every hand kernel's launch counter (a phase's count starts)."""
    from ldso_tpu_torch.kernels import ba, init_level, pallas_pyramid, predict, track_level
    from ldso_tpu_torch.kernels import trace as trace_kernel

    for k in (pallas_pyramid, track_level, trace_kernel, ba, init_level, predict):
        k.reset_launches()


def _device_events(fn) -> tuple:
    """(device events, their device ms) of one call of ``fn`` (warmed up
    once first): torch.profiler's kernels, copies and sets, in which the
    hand kernels count by their wrappers' launch counters read around the
    same profiled call (the profiler has been seen to miss a lone ctypes
    launch); the ms are those of the events the profiler saw."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    hand = [k for names in BenchProbe.KERNELS.values() for k in names]
    n0 = _hand_launches()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launched = _hand_launches() - n0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    torch_ops = [e for e in dev if not any(k in e.name for k in hand)]
    return len(torch_ops) + launched, sum(e.device_time_total for e in dev) / 1e3


@contextlib.contextmanager
def plain_tracker():
    """Within the block, ``tracker.track_frame`` runs its level chain
    through the plain version ``track_level_torch`` also on the card
    (``tracker._run_levels_plain``): the yardstick of the kernel, never the
    port's path."""
    from ldso_tpu_torch import tracker

    kernel = tracker._run_levels
    tracker._run_levels = tracker._run_levels_plain
    try:
        yield
    finally:
        tracker._run_levels = kernel


def _footprint_texels(lv, kw, Ts) -> int:
    """The distinct texels of a level's [h, w, 3] stack whose bilinear
    corners an evaluation at each pose of ``Ts`` [M, 4, 4] reads, as
    csrc/track_level.cu's evaluate places them (a point not in bounds reads
    the corners at (2, 2))."""
    import torch

    _, uv, idepth, _, valid, _, _, intr = lv
    w, h = kw["w"], kw["h"]
    fx, fy, cx, cy = intr
    xh = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                      torch.ones_like(idepth)], -1)
    X = torch.einsum("mij,nj->mni", Ts[:, :3, :3], xh) + Ts[:, None, :3, 3] * idepth[:, None]
    ok_z = X[..., 2] > 1e-6
    sz = torch.where(ok_z, X[..., 2], torch.ones_like(X[..., 2]))
    un, vn = fx * (X[..., 0] / sz) + cx, fy * (X[..., 1] / sz) + cy
    inb = (un >= 2) & (un < w - 3) & (vn >= 2) & (vn < h - 3) & ok_z & valid
    two = torch.full_like(un, 2.0)
    u0 = torch.where(inb, un, two).floor().long().clamp(0, w - 1)
    v0 = torch.where(inb, vn, two).floor().long().clamp(0, h - 1)
    u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
    return int(torch.cat([v0 * w + u0, v0 * w + u1, v1 * w + u0, v1 * w + u1],
                         -1).unique().numel())


def track_level_bound_ms(lv, kw, out_k) -> tuple:
    """The least time the card could take for one level's LM loop as this
    run's data drove it (``out_k``, the kernel's result on ``lv`` / ``kw``):
    the larger of its bytes over the memory rate and its operations over
    the float32 rate. Bytes: the texels read at the lanes' first and final
    poses (both are evaluated; the steps between read more), 12 B each,
    the N points' uv, idepth, color and valid (17 B) and the lanes' inputs
    and outputs, each once. Operations: per lane, TRACK_FLOPS_POINT for
    each of N points in each of its 1 + n_iter evaluations, TRACK_FLOPS_OK
    more for each point with omega > 0 (the kernel's n_ok summed over
    them), TRACK_FLOPS_STEP an iteration. Returns (ms, bound_by, bytes,
    flops)."""
    import torch

    n, k = lv[1].shape[0], lv[5].shape[0]
    texels = _footprint_texels(lv, kw, torch.cat([lv[5], out_k[0]]))
    n_bytes = (12 * texels + 17 * n + 16 + k * (64 + 8)
               + k * (64 + 8 + 4 + 24 + 4 + 8))
    n_iter = int(out_k[6].sum())
    flops = (TRACK_FLOPS_POINT * n * (k + n_iter) + TRACK_FLOPS_OK * int(out_k[7].sum())
             + TRACK_FLOPS_STEP * n_iter)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, flops)


def track_level_chain(args):
    """Walk one tracked frame's levels as ``tracker.track_frame`` chains
    them, with the plain version: ``args`` are ``track_frame``'s. Yields
    (level, the level's arguments, its keywords, the plain version's
    result); the next level starts from that result (the coarse stage's
    winner by rmse before the first fine level)."""
    import torch

    from ldso_tpu_torch import tracker

    pyr, ref, T_inits, ab_init, intr, cfg = args
    levels, tc = len(pyr), cfg.tracker
    iters = list(tc.max_iterations) + [50] * levels
    intr_l = tracker._level_intrinsics_all(intr, levels)
    K = T_inits.shape[0]
    T, ab = T_inits, ab_init.expand(K, 2).contiguous()
    coarse = list(range(levels - 1, max(levels - 3, 0), -1))
    fine = list(range(max(levels - 3, 0), -1, -1))
    rm = None
    for l in coarse + fine:
        if l == fine[0]:
            inf = float("inf")
            best = torch.argmin(torch.nan_to_num(rm, nan=inf, posinf=inf, neginf=inf))[None]
            T, ab = T.index_select(0, best), ab.index_select(0, best)
        lv = (pyr[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l], T, ab, intr_l[l])
        kw = dict(w=pyr[l].shape[1], h=pyr[l].shape[0],
                  iters=min(int(iters[l]), 12) if l in coarse else int(iters[l]),
                  cutoff=float(tc.coarse_cutoff_th * (2.0 ** l)), huber_th=float(tc.huber_th),
                  lam0=float(tc.lambda_initial), lam_success=float(tc.lambda_success),
                  lam_fail=float(tc.lambda_fail), step_eps=float(tc.step_eps))
        out_p = tracker.track_level_torch(*lv, **kw)
        yield l, lv, kw, out_p
        T, ab, rm = out_p[0], out_p[1], out_p[2]


def cap_walk(lv, kw):
    """Run one level's kernel and plain version again with the iteration
    cap at 1, 2, ... up to the level's own; yields (cap, the kernel's
    result, the plain version's)."""
    from ldso_tpu_torch import tracker
    from ldso_tpu_torch.kernels import track_level as ktl

    for cap in range(1, kw["iters"] + 1):
        kc = dict(kw, iters=cap)
        yield cap, ktl.track_level_cuda(*lv, **kc), tracker.track_level_torch(*lv, **kc)


def _tie_parting(lv, kw, lane: int):
    """Where lane ``lane`` of one level's kernel and plain runs part: both
    are run again with the iteration cap at 1, 2, ... (``cap_walk``); at
    the first cap where the lane's T or ab differ by more than a hundredth
    of the bounds (the states one cap before agree), exactly one version
    must have moved (accepted a step the other rejected, or took a step
    where the other had stopped), on a step that changed its own energy
    per point (rmse², what the accept test compares) by at most
    TRACK_TIE_RTOL: a decision that the float32 sums cannot resolve.
    Returns (cap, which version moved, the relative energy change), or
    None if the runs part otherwise."""
    import torch

    prev = None
    for cap, out_k, out_p in cap_walk(lv, kw):
        k, p = [t[lane] for t in out_k], [t[lane] for t in out_p]
        if (float((k[0] - p[0]).abs().max()) > TRACK_T_ATOL / 100
                or float((k[1] - p[1]).abs().max()) > TRACK_AB_ATOL / 100):
            if prev is None:
                return None
            moved = [not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
                     for a, b in ((k, prev[0]), (p, prev[1]))]
            if moved[0] == moved[1]:
                return None
            before, after = (prev[0], k) if moved[0] else (prev[1], p)
            e0, e1 = float(before[2]) ** 2, float(after[2]) ** 2
            rho = (e0 - e1) / max(e0, 1e-12)
            if not 0.0 <= rho <= TRACK_TIE_RTOL:
                return None
            return dict(cap=cap, moved="kernel" if moved[0] else "plain", rho=rho)
        prev = (k, p)
    return None


def check_track_level(name: str, args, time_it: bool = False) -> list:
    """Hold the tracker kernel against the plain version on one tracked
    frame's real inputs (``args`` of ``tracker.track_frame``), level by
    level as ``track_frame`` chains them: the plain chain's inputs go to
    both at each level. Per lane: T within TRACK_T_ATOL, rmse within
    TRACK_RMSE_RTOL (the 27 coarse lanes one by one), counts within
    TRACK_COUNT_FRAC of N_l, and ab within TRACK_AB_ATOL unless the two
    runs part at a tie (``_tie_parting``), then within TRACK_TIE_AB_ATOL;
    at most TRACK_MAX_TIES tied lanes over the frame. Returns a record per
    level (coarsest first); with ``time_it`` also the kernel's device ms
    and the plain version's host-clock ms."""
    import torch

    from ldso_tpu_torch import tracker
    from ldso_tpu_torch.kernels import track_level as ktl

    records = []
    for l, lv, kw, out_p in track_level_chain(args):
        out_k = ktl.track_level_cuda(*lv, **kw)
        torch.cuda.synchronize()
        n_l, k_l, h, w = lv[1].shape[0], lv[5].shape[0], kw["h"], kw["w"]
        d_T = (out_k[0] - out_p[0]).abs().flatten(1).amax(1)
        d_ab = (out_k[1] - out_p[1]).abs().amax(1)
        d_rm = (out_k[2] - out_p[2]).abs() / out_p[2].abs().clamp(min=1e-6)
        d_n = torch.stack([(a - b).abs() for a, b in zip(out_k[3:6], out_p[3:6])]).amax(0)
        ties = {}
        for lane in torch.nonzero(d_ab > TRACK_AB_ATOL).flatten().tolist():
            tie = _tie_parting(lv, kw, lane)
            if tie is None:
                raise RuntimeError(
                    f"tracker kernel disagrees on {name}, level {l}, lane {lane}: max|dab| "
                    f"{float(d_ab[lane]):.3g} (atol {TRACK_AB_ATOL}), and the two runs do not "
                    f"part at a tie: ab kernel {out_k[1][lane].tolist()} plain "
                    f"{out_p[1][lane].tolist()}")
            ties[lane] = tie
        held = torch.ones_like(d_ab, dtype=torch.bool)
        held[list(ties)] = False
        e_T, e_rm = float(d_T.max()), float(d_rm.max())
        e_ab = float(d_ab[held].max()) if bool(held.any()) else 0.0
        e_ab_tie = float(d_ab[~held].max()) if ties else 0.0
        e_n = int(d_n.max())
        if not (e_T <= TRACK_T_ATOL and e_ab <= TRACK_AB_ATOL and e_rm <= TRACK_RMSE_RTOL
                and e_n <= TRACK_COUNT_FRAC * n_l and e_ab_tie <= TRACK_TIE_AB_ATOL):
            raise RuntimeError(
                f"tracker kernel disagrees on {name}, level {l} ({k_l} lanes x {n_l} points):"
                f" max|dT| {e_T:.3g} (atol {TRACK_T_ATOL}), max|dab| {e_ab:.3g} (atol "
                f"{TRACK_AB_ATOL}; tied lanes {e_ab_tie:.3g}, atol {TRACK_TIE_AB_ATOL}), rmse "
                f"rel {e_rm:.3g} (rtol {TRACK_RMSE_RTOL}), counts "
                f"{e_n} (at most {TRACK_COUNT_FRAC * n_l:.1f}); rmse kernel "
                f"{out_k[2].tolist()} plain {out_p[2].tolist()}")
        bound, by, n_bytes, flops = track_level_bound_ms(lv, kw, out_k)
        cluster, threads = ktl.launch_config(k_l)
        inf = float("inf")
        rec = dict(level=l, lanes=k_l, points=n_l, w=w, h=h, cap=kw["iters"],
                   cluster=cluster, threads=threads,
                   # the lane the plain chain's winner pick takes from here
                   winner=int(torch.argmin(torch.nan_to_num(out_p[2], nan=inf, posinf=inf,
                                                            neginf=inf))),
                   n_iter=out_k[6].tolist(), e_T=e_T, e_ab=e_ab, e_rm=e_rm, e_n=e_n,
                   bound_ms=bound, bound_by=by, bytes=n_bytes, flops=flops,
                   ties={k: dict(v, d_ab=float(d_ab[k])) for k, v in ties.items()})
        if time_it:
            rec["ms"] = _device_ms(lambda: ktl.track_level_cuda(*lv, **kw))
            # the slowest lane paces the launch
            rec["us_iter"] = 1e3 * rec["ms"] / max(max(rec["n_iter"]), 1)
            rec["plain_ms"] = _timed_ms(lambda: tracker.track_level_torch(*lv, **kw),
                                        torch.cuda.synchronize, reps=3)
        records.append(rec)
    n_ties = sum(len(r["ties"]) for r in records)
    if n_ties > TRACK_MAX_TIES:
        raise RuntimeError(f"tracker kernel on {name}: {n_ties} lanes parted at a tie, more "
                           f"than {TRACK_MAX_TIES}")
    return records


def kernel_level_chain(args):
    """One tracked frame's levels (``args`` of ``tracker.track_frame``) as
    one-level kernel launches chained on their own outputs, the winner
    picked by torch.argmin over nan_to_num between the coarse and the fine
    levels: what the two launches of ``kernels/track_level.track_levels_cuda``
    must give bit for bit. Returns ({level: the one-level call's 8
    outputs}, the winner's index)."""
    import torch

    from ldso_tpu_torch import tracker
    from ldso_tpu_torch.kernels import track_level as ktl

    pyr, ref, T, ab_init, intr, cfg = args
    coarse, fine = tracker.level_plan(pyr, ref, cfg.tracker)
    intr_l = tracker._level_intrinsics_all(intr, len(pyr))
    ab = ab_init.reshape(1, 2).to(T.dtype).expand(T.shape[0], 2).contiguous()
    outs, best = {}, None
    for p in coarse + fine:
        if p is fine[0]:
            inf = float("inf")
            rm = outs[coarse[-1].level][2]
            best = int(torch.argmin(torch.nan_to_num(rm, nan=inf, posinf=inf, neginf=inf)))
            T, ab = T[best:best + 1].contiguous(), ab[best:best + 1].contiguous()
        l = p.level
        outs[l] = ktl.track_level_cuda(
            pyr[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l], T.contiguous(), ab,
            intr_l[p.intr_row], p.w, p.h, p.cap, p.cutoff, float(cfg.tracker.huber_th),
            **tracker._lm_args(cfg.tracker))
        T, ab = outs[l][0], outs[l][1]
    return outs, best


def fused_levels(args):
    """The two launches of a tracked frame (``args`` of
    ``tracker.track_frame``), as ``track_frame`` makes them; their
    ``LevelsOut``."""
    from ldso_tpu_torch import tracker
    from ldso_tpu_torch.kernels import track_level as ktl

    pyr, ref, T_inits, ab_init, intr, cfg = args
    return ktl.track_levels_cuda(pyr, ref, tracker.level_plan(pyr, ref, cfg.tracker),
                                 tracker._level_intrinsics_all(intr, len(pyr)),
                                 T_inits.contiguous(),
                                 ab_init.reshape(2).to(T_inits.dtype).contiguous(),
                                 float(cfg.tracker.huber_th), **tracker._lm_args(cfg.tracker))


def written_levels(out, plan):
    """(field, level, the entries the two launches wrote) of a frame's
    ``LevelsOut``: every lane at a coarse level, lane 0 at a fine one; then
    the winner."""
    from ldso_tpu_torch.kernels import track_level as ktl

    coarse, fine = plan
    for p in coarse + fine:
        lanes = out.rmse.shape[1] if p in coarse else 1
        for field, x in zip(ktl.LevelsOut._fields, out[:8]):
            yield field, p.level, x[p.level, :lanes]
    yield "best", None, out.best


def check_track_frame(name: str, args, recs) -> dict:
    """The two-launch frame on one tracked frame's real inputs: bit for bit
    the one-level calls chained on the kernel's own outputs, winner
    included (``kernel_level_chain``); the same bits in a second run; the
    whole ``track_frame`` reading them; and the plain chain on the card:
    T within TRACK_T_ATOL, ab within TRACK_AB_ATOL and rmse within
    TRACK_RMSE_RTOL, unless the frame's level check (``recs``) found a lane
    parted at a tie that reaches the pose (a lane of a fine level, or at a
    coarse level the winner of either chain): then ab within
    TRACK_TIE_AB_ATOL and rmse not held. Returns a record."""
    import torch

    from ldso_tpu_torch import tracker
    from ldso_tpu_torch.kernels import track_level as ktl

    pyr, ref, _, _, _, cfg = args
    plan = tracker.level_plan(pyr, ref, cfg.tracker)
    a, b = fused_levels(args), fused_levels(args)
    outs, best = kernel_level_chain(args)
    for (field, l, x), (_, _, y) in zip(written_levels(a, plan), written_levels(b, plan)):
        if not torch.equal(x, y):
            raise RuntimeError(f"{name}: two runs of the two-launch frame differ in {field} "
                               f"at level {l}")
        z = torch.tensor([best], dtype=x.dtype, device=x.device) if l is None else \
            outs[l][ktl.LevelsOut._fields.index(field)]
        if not torch.equal(x, z):
            raise RuntimeError(f"{name}: the two-launch frame's {field} at level {l} is not "
                               f"bitwise the chained one-level calls': {x.tolist()} against "
                               f"{z.tolist()}")
    res_k = tracker.track_frame(*args)
    if not (torch.equal(res_k.T, a.T[0, 0]) and torch.equal(res_k.ab, a.ab[0, 0])):
        raise RuntimeError(f"{name}: track_frame's pose is not the two launches' level 0")
    with plain_tracker():
        res_p = tracker.track_frame(*args)
    d_T = float((res_k.T - res_p.T).abs().max())
    d_ab = float((res_k.ab - res_p.ab).abs().max())
    d_rmse = float(((res_k.rmse - res_p.rmse).abs() / res_p.rmse.abs().clamp(min=1e-6)).max())
    winners = (best, [r for r in recs if r["lanes"] > 1][-1]["winner"])
    reach = [(r["level"], lane) for r in recs for lane in r["ties"]
             if r["lanes"] == 1 or lane in winners]
    ab_atol = TRACK_TIE_AB_ATOL if reach else TRACK_AB_ATOL
    if not (d_T <= TRACK_T_ATOL and d_ab <= ab_atol
            and (reach or d_rmse <= TRACK_RMSE_RTOL)):
        raise RuntimeError(f"{name}: track_frame with the kernel parts from the plain version:"
                           f" max|dT| {d_T:.3g} (atol {TRACK_T_ATOL}), max|dab| {d_ab:.3g} "
                           f"(atol {ab_atol}), rmse rel {d_rmse:.3g} (rtol {TRACK_RMSE_RTOL}"
                           f"{', not held' if reach else ''}); ties reaching the pose "
                           f"(level, lane): {reach}")
    return dict(best=best, d_T=d_T, d_ab=d_ab, d_rmse=d_rmse, reach=reach)


def track_phase_row(ph, n_iter) -> dict:
    """From an instrumented launch's [K, P] phases (``kernels/track_level.
    PHASE_NAMES``, or its first 8 for an older kernel): cycles per
    evaluation of each phase (the step's parts too) and per iteration of
    the whole level, of the lane with the most evaluations (the lane that
    paces the launch)."""
    from ldso_tpu_torch.kernels import track_level as ktl

    ph = ph.cpu().tolist()
    lane = max(range(len(ph)), key=lambda k: (ph[k][7], -k))
    row = ph[lane]
    out = {name: row[i] / max(row[7], 1) for i, name in enumerate(ktl.PHASE_NAMES)
           if i < len(row) and i not in (6, 7)}
    out.update(level_cycles=row[6], evaluations=row[7],
               cycles_per_iteration=row[6] / max(int(n_iter[lane]), 1))
    return out


def _phase_keys(row: dict) -> list:
    """The phases of ``track_phase_row``'s record, in ``PHASE_NAMES`` order."""
    from ldso_tpu_torch.kernels import track_level as ktl

    return [n for i, n in enumerate(ktl.PHASE_NAMES) if i not in (6, 7) and n in row]


def track_level_phases(args) -> list:
    """The instrumented kernel (``-DTRACK_LEVEL_PHASES``) at each level of a
    tracked frame, on the plain chain's inputs: ``track_phase_row`` a level."""
    from ldso_tpu_torch.kernels import track_level as ktl

    rows = []
    for l, lv, kw, _ in track_level_chain(args):
        out = ktl.track_level_cuda(*lv, **kw, phases=True)
        rows.append(dict(level=l, **track_phase_row(out[8], out[6])))
    return rows


def _iters_text(rec: dict) -> str:
    """A level's iterations: the lane's count, or over many lanes the
    largest and the sum."""
    it = rec["n_iter"]
    if len(it) == 1:
        return f"{it[0]} of {rec['cap']}"
    return f"max {max(it)} of {rec['cap']}, {sum(it)} over {len(it)} lanes"


def _check_track_launches(phase: str, launched: int, tracked: int, predicted: int) -> None:
    """Two tracker launches for each tracked frame (the coarse levels of
    every hypothesis, then the winner's fine levels) and one prediction
    launch (K7: the hypotheses)."""
    if launched != TRACK_LAUNCHES * tracked:
        raise RuntimeError(f"{phase}: tracker kernel launched {launched} times for "
                           f"{tracked} tracked frames, expected {TRACK_LAUNCHES * tracked}")
    if predicted != tracked:
        raise RuntimeError(f"{phase}: prediction kernel launched {predicted} times for "
                           f"{tracked} tracked frames")


def predict_bound_ms(num: int) -> tuple:
    """The least time the card could take for one prediction launch:
    (ms, "bytes" or "operations", bytes, flops). Bytes: T_last whole, T_prelast's
    rows 0-2, each hypothesis written once; flops: PREDICT_FLOPS_*."""
    n_bytes = 64 + 48 + 64 * num
    flops = PREDICT_FLOPS_ONCE + num * PREDICT_FLOPS_HYP
    by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS_PER_S
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", n_bytes,
            flops)


def ulp_text(a, b) -> str:
    """Where two float32 tensors of one shape part: the count of entries
    whose bits differ, the largest gap in ulps and its index."""
    import torch

    ia, ib = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    # the bits as an ordered integer line (negative floats mirrored)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    gap = (ia - ib).abs().flatten()
    if not int((gap > 0).sum()):
        return "bit for bit"
    i = int(torch.argmax(gap))
    idx = tuple(int(v) for v in torch.unravel_index(torch.tensor(i), a.shape))
    return (f"{int((gap > 0).sum())} of {gap.numel()} entries part, at most {int(gap[i])} ulps "
            f"at {idx} ({float(a.flatten()[i])!r} against {float(b.flatten()[i])!r})")


def check_predict(name: str, step, time_it: bool = False) -> dict:
    """K7 on one frame's prediction inputs (``fused_step``'s T_last and
    T_prelast, kept by ``BenchProbe``): the kernel's hypotheses bit for bit
    the plain chain's on the card (``tracker.predict_hypotheses_torch``) and
    a second launch's. With ``time_it`` also the launch's device ms (queued
    behind a spin kernel), the whole call's host ms, the plain chain's host
    ms (its eager launches), and the bound."""
    from ldso_tpu_torch import tracker
    from ldso_tpu_torch.kernels import predict

    T_last, T_prelast, cfg = step[2], step[3], step[-1]
    num = cfg.shapes.num_hypotheses
    n0 = predict.LAUNCHES
    out_k = predict.predict_hypotheses_cuda(T_last, T_prelast, num)
    out_k2 = predict.predict_hypotheses_cuda(T_last, T_prelast, num)
    out_p = tracker.predict_hypotheses_torch(T_last, T_prelast, num)
    if predict.LAUNCHES != n0 + 2:
        raise RuntimeError(f"{name}: two prediction calls made {predict.LAUNCHES - n0} launches")
    if not _bits_equal(out_k, out_k2):
        raise RuntimeError(f"{name}: a second prediction launch parts: {ulp_text(out_k2, out_k)}")
    if not _bits_equal(out_k, out_p):
        raise RuntimeError(f"{name}: the prediction kernel parts from the plain chain: "
                           f"{ulp_text(out_k, out_p)}")
    rec = dict(num=num)
    if time_it:
        kernel = lambda: predict.predict_hypotheses_cuda(T_last, T_prelast, num)  # noqa: E731
        rec["ms"] = _device_ms(kernel)
        rec["host_ms"] = _host_ms(kernel)
        rec["plain_host_ms"] = _host_ms(
            lambda: tracker.predict_hypotheses_torch(T_last, T_prelast, num))
        rec["plain_kernels"], rec["plain_ms"] = _device_events(
            lambda: tracker.predict_hypotheses_torch(T_last, T_prelast, num))
        rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["flops"] = predict_bound_ms(num)
    return rec


def _check_trace_launches(phase: str, traced: int, activated: int, tracked: int,
                          keyframes: int) -> None:
    """One trace launch for each tracked frame (every tracked frame is
    traced: trace_every 1) and one activation launch for each keyframe
    built (``FullSystem._make_keyframe``, counted by ``count_keyframes``)."""
    if traced != tracked or activated != keyframes:
        raise RuntimeError(f"{phase}: trace kernel launched {traced} times for {tracked} "
                           f"tracked frames, activation kernel {activated} times for "
                           f"{keyframes} keyframes built")


@contextlib.contextmanager
def count_keyframes():
    """Within the block, count the keyframes ``FullSystem`` builds
    (``_make_keyframe`` calls, on whichever thread); yields a one-item list
    holding the count."""
    import threading

    from ldso_tpu_torch.system import FullSystem

    made, lock = [0], threading.Lock()
    build = FullSystem._make_keyframe

    def counted(self, *args, **kw):
        with lock:
            made[0] += 1
        return build(self, *args, **kw)

    FullSystem._make_keyframe = counted
    try:
        yield made
    finally:
        FullSystem._make_keyframe = build


@contextlib.contextmanager
def plain_trace():
    """Within the block, ``frame_step._trace_core`` and
    ``trace.activate_candidates_device`` run their plain versions also on
    the card: the yardstick of the kernels, never the port's path."""
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch import trace as trace_mod

    kernels = frame_step._trace_core, trace_mod.activate_candidates_device
    frame_step._trace_core = frame_step._trace_core_torch
    trace_mod.activate_candidates_device = trace_mod.activate_candidates_torch
    try:
        yield
    finally:
        frame_step._trace_core, trace_mod.activate_candidates_device = kernels


def trace_details(args) -> tuple:
    """``frame_step._trace_core_torch`` on ``args`` (its arguments), with
    what ``trace.trace_points`` decides on kept (its ``details``), plus the
    runner-up SSD anywhere but the best sample (a near-tie with it can move
    the argmin), the options and the frame's size: (new bank, details)."""
    import torch

    from ldso_tpu_torch import frame_step

    rep = {}
    plain = frame_step._trace_core_torch(*args, details=rep)
    ssd, best_k = rep["ssd"], rep["best_k"]
    kk = torch.arange(ssd.shape[1], device=ssd.device)[None, :]
    rep["runner_up"] = torch.amin(torch.where(kk == best_k[:, None], float("inf"), ssd), dim=-1)
    rep.update(kw=frame_step._trace_kw(args[-1]), h=args[0].shape[0], w=args[0].shape[1])
    return plain, rep


def _near(a, b, rtol: float):
    """|a - b| <= rtol |b| (b a tensor or a number)."""
    import torch

    return (a - b).abs() <= rtol * (b.abs() if isinstance(b, torch.Tensor) else abs(b))


def _near_border(uv, w: int, h: int):
    """Per sample, whether a coordinate lies within TRACE_TIE_PX of the
    in-bounds border at 2 px (``interp.in_bounds``): where rounding of the
    position can flip the test."""
    u, v = uv[..., 0], uv[..., 1]
    return (((u - 2.0).abs() <= TRACE_TIE_PX) | ((u - (w - 3.0)).abs() <= TRACE_TIE_PX)
            | ((v - 2.0).abs() <= TRACE_TIE_PX) | ((v - (h - 3.0)).abs() <= TRACE_TIE_PX))


def trace_ties(rep: dict, valid):
    """The valid rows whose trace the plain version's own numbers (``rep``,
    ``trace_details``') put within reach of rounding: the runner-up SSD
    within TRACE_TIE_RTOL of the best (the argmin), or a deciding quantity
    within TRACE_TIE_RTOL of its threshold (quality against min_quality,
    the best SSD against the energy gate, g_along against 1, the segment's
    length against the slack, a GN step against gn_threshold, the two ends
    of the new interval, its minimum against -0.1, |dir_u| against |dir_v|
    for the axis), or a sweep sample within TRACE_TIE_PX of the border."""
    kw, r = rep["kw"], TRACE_TIE_RTOL
    tie = (_near(rep["runner_up"], rep["best_e"], r) | _near(rep["quality"], kw["min_quality"], r)
           | _near(rep["best_e"], rep["gate"], r) | _near(rep["g_along"], 1.0, r)
           | _near(rep["seg_len"], kw["slack_interval"], r)
           | _near(rep["new_max"], rep["new_min"], r) | _near(rep["new_min"], -0.1, r)
           | _near(rep["dir"][:, 0].abs(), rep["dir"][:, 1].abs(), r)
           | _near_border(rep["samp"], rep["w"], rep["h"]).flatten(1).any(1))
    for s in rep["raw_steps"]:
        tie |= _near(s.abs(), kw["gn_threshold"], r)
    return tie & valid


def _bits_equal(a, b) -> bool:
    """Equal bit for bit (float32 compared as its bits, so NaN too)."""
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def fma32(a, b, c):
    """float32 fused multiply-add, exactly rounded, in torch ops on any
    device: the float64 product of two float32 is exact, the float64 sum is
    taken to round-to-odd (its error by TwoSum), then rounded once to
    float32."""
    import torch

    a, b, c = torch.broadcast_tensors(a, b, c)
    p, cc = a.double() * b.double(), c.double()
    s = p + cc
    bb = s - p
    err = (p - (s - bb)) + (cc - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.float()


def _close(a, b, rtol: float, atol: float):
    """|a - b| <= atol + rtol |b|, NaN equal to NaN, infinities equal."""
    import torch

    return ((a - b).abs() <= atol + rtol * b.abs()) | (a == b) | (torch.isnan(a) & torch.isnan(b))


def trace_bound_ms(args, rep: dict) -> tuple:
    """The least time the card could take for one trace of the bank as
    this run's data needs it: the larger of its bytes over the memory rate
    and its operations over the float32 rate. Bytes: each output field
    written once (21 B a row); an invalid row reads its valid flag and the
    20 B it copies through; a valid row reads what the trace uses (valid,
    host_slot, uv, color, the interval and the strikes: 57 B; its quality
    and status it overwrites unread); the window's state the slot tables
    are made from (T_eval, x, exposure: 25 floats a slot; T_new_cw, ab_abs;
    intr); the distinct texels of the valid rows' in-bounds sweep samples
    at 4 B (intensity) and, for the rows whose status the refine can decide
    (not OOB, SKIPPED or over the energy gate), of the refine's and
    g_along's samples at 12 B (I, dx, dy). Operations (csrc/trace.cu,
    counted as one thread does them): TRACE_FLOPS_SLOT a slot's table row,
    TRACE_FLOPS_ROW a valid row, TRACE_FLOPS_SAMPLE a sample
    (TRACE_FLOPS_SAMPLE_IN more per sweep point of an in-bounds sample),
    TRACE_FLOPS_GN a GN step of a row the refine can decide. ``rep`` is
    ``trace_details``'. Returns (ms, bound_by, bytes, flops)."""
    import torch

    from ldso_tpu_torch import trace as tm
    from ldso_tpu_torch.core.window import pattern

    bank = args[1]
    n, F = bank.uv.shape[0], args[3].shape[0]
    w, h, kw = rep["w"], rep["h"], rep["kw"]
    valid = bank.valid
    # the rows whose status the refine and g_along can move
    refined = valid & ((rep["status"] == tm.GOOD) | (rep["status"] == tm.BADCONDITION)
                       | ((rep["status"] == tm.OUTLIER) & (rep["best_e"] <= rep["gate"])))

    def corners(uv):
        u0 = uv[..., 0].floor().long().clamp(0, w - 1)
        v0 = uv[..., 1].floor().long().clamp(0, h - 1)
        u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
        return torch.stack([v0 * w + u0, v0 * w + u1, v1 * w + u0, v1 * w + u1], -1)

    inb = rep["inb"] & valid[:, None]
    sweep = corners(rep["samp"][inb]).unique()
    pat = pattern(bank.uv.device)
    refine = torch.cat([corners(p[refined][:, None, :] + pat[None]).flatten()
                        for p in rep["positions"][:-1]]
                       + [corners(rep["positions"][-1][refined]).flatten()]).unique()
    only_sweep = int(sweep.numel()) - int(torch.isin(sweep, refine).sum())
    n_valid, n_in, n_ref = int(valid.sum()), int(inb.sum()), int(refined.sum())
    n_bytes = (21 * n + 57 * n_valid + 21 * (n - n_valid) + 4 * (25 * F + 18) + 16
               + 4 * kw["num_samples"] + 4 * only_sweep + 12 * int(refine.numel()))
    s = rep["samp"].shape[2]
    flops = (F * TRACE_FLOPS_SLOT + n_valid * TRACE_FLOPS_ROW
             + n_ref * kw["gn_iters"] * TRACE_FLOPS_GN
             + n_valid * kw["num_samples"] * (TRACE_FLOPS_SAMPLE + TRACE_FLOPS_BOUNDS * s)
             + n_in * TRACE_FLOPS_SAMPLE_IN * s)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, flops)


def _trace_state(args) -> tuple:
    """``kernels/trace.trace_bank_cuda``'s positional arguments from
    ``frame_step._trace_core``'s, contiguous."""
    from ldso_tpu_torch.core.bank import Bank

    img3, bank, T_eval, x, expo_all, T_new_cw, ab_abs, expo_new, intr, _ = args
    return (img3.contiguous(), Bank(*(f.contiguous() for f in bank)), T_eval.contiguous(),
            x.contiguous(), expo_all.contiguous(), T_new_cw.contiguous(), ab_abs.contiguous(),
            expo_new, intr.contiguous())


def _table_diff(fields, kernel, plain) -> dict:
    """Named tables, the kernel's against the plain version's: the entries
    whose bits differ, each table's count and largest distance in ulps (a
    zero of the other sign counts, at 0 ulps)."""
    import torch

    rec, n_all = dict(entries=0, max_ulps=0, fields={}), 0
    for field, k, p in zip(fields, kernel, plain):
        p = p.contiguous()
        ne = k.contiguous().view(torch.int32) != p.view(torch.int32)
        ulps = int((_ordered(k) - _ordered(p)).abs().max())
        n, n_all = int(ne.sum()), n_all + ne.numel()
        rec["entries"] += n
        rec["max_ulps"] = max(rec["max_ulps"], ulps)
        if n:
            rec["fields"][field] = (n, ulps)
    rec["of"] = n_all
    return rec


def trace_table_compare(args) -> dict:
    """The slot tables the trace kernel makes (its debug output,
    ``kernels/trace.trace_tables_cuda``) against
    ``frame_step.trace_slot_tables`` on the same ``_trace_core`` arguments:
    ``_table_diff``'s record."""
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch.kernels import trace as ktr

    state = _trace_state(args)
    kern = ktr.trace_tables_cuda(*state, **frame_step._trace_kw(args[-1]))
    plain = frame_step.trace_slot_tables(*state[2:8])
    return _table_diff(("T_hn", "ab"), kern, plain)


def activation_table_compare(call) -> dict:
    """The tables the activation kernel makes (its debug output,
    ``kernels/trace.activation_tables_cuda``) against
    ``trace.activation_slot_tables`` on the same arguments (``call`` =
    (args, kwargs) of ``trace.activate_candidates_device``):
    ``_table_diff``'s record."""
    from ldso_tpu_torch import trace as tm
    from ldso_tpu_torch.kernels import trace as ktr

    args, kw = call
    kern = ktr.activation_tables_cuda(*_act_state(args), **kw)
    plain = tm.activation_slot_tables(args[2], args[3], args[4])
    return _table_diff(("T_rel", "alpha", "beta"), kern, plain)


def check_trace(name: str, args, time_it: bool = False) -> dict:
    """Hold the trace kernel against its plain version on one traced frame's
    real inputs (``args`` of ``frame_step._trace_core``): the bank fields
    ``_trace_core`` writes (valid, last_status and outlier_count equal;
    idepth_min, idepth_max and quality within TRACE_ATOL + TRACE_RTOL |plain|,
    NaN equal to NaN) on every row, and best_uv (TRACE_UV_ATOL px) and
    best_idepth on the rows both call GOOD. A row that parts must be a tie
    of ``trace_ties``; at most TRACE_MAX_TIES such rows. Two launches must
    agree bit for bit. Returns a record; with ``time_it`` also the kernel's device ms, the plain
    version's ms and the bound."""
    import torch

    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch import trace as tm
    from ldso_tpu_torch.kernels import trace as ktr

    state, kw = _trace_state(args), frame_step._trace_kw(args[-1])
    bank = args[1]

    def launch(debug=True):
        return ktr.trace_bank_cuda(*state, debug=debug, **kw)

    out_k, again = launch(), launch()
    for field, a, b in zip(ktr.TraceBankOut._fields, out_k, again):
        if not _bits_equal(a, b):
            raise RuntimeError(f"trace kernel on {name}: two launches differ in {field}")
    plain, rep = trace_details(args)
    torch.cuda.synchronize()
    valid = bank.valid
    tie = trace_ties(rep, valid)
    good = (rep["status"] == tm.GOOD) & (out_k.status == tm.GOOD)
    held = ((out_k.valid == plain.valid) & (out_k.last_status == plain.last_status)
            & (out_k.outlier_count == plain.outlier_count)
            & _close(out_k.idepth_min, plain.idepth_min, TRACE_RTOL, TRACE_ATOL)
            & _close(out_k.idepth_max, plain.idepth_max, TRACE_RTOL, TRACE_ATOL)
            & _close(out_k.quality, plain.quality, TRACE_RTOL, TRACE_ATOL)
            & (~good | ((out_k.best_uv - rep["positions"][-1]).abs().amax(1) <= TRACE_UV_ATOL)
               & _close(out_k.best_idepth, rep["best_idepth"], TRACE_RTOL, TRACE_ATOL)))
    parted = ~held
    bad = parted & ~tie
    if bool(bad.any()):
        rows = torch.nonzero(bad).flatten()[:5].tolist()
        raise RuntimeError(
            f"trace kernel disagrees on {name} at {int(bad.sum())} rows that are no tie, e.g. "
            + "; ".join(f"row {i}: status {int(out_k.status[i])} / {int(rep['status'][i])}, "
                        f"interval [{float(out_k.idepth_min[i]):.7g}, "
                        f"{float(out_k.idepth_max[i]):.7g}] / [{float(plain.idepth_min[i]):.7g}"
                        f", {float(plain.idepth_max[i]):.7g}], quality "
                        f"{float(out_k.quality[i]):.7g} / {float(plain.quality[i]):.7g}, "
                        f"best_uv {out_k.best_uv[i].tolist()} / "
                        f"{rep['positions'][-1][i].tolist()}" for i in rows)
            + f" (kernel / plain; bounds atol {TRACE_ATOL} + rtol {TRACE_RTOL}, uv "
              f"{TRACE_UV_ATOL} px)")
    n_parted = int(parted.sum())
    if n_parted > TRACE_MAX_TIES:
        raise RuntimeError(f"trace kernel on {name}: {n_parted} rows parted at a tie, more "
                           f"than {TRACE_MAX_TIES}")
    both = held & valid
    e_abs = max([float((a - b)[both].abs().nan_to_num(0.0).max()) if bool(both.any()) else 0.0
                 for a, b in ((out_k.idepth_min, plain.idepth_min),
                              (out_k.idepth_max, plain.idepth_max))])
    e_q = float(((out_k.quality - plain.quality).abs()
                 / plain.quality.abs().clamp(min=1e-12))[both].nan_to_num(0.0).max()) \
        if bool(both.any()) else 0.0
    counts = torch.bincount(rep["status"][valid].long(), minlength=6).tolist()
    table = trace_table_compare(args)
    if table["entries"]:
        raise RuntimeError(f"trace kernel on {name}: {_table_text(table)}")
    rec = dict(rows=bank.uv.shape[0], valid=int(valid.sum()), status=counts[:5],
               ties_found=int(tie.sum()), parted=n_parted, e_abs=e_abs, e_quality=e_q,
               table=table)
    if time_it:
        rec["ms"] = _device_ms(lambda: launch(debug=False))
        rec["plain_ms"] = _time_ms(lambda: frame_step._trace_core_torch(*args), reps=5,
                                   inner=5)
        rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["flops"] = trace_bound_ms(args, rep)
    return rec


def activation_slots(call, can):
    """[N, F]: the target slots a candidate row's evaluations count (a valid
    slot other than its host; ``call`` = (args, kwargs) of
    ``trace.activate_candidates_device``, ``can`` the candidate mask)."""
    import torch

    (win_images, frame_valid, _, _, _, bank, _, _), _ = call
    fr = torch.arange(win_images.shape[0], device=can.device)
    return frame_valid[None, :] & can[:, None] & (bank.host_slot.long()[:, None] != fr[None, :])


def activate_bound_ms(call, det: dict) -> tuple:
    """The least time the card could take for one activation of the bank as
    this run's data needs it: the larger of its bytes over the memory rate
    and its operations over the float32 rate. Bytes: each row's results
    written once (17 B); what the candidate test reads, in its order
    (valid, then the status of a valid row, the quality of a GOOD one, the
    interval of one above min_quality: 1 to 17 B); a candidate's uv, color
    and host slot (44 B); the slots' poses and state the tables are made
    from (rows 0-2 of T_all, a, b, exposure, frame_valid); the distinct
    texels of the in-bounds samples of the 1 + iters evaluations at 12 B.
    Operations (csrc/trace.cu): ACT_FLOPS_PAIR an entry of the [F, F]
    tables once; ACT_FLOPS_SAMPLE for each sample of a valid target slot,
    ACT_FLOPS_IN more for each in-bounds one, ACT_FLOPS_SLOT a slot's sums,
    per evaluation of a candidate row. ``det`` is the plain version's
    ``details`` and ``can``. Returns (ms, bound_by, bytes, flops)."""
    import torch

    from ldso_tpu_torch import trace as tm

    (win_images, _, _, _, _, bank, _, min_q), _ = call
    F, h, w = win_images.shape[0], win_images.shape[1], win_images.shape[2]
    n = bank.uv.shape[0]
    can = det["can"]
    ok_f = activation_slots(call, can)
    texels, n_in = [], 0
    for uvn, inb in det["samples"]:
        u0 = uvn[..., 0][inb].floor().long().clamp(0, w - 1)
        v0 = uvn[..., 1][inb].floor().long().clamp(0, h - 1)
        f = torch.nonzero(inb)[:, 1]
        u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
        base = f * (h * w)
        texels.append(torch.cat([base + v0 * w + u0, base + v0 * w + u1, base + v1 * w + u0,
                                 base + v1 * w + u1]))
        n_in += int(inb.sum())
    n_evals = len(det["samples"])
    n_texels = int(torch.cat(texels).unique().numel())
    good = bank.valid & (bank.last_status == tm.GOOD)
    n_test = (n + 4 * int(bank.valid.sum()) + 4 * int(good.sum())
              + 8 * int((good & (bank.quality > min_q)).sum()))
    n_bytes = 17 * n + n_test + 44 * int(can.sum()) + 4 * 15 * F + F + 16 + 12 * n_texels
    flops = F * F * ACT_FLOPS_PAIR + n_evals * (ACT_FLOPS_SAMPLE * 8 * int(ok_f.sum())
                       + ACT_FLOPS_SLOT * F * int(ok_f.any(1).sum())) + ACT_FLOPS_IN * n_in
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, flops)


def _act_state(args) -> tuple:
    """``kernels/trace.activate_bank_cuda``'s positional arguments from
    ``trace.activate_candidates_device``'s, contiguous."""
    win_images, frame_valid, T_all, x, expo_all, bank, intr, min_q = args
    return (win_images.contiguous(), frame_valid.contiguous(), T_all.contiguous(),
            x.contiguous(), expo_all.contiguous(), type(bank)(*(f.contiguous() for f in bank)),
            intr.contiguous(), min_q)


def activate_replay(call) -> dict:
    """The activation kernel's arithmetic (csrc/trace.cu activate_bank), in
    torch ops in its order, on the tables of ``trace.activation_slot_tables``
    (``call`` = (args, kwargs) of ``trace.activate_candidates_device``):
    each sample's terms operator by operator (the projection's two
    fused multiply-adds exact, ``fma32``), each slot's 8 points by the tree
    ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7)), then the slots' sums
    added in slot order from 0, the order of the JAX package's loop and of
    the kernel since it was ported. Where the kernel's tables equal the
    plain version's (``activation_table_compare``), the kernel's outputs
    equal these bit for bit. Returns ``activate_candidates_torch``'s dict."""
    import torch

    from ldso_tpu_torch import trace as tm
    from ldso_tpu_torch.core.window import pattern

    (win_images, frame_valid, T_all, x, expo, bank, intr, min_q), kw = call
    iters, huber = kw.get("iters", 3), kw.get("huber_th", 9.0)
    F, h, w = win_images.shape[0], win_images.shape[1], win_images.shape[2]
    dev = win_images.device
    T_rel, alpha, beta = tm.activation_slot_tables(T_all, x, expo)
    can = (bank.valid & (bank.last_status == tm.GOOD) & (bank.quality > min_q)
           & ~torch.isnan(bank.idepth_max) & ((bank.idepth_max + bank.idepth_min) > 0))
    d = torch.clamp(0.5 * (torch.where(can, bank.idepth_min, 0.0)
                           + torch.where(can, bank.idepth_max, 1.0)), 1e-3, 50.0)
    hs = bank.host_slot.long().clamp(0, F - 1)
    fr = torch.arange(F, device=dev)
    act = frame_valid[None, :] & (fr[None, :] != hs[:, None]) & can[:, None]     # [N, F]
    T = T_rel[:, hs].transpose(0, 1)[:, :, :, :, None]                            # [N, F, 4, 4, 1]
    a, be = alpha[:, hs].T[..., None], beta[:, hs].T[..., None]                   # [N, F, 1]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pat = pattern(dev)
    xh0 = (((bank.uv[:, 0:1] + pat[None, :, 0]) - cx) / fx)[:, None, :]           # [N, 1, 8]
    xh1 = (((bank.uv[:, 1:2] + pat[None, :, 1]) - cy) / fy)[:, None, :]
    color = bank.color[:, None, :]
    flat = win_images.reshape(-1, 3)
    huber_t = torch.tensor(huber, dtype=torch.float32, device=dev)

    def tree8(v):
        return (((v[..., 0] + v[..., 4]) + (v[..., 2] + v[..., 6]))
                + ((v[..., 1] + v[..., 5]) + (v[..., 3] + v[..., 7])))

    def in_order(s):
        acc = torch.zeros_like(s[:, 0])
        for f in range(F):
            acc = acc + s[:, f]
        return acc

    def evaluate(d):
        X = [(T[:, :, i, 2] + fma32(T[:, :, i, 1], xh1, T[:, :, i, 0] * xh0))
             + T[:, :, i, 3] * d[:, None, None] for i in range(3)]
        okz = X[2] > 1e-6
        zs = torch.where(okz, X[2], 1.0)
        up, vp = X[0] / zs, X[1] / zs
        un, vn = fx * up + cx, fy * vp + cy
        inb = (okz & (un >= 2.0) & (un < w - 3.0) & (vn >= 2.0) & (vn < h - 3.0)
               & act[..., None])
        un, vn = torch.where(inb, un, 2.0), torch.where(inb, vn, 2.0)
        iu, iv = un.floor(), vn.floor()
        du, dv = un - iu, vn - iv
        u0, v0 = iu.long().clamp(0, w - 1), iv.long().clamp(0, h - 1)
        u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
        base = fr[None, :, None] * (h * w)
        c00, c10 = flat[base + v0 * w + u0], flat[base + v0 * w + u1]
        c01, c11 = flat[base + v1 * w + u0], flat[base + v1 * w + u1]
        du, dv = du[..., None], dv[..., None]
        top = c00 * (1.0 - du) + c10 * du
        bot = c01 * (1.0 - du) + c11 * du
        hit = top * (1.0 - dv) + bot * dv
        res = (hit[..., 0] - a * color) - be
        dre = 1.0 / zs
        Jd = (hit[..., 1] * ((fx * dre) * (T[:, :, 0, 3] - T[:, :, 2, 3] * up))
              + hit[..., 2] * ((fy * dre) * (T[:, :, 1, 3] - T[:, :, 2, 3] * vp)))
        ar = res.abs()
        hw = torch.where(ar < huber_t, 1.0, huber_t / torch.clamp(ar, min=1e-12))
        zero = torch.zeros_like(res)
        terms = ((hw * Jd) * Jd, (hw * Jd) * res, ((hw * res) * res) * (2.0 - hw),
                 torch.ones_like(res))
        return [in_order(tree8(torch.where(inb, t, zero))) for t in terms]

    for _ in range(iters):
        Hd, bd, _, _ = evaluate(d)
        d = torch.clamp(d - bd / (Hd + 1e-6), 1e-5, 50.0)
    Hd, _, E, cnt = evaluate(d)
    return dict(idepth=d, H_dd=Hd, energy=E, count=cnt, can=can)


def check_activate(name: str, call, time_it: bool = False) -> dict:
    """Hold the activation kernel against its plain version on one
    keyframe's real inputs (``call`` = (args, kwargs) of
    ``trace.activate_candidates_device``): can equal; count equal, idepth
    within ACT_IDEPTH_ATOL + ACT_IDEPTH_RTOL |plain| and H_dd, energy within
    ACT_SUM_ATOL + ACT_SUM_RTOL |plain| on every row but a tie (a sample of
    one of its evaluations, at the plain version's inverse depths, within
    TRACE_TIE_PX of the border), at most ACT_MAX_TIES of those. Two
    launches must agree bit for bit. Returns a record; with ``time_it``
    also the kernel's device ms, the plain version's ms and the bound."""
    import torch

    from ldso_tpu_torch import trace as tm
    from ldso_tpu_torch.kernels import trace as ktr

    args, kw = call
    win_images, frame_valid, bank = args[0], args[1], args[5]
    state = _act_state(args)

    def launch():
        return ktr.activate_bank_cuda(*state, **kw)

    out_k, again = launch(), launch()
    for key in out_k:
        if not _bits_equal(out_k[key], again[key]):
            raise RuntimeError(f"activation kernel on {name}: two launches differ in {key}")
    replay = activate_replay(call)
    for key in out_k:
        if not _bits_equal(out_k[key], replay[key]):
            raise RuntimeError(
                f"activation kernel on {name}: {key} differs from the kernel's order replayed "
                f"in torch (activate_replay) on {int((out_k[key] != replay[key]).sum())} rows")
    table = activation_table_compare(call)
    if table["entries"]:
        raise RuntimeError(f"activation kernel on {name}: {_table_text(table)}")
    det = {}
    out_p = tm.activate_candidates_torch(*args, **kw, details=det)
    det["can"] = out_p["can"]
    torch.cuda.synchronize()
    if not torch.equal(out_k["can"], out_p["can"]):
        raise RuntimeError(f"activation kernel on {name}: can differs on "
                           f"{int((out_k['can'] != out_p['can']).sum())} rows")
    tie = torch.zeros_like(out_p["can"])
    ok_f = activation_slots(call, out_p["can"])
    for uvn, _ in det["samples"]:
        tie |= (_near_border(uvn, win_images.shape[2], win_images.shape[1])
                & ok_f[..., None]).flatten(1).any(1)
    held = ((out_k["count"] == out_p["count"])
            & _close(out_k["idepth"], out_p["idepth"], ACT_IDEPTH_RTOL, ACT_IDEPTH_ATOL)
            & _close(out_k["H_dd"], out_p["H_dd"], ACT_SUM_RTOL, ACT_SUM_ATOL)
            & _close(out_k["energy"], out_p["energy"], ACT_SUM_RTOL, ACT_SUM_ATOL))
    bad = ~held & ~tie
    if bool(bad.any()):
        rows = torch.nonzero(bad).flatten()[:5].tolist()
        raise RuntimeError(
            f"activation kernel disagrees on {name} at {int(bad.sum())} rows that are no tie, "
            f"e.g. " + "; ".join(
                f"row {i}: " + ", ".join(f"{k} {float(out_k[k][i]):.7g} / "
                                         f"{float(out_p[k][i]):.7g}"
                                         for k in ("idepth", "H_dd", "energy", "count"))
                for i in rows)
            + f" (kernel / plain; idepth atol {ACT_IDEPTH_ATOL} + rtol {ACT_IDEPTH_RTOL}, sums "
              f"atol {ACT_SUM_ATOL} + rtol {ACT_SUM_RTOL}, count equal)")
    n_parted = int((~held).sum())
    if n_parted > ACT_MAX_TIES:
        raise RuntimeError(f"activation kernel on {name}: {n_parted} rows parted at a tie, "
                           f"more than {ACT_MAX_TIES}")
    can = out_p["can"] & held

    def rel(k):
        d = (out_k[k] - out_p[k]).abs() / out_p[k].abs().clamp(min=1e-12)
        return float(d[can].max()) if bool(can.any()) else 0.0

    rec = dict(rows=bank.uv.shape[0], candidates=int(out_p["can"].sum()),
               slots=int(frame_valid.sum()), ties_found=int(tie.sum()), parted=n_parted,
               e_idepth=rel("idepth"), e_H=rel("H_dd"), e_E=rel("energy"),
               e_abs=float((out_k["idepth"] - out_p["idepth"])[can].abs().max())
               if bool(can.any()) else 0.0, table=table)
    if time_it:
        rec["ms"] = _device_ms(launch)
        rec["plain_ms"] = _time_ms(lambda: tm.activate_candidates_torch(*args, **kw), reps=5,
                                   inner=3)
        rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["flops"] = \
            activate_bound_ms(call, det)
    return rec


@contextlib.contextmanager
def count_ba():
    """Within the block, count the BA evaluations the drives ask for (on
    whichever thread): for each ``ba.solve.run_ba`` call its first
    assembly and one a LM iteration (1 + ``len(stats.lam_ladder)``), and one
    for each ``ba.marginal.marginalize_points`` call that folds points.
    Yields a one-item list holding the count."""
    import threading

    import numpy as np

    from ldso_tpu_torch.ba import marginal, solve

    made, lock = [0], threading.Lock()
    run_ba, fold = solve.run_ba, marginal.marginalize_points

    def counted_ba(*args, **kw):
        out = run_ba(*args, **kw)
        with lock:
            made[0] += 1 + len(out[1].lam_ladder)
        return out

    def counted_fold(win, mask, *args, **kw):
        if np.asarray(mask).any():
            with lock:
                made[0] += 1
        return fold(win, mask, *args, **kw)

    solve.run_ba, marginal.marginalize_points = counted_ba, counted_fold
    try:
        yield made
    finally:
        solve.run_ba, marginal.marginalize_points = run_ba, fold


@contextlib.contextmanager
def count_calls(obj, name: str):
    """Within the block, count the calls of ``obj.name`` (a one-item list)."""
    made, fn = [0], getattr(obj, name)

    def counted(*args, **kw):
        made[0] += 1
        return fn(*args, **kw)

    setattr(obj, name, counted)
    try:
        yield made
    finally:
        setattr(obj, name, fn)


def _table_text(t: dict) -> str:
    """``ba_table_compare``'s or ``_table_diff``'s record as text."""
    slot = t.get("slot_equal", True)
    if not t["entries"] and slot:
        return f"tables bit for bit ({t['of']} entries)"
    return (f"tables: {t['entries']} of {t['of']} entries differ (max {t['max_ulps']} ulps; "
            + ", ".join(f"{k} {n} at up to {u} ulps" for k, (n, u) in t["fields"].items())
            + ")" + ("" if "slot_equal" not in t
                     else f", slot table {'equal' if slot else 'DIFFERS'}"))


def _check_ba_launches(phase: str, launched: int, evals: int) -> None:
    """PER_EVALUATION BA kernel launches for each evaluation ``count_ba``
    counted, and at least one evaluation."""
    from ldso_tpu_torch.kernels import ba as kba

    if evals < 1 or launched != kba.PER_EVALUATION * evals:
        raise RuntimeError(f"{phase}: BA kernel launched {launched} times for {evals} "
                           f"evaluations, expected {kba.PER_EVALUATION * evals}")


@contextlib.contextmanager
def plain_ba():
    """Within the block, ``ba.residuals.assemble`` and ``energy_only`` run
    their plain versions also on the card: the yardstick of the kernel,
    never the port's path."""
    from ldso_tpu_torch.ba import residuals

    kernels = residuals._assemble_kernel, residuals._energy_only_kernel
    residuals._assemble_kernel = residuals.assemble_torch
    residuals._energy_only_kernel = residuals.energy_only_torch
    try:
        yield
    finally:
        residuals._assemble_kernel, residuals._energy_only_kernel = kernels


def marg_window(args):
    """The window ``marginalize_points`` assembles (mode fej) from its
    arguments: the points it folds."""
    import torch

    win, mask = args[0], args[1]
    return win._replace(p_valid=win.p_valid & torch.as_tensor(mask, device=win.x.device))


def ba_samples(win) -> tuple:
    """The plain version's projections of ``win``: every sample's current
    pixel and test (``residuals._project_current``: uvk [P, F, 8, 2],
    ok_pat [P, F, 8]) and each pair's FEJ centre in pixels [P, F, 2] with
    its z test, as ``assemble_torch`` makes them."""
    import torch

    from ldso_tpu_torch.ba import residuals as res

    pre = res.precompute_pairs(win)
    host = win.p_host.long()
    uvk, ok_pat = res._project_current(win, pre, host)
    xc = res._normalized_dirs(win.p_uv, win.c_zero)
    X0 = torch.einsum("pfij,pj->pfi", pre.R_fej[host], xc) \
        + pre.t_fej[host] * win.p_idepth_zero[:, None, None]
    ok0 = X0[..., 2] > 1e-6
    dre = 1.0 / torch.where(ok0, X0[..., 2], torch.ones_like(X0[..., 2]))
    c0 = win.c_zero
    uv0 = torch.stack([c0[0] * (X0[..., 0] * dre) + c0[2], c0[1] * (X0[..., 1] * dre) + c0[3]],
                      dim=-1)
    return uvk, ok_pat, uv0, ok0


def ba_tie_pairs(win, mode: str):
    """bool [P, F]: the requested pairs whose validity is within reach of
    rounding in the plain version's own numbers: a sample within
    TRACE_TIE_PX of the in-bounds border (at border 2) or, unless ``mode``
    is "energy", the FEJ centre."""
    uvk, _, uv0, _ = ba_samples(win)
    h, w = win.images.shape[1], win.images.shape[2]
    requested = win.res_mask & win.p_valid[:, None] & win.frame_valid[None, :]
    tie = _near_border(uvk, w, h).any(-1)
    if mode != "energy":
        tie |= _near_border(uv0, w, h)
    return tie & requested


def ba_assemble_bound_ms(win, mode: str, valid_pair=None) -> tuple:
    """The least time the card could take for one evaluation of ``win``
    (``mode`` "active", "fej" or "energy") as its data needs it: the larger
    of its bytes over the memory rate and its operations over the float32
    rate. Bytes: each point's inputs once (uv 8, the inverse depth 4 and in
    modes active and fej its FEJ copy 4, color 32, weight 32, host 4, valid
    1, res_mask F), each slot's pose and state (T_eval 64, x 32, exposure
    4, frame_valid 1 and, but for energy_only, x_zero 32: the kernel makes
    the pair tables and the state delta of mode fej from them), the
    intrinsics; the distinct texels of the valid samples at 12 B (I, dx, dy);
    each output once (H, b, H_xd, H_dd, b_d, e_pair, the masks, the energy,
    the count; energy_only the energy and count). Operations (csrc/ba.cu,
    counted per sample as a lane does them): K4_FLOPS_REQ each requested
    sample, K4_FLOPS_VALID (+ K4_FLOPS_FEJ in mode fej) or K4_FLOPS_ENERGY
    each valid one. ``valid_pair`` is the plain version's (computed if not
    given). Returns (ms, bound_by, bytes, flops)."""
    import torch

    from ldso_tpu_torch.ba import residuals as res

    F, h, w = win.images.shape[0], win.images.shape[1], win.images.shape[2]
    P, D = win.p_uv.shape[0], 8 * win.images.shape[0] + 4
    uvk, ok_pat, _, _ = ba_samples(win)
    requested = win.res_mask & win.p_valid[:, None] & win.frame_valid[None, :]
    if mode == "energy":
        valid = ok_pat & requested[..., None]
    else:
        if valid_pair is None:
            valid_pair = res.assemble_torch(win, mode=mode).valid_pair
        valid = ok_pat & valid_pair[..., None]
    f = torch.nonzero(valid)[:, 1]
    uv = uvk[valid]
    u0 = uv[:, 0].floor().long().clamp(0, w - 1)
    v0 = uv[:, 1].floor().long().clamp(0, h - 1)
    u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
    base = f * (h * w)
    n_texels = int(torch.cat([base + v0 * w + u0, base + v0 * w + u1, base + v1 * w + u0,
                              base + v1 * w + u1]).unique().numel())
    n_req, n_valid = 8 * int(requested.sum()), int(valid.sum())
    energy = mode == "energy"
    n_bytes = (P * (8 + 4 + (0 if energy else 4) + 32 + 32 + 4 + 1 + F)
               + F * (64 + 32 + 4 + (0 if energy else 32)) + F + 32 + 12 * n_texels
               + (12 if energy else 4 * (D * D + D + 1) + 8 + P * (4 * D + 8 + 6 * F)))
    flops = n_req * K4_FLOPS_REQ + n_valid * (
        K4_FLOPS_ENERGY if energy else K4_FLOPS_VALID + (K4_FLOPS_FEJ if mode == "fej" else 0))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, flops)


def ba_compare(out_k, out_p, mode: str, win) -> dict:
    """Hold one evaluation of the kernel (``out_k``) to the plain one
    (``out_p``), both ``BASystem`` (or (energy, count) in mode "energy"), on
    ``win``. An entry within K4_RTOL |plain| + K4_ATOL_FRAC x the
    Cauchy-Schwarz bound on the sum of its absolute terms, from the plain
    outputs: sqrt(H_ii H_jj) for H_ij, sqrt(H_ii S) for b_i,
    sqrt(H_ii H_dd[p]) for H_xd[p, i], sqrt(H_dd[p] S_p) for b_d[p], where
    S >= the sum of w r^2 over the residuals: the energy (S_p: the point's
    e_pair) in mode active, and in mode fej 2 (energy + the quadratic form
    of H, H_xd and H_dd in the state and inverse-depth deltas), since there
    the residual is r - J delta; H_dd and e_pair (sums of non-negative
    terms) against their array's largest; the energy within K4_E_RTOL;
    masks and count equal. Returns numpy bools of what held: ``all``,
    ``pairs`` [P, F] (valid_pair and oob_pair equal, e_pair within bounds),
    ``points`` [P] (H_dd, b_d and the H_xd row within bounds), the worst
    entry of each output (error / bound, index, kernel, plain) and the
    fields each of the first points that part fails in."""
    import numpy as np

    E_k, E_p = float(out_k[0] if mode == "energy" else out_k.energy), \
        float(out_p[0] if mode == "energy" else out_p.energy)
    n_k, n_p = (int(out_k[1]), int(out_p[1])) if mode == "energy" else (
        int(out_k.num_res), int(out_p.num_res))
    e_rel = abs(E_k - E_p) / max(abs(E_p), 1e-30)
    rec = dict(e_energy=e_rel, num_res=(n_k, n_p))
    ok = e_rel <= K4_E_RTOL and n_k == n_p
    if mode == "energy":
        rec.update(all=ok, max_abs_err=0.0, used=0.0)
        return rec
    from ldso_tpu_torch.core.window import state_delta

    k = {f: getattr(out_k, f).cpu().numpy().astype(np.float64) for f in out_k._fields}
    p = {f: getattr(out_p, f).cpu().numpy().astype(np.float64) for f in out_p._fields}
    d_ii = np.abs(np.diagonal(p["H"]))
    hdd = np.abs(p["H_dd"])
    S, S_p = E_p, p["e_pair"].sum(1)
    if mode == "fej":
        delta = state_delta(win).cpu().numpy().astype(np.float64)
        dd = (win.p_idepth - win.p_idepth_zero).cpu().numpy().astype(np.float64)
        q = delta @ p["H"] @ delta + 2.0 * delta @ (p["H_xd"].T @ dd) + hdd @ (dd * dd)
        S, S_p = 2.0 * (E_p + q), 2.0 * (S_p + q)
    scales = {"H": np.sqrt(np.outer(d_ii, d_ii)), "b": np.sqrt(d_ii * max(S, 0.0)),
              "H_xd": np.sqrt(np.outer(hdd, d_ii)), "b_d": np.sqrt(hdd * np.maximum(S_p, 0.0)),
              "H_dd": np.full_like(hdd, hdd.max()),
              "e_pair": np.full_like(p["e_pair"], np.abs(p["e_pair"]).max())}
    held, worst = {}, {}
    for f, sc in scales.items():
        bound = K4_RTOL * np.abs(p[f]) + K4_ATOL_FRAC * sc
        err = np.abs(k[f] - p[f])
        held[f] = err <= bound
        ratio = np.divide(err, bound, out=np.zeros_like(bound), where=bound > 0)
        ratio[(bound == 0) & (err > 0)] = np.inf
        i = np.unravel_index(int(np.argmax(ratio)), ratio.shape)
        worst[f] = (float(ratio[i]), tuple(int(j) for j in i), float(k[f][i]), float(p[f][i]))
    masks = (k["valid_pair"] == p["valid_pair"]) & (k["oob_pair"] == p["oob_pair"])
    points = held["H_xd"].all(1) & held["H_dd"] & held["b_d"]
    pairs = masks & held["e_pair"]
    parted = np.nonzero(~points | ~pairs.all(1))[0][:5]
    fails = {int(i): [f for f, h in (("H_xd", held["H_xd"][i].all()), ("H_dd", held["H_dd"][i]),
                                     ("b_d", held["b_d"][i]), ("masks", masks[i].all()),
                                     ("e_pair", held["e_pair"][i].all())) if not h]
             for i in parted}
    rec.update(all=bool(ok and held["H"].all() and held["b"].all() and points.all()
                        and pairs.all()),
               pairs=pairs, points=points, worst=worst, fails=fails,
               used=max(w[0] for w in worst.values()),
               max_abs_err=max(float(np.abs(k[f] - p[f]).max()) for f in ("H", "b", "H_xd")))
    return rec


def _ordered(t):
    """float32 bits as integers in the order of the floats (-0 and +0 both 0)."""
    import torch

    i = t.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def ba_table_compare(win) -> dict:
    """The pair and slot tables the BA kernel makes (its debug output,
    ``kernels/ba.slot_tables_cuda``) against ``residuals.ba_slot_tables``
    on the same window: ``_table_diff``'s record over the pair table's
    fields, and whether the slot tables are equal bit for bit."""
    from ldso_tpu_torch.ba import residuals as res
    from ldso_tpu_torch.kernels import ba as kba

    pair_k, slot_k = kba.slot_tables_cuda(res._contiguous(win))
    pair_p, slot_p = res.ba_slot_tables(win)
    fields = (("R_cur", 0, 9), ("t_cur", 9, 12), ("R_fej", 12, 21), ("t_fej", 21, 24),
              ("adj_fej", 24, 60), ("alpha_cur", 60, 61), ("alpha_fej", 61, 62))
    rec = _table_diff([f for f, _, _ in fields], [pair_k[..., lo:hi] for _, lo, hi in fields],
                      [pair_p[..., lo:hi] for _, lo, hi in fields])
    rec["slot_equal"] = _bits_equal(slot_k, slot_p.contiguous())
    return rec


def check_ba(name: str, win, cfg, mode: str, time_it: bool = False) -> dict:
    """Hold the BA kernel against its plain version on one window (a BA
    window the drive built): ``assemble`` in ``mode`` "active" or "fej", or
    ``energy_only`` for "energy" (``ba_compare``'s bounds). Two launches
    must agree bit for bit. If the two versions part, the pairs that part
    must be ties (``ba_tie_pairs``; in mode energy, which has no per-pair
    output, the count may differ by at most K4_MAX_TIES and every tie pair
    is dropped), at most K4_MAX_TIES of them: they are dropped from
    res_mask and both versions run again, held as above. The record also
    holds the pair tables the kernel made against ``ba_slot_tables``
    (``ba_table_compare``: ``table``). With ``time_it`` also the kernel's
    device ms (its launch), the whole call's ms (CUDA events over
    back-to-back calls, as the two-launch version was read) and host ms
    (the host clock of one call, unsynchronized), the plain version's ms
    and the bound."""
    import numpy as np
    import torch

    from ldso_tpu_torch.ba import residuals as res
    from ldso_tpu_torch.kernels import ba as kba

    kw = dict(huber_th=cfg.ba.huber_th, outlier_sum=cfg.ba.outlier_th_sum_component)
    F = win.num_frames

    def kernel(w):
        return res.energy_only(w, **kw) if mode == "energy" else res.assemble(w, mode=mode, **kw)

    def plain(w):
        return (res.energy_only_torch(w, **kw) if mode == "energy"
                else res.assemble_torch(w, mode=mode, **kw))

    n0 = kba.LAUNCHES
    out_k, again = kernel(win), kernel(win)
    if kba.LAUNCHES != n0 + 2 * kba.PER_EVALUATION:
        raise RuntimeError(f"BA kernel on {name}: two evaluations counted "
                           f"{kba.LAUNCHES - n0} launches")
    for i, (a, b) in enumerate(zip(out_k, again)):
        if not _bits_equal(a, b):
            raise RuntimeError(f"BA kernel on {name}: two launches differ in output {i}")
    out_p = plain(win)
    torch.cuda.synchronize()
    rec = ba_compare(out_k, out_p, mode, win)
    tie = ba_tie_pairs(win, mode).cpu().numpy()
    parted = np.zeros_like(tie)
    if not rec["all"]:
        if mode == "energy":
            n_k, n_p = rec["num_res"]
            if abs(n_k - n_p) > K4_MAX_TIES or not tie.any():
                raise RuntimeError(f"BA kernel (energy_only) disagrees on {name}: energy rel "
                                   f"{rec['e_energy']:.3g} (bound {K4_E_RTOL}), count "
                                   f"{n_k} / {n_p}, {int(tie.sum())} tie pairs")
            parted = tie
        else:
            pair_bad, point_bad = ~rec["pairs"], ~rec["points"]
            bad = (pair_bad & ~tie).any(1) | (point_bad & ~tie.any(1))
            if bad.any():
                pts = np.nonzero(bad)[0][:5].tolist()
                raise RuntimeError(
                    f"BA kernel ({mode}) disagrees on {name} at {int(bad.sum())} points that "
                    f"hold no tie, e.g. points {pts} (failing in {rec['fails']}; energy rel "
                    f"{rec['e_energy']:.3g}, count {rec['num_res']}, error / bound, at, kernel, "
                    f"plain: {rec['worst']})")
            parted = pair_bad | (point_bad[:, None] & tie)
            if not parted.any():
                raise RuntimeError(f"BA kernel ({mode}) disagrees on {name} in H, b or the "
                                   f"energy with every point held: energy rel "
                                   f"{rec['e_energy']:.3g}, count {rec['num_res']}, error / "
                                   f"bound, at, kernel, plain: {rec['worst']}")
            if parted.sum() > K4_MAX_TIES:
                raise RuntimeError(f"BA kernel on {name}: {int(parted.sum())} pairs parted at "
                                   f"a tie, more than {K4_MAX_TIES}")
        keep = torch.as_tensor(~parted, device=win.x.device)
        win = win._replace(res_mask=win.res_mask & keep)
        out_k, out_p = kernel(win), plain(win)
        rec = ba_compare(out_k, out_p, mode, win)
        if not rec["all"]:
            raise RuntimeError(f"BA kernel ({mode}) disagrees on {name} with the "
                               f"{int(parted.sum())} tie pairs dropped: energy rel "
                               f"{rec['e_energy']:.3g}, count {rec['num_res']}, error / bound, "
                               f"at, kernel, plain: {rec.get('worst')}")
    out = dict(mode=mode, points=int(win.p_valid.sum()),
               hosts=int(torch.unique(win.p_host[win.p_valid]).numel()),
               slots=int(win.frame_valid.sum()), num_res=rec["num_res"][1],
               ties_found=int(tie.sum()), parted=int(parted.sum()), e_energy=rec["e_energy"],
               used=rec["used"], max_abs_err=rec["max_abs_err"], table=ba_table_compare(win))
    if time_it:
        wc = res._contiguous(win)
        if mode == "energy":
            out["ms"] = _device_ms(lambda: kba.energy_only_cuda(wc, **kw))
        else:
            out["ms"] = _device_ms(lambda: kba.assemble_cuda(wc, mode=mode, **kw))
        out["call_ms"] = _time_ms(lambda: kernel(win), reps=5, inner=5)
        out["host_ms"] = _host_ms(lambda: kernel(win))
        out["plain_ms"] = _time_ms(lambda: plain(win), reps=5, inner=3)
        out["bound_ms"], out["bound_by"], out["bytes"], out["flops"] = ba_assemble_bound_ms(
            win, mode, None if mode == "energy" else out_p.valid_pair)
    return out


def compare_run_ba(name: str, w_k, s_k, w_p, s_p) -> dict:
    """Hold a ``run_ba`` of the kernel (window ``w_k``, stats ``s_k``) to a
    plain one from the same arguments: the same lambda ladder, unless they
    part at a tie (a step whose trial energy in the plain run is within
    K4_LADDER_TIE_RTOL of the energy it is tested against: reported, and
    the states are not compared); then the states by the bounds above.
    Returns the numbers compared."""
    import numpy as np

    lk, lp = list(s_k.lam_ladder), list(s_p.lam_ladder)
    rec = dict(iterations=(s_k.iterations, s_p.iterations), ladder=len(lp))
    if lk != lp:
        part = next((i for i, (a, b) in enumerate(zip(lk, lp)) if a != b), min(len(lk), len(lp)))
        E, rho = s_p.energy_initial, []
        for Et in s_p.energy_ladder:
            rho.append(abs(Et - E) / max(abs(E), 1e-30))
            if np.isfinite(Et) and Et < E:
                E = Et
        # the decision at the parting step (or, where one run stopped, the last common one)
        at = min(part, len(lp) - 1)
        if not rho[at] < K4_LADDER_TIE_RTOL:
            raise RuntimeError(f"run_ba on {name}: the lambda ladders part at step {part} "
                               f"({lk} / {lp}), where the energy change is {rho[at]:.3g}, "
                               f"no tie (< {K4_LADDER_TIE_RTOL})")
        rec.update(tie_at=part, tie_rho=rho[at])
        return rec
    e_x = float(np.abs(w_k.x.cpu().numpy() - w_p.x.cpu().numpy()).max())
    c_k, c_p = w_k.c.cpu().numpy(), w_p.c.cpu().numpy()
    e_c = float((np.abs(c_k - c_p) / np.abs(c_p)).max())
    d_k, d_p = w_k.p_idepth.cpu().numpy(), w_p.p_idepth.cpu().numpy()
    held_d = np.abs(d_k - d_p) <= K4_IDEPTH_ATOL + K4_IDEPTH_RTOL * np.abs(d_p)
    masks = int((s_k.res_mask != s_p.res_mask).sum() + (s_k.junk != s_p.junk).sum())
    rec.update(e_x=e_x, e_c=e_c,
               e_idepth=float((np.abs(d_k - d_p) / np.maximum(np.abs(d_p), 1e-12)).max()),
               masks_parted=masks,
               e_final=abs(s_k.energy_final - s_p.energy_final) / max(abs(s_p.energy_final), 1e-30))
    if not (e_x <= K4_X_ATOL and e_c <= K4_C_RTOL and held_d.all() and masks <= K4_MAX_TIES):
        raise RuntimeError(f"run_ba on {name}: the same ladder {lp} but the states part: "
                           f"max|dx| {e_x:.3g} (bound {K4_X_ATOL}), c rel {e_c:.3g} "
                           f"({K4_C_RTOL}), idepth {int((~held_d).sum())} beyond atol "
                           f"{K4_IDEPTH_ATOL} + rtol {K4_IDEPTH_RTOL}, {masks} mask entries "
                           f"parted (at most {K4_MAX_TIES})")
    return rec


def check_run_ba(name: str, args, kw) -> dict:
    """A whole ``run_ba`` on kept arguments (``args``, ``kw``) through the
    kernel and through the plain version (``plain_ba``), each from its own
    copy, held by ``compare_run_ba``."""
    from ldso_tpu_torch.ba import solve

    w_k, s_k = solve.run_ba(*_clone(args), **kw)
    with plain_ba():
        w_p, s_p = solve.run_ba(*_clone(args), **kw)
    return compare_run_ba(name, w_k, s_k, w_p, s_p)


@contextlib.contextmanager
def plain_init():
    """Within the block, ``init2f.CoarseInitializer.track`` runs its levels
    through the plain version ``init_level_torch`` also on the card: the
    yardstick of the kernel, never the port's path."""
    from ldso_tpu_torch import init2f

    kernel = init2f.init_level
    init2f.init_level = init2f.init_level_torch
    try:
        yield
    finally:
        init2f.init_level = kernel


@contextlib.contextmanager
def count_bootstrap():
    """Within the block, count the frames ``CoarseInitializer.track``
    tracks against the first (on whichever thread); yields a one-item list
    holding the count."""
    from ldso_tpu_torch.init2f import CoarseInitializer

    with count_calls(CoarseInitializer, "track") as made:
        yield made


def _check_init_launches(phase: str, launched: int, tracked: int) -> None:
    """One bootstrap kernel launch for each level of each tracked bootstrap
    frame, and at least one such frame."""
    if tracked < 1 or launched != LEVELS * tracked:
        raise RuntimeError(f"{phase}: bootstrap kernel launched {launched} times for {tracked} "
                           f"tracked bootstrap frames, expected {LEVELS * tracked}")


def init_level_chain(levels):
    """Walk one bootstrap frame's kept ``init_level`` calls (``levels``,
    coarsest first, each (args, keywords)) as ``CoarseInitializer.track``
    chains them, with the plain version: yields (args, keywords, the plain
    result, its ladder [iters, 2]); from the second level on the state
    arguments (T, ab, idepth, iR, good) are the plain result of the level
    before."""
    import torch

    from ldso_tpu_torch import init2f

    state = None
    for args, kw in levels:
        if state is not None:
            args = tuple(args[:4]) + state + tuple(args[9:])
        ladder = []
        out_p = init2f.init_level_torch(*args, **kw, ladder=ladder)
        lad = (torch.stack([torch.stack(e) for e in ladder]) if ladder
               else torch.zeros((0, 2), device=args[1].device))
        yield args, kw, out_p, lad
        state = (out_p.T, out_p.ab, out_p.idepth, out_p.iR, out_p.good)


def ladder_parting(lad_k, lad_p):
    """Where two runs' accept ladders ([iters, 2]: E and the trial's E'
    each iteration; accept iff E' < E) first decide apart: None if they
    never do, else (iteration, each run's relative energy change (E - E') /
    E there, whether both are within INIT_TIE_RTOL: a tie)."""
    import numpy as np

    a, b = np.asarray(lad_k, np.float64), np.asarray(lad_p, np.float64)
    acc_a, acc_b = a[:, 1] < a[:, 0], b[:, 1] < b[:, 0]
    parted = np.flatnonzero(acc_a != acc_b)
    if not len(parted):
        return None
    i = int(parted[0])
    rho = [float((x[i, 0] - x[i, 1]) / max(abs(x[i, 0]), 1e-30)) for x in (a, b)]
    return dict(it=i, rho_k=rho[0], rho_p=rho[1],
                tie=bool(max(abs(r) for r in rho) <= INIT_TIE_RTOL))


def init_normalized(T, iR, idepth, good) -> dict:
    """``CoarseInitializer.results()`` of a state: the depths (iR) rescaled
    to mean 1 over the good points with idepth > 0, the translation by the
    same factor."""
    import numpy as np

    good = np.asarray(good) & (np.asarray(idepth) > 0)
    d = np.asarray(iR, np.float64)
    rescale = 1.0 / max(float(np.mean(d[good])) if good.any() else 1.0, 1e-6)
    T = np.asarray(T, np.float64).copy()
    T[:3, 3] /= rescale
    return dict(T_first_to_new=T, idepth=d * rescale, good=good)


def g1_compare(ra: dict, rb: dict) -> dict:
    """Two normalized bootstrap results (``init_normalized`` or
    ``results()``) against G1's bounds: the points good in both, the
    median relative depth gap, the rotation gap (rad) and the cosine of the
    translations."""
    import numpy as np

    both = ra["good"] & rb["good"]
    frac = float(both.sum()) / max(int(ra["good"].sum()), int(rb["good"].sum()), 1)
    rel = np.abs(rb["idepth"][both] - ra["idepth"][both]) / ra["idepth"][both]
    med = float(np.median(rel)) if both.any() else float("inf")
    Ra, Rb = ra["T_first_to_new"][:3, :3], rb["T_first_to_new"][:3, :3]
    rot = float(np.arccos(np.clip((np.trace(Rb @ Ra.T) - 1) / 2, -1, 1)))
    ta, tb = ra["T_first_to_new"][:3, 3], rb["T_first_to_new"][:3, 3]
    cos = float(ta @ tb / (np.linalg.norm(ta) * np.linalg.norm(tb)))
    return dict(both=frac, idepth=med, rot=rot, cos=cos,
                ok=bool(frac >= INIT_G1_BOTH and med < INIT_G1_IDEPTH and rot < INIT_G1_ROT
                        and cos > INIT_G1_COS))


def _init_texels(args, kw, states) -> int:
    """The distinct texels of a level's [h, w, 3] stack whose bilinear
    corners the evaluations at ``states`` ((T, idepth, good) each) read:
    the samples in bounds of good points, as csrc/init_level.cu skips the
    rest."""
    import torch

    from ldso_tpu_torch.cameras import level_intrinsics
    from ldso_tpu_torch.core.window import pattern

    img3, uv, intr0, level = args[0], args[1], args[9], kw["level"]
    h, w = img3.shape[0], img3.shape[1]
    s = 0.5 ** level
    fx, fy, cx, cy = level_intrinsics(intr0, level)
    uvp = (uv * s + (0.5 * s - 0.5))[:, None, :] + pattern(uv.device)[None]
    xh = torch.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                      torch.ones_like(uvp[..., 0])], -1)
    idx = []
    for T, d, good in states:
        X = xh @ T[:3, :3].T + T[:3, 3] * d[:, None, None]
        okz = X[..., 2] > 1e-6
        zs = torch.where(okz, X[..., 2], torch.ones_like(X[..., 2]))
        un, vn = fx * X[..., 0] / zs + cx, fy * X[..., 1] / zs + cy
        use = (un >= 2) & (un < w - 3) & (vn >= 2) & (vn < h - 3) & okz & good[:, None]
        u0, v0 = un[use].floor().long(), vn[use].floor().long()
        idx += [v0 * w + u0, v0 * w + u0 + 1, (v0 + 1) * w + u0, (v0 + 1) * w + u0 + 1]
    return int(torch.cat(idx).unique().numel()) if idx else 0


def init_level_bound_ms(args, kw, out_k) -> tuple:
    """The least time the card could take for one level's GN loop as this
    run's data drove it (``out_k``, the kernel's ``LevelOut``): the larger
    of its bytes over the memory rate and its operations over the float32
    rate. Bytes: the texels read at the start and the final state (both are
    evaluated; the trial states between read more), 12 B each, each point's
    inputs (uv, colors, neighbours, idepth, iR, good) and outputs once, the
    pose, affine and intrinsics. Operations: INIT_FLOPS_SAMPLE a sample and
    INIT_FLOPS_POINT a point in each of the 1 + iters evaluations,
    INIT_FLOPS_OK for each sample with om > 0 (the kernel's ``n_ok_sum``),
    INIT_FLOPS_UPDATE and a median a point and INIT_FLOPS_STEP an iteration.
    Returns (ms, bound_by, bytes, flops)."""
    n, k = args[3].shape
    iters = kw["iters"]
    texels = _init_texels(args, kw, [(args[4], args[6], args[8]),
                                     (out_k.T, out_k.idepth, out_k.good)])
    n_bytes = 12 * texels + n * (49 + 4 * k) + n * 9 + 2 * 18 * 4 + 16 + 8 + 16
    flops = ((INIT_FLOPS_SAMPLE * 8 + INIT_FLOPS_POINT) * n * (1 + iters)
             + INIT_FLOPS_OK * int(out_k.n_ok_sum)
             + (INIT_FLOPS_UPDATE + k * (k - 1)) * n * iters + INIT_FLOPS_STEP * iters)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            n_bytes, flops)


def compare_init_level(out_k, out_p) -> dict:
    """The kernel's result on one level against the plain one's: the
    largest errors against the bounds above (idepth and iR as error over
    bound), the points beyond them and the good points that differ;
    ``held``: T, energy and good within their bounds, ``depths_held``: the
    depths too."""
    import torch

    def over(a, b):
        return (a - b).abs() / (INIT_ID_ATOL + INIT_ID_RTOL * b.abs())

    r_d, r_iR = over(out_k.idepth, out_p.idepth), over(out_k.iR, out_p.iR)
    e_T = float((out_k.T - out_p.T).abs().max())
    n_good = int((out_k.good != out_p.good).sum())
    e_E = abs(float(out_k.energy) - float(out_p.energy)) / max(abs(float(out_p.energy)), 1e-30)
    n_d, n_iR = int((r_d > 1).sum()), int((r_iR > 1).sum())
    max_abs = max(e_T, float((out_k.idepth - out_p.idepth).abs().max()),
                  float((out_k.iR - out_p.iR).abs().max()))
    held = (e_T <= INIT_T_ATOL and n_good <= INIT_POINTS_PARTED and e_E <= INIT_E_RTOL
            and bool(torch.isfinite(out_k.T).all()))
    return dict(e_T=e_T, e_idepth=float(r_d.max()), e_iR=float(r_iR.max()), n_idepth=n_d,
                n_iR=n_iR, good_parted=n_good, e_E=e_E, max_abs_err=max_abs, held=held,
                depths_held=bool(n_d <= INIT_POINTS_PARTED and n_iR <= INIT_POINTS_PARTED))


def check_init_frame(name: str, levels, time_it: bool = False) -> list:
    """Hold the bootstrap kernel against the plain version on one bootstrap
    frame's kept ``init_level`` calls, level by level on the plain chain's
    inputs (``init_level_chain``), by the bounds above: T, energy and good
    on every level; the depths too, or, where they miss and the two accept
    ladders part first at a tie (``ladder_parting``), G1's bounds on the
    normalized states (``g1_compare``), before the snap on at most
    INIT_MAX_PARTED levels; a second launch the same bits. Returns a record
    per level; with ``time_it`` also the kernel's device ms and the plain
    version's host-clock ms."""
    import torch

    from ldso_tpu_torch import init2f
    from ldso_tpu_torch.kernels import init_level as kinit

    records = []
    for args, kw, out_p, lad_p in init_level_chain(levels):
        out_k = kinit.init_level_cuda(*args, **kw, ladder=True)
        again = kinit.init_level_cuda(*args, **kw, ladder=True)
        torch.cuda.synchronize()
        for field, a, b in zip(kinit.LevelOut._fields, out_k, again):
            if a is not None and not torch.equal(a, b):
                raise RuntimeError(f"bootstrap kernel on {name}, level {kw['level']}: a second "
                                   f"launch differs in {field}")
        rec = dict(level=kw["level"], iters=kw["iters"], snapped=bool(kw["snapped"]),
                   points=args[1].shape[0], w=args[0].shape[1], h=args[0].shape[0],
                   **compare_init_level(out_k, out_p))
        part = ladder_parting(out_k.ladder.cpu(), lad_p.cpu())
        rec["parted_at"] = None if part is None else part["it"]
        rec["tie"] = part
        rec["g1"] = None
        state = "snapped" if kw["snapped"] else "before the snap"
        where = f"{name}, level {kw['level']} ({state})"
        text = (f"max|dT| {rec['e_T']:.3g} (atol {INIT_T_ATOL}), energy rel {rec['e_E']:.3g} "
                f"(rtol {INIT_E_RTOL}), good parted {rec['good_parted']}, idepth / iR error / "
                f"bound {rec['e_idepth']:.3g} / {rec['e_iR']:.3g} on {rec['n_idepth']} / "
                f"{rec['n_iR']} points (at most {INIT_POINTS_PARTED})")
        if not rec["held"]:
            raise RuntimeError(f"bootstrap kernel disagrees on {where}: {text}")
        if not rec["depths_held"]:
            if part is None or not part["tie"]:
                raise RuntimeError(
                    f"bootstrap kernel disagrees on {where}: {text}, and the ladders "
                    + ("never part" if part is None else
                       f"part at iteration {part['it']} with no tie (energy changes "
                       f"{part['rho_k']:.3g} / {part['rho_p']:.3g})"))
            g1 = rec["g1"] = g1_compare(
                init_normalized(*(x.cpu().numpy() for x in
                                  (out_p.T, out_p.iR, out_p.idepth, out_p.good))),
                init_normalized(*(x.cpu().numpy() for x in
                                  (out_k.T, out_k.iR, out_k.idepth, out_k.good))))
            if not g1["ok"]:
                raise RuntimeError(f"bootstrap kernel on {where}: {text}; the ladders part at a "
                                   f"tie at iteration {part['it']}, and the normalized states "
                                   f"miss G1's bounds: {g1}")
        rec["bound_ms"], rec["bound_by"], rec["bytes"], rec["flops"] = \
            init_level_bound_ms(args, kw, out_k)
        if time_it:
            rec["ms"] = _device_ms(lambda: kinit.init_level_cuda(*args, **kw), n=5, reps=5)
            rec["us_iter"] = 1e3 * rec["ms"] / max(kw["iters"], 1)
            rec["plain_ms"] = _timed_ms(lambda: init2f.init_level_torch(*args, **kw),
                                        torch.cuda.synchronize, reps=2)
        records.append(rec)
    n_parted = sum(1 for r in records if r["g1"] is not None and not r["snapped"])
    if n_parted > INIT_MAX_PARTED:
        raise RuntimeError(f"bootstrap kernel on {name}: {n_parted} levels before the snap held "
                           f"to G1 after a tie, more than {INIT_MAX_PARTED}")
    return records


def wide_init_levels(boot, cfg, intr, dev, n: int = 2048) -> list:
    """The ``init_level`` calls (args, keywords) of one
    ``CoarseInitializer.track`` of the first tracked bootstrap frame of
    ``boot`` (``BenchProbe``'s records) against its first frame, with
    ``n`` points selected (``cfg``'s ``init_points`` replaced), chained
    through the plain version: a width the main path never reaches."""
    import dataclasses

    from ldso_tpu_torch import init2f

    init = init2f.CoarseInitializer(
        cfg.replace(shapes=dataclasses.replace(cfg.shapes, init_points=n)), intr, dev)
    init.set_first(boot[0]["pyr"], boot[0]["gsq"])
    kept, level = [], init2f.init_level

    def keep(*args, **kw):
        kept.append((_clone(args), _clone(kw)))
        return init2f.init_level_torch(*args, **kw)

    init2f.init_level = keep
    try:
        init.track(boot[1]["pyr"])
    finally:
        init2f.init_level = level
    return kept


def check_bootstrap(boot, cfg, intr, dev) -> dict:
    """The whole bootstrap on the kept pyramids (``boot``: the record of
    ``set_first`` with its pyramid and gsq, then one of each tracked frame,
    as ``BenchProbe`` keeps them) through the kernel and through the plain
    version (``plain_init``), each on a fresh ``CoarseInitializer``: the
    same frames snap and finish, n_good within INIT_POINTS_PARTED a frame,
    and the two ``results()`` within G1's bounds. Returns the numbers."""
    from ldso_tpu_torch.init2f import CoarseInitializer

    runs = {}
    for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", plain_init())):
        init = CoarseInitializer(cfg, intr, dev)
        with ctx:
            init.set_first(boot[0]["pyr"], boot[0]["gsq"])
            sts = [init.track(rec["pyr"]) for rec in boot[1:]]
        runs[name] = (sts, init.results())
    (sk, rk), (sp, rp) = runs["kernel"], runs["plain"]
    flags = [((a["snapped"], a["done"]), (b["snapped"], b["done"])) for a, b in zip(sk, sp)]
    d_good = max(abs(a["n_good"] - b["n_good"]) for a, b in zip(sk, sp))
    g1 = g1_compare(rp, rk)
    rec = dict(frames=len(sk), snapped_at=next((i for i, s in enumerate(sk) if s["snapped"]), None),
               done=sk[-1]["done"], d_good=d_good, g1=g1)
    if any(a != b for a, b in flags) or d_good > INIT_POINTS_PARTED or not g1["ok"] \
            or not sk[-1]["done"]:
        raise RuntimeError(f"bootstrap with the kernel parts from the plain one: (snapped, done) "
                           f"a frame {flags}, n_good within {d_good} (at most "
                           f"{INIT_POINTS_PARTED}), G1 {g1}")
    return rec


def _pctl(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def drive_async(cfg, ds, frames, dev, sync, ate_sync: float, *, batched: bool = False,
                loop: bool = False) -> dict:
    """Phase 6: one free-running drive of an async mode on a fresh
    FullSystem, ended by finish_mapping() and shutdown(). Fails on a lost
    frame, a missing pose, fewer than 3 keyframes, no marginalization, an
    ATE above max(1.5 x ``ate_sync``, the floor), a worker thread left
    alive, or (``loop``) no closure."""
    import numpy as np

    from ldso_tpu_torch.loop.closing import AsyncLoopClosing
    from ldso_tpu_torch.system import FullSystem

    mode = dict(async_mapping=True)
    if batched:
        mode.update(pipeline_depth=8, batch_size=BATCH)
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev, **mode)
    threads = [system._map_thread]
    lc, n_pgo = None, [0]
    if loop:
        lc = AsyncLoopClosing(cfg, ds.intrinsics(), train_after=4)
        threads.append(lc._thread)
        system.on_keyframe = lc.on_keyframe
        system.loop_closing = lc
        run_pose_graph = lc.run_pose_graph

        def counted_pose_graph(s):
            run_pose_graph(s)
            n_pgo[0] += 1

        lc.run_pose_graph = counted_pose_graph
    n_init, n_fed, n_feed = None, 0, len(frames)
    t0 = time.perf_counter()
    try:
        for img_np, ts, expo in frames:
            if n_fed >= n_feed:
                break
            st = system.add_frame(img_np, ts, expo)
            n_fed += 1
            if st["status"] == "lost":
                raise RuntimeError(f"async drive {mode}: lost at frame {n_fed - 1}: {st}")
            if st["status"] == "initialized":
                n_init = n_fed
                if batched and (len(frames) - n_init) % BATCH == 0:
                    n_feed -= 1        # leave a tail of fewer than BATCH frames
        system.finish_mapping()
        if lc is not None:
            lc.finish()
            lc.finish_retrain()
        sync()
        dt = time.perf_counter() - t0
    finally:
        system.shutdown()
        if lc is not None:
            lc.shutdown()
    if any(t is not None and t.is_alive() for t in threads) \
            or system._map_thread is not None:
        raise RuntimeError(f"async drive {mode}: a worker thread outlived shutdown()")
    if n_init is None or system.is_lost:
        raise RuntimeError(f"async drive {mode}: not initialized or lost")
    n_poses = len(system.export_trajectory()[1])
    if n_poses != n_fed or system._pending or system._fbuf:
        raise RuntimeError(f"async drive {mode}: {n_poses} poses for {n_fed} frames fed")
    n_marg = sum(1 for k in system.kfs.values() if not k.in_window)
    if len(system.kfs) < 3 or n_marg < 1:
        raise RuntimeError(f"async drive {mode}: {len(system.kfs)} keyframes, {n_marg} "
                           f"marginalized")
    ate = _ate_pct(system, ds)
    bound = max(1.5 * ate_sync, ATE_MAX_PCT)
    if not ate <= bound:
        raise RuntimeError(f"async drive {mode}: ATE {ate:.3f}% of extent > {bound:.3f}%")
    n_tracked = n_fed - n_init
    lat = system.frame_latency_ms
    if len(lat) != n_tracked:
        raise RuntimeError(f"async drive {mode}: {len(lat)} latencies for {n_tracked} "
                           f"tracked frames")
    out = dict(ate=ate, bound=bound, n_fed=n_fed, n_init=n_init, n_tracked=n_tracked,
               n_kf=len(system.kfs), n_marg=n_marg, fps_all=n_fed / dt,
               lat_med=statistics.median(lat), lat_p95=_pctl(lat, 0.95),
               kf_suppressed=system.kf_suppressed, kf_shed_events=system.kf_shed_events,
               kf_stale_waits=system.kf_stale_waits,
               # one pyramid launch per bootstrap frame, then per frame, or
               # per full batch and per tail frame
               launches_expected=(n_init + n_tracked // BATCH + n_tracked % BATCH
                                  if batched else n_fed),
               n_tail=n_tracked % BATCH if batched else 0)
    if lc is not None:
        if lc.retrain_errors:
            raise RuntimeError(f"vocabulary retrain failed: {lc.retrain_errors}")
        opti = [k.S_cw_opti for k in system.kfs.values() if k.S_cw_opti is not None]
        if not all(np.isfinite(S).all() for S in opti):
            raise RuntimeError("non-finite pose-graph output")
        if len(lc.loops_closed) < 1 or n_pgo[0] < 1:
            raise RuntimeError(
                f"async loop drive: {len(lc.loops_closed)} closures, {n_pgo[0]} pose-graph "
                f"runs; rejected "
                f"{dict(collections.Counter(r.get('reason') for r in lc.rejected))}")
        out.update(n_loops=len(lc.loops_closed), n_pgo=n_pgo[0],
                   loops=[(a, b) for a, b, _ in lc.loops_closed])
    return out


def _mode_line(name: str, r: dict) -> str:
    extra = (f", {r['n_loops']} closures {r['loops']}, {r['n_pgo']} pose-graph runs"
             if "n_loops" in r else "")
    return (f"  {name}: {r['n_fed']} frames ({r['n_init']} to initialize, {r['n_tracked']} "
            f"tracked, 0 lost), {r['fps_all']:.3f} frames/s, latency median "
            f"{r['lat_med']:.1f} ms p95 {r['lat_p95']:.1f} ms, {r['n_kf']} KFs "
            f"({r['n_marg']} marginalized), kf_suppressed {r['kf_suppressed']}, "
            f"kf_shed_events {r['kf_shed_events']}, staleness waits {r['kf_stale_waits']}, "
            f"ATE {r['ate']:.4f}% (bound "
            f"{r['bound']:.3f}%), pyramid launches {r['launches']} (expected "
            f"{r['launches_expected']}), tracker launches {r['track_launches']}"
            + (f", BA kernel launches {r['ba_launches']}" if "ba_launches" in r else "")
            + extra)


def _drive_loop(cfg, ds, frames, dev, sync, loop_on: bool) -> dict:
    """One drive of the loop sequence, as bench.py::bench_loop_closure
    wires it, with a synchronous LoopClosing when ``loop_on``."""
    import numpy as np

    from ldso_tpu_torch.loop.closing import LoopClosing
    from ldso_tpu_torch.system import FullSystem

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    lc, pgo_s = None, []
    if loop_on:
        lc = LoopClosing(cfg, ds.intrinsics(), train_after=4)
        system.on_keyframe = lc.on_keyframe
        system.loop_closing = lc
        run_pose_graph = lc.run_pose_graph

        def timed_pose_graph(s):          # host time of each pose-graph run
            t = time.perf_counter()
            run_pose_graph(s)
            sync()
            pgo_s.append(time.perf_counter() - t)

        lc.run_pose_graph = timed_pose_graph
    statuses = []
    t0 = time.perf_counter()
    for img_np, ts, expo in frames:
        st = system.add_frame(img_np, ts, expo)
        statuses.append(st["status"])
        if st["status"] == "lost":
            raise RuntimeError(f"loop {'on' if loop_on else 'off'}: lost at frame "
                               f"{st['frame_id']}: {st}")
    sync()
    dt = time.perf_counter() - t0
    out = dict(system=system, lc=lc, n_kf=len(system.kfs), fps=len(frames) / dt,
               n_tracked=statuses.count("tracked"), ate=_ate_pct(system, ds),
               latency_ms=list(system.frame_latency_ms))
    if lc is not None:
        lc.finish_retrain()
        if lc._retrain_thread is not None and lc._retrain_thread.is_alive():
            raise RuntimeError("the vocabulary retrain did not finish")
        if lc.retrain_errors:
            raise RuntimeError(f"vocabulary retrain failed: {lc.retrain_errors}")
        opti = [k.S_cw_opti for k in system.kfs.values() if k.S_cw_opti is not None]
        if not all(np.isfinite(S).all() for S in opti):
            raise RuntimeError("non-finite pose-graph output")
        out.update(n_loops=len(lc.loops_closed), n_pgo=len(pgo_s), pgo_s=sum(pgo_s),
                   loops=[(a, b) for a, b, _ in lc.loops_closed],
                   rejected=dict(collections.Counter(r.get("reason") for r in lc.rejected)))
    return out


def _relocalize_revisit(system, lc, ds, frames, dev) -> dict:
    """tests/test_system.py's relocalization check on a revisited view:
    the frame after the second-to-last keyframe, against its pose."""
    import numpy as np
    import torch

    from ldso_tpu_torch.kernels.pyramid import build_pyramid

    kf = sorted(system.kfs.values(), key=lambda k: k.kf_id)[-2]
    fid = kf.frame_id + 1
    img = torch.as_tensor(frames[fid][0][: system.h, : system.w], device=dev)
    pyr, _ = build_pyramid(img, system.cfg.shapes.pyr_levels)
    rel = lc.relocalize(system, pyr)
    if rel is None or not np.isfinite(rel["T_cw"]).all():
        raise RuntimeError(f"relocalization on frame {fid} returned no pose: {rel}")

    def center(T):
        return -T[:3, :3].T @ T[:3, 3]

    d_est = float(np.linalg.norm(center(rel["T_cw"]) - center(kf.T_cw)))
    d_gt = float(np.linalg.norm(center(ds.gt_pose_c_w(fid))
                                - center(ds.gt_pose_c_w(kf.frame_id))))
    bound = max(4.0 * d_gt, 0.15)
    if not d_est < bound:
        raise RuntimeError(f"relocalized center {d_est:.4f} from its anchor, bound "
                           f"{bound:.4f}")
    return dict(frame=fid, kf_id=rel["kf_id"], n_inliers=rel["n_inliers"],
                d_est=d_est, bound=bound)


def drive_loop_pair(cfg, ds, frames, dev, sync) -> dict:
    """Phase 5: loop off, loop on, then relocalization on a revisit."""
    off = _drive_loop(cfg, ds, frames, dev, sync, loop_on=False)
    on = _drive_loop(cfg, ds, frames, dev, sync, loop_on=True)
    if on["n_loops"] < 1 or on["n_pgo"] < 1:
        raise RuntimeError(f"no loop closed ({on['n_loops']} closures, {on['n_pgo']} "
                           f"pose-graph runs; rejected {on['rejected']})")
    if not on["ate"] <= ATE_MAX_PCT:
        raise RuntimeError(f"loop-on ATE {on['ate']:.3f}% of extent > {ATE_MAX_PCT}%")
    reloc = _relocalize_revisit(on["system"], on["lc"], ds, frames, dev)
    return dict(off=off, on=on, reloc=reloc)


def _ate_pct_file(traj_file: str, ds_gt) -> tuple:
    """(ATE in % of extent, poses) of a TUM trajectory file against the
    renderer's ground truth (frame i has timestamp i·0.05)."""
    import numpy as np

    from ldso_tpu_torch.eval.ate import ate_rmse, read_tum_trajectory

    ts, pos, quat = read_tum_trajectory(traj_file)
    if not (np.isfinite(pos).all() and np.isfinite(quat).all()):
        raise RuntimeError("non-finite poses in the trajectory file")
    gt_c = np.stack([ds_gt.poses_w_c[int(round(t / 0.05))][:3, 3] for t in ts])
    rmse, _ = ate_rmse(pos, gt_c, with_scale=True)
    return 100.0 * rmse / float(np.linalg.norm(gt_c.max(0) - gt_c.min(0))), len(ts)


def drive_cli(root_dir: str, ds_gt, out_dir: str) -> dict:
    """Phase 7 (a): the command line, in-process, on the card at the default
    preset, on the dataset in ``root_dir``; checks its files as the module
    docstring says."""
    import contextlib
    import io

    from ldso_tpu_torch import cli

    traj, metrics, viz = (os.path.join(out_dir, n)
                          for n in ("traj.txt", "metrics.jsonl", "viz"))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", "--dataset", "tum", "--path", root_dir, "--preset",
                       "default", "--device", "cuda", "--output", traj,
                       "--metrics", metrics, "--viz", viz])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    n_fed = summary["frames"]
    if summary["lost"] or summary["skipped"] or n_fed != ds_gt.num_frames:
        raise RuntimeError(f"the CLI lost or skipped frames: {summary}")
    ate, n_poses = _ate_pct_file(traj, ds_gt)
    if n_poses < MIN_POSES:
        raise RuntimeError(f"only {n_poses} poses in the trajectory file")
    if not ate <= ATE_MAX_PCT:
        raise RuntimeError(f"CLI ATE {ate:.3f}% of extent > {ATE_MAX_PCT}%")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    ids = [r["frame"] for r in rows]
    # a record per tracked frame, none for a bootstrap frame: the ids run
    # from the end of the bootstrap to the last frame without a gap, so no
    # frame after it was lost
    if not rows or ids != list(range(n_fed - len(rows), n_fed)):
        raise RuntimeError(f"{len(rows)} metrics lines for {n_fed} frames fed: {ids}")
    ply = os.path.join(viz, "map.ply")
    with open(ply) as f:
        n_pts = int(next(line for line in f if line.startswith("element vertex")).split()[-1])
    if n_pts <= 0:
        raise RuntimeError("the PLY holds no point")
    return dict(summary=summary, wall=wall, ate=ate, n_poses=n_poses, n_fed=n_fed,
                n_metrics=len(rows), n_bootstrap=n_fed - len(rows), n_pts=n_pts)


def drive_resume(cfg, root_dir: str, out_dir: str, dev, sync) -> dict:
    """Phase 7 (b): read the dataset once, run A over all frames with a
    checkpoint after frame ``N_RESUME - 1``, run B from that checkpoint;
    the two trajectories must agree to RESUME_ATOL."""
    import numpy as np

    from ldso_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from ldso_tpu_torch.io.datasets import TumMonoDataset
    from ldso_tpu_torch.system import FullSystem

    reader = TumMonoDataset(root_dir, device=dev)
    try:
        frames, t_get = [], []
        for i in range(reader.num_frames):
            t = time.perf_counter()
            frames.append(reader.get_image(i))
            sync()
            t_get.append(time.perf_counter() - t)
        intr = reader.intrinsics()
    finally:
        reader.close()
    h, w = frames[0][0].shape

    n_tracked = [0]

    def feed(system, lo, hi):
        for i in range(lo, hi):
            st = system.add_frame(*frames[i])
            if st["status"] == "lost":
                raise RuntimeError(f"resume drive: lost at frame {i}: {st}")
            n_tracked[0] += st["status"] == "tracked"

    path = os.path.join(out_dir, "ckpt")
    a = FullSystem(cfg, intr, w, h, device=dev)
    feed(a, 0, N_RESUME)
    t = time.perf_counter()
    save_checkpoint(a, path)
    t_save = time.perf_counter() - t
    n_bytes = os.path.getsize(path + ".npz") + os.path.getsize(path + ".json")
    feed(a, N_RESUME, len(frames))
    t = time.perf_counter()
    b = load_checkpoint(path, cfg, device=dev)
    sync()
    t_load = time.perf_counter() - t
    if b.device.type != "cuda":
        raise RuntimeError(f"the checkpoint was loaded onto {b.device}")
    feed(b, N_RESUME, len(frames))
    (_, pa), (_, pb) = a.export_trajectory(), b.export_trajectory()
    if len(pa) != len(frames) or len(pb) != len(frames):
        raise RuntimeError(f"resume: {len(pa)} and {len(pb)} poses for {len(frames)} frames")
    if not (np.isfinite(pa).all() and np.isfinite(pb).all()):
        raise RuntimeError("resume: non-finite poses")
    gap = float(np.abs(pa[:, :3, 3] - pb[:, :3, 3]).max())
    if not gap <= RESUME_ATOL:
        raise RuntimeError(f"the resumed run parts from the uninterrupted one: max "
                           f"|position gap| {gap:.3g} > {RESUME_ATOL}")
    return dict(gap=gap, n_frames=len(frames), n_kf=(len(a.kfs), len(b.kfs)),
                t_save=t_save, t_load=t_load, n_bytes=n_bytes,
                get_ms=1e3 * statistics.median(t_get),
                launches_expected=2 * len(frames) - N_RESUME, n_tracked=n_tracked[0])


def reader_times(root_dir: str, dev, n: int = 20) -> dict:
    """Per-frame host decode time (zip read + PNG decode, on the feed
    thread, no prefetch), device time of response + vignette + remap (CUDA
    events) and the two copies' host time, on the dataset's own frames."""
    import zipfile

    import torch

    from ldso_tpu_torch.io import datasets

    reader = datasets.TumMonoDataset(root_dir, device=dev)
    try:
        with zipfile.ZipFile(os.path.join(root_dir, "images.zip")) as zf:
            blobs = [zf.read(name) for name in reader._names[:n]]
        t = time.perf_counter()
        raws = [datasets.decode_image(b) for b in blobs]
        decode_ms = 1e3 * (time.perf_counter() - t) / len(blobs)
        raw_dev = torch.from_numpy(raws[0]).to(dev)
        device_ms = _time_ms(lambda: reader._undistort(raw_dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for raw in raws:
            torch.from_numpy(raw).to(dev).cpu()
        copy_ms = 1e3 * (time.perf_counter() - t) / len(raws)
    finally:
        reader.close()
    return dict(decode_ms=decode_ms, device_ms=device_ms, copy_ms=copy_ms)


def _timed_ms(fn, sync, reps: int = 20) -> float:
    """Median host-clock ms of ``fn()`` ending in ``sync()``, after one warm-up."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def distributed_rank(out_dir: str, spec: dict) -> None:
    """Phase 8's program, run by every rank of a process group (the parent
    starts the ranks with ``distributed.mesh.spawn_ranks``); writes this
    rank's results to ``out_dir/rank<r>.npz``. ``spec``: ``device``,
    ``preset``, ``window`` (an npz of ``convert.to_numpy``), ``ba_steps``,
    and unless ``ba_only``: ``circle`` [(seed, lm_iters, cg_iters)],
    ``curve`` (K, n_loops, lm_iters, cg_iters) and ``dryrun``.

    (1) The point-sharded BA step on a 1-D mesh, ``ba_steps`` times, each
    under a wrapper that records every all-reduce's size; the all-reduce
    alone; (2) the meshes: the default ``make_mesh_2d()``, one row per
    rank, 3 hosts (ValueError), an all-gather of 10·(rank + 1); the BA step
    on a 2×2 mesh; (3) the edge-sharded PGO on the test circles; (4) the
    block PGO on the curve, twice; (5) ``graft_entry.dryrun_multichip``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ldso_tpu_torch import convert, graft_entry
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.distributed import mesh as dmesh
    from ldso_tpu_torch.distributed import sharded_ba, sharded_pgo
    from ldso_tpu_torch.eval import toys
    from ldso_tpu_torch.kernels import ba as ba_kernel
    from ldso_tpu_torch.kernels import pallas_pyramid

    dev = torch.device(spec["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rank, n = dist.get_rank(), dist.get_world_size()
    cfg = preset(spec["preset"])
    D = cfg.shapes.state_dim
    HM, bM = np.zeros((D, D), np.float32), np.zeros(D, np.float32)
    with np.load(spec["window"]) as z:
        win = convert.from_numpy("window", dict(z), device=dev)
    res = {}
    all_reduce, calls = dist.all_reduce, []

    def counted(step, w):
        """One BA step with every all-reduce's element count recorded."""
        def counting(t, *a, **k):
            calls.append(t.numel())
            return all_reduce(t, *a, **k)

        dist.all_reduce, n0 = counting, len(calls)
        try:
            w, E = step(w, HM, bM, lam=1e-5)
            E = float(E)
        finally:
            dist.all_reduce = all_reduce
        return w, E, calls[n0:]

    # (1) the sharded BA step, 1-D mesh
    mesh1 = sharded_ba.make_mesh()
    shard = sharded_ba.shard_window(win, mesh1)
    step = sharded_ba.make_distributed_ba_step(mesh1, cfg)
    w, E_ba, ms_ba, n_calls = shard, [], [], []
    for i in range(spec["ba_steps"]):
        sync()
        t = time.perf_counter()
        w, E, c = counted(step, w)
        ms_ba.append(1e3 * (time.perf_counter() - t))
        E_ba.append(E)
        n_calls.append(c)
        if i == 0:
            res.update(ba_x=w.x.cpu().numpy(), ba_c=w.c.cpu().numpy(),
                       ba_idepth=w.p_idepth.cpu().numpy())
    payload = torch.zeros(D * D + 2 * D + 1, device=dev)
    res.update(n_local=shard.num_points, ba_E=E_ba, ba_ms=ms_ba,
               ba_n_calls=[len(c) for c in n_calls], ba_call_sizes=sum(n_calls, []),
               allreduce_ms=_timed_ms(lambda: mesh1.psum_(payload), sync))
    if not spec.get("ba_only"):
        # (2) meshes and the 2x2 step
        res["mesh_default"] = dmesh.make_mesh_2d().shape
        res["mesh_rows"] = dmesh.make_mesh_2d(n_hosts=n).shape
        try:
            dmesh.make_mesh_2d(n_hosts=3)
            res["mesh_3_error"] = ""
        except ValueError as e:
            res["mesh_3_error"] = str(e)
        res["gathered"] = mesh1.all_gather(torch.tensor([10.0 * (rank + 1)], device=dev)
                                           ).cpu().numpy()
        mesh2 = dmesh.make_mesh_2d(n_hosts=2)
        step2 = sharded_ba.make_distributed_ba_step(mesh2, cfg)
        w2, E2, c2 = counted(step2, sharded_ba.shard_window(win, mesh2))
        res.update(ba2_x=w2.x.cpu().numpy(), ba2_idepth=w2.p_idepth.cpu().numpy(),
                   ba2_E=E2, ba2_calls=np.asarray(c2))

        # (3) edge-sharded PGO on the test circles
        pmesh = sharded_pgo.make_mesh()
        f32 = dict(dtype=torch.float32, device=dev)

        def circle(seed):
            _, S, ei, ej, S_meas, w_e, fixed = toys.sim3_circle_graph(24, seed)
            return (torch.as_tensor(S, **f32),
                    *sharded_pgo.shard_edges(ei, ej, S_meas.astype(np.float32),
                                             w_e.astype(np.float32), pmesh, device=dev),
                    torch.as_tensor(fixed, device=dev))

        # one LM step of one CG step first: first uses stay out of the timings
        sharded_pgo.make_distributed_pgo(pmesh, lm_iters=1, cg_iters=1)(*circle(0))
        for seed, lm, cg in spec["circle"]:
            args = circle(seed)
            run = sharded_pgo.make_distributed_pgo(pmesh, lm_iters=lm, cg_iters=cg)
            sync()
            t = time.perf_counter()
            out = run(*args)
            res[f"pgo{seed}_E"] = float(out.energy)
            res[f"pgo{seed}_ms"] = 1e3 * (time.perf_counter() - t)
            res[f"pgo{seed}_S"] = out.S.cpu().numpy()

        # (4) block-halo PGO on the curve
        K, n_loops, lm, cg = spec["curve"]
        _, S, ei, ej, S_meas, w_e, fixed = toys.sim3_curve_graph(K, n_loops)
        part = sharded_pgo.partition_pose_graph(K, ei, ej, S_meas, w_e, n)
        Kp = part["Kp"]
        S_p = np.concatenate([S, np.tile(np.eye(4, dtype=S.dtype), (Kp - K, 1, 1))])
        fixed_p = np.concatenate([fixed, np.ones(Kp - K, bool)])
        run_blk = sharded_pgo.make_block_pgo(pmesh, part, lm_iters=lm, cg_iters=cg,
                                             device=dev)
        sync()
        t = time.perf_counter()
        out = run_blk(torch.as_tensor(S_p, **f32), torch.as_tensor(fixed_p, device=dev))
        res.update(block_E=float(out.energy), block_ms=1e3 * (time.perf_counter() - t),
                   block_S=out.S.cpu().numpy(), block_B=part["B"], block_H=part["H"])
        # the same solve again: its sums run in a fixed order, so the same bits
        again = run_blk(torch.as_tensor(S_p, **f32), torch.as_tensor(fixed_p, device=dev))
        res.update(block_E_again=float(again.energy), block_S_again=again.S.cpu().numpy())

        # (5) the dry run, counting this rank's pyramid launches
        if spec["dryrun"]:
            pallas_pyramid.reset_launches()
            t = time.perf_counter()
            e = graft_entry.dryrun_multichip(mesh2, device=dev)
            res.update(dryrun=[e["ba"], e["pgo"], e["block_pgo"]],
                       dryrun_s=time.perf_counter() - t,
                       dryrun_launches=pallas_pyramid.LAUNCHES)
    # every sharded BA step above is one evaluation on this rank's shard
    res["ba_launches"] = ba_kernel.LAUNCHES
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def run_ranks(spec: dict, world: int, backend: str, out_dir: str, timeout_s: float,
              ranks_per_host=None) -> list:
    """Start ``world`` ranks of ``distributed_rank`` on this host; raises
    unless every rank exits 0 and wrote its sentinel; returns each rank's
    results as a dict."""
    import numpy as np

    from ldso_tpu_torch.distributed.mesh import spawn_ranks

    os.makedirs(out_dir, exist_ok=True)
    spawn_ranks(distributed_rank, world, (out_dir, spec), backend=backend,
                out_dir=out_dir, timeout_s=timeout_s, ranks_per_host=ranks_per_host)
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# the JAX package's bounds (tests/test_distributed.py): sharded against the
# single-process step (f32 reduction order, amplified by the solve), 2-D mesh
# against 1-D, edge-sharded PGO against the single process, block PGO quality
BA_X_ATOL, BA_IDEPTH_ATOL, BA_E_RTOL = 3e-3, 5e-3, 0.02
MESH2_X_ATOL, MESH2_IDEPTH_ATOL = 2e-3, 5e-3
PGO_E_RTOL, PGO_E_ATOL, PGO_S_ATOL = 0.05, 1e-8, 2e-3
BLOCK_E_FACTOR, BLOCK_ERR_FACTOR, BLOCK_ERR_ATOL = 1.25, 1.05, 1e-3


def single_process_refs(win, cfg, spec: dict, sync) -> dict:
    """The single-process counterparts on ``win``'s device: the BA step of
    ``_solve_core`` (the window after it, its energy as ``assemble`` reads
    it, host ms) and ``optimize_pose_graph`` on the circles and the curve
    of ``spec`` (float32)."""
    import numpy as np
    import torch

    from ldso_tpu_torch.ba.residuals import assemble
    from ldso_tpu_torch.ba.solve import (_solve_core, apply_step, fix_mask, prior_diag,
                                         scale_vector)
    from ldso_tpu_torch.core.window import state_delta
    from ldso_tpu_torch.eval import toys
    from ldso_tpu_torch.loop.posegraph import optimize_pose_graph

    dev = win.x.device
    F, D = cfg.shapes.max_frames, cfg.shapes.state_dim
    hub, osum = cfg.ba.huber_th, cfg.ba.outlier_th_sum_component
    z = torch.zeros(D, device=dev)
    s_vec = torch.as_tensor(scale_vector(F, cfg.scales), device=dev)
    fixed = torch.as_tensor(fix_mask(F, 0), device=dev)

    evals = [0]

    def step():
        evals[0] += 1
        sys = assemble(win, huber_th=hub, outlier_sum=osum)
        dx, dd = _solve_core(sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d,
                             torch.zeros((D, D), device=dev), z, state_delta(win),
                             prior_diag(win.frame_valid, cfg), s_vec, fixed, z, 1e-5,
                             win.p_valid)
        return apply_step(win, dx, dd)

    w_ref = step()
    refs = dict(win=w_ref, E=float(assemble(w_ref, huber_th=hub, outlier_sum=osum).energy),
                ba_ms=_timed_ms(step, sync, reps=5))
    refs["evals"] = evals[0] + 1
    f32 = dict(dtype=torch.float32, device=dev)
    graphs = [(f"pgo{seed}", toys.sim3_circle_graph(24, seed), lm, cg)
              for seed, lm, cg in spec["circle"]]
    K, n_loops, lm, cg = spec["curve"]
    graphs.append(("block", toys.sim3_curve_graph(K, n_loops), lm, cg))

    def pgo(graph, lm, cg):
        _, S, ei, ej, S_meas, w_e, fixed_v = graph
        return optimize_pose_graph(
            torch.as_tensor(S, **f32), torch.as_tensor(ei, device=dev),
            torch.as_tensor(ej, device=dev), torch.as_tensor(S_meas, **f32),
            torch.as_tensor(w_e, **f32), torch.as_tensor(fixed_v, device=dev),
            lm_iters=lm, cg_iters=cg)

    pgo(graphs[0][1], 1, 1)          # first uses stay out of the timings
    for name, graph, lm, cg in graphs:
        sync()
        t = time.perf_counter()
        out = pgo(graph, lm, cg)
        refs[f"{name}_E"] = float(out.energy)
        refs[f"{name}_ms"] = 1e3 * (time.perf_counter() - t)
        refs[f"{name}_S"] = out.S.cpu().numpy()
        refs[f"{name}_graph"] = graph[:2]
    return refs


def check_distributed(results: list, refs: dict, win, cfg, spec: dict) -> dict:
    """Hold the ranks' results (``distributed_rank``) to the JAX package's
    bounds against the single-process ``refs`` and to each other: raises
    on the first miss; returns the numbers compared."""
    import numpy as np

    from ldso_tpu_torch.ba.residuals import assemble
    from ldso_tpu_torch.eval import toys

    n = len(results)
    D = cfg.shapes.state_dim
    P = win.num_points
    r0 = results[0]

    def fail(msg):
        raise RuntimeError(f"phase 8: {msg}")

    def same_on_all(key):
        if not all(np.array_equal(r[key], r0[key]) for r in results[1:]):
            fail(f"{key} differs between ranks")

    # replicated outputs: bitwise equal on every rank
    for key in ["ba_x", "ba_c", "ba_E"] + (
            [] if "ba2_x" not in r0 else
            ["ba2_x", "ba2_E", "block_E", "gathered", "mesh_default"]
            + [f"pgo{s}_{k}" for s, _, _ in spec["circle"] for k in ("S", "E")]
            + (["dryrun"] if spec["dryrun"] else [])):
        same_on_all(key)
    if any(int(r["n_local"]) != P // n for r in results):
        fail(f"a rank does not hold P/n = {P // n} points")
    # one all-reduce of D²+2D+1 floats per step on the 1-D mesh
    want = D * D + 2 * D + 1
    n_calls, sizes = r0["ba_n_calls"].tolist(), r0["ba_call_sizes"].tolist()
    if n_calls != [1] * spec["ba_steps"] or sizes != [want] * spec["ba_steps"]:
        fail(f"all-reduces per step {n_calls} of {sizes} floats, expected one of {want}")
    E = [float(e) for e in r0["ba_E"]]
    if len(E) > 1 and not E[-1] < E[0]:
        fail(f"energy does not decrease over the steps: {E}")

    def full_idepth(key):
        return np.concatenate([r[key] for r in results])

    x, idepth = r0["ba_x"], full_idepth("ba_idepth")
    w_ref = refs["win"]
    err_x = float(np.abs(x - w_ref.x.cpu().numpy()).max())
    err_id = float(np.abs(idepth - w_ref.p_idepth.cpu().numpy()).max())
    w_out = w_ref._replace(x=w_ref.x.new_tensor(x), c=w_ref.c.new_tensor(r0["ba_c"]),
                           p_idepth=w_ref.p_idepth.new_tensor(idepth))
    e_out = float(assemble(w_out, huber_th=cfg.ba.huber_th,
                           outlier_sum=cfg.ba.outlier_th_sum_component).energy)
    if not (err_x <= BA_X_ATOL and err_id <= BA_IDEPTH_ATOL
            and abs(e_out - refs["E"]) < BA_E_RTOL * refs["E"]):
        fail(f"sharded BA step against the single process: max|dx| {err_x:.3g} (atol "
             f"{BA_X_ATOL}), max|d idepth| {err_id:.3g} (atol {BA_IDEPTH_ATOL}), energy "
             f"{e_out:.6g} against {refs['E']:.6g} (rtol {BA_E_RTOL})")
    out = dict(err_x=err_x, err_idepth=err_id, e_out=e_out, e_ref=refs["E"], E=E,
               allreduce_floats=want)
    if "ba2_x" not in r0:
        return out

    if tuple(r0["mesh_rows"]) != (n, 1) or not str(r0["mesh_3_error"]) and n % 3:
        fail(f"mesh shapes: {r0['mesh_rows']}, 3 hosts: {r0['mesh_3_error']!r}")
    if sorted(r0["gathered"].ravel().tolist()) != [10.0 * (k + 1) for k in range(n)]:
        fail(f"all-gather: {r0['gathered'].ravel().tolist()}")
    if r0["ba2_calls"].tolist() != [want, want]:
        fail(f"2x2 mesh all-reduces {r0['ba2_calls'].tolist()}, expected two of {want}")
    err2_x = float(np.abs(r0["ba2_x"] - x).max())
    err2_id = float(np.abs(full_idepth("ba2_idepth") - idepth).max())
    if not (err2_x <= MESH2_X_ATOL and err2_id <= MESH2_IDEPTH_ATOL):
        fail(f"2x2 mesh against 1-D: max|dx| {err2_x:.3g}, max|d idepth| {err2_id:.3g}")
    out.update(err2_x=err2_x, err2_idepth=err2_id)

    for seed, _, _ in spec["circle"]:
        k = f"pgo{seed}"
        e_d, e_s = float(r0[f"{k}_E"]), refs[f"{k}_E"]
        err_S = float(np.abs(r0[f"{k}_S"] - refs[f"{k}_S"]).max())
        gt, S0 = refs[f"{k}_graph"]
        c_gt = toys.sim3_centers(gt)
        err0 = float(np.linalg.norm(toys.sim3_centers(S0) - c_gt, axis=1).mean())
        err1 = float(np.linalg.norm(toys.sim3_centers(r0[f"{k}_S"]) - c_gt, axis=1).mean())
        if not (abs(e_d - e_s) <= PGO_E_ATOL + PGO_E_RTOL * abs(e_s) and err_S <= PGO_S_ATOL
                and err1 < 0.05 and err1 < 0.2 * err0):
            fail(f"edge-sharded PGO (circle seed {seed}): energy {e_d:.6g} against "
                 f"{e_s:.6g} (atol {PGO_E_ATOL} + rtol {PGO_E_RTOL}), max|dS| {err_S:.3g} "
                 f"(atol {PGO_S_ATOL}), "
                 f"centre error {err1:.4g} from {err0:.4g} (< 0.05 and < 0.2x)")
        out[k] = dict(E=e_d, E_ref=e_s, err_S=err_S, err0=err0, err1=err1)

    B, H = int(r0["block_B"]), int(r0["block_H"])
    K = spec["curve"][0]
    S_blk = np.concatenate([r["block_S"] for r in results])[:K]
    gt, _ = refs["block_graph"]
    c_gt = toys.sim3_centers(gt)
    err_ref = float(np.linalg.norm(toys.sim3_centers(refs["block_S"]) - c_gt, axis=1).mean())
    err_blk = float(np.linalg.norm(toys.sim3_centers(S_blk) - c_gt, axis=1).mean())
    e_blk = float(r0["block_E"])
    if not all(r["block_E_again"] == r["block_E"]
               and np.array_equal(r["block_S_again"], r["block_S"]) for r in results):
        fail(f"block PGO at K = {K} solved twice: energies {e_blk!r} and "
             f"{float(r0['block_E_again'])!r}, or the poses differ (ROADMAP G7)")
    if not (H < B // 4 and e_blk < BLOCK_E_FACTOR * refs["block_E"] + 1e-6
            and err_blk < BLOCK_ERR_FACTOR * err_ref + BLOCK_ERR_ATOL):
        fail(f"block PGO at K = {K}: H {H}, B {B}; energy {e_blk:.6g} against "
             f"{refs['block_E']:.6g}; centre error {err_blk:.5g} against {err_ref:.5g}")
    out["block"] = dict(B=B, H=H, E=e_blk, E_again=float(r0["block_E_again"]),
                        E_ref=refs["block_E"], err=err_blk, err_ref=err_ref)
    if spec["dryrun"]:
        if not np.isfinite(r0["dryrun"]).all():
            fail(f"dry run energies {r0['dryrun'].tolist()}")
        out["dryrun"] = r0["dryrun"].tolist()
    return out


def drive_distributed(dev, work_dir: str) -> dict:
    """Phase 8: the toy window once in this process (640x480, 10 frames,
    ``preset("default")``, one-level pyramids on the card), written through
    ``convert.to_numpy``; the single-process references on the card; then
    (a, c, d, e) 4 gloo ranks on the one card and (b) 1 NCCL rank, each
    held by ``check_distributed``. Any rank's failure raises."""
    import numpy as np
    import torch

    from ldso_tpu_torch import convert
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.eval.toys import make_synthetic_window
    from ldso_tpu_torch.kernels import ba as ba_kernel
    from ldso_tpu_torch.kernels import pallas_pyramid

    sync = torch.cuda.synchronize
    cfg = preset("default")
    t = time.perf_counter()
    n0 = pallas_pyramid.LAUNCHES
    win, _ = make_synthetic_window(cfg, w=W, h=H, n_frames=DIST_FRAMES, device=dev)
    sync()
    launches_toy = pallas_pyramid.LAUNCHES - n0
    if launches_toy != DIST_FRAMES:
        raise RuntimeError(f"the toy window launched the pyramid kernel {launches_toy} "
                           f"times for {DIST_FRAMES} frames")
    t_toy = time.perf_counter() - t
    path = os.path.join(work_dir, "window.npz")
    np.savez(path, **convert.to_numpy(win))
    spec = dict(DIST_SPEC, device="cuda", window=path)
    t = time.perf_counter()
    ba_kernel.reset_launches()
    refs = single_process_refs(win, cfg, spec, sync)
    t_refs = time.perf_counter() - t
    t = time.perf_counter()
    gloo = run_ranks(spec, DIST_RANKS, "gloo", os.path.join(work_dir, "gloo"),
                     timeout_s=DIST_TIMEOUT_S)
    t_gloo = time.perf_counter() - t
    chk = check_distributed(gloo, refs, win, cfg, spec)
    spec1 = dict(spec, ba_only=True)
    t = time.perf_counter()
    nccl = run_ranks(spec1, 1, "nccl", os.path.join(work_dir, "nccl"),
                     timeout_s=DIST_TIMEOUT_S)
    t_nccl = time.perf_counter() - t
    chk1 = check_distributed(nccl, refs, win, cfg, spec1)
    # the BA kernel: the references' evaluations and one in each check here;
    # in every rank one a sharded step (ba_steps, the 2x2 mesh's, the dry run's)
    ba_parent = ba_kernel.LAUNCHES
    if ba_parent != ba_kernel.PER_EVALUATION * (refs["evals"] + 2):
        raise RuntimeError(f"BA kernel launched {ba_parent} times for the references and "
                           f"checks of phase 8, expected "
                           f"{ba_kernel.PER_EVALUATION * (refs['evals'] + 2)}")
    for rs, sp in ((gloo, spec), (nccl, spec1)):
        steps = sp["ba_steps"] + (0 if sp.get("ba_only") else 1 + int(bool(sp["dryrun"])))
        got = [int(r["ba_launches"]) for r in rs]
        if got != [ba_kernel.PER_EVALUATION * steps] * len(rs):
            raise RuntimeError(f"BA kernel launches by rank {got}, expected "
                               f"{ba_kernel.PER_EVALUATION * steps} each ({steps} sharded steps)")
    ba_launches = ba_parent + sum(int(r["ba_launches"]) for r in gloo + nccl)
    # every rank's dry run builds its 6 toy frames with the kernel, 1 level
    launches = launches_toy + sum(int(r["dryrun_launches"]) for r in gloo)
    if launches != DIST_FRAMES + DIST_RANKS * 6:
        raise RuntimeError(f"pyramid kernel launched {launches} times in phase 8, expected "
                           f"{DIST_FRAMES + DIST_RANKS * 6}")
    return dict(gloo=gloo[0], nccl=nccl[0], refs=refs, chk=chk, chk1=chk1, launches=launches,
                ba_launches=ba_launches, t_toy=t_toy, t_refs=t_refs, t_gloo=t_gloo,
                t_nccl=t_nccl)


def _dist_lines(d: dict, card: str) -> list:
    """Phase 8's result lines."""
    g, c, refs = d["gloo"], d["chk"], d["refs"]
    ms = ", ".join(f"{x:.2f}" for x in g["ba_ms"])
    blk = c["block"]
    circles = "; ".join(
        f"circle seed {s} ({lm} LM x {cg} CG): {g[f'pgo{s}_ms']:.0f} ms against "
        f"{refs[f'pgo{s}_ms']:.0f} ms single-process, energy {c[f'pgo{s}']['E']:.6g} / "
        f"{c[f'pgo{s}']['E_ref']:.6g}, max|dS| {c[f'pgo{s}']['err_S']:.3g}, centre error "
        f"{c[f'pgo{s}']['err1']:.4g} from {c[f'pgo{s}']['err0']:.4g}"
        for s, lm, cg in DIST_SPEC["circle"])
    K, n_loops, lm, cg = DIST_SPEC["curve"]
    return [
        f"distributed BA: {DIST_RANKS} gloo ranks on cuda:0, preset default, {W}x{H}, "
        f"{DIST_FRAMES} frames, P/{DIST_RANKS} = {int(g['n_local'])} points per rank; one "
        f"all-reduce of {c['allreduce_floats']} floats per step; sharded step {ms} ms "
        f"(host clock, steps 1..{len(g['ba_ms'])}, synchronized), single-process step "
        f"{refs['ba_ms']:.2f} ms, the all-reduce alone {float(g['allreduce_ms']):.3f} ms; "
        f"against the single process max|dx| {c['err_x']:.3g} (atol {BA_X_ATOL}), "
        f"max|d idepth| {c['err_idepth']:.3g} (atol {BA_IDEPTH_ATOL}), energy after the "
        f"step {c['e_out']:.6g} / {c['e_ref']:.6g}; energies over the steps "
        f"{[round(e, 3) for e in c['E']]}; 2x2 mesh against 1-D max|dx| "
        f"{c['err2_x']:.3g}, max|d idepth| {c['err2_idepth']:.3g}; NCCL, 1 rank: steps "
        f"{', '.join(f'{x:.2f}' for x in d['nccl']['ba_ms'])} ms, all-reduce "
        f"{float(d['nccl']['allreduce_ms']):.3f}"
        f" ms, max|dx| {d['chk1']['err_x']:.3g}, max|d idepth| {d['chk1']['err_idepth']:.3g} "
        f"| {card}",
        f"distributed PGO: edge-sharded, {DIST_RANKS} gloo ranks: {circles}; block-halo at K "
        f"= {K} ({n_loops} loops, {lm} LM x {cg} CG): B {blk['B']}, H {blk['H']}, "
        f"{float(g['block_ms']):.0f} ms against {refs['block_ms']:.0f} ms single-process, "
        f"energy {blk['E']!r} (solved again: {blk['E_again']!r}, bitwise equal) / "
        f"{blk['E_ref']:.6g}, centre error {blk['err']:.5g} / "
        f"{blk['err_ref']:.5g} | {card}",
        f"distributed dry run (graft_entry.dryrun_multichip, {DIST_RANKS} ranks, 2x2 mesh): "
        f"energies BA {c['dryrun'][0]:.6g}, PGO {c['dryrun'][1]:.4g}, block PGO "
        f"{c['dryrun'][2]:.4g}, {float(g['dryrun_s']):.1f} s; pyramid launches "
        f"{d['launches']} (1 level); toy window {d['t_toy']:.1f} s, single-process "
        f"references {d['t_refs']:.1f} s, gloo ranks {d['t_gloo']:.1f} s (start to join), "
        f"NCCL rank {d['t_nccl']:.1f} s | {card}",
    ]


def main() -> int:
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ldso_tpu_torch")):
        raise SystemExit("chip_smoke.py: ldso_tpu_torch/ not found next to this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this script drives the port on a CUDA card only")

    # ---- 1. device
    import ldso_tpu_torch  # noqa: F401  (sets the float32 precision flags)
    from ldso_tpu_torch.kernels import ba as ba_kernel
    from ldso_tpu_torch.kernels import cuda_build, pallas_pyramid, track_level
    from ldso_tpu_torch.kernels import init_level as init_kernel
    from ldso_tpu_torch.kernels import predict as predict_kernel
    from ldso_tpu_torch.kernels import trace as trace_kernel
    from ldso_tpu_torch.kernels.pyramid import build_pyramid_torch

    card = _card_line()
    dev = torch.device("cuda", 0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}",
          flush=True)

    # ---- 2. build; the inputs are rendered in worker processes meanwhile
    import concurrent.futures
    import multiprocessing
    import tempfile

    from ldso_tpu_torch import native
    from ldso_tpu_torch.io import datasets

    sys.path.insert(0, os.path.join(root, "scripts"))
    import torch_tum_fixture

    tmp = tempfile.TemporaryDirectory(prefix="ldso_smoke_")
    t_inputs = time.perf_counter()
    n_workers = min(8, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=n_workers, mp_context=multiprocessing.get_context("spawn")) as renders, \
            concurrent.futures.ThreadPoolExecutor(max_workers=14) as pool:
        # the dataset first: its frames cost the most (rendered larger,
        # warped through the lens, PNG-encoded)
        futures = [
            pool.submit(torch_tum_fixture.make_tum_fixture, os.path.join(tmp.name, "tum"),
                        n=N_FRAMES, w=W, h=H, omega=TUM_OMEGA, seed=3, pool=renders),
            pool.submit(_render_bench, N_FRAMES, pool=renders),
            pool.submit(_render_bench, LOOP_FRAMES, LOOP_W, LOOP_H, seed=5,
                        traj_kind="out_and_back", pool=renders)]
        t0 = time.perf_counter()
        builds = [pool.submit(pallas_pyramid.build), pool.submit(track_level.build),
                  pool.submit(track_level.build, True), pool.submit(trace_kernel.build),
                  pool.submit(cuda_build.ptxas_report, track_level.SOURCE),
                  pool.submit(cuda_build.ptxas_report, trace_kernel.SOURCE, (),
                              trace_kernel.NO_FMAD),
                  pool.submit(ba_kernel.build),
                  pool.submit(cuda_build.ptxas_report, ba_kernel.SOURCE, (), ba_kernel.NO_FMAD),
                  pool.submit(init_kernel.build),
                  pool.submit(cuda_build.ptxas_report, init_kernel.SOURCE),
                  pool.submit(predict_kernel.build),
                  pool.submit(cuda_build.ptxas_report, predict_kernel.SOURCE, (),
                              predict_kernel.NO_FMAD),
                  pool.submit(native.available)]
        (lib, lib_track, lib_phases, lib_trace, ptxas, ptxas_trace, lib_ba, ptxas_ba, lib_init,
         ptxas_init, lib_predict, ptxas_predict, has_native) = (b.result() for b in builds)
        reason = ""
        if not has_native:
            lines = (native.unavailable_reason() or "no reason given").strip().splitlines()
            # the compiler's or linker's own complaint, else the last line
            reason = f" ({next((ln for ln in lines if 'error' in ln), lines[-1]).strip()})"
        print(f"build: {os.path.relpath(lib, root)}, {os.path.relpath(lib_track, root)} "
              f"({ptxas_kernels(ptxas)}), {os.path.relpath(lib_phases, root)} (the tracker "
              f"kernel with -DTRACK_LEVEL_PHASES), {os.path.relpath(lib_trace, root)} "
              f"(-fmad=false; {ptxas_kernels(ptxas_trace)}), {os.path.relpath(lib_ba, root)} "
              f"(-fmad=false; {ptxas_kernels(ptxas_ba)}), {os.path.relpath(lib_init, root)} "
              f"({ptxas_kernels(ptxas_init)}), {os.path.relpath(lib_predict, root)} "
              f"(-fmad=false; {ptxas_kernels(ptxas_predict)}); native image loader "
              f"{'built' if has_native else 'NOT built'}{reason}; frames will be decoded by "
              f"'{datasets.active_decoder()}'; {time.perf_counter() - t0:.2f} s", flush=True)
        (tum_root, tum_gt), (ds, frames), (lds, lframes) = (f.result() for f in futures)
    print(f"dataset: {N_FRAMES} frames {W}x{H} in the TUM-monoVO layout (FOV omega "
          f"{TUM_OMEGA}, crop mode), the bench sequence and the loop sequence rendered "
          f"in {n_workers} worker processes beside the build in "
          f"{time.perf_counter() - t_inputs:.1f} s", flush=True)

    # ---- 3. kernel vs plain, on the card
    rng = np.random.default_rng(0)

    def random_f32(b, h, w):
        return torch.as_tensor(rng.random((b, h, w), np.float32) * 255.0, device=dev)

    bench8 = torch.as_tensor(np.stack([f[0] for f in frames[:8]]), device=dev)
    tum_reader = datasets.TumMonoDataset(tum_root, device=dev)
    tum_f32 = torch.as_tensor(tum_reader.get_image(N_FRAMES // 2)[0], device=dev)
    tum_reader.close()
    if tum_f32.dtype != torch.float32 or tuple(tum_f32.shape) != (H, W):
        raise RuntimeError(f"the reader gave {tum_f32.dtype} {tuple(tum_f32.shape)}")
    inputs = {
        "bench_u8 B=1": bench8[0], "bench_u8 B=8": bench8,
        "random_f32 B=1": random_f32(1, H, W)[0], "random_f32 B=8": random_f32(8, H, W),
        # the batch of phase 6 (b), and a loop frame of phases 5 and 6 (c)
        f"bench_u8 B={BATCH}": bench8[:BATCH].contiguous(),
        f"random_f32 B={BATCH}": random_f32(BATCH, H, W),
        f"loop_u8 {LOOP_W}x{LOOP_H} B=1": torch.as_tensor(lframes[LOOP_FRAMES // 2][0],
                                                          device=dev),
        f"random_f32 {LOOP_W}x{LOOP_H} B=1": random_f32(1, LOOP_H, LOOP_W)[0],
        # an undistorted irradiance frame, as phase 7's reader hands it over
        f"tum_f32 {W}x{H} B=1": tum_f32,
        f"bench_u8 {PART_W}x{PART_H} B=1": bench8[0, :PART_H, :PART_W].contiguous(),
        f"bench_u8 {PART_W}x{PART_H} B=8": bench8[:, :PART_H, :PART_W].contiguous(),
        f"random_f32 {PART_W}x{PART_H} B=1": random_f32(1, PART_H, PART_W)[0],
        f"random_f32 {PART_W}x{PART_H} B=8": random_f32(8, PART_H, PART_W),
    }
    max_err = max(max(check_pyramid(name, img)) for name, img in inputs.items())
    # one level on float32, as the toy windows of phase 8 build it: its
    # 640x480 window, the dry run's 320x240 and the 128x96 of graft_entry.entry()
    f32_l1 = random_f32(1, H, W)[0]
    for name, img in ((f"random_f32 {W}x{H} B=1", f32_l1),
                      (f"random_f32 {LOOP_W}x{LOOP_H} B=1", random_f32(1, LOOP_H, LOOP_W)[0]),
                      ("random_f32 128x96 B=1", random_f32(1, 96, 128)[0])):
        max_err = max(max_err, *check_pyramid(f"{name}, 1 level", img, levels=1))
    img1, img8 = inputs["bench_u8 B=1"], inputs["bench_u8 B=8"]
    kernel1 = lambda: pallas_pyramid.build_pyramid_cuda(img1, LEVELS)  # noqa: E731
    kernel8 = lambda: pallas_pyramid.build_pyramid_cuda(img8, LEVELS)  # noqa: E731
    plain = lambda: build_pyramid_torch(img1, LEVELS)                   # noqa: E731
    # in turns (plain, kernel, kernel, plain), so drift hits both alike
    p1, k1, k2, p2 = (_time_ms(fn) for fn in (plain, kernel1, kernel1, plain))
    ms_call, ms_p = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    ms_k1, ms_k8 = _device_ms(kernel1), _device_ms(kernel8)
    ms_f32 = _device_ms(lambda: pallas_pyramid.build_pyramid_cuda(tum_f32, LEVELS))
    ms_l1 = _device_ms(lambda: pallas_pyramid.build_pyramid_cuda(f32_l1, 1))
    plain_l1 = 0.5 * sum(_time_ms(lambda: build_pyramid_torch(f32_l1, 1)) for _ in range(2))
    bound1, bound_by = pyramid_bound_ms(1, H, W, LEVELS, 1)
    bound8, _ = pyramid_bound_ms(8, H, W, LEVELS, 1)
    bound_f32, _ = pyramid_bound_ms(1, H, W, LEVELS, 4)
    bound_l1, bound_by_l1 = pyramid_bound_ms(1, H, W, 1, 4)
    print(f"kernel pyramid timing [bench_u8 {W}x{H}, {LEVELS} levels, one launch]: "
          f"device B=1 {ms_k1:.4f} ms (bound {bound1:.5f} ms by {bound_by}), device B=8 "
          f"{ms_k8:.4f} ms (bound {bound8:.5f} ms), float32 frame B=1 {ms_f32:.4f} ms "
          f"(bound {bound_f32:.5f} ms), whole call B=1 {ms_call:.4f} ms, "
          f"plain B=1 {ms_p:.4f} ms; float32 frame at 1 level (phase 8) device "
          f"{ms_l1:.4f} ms (bound {bound_l1:.5f} ms by {bound_by_l1}), plain {plain_l1:.4f} ms"
          f" | {card}", flush=True)

    # ---- 4. the main path, at the untouched default preset
    from ldso_tpu_torch import frame_step, tracker
    from ldso_tpu_torch.config import preset

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    _reset_launches()
    probe = BenchProbe(TRACK_CAPTURE, TRACK_PROFILE)
    from ldso_tpu_torch import frame_step as fs_mod
    from ldso_tpu_torch import trace as tr_mod

    with count_keyframes() as kf_main, count_ba() as ba_main_evals, \
            count_bootstrap() as boot_main, \
            count_calls(fs_mod, "trace_slot_tables") as trace_tables_main, \
            count_calls(tr_mod, "activation_slot_tables") as act_tables_main:
        main = drive_bench(preset("default"), ds, frames, dev, sync=sync, probe=probe)
    # the kernels make their slot tables: the torch yardsticks run 0 times
    if trace_tables_main[0] or act_tables_main[0]:
        raise RuntimeError(f"phase 4: the kernel path called trace_slot_tables "
                           f"{trace_tables_main[0]} times, activation_slot_tables "
                           f"{act_tables_main[0]} times")
    launches_main = pallas_pyramid.LAUNCHES
    track_main, predict_main = track_level.LAUNCHES, predict_kernel.LAUNCHES
    trace_main, act_main = trace_kernel.LAUNCHES_TRACE, trace_kernel.LAUNCHES_ACTIVATE
    ba_main = ba_kernel.LAUNCHES
    init_main = init_kernel.LAUNCHES
    # one launch per frame: a bootstrap frame builds one pyramid too
    if launches_main != len(frames) or main["n_tracked"] == 0:
        raise RuntimeError(f"pyramid kernel launched {launches_main} times for "
                           f"{len(frames)} frames ({main['n_tracked']} tracked)")
    _check_track_launches("phase 4", track_main, main["n_tracked"], predict_main)
    _check_trace_launches("phase 4", trace_main, act_main, main["n_tracked"], kf_main[0])
    _check_ba_launches("phase 4", ba_main, ba_main_evals[0])
    _check_init_launches("phase 4", init_main, boot_main[0])
    print(f"main path: {len(frames)} frames ({main['n_init']} to initialize, "
          f"{main['n_tracked']} tracked, 0 lost), {main['n_kf']} KFs ({main['n_marg']} "
          f"marginalized), {main['n_corner_act']} corner-seeded activations, ATE "
          f"{main['ate']:.4f}% of extent (limit {ATE_MAX_PCT}%; JAX package "
          f"{REF_SYNC_ATE}% on the same frames, BENCH_r05.json), steady-state "
          f"{main['fps']:.3f} frames/s over {main['n_rate']} frames of {N_WARM}.."
          f"{len(frames) - 1} (the profiled {TRACK_PROFILE[0]}..{TRACK_PROFILE[-1]} left "
          f"out; host clock, synchronized per frame), pyramid launches {launches_main}, "
          f"tracker launches {track_main} ({TRACK_LAUNCHES} per tracked frame), trace launches "
          f"{trace_main} (1 per tracked frame), activation launches {act_main} (1 per "
          f"keyframe built, {kf_main[0]}; trace_slot_tables / activation_slot_tables "
          f"called {trace_tables_main[0]} / {act_tables_main[0]} times), BA kernel launches "
          f"{ba_main} "
          f"({ba_kernel.PER_EVALUATION} per evaluation, {ba_main_evals[0]} evaluations), "
          f"bootstrap kernel launches {init_main} ({LEVELS} per tracked bootstrap frame, "
          f"{boot_main[0]} frames), phase wall time {time.perf_counter() - t_phase:.1f} s "
          f"| {card}", flush=True)
    boot_s = sum(main["t_boot"])
    print(f"bootstrap: {main['n_init']} frames to initialize ({boot_main[0]} tracked against the "
          f"first), {boot_s:.3f} s from the first add_frame to initialized (host clock, "
          f"synchronized per frame; the probe's copies of its inputs included), per frame "
          + ", ".join(f"{t:.3f}" for t in main["t_boot"]) + f" s | {card}", flush=True)
    prof = probe.summary()
    split = ", ".join(f"{k} {prof[k]['host_ms']:.2f} ms host / {prof[k]['device_ms']:.3f} ms "
                      f"device ({prof[k]['calls']} calls)" for k in BenchProbe.LABELS)
    busy = "not measured" if prof["busy"] is None else f"{100 * prof['busy']:.2f}%"
    print(f"main path profile (torch.profiler over bench frames {TRACK_PROFILE[0]}.."
          f"{TRACK_PROFILE[-1]}, per frame): {prof['wall_ms']:.2f} ms wall (host clock, "
          f"under the profiler), {prof['launches_per_frame']:.1f} device kernels / copies, "
          f"device busy {busy}; {split} | {card}", flush=True)
    print(f"keyframe path by stage (same profile, per keyframe, {prof['keyframe']['calls']} "
          f"keyframes): whole {prof['keyframe']['host_ms_call']:.2f} ms host / "
          f"{prof['keyframe']['device_ms_call']:.3f} ms device; " + ", ".join(
              f"{k} {prof[k]['host_ms_call'] * prof[k]['calls'] / max(prof['keyframe']['calls'], 1):.2f}"
              f" / {prof[k]['device_ms_call'] * prof[k]['calls'] / max(prof['keyframe']['calls'], 1):.3f}"
              f" ms ({prof[k]['calls']} calls)" for k in BenchProbe.KF_STAGES)
          + f" (the kernels' own device time is not under a label) | {card}", flush=True)
    bs = prof["ba_split"]
    print(f"run_ba by part (same profile, per call, {bs['calls']} calls, "
          f"{bs['assemble_calls']:.2f} assemblies a call): {bs['host_ms']:.2f} ms host / "
          f"{bs['device_ms']:.3f} ms device (torch ops) + {bs['kernel_device_ms']:.4f} ms of "
          f"the BA kernel; host: assemble {bs['ba_assemble']:.2f} (pair tables in torch "
          f"{bs['ba_precompute']:.2f}, {bs['precompute_calls']:.2f} precompute_pairs calls a "
          f"run_ba), _solve_core {bs['ba_solve_core']:.2f}, apply_step "
          f"{bs['ba_apply_step']:.2f}, state_delta {bs['ba_state_delta']:.2f}, host syncs "
          f"{bs['syncs']:.2f}, copies {bs['copies']:.2f}, the rest {bs['rest']:.2f} ms; hand "
          f"kernels' device ms a frame " + ", ".join(f"{k} {v:.4f}"
                                                      for k, v in prof["kernels"].items())
          + f" | {card}", flush=True)

    # ---- 4b. the tracker kernel on the main path's real inputs
    t_phase = time.perf_counter()
    missing = [i for i in TRACK_CAPTURE if "track" not in probe.inputs.get(i, {})]
    if missing:
        raise RuntimeError(f"phase 4 kept no tracking inputs on frames {missing}")
    mid = TRACK_CAPTURE[len(TRACK_CAPTURE) // 2]
    track_recs = {}
    for i in TRACK_CAPTURE:
        recs = check_track_level(f"bench frame {i}", probe.inputs[i]["track"],
                                 time_it=(i == mid))
        track_recs[i] = recs
        print(f"kernel track_level vs plain [bench frame {i}, the system's ref, pyramid and "
              f"{recs[0]['lanes']} hypotheses]: " + "; ".join(
                  f"L{r['level']} {r['w']}x{r['h']} {r['lanes']}x{r['points']}: max|dT| "
                  f"{r['e_T']:.3g}, max|dab| {r['e_ab']:.3g}, rmse rel {r['e_rm']:.3g}, "
                  f"counts {r['e_n']}, iterations {_iters_text(r)}" + "".join(
                      f", lane {k} parted at a tie at iteration {t['cap']} ({t['moved']} moved,"
                      f" energy change {t['rho']:.2g}; |dab| {t['d_ab']:.3g} from there)"
                      for k, t in r["ties"].items()) for r in recs)
              + f" (bounds: T {TRACK_T_ATOL}, ab {TRACK_AB_ATOL}, or {TRACK_TIE_AB_ATOL} on "
                f"a lane parted at a tie (energy change <= {TRACK_TIE_RTOL}; at most "
                f"{TRACK_MAX_TIES} a frame), rmse rtol {TRACK_RMSE_RTOL} lane by lane, counts "
                f"{TRACK_COUNT_FRAC:.0%} of N_l)",
              flush=True)
    frame_recs = {}
    for i in TRACK_CAPTURE:
        fr = frame_recs[i] = check_track_frame(f"bench frame {i}", probe.inputs[i]["track"],
                                               track_recs[i])
        print(f"kernel track_level, two launches [bench frame {i}]: bitwise equal to the "
              f"one-level calls chained on their own outputs at every level (winner lane "
              f"{fr['best']} both), bitwise equal in a second run; whole track_frame against "
              f"the plain chain max|dT| {fr['d_T']:.3g}, max|dab| {fr['d_ab']:.3g}, rmse rel "
              f"{fr['d_rmse']:.3g} (bounds: T {TRACK_T_ATOL}, ab "
              + (f"{TRACK_TIE_AB_ATOL} and rmse not held: ties reaching the pose (level, "
                 f"lane) {fr['reach']})" if fr["reach"] else
                 f"{TRACK_AB_ATOL}, rmse {TRACK_RMSE_RTOL})"), flush=True)
    recs = track_recs[mid]
    args = probe.inputs[mid]["track"]
    track_ms = sum(r["ms"] for r in recs)
    track_frame_ms = _device_ms(lambda: fused_levels(args))
    track_plain_ms = sum(r["plain_ms"] for r in recs)
    track_bound_ms = sum(r["bound_ms"] for r in recs)
    track_bound_by = max(("bytes", "operations"), key=lambda by: sum(
        r["bound_ms"] for r in recs if r["bound_by"] == by))
    track_err = max(r["e_T"] for rs in track_recs.values() for r in rs)
    track_ties = sum(len(r["ties"]) for rs in track_recs.values() for r in rs)
    print(f"kernel track_level timing [bench frame {mid}, per level one-level launches: device "
          f"ms (queued behind a spin kernel) / us an iteration of the slowest lane / cluster x "
          f"threads / plain ms (host clock, synchronized) / bound ms]: "
          + "; ".join(f"L{r['level']} {r['ms']:.4f} / {r['us_iter']:.2f} / {r['cluster']}x"
                      f"{r['threads']} / {r['plain_ms']:.2f} / {r['bound_ms']:.6f} by "
                      f"{r['bound_by']} ({r['bytes']} B, {r['flops']} flops)" for r in recs)
          + f"; the five levels {track_ms:.4f} ms, the frame's two launches "
            f"{track_frame_ms:.4f} ms device, plain {track_plain_ms:.2f} ms, bound "
            f"{track_bound_ms:.6f} ms (mostly by {track_bound_by}) | {card}", flush=True)
    phases = track_level_phases(args)
    print(f"kernel track_level phases [bench frame {mid}, -DTRACK_LEVEL_PHASES, thread 0 of the "
          f"slowest lane's rank-0 CTA, clock64 cycles an evaluation]: " + "; ".join(
              f"L{r['level']} " + ", ".join(f"{n} {r[n]:.0f}" for n in _phase_keys(r))
              + f", {r['cycles_per_iteration']:.0f} an iteration over {r['evaluations']} "
                f"evaluations" for r in phases) + f" | {card}", flush=True)
    n_k, dev_ms_k = _device_events(lambda: tracker.track_frame(*args))
    with plain_tracker():
        n_p, dev_ms_p = _device_events(lambda: tracker.track_frame(*args))
    if n_k > TRACK_MAX_EVENTS:
        raise RuntimeError(f"one track_frame call took {n_k} device kernels, more than "
                           f"{TRACK_MAX_EVENTS}")
    # no host sync anywhere in a track_frame call on the card
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracker.track_frame(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step = probe.inputs[mid]["step"]
    n_step, ms_step = _device_events(lambda: frame_step.fused_step(*step))
    with plain_tracker():
        n_step_p, ms_step_p = _device_events(lambda: frame_step.fused_step(*step))
        with plain_trace():
            n_step_pp, ms_step_pp = _device_events(lambda: frame_step.fused_step(*step))
    if n_step >= STEP_MAX_EVENTS:
        raise RuntimeError(f"one fused_step took {n_step} device kernels / copies, not fewer "
                           f"than {STEP_MAX_EVENTS}")
    print(f"track_frame on bench frame {mid}: {n_k} device kernels / copies, {dev_ms_k:.3f} ms "
          f"device (kernel path; at most {TRACK_MAX_EVENTS}); plain version {n_p}, "
          f"{dev_ms_p:.3f} ms; ran under torch.cuda.set_sync_debug_mode('error') without a "
          f"host sync. One whole fused_step (non-keyframe work of a tracked frame): {n_step} "
          f"device kernels / copies, {ms_step:.3f} ms device; with the plain tracker "
          f"{n_step_p}, {ms_step_p:.3f} ms; with the plain tracker and the plain trace "
          f"{n_step_pp}, {ms_step_pp:.3f} ms (torch.profiler; fewer than {STEP_MAX_EVENTS} "
          f"held); phase wall time {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 4c. the trace and activation kernels on the main path's real inputs
    t_phase = time.perf_counter()
    from ldso_tpu_torch import trace as trace_mod

    missing = [i for i in TRACK_CAPTURE if "trace" not in probe.inputs.get(i, {})]
    if missing or len(probe.activations) < ACT_KEEP:
        raise RuntimeError(f"phase 4 kept no trace inputs on frames {missing} or "
                           f"{len(probe.activations)} activations of {ACT_KEEP}")
    trace_recs = {}
    for i in TRACK_CAPTURE:
        r = trace_recs[i] = check_trace(f"bench frame {i}", probe.inputs[i]["trace"],
                                        time_it=(i == mid))
        print(f"kernel trace vs plain [bench frame {i}, the system's bank of {r['rows']} rows, "
              f"{r['valid']} valid; status GOOD / OOB / OUTLIER / SKIPPED / BADCONDITION "
              f"{r['status']}]: bank fields max|err| {r['e_abs']:.3g}, quality rel "
              f"{r['e_quality']:.3g}, rows parted at a tie {r['parted']} (ties found "
              f"{r['ties_found']}; at most {TRACE_MAX_TIES}), bitwise equal in a second launch "
              f"(bounds: atol {TRACE_ATOL} + rtol {TRACE_RTOL}, best_uv {TRACE_UV_ATOL} px on "
              f"GOOD rows; ties within rtol {TRACE_TIE_RTOL} of a threshold or {TRACE_TIE_PX} px"
              f" of the border); slot {_table_text(r['table'])} against trace_slot_tables "
              f"| {card}", flush=True)
    tr = trace_recs[mid]
    print(f"kernel trace timing [bench frame {mid}, one launch]: device {tr['ms']:.4f} ms "
          f"(queued behind a spin kernel), plain _trace_core_torch {tr['plain_ms']:.4f} ms "
          f"(CUDA events over back-to-back calls), bound {tr['bound_ms']:.6f} ms by "
          f"{tr['bound_by']} ({tr['bytes']} B, {tr['flops']} flops) | {card}", flush=True)
    act_recs = []
    for j, call in enumerate(probe.activations):
        r = check_activate(f"keyframe {j + 1} after bench frame {ACT_AFTER}", call,
                           time_it=(j == 0))
        act_recs.append(r)
        print(f"kernel activate vs plain [keyframe {j + 1} after bench frame {ACT_AFTER}: "
              f"{r['rows']} rows, {r['candidates']} candidates, {r['slots']} window slots]: "
              f"can equal, idepth rel {r['e_idepth']:.3g} (max|err| {r['e_abs']:.3g}), H_dd rel "
              f"{r['e_H']:.3g}, energy rel {r['e_E']:.3g}, rows parted at a tie "
              f"{r['parted']} (ties found {r['ties_found']}; at most {ACT_MAX_TIES}), bitwise "
              f"equal in a second launch (bounds: idepth atol {ACT_IDEPTH_ATOL} + rtol "
              f"{ACT_IDEPTH_RTOL}, sums atol {ACT_SUM_ATOL} + rtol {ACT_SUM_RTOL}, count equal), "
              f"bit for bit the kernel's order replayed in torch (activate_replay); "
              f"{_table_text(r['table'])} against activation_slot_tables | {card}", flush=True)
    ar = act_recs[0]
    args_a, kw_a = probe.activations[0]
    n_act, ms_act = _device_events(lambda: trace_mod.activate_candidates_device(*args_a, **kw_a))
    with plain_trace():
        n_act_p, ms_act_p = _device_events(
            lambda: trace_mod.activate_candidates_device(*args_a, **kw_a))
    print(f"kernel activate timing [keyframe 1 after bench frame {ACT_AFTER}, one launch]: "
          f"device {ar['ms']:.4f} ms (queued behind a spin kernel), plain "
          f"activate_candidates_torch {ar['plain_ms']:.4f} ms, bound {ar['bound_ms']:.6f} ms by "
          f"{ar['bound_by']} ({ar['bytes']} B, {ar['flops']} flops); one "
          f"activate_candidates_device call {n_act} device kernels / copies, {ms_act:.3f} ms "
          f"device, plain {n_act_p}, {ms_act_p:.3f} ms (torch.profiler); phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 4d. the BA linearization kernel on the main path's real windows
    t_phase = time.perf_counter()
    from ldso_tpu_torch.ba import residuals as ba_residuals
    from ldso_tpu_torch.ba import solve as ba_solve

    if len(probe.ba_calls) < ACT_KEEP or not probe.marg_calls:
        raise RuntimeError(f"phase 4 kept {len(probe.ba_calls)} run_ba calls of {ACT_KEEP} and "
                           f"{len(probe.marg_calls)} point folds of 1")
    ba_recs, run_recs = [], []
    for j, (args, kw) in enumerate(probe.ba_calls):
        name = f"run_ba {j + 1} after bench frame {ACT_AFTER}"
        for mode in ("active", "fej", "energy"):
            r = check_ba(name, args[0], args[3], mode, time_it=(j == 0 and mode == "active"))
            ba_recs.append(r)
            print(f"kernel ba_assemble vs plain [{name}, mode {mode}: {r['points']} points on "
                  f"{r['hosts']} host slots, {r['slots']} slots, {r['num_res']} residuals]: "
                  f"energy rel {r['e_energy']:.3g}, error / bound up to {r['used']:.3g} "
                  f"(max|err| {r['max_abs_err']:.3g}), pairs parted at a tie {r['parted']} "
                  f"(ties found {r['ties_found']}; at most {K4_MAX_TIES}), bitwise equal in a "
                  f"second launch (bounds: rtol {K4_RTOL} + {K4_ATOL_FRAC} x each entry's "
                  f"Cauchy-Schwarz bound on its terms, energy rel {K4_E_RTOL}, masks and count "
                  f"equal); {_table_text(r['table'])} | {card}",
                  flush=True)
        rr = check_run_ba(name, args, kw)
        run_recs.append(rr)
        print(f"run_ba kernel vs plain [{name}]: iterations {rr['iterations']}, "
              + (f"ladders part at a tie at step {rr['tie_at']} (energy change "
                 f"{rr['tie_rho']:.3g} < {K4_LADDER_TIE_RTOL})" if "tie_at" in rr else
                 f"the same lambda ladder of {rr['ladder']} steps, max|dx| {rr['e_x']:.3g} "
                 f"(bound {K4_X_ATOL}), c rel {rr['e_c']:.3g} ({K4_C_RTOL}), idepth rel "
                 f"{rr['e_idepth']:.3g} (atol {K4_IDEPTH_ATOL} + rtol {K4_IDEPTH_RTOL}), mask "
                 f"entries parted {rr['masks_parted']}, final energy rel {rr['e_final']:.3g}")
              + f" | {card}", flush=True)
    m_args, _ = probe.marg_calls[0]
    r = check_ba("marginalize_points", marg_window(m_args), m_args[4], "fej")
    ba_recs.append(r)
    print(f"kernel ba_assemble vs plain [marginalize_points, mode fej: {r['points']} points "
          f"folded]: energy rel {r['e_energy']:.3g}, error / bound up to {r['used']:.3g}, "
          f"pairs parted at a tie {r['parted']}, bitwise equal in a second launch; "
          f"{_table_text(r['table'])} | {card}", flush=True)
    table_diff = [r["table"] for r in ba_recs
                  if r["table"]["entries"] or not r["table"]["slot_equal"]]
    br = ba_recs[0]
    b_args, b_kw = probe.ba_calls[0]
    with count_calls(ba_residuals, "precompute_pairs") as pre_calls:
        n_ba, ms_ba = _device_events(lambda: ba_solve.run_ba(*_clone(b_args), **b_kw))
    if pre_calls[0]:
        raise RuntimeError(f"run_ba on the kernel's path called precompute_pairs "
                           f"{pre_calls[0]} times")
    with plain_ba():
        n_ba_p, ms_ba_p = _device_events(lambda: ba_solve.run_ba(*_clone(b_args), **b_kw))
    print(f"kernel ba_assemble timing [run_ba 1 after bench frame {ACT_AFTER}, mode active, "
          f"{ba_kernel.PER_EVALUATION} launch]: device {br['ms']:.4f} ms (queued behind a spin "
          f"kernel; the two-launch version on an H100: 0.0971 ms), bound "
          f"{br['bound_ms']:.6f} ms by {br['bound_by']} ({br['bytes']} B, {br['flops']} flops); "
          f"the whole assemble call {br['call_ms']:.4f} ms (CUDA events over back-to-back "
          f"calls; the two-launch version 1.69-4.30 ms with its pair tables in torch), "
          f"{br['host_ms']:.4f} ms host clock a call; plain "
          f"assemble_torch {br['plain_ms']:.4f} ms; pair tables made in the kernel against "
          f"ba_slot_tables on {len(ba_recs)} windows: "
          + ("bit for bit" if not table_diff else "; ".join(_table_text(t) for t in table_diff))
          + f"; one run_ba call {n_ba} device kernels / copies (the two-launch version: "
          f"1685), {ms_ba:.3f} ms device, {pre_calls[0]} precompute_pairs calls, plain "
          f"{n_ba_p}, {ms_ba_p:.3f} ms "
          f"(torch.profiler); phase wall time {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)

    # ---- 4e. the bootstrap kernel on the main path's bootstrap
    t_phase = time.perf_counter()
    first = max(j for j, rec in enumerate(probe.boot) if "gsq" in rec)
    boot = probe.boot[first:]
    if len(boot) != main["n_init"] or any(len(rec["levels"]) != LEVELS for rec in boot[1:]):
        raise RuntimeError(f"phase 4 kept {len(boot)} bootstrap frames of {main['n_init']}, "
                           f"levels {[len(rec['levels']) for rec in boot[1:]]}")
    init_recs = []
    for j, rec in enumerate(boot[1:]):
        lrecs = check_init_frame(f"bootstrap frame {j + 1}", rec["levels"],
                                 time_it=(j == len(boot) - 2))
        init_recs.append(lrecs)
        print(f"kernel init_level vs plain [bootstrap frame {j + 1} of {len(boot) - 1}, "
              f"{lrecs[0]['points']} points, "
              f"{'snapped' if lrecs[0]['snapped'] else 'before the snap'}"
              f", the plain chain's inputs]: " + "; ".join(
                  f"L{r['level']} {r['w']}x{r['h']} {r['iters']} it: max|dT| {r['e_T']:.3g}, "
                  f"idepth / iR error / bound {r['e_idepth']:.3g} / {r['e_iR']:.3g} ({r['n_idepth']}"
                  f" / {r['n_iR']} points beyond), good parted {r['good_parted']}, energy rel "
                  f"{r['e_E']:.3g}, ladders "
                  + ("equal" if r["parted_at"] is None else f"part at iteration {r['parted_at']}")
                  + ("" if r["g1"] is None else
                     f" (a tie: held to G1, median idepth {r['g1']['idepth']:.3g}, rotation "
                     f"{r['g1']['rot']:.3g}, cos {r['g1']['cos']:.6f})") for r in lrecs)
              + f"; bitwise equal in a second launch (bounds: T {INIT_T_ATOL}, energy rtol "
                f"{INIT_E_RTOL}, good, idepth and iR (atol {INIT_ID_ATOL} + rtol {INIT_ID_RTOL})"
                f" but for {INIT_POINTS_PARTED} points; the depths of a level whose ladders part "
                f"at a tie (rtol {INIT_TIE_RTOL}) held to G1, before the snap at most "
                f"{INIT_MAX_PARTED} a frame) | {card}", flush=True)
    bb = check_bootstrap(boot, preset("default"), ds.intrinsics(), dev)
    print(f"bootstrap, kernel against plain on the kept pyramids: {bb['frames']} frames tracked, "
          f"snapped at frame {bb['snapped_at']} and finished on the last in both, n_good within "
          f"{bb['d_good']} (at most {INIT_POINTS_PARTED}); results() both good "
          f"{bb['g1']['both']:.4f}"
          f", median idepth gap {bb['g1']['idepth']:.3g} (bound {INIT_G1_IDEPTH}), rotation "
          f"{bb['g1']['rot']:.3g} rad ({INIT_G1_ROT}), translation cos {bb['g1']['cos']:.6f} "
          f"({INIT_G1_COS}) | {card}", flush=True)
    wide = wide_init_levels(boot, preset("default"), ds.intrinsics(), dev, WIDE_POINTS)
    n_wide = wide[WIDE_LEVEL][0][1].shape[0]
    wr = check_init_frame(f"{n_wide} points, bootstrap frame 1",
                          wide[WIDE_LEVEL:WIDE_LEVEL + 1])[0]
    print(f"kernel init_level vs plain [{n_wide} points, bootstrap frame 1, L{wr['level']} "
          f"{wr['w']}x{wr['h']} {wr['iters']} it, a cluster of "
          f"{init_kernel.launch_config(n_wide)[0]} CTAs]: max|dT| {wr['e_T']:.3g}, idepth / iR "
          f"error / bound {wr['e_idepth']:.3g} / {wr['e_iR']:.3g} ({wr['n_idepth']} / "
          f"{wr['n_iR']} points beyond), good parted {wr['good_parted']}, energy rel "
          f"{wr['e_E']:.3g}, ladders "
          + ("equal" if wr["parted_at"] is None else f"part at iteration {wr['parted_at']}")
          + f"; bitwise equal in a second launch | {card}", flush=True)
    timed = init_recs[-1]
    init_ms = sum(r["ms"] for r in timed)
    init_plain_ms = sum(r["plain_ms"] for r in timed)
    init_bound_ms = sum(r["bound_ms"] for r in timed)
    init_bound_by = max(("bytes", "operations"), key=lambda by: sum(
        r["bound_ms"] for r in timed if r["bound_by"] == by))
    init_err = max(r["max_abs_err"] for rs in init_recs for r in rs)
    init_ties = sum(1 for rs in init_recs for r in rs if r["g1"] is not None)
    init_parted = sum(1 for rs in init_recs for r in rs if r["parted_at"] is not None)
    init_cluster, init_threads = init_kernel.launch_config(timed[0]["points"])
    print(f"kernel init_level timing [bootstrap frame {len(boot) - 1}, one launch a level, a "
          f"cluster of {init_cluster} CTAs x {init_threads} threads: "
          f"device ms (queued behind a spin kernel) / us an iteration / plain ms (host clock, "
          f"synchronized) / bound ms]: " + "; ".join(
              f"L{r['level']} {r['ms']:.4f} / {r['us_iter']:.2f} / {r['plain_ms']:.2f} / "
              f"{r['bound_ms']:.6f} by {r['bound_by']} ({r['bytes']} B, {r['flops']} flops)"
              for r in timed)
          + f"; the frame's {LEVELS} launches {init_ms:.4f} ms device, plain {init_plain_ms:.2f} "
            f"ms, bound {init_bound_ms:.6f} ms (mostly by {init_bound_by}); levels whose ladders "
            f"part anywhere {init_parted} of {sum(len(rs) for rs in init_recs)}, held to G1 "
            f"{init_ties}; phase wall time {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)

    # ---- 4f. the prediction kernel (K7) on the main path's real inputs
    t_phase = time.perf_counter()
    pred_recs = {i: check_predict(f"bench frame {i}", probe.inputs[i]["step"],
                                  time_it=(i == mid)) for i in TRACK_CAPTURE}
    pr = pred_recs[mid]
    print(f"kernel predict vs plain [bench frames {', '.join(map(str, TRACK_CAPTURE))}, the "
          f"system's T_last and T_prelast, {pr['num']} hypotheses]: bit for bit the plain chain "
          f"and a second launch on every frame; bench frame {mid}: device {pr['ms']:.4f} ms "
          f"(queued behind a spin kernel), whole call {pr['host_ms']:.4f} ms host, plain "
          f"chain {pr['plain_host_ms']:.4f} ms host and {pr['plain_kernels']} device kernels / "
          f"copies ({pr['plain_ms']:.4f} ms device), bound {pr['bound_ms']:.7f} ms by "
          f"{pr['bound_by']} ({pr['bytes']} B, {pr['flops']} flops); phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 5. loop closure on the loop sequence
    t_phase = time.perf_counter()
    _reset_launches()
    with count_keyframes() as kf_loop, count_ba() as ba_loop_evals, \
            count_bootstrap() as boot_loop:
        loop = drive_loop_pair(preset("default"), lds, lframes, dev, sync=sync)
    ba_loop = ba_kernel.LAUNCHES
    init_loop = init_kernel.LAUNCHES
    _check_ba_launches("phase 5", ba_loop, ba_loop_evals[0])
    _check_init_launches("phase 5", init_loop, boot_loop[0])
    launches_loop = pallas_pyramid.LAUNCHES
    track_loop, predict_loop = track_level.LAUNCHES, predict_kernel.LAUNCHES
    trace_loop, act_loop = trace_kernel.LAUNCHES_TRACE, trace_kernel.LAUNCHES_ACTIVATE
    _check_track_launches("phase 5", track_loop,
                          loop["off"]["n_tracked"] + loop["on"]["n_tracked"], predict_loop)
    _check_trace_launches("phase 5", trace_loop, act_loop,
                          loop["off"]["n_tracked"] + loop["on"]["n_tracked"], kf_loop[0])
    # two drives of one launch per frame, and the relocalization's pyramid
    if launches_loop != 2 * len(lframes) + 1:
        raise RuntimeError(f"pyramid kernel launched {launches_loop} times in the loop "
                           f"phase, expected {2 * len(lframes) + 1}")
    off, on = loop["off"], loop["on"]
    print(f"loop closure: {LOOP_FRAMES} frames {LOOP_W}x{LOOP_H} out_and_back, 0 lost "
          f"in both drives; ATE loop off {off['ate']:.4f}% -> loop on {on['ate']:.4f}% "
          f"of extent (limit {ATE_MAX_PCT}%; JAX package {REF_LOOP_OFF_ATE}% -> "
          f"{REF_LOOP_ON_ATE}%, BENCH_r05.json); "
          f"{on['n_loops']} closures accepted "
          f"{on['loops']}, rejected {on['rejected']}; {on['n_pgo']} pose-graph runs, "
          f"{on['pgo_s']:.3f} s host time; {off['n_kf']} / {on['n_kf']} KFs; "
          f"{off['fps']:.3f} / {on['fps']:.3f} frames/s (all frames, host clock, "
          f"synchronized per frame); relocalization on frame {loop['reloc']['frame']} "
          f"-> kf {loop['reloc']['kf_id']} with {loop['reloc']['n_inliers']} inliers, "
          f"center offset {loop['reloc']['d_est']:.4f} (bound {loop['reloc']['bound']:.4f}); "
          f"pyramid launches {launches_loop}, tracker launches {track_loop}, trace launches "
          f"{trace_loop}, activation launches {act_loop}, BA kernel launches {ba_loop}, "
          f"bootstrap kernel launches {init_loop} ({boot_loop[0]} bootstrap frames); phase "
          f"wall time "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 6. async modes, free-running
    t_phase = time.perf_counter()
    drives = {}
    for name, kw, seq, ate_sync in (
            (f"(a) async, first {N_ASYNC_A} frames", dict(), (ds, frames[:N_ASYNC_A]),
             main["ate"]),
            (f"(b) async + pipeline_depth 8 + batch {BATCH}", dict(batched=True),
             (ds, frames), main["ate"]),
            ("(c) async + AsyncLoopClosing, loop sequence", dict(loop=True),
             (lds, lframes), on["ate"])):
        _reset_launches()
        with count_keyframes() as kf_async, count_ba() as ba_async_evals, \
                count_bootstrap() as boot_async:
            r = drive_async(preset("default"), *seq, dev, sync, ate_sync, **kw)
        r["ba_launches"] = ba_kernel.LAUNCHES
        r["init_launches"] = init_kernel.LAUNCHES
        _check_ba_launches(name, r["ba_launches"], ba_async_evals[0])
        _check_init_launches(name, r["init_launches"], boot_async[0])
        r["launches"] = pallas_pyramid.LAUNCHES
        r["track_launches"] = track_level.LAUNCHES
        r["predict_launches"] = predict_kernel.LAUNCHES
        r["trace_launches"] = trace_kernel.LAUNCHES_TRACE
        r["act_launches"] = trace_kernel.LAUNCHES_ACTIVATE
        _check_track_launches(name, r["track_launches"], r["n_tracked"],
                              r["predict_launches"])
        _check_trace_launches(name, r["trace_launches"], r["act_launches"], r["n_tracked"],
                              kf_async[0])
        if r["launches"] != r["launches_expected"]:
            raise RuntimeError(f"{name}: pyramid kernel launched {r['launches']} times, "
                               f"expected {r['launches_expected']}")
        drives[name] = r
    if drives[f"(b) async + pipeline_depth 8 + batch {BATCH}"]["n_tail"] < 1:
        raise RuntimeError("the batched drive left no tail of fewer than a batch")
    launches_async = sum(r["launches"] for r in drives.values())
    track_async = sum(r["track_launches"] for r in drives.values())
    predict_async = sum(r["predict_launches"] for r in drives.values())
    trace_async = sum(r["trace_launches"] for r in drives.values())
    act_async = sum(r["act_launches"] for r in drives.values())
    ba_async = sum(r["ba_launches"] for r in drives.values())
    init_async = sum(r["init_launches"] for r in drives.values())
    print(f"async modes (free-running, host clock over the whole drive with its drain; "
          f"latency = add_frame to pose available) | {card}", flush=True)
    print(f"  sync, bench sequence (phase 4): {len(frames)} frames, "
          f"{main['fps_all']:.3f} frames/s, latency median "
          f"{statistics.median(main['latency_ms']):.1f} ms p95 "
          f"{_pctl(main['latency_ms'], 0.95):.1f} ms, {main['n_kf']} KFs, ATE "
          f"{main['ate']:.4f}%", flush=True)
    print(f"  sync + LoopClosing, loop sequence (phase 5): {len(lframes)} frames, "
          f"{on['fps']:.3f} frames/s, latency median "
          f"{statistics.median(on['latency_ms']):.1f} ms p95 "
          f"{_pctl(on['latency_ms'], 0.95):.1f} ms, {on['n_kf']} KFs, ATE {on['ate']:.4f}%",
          flush=True)
    for name, r in drives.items():
        print(_mode_line(name, r), flush=True)
    print(f"async modes: phase wall time {time.perf_counter() - t_phase:.1f} s | {card}",
          flush=True)

    # ---- 7. the dataset path: the command line, then checkpoint and resume
    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp.name, "out")
    os.makedirs(out_dir)
    _reset_launches()
    with count_keyframes() as kf_cli, count_ba() as ba_cli_evals, \
            count_bootstrap() as boot_cli:
        cli_run = drive_cli(tum_root, tum_gt, out_dir)
    ba_cli = ba_kernel.LAUNCHES
    init_cli = init_kernel.LAUNCHES
    _check_ba_launches("phase 7 (CLI)", ba_cli, ba_cli_evals[0])
    _check_init_launches("phase 7 (CLI)", init_cli, boot_cli[0])
    launches_cli = pallas_pyramid.LAUNCHES
    track_cli, predict_cli = track_level.LAUNCHES, predict_kernel.LAUNCHES
    trace_cli, act_cli = trace_kernel.LAUNCHES_TRACE, trace_kernel.LAUNCHES_ACTIVATE
    # a metrics line per tracked frame
    _check_track_launches("phase 7 (CLI)", track_cli, cli_run["n_metrics"], predict_cli)
    _check_trace_launches("phase 7 (CLI)", trace_cli, act_cli, cli_run["n_metrics"], kf_cli[0])
    if launches_cli != cli_run["n_fed"]:
        raise RuntimeError(f"pyramid kernel launched {launches_cli} times for "
                           f"{cli_run['n_fed']} frames fed by the CLI")
    _reset_launches()
    with count_keyframes() as kf_resume, count_ba() as ba_resume_evals, \
            count_bootstrap() as boot_resume:
        resume = drive_resume(preset("default"), tum_root, out_dir, dev, sync)
    ba_resume = ba_kernel.LAUNCHES
    init_resume = init_kernel.LAUNCHES
    _check_ba_launches("phase 7 (resume)", ba_resume, ba_resume_evals[0])
    _check_init_launches("phase 7 (resume)", init_resume, boot_resume[0])
    launches_resume = pallas_pyramid.LAUNCHES
    track_resume, predict_resume = track_level.LAUNCHES, predict_kernel.LAUNCHES
    trace_resume = trace_kernel.LAUNCHES_TRACE
    act_resume = trace_kernel.LAUNCHES_ACTIVATE
    _check_track_launches("phase 7 (resume)", track_resume, resume["n_tracked"],
                          predict_resume)
    _check_trace_launches("phase 7 (resume)", trace_resume, act_resume, resume["n_tracked"],
                          kf_resume[0])
    if launches_resume != resume["launches_expected"]:
        raise RuntimeError(f"pyramid kernel launched {launches_resume} times in the resume "
                           f"drives, expected {resume['launches_expected']}")
    rt = reader_times(tum_root, dev)
    tmp.cleanup()
    cs = cli_run["summary"]
    print(f"dataset path: CLI over {cli_run['n_fed']} frames {W}x{H} from disk, "
          f"decoder '{datasets.active_decoder()}'{reason}: return 0, 0 lost, "
          f"{cli_run['n_poses']} poses in the trajectory file, ATE {cli_run['ate']:.4f}% of "
          f"extent (limit {ATE_MAX_PCT}%; phase 4 on the undistorted uint8 frames "
          f"{main['ate']:.4f}%), {cs['keyframes']} KFs, {cli_run['n_metrics']} metrics lines "
          f"({cli_run['n_bootstrap']} bootstrap frames write none), PLY {cli_run['n_pts']} "
          f"points, {cs['fps']} frames/s (the CLI's own clock, all frames; phase 4 "
          f"{main['fps_all']:.3f}), whole call {cli_run['wall']:.1f} s, pyramid launches "
          f"{launches_cli}, tracker launches {track_cli}, trace launches {trace_cli}, "
          f"activation launches {act_cli}, BA kernel launches {ba_cli}, bootstrap kernel "
          f"launches {init_cli} ({boot_cli[0]} bootstrap frames) | {card}", flush=True)
    print(f"  reader, per frame: decode {rt['decode_ms']:.3f} ms (host, zip read + PNG, no "
          f"prefetch), response + vignette + remap {rt['device_ms']:.4f} ms (device, CUDA "
          f"events), the two copies {rt['copy_ms']:.3f} ms (host clock), whole get_image "
          f"{resume['get_ms']:.3f} ms (host clock, median, zip prefetch on) | {card}",
          flush=True)
    print(f"  resume: checkpoint after frame {N_RESUME - 1}: {resume['n_bytes']} bytes, save "
          f"{resume['t_save']:.3f} s, load onto the card {resume['t_load']:.3f} s; frames "
          f"{N_RESUME}..{resume['n_frames'] - 1} again from it: max |position gap| to the "
          f"uninterrupted run {resume['gap']:.3g} (bound {RESUME_ATOL}), KFs "
          f"{resume['n_kf'][0]} / {resume['n_kf'][1]}, pyramid launches {launches_resume}, "
          f"tracker launches {track_resume}, trace launches {trace_resume}, activation "
          f"launches {act_resume}, BA kernel launches {ba_resume}, bootstrap kernel launches "
          f"{init_resume} ({boot_resume[0]} bootstrap frames); "
          f"phase wall time {time.perf_counter() - t_phase:.1f} s | {card}", flush=True)

    # ---- 8. the distributed solvers: ranks on the one card
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ldso_dist_") as work:
        dist_run = drive_distributed(dev, work)
    for line in _dist_lines(dist_run, card):
        print(line, flush=True)
    print(f"distributed solvers: phase wall time {time.perf_counter() - t_phase:.1f} s | "
          f"{card}", flush=True)

    print(f"chip_smoke.py: phases 1-8 in {time.perf_counter() - t_start:.1f} s | {card}",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "pyramid", "route": "cuda",
        "source": "ldso_tpu_torch/csrc/pyramid.cu",
        "replaces": "ldso_tpu/kernels/pallas_pyramid.py:33",
        "launches": (launches_main + launches_loop + launches_async + launches_cli
                     + launches_resume + dist_run["launches"]),
        "max_abs_err": max_err, "ms": ms_k1, "ms_b8": ms_k8, "ms_f32": ms_f32,
        "ms_is": "device", "call_ms": ms_call,
        "plain_ms": ms_p, "bound_ms": bound1, "bound_ms_b8": bound8,
        "bound_ms_f32": bound_f32, "ms_f32_l1": ms_l1, "plain_ms_f32_l1": plain_l1,
        "bound_ms_f32_l1": bound_l1,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "track_level", "route": "cuda",
        "source": "ldso_tpu_torch/csrc/track_level.cu",
        "replaces": "ldso_tpu/tracker.py:168",
        "launches": track_main + track_loop + track_async + track_cli + track_resume,
        "max_abs_err": track_err, "ms": track_frame_ms, "ms_is": f"device, the "
        f"{TRACK_LAUNCHES} launches of bench frame {mid}", "levels_ms_sum": track_ms, "plain_ms": track_plain_ms, "bound_ms": track_bound_ms,
        "bound_by": track_bound_by, "library_ms": None,
        "iterations": {f"L{r['level']}": r["n_iter"] for r in recs}, "ties": track_ties,
        "frame_ms": track_frame_ms, "launches_per_frame": TRACK_LAUNCHES,
        "levels": {f"L{r['level']}": {"ms": r["ms"], "us_per_iteration": r["us_iter"],
                                     "cluster": r["cluster"], "threads": r["threads"]}
                   for r in recs},
        "phase_cycles": {f"L{r['level']}": {n: r[n] for n in _phase_keys(r)}
                         for r in phases},
        "track_frame_kernels": n_k, "track_frame_kernels_plain": n_p,
        "fused_step_kernels": n_step, "fused_step_kernels_plain": n_step_p}, {
        "name": "trace", "route": "cuda", "source": "ldso_tpu_torch/csrc/trace.cu",
        "replaces": "ldso_tpu/trace.py:46",
        "launches": trace_main + trace_loop + trace_async + trace_cli + trace_resume,
        "max_abs_err": max(r["e_abs"] for r in trace_recs.values()),
        "ties": sum(r["parted"] for r in trace_recs.values()),
        "ms": tr["ms"], "ms_is": f"device, one launch on bench frame {mid}",
        "plain_ms": tr["plain_ms"], "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
        "library_ms": None, "launches_per_frame": 1,
        "table_entries_differ": sum(r["table"]["entries"] for r in trace_recs.values()),
        "slot_table_calls": trace_tables_main[0],
        "fused_step_kernels": n_step, "fused_step_kernels_plain": n_step_pp,
        "trace_host_ms_per_frame": prof["trace"]["host_ms"],
        "trace_device_ms_per_frame": prof["trace"]["device_ms"]}, {
        "name": "activate", "route": "cuda", "source": "ldso_tpu_torch/csrc/trace.cu",
        "replaces": "ldso_tpu/trace.py:292",
        "launches": act_main + act_loop + act_async + act_cli + act_resume,
        "max_abs_err": max(r["e_abs"] for r in act_recs),
        "ties": sum(r["parted"] for r in act_recs),
        "ms": ar["ms"], "ms_is": f"device, one launch on keyframe 1 after bench frame "
        f"{ACT_AFTER}", "plain_ms": ar["plain_ms"], "bound_ms": ar["bound_ms"],
        "bound_by": ar["bound_by"], "library_ms": None, "launches_per_keyframe": 1,
        "table_entries_differ": sum(r["table"]["entries"] for r in act_recs),
        "slot_table_calls": act_tables_main[0], "replay_bitwise": True,
        "call_kernels": n_act, "call_kernels_plain": n_act_p}, {
        "name": "ba_assemble", "route": "cuda", "source": "ldso_tpu_torch/csrc/ba.cu",
        "replaces": "ldso_tpu/ba/residuals.py:153",
        "launches": (ba_main + ba_loop + ba_async + ba_cli + ba_resume
                     + dist_run["ba_launches"]),
        "launches_per_evaluation": ba_kernel.PER_EVALUATION,
        "max_abs_err": max(r["max_abs_err"] for r in ba_recs),
        "ties": sum(r["parted"] for r in ba_recs),
        "ms": br["ms"], "ms_is": f"device, the launch of one assemble (mode active) on "
        f"run_ba 1 after bench frame {ACT_AFTER}", "call_ms": br["call_ms"],
        "host_ms": br["host_ms"], "table_entries_differ": sum(t["entries"] for t in table_diff),
        "plain_ms": br["plain_ms"], "bound_ms": br["bound_ms"], "bound_by": br["bound_by"],
        "library_ms": None, "run_ba_kernels": n_ba, "run_ba_kernels_plain": n_ba_p,
        "run_ba_host_ms": bs["host_ms"], "run_ba_device_ms": bs["device_ms"],
        "run_ba_kernel_device_ms": bs["kernel_device_ms"]}, {
        "name": "init_level", "route": "cuda", "source": "ldso_tpu_torch/csrc/init_level.cu",
        "replaces": "ldso_tpu/init2f.py:52",
        "launches": init_main + init_loop + init_async + init_cli + init_resume,
        "launches_per_bootstrap_frame": LEVELS, "cluster": init_cluster,
        "threads_per_cta": init_threads,
        "wide_check": {"points": n_wide, "level": wr["level"], "max_abs_err": wr["max_abs_err"],
                       "ladders_parted_at": wr["parted_at"]},
        "max_abs_err": init_err, "ties": init_ties,
        "ladders_parted": init_parted,
        "ms": init_ms, "ms_is": f"device, the {LEVELS} launches of bootstrap frame "
        f"{len(boot) - 1} (one a level)", "plain_ms": init_plain_ms, "bound_ms": init_bound_ms,
        "bound_by": init_bound_by, "library_ms": None,
        "levels": {f"L{r['level']}": {"ms": r["ms"], "us_per_iteration": r["us_iter"],
                                     "iterations": r["iters"], "plain_ms": r["plain_ms"],
                                     "bound_ms": r["bound_ms"]} for r in timed},
        "bootstrap_s": boot_s, "bootstrap_frames": main["n_init"],
        "bootstrap_s_per_frame": main["t_boot"]}, {
        "name": "predict", "route": "cuda", "source": "ldso_tpu_torch/csrc/predict.cu",
        "replaces": "ldso_tpu/tracker.py:324",
        "launches": predict_main + predict_loop + predict_async + predict_cli + predict_resume,
        "launches_per_frame": 1, "max_abs_err": 0.0, "bitwise": True,
        "ms": pr["ms"], "ms_is": f"device, one launch on bench frame {mid}",
        "call_host_ms": pr["host_ms"], "plain_host_ms": pr["plain_host_ms"],
        "plain_kernels": pr["plain_kernels"], "plain_ms": pr["plain_ms"],
        "bound_ms": pr["bound_ms"], "bound_by": pr["bound_by"], "library_ms": None,
        "fused_step_kernels": n_step}]}), flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
