#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels (repas_tpu_torch/kernels/csrc) from
   this checkout;
3. runs the 720p frame pipeline (repas_tpu_torch.pipeline.process_frames)
   once at batch 16 to capture each kernel's inputs at the main path's
   shapes, then holds each kernel against its plain PyTorch version on
   the card (B1, B2 exact; B3 within 1e-6 relative), times both with
   CUDA events (the kernel's calls queued behind a spin kernel, so the
   time is the device's alone) and sets the time beside the kernel's
   bound (bytes over the memory rate or operations over the compute
   rate, the larger; a window copy's bytes are the pyramid pixels under
   some window, each read once, and the windows written once); the CCL
   lines also print the band launch plan and,
   in cluster mode, cudaOccupancyMaxActiveClusters;
4. resets the launch counts, runs the pipeline with synchronizing CUDA
   calls turned into errors (the step must not wait for the device),
   reads the counts, checks the results (tag 9 in every frame,
   depth-corrected z within 5 mm of 0.45 m, one frame equal to the
   port's CPU result) and times it;
5. the robust phase: the eager staged detection ladder
   (repas_tpu_torch.detect.robust.detect_tags_robust_staged on the plain
   functions of its compiled steps; the compiled phase holds the
   compiled ladder against it) and
   best-order PnP on the best slot of each of 8 synthetic 720p frames
   (4 easy, 2 that only the stage-B ROI re-detection decodes, 1
   gamma-darkened, 1 without a tag, which forces stage C and kernel B4).
   Holds B1 and B2 exactly against their plain versions on the ladder's
   first input at each shape (stage A's frames, stage B's ROIs, stage
   C's full frames) and B4 on its first input, resets the counts, runs
   the ladder with synchronizing calls recorded as warnings (no more
   than one per wave test), reads the counts (B1, B2 and B4 launched),
   checks ids, poses and two frames against the port's CPU run, times
   it, and runs detect_tags_robust on one frame (B4 launched there too);
6. the calibrated_tracking phase: (a) tests/test_distortion.py's scene
   rendered through its lens, 16 noisy 720p frames, through the pipeline
   with the coefficients (sync-error mode; B1-B3 launched; every frame
   within 1 mm and 0.3 degrees of the truth; over 3 mm off without the
   coefficients; frame 0 as on the CPU) and without a cloud (no B3);
   (b) the register-then-track streamer (repas_tpu_torch.pose.track)
   over 35 noisy 720p frames, its steps compiled (CUDA graphs captured
   in the warm-up): B1 and B2 held exactly against their plain versions
   at the register and track shapes, then the counted stream (modes
   register, track, lost within the miss budget, register again; 3.5 mm
   from the truth; no launch outside the graphs; one device read per
   step), the stream again with each step under torch.profiler (B1 and
   B2 once on the device per track step, twice on the re-registering
   step), the stages' times, one robust registration (its compiled
   pieces captured anew: B4 launched in the capture); (c) the tag
   bundle's SQPnP on the card against the CPU; (d) depth-to-color
   alignment and NV12/YUYV decoding at 720p against the CPU, each a
   compiled step held against its eager function (compiled_leaf, below),
   the alignment also given its numpy camera (a replay of the same
   graph);
7. the compiled_pose phase (the last seven jax.jit sites, each a compiled
   step beside its plain function, and kernel K3, SQPnP's 9x9 eigh): on
   the bench frame at batch 16, detect_tags_jit on the packed gray frame
   (B1 and B2 in a replay's trace, tag 9 in every frame),
   fuse_tag_poses_jit without and with the 8-order search (anchor z
   within 5 mm of 0.45 m), solve_pnp_best_order_jit,
   solve_pnp_ippe_square_jit and refine_pnp_gn_jit on the detections'
   corners (error under 1 px and t_z > 0 on the valid slots), each
   against its eager function (compiled_leaf); solve_tag_bundle_jit on
   the bundle's 3-tag layout with its masked slot and
   solve_pnp_sqpnp_jit on 16 non-coplanar problems, against the CPU port
   (R within 0.01 degrees and t within 0.1 mm, or 0.3 degrees and 0.5 mm
   where the reprojection errors differ by over 1e-4 px: another
   candidate won), the eager calls' synchronising calls with cuSOLVER's
   solves and with K2/K3, the launch counts set to 0 just before them
   (K2 and K3 launched), K2 and K3 in a replay's trace and no cuSOLVER
   kernel; K3 against its plain version (check_k3) at (1,9,9) (the
   bundle's Omega and its DLT's float64 Gram), (16,9,9) and (4096,9,9),
   timed behind a spin kernel beside its bound and torch.linalg.eigh;
   K2 against its plain version (check_k2_pnp) on the seeds the bundle
   and the batch project to SO(3), (6,3,3), (1,3,3), (96,3,3) and
   (16,3,3), timed there behind a spin kernel beside its bound and
   torch.linalg.svd + det, with its sweep histogram (K2's record's
   at_other_shapes); every graph is dropped at the end;
8. the registration phase (repas_tpu_torch.cloud, compiled: each stage
   of register_clouds a captured graph, ICP's loop one WHILE graph node;
   kernels K1, the 3x3 eigh, K2, the Kabsch rotation, and K4, the
   grid-hash 1-NN query): (a)
   register_clouds on the JAX bench's 1M-point scene (bench.py's bumpy
   surface, seed 7, the source moved by rv (0.04, -0.06, 0.30) and t
   (0.06, -0.04, 0.05)) with tensors on the card, at the defaults
   (capacity 8192, 8192 hypotheses, 100 ICP iterations, 64^3 ICP grid):
   the eager call (core.jit.disable_jit) records K1's inputs (the 1M
   target's covariances) and K2's (one RANSAC draw's 8,192 triples);
   K1 and K2 held against their plain versions there (in float64, and
   in float32 where float32 determines the answer: the tolerances in
   check_k1 and check_k2), timed beside their bound and cuSOLVER's
   calls, and K1 likewise at the path's other shapes, one 65,536-matrix
   chunk of the target's normals and a downsampled cloud's 8,192 (the
   record's at_other_shapes); the warm call that captures every stage, with the launch
   counts set to 0 just before it (K1 and K2 launched); the compiled
   call: ICP fitness > 0.5, t error < 1 mm, R error < 0.05 degrees, no
   voxel dropped (n_down <= capacity), at most 8 synchronising calls and
   none inside a replay, no new graph, T within 1e-5 m and 1e-3 degrees
   of the eager call's; a traced compiled call (K1, K2 and K4 on the
   device, no cuSOLVER eigh or SVD kernel, its kernels and device ms);
   compiled and eager seconds in turns (3 each); the stages one by one
   with a synchronise between them (the split); each graph's reserved
   bytes;
   ICP alone from one T_init, compiled against eager (the same
   iterations, T within 1e-6 m; the capture's seconds and the graph's
   nodes, the WHILE body's), and with masked source points (C9's NaN
   RMSE) run to max_iters; one ICP correspondence pass's device and
   host ms; K4 at the register cell's shapes (921,600 queries, an
   independent sampling of the surface, on a 921,600-point target; the
   grid at 1.5 voxel), one record a level: index and distance bit-equal
   to the plain version, kernel and plain ms, the bound by bytes, K4's ms
   on the table as built; a compiled ICP there timed at 1-4 trips (its
   ms per trip); (b) on a 20k-point pair of the same surface, ICP from one
   T_init, RANSAC on one set of picks and the two-level grid query, each
   on the card against the CPU; (c) the capture side at 720p:
   create_masked_pointcloud on the bench frame (5 mm voxels, default
   outlier removal, normals), compiled (three graphs, the samples drawn
   between them) against eager: valid masks, points, colours and
   normals, peak memory (under 40 GB); then its stages on the card
   against the CPU on one sample, and the tag-anchored crop around the
   frame's fused pose;
9. the cad_chain phase: the port's six CLIs (repas_tpu_torch.apps), called
   in-process on the card on one 1280x720 capture written under a
   temporary directory (PNGs from the standard library's zlib, so the log
   names the codec that decoded them): generate_pointcloud (5 mm voxels,
   normals), crop_scene around tag 16, a CAD made from the crop in the
   tag's frame (mm), place_cad --icp (default ICPConfig), ply_to_stl on
   the crop (poisson at dim 128 and 256, alpha, bpa), apply_6dof --icp
   with the alpha mesh and the placement as its pose, refine_icp --global
   from the placed CAD moved by a known motion. Each app is timed after
   one warm call. Gates: the placed CAD within 5 mm of the crop
   (median), place_cad's ICP (fitness > 0.9, under 1 degree and 5 mm),
   the known motion recovered, every STL non-empty and the Poisson meshes
   on the crop, the sidecars' kinds, B1 and B2 launched by crop_scene and
   place_cad (counted in their warm calls, which capture the compiled
   detector and fusion anew) and held exactly against their plain
   versions on the phase's first inputs; then the Poisson grid, refine_with_icp on one
   normals sample and ball pivoting on the card against the CPU;
10. the canopy_calib_eval phase (canopy/, calib/, eval/ and their CLIs;
   no kernel of their own, B1-B4 counted: none launched), under 90 s:
   (a) measure_plant_height on a 1280x720 canopy capture (a bar tilted 6
   degrees, a plant whose top is a 2 px leaf tip, u16 depth) on the card:
   found, height within 5 mm of the scene's truth, the canopy mark within
   1.5 px of the tip, canopy_px, bar_px and found equal to the CPU port's
   and the height within 1e-5 m of it; its synchronising calls; the host
   clock (median of 10) and CUDA events; its compiled pieces
   (canny_edges, hough_horizontal_bar, refine_plant_mask: a graph each)
   against the eager call (compiled_leaf), each piece's replay traced
   alone and the share of the call's kernels the three graphs hold;
   detect_canopy.main once on PNGs of the capture; (b) the reference's
   19x19 board (12.7 mm squares) in 20 oblique 1280x720 views rendered
   on the card through a known lens (blur, noise): detection and
   sub-pixel refinement of every view (all found; two views' corners
   within 1e-3 px of the CPU port's), then
   calibrate_camera (RMS < 0.3 px, fx and fy within 0.5 %, cx and cy
   within 2 px of the truth); ms per view and the LM's seconds; the
   compiled sub-pixel refinement and LM step against their plain
   functions (bit-equal, the eager LM's seconds, the compiled LM's
   synchronizing calls equal at 5 and 100 steps);
   calibrate.main once on PNGs of the views; (c) 150,000 points within
   5 mm of a closed UV sphere of 50,880 triangles through
   point_to_mesh_signed_distances on the card: within the tessellation's
   sag plus 1e-6 m of the analytic distance, the sign right beyond the
   sag, a 5,000-point subsample equal to the CPU port's within 1e-6
   relative plus 1e-7 m; the compiled report (one graph holding the 199
   chunks) against eager (compiled_leaf, 2 turns), and
   point_to_mesh_distances likewise on the first 30,000 points, equal to
   the signed distances' magnitudes; error_report surface once with --txt
   and --colored-out (a replay); the two graphs are then dropped;
11. the apps_stream phase (the stream, pose, capture, fusion and viewing
   CLIs, the splat renderer and the frame mesh): a 1280x720 replay
   stream of 8 frames (tags 9 and 16 on a plane at 0.5 m, the camera
   moving 2 and 1 mm a frame) and a second view turned 25 degrees,
   written as color_<ts>.png + aligned_depth_<ts>.png; the ten CLIs
   track_stream (default, --robust, --temporal), detect_tags,
   estimate_pose (also --layout: one SQPnP bundle over tag 16, its pose
   within 1 degree and 5 mm of the truth), validate_pose translation,
   align_depth,
   capture_aligned --colorize, fetch_intrinsics, pack_replay --colorize,
   fuse_views and view_pointcloud --splat, in-process on the card, each
   timed after one warm call with B1-B4's wrapper launches counted
   around it (every compiled step captured anew in the warm calls; a
   replayed graph's launches are not the wrappers'), then each CLI that
   replays compiled steps (the three track_stream calls, detect_tags,
   both estimate_pose calls, validate_pose and fuse_views) once more
   under torch.profiler, whose trace counts the launches inside their
   graphs too (the device's count less the wrappers'); B1, B2 and B3 must
   launch on the device in track_stream and B4 in track_stream
   --robust (its trace) or fuse_views, and each is held exactly against
   its plain
   version at the phase's first inputs. Gates: ids [9, 16] and the
   anchor within 5 mm of the truth on every frame, modes register then
   track, validate_pose's delta within 2 mm of the known step, the two
   fused views within 5 mm of each other (median nearest neighbour),
   a drawn splat image, align_depth and capture_aligned equal to the
   CPU port's files; validate_pose threeway on the first translation
   capture (detector and PnP translations within 10 mm) and its
   compiled detector_pose against eager (compiled_leaf);
   render_pointcloud of 1M fused points at 1280x720, compiled against
   eager on one orbit view through the numpy camera (compiled_leaf),
   a second view replaying the same graph, equal to its eager image and
   differing from the first (CUDA events; z-buffer equal to the CPU
   port's, the image differing at most at tied pixels);
   sharded_frame_pipeline(process_frames) over
   the card named twice at batch 16 equal to the unsharded step;
12. the tools phase (repas_tpu_torch.tools, the port of the JAX repo's
   measurement tools, and kernels B5/B6 of tools/micro_perf.py), with the
   launch counts set to 0 before it: profile_stages --iters 3 (the 11
   stage prefixes, detect_tags, the point cloud and the pipeline at
   720p, batch 16), micro_perf with every section at 3 iterations,
   reconstruct_compare --n 200000, each in-process and its output
   printed; every timing line present with a finite sum, micro_perf's
   "match: True" (B6 against the plain gather), each reconstruction
   non-empty within 1 mm of the sphere; B1-B3, B5 and B6 launched; the
   thresh, ccl and topk prefixes on the card equal to the CPU port's on
   one frame; B5 (f32 and bf16) and B6 held exactly against their plain
   versions at the inputs micro_perf gave them, timed beside their bound
   and the one PyTorch indexing call that computes them (as for B2);
   B6 on micro_perf's pyramid at negative, past-the-edge and edge starts,
   exact and on the TMA path; the phase's seconds;
13. the graft_entry phase (repas_tpu_torch.graft_entry, the port of the
   JAX repo's __graft_entry__.py): (a) entry() on the card, one warm
   call, then one call with synchronizing CUDA calls turned into errors
   and B1-B3's launches counted (each >= 1); tag 9 found, anchor z
   within 5 mm of 0.45 m, ids equal to entry(device="cpu")'s and corners
   within 1e-2 px of them; ms per 720p process_frame at batch 1 (host
   clock, median of 10, and CUDA events); (b) dryrun_multichip(n) for n
   = 2 and 8 over cuda:0 named n times (each shard's step compiled and
   captured in the call), its printed line equal to the CPU port's
   (devices ["cpu"] * n), B1-B3 launched by each, its seconds.
   tools/canopy_reference_parity.py's port is host-only cv2 code and is
   not run here (the card's machine may have no cv2);
14. the compiled phase (repas_tpu_torch.core.jit, the port's counterpart
   of jax.jit: a step captured as a CUDA graph and replayed): (a)
   pipeline.process_frames_jit at batch 16 on the bench frame and (b)
   on the calibrated phase's scene with the lens's coefficients, each
   against the eager process_frames: the capture's seconds and the
   memory it reserves, one replay under sync-error mode (no launch
   outside the graph), integer outputs equal and floats bit-equal (or,
   named, within the CPU port's tolerances), 3 replays under
   torch.profiler whose trace shows B1-B3's device functions by name
   exactly once each per replay, the kernels and device ms
   of an eager step and of a replay, the synced step's ms eager and
   compiled in turns (median of 10, host clock and CUDA events), the
   bench's queued loop's frames/s each, the output clones' device ms;
   (c) entry()'s batch-1 720p process_frame under jit against the plain
   step, bit-equal, B1-B3 once per traced replay, ms each; (d) the
   tracker's 35-frame stream through the compiled TagTracker and one
   whose steps are the plain functions, frame by frame in turns: modes
   and poses equal, one device read and no launch outside the graphs
   per compiled track step, ms per track and register step each;
   (e) the compiled ladder + pose (stages A, B and C and the bench's
   pose_batch, each a graph; the waves of B and C conditional nodes)
   against the eager one on the 8 frames and on a set whose stages B
   and C run 4 and 2 waves: each stage's waves, the capture's launches,
   seconds and memory, a replay with synchronizing calls raising and no
   wave test, outputs equal, B1, B2 and B4 on the device in each of 3
   traced replays, ms each in turns; detect_tags_robust compiled on one
   frame (B4 in its replay's trace); (f) sharded_frame_pipeline at 720p,
   batch 16, over cuda:0 named 2 and 8 times, one graph per shard:
   outputs equal to the eager sharded step and the unsharded one, a
   replay without wrapper launches under sync-error mode, B1-B3 n times
   in a traced call, ms against the unsharded step eager and compiled;
15. the bench phase (repas_tpu_torch.bench, the port of the JAX repo's
   bench.py): its headline loop in-process (_time_pipeline at batch 16,
   the compiled step: a gated warm call that captures, then 10 queued
   calls with synchronizing CUDA calls turned into errors; the wrappers
   count B1-B3 twice, in the capture's warm-up and the capture; the loop
   again under torch.profiler, each of its 11 calls a replay running
   B1-B3 once on the device) and its
   ladder (_time_robust_ladder: B1, B2 and B4 launched, 7 valid best
   slots), then ``python -m repas_tpu_torch.bench`` once as a
   subprocess with REPAS_BENCH_BUDGET_S=400: exit 0, the headline line
   first with a positive value, the superset line last with bench.py's
   keys and the port's four departures, a measured cpu_fps (the port on
   this host's CPU), vs_baseline = value / cpu_fps (within the line's
   roundings), robust_tags_found 7, registration_1m_status "ok", device
   equal to the card's line; the host's CPU count and the phase's
   seconds;
16. prints one JSON line of kernel results (B1-B6, K1-K4, with each
   kernel's launches in the canopy_calib_eval, apps_stream, tools,
   graft_entry and bench phases, as the wrappers count them; K1, K2 and
   K4 with their launches in the registration phase's capturing call and
   in its traced replay, K3 with its launches in the compiled_pose
   phase's compiled bundle and SQPnP and in their traced replays; K1,
   K2 and K3 with their numbers at the path's other shapes
   (at_other_shapes; K2's at the pose seeds' four); B1-B3 also with
   their launches inside replayed
   graphs in the apps_stream, compiled and bench phases, as the traces
   count them; each
   B2, B5 and B6 record with the window copy's path, "vector", "tma" or
   "scalar", and on the TMA path its plan: bh, bw, stages, grid,
   smem_bytes), then, last, one JSON line {"ok": true, "device": {...}}.

compiled_leaf, for each of these compiled leaves (the JAX package's
jax.jit functions that no other compiled step calls): its graphs
dropped, the capturing call's seconds, each graph's capture seconds
(warm-up, recording, instantiation), nodes and reserved bytes; a call
in which every replay raises on a synchronizing CUDA call; its outputs
bit-equal to the call with every step eager (core.jit.disable_jit); the
kernels and device ms of a traced compiled call; compiled and eager
calls in turns (median and spread, host clock and CUDA events).

Any failed check raises, so the script exits non-zero and prints no
result line. It needs one CUDA device and refuses to run without one.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import struct
import subprocess
import sys
import time
import warnings
import zlib

import numpy as np
import torch

from repas_tpu_torch.bench import (BATCH, H, REG_N, REG_RV, REG_SEED, REG_T,
                                   ROBUST_BATCH, ROBUST_K, TAG_ID, TAG_Z, W,
                                   _frames as bench_frames, bumpy_scene,
                                   ladder_and_pose, robust_frames, rotation)

# The card's peak rates for a kernel's bound (NVIDIA H100 SXM data sheet,
# at its 700 W limit): device memory, f32 outside the tensor cores (an FMA
# counts two), and int32 min/compare/select: Hopper's SM has half as many
# INT32 lanes as FP32 lanes and an integer min is one operation, so a
# quarter of the f32 FLOP rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12          # outside the tensor cores (67e12 inside)
INT32_OPS_PER_S = F32_OPS_PER_S / 4
# int32 operations per pixel per CCL round: four scan directions of (min,
# select), the separable 3x3 min (four mins) and the background select
CCL_OPS_PER_PIXEL_ROUND = 13
# f32 operations per point of B3: z, x and y (7), three colour
# conversions and scalings (6), the z > 0 select
B3_OPS_PER_POINT = 14
NO_LIBRARY_CCL = ("no PyTorch call computes a connected-component "
                  "labelling or a segmented scan (torch.cummin has no "
                  "segments)")
LIBRARY_GATHER = ("one advanced-indexing call pyr[bidx, rows[..., :, None], "
                  "cols[..., None, :]] (the plain version's gather), its "
                  "index tensors built beforehand")
NO_LIBRARY_B3 = ("no PyTorch call back-projects a depth image with its "
                 "colours in one call")
STEPS = 10

# robust phase (its batch and intrinsics, ROBUST_BATCH and ROBUST_K, are
# the bench's: repas_tpu_torch.bench)
ROBUST_IDS = [9, 16, 9, 16, 9, 16, 16, None]     # best-slot id per frame
ROBUST_FOUND_A = [True] * 4 + [False] * 2 + [True, False]
ROBUST_STEPS = 5

# calibrated phase: tests/test_distortion.py's scene (f = 740, checkerboard
# size coefficients, tag 5 of 0.0909 m), batch 16
DIST_K = np.array([[740.0, 0, 640], [0, 740.0, 360], [0, 0, 1.0]], np.float32)
DIST = np.array([-0.24, 0.095, 0.0012, -0.0008, 0.018], np.float32)
DIST_TAG, DIST_TAG_ID = 0.0303 * 3, 5
DIST_RVEC = (0.25, -0.2, 0.1)
DIST_T = np.array([0.08, 0.05, 0.55], np.float32)
# tracker stream: the bench intrinsics, a 60 mm tag 9 tilted as in
# tests/test_track.py, 30 frames of motion, 2 blank frames, then the tag
# far from the old ROI for 3 frames (default TrackerConfig: 3 misses)
TRACK_TAG, TRACK_TAG_ID = 0.06, 9
TRACKER_ROI = 256                  # TrackerConfig().roi
TRACK_RVEC = (0.2, -0.15, 0.05)
TRACK_MOTION = 30
TRACK_FAR_T = np.array([-0.15, 0.1, 0.6], np.float32)
TRACK_MODES = (["register"] + ["track"] * (TRACK_MOTION - 1)
               + ["lost"] * 3 + ["register", "track"])
# registration phase: the bench's 1M-point scene (REG_N, REG_SEED, REG_RV,
# REG_T from repas_tpu_torch.bench) and its register_clouds call (seed 7,
# defaults: capacity 8192, 8192 hypotheses, 100 ICP iterations, 64^3 ICP
# grid)
REG_CAPACITY = 8192
REG_SMALL = 20_000             # the card-against-CPU checks
REG_SMALL_ICP_ITERS = 30       # bounds the CPU side's time
REG_SYNC_LIMIT = 8             # synchronising calls of a compiled call
REG_TURNS = 3                  # compiled and eager calls, in turns
ICP_BOUND_ITERS = 8            # max_iters of the ICP run that reaches it
K4_N = 921_600                 # the register cell's clouds: a 720p frame's
ICP_TRIPS = (1, 2, 3, 4)       # ICP replays timed at these trip counts
EIGH_BATCH = 16384             # cuSOLVER's eigh refuses 32,768 3x3 (C11)
# operations a matrix of what K1-K3's functions need, whatever the
# algorithm and however many sweeps the kernel's Jacobi takes (Golub and
# Van Loan's counts, an FMA two): a symmetric eigh with its eigenvectors
# 9 n^3 (the tridiagonal reduction, its Q and the implicit QR), so K1
# 243 (n = 3) and K3 6,561 (n = 9); K2 the 3x3 SVD with both factors,
# 21 n^3 (the R-SVD), and the product V diag(1, 1, d) U^T, 2 n^3: 621
EIG3_OPS = 9 * 3 ** 3
KABSCH3_OPS = 23 * 3 ** 3
EIG9_OPS = 9 * 9 ** 3
CAPTURE_VOXEL = 0.005
CAPTURE_BOX = 0.1              # +-0.1 m around the tag, every axis
# cad_chain phase: one 1280x720 capture at the bench intrinsics: 60 mm
# tags 9 and 16 on a plane at 0.5 m, two Gaussian bumps of unequal size
# (centre x, y, sigma, height in m) in front of the plane below tag 16,
# so that ICP is pinned in every direction; the crop around tag 16 (in
# its frame: x +-5 cm, y -3..+10 cm, z -6..+1 cm) holds the tag, the
# plane and both bumps
CAD_K = ROBUST_K
CAD_TAG, CAD_Z = 0.06, 0.5
CAD_TAGS = {9: (-0.12, -0.03), 16: (0.08, -0.03)}
CAD_BUMPS = ((0.065, 0.035, 0.012, 0.02), (0.105, 0.045, 0.01, 0.015))
CAD_CROP = ["--dx", "0.05", "0.05", "--dy", "0.1", "0.03", "--dz", "0.01",
            "0.06"]
CAD_POINTS = 30_000            # the CAD: the crop subsampled to >= this
CAD_MOVE_RV = (0.05, -0.03, 0.06)      # refine_icp --global's known motion
CAD_MOVE_T = (0.012, -0.008, 0.006)
CAD_REG_T_MM, CAD_REG_R_DEG = 2.0, 0.5
CAD_VS_CPU_SAMPLES = 20_000    # refine_with_icp card-vs-CPU check,
CAD_VS_CPU_ICP_ITERS = 30      # a fixed count of ICP iterations
# ICP on the card against the CPU on the crop: measured 3.7e-6 m and
# 0.0023 degrees apart after 30 iterations (6.2e-6 m when each stopped
# by itself, after 18 and 100). The crop is a pixel grid of mm-quantized
# depths, full of near-tied neighbours, and the card's voxel means differ
# from the CPU's by ulps (atomics), which flips such ties; on the smooth
# 20k-point pair of registration_vs_cpu the two agree within 1e-8 m
CAD_ICP_T_M, CAD_ICP_R_DEG = 2e-5, 0.01
CAD_BPA_STRIDE = 4             # ball_pivot card-vs-CPU on every 4th point
# canopy_calib_eval phase. (a) A 1280x720 canopy capture at the bench
# intrinsics: an 8 px bright bar tilted 6 degrees (one of the Hough
# table's angles), a green plant body topped by a 2 px leaf tip 24 px
# long, plant and bar at 1.07 m with depth edges 4 px outside the colour
# edges, background 2 m behind, 2 mm depth noise; the truth height is the
# bar's top edge at the image centre against the tip's top row
CANOPY_Z, CANOPY_ANGLE = 1.07, 6.0
CANOPY_REPS = 10
# (b) the reference's board (CalibrationConfig: 19x19 inner corners,
# 12.7 mm squares), 20 oblique 1280x720 views through a known lens,
# supersampled, blurred and noisy
CAL_K = np.array([[1050.0, 0, 642.0], [0, 1047.0, 358.0], [0, 0, 1.0]])
CAL_DIST = np.array([-0.12, 0.08, 0.0005, -0.0004, 0.0])
CAL_N, CAL_VIEWS = 19, 20
CAL_SQUARE = 0.0127
# (c) 150,000 points within 5 mm of a closed UV sphere (r 0.1 m) of
# 160 x 160 cells: 50,880 triangles
SURF_N, SURF_R, SURF_LAT = 150_000, 0.1, 160
SURF_SUB = 5_000               # the card-vs-CPU subsample
SURF_UNSIGNED_N = 30_000       # point_to_mesh_distances' points (1/5)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def render_window(tag_id, R, t, K, tag, size, dist=None, supersample=3):
    """(H,W) float32 gray frame holding one posed tag on a 180 background,
    rendered only in the size x size window around the tag's projected
    center, through the intrinsics shifted to that window: the same rays
    as a full-frame render at a tenth of its host time."""
    from repas_tpu_torch.detect.render import render_tag_in_scene

    c = K.astype(np.float64) @ t
    left = int(np.clip(round(c[0] / c[2] - size / 2), 0, W - size))
    top = int(np.clip(round(c[1] / c[2] - size / 2), 0, H - size))
    Kw = K.copy()
    Kw[0, 2] -= left
    Kw[1, 2] -= top
    win = render_tag_in_scene(tag_id, R, t, Kw, tag, (size, size),
                              supersample=supersample, dist=dist)
    edges = np.concatenate([win[[0, -1]].ravel(), win[:, [0, -1]].ravel()])
    if not (edges == 180.0).all():
        raise AssertionError(f"tag {tag_id} at {t} overflows its window")
    img = np.full((H, W), 180.0, np.float32)
    img[top:top + size, left:left + size] = win
    return img


def noisy_rgb(grays, seed=0):
    """Gray frames (N,H,W) + integer noise in [-8, 8) from `seed` ->
    (N,H,W,3) uint8 RGB."""
    rng = np.random.default_rng(seed)
    f = np.clip(grays + rng.integers(-8, 8, grays.shape), 0, 255)
    return np.repeat(f[..., None], 3, axis=-1).astype(np.uint8)


def angle_deg(Ra, Rb):
    """Angle of Ra^T Rb, atan2(|sin|, cos) in float64."""
    Rr = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([Rr[2, 1] - Rr[1, 2], Rr[0, 2] - Rr[2, 0],
                  Rr[1, 0] - Rr[0, 1]]) / 2
    return float(np.degrees(np.arctan2(np.linalg.norm(w),
                                       (np.trace(Rr) - 1) / 2)))


def distorted_frames(batch):
    """tests/test_distortion.py's scene rendered through the lens, `batch`
    noisy copies: (rgbs (B,H,W,3) uint8, depths (B,H,W) u16, R, t)."""
    R = rotation(DIST_RVEC)
    gray = render_window(DIST_TAG_ID, R, DIST_T, DIST_K, DIST_TAG, 330,
                         dist=DIST)
    rgbs = noisy_rgb(np.stack([gray] * batch))
    depths = np.full((batch, H, W), int(DIST_T[2] * 1000), np.uint16)
    return rgbs, depths, R, DIST_T


def pose_errors(out, R, t):
    """Per frame, the error of the tag's slot against the truth:
    (t error mm, R error deg), or raises if a frame lost the tag."""
    ids = out.detections.ids.cpu().numpy()
    Rs, ts = out.pose.R.cpu().numpy(), out.pose.t.cpu().numpy()
    terr, rerr = [], []
    for b in range(ids.shape[0]):
        hit = np.flatnonzero(ids[b] == DIST_TAG_ID)
        if not hit.size:
            raise AssertionError(f"frame {b}: tag {DIST_TAG_ID} not "
                                 f"detected: {ids[b].tolist()}")
        i = hit[0]
        terr.append(float(np.linalg.norm(ts[b, i] - t)) * 1000)
        rerr.append(angle_deg(R, Rs[b, i]))
    return terr, rerr


def tracker_stream():
    """(frames (N,H,W,3) uint8, truth t per frame or None): the tag moves
    3, 2 and 2 mm per frame in x, y, z around 0.5 m for TRACK_MOTION
    frames, two blank frames follow, then it reappears far from the old
    ROI for three frames. Noise in [-8, 8) from seed 0."""
    R = rotation(TRACK_RVEC)
    truth = [np.array([-0.03 + 0.003 * i, 0.02 - 0.002 * i, 0.5 + 0.002 * i],
                      np.float32) for i in range(TRACK_MOTION)]
    truth += [None, None] + [TRACK_FAR_T] * 3
    grays = np.stack([np.full((H, W), 180.0, np.float32) if t is None
                      else render_window(TRACK_TAG_ID, R, t, ROBUST_K,
                                         TRACK_TAG, 300)
                      for t in truth])
    return noisy_rgb(grays), truth


def sync_warnings(caught):
    return [str(w.message) for w in caught
            if "synchroniz" in str(w.message).lower()]


PIPELINE_KEYS = ("ccl", "patch_extract", "pointcloud")     # B1-B3
# a kernel of B1-B3 as its device function's name shows in a trace
KERNEL_NAMES = {"ccl": "ccl_band", "patch_extract": "window_copy",
                "pointcloud": "pointcloud"}


def counted(fn, what, need=PIPELINE_KEYS, sync_error=False):
    """fn() with every launch count set to 0 just before it (and, with
    `sync_error`, synchronizing CUDA calls raising); returns (its output,
    the counts read just after). Raises if a kernel of `need` was not
    launched."""
    from repas_tpu_torch.kernels import _build

    _build.reset_launches()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    low = [k for k in need if counts[k] < 1]
    if low:
        raise AssertionError(f"{what} never launched {low} (counts "
                             f"{counts})")
    return out, counts


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = False) -> float:
    """Mean device time of fn() in ms, CUDA events around `iters` calls.
    With `queued`, the calls are enqueued behind a spin kernel long enough
    to cover their host time, so the events time the device work alone
    and not the host's gaps between launches (for fn without host
    syncs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e9 * (2 * iters * host_s + 0.002)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Capture:
    """Records the arguments of the first call of module.name (with
    `every_shape`, of the first call at each distinct set of argument
    shapes) and passes every call through; restores the attribute on
    exit."""

    def __init__(self, module, name: str, every_shape: bool = False):
        self.module, self.name = module, name
        self.every_shape = every_shape
        self.calls = []
        self.keys = set()

    @property
    def args(self):
        return self.calls[0] if self.calls else None

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            key = tuple(tuple(a.shape) if torch.is_tensor(a) else a
                        for a in args)
            if key not in self.keys and (self.every_shape or not self.calls):
                self.keys.add(key)
                self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def hold(name, shape, kern, plain, rtol=0.0, **extra):
    """Kernel against its plain version on the same inputs (exact, or
    within `rtol` relative), then CUDA-event times of both; logs one line
    and returns (max_abs_err, ms, plain_ms)."""
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: kernel gives {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(ref.shape)} "
                             f"{ref.dtype}")
    diff = (got.to(torch.float64) - ref.to(torch.float64)).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    bound = (rtol * ref.to(torch.float64).abs()) if rtol else 0.0
    if not bool(torch.all(diff <= bound)):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {max_err}")
    ms = cuda_ms(kern, queued=True)
    plain_ms = cuda_ms(plain)
    log({"kernel": name, "input_shape": list(shape), **extra,
         "max_abs_err": max_err, "tolerance_rtol": rtol, "ms": ms,
         "plain_ms": plain_ms})
    return max_err, ms, plain_ms


B1_SRC = ("repas_tpu_torch/kernels/csrc/ccl.cu",
          "repas_tpu/kernels/ccl_pallas.py:35")
B2_SRC = ("repas_tpu_torch/kernels/csrc/patch_extract.cu",
          "repas_tpu/kernels/patch_extract.py:61")
B3_SRC = ("repas_tpu_torch/kernels/csrc/pointcloud.cu",
          "repas_tpu/kernels/pointcloud.py:102")
# B4's CCL is the band kernel of ccl.cu in grid mode; its unit, the direct
# counterpart of _make_scan_kernel, is ccl_tiled.cu
B4_SRC = ("repas_tpu_torch/kernels/csrc/ccl.cu",
          "repas_tpu/kernels/ccl_pallas.py:108")
# the two Pallas kernels of the measurement tool tools/micro_perf.py
B5_SRC = ("repas_tpu_torch/kernels/csrc/patch_extract.cu",
          "tools/micro_perf.py:108")
B6_SRC = ("repas_tpu_torch/kernels/csrc/patch_extract.cu",
          "tools/micro_perf.py:289")
# K1 and K2 replace no Pallas kernel: the JAX package's linear-algebra
# calls inside its jitted normals and RANSAC, which the port's cuSOLVER
# calls could not be captured in (they read a status on the host)
K1_SRC = ("repas_tpu_torch/kernels/csrc/eig3.cu",
          "repas_tpu/cloud/normals.py:53")
K2_SRC = ("repas_tpu_torch/kernels/csrc/kabsch3.cu",
          "repas_tpu/cloud/fpfh.py:157")
# K4 replaces no Pallas kernel either: the JAX package's grid_hash_query is
# jax.jit code
K4_SRC = ("repas_tpu_torch/kernels/csrc/grid_query.cu",
          "repas_tpu/cloud/knn.py:96")


def bound_of(nbytes, ops, ops_per_s):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and operations over the rate of their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def record(name, src, err_ms, nbytes, ops, ops_per_s, library_note,
           library_ms=None):
    """A kernel's line of the {"kernels": [...]} result: its times, its
    bound and its share of that bound."""
    max_err, ms, plain_ms = err_ms
    bound_ms, bound_by = bound_of(nbytes, ops, ops_per_s)
    return {"name": name, "route": "cuda", "source": src[0],
            "replaces": src[1], "launches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "library_ms": library_ms,
            "library_note": library_note}


def ccl_cost(mask, iters):
    """(bytes, int32 operations) of a CCL call: the mask read once, the
    labels written once; 13 operations per pixel per round."""
    n = mask.numel()
    return n + 4 * n, CCL_OPS_PER_PIXEL_ROUND * iters * n


def ccl_plan(mask, cluster_ok=True):
    """The band launch plan the CCL wrappers take for this mask, with the
    clusters the card holds at once (cluster mode) or the band CTAs it
    holds at once (grid mode)."""
    from repas_tpu_torch.kernels import ccl_cuda

    plan = ccl_cuda.plan_for(mask, cluster_ok)
    idx = mask.device.index
    out = {"mode": plan.mode, "cluster": plan.cluster,
           "band_rows": plan.band_rows, "bands": plan.bands,
           "images_per_launch": plan.group, "groups": plan.launches,
           "smem_bytes": plan.smem, "max_active_clusters": None}
    if plan.mode == "cluster":
        out["max_active_clusters"] = ccl_cuda.max_active_clusters(
            plan.cluster, plan.band_rows, mask.shape[2], idx)
    else:
        lim = ccl_cuda.card_limits(idx, mask.shape[2])
        out["resident_band_ctas"] = lim["sm_count"] * min(
            lim["blocks_per_sm"],
            (lim["smem_block"] + ccl_cuda.SMEM_RESERVED)
            // (plan.smem + ccl_cuda.SMEM_RESERVED))
    return out


def ccl_rounds(kernel, call, device):
    """Mean rounds an image ran in one call() of the band CCL, from the
    program's device counter (row `kernel`: "b1" or "b4")."""
    from repas_tpu_torch.kernels import ccl_cuda

    before = ccl_cuda.counts(device)[kernel]
    call()
    after = ccl_cuda.counts(device)[kernel]
    return ((after["rounds"] - before["rounds"])
            / max(1, after["images"] - before["images"]))


def check_b1(name, mask, iters, converge=False):
    """B1 exactly against its plain version, as the caller called it
    (`converge`: on to the fixed point, `iters` the least rounds). The
    bound is at `iters` rounds, whatever ran; `rounds` is the mean an
    image ran (the device counter), and `bound_share_at_rounds` the share
    of the bound at those rounds."""
    from repas_tpu_torch.kernels import ccl, ccl_cuda
    plan = ccl_plan(mask)

    def kern():
        return ccl_cuda.connected_components_cuda(mask, iters, converge)

    rounds = ccl_rounds("b1", kern, mask.device)
    rec = record(name, B1_SRC, hold(
        name, mask.shape, kern,
        lambda: ccl.connected_components_plain(mask, iters, converge),
        iters=iters, converge=converge, rounds=rounds, plan=plan),
        *ccl_cost(mask, iters), INT32_OPS_PER_S, NO_LIBRARY_CCL)
    rec["plan"] = plan
    rec["input_shape"] = list(mask.shape)
    rec["converge"] = converge
    rec["rounds"] = rounds
    rec["bound_share_at_rounds"] = bound_of(
        *ccl_cost(mask, rounds), INT32_OPS_PER_S)[0] / rec["ms"]
    return rec


def window_index(pyr, y, x, ah, aw):
    """Broadcast (batch, row, column) index tensors of the (ah, aw)
    windows at element origins y, x (B,C), each window inside the
    pyramid."""
    dev = pyr.device
    rows = (y.long()[..., None] + torch.arange(ah, device=dev))[..., :, None]
    cols = (x.long()[..., None] + torch.arange(aw, device=dev))[..., None, :]
    bidx = torch.arange(pyr.shape[0], device=dev)[:, None, None, None]
    return bidx, rows, cols


def window_bytes(pyr, y, x, ah, aw, starts):
    """Bytes a window copy must move, for the (ah, aw) windows at element
    origins y, x (B,C): the pyramid pixels under some window read once
    (the union of the windows; a pixel no window covers need not be read,
    and one that several cover need be read only once), the starts read
    once, the windows written once."""
    covered = torch.zeros(pyr.shape, dtype=torch.bool, device=pyr.device)
    covered[window_index(pyr, y, x, ah, aw)] = True
    return ((int(covered.sum()) + y.numel() * ah * aw) * pyr.element_size()
            + starts.numel() * starts.element_size())


def gather_ms(pyr, y, x, ah, aw, expect):
    """CUDA-event time of the one PyTorch call that computes B2, B5 and B6
    (LIBRARY_GATHER) at windows (ah, aw) from element origins y, x (B,C);
    its result must equal `expect`."""
    bidx, rows, cols = window_index(pyr, y, x, ah, aw)

    def call():
        return pyr[bidx, rows, cols]

    if not torch.equal(call(), expect):
        raise AssertionError("the library gather disagrees with the kernel")
    return cuda_ms(call, queued=True)


def copy_path(pyr, C, ah, aw, x_align=1):
    """The window copy's kernel for this geometry (``window_copy_path``)
    and, on the TMA path, its plan: band rows, ring stages, CTAs and
    shared bytes per CTA."""
    from repas_tpu_torch.kernels import patch_extract
    path, plan = patch_extract.launch_plan(pyr, C, ah, aw, x_align)
    if plan is None:
        return {"path": path}
    return {"path": path, "bh": plan.bh, "bw": plan.bw,
            "stages": plan.stages, "grid": plan.grid,
            "smem_bytes": plan.smem_bytes}


def check_b2(name, pyr, origins, ah, aw, x_align=1):
    from repas_tpu_torch.kernels import patch_extract
    hp, w = pyr.shape[-2:]
    y = patch_extract.slice_start(origins[..., 0], hp, ah)
    x = patch_extract.slice_start(origins[..., 1], w, aw)
    path = copy_path(pyr, origins.shape[1], ah, aw, x_align)

    def kern():
        return patch_extract.extract_windows(pyr, origins, ah, aw,
                                             x_align=x_align)

    err_ms = hold(
        name, pyr.shape, kern,
        lambda: patch_extract.extract_windows_plain(pyr, origins, ah, aw),
        windows=list(origins.shape[:-1]), window=[ah, aw], **path)
    lib = gather_ms(pyr, y, x, ah, aw, kern())
    rec = record(name, B2_SRC, err_ms,
                 window_bytes(pyr, y, x, ah, aw, origins), 0, F32_OPS_PER_S,
                 LIBRARY_GATHER, lib)
    rec["input_shape"] = list(pyr.shape)
    rec.update(path)
    return rec


def check_b5(name, pyr, starts_blk, ph, pw, tile_h):
    """B5 (extract_windows_blk) against its plain version, exact. The
    starts are checked once on the host first, as micro_perf does, so
    the timed calls are the launches alone (the wrapper's own check
    would synchronise each one)."""
    from repas_tpu_torch.kernels import patch_extract
    origins = patch_extract.blk_origins(pyr.shape, starts_blk, ph, pw,
                                        tile_h).to(pyr.device)
    y, x = origins[..., 0], origins[..., 1]

    def kern():
        return patch_extract.extract_windows_blk(pyr, starts_blk, ph, pw,
                                                 tile_h, checked=True)

    err_ms = hold(
        name, pyr.shape, kern,
        lambda: patch_extract.extract_windows_blk_plain(pyr, starts_blk, ph,
                                                        pw, tile_h),
        windows=list(starts_blk.shape[:-1]), window=[ph, pw], tile_h=tile_h,
        dtype=str(pyr.dtype))
    lib = gather_ms(pyr, y, x, ph, pw, kern())
    rec = record(name, B5_SRC, err_ms,
                 window_bytes(pyr, y, x, ph, pw, starts_blk), 0,
                 F32_OPS_PER_S, LIBRARY_GATHER, lib)
    rec["input_shape"] = list(pyr.shape)
    rec.update(copy_path(pyr, starts_blk.shape[1], ph, pw,
                         patch_extract.LANE_TILE))
    return rec


def check_b6(name, pyr, starts, ph, pw):
    """B6 (extract_windows_exact) against its plain version, exact."""
    from repas_tpu_torch.kernels import patch_extract
    hp, w = pyr.shape[-2:]
    y = patch_extract.slice_start(starts[..., 1], hp, ph)
    x = patch_extract.slice_start(starts[..., 0], w, pw)
    path = copy_path(pyr, starts.shape[1], ph, pw)
    err_ms = hold(
        name, pyr.shape,
        lambda: patch_extract.extract_windows_exact(pyr, starts, ph, pw),
        lambda: patch_extract.extract_windows_exact_plain(pyr, starts, ph,
                                                          pw),
        windows=list(starts.shape[:-1]), window=[ph, pw], **path)
    lib = gather_ms(pyr, y, x, ph, pw,
                    patch_extract.extract_windows_exact(pyr, starts, ph, pw))
    rec = record(name, B6_SRC, err_ms,
                 window_bytes(pyr, y, x, ph, pw, starts), 0, F32_OPS_PER_S,
                 LIBRARY_GATHER, lib)
    rec["input_shape"] = list(pyr.shape)
    rec.update(path)
    return rec


def check_b6_edges(pyr, ph, pw):
    """B6 at negative, past-the-edge and edge starts on micro_perf's
    pyramid, exact against its plain version (dynamic_slice's rule: a
    negative start counts from the end, then every start is clamped so
    the window fits), on the path micro_perf's call takes."""
    from repas_tpu_torch.kernels import patch_extract
    B, hp, w = pyr.shape
    edge = [[-1, -1], [-7, -5], [-w, -hp], [-3 * w, 17], [w - pw, hp - ph],
            [w - pw + 1, hp - ph + 1], [w, hp], [10 * w, -10 * hp],
            [-pw, -ph], [0, 0], [w - 1, -1], [-(w - pw), 3]]
    starts = torch.tensor([edge[(i + b) % len(edge)] for b in range(B)
                           for i in range(len(edge))], dtype=torch.int32,
                          device=pyr.device).reshape(B, len(edge), 2)
    got = patch_extract.extract_windows_exact(pyr, starts, ph, pw)
    ref = patch_extract.extract_windows_exact_plain(pyr, starts, ph, pw)
    torch.cuda.synchronize()
    exact = torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    path = copy_path(pyr, starts.shape[1], ph, pw)
    log({"kernel": "B6 patch_exact (negative and edge starts)",
         "input_shape": list(pyr.shape), "windows": list(starts.shape[:2]),
         "window": [ph, pw], **path, "exact": exact})
    if not exact or path["path"] != "tma":
        raise AssertionError(f"B6 at negative and edge starts: exact "
                             f"{exact}, path {path['path']}")


def check_kernels(captured):
    """Each kernel against its plain version on the card, at the main
    path's inputs; returns the kernel records (launches filled later)."""
    b1_args, _ = captured["ccl"]
    (pyr, origins, ah, aw), kw2 = captured["patch_extract"]
    (depth, rgb32, K), kw = captured["pointcloud"]
    return [
        check_b1("B1 ccl", *b1_args),
        check_b2("B2 patch_extract", pyr, origins, ah, aw, **kw2),
        check_b3("B3 pointcloud", depth, rgb32, K, kw["scale"]),
    ]


def check_b3(name, depth, rgb32, K, scale):
    from repas_tpu_torch.kernels import pointcloud

    npix = depth.numel()
    # depth (u16) and packed colour (int32) read once, six f32 planes
    # written once
    b3_bytes = npix * (depth.element_size() + rgb32.element_size() + 6 * 4)
    rec = record(name, B3_SRC, hold(
        name, depth.shape,
        lambda: pointcloud.fused_pointcloud(depth, rgb32, K, scale),
        lambda: pointcloud.fused_pointcloud_plain(depth, rgb32, K, scale),
        1e-6), b3_bytes, B3_OPS_PER_POINT * npix, F32_OPS_PER_S,
        NO_LIBRARY_B3)
    rec["input_shape"] = list(depth.shape)
    return rec


def check_results(out, out_cpu0, dev_name):
    """Detections and pose of the bench batch, and frame 0 against the
    port's CPU run."""
    det, pose = out.detections, out.pose
    if tuple(out.pointcloud.shape) != (BATCH, 6, H * W):
        raise AssertionError(f"pointcloud shape {tuple(out.pointcloud.shape)}")
    if not bool(torch.isfinite(out.pointcloud).all()):
        raise AssertionError("pointcloud has non-finite values")
    best = torch.argmax(torch.where(det.valid, det.decision_margin, -1.0),
                        dim=1)
    rows = torch.arange(BATCH, device=best.device)
    best_valid = det.valid[rows, best].cpu()
    best_id = det.ids[rows, best].cpu()
    if not bool(best_valid.all()) or not bool((best_id == TAG_ID).all()):
        raise AssertionError(f"best slots: valid {best_valid.tolist()}, "
                             f"ids {best_id.tolist()}")
    z = pose.anchor_P_depth[:, 2].cpu()
    if not bool(((z - TAG_Z).abs() <= 0.005).all()):
        raise AssertionError(f"anchor_P_depth z {z.tolist()}")

    d0 = out_cpu0.detections
    ids_gpu, ids_cpu = det.ids[0].cpu(), d0.ids[0]
    valid_gpu, valid_cpu = det.valid[0].cpu(), d0.valid[0]
    if not (torch.equal(ids_gpu, ids_cpu) and torch.equal(valid_gpu,
                                                          valid_cpu)):
        raise AssertionError(f"frame 0 on {dev_name} vs CPU: ids "
                             f"{ids_gpu.tolist()} vs {ids_cpu.tolist()}")
    cdiff = (det.corners[0].cpu() - d0.corners[0]).abs()[valid_cpu]
    corner_err = float(cdiff.max()) if cdiff.numel() else 0.0
    if corner_err > 0.05:
        raise AssertionError(f"frame 0 corners differ from CPU by "
                             f"{corner_err} px")
    log({"phase": "results", "best_ids": best_id.tolist(),
         "anchor_z_m": z.tolist(), "frame0_vs_cpu_corner_max_px": corner_err,
         "frame0_ids": ids_gpu.tolist()})


def check_b4(mask, iters, converge=False, name="B4 ccl_tiled"):
    """B4 on the ladder's first B4 input: the row unit on the initial
    labels, the column unit on the row unit's output, and the tiled CCL
    (the band CCL in grid mode, `converge` as called), each exactly
    against its plain version (and the CCL against B1); CUDA-event times
    of kernel and plain."""
    from repas_tpu_torch.kernels import ccl_cuda, ccl_tiled

    B, h, w = mask.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device)
    labels0 = torch.where(mask, idx.reshape(h, w), h * w)
    rows_plain = ccl_tiled.seg_scan_axis_plain(mask, labels0, 2)
    cases = [
        ("rows", lambda: ccl_tiled.seg_scan_axis_cuda(mask, labels0, 2),
         lambda: ccl_tiled.seg_scan_axis_plain(mask, labels0, 2)),
        ("columns", lambda: ccl_tiled.seg_scan_axis_cuda(mask, rows_plain, 1),
         lambda: ccl_tiled.seg_scan_axis_plain(mask, rows_plain, 1)),
        ("tiled_ccl",
         lambda: ccl_tiled.connected_components_tiled_cuda(mask, iters,
                                                           converge),
         lambda: ccl_tiled.connected_components_tiled_plain(mask, iters,
                                                            converge)),
    ]
    out = {}
    for unit, kern, plain in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"B4 {unit}: kernel differs from its plain "
                                 f"version at {bad} pixels")
        out[unit] = {"ms": cuda_ms(kern, queued=True),
                     "plain_ms": cuda_ms(plain, 5, 1)}
    if not torch.equal(
            ccl_tiled.connected_components_tiled_cuda(mask, iters, converge),
            ccl_cuda.connected_components_cuda(mask, iters, converge)):
        raise AssertionError("B4 tiled CCL differs from B1's labels")
    plan = ccl_plan(mask, cluster_ok=False)
    rounds = ccl_rounds("b4", lambda: ccl_tiled.connected_components_tiled_cuda(
        mask, iters, converge), mask.device)
    log({"kernel": name, "input_shape": list(mask.shape),
         "iters": iters, "converge": converge, "rounds": rounds,
         "foreground_frac": float(mask.float().mean()),
         "plan": plan, "max_abs_err": 0.0,
         **{f"{k}_{m}": v[m] for k, v in out.items()
            for m in ("ms", "plain_ms")}})
    rec = record(name, B4_SRC,
                 (0.0, out["tiled_ccl"]["ms"], out["tiled_ccl"]["plain_ms"]),
                 *ccl_cost(mask, iters), INT32_OPS_PER_S, NO_LIBRARY_CCL)
    rec["plan"] = plan
    rec["unit_source"] = "repas_tpu_torch/kernels/csrc/ccl_tiled.cu"
    rec["unit_ms"] = {k: out[k] for k in ("rows", "columns")}
    return rec


def robust_phase(dev, gpu_line):
    """The staged ladder + best-order PnP on the card, eager (main() runs
    it with the plain functions of the compiled steps); returns the kernel
    records of the ladder's path (B1 and B2 at each of the ladder's input
    shapes, B4 on its first input), launches from the counted ladder
    run."""
    from repas_tpu_torch.core.config import DetectorConfig, PnPConfig
    from repas_tpu_torch.detect import robust
    from repas_tpu_torch.kernels import (_build, ccl_cuda, ccl_tiled,
                                         patch_extract)

    frames_np = robust_frames()
    frames = torch.from_numpy(frames_np).to(dev)
    K = torch.from_numpy(ROBUST_K).to(dev)
    cfg = DetectorConfig()
    tag = PnPConfig().tag_size_m

    # warm-up run (copies the cached constants) that records the inputs
    # of B4's first call and of B1's and B2's first call at each shape:
    # stage A's decimated frames, stage B's 256 px ROIs (whose windows
    # take B2's exact-window geometry) and stage C's full frames
    with Capture(ccl_tiled, "connected_components_tiled_cuda") as cap, \
            Capture(ccl_cuda, "connected_components_cuda", True) as cap1, \
            Capture(patch_extract, "extract_windows", True) as cap2:
        ladder_and_pose(frames, K, cfg, tag)
        torch.cuda.synchronize()
    if cap.args is None:
        raise AssertionError("the ladder never called kernel B4")
    records = [check_b1(f"B1 ccl (ladder {tuple(a[0].shape)})", *a)
               for a, _ in cap1.calls]
    records += [check_b2(f"B2 patch_extract (ladder {tuple(a[0].shape)}, "
                         f"{a[2]}x{a[3]} windows)", *a, **kw)
                for a, kw in cap2.calls]
    records.append(check_b4(*cap.args[0]))

    found_a = robust._stage_a(frames, cfg)[1].cpu().tolist()
    if found_a != ROBUST_FOUND_A:
        raise AssertionError(f"stage A found {found_a}, expected "
                             f"{ROBUST_FOUND_A}")

    # the ladder, counted: launches, wave tests and synchronizing calls
    _build.reset_launches()
    robust.host_reads["wave_tests"] = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            det, best, t, err = ladder_and_pose(frames, K, cfg, tag)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    wave_tests = robust.host_reads["wave_tests"]
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    log({"phase": "robust_counts", "launches": counts,
         "wave_tests": wave_tests, "sync_calls": len(syncs)})
    if len(syncs) > wave_tests:
        raise AssertionError(f"the ladder synchronized {len(syncs)} times "
                             f"for {wave_tests} wave tests: {syncs[:5]}")
    missing = [k for k in ("ccl", "patch_extract", "ccl_tiled")
               if counts[k] < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the ladder: {missing}")
    keys = {"B1": "ccl", "B2": "patch_extract", "B4": "ccl_tiled"}
    for rec in records:
        rec["launches"] = counts[keys[rec["name"][:2]]]

    # results: best-slot ids, poses, and two frames against the CPU
    rows = torch.arange(ROBUST_BATCH, device=dev)
    best_id = det.ids[rows, best].cpu().tolist()
    best_valid = det.valid[rows, best].cpu().tolist()
    tz, err = t[:, 2].cpu(), err.cpu()
    for i, want in enumerate(ROBUST_IDS):
        if want is None:
            if bool(det.valid[i].any()):
                raise AssertionError(f"frame {i}: a valid slot in a frame "
                                     f"without a tag: {det.ids[i].tolist()}")
        elif not (best_valid[i] and best_id[i] == want):
            raise AssertionError(f"frame {i}: best slot {best_id[i]} "
                                 f"(valid {best_valid[i]}), expected {want}")
        elif not (float(tz[i]) > 0 and float(err[i]) < 1.0):
            raise AssertionError(f"frame {i}: PnP t_z {float(tz[i])}, "
                                 f"error {float(err[i])} px")
    sub = [4, 7]
    cpu = robust.detect_tags_robust_staged(torch.from_numpy(frames_np[sub]),
                                           cfg)
    for j, i in enumerate(sub):
        if not (torch.equal(det.ids[i].cpu(), cpu.ids[j])
                and torch.equal(det.valid[i].cpu(), cpu.valid[j])):
            raise AssertionError(f"frame {i} on the card vs CPU: ids "
                                 f"{det.ids[i].tolist()} vs "
                                 f"{cpu.ids[j].tolist()}")
    v = cpu.valid
    cdiff = (det.corners[sub].cpu() - cpu.corners).abs()[v]
    corner_err = float(cdiff.max()) if cdiff.numel() else 0.0
    if corner_err > 0.05:
        raise AssertionError(f"frames {sub} corners differ from the CPU by "
                             f"{corner_err} px")
    log({"phase": "robust_results", "best_ids": best_id,
         "stage_a_found": found_a, "t_z_m": tz.tolist(),
         "reproj_err_px": err.tolist(),
         "frames_4_7_vs_cpu_corner_max_px": corner_err})

    # ladder + PnP time: host clock around synchronized calls
    call_ms = []
    for _ in range(ROBUST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ladder_and_pose(frames, K, cfg, tag)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(call_ms))
    log({"phase": "robust_ladder", "batch": ROBUST_BATCH, "height": H,
         "width": W, "call_ms_median": med, "call_ms_all": call_ms,
         "frames_per_s": ROBUST_BATCH * 1e3 / med, "gpu": gpu_line})

    # the single-image ladder on one frame launches B4 too
    _build.reset_launches()
    single = robust.detect_tags_robust(frames[0])
    torch.cuda.synchronize()
    single_counts = dict(_build.launches)
    if single_counts["ccl_tiled"] < 1:
        raise AssertionError(f"detect_tags_robust never launched B4: "
                             f"{single_counts}")
    if 9 not in single.ids[single.valid].tolist():
        raise AssertionError(f"detect_tags_robust on frame 0: "
                             f"{single.ids.tolist()}")
    log({"phase": "robust_single", "launches": single_counts,
         "ids": single.ids.tolist()})
    return records


def host_ms(fn, reps):
    """Host-clock ms of each of `reps` synchronized calls of fn."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def distorted_pipeline(dev, gpu_line):
    """The 720p pipeline at batch 16 with the lens's coefficients, as
    tensors on the card, under sync-error mode: B1-B3 launched, every
    frame within 1 mm and 0.3 degrees of the truth, more than 3 mm off
    without the coefficients, frame 0 as on the CPU; then without a
    cloud (no B3)."""
    from repas_tpu_torch import pipeline
    from repas_tpu_torch.core.config import PipelineConfig, PnPConfig
    from repas_tpu_torch.kernels import _build

    rgbs_np, depths_np, R, t = distorted_frames(BATCH)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    depths = torch.from_numpy(depths_np).to(dev)
    K = torch.from_numpy(DIST_K).to(dev)
    dist = torch.from_numpy(DIST).to(dev)
    cfg = PipelineConfig(pnp=PnPConfig(tag_size_m=DIST_TAG))

    def step(**kw):
        return pipeline.process_frames(rgbs, depths, K, cfg, **kw)

    step(dist=dist)                        # warm-up: cached constants
    torch.cuda.synchronize()
    out, counts = counted(lambda: step(dist=dist), "distorted pipeline",
                          sync_error=True)
    terr, rerr = pose_errors(out, R, t)
    if max(terr) >= 1.0 or max(rerr) >= 0.3:
        raise AssertionError(f"with dist: t errors {terr} mm, R errors "
                             f"{rerr} deg")
    bare = step()
    terr0, rerr0 = pose_errors(bare, R, t)
    if min(terr0) <= 3.0:
        raise AssertionError(f"without dist the pose is within 3 mm: "
                             f"{terr0}")

    cpu = pipeline.process_frames(torch.from_numpy(rgbs_np[:1]),
                                  torch.from_numpy(depths_np[:1]), DIST_K,
                                  cfg, dist=DIST)
    d, c = out.detections, cpu.detections
    if not (torch.equal(d.ids[0].cpu(), c.ids[0])
            and torch.equal(d.valid[0].cpu(), c.valid[0])):
        raise AssertionError(f"frame 0 on the card vs CPU: ids "
                             f"{d.ids[0].tolist()} vs {c.ids[0].tolist()}")
    v = c.valid[0]
    corner_err = float((d.corners[0].cpu() - c.corners[0]).abs()[v].max())
    t_err = float((out.pose.t[0].cpu() - cpu.pose.t[0]).abs()[v].max())
    r_err = max(angle_deg(a, b) for a, b in zip(
        out.pose.R[0].cpu()[v].numpy(), cpu.pose.R[0][v].numpy()))
    if corner_err > 0.05 or t_err > 1e-4 or r_err > 0.25:
        raise AssertionError(f"frame 0 vs CPU: corners {corner_err} px, t "
                             f"{t_err} m, R {r_err} deg")

    _build.reset_launches()
    nocloud = step(dist=dist, with_pointcloud=False)
    torch.cuda.synchronize()
    if _build.launches["pointcloud"] != 0 or \
            tuple(nocloud.pointcloud.shape) != (BATCH, 6, 0):
        raise AssertionError(f"with_pointcloud=False: B3 launches "
                             f"{_build.launches['pointcloud']}, cloud "
                             f"{tuple(nocloud.pointcloud.shape)}")
    step_ms = host_ms(lambda: step(dist=dist), STEPS)
    bare_ms = host_ms(lambda: step(dist=dist, with_pointcloud=False), STEPS)
    med = float(np.median(step_ms))
    log({"phase": "distorted_pipeline", "batch": BATCH, "launches": counts,
         "t_err_mm": terr, "R_err_deg": rerr, "t_err_mm_without_dist": terr0,
         "frame0_vs_cpu": {"corner_px": corner_err, "t_m": t_err,
                           "R_deg": r_err},
         "step_ms_median": med, "step_ms_all": step_ms,
         "frames_per_s": BATCH * 1e3 / med,
         "no_cloud_step_ms_median": float(np.median(bare_ms)),
         "gpu": gpu_line})


def tracker_split(tr, frame):
    """Median host ms of a tracking tracker's stages on `frame`, each
    synchronized alone: the ROI detector and the LM of a track step, the
    full-frame detector and IPPE of a registration."""
    from repas_tpu_torch.detect.detector import detect_tags
    from repas_tpu_torch.pose.pnp import (refine_pnp_gn,
                                          solve_pnp_ippe_square,
                                          square_object_points)

    img = torch.from_numpy(frame).to(tr.device)
    u0, v0 = tr._predict_roi_origin(img.shape, TRACKER_ROI)
    roi = img[None, v0:v0 + TRACKER_ROI, u0:u0 + TRACKER_ROI]
    obj = square_object_points(tr.tag_size, tr.device)
    corners = detect_tags(img[None], tr.det_cfg).corners[0, 0]

    def lm():
        refine_pnp_gn(obj, corners, tr._rvec, tr._tvec, tr.K, tr.dist,
                      iters=tr.cfg.gn_iters)

    stages = {
        "track_detect_ms": lambda: detect_tags(roi, tr.roi_cfg),
        "track_lm_ms": lm,
        "register_detect_ms": lambda: detect_tags(img[None], tr.det_cfg),
        "register_ippe_ms": lambda: solve_pnp_ippe_square(
            corners, tr.K, tr.tag_size, dist=tr.dist),
    }
    return {k: float(np.median(host_ms(fn, 5))) for k, fn in stages.items()}


def tracker_phase(dev, gpu_line, records):
    """The register-then-track streamer on 1280x720 frames: B1 and B2
    held exactly against their plain versions at the register and track
    shapes (their inputs seen in the warm-up, which captures the
    tracker's compiled steps), then a counted stream (modes, truth,
    syncs per step, no wrapper launch: every step replays), then the
    stream again with each step traced (B1 and B2 once on the device per
    track step), then one robust registration. Appends the
    tracker-shape kernel records; adds the track step's launches and
    times to the main path's B1 and B2 records."""
    from repas_tpu_torch.kernels import _build, ccl_cuda, patch_extract
    from repas_tpu_torch.pose.track import TagTracker, TrackerConfig

    frames, truth = tracker_stream()

    def tracker(**kw):
        return TagTracker(ROBUST_K, tag_size=TRACK_TAG, device=dev, **kw)

    # warm-up on the first frames, recording B1's and B2's first input at
    # the register and the track shapes: the captures' eager warm-ups
    _build.reset_launches()
    with Capture(ccl_cuda, "connected_components_cuda", True) as c1, \
            Capture(patch_extract, "extract_windows", True) as c2:
        tr = tracker()
        for f in frames[:3]:
            tr.step(f)
        torch.cuda.synchronize()
    warm_counts = dict(_build.launches)
    def step_of(shape):      # the ROI step runs on 256 px wide inputs
        return "track" if shape[-1] == TRACKER_ROI else "register"

    new = [check_b1(f"B1 ccl (tracker {step_of(a[0].shape)} "
                    f"{tuple(a[0].shape)})", *a) for a, _ in c1.calls]
    new += [check_b2(f"B2 patch_extract (tracker {step_of(a[0].shape)} "
                     f"{tuple(a[0].shape)}, {a[2]}x{a[3]} windows)", *a, **kw)
            for a, kw in c2.calls]
    shapes = sorted(tuple(a[0].shape) for a, _ in c1.calls)
    if shapes != [(1, 256, 256), (1, 360, 640)]:
        raise AssertionError(f"tracker B1 shapes {shapes}")

    # the stream, counted: modes, truth, launches and syncs per step
    tr = tracker()
    steps = []
    for f, t in zip(frames, truth):
        before = dict(_build.launches)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                res = tr.step(f)
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode("default")
        steps.append({
            "mode": res.mode, "ok": bool(res.ok), "ms": ms,
            "syncs": len(sync_warnings(caught)),
            "t_err_mm": (float(np.linalg.norm(res.t - t)) * 1000
                         if res.ok else None),
            **{k: _build.launches[k] - before[k]
               for k in ("ccl", "patch_extract")}})
    modes = [s["mode"] for s in steps]
    if modes != TRACK_MODES:
        raise AssertionError(f"tracker modes {modes}")
    bad = [(i, s["t_err_mm"]) for i, s in enumerate(steps)
           if s["ok"] and s["t_err_mm"] >= 3.5]
    if bad or not all(s["ok"] for s, m in zip(steps, modes) if m != "lost"):
        raise AssertionError(f"tracker t errors over 3.5 mm: {bad}")
    track = [s for s in steps if s["mode"] == "track"]
    if any(s["ccl"] or s["patch_extract"] for s in steps):
        raise AssertionError(
            "a tracker step launched kernels outside its graphs: "
            f"{[(s['ccl'], s['patch_extract']) for s in steps]}")
    # the stream again, each step traced: B1 and B2 on the device
    tr_traced = tracker()
    traced0 = TRACED_S[0]
    traced_steps = []
    for f in frames:
        res, wrapped, device, _ = traced(lambda: tr_traced.step(f))
        traced_steps.append((res.mode, wrapped, device))
    if [m for m, _, _ in traced_steps] != TRACK_MODES or any(
            any(w.values()) for _, w, _ in traced_steps):
        raise AssertionError(f"traced tracker stream: {traced_steps}")
    per_step = [(d["ccl"], d["patch_extract"]) for _, _, d in traced_steps]
    if any(p != (1, 1) for p, (m, _, _) in zip(per_step, traced_steps)
           if m == "track") or not all(p in ((1, 1), (2, 2))
                                       for p in per_step):
        raise AssertionError(f"B1/B2 device launches per tracker step "
                             f"{per_step}")
    # one device read per step: the track step's, the registration's,
    # and both where a failed track step falls back to registration
    if max(s["syncs"] for s in track) > 1 or \
            max(s["syncs"] for s in steps) > 2:
        raise AssertionError(f"tracker steps synchronized "
                             f"{[s['syncs'] for s in steps]} times")
    reg_ms = float(np.median([s["ms"] for s in steps
                              if s["mode"] == "register"]))
    track_ms = float(np.median([s["ms"] for s in track]))
    log({"phase": "tracker", "frames": len(frames), "modes": modes,
         "t_err_mm": [s["t_err_mm"] for s in steps],
         "syncs": [s["syncs"] for s in steps],
         "wrapper_launches_warm_up": warm_counts,
         "device_launches_ccl": [p[0] for p in per_step],
         "device_launches_patch_extract": [p[1] for p in per_step],
         "traced_stream_s": TRACED_S[0] - traced0,
         "register_ms_median": reg_ms, "track_ms_median": track_ms,
         "track_ms_all": [s["ms"] for s in track],
         "tracked_frames_per_s": 1e3 / track_ms, "gpu": gpu_line})

    log({"phase": "tracker_split", **tracker_split(tr, frames[-1]),
         "gpu": gpu_line})

    device = {"ccl": sum(p[0] for p in per_step),
              "patch_extract": sum(p[1] for p in per_step)}
    for rec in new:
        key = "ccl" if rec["name"][:2] == "B1" else "patch_extract"
        rec["launches"] = warm_counts[key]
        rec["graph_launches"] = device[key]
    track_b1, track_b2 = (next(r for r in new if r["name"].startswith(k)
                               and "tracker track" in r["name"])
                          for k in ("B1", "B2"))
    for rec, i in ((track_b1, 0), (track_b2, 1)):
        rec["launches_per_track_step"] = max(
            p[i] for p, (m, _, _) in zip(per_step, traced_steps)
            if m == "track")
    for rec in records:
        if rec["name"] in ("B1 ccl", "B2 patch_extract"):
            tr_rec = track_b1 if rec["name"][:2] == "B1" else track_b2
            rec["track_launches_per_step"] = tr_rec["launches_per_track_step"]
            rec["track_ms"] = tr_rec["ms"]
            rec["track_shape"] = tr_rec["input_shape"]

    # one registration through the robust ladder (B1, B2 and B4), its
    # compiled pieces captured anew, so the wrappers count the capture
    for m, n in ladder_steps():
        getattr(m, n).clear()
    _build.reset_launches()
    rtr = tracker(config=TrackerConfig(robust_register=True))
    res = rtr.step(frames[0])
    torch.cuda.synchronize()
    rcounts = dict(_build.launches)
    err = float(np.linalg.norm(res.t - truth[0])) * 1000
    if res.mode != "register" or not res.ok or err >= 3.5 \
            or rcounts["ccl_tiled"] < 1:
        raise AssertionError(f"robust registration: {res.mode} ok {res.ok} "
                             f"t err {err} mm, launches {rcounts}")
    log({"phase": "tracker_robust_register", "t_err_mm": err,
         "tag_id": res.tag_id, "launches": rcounts})
    return new


def bundle_phase(dev, gpu_line):
    """solve_tag_bundle on a 3-tag planar layout with one masked slot
    (tests/test_pnp.py's construction) on the card against the CPU port:
    R within 0.01 degrees, t within 0.1 mm; ms per call and syncs."""
    from repas_tpu_torch.kernels.project import project_points
    from repas_tpu_torch.pose.bundle import solve_tag_bundle

    K = torch.from_numpy(ROBUST_K)
    rvec = torch.tensor([0.21, -0.3, 0.08])
    t = torch.tensor([0.05, -0.03, 0.7])
    centers = torch.tensor([[0.0, 0.0, 0.0], [0.12, 0.0, 0.0],
                            [0.0, 0.10, 0.0], [9.9, 9.9, 0.0]])
    h = TRACK_TAG / 2
    offs = torch.tensor([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]])
    corners = project_points(centers[:, None] + offs, rvec, t, K)
    cpx = project_points(centers, rvec, t, K)
    corners[3] = 0.0                          # the masked slot: garbage
    cpx[3] = 0.0
    valid = torch.tensor([True, True, True, False])
    args = (corners, cpx, valid, centers)
    R_c, t_c, e_c = solve_tag_bundle(*args, TRACK_TAG, K)
    on_dev = [a.to(dev) for a in args]
    Kd = K.to(dev)
    solve_tag_bundle(*on_dev, TRACK_TAG, Kd)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            R_g, t_g, e_g = solve_tag_bundle(*on_dev, TRACK_TAG, Kd)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sync_warnings(caught)
    r_err = angle_deg(R_g.cpu().numpy(), R_c.numpy())
    t_err = float((t_g.cpu() - t_c).abs().max())
    if r_err > 0.01 or t_err > 1e-4 or float(e_g) > 0.05:
        raise AssertionError(f"bundle on the card vs CPU: R {r_err} deg, t "
                             f"{t_err} m, error {float(e_g)} px")
    ms = host_ms(lambda: solve_tag_bundle(*on_dev, TRACK_TAG, Kd), 5)
    log({"phase": "bundle", "R_vs_cpu_deg": r_err, "t_vs_cpu_m": t_err,
         "err_px": float(e_g), "syncs_per_call": len(syncs),
         "sync_messages": sorted(set(syncs))[:4],
         "ms_median": float(np.median(ms)), "ms_all": ms, "gpu": gpu_line})


def front_end_phase(dev, gpu_line):
    """Depth-to-color alignment (640x576 plane with a box onto 1280x720
    under a small extrinsic) and NV12/YUYV at 1280x720, each on the card
    against the CPU port: alignment equal on all but 1e-3 of the pixels
    (a projection within an ulp of an integer column or row may floor to
    the other side), YUV within one level on 0.05 % of the values. Each
    of the three, a compiled step, against its eager function
    (compiled_leaf), and the alignment given its numpy camera through
    its public entry replaying the graph of the tensors' call."""
    from repas_tpu_torch.kernels.align import align_depth_to_color
    from repas_tpu_torch.kernels.color import (frame_to_rgb, nv12_to_rgb,
                                               yuyv_to_rgb)

    y, x = np.mgrid[0:576, 0:640]
    depth = (0.9 + 0.0004 * x + 0.0002 * y).astype(np.float32)
    depth[200:380, 250:420] -= 0.25
    depth[::37, ::41] = 0.0
    Kd = np.array([[504.0, 0, 320.5], [0, 504.3, 288.2], [0, 0, 1]],
                  np.float32)
    a = np.radians(1.15)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    t = np.array([0.032, 0.001, -0.002], np.float32)
    args = [torch.from_numpy(v) for v in (Kd, ROBUST_K, R, t)]
    cpu = align_depth_to_color(torch.from_numpy(depth), *args, (H, W))
    dd = torch.from_numpy(depth).to(dev)
    dargs = [v.to(dev) for v in args]
    aligned, compiled = compiled_leaf(
        "front_end align", [("align_depth_to_color", align_depth_to_color)],
        lambda: align_depth_to_color(dd, *dargs, (H, W)))
    with strict_replays() as replays:
        host_cam = align_depth_to_color(dd, Kd, ROBUST_K, R, t, (H, W))
    if replays[0] != 1 or len(align_depth_to_color.graphs) != 1 or \
            not bit_equal(host_cam, aligned):
        raise AssertionError("align_depth_to_color given numpy arrays did "
                             "not replay the tensors' graph")
    compiled["numpy_camera_replayed"] = True
    gpu = align_depth_to_color(dd, *dargs, (H, W)).cpu()
    differ = float((gpu != cpu).float().mean())
    if differ > 1e-3 or float((cpu > 0).float().mean()) < 0.5:
        raise AssertionError(f"alignment on the card differs from the CPU "
                             f"at {differ} of the pixels")
    align_ms = cuda_ms(lambda: align_depth_to_color(dd, *dargs, (H, W)))

    rng = np.random.default_rng(0)
    out = {}
    for name, fn, shape in (("nv12", nv12_to_rgb, (H * 3 // 2, W)),
                            ("yuyv", yuyv_to_rgb, (H, 2 * W))):
        buf = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        bd = buf.to(dev)
        _, yuv = compiled_leaf(f"front_end {name}", [(name, fn)],
                               lambda: fn(bd))
        diff = (fn(bd).cpu().int() - fn(buf).int()).abs()
        share = float((diff > 0).float().mean())
        if int(diff.max()) > 1 or share > 5e-4:
            raise AssertionError(f"{name} on the card vs CPU: max "
                                 f"{int(diff.max())} levels on {share}")
        host = frame_to_rgb(buf.numpy().reshape(-1), name, W, H)
        if not np.array_equal(host, fn(bd).cpu().numpy()):
            raise AssertionError(f"frame_to_rgb({name}) differs")
        out[name] = {"differ_share": share,
                     "ms": cuda_ms(lambda: fn(bd)), "compiled": yuv}
    log({"phase": "front_end", "align_differ_share": differ,
         "align_ms": align_ms, "align_valid_share":
         float((cpu > 0).float().mean()), "align_compiled": compiled, **out,
         "gpu": gpu_line})


# --- compiled_pose: the last seven jax.jit sites as compiled steps beside
# their plain functions, and kernel K3 (SQPnP's 9x9 eigh) -----------------
POSE_SQPNP_N = 16              # one problem per frame of a batch-16 step
POSE_SQPNP_POINTS = 12
K3_BOUND_N = 4096              # K3's matrices for its bound
K3_SRC = ("repas_tpu_torch/kernels/csrc/eig9.cu",
          "repas_tpu/pose/pnp.py:424")
# cuSOLVER's kernels behind torch.linalg's eigh, svd, det and solve
CUSOLVER_NAMES = ("syevj", "syevd", "gesvd", "getrf", "potrf", "geqrf")
SQPNP_DEG, SQPNP_M = 0.01, 1e-4            # the card against the CPU port
SQPNP_OTHER_DEG, SQPNP_OTHER_M = 0.3, 5e-4  # where another candidate wins


def sqpnp_problems(n, seed=0):
    """n non-coplanar PnP problems on the CPU: object points (n,12,3)
    within 0.1 m, 0.4-1.5 m from the camera, pixels (n,12,2) through
    ROBUST_K under 0.3 px of noise; returns (obj, img, K)."""
    from repas_tpu_torch.kernels.project import project_points

    rng = np.random.default_rng(seed)
    K = torch.from_numpy(ROBUST_K.astype(np.float32))
    obj = torch.from_numpy(rng.uniform(-0.1, 0.1, (n, POSE_SQPNP_POINTS, 3))
                           .astype(np.float32))
    rv = torch.from_numpy(rng.normal(0, 0.3, (n, 3)).astype(np.float32))
    t = torch.from_numpy(np.stack([rng.uniform(-0.2, 0.2, n),
                                   rng.uniform(-0.15, 0.15, n),
                                   rng.uniform(0.4, 1.5, n)], 1)
                         .astype(np.float32))
    img = project_points(obj, rv, t, K) + torch.from_numpy(
        rng.normal(0, 0.3, (n, POSE_SQPNP_POINTS, 2)).astype(np.float32))
    return obj, img, K


@contextlib.contextmanager
def cusolver_sqpnp():
    """solve_pnp_sqpnp's solves as the torch.linalg calls the port made
    before K3 (cuSOLVER on the card, each reading a status on the host):
    the 3x3 solve, Omega's eigh, the DLT's SVD and the SVD projection to
    SO(3)."""
    from repas_tpu_torch.pose import pnp

    saved = (pnp._chol_solve, pnp._eigh9, pnp._dlt_null_vector,
             pnp._nearest_rotation)

    def solve(A, B):
        return torch.linalg.solve(A, B) if A.shape[-1] == 3 else \
            saved[0](A, B)

    def null_vector(Ah):
        return torch.linalg.svd(Ah, full_matrices=False)[2][..., -1, :]

    def nearest(M):
        U, _, Vt = torch.linalg.svd(M)
        d = torch.sign(torch.linalg.det(U @ Vt))
        D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
        return (U * D[..., None, :]) @ Vt

    (pnp._chol_solve, pnp._eigh9, pnp._dlt_null_vector,
     pnp._nearest_rotation) = solve, torch.linalg.eigh, null_vector, nearest
    try:
        yield
    finally:
        (pnp._chol_solve, pnp._eigh9, pnp._dlt_null_vector,
         pnp._nearest_rotation) = saved


@contextlib.contextmanager
def pnp_inputs():
    """Records the matrices solve_pnp_sqpnp hands K3's and K2's wrappers
    ({"eig9": [...], "kabsch3": [...]}, clones in call order: K3 Omega,
    then the DLT's float64 Gram; K2 the transposed Omega seeds, then the
    homography seeds)."""
    from repas_tpu_torch.pose import pnp

    seen = {"eig9": [], "kabsch3": []}
    saved = {k: getattr(pnp, k) for k in seen}

    def recorder(key):
        def rec(A, *a, **k):
            seen[key].append(A.clone())
            return saved[key](A, *a, **k)
        return rec

    for key in seen:
        setattr(pnp, key, recorder(key))
    try:
        yield seen
    finally:
        for key, fn in saved.items():
            setattr(pnp, key, fn)


def check_k3(name, A, timed=True):
    """K3 against its plain version (torch.linalg.eigh, cuSOLVER) on the
    card, on A (N,9,9): the plain version in float64 on the same values:
    eigenvalues within 1e-5 (float32 input; 1e-12 for float64) of the
    largest |eigenvalue|, eigenvectors up to sign, 1 - |v.v'| within 1e-6
    (1e-10) where the eigenvalue's gap to its neighbours is over 1e-4 of
    the largest; the same call in A's type (today's): eigenvalues within
    1e-5, vectors within 1e-5 where the gap is over 1e-3 (a float32
    solver errs by ulps of |A| over the gap); |AV - VL| within 1e-5 |A|
    and V orthonormal within 1e-5 everywhere (the degenerate subspaces
    too). Then kernel and plain ms (CUDA events). Returns (the record's
    numbers, ms, plain_ms)."""
    from repas_tpu_torch.kernels.eig9 import eig9, eig9_plain

    n = A.shape[0]
    f64 = A.dtype == torch.float64
    w, V = eig9(A)
    sweeps = torch.zeros(n, dtype=torch.int32, device=A.device)
    eig9(A, sweeps=sweeps)
    w64, V64 = eig9_plain(A.double())
    wp, Vp = eig9_plain(A)
    torch.cuda.synchronize()
    top = w64.abs().amax(1, keepdim=True) + 1e-300
    d = (w64[:, 1:] - w64[:, :-1]) / top
    inf = torch.full((n, 1), float("inf"), dtype=torch.float64,
                     device=A.device)
    gap = torch.minimum(torch.cat([inf, d], 1), torch.cat([d, inf], 1))
    vec64 = 1 - (V.double() * V64).sum(1).abs()
    vecp = 1 - (V.double() * Vp.double()).sum(1).abs()
    Ad, Vd = A.double(), V.double()
    res = (Ad @ Vd - Vd * w.double()[:, None, :]).norm(dim=(1, 2)) / (
        Ad.norm(dim=(1, 2)) + 1e-300)
    eye = torch.eye(9, dtype=torch.float64, device=A.device)

    def worst(x, sel):
        return float(x[sel].max()) if bool(sel.any()) else 0.0

    out = {"matrices": n, "dtype": str(A.dtype).split(".")[-1],
           "eigval_rel_err_f64": float(((w.double() - w64).abs()
                                        / top).max()),
           "eigval_rel_err_plain": float(((w.double() - wp.double()).abs()
                                          / top).max()),
           "eigval_abs_err_plain": float((w.double() - wp.double())
                                         .abs().max()),
           "gap_over_1e-4": int((gap > 1e-4).sum()),
           "vec_err_f64": worst(vec64, gap > 1e-4),
           "vec_err_plain": worst(vecp, gap > 1e-3),
           "residual_rel_max": float(res.max()),
           "orthonormal_err": float((Vd.mT @ Vd - eye).abs().max()),
           "sweeps": torch.bincount(sweeps).tolist()}
    if not (out["eigval_rel_err_f64"] <= (1e-12 if f64 else 1e-5)
            and out["eigval_rel_err_plain"] <= 1e-5
            and out["vec_err_f64"] <= (1e-10 if f64 else 1e-6)
            and out["vec_err_plain"] <= 1e-5
            and out["residual_rel_max"] <= 1e-5
            and out["orthonormal_err"] <= 1e-5
            and int(sweeps.max()) <= 16):
        raise AssertionError(f"{name} against its plain version: {out}")
    ms = cuda_ms(lambda: eig9(A), queued=True) if timed else None
    plain_ms = cuda_ms(lambda: eig9_plain(A)) if timed else None
    log({"kernel": name, "input_shape": list(A.shape), **out, "ms": ms,
         "plain_ms": plain_ms})
    return out, ms, plain_ms


def kabsch3_library(H):
    """K2's library call: torch.linalg.svd, then torch.linalg.det of
    V U^T (cuSOLVER), the SVD and the sign the plain version needs."""
    U, _, Vh = torch.linalg.svd(H)
    return torch.linalg.det(Vh.mT @ U.mT)


def kabsch3_determined(Hd, s):
    """Where the nearest rotation of Hd (N,3,3) float64, singular values
    s, is determined (check_k2_pnp's rule)."""
    top = s[:, 0] + 1e-300
    gap = torch.where(torch.linalg.det(Hd) < 0,
                      torch.minimum(s[:, 1] + s[:, 2], s[:, 1] - s[:, 2]),
                      s[:, 1] + s[:, 2]) / top
    return (gap > 1e-6) & (s[:, 2] / top > 1e-9)


def check_k2_pnp(name, H):
    """K2 against its plain version on the (N,3,3) matrices SQPnP hands
    it (the transposes of the seeds it projects to SO(3)), the plain
    version in float64 on the same values: R within 1e-5 where the
    nearest rotation is determined, (sigma2 + sigma3) / sigma1 > 1e-6 and,
    where det H < 0, (sigma2 - sigma3) / sigma1 > 1e-6 too (the flipped
    axis is the smallest singular vector, free where sigma2 = sigma3, as
    for a sign-flipped seed -R / sqrt(3)), and sigma3 / sigma1 > 1e-9
    (below it the sign of det H is rounding, as for the rank-deficient
    seeds of a coplanar layout); on every matrix the Kabsch
    objective tr(R H) within 1e-6 (sigma1 + sigma2 + sigma3) of the
    plain version's (its maximum, which a free axis does not change),
    det R = 1 and R^T R = I within 1e-5. Then the sweep histogram, and
    the kernel's, the plain version's and the library call's ms (K2's
    behind a spin kernel) beside K2's bound at this shape. Returns the
    numbers."""
    from repas_tpu_torch.kernels.kabsch3 import kabsch3, kabsch3_plain

    n = H.shape[0]
    R = kabsch3(H).double()
    sweeps = torch.zeros(n, dtype=torch.int32, device=H.device)
    kabsch3(H, sweeps=sweeps)
    Hd = H.double()
    R64 = kabsch3_plain(Hd)
    s = torch.linalg.svdvals(Hd)
    torch.cuda.synchronize()
    fixed = kabsch3_determined(Hd, s)
    dR = (R - R64).abs().amax(dim=(1, 2))
    obj = ((R * Hd.mT).sum((1, 2)) - (R64 * Hd.mT).sum((1, 2))).abs() \
        / (s.sum(1) + 1e-300)
    eye = torch.eye(3, dtype=torch.float64, device=H.device)
    out = {"matrices": n, "determined": int(fixed.sum()),
           "dR_max_determined": float(dR[fixed].max())
           if bool(fixed.any()) else 0.0,
           "dR_max_all": float(dR.max()),
           "objective_rel_err_max": float(obj.max()),
           "det_err_max": float((torch.linalg.det(R) - 1).abs().max()),
           "orthonormal_err": float((R.mT @ R - eye).abs().max())}
    if not (out["dR_max_determined"] <= 1e-5
            and out["objective_rel_err_max"] <= 1e-6
            and out["det_err_max"] <= 1e-5
            and out["orthonormal_err"] <= 1e-5):
        raise AssertionError(f"{name} against its plain version: {out}")
    out["sweeps"] = torch.bincount(sweeps).tolist()
    out["ms"] = cuda_ms(lambda: kabsch3(H), queued=True)
    out["plain_ms"] = cuda_ms(lambda: kabsch3_plain(H))
    out["library_ms"] = cuda_ms(lambda: kabsch3_library(H))
    out["bound_ms"], out["bound_by"] = bound_of(n * (36 + 36),
                                                n * KABSCH3_OPS,
                                                F64_OPS_PER_S)
    out["bound_share"] = out["bound_ms"] / out["ms"]
    log({"kernel": name, "input_shape": list(H.shape), **out})
    return out


def pose_vs_cpu(R, t, e, Rc, tc, ec, what):
    """Per problem: R's angle (degrees) and t's largest difference (m)
    against the CPU port; the first bound where the reprojection errors
    agree within 1e-4 px, the second where they do not (another candidate
    won on one side). Returns the numbers."""
    R, t, e = R.cpu().double(), t.cpu().double(), e.cpu().double()
    Rc, tc, ec = Rc.double(), tc.double(), ec.double()
    Rr = R.mT @ Rc
    w = torch.stack([Rr[..., 2, 1] - Rr[..., 1, 2], Rr[..., 0, 2]
                     - Rr[..., 2, 0], Rr[..., 1, 0] - Rr[..., 0, 1]], -1) / 2
    ang = torch.rad2deg(torch.atan2(w.norm(dim=-1), (Rr.diagonal(
        dim1=-2, dim2=-1).sum(-1) - 1) / 2)).reshape(-1)
    dt = (t - tc).abs().reshape(-1, 3).amax(-1)
    same = ((e - ec).abs() <= 1e-4).reshape(-1)
    out = {"R_max_deg": float(ang.max()), "t_max_m": float(dt.max()),
           "err_max_px": float(e.max()), "other_candidate": int((~same)
                                                                .sum())}
    ok = torch.where(same, (ang <= SQPNP_DEG) & (dt <= SQPNP_M),
                     (ang <= SQPNP_OTHER_DEG) & (dt <= SQPNP_OTHER_M))
    if not bool(ok.all()) or out["err_max_px"] > 1.0:
        raise AssertionError(f"{what} on the card vs the CPU port: {out}")
    return out


def compiled_pose_phase(dev, gpu_line, rgbs, depths, K):
    """The last seven jax.jit sites as compiled steps (compiled_leaf each,
    against its eager function) on the 720p bench frame at batch 16: the
    detector on the packed gray frame (B1 and B2 in a replay's trace),
    fusion without and with the 8-order search, best order, IPPE and the
    LM on the detections' corners; the tag bundle (bundle_phase's layout,
    one masked slot) and SQPnP on 16 non-coplanar problems, both against
    the CPU port, the eager call's synchronising calls with cuSOLVER's
    solves and with K2/K3, K2 and K3 in a replay's trace and no cuSOLVER
    kernel; K3 against its plain version at (1,9,9) (the bundle's Omega
    and DLT Gram), (16,9,9) and (4096,9,9), timed beside its bound and
    torch.linalg.eigh; K2 against its plain version on the seeds the
    bundle and the batch project to SO(3), (6,3,3) and (1,3,3), (96,3,3)
    and (16,3,3), timed there beside its bound and torch.linalg.svd +
    det, with its sweep histogram. Every graph is dropped at the end.
    Returns K3's record, and K2's numbers at those shapes (main puts them
    into K2's record as at_other_shapes)."""
    from repas_tpu_torch.core.config import PipelineConfig
    from repas_tpu_torch.core.jit import clear_caches
    from repas_tpu_torch.core.transforms import rodrigues_inv
    from repas_tpu_torch.detect.detector import detect_tags_jit
    from repas_tpu_torch.kernels import _build
    from repas_tpu_torch.kernels.image import gray_from_u32, pack_rgb_u32
    from repas_tpu_torch.kernels.pointcloud import depth_to_meters
    from repas_tpu_torch.kernels.project import project_points
    from repas_tpu_torch.pose import pnp
    from repas_tpu_torch.pose.bundle import solve_tag_bundle_jit
    from repas_tpu_torch.pose.fusion import fuse_tag_poses_jit

    t0 = time.perf_counter()
    cfg = PipelineConfig()
    tag = cfg.pnp.tag_size_m
    gray = gray_from_u32(pack_rgb_u32(rgbs))
    depth_m = depth_to_meters(depths, cfg.depth.depth_scale)
    summary = {}

    # the detector: B1 and B2 inside its graph
    det, summary["detect_tags_jit"] = compiled_leaf(
        "detect_tags_jit", [("detect_tags_jit", detect_tags_jit)],
        lambda: detect_tags_jit(gray, cfg.detector))
    _, counts, device, _ = traced(lambda: detect_tags_jit(gray,
                                                          cfg.detector))
    if any(counts.values()) or device["ccl"] < 1 or \
            device["patch_extract"] < 1:
        raise AssertionError(f"detect_tags_jit replay: wrappers {counts}, "
                             f"device {device}")
    summary["detect_tags_jit"]["replay_device_launches"] = device
    if not bool(((det.ids == TAG_ID) & det.valid).any(-1).all()):
        raise AssertionError(f"detect_tags_jit ids {det.ids.tolist()}")

    # fusion, with the corners' known order and with the 8-order search
    for orders in (False, True):
        name = "fuse_tag_poses_jit" + ("_all_orders" if orders else "")
        fused, summary[name] = compiled_leaf(
            name, [(name, fuse_tag_poses_jit)],
            lambda orders=orders: fuse_tag_poses_jit(
                det.corners, det.ids, det.areas, det.valid, depth_m, K, tag,
                anchor_id=cfg.anchor_id,
                flip_z_ids=cfg.cad.flip_z_tag_ids, win=cfg.depth.center_win,
                try_all_orders=orders))
        z = fused.anchor_P_depth[:, 2].cpu()
        if not bool(((z - TAG_Z).abs() <= 0.005).all()):
            raise AssertionError(f"{name}: anchor z {z.tolist()}")

    # best order, IPPE and the LM on the detections' corners (every slot;
    # an empty slot's degenerate corners give NaN, as eager)
    corners = det.corners
    valid = det.valid
    (_, t_bo, e_bo, _), summary["solve_pnp_best_order_jit"] = compiled_leaf(
        "solve_pnp_best_order_jit",
        [("solve_pnp_best_order_jit", pnp.solve_pnp_best_order_jit)],
        lambda: pnp.solve_pnp_best_order_jit(corners, K, tag))
    (R_ip, t_ip, e_ip), summary["solve_pnp_ippe_square_jit"] = \
        compiled_leaf("solve_pnp_ippe_square_jit",
                      [("solve_pnp_ippe_square_jit",
                        pnp.solve_pnp_ippe_square_jit)],
                      lambda: pnp.solve_pnp_ippe_square_jit(corners, K, tag))
    obj = pnp.square_object_points(tag, dev)
    rv0 = rodrigues_inv(R_ip) + 0.02
    (_, t_lm, e_lm), summary["refine_pnp_gn_jit"] = compiled_leaf(
        "refine_pnp_gn_jit", [("refine_pnp_gn_jit", pnp.refine_pnp_gn_jit)],
        lambda: pnp.refine_pnp_gn_jit(obj, corners, rv0, t_ip + 0.005, K))
    for what, t_, e_ in (("best order", t_bo, e_bo), ("IPPE", t_ip, e_ip),
                         ("LM", t_lm, e_lm)):
        if not bool(((e_ < 1.0) & (t_[..., 2] > 0))[valid].all()):
            raise AssertionError(f"{what} on the valid slots: errors "
                                 f"{e_[valid].tolist()}")
    summary["pnp_valid_slots"] = int(valid.sum())
    summary["pnp_err_max_px"] = {"best_order": float(e_bo[valid].max()),
                                 "ippe": float(e_ip[valid].max()),
                                 "lm": float(e_lm[valid].max())}

    # the tag bundle (bundle_phase's layout) and SQPnP on 16 problems
    Kb = torch.from_numpy(ROBUST_K.astype(np.float32))
    rvec = torch.tensor([0.21, -0.3, 0.08])
    tb = torch.tensor([0.05, -0.03, 0.7])
    centers = torch.tensor([[0.0, 0.0, 0.0], [0.12, 0.0, 0.0],
                            [0.0, 0.10, 0.0], [9.9, 9.9, 0.0]])
    h = TRACK_TAG / 2
    offs = torch.tensor([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]])
    bc = project_points(centers[:, None] + offs, rvec, tb, Kb)
    bpx = project_points(centers, rvec, tb, Kb)
    bc[3], bpx[3] = 0.0, 0.0                   # the masked slot: garbage
    bvalid = torch.tensor([True, True, True, False])
    b_cpu = solve_tag_bundle_jit(bc, bpx, bvalid, centers, TRACK_TAG, Kb)
    b_args = (bc.to(dev), bpx.to(dev), bvalid.to(dev), centers.to(dev))
    obj_s, img_s, Ks = sqpnp_problems(POSE_SQPNP_N)
    s_cpu = pnp.solve_pnp_sqpnp_jit(obj_s, img_s, Ks)
    s_args = (obj_s.to(dev), img_s.to(dev), Ks.to(dev))

    Kbd = Kb.to(dev)

    def bundle():
        return solve_tag_bundle_jit(*b_args, TRACK_TAG, Kbd)

    def sqpnp():
        return pnp.solve_pnp_sqpnp_jit(*s_args)

    syncs = {}
    for name, fn in (("bundle", solve_tag_bundle_jit.fn),
                     ("sqpnp", pnp.solve_pnp_sqpnp_jit.fn)):
        args = (*b_args, TRACK_TAG, Kb.to(dev)) if name == "bundle" \
            else s_args
        with cusolver_sqpnp():
            fn(*args)
            syncs[f"{name}_eager_cusolver"] = len(syncs_of(
                lambda: fn(*args))[1])
        fn(*args)
        syncs[f"{name}_eager"] = len(syncs_of(lambda: fn(*args))[1])
    torch.cuda.synchronize()
    _build.reset_launches()
    (R_b, t_b, e_b), summary["solve_tag_bundle_jit"] = compiled_leaf(
        "solve_tag_bundle_jit",
        [("solve_tag_bundle_jit", solve_tag_bundle_jit)], bundle)
    (R_s, t_s, e_s), summary["solve_pnp_sqpnp_jit"] = compiled_leaf(
        "solve_pnp_sqpnp_jit",
        [("solve_pnp_sqpnp_jit", pnp.solve_pnp_sqpnp_jit)], sqpnp)
    torch.cuda.synchronize()
    launches = {k: _build.launches[k] for k in ("eig9", "kabsch3")}
    if launches["eig9"] < 1 or launches["kabsch3"] < 1:
        raise AssertionError(f"the bundle and SQPnP launched {launches}")
    vs_cpu = {"bundle": pose_vs_cpu(R_b, t_b, e_b, *b_cpu, "the bundle"),
              "sqpnp": pose_vs_cpu(R_s, t_s, e_s, *s_cpu, "SQPnP")}
    traces = {}
    for name, fn in (("bundle", bundle), ("sqpnp", sqpnp)):
        _, counts, _, names = traced(fn)
        low = [n.lower() for n in names]
        traces[name] = {
            "eig9": sum("eig9" in n for n in low),
            "kabsch3": sum("kabsch3" in n for n in low),
            "cusolver": sorted({n[:60] for n in low
                                if any(c in n for c in CUSOLVER_NAMES)}),
            "wrapper_launches": sum(counts.values())}
        if traces[name]["eig9"] < 1 or traces[name]["kabsch3"] < 1 or \
                traces[name]["cusolver"] or \
                traces[name]["wrapper_launches"]:
            raise AssertionError(f"{name} replay trace: {traces[name]}")

    # K3 at the bundle's, the batch's and the bound's shapes; K2 at the
    # bundle's and the batch's
    with pnp_inputs() as seen_b:
        solve_tag_bundle_jit.fn(*b_args, TRACK_TAG, Kb.to(dev))
    with pnp_inputs() as seen_s:
        pnp.solve_pnp_sqpnp_jit.fn(*s_args)
    obj_n, img_n, Kn = sqpnp_problems(K3_BOUND_N, seed=1)
    with pnp_inputs() as seen_n:
        pnp.solve_pnp_sqpnp_jit.fn(obj_n.to(dev), img_n.to(dev), Kn.to(dev))
    small = {}
    for what, A in (("bundle Omega", seen_b["eig9"][0]),
                    ("bundle DLT Gram", seen_b["eig9"][1]),
                    ("SQPnP batch Omega", seen_s["eig9"][0])):
        out, ms, plain_ms = check_k3(f"K3 eig9 ({what})", A)
        bound_ms, bound_by = bound_of(
            A.shape[0] * (81 + 9 + 81) * A.element_size(),
            A.shape[0] * EIG9_OPS, F64_OPS_PER_S)
        small[what] = {"shape": list(A.shape), "dtype": out["dtype"],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "sweeps": out["sweeps"]}
    k2_pnp, k2_shapes = {}, {}
    for who, seen in (("bundle", seen_b), ("SQPnP batch", seen_s)):
        if len(seen["kabsch3"]) != 2:
            raise AssertionError(f"{who}: K2 called {len(seen['kabsch3'])} "
                                 "times, not 2 (the Omega and homography "
                                 "seeds)")
        replay = "bundle" if who == "bundle" else "sqpnp"
        for what, H in zip(("Omega seeds", "homography seeds"),
                           seen["kabsch3"]):
            out = k2_pnp[f"{who} {what}"] = check_k2_pnp(
                f"K2 kabsch3 ({who} {what})", H)
            # launches: one a replay at this shape (two a replay in all,
            # counted in its trace), one in the eager call
            k2_shapes[f"{who} {what}"] = {
                "shape": list(H.shape),
                **{k: out[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by",
                                       "bound_share", "sweeps")},
                "launches_eager_call": sum(x.shape == H.shape
                                           for x in seen["kabsch3"]),
                "replay_launches": traces[replay]["kabsch3"]}
    A = seen_n["eig9"][0]
    out, ms, plain_ms = check_k3("K3 eig9 (bound)", A)
    n = A.shape[0]
    rec = record("K3 eig9", K3_SRC, (out["eigval_abs_err_plain"], ms,
                                     plain_ms), n * (81 + 9 + 81) * 4,
                 n * EIG9_OPS, F64_OPS_PER_S, "torch.linalg.eigh (cuSOLVER), which is "
                 "also the plain version", library_ms=plain_ms)
    rec["launches"] = launches["eig9"]
    rec["replaces_note"] = ("no Pallas kernel: jnp.linalg.eigh and "
                            "jnp.linalg.svd inside the jitted "
                            "solve_pnp_sqpnp")
    rec["input_shape"] = list(A.shape)
    rec["at_other_shapes"] = small
    rec["replay_launches"] = {k: v["eig9"] for k, v in traces.items()}
    clear_caches()
    torch.cuda.empty_cache()
    log({"phase": "compiled_pose", "steps": summary, "syncs": syncs,
         "launches": launches, "vs_cpu": vs_cpu, "replay_traces": traces,
         "k2_vs_plain": k2_pnp,
         "phase_s": time.perf_counter() - t0, "gpu": gpu_line})
    return [rec], k2_shapes


def calibrated_tracking_phase(dev, gpu_line, records):
    """The calibrated-camera path and register-then-track streaming;
    returns the kernel records at the tracker's shapes."""
    distorted_pipeline(dev, gpu_line)
    new = tracker_phase(dev, gpu_line, records)
    bundle_phase(dev, gpu_line)
    front_end_phase(dev, gpu_line)
    return new


def pose_error(T, R, t):
    """(t error mm, R error deg) of a 4x4 T against the truth."""
    T = np.asarray(T, np.float64)
    return (float(np.linalg.norm(T[:3, 3] - t)) * 1000,
            angle_deg(T[:3, :3], R))


def register_staged(src, mask, tgt, tmask, seed):
    """register_clouds' stages, one by one, each ended by a synchronise.
    Returns (ICPResult, ransac fitness, voxel, n_down, seconds by
    stage)."""
    from repas_tpu_torch.cloud import registration as reg
    from repas_tpu_torch.cloud.filters import compact_masked, voxel_downsample
    from repas_tpu_torch.cloud.fpfh import (fpfh_features, match_features,
                                            ransac_registration)
    from repas_tpu_torch.cloud.normals import estimate_normals_grid

    split = dict.fromkeys(("downsample", "normals", "fpfh", "matching",
                           "ransac", "target_normals", "icp"), 0.0)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] += time.perf_counter() - t0
        return out

    voxel = max(0.02 * reg._aabb_diag(src, mask, tgt, tmask), 1e-3)
    clouds, n_down = [], 0
    for pts, m in ((src, mask), (tgt, tmask)):
        pd, _, _, md = timed("downsample",
                             lambda: voxel_downsample(pts, m, voxel))
        pc, mc, nv = timed("downsample",
                           lambda: compact_masked(pd, md, REG_CAPACITY))
        n_down = max(n_down, int(nv))
        nrm, _ = timed("normals", lambda: estimate_normals_grid(
            pc, mc, k=24, radius=2.0 * voxel, dims=(32, 32, 32), slots=32))
        feat = timed("fpfh", lambda: fpfh_features(
            pc, nrm, mc, radius=5.0 * voxel, k=48, dims=(32, 32, 32),
            slots=32))
        clouds.append((pc, mc, feat))
    (sp, sm, sf), (tp, tm, tf) = clouds
    corr, _ = timed("matching", lambda: match_features(sf, sm, tf, tm))
    T0, fit = timed("ransac", lambda: ransac_registration(
        sp, sm, tp, tm, corr, dist_thresh=2.5 * voxel, key=seed))
    T0 = T0.cpu().numpy().astype(np.float64)
    nrm_t, _ = timed("target_normals", lambda: estimate_normals_grid(
        tgt, tmask, k=16, radius=2.0 * voxel))
    res = timed("icp", lambda: reg.icp_point_to_plane(
        src, mask, tgt, tmask, nrm_t, max_corr_dist=1.5 * voxel,
        T_init=T0))
    return res, float(fit), voxel, n_down, split


def registration_steps():
    """(name, compiled step) of every compiled step of register_clouds."""
    from repas_tpu_torch.cloud import filters, fpfh, knn, normals
    from repas_tpu_torch.cloud import registration as reg

    return [(f"{m.__name__.rsplit('.', 1)[1]}.{n}", getattr(m, n))
            for m, n in ((filters, "voxel_downsample"),
                         (filters, "compact_masked"),
                         (knn, "_grid_hash_build"),
                         (knn, "grid_hash_query"),
                         (knn, "grid_hash_query_knn"),
                         (normals, "_normals_grid"),
                         (fpfh, "fpfh_features"), (fpfh, "match_features"),
                         (fpfh, "_ransac_from_picks"), (reg, "_icp"))]


def graph_bytes(steps):
    """{step name: [bytes reserved by each captured graph's private pool,
    with its loop bodies' pools]}, from the caching allocator's
    segments."""
    by_pool = {}
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is not None:
            by_pool[tuple(pid)] = by_pool.get(tuple(pid), 0) + \
                seg["total_size"]
    out = {}
    for name, step in steps:
        out[name] = [sum(by_pool.get(tuple(i), 0) for i in
                         [e.graph.pool()] + [p.id for p in e.pins
                                             if isinstance(
                                                 p, torch.cuda.MemPool)])
                     for e in step.graphs.values()]
    return out


@contextlib.contextmanager
def strict_replays():
    """Every compiled step's replay runs with synchronizing CUDA calls
    raising (the rest keeps the sync-debug mode it has); counts the
    replays."""
    from repas_tpu_torch.core import jit as jit_module

    orig = jit_module.Jitted._replay
    n = [0]

    def replay(self, *args, **kwargs):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            n[0] += 1

    jit_module.Jitted._replay = replay
    try:
        yield n
    finally:
        jit_module.Jitted._replay = orig


def syncs_of(fn):
    """(fn()'s output, the synchronizing CUDA calls it made as sync-debug
    warnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sync_warnings(caught)


def smallest_angle(a, b, p, cam):
    """Angles (rad) between unit vectors a and b (N,3), each first turned
    to face `cam` from p, as _pca_normals turns a normal; up to sign where
    p is None."""
    if p is None:
        return torch.atan2(torch.linalg.cross(a, b).norm(dim=1),
                           (a * b).sum(1).abs())
    a = torch.where(((a * (cam - p)).sum(1) < 0)[:, None], -a, a)
    b = torch.where(((b * (cam - p)).sum(1) < 0)[:, None], -b, b)
    return torch.atan2(torch.linalg.cross(a, b).norm(dim=1),
                       (a * b).sum(1))


def check_k1(A, p, cam, name="K1 eig3"):
    """K1 against its plain version on covariances A (the 1M target's
    for the record): the plain version (torch.linalg.eigh, 16,384
    matrices a call, cuSOLVER's limit) in float64 on the same values:
    eigenvalues within 1e-5 of the largest, the smallest eigenvector
    within 1e-4 rad after both face the camera from the points p (up to
    sign where p is None) where the two smallest eigenvalues are over
    1e-6 of the trace apart, elsewhere |Av - lv| within 1e-5 |A|; the
    same call in float32 (today's): eigenvalues within 1e-5, the smallest
    eigenvector within 1e-4 rad where the gap is over 1e-3 of the trace,
    and angle x gap / trace within 1e-6 where it is over 1e-6 (a float32
    solver errs by a few ulps of |A|, and the vector moves by that over
    the gap). Returns the record and the checks' numbers."""
    from repas_tpu_torch.kernels.eig3 import eig3, eig3_plain

    def plain(M):
        out = [eig3_plain(M[s:s + EIGH_BATCH])
               for s in range(0, M.shape[0], EIGH_BATCH)]
        return (torch.cat([o[0] for o in out]),
                torch.cat([o[1] for o in out]))

    n = A.shape[0]
    w, V = eig3(A)
    w64, V64 = plain(A.double())
    w32, V32 = plain(A)
    sweeps = torch.zeros(n, dtype=torch.int32, device=A.device)
    eig3(A, sweeps=sweeps)
    torch.cuda.synchronize()
    top = w64.abs().amax(dim=1) + 1e-30
    tr = w64.sum(dim=1).abs() + 1e-30
    gap = (w64[:, 1] - w64[:, 0]) / tr
    apart = gap > 1e-6
    ang64 = smallest_angle(V[:, :, 0].double(), V64[:, :, 0],
                           None if p is None else p.double(), cam.double())
    ang32 = smallest_angle(V[:, :, 0], V32[:, :, 0], p, cam).double()
    Ad, Vd = A.double(), V.double()
    res = (Ad @ Vd - Vd * w.double()[:, None, :]).norm(dim=1).amax(dim=1) \
        / (Ad.norm(dim=(1, 2)) + 1e-30)
    out = {"matrices": n, "degenerate_gap_1e-6": int((~apart).sum()),
           "eigval_rel_err_f64": float(((w.double() - w64).abs().amax(1)
                                        / top).max()),
           "eigval_rel_err_f32": float(((w - w32).double().abs().amax(1)
                                        / top).max()),
           "eigval_abs_err_f32": float((w - w32).abs().max()),
           "angle_max_f64": float(ang64[apart].max()),
           "angle_max_f32_gap_1e-3": float(ang32[gap > 1e-3].max()),
           "angle_x_gap_max_f32": float((ang32 * gap)[apart].max()),
           "angle_max_f32_all": float(ang32.max()),
           "residual_rel_degenerate": float(res[~apart].max())
           if bool((~apart).any()) else 0.0,
           "residual_rel_max": float(res.max()),
           "sweeps": torch.bincount(sweeps).tolist()}
    if not (out["eigval_rel_err_f64"] <= 1e-5
            and out["eigval_rel_err_f32"] <= 1e-5
            and out["angle_max_f64"] <= 1e-4
            and out["angle_max_f32_gap_1e-3"] <= 1e-4
            and out["angle_x_gap_max_f32"] <= 1e-6
            and out["residual_rel_degenerate"] <= 1e-5):
        raise AssertionError(f"{name} against its plain version: {out}")
    ms = cuda_ms(lambda: eig3(A), queued=True)
    plain_ms = cuda_ms(lambda: plain(A))
    rec = record("K1 eig3", K1_SRC, (out["eigval_abs_err_f32"], ms,
                                     plain_ms), n * (36 + 48), n * EIG3_OPS,
                 F64_OPS_PER_S,
        "torch.linalg.eigh (cuSOLVER), 16,384 matrices a call: the plain "
        "version", library_ms=plain_ms)
    rec["replaces_note"] = ("no Pallas kernel: jnp.linalg.eigh inside the "
                            "jitted estimate_normals_grid")
    log({"kernel": name, "input_shape": [n, 3, 3], **out, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": rec["bound_ms"]})
    rec["sweeps"] = out["sweeps"]
    return rec


def check_k2(H, ransac_args):
    """K2 against its plain version on the 8,192 triples of one RANSAC
    draw: the plain version (torch.linalg.svd and det) in float64 on the
    same values: R within 1e-5 where sigma2 > 1e-6 sigma1; det R = 1
    within 1e-5 on every triple; the same in float32 (today's): R within
    1e-5 where r = (sigma2 + sigma3) / sigma1 > 1e-2 and |dR| r within
    1e-6 where sigma2 > 1e-6 sigma1 (a float32 SVD errs by a few ulps of
    |H|); the hypothesis scores with K2 and with the float32 plain version
    (equal, or the count that differ logged)."""
    from repas_tpu_torch.cloud import fpfh
    from repas_tpu_torch.kernels.kabsch3 import kabsch3, kabsch3_plain

    n = H.shape[0]
    R = kabsch3(H)
    R64 = kabsch3_plain(H.double())
    R32 = kabsch3_plain(H)
    s = torch.linalg.svdvals(H.double())
    sweeps = torch.zeros(n, dtype=torch.int32, device=H.device)
    kabsch3(H, sweeps=sweeps)
    torch.cuda.synchronize()
    ok = s[:, 1] > 1e-6 * s[:, 0]
    r = (s[:, 1] + s[:, 2]) / (s[:, 0] + 1e-300)
    e64 = (R.double() - R64).abs().amax(dim=(1, 2))
    e32 = (R - R32).double().abs().amax(dim=(1, 2))
    det = (torch.linalg.det(R.double()) - 1).abs()
    scores_k2 = fpfh._ransac_from_picks.fn(*ransac_args)[2]
    saved = fpfh.kabsch3
    fpfh.kabsch3 = kabsch3_plain
    try:
        scores_plain = fpfh._ransac_from_picks.fn(*ransac_args)[2]
    finally:
        fpfh.kabsch3 = saved
    out = {"triples": n, "sigma2_over_1e-6": int(ok.sum()),
           "r_over_1e-2": int((r > 1e-2).sum()),
           "dR_max_f64": float(e64[ok].max()),
           "dR_max_f32_r_1e-2": float(e32[r > 1e-2].max()),
           "dR_x_r_max_f32": float((e32 * r)[ok].max()),
           "dR_max_f32_all": float(e32.max()),
           "det_err_max": float(det.max()),
           "scores_differ": int((scores_k2 != scores_plain).sum()),
           "best_equal": int(torch.argmax(scores_k2))
           == int(torch.argmax(scores_plain)),
           "sweeps": torch.bincount(sweeps).tolist()}
    if not (out["dR_max_f64"] <= 1e-5 and out["dR_max_f32_r_1e-2"] <= 1e-5
            and out["dR_x_r_max_f32"] <= 1e-6
            and out["det_err_max"] <= 1e-5):
        raise AssertionError(f"K2 against its plain version: {out}")
    ms = cuda_ms(lambda: kabsch3(H), queued=True)
    plain_ms = cuda_ms(lambda: kabsch3_plain(H))
    library_ms = cuda_ms(lambda: kabsch3_library(H))
    rec = record("K2 kabsch3", K2_SRC, (out["dR_max_f32_r_1e-2"], ms,
                                        plain_ms), n * (36 + 36),
                 n * KABSCH3_OPS,
                 F64_OPS_PER_S, "torch.linalg.svd then torch.linalg.det "
                 "of V U^T (cuSOLVER), the SVD and the sign the plain "
                 "version needs", library_ms=library_ms)
    rec["replaces_note"] = ("no Pallas kernel: jnp.linalg.svd inside the "
                            "jitted ransac_registration")
    rec["input_shape"] = [n, 3, 3]
    rec["sweeps"] = out["sweeps"]
    log({"kernel": "K2 kabsch3", "input_shape": [n, 3, 3], **out,
         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": rec["bound_ms"]})
    return rec


def registration_1m(dev, gpu_line):
    """register_clouds on the bench's 1M scene on the card, compiled: the
    eager call (disable_jit) with K1's and K2's inputs recorded, K1 and K2
    against their plain versions there; the warm call, which captures
    every stage, with the launch counts set to 0 just before it (K1 and
    K2 launched); the compiled call: gates, synchronising calls (at most
    REG_SYNC_LIMIT, none inside a replay), peak memory, T against the
    eager call's; a traced compiled call (K1, K2 and K4 on the device, no
    cuSOLVER eigh or SVD); compiled and eager seconds in turns; the stage
    split; each graph's reserved bytes; ICP alone compiled against eager
    (capture seconds, graph nodes, also run to max_iters); one ICP
    correspondence pass's device and host ms; K4 and ICP's trips at the
    register cell's shapes (check_k4). Returns K1's, K2's and K4's
    records."""
    from repas_tpu_torch.cloud import fpfh, knn, normals
    from repas_tpu_torch.cloud import registration as reg
    from repas_tpu_torch.core.jit import disable_jit
    from repas_tpu_torch.core.transforms import make_T
    from repas_tpu_torch.kernels import _build

    src_np, tgt_np, R, t = bumpy_scene(REG_N)
    src = torch.from_numpy(src_np).to(dev)
    tgt = torch.from_numpy(tgt_np).to(dev)
    mask = torch.ones(REG_N, dtype=torch.bool, device=dev)
    steps = registration_steps()
    for _, step in steps:
        step.clear()

    def call():
        return reg.register_clouds(src, mask, tgt, mask, seed=REG_SEED)

    def eager():
        with disable_jit():
            return call()

    # the eager call, K1's and K2's inputs and RANSAC's step's recorded
    seen = {"eig3": [], "kabsch3": [], "ransac": []}
    saved = (normals.eig3, fpfh.kabsch3, fpfh._ransac_from_picks)

    def eig3_rec(A, *a, **k):
        seen["eig3"].append(A.clone())
        return saved[0](A, *a, **k)

    def kabsch3_rec(H, *a, **k):
        seen["kabsch3"].append(H.clone())
        return saved[1](H, *a, **k)

    def ransac_rec(*a):
        seen["ransac"].append(a)
        return saved[2](*a)

    normals.eig3, fpfh.kabsch3, fpfh._ransac_from_picks = \
        eig3_rec, kabsch3_rec, ransac_rec
    try:
        t0 = time.perf_counter()
        (res_e, fit_e, voxel), syncs_e = syncs_of(eager)
        eager_first_s = time.perf_counter() - t0
    finally:
        normals.eig3, fpfh.kabsch3, fpfh._ransac_from_picks = saved
    A = torch.cat(seen["eig3"][2:])               # the 1M target's normals
    if A.shape[0] != REG_N or len(seen["kabsch3"]) != 1:
        raise AssertionError(f"eager register_clouds: K1 saw {A.shape[0]} "
                             f"target matrices, K2 {len(seen['kabsch3'])} "
                             "calls")
    cam = torch.zeros(3, device=dev)
    records = [check_k1(A, tgt, cam),
               check_k2(seen["kabsch3"][0], seen["ransac"][0])]
    # K1 at the path's other shapes: one 65,536-matrix chunk of the 1M
    # target (its first points) and the downsampled clouds' capacity
    # (points not recorded: vectors compared up to sign); launches: the
    # eager call's at that shape
    small = {}
    for what, M, p in (("target chunk", seen["eig3"][2],
                        tgt[:seen["eig3"][2].shape[0]]),
                       ("capacity", seen["eig3"][0], None)):
        r = check_k1(M, p, cam, name=f"K1 eig3 ({what})")
        small[what] = {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "bound_share", "sweeps")}
        small[what]["shape"] = list(M.shape)
        small[what]["launches_eager_call"] = sum(
            x.shape == M.shape for x in seen["eig3"])
    records[0]["at_other_shapes"] = small
    del A, seen

    # the warm call captures every stage; the counts see its warm-up and
    # its capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    capture_run_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    reserved1 = torch.cuda.memory_reserved(dev)
    if counts["eig3"] < 1 or counts["kabsch3"] < 1:
        raise AssertionError(f"register_clouds launched no K1 or K2: "
                             f"{counts}")
    records[0]["launches"] = counts["eig3"]
    records[1]["launches"] = counts["kabsch3"]

    # the compiled call: a replay of every stage
    n_down = []
    orig = reg.global_register_fpfh

    def recording(*args, **kwargs):
        out = orig(*args, **kwargs)
        n_down.append(out[2])
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    graphs = sum(len(step.graphs) for _, step in steps)
    reg.global_register_fpfh = recording
    try:
        with strict_replays() as replays:
            t0 = time.perf_counter()
            (res, fit_g, voxel), syncs = syncs_of(call)
            first_s = time.perf_counter() - t0
    finally:
        reg.global_register_fpfh = orig
    peak = torch.cuda.max_memory_allocated(dev)
    Tc, Te = res.T.cpu().numpy(), res_e.T.cpu().numpy()
    t_err, r_err = pose_error(Tc, R, t)
    fitness = float(res.fitness)
    vs_eager = {"t_m": float(np.abs(Tc[:3, 3] - Te[:3, 3]).max()),
                "R_deg": angle_deg(Tc[:3, :3], Te[:3, :3]),
                "iterations": [res.iterations, res_e.iterations],
                "ransac_fitness": [fit_g, fit_e]}
    log({"phase": "registration", "points": REG_N, "voxel_m": voxel,
         "n_down": n_down[0], "capacity": REG_CAPACITY,
         "ransac_fitness": fit_g, "icp_fitness": fitness,
         "icp_rmse_m": float(res.inlier_rmse),
         "icp_iterations": res.iterations, "t_err_mm": t_err,
         "R_err_deg": r_err, "compiled_s": first_s,
         "capture_run_s": capture_run_s, "eager_first_s": eager_first_s,
         "sync_calls": len(syncs), "sync_messages": sorted(set(syncs))[:8],
         "sync_calls_eager": len(syncs_e), "replays": replays[0],
         "launches_capture_run": {k: counts[k] for k in ("eig3",
                                                         "kabsch3")},
         "graphs": graphs,
         "vs_eager": vs_eager, "peak_mem_bytes": peak,
         "graphs_reserved_bytes": reserved1 - reserved0, "gpu": gpu_line})
    # the bench's own gate, then this port's
    if fitness < 0.3 or t_err > 20.0:
        raise AssertionError(f"registration fails the bench gate: fitness "
                             f"{fitness}, t error {t_err} mm")
    if not (fitness > 0.5 and t_err < 1.0 and r_err < 0.05
            and n_down[0] <= REG_CAPACITY):
        raise AssertionError(f"registration: fitness {fitness}, t error "
                             f"{t_err} mm, R error {r_err} deg, n_down "
                             f"{n_down[0]}")
    captured = sum(len(step.graphs) for _, step in steps) - graphs
    if len(syncs) > REG_SYNC_LIMIT or captured or not replays[0]:
        raise AssertionError(f"compiled registration: {len(syncs)} "
                             f"synchronising calls, {replays[0]} replays, "
                             f"{captured} new graphs")
    if vs_eager["t_m"] > 1e-5 or vs_eager["R_deg"] > 1e-3:
        raise AssertionError(f"compiled registration vs eager: {vs_eager}")

    # a traced compiled call: K1 and K2 on the device, no cuSOLVER eigh
    # or SVD
    _, wrappers, _, names = traced(call)
    device = {"eig3": sum("eig3" in n for n in names),
              "kabsch3": sum("kabsch3" in n for n in names),
              "grid_query": sum("grid_query" in n for n in names)}
    solver = sorted({n[:60] for n in names
                     if re.search(r"syev|gesvd|heev", n, re.I)})
    prof = device_profile(call, top=8)
    if any(wrappers.values()) or not all(device.values()) or solver:
        raise AssertionError(f"traced compiled registration: wrappers "
                             f"{wrappers}, K1/K2/K4 on the device {device}, "
                             f"solver kernels {solver}")
    records[0]["graph_launches_registration"] = device["eig3"]
    records[1]["graph_launches_registration"] = device["kabsch3"]

    wall = in_turns({"compiled": call, "eager": eager}, REG_TURNS)
    res2, fit2, _, n_down2, split = register_staged(src, mask, tgt, mask,
                                                    REG_SEED)
    t_err2, r_err2 = pose_error(res2.T.cpu().numpy(), R, t)
    if t_err2 >= 1.0 or r_err2 >= 0.05 or float(res2.fitness) <= 0.5:
        raise AssertionError(f"staged registration: t error {t_err2} mm, R "
                             f"error {r_err2} deg")
    pools = graph_bytes(steps)

    # ICP alone from one T_init, compiled against eager: its capture, its
    # graph's nodes; then with masked source points (C9: NaN RMSE) it
    # runs to max_iters
    nrm_t, _ = normals.estimate_normals_grid(tgt, mask, k=16,
                                             radius=2.0 * voxel)
    T_init = make_T(rotation(np.array(REG_RV) + [0.01, -0.01, 0.005]),
                    torch.from_numpy(t + np.float32([0.004, -0.003, 0.002]))
                    ).numpy()
    smask = mask.clone()
    smask[::100] = False
    icp = {}
    for name, m, iters in (("converging", mask, 100),
                           ("max_iters", smask, ICP_BOUND_ITERS)):
        def one(m=m, iters=iters):
            return reg.icp_point_to_plane(src, m, tgt, mask, nrm_t,
                                          max_corr_dist=1.5 * voxel,
                                          max_iters=iters, T_init=T_init)

        reg._icp.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        entry = next(iter(reg._icp.graphs.values()))
        got = one()
        with disable_jit():
            want = one()

        def eager_one(one=one):
            with disable_jit():
                return one()

        ms = in_turns({"compiled": one, "eager": eager_one}, 1)
        icp[name] = {"iterations": [got.iterations, want.iterations],
                     "t_m": float((got.T - want.T)[:3, 3].abs().max()),
                     "rmse": [float(got.inlier_rmse),
                              float(want.inlier_rmse)],
                     "capture_s": cap_s, "ms": ms,
                     "graph_nodes": entry.nodes,
                     "while_body_nodes": entry.while_nodes,
                     "pool_bytes": graph_bytes([("icp", reg._icp)])["icp"]}
        if got.iterations != want.iterations or icp[name]["t_m"] > 1e-6 \
                or len(entry.while_nodes or []) != 1:
            raise AssertionError(f"compiled ICP vs eager ({name}): "
                                 f"{icp[name]}")
    if icp["max_iters"]["iterations"][0] != ICP_BOUND_ITERS or \
            not np.isnan(icp["max_iters"]["rmse"][0]):
        raise AssertionError(f"ICP with masked points: {icp['max_iters']}")

    # one ICP correspondence pass (both grid levels over the 1M moved
    # source points): the device's time alone (queued behind a spin
    # kernel) against the host clock around it
    gh2 = knn.grid2_build(tgt, mask, 1.5 * voxel)
    Tr = res2.T
    moved = src @ Tr[:3, :3].T + Tr[:3, 3]

    def query():
        return knn.grid2_query(gh2, tgt, moved, mask)

    query_host_ms = float(np.median(host_ms(query, 3)))
    query_dev_ms = cuda_ms(query, iters=3, warmup=1, queued=True)
    log({"phase": "registration_timing",
         "wall_s": {k: float(np.median(v)) / 1e3 for k, v in wall.items()},
         "wall_s_all": {k: [x / 1e3 for x in v] for k, v in wall.items()},
         "staged_wall_s": sum(split.values()), "split_s": split,
         "icp_iterations": res2.iterations,
         "icp_ms_per_iteration": split["icp"] * 1e3 / max(res2.iterations,
                                                          1),
         "staged_n_down": n_down2, "staged_ransac_fitness": fit2,
         "traced_kernels": prof["kernels"],
         "traced_device_ms": prof["device_ms"], "traced_top": prof["top"],
         "device_launches_K1_K2": device,
         "graph_reserved_bytes": pools, "icp": icp,
         "icp_query_host_ms": query_host_ms,
         "icp_query_device_ms": query_dev_ms, "gpu": gpu_line})
    k4 = check_k4(dev, gpu_line)
    for rec in k4:
        rec["launches"] = counts["grid_query"]
        rec["graph_launches_registration"] = device["grid_query"]
    return records + k4


def check_k4(dev, gpu_line):
    """K4 at the register cell's ICP shapes (K4_N queries, an independent
    sampling of the surface, on a K4_N-point target; the grid at 1.5
    voxel, the voxel 2 % of the AABB diagonal), one record a level: index
    and distance bit-equal to the plain version, CUDA-event ms of both,
    the bound by bytes (queries, mask, target and table read once, index
    and distance written once; the f32 operations' bound logged beside
    it), and K4's ms on the table as built (slots, cells) too. Then one
    compiled ICP (`_icp`, rel_tol 0 so it runs max_iters trips) timed by
    CUDA events at ICP_TRIPS trips: its grid and final query, and a trip.
    Returns the two records."""
    from repas_tpu_torch.cloud import knn, normals
    from repas_tpu_torch.cloud import registration as reg
    from repas_tpu_torch.kernels.grid_query import grid_query

    _, tgt_np, _, _ = bumpy_scene(K4_N)
    _, q_np, _, _ = bumpy_scene(K4_N, seed=REG_SEED + 1)
    tgt = torch.from_numpy(tgt_np).to(dev)
    q = torch.from_numpy(q_np).to(dev)
    mask = torch.ones(K4_N, dtype=torch.bool, device=dev)
    both = torch.cat([tgt, q])
    voxel = max(0.02 * float(torch.linalg.vector_norm(both.amax(0)
                                                      - both.amin(0))),
                1e-3)
    gh2 = knn.grid2_build(tgt, mask, 1.5 * voxel)
    records = []
    for level, gh, dims in (("coarse", gh2.coarse, (64, 64, 64)),
                            ("fine", gh2.fine, (96, 96, 96))):
        def kern(co=gh.cell_of, gh=gh, dims=dims):
            return grid_query(co, gh.origin, gh.cell, tgt, q, mask, dims)

        def plain(gh=gh, dims=dims):
            return knn.grid_hash_query_plain(gh, tgt, q, mask, dims)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        equal = (torch.equal(got[0], want[0])
                 and torch.equal(got[1].view(torch.int32),
                                 want[1].view(torch.int32)))
        if not equal:
            raise AssertionError(f"K4 grid_query ({level}) differs from its "
                                 "plain version")
        slots, cells = gh.cell_of.shape
        nbytes = 12 * K4_N + K4_N + 12 * K4_N + 4 * slots * cells + 8 * K4_N
        # a candidate: 3 subtractions, 3 products, 2 sums
        f32_ops = 8 * 27 * slots * K4_N
        ms = cuda_ms(kern, queued=True)
        as_built = gh.cell_of.contiguous()
        ms_as_built = cuda_ms(lambda: kern(as_built), queued=True)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        rec = record(f"K4 grid_query ({level})", K4_SRC, (0.0, ms, plain_ms),
                     nbytes, 0, F32_OPS_PER_S,
                     "no PyTorch call computes a grid-hash 1-NN; the "
                     "plain version's chunks are the yardstick")
        rec["replaces_note"] = ("no Pallas kernel: the jitted "
                                "grid_hash_query (XLA)")
        rec["bit_equal"] = equal
        rec["ms_table_as_built"] = ms_as_built
        rec["ops_bound_ms"] = f32_ops / F32_OPS_PER_S * 1e3
        log({"kernel": rec["name"], "input_shape": [K4_N, 3],
             "target": [K4_N, 3], "dims": list(dims), "slots": slots,
             "found": int((got[0] >= 0).sum()), "bit_equal": equal,
             "ms": ms, "ms_table_as_built": ms_as_built,
             "plain_ms": plain_ms, "bytes": nbytes,
             "bound_ms": rec["bound_ms"], "f32_ops": f32_ops,
             "ops_bound_ms": rec["ops_bound_ms"], "gpu": gpu_line})
        records.append(rec)

    nrm, _ = normals.estimate_normals_grid(tgt, mask, k=16,
                                           radius=2.0 * voxel)
    trips = {}
    for n in ICP_TRIPS:
        def icp(n=n):
            return reg._icp(q, mask, tgt, mask, nrm, 1.5 * voxel, n, 0.0,
                            None, (64, 64, 64), 4)

        reg._icp.clear()
        it = int(icp()[3])                               # captures
        if it != n:
            raise AssertionError(f"ICP ran {it} trips, not {n}")
        trips[n] = cuda_ms(icp, iters=5, warmup=1, queued=True)
    reg._icp.clear()
    per_trip = float(np.polyfit(list(trips), list(trips.values()), 1)[0])
    log({"phase": "icp_trips", "points": K4_N, "voxel_m": voxel,
         "ms_at_trips": trips, "ms_per_trip": per_trip, "gpu": gpu_line})
    for rec in records:
        rec["icp_ms_at_trips"] = trips
        rec["icp_ms_per_trip"] = per_trip
    return records


def registration_vs_cpu(dev):
    """A 20k-point pair of the same surface: ICP from one T_init, RANSAC on
    one set of picks and the two-level grid query, on the card against
    the CPU port."""
    from repas_tpu_torch.cloud import knn, registration as reg
    from repas_tpu_torch.cloud.filters import (_choice, _generator,
                                               compact_masked,
                                               voxel_downsample)
    from repas_tpu_torch.cloud.fpfh import (_ransac_from_picks,
                                            fpfh_features, match_features)
    from repas_tpu_torch.cloud.normals import estimate_normals_grid
    from repas_tpu_torch.core.transforms import make_T

    src_np, tgt_np, R, t = bumpy_scene(REG_SMALL, seed=1)
    src, tgt = torch.from_numpy(src_np), torch.from_numpy(tgt_np)
    mask = torch.ones(REG_SMALL, dtype=torch.bool)
    voxel = max(0.02 * reg._aabb_diag(src, mask, tgt, mask), 1e-3)
    nrm, _ = estimate_normals_grid(tgt, mask, k=16, radius=2.0 * voxel)

    def both(fn, *args):
        """fn on the CPU tensors and on their copies on the card."""
        return fn(*args), fn(*(a.to(dev) if torch.is_tensor(a) else a
                               for a in args))

    # ICP from the truth moved by 0.6 degrees and 5 mm
    T_init = make_T(rotation(np.array(REG_RV) + [0.01, -0.01, 0.005]),
                    torch.from_numpy(t + np.float32([0.004, -0.003, 0.002]))
                    ).numpy()
    ic, ig = both(lambda *a: reg.icp_point_to_plane(
        *a, max_corr_dist=1.5 * voxel, max_iters=REG_SMALL_ICP_ITERS,
        T_init=T_init), src, mask, tgt, mask, nrm)
    Tc, Tg = ic.T.numpy(), ig.T.cpu().numpy()
    icp = {"t_m": float(np.abs(Tc[:3, 3] - Tg[:3, 3]).max()),
           "R_deg": angle_deg(Tc[:3, :3], Tg[:3, :3]),
           "fitness": abs(float(ic.fitness) - float(ig.fitness)),
           "iterations": [ic.iterations, ig.iterations],
           "t_err_mm": pose_error(Tg, R, t)[0]}
    if icp["t_m"] > 1e-5 or icp["R_deg"] > 1e-3 or icp["fitness"] > 1e-4:
        raise AssertionError(f"ICP on the card vs CPU: {icp}")

    # RANSAC on one set of picks, drawn on the CPU
    clouds = []
    for pts in (src, tgt):
        pd, _, _, md = voxel_downsample(pts, mask, voxel)
        pc, mc, _ = compact_masked(pd, md, REG_CAPACITY)
        n_c, _ = estimate_normals_grid(pc, mc, k=24, radius=2.0 * voxel,
                                       dims=(32, 32, 32), slots=32)
        clouds.append((pc, mc, fpfh_features(pc, n_c, mc, radius=5 * voxel,
                                             k=48, dims=(32, 32, 32),
                                             slots=32)))
    (sp, sm, sf), (tp, tm, tf) = clouds
    corr, _ = match_features(sf, sm, tf, tm)
    gen = _generator("cpu", REG_SEED)
    ok = sm & (corr >= 0)
    picks = _choice(ok, 3 * 8192, True, gen).reshape(8192, 3)
    ev = _choice(ok, 2048, True, gen)
    rc, rg = both(lambda s_, sm_, t_, tm_, c_, p_, e_: _ransac_from_picks(
        s_, sm_, t_, tm_, c_, 2.5 * voxel, 0.9, p_, e_),
        sp, sm, tp, tm, corr, picks, ev)
    ransac = {"best": [int(rc[3]), int(rg[3])],
              "T_max_abs": float((rc[0] - rg[0].cpu()).abs().max()),
              "scores_differ": int((rc[2] != rg[2].cpu()).sum()),
              "fitness": [float(rc[1]), float(rg[1])]}
    if ransac["best"][0] != ransac["best"][1] or ransac["T_max_abs"] > 1e-5:
        raise AssertionError(f"RANSAC on the card vs CPU: {ransac}")

    # the two-level grid query: the source at the truth, 2 mm noise
    q = torch.from_numpy((src_np @ R.T + t + np.random.default_rng(2).normal(
        0, 0.002, src_np.shape)).astype(np.float32))
    gc, gg = both(lambda *a: knn.grid2_query(
        knn.grid2_build(a[0], a[1], 1.5 * voxel), a[0], a[2], a[3]),
        tgt, mask, q, mask)
    nn_c, d_c = gc
    nn_g, d_g = (v.cpu() for v in gg)
    two = torch.cat([torch.topk(torch.cdist(q[s:s + 2000], tgt), 2,
                                largest=False).values
                     for s in range(0, REG_SMALL, 2000)])
    clear = (two[:, 1] - two[:, 0]) > 1e-6
    fin = torch.isfinite(d_c)
    grid = {"nn_differ_where_clear": int((nn_c != nn_g)[clear].sum()),
            "nn_differ": int((nn_c != nn_g).sum()),
            "near_ties": int((~clear).sum()),
            "dist_max_abs": float((d_c - d_g)[fin].abs().max()),
            "finite_equal": bool(torch.equal(fin, torch.isfinite(d_g)))}
    if grid["nn_differ_where_clear"] or grid["dist_max_abs"] > 1e-6 \
            or not grid["finite_equal"]:
        raise AssertionError(f"grid2_query on the card vs CPU: {grid}")
    log({"phase": "registration_vs_cpu", "points": REG_SMALL, "icp": icp,
         "ransac": ransac, "grid2_query": grid})


def capture_phase(dev, gpu_line):
    """The capture side at 720p: create_masked_pointcloud on the bench
    frame on the card (peak memory under 40 GB), then its stages on the
    card against the CPU on one sample each, and the tag-anchored crop
    around the frame's fused pose on both."""
    from repas_tpu_torch import pipeline
    from repas_tpu_torch.cloud.crop import tag_frame_aabb_crop
    from repas_tpu_torch.cloud.filters import (_choice, _generator,
                                               _outlier_mask_from_sample,
                                               voxel_downsample)
    from repas_tpu_torch.cloud.generate import create_masked_pointcloud
    from repas_tpu_torch.cloud.normals import _normals_from_sample
    from repas_tpu_torch.core.config import CropConfig, PipelineConfig
    from repas_tpu_torch.kernels.pointcloud import rgbd_to_pointcloud

    rgbs, depths, K = bench_frames(1)
    rgb = torch.from_numpy(rgbs[0])
    depth = torch.from_numpy(depths[0].astype(np.float32) * np.float32(1e-3))
    Kt = torch.from_numpy(K)
    rgb_d, depth_d, K_d = rgb.to(dev), depth.to(dev), Kt.to(dev)

    # compiled: three steps (core.jit) with the samples drawn between
    # them; the first call captures them
    from repas_tpu_torch.cloud import filters, generate, normals
    from repas_tpu_torch.core.jit import disable_jit

    for step in (generate._back_project, filters._outlier_mask_from_sample,
                 normals._normals_step):
        step.clear()

    def gen():
        return create_masked_pointcloud(rgb_d, depth_d, K_d,
                                        voxel=CAPTURE_VOXEL,
                                        with_normals=True)

    def gen_eager():
        with disable_jit():
            return gen()

    from repas_tpu_torch.kernels import _build

    peaks, ms = {}, {}
    _build.reset_launches()
    for name, fn in (("capture", gen), ("compiled", gen),
                     ("eager", gen_eager)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        if name == "compiled":
            cloud = out
    eager = out
    gen_ms, peak = ms["compiled"], max(peaks.values())
    ve = eager.valid
    both = ve & cloud.valid
    vs_eager = {"valid_differ": int((cloud.valid != ve).sum()),
                "points_max_abs_m": float((cloud.points - eager.points)[
                    both].abs().max()),
                "colors_max_abs": float((cloud.colors - eager.colors)[
                    both].abs().max()),
                "normals_max_abs": float((cloud.normals - eager.normals)[
                    both].abs().max())}
    log({"phase": "capture_720p_compiled", "ms": ms, "peak_mem_bytes": peaks,
         "vs_eager": vs_eager, "valid": int(ve.sum()),
         "launches": {k: v for k, v in _build.launches.items() if v},
         "gpu": gpu_line})
    if vs_eager["valid_differ"] > 1e-3 * int(ve.sum()) or \
            vs_eager["points_max_abs_m"] > 1e-6 or \
            vs_eager["colors_max_abs"] > 1e-6 or \
            vs_eager["normals_max_abs"] > 1e-4:
        raise AssertionError(f"compiled create_masked_pointcloud vs eager: "
                             f"{vs_eager}")
    n_valid = int(cloud.valid.sum())
    # a valid point without 3 neighbours within 2 cm keeps a zero normal;
    # the others face the camera across the plane z = 0.45 m
    has_n = cloud.valid & (torch.linalg.vector_norm(cloud.normals, dim=1)
                           > 0)
    nz = cloud.normals[has_n][:, 2]
    if not (1000 < n_valid < H * W and bool(torch.isfinite(
            cloud.points).all()) and int(has_n.sum()) >= 0.9 * n_valid
            and bool((nz < -0.99).all()) and peak < 40e9):
        raise AssertionError(f"create_masked_pointcloud at 720p: {n_valid} "
                             f"valid, {int(has_n.sum())} with normals, "
                             f"normals z in [{float(nz.min())}, "
                             f"{float(nz.max())}], peak {peak} bytes")

    # the stages on the card against the CPU, one sample for both devices
    def stages(rgb, depth, K):
        pts, cols, valid = rgbd_to_pointcloud(rgb, depth, K, max_depth=10.0,
                                              min_depth=0.0)
        pd, _, _, rep = voxel_downsample(pts, valid, CAPTURE_VOXEL,
                                         colors=cols)
        return pd, rep

    pc, rep_c = stages(rgb, depth, Kt)
    pg, rep_g = (v.cpu() for v in stages(rgb_d, depth_d, K_d))
    both_rep = rep_c & rep_g
    mean_err = float((pc - pg)[both_rep].abs().max())
    idx_o = _choice(rep_c, 2048, False, _generator("cpu", 0))
    ok_c = _outlier_mask_from_sample(pc, rep_c, idx_o, 20, 2.0)
    ok_g = _outlier_mask_from_sample(pg.to(dev), rep_g.to(dev),
                                     idx_o.to(dev), 20, 2.0).cpu()
    outlier_differ = int((ok_c != ok_g).sum())
    idx_n = _choice(ok_c, 4096, False, _generator("cpu", 1))
    n_c, nok_c = _normals_from_sample(pc, ok_c, idx_n, 30, 0.02, None)
    n_g, nok_g = (v.cpu() for v in _normals_from_sample(
        pc.to(dev), ok_c.to(dev), idx_n.to(dev), 30, 0.02, None))
    normals_err = float((n_c - n_g)[nok_c & nok_g].abs().max())

    # the crop around frame 0's fused pose
    out = pipeline.process_frames(rgb_d[None], torch.from_numpy(
        depths[:1]).to(dev), K_d, PipelineConfig())
    R = out.pose.R_avg[0].cpu().numpy()
    t = out.pose.anchor_P_depth[0].cpu().numpy()      # depth-corrected
    box = CropConfig(**{f"d{a}_{s}": CAPTURE_BOX for a in "xyz"
                        for s in ("front", "back")})
    crop_c = tag_frame_aabb_crop(pc, ok_c, R, t, box)[0]
    crop_g = tag_frame_aabb_crop(pg.to(dev), ok_c.to(dev), R, t,
                                 box)[0].cpu()
    res = {"valid_after_generate": n_valid,
           "with_normals": int(has_n.sum()), "generate_ms": gen_ms,
           "peak_mem_bytes": peak, "voxels": int(rep_c.sum()),
           "rep_differ": int((rep_c != rep_g).sum()),
           "voxel_mean_max_abs_m": mean_err,
           "outlier_valid": int(ok_c.sum()),
           "outlier_differ": outlier_differ,
           "normals_ok_differ": int((nok_c != nok_g).sum()),
           "normals_max_abs": normals_err, "crop_kept": int(crop_c.sum()),
           "crop_differ": int((crop_c != crop_g).sum()),
           "fused_t": t.tolist(), "gpu": gpu_line}
    log({"phase": "capture_720p", **res})
    if (res["rep_differ"] or mean_err > 1e-6
            or outlier_differ > 1e-3 * int(ok_c.sum())
            or res["normals_ok_differ"] or normals_err > 1e-4
            or res["crop_differ"] or not 100 < res["crop_kept"]):
        raise AssertionError(f"capture stages on the card vs CPU: {res}")


def registration_phase(dev, gpu_line):
    """The point-cloud registration path and the capture side on the
    card, compiled; returns the records of its kernels, K1, K2 and K4."""
    records = registration_1m(dev, gpu_line)
    registration_vs_cpu(dev)
    capture_phase(dev, gpu_line)
    return records


# --- cad_chain: the CAD-placement and reconstruction path ------------------

def write_png(path, arr, level=6) -> None:
    """A PNG of uint8 gray/RGB or uint16 gray `arr`, filter 0, written with
    the standard library (zlib at `level`, struct): the smoke's inputs do
    not depend on the port's writer or on PIL."""
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    bits = 16 if arr.dtype == np.uint16 else 8
    ctype = 2 if arr.ndim == 3 else 0
    rows = (arr.astype(">u2") if bits == 16 else arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8)], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, level))
                + chunk(b"IEND", b""))


def cad_scene_depth():
    """(H,W) z in metres: the plane z = CAD_Z with CAD_BUMPS toward the
    camera (a fixed point along each pixel's ray)."""
    K = CAD_K.astype(np.float64)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    rx, ry = (u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1]
    z = np.full((H, W), CAD_Z)
    for _ in range(12):
        z = CAD_Z - sum(hgt * np.exp(-((rx * z - bx) ** 2 + (ry * z - by) ** 2)
                                     / (2 * s * s))
                        for bx, by, s, hgt in CAD_BUMPS)
    return z


def cad_scene(d):
    """Writes the capture into directory d: rgb.png (1280x720, tags 9 and
    16 on the plane, tag 9 mounted upside down as the fusion's flip
    expects), depth.png (u16 mm, 0.5 mm noise), K.json (lean schema)."""
    import pathlib

    d = pathlib.Path(d)
    img = np.full((H, W), 180.0, np.float32)
    for tid, (x, y) in CAD_TAGS.items():
        R = np.diag([-1.0, -1.0, 1.0]) if tid == 9 else np.eye(3)
        win = render_window(tid, R, np.array([x, y, CAD_Z]), CAD_K, CAD_TAG,
                            260, supersample=2)
        img = np.where(win != 180.0, win, img)
    write_png(d / "rgb.png", noisy_rgb(img[None], seed=3)[0])
    rng = np.random.default_rng(3)
    depth = cad_scene_depth() + rng.normal(0, 0.0005, (H, W))
    write_png(d / "depth.png", np.round(depth * 1000).astype(np.uint16))
    K = CAD_K
    (d / "K.json").write_text(json.dumps(
        {"fx": float(K[0, 0]), "fy": float(K[1, 1]), "cx": float(K[0, 2]),
         "cy": float(K[1, 2]), "width": W, "height": H}))
    return d


def motion_error(T, placed):
    """(t error mm, R error deg) of a registration T of the moved CAD
    against the inverse of the known motion (CAD_MOVE_RV, CAD_MOVE_T)
    about the placed CAD's centroid."""
    Rm = rotation(CAD_MOVE_RV).astype(np.float64)
    c = np.asarray(placed, np.float64).mean(0)
    back_t = c - Rm.T @ (c + np.asarray(CAD_MOVE_T))
    T = np.asarray(T, np.float64)
    return (float(np.linalg.norm(T[:3, 3] - back_t)) * 1000,
            angle_deg(T[:3, :3], Rm.T))


def nn_dist(a, b, chunk=4096):
    """Distance from each row of a (N,3) to its nearest row of b, on the
    card (a brute-force check, not the port's code)."""
    a = torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    b = torch.as_tensor(np.asarray(b, np.float32), device="cuda")
    return torch.cat([torch.cdist(a[s:s + chunk], b).amin(1)
                      for s in range(0, len(a), chunk)]).cpu().numpy()


def cad_chain_apps(d):
    """The six CLIs on the capture in d, each timed after one warm call,
    with B1's and B2's launches counted around the warm crop_scene and
    place_cad calls, which capture the compiled detector and fusion
    anew (the timed calls replay them). Returns (timings, launches, captured B1/B2 inputs, ICP
    timing, crop meta, placement meta, the crop rows the CAD took)."""
    from repas_tpu_torch.apps import (apply_6dof, crop_scene,
                                      generate_pointcloud, place_cad,
                                      ply_to_stl, refine_icp)
    from repas_tpu_torch.detect.detector import detect_tags_jit
    from repas_tpu_torch.io.meta import read_meta
    from repas_tpu_torch.pose.fusion import fuse_tag_poses_jit
    from repas_tpu_torch.io.ply import (PointCloud, read_geometry, write_ply,
                                        write_stl)
    from repas_tpu_torch.io.pose_txt import save_transform_txt
    from repas_tpu_torch.kernels import _build, ccl_cuda, patch_extract

    src = ["--color", str(d / "rgb.png"), "--depth", str(d / "depth.png"),
           "--intrinsics", str(d / "K.json")]
    ms, launches, icp_calls = {}, {}, []

    def run(name, app, argv, counted=False):
        if counted:
            detect_tags_jit.clear()
            fuse_tag_poses_jit.clear()
        torch.cuda.synchronize()
        _build.reset_launches()
        app.main(argv)                                        # warm
        torch.cuda.synchronize()
        if counted:
            launches[name] = {k: _build.launches[k]
                              for k in ("ccl", "patch_extract")}
        t0 = time.perf_counter()
        app.main(argv)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3

    run("generate_pointcloud", generate_pointcloud,
        src + ["--out", str(d / "scene.ply"), "--voxel", "0.005",
               "--normals"])
    with Capture(ccl_cuda, "connected_components_cuda") as c1, \
            Capture(patch_extract, "extract_windows") as c2:
        crop_scene.main(src + ["--out", str(d / "crop.ply"),
                               "--tag-size", str(CAD_TAG), *CAD_CROP])
        torch.cuda.synchronize()
    captured = (c1.args, c2.args)
    run("crop_scene", crop_scene, src + ["--out", str(d / "crop.ply"),
                                         "--tag-size", str(CAD_TAG),
                                         *CAD_CROP], counted=True)
    crop = read_geometry(d / "crop.ply")
    cmeta = read_meta(d / "crop.meta.json")

    # the CAD: the crop mapped into tag 16's frame in mm, subsampled
    R = np.asarray(cmeta["R_anchor"], np.float64)
    P = np.asarray(cmeta["anchor_P_depth"], np.float64)
    pts = np.asarray(crop.points, np.float64)
    sel = np.arange(len(pts))[::max(1, len(pts) // CAD_POINTS)]
    write_ply(d / "cad.ply", PointCloud(points=((pts[sel] - P) @ R / 0.001
                                                ).astype(np.float32)))
    orig = place_cad.refine_with_icp

    def timed_icp(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep, T = orig(*a, **k)
        icp_calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "iterations": rep["iterations"]})
        return rep, T

    place_cad.refine_with_icp = timed_icp
    try:
        run("place_cad", place_cad,
            src + ["--cad", str(d / "cad.ply"), "--out",
                   str(d / "placed.ply"), "--tag-size", str(CAD_TAG),
                   "--tag-ids", "16", "--icp"], counted=True)
    finally:
        place_cad.refine_with_icp = orig
    pmeta = read_meta(d / "placed.meta.json")

    # ply_to_stl on the crop: warm with the default, then each method
    ply_to_stl.main([str(d / "crop.ply"), str(d / "warm.stl")])
    for name, extra in (("poisson_128", ["--dim", "128"]),
                        ("poisson_256", ["--dim", "256"]),
                        ("alpha", ["--method", "alpha"]),
                        ("bpa", ["--method", "bpa"])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ply_to_stl.main([str(d / "crop.ply"), str(d / f"{name}.stl"),
                         *extra])
        torch.cuda.synchronize()
        ms[f"ply_to_stl_{name}"] = (time.perf_counter() - t0) * 1e3

    # apply_6dof: the alpha mesh in the tag frame (mm) as the CAD, the
    # placement as the pose (T_cad_world @ diag(1000): the tag's pose)
    mesh = read_geometry(d / "alpha.stl")
    mesh.vertices = (mesh.vertices - P) @ R / 0.001
    write_stl(d / "alpha_cad.stl", mesh)
    save_transform_txt(d / "pose.txt", np.asarray(pmeta["T_cad_world"])
                       @ np.diag([1000.0, 1000.0, 1000.0, 1.0]))
    run("apply_6dof", apply_6dof,
        ["--pose", str(d / "pose.txt"), "--cad", str(d / "alpha_cad.stl"),
         "--out", str(d / "posed.ply"), "--icp", "--scene",
         str(d / "crop.ply")])

    # refine_icp --global: the placed CAD moved by a known motion about its
    # centroid, registered back onto the crop
    placed = read_geometry(d / "placed.ply").points
    Rm = rotation(CAD_MOVE_RV).astype(np.float64)
    c = placed.mean(0)
    write_ply(d / "moved.ply", PointCloud(points=(placed - c) @ Rm.T + c
                                          + CAD_MOVE_T))
    run("refine_icp", refine_icp,
        ["--source", str(d / "moved.ply"), "--target", str(d / "crop.ply"),
         "--out", str(d / "registered.ply"), "--json", str(d / "reg.json"),
         "--global"])
    return ms, launches, captured, icp_calls, cmeta, pmeta, sel


def cad_chain_vs_cpu(d, dev):
    """Card against the port on the CPU on the chain's own data: the
    Poisson grid at dim 128, refine_with_icp fed one normals sample, and
    ball pivoting's face set."""
    from repas_tpu_torch.cloud import cad, reconstruct
    from repas_tpu_torch.cloud.filters import _choice, _generator
    from repas_tpu_torch.cloud.normals import (_normals_from_sample,
                                               estimate_normals)
    from repas_tpu_torch.core.config import ICPConfig
    from repas_tpu_torch.io.ply import PointCloud, read_geometry

    pts = np.asarray(read_geometry(d / "crop.ply").points, np.float32)
    ones = torch.ones(len(pts), dtype=torch.bool, device=dev)
    nrm, _ = estimate_normals(torch.from_numpy(pts).to(dev), ones,
                              camera=pts.mean(0) - [0, 0, 1.0])
    lo, hi = pts.min(0), pts.max(0)
    span = float((hi - lo).max()) * 1.2
    lo, cell = (lo + hi) / 2 - span / 2, span / 128
    args = (torch.from_numpy(pts), nrm.cpu(), ones.cpu())
    cc = reconstruct.poisson_indicator_grid(*args, lo, cell, dim=128)
    cg = reconstruct.poisson_indicator_grid(*(a.to(dev) for a in args), lo,
                                            cell, dim=128).cpu()
    # a grid value within rounding of 0 may change sign: reported only
    chi_rel = float((cc - cg).abs().max() / cc.abs().max())
    chi_flips = int(((cc > 0) != (cg > 0)).sum())

    # refine_with_icp, both devices on one normals sample
    placed = read_geometry(d / "placed.ply").points
    fixed = {}

    def one_sample(p, mask, k=30, radius=0.02, **_):
        if "idx" not in fixed:
            fixed["idx"] = _choice(mask.cpu(), min(4096, len(mask)), False,
                                   _generator("cpu", 1))
        return _normals_from_sample(p, mask, fixed["idx"].to(p.device), k,
                                    radius, None)

    # a fixed count of iterations (rel_tol 0): near its fixed point ICP
    # may cycle between correspondence sets at rounding level, and the
    # two devices would stop on different steps of the cycle
    cfg = ICPConfig(cad_samples=CAD_VS_CPU_SAMPLES, rel_tol=0.0,
                    max_iters=CAD_VS_CPU_ICP_ITERS)
    cad_pc = PointCloud(points=placed + [0.002, -0.0015, 0.001])
    orig = cad.estimate_normals
    cad.estimate_normals = one_sample
    try:
        rc, Tc = cad.refine_with_icp(cad_pc, PointCloud(points=pts), cfg,
                                     device="cpu")
        rg, Tg = cad.refine_with_icp(cad_pc, PointCloud(points=pts), cfg,
                                     device=dev)
    finally:
        cad.estimate_normals = orig
    icp = {"t_m": float(np.abs(Tc[:3, 3] - Tg[:3, 3]).max()),
           "R_deg": angle_deg(Tc[:3, :3], Tg[:3, :3]),
           "fitness": abs(rc["fitness"] - rg["fitness"]),
           "iterations": [rc["iterations"], rg["iterations"]]}

    sub = PointCloud(points=pts[::CAD_BPA_STRIDE])
    bc = reconstruct.ball_pivot(sub, device="cpu")
    bg = reconstruct.ball_pivot(sub, device=dev)
    bpa = {"points": len(sub), "faces": [len(bc.triangles),
                                         len(bg.triangles)],
           "equal": bool(np.array_equal(bc.triangles, bg.triangles))}
    out = {"poisson_128": {"max_abs_rel": chi_rel, "sign_flips": chi_flips},
           "refine_with_icp": icp, "ball_pivot": bpa}
    log({"phase": "cad_chain_vs_cpu", **out})
    if chi_rel > 1e-5 or icp["t_m"] > CAD_ICP_T_M \
            or icp["R_deg"] > CAD_ICP_R_DEG or icp["fitness"] > 1e-6 \
            or not bpa["equal"]:
        raise AssertionError(f"cad_chain on the card vs CPU: {out}")
    return pts, nrm, lo, cell


def cad_chain_phase(dev, gpu_line, keep=None):
    """The CAD-placement and reconstruction path (the port's six CLIs,
    in-process, on the card) on one 1280x720 capture; returns the kernel
    records of B1 and B2 at the chain's shapes."""
    import pathlib
    import shutil
    import tempfile

    from repas_tpu_torch.cloud import reconstruct
    from repas_tpu_torch.io import native
    from repas_tpu_torch.io.meta import read_meta
    from repas_tpu_torch.io.ply import read_geometry
    from repas_tpu_torch.io.image import read_image

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = cad_scene(pathlib.Path(tmp))
        # read_image takes the native codec where it decodes the file
        codec = ("native library" if native.read_png(d / "rgb.png")
                 is not None else "PIL")
        rgb = read_image(d / "rgb.png")
        log({"phase": "cad_chain_codec", "png_codec": codec,
             "library_build_error": native.build_error,
             "pil_importable": importlib.util.find_spec("PIL") is not None,
             "rgb_shape": list(rgb.shape)})
        ms, launches, captured, icp_calls, cmeta, pmeta, sel = \
            cad_chain_apps(d)

        # B1 and B2 at the chain's shapes, exact against their plain twins
        b1_args, _ = captured[0]
        (pyr, origins, ah, aw), kw = captured[1]
        recs = [check_b1(f"B1 ccl (cad_chain {tuple(b1_args[0].shape)})",
                         *b1_args),
                check_b2(f"B2 patch_extract (cad_chain {tuple(pyr.shape)}, "
                         f"{ah}x{aw} windows)", pyr, origins, ah, aw, **kw)]
        for rec in recs:
            key = "ccl" if rec["name"][:2] == "B1" else "patch_extract"
            rec["launches"] = sum(v[key] for v in launches.values())
            rec["launches_per_app"] = {k: v[key] for k, v in
                                       launches.items()}
        low = {k: v for k, v in launches.items()
               if v["ccl"] < 1 or v["patch_extract"] < 1}
        if low:
            raise AssertionError(f"B1/B2 not launched by {low}")

        # gates
        crop = np.asarray(read_geometry(d / "crop.ply").points, np.float64)
        placed = np.asarray(read_geometry(d / "placed.ply").points)
        d_place = np.linalg.norm(placed - crop[sel], axis=1)
        icp = pmeta["icp"]
        kinds = {n: read_meta(d / f"{n}.meta.json")["kind"] for n in
                 ("scene", "crop", "placed", "poisson_128", "alpha", "bpa",
                  "posed", "registered")}
        want = {"scene": "capture", "crop": "crop", "placed": "cad_transform",
                "poisson_128": "stl", "alpha": "stl", "bpa": "stl",
                "posed": "cad_transform", "registered": "cad_transform"}
        stl = {}
        for name in ("poisson_128", "poisson_256", "alpha", "bpa"):
            m = read_geometry(d / f"{name}.stl")
            stl[name] = {"vertices": len(m.vertices),
                         "triangles": len(m.triangles)}
            if name.startswith("poisson"):
                # the crop lies on the closed Poisson surface: each crop
                # point within cells of a mesh vertex
                dim = int(name.split("_")[1])
                cell_m = float((crop.max(0) - crop.min(0)).max()) * 1.2 / dim
                dist = nn_dist(crop[::4], m.vertices)
                stl[name]["crop_to_mesh_median_cells"] = float(
                    np.median(dist) / cell_m)
                stl[name]["crop_to_mesh_p99_cells"] = float(
                    np.percentile(dist, 99) / cell_m)
        reg = json.loads((d / "reg.json").read_text())
        t_mm, r_deg = motion_error(reg["T_total"], placed)
        reg_err = {"t_mm": t_mm, "R_deg": r_deg,
                   "global_fitness": reg["global"]["fitness"],
                   "icp_fitness": reg["icp"]["fitness"]}
        posed = read_meta(d / "posed.meta.json")["icp"]
        out = {"phase": "cad_chain", "crop_points": len(crop),
               "cad_points": len(sel), "place_median_mm":
               float(np.median(d_place)) * 1000,
               "place_p95_mm": float(np.percentile(d_place, 95)) * 1000,
               "place_icp": icp, "apply_6dof_icp": posed,
               "refine_icp": reg_err, "stl": stl, "kinds": kinds,
               "app_ms": ms, "launches": launches,
               "refine_with_icp": icp_calls[-1],
               "tag_ids": cmeta["tag_ids"],
               "anchor_P_depth": cmeta["anchor_P_depth"], "gpu": gpu_line}

        log(out)
        fails = []
        if not np.median(d_place) < 0.005:
            fails.append("placed CAD over 5 mm from the crop")
        if not (icp["fitness"] > 0.9 and icp["delta_rotation_deg"] < 1.0
                and icp["delta_translation_mm"] < 5.0):
            fails.append("place_cad ICP")
        if kinds != want:
            fails.append(f"sidecar kinds {kinds}")
        if any(v["triangles"] < 100 for v in stl.values()):
            fails.append("an STL under 100 triangles")
        if any(stl[n]["crop_to_mesh_median_cells"] > 1.0
               for n in ("poisson_128", "poisson_256")):
            fails.append("a Poisson mesh away from the crop")
        if not (reg_err["t_mm"] < CAD_REG_T_MM
                and reg_err["R_deg"] < CAD_REG_R_DEG):
            fails.append("refine_icp --global missed the known motion")
        if sorted(cmeta["tag_ids"]) != [9, 16]:
            fails.append(f"crop_scene tag ids {cmeta['tag_ids']}")
        if fails:
            raise AssertionError(f"cad_chain: {fails}")

        pts, nrm, lo, cell = cad_chain_vs_cpu(d, dev)
        timing = {"phase": "cad_chain_timing"}
        args = (torch.from_numpy(pts).to(dev), nrm,
                torch.ones(len(pts), dtype=torch.bool, device=dev))
        for dim in (128, 256):
            timing[f"poisson_grid_ms_{dim}"] = cuda_ms(
                lambda: reconstruct.poisson_indicator_grid(
                    *args, lo, cell * 128 / dim, dim=dim), iters=3,
                warmup=1)
        timing["phase_s"] = time.perf_counter() - t_phase
        timing["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        timing["gpu"] = gpu_line
        log(timing)
        if keep:                  # the clouds and sidecars, not the meshes
            shutil.copytree(d, keep, dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("*.stl", "*.png"))
    return recs


# --- canopy_calib_eval: plant height, checkerboard calibration, surface
# error (no kernel of their own) -------------------------------------------

def canopy_scene():
    """rgb (H,W,3) u8, depth u16 mm, the tip's pixel (2,) and the truth
    height in m (see CANOPY_*)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    rgb = rng.normal(120, 3, (H, W, 3))
    yb, half = 560.0, 4.0
    yc = yb + np.tan(np.deg2rad(CANOPY_ANGLE)) * (xx - W / 2)
    bar = (np.abs(yy - yc) <= half) & (xx >= 0.05 * W) & (xx <= 0.95 * W)
    rgb[bar] = 235 + rng.normal(0, 3, (bar.sum(), 3))
    cx, cy, ax, ay = 0.5 * W, 330.0, 150.0, 110.0
    body = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 < 1.0
    top = cy - ay
    tip = (np.abs(xx - (cx + 0.5)) <= 1.0) & (yy >= top - 24) & (yy <= top + 2)
    plant = body | tip
    rgb[plant] = [45, 165, 55] + rng.normal(0, 4, (plant.sum(), 3))
    rgb = np.clip(np.round(rgb), 0, 255).astype(np.uint8)
    near = plant | bar
    grown = near.copy()
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            grown |= np.roll(np.roll(near, dy, 0), dx, 1)
    depth = (np.where(grown, CANOPY_Z, CANOPY_Z + 2.0)
             + rng.normal(0, 0.002, (H, W)))
    tip_y = float(np.where(plant.any(1))[0][0])
    tip_x = float(np.median(np.where(plant[int(tip_y)])[0]))
    height = (yb - half - 0.5 - tip_y) * CANOPY_Z / float(ROBUST_K[1, 1])
    return (rgb, np.round(depth * 1000).astype(np.uint16),
            np.array([tip_x, tip_y]), height)


def host_and_device_ms(fn):
    """One call of fn: (host-clock ms around it and a synchronise, CUDA
    event ms around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def profiled_kernels(fn):
    """The device kernels' events of one call of fn under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def traced(fn, durations=False):
    """fn() under torch.profiler with every launch count set to 0 just
    before it: (its output, the wrappers' counts read just after, {B1-B3
    key: that kernel's device launches in the trace}, the device kernels'
    names[, with `durations` their device ns]). A wrapper counts the
    launches it makes; a replayed graph's launches show only in the
    trace."""
    from torch.profiler import ProfilerActivity, profile

    from repas_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the trace drops device events stamped before its window opened
        # (seen on the H100: a replay's first 100-340 kernels, now and
        # then): start fn's work well inside the window
        time.sleep(TRACE_MARGIN_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    counts = dict(_build.launches)
    # the raw events: building prof.events()' tree costs seconds a trace
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    names = [e.name() for e in events]
    device = {k: sum(v in n for n in names) for k, v in KERNEL_NAMES.items()}
    TRACED_S[0] += time.perf_counter() - t0
    if durations:
        return out, counts, device, names, [e.duration_ns() for e in events]
    return out, counts, device, names


def replays_traced(fn, what):
    """REPLAYS calls of a compiled step fn traced: each must be a replay
    (no wrapper launches) running B1-B3 once each on the device. Returns
    ({key: device launches}, {key: the kernels' names})."""
    _, counts, device, names = traced(lambda: [fn() for _ in range(REPLAYS)])
    if any(counts.values()) or \
            device != {k: REPLAYS for k in PIPELINE_KEYS}:
        raise AssertionError(f"{what}: {REPLAYS} replays launched {device} "
                             f"on the device, wrappers {counts}")
    seen = {k: sorted({n[:60] for n in names if v in n})
            for k, v in KERNEL_NAMES.items()}
    return device, seen


def device_profile(fn, top=5):
    """One call of fn under torch.profiler: the number of device kernels,
    their summed device ms, and the `top` kernels by device ms (names
    shortened); a window with no device events reports zeros."""
    kern = profiled_kernels(fn)
    by_name = {}
    for e in kern:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            e.device_time / 1e3
    return {"kernels": len(kern),
            "device_ms": sum(e.device_time for e in kern) / 1e3,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


# --- compiled leaves: the JAX package's leaf jax.jit functions as captured
# graphs (canopy pieces, reports, renderer, front end, detector_pose) ----
LEAF_TURNS = 5                 # compiled and eager calls of a leaf, in turns
REPORT_TURNS = 2               # the same for the seconds-long reports
INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
               8: torch.int64}


def tree_tensors(x):
    """Every tensor of an output tree (tensors, tuples, NamedTuples), in
    order."""
    if torch.is_tensor(x):
        return [x]
    return [t for v in x for t in tree_tensors(v)]


def bit_equal(got, want) -> bool:
    """Whether two output trees hold the same tensors bit for bit."""
    a, b = tree_tensors(got), tree_tensors(want)

    def bits(t):
        t = t.detach().contiguous()
        return t.view(INT_OF_SIZE[t.element_size()]) \
            if t.is_floating_point() else t

    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


@contextlib.contextmanager
def timed_captures():
    """{step name: [seconds of each capture made inside: the eager
    warm-up, the recording and the graph's instantiation]}."""
    from repas_tpu_torch.core import jit as jit_module

    orig = jit_module.Jitted._capture
    secs = {}

    def capture(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return orig(self, *args, **kwargs)
        finally:
            torch.cuda.synchronize()
            secs.setdefault(self.name, []).append(time.perf_counter() - t0)

    jit_module.Jitted._capture = capture
    try:
        yield secs
    finally:
        jit_module.Jitted._capture = orig


def trace_kernels(fn, top=4):
    """One call of fn traced (see `traced`): (its output, {its device
    kernels, their summed device ms, the copies and fills among the
    device events, the `top` kernels by device ms (names shortened)}),
    from the trace's raw events. The launch counts go on from where they
    were (a phase's counts stay whole)."""
    from repas_tpu_torch.kernels import _build

    before = dict(_build.launches)
    out, counts, _, names, ns = traced(fn, durations=True)
    for k, v in before.items():
        _build.launches[k] = v + counts[k]
    by_name = {}
    kern = [(n, d) for n, d in zip(names, ns)
            if not n.startswith(("Memcpy", "Memset"))]
    for n, d in kern:
        by_name[n[:60]] = by_name.get(n[:60], 0.0) + d / 1e6
    return out, {"kernels": len(kern),
                 "device_ms": sum(d for _, d in kern) / 1e6,
                 "copies_and_fills": len(names) - len(kern),
                 "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


def spread(ms):
    """Median, minimum and maximum of a list of ms."""
    return {"median": float(np.median(ms)), "min": float(min(ms)),
            "max": float(max(ms)), "n": len(ms)}


def turns(fns, reps):
    """Each fn of {name: fn} called in turn `reps` times, each call
    synchronized: ({name: {"host": spread of host-clock ms, "events":
    spread of CUDA-event ms}}, {name: the output of its first call})."""
    host = {k: [] for k in fns}
    events = {k: [] for k in fns}
    first = {}
    for _ in range(reps):
        for k, fn in fns.items():
            h, e = host_and_device_ms(lambda: first.setdefault(k, fn()))
            host[k].append(h)
            events[k].append(e)
    return {k: {"host": spread(host[k]), "events": spread(events[k])}
            for k in fns}, first


def compiled_leaf(what, steps, call, reps=LEAF_TURNS, eager_trace=True):
    """`call()` runs the compiled steps [(name, core.jit.Jitted)] on the
    card. Clears their graphs, then: the capturing call (its seconds, each
    graph's capture seconds, nodes and reserved bytes); a traced call in
    which every replay raises on a synchronizing CUDA call, every step
    replayed and no graph captured (its kernels and device ms); with
    `eager_trace`, the same call with every step eager
    (core.jit.disable_jit) traced; compiled and eager ms in turns; the
    compiled outputs bit-equal to the eager ones. Returns (the compiled
    output, the summary)."""
    from repas_tpu_torch.core.jit import disable_jit

    def eager():
        with disable_jit():
            return call()

    for _, step in steps:
        step.clear()
    with timed_captures() as caps:
        first_s = host_ms(call, 1)[0] / 1e3
    graphs = {name: len(step.graphs) for name, step in steps}
    with strict_replays() as replays:
        (got, syncs), replay_trace = trace_kernels(lambda: syncs_of(call))
    if replays[0] < len(steps) or \
            {name: len(step.graphs) for name, step in steps} != graphs:
        raise AssertionError(f"{what}: {replays[0]} replays for "
                             f"{len(steps)} steps, graphs {graphs}")
    nbytes = graph_bytes(steps)
    out = {"first_call_s": first_s, "replays_per_call": replays[0],
           "sync_calls_around_replays": len(syncs),
           "sync_messages": sorted(set(syncs))[:4],
           "graphs": {name: {
               "graphs": len(step.graphs),
               "capture_s": caps.get(step.name, []),
               "nodes": [e.nodes for e in step.graphs.values()],
               "reserved_bytes": nbytes[name]} for name, step in steps},
           "replay_trace": replay_trace}
    want = None
    if eager_trace:
        want, out["eager_trace"] = trace_kernels(eager)
    out["ms"], firsts = turns({"compiled": call, "eager": eager}, reps)
    if want is None:
        want = firsts["eager"]
    if not bit_equal(got, want):
        raise AssertionError(f"{what}: the compiled outputs differ from "
                             "the eager ones")
    out["bit_equal"] = True
    return got, out


def canopy_compiled(args):
    """measure_plant_height's compiled pieces (canny_edges,
    hough_horizontal_bar, refine_plant_mask: a graph each) against the
    eager call (compiled_leaf), each piece's replay traced alone on the
    inputs the call gave it, and the share of a compiled call's kernels
    that the three graphs hold."""
    from repas_tpu_torch.canopy import bar, measure_plant_height, segment

    height = importlib.import_module("repas_tpu_torch.canopy.height")
    steps = [("canny_edges", bar.canny_edges),
             ("hough_horizontal_bar", bar.hough_horizontal_bar),
             ("refine_plant_mask", segment.refine_plant_mask)]
    _, out = compiled_leaf("canopy", steps,
                           lambda: measure_plant_height(*args))
    with Capture(bar, "canny_edges") as c1, \
            Capture(bar, "hough_horizontal_bar") as c2, \
            Capture(height, "refine_plant_mask") as c3:
        measure_plant_height(*args)
    pieces = {}
    for (name, step), c in zip(steps, (c1, c2, c3)):
        a, kw = c.args
        pieces[name] = trace_kernels(lambda: step(*a, **kw))[1]
    total = out["replay_trace"]["kernels"]
    out["pieces_replay_traces"] = pieces
    out["graph_kernel_share"] = sum(v["kernels"] for v in
                                    pieces.values()) / max(total, 1)
    return out


def canopy_part(d, dev, gpu_line):
    """measure_plant_height at 720p on the card: its compiled pieces
    against the eager call, gates, card vs CPU, times, synchronising
    calls; then detect_canopy.main on PNGs of the scene."""
    from repas_tpu_torch.apps import detect_canopy
    from repas_tpu_torch.canopy import measure_plant_height

    rgb, d16, tip, truth = canopy_scene()
    depth = d16.astype(np.float32) / 1000.0
    K = ROBUST_K
    args = (torch.from_numpy(rgb).to(dev), torch.from_numpy(depth).to(dev),
            torch.from_numpy(K).to(dev))
    compiled = canopy_compiled(args)        # captures the pieces' graphs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = measure_plant_height(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sync_warnings(caught)
    ms = host_ms(lambda: measure_plant_height(*args), CANOPY_REPS)
    ev_ms = cuda_ms(lambda: measure_plant_height(*args), iters=CANOPY_REPS,
                    warmup=1)
    prof = device_profile(lambda: measure_plant_height(*args))
    cpu = measure_plant_height(torch.from_numpy(rgb),
                               torch.from_numpy(depth), K)
    got = {k: v.cpu().numpy() for k, v in res._asdict().items()}
    height = float(got["plant_height_m"])
    out = {"phase": "canopy", "height": H, "width": W,
           "found": bool(got["found"]), "height_m": height,
           "truth_height_m": truth, "height_err_mm": (height - truth) * 1e3,
           "canopy_px": got["canopy_px"].tolist(), "tip_px": tip.tolist(),
           "bar_px": got["bar_px"].tolist(),
           "rotation_deg": float(got["rotation_deg"]),
           "bar_z_m": float(got["bar_3d"][2]),
           "canopy_z_m": float(got["canopy_3d"][2]),
           "vs_cpu": {"canopy_px_equal": bool(np.array_equal(
               got["canopy_px"], cpu.canopy_px.numpy())),
               "bar_px_equal": bool(np.array_equal(got["bar_px"],
                                                   cpu.bar_px.numpy())),
               "found_equal": bool(got["found"]) == bool(cpu.found),
               "height_m": abs(height - float(cpu.plant_height_m))},
           "sync_calls": len(syncs), "sync_messages": syncs[:3],
           "ms_median": float(np.median(ms)), "ms_all": ms,
           "ms_cuda_events": ev_ms, "profile": prof, "compiled": compiled,
           "gpu": gpu_line}
    log(out)
    fails = []
    if syncs or compiled["sync_calls_around_replays"]:
        fails.append(f"{len(syncs)} synchronising calls, "
                     f"{compiled['sync_calls_around_replays']} around the "
                     "pieces' replays")
    if not out["found"]:
        fails.append("not found")
    if not abs(height - truth) < 0.005:
        fails.append(f"height {height} vs truth {truth}")
    if not np.abs(got["canopy_px"] - tip).max() <= 1.5:
        fails.append(f"canopy_px {got['canopy_px']} vs tip {tip}")
    v = out["vs_cpu"]
    if not (v["canopy_px_equal"] and v["bar_px_equal"] and v["found_equal"]
            and v["height_m"] < 1e-5):
        fails.append(f"card vs CPU {v}")
    if fails:
        raise AssertionError(f"canopy: {fails}")

    write_png(d / "canopy_rgb.png", rgb)
    write_png(d / "canopy_depth.png", d16)
    t0 = time.perf_counter()
    app = detect_canopy.main(["--color", str(d / "canopy_rgb.png"),
                              "--depth", str(d / "canopy_depth.png"),
                              "--fx", str(K[0, 0]), "--fy", str(K[1, 1]),
                              "--cx", str(K[0, 2]), "--cy", str(K[1, 2]),
                              "--out-txt", str(d / "camera_z.txt"),
                              "--json", str(d / "canopy.json"),
                              "--device", "cuda"])
    app_s = time.perf_counter() - t0
    log({"phase": "canopy_app", "plant_height_m": app["plant_height_m"],
         "out_txt": (d / "camera_z.txt").read_text(), "app_s": app_s})
    if abs(app["plant_height_m"] - height) > 1e-6:
        raise AssertionError("detect_canopy disagrees with the direct call")
    return out


def _rot_xyz(tilt, yaw, roll):
    """Rotation: roll about z after tilt about x after yaw about y
    (degrees)."""
    def R(axis, a):
        c, s_ = np.cos(np.radians(a)), np.sin(np.radians(a))
        i, j = [k for k in range(3) if k != axis]
        m = np.eye(3)
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s_, s_, c
        return m
    return R(2, roll) @ R(0, tilt) @ R(1, yaw)


def render_board(R, t, seed, dev, ss=2, blur=0.9, noise=1.5):
    """A 1280x720 view of the CAL_N x CAL_N-corner board through CAL_K and
    CAL_DIST, rendered on the card in float64: each supersample's ray is
    undistorted (20 fixed-point steps), met with the board plane and
    shaded (dark squares 45, light 205, white surround); then box
    averaged, blurred, noised and quantised. Returns (H,W) float32 on the
    card."""
    f64 = dict(dtype=torch.float64, device=dev)
    K = CAL_K
    u = (torch.arange(W * ss, **f64) + 0.5) / ss - 0.5
    v = (torch.arange(H * ss, **f64) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    x0, y0 = (uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1]
    k1, k2, p1, p2, k3 = CAL_DIST
    x, y = x0.clone(), y0.clone()
    for _ in range(20):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) / rad, (y0 - dy) / rad
    Minv = torch.linalg.inv(torch.tensor(np.column_stack(
        [R[:, 0], R[:, 1], t]), **f64))
    b = Minv @ torch.stack([x.reshape(-1), y.reshape(-1),
                            torch.ones_like(x).reshape(-1)])
    X, Y = b[0] / b[2], b[1] / b[2]
    i, j = torch.floor(X / CAL_SQUARE), torch.floor(Y / CAL_SQUARE)
    inside = (i >= 0) & (i <= CAL_N) & (j >= 0) & (j <= CAL_N) & (b[2] > 0)
    img = torch.where((torch.remainder(i + j, 2) == 0) & inside, 45.0, 205.0)
    img = img.to(torch.float64).reshape(H, ss, W, ss).mean((1, 3))
    r = int(3 * blur + 0.5)
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, **f64) / blur) ** 2)
    k = (k / k.sum()).reshape(1, 1, 1, -1)
    img = torch.nn.functional.conv2d(torch.nn.functional.pad(
        img[None, None], (r, r, 0, 0), mode="replicate"), k)
    img = torch.nn.functional.conv2d(torch.nn.functional.pad(
        img, (0, 0, r, r), mode="replicate"), k.transpose(-1, -2))[0, 0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    img = img + noise * torch.randn(img.shape, generator=gen, **f64)
    return torch.floor(torch.clamp(img, 0, 255)).to(torch.float32)


def board_views():
    """CAL_VIEWS board poses (R, t): tilted 10-40 degrees, yawed +-30,
    rolled +-12, 0.42-0.55 m away, moved about the image so the corners
    reach its borders; the whole board inside the frame."""
    from repas_tpu_torch.kernels.project import project_points

    rng = np.random.default_rng(11)
    c = np.array([(CAL_N + 1) * CAL_SQUARE / 2] * 2 + [0.0])
    outline = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.0]]) \
        * (CAL_N + 1) * CAL_SQUARE
    poses = []
    while len(poses) < CAL_VIEWS:
        R = _rot_xyz(rng.uniform(10, 40) * rng.choice([-1, 1]),
                     rng.uniform(-30, 30), rng.uniform(-12, 12))
        t = np.array([rng.uniform(-0.06, 0.06), rng.uniform(-0.04, 0.04),
                      rng.uniform(0.42, 0.55)]) - R @ c
        uv = project_points(torch.tensor(outline), torch.tensor(R),
                            torch.tensor(t), torch.tensor(CAL_K),
                            torch.tensor(CAL_DIST)).numpy()
        if (uv.min(0) > 12).all() and (uv.max(0) < [W - 12, H - 12]).all():
            poses.append((R, t))
    return poses


def calibration_vs_eager(img, objs, corners, result, dev):
    """The compiled calibration (refine_corners_subpix and the LM's step,
    each a captured graph) against its plain functions: the sub-pixel
    corners of one view and (K, dist, rms) bit-equal; the LM's seconds
    each, and the compiled LM's synchronizing calls at 5 and 100 steps
    (equal: a replayed step reads nothing on the host)."""
    from repas_tpu_torch.calib import (calibrate_camera, checkerboard,
                                       detect_checkerboard_corners,
                                       refine_corners_subpix)

    c = detect_checkerboard_corners(img, CAL_N, CAL_N)[0]
    sub = refine_corners_subpix(img, c)
    if not torch.equal(sub, refine_corners_subpix.fn(img, c)):
        raise AssertionError("compiled refine_corners_subpix differs from "
                             "its plain function")
    with eager_steps((checkerboard, "_lm_step")):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eager = calibrate_camera(objs, corners, (W, H), device=dev)
        eager_s = time.perf_counter() - t
    if not (np.array_equal(eager[0], result[0])
            and np.array_equal(eager[1], result[1])
            and eager[2] == result[2]):
        raise AssertionError(f"calibration compiled {result[:3]} vs eager "
                             f"{eager[:3]}")
    syncs = {}
    for iters in (5, 100):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                calibrate_camera(objs, corners, (W, H), iters=iters,
                                 device=dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[iters] = len(sync_warnings(caught))
    if syncs[5] != syncs[100]:
        raise AssertionError(f"the compiled LM synchronizes per step: "
                             f"{syncs}")
    return {"bit_equal": True, "eager_lm_s": eager_s,
            "lm_graphs": len(checkerboard._lm_step.graphs),
            "syncs_at_5_and_100_steps": list(syncs.values())}


def calibration_part(d, dev, gpu_line):
    """The reference's board in 20 views on the card: detection, sub-pixel
    refinement, calibrate_camera; gates; two views against the CPU; then
    calibrate.main on PNGs of the views."""
    from repas_tpu_torch.apps import calibrate
    from repas_tpu_torch.calib import (calibrate_camera,
                                       detect_checkerboard_corners,
                                       refine_corners_subpix)

    poses = board_views()
    t0 = time.perf_counter()
    imgs = [render_board(R, t, i, dev) for i, (R, t) in enumerate(poses)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    n = CAL_N
    xx, yy = np.meshgrid(np.arange(n), np.arange(n))
    obj = np.column_stack([xx.ravel() * CAL_SQUARE, yy.ravel() * CAL_SQUARE,
                           np.zeros(n * n)]).astype(np.float32)
    detect_refine = lambda g: refine_corners_subpix(          # noqa: E731
        g, detect_checkerboard_corners(g, n, n)[0])
    detect_refine(imgs[0])                                  # warm
    found, corners, view_ms = [], [], []
    for g in imgs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c, ok = detect_checkerboard_corners(g, n, n)
        r = refine_corners_subpix(g, c)
        torch.cuda.synchronize()
        view_ms.append((time.perf_counter() - t1) * 1e3)
        found.append(bool(ok))
        corners.append(r.cpu().numpy())
    # the refined corners against the rendered truth (first inner corner
    # at one square from the board's origin)
    from repas_tpu_torch.kernels.project import project_points
    truth_err = [float(np.abs(project_points(
        torch.tensor(obj + [CAL_SQUARE, CAL_SQUARE, 0.0], dtype=torch.float64),
        torch.tensor(R), torch.tensor(t), torch.tensor(CAL_K),
        torch.tensor(CAL_DIST)).numpy() - c).max())
        for (R, t), c in zip(poses, corners)]
    cpu_err = []
    for i in (0, CAL_VIEWS - 1):
        g = imgs[i].cpu()
        c_cpu = detect_refine(g).numpy()
        cpu_err.append(float(np.abs(c_cpu - corners[i]).max()))
    view_prof = device_profile(lambda: detect_refine(imgs[0]))
    objs = np.stack([obj] * CAL_VIEWS)
    calibrate_camera(objs, np.stack(corners), (W, H), device=dev)  # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    K, dist, rms, _, _ = calibrate_camera(objs, np.stack(corners), (W, H),
                                          device=dev)
    lm_s = time.perf_counter() - t1
    compiled = calibration_vs_eager(imgs[0], objs, np.stack(corners),
                                    (K, dist, rms), dev)
    out = {"phase": "calibration", "views": CAL_VIEWS, "found": found,
           "rms_px": rms, "K": K.tolist(), "dist": dist[:5].tolist(),
           "K_truth": CAL_K.tolist(), "dist_truth": CAL_DIST.tolist(),
           "fx_rel_err": K[0, 0] / CAL_K[0, 0] - 1,
           "fy_rel_err": K[1, 1] / CAL_K[1, 1] - 1,
           "cx_err_px": K[0, 2] - CAL_K[0, 2],
           "cy_err_px": K[1, 2] - CAL_K[1, 2],
           "corner_vs_truth_px_max": max(truth_err),
           "corner_vs_cpu_px": cpu_err,
           "view_ms_median": float(np.median(view_ms)), "view_ms": view_ms,
           "view_profile": view_prof, "calibrate_s": lm_s,
           "compiled_vs_eager": compiled,
           "calibrate_5_steps_profile": device_profile(
               lambda: calibrate_camera(objs, np.stack(corners), (W, H),
                                        iters=5, device=dev)),
           "render_s": render_s, "gpu": gpu_line}
    log(out)
    fails = []
    if not all(found):
        fails.append(f"boards not found: {found}")
    if not rms < 0.3:
        fails.append(f"rms {rms}")
    if not (abs(out["fx_rel_err"]) < 0.005 and abs(out["fy_rel_err"]) < 0.005
            and abs(out["cx_err_px"]) < 2 and abs(out["cy_err_px"]) < 2):
        fails.append(f"K {K.tolist()}")
    if not max(cpu_err) < 1e-3:
        fails.append(f"card vs CPU corners {cpu_err}")
    if fails:
        raise AssertionError(f"calibration: {fails}")

    vd = d / "views"
    vd.mkdir()
    for i, g in enumerate(imgs):
        write_png(vd / f"view_{i:02d}.png", g.cpu().numpy().astype(np.uint8),
                  level=1)
    t1 = time.perf_counter()
    calibrate.main(["--images", str(vd), "--cols", str(n), "--rows", str(n),
                    "--square-mm", str(CAL_SQUARE * 1000),
                    "--out", str(d / "calib.json"), "--device", "cuda"])
    app_s = time.perf_counter() - t1
    app = json.loads((d / "calib.json").read_text())
    log({"phase": "calibration_app", "fx": app["fx"], "fy": app["fy"],
         "cx": app["cx"], "cy": app["cy"], "rms_px": app["rms_px"],
         "app_s": app_s})
    if abs(app["fx"] / CAL_K[0, 0] - 1) > 0.005 or app["rms_px"] >= 0.3:
        raise AssertionError(f"calibrate app: {app}")
    return out


def uv_sphere(n_lat, n_lon, r):
    """A closed UV sphere (vertices, triangles), wound counter-clockwise
    seen from outside."""
    th = np.pi * np.arange(1, n_lat) / n_lat
    ph = 2 * np.pi * np.arange(n_lon) / n_lon
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                     np.sin(th)[:, None] * np.sin(ph)[None],
                     np.cos(th)[:, None] * np.ones(n_lon)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1.0]], ring, [[0, 0, -1.0]]]) * r
    i = np.arange(n_lat - 2)[:, None]
    j = np.arange(n_lon)[None, :]
    a, b = 1 + i * n_lon + j, 1 + i * n_lon + (j + 1) % n_lon
    c, e = a + n_lon, b + n_lon
    body = np.concatenate([np.stack([a, c, e], -1).reshape(-1, 3),
                           np.stack([a, e, b], -1).reshape(-1, 3)])
    jj = np.arange(n_lon)
    last = len(verts) - 1
    top = np.stack([np.zeros(n_lon, int), 1 + jj, 1 + (jj + 1) % n_lon], -1)
    base = 1 + (n_lat - 2) * n_lon
    bot = np.stack([np.full(n_lon, last), base + (jj + 1) % n_lon,
                    base + jj], -1)
    return (verts.astype(np.float32),
            np.concatenate([top, bot, body]).astype(np.int32))


def surface_part(d, dev, gpu_line):
    """point_to_mesh_signed_distances for 150,000 points on the card,
    compiled (one graph holding its 199 chunks) against eager
    (compiled_leaf): against the analytic distance, the sign, the CPU on a
    subsample; times; point_to_mesh_distances compiled against eager on
    the first SURF_UNSIGNED_N points, equal to the signed distances'
    magnitudes; then error_report surface on files of the scene (a replay
    of the same graph). The two graphs are dropped at the end (their
    pools hold gigabytes)."""
    from repas_tpu_torch.apps import error_report
    from repas_tpu_torch.eval.reports import (point_to_mesh_distances,
                                              point_to_mesh_signed_distances)
    from repas_tpu_torch.io.ply import (PointCloud, TriangleMesh, write_ply,
                                        write_stl)

    verts, tris = uv_sphere(SURF_LAT, SURF_LAT, SURF_R)
    rng = np.random.default_rng(5)
    u = rng.normal(size=(SURF_N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * (SURF_R + rng.uniform(-0.005, 0.005, (SURF_N, 1)))).astype(
        np.float32)
    # the mesh lies between the sphere and the nearest plane of its
    # triangles: sag <= r - min plane distance from the centre
    a, b, c = (verts[tris[:, k]].astype(np.float64) for k in range(3))
    nrm = np.cross(b - a, c - a)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    sag = SURF_R - float(np.min(np.abs(np.sum(nrm * a, axis=1))))
    args = [torch.from_numpy(x).to(dev) for x in (pts, verts, tris)]
    dist, compiled = compiled_leaf(
        "surface_error", [("point_to_mesh_signed_distances",
                           point_to_mesh_signed_distances)],
        lambda: point_to_mesh_signed_distances(*args), reps=REPORT_TURNS,
        eager_trace=False)
    ms = compiled["ms"]["compiled"]["host"]["median"]
    ev_ms = compiled["ms"]["compiled"]["events"]["median"]
    head = [args[0][:SURF_UNSIGNED_N], args[1], args[2]]
    udist, unsigned = compiled_leaf(
        "surface_error unsigned", [("point_to_mesh_distances",
                                    point_to_mesh_distances)],
        lambda: point_to_mesh_distances(*head), reps=REPORT_TURNS,
        eager_trace=False)
    unsigned["vs_signed_max_m"] = float(
        (udist - dist[:SURF_UNSIGNED_N].abs()).abs().max())
    dist = dist.cpu().numpy().astype(np.float64)
    true = np.linalg.norm(pts.astype(np.float64), axis=1) - SURF_R
    err = np.abs(np.abs(dist) - np.abs(true))
    far = np.abs(true) > sag + 1e-6
    sign_ok = bool((np.sign(dist[far]) == np.sign(true[far])).all())
    sub = np.random.default_rng(6).choice(SURF_N, SURF_SUB, replace=False)
    t0 = time.perf_counter()
    # on the CPU in batches of 500 points against 512-triangle chunks: the
    # same results (each point's distance is its own), with intermediates
    # that stay in cache (5x faster than one call with 256-wide chunks)
    cpu = torch.cat([point_to_mesh_signed_distances(
        torch.from_numpy(pts[sub[i:i + 500]]), torch.from_numpy(verts),
        torch.from_numpy(tris), chunk=512) for i in range(0, SURF_SUB, 500)]
    ).numpy().astype(np.float64)
    cpu_s = time.perf_counter() - t0
    vs_cpu = np.abs(np.abs(dist[sub]) - np.abs(cpu))
    away = np.abs(cpu) > 1e-5
    out = {"phase": "surface_error", "points": SURF_N,
           "triangles": len(tris), "sag_m": sag,
           "max_err_vs_analytic_m": float(err.max()),
           "sign_right_beyond_sag": sign_ok, "points_beyond_sag":
           int(far.sum()), "vs_cpu_max_m": float(vs_cpu.max()),
           "vs_cpu_over_tol": int((vs_cpu > 1e-6 * np.abs(cpu) + 1e-7).sum()),
           "vs_cpu_sign_differ": int((np.sign(dist[sub]) != np.sign(cpu))
                                     [away].sum()),
           "cpu_subsample_s": cpu_s, "cpu_threads": torch.get_num_threads(),
           "ms_host": ms, "ms_cuda_events": ev_ms, "compiled": compiled,
           "unsigned_points": SURF_UNSIGNED_N, "unsigned_compiled": unsigned,
           "gpu": gpu_line}
    log(out)
    fails = []
    if unsigned["vs_signed_max_m"] > 0.0:
        fails.append(f"unsigned distances off the signed ones' magnitudes "
                     f"by {unsigned['vs_signed_max_m']}")
    if not err.max() <= sag + 1e-6:
        fails.append(f"error vs analytic {err.max()} over sag {sag}")
    if not sign_ok:
        fails.append("a sign wrong beyond the sag")
    if out["vs_cpu_over_tol"] or out["vs_cpu_sign_differ"]:
        fails.append(f"card vs CPU {out['vs_cpu_over_tol']} over tolerance,"
                     f" {out['vs_cpu_sign_differ']} signs")
    if fails:
        raise AssertionError(f"surface_error: {fails}")

    write_ply(d / "cloud.ply", PointCloud(points=pts))
    write_stl(d / "sphere.stl", TriangleMesh(vertices=verts, triangles=tris))
    t0 = time.perf_counter()
    rep = error_report.main(["surface", "--cloud", str(d / "cloud.ply"),
                             "--mesh", str(d / "sphere.stl"),
                             "--txt", str(d / "alignment_errors.txt"),
                             "--colored-out", str(d / "colored.ply"),
                             "--json", str(d / "surface.json"),
                             "--device", "cuda"])
    app_s = time.perf_counter() - t0
    log({"phase": "surface_error_app", "count": rep["count"],
         "mean_mm": rep["mean_mm"], "inside_fraction":
         rep["signed"]["inside_fraction"], "app_s": app_s})
    if rep["count"] != SURF_N or not (d / "colored.ply").exists():
        raise AssertionError(f"error_report surface: {rep}")
    point_to_mesh_signed_distances.clear()
    point_to_mesh_distances.clear()
    return out


def canopy_calib_eval_phase(dev, gpu_line):
    """The canopy-height, calibration and surface-error paths on the card
    (no kernel of theirs; B1-B4 counted across the phase: none
    launched). Returns the B1-B4 launch counts of the phase."""
    import pathlib
    import tempfile

    from repas_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        canopy_part(d, dev, gpu_line)
        calibration_part(d, dev, gpu_line)
        surface_part(d, dev, gpu_line)
    counts = dict(_build.launches)
    phase_s = time.perf_counter() - t0
    log({"phase": "canopy_calib_eval", "phase_s": phase_s,
         "kernel_launches": counts, "gpu": gpu_line})
    if phase_s > 90.0:
        raise AssertionError(f"canopy_calib_eval took {phase_s} s")
    return counts


# --- apps_stream: the stream, pose, capture, fusion and viewing CLIs, the
# renderer and the frame mesh -------------------------------------------

# a 1280x720 replay stream at the bench intrinsics: 60 mm tags 9 (mounted
# upside down) and 16 on a plane at 0.5 m, the camera moving APPS_STEP a
# frame; a second view from a camera turned 25 degrees about y and moved
# so that it still faces the tags (a camera a few degrees off the plane's
# normal leaves a 40-100 px tag's pose ambiguous between IPPE's branches)
APPS_FRAMES = 8
APPS_STEP = np.array([0.002, 0.001, 0.0])
# validate_pose translation's two captures: one 120 mm tag 16 at 0.45 m
# (243 px; single-tag PnP ranges a 110 px tag only to 1-3 mm), the camera
# moved APPS_VALIDATE_STEP between them
APPS_VALIDATE_TAG, APPS_VALIDATE_Z = 0.12, 0.45
APPS_VALIDATE_STEP = np.array([0.01, 0.005, 0.0])
APPS_THREEWAY_MM = 10.0        # detector pose vs PnP in validate_pose
APPS_VIEW_DEG = 25.0
APPS_TARGET = np.array([-0.02, -0.03, CAD_Z])
APPS_RENDER_POINTS = 1_000_000
APPS_MESH_BATCH = 16


def apps_view_pose():
    """(R_wc, c) of the second view: turned APPS_VIEW_DEG about y and
    placed 0.5 m from APPS_TARGET along its optical axis."""
    a = np.radians(APPS_VIEW_DEG)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    return R, APPS_TARGET - 0.5 * R[:, 2]


def apps_frame(R_wc, c, seed, tags=CAD_TAGS, tag=CAD_TAG, z0=CAD_Z,
               window=260):
    """(rgb (H,W,3) u8, depth (H,W) u16 mm) of the tag plane z = z0 seen
    from a camera at c with camera-to-world rotation R_wc; tag 9 is
    mounted upside down."""
    img = np.full((H, W), 180.0, np.float32)
    for tid, (x, y) in tags.items():
        R_tag = np.diag([-1.0, -1.0, 1.0]) if tid == 9 else np.eye(3)
        win = render_window(tid, R_wc.T @ R_tag,
                            R_wc.T @ (np.array([x, y, z0]) - c), CAD_K,
                            tag, window, supersample=2)
        img = np.where(win != 180.0, win, img)
    rgb = noisy_rgb(img[None], seed=seed)[0]
    K = CAD_K.astype(np.float64)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                  np.ones_like(u)], -1) @ R_wc.T
    z = (z0 - c[2]) / d[..., 2]
    z = z + np.random.default_rng(seed).normal(0, 0.0005, (H, W))
    return rgb, np.round(z * 1000).astype(np.uint16)


def apps_scene(d):
    """Writes the stream (d/stream: color_<ts>.png + aligned_depth_<ts>.png,
    u16 mm), the second view (d/view_b), the validate_pose captures
    (d/cap_first, d/cap_last), a depth-camera frame for align_depth
    (d/depth_cam.png, 640x360) and the intrinsics JSONs."""
    def write(sub, ts, rgb, depth):
        (d / sub).mkdir(exist_ok=True)
        write_png(d / sub / f"color_{ts}.png", rgb, level=1)
        write_png(d / sub / f"aligned_depth_{ts}.png", depth, level=1)

    for k in range(APPS_FRAMES):
        rgb, depth = apps_frame(np.eye(3), k * APPS_STEP, seed=20 + k)
        write("stream", f"20250101_0000{k:02d}", rgb, depth)
        if k == 0:
            write_png(d / "depth_cam.png", depth[::2, ::2], level=1)
    write("view_b", "20250101_000000",
          *apps_frame(*apps_view_pose(), seed=40))
    for k, sub in enumerate(("cap_first", "cap_last")):
        write(sub, "20250101_000000", *apps_frame(
            np.eye(3), k * APPS_VALIDATE_STEP, seed=30 + k,
            tags={16: (0.0, 0.0)}, tag=APPS_VALIDATE_TAG,
            z0=APPS_VALIDATE_Z, window=480))
    K = CAD_K
    intr = {"fx": float(K[0, 0]), "fy": float(K[1, 1]), "cx": float(K[0, 2]),
            "cy": float(K[1, 2]), "width": W, "height": H}
    (d / "K.json").write_text(json.dumps(intr))
    (d / "K_depth.json").write_text(json.dumps(intr))
    (d / "d2c.json").write_text(json.dumps(
        {"R": np.eye(3).tolist(), "t": [0.015, 0.0, 0.0]}))
    # estimate_pose --layout: tag 16 in a frame whose origin is the world's
    # on the tag plane (tag 9 is mounted upside down, which a layout of
    # centres cannot state); the first frame's camera sees it at R = I,
    # t = (0, 0, CAD_Z)
    (d / "layout.json").write_text(json.dumps(
        {"16": [CAD_TAGS[16][0], CAD_TAGS[16][1], 0.0]}))


def apps_runs(d, dev):
    """(name, module, argv) of the ten CLIs' calls on the scene in d."""
    from repas_tpu_torch.apps import (align_depth, capture_aligned,
                                      detect_tags, estimate_pose,
                                      fetch_intrinsics, fuse_views,
                                      pack_replay, track_stream,
                                      validate_pose, view_pointcloud)

    K = ["--intrinsics", str(d / "K.json")]
    tag = ["--tag-size", str(CAD_TAG)]
    f0 = d / "stream"
    c0, d0 = f0 / "color_20250101_000000.png", \
        f0 / "aligned_depth_20250101_000000.png"
    track = ["--source", str(f0), *K, *tag]
    return [
        ("track_stream", track_stream, track + ["--out",
                                                str(d / "track.jsonl")]),
        ("track_stream_robust", track_stream,
         track + ["--robust", "--frames", "2", "--out",
                  str(d / "robust.jsonl")]),
        ("track_stream_temporal", track_stream,
         track + ["--temporal", "--out", str(d / "temporal.jsonl")]),
        ("detect_tags", detect_tags, [str(c0), "--json",
                                      str(d / "det.json")]),
        ("estimate_pose", estimate_pose,
         ["--color", str(c0), "--depth", str(d0), *K, *tag, "--json",
          str(d / "pose.json")]),
        ("estimate_pose_layout", estimate_pose,
         ["--color", str(c0), "--depth", str(d0), *K, *tag, "--layout",
          str(d / "layout.json"), "--json", str(d / "pose_layout.json")]),
        ("validate_pose", validate_pose,
         ["translation", "--captures", str(d / "cap_first"),
          str(d / "cap_last"), *K, "--tag-size", str(APPS_VALIDATE_TAG),
          "--json", str(d / "translation.json")]),
        ("align_depth", align_depth,
         ["--depth", str(d / "depth_cam.png"), "--depth-intrinsics",
          str(d / "K_depth.json"), "--color-intrinsics", str(d / "K.json"),
          "--extrinsics", str(d / "d2c.json"), "--width", str(W),
          "--height", str(H), "--out", str(d / "aligned" / "aligned.png")]),
        ("capture_aligned", capture_aligned,
         ["--source", str(f0), *K, "--frames", "1", "--colorize", "--out",
          str(d / "captured")]),
        ("fetch_intrinsics", fetch_intrinsics,
         ["--color", str(d / "K.json"), "--depth", str(d / "K_depth.json"),
          "--extrinsics", str(d / "d2c.json"), "--out",
          str(d / "bundle.json")]),
        ("pack_replay", pack_replay,
         ["--input", str(f0), "--out", str(d / "packed"), "--colorize"]),
        ("fuse_views", fuse_views,
         ["--views", str(f0), str(d / "view_b"), *K, *tag, "--anchor-id",
          "16", "--out", str(d / "fused.ply")]),
        ("view_pointcloud", view_pointcloud,
         [str(d / "fused.ply"), "--splat", "--orbit", "2", "--out",
          str(d / "view")]),
    ], ["--device", str(dev)]


# the apps_stream CLIs that replay compiled steps: the tracker's,
# detect_tags_robust's, detect_tags_jit, fuse_tag_poses_jit,
# solve_tag_bundle_jit, solve_pnp_best_order_jit
GRAPH_CLIS = ("track_stream", "track_stream_robust", "track_stream_temporal",
              "detect_tags", "estimate_pose", "estimate_pose_layout",
              "validate_pose", "fuse_views")


def apps_stream_clis(d, dev):
    """Each CLI call warm, then timed with the launch counts reset just
    before it, then each CLI that replays compiled steps (GRAPH_CLIS) once
    more traced. Returns (ms, wrapper launches per call, the traced calls'
    device launches and their launches inside graphs (device less
    wrapper), the B1-B4 inputs first seen in the warm calls)."""
    from repas_tpu_torch import pipeline
    from repas_tpu_torch.core.jit import clear_caches
    from repas_tpu_torch.kernels import (_build, ccl_cuda, ccl_tiled,
                                         patch_extract)

    runs, devarg = apps_runs(d, dev)
    ms, launches, device, graph = {}, {}, {}, {}
    # the compiled steps are captured anew in the warm calls, as in a new
    # process, whose eager warm-ups show B1's and B2's inputs at the
    # tracker's shapes
    clear_caches()
    with Capture(ccl_cuda, "connected_components_cuda", True) as c1, \
            Capture(patch_extract, "extract_windows") as c2, \
            Capture(pipeline, "fused_pointcloud") as c3, \
            Capture(ccl_tiled, "connected_components_tiled_cuda") as c4:
        for name, app, argv in runs:
            app.main(argv + devarg)
        torch.cuda.synchronize()
    for name, app, argv in runs:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        app.main(argv + devarg)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = dict(_build.launches)
    # the tracker's steps, detect_tags_robust's pieces and the _jit
    # steps replay graphs: their kernels show in a trace
    for name, app, argv in runs:
        if name in GRAPH_CLIS:
            _, wrapped, device[name], names = traced(
                lambda: app.main(argv + devarg))
            device[name]["ccl_tiled"] = trace_counts(
                names, LADDER_NAMES)["ccl_tiled"]
            graph[name] = {k: device[name][k] - wrapped[k]
                           for k in (*PIPELINE_KEYS, "ccl_tiled")}
    return ms, launches, device, graph, (c1.calls, c2.args, c3.args,
                                         c4.args)


def apps_stream_checks(d):
    """The CLIs' outputs against the scene's truth; returns the numbers."""
    from repas_tpu_torch.io.meta import read_meta
    from repas_tpu_torch.io.ply import read_ply
    from repas_tpu_torch.io.image import read_image

    def jsonl(name):
        return [json.loads(line) for line in open(d / name)]

    out, fails = {}, []
    track = jsonl("track.jsonl")
    p16 = np.array([CAD_TAGS[16][0], CAD_TAGS[16][1], CAD_Z])
    err = [float(np.linalg.norm(np.subtract(r["anchor_P_depth"],
                                            p16 - k * APPS_STEP))) * 1000
           for k, r in enumerate(track)]
    out["track_anchor_err_mm"] = err
    if len(track) != APPS_FRAMES or any(sorted(r["ids"]) != [9, 16]
                                        for r in track):
        fails.append(f"track_stream ids {[r['ids'] for r in track]}")
    if max(err) > 5.0:
        fails.append(f"track_stream anchor {max(err)} mm off")
    robust = jsonl("robust.jsonl")
    out["robust_ids"] = [r["ids"] for r in robust]
    if any(sorted(r["ids"]) != [9, 16] for r in robust):
        fails.append(f"track_stream --robust ids {out['robust_ids']}")
    modes = [r["mode"] for r in jsonl("temporal.jsonl")]
    out["temporal_modes"] = modes
    if modes != ["register"] + ["track"] * (APPS_FRAMES - 1):
        fails.append(f"track_stream --temporal modes {modes}")
    tr = json.loads((d / "translation.json").read_text())
    delta = np.asarray(tr["deltas"][0]["delta_t"])
    step = -APPS_VALIDATE_STEP
    out["translation_delta_err_mm"] = float(np.linalg.norm(delta - step)) * 1e3
    if out["translation_delta_err_mm"] > 2.0:
        fails.append(f"validate_pose delta {delta} vs {step}")
    det = json.loads((d / "det.json").read_text())[0]["detections"]
    pose = json.loads((d / "pose.json").read_text())
    out["detect_ids"] = sorted(x["id"] for x in det)
    out["pose_anchor_err_mm"] = float(np.linalg.norm(
        np.subtract(pose["anchor_P_depth"], p16))) * 1000
    if out["detect_ids"] != [9, 16] or out["pose_anchor_err_mm"] > 5.0:
        fails.append(f"detect_tags {out['detect_ids']}, estimate_pose "
                     f"anchor {out['pose_anchor_err_mm']} mm")
    lay = json.loads((d / "pose_layout.json").read_text())
    out["layout"] = {
        "tags_used": lay["tags_used"], "err_px": lay["reproj_err_px"],
        "R_err_deg": angle_deg(lay["R_world_to_camera"], np.eye(3)),
        "t_err_mm": float(np.linalg.norm(np.subtract(
            lay["t_world_to_camera"], [0.0, 0.0, CAD_Z]))) * 1000}
    if lay["mode"] != "bundle" or lay["tags_used"] != [16] or \
            out["layout"]["R_err_deg"] > 1.0 or \
            out["layout"]["t_err_mm"] > 5.0:
        fails.append(f"estimate_pose --layout {out['layout']}")

    # fuse_views: each view's points in the tag frame; near the tags the
    # second view's lie on the first's (median nearest-neighbour distance)
    meta = read_meta(d / "fused.meta.json")
    n_a = meta["views"][0]["n_points"]
    fused = read_ply(d / "fused.ply").points
    a, b = fused[:n_a], fused[n_a:]
    near_b = b[np.linalg.norm(b[:, :2], axis=1) < 0.1][::20]
    near_a = a[np.linalg.norm(a[:, :2], axis=1) < 0.12][::4]
    nn = nn_dist(near_b, near_a)
    out["fuse_views"] = {"views": len(meta["views"]), "points": len(fused),
                         "anchor_ids": [v["anchor_id"] for v in meta["views"]],
                         "nn_median_mm": float(np.median(nn)) * 1000,
                         "nn_p90_mm": float(np.percentile(nn, 90)) * 1000,
                         "nn_checked": len(near_b)}
    if len(meta["views"]) != 2 or out["fuse_views"]["nn_median_mm"] > 5.0:
        fails.append(f"fuse_views {out['fuse_views']}")
    imgs = [read_image(d / f"view_splat{i}.png") for i in range(2)]
    out["splat_drawn_frac"] = [float((im != 255).any(-1).mean())
                               for im in imgs]
    if min(out["splat_drawn_frac"]) < 0.01:
        fails.append(f"view_pointcloud drew {out['splat_drawn_frac']}")
    return out, fails, fused


def apps_stream_vs_cpu(d):
    """align_depth and capture_aligned run again on the CPU port: their
    files equal the card's (align_depth: a projection within an ulp of a
    pixel edge may floor either way, ROADMAP C: at most 1e-4 of the
    pixels)."""
    from repas_tpu_torch.apps import align_depth, capture_aligned
    from repas_tpu_torch.io.image import read_depth_png

    runs, _ = apps_runs(d, "cpu")
    runs = {name: (app, argv) for name, app, argv in runs}
    cpu = d / "cpu"
    cpu.mkdir()
    app, argv = runs["align_depth"]
    app.main([a.replace(str(d / "aligned"), str(cpu)) for a in argv]
             + ["--device", "cpu"])
    card = read_depth_png(d / "aligned" / "aligned.png")
    host = read_depth_png(cpu / "aligned.png")
    align_share = float((card != host).mean())
    app, argv = runs["capture_aligned"]
    app.main([a.replace(str(d / "captured"), str(cpu / "captured"))
              for a in argv] + ["--device", "cpu"])
    diff = []
    for f in sorted((d / "captured").rglob("*")):
        if f.is_file() and "meta" not in f.name:
            g = cpu / "captured" / f.relative_to(d / "captured")
            if f.read_bytes() != g.read_bytes():
                diff.append(f.name)
    if align_share > 1e-4 or diff:
        raise AssertionError(f"card vs CPU: align_depth differs at "
                             f"{align_share} of pixels, capture_aligned "
                             f"files {diff}")
    return {"align_depth_differ_share": align_share,
            "capture_aligned_files_equal": True}


def validate_pose_threeway(d, dev):
    """validate_pose threeway on the first translation capture (one 120 mm
    tag 16 at 0.45 m), whose detector_pose is a compiled step: the CLI's
    detector and PnP translations within APPS_THREEWAY_MM of each other;
    detector_pose on the corners and K the CLI gave it, compiled against
    eager (compiled_leaf)."""
    from repas_tpu_torch.apps import validate_pose

    cap = d / "cap_first"
    with Capture(validate_pose, "detector_pose") as c:
        res = validate_pose.main([
            "threeway", "--color", str(cap / "color_20250101_000000.png"),
            "--depth", str(cap / "aligned_depth_20250101_000000.png"),
            "--intrinsics", str(d / "K.json"), "--tag-size",
            str(APPS_VALIDATE_TAG), "--json", str(d / "threeway.json"),
            "--device", str(dev)])
    if c.args is None:
        raise AssertionError("validate_pose threeway never called "
                             "detector_pose")
    a, kw = c.args
    _, compiled = compiled_leaf(
        "validate_pose detector_pose",
        [("detector_pose", validate_pose.detector_pose)],
        lambda: validate_pose.detector_pose(*a, **kw))
    out = {"id": res["id"], "pnp_vs_detector_mm": res["pnp_vs_detector_mm"],
           "t_detector_mm": np.asarray(res["t_detector_mm"]).tolist(),
           "compiled": compiled}
    if not out["pnp_vs_detector_mm"] < APPS_THREEWAY_MM:
        raise AssertionError(f"validate_pose threeway: {out}")
    return out


def apps_render(fused, dev):
    """render_pointcloud of APPS_RENDER_POINTS fused points (splat 2) into
    1280x720 on the card: its CUDA-event ms (queued behind a spin kernel),
    and its z-buffer and image against the CPU port's (the image may
    differ only at pixels whose winners tie, where both devices apply the
    same rule, so no pixel is expected to). The compiled renderer against
    its eager function (compiled_leaf) on orbit view 1, its numpy camera
    through the public entry; then view 2 replays the same graph: equal
    to its eager image, and the two views' images differ."""
    from repas_tpu_torch.core.jit import disable_jit
    from repas_tpu_torch.viz.render import (orbit_views, render_pointcloud,
                                            zbuffer)

    sel = np.linspace(0, len(fused) - 1, APPS_RENDER_POINTS).astype(np.int64)
    pts = np.asarray(fused, np.float32)[sel]
    rgb = np.random.default_rng(0).integers(0, 256, (len(pts), 3))
    xyzrgb = np.concatenate([pts, rgb], 1).astype(np.float32)
    views = orbit_views(pts.mean(0), 0.9, n=8)
    R, t = views[1]
    K = CAD_K.astype(np.float32)
    card = torch.from_numpy(xyzrgb).to(dev)

    def view(i):
        return lambda: render_pointcloud(card, K, *views[i], shape=(H, W))

    img1, compiled = compiled_leaf(
        "apps_render", [("render_pointcloud", render_pointcloud)], view(1))
    with strict_replays() as replays:
        img2 = view(2)()
    with disable_jit():
        want2 = view(2)()
    if replays[0] != 1 or len(render_pointcloud.graphs) != 1 or \
            not bit_equal(img2, want2) or torch.equal(img1, img2):
        raise AssertionError(f"the second orbit view: {replays[0]} "
                             f"replays, {len(render_pointcloud.graphs)} "
                             "graphs, equal to eager "
                             f"{bit_equal(img2, want2)}, equal to view 1 "
                             f"{torch.equal(img1, img2)}")
    compiled["second_view"] = {
        "bit_equal": True, "differ_from_first_pixels":
        int((img1 != img2).any(-1).sum())}
    # the camera on the card: no host-to-device copy inside the timed calls
    cam = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
           for a in (K, R, t)]

    def render(x, cam=(K, R, t)):
        return render_pointcloud(x, *cam, shape=(H, W))

    ms = cuda_ms(lambda: render(card, cam), iters=10, queued=True)
    host_ms_one, event_ms_one = host_and_device_ms(lambda: render(card, cam))
    prof = device_profile(lambda: render(card, cam))
    img, zb = render(card).cpu(), zbuffer(card, K, R, t, shape=(H, W)).cpu()
    host = torch.from_numpy(xyzrgb)
    img_cpu, zb_cpu = render(host), zbuffer(host, K, R, t, shape=(H, W))
    if not torch.equal(zb, zb_cpu):
        raise AssertionError(f"render z-buffer differs from the CPU's at "
                             f"{int((zb != zb_cpu).sum())} pixels")
    # pixels where more than one point passes the depth test
    from repas_tpu_torch.viz import render as rmod

    z, cam, Kt = rmod._project(host[:, :3], K, R, t)
    valid, u, v = rmod._pixels(cam, Kt, z, 1e-3)
    zf = zb_cpu.reshape(-1)
    wins = torch.zeros(H * W, dtype=torch.int64)
    for dv, du in rmod._offsets(2):
        idx, ok = rmod._slots(valid, u, v, du, dv, H, W)
        win = ok & (z <= zf[idx] * (1 + 1e-6))
        wins.index_add_(0, idx, win.to(torch.int64))
    tied = (wins > 1).reshape(H, W)
    moved = (img != img_cpu).any(-1)
    if bool((moved & ~tied).any()):
        raise AssertionError(f"render image differs from the CPU's at "
                             f"{int((moved & ~tied).sum())} untied pixels")
    return {"points": len(pts), "ms": ms, "host_ms": host_ms_one,
            "event_ms": event_ms_one, "profile": prof, "compiled": compiled,
            "tied_pixels": int(tied.sum()),
            "differ_pixels": int(moved.sum()),
            "drawn_pixels": int((zb < float("inf")).sum())}


def apps_mesh(dev):
    """sharded_frame_pipeline(process_frames) over the card named twice, at
    batch APPS_MESH_BATCH, against the unsharded step, bit for bit."""
    from repas_tpu_torch.core.config import PipelineConfig
    from repas_tpu_torch.parallel import (frames_mesh, shard_batch,
                                          sharded_frame_pipeline)
    from repas_tpu_torch.pipeline import process_frames

    rgbs_np, depths_np, K_np = bench_frames(APPS_MESH_BATCH)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    depths = torch.from_numpy(depths_np).to(dev)
    K = torch.from_numpy(K_np).to(dev)
    mesh = frames_mesh(devices=[dev, dev])
    fn = lambda r, d: process_frames(r, d, K, PipelineConfig())  # noqa: E731
    single = fn(rgbs, depths)
    run = sharded_frame_pipeline(fn, mesh)
    sharded = run(shard_batch(rgbs, mesh), shard_batch(depths, mesh))
    ms = host_ms(lambda: run(shard_batch(rgbs, mesh),
                             shard_batch(depths, mesh)), 3)
    single_ms = host_ms(lambda: fn(rgbs, depths), 3)
    leaves = list(zip([*single.detections, *single.pose, single.pointcloud],
                      [*sharded.detections, *sharded.pose,
                       sharded.pointcloud]))
    bad = [i for i, (a, b) in enumerate(leaves)
           if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
               a.view(torch.int32) if a.dtype.is_floating_point else a,
               b.view(torch.int32) if b.dtype.is_floating_point else b)]
    if bad:
        raise AssertionError(f"sharded pipeline differs in leaves {bad}")
    return {"mesh_devices": [str(x) for x in mesh.devices],
            "batch": APPS_MESH_BATCH, "leaves_equal": len(leaves),
            "sharded_step_ms": ms, "unsharded_step_ms": single_ms,
            "device_count": torch.cuda.device_count()}


def apps_stream_phase(dev, gpu_line):
    """The last slice's entry points on the card: the ten CLIs in-process
    on a 720p replay stream and a second view, their outputs against the
    scene's truth, B1-B4 held against their plain twins at the phase's
    inputs, the renderer at full width and the mesh over a repeated
    device. Returns (the phase's kernel records, the phase's B1-B4
    wrapper launches, B1-B4's launches inside graphs in the traced CLI
    calls)."""
    import pathlib
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        apps_scene(d)
        scene_s = time.perf_counter() - t0
        traced0 = TRACED_S[0]
        ms, launches, device, per_cli, (b1, b2, b3, b4) = \
            apps_stream_clis(d, dev)
        traced_s = TRACED_S[0] - traced0
        totals = {k: sum(v[k] for v in launches.values())
                  for k in launches["track_stream"]}
        graph = {k: sum(v[k] for v in per_cli.values())
                 for k in (*PIPELINE_KEYS, "ccl_tiled")}
        low = [k for k in PIPELINE_KEYS if device["track_stream"][k] < 1]
        if low:
            raise AssertionError(f"track_stream did not launch {low} on the "
                                 f"device ({device['track_stream']})")
        if (launches["track_stream_robust"]["ccl_tiled"] < 1
                and launches["fuse_views"]["ccl_tiled"] < 1
                and device["track_stream_robust"]["ccl_tiled"] < 1
                and device["fuse_views"]["ccl_tiled"] < 1):
            raise AssertionError("B4 not launched by track_stream --robust "
                                 "nor fuse_views")
        if b2 is None or b3 is None or b4 is None:
            raise AssertionError("the CLIs never called B2, B3 or B4")
        records = [check_b1(f"B1 ccl (apps_stream {tuple(a[0].shape)})", *a)
                   for a, _ in b1]
        (pyr, origins, ah, aw), kw = b2
        records.append(check_b2(
            f"B2 patch_extract (apps_stream {tuple(pyr.shape)}, {ah}x{aw} "
            "windows)", pyr, origins, ah, aw, **kw))
        (depth, rgb32, K), kw = b3
        records.append(check_b3(f"B3 pointcloud (apps_stream "
                                f"{tuple(depth.shape)})", depth, rgb32, K,
                                kw["scale"]))
        b4_args, _ = b4
        records.append(check_b4(*b4_args, name=f"B4 ccl_tiled (apps_stream "
                                               f"{tuple(b4_args[0].shape)})"))
        keys = {"B1": "ccl", "B2": "patch_extract", "B3": "pointcloud",
                "B4": "ccl_tiled"}
        for rec in records:
            rec["launches"] = totals[keys[rec["name"][:2]]]
            rec["graph_launches"] = graph.get(keys[rec["name"][:2]], 0)

        checks, fails, fused = apps_stream_checks(d)
        log({"phase": "apps_stream", "app_ms": ms, "launches": launches,
             "traced_device_launches": device, "graph_launches": graph,
             "traced_s": traced_s,
             "scene_s": scene_s, **checks, "gpu": gpu_line})
        if fails:
            raise AssertionError(f"apps_stream: {fails}")
        log({"phase": "apps_stream_vs_cpu", **apps_stream_vs_cpu(d)})
        log({"phase": "validate_pose_threeway",
             **validate_pose_threeway(d, dev), "gpu": gpu_line})
        log({"phase": "apps_render", **apps_render(fused, dev),
             "gpu": gpu_line})
    log({"phase": "apps_mesh", **apps_mesh(dev), "gpu": gpu_line})
    phase_s = time.perf_counter() - t0
    log({"phase": "apps_stream_timing", "phase_s": phase_s,
         "kernel_launches": totals, "gpu": gpu_line})
    return records, totals, graph


# --- tools: the measurement tools (repas_tpu_torch.tools) and B5/B6 ------
TOOLS_ITERS = "3"
TOOLS_RC_N = "200000"
TOOL_LINE = re.compile(r"^(.*?)\s+(\S+) ms/frame\s+\(sum=([^)]*)\)")
PROFILE_NAMES = ["detect_tags (full)", "pointcloud", "full pipeline"]
MICRO_NAMES = [
    "bitcast(current)", "naive f32", "weighted+minor3sum", "u32pad",
    "reshape-mean(current)", "strided 4-add", "row then col",
    "reduce_window", "conv 2x2 s2", "vmap dynamic_slice f32",
    "vmap dynamic_slice bf16", "pallas DMA f32 aligned 200x384",
    "pallas DMA bf16 aligned 208x384", "xla dynamic_slice bf16",
    "pallas aligned DMA+rewindow", "pnp ippe x8", "depth_correct x8",
    "quat average", "fuse_tag_poses full", "ippe dist=None iters=8",
    "ippe dist=None iters=4", "ippe dist=None iters=2",
    "ippe dist=None iters=0", "ippe dist=zeros iters=8", "current (H*W,6)",
    "planar (6,H*W)"]


def run_tool(mod, argv):
    """mod.main(argv) in-process, its standard output captured, then
    printed; returns (seconds, its lines)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    if rc != 0:
        raise AssertionError(f"{mod.__name__} {argv} returned {rc}")
    return secs, buf.getvalue().splitlines()


def tool_times(lines, names, tool):
    """{name: [ms/frame, sum]} of a tool's timing lines; every name in
    `names` present, each time positive and each sum finite."""
    got = {}
    for ln in lines:
        m = TOOL_LINE.match(ln)
        if m:
            got[m.group(1).strip()] = [float(m.group(2)), float(m.group(3))]
    bad = [n for n in names if n not in got
           or not (got[n][0] > 0 and np.isfinite(got[n][1]))]
    if bad:
        raise AssertionError(f"{tool}: missing or bad lines {bad}")
    return got


def tools_phase(dev, gpu_line):
    """The measurement tools on the card: profile_stages (11 prefixes),
    micro_perf (every section), reconstruct_compare (200k points), each
    in-process with its launches counted; their lines checked; the
    integer stage prefixes on the card against the CPU port; B5 and B6
    held exactly against their plain versions at the inputs micro_perf
    gave them. Returns (B5 and B6's records, the phase's launches)."""
    from repas_tpu_torch.core.config import PipelineConfig
    from repas_tpu_torch.kernels import _build
    from repas_tpu_torch.tools import (micro_perf, profile_stages,
                                       reconstruct_compare)

    t0 = time.perf_counter()
    secs = {}
    _build.reset_launches()
    secs["profile_stages"], lines = run_tool(
        profile_stages, ["--iters", TOOLS_ITERS])
    prof = tool_times(lines, [f"prefix:{st}" for st in profile_stages.STAGES]
                      + PROFILE_NAMES, "profile_stages")
    with Capture(micro_perf, "extract_windows_blk", True) as c5, \
            Capture(micro_perf, "extract_windows_exact") as c6:
        secs["micro_perf"], lines = run_tool(
            micro_perf, [*micro_perf.SECTIONS, "--iters", TOOLS_ITERS])
    micro = tool_times(lines, MICRO_NAMES, "micro_perf")
    if "match: True" not in lines:
        raise AssertionError("micro_perf dmapatch2: B6 does not match the "
                             "plain gather")
    secs["reconstruct_compare"], lines = run_tool(
        reconstruct_compare, ["--n", TOOLS_RC_N])
    counts = dict(_build.launches)
    recon = [json.loads(ln) for ln in lines if ln.startswith('{"method"')]
    if ([r["method"] for r in recon] != ["fft_poisson_128", "fft_poisson_256",
                                         "ball_pivot"]
            or any(r["tris"] < 1 or not r["rmse_mm"] < 1.0 for r in recon)):
        raise AssertionError(f"reconstruct_compare: {recon}")
    low = [k for k in ("ccl", "patch_extract", "pointcloud", "patch_blk",
                       "patch_exact") if counts[k] < 1]
    if low:
        raise AssertionError(f"the tools did not launch {low}: {counts}")

    # the integer stage prefixes on the card against the CPU port
    rgbs, _, _ = profile_stages._frames(1, dev)
    det_cfg = PipelineConfig().detector
    for st in ("thresh", "ccl", "topk"):
        a = profile_stages._stage_prefix(rgbs, det_cfg, st)
        b = profile_stages._stage_prefix(rgbs.cpu(), det_cfg, st)
        if float(a) != float(b):
            raise AssertionError(f"profile_stages {st}: card {float(a)}, "
                                 f"CPU {float(b)}")

    if len(c5.calls) != 2 or c6.args is None:
        raise AssertionError("micro_perf did not call B5 twice and B6")
    records = []
    for (pyr, st, ph, pw, tile_h), _ in c5.calls:
        records.append(check_b5(
            f"B5 patch_blk ({str(pyr.dtype)[6:]} {tuple(pyr.shape)}, "
            f"{ph}x{pw} windows, tile {tile_h})", pyr, st, ph, pw, tile_h))
    (pyr, st, ph, pw), _ = c6.args
    records.append(check_b6(f"B6 patch_exact ({tuple(pyr.shape)}, {ph}x{pw} "
                            "windows)", pyr, st, ph, pw))
    check_b6_edges(pyr, ph, pw)
    for rec in records:
        rec["launches"] = counts[
            "patch_blk" if rec["name"].startswith("B5") else "patch_exact"]
    log({"phase": "tools", "seconds": secs, "profile_stages": prof,
         "micro_perf": micro, "reconstruct_compare": recon,
         "kernel_launches": counts, "gpu": gpu_line})
    log({"phase": "tools_timing", "phase_s": time.perf_counter() - t0,
         "gpu": gpu_line})
    return records, counts


# --- graft_entry: the port's entry points (repas_tpu_torch.graft_entry) ---
GRAFT_DRYRUN_N = (2, 8)
GRAFT_REPS = 10


def graft_dryrun(n, devices=None):
    """dryrun_multichip(n) with its printed line captured; returns
    (result, line)."""
    from repas_tpu_torch import graft_entry

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = graft_entry.dryrun_multichip(n, devices=devices)
    return res, buf.getvalue().strip().splitlines()[-1]


def graft_entry_phase(dev, gpu_line):
    """entry() and dryrun_multichip(2 and 8) on the card, each counted, and
    held against the CPU port. Returns the phase's B1-B3 launches."""
    from repas_tpu_torch import graft_entry

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    if any(a.device != dev for a in args):
        raise AssertionError(f"entry() frame on {[a.device for a in args]}")
    fn(*args)
    out, entry_counts = counted(lambda: fn(*args), "graft_entry entry()",
                                sync_error=True)
    ids, corners, _, anchor, pc = (x.cpu() for x in out)
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    ref = cpu_fn(*cpu_args)
    valid = ids >= 0
    fails = []
    if 9 not in ids[valid].tolist():
        fails.append(f"tag 9 not found: ids {ids.tolist()}")
    if not abs(float(anchor[2]) - TAG_Z) <= 0.005:
        fails.append(f"anchor z {float(anchor[2])}")
    if not torch.equal(ids, ref[0]):
        fails.append(f"ids {ids.tolist()} vs CPU {ref[0].tolist()}")
    cdiff = (corners - ref[1]).abs()[valid]
    corner_err = float(cdiff.max()) if cdiff.numel() else 0.0
    if not corner_err <= 1e-2:
        fails.append(f"corners {corner_err} px from the CPU")
    if tuple(pc.shape) != (6, H * W) or not bool(torch.isfinite(pc).all()):
        fails.append(f"pointcloud {tuple(pc.shape)}")
    if fails:
        raise AssertionError(f"graft_entry entry(): {fails}")
    step_ms = host_ms(lambda: fn(*args), GRAFT_REPS)
    ev_ms = cuda_ms(lambda: fn(*args), iters=GRAFT_REPS, warmup=1)
    log({"phase": "graft_entry", "entry_ids": ids.tolist(),
         "anchor_z_m": float(anchor[2]), "vs_cpu_corner_max_px": corner_err,
         "launches": entry_counts,
         "process_frame_ms_median": float(np.median(step_ms)),
         "process_frame_ms_all": step_ms,
         "process_frame_ms_cuda_events": ev_ms, "gpu": gpu_line})

    runs = [entry_counts]
    for n in GRAFT_DRYRUN_N:
        t = time.perf_counter()
        (res, line), counts = counted(lambda: graft_dryrun(n),
                                      f"dryrun_multichip({n})")
        secs = time.perf_counter() - t
        _, cpu_line = graft_dryrun(n, devices=["cpu"] * n)
        print(line, flush=True)
        if line != cpu_line:
            raise AssertionError(f"dryrun_multichip({n}): card {line!r}, "
                                 f"CPU {cpu_line!r}")
        log({"phase": "graft_dryrun", **res, "fused_pts": list(
            res["fused_pts"]), "launches": counts, "seconds": secs,
             "equal_to_cpu_line": True, "gpu": gpu_line})
        runs.append(counts)
    totals = {k: sum(c[k] for c in runs) for k in runs[0]}
    log({"phase": "graft_entry_timing", "phase_s": time.perf_counter() - t0,
         "kernel_launches": totals, "gpu": gpu_line})
    return totals


# --- compiled: the captured steps (repas_tpu_torch.core.jit) ---
# where a replayed float is not bit-equal to the eager step's, the output
# is named and held to the CPU port's tolerance against the JAX package
# (tests/test_torch_pipeline.py; a rotation entry's sin(0.25 degrees)):
# (atol, rtol); any other float must be bit-equal, integers equal
COMPILED_TOL = {"corners": (0.05, 0), "centers": (0.05, 0),
                "decision_margin": (0.25, 0), "R": (4.4e-3, 0),
                "R_avg": (4.4e-3, 0), "t": (1e-4, 0), "anchor_t": (1e-4, 0),
                "P_depth": (1e-4, 0), "anchor_P_depth": (1e-4, 0),
                "err_px": (2e-3, 0), "weights": (0, 0.02),
                "pointcloud": (1e-9, 1e-6)}
REPLAYS = 3                    # traced replays of each compiled step
TRACE_MARGIN_S = 0.02          # host sleep at each end of a traced window
TRACED_S = [0.0]               # seconds spent in traced() so far
QUEUED = 10                    # the bench's queued calls per host read
ENTRY_OUT = ("ids", "corners", "R_avg", "anchor_P_depth", "pointcloud")


def named_leaves(x, name="out"):
    """[(name, tensor)] of every tensor of a NamedTuple tree."""
    if torch.is_tensor(x):
        return [(name, x)]
    return [leaf for f, v in zip(x._fields, x)
            for leaf in named_leaves(v, f)]


def replay_vs_eager(got, want, what):
    """A compiled step's outputs against the eager step's, both
    [(name, tensor)]: integers and booleans equal, floats bit-equal (NaN
    equal to NaN) or, naming the output, within COMPILED_TOL. Returns
    {output: max abs difference} of the floats that differ (empty when
    every output is bit-equal)."""
    differ, fails = {}, []
    for (name, a), (_, b) in zip(got, want, strict=True):
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            fails.append(f"{name}: {tuple(a.shape)} {a.dtype} vs "
                         f"{tuple(b.shape)} {b.dtype}")
        elif not a.is_floating_point():
            if not torch.equal(a, b):
                fails.append(f"{name}: integers differ")
        elif not torch.equal(torch.nan_to_num(a, 7.0),
                             torch.nan_to_num(b, 7.0)):
            diff = (a - b).abs().nan_to_num(float("inf"))
            differ[name] = float(diff.max())
            atol, rtol = COMPILED_TOL.get(name, (0, 0))
            if not bool((diff <= atol + rtol * b.abs()).all()):
                fails.append(f"{name}: {differ[name]} over ({atol}, {rtol})")
    if fails:
        raise AssertionError(f"{what}, compiled vs eager: {fails}")
    return differ


def in_turns(fns, reps):
    """Host-clock ms of synchronized calls of each fn, the fns called in
    turn `reps` times: {name: [ms, ...]}."""
    out = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            out[k] += host_ms(fn, 1)
    return out


def queued_fps(fn, frames):
    """Frames/s of QUEUED queued calls of fn ended by one host read (the
    bench's loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(QUEUED):
        out = fn()
    out.pose.anchor_P_depth.cpu()
    return frames * QUEUED / (time.perf_counter() - t0)


def compiled_pipeline(name, dev, gpu_line, rgbs, depths, K, cfg, dist=None):
    """pipeline.process_frames_jit against process_frames at batch 16: the
    capture's seconds and memory, one replay under sync-error mode (no
    wrapper launch), outputs against the eager step's, REPLAYS replays
    traced (B1-B3 once each per replay on the device, seen by name),
    eager and compiled times."""
    from repas_tpu_torch import pipeline
    from repas_tpu_torch.kernels import _build

    step = pipeline.process_frames_jit

    def eager():
        return pipeline.process_frames(rgbs, depths, K, cfg, dist=dist)

    def compiled():
        return step(rgbs, depths, K, cfg, dist=dist)

    want = eager()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    graphs0 = len(step.graphs)
    _build.reset_launches()
    t = time.perf_counter()
    compiled()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    first = {k: _build.launches[k] for k in PIPELINE_KEYS}
    reserved1 = torch.cuda.memory_reserved(dev)
    if len(step.graphs) != graphs0 + 1:
        raise AssertionError(f"{name}: {len(step.graphs) - graphs0} graphs "
                             "captured, expected 1")
    got, counts = counted(compiled, f"{name} replay", need=(),
                          sync_error=True)
    if any(counts.values()):
        raise AssertionError(f"{name}: a replay launched {counts} outside "
                             "its graph")
    differ = replay_vs_eager(named_leaves(got), named_leaves(want), name)
    replays, seen = replays_traced(compiled, name)
    prof = {"eager": device_profile(eager, top=10),
            "compiled": device_profile(compiled, top=10)}
    entry = step.graphs[step.key(rgbs, depths, K, cfg, dist=dist)]
    clone_ms = cuda_ms(lambda: [t.clone() for t in entry.static_out],
                       iters=STEPS, warmup=1, queued=True)
    ms = in_turns({"eager": eager, "compiled": compiled}, STEPS)
    ev = {"eager": cuda_ms(eager, iters=STEPS, warmup=1),
          "compiled": cuda_ms(compiled, iters=STEPS, warmup=1)}
    fps = {"eager": queued_fps(eager, BATCH),
           "compiled": queued_fps(compiled, BATCH)}
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log({"phase": name, "batch": BATCH, "capture_s": capture_s,
         "first_call_launches": first,
         "traced_replays": REPLAYS, "replay_device_launches": replays,
         "floats_not_bit_equal": differ, "device_profile": prof,
         "kernels_seen": seen, "step_ms_median": med, "step_ms_all": ms,
         "step_ms_cuda_events": ev,
         "frames_per_s_synced": {k: BATCH * 1e3 / v for k, v in med.items()},
         "frames_per_s_queued": fps, "output_clone_device_ms": clone_ms,
         "reserved_bytes_before_capture": reserved0,
         "reserved_bytes_after_capture": reserved1,
         "graph_reserved_bytes": reserved1 - reserved0, "gpu": gpu_line})
    return {"step_ms": med, "cuda_events_ms": ev, "queued_fps": fps,
            "graph_reserved_bytes": reserved1 - reserved0,
            "replay_device_launches": replays}


def compiled_entry(dev, gpu_line):
    """entry()'s batch-1 720p process_frame compiled with jit against the
    plain step: bit-equal, a replay under sync-error mode without wrapper
    launches, B1-B3 once per traced replay on the device, ms each."""
    from repas_tpu_torch import graft_entry
    from repas_tpu_torch.core.jit import jit

    fn, args = graft_entry.entry()
    cfn = jit(fn)
    want = fn(*args)
    cfn(*args)                                   # capture
    got, counts = counted(lambda: cfn(*args), "compiled entry()", need=(),
                          sync_error=True)
    if any(counts.values()):
        raise AssertionError(f"compiled entry(): a replay launched {counts} "
                             "outside its graph")
    replays, _ = replays_traced(lambda: cfn(*args), "compiled entry()")
    differ = replay_vs_eager(list(zip(ENTRY_OUT, got)),
                             list(zip(ENTRY_OUT, want)), "compiled entry()")
    ms = in_turns({"eager": lambda: fn(*args),
                   "compiled": lambda: cfn(*args)}, STEPS)
    ev = {"eager": cuda_ms(lambda: fn(*args), iters=STEPS, warmup=1),
          "compiled": cuda_ms(lambda: cfn(*args), iters=STEPS, warmup=1)}
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log({"phase": "compiled_entry", "ids": got[0].tolist(),
         "traced_replays": REPLAYS, "replay_device_launches": replays,
         "floats_not_bit_equal": differ,
         "process_frame_ms_median": med, "process_frame_ms_all": ms,
         "process_frame_ms_cuda_events": ev, "gpu": gpu_line})
    return {"ms": med, "cuda_events_ms": ev,
            "replay_device_launches": replays}


def compiled_tracker(dev, gpu_line):
    """The calibrated_tracking phase's 35-frame stream through two
    trackers in turn, frame by frame: one with the compiled steps
    (TagTracker's own) and one with the plain functions in their place.
    Modes and poses equal, one device read per compiled track step and
    no launch outside the graphs (the tracker phase traces B1/B2 once per
    track step on the device), ms per track and register step each."""
    from repas_tpu_torch.detect.detector import detect_tags
    from repas_tpu_torch.kernels import _build
    from repas_tpu_torch.pose import track
    from repas_tpu_torch.pose.pnp import solve_pnp_ippe_square

    frames, _ = tracker_stream()

    def tracker():
        return track.TagTracker(ROBUST_K, tag_size=TRACK_TAG, device=dev)

    warm = tracker()                       # captures the steps' graphs
    for f in frames[:3]:
        warm.step(f)
    eager, comp = tracker(), tracker()
    eager._track, eager._detect, eager._ippe = (
        track._track_roi, detect_tags, solve_pnp_ippe_square)
    steps = []
    for i, f in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = eager.step(f)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        before = dict(_build.launches)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                b = comp.step(f)
                comp_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if (a.mode, a.ok, a.tag_id) != (b.mode, b.ok, b.tag_id) or not (
                np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t)
                and (a.err_px == b.err_px or not np.isfinite(a.err_px))):
            raise AssertionError(f"tracker step {i}: compiled {b} vs eager "
                                 f"{a}")
        steps.append({"mode": b.mode, "eager_ms": eager_ms,
                      "compiled_ms": comp_ms,
                      "syncs": len(sync_warnings(caught)),
                      **{k: _build.launches[k] - before[k]
                         for k in ("ccl", "patch_extract")}})
    modes = [s["mode"] for s in steps]
    if modes != TRACK_MODES:
        raise AssertionError(f"compiled tracker modes {modes}")
    tracked = [s for s in steps if s["mode"] == "track"]
    if any(s["ccl"] or s["patch_extract"] for s in steps) or any(
            s["syncs"] != 1 for s in tracked) or \
            max(s["syncs"] for s in steps) > 2:
        raise AssertionError(
            "compiled tracker steps (wrapper B1, B2, syncs): "
            f"{[(s['ccl'], s['patch_extract'], s['syncs']) for s in steps]}")
    regs = [s for s in steps if s["mode"] == "register"]
    med = {f"{m}_{k}": float(np.median([s[f"{k}_ms"] for s in group]))
           for m, group in (("track", tracked), ("register", regs))
           for k in ("eager", "compiled")}
    log({"phase": "compiled_tracker", "frames": len(frames), "modes": modes,
         "poses_bit_equal": True, "syncs": [s["syncs"] for s in steps],
         "wrapper_launches_ccl": [s["ccl"] for s in steps],
         "wrapper_launches_patch_extract": [s["patch_extract"]
                                            for s in steps],
         "ms_median": med,
         "track_ms_all": {k: [s[f"{k}_ms"] for s in tracked]
                          for k in ("eager", "compiled")},
         "gpu": gpu_line})
    return med


# the ladder's kernels as their device functions' names show in a trace:
# B1 runs the band CCL in cluster mode at the ladder's stage A and B
# shapes, B4 in grid mode on stage C's full frames (the lines of
# check_b1 and check_b4 print each plan)
LADDER_KEYS = ("ccl", "patch_extract", "ccl_tiled")
LADDER_NAMES = {"ccl": ("ccl_band", "ClusterScope"),
                "patch_extract": ("window_copy",),
                "ccl_tiled": ("ccl_band", "GridScope")}
# a set on which stage B runs 4 waves (7 frames left by stage A) and
# stage C 2 waves (the 3 tagless frames): robust_frames() indices
MULTI_WAVE = [4, 7, 5, 7, 4, 7, 0, 5]


@contextlib.contextmanager
def eager_steps(*steps):
    """The plain functions (each compiled step's ``.fn``) in place of the
    compiled steps named by (module, attribute) pairs."""
    saved = [(m, n, getattr(m, n)) for m, n in steps]
    for m, n, f in saved:
        setattr(m, n, f.fn)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def ladder_steps():
    """(module, attribute) of every compiled step of the ladder, of
    detect_tags_robust and of the bench's pose."""
    from repas_tpu_torch import bench
    from repas_tpu_torch.detect import robust

    return [(robust, n) for n in ("_stage_a", "_stage_b", "_stage_c",
                                  "_enhance_stack", "_detect_batch",
                                  "_merge_jit")] + [(bench, "pose_batch")]


def trace_counts(names, table):
    """{key: device functions in `names` whose name holds every part of
    table[key]}."""
    return {k: sum(all(p in n for p in v) for n in names)
            for k, v in table.items()}


def stage_waves(frames, cfg):
    """(stage B's waves, stage C's waves) the eager ladder runs on
    `frames`: ceil(frames each stage escalates / k)."""
    from repas_tpu_torch.detect import robust

    k = min(robust._ESC_K, frames.shape[0])
    det, found, grays, rois, rscores = robust._stage_a.fn(frames, cfg)
    n_b = int((~found).sum())
    _, found_b = robust._stage_b.fn(grays, det, found, rois, rscores, cfg)
    return -(-n_b // k), -(-int((~found_b).sum()) // k)


def ladder_leaves(out):
    det, best, t, err = out
    return named_leaves(det) + [("best", best), ("t", t), ("err_px", err)]


def compiled_ladder_set(name, dev, gpu_line, frames, K, cfg, tag, want_ids):
    """ladder_and_pose compiled against its eager run on one frame set:
    waves per stage, the capture (wrapper launches of its warm-up and
    capture, seconds, graph memory), a replay with synchronizing calls
    raising and no wave test, outputs equal to eager, REPLAYS replays
    traced (B1, B2 and B4 on the device in each), eager and compiled ms
    in turns."""
    from repas_tpu_torch.detect import robust

    waves = stage_waves(frames, cfg)

    def eager():
        with eager_steps(*ladder_steps()):
            return ladder_and_pose(frames, K, cfg, tag)

    def compiled():
        return ladder_and_pose(frames, K, cfg, tag)

    robust.host_reads["wave_tests"] = 0
    want = eager()
    torch.cuda.synchronize()
    eager_tests = robust.host_reads["wave_tests"]
    for m, n in ladder_steps():
        getattr(m, n).clear()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    t = time.perf_counter()
    _, first = counted(compiled, f"{name} capture", need=LADDER_KEYS)
    capture_s = time.perf_counter() - t
    reserved1 = torch.cuda.memory_reserved(dev)
    robust.host_reads["wave_tests"] = 0
    got, counts = counted(compiled, f"{name} replay", need=(),
                          sync_error=True)
    replay_tests = robust.host_reads["wave_tests"]
    if any(counts.values()) or replay_tests:
        raise AssertionError(f"{name}: a replay launched {counts} outside "
                             f"its graphs, {replay_tests} wave tests")
    differ = replay_vs_eager(ladder_leaves(got), ladder_leaves(want), name)
    det, best = got[0], got[1]
    rows = torch.arange(frames.shape[0], device=dev)
    ids = torch.where(det.valid[rows, best], det.ids[rows, best], -1)
    if ids.tolist() != [-1 if i is None else i for i in want_ids]:
        raise AssertionError(f"{name}: best ids {ids.tolist()}")
    _, wrapped, _, names = traced(lambda: [compiled()
                                           for _ in range(REPLAYS)])
    device = trace_counts(names, LADDER_NAMES)
    if any(wrapped.values()) or any(device[k] < REPLAYS
                                     for k in LADDER_KEYS):
        raise AssertionError(
            f"{name}: {REPLAYS} replays launched {device} on the device, "
            f"wrappers {wrapped}; kernels "
            f"{sorted({n[:80] for n in names if 'ccl' in n})}")
    ms = in_turns({"eager": eager, "compiled": compiled}, STEPS)
    ev = {"eager": cuda_ms(eager, iters=STEPS, warmup=1),
          "compiled": cuda_ms(compiled, iters=STEPS, warmup=1)}
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log({"phase": name, "frames": frames.shape[0],
         "stage_waves_b_c": waves, "eager_wave_tests": eager_tests,
         "capture_s": capture_s, "capture_launches": first,
         "graph_reserved_bytes": reserved1 - reserved0,
         "replay_wave_tests": replay_tests, "floats_not_bit_equal": differ,
         "best_ids": ids.tolist(), "traced_replays": REPLAYS,
         "replay_device_launches": device,
         "replay_kernels": len(names) / REPLAYS,
         "kernels_seen": sorted({n[:80] for n in names
                                 if "ccl" in n or "window" in n}),
         "call_ms_median": med, "call_ms_all": ms, "call_ms_cuda_events": ev,
         "frames_per_s": {k: frames.shape[0] * 1e3 / v
                          for k, v in med.items()}, "gpu": gpu_line})
    return {"waves": waves, "ms": med, "cuda_events_ms": ev,
            "graph_reserved_bytes": reserved1 - reserved0,
            "replay_device_launches": device}


def eager_single(img):
    """detect_tags_robust on its plain pieces."""
    from repas_tpu_torch.detect import robust

    with eager_steps(*ladder_steps()):
        return robust.detect_tags_robust(img)


def compiled_ladder(dev, gpu_line):
    """The compiled ladder + pose (the bench's robust workload) against
    the eager one on the 8-frame set and on the multi-wave set, then
    detect_tags_robust compiled on one frame against its eager run (B4 in
    its replay's trace). Frees the graphs after."""
    from repas_tpu_torch.core.config import DetectorConfig, PnPConfig
    from repas_tpu_torch.detect import robust

    frames_np = robust_frames()
    K = torch.from_numpy(ROBUST_K).to(dev)
    cfg, tag = DetectorConfig(), PnPConfig().tag_size_m
    out = {}
    for name, idx in (("compiled_ladder", list(range(ROBUST_BATCH))),
                      ("compiled_ladder_multi_wave", MULTI_WAVE)):
        frames = torch.from_numpy(frames_np[idx]).to(dev)
        out[name] = compiled_ladder_set(name, dev, gpu_line, frames, K, cfg,
                                        tag, [ROBUST_IDS[i] for i in idx])
    b, c = out["compiled_ladder_multi_wave"]["waves"]
    if b < 2 or c < 2:
        raise AssertionError(f"the multi-wave set ran {b} and {c} waves in "
                             "stages B and C")
    for m, n in ladder_steps():
        getattr(m, n).clear()

    img = torch.from_numpy(frames_np[0]).to(dev)
    want = eager_single(img)
    _, first = counted(lambda: robust.detect_tags_robust(img),
                       "compiled detect_tags_robust capture",
                       need=LADDER_KEYS)
    got, counts = counted(lambda: robust.detect_tags_robust(img),
                          "compiled detect_tags_robust replay", need=(),
                          sync_error=True)
    differ = replay_vs_eager(named_leaves(got), named_leaves(want),
                             "compiled detect_tags_robust")
    _, wrapped, _, names = traced(lambda: robust.detect_tags_robust(img))
    device = trace_counts(names, LADDER_NAMES)
    if any(counts.values()) or any(wrapped.values()) or \
            device["ccl_tiled"] < 1 or 9 not in got.ids[got.valid].tolist():
        raise AssertionError(f"compiled detect_tags_robust: ids "
                             f"{got.ids.tolist()}, replay wrappers {counts}, "
                             f"traced {device} (wrappers {wrapped})")
    ms = in_turns({"eager": lambda: eager_single(img),
                   "compiled": lambda: robust.detect_tags_robust(img)},
                  STEPS)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log({"phase": "compiled_robust_single", "ids": got.ids.tolist(),
         "capture_launches": first, "replay_device_launches": device,
         "floats_not_bit_equal": differ, "ms_median": med,
         "gpu": gpu_line})
    out["compiled_robust_single"] = {"ms": med,
                                     "replay_device_launches": device}
    for m, n in ladder_steps():
        getattr(m, n).clear()
    torch.cuda.empty_cache()
    return out


SHARDS = (2, 8)


def compiled_sharded(dev, gpu_line):
    """sharded_frame_pipeline(process_frames) over cuda:0 named n times at
    720p, batch 16, for n in SHARDS: one compiled step per shard (n
    graphs), a replay under sync-error mode without wrapper launches,
    outputs bit-equal to the eager sharded step's (the steps' plain
    functions) and to the unsharded step's, B1-B3 n times each in a
    traced call, ms against the unsharded step eager and compiled."""
    from repas_tpu_torch import pipeline
    from repas_tpu_torch.core.config import PipelineConfig
    from repas_tpu_torch.parallel import (frames_mesh, mesh as mesh_mod,
                                          shard_batch, sharded_frame_pipeline)

    rgbs_np, depths_np, K_np = bench_frames(BATCH)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    depths = torch.from_numpy(depths_np).to(dev)
    K = torch.from_numpy(K_np).to(dev)
    cfg = PipelineConfig()
    fn = lambda r, d: pipeline.process_frames(r, d, K, cfg)  # noqa: E731
    single = named_leaves(fn(rgbs, depths))
    out = {}
    for n in SHARDS:
        mesh = frames_mesh(devices=[dev] * n)
        run = sharded_frame_pipeline(fn, mesh)
        orig = mesh_mod.jit
        mesh_mod.jit = lambda f, **_: f
        try:
            eager_run = sharded_frame_pipeline(fn, mesh)
        finally:
            mesh_mod.jit = orig

        def call(r=run, m=mesh):
            return r(shard_batch(rgbs, m), shard_batch(depths, m))

        want = named_leaves(call(eager_run))
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t
        reserved1 = torch.cuda.memory_reserved(dev)
        graphs = [len(step.graphs) for step in run.steps]
        got, counts = counted(call, f"compiled sharded step n={n}",
                              need=(), sync_error=True)
        if any(counts.values()) or graphs != [1] * n:
            raise AssertionError(f"sharded n={n}: graphs per shard {graphs}"
                                 f", a replay launched {counts}")
        got = named_leaves(got)
        replay_vs_eager(got, want, f"compiled sharded step n={n}")
        differ = replay_vs_eager(got, single, f"sharded n={n} vs unsharded")
        _, wrapped, device, _ = traced(call)
        if any(wrapped.values()) or \
                device != {k: n for k in PIPELINE_KEYS}:
            raise AssertionError(f"sharded n={n}: a traced call launched "
                                 f"{device}, wrappers {wrapped}")
        ms = in_turns({"sharded_eager": lambda: call(eager_run),
                       "sharded_compiled": call,
                       "unsharded_eager": lambda: fn(rgbs, depths),
                       "unsharded_compiled": lambda: pipeline.
                       process_frames_jit(rgbs, depths, K, cfg)}, STEPS)
        med = {k: float(np.median(v)) for k, v in ms.items()}
        log({"phase": "compiled_sharded", "shards": n, "batch": BATCH,
             "mesh_devices": [str(x) for x in mesh.devices],
             "graphs_per_shard": graphs, "capture_s": capture_s,
             "graph_reserved_bytes": reserved1 - reserved0,
             "equal_to_eager_sharded": True,
             "vs_unsharded_not_bit_equal": differ,
             "traced_device_launches": device, "step_ms_median": med,
             "step_ms_all": ms, "gpu": gpu_line})
        out[n] = {"ms": med, "replay_device_launches": device}
        for step in run.steps:
            step.clear()
    pipeline.process_frames_jit.clear()
    torch.cuda.empty_cache()
    return out


def compiled_phase(dev, gpu_line):
    """The captured steps (repas_tpu_torch.core.jit) against the eager
    ones: the batch-16 pipeline on the bench frame and with the lens's
    coefficients, entry()'s batch-1 frame, the tracker's stream. Frees
    the pipeline's graphs after."""
    from repas_tpu_torch import pipeline
    from repas_tpu_torch.core.config import PipelineConfig, PnPConfig

    t0, traced0 = time.perf_counter(), TRACED_S[0]
    rgbs_np, depths_np, K_np = bench_frames(BATCH)
    pipe = compiled_pipeline(
        "compiled_pipeline", dev, gpu_line, torch.from_numpy(rgbs_np).to(dev),
        torch.from_numpy(depths_np).to(dev), torch.from_numpy(K_np).to(dev),
        PipelineConfig())
    rgbs_np, depths_np, _, _ = distorted_frames(BATCH)
    dist = compiled_pipeline(
        "compiled_distorted_pipeline", dev, gpu_line,
        torch.from_numpy(rgbs_np).to(dev), torch.from_numpy(depths_np).to(dev),
        torch.from_numpy(DIST_K).to(dev),
        PipelineConfig(pnp=PnPConfig(tag_size_m=DIST_TAG)),
        dist=torch.from_numpy(DIST).to(dev))
    pipeline.process_frames_jit.clear()
    torch.cuda.empty_cache()
    entry = compiled_entry(dev, gpu_line)
    tracker = compiled_tracker(dev, gpu_line)
    ladder = compiled_ladder(dev, gpu_line)
    sharded = compiled_sharded(dev, gpu_line)
    replays = {k: sum(x["replay_device_launches"][k]
                      for x in (pipe, dist, entry, *sharded.values()))
               for k in PIPELINE_KEYS}
    for k in LADDER_KEYS:
        replays[k] = replays.get(k, 0) + sum(
            x["replay_device_launches"][k] for x in ladder.values())
    log({"phase": "compiled", "pipeline": pipe, "distorted_pipeline": dist,
         "entry": entry, "tracker_ms": tracker, "ladder": ladder,
         "sharded": sharded,
         "replay_device_launches": replays,
         "traced_s": TRACED_S[0] - traced0,
         "phase_s": time.perf_counter() - t0, "gpu": gpu_line})
    return replays


# --- bench: the port's headline benchmark (repas_tpu_torch.bench) ---
# the bench's registration extra runs only with 240 s of its budget left
# after the headline, the CPU probe and the ladder (bench.py's gate)
BENCH_BUDGET_S = "400"
BENCH_TIMEOUT_S = 480


def bench_phase(dev, gpu_line):
    """The bench's headline loop (every process_frames_jit call after the
    warm one with synchronizing CUDA calls raising) and its ladder
    in-process, counted, the headline loop again traced (every call a
    replay running B1-B3 once on the device), then ``python -m
    repas_tpu_torch.bench`` once. Returns the phase's wrapper launches
    and the traced loop's device launches."""
    from repas_tpu_torch import bench
    from repas_tpu_torch.core.jit import WARMUP

    t0 = time.perf_counter()
    orig = bench.process_frames_jit
    graphs0 = len(orig.graphs)
    calls = []

    def sync_free(*args, **kwargs):
        calls.append(None)
        if len(calls) == 1:     # the warm call captures the step's graph
            return orig(*args, **kwargs)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    bench.process_frames_jit = sync_free
    try:
        fps, pipe_counts = counted(
            lambda: bench._time_pipeline(BATCH, bench.ITERS, device=dev),
            "the bench's headline loop")
    finally:
        bench.process_frames_jit = orig
    # the wrappers count a capture's warm-up and the capture; a replay
    # launches nothing outside its graph
    want = (WARMUP + 1) * (len(orig.graphs) - graphs0)
    low = {k: pipe_counts[k] for k in PIPELINE_KEYS if pipe_counts[k] != want}
    if low:
        raise AssertionError(f"the headline loop's {bench.ITERS + 1} calls "
                             f"launched {low}, expected {want}")
    calls, traced0 = bench.ITERS + 1, TRACED_S[0]
    _, wrapped, replays, _ = traced(
        lambda: bench._time_pipeline(BATCH, bench.ITERS, device=dev))
    if any(wrapped.values()) or replays != {k: calls for k in PIPELINE_KEYS}:
        raise AssertionError(f"the traced headline loop's {calls} calls "
                             f"launched {replays} on the device, wrappers "
                             f"{wrapped}")
    (robust_fps, n_found), ladder_counts = counted(
        lambda: bench._time_robust_ladder(dev), "the bench's ladder",
        need=("ccl", "patch_extract", "ccl_tiled"))
    if n_found != ROBUST_BATCH - 1:
        raise AssertionError(f"the bench's ladder found {n_found} valid "
                             f"best slots, expected {ROBUST_BATCH - 1}")
    log({"phase": "bench_in_process", "headline_fps": fps,
         "headline_step": "pipeline.process_frames_jit (CUDA graph)",
         "launches_headline": pipe_counts,
         "traced_headline_device_launches": replays,
         "traced_s": TRACED_S[0] - traced0,
         "robust_synth_fps": robust_fps,
         "robust_tags_found": n_found, "launches_ladder": ladder_counts,
         "gpu": gpu_line})

    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repas_tpu_torch.bench"], capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S, cwd=bench.ROOT,
        env=dict(os.environ, REPAS_BENCH_BUDGET_S=BENCH_BUDGET_S))
    secs = time.perf_counter() - t
    print(proc.stdout.strip(), flush=True)
    if proc.stderr.strip():
        print("\n".join(proc.stderr.strip().splitlines()[-5:]), flush=True)
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    fails = []
    if proc.returncode != 0 or len(lines) != 2:
        fails.append(f"exit {proc.returncode}, {len(lines)} JSON lines")
    else:
        head, last = lines
        keys = list(bench._record(1.0, None, None, None))
        if list(head) != keys or list(last) != keys:
            fails.append(f"keys {list(head)} / {list(last)}")
        if head["metric"] != "detect_pnp_pointcloud_720p" or not (
                head["value"] > 0):
            fails.append(f"headline {head}")
        cpu, value, vs = last["cpu_fps"], last["value"], last["vs_baseline"]
        # the line holds value and cpu_fps rounded to 2 and 3 decimals and
        # vs_baseline from the unrounded pair: equal within those roundings
        if not (cpu and cpu > 0 and last["cpu_fps_cached"] is False
                and abs(vs - value / cpu)
                <= 0.005 + vs * (0.005 / value + 0.0005 / cpu)):
            fails.append(f"cpu_fps {cpu}, vs_baseline {vs}")
        if last["robust_tags_found"] != ROBUST_BATCH - 1:
            fails.append(f"robust_tags_found {last['robust_tags_found']}")
        if last["registration_1m_status"] != "ok":
            fails.append(f"registration {last['registration_1m_status']}")
        if last["device"] != gpu_line:
            fails.append(f"device {last['device']!r}")
    if fails:
        raise AssertionError(f"python -m repas_tpu_torch.bench: {fails}")
    totals = {k: pipe_counts[k] + ladder_counts[k] for k in pipe_counts}
    log({"phase": "bench", "subprocess_s": secs,
         "phase_s": time.perf_counter() - t0, "host_cpus": os.cpu_count(),
         "host_cpus_usable": len(os.sched_getaffinity(0)),
         "kernel_launches": totals, "graph_launches": replays,
         "gpu": gpu_line})
    return totals, replays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Smoke run of the port on one "
                                "NVIDIA GPU (see the module docstring).")
    p.add_argument("--keep", help="copy the cad_chain phase's clouds, pose "
                   "and sidecars into this directory")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    from repas_tpu_torch.core.config import PipelineConfig
    from repas_tpu_torch.kernels import _build, ccl_cuda, patch_extract
    from repas_tpu_torch import pipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    gpu_line = smi.stdout.strip().splitlines()[0]
    log(gpu_line)

    dev = torch.device("cuda", 0)
    dev_name = torch.cuda.get_device_name(0)
    # conditional graph nodes (the compiled ladder's waves) need CUDA 12.4
    # or later in the runtime and the driver
    drv = subprocess.run(["nvidia-smi"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    log({"torch": torch.__version__, "cuda": torch.version.cuda,
         "driver": re.search(r"Driver Version: *(\S+)", drv).group(1),
         "driver_cuda": re.search(r"CUDA Version: *(\S+)", drv).group(1),
         "device": dev_name})

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log({"phase": "build", "library": str(lib.name),
         "seconds": time.perf_counter() - t0,
         "nvcc_seconds": _build.build_seconds})
    if _build.build_log:
        print(_build.build_log.strip(), flush=True)

    rgbs_np, depths_np, K_np = bench_frames(BATCH)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    depths = torch.from_numpy(depths_np).to(dev)
    K = torch.from_numpy(K_np).to(dev)
    cfg = PipelineConfig()

    with torch.no_grad():
        # warm-up run that records each kernel's main-path inputs
        with Capture(ccl_cuda, "connected_components_cuda") as c1, \
                Capture(patch_extract, "extract_windows") as c2, \
                Capture(pipeline, "fused_pointcloud") as c3:
            pipeline.process_frames(rgbs, depths, K, cfg)
            torch.cuda.synchronize()
        captured = {"ccl": c1.args, "patch_extract": c2.args,
                    "pointcloud": c3.args}
        missing = [k for k, v in captured.items() if v is None]
        if missing:
            raise AssertionError(f"main path never called {missing}")
        records = check_kernels(captured)

        # the main path, counted, with any host sync inside it an error
        out, counts = counted(
            lambda: pipeline.process_frames(rgbs, depths, K, cfg),
            "the main path", sync_error=True)
        keys = {"B1 ccl": "ccl", "B2 patch_extract": "patch_extract",
                "B3 pointcloud": "pointcloud"}
        for rec in records:
            rec["launches"] = counts[keys[rec["name"]]]

        out_cpu0 = pipeline.process_frames(rgbs[:1].cpu(), depths[:1].cpu(),
                                           K_np, cfg)
        check_results(out, out_cpu0, dev_name)

        # step time: host clock around synchronized steps, and CUDA events
        step_ms = []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipeline.process_frames(rgbs, depths, K, cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        ev_ms = cuda_ms(lambda: pipeline.process_frames(rgbs, depths, K, cfg),
                        iters=STEPS, warmup=1)
    med = float(np.median(step_ms))
    log({"phase": "pipeline", "batch": BATCH, "height": H, "width": W,
         "step_ms_median": med, "step_ms_all": step_ms,
         "step_ms_cuda_events": ev_ms, "frames_per_s": BATCH * 1e3 / med,
         "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})

    with torch.no_grad():
        # the eager ladder: the compiled phase holds the compiled one
        # against it
        with eager_steps(*ladder_steps()):
            records += robust_phase(dev, gpu_line)
        records += calibrated_tracking_phase(dev, gpu_line, records)
        k3_records, k2_shapes = compiled_pose_phase(dev, gpu_line, rgbs,
                                                    depths, K)
        records += k3_records
        reg_records = registration_phase(dev, gpu_line)
        for rec in reg_records:
            if rec["name"] == "K2 kabsch3":
                rec["at_other_shapes"] = k2_shapes
        records += reg_records
        records += cad_chain_phase(dev, gpu_line, args.keep)
        counts = canopy_calib_eval_phase(dev, gpu_line)
        apps_records, apps_counts, apps_graph = apps_stream_phase(dev,
                                                                  gpu_line)
        records += apps_records
        tools_records, tools_counts = tools_phase(dev, gpu_line)
        records += tools_records
        graft_counts = graft_entry_phase(dev, gpu_line)
        compiled_graph = compiled_phase(dev, gpu_line)
        bench_counts, bench_graph = bench_phase(dev, gpu_line)
    keys = {"B1": "ccl", "B2": "patch_extract", "B3": "pointcloud",
            "B4": "ccl_tiled", "B5": "patch_blk", "B6": "patch_exact",
            "K1": "eig3", "K2": "kabsch3", "K3": "eig9",
            "K4": "grid_query"}
    for rec in records:
        key = keys[rec["name"][:2]]
        rec["launches_canopy_calib_eval"] = counts[key]
        rec["launches_apps_stream"] = apps_counts[key]
        rec["launches_tools"] = tools_counts[key]
        rec["launches_graft_entry"] = graft_counts[key]
        rec["launches_bench"] = bench_counts[key]
        # launches inside replayed graphs, counted in the traces
        for phase, graph in (("apps_stream", apps_graph),
                             ("compiled", compiled_graph),
                             ("bench", bench_graph)):
            if key in graph:
                rec[f"graph_launches_{phase}"] = graph[key]

    log({"kernels": records})
    log({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
