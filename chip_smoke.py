#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``orbslam3_byzyh_tpu_torch/csrc`` with nvcc
(one process each, in parallel: K1-K3 and P1) and drives the port's entry
points through them:

  * ``graft.tracking_step`` (480x640, 1024 features, 4096 landmarks) on a
    scene that tracks (the example image against a map lifted from its own
    features);
  * ``graft.mono_frame_step`` at the EuRoC monocular configuration
    (752x480 + radtan, 1200 features, 65536 landmark and 1024 keyframe
    slots, the local window engaged) on ``graft.euroc_mono_scene``, in its
    normal case (motion model) and its retry case (the widened retry from
    the last pose), and the reference-keyframe fallback on the retry scene;
  * ``graft.mono_keyframe_step`` (the per-keyframe mapping bundle:
    triangulation against 3 covisible keyframes through K2's epipolar mode,
    duplicate fusion through K2's window mode over all 65536 landmark
    slots, the windowed Schur BA, culling) on ``graft.euroc_mono_map`` at
    the same capacity, in its normal case and its full case (the capacity
    valve retires landmarks and the slot allocation recycles them); each
    planted stage must fire, the result must agree with the CPU plain path,
    and the synchronisations with the host inside the step are counted;
  * ``graft.mono_initialize`` (the monocular initial map: K2's window mode
    at level 0, the two-view H/F RANSAC, the full-map BA over every one of
    the 1024 keyframe and 65536 landmark slots with the scatter Schur
    assembly) from the empty map against ``graft.euroc_mono_two_view``'s
    second frame, in its general case (F must win), planar case (H must
    win) and rotation case (it must fail and leave the map as it was); the
    CPU plain path with the indices the card drew must agree, and the
    synchronisations and host reads are counted and printed;
  * the monocular system, ``pipeline.system.MonoSlam.track`` frame by frame
    (phase "10 system"), on the golden frames (``graft.golden_frames()``,
    the 45 frames of the golden regression run): (a) the frozen golden
    config, held to the golden gate (at least 42 frames, Horn-scaled ATE
    under 0.0149 m); (b) the EuRoC-mono capacity (1024 keyframe and 65536
    landmark slots, 12 observations, the 20 + 4 keyframe / 4096 landmark
    window) on the frames padded to 752x480, held to test_e2e_mono.py's
    gate (more than 32 frames, ATE under 0.15 m), and once with EuRoC's
    1200 features (reported); (c) 16 keyframe slots, where the forced
    culling, the compaction and the trajectory rebase must fire while the
    map stays consistent. Every kernel launch of the first sequence of (a)
    and (b) is held against its plain version; (a) and (b) are then timed
    as whole sequences (per frame kind: track()'s host-clock time, K1-K3
    launches, synchronisations).

  * phase "11 stereo": K3s (K3's stereo launcher) against its plain version
    at KITTI's 2000 points; ``graft.stereo_frame_step`` at the KITTI stereo
    configuration (1241x376, bf 386.1, 2000 features, 65536 landmark and
    1024 keyframe slots) on ``graft.kitti_stereo_pair`` (a 32 px shift)
    against ``graft.kitti_stereo_scene``, in both cases: the disparities,
    one K3 and one K3s launch with the stereo rows, the pose, no
    synchronisation, the CPU plain path, 50 timed calls; then the systems
    on the committed stereo frames (``graft.stereo_frames()``): (a)
    ``StereoSlam`` at tests/test_stereo_system.py's config and its gate,
    (b) ``StereoSlam`` at KITTI's size and capacity, (c) ``RgbdSlam`` at
    TUM1's settings against the JAX RgbdSlam's recorded run; every launch
    of each first sequence held against its plain version, two timed
    sequences each, per frame kind as phase 10.

  * phase "12 inertial": the stereo-inertial device path at the EuRoC
    stereo-inertial configuration (752x480 rectified, bf 48.02, ThDepth 60,
    1200 features, 200 Hz IMU, 1024 / 65536 / 12 slots):
    ``graft.vi_frame_step`` on ``graft.euroc_vi_scene``'s three cases
    (no prior, a carried prior, the fallback to the IMU prediction) held
    to the truth and to the CPU plain path, its synchronisations named,
    50 timed calls; ``graft.vi_keyframe_step`` on ``graft.euroc_vi_map``
    (the cost falls, the free states move towards the truth, nothing else
    is written), 20 timed calls; ``graft.vi_initialize`` on
    ``graft.euroc_vi_init`` with the stereo and the mono gates (gravity,
    scale, gyro bias), 10 timed calls; the solvers' CUDA-graph replay
    against their operations run one by one; every K1, K2, K3 and K3s
    launch of the frame steps held against its plain version.

  * phase "13 inertial system": ``StereoInertialSlam`` and
    ``MonoInertialSlam`` on the committed VI frames, cells (d), (e) and (f)
    (the stereo frames at the EuRoC stereo-inertial capacity).

  * phase "14 fisheye": the non-rectified stereo path and the
    Kannala-Brandt camera. (a) ``graft.fisheye_stereo_extract`` at TUM-VI
    512's 1000 features on the stereo-inertial fixture's first pair warped
    to TUM-VI's 512x512 KB8 pair (``graft.tumvi_kb8_pair``): K1 twice and
    K2's 1000 x 1000 none launch held bit for bit, the match against the
    CPU plain path on the same features, the depths against the render's,
    the synchronisations named, 50 timed calls; (g) ``FisheyeStereoSlam``
    on ``graft.fisheye_frames()`` at tests/test_fisheye_stereo_system.py's
    configuration, held to that test's gate and the JAX run's ATE; (h)
    ``FisheyeStereoInertialSlam`` on the warped stereo-inertial frames at
    TUM-VI 512's capacity (1024 / 65536 / 12 slots, VI-BA 24 / 10 / 4096 /
    64), held to (d)'s gates and the JAX run's ATE; every launch of (g)'s
    and (h)'s first sequence held against its plain version, timed
    sequences by frame kind.

  * phase "15 reloc": place recognition and relocalization at the
    EuRoC-mono capacity with the runners' 10k-word vocabulary.
    ``MonoSlam`` on ``graft.reloc_sequence`` (the golden frames padded to
    752x480, a blackout of noise frames, a revisit): cell (i), 4 noise
    frames within the RECENTLY_LOST budget, relocalization into the active
    map; cell (j), 6 frames past a budget of 2, a new map, then the
    re-entry into the old one; both held to ``graft.reloc_run_gates`` (the
    JAX MonoSlam's recorded frame within 1, its map, the camera centre
    within 5 cm of the truth), every launch of (i)'s first sequence from
    the blackout on held against its plain version, timed sequences by
    frame kind with the relocalizing frame apart. The step,
    ``graft.relocalize`` on the map and frame of (i)'s relocalization: its
    K2 launches (none mode over the
    65536 landmark slots, window mode) and K3 launches (the PnP refine and
    the final pose, 1536 rows) held and timed, the CPU plain path with the
    card's draws, the synchronisations named, 20 timed calls. The
    deployment-width database: ``real_voc_100k.npz`` (92,613 words),
    ``transform`` of 1536 descriptors and ``query_groups`` over 1024 rows,
    timed, with the database's bytes.
  * phase "16 loop": loop closing and the global BA at the EuRoC-mono
    capacity with the same vocabulary. The step,
    ``graft.loop_closing_step`` on ``graft.euroc_loop_map`` (a drifted
    160-keyframe circuit, about 48,000 landmarks, three revisit keyframes):
    the revisits in turn with the default ladder gates, the third firing
    (``consecutive_needed`` 3), then the closure (the essential-graph pose
    graph at DOF_SIM3 over the live prefix, the fusion) and the global BA
    inline; its K2 launches (the guided projection's window mode over the
    65536 landmark slots twice per verified candidate, the fusion) held
    against their plain version bit for bit and timed; gates: the planted
    candidate, the Sim3's scale within 5 % of the creep's inverse, the
    revisit's centre error halved, one loop edge, the GBA's cost falling;
    the same with the background GBA ticked to completion and merged; the
    CPU plain path with the card's Sim3 draws (candidate, Sim3 and the
    poses after the pose graph within 1e-3); ``detect`` on a verifying
    keyframe and on one whose candidates fail (10 calls each), the closure
    with the inline GBA (5), the background ticks, each with its
    synchronisations named. Cell (k), the runners' default configuration
    (``graft.loop_golden_config``: loop closing and the background GBA on):
    ``MonoSlam`` on the golden frames padded to 752x480, every launch of a
    warm-up sequence held, cell (b)'s gates and the JAX MonoSlam's recorded
    detection decisions (``graft.LOOP_JAX``), timed sequences by frame kind
    with the keyframe frames that mined the database apart.
  * phase "17 merge": the atlas merge and the checkpoints at the
    EuRoC-mono capacity with the same vocabulary. The step,
    ``graft.map_merge_step`` on ``graft.euroc_merge_atlas`` (a 157-keyframe
    map and a 3-keyframe map of the same place, a planted Sim3 of scale 0.8
    apart): map B's keyframes in turn, the third welding map A (the
    databases, the fusion, the windowed BA past 64 keyframes); its K2
    launches held bit for bit and timed; gates: A's planted candidate, the
    weld's scale within 5 %, one map of both maps' keyframes, the
    transplanted landmarks the weld's transform of A's, ``obs.kf`` shifted,
    no live landmark under 2 live observations, B's misplaced keyframe
    nearer its truth; the CPU plain path with the card's Sim3 draws;
    ``detect_merge`` on a verifying keyframe and on a failing one (10 calls
    each) and ``graft.merge_maps`` (5 calls, each from a fresh copy, and
    its parts) with their synchronisations. Cells (l) and (m)
    (``graft.merge_sequence``): ``MonoSlam`` loses its map, starts another,
    revisits and merges the first back, held to the JAX MonoSlam's recorded
    runs (``graft.MERGE_JAX``, ``graft.merge_run_gates`` on each run); (m)
    saves the first map through ``save_atlas_checkpoint`` and loads it into
    a fresh system first. A held warm-up of (l), one timed sequence of each,
    by frame kind with the merge frame apart, one synchronisation-counting
    run of each; the checkpoint's bytes and its save and load seconds.

  * phase "19 runners" (run right after phase 13, while cell (f)'s CUDA
    graphs are cached): the port's dataset runners (``runners.py``) as a
    user calls them, on EuRoC-, KITTI- and TUM-layout datasets written
    from the fixtures in the oracle pool while the earlier phases run
    (``graft.write_runner_dataset``). Kernel P1, the PNG unfilter of the
    port's decoder (a port kernel for ``cv2.imread``, not for a TPU
    kernel), built with K1-K3: held bit for bit against the plain
    unfilter on every row filter at 752x480, and the prefetcher timed with
    1 and 4 threads on Paeth files. (o) The flagship runner,
    ``main_euroc_stereo_inertial`` at its defaults (1200 features, 1024 /
    65,536 / 12 slots) with ``--no-vocabulary``, on (d)'s 40 pairs through
    a raw EuRoC-like rig (radtan, the 0.8-degree stereo rotation) and the
    200 Hz IMU: every P1 launch bit-identical, every rectified pair within
    1e-4 of the plain remap, the rig within 1e-6 of the plain rig, (f)'s
    gates against the truth and the JAX runner's ATE, its files read
    back; the user's frames/s, the prefetcher's wait, decode and
    rectification by CUDA events; a second run without the ``T_bc`` repair
    counting synchronisations (none between ``track`` calls). (p) The
    other five runners on 10 frames each: each initialises on the frame
    its CPU run does, writes its files, P1 and CLAHE equal to plain.

  * phase "20" (the port's last modules; run after phase 17, its runner
    part right after phase 19's timed run of (o)): (a) phase 16's closure
    with the inline GBA over a 4-shard device mesh on the one card
    (``parallel.dist_ba``) against the unsharded closure (the same loop
    edge, the cost within 5 % + 1, the rotations within 1.4e-2: float32
    determines this GBA's poses only to about 1e-2, and its translations
    are reported), and the GBA alone in float64 with 4
    shards and with 1 (poses within 5e-4 and 5e-3 m), both forms timed;
    (b) the edge-sharded pose graph (``parallel.dist_posegraph``) on the
    essential graph of that closure against the unsharded one (1e-3,
    5e-3); (c) ``graft.dryrun_multichip(4)``; (d) K3 and K3s with the KB8
    camera at TUM-VI 512's coefficients and 1000 points, held at float64
    and timed; (e) tests/test_kb8_ab.py's A/B study (24 trials at 85
    degrees, 16 at 50) under its gates, every launch held at float64 (in
    the oracle pool, settled later); the KB8 launches of K3 and K3s, as
    their wrappers count them, in phase 20 and in the rest of the run,
    where every system path runs and none may launch KB8; (f) the flagship
    runner with ``--snapshot-every 10`` (its four PNGs read back, the
    snapshots' host time its cost) and ``viewer.main_view_atlas``
    (``scripts/view_atlas_torch.py``) on cell (m)'s checkpoint.

Every kernel is held against its plain PyTorch version on the card: on
synthetic inputs at both paths' shapes, and on the very inputs each path
gave it (its wrapper's calls are recorded and replayed). K3 and K3s are
held against their plain version run in float64 (within 1e-4): on the
stereo world's ill-conditioned problems the float32 plain version strays
further from it than the kernel does (phase 11 prints by how much). Each path runs
with the launch counts set to 0 just before and read just after; each must
have launched every kernel it uses. Any failed check raises and the script
exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``. Needs a CUDA device and ``nvcc``.

Per kernel, at the tracking step's shapes (and, under ``frame_step_calls``,
``keyframe_step_calls`` and ``init_step_calls``, at each of those steps'
calls):
  * ``ms``: the launch alone. The wrapper's launch is captured once and its
    C function is called again with the same prepared pointers; a spin kernel
    queued first keeps the host's launch cost out of the CUDA-event pair.
    Median of 50.
  * ``wrapper_ms``: CUDA events around the Python wrapper (its torch ops and
    the host's launch cost included, the device otherwise idle). Median of 50.
  * ``plain_ms``: the same around the plain PyTorch version.
  * ``bound_ms``: the larger of the bytes the function must move over the
    HBM rate and the operations this run's data needs over the peak rate of
    their type (NVIDIA's H100 SXM data sheet, 700 W).
  * ``ptxas``: registers, shared memory and spills from nvcc's report.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

N_TIMED_FRAMES = 50
N_TIMED_LAUNCHES = 50
# Steps right after start-up ran up to 2x slower than the steady state on an
# H100 80GB HBM3 at 700 W; time only after this many steps.
N_WARMUP_STEPS = 100
# Spin (clock cycles, ~0.5 ms) queued before a launch-alone sample, so that
# the launch is queued before the start event executes.
PRIME_CYCLES = 1_000_000
# K3 and K3s with the KB8 camera (ops/camera.py's kb8_project and
# kb8_project_jac in csrc/pose_opt.cu), counting atan2 and sqrt as one
# operation each: the projection adds 17 operations to each residual over
# the pinhole's (the radius, theta, the polynomial, psi), the Jacobian 91 to
# each masked point's (the 2 x 3 projection Jacobian, 6 entries of about 8
# operations on r, theta, f and f', and its product with [I | -skew(pc)],
# where the pinhole's has zeros).
KB8_RESIDUAL_FLOPS = 17
KB8_JACOBIAN_FLOPS = 91
# ops/camera.py's model ids.
KB8 = 1
# Phase 20 (a): the float32 sharded closure's keyframe rotations (the
# largest entry gap) against the unsharded closure's. The bound lies
# between the honest spread and a planted fault (scripts/gba_spread_torch.py
# --plant, NVIDIA H100 80GB HBM3, 700 W: float32 GBAs of the closed map,
# repeated and 4-shard, at most 7.3e-3 apart; the first shard left out of
# the sums, 2.1e-2 to 2.5e-2). The translations part no such way (honest
# up to 0.085 m, the fault from 0.076 m): they are reported.
F32_CLOSURE_R = 1.4e-2
# Published H100 SXM peaks at 700 W: HBM3 bytes/s, float32 outside the
# tensor cores FLOP/s, int8 tensor-core OP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
# At least 10^6 angles in [-pi, pi] for the sincosf check.
N_ANGLES = 1 << 20
# The keyframe step: timed calls after warm-up calls, each from the same map.
N_TIMED_KEYFRAMES = 20
N_WARMUP_KEYFRAMES = 5
# A triangulation decision may differ between the card and the CPU only
# where a gate value lies within float32 rounding of its threshold.
FLIP_MARGIN = 1e-5
# The init step: timed calls after warm-up calls, each from the empty map.
N_TIMED_INITS = 10
N_WARMUP_INITS = 2
# The monocular system: whole sequences timed after one warm-up sequence,
# each with a fresh MonoSlam (2 until phase 16 needed the room).
N_TIMED_SEQUENCES = 1
# The K3 / K3s plain version's timed runs at a system path's shapes (a
# float64 LM of 0.2-0.7 s a call; 5 until phase 16 needed the room), after
# one warm-up call (3 until phase 19 needed the room: about 25 such
# timings a script, 0.3-0.8 s a call).
K3_PLAIN_REPS = 2
K3_PLAIN_WARMUP = 1


def plain_reps_of(name: str) -> int:
    """Timed runs of a kernel's plain version at a path's shapes."""
    return K3_PLAIN_REPS if name in ("K3", "K3s") else 20

# The JAX system's reads of device values in each kind of frame
# (orbslam3_byzyh_tpu/pipeline/system.py), beside the port's synchronisations.
JAX_HOST_READS = {
    "uninitialised": "n_valid (:342), then n_matches (:353) and success "
                     "(:370) for an attempt",
    "init": "n_valid (:342) and the init's n_matches, success, good and "
            "points (:353-375), the new keyframe's pose (:307, :326)",
    "tracked": "info (:504)",
    "keyframe": "info (:504) and the previous bundle's info (:867)"}
# The stereo frame step: timed calls after warm-up calls; the stereo and
# RGB-D systems (phases 11 and 14): timed sequences after one warm-up
# sequence (2 until phase 16 needed the room).
N_WARMUP_STEREO = 20
N_TIMED_STEREO_SEQUENCES = 1
# The JAX stereo and RGB-D systems' reads of device values in each kind of
# frame (orbslam3_byzyh_tpu/pipeline/stereo_system.py and system.py).
JAX_STEREO_READS = {
    "uninitialised": "the depth and the features' validity "
                     "(stereo_system.py:138-139)",
    "init": "the depth and validity (:138-139), the new landmarks' count "
            "(:174) and slot high-water mark (:203), the reference "
            "keyframe's pose (system.py:326-327)",
    "tracked": "info (system.py:504)",
    "keyframe": "info (system.py:504), the keyframe liveness before the "
                "bundle (:825), the previous bundle's info (:867), the depth "
                "landmarks' count (stereo_system.py:174) and high-water mark "
                "(:203), both after the bundle"}
# The system's capacity run: keyframe slots few enough that the forced
# culling, the compaction and the trajectory rebase fire, and a local BA
# window of 24 keyframes (its fixed part must fit the slots).
CAPACITY_MAX_KF = 16
CAPACITY_BA_WINDOW = 24
# Phase 12: the stereo-inertial frame step's timed calls after its warm-up
# calls (50 after 10 until phase 16 needed the room).
N_WARMUP_VI = 5
N_TIMED_VI_FRAMES = 20


# Phase 13: the inertial systems' timed sequences after one warm-up
# sequence, per cell (2 until phase 16 needed the room).
N_TIMED_VI_SEQUENCES = 1
# Phase 14 (a): a match decision may differ between the card and the CPU
# only where a float gate (parallax, depth, reprojection) lies within this
# relative distance of its threshold: the DLT's float32 SVD (cuSOLVER
# against LAPACK) moves the point by up to about 1e-5 relative.
FISHEYE_FLIP_MARGIN = 1e-4
# Phase 14 (a): the matched depths' median relative error against the
# render's depth (test_stereo.py:136-138's gate for this function: the
# match triangulates the keypoints as detected, with no sub-pixel
# refinement, and a pixel is 4-10 % of the world's 9-27 px disparities).
FISHEYE_DEPTH_MEDIAN_TOL = 0.08
# Phase 15: the relocalization step's timed calls; the cells' timed
# sequences after one warm-up sequence (cell (i), cell (j); 5 and 4 until
# phase 16 needed the room).
N_TIMED_RELOC_STEPS = 20
N_TIMED_RELOC_SEQUENCES = {"i": 2, "j": 1}
# The JAX MonoSlam's reads of device values in each kind of a
# relocalization cell's frame (orbslam3_byzyh_tpu/pipeline/system.py,
# keyframe_db.py), beside the port's synchronisations.
JAX_RELOC_READS = dict(
    JAX_HOST_READS,
    lost="info (:504), the fallback's inliers (:517); per atlas map "
         "searched the candidates (keyframe_db.py:126-127) and per "
         "candidate its liveness (:1235), the PnP's ok and inliers (:1246) "
         "and the track's inliers (:1259)",
    reloc="as a lost frame's, up to the candidate that passes")
# Phase 16: the loop step's timed calls (detections, closures) and cell
# (k)'s timed sequences after one warm-up sequence.
N_TIMED_LOOP_DETECTS = 10
N_TIMED_LOOP_CLOSURES = 5
N_TIMED_LOOP_SEQUENCES = 1
# The JAX MonoSlam's reads of device values in a keyframe frame that mines
# the database for a loop (orbslam3_byzyh_tpu/pipeline/system.py,
# loop_closing.py), beside the port's synchronisations.
JAX_LOOP_READS = dict(
    JAX_HOST_READS,
    keyframe_detect=JAX_HOST_READS["keyframe"] + ", the keyframe's liveness "
    "(system.py:964), the covisibility counts (loop_closing.py:192), the "
    "candidates (keyframe_db.py:126-127) and each one's liveness (:204); per "
    "verified candidate the match (:287), both keyframes' landmarks "
    "(:292-300), the landmark positions (:311-312), the RANSAC's ok (:318), "
    "the window's observation table (:336-338), each stage's count (:383, "
    ":418, :425)")
# Phase 17: the merge step's timed calls (detections, welds, each weld from
# a fresh copy of the two maps) and the merge cells' timed sequences after
# one held warm-up.
N_TIMED_MERGE_DETECTS = 10
N_TIMED_MERGE_WELDS = 5
N_TIMED_MERGE_SEQUENCES = 1
# The JAX MonoSlam's reads of device values in the kinds of a merge cell's
# frames (orbslam3_byzyh_tpu/pipeline/system.py, loop_closing.py), beside
# the port's synchronisations.
JAX_MERGE_READS = dict(
    JAX_RELOC_READS,
    keyframe_detect=JAX_LOOP_READS["keyframe_detect"] + "; with another "
    "map, per map mined the candidates (keyframe_db.py:126-127), each one's "
    "liveness (loop_closing.py:253) and per verified candidate the "
    "ladder's reads as a loop's",
    merge="a keyframe's, the merge detection's, then the refreshed "
    "reference pose (system.py:1109)")
# The JAX inertial systems' reads of device values in each kind of frame
# (orbslam3_byzyh_tpu/pipeline/inertial_system.py unless named), beside
# the port's synchronisations.
JAX_VI_READS = {
    "uninitialised": "mono: n_valid (system.py:342) and an attempt's "
                     "n_matches, success (:353, :370); stereo: the depth and "
                     "validity (stereo_system.py:138-139)",
    "init": "mono: the init's reads (system.py:342-375) and keyframe 0's "
            "stamp (:322); stereo: the depth, validity, landmark count and "
            "high-water mark (stereo_system.py:138-139, :174, :203)",
    "visual": "info (system.py:504); before the IMU init the last "
              "keyframe's stamp once (:322)",
    "inertial": "info (:1059); a RECENTLY_LOST frame the predicted pose "
                "(:1074)",
    "keyframe": "info (:1059), the liveness before the bundle (system.py:825), "
                "the previous bundle's info (:867) and its culled mask "
                "(:880), the pending cull (:464) with the liveness (:470), "
                "the successor's bias (:493-494) and the valid mask (:504), "
                "the keyframe's pose for the body (:1105-1106); stereo: the "
                "depth landmarks' count and high-water mark "
                "(stereo_system.py:174, :203)",
    "imu_keyframe": "a keyframe's, and the refit's: the chain's poses "
                    "(:728-729), the scale (:741), gravity and velocities "
                    "(:746, :750), the biases (:755), the keyframe's pose "
                    "(:793-794 or :644-645) and biases (:651-652), the ref "
                    "cache (system.py)"}


T_START = time.perf_counter()
# Processes that run K3's and K3s's float64 oracle on the host's CPU while
# the card goes on (the machine has 8 cores; the script's own process
# drives the card).
ORACLE_WORKERS = 6


def oracle_solve(name: str, problem: tuple, kwargs: dict):
    """K3's or K3s's plain version in float64 on one problem's CPU tensors:
    (R, t, chi2). Runs in a worker process of the oracle pool."""
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    torch.set_num_threads(1)
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

    def f64(x):
        return (x.double() if isinstance(x, torch.Tensor)
                and x.is_floating_point() else x)

    plain = (cuda_pose_opt.pose_optimization_plain if name == "K3"
             else cuda_pose_opt.pose_optimization_stereo_plain)
    return plain(*(f64(a) for a in problem),
                 **{k: f64(v) for k, v in kwargs.items()})


def init_cpu(scene, eu, cam, idx) -> tuple:
    """Phase 9's CPU plain path: ``graft.mono_initialize`` on the CPU with
    the RANSAC indices the card drew, from ``graft.euroc_mono_two_view``'s
    scene at the config ``eu``. Runs in a worker process of the oracle
    pool: (success, used_h, live landmarks, bindings, R)."""
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    torch.set_num_threads(2)
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.models import map_state
    from orbslam3_byzyh_tpu_torch.ops import fast_orb
    cpu = torch.device("cpu")
    frames = [fast_orb.FrameFeatures(*convert.tree_to_torch(f, cpu))
              for f in (scene.ref, scene.cur)]
    empty = map_state.empty_map(eu.max_kf, eu.max_lm, eu.max_obs,
                                eu.n_features, device=cpu)
    r = graft.mono_initialize(empty, *frames, 0.0, 0.05, cam, idx=idx)
    return (r.success, bool(r.info["used_h"]),
            int(r.state.lms.valid.sum()) if r.success else 0,
            r.bindings if r.success else None, r.R if r.success else None)


def init_cpu_held(case: str, fut, card: tuple, out: dict) -> None:
    """Hold phase 9's card result ``card`` (as :func:`init_cpu` returns it)
    against the CPU plain path's (``fut``): the same decision, R within
    1e-3, the landmark count within 1 % and the bindings equal, or within
    1 % where the counts differ. Updates ``out``, the case's record."""
    ok, used_h, n_g, bind_g, R_g = card
    ok_c, used_h_c, n_c, bind_c, R_c = fut.result()
    require((ok_c, used_h_c) == (ok, used_h),
            f"init ({case}): CPU success {ok_c} used_h {used_h_c}")
    if ok:
        d_bind = int((bind_g != bind_c).sum())
        r_gap = float((R_g - R_c).abs().max())
        require(r_gap <= 1e-3, f"init ({case}): R differs from the CPU by "
                f"{r_gap}")
        require(abs(n_g - n_c) <= 0.01 * n_c
                and (d_bind == 0 or (n_g != n_c and d_bind <= 0.01 * n_c)),
                f"init ({case}): landmarks {n_g} vs CPU {n_c}, bindings "
                f"differ at {d_bind}")
        out.update(live_landmarks_cpu=n_c, bindings_differ_cpu=d_bind,
                   R_gap_cpu=r_gap)
    phase("9 init", f"{case}: the CPU plain path with the card's indices "
          f"agrees: success {ok_c}, used_h {used_h_c}, {n_c} landmarks "
          f"(the card {n_g}); {json.dumps(out)}")


def phase(name: str, msg: str) -> None:
    """One progress line, with the seconds since the script started."""
    print(f"[{name} +{time.perf_counter() - T_START:.1f} s] {msg}",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = N_TIMED_LAUNCHES, primed: bool = False,
             warmup: int = 3) -> float:
    """Median CUDA-event time of one call over ``reps`` calls, after
    ``warmup`` calls. ``primed`` queues a spin kernel first, so the events
    time the device work alone and not the host's enqueueing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Launcher:
    """One exported launcher of a kernel library with its own launch count:
    K3 and K3s are one source (``csrc/pose_opt.cu``) with two launchers.
    Every other attribute is the library's."""

    def __init__(self, kernel, fn: str):
        self.kernel, self.fn = kernel, fn

    @property
    def launches(self) -> int:
        return self.kernel.fn_launches[self.fn]

    @launches.setter
    def launches(self, v: int) -> None:
        self.kernel.fn_launches[self.fn] = v

    def __getattr__(self, name):
        return getattr(self.kernel, name)


def captured_launch(kernel, call):
    """Run ``call()`` once and return (its result, a function that repeats
    its kernel's launch alone: the exported C function called with the same
    prepared arguments). Keep the result alive while the launch is repeated:
    it owns the output buffers. Repeats do not count as launches."""
    kernel = getattr(kernel, "kernel", kernel)
    seen = []
    launch = kernel.launch

    def spy(fn, *args):
        seen.append((fn, args))
        launch(fn, *args)

    kernel.launch = spy
    try:
        out = call()
    finally:
        del kernel.launch
    require(len(seen) == 1, f"{kernel.name}: {len(seen)} launches in one call")
    fn, args = seen[0]
    c_fn = getattr(kernel.build(), fn)

    def again():
        err = c_fn(*args)
        if err != 0:
            raise RuntimeError(f"{kernel.name}.{fn}: CUDA error {err}")

    return out, again


@contextlib.contextmanager
def recorded(module, name: str):
    """Record the (args, kwargs) of every call of ``module.name`` (a kernel
    wrapper) made inside the block; the calls go through unchanged."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def ptxas_summary(kernel) -> list:
    """Per compiled kernel: registers, shared memory and spill bytes, from
    the build's ``-Xptxas=-v`` report (empty if the build kept none)."""
    log = kernel.library_path().with_suffix(".log")
    if not log.exists():
        return []
    out, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    cxxfilt = shutil.which("c++filt")
    for entry in out:
        if cxxfilt:
            entry["function"] = subprocess.run(
                [cxxfilt, entry["function"]], capture_output=True,
                text=True).stdout.strip() or entry["function"]
    return out


def tensor_instructions(kernel) -> dict | None:
    """Counts of tensor-core instructions (BMMA, IMMA, HMMA) in the kernel's
    SASS, by ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return None
    sass = subprocess.run([tool, "-sass", str(kernel.library_path())],
                          capture_output=True, text=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("BMMA", "IMMA", "HMMA")}


def bound(bytes_moved: float, ops: dict) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): ``ops`` maps a peak rate to the
    operations counted at that rate."""
    t_bytes = bytes_moved / HBM_BPS
    t_ops = sum(n / rate for rate, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def pose_error(R, t, R_true, t_true) -> float:
    """Largest of the rotation's entry-wise error and the camera centre's
    error in m (numpy, float64)."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    R0, t0 = np.asarray(R_true, np.float64), np.asarray(t_true, np.float64)
    return max(float(np.abs(R - R0).max()),
               float(np.abs(R.T @ t - R0.T @ t0).max()))


def triangulation_margins(X, Ra, ta, Rb, tb, xy_a, xy_b, level_a, level_b,
                          cam_params) -> np.ndarray:
    """Per row, in float64 from the triangulated points: the smallest
    relative distance of any of ``triangulate_pair``'s gates (depth in both
    views, chi2 5.991, the scale ratio's bounds, parallax cos 0.9998) to
    its threshold."""
    f = lambda a: np.asarray(a, np.float64)
    X, Ra, ta, Rb, tb, xy_a, xy_b = map(f, (X, Ra, ta, Rb, tb, xy_a, xy_b))
    fx, fy, cx, cy = f(cam_params)
    la, lb = np.asarray(level_a), np.asarray(level_b)
    margins = []
    for R, t, xo, lv in ((Ra, ta, xy_a, la), (Rb, tb, xy_b, lb)):
        pc = X @ R.T + t
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], -1)
        chi2 = ((uv - xo) ** 2).sum(-1) / 1.2 ** (2 * lv)
        margins += [np.abs(pc[:, 2]) / np.linalg.norm(X, axis=-1),
                    np.abs(chi2 - 5.991) / 5.991]
    ca, cb = -Ra.T @ ta, -Rb.T @ tb
    da = np.linalg.norm(X - ca, axis=-1)
    db = np.linalg.norm(X - cb, axis=-1)
    octave = 1.2 ** (la - lb).astype(np.float64)
    for b in (octave * 1.8, octave / 1.8):
        margins.append(np.abs(da / db - b) / b)
    cos = (((X - ca) / da[:, None]) * ((X - cb) / db[:, None])).sum(-1)
    margins.append(np.abs(cos - 0.9998) / 0.9998)
    return np.min(margins, axis=0)


@contextlib.contextmanager
def counted_syncs(stacks: list | None = None, callers: list | None = None):
    """Count the operations that synchronise the stream with the host
    inside the block (``torch.cuda.set_sync_debug_mode("warn")``): yields a
    list that ends up holding each warning's "file:line". ``stacks``, when
    given, receives each one's Python stack; ``callers`` the innermost
    frame of each in the port's ``pipeline/`` modules ("file:line
    function"), the system code that asked for it."""
    where = []
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                where.append(f"{os.path.relpath(filename)}:{lineno}")
                if stacks is not None:
                    stacks.append("".join(traceback.format_stack(limit=14)))
                if callers is not None:
                    inner = [f for f in traceback.extract_stack()
                             if "orbslam3_byzyh_tpu_torch/pipeline/"
                             in f.filename]
                    callers.append(
                        f"{os.path.relpath(inner[-1].filename)}:"
                        f"{inner[-1].lineno} {inner[-1].name}" if inner
                        else "outside pipeline/")

        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = show
        try:
            yield where
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def spied(module, name: str, record):
    """Call ``record(args, kwargs, result)`` after every call of
    ``module.name`` made inside the block."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        record(args, kwargs, out)
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def spread(xs) -> dict:
    """Count, median, p80, min and max of a list of times (ms)."""
    xs = list(xs)
    if not xs:
        return {"n": 0}
    p80 = statistics.quantiles(xs, n=5)[-1] if len(xs) > 1 else xs[0]
    return {"n": len(xs), "median": statistics.median(xs), "p80": p80,
            "min": min(xs), "max": max(xs)}


def run_sequence(slam, frames, stamps, kernels, bundles, after=None):
    """Drive ``slam.track`` over the frames, as a user's frame loop does.
    Per frame: its kind ("uninitialised": no map yet and none made; "init":
    the frame that makes the initial map; "keyframe": a tracked frame that
    hosts a new keyframe; "tracked": the rest), the host-clock time of
    ``track`` in ms (it returns after the system's own reads) and the
    K1-K3 launches. ``bundles`` grows by one per keyframe dispatch.
    ``after(i, kind)`` runs after each frame's timing. A frame that is a
    tuple (a stereo pair, an image and its depth) goes to ``track`` as its
    first arguments. Returns (the frames' records, the trajectory, the whole
    sequence in s, the trajectory read included)."""
    from orbslam3_byzyh_tpu_torch.pipeline.system import NOT_INITIALIZED
    out = []
    t_seq = time.perf_counter()
    for i, (img, stamp) in enumerate(zip(frames, stamps)):
        was_uninit = slam.status == NOT_INITIALIZED
        n_b = len(bundles)
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        slam.track(*(img if isinstance(img, tuple) else (img,)), float(stamp))
        ms = (time.perf_counter() - t0) * 1e3
        if was_uninit:
            kind = ("uninitialised" if slam.status == NOT_INITIALIZED
                    else "init")
        else:
            kind = "keyframe" if len(bundles) > n_b else "tracked"
        out.append({"kind": kind, "ms": ms, "launches": {
            n: k.launches - before[n] for n, k in kernels.items()}})
        if after is not None:
            after(i, kind)
    traj = slam.trajectory
    return out, traj, time.perf_counter() - t_seq


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_inertial(dev, card, sk, check_call, timed, shape_of) -> dict:
    """Phase "12 inertial": the stereo-inertial device path at the EuRoC
    stereo-inertial configuration. ``sk``: the launch counters of K1, K2,
    K3 and K3s; ``check_call`` / ``timed`` / ``shape_of``: main's kernel
    checks. Returns the phase's results and each kernel's held calls."""
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match
    from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as vi
    from orbslam3_byzyh_tpu_torch.solver import (cuda_pose_opt, inertial,
                                                 inertial_ba)

    name = "12 inertial"
    cfg = graft.EUROC_STEREO_INERTIAL
    m_cfg = cfg.rig.mono
    ctx = graft.vi_context(cfg, dev)
    ctx_cpu = graft.vi_context(cfg, "cpu")
    out = {"frame": {}, "keyframe": {}, "init": {}}
    held = {n: [] for n in sk}

    @contextlib.contextmanager
    def recording():
        with recorded(cuda_brief, "brief_descriptors_kernel") as c1, \
                recorded(cuda_match, "hamming_best2_kernel") as c2, \
                recorded(cuda_pose_opt, "pose_optimization_kernel") as c3, \
                recorded(cuda_pose_opt,
                         "pose_optimization_stereo_kernel") as c3s:
            yield {"K1": c1, "K2": c2, "K3": c3, "K3s": c3s}

    def zero_counts():
        for k in sk.values():
            k.launches = 0

    # The sites that may wait for the device inside the frame step: the
    # step's one read (device.read), and with a carried prior the
    # eigendecomposition of its PSD projection (inertial.prior_sqrt).
    read_site = "orbslam3_byzyh_tpu_torch/device.py"
    eigh_site = "orbslam3_byzyh_tpu_torch/solver/inertial.py"

    # -- the frame step, three cases -----------------------------------------
    left, right = (torch.from_numpy(a).to(dev) for a in graft.euroc_vi_pair(cfg))
    f, _, m = graft.stereo_extract(left, right, ctx.cam_params, None,
                                   cfg.rig)
    n_match = int(m.valid.sum())
    disp = float((f.xy[:, 0] - m.u_right)[m.valid].median())
    require(n_match >= 0.25 * m_cfg.n_features
            and abs(disp - graft.VI_PAIR_SHIFT) <= 0.1,
            f"EuRoC stereo match: {n_match} matches, disparity {disp}")
    feats_np = [convert.to_numpy(a) for a in (f.xy, f.level, f.desc,
                                               f.angle, f.valid)]
    depth_np = convert.to_numpy(m.depth)
    n_valid = int(f.valid.sum())
    frame_calls = {}
    for case in ("keyframe", "prior", "fallback"):
        s = graft.euroc_vi_scene(*feats_np, depth_np, case=case, cfg=cfg)
        args = graft.vi_frame_args(s, dev)
        # The first call: the cached constants, and the CUDA graphs of the
        # solves not captured yet (the window's preintegration and the
        # solve without the prior on "keyframe", with it on "prior").
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graft.vi_frame_step(args, ctx, cfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        zero_counts()
        stacks = []
        with recording() as calls, counted_syncs(stacks) as syncs:
            res, _, _ = graft.vi_frame_step(args, ctx, cfg)
        got = {n: k.launches for n, k in sk.items()}
        require(got == {"K1": 2, "K2": 2, "K3": 1, "K3s": 1},
                f"vi frame step ({case}) launches {got}, expected K1 2, K2 "
                f"2, K3 1, K3s 1")
        for n, c in calls.items():
            frame_calls.setdefault(n, []).extend(
                (a, kw, case) for a, kw in c)
        info = res.info
        pr = res.pose_inertial
        n_in = int(info[0])
        R = info[2:11].reshape(3, 3).astype(np.float64)
        r_err = float(np.abs(R - np.eye(3)).max())
        c_err = float(np.linalg.norm(R.T @ info[11:14].astype(np.float64)))
        v_err = float(np.linalg.norm(convert.to_numpy(pr.v) - s.v_true))
        vp_err = float(np.linalg.norm(convert.to_numpy(res.v_pred)
                                      - s.v_true))
        b_err = float(np.abs(info[14:20] - np.asarray(graft.VI_BIAS)).max())
        used = bool(res.used_prediction)
        expect = [read_site] + ([eigh_site] if case == "prior" else [])
        sites = sorted(w.rsplit(":", 1)[0] for w in syncs)
        require(np.isfinite(info).all(), f"vi frame step ({case}): "
                f"non-finite info")
        require(n_in >= 0.75 * n_valid, f"vi frame step ({case}): {n_in} "
                f"inliers of {n_valid}")
        require(r_err <= 2e-3 and c_err <= 1e-2, f"vi frame step ({case}): "
                f"rotation {r_err}, centre {c_err} m from the truth")
        # The solve must bring the velocity nearer the truth than the IMU
        # prediction it starts from; with the prior ("prior": the last
        # frame's velocity 0.05 m/s off and weakly held) by most of the way.
        require(v_err <= 0.015 and v_err < vp_err
                and (case != "prior" or v_err <= 0.25 * vp_err),
                f"vi frame step ({case}): velocity {v_err} m/s from the "
                f"truth, the prediction {vp_err}")
        require(b_err <= 1e-4, f"vi frame step ({case}): bias {b_err} from "
                f"the truth")
        require(used == (case == "fallback"), f"vi frame step ({case}): "
                f"IMU prediction used {used}")
        require(sites == sorted(expect), f"vi frame step ({case}): "
                f"synchronisations at {syncs}, expected {expect}; "
                f"stacks: {stacks}")
        # The CPU plain path on the same inputs.
        res_c, _, _ = graft.vi_frame_step(graft.vi_frame_args(s, "cpu"),
                                          ctx_cpu, cfg)
        n_cpu = int(res_c.info[0])
        Rc = res_c.info[2:11].reshape(3, 3).astype(np.float64)
        d_pose = max(float(np.abs(Rc - R).max()), float(np.linalg.norm(
            Rc.T @ res_c.info[11:14] - R.T @ info[11:14])))
        require(abs(n_cpu - n_in) <= max(2, 0.01 * n_in) and d_pose <= 1e-3,
                f"vi frame step ({case}): CPU {n_cpu} inliers vs card "
                f"{n_in}, poses {d_pose} apart")
        out["frame"][case] = {
            "n_inliers": n_in, "n_valid": n_valid, "n_inliers_cpu": n_cpu,
            "cpu_pose_gap": d_pose, "R_err": r_err, "centre_err_m": c_err,
            "v_err_mps": v_err, "v_pred_err_mps": vp_err,
            "bias_err": b_err, "used_prediction": used,
            "ref_matches": int(info[1]), "close": info[20:22].tolist(),
            "launches": got, "syncs": syncs, "first_call_ms": first_ms}
        phase(name, f"{case}: vi_frame_step {m_cfg.width}x{m_cfg.height}, "
              f"{m_cfg.n_features} features, {m_cfg.max_lm} landmark slots: "
              f"{n_in} inliers of {n_valid} (CPU plain path {n_cpu}, poses "
              f"{d_pose:.1e} apart); rotation {r_err:.1e}, centre "
              f"{c_err * 1e3:.2f} mm, velocity {v_err * 1e3:.2f} mm/s "
              f"(the prediction {vp_err * 1e3:.2f}), bias {b_err:.1e} from "
              f"the truth; IMU prediction used: {used}; close points "
              f"{info[20:22].tolist()}; launches {got}; synchronisations "
              f"{syncs}; the first call (captures included) {first_ms:.1f} "
              f"ms ({card})")
    out["frame"]["stereo_matches"] = n_match
    out["frame"]["disparity_median"] = disp

    # The solvers replay as CUDA graphs: held against the same operations
    # run one by one, on the prior case.
    from orbslam3_byzyh_tpu_torch.utils import cuda_graph
    args = graft.vi_frame_args(graft.euroc_vi_scene(
        *feats_np, depth_np, case="prior", cfg=cfg), dev)
    res_g, _, _ = graft.vi_frame_step(args, ctx, cfg)
    with cuda_graph.disabled():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_e, _, _ = graft.vi_frame_step(args, ctx, cfg)
        eager_ms = (time.perf_counter() - t0) * 1e3
    # The counts, the pose and the biases within 1e-5, H_marg within 1e-4
    # of its largest entry (both runs take cuSOLVER's LU: the 30-dim solve
    # with a prior is ill-conditioned along the biases, and another LU
    # moved them by up to 1e-4).
    pose_gap = float(np.abs(res_g.info[:14] - res_e.info[:14]).max())
    bias_gap = float(np.abs(res_g.info[14:20] - res_e.info[14:20]).max())
    h_gap = float((res_g.pose_inertial.H_marg - res_e.pose_inertial.H_marg)
                  .abs().max() / res_e.pose_inertial.H_marg.abs().max())
    require(pose_gap <= 1e-5 and bias_gap <= 1e-5 and h_gap <= 1e-4,
            f"vi frame step: the graph replay from the operations run one "
            f"by one: counts and pose {pose_gap}, biases {bias_gap}, H_marg "
            f"{h_gap} (relative)")
    out["frame"]["graph_vs_eager"] = {"pose": pose_gap, "bias": bias_gap,
                                      "H_marg_rel": h_gap,
                                      "eager_ms": eager_ms}
    phase(name, f"prior: the CUDA-graph replay of the solve against its "
          f"operations run one by one: counts and pose within "
          f"{pose_gap:.1e}, biases within {bias_gap:.1e}, H_marg within "
          f"{h_gap:.1e} of its largest entry; one step run so took "
          f"{eager_ms:.1f} ms ({card})")

    # Timing, per case with and without the prior: the read included.
    from torch.profiler import ProfilerActivity, profile
    for case in ("keyframe", "prior"):
        args = graft.vi_frame_args(graft.euroc_vi_scene(
            *feats_np, depth_np, case=case, cfg=cfg), dev)
        ms_ = []
        zero_counts()
        for i in range(N_WARMUP_VI + N_TIMED_VI_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graft.vi_frame_step(args, ctx, cfg)
            if i >= N_WARMUP_VI:
                ms_.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graft.vi_frame_step(args, ctx, cfg)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        out["frame"][f"{case}_ms"] = spread(ms_)
        out["frame"][f"{case}_device_ops"] = sum(e.count for e in ev)
        out["frame"][f"{case}_device_ms"] = sum(
            e.self_device_time_total for e in ev) / 1e3
        st = out["frame"][f"{case}_ms"]
        phase(name, f"vi_frame_step ({case}) median {st['median']:.3f} ms, "
              f"p80 {st['p80']:.3f} ms over {N_TIMED_VI_FRAMES} calls after "
              f"{N_WARMUP_VI} warm-up (min {st['min']:.3f}, max "
              f"{st['max']:.3f}), the read included; "
              f"{out['frame'][case + '_device_ops']} device operations, "
              f"{out['frame'][case + '_device_ms']:.3f} ms of device time "
              f"a call ({card})")

    # -- the keyframe step ---------------------------------------------------
    mp = graft.euroc_vi_map(cfg)
    imap = graft.vi_map_args(mp, dev)
    K = mp.kf_id + 1
    free = np.arange(K - cfg.viba_free, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graft.vi_keyframe_step(imap, mp.kf_id, mp.map_first_kf, ctx)   # capture
    torch.cuda.synchronize()
    kf_first_ms = (time.perf_counter() - t0) * 1e3
    zero_counts()
    with counted_syncs() as syncs:
        new = graft.vi_keyframe_step(imap, mp.kf_id, mp.map_first_kf, ctx)
        torch.cuda.synchronize()
    got = {n: k.launches for n, k in sk.items()}
    ids = vi.chain(mp.kf_prev, mp.kf_id, cfg.viba_window)
    cost0 = float(inertial_ba.problem_cost(vi.build_viba(
        imap, ids, list(free), cfg.viba_window, cfg.viba_landmarks,
        (0.0, 0.0), 1.0, ctx)[0]))
    cost1 = float(inertial_ba.problem_cost(vi.build_viba(
        new, ids, list(free), cfg.viba_window, cfg.viba_landmarks,
        (0.0, 0.0), 1.0, ctx)[0]))
    R0, t0_ = mp.state.kfs.R, mp.state.kfs.t
    R1, t1_ = (convert.to_numpy(x) for x in (new.state.kfs.R,
                                             new.state.kfs.t))

    def centres(R, t):
        return -np.einsum("kji,kj->ki", R[:K].astype(np.float64),
                          t[:K].astype(np.float64))
    c_true = centres(mp.R_true, mp.t_true)
    e0 = np.linalg.norm(centres(R0, t0_) - c_true, axis=-1)[free]
    e1 = np.linalg.norm(centres(R1, t1_) - c_true, axis=-1)[free]
    v1 = convert.to_numpy(new.kf_vel)
    ve0 = np.linalg.norm(mp.kf_vel[free] - mp.v_true[free], axis=-1)
    ve1 = np.linalg.norm(v1[free] - mp.v_true[free], axis=-1)
    others = np.setdiff1d(np.arange(m_cfg.max_kf), free)
    moved_fixed = float(max(np.abs(R1[others] - R0[others]).max(),
                            np.abs(t1_[others] - t0_[others]).max()))
    side = {n: convert.to_numpy(getattr(new, n)) for n in
            ("kf_vel", "kf_bg", "kf_ba")}
    side_other = max(float(np.abs(side[n][others] - getattr(mp, n)[others])
                           .max()) for n in side)
    side_free = min(float(np.abs(side[n][free] - getattr(mp, n)[free])
                          .max()) for n in side)
    require(cost1 < cost0, f"vi keyframe step: cost {cost0} -> {cost1}")
    require(e1.mean() < e0.mean() and ve1.mean() < ve0.mean(),
            f"vi keyframe step: free centres {e0.mean()} -> {e1.mean()} m, "
            f"velocities {ve0.mean()} -> {ve1.mean()} m/s from the truth")
    require(moved_fixed == 0.0, f"vi keyframe step: a fixed keyframe moved "
            f"by {moved_fixed}")
    require(side_other == 0.0 and side_free > 0.0, f"vi keyframe step: "
            f"velocities / biases written outside the free slots "
            f"({side_other}) or not at all in them ({side_free})")
    with cuda_graph.disabled():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = graft.vi_keyframe_step(imap, mp.kf_id, mp.map_first_kf, ctx)
        torch.cuda.synchronize()
        kf_eager_ms = (time.perf_counter() - t0) * 1e3
    kf_gap = max(float((a - b).abs().max()) for a, b in (
        (new.state.kfs.R, eager.state.kfs.R),
        (new.state.kfs.t, eager.state.kfs.t), (new.kf_vel, eager.kf_vel)))
    require(kf_gap <= 1e-4, f"vi keyframe step: the graph replay {kf_gap} "
            f"from the operations run one by one")
    kf_ms = []
    for i in range(N_WARMUP_KEYFRAMES + N_TIMED_KEYFRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graft.vi_keyframe_step(imap, mp.kf_id, mp.map_first_kf, ctx)
        torch.cuda.synchronize()
        if i >= N_WARMUP_KEYFRAMES:
            kf_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graft.vi_keyframe_step(imap, mp.kf_id, mp.map_first_kf, ctx)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    out["keyframe"] = {
        "cost": [cost0, cost1], "free_centre_err_m": [e0.mean(), e1.mean()],
        "free_v_err_mps": [ve0.mean(), ve1.mean()], "launches": got,
        "syncs": syncs, "ms": spread(kf_ms), "graph_vs_eager": kf_gap,
        "eager_ms": kf_eager_ms, "first_call_ms": kf_first_ms,
        "device_ops": sum(e.count for e in ev),
        "device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
        "live_kf": K,
        "landmarks": int(mp.state.lms.valid.sum())}
    st = out["keyframe"]["ms"]
    phase(name, f"vi_keyframe_step: {K} live keyframes, "
          f"{out['keyframe']['landmarks']} landmarks, window "
          f"{cfg.viba_window} ({cfg.viba_free} free), "
          f"{cfg.viba_landmarks} landmark slots: cost {cost0:.1f} -> "
          f"{cost1:.1f}; free centres {e0.mean() * 1e3:.2f} -> "
          f"{e1.mean() * 1e3:.2f} mm, velocities {ve0.mean() * 1e3:.1f} -> "
          f"{ve1.mean() * 1e3:.1f} mm/s from the truth; fixed keyframes and "
          f"the other slots' velocities and biases untouched; kernel "
          f"launches {got}; synchronisations {syncs}; median "
          f"{st['median']:.3f} ms, p80 {st['p80']:.3f} ms over "
          f"{N_TIMED_KEYFRAMES} calls (the first, its capture included, "
          f"{kf_first_ms:.1f} ms; one call op by op {kf_eager_ms:.1f} ms); "
          f"{out['keyframe']['device_ops']} "
          f"device operations, {out['keyframe']['device_ms']:.3f} ms of "
          f"device time a call ({card})")

    # -- the init step, stereo (scale fixed) and mono gates -----------------
    for case in ("stereo", "mono"):
        c = cfg if case == "stereo" else graft.mono_inertial_gates(cfg)
        mi = graft.euroc_vi_init(c, case=case)
        cx = graft.vi_context(c, dev, stereo=case == "stereo")
        imap = graft.vi_map_args(mi, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graft.vi_initialize(imap, mi.kf_id, cx, c)           # captures
        torch.cuda.synchronize()
        in_first_ms = (time.perf_counter() - t0) * 1e3
        with counted_syncs() as syncs:
            new, fit, ok = graft.vi_initialize(imap, mi.kf_id, cx, c)
            torch.cuda.synchronize()
        g_est = convert.to_numpy(fit.solve.R_wg).astype(np.float64) @ [0, 0, -1.0]
        g_true = mi.R_vw.astype(np.float64) @ [0, 0, -1.0]
        g_deg = float(np.degrees(np.arccos(np.clip(g_est @ g_true, -1, 1))))
        s_true = 1.0 if case == "stereo" else mi.scale
        s_err = abs(fit.scale - s_true) / s_true
        bg_err = float(np.abs(fit.bias[:3] - mi.bias_true[:3]).max())
        sites = sorted(w.rsplit(":", 1)[0] for w in syncs)
        require(ok and g_deg < 1.0 and s_err < 0.02 and bg_err < 2.5e-3,
                f"vi initialize ({case}): init {ok}, gravity {g_deg} deg, "
                f"scale {fit.scale} vs {s_true}, gyro bias {bg_err}")
        require(sites == [read_site], f"vi initialize ({case}): "
                f"synchronisations at {syncs}, expected one read")
        with cuda_graph.disabled():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, fit_e, _ = graft.vi_initialize(imap, mi.kf_id, cx, c)
            torch.cuda.synchronize()
            in_eager_ms = (time.perf_counter() - t0) * 1e3
        in_gap = max(abs(fit.scale - fit_e.scale),
                     float(np.abs(fit.bias - fit_e.bias).max()))
        require(in_gap <= 1e-4, f"vi initialize ({case}): the graph replay "
                f"{in_gap} from the operations run one by one")
        in_ms = []
        for i in range(N_WARMUP_INITS + N_TIMED_INITS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graft.vi_initialize(imap, mi.kf_id, cx, c)
            torch.cuda.synchronize()
            if i >= N_WARMUP_INITS:
                in_ms.append((time.perf_counter() - t0) * 1e3)
        out["init"][case] = {"gravity_deg": g_deg, "scale": fit.scale,
                             "scale_true": s_true, "scale_err": s_err,
                             "bg_err": bg_err, "syncs": syncs,
                             "ms": spread(in_ms), "chain": mi.kf_id + 1,
                             "graph_vs_eager": in_gap,
                             "eager_ms": in_eager_ms,
                             "first_call_ms": in_first_ms}
        st = out["init"][case]["ms"]
        phase(name, f"vi_initialize ({case}): {mi.kf_id + 1} keyframes "
              f"over {mi.kf_stamp[mi.kf_id]:.2f} s: gravity {g_deg:.3f} "
              f"deg, scale {fit.scale:.4f} (truth {s_true}), gyro bias "
              f"{bg_err:.2e} off; synchronisations {syncs}; median "
              f"{st['median']:.3f} ms, p80 {st['p80']:.3f} ms over "
              f"{N_TIMED_INITS} calls (the first, its captures included, "
              f"{in_first_ms:.1f} ms; one call op by op {in_eager_ms:.1f} "
              f"ms; {card})")

    out["graphs"] = len(cuda_graph._GRAPHS)
    phase(name, f"{out['graphs']} CUDA graphs captured in the phase (at "
          f"most {cuda_graph.MAX_GRAPHS} kept)")

    # -- every kernel launch of the frame steps, held against plain ---------
    for n, calls in frame_calls.items():
        for a, kw, case in calls:
            err, (b_ms, b_by, b_txt) = check_call(n, a, kw)
            entry = {"call": f"vi frame step ({case})",
                     "shape": shape_of(n, a, kw), "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
            if case == "keyframe":
                entry.update(timed(n, a, kw, plain_reps=plain_reps_of(n)))
            held[n].append(entry)
        phase(name, f"{n}: all {len(calls)} launches of the three frame "
              f"steps held against plain (max err "
              f"{max(e['max_abs_err'] for e in held[n]):.2e})")
    out["held"] = held
    return out


def phase_inertial_system(dev, card, sk, check_call, shape_of,
                          name: str = "13 inertial system", cells=None,
                          jax_ate=None) -> dict:
    """Phase "13 inertial system": ``StereoInertialSlam`` and
    ``MonoInertialSlam`` on the committed VI frames, (d) the stereo golden
    cell, (e) the mono golden cell, (f) the stereo frames at the EuRoC
    stereo-inertial capacity. Per cell: one warm-up sequence with every
    K1, K2, K3 and K3s launch held against its plain version (K3s where
    the system has stereo rows), held to its gates; then timed sequences
    (frame latency by kind, frames/s, launches, CUDA graphs captured); then
    one sequence counting the synchronisations by kind. ``cells`` (name ->
    (class, setup, frames, images, "stereo" | "mono")) and ``jax_ate`` (a
    stereo cell's JAX reference ATE, default the (d) run's) run other
    cells under phase ``name``. Returns the results and each kernel's first
    held call per cell."""
    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match
    from orbslam3_byzyh_tpu_torch.pipeline import inertial_system as vi
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.pipeline.stereo_inertial import \
        StereoInertialSlam
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt
    from orbslam3_byzyh_tpu_torch.utils import cuda_graph

    jax_ate = jax_ate or {}
    vs, vm = graft.vi_stereo_frames(), graft.vi_mono_frames()
    cells = cells or {
        "d_stereo_vi": (StereoInertialSlam,
                        graft.stereo_inertial_golden_config(), vs,
                        list(zip(vs.left, vs.right)), "stereo"),
        "e_mono_vi": (vi.MonoInertialSlam,
                      graft.mono_inertial_golden_config(), vm,
                      [(f,) for f in vm.left], "mono"),
        "f_euroc_vi": (StereoInertialSlam, graft.euroc_vi_golden_config(),
                       vs, list(zip(graft.pad_frames(vs.left),
                                    graft.pad_frames(vs.right))), "stereo")}
    spies = {"K1": (cuda_brief, "brief_descriptors_kernel"),
             "K2": (cuda_match, "hamming_best2_kernel"),
             "K3": (cuda_pose_opt, "pose_optimization_kernel"),
             "K3s": (cuda_pose_opt, "pose_optimization_stereo_kernel")}
    originals = {n: getattr(m, f) for n, (m, f) in spies.items()}
    checked, held, guard = {}, {n: [] for n in sk}, []
    bundles = []
    keyframe_step = graft.mono_keyframe_step

    def counted_bundle(*a, **kw):
        bundles.append(1)
        return keyframe_step(*a, **kw)

    def checking(cell, n):
        fn = originals[n]

        def spy(*a, **kw):
            out = fn(*a, **kw)
            if guard:
                return out
            rec = checked[cell][n]
            guard.append(n)
            try:
                # The first call's error is kept with it: held at once.
                err, b = check_call(n, a, kw, rec if rec["calls"] else None)
            finally:
                guard.pop()
            rec["calls"] += 1
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
            if rec["calls"] == 1:
                held[n].append((cell, a, kw, err, b))
            return out

        return spy

    def run(slam, frames, imgs, syncs=None):
        """``track`` over the sequence as a user's loop calls it (each
        frame with its IMU batch). Per frame: its kind, its host-clock ms,
        its launches (and, with ``syncs``, its synchronisations)."""
        out = []
        t_seq = time.perf_counter()
        for i, (img, stamp) in enumerate(zip(imgs, frames.stamps)):
            uninit = slam.status == system_mod.NOT_INITIALIZED
            ready, stage, n_b = slam.imu_ready, slam.viba_stage, len(bundles)
            before = {n: k.launches for n, k in sk.items()}
            imu = frames.imu(i)
            callers = []
            ctx = counted_syncs(callers=callers) if syncs is not None else \
                contextlib.nullcontext([])
            with ctx as where:
                t0 = time.perf_counter()
                slam.track(*img, float(stamp), imu)
                ms = (time.perf_counter() - t0) * 1e3
            if uninit:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            elif len(bundles) > n_b:
                kind = ("imu_keyframe" if slam.viba_stage != stage
                        else "keyframe")
            else:
                kind = "inertial" if ready else "visual"
            out.append({"kind": kind, "ms": ms, "syncs": list(where),
                        "callers": callers,
                        "launches": {n: k.launches - before[n]
                                     for n, k in sk.items()}})
        traj = slam.trajectory
        return out, traj, time.perf_counter() - t_seq

    def gate(cell, kind, slam, frames, traj):
        require(len(traj) > 0, f"{cell}: no frame tracked")
        v = slam._body[2] if slam._body is not None else torch.zeros(3)
        g = graft.vi_gates(kind, traj, slam.t0, frames,
                           v.detach().cpu().numpy())
        g.update(imu_ready=bool(slam.imu_ready),
                 viba_stage=int(slam.viba_stage),
                 live_keyframes=int(slam.state.kfs.valid.sum()),
                 live_landmarks=int(slam.state.lms.valid.sum()))
        ok = g["ok"] and slam.imu_ready
        if kind == "stereo":
            g["jax_ate_m"] = jax_ate.get(cell, graft.VI_STEREO_JAX_ATE_M)
            jax_gate = 1.5 * g["jax_ate_m"] + 0.002
            ok = ok and g["ate_m"] < jax_gate
            limit = (f"imu_ready, >= {graft.VI_STEREO_MIN_FRAMES} frames, "
                     f"ATE < {graft.VI_STEREO_ATE_GATE_M} m and < "
                     f"{jax_gate:.5f} m (1.5 x the JAX run's + 0.002), "
                     f"speed within {graft.VI_SPEED_TOL_MPS} m/s")
        else:
            g["jax_ate_m"] = graft.VI_MONO_JAX_ATE_M
            ok = ok and slam.viba_stage >= 2
            limit = (f"imu_ready, viba_stage >= 2, >= "
                     f"{graft.VI_MONO_MIN_FRAMES} frames; after "
                     f"{graft.VI_MONO_POST_S} s: scale within "
                     f"{graft.VI_MONO_SCALE_TOL} of 1, ATE < "
                     f"{graft.VI_MONO_ATE_GATE_M} m, gravity within "
                     f"{graft.VI_MONO_GRAVITY_DEG} deg; no single-frame "
                     f"outlier; speed within {graft.VI_SPEED_TOL_MPS} m/s")
        require(ok, f"{cell}: {g} against {limit}")
        return g

    out = {}
    graft.mono_keyframe_step = counted_bundle
    try:
        for cell, (cls, setup, frames, imgs, kind) in cells.items():
            checked[cell] = {n: {"calls": 0, "max_abs_err": 0.0} for n in sk}
            for n_, (m, f) in spies.items():
                setattr(m, f, checking(cell, n_))
            cap0 = cuda_graph.CAPTURES[0]
            try:
                slam = cls(setup.config, setup.imu, **setup.viba)
                _, traj, sec = run(slam, frames, imgs)
                torch.cuda.synchronize()
                check_call.settle()
            finally:
                for n_, (m, f) in spies.items():
                    setattr(m, f, originals[n_])
            warm = gate(cell, kind, slam, frames, traj)
            warm.update(seconds=sec,
                        graphs_captured=cuda_graph.CAPTURES[0] - cap0)
            # K3s runs where the system has stereo rows (a right-image u).
            used = [n for n in sk if n != "K3s" or slam._ur is not None]
            require(all(checked[cell][n]["calls"] > 0 for n in used),
                    f"{cell}: kernels launched {checked[cell]}")
            phase(name, f"{cell}: warm-up sequence, every launch held "
                  "against its plain version: " + ", ".join(
                      f"{n} {checked[cell][n]['calls']} calls max err "
                      f"{checked[cell][n]['max_abs_err']:.2e}" for n in sk)
                  + f"; {json.dumps(warm)}")
            recs, seqs = [], []
            for _ in range(N_TIMED_VI_SEQUENCES):
                slam = cls(setup.config, setup.imu, **setup.viba)
                for k in sk.values():
                    k.launches = 0
                cap0 = cuda_graph.CAPTURES[0]
                torch.cuda.synchronize()
                r, traj, sec = run(slam, frames, imgs)
                res = gate(cell, kind, slam, frames, traj)
                res.update(seconds=sec, fps=len(imgs) / sec,
                           graphs_captured=cuda_graph.CAPTURES[0] - cap0,
                           launches={n: k.launches for n, k in sk.items()})
                require(all(res["launches"][n] > 0 for n in used),
                        f"{cell}: launches {res['launches']}")
                seqs.append(res)
                recs += r
            slam = cls(setup.config, setup.imu, **setup.viba)
            sync_recs, _, _ = run(slam, frames, imgs, syncs=True)
            kinds = {}
            for k_ in ("uninitialised", "init", "visual", "inertial",
                       "keyframe", "imu_keyframe"):
                rs = [r for r in recs if r["kind"] == k_]
                ws = [r["syncs"] for r in sync_recs if r["kind"] == k_]
                cs = [r["callers"] for r in sync_recs if r["kind"] == k_]
                st = spread(r["ms"] for r in rs)
                st["launches_per_frame"] = {
                    n: (sum(r["launches"][n] for r in rs) / len(rs) if rs
                        else None) for n in sk}
                sites = {}
                for w in ws:
                    for site in w:
                        sites[site] = sites.get(site, 0) + 1
                st["syncs_per_frame"] = (sum(len(w) for w in ws) / len(ws)
                                         if ws else None)
                st["sync_sites"] = {k: v / len(ws)
                                    for k, v in sorted(sites.items())}
                asked = {}
                for c in cs:
                    for site in c:
                        asked[site] = asked.get(site, 0) + 1
                st["sync_callers"] = {k: v / len(cs)
                                      for k, v in sorted(asked.items())}
                st["jax_host_reads"] = JAX_VI_READS[k_]
                kinds[k_] = st
                if st["n"]:
                    phase(name, f"{cell}: {k_} frames ({st['n']} over "
                          f"{N_TIMED_VI_SEQUENCES} sequences): track() "
                          f"median {st['median']:.3f} ms, p80 "
                          f"{st['p80']:.3f} ms (min {st['min']:.3f}, max "
                          f"{st['max']:.3f}); launches per frame "
                          f"{st['launches_per_frame']}; "
                          f"{st['syncs_per_frame']} synchronisations per "
                          f"frame {st['sync_sites']}, asked for by "
                          f"{st['sync_callers']}; the JAX system reads "
                          f"{JAX_VI_READS[k_]} ({card})")
            fps = [r["fps"] for r in seqs]
            phase(name, f"{cell}: {len(imgs)} frames in "
                  + ", ".join(f"{r['seconds']:.3f}" for r in seqs) + " s = "
                  + ", ".join(f"{f:.2f}" for f in fps) + " frames/s; "
                  f"graphs captured: warm-up {warm['graphs_captured']}, "
                  f"timed {[r['graphs_captured'] for r in seqs]}; ATE "
                  f"{[round(r['ate_m'], 5) for r in seqs]} m (JAX "
                  f"{seqs[0]['jax_ate_m']:.5f}), frames "
                  f"{[r['frames'] for r in seqs]}, speed error "
                  f"{[round(r['speed_err_mps'], 4) for r in seqs]} m/s, "
                  f"viba_stage {[r['viba_stage'] for r in seqs]} ({card})")
            out[cell] = {"config": {k: v for k, v in dataclasses.asdict(
                setup.config).items() if not isinstance(v, np.ndarray)},
                "viba": setup.viba, "warmup": warm, "sequences": seqs,
                "frame_kinds": kinds, "fps": spread(fps),
                "checked": checked[cell]}
    finally:
        graft.mono_keyframe_step = keyframe_step
    out["graphs_kept"] = len(cuda_graph._GRAPHS)
    return out, held


def fisheye_margins(xy_l, lvl_l, xy_r, lvl_r, bj, cam_l, cam_r, R_rl,
                    t_rl) -> np.ndarray:
    """Per left keypoint, in float64 from a float64 DLT of it and its best
    right keypoint: the smallest relative distance of one of
    ``fisheye_stereo_match``'s float gates (parallax cos 0.9998, the depth
    in each camera, the reprojection chi2 5.991 sigma^2 in each view) to
    its threshold."""
    f = lambda a: np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                             else a, np.float64)
    j = np.clip(f(bj).astype(np.int64), 0, None)
    xl, xr = f(xy_l), f(xy_r)[j]
    cl, cr, R, t = f(cam_l), f(cam_r), f(R_rl), f(t_rl)
    r1 = np.stack([(xl[:, 0] - cl[2]) / cl[0], (xl[:, 1] - cl[3]) / cl[1],
                   np.ones(len(xl))], -1)
    r2 = np.stack([(xr[:, 0] - cr[2]) / cr[0], (xr[:, 1] - cr[3]) / cr[1],
                   np.ones(len(xr))], -1)
    r2l = r2 @ R
    cos = (r1 * r2l).sum(-1) / (np.linalg.norm(r1, axis=-1)
                                * np.linalg.norm(r2l, axis=-1))
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t[:, None]])
    A = np.stack([r1[:, 0, None] * P1[2] - P1[0],
                  r1[:, 1, None] * P1[2] - P1[1],
                  r2[:, 0, None] * P2[2] - P2[0],
                  r2[:, 1, None] * P2[2] - P2[1]], 1)
    Xh = np.linalg.svd(A)[2][:, 3]
    X = Xh[:, :3] / Xh[:, 3:]
    X2 = X @ R.T + t
    out = [np.abs(cos - 0.9998) / 0.9998,
           np.abs(X[:, 2]) / np.linalg.norm(X, axis=-1),
           np.abs(X2[:, 2]) / np.linalg.norm(X2, axis=-1)]
    for Xc, xo, c, lv in ((X, xl, cl, f(lvl_l)), (X2, xr, cr, f(lvl_r)[j])):
        uv = np.stack([c[0] * Xc[:, 0] / Xc[:, 2] + c[2],
                       c[1] * Xc[:, 1] / Xc[:, 2] + c[3]], -1)
        th = 5.991 * 1.2 ** (2 * lv)
        out.append(np.abs(((uv - xo) ** 2).sum(-1) - th) / th)
    return np.min(out, axis=0)


def phase_fisheye(dev, card, sk, check_call, timed, shape_of) -> dict:
    """Phase "14 fisheye": the non-rectified stereo path and the
    Kannala-Brandt camera. (a) the TUM-VI 512 extraction step
    (``graft.fisheye_stereo_extract``: K1 on each raw 512x512 KB8 image,
    the keypoints rectified onto each camera's virtual pinhole, K2's none
    mode over 1000 x 1000 descriptors, the DLT and its gates) on the
    stereo-inertial fixture's first pair warped to TUM-VI's pair: every
    launch held against its plain version, the match against the CPU plain
    path on the same features, the depths against the render's, the
    synchronisations named, 50 timed calls; (b) cell (g),
    ``FisheyeStereoSlam`` on the fisheye fixture at the JAX test's
    configuration: a warm-up sequence with every launch held, its gates
    (test_fisheye_stereo_system.py's and the JAX run's ATE), timed
    sequences by frame kind, one sequence counting synchronisations; (c)
    cell (h), ``FisheyeStereoInertialSlam`` on the warped stereo-inertial
    frames at TUM-VI 512's capacity, run as phase 13 runs its cells.
    Returns the results, the held calls of (a) and of (b), and each
    kernel's first held call in (c)."""
    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match, stereo
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.pipeline.stereo_inertial import \
        FisheyeStereoInertialSlam
    from orbslam3_byzyh_tpu_torch.pipeline.stereo_system import \
        FisheyeStereoSlam
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

    name = "14 fisheye"
    out = {}

    # -- (a) the TUM-VI 512 extraction step ---------------------------------
    vs = graft.vi_stereo_frames()
    left, right = graft.tumvi_kb8_pair(vs.left[0], vs.right[0])
    setup = graft.tumvi_vi_golden_config()
    rig = graft.fisheye_rig_config(setup.config)
    tens = graft.fisheye_rig_tensors(rig, dev)
    img_l = torch.from_numpy(left).to(dev).float()
    img_r = torch.from_numpy(right).to(dev).float()
    torch.cuda.synchronize()
    with recorded(cuda_brief, "brief_descriptors_kernel") as k1_calls, \
            recorded(cuda_match, "hamming_best2_kernel") as k2_calls:
        for k in sk.values():
            k.launches = 0
        fl, fr, m = graft.fisheye_stereo_extract(img_l, img_r, rig, tens)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in sk.items()}
    require(launches == {"K1": 2, "K2": 1, "K3": 0, "K3s": 0},
            f"fisheye_stereo_extract launches {launches}")
    n_feat = rig.mono.n_features
    k2_shape = shape_of("K2", *k2_calls[0])
    require((k2_shape["N"], k2_shape["M"], k2_shape["mode"])
            == (n_feat, n_feat, "none"), f"K2's call {k2_shape}")
    a_calls = {n: [] for n in sk}
    for n, calls in (("K1", k1_calls), ("K2", k2_calls)):
        for a, kw in calls:
            err, (b_ms, b_by, b_txt) = check_call(n, a, kw)
            entry = {"call": "fisheye extraction step",
                     "shape": shape_of(n, a, kw), "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
            entry.update(timed(n, a, kw, plain_reps=20))
            a_calls[n].append(entry)
            phase(name, f"(a) {n} {entry['shape']}: identical to plain; "
                  f"launch alone {entry['ms']:.4f} ms, wrapper "
                  f"{entry['wrapper_ms']:.4f} ms, plain "
                  f"{entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by} ({card})")
    # The match's CPU plain path on the card's features.
    cpu = lambda x: x.detach().cpu()
    m_cpu = stereo.fisheye_stereo_match(
        *(cpu(x) for x in (fl.xy, fl.level, fl.desc, fl.valid, fr.xy,
                           fr.level, fr.desc, fr.valid, tens.cam_l,
                           tens.cam_r, tens.R_rl, tens.t_rl)))
    ok_g, ok_c = cpu(m.valid).numpy(), m_cpu.valid.numpy()
    mj_g, mj_c = cpu(m.match_j).numpy(), m_cpu.match_j.numpy()
    diff = np.flatnonzero((ok_g != ok_c) | (mj_g != mj_c))
    bj = cuda_match.hamming_best2_plain(cpu(fl.desc), cpu(fr.desc),
                                        cpu(fl.valid), cpu(fr.valid))[2]
    if len(diff):
        margin = fisheye_margins(fl.xy, fl.level, fr.xy, fr.level, bj,
                                 tens.cam_l, tens.cam_r, tens.R_rl,
                                 tens.t_rl)
        near = margin < FISHEYE_FLIP_MARGIN
        shared = np.isin(bj.numpy(), bj.numpy()[near])
        for i in diff:
            phase(name, f"(a) row {i}: card {ok_g[i]} {mj_g[i]}, CPU "
                  f"{ok_c[i]} {mj_c[i]}, gate margin {margin[i]:.2e}")
        require(np.all(near[diff] | shared[diff]),
                f"(a) card and CPU disagree beyond the gates' margins on "
                f"rows {diff.tolist()}")
    both = ok_g & ok_c
    d_g, d_c = cpu(m.depth).numpy(), m_cpu.depth.numpy()
    depth_rel = float((np.abs(d_g[both] - d_c[both])
                       / np.abs(d_c[both])).max()) if both.any() else 0.0
    require(depth_rel <= 1e-4, f"(a) depth {depth_rel:.2e} from the CPU's")
    # Every right keypoint is taken at most once (the mutual filter), so
    # duplicate columns cannot race.
    taken = mj_g[ok_g]
    require(len(np.unique(taken)) == len(taken), "(a) a right keypoint "
            "matched twice")
    # The depths against the render's: each matched keypoint's virtual-
    # pinhole pixel lies in the render's pinhole (the same focal length),
    # shifted by the principal points.
    fg = graft.fisheye_frames()
    true_z = fg.vi_depth0.astype(np.float64) / fg.depth_factor
    cx_r, cy_r = (float(x) for x in vs.camera[2:4])
    xy = cpu(fl.xy).numpy().astype(np.float64)
    u = np.round(xy[:, 0] - rig.mono.cx + cx_r).astype(np.int64)
    v = np.round(xy[:, 1] - rig.mono.cy + cy_r).astype(np.int64)
    inside = (u >= 0) & (u < true_z.shape[1]) & (v >= 0) \
        & (v < true_z.shape[0])
    zt = np.where(inside, true_z[v.clip(0, true_z.shape[0] - 1),
                                 u.clip(0, true_z.shape[1] - 1)], 0.0)
    sel = ok_g & (zt > 0)
    rel = np.abs(d_g[sel] - zt[sel]) / zt[sel]
    depth_truth = {"matched": int(ok_g.sum()), "with_truth": int(sel.sum()),
                   "median_rel": float(np.median(rel)),
                   "p80_rel": float(np.quantile(rel, 0.8)),
                   "share_within_2pct": float((rel < 0.02).mean())}
    require(sel.sum() >= 50 and depth_truth["median_rel"]
            < FISHEYE_DEPTH_MEDIAN_TOL, f"(a) depths against the render's: "
            f"{depth_truth}")
    # The synchronisations of one call, by site.
    with counted_syncs() as where_a:
        graft.fisheye_stereo_extract(img_l, img_r, rig, tens)
    sites = {}
    for w in where_a:
        sites[w] = sites.get(w, 0) + 1
    # Timing: the call ending in a synchronisation.
    ms_a = []
    for i in range(10 + N_TIMED_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graft.fisheye_stereo_extract(img_l, img_r, rig, tens)
        torch.cuda.synchronize()
        if i >= 10:
            ms_a.append((time.perf_counter() - t0) * 1e3)
    out["extract"] = {
        "shape": [rig.mono.height, rig.mono.width, n_feat],
        "launches": launches, "matches": int(ok_g.sum()),
        "cpu_flips": len(diff), "depth_rel_to_cpu": depth_rel,
        "depth_truth": depth_truth, "syncs": len(where_a),
        "sync_sites": sites, "ms": spread(ms_a)}
    st = out["extract"]["ms"]
    phase(name, f"(a) fisheye_stereo_extract {rig.mono.width}x"
          f"{rig.mono.height} KB8, {n_feat} features: launches {launches}; "
          f"{int(ok_g.sum())} matches, {len(diff)} rows differ from the CPU "
          f"plain path (within the gates' margins), depth within "
          f"{depth_rel:.2e} of it; against the render's depth "
          f"{json.dumps(depth_truth)}; {len(where_a)} synchronisations "
          f"{sites}; median {st['median']:.3f} ms, p80 {st['p80']:.3f} ms "
          f"over {N_TIMED_FRAMES} calls (min {st['min']:.3f}, max "
          f"{st['max']:.3f}), synchronised ({card})")

    # -- (b) cell (g): FisheyeStereoSlam on the fisheye fixture -------------
    spies = {"K1": (cuda_brief, "brief_descriptors_kernel"),
             "K2": (cuda_match, "hamming_best2_kernel"),
             "K3": (cuda_pose_opt, "pose_optimization_kernel"),
             "K3s": (cuda_pose_opt, "pose_optimization_stereo_kernel")}
    originals = {n: getattr(mod, f) for n, (mod, f) in spies.items()}
    checked = {n: {"calls": 0, "max_abs_err": 0.0} for n in sk}
    g_calls = {n: [] for n in sk}
    guard, bundles = [], []
    keyframe_step = graft.mono_keyframe_step

    def counted_bundle(*a, **kw):
        bundles.append(1)
        return keyframe_step(*a, **kw)

    def checking(n):
        fn = originals[n]

        def spy(*a, **kw):
            res = fn(*a, **kw)
            if guard:
                return res
            guard.append(n)
            try:
                # The first call's error is kept with it: held at once.
                err, b = check_call(n, a, kw, checked[n] if checked[n][
                    "calls"] else None)
            finally:
                guard.pop()
            checked[n]["calls"] += 1
            checked[n]["max_abs_err"] = max(checked[n]["max_abs_err"],
                                            float(err))
            if checked[n]["calls"] == 1:
                g_calls[n].append((a, kw, err, b))
            return res

        return spy

    def gate_g(slam, traj):
        require(len(traj) > 0, "(g): no frame tracked")
        res = graft.fisheye_gates(traj, slam.t0, fg)
        res.update(jax_ate_m=graft.FISHEYE_JAX_ATE_M, status=slam.status,
                   n_kf=slam.n_kf, n_lm=slam.n_lm,
                   live_keyframes=int(slam.state.kfs.valid.sum()),
                   live_landmarks=int(slam.state.lms.valid.sum()))
        ok = (res["ok"] and slam.status == system_mod.OK and slam.n_kf >= 1
              and slam.n_lm > 50
              and res["ate_m"] < graft.FISHEYE_JAX_ATE_GATE_M)
        require(ok, f"(g): {res} against status OK, n_kf >= 1, n_lm > 50, "
                f"> {graft.FISHEYE_MIN_FRAMES} frames, ATE < "
                f"{graft.FISHEYE_ATE_GATE_M} m and < "
                f"{graft.FISHEYE_JAX_ATE_GATE_M:.5f} m (1.5 x the JAX "
                f"run's + 0.002), path within {graft.FISHEYE_PATH_TOL:.0%}")
        return res

    cfg_g = graft.fisheye_stereo_golden_config(fg)
    imgs_g = list(zip(fg.left, fg.right))
    graft.mono_keyframe_step = counted_bundle
    try:
        for n_, (mod, f) in spies.items():
            setattr(mod, f, checking(n_))
        try:
            slam = FisheyeStereoSlam(cfg_g)
            _, traj, sec = run_sequence(slam, imgs_g, fg.stamps, sk, bundles)
            torch.cuda.synchronize()
            check_call.settle()
        finally:
            for n_, (mod, f) in spies.items():
                setattr(mod, f, originals[n_])
        warm = gate_g(slam, traj)
        warm["seconds"] = sec
        require(all(checked[n]["calls"] > 0 for n in ("K1", "K2", "K3"))
                and checked["K3s"]["calls"] == 0,
                f"(g): kernels launched {checked}")
        phase(name, "(g) warm-up sequence, every launch held against its "
              "plain version: " + ", ".join(
                  f"{n} {checked[n]['calls']} calls max err "
                  f"{checked[n]['max_abs_err']:.2e}" for n in sk)
              + f"; {json.dumps(warm)}")
        recs, seqs = [], []
        for _ in range(N_TIMED_STEREO_SEQUENCES):
            slam = FisheyeStereoSlam(cfg_g)
            for k in sk.values():
                k.launches = 0
            torch.cuda.synchronize()
            r, traj, sec = run_sequence(slam, imgs_g, fg.stamps, sk,
                                        bundles)
            res = gate_g(slam, traj)
            res.update(seconds=sec, fps=len(imgs_g) / sec,
                       launches={n: k.launches for n, k in sk.items()})
            require(all(res["launches"][n] > 0 for n in ("K1", "K2", "K3")),
                    f"(g): launches {res['launches']}")
            seqs.append(res)
            recs += r
        slam = FisheyeStereoSlam(cfg_g)
        sync_recs = []
        for fr_, stamp in zip(imgs_g, fg.stamps):
            uninit = slam.status == system_mod.NOT_INITIALIZED
            n_b = len(bundles)
            callers = []
            with counted_syncs(callers=callers) as where:
                slam.track(*fr_, float(stamp))
            if uninit:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            else:
                kind = "keyframe" if len(bundles) > n_b else "tracked"
            sync_recs.append((kind, list(where), callers))
    finally:
        graft.mono_keyframe_step = keyframe_step
    kinds = {}
    for kind in ("uninitialised", "init", "tracked", "keyframe"):
        rs = [r for r in recs if r["kind"] == kind]
        st = spread(r["ms"] for r in rs)
        st["launches_per_frame"] = {
            n: (sum(r["launches"][n] for r in rs) / len(rs) if rs else None)
            for n in sk}
        ws = [w for k_, w, _ in sync_recs if k_ == kind]
        cs = [c for k_, _, c in sync_recs if k_ == kind]
        st["syncs_per_frame"] = (sum(len(w) for w in ws) / len(ws) if ws
                                 else None)
        asked = {}
        for c in cs:
            for site in c:
                asked[site] = asked.get(site, 0) + 1
        st["sync_callers"] = {k: v / len(cs) for k, v in sorted(
            asked.items())}
        sites = {}
        for w in ws:
            for site in w:
                sites[site] = sites.get(site, 0) + 1
        st["sync_sites"] = {k: v / len(ws) for k, v in sorted(sites.items())}
        st["jax_host_reads"] = JAX_STEREO_READS[kind]
        kinds[kind] = st
        if st["n"]:
            phase(name, f"(g) {kind} frames ({st['n']} over "
                  f"{N_TIMED_STEREO_SEQUENCES} sequences): track() median "
                  f"{st['median']:.3f} ms, p80 {st['p80']:.3f} ms (min "
                  f"{st['min']:.3f}, max {st['max']:.3f}); launches per "
                  f"frame {st['launches_per_frame']}; "
                  f"{st['syncs_per_frame']} synchronisations per frame "
                  f"{st['sync_sites']}, asked for by {st['sync_callers']} "
                  f"({card})")
    fps = [r["fps"] for r in seqs]
    phase(name, f"(g) {len(imgs_g)} frames in "
          + ", ".join(f"{r['seconds']:.3f}" for r in seqs) + " s = "
          + ", ".join(f"{f_:.2f}" for f_ in fps) + " frames/s; ATE "
          f"{[round(r['ate_m'], 5) for r in seqs]} m (JAX "
          f"{graft.FISHEYE_JAX_ATE_M:.5f}), frames "
          f"{[r['frames'] for r in seqs]}, path error "
          f"{[round(r['path_err'], 4) for r in seqs]} ({card})")
    out["g_fisheye_stereo"] = {
        "config": {k: v for k, v in dataclasses.asdict(cfg_g).items()
                   if not isinstance(v, np.ndarray)},
        "warmup": warm, "sequences": seqs, "frame_kinds": kinds,
        "fps": spread(fps), "checked": checked}

    # -- (c) cell (h): FisheyeStereoInertialSlam at TUM-VI 512 capacity -----
    hv = graft.tumvi_vi_frames(vs)
    h_out, h_held = phase_inertial_system(
        dev, card, sk, check_call, shape_of, name=name,
        cells={"h_tumvi_vi": (FisheyeStereoInertialSlam, setup, hv,
                              list(zip(hv.left, hv.right)), "stereo")},
        jax_ate={"h_tumvi_vi": graft.TUMVI_VI_JAX_ATE_M})
    out.update(h_out)
    return out, a_calls, g_calls, h_held


def phase_reloc(dev, card, sk, check_call, timed, shape_of) -> tuple:
    """Phase "15 reloc": place recognition and relocalization at the
    EuRoC-mono capacity (``graft.EUROC_MONO``'s 1024 / 65536 / 12 slots,
    1536 features, the golden frames padded to 752x480) with the runners'
    10k-word vocabulary. Cells (i) and (j) (``graft.reloc_sequence``):
    ``MonoSlam`` with the vocabulary and loop closing off, a warm-up
    sequence with every launch from the blackout on held against its
    plain version, the gates of ``graft.reloc_run_gates``,
    timed sequences by frame kind (a
    relocalizing frame and a lost frame, one that tried and failed, apart)
    and one sequence counting synchronisations. The step: ``graft.relocalize``
    on the map, database and frame of (i)'s warm-up relocalization, its
    launches held and timed, the CPU plain path with the card's draws, its
    synchronisations, 20 timed calls. The database at deployment width:
    ``real_voc_100k.npz`` over 1024 rows filled from that map's keyframes.
    Returns the results and each kernel's held calls of the step with
    their times."""
    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.ops import bow, cuda_brief, cuda_match
    from orbslam3_byzyh_tpu_torch.pipeline import keyframe_db
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

    name = "15 reloc"
    t15 = time.perf_counter()
    out = {}
    gold = graft.golden_frames()
    t0 = time.perf_counter()
    voc = bow.load_vocabulary(graft.RELOC_VOCABULARY, dev)
    torch.cuda.synchronize()
    out["vocabulary_load_s"] = time.perf_counter() - t0
    spies = {"K1": (cuda_brief, "brief_descriptors_kernel"),
             "K2": (cuda_match, "hamming_best2_kernel"),
             "K3": (cuda_pose_opt, "pose_optimization_kernel"),
             "K3s": (cuda_pose_opt, "pose_optimization_stereo_kernel")}
    originals = {n: getattr(mod, f) for n, (mod, f) in spies.items()}
    checked = {}
    guard, bundles, attempts, captured = [], [], [], []
    # The held warm-up holds the launches from the blackout on: the frames
    # before it are phase 10's EuRoC-capacity path, held there.
    holding = [False]
    keyframe_step, relocalize = graft.mono_keyframe_step, graft.relocalize

    def counted_bundle(*a, **kw):
        bundles.append(1)
        return keyframe_step(*a, **kw)

    def spy_reloc(state, db, feats, *a, **kw):
        r = relocalize(state, db, feats, *a, **kw)
        attempts.append(r.success)
        if r.success and not captured:
            # The inputs as they stand now: the database grows in place.
            copy = keyframe_db.KeyframeDatabase(db.voc, 1, 1)
            copy.vecs, copy.words, copy.valid = (
                x.clone() for x in (db.vecs, db.words, db.valid))
            captured.append((state, copy, feats, a, dict(kw), r))
        return r

    def checking(cell, n):
        fn = originals[n]

        def spy(*a, **kw):
            res = fn(*a, **kw)
            if guard or not holding[0]:
                return res
            rec = checked[cell][n]
            guard.append(n)
            try:
                err, _ = check_call(n, a, kw, rec)
            finally:
                guard.pop()
            rec["calls"] += 1
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
            return res

        return spy

    def run_cell(cfg, seq, syncs=False):
        """The cell's frames through a fresh MonoSlam: per frame its kind,
        host-clock ms, launches (and synchronisations); the statuses, the
        active maps, the keyframe slots before the blackout, the
        trajectory and the sequence's seconds."""
        slam = system_mod.MonoSlam(cfg)
        recs, statuses, maps, n_kf_before, live_before = [], [], [], 0, 0
        t_seq = time.perf_counter()
        for i, f in enumerate(seq):
            holding[0] = i >= graft.RELOC_TRACKED
            was = slam.status
            n_b, n_a = len(bundles), len(attempts)
            before = {n: k.launches for n, k in sk.items()}
            callers = []
            ctx = (counted_syncs(callers=callers) if syncs
                   else contextlib.nullcontext([]))
            with ctx as where:
                t0 = time.perf_counter()
                slam.track(f.image, f.stamp)
                ms_ = (time.perf_counter() - t0) * 1e3
            tried = attempts[n_a:]
            if any(tried):
                kind = "reloc"
            elif tried:
                kind = "lost"
            elif was == system_mod.NOT_INITIALIZED:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            else:
                kind = "keyframe" if len(bundles) > n_b else "tracked"
            recs.append({"kind": kind, "ms": ms_, "status": slam.status,
                         "syncs": list(where), "callers": callers,
                         "launches": {n: k.launches - before[n]
                                      for n, k in sk.items()}})
            statuses.append(slam.status)
            maps.append(slam.atlas.current)
            if i == graft.RELOC_TRACKED - 1:
                n_kf_before = slam.n_kf
                live_before = int(slam.state.kfs.valid.sum())
        traj = slam.trajectory
        return (slam, recs, statuses, maps, n_kf_before, live_before, traj,
                time.perf_counter() - t_seq)

    def gate(cell, seq, run):
        slam, recs, statuses, maps, n_kf_before, live_before, traj, sec = run
        res = graft.reloc_run_gates(cell, statuses, maps,
                                    len(slam.atlas.maps), n_kf_before,
                                    slam.n_kf, traj, slam.t0, seq, gold)
        live_after = int(slam.state.kfs.valid.sum())
        res.update(jax=graft.RELOC_JAX[cell], seconds=sec,
                   fps=len(seq) / sec, live_keyframes_before=live_before,
                   live_keyframes_after=live_after,
                   n_cross_map_relocs=slam.n_cross_map_relocs,
                   kinds=[r["kind"] for r in recs])
        require(res["ok"] and (cell == "i" or live_after >= live_before)
                and slam.n_cross_map_relocs == (1 if cell == "j" else 0),
                f"({cell}): {res} against the JAX run's frame "
                f"{graft.RELOC_JAX[cell]['index']} +- 1 into map "
                f"{graft.RELOC_JAX[cell]['map']}, status OK after it, the "
                f"centre within {graft.RELOC_CENTRE_GATE_M} m")
        return res

    cells = {"i": "i_reloc", "j": "j_cross_map"}
    step_calls = {n: [] for n in sk}
    graft.mono_keyframe_step = counted_bundle
    graft.relocalize = spy_reloc
    try:
        for cell, key in cells.items():
            seq = graft.reloc_sequence(cell, gold)
            cfg = graft.reloc_golden_config(cell, voc)
            # Each cell's warm-up holds every launch from the blackout on
            # against its plain version: (j)'s include the new map's init
            # and the relocalization against the older map's state.
            checked[key] = {n: {"calls": 0, "max_abs_err": 0.0} for n in sk}
            for n_, (mod, f) in spies.items():
                setattr(mod, f, checking(key, n_))
            try:
                run = run_cell(cfg, seq)
                torch.cuda.synchronize()
                check_call.settle()
            finally:
                for n_, (mod, f) in spies.items():
                    setattr(mod, f, originals[n_])
            warm = gate(cell, seq, run)
            ch = checked[key]
            require(all(ch[n]["calls"] > 0 for n in ("K1", "K2", "K3"))
                    and ch["K3s"]["calls"] == 0,
                    f"({cell}): kernels launched {ch}")
            phase(name, f"({cell}) warm-up sequence, every launch from the "
                  "blackout on held against its plain version: "
                  + ", ".join(f"{n} {ch[n]['calls']} calls max err "
                              f"{ch[n]['max_abs_err']:.2e}" for n in sk)
                  + f"; {json.dumps(warm)} ({card})")
            if cell == "i":
                require(len(captured) == 1, "(i): no relocalization captured")
                step, step_calls = reloc_step(
                    dev, card, name, sk, check_call, timed, shape_of,
                    captured[0])
                out["step"] = step
                out["database"] = reloc_database(dev, card, name,
                                                 captured[0], voc)
            seqs, recs = [], []
            for _ in range(N_TIMED_RELOC_SEQUENCES[cell]):
                for k in sk.values():
                    k.launches = 0
                torch.cuda.synchronize()
                run = run_cell(cfg, seq)
                res = gate(cell, seq, run)
                res["launches"] = {n: k.launches for n, k in sk.items()}
                require(all(res["launches"][n] > 0
                            for n in ("K1", "K2", "K3")),
                        f"({cell}): launches {res['launches']}")
                seqs.append(res)
                recs += run[1]
            sync_run = run_cell(cfg, seq, syncs=True)
            gate(cell, seq, sync_run)
            kinds = {}
            for kind in ("uninitialised", "init", "tracked", "keyframe",
                         "lost", "reloc"):
                rs = [r for r in recs if r["kind"] == kind]
                st = spread(r["ms"] for r in rs)
                st["launches_per_frame"] = {
                    n: (sum(r["launches"][n] for r in rs) / len(rs)
                        if rs else None) for n in sk}
                ss = [r for r in sync_run[1] if r["kind"] == kind]
                st["syncs_per_frame"] = (sum(len(r["syncs"]) for r in ss)
                                         / len(ss) if ss else None)
                sites, asked = {}, {}
                for r in ss:
                    for w in r["syncs"]:
                        sites[w] = sites.get(w, 0) + 1
                    for c in r["callers"]:
                        asked[c] = asked.get(c, 0) + 1
                st["sync_sites"] = {k: v / len(ss)
                                    for k, v in sorted(sites.items())}
                st["sync_callers"] = {k: v / len(ss)
                                      for k, v in sorted(asked.items())}
                st["jax_host_reads"] = JAX_RELOC_READS[kind]
                kinds[kind] = st
                if st["n"]:
                    phase(name, f"({cell}) {kind} frames ({st['n']} over "
                          f"{len(seqs)} sequences): track() median "
                          f"{st['median']:.3f} ms, p80 {st['p80']:.3f} ms "
                          f"(min {st['min']:.3f}, max {st['max']:.3f}); "
                          f"launches per frame {st['launches_per_frame']}; "
                          f"{st['syncs_per_frame']} synchronisations per "
                          f"frame {st['sync_sites']}, asked for by "
                          f"{st['sync_callers']} ({card})")
            fps = [r["fps"] for r in seqs]
            phase(name, f"({cell}) {len(seq)} frames in "
                  + ", ".join(f"{r['seconds']:.3f}" for r in seqs) + " s = "
                  + ", ".join(f"{f_:.2f}" for f_ in fps) + " frames/s; "
                  f"relocalized at frame {[r['reloc_index'] for r in seqs]} "
                  f"(JAX {graft.RELOC_JAX[cell]['index']}) into map "
                  f"{[r['reloc_map'] for r in seqs]}, centre error "
                  f"{[round(r['reloc_err_m'], 5) for r in seqs]} m (JAX "
                  f"{graft.RELOC_JAX[cell]['reloc_err_m']:.5f}) ({card})")
            out[key] = {
                "config": {k: v for k, v in dataclasses.asdict(
                    dataclasses.replace(cfg, vocabulary=None)).items()
                           if not isinstance(v, np.ndarray)},
                "warmup": warm, "sequences": seqs, "frame_kinds": kinds,
                "fps": spread(fps), "checked": checked[key]}
    finally:
        graft.mono_keyframe_step = keyframe_step
        graft.relocalize = relocalize
    out["seconds"] = time.perf_counter() - t15
    phase(name, f"phase took {out['seconds']:.1f} s")
    return out, step_calls


def reloc_step(dev, card, name, sk, check_call, timed, shape_of,
               captured) -> tuple:
    """Phase 15's step: ``graft.relocalize`` on a captured relocalization's
    inputs. Returns its results and each kernel's held calls with their
    times."""
    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.models import map_state as ms
    from orbslam3_byzyh_tpu_torch.ops import bow, cuda_match, pnp
    from orbslam3_byzyh_tpu_torch.pipeline import keyframe_db
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

    state, db, feats, a, kw, sys_res = captured
    cam, cfg, mi = a[0], kw["cfg"], kw["min_inliers"]
    draws = []

    def call(draw=None):
        gen = torch.Generator(dev).manual_seed(0)

        def drawing(corr, kp_lm):
            idx = pnp.draw_indices(gen, corr)
            draws.append(idx)
            return idx

        return graft.relocalize(state, db, feats, cam, cfg=cfg,
                                min_inliers=mi, draw=draw or drawing)

    with recorded(cuda_match, "hamming_best2_kernel") as k2c, \
            recorded(cuda_pose_opt, "pose_optimization_kernel") as k3c:
        for k in sk.values():
            k.launches = 0
        r = call()
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in sk.items()}
    tried = r.info["tried"]
    require(r.success and r.cand == sys_res.cand,
            f"step: {r.info} against the system's candidate {sys_res.cand}")
    require(launches == {"K1": 0, "K2": 2 * len(tried), "K3": 2 * len(tried),
                         "K3s": 0}, f"step launches {launches} for "
            f"{len(tried)} candidates")
    calls = {n: [] for n in sk}
    for n, rec in (("K2", k2c), ("K3", k3c)):
        for i, (args, kwargs) in enumerate(rec):
            err, (b_ms, b_by, b_txt) = check_call(n, args, kwargs)
            what = (("candidate match", "local-map search")[i % 2]
                    if n == "K2" else ("PnP refine", "final pose")[i % 2])
            entry = {"call": f"reloc step {what}",
                     "shape": shape_of(n, args, kwargs), "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
            entry.update(timed(n, args, kwargs, plain_reps=5))
            calls[n].append(entry)
            phase(name, f"step {n} {entry['call']} {entry['shape']}: held "
                  f"against plain (err {err}); launch alone "
                  f"{entry['ms']:.4f} ms, wrapper {entry['wrapper_ms']:.4f} "
                  f"ms, plain {entry['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.5f} ms by {b_by} ({card})")
    k2_shapes = [shape_of("K2", *c) for c in k2c]
    require(k2_shapes[0]["N"] == cfg.max_lm and k2_shapes[0]["mode"] == "none"
            and k2_shapes[0]["M"] == cfg.n_features,
            f"step: the candidate match's shape {k2_shapes[0]}")
    require(all(shape_of("K3", *c)["N"] == cfg.n_features for c in k3c),
            "step: a K3 launch not over the frame's keypoints")

    # The CPU plain path with the card's draws.
    cpu = torch.device("cpu")
    state_c = ms.MapState(*(type(g)(*(x.cpu() for x in g)) for g in state))
    db_c = keyframe_db.KeyframeDatabase(bow.to_device(db.voc, cpu), 1, 1)
    db_c.vecs, db_c.words, db_c.valid = (x.cpu() for x in
                                         (db.vecs, db.words, db.valid))
    replay = iter([d.cpu() for d in draws])
    t0 = time.perf_counter()
    r_c = graft.relocalize(state_c, db_c, type(feats)(*(x.cpu()
                                                        for x in feats)),
                           cam.cpu(), cfg=cfg, min_inliers=mi,
                           draw=lambda corr, kp_lm: next(replay))
    cpu_s = time.perf_counter() - t0
    n_g = tried[-1]["inliers"]
    n_c = r_c.info["tried"][-1]["inliers"] if r_c.info["tried"] else 0
    gap = (float(np.abs(r_c.t - r.t).max()) if r_c.success else float("inf"))
    require(r_c.success and r_c.cand == r.cand
            and list(r_c.info["candidates"]) == list(r.info["candidates"])
            and abs(n_c - n_g) <= max(2, 0.01 * n_g) and gap <= 1e-3,
            f"step: CPU {r_c.info} against the card's {r.info}, pose gap "
            f"{gap}")
    # The synchronisations of one call, by site and by caller.
    callers = []
    with counted_syncs(callers=callers) as where:
        call(lambda corr, kp_lm: draws[0])
    sites = {}
    for w in where:
        sites[w] = sites.get(w, 0) + 1
    covis_ms = event_ms(lambda: ms.covisibility_matrix(state), reps=20)
    ms_ = []
    for i in range(5 + N_TIMED_RELOC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        if i >= 5:
            ms_.append((time.perf_counter() - t0) * 1e3)
    out = {"candidates": [int(c) for c in r.info["candidates"]],
           "scores": [float(s) for s in r.info["scores"]], "tried": tried,
           "cand": r.cand, "launches": launches,
           "host_reads": r.info["host_reads"], "syncs": len(where),
           "sync_sites": sites, "ms": spread(ms_),
           "covisibility_ms": covis_ms, "cpu_inliers": n_c,
           "cpu_pose_gap": gap, "cpu_seconds": cpu_s,
           "live_keyframes": int(state.kfs.valid.sum()),
           "live_landmarks": int(state.lms.valid.sum())}
    st = out["ms"]
    phase(name, f"step: graft.relocalize at {cfg.max_kf} / {cfg.max_lm} / "
          f"{cfg.max_obs} slots ({out['live_keyframes']} live keyframes, "
          f"{out['live_landmarks']} landmarks), {cfg.n_features} features: "
          f"candidates {out['candidates']}, tried {tried}; launches "
          f"{launches}; the CPU plain path with the card's draws agrees "
          f"(inliers {n_c}, pose within {gap:.2e}); {len(where)} "
          f"synchronisations {sites}, asked for by {sorted(set(callers))}; "
          f"host reads {r.info['host_reads']}; covisibility matrix "
          f"{covis_ms:.4f} ms; median {st['median']:.3f} ms, p80 "
          f"{st['p80']:.3f} ms over {N_TIMED_RELOC_STEPS} calls (min "
          f"{st['min']:.3f}, max {st['max']:.3f}) ({card})")
    return out, calls


def reloc_database(dev, card, name, captured, voc10k) -> dict:
    """Phase 15's database at deployment width: ``real_voc_100k.npz``, a
    1024-row database filled from the captured map's live keyframes (in
    turn), ``transform`` of the frame's 1536 descriptors and
    ``query_groups`` timed; the bytes of it and of the 10k-word one."""
    from orbslam3_byzyh_tpu_torch import graft
    from orbslam3_byzyh_tpu_torch.models import map_state as ms
    from orbslam3_byzyh_tpu_torch.ops import bow
    from orbslam3_byzyh_tpu_torch.pipeline import keyframe_db

    state, _, feats, _, kw, _ = captured
    cfg = kw["cfg"]
    t0 = time.perf_counter()
    voc = bow.load_vocabulary(graft.DEPLOY_VOCABULARY, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    live = torch.nonzero(state.kfs.valid).flatten().tolist()
    out = {}
    for width, v in (("100k", voc), ("10k", voc10k)):
        db = keyframe_db.KeyframeDatabase(v, cfg.max_kf, cfg.n_features)
        for k in range(cfg.max_kf):
            src = live[k % len(live)]
            db.add(k, state.kfs.kp_desc[src], state.kfs.kp_valid[src])
        covis = ms.covisibility_matrix(state)
        torch.cuda.synchronize()
        tr_ms = event_ms(lambda: bow.transform(v, feats.desc, feats.valid),
                         reps=20)
        q_ms = []
        for i in range(3 + 20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, scores, _ = db.query_groups(feats.desc, feats.valid, covis,
                                             top_n=3,
                                             kf_valid=state.kfs.valid)
            if i >= 3:
                q_ms.append((time.perf_counter() - t0) * 1e3)
        nbytes = sum(x.numel() * x.element_size()
                     for x in (db.vecs, db.words, db.valid))
        out[width] = {"n_words": v.n_words, "rows": cfg.max_kf,
                      "bytes": nbytes, "transform_ms": tr_ms,
                      "query_groups_ms": spread(q_ms),
                      "candidates": [int(i) for i in ids]}
        st = out[width]["query_groups_ms"]
        phase(name, f"database {width}: {v.n_words} words x {cfg.max_kf} "
              f"rows = {nbytes} bytes; transform of {cfg.n_features} "
              f"descriptors {tr_ms:.4f} ms (CUDA events, median of 20); "
              f"query_groups median {st['median']:.3f} ms, p80 "
              f"{st['p80']:.3f} ms over 20 calls (one read each), "
              f"candidates {out[width]['candidates']} ({card})")
        del db
    out["100k"]["load_s"] = load_s
    return out


def loop_cost(state, cam, before=None) -> float:
    """The global BA's objective (no robust kernel) over the observations
    live in ``state``, at ``state``'s poses and points, or at ``before``'s
    (the same observation set before a BA)."""
    from orbslam3_byzyh_tpu_torch.ops import camera as cam_mod
    from orbslam3_byzyh_tpu_torch.pipeline import mapping
    from orbslam3_byzyh_tpu_torch.solver import ba, lm
    src = state if before is None else before
    kfs = state.kfs
    free = kfs.valid & (torch.arange(kfs.valid.shape[0],
                                     device=kfs.valid.device) != 0)
    p = mapping._full_ba_problem(state, free, cam)
    s = ba._build_system(p, src.kfs.R, src.kfs.t, src.lms.pos,
                         torch.ones_like(p.obs_valid), cam_mod.PINHOLE,
                         False, lm.CHI2_MONO)
    return float(s["cost"])


def phase_loop(dev, card, sk, check_call, timed, shape_of, shared) -> tuple:
    """Phase "16 loop": loop closing and the global BA at the EuRoC-mono
    capacity with the runners' 10k-word vocabulary. The step,
    ``graft.loop_closing_step`` on ``graft.euroc_loop_map`` (160 keyframes
    on a drifted circuit, about 48,000 landmarks, 3 revisit keyframes):
    the three revisits in turn with the default ladder gates and
    ``consecutive_needed`` 3 (the first two confirm, the third fires: the
    pose graph at DOF_SIM3, the fusion, the global BA inline), every K2
    launch held against its plain version; the gates (the planted
    candidate, the Sim3's scale within 5 % of the creep's inverse, the
    revisit's centre error halved, one loop edge, the GBA's cost falling);
    the same with the background GBA ticked to completion and merged; the
    CPU plain path with the card's Sim3 draws (the candidate, the Sim3 and
    the poses after the pose graph within 1e-3); the timed calls and their
    synchronisations. Cell (k): ``MonoSlam`` at
    ``graft.loop_golden_config`` (the runners' default: loop closing and the
    background GBA on) on the golden frames padded to 752x480, a held
    warm-up, the gates of cell (b) and of the JAX run's decisions
    (``graft.LOOP_JAX``), timed sequences by frame kind with the keyframes
    that mined the database apart. Returns the results and each kernel's
    held calls of the step with their times; leaves the map and its
    closer in ``shared["loop"]`` for phase 20."""
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.ops import bow, cuda_brief, cuda_match
    from orbslam3_byzyh_tpu_torch.pipeline import loop_closing as lc_mod
    from orbslam3_byzyh_tpu_torch.pipeline import mapping
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.pipeline.background_gba import BackgroundGBA
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt
    from orbslam3_byzyh_tpu_torch.utils import evaluate

    name = "16 loop"
    t16 = time.perf_counter()
    out = {}
    cfg = graft.EUROC_MONO
    voc = bow.load_vocabulary(graft.RELOC_VOCABULARY, dev)
    t0 = time.perf_counter()
    m = graft.euroc_loop_map(cfg)
    build_s = time.perf_counter() - t0
    cam = convert.to_torch(m.cam_params, dev)
    state0 = convert.map_state_to_torch(m.state, dev)
    q_fire = m.revisit[-1]

    def closer(device, state, record=None, replay=None):
        v = voc if device.type == "cuda" else bow.to_device(voc, device)
        lc = lc_mod.LoopCloser(v, cfg.max_kf, cfg.n_features,
                               cam_params=m.cam_params)
        for k in range(m.n_kf):
            lc.add_keyframe(state, k)
        if record is not None:
            draw = lc._sim3_indices

            def recording(mask, q):
                idx = draw(mask, q)
                record.append(idx)
                return idx

            lc._sim3_indices = recording
        if replay is not None:
            lc._sim3_indices = lambda mask, q: next(replay)
        return lc

    def steps(lc, state, gba, bg=None):
        infos = []
        for q in m.revisit:
            new, info = graft.loop_closing_step(
                state, lc, q, m.n_kf, cam if state.kfs.R.is_cuda
                else cam.cpu(), kf_parent=m.kf_parent, cfg=cfg, gba=gba,
                bg=bg)
            infos.append(info)
        return new, infos

    def centre_err(state, q):
        R, t_ = (convert.to_numpy(x[q]).astype(np.float64)
                 for x in (state.kfs.R, state.kfs.t))
        return float(np.linalg.norm(-R.T @ t_ - m.c_true[q]))

    def gate_run(infos, lc, what):
        ex = graft.loop_expected_scale(m, len(m.revisit) - 1)
        fired = [i["fired"] for i in infos]
        s = infos[-1].get("sim3", (None, None, float("nan"), 0))[2]
        require(fired == [False, False, True]
                and [i["streak"] for i in infos] == [1, 2, 3]
                and infos[-1]["cand"] == m.revisit_of[-1]
                and abs(s - ex) / ex < 0.05
                and len(lc.loop_edges[0]) == 1
                and all(r["failed"] is None for i in infos
                        for r in i["tried"]),
                f"{what}: {[dict(i, tried=None) for i in infos]} against "
                f"candidate {m.revisit_of[-1]} at the third revisit, "
                f"scale {ex:.5f} +- 5 %, one loop edge")
        return dict(fired=fired, cand=infos[-1]["cand"], scale=s,
                    expected_scale=ex, n_final=infos[-1]["sim3"][3],
                    candidates=[i["candidates"] for i in infos],
                    tried=[i["tried"] for i in infos],
                    host_reads=[i["host_reads"] for i in infos])

    # (a) The step with the inline GBA, every K2 launch held.
    lc = closer(dev, state0)
    torch.cuda.synchronize()
    for k in sk.values():
        k.launches = 0
    with recorded(cuda_match, "hamming_best2_kernel") as k2c:
        t0 = time.perf_counter()
        st_a, infos = steps(lc, state0, "inline")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in sk.items()}
    res_a = gate_run(infos, lc, "step (inline GBA)")
    n_verified = sum(len(i["tried"]) for i in infos)
    require(launches["K1"] == launches["K3"] == launches["K3s"] == 0
            and launches["K2"] == len(k2c) >= 2 * n_verified + 1,
            f"step launches {launches} for {n_verified} verified candidates")
    calls = {n: [] for n in sk}
    seen_shapes = {}
    for i, (args, kwargs) in enumerate(k2c):
        err, (b_ms, b_by, b_txt) = check_call("K2", args, kwargs)
        require(err == 0, f"step K2 call {i}: {err}")
        what = ("guided projection (coarse)", "guided projection (tight)")[
            i % 2] if i < 2 * n_verified else "fusion"
        shape = shape_of("K2", args, kwargs)
        key = (what, shape["N"], shape["M"], shape["mode"])
        seen_shapes[key] = seen_shapes.get(key, 0) + 1
        if seen_shapes[key] > 1:
            continue
        entry = {"call": f"loop step {what}", "shape": shape,
                 "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                 "bound": b_txt}
        entry.update(timed("K2", args, kwargs, plain_reps=5))
        calls["K2"].append(entry)
        phase(name, f"step K2 {entry['call']} {shape}: identical to plain; "
              f"launch alone {entry['ms']:.4f} ms, wrapper "
              f"{entry['wrapper_ms']:.4f} ms, plain {entry['plain_ms']:.4f} "
              f"ms, bound {b_ms:.5f} ms by {b_by} ({card})")
    for entry in calls["K2"]:
        key = (entry["call"][len("loop step "):], entry["shape"]["N"],
               entry["shape"]["M"], entry["shape"]["mode"])
        entry["launches"] = seen_shapes[key]

    # (b) Without the GBA: the pose graph's result, with the card's draws
    # recorded for the CPU plain path.
    draws = []
    lc_b = closer(dev, state0, record=draws)
    st_b, infos_b = steps(lc_b, state0, "none")
    res_b = gate_run(infos_b, lc_b, "step (no GBA)")
    err0, err_pg, err_gba = (centre_err(state0, q_fire),
                             centre_err(st_b, q_fire),
                             centre_err(st_a, q_fire))
    # The JAX test's gate (test_loop_closing.py:229-237) holds the closure;
    # the GBA's error is reported (it distributes the loop's residual over
    # the whole circuit, with the monocular scale free).
    require(err_pg < 0.5 * err0,
            f"step: revisit {q_fire}'s centre error {err0:.5f} m before, "
            f"{err_pg:.5f} after the closure: not halved")
    cost_before, cost_after = (loop_cost(st_a, cam, st_b),
                                 loop_cost(st_a, cam))
    require(cost_after < cost_before,
            f"step: the GBA's cost {cost_before} -> {cost_after}")
    # The CPU plain path with the card's draws.
    cpu = torch.device("cpu")
    state_c = convert.map_state_to_torch(m.state, cpu)
    replay = iter([d.cpu() for d in draws])
    lc_c = closer(cpu, state_c, replay=replay)
    t0 = time.perf_counter()
    st_c, infos_c = steps(lc_c, state_c, "none")
    cpu_s = time.perf_counter() - t0
    Rg, tg, Rc, tc = (convert.to_numpy(x)[:m.n_kf] for x in (
        st_b.kfs.R, st_b.kfs.t, st_c.kfs.R, st_c.kfs.t))
    sim_g, sim_c = infos_b[-1]["sim3"], infos_c[-1]["sim3"]
    gap_sim3 = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for a, b in zip(sim_g[:3], sim_c[:3]))
    gap_pose = float(max(np.abs(Rg - Rc).max(), np.abs(tg - tc).max()))
    require(infos_c[-1]["fired"] and infos_c[-1]["cand"] == infos_b[-1]["cand"]
            and gap_sim3 <= 1e-3 and gap_pose <= 1e-3,
            f"step: CPU {infos_c[-1].get('cand')} Sim3 gap {gap_sim3}, pose "
            f"gap {gap_pose} against the card's")
    phase(name, f"step: graft.loop_closing_step on graft.euroc_loop_map "
          f"({m.n_kf} keyframes, {int(state0.lms.valid.sum())} landmarks, "
          f"built in {build_s:.1f} s) at {cfg.max_kf} / {cfg.max_lm} / "
          f"{cfg.max_obs} slots: fired {res_a['fired']} at candidate "
          f"{res_a['cand']}, scale {res_a['scale']:.5f} (planted "
          f"{res_a['expected_scale']:.5f}), {res_a['n_final']} final "
          f"matches; the revisit's centre error {err0:.5f} -> {err_pg:.5f} m "
          f"(pose graph) -> {err_gba:.5f} m (GBA); GBA cost {cost_before:.3f}"
          f" -> {cost_after:.3f}; launches {launches}, all {len(k2c)} K2 "
          f"identical to plain; first call {first_s:.2f} s; the CPU plain "
          f"path with the card's draws agrees (Sim3 within {gap_sim3:.2e}, "
          f"poses within {gap_pose:.2e}; {cpu_s:.1f} s) ({card})")

    # (c) The background GBA, ticked to completion and merged.
    lc_bg = closer(dev, state0)
    bg = BackgroundGBA()
    st_bg, infos_bg = steps(lc_bg, state0, "background", bg)
    gate_run(infos_bg, lc_bg, "step (background GBA)")
    require(bg.active, "step: no background GBA started")
    tick_ms = []
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = bg.tick()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if done:
            break
    st_m = bg.merge(st_bg, m.kf_parent)
    cost_bg0, cost_bg1 = loop_cost(st_m, cam, st_bg), loop_cost(st_m, cam)
    err_bg = centre_err(st_m, q_fire)
    require(len(tick_ms) == bg.total_iters and cost_bg1 < cost_bg0,
            f"step: background GBA {len(tick_ms)} ticks, cost {cost_bg0} -> "
            f"{cost_bg1}")
    phase(name, f"step (background GBA): {len(tick_ms)} ticks, cost "
          f"{cost_bg0:.3f} -> {cost_bg1:.3f}, the revisit's centre error "
          f"{err_bg:.5f} m after the merge; tick median "
          f"{statistics.median(tick_ms[1:]):.3f} ms ({card})")

    # (d) Timed calls and their synchronisations.
    q_none = m.n_kf // 2

    def detect_once(q):
        lc._streak = None
        return lc.detect(state0, q, m.n_kf)

    corr = infos[-1]["sim3"]
    cand = infos[-1]["cand"]

    def closure():
        lc.loop_edges[0] = []
        st = lc.close(state0, q_fire, cand, corr, m.n_kf,
                      span_parent=m.kf_parent)
        st = mapping.fuse_duplicates(st, q_fire, cam, float(cfg.width),
                                     float(cfg.height))
        return mapping.global_ba(st, cam)

    def host_ms(fn, n_warm, n_timed):
        xs = []
        for i in range(n_warm + n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= n_warm:
                xs.append((time.perf_counter() - t0) * 1e3)
        return spread(xs)

    def syncs_of(fn):
        callers = []
        with counted_syncs(callers=callers) as where:
            fn()
        sites = {}
        for w in where:
            sites[w] = sites.get(w, 0) + 1
        return len(where), sites, sorted(set(callers))

    timed_calls = {}
    for key, fn, n_timed, n_warm in (
            ("detect_verifying", lambda: detect_once(m.revisit[0]),
             N_TIMED_LOOP_DETECTS, 2),
            ("detect_no_loop", lambda: detect_once(q_none),
             N_TIMED_LOOP_DETECTS, 2),
            ("closure_inline_gba", closure, N_TIMED_LOOP_CLOSURES, 1)):
        st_ = host_ms(fn, n_warm, n_timed)
        n_s, sites, callers = syncs_of(fn)
        if key != "closure_inline_gba":
            st_["tried"] = lc.info["tried"]
            st_["host_reads"] = lc.info["host_reads"]
        st_.update(syncs=n_s, sync_sites=sites, sync_callers=callers)
        timed_calls[key] = st_
        phase(name, f"{key}: median {st_['median']:.3f} ms, p80 "
              f"{st_['p80']:.3f} ms over {st_['n']} calls (min "
              f"{st_['min']:.3f}, max {st_['max']:.3f}); {n_s} "
              f"synchronisations {sites} asked for by {callers}"
              + (f"; tried {st_['tried']}, host reads {st_['host_reads']}"
                 if "tried" in st_ else "") + f" ({card})")
    # The closure's parts, each from the same input (synchronised).
    st_pg = lc.close(state0, q_fire, cand, corr, m.n_kf,
                     span_parent=m.kf_parent)
    st_fu = mapping.fuse_duplicates(st_pg, q_fire, cam, float(cfg.width),
                                    float(cfg.height))

    def close_only():
        lc.loop_edges[0] = []
        lc.close(state0, q_fire, cand, corr, m.n_kf, span_parent=m.kf_parent)

    parts = {
        "close": host_ms(close_only, 1, N_TIMED_LOOP_CLOSURES),
        "fuse": host_ms(lambda: mapping.fuse_duplicates(
            st_pg, q_fire, cam, float(cfg.width), float(cfg.height)), 1,
            N_TIMED_LOOP_CLOSURES),
        "global_ba": host_ms(lambda: mapping.global_ba(st_fu, cam), 1,
                             N_TIMED_LOOP_CLOSURES)}
    timed_calls["closure_parts"] = parts
    phase(name, "closure parts (median ms over "
          f"{N_TIMED_LOOP_CLOSURES}): " + ", ".join(
              f"{k} {v['median']:.3f}" for k, v in parts.items())
          + f" ({card})")
    del st_pg, st_fu
    bg2 = BackgroundGBA()
    bg2.start(st_b, m.n_kf, cam)
    n_s, sites, callers = syncs_of(bg2.tick)
    timed_calls["background_tick"] = dict(spread(tick_ms[1:]), syncs=n_s,
                                          sync_sites=sites,
                                          sync_callers=callers)
    phase(name, f"background_tick: median "
          f"{timed_calls['background_tick']['median']:.3f} ms over "
          f"{len(tick_ms) - 1} ticks (the first, which builds the "
          f"problem's caches, {tick_ms[0]:.3f} ms); {n_s} synchronisations "
          f"{sites} ({card})")
    out["step"] = dict(
        inline=res_a, no_gba=res_b, launches=launches,
        centre_err_m=dict(before=err0, pose_graph=err_pg, gba=err_gba,
                          background=err_bg),
        gba_cost=dict(before=cost_before, after=cost_after,
                      background_before=cost_bg0,
                      background_after=cost_bg1),
        cpu=dict(seconds=cpu_s, sim3_gap=gap_sim3, pose_gap=gap_pose,
                 cand=infos_c[-1]["cand"]),
        first_call_s=first_s, map_build_s=build_s,
        live_keyframes=m.n_kf, live_landmarks=int(state0.lms.valid.sum()),
        timed=timed_calls)
    del st_a, st_b, st_c, st_bg, st_m, lc, lc_b, lc_c, lc_bg, bg, bg2
    shared["loop"] = dict(m=m, state0=state0, cam=cam, cfg=cfg,
                          closer=closer)

    # (e) Cell (k): the runners' default configuration.
    gold = graft.golden_frames()
    frames = graft.pad_frames(gold.frames)
    cfg_k = graft.loop_golden_config(voc)
    spies = {"K1": (cuda_brief, "brief_descriptors_kernel"),
             "K2": (cuda_match, "hamming_best2_kernel"),
             "K3": (cuda_pose_opt, "pose_optimization_kernel")}
    originals = {n: getattr(mod, f) for n, (mod, f) in spies.items()}
    checked = {n: {"calls": 0, "max_abs_err": 0.0} for n in sk}
    guard, bundles, detects = [], [], []
    keyframe_step, detect = graft.mono_keyframe_step, lc_mod.LoopCloser.detect

    def counted_bundle(*a, **kw):
        bundles.append(1)
        return keyframe_step(*a, **kw)

    def recorded_detect(self, state, kf_id, n_kf):
        det = detect(self, state, kf_id, n_kf)
        detects.append(dict(
            query=int(kf_id), n_kf=int(n_kf),
            candidates=self.info.get("candidates"),
            tried=self.info["tried"],
            streak=self.info.get("streak"), fired=det is not None,
            cand=None if det is None else int(det[0])))
        return det

    def checking(n):
        fn = originals[n]

        def spy(*a, **kw):
            res = fn(*a, **kw)
            if guard:
                return res
            guard.append(n)
            try:
                err, _ = check_call(n, a, kw, checked[n])
            finally:
                guard.pop()
            checked[n]["calls"] += 1
            checked[n]["max_abs_err"] = max(checked[n]["max_abs_err"],
                                            float(err))
            return res

        return spy

    def run_cell(syncs=False):
        slam = system_mod.MonoSlam(cfg_k)
        recs = []
        t_seq = time.perf_counter()
        for img, stamp in zip(frames, gold.stamps):
            was = slam.status
            n_b, n_d = len(bundles), len(detects)
            before = {n: k.launches for n, k in sk.items()}
            ctx = counted_syncs() if syncs else contextlib.nullcontext([])
            with ctx as where:
                t0 = time.perf_counter()
                slam.track(img, float(stamp))
                ms_ = (time.perf_counter() - t0) * 1e3
            ran = [d for d in detects[n_d:]
                   if d["n_kf"] >= lc_mod.LoopCloserConfig.min_map_kfs]
            if was == system_mod.NOT_INITIALIZED:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            elif len(bundles) > n_b:
                kind = "keyframe_detect" if ran else "keyframe"
            else:
                kind = "tracked"
            recs.append({"kind": kind, "ms": ms_, "syncs": list(where),
                         "launches": {n: k.launches - before[n]
                                      for n, k in sk.items()}})
        traj = slam.trajectory
        return slam, recs, traj, time.perf_counter() - t_seq

    def gate_cell(slam, traj, dets):
        stamps = np.array([s for s, _, _ in traj]) + slam.t0
        est = evaluate.camera_centers(np.stack([R for _, R, _ in traj]),
                                      np.stack([t_ for _, _, t_ in traj]))
        ate, n_assoc = evaluate.ate_rmse(stamps, est, gold.stamps,
                                         gold.centres)
        ref = graft.LOOP_JAX

        def decisions(ds):
            return ([(d["query"], d["n_kf"], d["fired"], d["cand"])
                     for d in ds],
                    [d["candidates"] for d in ds if d["n_kf"] >= 12])

        mine, theirs = decisions(dets), decisions(ref["detect"])
        # The candidates are reported: the free runs (1,024 slots here,
        # 48 in the JAX run) drift apart at float32 rounding, and the
        # database's scores near its gates move with them; the CPU parity
        # test holds them frame by frame from the JAX state.
        differ = [(d["query"], a, b) for d, a, b in zip(
            [d for d in dets if d["n_kf"] >= 12], mine[1], theirs[1])
            if a != b]
        res = {"frames": len(traj), "ate_m": float(ate),
               "n_assoc": int(n_assoc), "detect_calls": len(dets),
               "mined": len(mine[1]),
               "loops": sum(d["fired"] for d in dets),
               "candidates_differ": differ,
               "verified": [(d["query"], d["tried"]) for d in dets
                            if d["tried"]],
               "live_keyframes": int(slam.state.kfs.valid.sum()),
               "live_landmarks": int(slam.state.lms.valid.sum())}
        require(len(traj) > 32 and n_assoc > 30 and ate < 0.15
                and mine[0] == theirs[0] and len(mine[1]) == len(theirs[1]),
                f"cell (k): {res}; decisions {mine[0]} against the JAX run's "
                f"{theirs[0]} (> 32 frames, ATE < 0.15 m, the same keyframes "
                "mining the database, the same loops)")
        return res

    graft.mono_keyframe_step = counted_bundle
    lc_mod.LoopCloser.detect = recorded_detect
    try:
        for n_, (mod, f) in spies.items():
            setattr(mod, f, checking(n_))
        try:
            slam, recs, traj, sec = run_cell()
            torch.cuda.synchronize()
            check_call.settle()
        finally:
            for n_, (mod, f) in spies.items():
                setattr(mod, f, originals[n_])
        warm = gate_cell(slam, traj, detects)
        warm["seconds"] = sec
        warm["detect"] = list(detects)
        require(all(checked[n]["calls"] > 0 for n in ("K1", "K2", "K3")),
                f"cell (k): kernels launched {checked}")
        phase(name, f"(k) warm-up sequence, every launch held against its "
              f"plain version: " + ", ".join(
                  f"{n} {checked[n]['calls']} calls max err "
                  f"{checked[n]['max_abs_err']:.2e}" for n in sk)
              + f"; {json.dumps(dict(warm, detect=None))}; detections "
              + str([(d["query"], d["candidates"],
                      [r["failed"] for r in d["tried"]])
                     for d in detects if d["n_kf"] >= 12]) + f" ({card})")
        seqs, all_recs = [], []
        for _ in range(N_TIMED_LOOP_SEQUENCES):
            detects.clear()
            for k in sk.values():
                k.launches = 0
            torch.cuda.synchronize()
            slam, recs, traj, sec = run_cell()
            res = gate_cell(slam, traj, detects)
            res.update(seconds=sec, fps=len(frames) / sec,
                       launches={n: k.launches for n, k in sk.items()})
            require(all(res["launches"][n] > 0 for n in ("K1", "K2", "K3")),
                    f"cell (k): launches {res['launches']}")
            seqs.append(res)
            all_recs += recs
        detects.clear()
        _, sync_recs, _, _ = run_cell(syncs=True)
    finally:
        graft.mono_keyframe_step = keyframe_step
        lc_mod.LoopCloser.detect = detect
    kinds = {}
    for kind in ("uninitialised", "init", "tracked", "keyframe",
                 "keyframe_detect"):
        rs = [r for r in all_recs if r["kind"] == kind]
        st_ = spread(r["ms"] for r in rs)
        st_["launches_per_frame"] = {
            n: (sum(r["launches"][n] for r in rs) / len(rs) if rs else None)
            for n in sk}
        ss = [r for r in sync_recs if r["kind"] == kind]
        st_["syncs_per_frame"] = (sum(len(r["syncs"]) for r in ss) / len(ss)
                                  if ss else None)
        sites = {}
        for r in ss:
            for w in r["syncs"]:
                sites[w] = sites.get(w, 0) + 1
        st_["sync_sites"] = {k: v / len(ss) for k, v in sorted(sites.items())}
        st_["jax_host_reads"] = JAX_LOOP_READS[kind]
        kinds[kind] = st_
        if st_["n"]:
            phase(name, f"(k) {kind} frames ({st_['n']} over {len(seqs)} "
                  f"sequences): track() median {st_['median']:.3f} ms, p80 "
                  f"{st_['p80']:.3f} ms (min {st_['min']:.3f}, max "
                  f"{st_['max']:.3f}); launches per frame "
                  f"{st_['launches_per_frame']}; {st_['syncs_per_frame']} "
                  f"synchronisations per frame {st_['sync_sites']} ({card})")
    fps = [r["fps"] for r in seqs]
    phase(name, f"(k) {len(frames)} frames in "
          + ", ".join(f"{r['seconds']:.3f}" for r in seqs) + " s = "
          + ", ".join(f"{f_:.2f}" for f_ in fps) + " frames/s; ATE "
          f"{[round(r['ate_m'], 5) for r in seqs]} m; "
          f"{seqs[0]['mined']} keyframes mined the database, the JAX run's "
          f"decisions at each ({card})")
    out["k_default"] = {
        "config": {k: v for k, v in dataclasses.asdict(
            dataclasses.replace(cfg_k, vocabulary=None)).items()
            if not isinstance(v, np.ndarray)},
        "warmup": warm, "sequences": seqs, "frame_kinds": kinds,
        "fps": spread(fps), "checked": checked}
    out["seconds"] = time.perf_counter() - t16
    phase(name, f"phase took {out['seconds']:.1f} s")
    return out, calls


def merge_atlas(m, dev, voc, cfg):
    """``graft.euroc_merge_atlas``'s maps as a port atlas on ``dev`` (map
    B current) and a ``LoopCloser`` with both databases filled."""
    from orbslam3_byzyh_tpu_torch import convert
    from orbslam3_byzyh_tpu_torch.models import atlas as atlas_mod
    from orbslam3_byzyh_tpu_torch.ops import bow
    from orbslam3_byzyh_tpu_torch.pipeline import loop_closing as lc_mod
    at = atlas_mod.Atlas(cfg.max_kf, cfg.max_lm, cfg.max_obs,
                         cfg.n_features, device=dev)
    at.maps = [convert.map_state_to_torch(s, dev) for s in m.maps]
    at.meta = [atlas_mod.MapMeta(k, n, p.copy()) for k, n, p in
               zip(m.n_kf, m.n_lm, m.kf_parent)]
    at.current = 1
    v = voc if dev.type == "cuda" else bow.to_device(voc, dev)
    lc = lc_mod.LoopCloser(v, cfg.max_kf, cfg.n_features,
                           cam_params=m.cam_params)
    for idx, k in enumerate(m.n_kf):
        lc.switch_map(idx)
        lc.db.add_range(0, at.maps[idx].kfs.kp_desc[:k],
                        at.maps[idx].kfs.kp_valid[:k])
    lc.switch_map(1, fresh=False)
    return at, lc


def copy_merge_inputs(at, lc):
    """A fresh copy of an atlas and its loop closer (the tensors cloned),
    for a timed weld that must start from the same maps."""
    import copy
    at2 = copy.copy(at)
    at2.maps = [type(s)(*(type(g)(*(x.clone() for x in g)) for g in s))
                for s in at.maps]
    at2.meta = [copy.deepcopy(m_) for m_ in at.meta]
    lc2 = copy.copy(lc)
    lc2.dbs = {}
    for k, db in lc.dbs.items():
        d = copy.copy(db)
        d.vecs, d.words, d.valid = (x.clone() for x in (db.vecs, db.words,
                                                         db.valid))
        lc2.dbs[k] = d
    lc2.loop_edges = {k: list(e) for k, e in lc.loop_edges.items()}
    return at2, lc2


def phase_merge(dev, card, sk, check_call, timed, shape_of,
                keep_checkpoint=None) -> tuple:
    """Phase "17 merge": the atlas merge and the atlas checkpoints at the
    EuRoC-mono capacity with the runners' 10k-word vocabulary. The step,
    ``graft.map_merge_step`` on ``graft.euroc_merge_atlas`` (map A: 157
    keyframes of a circuit, about 47,000 landmarks; map B: its 3 revisit
    keyframes in a world of their own, the planted Sim3 of scale 0.8 away,
    the middle one misplaced): B's three keyframes in turn (the first two
    confirm, the third fires: the weld, the databases, the fusion, the
    windowed BA past 64 keyframes), every K2 launch held against its plain
    version; the gates (A's planted candidate, the Sim3's scale within
    5 %, one map of A's plus B's keyframes, the transplanted landmarks the
    weld's transform of A's within 1e-4, ``obs.kf`` shifted, no live
    landmark under 2 live observations, the misplaced keyframe's centre
    error falling); the CPU plain path with the card's Sim3 draws (the
    candidate, the Sim3 and the merged poses within 1e-3); the timed
    detections and welds (each weld from a fresh copy, split into its
    parts) with their synchronisations. Cells (l) and (m): ``MonoSlam`` at
    ``graft.merge_golden_config`` on ``graft.merge_sequence`` (map A, a
    blackout that starts map B, the revisit that merges A back), a held
    warm-up of (l), ``graft.merge_run_gates`` against the JAX runs
    (``graft.MERGE_JAX``) on every run, timed sequences by frame kind with
    the merge frame apart, one more run of each counting synchronisations;
    (m) saves map A through ``save_atlas_checkpoint``, loads it into a
    fresh system and plays the revisit: the checkpoint's bytes and the
    save and load seconds (a copy of the checkpoint goes to
    ``keep_checkpoint`` for phase 20's viewer). Returns the results and
    each kernel's held calls of the step with their times."""

    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.ops import bow, cuda_brief, cuda_match
    from orbslam3_byzyh_tpu_torch.pipeline import loop_closing as lc_mod
    from orbslam3_byzyh_tpu_torch.pipeline import mapping
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

    name = "17 merge"
    t17 = time.perf_counter()
    out = {}
    cfg = graft.EUROC_MONO
    voc = bow.load_vocabulary(graft.RELOC_VOCABULARY, dev)
    t0 = time.perf_counter()
    m = graft.euroc_merge_atlas(cfg)
    build_s = time.perf_counter() - t0
    cam = convert.to_torch(m.cam_params, dev)
    n_a, n_b = m.n_kf
    l_a, l_b = m.n_lm
    R_p, t_p, s_p = m.plant

    def steps(at, lc, camera, weld=None):
        infos = []
        fuse = mapping.fuse_duplicates

        def spy(state, *a, **kw):
            if weld is not None:
                weld.append(state)
            return fuse(state, *a, **kw)

        mapping.fuse_duplicates = spy
        try:
            for q in range(n_b):
                infos.append(graft.map_merge_step(at, lc, q, camera,
                                                  cfg=cfg))
        finally:
            mapping.fuse_duplicates = fuse
        return infos

    def centre_err(state, k):
        R, t_ = (convert.to_numpy(x[k]).astype(np.float64)
                 for x in (state.kfs.R, state.kfs.t))
        return float(np.linalg.norm(-R.T @ t_ - m.c_true_b[k]))

    def recording(lc, record):
        draw = lc._sim3_indices

        def rec(mask, q):
            idx = draw(mask, q)
            record.append(idx)
            return idx

        lc._sim3_indices = rec

    # (a) The step, every K2 launch held.
    at, lc = merge_atlas(m, dev, voc, cfg)
    err0 = centre_err(at.maps[1], 1)
    draws, weld = [], []
    recording(lc, draws)
    torch.cuda.synchronize()
    for k in sk.values():
        k.launches = 0
    with recorded(cuda_match, "hamming_best2_kernel") as k2c:
        t0 = time.perf_counter()
        infos = steps(at, lc, cam, weld)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in sk.items()}
    fired = [i["fired"] for i in infos]
    w = infos[-1].get("weld", {})
    s_i = w.get("s_i", float("nan"))
    require(fired == [False, False, True]
            and [i["streak"] for i in infos] == [1, 2, 3]
            and infos[-1]["cand"] == m.revisit_of[-1]
            and infos[-1]["other"] == 0
            and abs(s_i - s_p) / s_p < 0.05
            and len(at.maps) == 1 and at.counts().n_kf == n_a + n_b
            and w.get("ba") == "windowed",
            f"step: {[dict(i, tried=None, weld=None) for i in infos]}, weld "
            f"{w} against candidate {m.revisit_of[-1]} of map 0 at B's third "
            f"keyframe, scale {s_p} +- 5 %, one map of {n_a + n_b} keyframes")
    # The weld: the state the fusion received.
    ws = convert.map_state_to_numpy(weld[0])
    A = m.maps[0]
    rows = np.arange(l_b, l_b + l_a)
    live = A.lms.valid[:l_a]
    want = (s_i * A.lms.pos[:l_a].astype(np.float64) @ w["R_i"].T
            + w["t_i"])
    rel = (np.abs(ws.lms.pos[rows][live] - want[live]).max()
           / np.abs(want[live]).max())
    okf = A.obs.kf[:l_a]
    shifted = np.where(A.obs.valid[:l_a], okf + n_b, -1)
    require(rel <= 1e-4
            and (np.where(ws.obs.valid[rows], ws.obs.kf[rows], -1)
                 == shifted).all()
            and (ws.lms.valid[rows] == live).all(),
            f"step: the weld's landmarks {rel:.2e} from the transform of "
            "A's, or obs.kf not shifted")
    st_a = at.state
    obs_live = (st_a.obs.valid & (st_a.obs.kf >= 0)).sum(-1)
    weak = int((st_a.lms.valid & (obs_live < 2)).sum())
    err1 = centre_err(st_a, 1)
    require(weak == 0 and err1 < err0,
            f"step: {weak} live landmarks under 2 live observations; the "
            f"misplaced keyframe's centre error {err0:.5f} -> {err1:.5f} m")
    n_verified = sum(len(i["tried"]) for i in infos)
    require(launches["K1"] == launches["K3"] == launches["K3s"] == 0
            and launches["K2"] == len(k2c) >= 2 * n_verified + 1,
            f"step launches {launches} for {n_verified} verified candidates")
    calls = {n: [] for n in sk}
    seen_shapes = {}
    for i, (args, kwargs) in enumerate(k2c):
        err, (b_ms, b_by, b_txt) = check_call("K2", args, kwargs)
        require(err == 0, f"step K2 call {i}: {err}")
        what = ("guided projection (coarse)", "guided projection (tight)")[
            i % 2] if i < 2 * n_verified else "fusion"
        shape = shape_of("K2", args, kwargs)
        key = (what, shape["N"], shape["M"], shape["mode"])
        seen_shapes[key] = seen_shapes.get(key, 0) + 1
        if seen_shapes[key] > 1:
            continue
        entry = {"call": f"merge step {what}", "shape": shape,
                 "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                 "bound": b_txt}
        entry.update(timed("K2", args, kwargs, plain_reps=2))
        calls["K2"].append(entry)
        phase(name, f"step K2 {entry['call']} {shape}: identical to plain; "
              f"launch alone {entry['ms']:.4f} ms, wrapper "
              f"{entry['wrapper_ms']:.4f} ms, plain {entry['plain_ms']:.4f} "
              f"ms, bound {b_ms:.5f} ms by {b_by} ({card})")
    for entry in calls["K2"]:
        key = (entry["call"][len("merge step "):], entry["shape"]["N"],
               entry["shape"]["M"], entry["shape"]["mode"])
        entry["launches"] = seen_shapes[key]

    # The CPU plain path with the card's draws.
    cpu = torch.device("cpu")
    at_c, lc_c = merge_atlas(m, cpu, voc, cfg)
    replay = iter([d.cpu() for d in draws])
    lc_c._sim3_indices = lambda mask, q: next(replay)
    t0 = time.perf_counter()
    infos_c = steps(at_c, lc_c, cam.cpu())
    cpu_s = time.perf_counter() - t0
    sim_g, sim_c = infos[-1]["sim3"], infos_c[-1].get("sim3")
    gap_sim3 = (float("inf") if sim_c is None else max(
        float(np.abs(np.asarray(a) - np.asarray(b)).max())
        for a, b in zip(sim_g[:3], sim_c[:3])))
    K = n_a + n_b
    Rg, tg, Rc, tc = (convert.to_numpy(x)[:K] for x in (
        st_a.kfs.R, st_a.kfs.t, at_c.state.kfs.R, at_c.state.kfs.t))
    gap_pose = float(max(np.abs(Rg - Rc).max(), np.abs(tg - tc).max()))
    require(infos_c[-1]["fired"] and infos_c[-1]["cand"] == infos[-1]["cand"]
            and gap_sim3 <= 1e-3 and gap_pose <= 1e-3,
            f"step: CPU {infos_c[-1].get('cand')} Sim3 gap {gap_sim3}, pose "
            f"gap {gap_pose} against the card's")
    del at_c, lc_c
    phase(name, f"step: graft.map_merge_step on graft.euroc_merge_atlas (A "
          f"{n_a} keyframes / {int(A.lms.valid.sum())} landmarks, B {n_b} / "
          f"{int(m.maps[1].lms.valid.sum())}, built in {build_s:.1f} s) at "
          f"{cfg.max_kf} / {cfg.max_lm} / {cfg.max_obs} slots: fired "
          f"{fired} at candidate {infos[-1]['cand']} of map "
          f"{infos[-1]['other']}, weld scale {s_i:.5f} (planted {s_p}), "
          f"{infos[-1]['sim3'][3]} final matches; {at.counts().n_kf} "
          f"keyframes in one map; the weld's landmarks within {rel:.2e} of "
          f"the transform; the misplaced keyframe's centre error "
          f"{err0:.5f} -> {err1:.5f} m; launches {launches}, all "
          f"{len(k2c)} K2 identical to plain; first call {first_s:.2f} s; "
          f"the CPU plain path with the card's draws agrees (Sim3 within "
          f"{gap_sim3:.2e}, poses within {gap_pose:.2e}; {cpu_s:.1f} s) "
          f"({card})")

    # (b) Timed calls and their synchronisations.
    def host_ms(fn, n_warm, n_timed, setup=None):
        xs = []
        for i in range(n_warm + n_timed):
            arg = setup() if setup is not None else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(arg)
            torch.cuda.synchronize()
            if i >= n_warm:
                xs.append((time.perf_counter() - t0) * 1e3)
        return spread(xs)

    def syncs_of(fn, arg=None):
        callers = []
        with counted_syncs(callers=callers) as where:
            fn(arg)
        sites = {}
        for w_ in where:
            sites[w_] = sites.get(w_, 0) + 1
        return len(where), sites, sorted(set(callers))

    at0, lc0 = merge_atlas(m, dev, voc, cfg)
    # A query of map A mines map B: its candidates fail.
    at_f, lc_f = copy_merge_inputs(at0, lc0)
    at_f.current, lc_f.active = 0, 0
    q_fail = n_a // 2

    def detect_verifying(_):
        lc0._merge_streak = None
        return lc0.detect_merge(at0.state, 0, at0)

    def detect_failing(_):
        return lc_f.detect_merge(at_f.state, q_fail, at_f)

    corr = infos[-1]["sim3"]
    kf_w = n_b - 1

    def fresh(_=None):
        return copy_merge_inputs(at0, lc0)

    def weld_once(arg):
        a_, l_ = arg
        graft.merge_maps(a_, l_, kf_w, 0, corr, cam, cfg=cfg)

    timed_calls = {}
    for key, fn, n_timed, n_warm, setup in (
            ("detect_verifying", detect_verifying, N_TIMED_MERGE_DETECTS, 2,
             None),
            ("detect_failing", detect_failing, N_TIMED_MERGE_DETECTS, 2,
             None),
            ("merge_maps", weld_once, N_TIMED_MERGE_WELDS, 1, fresh)):
        st_ = host_ms(fn, n_warm, n_timed, setup)
        arg = setup() if setup is not None else None
        n_s, sites, callers = syncs_of(fn, arg)
        if key != "merge_maps":
            info = (lc0 if key == "detect_verifying" else lc_f).info
            st_.update(tried=info["tried"], maps=info["maps"],
                       host_reads=info["host_reads"])
        st_.update(syncs=n_s, sync_sites=sites, sync_callers=callers)
        timed_calls[key] = st_
        phase(name, f"{key}: median {st_['median']:.3f} ms, p80 "
              f"{st_['p80']:.3f} ms over {st_['n']} calls (min "
              f"{st_['min']:.3f}, max {st_['max']:.3f}); {n_s} "
              f"synchronisations {sites} asked for by {callers}"
              + (f"; per map {st_['maps']}, host reads {st_['host_reads']}"
                 if "maps" in st_ else "") + f" ({card})")
    # The weld's parts, each from a fresh copy (synchronised).
    parts = {k: [] for k in ("atlas_merge", "on_maps_merged", "fusion",
                             "windowed_ba")}
    R_i, t_i, s_w = w["R_i"], w["t_i"], w["s_i"]
    for i in range(1 + N_TIMED_MERGE_WELDS):
        a_, l_ = fresh()
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        mark()
        kf_lo = a_.counts().n_kf
        a_.merge(0, R_i, t_i, s_w)
        mark()
        l_.on_maps_merged(a_.current, 0, a_.state, kf_lo, a_.counts().n_kf)
        mark()
        st_ = mapping.fuse_duplicates(a_.state, kf_w, cam, float(cfg.width),
                                      float(cfg.height))
        mark()
        mapping.windowed_local_ba(
            st_, kf_w, cam, n_free=max(cfg.local_window + 1, 12),
            n_window=cfg.ba_window, n_lm_window=cfg.ba_lm_window)
        mark()
        if i:
            for k_, (t_a, t_b) in zip(parts, zip(marks, marks[1:])):
                parts[k_].append((t_b - t_a) * 1e3)
        del a_, l_, st_
    timed_calls["merge_parts"] = {k: spread(v) for k, v in parts.items()}
    phase(name, "merge_maps parts (median ms over "
          f"{N_TIMED_MERGE_WELDS}, each from a fresh copy): " + ", ".join(
              f"{k} {v['median']:.3f}"
              for k, v in timed_calls["merge_parts"].items()) + f" ({card})")
    out["step"] = dict(
        fired=fired, cand=infos[-1]["cand"], other=infos[-1]["other"],
        weld_scale=s_i, planted_scale=s_p, n_final=infos[-1]["sim3"][3],
        n_kf=int(at.counts().n_kf), weld_rel_err=float(rel),
        weak_landmarks=weak, centre_err_m=dict(before=err0, after=err1),
        launches=launches, host_reads=[i["host_reads"] for i in infos],
        cpu=dict(seconds=cpu_s, sim3_gap=gap_sim3, pose_gap=gap_pose),
        first_call_s=first_s, map_build_s=build_s, timed=timed_calls)
    del at, lc, at0, lc0, at_f, lc_f, st_a, weld

    # (c) Cells (l) and (m).
    gold = graft.golden_frames()
    seq = graft.merge_sequence(gold)
    cfg_l = graft.merge_golden_config(voc)
    spies = {"K1": (cuda_brief, "brief_descriptors_kernel"),
             "K2": (cuda_match, "hamming_best2_kernel"),
             "K3": (cuda_pose_opt, "pose_optimization_kernel")}
    originals = {n: getattr(mod, f) for n, (mod, f) in spies.items()}
    checked = {n: {"calls": 0, "max_abs_err": 0.0} for n in sk}
    guard, bundles, detects, merges = [], [], [], []
    holding = [False]
    keyframe_step = graft.mono_keyframe_step
    detect_merge = lc_mod.LoopCloser.detect_merge
    merge_maps = system_mod.MonoSlam._merge_maps

    def counted_bundle(*a, **kw):
        bundles.append(1)
        return keyframe_step(*a, **kw)

    def recorded_detect(self, state, kf_id, atlas):
        det = detect_merge(self, state, kf_id, atlas)
        detects.append(dict(query=int(kf_id), maps=self.info.get("maps"),
                            streak=self.info.get("streak"),
                            fired=det is not None))
        return det

    at_frame = [0]

    def recorded_merge(self, kf_id, other_idx, cand, corr_):
        before = [int(mt.n_kf) for mt in self.atlas.meta]
        merge_maps(self, kf_id, other_idx, cand, corr_)
        merges.append(dict(index=at_frame[0], kf_id=int(kf_id),
                           other=int(other_idx), cand=int(cand),
                           scale=float(corr_[2]), n_inliers=int(corr_[3]),
                           n_kf_maps=before, n_kf_after=int(self.n_kf)))

    def checking(n):
        fn = originals[n]

        def spy(*a, **kw):
            res = fn(*a, **kw)
            if guard or not holding[0]:
                return res
            guard.append(n)
            try:
                err, _ = check_call(n, a, kw, checked[n])
            finally:
                guard.pop()
            checked[n]["calls"] += 1
            checked[n]["max_abs_err"] = max(checked[n]["max_abs_err"],
                                            float(err))
            return res

        return spy

    def play(slam, lo, hi, recs, statuses, n_maps, syncs):
        for i in range(lo, hi):
            f = seq[i]
            at_frame[0] = i
            holding[0] = i >= graft.MERGE_TRACKED
            was = slam.status
            n_b_, n_d, n_m = len(bundles), len(detects), len(merges)
            before = {n: k.launches for n, k in sk.items()}
            ctx = counted_syncs() if syncs else contextlib.nullcontext([])
            with ctx as where:
                t0 = time.perf_counter()
                slam.track(f.image, f.stamp)
                ms_ = (time.perf_counter() - t0) * 1e3
            if len(merges) > n_m:
                kind = "merge"
            elif was == system_mod.NOT_INITIALIZED:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            elif f.world < 0:
                kind = "lost"
            elif len(bundles) > n_b_:
                kind = "keyframe_detect" if len(detects) > n_d else "keyframe"
            else:
                kind = "tracked"
            recs.append({"kind": kind, "ms": ms_, "syncs": list(where),
                         "launches": {n: k.launches - before[n]
                                      for n, k in sk.items()}})
            statuses[i] = slam.status
            n_maps[i] = len(slam.atlas.maps)

    def run_cell(cell, syncs=False):
        """Cell ``cell`` through fresh systems: the gates' inputs, the
        frames' records and the seconds (the checkpoint's for (m))."""
        merges.clear()
        detects.clear()
        recs, statuses, n_maps, ck = [], {}, {}, {}
        slam = system_mod.MonoSlam(cfg_l)
        t_seq = time.perf_counter()
        play(slam, 0, graft.MERGE_TRACKED, recs, statuses, n_maps, syncs)
        n_kf_a = slam.n_kf
        if cell == "l":
            play(slam, graft.MERGE_TRACKED, len(seq), recs, statuses, n_maps,
                 syncs)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "atlas")
                t0 = time.perf_counter()
                slam.save_atlas_checkpoint(path)
                ck["save_s"] = time.perf_counter() - t0
                ck["bytes"] = sum(os.path.getsize(os.path.join(path, f_))
                                  for f_ in os.listdir(path))
                if keep_checkpoint is not None:
                    shutil.copytree(path, keep_checkpoint,
                                    dirs_exist_ok=True)
                slam = system_mod.MonoSlam(cfg_l)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                slam.load_atlas_checkpoint(path)
                torch.cuda.synchronize()
                ck["load_s"] = time.perf_counter() - t0
                ck["n_maps_loaded"] = len(slam.atlas.maps)
            play(slam, graft.MERGE_TRACKED + graft.MERGE_NOISE, len(seq),
                 recs, statuses, n_maps, syncs)
        traj = slam.trajectory
        res = graft.merge_run_gates(cell, statuses, n_maps, list(merges),
                                    n_kf_a, slam.n_kf, traj, slam.t0, seq,
                                    gold)
        res.update(seconds=time.perf_counter() - t_seq, frames=len(recs),
                   kinds=[r["kind"] for r in recs],
                   detects=list(detects), **ck)
        require(res["ok"], f"({cell}): {json.dumps(res, default=str)} "
                f"against the JAX run's merge at keyframe "
                f"{graft.MERGE_JAX[cell]['kf_id']} +- 1, one map after it, "
                f"status OK, ATE within {graft.MERGE_ATE_GATE}")
        if cell == "m":
            require(ck["n_maps_loaded"] == 2,
                    f"(m): {ck['n_maps_loaded']} maps after the load")
        return res, recs

    graft.mono_keyframe_step = counted_bundle
    lc_mod.LoopCloser.detect_merge = recorded_detect
    system_mod.MonoSlam._merge_maps = recorded_merge
    try:
        for n_, (mod, f) in spies.items():
            setattr(mod, f, checking(n_))
        try:
            warm, _ = run_cell("l")
            torch.cuda.synchronize()
            check_call.settle()
        finally:
            for n_, (mod, f) in spies.items():
                setattr(mod, f, originals[n_])
        require(all(checked[n]["calls"] > 0 for n in ("K1", "K2", "K3")),
                f"(l): kernels launched {checked}")
        phase(name, "(l) warm-up sequence, every launch from the blackout "
              "on held against its plain version: " + ", ".join(
                  f"{n} {checked[n]['calls']} calls max err "
                  f"{checked[n]['max_abs_err']:.2e}" for n in sk)
              + "; " + json.dumps(dict(warm, detects=None, kinds=None),
                                  default=str) + f" ({card})")
        for cell, key in (("l", "l_live"), ("m", "m_resume")):
            seqs, all_recs = [], []
            for _ in range(N_TIMED_MERGE_SEQUENCES):
                for k in sk.values():
                    k.launches = 0
                torch.cuda.synchronize()
                res, recs = run_cell(cell)
                res["launches"] = {n: k.launches for n, k in sk.items()}
                res["fps"] = res["frames"] / res["seconds"]
                require(all(res["launches"][n] > 0
                            for n in ("K1", "K2", "K3")),
                        f"({cell}): launches {res['launches']}")
                seqs.append(res)
                all_recs += recs
            sync_res, sync_recs = run_cell(cell, syncs=True)
            runs = ([warm] if cell == "l" else []) + seqs + [sync_res]
            kinds = {}
            for kind in ("uninitialised", "init", "tracked", "keyframe",
                         "keyframe_detect", "lost", "merge"):
                rs = [r for r in all_recs if r["kind"] == kind]
                st_ = spread(r["ms"] for r in rs)
                st_["launches_per_frame"] = {
                    n: (sum(r["launches"][n] for r in rs) / len(rs)
                        if rs else None) for n in sk}
                ss = [r for r in sync_recs if r["kind"] == kind]
                st_["syncs_per_frame"] = (sum(len(r["syncs"]) for r in ss)
                                          / len(ss) if ss else None)
                sites = {}
                for r in ss:
                    for w_ in r["syncs"]:
                        sites[w_] = sites.get(w_, 0) + 1
                st_["sync_sites"] = {k: v / len(ss)
                                     for k, v in sorted(sites.items())}
                st_["jax_host_reads"] = JAX_MERGE_READS[kind]
                kinds[kind] = st_
                if st_["n"]:
                    phase(name, f"({cell}) {kind} frames ({st_['n']} over "
                          f"{len(seqs)} sequences): track() median "
                          f"{st_['median']:.3f} ms, p80 {st_['p80']:.3f} ms "
                          f"(min {st_['min']:.3f}, max {st_['max']:.3f}); "
                          f"launches per frame {st_['launches_per_frame']}; "
                          f"{st_['syncs_per_frame']} synchronisations per "
                          f"frame {st_['sync_sites']} ({card})")
            r0 = seqs[0]
            phase(name, f"({cell}) {r0['frames']} frames in "
                  f"{r0['seconds']:.3f} s = {r0['fps']:.2f} frames/s; merged "
                  f"at frame {r0['merge_index']} (JAX "
                  f"{graft.MERGE_JAX[cell]['index']}), keyframe "
                  f"{r0['merge_kf']} (JAX {graft.MERGE_JAX[cell]['kf_id']}); "
                  f"{r0['n_kf_end']} keyframes in one map (map A "
                  f"{r0['n_kf_a']}); ATE {r0['ate_m']:.5f} m, the cell's "
                  f"{len(runs)} runs {[round(r['ate_m'], 5) for r in runs]} "
                  f"(JAX {graft.MERGE_JAX[cell]['ate_m']:.5f})"
                  + (f"; checkpoint {r0['bytes']} B, save {r0['save_s']:.3f}"
                     f" s, load {r0['load_s']:.3f} s" if cell == "m" else "")
                  + f" ({card})")
            out[key] = {"warmup": warm if cell == "l" else None,
                        "sequences": seqs, "frame_kinds": kinds,
                        "sync_run": dict(sync_res, kinds=None, detects=None)}
    finally:
        graft.mono_keyframe_step = keyframe_step
        lc_mod.LoopCloser.detect_merge = detect_merge
        system_mod.MonoSlam._merge_maps = merge_maps
    out["config"] = {k: v for k, v in dataclasses.asdict(
        dataclasses.replace(cfg_l, vocabulary=None)).items()
        if not isinstance(v, np.ndarray)}
    out["checked"] = checked
    out["seconds"] = time.perf_counter() - t17
    phase(name, f"phase took {out['seconds']:.1f} s")
    return out, calls


def phase_chessboard(dev, card, sk, check_call, system) -> dict:
    """Phase "18 chessboard": the fork's chessboard world frame at the
    Mycamera configuration (``graft.MYCAMERA_MONO``, 1280x1024 with radtan,
    the 9 x 6 board of 24 mm squares). (a) The step,
    ``graft.chessboard_pose`` (the device detector's ChESS responses and
    candidates, one read; the lattice on the host; the corners' refinement
    and the squares' colours, one read; the planar PnP's four orderings,
    one read) on a frame with the board and on one without: 20 timed calls
    each, their synchronisations counted, the pose against the truth, the
    CPU plain path on the same frame (its corners within 1e-3 px of the
    card's, its pose from the card's corners within 1e-5). (b) Cell (n):
    ``MonoSlam`` at ``graft.chessboard_golden_config()`` on the full-size
    chessboard frames: a warm-up sequence with every K1-K3 launch held
    against its plain version, one timed sequence by frame kind (an
    uninitialised frame that ran the detector is a "snoop" frame; the
    tracked frame that moved the map into the board's frame a "rebase"
    frame), a run counting synchronisations (tracked and keyframe frames
    as phase 10's EuRoC cell), a run with ``enable_stage_timers()`` that
    prints its report; each run held by ``graft.chessboard_run_gates``
    against the JAX run (``graft.CHESS_JAX["full"]``). ``system``: phase
    10's results. Returns the phase's results."""
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt
    from orbslam3_byzyh_tpu_torch.utils import chessboard as cb

    name = "18 chessboard"
    t18 = time.perf_counter()
    out = {}
    f = graft.chessboard_frames()
    board = graft.MYCAMERA_BOARD
    e = graft.MYCAMERA_MONO
    cam = torch.tensor([e.fx, e.fy, e.cx, e.cy], device=dev)
    dist = torch.tensor(e.dist, device=dev)
    with_board, without = 0, len(f.stamps) - 1
    require(np.isfinite(f.corners[with_board]).all()
            and not np.isfinite(f.corners[without]).any(),
            "the fixture's board and board-less frames")

    # (a) The step.
    step = {}
    for key, i in (("board", with_board), ("no_board", without)):
        img = convert.to_torch(f.frames[i], dev).to(torch.float32)
        res = graft.chessboard_pose(img, board, cam, dist)      # warm-up
        with counted_syncs() as where:
            res = graft.chessboard_pose(img, board, cam, dist)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            graft.chessboard_pose(img, board, cam, dist)
            times.append((time.perf_counter() - t0) * 1e3)
        st_ = spread(times)
        st_.update(syncs=len(where), sync_sites=where,
                   found=res.R is not None)
        if key == "board":
            require(res.R is not None, "(a) no board found on frame 0")
            ang, cen, flipped = graft.chessboard_pose_error(
                res.R, res.t, f.R[i], f.t[i], board)
            err = np.linalg.norm(res.corners[:, None] - f.corners[i][None],
                                 axis=-1).min(1)
            # The CPU plain path: the corners on the same frame, the pose
            # from the card's corners.
            t0 = time.perf_counter()
            c_cpu = cb.detect_chessboard(img.cpu(), board)
            K = np.array([[e.fx, 0, e.cx], [0, e.fy, e.cy], [0, 0, 1.0]])
            p_cpu = cb.pose_from_chessboard(res.corners, board, K,
                                            dist=np.array(e.dist),
                                            device="cpu")
            cpu_s = time.perf_counter() - t0
            require(c_cpu is not None, "(a) the CPU path found no board")
            gap_c = float(np.abs(c_cpu - res.corners).max())
            gap_p = max(float(np.abs(p_cpu[0] - res.R).max()),
                        float(np.abs(p_cpu[1] - res.t).max()))
            st_.update(pose_deg=ang, pose_m=cen, flipped=flipped,
                       corner_err_mean=float(err.mean()),
                       corner_err_max=float(err.max()),
                       opencv_err_mean=float(f.cv_err[i]),
                       cpu_corner_gap_px=gap_c, cpu_pose_gap=gap_p,
                       cpu_s=cpu_s)
            require(ang < 0.5 and cen < 0.005,
                    f"(a) pose {ang:.4f} deg, {cen:.5f} m from the truth")
            require(gap_c <= 1e-3 and gap_p <= 1e-5,
                    f"(a) CPU plain path: corners {gap_c:.2e} px, pose "
                    f"{gap_p:.2e} from the card's")
        else:
            require(res.corners is None, "(a) a board on a board-less frame")
        step[key] = st_
        phase(name, f"(a) chessboard_pose {e.width}x{e.height} ({key}): "
              f"median {st_['median']:.3f} ms, p80 {st_['p80']:.3f} ms over "
              f"20 calls; {len(where)} synchronisations {where}"
              + (f"; pose {st_['pose_deg']:.4f} deg, {st_['pose_m']:.5f} m "
                 f"from the truth; corners {st_['corner_err_mean']:.4f} / "
                 f"{st_['corner_err_max']:.4f} px (OpenCV "
                 f"{st_['opencv_err_mean']:.4f}); the CPU path "
                 f"{gap_c:.2e} px, pose {gap_p:.2e} ({cpu_s:.2f} s)"
                 if key == "board" else "") + f" ({card})")
    out["step"] = step

    # (b) Cell (n).
    cfg = graft.chessboard_golden_config()
    spies = {"K1": (cuda_brief, "brief_descriptors_kernel"),
             "K2": (cuda_match, "hamming_best2_kernel"),
             "K3": (cuda_pose_opt, "pose_optimization_kernel")}
    originals = {n: getattr(mod, fn) for n, (mod, fn) in spies.items()}
    checked = {n: {"calls": 0, "max_abs_err": 0.0} for n in sk}
    guard, bundles, events = [], [], {}
    keyframe_step = graft.mono_keyframe_step
    snoop = system_mod.MonoSlam._snoop_chessboard
    rebase = system_mod.MonoSlam._apply_chessboard_rebase
    at = [0]

    def counted_bundle(*a, **kw):
        bundles.append(1)
        return keyframe_step(*a, **kw)

    def recorded_snoop(self, img):
        events.setdefault("snoops", []).append(at[0])
        snoop(self, img)
        if self._chess_pose is not None:
            events.setdefault("snoop", at[0])

    def recorded_rebase(self, *a):
        events.setdefault("rebases", []).append(at[0])
        out_ = rebase(self, *a)
        # Keyframe 0 right after the rebase, read after the frame (a read
        # here would count as the frame's).
        events["kf0_after"] = (self.state.kfs.R[0].clone(),
                               self.state.kfs.t[0].clone())
        return out_

    def checking(n):
        fn = originals[n]

        def spy(*a, **kw):
            res = fn(*a, **kw)
            if guard:
                return res
            guard.append(n)
            try:
                err, _ = check_call(n, a, kw, checked[n])
            finally:
                guard.pop()
            checked[n]["calls"] += 1
            checked[n]["max_abs_err"] = max(checked[n]["max_abs_err"],
                                            float(err))
            return res

        return spy

    def run_cell(syncs=False, timers=False):
        events.clear()
        slam = system_mod.MonoSlam(cfg)
        if timers:
            slam.enable_stage_timers()
        recs = []
        t_seq = time.perf_counter()
        for i, (img, stamp) in enumerate(zip(f.frames, f.stamps)):
            at[0] = i
            was = slam.status
            n_b, n_s = len(bundles), len(events.get("snoops", []))
            n_r = len(events.get("rebases", []))
            before = {n: k.launches for n, k in sk.items()}
            ctx = counted_syncs() if syncs else contextlib.nullcontext([])
            with ctx as where:
                t0 = time.perf_counter()
                slam.track(img, float(stamp))
                ms_ = (time.perf_counter() - t0) * 1e3
            if was == system_mod.NOT_INITIALIZED:
                if slam.status != system_mod.NOT_INITIALIZED:
                    kind = "init"
                elif len(events.get("snoops", [])) > n_s:
                    kind = "snoop"
                else:
                    kind = "uninitialised"
            elif len(events.get("rebases", [])) > n_r:
                kind = "rebase"
            elif len(bundles) > n_b:
                kind = "keyframe"
            else:
                kind = "tracked"
            if kind == "init":
                events["init"] = i
                events["kf0"] = int(np.argmin(np.abs(
                    f.stamps - (slam._init_stamp + slam.t0))))
            recs.append({"kind": kind, "ms": ms_, "syncs": list(where),
                         "launches": {n: k.launches - before[n]
                                      for n, k in sk.items()}})
        traj = slam.trajectory
        sec = time.perf_counter() - t_seq
        if "kf0_after" in events:
            R0, t0_ = (convert.to_numpy(x) for x in events.pop("kf0_after"))
            events["kf0_gap"] = max(
                float(np.abs(R0 - slam._chess_pose[0]).max()),
                float(np.abs(t0_ - slam._chess_pose[1]).max()))
        res = graft.chessboard_run_gates(dict(events), slam, traj, f)
        res.update(seconds=sec, fps=len(f.stamps) / sec,
                   kinds=[r["kind"] for r in recs])
        require(res["ok"], f"(n): {json.dumps(res, default=str)} against "
                f"the JAX run {graft.CHESS_JAX['full']}")
        return slam, recs, res

    graft.mono_keyframe_step = counted_bundle
    system_mod.MonoSlam._snoop_chessboard = recorded_snoop
    system_mod.MonoSlam._apply_chessboard_rebase = recorded_rebase
    try:
        for n_, (mod, fn) in spies.items():
            setattr(mod, fn, checking(n_))
        try:
            _, _, warm = run_cell()
            torch.cuda.synchronize()
            check_call.settle()
        finally:
            for n_, (mod, fn) in spies.items():
                setattr(mod, fn, originals[n_])
        require(all(checked[n]["calls"] > 0 for n in ("K1", "K2", "K3")),
                f"(n): kernels launched {checked}")
        phase(name, "(n) warm-up sequence, every launch held against its "
              "plain version: " + ", ".join(
                  f"{n} {checked[n]['calls']} calls max err "
                  f"{checked[n]['max_abs_err']:.2e}" for n in sk)
              + "; " + json.dumps(dict(warm, kinds=None, rot_deg=None),
                                  default=str) + f" ({card})")
        for k in sk.values():
            k.launches = 0
        torch.cuda.synchronize()
        _, recs, timed_run = run_cell()
        timed_run["launches"] = {n: k.launches for n, k in sk.items()}
        require(all(timed_run["launches"][n] > 0
                    for n in ("K1", "K2", "K3")),
                f"(n): launches {timed_run['launches']}")
        _, sync_recs, sync_run = run_cell(syncs=True)
        slam_t, _, timers_run = run_cell(timers=True)
    finally:
        graft.mono_keyframe_step = keyframe_step
        system_mod.MonoSlam._snoop_chessboard = snoop
        system_mod.MonoSlam._apply_chessboard_rebase = rebase
    kinds = {}
    for kind in ("snoop", "uninitialised", "init", "rebase", "tracked",
                 "keyframe"):
        rs = [r for r in recs if r["kind"] == kind]
        st_ = spread(r["ms"] for r in rs)
        st_["launches_per_frame"] = {
            n: (sum(r["launches"][n] for r in rs) / len(rs) if rs else None)
            for n in sk}
        ss = [r for r in sync_recs if r["kind"] == kind]
        st_["syncs_per_frame"] = (sum(len(r["syncs"]) for r in ss) / len(ss)
                                  if ss else None)
        sites = {}
        for r in ss:
            for w_ in r["syncs"]:
                sites[w_] = sites.get(w_, 0) + 1
        st_["sync_sites"] = {k: v / len(ss) for k, v in sorted(sites.items())}
        kinds[kind] = st_
        if st_["n"]:
            phase(name, f"(n) {kind} frames ({st_['n']}): track() median "
                  f"{st_['median']:.3f} ms, p80 {st_['p80']:.3f} ms (min "
                  f"{st_['min']:.3f}, max {st_['max']:.3f}); launches per "
                  f"frame {st_['launches_per_frame']}; "
                  f"{st_['syncs_per_frame']} synchronisations per frame "
                  f"{st_['sync_sites']} ({card})")
    # With the timers off, a tracked frame synchronises as phase 10's mono
    # cells' do (once), and a keyframe frame at no site theirs do not (its
    # count moves with the culling a run does: a culled keyframe's frame
    # records are rebased with one more read).
    ref = {k: v["frame_kinds"] for k, v in system.items()
           if "frame_kinds" in v}
    require(kinds["tracked"]["syncs_per_frame"] in (None, *(
        r["tracked"]["syncs_per_frame"] for r in ref.values())),
        f"(n) tracked: {kinds['tracked']['syncs_per_frame']} "
        f"synchronisations per frame against phase 10's "
        f"{[r['tracked']['syncs_per_frame'] for r in ref.values()]}")
    sites = set().union(*(r["keyframe"].get("sync_sites", {})
                          for r in ref.values()))
    require(set(kinds["keyframe"]["sync_sites"]) <= sites,
            f"(n) keyframe: synchronisation sites "
            f"{kinds['keyframe']['sync_sites']} against phase 10's {sites}")
    report = slam_t.timers.report()
    phase(name, "(n) stage timers (enable_stage_timers, each stage "
          "synchronised):\n" + report)
    phase(name, f"(n) {len(f.stamps)} frames in {timed_run['seconds']:.3f} s "
          f"= {timed_run['fps']:.2f} frames/s (the frame period at 30 fps is "
          f"33.3 ms); the board on frame {timed_run['snoop']} (JAX "
          f"{graft.CHESS_JAX['full']['snoop']}), keyframe 0 from frame "
          f"{timed_run['kf0']}, rebase on frame {timed_run['rebase']} (JAX "
          f"{graft.CHESS_JAX['full']['rebase']}); the snooped pose "
          f"{timed_run['pose_deg']:.4f} deg, {timed_run['pose_m']:.5f} m "
          f"from the truth; the largest tracked rotation error "
          f"{timed_run['rot_deg_max']:.4f} deg; ATE after the scale fit "
          f"{timed_run['ate_m']:.5f} m (JAX "
          f"{graft.CHESS_JAX['full']['ate_m']:.5f}, gate "
          f"{timed_run['ate_gate_m']:.5f}); launches "
          f"{timed_run['launches']} ({card})")
    out["n_chessboard"] = {
        "config": {k: v for k, v in dataclasses.asdict(
            dataclasses.replace(cfg, chessboard=None)).items()
            if not isinstance(v, np.ndarray)},
        "warmup": dict(warm, kinds=None), "sequences": [timed_run],
        "sync_run": dict(sync_run, kinds=None),
        "timers_run": dict(timers_run, kinds=None),
        "stage_timers": slam_t.timers.stats(), "frame_kinds": kinds,
        "checked": checked}
    out["seconds"] = time.perf_counter() - t18
    phase(name, f"phase took {out['seconds']:.1f} s")
    return out


def phase_last_modules(dev, card, sk, check_call, timed, shape_of, shared,
                       checkpoint) -> dict:
    """Phase "20": the last modules of the port, run after phase 17 with
    phase 16's map. (a) The sharded closure: phase 16's
    ``graft.loop_closing_step`` with the inline GBA on
    ``graft.euroc_loop_map`` at the EuRoC-mono capacity, once unsharded
    and once over a 4-shard mesh on the one card
    (``parallel.dist_ba``): the same loop edge, the GBA's cost within
    5 % + 1 (tests/test_dist_ba.py's tolerance) and the keyframe
    rotations within ``F32_CLOSURE_R``; the GBA alone on the
    closed map in float64 with 4 shards and with 1, keyframe poses within
    5e-4 (R) and 5e-3 m (t) (tests/test_dist_ba.py's; in float32 the GBA
    of this map is determined only to about 1e-2, so the float32 poses'
    distances, and two unsharded float32 runs' distance from each other,
    are reported beside it); the GBA timed with 1 and 4 shards
    and the sharded one's synchronisations counted. (b) The
    edge-sharded pose graph (``parallel.dist_posegraph``, 4 shards) on the
    essential graph ``LoopCloser.close`` handed ``optimize_pose_graph`` in
    (a), against the unsharded result within 1e-3 (R) and 5e-3 (t)
    (tests/test_dist_posegraph.py's), both timed. (c)
    ``graft.dryrun_multichip(4)`` on the card, its global BA against the
    unsharded one. (d) K3 and K3s with the KB8 camera (TUM-VI 512's
    coefficients, 1000 points): one launch each through
    ``solver.pose_opt``, within 1e-4 of the float64 plain version, timed
    alone, by the wrapper and plain, with their bound. (e)
    tests/test_kb8_ab.py's A/B study on the card (24 trials at 85 degrees,
    16 at 50, its gates): one KB8 launch a trial, each held against the
    float64 plain version in the oracle pool. (f) The viewer: (o)'s
    snapshot run (``shared["viewer_run"]``, run in phase 19) and
    ``scripts/view_atlas_torch.py``'s main on cell (m)'s checkpoint
    (``checkpoint``), read back and not blank."""
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch.io import png
    from orbslam3_byzyh_tpu_torch.parallel import dist_ba, dist_posegraph
    from orbslam3_byzyh_tpu_torch.pipeline import mapping
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt, pose_graph
    from orbslam3_byzyh_tpu_torch.solver import pose_opt
    from orbslam3_byzyh_tpu_torch.utils import viewer

    t20 = time.perf_counter()
    out = {"kb8_launches_before": dict(cuda_pose_opt.KB8_LAUNCHES)}
    mesh = dist_ba.make_mesh(4, devices=[dev] * 4)
    require(all(d.type == "cuda" for d in mesh.devices),
            f"mesh {mesh.devices}: every shard on a CUDA device")
    loop = shared.pop("loop")
    m, state0, cam, cfg = loop["m"], loop["state0"], loop["cam"], loop["cfg"]
    q_fire = m.revisit[-1]

    def host_ms(fn, n_warm, n_timed):
        xs = []
        for i in range(n_warm + n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= n_warm:
                xs.append((time.perf_counter() - t0) * 1e3)
        return spread(xs)

    # (a) The closure, unsharded and over the mesh.
    def closure(mesh_):
        lc = loop["closer"](dev, state0)
        infos = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in m.revisit:
            st, info = graft.loop_closing_step(
                state0, lc, q, m.n_kf, cam, kf_parent=m.kf_parent, cfg=cfg,
                gba="inline", mesh=mesh_)
            infos.append(info)
        torch.cuda.synchronize()
        return st, lc, infos, time.perf_counter() - t0

    pg_calls = []
    with spied(pose_graph, "optimize_pose_graph",
               lambda a, kw, r: pg_calls.append((a, kw))):
        st1, lc1, inf1, s1 = closure(None)
    st4, lc4, inf4, s4 = closure(mesh)
    edges = [[e[:2] for e in lc.loop_edges[0]] for lc in (lc1, lc4)]
    require(inf1[-1]["fired"] and inf4[-1]["fired"] and edges[0] == edges[1]
            and len(edges[0]) == 1 and len(pg_calls) == 1,
            f"(a) loop edges {edges}, fired {inf1[-1]['fired']} / "
            f"{inf4[-1]['fired']}, {len(pg_calls)} pose graphs")
    n = m.n_kf

    def gaps(a_, b_):
        return (float((a_.kfs.R[:n].double() - b_.kfs.R[:n].double())
                      .abs().max()),
                float((a_.kfs.t[:n].double() - b_.kfs.t[:n].double())
                      .abs().max()))

    gap_R, gap_t = gaps(st4, st1)
    c1, c4 = loop_cost(st1, cam), loop_cost(st4, cam)
    require(abs(c4 - c1) < 0.05 * c1 + 1.0 and gap_R <= F32_CLOSURE_R,
            f"(a) sharded closure: cost {c4} against {c1}, rotations "
            f"{gap_R:.2e} apart (at most {F32_CLOSURE_R})")
    cand, corr = inf1[-1]["cand"], inf1[-1]["sim3"]
    lc1.loop_edges[0] = []
    st_fu = mapping.fuse_duplicates(
        lc1.close(state0, q_fire, cand, corr, n, span_parent=m.kf_parent),
        q_fire, cam, float(cfg.width), float(cfg.height))
    # The GBA alone on the closed map in float64, where its result is
    # determined: there the sharded and unsharded GBA must agree within
    # tests/test_dist_ba.py's tolerances. In float32 this GBA's poses are
    # determined only to about 1e-2 (scripts/gba_spread_torch.py; on a
    # 40-keyframe cut on the CPU, where every run is deterministic, float32
    # results lie 1e-2 rad and 0.06 m from the float64 one, a 4-shard run
    # 0.015 m from the unsharded one, not along the scale gauge): the
    # float32 closures are held to F32_CLOSURE_R in rotation, and their
    # translations are reported.
    f64 = lambda st: type(st)(*(type(g)(*(  # noqa: E731
        x.double() if x.is_floating_point() else x for x in g)) for g in st))
    st_64, cam_64 = f64(st_fu), cam.double()
    g64_1 = mapping.global_ba(st_64, cam_64)
    g64_4 = mapping.global_ba(st_64, cam_64, mesh=mesh)
    gap64 = gaps(g64_4, g64_1)
    require(gap64[0] <= 5e-4 and gap64[1] <= 5e-3,
            f"(a) sharded GBA in float64: poses off by {gap64[0]:.2e} (R), "
            f"{gap64[1]:.2e} m (t)")
    del st_64, g64_4
    # Timed warm (the closures ran each form); the timed runs are kept:
    # the second unsharded run's distance from the first is what the
    # card's atomic adds alone move this float32 GBA.
    reps1, reps4 = [], []
    gba1 = host_ms(lambda: reps1.append(mapping.global_ba(st_fu, cam)), 0, 2)
    gba4 = host_ms(lambda: reps4.append(
        mapping.global_ba(st_fu, cam, mesh=mesh)), 0, 2)
    repeat32 = gaps(reps1[1], reps1[0])
    float32_off = dict(unsharded=gaps(reps1[0], g64_1),
                       sharded=gaps(reps4[0], g64_1))
    del reps1, reps4, g64_1
    callers = []
    with counted_syncs(callers=callers) as where:
        mapping.global_ba(st_fu, cam, mesh=mesh)
    sites = {}
    for w in where:
        sites[w] = sites.get(w, 0) + 1
    out["a_closure"] = dict(
        loop_edge=edges[0], pose_gap_R=gap_R, pose_gap_t_m=gap_t,
        gba_float64_gap=gap64, gba_float32_from_float64=float32_off,
        gba_float32_repeat_gap=repeat32,
        cost_1=c1, cost_4=c4, closure_s_1=s1, closure_s_4=s4,
        gba_ms_1=gba1, gba_ms_4=gba4, gba_4_syncs=len(where),
        gba_4_sync_sites=sites, gba_4_sync_callers=sorted(set(callers)),
        mesh=[str(d) for d in mesh.devices])
    phase("20 mesh", f"(a) the closure on graft.euroc_loop_map ({n} "
          f"keyframes, {cfg.max_kf} / {cfg.max_lm} / {cfg.max_obs} slots) "
          f"with the inline GBA over {mesh.size} shards on "
          f"{mesh.devices[0]}: loop edge {edges[0]} as unsharded; cost "
          f"{c4:.3f} against {c1:.3f}; poses {gap_R:.2e} (R, at most "
          f"{F32_CLOSURE_R}) and {gap_t:.2e} m (t) from the unsharded "
          f"closure's in float32; the "
          f"GBA alone in float64 within {gap64[0]:.2e} (R) and "
          f"{gap64[1]:.2e} m (t) of the unsharded one, the float32 GBA's "
          f"distance from it (R, t) {float32_off}, two unsharded float32 "
          f"GBAs {repeat32[0]:.2e} (R) and {repeat32[1]:.2e} m (t) "
          f"apart; closure {s4:.3f} s "
          f"against {s1:.3f} s; the "
          f"GBA median {gba4['median']:.1f} ms with 4 shards, "
          f"{gba1['median']:.1f} ms with 1; the sharded GBA's "
          f"synchronisations {len(where)} {sites} ({card})")
    del st1, st4, st_fu

    # (b) The essential graph of (a)'s closure, edge-sharded.
    a, kw = pg_calls[0]
    res_1 = pose_graph.optimize_pose_graph(*a, **kw)
    padded = dist_posegraph.pad_edges(*a[3:9], mesh.size)

    def sharded():
        return dist_posegraph.dist_optimize_pose_graph(
            *a[:3], *padded, a[9], a[10], mesh=mesh, **kw)

    results = []
    pg4 = host_ms(lambda: results.append(sharded()), 0, 1)
    res_4 = results[0]
    pg_R = float((res_4.R - res_1.R).abs().max())
    pg_t = float((res_4.t - res_1.t).abs().max())
    require(pg_R <= 1e-3 and pg_t <= 5e-3,
            f"(b) sharded pose graph off by {pg_R:.2e} (R), {pg_t:.2e} (t)")
    pg1 = host_ms(lambda: pose_graph.optimize_pose_graph(*a, **kw), 0, 3)
    out["b_pose_graph"] = dict(
        edges=int(a[3].shape[0]), padded_edges=int(padded[0].shape[0]),
        vertices=int(a[0].shape[0]), n_live=kw.get("n_live"),
        n_iters=kw.get("n_iters"), gap_R=pg_R, gap_t=pg_t, ms_1=pg1,
        ms_4=pg4)
    phase("20 mesh", f"(b) the essential graph ({a[3].shape[0]} edges, "
          f"{padded[0].shape[0]} padded over {mesh.size} shards; "
          f"{a[0].shape[0]} vertex slots, n_live {kw.get('n_live')}) "
          f"within {pg_R:.2e} (R) and {pg_t:.2e} (t) of the unsharded "
          f"result; median {pg4['median']:.1f} ms sharded (op by op) "
          f"against {pg1['median']:.1f} ms unsharded (its CUDA graph) "
          f"({card})")

    # (c) The dry run.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state2, pgr = graft.dryrun_multichip(4)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    tiny, camt, bft = graft.make_tiny_map_state(n_kf=6, n_lm=64, device=dev)
    ref = mapping.global_ba(tiny, camt, use_stereo=True, bf=bft)
    dry_R = float((state2.kfs.R - ref.kfs.R).abs().max())
    dry_t = float((state2.kfs.t - ref.kfs.t).abs().max())
    require(state2.kfs.R.is_cuda and dry_R <= 5e-4 and dry_t <= 5e-3
            and float(pgr.cost) >= 0.0,
            f"(c) dry run: {dry_R:.2e} (R), {dry_t:.2e} (t), pose-graph "
            f"cost {float(pgr.cost)}")
    out["c_dryrun"] = dict(seconds=dry_s, gap_R=dry_R, gap_t=dry_t,
                           pose_graph_cost=float(pgr.cost))
    phase("20 mesh", f"(c) graft.dryrun_multichip(4): {dry_s:.2f} s; its "
          f"sharded global BA within {dry_R:.2e} (R) and {dry_t:.2e} (t) "
          f"of the unsharded one; pose-graph cost {float(pgr.cost):.3e} "
          f"({card})")

    # (d) K3 and K3s with the KB8 camera.
    kb8 = {}
    for nm, stereo in (("K3", False), ("K3s", True)):
        p = graft.kb8_pose_problem(1000, stereo=stereo)
        args = tuple(x if isinstance(x, float) else convert.to_torch(x, dev)
                     for x in p)
        kw = {"model_id": KB8}
        for k in sk.values():
            k.launches = 0
        n0 = cuda_pose_opt.KB8_LAUNCHES[sk[nm].fn]
        if stereo:
            res = pose_opt.pose_optimization_stereo(*args, **kw)
        else:
            res = pose_opt.pose_optimization(*args, **kw)
        launches = {k_: k.launches for k_, k in sk.items()}
        n_kb8 = cuda_pose_opt.KB8_LAUNCHES[sk[nm].fn] - n0
        require(launches[nm] == 1 and sum(launches.values()) == 1
                and n_kb8 == 1,
                f"(d) {nm} KB8: launches {launches}, {n_kb8} of the KB8 "
                f"variant")
        err, (b_ms, b_by, b_txt) = check_call(nm, args, kw)
        entry = {"call": f"{nm} KB8 (TUM-VI 512)",
                 "shape": shape_of(nm, args, kw), "launches": 1,
                 "n_inliers": int(res.n_inliers), "max_abs_err": err,
                 "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
        entry.update(timed(nm, args, kw, plain_reps=K3_PLAIN_REPS))
        kb8[nm] = entry
        phase("20 KB8", f"(d) {nm} with the KB8 camera, N=1000"
              + (f" ({entry['shape']['stereo_rows']} stereo rows)"
                 if stereo else "") + f": within {err:.2e} of the float64 "
              f"plain version, {entry['n_inliers']} inliers; launch alone "
              f"{entry['ms']:.4f} ms, wrapper {entry['wrapper_ms']:.4f} ms, "
              f"plain {entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
              f"{b_by} ({card})")

    # (e) The A/B study on the card.
    for k in sk.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n0 = cuda_pose_opt.KB8_LAUNCHES[cuda_pose_opt.MONO_FN]
    with recorded(cuda_pose_opt, "pose_optimization_kernel") as k3c:
        wide = graft.kb8_ab_study(np.random.default_rng(42), n_trials=24,
                                  max_angle_deg=85.0, device=dev)
        moderate = graft.kb8_ab_study(np.random.default_rng(42), n_trials=16,
                                      max_angle_deg=50.0, device=dev)
    torch.cuda.synchronize()
    ab_s = time.perf_counter() - t0
    launches = {k_: k.launches for k_, k in sk.items()}
    n_kb8 = sum(1 for _, kw_ in k3c if kw_.get("model_id") == KB8)
    counted = cuda_pose_opt.KB8_LAUNCHES[cuda_pose_opt.MONO_FN] - n0
    gates = graft.kb8_ab_gates(wide, moderate)
    require(gates["ok"] and n_kb8 == 40 and counted == 40
            and launches["K3"] == 80 and launches["K3"] == len(k3c),
            f"(e) A/B: gates {gates}, medians {wide['med_rect']:.5f} / "
            f"{wide['med_native']:.5f} (85 deg), {moderate['med_rect']:.5f}"
            f" / {moderate['med_native']:.5f} (50 deg); {n_kb8} KB8 "
            f"launches, K3 {launches['K3']}")
    # Each launch held against the float64 plain version in the oracle
    # pool, settled by a later phase (``study_held`` reads the errors).
    held = {"max_abs_err": 0.0}
    held_kb8 = {"max_abs_err": 0.0}
    for args, kw_ in k3c:
        check_call("K3", args, kw_,
                   held_kb8 if kw_.get("model_id") == KB8 else held)
    kb8["K3"].update(launches_study=n_kb8)
    out["e_ab"] = dict(
        gates=gates, seconds=ab_s, launches=launches, kb8_launches=n_kb8,
        wide={k: v for k, v in wide.items() if k.startswith(("med", "err"))},
        moderate={k: v for k, v in moderate.items()
                  if k.startswith(("med", "err"))})

    def study_held():
        out["e_ab"].update(kb8_max_abs_err=held_kb8["max_abs_err"],
                           pinhole_max_abs_err=held["max_abs_err"])
        kb8["K3"].update(study_max_abs_err=held_kb8["max_abs_err"])
        phase("20 KB8", f"(e) the study's {launches['K3']} K3 launches "
              f"({n_kb8} KB8), each within {held_kb8['max_abs_err']:.2e} "
              f"(KB8) and {held['max_abs_err']:.2e} (pinhole) of the float64 "
              f"plain version")

    out["study_held"] = study_held
    phase("20 KB8", f"(e) tests/test_kb8_ab.py's study on the card: 85 deg "
          f"(24 trials) median error rectified {wide['med_rect']:.5f} m, "
          f"native {wide['med_native']:.5f} m; 50 deg (16) "
          f"{moderate['med_rect']:.5f} / {moderate['med_native']:.5f} m; "
          f"gates {gates}; {launches['K3']} K3 launches ({n_kb8} KB8), held "
          f"against the float64 plain version in the oracle pool; "
          f"{ab_s:.2f} s ({card})")
    out["kb8"] = kb8

    # (f) The viewer: the snapshot run (phase 19) and the atlas render.
    run = shared.pop("viewer_run")
    work = tempfile.mkdtemp()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = viewer.main_view_atlas([checkpoint, "--out",
                                       os.path.join(work, "atlas_m.png")])
        atlas_s = time.perf_counter() - t0
        img = png.read_rgb(path)
        drawn = int((img != 255).any(-1).sum())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(img.shape == (720, 900, 3) and drawn > 100,
            f"(f) view_atlas: {img.shape}, {drawn} pixels drawn")
    out["f_viewer"] = dict(run, view_atlas_s=atlas_s,
                           view_atlas_drawn_pixels=drawn)
    phase("20 viewer", f"(f) view_atlas_torch.py on cell (m)'s checkpoint: "
          f"{atlas_s:.2f} s, {drawn} pixels drawn; the snapshots cost "
          f"{run['snapshot_ms_total']:.1f} ms of host time in all (the "
          f"snapshot run {run['fps_user']:.2f} frames/s, (o)'s timed run "
          f"before it {run['fps_user_without']:.2f}) ({card})")
    out["kb8_launches_after"] = dict(cuda_pose_opt.KB8_LAUNCHES)
    out["seconds"] = time.perf_counter() - t20
    phase("20", f"phase took {out['seconds']:.1f} s (the snapshot run's "
          f"{run['seconds']:.1f} s in phase 19)")
    return out


# Phase 19's Paeth files for the prefetcher's thread scaling.
N_PAETH_FILES = 16


def fabricate_dataset(kind: str, root: str):
    """``graft.write_runner_dataset(kind)`` at phase 19's frames under
    ``root``; runs in a worker process of the oracle pool."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    torch.set_num_threads(1)
    from orbslam3_byzyh_tpu_torch import graft
    return graft.write_runner_dataset(kind, os.path.join(root, kind))


class RunnerProbe:
    """What a runner's frame loop did, seen from ``on_system``: each
    ``track`` call's frame kind (as phase 13's: uninitialised, init, visual,
    inertial, keyframe, imu_keyframe; tracked for the systems without an
    IMU), its host-clock ms and, inside ``counted_syncs``, the
    synchronisations inside ``track`` and between two ``track`` calls (the
    runner's own: decode, rectification, CLAHE, the IMU batch)."""

    def __init__(self, bundles, where=None):
        self.bundles, self.where = bundles, where
        self.frames, self.slam = [], None

    def _n(self):
        return len(self.where) if self.where is not None else 0

    def __call__(self, slam):
        from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
        self.slam = slam
        track = slam.track
        mark = [self._n()]

        def probed(*args):
            uninit = slam.status == system_mod.NOT_INITIALIZED
            imu = hasattr(slam, "imu_ready")
            ready = imu and slam.imu_ready
            stage = slam.viba_stage if imu else None
            n_b = len(self.bundles)
            s0 = self._n()
            t0 = time.perf_counter()
            pose = track(*args)
            ms = (time.perf_counter() - t0) * 1e3
            s1 = self._n()
            if uninit:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            elif len(self.bundles) > n_b:
                kind = ("imu_keyframe" if imu and slam.viba_stage != stage
                        else "keyframe")
            elif imu:
                kind = "inertial" if ready else "visual"
            else:
                kind = "tracked"
            self.frames.append({"kind": kind, "ms": ms,
                                "syncs_in": s1 - s0,
                                "syncs_out": s0 - mark[0]})
            mark[0] = s1
            return pose

        slam.track = probed

    def init_frame(self):
        return next((i for i, f in enumerate(self.frames)
                     if f["kind"] == "init"), None)


@contextlib.contextmanager
def spied_method(cls, name: str, calls: list):
    """Record (args, result) of every call of the method ``cls.name``."""
    fn = getattr(cls, name)

    def spy(self, *args):
        out = fn(self, *args)
        calls.append((args, out))
        return out

    setattr(cls, name, spy)
    try:
        yield calls
    finally:
        setattr(cls, name, fn)


def rect_error(inputs, outputs, mx, my) -> float:
    """The largest distance of rectified images from the float64 plain remap
    of their inputs (numpy); runs in a worker process of the oracle pool."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from orbslam3_byzyh_tpu_torch.io import rectify
    return max(float(np.abs(y - rectify.remap_plain(x, mx, my)).max())
               for x, y in zip(inputs, outputs))


def snapshot_run(d, fps_without: float, card: str) -> dict:
    """Phase 20 (f)'s runner: the flagship runner (cell (o)) again with
    ``--snapshot-every 10``, timed as phase 19 times it. Its four PNGs are
    read back with ``io/png`` (RGB, 480 x 640, the map drawn: more than 100
    pixels off the background). The viewer's cost is the snapshots' own
    time, the sum of ``viewer.snapshot``'s host clock: the run goes right
    after phase 19's timed run of (o), on warmer caches, so its frames/s
    beside (o)'s is no measure of that cost."""
    from orbslam3_byzyh_tpu_torch import runners
    from orbslam3_byzyh_tpu_torch.io import png
    from orbslam3_byzyh_tpu_torch.utils import viewer

    snap_ms = []
    snapshot = viewer.snapshot

    def timed_snapshot(*a, **kw):
        t0 = time.perf_counter()
        out = snapshot(*a, **kw)
        snap_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    work = tempfile.mkdtemp()
    viewer.snapshot = timed_snapshot
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runners.main_euroc_stereo_inertial(
            d.argv + ["--snapshot-every", "10"], out_dir=work)
        seconds = time.perf_counter() - t0
        snaps = [p for p in res.outputs if p.endswith(".png")]
        names = [os.path.basename(p) for p in snaps]
        drawn = []
        for p in snaps:
            img = png.read_rgb(p)
            require(img.shape == (480, 640, 3), f"(f) {p}: {img.shape}")
            drawn.append(int((img != 255).any(-1).sum()))
        sizes = [os.path.getsize(p) for p in snaps]
    finally:
        viewer.snapshot = snapshot
        shutil.rmtree(work, ignore_errors=True)
    want = [f"map_{i:05d}.png" for i in range(10, res.n_total + 1, 10)]
    require(names == want and all(n_ > 100 for n_ in drawn),
            f"(f) snapshots {names} (want {want}), drawn pixels {drawn}")
    out = dict(files=names, drawn_pixels=drawn, bytes=sizes,
               seconds=seconds, fps_user=res.n_total / seconds,
               fps_user_without=fps_without, snapshot_ms=spread(snap_ms),
               snapshot_ms_total=sum(snap_ms))
    phase("20 viewer", f"(f) main_euroc_stereo_inertial --snapshot-every 10,"
          f" {res.n_total} frames: {out['fps_user']:.2f} frames/s as the "
          f"user sees it ({seconds:.2f} s; (o)'s timed run before it, "
          f"without snapshots, {fps_without:.2f}); {len(names)} PNGs "
          f"{names} read back, {drawn} pixels drawn, {sizes} B; the cost, "
          f"the snapshots' own host time: {out['snapshot_ms_total']:.1f} ms "
          f"in all (median {out['snapshot_ms']['median']:.1f} ms a "
          f"snapshot) ({card})")
    return out


def p1_device_us(d, dev, card: str) -> dict:
    """P1's device time by the profiler (CUDA activity, the kernel by
    name), per launch and per flagship frame (2 launches), on the first 8
    left images of dataset ``d`` (752x480, Sub rows), after a warm-up;
    these launches are measurements, not a path's."""
    from orbslam3_byzyh_tpu_torch.io import euroc, png
    from orbslam3_byzyh_tpu_torch.ops import cuda_png

    seq = euroc.load_euroc(d.sequence, cam="cam0")
    infs = [png.inflate(p) for p in seq.image_paths[:8]]
    raws = [torch.from_numpy(i.raw).to(dev) for i in infs]

    def decode_all():
        for r, i in zip(raws, infs):
            cuda_png.unfilter_kernel(r, i.width, i.bpp, i.mode)

    decode_all()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        decode_all()
        torch.cuda.synchronize()
    dev_evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    # By name; where the profiler names no kernel so (a session after
    # earlier ones in this process has shown P1's launches unnamed or not
    # at all), every kernel of the session, which launches P1 alone.
    evs = [e for e in dev_evs if "unfilter" in e.key] or dev_evs
    total = sum(e.self_device_time_total for e in evs)
    count = sum(e.count for e in evs)
    out = dict(launches=count, device_us_per_launch=(
        total / count if count else None), kernels=[e.key for e in evs])
    out["device_us_per_frame"] = (None if not count
                                  else 2 * out["device_us_per_launch"])
    phase("20 viewer", f"P1 by the profiler: {count} launches at "
          f"{infs[0].height}x{infs[0].width}, "
          f"{out['device_us_per_launch']} us of device time each, "
          f"{out['device_us_per_frame']} us a flagship frame; the "
          f"profiler's kernels {out['kernels']} ({card})")
    return out


def phase_runners(dev, card, sk, p1, vi_sys, datasets, oracle,
                  shared) -> dict:
    """Phase "19 runners": the port's dataset runners (``runners.py``) as a
    user calls them, on the datasets ``fabricate_dataset`` wrote in the
    oracle pool. (a) P1 on synthetic scanlines of every row filter at
    EuRoC's 752x480 (8 and 16 bit, and RGB) bit-identical to the plain
    unfilter; the prefetcher's device path with 1 and 4 threads on
    Paeth-filtered 752x480 files, and its CPU path. (o) The flagship:
    ``main_euroc_stereo_inertial`` with the runner's defaults (1200
    features, 1024 / 65,536 / 12 slots) and ``--no-vocabulary`` on (d)'s 40
    pairs through ``graft.euroc_raw_rig`` with the 200 Hz IMU: a timed run
    (the user's frames/s, the prefetcher wait, decode and rectification
    by CUDA events, frame latency by kind) with every P1 launch held
    against the plain unfilter bit for bit, every rectified pair against
    the float64 plain remap within 1e-4, the runner's rig against the plain
    float64 rig within 1e-6, (f)'s gates against the truth and the JAX
    runner's ATE (``graft.RUNNER_JAX``), the ``f_`` / ``kf_`` files read
    back with their ns stamps; a second run without the ``T_bc`` repair
    (the JAX runner's extrinsic) counting synchronisations per frame
    kind: none between two ``track`` calls, and those inside against
    (f)'s. P1 timed alone, by its wrapper, plain and its bound. (p) The
    other five runners on at most 10 frames each: they run on the card,
    initialise on the frame the CPU run of the same runner does
    (``graft.RUNNER_INIT_FRAMES``; a two-view init within the frames, as
    its RANSAC draws on the card differ from the CPU's), write their files,
    every P1 launch bit-identical, every CLAHE equal to its plain
    version. It runs right after phase 13, whose cell (f) leaves the
    flagship's CUDA graphs cached; the rectified pairs are held in the
    ``oracle`` pool while the card goes on. Phase 20 (f)'s runner
    (:func:`snapshot_run`) runs right after (o)'s timed run, its result
    in ``shared["viewer_run"]``."""
    from orbslam3_byzyh_tpu_torch import graft, runners
    from orbslam3_byzyh_tpu_torch.io import png, rectify, trajectory
    from orbslam3_byzyh_tpu_torch.io.prefetch import ImagePrefetcher
    from orbslam3_byzyh_tpu_torch.ops import clahe as clahe_mod
    from orbslam3_byzyh_tpu_torch.ops import cuda_png

    name = "19 runners"
    t19 = time.perf_counter()
    out = {}
    counters = dict(sk, P1=p1)
    rng = np.random.default_rng(19)

    # -- (a) P1 on every filter, and the prefetcher ---------------------------
    h, w = 480, 752
    img8 = ((rng.integers(0, 256, (h, w)) // 4
             + np.add.outer(np.arange(h), 3 * np.arange(w))) % 256).astype(
                 np.uint8)
    cases = [("grey8", img8.reshape(h, w), 1, png.GREY8),
             ("grey16", (img8.astype(np.uint16) * 251 + 7).astype(">u2")
              .view(np.uint8).reshape(h, -1), 2, png.GREY16),
             ("rgb8", np.repeat(img8, 3, 1) ^ rng.integers(
                 0, 8, (h, 3 * w)).astype(np.uint8), 3, png.RGB8)]
    n_held = 0
    for label, by, bpp, mode in cases:
        for filters in ((0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)):
            raw = png.filter_rows(by, bpp, filters)
            got = cuda_png.unfilter_kernel(torch.from_numpy(raw).to(dev), w,
                                           bpp, mode)
            ref = cuda_png.unfilter_plain(torch.from_numpy(raw), w, bpp, mode)
            torch.cuda.synchronize()
            require(torch.equal(got.cpu(), ref),
                    f"P1 {label} filters {filters} differs from plain")
            n_held += 1
    phase(name, f"(a) P1 {h}x{w}: {n_held} launches (grey 8, grey 16, RGB; "
          "each filter alone and all five mixed) bit-identical to the plain "
          "unfilter")
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(N_PAETH_FILES):
            paths.append(os.path.join(tmp, f"{i:03d}.png"))
            png.write_png(paths[-1], np.roll(img8, 7 * i, 1), filters=(4,))
        scaling = {}
        for where in ("cuda", "cpu"):
            for n_threads in (1, 4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pf = ImagePrefetcher(paths, n_threads=n_threads, capacity=8,
                                     device=where)
                imgs = [im for _, im in pf]
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3 / len(paths)
                pf.close()
                if where == "cuda":
                    for p, im in zip(paths, imgs):
                        require(np.array_equal(im.cpu().numpy(),
                                               png.read_grey(p)),
                                f"prefetcher: {p} differs from plain")
                scaling[f"{where}_{n_threads}"] = {
                    "ms_per_image": dt, "wait_ms_per_image":
                        pf.wait_s * 1e3 / len(paths)}
    out["prefetch_paeth_752x480"] = scaling
    phase(name, "(a) prefetcher on 752x480 Paeth files (all rows Paeth, the "
          "port's writer), ms an image end to end [wait]: " + ", ".join(
              f"{k} {v['ms_per_image']:.2f} [{v['wait_ms_per_image']:.2f}]"
              for k, v in scaling.items()) + f" ({card})")

    # -- (o) the flagship -------------------------------------------------------
    bundles = []
    keyframe_step = graft.mono_keyframe_step

    def counted_bundle(*a, **kw):
        bundles.append(1)
        return keyframe_step(*a, **kw)

    def run(main, d, probe, **kw):
        p1_calls, rect_calls, clahe_calls = [], [], []
        unfilter = cuda_png.unfilter

        def p1_spy(raw, width, bpp, mode):
            res = unfilter(raw, width, bpp, mode)
            p1_calls.append((raw, width, bpp, mode, res))
            return res

        cuda_png.unfilter = p1_spy
        work = tempfile.mkdtemp()
        try:
            with spied_method(rectify.RectifiedRig, "rectify", rect_calls), \
                    spied_method(clahe_mod.Clahe, "apply", clahe_calls):
                for k in counters.values():
                    k.launches = 0
                t0 = time.perf_counter()
                res = getattr(runners, main)(d.argv, out_dir=work,
                                             on_system=probe, **kw)
                seconds = time.perf_counter() - t0
                launches = {n: k.launches for n, k in counters.items()}
            files = {os.path.basename(p): os.path.getsize(p)
                     for p in res.outputs}
            traj, kf = (read_tum(res.outputs, "f_"),
                        read_tum(res.outputs, "kf_"))
        finally:
            cuda_png.unfilter = unfilter
            shutil.rmtree(work, ignore_errors=True)
        return dict(res=res, seconds=seconds, launches=launches, files=files,
                    traj=traj, kf=kf, p1=p1_calls, rect=rect_calls,
                    clahe=clahe_calls)

    def read_tum(paths, prefix):
        """A runner's TUM file read back with the port's ``load_tum``;
        None when it holds no pose."""
        for p in paths:
            if os.path.basename(p).startswith(prefix):
                with open(p) as f:
                    if f.read().strip():
                        return trajectory.load_tum(p)
        return None

    def hold_p1(calls):
        for raw, width, bpp, mode, res in calls:
            ref = cuda_png.unfilter_plain(raw.cpu(), width, bpp, mode)
            require(torch.equal(res.cpu(), ref), "P1 differs from plain")
        return len(calls)

    def hold_clahe(calls):
        for (img,), res in calls:
            ref = clahe_mod.clahe_plain(img.cpu().numpy())
            require(np.array_equal(res.cpu().numpy(), ref),
                    "CLAHE differs from its plain version")
        return len(calls)

    def stamps_ok(d, traj, scale):
        s = traj[0] * scale
        gap = np.abs(s[:, None] - d.stamps[None]).min(1).max()
        require(gap < 1e-6, f"{d.kind}: stamps off the dataset's by {gap}")
        return float(gap)

    def kinds_of(frames):
        by = {}
        for f in frames:
            by.setdefault(f["kind"], []).append(f)
        return {k: dict(spread(x["ms"] for x in v),
                        syncs_in=sum(x["syncs_in"] for x in v) / len(v),
                        syncs_out=sum(x["syncs_out"] for x in v))
                for k, v in by.items()}

    graft.mono_keyframe_step = counted_bundle
    try:
        d = datasets["euroc_stereo_inertial"].result()
        torch.cuda.synchronize()
        probe = RunnerProbe(bundles)
        r1 = run("main_euroc_stereo_inertial", d, probe)
        res = r1["res"]
        require(all(v > 0 for v in r1["launches"].values()),
                f"(o): kernels launched {r1['launches']}")
        n_p1 = hold_p1(r1["p1"])
        rig = res.rig
        rect_jobs = [oracle.submit(
            rect_error, [c[0][k].cpu().numpy() for c in r1["rect"]],
            [c[1][k].cpu().numpy() for c in r1["rect"]], mx, my)
            for k, (mx, my) in enumerate(((rig.map1x, rig.map1y),
                                          (rig.map2x, rig.map2y)))]
        plain_rig = graft.raw_rig_rectification(graft.euroc_raw_rig())
        rig_err = max(float(np.abs(getattr(rig, k) - getattr(plain_rig, k))
                            .max() / np.abs(getattr(plain_rig, k)).max())
                      for k in ("R1", "R2", "P1", "P2"))
        require(rig_err <= 1e-6, f"(o): rig off the plain rig by {rig_err}")
        slam = res.slam
        v = slam._body[2] if slam._body is not None else torch.zeros(3)
        g1 = graft.runner_gates(d, r1["traj"][0] * 1e-9, r1["traj"][1],
                                v_est=v.detach().cpu().numpy(),
                                jax_ate_m=graft.RUNNER_JAX["ate_m"])
        g1.update(imu_ready=bool(slam.imu_ready), stamp_gap_s=stamps_ok(
            d, r1["traj"], 1e-9), kf_stamp_gap_s=stamps_ok(d, r1["kf"], 1e-9),
            n_kf_file=len(r1["kf"][0]))
        require(g1["ok"] and slam.imu_ready,
                f"(o): {g1} against imu_ready, >= "
                f"{graft.VI_STEREO_MIN_FRAMES} frames, ATE < "
                f"{graft.VI_STEREO_ATE_GATE_M} m and < "
                f"{graft.RUNNER_JAX_ATE_GATE_M:.5f} m (1.5 x the JAX "
                f"runner's + 0.002), speed within {graft.VI_SPEED_TOL_MPS}")
        phase(name, f"(o) warm-up run: {r1['seconds']:.2f} s, every launch "
              f"held (the rectified pairs in the oracle pool)")
        # The timed run, warm: what a user's second sequence sees.
        probe = RunnerProbe(bundles)
        torch.cuda.synchronize()
        rt = run("main_euroc_stereo_inertial", d, probe)
        require(all(v > 0 for v in rt["launches"].values()),
                f"(o) timed run: kernels launched {rt['launches']}")
        hold_p1(rt["p1"])
        res = rt["res"]
        slam = res.slam
        v = slam._body[2] if slam._body is not None else torch.zeros(3)
        gt = graft.runner_gates(d, rt["traj"][0] * 1e-9, rt["traj"][1],
                                v_est=v.detach().cpu().numpy(),
                                jax_ate_m=graft.RUNNER_JAX["ate_m"])
        require(gt["ok"] and slam.imu_ready, f"(o) timed run: {gt}")
        rect_err = max(j.result() for j in rect_jobs)
        require(rect_err <= 1e-4, f"(o): rectified pair off by {rect_err}")
        waits = [f["wait_ms"] for f in res.frames]
        preps = [f["prep_ms"] for f in res.frames]
        o = {"frames": res.n_total, "main_s": rt["seconds"],
             "warmup_main_s": r1["seconds"], "loop_s": res.wall_s,
             "fps_user": res.n_total / rt["seconds"],
             "fps_loop": res.n_total / res.wall_s,
             "prefetch_wait_ms": dict(spread(waits), total=sum(waits)),
             "prep_host_ms": spread(preps),
             "decode_rectify_device_ms": spread(res.prep_device_ms or []),
             "launches": rt["launches"], "p1_held": n_p1,
             "rectified_pairs_held": len(r1["rect"]),
             "rect_max_abs_err": rect_err, "rig_rel_err": rig_err,
             "files": rt["files"], "gates": g1, "gates_timed": gt,
             "frame_kinds": kinds_of(probe.frames), "rig": {
                 "fx": rig.fx, "cx": rig.cx, "cy": rig.cy, "bf": rig.bf,
                 "R1_deg": float(np.degrees(np.linalg.norm(
                     rectify.rodrigues_to_vector(rig.R1))))},
             "T_bc": np.asarray(res.T_bc).tolist()}
        phase(name, f"(o) main_euroc_stereo_inertial, {res.n_total} frames: "
              f"{o['fps_user']:.2f} frames/s as the user sees it "
              f"({rt['seconds']:.2f} s, the files included), loop "
              f"{o['fps_loop']:.2f} frames/s; prefetcher wait "
              f"{o['prefetch_wait_ms']['total']:.2f} ms in all (median "
              f"{o['prefetch_wait_ms']['median']:.3f} ms a frame); decode + "
              f"rectify on the device median "
              f"{o['decode_rectify_device_ms'].get('median', -1):.3f} ms a "
              f"frame, host {o['prep_host_ms']['median']:.3f} ms; launches "
              f"{rt['launches']}; P1 {n_p1} launches bit-identical, "
              f"{len(r1['rect'])} pairs within {rect_err:.2e} of the plain "
              f"remap, rig within {rig_err:.1e}; gates {json.dumps(g1)} "
              f"({card})")
        for k_, st in o["frame_kinds"].items():
            phase(name, f"(o) {k_} frames ({st['n']}): track() median "
                  f"{st['median']:.3f} ms, p80 {st['p80']:.3f} ms ({card})")
        shared["viewer_run"] = snapshot_run(d, o["fps_user"], card)
        o["p1_profiler"] = p1_device_us(d, dev, card)

        # The same run without the T_bc repair, counting synchronisations.
        probe2 = RunnerProbe(bundles)
        callers = []
        with counted_syncs(callers=callers) as where:
            probe2.where = where
            r2 = run("main_euroc_stereo_inertial", d, probe2,
                     repair_tbc=False)
        hold_p1(r2["p1"])
        slam2 = r2["res"].slam
        v2 = slam2._body[2] if slam2._body is not None else torch.zeros(3)
        g2 = graft.runner_gates(d, r2["traj"][0] * 1e-9, r2["traj"][1],
                                v_est=v2.detach().cpu().numpy(),
                                jax_ate_m=graft.RUNNER_JAX["ate_m"])
        outside = sum(f["syncs_out"] for f in probe2.frames)
        require(outside == 0, f"(o): {outside} synchronisations between "
                "track calls (decode, rectify, the IMU batch)")
        kinds2 = kinds_of(probe2.frames)
        f_kinds = vi_sys.get("f_euroc_vi", {}).get("frame_kinds", {})
        compare = {}
        for k_, st in kinds2.items():
            ref = f_kinds.get(k_, {}).get("syncs_per_frame")
            compare[k_] = {"runner": st["syncs_in"], "f": ref}
            if k_ in ("uninitialised", "init", "visual") and ref is not None:
                require(st["syncs_in"] == ref,
                        f"(o): {k_} frames synchronise {st['syncs_in']} "
                        f"times, (f)'s {ref}")
        o.update(no_repair=dict(gates=g2, imu_ready=bool(slam2.imu_ready),
                                T_bc=np.asarray(r2["res"].T_bc).tolist()),
                 syncs=compare, syncs_between_tracks=outside)
        out["o_flagship"] = o
        phase(name, f"(o) ATE with the T_bc repair {g1['ate_m']:.5f} m, "
              f"without {g2['ate_m']:.5f} m (JAX runner "
              f"{graft.RUNNER_JAX['ate_m']:.5f} m at 48 / 4096 slots); "
              f"synchronisations between track calls {outside}; inside, "
              f"per frame by kind (runner vs (f)): {json.dumps(compare)}")

        # -- (p) the other five runners -----------------------------------------
        cells = {}
        for kind in graft.RUNNER_KINDS[1:]:
            d = datasets[kind].result()
            probe = RunnerProbe(bundles)
            r = run(graft.RUNNER_MAIN[kind], d, probe)
            n_p1 = hold_p1(r["p1"])
            n_cl = hold_clahe(r["clahe"])
            init = probe.init_frame()
            want = graft.RUNNER_INIT_FRAMES[kind]
            tracked = len(r["res"].slam.trajectory)
            need = ["P1", "K1"] + (["K2", "K3"] if tracked else [])
            require(all(r["launches"][n] > 0 for n in need),
                    f"({kind}): kernels launched {r['launches']}")
            require(set(r["files"]) == set(d.outputs),
                    f"({kind}): files {r['files']}")
            # A one-frame init lands where the CPU run's does; a two-view
            # init, whose RANSAC draws come from the card's generator,
            # within the frames where the CPU run's does.
            if kind in graft.RUNNER_TWO_VIEW:
                require(want is None or init is not None,
                        f"({kind}): no init; the CPU run's on frame {want}")
            else:
                require(init == want, f"({kind}): initialised on frame "
                        f"{init}, the CPU run {want}")
            if d.clahe:
                require(n_cl > 0, f"({kind}): CLAHE never ran")
            if r["traj"] is not None:
                stamps_ok(d, r["traj"], 1.0 if kind in ("kitti", "tum_rgbd")
                          else 1e-9)
            cells[kind] = {"frames": r["res"].n_total, "tracked": tracked,
                           "init_frame": init, "init_frame_cpu": want,
                           "seconds": r["seconds"],
                           "fps_user": r["res"].n_total / r["seconds"],
                           "launches": r["launches"], "p1_held": n_p1,
                           "clahe_held": n_cl, "files": r["files"],
                           "frame_kinds": kinds_of(probe.frames)}
            phase(name, f"(p) {kind}: {tracked}/{r['res'].n_total} frames "
                  f"tracked, initialised on frame {init} (CPU run {want}); "
                  f"{cells[kind]['fps_user']:.2f} frames/s; launches "
                  f"{r['launches']}; P1 {n_p1} and CLAHE {n_cl} calls equal "
                  f"to plain; files {sorted(r['files'])} ({card})")
        out["p_runners"] = cells

        # -- P1 timed at the flagship's shape -------------------------------
        raw, width, bpp, mode, _ = r1["p1"][0]
        res_, again = captured_launch(cuda_png.KERNEL, lambda: (
            cuda_png.unfilter_kernel(raw, width, bpp, mode)))
        t = {"ms": event_ms(again, primed=True),
             "wrapper_ms": event_ms(lambda: cuda_png.unfilter_kernel(
                 raw, width, bpp, mode))}
        raw_cpu = raw.cpu()
        plain = []
        for _ in range(5):
            t0 = time.perf_counter()
            cuda_png.unfilter_plain(raw_cpu, width, bpp, mode)
            plain.append((time.perf_counter() - t0) * 1e3)
        t["plain_ms"] = statistics.median(plain)
        paeth = torch.from_numpy(png.filter_rows(img8, 1, (4,))).to(dev)
        _, again_p = captured_launch(cuda_png.KERNEL, lambda: (
            cuda_png.unfilter_kernel(paeth, w, 1, png.GREY8)))
        t["ms_paeth"] = event_ms(again_p, primed=True)
        hh = raw.shape[0]
        t["bound_ms"], t["bound_by"] = bound(
            cuda_png.bound_bytes(hh, width, bpp), {})
        t["bound"] = (f"{hh} x {1 + width * bpp} filtered bytes in + {hh} x "
                      f"{width} x 4 B out over {HBM_BPS / 1e12} TB/s")
        t["shape"] = {"height": hh, "width": width, "bpp": bpp,
                      "filters": sorted(set(raw_cpu[:, 0].tolist()))}
        t["launches"] = o["launches"]["P1"]
        t["max_abs_err"] = 0.0
        del res_
        out["p1"] = t
        phase(name, f"P1 {hh}x{width} (the flagship's files, filters "
              f"{t['shape']['filters']}): launch alone {t['ms']:.4f} ms "
              f"(all rows Paeth {t['ms_paeth']:.4f}), wrapper "
              f"{t['wrapper_ms']:.4f} ms, plain (numpy, host) "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms by "
              f"bytes ({card})")
    finally:
        graft.mono_keyframe_step = keyframe_step
    out["seconds"] = time.perf_counter() - t19
    phase(name, f"phase took {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    ctx = multiprocessing.get_context("spawn")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with concurrent.futures.ProcessPoolExecutor(
                ORACLE_WORKERS, mp_context=ctx) as oracle:
            return smoke(oracle, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def smoke(oracle, root) -> int:
    """The phases; ``oracle`` is the pool that runs K3's and K3s's float64
    oracle (and writes phase 19's datasets under ``root``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from orbslam3_byzyh_tpu_torch import convert, graft
    from orbslam3_byzyh_tpu_torch import device as device_mod
    from orbslam3_byzyh_tpu_torch.ops import cuda_brief, cuda_match, fast_orb
    from orbslam3_byzyh_tpu_torch.ops import cuda_png, lie, matching
    from orbslam3_byzyh_tpu_torch.pipeline import tracking
    from orbslam3_byzyh_tpu_torch.solver import cuda_pose_opt

    dev = device_mod.resolve("cuda")
    card = card_line()
    phase("0 device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    # Phase 19's datasets, written in the oracle pool meanwhile.
    datasets = {k: oracle.submit(fabricate_dataset, k, root)
                for k in graft.RUNNER_KINDS}

    # -- 1: build, one nvcc per source, all started together ----------------
    kernels = {"K1": cuda_brief.KERNEL, "K2": cuda_match.KERNEL,
               "K3": Launcher(cuda_pose_opt.KERNEL, cuda_pose_opt.MONO_FN)}
    # K3s, K3's stereo launcher: built with K3's source, counted apart.
    k3s = Launcher(cuda_pose_opt.KERNEL, cuda_pose_opt.STEREO_FN)
    # P1, the PNG unfilter of phase 19's runners: a port kernel for a host
    # OpenCV function, built with the others.
    p1 = cuda_png.KERNEL
    cuda_pose_opt.KB8_LAUNCHES.update(dict.fromkeys(cuda_pose_opt.KB8_LAUNCHES,
                                                    0))
    t0 = time.perf_counter()
    builds = dict(kernels, P1=p1)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(k.build) for k in builds.values()]:
            f.result()
    phase("1 build", f"{time.perf_counter() - t0:.1f} s wall; " + ", ".join(
        f"{n} {k.source.name} {k.build_seconds:.1f} s"
        for n, k in builds.items()))
    ptxas = {n: ptxas_summary(k) for n, k in builds.items()}
    for n, entries in ptxas.items():
        for e in entries:
            phase("1 build", f"{n} ptxas {e}")
    tensor_ops = tensor_instructions(cuda_match.KERNEL)
    phase("1 build", f"K2 SASS tensor-core instructions: {tensor_ops}")

    # -- per-kernel checks, bounds and times, for any call's inputs --------
    def k1_check(args):
        out = cuda_brief.brief_descriptors_kernel(*args)
        ref = cuda_brief.brief_descriptors_plain(*args)
        torch.cuda.synchronize()
        err = int((out.long() - ref.long()).abs().max()) if out.numel() else 0
        require(torch.equal(out, ref), "K1 descriptors differ from plain")
        return err

    def k1_bound(args):
        # Each distinct sampled pixel read once (4 B), the keypoints' xy,
        # level and angle (16 B), the pattern (4 KB), the words written
        # (32 B); 6 flops to rotate each of the 512 sample points.
        blurred, xy, kp_level, angle = args
        sizes = [b.numel() for b in blurred]
        table = torch.tensor([[sum(sizes[:i]), b.shape[0], b.shape[1]]
                              for i, b in enumerate(blurred)],
                             dtype=torch.int64, device=dev)[kp_level.long()]
        gy, gx = fast_orb._pattern_positions(
            xy, torch.cos(angle), torch.sin(angle), table[:, 2:3].float(),
            table[:, 1:2].float())
        n_pix = int(torch.unique(table[:, 0:1] + gy.long() * table[:, 2:3]
                                 + gx.long()).numel())
        k = xy.shape[0]
        ms, by = bound(4 * n_pix + 16 * k + 4096 + 32 * k,
                       {F32_FLOPS: 6 * 512 * k})
        return ms, by, (f"{n_pix} distinct sampled pixels x 4 B + K={k} x "
                        f"(16 B in + 32 B out) + 4 KB pattern over "
                        f"{HBM_BPS / 1e12} TB/s; 6 x 512 x K f32 flops over "
                        f"{F32_FLOPS / 1e12} TFLOP/s")

    def k2_check(args, gates):
        out = cuda_match.hamming_best2_kernel(*args, **gates)
        ref = cuda_match.hamming_best2_plain(*args, **gates)
        torch.cuda.synchronize()
        err = 0
        for name, a, b in zip(("best", "second", "best_j"), out, ref):
            err = max(err, int((a.long() - b.long()).abs().max()))
            require(torch.equal(a, b), f"K2: {name} differs from plain")
        return err, out

    def k2_bound(args, gates):
        # Bytes: the validity masks read and three int32 per row written
        # for every row and column; the descriptors and the gate data read
        # only for the valid ones (a masked row's or column's descriptor
        # and gate data do not change the output). Operations: the gate (5
        # f32 flops) on every pair of a valid row and a valid column, and
        # the distance on every pair that passes the gate (all valid pairs
        # without one), counted as a +-1 int8 dot product (512 operations):
        # the kernel's 1-bit AND-popc products have no published H100 rate.
        qa, qb, qva, qvb = args
        na, nb = qa.shape[0], qb.shape[0]
        va, vb = int(qva.sum()), int(qvb.sum())
        n_valid_pairs = va * vb
        if "xy_a" in gates:
            lo, hi = gates["level_window"]
            gate = (matching.window_mask(gates["xy_a"], gates["xy_b"],
                                         gates["radius"])
                    & matching.level_mask(gates["level_a"], gates["level_b"],
                                          lo, hi))
            n_gated = int((gate & qva[:, None] & qvb[None, :]).sum())
            ms, by = bound(na * 13 + va * (32 + 8 + 4 + 4)
                           + nb * 1 + vb * (32 + 8 + 4),
                           {F32_FLOPS: 5 * n_valid_pairs,
                            INT8_OPS: 2 * 256 * n_gated})
            return ms, by, (
                f"N={na} x 13 B + {va} valid rows x 48 B + M={nb} x 1 B + "
                f"{vb} valid columns x 44 B over {HBM_BPS / 1e12} TB/s; "
                f"gate 5 f32 flops x {n_valid_pairs} valid pairs over "
                f"{F32_FLOPS / 1e12} TFLOP/s + 512 int8 ops x {n_gated} gated "
                f"pairs over {INT8_OPS / 1e12} TOP/s")
        if "lines" in gates:
            # The epipolar gate: (a u + b v + c)^2 / (a^2 + b^2) < th_j,
            # 5 f32 flops a pair (the row's 1 / (a^2 + b^2) once a row).
            ln, xb, th = gates["lines"], gates["xy_b"], gates["line_th"]
            num = ln[:, None, 0] * xb[None, :, 0] + ln[:, None, 1] \
                * xb[None, :, 1] + ln[:, None, 2]
            inv = 1.0 / (ln[:, 0] ** 2 + ln[:, 1] ** 2).clamp_min(1e-12)
            gate = num * num * inv[:, None] < th[None, :]
            n_gated = int((gate & qva[:, None] & qvb[None, :]).sum())
            ms, by = bound(na * 13 + va * (32 + 12)
                           + nb * 1 + vb * (32 + 8 + 4),
                           {F32_FLOPS: 5 * n_valid_pairs,
                            INT8_OPS: 2 * 256 * n_gated})
            return ms, by, (
                f"N={na} x 13 B + {va} valid rows x 44 B + M={nb} x 1 B + "
                f"{vb} valid columns x 44 B over {HBM_BPS / 1e12} TB/s; "
                f"epipolar gate 5 f32 flops x {n_valid_pairs} valid pairs "
                f"over {F32_FLOPS / 1e12} TFLOP/s + 512 int8 ops x {n_gated} "
                f"gated pairs over {INT8_OPS / 1e12} TOP/s")
        ms, by = bound(na * 13 + va * 32 + nb * 1 + vb * 32,
                       {INT8_OPS: 2 * 256 * n_valid_pairs})
        return ms, by, (f"N={na} x 13 B + {va} valid rows x 32 B + M={nb} "
                        f"x 1 B + {vb} valid columns x 32 B over "
                        f"{HBM_BPS / 1e12} TB/s; 512 int8 ops x "
                        f"{n_valid_pairs} valid pairs over "
                        f"{INT8_OPS / 1e12} TOP/s")

    # K3's and K3s's oracle is their plain version run in float64 on the
    # same inputs: on the stereo world's ill-conditioned problems the
    # float32 plain version (SVD re-orthonormalisation and a general solve,
    # as the JAX package's XLA path) strays from it further than the
    # kernel does. The oracle runs on the host's CPU, in the ``oracle``
    # pool's worker processes: its 40 LM steps of small operations, each
    # with a 3 x 3 SVD that synchronises, take the card 300-550 ms a
    # problem, and the system phases hold about 850 of them. A warm-up
    # sequence's comparisons (``check_call`` with ``rec``) are settled
    # after the sequence (``settle``): the card goes on meanwhile. While
    # ``plain32_err["on"]`` (the stereo cell's warm-up sequence) the
    # float32 plain version runs too, on the card, and its largest
    # distance from the oracle is kept and printed.
    plain32_err = {"K3": 0.0, "K3s": 0.0, "on": False}
    # The deferred comparisons: (finish, the record it updates).
    pending = []
    # Checks whose CPU side runs in the pool throughout the script, held
    # just before the last settle.
    late = []

    def to_cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def plain_pair(name, p, kwargs):
        """A function giving the float64 plain result of one problem on
        the card's device (solved in the pool from now on); it keeps the
        float32 plain result's distance from it while plain32 is on."""
        fut = oracle.submit(oracle_solve, name, tuple(to_cpu(a) for a in p),
                            {k: to_cpu(v) for k, v in kwargs.items()})
        on = plain32_err["on"]

        def result():
            R6, t6, c6 = (x.to(dev) for x in fut.result())
            if on:
                plain = (cuda_pose_opt.pose_optimization_plain if name == "K3"
                         else cuda_pose_opt.pose_optimization_stereo_plain)
                R3, t3, _ = plain(*p, **kwargs)
                plain32_err[name] = max(
                    plain32_err[name], float((R3.double() - R6).abs().max()),
                    float((t3.double() - t6).abs().max()))
            return R6, t6, c6

        return result

    def settle():
        """Finish the deferred oracle comparisons (each raises as its
        synchronous form would) and fold their errors into their records."""
        while pending:
            finish, rec = pending.pop(0)
            rec["max_abs_err"] = max(rec["max_abs_err"], float(finish()))

    def k3_check(args, rec=None, kwargs=None):
        """Kernel against plain at float64 (per problem of a batch) within
        1e-4 and inliers within 2; a batch's rows bit-equal to their single
        runs. ``kwargs``: the call's (``model_id`` KB8 for the fisheye
        camera). With ``rec`` the comparison with the oracle is deferred
        (see ``settle``) and the error returned is 0.0 until then."""
        kwargs = dict(kwargs or {})
        Rk, tk, ck = cuda_pose_opt.pose_optimization_kernel(*args, **kwargs)
        batched = args[0].dim() == 3
        probs = ([tuple(a[i] for a in args[:6]) + (args[6],)
                  for i in range(args[0].shape[0])] if batched else [args])
        inl, solved = [], []
        for i, p in enumerate(probs):
            Rs, ts, cs = ((Rk[i], tk[i], ck[i]) if batched else (Rk, tk, ck))
            if batched:
                R1, t1, c1 = cuda_pose_opt.pose_optimization_kernel(
                    *(a.contiguous() for a in p), **kwargs)
                torch.cuda.synchronize()
                require(torch.equal(R1, Rs) and torch.equal(t1, ts)
                        and torch.equal(c1, cs),
                        f"K3 batch row {i} differs from its single run")
            solved.append((plain_pair("K3", p, kwargs), Rs, ts, cs, p[5]))
            inl.append(int(((cs <= cuda_pose_opt.CHI2_MONO) & p[5]).sum()))

        def finish():
            err = 0.0
            for result, Rs, ts, cs, valid in solved:
                Rp, tp, cp = result()
                err = max(err, float((Rs.double() - Rp).abs().max()),
                          float((ts.double() - tp).abs().max()))
                n_k = int(((cs <= cuda_pose_opt.CHI2_MONO) & valid).sum())
                n_p = int(((cp <= cuda_pose_opt.CHI2_MONO) & valid).sum())
                require(abs(n_k - n_p) <= 2,
                        f"K3 inliers {n_k} vs plain {n_p}")
            require(err <= 1e-4, f"K3 pose differs from plain by {err}")
            return err

        if rec is not None and not plain32_err["on"]:
            pending.append((finish, rec))
            return 0.0, inl
        return finish(), inl

    def k3_bound(args, inliers, kb8=False):
        # Per problem: 25 B per point in (xyz, uv, 1/sigma^2, valid) and 4 B
        # out, the poses and camera. Operations: 45 passes (the first of
        # round 0, one per LM iteration, the three re-markings fused with
        # the next round's first pass, the final chi2). Round 0's 11 passes
        # cover every valid point; the 34 later ones are counted over the
        # final inliers, the mask the later rounds converge to. A pass costs
        # 31 flops per point for the residual and chi2, plus 159 for the
        # Jacobian, the 21 H and 6 g terms and the cost where the point is
        # in the mask. The KB8 camera adds KB8_RESIDUAL_FLOPS to each
        # residual and KB8_JACOBIAN_FLOPS to each Jacobian.
        valid = args[5].reshape(-1, args[5].shape[-1])
        npt = valid.shape[1]
        res = 31 + (KB8_RESIDUAL_FLOPS if kb8 else 0)
        full = 190 + (KB8_RESIDUAL_FLOPS + KB8_JACOBIAN_FLOPS if kb8 else 0)
        flops, nbytes = 0, 0
        for v, n_in in zip(valid, inliers):
            n_valid = int(v.sum())
            flops += (11 * n_valid + 34 * n_in) * full + 4 * n_valid * res
            nbytes += npt * (25 + 4) + 2 * 48 + 16 + (16 if kb8 else 0)
        ms, by = bound(nbytes, {F32_FLOPS: flops})
        return ms, by, (f"B={valid.shape[0]} x N={npt} x 29 B over "
                        f"{HBM_BPS / 1e12} TB/s; {flops} f32 flops (45 passes "
                        f"over the valid points and final inliers, {full} a "
                        f"point in the mask{', KB8' if kb8 else ''}) over "
                        f"{F32_FLOPS / 1e12} TFLOP/s")

    def k3s_check(args, kwargs, rec=None):
        """K3s against its plain version at float64 (per problem of a batch)
        within 1e-4, inliers (per-row gates 5.991 / 7.815) within 2; a
        batch's rows bit-equal to their single runs. Returns (error,
        inliers, stereo inliers) per problem; with ``rec`` the comparison
        with the oracle is deferred as in ``k3_check``."""
        Rk, tk, ck = cuda_pose_opt.pose_optimization_stereo_kernel(*args,
                                                                   **kwargs)
        result = plain_pair("K3s", args, kwargs)
        ur, valid = args[4], args[7]
        gate = torch.where(ur >= 0, cuda_pose_opt.CHI2_STEREO,
                           cuda_pose_opt.CHI2_MONO)
        in_k = ((ck <= gate) & valid).reshape(-1, valid.shape[-1])

        def finish():
            Rp, tp, cp = result()
            err = max(float((Rk.double() - Rp).abs().max()),
                      float((tk.double() - tp).abs().max()))
            in_p = ((cp <= gate) & valid).reshape(-1, valid.shape[-1])
            for a, b in zip(in_k.sum(-1).tolist(), in_p.sum(-1).tolist()):
                require(abs(a - b) <= 2, f"K3s inliers {a} vs plain {b}")
            require(err <= 1e-4, f"K3s pose differs from plain by {err}")
            return err

        if args[0].dim() == 3:
            for i in range(args[0].shape[0]):
                one = ([a[i].contiguous() for a in args[:5]] + [args[5]]
                       + [a[i].contiguous() for a in args[6:8]] + [args[8]])
                R1, t1, c1 = cuda_pose_opt.pose_optimization_stereo_kernel(
                    *one, **kwargs)
                require(torch.equal(R1, Rk[i]) and torch.equal(t1, tk[i])
                        and torch.equal(c1, ck[i]),
                        f"K3s batch row {i} differs from its single run")
        stereo = (in_k & (ur >= 0).reshape(in_k.shape)).sum(-1).tolist()
        if rec is not None and not plain32_err["on"]:
            pending.append((finish, rec))
            return 0.0, in_k.sum(-1).tolist(), stereo
        return finish(), in_k.sum(-1).tolist(), stereo

    def k3s_bound(args, inliers, stereo_inliers, kb8=False):
        # Per problem: 29 B per point in (xyz, uv, u_r, 1/sigma^2, valid)
        # and 4 B out. Operations as K3's, 45 passes (11 over the valid
        # points, 34 over the final inliers), per point and pass: a mono row
        # 31 flops of residual and chi2 and 159 more in the mask (190); a
        # stereo row 36 and 219 (255): the third residual, its Jacobian row
        # (e = bf / z^2), and its terms in the 21 H and 6 g sums. KB8 adds
        # its projection's and Jacobian's flops to every row as in K3.
        ur = args[4].reshape(-1, args[4].shape[-1])
        valid = args[7].reshape(ur.shape)
        npt = ur.shape[1]
        xr = KB8_RESIDUAL_FLOPS if kb8 else 0
        xf = KB8_RESIDUAL_FLOPS + KB8_JACOBIAN_FLOPS if kb8 else 0
        flops, nbytes = 0, 0
        for u, v, n_in, n_in_s in zip(ur, valid, inliers, stereo_inliers):
            vs = int((v & (u >= 0)).sum())
            vm = int(v.sum()) - vs
            n_in_m = n_in - n_in_s
            flops += ((11 * vm + 34 * n_in_m) * (190 + xf)
                      + 4 * vm * (31 + xr)
                      + (11 * vs + 34 * n_in_s) * (255 + xf)
                      + 4 * vs * (36 + xr))
            nbytes += npt * (29 + 4) + 2 * 48 + 16 + (16 if kb8 else 0)
        ms, by = bound(nbytes, {F32_FLOPS: flops})
        return ms, by, (f"B={ur.shape[0]} x N={npt} x 33 B over "
                        f"{HBM_BPS / 1e12} TB/s; {flops} f32 flops (45 passes "
                        f"over the valid points and final inliers, 3 rows on "
                        f"the stereo ones) over {F32_FLOPS / 1e12} TFLOP/s")

    wrappers = {"K1": cuda_brief.brief_descriptors_kernel,
                "K2": cuda_match.hamming_best2_kernel,
                "K3": cuda_pose_opt.pose_optimization_kernel,
                "K3s": cuda_pose_opt.pose_optimization_stereo_kernel}
    plains = {"K1": cuda_brief.brief_descriptors_plain,
              "K2": cuda_match.hamming_best2_plain,
              "K3": cuda_pose_opt.pose_optimization_plain,
              "K3s": cuda_pose_opt.pose_optimization_stereo_plain}

    def timed(name, args, kwargs, plain_reps=N_TIMED_LAUNCHES):
        """Launch alone, wrapper and plain times of one call's inputs."""
        wrap = wrappers[name]
        out, again = captured_launch(cuda_pose_opt.KERNEL if name == "K3s"
                                     else kernels[name],
                                     lambda: wrap(*args, **kwargs))
        t = {"ms": event_ms(again, primed=True),
             "wrapper_ms": event_ms(lambda: wrap(*args, **kwargs))}
        warm = K3_PLAIN_WARMUP if plain_reps == K3_PLAIN_REPS else 3
        if name == "K3" and args[0].dim() == 3:     # plain: one problem each
            probs = [tuple(a[i] for a in args[:6]) + (args[6],)
                     for i in range(args[0].shape[0])]
            t["plain_ms"] = event_ms(
                lambda: [plains[name](*p, **kwargs) for p in probs],
                reps=plain_reps, warmup=warm)
        else:
            t["plain_ms"] = event_ms(lambda: plains[name](*args, **kwargs),
                                     reps=plain_reps, warmup=warm)
        del out
        return t

    def shape_of(name, args, kwargs):
        if name == "K1":
            return {"levels": [tuple(b.shape) for b in args[0]],
                    "K": args[1].shape[0]}
        if name == "K2":
            mode = ("window" if "xy_a" in kwargs
                    else "epipolar" if "lines" in kwargs else "none")
            return {"N": args[0].shape[0], "M": args[1].shape[0],
                    "mode": mode, "level_window": kwargs.get("level_window"),
                    "valid_rows": int(args[2].sum())}
        out = {"B": args[0].shape[0] if args[0].dim() == 3 else 1,
               "N": args[2].shape[-2]}
        if name == "K3s":
            out["stereo_rows"] = int(((args[4] >= 0) & args[7]).sum())
        if kwargs.get("model_id") == KB8:
            out["camera"] = "KB8"
        return out

    def check_call(name, args, kwargs, rec=None):
        """Hold one recorded call against the plain version; return its
        error and bound. With ``rec`` (a record with ``max_abs_err``) K3's
        and K3s's comparison with the oracle is settled later (``settle``)
        and the error returned is 0.0."""
        if name == "K1":
            err = k1_check(args)
            b = k1_bound(args)
        elif name == "K2":
            err, _ = k2_check(args, kwargs)
            b = k2_bound(args, kwargs)
        elif name == "K3s":
            err, inl, inl_s = k3s_check(args, kwargs, rec)
            b = k3s_bound(args, inl, inl_s, kwargs.get("model_id") == KB8)
        else:
            err, inl = k3_check(args, rec, kwargs)
            b = k3_bound(args, inl, kwargs.get("model_id") == KB8)
        return err, b

    # The phases outside this function settle their warm-ups' deferred
    # comparisons through the ``check_call`` they are handed.
    check_call.settle = settle

    rng = np.random.default_rng(0)
    arrays = graft.example_arrays()
    h, w = arrays[0].shape
    img = torch.from_numpy(arrays[0]).to(dev)
    results = {}

    # -- 2: K1 vs plain: keypoints over the 8 levels of a 480x640 frame ----
    pyr = fast_orb.build_pyramid(img, 8, 1.2)
    budget = fast_orb.level_feature_budget(graft.N_FEATURES, 8, 1.2)
    shapes = [tuple(p.shape) for p in pyr]
    blurred = [fast_orb.gaussian_blur(p) for p in pyr]
    xy, lvl = [], []
    for i, ((lh, lw), cap) in enumerate(zip(shapes, budget)):
        # Most keypoints inside the 19 px border, some at the image edge.
        inner = np.stack([rng.integers(19, lw - 19, cap),
                          rng.integers(19, lh - 19, cap)], -1)
        edge = np.stack([rng.integers(0, lw, cap), rng.integers(0, lh, cap)], -1)
        pick = rng.random(cap) < 0.1
        xy.append(np.where(pick[:, None], edge, inner).astype(np.float32))
        lvl.append(np.full(cap, i, np.int32))
    xy = torch.from_numpy(np.concatenate(xy)).to(dev)
    kp_level = torch.from_numpy(np.concatenate(lvl)).to(dev)
    angle = torch.from_numpy(
        rng.uniform(-np.pi, np.pi, xy.shape[0]).astype(np.float32)).to(dev)
    k1_args = (blurred, xy, kp_level, angle)
    results["K1"] = {"max_abs_err": k1_check(k1_args)}
    (results["K1"]["bound_ms"], results["K1"]["bound_by"],
     results["K1"]["bound"]) = k1_bound(k1_args)
    results["K1"].update(timed("K1", k1_args, {}))
    phase("2 K1", f"480x640, K={xy.shape[0]} over {len(shapes)} levels: "
          f"bit-identical descriptors; launch alone "
          f"{results['K1']['ms']:.4f} ms, wrapper "
          f"{results['K1']['wrapper_ms']:.4f} ms, plain "
          f"{results['K1']['plain_ms']:.4f} ms, bound "
          f"{results['K1']['bound_ms']:.5f} ms ({card})")
    # The kernel's sincosf against torch.cos / torch.sin.
    ang = torch.linspace(-np.pi, np.pi, N_ANGLES, device=dev)
    s_k, c_k = cuda_brief.sincos_on_card(ang)
    torch.cuda.synchronize()
    n_diff = int((s_k != torch.sin(ang)).sum() + (c_k != torch.cos(ang)).sum())
    require(n_diff == 0, f"sincosf differs from torch.sin/cos at {n_diff} "
            f"of {2 * N_ANGLES} values")
    phase("2 K1", f"sincosf bit-equal to torch.sin / torch.cos over "
          f"{N_ANGLES} angles in [-pi, pi]")
    # The EuRoC-mono frame's size, ragged keypoint counts included.
    rng1 = np.random.default_rng(1)
    eu = graft.EUROC_MONO
    img_eu = torch.from_numpy(graft.example_image(eu.height, eu.width)).to(dev)
    blurred_eu = [fast_orb.gaussian_blur(p)
                  for p in fast_orb.build_pyramid(img_eu, 8, 1.2)]
    for k in (1, 31, eu.n_features, eu.n_features + 1):
        lv = rng1.integers(0, 8, k).astype(np.int32)
        kxy = np.stack([rng1.integers(0, eu.width, k),
                        rng1.integers(0, eu.height, k)], -1)
        kxy = np.floor(kxy / 1.2 ** lv[:, None]).astype(np.float32)
        k1_check((blurred_eu, torch.from_numpy(kxy).to(dev),
                  torch.from_numpy(lv).to(dev),
                  torch.from_numpy(rng1.uniform(-np.pi, np.pi, k).astype(
                      np.float32)).to(dev)))
    phase("2 K1", f"{eu.height}x{eu.width}: bit-identical at K = 1, 31, "
          f"{eu.n_features}, {eu.n_features + 1}")

    # The lifted scene from the card's own features: it feeds K2, K3 and
    # the slice.
    feats = fast_orb.extract(img, n_features=graft.N_FEATURES)
    scene_np = graft.lifted_scene(
        convert.to_numpy(feats.xy), convert.to_numpy(feats.level),
        convert.to_numpy(feats.desc), convert.to_numpy(feats.valid))
    scene = convert.tree_to_torch(scene_np, dev)
    (_, R0, t0_, lm_pos, lm_desc, lm_normal, lm_min_d, lm_max_d, lm_valid,
     cam) = scene

    # -- 3: K2 vs plain -----------------------------------------------------
    visible, proj, _, plevel = matching.frustum_cull(
        R0, t0_, lm_pos, lm_normal, lm_min_d, lm_max_d, cam, float(w),
        float(h))
    window = dict(xy_a=proj, xy_b=feats.xy,
                  radius=4.0 * tracking.SCALE ** plevel.float(),
                  level_a=plevel, level_b=feats.level, level_window=(-1, 1))
    k2_cases = {"window": (lm_desc, feats.desc, visible & lm_valid,
                           feats.valid, window)}
    # none / epipolar at 1024 x 1024 with duplicate descriptors (ties).
    n = 1024
    da = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, 8),
                                       dtype=np.int64).astype(np.int32))
    db = da[torch.from_numpy(rng.permutation(n))].clone()
    db[1::2] = db[0::2]                       # every column has a twin
    da, db = da.to(dev), db.to(dev)
    va = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    vb = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    lines = torch.from_numpy(rng.normal(0, 1, (n, 3)).astype(np.float32)).to(dev)
    lines[:, 2] *= 300.0
    kxy = torch.from_numpy(rng.uniform(0, 640, (n, 2)).astype(np.float32)).to(dev)
    th = torch.from_numpy(rng.uniform(50, 5000, n).astype(np.float32)).to(dev)
    k2_cases["none"] = (da, db, va, vb, {})
    k2_cases["epipolar"] = (da, db, va, vb, dict(xy_b=kxy, lines=lines,
                                                 line_th=th))
    # The frame step's shapes: 1200 x 1200 without a gate, duplicates; the
    # motion model's two tries stacked, 2400 x 1200, radius 15 then 30,
    # level window +-8.
    m = eu.n_features
    db2 = torch.from_numpy(rng1.integers(-2 ** 31, 2 ** 31, (m, 8),
                                         dtype=np.int64).astype(np.int32))
    db2[1::2] = db2[0::2]
    da2 = db2[torch.from_numpy(rng1.integers(0, m, m))].clone()
    da2[::3] ^= 5
    db2, da2 = db2.to(dev), da2.to(dev)
    va2 = torch.from_numpy(rng1.random(m) > 0.05).to(dev)
    vb2 = torch.from_numpy(rng1.random(m) > 0.05).to(dev)
    k2_cases["none 1200"] = (da2, db2, va2, vb2, {})
    xb = torch.from_numpy(np.stack([rng1.uniform(0, eu.width, m),
                                    rng1.uniform(0, eu.height, m)],
                                   -1).astype(np.float32)).to(dev)
    xa = xb[torch.from_numpy(rng1.integers(0, m, m)).to(dev)] + torch.from_numpy(
        rng1.normal(0, 12, (m, 2)).astype(np.float32)).to(dev)
    stacked = dict(
        xy_a=torch.cat([xa, xa + 20.0]), xy_b=xb,
        radius=torch.cat([torch.full((m,), 15.0, device=dev),
                          torch.full((m,), 30.0, device=dev)]),
        level_a=torch.zeros(2 * m, dtype=torch.int32, device=dev),
        level_b=torch.from_numpy(rng1.integers(0, 8, m).astype(
            np.int32)).to(dev), level_window=(-8, 8))
    k2_cases["stacked window"] = (da2.repeat(2, 1), db2, va2.repeat(2), vb2,
                                  stacked)
    k2_err = 0
    for mode, (qa, qb, qva, qvb, gates) in k2_cases.items():
        err, out_k = k2_check((qa, qb, qva, qvb), gates)
        k2_err = max(k2_err, err)
        matched = int((out_k[0] < matching.INVALID_DIST).sum())
        ties = int((out_k[0] == out_k[1]).sum())
        phase("3 K2", f"{mode}: {qa.shape[0]}x{qb.shape[0]} identical "
              f"(rows with a candidate {matched}, best==second {ties})")
    qa, qb, qva, qvb, gates = k2_cases["stacked window"]
    _, out_k = k2_check((qa, qb, qva, qvb), gates)
    for half in range(2):
        rows = slice(m * half, m * (half + 1))
        one = dict(gates, xy_a=gates["xy_a"][rows].contiguous(),
                   radius=gates["radius"][rows].contiguous(),
                   level_a=gates["level_a"][rows].contiguous())
        alone = cuda_match.hamming_best2_kernel(
            qa[rows].contiguous(), qb, qva[rows].contiguous(), qvb, **one)
        torch.cuda.synchronize()
        require(all(torch.equal(a[rows], b) for a, b in zip(out_k, alone)),
                f"K2 stacked: half {half} differs from its own launch")
    phase("3 K2", "stacked window: each half equals its own launch")
    qa, qb, qva, qvb, gates = k2_cases["window"]
    results["K2"] = {"max_abs_err": k2_err}
    (results["K2"]["bound_ms"], results["K2"]["bound_by"],
     results["K2"]["bound"]) = k2_bound((qa, qb, qva, qvb), gates)
    results["K2"].update(timed("K2", (qa, qb, qva, qvb), gates))
    phase("3 K2", f"window {qa.shape[0]}x{qb.shape[0]}: launch alone "
          f"{results['K2']['ms']:.4f} ms, wrapper "
          f"{results['K2']['wrapper_ms']:.4f} ms, plain "
          f"{results['K2']['plain_ms']:.4f} ms, bound "
          f"{results['K2']['bound_ms']:.5f} ms ({card})")

    # -- 4: K3 vs plain on the lifted scene's points ------------------------
    npt = graft.N_FEATURES
    pts = lm_pos[:npt]
    obs_np = convert.to_numpy(feats.xy).astype(np.float64)
    obs_np += rng.normal(0, 0.5, obs_np.shape)
    out_idx = rng.choice(npt, 60, replace=False)
    obs_np[out_idx] += rng.uniform(20, 80, (60, 2))
    obs = torch.from_numpy(obs_np.astype(np.float32)).to(dev)
    inv_s2 = tracking.INV_SIGMA2.to(dev)[feats.level.long()]
    valid_np = np.ones(npt, bool)
    valid_np[rng.choice(npt, 30, replace=False)] = False
    pvalid = torch.from_numpy(valid_np).to(dev) & feats.valid
    k3_args = (R0, t0_, pts, obs, inv_s2, pvalid, cam)
    k3_err, (n_k,) = k3_check(k3_args)
    results["K3"] = {"max_abs_err": k3_err}
    (results["K3"]["bound_ms"], results["K3"]["bound_by"],
     results["K3"]["bound"]) = k3_bound(k3_args, [n_k])
    results["K3"].update(timed("K3", k3_args, {}, plain_reps=10))
    phase("4 K3", f"N={npt}: max |dR|,|dt| {k3_err:.2e}; inliers {n_k}; "
          f"launch alone {results['K3']['ms']:.4f} ms, wrapper "
          f"{results['K3']['wrapper_ms']:.4f} ms, plain "
          f"{results['K3']['plain_ms']:.4f} ms, bound "
          f"{results['K3']['bound_ms']:.5f} ms ({card})")

    # -- 5: the tracking step through the kernels ---------------------------
    for k in kernels.values():
        k.launches = 0
    R, t, n_inl = graft.tracking_step(*scene)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    eye = torch.eye(3, device=dev)
    r_err, t_err = float((R - eye).abs().max()), float(t.abs().max())
    n_gpu = int(n_inl)
    require(all(v == 1 for v in launches.values()),
            f"each kernel must launch once in the slice: {launches}")
    require(bool(torch.isfinite(R).all() and torch.isfinite(t).all()),
            "non-finite pose")
    require(n_gpu >= 900, f"n_inliers {n_gpu} < 900")
    require(r_err <= 1e-3 and t_err <= 1e-3,
            f"pose error R {r_err} t {t_err} > 1e-3")
    cpu_scene = tuple(a.cpu() for a in scene)
    _, _, n_cpu = graft.tracking_step(*cpu_scene)
    n_cpu = int(n_cpu)
    require(abs(n_cpu - n_gpu) <= 0.01 * n_gpu,
            f"CPU n_inliers {n_cpu} vs card {n_gpu} differ by more than 1%")
    phase("5 slice", f"tracking_step 480x640, {graft.N_FEATURES} features, "
          f"{lm_pos.shape[0]} landmarks: n_inliers {n_gpu} (CPU plain "
          f"versions {n_cpu}); |R-I| {r_err:.2e} |t| {t_err:.2e}; "
          f"launches {launches}")

    # -- 6: the EuRoC-mono frame step through the kernels -------------------
    cam_eu = torch.tensor([eu.fx, eu.fy, eu.cx, eu.cy], dtype=torch.float32,
                          device=dev)
    dist_eu = torch.tensor(eu.dist, dtype=torch.float32, device=dev)
    f_eu = graft.mono_extract(img_eu, cam_eu, dist_eu)
    n_valid = int(f_eu.valid.sum())
    feats_np = tuple(convert.to_numpy(a) for a in (
        f_eu.xy, f_eu.level, f_eu.desc, f_eu.angle, f_eu.valid))
    mono = {}
    frame_calls = {"K1": [], "K2": [], "K3": []}
    launches_fs = launches_fb = None
    for case in ("normal", "retry"):
        args = graft.MonoFrameArgs(*convert.tree_to_torch(
            graft.euroc_mono_scene(*feats_np, case=case), dev))
        for k in kernels.values():
            k.launches = 0
        with recorded(cuda_brief, "brief_descriptors_kernel") as c1, \
                recorded(cuda_match, "hamming_best2_kernel") as c2, \
                recorded(cuda_pose_opt, "pose_optimization_kernel") as c3:
            res, info, n_found, _ = graft.mono_frame_step(*args)
            torch.cuda.synchronize()
        got = {n: k.launches for n, k in kernels.items()}
        require(got == {"K1": 1, "K2": 2, "K3": 2},
                f"frame step ({case}) launches {got}, expected K1 1, K2 2, "
                f"K3 2")
        if case == "normal":
            launches_fs = got
            for name, calls in (("K1", c1), ("K2", c2), ("K3", c3)):
                frame_calls[name] += [(case, a, kw) for a, kw in calls]
        info_np = convert.to_numpy(info)
        n_gpu = int(info_np[0])
        r_err = float((res.R - eye).abs().max())
        t_err = float(res.t.abs().max())
        require(bool(torch.isfinite(info).all()), "non-finite frame step info")
        require(n_gpu >= 0.9 * n_valid,
                f"frame step ({case}): {n_gpu} inliers of {n_valid} valid")
        require(r_err <= 1e-3 and t_err <= 1e-3,
                f"frame step ({case}) pose error R {r_err} t {t_err}")
        require(int((n_found - args.n_found).sum())
                == int((res.bindings >= 0).sum()),
                "found counters do not follow the bindings")
        # Which branch: the motion model's own inliers from the predicted
        # pose (frame_step takes the retry below 10).
        first = tracking.track_motion_model(
            args.R_pred, args.t_pred, args.lm_pos, args.lm_valid,
            args.last_bind, args.last_desc, f_eu.xy, f_eu.level, f_eu.desc,
            f_eu.valid, args.cam_params, last_angle=args.last_angle,
            feats_angle=f_eu.angle)
        n_first = int(first.n_inliers)
        took_retry = n_first < tracking.RETRY_BELOW
        require(took_retry == (case == "retry"),
                f"frame step ({case}): the motion model keeps {n_first} "
                f"inliers, so the {'retry' if took_retry else 'first try'} "
                f"was taken")
        # The same inputs through the plain versions on the CPU.
        _, info_cpu, _, _ = graft.mono_frame_step(*(a.cpu() for a in args))
        n_cpu = int(info_cpu[0])
        require(abs(n_cpu - n_gpu) <= 0.01 * n_gpu,
                f"frame step ({case}): CPU {n_cpu} vs card {n_gpu} inliers")
        # No host read inside frame_step: torch raises on any operation
        # that synchronises the stream.
        def step():
            return tracking.frame_step(
                args.R_pred, args.t_pred, args.R_last, args.t_last,
                args.lm_pos, args.lm_desc, args.lm_normal, args.lm_min_d,
                args.lm_max_d, args.lm_valid, args.last_bind, args.last_desc,
                args.last_angle, f_eu.xy, f_eu.level, f_eu.desc, f_eu.valid,
                f_eu.angle, torch.full((eu.n_features,), -1.0, device=dev),
                torch.zeros((), device=dev), torch.zeros((), device=dev),
                args.obs_kf, args.obs_valid, args.ref_kf, eu.kf_ref_min_obs,
                args.n_kf, args.n_found, args.n_visible, args.cam_params,
                eu.width, eu.height, max_kf=eu.max_kf)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, info_ns, _, _ = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(abs(int(info_ns[0]) - n_gpu) <= 0.01 * n_gpu,
                f"frame_step on the extracted features: {int(info_ns[0])} "
                f"inliers against {n_gpu}")
        mono[case] = {"n_inliers": n_gpu, "n_valid": n_valid,
                      "n_inliers_cpu": n_cpu, "first_try_inliers": n_first,
                      "R_err": r_err, "t_err": t_err}
        phase("6 frame step", f"{case}: mono_frame_step {eu.height}x"
              f"{eu.width}, {eu.n_features} features, {eu.max_lm} landmark "
              f"slots: n_inliers {n_gpu} of {n_valid} valid (CPU plain "
              f"versions {n_cpu}); motion model from the predicted pose "
              f"{n_first} -> {'retry' if took_retry else 'first try'}; "
              f"|R-I| {r_err:.2e} |t| {t_err:.2e}; launches {got}; no "
              f"synchronisation inside frame_step")
        if case == "retry":
            # The reference-keyframe fallback, forced on the retry scene.
            for k in kernels.values():
                k.launches = 0
            with recorded(cuda_match, "hamming_best2_kernel") as c2, \
                    recorded(cuda_pose_opt, "pose_optimization_kernel") as c3:
                fb = graft.mono_reference_fallback(f_eu, args)
                torch.cuda.synchronize()
            launches_fb = {n: k.launches for n, k in kernels.items()}
            require(launches_fb == {"K1": 0, "K2": 2, "K3": 2},
                    f"fallback launches {launches_fb}")
            frame_calls["K2"] += [("fallback", a, kw) for a, kw in c2]
            frame_calls["K3"] += [("fallback", a, kw) for a, kw in c3]
            n_fb = int(fb.n_inliers)
            fr = float((fb.R - eye).abs().max())
            ft = float(fb.t.abs().max())
            require(n_fb >= 0.9 * n_valid and fr <= 1e-3 and ft <= 1e-3,
                    f"fallback: {n_fb} inliers, R {fr} t {ft}")
            mono["fallback"] = {"n_inliers": n_fb, "R_err": fr, "t_err": ft}
            phase("6 frame step", f"reference-KF fallback on the retry "
                  f"scene: n_inliers {n_fb}; |R-I| {fr:.2e} |t| {ft:.2e}; "
                  f"launches {launches_fb}")

    # Each kernel on the inputs the frame step gave it.
    fs_calls = {n: [] for n in kernels}
    for name, calls in frame_calls.items():
        for where, args, kwargs in calls:
            err, (b_ms, b_by, b_txt) = check_call(name, args, kwargs)
            entry = {"call": where, "shape": shape_of(name, args, kwargs),
                     "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                     "bound": b_txt}
            entry.update(timed(name, args, kwargs,
                               plain_reps=plain_reps_of(name)))
            fs_calls[name].append(entry)
            phase("6 frame step", f"{name} {where} {entry['shape']}: "
                  f"identical to plain (max err {err:.2e}); launch alone "
                  f"{entry['ms']:.4f} ms, wrapper {entry['wrapper_ms']:.4f} "
                  f"ms, plain {entry['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.5f} ms by {b_by} ({card})")

    # -- 7: times --------------------------------------------------------------
    gen = torch.Generator(dev).manual_seed(0)

    def step_times(step, frames):
        for i in range(N_WARMUP_STEPS):
            step(frames[i % N_TIMED_FRAMES])
        out = []
        for frame in frames:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            step(frame)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t_start) * 1e3)
        # p80: the highest percentile with ten samples beyond it at 50.
        return statistics.median(out), statistics.quantiles(out, n=5)[-1], out

    frames = [img + 0.5 * torch.randn(img.shape, device=dev, generator=gen)
              for _ in range(N_TIMED_FRAMES)]
    step_med, step_p80, step_ms = step_times(
        lambda fr: graft.tracking_step(fr, *scene[1:]), frames)
    phase("7 times", f"tracking_step median {step_med:.3f} ms, p80 "
          f"{step_p80:.3f} ms over {N_TIMED_FRAMES} frames (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
          f"{1e3 / step_med:.1f} fps, after {N_WARMUP_STEPS} warm-up steps "
          f"({card})")
    args = graft.MonoFrameArgs(*convert.tree_to_torch(
        graft.euroc_mono_scene(*feats_np, case="normal"), dev))
    frames_eu = [img_eu + 0.5 * torch.randn(img_eu.shape, device=dev,
                                            generator=gen)
                 for _ in range(N_TIMED_FRAMES)]

    def mono_step(frame):
        _, info, _, _ = graft.mono_frame_step(frame, *args[1:])
        return info.cpu()          # the caller's one read of the frame

    mono_med, mono_p80, mono_ms = step_times(mono_step, frames_eu)
    phase("7 times", f"mono_frame_step (EuRoC mono, normal case) median "
          f"{mono_med:.3f} ms, p80 {mono_p80:.3f} ms over {N_TIMED_FRAMES} "
          f"frames (min {min(mono_ms):.3f}, max {max(mono_ms):.3f}) = "
          f"{1e3 / mono_med:.1f} fps, after {N_WARMUP_STEPS} warm-up steps, "
          f"the read of info included ({card})")
    for n, r in results.items():
        phase("7 times", f"{n}: launch alone {r['ms']:.4f} ms, wrapper "
              f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({card})")

    # -- 8: the EuRoC-mono keyframe step through the kernels ----------------
    from orbslam3_byzyh_tpu_torch.models import map_state
    from orbslam3_byzyh_tpu_torch.ops import camera as cam_mod
    from orbslam3_byzyh_tpu_torch.pipeline import mapping
    from orbslam3_byzyh_tpu_torch.solver import lm as lm_mod

    cpu = torch.device("cpu")

    def replay_flips(m):
        """Replay the bundle's insert, valve and triangulation on the card
        and on the CPU side by side: (neighbour, row, margin) for each row
        whose decision differs on the same input. Each side goes on with
        its own result."""
        nf, kf = eu.n_features, m.kf_id
        sides = {}
        for d in (dev, cpu):
            a = graft.mono_map_args(m, d)
            st = map_state.add_keyframe(a[0], kf, a[2], a[3], a[4], a[5])
            st = map_state.add_observations(
                st, a[6].clamp_min(0), kf,
                torch.arange(nf, dtype=torch.int32, device=d), a[6] >= 0)
            sides[d.type] = [a[5], st, a[6], a[7]]
        st = sides["cpu"][1]
        counts = map_state.covisibility_counts(st, kf, eu.max_kf)
        counts = torch.where(st.kfs.valid, counts, 0)
        counts[kf] = 0
        cv, ci = matching.top_k_lowest_first(counts,
                                             eu.triangulation_neighbors)
        for side in sides.values():
            side[1] = mapping.landmark_overflow_valve(side[1], nf)
        flips = []
        for nb, c in zip(ci.tolist(), cv.tolist()):
            out = {}
            for name, (f, st, b, cam) in sides.items():
                k, ok_nb = st.kfs, c >= 15
                out[name] = mapping.triangulate_pair(
                    k.R[kf], k.t[kf], f.xy, f.level, f.desc,
                    f.valid & (b < 0) & ok_nb, k.R[nb], k.t[nb], k.kp_xy[nb],
                    k.kp_level[nb], k.kp_desc[nb], k.kp_valid[nb] & ok_nb,
                    cam)
            same = (sides["cuda"][2].cpu() < 0) == (sides["cpu"][2] < 0)
            diff = ((out["cuda"].good.cpu() != out["cpu"].good)
                    & same).nonzero().flatten().numpy()
            if len(diff):
                f, st = sides["cpu"][:2]
                r = out["cpu"]
                kb = r.kp_b.long()
                marg = triangulation_margins(
                    r.pos.numpy(), st.kfs.R[kf].numpy(), st.kfs.t[kf].numpy(),
                    st.kfs.R[nb].numpy(), st.kfs.t[nb].numpy(), f.xy.numpy(),
                    st.kfs.kp_xy[nb][kb].numpy(), f.level.numpy(),
                    st.kfs.kp_level[nb][kb].numpy(), m.cam_params)
                flips += [(nb, int(i), float(marg[i])) for i in diff]
            for name, side in sides.items():
                st, b = side[1], side[2]
                r = out[name]
                slots, ok = mapping._alloc_landmark_slots(st.lms.valid,
                                                          r.good)
                side[1] = map_state.add_landmarks(
                    st, slots, r.pos, r.desc, kf, r.kp_a, nb, r.kp_b, ok,
                    r.normal, r.min_dist, r.max_dist)
                side[2] = map_state.scatter_rows(
                    b, torch.where(ok, r.kp_a, nf), torch.where(ok, slots, -1))
        return flips

    def new_slots(st, kf):
        return set(torch.nonzero((st.lms.first_kf == kf)
                                 & st.lms.valid).flatten().tolist())

    keyframe, ks_calls, launches_ks = {}, {n: [] for n in kernels}, None
    for case in ("normal", "full"):
        m = graft.euroc_mono_map(case=case)
        kargs = graft.mono_map_args(m, dev)
        st0, kf = kargs[0], m.kf_id
        seen = {}

        def on_valve(a, _, out):
            seen["valve"] = int((a[0].lms.valid & ~out.lms.valid).sum())

        def on_fuse(a, _, out):
            seen["fuse_killed"] = int((a[0].lms.valid & ~out.lms.valid).sum())
            had = ((a[0].obs.kf == kf) & a[0].obs.valid).any(1)
            has = ((out.obs.kf == kf) & out.obs.valid).any(1)
            seen["fuse_new_obs"] = int((has & ~had).sum())

        def on_ba(a, _, out):
            moved = (out.kfs.R != a[0].kfs.R).flatten(1).any(1)
            obs = a[0].obs
            in_free = obs.valid & (obs.kf >= 0) & moved[obs.kf.clamp_min(0)]
            seen["ba_free"] = int(moved.sum())
            seen["ba_lms"] = int((in_free.any(1) & a[0].lms.valid).sum())

        for k in kernels.values():
            k.launches = 0
        with recorded(cuda_match, "hamming_best2_kernel") as c2, \
                spied(mapping, "landmark_overflow_valve", on_valve), \
                spied(mapping, "fuse_duplicates", on_fuse), \
                spied(mapping, "windowed_local_ba", on_ba):
            st, bind, info, culled = graft.mono_keyframe_step(*kargs)
            torch.cuda.synchronize()
        got = {n: k.launches for n, k in kernels.items()}
        require(got == {"K1": 0, "K2": 4, "K3": 0},
                f"keyframe step ({case}) launches {got}, expected K2 4")
        modes = [("epipolar" if "lines" in kw else "window") for _, kw in c2]
        require(modes == ["epipolar"] * 3 + ["window"]
                and c2[-1][0][0].shape[0] == eu.max_lm,
                f"keyframe step ({case}) K2 calls {modes}")
        if case == "normal":
            launches_ks = got
            for a, kw in c2:
                err, (b_ms, b_by, b_txt) = check_call("K2", a, kw)
                entry = {"call": f"keyframe step {case}",
                         "shape": shape_of("K2", a, kw), "max_abs_err": err,
                         "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
                entry.update(timed("K2", a, kw, plain_reps=20))
                ks_calls["K2"].append(entry)
                phase("8 keyframe step", f"K2 {entry['shape']}: identical to "
                      f"plain; launch alone {entry['ms']:.4f} ms, wrapper "
                      f"{entry['wrapper_ms']:.4f} ms, plain "
                      f"{entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                      f"{b_by} ({card})")
        else:
            for a, kw in c2:
                check_call("K2", a, kw)
            phase("8 keyframe step", f"K2 ({case}): all 4 calls identical to "
                  f"plain")
        # Every planted stage fired.
        new = new_slots(st, kf)
        live0 = set(torch.nonzero(st0.lms.valid).flatten().tolist())
        recycled = len(new & live0)
        culled_ids = torch.nonzero(culled).flatten().tolist()
        err0 = pose_error(m.R, m.t, m.R_true, m.t_true)
        err1 = pose_error(st.kfs.R[kf].cpu(), st.kfs.t[kf].cpu(), m.R_true,
                          m.t_true)
        inv = map_state.check_invariants(st, kf + 1, eu.max_lm)
        require(len(new) >= 300, f"keyframe step ({case}): {len(new)} new "
                f"landmarks < 300")
        require(seen["fuse_killed"] >= 1 and seen["fuse_new_obs"] >= 1,
                f"keyframe step ({case}): fusion {seen}")
        require(culled_ids == [m.cull_kf], f"keyframe step ({case}): culled "
                f"{culled_ids}, planted {m.cull_kf}")
        require((seen["valve"] > 0) == (case == "full")
                and (recycled > 0) == (case == "full"),
                f"keyframe step ({case}): valve retired {seen['valve']}, "
                f"{recycled} slots recycled")
        require(seen["ba_free"] == eu.local_window + 1
                and seen["ba_lms"] > eu.ba_lm_window,
                f"keyframe step ({case}): BA window {seen}")
        require(err1 < err0, f"keyframe step ({case}): pose error {err0} -> "
                f"{err1}")
        require(inv == [], f"keyframe step ({case}): invariants {inv}")
        require(bool(torch.equal(st0.lms.valid.cpu(),
                                 torch.from_numpy(m.state.lms.valid))),
                "the keyframe step wrote into its input map")
        # The CPU plain path on the same numpy inputs.
        st_c, bind_c, info_c, culled_c = graft.mono_keyframe_step(
            *graft.mono_map_args(m, cpu))
        new_c = new_slots(st_c, kf)
        d_bind = int((bind.cpu() != bind_c).sum())
        flips = [] if (new == new_c and d_bind == 0) else replay_flips(m)
        for nb, row, margin in flips:
            phase("8 keyframe step", f"{case}: triangulation against keyframe "
                  f"{nb}, row {row}: card and CPU differ, gate margin "
                  f"{margin:.3e}")
        require(all(mg < FLIP_MARGIN for _, _, mg in flips),
                f"keyframe step ({case}): flips beyond float rounding {flips}")
        n_bound = int((bind_c >= 0).sum())
        require(torch.equal(culled.cpu(), culled_c), "culled differs from CPU")
        require(len(new ^ new_c) <= max(1, 0.01 * len(new_c))
                and d_bind <= max(1, 0.01 * n_bound),
                f"keyframe step ({case}): new slots {len(new)} vs CPU "
                f"{len(new_c)} ({len(new ^ new_c)} differ), bindings differ "
                f"at {d_bind}")
        live = st_c.kfs.valid
        pose_gap = max(float((st.kfs.R.cpu() - st_c.kfs.R)[live].abs().max()),
                       float((st.kfs.t.cpu() - st_c.kfs.t)[live].abs().max()))
        require(pose_gap <= 1e-3, f"keyframe step ({case}): poses differ "
                f"from the CPU by {pose_gap}")
        # The synchronisations with the host inside the step.
        with counted_syncs() as where:
            graft.mono_keyframe_step(*kargs)
        torch.cuda.synchronize()
        keyframe[case] = {
            "new_landmarks": len(new), "new_landmarks_cpu": len(new_c),
            "bindings": int((bind >= 0).sum()), "bindings_in": int(
                (kargs[6] >= 0).sum()), "bindings_differ_cpu": d_bind,
            "fusion_killed": seen["fuse_killed"],
            "fusion_new_observations": seen["fuse_new_obs"],
            "valve_retired": seen["valve"], "slots_recycled": recycled,
            "ba_free_keyframes": seen["ba_free"],
            "ba_landmarks_seen": seen["ba_lms"], "culled": culled_ids,
            "pose_error_before": err0, "pose_error_after": err1,
            "pose_gap_cpu": pose_gap, "flips": flips,
            "live_landmarks_in": int(st0.lms.valid.sum()),
            "live_landmarks_out": int(st.lms.valid.sum()),
            "syncs": len(where), "sync_sites": sorted(set(where))}
        phase("8 keyframe step", f"{case}: mono_keyframe_step, {eu.max_kf} "
              f"keyframe / {eu.max_lm} landmark slots, {kf} live keyframes: "
              f"{len(new)} new landmarks (CPU plain versions {len(new_c)}), "
              f"fusion killed {seen['fuse_killed']} and added "
              f"{seen['fuse_new_obs']} observations, valve retired "
              f"{seen['valve']} ({recycled} slots recycled), BA window "
              f"{seen['ba_free']} free keyframes seeing {seen['ba_lms']} > "
              f"{eu.ba_lm_window} landmarks, culled {culled_ids}; pose error "
              f"{err0:.2e} -> {err1:.2e}; poses within {pose_gap:.2e} of the "
              f"CPU; launches {got}; {len(where)} synchronisations "
              f"{sorted(set(where))}")

    # The timed keyframe step: every call from the same input map.
    m = graft.euroc_mono_map(case="normal")
    kargs = graft.mono_map_args(m, dev)

    def kf_step():
        return graft.mono_keyframe_step(*kargs)[2].cpu()

    for _ in range(N_WARMUP_KEYFRAMES):
        kf_step()
    for k in kernels.values():
        k.launches = 0
    kf_ms = []
    for _ in range(N_TIMED_KEYFRAMES):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        kf_step()
        torch.cuda.synchronize()
        kf_ms.append((time.perf_counter() - t_start) * 1e3)
    per_call = {n: k.launches / N_TIMED_KEYFRAMES for n, k in kernels.items()}
    kf_med = statistics.median(kf_ms)
    kf_p80 = statistics.quantiles(kf_ms, n=5)[-1]
    # All device work of a call, by the profiler over a few calls.
    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            kf_step()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    kf_device_launches = sum(e.count for e in dev_events) / n_prof
    kf_busy_ms = sum(e.self_device_time_total for e in dev_events) / n_prof / 1e3
    phase("8 keyframe step", f"mono_keyframe_step (normal case) median "
          f"{kf_med:.3f} ms, p80 {kf_p80:.3f} ms over {N_TIMED_KEYFRAMES} "
          f"calls (min {min(kf_ms):.3f}, max {max(kf_ms):.3f}), after "
          f"{N_WARMUP_KEYFRAMES} warm-up calls, the read of info included; "
          f"K1-K3 launches per call {per_call}; {kf_device_launches:.0f} "
          f"device operations and {kf_busy_ms:.3f} ms of device time per "
          f"call (profiler, {n_prof} calls); "
          f"{keyframe['normal']['syncs']} synchronisations per call ({card})")

    # -- 9: the monocular initialisation at EuRoC-mono capacity -----------
    from orbslam3_byzyh_tpu_torch.solver import ba as ba_mod

    def rotation_deg(R, R_true) -> float:
        dR = np.asarray(R, np.float64).T @ np.asarray(R_true, np.float64)
        w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                      dR[1, 0] - dR[0, 1]]) / 2
        return float(np.degrees(np.arctan2(np.linalg.norm(w),
                                           (np.trace(dR) - 1) / 2)))

    def angle_deg(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))

    def init_args(scene, d):
        ref_f = fast_orb.FrameFeatures(*convert.tree_to_torch(scene.ref, d))
        cur_f = fast_orb.FrameFeatures(*convert.tree_to_torch(scene.cur, d))
        empty = map_state.empty_map(eu.max_kf, eu.max_lm, eu.max_obs,
                                    eu.n_features, device=d)
        return empty, ref_f, cur_f, 0.0, 0.05, cam_eu.to(d)

    # The reference frame: the EuRoC-mono frame's own features (K1 ran in
    # its extraction, phase 6).
    init, init_calls, launches_init = {}, {n: [] for n in kernels}, None
    expected = {"general": (True, False), "planar": (True, True),
                "rotation": (False, False)}
    for case, (want_ok, want_h) in expected.items():
        scene = graft.euroc_mono_two_view(f_eu, eu, case)
        iargs = init_args(scene, dev)
        seen = {}

        def on_local_ba(a, _, out):
            seen["pre_ba"] = a[0]

        def on_ba(a, kw, out):
            seen["ba"] = (a[0], out)

        for k in kernels.values():
            k.launches = 0
        with recorded(cuda_match, "hamming_best2_kernel") as c2, \
                spied(mapping, "local_ba", on_local_ba), \
                spied(ba_mod, "bundle_adjust", on_ba):
            res = graft.mono_initialize(
                *iargs, generator=torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
        got = {n: k.launches for n, k in kernels.items()}
        require(got == {"K1": 0, "K2": 1, "K3": 0},
                f"init ({case}) launches {got}, expected K2 1")
        if case == "general":
            launches_init = got
            for a, kw in c2:
                err, (b_ms, b_by, b_txt) = check_call("K2", a, kw)
                entry = {"call": "init step general",
                         "shape": shape_of("K2", a, kw), "max_abs_err": err,
                         "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
                entry.update(timed("K2", a, kw, plain_reps=20))
                init_calls["K2"].append(entry)
                phase("9 init", f"K2 {entry['shape']}: identical to plain; "
                      f"launch alone {entry['ms']:.4f} ms, wrapper "
                      f"{entry['wrapper_ms']:.4f} ms, plain "
                      f"{entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                      f"{b_by} ({card})")
        else:
            for a, kw in c2:
                check_call("K2", a, kw)
        info = res.info
        require((res.success, bool(info["used_h"])) == (want_ok, want_h),
                f"init ({case}): success {res.success}, used_h "
                f"{info['used_h']}, expected {want_ok}, {want_h} ({info})")
        out = {"success": res.success, "used_h": info["used_h"],
               "n_matches": info["n_matches"], "reason": info["reason"],
               "host_reads": info["host_reads"]}
        if not res.success:
            require(res.state is iargs[0] and info["reason"] == "two_view",
                    f"init ({case}): failed with {info['reason']}, or the map "
                    f"changed")
        else:
            st = res.state
            rot = rotation_deg(convert.to_numpy(res.R), scene.R)
            t_ang = angle_deg(convert.to_numpy(res.t), scene.t)
            pre = seen["pre_ba"]
            z_pre = convert.to_numpy(pre.lms.pos[pre.lms.valid][:, 2])
            z_post = convert.to_numpy(st.lms.pos[st.lms.valid][:, 2])
            prob, ba_res = seen["ba"]
            cost0 = float(ba_mod._build_system(
                prob, prob.R, prob.t, prob.points, ba_res.obs_inlier,
                cam_mod.PINHOLE, False, lm_mod.CHI2_MONO)["cost"])
            cost1 = float(ba_res.cost)
            inv = map_state.check_invariants(st, 2, eu.max_lm)
            require(info["n_good"] >= 50, f"init ({case}): {info['n_good']} "
                    f"good points < 50")
            require(abs(float(np.median(z_pre)) - 1.0) <= 1e-5,
                    f"init ({case}): median depth {np.median(z_pre)} before "
                    f"the BA")
            require(cost1 < cost0, f"init ({case}): BA cost {cost0} -> "
                    f"{cost1}")
            require(inv == [], f"init ({case}): invariants {inv}")
            require(rot < 1.0 and t_ang < 5.0, f"init ({case}): rotation "
                    f"error {rot} deg, translation direction {t_ang} deg")
            out.update(n_good=info["n_good"], rotation_error_deg=rot,
                       translation_angle_deg=t_ang,
                       median_depth_before_ba=float(np.median(z_pre)),
                       median_depth_after_ba=float(np.median(z_post)),
                       ba_cost_before=cost0, ba_cost_after=cost1,
                       live_landmarks=int(st.lms.valid.sum()))
        # The CPU plain path with the indices the card drew, in the oracle
        # pool; held at the end of the script (``late``).
        if "idx" in info:
            fut = oracle.submit(init_cpu, scene, eu, cam_eu.cpu(),
                                info["idx"].cpu())
            card_res = (res.success, bool(info["used_h"]),
                        int(res.state.lms.valid.sum()) if res.success else 0,
                        res.bindings.cpu() if res.success else None,
                        res.R.cpu() if res.success else None)
            late.append(functools.partial(init_cpu_held, case, fut, card_res,
                                          out))
        # The synchronisations with the host inside the entry point.
        with counted_syncs() as where:
            graft.mono_initialize(
                *iargs, generator=torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        out.update(syncs=len(where), sync_sites=sorted(set(where)))
        init[case] = out
        phase("9 init", f"{case}: mono_initialize, {eu.max_kf} keyframe / "
              f"{eu.max_lm} landmark slots: {json.dumps(out)}; launches "
              f"{got} ({card})")

    # The timed init step: the general case from the empty map.
    scene = graft.euroc_mono_two_view(f_eu, eu, "general")
    iargs = init_args(scene, dev)

    def init_step():
        r = graft.mono_initialize(
            *iargs, generator=torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        return r

    for _ in range(N_WARMUP_INITS):
        init_step()
    for k in kernels.values():
        k.launches = 0
    init_ms = []
    for _ in range(N_TIMED_INITS):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        init_step()
        init_ms.append((time.perf_counter() - t_start) * 1e3)
    init_per_call = {n: k.launches / N_TIMED_INITS
                     for n, k in kernels.items()}
    init_med = statistics.median(init_ms)
    init_p80 = statistics.quantiles(init_ms, n=5)[-1]
    phase("9 init", f"mono_initialize (general case) median {init_med:.3f} "
          f"ms, p80 {init_p80:.3f} ms over {N_TIMED_INITS} calls (min "
          f"{min(init_ms):.3f}, max {max(init_ms):.3f}), after "
          f"{N_WARMUP_INITS} warm-up calls; K1-K3 launches per call "
          f"{init_per_call}; {init['general']['syncs']} synchronisations and "
          f"{len(init['general']['host_reads'])} host reads "
          f"({', '.join(init['general']['host_reads'])}) per call ({card})")

    # -- 10: the monocular system at the golden and EuRoC-mono capacity ----
    from orbslam3_byzyh_tpu_torch.pipeline import system as system_mod
    from orbslam3_byzyh_tpu_torch.utils import evaluate

    gold = graft.golden_frames()
    configs = {
        "golden": (graft.golden_slam_config(), gold.frames),
        "euroc": (graft.euroc_golden_config(), graft.pad_frames(gold.frames))}
    bundles = []
    keyframe_step = graft.mono_keyframe_step

    def counted_bundle(*a, **kw):
        bundles.append(kw.get("do_kf_cull"))
        return keyframe_step(*a, **kw)

    graft.mono_keyframe_step = counted_bundle

    def centres_of(traj):
        return (np.array([s for s, _, _ in traj]),
                evaluate.camera_centers(np.stack([R for _, R, _ in traj]),
                                        np.stack([t for _, _, t in traj])))

    def gate(name, slam, traj):
        """The run's gate, as the JAX package's tests hold it: the golden
        run as test_golden.py (>= 42 frames, Horn-scaled ATE < 0.0149 m),
        the EuRoC-capacity run as test_e2e_mono.py (> 32 frames, ATE by
        stamp association < 0.15 m)."""
        require(len(traj) > 0, f"system ({name}): no frame tracked")
        stamps, est = centres_of(traj)
        stamps = stamps + slam.t0
        if name == "golden":
            idx = np.searchsorted(gold.stamps, stamps - 1e-6)
            _, _, _, ate = evaluate.horn_align(est, gold.centres[idx])
            ok = (len(traj) >= graft.GOLDEN_N_FRAMES - 2
                  and ate < graft.GOLDEN_ATE_GATE_M)
            limit = (f">= {graft.GOLDEN_N_FRAMES - 2} frames, ATE < "
                     f"{graft.GOLDEN_ATE_GATE_M:.4f} m")
        else:
            ate, n_assoc = evaluate.ate_rmse(stamps, est, gold.stamps,
                                             gold.centres)
            ok = len(traj) > 32 and n_assoc > 30 and ate < 0.15
            limit = "> 32 frames, ATE < 0.15 m"
        live = slam.state.kfs.valid.sum(), slam.state.lms.valid.sum()
        out = {"frames": len(traj), "ate_m": float(ate),
               "live_keyframes": int(live[0]), "live_landmarks": int(live[1]),
               "keyframe_slots": slam.n_kf, "status": slam.status}
        require(ok, f"system ({name}): {out} against {limit}")
        return out

    # Every kernel launch of the first sequence, held against its plain
    # version right after it returns (K1, K2 bit-identical, K3 as k3_check).
    sys_checked = {name: {n: {"calls": 0, "max_abs_err": 0.0, "shapes": {}}
                          for n in kernels} for name in configs}
    sys_calls = {n: [] for n in kernels}
    guard = []
    spies = {"K1": (cuda_brief, "brief_descriptors_kernel"),
             "K2": (cuda_match, "hamming_best2_kernel"),
             "K3": (cuda_pose_opt, "pose_optimization_kernel")}
    originals = {n: getattr(m, f) for n, (m, f) in spies.items()}

    def checking(name):
        fn = originals[name]

        def spy(*a, **kw):
            out = fn(*a, **kw)
            if guard:
                return out
            rec = sys_checked[seq_name[0]][name]
            shape = shape_of(name, a, kw)
            key = json.dumps({"K1": {}, "K3": shape}.get(name, [
                shape.get("N"), shape.get("M"), shape.get("mode")]))
            guard.append(name)
            try:
                # A shape's first call keeps its error: held at once.
                err, b = check_call(name, a, kw,
                                    rec if key in rec["shapes"] else None)
            finally:
                guard.pop()
            rec["calls"] += 1
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
            rec["shapes"][key] = rec["shapes"].get(key, 0) + 1
            if rec["shapes"][key] == 1:
                sys_calls[name].append((seq_name[0], a, kw, err, b))
            return out

        return spy

    seq_name = [None]
    system = {}
    for name, (cfg, frames) in configs.items():
        seq_name[0] = name
        for n_, (m, f) in spies.items():
            setattr(m, f, checking(n_))
        try:
            slam = system_mod.MonoSlam(cfg)
            recs, traj, _ = run_sequence(slam, frames, gold.stamps, kernels,
                                         bundles)
            torch.cuda.synchronize()
            settle()
        finally:
            for n_, (m, f) in spies.items():
                setattr(m, f, originals[n_])
        warm = gate(name, slam, traj)
        checked = sys_checked[name]
        require(all(checked[n]["calls"] > 0 for n in kernels),
                f"system ({name}): kernels launched {checked}")
        phase("10 system", f"{name}: warm-up sequence, every launch held "
              f"against its plain version: " + ", ".join(
                  f"{n} {checked[n]['calls']} calls max err "
                  f"{checked[n]['max_abs_err']:.2e}" for n in kernels)
              + f"; {json.dumps(warm)}")
        # The timed sequences.
        frames_all, seqs = [], []
        for _ in range(N_TIMED_SEQUENCES):
            slam = system_mod.MonoSlam(cfg)
            for k in kernels.values():
                k.launches = 0
            torch.cuda.synchronize()
            recs, traj, sec = run_sequence(slam, frames, gold.stamps, kernels,
                                           bundles)
            res = gate(name, slam, traj)
            res.update(seconds=sec, fps=len(frames) / sec,
                       launches={n: k.launches for n, k in kernels.items()})
            require(all(v > 0 for v in res["launches"].values()),
                    f"system ({name}): launches {res['launches']}")
            seqs.append(res)
            frames_all += recs
        kinds = {}
        for kind in ("uninitialised", "init", "tracked", "keyframe"):
            rs = [r for r in frames_all if r["kind"] == kind]
            kinds[kind] = spread(r["ms"] for r in rs)
            kinds[kind]["launches_per_frame"] = {
                n: (sum(r["launches"][n] for r in rs) / len(rs) if rs
                    else None) for n in kernels}
        # The synchronisations per frame, by kind, on one more sequence.
        slam = system_mod.MonoSlam(cfg)
        syncs = []
        for img, stamp in zip(frames, gold.stamps):
            uninit = slam.status == system_mod.NOT_INITIALIZED
            n_b = len(bundles)
            with counted_syncs() as where:
                slam.track(img, float(stamp))
            if uninit:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            else:
                kind = "keyframe" if len(bundles) > n_b else "tracked"
            syncs.append((kind, where))
        for kind in kinds:
            ws = [w for k, w in syncs if k == kind]
            kinds[kind]["syncs_per_frame"] = (
                sum(len(w) for w in ws) / len(ws) if ws else None)
            sites = {}
            for w in ws:
                for site in w:
                    sites[site] = sites.get(site, 0) + 1
            kinds[kind]["sync_sites"] = {k: v / len(ws)
                                         for k, v in sorted(sites.items())}
            kinds[kind]["jax_host_reads"] = JAX_HOST_READS[kind]
        fps = [r["fps"] for r in seqs]
        system[name] = {"config": {k: v for k, v in dataclasses.asdict(
            cfg).items() if not isinstance(v, np.ndarray)},
            "warmup": warm, "sequences": seqs, "frame_kinds": kinds,
            "fps": spread(fps)}
        for kind, st in kinds.items():
            if st["n"]:
                phase("10 system", f"{name}: {kind} frames ({st['n']} over "
                      f"{N_TIMED_SEQUENCES} sequences): track() median "
                      f"{st['median']:.3f} ms, p80 {st['p80']:.3f} ms (min "
                      f"{st['min']:.3f}, max {st['max']:.3f}); K1-K3 launches "
                      f"per frame {st['launches_per_frame']}; "
                      f"{st['syncs_per_frame']} synchronisations per frame "
                      f"{st['sync_sites']}; the JAX system reads "
                      f"{JAX_HOST_READS[kind]} ({card})")
        secs = ", ".join(f"{r['seconds']:.3f}" for r in seqs)
        rates = ", ".join(f"{f:.2f}" for f in fps)
        phase("10 system", f"{name}: {len(gold.frames)} frames in {secs} s "
              f"= {rates} frames/s; trajectory "
              f"{[r['frames'] for r in seqs]} frames, ATE "
              f"{[round(r['ate_m'], 5) for r in seqs]} m, live keyframes "
              f"{[r['live_keyframes'] for r in seqs]} and landmarks "
              f"{[r['live_landmarks'] for r in seqs]}"
              + (f" (the JAX golden run: {graft.GOLDEN_N_KF_LIVE} and "
                 f"{graft.GOLDEN_N_LM_LIVE}, ATE {graft.GOLDEN_ATE_M} m)"
                 if name == "golden" else "") + f" ({card})")

    # EuRoC-mono's own 1200 features on the same frames: reported, not
    # gated (the synthetic world needs 1536, see graft.euroc_golden_config).
    attempts = []
    init_fn = graft.mono_initialize

    def logged_init(*a, **kw):
        r = init_fn(*a, **kw)
        attempts.append((r.info["n_matches"], r.info["reason"]))
        return r

    graft.mono_initialize = logged_init
    try:
        slam = system_mod.MonoSlam(graft.euroc_golden_config(
            n_features=eu.n_features))
        _, traj, _ = run_sequence(slam, configs["euroc"][1], gold.stamps,
                                  kernels, bundles)
    finally:
        graft.mono_initialize = init_fn
    system["euroc_1200_features"] = {"frames": len(traj),
                                     "init_attempts": attempts}
    phase("10 system", f"euroc with {eu.n_features} features: {len(traj)} "
          f"frames tracked; init attempts (matches, reason) {attempts}")

    # The capacity run: the golden frames into 12 keyframe slots.
    cfg = graft.golden_slam_config(max_kf=CAPACITY_MAX_KF,
                                   ba_window=CAPACITY_BA_WINDOW)
    slam = system_mod.MonoSlam(cfg)
    fired = {"force_cull_calls": 0, "force_culled": 0, "compactions": 0,
             "rebases": 0}
    force = slam._force_cull_keyframes
    compact = map_state.compact_keyframes
    rebase = slam._traj.rebase
    compacted = []

    def forced(n):
        fired["force_cull_calls"] += 1
        got = force(n)
        fired["force_culled"] += got
        return got

    def compacting(*a, **kw):
        fired["compactions"] += 1
        out = compact(*a, **kw)
        compacted.append(out[2])
        return out

    def rebasing(*a, **kw):
        fired["rebases"] += 1
        return rebase(*a, **kw)

    drain = slam._drain_pending
    drains = []

    def draining():
        # The lazy read of a bundle moves the frame records off the
        # keyframes it culled: none may stay on a dead slot.
        drain()
        live = convert.to_numpy(slam.state.kfs.valid)
        dead_refs = [r for r in slam._traj.refs if r >= 0 and not live[r]]
        require(not dead_refs, f"capacity: after a keyframe read, frame "
                f"records on dead keyframe slots {dead_refs}")
        drains.append(len(slam._traj.refs))

    def capacity_checks(i, kind):
        if compacted:
            inv = map_state.check_invariants(slam.state, slam.n_kf,
                                             cfg.max_lm)
            require(inv == [], f"capacity: frame {i}: invariants {inv}")
            compacted.clear()

    slam._drain_pending = draining
    slam._force_cull_keyframes = forced
    slam._traj.rebase = rebasing
    map_state.compact_keyframes = compacting
    try:
        _, traj, _ = run_sequence(slam, gold.frames, gold.stamps, kernels,
                                  bundles, after=capacity_checks)
    finally:
        map_state.compact_keyframes = compact
    require(len(traj) > 32 and all(v > 0 for v in fired.values()),
            f"capacity: {len(traj)} frames, fired {fired}")
    system["capacity"] = dict(fired, frames=len(traj), drains=len(drains),
                              keyframe_slots=slam.n_kf,
                              live_keyframes=int(slam.state.kfs.valid.sum()))
    phase("10 system", f"capacity (max_kf {CAPACITY_MAX_KF}, ba_window "
          f"{CAPACITY_BA_WINDOW}): "
          f"{json.dumps(system['capacity'])}; invariants empty after every "
          f"compaction, no frame record on a dead slot after any keyframe "
          f"read")
    graft.mono_keyframe_step = keyframe_step

    # Each kernel on a call of each shape the system gave it.
    for name, calls in sys_calls.items():
        timed_calls = []
        for where, a, kw, err, (b_ms, b_by, b_txt) in calls:
            entry = {"call": f"system {where}",
                     "shape": shape_of(name, a, kw), "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
            entry.update(timed(name, a, kw,
                               plain_reps=plain_reps_of(name)))
            timed_calls.append(entry)
            phase("10 system", f"{name} {entry['call']} {entry['shape']}: "
                  f"launch alone {entry['ms']:.4f} ms, wrapper "
                  f"{entry['wrapper_ms']:.4f} ms, plain "
                  f"{entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by} ({card})")
        sys_calls[name] = timed_calls

    # -- 11: rectified stereo and RGB-D ---------------------------------------
    from orbslam3_byzyh_tpu_torch.pipeline import stereo_system

    rig = graft.KITTI_STEREO
    km = rig.mono
    sk = dict(kernels, K3s=k3s)          # the stereo paths' launch counts

    # K3s against its plain version on a mixed problem at KITTI's 2000
    # points: 60 % stereo rows, outliers in both coordinates.
    npt = km.n_features
    pts = np.stack([rng.uniform(-6, 6, npt), rng.uniform(-2, 2, npt),
                    rng.uniform(4, 30, npt)], -1)
    xi = torch.tensor([0.2, -0.1, 0.3, 0.02, -0.03, 0.01], dtype=torch.float64)
    R_gt, t_gt = (x.numpy() for x in lie.se3_exp(xi))
    pc = pts @ R_gt.T + t_gt
    uv = np.stack([km.fx * pc[:, 0] / pc[:, 2] + km.cx,
                   km.fy * pc[:, 1] / pc[:, 2] + km.cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    ur = uv[:, 0] - rig.bf / pc[:, 2] + rng.normal(0, 0.5, npt)
    bad = rng.choice(npt, 100, replace=False)
    uv[bad[:50]] += rng.uniform(20, 80, (50, 2))
    ur[bad[50:]] += rng.uniform(10, 40, 50)
    ur = np.where(rng.random(npt) < 0.6, ur, -1.0)
    R0_s, t0_s = (x.numpy() for x in lie.se3_exp(
        xi + torch.tensor([0.05, -0.03, 0.08, 0.01, -0.01, 0.005],
                          dtype=torch.float64)))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    k3s_args = (f32(R0_s), f32(t0_s), f32(pts), f32(uv), f32(ur),
                float(rig.bf),
                f32(1.0 / 1.2 ** (2.0 * rng.integers(0, 8, npt))),
                torch.from_numpy(rng.random(npt) > 0.03).to(dev),
                f32([km.fx, km.fy, km.cx, km.cy]))
    err, inl, inl_s = k3s_check(k3s_args, {})
    results["K3s"] = {"max_abs_err": err}
    (results["K3s"]["bound_ms"], results["K3s"]["bound_by"],
     results["K3s"]["bound"]) = k3s_bound(k3s_args, inl, inl_s)
    results["K3s"].update(timed("K3s", k3s_args, {}, plain_reps=10))
    require(cuda_pose_opt.pose_max_points_stereo() >= npt,
            f"K3s holds {cuda_pose_opt.pose_max_points_stereo()} points")
    phase("11 stereo", f"K3s N={npt} ({int((k3s_args[4] >= 0).sum())} "
          f"stereo rows): max |dR|,|dt| {err:.2e}; inliers {inl[0]} "
          f"({inl_s[0]} stereo); launch alone {results['K3s']['ms']:.4f} ms, "
          f"wrapper {results['K3s']['wrapper_ms']:.4f} ms, plain "
          f"{results['K3s']['plain_ms']:.4f} ms, bound "
          f"{results['K3s']['bound_ms']:.5f} ms by "
          f"{results['K3s']['bound_by']}; at most "
          f"{cuda_pose_opt.pose_max_points_stereo()} points a problem "
          f"({card})")

    # The KITTI stereo frame step on the shifted pair.
    cam_k = f32([km.fx, km.fy, km.cx, km.cy])
    left, right = (torch.from_numpy(a).to(dev)
                   for a in graft.kitti_stereo_pair(rig))
    f_k, _, m_k = graft.stereo_extract(left, right, cam_k, None, rig)
    disp = f_k.xy[:, 0] - m_k.u_right
    lvl0 = m_k.valid & (f_k.level == 0)
    n_match, n_lvl0 = int(m_k.valid.sum()), int(lvl0.sum())
    d0 = float((disp[lvl0] - graft.KITTI_PAIR_SHIFT).abs().max())
    d_all = float((disp[m_k.valid] - graft.KITTI_PAIR_SHIFT).abs().max())
    d_med = float(disp[m_k.valid].median())
    # Level-0 keypoints sit on whole pixels: the parabola moves them by at
    # most 0.5 px. A higher level's keypoint is scaled up to a fraction of
    # a pixel, and the SAD window sits at its rounded position (0.5 more);
    # where the SAD's minimum falls on the search's edge the parabola is
    # skipped (1 more), and near the image's edge the windows are clamped.
    d_share = float(((disp[m_k.valid] - graft.KITTI_PAIR_SHIFT).abs()
                     <= 1.0).float().mean())
    require(n_match >= 0.25 * km.n_features and n_lvl0 > 0
            and d0 <= 0.5 and d_all <= 1.5 and d_share >= 0.95
            and abs(d_med - graft.KITTI_PAIR_SHIFT) <= 0.1,
            f"stereo match: {n_match} matches ({n_lvl0} at level 0), "
            f"disparity {d_med} (level 0 within {d0}, all within {d_all}, "
            f"{d_share:.1%} within 1 px) against {graft.KITTI_PAIR_SHIFT}")
    phase("11 stereo", f"stereo_extract {km.width}x{km.height}: "
          f"{int(f_k.valid.sum())} features, {n_match} stereo matches, "
          f"disparity median {d_med:.4f} px (level 0: {n_lvl0} within "
          f"{d0:.4f} px of {graft.KITTI_PAIR_SHIFT}; all within {d_all:.4f}, "
          f"{d_share:.1%} within 1 px)")
    feats_k = [convert.to_numpy(a) for a in (f_k.xy, f_k.level, f_k.desc,
                                             f_k.angle, f_k.valid)]
    depth_k = convert.to_numpy(m_k.depth)
    stereo = {"disparity": {"matches": n_match, "level0": n_lvl0,
                            "median": d_med, "level0_max_err": d0,
                            "max_err": d_all, "within_1px": d_share}}
    st_recorded = {n: [] for n in sk}
    launches_st = None
    for case in ("normal", "retry"):
        args = graft.StereoFrameArgs(*convert.tree_to_torch(
            graft.kitti_stereo_scene(*feats_k, depth_k, case=case, rig=rig),
            dev))
        # A first call makes the step's cached constants (one upload of
        # the search radii per row count), then the counted, checked call.
        graft.stereo_frame_step(*args)
        for k in sk.values():
            k.launches = 0
        with recorded(cuda_brief, "brief_descriptors_kernel") as c1, \
                recorded(cuda_match, "hamming_best2_kernel") as c2, \
                recorded(cuda_pose_opt, "pose_optimization_kernel") as c3, \
                recorded(cuda_pose_opt,
                         "pose_optimization_stereo_kernel") as c3s:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res, info, n_found, _, _ = graft.stereo_frame_step(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        got = {n: k.launches for n, k in sk.items()}
        require(got == {"K1": 2, "K2": 2, "K3": 1, "K3s": 1},
                f"stereo frame step ({case}) launches {got}, expected K1 2, "
                f"K2 2, K3 1, K3s 1")
        info_np = convert.to_numpy(info)
        n_gpu, n_valid = int(info_np[0]), int(f_k.valid.sum())
        r_err = float((res.R - eye).abs().max())
        t_err = float(res.t.abs().max())
        ur_c, valid_c = c3s[0][0][4], c3s[0][0][7]
        rows = int(((ur_c >= 0) & valid_c).sum())
        require(bool(torch.isfinite(info).all()), "non-finite stereo info")
        require(n_gpu >= 0.9 * n_valid,
                f"stereo frame step ({case}): {n_gpu} inliers of {n_valid}")
        require(r_err <= 1e-3 and t_err <= 1e-3,
                f"stereo frame step ({case}) pose error R {r_err} t {t_err}")
        require(rows >= 0.9 * n_match,
                f"stereo frame step ({case}): {rows} stereo rows in K3s of "
                f"{n_match} matches")
        first = tracking.track_motion_model(
            args.R_pred, args.t_pred, args.lm_pos, args.lm_valid,
            args.last_bind, args.last_desc, f_k.xy, f_k.level, f_k.desc,
            f_k.valid, args.cam_params, last_angle=args.last_angle,
            feats_angle=f_k.angle)
        took_retry = int(first.n_inliers) < tracking.RETRY_BELOW
        require(took_retry == (case == "retry"),
                f"stereo frame step ({case}): the motion model keeps "
                f"{int(first.n_inliers)} inliers")
        _, info_cpu, _, _, _ = graft.stereo_frame_step(*(
            None if a is None else a.cpu() for a in args))
        n_cpu = int(info_cpu[0])
        require(abs(n_cpu - n_gpu) <= 0.01 * n_gpu,
                f"stereo frame step ({case}): CPU {n_cpu} vs card {n_gpu}")
        if case == "normal":
            launches_st = got
            for name, calls in (("K1", c1), ("K2", c2), ("K3", c3),
                                ("K3s", c3s)):
                st_recorded[name] += [(a, kw) for a, kw in calls]
        stereo[case] = {"n_inliers": n_gpu, "n_valid": n_valid,
                        "n_inliers_cpu": n_cpu, "stereo_rows": rows,
                        "close": info_np[2:4].tolist(), "R_err": r_err,
                        "t_err": t_err}
        phase("11 stereo", f"{case}: stereo_frame_step {km.width}x"
              f"{km.height}, {km.n_features} features, {km.max_lm} landmark "
              f"slots: n_inliers {n_gpu} of {n_valid} valid (CPU plain "
              f"versions {n_cpu}); {rows} stereo rows in K3s; close points "
              f"tracked / untracked {info_np[2:4].tolist()}; "
              f"{'retry' if took_retry else 'first try'}; |R-I| "
              f"{r_err:.2e} |t| {t_err:.2e}; launches {got}; no "
              f"synchronisation inside the step")
    st_calls = {n: [] for n in sk}
    for name, calls in st_recorded.items():
        for a, kw in calls:
            err, (b_ms, b_by, b_txt) = check_call(name, a, kw)
            entry = {"call": "stereo frame step",
                     "shape": shape_of(name, a, kw), "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
            entry.update(timed(name, a, kw, plain_reps=plain_reps_of(name)))
            st_calls[name].append(entry)
            phase("11 stereo", f"{name} stereo frame step {entry['shape']}: "
                  f"held against plain (max err {err:.2e}); launch alone "
                  f"{entry['ms']:.4f} ms, wrapper {entry['wrapper_ms']:.4f} "
                  f"ms, plain {entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms "
                  f"by {b_by} ({card})")
    args = graft.StereoFrameArgs(*convert.tree_to_torch(
        graft.kitti_stereo_scene(*feats_k, depth_k, rig=rig), dev))
    st_ms = []
    for i in range(N_WARMUP_STEREO + N_TIMED_FRAMES):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        _, info, _, _, _ = graft.stereo_frame_step(*args)
        info.cpu()                 # the caller's one read of the frame
        if i >= N_WARMUP_STEREO:
            st_ms.append((time.perf_counter() - t_start) * 1e3)
    stereo["step_ms"] = spread(st_ms)
    phase("11 stereo", f"stereo_frame_step (KITTI, normal case) median "
          f"{stereo['step_ms']['median']:.3f} ms, p80 "
          f"{stereo['step_ms']['p80']:.3f} ms over {N_TIMED_FRAMES} calls "
          f"(min {stereo['step_ms']['min']:.3f}, max "
          f"{stereo['step_ms']['max']:.3f}), after {N_WARMUP_STEREO} warm-up "
          f"calls, the read of info included ({card})")

    # The systems: (a) the stereo golden config, (b) KITTI capacity, (c)
    # RGB-D at TUM1's settings, on the committed stereo frames.
    sf = graft.stereo_frames()
    cells = {
        "stereo": (stereo_system.StereoSlam, graft.stereo_golden_config(),
                   list(zip(sf.left, sf.right))),
        "kitti": (stereo_system.StereoSlam, graft.kitti_golden_config(),
                  list(zip(graft.kitti_frames(sf.left),
                           graft.kitti_frames(sf.right)))),
        "rgbd": (stereo_system.RgbdSlam, graft.tum_rgbd_golden_config(),
                 list(zip(sf.left, sf.depth)))}
    bundles = []
    graft.mono_keyframe_step = counted_bundle

    def stereo_gate(name, slam, traj):
        """(a), (b): test_stereo_system.py's gate (more than 20 frames, the
        ATE without scale alignment under 0.12 m, the path length within
        5 %); (c): the JAX RgbdSlam's run on the same frames (its frame
        count +-1, ATE under 1.5 x its own + 0.002 m)."""
        require(len(traj) > 0, f"system ({name}): no frame tracked")
        stamps, est = centres_of(traj)
        stamps = stamps + slam.t0
        ate, n_assoc = evaluate.ate_rmse(stamps, est, sf.stamps, sf.centres,
                                         with_scale=False)
        idx = np.searchsorted(sf.stamps, stamps - 1e-6)
        length = float(np.linalg.norm(np.diff(est, axis=0), axis=-1).sum())
        true_len = float(np.linalg.norm(np.diff(sf.centres[idx], axis=0),
                                        axis=-1).sum())
        path_err = abs(length - true_len) / true_len
        if name == "rgbd":
            limit_m = 1.5 * graft.RGBD_JAX_ATE_M + 0.002
            ok = (abs(len(traj) - graft.RGBD_JAX_FRAMES) <= 1
                  and ate < limit_m)
            limit = (f"{graft.RGBD_JAX_FRAMES} +- 1 frames, ATE < "
                     f"{limit_m:.5f} m")
        else:
            ok = (n_assoc > graft.STEREO_MIN_FRAMES
                  and ate < graft.STEREO_ATE_GATE_M
                  and path_err < graft.STEREO_PATH_TOL)
            limit = (f"> {graft.STEREO_MIN_FRAMES} frames, ATE < "
                     f"{graft.STEREO_ATE_GATE_M} m, path within "
                     f"{graft.STEREO_PATH_TOL:.0%}")
        live = slam.state.kfs.valid.sum(), slam.state.lms.valid.sum()
        out = {"frames": len(traj), "ate_m": float(ate), "path_m": length,
               "true_path_m": true_len, "path_err": path_err,
               "live_keyframes": int(live[0]),
               "live_landmarks": int(live[1]), "keyframe_slots": slam.n_kf,
               "status": slam.status}
        require(ok, f"system ({name}): {out} against {limit}")
        return out

    spies["K3s"] = (cuda_pose_opt, "pose_optimization_stereo_kernel")
    originals["K3s"] = cuda_pose_opt.pose_optimization_stereo_kernel
    st_checked = {name: {n: {"calls": 0, "max_abs_err": 0.0, "shapes": {}}
                         for n in sk} for name in cells}
    sys_checked.update(st_checked)
    sys_calls["K3s"] = []
    st_sys_calls = {n: [] for n in sk}
    phase10_calls = {n: list(v) for n, v in sys_calls.items()}
    stereo_sys = {}
    for name, (cls, cfg, frames) in cells.items():
        seq_name[0] = name
        n_calls = {n: len(sys_calls[n]) for n in sk}
        for n_, (m, f) in spies.items():
            setattr(m, f, checking(n_))
        plain32_err["on"] = name == "stereo"
        try:
            slam = cls(cfg)
            _, traj, _ = run_sequence(slam, frames, sf.stamps, sk, bundles)
            torch.cuda.synchronize()
            settle()
        finally:
            plain32_err["on"] = False
            for n_, (m, f) in spies.items():
                setattr(m, f, originals[n_])
        warm = stereo_gate(name, slam, traj)
        checked = sys_checked[name]
        require(all(checked[n]["calls"] > 0 for n in sk),
                f"system ({name}): kernels launched {checked}")
        for n in sk:
            st_sys_calls[n] += sys_calls[n][n_calls[n]:]
        phase("11 stereo", f"{name}: warm-up sequence, every launch held "
              f"against its plain version: " + ", ".join(
                  f"{n} {checked[n]['calls']} calls max err "
                  f"{checked[n]['max_abs_err']:.2e}" for n in sk)
              + f"; {json.dumps(warm)}")
        frames_all, seqs = [], []
        for _ in range(N_TIMED_STEREO_SEQUENCES):
            slam = cls(cfg)
            for k in sk.values():
                k.launches = 0
            torch.cuda.synchronize()
            recs, traj, sec = run_sequence(slam, frames, sf.stamps, sk,
                                           bundles)
            res = stereo_gate(name, slam, traj)
            res.update(seconds=sec, fps=len(frames) / sec,
                       launches={n: k.launches for n, k in sk.items()})
            require(all(v > 0 for v in res["launches"].values()),
                    f"system ({name}): launches {res['launches']}")
            seqs.append(res)
            frames_all += recs
        kinds = {}
        for kind in ("uninitialised", "init", "tracked", "keyframe"):
            rs = [r for r in frames_all if r["kind"] == kind]
            kinds[kind] = spread(r["ms"] for r in rs)
            kinds[kind]["launches_per_frame"] = {
                n: (sum(r["launches"][n] for r in rs) / len(rs) if rs
                    else None) for n in sk}
        slam = cls(cfg)
        syncs = []
        for fr, stamp in zip(frames, sf.stamps):
            uninit = slam.status == system_mod.NOT_INITIALIZED
            n_b = len(bundles)
            with counted_syncs() as where:
                slam.track(*fr, float(stamp))
            if uninit:
                kind = ("uninitialised"
                        if slam.status == system_mod.NOT_INITIALIZED
                        else "init")
            else:
                kind = "keyframe" if len(bundles) > n_b else "tracked"
            syncs.append((kind, where))
        for kind in kinds:
            ws = [w for k, w in syncs if k == kind]
            kinds[kind]["syncs_per_frame"] = (
                sum(len(w) for w in ws) / len(ws) if ws else None)
            sites = {}
            for w in ws:
                for site in w:
                    sites[site] = sites.get(site, 0) + 1
            kinds[kind]["sync_sites"] = {k: v / len(ws)
                                         for k, v in sorted(sites.items())}
            kinds[kind]["jax_host_reads"] = JAX_STEREO_READS[kind]
        fps = [r["fps"] for r in seqs]
        stereo_sys[name] = {"config": {k: v for k, v in dataclasses.asdict(
            cfg).items() if not isinstance(v, np.ndarray)},
            "warmup": warm, "sequences": seqs, "frame_kinds": kinds,
            "fps": spread(fps)}
        for kind, st in kinds.items():
            if st["n"]:
                phase("11 stereo", f"{name}: {kind} frames ({st['n']} over "
                      f"{N_TIMED_STEREO_SEQUENCES} sequences): track() median "
                      f"{st['median']:.3f} ms, p80 {st['p80']:.3f} ms (min "
                      f"{st['min']:.3f}, max {st['max']:.3f}); launches per "
                      f"frame {st['launches_per_frame']}; "
                      f"{st['syncs_per_frame']} synchronisations per frame "
                      f"{st['sync_sites']}; the JAX system reads "
                      f"{JAX_STEREO_READS[kind]} ({card})")
        phase("11 stereo", f"{name}: {len(frames)} frames in "
              + ", ".join(f"{r['seconds']:.3f}" for r in seqs) + " s = "
              + ", ".join(f"{f:.2f}" for f in fps) + " frames/s; trajectory "
              f"{[r['frames'] for r in seqs]} frames, ATE "
              f"{[round(r['ate_m'], 5) for r in seqs]} m, path error "
              f"{[round(r['path_err'], 4) for r in seqs]}, live keyframes "
              f"{[r['live_keyframes'] for r in seqs]} and landmarks "
              f"{[r['live_landmarks'] for r in seqs]} ({card})")
    graft.mono_keyframe_step = keyframe_step
    for n in sk:                     # phase 10's timed calls stay its own
        sys_calls[n] = phase10_calls.get(n, [])
    for name, calls in st_sys_calls.items():
        timed_calls = []
        for where, a, kw, err, (b_ms, b_by, b_txt) in calls:
            entry = {"call": f"system {where}",
                     "shape": shape_of(name, a, kw), "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": b_by, "bound": b_txt}
            entry.update(timed(name, a, kw, plain_reps=plain_reps_of(name)))
            timed_calls.append(entry)
            phase("11 stereo", f"{name} {entry['call']} {entry['shape']}: "
                  f"launch alone {entry['ms']:.4f} ms, wrapper "
                  f"{entry['wrapper_ms']:.4f} ms, plain "
                  f"{entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by} ({card})")
        st_sys_calls[name] = timed_calls
    stereo["system"] = stereo_sys
    phase("11 stereo", "the float32 plain versions' largest distance from "
          f"the float64 oracle over the stereo cell's checked calls: K3 "
          f"{plain32_err['K3']:.2e}, K3s {plain32_err['K3s']:.2e}")

    # -- 12: the stereo-inertial device path ----------------------------------
    vi_out = phase_inertial(dev, card, sk, check_call, timed, shape_of)

    # -- 13: the inertial systems -------------------------------------------
    vi_sys, vi_held = phase_inertial_system(dev, card, sk, check_call,
                                            shape_of)
    vi_sys_calls = {n: [] for n in sk}
    for n, calls in vi_held.items():
        # Timed at the EuRoC-capacity cell's shapes (the golden cells'
        # calls were held against plain in the warm-up all the same).
        for cell, a, kw, err, (b_ms, b_by, b_txt) in calls:
            if cell != "f_euroc_vi":
                continue
            entry = {"call": f"system {cell}", "shape": shape_of(n, a, kw),
                     "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                     "bound": b_txt}
            entry.update(timed(n, a, kw, plain_reps=plain_reps_of(n)))
            vi_sys_calls[n].append(entry)
            phase("13 inertial system", f"{n} {entry['call']} "
                  f"{entry['shape']}: launch alone {entry['ms']:.4f} ms, "
                  f"wrapper {entry['wrapper_ms']:.4f} ms, plain "
                  f"{entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by} ({card})")
    del vi_held
    phase("13 inertial system", f"{vi_sys['graphs_kept']} CUDA graphs kept "
          f"at the end (at most 32 are)")

    # -- 19: the dataset runners, run here while cell (f)'s CUDA graphs (the
    # flagship runner's shapes) are still cached ------------------------------
    shared = {}
    runs = phase_runners(dev, card, sk, p1, vi_sys, datasets, oracle, shared)

    # -- 14: non-rectified (fisheye) stereo and the KB8 camera --------------
    t14 = time.perf_counter()
    fish, fish_a, fish_g, fish_h = phase_fisheye(dev, card, sk, check_call,
                                                 timed, shape_of)
    fish_sys_calls = {n: [] for n in sk}
    for n in sk:
        calls = [("g_fisheye_stereo",) + c for c in fish_g[n]] \
            + list(fish_h[n])
        for cell, a, kw, err, (b_ms, b_by, b_txt) in calls:
            entry = {"call": f"system {cell}", "shape": shape_of(n, a, kw),
                     "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                     "bound": b_txt}
            entry.update(timed(n, a, kw, plain_reps=plain_reps_of(n)))
            fish_sys_calls[n].append(entry)
            phase("14 fisheye", f"{n} {entry['call']} {entry['shape']}: "
                  f"launch alone {entry['ms']:.4f} ms, wrapper "
                  f"{entry['wrapper_ms']:.4f} ms, plain "
                  f"{entry['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by} ({card})")
    del fish_g, fish_h
    fish["seconds"] = time.perf_counter() - t14
    phase("14 fisheye", f"phase took {fish['seconds']:.1f} s; "
          f"{fish['graphs_kept']} CUDA graphs kept at the end")

    # -- 15: place recognition and relocalization ---------------------------
    reloc, reloc_calls = phase_reloc(dev, card, sk, check_call, timed,
                                     shape_of)
    reloc_cells = ("i_reloc", "j_cross_map")

    # -- 16: loop closing and the global BA ---------------------------------
    loop, loop_calls = phase_loop(dev, card, sk, check_call, timed, shape_of,
                                  shared)

    # -- 17: the atlas merge and the atlas checkpoints -----------------------
    merge, merge_calls = phase_merge(dev, card, sk, check_call, timed,
                                     shape_of, os.path.join(root, "atlas_m"))

    # -- 20: the device mesh, native KB8 and the viewer ---------------------
    last = phase_last_modules(dev, card, sk, check_call, timed, shape_of,
                              shared, os.path.join(root, "atlas_m"))

    # -- 18: the chessboard world frame --------------------------------------
    chess = phase_chessboard(dev, card, sk, check_call, system)

    # The KB8 launches of the whole run outside phase 20 (every system path
    # among them): no system path passes a KB8 camera to K3 or K3s.
    for k3_name, fn in (("K3", cuda_pose_opt.MONO_FN),
                        ("K3s", cuda_pose_opt.STEREO_FN)):
        outside = (last["kb8_launches_before"][fn]
                   + cuda_pose_opt.KB8_LAUNCHES[fn]
                   - last["kb8_launches_after"][fn])
        require(outside == 0, f"{k3_name}: {outside} KB8 launches outside "
                f"phase 20 (a system path)")
        last["kb8"][k3_name]["launches_system"] = outside

    sources = {"K1": ("steered-BRIEF sampler", "csrc/brief.cu",
                      "orbslam3_byzyh_tpu/ops/pallas_brief.py:161",
                      "none: no single PyTorch call gathers rotated sample "
                      "pairs and packs their bits"),
               "K2": ("masked-Hamming top-2", "csrc/match.cu",
                      "orbslam3_byzyh_tpu/ops/pallas_match.py:106",
                      "none: torch has no popcount op and no masked top-2 "
                      "with this tie rule"),
               "K3": ("fused pose optimization", "csrc/pose_opt.cu",
                      "orbslam3_byzyh_tpu/solver/pallas_pose_opt.py:297",
                      "none: torch has no fused Levenberg-Marquardt solver")}

    def stereo_keys(n):
        """A kernel's launches and held calls on phase 11's paths."""
        return {
            "launches_stereo_frame_step": launches_st[n],
            "stereo_frame_step_calls": st_calls[n],
            "launches_stereo_system": {
                k: v["sequences"][0]["launches"][n]
                for k, v in stereo_sys.items()},
            "launches_stereo_system_per_frame_kind": {
                k: {kind: st["launches_per_frame"][n]
                    for kind, st in v["frame_kinds"].items()}
                for k, v in stereo_sys.items()},
            "stereo_system_calls": st_sys_calls[n],
            "launches_vi_frame_step": {
                case: vi_out["frame"][case]["launches"][n]
                for case in ("keyframe", "prior", "fallback")},
            "launches_vi_keyframe_step": vi_out["keyframe"]["launches"][n],
            "vi_frame_step_calls": vi_out["held"][n],
            "launches_vi_system": {
                k: v["sequences"][0]["launches"][n]
                for k, v in vi_sys.items() if isinstance(v, dict)},
            "launches_vi_system_per_frame_kind": {
                k: {kind: st["launches_per_frame"][n]
                    for kind, st in v["frame_kinds"].items()}
                for k, v in vi_sys.items() if isinstance(v, dict)},
            "vi_system_calls": vi_sys_calls[n],
            "launches_fisheye_extract": fish["extract"]["launches"][n],
            "fisheye_extract_calls": fish_a[n],
            "launches_fisheye_system": {
                k: v["sequences"][0]["launches"][n]
                for k, v in fish.items()
                if isinstance(v, dict) and "sequences" in v},
            "launches_fisheye_frame": {
                k: {kind: st["launches_per_frame"][n]
                    for kind, st in v["frame_kinds"].items()}
                for k, v in fish.items()
                if isinstance(v, dict) and "frame_kinds" in v},
            "fisheye_system_calls": fish_sys_calls[n],
            "launches_reloc_step": reloc["step"]["launches"][n],
            "reloc_step_calls": reloc_calls[n],
            "launches_reloc_system": {
                k: reloc[k]["sequences"][0]["launches"][n]
                for k in reloc_cells},
            "launches_reloc_frame": {
                k: {kind: st["launches_per_frame"][n]
                    for kind, st in reloc[k]["frame_kinds"].items()}
                for k in reloc_cells},
            "launches_loop_step": loop["step"]["launches"][n],
            "loop_step_calls": loop_calls[n],
            "launches_loop_system": loop["k_default"]["sequences"][0][
                "launches"][n],
            "launches_loop_frame": {
                kind: st["launches_per_frame"][n]
                for kind, st in loop["k_default"]["frame_kinds"].items()},
            "launches_merge_step": merge["step"]["launches"][n],
            "merge_step_calls": merge_calls[n],
            "launches_merge_system": {
                k: merge[k]["sequences"][0]["launches"][n]
                for k in ("l_live", "m_resume")},
            "launches_merge_frame": {
                k: {kind: st["launches_per_frame"][n]
                    for kind, st in merge[k]["frame_kinds"].items()}
                for k in ("l_live", "m_resume")},
            "launches_chessboard_system": chess["n_chessboard"][
                "sequences"][0]["launches"][n],
            "launches_chessboard_frame": {
                kind: st["launches_per_frame"][n]
                for kind, st in chess["n_chessboard"][
                    "frame_kinds"].items()},
            "launches_runner_flagship": runs["o_flagship"]["launches"][n],
            "launches_runners": {k: v["launches"][n]
                                 for k, v in runs["p_runners"].items()}}

    # K3s: no Pallas kernel; it ports the JAX package's XLA function.
    k3s_entry = {
        "name": "K3s stereo pose optimization", "route": "cuda",
        "source": "orbslam3_byzyh_tpu_torch/csrc/pose_opt.cu",
        "replaces": "orbslam3_byzyh_tpu/solver/pose_opt.py:163",
        "replaces_note": "pose_optimization_stereo, which the JAX package "
                         "runs through XLA (no pallas_call): a port kernel "
                         "for a JAX function outside Pallas",
        "launches": launches_st["K3s"],
        "max_abs_err": results["K3s"]["max_abs_err"],
        "ms": results["K3s"]["ms"], "plain_ms": results["K3s"]["plain_ms"],
        "bound_ms": results["K3s"]["bound_ms"],
        "bound_by": results["K3s"]["bound_by"], "library_ms": None,
        "library": "none: torch has no fused Levenberg-Marquardt solver",
        "wrapper_ms": results["K3s"]["wrapper_ms"],
        "bound": results["K3s"]["bound"], "ptxas": ptxas["K3"],
        "system_checked": {
            k: {"calls": v["K3s"]["calls"],
                "max_abs_err": v["K3s"]["max_abs_err"]}
            for k, v in st_checked.items()}, **stereo_keys("K3s"),
        "kb8": last["kb8"]["K3s"]}
    # P1: a port kernel for a host OpenCV function (cv2.imread's libpng
    # unfilter), not for a TPU kernel; its main path is phase 19's runners.
    t1 = runs["p1"]
    p1_entry = {
        "name": "P1 PNG unfilter", "route": "cuda",
        "source": "orbslam3_byzyh_tpu_torch/csrc/png.cu",
        "replaces": "cv2.imread (host OpenCV), no TPU kernel",
        "replaces_note": "orbslam3_byzyh_tpu/io/euroc.py:31-32, kitti.py:27-"
                         "29, tum_rgbd.py:42-44 and the native prefetcher "
                         "decode with OpenCV on the host",
        "launches": t1["launches"], "max_abs_err": t1["max_abs_err"],
        "ms": t1["ms"], "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
        "library_ms": None,
        "library": "none: torch has no PNG decode, and torchvision (decode_"
                   "png) is not installed on the card's machine",
        "wrapper_ms": t1["wrapper_ms"], "ms_paeth": t1["ms_paeth"],
        "bound": t1["bound"], "shape": t1["shape"], "ptxas": ptxas["P1"],
        "device_us": runs["o_flagship"]["p1_profiler"],
        "launches_runners": {k: v["launches"]["P1"]
                             for k, v in runs["p_runners"].items()}}
    for held in late:
        held()
    settle()
    require(not pending, "oracle comparisons left unsettled")
    last.pop("study_held")()
    print(json.dumps({"kernels": [
        {"name": f"{n} {sources[n][0]}", "route": "cuda",
         "source": f"orbslam3_byzyh_tpu_torch/{sources[n][1]}",
         "replaces": sources[n][2], "launches": launches[n],
         "launches_frame_step": launches_fs[n],
         "launches_fallback": launches_fb[n],
         "max_abs_err": results[n]["max_abs_err"],
         "ms": results[n]["ms"], "plain_ms": results[n]["plain_ms"],
         "bound_ms": results[n]["bound_ms"],
         "bound_by": results[n]["bound_by"], "library_ms": None,
         "library": sources[n][3], "wrapper_ms": results[n]["wrapper_ms"],
         "bound": results[n]["bound"], "ptxas": ptxas[n],
         "frame_step_calls": fs_calls[n],
         "launches_keyframe_step": launches_ks[n],
         "keyframe_step_calls": ks_calls[n],
         "launches_init_step": launches_init[n],
         "init_step_calls": init_calls[n],
         "launches_system": {k: v["sequences"][0]["launches"][n]
                             for k, v in system.items() if "sequences" in v},
         "launches_system_per_frame_kind": {
             k: {kind: st["launches_per_frame"][n]
                 for kind, st in v["frame_kinds"].items()}
             for k, v in system.items() if "frame_kinds" in v},
         "system_checked": {
             k: {"calls": v[n]["calls"], "max_abs_err": v[n]["max_abs_err"]}
             for k, v in sys_checked.items()},
         "system_calls": sys_calls[n], **stereo_keys(n),
         **({"kb8": last["kb8"][n]} if n in last["kb8"] else {})}
        for n in kernels] + [k3s_entry, p1_entry],
        "k2_sass_tensor_instructions":
        tensor_ops,
        "step_ms": step_med, "step_p80_ms": step_p80,
        "mono_frame_step_ms": mono_med, "mono_frame_step_p80_ms": mono_p80,
        "mono_frame_step": mono, "keyframe_step_ms": kf_med,
        "keyframe_step_p80_ms": kf_p80,
        "keyframe_step_launches_per_call": per_call,
        "keyframe_step_device_ops_per_call": kf_device_launches,
        "keyframe_step_device_ms_per_call": kf_busy_ms,
        "keyframe_step": keyframe, "init_step_ms": init_med,
        "init_step_p80_ms": init_p80, "init_step_per_call": init_per_call,
        "init_step": init, "system": system, "stereo": stereo,
        "plain32_err": plain32_err,
        "inertial": {k: v for k, v in vi_out.items() if k != "held"},
        "inertial_system": vi_sys, "fisheye": fish, "reloc": reloc,
        "loop": loop, "merge": merge, "chessboard": chess, "runners": runs,
        "last_modules": {k: v for k, v in last.items() if k != "kb8"},
        "card": card}, default=str))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
