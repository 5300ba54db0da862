#!/usr/bin/env python3
"""Builds the PyTorch port's CUDA kernels and drives its paths on one
NVIDIA GPU.

    python3 chip_smoke.py              # every phase, on one card
    python3 chip_smoke.py --sharding   # the build and the sharding phase only (any number of cards)
    python3 chip_smoke.py --bottleneck # the build and the bottleneck kernel's phase only
    python3 chip_smoke.py --blaze-block # the build and the BlazeBlock kernel's phase only
    python3 chip_smoke.py --entry-block # the build and the entry block kernel's phase only

Phases, one line of output each and each phase's wall time (any failed
check exits non-zero):

1. device: ``nvidia-smi`` name and power limit, CUDA version;
2. build: the kernels' six sources in ``zaru_tpu_torch/csrc`` (the stage
   kernel's two layouts are two), one ``nvcc`` each, all started together;
3. each kernel against its plain PyTorch version on the card: the
   rotated-ROI sampler bit for bit, in the NHWC and the planar layout, on
   coordinate-encoded 1080p frames at batch 64 with ``[B,2,5]`` slots
   (upright, tilted, frame-corner, stride 2, 3 and 4 views) on the 512-pixel
   grid, on 64×64 eye views on the 256-pixel grid (also with the right eyes
   mirrored, as the iris path samples them), on 224×224 hand views of
   150-700 px at any angle on the 256-pixel grid, and on random views
   (strides 1-8, any angle, partly outside the frame) on both grids; the
   coefficients the kernel computes for each view (``cosf``/``sinf``
   included) against the plain version's torch ops, bit for bit, on 10^6
   random rects and every angle stored in the fixtures; a profile showing
   that one call of each sampler is one kernel; the letterbox sampler bit
   for bit in both layouts on 1080p and 720p frames at 128² and 192²; the
   BlazeBlock stage kernel within ``rtol = atol = 1e-4`` on
   random weights at odd sizes whose tiles have ragged edges, one for each
   channel count it is built for (with a ReLU case and a 4-block case), and
   its refusal of 8 channels; the rotated sampler at 512×256² (Face Mesh
   V2's crops: the stored ROIs, then random views) and the letterbox at
   512×192² (full-range detection) bit for bit; the exact sampler (plain
   torch on every device) on the card bit for bit against the CPU; at
   BodyTracker's shapes, the rotated sampler on 64 square 256×256 views of
   150-900 px at any angle, partly outside the frame, on the 256-pixel grid
   (and on the views stored from JAX in ``body_track.npz``, against JAX's
   output), and the letterbox at 224², colour range [-1, 1], on 1080p and
   720p frames; the rotated sampler at StreamIdentifier's 112² crop,
   planar and NHWC, on angle-0 views of 150-900 px and at strides 1-8 on
   both grids, partly outside the frame, and on the crop rects stored from
   JAX's run (``identify.npz``), against the plain version and JAX's crops;
   the RGB→YUV kernel bit for bit on the fixture photo at 1920×1080 and on
   random images of ragged sizes; the stage kernel's NHWC variant (a
   channels_last tensor) bit for bit against the NCHW kernel on the same
   values, at the random cases above and at the ten chains of the two face
   CNNs (their weights, random inputs at batch 512), and within
   ``rtol = atol = 1e-4`` of its plain version; the two chains the stage
   plan treats apart (``onnx_dialect.npz``): 48 channels, planned node by
   node on the card as on the CPU, and 7 blocks at 128 channels, planned as
   5 + 2 (two launches), both layouts, against the CPU and JAX; the port's
   ONNX writer: its bytes of every graph of ``onnx/writer_cases.py`` equal
   to JAX's writer's (stored in ``fixtures/onnx_writer.npz``), and a
   writer-built chain of three stride-1 BlazeBlocks at 32 channels run
   through the executor at [64,32,64,64], one stage launch a call, within
   the CNN bar of the same graph on the CPU;
4. the paths against the JAX reference stored in
   ``zaru_tpu_torch/fixtures/``: ``FaceTracker`` one step at a time from
   JAX's state (flags equal, landmarks and ROI within the CPU test's
   tolerance, and with ``iris=True`` the eyes within theirs), then
   free-running (flags equal), and the same for ``redetect_bucket=1``;
   ``MultiFaceTracker`` and ``MultiHandTracker`` (``multi_track.npz``):
   detection candidates, one step at a time from JAX's state and
   free-running flags, each within the CPU tests' tolerances (``run_frame``
   and ``run_frames`` and ``fast_sampler=False`` among them); the runs of
   ``face_models_track.npz`` the same way (``FaceTracker`` with Face Mesh
   V2, with the full-range detector, ``fast_sampler=False``,
   ``run_frames``, ``run_frame`` with and without iris) and ``scan_video``
   equal to ``run_frame``; ``BodyTracker`` on the stub pose models
   (``body_track.npz``: the blobs, written to a temporary directory that
   ``ZARU_TPU_MODELS`` names, and JAX's runs): network outputs, decoders,
   candidates, then gated, ``run_frame`` and ``run_frames`` one step at a
   time and free-running, within the CPU tests' tolerances; the host
   engines and the eval sweep (``host_eval.npz``, tests/test_torch_host.py
   and tests/test_torch_eval.py): the executor's op graphs (ReduceMean,
   AveragePool, Constant) and four models at batch 1, ``Detector.detect``
   (short-range face, palm), ``Estimator.estimate`` (Face Mesh V1, both
   68-point networks), ``LandmarkTracker.track`` from JAX's ROIs and
   free-running, the loss on a blank frame, and each eval runner's reduced
   sweep on the 535×535 photo, within the CPU tests' tolerances; then the
   full sweep (8 transforms, both photos, six runners) with every identity
   row exact, the stage kernel launched by every face runner and no plain
   version of a kernel called with a CUDA tensor; the body host API on the
   stub pose models (``Detector(PoseNetwork())``,
   ``Estimator(LiteNetwork())``) and ``nms_remove_device`` (bit for bit)
   against ``host_eval.npz``; bf16 network bodies (``bf16_models.npz``,
   tests/test_torch_bf16.py): every network the bf16 trackers load at
   batches 1 and 512 against JAX's bf16 run and the port's bf16 run on the
   CPU within the test's bounds in bf16 ulps, no stage kernel launched, then
   bf16 ``FaceTracker``, ``MultiHandTracker`` and ``BodyTracker`` (stubs)
   one step at a time from JAX's state, flags equal; identification
   (``identify.npz``, tests/test_torch_identify.py): ``Embedder.embed`` and
   ``FaceIdentifier`` enrolling the cropped photo and identifying the full
   one, ``StreamIdentifier`` one step at a time from JAX's state (flags and
   identities equal) and free-running, no plain kernel version on the card;
   blend, quat, Procrustes, Dlt and approx on CUDA tensors against the
   port's CPU run, and the head pose's yaw (Face Mesh V1 on the cropped
   photo → ``ProcrustesAnalyzer``) against JAX's; the ONNX dialect
   (``onnx_dialect.npz``, tests/test_torch_onnx_ops.py, _fuzz.py,
   _layout.py): every op case (Resize's shrinks, cubic and nearest among
   them), the 50 fuzz graphs in their layouts at batch 3, and the six
   bundled models loaded ``with_layout("NHWC")`` (and bf16 with NHWC on the
   short-range detector) against JAX's stored runs at the tests'
   tolerances, the models also against the port's NCHW modules; then a
   module's second call on every Div, Resize and negative-step Slice case,
   which must copy nothing from the host;
5. the paths at full size on the bench frame (the fixture photo upscaled
   to 1920×1080, ``bench_programs.make_1080p_frame``: JAX's bench frame bit
   for bit), uploaded once, 54 steps after 9 of warm-up: ``FaceTracker.step_batch`` at
   batches 64 and 512 with detection forced every 9th step, then
   ``FaceTracker(iris=True)`` at 512; ``MultiFaceTracker(max_faces=4)`` at
   batch 128; ``MultiHandTracker(max_hands=4)`` at batch 128 tracking four
   seeded hands per stream (palm detection every 9th step), and with no
   hand in view (palm detection every step); frames/s, ms/step, active
   slots and detect steps. The kernels' launch counts are zeroed just
   before each run and read just after it; every kernel of a path must have
   launched in its run. A profile of the batch-512 face runs and of the
   tracking hand run follows, and for every run a profile with shapes of a
   detect step and a tracking step that fails if a crop is copied between
   its sampler and its network; then ``FaceTracker`` with Face Mesh V2 and
   with the full-range detector at 512 (the same cadence), and ``run_frame``
   on one stream, which must launch the stage kernel and no sampler kernel,
   each with its device busy share; ``BodyTracker`` at 512 (detection every
   9th step, both sampler kernels launched, busy share); then serving
   (``zaru_tpu_torch.serve.serve_loop`` and ``pipeline.ingest``) with 64
   in-memory sources of host 1080p frames (the photo, shifted a few pixels
   a stream): ``measure_ingest_bandwidth``, the uploader's batches against
   the staged frames by device checksums over 16 flushes with no host read
   between them, the loop bit-equal to ``run_frames_gated`` for 9 steps,
   its fresh frames/s end to end, p50/p95 ms/step, drops, host time staging
   and flushing and a 9-step profile over 54 steps after 9, beside the
   tiled main path at 64; a join's slot reset to a fresh state; one stream
   in ms/frame beside ``run_frame``; the host engines per call (host clock,
   50 calls after 5, each ending in its host read: ``Detector.detect``,
   ``Estimator.estimate``, ``LandmarkTracker.track`` on the 1280×720
   photo, each of which must launch the stage kernel) and the full sweep's
   wall time per runner; bf16 against f32 in turns (f32, bf16, bf16, f32):
   the main path at 64 and 512, hand tracking at 128 and ``run_frame``,
   each bf16 run with a 9-step profile, no stage launch and the samplers'
   launches of the f32 run; ``StreamIdentifier.run_frames`` in turns with
   the main path (FaceTracker, StreamIdentifier, StreamIdentifier,
   FaceTracker) at 64 and 512, two rotated-sampler launches a step, every
   stream identified, with a profile of the step and of its embedding pass
   at 512, and ``FaceIdentifier.enroll``/``identify`` per call; Face Mesh V1
   on the rotated views and short-range BlazeFace on the letterbox views at
   batch 512 through ``Cnn`` with NHWC-layout modules, in turns with the
   NCHW ones (NCHW, NHWC, NHWC, NCHW; each run launching only its own stage
   variant), and a 9-call profile of each counting copy kernels and crop-
   or activation-sized copies; the main path's ``step_batch`` exported
   with ``zaru_tpu_torch.export.export_fn`` at 1920×1080 and batch 512 (a
   force-detect input), reloaded through ``load_exported`` and run in
   lockstep with the eager step for 18 steps (bit-equal, or each differing
   key held to the trackers' tolerances), then timed in turns with it
   (eager, exported, exported, eager; 54 steps after 9, detection forced
   every 9th step, the rotated, letterbox and stage kernels launched inside
   the exported run), and the single-stream ``step`` exported and held bit
   for bit to ``run_frame``, timed in turns with it; ``analyze`` of
   BlazeFace and Face Mesh V1 (the same FLOPs with and without the stage
   plan) beside their measured ms/call at batch 512 and the speed of light
   at 67 TFLOP/s; the ``Trainer`` on Face Mesh V1 at batch 64 (face crops of
   the stored photo, the pretrained network's outputs as labels, weights
   perturbed from a numpy seed) on the card and on the CPU, losses and
   parameters held to the CPU run, ms/step, then inference through the
   stage kernel on the trained weights against the op-by-op graph; an async
   checkpoint of the trained parameters read back onto the card; a
   ``profiling.trace`` of one exported detect step whose file must name the
   stage and both sampler kernels. The card's machine has no image
   decoder (cv2, PIL), so file decoding is not run here: the CPU tests
   (tests/test_torch_serve.py, tests/test_torch_export.py) cover the CLI's
   inputs; then stream sharding (``zaru_tpu_torch.parallel``) over a mesh
   of every visible card, or with one card two shards on it: a
   ``FaceTracker`` built on the CPU and sharded onto the cards (a tensor the
   replica left behind would fail here), 18 ``step_gated`` steps at
   1920×1080 × 512 (detection forced every 9th) with every shard's outputs
   and state bit-equal to its own ``step_batch`` on its slice run by a
   tracker built on its card (from the main thread, so a launch for another
   card's tensor shows), ``valid`` equal to the unsharded run at 512 and
   landmarks within SHARD_LM_TOL_PX of it; then the unsharded main path,
   the sharded step, the sharded step and the unsharded one in turns (54
   steps after 9, the rotated kernel once a step per shard); ``serve_loop``
   over the sharded
   tracker at 64 streams through the sharded uploader, bit-equal to
   ``step_gated`` on the same frames uploaded at once; data-parallel
   training (``train.make_data_parallel_train_step``) of Face Mesh V1 at
   batch 64 over the mesh for 10 steps, its first loss against the
   one-device ``Trainer``'s, ms/step; the trained replicas saved and
   restored onto the mesh with ``load_params(like=)``, then with the
   largest weight sharded over the mesh (``CheckpointManager``,
   ``restore(like=)``): each shard back on its card, every leaf bit-equal;
   before bf16, the demo examples ``fused_cascade``, ``facemesh`` and
   ``identify_stream`` (``zaru_tpu_torch/examples``) in this process on the
   card for 9 frames each under ``ZARU_TPU_GUI=file`` (the photo and its
   crop fed as ``.npy`` arrays): PNG files against the frames shown, the
   launch counts of each run (the stage kernel in all three, both samplers
   in ``identify_stream``), every stream identified as the crop, ms/frame
   after the first; and ``info`` with no wrapper unported; last, the
   measurement surface (``zaru_tpu_torch/examples``: benchsuite and the
   single-purpose benches), each script's ``main`` called in this process
   on the card into a temporary ``--out``: ``benchsuite cascade`` at 512
   and at 8, ``latency`` (batches 1-64) and ``ledger`` at 512, 16 steps
   and 4 windows, the launch counts of every window of the cascade
   program held to its cadence (16 rotated-sampler launches, 2 letterbox
   launches on the forced detect steps, 8 stage launches a step and
   BlazeFace's 2 on each detect step: 132), the ledger's six stages and
   its derived row written, and ``cascade`` at 512 printed beside this
   phase's main path at 512; then every other subcommand and script once
   at a reduced size (one window, batch 64), each of which must launch
   every kernel of its path and write no error record;
6. each kernel's time at its main-path inputs (queued behind a device spin
   so the host's launch cost is hidden) beside its plain version's and its
   bound; for the samplers the whole call in the planar layout the path
   uses (one launch), the launch alone in both layouts, a lone call not
   queued, the sector figure (the distinct 32-byte sectors the index map
   reads) and the layout copy the path no longer runs; for
   the stage kernel at each of the ten chains of the two face CNNs, on the
   chain's real input and weights, checked against its plain version
   (``rtol = atol = 1e-4``), with the per-op chain it replaces timed as its
   library yardstick; the RGB→YUV kernel at 1920×1080 beside
   ``torch.matmul``; the samplers at the hand tracker's shapes; the rotated
   sampler at Face Mesh V2's 512×256² and the letterbox at the full-range
   512×192², the stage kernel's ten chains at batch 1 (``run_frame``), and
   both samplers at BodyTracker's 512×256² (256-pixel grid) and 512×224²,
   the stage kernel's ten chains at batch 1 for the host engines'
   launches, the rotated sampler at StreamIdentifier's 512×112², and the
   stage kernel's NHWC variant at the ten chains (channels_last copies of
   their real inputs, the same bound), as further entries of the JSON
   line; the bottleneck kernel (``phase_bottleneck``, alone with
   ``--bottleneck``): within the CNN bar of its plain chain on random
   weights at ragged shapes and at every chain of Face Mesh V2 (batches 512
   and 1) and the iris model (1024 and 1) on the chain's input from
   uniform inputs, timed beside its bound and the per-op chain, its
   refusal of 24 channels, ``analyze`` with and without the plan, and
   ``FaceTracker(iris=True)`` at 512 in turns with and without the plan on
   the eye network; the BlazeBlock kernel (``phase_blaze_block``, alone
   with ``--blaze-block``): within the CNN bar of its plain version on
   random weights at ragged shapes and of the per-op chain at every block
   of BlazeFace short range and Face Mesh V1 (batches 512 and 1), timed
   beside its bound and the per-op chain, ``analyze`` with and without the
   plan, a forward's counted blocks and launches, its refusals, and the
   main path's launches at 512 (phase 5's run; alone, a run of its own):
   6 a step and 11 more a detect step; the entry block kernel
   (``phase_entry_block``, alone with ``--entry-block``): within the CNN bar
   of its plain version on random weights at ragged shapes and of the
   per-op chain at every entry block of Face Mesh V2 (batches 512 and 1)
   and the iris model (1024 and 1), timed beside its bound and the per-op
   chain, ``analyze`` with and without the plan, a forward's counted blocks
   and launches (6 a V2 or iris forward, none a Face Mesh V1 or BlazeFace
   one), its refusals, and ``FaceTracker`` with Face Mesh V2 and with iris
   at 512 in turns with and without the plan (6 launches a step with it);
   phase 5's V2 and iris runs are held to 6 launches a step;
7. the launch counts of phase 5, then one JSON line of per-kernel numbers,
   then the result line.

It needs the repository checkout (the ``zaru_tpu_torch`` package beside
it) and a CUDA GPU; without either it exits non-zero and prints no result.
JAX is not used.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
STEP_TOL_PX = 1e-2  # tests/test_torch_face_cascade.py STEP_TOL_PX
EYE_RECT_TOL_PX = 1e-3  # tests/test_torch_face_cascade.py EYE_RECT_TOL_PX
EYE_TOL_PX = 1.0  # tests/test_torch_face_cascade.py EYE_TOL_PX
STAGE_TOL = 1e-4  # rtol = atol, tests/test_cnn_stage.py:42
# The repo's CNN bar, |got − want| ≤ CNN_ATOL·max(1, |want|max) + CNN_RTOL·|want|
# (zaru_tpu_torch/onnx/dialect_cases.py "cnn", tests/test_torch_onnx_writer.py).
CNN_ATOL, CNN_RTOL = 1e-3, 2e-3
WRITER_BATCH = 64  # the writer-built BlazeBlock chain's batch on the card (phase 3)
EXAMPLE_FRAMES = 9  # frames of each demo example on the card (phase 5)
# tests/test_torch_multi_object.py: (px, score) one-step tolerances of a
# step that tracks carried slots and of one that seeds a slot from a new
# detection; detection candidates (px, rad).
MULTI_STEP_TOLS = (1e-2, 1e-5)
MULTI_SEED_TOLS = (0.25, 1e-3)
CAND_TOL_PX, CAND_TOL_RAD = 1e-3, 1e-5
# tests/test_torch_face_models.py: one-step tolerances of the face-model,
# exact-sampler, ungated and single-stream runs (landmarks and ROIs in px,
# confidence, eyes in px).
MODEL_STEP_TOL_PX, MODEL_SCORE_TOL, MODEL_EYE_TOL_PX = 1e-2, 1e-5, 1.0
# tests/test_torch_body.py: BodyTracker's one-step tolerances (landmarks and
# ROIs in px, scores) and the candidate ROIs on random keypoints (px).
BODY_TOL_PX, BODY_SCORE_TOL, BODY_NORM_TOL_PX = 1e-3, 1e-6, 1e-4
BODY_BLOBS = {"blob_pose_detection": ("pose_detection.onnx",),
              "blob_pose_landmark": ("pose_landmark_lite.onnx", "pose_landmark_full.onnx")}
SERVE_STREAMS = 64  # streams of the serving runs (2 staging buffers: 1.06 GB pinned)
# tests/test_torch_bf16.py: each network the bf16 trackers load (ONNX file,
# colour range, output selection), the seed of its inputs, its tolerance in
# bf16 ulps of max(1, |out|max) against JAX's bf16 run, and the trackers'
# one-step tolerances (px: a tracking step, a step seeding a slot from a
# detection; scores).
BF16_NETS = {
    "short_range": ("face_detection_short_range.onnx", (-1.0, 1.0), None),
    "full_range": ("face_detection_full_range.onnx", (-1.0, 1.0), None),
    "face_mesh_v1": ("face_landmark.onnx", (-1.0, 1.0), None),
    "face_mesh_v2": ("face_landmarks_detector.onnx", (-1.0, 1.0), None),
    "palm_lite": ("palm_detection_lite.onnx", (0.0, 1.0), None),
    "hand_lite": ("hand_landmark_lite.onnx", (0.0, 1.0), None),
    "pose_detection_stub": ("pose_detection.onnx", (-1.0, 1.0), None),
    "pose_landmark_stub": ("pose_landmark_lite.onnx", (0.0, 1.0), [0, 1]),
}
BF16_NET_SEED = 21
BF16_NET_TOL_ULPS = {"short_range": 4, "full_range": 4, "face_mesh_v1": 4, "face_mesh_v2": 24,
                     "palm_lite": 4, "hand_lite": 4, "pose_detection_stub": 0, "pose_landmark_stub": 0}
BF16_TRACK_TOL_PX = {"face": (4.0, 4.0), "hand": (8.0, 40.0), "body": (1e-3, 1e-3)}
BF16_TRACK_SCORE_TOL = 0.05
BF16_VALUE_KEYS = ("landmarks", "roi", "rois", "confidence", "presence", "handedness", "pose_flag", "visibility")
# Rows of the batch-512 network runs compared with the port on the CPU.
BF16_CPU_ROWS = [0, 1, 2, 3, 137, 300, 511]
# tests/test_torch_identify.py: unit-sphere distances, crop rects from
# JAX's ROIs (px); tests/test_torch_pose3d.py: blend against the CPU (u8
# steps), quaternions and Kabsch rotations against the CPU, the head pose's
# yaw against JAX's (degrees).
ID_DIST_TOL, ID_CROP_RECT_TOL_PX = 1e-3, 1e-3
POSE_BLEND_MAX_STEP, POSE_QUAT_TOL, POSE_ROT_TOL, POSE_YAW_TOL_DEG = 1, 1e-5, 1e-4, 1e-2
VIEW_CASES = [  # (cx, cy, w, h, theta), tests/test_torch_samplers.py
    (960, 540, 300, 300, 0.0),
    (500, 400, 192, 192, 0.0),
    (960, 540, 300, 300, 0.25),
    (700, 500, 400, 400, -0.25),
    (1300, 600, 350, 350, 0.55),
    (600, 300, 250, 250, 0.8),
    (60, 60, 300, 300, 1.2),        # frame corner, reads out of bounds
    (960, 540, 836, 836, 0.0),      # stride 2
    (960, 540, 836, 836, 0.7),      # stride 3
    (1500, 700, 420, 360, -0.8),
    (960, 540, 1600, 1600, 0.0),    # bbox > 1536: stride 4
    (900, 500, 320, 320, -0.55),
]


# Kernel-name substrings grouping the profile's device time, first match
# wins: cuDNN's convolution kernels before the matrix products (Gemm).
PROFILE_GROUPS = [
    ("blaze_stage", ("blaze_stage_kernel",)),
    ("blaze_block", ("blaze_block_kernel",)),
    ("entry_block", ("entry_block_kernel",)),
    ("samplers", ("rotated_sample_kernel", "letterbox_sample_kernel")),
    ("convolution", ("conv", "fprop", "implicit", "cudnn", "winograd")),
    ("gemm", ("gemm", "gemv", "xmma")),
    ("upsample", ("upsample",)),
    ("elementwise", ("elementwise",)),
    ("copy/pad/cat", ("copy", "Cat", "pad", "Pad")),
    ("reduce", ("reduce",)),
]


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def coord_frames(torch, n, H, W, device):
    """n coordinate-encoded RGBA frames (RGB encodes x, y), shifted by 7 px
    per stream so a wrong frame index shows."""
    x = torch.arange(W, device=device)[None, :].expand(H, W)
    y = torch.arange(H, device=device)[:, None].expand(H, W)
    base = torch.stack([x & 255, (x >> 8) * 16 + (y >> 8), y & 255, torch.full_like(x, 255)], -1)
    base = base.to(torch.uint8)
    return torch.stack([torch.roll(base, 7 * i, dims=1) for i in range(n)])


def cuda_ms(torch, fn, reps=50, queued=False):
    """Mean time of ``fn`` in ms over ``reps`` calls, after one warm-up
    call, from CUDA events. ``queued``: the device first spins ~10 ms while
    the host queues all ``reps`` calls, so a call whose launch costs the host
    more than its kernel costs the device is timed by its kernel alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernels_in(torch, fn):
    """The device kernels ``fn()`` issues, by name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def random_views(torch, gen, n, m, device):
    """``n`` rects at random: centres inside and outside a 1920×1080 frame,
    sizes that give strides 1 to 8 on the ``m``-pixel grid, any angle."""
    u = lambda lo, hi: lo + torch.rand(n, generator=gen) * (hi - lo)  # noqa: E731
    return torch.stack([u(-300, 2200), u(-300, 1400), u(10, 0.69 * 8 * m), u(10, 0.69 * 8 * m),
                        u(-3.14159265, 3.14159265)], -1).to(device)


def check_rotated(torch, label, frames, rects, size, lo, hi, m, mirror=None):
    """The rotated sampler's kernel against its plain version, bit for bit,
    in both layouts. → the NHWC output."""
    from zaru_tpu_torch.ops.rotated_fast import rotated_sample_fast, rotated_sample_fast_reference

    out = {}
    for layout in ("NHWC", "NCHW"):
        got = rotated_sample_fast(frames, rects, size, size, lo, hi, m, layout, mirror)
        want = rotated_sample_fast_reference(frames, rects, size, size, lo, hi, m, layout, mirror)
        torch.cuda.synchronize()
        out[layout] = int((got != want).sum()), got
    black = int((out["NHWC"][1] == lo).all(-1).sum())
    print(f"rotated_sample vs plain, {label}: {tuple(out['NHWC'][1].shape)} on the {m}-px grid"
          f"{', mirror ' + str(mirror) if mirror else ''}: {out['NHWC'][0]} values differ (NHWC), "
          f"{out['NCHW'][0]} (planar); {black} black pixels", flush=True)
    check(out["NHWC"][0] == 0 and out["NCHW"][0] == 0,
          f"rotated_sample kernel disagrees with its plain version ({label})")
    return out["NHWC"][1]


def check_coefs(torch, np, gen, device):
    """The kernel's per-view coefficients (its ``cosf``/``sinf`` among them)
    against :func:`sampler_coefs`'s torch ops on the card: 10^6 rects with
    angles over [-π, π], then every angle stored in the fixtures."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.ops.rotated_fast import kernel_coefs, sampler_coefs

    angles = []
    for name in ("sad_linus_track.npz", "multi_track.npz"):
        with np.load(fixture_path(name)) as f:
            angles += [f[k][..., 4].ravel() for k in f.files
                       if f[k].dtype == np.float32 and f[k].ndim >= 2 and f[k].shape[-1] == 5]
    stored = random_views(torch, gen, sum(a.size for a in angles), 512, device)
    stored[:, 4] = torch.from_numpy(np.concatenate(angles)).to(device)
    for label, rects in (("10^6 random rects", random_views(torch, gen, 10**6, 512, device)),
                         (f"{stored.shape[0]} fixture angles", stored)):
        for m in (512, 256):
            got, igot = kernel_coefs(rects, m)
            want, iwant = sampler_coefs(rects, m)
            torch.cuda.synchronize()
            trig = int((got[:, 2:4] != want[:, 2:4]).any(-1).sum())
            rows = int(((got != want).any(-1) | (igot != iwant).any(-1)).sum())
            print(f"rotated_sample coefficients in the kernel vs sampler_coefs on the card, {label}, "
                  f"{m}-px grid: {trig} angles whose cos or sin differ, {rows} views whose coefficients "
                  f"differ", flush=True)
            check(rows == 0, f"the kernel's coefficients differ from sampler_coefs ({label}, m={m})")


def phase_kernels_vs_plain(torch, device):
    import numpy as np

    from zaru_tpu_torch.ops.cnn_stage import _tiling, blaze_blocks_reference, fused_blocks, pack_blocks
    from zaru_tpu_torch.ops.letterbox import letterbox_sample, letterbox_sample_reference
    from zaru_tpu_torch.ops.letterbox import letterbox_sample_planar_reference
    from zaru_tpu_torch.ops.rotated_fast import rotated_sample_fast
    from zaru_tpu_torch.pipeline import _ops
    from zaru_tpu_torch.resolution import Resolution

    gen = torch.Generator(device="cpu").manual_seed(0)
    B = 64
    frames = coord_frames(torch, B, 1080, 1920, device)
    cases = torch.tensor(VIEW_CASES, dtype=torch.float32)
    idx = torch.arange(2 * B) % len(VIEW_CASES)
    jitter = (torch.rand((2 * B, 5), generator=gen) - 0.5) * torch.tensor([40.0, 40.0, 10.0, 10.0, 0.04])
    rects = (cases[idx] + jitter * (torch.arange(2 * B) >= len(VIEW_CASES))[:, None])
    rects = rects.reshape(B, 2, 5).to(device)
    got = check_rotated(torch, "the test views, jittered", frames, rects, 192, -1.0, 1.0, 512)
    check(bool((got == -1.0).all(-1).any()), "no view of the set reads outside the frame")

    # Eye crops: square 64x64 views of 60-460 px at any angle, 256-px grid,
    # as the iris path samples them (right eyes mirrored) and unmirrored.
    eye = torch.stack([
        torch.rand(2 * B, generator=gen) * 1920, torch.rand(2 * B, generator=gen) * 1080,
        60 + torch.rand(2 * B, generator=gen) * 400, torch.zeros(2 * B),
        (torch.rand(2 * B, generator=gen) - 0.5) * 6.0,
    ], -1)
    eye[:, 3] = eye[:, 2]
    eye = eye.reshape(B, 2, 5).to(device)
    check_rotated(torch, "eye views", frames, eye, 64, -1.0, 1.0, 256)
    check_rotated(torch, "eye views", frames, eye, 64, -1.0, 1.0, 256, mirror=(False, True))

    # Hand crops: square 224x224 views of 150-700 px (strides 1-3) at any
    # angle, four slots per frame, 256-px grid, colour range [0, 1].
    hand = torch.stack([
        torch.rand(4 * B, generator=gen) * 1920, torch.rand(4 * B, generator=gen) * 1080,
        150 + torch.rand(4 * B, generator=gen) * 550, torch.zeros(4 * B),
        (torch.rand(4 * B, generator=gen) - 0.5) * 6.3,
    ], -1)
    hand[:, 3] = hand[:, 2]
    hand = hand.reshape(B, 4, 5).to(device)
    check_rotated(torch, "hand views", frames, hand, 224, 0.0, 1.0, 256)
    for m in (512, 256):
        check_rotated(torch, "random views (strides 1-8, any angle, partly outside)", frames,
                      random_views(torch, gen, 2 * B, m, device).reshape(B, 2, 5), 192, -1.0, 1.0, m)
    check_coefs(torch, np, gen, device)
    names = kernels_in(torch, lambda: rotated_sample_fast(frames, rects, 192, 192, -1.0, 1.0, layout="NCHW"))
    names_iris = kernels_in(torch, lambda: rotated_sample_fast(
        frames, eye, 64, 64, -1.0, 1.0, 256, "NCHW", (False, True)))
    print(f"one CUDA call of rotated_sample_fast issues {len(names)} kernel(s): {names}; "
          f"with mirrored slots {len(names_iris)}", flush=True)
    check(len(names) == 1 and len(names_iris) == 1 and "rotated_sample_kernel" in names[0],
          "a call of rotated_sample_fast issues more than its one kernel")

    for H, W in ((1080, 1920), (720, 1280)):
        frames = torch.randint(0, 256, (8, H, W, 4), generator=gen, dtype=torch.uint8).to(device)
        _fit, fit_rrect = _ops.full_frame_fit(frames, Resolution(128, 128))
        rr = fit_rrect.expand(8, 5).clone()
        rr[4:, 0] += torch.tensor([-300.0, 200.0, 31.3, 700.0], device=device)
        rr[4:, 2:4] *= 0.61
        for size in (128, 192):
            got = letterbox_sample(frames, rr, size, size, -1.0, 1.0)
            want = letterbox_sample_reference(frames, rr, size, size, -1.0, 1.0)
            got_p = letterbox_sample(frames, rr, size, size, -1.0, 1.0, layout="NCHW")
            want_p = letterbox_sample_planar_reference(frames, rr, size, size, -1.0, 1.0)
            torch.cuda.synchronize()
            differ, differ_p = int((got != want).sum()), int((got_p != want_p).sum())
            print(f"letterbox_sample vs plain at {W}x{H}: {tuple(got.shape)}, {differ} values differ "
                  f"(NHWC), {differ_p} (planar)", flush=True)
            check(differ == 0 and differ_p == 0, "letterbox_sample kernel disagrees with its plain version")
    names = kernels_in(torch, lambda: letterbox_sample(frames, rr, 128, 128, -1.0, 1.0, layout="NCHW"))
    print(f"one CUDA call of letterbox_sample issues {len(names)} kernel(s): {names}", flush=True)
    check(len(names) == 1, "a call of letterbox_sample issues more than its one kernel")

    # Random weights at sizes the face CNNs do not have, each channel count
    # the kernel is built for: 12x20, 9x21 and 7x13 fit one tile, the others
    # are tiled, all but 50x70 with ragged edges. 16 and 24 channels keep the
    # depthwise in registers (9x21: one pixel a thread), except on regions
    # of at most 128 pixels (7x13).
    for C, H, W, nb, relu in ((32, 12, 20, 3, False), (16, 37, 53, 3, False), (24, 50, 70, 2, False),
                              (64, 29, 31, 2, False), (96, 19, 23, 4, False), (128, 13, 17, 2, True),
                              (16, 9, 21, 2, False), (24, 7, 13, 2, False)):
        blocks = [{
            "dw_w": torch.randn((C, 1, 3, 3), generator=gen) * 0.3,
            "dw_b": torch.randn(C, generator=gen) * 0.1,
            "pw_w": torch.randn((C, C, 1, 1), generator=gen) * 0.3,
            "pw_b": torch.randn(C, generator=gen) * 0.1,
            "alpha": None if relu else torch.rand(C, generator=gen) * 0.25 + 0.05,
        } for _ in range(nb)]
        x = torch.randn((512, C, H, W), generator=gen).to(device)
        packed = pack_blocks(blocks, C).to(device)
        got = fused_blocks(x, packed, H, W, C)
        got_nhwc = fused_blocks(x.contiguous(memory_format=torch.channels_last), packed, H, W, C)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            want = blaze_blocks_reference(
                x, [{k: None if v is None else v.to(device) for k, v in b.items()} for b in blocks])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= STAGE_TOL + STAGE_TOL * want.abs()).all())
        nhwc_differ = int((got_nhwc != got).sum())
        print(f"blaze_stage vs plain, random weights, [512,{C},{H},{W}] x {nb} blocks"
              f"{' (ReLU)' if relu else ''} (tiles {_tiling(C, H, W, nb)[:2]}): max abs err {err}; the NHWC "
              f"variant on the channels_last copy: {nhwc_differ} values differ from the NCHW kernel", flush=True)
        check(ok, "blaze_stage kernel disagrees with its plain version")
        check(nhwc_differ == 0 and got_nhwc.is_contiguous(memory_format=torch.channels_last),
              "the NHWC stage variant is not bit-equal to the NCHW kernel (or not channels_last)")
    try:
        fused_blocks(torch.zeros((2, 8, 6, 6), device=device), torch.zeros((1, 8 * 8 + 12 * 8), device=device),
                     6, 6, 8)
    except ValueError as e:
        print(f"blaze_stage refuses 8 channels on the card: {e}", flush=True)
    else:
        check(False, "fused_blocks launched a stage of 8 channels, which the kernel is not built for")


def phase_slice_shapes_vs_plain(torch, np, device, rgba):
    """The samplers at this slice's shapes against their plain versions,
    bit for bit: the rotated kernel at 512×256² (Face Mesh V2's crops on the
    512-pixel grid: every ROI stored in face_models_track.npz, then random
    views at strides 1-8), the letterbox at 512×192² (full-range detection,
    colour range [-1, 1]); and the exact sampler (plain torch on every
    device) on the card against the same function on the CPU: the stored
    ROIs on the photo at 192², 256² and 64² (right eyes mirrored), and
    random views at 224² on coordinate frames."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.ops.letterbox import letterbox_sample, letterbox_sample_reference
    from zaru_tpu_torch.ops.letterbox import letterbox_sample_planar_reference
    from zaru_tpu_torch.ops.sampling import view_to_tensor_core
    from zaru_tpu_torch.pipeline import _ops
    from zaru_tpu_torch.resolution import Resolution

    gen = torch.Generator(device="cpu").manual_seed(2)
    with np.load(fixture_path("face_models_track.npz")) as f:
        rois = torch.from_numpy(np.concatenate(
            [f[k].reshape(-1, 5) for k in f.files if k.endswith(("state_roi", "out_roi"))]))
    n = rois.shape[0] - rois.shape[0] % 2
    rois = rois[:n]
    frames = coord_frames(torch, 64, 1080, 1920, device)
    v2 = _ops.aspect_view_rect(rois, Resolution(256, 256))
    rects = torch.cat([v2, random_views(torch, gen, 512 - n, 512, "cpu")]).reshape(64, 8, 5).to(device)
    check_rotated(torch, f"512 views at 256x256 ({n} stored ROIs, then random)", frames, rects, 256,
                  -1.0, 1.0, 512)

    frames512 = frames.repeat(8, 1, 1, 1)
    _fit, fit_rrect = _ops.full_frame_fit(frames512, Resolution(192, 192))
    rr = fit_rrect.expand(512, 5).contiguous()
    got = letterbox_sample(frames512, rr, 192, 192, -1.0, 1.0)
    want = letterbox_sample_reference(frames512, rr, 192, 192, -1.0, 1.0)
    got_p = letterbox_sample(frames512, rr, 192, 192, -1.0, 1.0, layout="NCHW")
    want_p = letterbox_sample_planar_reference(frames512, rr, 192, 192, -1.0, 1.0)
    torch.cuda.synchronize()
    differ, differ_p = int((got != want).sum()), int((got_p != want_p).sum())
    print(f"letterbox_sample vs plain at the full-range shape: {tuple(got_p.shape)} from 1920x1080, "
          f"{differ} values differ (NHWC), {differ_p} (planar)", flush=True)
    check(differ == 0 and differ_p == 0, "letterbox_sample disagrees with its plain version at 512x192^2")
    del frames512, got, want, got_p, want_p

    photo = rgba.expand(n // 2, *rgba.shape).contiguous()
    cases = [("stored ROIs", photo, _ops.aspect_view_rect(rois, Resolution(s, s)).reshape(-1, 2, 5), s, None)
             for s in (192, 256)]
    eyes = _ops.aspect_view_rect(rois * torch.tensor([1, 1, 0.35, 0.35, 1]), Resolution(64, 64))
    cases.append(("stored ROIs as eyes", photo, eyes.reshape(-1, 2, 5), 64, (False, True)))
    random = random_views(torch, gen, 128, 512, "cpu").reshape(64, 2, 5)
    cases.append(("random views", frames, random, 224, None))
    for label, fr, rects, size, mirror in cases:
        got = view_to_tensor_core(fr, rects.to(device), size, size, -1.0, 1.0, "NCHW", mirror).cpu()
        want = view_to_tensor_core(fr.cpu(), rects, size, size, -1.0, 1.0, "NCHW", mirror)
        # torch's cos and sin of a view's angle on the card and on the CPU
        # (its own library on each) can differ by an ulp and move a pixel.
        th = rects[..., 4]
        trig = ((torch.cos(th.to(device)).cpu() == torch.cos(th))
                & (torch.sin(th.to(device)).cpu() == torch.sin(th)))
        differ = (got != want).flatten(2).any(-1)  # per view
        print(f"exact sampler on the card vs on the CPU, {label}: {tuple(got.shape)}"
              f"{', mirror ' + str(mirror) if mirror else ''}: {int(differ.sum())} views differ; "
              f"{int((~trig).sum())} of {trig.numel()} angles whose cos or sin differ between the devices, "
              f"{int((differ & ~trig).sum())} views differ among them", flush=True)
        check(not (differ & trig).any(), f"the exact sampler's CUDA output differs from its CPU output ({label})")
        check(label == "random views" or not differ.any(),
              f"the exact sampler's CUDA output differs from its CPU output on the {label}")


def phase_yuv_vs_plain(torch, img, device):
    """The RGB→YUV kernel bit for bit against its plain version: the photo
    at 1920×1080 in [0, 1], and random images whose pixel counts are not a
    multiple of the kernel's 4-pixel vector."""
    from zaru_tpu_torch.ops.yuv import rgb_to_yuv_fast, rgb_to_yuv_fast_reference

    gen = torch.Generator(device="cpu").manual_seed(1)
    rgb = img[..., :3].float() / 255.0
    for x in (rgb, torch.rand((37, 53, 3), generator=gen).to(device),
              torch.rand((1081, 1917, 3), generator=gen).to(device)):
        got, want = rgb_to_yuv_fast(x), rgb_to_yuv_fast_reference(x)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        print(f"rgb_to_yuv vs plain at {x.shape[1]}x{x.shape[0]}: {differ} values differ, "
              f"max abs err {float((got - want).abs().max())}", flush=True)
        check(differ == 0, "rgb_to_yuv kernel disagrees with its plain version")
    return rgb


def load_photo(torch, np, device):
    """The fixture photo as RGBA u8 on the card: as stored (1280×720), and
    the bench frame (``bench_programs.make_1080p_frame``: the photo upscaled
    to 1920×1080 by OpenCV's bilinear rule, JAX's bench frame bit for bit),
    uploaded once."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.bench_programs import make_1080p_frame

    with np.load(fixture_path("sad_linus_track.npz")) as f:
        rgb = torch.from_numpy(f["rgb"]).to(device)
    rgba = torch.cat([rgb, torch.full_like(rgb[..., :1], 255)], -1)
    return rgba, torch.from_numpy(make_1080p_frame()).to(device)


def phase_vs_jax(torch, np, device, rgba):
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.pipeline import FaceTracker

    with np.load(fixture_path("sad_linus_track.npz")) as f:
        ref = {k: f[k] for k in f.files}
    batch = ref["state_roi"].shape[1]
    tracker = FaceTracker(device=device)

    def frames_for(t, prefix=""):
        frames = rgba.expand(batch, *rgba.shape).clone()
        if ref[prefix + "zero"][t] >= 0:
            frames[int(ref[prefix + "zero"][t])] = 0
        return frames

    def state_at(t, prefix=""):
        return {
            "roi": torch.from_numpy(ref[prefix + "state_roi"][t]).to(device),
            "tracking": torch.from_numpy(ref[prefix + "state_tracking"][t]).to(device),
            "filter": {k: torch.from_numpy(ref[f"{prefix}state_{k}"][t]).to(device)
                       for k in ("x", "dx", "init")},
        }

    lm_err = roi_err = 0.0
    for t, force in enumerate(ref["force"]):
        _, out = tracker.step_batch(state_at(t), frames_for(t), bool(force))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        check((out["valid"] == ref["valid"][t]).all(), f"step {t}: tracking flags differ from JAX")
        lm_err = max(lm_err, float(np.abs(out["landmarks"] - ref["landmarks"][t]).max()))
        roi_err = max(roi_err, float(np.abs(out["roi"] - ref["roi"][t]).max()))
    print(f"main path vs JAX reference, one step at a time over {len(ref['force'])} steps "
          f"at batch {batch}: max landmark error {lm_err:.6f} px, max ROI error {roi_err:.6f} px "
          f"(tolerance {STEP_TOL_PX} px)", flush=True)
    check(lm_err <= STEP_TOL_PX and roi_err <= STEP_TOL_PX, "main path disagrees with JAX")

    state = tracker.init_state(batch)
    for t, force in enumerate(ref["force"]):
        state, out = tracker.step_batch(state, frames_for(t), bool(force))
        check((out["valid"].cpu().numpy() == ref["valid"][t]).all(),
              f"free-running step {t}: tracking flags differ from JAX")
    print("main path free-running: tracking flags equal to JAX at every step", flush=True)

    iris = FaceTracker(iris=True, device=device)
    rect_err = given_err = 0.0
    for t in range(len(ref["force"])):
        frames, pos = frames_for(t), torch.from_numpy(ref["landmarks"][t]).to(device)
        rects = iris._eye_view_rects(pos).cpu().numpy()
        rect_err = max(rect_err, float(np.abs(rects - ref["eye_rects"][t]).max()))
        eyes = iris._iris_views(frames, torch.from_numpy(ref["eye_rects"][t]).to(device)).cpu().numpy()
        given_err = max(given_err, float(np.abs(eyes - ref["eyes"][t]).max()))
    print(f"iris vs JAX reference on JAX's landmarks: eye rects within {rect_err:.6f} px; eyes from "
          f"JAX's eye rects within {given_err:.6f} px (tolerance {EYE_RECT_TOL_PX} px)", flush=True)
    check(rect_err <= EYE_RECT_TOL_PX and given_err <= EYE_RECT_TOL_PX, "iris disagrees with JAX")

    lm_err = eye_err = 0.0
    for t, force in enumerate(ref["force"]):
        _, out = iris.step_batch(state_at(t), frames_for(t), bool(force))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        check(out["eyes"].shape == ref["eyes"][t].shape and np.isfinite(out["eyes"]).all(),
              f"iris step {t}: eyes of shape {out['eyes'].shape}")
        check((out["valid"] == ref["valid"][t]).all(), f"iris step {t}: tracking flags differ from JAX")
        lm_err = max(lm_err, float(np.abs(out["landmarks"] - ref["landmarks"][t]).max()))
        eye_err = max(eye_err, float(np.abs(out["eyes"] - ref["eyes"][t]).max()))
    print(f"iris vs JAX reference, one step at a time: max landmark error {lm_err:.6f} px "
          f"(tolerance {STEP_TOL_PX} px), max eye error {eye_err:.6f} px (tolerance {EYE_TOL_PX} px)",
          flush=True)
    check(lm_err <= STEP_TOL_PX and eye_err <= EYE_TOL_PX, "iris disagrees with JAX")

    bucket = FaceTracker(redetect_bucket=1, device=device)
    lm_err = roi_err = 0.0
    state = bucket.init_state(batch)
    for t, force in enumerate(ref["bucket_force"]):
        frames = frames_for(t, "bucket_")
        _, out = bucket.step_batch(state_at(t, "bucket_"), frames, bool(force))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        check((out["valid"] == ref["bucket_valid"][t]).all(),
              f"redetect_bucket step {t}: tracking flags differ from JAX")
        lm_err = max(lm_err, float(np.abs(out["landmarks"] - ref["bucket_landmarks"][t]).max()))
        roi_err = max(roi_err, float(np.abs(out["roi"] - ref["bucket_roi"][t]).max()))
        state, out = bucket.step_batch(state, frames, bool(force))
        check((out["valid"].cpu().numpy() == ref["bucket_valid"][t]).all(),
              f"redetect_bucket free-running step {t}: tracking flags differ from JAX")
    print(f"FaceTracker(redetect_bucket=1) vs JAX reference over {len(ref['bucket_force'])} steps: "
          f"one step at a time max landmark error {lm_err:.6f} px, max ROI error {roi_err:.6f} px "
          f"(tolerance {STEP_TOL_PX} px); free-running flags equal at every step", flush=True)
    check(lm_err <= STEP_TOL_PX and roi_err <= STEP_TOL_PX, "redetect_bucket disagrees with JAX")


def stored_tracker(cls, kwargs, device):
    """Tracker ``cls`` of a stored run's keyword arguments (the networks
    named by class)."""
    import zaru_tpu_torch.face.detection as tdet
    import zaru_tpu_torch.face.landmark.mediapipe as tmesh
    import zaru_tpu_torch.pipeline as tp

    kwargs = dict(kwargs)
    if "landmarker" in kwargs:
        kwargs["landmarker"] = getattr(tmesh, kwargs["landmarker"])(device=device)
    if "detector" in kwargs:
        kwargs["detector"] = getattr(tdet, kwargs["detector"])(device=device)
    return getattr(tp, cls)(device=device, **kwargs)


def phase_face_models_vs_jax(torch, np, device, rgba):
    """Each run of ``face_models_track.npz`` (see
    tests/test_torch_face_models.py): FaceMeshV2, FullRangeNetwork and
    ``fast_sampler=False`` gated, ``run_frames``, ``run_frame`` (with iris
    too): one step at a time from JAX's state, then free-running flags; and
    ``scan_video`` against ``run_frame`` on the card, bit for bit."""
    from zaru_tpu_torch.assets import fixture_path

    with np.load(fixture_path("face_models_track.npz")) as f:
        ref = {k: f[k] for k in f.files}
    for run in sorted({k.split("__")[0] for k in ref}):
        r = lambda k: ref[f"{run}__{k}"]  # noqa: E731
        kwargs, entry = json.loads(str(r("kwargs"))), str(r("entry"))
        tracker = stored_tracker("FaceTracker", kwargs, device)
        single = entry == "run_frame"
        batch = 1 if single else r("state_roi").shape[1]

        def frames_for(t):
            frames = rgba.expand(max(batch, 1), *rgba.shape).clone()
            if r("zero")[t] >= 0:
                frames[int(r("zero")[t])] = 0
            return frames[0] if single else frames

        def state_at(t):
            at = lambda k: torch.from_numpy(np.asarray(r(f"state_{k}")[t])).to(device)  # noqa: E731
            return {"roi": at("roi"), "tracking": at("tracking"),
                    "filter": {k: at(k) for k in ("x", "dx", "init")}}

        def step(state, t):
            frames, force = frames_for(t), bool(r("force")[t])
            if entry == "gated":
                return tracker.step_batch(state, frames, force)
            if entry == "run_frames":
                return tracker.run_frames(state, frames)
            return tracker.run_frame(state, frames)

        errs = {}
        state, outs = tracker.init_state(None if single else batch), []
        for t in range(len(r("force"))):
            _, out = step(state_at(t), t)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            check((out["valid"] == r("out_valid")[t]).all(), f"{run} step {t}: flags differ from JAX")
            for k, tol in (("landmarks", MODEL_STEP_TOL_PX), ("roi", MODEL_STEP_TOL_PX),
                           ("confidence", MODEL_SCORE_TOL), ("eyes", MODEL_EYE_TOL_PX)):
                if k in out:
                    err = float(np.abs(out[k] - r(f"out_{k}")[t]).max())
                    check(err <= tol, f"{run} step {t}: {k} differs from JAX by {err} (tolerance {tol})")
                    errs[k] = max(errs.get(k, 0.0), err)
            state, out = step(state, t)
            outs.append(out)
            check((out["valid"].cpu().numpy() == r("out_valid")[t]).all(),
                  f"{run} free-running step {t}: flags differ from JAX")
        scan = ""
        if single:
            frames = torch.stack([frames_for(t) for t in range(len(r("force")))])
            _, scanned = tracker.scan_video(tracker.init_state(), frames)
            same = all(torch.equal(v, torch.stack([o[k] for o in outs])) for k, v in scanned.items())
            check(same, f"{run}: scan_video differs from run_frame")
            scan = "; scan_video equals run_frame bit for bit"
        print(f"FaceTracker({', '.join(f'{k}={v}' for k, v in kwargs.items())}).{entry} vs JAX reference "
              f"over {len(r('force'))} steps: one step at a time max errors "
              f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tolerances {MODEL_STEP_TOL_PX} px, "
              f"{MODEL_SCORE_TOL}, eyes {MODEL_EYE_TOL_PX} px); free-running flags equal at every step{scan}",
              flush=True)


def phase_multi_vs_jax(torch, np, device, rgba):
    """Each run of ``multi_track.npz`` (see tests/test_torch_multi_object.py;
    ``MultiFaceTracker`` with Face Mesh V2, whose tongue score is ``extra0``,
    and with the full-range detector among them): detection candidates on
    the photo, one step at a time from JAX's state, and free-running
    flags."""
    from zaru_tpu_torch.assets import fixture_path

    with np.load(fixture_path("multi_track.npz")) as f:
        ref = {k: f[k] for k in f.files}
    for run in sorted({k.split("__")[0] for k in ref}):
        r = lambda k: ref[f"{run}__{k}"]  # noqa: E731
        cls, kwargs = str(r("tracker")), json.loads(str(r("kwargs")))
        entry = str(r("entry")) if f"{run}__entry" in ref else "gated"
        tracker = stored_tracker(cls, kwargs, device)
        batch = r("zero").shape[1]

        def frames_for(zero):
            frames = rgba.expand(batch, *rgba.shape).clone()
            frames[torch.from_numpy(zero).to(device)] = 0
            return frames

        def state_at(t):
            return {k: torch.from_numpy(np.asarray(r(f"state_{k}")[t])).to(device)
                    for k in ("rois", "active", "frame")}

        def step(state, frames, force):
            if entry == "run_frame":  # stream 0's frame
                return tracker.run_frame(state, frames[0])
            if entry == "run_frames":
                return tracker.run_frames(state, frames)
            return tracker.step_batch(state, frames, force)

        rois, valid = tracker._detect_batch(frames_for(np.zeros(batch, bool)))
        check((valid.cpu().numpy() == r("cand_valid")).all(), f"{run}: detection flags differ from JAX")
        cand = np.abs(rois.cpu().numpy() - r("cand_rois"))
        check(cand[..., :4].max() <= CAND_TOL_PX and cand[..., 4].max() <= CAND_TOL_RAD,
              f"{run}: detection candidates differ from JAX by {cand.max((0, 1))}")
        errs = {}
        state = None
        for t, force in enumerate(r("force")):
            frames = frames_for(r("zero")[t])
            start = state_at(t)
            _, out = step(start, frames, bool(force))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            check((out["valid"] == r("out_valid")[t]).all(), f"{run} step {t}: flags differ from JAX")
            seeded = (r("out_valid")[t] & ~r("state_active")[t]).any()
            tols = MULTI_SEED_TOLS if seeded else MULTI_STEP_TOLS
            for k, v in out.items():
                if k == "valid":
                    continue
                err = float(np.abs(v - r(f"out_{k}")[t]).max())
                tol = tols[0] if k in ("landmarks", "rois") else tols[1]
                check(err <= tol, f"{run} step {t}: {k} differs from JAX by {err} (tolerance {tol})")
                errs[k] = max(errs.get(k, 0.0), err)
            kind = str(r("start")[t])
            fresh = tracker.init_state(None if entry == "run_frame" else batch)
            state = fresh if kind == "init" else start if kind == "seed" else state
            state, out = step(state, frames, bool(force))
            check((out["valid"].cpu().numpy() == r("out_valid")[t]).all(),
                  f"{run} free-running step {t}: flags differ from JAX")
        print(f"{cls}({', '.join(f'{k}={v}' for k, v in kwargs.items())}).{entry} vs JAX reference over "
              f"{len(r('force'))} steps at batch {batch}: candidates within {cand[..., :4].max():.6f} px "
              f"and {cand[..., 4].max():.3g} rad; one step at a time max errors "
              f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tolerances {MULTI_STEP_TOLS} tracking, "
              f"{MULTI_SEED_TOLS} seeding); free-running flags equal at every step", flush=True)


# The kernels each path must launch in its run (rgb_to_yuv is on no path).
FACE_KERNELS = ("rotated_sample", "letterbox_sample", "blaze_stage", "blaze_block")
HAND_KERNELS = ("rotated_sample", "letterbox_sample")
STEPS, WARMUP = 54, 9
# The BlazeBlock kernel's launches on the face path: Face Mesh V1's 6 blocks
# every step, BlazeFace short range's 11 on a detect step.
BLAZE_BLOCKS_TRACK, BLAZE_BLOCKS_DETECT = 6, 11
# The entry block kernel's launches a forward of Face Mesh V2 and of the iris
# network (each every step on its path), none on Face Mesh V1 or BlazeFace.
ENTRY_BLOCKS = 6
MULTI_BATCH = 128  # streams of the multi-object runs (4 slots each: 512 crops a step)


def launch_counters():
    """Each kernel's name → the ``profiling.counters`` key that counts its
    launches (the stage kernel counts its NHWC variant apart)."""
    from zaru_tpu_torch import profiling

    return {key.removeprefix("launches."): key for key in profiling.counters if key.startswith("launches.")}


def zero_launches():
    from zaru_tpu_torch import profiling

    for key in launch_counters().values():
        profiling.counters[key] = 0


def read_launches():
    from zaru_tpu_torch import profiling

    return {name: profiling.counters[key] for name, key in launch_counters().items()}


def timed_run(torch, step, what, kernels, counted=None):
    """``step(i)`` for WARMUP steps, then STEPS steps timed on the host
    clock with the launch counts zeroed just before and read just after;
    fails unless every kernel in ``kernels`` launched. ``counted``, a dict,
    receives the tracker steps and detect steps of the timed steps
    (``profiling.counters``). → (seconds, launches)."""
    from zaru_tpu_torch import profiling

    for i in range(WARMUP):
        step(i)
    torch.cuda.synchronize()
    zero_launches()
    before = dict(profiling.counters)
    t0 = time.perf_counter()
    for i in range(STEPS):
        step(i)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    if counted is not None:
        counted.update({k: profiling.counters[k] - before[k] for k in ("steps", "detect_steps")})
    check(all(launches[k] > 0 for k in kernels), f"{what}: a kernel of the path was never launched: {launches}")
    return dt, launches


def check_blaze_block_launches(what, launches, counted):
    """A face run's BlazeBlock launches against BLAZE_BLOCKS_TRACK a step
    plus BLAZE_BLOCKS_DETECT a detect step (``counted`` from
    :func:`timed_run`). → the run's launches, steps and detect steps."""
    n, steps, detects = launches["blaze_block"], counted["steps"], counted["detect_steps"]
    want = BLAZE_BLOCKS_TRACK * steps + BLAZE_BLOCKS_DETECT * detects
    check(n == want, f"{what}: {n} BlazeBlock launches in {steps} steps with {detects} detect steps, want {want}")
    return {"launches": n, "steps": steps, "detect_steps": detects}


def check_entry_block_launches(what, launches, steps, per_step):
    """A run's entry block launches against ``per_step`` a step (ENTRY_BLOCKS
    where Face Mesh V2 or the iris network runs every step, else 0)."""
    n = launches["entry_block"]
    check(n == per_step * steps, f"{what}: {n} entry block launches in {steps} steps, want {per_step * steps}")
    return n


def phase_full_size(torch, img, device, card):
    from zaru_tpu_torch.pipeline import FaceTracker

    tracker = FaceTracker(device=device)
    iris = FaceTracker(iris=True, device=device)
    result = {"launches": {}}
    for what, tr, batch in (("main path", tracker, 64), ("main path", tracker, 512),
                            ("FaceTracker(iris=True)", iris, 512)):
        frames = img.expand(batch, *img.shape).contiguous()
        box = {"state": tr.init_state(batch)}

        def step(i, tr=tr, frames=frames, box=box):
            box["state"], box["out"] = tr.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

        counted = {}
        dt, launches = timed_run(torch, step, what, FACE_KERNELS, counted)
        blaze = check_blaze_block_launches(f"{what}, batch {batch}", launches, counted)
        check_entry_block_launches(f"{what}, batch {batch}", launches, counted["steps"],
                                   ENTRY_BLOCKS if tr is iris else 0)
        result.setdefault("ms", {})[(what, batch)] = dt / STEPS * 1e3
        out = box["out"]
        valid = bool(out["valid"].all())
        conf = float(out["confidence"].min())
        print(f"{what} at 1920x1080, batch {batch}: {STEPS} steps (detect every 9th) in "
              f"{dt:.3f} s: {dt / STEPS * 1e3:.3f} ms/step, {batch * STEPS / dt:.1f} frames/s, "
              f"all valid {valid}, min confidence {conf:.4f}; launches {launches} [{card}]", flush=True)
        check(valid and conf > 0.9, f"{what}, batch {batch}: lost the face")
        if tr is iris:
            eyes = out["eyes"]
            check(tuple(eyes.shape) == (batch, 2, 76, 3) and bool(torch.isfinite(eyes).all()),
                  f"iris: eyes of shape {tuple(eyes.shape)}")
        if batch == 512:
            result["launches"][what] = launches
            if what == "main path":
                result["blaze_block"] = blaze
            result[what] = (frames, box["state"], step)
            crops = [(192, 192), (128, 128)] + ([(64, 64)] if tr is iris else [])
            check_no_layout_copy(torch, step, crops, what)
    profile_steps(torch, result["main path"][2], 512, "main path")
    profile_steps(torch, result["FaceTracker(iris=True)"][2], 512, "FaceTracker(iris=True)")
    return tracker, result


def hand_seed_rois(torch, batch, device):
    """Four hands per stream at fixed rects: 200-600 px, -3 to 3 rad, inside
    the 1920×1080 frame (seeded, so the same every run)."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    n = batch * 4
    size = 200 + torch.rand(n, generator=gen) * 400
    rois = torch.stack([
        300 + torch.rand(n, generator=gen) * 1320, 300 + torch.rand(n, generator=gen) * 480,
        size, size * (0.8 + 0.4 * torch.rand(n, generator=gen)),
        (torch.rand(n, generator=gen) - 0.5) * 6.0,
    ], -1)
    return rois.reshape(batch, 4, 5).to(device)


def phase_multi_full_size(torch, img, device, card):
    """MultiFaceTracker and the two MultiHandTracker runs at batch 128."""
    from zaru_tpu_torch.pipeline import MultiFaceTracker, MultiHandTracker

    batch = MULTI_BATCH
    frames = img.expand(batch, *img.shape).contiguous()
    result = {"launches": {}}

    def report(key, what, dt, launches, out, detects, extra=""):
        active = int(out["valid"].sum())
        print(f"{what} at 1920x1080, batch {batch}: {STEPS} steps in {dt:.3f} s: "
              f"{dt / STEPS * 1e3:.3f} ms/step, {batch * STEPS / dt:.1f} frames/s, "
              f"{batch * 4} crops/step, active slots after the last "
              f"step {active}, detect steps {launches['letterbox_sample']}{extra}; launches {launches} "
              f"[{card}]", flush=True)
        check(launches["letterbox_sample"] == detects and launches["rotated_sample"] == STEPS,
              f"{what}: {launches['letterbox_sample']} detect steps, want {detects}")
        result["launches"][key] = launches

    faces = MultiFaceTracker(max_faces=4, device=device)
    box = {"state": faces.init_state(batch)}

    def face_step(i):
        box["state"], box["out"] = faces.run_frames_gated(box["state"], frames)

    what = "MultiFaceTracker(max_faces=4)"
    dt, launches = timed_run(torch, face_step, what, FACE_KERNELS)
    out = box["out"]
    conf = float(out["confidence"][:, 0].min())
    report("multi-face", what, dt, launches, out, STEPS // 9, f", face in slot 0 of every stream "
           f"{bool(out['valid'][:, 0].all())}, min confidence {conf:.4f}")
    check(bool(out["valid"][:, 0].all()) and conf > 0.9 and int(out["valid"].sum()) == batch,
          f"{what}: lost the face")

    def face_detect_step(i):
        box["state"], box["out"] = faces.step_batch(box["state"], frames, force_detect=(i == 0))

    check_no_layout_copy(torch, face_detect_step, [(192, 192), (128, 128)], what)

    hands = MultiHandTracker(max_hands=4, device=device)
    seed = hand_seed_rois(torch, batch, device)
    active = torch.ones((batch, 4), dtype=torch.bool, device=device)
    box = {}

    def hand_step(i):
        state = {"rois": seed, "active": active,
                 "frame": torch.full((batch,), i, dtype=torch.int32, device=device)}
        box["state"], box["out"] = hands.step_batch(state, frames)

    what = "MultiHandTracker(max_hands=4), tracking 4 seeded hands per stream"
    dt, launches = timed_run(torch, hand_step, what, HAND_KERNELS)
    out = box["out"]
    check(tuple(out["landmarks"].shape) == (batch, 4, 21, 3) and bool(torch.isfinite(out["landmarks"]).all()),
          f"{what}: landmarks of shape {tuple(out['landmarks'].shape)}")
    report("hand tracking", what, dt, launches, out, STEPS // 9,
           f", max presence {float(out['presence'].max()):.4f}")
    profile_steps(torch, hand_step, batch, "MultiHandTracker tracking run")
    check_no_layout_copy(torch, hand_step, [(224, 224), (192, 192)], what)

    box = {"state": hands.init_state(batch)}

    def lost_step(i):
        box["state"], box["out"] = hands.run_frames_gated(box["state"], frames)

    what = "MultiHandTracker(max_hands=4), no hand in view"
    dt, launches = timed_run(torch, lost_step, what, HAND_KERNELS)
    report("hand, none in view", what, dt, launches, box["out"], STEPS)
    check(not bool(box["out"]["valid"].any()), f"{what}: found a hand in the photo")
    check_no_layout_copy(torch, lost_step, [(224, 224), (192, 192)], what)
    return hands, frames, seed, result["launches"]


# Ops that would copy a crop between a sampler and its network (a layout
# change, a mirror, a concatenation of slots). ``aten::copy_`` itself is not
# listed: the networks' own Pad copies its input into the padded tensor.
COPY_OPS = ("aten::contiguous", "aten::clone", "aten::cat", "aten::stack", "aten::flip", "aten::_to_copy")


def check_no_layout_copy(torch, step, crops, what):
    """torch.profiler with shapes over ``step(0)`` (a detect step) and
    ``step(1)``: fails if a copy-like op takes a crop-shaped input, ``[...,
    h, w, 3]`` or ``[..., 3, h, w]`` for ``(h, w)`` in ``crops``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for i in range(2):
            step(i)
        torch.cuda.synchronize()
    shapes = {(h, w, 3) for h, w in crops} | {(3, h, w) for h, w in crops}
    found = sorted({(e.key, str(shape)) for e in prof.key_averages(group_by_input_shape=True)
                    if e.key in COPY_OPS for shape in e.input_shapes
                    if len(shape) >= 3 and tuple(shape[-3:]) in shapes})
    print(f"layout copies of a crop ({', '.join(f'{h}x{w}' for h, w in crops)}) in two steps of the "
          f"{what} (one detect): {found if found else 'none'}", flush=True)
    check(not found, f"{what}: a crop is copied between its sampler and its network")


def profile_steps(torch, step, batch, what, steps=9):
    """torch.profiler over ``step(0)`` … ``step(8)`` (one detect step, then
    8 track steps): device time by kernel, and the device's busy share of
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    per_step = sorted(((e.self_device_time_total / 1e3 / steps, e.key) for e in kernels), reverse=True)
    busy = sum(ms for ms, _ in per_step)
    groups = {}
    for ms, name in per_step:
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    by_group = ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda x: -x[1]))
    top = "; ".join(f"{name[:72]} {ms:.3f}" for ms, name in per_step[:8])
    print(f"profile of the {what}, batch {batch}, {steps} steps (1 detect): "
          f"{wall_ms / steps:.3f} ms/step wall, device busy {busy:.3f} ms/step "
          f"({100 * busy * steps / wall_ms:.1f}%), {len(per_step)} kernels; ms/step by group: "
          f"{by_group}; top: {top}", flush=True)
    return busy * steps / wall_ms


def phase_slice_full_size(torch, img, device, card, batch=512):
    """FaceTracker with Face Mesh V2 and with the full-range detector at
    batch 512 on the main path's cadence (detection forced every 9th step),
    and ``run_frame`` on one stream: ms/step, frames/s, launches, and the
    device's busy share from a 9-step profile. The single-stream step must
    run the stage kernel and no sampler kernel (its crops are exact)."""
    from zaru_tpu_torch.face.detection import FullRangeNetwork
    from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV2
    from zaru_tpu_torch.pipeline import FaceTracker

    frames = img.expand(batch, *img.shape).contiguous()
    result = {}
    for what, tr, points, crops in (
        ("FaceTracker(landmarker=FaceMeshV2())",
         FaceTracker(landmarker=FaceMeshV2(device=device), device=device), 478, [(256, 256), (128, 128)]),
        ("FaceTracker(detector=FullRangeNetwork())",
         FaceTracker(detector=FullRangeNetwork(device=device), device=device), 468, [(192, 192)]),
    ):
        box = {"state": tr.init_state(batch)}

        def step(i, tr=tr, box=box):
            box["state"], box["out"] = tr.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

        dt, launches = timed_run(torch, step, what, FACE_KERNELS)
        check_entry_block_launches(what, launches, STEPS, ENTRY_BLOCKS if points == 478 else 0)
        out = box["out"]
        valid, conf = bool(out["valid"].all()), float(out["confidence"].min())
        check(tuple(out["landmarks"].shape) == (batch, points, 3),
              f"{what}: landmarks {tuple(out['landmarks'].shape)}")
        busy = profile_steps(torch, step, batch, what)
        print(f"{what} at 1920x1080, batch {batch}: {STEPS} steps (detect every 9th) in {dt:.3f} s: "
              f"{dt / STEPS * 1e3:.3f} ms/step, {batch * STEPS / dt:.1f} frames/s, device busy "
              f"{100 * busy:.1f}%, all valid {valid}, min confidence {conf:.4f}; launches {launches} [{card}]",
              flush=True)
        check(valid and conf > 0.9, f"{what}: lost the face")
        check_no_layout_copy(torch, step, crops, what)
        result[what] = (tr, box["state"], launches)

    one = FaceTracker(device=device)
    box = {"state": one.init_state()}

    def single(i):
        box["state"], box["out"] = one.run_frame(box["state"], img)

    what = "FaceTracker.run_frame, one stream"
    dt, launches = timed_run(torch, single, what, ("blaze_stage",))
    check(launches["rotated_sample"] == 0 and launches["letterbox_sample"] == 0,
          f"{what}: a sampler kernel ran on the exact path: {launches}")
    busy = profile_steps(torch, single, 1, what)
    out = box["out"]
    print(f"{what} at 1920x1080: {STEPS} frames in {dt:.3f} s: {dt / STEPS * 1e3:.3f} ms/frame, "
          f"{STEPS / dt:.1f} frames/s, device busy {100 * busy:.1f}%, valid {bool(out['valid'])}, confidence "
          f"{float(out['confidence']):.4f}; launches {launches} [{card}]", flush=True)
    check(bool(out["valid"]) and float(out["confidence"]) > 0.9, f"{what}: lost the face")
    result[what] = (one, box["state"], launches)
    return frames, result, dt / STEPS * 1e3


def _letterbox_lin(torch, frames, yi, xi, ok):
    """The letterbox's reads as ``(lin, ok)``: each read pixel's index in
    ``frames [B,H,W,4]`` viewed as ``[B*H*W]`` RGBA pixels (0 where not read)."""
    B, H, W, _ = frames.shape
    bidx = torch.arange(B, device=frames.device)[:, None, None]
    return torch.where(ok, (bidx * H + yi) * W + xi, 0), ok


def phase_kernel_times(torch, frames, lm, det, rois, launches, what, prescale_m=512,
                       names=("rotated_sample", "letterbox_sample"), view_rects=None):
    """The two samplers at a path's inputs (``lm``/``det``: its landmark and
    detector ``Cnn``; ``rois``: the ROIs of its last step), in the planar
    layout the path samples (``view_rects``: the rotated views, if not the
    landmark crops of ``rois``): ``ms`` is the whole call (``rotated_sample_fast``,
    ``letterbox_sample``: one kernel each), queued behind a device spin so
    the host's launch cost is hidden; ``kernel_ms`` the launch alone and
    ``nhwc_ms`` the NHWC launch, both queued; ``call_ms`` a lone call, not
    queued (host time included). Beside the bound (4 B read per
    in-frame pixel), the printed line gives the sector figure: the distinct
    32-byte sectors the plain version's index map reads, × 32 B, plus the
    bytes written, over the memory rate (a second bound, so not in the JSON
    line). ``copy_ms``: the ``permute(0,3,1,2).contiguous()`` of the NHWC
    output that the path ran before it sampled planar. ``names``: the
    samplers to time."""
    from zaru_tpu_torch.ops.letterbox import letterbox_sample, letterbox_sample_planar_reference
    from zaru_tpu_torch.ops.rotated_fast import (
        _source_index, rotated_sample_fast, rotated_sample_fast_reference, rotated_sample_launch,
        sampler_coefs,
    )
    from zaru_tpu_torch.ops.sampling import _letterbox_index
    from zaru_tpu_torch.pipeline import _ops

    lm_res, det_res = lm.input_resolution(), det.input_resolution()
    view_rects = _ops.aspect_view_rect(rois, lm_res) if view_rects is None else view_rects
    flat = view_rects.reshape(-1, 5).contiguous()
    slots = flat.shape[0] // frames.shape[0]
    _fit, fit_rrect = _ops.full_frame_fit(frames, det_res)
    fit_rects = fit_rrect.expand(frames.shape[0], 5).contiguous()
    lm_col, det_col = (lm.mapper.lo, lm.mapper.hi), (det.mapper.lo, det.mapper.hi)
    w, h, dw, dh = lm_res.width, lm_res.height, det_res.width, det_res.height
    kernels = []
    for name, call, plain, launch, launch_nhwc, index, source, replaces, flops_px in (
        ("rotated_sample",
         lambda: rotated_sample_fast(frames, view_rects, w, h, *lm_col, prescale_m, "NCHW"),
         lambda: rotated_sample_fast_reference(frames, view_rects, w, h, *lm_col, prescale_m, "NCHW"),
         lambda: rotated_sample_launch(frames, flat, slots, w, h, *lm_col, prescale_m, "NCHW"),
         lambda: rotated_sample_launch(frames, flat, slots, w, h, *lm_col, prescale_m, "NHWC"),
         lambda: _source_index(frames, *sampler_coefs(flat, prescale_m), w, h, prescale_m),
         "zaru_tpu_torch/csrc/rotated_sample.cu", "zaru_tpu/ops/rotated_fast.py:1481", 32),
        ("letterbox_sample",
         lambda: letterbox_sample(frames, fit_rects, dw, dh, *det_col, "NCHW"),
         lambda: letterbox_sample_planar_reference(frames, fit_rects, dw, dh, *det_col),
         lambda: letterbox_sample(frames, fit_rects, dw, dh, *det_col, "NCHW"),
         lambda: letterbox_sample(frames, fit_rects, dw, dh, *det_col, "NHWC"),
         lambda: _letterbox_lin(torch, frames, *_letterbox_index(frames, fit_rects, dw, dh)),
         "zaru_tpu_torch/csrc/letterbox_sample.cu", "zaru_tpu/ops/pallas_kernels.py:112", 22),
    ):
        if name not in names:
            continue
        got, want, nhwc = call(), plain(), launch_nhwc()
        err = float((got - want).abs().max())
        check(torch.equal(launch().reshape(got.shape), got), f"{name}: launch differs from the call")
        check(torch.equal(nhwc.reshape(-1, *nhwc.shape[-3:]).permute(0, 3, 1, 2), got.reshape(
            -1, *got.shape[-3:])), f"{name}: the NHWC launch differs from the planar call")
        lin, ok = index()
        reads = int(ok.sum())
        sectors = int(torch.unique(lin[ok] // 8).numel())  # 8 RGBA pixels = 32 bytes
        del lin, ok
        out_px = got.numel() // 3
        rect_bytes = (view_rects if name == "rotated_sample" else fit_rects).numel() * 4
        nbytes = out_px * 12 + reads * 4 + rect_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = out_px * flops_px / F32_FLOPS * 1e3
        sector_ms = (out_px * 12 + sectors * 32 + rect_bytes) / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(torch, call, queued=True)
        kernel_ms = cuda_ms(torch, launch, queued=True)
        nhwc_ms = cuda_ms(torch, launch_nhwc, queued=True)
        call_ms = cuda_ms(torch, call)
        copy_ms = cuda_ms(torch, lambda: nhwc.permute(0, 3, 1, 2).contiguous(), queued=True)
        plain_ms = cuda_ms(torch, plain, reps=5)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "kernel_ms": kernel_ms, "nhwc_ms": nhwc_ms, "call_ms": call_ms,
            "copy_ms": copy_ms, "path": what, "shape": list(got.shape),
        })
        print(f"{name}, {what}, batch {frames.shape[0]} ({tuple(got.shape)}, planar): call {ms:.4f} ms "
              f"(kernel {kernel_ms:.4f}, NHWC kernel {nhwc_ms:.4f}, lone call not queued {call_ms:.4f}), "
              f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB), sector figure {sector_ms:.4f} ms "
              f"({sectors} sectors of 32 B for {reads} reads), permute copy it no longer runs "
              f"{copy_ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
              f"{launches[name] / STEPS:.3f} launches/step, max abs err {err}", flush=True)
        check(err == 0.0, f"{name} disagrees with its plain version at the {what} inputs")
    return kernels


def phase_yuv_times(torch, rgb, launches):
    """The RGB→YUV kernel at 1920×1080 (queued launches) beside its plain
    version and ``torch.matmul(rgb, M.T)``, the one PyTorch call that
    computes the same function (full f32: TF32 off for matrix products)."""
    from zaru_tpu_torch.ops.yuv import YUV_FROM_RGB, rgb_to_yuv_fast_reference, rgb_to_yuv_launch

    m_t = torch.from_numpy(YUV_FROM_RGB).to(rgb.device).T.contiguous()
    got, want = rgb_to_yuv_launch(rgb), rgb_to_yuv_fast_reference(rgb)
    err = float((got - want).abs().max())
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        lib_err = float((torch.matmul(rgb, m_t) - want).abs().max())
        ms = cuda_ms(torch, lambda: rgb_to_yuv_launch(rgb), reps=200, queued=True)
        plain_ms = cuda_ms(torch, lambda: rgb_to_yuv_fast_reference(rgb), reps=50, queued=True)
        library_ms = cuda_ms(torch, lambda: torch.matmul(rgb, m_t), reps=200, queued=True)
    finally:
        torch.set_float32_matmul_precision(prev)
    n = rgb.shape[0] * rgb.shape[1]
    nbytes = 2 * n * 12
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, n * 15 / F32_FLOPS * 1e3
    print(f"rgb_to_yuv at {rgb.shape[1]}x{rgb.shape[0]}: {ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms, torch.matmul {library_ms:.4f} ms "
          f"(max abs diff to the plain version {lib_err}), {launches} launches on the main path, "
          f"max abs err {err}", flush=True)
    check(err == 0.0, "rgb_to_yuv disagrees with its plain version at 1920x1080")
    return {
        "name": "rgb_to_yuv", "route": "cuda", "source": "zaru_tpu_torch/csrc/rgb_to_yuv.cu",
        "replaces": "zaru_tpu/ops/pallas_kernels.py:174", "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms,
        "library": "torch.matmul(rgb, M.T), f32", "path": "none (1920x1080 photo)",
    }


def phase_stage_times(torch, tracker, frames, state, launches, steps, what="main path", nhwc=False):
    """The stage kernel at each BlazeBlock chain of the two face CNNs, on the
    chain's real input at batch 512 (the main path's crops and letterbox
    views) and the real weights: checked against its plain version, then
    timed beside the plain version and the per-op chain the executor ran
    before the stage plan (``F.conv2d`` depthwise, ``F.conv2d`` 1×1, ``+``,
    ``torch.where`` PReLU or ``torch.relu`` per block, TF32 off). The JSON
    row sums the ten chains, one launch each. ``nhwc``: the same on a
    channels_last copy of each input, through the NHWC variant (its own
    row)."""
    from zaru_tpu_torch.onnx.executor import _OPS
    from zaru_tpu_torch.ops.cnn_stage import (
        _tiling, blaze_blocks_reference, fused_blocks, pack_blocks, unpack_blocks,
    )
    from zaru_tpu_torch.pipeline import _ops

    lm, det = tracker.lm_cnn, tracker.det_cnn
    view_rects = _ops.aspect_view_rect(state["roi"], lm.input_resolution())
    _fit, fit_rrect = _ops.full_frame_fit(frames, det.input_resolution())
    inputs = (
        ("face_landmark", lm, lm.sample_views_fast(frames, view_rects, layout="NCHW")),
        ("face_detection_short_range", det,
         det.sample_views_letterbox(frames, fit_rrect.expand(frames.shape[0], 5).contiguous(), "NCHW")),
    )
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0, "err": 0.0}
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for model, cnn, xs in inputs:
            net = cnn.net
            params = net.params()
            env = net.activations(xs)
            for k, st in enumerate(net.stages):
                x = env[st.input].contiguous(memory_format=torch.channels_last if nhwc else torch.contiguous_format)
                B, C, H, W = x.shape
                nb = len(st.blocks)
                packed = pack_blocks(
                    [{n: None if v is None else params[v] for n, v in b.items()} for b in st.blocks], C
                )

                def chain(x=x, st=st):
                    vals = dict(params)
                    vals[st.input] = x
                    for i in st.nodes:
                        node = net.nodes[i]
                        vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[n] for n in node.inputs])
                    return vals[st.output]

                kernel = lambda x=x, p=packed, H=H, W=W, C=C: fused_blocks(x, p, H, W, C)  # noqa: E731
                plain = lambda x=x, p=packed, C=C: blaze_blocks_reference(x, unpack_blocks(p, C))  # noqa: E731
                got, want, ops_out = kernel(), plain(), chain()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(((got - want).abs() <= STAGE_TOL + STAGE_TOL * want.abs()).all())
                chain_err = float((ops_out - want).abs().max())
                ms = cuda_ms(torch, kernel, queued=True)
                plain_ms = cuda_ms(torch, plain, reps=20, queued=True)
                chain_ms = cuda_ms(torch, chain, reps=20, queued=True)
                nbytes = 2 * x.numel() * 4 + packed.numel() * 4
                ops = nb * B * H * W * C * (2 * (9 + C) + 4)
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
                print(f"blaze_stage{' NHWC' if nhwc else ''}, {what}, {model} chain {k}: [{B},{C},{H},{W}] "
                      f"x {nb} blocks "
                      f"(tiles {_tiling(C, H, W, nb)[:2]}): {ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                      f"({'bytes' if t_bytes >= t_ops else 'operations'}), plain {plain_ms:.4f} ms, "
                      f"per-op chain {chain_ms:.4f} ms, max abs err {err} (per-op chain vs plain "
                      f"{chain_err})", flush=True)
                check(ok, f"blaze_stage disagrees with its plain version at {model} chain {k}")
                check(chain_err <= STAGE_TOL, f"{model} chain {k}: the per-op chain differs from the plain version")
                for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", chain_ms),
                               ("bytes", nbytes), ("ops", ops)):
                    tot[key] += v
                tot["err"] = max(tot["err"], err)
            del env
    t_bytes, t_ops = tot["bytes"] / HBM_BYTES_PER_S * 1e3, tot["ops"] / F32_FLOPS * 1e3
    print(f"blaze_stage{' NHWC' if nhwc else ''}, {what}, the ten chains at batch {frames.shape[0]}, one launch each: "
          f"{tot['ms']:.4f} ms, "
          f"bound {max(t_bytes, t_ops):.4f} ms, plain {tot['plain_ms']:.4f} ms, per-op chain "
          f"{tot['library_ms']:.4f} ms; {launches / steps:.3f} launches/step", flush=True)
    return {
        "name": "blaze_stage_nhwc" if nhwc else "blaze_stage", "route": "cuda",
        "source": f"zaru_tpu_torch/csrc/blaze_stage{'_nhwc' if nhwc else ''}.cu (kernel: csrc/blaze_stage.cuh)",
        "replaces": "zaru_tpu/ops/cnn_stage.py:148", "launches": launches, "path": what,
        "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": tot["library_ms"],
        "library": "per-op chain: F.conv2d depthwise, F.conv2d 1x1, add, torch.where PReLU or relu",
    }


def phase_bottleneck(torch, np, device, card, img=None):
    """The bottleneck kernel at every chain of Face Mesh V2 and the iris
    model, on the chain's input (the network on uniform [-1, 1] inputs) and
    the real weights, at batch 512 and batch 1: within the CNN bar of its
    plain version, then timed beside its bound and the per-op chain the
    executor runs without the plan (TF32 off); ``analyze`` of each network
    with and without the plan, which must agree; a chain of an unbuilt width
    must raise. With ``img``: ``FaceTracker(iris=True)`` at 512 in turns
    with the plan and without it on the eye network (ms a step). → the
    ``kernels`` line's row."""
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.analysis import analyze
    from zaru_tpu_torch.onnx.executor import _OPS
    from zaru_tpu_torch.ops import bottleneck as bn_ops

    gen = torch.Generator(device=device).manual_seed(3)
    for C, B, H, W, nb in ((16, 3, 37, 29, 3), (32, 2, 20, 13, 4), (64, 5, 9, 7, 2), (128, 3, 5, 6, 4),
                           (128, 7, 3, 3, 1), (16, 1, 130, 66, 4), (64, 600, 2, 1, 2)):
        x = torch.rand(B, C, H, W, device=device, generator=gen) * 2 - 1
        packed = (torch.rand(nb, bn_ops.row_floats(C), device=device, generator=gen) - 0.5) * (2.0 / C ** 0.5)
        got = bn_ops.fused_bottlenecks(x, packed, H, W, C)
        want = bn_ops.bottleneck_blocks_reference(x, bn_ops.unpack_bottlenecks(packed, C))
        atol = CNN_ATOL * max(1.0, float(want.abs().max()))
        check(bool(((got - want).abs() <= atol + CNN_RTOL * want.abs()).all()),
              f"bottleneck_stage disagrees with its plain version at [{B},{C},{H},{W}] x {nb} blocks: "
              f"max abs err {float((got - want).abs().max())}")
    print("bottleneck_stage within the CNN bar of its plain version on random weights at ragged shapes "
          f"[{card}]", flush=True)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    bound_by = set()
    for name, res, batch in (("face_landmarks_detector.onnx", 256, 512), ("iris_landmark.onnx", 64, 1024)):
        net = load_model((ROOT / "assets" / "onnx" / name).read_bytes(), device)
        flops = analyze(net).flops
        with net.without_plans("bottlenecks"):
            op_by_op = analyze(net).flops
        check(flops == op_by_op, f"{name}: analyze counts {flops} FLOPs with the bottleneck plan, {op_by_op} without")
        gen = torch.Generator(device=device).manual_seed(5)
        xin = torch.rand(batch, 3, res, res, device=device, generator=gen) * 2 - 1
        params = net.params()
        with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            with net.without_plans():
                env = net.activations(xin)
            for k, bn in enumerate(net.bottlenecks):
                packed = net._packed[bn.at]
                for b in (batch, 1):
                    x = env[bn.input][:b].contiguous()
                    B, C, H, W = x.shape

                    def chain(x=x, bn=bn):
                        vals = dict(params)
                        vals[bn.input] = x
                        for i in bn.nodes:
                            node = net.nodes[i]
                            vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[n] for n in node.inputs])
                        return vals[bn.output]

                    kernel = lambda x=x, p=packed, H=H, W=W, C=C: bn_ops.fused_bottlenecks(x, p, H, W, C)  # noqa: E731
                    plain = lambda x=x, p=packed, C=C: bn_ops.bottleneck_blocks_reference(  # noqa: E731
                        x, bn_ops.unpack_bottlenecks(p, C))
                    got, want, ops_out = kernel(), plain(), chain()
                    torch.cuda.synchronize()
                    diff = (got - want).abs()
                    err = float(diff.max())
                    atol = CNN_ATOL * max(1.0, float(want.abs().max()))
                    ok = bool((diff <= atol + CNN_RTOL * want.abs()).all())
                    chain_err = float((ops_out - want).abs().max())
                    ms = cuda_ms(torch, kernel, queued=True)
                    chain_ms = cuda_ms(torch, chain, reps=20, queued=True)
                    plain_ms = cuda_ms(torch, plain, reps=20, queued=True)
                    nb = len(bn.blocks)
                    ops = bn_ops.bottleneck_flops((B, C, H, W), packed.shape)
                    t_bytes = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / F32_FLOPS * 1e3
                    bound = max(t_bytes, t_ops)
                    by = "bytes" if t_bytes >= t_ops else "operations"
                    print(f"bottleneck_stage, {name} chain {k}: [{B},{C},{H},{W}] x {nb} blocks (launches: blocks, "
                          f"tile, images {[p[:4] for p in bn_ops.plan(C, H, W, B, nb)]}): {ms:.4f} ms, bound "
                          f"{bound:.4f} ms ({by}), "
                          f"{100 * bound / ms:.1f}% of it; plain {plain_ms:.4f} ms, per-op chain {chain_ms:.4f} ms; "
                          f"max abs err {err:.3g} (atol {atol:.3g}; per-op chain vs plain {chain_err:.3g}) [{card}]",
                          flush=True)
                    check(ok, f"bottleneck_stage disagrees with its plain version at {name} chain {k}, batch {B}")
                    check(chain_err <= atol, f"{name} chain {k}: the per-op chain differs from the plain version")
                    if b == batch and name.startswith("face_landmarks"):
                        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", chain_ms),
                                       ("bound_ms", bound)):
                            tot[key] += v
                        tot["err"] = max(tot["err"], err)
                        bound_by.add(by)
            del env
    x = torch.zeros(2, 24, 8, 8, device=device)
    try:
        bn_ops.fused_bottlenecks(x, torch.zeros(1, 24 * 24 + 8 * 24, device=device), 8, 8, 24)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the bottleneck kernel ran 24 channels, which it is not built for")
    print(f"bottleneck_stage, Face Mesh V2's seven chains at batch 512, the plan's launches: {tot['ms']:.4f} ms, "
          f"bound {tot['bound_ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}%), plain {tot['plain_ms']:.4f} "
          f"ms, per-op chain {tot['library_ms']:.4f} ms [{card}]", flush=True)
    if img is not None:
        from zaru_tpu_torch.pipeline import FaceTracker

        iris = FaceTracker(iris=True, device=device)
        frames = img.expand(512, *img.shape).contiguous()
        box = {"state": iris.init_state(512)}

        def step(i):
            box["state"], box["out"] = iris.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

        times = {}
        for plan in (True, False, False, True):
            with contextlib.nullcontext() if plan else iris.eye_cnn.net.without_plans("bottlenecks"):
                dt, launches = timed_run(torch, step, "FaceTracker(iris=True)", FACE_KERNELS)
            times.setdefault(plan, []).append(dt / STEPS * 1e3)
            check((launches["bottleneck_stage"] > 0) == plan, f"iris: bottleneck launches {launches}")
        print(f"FaceTracker(iris=True) at 512, detect every 9th step: {times[True]} ms/step with the bottleneck "
              f"plan on the eye network, {times[False]} without [{card}]", flush=True)
    return {
        "name": "bottleneck_stage", "route": "cuda", "source": "zaru_tpu_torch/csrc/bottleneck_stage.cu",
        "replaces": "none (XLA's per-op blocks)", "path": "Face Mesh V2, seven chains at batch 512",
        "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "+".join(sorted(bound_by)), "library_ms": tot["library_ms"],
        "library": "per-op chain: F.conv2d 1x1, torch.where PReLU, F.conv2d depthwise, F.conv2d 1x1, add, "
                   "torch.where PReLU",
    }


# The BlazeBlock kernel's random cases: (C_in, C_out, B, H, W, stride, pads,
# relu): ragged sizes, bands and whole images, rows that are no multiple of
# four floats, both pad splits at stride 2, more images than a launch's
# thread block takes.
BLAZE_BLOCK_CASES = [
    (24, 28, 3, 37, 29, 1, (1, 1, 1, 1), True), (28, 32, 2, 20, 13, 2, (0, 0, 1, 1), True),
    (42, 48, 5, 9, 7, 2, (1, 1, 0, 0), False), (16, 32, 3, 96, 96, 2, (0, 0, 1, 1), False),
    (128, 128, 7, 6, 6, 2, (0, 0, 1, 1), False), (128, 128, 37, 3, 3, 2, (0, 1, 1, 0), False),
    (88, 96, 1, 16, 16, 2, (0, 0, 1, 1), True), (80, 88, 600, 4, 4, 1, (1, 1, 1, 1), True),
    (36, 42, 2, 30, 30, 1, (1, 1, 1, 1), False), (8, 13, 4, 64, 64, 1, (1, 1, 1, 1), False),
]


def phase_blaze_block(torch, np, device, card, img, main=None):
    """The BlazeBlock kernel at random weights on ragged shapes, then at
    every block of BlazeFace short range and Face Mesh V1 on the block's
    input (the network on uniform [-1, 1] inputs) and the real weights, at
    batch 512 and batch 1: within the CNN bar of the per-op chain the
    executor runs without the plan (TF32 off), timed beside it and its
    bound; ``analyze`` of each network with and without the plan, which must
    agree; a forward's blocks in ``counters["blaze_blocks"]`` and its
    launches; the refusals. ``main``: the main path's launches at 512
    (:func:`check_blaze_block_launches` of phase 5's run); without it the
    main path runs here on the photo ``img``, as phase 5 runs it, and is
    checked the same way. → the ``kernels`` line's row."""
    from zaru_tpu_torch import profiling
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.analysis import analyze
    from zaru_tpu_torch.onnx.executor import _OPS
    from zaru_tpu_torch.ops import blaze_block as bb

    def within(got, want):
        diff = (got - want).abs()
        atol = CNN_ATOL * max(1.0, float(want.abs().max()))
        return bool((diff <= atol + CNN_RTOL * want.abs()).all()), float(diff.max()), atol

    gen = torch.Generator(device=device).manual_seed(3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for c_in, c_out, B, H, W, s, pads, relu in BLAZE_BLOCK_CASES:
            x = torch.rand(B, c_in, H, W, device=device, generator=gen) * 2 - 1
            packed = (torch.rand(bb.row_floats(c_in, c_out), device=device, generator=gen) - 0.5) * (2.0 / c_in ** 0.5)
            got = bb.fused_blaze_block(x, packed, c_out, s, pads, relu)
            want = bb.blaze_block_reference(x, bb.unpack_blaze_block(packed, c_in, c_out, relu), s, pads, relu)
            torch.cuda.synchronize()
            ok, err, atol = within(got, want)
            check(got.shape == want.shape and ok,
                  f"blaze_block disagrees with its plain version at [{B},{c_in},{H},{W}] -> {c_out}, stride {s}, "
                  f"pads {pads}: max abs err {err} (atol {atol:.3g}), tiling {bb.tiling(c_in, c_out, H, W, s, B)}")
    print(f"blaze_block within the CNN bar of its plain version on random weights at {len(BLAZE_BLOCK_CASES)} "
          f"ragged shapes [{card}]", flush=True)
    tot = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    bound_by = set()
    for name, res, want_blocks in (("face_detection_short_range.onnx", 128, 11), ("face_landmark.onnx", 192, 6)):
        net = load_model((ROOT / "assets" / "onnx" / name).read_bytes(), device)
        check(len(net.blaze_blocks) == want_blocks, f"{name}: {len(net.blaze_blocks)} blocks in the plan")
        flops = analyze(net).flops
        with net.without_plans("blaze_blocks"):
            op_by_op = analyze(net).flops
        check(flops == op_by_op, f"{name}: analyze counts {flops} FLOPs with the BlazeBlock plan, {op_by_op} without")
        gen = torch.Generator(device=device).manual_seed(5)
        xin = torch.rand(512, 3, res, res, device=device, generator=gen) * 2 - 1
        params = net.params()
        with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            before = dict(profiling.counters)
            fused = net(xin)
            with net.without_plans():
                plain = net(xin)
            torch.cuda.synchronize()
            counted = tuple(profiling.counters[k] - before[k] for k in ("blaze_blocks", "launches.blaze_block"))
            check(counted == (want_blocks, want_blocks), f"{name}: a forward counted (blocks, launches) {counted}")
            worst = max(within(a, b)[1] / within(a, b)[2] for a, b in zip(fused, plain))
            print(f"{name} at 512, the whole network with and without the plan: largest difference "
                  f"{worst:.3g} of the CNN bar's atol [{card}]", flush=True)
            with net.without_plans():
                env = net.activations(xin)
            for k, blk in enumerate(net.blaze_blocks):
                packed = net._packed[blk.at]
                for b in (512, 1):
                    x = env[blk.input][:b].contiguous()
                    B, C, H, W = x.shape

                    # The block's nodes, and a MaxPool it shares with another block.
                    order = sorted(set(blk.nodes) | {j for j, n in enumerate(net.nodes)
                                                     if n.op_type == "MaxPool" and n.inputs[0] == blk.input})

                    def chain(x=x, blk=blk, order=order):
                        vals = dict(params)
                        vals[blk.input] = x
                        for i in order:
                            node = net.nodes[i]
                            vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[n] for n in node.inputs])
                        return vals[blk.output]

                    kernel = lambda x=x, p=packed, blk=blk: bb.fused_blaze_block(  # noqa: E731
                        x, p, blk.c_out, blk.stride, blk.pads, blk.relu)
                    got, ops_out = kernel(), chain()
                    torch.cuda.synchronize()
                    ok, err, atol = within(got, ops_out)
                    ms = cuda_ms(torch, kernel, queued=True)
                    chain_ms = cuda_ms(torch, chain, reps=20, queued=True)
                    ops = bb.blaze_block_flops(tuple(x.shape), packed.shape, blk.c_out, blk.stride, blk.pads,
                                               blk.relu)
                    t_bytes = (x.numel() + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / F32_FLOPS * 1e3
                    bound = max(t_bytes, t_ops)
                    by = "bytes" if t_bytes >= t_ops else "operations"
                    print(f"blaze_block, {name} block {k}: [{B},{C},{H},{W}] -> {blk.c_out}, stride {blk.stride}, "
                          f"{'ReLU' if blk.relu else 'PReLU'} (tile rows, images "
                          f"{bb.tiling(C, blk.c_out, H, W, blk.stride, B)}): {ms:.4f} ms, bound {bound:.4f} ms "
                          f"({by}), {100 * bound / ms:.1f}% of it; per-op chain {chain_ms:.4f} ms; max abs err "
                          f"{err:.3g} (atol {atol:.3g}, rtol {CNN_RTOL}) [{card}]", flush=True)
                    check(ok, f"blaze_block disagrees with the per-op chain at {name} block {k}, batch {B}")
                    if b == 512:
                        for key, v in (("ms", ms), ("library_ms", chain_ms), ("bound_ms", bound)):
                            tot[key] += v
                        tot["err"] = max(tot["err"], err)
                        bound_by.add(by)
            del env
    refusals = {
        "5x5": lambda: bb.pack_blaze_block({"dw_w": torch.zeros(8, 1, 5, 5), "dw_b": torch.zeros(8),
                                            "pw_w": torch.zeros(16, 8, 1, 1), "pw_b": torch.zeros(16)}, 8, 16),
        "C_out < C_in": lambda: bb.fused_blaze_block(torch.zeros(2, 16, 8, 8, device=device),
                                                     torch.zeros(bb.row_floats(16, 8), device=device), 8, 2,
                                                     (0, 0, 1, 1), True),
        "float64": lambda: bb.fused_blaze_block(torch.zeros(2, 8, 8, 8, device=device, dtype=torch.float64),
                                                torch.zeros(bb.row_floats(8, 16), device=device), 16, 1,
                                                (1, 1, 1, 1), True),
        "channels_last": lambda: bb.fused_blaze_block(
            torch.zeros(2, 8, 8, 8, device=device).to(memory_format=torch.channels_last),
            torch.zeros(bb.row_floats(8, 16), device=device), 16, 1, (1, 1, 1, 1), True),
    }
    for what, fn in refusals.items():
        try:
            fn()
            refused = False
        except ValueError:
            refused = True
        check(refused, f"the BlazeBlock kernel took {what}")
    if main is None:
        from zaru_tpu_torch.pipeline import FaceTracker

        tracker = FaceTracker(device=device)
        frames = img.expand(512, *img.shape).contiguous()
        box = {"state": tracker.init_state(512)}

        def step(i):
            box["state"], _out = tracker.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

        counted = {}
        _dt, launches = timed_run(torch, step, "main path", FACE_KERNELS, counted)
        main = check_blaze_block_launches("main path, batch 512", launches, counted)
    print(f"blaze_block, the 17 blocks of BlazeFace short range and Face Mesh V1 at batch 512: {tot['ms']:.4f} ms, "
          f"bound {tot['bound_ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}%), per-op chain "
          f"{tot['library_ms']:.4f} ms; refused {sorted(refusals)}; main path at 512: {main['launches']} launches "
          f"in {main['steps']} steps, {main['detect_steps']} of them detect steps, "
          f"{main['launches'] / main['steps']:.3f} launches/step [{card}]", flush=True)
    return {
        "name": "blaze_block", "route": "cuda", "source": "zaru_tpu_torch/csrc/blaze_block.cu",
        "replaces": "none (XLA's per-op blocks)",
        "path": "BlazeFace short range's 11 and Face Mesh V1's 6 blocks at batch 512",
        "launches": main["launches"], "steps": main["steps"], "detect_steps": main["detect_steps"],
        "max_abs_err": tot["err"], "ms": tot["ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "+".join(sorted(bound_by)), "library_ms": tot["library_ms"],
        "library": "per-op chain: F.pad, F.conv2d depthwise, F.conv2d 1x1, max_pool2d, F.pad, add, "
                   "torch.relu or torch.where PReLU",
    }


# The entry block kernel's random cases: (C_in, M, B, H, W): each width, bands
# and whole images, sides that are no multiple of four, a 2x2 image, more
# images than a thread block takes.
ENTRY_BLOCK_CASES = [
    (16, 16, 3, 130, 66), (32, 32, 2, 6, 22), (64, 64, 5, 34, 30), (128, 64, 3, 18, 14), (128, 64, 7, 8, 8),
    (128, 64, 600, 4, 4), (64, 64, 2, 2, 2), (16, 16, 1, 10, 14),
]


def phase_entry_block(torch, np, device, card, img=None):
    """The entry block kernel at random weights on ragged shapes, then at
    every entry block of Face Mesh V2 (batch 512) and the iris model (1024)
    on the block's input (the network on uniform [-1, 1] inputs) and the
    real weights, and at batch 1: within the CNN bar of the per-op chain the
    executor runs without the plan (TF32 off), timed beside it and its
    bound; ``analyze`` of each network with and without the plan, which must
    agree; a forward's blocks in ``counters["entry_blocks"]`` and its
    launches, 6 for either network and none for Face Mesh V1 or BlazeFace;
    the refusals. With ``img``: ``FaceTracker`` with Face Mesh V2 and with
    iris at 512 on the photo, in turns with the plan and without it
    (ms a step, 6 launches a step with it). → the ``kernels`` line's row."""
    from zaru_tpu_torch import profiling
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.analysis import analyze
    from zaru_tpu_torch.onnx.executor import _OPS
    from zaru_tpu_torch.ops import entry_block as eb

    def within(got, want):
        diff = (got - want).abs()
        atol = CNN_ATOL * max(1.0, float(want.abs().max()))
        return bool((diff <= atol + CNN_RTOL * want.abs()).all()), float(diff.max()), atol

    def counted(fn):
        before = dict(profiling.counters)
        fn()
        torch.cuda.synchronize()
        return tuple(profiling.counters[k] - before[k] for k in ("entry_blocks", "launches.entry_block"))

    gen = torch.Generator(device=device).manual_seed(3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for c_in, m, B, H, W in ENTRY_BLOCK_CASES:
            x = torch.rand(B, c_in, H, W, device=device, generator=gen) * 2 - 1
            packed = (torch.rand(eb.row_floats(c_in, m), device=device, generator=gen) - 0.5) * (1.0 / c_in ** 0.5)
            got = eb.fused_entry_block(x, packed, m)
            want = eb.entry_block_reference(x, eb.unpack_entry_block(packed, c_in, m))
            torch.cuda.synchronize()
            ok, err, atol = within(got, want)
            check(got.shape == want.shape and ok,
                  f"entry_block disagrees with its plain version at [{B},{c_in},{H},{W}], M {m}: max abs err {err} "
                  f"(atol {atol:.3g}), tiling {eb.tiling(c_in, m, H, W, B)}")
    print(f"entry_block within the CNN bar of its plain version on random weights at {len(ENTRY_BLOCK_CASES)} "
          f"ragged shapes [{card}]", flush=True)
    for name, res in (("face_landmark.onnx", 192), ("face_detection_short_range.onnx", 128)):
        net = load_model((ROOT / "assets" / "onnx" / name).read_bytes(), device)
        xin = torch.rand(8, 3, res, res, device=device, generator=gen) * 2 - 1
        with torch.inference_mode():
            runs = counted(lambda: net(xin))
        check(net.entry_blocks == [] and runs == (0, 0), f"{name}: {runs} entry blocks and launches a forward")
    tot = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    bound_by = set()
    for name, res, batch in (("face_landmarks_detector.onnx", 256, 512), ("iris_landmark.onnx", 64, 1024)):
        net = load_model((ROOT / "assets" / "onnx" / name).read_bytes(), device)
        check(len(net.entry_blocks) == ENTRY_BLOCKS, f"{name}: {len(net.entry_blocks)} entry blocks in the plan")
        flops = analyze(net).flops
        with net.without_plans("entry_blocks"):
            op_by_op = analyze(net).flops
        check(flops == op_by_op, f"{name}: analyze counts {flops} FLOPs with the entry block plan, {op_by_op} without")
        gen = torch.Generator(device=device).manual_seed(5)
        xin = torch.rand(batch, 3, res, res, device=device, generator=gen) * 2 - 1
        with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            box = {}
            runs = counted(lambda: box.setdefault("fused", net(xin)))
            check(runs == (ENTRY_BLOCKS, ENTRY_BLOCKS), f"{name}: a forward counted (blocks, launches) {runs}")
            with net.without_plans("entry_blocks"):
                plain = net(xin)
            worst = max(within(a, b)[1] / within(a, b)[2] for a, b in zip(box["fused"], plain))
            print(f"{name} at {batch}, the whole network with and without the entry block plan: largest difference "
                  f"{worst:.3g} of the CNN bar's atol [{card}]", flush=True)
            with net.without_plans():
                env = net.activations(xin)
            params = {**net._static, **net.params()}
            for k, blk in enumerate(net.entry_blocks):
                packed = net._packed[blk.at]
                for b in (batch, 1):
                    x = env[blk.input][:b].contiguous()
                    B, C, H, W = x.shape

                    def chain(x=x, blk=blk):
                        vals = {**params, blk.input: x}
                        for i in blk.nodes:
                            node = net.nodes[i]
                            vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[n] for n in node.inputs])
                        return vals[blk.output]

                    kernel = lambda x=x, p=packed, blk=blk: eb.fused_entry_block(x, p, blk.m)  # noqa: E731
                    got, ops_out = kernel(), chain()
                    torch.cuda.synchronize()
                    ok, err, atol = within(got, ops_out)
                    ms = cuda_ms(torch, kernel, queued=True)
                    chain_ms = cuda_ms(torch, chain, reps=20, queued=True)
                    ops = eb.entry_block_flops(tuple(x.shape), packed.shape, blk.m)
                    t_bytes = (x.numel() + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / F32_FLOPS * 1e3
                    bound = max(t_bytes, t_ops)
                    by = "bytes" if t_bytes >= t_ops else "operations"
                    print(f"entry_block, {name} block {k}: [{B},{C},{H},{W}] -> {blk.c_out}, M {blk.m} (tile rows, "
                          f"images, chunk {eb.tiling(C, blk.m, H, W, B)}): {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                          f"{100 * bound / ms:.1f}% of it; per-op chain {chain_ms:.4f} ms; max abs err {err:.3g} "
                          f"(atol {atol:.3g}, rtol {CNN_RTOL}) [{card}]", flush=True)
                    check(ok, f"entry_block disagrees with the per-op chain at {name} block {k}, batch {B}")
                    if b == batch and name.startswith("face_landmarks"):
                        for key, v in (("ms", ms), ("library_ms", chain_ms), ("bound_ms", bound)):
                            tot[key] += v
                        tot["err"] = max(tot["err"], err)
                        bound_by.add(by)
            del env
    refusals = {
        "24 channels": lambda: eb.fused_entry_block(torch.zeros(2, 24, 8, 8, device=device),
                                                    torch.zeros(eb.row_floats(24, 16), device=device), 16),
        "odd H": lambda: eb.fused_entry_block(torch.zeros(2, 16, 7, 8, device=device),
                                              torch.zeros(eb.row_floats(16, 16), device=device), 16),
        "float64": lambda: eb.fused_entry_block(torch.zeros(2, 16, 8, 8, device=device, dtype=torch.float64),
                                                torch.zeros(eb.row_floats(16, 16), device=device), 16),
        "channels_last": lambda: eb.fused_entry_block(
            torch.zeros(2, 16, 8, 8, device=device).to(memory_format=torch.channels_last),
            torch.zeros(eb.row_floats(16, 16), device=device), 16),
    }
    for what, fn in refusals.items():
        try:
            fn()
            refused = False
        except ValueError:
            refused = True
        check(refused, f"the entry block kernel took {what}")
    print(f"entry_block, Face Mesh V2's six blocks at batch 512: {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f}%), per-op chain {tot['library_ms']:.4f} ms; refused "
          f"{sorted(refusals)} [{card}]", flush=True)
    if img is not None:
        from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV2
        from zaru_tpu_torch.pipeline import FaceTracker

        frames = img.expand(512, *img.shape).contiguous()
        v2, iris = FaceTracker(landmarker=FaceMeshV2(device=device), device=device), FaceTracker(iris=True, device=device)
        for what, tr, net in (("FaceTracker(landmarker=FaceMeshV2())", v2, v2.lm_cnn.net),
                              ("FaceTracker(iris=True)", iris, iris.eye_cnn.net)):
            box = {"state": tr.init_state(512)}

            def step(i, tr=tr, box=box):
                box["state"], box["out"] = tr.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

            times = {}
            for plan in (True, False, False, True):
                with contextlib.nullcontext() if plan else net.without_plans("entry_blocks"):
                    runs = {}
                    dt, launches = timed_run(torch, step, what, FACE_KERNELS, runs)
                times.setdefault(plan, []).append(dt / STEPS * 1e3)
                check_entry_block_launches(what, launches, runs["steps"], ENTRY_BLOCKS if plan else 0)
            print(f"{what} at 512, detect every 9th step: {[round(t, 3) for t in times[True]]} ms/step with the "
                  f"entry block plan, {[round(t, 3) for t in times[False]]} without [{card}]", flush=True)
    return {
        "name": "entry_block", "route": "cuda", "source": "zaru_tpu_torch/csrc/entry_block.cu",
        "replaces": "none (XLA's per-op blocks)", "path": "Face Mesh V2, six entry blocks at batch 512",
        "max_abs_err": tot["err"], "ms": tot["ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "+".join(sorted(bound_by)), "library_ms": tot["library_ms"],
        "library": "per-op chain: max_pool2d, F.pad, F.conv2d 2x2 stride 2, torch.where PReLU, F.conv2d depthwise, "
                   "F.conv2d 1x1, add, torch.where PReLU",
    }


def body_photo(torch, np, device):
    """tests/test_torch_body.py ``photo()``: the fixture photo subsampled to
    320×180, RGBA u8 on the card."""
    from zaru_tpu_torch.assets import fixture_path

    with np.load(fixture_path("sad_linus_track.npz")) as f:
        rgb = f["rgb"][::4, ::4]
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
    return torch.from_numpy(np.ascontiguousarray(rgba)).to(device)


def unmap_u8(torch, np, c):
    """tests/test_torch_body.py ``unmap_u8``: the [0, 1] colour map of u8
    channels, ``c * f32(1/255)`` rounded once."""
    return (torch.from_numpy(c).double() * float(np.float32(1.0) / np.float32(255.0))).float()


def phase_body_shapes_vs_plain(torch, np, device):
    """The samplers at BodyTracker's shapes against their plain versions, bit
    for bit: the rotated kernel on 64 square 256×256 views of 150-900 px at
    any angle, partly outside the frame, on the 256-pixel grid, colour range
    [0, 1] (planar and NHWC); the views stored from JAX in body_track.npz
    against JAX's output; the letterbox at 224², colour range [-1, 1], on
    1080p and 720p frames (the full-frame fit and offset, scaled rects)."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.ops.letterbox import letterbox_sample, letterbox_sample_planar_reference
    from zaru_tpu_torch.ops.letterbox import letterbox_sample_reference
    from zaru_tpu_torch.ops.rotated_fast import rotated_sample_fast
    from zaru_tpu_torch.pipeline import _ops
    from zaru_tpu_torch.resolution import Resolution

    gen = torch.Generator(device="cpu").manual_seed(4)
    B = 64
    frames = coord_frames(torch, B, 1080, 1920, device)
    u = lambda lo, hi: lo + torch.rand(B, generator=gen) * (hi - lo)  # noqa: E731
    size = u(150, 900)
    body = torch.stack([u(-150, 2070), u(-150, 1230), size, size, u(-3.15, 3.15)], -1).reshape(B, 1, 5)
    got = check_rotated(torch, "body views (150-900 px, any angle, partly outside)", frames, body.to(device),
                        256, 0.0, 1.0, 256)
    check(bool((got == 0.0).all(-1).any()), "no body view reads outside the frame")
    with np.load(fixture_path("body_track.npz")) as f:
        rects, want = torch.from_numpy(f["views_rects"]).to(device), unmap_u8(torch, np, f["views_u8"])
    got = rotated_sample_fast(frames[: rects.shape[0]], rects, 256, 256, 0.0, 1.0, 256).cpu()
    differ = int((got != want).sum())
    print(f"rotated_sample kernel vs JAX's stored run at the body shape: {tuple(got.shape)} on the 256-px grid "
          f"(square views, strides 1-5): {differ} values differ", flush=True)
    check(differ == 0, "rotated_sample kernel differs from JAX's stored body views")

    for H, W in ((1080, 1920), (720, 1280)):
        fr = torch.randint(0, 256, (8, H, W, 4), generator=gen, dtype=torch.uint8).to(device)
        _fit, fit_rrect = _ops.full_frame_fit(fr, Resolution(224, 224))
        rr = fit_rrect.expand(8, 5).clone()
        rr[4:, 0] += torch.tensor([-300.0, 200.0, 31.3, 700.0], device=device)
        rr[4:, 2:4] *= torch.tensor([[0.61], [0.61], [420 / float(rr[0, 2])], [0.61]], device=device)
        got = letterbox_sample(fr, rr, 224, 224, -1.0, 1.0)
        want = letterbox_sample_reference(fr, rr, 224, 224, -1.0, 1.0)
        got_p = letterbox_sample(fr, rr, 224, 224, -1.0, 1.0, layout="NCHW")
        want_p = letterbox_sample_planar_reference(fr, rr, 224, 224, -1.0, 1.0)
        torch.cuda.synchronize()
        differ, differ_p = int((got != want).sum()), int((got_p != want_p).sum())
        print(f"letterbox_sample vs plain at the pose detector's shape, {W}x{H}: {tuple(got.shape)}, range "
              f"[-1, 1], {differ} values differ (NHWC), {differ_p} (planar)", flush=True)
        check(differ == 0 and differ_p == 0, "letterbox_sample kernel disagrees with its plain version at 224^2")


def write_body_stubs(np, directory):
    """The stub pose blobs stored in body_track.npz, written into
    ``directory`` under the model names BodyTracker loads."""
    from zaru_tpu_torch.assets import fixture_path

    with np.load(fixture_path("body_track.npz")) as f:
        for key, names in BODY_BLOBS.items():
            for name in names:
                (Path(directory) / name).write_bytes(f[key].tobytes())


def phase_body_vs_jax(torch, np, device):
    """BodyTracker on the stub models against body_track.npz (see
    tests/test_torch_body.py): the networks' raw outputs and the port's
    decode of JAX's, the detection candidates and ``_candidate_rois`` on
    random keypoints, then each run (gated, ``run_frame``, ``run_frames``)
    one step at a time from JAX's state and free-running by its flags."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.pipeline import BodyTracker, _ops

    with np.load(fixture_path("body_track.npz")) as f:
        ref = {k: f[k] for k in f.files}
    tracker = BodyTracker(max_bodies=2, device=device)
    frame = body_photo(torch, np, device)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    _fit, fit_rrect = _ops.full_frame_fit(frame, tracker.det_cnn.input_resolution())
    det = tracker.det_cnn.apply_views_letterbox(frame[None], fit_rrect[None])
    lm = tracker.lm_cnn.apply_on_view(frame[None], dev(ref["lm_view"])[None])
    raw_err = max(float((o.cpu() - torch.from_numpy(ref[k])).abs().max())
                  for o, k in zip(det + lm, ("det_out0", "det_out1", "lm_out0", "lm_out1")))
    check(len(lm) == 2 and raw_err <= 1e-6, f"body networks' outputs differ from JAX by {raw_err}")
    dec = [t[0].cpu().numpy() for t in tracker.detector.decode_device(
        [dev(ref["det_out0"]), dev(ref["det_out1"])], tracker.detection_threshold)]
    dec += [t[0].cpu().numpy() for t in tracker.landmarker.decode_device([dev(ref["lm_out0"]), dev(ref["lm_out1"])])]
    keys = ("det_boxes", "det_conf", "det_kps", "det_angles", "lm_coords", "lm_flag", "lm_vis", "lm_pres")
    dec_err = max(float(np.abs(d - ref[k]).max()) for d, k in zip(dec, keys))
    check(dec_err <= BODY_SCORE_TOL, f"body decoders differ from JAX by {dec_err}")
    rois, valid = tracker._detect_batch(frame.expand(2, *frame.shape).contiguous())
    cand_err = float(np.abs(rois.cpu().numpy() - ref["cand_rois"]).max())
    check((valid.cpu().numpy() == ref["cand_valid"]).all() and cand_err <= BODY_TOL_PX,
          f"body detection candidates differ from JAX by {cand_err}")
    rng = np.random.default_rng(9)  # tests/test_torch_body.py norm_inputs()
    box, kps, ang = (rng.uniform(0, 224, (8, 2, 4)).astype(np.float32),
                     rng.uniform(0, 224, (8, 2, 4, 2)).astype(np.float32),
                     rng.uniform(-3, 3, (8, 2)).astype(np.float32))
    fit, _ = _ops.full_frame_fit(frame, tracker.det_cnn.input_resolution())
    norm = tracker._candidate_rois(dev(box), dev(kps), dev(ang), fit, tracker.det_cnn.input_resolution())
    norm_err = float(np.abs(norm.cpu().numpy() - ref["norm_rois"]).max())
    check(norm_err <= BODY_NORM_TOL_PX, f"body _candidate_rois differ from JAX by {norm_err}")

    errs = {}
    for run in ("gated", "single", "ungated"):
        r = lambda k: ref[f"{run}__{k}"]  # noqa: E731
        entry = str(r("entry"))

        def step(state, t):
            frames = frame.expand(2, *frame.shape).clone()
            frames[torch.from_numpy(r("zero")[t]).to(device)] = 0
            if entry == "run_frame":
                return tracker.run_frame(state, frames[0])
            if entry == "run_frames":
                return tracker.run_frames(state, frames)
            return tracker.step_batch(state, frames, bool(r("force")[t]))

        state = None
        for t in range(len(r("force"))):
            start = {k: dev(r(f"state_{k}")[t]) for k in ("rois", "active", "frame")}
            _, out = step(start, t)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            check((out["valid"] == r("out_valid")[t]).all(), f"body {run} step {t}: flags differ from JAX")
            for k in ("landmarks", "pose_landmarks", "rois", "pose_flag", "visibility", "presence"):
                err = float(np.abs(out[k] - r(f"out_{k}")[t]).max())
                tol = BODY_TOL_PX if "landmarks" in k or k == "rois" else BODY_SCORE_TOL
                check(err <= tol, f"body {run} step {t}: {k} differs from JAX by {err} (tolerance {tol})")
                errs[k] = max(errs.get(k, 0.0), err)
            kind = str(r("start")[t])
            fresh = tracker.init_state(None if entry == "run_frame" else 2)
            state = fresh if kind == "init" else start if kind == "seed" else state
            state, out = step(state, t)
            check((out["valid"].cpu().numpy() == r("out_valid")[t]).all(),
                  f"body {run} free-running step {t}: flags differ from JAX")
    print(f"BodyTracker(max_bodies=2) on the stub models vs JAX reference: raw network outputs within {raw_err:.3g}, "
          f"decoders within {dec_err:.3g}, candidates within {cand_err:.3g} px, _candidate_rois on random "
          f"keypoints within {norm_err:.3g} px; gated, run_frame and run_frames one step at a time max errors "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tolerances {BODY_TOL_PX} px, {BODY_SCORE_TOL}); "
          f"free-running flags equal at every step", flush=True)


def phase_body_full_size(torch, img, device, card, batch=512):
    """BodyTracker (one body a stream, stub models) at batch 512 on the
    1080p photo, 54 steps after 9, detection forced every 9th step: ms/step,
    frames/s, the device's busy share, and both sampler kernels launched."""
    import numpy as np

    from zaru_tpu_torch.pipeline import BodyTracker

    tracker = BodyTracker(device=device)
    frames = img.expand(batch, *img.shape).contiguous()
    box = {"state": tracker.init_state(batch)}

    def step(i):
        box["state"], box["out"] = tracker.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

    what = "BodyTracker (stub pose models)"
    dt, launches = timed_run(torch, step, what, HAND_KERNELS)
    out = box["out"]
    check(tuple(out["landmarks"].shape) == (batch, 1, 39, 3) and bool(torch.isfinite(out["landmarks"]).all())
          and bool(out["valid"].all()), f"{what}: landmarks {tuple(out['landmarks'].shape)}, valid "
          f"{int(out['valid'].sum())} of {batch}")
    check(launches["letterbox_sample"] == STEPS // 9 and launches["rotated_sample"] == STEPS,
          f"{what}: launches {launches}")
    busy = profile_steps(torch, step, batch, what)
    view = float(box["state"]["rois"][0, 0, 2])
    print(f"{what} at 1920x1080, batch {batch}: {STEPS} steps (detect every 9th) in {dt:.3f} s: "
          f"{dt / STEPS * 1e3:.3f} ms/step, {batch * STEPS / dt:.1f} frames/s, device busy {100 * busy:.1f}%, "
          f"tracked ROI {view:.1f} px (stride {int(np.ceil((view + 2) / 256))} on the 256-px grid), "
          f"all valid; launches {launches} [{card}]", flush=True)
    check_no_layout_copy(torch, step, [(256, 256), (224, 224)], what)
    return tracker, frames, box["state"], launches


def memory_factory(frame, name, n=None):
    """A source of ``frame`` (host numpy), ``n`` times or forever."""
    def factory():
        i = 0
        while n is None or i < n:
            i += 1
            yield frame

    factory.name = name
    return factory


def profile_serve(torch, run, steps):
    """torch.profiler over ``run()`` (``steps`` serve steps): device kernel
    time and host→device copy time per step, and their shares of the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel = copy = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        if "Memcpy HtoD" in e.key:
            copy += ms
        elif "Memcpy" not in e.key and "Memset" not in e.key:
            kernel += ms
    return wall / steps, kernel / steps, copy / steps


class RecordingTracker:
    """A tracker whose gated step records the state it starts from."""

    def __init__(self, tracker):
        self.tracker, self.states = tracker, []

    def init_state(self, batch=None):
        return self.tracker.init_state(batch)

    def run_frames_gated(self, state, frames):
        self.states.append(state)
        return self.tracker.run_frames_gated(state, frames)


def phase_serve(torch, np, img, device, card, tracker, tiled_ms, run_frame_ms):
    """The serving entry points on the card, with in-memory sources of host
    1080p RGBA frames (the photo, each stream's shifted a few pixels):
    ``measure_ingest_bandwidth`` at 64; the uploader's device batches
    against the staged frames over 16 flushes (device checksums, read once
    at the end); ``serve_loop`` at 64 streams bit-equal to
    ``run_frames_gated`` on the same frames uploaded at once (9 steps); the
    loop's figures over 54 steps after 9 (fresh frames/s end to end, p50/p95
    ms/step, drops, host time staging and issuing the upload) and a 9-step
    profile; a join's slot reset to a fresh state; one stream in ms/frame.
    Frames are in memory: the card's machine has no image decoder, so file
    decoding is left to the CPU tests."""
    from zaru_tpu_torch.pipeline.ingest import FrameUploader, measure_ingest_bandwidth
    from zaru_tpu_torch.serve import StreamSet, serve_loop

    B = SERVE_STREAMS
    host = img.cpu().numpy()
    frames = [np.ascontiguousarray(np.roll(host, (s % 8, 3 * (s // 8)), axis=(0, 1))) for s in range(B)]
    bw = measure_ingest_bandwidth(batch=B, shape=host.shape, iters=20, device=device)
    print(f"ingest at batch {B}, 1920x1080 RGBA u8 from page-locked memory: {bw['gbytes_per_s']:.3f} GB/s, "
          f"{bw['frames_per_s']:.1f} frames/s [{card}]", flush=True)

    t0 = time.perf_counter()
    up = FrameUploader(B, host.shape, device)
    pin_s = time.perf_counter() - t0
    want = [int(f.view(np.int32).sum(dtype=np.int64)) for f in frames]
    sums = []
    for n in range(16):
        for s in range(B):
            up.stage(s, frames[(s + n) % B])
        dev = up.flush()
        sums.append(dev.view(torch.int32).sum(dim=(1, 2, 3), dtype=torch.int64))
    got = torch.stack(sums).cpu().numpy()
    bad = int(sum(got[n][s] != want[(s + n) % B] for n in range(16) for s in range(B)))
    print(f"FrameUploader at batch {B}: two page-locked staging buffers of {B * host.nbytes / 1e9:.2f} GB "
          f"allocated in {pin_s:.2f} s; 16 flushes with the slots' frames rotated each time and no host read "
          f"between them: {bad} of {16 * B} device checksums differ from the staged frames", flush=True)
    check(bad == 0, "an uploaded batch differs from the frames staged for it")

    def streams_of():
        return StreamSet([memory_factory(frames[s], f"memory{s}") for s in range(B)])

    streams = streams_of()
    streams.prime()
    outs = []
    serve_loop(tracker, streams, up, single=False, steps=9,
               emit=lambda rec, out: outs.append({k: out[k].clone() for k in ("valid", "landmarks")}))
    streams.close()
    direct = torch.from_numpy(np.stack(frames)).to(device)
    state = tracker.init_state(B)
    for t in range(9):
        state, out = tracker.run_frames_gated(state, direct)
        check(torch.equal(outs[t]["valid"], out["valid"]) and torch.equal(outs[t]["landmarks"], out["landmarks"]),
              f"serve_loop step {t} differs from run_frames_gated on the same frames")
    check(bool(out["valid"].all()), "serve_loop: lost the face")
    print(f"serve_loop at {B} streams: 9 steps bit-equal to run_frames_gated on the same frames uploaded at once "
          "(valid, landmarks)", flush=True)
    del direct

    def timed(single, steps, streams, up):
        stage0, flush0 = up.stage_seconds, up.flush_seconds
        zero_launches()
        t0 = time.perf_counter()
        stats = serve_loop(tracker, streams, up, single=single, steps=steps, emit=lambda rec, out: None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        return dt, stats, launches, (up.stage_seconds - stage0) / steps, (up.flush_seconds - flush0) / steps

    for n in (WARMUP, STEPS):  # warm-up, then the timed run; each starts from a fresh state
        streams = streams_of()
        streams.prime()
        dt, stats, launches, stage_s, flush_s = timed(False, n, streams, up)
        streams.close()
    check(all(launches[k] > 0 for k in FACE_KERNELS), f"serving: a kernel of the path was never launched: {launches}")
    fps = stats.frames / dt
    p50, p95 = stats._pct(50) * 1e3, stats._pct(95) * 1e3
    drops = sum(streams.drops)
    streams = streams_of()
    streams.prime()
    wall, kernel, copy = profile_serve(torch, lambda: serve_loop(
        tracker, streams, up, single=False, steps=9, emit=lambda rec, out: None), 9)
    streams.close()
    print(f"serving (serve_loop, FaceTracker.run_frames_gated) at {B} streams of in-memory 1920x1080 frames: "
          f"{STEPS} steps in {dt:.3f} s: {stats.frames} fresh frames, {fps:.1f} frames/s end to end, step p50 "
          f"{p50:.3f} ms / p95 {p95:.3f} ms, drops {drops}; host time a step staging {stage_s * 1e3:.3f} ms, "
          f"issuing the upload {flush_s * 1e3:.3f} ms; PCIe at the measured rate "
          f"{B * host.nbytes / bw['gbytes_per_s'] / 1e6:.3f} ms a batch; 9-step profile: {wall:.3f} ms/step wall, "
          f"device kernels {kernel:.3f} ms/step ({100 * kernel / wall:.1f}%), host-to-device copies "
          f"{copy:.3f} ms/step ({100 * copy / wall:.1f}%); launches {launches} [{card}]", flush=True)
    print(f"serving beside the tiled run at batch {B}: serve_loop {dt / STEPS * 1e3:.3f} ms/step ({fps:.1f} "
          f"frames/s, ingest included) against the main path on frames tiled on the card {tiled_ms:.3f} ms/step "
          f"({B / tiled_ms * 1e3:.1f} frames/s): ingest and the loop cost "
          f"{dt / STEPS * 1e3 - tiled_ms:.3f} ms/step", flush=True)

    recorder = RecordingTracker(tracker)
    streams = StreamSet([memory_factory(frames[0], "finite0", n=2)] +
                        [memory_factory(frames[s], f"memory{s}") for s in range(1, B)],
                        pending=[memory_factory(frames[1], "joiner")])
    streams.prime()
    lines, recs = [], []
    serve_loop(recorder, streams, up, single=False, steps=5, no_loop=True, log=lines.append,
               emit=lambda rec, out: recs.append(rec))
    streams.close()
    joined = next(i for i, r in enumerate(recs) if i > 0 and r.get("active", [False])[0])
    fresh = tracker.init_state(B)
    start = recorder.states[joined]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    fresh_leaves = dict(leaves(fresh))
    reset_ok = all(torch.equal(v[0], fresh_leaves[k][0]) for k, v in leaves(start))
    carried = bool(start["tracking"][1:].all())
    print(f"serve_loop join at {B} streams: {[ln for ln in lines if 'slot 0' in ln]}; at step {joined} slot 0 "
          f"starts from a fresh state {reset_ok}, the other slots keep tracking {carried}, slot 0 valid after "
          f"the step {recs[joined]['valid'][0]}", flush=True)
    check("stream slot 0: leave" in lines and "stream slot 0: join (joiner)" in lines and reset_ok and carried
          and recs[joined]["valid"][0], "serve_loop: the joined slot was not reset to a fresh state")

    one = FrameUploader(1, host.shape, device)
    for n in (WARMUP, STEPS):
        streams = StreamSet([memory_factory(frames[0], "memory0")])
        streams.prime()
        dt1, stats1, launches1, stage1, _ = timed(True, n, streams, one)
        streams.close()
    check(launches1["blaze_stage"] > 0 and launches1["rotated_sample"] == 0,
          f"serve_loop, one stream: launches {launches1}")
    print(f"serving one stream (serve_loop, run_frame): {STEPS} frames in {dt1:.3f} s: {dt1 / STEPS * 1e3:.3f} "
          f"ms/frame, {stats1.frames / dt1:.1f} frames/s, staging {stage1 * 1e3:.3f} ms/frame; beside phase 5's "
          f"run_frame on a frame on the card {run_frame_ms:.3f} ms/frame; launches {launches1} [{card}]", flush=True)
    return launches


# tests/test_torch_host.py: inputs and tolerances of the host engines'
# comparisons with JAX (op graphs, models at batch 1, Detector, Estimator,
# LandmarkTracker).
HOST_OP_TOL = 1e-6
HOST_DET_TOL_PX, HOST_SCORE_TOL, HOST_ANGLE_TOL = 1e-3, 1e-5, 1e-5
HOST_LM_TOL_PX, HOST_TRACK_FREE_TOL_PX = 1e-2, 0.25
HOST_PALM_THRESHOLD = 0.1
HOST_FACE_VIEW = (699.0, 405.0, 400.0, 440.0, 0.12)
HOST_SEED_ROI = (698.8, 420.7, 300.0, 300.0, 0.05)
HOST_OP_SHAPE = (2, 3, 11, 9)
HOST_MODELS = ["slim_160_latest.onnx", "landmarks_68_pfld.onnx", "mobilefacenet.onnx",
               "face_detection_short_range.onnx"]
# tests/test_torch_eval.py: the reduced sweep's transforms and each runner's
# tolerance against JAX's rows (px).
EVAL_REDUCED = [("identity", 0.0, 1.0), ("rot+10", 10.0, 1.0), ("scale0.85", 0.0, 0.85)]
EVAL_SWEEP_TOL_PX = {"face_mesh": 0.25, "face_mesh_v2": 0.25, "iris": 0.5, "multipie68_peppa": 1e-3,
                     "multipie68_onnx": 1e-3, "hand": 0.0}
# The runners whose networks hold BlazeBlock chains (every face runner
# detects with short-range BlazeFace); the hand runner has none.
EVAL_STAGE_RUNNERS = ("face_mesh", "face_mesh_v2", "iris", "multipie68_peppa", "multipie68_onnx")
HOST_CALLS = 50


class PlainWatch:
    """Counts, while active, the calls of the kernels' plain versions that
    are given a CUDA tensor (their wrappers call them for CPU tensors only)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = {}

    def __enter__(self):
        from zaru_tpu_torch.ops import cnn_stage, letterbox, rotated_fast, yuv

        self._saved = []
        for mod, name in ((cnn_stage, "blaze_blocks_reference"), (rotated_fast, "rotated_sample_fast_reference"),
                          (letterbox, "letterbox_sample_planar_reference"), (letterbox, "letterbox_sample_core"),
                          (yuv, "rgb_to_yuv_fast_reference")):
            fn = getattr(mod, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                if any(isinstance(a, self.torch.Tensor) and a.is_cuda for a in args):
                    self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*args, **kwargs)

            setattr(mod, name, counted)
            self._saved.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def host_fixture(np):
    from zaru_tpu_torch.assets import fixture_path

    with np.load(fixture_path("host_eval.npz")) as f:
        return ({k[6:]: f[k] for k in f.files if k.startswith("host__")},
                {k[6:]: f[k] for k in f.files if k.startswith("eval__")})


def detections_arrays(np, dets):
    """tests/test_torch_host.py ``detections_arrays``: conf, rect, kps,
    angle of a ``Detections``."""
    dets = list(dets)
    return {
        "conf": np.asarray([d.confidence() for d in dets], np.float32),
        "rect": np.asarray([d.bounding_rect().array for d in dets], np.float32).reshape(-1, 4),
        "kps": np.asarray([np.stack(d.keypoints()) for d in dets], np.float32),
        "angle": np.asarray([d.angle() for d in dets], np.float32),
    }


def eval_transforms():
    from zaru_tpu_torch import eval as ev

    return [ev.Transform(n, angle_deg=a, scale=s) for n, a, s in EVAL_REDUCED]


def rows_error(np, rows, ref, name):
    """Max deviation of a runner's rows from JAX's stored rows; fails on a
    different transform list, flag or missing value."""
    names = [r["transform"] for r in rows]
    check(names == ref[f"sweep/{name}/names"].tolist(), f"eval {name}: rows {names}")
    check([r["valid"] for r in rows] == ref[f"sweep/{name}/valid"].tolist(), f"eval {name}: flags differ from JAX")
    got = np.asarray([[r.get(k, np.nan) for k in ("mean_px", "p95_px", "max_px")] for r in rows], np.float64)
    want = ref[f"sweep/{name}/px"]
    check((np.isnan(got) == np.isnan(want)).all(), f"eval {name}: rows with values differ from JAX")
    return float(np.nan_to_num(np.abs(got - want)).max()) if got.size else 0.0


def phase_host_vs_jax(torch, np, device, rgba):
    """The host engines and the eval sweep against host_eval.npz (see
    tests/test_torch_host.py and tests/test_torch_eval.py), on the card: the
    op graphs and four models at batch 1, ``Detector.detect`` (short-range
    face, palm at threshold 0.1), ``Estimator.estimate`` (Face Mesh V1 and
    both 68-point networks), two ``LandmarkTracker.track`` steps from JAX's
    ROIs and free-running, the loss on a blank frame, each runner's reduced
    sweep on the 535×535 photo; then the full sweep (8 transforms, both
    photos, 6 runners) with the identity rows exact. No plain version of a
    kernel runs on the card."""
    from zaru_tpu_torch import eval as ev
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.detection import Detector
    from zaru_tpu_torch.face.detection import ShortRangeNetwork
    from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV1
    from zaru_tpu_torch.face.landmark.multipie68 import FaceOnnx, PeppaFacialLandmark
    from zaru_tpu_torch.hand.detection import LiteNetwork as Palm
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.landmark import Estimator, LandmarkTracker
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.rect import RotatedRect

    host, ref = host_fixture(np)
    errs = {}
    with PlainWatch(torch) as watch, torch.inference_mode():
        x = torch.from_numpy(np.random.default_rng(11).normal(size=HOST_OP_SHAPE).astype(np.float32)).to(device)
        for key in sorted(k for k in host if k.startswith("graph/")):
            name = key[len("graph/"):]
            out = load_model(host[key].tobytes(), device)(x[:1] if name == "const" else x)[0].cpu().numpy()
            want = host[f"op/{name}"]
            check(out.shape == want.shape, f"op graph {name}: shape {out.shape}, JAX {want.shape}")
            err = float(np.abs(out - want).max())
            check(err <= (0.0 if name == "const" else HOST_OP_TOL), f"op graph {name} differs from JAX by {err}")
            errs["ops"] = max(errs.get("ops", 0.0), err)
        for name in HOST_MODELS:
            m = load_model(model_path(name), device)
            shape = [d if isinstance(d, int) else 1 for d in m.input_info[0].shape]
            inp = np.random.default_rng(12).uniform(-1, 1, shape).astype(np.float32)
            for i, o in enumerate(m(torch.from_numpy(inp).to(device))):
                want = host[f"model/{name}/{i}"]
                got = o.cpu().numpy()
                tol = 1e-3 * max(1.0, float(np.abs(want).max()))
                check(bool((np.abs(got - want) <= tol + 2e-3 * np.abs(want)).all()),
                      f"{name} output {i} outside the CNN bar of JAX's")
                errs["models"] = max(errs.get("models", 0.0), float(np.abs(got - want).max()))

    nets = {"face": ShortRangeNetwork(device=device), "palm": Palm(device=device), "v1": FaceMeshV1(device=device),
            "peppa": PeppaFacialLandmark(device=device), "pfld": FaceOnnx(device=device)}
    image = Image(rgba, device)
    with PlainWatch(torch) as watch2:
        for key, threshold in (("face", 0.5), ("palm", HOST_PALM_THRESHOLD)):
            det = Detector(nets[key])
            det.set_threshold(threshold)
            got = detections_arrays(np, det.detect(image))
            for k, tol in (("conf", HOST_SCORE_TOL), ("rect", HOST_DET_TOL_PX), ("kps", HOST_DET_TOL_PX),
                           ("angle", HOST_ANGLE_TOL)):
                want = host[f"det_{key}_{k}"]
                check(got[k].shape == want.shape, f"Detector({key}): {k} {got[k].shape}, JAX {want.shape}")
                err = float(np.abs(got[k] - want).max())
                check(err <= tol, f"Detector({key}): {k} differs from JAX by {err} (tolerance {tol})")
                errs[f"detect {key} {k}"] = err
        view = image.view(RotatedRect(np.asarray(HOST_FACE_VIEW, np.float32)))
        for key in ("v1", "peppa", "pfld"):
            est = Estimator(nets[key]).estimate(view)
            err = float(np.abs(est.landmarks_mut().positions() - host[f"est_{key}_pos"]).max())
            check(err <= HOST_LM_TOL_PX, f"Estimator({key}) differs from JAX by {err} px")
            errs[f"estimate {key}"] = err
        tracker = LandmarkTracker(Estimator(nets["v1"]))
        for t, roi in enumerate([np.asarray(HOST_SEED_ROI, np.float32), host["track0_roi"]]):
            tracker.set_roi(RotatedRect(roi))
            r = tracker.track(image)
            check(r is not None, f"LandmarkTracker step {t} lost the face")
            err = float(np.abs(r.estimate().landmarks_mut().positions() - host[f"track{t}_pos"]).max())
            roi_err = float(np.abs(tracker.roi().array[:4] - host[f"track{t}_roi"][:4]).max())
            check(err <= HOST_LM_TOL_PX and roi_err <= HOST_LM_TOL_PX,
                  f"LandmarkTracker step {t} from JAX's ROI differs by {err} px (ROI {roi_err} px)")
            errs[f"track {t}"] = max(err, roi_err)
        tracker.set_roi(RotatedRect(np.asarray(HOST_SEED_ROI, np.float32)))
        for t in range(2):
            err = float(np.abs(tracker.track(image).estimate().landmarks_mut().positions()
                               - host[f"track{t}_pos"]).max())
            check(err <= HOST_TRACK_FREE_TOL_PX, f"LandmarkTracker free-running step {t} differs by {err} px")
            errs[f"track free {t}"] = err
        blank = LandmarkTracker(Estimator(nets["v1"]))
        blank.set_roi(RotatedRect(np.asarray(HOST_SEED_ROI, np.float32)))
        check(blank.track(Image(torch.zeros_like(rgba), device)) is None and blank.roi() is None
              and bool(host["blank_lost"]), "LandmarkTracker kept tracking a blank frame")

        cropped = ref["cropped"]
        for name in ev.RUNNERS:
            rows = ev.evaluate_runner(ev.RUNNERS[name](device=device), cropped, eval_transforms(), device=device)
            err = rows_error(np, rows, ref, name)
            check(err <= EVAL_SWEEP_TOL_PX[name],
                  f"eval {name}: reduced sweep differs from JAX by {err} px (tolerance {EVAL_SWEEP_TOL_PX[name]})")
            errs[f"sweep {name}"] = err
    for w in (watch, watch2):
        check(not w.calls, f"a plain version of a kernel ran on the card: {w.calls}")
    print("host engines vs JAX reference on the card: max errors "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (ops {HOST_OP_TOL}, models the CNN bar, detections "
          f"{HOST_DET_TOL_PX} px / {HOST_SCORE_TOL} / {HOST_ANGLE_TOL} rad, landmarks {HOST_LM_TOL_PX} px, free "
          f"tracking {HOST_TRACK_FREE_TOL_PX} px, sweeps {EVAL_SWEEP_TOL_PX}); a blank frame loses tracking; no plain "
          f"kernel version ran on the card", flush=True)
    return nets, image, cropped


def full_sweep(torch, np, device, cropped, rgba, card, what):
    """The full sweep (DEFAULT_TRANSFORMS, both photos) for every runner:
    identity rows exact, the face runners valid everywhere, the hand runner
    n/a; each runner's wall time and launches (zeroed just before, read
    just after), the stage kernel launched by every face runner and no
    plain kernel version on the card. → {runner: (seconds, launches,
    summaries)}."""
    from zaru_tpu_torch import eval as ev

    photos = {"sad_linus.jpg": rgba.cpu().numpy(), "sad_linus_cropped.jpg": cropped}
    result = {}
    for name in ev.RUNNERS:
        run = ev.RUNNERS[name](device=device)
        torch.cuda.synchronize()
        zero_launches()
        with PlainWatch(torch) as watch:
            t0 = time.perf_counter()
            sweeps = {label: ev.evaluate_runner(run, frame, device=device) for label, frame in photos.items()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = read_launches()
        check(not watch.calls, f"eval {name}: a plain version of a kernel ran on the card: {watch.calls}")
        for label, rows in sweeps.items():
            if name == "hand":
                check(rows == [{"transform": "base", "valid": False}], f"eval hand on {label}: {rows}")
                continue
            check(len(rows) == 8 and all(r["valid"] for r in rows), f"eval {name} on {label}: {rows}")
            check(rows[0]["transform"] == "identity" and rows[0]["max_px"] == 0.0,
                  f"eval {name} on {label}: identity row {rows[0]}")
        stage = name in EVAL_STAGE_RUNNERS
        check((launches["blaze_stage"] > 0) == stage, f"eval {name}: stage kernel launches {launches}")
        check(launches["rotated_sample"] == 0 and launches["letterbox_sample"] == 0 or name == "hand",
              f"eval {name}: a sampler kernel ran on an exact path: {launches}")
        summaries = {label: ev.summarize(rows) for label, rows in sweeps.items()}
        result[name] = (dt, launches, summaries)
        print(f"eval {name} ({what}), 8 transforms x 2 photos: {dt:.3f} s wall, launches {launches}; "
              + "; ".join(f"{label}: " + (f"mean {s['mean_px']:.3f} px, p95 {s['p95_px']:.3f} px, max "
                                         f"{s['max_px']:.3f} px" if s.get("valid_transforms") else "n/a")
                          for label, s in summaries.items()) + f" [{card}]", flush=True)
    return result


def phase_host_full_size(torch, np, device, nets, image, cropped, rgba, card):
    """Per-call host time of ``Detector.detect`` (short-range face),
    ``Estimator.estimate`` (Face Mesh V1 on the fixed face view) and
    ``LandmarkTracker.track`` (Face Mesh V1, tracking the photo's face) on
    the 1280×720 photo, HOST_CALLS calls after 5 of warm-up, each ending in
    its host read; the stage kernel must launch in each; then the full
    sweep's wall time per runner."""
    from zaru_tpu_torch.detection import Detector
    from zaru_tpu_torch.landmark import Estimator, LandmarkTracker
    from zaru_tpu_torch.rect import RotatedRect

    detector = Detector(nets["face"])
    estimator = Estimator(nets["v1"])
    view = image.view(RotatedRect(np.asarray(HOST_FACE_VIEW, np.float32)))
    tracker = LandmarkTracker(Estimator(nets["v1"]))
    tracker.set_roi(RotatedRect(np.asarray(HOST_SEED_ROI, np.float32)))
    calls = {
        "Detector.detect (short range)": lambda: detector.detect(image),
        "Estimator.estimate (Face Mesh V1)": lambda: estimator.estimate(view),
        "LandmarkTracker.track (Face Mesh V1)": lambda: check(tracker.track(image) is not None,
                                                              "LandmarkTracker lost the face"),
    }
    per_call = {}
    for what, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        zero_launches()
        with PlainWatch(torch) as watch:
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            dt = time.perf_counter() - t0
        launches = read_launches()
        check(not watch.calls, f"{what}: a plain version of a kernel ran on the card: {watch.calls}")
        check(launches["blaze_stage"] > 0, f"{what}: the stage kernel never launched: {launches}")
        per_call[what] = (dt / HOST_CALLS * 1e3, launches)
        print(f"{what} on the 1280x720 photo: {HOST_CALLS} calls in {dt:.3f} s, {dt / HOST_CALLS * 1e3:.3f} "
              f"ms/call (host clock, host read included); launches {launches} "
              f"({launches['blaze_stage'] / HOST_CALLS:.1f} stage chains a call) [{card}]", flush=True)
    sweeps = full_sweep(torch, np, device, cropped, rgba, card, "timed")
    return per_call, sweeps


def bf16_ulps(np, got, want):
    """The largest error of ``got`` against ``want`` in bf16 ulps of
    ``max(1, |want|max)`` (tests/test_torch_bf16.py ``ulp_of_max``)."""
    ulp = 2.0 ** (np.floor(np.log2(max(1.0, float(np.abs(want).max())))) - 7)
    return float(np.abs(got - want).max()) / ulp


def unflatten(flat, prefix):
    """tests/test_torch_bf16.py ``unflatten``: ``{prefix + "a/b": array}`` as a
    nested dict."""
    tree = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def phase_bf16_vs_jax(torch, np, device, rgba, batch=512):
    """bf16 network bodies (``compute_dtype=torch.bfloat16``) against
    ``bf16_models.npz`` (tests/test_torch_bf16.py) and the port's bf16 run on
    the CPU: every network the bf16 trackers load at batch 1 and 512 (seeded
    inputs, rows 0-3 as the test's; the batch-512 run's rows BF16_CPU_ROWS
    against the CPU), each output within its bound in bf16
    ulps of max(1, |out|max); no stage kernel launched; then bf16
    ``FaceTracker``, ``MultiHandTracker`` and ``BodyTracker`` (stubs) one
    gated step at a time from JAX's state, flags equal, within the test's
    pixel and score tolerances."""
    import zaru_tpu_torch.pipeline as tp
    from zaru_tpu_torch.assets import fixture_path, model_path
    from zaru_tpu_torch.onnx import load_model

    with np.load(fixture_path("bf16_models.npz")) as f:
        ref = {k: f[k] for k in f.files}
    bf16, cpu = torch.bfloat16, torch.device("cpu")
    zero_launches()
    lines = []
    with torch.inference_mode():
        for name, (file, (lo, hi), subset) in BF16_NETS.items():
            card = load_model(model_path(file), device, subset, bf16)
            host = load_model(model_path(file), cpu, subset, bf16)
            check(card.stages == [], f"{name}: a bf16 module built a stage plan")
            h, w = card.input_info[0].shape[2:]
            x = np.random.default_rng(BF16_NET_SEED).uniform(lo, hi, (4, 3, h, w)).astype(np.float32)
            gen = torch.Generator(device=device).manual_seed(BF16_NET_SEED)
            rows = [r for r in BF16_CPU_ROWS if r < batch]
            x512 = torch.cat([torch.from_numpy(x).to(device),
                              lo + (hi - lo) * torch.rand((batch - 4, 3, h, w), generator=gen, device=device)])
            one, full = card(x512[:1]), card(x512)
            cpu_one = host(x512[:1].cpu())
            cpu_rows = host(x512[rows].cpu())
            err = {"jax 1": 0.0, "jax 512": 0.0, "cpu 1": 0.0, "cpu 512": 0.0}
            for i, (o1, o512, c1, crows) in enumerate(zip(one, full, cpu_one, cpu_rows, strict=True)):
                want = ref[f"net/{name}/{i}"]
                check(o512.dtype == torch.float32 and tuple(o512.shape[1:]) == want.shape[1:],
                      f"{name} output {i}: {o512.dtype} {tuple(o512.shape)}")
                o1, o512, c1, crows = (t.cpu().numpy() for t in (o1, o512, c1, crows))
                err["jax 1"] = max(err["jax 1"], bf16_ulps(np, o1, want[:1]))
                err["jax 512"] = max(err["jax 512"], bf16_ulps(np, o512[:4], want))
                err["cpu 1"] = max(err["cpu 1"], bf16_ulps(np, o1, c1))
                err["cpu 512"] = max(err["cpu 512"], bf16_ulps(np, o512[rows], crows))
            tol = BF16_NET_TOL_ULPS[name]
            check(all(v <= tol for v in err.values()),
                  f"bf16 {name}: {err} ulps from JAX's and the CPU's bf16 runs (tolerance {tol})")
            lines.append(f"{name} " + ", ".join(f"{k} {v:.2f}" for k, v in err.items()))
    launches = read_launches()
    check(launches["blaze_stage"] == 0, f"a bf16 network launched the stage kernel: {launches}")
    print(f"bf16 networks on the card (batch 1 and 512) vs JAX's bf16 run and the port's on the CPU, max errors "
          f"in bf16 ulps of max(1, |out|max) (tolerances {BF16_NET_TOL_ULPS}): {'; '.join(lines)}; stage kernel "
          f"launches {launches['blaze_stage']}", flush=True)

    frames_of = {"face": rgba, "hand": rgba, "body": body_photo(torch, np, device)}
    for name, frame in frames_of.items():
        r = lambda k: ref[f"track/{name}/{k}"]  # noqa: E731
        kwargs = json.loads(str(r("kwargs")))
        cls = {"face": "FaceTracker", "hand": "MultiHandTracker", "body": "BodyTracker"}[name]
        tracker = getattr(tp, cls)(compute_dtype=bf16, device=device, **kwargs)
        errs = {}
        for t, force in enumerate(r("force")):
            frames = frame.expand(r("zero").shape[1], *frame.shape).clone()
            frames[torch.from_numpy(r("zero")[t]).to(device)] = 0
            state = unflatten(ref, f"track/{name}/{t}/state/")
            want = unflatten(ref, f"track/{name}/{t}/out/")
            dev = {k: ({kk: torch.from_numpy(vv).to(device) for kk, vv in v.items()} if isinstance(v, dict)
                       else torch.from_numpy(v).to(device)) for k, v in state.items()}
            _, out = tracker.step_batch(dev, frames, bool(force))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            check((out["valid"] == want["valid"]).all(), f"bf16 {cls} step {t}: flags differ from JAX")
            seeded = bool((want["valid"] & ~state.get("active", state.get("tracking"))).any())
            for k in BF16_VALUE_KEYS:
                if k in want and want[k].size:
                    err = float(np.abs(out[k] - want[k]).max())
                    tol = BF16_TRACK_TOL_PX[name][seeded] if k in ("landmarks", "roi", "rois") else BF16_TRACK_SCORE_TOL
                    check(err <= tol, f"bf16 {cls} step {t}: {k} differs from JAX by {err} (tolerance {tol})")
                    errs[k] = max(errs.get(k, 0.0), err)
        args = ", ".join([f"{k}={v}" for k, v in kwargs.items()] + ["compute_dtype=bfloat16"])
        print(f"{cls}({args}).step_batch vs JAX's "
              f"bf16 run over {len(r('force'))} steps at batch {r('zero').shape[1]}: one step at a time max errors "
              f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tolerances {BF16_TRACK_TOL_PX[name]} px "
              f"tracking / seeding, {BF16_TRACK_SCORE_TOL}); flags equal at every step", flush=True)


def phase_host_remainders_vs_jax(torch, np, device, rgba):
    """The body host API on the stub pose models and ``nms_remove_device``
    against host_eval.npz (tests/test_torch_host.py): ``Detector(
    PoseNetwork())`` on the 1280×720 photo, ``Estimator(LiteNetwork())`` on
    the rotated face view, ``nms_remove_device`` on the stored inputs, bit for
    bit."""
    from zaru_tpu_torch.body.detection import PoseNetwork
    from zaru_tpu_torch.body.landmark import LiteNetwork as PoseLite
    from zaru_tpu_torch.detection import Detector, nms_remove_device
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.landmark import Estimator
    from zaru_tpu_torch.rect import RotatedRect

    host, _ = host_fixture(np)
    image = Image(rgba, device)
    errs = {}
    got = detections_arrays(np, Detector(PoseNetwork(device=device)).detect(image))
    for k, tol in (("conf", HOST_SCORE_TOL), ("rect", HOST_DET_TOL_PX), ("kps", HOST_DET_TOL_PX), ("angle", 0.0)):
        want = host[f"det_pose_{k}"]
        check(got[k].shape == want.shape, f"Detector(PoseNetwork()): {k} {got[k].shape}, JAX {want.shape}")
        errs[f"detect {k}"] = float(np.abs(got[k] - want).max())
        check(errs[f"detect {k}"] <= tol, f"Detector(PoseNetwork()): {k} differs from JAX by {errs[f'detect {k}']}")
    est = Estimator(PoseLite(device=device)).estimate(image.view(RotatedRect(np.asarray(HOST_FACE_VIEW, np.float32))))
    lms = est.landmarks_mut()
    for k, v, tol in (("pos", lms.positions(), HOST_LM_TOL_PX), ("vis", lms.visibility, HOST_SCORE_TOL),
                      ("pres", lms.presence, HOST_SCORE_TOL), ("conf", est.confidence(), HOST_SCORE_TOL)):
        errs[f"estimate {k}"] = float(np.abs(np.asarray(v) - host[f"est_pose_{k}"]).max())
        check(errs[f"estimate {k}"] <= tol, f"Estimator(LiteNetwork()): {k} differs from JAX by "
              f"{errs[f'estimate {k}']}")
    cases = sorted({k.split("/")[1] for k in host if k.startswith("nms_remove/")})
    for case in cases:
        args = [torch.from_numpy(host[f"nms_remove/{case}/in{i}"]).to(device) for i in range(4)]
        for i, o in enumerate(nms_remove_device(*args)):
            check(np.array_equal(o.cpu().numpy(), host[f"nms_remove/{case}/{i}"]),
                  f"nms_remove_device ({case}) output {i} differs from JAX")
    print(f"body host API on the stub pose models vs JAX reference on the card: max errors "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (detections {HOST_DET_TOL_PX} px / {HOST_SCORE_TOL}, "
          f"landmarks {HOST_LM_TOL_PX} px); nms_remove_device bit for bit on {cases}", flush=True)


def phase_bf16_full_size(torch, img, device, card, tracker, hands, seed, batches=(64, 512), hand_batch=MULTI_BATCH):
    """bf16 against f32 in turns (f32, bf16, bf16, f32), each run 54 steps
    after 9: the main path at batches 64 and 512, ``MultiHandTracker`` at
    128 tracking four seeded hands a stream, and ``run_frame`` on one
    stream; a 9-step profile of each bf16 run. The bf16 runs launch no
    stage kernel and the samplers as the f32 runs do (``run_frame``: no
    kernel at all). → {(run, batch): (ms/step by dtype, launches by dtype)}."""
    from zaru_tpu_torch.pipeline import FaceTracker, MultiHandTracker

    bf16 = torch.bfloat16
    result = {}

    def abba(what, steps, kernels, batch):
        """f32, bf16, bf16, f32 runs of ``steps[dtype](i)``; fails unless
        each run launched ``kernels[dtype]`` and the bf16 runs no stage
        kernel and the samplers as often as the f32 runs."""
        ms, launches = {"f32": [], "bf16": []}, {}
        for dtype in ("f32", "bf16", "bf16", "f32"):
            dt, launches[dtype] = timed_run(torch, steps[dtype], f"{what}, batch {batch} ({dtype})", kernels[dtype])
            ms[dtype].append(dt / STEPS * 1e3)
        check(launches["bf16"]["blaze_stage"] == 0, f"{what}: the bf16 run launched the stage kernel")
        for k in ("rotated_sample", "letterbox_sample"):
            check(launches["bf16"][k] == launches["f32"][k], f"{what}: bf16 sampler launches {launches}")
        busy = profile_steps(torch, steps["bf16"], batch, f"{what} in bf16")
        print(f"{what} at 1920x1080, batch {batch}: f32 against bf16 in turns (f32, bf16, bf16, f32), {STEPS} steps each: f32 "
              f"{ms['f32'][0]:.3f} / {ms['f32'][1]:.3f} ms/step, bf16 {ms['bf16'][0]:.3f} / {ms['bf16'][1]:.3f} "
              f"ms/step; bf16 device busy {100 * busy:.1f}%; launches f32 {launches['f32']}, bf16 {launches['bf16']} "
              f"[{card}]", flush=True)
        result[(what, batch)] = (ms, launches)

    face16 = FaceTracker(compute_dtype=bf16, device=device)
    for batch in batches:
        frames = img.expand(batch, *img.shape).contiguous()
        steps, boxes = {}, {}
        for dtype, tr in (("f32", tracker), ("bf16", face16)):
            box = boxes[dtype] = {"state": tr.init_state(batch)}

            def step(i, tr=tr, box=box):
                box["state"], box["out"] = tr.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

            steps[dtype] = step
        abba("main path", steps, {"f32": FACE_KERNELS, "bf16": HAND_KERNELS}, batch)
        out = boxes["bf16"]["out"]
        conf = float(out["confidence"].min())
        check(bool(out["valid"].all()) and conf > 0.9, f"bf16 main path, batch {batch}: lost the face ({conf})")

    batch = hand_batch
    frames = img.expand(batch, *img.shape).contiguous()
    active = torch.ones((batch, 4), dtype=torch.bool, device=device)
    steps, boxes = {}, {}
    for dtype, tr in (("f32", hands), ("bf16", MultiHandTracker(max_hands=4, compute_dtype=bf16, device=device))):
        box = boxes[dtype] = {}

        def hand_step(i, tr=tr, box=box):
            state = {"rois": seed, "active": active,
                     "frame": torch.full((batch,), i, dtype=torch.int32, device=device)}
            box["state"], box["out"] = tr.step_batch(state, frames)

        steps[dtype] = hand_step
    abba("MultiHandTracker(max_hands=4), tracking 4 seeded hands per stream", steps,
         {"f32": HAND_KERNELS, "bf16": HAND_KERNELS}, batch)
    lm = boxes["bf16"]["out"]["landmarks"]
    check(tuple(lm.shape) == (batch, 4, 21, 3) and bool(torch.isfinite(lm).all()),
          f"bf16 hand tracking: landmarks {tuple(lm.shape)}")

    steps, boxes = {}, {}
    for dtype, tr in (("f32", FaceTracker(device=device)), ("bf16", FaceTracker(compute_dtype=bf16, device=device))):
        box = boxes[dtype] = {"state": tr.init_state()}

        def single(i, tr=tr, box=box):
            box["state"], box["out"] = tr.run_frame(box["state"], img)

        steps[dtype] = single
    what = "FaceTracker.run_frame, one stream"
    abba(what, steps, {"f32": ("blaze_stage",), "bf16": ()}, 1)
    bf16_launches = result[(what, 1)][1]["bf16"]
    check(not any(bf16_launches.values()), f"bf16 run_frame launched a kernel: {bf16_launches}")
    out = boxes["bf16"]["out"]
    check(bool(out["valid"]) and float(out["confidence"]) > 0.9, "bf16 run_frame lost the face")
    return result

# --- identification (face.recognition, face.identify) and the head-pose math ---


def identify_fixture(np):
    from zaru_tpu_torch.assets import fixture_path

    with np.load(fixture_path("identify.npz")) as f:
        return {k: f[k] for k in f.files}


def stored_stream_steps(torch, np, ref, rgba, device):
    """tests/test_torch_identify.py ``steps``: the stored StreamIdentifier
    run as (frames, JAX's pre-step state, JAX's outputs) per step, on the
    card."""
    batch = ref["stream_state_roi"].shape[1]
    for t, zero in enumerate(ref["stream_zero"]):
        frames = rgba.expand(batch, *rgba.shape).clone()
        if zero >= 0:
            frames[int(zero)] = 0
        st = {k[len("stream_state_"):]: v[t] for k, v in ref.items() if k.startswith("stream_state_")}
        state = {"roi": torch.from_numpy(st["roi"]).to(device), "tracking": torch.from_numpy(st["tracking"]).to(device),
                 "filter": {k[2:]: torch.from_numpy(v).to(device) for k, v in st.items() if k.startswith("f_")}}
        yield frames, state, {k[len("stream_out_"):]: v[t] for k, v in ref.items() if k.startswith("stream_out_")}


def phase_identify_shapes_vs_plain(torch, np, device, rgba):
    """The rotated kernel at the identification crop, ``[B,3,112,112]``
    planar and NHWC, bit for bit against its plain version: 512 views at
    angle 0 on coordinate-encoded 1080p frames (square, 150-900 px, then
    random sizes at strides 1-8 of each grid), centres partly outside the
    frame, on the 512- and the 256-pixel grid; then the crop rects stored
    from JAX's StreamIdentifier run (identify.npz) on the photo, against the
    plain version and against JAX's crops."""
    from zaru_tpu_torch.ops.rotated_fast import _color
    from zaru_tpu_torch.ops.sampling import color_map

    gen = torch.Generator(device="cpu").manual_seed(4)
    frames = coord_frames(torch, 64, 1080, 1920, device)
    n = 256
    size = 150 + torch.rand(n, generator=gen) * 750
    square = torch.stack([torch.rand(n, generator=gen) * 2300 - 200, torch.rand(n, generator=gen) * 1400 - 160,
                          size, size, torch.zeros(n)], -1)
    for m in (512, 256):
        views = random_views(torch, gen, n, m, "cpu")
        views[:, 4] = 0.0
        rects = torch.cat([square, views]).reshape(64, 8, 5).to(device)
        got = check_rotated(torch, "identity crops at angle 0 (150-900 px, then strides 1-8)", frames, rects, 112,
                            -1.0, 1.0, m)
        check(bool((got == -1.0).all(-1).any()), "no identity view reads outside the frame")
    ref = identify_fixture(np)
    steps = list(stored_stream_steps(torch, np, ref, rgba, device))
    frames = torch.cat([s[0] for s in steps])
    rects = torch.from_numpy(ref["stream_out_crop_rects"]).reshape(-1, 5).to(device)
    got = check_rotated(torch, f"the crop rects of JAX's StreamIdentifier run ({len(steps)} steps)", frames, rects,
                        112, -1.0, 1.0, 512)
    want = color_map(torch.from_numpy(ref["stream_out_crop_codes"].reshape(got.shape).astype(np.int32)),
                     *_color(-1.0, 1.0))
    differ = int((got.cpu() != want).sum())
    print(f"rotated_sample on JAX's crop rects vs JAX's crops: {differ} values differ", flush=True)
    check(differ == 0, "the 112x112 crops from JAX's rects differ from JAX's crops")


def cnn_error(np, got, want, what):
    """The largest error of a CNN output against JAX's; fails outside the
    repo's CNN bar (tests/test_onnx_importer.py:63-66)."""
    tol = 1e-3 * max(1.0, float(np.abs(want).max()))
    check(got.shape == want.shape and bool((np.abs(got - want) <= tol + 2e-3 * np.abs(want)).all()),
          f"{what} outside the CNN bar of JAX's")
    return float(np.abs(got - want).max())


def phase_identify_vs_jax(torch, np, device, rgba, cropped):
    """Identification against identify.npz (tests/test_torch_identify.py),
    on the card: ``Embedder.embed`` on the cropped photo, ``FaceIdentifier``
    enrolling it and identifying the full photo, ``StreamIdentifier`` one
    step at a time from JAX's state (flags and identities equal, distances,
    tracker outputs and embeddings within the CPU test's tolerances, the
    crop rects from JAX's ROIs within theirs), then free-running (flags and
    identities equal). No plain version of a kernel runs on the card. →
    the enrolled ``FaceIdentifier``."""
    from zaru_tpu_torch.face.identify import FaceIdentifier, StreamIdentifier
    from zaru_tpu_torch.face.recognition import Embedder
    from zaru_tpu_torch.image import Image

    ref = identify_fixture(np)
    full, crop = Image(rgba, device), Image(cropped, device)
    errs = {}
    with PlainWatch(torch) as watch:
        embedder = Embedder(device)
        errs["embed"] = cnn_error(np, embedder.embed(crop), ref["embed_cropped"], "Embedder.embed")
        ident = FaceIdentifier(embedder=embedder, device=device)
        check(ident.identify(full) is None and ident.enroll("linus", crop), "FaceIdentifier.enroll found no face")
        errs["enrolled"] = cnn_error(np, ident.gallery[0].cpu().numpy(), ref["enrolled"], "the enrolled row")
        errs["query"] = cnn_error(np, ident._embed_face(full), ref["query"], "the query embedding")
        match = ident.identify(full)
        check(match is not None and match.name == str(ref["identify_name"]), f"FaceIdentifier.identify: {match}")
        errs["identify distance"] = abs(match.distance - float(ref["identify_distance"]))
        check(errs["identify distance"] <= ID_DIST_TOL, f"FaceIdentifier distance {match.distance}")

        sid = StreamIdentifier(embedder=embedder, device=device)
        gallery = torch.from_numpy(ref["stream_gallery"]).to(device)
        steps = list(stored_stream_steps(torch, np, ref, rgba, device))
        for t, (frames, state, want) in enumerate(steps):
            _, out = sid.step(state, frames, gallery)
            got = {k: v.cpu().numpy() for k, v in out.items()}
            check((got["valid"] == want["valid"]).all() and (got["identity"] == want["identity"]).all(),
                  f"StreamIdentifier step {t}: flags or identities differ from JAX")
            inf = np.isinf(want["identity_distance"])
            check((np.isinf(got["identity_distance"]) == inf).all(), f"StreamIdentifier step {t}: inf differs")
            for key, value, tol in (
                ("distance", np.abs(got["identity_distance"][~inf] - want["identity_distance"][~inf]).max(),
                 ID_DIST_TOL),
                ("landmarks", np.abs(got["landmarks"] - want["landmarks"]).max(), STEP_TOL_PX),
                ("roi", np.abs(got["roi"] - want["roi"]).max(), STEP_TOL_PX),
                ("norm", np.abs(np.linalg.norm(got["embedding"], axis=-1) - 1.0).max(), 1e-5),
                ("crop rects", np.abs(sid._crop_rects(torch.from_numpy(want["roi"]).to(device)).cpu().numpy()
                                      - want["crop_rects"]).max(), ID_CROP_RECT_TOL_PX),
            ):
                errs[f"stream {key}"] = max(errs.get(f"stream {key}", 0.0), float(value))
                check(value <= tol, f"StreamIdentifier step {t}: {key} differs from JAX by {value} (tolerance {tol})")
            errs["stream embedding"] = max(errs.get("stream embedding", 0.0),
                                           cnn_error(np, got["embedding"], want["embedding"], f"step {t} embeddings"))
        sid.set_gallery(["random", "linus"], gallery)
        state = sid.init_state(len(steps[0][0]))
        for t, (frames, _state, want) in enumerate(steps):
            state, out = sid.run_frames(state, frames)
            check((out["valid"].cpu().numpy() == want["valid"]).all()
                  and (out["identity"].cpu().numpy() == want["identity"]).all(),
                  f"StreamIdentifier free-running step {t}: flags or identities differ from JAX")
    check(not watch.calls, f"a plain version of a kernel ran on the card: {watch.calls}")
    print(f"identification vs JAX reference on the card: max errors { {k: float(f'{v:.3g}') for k, v in errs.items()} } "
          f"(CNN bar for embeddings, distances {ID_DIST_TOL}, tracker {STEP_TOL_PX} px, crop rects "
          f"{ID_CROP_RECT_TOL_PX} px); identities {ref['stream_out_identity'].tolist()} equal one step at a time and "
          f"free-running; no plain kernel version ran on the card", flush=True)
    return ident


def phase_pose3d_vs_cpu(torch, np, device, cropped):
    """blend, quat, Procrustes, Dlt and approx on CUDA tensors against the
    port's CPU run on the same seeded inputs (tests/test_torch_pose3d.py):
    blend within one u8 step, quaternions within POSE_QUAT_TOL, Kabsch
    rotations (180° about each axis among them: the SVD's signs on the card)
    within POSE_ROT_TOL, Dlt and approx equal; then the head pose, Face Mesh
    V1 on the cropped photo → ProcrustesAnalyzer → yaw, against JAX's stored
    yaw."""
    import math

    from zaru_tpu_torch import approx, procrustes, quat
    from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV1, reference_positions
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.image.blend import blend
    from zaru_tpu_torch.landmark import Estimator
    from zaru_tpu_torch.pnp import Dlt
    from zaru_tpu_torch.rect import RotatedRect

    rng = np.random.default_rng(6)
    errs, differing, total = {}, 0, 0
    for i in range(6):
        H, W, h, w = (int(v) for v in rng.integers(40, 400, 4))
        dest, src = (rng.integers(0, 256, s, np.uint8) for s in ((H, W, 4), (h, w, 4)))
        dr = np.asarray([*rng.uniform(0, [W, H]), *rng.uniform(8, [W, H]), rng.uniform(-3, 3)], np.float32)
        sr = np.asarray([*rng.uniform(0, [w, h]), *rng.uniform(4, [w, h]), rng.uniform(-1, 1) * (i % 2)], np.float32)
        want, got = (blend(Image(dest, dev).view(RotatedRect(dr)), Image(src, dev).view(RotatedRect(sr)))
                     for dev in ("cpu", device))
        check(got.device.type == "cuda", "blend() left the card")
        step = np.abs(got.to_numpy().astype(int) - want.to_numpy().astype(int))
        check(step.max() <= POSE_BLEND_MAX_STEP, f"blend on the card: {step.max()} u8 steps from the CPU")
        differing, total = differing + int((step > 0).sum()), total + step.size

    q = rng.normal(size=(64, 4)).astype(np.float32)
    args = {"q": q / np.linalg.norm(q, axis=-1, keepdims=True), "v": rng.normal(size=(64, 3)).astype(np.float32),
            "a": rng.uniform(-3, 3, 64).astype(np.float32)}
    calls = {
        "multiply": lambda x: quat.multiply(x["q"], x["q"].flip(0)), "rotate_vec": lambda x: quat.rotate_vec(x["q"], x["v"]),
        "from_euler": lambda x: quat.from_euler(x["a"], -x["a"], x["a"] * 0.5),
        "to_euler": lambda x: torch.stack(quat.to_euler(x["q"]), -1),
        "to_rotation_matrix": lambda x: quat.to_rotation_matrix(x["q"]),
        "from_axis_angle": lambda x: quat.from_axis_angle(x["v"][0], x["a"][0]),
        "normalize": lambda x: quat.normalize(x["q"] * 3.0),
    }
    for name, fn in calls.items():
        cpu = fn({k: torch.from_numpy(v) for k, v in args.items()})
        gpu = fn({k: torch.from_numpy(v).to(device) for k, v in args.items()})
        check(gpu.device.type == "cuda", f"quat.{name} left the card")
        errs["quat"] = max(errs.get("quat", 0.0), float((gpu.cpu() - cpu).abs().max()))
    check(errs["quat"] <= POSE_QUAT_TOL, f"quat on the card differs from the CPU by {errs['quat']}")

    cloud = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    rots = [np.eye(3, dtype=np.float32)]
    for axis in range(3):
        for angle in (math.pi, math.radians(179.0), 0.7):
            c, s = math.cos(angle), math.sin(angle)
            m = np.eye(3)
            i, j = [k for k in range(3) if k != axis]
            m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
            rots.append(m.astype(np.float32))
    data = np.stack([cloud @ r.T * np.float32(1.3) + np.float32(0.2) for r in rots])
    want = procrustes.procrustes_align(torch.from_numpy(cloud), torch.from_numpy(data))
    got = procrustes.procrustes_align(torch.from_numpy(cloud).to(device), torch.from_numpy(data).to(device))
    errs["procrustes rotation"] = float((got[0].cpu() - want[0]).abs().max())
    errs["procrustes vs truth"] = float(np.abs(got[0].cpu().numpy() - np.stack(rots)).max())
    check(errs["procrustes rotation"] <= POSE_ROT_TOL and errs["procrustes vs truth"] <= POSE_ROT_TOL,
          f"procrustes_align on the card: rotations off by {errs['procrustes rotation']} (CPU), "
          f"{errs['procrustes vs truth']} (truth)")
    res = procrustes.ProcrustesAnalyzer(cloud).analyze(torch.from_numpy(data[1]).to(device))
    check(np.allclose(res.rotation_matrix(), rots[1], atol=POSE_ROT_TOL), "ProcrustesAnalyzer on CUDA tensors")

    pts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    uv = (pts @ rots[3].T + np.float32([0.2, -0.1, 1.0]))
    uv = (uv[:, :2] / uv[:, 2:3]).astype(np.float32)
    a, b = Dlt(pts).solve(uv), Dlt(torch.from_numpy(pts).to(device)).solve(torch.from_numpy(uv).to(device))
    check(np.array_equal(a.rotation(), b.rotation()) and np.array_equal(a.translation, b.translation),
          "Dlt on CUDA tensors differs from numpy")
    x = rng.normal(size=50).astype(np.float32)
    y = x + np.float32(1e-6)
    for fn in (approx.abs_diff_eq, approx.rel_diff_eq):
        check(fn(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device), 1e-6) == fn(x, y, 1e-6),
              f"approx.{fn.__name__} on CUDA tensors")
    check(approx.ulps_diff_eq(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device), 64)
          == approx.ulps_diff_eq(x, y, 64), "approx.ulps_diff_eq on CUDA tensors")

    res = Estimator(FaceMeshV1(device=device)).estimate(Image(cropped, device))
    ref = reference_positions().copy()
    ref[:, 1] *= -1.0
    w, qx, qy, qz = procrustes.ProcrustesAnalyzer(ref).analyze(res.landmarks_mut().positions()).rotation_quaternion()
    yaw = math.degrees(math.atan2(2 * (w * qy + qx * qz), 1 - 2 * (qy * qy + qz * qz)))
    stored = identify_fixture(np)
    errs["landmarks"] = float(np.abs(res.landmarks_mut().positions() - stored["pose_landmarks"]).max())
    errs["yaw"] = abs(yaw - float(stored["pose_yaw"]))
    check(errs["landmarks"] <= HOST_LM_TOL_PX and errs["yaw"] <= POSE_YAW_TOL_DEG,
          f"head pose on the card: landmarks {errs['landmarks']} px, yaw {yaw} against JAX's {stored['pose_yaw']}")
    print(f"blend, quat, Procrustes, Dlt, approx on the card vs the port on the CPU, and the head pose vs JAX: "
          f"blend {differing} of {total} u8 values differ by one step; max errors "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (quat {POSE_QUAT_TOL}, rotations {POSE_ROT_TOL}, "
          f"landmarks {HOST_LM_TOL_PX} px, yaw {POSE_YAW_TOL_DEG} deg); yaw {yaw:.4f} deg (JAX "
          f"{float(stored['pose_yaw']):.4f}); Dlt and approx equal", flush=True)


def phase_identify_full_size(torch, np, img, device, card, tracker, ident, rgba, cropped, batches=(64, 512)):
    """``StreamIdentifier.run_frames`` on the tiled 1080p photo at batches 64
    and 512, 54 steps after 9 with detection forced every 9th step, in turns
    with the plain main path (FaceTracker, StreamIdentifier,
    StreamIdentifier, FaceTracker): ms/step and frames/s of both; the
    rotated kernel launched twice a step, the stage kernel as on the main
    path, the letterbox on detect steps, no plain kernel version; every
    stream identified as the enrolled face. At 512: a 9-step profile of the step and one of the
    embedding pass alone (the 112² sampler and MobileFaceNet), and no
    crop-shaped copy between a sampler and its network. Then
    ``FaceIdentifier.enroll``/``identify`` per call on the host clock. →
    (the identifier, its frames, state and launches at 512)."""
    from zaru_tpu_torch.face.identify import FaceIdentifier, StreamIdentifier
    from zaru_tpu_torch.image import Image

    sid = StreamIdentifier(tracker, ident._embedder, device=device)
    sid.adopt(ident)
    result = {}
    for batch in batches:
        frames = img.expand(batch, *img.shape).contiguous()
        boxes = {"FaceTracker": {"state": tracker.init_state(batch)}, "StreamIdentifier": {"state": sid.init_state(batch)}}

        def ft_step(i, box=boxes["FaceTracker"], frames=frames):
            box["state"], box["out"] = tracker.step_batch(box["state"], frames, force_detect=(i % 9 == 0))

        def sid_step(i, box=boxes["StreamIdentifier"], frames=frames):
            box["state"], box["out"] = sid.run_frames(box["state"], frames, force_detect=(i % 9 == 0))

        ms, launches = {"FaceTracker": [], "StreamIdentifier": []}, {}
        with PlainWatch(torch) as watch:
            for what, step in (("FaceTracker", ft_step), ("StreamIdentifier", sid_step),
                               ("StreamIdentifier", sid_step), ("FaceTracker", ft_step)):
                dt, launches[what] = timed_run(torch, step, f"{what}, batch {batch}", FACE_KERNELS)
                ms[what].append(dt / STEPS * 1e3)
        check(not watch.calls, f"StreamIdentifier, batch {batch}: a plain kernel version ran on the card: {watch.calls}")
        got, main = launches["StreamIdentifier"], launches["FaceTracker"]
        check(got["rotated_sample"] == 2 * STEPS and main["rotated_sample"] == STEPS
              and got["letterbox_sample"] == main["letterbox_sample"] == STEPS // 9
              and got["blaze_stage"] == main["blaze_stage"],
              f"StreamIdentifier launches {got}, main path {main}")
        out = boxes["StreamIdentifier"]["out"]
        dist = out["identity_distance"]
        check(bool(out["valid"].all()) and bool((out["identity"] == 0).all()) and float(dist.max()) < 1.0,
              f"StreamIdentifier, batch {batch}: identities {out['identity'].unique().tolist()}, "
              f"max distance {float(dist.max())}")
        print(f"StreamIdentifier at 1920x1080, batch {batch}, in turns with the main path (FaceTracker, "
              f"StreamIdentifier, StreamIdentifier, FaceTracker), {STEPS} steps each (detect every 9th): main path "
              f"{ms['FaceTracker'][0]:.3f} / {ms['FaceTracker'][1]:.3f} ms/step, StreamIdentifier "
              f"{ms['StreamIdentifier'][0]:.3f} / {ms['StreamIdentifier'][1]:.3f} ms/step "
              f"({batch * 1e3 / ms['StreamIdentifier'][0]:.1f} / {batch * 1e3 / ms['StreamIdentifier'][1]:.1f} "
              f"frames/s); every stream identified "
              f"as '{sid.names[0]}', distance {float(dist.min()):.4f}-{float(dist.max()):.4f}; launches "
              f"StreamIdentifier {got}, main path {main} [{card}]", flush=True)
        result[batch] = (ms, launches)
        if batch == max(batches):
            profile_steps(torch, sid_step, batch, "StreamIdentifier")
            rois = boxes["StreamIdentifier"]["state"]["roi"]
            profile_steps(torch, lambda i: sid._embed_batch(frames, rois), batch,
                          "StreamIdentifier's embedding pass alone (112x112 sampler + MobileFaceNet)")
            check_no_layout_copy(torch, sid_step, [(192, 192), (128, 128), (112, 112)], "StreamIdentifier")
            kept = (frames, boxes["StreamIdentifier"]["state"], got)

    full, crop = Image(rgba, device), Image(cropped, device)
    enroller = FaceIdentifier(embedder=ident._embedder, device=device)
    calls = {"FaceIdentifier.enroll": lambda: check(enroller.enroll("linus", crop), "enroll found no face"),
             "FaceIdentifier.identify": lambda: check(ident.identify(full) is not None, "identify found no match")}
    per_call = {}
    for what, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        zero_launches()
        with PlainWatch(torch) as watch:
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            dt = time.perf_counter() - t0
        launches = read_launches()
        check(not watch.calls, f"{what}: a plain version of a kernel ran on the card: {watch.calls}")
        check(launches["blaze_stage"] == 2 * HOST_CALLS and launches["rotated_sample"] == 0
              and launches["letterbox_sample"] == 0, f"{what}: launches {launches}")
        per_call[what] = dt / HOST_CALLS * 1e3
        print(f"{what} (detect + embed, {'cropped 535x535' if 'enroll' in what else '1280x720'} photo): "
              f"{HOST_CALLS} calls in {dt:.3f} s, {per_call[what]:.3f} ms/call (host clock, host read included); "
              f"launches {launches} ({launches['blaze_stage'] / HOST_CALLS:.0f} stage chains a call) [{card}]",
              flush=True)
    return sid, kept, result


# --- the ONNX dialect and the NHWC layout (onnx/executor.py, onnx/layout.py) ---

DIALECT_CHAINS = {"chain of 2 blocks at 48 channels": [], "chain of 7 blocks at 128 channels": [5, 2]}


def _numpy_outs(torch, outs):
    return [o if not isinstance(o, torch.Tensor) else o.float().cpu().numpy() for o in outs]


def run_graph(torch, np, data, ins, device, layout="NCHW"):
    """An ONNX graph's outputs (numpy) on ``device`` in ``layout``, and its
    module."""
    import warnings

    from zaru_tpu_torch.onnx import load_model

    m = load_model(data, torch.device(device), layout=layout)
    with torch.inference_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Resize's approximation warnings, as in the tests
        outs = m(*(torch.from_numpy(np.asarray(x)).to(device) for x in ins))
    return m, _numpy_outs(torch, outs)


def phase_stage_nhwc_vs_plain(torch, np, device):
    """The stage kernel's NHWC variant at the ten chains of the two face
    CNNs (their weights, random inputs at batch 512): bit for bit against
    the NCHW kernel on the same values, within ``rtol = atol = 1e-4`` of the
    plain version on the channels_last input; then the two chains the plan
    treats apart (tests/test_torch_onnx_ops.py): 48 channels, which the
    kernel is not built for, planned as on the CPU (no stage) and run node
    by node, and 7 blocks at 128 channels, planned as 5 + 2 on both devices;
    each on the card against the CPU and against JAX."""
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.onnx import dialect_cases, load_model
    from zaru_tpu_torch.ops.cnn_stage import blaze_blocks_reference, fused_blocks, unpack_blocks

    gen = torch.Generator(device="cpu").manual_seed(13)
    worst = 0.0
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for model, side in (("face_landmark.onnx", 192), ("face_detection_short_range.onnx", 128)):
            net = load_model(model_path(model).read_bytes(), device)
            env = net.activations(torch.rand((2, 3, side, side), generator=gen).to(device) * 2 - 1)
            for k, st in enumerate(net.stages):
                _, C, H, W = env[st.input].shape
                x = (torch.rand((512, C, H, W), generator=gen) * 2 - 1).to(device)
                packed = net._packed[st.at]
                x_cl = x.contiguous(memory_format=torch.channels_last)
                got, ref = fused_blocks(x_cl, packed, H, W, C), fused_blocks(x, packed, H, W, C)
                want = blaze_blocks_reference(x_cl, unpack_blocks(packed, C))
                torch.cuda.synchronize()
                differ = int((got != ref).sum())
                err = float((got - want).abs().max())
                worst = max(worst, err)
                check(got.is_contiguous(memory_format=torch.channels_last),
                      f"the NHWC variant's output is not channels_last ({model} chain {k})")
                check(differ == 0, f"the NHWC stage variant differs from the NCHW kernel at {model} chain {k}: "
                      f"{differ} values")
                check(bool(((got - want).abs() <= STAGE_TOL + STAGE_TOL * want.abs()).all()),
                      f"the NHWC stage variant disagrees with its plain version at {model} chain {k}")
            del env
    print(f"blaze_stage NHWC variant at the ten chains of the two face CNNs, [512,C,H,W] channels_last: "
          f"bit-equal to the NCHW kernel, max abs err vs plain {worst}", flush=True)
    x = torch.zeros((2, 16, 6, 6), device=device).transpose(2, 3)  # neither layout
    try:
        fused_blocks(x, torch.zeros((1, 16 * 16 + 12 * 16), device=device), 6, 6, 16)
    except ValueError as e:
        print(f"blaze_stage refuses a tensor in neither layout on the card: {e}", flush=True)
    else:
        check(False, "fused_blocks launched on a tensor that is neither NCHW-contiguous nor channels_last")

    cases = dialect_cases.load()
    for name, plan in DIALECT_CHAINS.items():
        c = cases[f"ops/{name}"]
        for layout in ("NCHW", "NHWC"):
            zero_launches()
            m, got = run_graph(torch, np, c["graph"], c["ins"], device, layout)
            launches = read_launches()
            cpu, want_cpu = run_graph(torch, np, c["graph"], c["ins"], "cpu", layout)
            pieces = [len(st.blocks) for st in m.stages]
            check(pieces == plan == [len(st.blocks) for st in cpu.stages],
                  f"{name}: planned {pieces} on the card, {[len(st.blocks) for st in cpu.stages]} on the CPU")
            key = "blaze_stage_nhwc" if layout == "NHWC" else "blaze_stage"
            check(launches[key] == len(plan), f"{name} ({layout}): {launches[key]} stage launches, want {len(plan)}")
            ok_cpu, err_cpu = dialect_cases.compare(got[0], want_cpu[0], c["tol"])
            ok_jax, err_jax = dialect_cases.compare(got[0], c["outs"][0], c["tol"])
            print(f"{name}, {layout}, batch {c['ins'][0].shape[0]}: planned {pieces or 'node by node'} on the "
                  f"card as on the CPU, {launches[key]} stage launches; vs the CPU {err_cpu}, vs JAX {err_jax} "
                  f"({c['tol']})", flush=True)
            check(ok_cpu and ok_jax, f"{name} ({layout}) disagrees with the CPU or JAX")


def phase_dialect_vs_jax(torch, np, device):
    """Every stored case of tests/test_torch_onnx_{ops,fuzz,layout}.py on
    the card against JAX's stored outputs, at the tests' tolerances: the
    op cases (Resize's shrinks among them), the fuzz graphs in both layouts
    at batch 3 (three images against JAX's three batch-1 runs), and the six
    bundled models with
    ``with_layout("NHWC")`` (and bf16 with NHWC on the short-range
    detector), those also against the port's NCHW module on the card."""
    from zaru_tpu_torch.nn import Loader
    from zaru_tpu_torch.onnx import dialect_cases

    cases = dialect_cases.load()
    worst, counts, failed = {}, {}, []
    for name, c in sorted(cases.items()):
        group = name.split("/", 1)[0]
        runs = []
        if group == "layout":
            path = str(ROOT / "assets" / "onnx" / c["model"])
            loader = Loader(path, device=device).with_layout("NHWC")
            bf16 = c["tol"].startswith("bf16")
            net = (loader.with_bf16() if bf16 else loader).load()
            x = torch.from_numpy(c["ins"][0]).to(device)
            with torch.inference_mode():
                outs = net.estimate(x)
                check(all(o.is_contiguous() for o in outs), f"{name}: an output leaves channels_last")
                runs.append(("", _numpy_outs(torch, outs), c["outs"], c["tol"]))
                if not bf16:
                    ref = _numpy_outs(torch, Loader(path, device=device).load().estimate(x))
                    runs.append((" vs the NCHW module", _numpy_outs(torch, outs), ref, "cnn"))
        else:
            _m, outs = run_graph(torch, np, c["graph"], c["ins"], device, c.get("layout", "NCHW"))
            runs.append(("", outs, c["outs"], c["tol"]))
        for what, outs, wants, tol in runs:
            check(len(outs) == len(wants), f"{name}{what}: {len(outs)} outputs, want {len(wants)}")
            for i, (got, want) in enumerate(zip(outs, wants)):
                ok, err = dialect_cases.compare(got, want, tol)
                if not ok:
                    failed.append(f"{name}{what} output {i}: {err} ({tol})")
                key = (group, tol.split(":")[0])
                worst[key] = max(worst.get(key, 0), err)
        counts[group] = counts.get(group, 0) + 1
    print(f"ONNX dialect vs JAX on the card: {counts} cases, {len(failed)} outputs outside the tests' tolerance "
          f"{failed}; the largest errors by group and kind (exact: values differing; ulp: ulps; abs, cnn: absolute; "
          f"bf16: bf16 ulps): { {f'{g} {k}': v for (g, k), v in sorted(worst.items())} }", flush=True)
    check(not failed, f"{len(failed)} outputs of the dialect's cases disagree with JAX on the card")
    host_copies_on_repeat(torch, np, device, cases)


def host_copies_on_repeat(torch, np, device, cases):
    """A module's second call on inputs already on the card copies nothing
    from the host: a constant divisor is a buffer (its reciprocal), a value
    the host computes is copied once and kept, and index vectors and resize
    weights are made on the card. Counted with torch.profiler's host→device
    copies over the second call of every Div, Resize and negative-step
    Slice case."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from zaru_tpu_torch.onnx import load_model

    copies = {}
    for name in sorted(n for n in cases if n.startswith(("ops/Div", "ops/Resize", "ops/Slice inputs"))):
        c = cases[name]
        m = load_model(c["graph"], torch.device(device))
        xs = [torch.from_numpy(np.asarray(x)).to(device) for x in c["ins"]]
        with torch.inference_mode(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m(*xs)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                m(*xs)
                torch.cuda.synchronize()
        copies[name[len("ops/"):]] = sum(e.count for e in prof.key_averages() if "Memcpy HtoD" in e.key)
    print(f"host-to-device copies in a module's second call, {len(copies)} Div, Resize and Slice cases: "
          f"{sum(copies.values())} ({ {k: v for k, v in copies.items() if v} or 'none'})", flush=True)
    check(not any(copies.values()), f"a module's second call copies from the host: {copies}")


def nhwc_copies(torch, step, crops, batch):
    """Over a 9-call torch.profiler run of ``step``: the copy kernels on the
    device per call, and the copy ops per call whose input is a crop
    (``[N,3,h,w]``/``[N,h,w,3]`` for ``(h, w)`` in ``crops``) or a 4-D
    activation of the batch (``[batch, ...]`` of at least 1024 values an
    image)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for i in range(9):
            step(i)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                  and "copy" in e.key.lower())
    shapes = {(h, w, 3) for h, w in crops} | {(3, h, w) for h, w in crops}
    crop = act = 0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in COPY_OPS + ("aten::copy_",) or not e.input_shapes or len(e.input_shapes[0]) != 4:
            continue
        shape = tuple(e.input_shapes[0])
        if shape[1:] in shapes:
            crop += e.count
        elif shape[0] == batch and shape[1] * shape[2] * shape[3] >= 1024:
            act += e.count
    return kernels / 9, crop / 9, act / 9


def phase_nhwc_full_size(torch, img, device, card, state, batch=512):
    """Face Mesh V1 on the rotated views and short-range BlazeFace on the
    letterbox views of the fixture photo at batch 512, through ``Cnn`` with
    NHWC-layout modules and with the main path's NCHW ones, in turns (NCHW,
    NHWC, NHWC, NCHW), 54 calls after 9 each; the NHWC runs must launch the
    stage kernel's NHWC variant and not the NCHW one, and agree with the
    NCHW runs at the CNN bar; then a 9-call profile of each layout counting
    the copy kernels and the crop- or activation-sized copies."""
    from zaru_tpu_torch.nn import Cnn, ColorMapper
    from zaru_tpu_torch.pipeline import _ops

    frames = img.expand(batch, *img.shape).contiguous()
    mapper = ColorMapper.linear(-1.0, 1.0)
    cnns = {layout: (Cnn.load("face_landmark.onnx", mapper, device, layout=layout),
                     Cnn.load("face_detection_short_range.onnx", mapper, device, layout=layout))
            for layout in ("NCHW", "NHWC")}
    lm = cnns["NCHW"][0]
    view_rects = _ops.aspect_view_rect(state["roi"], lm.input_resolution())
    _fit, fit_rrect = _ops.full_frame_fit(frames, cnns["NCHW"][1].input_resolution())
    fit_rrect = fit_rrect.expand(batch, 5).contiguous()

    def call(layout):
        lm_cnn, det_cnn = cnns[layout]
        with torch.inference_mode():
            return lm_cnn.apply_views_fast(frames, view_rects) + det_cnn.apply_views_letterbox(frames, fit_rrect)

    outs = {layout: call(layout) for layout in ("NCHW", "NHWC")}
    worst = 0.0
    for got, want in zip(outs["NHWC"], outs["NCHW"], strict=True):
        w = want.float().cpu().numpy()
        g = got.float().cpu().numpy()
        worst = max(worst, float(abs(g - w).max()))
        check(bool((abs(g - w) <= 1e-3 * max(1.0, float(abs(w).max())) + 2e-3 * abs(w)).all()),
              "the NHWC modules disagree with the NCHW ones on the photo's views")
    ms, launches = {}, {}
    for k, layout in enumerate(("NCHW", "NHWC", "NHWC", "NCHW")):
        stage = "blaze_stage" if layout == "NCHW" else "blaze_stage_nhwc"
        dt, n = timed_run(torch, lambda i, layout=layout: call(layout), f"Cnn, {layout} modules",
                          ("rotated_sample", "letterbox_sample", stage))
        ms.setdefault(layout, []).append(dt / STEPS * 1e3)
        launches[layout] = n
        other = "blaze_stage_nhwc" if layout == "NCHW" else "blaze_stage"
        check(n[other] == 0, f"the {layout} modules launched {n[other]} times the other stage variant")
    copies = {layout: nhwc_copies(torch, lambda i, layout=layout: call(layout), [(192, 192), (128, 128)], batch)
              for layout in ("NCHW", "NHWC")}
    print(f"Face Mesh V1 (rotated views) + BlazeFace short range (letterbox views) at batch {batch} through Cnn, "
          f"{STEPS} calls after {WARMUP}, in turns NCHW / NHWC / NHWC / NCHW: "
          f"{ms['NCHW'][0]:.3f} / {ms['NHWC'][0]:.3f} / {ms['NHWC'][1]:.3f} / {ms['NCHW'][1]:.3f} ms/call; "
          f"NHWC vs NCHW outputs max abs {worst}; launches NCHW {launches['NCHW']}, NHWC {launches['NHWC']}; "
          f"per call (copy kernels on the device, crop-sized copies, activation-sized copies): "
          f"NCHW {copies['NCHW']}, NHWC {copies['NHWC']} [{card}]", flush=True)
    return ms, launches["NHWC"], copies


# Trainer on Face Mesh V1 (tests/test_torch_train.py's recipe at 192²):
# crops, seeds and tolerances against the port's own CPU run.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_RES = 64, 10, 192
# The weights' perturbation, in standard deviations of each parameter: at
# slim_160's 0.03 Face Mesh's first Adam step at lr 1e-4 overshoots (the
# loss rises from 0.21 to 1.13 at batch 16 on the CPU); at 0.1 it falls
# from 2.3 to 0.5 in ten steps.
TRAIN_PERTURB = 0.1
TRAIN_FIRST_LOSS_RTOL = 1e-5  # tests/test_torch_train.py FIRST_LOSS_RTOL
TRAIN_LOSS_RTOL = 0.1  # tests/test_torch_train.py LOSS_RTOL: Adam parts the runs
TRAIN_PARAM_TOL_LR_STEPS = 0.5  # tests/test_torch_train.py PARAM_TOL_LR_STEPS


# Stream sharding (zaru_tpu_torch.parallel): the sharded main path's batch,
# serving's stream count, and the sharded run's landmarks against the
# unsharded run at 512 (px): 0 measured over 18 steps on H100s, two shards of
# 256 on one card and four of 128 on four cards (each shard runs the CNNs at
# its own batch, and cuDNN could sum them in another order there); held to
# the one-step bound STEP_TOL_PX.
SHARD_BATCH, SHARD_SERVE_STREAMS = 512, 64
SHARD_LM_TOL_PX = STEP_TOL_PX


def sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def sharding_mesh(torch):
    """Every visible card, or with one card two shards on it."""
    from zaru_tpu_torch.parallel import stream_mesh

    return stream_mesh() if torch.cuda.device_count() > 1 else stream_mesh(["cuda:0", "cuda:0"])


def timed_sharded(torch, step, what):
    """``timed_run`` for a step that may run on several cards: every card
    synchronised before the clock starts and before it stops."""
    for i in range(WARMUP):
        step(i)
    sync_all(torch)
    zero_launches()
    t0 = time.perf_counter()
    for i in range(STEPS):
        step(i)
    sync_all(torch)
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(all(launches[k] > 0 for k in FACE_KERNELS), f"{what}: a kernel of the path was never launched: {launches}")
    return dt, launches


def phase_sharding(torch, np, img, device, card, tracker):
    """Stream sharding on the card(s): see the module docstring (phase 5's
    last part). ``tracker``: the unsharded main path's tracker on
    ``device``."""
    from zaru_tpu_torch.checkpoint import load_params, save_params
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import NeuralNetwork
    from zaru_tpu_torch.parallel import ShardedTracker
    from zaru_tpu_torch.pipeline import FaceTracker
    from zaru_tpu_torch.pipeline.ingest import FrameUploader
    from zaru_tpu_torch.serve import StreamSet, serve_loop
    from zaru_tpu_torch.train import Trainer, make_data_parallel_train_step

    mesh = sharding_mesh(torch)
    n = len(mesh)
    cards = list(dict.fromkeys(mesh))
    print(f"mesh: {[str(d) for d in mesh]}: {n} shards over {len(cards)} card(s) "
          f"({', '.join(torch.cuda.get_device_name(d) for d in cards)})", flush=True)
    t0 = time.perf_counter()
    sharded = ShardedTracker(FaceTracker(device="cpu"), mesh)
    replicate_s = time.perf_counter() - t0
    B = SHARD_BATCH
    frames = img.expand(B, *img.shape).contiguous()
    shards = sharded.shard_frames(frames)
    own = {d: FaceTracker(device=d) for d in cards}
    state = sharded.init_state(B)
    own_states = [own[d].init_state(B // n) for d in mesh]
    ref_state = tracker.init_state(B)
    lm_err, bad = 0.0, []
    for i in range(2 * 9):
        force = i % 9 == 0
        state, out = sharded.step_gated(state, shards, force)
        runs = [own[d].step_batch(st, f, force) for d, st, f in zip(mesh, own_states, shards.shards)]
        own_states = [st for st, _ in runs]
        for tree, mine in ((out, [o for _, o in runs]), (state, own_states)):
            flat = [(k, v, [m[k] for m in mine]) for k, v in tree.items() if not isinstance(v, dict)]
            flat += [(f"filter/{k}", v, [m["filter"][k] for m in mine]) for k, v in tree.get("filter", {}).items()]
            for k, v, want in flat:
                for s, (got, w) in enumerate(zip(v.shards, want)):
                    if got.device != mesh[s] or not torch.equal(got, w):
                        bad.append((i, k, s))
        ref_state, ref = tracker.step_batch(ref_state, frames, force)
        if not torch.equal(out["valid"].cpu(), ref["valid"].cpu()):
            bad.append((i, "valid against the unsharded run", -1))
        lm_err = max(lm_err, float((out["landmarks"].cpu() - ref["landmarks"].cpu()).abs().max()))
    print(f"sharded FaceTracker (built on the CPU, replicated in {replicate_s:.2f} s) at 1920x1080 x {B}, {n} "
          f"shards of {B // n}: 18 step_gated steps (detect every 9th): every shard's outputs and state bit-equal "
          f"to its own step_batch on a tracker built on its card, on its card: {not bad} {bad[:4]}; valid equal "
          f"to the unsharded run at {B}, landmarks {lm_err:.6g} px from it (bound {SHARD_LM_TOL_PX}), all valid "
          f"{bool(ref['valid'].all())}", flush=True)
    check(not bad and lm_err <= SHARD_LM_TOL_PX and bool(np.asarray(out["valid"]).all()),
          "the sharded step parts from its shards' own steps or from the unsharded run")

    box = {"plain": tracker.init_state(B), "sharded": sharded.init_state(B)}

    def plain(i):
        box["plain"], _ = tracker.step_batch(box["plain"], frames, force_detect=(i % 9 == 0))

    def shard_step(i):
        box["sharded"], box["out"] = sharded.step_gated(box["sharded"], shards, i % 9 == 0)

    ms = {}
    for what, step in (("unsharded", plain), ("sharded", shard_step), ("sharded", shard_step), ("unsharded", plain)):
        dt, launches = timed_sharded(torch, step, what)
        ms.setdefault(what, []).append(dt / STEPS * 1e3)
        if what == "sharded":
            shard_launches = launches
    check(shard_launches["rotated_sample"] == STEPS * n,
          f"sharded run: {shard_launches['rotated_sample']} rotated launches in {STEPS} steps of {n} shards")
    print(f"sharded main path at 1920x1080 x {B} over {n} shards, {STEPS} steps after {WARMUP} (detect every 9th), "
          f"in turns: unsharded {ms['unsharded'][0]:.3f} / sharded {ms['sharded'][0]:.3f} / sharded "
          f"{ms['sharded'][1]:.3f} / unsharded {ms['unsharded'][1]:.3f} ms/step; sharded launches {shard_launches} "
          f"[{card}]", flush=True)

    S = SHARD_SERVE_STREAMS
    host = img.cpu().numpy()
    host_frames = [np.ascontiguousarray(np.roll(host, (s % 8, 3 * (s // 8)), axis=(0, 1))) for s in range(S)]
    serving = ShardedTracker(tracker, mesh)
    up = FrameUploader(S, host.shape, device=serving.frame_sharding)
    streams = StreamSet([memory_factory(host_frames[s], f"memory{s}") for s in range(S)])
    streams.prime()
    outs = []
    zero_launches()
    t0 = time.perf_counter()
    stats = serve_loop(serving, streams, up, single=False, steps=9,
                       emit=lambda rec, out: outs.append({k: out[k].cpu() for k in ("valid", "landmarks")}))
    sync_all(torch)
    dt = time.perf_counter() - t0
    launches = read_launches()
    streams.close()
    direct = serving.shard_frames(np.stack(host_frames))
    st = serving.init_state(S)
    same = True
    for t in range(9):
        st, out = serving.step_gated(st, direct)
        same &= torch.equal(outs[t]["valid"], out["valid"].cpu()) and torch.equal(outs[t]["landmarks"],
                                                                                 out["landmarks"].cpu())
    print(f"serve_loop over the sharded tracker at {S} streams ({n} shards), sharded uploader: 9 steps in "
          f"{dt:.3f} s ({dt / 9 * 1e3:.3f} ms/step, the first included, {stats.frames} fresh frames), bit-equal to "
          f"step_gated on the same frames uploaded at once: {same}, all valid {bool(outs[-1]['valid'].all())}; "
          f"launches {launches} [{card}]", flush=True)
    check(same and bool(outs[-1]["valid"].all()) and launches["rotated_sample"] == 9 * n,
          "sharded serving parts from step_gated or lost the face")

    x = train_inputs(np)
    teacher = NeuralNetwork.load(model_path("face_landmark.onnx"), device=device)
    with torch.inference_mode():
        y = teacher.module(torch.from_numpy(x).to(device))[0].reshape(TRAIN_BATCH, -1).cpu().numpy()
    rng = np.random.default_rng(3)
    base = {k: v.detach().cpu().numpy() for k, v in teacher.params.items()}
    student = {k: (base[k] + rng.normal(0, TRAIN_PERTURB * (np.std(base[k]) + 1e-6), base[k].shape)).astype(np.float32)
               for k in sorted(base)}
    one = NeuralNetwork.load(model_path("face_landmark.onnx"), device=device)
    one.load_params(student)
    first = Trainer(one).train_step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    net = NeuralNetwork.load(model_path("face_landmark.onnx"), device="cpu")
    net.load_params(student)
    step, params, opt_state, shard_batch = make_data_parallel_train_step(net, mesh)
    xs, ys = shard_batch(x), shard_batch(y)
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, xs, ys)
        losses.append(float(loss))  # the host read ends the step
        times.append(time.perf_counter() - t0)
    rel = abs(losses[0] / first - 1)
    on_mesh = all(v.devices == tuple(cards) for v in params.values())
    print(f"data-parallel training of Face Mesh V1 (built on the CPU) at batch {TRAIN_BATCH} over {n} shards, "
          f"{TRAIN_STEPS} Adam steps: losses {[round(v, 6) for v in losses]}, first {losses[0]:.8g} against the "
          f"one-device Trainer's {first:.8g} (relative {rel:.3g}, bound {TRAIN_FIRST_LOSS_RTOL}); replicas on "
          f"{[str(d) for d in cards]} {on_mesh}; {np.mean(times[1:]) * 1e3:.3f} ms/step (first step "
          f"{times[0] * 1e3:.1f} ms) [{card}]", flush=True)
    check(rel <= TRAIN_FIRST_LOSS_RTOL and losses[-1] < losses[0] and on_mesh,
          "data-parallel training parts from the one-device Trainer or does not learn")
    with tempfile.TemporaryDirectory() as d:
        save_params(f"{d}/ckpt", params)
        back = load_params(f"{d}/ckpt", like=params)
    restored = all(b.devices == params[k].devices and all(torch.equal(c, p.detach()) for c, p in
                                                          zip(b.copies, params[k].copies)) for k, b in back.items())
    print(f"checkpoint of the trained replicas ({len(params)} parameters) restored onto the mesh with like=: "
          f"every copy equal on its card {restored}", flush=True)
    check(restored, "the replicated checkpoint did not come back onto the mesh")

    from zaru_tpu_torch.checkpoint import CheckpointManager
    from zaru_tpu_torch.parallel import StreamSharding

    host = {k: np.asarray(v) for k, v in params.items()}
    key = max((k for k, v in host.items() if v.ndim and v.shape[0] % n == 0 and v.size > n),
              key=lambda k: host[k].size)
    placed = dict(params, **{key: StreamSharding(mesh).put(torch.from_numpy(host[key]))})
    with tempfile.TemporaryDirectory() as d:
        with CheckpointManager(d) as mgr:
            mgr.save(0, placed)
            mgr.wait_until_finished()
            back = mgr.restore(0, like=placed)
    leaf = back[key]
    on_shards = leaf.sharding == placed[key].sharding and all(s.device == mesh[i] for i, s in enumerate(leaf.shards))
    equal = np.array_equal(np.asarray(leaf), host[key]) and all(
        all(torch.equal(c.cpu(), torch.from_numpy(host[k])) for c in back[k].copies) for k in back if k != key)
    print(f"checkpoint with {key!r} {tuple(host[key].shape)} sharded over the {n} shards (the rest replicated), "
          f"CheckpointManager save and restore(like=): shards {[str(s.device) for s in leaf.shards]} of "
          f"{tuple(leaf.shards[0].shape)}, sharding equal {on_shards}, every leaf bit-equal {equal}", flush=True)
    check(on_shards and equal, "the sharded checkpoint leaf did not come back shard by shard onto the mesh")
    return ms


def outputs_diff(torch, a, b):
    """The leaves (of the new state and the outputs) where two step results
    ``(state, outputs)`` differ, by path, with the largest difference."""
    from torch.utils._pytree import keystr, tree_flatten_with_path

    fa, fb = ({keystr(p): v for p, v in tree_flatten_with_path(r)[0]} for r in (a, b))
    return {k: float((fa[k].double() - fb[k].double()).abs().max()) for k in fa if not torch.equal(fa[k], fb[k])}


def phase_export_full_size(torch, img, device, card, tracker, frames):
    """The main path's gated step exported at 1080p and batch 512 (a
    force-detect input, so the cadence stays the caller's), reloaded and run
    in lockstep with the eager step (bit-equal, or each differing key held
    to the trackers' tolerances), then both timed in turns (eager,
    exported, exported, eager) with the kernels' launches counted inside
    the exported run; then the single-stream step against run_frame."""
    from zaru_tpu_torch.export import export_fn, load_exported

    batch = frames.shape[0]
    yes, no = torch.tensor(True, device=device), torch.tensor(False, device=device)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        export_fn(lambda st, fs, force: tracker.step_batch(st, fs, force), (tracker.init_state(batch), frames, no),
                  f"{d}/step_batch.pt2")
        t1 = time.perf_counter()
        call = load_exported(f"{d}/step_batch.pt2")
        size = os.path.getsize(f"{d}/step_batch.pt2")
        print(f"export of FaceTracker.step_batch at 1920x1080, batch {batch}: traced and saved in {t1 - t0:.1f} s, "
              f"reloaded in {time.perf_counter() - t1:.1f} s, {size / 1e6:.2f} MB", flush=True)
        t0 = time.perf_counter()
        export_fn(lambda st, f: tracker.step(st, f), (tracker.init_state(), img), f"{d}/step.pt2")
        single = load_exported(f"{d}/step.pt2")
        print(f"export of FaceTracker.step at 1920x1080: traced, saved and reloaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    se = sx = tracker.init_state(batch)
    diffs = {}
    for i in range(2 * 9):
        force = i % 9 == 0
        se, oe = tracker.step_batch(se, frames, force)
        sx, ox = call(sx, frames, yes if force else no)
        for k, v in outputs_diff(torch, (se, oe), (sx, ox)).items():
            diffs[k] = max(diffs.get(k, 0.0), v)
    print(f"exported step_batch against eager over 18 steps (2 forced detections): "
          f"{'bit-equal' if not diffs else f'differing keys {diffs}'}", flush=True)
    # Held, if they differ at all, to the trackers' one-step tolerances:
    # flags equal, scores within MODEL_SCORE_TOL, positions within STEP_TOL_PX.
    check(all(not any(f in k for f in ("valid", "tracking", "init"))
              and v <= (MODEL_SCORE_TOL if "confidence" in k else STEP_TOL_PX) for k, v in diffs.items()),
          f"exported step_batch differs from eager: {diffs}")
    eager = lambda st, force: tracker.step_batch(st, frames, force)  # noqa: E731
    exported = lambda st, force: call(st, frames, yes if force else no)  # noqa: E731
    ms, launches = {}, {}
    for what, fn in (("eager", eager), ("exported", exported), ("exported", exported), ("eager", eager)):
        box = {"state": tracker.init_state(batch)}

        def step(i, fn=fn, box=box):
            box["state"], box["out"] = fn(box["state"], i % 9 == 0)

        dt, launches[what] = timed_run(torch, step, f"{what} step_batch", FACE_KERNELS)
        ms.setdefault(what, []).append(dt / STEPS * 1e3)
        check(bool(box["out"]["valid"].all()), f"{what} step_batch lost the face")
    print(f"main path at 1920x1080, batch {batch}, eager / exported / exported / eager: "
          f"{ms['eager'][0]:.3f} / {ms['exported'][0]:.3f} / {ms['exported'][1]:.3f} / {ms['eager'][1]:.3f} "
          f"ms/step; launches in the exported run {launches['exported']} [{card}]", flush=True)
    se = sx = tracker.init_state()
    single_diffs = {}
    for _ in range(9):
        se, oe = tracker.run_frame(se, img)
        sx, ox = single(sx, img)
        single_diffs.update(outputs_diff(torch, (se, oe), (sx, ox)))
    check(not single_diffs, f"exported step differs from run_frame: {single_diffs}")
    one = {}
    for what, fn in (("run_frame", tracker.run_frame), ("exported", single), ("exported", single),
                     ("run_frame", tracker.run_frame)):
        box = {"state": tracker.init_state()}

        def step(i, fn=fn, box=box):
            box["state"], box["out"] = fn(box["state"], img)

        dt, launches[f"{what}, one stream"] = timed_run(torch, step, f"{what}, one stream", ("blaze_stage",))
        one.setdefault(what, []).append(dt / STEPS * 1e3)
    check(launches["exported, one stream"]["rotated_sample"] == 0, "the exported single-stream step ran a sampler")
    print(f"single stream at 1920x1080, run_frame / exported / exported / run_frame: {one['run_frame'][0]:.3f} / "
          f"{one['exported'][0]:.3f} / {one['exported'][1]:.3f} / {one['run_frame'][1]:.3f} ms/frame, exported "
          f"bit-equal to run_frame over 9 frames; launches in the exported run {launches['exported, one stream']} "
          f"[{card}]", flush=True)
    return call, launches["exported"]


def phase_analysis_full_size(torch, device, card, tracker, batch=512):
    """``analyze`` of the main path's two networks beside their measured
    time at batch 512: FLOPs, the speed of light at 67 TFLOP/s (f32)."""
    from zaru_tpu_torch.onnx.analysis import H100_F32_TFLOPS, analyze

    for what, cnn in (("BlazeFace short-range", tracker.det_cnn), ("Face Mesh V1", tracker.lm_cnn)):
        rep = analyze(cnn.net, what)
        with cnn.net.without_plans():
            op_by_op = analyze(cnn.net, what).flops
        check(op_by_op == rep.flops, f"{what}: analyze counts {rep.flops} FLOPs with the stage plan, {op_by_op} without")
        res = cnn.input_resolution()
        x = torch.rand(batch, 3, res.height, res.width, device=device) * 2 - 1
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: cnn.net(x), reps=20)
        sol_ms = rep.flops * batch / (H100_F32_TFLOPS * 1e12) * 1e3
        print(f"analyze {rep} (the same without the stage plan); at batch {batch}: {rep.flops * batch / 1e9:.3f} GFLOP, "
              f"speed of light {sol_ms:.4f} ms at {H100_F32_TFLOPS:g} TFLOP/s, measured {ms:.4f} ms/call "
              f"({100 * sol_ms / ms:.1f}% of the f32 peak) [{card}]", flush=True)


def train_inputs(np):
    """TRAIN_BATCH jittered square face crops of the stored photo at
    TRAIN_RES², nearest-neighbour (tests/test_torch_train.py's recipe),
    as NCHW f32 in [-1, 1]."""
    from zaru_tpu_torch.assets import fixture_path

    with np.load(fixture_path("sad_linus_track.npz")) as f:
        rgb, roi = f["rgb"], f["roi"][0, 0]
    cx, cy, size = float(roi[0]), float(roi[1]), float(max(roi[2], roi[3]))
    rng = np.random.default_rng(7)
    crops = []
    for _ in range(TRAIN_BATCH):
        jx, jy = rng.uniform(-0.05, 0.05, 2) * size
        side = size * float(rng.uniform(0.9, 1.15))
        grid = (np.arange(TRAIN_RES) + 0.5) * side / TRAIN_RES - side / 2
        xs = np.clip(np.floor(cx + jx + grid), 0, rgb.shape[1] - 1).astype(np.int64)
        ys = np.clip(np.floor(cy + jy + grid), 0, rgb.shape[0] - 1).astype(np.int64)
        crops.append(rgb[ys[:, None], xs[None, :]])
    x = np.stack(crops).astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def phase_trainer(torch, np, device, card):
    """The Trainer on Face Mesh V1 at batch 64 on the card and on the CPU
    from the same perturbed weights, crops and teacher labels: losses held
    to the CPU run's, the stored parameters in units of lr·K, ms/step; then
    inference through the stage kernel on the trained weights against the
    op-by-op graph (the CNN bar). → the trained network."""
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import NeuralNetwork
    from zaru_tpu_torch.train import Trainer

    x = train_inputs(np)
    teacher = NeuralNetwork.load(model_path("face_landmark.onnx"), device=device)
    with torch.inference_mode():
        y = teacher.module(torch.from_numpy(x).to(device))[0].reshape(TRAIN_BATCH, -1).cpu().numpy()
    rng = np.random.default_rng(3)
    base = {k: v.detach().cpu().numpy() for k, v in teacher.params.items()}
    student = {k: (base[k] + rng.normal(0, TRAIN_PERTURB * (np.std(base[k]) + 1e-6), base[k].shape)).astype(np.float32)
               for k in sorted(base)}
    runs = []
    for dev in (device, torch.device("cpu")):
        net = NeuralNetwork.load(model_path("face_landmark.onnx"), device=dev)
        net.load_params(student)
        trainer = Trainer(net)
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(trainer.train_step(xd, yd))  # ends in the loss's host read
            times.append(time.perf_counter() - t0)
        runs.append((net, np.asarray(losses), times))
    (net, losses, times), (cpu_net, cpu_losses, cpu_times) = runs
    rel = np.abs(losses / cpu_losses - 1)
    param_err = max(float((p.detach().cpu() - cpu_net.params[k].detach()).abs().max())
                    for k, p in net.params.items()) / (1e-4 * TRAIN_STEPS)
    print(f"Trainer on Face Mesh V1, batch {TRAIN_BATCH}, {TRAIN_STEPS} Adam steps at lr 1e-4: losses on the card "
          f"{[round(float(v), 6) for v in losses]}, relative difference from the CPU run {rel.max():.3g} "
          f"(first {rel[0]:.3g}), parameters {param_err:.3g} lr·K apart; {np.mean(times[1:]) * 1e3:.3f} ms/step "
          f"on the card (first step {times[0] * 1e3:.1f} ms), {np.mean(cpu_times) * 1e3:.1f} ms/step on the CPU "
          f"[{card}]", flush=True)
    check(rel[0] <= TRAIN_FIRST_LOSS_RTOL and rel.max() <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_TOL_LR_STEPS,
          "the Trainer on the card parts from its CPU run beyond the tolerances")
    check(losses[-1] < losses[0], "the Trainer's loss did not fall")
    xd = torch.from_numpy(x).to(device)
    with torch.inference_mode():
        zero_launches()
        fused = net.module(xd)[0]
        stage = read_launches()["blaze_stage"]
        with net.module.without_plans():
            op_by_op = net.module(xd)[0]
    err = float((fused - op_by_op).abs().max())
    tol = 1e-3 * max(1.0, float(op_by_op.abs().max()))
    print(f"after training: inference through the stage kernel ({stage} launches) against the op-by-op graph on "
          f"the trained weights: max difference {err:.3g} (bar {tol:.3g} + 2e-3 relative)", flush=True)
    check(stage == 8 and bool(((fused - op_by_op).abs() <= tol + 2e-3 * op_by_op.abs()).all()),
          "inference after training does not see the trained weights")
    return net


def phase_checkpoint_profiler(torch, device, card, net, tracker, call, frames):
    """An async checkpoint of the trained card parameters (host copy
    before the call returns, written on a thread) read back onto the card;
    then a profiler trace of one exported detect step, which must name the
    stage and both sampler kernels."""
    from zaru_tpu_torch.checkpoint import load_params, save_params_async
    from zaru_tpu_torch.profiling import trace

    params = net.params
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        handle = save_params_async(f"{d}/ckpt", params)
        t1 = time.perf_counter()
        handle.wait_until_finished()
        t2 = time.perf_counter()
        back = load_params(f"{d}/ckpt", like=params)
        check(all(back[k].device == params[k].device and torch.equal(back[k], params[k].detach()) for k in params),
              "the checkpoint did not come back equal onto the card")
        print(f"async checkpoint of {len(params)} tensors ({sum(p.numel() for p in params.values()) * 4 / 1e6:.2f} MB): "
              f"{(t1 - t0) * 1e3:.1f} ms to return (host copy included), {(t2 - t0) * 1e3:.1f} ms written; read "
              f"back onto {device} equal [{card}]", flush=True)
        batch = frames.shape[0]
        state = tracker.init_state(batch)
        yes = torch.tensor(True, device=device)
        with trace(f"{d}/prof"):
            call(state, frames, yes)
        (path,) = Path(f"{d}/prof").glob("*.json")
        text = path.read_text()
        names = [k for k in ("blaze_stage_kernel", "rotated_sample_kernel", "letterbox_sample_kernel") if k in text]
        print(f"profiler trace of one exported detect step at batch {batch}: {path.stat().st_size / 1e6:.2f} MB, "
              f"names {names}", flush=True)
        check(len(names) == 3, f"the trace names only {names}")


# --- the ONNX writer, the demo examples and the GUI's file back-end ---


def phase_writer_on_card(torch, np, device):
    """The port's ONNX writer on the card's machine (no JAX there): its bytes
    of every graph of ``onnx/writer_cases.py`` equal JAX's writer's, stored
    in ``fixtures/onnx_writer.npz``; then the writer-built chain of three
    stride-1 BlazeBlocks at 32 channels (seeded weights) through the
    executor on the card at [64,32,64,64]: one stage-kernel launch a call,
    and the output within the CNN bar of the same graph on the CPU."""
    from zaru_tpu_torch.onnx import load_model, writer
    from zaru_tpu_torch.onnx import writer_cases as cases

    stored = cases.stored()
    same = {k: g(writer) == stored[k] for k, g in cases.GRAPHS.items()}
    data = cases.blaze_chain(writer)
    module, cpu = load_model(data, device), load_model(data, torch.device("cpu"))
    plan = [(st.channels, len(st.blocks)) for st in module.stages]
    x = np.random.default_rng(16).normal(0, 1, (WRITER_BATCH, 32, 64, 64)).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    calls = 3
    with torch.inference_mode():
        before = read_launches()["blaze_stage"]
        for _ in range(calls):
            (out,) = module(xd)
        torch.cuda.synchronize()
        launches = read_launches()["blaze_stage"] - before
        (want,) = cpu(torch.from_numpy(x))
    got = out.cpu()
    err = float((got - want).abs().max())
    bar = CNN_ATOL * max(1.0, float(want.abs().max()))
    within = bool(((got - want).abs() <= bar + CNN_RTOL * want.abs()).all())
    print(f"ONNX writer: bytes equal to JAX's writer's (stored) {same}; writer-built chain of 3 BlazeBlocks at 32 "
          f"channels ({len(data)} bytes, plan {plan}) on {device} at {tuple(x.shape)}: {launches} stage launches in "
          f"{calls} calls, max difference {err:.3g} from the CPU (bar {bar:.3g} + {CNN_RTOL} relative)", flush=True)
    check(all(same.values()), f"the port's writer parts from JAX's stored bytes: {same}")
    check(plan == [(32, 3)] and launches == calls, f"the writer-built chain ran {launches} stage launches in {calls} "
          f"calls (plan {plan})")
    check(within, "the writer-built chain on the card parts from the CPU beyond the CNN bar")


def run_example(name, args, device):
    """The example ``name`` under ``gui.run`` as its ``__main__`` runs it,
    with ``args`` and ``--device``; a failure exits (``gui.run``'s exit
    code). → (host-clock time of each ``show_image`` call, its stdout,
    wall seconds)."""
    import contextlib
    import importlib
    import io

    from zaru_tpu_torch import gui

    mod = importlib.import_module(f"zaru_tpu_torch.examples.{name}")
    shown, show = [], gui.show_image

    def timed_show(key, image):
        show(key, image)
        shown.append(time.perf_counter())

    out = io.StringIO()
    argv = sys.argv
    sys.argv = [name, *args, "--device", str(device)]
    gui.show_image = timed_show
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            gui.run(mod.main)
    finally:
        gui.show_image, sys.argv = show, argv
    return shown, out.getvalue(), time.perf_counter() - t0


def phase_examples(torch, np, device, card, rgba, cropped):
    """``fused_cascade``, ``facemesh`` and ``identify_stream`` (the port's
    demo examples) in this process on the card for EXAMPLE_FRAMES frames
    each, under ``ZARU_TPU_GUI=file`` into a temporary directory, fed the
    stored photo and its crop as ``.npy`` arrays (no image decoder here):
    the PNG count against the frames shown, the launch counts of each run
    (the stage kernel in all three, the rotated and letterbox kernels in
    ``identify_stream``), every stream identified as the enrolled crop,
    ms/frame after the first; then ``info`` with every wrapper ported."""
    import contextlib
    import io

    from zaru_tpu_torch.__main__ import main as cli

    saved = {k: os.environ.get(k) for k in ("ZARU_TPU_GUI", "ZARU_TPU_GUI_DIR", "ZARU_TPU_EXAMPLE_FRAMES",
                                            "ZARU_TPU_LOG")}
    with tempfile.TemporaryDirectory() as d:
        photo, crop = f"{d}/sad_linus.npy", f"{d}/sad_linus_cropped.npy"
        np.save(photo, rgba.cpu().numpy())
        np.save(crop, cropped)
        os.environ.update(ZARU_TPU_GUI="file", ZARU_TPU_GUI_DIR=f"{d}/gui",
                          ZARU_TPU_EXAMPLE_FRAMES=str(EXAMPLE_FRAMES), ZARU_TPU_LOG="WARNING")
        try:
            runs = (("fused_cascade", [photo], "fused cascade", ("blaze_stage",)),
                    ("facemesh", [photo], "facemesh", ("blaze_stage",)),
                    ("identify_stream", [crop, "--stream", photo, "--frames", str(EXAMPLE_FRAMES)], None,
                     FACE_KERNELS))
            for name, args, key, kernels in runs:
                zero_launches()
                shown, out, wall = run_example(name, args, device)
                torch.cuda.synchronize()
                launches = read_launches()
                pngs = len(list(Path(f"{d}/gui/{key}").glob("*.png"))) if key else 0
                if key:
                    want_pngs = EXAMPLE_FRAMES
                    ms = (shown[-1] - shown[0]) / (len(shown) - 1) * 1e3
                else:
                    # identify_stream shows nothing (as JAX's); it prints each
                    # frame's identities and milliseconds.
                    want_pngs = 0
                    lines = [ln for ln in out.splitlines() if ln.startswith("frame ")]
                    check(len(lines) == EXAMPLE_FRAMES and all(ln.count("'sad_linus_cropped'") == 2 for ln in lines),
                          f"identify_stream did not identify every stream as the crop:\n{out}")
                    ms = float(np.mean([float(ln.rsplit("(", 1)[1].split(" ms")[0]) for ln in lines[1:]]))
                print(f"example {name} on {device}, {EXAMPLE_FRAMES} frames ({' '.join(a.rsplit('/', 1)[-1] for a in args)}): "
                      f"{pngs} PNG files (want {want_pngs}), {ms:.3f} ms/frame after the first, {wall:.2f} s in all "
                      f"(model loading included); launches {launches} [{card}]", flush=True)
                check(pngs == want_pngs, f"{name} wrote {pngs} PNG files for {EXAMPLE_FRAMES} frames")
                check(all(launches[k] > 0 for k in kernels), f"{name}: a kernel of its path was never launched: "
                      f"{launches}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli(["info"])
    unported = [ln for ln in out.getvalue().splitlines() if "(wrapper not ported)" in ln]
    print(f"info: exit {code}, {len(out.getvalue().splitlines())} lines, wrappers not ported: {unported}", flush=True)
    check(code == 0 and not unported, f"info lists unported wrappers: {unported}")


# The measurement surface: the cascade program's launches in a window of
# SURFACE_STEPS steps (detection forced on steps 0 and 9).
SURFACE_STEPS, SURFACE_WINDOWS = 16, 4
SURFACE_DETECTS = 2
CASCADE_WINDOW_LAUNCHES = {"rotated_sample": SURFACE_STEPS, "letterbox_sample": SURFACE_DETECTS,
                           "blaze_stage": 8 * SURFACE_STEPS + 2 * SURFACE_DETECTS}
SURFACE_BATCH = 64  # the reduced runs' batch


def run_surface(torch, name, argv, card, kernels, consts=None):
    """``zaru_tpu_torch.examples.<name>.main(argv)`` in this process on the
    card, its stdout printed beside ``card``; ``consts`` set on the module
    for the run (a script's steps and windows). The launch counts are zeroed
    before and read after, and every kernel in ``kernels`` must have
    launched; each call of a function ``timed_windows_stats`` times (a
    window) is counted on its own. → (the launches of the run, [(label,
    launches of one window)], its JSONL records, wall seconds)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"zaru_tpu_torch.examples.{name}")
    windows = []
    timed = getattr(mod, "timed_windows_stats", None)

    def counting(fn, *args, label="", **kw):
        def counted(*a):
            before = read_launches()
            out = fn(*a)  # the counters count launches as the host issues them: no wait needed
            after = read_launches()
            windows.append((label, {k: n - before[k] for k, n in after.items()}))
            return out

        return timed(counted, *args, label=label, **kw)

    saved = {k: getattr(mod, k) for k in (consts or {})}
    if timed is not None:
        mod.timed_windows_stats = counting
    for k, v in (consts or {}).items():
        setattr(mod, k, v)
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        jsonl = f"{d}/out.jsonl"
        args = [a.replace("{out}", jsonl) for a in argv]
        zero_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                mod.main([*args, "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            if timed is not None:
                mod.timed_windows_stats = timed
            for k, v in saved.items():
                setattr(mod, k, v)
        wall = time.perf_counter() - t0
        launches = read_launches()
        records = [json.loads(line) for line in open(jsonl)] if os.path.exists(jsonl) else []
    # The JSONL records, or the lines a script prints instead.
    for line in [json.dumps(r) for r in records] or out.getvalue().splitlines():
        print(f"  {name}: {line} [{card}]", flush=True)
    print(f"{name} {' '.join(argv)}: {wall:.1f} s wall, launches {launches} [{card}]", flush=True)
    check(all(launches[k] > 0 for k in kernels), f"{name} {argv}: a kernel of its path was never launched: {launches}")
    check(not any("error" in r for r in records), f"{name} {argv}: an error record: {records}")
    return launches, windows, records, wall


def phase_measurement_surface(torch, device, card, main_512_ms):
    """The measurement scripts on the card (module docstring, phase 5's
    last part). → the ledger's records."""
    from zaru_tpu_torch.examples import benchsuite

    steps = ["--steps", str(SURFACE_STEPS), "--windows", str(SURFACE_WINDOWS), "--out", "{out}"]
    cascade = {}
    for batch in (512, 8):
        _l, windows, recs, _w = run_surface(torch, "benchsuite", ["cascade", "--batch", str(batch), *steps], card,
                                            FACE_KERNELS)
        cascade[batch] = recs, windows
    _l, lat_windows, lat, _w = run_surface(torch, "benchsuite", ["latency", *steps], card, FACE_KERNELS)
    _l, led_windows, ledger, _w = run_surface(torch, "benchsuite", ["ledger", "--batch", "512", *steps], card,
                                              FACE_KERNELS)
    checked = [(label, w) for _r, ws in cascade.values() for label, w in ws]
    checked += [(label, w) for label, w in lat_windows if label.startswith("latency B=")]
    checked += [(label, w) for label, w in led_windows if label == "ledger cascade"]
    bad = [(label, w) for label, w in checked if any(w[k] != n for k, n in CASCADE_WINDOW_LAUNCHES.items())]
    print(f"cascade program windows: {len(checked)} (cascade at 512 and 8, latency at "
          f"{sorted({int(l.split('=')[1]) for l, _ in checked if l.startswith('latency')})}, ledger), each "
          f"{CASCADE_WINDOW_LAUNCHES}; windows off that count: {bad}", flush=True)
    # The first call of each timing and its windows: cascade at 512 and 8,
    # latency at its 7 batches, the ledger's cascade stage.
    check(len(checked) == (2 + 7 + 1) * (SURFACE_WINDOWS + 1) and not bad,
          f"{len(checked)} cascade program windows, launched off the cadence: {bad}")
    stages = [r.get("stage") for r in ledger]
    check(stages == [*benchsuite.LEDGER_STAGES, "derived"], f"the ledger wrote {stages}")
    (c512,) = cascade[512][0]
    print(f"benchsuite cascade at 512: {c512['ms_per_step']} ms/step (median {c512['ms_per_step_median']}, "
          f"{c512['windows']} windows of {SURFACE_STEPS} steps) beside this run's phase 5 main path at 512: "
          f"{main_512_ms:.3f} ms/step (54 steps) [{card}]", flush=True)
    small = ["--batch", str(SURFACE_BATCH), "--steps", str(SURFACE_STEPS), "--windows", "1", "--out", "{out}"]
    for sub, kernels, extra in (
        ("batch-sweep", FACE_KERNELS, ["--sweep-batches", str(SURFACE_BATCH)]),
        ("cadence", FACE_KERNELS, []),
        ("detect", ("letterbox_sample", "blaze_stage"), []),
        ("gate", FACE_KERNELS, []),
        ("landmark", ("rotated_sample", "blaze_stage"), []),
        ("cnnstage", ("blaze_stage",), []),
        ("parity", HAND_KERNELS, []),
        ("sampler", ("rotated_sample",), []),
        ("hand", HAND_KERNELS, []),
        ("bf16", FACE_KERNELS, []),
    ):
        _l, _ws, recs, _w = run_surface(torch, "benchsuite", [sub, *small, *extra], card, kernels)
        if sub == "parity":
            check(all(r["plain_eq"] for r in recs), "parity: a sampler kernel parts from its plain version")
    b = str(SURFACE_BATCH)
    short = {"SCAN_STEPS": 8, "WINDOWS": 1}
    for name, argv, kernels, consts in (
        ("irisbench", [b, "{out}"], FACE_KERNELS, {"STEPS": SURFACE_STEPS, "WINDOWS": 1}),
        ("identifybench", [b, "512"], FACE_KERNELS, short),
        ("gatebench", [b], FACE_KERNELS, short),
        ("detbench", [b], FACE_KERNELS, short),
        ("multifacebench", [b, "4"], ("rotated_sample", "blaze_stage"), short),
        ("handbench", [b, "4"], HAND_KERNELS, short),
        ("ingestbench", ["{out}"], (), {}),
        ("jpegbench", [], (), {}),
    ):
        run_surface(torch, name, argv, card, kernels, consts)
    return ledger


def timed_phase(what, fn, *args):
    """``fn(*args)``, then its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {what} took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not (ROOT / "zaru_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py needs the repository checkout (zaru_tpu_torch/ beside it)",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from zaru_tpu_torch.ops import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    print(f"build: {len(_build.SOURCES)} kernel sources in {_build.build_all():.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)

    if "--blaze-block" in sys.argv[1:]:
        _rgba, img = load_photo(torch, np, device)
        kernels = [timed_phase("6, the BlazeBlock kernel", phase_blaze_block, torch, np, device, smi, img)]
        print(json.dumps({"kernels": kernels}), flush=True)
    elif "--entry-block" in sys.argv[1:]:
        _rgba, img = load_photo(torch, np, device)
        kernels = [timed_phase("6, the entry block kernel", phase_entry_block, torch, np, device, smi, img)]
        print(json.dumps({"kernels": kernels}), flush=True)
    elif "--bottleneck" in sys.argv[1:]:
        _rgba, img = load_photo(torch, np, device)
        kernels = [timed_phase("6, the bottleneck kernel", phase_bottleneck, torch, np, device, smi, img)]
        print(json.dumps({"kernels": kernels}), flush=True)
    elif "--sharding" in sys.argv[1:]:
        from zaru_tpu_torch.pipeline import FaceTracker

        _rgba, img = load_photo(torch, np, device)
        timed_phase("5, stream sharding", phase_sharding, torch, np, img, device, smi, FaceTracker(device=device))
    else:
        # The pose models BodyTracker loads: the stub blobs stored in
        # body_track.npz (the real ones are missing upstream).
        with tempfile.TemporaryDirectory() as stubs:
            write_body_stubs(np, stubs)
            os.environ["ZARU_TPU_MODELS"] = stubs
            run_phases(torch, np, device, smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def run_phases(torch, np, device, smi):
    """Phases 3-7 (see the module docstring)."""
    timed = timed_phase
    timed("3, kernels vs plain", phase_kernels_vs_plain, torch, device)
    timed("3, the stage kernel's NHWC variant and the plan's other chains", phase_stage_nhwc_vs_plain, torch, np,
          device)
    timed("3, the ONNX writer and a writer-built chain on the card", phase_writer_on_card, torch, np, device)
    rgba, img = load_photo(torch, np, device)
    timed("3, this slice's shapes vs plain", phase_slice_shapes_vs_plain, torch, np, device, rgba)
    timed("3, BodyTracker's shapes vs plain", phase_body_shapes_vs_plain, torch, np, device)
    timed("3, StreamIdentifier's 112x112 crops vs plain", phase_identify_shapes_vs_plain, torch, np, device, rgba)
    rgb = timed("3, RGB to YUV vs plain", phase_yuv_vs_plain, torch, img, device)
    timed("4, FaceTracker vs JAX", phase_vs_jax, torch, np, device, rgba)
    timed("4, face models and entry points vs JAX", phase_face_models_vs_jax, torch, np, device, rgba)
    timed("4, multi-object vs JAX", phase_multi_vs_jax, torch, np, device, rgba)
    timed("4, BodyTracker vs JAX", phase_body_vs_jax, torch, np, device)
    nets, image, cropped = timed("4, host engines and eval vs JAX", phase_host_vs_jax, torch, np, device, rgba)
    timed("4, body host API and nms_remove_device vs JAX", phase_host_remainders_vs_jax, torch, np, device, rgba)
    timed("4, bf16 networks and trackers vs JAX", phase_bf16_vs_jax, torch, np, device, rgba)
    timed("4, host engines and eval: the full sweep", full_sweep, torch, np, device, cropped, rgba, smi, "first")
    ident = timed("4, identification vs JAX", phase_identify_vs_jax, torch, np, device, rgba, cropped)
    timed("4, blend, quat, Procrustes, Dlt, approx and the head pose", phase_pose3d_vs_cpu, torch, np, device, cropped)
    timed("4, the ONNX dialect and the NHWC layout vs JAX", phase_dialect_vs_jax, torch, np, device)
    tracker, runs = timed("5, face runs", phase_full_size, torch, img, device, smi)
    _nhwc_ms, nhwc_launches, _copies = timed("5, NHWC-layout modules in turns with NCHW", phase_nhwc_full_size, torch,
                                             img, device, smi, runs["main path"][1])
    sid, (sid_frames, sid_state, sid_launches), _ = timed(
        "5, StreamIdentifier in turns with the main path", phase_identify_full_size, torch, np, img, device, smi,
        tracker, ident, rgba, cropped)
    hands, hand_frames, seed, multi = timed("5, multi-object runs", phase_multi_full_size, torch, img, device, smi)
    model_frames, models, run_frame_ms = timed("5, face models and run_frame", phase_slice_full_size, torch, img,
                                               device, smi)
    body, body_frames, body_state, body_launches = timed("5, BodyTracker", phase_body_full_size, torch, img,
                                                         device, smi)
    serve_launches = timed("5, serving", phase_serve, torch, np, img, device, smi, tracker,
                           runs["ms"][("main path", SERVE_STREAMS)], run_frame_ms)
    host_calls, sweeps = timed("5, host engines and eval", phase_host_full_size, torch, np, device, nets, image,
                               cropped, rgba, smi)
    timed("5, the demo examples under the file back-end", phase_examples, torch, np, device, smi, rgba, cropped)
    timed("5, bf16 against f32", phase_bf16_full_size, torch, img, device, smi, tracker, hands, seed)
    main_frames = runs["main path"][0]
    call, export_launches = timed("5, export and run-exported of the main path", phase_export_full_size, torch, img,
                                  device, smi, tracker, main_frames)
    timed("5, analyze", phase_analysis_full_size, torch, device, smi, tracker)
    trained = timed("5, Trainer on Face Mesh V1", phase_trainer, torch, np, device, smi)
    timed("5, checkpoint and profiler", phase_checkpoint_profiler, torch, device, smi, trained, tracker, call,
          main_frames)
    del call
    timed("5, stream sharding", phase_sharding, torch, np, img, device, smi, tracker)
    timed("5, the measurement surface", phase_measurement_surface, torch, device, smi,
          runs["ms"][("main path", 512)])
    print(f"launches in the batch-512 face runs ({STEPS} steps each): {runs['launches']}", flush=True)
    print(f"launches in the batch-128 multi-object runs ({STEPS} steps each): {multi}", flush=True)
    print(f"launches in the face-model and single-stream runs ({STEPS} steps each): "
          f"{ {k: v[2] for k, v in models.items()} }", flush=True)
    print(f"launches in the BodyTracker run at 512 ({STEPS} steps): {body_launches}; in the serving run at "
          f"{SERVE_STREAMS} streams ({STEPS} steps): {serve_launches}", flush=True)
    print(f"launches in the StreamIdentifier run at 512 ({STEPS} steps): {sid_launches}", flush=True)
    print(f"launches in the NHWC-layout Cnn run at 512 ({STEPS} calls): {nhwc_launches}", flush=True)
    print(f"launches in the exported main path's run at 512 ({STEPS} steps): {export_launches}", flush=True)
    print(f"launches in the host engines' runs ({HOST_CALLS} calls each): "
          f"{ {k: v[1]['blaze_stage'] for k, v in host_calls.items()} } stage chains; in the timed sweep: "
          f"{ {k: v[1]['blaze_stage'] for k, v in sweeps.items()} }", flush=True)
    t0 = time.perf_counter()
    launches = runs["launches"]["main path"]
    frames, state, _ = runs["main path"]
    kernels = phase_kernel_times(torch, frames, tracker.lm_cnn, tracker.det_cnn, state["roi"], launches,
                                 "main path")
    kernels.append(phase_stage_times(torch, tracker, frames, state, launches["blaze_stage"], STEPS))
    kernels.append(phase_stage_times(torch, tracker, frames, state, nhwc_launches["blaze_stage_nhwc"], STEPS,
                                     "Cnn with NHWC-layout modules", nhwc=True))
    kernels.append(phase_yuv_times(torch, rgb, launches["rgb_to_yuv"]))
    kernels.append(phase_bottleneck(torch, np, device, smi, img))
    kernels.append(phase_blaze_block(torch, np, device, smi, img, runs["blaze_block"]))
    kernels.append(phase_entry_block(torch, np, device, smi))
    phase_kernel_times(torch, hand_frames, hands.lm_cnn, hands.det_cnn, seed, multi["hand tracking"],
                       "hand tracking run", prescale_m=256)
    v2, v2_state, v2_launches = models["FaceTracker(landmarker=FaceMeshV2())"]
    kernels += phase_kernel_times(torch, model_frames, v2.lm_cnn, v2.det_cnn, v2_state["roi"], v2_launches,
                                  "FaceMeshV2 run", names=("rotated_sample",))
    full, full_state, full_launches = models["FaceTracker(detector=FullRangeNetwork())"]
    kernels += phase_kernel_times(torch, model_frames, full.lm_cnn, full.det_cnn, full_state["roi"],
                                  full_launches, "FullRange run", names=("letterbox_sample",))
    one, one_state, one_launches = models["FaceTracker.run_frame, one stream"]
    kernels.append(phase_stage_times(torch, one, img[None], {"roi": one_state["roi"][None]},
                                     one_launches["blaze_stage"], STEPS, "run_frame, one stream"))
    kernels += phase_kernel_times(torch, body_frames, body.lm_cnn, body.det_cnn, body_state["rois"], body_launches,
                                  "BodyTracker run", prescale_m=256)
    host_cnns = SimpleNamespace(lm_cnn=nets["v1"].cnn(), det_cnn=nets["face"].cnn())
    host_roi = torch.tensor([HOST_SEED_ROI], dtype=torch.float32, device=device)
    kernels.append(phase_stage_times(torch, host_cnns, rgba[None], {"roi": host_roi},
                                     sum(v[1]["blaze_stage"] for v in host_calls.values()), 3 * HOST_CALLS,
                                     "host engines, batch 1"))
    kernels += phase_kernel_times(torch, sid_frames, sid.embedder.cnn(), tracker.det_cnn, sid_state["roi"],
                                  sid_launches, "StreamIdentifier run, 112x112 identity crops",
                                  names=("rotated_sample",), view_rects=sid._crop_rects(sid_state["roi"]))
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
