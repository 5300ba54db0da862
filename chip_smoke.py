#!/usr/bin/env python3
"""Builds the PyTorch port's CUDA kernels and drives its main path on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failed check exits non-zero):

1. device: ``nvidia-smi`` name and power limit, CUDA version;
2. build: both kernels from ``zaru_tpu_torch/csrc``, one ``nvcc`` each;
3. each kernel against its plain PyTorch version on the card, bit for bit:
   the rotated-ROI sampler on coordinate-encoded 1080p frames at batch 64
   with ``[B,2,5]`` slots (upright, tilted, frame-corner, stride 2, 3 and 4
   views), the letterbox sampler on 1080p and 720p frames;
4. the main path against the JAX reference stored in
   ``zaru_tpu_torch/fixtures/sad_linus_track.npz``: one step at a time from
   JAX's state (flags equal, landmarks and ROI within the CPU test's
   tolerance), then free-running (flags equal);
5. the main path at full size: the fixture photo upscaled to 1920×1080 on
   the card, tiled to batches 64 and 512, ``FaceTracker.step_batch`` with
   detection forced every 9th step; frames/s and ms/step. The kernels'
   launch counts are zeroed just before the batch-512 run and read just
   after it;
6. each kernel's time at the batch-512 main-path inputs (the launch alone,
   and the whole wrapper) beside its plain version's and its bound;
7. the launch counts of phase 5, then one JSON line of per-kernel numbers,
   then the result line.

It needs the repository checkout (the ``zaru_tpu_torch`` package beside
it) and a CUDA GPU; without either it exits non-zero and prints no result.
JAX is not used.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
STEP_TOL_PX = 1e-2  # tests/test_torch_face_cascade.py STEP_TOL_PX
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


# Kernel-name substrings grouping the profile's device time.
PROFILE_GROUPS = [
    ("samplers", ("rotated_sample_kernel", "letterbox_sample_kernel")),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "winograd")),
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


def cuda_ms(torch, fn, reps=50):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels_vs_plain(torch, device):
    from zaru_tpu_torch.ops.letterbox import letterbox_sample, letterbox_sample_reference
    from zaru_tpu_torch.ops.rotated_fast import rotated_sample_fast, rotated_sample_fast_reference
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
    got = rotated_sample_fast(frames, rects, 192, 192, -1.0, 1.0)
    want = rotated_sample_fast_reference(frames, rects, 192, 192, -1.0, 1.0)
    torch.cuda.synchronize()
    differ = int((got != want).any(-1).sum())
    black = int((got == -1.0).all(-1).sum())
    print(f"rotated_sample vs plain: {tuple(got.shape)}, {differ} pixels differ, "
          f"{black} black (out of frame)", flush=True)
    check(differ == 0 and black > 0, "rotated_sample kernel disagrees with its plain version")

    for H, W in ((1080, 1920), (720, 1280)):
        frames = torch.randint(0, 256, (8, H, W, 4), generator=gen, dtype=torch.uint8).to(device)
        _fit, fit_rrect = _ops.full_frame_fit(frames, Resolution(128, 128))
        rr = fit_rrect.expand(8, 5).clone()
        rr[4:, 0] += torch.tensor([-300.0, 200.0, 31.3, 700.0], device=device)
        rr[4:, 2:4] *= 0.61
        got = letterbox_sample(frames, rr, 128, 128, -1.0, 1.0)
        want = letterbox_sample_reference(frames, rr, 128, 128, -1.0, 1.0)
        torch.cuda.synchronize()
        differ = int((got != want).any(-1).sum())
        print(f"letterbox_sample vs plain at {W}x{H}: {tuple(got.shape)}, {differ} pixels differ",
              flush=True)
        check(differ == 0, "letterbox_sample kernel disagrees with its plain version")


def phase_vs_jax(torch, np, device):
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.pipeline import FaceTracker

    with np.load(fixture_path("sad_linus_track.npz")) as f:
        ref = {k: f[k] for k in f.files}
    rgb = torch.from_numpy(ref["rgb"]).to(device)
    rgba = torch.cat([rgb, torch.full_like(rgb[..., :1], 255)], -1)
    batch = ref["state_roi"].shape[1]
    tracker = FaceTracker(device=device)

    def frames_for(t):
        frames = rgba.expand(batch, *rgba.shape).clone()
        if ref["zero"][t] >= 0:
            frames[int(ref["zero"][t])] = 0
        return frames

    lm_err = roi_err = 0.0
    for t, force in enumerate(ref["force"]):
        state = {
            "roi": torch.from_numpy(ref["state_roi"][t]).to(device),
            "tracking": torch.from_numpy(ref["state_tracking"][t]).to(device),
            "filter": {k: torch.from_numpy(ref[f"state_{k}"][t]).to(device)
                       for k in ("x", "dx", "init")},
        }
        _, out = tracker.step_batch(state, frames_for(t), bool(force))
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
    return rgba


def phase_full_size(torch, F, rgba, device, card):
    from zaru_tpu_torch.ops.letterbox import letterbox_sample
    from zaru_tpu_torch.ops.rotated_fast import rotated_sample_fast
    from zaru_tpu_torch.pipeline import FaceTracker

    img = F.interpolate(
        rgba.permute(2, 0, 1)[None].float(), size=(1080, 1920), mode="bilinear", align_corners=False
    )
    img = img[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).contiguous()
    tracker = FaceTracker(device=device)
    steps, warmup = 54, 9
    result = {}
    for batch in (64, 512):
        frames = img.expand(batch, *img.shape).contiguous()
        state = tracker.init_state(batch)
        for i in range(warmup):
            state, out = tracker.step_batch(state, frames, force_detect=(i % 9 == 0))
        torch.cuda.synchronize()
        if batch == 512:
            rotated_sample_fast.launches = 0
            letterbox_sample.launches = 0
        t0 = time.perf_counter()
        for i in range(steps):
            state, out = tracker.step_batch(state, frames, force_detect=(i % 9 == 0))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if batch == 512:
            result["launches"] = {
                "rotated_sample": rotated_sample_fast.launches,
                "letterbox_sample": letterbox_sample.launches,
            }
        valid = bool(out["valid"].all())
        conf = float(out["confidence"].min())
        print(f"main path at 1920x1080, batch {batch}: {steps} steps (detect every 9th) in "
              f"{dt:.3f} s: {dt / steps * 1e3:.3f} ms/step, {batch * steps / dt:.1f} frames/s, "
              f"all valid {valid}, min confidence {conf:.4f} [{card}]", flush=True)
        check(valid and conf > 0.9, f"batch {batch}: lost the face")
        result[batch] = (frames, state)
    result["profile"] = profile_steps(torch, tracker, *result[512])
    return tracker, result


def profile_steps(torch, tracker, frames, state, steps=9):
    """torch.profiler over one detect step and 8 track steps: device time
    by kernel, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = tracker.step_batch(state, frames, force_detect=(i == 0))
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
    print(f"profile, batch {frames.shape[0]}, {steps} steps (1 detect): {wall_ms / steps:.3f} ms/step "
          f"wall, device busy {busy:.3f} ms/step ({100 * busy * steps / wall_ms:.1f}%), "
          f"{len(per_step)} kernels; ms/step by group: {by_group}; top: {top}", flush=True)
    return per_step


def phase_kernel_times(torch, tracker, frames, state, launches, steps):
    """Each kernel at the batch-512 main-path inputs: ``ms`` is the kernel
    launch alone, from CUDA events (the rotated sampler's coefficients are
    computed once beforehand: with them, the wrapper's ~60 small torch ops
    make a lone call host-bound, and that is printed as ``wrapper``)."""
    from zaru_tpu_torch.ops.letterbox import letterbox_sample, letterbox_sample_reference
    from zaru_tpu_torch.ops.rotated_fast import (
        rotated_sample_fast, rotated_sample_fast_reference, rotated_sample_launch, sampler_coefs,
    )
    from zaru_tpu_torch.pipeline import _ops

    lm, det = tracker.lm_cnn, tracker.det_cnn
    lm_res, det_res = lm.input_resolution(), det.input_resolution()
    view_rects = _ops.aspect_view_rect(state["roi"], lm_res)
    coefs, icoefs = sampler_coefs(view_rects)
    _fit, fit_rrect = _ops.full_frame_fit(frames, det_res)
    fit_rects = fit_rrect.expand(frames.shape[0], 5).contiguous()
    white = torch.full_like(frames[:1], 255).expand_as(frames)
    kernels = []
    for name, kernel, plain, launch, rects, res, source, replaces, flops_px in (
        ("rotated_sample", rotated_sample_fast, rotated_sample_fast_reference,
         lambda f: rotated_sample_launch(f, coefs, icoefs, lm_res.width, lm_res.height, -1.0, 1.0),
         view_rects, lm_res, "zaru_tpu_torch/csrc/rotated_sample.cu",
         "zaru_tpu/ops/rotated_fast.py:1481", 32),
        ("letterbox_sample", letterbox_sample, letterbox_sample_reference,
         lambda f: letterbox_sample(f, fit_rects, det_res.width, det_res.height, -1.0, 1.0),
         fit_rects, det_res, "zaru_tpu_torch/csrc/letterbox_sample.cu",
         "zaru_tpu/ops/pallas_kernels.py:112", 22),
    ):
        call = lambda f, fn=kernel: fn(f, rects, res.width, res.height, -1.0, 1.0)  # noqa: E731
        call_plain = lambda f, fn=plain: fn(f, rects, res.width, res.height, -1.0, 1.0)  # noqa: E731
        got, want = call(frames), call_plain(frames)
        err = float((got - want).abs().max())
        check(torch.equal(launch(frames).reshape(got.shape), got), f"{name}: launch differs from wrapper")
        # Pixels that read an in-frame source: on an all-white frame they map
        # to hi (1), the others to lo (-1).
        reads = int((call_plain(white) > 0).all(-1).sum())
        out_px = got.numel() // 3
        nbytes = out_px * 12 + reads * 4 + rects.numel() * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = out_px * flops_px / F32_FLOPS * 1e3
        ms = cuda_ms(torch, lambda: launch(frames))
        wrapper_ms = cuda_ms(torch, lambda: call(frames))
        plain_ms = cuda_ms(torch, lambda: call_plain(frames), reps=5)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        print(f"{name} at batch {frames.shape[0]} ({tuple(got.shape)}): {ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB), wrapper {wrapper_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library none, {launches[name] / steps:.3f} launches/step, "
              f"max abs err {err}", flush=True)
        check(err == 0.0, f"{name} disagrees with its plain version at the main-path inputs")
    return kernels


def main() -> int:
    if not (ROOT / "zaru_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py needs the repository checkout (zaru_tpu_torch/ beside it)",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F

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

    print(f"build: {len(_build.SOURCES)} kernels in {_build.build_all():.1f} s "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)

    phase_kernels_vs_plain(torch, device)
    rgba = phase_vs_jax(torch, np, device)
    tracker, runs = phase_full_size(torch, F, rgba, device, smi)
    launches = runs["launches"]
    print(f"launches in the batch-512 main-path run (54 steps): {launches}", flush=True)
    check(all(n > 0 for n in launches.values()), "a kernel of the main path was never launched")
    frames, state = runs[512]
    kernels = phase_kernel_times(torch, tracker, frames, state, launches, 54)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
