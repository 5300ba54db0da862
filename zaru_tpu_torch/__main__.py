"""Command-line interface of the port (zaru_tpu/__main__.py): offline
tracking, the multi-stream serving loop, the equivariance sweep and the
asset inventory, on the GPU.

    python -m zaru_tpu_torch info
    python -m zaru_tpu_torch eval [--models face_mesh,...] [--input PHOTO]
        [--json OUT] [--device cuda]
    python -m zaru_tpu_torch track INPUT [--pipeline face|hand|body] [--iris]
        [--out out.jsonl] [--annotate DIR] [--max-frames N] [--slots K]
        [--device cuda]
    python -m zaru_tpu_torch serve INPUT... --streams N [--pipeline ...]
        [--steps N | --soak SECONDS] [--out out.jsonl] [--landmarks]
        [--no-loop] [--decode-wait MS] [--batch-program] [--shard] [--device cuda]
    python -m zaru_tpu_torch export OUT [--pipeline face|hand|body] [--iris]
        [--slots N] [--batch N] [--height H] [--width W] [--device cuda]
        [--verify]
    python -m zaru_tpu_torch run-exported ARTIFACT INPUT [--state S]
        [--out out.jsonl] [--max-frames N]

``track`` reads INPUT (video file, GIF/APNG animation, single image, or a
directory of images), runs the chosen cascade one stream at a time
(``run_frame``), and writes one JSON line per frame (landmarks in image
coordinates). ``serve`` is the multi-stream serving loop
(:func:`zaru_tpu_torch.serve.serve_loop`): N streams fed round-robin from
the INPUT sources (each looped when exhausted, or with ``--no-loop``
finite, joining as slots free), decoded on a host thread pool, uploaded
double-buffered (``pipeline.ingest.FrameUploader``) and stepped through the
batch-gated cascade, one JSON line per step. ``eval`` forwards its
arguments to :func:`zaru_tpu_torch.eval.main`, the equivariance sweep.
``export`` saves a tracker's step as a ``torch.export`` artifact with the
weights baked in (``--batch N``: the batch-gated ``step_batch``, which runs
the letterbox, rotated and stage kernels; else the single-stream ``step``),
beside its initial state (``OUT.state.npz``) and manifest
(``OUT.manifest.json``); ``run-exported`` runs such an artifact over INPUT
with nothing but this package, after checking the frames, the state
sidecar and the manifest against the program's signature
(:mod:`zaru_tpu_torch.export`).
``info`` reports the runtime (torch and CUDA versions, the card), which
model blobs resolve through the ``ZARU_TPU_MODELS`` search chain, and which
of their wrappers the port lacks.

``--device`` (``cuda`` unless named) is the port's counterpart of
``JAX_PLATFORMS``: without a GPU the default raises instead of running on
the CPU; ``--device cpu`` runs the kernels' plain versions; an exported
artifact runs on the device it was exported for. ``serve --shard`` splits
the streams over every visible GPU (``parallel.ShardedTracker``; with
``--device cpu``, one CPU shard).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
_ANIM_EXTS = {".gif", ".apng"}

# Every model blob the domain wrappers can load, in wrapper order
# (zaru_tpu/__main__.py:52-68). `info` reports found/missing for each.
_KNOWN_MODELS = (
    ("face.detection.ShortRangeNetwork", "face_detection_short_range.onnx"),
    ("face.detection.FullRangeNetwork", "face_detection_full_range.onnx"),
    ("face.landmark.mediapipe.FaceMeshV1", "face_landmark.onnx"),
    ("face.landmark.mediapipe.FaceMeshV2", "face_landmarks_detector.onnx"),
    ("face.landmark.multipie68.PeppaFacialLandmark", "slim_160_latest.onnx"),
    ("face.landmark.multipie68.FaceOnnx", "landmarks_68_pfld.onnx"),
    ("face.eye.EyeNetwork", "iris_landmark.onnx"),
    ("face.recognition.Embedder", "mobilefacenet.onnx"),
    ("hand.detection.LiteNetwork", "palm_detection_lite.onnx"),
    ("hand.detection.FullNetwork", "palm_detection_full.onnx"),
    ("hand.landmark.LiteNetwork", "hand_landmark_lite.onnx"),
    ("hand.landmark.FullNetwork", "hand_landmark_full.onnx"),
    ("body.detection.PoseNetwork", "pose_detection.onnx"),
    ("body.landmark.LiteNetwork", "pose_landmark_lite.onnx"),
    ("body.landmark.FullNetwork", "pose_landmark_full.onnx"),
)


def _iter_frames(path: Path, device):
    """Yields `Image` frames on ``device`` from a video / animation / image
    / directory."""
    from .image import Image

    if path.is_dir():
        files = sorted(p for p in path.iterdir() if p.suffix.lower() in _IMAGE_EXTS)
        if not files:
            raise SystemExit(f"no images ({sorted(_IMAGE_EXTS)}) in {path}")
        for f in files:
            yield Image.load(f, device)
    elif path.suffix.lower() in _ANIM_EXTS:
        from .video.anim import Animation

        for fr in Animation.from_path(path, device).frames():
            yield fr.image_view()
    elif path.suffix.lower() in _IMAGE_EXTS:
        yield Image.load(path, device)
    else:
        from .video.file import VideoFile

        video = VideoFile(path, device)
        while True:
            frame = video.read()
            if frame is None:
                return
            yield frame


def _build_tracker(name: str, *, iris: bool, slots: int, device):
    from . import pipeline

    if name == "face":
        return pipeline.FaceTracker(iris=iris, device=device)
    if iris:
        raise SystemExit("--iris only applies to --pipeline face")
    if name == "hand":
        return pipeline.MultiHandTracker(max_hands=slots, device=device)
    if name == "body":
        return pipeline.BodyTracker(device=device)
    raise SystemExit(f"unknown pipeline {name!r}")


def _to_jsonable(out: dict) -> dict:
    from .serve import _host

    rec = {}
    for key, val in out.items():
        arr = _host(val)
        rec[key] = arr.item() if arr.ndim == 0 else arr.tolist()
    return rec


def _annotate(image, out, path: Path):
    import cv2
    import numpy as np

    from .image.draw import Canvas, marker
    from .serve import _host

    canvas = Canvas(image)
    landmarks = _host(out["landmarks"])
    valid = np.atleast_1d(_host(out["valid"]))
    slot_lms = landmarks[None] if landmarks.ndim == 2 else landmarks
    for ok, lms in zip(valid, slot_lms):
        if bool(ok):
            for p in lms:
                marker(canvas, p[:2], size=2)
    rgba = canvas.flush().to_numpy()
    cv2.imwrite(str(path), cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGR))


def cmd_track(args) -> int:
    from .serve import _host

    tracker = _build_tracker(args.pipeline, iris=args.iris, slots=args.slots, device=args.device)
    state = tracker.init_state()
    sink = open(args.out, "w") if args.out else sys.stdout
    annotate_dir = None
    if args.annotate:
        annotate_dir = Path(args.annotate)
        annotate_dir.mkdir(parents=True, exist_ok=True)

    shape = None
    n_valid = 0
    try:
        for idx, image in enumerate(_iter_frames(Path(args.input), tracker.device)):
            if args.max_frames is not None and idx >= args.max_frames:
                break
            if shape is not None and tuple(image.data.shape) != shape:
                print(f"frame {idx}: shape {tuple(image.data.shape)} != {shape} "
                      "(recompiles the step program)", file=sys.stderr)
            shape = tuple(image.data.shape)
            state, out = tracker.run_frame(state, image.data)
            rec = _to_jsonable(out)
            rec["frame"] = idx
            rec.pop("rois", None)  # internal tracking state, not a result
            print(json.dumps(rec), file=sink, flush=sink is sys.stdout)
            n_valid += int(_host(out["valid"]).sum())
            if annotate_dir is not None:
                _annotate(image, out, annotate_dir / f"frame_{idx:05d}.jpg")
    finally:
        if sink is not sys.stdout:
            sink.close()
    frames = idx + 1 if shape is not None else 0
    print(f"{frames} frames, {n_valid} valid detections", file=sys.stderr)
    return 0


def _looping_frames(path: Path, device):
    """Like :func:`_iter_frames` but restarts the source when exhausted —
    a serving stream never ends."""
    while True:
        yielded = False
        for image in _iter_frames(path, device):
            yielded = True
            yield image
        if not yielded:
            raise SystemExit(f"source {path} produced no frames")


def cmd_serve(args) -> int:
    """The multi-stream serving loop (:func:`zaru_tpu_torch.serve.serve_loop`
    and its policies, zaru_tpu/__main__.py:195-391): join/leave with
    ``--no-loop`` (the joined slot's state reset, so it re-detects), drops
    (a decode that misses ``--decode-wait`` ms re-serves the previous frame),
    a stats line every ``--report-every`` steps and a summary, ``--soak``
    seconds instead of ``--steps``, and at ``--streams 1`` the tracker's
    single-stream ``run_frame`` (``--batch-program`` restores the gated
    batch step). Frames decode on the host and reach the device through the
    double-buffered uploader. ``--shard`` splits the streams over every
    visible GPU (with ``--device cpu``, over the one CPU device), each shard
    stepped on its device (:class:`~zaru_tpu_torch.parallel.ShardedTracker`),
    frames uploaded straight into the sharded layout."""
    from ._device import resolve_device
    from .pipeline.ingest import FrameUploader
    from .serve import StreamSet, serve_loop

    tracker = _build_tracker(args.pipeline, iris=args.iris, slots=args.slots, device=args.device)
    runner, target = tracker, tracker.device
    if args.shard:
        from .parallel import ShardedTracker, stream_mesh

        device = resolve_device(args.device)
        mesh = stream_mesh() if device.type == "cuda" else stream_mesh([device])
        if args.streams % len(mesh):
            raise SystemExit(f"--streams {args.streams} must divide evenly over the {len(mesh)} available devices")
        runner = ShardedTracker(tracker, mesh)
        target = runner.frame_sharding
        print(f"sharding {args.streams} streams over {len(mesh)} {device.type} devices", file=sys.stderr)

    def make_factory(path: Path):
        def factory():
            frames = _iter_frames(path, "cpu") if args.no_loop else _looping_frames(path, "cpu")
            for image in frames:
                yield image.to_numpy()

        factory.name = str(path)
        return factory

    if args.no_loop:
        # Finite sources: the first --streams inputs fill the slots, the
        # rest queue up and join as slots free (leave -> join).
        initial = [make_factory(Path(p)) for p in args.inputs[: args.streams]]
        initial += [None] * (args.streams - len(initial))
        pending = [make_factory(Path(p)) for p in args.inputs[args.streams:]]
    else:
        initial = [make_factory(Path(args.inputs[i % len(args.inputs)])) for i in range(args.streams)]
        pending = []

    streams = StreamSet(initial, pending)
    sink = None
    try:
        try:
            prime_events = streams.prime()
        except RuntimeError as e:
            raise SystemExit(str(e))
        for ev in prime_events:
            src = f" ({ev.source})" if ev.source else ""
            print(f"stream slot {ev.slot}: {ev.kind}{src}", file=sys.stderr)
        uploader = FrameUploader(batch=args.streams, shape=streams.frames[0].shape, device=target)
        sink = open(args.out, "w") if args.out else sys.stdout

        def emit(rec, _out):
            print(json.dumps(rec), file=sink, flush=sink is sys.stdout)

        stats = serve_loop(
            runner, streams, uploader,
            single=args.streams == 1 and not args.batch_program and not args.shard,
            steps=args.steps, emit=emit, soak=args.soak, decode_wait=args.decode_wait / 1e3,
            report_every=args.report_every, landmarks=args.landmarks, no_loop=args.no_loop,
            log=lambda line: print(line, file=sys.stderr),
        )
    finally:
        streams.close()
        if sink is not None and sink is not sys.stdout:
            sink.close()
    print(stats.summary(streams), file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    """Saves a tracker's step as a ``torch.export`` artifact
    (zaru_tpu/__main__.py:394 ``cmd_export``): the weights baked in, the
    initial state beside it as a sidecar, and a manifest."""
    import torch
    from torch.utils import _pytree as pytree

    from .export import export_fn, load_exported, save_state, write_manifest

    tracker = _build_tracker(args.pipeline, iris=args.iris, slots=args.slots, device=args.device)
    if args.batch:
        state = tracker.init_state(batch=args.batch)
        frames = torch.zeros((args.batch, args.height, args.width, 4), dtype=torch.uint8, device=tracker.device)
        fn = lambda st, fs: tracker.step_batch(st, fs)  # noqa: E731  the serving step (`run_frames_gated`)
        kind = f"step_batch (gated), batch {args.batch}"
    else:
        state = tracker.init_state()
        frames = torch.zeros((args.height, args.width, 4), dtype=torch.uint8, device=tracker.device)
        fn = lambda st, f: tracker.step(st, f)  # noqa: E731
        kind = "single-stream step"
    out_path = Path(args.out)
    export_fn(fn, (state, frames), out_path, device=tracker.device)
    state_path = Path(f"{out_path}.state.npz")
    save_state(state, state_path)
    manifest = write_manifest(
        out_path, pipeline=args.pipeline, kind=kind, batch=args.batch, frame_shape=frames.shape,
        frame_dtype="uint8", platforms=[str(tracker.device)], state_leaves=len(pytree.tree_leaves(state)),
    )
    size = out_path.stat().st_size
    print(
        f"exported {args.pipeline} {kind} for {args.height}x{args.width} frames for device "
        f"{tracker.device} -> {out_path} ({size / 1e6:.2f} MB) + init state {state_path.name} + {manifest.name}",
        file=sys.stderr,
    )
    if args.verify:
        restored = load_exported(out_path)
        _new_state, out = restored(state, frames)
        shapes = {k: list(v.shape) for k, v in out.items()}
        print(f"verify: reloaded and ran; outputs {shapes}", file=sys.stderr)
    return 0


def cmd_run_exported(args) -> int:
    """Runs an exported step over an offline input with nothing but the
    artifact and its state sidecar (zaru_tpu/__main__.py:459
    ``cmd_run_exported``). The artifact's signature and manifest are
    checked before the frame loop: wrong-sized frames and a stale or
    mismatched sidecar fail with one line. A batch artifact gathers N
    frames a step; the last step pads by repeating the last frame and says
    so (``"padded"``)."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    from .export import deserialize_exported, load_state, read_manifest
    from .serve import _host

    exp = deserialize_exported(args.artifact)
    state = load_state(args.state or f"{args.artifact}.state.npz")

    # The exported arguments are (state, frame): the frame is the last flat
    # input, the state's leaves come before it.
    frame_shape, _ = exp.in_specs[-1]
    state_specs = exp.in_specs[:-1]
    if len(frame_shape) == 4:
        batch, frame_hw = frame_shape[0], frame_shape[1:]
    elif len(frame_shape) == 3:
        batch, frame_hw = 0, frame_shape
    else:
        raise SystemExit(
            f"{args.artifact}: last input has shape {list(frame_shape)}; expected a [H,W,4] or "
            "[B,H,W,4] frame — not a zaru_tpu_torch step artifact?"
        )

    state_leaves = pytree.tree_leaves(state)
    if len(state_leaves) != len(state_specs):
        raise SystemExit(
            f"state sidecar has {len(state_leaves)} arrays but the artifact was exported with "
            f"{len(state_specs)}; the --state file does not belong to this artifact (re-export, or pass "
            "the matching .state.npz)"
        )
    for i, (leaf, (shape, dtype)) in enumerate(zip(state_leaves, state_specs)):
        got = (tuple(np.shape(leaf)), np.asarray(leaf).dtype.name)
        if got != (shape, dtype):
            raise SystemExit(
                f"state sidecar leaf {i} is {got[1]}{list(got[0])} but the artifact expects "
                f"{dtype}{list(shape)}; stale or mismatched --state sidecar"
            )

    manifest = read_manifest(args.artifact)
    if manifest is not None:
        want_shape = ([batch] if batch else []) + list(frame_hw)
        if manifest.get("frame_shape") != want_shape:
            raise SystemExit(
                f"manifest {manifest.get('frame_shape')} disagrees with the artifact signature "
                f"{want_shape}; the .manifest.json does not belong to this artifact"
            )
        print(
            f"artifact: {manifest.get('pipeline')} {manifest.get('kind')} "
            f"(zaru_tpu_torch {manifest.get('framework_version')}, torch {manifest.get('torch_version')}, "
            f"platforms {manifest.get('platforms') or 'default'})",
            file=sys.stderr,
        )

    sink = open(args.out, "w") if args.out else sys.stdout
    n_valid = n_frames = step = 0

    def run_step(frame_or_batch, rec_extra, n_real=None):
        nonlocal state, n_valid, step
        try:
            state, out = exp.call(state, frame_or_batch)
        except (ValueError, TypeError, RuntimeError) as e:
            raise SystemExit(
                f"step {step} (frames {tuple(frame_or_batch.shape)}) failed: exported-signature mismatch "
                f"or a runtime error inside the artifact — {e}"
            ) from e
        rec = _to_jsonable(out)
        rec.update(rec_extra)
        rec.pop("rois", None)
        rec.pop("roi", None)
        print(json.dumps(rec), file=sink, flush=sink is sys.stdout)
        valid = _host(out["valid"]).reshape(-1)
        if n_real is not None:
            valid = valid[:n_real]  # padding frames do not count
        n_valid += int(valid.sum())
        step += 1

    try:
        pending = []
        for idx, image in enumerate(_iter_frames(Path(args.input), exp.device)):
            if args.max_frames is not None and idx >= args.max_frames:
                break
            frame = image.data
            if tuple(frame.shape) != frame_hw:
                raise SystemExit(
                    f"frame {idx} has shape {tuple(frame.shape)}; the artifact expects {frame_hw} frames "
                    "(exported signature)"
                )
            n_frames += 1
            if not batch:
                run_step(frame, {"frame": idx})
                continue
            pending.append(frame)
            if len(pending) == batch:
                run_step(torch.stack(pending), {"frames": n_frames - batch})
                pending = []
        if pending:
            real = len(pending)
            pending += [pending[-1]] * (batch - real)
            run_step(torch.stack(pending), {"frames": n_frames - real, "padded": batch - real}, n_real=real)
    finally:
        if sink is not sys.stdout:
            sink.close()
    print(f"{n_frames} frames, {n_valid} valid detections", file=sys.stderr)
    return 0


def _ported(wrapper: str) -> bool:
    """Whether the port has the wrapper class ``wrapper`` (a path below the
    package)."""
    module, _, cls = wrapper.rpartition(".")
    try:
        return hasattr(importlib.import_module(f"{__package__}.{module}"), cls)
    except ImportError:
        return False


def cmd_info(args) -> int:
    import torch

    from .assets import MISSING_MODELS, ModelMissingError, model_path

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"devices: {names}")
    else:
        print("devices: no CUDA device (torch.cuda.is_available() is False)")
    print("models (search chain: $ZARU_TPU_MODELS, then bundled assets/onnx):")
    for wrapper, blob in _KNOWN_MODELS:
        try:
            where = model_path(blob)
            status = f"ok       {where}"
        except ModelMissingError:
            status = (
                "MISSING  (absent upstream too; drop into assets/onnx/)"
                if blob in MISSING_MODELS
                else "MISSING"
            )
        if not _ported(wrapper):
            status += "  (wrapper not ported)"
        print(f"  {wrapper:45s} {blob:35s} {status}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m zaru_tpu_torch", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument(
            "--device", default="cuda",
            help="torch device to run on (default cuda; without a GPU it raises rather than use the CPU)",
        )

    p_track = sub.add_parser("track", help="run a pipeline over an offline input")
    p_track.add_argument("input", help="video / GIF / image / image directory")
    p_track.add_argument("--pipeline", default="face", choices=("face", "hand", "body"))
    p_track.add_argument("--iris", action="store_true", help="add iris refinement (face only)")
    p_track.add_argument("--slots", type=int, default=4, help="max hands (hand pipeline)")
    p_track.add_argument("--out", help="output JSONL path (default stdout)")
    p_track.add_argument("--annotate", help="directory for annotated JPEGs")
    p_track.add_argument("--max-frames", type=int, default=None)
    device_arg(p_track)
    p_track.set_defaults(fn=cmd_track)

    p_serve = sub.add_parser("serve", help="multi-stream serving loop (batch-gated cascade)")
    p_serve.add_argument("inputs", nargs="+", help="sources assigned to streams round-robin, each looped")
    p_serve.add_argument("--streams", type=int, default=8)
    p_serve.add_argument("--pipeline", default="face", choices=("face", "hand", "body"))
    p_serve.add_argument("--iris", action="store_true")
    p_serve.add_argument("--slots", type=int, default=4)
    p_serve.add_argument("--steps", type=int, default=100)
    p_serve.add_argument("--out", help="output JSONL path (default stdout)")
    p_serve.add_argument("--landmarks", action="store_true", help="include landmark arrays in the JSONL (large)")
    p_serve.add_argument("--report-every", type=int, default=10)
    p_serve.add_argument(
        "--shard", action="store_true",
        help="shard the streams over every visible GPU (with --device cpu, the one CPU device)",
    )
    p_serve.add_argument(
        "--no-loop", action="store_true",
        help="sources are finite: a stream whose source ends frees its slot and the next pending input "
        "joins (slot state reset); default loops every source forever",
    )
    p_serve.add_argument(
        "--soak", type=float, default=0.0, metavar="SECONDS",
        help="run for a wall-clock duration instead of --steps",
    )
    p_serve.add_argument(
        "--decode-wait", type=float, default=1000.0, metavar="MS",
        help="per-step decode deadline; a stream missing it re-serves its previous frame and counts a "
        "drop (default 1000 ms)",
    )
    p_serve.add_argument(
        "--batch-program", action="store_true",
        help="use the gated batch step even at --streams 1 (default: a single stream takes the "
        "tracker's run_frame)",
    )
    device_arg(p_serve)
    p_serve.set_defaults(fn=cmd_serve)

    p_export = sub.add_parser("export", help="save a tracker step as a torch.export artifact")
    p_export.add_argument("out", help="artifact output path")
    p_export.add_argument("--pipeline", default="face", choices=("face", "hand", "body"))
    p_export.add_argument("--iris", action="store_true")
    p_export.add_argument("--slots", type=int, default=4)
    p_export.add_argument(
        "--batch", type=int, default=0,
        help="export the batch-gated serving step for N streams (default 0 = single-stream step)",
    )
    p_export.add_argument("--height", type=int, default=1080)
    p_export.add_argument("--width", type=int, default=1920)
    p_export.add_argument("--verify", action="store_true", help="reload the artifact and run it once on zero frames")
    device_arg(p_export)
    p_export.set_defaults(fn=cmd_export)

    p_run = sub.add_parser("run-exported", help="run an exported step artifact over an offline input")
    p_run.add_argument("artifact", help="artifact from `export`")
    p_run.add_argument("input", help="video / GIF / image / image directory")
    p_run.add_argument("--state", help="init-state sidecar (default: ARTIFACT.state.npz)")
    p_run.add_argument("--out", help="output JSONL path (default stdout)")
    p_run.add_argument("--max-frames", type=int, default=None)
    p_run.set_defaults(fn=cmd_run_exported)

    p_info = sub.add_parser("info", help="runtime + model-asset inventory")
    p_info.set_defaults(fn=cmd_info)

    sub.add_parser("eval", add_help=False, help="equivariance accuracy sweep (zaru_tpu_torch.eval; args forwarded)")

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["eval"]:
        from .eval import main as eval_main

        return eval_main(argv[1:])
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
