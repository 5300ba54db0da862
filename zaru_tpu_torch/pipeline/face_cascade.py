"""Face detect → crop → landmark → smooth cascade
(zaru_tpu/pipeline/face_cascade.py:62 ``FaceTracker``).

One step over a batch of streams (``step_batch``, face_cascade.py:452):

- **Detect**, only when some stream is lost or the caller forces it
  (``_detect_batch`` :197): letterbox every frame to the detector's input
  (128×128 short-range, 192×192 full-range; the letterbox kernel), BlazeFace,
  SSD decode, weighted NMS with one output → seed ROI.
- **Track**, every step (``_track_batch`` :250, ``_track_tail`` :285):
  aspect-fit view rect, rotated crop at the landmarker's input (192×192
  Face Mesh V1, 256×256 V2; the rotated-ROI kernel, or with
  ``fast_sampler=False`` the exact sampler), Face Mesh, decode, 1€
  smoothing in network coordinates, landmarks back to the image, next ROI
  from the rotated landmark bbox plus padding.
- **Iris**, every step with ``iris=True`` (``_iris_batch`` :394): two eye
  rects from the landmarks, rotated 64×64 crops on a 256-pixel prescale
  grid, right eyes mirrored, the iris network on the ``2B`` crops, 76
  landmarks per eye back in the image (``eyes [B,2,76,3]``).

The default CNNs' BlazeBlock chains run through the stage kernel
(``onnx/executor.py``); the iris network's, full-range BlazeFace's and Face
Mesh V2's blocks are bottlenecks and run op by op.

The batch gate: in JAX the detect-or-keep choice is a device-side
``lax.cond`` (face_cascade.py:509). Here it is a ``torch.cond``
(``_ops.choose``) over the same branches (``_kept``, ``_detect_lost``,
``_detect_bucket``): eagerly one host read of one bool per step (``all
streams tracking and not forced``), which waits for the previous step's
tracking flags, then that branch; under ``torch.export`` both branches in
the graph. Capturing the two branches as CUDA graphs is left for later.
With ``redetect_bucket=K`` an unforced detect step detects only the first K
lost streams (``_detect_bucket`` :216).

Spans and counters (:mod:`zaru_tpu_torch.profiling`, free while no profiler
runs): every entry point is a ``zaru.step`` span; inside it ``zaru.detect``
(the whole branch, ``.sample``, ``.net``, ``.tail`` within),
``zaru.track.sample``, ``.net``, ``.tail`` and, with ``iris``,
``zaru.iris.sample`` (eye rects and crops), ``.net`` and ``.tail`` (flips,
decode, unmap), whose crops ``counters["eye_crops"]`` counts. Each host
sync is a ``zaru.sync.<site>`` span counted in ``host_syncs``: the gate's read
(``gate``, each step that is not forced), the letterbox fit's copy
(``frame_fit``, each detect step), and on the exact sampler's paths its
channel shifts (``sampler_shifts``, each call), its mirror flags
(``sampler_mirror``) and the iris flips (``iris_flip``).

The ungated entry points sample every crop with the exact sampler
(``Cnn.apply_on_view``), as JAX's ``step`` does:

- ``step``/``run_frame`` (:420, :517): one stream, ``[H,W,4]`` frame,
  unbatched state. JAX's ``lax.cond`` on the stream's tracking flag is the
  same ``torch.cond`` (one host read when run eagerly); detection runs the
  exact sampler too, so the path runs the stage kernel at batch 1 and no
  sampler kernel. With ``iris`` the eye
  crops are exact as well (``_iris_single`` :381);
- ``run_frames`` (:521), JAX's ``vmap(step)``: each stream detects exactly
  when it is lost and keeps its tracked ROI otherwise. Detection runs for
  every stream when some stream is lost and is selected per stream (XLA's
  both-branches select), through the letterbox kernel, which equals the
  exact sampler at angle 0 (:198-202);
- ``scan_video`` (:531): ``step`` over ``[T,H,W,4]`` frames, outputs stacked
  on a leading T axis like ``lax.scan``.

``compute_dtype=torch.bfloat16`` runs the default detector's and
landmarker's bodies in bf16 (the iris network stays f32, as in JAX): the
same entry points and sampler kernels, f32 crops cast on the networks'
entry, no stage kernel (``onnx/executor.py``).

Not ported: ``sampler_opts`` (the TPU sampler's blocking; the face tracker
sets no ``prescale_m``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..detection import nms_average_device
from ..face.detection import ShortRangeNetwork
from ..face.eye import EyeLandmarks, EyeNetwork
from ..face.landmark.mediapipe import FaceMeshV1, LandmarkIdx
from ..filters import OneEuroFilter
from ..geometry import rect_grow_rel, rrect_bounding, signed_angle_to_x
from ..profiling import counters, span, sync
from . import _ops

__all__ = ["FaceTracker"]


class FaceTracker:
    """Face tracking cascade on ``device`` (``cuda`` unless named).

    ``detector``/``landmarker``: the networks (``ShortRangeNetwork`` and
    ``FaceMeshV1`` unless given; ``FullRangeNetwork``, ``FaceMeshV2``), on
    the tracker's device. ``params``: optional ``{"det": {...}, "lm":
    {...}[, "eye": {...}]}`` ONNX-initializer dicts (see
    :func:`zaru_tpu_torch.weights.params_from_jax`) replacing the weights
    loaded from the ONNX files. ``fast_sampler``: the batch-gated step
    samples its landmark crops through the rotated-ROI kernel (else the
    exact sampler). ``iris``: also refine both eyes every step.
    ``redetect_bucket``: detect at most this many lost streams on an
    unforced detect step of :meth:`step_batch`. ``compute_dtype``:
    ``torch.bfloat16`` runs the default networks' bodies in bf16 (None:
    f32).
    """

    EYE_PRESCALE_M = 256  # the eye crops' prescale grid (face_cascade.py:397-402)

    def __init__(
        self,
        detector=None,
        landmarker=None,
        *,
        detection_threshold: float = 0.5,
        loss_threshold: float = 0.5,
        roi_padding: float = 0.3,
        smooth: OneEuroFilter | None = OneEuroFilter(min_cutoff=1.0, beta=0.5),
        frame_rate: float = 30.0,
        compute_dtype=None,
        fast_sampler: bool = True,
        iris: bool = False,
        redetect_bucket: int | None = None,
        params: dict | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.detector = detector or ShortRangeNetwork(compute_dtype, device=self.device)
        self.landmarker = landmarker or FaceMeshV1(compute_dtype, device=self.device)
        self.det_cnn = self.detector.cnn()
        self.lm_cnn = self.landmarker.cnn()
        self.iris = iris
        if iris:
            self.eye_cnn = EyeNetwork(device=self.device).cnn()
        if params is not None:
            self.det_cnn.net.load_params(params["det"])
            self.lm_cnn.net.load_params(params["lm"])
            if iris and "eye" in params:
                self.eye_cnn.net.load_params(params["eye"])
        self.fast_sampler = fast_sampler
        self.redetect_bucket = redetect_bucket
        self.detection_threshold = detection_threshold
        self.loss_threshold = loss_threshold
        self.roi_padding = roi_padding
        self.smooth = smooth
        self.elapsed = 1.0 / frame_rate
        self.num_landmarks = self.landmarker.NUM_LANDMARKS

    def init_state(self, batch: int | None = None) -> dict:
        """Fresh (not tracking) state; ``batch`` gives it a leading stream
        axis (left out: one stream, for :meth:`step`)."""
        dev, lead = self.device, (batch,) if batch else ()
        filt = (
            self.smooth.init_state(lead + (self.num_landmarks, 3), dev) if self.smooth else {}
        )
        return {
            "roi": torch.zeros(lead + (5,), dtype=torch.float32, device=dev),
            "tracking": torch.zeros(lead, dtype=torch.bool, device=dev),
            "filter": filt,
        }

    def _detect_batch(self, frames, exact: bool = False):
        """Letterbox (or, ``exact``, the exact sampler) + BlazeFace + decode
        + NMS for every stream → (rois [B,5], founds [B]); the spans
        ``zaru.detect.sample``, ``.net`` and ``.tail``."""
        res = self.det_cnn.input_resolution()
        fit, fit_rrect = _ops.full_frame_fit(frames, res)
        rrects = fit_rrect.expand(frames.shape[0], 5).contiguous()
        with span("zaru.detect.sample"):
            if exact:
                xs = self.det_cnn.sample_on_view(frames, rrects)
            else:
                xs = self.det_cnn.sample_views_letterbox(frames, rrects, self.det_cnn.layout)
        with span("zaru.detect.net"):
            outputs = self.det_cnn.apply_samples(xs)
        with span("zaru.detect.tail"):
            return self._detect_tail(outputs, fit, res)

    def _detect_tail(self, outputs, fit, res):
        """The detector's outputs for ``B`` frames → SSD decode, weighted NMS
        with one output, the box back in the image through the letterbox
        ``fit`` (:186) → (rois [B,5], founds [B])."""
        boxes, conf, kps, angles = self.detector.decode_device(outputs, self.detection_threshold)
        valid, _conf, avg_box, _kp, _angle = nms_average_device(boxes, conf, kps, angles, max_out=1)
        rect = _ops.unmap_center_size(avg_box[:, 0], fit, res)
        rois = torch.cat([rect, torch.zeros_like(rect[:, :1])], dim=-1)
        return rois, valid[:, 0]

    def _detect_lost(self, roi, tr, frames, exact: bool = False):
        """Detection for every stream; lost streams take its ROI, tracked
        streams keep theirs (``roi [B,5]``, ``tr [B]``) → (rois [B,5],
        founds [B], seeded [B]). The span ``zaru.detect``."""
        counters["detect_steps"] += 1
        with span("zaru.detect"):
            det_rois, det_founds = self._detect_batch(frames, exact)
            return torch.where(tr[:, None], roi, det_rois), tr | det_founds, ~tr

    def _detect_bucket(self, roi, tr, frames):
        """Detection for the first K lost streams only (K =
        ``redetect_bucket``): a stable sort on the tracking flags brings the
        lost streams to the front, their K frames are detected as one batch,
        and the results are scattered back; tracked streams keep their ROIs.
        → (rois [B,5], founds [B], seeded [B]). The span ``zaru.detect``."""
        counters["detect_steps"] += 1
        with span("zaru.detect"):
            k = min(int(self.redetect_bucket), tr.shape[0])
            idx = torch.sort(tr.to(torch.uint8), stable=True).indices[:k]  # lost first
            sel = ~tr[idx]  # bucket slots that really are lost
            rois_k, found_k = self._detect_batch(frames[idx])
            apply = sel & found_k
            rois = roi.index_copy(0, idx, torch.where(apply[:, None], rois_k, roi[idx]))
            founds = tr.index_copy(0, idx, tr[idx] | apply)
            seeded = torch.zeros_like(tr).index_copy(0, idx, sel)
            return rois, founds, seeded

    def _track_batch(self, state, frames, rois, founds, seeded, exact: bool, eyes_exact: bool):
        """Crops (the rotated-ROI kernel, or ``exact`` the exact sampler) +
        Face Mesh for every stream, then the tail; streams not ``founds``
        come out lost. With ``iris`` the eyes, their crops exact when
        ``eyes_exact``. The spans ``zaru.track.sample``, ``.net`` and
        ``.tail``."""
        with span("zaru.track.sample"):
            view_rects = _ops.aspect_view_rect(rois, self.lm_cnn.input_resolution())
            if exact:
                xs = self.lm_cnn.sample_on_view(frames, view_rects)
            else:
                xs = self.lm_cnn.sample_views_fast(frames, view_rects, layout=self.lm_cnn.layout)
        with span("zaru.track.net"):
            outputs = self.lm_cnn.apply_samples(xs)
        with span("zaru.track.tail"):
            new_state, out = self._track_tail(state, outputs, view_rects, seeded)
            new_state["tracking"] = new_state["tracking"] & founds
            out["valid"] = out["valid"] & founds
        if self.iris:
            out["eyes"] = self._iris_batch(frames, out["landmarks"], eyes_exact)
        return new_state, out

    def _track_tail(self, state, outputs, view_rects, seeded):
        """Decode → smooth → unmap → ROI update, batched."""
        res = self.lm_cnn.input_resolution()
        coords, conf, *_extras = self.landmarker.decode_device(outputs)  # V2: tongue dropped
        coords = coords[:, : self.num_landmarks]
        fstate = state["filter"]
        if self.smooth:
            # Freshly seeded streams restart their filter.
            fstate = {
                k: torch.where(seeded.reshape(-1, 1, 1), torch.zeros_like(s), s)
                for k, s in fstate.items()
            }
            fstate, coords = self.smooth.apply(fstate, coords, self.elapsed)
        xy_view, pos = _ops.landmarks_to_image(coords, view_rects, res)
        ltr = (
            xy_view[:, LandmarkIdx.RIGHT_EYE_OUTER_CORNER]
            - xy_view[:, LandmarkIdx.LEFT_EYE_OUTER_CORNER]
        )
        angle = view_rects[:, 4] + signed_angle_to_x(ltr)
        new_roi = _ops.padded_roi(pos[..., 0:2], angle, self.roi_padding)
        tracking = conf >= self.loss_threshold
        new_state = {"roi": new_roi, "tracking": tracking, "filter": fstate}
        out = {"landmarks": pos, "confidence": conf, "roi": new_roi, "valid": tracking}
        return new_state, out

    # Iris refinement (face_cascade.py:337-418).
    _LEFT_EYE = [
        LandmarkIdx.LEFT_EYE_BOTTOM, LandmarkIdx.LEFT_EYE_OUTER_CORNER,
        LandmarkIdx.LEFT_EYE_INNER_CORNER, LandmarkIdx.LEFT_EYE_TOP,
    ]
    _RIGHT_EYE = [
        LandmarkIdx.RIGHT_EYE_BOTTOM, LandmarkIdx.RIGHT_EYE_INNER_CORNER,
        LandmarkIdx.RIGHT_EYE_OUTER_CORNER, LandmarkIdx.RIGHT_EYE_TOP,
    ]
    EYE_GROW = 0.8

    def _eye_view_rects(self, pos):
        """Landmarks ``[B,N,3]`` in image coords (the first 468 the mesh)
        → aspect-fit eye view rects ``[B,2,5]``, left eye first (:351)."""
        res = self.eye_cnn.input_resolution()
        angle = signed_angle_to_x(
            pos[:, LandmarkIdx.RIGHT_EYE_OUTER_CORNER, :2]
            - pos[:, LandmarkIdx.LEFT_EYE_OUTER_CORNER, :2]
        )

        def one(idx):
            r = rrect_bounding(angle, pos[:, idx, :2])
            r = torch.cat([rect_grow_rel(r[:, 0:4], self.EYE_GROW), r[:, 4:5]], dim=-1)
            return _ops.aspect_view_rect(r, res)

        return torch.stack([one(self._LEFT_EYE), one(self._RIGHT_EYE)], dim=1)

    def _iris_decode(self, outputs, view_rects, flip):
        """``(eye [N,...,213], iris [N,...,15])`` → ``[N,76,3]`` image-coord
        landmarks, iris centre first (:369); ``flip [N]`` un-mirrors right
        eyes."""
        res = self.eye_cnn.input_resolution()
        n = view_rects.shape[0]
        coords = torch.cat([outputs[1].reshape(n, 5, 3), outputs[0].reshape(n, 71, 3)], dim=1)
        x = torch.where(flip[:, None], float(np.float32(res.width)) - coords[..., 0], coords[..., 0])
        coords = torch.cat([x[..., None], coords[..., 1:]], dim=-1)
        _xy_view, pos = _ops.landmarks_to_image(coords, view_rects, res)
        return pos

    _MIRROR = (False, True)  # right eyes go through the network mirrored

    def _eye_samples(self, frames, rects, exact: bool = False):
        """Eye view rects ``[B,2,5]`` → the eye crops in the iris network's
        layout, through the rotated-ROI kernel on the 256-pixel grid
        (``_iris_batch`` :394) or, ``exact``, the exact sampler
        (``_iris_single`` :381), right eyes mirrored by the sampler."""
        if exact:
            return self.eye_cnn.sample_on_view(frames, rects, mirror=self._MIRROR)
        return self.eye_cnn.sample_views_fast(frames, rects, self.EYE_PRESCALE_M, self.eye_cnn.layout, self._MIRROR)

    def _iris_batch(self, frames, pos, exact: bool = False):
        """Both eyes of every stream → ``[B,2,76,3]`` (:394; ``exact``
        :381): the eye rects from the landmarks and the crops (the span
        ``zaru.iris.sample``), then :meth:`_iris_run`."""
        with span("zaru.iris.sample"):
            rects = self._eye_view_rects(pos)
            xs = self._eye_samples(frames, rects, exact)
        return self._iris_run(xs, rects)

    def _iris_views(self, frames, rects, exact: bool = False):
        """Eye view rects ``[B,2,5]`` → ``[B,2,76,3]``: the crops of the
        given rects (``zaru.iris.sample``), then :meth:`_iris_run`."""
        with span("zaru.iris.sample"):
            xs = self._eye_samples(frames, rects, exact)
        return self._iris_run(xs, rects)

    def _iris_run(self, xs, rects):
        """The iris network on the ``2B`` eye crops (``zaru.iris.net``),
        then the flips, decode and unmap (``zaru.iris.tail``), ``[B,2]``
        flattened to ``[2B]`` around the network; counted in
        ``counters["eye_crops"]``."""
        b = rects.shape[0]
        counters["eye_crops"] += 2 * b
        with span("zaru.iris.net"):
            outputs = self.eye_cnn.apply_samples(xs)
        with span("zaru.iris.tail"):
            with sync("zaru.sync.iris_flip"):
                flips = torch.tensor(self._MIRROR, device=rects.device)
            flips = flips.repeat(b)
            eyes = self._iris_decode(outputs, rects.reshape(2 * b, 5), flips)
            return eyes.reshape(b, 2, EyeLandmarks.NUM_LANDMARKS, 3)

    @staticmethod
    def _kept(roi, tr, frames):
        """ROI sources of a step that detects nothing: the carried ROIs
        (a copy: a ``torch.cond`` branch returns no operand)."""
        return roi.clone(), torch.ones_like(tr), torch.zeros_like(tr)

    @torch.inference_mode()
    def step_batch(self, state: dict, frames, force_detect=False):
        """One gated step for ``frames [B,H,W,4] u8`` on the tracker's device
        → ``(new_state, outputs)``; outputs hold ``landmarks [B,N,3]`` in
        image coords (``N`` the landmarker's), ``confidence [B]``, ``roi
        [B,5]``, ``valid [B]`` and, with ``iris``, ``eyes [B,2,76,3]``.

        Detection runs for every stream when some stream is lost or
        ``force_detect`` (a bool, or a bool tensor as in JAX) is set (the
        redetect cadence); tracked streams keep their carried ROIs either
        way. With ``redetect_bucket``, a detect step that is not forced
        detects only the first K lost streams. The eye crops always go
        through the rotated-ROI kernel, as JAX's batch step samples them
        whatever ``fast_sampler`` says. The detect-or-keep choice (and the
        bucket's) is :func:`_ops.choose`, so ``torch.export`` captures both
        branches."""
        # The branches are plain functions of exactly the operands (no bound
        # method, no default argument): torch.export traces them so.
        def detect_all(roi, tr, frames):
            return self._detect_lost(roi, tr, frames)

        def detect_bucket(roi, tr, frames):
            return self._detect_bucket(roi, tr, frames)

        def detect(roi, tr, frames):
            if not self.redetect_bucket:
                return detect_all(roi, tr, frames)
            return _ops.choose(force_detect, detect_all, detect_bucket, (roi, tr, frames))

        counters["steps"] += 1
        with span("zaru.step"):
            tr = state["tracking"]
            keep = (tr.all() & ~force_detect if isinstance(force_detect, torch.Tensor)
                    else not force_detect and tr.all())
            sources = _ops.choose(keep, self._kept, detect, (state["roi"], tr, frames))
            return self._track_batch(state, frames, *sources, exact=not self.fast_sampler, eyes_exact=False)

    def run_frames_gated(self, state: dict, frames):
        """The serving step: :meth:`step_batch` without forced detection."""
        return self.step_batch(state, frames)

    def _ungated(self, state, frames, exact_detect: bool):
        """JAX's ``step`` for every stream of ``frames [B,...]``: lost streams
        take a detection (:func:`_ops.choose` on "is every stream
        tracking?"), every crop exact."""
        def detect(roi, tr, frames):
            return self._detect_lost(roi, tr, frames, exact_detect)

        tr = state["tracking"]
        sources = _ops.choose(tr.all(), self._kept, detect, (state["roi"], tr, frames))
        return self._track_batch(state, frames, *sources, exact=True, eyes_exact=True)

    @torch.inference_mode()
    def run_frames(self, state: dict, frames):
        """The ungated batch step, JAX's ``vmap(step)``: the same outputs as
        :meth:`step` for each stream of ``frames [B,H,W,4]``. Every crop is
        exact; a step with a lost stream detects every stream (letterbox
        kernel) and only lost streams take the detection."""
        counters["steps"] += 1
        with span("zaru.step"):
            return self._ungated(state, frames, exact_detect=False)

    @torch.inference_mode()
    def step(self, state: dict, frame):
        """One frame ``[H,W,4] u8`` of one stream, state from
        ``init_state()`` → ``(new_state, outputs)``, the outputs of
        :meth:`step_batch` without the stream axis. Detects when the stream
        is lost (one host read of its flag), every crop exact."""
        counters["steps"] += 1
        with span("zaru.step"):
            new_state, out = self._ungated(_map_state(lambda t: t[None], state), frame[None], exact_detect=True)
            return _map_state(lambda t: t[0], new_state), {k: v[0] for k, v in out.items()}

    def run_frame(self, state: dict, frame):
        """The single-stream step, :meth:`step`."""
        return self.step(state, frame)

    def scan_video(self, state: dict, frames):
        """:meth:`step` over ``frames [T,H,W,4]`` of one stream → (the final
        state, outputs stacked on a leading ``T`` axis), like JAX's
        ``lax.scan``."""
        outs = []
        for frame in frames:
            state, out = self.step(state, frame)
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _map_state(fn, state: dict) -> dict:
    """``fn`` on every tensor of a tracker state (the filter's included)."""
    return {k: _map_state(fn, v) if isinstance(v, dict) else fn(v) for k, v in state.items()}
