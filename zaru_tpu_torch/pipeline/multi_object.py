"""Fixed-slot multi-object tracking, batch-gated
(zaru_tpu/pipeline/multi_object.py:25 ``MultiObjectTracker``).

Every stream has ``max_objects`` slots, each an ROI ``[5]`` and an active
flag, and a frame counter. One step over a batch of streams
(``step_batch``, multi_object.py:310):

- **Detect**, when some stream has no active slot, some stream's counter is
  due (``frame % detect_interval == 0``) or the caller forces it
  (``_detect_batch`` :130): the full-frame letterbox of every frame (the
  letterbox kernel), the detector CNN, SSD decode, weighted NMS with
  ``max_objects`` outputs, and candidate ROIs (``_candidate_rois`` :150).
  Streams that are lost or due then fill free slots with the candidates
  that overlap no active slot (``_assign`` :161); the other streams keep
  their slots.
- **Track**, every step (``_track_slots_batch`` :201): the aspect-fit view
  rect of every slot of every stream, rotated crops through the rotated-ROI
  kernel (on a prescale grid of side ``prescale_m``), the landmark CNN on
  one flat ``[B·S]`` batch, decode, landmarks back to the image and the next
  ROI from the rotated landmark bbox plus padding (``_track_slot_tail``
  :190).
- **Post** (``_post`` :270): a slot stays active while its confidence
  reaches ``presence_threshold``; newer slots overlapping an older active
  one are culled; outputs of inactive slots are zeroed.

The batch gate: in JAX the detect-or-keep choice is a device-side
``lax.cond`` (:382). Here it is a ``torch.cond`` (``_ops.choose``): detect
when some stream is lost or due or the caller forces it, else keep the
slots. Run eagerly it is one host read of one bool a step (none when the
caller forces detection); under ``torch.export`` both branches are in the
graph. With ``redetect_bucket=K`` a detect step where no interval is due
and nothing is forced detects only the first K lost streams (:348-370),
a second ``torch.cond`` (one more host read eagerly); due and forced steps
detect every stream, so no stream's periodic redetect is skipped.

With ``fast_sampler`` (on in both trackers; off in this base class, as in
JAX) the gated step samples its slot crops through the rotated-ROI kernel;
without it through the exact sampler (``Cnn.apply_on_view``, :231-248).
Of JAX's ``sampler_opts`` only ``prescale_m`` changes the function;
``band_p``, ``col_split``, ``square_views`` and ``rows_per_block`` choose
the TPU kernel's blocking and are not ported. ``angle_clamp`` clamps the
angle of a view the fast sampler takes, as in JAX.

The ungated entry points sample every crop with the exact sampler, as
JAX's ``step`` (:301) does:

- ``step``/``run_frame`` (:392): one stream, ``[H,W,4]`` frame, unbatched
  state; JAX's ``lax.cond`` (``_roi_phase`` :255) is one host read of the
  stream's detect flag, and detection samples exactly too (``_detect``
  :111), so the path runs no sampler kernel;
- ``run_frames`` (:395), JAX's ``vmap(step)``: every stream that is lost or
  due takes a detection, the others keep their slots; a step where some
  stream is lost or due detects every stream through the letterbox kernel
  (equal to the exact sampler at angle 0) and assigns where due.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..detection import nms_average_device
from ..geometry import rect_grow_rel, rect_iou
from ..ops.rotated_fast import PRESCALE_M
from . import _ops

__all__ = ["MultiObjectTracker"]


class MultiObjectTracker:
    """Fixed-slot multi-object tracker over a batch of streams.

    ``detector``: a detection network with ``cnn()`` and
    ``decode_device(outputs, thresh) -> (boxes, conf, keypoints, angles)``;
    ``landmarker``: a landmark network with ``cnn()`` and
    ``decode_device(outputs) -> (coords [N,K,3], confidence [N], *extras)``;
    ``residual_angle(xy_view [N,K,2]) -> [N]``: the object's rotation in the
    view, added to the view's angle; ``grow_by``: detection box → ROI
    growth; ``roi_padding``: relative padding of the landmark bbox.
    ``params``: optional ``{"det": {...}, "lm": {...}}`` ONNX-initializer
    dicts (see :func:`zaru_tpu_torch.weights.params_from_jax`).
    ``fast_sampler``: the gated step samples through the rotated-ROI kernel
    (on a prescale grid of side ``prescale_m``, the view angle clamped to
    ``angle_clamp``), else through the exact sampler.
    """

    def __init__(
        self,
        detector,
        landmarker,
        *,
        residual_angle,
        grow_by: float = 1.0,
        roi_padding: float = 0.3,
        max_objects: int = 4,
        detect_interval: int = 9,
        detection_threshold: float = 0.5,
        presence_threshold: float = 0.5,
        iou_thresh: float = 0.3,
        fast_sampler: bool = False,
        angle_clamp: float | None = None,
        prescale_m: int = PRESCALE_M,
        redetect_bucket: int | None = None,
        params: dict | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.detector = detector
        self.landmarker = landmarker
        self.det_cnn = detector.cnn()
        self.lm_cnn = landmarker.cnn()
        if params is not None:
            self.det_cnn.net.load_params(params["det"])
            self.lm_cnn.net.load_params(params["lm"])
        self.residual_angle = residual_angle
        self.grow_by = grow_by
        self.roi_padding = roi_padding
        self.max_objects = max_objects
        self.detect_interval = detect_interval
        self.detection_threshold = detection_threshold
        self.presence_threshold = presence_threshold
        self.iou_thresh = iou_thresh
        self.fast_sampler = fast_sampler
        self.angle_clamp = angle_clamp
        self.prescale_m = prescale_m
        self.redetect_bucket = redetect_bucket

    @property
    def params(self) -> dict:
        """``{"det": {name: tensor}, "lm": {name: tensor}}``, the networks'
        float initializers by ONNX name."""
        return {"det": self.det_cnn.net.params(), "lm": self.lm_cnn.net.params()}

    def init_state(self, batch: int | None = None) -> dict:
        """Fresh state, no active slot, frame 0: for ``batch`` streams, or
        left out, for one (:meth:`step`)."""
        s, dev, lead = self.max_objects, self.device, (batch,) if batch else ()
        return {
            "rois": torch.zeros(lead + (s, 5), dtype=torch.float32, device=dev),
            "active": torch.zeros(lead + (s,), dtype=torch.bool, device=dev),
            "frame": torch.zeros(lead, dtype=torch.int32, device=dev),
        }

    # --- detection and slot assignment ---------------------------------

    def _detect_batch(self, frames, exact: bool = False):
        """Letterbox (or, ``exact``, the exact sampler) + detector + decode +
        NMS for every stream → (candidate ROIs [B,S,5], valid [B,S])."""
        res = self.det_cnn.input_resolution()
        fit, fit_rrect = _ops.full_frame_fit(frames, res)
        rrects = fit_rrect.expand(frames.shape[0], 5).contiguous()
        if exact:
            outputs = self.det_cnn.apply_on_view(frames, rrects)
        else:
            outputs = self.det_cnn.apply_views_letterbox(frames, rrects)
        return self._detect_tail(outputs, fit, res)

    def _detect_tail(self, outputs, fit, res):
        boxes, conf, kps, angles = self.detector.decode_device(outputs, self.detection_threshold)
        valid, _conf, avg_box, avg_kps, avg_angle = nms_average_device(
            boxes, conf, kps, angles, iou_thresh=self.iou_thresh, max_out=self.max_objects
        )
        return self._candidate_rois(avg_box, avg_kps, avg_angle, fit, res), valid

    def _candidate_rois(self, avg_box, avg_kps, avg_angle, fit, res):
        """NMS'd boxes ``[B,S,4]`` → candidate ROIs ``[B,S,5]`` in image
        coords: the box grown by ``grow_by``, at the detection's angle."""
        rect = rect_grow_rel(_ops.unmap_center_size(avg_box, fit, res), self.grow_by)
        return torch.cat([rect, avg_angle[..., None]], dim=-1)

    def _assign(self, rois, active, cand_rois, cand_valid):
        """Candidates ``[B,S,5]`` (``valid [B,S]``) into the free slots of
        ``rois [B,S,5]`` / ``active [B,S]``, in candidate order, skipping any
        that overlaps an active slot. A fixed-length loop, no host read."""
        slots = torch.arange(self.max_objects, device=rois.device)
        for i in range(self.max_objects):
            cand = cand_rois[:, i]
            ious = rect_iou(cand[:, None, 0:4], rois[..., 0:4])  # [B,S]
            overlaps = (active & (ious >= self.iou_thresh)).any(-1)
            free = torch.argmin(active.to(torch.int32), dim=-1)  # first free slot, or 0
            have_free = ~torch.gather(active, 1, free[:, None])[:, 0]
            put = (cand_valid[:, i] & ~overlaps & have_free)[:, None] & (slots == free[:, None])
            rois = torch.where(put[..., None], cand[:, None, :], rois)
            active = active | put
        return rois, active

    def _detect_assign(self, state, frames, do, exact: bool = False):
        """Detection on ``frames [B',...]`` and assignment into the slots of
        ``state`` (already cut to those ``B'`` streams) where ``do [B']``."""
        cand_rois, cand_valid = self._detect_batch(frames, exact)
        rois, active = self._assign(state["rois"], state["active"], cand_rois, cand_valid)
        return (torch.where(do[:, None, None], rois, state["rois"]),
                torch.where(do[:, None], active, state["active"]))

    def _detect_bucket(self, state, frames, lost):
        """Detection for the first K lost streams only (K =
        ``redetect_bucket``): a stable sort brings the lost streams to the
        front, their K frames are detected as one batch, and the slots are
        scattered back."""
        k = min(int(self.redetect_bucket), lost.shape[0])
        idx = torch.sort((~lost).to(torch.uint8), stable=True).indices[:k]  # lost first
        sub = {key: state[key][idx] for key in ("rois", "active")}
        rois_k, active_k = self._detect_assign(sub, frames[idx], lost[idx])
        return state["rois"].index_copy(0, idx, rois_k), state["active"].index_copy(0, idx, active_k)

    # --- per-slot tracking -----------------------------------------------

    def _track_slots_batch(self, frames, rois, exact: bool = False):
        """Every slot of every stream in one landmark pass: ``frames
        [B,H,W,4]``, ``rois [B,S,5]`` → (new ROIs [B,S,5], confidence [B,S],
        extras (each [B,S,...]), positions [B,S,K,3]). The crops go through
        the rotated-ROI kernel, or ``exact`` the exact sampler (no angle
        clamp)."""
        res = self.lm_cnn.input_resolution()
        view_rects = _ops.aspect_view_rect(rois, res)
        b, s = view_rects.shape[:2]
        if exact:
            outputs = self.lm_cnn.apply_on_view(frames, view_rects)
        else:
            if self.angle_clamp is not None:
                theta = torch.clamp(view_rects[..., 4:5], -self.angle_clamp, self.angle_clamp)
                view_rects = torch.cat([view_rects[..., 0:4], theta], dim=-1)
            outputs = self.lm_cnn.apply_views_fast(frames, view_rects, prescale_m=self.prescale_m)
        new_rois, confidence, extras, pos = self._track_slot_tail(outputs, view_rects.reshape(b * s, 5))
        unflat = lambda t: t.reshape(b, s, *t.shape[1:])  # noqa: E731
        return unflat(new_rois), unflat(confidence), tuple(map(unflat, extras)), unflat(pos)

    def _track_slot_tail(self, outputs, view_rects):
        """Decode → landmarks to image → next ROI, for ``N`` flat views."""
        res = self.lm_cnn.input_resolution()
        coords, confidence, *extras = self.landmarker.decode_device(outputs)
        xy_view, pos = _ops.landmarks_to_image(coords, view_rects, res)
        # The sampled view's angle: with angle_clamp it may differ from the
        # ROI's, and the residual measured in the view recovers the object's.
        angle = view_rects[:, 4] + self.residual_angle(xy_view)
        new_roi = _ops.padded_roi(pos[..., 0:2], angle, self.roi_padding)
        return new_roi, confidence, tuple(extras), pos

    # --- the step ----------------------------------------------------------

    def _post(self, state, rois, active, new_rois, confidence, extras, pos):
        """Presence gating, culling of newer slots overlapping older ones,
        and the outputs (inactive slots zeroed)."""
        keep = active & (confidence >= self.presence_threshold)
        rois = torch.where(keep[..., None], new_rois, rois)
        s = self.max_objects
        ious = rect_iou(rois[:, :, None, 0:4], rois[:, None, :, 0:4])  # [B,S,S]
        older = torch.ones((s, s), dtype=torch.bool, device=rois.device).tril(-1)
        overlap_older = (older & (ious >= self.iou_thresh) & keep[:, None, :] & keep[:, :, None]).any(-1)
        keep = keep & ~overlap_older
        new_state = {"rois": rois, "active": keep, "frame": state["frame"] + 1}
        z = keep.to(torch.float32)
        out = {
            "landmarks": pos * z[..., None, None],
            "confidence": confidence * z,
            "rois": rois * z[..., None],
            "valid": keep,
        }
        for i, ex in enumerate(extras):
            out[f"extra{i}"] = ex * z.reshape(z.shape + (1,) * (ex.ndim - 2))
        return new_state, self._finalize_out(out)

    def _finalize_out(self, out: dict) -> dict:
        """Output renames of a configuration (the hand tracker's)."""
        return out

    @torch.inference_mode()
    def step_batch(self, state: dict, frames, force_detect=False):
        """One gated step for ``frames [B,H,W,4] u8`` on the tracker's device
        → ``(new_state, outputs)``; outputs hold ``landmarks [B,S,K,3]`` in
        image coords, ``confidence [B,S]``, ``rois [B,S,5]``, ``valid
        [B,S]`` and the landmarker's extras (see the module docstring).
        ``force_detect``: a bool, or a bool tensor as in JAX."""
        # The branches are plain functions of the operands, as torch.export
        # traces them (see pipeline/_ops.choose).
        def kept(rois, active, lost, due, frames):
            return rois.clone(), active.clone()

        def detect_all(rois, active, lost, due, frames):
            return self._detect_assign({"rois": rois, "active": active}, frames, lost | due)

        def detect_bucket(rois, active, lost, due, frames):
            return self._detect_bucket({"rois": rois, "active": active}, frames, lost)

        def detect(rois, active, lost, due, frames):
            if not self.redetect_bucket:
                return detect_all(rois, active, lost, due, frames)
            full = (due.any() | force_detect if isinstance(force_detect, torch.Tensor)
                    else force_detect or due.any())
            return _ops.choose(full, detect_all, detect_bucket, (rois, active, lost, due, frames))

        lost = ~state["active"].any(-1)
        due = state["frame"] % self.detect_interval == 0
        keep = (~(lost | due).any() & ~force_detect if isinstance(force_detect, torch.Tensor)
                else not force_detect and ~(lost | due).any())
        rois, active = _ops.choose(keep, kept, detect, (state["rois"], state["active"], lost, due, frames))
        new_rois, confidence, extras, pos = self._track_slots_batch(frames, rois, not self.fast_sampler)
        return self._post(state, rois, active, new_rois, confidence, extras, pos)

    def run_frames_gated(self, state: dict, frames):
        """The serving step: :meth:`step_batch` without forced detection."""
        return self.step_batch(state, frames)

    def _ungated(self, state, frames, exact_detect: bool):
        """JAX's ``step`` for every stream of ``frames [B,...]``: streams
        lost or due take a detection (:func:`_ops.choose` on "does any?"),
        every crop exact."""
        def detect(rois, active, do, frames):
            return self._detect_assign({"rois": rois, "active": active}, frames, do, exact_detect)

        def kept(rois, active, do, frames):
            return rois.clone(), active.clone()

        do = ~state["active"].any(-1) | (state["frame"] % self.detect_interval == 0)
        rois, active = _ops.choose(do.any(), detect, kept, (state["rois"], state["active"], do, frames))
        new_rois, confidence, extras, pos = self._track_slots_batch(frames, rois, exact=True)
        return self._post(state, rois, active, new_rois, confidence, extras, pos)

    @torch.inference_mode()
    def run_frames(self, state: dict, frames):
        """The ungated batch step, JAX's ``vmap(step)``: the same outputs as
        :meth:`step` for each stream of ``frames [B,H,W,4]``."""
        return self._ungated(state, frames, exact_detect=False)

    @torch.inference_mode()
    def step(self, state: dict, frame):
        """One frame ``[H,W,4] u8`` of one stream, state from
        ``init_state()`` → ``(new_state, outputs)``, the outputs of
        :meth:`step_batch` without the stream axis; every crop exact."""
        new_state, out = self._ungated({k: v[None] for k, v in state.items()}, frame[None], exact_detect=True)
        return {k: v[0] for k, v in new_state.items()}, {k: v[0] for k, v in out.items()}

    def run_frame(self, state: dict, frame):
        """The single-stream step, :meth:`step`."""
        return self.step(state, frame)
