"""Landmark estimation and ROI tracking on the host
(zaru_tpu/landmark.py).

:class:`Estimator` (landmark.py:165) runs a :class:`LandmarkNetwork` on one
image or view: the aspect-fit view → the network at batch 1
(``Cnn.estimate``, the exact sampler, on the network's device) → one host
read of the outputs → the network's ``extract`` (numpy) → an optional
filter in network coordinates → positions back in the input's coordinates.
:class:`LandmarkTracker` (:246) follows a rotated ROI from frame to frame
without detection: the next ROI is the rotated bounding box of the
landmarks plus padding, and tracking is lost below a confidence.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from .filters import FilterParams, TimedFilterAdapter
from .image import as_view
from .rect import Rect, RotatedRect, rrect_bounding, rrect_transform_out
from .timer import Timer

__all__ = [
    "Estimate",
    "Estimator",
    "Landmark",
    "LandmarkFilter",
    "LandmarkNetwork",
    "LandmarkTracker",
    "Landmarks",
    "TrackingResult",
]


class Landmark:
    """One landmark (landmark.py:34)."""

    def __init__(self, position, visibility=None, presence=None):
        self.pos = np.asarray(position, np.float32).reshape(3)
        self.visibility = visibility
        self.presence = presence

    def position(self) -> np.ndarray:
        return self.pos

    def x(self) -> float:
        return float(self.pos[0])

    def y(self) -> float:
        return float(self.pos[1])

    def z(self) -> float:
        return float(self.pos[2])


class Landmarks:
    """Landmark positions ``[N,3]`` and optional visibility and presence
    arrays (landmark.py:56)."""

    def __init__(self, length: int):
        self._positions = np.zeros((length, 3), np.float32)
        self._visibility: np.ndarray | None = None
        self._presence: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self._positions)

    def positions(self) -> np.ndarray:
        return self._positions

    def set_positions(self, arr) -> None:
        arr = np.array(arr, np.float32, copy=True)
        if arr.shape != self._positions.shape:
            raise ValueError(f"positions must be {self._positions.shape}, got {arr.shape}")
        self._positions = arr

    @property
    def visibility(self):
        return self._visibility

    @property
    def presence(self):
        return self._presence

    def set_visibility(self, arr) -> None:
        self._visibility = np.asarray(arr, np.float32).reshape(len(self))

    def set_presence(self, arr) -> None:
        self._presence = np.asarray(arr, np.float32).reshape(len(self))

    def get(self, index: int) -> Landmark:
        lm = Landmark(self._positions[index])
        if self._visibility is not None:
            lm.visibility = float(self._visibility[index])
        if self._presence is not None:
            lm.presence = float(self._presence[index])
        return lm

    def set(self, index: int, lm: Landmark) -> None:
        self._positions[index] = lm.pos
        if lm.visibility is not None:
            if self._visibility is None:
                self._visibility = np.zeros(len(self), np.float32)
            self._visibility[index] = lm.visibility
        if lm.presence is not None:
            if self._presence is None:
                self._presence = np.zeros(len(self), np.float32)
            self._presence[index] = lm.presence

    def iter(self):
        return (self.get(i) for i in range(len(self)))

    def average_position(self) -> np.ndarray:
        return self._positions.mean(axis=0)

    def map_positions(self, f) -> None:
        self._positions = np.stack([f(p) for p in self._positions]).astype(np.float32)


class LandmarkFilter:
    """One filter over all landmark positions, state ``[N,3]``
    (landmark.py:128); a time-based filter is given the wall-clock time
    between calls (:class:`~zaru_tpu_torch.filters.TimedFilterAdapter`)."""

    def __init__(self, params: FilterParams | None = None, num_landmarks: int = 0):
        if params is not None and params.time_based:
            params = TimedFilterAdapter(params)
        self._params = params
        self._state = params.init_state((num_landmarks, 3)) if params is not None else None

    def filter(self, landmarks: Landmarks) -> None:
        if self._params is None:
            return
        self._state, out = self._params.apply(self._state, landmarks.positions())
        landmarks.set_positions(np.asarray(out))


class Estimate(Protocol):
    """What a landmark network's ``init_estimate`` returns and ``extract``
    fills (landmark.py:143): its landmarks through ``landmarks_mut()``.
    An estimate may also have ``angle_radians() -> float | None``, which
    :class:`LandmarkTracker` reads to rotate the next ROI."""

    def landmarks_mut(self) -> Landmarks: ...


class LandmarkNetwork:
    """Base of the landmark networks (landmark.py:150): ``cnn()``,
    ``init_estimate()`` and ``extract(outputs, estimate)`` on the host
    outputs, positions in network-input pixels."""

    def cnn(self):
        raise NotImplementedError

    def init_estimate(self):
        raise NotImplementedError

    def extract(self, outputs, estimate) -> None:
        raise NotImplementedError


class Estimator:
    """The host landmark estimator (landmark.py:165)."""

    def __init__(self, network: LandmarkNetwork):
        self._network = network
        self._estimate = network.init_estimate()
        self._t_infer = Timer("infer")
        self._t_extract = Timer("extract")
        self._t_filter = Timer("filter")
        self._filter = LandmarkFilter()

    @property
    def network(self) -> LandmarkNetwork:
        return self._network

    def input_resolution(self):
        return self._network.cnn().input_resolution()

    def set_filter(self, filter: LandmarkFilter) -> None:
        """Applied after inference in network coordinates, so its tuning does
        not depend on the image size."""
        self._filter = filter

    def estimate(self, image):
        """Landmarks of an image or view, in its coordinates. The estimate
        object is reused by the next call."""
        view = as_view(image)
        cnn = self._network.cnn()
        input_res = cnn.input_resolution()
        rect = view.rect().grow_to_fit_aspect(input_res.aspect_ratio())
        fit_view = view.view(rect)
        with self._t_infer.measure():
            # The host read is the completion fence: it stays in the span.
            outputs = [o.cpu().numpy() for o in cnn.estimate(fit_view)]

        with self._t_extract.measure():
            self._network.extract(outputs, self._estimate)

        with self._t_filter.measure():
            self._filter.filter(self._estimate.landmarks_mut())

        scale = np.float32(rect.width()) / np.float32(input_res.width)
        lms = self._estimate.landmarks_mut()
        pos = lms.positions() * scale
        pos[:, 0] += np.float32(rect.x())
        pos[:, 1] += np.float32(rect.y())
        lms.set_positions(pos)
        return self._estimate

    def timers(self):
        return [self._t_infer, self._t_extract, self._t_filter]


DEFAULT_LOSS_THRESHOLD = 0.5
DEFAULT_ROI_PADDING = 0.3


class TrackingResult:
    """One tracking step's view rect, estimate and new ROI
    (landmark.py:226)."""

    def __init__(self, view_rect: RotatedRect, estimate, updated_roi: RotatedRect):
        self._view_rect = view_rect
        self._estimate = estimate
        self._updated_roi = updated_roi

    def view_rect(self) -> RotatedRect:
        return self._view_rect

    def estimate(self):
        return self._estimate

    def updated_roi(self) -> RotatedRect:
        return self._updated_roi


class LandmarkTracker:
    """Detection-free ROI tracking across frames (landmark.py:246).

    Seed it with :meth:`set_roi`; each :meth:`track` estimates landmarks in
    the aspect-grown rotated ROI, drops tracking below the loss threshold,
    and takes the rotated bounding box of the landmarks plus padding as the
    next ROI.
    """

    def __init__(self, estimator: Estimator):
        self._estimator = estimator
        self._aspect = estimator.input_resolution().aspect_ratio()
        self._roi: RotatedRect | None = None
        self._loss_thresh = DEFAULT_LOSS_THRESHOLD
        self._roi_padding = DEFAULT_ROI_PADDING

    def estimator(self) -> Estimator:
        return self._estimator

    def timers(self):
        return self._estimator.timers()

    def set_loss_threshold(self, threshold: float) -> None:
        self._loss_thresh = threshold

    def set_roi_padding(self, padding: float) -> None:
        if not padding >= 0.0:
            raise ValueError(f"ROI padding must be >= 0, got {padding}")
        self._roi_padding = padding

    def roi(self) -> RotatedRect | None:
        return self._roi

    def set_roi(self, roi) -> None:
        if isinstance(roi, Rect):
            roi = RotatedRect.from_rect(roi)
        self._roi = roi

    def track(self, full_image) -> TrackingResult | None:
        """One step; None when not tracking or when tracking was lost in
        this frame."""
        if self._roi is None:
            return None
        roi = self._roi
        view_rect = roi.map(lambda r: r.grow_to_fit_aspect(self._aspect))
        view = as_view(full_image).view(view_rect)
        estimate = self._estimator.estimate(view)

        if estimate.confidence() < self._loss_thresh:
            self._roi = None
            return None

        angle_est = getattr(estimate, "angle_radians", lambda: None)()
        angle = roi.rotation_radians() + (angle_est if angle_est is not None else 0.0)

        lms = estimate.landmarks_mut()
        pos = lms.positions()
        out_xy = rrect_transform_out(view_rect.array.astype(np.float32), pos[:, 0:2].astype(np.float32))
        pos = np.concatenate([out_xy, pos[:, 2:3]], axis=-1)
        lms.set_positions(pos)

        updated_roi = RotatedRect(rrect_bounding(np.float32(angle), pos[:, 0:2]))
        self._roi = updated_roi.grow_rel(self._roi_padding)
        return TrackingResult(view_rect, estimate, updated_roi)
