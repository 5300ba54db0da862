"""Several hands: detection and tracking on the host
(zaru_tpu/hand/tracking.py).

Synchronous, returning the current frame's results, with the reference's
scheduling:

- palm detection runs when no hand is tracked or the redetect interval has
  passed;
- a detection is dropped when its palm box, grown 1.5× to hand size,
  overlaps a live ROI (IoU);
- of two overlapping trackers the newer is culled;
- trackers pad their ROIs by 0.4, since the default loses closed hands.

Each hand is a :class:`~zaru_tpu_torch.landmark.LandmarkTracker` over its
own :class:`~zaru_tpu_torch.landmark.Estimator`; the estimators share one
landmark network unless ``landmarker_factory`` makes one per hand.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable

from .._device import resolve_device
from ..detection import Detector
from ..landmark import Estimator, LandmarkTracker
from ..rect import RotatedRect
from . import detection as palm_detection
from . import landmark as hand_landmark

__all__ = ["HandData", "HandId", "HandTracker"]

ROI_PADDING = 0.4
DEFAULT_IOU_THRESH = 0.3
DEFAULT_REDETECT_INTERVAL = 0.3  # seconds
PALM_TO_HAND = 1.5


@dataclass(frozen=True)
class HandId:
    """A hand's ID, stable while it stays tracked."""

    value: int


@dataclass
class HandData:
    """One tracked hand's result."""

    id: HandId
    landmark_result: hand_landmark.LandmarkResult
    view_rect: RotatedRect


class _TrackedHand:
    def __init__(self, hand_id: HandId, tracker: LandmarkTracker):
        self.id = hand_id
        self.tracker = tracker
        self.lm: hand_landmark.LandmarkResult | None = None
        self.view_rect: RotatedRect | None = None


class HandTracker:
    """Hand detector, trackers and landmarker in one (tracking.py:66), on
    ``device`` (``cuda`` unless named)."""

    def __init__(
        self,
        detector: palm_detection.LiteNetwork | None = None,
        landmarker_factory: Callable[[], hand_landmark.LiteNetwork] | None = None,
        clock=time.monotonic,
        device=None,
    ):
        if detector is None or landmarker_factory is None:
            device = resolve_device(device)
        self._detector = Detector(detector or palm_detection.LiteNetwork(device=device))
        if landmarker_factory is None:
            shared = hand_landmark.LiteNetwork(device=device)
            landmarker_factory = lambda: shared  # noqa: E731
        self._make_network = landmarker_factory
        self._hands: list[_TrackedHand] = []
        self._next_id = 0
        self._clock = clock
        self._next_det = clock()
        self.det_interval = DEFAULT_REDETECT_INTERVAL
        self.iou_thresh = DEFAULT_IOU_THRESH

    def set_redetect_interval(self, seconds: float) -> None:
        self.det_interval = seconds

    def set_iou_thresh(self, thresh: float) -> None:
        self.iou_thresh = thresh

    def hands(self) -> list[HandData]:
        return [HandData(h.id, h.lm, h.view_rect) for h in self._hands if h.lm is not None]

    def _advance(self, hand: _TrackedHand, image) -> bool:
        """One tracking step of ``hand``; False when it lost tracking. The
        result is copied out: the estimator reuses its estimate."""
        result = hand.tracker.track(image)
        if result is None:
            return False
        hand.lm = copy.deepcopy(result.estimate())
        hand.view_rect = result.view_rect()
        return True

    def track(self, image) -> None:
        """Advances tracking by one frame; the results are :meth:`hands`."""
        # 1. Advance every live tracker; drop those that lost tracking.
        self._hands = [h for h in self._hands if self._advance(h, image)]

        # 2. Detection when no hand is tracked or the interval has passed.
        detections = []
        now = self._clock()
        if not self._hands or now >= self._next_det:
            detections = list(self._detector.detect(image))
            self._next_det = now + self.det_interval

        # 3. Drop detections whose hand box overlaps a live ROI; track the
        #    others from this frame on.
        for det in detections:
            hand_rect = det.bounding_rect().grow_rel(PALM_TO_HAND)
            if any(
                h.tracker.roi() is not None and h.tracker.roi().rect().iou(hand_rect) >= self.iou_thresh
                for h in self._hands
            ):
                continue
            tracker = LandmarkTracker(Estimator(self._make_network()))
            tracker.set_roi_padding(ROI_PADDING)
            tracker.set_roi(RotatedRect.new(hand_rect, det.angle()))
            hand = _TrackedHand(HandId(self._next_id), tracker)
            self._next_id += 1
            if self._advance(hand, image):
                self._hands.append(hand)

        # 4. Cull overlapping trackers, newest first (IoU of the unrotated
        #    rects, as in the reference).
        i = len(self._hands) - 1
        while i > 0:
            roi_i = self._hands[i].tracker.roi()
            if roi_i is not None:
                for j in range(i):
                    roi_j = self._hands[j].tracker.roi()
                    if roi_j is not None and roi_i.rect().iou(roi_j.rect()) >= self.iou_thresh:
                        self._hands.pop(i)
                        break
            i -= 1
