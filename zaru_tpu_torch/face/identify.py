"""Face identification: detection + embedding + gallery matching on the
device, the port of zaru_tpu/face/identify.py.

Two tiers:

- :class:`FaceIdentifier`: host-loop enrollment and 1:N identification on
  single images (detection → crop → embed → match). The detector and the
  embedder sample with the exact sampler at batch 1; the detector's
  BlazeBlock chains run through the stage kernel.
- :class:`StreamIdentifier`: batched serving on a
  :class:`~zaru_tpu_torch.pipeline.FaceTracker`'s gated step (the
  letterbox, rotated-ROI and stage kernels), plus in the same step one
  112×112 crop a stream through one more call of the rotated-ROI kernel,
  written in the planar layout MobileFaceNet reads, one batched
  MobileFaceNet pass and the gallery distances and argmin. It runs eagerly,
  as the port's ``FaceTracker`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..detection import Detector
from ..geometry import rect_grow_rel, rect_grow_to_fit_aspect, rotate_ccw, rrect_bounding
from ..image import as_view
from .detection import ShortRangeNetwork
from .recognition import Embedder

__all__ = ["FaceIdentifier", "Match", "StreamIdentifier"]


@dataclass(frozen=True)
class Match:
    name: str
    distance: float


def _distances(gallery, queries):
    """``gallery [G,128]``, ``queries [...,128]`` → ``[...,G]`` L2 distances,
    ``sqrt(sum((g - q)²))`` (identify.py:43-46). Not ``torch.cdist``, whose
    matrix-product form for larger sizes rounds otherwise."""
    diff = gallery - queries[..., None, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def _normalized(emb):
    """Rows over their L2 norm, the norm kept from 0 (identify.py:146-147)."""
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)


class FaceIdentifier:
    """Enroll faces by name, then identify faces in new images, on
    ``device`` (``cuda`` unless named; ``detector`` and ``embedder`` must
    be on it).

    Embeddings are L2-normalized before matching, so ``threshold`` is a
    distance on the unit sphere: same-person pairs typically land below
    ~0.9, different people above ~1.2.
    """

    def __init__(self, threshold: float = 1.0, detector=None, embedder=None, device=None):
        self.device = resolve_device(device)
        self.threshold = threshold
        self._detector = detector or Detector(ShortRangeNetwork(device=self.device))
        self._embedder = embedder or Embedder(self.device)
        self._names: list[str] = []
        self._gallery: torch.Tensor | None = None  # [G, 128] on the device

    def _embed_face(self, image) -> np.ndarray | None:
        dets = list(self._detector.detect(image))
        if not dets:
            return None
        best = max(dets, key=lambda d: d.confidence())
        crop = best.bounding_rect().grow_rel(0.2)
        emb = self._embedder.embed(as_view(image).view(crop))
        return emb / np.linalg.norm(emb)

    def enroll(self, name: str, image) -> bool:
        """Adds the most confident face in ``image`` under ``name``.
        Returns False if no face was found."""
        emb = self._embed_face(image)
        if emb is None:
            return False
        self._names.append(name)
        row = torch.from_numpy(emb)[None].to(self.device)
        self._gallery = row if self._gallery is None else torch.cat([self._gallery, row])
        return True

    def __len__(self) -> int:
        return len(self._names)

    def identify(self, image) -> Match | None:
        """Identifies the most confident face; None when no face is found
        or the best gallery distance exceeds the threshold."""
        if self._gallery is None:
            return None
        emb = self._embed_face(image)
        if emb is None:
            return None
        with torch.inference_mode():
            d = _distances(self._gallery, torch.from_numpy(emb).to(self.device)).cpu().numpy()
        i = int(np.argmin(d))
        if d[i] > self.threshold:
            return None
        return Match(self._names[i], float(d[i]))

    @property
    def names(self) -> list[str]:
        return list(self._names)

    @property
    def gallery(self) -> torch.Tensor | None:
        """[G, 128] L2-normalized embeddings on the device (None if empty)."""
        return self._gallery


class StreamIdentifier:
    """Tracking and identification over batched streams on ``device``
    (``cuda`` unless named; ``tracker`` and ``embedder`` must be on it).

    One step a frame: the wrapped ``FaceTracker`` advances every stream on
    its gated step, then the tracked ROI (its unrotated bounding rect, grown
    like :meth:`FaceIdentifier._embed_face` frames a face) is sampled to the
    embedder's 112×112 input for all streams in one call of the rotated-ROI
    kernel, embedded in one batched MobileFaceNet pass, L2-normalized and
    matched against the gallery. Outputs gain:

    - ``identity``: [B] int32 gallery row of the best match, -1 when the
      stream has no valid face or the distance exceeds ``threshold``;
    - ``identity_distance``: [B] f32 unit-sphere L2 distance to that row
      (``inf`` without a valid face or without a gallery);
    - ``embedding``: [B,128] the L2-normalized embeddings.

    Enroll through :class:`FaceIdentifier` (:meth:`adopt`) or pass ``names,
    embeddings`` to :meth:`set_gallery`; ``names[i]`` names row ``i``.
    ``params``: ``{"det", "lm", "emb"}`` weights for the default tracker and
    embedder (:func:`zaru_tpu_torch.weights.params_from_jax`).
    """

    def __init__(
        self,
        tracker=None,
        embedder: Embedder | None = None,
        *,
        threshold: float = 1.0,
        crop_grow: float = 0.2,
        params: dict | None = None,
        device=None,
    ):
        from ..pipeline import FaceTracker

        self.device = resolve_device(device)
        self.tracker = tracker or FaceTracker(params=params, device=self.device)
        self.embedder = embedder or Embedder(self.device, None if params is None else params.get("emb"))
        self.threshold = threshold
        self.crop_grow = crop_grow
        self.names: list[str] = []
        self._gallery = torch.zeros((0, 128), dtype=torch.float32, device=self.device)

    def set_gallery(self, names, embeddings) -> None:
        """Installs a [G, 128] gallery (rows are L2-normalized copies)."""
        emb = torch.as_tensor(embeddings, dtype=torch.float32).to(self.device)
        if emb.ndim != 2 or emb.shape[0] != len(names):
            raise ValueError(f"a gallery of {len(names)} names needs [{len(names)}, 128] embeddings, "
                             f"got {tuple(emb.shape)}")
        self.names = list(names)
        self._gallery = _normalized(emb)

    def adopt(self, identifier: FaceIdentifier) -> None:
        """Copies an enrolled :class:`FaceIdentifier`'s gallery."""
        if identifier.gallery is None:
            raise ValueError("identifier has no enrolled faces")
        self.set_gallery(identifier.names, identifier.gallery)

    def init_state(self, batch: int) -> dict:
        return self.tracker.init_state(batch=batch)

    def _crop_rects(self, rois):
        """Tracked ROIs ``[B,5]`` → the embedder's crop rects ``[B,5]``
        (identify.py:178-201): the ROI's axis-aligned bounding rect, grown
        to the host path's face-box-plus-``crop_grow`` framing and fitted
        to the network's aspect, at angle 0.

        The tracked ROI is the landmark bounding box grown by the tracker's
        ``roi_padding``. ``rect_grow_rel`` adds ``amount`` per side (size ×
        (1 + 2·amount)), so the compensating growth solves (1+2g) =
        (1+2cg)/(1+2rp): g = (cg − rp) / (1 + 2·rp)."""
        res = self.embedder.input_resolution()
        grow = (self.crop_grow - self.tracker.roi_padding) / (1.0 + 2.0 * self.tracker.roi_padding)
        zero = torch.zeros_like(rois[:, 4])
        rect = rrect_bounding(zero, _roi_corners(rois))
        rect = rect_grow_rel(rect[:, 0:4], grow)
        rect = rect_grow_to_fit_aspect(rect, float(np.float32(res.width) / np.float32(res.height)))
        return torch.cat([rect, zero[:, None]], dim=-1)

    def _embed_batch(self, frames, rois):
        """``frames [B,H,W,4] u8`` and tracked ROIs ``[B,5]`` → ``[B,128]``
        L2-normalized embeddings: one rotated-ROI kernel call writes the
        ``[B,3,112,112]`` crops MobileFaceNet reads, one pass embeds them."""
        out = self.embedder.cnn().apply_views_fast(frames, self._crop_rects(rois))
        return _normalized(out[0].reshape(-1, 128))

    @torch.inference_mode()
    def step(self, state: dict, frames, gallery=None, threshold=None, force_detect: bool = False):
        """(state, ``frames [B,H,W,4] u8``) → (state, outputs + identity).

        ``gallery`` and ``threshold`` default to the identifier's own;
        ``force_detect`` is the tracker's redetect cadence
        (``FaceTracker.step_batch``)."""
        gallery = self._gallery if gallery is None else gallery
        threshold = self.threshold if threshold is None else threshold
        new_state, out = self.tracker.step_batch(state, frames, force_detect)
        embs = self._embed_batch(frames, out["roi"])
        b = frames.shape[0]
        if gallery.shape[0] == 0:
            ident = torch.full((b,), -1, dtype=torch.int32, device=embs.device)
            dist = torch.full((b,), torch.inf, dtype=torch.float32, device=embs.device)
        else:
            d = _distances(gallery, embs)  # [B, G]
            dist, ident = torch.min(d, dim=-1)
            ok = out["valid"] & (dist <= threshold)
            ident = torch.where(ok, ident.to(torch.int32), -1)
            dist = torch.where(out["valid"], dist, torch.inf)
        out = dict(out, identity=ident, identity_distance=dist, embedding=embs)
        return new_state, out

    def run_frames(self, state: dict, frames, force_detect: bool = False):
        """The batched tracking + identification step with the identifier's
        gallery and threshold."""
        return self.step(state, frames, self._gallery, self.threshold, force_detect)


def _roi_corners(rois):
    """``[B,5]`` rrects → ``[B,4,2]`` corner points (identify.py:249-258),
    through the shared rotation (``geometry.rotate_ccw``)."""
    cx, cy, w, h, th = rois.unbind(-1)
    pts = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], device=rois.device)
    xy = pts * torch.stack([w * 0.5, h * 0.5], dim=-1)[:, None, :]
    return rotate_ccw(xy, th[:, None]) + torch.stack([cx, cy], dim=-1)[:, None, :]
