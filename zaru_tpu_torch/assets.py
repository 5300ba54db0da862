"""Model and fixture paths: the port's own copy of ``model_path``,
``fixture_path`` and ``MISSING_MODELS`` (zaru_tpu/assets.py:23-68).

Models are searched in ``$ZARU_TPU_MODELS`` (colon-separated directories),
then in the repository's ``assets/onnx``. Fixtures are searched in the
package's ``fixtures/`` directory, then in the repository's ``assets/img``.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["model_path", "fixture_path", "ModelMissingError", "MISSING_MODELS"]

# Blobs absent from the reference checkout itself
# (reference: 3rdparty/onnx/.MISSING_LARGE_BLOBS).
MISSING_MODELS = frozenset(
    {
        "hand_landmark_full.onnx",
        "palm_detection_full.onnx",
        "pose_detection.onnx",
        "pose_landmark_full.onnx",
        "pose_landmark_lite.onnx",
    }
)

_PACKAGE_DIR = Path(__file__).resolve().parent
_REPO_ROOT = _PACKAGE_DIR.parent


class ModelMissingError(FileNotFoundError):
    """A model blob is not available in any search directory."""


def model_path(filename: str) -> Path:
    dirs = [Path(p) for p in os.environ.get("ZARU_TPU_MODELS", "").split(":") if p]
    dirs.append(_REPO_ROOT / "assets" / "onnx")
    for d in dirs:
        p = d / filename
        if p.is_file():
            return p
    raise ModelMissingError(
        f"model {filename!r} not found in {[str(d) for d in dirs]} "
        "(set ZARU_TPU_MODELS to add a directory)"
    )


def fixture_path(filename: str) -> Path:
    for d in (_PACKAGE_DIR / "fixtures", _REPO_ROOT / "assets" / "img"):
        p = d / filename
        if p.is_file():
            return p
    raise FileNotFoundError(f"fixture {filename!r} not found")
