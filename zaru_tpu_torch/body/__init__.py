"""Body pose: detection and 33-point pose landmarks (zaru_tpu/body).

The pose model blobs are missing upstream and from this repository; the
networks load them from ``$ZARU_TPU_MODELS`` or ``assets/onnx`` and raise
``ModelMissingError`` until they are there.
"""

from . import detection, landmark

__all__ = ["detection", "landmark"]
