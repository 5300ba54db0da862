"""ONNX models as torch modules (zaru_tpu/onnx/__init__.py)."""

from __future__ import annotations

from pathlib import Path

import torch

from .executor import SUPPORTED_OPS, OnnxModule
from .proto import OnnxModel, parse_model

__all__ = ["OnnxModel", "OnnxModule", "SUPPORTED_OPS", "load_model", "parse_model"]


def load_model(
    path_or_bytes: str | Path | bytes, device: torch.device, output_subset=None, compute_dtype=None,
    layout: str = "NCHW",
) -> OnnxModule:
    """Parses an ONNX file (or its bytes) into an :class:`OnnxModule` whose
    parameters live on ``device``; ``output_subset`` selects its outputs by
    name or position, ``compute_dtype`` (``torch.bfloat16``) the dtype its
    body runs in, ``layout`` (``"NCHW"`` or ``"NHWC"``) its activations'
    memory layout."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        data = Path(path_or_bytes).read_bytes()
    return OnnxModule(parse_model(data), device, output_subset, compute_dtype, layout)
