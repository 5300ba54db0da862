"""The NHWC layout as ``torch.channels_last`` (zaru_tpu/onnx/layout.py).

JAX's NHWC layout keeps activations physically NHWC between layout-aware
ops and tags each value with its layout, converting back to NCHW at a
Reshape, a Transpose other than the pre-head NCHW→NHWC one and at the
graph's outputs (layout.py:280-298, importer.py:220-222). PyTorch's idiom
for the same is a memory format: a channels_last tensor keeps its logical
NCHW shape, so no op needs a tag or a second handler, and a permute to NHWC
of a channels_last tensor is a contiguous view, not a copy.

An NHWC :class:`~zaru_tpu_torch.onnx.OnnxModule` stores its 4-D float
parameters and its 4-D inputs channels_last (:func:`store`); after each op
that JAX runs natively in NHWC (:data:`CHANNELS_LAST_OPS`), an output that
left channels_last while one of its 4-D inputs was channels_last is put
back (:func:`keep`; the PyTorch ops of the shipped models keep the format
on their own, so this costs nothing there); the graph's 4-D outputs leave
NCHW-contiguous (:func:`to_nchw`). A Reshape or Transpose leaves what
PyTorch gives it, as JAX converts only there.
"""

from __future__ import annotations

import torch

__all__ = ["CHANNELS_LAST_OPS", "LAYOUTS", "check", "keep", "store", "to_nchw"]

LAYOUTS = ("NCHW", "NHWC")
# The ops JAX's NHWC dispatcher runs on NHWC values (layout.py:87-92,
# :260-277), by the port's names.
CHANNELS_LAST_OPS = frozenset({
    "Conv", "PRelu", "MaxPool", "AveragePool", "GlobalAveragePool", "Pad", "Concat", "Resize",
    "Add", "Sub", "Mul", "Div", "Min", "Max",
    "Relu", "Sigmoid", "Tanh", "Clip", "LeakyRelu", "Elu", "Gelu", "HardSigmoid", "Neg", "Abs", "Sqrt",
    "Exp", "Log", "Floor", "Ceil", "Erf", "Identity", "Cast",
})


def check(layout: str) -> str:
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    return layout


def _is_image(x) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim == 4 and x.is_floating_point()


def store(x, layout: str):
    """``x`` as the layout stores it: a 4-D float tensor channels_last in
    NHWC (no copy if it is already), anything else as it is."""
    if layout == "NHWC" and _is_image(x):
        return x.contiguous(memory_format=torch.channels_last)
    return x


def keep(op: str, vals, out):
    """``out`` of ``op`` on ``vals`` with its 4-D outputs channels_last
    again where a 4-D input was and the op is one of
    :data:`CHANNELS_LAST_OPS`."""
    if op not in CHANNELS_LAST_OPS or not any(
        _is_image(v) and v.is_contiguous(memory_format=torch.channels_last) for v in vals
    ):
        return out
    if isinstance(out, list):
        return [store(o, "NHWC") for o in out]
    return store(out, "NHWC")


def to_nchw(x):
    """A graph output as ONNX gives it: a 4-D tensor NCHW-contiguous."""
    return x.contiguous() if isinstance(x, torch.Tensor) and x.ndim == 4 else x
