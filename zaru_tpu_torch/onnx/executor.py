"""Runs a parsed ONNX graph as an ``nn.Module``.

The counterpart of zaru_tpu/onnx/importer.py (``import_model``) and of its
op registry, zaru_tpu/onnx/ops.py (``OPS``): the same 62 ops under the same
names, each following its JAX handler:

- elementwise (ops.py:59-199): Relu, LeakyRelu, PRelu, Sigmoid,
  HardSigmoid, Tanh, Exp, Sqrt, Neg, Erf, Clip, Add, Sub, Mul, Div, Pow,
  variadic Min and Max, Softmax (opset < 13 flattens the trailing axes),
  Identity, Cast;
- convolution and pooling (:205-357): Conv (explicit pads, SAME_UPPER,
  SAME_LOWER, VALID), MaxPool and AveragePool (``ceil_mode``,
  ``count_include_pad``), GlobalAveragePool;
- reductions (:360-413, :765-780): ReduceMean, ReduceSum, ReduceMax,
  ReduceMin, one axis at a time in ascending order; ArgMax;
- shape (:419-562): Pad, Reshape, Flatten, Transpose, Concat, Squeeze,
  Unsqueeze, Shape, Gather, Slice, Split, Constant;
- resampling (:572-649): Resize and Upsample as ``jax.image.resize``
  computes them (:func:`resize`);
- linear algebra and the rest (:655-838): Gemm, MatMul,
  BatchNormalization, Abs, Floor, Ceil, Round (half to even), Log, Elu,
  Gelu, Where, Equal, Greater, Less, Expand, Tile,
  InstanceNormalization, ConvTranspose.

A graph with any other op is refused when it is loaded.

**Parameters and host values.** The parameters are the graph's float
initializers, keyed by their ONNX names exactly as
zaru_tpu/onnx/importer.py:109-136 keys them: a float initializer read only
by a structural input slot (Resize ``roi`` and ``scales``, Upsample
``scales``, Pad ``constant_value``) is no parameter. Every other
initializer and every Constant is a host value, a numpy array, as JAX's
``static_env`` holds them (importer.py:177-218): a node whose inputs are
all host values and whose op has a numpy form (:data:`_HOST_OPS`: Shape,
Gather, Concat, Squeeze, Unsqueeze, Slice, Cast, Identity, the arithmetic
and comparison ops) computes in numpy, and its outputs are host values
too; Shape always is one. What runs where is decided when the module is
built, from the graph alone. A slot that reads a shape, pads, axes, scales
or a bound (:data:`_HOST_SLOTS`) takes a host value as numpy; a slot that
must be static (``_need_static`` in ops.py) and gets a tensor raises
``ValueError`` as JAX does. A host value read by any other slot of a node
that runs on the device becomes a tensor there: a copy made when the module
is built for the initializers and Constants (a buffer, no parameter; float
ones stay f32, as JAX's numpy constants do), made at the first call that
computes a value on the host and kept for the next call with the same
value (float64 as f32, as JAX canonicalizes). A Div by a float host value
multiplies by the value's f32 reciprocal, which is what the buffer or copy
holds: JAX folds the constant into its program, and XLA:CPU compiles that
division as such a product.

**Batches.** The graphs are exported at batch 1 and run here at batch B.
A graph input whose declared leading dimension is 1 or symbolic carries
the batch, and so does every device value computed from it; its axis 0
holds one row per image, in place of JAX's axis of size 1 (a graph input
declared at a fixed size greater than 1 carries none, and ops compute on
it exactly as JAX does). The result at batch B is JAX's batch-1 result per
image, concatenated along axis 0, or the op raises ``NotImplementedError``
when it would read or move the batch axis of more than one image, or give
an image more than one row of it:

- Reshape reads a leading 1 (or 0) as the batch and keeps a leading -1
  that leaves one row per image, Flatten ``axis=0`` keeps it, Resize and
  Upsample keep it, Squeeze with no axes keeps it, Shape of a batched
  value gives its per-image shape (axis 0 divided by B);
- Gather, Split, Concat, ArgMax, Softmax (and Softmax before opset 13 on
  axis 0), the reductions, Squeeze and Unsqueeze of axis 0, Transpose
  moving it, Tile repeating it and Expand broadcasting it to more than one
  or adding leading axes raise at B > 1; so do a Reshape to any other
  leading size, a Flatten whose rows would hold more than the image's
  axis 0, Gather with batched indices other than into an unbatched
  ``data``'s axis 0, and a broadcast (the elementwise ops, PRelu, Where,
  MatMul's leading axes) that would put a batched operand's axis 0
  anywhere but first or broadcast it against a size other than 1; Slice
  of axis 0 keeps or empties it, as JAX's slice of a size-1 axis does;
  MatMul raises when a batched operand of one or two axes would have its
  axis 0 contracted or moved; Gemm's ``transA`` always raises.

**Fused kernels.** The subgraphs that run as one hand-written kernel, and
their packed weights, are ``onnx/fusion.py``'s plans, found when the module
is built and packed again by :meth:`OnnxModule.load_params`;
:meth:`OnnxModule.without_plans` runs chosen plans node by node.

The other convolutions stay ``F.conv2d`` (cuDNN on the GPU), as the JAX
package left them to XLA. cuDNN runs f32 convolutions in TF32 by default,
which keeps about three decimal digits and breaks the repo's CNN bar
(``atol = 1e-3·max(1,|out|max)``, ``rtol = 2e-3``), so :meth:`forward`
turns TF32 off around them, and pins f32 matrix products (Gemm, MatMul) to
full f32 whatever ``torch.set_float32_matmul_precision`` the caller set.

**Compute dtype.** ``compute_dtype=torch.bfloat16`` runs the network body
in bf16, as ``compute_dtype=jnp.bfloat16`` does in the JAX importer
(importer.py:178-184, :223-228): float graph inputs and a cast copy of the
parameters enter in bf16, every op runs in its input's dtype, and outputs
of that dtype leave as f32. The parameters themselves stay f32 (so
:meth:`OnnxModule.params`, :meth:`OnnxModule.load_params` and
``weights.params_from_jax`` are those of an f32 module); the cast copy is
made when the module is built and again by :meth:`OnnxModule.load_params`.
A float Constant stays f32 as JAX's numpy constant does, so what it meets
is promoted to f32 as in JAX. Ops follow JAX's rounding in bf16:

- Conv and ConvTranspose add their bias after the convolution, rounded to
  bf16 first (ops.py:260-264); ``F.conv2d`` with the bias would add it
  before its one rounding, which differs from JAX in a quarter of the
  outputs. In f32 Conv's bias stays fused, so f32 modules are unchanged
  bit for bit;
- Gemm's and MatMul's products are rounded once (ops.py:665, :673),
  accumulated in f32: :meth:`forward` turns cuBLAS's reduced-precision
  bf16 reduction off around them (JAX asks for f32 accumulation) and
  restores the caller's setting afterwards;
- Resize contracts one axis at a time and rounds in between (:func:`resize`).

A bf16 module builds no plan: the fused kernels are f32 by design, and
JAX's bf16 path runs its convolutions in XLA (``cnn_stage.fused_blocks`` has
no caller in ``zaru_tpu/``). The choice is made once, when the module is
built; an f32 module on CUDA launches its kernels or raises.

**Layout.** ``layout="NHWC"`` keeps the activations channels_last
(``onnx/layout.py``), the counterpart of JAX's NHWC layout: logical shapes
stay NCHW, so every op runs unchanged.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from . import layout as _layout
from .fusion import (PLANS, BlazeBlock, Bottlenecks, EntryBlock, Stage, find_blaze_blocks, find_bottlenecks,
                     find_entry_blocks, find_plans, find_stages)
from .proto import TENSOR_DTYPES, OnnxModel, OnnxNode

__all__ = ["BlazeBlock", "Bottlenecks", "EntryBlock", "OnnxModule", "PLANS", "SUPPORTED_OPS", "Stage",
           "find_blaze_blocks", "find_bottlenecks", "find_entry_blocks", "find_stages", "resize"]


def _static(node, vals, idx: int, what: str) -> np.ndarray:
    """Input ``idx`` as a host value, or ``ValueError`` (ops.py:47
    ``_need_static``)."""
    v = vals[idx] if idx < len(vals) else None
    if not isinstance(v, (np.ndarray, np.generic)):
        raise ValueError(f"{node.op_type} node {node.name!r}: input #{idx} ({what}) must be statically known")
    return np.asarray(v)


def _str(v) -> str:
    return v.decode() if isinstance(v, bytes) else v


@dataclass(frozen=True)
class Step:
    """A graph node as :class:`OnnxModule` runs it: the parsed node's fields
    (the parsed model itself is left as it is) and what the module decided
    when it was built: the model's ``opset`` (Softmax reads it, as the JAX
    importer hands it to its handlers, importer.py:161-164), which inputs
    carry the batch (``batched``) and which are host values (``host``)."""

    op_type: str
    inputs: tuple
    outputs: tuple
    name: str
    attrs: dict
    opset: int
    batched: tuple
    host: tuple

    @classmethod
    def of(cls, node: OnnxNode, opset: int, batched=None, host=None) -> Step:
        """``node`` as a step; ``batched`` and ``host`` (one flag an input)
        default to none."""
        none = (False,) * len(node.inputs)
        return cls(node.op_type, tuple(node.inputs), tuple(node.outputs), node.name, node.attrs, opset,
                   tuple(none if batched is None else batched), tuple(none if host is None else host))


def _batched(node: Step, i: int = 0) -> bool:
    """Whether input ``i`` carries the batch (see the module docstring)."""
    return node.batched[i]


def _per_image(node, vals, i: int = 0) -> bool:
    """Whether input ``i`` carries the batch of more than one image: an op
    that would read or move its axis 0 then raises."""
    return _batched(node, i) and np.ndim(vals[i]) > 0 and vals[i].shape[0] > 1


def _refuse_batch_axis(node, what: str) -> None:
    raise NotImplementedError(f"{node.op_type} node {node.name!r}: {what} the batch axis of more than one image")


def _check_broadcast(node, shapes, batched) -> None:
    """Refuses a broadcast of ``shapes`` that would not keep a batched
    operand's axis 0 as the result's axis 0 against size-1 axes of the
    others: a batched operand of fewer axes than the result, or an
    unbatched one of as many whose axis 0 is not 1."""
    rank = max(len(s) for s in shapes)
    for s, b in zip(shapes, batched):
        if (b and len(s) < rank) or (not b and len(s) == rank > 0 and s[0] != 1):
            _refuse_batch_axis(node, "broadcasts")


def _elementwise(fn):
    """A handler of an elementwise op on several inputs: ``fn(*vals)``, after
    :func:`_check_broadcast` when an input carries more than one image."""
    def handler(node, vals):
        if any(_per_image(node, vals, i) for i in range(len(vals))):
            _check_broadcast(node, [tuple(np.shape(v)) for v in vals], [_batched(node, i) for i in range(len(vals))])
        return fn(*vals)
    return handler


def _same_pads(size: int, k: int, s: int, d: int, lower: bool) -> tuple[int, int]:
    """SAME padding of one spatial axis, as lax computes it: the odd pixel
    goes to the end (SAME_UPPER) or the beginning (SAME_LOWER)."""
    out = -(-size // s)
    total = max((out - 1) * s + d * (k - 1) + 1 - size, 0)
    half = total // 2
    return (total - half, half) if lower else (half, total - half)


def _pad_pairs(node: OnnxNode, x, kernel, strides, dilations) -> list[tuple[int, int]]:
    """(begin, end) padding of the two spatial axes from ``auto_pad`` or the
    explicit ``pads`` (ops.py:205, :268)."""
    auto_pad = _str(node.attrs.get("auto_pad", "NOTSET"))
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        return [
            _same_pads(x.shape[2 + i], k, s, d, auto_pad == "SAME_LOWER")
            for i, (k, s, d) in enumerate(zip(kernel, strides, dilations))
        ]
    if auto_pad == "VALID":
        return [(0, 0), (0, 0)]
    pads = node.attrs.get("pads") or [0, 0, 0, 0]
    return list(zip(pads[:2], pads[2:]))


def _conv(node, vals):
    x, w = vals[0], vals[1]
    b = vals[2] if len(vals) > 2 else None
    if x.ndim != 4:
        raise NotImplementedError(f"Conv node {node.name!r}: only 2-D convolutions")
    strides = node.attrs.get("strides", [1, 1])
    dilations = node.attrs.get("dilations", [1, 1])
    (pt, pb), (pl, pr) = _pad_pairs(node, x, w.shape[2:], strides, dilations)
    if pt == pb and pl == pr:
        padding = (pt, pl)
    else:
        x = F.pad(x, (pl, pr, pt, pb))
        padding = 0
    bias_after = b is not None and x.dtype != torch.float32  # bf16: JAX rounds the convolution first
    out = F.conv2d(
        x, w, None if bias_after else b, stride=strides, padding=padding, dilation=dilations,
        groups=node.attrs.get("group", 1),
    )
    return out + b[:, None, None] if bias_after else out


def _conv_transpose(node, vals):
    """ops.py:794: the full transposed convolution (``F.conv_transpose2d``
    with no padding), then each axis cropped by its begin and end pad and
    grown by ``output_padding`` (zeros before the bias): ONNX pads may be
    asymmetric, which ``F.conv_transpose2d``'s one pad per axis is not. The
    bias is added after the convolution, as JAX adds it."""
    x, w = vals[0], vals[1]
    b = vals[2] if len(vals) > 2 else None
    if x.ndim != 4:
        raise NotImplementedError(f"ConvTranspose node {node.name!r}: only 2-D transposed convolutions")
    if node.attrs.get("group", 1) != 1:
        raise NotImplementedError("grouped ConvTranspose")
    auto_pad = _str(node.attrs.get("auto_pad", "NOTSET"))
    if auto_pad not in ("NOTSET", "VALID") or "output_shape" in node.attrs:
        raise NotImplementedError(
            f"ConvTranspose node {node.name!r}: auto_pad={auto_pad!r} / "
            "output_shape are not supported — re-export with explicit pads"
        )
    strides = node.attrs.get("strides", [1, 1])
    dilations = node.attrs.get("dilations", [1, 1])
    pads = node.attrs.get("pads") or [0, 0, 0, 0]
    out_pad = node.attrs.get("output_padding", [0, 0])
    out = F.conv_transpose2d(x, w, None, stride=strides, dilation=dilations)
    (pt, pl), (pb, pr) = pads[:2], pads[2:]
    out = F.pad(out, (-pl, out_pad[1] - pr, -pt, out_pad[0] - pb))  # negative pads crop
    return out if b is None else out + b[:, None, None]


def _pool_pad_pairs(node, x, kernel, strides, dilations) -> tuple[int, int, int, int]:
    """``(top, bottom, left, right)`` padding of a pool; with ``ceil_mode``
    the end padding grows so that the floor division gives the ceil output
    size (ops.py:298-304)."""
    (pt, pb), (pl, pr) = _pad_pairs(node, x, kernel, strides, dilations)
    if node.attrs.get("ceil_mode", 0):
        keh = dilations[0] * (kernel[0] - 1) + 1
        kew = dilations[1] * (kernel[1] - 1) + 1
        h, w = x.shape[2], x.shape[3]
        out_h = -(-(h + pt + pb - keh) // strides[0]) + 1
        out_w = -(-(w + pl + pr - kew) // strides[1]) + 1
        pb = (out_h - 1) * strides[0] + keh - h - pt
        pr = (out_w - 1) * strides[1] + kew - w - pl
    return pt, pb, pl, pr


def _max_pool(node, vals):
    x = vals[0]
    kernel = node.attrs["kernel_shape"]
    strides = node.attrs.get("strides", [1, 1])
    dilations = node.attrs.get("dilations", [1, 1])
    pt, pb, pl, pr = _pool_pad_pairs(node, x, kernel, strides, dilations)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, kernel, strides, 0, dilations)


def _avg_pool(node, vals):
    """Window sums over the zero-padded input, divided by the window's size
    (``count_include_pad``) or else by the count of input pixels it covers
    (ops.py:316-324); ``F.avg_pool2d`` pads only symmetrically, so the pads
    are explicit and the divisor is computed here."""
    x = vals[0]
    kernel = node.attrs["kernel_shape"]
    strides = node.attrs.get("strides", [1, 1])
    pt, pb, pl, pr = _pool_pad_pairs(node, x, kernel, strides, [1, 1])
    padded = F.pad(x, (pl, pr, pt, pb))
    sums = F.avg_pool2d(padded, kernel, strides, 0, divisor_override=1)
    if node.attrs.get("count_include_pad", 0):
        return sums / float(kernel[0] * kernel[1])
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device), (pl, pr, pt, pb))
    counts = F.avg_pool2d(ones, kernel, strides, 0, divisor_override=1)
    return (1.0 / counts) * sums


def _reduce(node, vals, fn):
    """A reduction over ``axes`` (an attribute, or from opset 18 an input;
    none or an empty input: every axis, or with ``noop_with_empty_axes``
    the input itself), one axis at a time in ascending order as ops.py:360
    reduces them; ``keepdims`` (default 1). Refuses the batch axis of more
    than one image."""
    x = vals[0]
    axes = node.attrs.get("axes")
    if axes is None and len(vals) > 1 and vals[1] is not None:
        axes = _static(node, vals, 1, "axes").tolist()
    if axes is not None and len(axes) == 0:
        if node.attrs.get("noop_with_empty_axes", 0):
            return x
        axes = None
    axes = sorted({int(a) % x.ndim for a in (range(x.ndim) if axes is None else axes)})
    if 0 in axes and _per_image(node, vals):
        _refuse_batch_axis(node, "reduces")
    out = x
    for ax in axes:
        out = fn(out, ax)
    if not node.attrs.get("keepdims", 1):
        out = out.reshape([s for i, s in enumerate(out.shape) if i not in axes])
    return out


def _pad(node, vals):
    x = vals[0]
    pads = node.attrs.get("pads")
    if pads is None:
        pads = _static(node, vals, 1, "pads").tolist()
    value = node.attrs.get("value", 0.0)
    if len(vals) > 2 and vals[2] is not None:
        value = float(_static(node, vals, 2, "constant_value"))
    mode = _str(node.attrs.get("mode", "constant"))
    if mode != "constant":
        raise NotImplementedError(f"Pad node {node.name!r}: mode {mode!r}")
    rank = x.ndim
    flat = []
    for i in reversed(range(rank)):  # F.pad lists the last axis first
        flat += [int(pads[i]), int(pads[i + rank])]
    return F.pad(x, flat, value=value)


def _reshape(node, vals):
    """A batched input's leading target size 1 (or 0) is the batch; a
    leading -1 must leave one row per image; any other leading size would
    give an image several rows, and raises."""
    x = vals[0]
    shape = node.attrs.get("shape")
    if shape is None:
        shape = _static(node, vals, 1, "shape").tolist()
    shape = [int(s) for s in shape]
    allowzero = node.attrs.get("allowzero", 0)
    per_image = bool(shape) and _per_image(node, vals)
    if per_image and shape[0] not in (1, -1) and (shape[0] != 0 or allowzero):
        _refuse_batch_axis(node, f"reshapes to a leading {shape[0]}")
    if not allowzero:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    if per_image and shape[0] == 1:
        shape[0] = x.shape[0]  # the batch-1 graph's leading axis is the batch
    out = torch.reshape(x, shape)
    if per_image and out.shape[0] != x.shape[0]:
        _refuse_batch_axis(node, f"reshapes to {out.shape[0] // x.shape[0]} rows an image of")
    return out


def _flatten(node, vals):
    """ops.py:452: ``[prod(shape[:axis]), -1]``, a negative axis counted
    from the end; ``axis=0`` keeps a batch axis (each image's ``[1, n]``),
    and a larger one raises where an image's rows would be several."""
    x = vals[0]
    axis = node.attrs.get("axis", 1)
    if axis < 0:
        axis += x.ndim
    if _per_image(node, vals):
        if int(np.prod(x.shape[1:axis])) != 1:
            _refuse_batch_axis(node, "flattens into several rows an image of")
        axis = max(axis, 1)
    return torch.reshape(x, (int(np.prod(x.shape[:axis])) if axis > 0 else 1, -1))


def _transpose(node, vals):
    x = vals[0]
    perm = node.attrs.get("perm") or list(reversed(range(x.ndim)))
    if perm[0] != 0 and _per_image(node, vals):
        _refuse_batch_axis(node, "moves")
    return x.permute(*perm)


def _concat(node, vals):
    axis = node.attrs["axis"]
    if axis % vals[0].ndim == 0 and any(_per_image(node, vals, i) for i in range(len(vals))):
        _refuse_batch_axis(node, "concatenates along")
    return torch.cat(vals, dim=axis)


def _clip(node, vals):
    """``min(max(x, lo), hi)`` in one pass; a bound from an input is a
    static initializer (a Python float here) or a tensor."""
    x = vals[0]
    lo, hi = node.attrs.get("min"), node.attrs.get("max")
    if lo is None and len(vals) > 1:
        lo = vals[1]
    if hi is None and len(vals) > 2:
        hi = vals[2]
    bounds = [float(v.item()) if isinstance(v, np.ndarray) else v for v in (lo, hi)]
    if all(v is None for v in bounds):
        return x
    if any(isinstance(v, torch.Tensor) for v in bounds):  # torch.clamp takes two tensors or two numbers
        bounds = [v if v is None or isinstance(v, torch.Tensor) else torch.full((), v, dtype=x.dtype, device=x.device)
                  for v in bounds]
    return torch.clamp(x, *bounds)


def _squeeze_axes(node, vals) -> list[int]:
    x = vals[0]
    axes = node.attrs.get("axes")
    if axes is None and len(vals) > 1 and vals[1] is not None:
        axes = _static(node, vals, 1, "axes").tolist()
    if axes is None:  # every size-1 axis (but a batch axis)
        first = 1 if _batched(node) else 0
        axes = [i for i in range(first, np.ndim(x)) if x.shape[i] == 1]
    return sorted({int(a) % np.ndim(x) for a in axes})


def _squeeze(node, vals):
    axes = _squeeze_axes(node, vals)
    if 0 in axes and _per_image(node, vals):
        _refuse_batch_axis(node, "squeezes")
    return vals[0].reshape([s for i, s in enumerate(vals[0].shape) if i not in axes])


def _unsqueeze_axes(node, vals) -> list[int]:
    axes = node.attrs.get("axes")
    if axes is None:
        axes = _static(node, vals, 1, "axes").tolist()
    rank = np.ndim(vals[0]) + len(axes)
    return sorted(int(a) % rank for a in axes)


def _unsqueeze(node, vals):
    axes = _unsqueeze_axes(node, vals)
    if 0 in axes and _per_image(node, vals):
        _refuse_batch_axis(node, "moves")
    x = vals[0]
    for a in axes:
        x = x.unsqueeze(a)
    return x


def _gather(node, vals):
    """``jnp.take`` (ops.py:512): negative indices wrap. Batched indices
    keep their batch axis first only as indices into an unbatched
    ``data``'s axis 0."""
    data, idx = vals
    axis = node.attrs.get("axis", 0) % data.ndim
    if axis == 0 and _per_image(node, vals):
        _refuse_batch_axis(node, "gathers along")
    if _per_image(node, vals, 1) and (axis != 0 or _batched(node, 0)):
        _refuse_batch_axis(node, "moves")
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


def _slice_args(node, vals, rank: int) -> list[tuple[int, slice]]:
    """``(axis, slice)`` pairs from the attributes (opset < 10) or the
    ``starts``, ``ends``, ``axes``, ``steps`` inputs (ops.py:521)."""
    if "starts" in node.attrs:
        starts, ends = node.attrs["starts"], node.attrs["ends"]
        axes = node.attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = _static(node, vals, 1, "starts").tolist()
        ends = _static(node, vals, 2, "ends").tolist()
        axes = (_static(node, vals, 3, "axes").tolist() if len(vals) > 3 and vals[3] is not None
                else list(range(len(starts))))
        steps = (_static(node, vals, 4, "steps").tolist() if len(vals) > 4 and vals[4] is not None
                 else [1] * len(starts))
    return [(int(ax) % rank, slice(int(st), int(en), int(sp))) for st, en, ax, sp in zip(starts, ends, axes, steps)]


def _slice(node, vals):
    """numpy's slicing, as ops.py:521 slices: a negative step through an
    index; the batch axis is kept or emptied as a size-1 axis is."""
    x = vals[0]
    for ax, sl in _slice_args(node, vals, x.ndim):
        if ax == 0 and _per_image(node, vals):
            if len(range(1)[sl]) == 0:
                x = x[:0]
            continue
        idx = range(x.shape[ax])[sl]
        if sl.step > 0:
            x = x.narrow(ax, idx.start, len(idx)) if sl.step == 1 else x[(slice(None),) * ax + (sl,)]
        else:
            x = x.index_select(ax, torch.arange(idx.start, idx.stop, idx.step, device=x.device))
    return x


def _split_sizes(node, vals, size: int) -> list[int]:
    split = node.attrs.get("split")
    if split is None and len(vals) > 1 and vals[1] is not None:
        split = _static(node, vals, 1, "split").tolist()
    if split is None:
        n = len(node.outputs)
        split = [size // n] * n
    return np.cumsum(split)[:-1].tolist()


def _split(node, vals):
    """``jnp.split`` at the cumulative sizes (ops.py:550): from the
    attribute, the input or an even split over the outputs."""
    x = vals[0]
    axis = node.attrs.get("axis", 0) % x.ndim
    if axis == 0 and _per_image(node, vals):
        _refuse_batch_axis(node, "splits")
    return list(torch.tensor_split(x, _split_sizes(node, vals, x.shape[axis]), dim=axis))


def _softmax(node, vals):
    """ops.py:171: per axis from opset 13 (default -1); before it over the
    flattened trailing axes from ``axis`` (default 1)."""
    x = vals[0]
    if node.opset >= 13:
        axis = node.attrs.get("axis", -1) % x.ndim
        if axis == 0 and _per_image(node, vals):
            _refuse_batch_axis(node, "normalizes over")
        return torch.softmax(x, axis)
    axis = node.attrs.get("axis", 1) % max(x.ndim, 1)
    if axis == 0 and _per_image(node, vals):
        _refuse_batch_axis(node, "normalizes over")
    return torch.softmax(x.reshape(x.shape[:axis] + (-1,)), -1).reshape(x.shape)


def _torch_dtype(np_dtype) -> torch.dtype:
    """A numpy dtype's torch dtype; float64 as float32, as JAX keeps it
    without x64."""
    dt = np.dtype(np_dtype)
    return torch.float32 if dt == np.float64 else torch.from_numpy(np.zeros(0, dt)).dtype


def _cast(node, vals):
    return vals[0].to(_torch_dtype(TENSOR_DTYPES[node.attrs["to"]]))


def _matmul(node, vals):
    """``a @ b``. A batched ``a`` of two axes keeps its rows first against a
    ``b`` of at most two; otherwise a batched operand's axis 0 must lead
    the broadcast axes (:func:`_check_broadcast`)."""
    a, b = vals
    if _per_image(node, vals, 0) or _per_image(node, vals, 1):
        if (a.ndim == 1 and _batched(node, 0)) or (b.ndim <= 2 and _batched(node, 1)):
            _refuse_batch_axis(node, "contracts")
        if a.ndim == 2 and _batched(node, 0) and b.ndim > 2:
            _refuse_batch_axis(node, "moves")
        _check_broadcast(node, [tuple(v.shape[:-2]) for v in (a, b)], [_batched(node, 0), _batched(node, 1)])
    return torch.matmul(a, b)


def _batch_norm(node, vals):
    """ops.py:678, in its order of operations:
    ``(x − mean)·(scale·rsqrt(var + eps)) + bias``, the root in f32."""
    x, scale, bias, mean, var = vals[:5]
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + bias.reshape(shape)


def _instance_norm(node, vals):
    """ops.py:783: the mean and the population variance (``jnp.var``:
    the mean of the squared deviations) over the spatial axes."""
    x, scale, bias = vals
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)


def _elu(node, vals):
    x = vals[0]
    return torch.where(x < 0, node.attrs.get("alpha", 1.0) * (torch.exp(x) - 1.0), x)


def _gelu(node, vals):
    """``jax.nn.gelu``: ``0.5·x·erfc(−x·√½)``, or with ``approximate="tanh"``
    ``x·0.5·(1 + tanh(√(2/π)·(x + 0.044715·x³)))``."""
    x = vals[0]
    if _str(node.attrs.get("approximate", "none")) == "tanh":
        c = float(np.sqrt(2 / np.pi).astype(np.float32))
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))
    return 0.5 * x * torch.special.erfc(-x * float(np.sqrt(0.5).astype(np.float32)))


def _expand(node, vals):
    """Two-way broadcast to ``shape`` (ops.py:750); a batch axis of more
    than one image stays one image's size 1 against ``shape``."""
    x = vals[0]
    shape = [int(s) for s in _static(node, vals, 1, "shape").tolist()]
    if _per_image(node, vals):
        per_image = torch.broadcast_shapes((1,) + tuple(x.shape[1:]), tuple(shape))
        if len(shape) > x.ndim or per_image[0] != 1:
            _refuse_batch_axis(node, "broadcasts")
        shape = [x.shape[0]] + list(per_image[1:])
    return x.expand(torch.broadcast_shapes(tuple(x.shape), tuple(shape)))


def _tile(node, vals):
    x = vals[0]
    reps = [int(r) for r in _static(node, vals, 1, "repeats").tolist()]
    if _per_image(node, vals) and (len(reps) > x.ndim or reps[len(reps) - x.ndim] != 1):
        _refuse_batch_axis(node, "repeats")
    return torch.tile(x, reps)


def _argmax(node, vals):
    """``jnp.argmax`` (the first index of the maximum), int64."""
    x = vals[0]
    axis = node.attrs.get("axis", 0) % x.ndim
    if axis == 0 and _per_image(node, vals):
        _refuse_batch_axis(node, "reduces")
    return torch.argmax(x, axis, keepdim=bool(node.attrs.get("keepdims", 1)))


_mul, _true_div = _elementwise(torch.mul), _elementwise(torch.div)


def _div(node, vals):
    """``a / b``; by a float host value (a constant, folded into JAX's
    program) as XLA:CPU compiles it: a product with its f32 reciprocal,
    which is what the module hands over for such a ``b``."""
    return (_mul if node.host[1] and vals[1].is_floating_point() else _true_div)(node, vals)


# --- Resize ------------------------------------------------------------------


def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    """The Keys cubic kernel with a = −0.5, as ``jax.image.resize``'s
    ``cubic`` (PyTorch's ``bicubic`` takes a = −0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def _resize_weights(m: int, n: int, method: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``[m, n]`` in ``dtype``: the weight of input ``i`` in output ``j``
    along one axis, as ``jax.image``'s ``compute_weight_mat`` computes it
    in f32 with antialiasing: half-pixel centres, the kernel widened by
    ``m / n`` on a shrink, each column normalised to sum 1. Kept for the
    next call at the same sizes."""
    with _real_tensors():
        return _weight_mat(m, n, method, device).to(dtype)


@contextlib.contextmanager
def _real_tensors():
    """Makes a tensor that is kept from one call to the next: a plain one,
    outside inference mode and outside any tracing or fake-tensor mode of
    the call that makes it (``torch.export``, ``FakeTensorMode`` in
    ``onnx/analysis.py``), so a later eager call can use it; a traced
    program takes it as a constant."""
    from torch.utils._python_dispatch import _disable_current_modes

    with torch.inference_mode(False), _disable_current_modes():
        yield


def _weight_mat(m: int, n: int, method: str, device: torch.device) -> torch.Tensor:
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = (_triangle if method == "linear" else _keys_cubic)(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _axis_order(shape, sizes, axes) -> list[int]:
    """The order ``jnp.einsum`` contracts the resized axes in: of two, the
    one whose pass costs less work first (the earlier on a tie)."""
    if len(axes) != 2:
        return list(axes)
    a, b = axes
    h, w, H, W = shape[a], shape[b], sizes[a], sizes[b]
    return [a, b] if H * w * (h + W) <= h * W * (w + H) else [b, a]


def resize(x: torch.Tensor, sizes, method: str) -> torch.Tensor:
    """``jax.image.resize(x, sizes, method)`` for ``nearest``, ``linear``
    and ``cubic``. Nearest reads input ``floor((j + 0.5)·m / n)`` along
    each resized axis. Linear and cubic contract each resized axis with
    :func:`_resize_weights` (antialiased on a shrink), one axis at a time
    and rounded to the input's dtype in between, as JAX's einsum does: bf16
    takes bf16 weights. A 4-D linear resize that grows only the spatial
    axes runs ``F.interpolate`` (bilinear, half-pixel), which computes the
    same weights: in f32 both axes before its one rounding, in bf16 the
    cheaper axis first."""
    sizes = [int(s) for s in sizes]
    axes = [d for d in range(x.ndim) if x.shape[d] != sizes[d]]
    if not axes:
        return x
    if method == "nearest":
        for d in axes:
            m, n = x.shape[d], sizes[d]
            idx = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n)
            x = x.index_select(d, idx.to(torch.int64))
        return x
    if method == "linear" and x.ndim == 4 and min(axes) >= 2 and all(sizes[d] > x.shape[d] for d in axes):
        cl = x.is_contiguous(memory_format=torch.channels_last)
        # Channels-last: PyTorch's NCHW bilinear kernel on CUDA runs one
        # thread per output pixel over every image and channel, which is
        # slow at a small spatial size and a large batch.
        x = x.contiguous(memory_format=torch.channels_last)
        h, w = x.shape[2:]
        H, W = sizes[2:]
        if x.dtype != torch.float32 and (h, w) != (H, W):
            first = _axis_order(x.shape, sizes, [2, 3])[0]
            x = F.interpolate(x, size=(H, w) if first == 2 else (h, W), mode="bilinear", align_corners=False)
        out = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False)
        return out if cl else out.contiguous()
    for d in _axis_order(x.shape, sizes, axes):
        w = _resize_weights(x.shape[d], sizes[d], method, x.dtype, x.device)
        x = torch.movedim(torch.matmul(torch.movedim(x, d, -1), w), -1, d)
    return x


def _resize_sizes(node, vals, x, scales) -> list[int]:
    """``floor(scale · dim + 1e-7)`` per axis (ops.py:592-598); a batch
    axis keeps its size."""
    sizes = [int(np.floor(float(s) * d + 1e-7)) for s, d in zip(scales, x.shape)]
    if _batched(node):
        sizes[0] = x.shape[0]
    return sizes


def _resize(node, vals):
    """ops.py:572: the target size from ``sizes`` or else ``scales``; linear
    with half-pixel centres and nearest ``asymmetric``/``floor`` as they
    are, every other nearest, linear or cubic configuration with JAX's
    warning, computed as ``jax.image.resize`` computes it (:func:`resize`).
    A batch axis keeps its size."""
    x = vals[0]
    mode = _str(node.attrs.get("mode", "nearest"))
    coord = _str(node.attrs.get("coordinate_transformation_mode", "half_pixel"))
    nearest_mode = _str(node.attrs.get("nearest_mode", "round_prefer_floor"))
    if len(vals) > 3 and vals[3] is not None and np.size(_static(node, vals, 3, "sizes")) > 0:
        sizes = [int(s) for s in np.asarray(vals[3]).tolist()]
        if _batched(node):
            sizes[0] = x.shape[0]
    elif len(vals) > 2 and vals[2] is not None and np.size(_static(node, vals, 2, "scales")) > 0:
        sizes = _resize_sizes(node, vals, x, np.asarray(vals[2]).tolist())
    else:
        raise ValueError(f"Resize node {node.name!r}: no static sizes/scales")
    if mode == "linear" and coord in ("half_pixel", "pytorch_half_pixel"):
        if coord == "pytorch_half_pixel" and 1 in sizes[2:]:
            raise ValueError(f"Resize node {node.name!r}: pytorch_half_pixel with an output dim of 1")
        return resize(x, sizes, "linear")
    if mode == "nearest" and coord == "asymmetric" and nearest_mode == "floor":
        return resize(x, sizes, "nearest")
    if mode not in ("nearest", "linear", "cubic"):
        raise ValueError(f"unsupported Resize config mode={mode} coord={coord}")
    warnings.warn(
        f"Resize node {node.name!r}: mode={mode!r} with "
        f"coordinate_transformation_mode={coord!r} "
        f"(nearest_mode={nearest_mode!r}) is approximated by "
        "jax.image.resize's half-pixel convention; outputs may differ "
        "from ONNX semantics",
        stacklevel=2,
    )
    return resize(x, sizes, mode)


def _upsample(node, vals):
    """ops.py:638: ``scales`` from the attribute or the input, nearest or
    (any other mode) linear."""
    x = vals[0]
    scales = node.attrs.get("scales")
    if scales is None:
        scales = _static(node, vals, 1, "scales").tolist()
    method = "nearest" if _str(node.attrs.get("mode", "nearest")) == "nearest" else "linear"
    return resize(x, _resize_sizes(node, vals, x, scales), method)


def _gemm(node, vals):
    a, b = vals[0], vals[1]
    c = vals[2] if len(vals) > 2 else None
    if node.attrs.get("transA", 0):
        raise NotImplementedError(f"Gemm node {node.name!r}: transA (A's leading axis is the batch)")
    if node.attrs.get("transB", 0):
        b = b.t()
    out = node.attrs.get("alpha", 1.0) * torch.matmul(a, b)
    if c is not None:
        out = out + node.attrs.get("beta", 1.0) * c
    return out


_OPS = {
    "Conv": _conv,
    "Relu": lambda node, vals: torch.relu(vals[0]),
    "LeakyRelu": lambda node, vals: torch.where(vals[0] < 0, node.attrs.get("alpha", 0.01) * vals[0], vals[0]),
    "PRelu": _elementwise(lambda x, s: torch.where(x < 0, s * x, x)),
    "Sigmoid": lambda node, vals: torch.sigmoid(vals[0]),
    "HardSigmoid": lambda node, vals: torch.clamp(
        node.attrs.get("alpha", 0.2) * vals[0] + node.attrs.get("beta", 0.5), 0.0, 1.0),
    "Tanh": lambda node, vals: torch.tanh(vals[0]),
    "Exp": lambda node, vals: torch.exp(vals[0]),
    "Sqrt": lambda node, vals: torch.sqrt(vals[0]),
    "Neg": lambda node, vals: -vals[0],
    "Erf": lambda node, vals: torch.erf(vals[0]),
    "Clip": _clip,
    "Add": _elementwise(torch.add),
    "Sub": _elementwise(torch.sub),
    "Mul": _mul,
    "Div": _div,
    "Pow": _elementwise(torch.pow),
    "Min": _elementwise(lambda *vals: functools.reduce(torch.minimum, vals)),
    "Max": _elementwise(lambda *vals: functools.reduce(torch.maximum, vals)),
    "Softmax": _softmax,
    "Identity": lambda node, vals: vals[0],
    "Cast": _cast,
    "MaxPool": _max_pool,
    "AveragePool": _avg_pool,
    "GlobalAveragePool": lambda node, vals: vals[0].mean(dim=tuple(range(2, vals[0].ndim)), keepdim=True),
    "ReduceMean": lambda node, vals: _reduce(node, vals, lambda x, ax: x.mean(dim=ax, keepdim=True)),
    "ReduceSum": lambda node, vals: _reduce(node, vals, lambda x, ax: x.sum(dim=ax, keepdim=True)),
    "ReduceMax": lambda node, vals: _reduce(node, vals, lambda x, ax: x.amax(dim=ax, keepdim=True)),
    "ReduceMin": lambda node, vals: _reduce(node, vals, lambda x, ax: x.amin(dim=ax, keepdim=True)),
    "Pad": _pad,
    "Reshape": _reshape,
    "Flatten": _flatten,
    "Transpose": _transpose,
    "Concat": _concat,
    "Squeeze": _squeeze,
    "Unsqueeze": _unsqueeze,
    "Gather": _gather,
    "Slice": _slice,
    "Split": _split,
    "Resize": _resize,
    "Upsample": _upsample,
    "Gemm": _gemm,
    "MatMul": _matmul,
    "BatchNormalization": _batch_norm,
    "Abs": lambda node, vals: torch.abs(vals[0]),
    "Floor": lambda node, vals: torch.floor(vals[0]),
    "Ceil": lambda node, vals: torch.ceil(vals[0]),
    "Round": lambda node, vals: torch.round(vals[0]),  # half to even, as ONNX and jnp.round
    "Log": lambda node, vals: torch.log(vals[0]),
    "Elu": _elu,
    "Gelu": _gelu,
    "Where": _elementwise(lambda c, a, b: torch.where(c.to(torch.bool), a, b)),
    "Equal": _elementwise(torch.eq),
    "Greater": _elementwise(torch.gt),
    "Less": _elementwise(torch.lt),
    "Expand": _expand,
    "Tile": _tile,
    "ArgMax": _argmax,
    "InstanceNormalization": _instance_norm,
    "ConvTranspose": _conv_transpose,
}


def _host_shape(node, vals):
    return np.asarray(np.shape(vals[0]), dtype=np.int64)


def _host_squeeze(node, vals):
    return np.squeeze(vals[0], axis=tuple(_squeeze_axes(node, vals)))


def _host_unsqueeze(node, vals):
    x = vals[0]
    for a in _unsqueeze_axes(node, vals):
        x = np.expand_dims(x, a)
    return x


def _host_slice(node, vals):
    x = vals[0]
    slicers = [slice(None)] * np.ndim(x)
    for ax, sl in _slice_args(node, vals, np.ndim(x)):
        slicers[ax] = sl
    return x[tuple(slicers)]


def _host_min(node, vals):
    return functools.reduce(np.minimum, vals)


def _host_max(node, vals):
    return functools.reduce(np.maximum, vals)


# The numpy forms of the ops a node whose inputs are all host values runs on
# the host (ops.py: the handlers whose numpy inputs give numpy outputs).
_HOST_OPS = {
    "Shape": _host_shape,
    "Gather": lambda node, vals: np.take(vals[0], np.asarray(vals[1]).astype(np.int64),
                                         axis=node.attrs.get("axis", 0)),
    "Concat": lambda node, vals: np.concatenate(vals, axis=node.attrs["axis"]),
    "Squeeze": _host_squeeze,
    "Unsqueeze": _host_unsqueeze,
    "Slice": _host_slice,
    "Cast": lambda node, vals: np.asarray(vals[0]).astype(TENSOR_DTYPES[node.attrs["to"]]),
    "Identity": lambda node, vals: vals[0],
    "Add": lambda node, vals: vals[0] + vals[1],
    "Sub": lambda node, vals: vals[0] - vals[1],
    "Mul": lambda node, vals: vals[0] * vals[1],
    "Div": lambda node, vals: vals[0] / vals[1],
    "Pow": lambda node, vals: vals[0] ** vals[1],
    "Neg": lambda node, vals: -vals[0],
    "Min": _host_min,
    "Max": _host_max,
    "Equal": lambda node, vals: vals[0] == vals[1],
    "Greater": lambda node, vals: vals[0] > vals[1],
    "Less": lambda node, vals: vals[0] < vals[1],
}
SUPPORTED_OPS = frozenset(_OPS) | {"Shape", "Constant"}
# Input slots whose float initializer is structural, never a parameter
# (zaru_tpu/onnx/importer.py:109-123).
_FLOAT_STATIC_SLOTS = frozenset({("Resize", 1), ("Resize", 2), ("Upsample", 1), ("Pad", 2)})
# Input slots whose value an op reads on the host (a shape, pads, a bound,
# axes, scales, repeats: every slot ops.py's ``_need_static`` reads): a host
# value read there stays numpy.
_HOST_SLOTS = _FLOAT_STATIC_SLOTS | {
    ("Reshape", 1), ("Pad", 1), ("Clip", 1), ("Clip", 2), ("Squeeze", 1), ("Resize", 3),
    ("Slice", 1), ("Slice", 2), ("Slice", 3), ("Slice", 4), ("Split", 1), ("Unsqueeze", 1),
    ("Expand", 1), ("Tile", 1), ("ReduceMean", 1), ("ReduceSum", 1), ("ReduceMax", 1), ("ReduceMin", 1),
}


def _constant_value(node) -> np.ndarray:
    """A Constant node's value (ops.py:565)."""
    for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        if key in node.attrs:
            return np.asarray(node.attrs[key])
    raise ValueError(f"Constant node {node.name!r} without value")


def _float_static_names(nodes) -> set[str]:
    """Names read only through :data:`_FLOAT_STATIC_SLOTS`."""
    static, traced = set(), set()
    for n in nodes:
        for idx, name in enumerate(n.inputs):
            if name:
                (static if (n.op_type, idx) in _FLOAT_STATIC_SLOTS else traced).add(name)
    return static - traced


def _carries_batch(vi) -> bool:
    """Whether a graph input carries the batch: its declared leading
    dimension is 1 or symbolic (or its shape unknown)."""
    return not vi.shape or not isinstance(vi.shape[0], int) or vi.shape[0] == 1


def _inverts(step: Step, idx: int, value) -> bool:
    """Whether a host value read as a tensor by input ``idx`` of ``step`` is
    handed over as its f32 reciprocal: a Div's float divisor (:func:`_div`)."""
    return step.op_type == "Div" and idx == 1 and np.asarray(value).dtype.kind == "f"


def _device_value(v, device: torch.device, reciprocal: bool = False) -> torch.Tensor:
    """A host value as a tensor on ``device``: float64 as f32; with
    ``reciprocal``, a float value's f32 reciprocal."""
    arr = np.asarray(v)
    if arr.dtype == np.float64 or reciprocal:
        arr = arr.astype(np.float32)
    if reciprocal:
        arr = np.float32(1) / arr
    return torch.from_numpy(np.array(arr)).to(device)  # a copy torch may write, an array even of a 0-d value


@contextlib.contextmanager
def _full_precision():
    """cuDNN convolutions without TF32, f32 matrix products at full f32
    precision and bf16 products accumulated in f32, restoring the caller's
    settings afterwards."""
    matmul = torch.backends.cuda.matmul
    prev = torch.get_float32_matmul_precision(), matmul.allow_bf16_reduced_precision_reduction
    torch.set_float32_matmul_precision("highest")
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        matmul.allow_bf16_reduced_precision_reduction = prev[1]


def _live_nodes(nodes, outputs) -> set[int]:
    """Indices of the nodes that ``outputs`` depend on."""
    needed, live = set(outputs), set()
    for i in range(len(nodes) - 1, -1, -1):
        if any(o in needed for o in nodes[i].outputs):
            live.add(i)
            needed.update(n for n in nodes[i].inputs if n)
    return live


class OnnxModule(nn.Module):
    """An ONNX graph as a module: ``forward(*inputs) -> list`` of the graph's
    outputs, NCHW like the ONNX contract.

    ``output_subset``: the outputs to return, by name or position, in that
    order (zaru_tpu/onnx/importer.py:140-151, the reference Loader's output
    selection); nodes that only feed the others are not run. The parameters
    stay those of the whole graph.

    ``compute_dtype``: ``torch.bfloat16`` runs the body in bf16 (see the
    module docstring); None is f32.

    ``layout``: ``"NCHW"`` or ``"NHWC"`` (channels_last activations,
    ``onnx/layout.py``)."""

    def __init__(self, model: OnnxModel, device: torch.device, output_subset=None, compute_dtype=None,
                 layout: str = "NCHW"):
        super().__init__()
        self.device = device
        if compute_dtype not in (None, torch.bfloat16):
            raise NotImplementedError(f"compute_dtype {compute_dtype}: only torch.bfloat16 or None (f32)")
        self.compute_dtype = compute_dtype
        self.layout = _layout.check(layout)
        g = model.graph
        self.name = g.name
        unsupported = sorted({n.op_type for n in g.nodes} - SUPPORTED_OPS)
        if unsupported:
            raise NotImplementedError(
                f"model {g.name!r} uses ONNX ops the port does not run: {unsupported}"
            )
        self._attr_of: dict[str, str] = {}
        self._static: dict[str, np.ndarray] = {}
        static_floats = _float_static_names(g.nodes)
        for i, (name, arr) in enumerate(g.initializers.items()):
            if arr.dtype in (np.float32, np.float16, np.float64) and name not in static_floats:
                attr = f"p{i}"
                self._attr_of[name] = attr
                t = _layout.store(torch.tensor(np.asarray(arr, np.float32), device=device), self.layout)
                self.register_parameter(attr, nn.Parameter(t, requires_grad=False))
            else:
                self._static[name] = arr
        for n in g.nodes:
            if n.op_type == "Constant":
                self._static[n.outputs[0]] = _constant_value(n)
        self.input_info = [vi for vi in g.inputs if vi.name not in g.initializers]
        self._plan_values(model)
        self.output_names = [vi.name for vi in g.outputs]
        if output_subset is not None:
            by_name = set(self.output_names)
            for sel in output_subset:
                if not isinstance(sel, int) and sel not in by_name:
                    raise ValueError(f"unknown output {sel!r}; have {self.output_names}")
            self.output_names = [
                g.outputs[sel].name if isinstance(sel, int) else sel for sel in output_subset
            ]
        info = {vi.name: vi for vi in g.outputs}
        self.output_info = [info[n] for n in self.output_names]
        self._live = _live_nodes(g.nodes, self.output_names)
        for kind, entries in find_plans(model, compute_dtype, self.layout).items():
            setattr(self, kind, entries)
        self._index_plans()
        self._derive_weights()

    def _index_plans(self) -> None:
        """Every plan's entries by the node that runs them, and every node
        the plans replace, from the attributes :data:`PLANS` names."""
        entries = [e for kind in PLANS for e in getattr(self, kind)]
        self._plan_at = {e.at: e for e in entries}
        self._in_plan = {i for e in entries for i in e.nodes}

    @contextlib.contextmanager
    def without_plans(self, *kinds: str):
        """Inside the block, the plans named in ``kinds`` (of :data:`PLANS`:
        ``"stages"``, ``"bottlenecks"``, ``"blaze_blocks"``, ``"entry_blocks"``;
        all where none is named) are empty and their nodes run one by one: the graph JAX
        differentiates (the kernels' ops have no gradient). The others run as
        planned. The packed weights are kept: load no parameters inside."""
        unknown = set(kinds) - set(PLANS)
        if unknown:
            raise ValueError(f"unknown plans {sorted(unknown)}; have {list(PLANS)}")
        kept = {kind: getattr(self, kind) for kind in kinds or PLANS}
        for kind in kept:
            setattr(self, kind, [])
        self._index_plans()
        try:
            yield self
        finally:
            for kind, plan in kept.items():
                setattr(self, kind, plan)
            self._index_plans()

    def _plan_values(self, model: OnnxModel) -> None:
        """The steps (:class:`Step`): which nodes run on the host, which
        values carry the batch and which are host values; and a device copy
        (a buffer) of each build-time host value a device node reads as a
        tensor."""
        host = set(self._static)
        batched = {vi.name for vi in self.input_info if _carries_batch(vi)}
        self.nodes: list[Step] = []
        self._on_host: set[int] = set()
        self._to_device: dict[int, tuple] = {}  # a device node's slots that read a host value as a tensor
        buffers: set[tuple[str, bool]] = set()
        for i, n in enumerate(model.graph.nodes):
            is_host = tuple(bool(name) and name in host for name in n.inputs)
            if n.op_type == "Constant":
                self.nodes.append(Step.of(n, model.opset))
                continue
            if n.op_type == "Shape" or (n.op_type in _HOST_OPS and all(is_host[k] or not name
                                                                        for k, name in enumerate(n.inputs))):
                self.nodes.append(Step.of(n, model.opset, host=is_host))
                self._on_host.add(i)
                host.update(n.outputs)
                continue
            step = Step.of(n, model.opset, [bool(name) and name in batched for name in n.inputs], is_host)
            self.nodes.append(step)
            if any(step.batched):
                batched.update(n.outputs)
            to_device = tuple(idx for idx, name in enumerate(n.inputs)
                              if is_host[idx] and (n.op_type, idx) not in _HOST_SLOTS)
            if to_device:
                self._to_device[i] = to_device
                buffers.update((n.inputs[idx], _inverts(step, idx, self._static[n.inputs[idx]]))
                               for idx in to_device if n.inputs[idx] in self._static)
        self._batched = batched
        self._const_attr: dict[tuple[str, bool], str] = {}
        for j, (name, reciprocal) in enumerate(sorted(buffers)):
            self._const_attr[name, reciprocal] = f"c{j}"
            self.register_buffer(f"c{j}", _device_value(self._static[name], self.device, reciprocal),
                                 persistent=False)
        self._host_copies: dict[tuple, torch.Tensor] = {}

    def _tensor_of(self, step: Step, idx: int, value) -> torch.Tensor:
        """Host value ``value`` read as a tensor by input ``idx`` of ``step``:
        its buffer, or for a value the host computed in this call, the copy
        kept from the first call that computed the same value (a new copy is
        counted in ``profiling.counters["host_copies"]``)."""
        name, reciprocal = step.inputs[idx], _inverts(step, idx, value)
        attr = self._const_attr.get((name, reciprocal))
        if attr is not None:
            return getattr(self, attr)
        arr = np.asarray(value)
        key = (name, reciprocal, arr.dtype.str, arr.shape, arr.tobytes())
        t = self._host_copies.get(key)
        if t is None:
            profiling.counters["host_copies"] += 1
            with profiling.span("zaru.build.host_copy"), _real_tensors():
                t = self._host_copies[key] = _device_value(arr, self.device, reciprocal)
        return t

    @torch.no_grad()
    def _derive_weights(self) -> None:
        """The plans' packed weights, by the node that runs each entry, and,
        in bf16, the parameters' cast copy, from the current parameters."""
        params = self.params()
        self._compute_params = (
            {k: v.to(self.compute_dtype) for k, v in params.items()} if self.compute_dtype else params
        )
        self._packed = {i: e.pack(params) for i, e in self._plan_at.items()}

    def params(self) -> dict[str, torch.Tensor]:
        """The float initializers by ONNX name."""
        return {name: getattr(self, attr) for name, attr in self._attr_of.items()}

    @torch.no_grad()
    def load_params(self, params: dict) -> None:
        """Copies ``{onnx name: array}`` into the parameters; the names and
        shapes must be exactly the graph's."""
        if set(params) != set(self._attr_of):
            missing = sorted(set(self._attr_of) - set(params))[:5]
            extra = sorted(set(params) - set(self._attr_of))[:5]
            raise ValueError(f"parameter names differ: missing {missing}, unknown {extra}")
        for name, value in params.items():
            p = getattr(self, self._attr_of[name])
            v = torch.as_tensor(value, dtype=torch.float32)
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"parameter {name!r}: shape {tuple(v.shape)}, want {tuple(p.shape)}")
            p.copy_(v)
        self._derive_weights()

    def activations(self, *inputs: torch.Tensor) -> dict:
        """Every value the selected outputs depend on, by name (the inner
        values of a plan's entry are not computed), for ``inputs``: device
        values as tensors, host values as numpy arrays."""
        if len(inputs) != len(self.input_info):
            raise ValueError(f"expected {len(self.input_info)} inputs, got {len(inputs)}")
        dtype = self.compute_dtype
        if dtype:
            inputs = [x.to(dtype) if x.is_floating_point() else x for x in inputs]
        inputs = [_layout.store(x, self.layout) for x in inputs]
        batch = next((x.shape[0] for vi, x in zip(self.input_info, inputs) if vi.name in self._batched), 1)
        env: dict = dict(self._static)
        # An f32 module reads its parameters themselves (attribute reads,
        # which torch.export tracks), a bf16 one their cast copy.
        env.update(self._compute_params if dtype else self.params())
        env.update((vi.name, x) for vi, x in zip(self.input_info, inputs))
        with _full_precision():
            for i, node in enumerate(self.nodes):
                if i not in self._live or node.op_type == "Constant":
                    continue
                e = self._plan_at.get(i)
                if e is not None:
                    env[e.output] = e.run(env[e.input], self._packed[i])
                    continue
                if i in self._in_plan:
                    continue
                vals = [env[n] if n else None for n in node.inputs]
                if i in self._on_host:
                    out = _HOST_OPS[node.op_type](node, vals)
                    if node.op_type == "Shape" and node.inputs[0] in self._batched and out.size:
                        out[0] //= batch  # the per-image shape
                else:
                    for idx in self._to_device.get(i, ()):
                        vals[idx] = self._tensor_of(node, idx, vals[idx])
                    out = _OPS[node.op_type](node, vals)
                    if self.layout == "NHWC":
                        out = _layout.keep(node.op_type, vals, out)
                env.update(zip(node.outputs, out if isinstance(out, list) else [out]))
        return env

    def forward(self, *inputs: torch.Tensor) -> list[torch.Tensor]:
        env = self.activations(*inputs)
        outs = [env[n] for n in self.output_names]
        if self.layout == "NHWC":
            outs = [_layout.to_nchw(o) for o in outs]
        if self.compute_dtype:
            outs = [o.float() if o.dtype == self.compute_dtype else o for o in outs]
        return outs
