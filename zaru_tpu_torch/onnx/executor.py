"""Runs a parsed ONNX graph as an ``nn.Module``.

The counterpart of zaru_tpu/onnx/importer.py (``import_model``) for the 18
ops the shipped models use: Conv, Relu, PRelu, Add, Pad, MaxPool,
Transpose, Reshape and Concat (the face models), Resize (palm detection),
Clip, GlobalAveragePool, Squeeze, Gemm and Sigmoid (hand landmarks),
ReduceMean (``slim_160_latest.onnx``), AveragePool
(``landmarks_68_pfld.onnx``) and Constant (``mobilefacenet.onnx``). Each op
follows the JAX package's semantics in zaru_tpu/onnx/ops.py: ``_conv`` :219
with ``_conv_pads`` :205 (explicit pads, SAME_UPPER, SAME_LOWER and VALID),
``_max_pool`` :328 and ``_avg_pool`` :342 with ``_pool_pads`` :268 and
``_pool_output`` :289, ``_pad`` :420, ``_prelu`` :72, ``_reshape`` :440,
``_transpose`` :463, ``_concat`` :472, ``_sigmoid`` :78, ``_clip`` :115,
``_global_avg_pool`` :355, ``_reduce_mean`` :407 with ``_reduce`` :360,
``_squeeze`` :480, ``_constant`` :565, ``_resize`` :573 (its two exact
configurations) and ``_gemm`` :656. A graph with any other op is refused
when it is loaded.

The parameters are the graph's float initializers, keyed by their ONNX
names exactly as zaru_tpu/onnx/importer.py:109-136 keys them: a float
initializer read only by a structural input slot (Resize ``roi`` and
``scales``, Upsample ``scales``, Pad ``constant_value``) is no parameter,
and other initializers (shape vectors) stay numpy constants as well. A
Constant node is evaluated when the module is built: an integer value, or
a float value read only through a slot that takes a static value (a shape,
pads, a Clip bound), joins the numpy constants as an initializer would; any
other float value becomes a device tensor that is no parameter (JAX keeps
Constant outputs out of its params as well). The
graphs are exported at batch 1 and run here at batch B: a Reshape's leading
1 is read as the batch axis, as the JAX cascade's ``vmap`` over streams has
it, a Resize keeps the batch and takes only the spatial sizes, and a
Squeeze never drops the batch axis.

**Stage plan.** When a module is built it finds the maximal chains of
stride-1 BlazeBlocks (:func:`find_stages`): a depthwise 3×3 ``Conv``
(``group == C``, stride 1, pads 1) → a 1×1 ``Conv`` C→C → an ``Add`` with
the depthwise conv's input → ``PRelu`` or ``Relu``, every intermediate read
by that one consumer only. :meth:`OnnxModule.forward` runs each chain as one
``ops.cnn_stage.fused_blocks`` call (the stage kernel on CUDA, the plain
per-op chain on the CPU) and every other node one by one. The packed stage
weights are built from the parameters at construction and again by
:meth:`OnnxModule.load_params`.

The other convolutions stay ``F.conv2d`` (cuDNN on the GPU), as the JAX
package left them to XLA. cuDNN runs f32 convolutions in TF32 by default,
which keeps about three decimal digits and breaks the repo's CNN bar
(``atol = 1e-3·max(1,|out|max)``, ``rtol = 2e-3``), so :meth:`forward`
turns TF32 off around them, and pins f32 matrix products (Gemm) to full
f32 whatever ``torch.set_float32_matmul_precision`` the caller set.

**Compute dtype.** ``compute_dtype=torch.bfloat16`` runs the network body
in bf16, as ``compute_dtype=jnp.bfloat16`` does in the JAX importer
(importer.py:178-184, :223-228): float graph inputs and a cast copy of the
parameters enter in bf16, every op runs in its input's dtype, and outputs
of that dtype leave as f32. The parameters themselves stay f32 (so
:meth:`OnnxModule.params`, :meth:`OnnxModule.load_params` and
``weights.params_from_jax`` are those of an f32 module); the cast copy is
made when the module is built and again by :meth:`OnnxModule.load_params`.
A float Constant stays f32 as JAX's numpy constant does, so what it meets
is promoted to f32 as in JAX. Two ops follow JAX's rounding in bf16 only:

- Conv adds its bias after the convolution, rounded to bf16 first
  (ops.py:260-264); ``F.conv2d`` with the bias would add it before its one
  rounding, which differs from JAX in a quarter of the outputs. In f32 the
  bias stays fused, so f32 modules are unchanged bit for bit;
- Gemm's product is rounded before ``alpha`` and ``beta · c`` (ops.py:665,
  as in f32), accumulated in f32: :meth:`forward` turns cuBLAS's reduced-
  precision bf16 reduction off around it (JAX asks for f32 accumulation)
  and restores the caller's setting afterwards.

A bf16 module builds no stage plan: the stage kernel
(``csrc/blaze_stage.cu``) is f32 by design, and JAX's bf16 path runs its
convolutions in XLA (``cnn_stage.fused_blocks`` has no caller in
``zaru_tpu/``). The choice is made once, when the module is built; an f32
module on CUDA launches the stage kernel or raises, as before.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cnn_stage
from .proto import OnnxModel, OnnxNode

__all__ = ["OnnxModule", "SUPPORTED_OPS", "Stage", "find_stages"]


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
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
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


def _reduce_mean(node, vals):
    """Means over ``axes`` (an attribute before opset 18, an input from opset
    18; none or an empty input: every axis, or with ``noop_with_empty_axes``
    the input itself), one axis at a time in ascending order as ops.py:360
    reduces them; ``keepdims`` (default 1). The batch axis is never
    reduced: the graphs run batched."""
    x = vals[0]
    axes = node.attrs.get("axes")
    if axes is None and len(vals) > 1 and vals[1] is not None:
        axes = np.asarray(vals[1]).tolist()
    if axes is not None and len(axes) == 0:
        if node.attrs.get("noop_with_empty_axes", 0):
            return x
        axes = None
    axes = sorted({int(a) % x.ndim for a in (range(x.ndim) if axes is None else axes)})
    if 0 in axes:
        raise NotImplementedError(f"ReduceMean node {node.name!r}: reduces the batch axis")
    out = x
    for ax in axes:
        out = out.mean(dim=ax, keepdim=True)
    if not node.attrs.get("keepdims", 1):
        out = out.reshape([s for i, s in enumerate(out.shape) if i not in axes])
    return out


def _pad(node, vals):
    x = vals[0]
    pads = node.attrs.get("pads")
    if pads is None:
        pads = np.asarray(vals[1]).tolist()
    value = node.attrs.get("value", 0.0)
    if len(vals) > 2 and vals[2] is not None:
        value = float(np.asarray(vals[2]))
    mode = node.attrs.get("mode", "constant")
    if mode != "constant":
        raise NotImplementedError(f"Pad node {node.name!r}: mode {mode!r}")
    rank = x.ndim
    flat = []
    for i in reversed(range(rank)):  # F.pad lists the last axis first
        flat += [int(pads[i]), int(pads[i + rank])]
    return F.pad(x, flat, value=value)


def _reshape(node, vals):
    x = vals[0]
    shape = node.attrs.get("shape")
    if shape is None:
        shape = np.asarray(vals[1]).tolist()
    shape = [int(s) for s in shape]
    if not node.attrs.get("allowzero", 0):
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    if shape and shape[0] == 1 and x.shape[0] != 1:
        shape[0] = x.shape[0]  # the batch-1 graph's leading axis is the batch
    return torch.reshape(x, shape)


def _transpose(node, vals):
    x = vals[0]
    perm = node.attrs.get("perm") or list(reversed(range(x.ndim)))
    return x.permute(*perm)


def _concat(node, vals):
    return torch.cat(vals, dim=node.attrs["axis"])


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
        bounds = [None if v is None else torch.as_tensor(v, dtype=x.dtype, device=x.device) for v in bounds]
    return torch.clamp(x, *bounds)


def _squeeze(node, vals):
    x = vals[0]
    axes = node.attrs.get("axes")
    if axes is None and len(vals) > 1 and vals[1] is not None:
        axes = np.asarray(vals[1]).tolist()
    if axes is None:  # every size-1 axis but the batch
        axes = [i for i in range(1, x.ndim) if x.shape[i] == 1]
    axes = sorted({int(a) % x.ndim for a in axes})
    if 0 in axes:
        raise NotImplementedError(f"Squeeze node {node.name!r}: squeezes the batch axis")
    return x.reshape([s for i, s in enumerate(x.shape) if i not in axes])


def _resize(node, vals):
    """Bilinear with half-pixel centres, the configuration of the JAX
    handler that ``jax.image.resize`` computes exactly (ops.py:604-616). The
    target size comes from ``sizes`` or else ``scales`` (``floor(scale ·
    dim)``); only its spatial part is taken, the batch is the input's."""
    x = vals[0]
    mode = node.attrs.get("mode", "nearest")
    coord = node.attrs.get("coordinate_transformation_mode", "half_pixel")
    sizes = None
    if len(vals) > 3 and vals[3] is not None and np.size(vals[3]) > 0:
        sizes = [int(s) for s in np.asarray(vals[3]).tolist()]
    elif len(vals) > 2 and vals[2] is not None and np.size(vals[2]) > 0:
        scales = np.asarray(vals[2]).tolist()
        sizes = [int(np.floor(float(s) * d + 1e-7)) for s, d in zip(scales, x.shape)]
    if sizes is None:
        raise ValueError(f"Resize node {node.name!r}: no static sizes/scales")
    if x.ndim != 4 or mode != "linear" or coord not in ("half_pixel", "pytorch_half_pixel"):
        raise NotImplementedError(
            f"Resize node {node.name!r}: only 2-D linear half_pixel, got mode={mode!r} coord={coord!r}"
        )
    if coord == "pytorch_half_pixel" and 1 in sizes[2:]:
        raise ValueError(f"Resize node {node.name!r}: pytorch_half_pixel with an output dim of 1")
    # Channels-last: PyTorch's NCHW bilinear kernel on CUDA runs one thread
    # per output pixel over every image and channel, which is slow at a
    # small spatial size and a large batch.
    x = x.contiguous(memory_format=torch.channels_last)
    h, w = x.shape[2:]
    H, W = sizes[2:]
    if x.dtype != torch.float32 and (h, w) != (H, W):
        # jax.image.resize contracts one axis at a time (one einsum, in the
        # order of least work, the height first on a tie) and rounds to bf16
        # in between; F.interpolate computes both axes before its one
        # rounding.
        x = F.interpolate(x, size=(H, w) if H * w * (h + W) <= h * W * (w + H) else (h, W),
                          mode="bilinear", align_corners=False)
    return F.interpolate(x, size=sizes[2:], mode="bilinear", align_corners=False).contiguous()


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
    "PRelu": lambda node, vals: torch.where(vals[0] < 0, vals[1] * vals[0], vals[0]),
    "Add": lambda node, vals: vals[0] + vals[1],
    "Pad": _pad,
    "MaxPool": _max_pool,
    "Transpose": _transpose,
    "Reshape": _reshape,
    "Concat": _concat,
    "Resize": _resize,
    "Clip": _clip,
    "GlobalAveragePool": lambda node, vals: vals[0].mean(dim=tuple(range(2, vals[0].ndim)), keepdim=True),
    "Squeeze": _squeeze,
    "Gemm": _gemm,
    "Sigmoid": lambda node, vals: torch.sigmoid(vals[0]),
    "AveragePool": _avg_pool,
    "ReduceMean": _reduce_mean,
}
SUPPORTED_OPS = frozenset(_OPS) | {"Constant"}
# Input slots whose float initializer is structural, never a parameter
# (zaru_tpu/onnx/importer.py:109-123).
_FLOAT_STATIC_SLOTS = frozenset({("Resize", 1), ("Resize", 2), ("Upsample", 1), ("Pad", 2)})
# Input slots whose value an op reads on the host (a shape, pads, a bound,
# axes): a float Constant read only through these stays numpy.
_HOST_SLOTS = _FLOAT_STATIC_SLOTS | {
    ("Reshape", 1), ("Pad", 1), ("Clip", 1), ("Clip", 2), ("Squeeze", 1), ("ReduceMean", 1), ("Resize", 3),
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


@dataclass(frozen=True)
class Stage:
    """A chain of BlazeBlocks: its input and output value names, its channel
    count, each block's initializer names (``dw_w``, ``dw_b``, ``pw_w``,
    ``pw_b``, ``alpha``; ``alpha`` is None for a ReLU) and the indices of its
    nodes in the graph."""

    input: str
    output: str
    channels: int
    blocks: tuple
    nodes: tuple


def _block_at(nodes, i, consumers, inits):
    """The BlazeBlock whose depthwise conv is ``nodes[i]``, as ``(block
    names, node indices, output name)``, or None."""
    dw = nodes[i]
    if dw.op_type != "Conv" or len(dw.inputs) != 3:
        return None
    x, w, b = dw.inputs
    wt = inits.get(w)
    if wt is None or wt.ndim != 4 or b not in inits:
        return None
    C = wt.shape[0]
    a = dw.attrs
    if (wt.shape != (C, 1, 3, 3) or a.get("group") != C or a.get("pads") != [1, 1, 1, 1]
            or a.get("auto_pad", "NOTSET") != "NOTSET"
            or a.get("strides", [1, 1]) != [1, 1] or a.get("dilations", [1, 1]) != [1, 1]):
        return None

    def only(name, op):
        cs = consumers.get(name, [])
        return cs[0] if len(cs) == 1 and cs[0] >= 0 and nodes[cs[0]].op_type == op else None

    j = only(dw.outputs[0], "Conv")
    if j is None:
        return None
    pw = nodes[j]
    a = pw.attrs
    pwt = inits.get(pw.inputs[1])
    if (len(pw.inputs) != 3 or pw.inputs[0] != dw.outputs[0] or pwt is None
            or pwt.shape != (C, C, 1, 1) or pw.inputs[2] not in inits
            or a.get("group", 1) != 1 or any(a.get("pads") or [])
            or a.get("auto_pad", "NOTSET") not in ("NOTSET", "VALID")
            or a.get("strides", [1, 1]) != [1, 1]):
        return None
    k = only(pw.outputs[0], "Add")
    if k is None or sorted(nodes[k].inputs) != sorted([x, pw.outputs[0]]):
        return None
    add_out = nodes[k].outputs[0]
    act = only(add_out, "PRelu")
    if act is not None:
        slope = nodes[act].inputs[1]
        if nodes[act].inputs[0] != add_out or slope not in inits or inits[slope].size != C:
            return None
    else:
        act = only(add_out, "Relu")
        if act is None:
            return None
        slope = None
    names = {"dw_w": w, "dw_b": b, "pw_w": pw.inputs[1], "pw_b": pw.inputs[2], "alpha": slope}
    return names, (i, j, k, act), nodes[act].outputs[0]


def find_stages(model: OnnxModel) -> list[Stage]:
    """The graph's maximal chains of BlazeBlocks (see the module docstring).
    A block output read by anything but the next block (or a graph output)
    ends its chain."""
    g = model.graph
    nodes = g.nodes
    consumers: dict[str, list[int]] = {}
    for i, n in enumerate(nodes):
        for name in n.inputs:
            consumers.setdefault(name, []).append(i)
    for vi in g.outputs:
        consumers.setdefault(vi.name, []).append(-1)
    stages, taken = [], set()
    for i in range(len(nodes)):
        if i in taken:
            continue
        found = _block_at(nodes, i, consumers, g.initializers)
        if found is None:
            continue
        names, idx, out = found
        x = nodes[i].inputs[0]
        blocks, node_idx = [names], list(idx)
        while True:
            nxt = None
            cs = consumers.get(out, [])
            if len(cs) == 2 and -1 not in cs:
                for c in cs:
                    f = _block_at(nodes, c, consumers, g.initializers)
                    if f is not None and set(cs) == {c, f[1][2]}:
                        nxt = f
            if nxt is None:
                break
            blocks.append(nxt[0])
            node_idx += nxt[1]
            out = nxt[2]
        taken.update(node_idx)
        C = g.initializers[blocks[0]["dw_w"]].shape[0]
        stages.append(Stage(x, out, C, tuple(blocks), tuple(node_idx)))
    return stages


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
    module docstring); None is f32."""

    def __init__(self, model: OnnxModel, device: torch.device, output_subset=None, compute_dtype=None):
        super().__init__()
        self.device = device
        if compute_dtype not in (None, torch.bfloat16):
            raise NotImplementedError(f"compute_dtype {compute_dtype}: only torch.bfloat16 or None (f32)")
        self.compute_dtype = compute_dtype
        g = model.graph
        unsupported = sorted({n.op_type for n in g.nodes} - SUPPORTED_OPS)
        if unsupported:
            raise NotImplementedError(
                f"model {g.name!r} uses ONNX ops the port does not run: {unsupported}"
            )
        self.nodes = g.nodes
        self._attr_of: dict[str, str] = {}
        self._static: dict[str, np.ndarray] = {}
        static_floats = _float_static_names(g.nodes)
        for i, (name, arr) in enumerate(g.initializers.items()):
            if arr.dtype in (np.float32, np.float16, np.float64) and name not in static_floats:
                attr = f"p{i}"
                self._attr_of[name] = attr
                t = torch.tensor(np.asarray(arr, np.float32), device=device)
                self.register_parameter(attr, nn.Parameter(t, requires_grad=False))
            else:
                self._static[name] = arr
        host_reads: dict[str, bool] = {}
        for n in g.nodes:
            for idx, name in enumerate(n.inputs):
                if name:
                    host_reads[name] = host_reads.get(name, True) and (n.op_type, idx) in _HOST_SLOTS
        self._const_attr: dict[str, str] = {}
        for i, n in enumerate(g.nodes):
            if n.op_type == "Constant":
                arr = _constant_value(n)
                if arr.dtype.kind == "f" and not host_reads.get(n.outputs[0], True):
                    self._const_attr[n.outputs[0]] = f"c{i}"
                    self.register_buffer(f"c{i}", torch.tensor(arr, dtype=torch.float32, device=device),
                                         persistent=False)
                else:
                    self._static[n.outputs[0]] = arr
        self.input_info = [vi for vi in g.inputs if vi.name not in g.initializers]
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
        self.stages = [] if compute_dtype else find_stages(model)
        self._stage_at = {st.nodes[0]: st for st in self.stages}
        self._in_stage = {i for st in self.stages for i in st.nodes}
        self._derive_weights()

    @torch.no_grad()
    def _derive_weights(self) -> None:
        """The stage kernel's packed weights and, in bf16, the parameters'
        cast copy, from the current parameters."""
        params = self.params()
        self._compute_params = (
            {k: v.to(self.compute_dtype) for k, v in params.items()} if self.compute_dtype else params
        )
        self._packed = {
            st.nodes[0]: cnn_stage.pack_blocks(
                [{k: None if v is None else params[v] for k, v in b.items()} for b in st.blocks],
                st.channels,
            )
            for st in self.stages
        }

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
        """Every value the selected outputs depend on, by name (a chain's
        inner values are not computed), for ``inputs``."""
        if len(inputs) != len(self.input_info):
            raise ValueError(f"expected {len(self.input_info)} inputs, got {len(inputs)}")
        dtype = self.compute_dtype
        if dtype:
            inputs = [x.to(dtype) if x.is_floating_point() else x for x in inputs]
        env: dict = dict(self._static)
        env.update(self._compute_params)
        env.update((name, getattr(self, attr)) for name, attr in self._const_attr.items())
        env.update((vi.name, x) for vi, x in zip(self.input_info, inputs))
        with _full_precision():
            for i, node in enumerate(self.nodes):
                if i not in self._live:
                    continue
                st = self._stage_at.get(i)
                if st is not None:
                    x = env[st.input]
                    env[st.output] = cnn_stage.fused_blocks(
                        x, self._packed[i], x.shape[2], x.shape[3], st.channels
                    )
                elif i not in self._in_stage and node.op_type != "Constant":
                    vals = [env[n] if n else None for n in node.inputs]
                    env[node.outputs[0]] = _OPS[node.op_type](node, vals)
        return env

    def forward(self, *inputs: torch.Tensor) -> list[torch.Tensor]:
        env = self.activations(*inputs)
        outs = [env[n] for n in self.output_names]
        if self.compute_dtype:
            outs = [o.float() if o.dtype == self.compute_dtype else o for o in outs]
        return outs
