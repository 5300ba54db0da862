"""A plain PyTorch runner of the face models' ONNX graphs, in float32.

It runs the eleven ops the BlazeFace, Face Mesh, iris and MobileFaceNet
graphs hold (Conv, Relu, PRelu, Clip, Add, Pad, MaxPool, Transpose,
Reshape, Concat, Sigmoid) node by node with ``torch.nn.functional``, at
batch ``B``: the graphs are exported at batch 1, and a Reshape's leading 1
is read as the batch. A Constant node is no step: its ``value`` is read
once, at load, as a host value usable wherever an initializer is (a
Reshape's shape, a Pad's pads, a Clip's bounds, or a float operand). Clip
takes its bounds as inputs (opset 11 on) or as ``min``/``max`` attributes,
either one absent. TF32 is off around every call, so a convolution on the
GPU keeps full float32.

``hook(node, inputs, output)``, when given, sees every node as it runs; the
benchmark's work counts read the graph through it on the ``meta`` device,
where nothing is computed.
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_wire import parse_model

__all__ = ["Graph", "full_float32"]


@contextmanager
def full_float32():
    """TF32 off for convolutions and matrix products, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _conv(node, x, w, b=None):
    a = node.attrs
    pads = a.get("pads") or [0, 0, 0, 0]
    (pt, pl), (pb, pr) = pads[:2], pads[2:]
    if (pt, pl) != (pb, pr):
        x = F.pad(x, (pl, pr, pt, pb))
        pt = pl = 0
    return F.conv2d(x, w, b, stride=a.get("strides", [1, 1]), padding=(pt, pl),
                    dilation=a.get("dilations", [1, 1]), groups=a.get("group", 1))


def _max_pool(node, x):
    a = node.attrs
    pads = a.get("pads") or [0, 0, 0, 0]
    if any(pads):
        x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]), value=float("-inf"))
    return F.max_pool2d(x, a["kernel_shape"], a.get("strides", [1, 1]))


def _pad(node, x, pads=None):
    pads = node.attrs.get("pads") if pads is None else pads
    pads = [int(p) for p in np.asarray(pads).tolist()]
    rank = x.ndim
    flat = []
    for i in reversed(range(rank)):
        flat += [pads[i], pads[i + rank]]
    return F.pad(x, flat)


def _bound(v):
    return None if v is None else float(np.asarray(v).reshape(-1)[0])


def _clip(node, x, lo=None, hi=None):
    lo = node.attrs.get("min") if lo is None else lo
    hi = node.attrs.get("max") if hi is None else hi
    if lo is None and hi is None:
        return x
    return torch.clamp(x, _bound(lo), _bound(hi))


def _reshape(node, x, shape):
    shape = [int(s) for s in np.asarray(shape).tolist()]
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    if shape[0] == 1:
        shape[0] = x.shape[0]
    return torch.reshape(x, shape)


_OPS = {
    "Conv": _conv,
    "Relu": lambda node, x: torch.relu(x),
    "PRelu": lambda node, x, s: torch.where(x < 0, s * x, x),
    "Clip": _clip,
    "Add": lambda node, a, b: a + b,
    "Sigmoid": lambda node, x: torch.sigmoid(x),
    "MaxPool": _max_pool,
    "Pad": _pad,
    "Reshape": _reshape,
    "Transpose": lambda node, x: x.permute(*node.attrs["perm"]),
    "Concat": lambda node, *xs: torch.cat(xs, dim=node.attrs["axis"]),
}
_HOST_SLOTS = {("Pad", 1), ("Reshape", 1), ("Clip", 1), ("Clip", 2)}  # inputs read as numpy values


class Graph:
    """An ONNX model file as a callable on ``[B,C,H,W]`` float32 tensors on
    ``device``; the weights are the file's float initializers and float
    Constants (float16 ones widened to float32). ``nodes`` are the graph's
    nodes but its Constants, in the file's order."""

    def __init__(self, path: str | Path, device="cpu"):
        model = parse_model(Path(path).read_bytes())
        g = model.graph
        self.nodes = [n for n in g.nodes if n.op_type != "Constant"]
        self.input_name = g.inputs[0].name
        self.input_shape = tuple(g.inputs[0].shape)
        self.output_names = [v.name for v in g.outputs]
        unknown = {n.op_type for n in self.nodes} - set(_OPS)
        if unknown:
            raise NotImplementedError(f"{path}: ops {sorted(unknown)} are not in the reference")
        self.host = dict(g.initializers)
        for n in g.nodes:
            if n.op_type == "Constant":
                if not isinstance(n.attrs.get("value"), np.ndarray):
                    raise NotImplementedError(f"{path}: Constant {n.outputs[0]!r} has no tensor value")
                self.host[n.outputs[0]] = n.attrs["value"]
        self.weights = {
            k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in self.host.items() if np.issubdtype(v.dtype, np.floating)
        }

    def __call__(self, x, hook=None) -> list[torch.Tensor]:
        vals = {self.input_name: x}
        with torch.inference_mode(), full_float32():
            for node in self.nodes:
                args = []
                for i, name in enumerate(node.inputs):
                    if not name:  # an optional input left out
                        args.append(None)
                    elif (node.op_type, i) in _HOST_SLOTS:
                        args.append(self.host[name])
                    else:
                        args.append(vals[name] if name in vals else self.weights[name])
                out = _OPS[node.op_type](node, *args)
                if hook is not None:
                    hook(node, args, out)
                vals[node.outputs[0]] = out
        return [vals[n] for n in self.output_names]
