"""The work of one forward pass of a model file, counted by the benchmark.

- :func:`flops`: operations a frame, by the rule of the usual FLOP
  counters: a multiply-add is 2 (Conv), a bias 1 an output element, an
  elementwise op (Add, Relu, PRelu's multiply, Clip, Sigmoid) 1 an output
  element, data movement (Pad, MaxPool, Reshape, Transpose, Concat) 0, as
  ``zaru_tpu_torch/onnx/analysis.analyze`` counts them;
- :func:`stage_chains`: the maximal chains of stride-1 BlazeBlocks, each a
  depthwise 3×3 convolution (stride 1, padding 1, one group a channel), a
  1×1 convolution from C to C channels, an Add with the block's input and a
  Relu or PRelu, and each chain's size ``(C, H, W, blocks)``. A block costs
  ``H·W·C·(2·(9 + C) + 4)`` operations a frame: both convolutions, their
  biases, the Add and the activation.

Shapes come from running the graph on the ``meta`` device at batch 1, so
nothing is computed; the counts depend on the file alone, not on what
runs it.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import torch

from ..reference.graph import Graph

__all__ = ["flops", "stage_chains", "block_ops"]

_ELEMENTWISE = {"Add", "Relu", "PRelu", "Clip", "Sigmoid"}


def block_ops(c: int, h: int, w: int) -> int:
    """Operations of one stride-1 BlazeBlock on one frame."""
    return h * w * c * (2 * (9 + c) + 4)


@functools.lru_cache(maxsize=None)
def _shapes(path: str):
    """``(nodes, {value name: shape})`` of the graph at batch 1."""
    g = Graph(path, "meta")
    shapes = {}

    def hook(node, args, out):
        shapes[node.outputs[0]] = tuple(out.shape)

    shape = tuple(d if isinstance(d, int) else 1 for d in g.input_shape)
    g(torch.empty(shape, device="meta"), hook=hook)
    shapes[g.input_name] = shape
    return g, shapes


@functools.lru_cache(maxsize=None)
def flops(path: str | Path) -> int:
    g, shapes = _shapes(str(path))
    total = 0
    for node in g.nodes:
        out = math.prod(shapes[node.outputs[0]])
        if node.op_type == "Conv":
            w = g.host[node.inputs[1]].shape
            total += 2 * out * math.prod(w[1:]) + (out if len(node.inputs) > 2 else 0)
        elif node.op_type in _ELEMENTWISE:
            total += out
    return total


def _block(g, i, consumers):
    """The block whose depthwise conv is node ``i``: ``(input, output, C)``."""
    nodes, init = g.nodes, g.host
    dw = nodes[i]
    if dw.op_type != "Conv" or len(dw.inputs) != 3:
        return None
    w = init.get(dw.inputs[1])
    a = dw.attrs
    if (w is None or w.ndim != 4 or w.shape[1:] != (1, 3, 3) or a.get("group") != w.shape[0]
            or a.get("pads") != [1, 1, 1, 1] or a.get("strides", [1, 1]) != [1, 1]):
        return None
    c = w.shape[0]

    def only(name, op):
        cs = consumers.get(name, [])
        return nodes[cs[0]] if len(cs) == 1 and nodes[cs[0]].op_type == op else None

    pw = only(dw.outputs[0], "Conv")
    if pw is None or pw.inputs[0] != dw.outputs[0]:
        return None
    pwt = init.get(pw.inputs[1])
    if pwt is None or pwt.shape != (c, c, 1, 1) or pw.attrs.get("group", 1) != 1 \
            or any(pw.attrs.get("pads") or []) or pw.attrs.get("strides", [1, 1]) != [1, 1]:
        return None
    add = only(pw.outputs[0], "Add")
    if add is None or sorted(add.inputs) != sorted([dw.inputs[0], pw.outputs[0]]):
        return None
    act = only(add.outputs[0], "PRelu") or only(add.outputs[0], "Relu")
    if act is None or act.inputs[0] != add.outputs[0]:
        return None
    return dw.inputs[0], act.outputs[0], c


@functools.lru_cache(maxsize=None)
def stage_chains(path: str | Path) -> tuple:
    """``((C, H, W, blocks), ...)``: the graph's maximal stride-1 BlazeBlock
    chains at batch 1."""
    g, shapes = _shapes(str(path))
    consumers = {}
    for i, n in enumerate(g.nodes):
        for name in n.inputs:
            consumers.setdefault(name, []).append(i)
    blocks = {}
    for i in range(len(g.nodes)):
        b = _block(g, i, consumers)
        if b is not None:
            blocks[b[0]] = b
    outputs = {b[1] for b in blocks.values()}
    chains = []
    for start, (inp, out, c) in blocks.items():
        if inp in outputs and len(consumers.get(inp, [])) == 2:
            continue  # not the head of its chain
        n = 1
        while out in blocks and len(consumers.get(out, [])) == 2:
            inp, out, c = blocks[out]
            n += 1
        _, _, h, w = shapes[start]
        chains.append((c, h, w, n))
    return tuple(chains)
