"""What the readers of the program's fused bottleneck chains share.

- :func:`chains`: a model file's maximal chains of stride-1 residual
  bottleneck blocks, each a 1×1 convolution from C to C/2 channels, PRelu,
  a depthwise 3×3 convolution (stride 1, padding 1), a 1×1 convolution back
  to C, an Add with the block's input and PRelu, and each chain's size
  ``(C, H, W, blocks)``, found in the file by the benchmark itself;
- :func:`block_ops`: a block's operations a frame, by the rule of
  :mod:`benchmark.work.networks` (a multiply-add 2, a bias, PRelu's
  multiply and the Add 1 an output element): ``H·W·C·(2·C + 13.5)``;
- :func:`bound_seconds`: the least time of the chains the profiled steps
  ran, per chain and frame the larger of its operations over the float32
  peak and its input read once plus its output written once (float32) over
  the memory bandwidth;
- :data:`SPAN`: the program's span around each chain, whose device time
  :func:`benchmark.harness.spans.device_seconds` reads.
"""

from __future__ import annotations

import functools
from pathlib import Path

from ..work.networks import _shapes

__all__ = ["SPAN", "block_ops", "bound_seconds", "chains"]

SPAN = "zaru.net.bottleneck"


def block_ops(c: int, h: int, w: int) -> int:
    """Operations of one bottleneck block of ``c`` channels on one frame."""
    return h * w * c * (4 * c + 27) // 2


def _block(g, i, consumers):
    """The block whose first 1×1 convolution is node ``i``: ``(input,
    output, C)``."""
    nodes, init = g.nodes, g.host

    def only(name, op):
        cs = consumers.get(name, [])
        return nodes[cs[0]] if len(cs) == 1 and nodes[cs[0]].op_type == op else None

    def conv(n, shape, group=1, pads=None):
        a = n.attrs
        w = init.get(n.inputs[1]) if n.op_type == "Conv" and len(n.inputs) == 3 else None
        return (w is not None and w.shape == shape and a.get("group", 1) == group
                and a.get("strides", [1, 1]) == [1, 1]
                and (a.get("pads") == pads if pads else not any(a.get("pads") or [])))

    c1 = nodes[i]
    w1 = init.get(c1.inputs[1]) if c1.op_type == "Conv" and len(c1.inputs) == 3 else None
    if w1 is None or w1.ndim != 4 or w1.shape[1] % 2:
        return None
    c = w1.shape[1]
    m = c // 2
    if not conv(c1, (m, c, 1, 1)):
        return None
    p1 = only(c1.outputs[0], "PRelu")
    dw = p1 and only(p1.outputs[0], "Conv")
    if dw is None or not conv(dw, (m, 1, 3, 3), m, [1, 1, 1, 1]):
        return None
    c2 = only(dw.outputs[0], "Conv")
    if c2 is None or not conv(c2, (c, m, 1, 1)):
        return None
    add = only(c2.outputs[0], "Add")
    if add is None or sorted(add.inputs) != sorted([c1.inputs[0], c2.outputs[0]]):
        return None
    p2 = only(add.outputs[0], "PRelu")
    if p2 is None:
        return None
    return c1.inputs[0], p2.outputs[0], c


@functools.lru_cache(maxsize=None)
def chains(path: str | Path) -> tuple:
    """``((C, H, W, blocks), ...)``: the graph's maximal bottleneck chains
    at batch 1; a block's output read by the next block's first convolution
    and its Add, and by nothing else, continues a chain."""
    g, shapes = _shapes(str(path))
    consumers = {}
    for i, n in enumerate(g.nodes):
        for name in n.inputs:
            consumers.setdefault(name, []).append(i)
    blocks = [b for b in (_block(g, i, consumers) for i in range(len(g.nodes))) if b is not None]
    after = {b[0]: b for b in blocks if len(consumers.get(b[0], [])) == 2}  # a block its input's one reader
    outputs = {b[1] for b in blocks}
    found = []
    for start, out, c in blocks:
        if start in outputs and start in after:
            continue  # not the head of its chain
        n = 1
        while out in after:
            _, out, c = after[out]
            n += 1
        _, _, h, w = shapes[start]
        found.append((c, h, w, n))
    return tuple(found)


def bound_seconds(run, profiled=None) -> float:
    """The least time the bottleneck chains of the profiled steps (or of
    ``profiled``, entries of ``run.profiled()``) could take (see the module
    docstring)."""
    p = run.peaks

    def per_frame(path):
        return sum(max(n * block_ops(c, h, w) / p["f32_flops"], 2 * 4 * c * h * w / p["bytes_per_s"])
                   for c, h, w, n in chains(path))

    return run.over_steps(per_frame, profiled)

