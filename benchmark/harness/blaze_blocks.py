"""What the readers of the program's fused BlazeBlocks share: the blocks
whose residual is the block's input pooled or padded with zero channels,
which the program runs one launch a block.

- :func:`blocks`: a model file's such blocks, each a depthwise 3×3
  convolution of x (stride 1 or 2), a 1×1 convolution from C_in to C_out
  channels, an Add with ``Pad(x)``, ``MaxPool(x)`` or ``Pad(MaxPool(x))``
  and a Relu or PRelu, and each block's size ``(C_in, C_out, H, W, Ho,
  Wo)`` (its input's and its output's), found in the file by the benchmark
  itself;
- :func:`block_ops`: a block's operations a frame, by the rule of
  :mod:`benchmark.work.networks` (a multiply-add 2, a bias, the Add and the
  activation 1 an output element; Pad and MaxPool nothing):
  ``Ho·Wo·(19·C_in + 2·C_in·C_out + 3·C_out)``;
- :func:`block_bytes`: its input read once plus its output written once,
  float32; an input two blocks read (Face Mesh V1's last two) counts once
  for each;
- :func:`bound_seconds`: the least time of the blocks the profiled steps
  ran, per block and frame the larger of its operations over the float32
  peak and its bytes over the memory bandwidth;
- :data:`SPAN`: the program's span around each block, whose device time
  :func:`benchmark.harness.spans.device_seconds` reads.
"""

from __future__ import annotations

import functools
from pathlib import Path

from ..work.networks import _shapes

__all__ = ["SPAN", "block_bytes", "block_ops", "blocks", "bound_seconds"]

SPAN = "zaru.net.blaze_block"


def block_ops(c_in: int, c_out: int, ho: int, wo: int) -> int:
    """Operations of one block on one frame."""
    return ho * wo * (19 * c_in + 2 * c_in * c_out + 3 * c_out)


def block_bytes(c_in: int, c_out: int, h: int, w: int, ho: int, wo: int) -> int:
    """Bytes of one block on one frame: its input and its output, float32."""
    return 4 * (c_in * h * w + c_out * ho * wo)


def _block(g, i, consumers, producer):
    """The block whose depthwise convolution is node ``i``: ``(input,
    output)``, or None."""
    nodes, init = g.nodes, g.host
    dw = nodes[i]
    if dw.op_type != "Conv" or len(dw.inputs) != 3:
        return None
    w = init.get(dw.inputs[1])
    a = dw.attrs
    if (w is None or w.ndim != 4 or w.shape[1:] != (1, 3, 3) or a.get("group") != w.shape[0]
            or a.get("strides", [1, 1]) not in ([1, 1], [2, 2])):
        return None
    x = dw.inputs[0]

    def only(name, *ops):
        cs = consumers.get(name, [])
        return nodes[cs[0]] if len(cs) == 1 and nodes[cs[0]].op_type in ops else None

    pw = only(dw.outputs[0], "Conv")
    if pw is None or pw.inputs[0] != dw.outputs[0]:
        return None
    pwt = init.get(pw.inputs[1])
    if pwt is None or pwt.ndim != 4 or pwt.shape[1:] != (w.shape[0], 1, 1) or pw.attrs.get("group", 1) != 1:
        return None
    add = only(pw.outputs[0], "Add")
    if add is None or pw.outputs[0] not in add.inputs:
        return None
    src = add.inputs[1] if add.inputs[0] == pw.outputs[0] else add.inputs[0]
    for op in ("Pad", "MaxPool"):
        n = producer.get(src)
        if n is not None and n.op_type == op:
            src = n.inputs[0]
    if src != x or x in add.inputs:
        return None
    act = only(add.outputs[0], "Relu", "PRelu")
    if act is None:
        return None
    return x, act.outputs[0]


@functools.lru_cache(maxsize=None)
def blocks(path: str | Path) -> tuple:
    """``((C_in, C_out, H, W, Ho, Wo), ...)``: the graph's blocks at batch
    1, in graph order."""
    g, shapes = _shapes(str(path))
    consumers, producer = {}, {}
    for i, n in enumerate(g.nodes):
        for name in n.inputs:
            consumers.setdefault(name, []).append(i)
        for name in n.outputs:
            producer[name] = n
    found = []
    for i in range(len(g.nodes)):
        b = _block(g, i, consumers, producer)
        if b is not None:
            (_, c_in, h, w), (_, c_out, ho, wo) = shapes[b[0]], shapes[b[1]]
            found.append((c_in, c_out, h, w, ho, wo))
    return tuple(found)


def bound_seconds(run, profiled=None) -> float:
    """The least time the blocks of the profiled steps (or of ``profiled``,
    entries of ``run.profiled()``) could take (see the module docstring)."""
    p = run.peaks

    def per_frame(path):
        return sum(max(block_ops(c_in, c_out, ho, wo) / p["f32_flops"],
                       block_bytes(c_in, c_out, h, w, ho, wo) / p["bytes_per_s"])
                   for c_in, c_out, h, w, ho, wo in blocks(path))

    return run.over_steps(per_frame, profiled)

