"""What the readers of the program's fused entry blocks share: the stride-2
residual bottleneck blocks, which the program runs one launch a block.

- :func:`blocks`: a model file's such blocks, each a 2×2 stride-2
  convolution of x from C_in to M channels, a PRelu, a depthwise 3×3
  convolution (stride 1, padding 1), a 1×1 convolution from M to C_out
  channels, an Add with ``MaxPool(x)`` (2×2, stride 2) or
  ``Pad(MaxPool(x))`` and a PRelu, and each block's size ``(C_in, M,
  C_out, H, W, Ho, Wo)`` (its input's and its output's), found in the file
  by the benchmark itself;
- :func:`block_ops`: a block's operations a frame, by the rule of
  :mod:`benchmark.work.networks` (a multiply-add 2, a bias, PRelu's
  multiply and the Add 1 an output element; Pad and MaxPool nothing):
  ``Ho·Wo·(M·(8·C_in + 2) + 19·M + C_out·(2·M + 3))``;
- :func:`block_bytes`: its input read once plus its output written once,
  float32;
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

SPAN = "zaru.net.entry_block"


def block_ops(c_in: int, m: int, c_out: int, ho: int, wo: int) -> int:
    """Operations of one block on one frame."""
    return ho * wo * (m * (8 * c_in + 2) + 19 * m + c_out * (2 * m + 3))


def block_bytes(c_in: int, c_out: int, h: int, w: int, ho: int, wo: int) -> int:
    """Bytes of one block on one frame: its input and its output, float32."""
    return 4 * (c_in * h * w + c_out * ho * wo)


def _block(g, i, consumers, producer):
    """The block whose 2×2 convolution is node ``i``: ``(input, output)``,
    or None."""
    nodes, init = g.nodes, g.host

    def only(name, *ops):
        cs = consumers.get(name, [])
        return nodes[cs[0]] if len(cs) == 1 and nodes[cs[0]].op_type in ops else None

    def conv(n, src, group, stride, pads):
        a = n.attrs
        w = init.get(n.inputs[1]) if n.op_type == "Conv" and len(n.inputs) == 3 else None
        return (w is not None and w.ndim == 4 and n.inputs[0] == src and a.get("group", 1) == group
                and a.get("strides", [1, 1]) == [stride, stride]
                and list(a.get("pads") or [0, 0, 0, 0]) == pads), w

    c1 = nodes[i]
    ok, w1 = conv(c1, c1.inputs[0], 1, 2, [0, 0, 0, 0]) if c1.op_type == "Conv" else (False, None)
    if not ok or w1.shape[2:] != (2, 2):
        return None
    x, m = c1.inputs[0], w1.shape[0]
    p1 = only(c1.outputs[0], "PRelu")
    dw = p1 and only(p1.outputs[0], "Conv")
    if dw is None:
        return None
    ok, wd = conv(dw, p1.outputs[0], m, 1, [1, 1, 1, 1])
    if not ok or wd.shape != (m, 1, 3, 3):
        return None
    c2 = only(dw.outputs[0], "Conv")
    if c2 is None:
        return None
    ok, w2 = conv(c2, dw.outputs[0], 1, 1, [0, 0, 0, 0])
    if not ok or w2.shape[1:] != (m, 1, 1):
        return None
    add = only(c2.outputs[0], "Add")
    if add is None or c2.outputs[0] not in add.inputs:
        return None
    src = add.inputs[1] if add.inputs[0] == c2.outputs[0] else add.inputs[0]
    pad = producer.get(src)
    if pad is not None and pad.op_type == "Pad":
        src = pad.inputs[0]
    pool = producer.get(src)
    if pool is None or pool.op_type != "MaxPool" or pool.inputs[0] != x:
        return None
    p2 = only(add.outputs[0], "PRelu")
    return None if p2 is None else (x, p2.outputs[0])


@functools.lru_cache(maxsize=None)
def blocks(path: str | Path) -> tuple:
    """``((C_in, M, C_out, H, W, Ho, Wo), ...)``: the graph's blocks at batch
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
            found.append((c_in, g.host[g.nodes[i].inputs[1]].shape[0], c_out, h, w, ho, wo))
    return tuple(found)


def bound_seconds(run, profiled=None) -> float:
    """The least time the blocks of the profiled steps (or of ``profiled``,
    entries of ``run.profiled()``) could take (see the module docstring)."""
    p = run.peaks

    def per_frame(path):
        return sum(max(block_ops(c_in, m, c_out, ho, wo) / p["f32_flops"],
                       block_bytes(c_in, c_out, h, w, ho, wo) / p["bytes_per_s"])
                   for c_in, m, c_out, h, w, ho, wo in blocks(path))

    return run.over_steps(per_frame, profiled)

