"""Graphs authored with an ONNX writer, and the JAX writer's bytes of them.

Each function takes the writer *module* (``zaru_tpu_torch.onnx.writer``, or
the JAX package's ``zaru_tpu.onnx.writer`` in the tests) and returns the
serialized model, so one definition serves both writers:

- :func:`conv_relu`: Conv 3×3 (pads 1) with bias → Relu at 1×3×8×8;
- :func:`attributes`: one node carrying every attribute type the writer
  encodes (float, int, bool, string, bytes, tensor, floats, ints);
- :func:`blaze_chain`: ``blocks`` stride-1 BlazeBlocks at ``channels``
  channels (Conv dw3×3 → Conv 1×1 → Add → PRelu), seeded weights, declared
  at batch 1: the executor plans it as one stage-kernel chain.

``fixtures/onnx_writer.npz`` keeps the JAX writer's bytes of each graph
under its name (tests/test_torch_onnx_writer.py writes it and checks the
port's writer against JAX's live; ``chip_smoke.py`` checks the port's
writer against it on a machine without JAX).
"""

from __future__ import annotations

import numpy as np

from ..assets import fixture_path

__all__ = ["FIXTURE", "GRAPHS", "attributes", "blaze_chain", "conv_relu", "stored"]

FIXTURE = "onnx_writer.npz"


def conv_relu(writer, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    w = writer.OnnxWriter(graph_name="tiny")
    w.input("x", (1, 3, 8, 8))
    w.initializer("k", rng.normal(0, 1, (4, 3, 3, 3)).astype(np.float32))
    w.initializer("b", rng.normal(0, 1, (4,)).astype(np.float32))
    w.node("Conv", ["x", "k", "b"], ["c"], kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[1, 1])
    w.node("Relu", ["c"], ["y"])
    w.output("y", (1, 4, 8, 8))
    return w.serialize()


def attributes(writer) -> bytes:
    w = writer.OnnxWriter(graph_name="attrs", opset=17)
    w.input("x", (2, 3))
    w.node(
        "Fake", ["x"], ["y"],
        f=1.5, i=-7, big=1 << 40, flag=True, s="hello", raw=b"bytes", fs=[1.0, 2.5], ints=[1, -2, 3],
        t=np.arange(6, dtype=np.float32).reshape(2, 3), ti=np.array([-1, 2], np.int64),
    )
    w.output("y", (2, 3), np.int32)
    return w.serialize()


def blaze_chain(writer, channels: int = 32, blocks: int = 3, size: int = 64, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    C = channels
    w = writer.OnnxWriter(graph_name="blaze_chain")
    w.input("x", (1, C, size, size))
    x = "x"
    for b in range(blocks):
        p = f"b{b}_"
        w.initializer(p + "dw_w", rng.normal(0, 0.3, (C, 1, 3, 3)).astype(np.float32))
        w.initializer(p + "dw_b", rng.normal(0, 0.1, (C,)).astype(np.float32))
        w.initializer(p + "pw_w", rng.normal(0, 1 / np.sqrt(C), (C, C, 1, 1)).astype(np.float32))
        w.initializer(p + "pw_b", rng.normal(0, 0.1, (C,)).astype(np.float32))
        w.initializer(p + "alpha", rng.uniform(0.05, 0.3, (C, 1, 1)).astype(np.float32))
        w.node("Conv", [x, p + "dw_w", p + "dw_b"], [p + "dw"], group=C, kernel_shape=[3, 3], pads=[1, 1, 1, 1],
               strides=[1, 1])
        w.node("Conv", [p + "dw", p + "pw_w", p + "pw_b"], [p + "pw"], kernel_shape=[1, 1], strides=[1, 1])
        w.node("Add", [x, p + "pw"], [p + "sum"])
        w.node("PRelu", [p + "sum", p + "alpha"], [p + "out"])
        x = p + "out"
    w.output(x, (1, C, size, size))
    return w.serialize()


GRAPHS = {"conv_relu": conv_relu, "attributes": attributes, "blaze_chain": blaze_chain}


def stored() -> dict[str, bytes]:
    """The JAX writer's bytes of each graph of :data:`GRAPHS`."""
    with np.load(fixture_path(FIXTURE)) as f:
        return {k: f[k].tobytes() for k in f.files}
