"""The port's ONNX executor op by op (zaru_tpu_torch.onnx) against the JAX
importer (zaru_tpu.onnx) on the CPU.

Every case is a small graph written with zaru_tpu/onnx/writer.py on seeded
numpy inputs: each case of tests/test_onnx_ops_extended.py and
tests/test_onnx_opsemantics.py, one or more for each other op of the
dialect (every attribute and opset form the port takes, host values
included: a Shape → Gather → Concat → Reshape graph and a Resize whose
sizes the host computes), Resize's shrinks and its cubic and nearest
configurations, a 48-channel BlazeBlock chain (which the stage kernel is not
built for, so the plan leaves it node by node) and a 7-block 128-channel one
(split into 5 + 2 so that every piece has a tiling).

JAX's outputs are stored with the graphs and inputs in
``zaru_tpu_torch/fixtures/onnx_dialect.npz`` (keys ``ops/*``; the fuzz and
layout tests own ``fuzz/*`` and ``layout/*``), which ``chip_smoke.py``
replays on the card; ``test_fixture_is_current`` rebuilds every graph and
input and runs JAX live on a few. Regenerate with::

    JAX_PLATFORMS=cpu python tests/test_torch_onnx_ops.py

Tolerances, each case's own (the second field of ``CASES``):

- ``exact``: comparisons, Where, the shape ops, Cast, Abs, Neg, Floor,
  Ceil, Round (half to even), Min, Max, MaxPool, the max/min reductions,
  ArgMax, nearest resizes, Sub and Mul: bit for bit;
- ``ulp:N``: transcendental and divided results within N ulp of JAX's,
  elementwise (XLA:CPU and torch call other ``exp``/``log``/``erf``);
- ``abs:X``: sums in another order (convolutions, products, normalisations,
  linear and cubic resizes), within the measured X of the output's
  magnitude, written beside each case (``atol = X·max(1, |out|max)``);
- ``cnn``: whole graphs (tests/test_torch_onnx_fuzz.py, _layout.py), the
  repo's CNN bar (tests/test_onnx_importer.py:63-66),
  ``atol = 1e-3·max(1, |out|max)`` and ``rtol = 2e-3``.
"""

import os
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "zaru_tpu_torch", "fixtures", "onnx_dialect.npz")
PREFIX = "ops/"
# Sums in another order than XLA's: convolutions and products of up to a
# few hundred terms; 2e-6 of |out|max measured at most (MatMul), held to 1e-5.
SUM_TOL = "abs:1e-5"
# Resize shrinks and cubic resizes: JAX's weights and einsum against the
# port's; 1.2e-7 measured, held to the acceptance bar of 1e-6.
RESIZE_TOL = "abs:1e-6"


def _rng(i):
    return np.random.default_rng(100 + i)


def graph(op, ins, attrs=None, n_out=1, opset=13):
    """One ``op`` node. ``ins``: per input slot, ``("in", array)`` (a graph
    input, declared at the array's shape and dtype), ``("init", array)``
    (an initializer) or None (an omitted optional input). → (bytes, graph
    input arrays)."""
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(graph_name=op, opset=opset)
    names, feeds = [], []
    for i, spec in enumerate(ins):
        if spec is None:
            names.append("")
            continue
        kind, arr = spec
        name = f"{kind}{i}"
        names.append(name)
        if kind == "in":
            w.input(name, arr.shape, arr.dtype)
            feeds.append(arr)
        else:
            w.initializer(name, arr)
    outs = [f"y{i}" for i in range(n_out)]
    w.node(op, names, outs, **(attrs or {}))
    for o in outs:
        w.output(o, ())
    return w.serialize(), feeds


def f32(rng, shape, lo=None, hi=None, scale=1.0):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return (rng.normal(0, scale, shape)).astype(np.float32)


def i64(v):
    return np.asarray(v, np.int64)


# --- the cases: name → (graph function, tolerance) -----------------------------


def _unary(op, lo=None, hi=None, attrs=None, scale=2.0, shape=(4, 5)):
    return lambda r: graph(op, [("in", f32(r, shape, lo, hi, scale))], attrs)


def _binary(op, a_lo=None, a_hi=None, b_lo=None, b_hi=None, b_shape=(4, 5)):
    return lambda r: graph(op, [("in", f32(r, (4, 5), a_lo, a_hi)), ("in", f32(r, b_shape, b_lo, b_hi))])


def _chain_graph(C, nb, hw):
    """``nb`` stride-1 BlazeBlocks (depthwise 3×3, 1×1, Add, PRelu) on
    ``[1, C, hw, hw]``, tests/test_torch_cnn_stage.py's weights."""
    from zaru_tpu.onnx.writer import OnnxWriter

    r = np.random.default_rng(C + nb)
    w = OnnxWriter(graph_name=f"chain{C}x{nb}")
    w.input("x", (1, C, hw, hw))
    cur = "x"
    for k in range(nb):
        for name, arr in (("dw", r.normal(0, 0.3, (C, 1, 3, 3))), ("dwb", r.normal(0, 0.1, C)),
                          ("pw", r.normal(0, 0.3, (C, C, 1, 1)) / np.sqrt(C / 16)), ("pwb", r.normal(0, 0.1, C)),
                          ("a", r.uniform(0.05, 0.3, (C, 1, 1)))):
            w.initializer(f"{name}{k}", arr.astype(np.float32))
        w.node("Conv", [cur, f"dw{k}", f"dwb{k}"], [f"d{k}"], kernel_shape=[3, 3], pads=[1, 1, 1, 1], group=C)
        w.node("Conv", [f"d{k}", f"pw{k}", f"pwb{k}"], [f"p{k}"], kernel_shape=[1, 1])
        w.node("Add", [cur, f"p{k}"], [f"s{k}"])
        w.node("PRelu", [f"s{k}", f"a{k}"], [f"b{k}"])
        cur = f"b{k}"
    w.output(cur, (1, C, hw, hw))
    return w.serialize(), [f32(r, (2, C, hw, hw))]


def _shape_reshape(r):
    """Shape → Gather [0, 1] → Concat [-1] → Reshape: ``[1, C, H·W]``."""
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(graph_name="shape")
    w.input("x", (1, 4, 6, 5))
    w.initializer("idx", i64([0, 1]))
    w.initializer("rest", i64([-1]))
    w.node("Shape", ["x"], ["s"])
    w.node("Gather", ["s", "idx"], ["nc"], axis=0)
    w.node("Concat", ["nc", "rest"], ["shape"], axis=0)
    w.node("Relu", ["x"], ["r"])
    w.node("Reshape", ["r", "shape"], ["y"])
    w.output("y", (1, 4, 30))
    return w.serialize(), [f32(r, (3, 4, 6, 5))]


def _host_sizes(r):
    """A Resize whose sizes the host computes from Shape: ``[N, C, 2H,
    W + 3]`` through Slice, Cast, Mul, Add, Cast and Concat."""
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(graph_name="sizes", opset=13)
    w.input("x", (1, 3, 5, 7))
    for name, arr in (("s0", i64([0])), ("s2", i64([2])), ("s3", i64([3])), ("s4", i64([4])), ("three", i64([3]))):
        w.initializer(name, arr)
    w.node("Constant", [], ["two"], value=np.asarray([2.0], np.float32))  # a float initializer would be a weight
    w.node("Shape", ["x"], ["shape"])
    w.node("Slice", ["shape", "s0", "s2"], ["nc"])
    w.node("Slice", ["shape", "s2", "s3"], ["h"])
    w.node("Slice", ["shape", "s3", "s4"], ["wd"])
    w.node("Cast", ["h"], ["hf"], to=1)
    w.node("Mul", ["hf", "two"], ["h2f"])
    w.node("Cast", ["h2f"], ["h2"], to=7)
    w.node("Add", ["wd", "three"], ["w3"])
    w.node("Concat", ["nc", "h2", "w3"], ["sizes"], axis=0)
    w.node("Resize", ["x", "", "", "sizes"], ["y"], mode="nearest", coordinate_transformation_mode="asymmetric",
           nearest_mode="floor")
    w.output("y", (1, 3, 10, 10))
    return w.serialize(), [f32(r, (3, 3, 5, 7))]


def _resize(shape, sizes, mode, coord="half_pixel", nearest="floor", opset=13):
    roi = np.zeros((0,), np.float32)
    attrs = {"mode": mode, "coordinate_transformation_mode": coord, "nearest_mode": nearest}
    return lambda r: graph("Resize", [("in", f32(r, shape)), ("init", roi), ("init", roi), ("init", i64(sizes))],
                           attrs, opset=opset)


def _conv(auto_pad=None, pads=None):
    attrs = {"kernel_shape": [2, 2], "strides": [1, 1]}
    if auto_pad:
        attrs["auto_pad"] = auto_pad
    if pads:
        attrs["pads"] = pads
    return lambda r: graph("Conv", [("in", np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5)),
                                    ("init", np.ones((1, 1, 2, 2), np.float32))], attrs)


def _conv_transpose(stride, pad, extra=None):
    def build(r):
        attrs = {"strides": [stride, stride], "pads": [pad, pad, pad, pad], **(extra or {})}
        return graph("ConvTranspose", [("in", f32(r, (1, 3, 7, 7))), ("init", f32(r, (3, 4, 3, 3))),
                                       ("init", f32(r, (4,)))], attrs)
    return build


def _div_constant(r):
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(graph_name="div")
    w.input("x", (4, 50))
    w.node("Constant", [], ["c"], value=np.asarray([3.0, 7.0, 0.3, 10.0], np.float32).reshape(4, 1))
    w.node("Div", ["x", "c"], ["y"])
    w.output("y", (4, 50))
    return w.serialize(), [f32(r, (4, 50), scale=10.0)]


def _div_scalar(kind):
    """``x / c`` by a 0-d divisor: a Constant's ``value_float`` or 0-d
    ``value`` (host values, as JAX's constants), or a 0-d initializer (a
    parameter in both)."""
    def build(r):
        from zaru_tpu.onnx.writer import OnnxWriter

        w = OnnxWriter(graph_name="div")
        w.input("x", (4, 50))
        if kind == "value_float":
            w.node("Constant", [], ["c"], value_float=255.0)
        elif kind == "value":
            w.node("Constant", [], ["c"], value=np.asarray(0.3, np.float32))
        else:
            w.initializer("c", np.asarray(7.0, np.float32))
        w.node("Div", ["x", "c"], ["y"])
        w.output("y", (4, 50))
        return w.serialize(), [f32(r, (4, 50), scale=100.0)]
    return build


def _div_host(r):
    """``x / float(H)``, ``H`` from Shape → Gather → Cast: a divisor the host
    computes at each call."""
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(graph_name="div_host")
    w.input("x", (1, 3, 5, 7))
    w.initializer("two", i64(2))
    w.node("Shape", ["x"], ["s"])
    w.node("Gather", ["s", "two"], ["h"], axis=0)
    w.node("Cast", ["h"], ["hf"], to=1)
    w.node("Div", ["x", "hf"], ["y"])
    w.output("y", (1, 3, 5, 7))
    return w.serialize(), [f32(r, (3, 3, 5, 7), scale=10.0)]


def _round(r):
    halves = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, -3.5, 0.49999997, 2.5000002], np.float32)
    return graph("Round", [("in", np.concatenate([halves, f32(r, (30,), scale=4.0)]))])


CASES = {
    # tests/test_onnx_ops_extended.py
    "Abs": (_unary("Abs"), "exact"),
    "Floor": (_unary("Floor"), "exact"),
    "Ceil": (_unary("Ceil"), "exact"),
    "Log": (_unary("Log", 1.0, 6.0), "ulp:2"),
    # exp(x) − 1 cancels near 0: the H100's expf, 1 ulp from XLA's, is 16384
    # ulps of a −3.8e-5 result there, 6e-8 absolute (the CPU's: 0); held to
    # 2 ulp of 1.0, absolute.
    "Elu": (_unary("Elu", attrs={"alpha": 1.0}, scale=1.0, shape=(8,)), "abs:2.4e-7"),
    # erfc and three products, cancelling where erfc is small: 3e-8 absolute
    # measured (4 ulps of a small result); held to 2 ulp of 1.0, absolute.
    "Gelu": (_unary("Gelu", scale=1.0, shape=(8,)), "abs:2.4e-7"),
    "Greater": (lambda r: graph("Greater", [("in", np.asarray([1.0, 2.0, 3.0], np.float32)),
                                            ("init", np.asarray([2.0, 2.0, 2.0], np.float32))]), "exact"),
    "Equal": (lambda r: graph("Equal", [("in", np.asarray([1.0, 2.0, 3.0], np.float32)),
                                        ("init", np.asarray([2.0, 2.0, 2.0], np.float32))]), "exact"),
    "Where": (lambda r: graph("Where", [("in", np.asarray([False, False, True])),
                                        ("in", np.asarray([1.0, 2.0, 3.0], np.float32)),
                                        ("in", np.asarray([2.0, 2.0, 2.0], np.float32))]), "exact"),
    "Expand": (lambda r: graph("Expand", [("in", np.asarray([[1.0], [2.0]], np.float32)), ("init", i64([2, 3]))]),
               "exact"),
    "Tile": (lambda r: graph("Tile", [("in", np.asarray([[1.0], [2.0]], np.float32)), ("init", i64([2, 2]))]),
             "exact"),
    "ReduceMax axes [1]": (lambda r: graph("ReduceMax", [("in", f32(r, (3, 4)))], {"axes": [1], "keepdims": 1}),
                           "exact"),
    "ReduceMin axes [0], keepdims 0": (lambda r: graph("ReduceMin", [("in", f32(r, (3, 4)))],
                                                       {"axes": [0], "keepdims": 0}), "exact"),
    "ArgMax axis 1, keepdims 0": (lambda r: graph("ArgMax", [("in", f32(r, (3, 4)))], {"axis": 1, "keepdims": 0}),
                                  "exact"),
    "InstanceNormalization": (lambda r: graph("InstanceNormalization", [
        ("in", f32(r, (2, 3, 5, 5), scale=2.0)), ("init", f32(r, (3,), 0.9, 1.1)),
        ("init", f32(r, (3,), scale=0.1))], {"epsilon": 1e-5}), SUM_TOL),
    **{f"ConvTranspose stride {s} pad {p}": (_conv_transpose(s, p), SUM_TOL)
       for s, p in ((1, 0), (2, 0), (2, 1), (1, 1))},
    "Resize linear half_pixel up": (_resize((1, 2, 4, 4), (1, 2, 8, 8), "linear"), RESIZE_TOL),
    "Resize nearest asymmetric floor": (_resize((1, 2, 4, 4), (1, 2, 8, 8), "nearest", "asymmetric"), "exact"),
    "Resize linear pytorch_half_pixel": (_resize((1, 2, 4, 4), (1, 2, 8, 8), "linear", "pytorch_half_pixel"),
                                         RESIZE_TOL),
    "Resize linear align_corners (warns)": (_resize((1, 2, 4, 4), (1, 2, 8, 8), "linear", "align_corners"),
                                            RESIZE_TOL),
    # tests/test_onnx_opsemantics.py
    "Conv SAME_LOWER": (_conv(auto_pad="SAME_LOWER"), SUM_TOL),
    "Conv pads [1, 1, 0, 0]": (_conv(pads=[1, 1, 0, 0]), SUM_TOL),
    "Conv SAME_UPPER": (_conv(auto_pad="SAME_UPPER"), SUM_TOL),
    "MaxPool SAME_UPPER": (lambda r: graph("MaxPool", [("in", np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5))],
                                           {"kernel_shape": [2, 2], "strides": [2, 2], "auto_pad": "SAME_UPPER"}),
                           "exact"),
    "Softmax opset 11": (lambda r: graph("Softmax", [("in", f32(r, (2, 3, 4)))], opset=11), "ulp:4"),
    "Softmax opset 13": (lambda r: graph("Softmax", [("in", f32(r, (2, 3, 4)))], opset=13), "ulp:4"),
    "Resize fractional scale floors": (lambda r: graph("Resize", [
        ("in", np.arange(49, dtype=np.float32).reshape(1, 1, 7, 7)), ("init", np.zeros((0,), np.float32)),
        ("init", np.asarray([1, 1, 0.5, 0.5], np.float32))],
        {"mode": "nearest", "coordinate_transformation_mode": "asymmetric", "nearest_mode": "floor"}), "exact"),
    "Flatten axis -1": (lambda r: graph("Flatten", [("in", np.arange(24, dtype=np.float32).reshape(2, 3, 4))],
                                        {"axis": -1}), "exact"),
    "ReduceMean omitted axes": (lambda r: graph("ReduceMean", [("in", np.arange(12, dtype=np.float32).reshape(3, 4)),
                                                               None], {"keepdims": 0}, opset=18), SUM_TOL),
    # the rest of the dialect
    "LeakyRelu": (_unary("LeakyRelu", attrs={"alpha": 0.1}), "exact"),
    # XLA:CPU contracts alpha·x + beta into one FMA, the port rounds twice:
    # one ulp of 0.5 (6e-8 absolute, up to 5 ulps of a result near 0)
    # measured; held to 2 ulp of 1.0, absolute.
    "HardSigmoid": (_unary("HardSigmoid", scale=4.0), "abs:2.4e-7"),
    "Tanh": (_unary("Tanh"), "ulp:2"),
    "Exp": (_unary("Exp"), "ulp:2"),
    "Sqrt": (_unary("Sqrt", 0.0, 9.0), "exact"),
    "Neg": (_unary("Neg"), "exact"),
    # Two erf approximations, each within 2 ulp: 3 ulp apart measured.
    "Erf": (_unary("Erf"), "ulp:3"),
    "Sigmoid": (_unary("Sigmoid"), "ulp:2"),
    "Relu": (_unary("Relu"), "exact"),
    "Sub": (_binary("Sub"), "exact"),
    "Mul, broadcast": (_binary("Mul", b_shape=(1, 5)), "exact"),
    "Div": (_binary("Div", b_lo=0.5, b_hi=3.0), "exact"),
    # A Constant divisor is folded into JAX's program, and XLA:CPU divides by
    # it as a product with its f32 reciprocal (a third of these quotients
    # differ from a division by one ulp); the port does the same.
    "Div by a Constant": (lambda r: _div_constant(r), "exact"),
    "Div by a scalar value_float Constant": (_div_scalar("value_float"), "exact"),
    "Div by a 0-d value Constant": (_div_scalar("value"), "exact"),
    "Div by a 0-d initializer": (_div_scalar("initializer"), "exact"),
    "Div by a host-computed value": (_div_host, "exact"),
    "Pow": (_binary("Pow", 0.1, 4.0, -2.0, 2.0), "ulp:2"),
    "Min of 3": (lambda r: graph("Min", [("in", f32(r, (4, 5))), ("in", f32(r, (4, 5))), ("in", f32(r, (1, 5)))]),
                 "exact"),
    "Max of 3": (lambda r: graph("Max", [("in", f32(r, (4, 5))), ("in", f32(r, (4, 5))), ("in", f32(r, (4, 1)))]),
                 "exact"),
    "Identity": (_unary("Identity"), "exact"),
    "Cast to int32": (_unary("Cast", attrs={"to": 6}, scale=5.0), "exact"),
    "Cast to float64": (_unary("Cast", attrs={"to": 11}, scale=5.0), "exact"),
    "Clip": (lambda r: graph("Clip", [("in", f32(r, (4, 5), scale=3.0)), ("init", np.float32(-1.0)),
                                      ("init", np.float32(2.0))]), "exact"),
    "Round, half to even": (_round, "exact"),
    "Less": (_binary("Less"), "exact"),
    "Unsqueeze attr (opset 11)": (lambda r: graph("Unsqueeze", [("in", f32(r, (3, 4)))], {"axes": [0, -1]},
                                                  opset=11), "exact"),
    "Unsqueeze input (opset 13)": (lambda r: graph("Unsqueeze", [("in", f32(r, (3, 4))), ("init", i64([1]))]),
                                   "exact"),
    "Squeeze, no axes": (lambda r: graph("Squeeze", [("in", f32(r, (3, 1, 4, 1)))], opset=11), "exact"),
    "Shape": (lambda r: graph("Shape", [("in", f32(r, (3, 4, 2)))]), "exact"),
    "Gather axis 1, negative indices": (lambda r: graph("Gather", [("in", f32(r, (3, 5, 2))),
                                                                   ("init", i64([[0, -1], [4, 2]]))], {"axis": 1}),
                                        "exact"),
    "Gather, scalar index": (lambda r: graph("Gather", [("in", f32(r, (3, 5))), ("init", i64(2))], {"axis": 1}),
                             "exact"),
    "Slice attrs (opset 9)": (lambda r: graph("Slice", [("in", f32(r, (4, 6, 5)))],
                                              {"starts": [1, -4], "ends": [3, 100], "axes": [0, 1]}, opset=9),
                              "exact"),
    "Slice inputs, steps 2 and -1": (lambda r: graph("Slice", [
        ("in", f32(r, (4, 6, 5))), ("init", i64([0, -1])), ("init", i64([6, -100])), ("init", i64([1, 2])),
        ("init", i64([2, -1]))]), "exact"),
    "Split attr (opset 11)": (lambda r: graph("Split", [("in", f32(r, (2, 6, 3)))], {"axis": 1, "split": [1, 2, 3]},
                                              n_out=3, opset=11), "exact"),
    "Split input (opset 13)": (lambda r: graph("Split", [("in", f32(r, (2, 6, 3))), ("init", i64([4, 2]))],
                                               {"axis": 1}, n_out=2), "exact"),
    "Split even": (lambda r: graph("Split", [("in", f32(r, (2, 6, 3)))], {"axis": -2}, n_out=3), "exact"),
    "Upsample scales attr (opset 7)": (lambda r: graph("Upsample", [("in", f32(r, (1, 2, 3, 4)))],
                                                       {"scales": [1.0, 1.0, 2.0, 3.0], "mode": "nearest"}, opset=7),
                                       "exact"),
    "Upsample scales input, linear (opset 9)": (lambda r: graph("Upsample", [
        ("in", f32(r, (1, 2, 3, 4))), ("init", np.asarray([1, 1, 2, 2], np.float32))], {"mode": "linear"}, opset=9),
        RESIZE_TOL),
    "MatMul": (lambda r: graph("MatMul", [("in", f32(r, (3, 40))), ("init", f32(r, (40, 7)))]), SUM_TOL),
    "MatMul, batched": (lambda r: graph("MatMul", [("in", f32(r, (2, 3, 40))), ("in", f32(r, (2, 40, 7)))]), SUM_TOL),
    "BatchNormalization": (lambda r: graph("BatchNormalization", [
        ("in", f32(r, (2, 3, 4, 5), scale=2.0)), ("init", f32(r, (3,), 0.5, 1.5)), ("init", f32(r, (3,), scale=0.3)),
        ("init", f32(r, (3,), scale=0.5)), ("init", f32(r, (3,), 0.3, 2.0))], {"epsilon": 1e-3}), SUM_TOL),
    "ReduceSum axes input (opset 13)": (lambda r: graph("ReduceSum", [("in", f32(r, (2, 3, 4))),
                                                                      ("init", i64([1, -1]))], {"keepdims": 0}),
                                        SUM_TOL),
    "ReduceMax every axis": (lambda r: graph("ReduceMax", [("in", f32(r, (2, 3, 4)))]), "exact"),
    # 1 + tanh(·) cancels for negative x: 1.2e-7 absolute measured (38 ulps
    # of a small result); held to 2 ulp of 1.0, absolute.
    "Gelu tanh": (_unary("Gelu", attrs={"approximate": "tanh"}, scale=1.0, shape=(8,)), "abs:2.4e-7"),
    "ArgMax ties, keepdims": (lambda r: graph("ArgMax", [("in", np.asarray([[1, 3, 3, 0], [2, 2, 1, 2]], np.float32))],
                                              {"axis": 1}), "exact"),
    "Expand two-way": (lambda r: graph("Expand", [("in", f32(r, (3, 1))), ("init", i64([2, 1, 4]))]), "exact"),
    "Transpose default perm": (lambda r: graph("Transpose", [("in", f32(r, (2, 3, 4)))]), "exact"),
    "Concat axis -1": (lambda r: graph("Concat", [("in", f32(r, (2, 3))), ("init", f32(r, (2, 2)))], {"axis": -1}),
                       "exact"),
    "Pad": (lambda r: graph("Pad", [("in", f32(r, (1, 2, 3, 4))), ("init", i64([0, 0, 1, 0, 0, 0, 0, 2])),
                                    ("init", np.float32(0.5))]), "exact"),
    "Shape, Gather, Concat, Reshape": (_shape_reshape, "exact"),
    "Resize with host-computed sizes": (_host_sizes, "exact"),
    # Resize: shrinks (antialiased, as jax.image.resize), cubic, nearest
    **{f"Resize linear 8x8 to {h}x{w}": (_resize((1, 2, 8, 8), (1, 2, h, w), "linear"), RESIZE_TOL)
       for h, w in ((4, 4), (5, 5), (3, 7), (8, 3), (4, 16))},
    "Resize cubic up (warns)": (_resize((1, 2, 8, 8), (1, 2, 13, 11), "cubic"), RESIZE_TOL),
    "Resize cubic down (warns)": (_resize((1, 2, 8, 8), (1, 2, 5, 6), "cubic"), RESIZE_TOL),
    "Resize nearest half_pixel (warns)": (_resize((1, 2, 8, 8), (1, 2, 5, 12), "nearest", nearest="round_prefer_floor"),
                                          "exact"),
    "Resize nearest align_corners (warns)": (_resize((1, 2, 7, 5), (1, 2, 16, 3), "nearest", "align_corners",
                                                     "round_prefer_ceil"), "exact"),
    # BlazeBlock chains outside the kernel's reach or longer than a tiling allows
    "chain of 2 blocks at 48 channels": (lambda r: _chain_graph(48, 2, 12), "abs:1e-4"),
    "chain of 7 blocks at 128 channels": (lambda r: _chain_graph(128, 7, 8), "abs:1e-4"),
}
# Graphs whose inputs are batches of batch-1 images: JAX runs each image.
PER_IMAGE = {"Shape, Gather, Concat, Reshape", "Resize with host-computed sizes", "Div by a host-computed value",
             "chain of 2 blocks at 48 channels", "chain of 7 blocks at 128 channels"}
# The cases test_fixture_is_current runs JAX on.
LIVE = ["Elu", "Div by a scalar value_float Constant", "ConvTranspose stride 2 pad 1", "Resize linear 8x8 to 3x7",
        "Resize cubic down (warns)", "Resize with host-computed sizes", "chain of 2 blocks at 48 channels"]


def build(name):
    """A case's graph and inputs, drawn from a seed of its own name."""
    return CASES[name][0](_rng(zlib.crc32(name.encode())))


def jax_run(name, data, feeds):
    """JAX's outputs: the graph on its inputs, or on each image of a batch
    of batch-1 images, concatenated."""
    import jax

    from zaru_tpu.onnx import load_model

    m = load_model(data)
    fn = jax.jit(m.apply)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name in PER_IMAGE:
            runs = [fn(m.params, *(f[i:i + 1] for f in feeds)) for i in range(feeds[0].shape[0])]
            return [np.concatenate([np.asarray(r[k]) for r in runs]) for k in range(len(runs[0]))]
        return [np.asarray(o) for o in fn(m.params, *feeds)]


def case_arrays(name, data, feeds, outs) -> dict:
    """A case as the fixture stores it (chip_smoke.py reads the same keys)."""
    arrays = {f"{name}/graph": np.frombuffer(data, np.uint8), f"{name}/tol": np.asarray(CASES[name][1])}
    arrays.update({f"{name}/in{i}": f for i, f in enumerate(feeds)})
    arrays.update({f"{name}/out{i}": o for i, o in enumerate(outs)})
    return arrays


def regen(prefix, names, build_fn, jax_fn, arrays_fn):
    arrays = {}
    for name in names:
        data, feeds = build_fn(name)
        arrays.update(arrays_fn(name, data, feeds, jax_fn(name, data, feeds)))
    keep = {}
    if os.path.exists(FIXTURE):
        with np.load(FIXTURE) as f:
            keep = {k: f[k] for k in f.files if not k.startswith(prefix)}
    np.savez_compressed(FIXTURE, **keep, **{prefix + k: v for k, v in arrays.items()})
    print(f"wrote {len(names)} cases to {FIXTURE}")


def stored_cases(prefix) -> dict:
    """The stored cases under ``prefix`` (``zaru_tpu_torch.onnx.dialect_cases.load``)."""
    from zaru_tpu_torch.onnx import dialect_cases

    return dialect_cases.load(prefix)


def check(got, want, tol, what):
    """``got`` (numpy) against JAX's ``want`` at tolerance ``tol`` (see the
    module docstring), by ``zaru_tpu_torch.onnx.dialect_cases.compare``, the
    rule chip_smoke.py holds the card to; integer and bool results are
    compared by value."""
    from zaru_tpu_torch.onnx import dialect_cases

    ok, err = dialect_cases.compare(got, want, tol)
    assert ok, f"{what}: error {err} at {tol} (shapes {np.shape(got)}, {want.shape})"


def run_port(data, feeds, layout="NCHW", compute_dtype=None, device="cpu"):
    from zaru_tpu_torch.onnx import load_model

    m = load_model(data, torch.device(device), compute_dtype=compute_dtype, layout=layout)
    with torch.inference_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = m(*(torch.from_numpy(np.asarray(f)).to(device) for f in feeds))
    return m, [np.asarray(o) if isinstance(o, np.ndarray) else o.float().cpu().numpy() if o.dtype == torch.bfloat16
               else o.cpu().numpy() for o in outs]


@pytest.fixture(scope="module")
def stored():
    return stored_cases(PREFIX)


def test_fixture_is_current(stored):
    """Every stored graph and input is what the case functions make now, and JAX
    computes the stored outputs of a few of them now."""
    assert set(stored) == set(CASES)
    for name in CASES:
        data, feeds = build(name)
        c = stored[name]
        assert data == c["graph"] and c["tol"] == CASES[name][1], name
        for a, b in zip(feeds, c["ins"], strict=True):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in LIVE:
        c = stored[name]
        for got, want in zip(jax_run(name, c["graph"], c["ins"]), c["outs"], strict=True):
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(stored, name):
    c = stored[name]
    _m, outs = run_port(c["graph"], c["ins"])
    assert len(outs) == len(c["outs"])
    for i, (got, want) in enumerate(zip(outs, c["outs"])):
        check(got, want, c["tol"], f"{name}/{i}")


def test_host_values(stored):
    """Shape, and what the host computes from it, stay numpy (Shape's
    output is the per-image shape at batch 3); initializers and Constants
    read as tensors get one device copy each; a slot that must be static
    and gets a device value raises as JAX does; a divisor the host holds
    reaches the device once, as its reciprocal."""
    from zaru_tpu.onnx.writer import OnnxWriter

    from zaru_tpu_torch.onnx import load_model

    c = stored["Resize with host-computed sizes"]
    m = load_model(c["graph"], torch.device("cpu"))
    env = m.activations(torch.from_numpy(c["ins"][0]))
    for name in ("shape", "nc", "h", "hf", "h2f", "h2", "w3", "sizes"):
        assert isinstance(env[name], np.ndarray), name
    np.testing.assert_array_equal(env["shape"], [1, 3, 5, 7])
    np.testing.assert_array_equal(env["sizes"], [1, 3, 10, 10])
    assert env["h2f"].dtype == np.float32 and env["h2"].dtype == np.int64
    assert not list(m.named_buffers())
    w = OnnxWriter(opset=13)
    w.input("x", (1, 4))
    w.initializer("k", i64([1, 2]))
    w.node("Relu", ["x"], ["r"])
    w.node("Reshape", ["x", "r"], ["y"])  # a shape computed on the device
    w.output("y", (2, 2))
    with pytest.raises(ValueError, match="statically known"):
        load_model(w.serialize(), torch.device("cpu"))(torch.ones(1, 4))
    # A constant divisor is one buffer, its f32 reciprocal; a divisor the
    # host computes gets one device copy, kept for the next call.
    c = stored["Div by a scalar value_float Constant"]
    m = load_model(c["graph"], torch.device("cpu"))
    (buf,) = [b for _name, b in m.named_buffers()]
    assert buf.dtype == torch.float32 and buf.item() == np.float32(1) / np.float32(255)
    c = stored["Div by a host-computed value"]
    m = load_model(c["graph"], torch.device("cpu"))
    x = torch.from_numpy(c["ins"][0])
    first = m(x)[0]
    (copy,) = m._host_copies.values()
    assert torch.equal(m(x)[0], first) and list(m._host_copies.values()) == [copy]
    assert copy.item() == np.float32(1) / np.float32(5)


def test_resize_modes():
    """JAX's configurations: linear half-pixel and nearest asymmetric/floor
    silently, nearest, linear and cubic otherwise with JAX's warning, any
    other mode refused."""
    data, feeds = _resize((1, 2, 4, 4), (1, 2, 8, 8), "linear")(_rng(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run_port(data, feeds)
    from zaru_tpu_torch.onnx import load_model

    for mode, coord in (("cubic", "half_pixel"), ("nearest", "half_pixel"), ("linear", "align_corners")):
        data, feeds = _resize((1, 2, 4, 4), (1, 2, 8, 8), mode, coord)(_rng(0))
        with pytest.warns(UserWarning, match="approximated by jax.image.resize"):
            load_model(data, torch.device("cpu"))(torch.from_numpy(feeds[0]))
    data, feeds = _resize((1, 2, 4, 4), (1, 2, 8, 8), "lanczos")(_rng(0))
    with pytest.raises(ValueError, match="unsupported Resize"):
        run_port(data, feeds)


def test_conv_transpose_refusals():
    """ConvTranspose refuses ``group``, ``auto_pad`` and ``output_shape`` as
    JAX does."""
    for extra, match in (({"group": 3}, "grouped"), ({"auto_pad": "SAME_UPPER"}, "auto_pad"),
                         ({"output_shape": [15, 15]}, "output_shape")):
        data, feeds = graph("ConvTranspose", [("in", np.zeros((1, 3, 7, 7), np.float32)),
                                               ("init", np.ones((3, 1, 3, 3), np.float32))], extra)
        with pytest.raises(NotImplementedError, match=match):
            run_port(data, feeds)


def test_stage_plan_of_other_chains():
    """A 48-channel chain is no stage (the kernel is not built for it) and
    runs node by node; a 7-block 128-channel chain is planned as 5 + 2
    blocks; the plan is the graph's, whatever the device."""
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.ops.cnn_stage import max_blocks

    assert load_model(_chain_graph(48, 2, 12)[0], torch.device("cpu")).stages == []
    m = load_model(_chain_graph(128, 7, 8)[0], torch.device("cpu"))
    assert [len(st.blocks) for st in m.stages] == [max_blocks(128), 7 - max_blocks(128)] == [5, 2]
    assert m.stages[0].output == m.stages[1].input


def _batch_graph(op, shape, attrs=None, inits=(), opset=13):
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(opset=opset)
    w.input("x", shape)
    names = ["x"]
    for k, v in enumerate(inits):
        w.initializer(f"c{k}", v)
        names.append(f"c{k}")
    w.node(op, names, ["y"], **(attrs or {}))
    w.output("y", ())
    return w.serialize()


def test_batch_semantics():
    """A batch-1 graph at batch 3: each image's batch-1 result (the port's,
    held to JAX by the cases above), concatenated, for the ops that keep
    the batch axis; the ops that would read or move it raise."""
    from zaru_tpu_torch.onnx import load_model

    x = _rng(7).normal(size=(3, 4, 6)).astype(np.float32)
    keep = {
        "Expand": (_batch_graph("Expand", (1, 4, 1), inits=(i64([4, 6]),)), (3, 4, 1)),
        "Squeeze, no axes": (_batch_graph("Squeeze", (1, 4, 1), opset=11), (3, 4, 1)),
    }
    keep.update({name: (data, x.shape) for name, data in {
        "Flatten axis 0": _batch_graph("Flatten", (1, 4, 6), {"axis": 0}),
        "Slice axis 0, kept": _batch_graph("Slice", (1, 4, 6), inits=(i64([0, 1]), i64([5, 3]), i64([0, 2]))),
        "Slice axis 0, emptied": _batch_graph("Slice", (1, 4, 6), inits=(i64([1]), i64([5]), i64([0]))),
        "Softmax axis 1": _batch_graph("Softmax", (1, 4, 6), {"axis": 1}),
        "ReduceSum axis 2": _batch_graph("ReduceSum", (1, 4, 6), inits=(i64([2]),)),
        "Tile": _batch_graph("Tile", (1, 4, 6), inits=(i64([1, 2, 1]),)),
        "ArgMax axis 1": _batch_graph("ArgMax", (1, 4, 6), {"axis": 1}),
        "Split axis 2": _batch_graph("Split", (1, 4, 6), {"axis": 2}, inits=(i64([2, 4]),)),
        "Reshape to a leading -1, one row an image": _batch_graph("Reshape", (1, 4, 6), inits=(i64([-1, 24]),)),
        "Reshape to a leading 0": _batch_graph("Reshape", (1, 4, 6), inits=(i64([0, 24]),)),
        "Add against a size-1 axis 0": _batch_graph("Add", (1, 4, 6), inits=(np.ones((1, 4, 1), np.float32),)),
        "MatMul on the rows": _batch_graph("MatMul", (1, 4, 6), inits=(np.ones((6, 2), np.float32),)),
    }.items()})
    for name, (data, shape) in keep.items():
        m = load_model(data, torch.device("cpu"))
        xs = torch.from_numpy(_rng(8).normal(size=shape).astype(np.float32))
        got = m(xs)[0]
        want = torch.cat([m(xs[i:i + 1])[0] for i in range(3)])
        assert got.shape == want.shape and torch.equal(got, want), name
    refuse = {
        "Gather axis 0": _batch_graph("Gather", (1, 4, 6), inits=(i64([0]),)),
        "ReduceMax every axis": _batch_graph("ReduceMax", (1, 4, 6)),
        "ArgMax axis 0": _batch_graph("ArgMax", (1, 4, 6), {"axis": 0}),
        "Split axis 0": _batch_graph("Split", (1, 4, 6), {"axis": 0}, inits=(i64([1]),)),
        "Softmax axis 0": _batch_graph("Softmax", (1, 4, 6), {"axis": 0}),
        "Transpose moving axis 0": _batch_graph("Transpose", (1, 4, 6), {"perm": [1, 0, 2]}),
        "Tile of axis 0": _batch_graph("Tile", (1, 4, 6), inits=(i64([2, 1, 1]),)),
        "Expand adding an axis": _batch_graph("Expand", (1, 4, 6), inits=(i64([2, 1, 4, 6]),)),
        "Unsqueeze axis 0": _batch_graph("Unsqueeze", (1, 4, 6), inits=(i64([0]),)),
        "Concat axis 0": _batch_graph("Concat", (1, 4, 6), {"axis": 0}, inits=(np.ones((1, 4, 6), np.float32),)),
        "Reshape to a leading 2": _batch_graph("Reshape", (1, 4, 6), inits=(i64([2, -1]),)),
        "Reshape to a leading -1, several rows an image": _batch_graph("Reshape", (1, 4, 6), inits=(i64([-1, 6]),)),
        "Flatten axis 2": _batch_graph("Flatten", (1, 4, 6), {"axis": 2}),
        "Add against an axis 0 of 2": _batch_graph("Add", (1, 4, 6), inits=(np.ones((2, 1, 1), np.float32),)),
        "Add adding a leading axis": _batch_graph("Add", (1, 4, 6), inits=(np.ones((2, 1, 1, 1), np.float32),)),
        "MatMul of 2-D rows against 3-D": _batch_graph("MatMul", (1, 6), inits=(np.ones((2, 6, 3), np.float32),)),
    }
    for name, data in refuse.items():
        m = load_model(data, torch.device("cpu"))
        xs = x if len(m.input_info[0].shape) == 3 else x[:, 0]
        m(torch.from_numpy(xs[:1]))  # batch 1: JAX's graph as it is
        with pytest.raises(NotImplementedError, match="batch axis"):
            m(torch.from_numpy(xs))
    # Batched indices: into an unbatched data's axis 0 they keep the batch
    # first; along another axis they would move it.
    from zaru_tpu.onnx.writer import OnnxWriter

    idx = np.asarray([[0, 3], [2, 1], [3, 3]], np.int64)
    for axis, keeps in ((0, True), (1, False)):
        w = OnnxWriter(opset=13)
        w.input("i", (1, 2), np.int64)
        w.initializer("data", np.arange(20, dtype=np.float32).reshape(5, 4))
        w.node("Gather", ["data", "i"], ["y"], axis=axis)
        w.output("y", ())
        m = load_model(w.serialize(), torch.device("cpu"))
        if keeps:
            got = m(torch.from_numpy(idx))[0]
            assert torch.equal(got, torch.cat([m(torch.from_numpy(idx[i:i + 1]))[0] for i in range(3)]))
        else:
            m(torch.from_numpy(idx[:1]))
            with pytest.raises(NotImplementedError, match="batch axis"):
                m(torch.from_numpy(idx))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen(PREFIX, sorted(CASES), build, jax_run, case_arrays)
