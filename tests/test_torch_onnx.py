"""The port's ONNX executor (zaru_tpu_torch.onnx) against the JAX importer.

The two face models of the main path and the two hand models (palm
detection, hand landmarks) run at full width and batch 2 on the same seeded
inputs through ``zaru_tpu.onnx.load_model(...).apply`` and the port's
``OnnxModule``. f32 convolution sums in another order in XLA and in torch
(and ``jax.image.resize`` renormalises its edge weights where torch clamps
the coordinate), so the outputs are held to the repo's CNN bar
(tests/test_onnx_importer.py:63-66): ``atol = 1e-3·max(1, |out|max)``,
``rtol = 2e-3``. The hand models' six new ops are each held to the JAX op
handler on small random inputs: Clip and Squeeze bit for bit, Sigmoid
within 2 ulp, Resize, GlobalAveragePool and Gemm within ``OP_TOL``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zaru_tpu.assets import model_path
from zaru_tpu.onnx import load_model as jax_load
from zaru_tpu_torch.onnx import SUPPORTED_OPS, load_model, parse_model
from torch_port import one_torch_thread  # noqa: F401

MODELS = [
    "face_detection_short_range.onnx", "face_landmark.onnx",
    "palm_detection_lite.onnx", "hand_landmark_lite.onnx",
]
# Resize, GlobalAveragePool and Gemm against the JAX handlers, which sum in
# another order: 4.1e-6 (Resize, values up to 16), 1.2e-7 (pool) and 4.1e-7
# of |out|max (Gemm) measured.
OP_TOL = 1e-5


def step(node):
    """``node`` as a module plans it for these batch-2 inputs: its first
    input carries the batch."""
    from zaru_tpu_torch.onnx.executor import Step

    return Step.of(node, 13, [i == 0 for i in range(len(node.inputs))])


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name):
    data = model_path(name).read_bytes()
    jm = jax_load(data)
    tm = load_model(data, torch.device("cpu"))
    assert set(tm.params()) == set(jm.params)
    shape = [d if isinstance(d, int) else 1 for d in jm.input_info[0].shape]
    x = np.random.default_rng(0).uniform(-1, 1, [2] + shape[1:]).astype(np.float32)
    want = jax.jit(jax.vmap(lambda t: jm.apply(jm.params, t[None])))(jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)[:, 0]  # vmap over single-image calls
        g = g.detach().numpy()
        assert g.shape == w.shape
        tol = 1e-3 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=tol, rtol=2e-3)


@pytest.mark.parametrize("name", MODELS)
def test_main_path_ops_only(name):
    """The four models use only ops the executor runs (all 62 of the JAX
    registry since the rest of the dialect joined the 18)."""
    ops = {n.op_type for n in parse_model(model_path(name).read_bytes()).graph.nodes}
    assert ops <= SUPPORTED_OPS
    assert len(SUPPORTED_OPS) == 62


@pytest.mark.parametrize("name", ["palm_detection_lite.onnx", "hand_landmark_lite.onnx"])
def test_load_params_takes_jax_params(name):
    """``load_params`` takes the JAX importer's params as they are: the
    palm model's Resize ``roi``/``scales`` initializer (``roi__256``, f32 of
    shape (0,)) is structural in both packages, not a parameter. Neither
    hand model has a chain of 3×3 BlazeBlocks for the stage kernel."""
    data = model_path(name).read_bytes()
    jm = jax_load(data)
    tm = load_model(data, torch.device("cpu"))
    assert "roi__256" not in tm.params() and "roi__256" not in jm.params
    assert tm.stages == []
    scaled = {k: np.asarray(v) * np.float32(0.5) for k, v in jm.params.items()}
    tm.load_params(scaled)
    for k, v in tm.params().items():
        np.testing.assert_array_equal(v.numpy(), scaled[k], err_msg=k)


def test_hand_ops_match_jax():
    """Resize, Clip, GlobalAveragePool, Squeeze, Gemm and Sigmoid against
    the JAX op handlers (zaru_tpu/onnx/ops.py), with the attributes and
    static inputs the hand models give them, on odd sizes at batch 2."""
    from zaru_tpu.onnx import ops as jops
    from zaru_tpu.onnx.proto import OnnxNode
    from zaru_tpu_torch.onnx import executor as tex

    rng = np.random.default_rng(2)
    x = rng.normal(0, 4, size=(2, 5, 7, 6)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)

    def both(op, attrs, statics=(), tol=None):
        node = OnnxNode(op, ["x"] + [f"s{i}" for i in range(len(statics))], ["y"], attrs=dict(attrs))
        fn = getattr(jops, op_fn[op])
        # Per image, as the JAX cascade runs the batch-1 graph under vmap.
        want = np.concatenate([np.asarray(fn(node, [jx[i:i + 1], *statics], [None, *statics]))
                               for i in range(jx.shape[0])])
        got = tex._OPS[op](step(node), [tx, *statics]).numpy()
        assert got.shape == want.shape, (op, attrs)
        if tol is None:
            np.testing.assert_array_equal(got, want, err_msg=f"{op} {attrs}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{op} {attrs}")
        return got

    op_fn = {"Clip": "_clip", "GlobalAveragePool": "_global_avg_pool", "Squeeze": "_squeeze",
             "Resize": "_resize", "Sigmoid": "_sigmoid"}
    both("Clip", {"min": 0.0, "max": 6.0})
    both("Clip", {}, (np.float32(-1.0), np.float32(2.5)))
    pooled = both("GlobalAveragePool", {}, tol=OP_TOL)
    np.testing.assert_allclose(pooled, x.mean(axis=(2, 3), keepdims=True), rtol=0, atol=OP_TOL)
    # Squeeze [2,3] on the pooled [B,C,1,1] (the hand model's pattern).
    tx, jx = torch.from_numpy(pooled), jnp.asarray(pooled)
    assert both("Squeeze", {"axes": [2, 3]}).shape == (2, 5)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    roi = np.zeros((0,), np.float32)
    for size in ([1, 5, 14, 12], [1, 5, 21, 18]):  # 2x and 3x, from the batch-1 graph's sizes
        got = both("Resize", {"mode": "linear", "coordinate_transformation_mode": "half_pixel",
                              "nearest_mode": "floor"}, (roi, roi, np.asarray(size, np.int64)), OP_TOL)
        assert got.shape == (2, 5, size[2], size[3])
    np.testing.assert_array_max_ulp(
        tex._OPS["Sigmoid"](None, [tx]).numpy(), np.asarray(jops._sigmoid(None, [jx], [None])), maxulp=2
    )
    a = rng.normal(size=(2, 672)).astype(np.float32)
    b = rng.normal(size=(672, 63)).astype(np.float32)
    c = rng.normal(size=(63,)).astype(np.float32)
    for attrs, bb in (({"transA": 0, "transB": 0}, b), ({"transB": 1, "alpha": 0.5, "beta": 2.0}, b.T.copy())):
        node = OnnxNode("Gemm", ["a", "b", "c"], ["y"], attrs=attrs)
        want = np.asarray(jops._gemm(node, [jnp.asarray(a), jnp.asarray(bb), jnp.asarray(c)], [None] * 3))
        got = tex._gemm(node, [torch.from_numpy(a), torch.from_numpy(bb), torch.from_numpy(c)]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL * max(1.0, float(np.abs(want).max())))
    with pytest.raises(NotImplementedError, match="transA"):
        tex._gemm(OnnxNode("Gemm", ["a", "b"], ["y"], attrs={"transA": 1}),
                  [torch.from_numpy(a), torch.from_numpy(b)])
    # Nearest with half-pixel coordinates is served as JAX serves it, with
    # its warning (tests/test_torch_onnx_ops.py holds the values to JAX).
    with pytest.warns(UserWarning, match="approximated"):
        tex._resize(step(OnnxNode("Resize", ["x", "r", "s", "z"], ["y"], attrs={"mode": "nearest"})),
                    [tx, roi, roi, np.asarray([1, 5, 14, 12], np.int64)])


def test_unsupported_op_refused():
    from zaru_tpu_torch.onnx.executor import OnnxModule

    model = parse_model(model_path("face_landmark.onnx").read_bytes())
    model.graph.nodes[0].op_type = "Softplus"  # in neither registry
    with pytest.raises(NotImplementedError, match="Softplus"):
        OnnxModule(model, torch.device("cpu"))


def test_padding_modes_match_jax():
    """Conv and MaxPool padding: explicit asymmetric pads, SAME_UPPER,
    SAME_LOWER and VALID, against the JAX op handlers (zaru_tpu/onnx/ops.py
    ``_conv`` :219, ``_max_pool`` :328) on odd sizes, where SAME_UPPER and
    SAME_LOWER differ."""
    from zaru_tpu.onnx import ops as jops
    from zaru_tpu.onnx.proto import OnnxNode
    from zaru_tpu_torch.onnx import executor as tex

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 11, 9)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    for attrs in (
        {"pads": [0, 0, 1, 1], "strides": [2, 2]},
        {"auto_pad": "SAME_UPPER", "strides": [2, 2]},
        {"auto_pad": "SAME_LOWER", "strides": [2, 2]},
        {"auto_pad": "VALID"},
    ):
        node = OnnxNode("Conv", ["x", "w", "b"], ["y"], attrs=dict(attrs))
        want = np.asarray(jops._conv(node, [jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)], [None] * 3))
        got = tex._conv(node, [torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)]).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=str(attrs))
        pool = OnnxNode("MaxPool", ["x"], ["y"], attrs=dict(attrs, kernel_shape=[3, 3]))
        want = np.asarray(jops._max_pool(pool, [jnp.asarray(x)], [None]))
        got = tex._max_pool(pool, [torch.from_numpy(x)]).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(attrs))
    pool = OnnxNode("MaxPool", ["x"], ["y"], attrs={"kernel_shape": [2, 2], "strides": [2, 2], "ceil_mode": 1})
    np.testing.assert_array_equal(
        tex._max_pool(pool, [torch.from_numpy(x)]).numpy(),
        np.asarray(jops._max_pool(pool, [jnp.asarray(x)], [None])),
    )
