"""The port's ONNX executor (zaru_tpu_torch.onnx) against the JAX importer.

Both face models of the main path run at batch 2 on the same seeded inputs
through ``zaru_tpu.onnx.load_model(...).apply`` and the port's
``OnnxModule``. f32 convolution sums in another order in XLA and in torch,
so the outputs are held to the repo's CNN bar (tests/test_onnx_importer.py:
63-66): ``atol = 1e-3·max(1, |out|max)``, ``rtol = 2e-3``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zaru_tpu.assets import model_path
from zaru_tpu.onnx import load_model as jax_load
from zaru_tpu_torch.onnx import SUPPORTED_OPS, load_model, parse_model

MODELS = ["face_detection_short_range.onnx", "face_landmark.onnx"]


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
    """The two models use only the 9 ops the executor runs."""
    ops = {n.op_type for n in parse_model(model_path(name).read_bytes()).graph.nodes}
    assert ops <= SUPPORTED_OPS
    assert len(SUPPORTED_OPS) == 9


def test_unsupported_op_refused():
    from zaru_tpu_torch.onnx.executor import OnnxModule

    model = parse_model(model_path("face_landmark.onnx").read_bytes())
    model.graph.nodes[0].op_type = "Softmax"
    with pytest.raises(NotImplementedError, match="Softmax"):
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
