"""The port's ONNX writer (zaru_tpu_torch.onnx.writer) against the JAX
package's (zaru_tpu/onnx/writer.py), held to tests/test_onnx_writer.py's
cases: the bytes of every graph equal JAX's writer's, and each graph
parses with the port's reader and runs through the port's executor.

The graphs are built by ``zaru_tpu_torch.onnx.writer_cases``, whose
functions take the writer module, so both writers make the same graph from
one definition. ``zaru_tpu_torch/fixtures/onnx_writer.npz`` keeps JAX's
bytes of them for ``chip_smoke.py``; regenerate it after a change to the
JAX writer or to a graph function with::

    JAX_PLATFORMS=cpu python tests/test_torch_onnx_writer.py
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port import one_torch_thread  # noqa: E402,F401

from zaru_tpu_torch.onnx import load_model, writer  # noqa: E402
from zaru_tpu_torch.onnx import writer_cases as cases  # noqa: E402
from zaru_tpu_torch.onnx.proto import parse_model  # noqa: E402

# tests/test_torch_onnx_ops.py's CNN bar: |got − want| ≤ ATOL·max(1, |want|max) + RTOL·|want|.
CNN_ATOL, CNN_RTOL = 1e-3, 2e-3


def jax_writer():
    from zaru_tpu.onnx import writer as jax_mod

    return jax_mod


def regen() -> None:
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zaru_tpu_torch", "fixtures",
                        cases.FIXTURE)
    np.savez(path, **{k: np.frombuffer(g(jax_writer()), np.uint8) for k, g in cases.GRAPHS.items()})
    print(f"wrote {path}")


def test_fixture_is_current():
    """The stored bytes are JAX's writer's bytes of the graph functions now."""
    assert cases.stored() == {k: g(jax_writer()) for k, g in cases.GRAPHS.items()}


@pytest.mark.parametrize("name", sorted(cases.GRAPHS))
def test_graph_bytes_equal_jax(name):
    assert cases.GRAPHS[name](writer) == cases.GRAPHS[name](jax_writer())


def test_roundtrip_conv_relu():
    data = cases.conv_relu(writer)
    model = parse_model(data)
    assert model.producer == "zaru_tpu"
    assert model.opset == 13
    assert [n.op_type for n in model.graph.nodes] == ["Conv", "Relu"]
    assert model.graph.nodes[0].attrs["pads"] == [1, 1, 1, 1]
    rng = np.random.default_rng(0)
    kernel = rng.normal(0, 1, (4, 3, 3, 3)).astype(np.float32)
    bias = rng.normal(0, 1, (4,)).astype(np.float32)
    np.testing.assert_array_equal(model.graph.initializers["k"], kernel)
    assert model.graph.inputs[0].shape == [1, 3, 8, 8]

    module = load_model(data, torch.device("cpu"))
    x = torch.from_numpy(rng.normal(0, 1, (1, 3, 8, 8)).astype(np.float32))
    with torch.no_grad():
        (got,) = module(x)
    want = F.relu(F.conv2d(x, torch.from_numpy(kernel), torch.from_numpy(bias), padding=1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_attribute_types_roundtrip():
    """Every attribute type parses back; each encoder's bytes equal JAX's,
    and both refuse what they cannot encode."""
    g = parse_model(cases.attributes(writer)).graph
    a = g.nodes[0].attrs
    assert a["f"] == pytest.approx(1.5)
    assert a["i"] == -7 and a["big"] == 1 << 40 and a["flag"] == 1
    assert a["s"] == "hello" and a["raw"] == "bytes"
    assert a["fs"] == [1.0, 2.5]
    assert a["ints"] == [1, -2, 3]
    np.testing.assert_array_equal(a["t"], np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(a["ti"], [-1, 2])
    assert g.outputs[0].dtype == np.int32

    jw = jax_writer()
    values = [0.0, -2.25, 0, 5, -1, 1 << 62, False, True, "", "é", b"x", [], [0.5], (1, -1, 1 << 40),
              np.zeros((0,), np.float32), np.arange(4, dtype=np.uint8)]
    for v in values:
        assert writer._encode_attribute("a", v) == jw._encode_attribute("a", v), v
    for mod in (writer, jw):
        with pytest.raises(ValueError, match="unsupported attribute"):
            mod._encode_attribute("a", {"no": 1})
    for v in (0, 1, 127, 128, 300, 1 << 35, (1 << 64) - 1):
        assert writer._varint(v) == jw._varint(v)
    for dtype in sorted({np.dtype(t).name for t in writer.TENSOR_DTYPES.values()}):
        arr = (np.arange(6) % 2).astype(dtype).reshape(3, 2)
        assert writer._encode_tensor("w", arr) == jw._encode_tensor("w", arr), dtype
    for mod in (writer, jw):
        with pytest.raises(ValueError, match="unsupported initializer dtype"):
            mod._encode_tensor("w", np.zeros(2, np.complex64))
    assert writer.tensor_value_info("v", (1, 2), np.int64) == jw.tensor_value_info("v", (1, 2), np.int64)
    parts = dict(nodes=[writer.node("Relu", ["x"], ["y"], name="r")], inputs=[writer.tensor_value_info("x", (2,))],
                 outputs=[writer.tensor_value_info("y", (2,))], initializers={"c": np.ones(2, np.float32)},
                 graph_name="g", producer="someone", opset=11, ir_version=7)
    assert writer.build_model(**parts) == jw.build_model(**parts)


def test_stub_models_parse_and_run(monkeypatch):
    """tests/stub_models.py's four stubs built with the port's writer are
    JAX's bytes; the pose stubs parse and run through the port's
    executor."""
    import stub_models

    makers = ("build_pose_detection_stub", "build_pose_landmark_stub", "build_palm_detection_full_stub",
                "build_hand_landmark_full_stub")
    want = {b: getattr(stub_models, b)() for b in makers}
    monkeypatch.setattr(stub_models, "OnnxWriter", writer.OnnxWriter)
    got = {b: getattr(stub_models, b)() for b in makers}
    assert got == want

    det = parse_model(got["build_pose_detection_stub"])
    assert det.graph.inputs[0].shape == [1, 3, 224, 224]
    assert [o.name for o in det.graph.outputs] == ["boxes", "conf"]
    module = load_model(got["build_pose_landmark_stub"], torch.device("cpu"), output_subset=[0, 1])
    with torch.no_grad():
        lms, flag = module(torch.zeros((1, 3, 256, 256)))
    assert tuple(lms.shape) == (1, 195)
    assert float(flag.reshape(())) == pytest.approx(0.95)


def test_blaze_chain_is_one_stage():
    """The authored BlazeBlock chain plans as one stage-kernel chain of its
    three blocks and agrees with the op-by-op graph within the CNN bar, at
    the declared batch and at batch 2."""
    data = cases.blaze_chain(writer, size=16)
    module = load_model(data, torch.device("cpu"))
    assert [(st.channels, len(st.blocks)) for st in module.stages] == [(32, 3)]
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 32, 16, 16)).astype(np.float32))
    with torch.no_grad():
        for batch in (x[:1], x):
            (fused,) = module(batch)
            with module.without_plans():
                (plain,) = module(batch)
            bar = CNN_ATOL * max(1.0, float(plain.abs().max())) + CNN_RTOL * plain.abs()
            assert bool(((fused - plain).abs() <= bar).all())
            assert tuple(fused.shape) == tuple(batch.shape)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    regen()
