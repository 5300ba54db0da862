"""The port's host engines (zaru_tpu_torch ``nn.NeuralNetwork``/``Loader``,
``detection.Detector``, ``landmark.Estimator``/``LandmarkTracker``,
``hand.tracking.HandTracker``) and the executor's ReduceMean, AveragePool
and Constant, against zaru_tpu on the CPU.

Both packages compute with the same weights: the port loads the ONNX files
JAX loads (``test_fixture_is_current`` holds its parameters equal to JAX's
``NeuralNetwork.params`` through ``weights.network_params_from_jax``).

- **Ops.** Small seeded graphs written with zaru_tpu/onnx/writer.py (every
  attribute and opset form the port takes), through JAX's importer and the
  port's executor: AveragePool and ReduceMean sum in another order, held to
  OP_TOL; Constant bit for bit.
- **Models.** Every blob in ``assets/onnx`` loads in the port; four of them
  at batch 1 on a seeded input are held to the repo's CNN bar
  (tests/test_onnx_importer.py:63-66): ``atol = 1e-3·max(1,|out|max)``,
  ``rtol = 2e-3``.
- **Host decode, NMS and filters**: numpy in both packages, so bit for bit.
- **Engines on the fixture photo (1280×720)**: ``Detector.detect`` with
  short-range BlazeFace and with the palm detector (threshold 0.1: the
  photo has no hand), ``Estimator.estimate`` with Face Mesh V1 and both
  68-point networks on a fixed rotated view (the exact sampler gives both
  packages the same crop; the CNNs differ in their sums), and two
  ``LandmarkTracker.track`` steps from a fixed ROI, within the tolerances
  measured below; a blank image loses tracking.
- **HandTracker's scheduling** with the detector and trackers replaced by
  scripted stand-ins, as tests/test_hand_body.py drives JAX's: the same
  script gives both packages the same hands and IDs.
- **The body host API** on the stub pose models of tests/stub_models.py
  (the real blobs are missing upstream; ``ZARU_TPU_MODELS`` names a
  temporary directory they are written to): ``Detector(PoseNetwork())`` on
  the photo and ``Estimator(LiteNetwork())`` on a rotated view, within the
  tolerances above; ``nms_remove_device`` (the fixed-shape classic NMS) on
  seeded boxes, bit for bit; ``DecodePool`` against ``decode_jpeg`` on the
  repository's photos.

JAX's results are stored in ``zaru_tpu_torch/fixtures/host_eval.npz`` (keys
``host__*``; tests/test_torch_eval.py owns the ``eval__*`` keys). Only
``test_fixture_is_current`` runs JAX, in the test process. Regenerate the
keys of this file with::

    JAX_PLATFORMS=cpu python tests/test_torch_host.py
"""

import os
import sys

import numpy as np
import pytest

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "zaru_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "host_eval.npz")
PREFIX = "host__"
ONNX_DIR = os.path.join(ROOT, "assets", "onnx")
# The four models held to JAX at batch 1.
MODELS = ["slim_160_latest.onnx", "landmarks_68_pfld.onnx", "mobilefacenet.onnx",
          "face_detection_short_range.onnx"]
PALM_THRESHOLD = 0.1
# A rotated view around the photo's face (cx, cy, w, h, theta) for the
# estimators, and the tracker's seed ROI.
FACE_VIEW = (699.0, 405.0, 400.0, 440.0, 0.12)
SEED_ROI = (698.8, 420.7, 300.0, 300.0, 0.05)
# AveragePool and ReduceMean against JAX's reduce_window / dot: 1.2e-7
# measured.
OP_TOL = 1e-6
# Measured (CPU, one torch thread): detection boxes and keypoints within
# 1.2e-4 px (face) and 3.7e-4 px (palm), scores within 1.3e-6, angles within
# 2.7e-6 rad; estimates within 1.2e-4 px (Face Mesh) and 1.5e-4 px (both
# 68-point networks), the face flag equal, its rotation within 7.5e-9 rad
# and its eye rects within 3.1e-5 px; each tracker step from JAX's ROI
# within 1.2e-4 px, its next ROI within 2.1e-4 px and 1.6e-7 rad. Run
# freely, the second step starts from a ROI 6e-5 px off JAX's, which moves
# crop pixels that lie on a rounding boundary: 0.0215 px (with torch's
# default threads 0.0030 px), held to TRACK_FREE_TOL_PX.
DET_TOL_PX, SCORE_TOL, ANGLE_TOL = 1e-3, 1e-5, 1e-5
LM_TOL_PX = 1e-2
TRACK_FREE_TOL_PX = 0.25


def photo_rgba():
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        rgb = f["rgb"]
    return np.ascontiguousarray(np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1))


# --- graphs for the three ops ------------------------------------------------

X_SHAPE = (2, 3, 11, 9)


def _graph(op, attrs, opset=13, inits=None, extra_inputs=()):
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(opset=opset)
    w.input("x", X_SHAPE)
    for name, arr in (inits or {}).items():
        w.initializer(name, arr)
    w.node(op, ["x", *extra_inputs], ["y"], **attrs)
    w.output("y", X_SHAPE)
    return w.serialize()


def avg_pool_graphs():
    cases = {
        "asymmetric pads": {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [0, 1, 1, 2]},
        "asymmetric pads, count_include_pad": {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [0, 1, 1, 2],
                                               "count_include_pad": 1},
        "SAME_UPPER": {"kernel_shape": [3, 3], "strides": [2, 2], "auto_pad": "SAME_UPPER"},
        "SAME_LOWER": {"kernel_shape": [4, 2], "strides": [3, 2], "auto_pad": "SAME_LOWER"},
        "ceil_mode": {"kernel_shape": [2, 2], "strides": [2, 2], "ceil_mode": 1},
        "ceil_mode, count_include_pad": {"kernel_shape": [3, 2], "strides": [2, 2], "ceil_mode": 1,
                                         "count_include_pad": 1},
        "valid windows (pfld)": {"kernel_shape": [3, 3], "strides": [3, 3], "pads": [0, 0, 0, 0]},
    }
    return {name: _graph("AveragePool", attrs) for name, attrs in cases.items()}


def reduce_mean_graphs():
    axes = lambda a: {"axes": np.asarray(a, np.int64)}  # noqa: E731
    return {
        "opset 13, axes [3], keepdims 0": _graph("ReduceMean", {"axes": [3], "keepdims": 0}),
        "opset 13, axes [2, 3]": _graph("ReduceMean", {"axes": [2, 3]}),
        "opset 13, axes [-1, 1], keepdims 0": _graph("ReduceMean", {"axes": [-1, 1], "keepdims": 0}),
        "opset 18, axes input [3, 2]": _graph("ReduceMean", {}, 18, axes([3, 2]), ["axes"]),
        "opset 18, axes input, keepdims 0": _graph("ReduceMean", {"keepdims": 0}, 18, axes([2]), ["axes"]),
        "opset 18, empty axes, noop": _graph("ReduceMean", {"noop_with_empty_axes": 1}, 18, axes([]), ["axes"]),
    }


def constant_graph():
    """Constants as a PRelu slope (a float tensor), as Clip's bounds (as in
    mobilefacenet.onnx) and as a Reshape's shape (int64)."""
    from zaru_tpu.onnx.writer import OnnxWriter

    w = OnnxWriter(opset=11)
    w.input("x", (1,) + X_SHAPE[1:])
    w.initializer("bias", np.linspace(-1, 1, 3, dtype=np.float32).reshape(3, 1, 1))
    w.node("Constant", [], ["scale"], value=np.asarray([[[0.5]], [[-2.0]], [[3.0]]], np.float32))
    w.node("Constant", [], ["lo"], value=np.asarray(-1.5, np.float32))
    w.node("Constant", [], ["hi"], value=np.asarray(2.5, np.float32))
    w.node("Constant", [], ["shape"], value=np.asarray([1, 3, -1], np.int64))
    w.node("PRelu", ["x", "scale"], ["m"])
    w.node("Add", ["m", "bias"], ["a"])
    w.node("Clip", ["a", "lo", "hi"], ["c"])
    w.node("Reshape", ["c", "shape"], ["y"])
    w.output("y", (1, 3, 99))
    return w.serialize()


def op_input(batch=X_SHAPE[0]):
    return np.random.default_rng(11).normal(size=X_SHAPE).astype(np.float32)[:batch]


def model_input(shape):
    return np.random.default_rng(12).uniform(-1, 1, shape).astype(np.float32)


# --- host decode, NMS and filter inputs --------------------------------------


def ssd_inputs():
    rng = np.random.default_rng(13)
    boxes = rng.normal(0, 4, (1, 896, 16)).astype(np.float32)
    boxes[..., 2:4] = rng.uniform(10, 40, (1, 896, 2))
    return boxes, rng.normal(-2, 2, (1, 896, 1)).astype(np.float32)


def nms_inputs():
    """40 detections in 4 clusters: (conf, rect [cx,cy,w,h], keypoints
    [3,2], angle), confidences with ties."""
    rng = np.random.default_rng(14)
    centers = rng.uniform(50, 400, (4, 2))
    k = rng.integers(0, 4, 40)
    rects = np.concatenate([centers[k] + rng.normal(0, 6, (40, 2)), rng.uniform(40, 60, (40, 2))], 1)
    conf = np.round(rng.uniform(0.3, 1.0, 40), 2)
    return (conf.astype(np.float32), rects.astype(np.float32),
            rng.uniform(0, 400, (40, 3, 2)).astype(np.float32), rng.uniform(-1, 1, 40).astype(np.float32))


def filter_values():
    return np.random.default_rng(15).uniform(0, 192, (6, 4, 3)).astype(np.float32)


ELAPSED = [1 / 30, 1 / 30, 0.0, 1 / 60, 0.1, 1 / 30]


def run_filters(pkg):
    """Every host filter of ``pkg`` (``zaru_tpu`` or ``zaru_tpu_torch``)
    over FILTER_VALUES: the outputs, stacked."""
    import importlib

    f = importlib.import_module(f"{pkg}.filters")
    values, outs = filter_values(), []
    for params in (f.Ema(0.3), f.AlphaBetaFilter(0.5, 0.1), f.OneEuroFilter(1.0, 0.5), f.NoopFilter()):
        simple = f.SimpleFilter(params, shape=(4, 3))
        outs.append(np.stack([simple.filter(v, e) if params.time_based else simple.filter(v)
                              for v, e in zip(values, ELAPSED)]))
        simple.reset_state()
        outs.append(np.asarray(simple.filter(values[0], 0.0) if params.time_based else simple.filter(values[0])))
    clock = iter(np.cumsum([0.0] + ELAPSED).tolist())
    timed = f.SimpleFilter(f.TimedFilterAdapter(f.OneEuroFilter(1.0, 0.5), clock=lambda: next(clock)), shape=(4, 3))
    outs.append(np.stack([timed.filter(v) for v in values]))
    return outs


def detections_arrays(dets, key):
    """A ``Detections``' class-0 list as arrays under ``key``."""
    dets = list(dets)
    return {
        f"{key}_conf": np.asarray([d.confidence() for d in dets], np.float32),
        f"{key}_rect": np.asarray([d.bounding_rect().array for d in dets], np.float32).reshape(-1, 4),
        f"{key}_kps": np.asarray([np.stack(d.keypoints()) for d in dets], np.float32),
        f"{key}_angle": np.asarray([d.angle() for d in dets], np.float32),
    }


# --- the JAX side (test_fixture_is_current and regeneration only) -----------


def op_graphs():
    """Every op graph by name; the constant graph takes batch 1."""
    return {**{f"avg/{k}": v for k, v in avg_pool_graphs().items()},
            **{f"mean/{k}": v for k, v in reduce_mean_graphs().items()}, "const": constant_graph()}


def jax_graphs():
    """JAX's importer on the op graphs (stored with their bytes, which
    chip_smoke.py replays) and on the four models: outputs and params."""
    import jax

    from zaru_tpu.onnx import load_model

    out, x = {}, op_input()
    for name, data in op_graphs().items():
        m = load_model(data)
        out[f"graph/{name}"] = np.frombuffer(data, np.uint8)
        out[f"op/{name}"] = np.asarray(m.apply(m.params, x[:1] if name == "const" else x)[0])
    params = {}
    for name in MODELS:
        m = load_model(os.path.join(ONNX_DIR, name))
        shape = [d if isinstance(d, int) else 1 for d in m.input_info[0].shape]
        outs = jax.jit(m.apply)(m.params, model_input(shape))
        for i, o in enumerate(outs):
            out[f"model/{name}/{i}"] = np.asarray(o)
        params[name] = {k: np.asarray(v) for k, v in m.params.items()}
    return out, params


def jax_engines():
    """JAX's host engines on the photo."""
    from zaru_tpu.detection import Detector
    from zaru_tpu.face.detection import ShortRangeNetwork
    from zaru_tpu.face.landmark.mediapipe import FaceMeshV1
    from zaru_tpu.face.landmark.multipie68 import FaceOnnx, PeppaFacialLandmark
    from zaru_tpu.geometry import RotatedRect
    from zaru_tpu.hand.detection import LiteNetwork as Palm
    from zaru_tpu.image import Image
    from zaru_tpu.landmark import Estimator, LandmarkTracker

    img = Image(photo_rgba())
    out = detections_arrays(Detector(ShortRangeNetwork()).detect(img), "det_face")
    palm = Detector(Palm())
    palm.set_threshold(PALM_THRESHOLD)
    out.update(detections_arrays(palm.detect(img), "det_palm"))
    view = img.view(RotatedRect(np.asarray(FACE_VIEW, np.float32)))
    for key, net in (("v1", FaceMeshV1()), ("peppa", PeppaFacialLandmark()), ("pfld", FaceOnnx())):
        est = Estimator(net).estimate(view)
        out[f"est_{key}_pos"] = est.landmarks_mut().positions().copy()
        if key == "v1":
            out["est_v1_conf"] = np.asarray(est.confidence(), np.float32)
            out["est_v1_left_eye"] = est.left_eye().array.copy()
            out["est_v1_right_eye"] = est.right_eye().array.copy()
            out["est_v1_rotation"] = np.asarray(est.rotation_radians(), np.float32)
    tracker = LandmarkTracker(Estimator(FaceMeshV1()))
    tracker.set_roi(RotatedRect(np.asarray(SEED_ROI, np.float32)))
    for t in range(2):
        r = tracker.track(img)
        out[f"track{t}_pos"] = r.estimate().landmarks_mut().positions().copy()
        out[f"track{t}_view"] = r.view_rect().array.copy()
        out[f"track{t}_roi"] = tracker.roi().array.copy()
    blank = LandmarkTracker(Estimator(FaceMeshV1()))
    blank.set_roi(RotatedRect(np.asarray(SEED_ROI, np.float32)))
    out["blank_lost"] = np.asarray(blank.track(Image(np.zeros_like(photo_rgba()))) is None and blank.roi() is None)
    return out


def nms_remove_cases():
    """name: (boxes, conf, keypoints, angles) for ``nms_remove_device``: the
    40 clustered detections of :func:`nms_inputs` (16 slots, so some stay
    empty), and two streams of them, the second reversed with a third of its
    confidences zeroed (below the detection threshold)."""
    conf, rects, kps, angles = nms_inputs()
    flip = lambda a: a[::-1].copy()  # noqa: E731
    conf2 = flip(conf)
    conf2[::3] = 0.0
    return {
        "clusters": (rects, conf, kps, angles),
        "two streams": (np.stack([rects, flip(rects)]), np.stack([conf, conf2]),
                        np.stack([kps, flip(kps)]), np.stack([angles, flip(angles)])),
    }


def write_pose_stubs(directory):
    """The stub pose blobs (tests/stub_models.py) as the files the pose
    networks load."""
    import stub_models

    blobs = {"pose_detection.onnx": stub_models.build_pose_detection_stub(),
             "pose_landmark_lite.onnx": stub_models.build_pose_landmark_stub()}
    for name, blob in blobs.items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(blob)


def jax_remainders(model_dir):
    """JAX's ``Detector(PoseNetwork())`` on the photo and
    ``Estimator(LiteNetwork())`` on FACE_VIEW (the stubs in ``model_dir``),
    and ``nms_remove_device`` on :func:`nms_remove_cases`."""
    import jax

    os.environ["ZARU_TPU_MODELS"] = model_dir
    from zaru_tpu.body.detection import PoseNetwork
    from zaru_tpu.body.landmark import LiteNetwork as PoseLite
    from zaru_tpu.detection import Detector
    from zaru_tpu.detection.nms import nms_remove_device
    from zaru_tpu.geometry import RotatedRect
    from zaru_tpu.image import Image
    from zaru_tpu.landmark import Estimator

    img = Image(photo_rgba())
    out = detections_arrays(Detector(PoseNetwork()).detect(img), "det_pose")
    est = Estimator(PoseLite()).estimate(img.view(RotatedRect(np.asarray(FACE_VIEW, np.float32))))
    lms = est.landmarks_mut()
    out.update({"est_pose_pos": lms.positions().copy(), "est_pose_vis": np.asarray(lms.visibility),
                "est_pose_pres": np.asarray(lms.presence),
                "est_pose_conf": np.asarray(est.confidence(), np.float32)})
    for name, args in nms_remove_cases().items():
        fn = jax.jit(nms_remove_device if args[1].ndim == 1 else jax.vmap(nms_remove_device))
        for i, o in enumerate(fn(*args)):
            out[f"nms_remove/{name}/{i}"] = np.asarray(o)
        for i, a in enumerate(args):  # the inputs, which chip_smoke.py replays
            out[f"nms_remove/{name}/in{i}"] = a
    return out


def jax_now(model_dir):
    """Every JAX result the fixture stores, and the four models' params."""
    graphs, params = jax_graphs()
    return {**graphs, **jax_engines(), **jax_remainders(model_dir)}, params


def regen():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        write_pose_stubs(d)
        arrays = jax_now(d)[0]
    keep = {}
    if os.path.exists(FIXTURE):
        with np.load(FIXTURE) as f:
            keep = {k: f[k] for k in f.files if not k.startswith(PREFIX)}
    np.savez_compressed(FIXTURE, **keep, **{PREFIX + k: v for k, v in arrays.items()})
    print(f"wrote {FIXTURE}")


# --- the tests -----------------------------------------------------------------


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k[len(PREFIX):]: f[k] for k in f.files if k.startswith(PREFIX)}


def _load(data):
    from zaru_tpu_torch.onnx import load_model

    return load_model(data, torch.device("cpu"))


def _run(data, batch=X_SHAPE[0]):
    with torch.inference_mode():
        return _load(data)(torch.from_numpy(op_input(batch)))[0].numpy()


@pytest.fixture(scope="module")
def stub_dir(tmp_path_factory):
    """The stub pose blobs in a temporary directory that ``ZARU_TPU_MODELS``
    names, for the module."""
    d = str(tmp_path_factory.mktemp("stub_onnx"))
    write_pose_stubs(d)
    old = os.environ.get("ZARU_TPU_MODELS")
    os.environ["ZARU_TPU_MODELS"] = d
    try:
        yield d
    finally:
        if old is None:
            os.environ.pop("ZARU_TPU_MODELS", None)
        else:
            os.environ["ZARU_TPU_MODELS"] = old


def test_fixture_is_current(stored, stub_dir):
    """The stored JAX results are what zaru_tpu computes now (1e-3, the
    regen machine's own rounding), and the port's networks hold JAX's
    weights bit for bit."""
    from zaru_tpu_torch.nn import NeuralNetwork
    from zaru_tpu_torch.weights import network_params_from_jax

    now, params = jax_now(stub_dir)
    assert set(now) == set(stored)
    for k, v in now.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    for name, jparams in params.items():
        want = network_params_from_jax(jparams)
        net = NeuralNetwork.load(os.path.join(ONNX_DIR, name), device="cpu")
        assert set(net.params) == set(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(net.params[k].numpy(), v.numpy(), err_msg=f"{name}/{k}")
        net.load_params(want)  # JAX's params as they are


def test_average_pool_matches_jax(stored):
    """Asymmetric pads, both auto_pad modes, ceil_mode and
    count_include_pad (default 0) on an 11×9 input."""
    for name, data in avg_pool_graphs().items():
        got, want = _run(data), stored[f"op/avg/{name}"]
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL, err_msg=name)


def test_reduce_mean_matches_jax(stored):
    """``axes`` as an attribute (opset 13) and as an input (opset 18),
    negative axes, ``keepdims`` 0 and 1, ``noop_with_empty_axes``; a
    reduction over the batch axis is refused."""
    from zaru_tpu.onnx.writer import OnnxWriter

    for name, data in reduce_mean_graphs().items():
        got, want = _run(data), stored[f"op/mean/{name}"]
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL, err_msg=name)
    w = OnnxWriter(opset=18)
    w.input("x", (1,) + X_SHAPE[1:])  # a batch-1 graph, run at batch 2
    w.node("ReduceMean", ["x"], ["y"])
    w.output("y", (1, 1, 1, 1))
    with pytest.raises(NotImplementedError, match="batch axis"):
        _run(w.serialize())


def test_constant_matches_jax(stored):
    """Constants as a float operand, Clip bounds and a Reshape shape: bit for
    bit; no Constant is a parameter, and a float one read as a tensor lives
    on the module's device."""
    m = _load(constant_graph())
    assert set(m.params()) == {"bias"}
    assert {n for n, _ in m.named_buffers()} == {next(iter(m._const_attr.values()))}
    assert m._static["shape"].dtype == np.int64 and m._static["lo"].dtype == np.float32
    np.testing.assert_array_equal(_run(constant_graph(), batch=1), stored["op/const"])


def test_every_model_loads_and_four_match_jax(stored):
    """Every blob in assets/onnx loads in the port (62 ops now); the 68-point
    landmarkers, mobilefacenet and short-range BlazeFace at batch 1 on a
    seeded input are within the CNN bar of JAX's outputs. Neither 68-point
    network has a BlazeBlock chain for the stage kernel."""
    from zaru_tpu_torch.onnx import SUPPORTED_OPS

    assert len(SUPPORTED_OPS) == 62
    names = sorted(n for n in os.listdir(ONNX_DIR) if n.endswith(".onnx"))
    assert len(names) == 10
    modules = {n: _load(os.path.join(ONNX_DIR, n)) for n in names}
    assert modules["slim_160_latest.onnx"].stages == [] and modules["landmarks_68_pfld.onnx"].stages == []
    for name in MODELS:
        m = modules[name]
        shape = [d if isinstance(d, int) else 1 for d in m.input_info[0].shape]
        with torch.inference_mode():
            outs = m(torch.from_numpy(model_input(shape)))
        for i, o in enumerate(outs):
            want = stored[f"model/{name}/{i}"]
            tol = 1e-3 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(o.numpy(), want, atol=tol, rtol=2e-3, err_msg=f"{name}/{i}")


def test_network_api():
    """``NeuralNetwork``/``Loader``: inputs, outputs, output selection by
    name and position, ``estimate`` on raw tensors; ``with_bf16`` loads a
    network whose body runs in bf16 and whose outputs are f32, near the f32
    ones; ``with_layout("NHWC")`` loads a channels_last module whose
    outputs are the NCHW module's (tests/test_torch_onnx_layout.py holds it
    to JAX); ``Cnn``
    takes ``(NeuralNetwork, CnnInputShape, ColorMapper)`` and refuses a
    shape that does not fit."""
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import Cnn, CnnInputShape, ColorMapper, Loader, NeuralNetwork

    path = model_path("hand_landmark_lite.onnx")
    net = NeuralNetwork.load(path, device="cpu")
    assert (net.num_inputs(), net.num_outputs()) == (1, 4)
    assert net.inputs()[0].shape == [1, 3, 224, 224]
    assert [o.name for o in net.outputs()] == ["Identity", "Identity_1", "Identity_2", "Identity_3"]
    x = np.random.default_rng(16).uniform(0, 1, (1, 3, 224, 224)).astype(np.float32)
    full = net.estimate(x)
    by_name = Loader(path, device="cpu").with_output_selection(["Identity_2", "Identity"]).load()
    by_index = Loader(path, device="cpu").with_output_selection_by_index([2, 0]).load()
    for sel in (by_name, by_index):
        assert sel.num_outputs() == 2
        got = sel.estimate(torch.from_numpy(x))
        np.testing.assert_array_equal(got[0].numpy(), full[2].numpy())
        np.testing.assert_array_equal(got[1].numpy(), full[0].numpy())
    bf16 = Loader(path, device="cpu").with_bf16().load()
    assert bf16.module.compute_dtype == torch.bfloat16 and bf16.module.stages == []
    assert all(p.dtype == torch.float32 for p in bf16.params.values())
    for got, want in zip(bf16.estimate(x), full, strict=True):
        assert got.dtype == torch.float32 and got.shape == want.shape
        bound = 0.05 * max(1.0, float(want.abs().max()))  # the landmarks: 1.3 px of 224 measured
        assert float((got - want).abs().max()) <= bound
    nhwc = Loader(path, device="cpu").with_layout("NHWC").load()
    assert nhwc.module.layout == "NHWC"
    for got, want in zip(nhwc.estimate(x), full, strict=True):
        assert got.shape == want.shape and got.is_contiguous()
        tol = 1e-3 * max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=2e-3)
    cnn = Cnn(net, CnnInputShape.NCHW, ColorMapper.linear(0.0, 1.0))
    assert (cnn.input_resolution().width, cnn.input_resolution().height) == (224, 224)
    with pytest.raises(ValueError, match="input shape"):
        Cnn(net, CnnInputShape.NHWC, ColorMapper.linear(0.0, 1.0))


def test_decode_ssd_matches_jax():
    """The host SSD decode (numpy in both packages) on random BlazeFace
    outputs: bit for bit, the face angle included."""
    from zaru_tpu.detection import Detections as JDets, decode_ssd as j_decode
    from zaru_tpu.face.detection import ShortRangeNetwork as JNet, _face_angle as j_angle
    from zaru_tpu_torch.detection import Anchors, Detections, decode_ssd
    from zaru_tpu_torch.face.detection import ShortRangeNetwork, _face_angle

    boxes, conf = ssd_inputs()
    anchors = Anchors.calculate(ShortRangeNetwork.LAYERS)
    got, want = Detections(), JDets()
    decode_ssd(128, 128, anchors, boxes, conf, 0.5, got, 6, _face_angle)
    j_decode(128, 128, JNet().anchors, boxes, conf, 0.5, want, 6, j_angle)
    g, w = detections_arrays(got, "d"), detections_arrays(want, "d")
    assert len(got) > 100
    for k in g:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_nms_matches_jax():
    """Host NMS in both modes (remove, weighted average) on 40 detections in
    four clusters with tied confidences: bit for bit, in the same order."""
    from zaru_tpu.detection import Detection as JDet, NonMaxSuppression as JNms
    from zaru_tpu.geometry import Rect as JRect
    from zaru_tpu_torch.detection import Detection, NonMaxSuppression, SuppressionMode
    from zaru_tpu_torch.rect import Rect

    conf, rects, kps, angles = nms_inputs()
    for mode in (SuppressionMode.Remove, SuppressionMode.Average):
        port, jax_ = NonMaxSuppression(), JNms()
        port.set_mode(mode)
        jax_.set_mode(mode)
        got = port.process([Detection(c, Rect(r), list(k), a) for c, r, k, a in zip(conf, rects, kps, angles)])
        want = jax_.process([JDet(c, JRect(r), list(k), a) for c, r, k, a in zip(conf, rects, kps, angles)])
        g, w = detections_arrays(got, "d"), detections_arrays(want, "d")
        assert 3 <= len(got) < 40, mode
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{mode} {k}")


def test_filters_match_jax():
    """Ema, AlphaBetaFilter, OneEuroFilter (host), NoopFilter through
    ``SimpleFilter`` (with ``elapsed``, a zero interval and a reset), and
    ``TimedFilterAdapter`` on a scripted clock: bit for bit."""
    for got, want in zip(run_filters("zaru_tpu_torch"), run_filters("zaru_tpu"), strict=True):
        np.testing.assert_array_equal(got, want)


def _engine_nets():
    from zaru_tpu_torch.face.detection import ShortRangeNetwork
    from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV1
    from zaru_tpu_torch.face.landmark.multipie68 import FaceOnnx, PeppaFacialLandmark
    from zaru_tpu_torch.hand.detection import LiteNetwork as Palm

    return {"face": ShortRangeNetwork(device="cpu"), "palm": Palm(device="cpu"),
            "v1": FaceMeshV1(device="cpu"), "peppa": PeppaFacialLandmark(device="cpu"),
            "pfld": FaceOnnx(device="cpu")}


@pytest.fixture(scope="module")
def nets():
    return _engine_nets()


@pytest.fixture(scope="module")
def image():
    from zaru_tpu_torch.image import Image

    return Image(photo_rgba(), device="cpu")


def test_detector_matches_jax(stored, nets, image):
    """``Detector.detect`` on the photo: one face (its box, keypoints, score
    and eye angle), and the palm detector's candidates at threshold 0.1
    after NMS, within the measured tolerances."""
    from zaru_tpu_torch.detection import Detector

    for key, threshold in (("face", 0.5), ("palm", PALM_THRESHOLD)):
        det = Detector(nets[key])
        det.set_threshold(threshold)
        got = detections_arrays(det.detect(image), "d")
        want = {k.split("_", 2)[2]: v for k, v in stored.items() if k.startswith(f"det_{key}_")}
        assert got["d_conf"].shape == want["conf"].shape and len(want["conf"]) >= 1, key
        np.testing.assert_allclose(got["d_conf"], want["conf"], rtol=0, atol=SCORE_TOL, err_msg=key)
        np.testing.assert_allclose(got["d_rect"], want["rect"], rtol=0, atol=DET_TOL_PX, err_msg=key)
        np.testing.assert_allclose(got["d_kps"], want["kps"], rtol=0, atol=DET_TOL_PX, err_msg=key)
        np.testing.assert_allclose(got["d_angle"], want["angle"], rtol=0, atol=ANGLE_TOL, err_msg=key)
        assert [t.average_ms() is not None for t in det.timers()] == [True] * 3


@pytest.mark.parametrize("key", ["v1", "peppa", "pfld"])
def test_estimator_matches_jax(stored, nets, image, key):
    """``Estimator.estimate`` on a rotated view of the photo, positions in
    the view's coordinates; Face Mesh's confidence, rotation and eye rects
    too."""
    from zaru_tpu_torch.landmark import Estimator
    from zaru_tpu_torch.rect import RotatedRect

    est = Estimator(nets[key]).estimate(image.view(RotatedRect(np.asarray(FACE_VIEW, np.float32))))
    np.testing.assert_allclose(est.landmarks_mut().positions(), stored[f"est_{key}_pos"], rtol=0, atol=LM_TOL_PX)
    if key == "v1":
        np.testing.assert_allclose(est.confidence(), stored["est_v1_conf"], rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(est.rotation_radians(), stored["est_v1_rotation"], rtol=0, atol=ANGLE_TOL)
        np.testing.assert_allclose(est.left_eye().array, stored["est_v1_left_eye"], rtol=0, atol=LM_TOL_PX)
        np.testing.assert_allclose(est.right_eye().array, stored["est_v1_right_eye"], rtol=0, atol=LM_TOL_PX)


def test_tracker_matches_jax(stored, nets, image):
    """Two ``LandmarkTracker.track`` steps from a fixed ROI, each from JAX's
    ROI before it (landmarks in the image, the view rect and the next ROI
    within LM_TOL_PX), then run freely (landmarks within
    TRACK_FREE_TOL_PX)."""
    from zaru_tpu_torch.landmark import Estimator, LandmarkTracker
    from zaru_tpu_torch.rect import RotatedRect

    tracker = LandmarkTracker(Estimator(nets["v1"]))
    for t, roi in enumerate([np.asarray(SEED_ROI, np.float32), stored["track0_roi"]]):
        tracker.set_roi(RotatedRect(roi))
        r = tracker.track(image)
        assert r is not None
        np.testing.assert_allclose(r.estimate().landmarks_mut().positions(), stored[f"track{t}_pos"],
                                   rtol=0, atol=LM_TOL_PX)
        for got, key in ((r.view_rect().array, "view"), (tracker.roi().array, "roi")):
            np.testing.assert_allclose(got[:4], stored[f"track{t}_{key}"][:4], rtol=0, atol=LM_TOL_PX)
            np.testing.assert_allclose(got[4], stored[f"track{t}_{key}"][4], rtol=0, atol=ANGLE_TOL)
    tracker.set_roi(RotatedRect(np.asarray(SEED_ROI, np.float32)))
    for t in range(2):
        np.testing.assert_allclose(tracker.track(image).estimate().landmarks_mut().positions(),
                                   stored[f"track{t}_pos"], rtol=0, atol=TRACK_FREE_TOL_PX)


def test_tracker_loses_a_blank_image(stored, nets):
    """On a black frame the face flag falls below the loss threshold:
    ``track`` returns None and the ROI is gone, as in JAX."""
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.landmark import Estimator, LandmarkTracker
    from zaru_tpu_torch.rect import RotatedRect

    tracker = LandmarkTracker(Estimator(nets["v1"]))
    tracker.set_roi(RotatedRect(np.asarray(SEED_ROI, np.float32)))
    lost = tracker.track(Image(np.zeros_like(photo_rgba()), device="cpu")) is None and tracker.roi() is None
    assert lost and bool(stored["blank_lost"])
    assert tracker.track(None) is None


def test_pose_detector_matches_jax(stored, stub_dir, image):
    """``Detector(PoseNetwork())`` (the stub, which fires on one anchor) on
    the photo: its box, keypoints and score within the measured tolerances,
    no angle, as in JAX."""
    from zaru_tpu_torch.body.detection import PoseNetwork
    from zaru_tpu_torch.detection import Detector

    got = detections_arrays(Detector(PoseNetwork(device="cpu")).detect(image), "d")
    assert len(got["d_conf"]) == len(stored["det_pose_conf"]) == 1
    np.testing.assert_allclose(got["d_conf"], stored["det_pose_conf"], rtol=0, atol=SCORE_TOL)
    for k in ("rect", "kps"):
        np.testing.assert_allclose(got[f"d_{k}"], stored[f"det_pose_{k}"], rtol=0, atol=DET_TOL_PX, err_msg=k)
    np.testing.assert_array_equal(got["d_angle"], stored["det_pose_angle"])


def test_pose_estimator_matches_jax(stored, stub_dir, image):
    """``Estimator(LiteNetwork())`` (the pose stub) on a rotated view: the 39
    positions, visibility and presence, and the pose flag."""
    from zaru_tpu_torch.body.landmark import NUM_POSE, LandmarkResult, LiteNetwork as PoseLite
    from zaru_tpu_torch.landmark import Estimator
    from zaru_tpu_torch.rect import RotatedRect

    net = PoseLite(device="cpu")
    assert isinstance(net.init_estimate(), LandmarkResult)
    est = Estimator(net).estimate(image.view(RotatedRect(np.asarray(FACE_VIEW, np.float32))))
    lms = est.landmarks_mut()
    np.testing.assert_allclose(lms.positions(), stored["est_pose_pos"], rtol=0, atol=LM_TOL_PX)
    np.testing.assert_allclose(lms.visibility, stored["est_pose_vis"], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(lms.presence, stored["est_pose_pres"], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(est.confidence(), stored["est_pose_conf"], rtol=0, atol=SCORE_TOL)
    assert est.pose_landmarks().shape == (NUM_POSE, 3) and est.aux_landmarks().shape == (6, 3)


@pytest.mark.parametrize("case", list(nms_remove_cases()))
def test_nms_remove_device_matches_jax(stored, case):
    """``nms_remove_device`` (batched over leading dims) gives JAX's slots
    bit for bit: flags, the seeds' confidences, boxes, keypoints and
    angles."""
    from zaru_tpu_torch.detection import nms_remove_device

    got = nms_remove_device(*(torch.from_numpy(a) for a in nms_remove_cases()[case]))
    assert len(got) == 5
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), stored[f"nms_remove/{case}/{i}"], err_msg=str(i))
    assert 0 < int(got[0].sum()) < got[0].numel()  # some slots empty


@pytest.mark.parametrize("threads", [1, 4])
def test_decode_pool_matches_decode_jpeg(threads):
    """``DecodePool.decode_batch`` returns ``decode_jpeg``'s arrays in input
    order, and ``submit`` each one's future."""
    from zaru_tpu_torch.image.decode import DecodePool, decode_jpeg

    img_dir = os.path.join(ROOT, "assets", "img")
    blobs = [open(os.path.join(img_dir, n), "rb").read() for n in sorted(os.listdir(img_dir)) if n.endswith(".jpg")]
    blobs = (blobs + blobs[::-1]) * 2
    pool = DecodePool(threads)
    try:
        got = pool.decode_batch(blobs)
        assert len(got) == len(blobs) >= 8
        for blob, arr in zip(blobs, got):
            np.testing.assert_array_equal(arr, decode_jpeg(blob))
        np.testing.assert_array_equal(pool.submit(blobs[1]).result(), decode_jpeg(blobs[1]))
    finally:
        pool.close()


# --- HandTracker's scheduling ------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scripted(monkeypatch, pkg):
    """``pkg``'s HandTracker with a scripted detector and stand-in
    trackers (tests/test_hand_body.py's mock, for either package)."""
    import importlib

    tr = importlib.import_module(f"{pkg}.hand.tracking")
    hand_lm = importlib.import_module(f"{pkg}.hand.landmark")
    landmark = importlib.import_module(f"{pkg}.landmark")
    script = {"dets": []}

    class FakeDetector:
        def __init__(self, net):
            pass

        def detect(self, image):
            return list(script["dets"])

    class FakeEstimator:
        def __init__(self, net):
            pass

    class FakeLandmarkTracker:
        def __init__(self, estimator):
            self._roi, self.lost = None, False

        def set_roi_padding(self, p):
            pass

        def set_roi(self, roi):
            self._roi = roi

        def roi(self):
            return None if self.lost else self._roi

        def track(self, image):
            if self.lost or self._roi is None:
                return None
            lm = hand_lm.LandmarkResult()
            lm.presence = 0.95
            lm.landmarks.positions()[:] = [*self._roi.center(), 0.0]
            return landmark.TrackingResult(self._roi, lm, self._roi)

    monkeypatch.setattr(tr, "Detector", FakeDetector)
    monkeypatch.setattr(tr, "Estimator", FakeEstimator)
    monkeypatch.setattr(tr, "LandmarkTracker", FakeLandmarkTracker)
    clock = _Clock()
    kwargs = {"device": "cpu"} if pkg == "zaru_tpu_torch" else {}
    return tr.HandTracker(clock=clock, **kwargs), script, clock


def _hand_script(pkg, tracker, script, clock):
    """The scenarios of tests/test_hand_body.py in one run: two detections,
    a duplicate, the redetect interval, a lost hand, culling. → (hand
    count, ids, centres) after each frame."""
    det_mod = __import__(f"{pkg}.detection", fromlist=["Detection"])
    rect_mod = __import__(f"{pkg}.rect" if pkg == "zaru_tpu_torch" else f"{pkg}.geometry", fromlist=["Rect"])

    def mk(cx, cy, size=40.0):
        return det_mod.Detection(0.9, rect_mod.Rect.from_center(cx, cy, size, size))

    log = []

    def frame(dets, dt, edit=None):
        script["dets"] = dets
        clock.t += dt
        if edit:
            edit()
        tracker.track(None)
        hands = tracker.hands()
        log.append((len(hands), [h.id.value for h in hands],
                    [tuple(h.view_rect.center().tolist()) for h in hands]))

    frame([mk(50, 50), mk(200, 200)], 0.0)          # two hands
    frame([mk(50, 50), mk(200, 200)], 1.0)          # duplicates dropped
    frame([mk(50, 50), mk(400, 400)], 0.1)          # inside the interval
    frame([mk(50, 50), mk(400, 400)], 0.5)          # after it: a third
    frame([], 1.0, lambda: setattr(tracker._hands[0].tracker, "lost", True))
    frame([mk(460, 100, 60)], 1.0)
    frame([], 1.0, lambda: setattr(tracker._hands[-1].tracker, "_roi", tracker._hands[0].tracker._roi))
    return log


def test_hand_tracker_scheduling_matches_jax(monkeypatch):
    """The same script gives the same hands, IDs and view centres in both
    packages, frame by frame (detection, de-duplication with the palm box
    grown 1.5×, the redetect interval, loss, culling the newer of two
    overlapping trackers)."""
    got = _hand_script("zaru_tpu_torch", *_scripted(monkeypatch, "zaru_tpu_torch"))
    want = _hand_script("zaru_tpu", *_scripted(monkeypatch, "zaru_tpu"))
    assert got == want
    assert [n for n, _, _ in got] == [2, 2, 2, 3, 2, 3, 2]


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen()
