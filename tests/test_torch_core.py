"""zaru_tpu_torch's standalone rule, device rule and numeric core, held to
zaru_tpu on the CPU.

Inputs come from seeded numpy and go through both packages. The JAX
functions run op by op (not under ``jit``): compiled, XLA:CPU may contract a
multiply and an add into one FMA, which the port does not do outside its
samplers' colour map (see tests/test_torch_samplers.py).

IEEE arithmetic is held bit-exact. ``cos``, ``sin``, ``atan2`` and ``exp``
are each library's own and differ in the last ulp on 5-17% of inputs
(measured); results that go through them are held to 4 ulp of their
magnitude, the sigmoid to 2 ulp.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zaru_tpu import geometry as jgeom
from zaru_tpu import num as jnum
from zaru_tpu.pipeline import _ops as jops
from zaru_tpu.resolution import Resolution as JRes
from zaru_tpu_torch import geometry as tgeom
from zaru_tpu_torch import num as tnum
from zaru_tpu_torch.pipeline import _ops as tops
from zaru_tpu_torch.resolution import Resolution as TRes
from torch_port import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    """Bit-exact f32 (NaN-free inputs)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _near(got, want, ulps=4):
    """Within ``ulps`` ulp of the result's magnitude (for trig results)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * np.spacing(np.abs(want).max()))


def test_imports_neither_jax_nor_zaru_tpu():
    code = (
        "import sys, zaru_tpu_torch, zaru_tpu_torch.pipeline, zaru_tpu_torch.weights\n"
        "import zaru_tpu_torch.ops.rotated_fast, zaru_tpu_torch.ops.letterbox\n"
        "import zaru_tpu_torch.ops.cnn_stage, zaru_tpu_torch.face.eye, zaru_tpu_torch.ops.yuv\n"
        "import zaru_tpu_torch.hand.detection, zaru_tpu_torch.hand.landmark\n"
        "import zaru_tpu_torch.pipeline.multi_face, zaru_tpu_torch.pipeline.hand_cascade\n"
        "import zaru_tpu_torch.face.detection, zaru_tpu_torch.face.landmark.mediapipe\n"
        "import zaru_tpu_torch.ops.sampling, zaru_tpu_torch.nn\n"
        "import zaru_tpu_torch.serve, zaru_tpu_torch.pipeline.ingest, zaru_tpu_torch.__main__\n"
        "import zaru_tpu_torch.body.detection, zaru_tpu_torch.body.landmark\n"
        "import zaru_tpu_torch.pipeline.body_cascade, zaru_tpu_torch.color, zaru_tpu_torch.rect\n"
        "import zaru_tpu_torch.image, zaru_tpu_torch.image.decode, zaru_tpu_torch.image.draw\n"
        "import zaru_tpu_torch.video.anim, zaru_tpu_torch.video.file, zaru_tpu_torch.timer\n"
        "import zaru_tpu_torch.detection, zaru_tpu_torch.landmark, zaru_tpu_torch.filters\n"
        "import zaru_tpu_torch.face.landmark.multipie68, zaru_tpu_torch.face.landmark.canonical_face\n"
        "import zaru_tpu_torch.hand.tracking, zaru_tpu_torch.eval\n"
        "import zaru_tpu_torch.face.recognition, zaru_tpu_torch.face.identify, zaru_tpu_torch.image.blend\n"
        "import zaru_tpu_torch.quat, zaru_tpu_torch.procrustes, zaru_tpu_torch.pnp, zaru_tpu_torch.approx\n"
        "import zaru_tpu_torch.onnx.executor, zaru_tpu_torch.onnx.layout\n"
        "import zaru_tpu_torch.gui, zaru_tpu_torch.gui.loop, zaru_tpu_torch.onnx.writer\n"
        "from zaru_tpu_torch.hand.detection import ALL_KEYPOINTS, FullNetwork\n"
        "from zaru_tpu_torch.hand.landmark import FullNetwork\n"
        "from zaru_tpu_torch.landmark import Estimate\n"
        "from zaru_tpu_torch.face import identify, recognition\n"
        "from zaru_tpu_torch.detection import Detector\n"
        "from zaru_tpu_torch.landmark import Estimator, LandmarkTracker\n"
        "from zaru_tpu_torch.hand.tracking import HandTracker\n"
        "from zaru_tpu_torch.face.landmark.multipie68 import reference_positions\n"
        "assert reference_positions().shape == (68, 3)\n"
        "import importlib, pkgutil\n"
        "for m in pkgutil.walk_packages(zaru_tpu_torch.__path__, 'zaru_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'zaru_tpu_torch.parallel.mesh' in sys.modules and 'zaru_tpu_torch.video.webcam' in sys.modules\n"
        "assert 'zaru_tpu_torch.examples.identify_stream' in sys.modules and 'zaru_tpu_torch.examples._common' in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'zaru_tpu' or m.startswith('zaru_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_onnx_registry_is_jaxs():
    """The port's executor runs exactly the JAX importer's ops
    (zaru_tpu/onnx/ops.py ``OPS``)."""
    from zaru_tpu.onnx.ops import OPS

    from zaru_tpu_torch.onnx import SUPPORTED_OPS

    assert SUPPORTED_OPS == set(OPS) and len(SUPPORTED_OPS) == 62


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device given and no GPU: every entry point raises instead of
    running on the CPU."""
    from zaru_tpu_torch import FaceTracker, resolve_device
    from zaru_tpu_torch.face.detection import FullRangeNetwork, ShortRangeNetwork
    from zaru_tpu_torch.face.eye import EyeNetwork
    from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV1, FaceMeshV2
    from zaru_tpu_torch.hand.detection import FullNetwork as PalmFull, LiteNetwork as PalmLite
    from zaru_tpu_torch.hand.landmark import FullNetwork as HandFull, LiteNetwork as HandLite
    from zaru_tpu_torch.nn import Cnn, ColorMapper
    from zaru_tpu_torch.body.detection import PoseNetwork
    from zaru_tpu_torch.body.landmark import FullNetwork as PoseFull, LiteNetwork as PoseLite
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.pipeline import BodyTracker, MultiFaceTracker, MultiHandTracker
    from zaru_tpu_torch.pipeline.ingest import FrameUploader, measure_ingest_bandwidth
    from zaru_tpu_torch import eval as ev
    from zaru_tpu_torch.face.landmark.multipie68 import FaceOnnx, PeppaFacialLandmark
    from zaru_tpu_torch.hand.tracking import HandTracker
    from zaru_tpu_torch.nn import Loader, NeuralNetwork
    from zaru_tpu_torch.face.identify import FaceIdentifier, StreamIdentifier
    from zaru_tpu_torch.face.recognition import Embedder
    from zaru_tpu_torch.image.blend import blend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        FaceTracker,
        lambda: FaceTracker(iris=True, redetect_bucket=4),
        lambda: FaceTracker(fast_sampler=False),
        ShortRangeNetwork,
        FullRangeNetwork,
        EyeNetwork,
        FaceMeshV1,
        FaceMeshV2,
        MultiFaceTracker,
        lambda: MultiHandTracker(redetect_bucket=2),
        lambda: MultiHandTracker(fast_sampler=False),
        PalmLite,
        HandLite,
        PalmFull,
        HandFull,
        lambda: Cnn.load("face_landmark.onnx", ColorMapper.linear(-1.0, 1.0)),
        BodyTracker,
        PoseNetwork,
        PoseLite,
        PoseFull,
        lambda: FrameUploader(2, (4, 4, 4)),
        lambda: measure_ingest_bandwidth(2, (4, 4, 4), 1),
        lambda: Image.new(4, 4),
        PeppaFacialLandmark,
        FaceOnnx,
        HandTracker,
        lambda: NeuralNetwork.load("assets/onnx/slim_160_latest.onnx"),
        lambda: Loader("assets/onnx/slim_160_latest.onnx").load(),
        lambda: Loader("assets/onnx/slim_160_latest.onnx").with_bf16().load(),
        lambda: Loader("assets/onnx/slim_160_latest.onnx").with_layout("NHWC").load(),
        lambda: FaceTracker(compute_dtype=torch.bfloat16),
        lambda: MultiHandTracker(compute_dtype=torch.bfloat16),
        lambda: BodyTracker(compute_dtype=torch.bfloat16),
        *(lambda name=name: ev.RUNNERS[name]() for name in ev.RUNNERS),
        Embedder,
        FaceIdentifier,
        StreamIdentifier,
        lambda: StreamIdentifier(threshold=0.5, crop_grow=0.1),
        lambda: blend(Image.new(4, 4), Image.new(2, 2)),
        resolve_device,
        lambda: resolve_device("cuda"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_num_bit_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1e3, 1e3, 4000),
        np.arange(-20, 20) * 0.5,  # exact halves
        rng.normal(0, 30, 1000),
    ]).astype(np.float32)
    _eq(tnum.round_half_away(_t(x)), jnum.round_half_away(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(
        tnum.sigmoid(_t(x / 50)).numpy(), np.asarray(jnum.sigmoid(jnp.asarray(x / 50))), maxulp=2
    )
    _eq(tnum.div(_t(x), 30.0), jnp.asarray(x) / np.float32(30.0))


def _rects(rng, n, rot=True):
    r = np.stack([
        rng.uniform(0, 1920, n), rng.uniform(0, 1080, n),
        rng.uniform(20, 900, n), rng.uniform(20, 900, n),
        rng.uniform(-3.1, 3.1, n) if rot else np.zeros(n),
    ], -1)
    return r.astype(np.float32)


def test_geometry_bit_exact():
    rng = np.random.default_rng(1)
    rr = _rects(rng, 64)
    pts = rng.uniform(-300, 300, (64, 468, 2)).astype(np.float32)
    rad = rng.uniform(-3.1, 3.1, 64).astype(np.float32)
    _eq(tgeom.rect_grow_rel(_t(rr[:, :4]), 0.3), jgeom.rect_grow_rel(jnp.asarray(rr[:, :4]), 0.3))
    aspect = float(np.float32(192) / np.float32(128))
    _eq(tgeom.rect_grow_to_fit_aspect(_t(rr[:, :4]), aspect),
        jgeom.rect_grow_to_fit_aspect(jnp.asarray(rr[:, :4]), np.float32(aspect)))
    _eq(tgeom.rect_iou(_t(rr[:1, :4]), _t(rr[:, :4])),
        jgeom.rect_iou(jnp.asarray(rr[:1, :4]), jnp.asarray(rr[:, :4])))
    _near(tgeom.rrect_transform_out(_t(rr[:, None, :]), _t(pts)),
          jgeom.rrect_transform_out(jnp.asarray(rr[:, None, :]), jnp.asarray(pts)))
    _near(tgeom.rrect_bounding(_t(rad), _t(pts)), jgeom.rrect_bounding(jnp.asarray(rad), jnp.asarray(pts)))
    _near(tgeom.signed_angle_to_x(_t(pts)), jgeom.signed_angle_to_x(jnp.asarray(pts)))
    # At angle 0 (cos 1, sin 0 in both libraries) the rotations are exact.
    rr0 = _rects(rng, 64, rot=False)
    _eq(tgeom.rrect_transform_out(_t(rr0[:, None, :]), _t(pts)),
        jgeom.rrect_transform_out(jnp.asarray(rr0[:, None, :]), jnp.asarray(pts)))
    _eq(tgeom.rrect_bounding(_t(rr0[:, 4]), _t(pts)),
        jgeom.rrect_bounding(jnp.asarray(rr0[:, 4]), jnp.asarray(pts)))


def test_pipeline_ops_bit_exact():
    rng = np.random.default_rng(2)
    det, lm = (128, 128), (192, 192)
    for h, w in ((1080, 1920), (720, 1280)):
        fit_t, rr_t = tops.full_frame_fit(torch.zeros((2, h, w, 4), dtype=torch.uint8), TRes(*det))
        fit_j, rr_j = jops.full_frame_fit(jnp.zeros((h, w, 4), jnp.uint8), JRes(*det))
        _eq(fit_t, fit_j)
        _eq(rr_t, rr_j)
    boxes = rng.uniform(0, 128, (8, 4)).astype(np.float32)
    fit = np.asarray(fit_j)
    _eq(tops.unmap_center_size(_t(boxes), _t(np.tile(fit, (8, 1))), TRes(*det)),
        jnp.stack([jops.unmap_center_size(jnp.asarray(b), jnp.asarray(fit), JRes(*det)) for b in boxes]))
    _eq(tops.unmap_points(_t(boxes[:, :2]), _t(fit), TRes(*det)),
        jops.unmap_points(jnp.asarray(boxes[:, :2]), jnp.asarray(fit), JRes(*det)))
    rois = _rects(rng, 8)
    coords = rng.uniform(0, 192, (8, 468, 3)).astype(np.float32)
    angles = rng.uniform(-1, 1, 8).astype(np.float32)
    _eq(tops.aspect_view_rect(_t(rois), TRes(*lm)),
        jnp.stack([jops.aspect_view_rect(jnp.asarray(r), JRes(*lm)) for r in rois]))
    xy_t, pos_t = tops.landmarks_to_image(_t(coords), _t(rois), TRes(*lm))
    got_j = [jops.landmarks_to_image(jnp.asarray(c), jnp.asarray(r), JRes(*lm)) for c, r in zip(coords, rois)]
    _eq(xy_t, jnp.stack([g[0] for g in got_j]))
    _near(pos_t, jnp.stack([g[1] for g in got_j]))
    _near(tops.padded_roi(_t(coords[..., :2]), _t(angles), 0.3),
        jnp.stack([jops.padded_roi(jnp.asarray(c[:, :2]), jnp.asarray(a), 0.3) for c, a in zip(coords, angles)]))


def test_decode_and_nms_match_jax():
    """SSD decode and weighted NMS on random BlazeFace-shaped outputs.
    Decode is bit-exact apart from the sigmoid (each library's own exp;
    held to 2 ulp); the NMS sums 896 weighted boxes in each library's own
    order (held to 1e-5 relative)."""
    from zaru_tpu.detection import decode_ssd_device as j_decode
    from zaru_tpu.detection.nms import nms_average_device as j_nms
    from zaru_tpu.face.detection import ShortRangeNetwork as JNet
    from zaru_tpu_torch.detection import Anchors, decode_ssd_device as t_decode
    from zaru_tpu_torch.detection.nms import nms_average_device as t_nms
    from zaru_tpu_torch.face.detection import ShortRangeNetwork as TNet

    rng = np.random.default_rng(3)
    anchors = Anchors.calculate(TNet.LAYERS).centers
    np.testing.assert_array_equal(anchors, JNet().anchors.centers)
    B, N = 2, len(anchors)
    boxes_raw = rng.normal(0, 4, (B, N, 16)).astype(np.float32)
    boxes_raw[..., 2:4] = rng.uniform(10, 40, (B, N, 2))
    conf_raw = rng.normal(-3, 3, (B, N, 1)).astype(np.float32)
    t_out = t_decode(128, 128, _t(anchors), _t(boxes_raw), _t(conf_raw), 0.5, 6)
    for b in range(B):
        j_out = j_decode(128, 128, jnp.asarray(anchors), jnp.asarray(boxes_raw[b]),
                         jnp.asarray(conf_raw[b]), 0.5, 6)
        _eq(t_out[0][b], j_out[0])
        _eq(t_out[2][b], j_out[2])
        np.testing.assert_array_max_ulp(t_out[1][b].numpy(), np.asarray(j_out[1]), maxulp=2)
    angles = tgeom.signed_angle_to_x(t_out[2][..., 1, :] - t_out[2][..., 0, :])
    for max_out in (1, 4):
        got = t_nms(t_out[0], t_out[1], t_out[2], angles, max_out=max_out)
        for b in range(B):
            want = j_nms(jnp.asarray(t_out[0][b].numpy()), jnp.asarray(t_out[1][b].numpy()),
                         jnp.asarray(t_out[2][b].numpy()), jnp.asarray(angles[b].numpy()),
                         max_out=max_out)
            np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
            assert np.asarray(want[0]).any()
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_palm_decode_matches_jax():
    """Palm detection: the port's anchors are JAX's 2016, and the decode with
    7 keypoints and the fingers-up angle matches JAX's on random palm-shaped
    outputs (boxes and keypoints bit for bit, the sigmoid within 2 ulp, the
    angle, through ``atan2``, within 4 ulp)."""
    from zaru_tpu.hand.detection import LiteNetwork as JPalm
    from zaru_tpu_torch.hand.detection import LiteNetwork as TPalm

    rng = np.random.default_rng(5)
    jnet, tnet = JPalm(), TPalm(device="cpu")
    assert tnet.anchors.centers.shape == (2016, 2)
    np.testing.assert_array_equal(tnet.anchors.centers, jnet.anchors.centers)
    B, N = 2, 2016
    boxes_raw = rng.normal(0, 20, (B, N, 18)).astype(np.float32)
    conf_raw = rng.normal(-3, 3, (B, N, 1)).astype(np.float32)
    got = tnet.decode_device([_t(boxes_raw), _t(conf_raw)], 0.5)
    for b in range(B):
        want = jnet.decode_device([jnp.asarray(boxes_raw[b]), jnp.asarray(conf_raw[b])], 0.5)
        assert got[2][b].shape == (N, 7, 2)
        _eq(got[0][b], want[0])
        _eq(got[2][b], want[2])
        np.testing.assert_array_max_ulp(got[1][b].numpy(), np.asarray(want[1]), maxulp=2)
        _near(got[3][b], want[3])


def test_one_euro_matches_jax():
    """1€ filter over several steps, including a seeded reset and a
    zero-elapsed step: bit-exact."""
    from zaru_tpu.filters import OneEuroFilter as JF
    from zaru_tpu_torch.filters import OneEuroFilter as TF

    rng = np.random.default_rng(4)
    jf, tf = JF(1.0, 0.5), TF(1.0, 0.5)
    js = {k: jnp.asarray(v) for k, v in jf.init_state((2, 468, 3)).items()}
    ts = tf.init_state((2, 468, 3), "cpu")
    for step, elapsed in enumerate([1 / 30, 1 / 30, 0.0, 1 / 30, 1 / 60]):
        v = rng.uniform(0, 192, (2, 468, 3)).astype(np.float32)
        js, jo = jf.apply(js, jnp.asarray(v), elapsed)
        ts, to = tf.apply(ts, _t(v), elapsed)
        _eq(to, jo)
        for k in ("x", "dx", "init"):
            _eq(ts[k], js[k])


@pytest.mark.parametrize("which", ["detection", "landmark"])
def test_full_hand_networks_gated(which, monkeypatch):
    """Both full hand networks raise ModelMissingError naming their blob
    while it is absent, in the port (at construction) and in JAX (at
    ``.cnn()``, tests/test_hand_body.py's form holds both)."""
    import importlib

    from zaru_tpu.assets import ModelMissingError as JaxMissing

    from zaru_tpu_torch.assets import ModelMissingError

    monkeypatch.delenv("ZARU_TPU_MODELS", raising=False)
    port = importlib.import_module(f"zaru_tpu_torch.hand.{which}")
    ref = importlib.import_module(f"zaru_tpu.hand.{which}")
    blob = port.FullNetwork.FILE
    assert blob == ref.FullNetwork.FILE == {"detection": "palm_detection_full.onnx",
                                             "landmark": "hand_landmark_full.onnx"}[which]
    with pytest.raises(ModelMissingError, match=blob):
        port.FullNetwork(device="cpu").cnn()
    with pytest.raises(JaxMissing, match=blob):
        ref.FullNetwork().cnn()


def test_palm_keypoints_and_anchors_match_jax():
    """``ALL_KEYPOINTS`` and both palm networks' anchor layouts equal
    JAX's (numpy)."""
    from zaru_tpu.detection import Anchors as JaxAnchors
    from zaru_tpu.hand import detection as ref

    from zaru_tpu_torch.detection import Anchors
    from zaru_tpu_torch.hand import detection as port

    assert [(k.name, int(k)) for k in port.ALL_KEYPOINTS] == [(k.name, int(k)) for k in ref.ALL_KEYPOINTS]
    for name in ("LiteNetwork", "FullNetwork"):
        mine, theirs = getattr(port, name), getattr(ref, name)
        assert mine.NUM_KEYPOINTS == theirs.NUM_KEYPOINTS == len(port.ALL_KEYPOINTS)
        want = JaxAnchors.calculate(theirs.LAYERS).centers
        got = Anchors.calculate(mine.LAYERS).centers
        assert got.shape == (2016, 2)
        np.testing.assert_array_equal(got, want)


def test_full_hand_networks_run_their_blob(tmp_path, monkeypatch):
    """With the Lite blobs provided under the Full names (``ZARU_TPU_MODELS``
    naming a temporary folder), each FullNetwork loads its own file and gives
    the Lite network's detections and landmarks on the photo bit for bit."""
    import shutil

    from zaru_tpu_torch.assets import fixture_path, model_path
    from zaru_tpu_torch.detection import Detector
    from zaru_tpu_torch.hand import detection as palm, landmark as hand
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.landmark import Estimator
    from zaru_tpu_torch.rect import Rect

    for lite, full in ((palm.LiteNetwork, palm.FullNetwork), (hand.LiteNetwork, hand.FullNetwork)):
        shutil.copy(model_path(lite.FILE), tmp_path / full.FILE)
    monkeypatch.setenv("ZARU_TPU_MODELS", str(tmp_path))
    assert model_path(palm.FullNetwork.FILE) == tmp_path / palm.FullNetwork.FILE
    image = Image.load(fixture_path("sad_linus.jpg"), device="cpu")

    def detections(cls):
        det = Detector(cls(device="cpu"))
        det.set_threshold(0.1)  # the photo has no hand: keep the weak candidates
        return [(d.confidence(), d.angle(), np.asarray(d.bounding_rect().center()), np.asarray(d.keypoints()))
                for d in det.detect(image)]

    def landmarks(cls):
        est = Estimator(cls(device="cpu")).estimate(image.view(Rect.from_top_left(300.0, 100.0, 400.0, 400.0)))
        return est.landmarks_mut().positions().copy(), est.presence, est.raw_handedness

    lite, full = detections(palm.LiteNetwork), detections(palm.FullNetwork)
    assert len(lite) == len(full) > 0
    for a, b in zip(lite, full):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    (pa, qa, ha), (pb, qb, hb) = landmarks(hand.LiteNetwork), landmarks(hand.FullNetwork)
    np.testing.assert_array_equal(pa, pb)
    assert pa.shape == (21, 3) and (qa, ha) == (qb, hb)


def test_info_marks_no_wrapper_unported(capsys):
    """``info`` lists every model of the JAX package's table, each wrapper
    ported."""
    from zaru_tpu_torch.__main__ import _KNOWN_MODELS, _ported, main

    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "(wrapper not ported)" not in out
    assert all(_ported(wrapper) for wrapper, _ in _KNOWN_MODELS)
    assert "hand.detection.FullNetwork" in out and "hand.landmark.FullNetwork" in out
