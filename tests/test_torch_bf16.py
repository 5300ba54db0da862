"""bf16 network bodies in the port (``compute_dtype=torch.bfloat16``) against
zaru_tpu's ``compute_dtype=jnp.bfloat16``, on the CPU.

- **Single ops**, bit for bit: each op on bf16 inputs, as JAX's handler
  computes it on materialised bf16 arrays (zaru_tpu/onnx/ops.py called op
  by op): Conv with a bias (3×3 stride 2 with asymmetric pads, 1×1,
  depthwise 3×3 and 5×5), Add then PRelu, Gemm with ``alpha`` and
  ``beta``, and Resize (2× bilinear, square and not). Conv adds its bias
  after rounding the convolution to bf16, Gemm rounds its product before
  ``alpha`` and ``beta · c``, and Resize rounds between its two axes.
- **Networks**: every network the trackers load (the six shipped blobs and
  the two pose stubs) at batch 4 on seeded inputs in its colour range,
  against JAX's ``jax.jit`` of the bf16 graph. Op by op the port computes
  what JAX's handlers compute: each node of the hand and palm networks, fed
  JAX's activations, gives JAX's eager result bit for bit (Clip,
  GlobalAveragePool, Gemm, Sigmoid, PRelu, Add, MaxPool, Pad, Resize), but
  for Conv outputs summed in another f32 order (4 of 4.4 million hand, 53 of
  4.7 million palm outputs, half an ulp of the node's |max| at most).
  Resize was the one difference of semantics, now followed (it rounds
  between its axes). Inside one compiled graph XLA:CPU rounds at places of
  its own (it keeps f32 between some ops), so the whole networks are not
  bit-equal: each output is held within
  NET_TOL_ULPS bf16 units in the last place of ``max(1, |out|max)`` (the
  repo's CNN bar's scale, tests/test_onnx_importer.py:63-66: one ulp is
  2^(floor(log2 max(1, |out|max)) - 7)), measured below. JAX's own
  bf16-against-f32 gap is as large or larger.
- **The module**: a bf16 module builds no stage plan and never calls
  ``cnn_stage.fused_blocks``; building and running one leaves an f32 module
  bit-identical and every precision flag as it was; ``params()`` stays
  f32; ``load_params`` reaches the bf16 copy.
- **Trackers**: one gated step at a time from JAX's state of bf16
  ``FaceTracker``, ``MultiHandTracker`` (the open thresholds of
  tests/test_torch_multi_object.py, so its slots keep values) and
  ``BodyTracker`` on the stub pose models, with flags equal and landmarks
  and ROIs within TRACK_TOL_PX image pixels. Every other entry point of the
  bf16 ``FaceTracker`` and ``MultiHandTracker`` runs, with the flags of the
  f32 port and landmarks within a bf16 gap of it.

JAX's results are stored in ``zaru_tpu_torch/fixtures/bf16_models.npz``
(``chip_smoke.py`` replays the networks and the tracker steps on the GPU).
Only ``test_fixture_is_current`` runs JAX, in the test process.
Regenerate it with::

    JAX_PLATFORMS=cpu python tests/test_torch_bf16.py
"""

import json
import os
import sys

import numpy as np
import pytest

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stub_models  # noqa: E402
from torch_port import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "zaru_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "bf16_models.npz")
ONNX_DIR = os.path.join(ROOT, "assets", "onnx")
NET_BATCH = 4
# name: (ONNX file, colour range, output selection, input side). The pose
# files are the stubs of tests/stub_models.py, written where
# ZARU_TPU_MODELS points.
NETS = {
    "short_range": ("face_detection_short_range.onnx", (-1.0, 1.0), None, 128),
    "full_range": ("face_detection_full_range.onnx", (-1.0, 1.0), None, 192),
    "face_mesh_v1": ("face_landmark.onnx", (-1.0, 1.0), None, 192),
    "face_mesh_v2": ("face_landmarks_detector.onnx", (-1.0, 1.0), None, 256),
    "palm_lite": ("palm_detection_lite.onnx", (0.0, 1.0), None, 192),
    "hand_lite": ("hand_landmark_lite.onnx", (0.0, 1.0), None, 224),
    "pose_detection_stub": ("pose_detection.onnx", (-1.0, 1.0), None, 224),
    "pose_landmark_stub": ("pose_landmark_lite.onnx", (0.0, 1.0), [0, 1], 256),
}
STUB_BLOBS = {"pose_detection.onnx": stub_models.build_pose_detection_stub,
              "pose_landmark_lite.onnx": stub_models.build_pose_landmark_stub}
# Each network's largest error over its outputs in those ulps, measured
# (CPU, batch 4): short range 2, full range 2, Face Mesh V1 1.16, V2 18.45
# (its face-flag logit, |max| 15.1, off by 1.15; its landmarks 7, 7 crop
# pixels of 256; JAX's own bf16 run is 19 crop pixels and 1.24 from its f32
# run at batch 4), palm 2, hand 1.37 (its handedness, 0.0107), the stubs 0
# (constants through a zero Gemm). chip_smoke.py holds the card to the same
# bounds, against JAX and against this CPU run; an H100 (700 W) measured
# 2, 2, 1.16, 15.45, 2 and 1.03 against JAX, and 3, 2.5, 1, 17.5, 2 and 1
# against the CPU.
NET_TOL_ULPS = {"short_range": 4, "full_range": 4, "face_mesh_v1": 4, "face_mesh_v2": 24,
                "palm_lite": 4, "hand_lite": 4, "pose_detection_stub": 0, "pose_landmark_stub": 0}
BATCH = 2
S = 3
# Tracker runs: (tracker class, keyword arguments, plan); a plan step is
# (start, force_detect, zeroed streams) as in tests/test_torch_multi_object.py.
HAND_SEED_ROIS = [
    [(640, 360, 240, 240, 0.0), (420, 300, 420, 380, 3.1), (660, 360, 240, 240, -1.57)],
    [(700, 400, 600, 600, 1.6), (300, 500, 520, 560, -3.05), (0, 0, 0, 0, 0)],
]
HAND_SEED_ACTIVE = [[True, True, True], [True, True, False]]
BODY_SEED_ROIS = [[(160, 90, 120, 120, 0.3), (0, 0, 0, 0, 0)], [(100, 100, 200, 200, -2.0), (250, 60, 60, 90, 1.0)]]
BODY_SEED_ACTIVE = [[True, False], [True, True]]
TRACKERS = {
    "face": ("FaceTracker", {}, [("init", False, ()), ("carry", False, ()), ("carry", False, (1,))]),
    "hand": ("MultiHandTracker", {"max_hands": S, "detection_threshold": 0.2, "presence_threshold": 0.0},
             [("init", False, ()), ("carry", False, ()), ("seed", False, ())]),
    "body": ("BodyTracker", {"max_bodies": 2}, [("init", False, ()), ("carry", False, ()), ("seed", False, ())]),
}
# One-step tolerances in image pixels of landmarks and ROIs: (a step that
# tracks, one that seeds a slot from a new detection). Measured on the CPU
# from JAX's state: the face 2.0 px tracking and 2.6 px seeding (one bf16
# ulp of a Face Mesh coordinate in [128, 256) is one crop pixel, 1.6 image
# pixels on a 300 px face); the hand 3.3 px tracking, and seeded from the
# palm detector 19.1 px (landmarks) and 26.0 px (ROIs): one ulp of a palm
# box coordinate in [256, 512) is 2 pixels of the 192² letterbox, 13.3
# pixels of the 1280-pixel frame; JAX's own bf16 step is 38.8 px from its
# f32 step there (the photo has no hand). The body stubs 6.1e-5 px. Scores
# (confidence, presence, handedness, pose flag, visibility): 0.0144
# (handedness) at most. On an H100 (chip_smoke.py): the face 2.59 px, the
# hand 24.0 px (landmarks) and 34.3 px (ROIs) on the seeding step, 2.6 palm
# box ulps; scores 0.0174.
TRACK_TOL_PX = {"face": (4.0, 4.0), "hand": (8.0, 40.0), "body": (1e-3, 1e-3)}
TRACK_SCORE_TOL = 0.05
# The bf16 trackers' entry points against the f32 port's, from a fresh
# state (px): face 2.44, hand 25.3 measured (a detection step on the photo,
# which has no hand; JAX measured up to ~21 px on such crops).
ENTRY_TOL_PX = {"face": 4.0, "hand": 40.0}
VALUE_KEYS = ("landmarks", "roi", "rois", "confidence", "presence", "handedness", "pose_flag", "visibility")


def ulp_of_max(a) -> float:
    """One bf16 ulp of ``max(1, |a|max)``."""
    return 2.0 ** (np.floor(np.log2(max(1.0, float(np.abs(a).max())))) - 7)


def net_input(name, batch=NET_BATCH, seed=21):
    """The seeded input ``[batch,3,side,side]`` of network ``name`` in its
    colour range (chip_smoke.py makes rows 0-3 alike)."""
    _file, (lo, hi), _subset, side = NETS[name]
    return np.random.default_rng(seed).uniform(lo, hi, (batch, 3, side, side)).astype(np.float32)


def net_path(name, model_dir):
    file = NETS[name][0]
    return os.path.join(model_dir if file in STUB_BLOBS else ONNX_DIR, file)


def write_stubs(directory):
    for file, build in STUB_BLOBS.items():
        with open(os.path.join(directory, file), "wb") as f:
            f.write(build())


# --- single ops ----------------------------------------------------------------


def bf16_values(shape, rng, scale=1.0):
    """Seeded values that bf16 holds exactly, as f32."""
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).bfloat16().float().numpy()


OP_CASES = ["conv 3x3 stride 2 asymmetric pads", "conv 1x1", "depthwise 3x3", "depthwise 5x5", "add then prelu",
            "gemm alpha beta", "resize 2x square", "resize 2x 12x20", "resize 2x 20x12", "f32 constant"]


def op_cases():
    """name: (ONNX graph bytes, inputs) for each of OP_CASES."""
    from zaru_tpu.onnx.writer import OnnxWriter

    rng = np.random.default_rng(22)
    cases = {}

    def conv(name, x_shape, w_shape, **attrs):
        w = OnnxWriter(opset=13)
        w.input("x", x_shape)
        w.initializer("w", bf16_values(w_shape, rng, 0.3))
        w.initializer("b", bf16_values((w_shape[0],), rng))
        w.node("Conv", ["x", "w", "b"], ["y"], **attrs)
        w.output("y", x_shape)
        cases[name] = (w.serialize(), [bf16_values(x_shape, rng)])

    conv("conv 3x3 stride 2 asymmetric pads", (2, 8, 13, 11), (16, 8, 3, 3), strides=[2, 2], pads=[0, 1, 1, 2])
    conv("conv 1x1", (2, 24, 9, 9), (32, 24, 1, 1))
    conv("depthwise 3x3", (2, 16, 12, 12), (16, 1, 3, 3), group=16, pads=[1, 1, 1, 1])
    conv("depthwise 5x5", (2, 16, 12, 12), (16, 1, 5, 5), group=16, pads=[2, 2, 2, 2])

    w = OnnxWriter(opset=13)
    w.input("x", (2, 8, 10, 10))
    w.input("y", (2, 8, 10, 10))
    w.initializer("slope", bf16_values((8, 1, 1), rng, 0.2))
    w.node("Add", ["x", "y"], ["s"])
    w.node("PRelu", ["s", "slope"], ["z"])
    w.output("z", (2, 8, 10, 10))
    cases["add then prelu"] = (w.serialize(), [bf16_values((2, 8, 10, 10), rng), bf16_values((2, 8, 10, 10), rng)])

    w = OnnxWriter(opset=13)
    w.input("a", (3, 48))
    w.initializer("b", bf16_values((20, 48), rng, 0.3))
    w.initializer("c", bf16_values((20,), rng))
    w.node("Gemm", ["a", "b", "c"], ["y"], transB=1, alpha=0.5, beta=2.0)
    w.output("y", (3, 20))
    cases["gemm alpha beta"] = (w.serialize(), [bf16_values((3, 48), rng)])

    for name, (h, wd) in (("resize 2x square", (12, 12)), ("resize 2x 12x20", (12, 20)), ("resize 2x 20x12", (20, 12))):
        w = OnnxWriter(opset=13)
        w.input("x", (2, 8, h, wd))
        w.initializer("roi", np.zeros(0, np.float32))
        w.initializer("scales", np.asarray([1, 1, 2, 2], np.float32))
        w.node("Resize", ["x", "roi", "scales"], ["y"], mode="linear", coordinate_transformation_mode="half_pixel")
        w.output("y", (2, 8, 2 * h, 2 * wd))
        cases[name] = (w.serialize(), [bf16_values((2, 8, h, wd), rng)])

    # A float Constant stays f32 (JAX's is a numpy array), so the PRelu it
    # feeds and what follows run in f32; Clip's bounds and the shape are
    # read on the host.
    w = OnnxWriter(opset=11)
    w.input("x", (1, 3, 5, 4))
    w.initializer("bias", bf16_values((3, 1, 1), rng))
    w.node("Constant", [], ["scale"], value=np.asarray([[[0.3]], [[-2.0]], [[3.1]]], np.float32))
    w.node("Constant", [], ["lo"], value=np.asarray(-1.5, np.float32))
    w.node("Constant", [], ["hi"], value=np.asarray(2.5, np.float32))
    w.node("Constant", [], ["shape"], value=np.asarray([1, 3, -1], np.int64))
    w.node("PRelu", ["x", "scale"], ["m"])
    w.node("Add", ["m", "bias"], ["a"])
    w.node("Clip", ["a", "lo", "hi"], ["c"])
    w.node("Reshape", ["c", "shape"], ["y"])
    w.output("y", (1, 3, 20))
    cases["f32 constant"] = (w.serialize(), [bf16_values((1, 3, 5, 4), rng)])
    assert list(cases) == OP_CASES
    return cases


# --- the JAX side (test_fixture_is_current and regeneration only) -------------


def jax_ops():
    """JAX's op handlers on each case, op by op on bf16 arrays: case → the
    graph's output as f32."""
    import jax.numpy as jnp

    from zaru_tpu.onnx.ops import OPS
    from zaru_tpu.onnx.proto import parse_model

    out = {}
    for name, (data, inputs) in op_cases().items():
        g = parse_model(data).graph
        env = {vi.name: jnp.asarray(x, jnp.bfloat16) for vi, x in zip(g.inputs, inputs)}
        static = {}
        for k, v in g.initializers.items():
            if k in ("roi", "scales"):
                static[k] = v
            else:
                env[k] = jnp.asarray(v, jnp.bfloat16)
        for node in g.nodes:
            vals = [env.get(i, static.get(i)) if i else None for i in node.inputs]
            statics = [static.get(i) if i else None for i in node.inputs]
            y = env[node.outputs[0]] = OPS[node.op_type](node, vals, statics)
            if isinstance(y, np.ndarray):  # a Constant, as the importer keeps it
                static[node.outputs[0]] = y
        assert y.dtype == (jnp.float32 if name == "f32 constant" else jnp.bfloat16), (name, y.dtype)
        out[f"op/{name}"] = np.asarray(y.astype(jnp.float32))
    return out


def jax_nets(model_dir):
    """JAX's ``load_model(..., compute_dtype=jnp.bfloat16)`` of every network
    at batch NET_BATCH, under ``jax.jit``: outputs, and the params."""
    import jax
    import jax.numpy as jnp

    from zaru_tpu.onnx import load_model

    out, params = {}, {}
    for name, (_file, _range, subset, _side) in NETS.items():
        m = load_model(net_path(name, model_dir), output_subset=subset, compute_dtype=jnp.bfloat16)
        # The graphs take batch 1; the cascades map them over the batch.
        outs = jax.jit(jax.vmap(lambda p, x: m.apply(p, x[None]), (None, 0)))(m.params, jnp.asarray(net_input(name)))
        for i, o in enumerate(outs):
            assert o.dtype == jnp.float32
            out[f"net/{name}/{i}"] = np.asarray(o)[:, 0]
        params[name] = {k: np.asarray(v) for k, v in m.params.items()}
    return out, params


def photo(name):
    """The tracker ``name``'s frame: the fixture photo (1280×720; 320×180
    for the body stubs), RGBA."""
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        rgb = f["rgb"]
    if name == "body":
        rgb = rgb[::4, ::4]
    return np.ascontiguousarray(np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1))


def frames_for(rgba, zeroed):
    frames = np.stack([rgba] * BATCH)
    frames[list(zeroed)] = 0
    return frames


def seed_state(name):
    rois, active = (HAND_SEED_ROIS, HAND_SEED_ACTIVE) if name == "hand" else (BODY_SEED_ROIS, BODY_SEED_ACTIVE)
    return {"rois": np.asarray(rois, np.float32), "active": np.asarray(active), "frame": np.ones(BATCH, np.int32)}


def flatten(tree, prefix):
    """A nested dict of arrays as ``{prefix + "a/b": array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def jax_tracker(name, model_dir):
    """JAX's bf16 tracker ``name`` over its plan, gated: its keyword
    arguments and plan (for chip_smoke.py), each step's state before it and
    its outputs, as fixture arrays; and the params."""
    import jax.numpy as jnp

    import zaru_tpu.pipeline as jp

    os.environ["ZARU_TPU_MODELS"] = model_dir
    cls, kwargs, plan = TRACKERS[name]
    tracker = getattr(jp, cls)(compute_dtype=jnp.bfloat16, **kwargs)
    rgba, prefix = photo(name), f"track/{name}/"
    out = {prefix + "kwargs": np.asarray(json.dumps(kwargs)), prefix + "force": np.asarray([f for _, f, _ in plan]),
           prefix + "zero": np.asarray([[b in z for b in range(BATCH)] for _, _, z in plan])}
    state = None
    for t, (start, force, zeroed) in enumerate(plan):
        if start == "init":
            state = tracker.init_state(batch=BATCH)
        elif start == "seed":
            state = {k: jnp.asarray(v) for k, v in seed_state(name).items()}
        out.update(flatten(state, f"track/{name}/{t}/state/"))
        state, step_out = tracker._step_batch_gated(tracker.params, state, jnp.asarray(frames_for(rgba, zeroed)), force)
        out.update(flatten(step_out, f"track/{name}/{t}/out/"))
    return out, tracker.params


def jax_now(model_dir):
    """Every JAX result the fixture stores, and the params of each network
    and of each tracker."""
    now = jax_ops()
    nets, net_params = jax_nets(model_dir)
    now.update(nets)
    tracker_params = {}
    for name in TRACKERS:
        arrays, tracker_params[name] = jax_tracker(name, model_dir)
        now.update(arrays)
    return now, net_params, tracker_params


def regen():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        write_stubs(d)
        arrays = jax_now(d)[0]
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}")


# --- the tests -----------------------------------------------------------------


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def stub_dir(tmp_path_factory):
    """The pose stubs in a temporary directory that ``ZARU_TPU_MODELS``
    names, for the module."""
    d = str(tmp_path_factory.mktemp("stub_onnx"))
    write_stubs(d)
    old = os.environ.get("ZARU_TPU_MODELS")
    os.environ["ZARU_TPU_MODELS"] = d
    try:
        yield d
    finally:
        if old is None:
            os.environ.pop("ZARU_TPU_MODELS", None)
        else:
            os.environ["ZARU_TPU_MODELS"] = old


def load(name, model_dir, dtype=torch.bfloat16):
    from zaru_tpu_torch.onnx import load_model

    return load_model(net_path(name, model_dir), torch.device("cpu"), NETS[name][2], dtype)


def test_fixture_is_current(stored, stub_dir):
    """The stored JAX results are what zaru_tpu computes now (single ops bit
    for bit; networks and trackers within 1e-3 and one bf16 ulp of each
    output's scale, the regen machine's own rounding), and the port's
    networks hold JAX's weights bit for bit."""
    from zaru_tpu_torch.weights import network_params_from_jax, params_from_jax

    now, net_params, tracker_params = jax_now(stub_dir)
    assert set(now) == set(stored)
    for k, v in now.items():
        if k.startswith("op/") or v.dtype.kind != "f":
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
        else:
            tol = max(1e-3, ulp_of_max(v))
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=tol, equal_nan=True, err_msg=k)
    for name, jparams in net_params.items():
        got = load(name, stub_dir).params()
        want = network_params_from_jax(jparams)
        assert set(got) == set(want), name
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=f"{name}/{k}")
    for name, jparams in tracker_params.items():
        port = port_tracker(name)
        for net, cnn in params_from_jax(jparams).items():
            got = {"det": port.det_cnn, "lm": port.lm_cnn}[net].net.params()
            for k, v in cnn.items():
                np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=f"{name}/{net}/{k}")


@pytest.mark.parametrize("case", OP_CASES)
def test_single_op_bit_equal(stored, case):
    """The op in a bf16 module gives JAX's handler's bf16 result bit for
    bit."""
    from zaru_tpu_torch.onnx import load_model

    data, inputs = op_cases()[case]
    m = load_model(data, torch.device("cpu"), compute_dtype=torch.bfloat16)
    with torch.inference_mode():
        got = m(*(torch.from_numpy(x) for x in inputs))[0]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), stored[f"op/{case}"])


@pytest.mark.parametrize("name", list(NETS))
def test_network_matches_jax(stored, stub_dir, name):
    """Every output of the bf16 network is f32 and within NET_TOL_ULPS bf16
    ulps of ``max(1, |out|max)`` from JAX's bf16 run."""
    m = load(name, stub_dir)
    with torch.inference_mode():
        outs = m(torch.from_numpy(net_input(name)))
    for i, o in enumerate(outs):
        want = stored[f"net/{name}/{i}"]
        assert o.dtype == torch.float32 and tuple(o.shape) == want.shape
        err = float(np.abs(o.numpy() - want).max())
        ulp = ulp_of_max(want)
        assert err <= NET_TOL_ULPS[name] * ulp, f"{name} output {i}: {err} ({err / ulp:.2f} ulps)"


def test_bf16_module_has_no_stage_plan(monkeypatch):
    """Face Mesh V1 in bf16 has an empty stage plan and never reaches the
    stage kernel's wrapper; in f32 it has its 8 chains."""
    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.ops import cnn_stage

    path = os.path.join(ONNX_DIR, "face_landmark.onnx")
    assert len(load_model(path, torch.device("cpu")).stages) == 8
    m = load_model(path, torch.device("cpu"), compute_dtype=torch.bfloat16)
    assert m.stages == [] and m._packed == {}

    def refuse(*args, **kwargs):
        raise AssertionError("a bf16 module called fused_blocks")

    monkeypatch.setattr(cnn_stage, "fused_blocks", refuse)
    with torch.inference_mode():
        outs = m(torch.from_numpy(net_input("face_mesh_v1", batch=1)))
    assert all(o.dtype == torch.float32 for o in outs)


def test_f32_module_unchanged_by_bf16():
    """Building and running a bf16 module leaves an f32 module's outputs bit
    for bit as they were, and every precision flag the executor pins as the
    caller set it."""
    from zaru_tpu_torch.onnx import load_model

    path = os.path.join(ONNX_DIR, "hand_landmark_lite.onnx")
    x = torch.from_numpy(net_input("hand_lite", batch=1))
    flags = lambda: (torch.get_float32_matmul_precision(),  # noqa: E731
                     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                     torch.backends.cudnn.allow_tf32)
    before_flags = flags()
    f32 = load_model(path, torch.device("cpu"))
    with torch.inference_mode():
        before = [o.clone() for o in f32(x)]
        load_model(path, torch.device("cpu"), compute_dtype=torch.bfloat16)(x)
        after = f32(x)
    assert flags() == before_flags
    for b, a in zip(before, after):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


def test_params_stay_f32_and_load_params_reaches_bf16():
    """``params()`` of a bf16 module are f32 and equal to an f32 module's;
    zeroed weights through ``load_params`` change the bf16 outputs, and the
    weights loaded back give them bit for bit again."""
    from zaru_tpu_torch.onnx import load_model

    path = os.path.join(ONNX_DIR, "face_detection_short_range.onnx")
    m = load_model(path, torch.device("cpu"), compute_dtype=torch.bfloat16)
    f32 = load_model(path, torch.device("cpu")).params()
    params = {k: v.clone() for k, v in m.params().items()}
    assert all(v.dtype == torch.float32 and torch.equal(v, f32[k]) for k, v in params.items())
    x = torch.from_numpy(net_input("short_range", batch=1))
    with torch.inference_mode():
        want = m(x)
        m.load_params({k: torch.zeros_like(v) for k, v in params.items()})
        zeroed = m(x)
        m.load_params(params)
        again = m(x)
    assert not torch.equal(zeroed[0], want[0]) and float(zeroed[0].abs().max()) == 0.0
    for a, w in zip(again, want):
        assert torch.equal(a, w)


def port_tracker(name, dtype=torch.bfloat16):
    import zaru_tpu_torch.pipeline as tp

    cls, kwargs, _ = TRACKERS[name]
    return getattr(tp, cls)(compute_dtype=dtype, device="cpu", **kwargs)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", list(TRACKERS))
def test_tracker_step_matches_jax(stored, stub_dir, name):
    """From JAX's state before each step, one bf16 gated step gives JAX's
    flags, and its landmarks and ROIs within TRACK_TOL_PX image pixels (the
    looser bound on a step that seeds a slot from a detection), its scores
    within TRACK_SCORE_TOL."""
    port = port_tracker(name)
    rgba = photo(name)
    for t, (_start, force, zeroed) in enumerate(TRACKERS[name][2]):
        state = unflatten(stored, f"track/{name}/{t}/state/")
        want = unflatten(stored, f"track/{name}/{t}/out/")
        _, out = port.step_batch(_torch_tree(state), torch.from_numpy(frames_for(rgba, zeroed)), force)
        got = {k: v.numpy() for k, v in out.items()}
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=f"step {t}")
        was = state.get("active", state.get("tracking"))
        seeded = bool((want["valid"] & ~was).any())
        for k in VALUE_KEYS:
            if k in want:
                tol = TRACK_TOL_PX[name][seeded] if k in ("landmarks", "roi", "rois") else TRACK_SCORE_TOL
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=f"step {t}: {k}")


@pytest.mark.parametrize("name", ["face", "hand"])
def test_every_entry_point_runs(name):
    """The bf16 tracker runs every entry point its f32 form runs (the gated
    batch step in both forms, ``run_frames``, ``run_frame``, ``step`` and,
    for the face, ``scan_video``) from a fresh state on the photo: outputs
    of the f32 form's shapes and dtypes, finite, its flags, and landmarks
    within ENTRY_TOL_PX of it."""
    bf16, f32 = port_tracker(name), port_tracker(name, None)
    frames = torch.from_numpy(frames_for(photo(name), ()))
    calls = {
        "step_batch": lambda tr: tr.step_batch(tr.init_state(BATCH), frames, True),
        "run_frames_gated": lambda tr: tr.run_frames_gated(tr.init_state(BATCH), frames),
        "run_frames": lambda tr: tr.run_frames(tr.init_state(BATCH), frames),
        "run_frame": lambda tr: tr.run_frame(tr.init_state(), frames[0]),
        "step": lambda tr: tr.step(tr.init_state(), frames[0]),
    }
    if name == "face":
        calls["scan_video"] = lambda tr: tr.scan_video(tr.init_state(), frames)
    for entry, call in calls.items():
        (_, got), (_, want) = call(bf16), call(f32)
        assert set(got) == set(want), entry
        for k, v in got.items():
            assert v.shape == want[k].shape and v.dtype == want[k].dtype, (entry, k)
            assert bool(torch.isfinite(v.float()).all()), (entry, k)
        assert torch.equal(got["valid"], want["valid"]), entry
        assert bool(got["valid"].any()), entry
        err = float((got["landmarks"] - want["landmarks"]).abs().max())
        assert err <= ENTRY_TOL_PX[name], f"{entry}: landmarks {err} px from f32"


if __name__ == "__main__":
    import jax

    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    regen()
