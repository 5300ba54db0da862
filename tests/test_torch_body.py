"""The port's body-pose path (zaru_tpu_torch ``BodyTracker``, ``body.detection
.PoseNetwork``, ``body.landmark.LiteNetwork``) against zaru_tpu's, on the
CPU, on the stub pose models.

The pose blobs are missing upstream and from the repository, so both
packages run the stand-ins of ``tests/stub_models.py`` (constant outputs
through a Gemm's bias, whatever the image; the landmark stub has a third
head that output selection ``[0, 1]`` must keep from the decoder). The
fixture ``zaru_tpu_torch/fixtures/body_track.npz`` stores the two stub blobs
as bytes, so a run with no JAX (``chip_smoke.py``) loads the same models;
tests write them into a temporary directory and point ``ZARU_TPU_MODELS``
there, as tests/test_body_cascade.py does.

Every tracker run is ``BodyTracker(max_bodies=2)`` on the fixture photo
subsampled to 320×180, through the gated batch step (batch 2), ``run_frame``
(one stream) or ``run_frames`` (ungated, batch 2). A plan step is ``(start,
force_detect, zeroed streams)``, as in tests/test_torch_multi_object.py; the
``seed`` state holds slots at fixed rects (60-200 px, angles to -2 rad), so
the gated step's crops go through the rotated sampler at 256² on the
256-pixel grid at any angle. Each run is held one step at a time from JAX's
state (flags equal, landmarks and ROIs within STEP_TOL_PX or, on a step
that seeds a slot from a detection, SEED_TOL_PX; scores within
SCORE_TOL) and free-running by its flags.

The fixture also stores JAX's raw network outputs and decodes on the photo
(detector and landmarker), its detection candidates, its ``_candidate_rois``
on random keypoints (the port's ``torch.linalg.vector_norm`` against
``jnp.linalg.norm``), and its rotated sampler on body views (256² on the
256-pixel grid, ``square_views=True``, read by tests/test_torch_samplers.py).
Only ``test_fixture_is_current`` runs JAX, in the test process. Regenerate
it with::

    JAX_PLATFORMS=cpu python tests/test_torch_body.py
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stub_models  # noqa: E402
from torch_port import one_torch_thread  # noqa: E402,F401

FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zaru_tpu_torch", "fixtures"
)
FIXTURE = os.path.join(FIXTURES, "body_track.npz")
BATCH = 2
S = 2
BLOBS = {  # fixture key: the files it is written to
    "blob_pose_detection": ("pose_detection.onnx",),
    "blob_pose_landmark": ("pose_landmark_lite.onnx", "pose_landmark_full.onnx"),
}
# Seeded slots (cx, cy, w, h, theta) on the 320×180 photo; stream 1's two
# slots do not overlap, stream 0's second slot is empty.
SEED_ROIS = [[(160, 90, 120, 120, 0.3), (0, 0, 0, 0, 0)],
             [(100, 100, 200, 200, -2.0), (250, 60, 60, 90, 1.0)]]
SEED_ACTIVE = [[True, False], [True, True]]
GATED_PLAN = [("init", False, ()), ("carry", False, ()), ("carry", True, ()),
              ("carry", False, (1,)), ("seed", False, ())]
SINGLE_PLAN = [("init", False, ()), ("carry", False, ()), ("carry", False, (0,)), ("seed", False, ())]
RUNS = {"gated": GATED_PLAN, "single": SINGLE_PLAN, "ungated": GATED_PLAN}
ENTRY = {"gated": "step_batch", "single": "run_frame", "ungated": "run_frames"}
VALUE_KEYS = ("landmarks", "pose_landmarks", "rois", "pose_flag", "visibility", "presence")
# Body views for tests/test_torch_samplers.py: 256² squares of 150-900 px
# on the 256-pixel grid (strides 1 to 5), any angle, one partly outside
# the frame, on 1080p coordinate frames; [4,2,5]. Their angles are ones
# where XLA's and torch's cos and sin agree (at 2.4 and 0.9 rad the sines
# differ by an ulp, which moved two pixels of a 300 px view).
BODY_VIEWS = [
    (960, 540, 150, 150, 0.0), (700, 500, 300, 300, 2.45), (1200, 400, 420, 420, -0.7),
    (900, 600, 560, 560, 1.57), (960, 540, 700, 700, -3.0), (400, 300, 900, 900, 0.35),
    (100, 1000, 500, 500, 0.8), (1500, 540, 640, 640, -1.2),
]

# One-step tolerances, measured over every run here (CPU): landmarks and
# ROIs of a step that tracks carried slots within 1.53e-5 and 3.81e-5 px, of
# a step that seeds a slot from a detection within 3.05e-5 and 6.10e-5 px
# (an ulp or two at these coordinates); pose flag, visibility and presence
# equal. Detection candidates within 3.05e-5 px. On random keypoints the
# port's norm rounds differently in 20 of 80 candidate values, by up to
# 6.1e-5 px (one ulp of a side near 1000 px). The stub's outputs do not
# depend on the image, so no crop pixel moves anything here; the sampler
# at these shapes is held bit for bit in tests/test_torch_samplers.py.
STEP_TOL_PX = 1e-3
SEED_TOL_PX = 1e-3
SCORE_TOL = 1e-6
NORM_TOL_PX = 1e-4


def seed_state():
    return {"rois": np.asarray(SEED_ROIS, np.float32), "active": np.asarray(SEED_ACTIVE),
            "frame": np.ones(BATCH, np.int32)}


def photo():
    """The fixture photo (1280×720) subsampled to 320×180, RGBA."""
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        rgb = f["rgb"][::4, ::4]
    return np.ascontiguousarray(np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1))


def frames_for(rgba, zeroed):
    frames = np.stack([rgba] * BATCH)
    frames[list(zeroed)] = 0
    return frames


def coord_frames(n, H=1080, W=1920):
    """Coordinate-encoded RGBA frames (tests/test_torch_samplers.py), shifted
    7 px a stream."""
    x = np.arange(W)[None, :].repeat(H, 0)
    y = np.arange(H)[:, None].repeat(W, 1)
    img = np.stack([x & 255, (x >> 8) * 16 + (y >> 8), y & 255, np.full_like(x, 255)], -1).astype(np.uint8)
    return np.stack([np.roll(img, 7 * i, axis=1) for i in range(n)])


def norm_inputs():
    """Random NMS outputs ``(avg_box [B,S,4], avg_kps [B,S,4,2], avg_angle
    [B,S])`` in network-input pixels, and the full-frame fit of the photo."""
    rng = np.random.default_rng(9)
    return (rng.uniform(0, 224, (8, S, 4)).astype(np.float32),
            rng.uniform(0, 224, (8, S, 4, 2)).astype(np.float32),
            rng.uniform(-3, 3, (8, S)).astype(np.float32))


def unmap_u8(c):
    """The [0, 1] colour map of u8 channels ``c``: ``c * f32(1/255)`` rounded
    once, as the compiled samplers compute it."""
    return (c.astype(np.float64) * np.float64(np.float32(1.0) / np.float32(255.0))).astype(np.float32)


def write_blobs(directory, arrays):
    for key, names in BLOBS.items():
        for name in names:
            with open(os.path.join(directory, name), "wb") as f:
                f.write(arrays[key].tobytes())


def stub_blobs():
    return {
        "blob_pose_detection": np.frombuffer(stub_models.build_pose_detection_stub(), np.uint8),
        "blob_pose_landmark": np.frombuffer(stub_models.build_pose_landmark_stub(), np.uint8),
    }


# --- the JAX side (test_fixture_is_current and regeneration only) ----------


def jax_tracker_run(name):
    """zaru_tpu's BodyTracker over run ``name``'s plan: pre-step states and
    outputs per step, as numpy."""
    from zaru_tpu.pipeline import BodyTracker

    tracker = BodyTracker(max_bodies=S)
    rgba, entry = photo(), ENTRY[name]
    states, outs = [], []
    state = None
    for start, force, zeroed in RUNS[name]:
        if start == "init":
            state = tracker.init_state(batch=None if entry == "run_frame" else BATCH)
        elif start == "seed":
            seed = seed_state()
            state = {k: jnp.asarray(v[0] if entry == "run_frame" else v) for k, v in seed.items()}
        states.append({k: np.asarray(v) for k, v in state.items()})
        frames = jnp.asarray(frames_for(rgba, zeroed))
        if entry == "run_frame":
            state, out = tracker.run_frame(state, frames[0])
        elif entry == "run_frames":
            state, out = tracker.run_frames(state, frames)
        else:
            state, out = tracker._step_batch_gated(tracker.params, state, frames, force)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    arrays = {"kwargs": np.asarray(json.dumps({"max_bodies": S})), "entry": np.asarray(entry),
              "start": np.asarray([s for s, _, _ in RUNS[name]]),
              "force": np.asarray([f for _, f, _ in RUNS[name]]),
              "zero": np.asarray([[b in z for b in range(BATCH)] for _, _, z in RUNS[name]])}
    for k in states[0]:
        arrays[f"state_{k}"] = np.stack([s[k] for s in states])
    for k in outs[0]:
        arrays[f"out_{k}"] = np.stack([o[k] for o in outs])
    return {f"{name}__{k}": v for k, v in arrays.items()}, tracker.params


def jax_pieces():
    """JAX's networks and decoders on the photo, its detection candidates
    and ``_candidate_rois`` on random keypoints, as fixture arrays."""
    from zaru_tpu.pipeline import BodyTracker
    from zaru_tpu.pipeline import _ops

    tracker = BodyTracker(max_bodies=S)
    frame = jnp.asarray(photo())
    det, lm = tracker.det_cnn, tracker.lm_cnn
    res = det.input_resolution()
    fit, fit_rrect = _ops.full_frame_fit(frame, res)
    det_out = jax.jit(det.apply_on_view)(tracker.params["det"], frame, fit_rrect)
    boxes, conf, kps, angles = tracker.detector.decode_device(det_out, tracker.detection_threshold)
    view = jnp.asarray([160.0, 90.0, 150.0, 150.0, 0.4], jnp.float32)
    lm_out = jax.jit(lm.apply_on_view)(tracker.params["lm"], frame, view)
    coords, flag, vis, pres = tracker.landmarker.decode_device(lm_out)
    cand = jax.jit(tracker._detect_batch)(tracker.params, jnp.asarray(frames_for(photo(), ())))
    box, akps, ang = norm_inputs()
    norm = jax.jit(jax.vmap(lambda b, k, a: tracker._candidate_rois(b, k, a, fit, res)))(box, akps, ang)
    return {
        "det_out0": np.asarray(det_out[0]), "det_out1": np.asarray(det_out[1]),
        "det_boxes": np.asarray(boxes), "det_conf": np.asarray(conf), "det_kps": np.asarray(kps),
        "det_angles": np.asarray(angles),
        "lm_view": np.asarray(view), "lm_n_outputs": np.asarray(len(lm_out)),
        "lm_out0": np.asarray(lm_out[0]), "lm_out1": np.asarray(lm_out[1]),
        "lm_coords": np.asarray(coords), "lm_flag": np.asarray(flag), "lm_vis": np.asarray(vis),
        "lm_pres": np.asarray(pres),
        "cand_rois": np.asarray(cand[0]), "cand_valid": np.asarray(cand[1]),
        "norm_rois": np.asarray(norm),
    }


def jax_views():
    """JAX's rotated sampler on BODY_VIEWS (256², 256-pixel grid, square
    views, colour range [0, 1]), stored as the u8 channels it maps."""
    from zaru_tpu.ops.rotated_fast import rotated_sample_fast

    rects = np.asarray(BODY_VIEWS, np.float32).reshape(4, 2, 5)
    views = rotated_sample_fast(jnp.asarray(coord_frames(4)), jnp.asarray(rects), 256, 256, 0.0, 1.0,
                                prescale_m=256, band_p=256, col_split=1, square_views=True)
    views = np.asarray(views)
    views_u8 = np.rint(views.astype(np.float64) * 255.0).astype(np.uint8)
    return {"views_rects": rects, "views_u8": views_u8,
            "views_exact": np.asarray(np.array_equal(views, unmap_u8(views_u8)))}


def jax_now():
    """Every JAX result the fixture stores but the stub blobs, and the
    tracker's params."""
    now, jparams = {}, None
    for name in RUNS:
        arrays, jparams = jax_tracker_run(name)
        now.update(arrays)
    now.update(jax_pieces())
    now.update(jax_views())
    return now, jparams


def regen():
    import tempfile

    blobs = stub_blobs()
    with tempfile.TemporaryDirectory() as d:
        write_blobs(d, blobs)
        os.environ["ZARU_TPU_MODELS"] = d
        arrays = dict(blobs)
        arrays.update(jax_now()[0])
    assert arrays["views_exact"], "the colour map at [0, 1] does not round-trip through u8"
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}")


# --- the tests -----------------------------------------------------------------


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def stub_env(tmp_path_factory, stored):
    """The stored stub blobs in a temporary directory that
    ``ZARU_TPU_MODELS`` names, for the module."""
    d = tmp_path_factory.mktemp("stub_onnx")
    write_blobs(str(d), stored)
    old = os.environ.get("ZARU_TPU_MODELS")
    os.environ["ZARU_TPU_MODELS"] = str(d)
    try:
        yield d
    finally:
        if old is None:
            os.environ.pop("ZARU_TPU_MODELS", None)
        else:
            os.environ["ZARU_TPU_MODELS"] = old


@pytest.fixture(scope="module")
def port(stub_env):
    from zaru_tpu_torch.pipeline import BodyTracker

    return BodyTracker(max_bodies=S, device="cpu")


def unflat(stored, name):
    run = {k.split("__", 1)[1]: v for k, v in stored.items() if k.startswith(f"{name}__")}
    steps = range(len(RUNS[name]))
    states = [{k[6:]: v[t] for k, v in run.items() if k.startswith("state_")} for t in steps]
    outs = [{k[4:]: v[t] for k, v in run.items() if k.startswith("out_")} for t in steps]
    return states, outs


def port_step(port, name, state, frames, force):
    frames = torch.from_numpy(frames)
    if ENTRY[name] == "run_frame":
        return port.run_frame(state, frames[0])
    if ENTRY[name] == "run_frames":
        return port.run_frames(state, frames)
    return port.step_batch(state, frames, force)


def assert_step_close(got, want, seeded):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in VALUE_KEYS:
        tol = (SEED_TOL_PX if seeded else STEP_TOL_PX) if "landmarks" in k or k == "rois" else SCORE_TOL
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_fixture_is_current(stored, port, stub_env):
    """The stored blobs are what tests/stub_models.py writes, and the stored
    JAX runs are what zaru_tpu computes now (1e-3, the regen machine's own
    rounding; the sampler views bit for bit); the port's tracker holds JAX's
    weights bit for bit."""
    from zaru_tpu_torch.weights import params_from_jax

    for key, blob in stub_blobs().items():
        np.testing.assert_array_equal(stored[key], blob, err_msg=key)
    now, jparams = jax_now()
    assert set(now) == set(stored) - set(BLOBS)
    for k, v in now.items():
        if v.dtype.kind in "fc":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    want = params_from_jax(jparams)
    for net, cnn in (("det", port.det_cnn), ("lm", port.lm_cnn)):
        got = cnn.net.params()
        assert set(got) == set(want[net]), net
        for k, v in want[net].items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=f"{net}/{k}")


def test_detector_decode_matches_jax(stored, port):
    """The detector on the photo's letterbox gives JAX's raw outputs, and the
    port's decode of JAX's outputs gives JAX's boxes, scores, keypoints and
    angles; the stub fires at anchor POSE_DET_ANCHOR only."""
    from zaru_tpu_torch.pipeline import _ops

    frame = torch.from_numpy(photo())[None]
    res = port.det_cnn.input_resolution()
    _fit, fit_rrect = _ops.full_frame_fit(frame, res)
    outs = port.det_cnn.apply_views_letterbox(frame, fit_rrect[None])
    np.testing.assert_allclose(outs[0].numpy(), stored["det_out0"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(outs[1].numpy(), stored["det_out1"], rtol=0, atol=1e-6)
    raw = [torch.from_numpy(stored["det_out0"]), torch.from_numpy(stored["det_out1"])]
    boxes, conf, kps, angles = (t[0].numpy() for t in port.detector.decode_device(raw, port.detection_threshold))
    np.testing.assert_array_equal(boxes, stored["det_boxes"])
    np.testing.assert_array_equal(kps, stored["det_kps"])
    np.testing.assert_allclose(conf, stored["det_conf"], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(angles, stored["det_angles"], rtol=0, atol=SCORE_TOL)
    assert np.flatnonzero(conf).tolist() == [stub_models.POSE_DET_ANCHOR]


def test_landmarker_decode_matches_jax(stored, port):
    """The landmarker loads with outputs 0 and 1 selected (the stub's third
    head is not run), gives JAX's raw outputs on a rotated view of the
    photo, and decodes them to JAX's coordinates, flag, visibility and
    presence."""
    assert int(stored["lm_n_outputs"]) == 2
    assert port.lm_cnn.net.output_names == ["ld_3d", "output_poseflag"]
    frame = torch.from_numpy(photo())[None]
    outs = port.lm_cnn.apply_on_view(frame, torch.from_numpy(stored["lm_view"])[None])
    assert len(outs) == 2
    np.testing.assert_allclose(outs[0].numpy(), stored["lm_out0"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(outs[1].numpy(), stored["lm_out1"], rtol=0, atol=1e-6)
    raw = [torch.from_numpy(stored["lm_out0"]), torch.from_numpy(stored["lm_out1"])]
    coords, flag, vis, pres = (t[0].numpy() for t in port.landmarker.decode_device(raw))
    np.testing.assert_array_equal(coords, stored["lm_coords"])
    np.testing.assert_array_equal(flag, stored["lm_flag"])
    np.testing.assert_allclose(vis, stored["lm_vis"], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(pres, stored["lm_pres"], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(coords[:, :2], stub_models.stub_pose_points(), rtol=0, atol=1e-4)


def test_candidate_rois_match_jax(stored, port):
    """Detection candidates on the photo (a square on the hips, flags
    equal), and ``_candidate_rois`` on random keypoints, where the port's
    norm may round differently from ``jnp.linalg.norm``: within
    NORM_TOL_PX."""
    from zaru_tpu_torch.pipeline import _ops

    rois, valid = port._detect_batch(torch.from_numpy(frames_for(photo(), ())))
    np.testing.assert_array_equal(valid.numpy(), stored["cand_valid"])
    np.testing.assert_allclose(rois.numpy(), stored["cand_rois"], rtol=0, atol=STEP_TOL_PX)
    res = port.det_cnn.input_resolution()
    fit, _ = _ops.full_frame_fit(torch.from_numpy(photo()), res)
    box, kps, ang = (torch.from_numpy(a) for a in norm_inputs())
    got = port._candidate_rois(box, kps, ang, fit, res).numpy()
    np.testing.assert_allclose(got, stored["norm_rois"], rtol=0, atol=NORM_TOL_PX)


@pytest.mark.parametrize("name", list(RUNS))
def test_one_step_matches_jax(stored, port, name):
    """From JAX's state before each step, one port step gives JAX's outputs
    and next frame counter."""
    states, outs = unflat(stored, name)
    rgba = photo()
    for t, (_start, force, zeroed) in enumerate(RUNS[name]):
        start = {k: torch.from_numpy(np.array(v)) for k, v in states[t].items()}
        state, out = port_step(port, name, start, frames_for(rgba, zeroed), force)
        got = {k: v.numpy() for k, v in out.items()}
        seeded = (np.asarray(outs[t]["valid"]) & ~np.asarray(states[t]["active"])).any()
        assert_step_close(got, outs[t], seeded)
        np.testing.assert_array_equal(state["frame"].numpy(), states[t]["frame"] + 1)


@pytest.mark.parametrize("name", list(RUNS))
def test_free_running_flags_match_jax(stored, port, name):
    """The port on its own over the plan: flags equal at every step, and the
    stub's constant pose holds the tracked ROI fixed."""
    _states, outs = unflat(stored, name)
    rgba = photo()
    state = None
    for t, (start, force, zeroed) in enumerate(RUNS[name]):
        if start == "init":
            state = port.init_state(None if ENTRY[name] == "run_frame" else BATCH)
        elif start == "seed":
            seed = {k: torch.from_numpy(v) for k, v in seed_state().items()}
            state = {k: v[0] for k, v in seed.items()} if ENTRY[name] == "run_frame" else seed
        state, out = port_step(port, name, state, frames_for(rgba, zeroed), force)
        np.testing.assert_array_equal(out["valid"].numpy(), outs[t]["valid"], err_msg=f"{name} step {t}")
    assert out["pose_landmarks"].shape[-2:] == (33, 3)


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    regen()
