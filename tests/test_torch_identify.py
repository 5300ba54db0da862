"""The port's face identification (zaru_tpu_torch ``face.recognition.Embedder``,
``face.identify.FaceIdentifier`` and ``StreamIdentifier``) against zaru_tpu
on the CPU.

Both packages compute with the same weights: the port loads the ONNX files
JAX loads (``test_fixture_is_current`` holds MobileFaceNet's parameters
equal to JAX's ``Embedder.params`` through ``weights.network_params_from_jax``).
The photos are the decoded ones the port's fixtures already hold: the
1280×720 photo of ``sad_linus_track.npz`` and the 535×535 cropped photo of
``host_eval.npz`` (``eval__cropped``).

- **Embedder** on the cropped photo (the exact sampler at batch 1), within
  the repo's CNN bar (tests/test_onnx_importer.py:63-66): ``atol =
  1e-3·max(1,|out|max)``, ``rtol = 2e-3``.
- **FaceIdentifier**: enroll the cropped photo, identify the full photo:
  the same name, the gallery row and the query's embedding within the CNN
  bar, the distance within DIST_TOL; a tight threshold rejects, an empty
  identifier and a blank image find nothing.
- **StreamIdentifier** at batch 2 over PLAN (stream 1's frame zeroed at
  step 2: a loss, then a redetection), with a two-row gallery (a seeded
  random unit vector, then the enrolled face), one step at a time from
  JAX's state: flags and identities equal, distances within DIST_TOL and
  ``inf`` where JAX's are, tracker outputs within the face cascade's
  STEP_TOL_PX, embeddings within the CNN bar and of norm 1 within 1e-5.
  The 112² crops: from JAX's own crop rects (stored with its run) the
  port's rotated sampler gives JAX's crops bit for bit; the port's own
  crop rects go through ``cos`` and ``sin`` of the ROI angle, which differ
  from XLA's by an ulp now and then, and are held to CROP_RECT_TOL_PX.
  Free-running, flags and identities equal at every step. A tight
  threshold rejects every stream and keeps the distances; an empty gallery
  gives -1 and ``inf``.
- **Head pose** (keys ``pose_*``): JAX's Face Mesh V1 landmarks on the
  cropped photo, their Procrustes quaternion and yaw, which
  tests/test_torch_pose3d.py and chip_smoke.py hold the port to.

JAX's results are stored in ``zaru_tpu_torch/fixtures/identify.npz`` (the
crops as their u8 channel values, which the colour map turns into JAX's
f32 crops bit for bit). Only ``test_fixture_is_current`` runs JAX, in
the test process. Regenerate the fixture with::

    JAX_PLATFORMS=cpu python tests/test_torch_identify.py
"""

import math
import os
import sys

import numpy as np
import pytest

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "zaru_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "identify.npz")
BATCH = 2
# The stream whose frame is zeroed at each step (-1: none).
PLAN = [-1, -1, 1, -1]
GALLERY_NAMES = ["random", "linus"]
GALLERY_SEED = 31
# The rejecting threshold of tests/test_stream_identify.py.
TIGHT_THRESHOLD = 0.05
# tests/test_torch_face_cascade.py STEP_TOL_PX: one tracker step from
# JAX's state.
STEP_TOL_PX = 1e-2
# Measured (CPU, one torch thread): unit-sphere distances within 1.8e-7 of
# JAX's, normalized embeddings within 8.0e-7 (the cropped photo's raw
# embedding within 4.2e-6 of a largest value of 3.94), landmarks and ROIs
# within 4.0e-4 px; the port's crop rects from JAX's ROIs equal JAX's on
# the CPU (an H100's cos and sin differ again). The bounds leave room for
# the card's convolutions (the CNN bar) and its trigonometry.
DIST_TOL = 1e-3
CROP_RECT_TOL_PX = 1e-3


def photos():
    """(the 1280×720 photo, the 535×535 cropped photo), RGBA u8."""
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        rgb = f["rgb"]
    with np.load(os.path.join(FIXTURES, "host_eval.npz")) as f:
        cropped = f["eval__cropped"]
    full = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
    return np.ascontiguousarray(full), np.ascontiguousarray(cropped)


def frames_at(full, zero):
    frames = np.stack([full] * BATCH)
    if zero >= 0:
        frames[zero] = 0
    return frames


def random_row():
    v = np.random.default_rng(GALLERY_SEED).normal(size=128).astype(np.float32)
    return v / np.linalg.norm(v)


def crop_codes(crops):
    """JAX's ``[...,112,112,3]`` f32 crops (colour range [-1, 1]) as the u8
    channel values they were mapped from."""
    codes = np.rint((crops.astype(np.float64) + 1.0) * 127.5)
    assert codes.min() >= 0 and codes.max() <= 255
    return codes.astype(np.uint8)


def crops_of(codes):
    """The port's colour map of stored channel values: JAX's f32 crops."""
    from zaru_tpu_torch.ops.rotated_fast import _color
    from zaru_tpu_torch.ops.sampling import color_map

    return color_map(torch.from_numpy(codes.astype(np.int32)), *_color(-1.0, 1.0)).numpy()


def yaw_degrees(q):
    """tests/test_pose3d.py:171-172: yaw from a (w, x, y, z) quaternion."""
    w, x, y, z = (float(v) for v in q)
    return math.degrees(math.atan2(2 * (w * y + x * z), 1 - 2 * (y * y + z * z)))


# --- the JAX side (test_fixture_is_current and regeneration only) -----------


def _np_state(state):
    return {"roi": np.asarray(state["roi"]), "tracking": np.asarray(state["tracking"]),
            **{f"f_{k}": np.asarray(v) for k, v in state["filter"].items()}}


def jax_identify():
    """JAX's Embedder, FaceIdentifier and head pose on the photos →
    arrays."""
    from zaru_tpu.face.identify import FaceIdentifier
    from zaru_tpu.face.landmark.mediapipe import FaceMeshV1, reference_positions
    from zaru_tpu.face.recognition import Embedder
    from zaru_tpu.image import Image
    from zaru_tpu.landmark import Estimator
    from zaru_tpu.procrustes import ProcrustesAnalyzer

    full, cropped = photos()
    embedder = Embedder()
    out = {"embed_cropped": np.asarray(embedder.embed(Image(cropped)))}
    ident = FaceIdentifier(embedder=embedder)
    assert ident.enroll("linus", Image(cropped))
    out["enrolled"] = np.asarray(ident.gallery)[0]
    out["query"] = np.asarray(ident._embed_face(Image(full)))
    match = ident.identify(Image(full))
    out["identify_name"] = np.asarray(match.name)
    out["identify_distance"] = np.asarray(match.distance, np.float32)
    res = Estimator(FaceMeshV1()).estimate(Image(cropped))
    ref = reference_positions().copy()
    ref[:, 1] *= -1.0
    q = ProcrustesAnalyzer(ref).analyze(res.landmarks_mut().positions()).rotation_quaternion()
    out.update(pose_landmarks=res.landmarks_mut().positions().copy(), pose_quat=np.asarray(q),
               pose_yaw=np.asarray(yaw_degrees(q), np.float32))
    return out


def jax_stream(enrolled):
    """JAX's StreamIdentifier over PLAN with the two-row gallery: pre-step
    states, outputs, and the crop rects and crops of each step (read from
    the sampler call inside ``_embed_batch``) → (arrays keyed ``stream_*``,
    its params as numpy)."""
    import jax
    import jax.numpy as jnp

    from zaru_tpu.face.identify import StreamIdentifier

    full, _ = photos()
    sid = StreamIdentifier()
    sid.set_gallery(GALLERY_NAMES, np.stack([random_row(), enrolled]))
    cnn = sid.embedder._cnn
    seen = {}
    sample = cnn._sample_views_fast

    def spy(images, rects, **opts):
        seen["rects"], seen["crops"] = rects, sample(images, rects, **opts)
        return seen["crops"]

    @jax.jit
    def crops(params, frames, rois):
        sid._embed_batch(params, frames, rois)
        return seen["rects"], seen["crops"]

    cnn._sample_views_fast = spy
    state = sid.init_state(BATCH)
    states, outs = [], []
    for zero in PLAN:
        frames = jnp.asarray(frames_at(full, zero))
        states.append(_np_state(state))
        state, out = sid.run_frames(state, frames)
        out = {k: np.asarray(v) for k, v in out.items()}
        rects, crop = crops(sid.params, frames, jnp.asarray(out["roi"]))
        out["crop_rects"], out["crop_codes"] = np.asarray(rects), crop_codes(np.asarray(crop))
        assert np.array_equal(crops_of(out["crop_codes"]), np.asarray(crop))  # the codes are exact
        outs.append(out)
    flat = {"gallery": np.asarray(sid._gallery), "zero": np.asarray(PLAN, np.int32)}
    for name, items in (("state", states), ("out", outs)):
        flat.update({f"{name}_{k}": np.stack([s[k] for s in items]) for k in items[0]})
    return {f"stream_{k}": v for k, v in flat.items()}, sid.params


def jax_now(enrolled):
    """Both JAX runs, the stream's on the stored enrolled row (which the
    first run recomputes) → (arrays, the StreamIdentifier's ``{"det",
    "lm", "emb"}`` params)."""
    arrays = jax_identify()
    stream, params = jax_stream(enrolled)
    return {**arrays, **stream}, params


def regen():
    arrays = jax_identify()
    stream, _ = jax_stream(arrays["enrolled"])
    codes = stream["stream_out_crop_codes"]
    np.savez_compressed(FIXTURE, **arrays, **stream)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes, crops {codes.shape})")


# --- the tests -----------------------------------------------------------------


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def images():
    from zaru_tpu_torch.image import Image

    full, cropped = photos()
    return Image(full, "cpu"), Image(cropped, "cpu")


@pytest.fixture(scope="module")
def identifier():
    from zaru_tpu_torch.face.identify import FaceIdentifier

    return FaceIdentifier(device="cpu")


@pytest.fixture(scope="module")
def sid():
    from zaru_tpu_torch.face.identify import StreamIdentifier

    return StreamIdentifier(device="cpu")


def cnn_close(got, want, err_msg=""):
    tol = 1e-3 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=2e-3, err_msg=err_msg)


def steps(stored):
    """The stored run as (zeroed stream, pre-step state as tensors, JAX's
    outputs) per step."""
    run = {k[len("stream_"):]: v for k, v in stored.items() if k.startswith("stream_")}
    for t, zero in enumerate(run["zero"]):
        st = {k[len("state_"):]: v[t] for k, v in run.items() if k.startswith("state_")}
        state = {"roi": torch.from_numpy(st["roi"]), "tracking": torch.from_numpy(st["tracking"]),
                 "filter": {k[2:]: torch.from_numpy(v) for k, v in st.items() if k.startswith("f_")}}
        yield int(zero), state, {k[len("out_"):]: v[t] for k, v in run.items() if k.startswith("out_")}


def test_fixture_is_current(stored, sid):
    """The stored JAX runs are what zaru_tpu computes now (floats within
    1e-3, the regen machine's own rounding; flags, identities and crops
    exactly), the stored crops are JAX's f32 crops bit for bit through the
    colour map, and the port's StreamIdentifier holds JAX's weights bit for
    bit, loaded from the ONNX files and given as ``params``."""
    from zaru_tpu_torch.face.identify import StreamIdentifier
    from zaru_tpu_torch.weights import params_from_jax

    now, params = jax_now(stored["enrolled"])
    assert set(now) == set(stored)
    for k, v in now.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    want = params_from_jax(params)
    loaded = StreamIdentifier(params=want, device="cpu")
    for port in (sid, loaded):
        for net, got in (("det", port.tracker.det_cnn.nn.params), ("lm", port.tracker.lm_cnn.nn.params),
                         ("emb", port.embedder.params)):
            assert set(got) == set(want[net]), net
            for k, v in want[net].items():
                np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=f"{net}/{k}")


def test_embed_matches_jax(stored, images):
    """``Embedder.embed`` on the cropped photo: [128] f32 within the CNN
    bar, and ``apply_on_view`` on the photo's own rect the same vector;
    ``embedding_distance`` is numpy's norm of the difference."""
    from zaru_tpu_torch.face.recognition import Embedder, embedding_distance

    embedder = Embedder("cpu")
    emb = embedder.embed(images[1])
    assert emb.shape == (128,) and emb.dtype == np.float32
    cnn_close(emb, stored["embed_cropped"])
    whole = torch.tensor([267.5, 267.5, 535.0, 535.0, 0.0])  # the square photo's own rect
    np.testing.assert_array_equal(embedder.apply_on_view(images[1].data, whole).numpy(), emb)
    assert embedding_distance(torch.from_numpy(emb), stored["embed_cropped"]) == float(
        np.linalg.norm(emb - stored["embed_cropped"]))


def test_face_identifier_matches_jax(stored, images, identifier):
    """Enroll the cropped photo, identify the full one: the same name, the
    gallery row and the query within the CNN bar, the distance within
    DIST_TOL; no gallery, a blank image and a tight threshold give None."""
    from zaru_tpu_torch.face.identify import FaceIdentifier
    from zaru_tpu_torch.image import Image

    full, cropped = images
    assert FaceIdentifier(device="cpu").identify(full) is None
    assert identifier.enroll("linus", cropped) and len(identifier) == 1 and identifier.names == ["linus"]
    assert identifier.gallery.shape == (1, 128) and identifier.gallery.device.type == "cpu"
    cnn_close(identifier.gallery[0].numpy(), stored["enrolled"])
    cnn_close(identifier._embed_face(full), stored["query"])
    match = identifier.identify(full)
    assert match.name == str(stored["identify_name"]) == "linus"
    assert abs(match.distance - float(stored["identify_distance"])) <= DIST_TOL, match
    assert identifier.identify(Image(np.zeros_like(full.to_numpy()), "cpu")) is None
    tight = FaceIdentifier(threshold=TIGHT_THRESHOLD, detector=identifier._detector,
                           embedder=identifier._embedder, device="cpu")
    assert tight.enroll("linus", cropped) and tight.identify(full) is None


def test_stream_one_step_matches_jax(stored, sid):
    """From JAX's state before each step, one port step on the two-row
    gallery: flags and identities equal, distances within DIST_TOL (``inf``
    where JAX's are), tracker outputs within STEP_TOL_PX, embeddings within
    the CNN bar and of norm 1."""
    full, _ = photos()
    gallery = torch.from_numpy(stored["stream_gallery"])
    lost = 0
    for t, (zero, state, want) in enumerate(steps(stored)):
        _, out = sid.step(state, torch.from_numpy(frames_at(full, zero)), gallery)
        got = {k: v.numpy() for k, v in out.items()}
        np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=str(t))
        np.testing.assert_array_equal(got["identity"], want["identity"], err_msg=str(t))
        assert got["identity"].dtype == np.int32
        np.testing.assert_array_equal(np.isinf(got["identity_distance"]), np.isinf(want["identity_distance"]))
        np.testing.assert_allclose(got["identity_distance"], want["identity_distance"], rtol=0, atol=DIST_TOL)
        for k in ("landmarks", "roi"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=STEP_TOL_PX, err_msg=f"{t} {k}")
        cnn_close(got["embedding"], want["embedding"], str(t))
        np.testing.assert_allclose(np.linalg.norm(got["embedding"], axis=-1), 1.0, atol=1e-5)
        lost += int((~want["valid"]).sum())
    # Step 2 loses stream 1 (-1, inf); the face is "linus" (row 1) elsewhere.
    assert lost == 1 and stored["stream_out_identity"].tolist() == [[1, 1], [1, 1], [1, -1], [1, 1]]


def test_crops_from_jax_rects_are_jax_crops(stored, sid):
    """The 112² crops the port's rotated sampler takes from JAX's crop rects
    are JAX's crops bit for bit, planar (what MobileFaceNet reads) and
    NHWC."""
    full, _ = photos()
    cnn = sid.embedder.cnn()
    for t, (zero, _state, want) in enumerate(steps(stored)):
        frames = torch.from_numpy(frames_at(full, zero))
        rects = torch.from_numpy(want["crop_rects"])
        jax_crops = crops_of(want["crop_codes"])
        planar = cnn.sample_views_fast(frames, rects, layout="NCHW")
        assert planar.shape == (BATCH, 3, 112, 112)
        np.testing.assert_array_equal(planar.permute(0, 2, 3, 1).numpy(), jax_crops, err_msg=str(t))
        np.testing.assert_array_equal(cnn.sample_views_fast(frames, rects).numpy(), jax_crops, err_msg=str(t))


def test_crop_rects_match_jax(stored, sid):
    """The port's crop rects from JAX's tracked ROIs: axis-aligned, within
    CROP_RECT_TOL_PX of JAX's."""
    for t, (_zero, _state, want) in enumerate(steps(stored)):
        rects = sid._crop_rects(torch.from_numpy(want["roi"])).numpy()
        assert (rects[:, 4] == 0).all() and (rects[:, 2] == rects[:, 3]).all()
        np.testing.assert_allclose(rects, want["crop_rects"], rtol=0, atol=CROP_RECT_TOL_PX, err_msg=str(t))


def test_stream_free_running_matches_jax(stored, sid):
    """The port tracking and identifying on its own over PLAN (gallery from
    ``set_gallery``): flags and identities equal at every step."""
    full, _ = photos()
    sid.set_gallery(GALLERY_NAMES, torch.from_numpy(stored["stream_gallery"]))
    state = sid.init_state(BATCH)
    for t, (zero, _state, want) in enumerate(steps(stored)):
        state, out = sid.run_frames(state, torch.from_numpy(frames_at(full, zero)))
        np.testing.assert_array_equal(out["valid"].numpy(), want["valid"], err_msg=str(t))
        np.testing.assert_array_equal(out["identity"].numpy(), want["identity"], err_msg=str(t))
    assert [sid.names[i] for i in out["identity"].tolist()] == ["linus", "linus"]


def test_threshold_rejects_and_empty_gallery(stored, sid):
    """tests/test_stream_identify.py's rules, one step from JAX's state at
    step 1: a 0.05 threshold leaves every stream unidentified (-1) and
    reports the distance; an empty gallery gives -1 and ``inf``; the
    embeddings are the same either way."""
    from zaru_tpu_torch.face.identify import StreamIdentifier

    full, _ = photos()
    zero, state, want = list(steps(stored))[1]
    frames = torch.from_numpy(frames_at(full, zero))
    tight = StreamIdentifier(sid.tracker, sid.embedder, threshold=TIGHT_THRESHOLD, device="cpu")
    tight.set_gallery(GALLERY_NAMES, stored["stream_gallery"])
    _, out = tight.run_frames(state, frames)
    assert (out["identity"].numpy() == -1).all()
    np.testing.assert_allclose(out["identity_distance"].numpy(), want["identity_distance"], rtol=0, atol=DIST_TOL)
    empty = StreamIdentifier(sid.tracker, sid.embedder, device="cpu")
    assert empty._gallery.shape == (0, 128)
    _, out = empty.run_frames(state, frames)
    assert (out["identity"].numpy() == -1).all() and np.isinf(out["identity_distance"].numpy()).all()
    cnn_close(out["embedding"].numpy(), want["embedding"])


def test_gallery_rules(sid):
    """``set_gallery`` normalizes its rows and refuses a shape that does not
    match the names; ``adopt`` refuses an identifier with no faces."""
    from zaru_tpu_torch.face.identify import FaceIdentifier, StreamIdentifier

    other = StreamIdentifier(sid.tracker, sid.embedder, device="cpu")
    other.set_gallery(["a", "b"], np.asarray([[3.0, 4.0] + [0.0] * 126, [0.0] * 127 + [2.0]], np.float32))
    np.testing.assert_allclose(other._gallery[:, [0, 1, 127]].numpy(), [[0.6, 0.8, 0.0], [0.0, 0.0, 1.0]])
    with pytest.raises(ValueError, match="needs"):
        other.set_gallery(["a"], np.zeros((2, 128), np.float32))
    with pytest.raises(ValueError, match="no enrolled faces"):
        other.adopt(FaceIdentifier(detector=object(), embedder=sid.embedder, device="cpu"))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen()
