"""The port's multi-object trackers (zaru_tpu_torch.pipeline
``MultiFaceTracker``, ``MultiHandTracker``) against zaru_tpu's, on the CPU.

Every run is batch 2 on the fixture photo (1280×720, one face, no hand),
with the same weights in both packages (the port's trackers load the ONNX
files JAX loads; ``test_fixture_is_current`` holds them equal), through the
gated batch step (JAX ``_step_batch_gated``, the port's ``step_batch``) or,
for the runs ENTRY names, ``run_frame`` or ``run_frames``.
A plan step is ``(start, force_detect, zeroed streams)``: it starts from
the previous step's state (``carry``), from ``init_state`` (``init``) or
from the seeded state ``seed_state`` (``seed``: slots active at fixed rects
of several sizes and angles, frame 1, so no detection is due).

- ``face``: ``MultiFaceTracker(max_faces=3)`` over the face cascade's plan
  (detect, forced redetect, stream 1 zeroed and lost, redetect, track);
- ``face_bucket``: the same with ``redetect_bucket=1``: both streams
  zeroed and lost, then drained one per step, then a forced redetect;
- ``hand``: ``MultiHandTracker(max_hands=3)``: a seeded tracking step, a
  detect step on the photo and one on zeroed frames. No palm scores 0.5
  on the photo (0.382 at most), and hand presence on its crops is 0.001-
  0.012, so every slot drops and the outputs are zeros: this run holds the
  flags;
- ``hand_open``: ``MultiHandTracker(max_hands=3, detection_threshold=0.2,
  presence_threshold=0.0)``, which keeps every slot: it detects palms on
  the photo (scores 0.215-0.382 pass; the next is 0.181, so no score lies
  near 0.2), assigns and tracks them, redetects (forced, deduplicated),
  tracks a zeroed stream and takes the seeded step, whose two overlapping
  slots make the newer one culled. This run holds the values;
- ``hand_exact``: ``hand_open`` with ``fast_sampler=False``: the gated
  step's slot crops (224², any angle, the seeded views of up to 620 px)
  through the exact sampler;
- ``face_single``: ``MultiFaceTracker(max_faces=3).run_frame`` (JAX's
  single-stream ``step``, every crop exact) over one stream: detect, track,
  a zeroed frame (lost), redetect;
- ``face_ungated``: ``run_frames`` (JAX's ``vmap(step)``) over the face
  plan without the forced step: stream 1 is lost and redetected on its own
  while stream 0 keeps tracking (no interval is due);
- ``face_v2``: ``MultiFaceTracker(landmarker=FaceMeshV2())`` over the face
  plan: 256² crops, 478 landmarks, its tongue score as ``extra0``;
- ``face_full``: ``MultiFaceTracker(detector=FullRangeNetwork())`` over the
  face plan: 192² letterbox detection, 2304 anchors.

A run's keyword arguments name its networks by class (``landmarker``,
``detector``); :func:`make_tracker` builds them in either package.

Empty slots carry the zero ROI: their view is empty and their outputs are
masked to zero. No NaN reaches an output in either package (checked).

The cascade amplifies tiny differences (see test_torch_face_cascade.py), so
each run is held one step at a time from JAX's state (flags equal,
landmarks, ROIs, confidence/presence and handedness within the tolerances
below), and free-running by its flags. A step that seeds a slot from a
fresh detection is held more loosely than one that tracks carried slots:
the detector's candidate ROIs differ from JAX's by ≤ 1.2e-4 px and
4.3e-6 rad (held to CAND_TOL_PX and CAND_TOL_RAD on the photo), which
moves 6 (face) and 26 (hand) crop pixels that lie on a rounding boundary
to their neighbours, and the landmarks of that step by up to 0.033 px
(0.051 px on an H100).

JAX's states and outputs are stored in
``zaru_tpu_torch/fixtures/multi_track.npz`` (the photo comes from
``sad_linus_track.npz``). The port is held to the stored runs, here and in
``chip_smoke.py`` on the GPU, where JAX is absent; ``test_fixture_is_current``
runs each plan through JAX again (one compile of its tracker) and ties the
stored run to the reference. Each JAX run and the ``angle_clamp`` pass
runs in the test process when a test first asks for it (``jax_runs``).
Regenerate it with::

    JAX_PLATFORMS=cpu python tests/test_torch_multi_object.py
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zaru_tpu_torch", "fixtures"
)
FIXTURE = os.path.join(FIXTURES, "multi_track.npz")
BATCH = 2
S = 3
# Seeded slots (cx, cy, w, h, theta) of the two streams: views of 240-620 px
# (strides 1 to 3 on the hand sampler's 256-pixel grid) at angles near 0,
# ±π/2 and ±π; stream 0's third slot overlaps its first, and stream 1's
# third slot is empty.
SEED_ROIS = [
    [(640, 360, 240, 240, 0.0), (420, 300, 420, 380, 3.1), (660, 360, 240, 240, -1.57)],
    [(700, 400, 600, 600, 1.6), (300, 500, 520, 560, -3.05), (0, 0, 0, 0, 0)],
]
SEED_ACTIVE = [[True, True, True], [True, True, False]]
FACE_PLAN = [("init", False, ()), ("carry", True, ()), ("carry", False, (1,)),
             ("carry", False, ()), ("carry", False, ())]
FACE_BUCKET_PLAN = [("init", False, ()), ("carry", False, (0, 1)), ("carry", False, ()),
                    ("carry", False, ()), ("carry", True, ())]
HAND_PLAN = [("seed", False, ()), ("init", False, ()), ("init", False, (0, 1))]
HAND_OPEN_PLAN = [("init", False, ()), ("carry", False, ()), ("carry", True, ()),
                  ("carry", False, (1,)), ("seed", False, ())]
# Single-stream steps use stream 0's frame.
FACE_SINGLE_PLAN = [("init", False, ()), ("carry", False, ()), ("carry", False, (0,)),
                    ("carry", False, ())]
FACE_UNGATED_PLAN = [("init", False, ()), ("carry", False, ()), ("carry", False, (1,)),
                     ("carry", False, ())]
# The entry point of a run that does not take the gated batch step.
ENTRY = {"face_single": "run_frame", "face_ungated": "run_frames"}
RUNS = {  # name: (tracker class, keyword arguments, plan)
    "face": ("MultiFaceTracker", {"max_faces": S}, FACE_PLAN),
    "face_bucket": ("MultiFaceTracker", {"max_faces": S, "redetect_bucket": 1}, FACE_BUCKET_PLAN),
    "hand": ("MultiHandTracker", {"max_hands": S}, HAND_PLAN),
    "hand_open": ("MultiHandTracker",
                  {"max_hands": S, "detection_threshold": 0.2, "presence_threshold": 0.0},
                  HAND_OPEN_PLAN),
    "hand_exact": ("MultiHandTracker",
                   {"max_hands": S, "detection_threshold": 0.2, "presence_threshold": 0.0,
                    "fast_sampler": False},
                   HAND_OPEN_PLAN),
    "face_single": ("MultiFaceTracker", {"max_faces": S}, FACE_SINGLE_PLAN),
    "face_ungated": ("MultiFaceTracker", {"max_faces": S}, FACE_UNGATED_PLAN),
    "face_v2": ("MultiFaceTracker", {"max_faces": S, "landmarker": "FaceMeshV2"}, FACE_PLAN),
    "face_full": ("MultiFaceTracker", {"max_faces": S, "detector": "FullRangeNetwork"}, FACE_PLAN),
}

# One-step tolerances (landmarks and ROIs in px; confidence, presence and
# handedness), measured over every run: a step that tracks carried slots,
# 7.2e-4 px and 1.9e-6 on the CPU (an H100 holds it too, chip_smoke.py); a
# step that seeds a slot from a new detection, 0.0334 px and 1.34e-5
# (handedness) on the CPU with the fast sampler, up to 0.0507 px and
# 7.65e-5 on an H100, where other crop pixels move; with the exact sampler
# (hand_exact, full-resolution crops, so more pixels on a rounding
# boundary) 0.142 px and 3.49e-4 on the CPU, 0.176 px and 2.96e-4 on an
# H100.
STEP_TOL_PX, STEP_SCORE_TOL = 1e-2, 1e-5
SEED_TOL_PX, SEED_SCORE_TOL = 0.25, 1e-3
# Detection candidates on the photo: 1.2e-4 px and 4.3e-6 rad (CPU),
# 3.4e-4 px and 4.0e-6 rad (H100) measured.
CAND_TOL_PX, CAND_TOL_RAD = 1e-3, 1e-5
VALUE_KEYS = {"landmarks", "rois", "confidence", "presence", "handedness", "extra0"}


def seed_state():
    return {
        "rois": np.asarray(SEED_ROIS, np.float32),
        "active": np.asarray(SEED_ACTIVE),
        "frame": np.ones(BATCH, np.int32),
    }


def photo():
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        return f["rgb"]


def frames_for(rgb, zeroed):
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    frames = np.stack([rgba] * BATCH)
    frames[list(zeroed)] = 0
    return frames


def make_tracker(pkg, cls, kwargs, **extra):
    """Tracker ``cls`` of package ``pkg`` (``zaru_tpu`` or ``zaru_tpu_torch``)
    with ``kwargs``, its networks named by class built with ``extra`` (the
    port's ``device``) as well."""
    import importlib

    kwargs = dict(kwargs)
    for key, module in (("landmarker", "face.landmark.mediapipe"), ("detector", "face.detection")):
        if key in kwargs:
            kwargs[key] = getattr(importlib.import_module(f"{pkg}.{module}"), kwargs[key])(**extra)
    return getattr(importlib.import_module(f"{pkg}.pipeline"), cls)(**kwargs, **extra)


def jax_run(rgb, name):
    """zaru_tpu's tracker of run ``name`` over its plan: pre-step states and
    outputs per step, as numpy, with the detection candidates on the photo
    as the last "step" of ``outs`` (``cand_rois``, ``cand_valid``)."""
    cls, kwargs, plan = RUNS[name]
    tracker = make_tracker("zaru_tpu", cls, kwargs)
    entry = ENTRY.get(name, "gated")
    states, outs = [], []
    state = None
    for start, force, zeroed in plan:
        if start == "init":
            state = tracker.init_state(batch=None if entry == "run_frame" else BATCH)
        elif start == "seed":
            state = {k: jnp.asarray(v) for k, v in seed_state().items()}
        states.append({k: np.asarray(v) for k, v in state.items()})
        frames = jnp.asarray(frames_for(rgb, zeroed))
        if entry == "run_frame":
            state, out = tracker.run_frame(state, frames[0])
        elif entry == "run_frames":
            state, out = tracker.run_frames(state, frames)
        else:
            state, out = tracker._step_batch_gated(tracker.params, state, frames, force)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    cand = jax.jit(tracker._detect_batch)(tracker.params, jnp.asarray(frames_for(rgb, ())))
    outs.append({"cand_rois": np.asarray(cand[0]), "cand_valid": np.asarray(cand[1])})
    return tracker, states, outs


def flat(name, states, outs):
    """One run as fixture arrays, keyed ``<run>__<key>``."""
    cls, kwargs, plan = RUNS[name]
    arrays = {
        "tracker": np.asarray(cls),
        "kwargs": np.asarray(json.dumps(kwargs)),
        **({"entry": np.asarray(ENTRY[name])} if name in ENTRY else {}),
        "start": np.asarray([s for s, _, _ in plan]),
        "force": np.asarray([f for _, f, _ in plan]),
        "zero": np.asarray([[b in z for b in range(BATCH)] for _, _, z in plan]),
    }
    for k in states[0]:
        arrays[f"state_{k}"] = np.stack([s[k] for s in states])
    for k in outs[0]:
        arrays[f"out_{k}"] = np.stack([o[k] for o in outs[:-1]])
    arrays.update(outs[-1])
    return {f"{name}__{k}": v for k, v in arrays.items()}


def regen(names=tuple(RUNS)):
    """Writes the runs ``names`` into the fixture, keeping the others'
    stored arrays."""
    rgb = photo()
    arrays = {}
    if os.path.exists(FIXTURE):
        with np.load(FIXTURE) as f:
            arrays = {k: f[k] for k in f.files if k.split("__")[0] not in names}
    for name in names:
        _, states, outs = jax_run(rgb, name)
        arrays.update(flat(name, states, outs))
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}")


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def port_step(port, name, state, frames, force):
    """One step of run ``name``'s entry point on ``frames [BATCH,...]``
    (a single-stream run takes stream 0's frame)."""
    frames = torch.from_numpy(frames)
    entry = ENTRY.get(name, "gated")
    if entry == "run_frame":
        return port.run_frame(state, frames[0])
    if entry == "run_frames":
        return port.run_frames(state, frames)
    return port.step_batch(state, frames, force)


def step_tols(state_active, out_valid):
    """(px, score) tolerances of a step: the looser pair when a slot that
    was not active before the step is valid after it."""
    seeded = (np.asarray(out_valid) & ~np.asarray(state_active)).any()
    return (SEED_TOL_PX, SEED_SCORE_TOL) if seeded else (STEP_TOL_PX, STEP_SCORE_TOL)


def assert_step_close(got, want, tols):
    """Flags equal; positions and scores within ``tols``; NaN where JAX has
    NaN."""
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in VALUE_KEYS & set(want):
        tol = tols[0] if k in ("landmarks", "rois") else tols[1]
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, equal_nan=True, err_msg=k)


@pytest.fixture(scope="module")
def rgb():
    return photo()


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def unflat(stored, name):
    """The inverse of :func:`flat`: run ``name`` from the fixture as pre-step
    states and outputs per step, the detection candidates last."""
    run = {k.split("__", 1)[1]: v for k, v in stored.items() if k.startswith(f"{name}__")}
    steps = range(len(RUNS[name][2]))
    states = [{k[6:]: v[t] for k, v in run.items() if k.startswith("state_")} for t in steps]
    outs = [{k[4:]: v[t] for k, v in run.items() if k.startswith("out_")} for t in steps]
    outs.append({k: run[k] for k in ("cand_rois", "cand_valid")})
    return states, outs


def jax_clamp_run(rgb, clamp=0.6):
    """JAX's ``_track_slots_batch`` of a ``MultiHandTracker`` with
    ``angle_clamp`` on the seeded slots → (its outputs, the tracker's
    params). ``detect_interval`` is read only by the detection gates, which
    this pass does not run."""
    from zaru_tpu.pipeline import MultiHandTracker as JTracker

    jt = JTracker(max_hands=S, detect_interval=5)
    jt.angle_clamp = clamp
    frames, rois = frames_for(rgb, ()), seed_state()["rois"]
    want = jax.jit(jt._track_slots_batch)(jt.params, jnp.asarray(frames), jnp.asarray(rois))
    return jax.tree_util.tree_map(np.asarray, want), jt.params


@pytest.fixture(scope="module")
def jax_runs(rgb):
    """name → the run of RUNS through JAX, as (states, outputs, the
    tracker's params), or for ``"angle_clamp"`` :func:`jax_clamp_run`'s
    result; each computed in the test process when first asked for."""

    @functools.cache
    def run(name):
        if name == "angle_clamp":
            return jax_clamp_run(rgb)
        tracker, states, outs = jax_run(rgb, name)
        return states, outs, tracker.params

    return run


@pytest.fixture(scope="module", params=list(RUNS))
def live(request, stored):
    """One stored JAX run and the port's tracker for it (its own weights)."""
    name = request.param
    cls, kwargs, _ = RUNS[name]
    port = make_tracker("zaru_tpu_torch", cls, kwargs, device="cpu")
    return name, port, *unflat(stored, name)


def test_fixture_is_current(stored, live, jax_runs):
    """The stored JAX run is what zaru_tpu computes now (1e-3 px, the regen
    machine's own rounding), and the port's tracker holds JAX's weights bit
    for bit."""
    from zaru_tpu_torch.weights import params_from_jax

    name, port, _, _ = live
    states, outs, jparams = jax_runs(name)
    now = flat(name, states, outs)
    for k, v in now.items():
        if v.dtype.kind in "fc":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-3, equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    want = params_from_jax(jparams)
    for net, cnn in (("det", port.det_cnn), ("lm", port.lm_cnn)):
        got = cnn.net.params()
        assert set(got) == set(want[net]), net
        for k, v in want[net].items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=f"{net}/{k}")


def test_one_step_matches_jax(rgb, live):
    """From JAX's state before each step, one port step gives JAX's outputs
    and next state."""
    name, port, states, outs = live
    for t, (_start, force, zeroed) in enumerate(RUNS[name][2]):
        state, out = port_step(port, name, _torch_state(states[t]), frames_for(rgb, zeroed), force)
        got = {k: v.numpy() for k, v in out.items()}
        assert_step_close(got, outs[t], step_tols(states[t]["active"], outs[t]["valid"]))
        np.testing.assert_array_equal(state["frame"].numpy(), states[t]["frame"] + 1)
        for v in got.values():
            assert not np.isnan(v.astype(np.float32)).any()


def test_detect_candidates_match_jax(rgb, live):
    """Letterbox, detector, decode, NMS and candidate ROIs on the photo:
    valid flags equal, ROIs within CAND_TOL_PX and CAND_TOL_RAD."""
    _name, port, _, outs = live
    rois, valid = port._detect_batch(torch.from_numpy(frames_for(rgb, ())))
    np.testing.assert_array_equal(valid.numpy(), outs[-1]["cand_valid"])
    err = np.abs(rois.numpy() - outs[-1]["cand_rois"])
    assert err[..., :4].max() <= CAND_TOL_PX and err[..., 4].max() <= CAND_TOL_RAD, err.max((0, 1))


def test_free_running_flags_match_jax(rgb, live):
    """The port on its own over the plan: flags equal at every step."""
    name, port, states, outs = live
    state = None
    for t, (start, force, zeroed) in enumerate(RUNS[name][2]):
        if start == "init":
            state = port.init_state(None if ENTRY.get(name) == "run_frame" else BATCH)
        elif start == "seed":
            state = _torch_state(seed_state())
        state, out = port_step(port, name, state, frames_for(rgb, zeroed), force)
        np.testing.assert_array_equal(out["valid"].numpy(), outs[t]["valid"], err_msg=f"{name} step {t}")


def test_plans_do_what_they_say(stored):
    """The stored JAX runs take the paths the plans are for."""
    v = lambda run: stored[f"{run}__out_valid"].any(-1)  # noqa: E731  stream tracking [T,B]
    np.testing.assert_array_equal(v("face"), [[1, 1], [1, 1], [1, 0], [1, 1], [1, 1]])
    np.testing.assert_array_equal(v("face_bucket"), [[1, 1], [0, 0], [1, 0], [1, 1], [1, 1]])
    assert not stored["hand__out_valid"].any()
    hv = stored["hand_open__out_valid"]
    assert hv[0].any(-1).all() and hv[2].sum() == hv[1].sum()  # palms found; redetect deduplicated
    np.testing.assert_array_equal(hv[4], [[1, 1, 0], [1, 1, 0]])  # seeded: slot 0/2 overlap culled
    assert stored["hand_open__out_presence"][4].max() < 0.5  # no hand in the photo


@pytest.fixture(scope="module")
def jax_hands():
    """One JAX MultiHandTracker for the test below. ``detect_interval`` is
    read only by the detection gates, which the test does not run."""
    from zaru_tpu.pipeline import MultiHandTracker as JTracker

    return JTracker(max_hands=S, detect_interval=5)


def test_angle_clamp_matches_jax(rgb, jax_runs):
    """``angle_clamp`` (set by neither tracker) clamps the sampled view's
    angle and leaves the ROI's: the per-slot pass on the seeded slots against
    JAX's ``_track_slots_batch`` with the same clamp."""
    from zaru_tpu_torch.pipeline import MultiHandTracker as TTracker
    from zaru_tpu_torch.weights import params_from_jax

    want, jparams = jax_runs("angle_clamp")
    pt = TTracker(max_hands=S, params=params_from_jax(jparams), device="cpu")
    pt.angle_clamp = 0.6
    frames, rois = frames_for(rgb, ()), seed_state()["rois"]
    got = pt._track_slots_batch(torch.from_numpy(frames), torch.from_numpy(rois))
    for g, w in ((got[0], want[0]), (got[3], want[3])):  # next ROIs, landmarks
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_TOL_PX)
    for g, w in ((got[1], want[1]), (got[2][0], want[2][0])):  # presence, handedness
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_SCORE_TOL)
    pt.angle_clamp = None
    assert not torch.equal(pt._track_slots_batch(torch.from_numpy(frames), torch.from_numpy(rois))[3], got[3])


def test_assign_matches_jax(jax_hands):
    """The three slot-assignment cases of tests/test_hand_cascade.py:27-57
    (free slots, dedup against an active slot, no free slot), batched as
    three streams, against JAX's ``_assign``."""
    from zaru_tpu_torch.pipeline import MultiHandTracker as TTracker

    roi = lambda cx, cy, size=100.0: [cx, cy, size, size, 0.0]  # noqa: E731
    rois = np.zeros((3, 3, 5), np.float32)
    active = np.zeros((3, 3), bool)
    rois[1, 0], active[1, 0] = roi(100, 100), True
    rois[2] = [roi(100, 100), roi(300, 300), roi(500, 500)]
    active[2] = True
    cands = np.asarray([
        [roi(100, 100), roi(300, 300), roi(500, 100)],
        [roi(105, 100), roi(400, 400), roi(0, 0, 1)],
        [roi(700, 700)] * 3,
    ], np.float32)
    valid = np.asarray([[1, 1, 0], [1, 1, 0], [1, 1, 1]], bool)
    jassign = jax.jit(jax_hands._assign)
    port = TTracker(max_hands=3, detect_interval=5, device="cpu")
    got = port._assign(*(torch.from_numpy(a) for a in (rois, active, cands, valid)))
    for b in range(3):
        want = jassign({"rois": jnp.asarray(rois[b]), "active": jnp.asarray(active[b])},
                       jnp.asarray(cands[b]), jnp.asarray(valid[b]))
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[1]))
    assert got[1].tolist() == [[True, True, False], [True, True, False], [True, True, True]]
    np.testing.assert_array_equal(got[0][1, 1, :2], [400, 400])
    np.testing.assert_array_equal(got[0][2, 2, :2], [500, 500])


if __name__ == "__main__":
    # python tests/test_torch_multi_object.py [run ...]: every run, or those
    # named.
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    regen(tuple(sys.argv[1:]) or tuple(RUNS))
