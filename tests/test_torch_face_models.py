"""The rest of the port's FaceTracker (zaru_tpu_torch) against zaru_tpu's, on
the CPU: its other face models, the exact sampler and its ungated and
single-stream entry points.

Every run is on the fixture photo (1280×720, one face), with the same
weights in both packages (the port's networks load the ONNX files JAX loads;
``test_fixture_is_current`` holds them equal):

- ``v2``: ``FaceTracker(landmarker=FaceMeshV2())`` (256² crops, 478
  landmarks, a tongue score the tracker drops), gated batch step over PLAN;
- ``full``: ``FaceTracker(detector=FullRangeNetwork())`` (192² letterbox,
  2304 anchors), gated over PLAN;
- ``exact``: ``FaceTracker(fast_sampler=False)``, gated over PLAN: the
  landmark crops through the exact sampler;
- ``ungated``: ``run_frames`` (JAX ``vmap(step)``) over UNGATED_PLAN: both
  streams detect, track, stream 1 is lost and redetected while stream 0
  keeps tracking;
- ``single``: ``run_frame`` over SINGLE_PLAN (detect, a black frame that
  loses the face, redetect), and ``scan_video`` over the same three frames,
  which gives ``run_frame``'s outputs exactly (in JAX within SCAN_TOL_PX:
  two compiled programs; checked);
- ``single_iris``: ``FaceTracker(iris=True).run_frame`` over SINGLE_PLAN:
  exact eye crops, the right eye mirrored.

PLAN is the face cascade's (test_torch_face_cascade.py) cut to four steps:
detect, forced redetect, stream 1's frame zeroed (loss), redetect.

The cascade amplifies tiny differences (see test_torch_face_cascade.py), so
each run is held one step at a time from JAX's state before the step: flags
equal, landmarks and ROIs within STEP_TOL_PX, confidence within
SCORE_TOL, eyes within EYE_TOL_PX; and free-running by its flags.

JAX's states and outputs are stored in
``zaru_tpu_torch/fixtures/face_models_track.npz`` (the photo comes from
``sad_linus_track.npz``). The port is held to the stored runs, here and in
``chip_smoke.py`` on the GPU, where JAX is absent;
``test_fixture_is_current`` runs every run through JAX again, in the test
process, and ties the stored runs, and the port's own weights, to
the reference. Regenerate the fixture with::

    JAX_PLATFORMS=cpu python tests/test_torch_face_models.py
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
FIXTURE = os.path.join(FIXTURES, "face_models_track.npz")
BATCH = 2
# Steps as (force_detect, stream whose frame is zeroed or -1); a
# single-stream step takes stream 0's frame.
PLAN = [(False, -1), (True, -1), (False, 1), (False, -1)]
UNGATED_PLAN = [(False, -1), (False, -1), (False, 1), (False, -1)]
SINGLE_PLAN = [(False, -1), (False, 0), (False, -1)]
RUNS = {  # name: (FaceTracker keyword arguments, entry point, plan)
    "v2": ({"landmarker": "FaceMeshV2"}, "gated", PLAN),
    "full": ({"detector": "FullRangeNetwork"}, "gated", PLAN),
    "exact": ({"fast_sampler": False}, "gated", PLAN),
    "ungated": ({}, "run_frames", UNGATED_PLAN),
    "single": ({}, "run_frame", SINGLE_PLAN),
    "single_iris": ({"iris": True}, "run_frame", SINGLE_PLAN),
}

# One-step tolerances over every run. Landmarks and ROIs (px): 2.6e-3 and
# 1.2e-3 measured for v2 (the larger network), at most 4.0e-4 for the
# others. Confidence: 5.3e-8 measured.
STEP_TOL_PX = 1e-2
SCORE_TOL = 1e-5
# Eyes (px): 0.117 measured on the CPU, where the port's eye rects differ
# from JAX's by an ulp of cos/sin and move an exact-crop pixel (the same
# bound as tests/test_torch_face_cascade.py EYE_TOL_PX).
EYE_TOL_PX = 1.0
# JAX's scan_video against its run_frame, landmarks and ROIs (px): 1.2e-4
# measured.
SCAN_TOL_PX = 1e-3


def photo():
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        return f["rgb"]


def rgba(rgb):
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)


def batch_frames(rgb, zero):
    frames = np.stack([rgba(rgb)] * BATCH)
    if zero >= 0:
        frames[zero] = 0
    return frames


def steps_of(name, rgb):
    """Run ``name``'s steps as ``(force_detect, frames)``: ``[BATCH,H,W,4]``
    frames, or one ``[H,W,4]`` frame for a single-stream run."""
    _, entry, plan = RUNS[name]
    one = entry == "run_frame"
    return [(f, batch_frames(rgb, z)[0] if one else batch_frames(rgb, z)) for f, z in plan]


def _np_state(state):
    return {
        "roi": np.asarray(state["roi"]),
        "tracking": np.asarray(state["tracking"]),
        "filter": {k: np.asarray(v) for k, v in state["filter"].items()},
    }


def jax_run(rgb, name):
    """zaru_tpu's FaceTracker of run ``name`` over its steps: pre-step
    states and outputs per step, as numpy, and the tracker's params; the
    ``single`` run also returns ``scan_video``'s outputs over the same
    frames."""
    import zaru_tpu.face.detection as jdet
    import zaru_tpu.face.landmark.mediapipe as jmesh
    from zaru_tpu.pipeline import FaceTracker

    kwargs, entry, _ = RUNS[name]
    kwargs = dict(kwargs)
    if "landmarker" in kwargs:
        kwargs["landmarker"] = getattr(jmesh, kwargs["landmarker"])()
    if "detector" in kwargs:
        kwargs["detector"] = getattr(jdet, kwargs["detector"])()
    tracker = FaceTracker(**kwargs)
    single = entry == "run_frame"
    state = tracker.init_state(batch=None if single else BATCH)
    states, outs = [], []
    for force, frames in steps_of(name, rgb):
        states.append(_np_state(state))
        frames = jnp.asarray(frames)
        if entry == "gated":
            state, out = tracker._step_batch_gated(tracker.params, state, frames, force)
        elif entry == "run_frames":
            state, out = tracker.run_frames(state, frames)
        else:
            state, out = tracker.run_frame(state, frames)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    scan = None
    if name == "single":
        frames = np.stack([f for _, f in steps_of(name, rgb)])
        _, scanned = tracker.scan_video(tracker.init_state(), jnp.asarray(frames))
        scan = {k: np.asarray(v) for k, v in scanned.items()}
    return states, outs, scan, tracker.params


def flat(name, states, outs):
    """One run as fixture arrays, keyed ``<run>__<key>``: its definition
    (for chip_smoke.py, which cannot import this file), pre-step states and
    outputs."""
    kwargs, entry, plan = RUNS[name]
    arrays = {
        "kwargs": np.asarray(json.dumps(kwargs)),
        "entry": np.asarray(entry),
        "force": np.asarray([f for f, _ in plan]),
        "zero": np.asarray([z for _, z in plan], np.int32),
    }
    for k in ("roi", "tracking"):
        arrays[f"state_{k}"] = np.stack([s[k] for s in states])
    for k in states[0]["filter"]:
        arrays[f"state_{k}"] = np.stack([s["filter"][k] for s in states])
    for k in outs[0]:
        arrays[f"out_{k}"] = np.stack([o[k] for o in outs])
    return {f"{name}__{k}": v for k, v in arrays.items()}


def unflat(stored, name):
    """The inverse of :func:`flat`: pre-step states and outputs per step."""
    run = {k.split("__", 1)[1]: v for k, v in stored.items() if k.startswith(f"{name}__")}
    steps = range(len(run["force"]))
    fkeys = [k[6:] for k in run if k.startswith("state_") and k[6:] not in ("roi", "tracking")]
    states = [{"roi": run["state_roi"][t], "tracking": run["state_tracking"][t],
               "filter": {k: run[f"state_{k}"][t] for k in fkeys}} for t in steps]
    outs = [{k[4:]: v[t] for k, v in run.items() if k.startswith("out_")} for t in steps]
    return states, outs


@pytest.fixture(scope="module")
def rgb():
    return photo()


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def port_tracker(name, **extra):
    """The port's FaceTracker of run ``name`` on the CPU (its own weights)."""
    import zaru_tpu_torch.face.detection as tdet
    import zaru_tpu_torch.face.landmark.mediapipe as tmesh
    from zaru_tpu_torch.pipeline import FaceTracker

    kwargs = dict(RUNS[name][0], **extra)
    if "landmarker" in kwargs:
        kwargs["landmarker"] = getattr(tmesh, kwargs["landmarker"])(device="cpu")
    if "detector" in kwargs:
        kwargs["detector"] = getattr(tdet, kwargs["detector"])(device="cpu")
    return FaceTracker(device="cpu", **kwargs)


@pytest.fixture(scope="module", params=list(RUNS))
def live(request, stored):
    """One stored JAX run and the port's tracker for it."""
    name = request.param
    return name, port_tracker(name), *unflat(stored, name)


def _torch_state(state):
    return {
        "roi": torch.from_numpy(np.array(state["roi"])),
        "tracking": torch.from_numpy(np.array(state["tracking"])),
        "filter": {k: torch.from_numpy(np.array(v)) for k, v in state["filter"].items()},
    }


def port_step(port, name, state, force, frames):
    """One step of run ``name``'s entry point."""
    frames = torch.from_numpy(frames)
    entry = RUNS[name][1]
    if entry == "gated":
        return port.step_batch(state, frames, force)
    if entry == "run_frames":
        return port.run_frames(state, frames)
    return port.run_frame(state, frames)


@pytest.fixture(scope="module")
def jax_runs(rgb):
    """name → the run of RUNS through JAX (:func:`jax_run`'s result),
    computed in the test process when first asked for."""
    return functools.cache(lambda name: jax_run(rgb, name))


def test_fixture_is_current(stored, live, jax_runs):
    """The stored JAX run is what zaru_tpu computes now (1e-3 px, the regen
    machine's own rounding); JAX's ``scan_video`` gives its ``run_frame``
    outputs (within SCAN_TOL_PX: two compiled programs); and the port's
    networks (FullRangeNetwork and FaceMeshV2 among them) hold JAX's
    weights bit for bit."""
    from zaru_tpu_torch.weights import params_from_jax

    name, port, _, _ = live
    states, outs, scan, jparams = jax_runs(name)
    for k, v in flat(name, states, outs).items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)
    if scan is not None:
        for k, v in scan.items():
            np.testing.assert_allclose(v, np.stack([o[k] for o in outs]), rtol=0, atol=SCAN_TOL_PX, err_msg=k)
    want = params_from_jax(jparams)
    nets = [("det", port.det_cnn), ("lm", port.lm_cnn)] + ([("eye", port.eye_cnn)] if port.iris else [])
    for net, cnn in nets:
        got = cnn.net.params()
        assert set(got) == set(want[net]), net
        for k, v in want[net].items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=f"{net}/{k}")


def test_one_step_matches_jax(rgb, live):
    """From JAX's state before each step, one port step gives JAX's
    outputs: flags equal, landmarks and ROI within STEP_TOL_PX, confidence
    within SCORE_TOL, eyes within EYE_TOL_PX."""
    name, port, states, outs = live
    for t, (force, frames) in enumerate(steps_of(name, rgb)):
        _, out = port_step(port, name, _torch_state(states[t]), force, frames)
        got = {k: v.numpy() for k, v in out.items()}
        want = outs[t]
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=f"{name} step {t}")
        for k, tol in (("landmarks", STEP_TOL_PX), ("roi", STEP_TOL_PX), ("confidence", SCORE_TOL),
                       ("eyes", EYE_TOL_PX)):
            if k in want:
                assert got[k].shape == want[k].shape, k
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=f"{name} step {t}: {k}")


def test_free_running_flags_match_jax(rgb, live):
    """The port on its own over the run's steps: flags equal at every step
    (loss, then redetection)."""
    name, port, _, outs = live
    state = port.init_state(None if RUNS[name][1] == "run_frame" else BATCH)
    for t, (force, frames) in enumerate(steps_of(name, rgb)):
        state, out = port_step(port, name, state, force, frames)
        np.testing.assert_array_equal(out["valid"].numpy(), outs[t]["valid"], err_msg=f"{name} step {t}")
        np.testing.assert_array_equal(state["tracking"].numpy(), outs[t]["valid"])
    valid = np.stack([o["valid"] for o in outs])
    lost = [[1, 0, 1]] if RUNS[name][1] == "run_frame" else [[1, 1], [1, 1], [1, 0], [1, 1]]
    np.testing.assert_array_equal(valid.reshape(len(outs), -1), np.asarray(lost).reshape(len(outs), -1))


def test_scan_video_is_run_frame(rgb):
    """``scan_video`` over T frames gives ``run_frame``'s outputs and final
    state, stacked on a leading T axis, bit for bit."""
    port = port_tracker("single")
    frames = torch.from_numpy(np.stack([f for _, f in steps_of("single", rgb)]))
    state, outs = port.init_state(), []
    for frame in frames:
        state, out = port.run_frame(state, frame)
        outs.append(out)
    final, scanned = port.scan_video(port.init_state(), frames)
    assert set(scanned) == set(outs[0])
    for k, v in scanned.items():
        assert v.shape == (len(SINGLE_PLAN),) + outs[0][k].shape
        assert torch.equal(v, torch.stack([o[k] for o in outs])), k
    assert torch.equal(final["roi"], state["roi"]) and torch.equal(final["tracking"], state["tracking"])
    for k in state["filter"]:
        assert torch.equal(final["filter"][k], state["filter"][k])



@pytest.mark.parametrize("deg", [55.0, 80.0])
def test_tilted_face_fast_sampler_equals_exact(rgb, deg):
    """The intent of tests/test_face_cascade.py:276-300: on a strongly
    tilted frame the fast sampler (rotated-ROI kernel's plain version) and
    the exact sampler keep tracking and give identical landmarks every
    frame (views of 220-300 px at 0.09-0.51 rad, whose rotated bbox fits
    the 512-pixel grid). The frame is the photo turned by ``deg`` and
    scaled by 0.9 through the port's exact sampler (colour range [0, 255],
    so the colour map is the identity)."""
    from zaru_tpu_torch.ops.sampling import view_to_tensor_core

    H, W = rgb.shape[:2]
    rect = torch.tensor([[W / 2, H / 2, W / 0.9, H / 0.9, np.radians(deg)]], dtype=torch.float32)
    turned = view_to_tensor_core(torch.from_numpy(rgba(rgb))[None], rect, W, H, 0.0, 255.0, "NHWC")
    frame = torch.cat([turned.to(torch.uint8), torch.full((1, H, W, 1), 255, dtype=torch.uint8)], -1)
    fast = port_tracker("single", smooth=None)
    exact = port_tracker("single", smooth=None, fast_sampler=False)
    sf, se = fast.init_state(1), exact.init_state(1)
    for i in range(4):
        sf, of = fast.step_batch(sf, frame)
        se, oe = exact.step_batch(se, frame)
        assert bool(of["valid"][0]) and bool(oe["valid"][0]), f"lost the face at frame {i}"
        assert torch.equal(of["landmarks"], oe["landmarks"]), f"frame {i}"
    assert float(sf["roi"][0, 4]) > 0.2  # the view did turn


def regen():
    """Writes the fixture: every run of RUNS through JAX."""
    rgb = photo()
    arrays = {}
    for name in RUNS:
        states, outs, _scan, _ = jax_run(rgb, name)
        arrays.update(flat(name, states, outs))
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    regen()
