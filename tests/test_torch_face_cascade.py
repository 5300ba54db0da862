"""The port's FaceTracker (zaru_tpu_torch) against zaru_tpu's, on the CPU.

Both trackers run at batch 2 on the fixture photo over one step sequence:
detect, forced redetect, stream 1's frame zeroed (loss), redetect, track.
Both use the same weights (``params_from_jax``).

The cascade feeds each step's landmarks back into the next step's ROI and
samples its crops nearest-neighbour, so it amplifies tiny differences:
moving the JAX tracker's own ROI by 1e-3 px moves its landmarks by ~0.4 px
one step later and by up to ~3.6 px within six steps. So the port is held to
JAX in two ways:

- one step at a time, from JAX's state before each step: this measures the
  port's own error (CNN arithmetic and the tail's f32 math), ≤ 4e-4 px
  measured, held to 1e-2 px;
- free-running over the whole sequence: tracking flags equal at every step
  and landmarks within 8 px (4.3 px measured).

The same sequence, with JAX's states and outputs, is stored in
``zaru_tpu_torch/fixtures/sad_linus_track.npz`` for ``chip_smoke.py`` to
replay on the GPU, where JAX is absent. Regenerate it with::

    JAX_PLATFORMS=cpu python tests/test_torch_face_cascade.py
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "zaru_tpu_torch", "fixtures", "sad_linus_track.npz",
)
BATCH = 2
# (force_detect, stream whose frame is zeroed or -1) per step.
PLAN = [(False, -1), (True, -1), (False, 1), (False, -1), (False, -1)]

# One-step tolerance (px) for landmarks and ROIs: 4e-4 px measured.
STEP_TOL_PX = 1e-2
# Free-running bound (px): 4.3 px measured; see the module docstring.
FREE_TOL_PX = 8.0


def _frames(rgb, zero):
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    frames = np.stack([rgba] * BATCH)
    if zero >= 0:
        frames[zero] = 0
    return frames


def _np_state(state):
    return {
        "roi": np.asarray(state["roi"]),
        "tracking": np.asarray(state["tracking"]),
        "filter": {k: np.asarray(v) for k, v in state["filter"].items()},
    }


def jax_run(rgb):
    """zaru_tpu FaceTracker over PLAN: pre-step states and outputs per step."""
    from zaru_tpu.pipeline import FaceTracker

    tracker = FaceTracker()
    state = tracker.init_state(batch=BATCH)
    states, outs = [], []
    for force, zero in PLAN:
        states.append(_np_state(state))
        state, out = tracker._step_batch_gated(
            tracker.params, state, jnp.asarray(_frames(rgb, zero)), force
        )
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return tracker, states, outs


def _flat(rgb, states, outs):
    st = lambda k: np.stack([s[k] for s in states])  # noqa: E731
    fl = lambda k: np.stack([s["filter"][k] for s in states])  # noqa: E731
    ou = lambda k: np.stack([o[k] for o in outs])  # noqa: E731
    return {
        "rgb": rgb,
        "force": np.asarray([f for f, _ in PLAN]),
        "zero": np.asarray([z for _, z in PLAN], np.int32),
        "state_roi": st("roi"), "state_tracking": st("tracking"),
        "state_x": fl("x"), "state_dx": fl("dx"), "state_init": fl("init"),
        "landmarks": ou("landmarks"), "confidence": ou("confidence"),
        "roi": ou("roi"), "valid": ou("valid"),
    }


def regen():
    """Writes the fixture: the decoded photo and JAX's run over PLAN."""
    from zaru_tpu.assets import fixture_path
    from zaru_tpu.image import Image

    rgb = np.ascontiguousarray(Image.load(fixture_path("sad_linus.jpg")).data[..., :3])
    _, states, outs = jax_run(rgb)
    np.savez_compressed(FIXTURE, **_flat(rgb, states, outs))
    print(f"wrote {FIXTURE}")


def _torch_state(state):
    return {
        "roi": torch.from_numpy(np.array(state["roi"])),
        "tracking": torch.from_numpy(np.array(state["tracking"])),
        "filter": {k: torch.from_numpy(np.array(v)) for k, v in state["filter"].items()},
    }


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def live(stored):
    from zaru_tpu_torch.pipeline import FaceTracker as PortTracker
    from zaru_tpu_torch.weights import params_from_jax

    tracker, states, outs = jax_run(stored["rgb"])
    port = PortTracker(params=params_from_jax(tracker.params), device="cpu")
    return tracker, port, states, outs


def _assert_step_close(got, want, tol):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["landmarks"], want["landmarks"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["roi"], want["roi"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["confidence"], want["confidence"], rtol=0, atol=1e-5)


def test_fixture_is_current(stored, live):
    """The stored photo is the decoded JPEG, and the stored JAX states and
    outputs are what zaru_tpu computes now (JAX on the CPU is deterministic:
    held to 1e-3 px, the same bar as the regen machine's own rounding)."""
    from zaru_tpu.assets import fixture_path
    from zaru_tpu.image import Image

    decoded = Image.load(fixture_path("sad_linus.jpg")).data[..., :3]
    assert stored["rgb"].shape == (720, 1280, 3)
    assert np.abs(stored["rgb"].astype(int) - decoded).mean() < 1.0
    np.testing.assert_array_equal(stored["force"], [f for f, _ in PLAN])
    np.testing.assert_array_equal(stored["zero"], [z for _, z in PLAN])
    _, _, states, outs = live
    flat = _flat(stored["rgb"], states, outs)
    for k in ("state_tracking", "state_init", "valid"):
        np.testing.assert_array_equal(stored[k], flat[k], err_msg=k)
    for k in ("state_roi", "state_x", "state_dx", "landmarks", "roi", "confidence"):
        np.testing.assert_allclose(stored[k], flat[k], rtol=0, atol=1e-3, err_msg=k)


def test_one_step_matches_jax(stored, live):
    """From JAX's state before each step, one port step gives JAX's
    outputs: flags equal, landmarks and ROI within STEP_TOL_PX."""
    _, port, states, outs = live
    for t, (force, zero) in enumerate(PLAN):
        _, out = port.step_batch(
            _torch_state(states[t]), torch.from_numpy(_frames(stored["rgb"], zero)), force
        )
        got = {k: v.numpy() for k, v in out.items()}
        _assert_step_close(got, outs[t], STEP_TOL_PX)


def test_free_running_matches_jax(stored, live):
    """The port tracking on its own over the sequence: flags equal at every
    step (loss on the zeroed stream, then redetection), and landmarks within
    FREE_TOL_PX of JAX's."""
    _, port, _states, outs = live
    state = port.init_state(BATCH)
    for t, (force, zero) in enumerate(PLAN):
        state, out = port.step_batch(
            state, torch.from_numpy(_frames(stored["rgb"], zero)), force
        )
        np.testing.assert_array_equal(out["valid"].numpy(), outs[t]["valid"])
        np.testing.assert_array_equal(state["tracking"].numpy(), outs[t]["valid"])
        ok = outs[t]["valid"]
        err = np.abs(out["landmarks"].numpy()[ok] - outs[t]["landmarks"][ok]).max()
        assert err <= FREE_TOL_PX, (t, err)
    assert not outs[2]["valid"][1] and outs[3]["valid"].all()


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    regen()
