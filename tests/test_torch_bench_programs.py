"""The port's measurement programs (zaru_tpu_torch/bench_programs.py)
against zaru_tpu/bench_programs.py, on the CPU.

- ``make_1080p_frame``: the port builds the bench frame from the stored
  decode of the photo with a NumPy copy of OpenCV's bilinear u8 resize; it
  equals JAX's frame (decode + ``cv2.resize``) bit for bit, and the resize
  equals ``cv2.resize(INTER_LINEAR)`` on seeded images.
- ``build_cascade_scan``: the port's eager loop equals a plain loop of
  ``step_batch`` calls bit for bit, and is held to JAX's scan over the same
  10 steps at batch 2 on the bench frame, stored in
  ``zaru_tpu_torch/fixtures/bench_programs.npz``: step 0's confidences
  within 1e-5 (``_assert_step_close``'s bar), every step's tracking flag
  equal, and the later steps, where the two trackers run free and drift
  apart ("Chaos" in ROADMAP.md), within the measured bounds below.
  ``test_fixture_is_current`` runs JAX's scan again, in the test process.
  Regenerate the fixture with::

      JAX_PLATFORMS=cpu python tests/test_torch_bench_programs.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "zaru_tpu_torch", "fixtures", "bench_programs.npz",
)
BATCH, STEPS, DETECT_EVERY = 2, 10, 9
# Free-running bounds after step 0: confidences (1.0 in both runs, measured
# 0) and the final ROI (px; measured 5.99 on its width of 646 px, 1.12 on
# its centre, 0.004 rad on its angle: the landmarks in the smoothing state
# differ by up to 0.48 px of the 192-px crop, and the ROI is their rotated
# bounding box padded by 0.3 a side).
FREE_CONF_TOL = 1e-5
FREE_ROI_TOL_PX = 12.0


def jax_scan_arrays():
    """JAX's ``build_cascade_scan`` over STEPS steps at BATCH on its bench
    frame: ``{"confs", "roi", "tracking", "filter_<k>"}`` as numpy."""
    import jax
    import jax.numpy as jnp

    from zaru_tpu import bench_programs as bp
    from zaru_tpu.pipeline import FaceTracker

    tracker = FaceTracker()
    frames = bp.tile_frames(jax.device_put(jnp.asarray(bp.make_1080p_frame())), BATCH)
    run = bp.build_cascade_scan(tracker, STEPS, DETECT_EVERY)
    state, confs = run(tracker.params, tracker.init_state(batch=BATCH), frames)
    out = {"confs": np.asarray(confs), "roi": np.asarray(state["roi"]), "tracking": np.asarray(state["tracking"])}
    out.update({f"filter_{k}": np.asarray(v) for k, v in state["filter"].items()})
    return out


def regen():
    np.savez_compressed(FIXTURE, **jax_scan_arrays())
    print(f"wrote {FIXTURE}")


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def frame():
    from zaru_tpu_torch.bench_programs import make_1080p_frame

    return make_1080p_frame()


@pytest.fixture(scope="module")
def port_run(frame):
    """The port's scan and a plain ``step_batch`` loop over the same steps:
    (scan state, scan confidences, loop state, loop outputs per step)."""
    from zaru_tpu_torch.bench_programs import build_cascade_scan, tile_frames
    from zaru_tpu_torch.pipeline import FaceTracker

    tracker = FaceTracker(device="cpu")
    frames = tile_frames(frame, BATCH, "cpu")
    state, confs = build_cascade_scan(tracker, STEPS, DETECT_EVERY)(tracker.init_state(BATCH), frames)
    lstate, outs = tracker.init_state(BATCH), []
    for t in range(STEPS):
        lstate, out = tracker.step_batch(lstate, frames, t % DETECT_EVERY == 0)
        outs.append(out)
    return state, confs, lstate, outs


def test_make_1080p_frame_equals_jax(frame):
    """The bench frame bit for bit: JAX decodes the JPEG and resizes with
    cv2 (numpy and cv2 only, no JAX program runs)."""
    from zaru_tpu.bench_programs import make_1080p_frame as jax_frame

    want = jax_frame()
    assert frame.shape == (1080, 1920, 4) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, want)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("size", [(40, 60, 90, 60), (33, 47, 94, 66), (31, 45, 103, 77)],
                         ids=["1.5x", "2x", "odd"])
def test_resize_equals_cv2(size, channels):
    """The private resize equals ``cv2.resize(INTER_LINEAR)`` on seeded u8
    images: upscales by 1.5x, 2x and a non-integer factor to odd sizes."""
    import cv2

    from zaru_tpu_torch.bench_programs import _resize_linear_u8

    h, w, dw, dh = size
    img = np.random.default_rng(h * w + channels).integers(0, 256, (h, w, channels), dtype=np.uint8)
    got = _resize_linear_u8(img, dw, dh)
    np.testing.assert_array_equal(got, cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR))


def test_tile_frames():
    from zaru_tpu_torch.bench_programs import tile_frames

    f = np.random.default_rng(0).integers(0, 256, (6, 10, 4), dtype=np.uint8)
    for src in (f, torch.from_numpy(f)):
        t = tile_frames(src, 3, "cpu")
        assert t.shape == (3, 6, 10, 4) and t.dtype == torch.uint8 and t.is_contiguous()
        assert all(np.array_equal(t[i].numpy(), f) for i in range(3))


def test_cascade_scan_equals_step_loop(port_run):
    """The scan is a loop of ``step_batch`` with detection forced on steps 0
    and 9: confidences and the final state bit-equal to the plain loop's."""
    state, confs, lstate, outs = port_run
    assert confs.shape == (STEPS, BATCH)
    torch.testing.assert_close(confs, torch.stack([o["confidence"] for o in outs]), rtol=0, atol=0)
    for k in ("roi", "tracking"):
        torch.testing.assert_close(state[k], lstate[k], rtol=0, atol=0)
    for k, v in state["filter"].items():
        torch.testing.assert_close(v, lstate["filter"][k], rtol=0, atol=0)


def test_cascade_scan_matches_jax(stored, port_run):
    """Against JAX's stored scan: step 0 within 1e-5, every step's flag
    equal (the port's ``valid`` against JAX's confidence above the loss
    threshold: JAX's scan returns only confidences, and on the photo every
    detection is found), the later confidences and the final state within
    the free-running bounds."""
    state, confs, _lstate, outs = port_run
    got = confs.numpy()
    np.testing.assert_allclose(got[0], stored["confs"][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1:], stored["confs"][1:], rtol=0, atol=FREE_CONF_TOL)
    np.testing.assert_array_equal(np.stack([o["valid"].numpy() for o in outs]), stored["confs"] >= 0.5)
    np.testing.assert_array_equal(state["tracking"].numpy(), stored["tracking"])
    np.testing.assert_allclose(state["roi"].numpy(), stored["roi"], rtol=0, atol=FREE_ROI_TOL_PX)


def test_fixture_is_current(stored):
    """The stored run is what zaru_tpu's ``build_cascade_scan`` computes now
    (held to 1e-3, as the other fixtures are)."""
    live = jax_scan_arrays()
    assert set(live) == set(stored)
    for k, v in live.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


def test_measure_tunnel_roundtrip():
    from zaru_tpu_torch.bench_programs import measure_tunnel_roundtrip

    assert measure_tunnel_roundtrip(n=5, device="cpu") > 0.0


if __name__ == "__main__":
    import jax

    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    regen()
