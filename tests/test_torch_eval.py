"""The port's equivariance sweep (zaru_tpu_torch.eval and ``python -m
zaru_tpu_torch eval``) against zaru_tpu.eval on the CPU.

- ``warp_image`` on both fixture photos and the three transforms of
  tests/test_accuracy_eval.py's REDUCED sweep equals JAX's warp bit for bit
  (a SHA-256 digest of each JAX frame is stored, not the frame);
- ``map_points_back`` on seeded points within 1e-4 px (``cos``/``sin`` are
  numpy's here and XLA's there);
- each runner's reduced sweep on the 535×535 photo: the ``valid`` flags
  equal JAX's, the identity row exact (``max_px == 0.0``), and each
  transform's mean, p95 and max deviation within SWEEP_TOL_PX of JAX's;
- the CLI on the default photos with ``--device cpu``, and its refusal to
  run without a device when there is no GPU.

JAX's results are stored in ``zaru_tpu_torch/fixtures/host_eval.npz`` (keys
``eval__*``; tests/test_torch_host.py owns the ``host__*`` keys), with the
535×535 photo decoded (the card's machine has no JPEG decoder). Only
``test_fixture_is_current`` runs JAX, in the test process. Regenerate the
keys of this file with::

    JAX_PLATFORMS=cpu python tests/test_torch_eval.py
"""

import hashlib
import json
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
PREFIX = "eval__"
RUNNER_NAMES = ["face_mesh", "face_mesh_v2", "iris", "multipie68_peppa", "multipie68_onnx", "hand"]
# tests/test_accuracy_eval.py REDUCED: (name, angle_deg, scale).
REDUCED = [("identity", 0.0, 1.0), ("rot+10", 10.0, 1.0), ("scale0.85", 0.0, 0.85)]
# Measured per transform against JAX's row (mean, p95 and max), on the CPU
# (one torch thread) and on an H100 (chip_smoke.py, the same tolerances):
# the host runners within 7.7e-5 / 1.5e-4 px (Peppa) and 6.6e-5 / 4.5e-5 px
# (FaceOnnx), one detection and one estimate each; the fused runners run
# ``run_frame`` three times, each ROI from the last step's landmarks, so the
# CNNs' ~1e-4 px grows as crop pixels on a rounding boundary move: Face Mesh
# V1 0.041 / 0.093 px, V2 0.048 / 0.029 px; the iris crops' rects also go
# through atan2/cos/sin, which differ by an ulp between the libraries
# (tests/test_torch_face_cascade.py): 0.316 / 0.365 px, held to the bound of
# 0.5 px.
SWEEP_TOL_PX = {"face_mesh": 0.25, "face_mesh_v2": 0.25, "iris": 0.5, "multipie68_peppa": 1e-3,
                "multipie68_onnx": 1e-3, "hand": 0.0}
MAP_TOL_PX = 1e-4


def transforms(ev):
    return [ev.Transform(n, angle_deg=a, scale=s) for n, a, s in REDUCED]


def photo_rgba():
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        rgb = f["rgb"]
    return np.ascontiguousarray(np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1))


def decode_cropped():
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.image import Image

    return Image.load(fixture_path("sad_linus_cropped.jpg"), device="cpu").to_numpy()


def map_inputs():
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 535, (64, 2)).astype(np.float32)
    rrect = np.asarray([280.0, 260.0, 610.0, 590.0, 0.3], np.float32)
    return pts, rrect


def digest(frame: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest()


def rows_arrays(rows, key):
    """A runner's rows as ``{key}/names``, ``{key}/valid`` and
    ``{key}/px`` (mean, p95, max; NaN where a row has none)."""
    return {
        f"{key}/names": np.asarray([r["transform"] for r in rows]),
        f"{key}/valid": np.asarray([r["valid"] for r in rows]),
        f"{key}/px": np.asarray([[r.get(k, np.nan) for k in ("mean_px", "p95_px", "max_px")] for r in rows],
                                np.float64),
    }


# --- the JAX side (test_fixture_is_current and regeneration only) -----------


def jax_sweep(name, cropped):
    from zaru_tpu import eval as ev

    return rows_arrays(ev.evaluate_runner(ev.RUNNERS[name](), cropped, transforms(ev)), f"sweep/{name}")


def jax_geometry(cropped):
    from zaru_tpu import eval as ev

    out = {}
    for label, frame in (("photo", photo_rgba()), ("cropped", cropped)):
        h, w = frame.shape[:2]
        out[f"warp/{label}"] = np.asarray([digest(ev.warp_image(frame, ev.transform_rrect(h, w, t)))
                                           for t in transforms(ev)])
    pts, rrect = map_inputs()
    out["map_back"] = np.asarray(ev.map_points_back(pts, rrect, (535, 535)))
    return out


def jax_now(cropped):
    """Every JAX result the fixture stores but the photo."""
    now = jax_geometry(cropped)
    for name in RUNNER_NAMES:
        now.update(jax_sweep(name, cropped))
    return now


def regen():
    cropped = decode_cropped()
    arrays = {"cropped": cropped, **jax_now(cropped)}
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


def assert_rows_match(got, stored, name):
    """``got`` (a runner's rows) against the stored JAX rows of ``name``."""
    g, want = rows_arrays(got, "r"), {k.split("/")[-1]: stored[k] for k in stored if k.startswith(f"sweep/{name}/")}
    assert g["r/names"].tolist() == want["names"].tolist(), name
    np.testing.assert_array_equal(g["r/valid"], want["valid"], err_msg=name)
    np.testing.assert_array_equal(np.isnan(g["r/px"]), np.isnan(want["px"]), err_msg=name)
    np.testing.assert_allclose(g["r/px"], want["px"], rtol=0, atol=SWEEP_TOL_PX[name], err_msg=name)


def test_fixture_is_current(stored):
    """The stored photo is the decoded fixture, and the stored JAX results
    are what zaru_tpu computes now (the warps' digests equal, deviations
    within 1e-3 px, the regen machine's own rounding)."""
    cropped = decode_cropped()
    np.testing.assert_array_equal(stored["cropped"], cropped)
    now = jax_now(cropped)
    assert set(now) == set(stored) - {"cropped"}
    for k, v in now.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


def test_warp_matches_jax(stored):
    """``warp_image`` on both photos is JAX's warp bit for bit; the identity
    reproduces the photo."""
    from zaru_tpu_torch import eval as ev

    for label, frame in (("photo", photo_rgba()), ("cropped", stored["cropped"])):
        h, w = frame.shape[:2]
        warps = [ev.warp_image(frame, ev.transform_rrect(h, w, t), device="cpu") for t in transforms(ev)]
        np.testing.assert_array_equal(warps[0], frame)
        assert [digest(x) for x in warps] == stored[f"warp/{label}"].tolist(), label


def test_map_points_back_matches_jax(stored):
    from zaru_tpu_torch import eval as ev

    pts, rrect = map_inputs()
    got = ev.map_points_back(pts, rrect, (535, 535))
    np.testing.assert_allclose(got, stored["map_back"], rtol=0, atol=MAP_TOL_PX)


@pytest.mark.parametrize("name", RUNNER_NAMES)
def test_reduced_sweep_matches_jax(stored, name):
    """Each runner's reduced sweep on the 535×535 photo: flags equal, the
    identity exact, deviations within SWEEP_TOL_PX; the hand runner finds no
    hand, as JAX's."""
    from zaru_tpu_torch import eval as ev

    rows = ev.evaluate_runner(ev.RUNNERS[name](device="cpu"), stored["cropped"], transforms(ev), device="cpu")
    assert_rows_match(rows, stored, name)
    if name == "hand":
        assert rows == [{"transform": "base", "valid": False}]
    else:
        assert rows[0]["transform"] == "identity" and rows[0]["max_px"] == 0.0


def test_cli_eval(tmp_path, stored, capsys):
    """``python -m zaru_tpu_torch eval --device cpu --models
    face_mesh,multipie68_peppa --json OUT`` on both fixture photos: a line
    and a JSON report per model and photo, eight transforms each, the
    identity exact; on the 535×535 photo the rows of the reduced sweep's
    transforms match JAX's."""
    from zaru_tpu_torch.__main__ import main

    out = tmp_path / "eval.json"
    assert main(["eval", "--device", "cpu", "--models", "face_mesh,multipie68_peppa", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    report = json.loads(out.read_text())
    keys = [f"{m}:{p}" for m in ("face_mesh", "multipie68_peppa") for p in ("sad_linus.jpg", "sad_linus_cropped.jpg")]
    assert sorted(report) == sorted(keys)
    for key in keys:
        rows = report[key]["rows"]
        assert len(rows) == 8 and all(r["valid"] for r in rows), key
        assert rows[0]["transform"] == "identity" and rows[0]["max_px"] == 0.0, key
        assert report[key]["summary"]["valid_transforms"] == 7, key
        assert f"{key}: mean" in text
    for name in ("face_mesh", "multipie68_peppa"):
        rows = report[f"{name}:sad_linus_cropped.jpg"]["rows"]
        assert_rows_match([r for r in rows if r["transform"] in {n for n, _, _ in REDUCED}], stored, name)


def test_cli_eval_needs_a_device(monkeypatch):
    """Without ``--device`` and without a GPU, ``eval`` raises instead of
    running on the CPU; an unknown model exits."""
    from zaru_tpu_torch import eval as ev
    from zaru_tpu_torch.__main__ import main

    with pytest.raises(SystemExit, match="unknown model"):
        main(["eval", "--device", "cpu", "--models", "nose"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["eval", "--models", "face_mesh"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev.warp_image(photo_rgba(), ev.transform_rrect(720, 1280, ev.Transform("identity")))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen()
