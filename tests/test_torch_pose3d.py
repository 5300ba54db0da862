"""The port's blend, quaternions, Procrustes, PnP and approximate
comparison (zaru_tpu_torch ``image.blend``, ``quat``, ``procrustes``,
``pnp``, ``approx``) against zaru_tpu, live, on the CPU.

These are cheap, so both packages run here on the same seeded numpy
inputs:

- **numpy paths** (quat and Procrustes on numpy arrays, the host classes,
  Dlt, approx) run the JAX package's numpy operations: bit for bit;
- **torch paths** (quat and ``procrustes_align`` on tensors) against the
  numpy result: QUAT_TOL and ROT_TOL, f32 rounding of unit quantities in
  another order. ``torch.linalg.svd`` may return singular vectors with
  other signs than numpy's; the ``sign(det)`` correction makes the Kabsch
  rotation the same, which a rotation near 180° about each axis shows
  (tests/test_pose3d.py:91-103);
- **blend** on the cases of tests/test_blend_quat.py and on seeded random
  views (rotated, scaled, partly outside): the port computes XLA's compiled
  form where that was found to matter (see zaru_tpu_torch/image/blend.py);
  ``pow`` and the view rotations still round otherwise now and then, which
  can move an output by one u8 step: BLEND_DIFFERING values, measured;
- **head pose**: ``Estimator(FaceMeshV1())`` on the cropped photo, then
  ``ProcrustesAnalyzer`` against the canonical mesh, yaw as
  tests/test_pose3d.py:160 computes it, within YAW_TOL_DEG of JAX's live
  run and of the yaw stored in ``zaru_tpu_torch/fixtures/identify.npz``
  (which chip_smoke.py holds the card to).
"""

import math
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

from zaru_tpu import approx as japprox  # noqa: E402
from zaru_tpu import pnp as jpnp  # noqa: E402
from zaru_tpu import procrustes as jproc  # noqa: E402
from zaru_tpu import quat as jquat  # noqa: E402
from zaru_tpu_torch import approx as tapprox  # noqa: E402
from zaru_tpu_torch import pnp as tpnp  # noqa: E402
from zaru_tpu_torch import procrustes as tproc  # noqa: E402
from zaru_tpu_torch import quat as tquat  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Torch paths against numpy: unit quaternions and vectors (f32, another
# order of the same operations; measured 2.4e-7), Kabsch rotations
# (measured 3.0e-7 on the CPU, scale, translation and centroids 1.2e-7
# relative).
QUAT_TOL = 1e-5
ROT_TOL = 1e-4
# Blend: u8 values that differ from JAX's (measured 1 of 15_888 here, an
# alpha value of the rotated "random views 0"; 0 of 319_596 on 40 more
# random cases) and the largest difference allowed (one step); bilinear
# samples in linear light (f32 in [0, 1]): 1 ulp (5.96e-8) on 0.8% of
# values, measured.
BLEND_DIFFERING = 1
BLEND_MAX_STEP = 1
BILINEAR_TOL = 2.0**-24
# Head-pose yaw (degrees): the landmarks differ from JAX's by the CNN's
# summation order (measured 1.2e-4 px, held to tests/test_torch_host.py's
# 1e-2), the yaw by 2.3e-6 degrees (of -2.1666).
YAW_TOL_DEG = 1e-2


def rot(axis, a):
    c, s = math.cos(a), math.sin(a)
    m = {"x": [[1, 0, 0], [0, c, -s], [0, s, c]], "y": [[c, 0, s], [0, 1, 0], [-s, 0, c]],
         "z": [[c, -s, 0], [s, c, 0], [0, 0, 1]]}[axis]
    return np.array(m, np.float32)


def equal(got, want):
    """Bit for bit, numpy against numpy (tuples too)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def close(got, want, tol):
    """A tensor result (or tuple of them) against numpy, within ``tol``."""
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            close(g, w, tol)
        return
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=0, atol=tol)


# --- blend -------------------------------------------------------------------


def blend_cases():
    """name: (dest [H,W,4], dest view (cx,cy,w,h,theta) or None, src, src
    view or None): the cases of tests/test_blend_quat.py, then seeded random
    ones."""
    rng = np.random.default_rng(0)
    grad = np.zeros((2, 2, 4), np.uint8)
    grad[0, 0], grad[0, 1] = [0, 0, 0, 255], [200, 0, 0, 255]
    grad[1, 0], grad[1, 1] = [0, 200, 0, 255], [200, 200, 0, 255]
    half = np.zeros((1, 2, 4), np.uint8)
    half[0, 1] = 255
    blank = lambda w, h: np.zeros((h, w, 4), np.uint8)  # noqa: E731
    filled = lambda w, h, c: np.broadcast_to(np.asarray(c, np.uint8), (h, w, 4)).copy()  # noqa: E731
    cases = {
        "full copy": (blank(8, 8), None, rng.integers(0, 256, (8, 8, 4), np.uint8), None),
        "blit to a partial target": (blank(8, 8), (4.0, 4.0, 4.0, 4.0, 0.0), filled(4, 4, (10, 20, 30, 255)), None),
        "bilinear upscale": (blank(8, 8), None, grad, None),
        "rotated dest region": (blank(16, 16), (8.0, 8.0, 8.0, 2.0, math.tau / 4), filled(4, 4, (255,) * 4), None),
        "linear-light midpoint": (blank(8, 1), None, half, None),
    }
    for i in range(4):
        H, W, h, w = (int(v) for v in rng.integers(9, 48, 4))
        dest_view = (*rng.uniform(0, [W, H]), *rng.uniform(3, [W, H]), rng.uniform(-3, 3))
        src_view = (*rng.uniform(0, [w, h]), *rng.uniform(2, [w, h]), rng.uniform(-1, 1) * (i % 2))
        cases[f"random views {i}"] = (rng.integers(0, 256, (H, W, 4), np.uint8), dest_view,
                                      rng.integers(0, 256, (h, w, 4), np.uint8), src_view)
    return cases


def _blend(pkg, dest, dview, src, sview):
    """``pkg``'s blend (``zaru_tpu`` or ``zaru_tpu_torch``) of the case's
    views → the new dest as numpy."""
    import importlib

    image = importlib.import_module(f"{pkg}.image")
    blend = importlib.import_module(f"{pkg}.image.blend").blend
    rect = importlib.import_module(f"{pkg}.geometry" if pkg == "zaru_tpu" else f"{pkg}.rect").RotatedRect
    kw = {} if pkg == "zaru_tpu" else {"device": "cpu"}
    d, s = image.Image(dest, **kw), image.Image(src, **kw)
    view = lambda img, v: img if v is None else img.view(rect(np.asarray(v, np.float32)))  # noqa: E731
    return np.asarray(blend(view(d, dview), view(s, sview)).to_numpy())


def test_blend_matches_jax():
    """Every case: the port's output against JAX's, BLEND_DIFFERING values
    at most differ and by at most BLEND_MAX_STEP; the JAX test's own
    claims hold for the port (linear-light midpoint ~188)."""
    differing = total = 0
    for name, case in blend_cases().items():
        got, want = _blend("zaru_tpu_torch", *case), _blend("zaru_tpu", *case)
        assert got.shape == want.shape and got.dtype == np.uint8, name
        step = np.abs(got.astype(int) - want.astype(int))
        assert step.max() <= BLEND_MAX_STEP, name
        differing += int((step > 0).sum())
        total += step.size
        if name == "linear-light midpoint":
            assert 170 < got[0, 3:5, 0].astype(float).mean() < 200
    assert differing <= BLEND_DIFFERING, (differing, total)


def test_blend_device_and_bilinear_sample():
    """``bilinear_sample`` on tensors within BILINEAR_TOL of the jitted JAX
    function (0 outside the image), ``blend_device`` its result bit for
    bit."""
    from zaru_tpu.image import blend as jblend
    from zaru_tpu_torch.image import blend as tblend

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (13, 17, 4), np.uint8)
    pts = rng.uniform(-3, 20, (40, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jblend.bilinear_sample)(img, pts))
    got = tblend.bilinear_sample(torch.from_numpy(img), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BILINEAR_TOL)
    assert (got[(pts[:, 0] < 0) | (pts[:, 0] > 17) | (pts[:, 1] < 0) | (pts[:, 1] > 13)] == 0).all()
    dest = rng.integers(0, 256, (20, 24, 4), np.uint8)
    dr, sr = np.asarray([11.0, 9.0, 14.0, 10.0, 0.4], np.float32), np.asarray([8.0, 6.0, 12.0, 9.0, 0.0], np.float32)
    want = np.asarray(jblend._blend_jit(dest, dr, img, sr))
    got = tblend.blend_device(*(torch.from_numpy(a) for a in (dest, dr, img, sr))).numpy()
    np.testing.assert_array_equal(got, want)


# --- quat ----------------------------------------------------------------------


def quat_inputs():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {
        "q": q, "q2": np.roll(q, 1, axis=0), "v": rng.normal(size=(16, 3)).astype(np.float32),
        "axis": rng.normal(size=3).astype(np.float32), "angle": np.float32(rng.uniform(-3, 3)),
        "angles": rng.uniform(-3, 3, 16).astype(np.float32),
        "angles2": rng.uniform(-1.5, 1.5, 16).astype(np.float32),
        "raw": rng.normal(size=(16, 4)).astype(np.float32),
    }


QUAT_CALLS = {
    "normalize": lambda m, a: m.normalize(a["raw"]),
    "conjugate": lambda m, a: m.conjugate(a["q"]),
    "multiply": lambda m, a: m.multiply(a["q"], a["q2"]),
    "rotate_vec": lambda m, a: m.rotate_vec(a["q"], a["v"]),
    "from_axis_angle": lambda m, a: m.from_axis_angle(a["axis"], a["angle"]),
    "from_rotation_x": lambda m, a: m.from_rotation_x(a["angles"]),
    "from_rotation_y": lambda m, a: m.from_rotation_y(a["angles"]),
    "from_rotation_z": lambda m, a: m.from_rotation_z(a["angles"]),
    "from_euler": lambda m, a: m.from_euler(a["angles"], a["angles2"], -a["angles"]),
    "to_euler": lambda m, a: m.to_euler(a["q"]),
    "to_rotation_matrix": lambda m, a: m.to_rotation_matrix(a["q"]),
}


def test_quat_matches_jax():
    """Each function on numpy arrays: JAX's numpy result bit for bit; on
    tensors: a tensor within QUAT_TOL of it. (One test for all of them: the
    file's test count sets its place in the ``--dist loadfile`` order.)"""
    args = quat_inputs()
    targs = {k: torch.from_numpy(np.array(v)) for k, v in args.items()}
    for name, call in QUAT_CALLS.items():
        want = call(jquat, args)
        equal(call(tquat, args), want)
        close(call(tquat, targs), want, QUAT_TOL)


def test_quat_scalars_and_matrices():
    """Python-number angles take numpy's float64 path as in JAX;
    ``identity`` is numpy; ``from_rotation_matrix`` is host numpy for a
    matrix given as an array or as a tensor."""
    for fn in ("from_rotation_x", "from_rotation_y", "from_rotation_z"):
        equal(getattr(tquat, fn)(math.tau / 4), getattr(jquat, fn)(math.tau / 4))
    equal(tquat.identity(), jquat.identity())
    for q in quat_inputs()["q"][:6]:
        m = jquat.to_rotation_matrix(q)
        want = jquat.from_rotation_matrix(m)
        equal(tquat.from_rotation_matrix(m), want)
        equal(tquat.from_rotation_matrix(torch.from_numpy(m)), want)


# --- Procrustes ------------------------------------------------------------------


def procrustes_cases():
    """name: (reference [N,3], data [N,3]), after tests/test_pose3d.py."""
    rng = np.random.default_rng(1234)
    cloud = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    jitter = np.random.default_rng(99).normal(0, 0.005, (40, 3)).astype(np.float32)
    r = rot("y", 0.7) @ rot("x", -0.2)
    cases = {
        "identity": cloud,
        "translation": cloud + np.float32([1.0, -2.0, 3.0]),
        "scale": cloud * np.float32(2.5),
        "combined with jitter": (cloud @ r.T) * np.float32(1.7) + np.float32([0.5, 0.25, -1.0]) + jitter,
        "rotation x 0.3 y 1.1 z -0.4": cloud @ (rot("x", 0.3) @ rot("y", 1.1) @ rot("z", -0.4)).T,
        "collapsed": np.zeros_like(cloud),
    }
    for axis in "xyz":
        cases[f"180 degrees about {axis}"] = cloud @ rot(axis, math.pi).T
        cases[f"179 degrees about {axis}"] = cloud @ rot(axis, math.radians(179.0)).T
    return {k: (cloud, v) for k, v in cases.items()}


@pytest.mark.parametrize("name", list(procrustes_cases()))
def test_procrustes_matches_jax(name):
    """``procrustes_align`` on numpy and ``ProcrustesAnalyzer`` (rotation,
    scale, translation, quaternion, transform): JAX's bit for bit.
    ``procrustes_align`` on tensors: the rotation within ROT_TOL of numpy's
    (the SVD's signs do not show), the rest within QUAT_TOL relative."""
    ref, data = procrustes_cases()[name]
    want = jproc.procrustes_align(ref, data)
    equal(tproc.procrustes_align(ref, data), want)
    got = tproc.procrustes_align(torch.from_numpy(ref), torch.from_numpy(data))
    close(got[0], want[0], ROT_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=QUAT_TOL, atol=QUAT_TOL)
    jres, tres = jproc.ProcrustesAnalyzer(ref).analyze(data), tproc.ProcrustesAnalyzer(ref).analyze(data)
    for attr in ("rotation_matrix", "scale", "translation", "centroid", "rotation_quaternion", "transform"):
        equal(getattr(tres, attr)(), getattr(jres, attr)())
    equal(tproc.ProcrustesAnalyzer(torch.from_numpy(ref)).reference_centroid(),
          jproc.ProcrustesAnalyzer(ref).reference_centroid())
    tensor_res = tproc.ProcrustesAnalyzer(ref).analyze(torch.from_numpy(data))
    equal(tensor_res.rotation_matrix(), jres.rotation_matrix())


def test_procrustes_batched_tensors():
    """``[B,N,3]`` tensors align each cloud as the unbatched numpy call
    does; the reference broadcasts."""
    cases = list(procrustes_cases().values())
    ref = cases[0][0]
    data = np.stack([d for _, d in cases])
    got = tproc.procrustes_align(ref, torch.from_numpy(data))
    for i, (_, d) in enumerate(cases):
        want = jproc.procrustes_align(ref, d)
        close(got[0][i], want[0], ROT_TOL)
        np.testing.assert_allclose(got[1][i].numpy(), want[1], rtol=QUAT_TOL)


def test_procrustes_rejects_wrong_length():
    ref = procrustes_cases()["identity"][0]
    with pytest.raises(AssertionError):
        tproc.ProcrustesAnalyzer(ref).analyze(ref[:-1])


# --- PnP and approx ------------------------------------------------------------


def test_dlt_matches_jax():
    """``Dlt.solve`` on projections of a seeded cloud (tests/test_pose3d.py
    TestDlt) and ``IntrinsicParams.to_matrix``: JAX's bit for bit, the points
    given as numpy arrays or tensors; fewer than 6 points are refused."""
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    r = rot("y", 0.3) @ rot("x", -0.15)
    t = np.array([0.2, -0.1, 1.0], np.float32)
    for ti, ji in ((tpnp.IntrinsicParams(1.0, (1.0, 1.0)), jpnp.IntrinsicParams(1.0, (1.0, 1.0))),
                   (tpnp.IntrinsicParams(2.0, (0.5, 0.25)), jpnp.IntrinsicParams(2.0, (0.5, 0.25)))):
        ti.set_principal_point((10.0, 20.0))
        ji.set_principal_point((10.0, 20.0))
        equal(ti.to_matrix(), ji.to_matrix())
    intr = jpnp.IntrinsicParams(1.0, (1.0, 1.0))
    cam = pts @ r.T + t
    proj = (intr.to_matrix()[:, :3] @ cam.T).T
    uv = proj[:, :2] / proj[:, 2:3]
    want = jpnp.Dlt(pts).solve(uv)
    for p, q in ((pts, uv), (torch.from_numpy(pts), torch.from_numpy(uv))):
        got = tpnp.Dlt(p).solve(q)
        equal(got.rotation(), want.rotation())
        equal(got.translation, want.translation)
    np.testing.assert_allclose(want.rotation_matrix, r, atol=5e-3)
    with pytest.raises(AssertionError, match="at least 6"):
        tpnp.Dlt(np.zeros((5, 3), np.float32))


def approx_cases():
    """(a, b) pairs: seeded arrays, then the edges where the JAX package's
    rules differ from the reference's (zaru_tpu/approx.py:12,39): ±0.0
    against a negative denormal, infinities, NaN."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=20).astype(np.float32)
    b = a + rng.normal(scale=1e-6, size=20).astype(np.float32)
    denormal = np.float32(-1.4e-45)
    return [(a, b), (a, -a), (np.float32(-0.0), denormal), (np.float32(0.0), np.float32(-0.0)),
            (np.float32(np.inf), np.float32(np.inf)), (np.float32(1.0), np.float32(np.nan)),
            (np.float32(1.0), np.nextafter(np.float32(1.0), np.float32(2.0)))]


def test_approx_matches_jax():
    """Every comparison on every pair, as arrays and as tensors: the JAX
    package's answer, its reference-side caveats kept; ``assert_approx_eq``
    raises where JAX's does."""
    for i, (a, b) in enumerate(approx_cases()):
        for x, y in ((a, b), (torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b)))):
            for fn, tol in (("abs_diff_eq", 1e-6), ("rel_diff_eq", 1e-6), ("ulps_diff_eq", 4)):
                assert getattr(tapprox, fn)(x, y, tol) == getattr(japprox, fn)(a, b, tol), (i, fn)
            for kw in ({}, {"abs": 1e-7}, {"ulps": 1}, {"rel": 1e-7, "ulps": 2}):
                try:
                    japprox.assert_approx_eq(a, b, **kw)
                except AssertionError:
                    with pytest.raises(AssertionError):
                        tapprox.assert_approx_eq(x, y, **kw)
                else:
                    tapprox.assert_approx_eq(x, y, **kw)
    assert not tapprox.ulps_diff_eq(np.float32(-0.0), np.float32(-1.4e-45), 1)  # the caveat, kept
    assert not tapprox.abs_diff_eq(np.float32(np.inf), np.float32(np.inf), 1.0)


# --- head pose -------------------------------------------------------------------


def _yaw(pkg, cropped, **kw):
    """``pkg``'s Face Mesh V1 on the cropped photo → Procrustes against the
    canonical mesh (Y flipped to image coordinates) → (landmarks, yaw in
    degrees), as tests/test_pose3d.py:160-173."""
    import importlib

    mesh = importlib.import_module(f"{pkg}.face.landmark.mediapipe")
    est = importlib.import_module(f"{pkg}.landmark").Estimator(mesh.FaceMeshV1(**kw))
    res = est.estimate(importlib.import_module(f"{pkg}.image").Image(cropped, **kw))
    assert res.confidence() > 0.9
    ref = mesh.reference_positions().copy()
    ref[:, 1] *= -1.0
    analyzer = importlib.import_module(f"{pkg}.procrustes").ProcrustesAnalyzer(ref)
    w, x, y, z = analyzer.analyze(res.landmarks_mut().positions()).rotation_quaternion()
    return res.landmarks_mut().positions(), math.degrees(math.atan2(2 * (w * y + x * z), 1 - 2 * (y * y + z * z)))


def test_head_pose_yaw_matches_jax():
    """The port's yaw on the cropped photo: frontal (|yaw| < 10°, the JAX
    test's claim), within YAW_TOL_DEG of JAX's live run and of the stored
    yaw."""
    with np.load(os.path.join(ROOT, "zaru_tpu_torch", "fixtures", "host_eval.npz")) as f:
        cropped = f["eval__cropped"]
    with np.load(os.path.join(ROOT, "zaru_tpu_torch", "fixtures", "identify.npz")) as f:
        stored = float(f["pose_yaw"])
    lms, yaw = _yaw("zaru_tpu_torch", cropped, device="cpu")
    jlms, jyaw = _yaw("zaru_tpu", jnp.asarray(cropped))
    np.testing.assert_allclose(lms, jlms, rtol=0, atol=1e-2)
    assert abs(yaw) < 10.0
    assert abs(yaw - jyaw) <= YAW_TOL_DEG and abs(yaw - stored) <= YAW_TOL_DEG, (yaw, jyaw, stored)
