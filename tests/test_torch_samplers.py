"""The port's plain samplers against the JAX samplers, bit for bit, on the
CPU.

- Letterbox: ``zaru_tpu_torch.ops.letterbox.letterbox_sample_reference``
  against ``letterbox_sample_core`` (compiled, as the cascade runs it) and
  ``letterbox_sample_pallas(..., interpret=True)``.
- Rotated ROI: ``zaru_tpu_torch.ops.rotated_fast.rotated_sample_fast`` (a CPU
  tensor takes the plain version) against ``zaru_tpu.ops.rotated_fast.
  rotated_sample_fast``, which runs its Pallas kernels in interpret mode on
  the CPU (rotated_fast.py:1083). The views cover upright, tilted (±0.25,
  0.55, 0.8 rad), a frame corner read out of bounds, an 836 px view at
  stride 2 and, tilted 0.7 rad, stride 3, and a view whose bbox exceeds
  1536 px (stride 4), over ``[B,S,5]`` slots. Both batches have one shape,
  so JAX compiles its sampler once for both (about 25 s on the CPU).
- The same at the hand tracker's geometry: 224×224 views on the 256-pixel
  grid at any angle, strides 1-3.
- The same at Face Mesh V2's crop, 256×256 on the 512-pixel grid (views of
  up to 836 px, strides 1-3), and the letterbox at the full-range
  detector's 192×192.
- Exact rotated view: ``zaru_tpu_torch.ops.sampling.view_to_tensor_core``
  against compiled ``view_to_tensor_core``.
- The rotated sampler's per-view coefficients (``sampler_coefs``, which the
  CUDA kernel computes in the same op order) against JAX's
  ``_prescale_geometry``/``_sampler_coefs``/``_prescale_coefs`` on random
  rects: every coefficient bit for bit except ``cos`` and ``sin``, which
  differ by one ulp between the libraries on about 10% of angles.
- The planar ``[...,3,h,w]`` layout the pipelines feed their CNNs (and the
  iris path's mirrored slots) against the NHWC result, permuted (flipped),
  bit for bit, for both samplers on small frames.

Two things XLA:CPU does when it compiles the JAX samplers, found here:

- it contracts the colour map ``c * adjust + lo`` into one FMA (one
  rounding; op by op, JAX rounds twice and differs in the last ulp on ~35%
  of pixels at ``lo=-1``). The port rounds the colour map once as well, so
  the letterbox sampler is bit-exact;
- in the rotated sampler's index map (rotated_fast.py:641-654) it computes
  ``j / 192`` as ``j * f32(1/192)``, which is one ulp off the quotient for
  63 of the 192 columns, and contracts ``cth*px - sth*py`` into
  ``fma(cth, px, -(sth*py))``. The port computes both the same way (the
  reciprocal from the host, the FMA with ``__fmaf_rn`` in the kernel and an
  exactly rounded emulation, ``num.fma``, in the plain version), so every
  view here is bit-exact. Before that, 110 pixels in column 56 of the
  420×360 view at -0.8 rad (56/192·420 = 122.5 exactly) and 1 pixel of the
  320 px view at -0.55 rad read the neighbouring prescale cell. It
  contracts ``sth*px + cth*py`` as well, into ``fma(sth, px, cth*py)``:
  without that, one pixel each of two 256² views (760 px at 1.0 rad,
  836 px at 0.7 rad) read the neighbouring prescale row. And it contracts
  the map into the prescale grid, ``fx * inv_sx + qx0`` (likewise y), into
  ``fma(fx, inv_sx, qx0)``: without that, one pixel of a 900 px body view
  on the 256-pixel grid read the neighbouring prescale row, and so did
  pixels of each of the views of ``VIEWS_PRESCALE_FMA``, found by a search
  for views where the two forms differ, on the 512-pixel grid;
- the exact sampler and the letterbox compute ``j / n`` as
  ``j * f32(1/n)`` too, and the exact sampler contracts both rotated
  coordinates the same way. The port follows both: before that, 166
  pixels of a 420 px hand view at 3.1 rad (column and row 124: 124/224·420
  = 232.5 exactly) and one pixel of a 276 px face view read a neighbour.

What remains: ``cos`` and ``sin`` of the view angle can differ by an ulp
between the libraries (tests/test_torch_core.py), and at angles and sizes
other than these views that can still move a pixel whose index lies on a
rounding boundary to the neighbouring prescale cell.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zaru_tpu.ops.pallas_kernels import letterbox_sample_pallas
from zaru_tpu.ops.rotated_fast import rotated_sample_fast as jax_rotated
from zaru_tpu.ops.sampling import letterbox_sample_core, view_to_tensor_core
from zaru_tpu.pipeline import _ops as jops
from zaru_tpu.resolution import Resolution
from zaru_tpu.ops import rotated_fast as jax_rf
from zaru_tpu_torch.ops.letterbox import letterbox_sample, letterbox_sample_reference
from zaru_tpu_torch.ops.rotated_fast import rotated_sample_fast, sampler_coefs
from zaru_tpu_torch.ops.sampling import view_to_tensor_core as view_to_tensor_reference
from torch_port import one_torch_thread  # noqa: F401


def coord_image(H, W):
    """RGB encodes (x, y): r = x & 255, g = (x>>8)*16 + (y>>8), b = y & 255
    (the trick of tests/test_rotated_fast.py)."""
    x = np.arange(W)[None, :].repeat(H, 0)
    y = np.arange(H)[:, None].repeat(W, 1)
    img = np.zeros((H, W, 4), np.uint8)
    img[..., 0] = x & 255
    img[..., 1] = (x >> 8) * 16 + (y >> 8)
    img[..., 2] = y & 255
    img[..., 3] = 255
    return img


# (cx, cy, w, h, theta). Batch A: every view admits one of the Pallas crop
# classes, so JAX runs its fused kernel; batch B holds a stride-4 view, so
# JAX takes its exact fallback (take prescale + rotate kernel) for the whole
# batch, batch A's first eight views included.
# Each view with the number of its pixels allowed to differ: none.
VIEWS_A = [
    ((960, 540, 300, 300, 0.0), 0),      # upright, stride 1
    ((500, 400, 192, 192, 0.0), 0),      # upright
    ((960, 540, 300, 300, 0.25), 0),     # tilted
    ((700, 500, 400, 400, -0.25), 0),
    ((1300, 600, 350, 350, 0.55), 0),
    ((600, 300, 250, 250, 0.8), 0),
    ((60, 60, 300, 300, 1.2), 0),        # frame corner: reads out of bounds
    ((960, 540, 836, 836, 0.0), 0),      # stride 2
    ((960, 540, 836, 836, 0.7), 0),      # stride 3
    ((1500, 700, 420, 360, -0.8), 0),    # stride 2
]
VIEWS_B = [
    ((960, 540, 1600, 1600, 0.0), 0),    # bbox > 1536: stride 4
    ((900, 500, 320, 320, -0.55), 0),
    *VIEWS_A[:8],
]
# JAX's sampler at the face crop, compiled once for both batches.
jax_rotated_192 = jax.jit(partial(jax_rotated, out_w=192, out_h=192, lo=-1.0, hi=1.0))


def _decode(mapped, b):
    """Source (x, y) of colour-mapped ``[..., 3]`` pixels of frame ``b``."""
    c = np.rint((mapped.astype(np.float64) + 1.0) * 127.5).astype(np.int64)
    x = ((c[..., 1] // 16) * 256 + c[..., 0] + 7 * b) % 1920
    return x, (c[..., 1] % 16) * 256 + c[..., 2]


def _frames(n, H=1080, W=1920):
    """n different coordinate frames (shifted per stream), so a wrong
    slot→frame index shows."""
    base = coord_image(H, W)
    return np.stack([np.roll(base, 7 * i, axis=1) for i in range(n)])


@pytest.mark.parametrize("views", [VIEWS_A, VIEWS_B], ids=["fused", "fallback"])
def test_rotated_sampler_matches_jax(views):
    rects = np.asarray([v for v, _ in views], np.float32).reshape(-1, 2, 5)  # [B, S=2, 5]
    frames = _frames(rects.shape[0])
    want = np.asarray(jax_rotated_192(jnp.asarray(frames), jnp.asarray(rects)))
    got = rotated_sample_fast(
        torch.from_numpy(frames), torch.from_numpy(rects), 192, 192, -1.0, 1.0
    ).numpy()
    assert got.shape == want.shape == (rects.shape[0], 2, 192, 192, 3)
    for i, (view, count) in enumerate(views):
        b, s = divmod(i, 2)
        differ = (got[b, s] != want[b, s]).any(-1)
        assert differ.sum() <= count, (view, differ.sum())
        if differ.any():
            gx, gy = _decode(got[b, s][differ], b)
            wx, wy = _decode(want[b, s][differ], b)
            cx, cy, w, h, th = view
            bbox = max(w * abs(np.cos(th)) + h * abs(np.sin(th)),
                       w * abs(np.sin(th)) + h * abs(np.cos(th))) + 2
            stride = int(np.ceil(bbox / 512))
            assert np.abs(gx - wx).max() <= stride and np.abs(gy - wy).max() <= stride
    # Black (lo) where the view leaves the frame: the corner view has some.
    assert (got == -1.0).all(-1).any()


# Face crops, 192×192 on the 512-pixel grid (strides 2 and 3), each with
# pixels whose prescale-grid index differs between ``fx * inv_sx + qx0``
# rounded twice and its FMA (a search over random views at angles where
# XLA's and torch's cos and sin agree).
VIEWS_PRESCALE_FMA = [
    (705.380859375, 524.2680053710938, 952.0814819335938, 952.0814819335938, 2.50960636138916),
    (1275.47412109375, 848.763671875, 799.2994384765625, 799.2994384765625, -0.6397162079811096),
    (1242.2269287109375, 264.4622802734375, 1052.534423828125, 1052.534423828125, -2.4242894649505615),
    (1323.22607421875, 520.6557006835938, 900.53466796875, 900.53466796875, -2.858391284942627),
    (495.6822814941406, 648.0073852539062, 931.3646850585938, 931.3646850585938, -1.9777787923812866),
    (1374.8729248046875, 398.2197265625, 1047.052978515625, 1047.052978515625, 2.1990137100219727),
    (1299.0721435546875, 764.4442749023438, 888.4882202148438, 888.4882202148438, 2.184288740158081),
    (860.5947875976562, 636.1656494140625, 984.6622924804688, 984.6622924804688, -1.202706217765808),
    (1401.097900390625, 445.7167053222656, 844.6909790039062, 844.6909790039062, 2.0155282020568848),
    (1272.683349609375, 808.9071655273438, 776.810546875, 776.810546875, -0.83737713098526),
]


def test_rotated_sampler_prescale_map_is_fma():
    """The views of VIEWS_PRESCALE_FMA at 192×192 on the 512-pixel grid, bit
    for bit against JAX (the batch has VIEWS_A's shape, so JAX's sampler is
    compiled once for both); the twice-rounded prescale map would read the
    neighbouring prescale cell at some pixel of each."""
    rects = np.asarray(VIEWS_PRESCALE_FMA, np.float32).reshape(5, 2, 5)
    frames = _frames(5)
    want = np.asarray(jax_rotated_192(jnp.asarray(frames), jnp.asarray(rects)))
    got = rotated_sample_fast(torch.from_numpy(frames), torch.from_numpy(rects), 192, 192, -1.0, 1.0).numpy()
    np.testing.assert_array_equal(got, want)


# Face Mesh V2 crops, 256×256 on the 512-pixel grid: views of the sizes a
# FaceTracker(landmarker=FaceMeshV2()) takes at 1080p (600-830 px, so
# strides 2 and 3 at its angles), smaller ones at stride 1, and the frame
# corner; [5,2,5] like the 192² batches.
VIEWS_V2 = [
    (960, 540, 620, 620, 0.0), (900, 500, 700, 700, 0.3), (1100, 560, 830, 830, -0.45),
    (700, 450, 760, 760, 1.0), (960, 540, 300, 300, 0.25), (500, 400, 256, 256, 0.0),
    (60, 60, 300, 300, 1.2), (1500, 700, 420, 360, -0.8), (1300, 600, 650, 650, 2.9),
    (960, 540, 836, 836, 0.7),
]


def test_rotated_sampler_mesh_v2_grid_matches_jax():
    """The Face Mesh V2 crops: 256×256 views on the 512-pixel grid, colour
    range [-1, 1], bit for bit, strides 1-3, across the frame corner."""
    rects = np.asarray(VIEWS_V2, np.float32).reshape(5, 2, 5)
    frames = _frames(5)
    want = np.asarray(jax.jit(partial(jax_rotated, out_w=256, out_h=256, lo=-1.0, hi=1.0))(
        jnp.asarray(frames), jnp.asarray(rects)))
    got = rotated_sample_fast(torch.from_numpy(frames), torch.from_numpy(rects), 256, 256, -1.0, 1.0).numpy()
    assert got.shape == (5, 2, 256, 256, 3)
    np.testing.assert_array_equal(got, want)
    assert (got == -1.0).all(-1).any()


def test_rotated_sampler_eye_grid_matches_jax():
    """The eye crops of iris refinement: 64×64 square views on a 256-pixel
    prescale grid (face_cascade.py:401-404), upright, tilted, at stride 2
    and across the frame corner, bit for bit."""
    rects = np.asarray([
        (640, 340, 147, 147, -0.02), (762, 337, 151, 151, 0.3),
        (300, 500, 90, 90, -1.1), (900, 400, 400, 400, 0.6),
        (20, 30, 120, 120, 0.0), (1800, 1000, 160, 160, 2.2),
    ], np.float32).reshape(3, 2, 5)
    frames = _frames(3)
    want = np.asarray(jax_rotated(
        jnp.asarray(frames), jnp.asarray(rects), 64, 64, -1.0, 1.0,
        prescale_m=256, band_p=256, col_split=1, square_views=True,
    ))
    got = rotated_sample_fast(
        torch.from_numpy(frames), torch.from_numpy(rects), 64, 64, -1.0, 1.0, prescale_m=256
    ).numpy()
    assert got.shape == (3, 2, 64, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert (got == -1.0).all(-1).any()


def test_rotated_sampler_hand_grid_matches_jax():
    """The hand crops of MultiHandTracker: 224×224 square views on a
    256-pixel prescale grid with the hand tracker's sampler options
    (hand_cascade.py:83-86), at angles near ±π and ±π/2, at stride 1, and
    at stride 2 and 3 (views of 400-600 px), across the frame corner, bit
    for bit (colour range [0, 1])."""
    rects = np.asarray([
        (960, 540, 200, 200, 3.14159), (700, 500, 240, 240, -3.1),
        (500, 400, 230, 230, 1.5708), (1200, 300, 250, 250, -1.5708),
        (960, 540, 400, 400, 3.0), (800, 600, 600, 600, -1.6),
        (60, 1000, 300, 300, 2.5), (1500, 200, 500, 500, 0.785),
    ], np.float32).reshape(4, 2, 5)
    frames = _frames(4)
    want = np.asarray(jax_rotated(
        jnp.asarray(frames), jnp.asarray(rects), 224, 224, 0.0, 1.0,
        prescale_m=256, band_p=256, col_split=1, square_views=True,
    ))
    got = rotated_sample_fast(
        torch.from_numpy(frames), torch.from_numpy(rects), 224, 224, 0.0, 1.0, prescale_m=256
    ).numpy()
    assert got.shape == (4, 2, 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    assert (got == 0.0).all(-1).any()  # the corner view reads outside the frame


def test_kernel_wrappers_refuse_bad_input():
    """The wrappers check dtype, shape, layout, mirror flags and device
    before any launch, and the CUDA launches themselves refuse a CPU tensor
    instead of running the plain version."""
    from zaru_tpu_torch.ops.rotated_fast import kernel_coefs, rotated_sample_launch

    frames = torch.zeros((2, 8, 8, 4), dtype=torch.uint8)
    rects = torch.tensor([[4.0, 4.0, 6.0, 6.0, 0.3]] * 2)
    with pytest.raises(ValueError, match="uint8"):
        rotated_sample_fast(frames.float(), rects, 4, 4)
    with pytest.raises(ValueError, match="rects"):
        rotated_sample_fast(frames, rects[:1], 4, 4)
    with pytest.raises(ValueError, match="layout"):
        rotated_sample_fast(frames, rects, 4, 4, layout="HWC")
    with pytest.raises(ValueError, match="mirror"):
        rotated_sample_fast(frames, rects, 4, 4, mirror=(False, True))
    with pytest.raises(ValueError, match="rects"):
        letterbox_sample(frames, rects[:, :4], 4, 4, -1.0, 1.0)
    with pytest.raises(ValueError, match="layout"):
        letterbox_sample(frames, rects, 4, 4, -1.0, 1.0, layout="HWC")
    with pytest.raises(ValueError, match="CUDA"):
        rotated_sample_launch(frames, rects, 1, 4, 4, -1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_coefs(rects)


@pytest.mark.parametrize("m", [512, 256])
def test_sampler_coefs_match_jax(m):
    """The per-view coefficients on 4000 random rects: centres inside and
    outside a 1920×1080 frame, sizes that give strides 1 to 8, angles over
    [-π, π]. Every coefficient and integer is JAX's bit for bit except cos
    and sin, which are within one ulp (and differ on about 10%)."""
    rng = np.random.default_rng(m)
    n = 4000
    rects = np.stack([
        rng.uniform(-300, 2200, n), rng.uniform(-300, 1400, n),
        rng.uniform(10, 0.69 * 8 * m, n), rng.uniform(10, 0.69 * 8 * m, n),
        rng.uniform(-np.pi, np.pi, n),
    ], -1).astype(np.float32)

    def one(rr):
        left, top, sx, sy, _bw, _bh = jax_rf._prescale_geometry(rr, m)
        return jax_rf._sampler_coefs(rr, 192, 192, left, top, sx, sy)

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(rects)))
    # [ystart, xstart, ly, lx, syi, sxi] → (lx, ly, sx, sy)
    iwant = np.asarray(jax.jit(
        lambda r: jax_rf._prescale_coefs(r, m, 1080, 1920, jax_rf.PRESCALE_SMAX)
    )(jnp.asarray(rects)))[:, [3, 2, 5, 4]]
    got, igot = (t.numpy() for t in sampler_coefs(torch.from_numpy(rects), m))
    np.testing.assert_array_equal(np.unique(igot[:, 2:]), np.arange(1, 9))  # strides 1-8
    np.testing.assert_array_equal(igot, iwant)
    trig = [2, 3]
    rest = [i for i in range(12) if i not in trig]
    np.testing.assert_array_equal(got[:, rest], want[:, rest])
    ulps = np.abs(got[:, trig].view(np.int32) - want[:, trig].view(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).any(-1).mean() < 0.2, (ulps.max(), (ulps > 0).any(-1).mean())


def _small(views, scale):
    """A view set scaled onto a 384×288 frame, the original views beside it
    (mostly outside the small frame): ``[B,2,5]``."""
    v = np.asarray([r for r, _ in views] if len(views[0]) == 2 else views, np.float32)
    small = v * np.asarray([scale, scale, scale, scale, 1.0], np.float32)
    both = np.concatenate([small, v])
    return both[: len(both) // 2 * 2].reshape(-1, 2, 5)


@pytest.mark.parametrize("case", ["fused", "fallback", "eye", "hand"])
def test_planar_layout_is_permuted_nhwc(case):
    """The planar layout the pipelines feed their CNNs is the NHWC result
    permuted, bit for bit, on each rotated view set (scaled onto a small
    frame, and as they are), and a mirrored slot is the NHWC slot flipped
    left to right."""
    eye = [(640, 340, 147, 147, -0.02), (762, 337, 151, 151, 0.3), (300, 500, 90, 90, -1.1),
           (900, 400, 400, 400, 0.6), (20, 30, 120, 120, 0.0), (1800, 1000, 160, 160, 2.2)]
    hand = [(960, 540, 200, 200, 3.14159), (700, 500, 240, 240, -3.1), (60, 1000, 300, 300, 2.5),
            (1500, 200, 500, 500, 0.785)]
    views, size, m = {"fused": (VIEWS_A, 192, 512), "fallback": (VIEWS_B, 192, 512),
                      "eye": (eye, 64, 256), "hand": (hand, 224, 256)}[case]
    rects = torch.from_numpy(_small(views, 0.2))
    frames = torch.from_numpy(_frames(rects.shape[0], 288, 384))
    args = (size, size, -1.0, 1.0, m)
    nhwc = rotated_sample_fast(frames, rects, *args)
    planar = rotated_sample_fast(frames, rects, *args, layout="NCHW")
    assert planar.shape == (rects.shape[0], 2, 3, size, size) and planar.is_contiguous()
    assert torch.equal(planar, nhwc.movedim(-1, -3))
    assert (nhwc != -1.0).any()  # the scaled views read the frame
    mirrored = rotated_sample_fast(frames, rects, *args, layout="NCHW", mirror=(False, True))
    assert torch.equal(mirrored[:, 0], planar[:, 0])
    assert torch.equal(mirrored[:, 1], planar[:, 1].flip(-1))


def test_letterbox_planar_layout_is_permuted_nhwc():
    """The letterbox sampler's planar layout is its NHWC result permuted,
    bit for bit: the full-frame fit and offset, scaled views partly outside
    a 384×288 frame, at the face (128²) and palm (192²) detector sizes."""
    frames = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 288, 384, 4), dtype=np.uint8))
    fit = _fit(288, 384)
    rects = torch.from_numpy(np.stack([
        fit, [115.2, 172.8, 345.6, 345.6, 0.0], [19.2, 28.8, 60.3, 57.5, 0.0], [300.0, 50.0, 400.0, 250.0, 0.0],
    ]).astype(np.float32))
    for size in (128, 192):
        nhwc = letterbox_sample(frames, rects, size, size, -1.0, 1.0)
        planar = letterbox_sample(frames, rects, size, size, -1.0, 1.0, layout="NCHW")
        assert planar.shape == (4, 3, size, size) and planar.is_contiguous()
        assert torch.equal(planar, nhwc.permute(0, 3, 1, 2))
        assert (nhwc == -1.0).all(-1).any() and (nhwc != -1.0).any()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_view_to_tensor_bit_exact(layout):
    """The exact rotated-view sampler against compiled
    ``view_to_tensor_core``, upright, tilted, out of bounds and large
    views. Bit-exact, tilted views included: the cos/sin of these angles
    agree in both libraries."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 1080, 1920, 4), dtype=np.uint8)
    rects = np.asarray([
        (960, 540, 300, 300, 0.0), (500, 400, 192, 192, 0.0), (960, 540, 300, 300, 0.25),
        (700, 500, 400, 400, -0.25), (60, 60, 300, 300, 1.2), (1300, 600, 836, 836, 0.7),
    ], np.float32)
    jit_core = jax.jit(
        jax.vmap(lambda f, r: view_to_tensor_core(f, r, 192, 192, -1.0, 1.0, layout)[0])
    )
    want = np.asarray(jit_core(jnp.asarray(frames), jnp.asarray(rects)))
    got = view_to_tensor_reference(
        torch.from_numpy(frames), torch.from_numpy(rects), 192, 192, -1.0, 1.0, layout
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == -1.0).any()  # the corner view reads outside the frame


def test_view_to_tensor_slots_bit_exact():
    """The exact sampler on ``[B,S,5]`` slots at the hand crop's 224×224:
    64 random views (10-900 px, any angle, partly outside the frame) and a
    420 px view at 3.1 rad whose column and row 124 lie on a rounding
    boundary of ``j / 224``, against compiled ``view_to_tensor_core`` bit for
    bit wherever torch's and XLA's ``cos`` and ``sin`` of the angle agree
    (most views); mirrored slots are the JAX crops flipped left to right."""
    rng = np.random.default_rng(11)
    n = 64
    rects = np.stack([rng.uniform(-100, 2000, n), rng.uniform(-100, 1200, n), rng.uniform(10, 900, n),
                      rng.uniform(10, 900, n), rng.uniform(-3.2, 3.2, n)], -1).astype(np.float32)
    rects[0] = (420, 300, 420, 420, 3.1)
    rects = rects.reshape(4, 16, 5)
    frames = _frames(4)
    jit_core = jax.jit(jax.vmap(jax.vmap(
        lambda f, r: view_to_tensor_core(f, r, 224, 224, 0.0, 1.0, "NHWC")[0], in_axes=(None, 0))))
    want = np.array(jit_core(jnp.asarray(frames), jnp.asarray(rects)))
    mirror = (False, True) * 8
    got = view_to_tensor_reference(
        torch.from_numpy(frames), torch.from_numpy(rects), 224, 224, 0.0, 1.0, "NHWC", mirror
    ).numpy()
    want[:, 1::2] = want[:, 1::2, :, ::-1]
    th = rects[..., 4]
    trig = ((torch.cos(torch.from_numpy(th)).numpy() == np.asarray(jnp.cos(th)))
            & (torch.sin(torch.from_numpy(th)).numpy() == np.asarray(jnp.sin(th))))
    assert trig[0, 0] and trig.sum() >= 48, trig.sum()
    np.testing.assert_array_equal(got[trig], want[trig])
    planar = view_to_tensor_reference(
        torch.from_numpy(frames), torch.from_numpy(rects), 224, 224, 0.0, 1.0, "NCHW", mirror)
    assert planar.shape == (4, 16, 3, 224, 224) and planar.is_contiguous()
    assert torch.equal(planar, torch.from_numpy(got).movedim(-1, -3))
    assert (got == 0.0).all(-1).any()


def _fit(H, W):
    fit, rrect = jops.full_frame_fit(jnp.zeros((H, W, 4), jnp.uint8), Resolution(128, 128))
    return np.asarray(rrect)


@pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280)])
def test_letterbox_bit_exact(hw):
    H, W = hw
    rng = np.random.default_rng(H)
    frames = rng.integers(0, 256, (2, H, W, 4), dtype=np.uint8)
    fit = _fit(H, W)
    # The full-frame fit (the detect path's rect), then views that are
    # offset, scaled and partly outside the frame.
    rects = np.stack([
        fit,
        fit,
        [W * 0.3, H * 0.6, W * 0.9, W * 0.9, 0.0],
        [W * 0.05, H * 0.1, 301.7, 287.3, 0.0],
    ]).astype(np.float32)
    jit_core = jax.jit(
        jax.vmap(lambda f, r: letterbox_sample_core(f, r, 128, 128, -1.0, 1.0))
    )
    for pair in (rects[:2], rects[2:]):
        got = letterbox_sample_reference(
            torch.from_numpy(frames), torch.from_numpy(pair), 128, 128, -1.0, 1.0
        ).numpy()
        want = np.asarray(jit_core(jnp.asarray(frames), jnp.asarray(pair)))
        np.testing.assert_array_equal(got, want)
    got = letterbox_sample_reference(
        torch.from_numpy(frames), torch.from_numpy(rects[:2]), 128, 128, -1.0, 1.0
    ).numpy()
    for b in range(2):
        pallas = letterbox_sample_pallas(
            jnp.asarray(frames[b]), fit[:4], 128, 128, -1.0, 1.0, interpret=True
        )
        np.testing.assert_array_equal(got[b], np.asarray(pallas)[0].transpose(1, 2, 0))


def test_letterbox_full_range_bit_exact():
    """The full-range detector's letterbox: 192×192, colour range [-1, 1],
    against compiled ``letterbox_sample_core`` and the Pallas kernel in
    interpret mode: the full-frame fits of 1080p and 720p frames, and rects
    whose widths put a column on a rounding boundary of ``j / 192`` (420 px:
    j = 56 and 152; 1000 px, which XLA computes as ``j * f32(1/192)``)."""
    rng = np.random.default_rng(192)
    frames = rng.integers(0, 256, (4, 720, 1280, 4), dtype=np.uint8)
    rects = np.stack([
        _fit(1080, 1920), _fit(720, 1280),
        [640.0, 360.0, 420.0, 420.0, 0.0], [500.0, 300.0, 1000.0, 708.0, 0.0],
    ]).astype(np.float32)
    jit_core = jax.jit(jax.vmap(lambda f, r: letterbox_sample_core(f, r, 192, 192, -1.0, 1.0)))
    want = np.asarray(jit_core(jnp.asarray(frames), jnp.asarray(rects)))
    got = letterbox_sample_reference(torch.from_numpy(frames), torch.from_numpy(rects), 192, 192, -1.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1.0).all(-1).any() and (want != -1.0).any()
    pallas = letterbox_sample_pallas(jnp.asarray(frames[1]), rects[1, :4], 192, 192, -1.0, 1.0, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(pallas)[0].transpose(1, 2, 0))


def test_cnn_takes_planar_views_as_it_took_nhwc():
    """``Cnn.apply_views_fast`` and ``apply_views_letterbox`` (the planar
    sampling the pipelines use) give the network outputs of the NHWC crops
    through ``apply_tensor_hwc`` bit for bit: the eye network on mirrored
    slots, Face Mesh on rotated views, BlazeFace on letterbox views."""
    from zaru_tpu_torch.face.detection import ShortRangeNetwork
    from zaru_tpu_torch.face.eye import EyeNetwork
    from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV1

    frames = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 288, 384, 4), dtype=np.uint8))
    rects = torch.tensor([[[190.0, 140.0, 150.0, 150.0, 0.3], [100.0, 80.0, 60.0, 60.0, -2.0]],
                          [[300.0, 200.0, 250.0, 250.0, 1.4], [20.0, 30.0, 90.0, 90.0, 0.0]]])
    eye = EyeNetwork(device="cpu").cnn()
    got = eye.apply_views_fast(frames, rects, prescale_m=256, mirror=(False, True))
    xs = eye.sample_views_fast(frames, rects, prescale_m=256)
    want = eye.apply_tensor_hwc(torch.stack([xs[:, 0], xs[:, 1].flip(-2)], 1).reshape(4, *xs.shape[2:]))
    lm = FaceMeshV1(device="cpu").cnn()
    got += lm.apply_views_fast(frames, rects)
    want += lm.apply_tensor_hwc(lm.sample_views_fast(frames, rects).reshape(4, 192, 192, 3))
    det = ShortRangeNetwork(device="cpu").cnn()
    fit = torch.from_numpy(np.stack([_fit(288, 384)] * 2))
    got += det.apply_views_letterbox(frames, fit)
    want += det.apply_tensor_hwc(det.sample_views_letterbox(frames, fit))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cnn_apply_on_view_is_the_exact_sampler_then_the_network():
    """``Cnn.sample_view_hwc`` is JAX's (Face Mesh V2's 256² crops, bit for
    bit), and ``Cnn.apply_on_view`` (the exact sampler straight into the
    planar layout) gives the network outputs of those NHWC crops through
    ``apply_tensor_hwc`` bit for bit: Face Mesh V2 on ``[B,S]`` slots, the
    eye network with its second slots mirrored."""
    from zaru_tpu.face.landmark.mediapipe import FaceMeshV2 as JMesh
    from zaru_tpu_torch.face.eye import EyeNetwork
    from zaru_tpu_torch.face.landmark.mediapipe import FaceMeshV2

    frames = np.random.default_rng(8).integers(0, 256, (2, 288, 384, 4), dtype=np.uint8)
    rects = np.asarray([[[190.0, 140.0, 150.0, 150.0, 0.3], [100.0, 80.0, 60.0, 60.0, -2.0]],
                        [[300.0, 200.0, 250.0, 250.0, 1.4], [20.0, 30.0, 90.0, 90.0, 0.0]]], np.float32)
    jcnn = JMesh().cnn()
    want = np.asarray(jax.jit(jax.vmap(jax.vmap(jcnn.sample_view_hwc, in_axes=(None, 0))))(
        jnp.asarray(frames), jnp.asarray(rects)))
    mesh = FaceMeshV2(device="cpu").cnn()
    tf, tr = torch.from_numpy(frames), torch.from_numpy(rects)
    xs = mesh.sample_view_hwc(tf, tr)
    assert xs.shape == (2, 2, 256, 256, 3)
    np.testing.assert_array_equal(xs.numpy(), want)
    got, ref = mesh.apply_on_view(tf, tr), mesh.apply_tensor_hwc(xs.reshape(4, 256, 256, 3))
    eye = EyeNetwork(device="cpu").cnn()
    got += eye.apply_on_view(tf, tr, mirror=(False, True))
    es = eye.sample_view_hwc(tf, tr)
    ref += eye.apply_tensor_hwc(torch.stack([es[:, 0], es[:, 1].flip(-2)], 1).reshape(4, 64, 64, 3))
    assert len(got) == len(ref) == 5
    for g, w in zip(got, ref):
        assert torch.equal(g, w)


def test_rotated_sampler_body_grid_matches_jax():
    """The body crops of BodyTracker: 256×256 square views of 150-900 px on
    the 256-pixel grid (strides 1 to 4) at any angle, one partly outside the
    frame, against JAX's ``rotated_sample_fast(..., prescale_m=256,
    band_p=256, col_split=1, square_views=True)`` bit for bit, through the
    run stored in ``body_track.npz`` (its [0, 1] colour map stored as the u8
    channels it maps; tests/test_torch_body.py checks that the stored run
    is current and round-trips exactly)."""
    from test_torch_body import FIXTURE, unmap_u8

    with np.load(FIXTURE) as f:
        rects, want = f["views_rects"], unmap_u8(f["views_u8"])
    frames = torch.from_numpy(_frames(rects.shape[0]))
    got = rotated_sample_fast(frames, torch.from_numpy(rects), 256, 256, 0.0, 1.0, prescale_m=256)
    assert got.shape == (4, 2, 256, 256, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0.0).all(-1).any() and (want != 0.0).any()  # a view reads outside the frame
    planar = rotated_sample_fast(frames, torch.from_numpy(rects), 256, 256, 0.0, 1.0, prescale_m=256,
                                 layout="NCHW")
    assert torch.equal(planar, got.movedim(-1, -3))


def test_letterbox_body_detector_bit_exact():
    """The pose detector's letterbox: 224×224, colour range [-1, 1], against
    compiled ``letterbox_sample_core`` and the Pallas kernel in interpret
    mode: the full-frame fits of 1080p and 720p frames, and rects whose
    widths put columns on rounding boundaries of ``j / 224`` (420 px:
    j·1.875 is a half for every j ≡ 4 mod 8; 1000 px)."""
    rng = np.random.default_rng(224)
    frames = rng.integers(0, 256, (4, 720, 1280, 4), dtype=np.uint8)
    fit = lambda H, W: np.asarray(  # noqa: E731
        jops.full_frame_fit(jnp.zeros((H, W, 4), jnp.uint8), Resolution(224, 224))[1])
    rects = np.stack([
        fit(1080, 1920), fit(720, 1280),
        [640.0, 360.0, 420.0, 420.0, 0.0], [500.0, 300.0, 1000.0, 708.0, 0.0],
    ]).astype(np.float32)
    jit_core = jax.jit(jax.vmap(lambda f, r: letterbox_sample_core(f, r, 224, 224, -1.0, 1.0)))
    want = np.asarray(jit_core(jnp.asarray(frames), jnp.asarray(rects)))
    got = letterbox_sample_reference(torch.from_numpy(frames), torch.from_numpy(rects), 224, 224, -1.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1.0).all(-1).any() and (want != -1.0).any()
    pallas = letterbox_sample_pallas(jnp.asarray(frames[1]), rects[1, :4], 224, 224, -1.0, 1.0, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(pallas)[0].transpose(1, 2, 0))


def test_sample_view_matches_jax():
    """``sample_view`` (a view materialised at its own size) and
    ``sample_view_rgba`` (scaled to an output size) against JAX's, compiled,
    bit for bit, on upright, tilted and out-of-frame views; and the port's
    ``ImageView.to_image``/``get`` against JAX's on the same view."""
    from zaru_tpu.geometry import Rect as JRect, RotatedRect as JRR
    from zaru_tpu.image import Image as JImage
    from zaru_tpu.ops.sampling import sample_view as jsv, sample_view_rgba as jsvr
    from zaru_tpu_torch.image import Image
    from zaru_tpu_torch.ops.sampling import sample_view, sample_view_rgba
    from zaru_tpu_torch.rect import Rect, RotatedRect

    img = np.random.default_rng(6).integers(0, 256, (90, 120, 4), dtype=np.uint8)
    rects = [(60.0, 45.0, 33.0, 21.0, 0.0), (50.0, 40.0, 40.0, 30.0, 0.35), (10.0, 80.0, 31.0, 27.0, -2.3),
             (100.0, 20.0, 45.0, 45.0, 1.1)]
    for r in rects:
        rr = np.asarray(r, np.float32)
        w, h = int(np.ceil(r[2])), int(np.ceil(r[3]))
        want = np.asarray(jax.jit(jsv, static_argnums=(2, 3))(jnp.asarray(img), jnp.asarray(rr), w, h))
        got = sample_view(torch.from_numpy(img), torch.from_numpy(rr), w, h).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(r))
        want = np.asarray(jax.jit(jsvr, static_argnums=(2, 3))(jnp.asarray(img), jnp.asarray(rr), 24, 16))
        got = sample_view_rgba(torch.from_numpy(img), torch.from_numpy(rr), 24, 16).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(r))
    sub = (JRect.from_top_left(7.0, 5.0, 40.0, 30.0), Rect.from_top_left(7.0, 5.0, 40.0, 30.0))
    jview = JImage(img).view(JRR.new(JRect.from_center(60.0, 45.0, 80.0, 60.0), 0.4)).view(sub[0])
    view = Image(img, "cpu").view(RotatedRect.new(Rect.from_center(60.0, 45.0, 80.0, 60.0), 0.4)).view(sub[1])
    np.testing.assert_array_equal(view.view_rect.array, jview.view_rect.array)
    np.testing.assert_array_equal(view.to_image().to_numpy(), jview.to_image().to_numpy())
    for x, y in ((3, 4), (30, 20), (0, 0)):
        got, want = view.get(x, y), jview.get(x, y)
        assert (got.r, got.g, got.b, got.a) == (want.r, want.g, want.b, want.a), (x, y)
