"""The port's RGB ↔ YUV (zaru_tpu_torch.ops.yuv) against zaru_tpu's, on the CPU.

- ``rgb_to_yuv`` / ``yuv_to_rgb`` are ``x @ M.T`` in both packages; XLA and
  torch sum the three products in their own ways, so they are held to
  ``YUV_TOL`` (one f32 ulp at 1.0, 1.19e-7 measured).
- ``rgb_to_yuv_fast`` on a CPU tensor runs the kernel's plain version,
  ``(m0*r + m1*g) + m2*b`` with each product and sum rounded on its own (the
  order of the Pallas kernel body, pallas_kernels.py:166-171). Against
  ``rgb_to_yuv_pallas(interpret=True, block_rows=32)`` it is not bit-exact:
  in interpret mode XLA:CPU compiles the body into ``fma(m2, b, fma(m0, r,
  m1*g))``, two fused multiply-adds, which round fewer times; 17% of the
  values differ, by at most 1.19e-7 (one ulp at 1.0). The test shows that
  the contraction is the whole difference: that FMA form, rounded exactly
  (``num.fma``), gives the Pallas output bit for bit. The CUDA kernel keeps
  the source order and is bit-equal to the plain version on the card
  (chip_smoke.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zaru_tpu.ops.pallas_kernels import rgb_to_yuv as j_rgb_to_yuv
from zaru_tpu.ops.pallas_kernels import rgb_to_yuv_pallas
from zaru_tpu.ops.pallas_kernels import yuv_to_rgb as j_yuv_to_rgb
from zaru_tpu_torch.num import fma
from zaru_tpu_torch.ops.yuv import (
    YUV_FROM_RGB,
    rgb_to_yuv,
    rgb_to_yuv_fast,
    rgb_to_yuv_launch,
    yuv_to_rgb,
)
from torch_port import one_torch_thread  # noqa: F401

YUV_TOL = 2.0 ** -23  # 1.19e-7 measured, in both comparisons below
# JAX's own 130x64 (ragged against 32-row blocks) and an odd size.
SHAPES = [(130, 64), (37, 53)]


def _rgb(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape + (3,)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape):
    rgb = _rgb(shape, 1)
    yuv = rgb_to_yuv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(yuv, np.asarray(j_rgb_to_yuv(jnp.asarray(rgb))), rtol=0, atol=YUV_TOL)
    back = yuv_to_rgb(torch.from_numpy(yuv)).numpy()
    np.testing.assert_allclose(back, np.asarray(j_yuv_to_rgb(jnp.asarray(yuv))), rtol=0, atol=YUV_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_plain_version_matches_pallas(shape):
    rgb = _rgb(shape, 2)
    want = np.asarray(rgb_to_yuv_pallas(jnp.asarray(rgb), interpret=True, block_rows=32))
    got = rgb_to_yuv_fast(torch.from_numpy(rgb))
    assert got.shape == want.shape == shape + (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=YUV_TOL)
    # The plain version against the kernel's source order and the FMA form.
    t = torch.from_numpy(rgb)
    r, g, b = t.unbind(-1)
    m = torch.from_numpy(YUV_FROM_RGB)
    source = torch.stack([(m[i, 0] * r + m[i, 1] * g) + m[i, 2] * b for i in range(3)], -1)
    np.testing.assert_array_equal(got.numpy(), source.numpy())
    full = lambda c: m[c // 3, c % 3].expand_as(r)  # noqa: E731
    contracted = torch.stack(
        [fma(full(3 * i + 2), b, fma(full(3 * i), r, m[i, 1] * g)) for i in range(3)], -1
    )
    np.testing.assert_array_equal(contracted.numpy(), want)
    assert (got.numpy() != want).any()


def test_roundtrip_and_gray():
    """As tests/test_pallas_kernels.py:50-62: the round trip, and gray gives
    Y = 0.5 and U = V = 0, through the plain functions and the kernel's plain
    version."""
    rgb = _rgb((16, 24), 1)
    back = yuv_to_rgb(rgb_to_yuv(torch.from_numpy(rgb))).numpy()
    np.testing.assert_allclose(back, rgb, atol=1e-5)
    back = yuv_to_rgb(rgb_to_yuv_fast(torch.from_numpy(rgb))).numpy()
    np.testing.assert_allclose(back, rgb, atol=1e-5)
    gray = torch.full((4, 4, 3), 0.5)
    for yuv in (rgb_to_yuv(gray), rgb_to_yuv_fast(gray)):
        np.testing.assert_allclose(yuv[..., 0].numpy(), 0.5, atol=1e-6)
        np.testing.assert_allclose(yuv[..., 1:].numpy(), 0.0, atol=1e-6)


def test_wrapper_refuses_bad_input():
    with pytest.raises(ValueError, match=r"\[H,W,3\] float32"):
        rgb_to_yuv_fast(torch.zeros((4, 4, 4)))
    with pytest.raises(ValueError, match=r"\[H,W,3\] float32"):
        rgb_to_yuv_fast(torch.zeros((4, 4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        rgb_to_yuv_launch(torch.zeros((4, 4, 3)))
