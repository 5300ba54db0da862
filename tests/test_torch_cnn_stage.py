"""The port's fused BlazeBlock stage (zaru_tpu_torch.ops.cnn_stage), against
zaru_tpu on the CPU.

- ``fused_blocks`` on a CPU tensor (its plain version) and
  ``blaze_blocks_reference`` against JAX ``fused_blocks(interpret=True)``
  and ``blaze_blocks_reference`` at the three cases of
  tests/test_cnn_stage.py and a ReLU case (α = 0), ``rtol = atol = 1e-4``
  (tests/test_cnn_stage.py:42).
- Every chain's channel count is one the CUDA kernel is built for, and its
  tiling covers the image with regions whose shared memory, counted from
  the kernel's layout, is what the launch asks for and fits the card.
- The chains are those the executor finds in the two face models (its
  plans are tested in test_torch_fusion.py; the models' outputs against
  JAX, stage plan included, in tests/test_torch_onnx.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zaru_tpu.ops.cnn_stage import blaze_blocks_reference as jax_reference
from zaru_tpu.ops.cnn_stage import fused_blocks as jax_fused
from zaru_tpu.ops.cnn_stage import pack_blocks as jax_pack
from zaru_tpu_torch.ops.cnn_stage import (
    KERNEL_CHANNELS, PIXELS_PER_THREAD, SMEM_LIMIT, THREADS, _tiling, blaze_blocks_reference, fused_blocks, pack_blocks,
    unpack_blocks,
)
from torch_port import one_torch_thread  # noqa: F401

# (blocks, channels, H×W, ReLU) per chain, in graph order.
STAGES = {
    "face_landmark.onnx": (192, [
        (2, 16, (96, 96), False), (2, 32, (48, 48), False), (2, 64, (24, 24), False),
        (2, 128, (12, 12), False), (2, 128, (6, 6), False), (1, 32, (3, 3), False),
        (2, 128, (3, 3), False), (1, 32, (3, 3), False),
    ]),
    "face_detection_short_range.onnx": (128, [(1, 24, (64, 64), True), (4, 96, (8, 8), True)]),
    "iris_landmark.onnx": (64, []),
}

CHAINS = [(name, nb, C, H, W) for name, (_res, chains) in STAGES.items() for nb, C, (H, W), _ in chains]


def make_blocks(rng, C, nb, relu=False):
    """tests/test_cnn_stage.py's blocks; ``relu`` makes every slope 0."""
    return [
        {
            "dw_w": rng.normal(0, 0.3, (C, 1, 3, 3)).astype(np.float32),
            "dw_b": rng.normal(0, 0.1, (C,)).astype(np.float32),
            "pw_w": rng.normal(0, 0.3, (C, C, 1, 1)).astype(np.float32),
            "pw_b": rng.normal(0, 0.1, (C,)).astype(np.float32),
            "alpha": (np.zeros(C, np.float32) if relu
                      else rng.uniform(0.05, 0.3, (C,)).astype(np.float32)),
        }
        for _ in range(nb)
    ]


@pytest.mark.parametrize("C,H,W,B,nb,relu", [
    (32, 24, 24, 8, 3, False),
    (16, 12, 20, 8, 2, False),
    (128, 6, 6, 2, 2, False),
    (24, 12, 20, 5, 2, True),   # α = 0, BlazeFace's ReLU blocks (G = 5)
])
def test_fused_blocks_matches_jax(C, H, W, B, nb, relu):
    rng = np.random.default_rng(11)
    blocks = make_blocks(rng, C, nb, relu)
    x = rng.normal(0, 1, (B, C, H, W)).astype(np.float32)
    want_ref = np.asarray(jax_reference(jnp.asarray(x), blocks))
    G = max(1, 128 // C)
    want_kernel = np.asarray(jax_fused(jnp.asarray(x), jax_pack(blocks, C, G), H, W, C,
                                       interpret=True, group=G))
    packed = pack_blocks(blocks, C)
    assert packed.shape == (nb, C * C + 12 * C)
    got = fused_blocks(torch.from_numpy(x), packed, H, W, C).numpy()
    got_ref = blaze_blocks_reference(torch.from_numpy(x), blocks).numpy()
    for g in (got, got_ref):
        np.testing.assert_allclose(g, want_kernel, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g, want_ref, rtol=1e-4, atol=1e-4)
    # α = 0 comes back from the packed layout as a ReLU; the same numbers.
    assert all((b["alpha"] is None) == relu for b in unpack_blocks(packed, C))
    np.testing.assert_array_equal(got, got_ref)


def test_fused_blocks_refuses_bad_input():
    rng = np.random.default_rng(1)
    packed = pack_blocks(make_blocks(rng, 16, 2), 16)
    x = torch.zeros((2, 16, 6, 6))
    with pytest.raises(ValueError, match="x must be"):
        fused_blocks(x, packed, 6, 6, 8)
    with pytest.raises(ValueError, match="x must be"):
        fused_blocks(x.double(), packed, 6, 6, 16)
    with pytest.raises(ValueError, match="packed must be"):
        fused_blocks(x, packed[:, :-1], 6, 6, 16)


@pytest.mark.parametrize("name,nb,C,H,W", CHAINS)
def test_chain_fits_the_kernel(name, nb, C, H, W):
    """The chain's C is in KERNEL_CHANNELS; ``_tiling``'s tiles cover the
    image once; every region's shared memory, counted from
    csrc/blaze_stage.cu's layout, is within what the launch asks for, which
    fits SMEM_LIMIT; where the depthwise stays in registers, the threads hold
    every pixel of a region."""
    assert C in KERNEL_CHANNELS
    th, tw, smem = _tiling(C, H, W, nb)
    # The launch's path, from its unclipped region, as the kernel decides it.
    in_registers = C <= 24 and min(H, th + 2 * nb) * min(W, tw + 2 * nb) > THREADS // 2
    covered = np.zeros((H, W), int)
    most = 0
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            y1, x1 = min(H, y0 + th), min(W, x0 + tw)
            covered[y0:y1, x0:x1] += 1
            rh, rw = min(H, y1 + nb) - max(0, y0 - nb), min(W, x1 + nb) - max(0, x0 - nb)
            floats = (C * (rh + 1) * (rw + 1)                 # the activation, rows and channels led by zeros
                      + -(-(rw + 2) // 4) * 4                  # the zeros that close the last channel
                      + (0 if in_registers else C * rh * rw)   # the depthwise result
                      + C * C + 12 * C)                        # one block's packed parameters
            most = max(most, 4 * floats)
            if in_registers:
                assert rh * rw <= PIXELS_PER_THREAD[C] * THREADS
    assert (covered == 1).all()
    assert most <= smem <= SMEM_LIMIT
