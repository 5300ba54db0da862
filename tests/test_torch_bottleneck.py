"""The port's fused residual bottleneck blocks (zaru_tpu_torch.ops.bottleneck),
on the CPU. The plan that finds the chains is tested with the other plans
in test_torch_fusion.py.

- Packing round-trips; on the CPU the op is the plain chain; the kernel's
  launch plan covers each chain and image and fits the shared memory; the
  CUDA wrapper raises on what the kernel does not take and falls back to
  nothing.
- The registered op's FLOP formula counts what ``onnx/analysis.analyze``
  counts for the nodes.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

from zaru_tpu_torch.assets import model_path  # noqa: E402
from zaru_tpu_torch.onnx import load_model  # noqa: E402
from zaru_tpu_torch.onnx.analysis import _mapping, analyze  # noqa: E402
from zaru_tpu_torch.onnx.executor import _OPS  # noqa: E402
from zaru_tpu_torch.ops import bottleneck as bn  # noqa: E402

V2 = "face_landmarks_detector.onnx"
IRIS = "iris_landmark.onnx"
# (channels, blocks, H×W of the chain) per chain, in graph order, and the
# network's input side.
CHAINS = {
    V2: (256, [(16, 4, 128), (32, 4, 64), (64, 4, 32), (128, 4, 16), (128, 4, 8), (128, 4, 4), (128, 4, 2)]),
    IRIS: (64, [(64, 4, 32), (128, 4, 16), (128, 2, 8), (128, 2, 8), (128, 2, 4), (128, 2, 2), (128, 2, 4),
                (128, 2, 2)]),
}


@pytest.fixture(scope="module")
def nets():
    return {name: load_model(model_path(name).read_bytes(), torch.device("cpu")) for name in CHAINS}


def _input(res, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32))


def _blocks(rng, C, nb):
    M = C // 2
    f = lambda *shape, s=0.3: rng.normal(0, s, shape).astype(np.float32)  # noqa: E731
    return [{"w1": f(M, C, 1, 1), "b1": f(M, s=0.1), "a1": rng.uniform(0.05, 0.3, M).astype(np.float32),
             "dw_w": f(M, 1, 3, 3), "dw_b": f(M, s=0.1), "w2": f(C, M, 1, 1), "b2": f(C, s=0.1),
             "a2": rng.uniform(0.05, 0.3, C).astype(np.float32)} for _ in range(nb)]


@pytest.mark.parametrize("C,nb", [(16, 1), (32, 3), (128, 2)])
def test_pack_round_trips(C, nb):
    blocks = _blocks(np.random.default_rng(C), C, nb)
    packed = bn.pack_bottlenecks(blocks, C)
    assert packed.shape == (nb, C * C + 8 * C) and packed.is_contiguous()
    for got, want in zip(bn.unpack_bottlenecks(packed, C), blocks):
        for k, v in want.items():
            assert torch.equal(got[k].reshape(-1), torch.from_numpy(v).reshape(-1)), k
            assert got[k].is_contiguous()
    assert torch.equal(bn.pack_bottlenecks(bn.unpack_bottlenecks(packed, C), C), packed)


@pytest.mark.parametrize("C,B,H,W,nb", [(16, 3, 11, 7, 2), (64, 2, 5, 6, 3), (128, 5, 2, 2, 1)])
def test_fused_bottlenecks_on_the_cpu_is_the_plain_chain(C, B, H, W, nb):
    rng = np.random.default_rng(7)
    blocks = _blocks(rng, C, nb)
    x = torch.from_numpy(rng.normal(0, 1, (B, C, H, W)).astype(np.float32))
    got = bn.fused_bottlenecks(x, bn.pack_bottlenecks(blocks, C), H, W, C)
    assert torch.equal(got, bn.bottleneck_blocks_reference(x, blocks))


def _tile_buffers(C, H, W, th, tw, images, nb):
    """The floats csrc/bottleneck_stage.cu lays out for each of a launch's
    tiles, from its own geometry: x on the region, the padded intermediate,
    the depthwise result on the first block's output window."""
    M = C // 2
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            y1, x1 = min(H, y0 + th), min(W, x0 + tw)
            ry0, rx0, ry1, rx1 = max(0, y0 - nb), max(0, x0 - nb), min(H, y1 + nb), min(W, x1 + nb)
            rh, rw = ry1 - ry0, rx1 - rx0
            wh, ww = rh - (ry0 > 0) - (ry1 < H), rw - (rx0 > 0) - (rx1 < W)
            yield (y0, y1, x0, x1), images * (C * rh * rw + M * (rh + 2) * (rw + 2) + M * wh * ww)


@pytest.mark.parametrize("B", [1, 512, 1024])
@pytest.mark.parametrize("C,nb,H", sorted({c for _, chains in CHAINS.values() for c in chains}))
def test_launch_plan_covers_and_fits(C, nb, H, B):
    """The plan's launches run every block once; each launch's tiles cover
    the image once, and each tile's buffers, counted from the kernel's
    layout, fit the shared memory the launch asks for, which fits the card."""
    launches = bn.plan(C, H, H, B, nb)
    assert sum(n for n, *_ in launches) == nb
    for n, th, tw, images in launches:
        assert images == 1 or (th, tw) == (H, H)
        smem = bn._smem_bytes(C, H, H, th, tw, images, n)
        assert smem <= bn.SMEM_LIMIT
        covered = np.zeros((H, H), int)
        for (y0, y1, x0, x1), floats in _tile_buffers(C, H, H, th, tw, images, n):
            covered[y0:y1, x0:x1] += 1
            assert 4 * (n * bn.row_floats(C) + floats) <= smem
        assert (covered == 1).all()


def test_cuda_launch_refuses_and_never_falls_back(monkeypatch):
    """The launch raises on a width it is not built for, too many images or
    a non-contiguous input, and a failure to build or load the kernel
    reaches the caller: no plain version runs in its place."""
    packed = bn.pack_bottlenecks(_blocks(np.random.default_rng(0), 24, 1), 24)
    with pytest.raises(ValueError, match="C in"):
        bn._launch(torch.zeros(1, 24, 4, 4), packed)
    packed16 = bn.pack_bottlenecks(_blocks(np.random.default_rng(0), 16, 1), 16)
    with pytest.raises(ValueError, match="1..65535 images"):
        bn._launch(torch.zeros(65536, 16, 1, 1), packed16)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        bn._launch(torch.zeros(1, 16, 4, 4).transpose(2, 3), packed16)

    def no_kernel(name):
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(bn, "library", no_kernel)
    with pytest.raises(RuntimeError, match="no nvcc"):
        bn._launch(torch.zeros(1, 16, 4, 4), packed16)
    with pytest.raises(ValueError, match="unsupported device"):
        bn.fused_bottlenecks(torch.zeros(1, 16, 4, 4, device="meta"), packed16.to("meta"), 4, 4, 16)
    with pytest.raises(ValueError, match="packed must be"):
        bn.fused_bottlenecks(torch.zeros(1, 16, 4, 4), packed16[:, 1:], 4, 4, 16)


def _flops(fn):
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping=_mapping())
    with torch.no_grad(), counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("k", range(7))
def test_flop_formula_counts_the_nodes(k, nets):
    """The op's formula on Face Mesh V2's chain k equals the count of the
    chain's nodes run one by one, as ``analyze`` counts them; so does the
    whole network's count with and without the plan."""
    net = nets[V2]
    chain = net.bottlenecks[k]
    x = net.activations(_input(256, 1))[chain.input]
    packed = net._packed[chain.at]
    params = net.params()

    def nodes():
        vals = dict(params)
        vals[chain.input] = x
        for i in chain.nodes:
            node = net.nodes[i]
            vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[n] for n in node.inputs])

    want = _flops(nodes)
    assert _flops(lambda: bn.bottleneck_stage_op(x, packed)) == want
    assert want == bn.bottleneck_flops(tuple(x.shape), tuple(packed.shape))
    if k == 0:
        with_plan = analyze(net).flops
        with net.without_plans("bottlenecks"):
            assert analyze(net).flops == with_plan == 236374173
