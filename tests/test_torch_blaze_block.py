"""The port's fused BlazeBlock with a pooled or channel-padded residual
(zaru_tpu_torch.ops.blaze_block), on the CPU. The plan that finds the
blocks is tested with the other plans in test_torch_fusion.py.

- Face Mesh V1's two last blocks share one MaxPool, which runs only where
  something else reads it.
- Packing round-trips; the launch's tiling fits the shared memory; the
  CUDA wrapper raises on what the kernel does not take and falls back to
  nothing; on the CPU the op is the plain block.
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
from zaru_tpu_torch.onnx import executor as ex  # noqa: E402
from zaru_tpu_torch.onnx import load_model  # noqa: E402
from zaru_tpu_torch.onnx.proto import ValueInfo, parse_model  # noqa: E402
from zaru_tpu_torch.onnx.analysis import _mapping, analyze  # noqa: E402
from zaru_tpu_torch.onnx.executor import _OPS  # noqa: E402
from zaru_tpu_torch.ops import blaze_block as bb  # noqa: E402

SHORT = "face_detection_short_range.onnx"
V1 = "face_landmark.onnx"
# (C_in, C_out, stride, H of the input, ReLU) per block, in graph order, and
# the network's input side.
BLOCKS = {
    SHORT: (128, [(24, 28, 1, 64, True), (28, 32, 2, 64, True), (32, 36, 1, 32, True), (36, 42, 1, 32, True),
                  (42, 48, 2, 32, True), (48, 56, 1, 16, True), (56, 64, 1, 16, True), (64, 72, 1, 16, True),
                  (72, 80, 1, 16, True), (80, 88, 1, 16, True), (88, 96, 2, 16, True)]),
    V1: (192, [(16, 32, 2, 96, False), (32, 64, 2, 48, False), (64, 128, 2, 24, False), (128, 128, 2, 12, False),
               (128, 128, 2, 6, False), (128, 128, 2, 6, False)]),
}
PADS = {1: (1, 1, 1, 1), 2: (0, 0, 1, 1)}


@pytest.fixture(scope="module")
def nets():
    return {name: load_model(model_path(name).read_bytes(), torch.device("cpu")) for name in BLOCKS}


def _input(res, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32))


def _block(rng, c_in, c_out, relu=False):
    f = lambda *shape, s=0.3: rng.normal(0, s, shape).astype(np.float32)  # noqa: E731
    return {"dw_w": f(c_in, 1, 3, 3), "dw_b": f(c_in, s=0.1), "pw_w": f(c_out, c_in, 1, 1), "pw_b": f(c_out, s=0.1),
            "alpha": None if relu else rng.uniform(0.05, 0.3, c_out).astype(np.float32)}


def test_a_shared_max_pool_runs_only_when_read_outside(nets):
    """Face Mesh V1's two last blocks share one MaxPool: it is among both
    blocks' nodes and is not run, as nothing else reads it; where something
    else reads it, it runs, and the blocks are still planned."""
    net = nets[V1]
    last = net.blaze_blocks[-2:]
    assert last[0].input == last[1].input
    (pool,) = [i for i, n in enumerate(net.nodes) if n.op_type == "MaxPool" and n.inputs[0] == last[0].input]
    assert all(pool in b.nodes for b in last) and pool in net._in_plan
    env = net.activations(_input(192, 1))
    assert net.nodes[pool].outputs[0] not in env
    model = parse_model(model_path(V1).read_bytes())
    model.graph.outputs.append(ValueInfo(net.nodes[pool].outputs[0], [1, 128, 3, 3], 1))
    opened = ex.OnnxModule(model, torch.device("cpu"))
    assert len(opened.blaze_blocks) == 6 and all(pool not in b.nodes for b in opened.blaze_blocks[-2:])
    assert pool not in opened._in_plan
    x = _input(192, 2, seed=5)
    with torch.no_grad():
        fused = opened(x)
        with opened.without_plans():
            plain = opened(x)
    for a, b in zip(fused, plain, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c_in,c_out,relu", [(24, 28, True), (42, 48, False), (128, 128, False), (5, 13, True)])
def test_pack_round_trips(c_in, c_out, relu):
    block = _block(np.random.default_rng(c_in), c_in, c_out, relu)
    packed = bb.pack_blaze_block(block, c_in, c_out)
    assert packed.shape == (bb.row_floats(c_in, c_out),) and packed.shape[0] % 4 == 0
    got = bb.unpack_blaze_block(packed, c_in, c_out, relu)
    for k, v in block.items():
        if v is None:
            assert got[k] is None
        else:
            assert torch.equal(got[k].reshape(-1), torch.from_numpy(v).reshape(-1)), k
            assert got[k].is_contiguous()
    assert torch.equal(bb.pack_blaze_block(got, c_in, c_out), packed)
    lay = bb.layout(c_in, c_out)
    assert lay["cp"] % 8 == 0 and lay["cp"] >= c_out and all(lay[k] % 4 == 0 for k in ("bpw", "alpha", "taps"))


@pytest.mark.parametrize("c_in,c_out,B,H,W,stride,pads,relu", [
    (24, 28, 3, 11, 7, 1, (1, 1, 1, 1), True), (28, 32, 2, 9, 6, 2, (0, 0, 1, 1), True),
    (16, 16, 2, 5, 5, 2, (1, 0, 0, 1), False), (8, 13, 1, 4, 4, 1, (1, 1, 1, 1), False),
])
def test_fused_blaze_block_on_the_cpu_is_the_plain_block(c_in, c_out, B, H, W, stride, pads, relu):
    rng = np.random.default_rng(7)
    block = _block(rng, c_in, c_out, relu)
    x = torch.from_numpy(rng.normal(0, 1, (B, c_in, H, W)).astype(np.float32))
    got = bb.fused_blaze_block(x, bb.pack_blaze_block(block, c_in, c_out), c_out, stride, pads, relu)
    want = bb.blaze_block_reference(x, block, stride, pads, relu)
    assert got.shape == (B, c_out, (H + pads[0] + pads[2] - 3) // stride + 1, (W + pads[1] + pads[3] - 3) // stride + 1)
    assert torch.equal(got, want)


def _band_floats(c_in, H, W, stride, pads, th, images):
    """The floats csrc/blaze_block.cu lays out for each of a launch's bands,
    from its own geometry: the input rows the band reads (clipped to the
    image), at their places in the band's rows, and the depthwise outputs."""
    pt = pads[0]
    ho, wo = bb.out_size(H, stride, pads[0], pads[2]), bb.out_size(W, stride, pads[1], pads[3])
    rows = H if th >= ho else (th - 1) * stride + 3
    for oy0 in range(0, ho, th):
        n = min(th, ho - oy0)
        rbase = 0 if th >= ho else oy0 * stride - pt
        need = [oy * stride - pt + k for oy in range(oy0, oy0 + n) for k in range(3)]
        need += [oy * stride + k for oy in range(oy0, oy0 + n) for k in range(2)] if stride == 2 else []
        inside = [r - rbase for r in need if 0 <= r < H]
        assert 0 <= min(inside) and max(inside) < rows
        yield (oy0, oy0 + n), images * c_in * (rows * W + n * wo)


@pytest.mark.parametrize("B", [1, 512])
@pytest.mark.parametrize("c_in,c_out,stride,H,relu", sorted({b for _, blocks in BLOCKS.values() for b in blocks}))
def test_tiling_covers_and_fits(c_in, c_out, stride, H, relu, B):
    """Each block's bands cover the output rows once, every row a band
    reads lies in its rows, and its buffers fit the shared memory the launch
    asks for, which fits the card."""
    th, images = bb.tiling(c_in, c_out, H, H, stride, B)
    ho = bb.out_size(H, stride, PADS[stride][0], PADS[stride][2])
    assert images == 1 or th == ho
    smem = bb._smem_bytes(c_in, c_out, H, H, stride, th, images)
    assert smem <= bb.SMEM_LIMIT
    covered = np.zeros(ho, int)
    for (y0, y1), floats in _band_floats(c_in, H, H, stride, PADS[stride], th, images):
        covered[y0:y1] += 1
        assert 4 * (bb.row_floats(c_in, c_out) + floats) <= smem
    assert (covered == 1).all()


def test_cuda_launch_refuses_and_never_falls_back(monkeypatch):
    """The launch raises on a 5×5 depthwise, C_out < C_in, a stride-1 block
    of one width, non-f32 input, a channels_last input or pads it does not
    take, and a failure to build or load the kernel reaches the caller: no
    plain version runs in its place."""
    rng = np.random.default_rng(0)
    five = _block(rng, 8, 16)
    five["dw_w"] = rng.normal(0, 1, (8, 1, 5, 5)).astype(np.float32)
    with pytest.raises(ValueError, match="3x3 depthwise"):
        bb.pack_blaze_block(five, 8, 16)
    packed = bb.pack_blaze_block(_block(rng, 8, 16), 8, 16)
    with pytest.raises(ValueError, match="packed must be"):
        bb._launch(torch.zeros(1, 8, 8, 8), torch.zeros(packed.shape[0] + 16 * 8), 16, 1, (1, 1, 1, 1), True)
    with pytest.raises(ValueError, match="C_out > C_in"):
        bb._launch(torch.zeros(1, 16, 8, 8), packed, 8, 2, (0, 0, 1, 1), True)
    with pytest.raises(ValueError, match="C_out > C_in"):
        bb._launch(torch.zeros(1, 8, 8, 8), bb.pack_blaze_block(_block(rng, 8, 8), 8, 8), 8, 1, (1, 1, 1, 1), True)
    with pytest.raises(ValueError, match="float32"):
        bb._launch(torch.zeros(1, 8, 8, 8, dtype=torch.float64), packed, 16, 1, (1, 1, 1, 1), True)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        bb._launch(torch.zeros(1, 8, 8, 8).to(memory_format=torch.channels_last), packed, 16, 1, (1, 1, 1, 1), True)
    with pytest.raises(ValueError, match="pads"):
        bb._launch(torch.zeros(1, 8, 8, 8), packed, 16, 2, (1, 1, 1, 1), True)

    def no_kernel(name):
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(bb, "library", no_kernel)
    with pytest.raises(RuntimeError, match="no nvcc"):
        bb._launch(torch.zeros(1, 8, 8, 8), packed, 16, 1, (1, 1, 1, 1), True)
    with pytest.raises(ValueError, match="unsupported device"):
        bb.fused_blaze_block(torch.zeros(1, 8, 8, 8, device="meta"), packed.to("meta"), 16, 1, (1, 1, 1, 1), True)


def _flops(fn):
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping=_mapping())
    with torch.no_grad(), counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name,k", [(SHORT, k) for k in range(11)] + [(V1, k) for k in range(6)])
def test_flop_formula_counts_the_nodes(name, k, nets):
    """The op's formula on each block equals the count of the block's nodes
    run one by one, as ``analyze`` counts them; so does the whole network's
    count with and without the plan."""
    net = nets[name]
    blk = net.blaze_blocks[k]
    x = net.activations(_input(BLOCKS[name][0], 1))[blk.input]
    packed = net._packed[blk.at]
    params = net.params()
    pools = {j for j, n in enumerate(net.nodes) if n.op_type == "MaxPool" and n.inputs[0] == blk.input}

    def nodes():
        vals = dict(params)
        vals[blk.input] = x
        for i in sorted(set(blk.nodes) | pools):
            node = net.nodes[i]
            vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[n] for n in node.inputs])

    want = _flops(nodes)
    assert _flops(lambda: bb.blaze_block_op(x, packed, blk.c_out, blk.stride, list(blk.pads), blk.relu)) == want
    assert want == bb.blaze_block_flops(tuple(x.shape), tuple(packed.shape), blk.c_out, blk.stride, blk.pads,
                                        blk.relu)
    if k == 0:
        with_plan = analyze(net).flops
        with net.without_plans("blaze_blocks"):
            assert analyze(net).flops == with_plan == {SHORT: 63533952, V1: 72995005}[name]
