"""The port's fused stride-2 residual bottleneck ("entry") block
(zaru_tpu_torch.ops.entry_block), on the CPU. The plan that finds the
blocks is tested with the other plans in test_torch_fusion.py.

- The plain version is the executor's nodes of each block of Face Mesh V2
  and the iris model, bit for bit; packing round-trips.
- The fake kernel gives the output's shape; ``torch.export`` captures the
  op; the FLOP formula counts what ``onnx/analysis.analyze`` counts for the
  nodes.
- The launch's tiling fits the shared memory and a warp's registers at
  every block shape, batch 1 and an odd batch included; the CUDA wrapper
  raises on what the kernel does not take and falls back to nothing.
- On a GPU (skipped here): the kernel within the CNN bar of its plain
  version at every block shape and at batches 512/1024, 1 and an odd batch.
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
from zaru_tpu_torch.ops import entry_block as eb  # noqa: E402

V2 = "face_landmarks_detector.onnx"
IRIS = "iris_landmark.onnx"
# (C_in, M, H of the input) per block, in graph order, the network's input
# side and the batch its cell runs it at (512 streams; two eyes a stream).
BLOCKS = {
    V2: (256, 512, [(16, 16, 128), (32, 32, 64), (64, 64, 32), (128, 64, 16), (128, 64, 8), (128, 64, 4)]),
    IRIS: (64, 1024, [(64, 64, 32), (128, 64, 16), (128, 64, 8), (128, 64, 4), (128, 64, 8), (128, 64, 4)]),
}
SHAPES = sorted({(c_in, m, h) for _, _, blocks in BLOCKS.values() for c_in, m, h in blocks})
CNN_ATOL, CNN_RTOL = 1e-3, 2e-3  # the repo's CNN bar (zaru_tpu_torch/onnx/dialect_cases.py "cnn")


@pytest.fixture(scope="module")
def nets():
    return {name: load_model(model_path(name).read_bytes(), torch.device("cpu")) for name in BLOCKS}


def _input(res, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (batch, 3, res, res)).astype(np.float32))


def _block(rng, c_in, m):
    f = lambda *shape, s=0.3: rng.normal(0, s, shape).astype(np.float32)  # noqa: E731
    return {"w1": f(m, c_in, 2, 2), "b1": f(m, s=0.1), "a1": rng.uniform(0.05, 0.3, m).astype(np.float32),
            "dw_w": f(m, 1, 3, 3), "dw_b": f(m, s=0.1), "w2": f(2 * m, m, 1, 1), "b2": f(2 * m, s=0.1),
            "a2": rng.uniform(0.05, 0.3, 2 * m).astype(np.float32)}


def _nodes(net, blk, x):
    """The block's nodes run one by one (its MaxPool and Pad too), from
    ``x``: the value the Add's PRelu gives."""
    vals = {**net._static, **net.params(), blk.input: x}
    for i in blk.nodes:
        node = net.nodes[i]
        vals[node.outputs[0]] = _OPS[node.op_type](node, [vals[n] for n in node.inputs])
    return vals[blk.output]


@pytest.mark.parametrize("name,k", [(name, k) for name in BLOCKS for k in range(6)])
def test_plain_version_is_the_nodes(name, k, nets):
    """On the block's own input (batch 2) and weights, the registered op on
    the CPU, the plain version on the unpacked row and the nodes agree bit
    for bit; the fake kernel's shape is the output's."""
    net = nets[name]
    blk = net.entry_blocks[k]
    assert (blk.c_in, blk.m, blk.c_out) == (*BLOCKS[name][2][k][:2], 2 * blk.m)
    x = net.activations(_input(BLOCKS[name][0], 2, seed=k))[blk.input]
    packed = net._packed[blk.at]
    want = _nodes(net, blk, x)
    got = eb.fused_entry_block(x, packed, blk.m)
    assert torch.equal(got, want)
    assert torch.equal(eb.entry_block_reference(x, eb.unpack_entry_block(packed, blk.c_in, blk.m)), want)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = eb.entry_block_op(torch.empty(x.shape), torch.empty(packed.shape), blk.m)
    assert fake.shape == want.shape == (2, blk.c_out, x.shape[2] // 2, x.shape[3] // 2)


@pytest.mark.parametrize("c_in,m", eb.KERNEL_WIDTHS)
def test_pack_round_trips(c_in, m):
    block = _block(np.random.default_rng(c_in), c_in, m)
    packed = eb.pack_entry_block(block, c_in, m)
    assert packed.shape == (eb.row_floats(c_in, m),) and packed.shape[0] % 4 == 0
    assert all(v % 4 == 0 for v in eb.layout(c_in, m).values())
    got = eb.unpack_entry_block(packed, c_in, m)
    for k, v in block.items():
        assert torch.equal(got[k].reshape(-1), torch.from_numpy(v).reshape(-1)), k
        assert got[k].is_contiguous()
    assert torch.equal(eb.pack_entry_block(got, c_in, m), packed)
    # The 2x2 weights input-major, k = 4·ci + 2·ky + kx, the outputs fastest.
    assert packed[(4 * 1 + 2 * 1 + 0) * m + 3] == block["w1"][3, 1, 1, 0]


def _flops(fn):
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping=_mapping())
    with torch.no_grad(), counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_flop_formula_counts_the_nodes(name, nets):
    """Each block: the op's formula equals the count of its nodes run one by
    one, as ``analyze`` counts them; so does the whole network's count with
    and without the plan."""
    net = nets[name]
    env = net.activations(_input(BLOCKS[name][0]))
    for blk in net.entry_blocks:
        x, packed = env[blk.input], net._packed[blk.at]
        want = _flops(lambda: _nodes(net, blk, x))
        assert _flops(lambda: eb.entry_block_op(x, packed, blk.m)) == want
        assert want == eb.entry_block_flops(tuple(x.shape), tuple(packed.shape), blk.m)
    with_plan = analyze(net).flops
    with net.without_plans("entry_blocks"):
        assert analyze(net).flops == with_plan == {V2: 236374173, IRIS: 109636324}[name]


def test_export_captures_the_op():
    """``torch.export`` keeps the block as the registered op, and the
    exported program runs it."""
    rng = np.random.default_rng(5)
    packed = eb.pack_entry_block(_block(rng, 16, 16), 16, 16)

    class Block(torch.nn.Module):
        def forward(self, x, p):
            return eb.entry_block_op(x, p, 16)

    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 8, 6)).astype(np.float32))
    program = torch.export.export(Block(), (x, packed))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets == ["zaru_tpu_torch.entry_block.default"]
    assert torch.equal(program.module()(x, packed), eb.entry_block_op(x, packed, 16))


@pytest.mark.parametrize("c_in,m,H", SHAPES)
def test_tiling_fits(c_in, m, H):
    """At batches 1, 3, 512 and 1024, each launch's tiling fits the card's
    shared memory and gives each warp's unit of the 2×2 convolution at most
    its groups of pixels; bands cover the output rows once."""
    for B in (1, 3, 512, 1024):
        th, images, cc = eb.tiling(c_in, m, H, H, B)
        assert eb._smem_bytes(c_in, m, H, H, th, images, cc) <= eb.SMEM_LIMIT
        assert eb._fits(c_in, m, H, H, th, images)
        assert c_in % cc == 0 and 1 <= images <= B and (images == 1 or th >= H // 2)
        covered = np.zeros(H // 2, int)
        for y0 in range(0, H // 2, th):
            covered[y0:y0 + th] += 1
        assert (covered == 1).all()


def test_cuda_launch_refuses_and_never_falls_back(monkeypatch):
    """The launch raises on widths it is not built for, odd sizes, non-f32
    or channels_last input and a wrong packed row, and a failure to build or
    load the kernel reaches the caller: no plain version runs in its place."""
    packed = eb.pack_entry_block(_block(np.random.default_rng(0), 16, 16), 16, 16)
    with pytest.raises(ValueError, match="w1 must be"):
        eb.pack_entry_block(_block(np.random.default_rng(0), 16, 8), 16, 16)
    with pytest.raises(ValueError, match=r"\(C_in, M\)"):
        eb._launch(torch.zeros(1, 24, 8, 8), packed, 16)
    with pytest.raises(ValueError, match="even H and W"):
        eb._launch(torch.zeros(1, 16, 7, 8), packed, 16)
    with pytest.raises(ValueError, match="float32"):
        eb._launch(torch.zeros(1, 16, 8, 8, dtype=torch.float64), packed, 16)
    with pytest.raises(ValueError, match="packed must be"):
        eb._launch(torch.zeros(1, 16, 8, 8), packed[:-4], 16)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        eb._launch(torch.zeros(1, 16, 8, 8).to(memory_format=torch.channels_last), packed, 16)

    def no_kernel(name):
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(eb, "library", no_kernel)
    eb._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no nvcc"):
            eb._launch(torch.zeros(1, 16, 8, 8), packed, 16)
    finally:
        eb._kernel.cache_clear()
    with pytest.raises(ValueError, match="unsupported device"):
        eb.fused_entry_block(torch.zeros(1, 16, 8, 8, device="meta"), packed.to("meta"), 16)


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is present (decided in the test,
    not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the entry block kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("name", list(BLOCKS))
def test_kernel_within_the_cnn_bar(name, cuda):
    """The kernel against its plain version (TF32 off) on random weights at
    each block's shape, at the cell's batch, 1 and an odd batch."""
    _, batch, blocks = BLOCKS[name]
    for c_in, m, H in blocks:
        gen = torch.Generator(device=cuda).manual_seed(c_in + H)
        block = {k: torch.from_numpy(v).to(cuda) for k, v in _block(np.random.default_rng(H), c_in, m).items()}
        packed = eb.pack_entry_block(block, c_in, m)
        for b in (batch, 1, 37):
            x = torch.rand(b, c_in, H, H, device=cuda, generator=gen) * 2 - 1
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                got = eb.fused_entry_block(x, packed, m)
                want = eb.entry_block_reference(x, block)
            atol = CNN_ATOL * max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            assert bool(((got - want).abs() <= atol + CNN_RTOL * want.abs()).all()), (c_in, H, b, err)
