"""The port's fused residual bottleneck blocks (zaru_tpu_torch.ops.bottleneck)
and the executor's bottleneck plan, on the CPU.

- The plan finds 28 blocks in 7 chains in Face Mesh V2, 20 in the iris
  model and none in the other bundled models; bf16 and NHWC modules build
  no plan.
- With the plan, Face Mesh V2's and the iris model's forwards equal the
  node-by-node run bit for bit (on the CPU a chain runs the executor's own
  per-op chain).
- Packing round-trips; ``load_params`` repacks; the kernel's launch plan
  covers each chain and image and fits the shared memory; the CUDA wrapper
  raises on what the kernel does not take and falls back to nothing.
- Each forward counts its blocks in ``profiling.counters`` and marks each
  chain with the span ``zaru.net.bottleneck``; the registered op's FLOP
  formula counts what ``onnx/analysis.analyze`` counts for the nodes.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

from zaru_tpu_torch import profiling  # noqa: E402
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
OTHERS = ["face_detection_full_range.onnx", "face_detection_short_range.onnx", "face_landmark.onnx",
          "hand_landmark_lite.onnx", "landmarks_68_pfld.onnx", "mobilefacenet.onnx", "palm_detection_lite.onnx",
          "slim_160_latest.onnx"]


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


def test_assets_are_the_listed_models():
    assert sorted(os.listdir(model_path(V2).parent)) == sorted([V2, IRIS, *OTHERS])


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_plan_finds_the_chains(name, nets):
    """Chains of the listed widths, lengths and sizes; each chain's six
    nodes a block, its output the shape of its input."""
    net = nets[name]
    res, want = CHAINS[name]
    env = net.activations(_input(res, 1))
    got = [(bn.channels, len(bn.blocks), env[bn.input].shape[2]) for bn in net.bottlenecks]
    assert got == want
    assert sum(len(b.blocks) for b in net.bottlenecks) == {V2: 28, IRIS: 20}[name]
    for chain in net.bottlenecks:
        assert env[chain.output].shape == env[chain.input].shape
        assert len(chain.nodes) == 6 * len(chain.blocks)
        assert [net.nodes[i].op_type for i in chain.nodes[:6]] == ["Conv", "PRelu", "Conv", "Conv", "Add", "PRelu"]


@pytest.mark.parametrize("name", OTHERS)
def test_plan_finds_nothing_elsewhere(name):
    """Full-range BlazeFace's bottleneck-like blocks (ReLU, no such
    residual) and every other bundled model run node by node."""
    assert load_model(model_path(name).read_bytes(), torch.device("cpu")).bottlenecks == []


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_plan_equals_node_by_node(name, nets):
    """Batch 2: every output of the forward with the plan equals the
    node-by-node run (``stages=False``) bit for bit."""
    net = nets[name]
    x = _input(CHAINS[name][0], 2, seed=3)
    with torch.no_grad():
        fused, plain = net(x), net(x, stages=False)
    assert len(fused) == len(plain)
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{"compute_dtype": torch.bfloat16}, {"layout": "NHWC"}])
def test_bf16_and_nhwc_modules_build_no_plan(kw):
    net = load_model(model_path(V2).read_bytes(), torch.device("cpu"), **kw)
    assert net.bottlenecks == [] and net._bottleneck_packed == {}


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


def test_load_params_repacks(nets):
    """New weights loaded after construction are the ones the chains run
    with: the chain's output changes and equals the plain chain on them."""
    net = load_model(model_path(V2).read_bytes(), torch.device("cpu"))
    chain = net.bottlenecks[2]
    x = _input(256, 1, seed=4)
    before = net.activations(x)
    params = {k: v.clone() for k, v in net.params().items()}
    for b in chain.blocks:
        params[b["w2"]] *= 1.5
        params[b["a2"]] += 0.1
    net.load_params(params)
    after = net.activations(x)
    assert not torch.equal(after[chain.output], before[chain.output])
    blocks = [{k: params[v] for k, v in b.items()} for b in chain.blocks]
    assert torch.equal(after[chain.output], bn.bottleneck_blocks_reference(after[chain.input], blocks))


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


def test_forwards_count_their_blocks(nets):
    """28 blocks a Face Mesh V2 forward, none a Face Mesh V1 forward, none
    a forward run node by node."""
    v1 = load_model(model_path("face_landmark.onnx").read_bytes(), torch.device("cpu"))
    c = profiling.counters

    def ran(fn):
        before = c["bottleneck_blocks"]
        with torch.no_grad():
            fn()
        return c["bottleneck_blocks"] - before

    assert ran(lambda: nets[V2](_input(256, 1))) == 28
    assert ran(lambda: nets[IRIS](_input(64, 1))) == 20
    assert ran(lambda: v1(_input(192, 1))) == 0
    assert ran(lambda: nets[IRIS](_input(64, 1), stages=False)) == 0


def test_each_chain_is_a_span_under_trace(nets, tmp_path):
    with profiling.trace(tmp_path), torch.no_grad():
        nets[V2](_input(256, 1))
    (trace,) = tmp_path.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "zaru.net.bottleneck" and e.get("ph") == "X"]
    assert len(spans) == 7


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
    packed = net._bottleneck_packed[chain.nodes[0]]
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
