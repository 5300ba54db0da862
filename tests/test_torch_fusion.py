"""The executor's plans (zaru_tpu_torch.onnx.fusion): the subgraphs that run
as one hand-written kernel, on the CPU, one test a property, each case a
kind of plan and a network that has it.

- Each plan finds its entries in its networks (BlazeFace short range: 2
  stage chains and 11 BlazeBlocks; Face Mesh V1: 8 stage chains and 6
  BlazeBlocks, all stride 2; Face Mesh V2: 7 bottleneck chains of 28
  blocks and 6 entry blocks; the iris model: 8 bottleneck chains of 20
  blocks and 6 entry blocks) and none in the other bundled models; the
  module runs each entry at its node. An entry block's MaxPool or Pad that
  something else reads runs as a node too.
- With a plan, each forward equals the node-by-node run (inside
  ``without_plans``) bit for bit: on the CPU a kernel runs the executor's
  own nodes.
- bf16 modules build no plan; NHWC modules only the stages.
- ``load_params`` repacks each plan's weights.
- Each forward counts its bottleneck blocks, BlazeBlocks and entry blocks
  in ``profiling.counters`` and marks each chain or block with its span.
- ``without_plans(*kinds)`` runs the named plans node by node, and gives
  every plan back on leaving.

The kernels themselves (packing, tiling, refusals, FLOP formulas) are
tested in test_torch_cnn_stage.py, test_torch_bottleneck.py,
test_torch_blaze_block.py and test_torch_entry_block.py.
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
from zaru_tpu_torch.onnx import executor as ex  # noqa: E402
from zaru_tpu_torch.onnx import fusion, load_model  # noqa: E402
from zaru_tpu_torch.onnx.proto import ValueInfo, parse_model  # noqa: E402

SHORT = "face_detection_short_range.onnx"
V1 = "face_landmark.onnx"
V2 = "face_landmarks_detector.onnx"
IRIS = "iris_landmark.onnx"
MODELS = [SHORT, V1, V2, IRIS, "face_detection_full_range.onnx", "hand_landmark_lite.onnx",
          "landmarks_68_pfld.onnx", "mobilefacenet.onnx", "palm_detection_lite.onnx", "slim_160_latest.onnx"]
SIDE = {SHORT: 128, V1: 192, V2: 256, IRIS: 64}
# Each plan's entries in its networks, in graph order, as summary() reads
# them. Stages: (blocks, channels, H×W, ReLU); bottlenecks: (channels,
# blocks, H); BlazeBlocks: (C_in, C_out, stride, H of the input, ReLU);
# entry blocks: (C_in, M, C_out, H of the input).
FOUND = {
    "stages": {
        V1: [(2, 16, (96, 96), False), (2, 32, (48, 48), False), (2, 64, (24, 24), False),
             (2, 128, (12, 12), False), (2, 128, (6, 6), False), (1, 32, (3, 3), False),
             (2, 128, (3, 3), False), (1, 32, (3, 3), False)],
        SHORT: [(1, 24, (64, 64), True), (4, 96, (8, 8), True)],
    },
    "bottlenecks": {
        V2: [(16, 4, 128), (32, 4, 64), (64, 4, 32), (128, 4, 16), (128, 4, 8), (128, 4, 4), (128, 4, 2)],
        IRIS: [(64, 4, 32), (128, 4, 16), (128, 2, 8), (128, 2, 8), (128, 2, 4), (128, 2, 2), (128, 2, 4),
               (128, 2, 2)],
    },
    "blaze_blocks": {
        SHORT: [(24, 28, 1, 64, True), (28, 32, 2, 64, True), (32, 36, 1, 32, True), (36, 42, 1, 32, True),
                (42, 48, 2, 32, True), (48, 56, 1, 16, True), (56, 64, 1, 16, True), (64, 72, 1, 16, True),
                (72, 80, 1, 16, True), (80, 88, 1, 16, True), (88, 96, 2, 16, True)],
        V1: [(16, 32, 2, 96, False), (32, 64, 2, 48, False), (64, 128, 2, 24, False), (128, 128, 2, 12, False),
             (128, 128, 2, 6, False), (128, 128, 2, 6, False)],
    },
    "entry_blocks": {
        V2: [(16, 16, 32, 128), (32, 32, 64, 64), (64, 64, 128, 32), (128, 64, 128, 16), (128, 64, 128, 8),
             (128, 64, 128, 4)],
        IRIS: [(64, 64, 128, 32), (128, 64, 128, 16), (128, 64, 128, 8), (128, 64, 128, 4), (128, 64, 128, 8),
               (128, 64, 128, 4)],
    },
}
HAS = [(kind, name) for kind, nets in FOUND.items() for name in nets]
HAS_NOT = [(kind, name) for kind, nets in FOUND.items() for name in MODELS if name not in nets]
# The counter and the span of the plans that have them (the stages have neither).
COUNTED = {"bottlenecks": ("bottleneck_blocks", "zaru.net.bottleneck"),
           "blaze_blocks": ("blaze_blocks", "zaru.net.blaze_block"),
           "entry_blocks": ("entry_blocks", "zaru.net.entry_block")}
# The entries that run at their last node (the others at their first).
AT_LAST = ("blaze_blocks", "entry_blocks")
BLAZE_PADS = {1: (1, 1, 1, 1), 2: (0, 0, 1, 1)}


@pytest.fixture(scope="module")
def nets():
    return {name: load_model(model_path(name).read_bytes(), torch.device("cpu")) for name in SIDE}


def _input(name, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (batch, 3, SIDE[name], SIDE[name])).astype(np.float32))


def summary(kind, net, e, env) -> tuple:
    """Entry ``e`` of plan ``kind`` as FOUND lists it, after checking its
    nodes' ops and its output's shape against ``env``, a forward's values."""
    ops = [net.nodes[i].op_type for i in e.nodes]
    x, y = env[e.input].shape, env[e.output].shape
    if kind == "stages":
        assert y == x and len(e.nodes) == 4 * len(e.blocks)
        assert ops[:3] == ["Conv", "Conv", "Add"] and ops[3] in ("PRelu", "Relu")
        return len(e.blocks), e.channels, tuple(x[2:]), e.blocks[0]["alpha"] is None
    if kind == "bottlenecks":
        assert y == x and len(e.nodes) == 6 * len(e.blocks)
        assert ops[:6] == ["Conv", "PRelu", "Conv", "Conv", "Add", "PRelu"]
        return e.channels, len(e.blocks), x[2]
    if kind == "entry_blocks":
        assert y == (x[0], e.c_out, x[2] // 2, x[3] // 2) and e.c_out == 2 * e.m and e.nodes[-1] == max(e.nodes)
        want = ["Conv", "PRelu", "Conv", "Conv", "Add", "PRelu", "MaxPool"] + ["Pad"] * (e.c_out > e.c_in)
        assert sorted(ops) == sorted(want) and net.nodes[e.at].outputs[0] == e.output
        return e.c_in, e.m, e.c_out, x[2]
    assert e.pads == BLAZE_PADS[e.stride] and y == (x[0], e.c_out, x[2] // e.stride, x[3] // e.stride)
    want = ["Add", "Conv", "Conv", "Relu" if e.relu else "PRelu"]
    want += ["Pad"] * (e.c_out > e.c_in) + ["MaxPool"] * (e.stride == 2)
    assert sorted(ops) == sorted(want) and e.nodes[-1] == max(e.nodes) and net.nodes[e.at].outputs[0] == e.output
    return e.c_in, e.c_out, e.stride, x[2], e.relu


def test_assets_are_the_listed_models():
    assert sorted(os.listdir(model_path(V1).parent)) == sorted(MODELS)


def test_kinds_are_the_plans():
    assert fusion.PLANS == ex.PLANS == tuple(fusion.KINDS) == ("stages", "bottlenecks", "blaze_blocks",
                                                               "entry_blocks")


@pytest.mark.parametrize("kind,name", HAS)
def test_plan_finds_its_entries(kind, name, nets):
    """The listed entries, each of its nodes; the module runs each at its
    node (the first of a chain, a BlazeBlock's activation, an entry block's
    last PRelu) and skips the others; the finder importable from the
    executor finds the same."""
    net = nets[name]
    env = net.activations(_input(name, 1))
    entries = getattr(net, kind)
    assert [summary(kind, net, e, env) for e in entries] == FOUND[kind][name]
    assert all(net._plan_at[e.at] is e and set(e.nodes) <= net._in_plan for e in entries)
    assert all(e.at == (e.nodes[-1] if kind in AT_LAST else e.nodes[0]) for e in entries)
    finder = getattr(ex, f"find_{kind}")
    assert finder is fusion.KINDS[kind][0]
    assert finder(parse_model(model_path(name).read_bytes())) == entries


@pytest.mark.parametrize("kind,name", HAS_NOT)
def test_plan_finds_nothing_elsewhere(kind, name):
    """Every other bundled model runs these nodes one by one: full-range
    BlazeFace's double blocks and bottleneck look-alikes (ReLU, no such
    residual), Face Mesh V2's and the iris model's stride-2 entry blocks
    for the BlazeBlocks (their depthwise reads a 2×2 convolution's output,
    not the pooled value), the iris model's bottleneck blocks for the
    stages; no other network has a 2×2 stride-2 convolution."""
    assert getattr(load_model(model_path(name).read_bytes(), torch.device("cpu")), kind) == []


@pytest.mark.parametrize("kind,name", HAS)
def test_plan_equals_node_by_node(kind, name, nets):
    """Batch 2: every output of the forward with the plan equals the run
    without it, and the run without any plan, bit for bit."""
    net = nets[name]
    x = _input(name, 2, seed=3)
    with torch.no_grad():
        fused = net(x)
        with net.without_plans(kind):
            without = net(x)
        with net.without_plans():
            plain = net(x)
    for a, b, c in zip(fused, without, plain, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("kw", [{"compute_dtype": torch.bfloat16}, {"layout": "NHWC"}], ids=["bf16", "NHWC"])
@pytest.mark.parametrize("kind,name", HAS)
def test_bf16_and_nhwc_modules_build_no_plan(kind, name, kw, nets):
    """A bf16 module builds no plan and packs nothing; an NHWC module builds
    only the stages, the same as the NCHW module's."""
    net = load_model(model_path(name).read_bytes(), torch.device("cpu"), **kw)
    takes = kind == "stages" and "layout" in kw
    assert getattr(net, kind) == (getattr(nets[name], kind) if takes else [])
    assert set(net._packed) == {e.at for k in ex.PLANS for e in getattr(net, k)}
    assert takes or not set(net._packed) & {e.at for e in getattr(nets[name], kind)}


@pytest.mark.parametrize("kind,name", HAS)
def test_load_params_repacks(kind, name):
    """New weights loaded after construction are the ones an entry runs
    with: its output changes and equals the node-by-node run on them."""
    net = load_model(model_path(name).read_bytes(), torch.device("cpu"))
    entries = getattr(net, kind)
    e = entries[min(2, len(entries) - 1)]
    x = _input(name, 1, seed=4)
    before = net.activations(x)
    params = {k: v.clone() for k, v in net.params().items()}
    for names in (e.names,) if kind in AT_LAST else e.blocks:
        for v in names.values():
            if v is not None:
                params[v] = params[v] * 1.5 + 0.1
    net.load_params(params)
    after = net.activations(x)
    assert not torch.equal(after[e.output], before[e.output])
    with net.without_plans(kind):
        assert torch.equal(after[e.output], net.activations(x)[e.output])


@pytest.mark.parametrize("kind,name", [(k, n) for k, n in HAS if k in COUNTED])
def test_forwards_count_their_blocks(kind, name, nets):
    """A forward counts each plan's blocks in its counter (bottleneck blocks
    28 a Face Mesh V2 forward and 20 an iris forward, entry blocks 6 in
    each; BlazeBlocks 11 a BlazeFace short range forward, 6 a Face Mesh V1
    forward; none of another network's kind), and none while the plan is
    off."""
    net = nets[name]
    c = profiling.counters

    def ran(fn):
        before = dict(c)
        with torch.no_grad():
            fn()
        return {k: c[key] - before[key] for k, (key, _) in COUNTED.items()}

    want = {k: sum(len(e.blocks) if k == "bottlenecks" else 1 for e in getattr(net, k)) for k in COUNTED}
    assert want[kind] == {("bottlenecks", V2): 28, ("bottlenecks", IRIS): 20, ("blaze_blocks", SHORT): 11,
                          ("blaze_blocks", V1): 6, ("entry_blocks", V2): 6, ("entry_blocks", IRIS): 6}[kind, name]
    assert ran(lambda: net(_input(name, 1))) == want
    with net.without_plans(kind):
        assert ran(lambda: net(_input(name, 1)))[kind] == 0


@pytest.mark.parametrize("kind,name", [(k, n) for k, n in HAS if k in COUNTED])
def test_each_entry_is_a_span_under_trace(kind, name, nets, tmp_path):
    """One span a bottleneck chain, a BlazeBlock or an entry block."""
    with profiling.trace(tmp_path), torch.no_grad():
        nets[name](_input(name, 1))
    (trace,) = tmp_path.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == COUNTED[kind][1] and e.get("ph") == "X"]
    assert len(spans) == len(getattr(nets[name], kind))


@pytest.mark.parametrize("kinds", [(), ("stages",), ("bottlenecks",), ("blaze_blocks",), ("stages", "blaze_blocks"),
                                   ("entry_blocks",)])
@pytest.mark.parametrize("name", [SHORT, V1, V2])
def test_without_plans_runs_the_named_plans_node_by_node(name, kinds, nets):
    """Inside ``without_plans`` the named plans (all where none is named)
    are empty and only the others' nodes are left to them; the forward
    counts no block of a named plan and still equals the node-by-node run
    bit for bit; on leaving, by an exception too, every plan is back."""
    net = nets[name]
    plans, in_plan, plan_at = {k: list(getattr(net, k)) for k in ex.PLANS}, set(net._in_plan), dict(net._plan_at)
    cleared = kinds or ex.PLANS
    x = _input(name, 2, seed=7)
    with torch.no_grad():
        with net.without_plans():
            plain = net(x)
        with pytest.raises(KeyError, match="left"):
            with net.without_plans(*kinds):
                assert all(getattr(net, k) == [] for k in cleared)
                kept = [e for k in ex.PLANS if k not in cleared for e in plans[k]]
                assert net._in_plan == {i for e in kept for i in e.nodes}
                assert net._plan_at == {e.at: e for e in kept}
                before = dict(profiling.counters)
                got = net(x)
                for k, (key, _) in COUNTED.items():
                    ran = profiling.counters[key] - before[key]
                    assert (ran == 0) == (k in cleared or not plans[k]), (k, ran)
                assert all(torch.equal(a, b) for a, b in zip(got, plain, strict=True))
                raise KeyError("left")
    assert {k: getattr(net, k) for k in ex.PLANS} == plans
    assert net._in_plan == in_plan and net._plan_at == plan_at


def test_without_plans_refuses_an_unknown_plan(nets):
    net = nets[V1]
    with pytest.raises(ValueError, match="unknown plans"):
        with net.without_plans("stage"):
            pass
    assert len(net.blaze_blocks) == 6 and len(net.stages) == 8


@pytest.mark.parametrize("read", ["MaxPool", "Pad"])
def test_an_entry_blocks_pool_read_elsewhere_runs_as_a_node(read):
    """Where a graph output reads Face Mesh V2's first entry block's Pad or
    its MaxPool, that node (and the MaxPool under a Pad) runs as a node:
    the block is still planned without it, and the forward equals the
    node-by-node run bit for bit."""
    model = parse_model(model_path(V2).read_bytes())
    first = fusion.find_entry_blocks(model)[0]
    (node,) = [i for i in first.nodes if model.graph.nodes[i].op_type == read]
    model.graph.outputs.append(ValueInfo(model.graph.nodes[node].outputs[0], [1, 16, 64, 64], 1))
    net = ex.OnnxModule(model, torch.device("cpu"))
    kept = {i for i in first.nodes if model.graph.nodes[i].op_type in ({read, "MaxPool"})}
    blk = net.entry_blocks[0]
    assert len(net.entry_blocks) == 6 and set(blk.nodes) == set(first.nodes) - kept
    assert not kept & net._in_plan and blk.input == first.input
    x = _input(V2, 2, seed=6)
    with torch.no_grad():
        fused = net(x)
        with net.without_plans():
            plain = net(x)
    for a, b in zip(fused, plain, strict=True):
        assert torch.equal(a, b)
