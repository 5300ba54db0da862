"""What a configuration that identifies the faces it tracks may carry as
data, with no edit to the harness: a class wrapped around the tracker
(``program.wrap``), a gallery made from the configuration (``gallery``),
MobileFaceNet in the plain graph runner and the work counts, and the
compared numbers ``embedding`` and ``identity``; end to end through
``Session`` on the CPU at 2 streams with a wrapper and a reference of the
test's own."""

from __future__ import annotations

import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import check, frames, gallery, program, readings
from benchmark.harness.cell import Session
from benchmark.harness.loops import Window
from benchmark.harness.spec import Spec
from benchmark.reference import samplers
from benchmark.reference.cascade import Cascade
from benchmark.reference.graph import Graph
from benchmark.work import networks

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MODELS = ROOT / "assets" / "onnx"
MOBILEFACENET = MODELS / "mobilefacenet.onnx"
H100 = "NVIDIA H100 80GB HBM3"
EMBEDDER = {"name": "embedder", "file": "mobilefacenet.onnx", "crops": 1, "steps": "every"}
# The bench frame's face: the reference detector's box (centre 1048.8,
# 630.8; side 451) grown by 0.2 a side, as the program frames a face to embed.
FACE = [1048.8, 630.8, 631.3, 631.3, 0.0]
GALLERY = {"rows": 48, "dim": 128, "seed": 2**31 + 5,
           "enroll": [{"network": "embedder", "rect": FACE},
                      {"network": "embedder", "rect": [1048.8, 630.8, 700.0, 700.0, 0.2]}]}


def _cnn_bar(got, want):
    """The CNN bar: ``atol = 1e-3·max(1, |want|max)``, ``rtol = 2e-3``."""
    torch.testing.assert_close(got, want, atol=1e-3 * max(1.0, float(want.abs().max())), rtol=2e-3)


def _id_config(**kw):
    """``face_v1`` identifying its faces: the embedder listed as one crop a
    stream every step, its section, and a gallery."""
    cfg = dict(Spec().config("face_v1"), name="face_v1_id", networks=[EMBEDDER],
               embedder={"input": [112, 112], "color_range": [-1.0, 1.0]}, gallery=GALLERY)
    cfg.update(kw)
    return cfg


# --- MobileFaceNet in the plain graph runner -----------------------------

def _seeded_params(params: dict, seed: int) -> dict:
    """Gaussian weights of each initializer's own shape and spread."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) * float(v.float().std()) for k, v in params.items()}


@pytest.mark.parametrize("weights", ["file", "seeded"])
def test_graph_runs_mobilefacenet_as_the_port_does(weights):
    """At 4 crops on the CPU, on the file's weights and on seeded ones: the
    port's executor and the plain runner agree (bit for bit here)."""
    from zaru_tpu_torch.face.recognition import Embedder

    graph = Graph(MOBILEFACENET)
    assert {n.op_type for n in graph.nodes} == {"Conv", "Clip", "Add", "Relu", "Reshape"}
    x = torch.rand(4, 3, 112, 112, generator=torch.Generator().manual_seed(3)) * 2 - 1
    if weights == "file":
        embedder = Embedder("cpu")
    else:
        params = _seeded_params(Embedder("cpu").params, 5)
        embedder = Embedder("cpu", params={k: v.numpy() for k, v in params.items()})
        graph.weights.update(params)
    got = graph(x)[0]
    want = embedder.cnn().nn.estimate(x)[0]
    assert got.shape == (4, 128)
    _cnn_bar(got, want)


def test_clip_takes_its_bounds_as_inputs_or_attributes_either_one_absent():
    from benchmark.reference.graph import _OPS

    node = types.SimpleNamespace(attrs={})
    x = torch.linspace(-8, 8, 33)
    assert torch.equal(_OPS["Clip"](node, x, np.float32(0), np.array([6.0], np.float32)), x.clamp(0, 6))
    assert torch.equal(_OPS["Clip"](node, x, None, np.float32(6)), x.clamp(max=6))
    assert torch.equal(_OPS["Clip"](node, x), x)
    old = types.SimpleNamespace(attrs={"min": -1.0, "max": 2.0})
    assert torch.equal(_OPS["Clip"](old, x), x.clamp(-1, 2))
    assert torch.equal(_OPS["Clip"](types.SimpleNamespace(attrs={"min": 0.5}), x), x.clamp(min=0.5))


@pytest.mark.parametrize("name, count", [("mobilefacenet.onnx", 474_351_360),
                                         ("face_detection_short_range.onnx", 63_533_952),
                                         ("face_landmark.onnx", 72_995_005),
                                         ("face_landmarks_detector.onnx", 236_374_173),
                                         ("iris_landmark.onnx", 109_636_324)])
def test_flops_of_each_file(name, count):
    assert networks.flops(MODELS / name) == count


def test_flops_of_mobilefacenet_equal_analyze():
    from zaru_tpu_torch.face.recognition import Embedder
    from zaru_tpu_torch.onnx.analysis import analyze

    assert networks.flops(MOBILEFACENET) == analyze(Embedder("cpu").cnn().nn).flops == 474_351_360


# --- the gallery ---------------------------------------------------------

def test_gallery_rows_are_enrolled_then_seeded_unit_rows():
    names, rows = gallery.rows(_id_config(), MODELS)
    assert rows.dtype == torch.float32 and rows.device.type == "cpu" and rows.shape == (48, 128)
    assert names == ["enrolled.0", "enrolled.1"] + [f"seeded.{i}" for i in range(46)]
    torch.testing.assert_close(torch.linalg.vector_norm(rows, dim=-1), torch.ones(48), atol=1e-6, rtol=0)
    # The enrolled rows: the network on the exact crops of the bench frame, one at a time.
    frame = torch.from_numpy(frames.bench_frame())[None]
    for row, e in zip(rows, GALLERY["enroll"]):
        rect = torch.tensor([e["rect"]], dtype=torch.float32)
        out = Graph(MOBILEFACENET)(samplers.rotated_exact(frame, rect, 112, 112, -1.0, 1.0))[0][0]
        assert torch.equal(row, out / torch.linalg.vector_norm(out))
    # The same rows again, as copies; another seed draws other seeded rows only.
    again_names, again = gallery.rows(_id_config(), MODELS)
    assert again_names == names and torch.equal(again, rows)
    rows.zero_()
    assert torch.equal(gallery.rows(_id_config(), MODELS)[1], again)
    _, other = gallery.rows(_id_config(gallery=dict(GALLERY, seed=7)), MODELS)
    assert torch.equal(other[:2], again[:2]) and not torch.equal(other[2:], again[2:])
    # Seeded rows spread over the sphere: no two alike.
    cos = again[2:] @ again[2:].T - torch.eye(46)
    assert float(cos.abs().max()) < 0.6


def test_gallery_refuses_what_it_cannot_make():
    with pytest.raises(ValueError, match="cannot hold"):
        gallery.rows(_id_config(gallery=dict(GALLERY, rows=1)), MODELS)
    with pytest.raises(ValueError, match="not the gallery's 64"):
        gallery.rows(_id_config(gallery=dict(GALLERY, dim=64)), MODELS)
    only_seeded = dict(GALLERY, enroll=[])
    names, rows = gallery.rows(_id_config(gallery=only_seeded), MODELS)
    assert len(names) == 48 and names[0] == "seeded.0" and rows.shape == (48, 128)


# --- the wrapper ---------------------------------------------------------

class _Stub:
    """A wrapper that keeps what it was built with."""

    def __init__(self, tracker, compute_dtype=None, device=None, threshold=1.0):
        self.tracker, self.compute_dtype, self.device, self.threshold = tracker, compute_dtype, device, threshold


@pytest.fixture
def stub_module(monkeypatch):
    module = types.ModuleType("portbench_wrap_stub")
    module.Stub = _Stub
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return module


def test_wrap_reaches_the_class_with_compute_dtype(stub_module):
    from zaru_tpu_torch.pipeline.face_cascade import FaceTracker

    plain = Spec().config("face_v1")
    cfg = dict(plain, program=dict(plain["program"], wrap={"class": "portbench_wrap_stub.Stub",
                                                           "options": {"threshold": 0.7}}))
    built = program.build(cfg, torch.device("cpu"), torch.bfloat16)
    assert isinstance(built, _Stub) and isinstance(built.tracker, FaceTracker)
    assert built.compute_dtype is torch.bfloat16 and built.device == torch.device("cpu") and built.threshold == 0.7
    assert built.tracker.roi_padding == plain["tracker"]["roi_padding"]
    no_options = dict(plain, program=dict(plain["program"], wrap={"class": "portbench_wrap_stub.Stub"}))
    assert program.build(no_options, torch.device("cpu")).compute_dtype is None
    assert type(program.build(plain, torch.device("cpu"))) is FaceTracker


# --- the compared numbers ------------------------------------------------

def _record(n=4):
    emb = torch.nn.functional.normalize(torch.randn(n, 128, generator=torch.Generator().manual_seed(1)), dim=-1)
    out = {"landmarks": torch.rand(n, 468, 3), "confidence": torch.rand(n), "roi": torch.rand(n, 5),
           "valid": torch.tensor([True, True, False, True][:n]), "embedding": emb,
           "identity": torch.tensor([3, -1, 5, 0][:n], dtype=torch.int32)}
    state = {"roi": out["roi"], "tracking": out["valid"],
             "filter": {"x": torch.rand(n, 468, 3), "dx": torch.rand(n, 468, 3),
                        "init": torch.ones(n, 468, 3, dtype=torch.bool)}}
    return {"state_in": state, "out": out, "state_out": state, "detect": False}


class _Judge:
    """A reference that returns the program's outputs and state, its
    embeddings moved by ``shift`` in one component, the identities in
    ``flips`` changed, and a margin of ``margin`` (None: no margin)."""

    def __init__(self, record, shift=0.0, flips=(), margin=None, keep=("embedding", "identity")):
        self.record, self.shift, self.flips, self.margin, self.keep = record, shift, flips, margin, keep

    def step(self, state, frames, detect, exact):
        out = {k: v for k, v in self.record["out"].items() if k not in ("embedding", "identity") or k in self.keep}
        if "embedding" in out:
            out["embedding"] = out["embedding"].clone()
            out["embedding"][:, 0] += self.shift
        if "identity" in out:
            out["identity"] = out["identity"].clone()
            for i in self.flips:
                out["identity"][i] = out["identity"][i] + 1
        if self.margin is not None:
            out["identity_margin"] = torch.full(out["valid"].shape, self.margin)
        return self.record["state_out"], out


def _compare(reference, rec):
    return check.compare(reference, [(0, rec)], lambda a, b: None, exact=False, single=False, rows=8,
                         device=torch.device("cpu"))


@pytest.mark.parametrize("margin, flips, identity", [
    (1.0, (), 0.0),  # no flip
    (1.0, (0,), 1.0),  # a flip outside the margin: a fault
    (1.0, (0, 1, 3), 3.0),
    (1.0, (2,), 0.0),  # a stream not valid on the program's side
    (0.0005, (0,), 0.0),  # inside the margin (‖Δe‖ 0.001): rounding may flip it
    (0.001 + check.DISTANCE_ROUNDING / 2, (0,), 0.0),
    (0.001 + 2 * check.DISTANCE_ROUNDING, (0,), 1.0),
    (float("inf"), (0,), 1.0),  # a gallery of one row: every decision clear
])
def test_an_identity_flip_counts_only_outside_the_margin(margin, flips, identity):
    rec = _record()
    numbers = _compare(_Judge(rec, shift=0.001, flips=flips, margin=margin), rec)
    assert numbers["identity"] == identity
    assert numbers["embedding"] == pytest.approx(0.001, abs=1e-6)
    assert numbers["landmarks_px"] == numbers["flags"] == 0.0


def test_embeddings_and_identities_are_read_only_where_both_sides_give_them():
    rec = _record()
    plain = {k: v for k, v in rec["out"].items() if k not in ("embedding", "identity")}
    older = dict(rec, out=plain)
    assert not {"embedding", "identity"} & set(_compare(_Judge(older, margin=1.0), older))
    # The reference gives no margin: embeddings compared, identities not.
    numbers = _compare(_Judge(rec, flips=(0,)), rec)
    assert numbers["embedding"] == 0.0 and "identity" not in numbers
    # The reference gives no embedding: neither.
    numbers = _compare(_Judge(rec, margin=1.0, keep=("identity",)), rec)
    assert not {"embedding", "identity"} & set(numbers)


def test_limits_naming_embedding_on_a_cell_without_it_are_an_error():
    rec = _record()
    older = dict(rec, out={k: v for k, v in rec["out"].items() if k not in ("embedding", "identity")})
    numbers = _compare(_Judge(older), older)
    with pytest.raises(KeyError, match="embedding"):
        check.judge(numbers, {"landmarks_px": {"limit": 0.74}, "embedding": {"limit": 1e-3}})
    with pytest.raises(KeyError, match="identity"):
        check.judge(numbers, {"identity": {"limit": 0}})


# --- end to end, as data -------------------------------------------------

class _Identifier:
    """The port's ``StreamIdentifier`` on the wrapped tracker, driven as the
    harness drives a program: ``init_state``, ``step_batch``, and
    ``set_gallery`` once at set-up."""

    def __init__(self, tracker, compute_dtype=None, device=None, threshold=1.0):
        from zaru_tpu_torch.face.identify import StreamIdentifier
        from zaru_tpu_torch.face.recognition import Embedder

        self.identifier = StreamIdentifier(tracker, Embedder(device), threshold=threshold, device=device)
        self.compute_dtype, self.installed = compute_dtype, None

    def set_gallery(self, names, rows):
        self.installed = names, rows.clone()
        self.identifier.set_gallery(names, rows)

    def init_state(self, batch):
        return self.identifier.init_state(batch)

    def step_batch(self, state, frames, force_detect=False):
        return self.identifier.step(state, frames, force_detect=force_detect)


class _WithIdentities(Cascade):
    """The plain cascade, with embeddings and identities of the program's
    own (``kept``) moved by ``shift`` in one component, stream 0's identity
    changed where ``flip``, and a margin of ``margin`` for every stream: no
    identification reference exists yet."""

    def __init__(self, *args, kept, shift, flip, margin, **kw):
        super().__init__(*args, **kw)
        self.kept, self.shift, self.flip, self.margin = kept, shift, flip, margin

    def step(self, state, frames, detect, exact=False):
        r_state, r_out = super().step(state, frames, detect, exact)
        out = self.kept.pop(0)
        emb = out["embedding"].clone()
        emb[:, 0] += self.shift
        ident = out["identity"].clone()
        if self.flip:
            ident[0] = ident[0] + 1
        margin = torch.full(ident.shape, self.margin)
        return r_state, dict(r_out, embedding=emb, identity=ident, identity_margin=margin)


@pytest.fixture(scope="module")
def id_spec(tmp_path_factory):
    """A copy of the benchmark with an identifying configuration, a limits
    file naming ``embedding`` and ``identity``, and a cell, written as new
    files and new entries; the wrapper importable by its dotted path."""
    root = tmp_path_factory.mktemp("id")
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "assets").symlink_to(ROOT / "assets")
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = _id_config()
    cfg["program"] = dict(cfg["program"], wrap={"class": "portbench_identify_wrap.Identifier",
                                                "options": {"threshold": 1.0}})
    (root / "benchmark" / "configs" / "face_v1_id.json").write_text(json.dumps(cfg))
    limits = json.loads((BENCH / "limits" / "face_v1.track_b512.json").read_text())
    limits["embedding"] = {"limit": 0.01, "lower": 0.0, "upper": 0.1}
    limits["identity"] = {"limit": 0, "lower": 0, "upper": None}
    (root / "benchmark" / "limits" / "face_v1_id.track_b512.json").write_text(json.dumps(limits))
    data["configs"].append({"name": "face_v1_id", "source": "https://arxiv.org/abs/1804.07573", "reduced": [],
                            "why": "x", "file": "benchmark/configs/face_v1_id.json"})
    data["workloads"].append({"name": "face_v1_id.track_b512", "config": "face_v1_id",
                              "traffic": "track_b512", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    module = types.ModuleType("portbench_identify_wrap")
    module.Identifier = _Identifier
    sys.modules[module.__name__] = module
    yield root, Spec(root, root / "benchmark")
    del sys.modules[module.__name__]


@pytest.mark.parametrize("flip, margin, correct", [(False, 1.0, True), (True, 1.0, False), (True, 0.0005, True)])
def test_an_identifying_configuration_is_built_counted_and_compared_as_data(id_spec, flip, margin, correct):
    """The wrapper built around the tracker, the gallery installed before
    the warm-up, the embedder counted, and both numbers read and judged by
    the harness as it stands (a small window on the CPU); a flip outside
    the reference's margin makes the run not correct."""
    harness = {p.name: p.read_bytes() for p in (BENCH / "harness").glob("*.py")}
    root, spec = id_spec
    cell = spec.cell("face_v1_id.track_b512")
    small = dict(cell.traffic, streams=2, width=480, height=270, check_steps=1)
    session = Session(cell, root, "cpu", traffic=small)
    assert isinstance(session.program, _Identifier)
    names, rows = session.program.installed
    ref_names, ref_rows = gallery.rows(cell.config, MODELS)  # as a reference module gets them
    assert names == ref_names and torch.equal(rows, ref_rows)

    kept = []
    reference = _WithIdentities(cell.config, MODELS, "cpu", kept=kept, shift=0.001, flip=flip, margin=margin)
    orig_compare = check.compare

    def compare(ref, steps, *a, **kw):
        kept.extend(rec["out"] for _, rec in steps)
        return orig_compare(ref, steps, *a, **kw)

    check.compare = compare
    try:
        outcome = session.run(2**31 + 11, 0.2, False, 0.0, reference=reference)
    finally:
        check.compare = orig_compare
    assert not kept and outcome.lost_after_first == 0
    assert outcome.numbers["embedding"] == pytest.approx(0.001, abs=1e-6)
    assert outcome.numbers["identity"] == (1.0 if flip and margin > 0.01 else 0.0)
    assert outcome.numbers["landmarks_px"] == 0.0 and outcome.numbers["flags"] == 0.0
    ok, checks = check.judge(outcome.numbers, cell.limits)
    assert ok is correct
    assert checks["embedding"]["limit"] == 0.01 and checks["identity"]["limit"] == 0
    lm, det, emb = (networks.flops(MODELS / f) for f in
                    ("face_landmark.onnx", "face_detection_short_range.onnx", "mobilefacenet.onnx"))
    run = readings.Run(cell.config, Window(1.0, [0.01], 0, 0, [(512, torch.ones(512, dtype=torch.bool), d)
                                                               for d in (True, False)], {}), None, H100, MODELS)
    assert readings.network_flops(run) == 512 * (2 * (lm + emb) + det)
    assert {p.name: p.read_bytes() for p in (BENCH / "harness").glob("*.py")} == harness


# --- on the card ---------------------------------------------------------

@pytest.mark.chip
def test_graph_holds_the_ports_embedder_at_128_crops_on_the_card(cuda):
    """MobileFaceNet on 128 crops of the bench frame's face (seeded shifts,
    sizes and angles) through the port's ``Embedder`` and the plain runner
    on the card, TF32 off on both: within the CNN bar. Prints the gap
    (``pytest -s``)."""
    from zaru_tpu_torch.face.recognition import Embedder

    rng = np.random.Generator(np.random.PCG64(2**31 + 27))
    jitter = np.stack([rng.uniform(-40, 40, 128), rng.uniform(-40, 40, 128), rng.uniform(0.8, 1.25, 128),
                       rng.uniform(-0.35, 0.35, 128)], axis=-1)
    rects = torch.tensor([[FACE[0] + dx, FACE[1] + dy, FACE[2] * s, FACE[3] * s, a] for dx, dy, s, a in jitter],
                         dtype=torch.float32, device=cuda)
    frame = torch.from_numpy(frames.bench_frame()).to(cuda)[None].expand(128, -1, -1, -1)
    x = samplers.rotated_exact(frame, rects, 112, 112, -1.0, 1.0)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = Embedder(cuda).cnn().nn.estimate(x)[0]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    got = Graph(MOBILEFACENET, cuda)(x)[0]
    gap = float((got - want).abs().max())
    print(f"MobileFaceNet, 128 crops, plain runner against the port: max |diff| {gap!r}, "
          f"|out| max {float(want.abs().max())!r}")
    _cnn_bar(got, want)
