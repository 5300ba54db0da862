"""The port's export path (zaru_tpu_torch.export, the CLI's ``export`` and
``run-exported``, the kernels as registered ops, the ROI choice as
``torch.cond``), its cost analysis and profiling hooks, against
zaru_tpu's, on the CPU.

JAX's side is stored in ``zaru_tpu_torch/fixtures/export_train.npz`` (keys
``export__*``; tests/test_torch_train.py owns the ``train__*`` keys):

- its exported single-stream face step (``zaru_tpu.export.export_fn`` of
  ``FaceTracker().step`` at 720×1280, reloaded with ``load_exported``) over
  PLAN on the fixture photo: the state before each step and the outputs;
- a state sidecar it wrote (``save_state`` of a batch-2 ``FaceTracker``
  state, the filter's nested dict included);
- its FLOP counts, parameter counts and output shapes (``analyze``) of
  BlazeFace short-range, Face Mesh V1 and slim_160.

``test_fixture_is_current`` runs JAX again, in the test process. Regenerate
this file's keys with::

    JAX_PLATFORMS=cpu python tests/test_torch_export.py

The exported step is held to JAX as tests/test_torch_face_cascade.py holds
the eager one: one step at a time from JAX's state (landmarks and ROI
within STEP_TOL_PX, flags equal), and free-running (flags equal, landmarks
within FREE_TOL_PX); against the port's eager step it is bit-equal.

FLOPs. XLA's ``cost_analysis`` counts what the port's ``analyze`` counts
(multiply-adds as 2, a bias or an elementwise arithmetic op 1 an element)
and more: a MaxPool's window (each element a compare), PReLU's compare and
select, the padding and the channel-padding of the stride-2 blocks. The
port counts those 0. Measured, the port is below JAX by 2.13% on BlazeFace
(stride-2 blocks with MaxPool, channel pads and PReLU-free ReLUs), 1.96% on
Face Mesh V1 (PReLU everywhere, MaxPool in its stride-2 blocks), and above
by 0.29% on slim_160 (XLA folds its BatchNorm-free Clip-and-Add work
differently); held to FLOPS_RTOL.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "zaru_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "export_train.npz")
PREFIX = "export__"
PHOTO = os.path.join(ROOT, "assets", "img", "sad_linus.jpg")
CROPPED = os.path.join(ROOT, "assets", "img", "sad_linus_cropped.jpg")
MODELS = ("face_detection_short_range.onnx", "face_landmark.onnx", "slim_160_latest.onnx")
# Per step: is the photo's frame zeroed (the face lost)?
PLAN = [False, False, True, False]
STEP_TOL_PX = 1e-2  # tests/test_torch_face_cascade.py
FREE_TOL_PX = 8.0  # tests/test_torch_face_cascade.py
FLOPS_RTOL = 0.03  # 2.13% measured; see the module docstring


def photo_rgba():
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        rgb = f["rgb"]
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)


def plan_frames():
    photo = photo_rgba()
    return [np.zeros_like(photo) if zero else photo for zero in PLAN]


def flat_state(state) -> dict:
    return {"roi": np.asarray(state["roi"]), "tracking": np.asarray(state["tracking"]),
            **{f"filter/{k}": np.asarray(v) for k, v in state["filter"].items()}}


def nested_state(flat: dict) -> dict:
    return {"roi": flat["roi"], "tracking": flat["tracking"],
            "filter": {k[len("filter/"):]: v for k, v in flat.items() if k.startswith("filter/")}}


def jax_step_run():
    """zaru_tpu's exported single-stream step over PLAN: pre-step states
    and outputs, stacked on a leading step axis."""
    import tempfile

    from zaru_tpu.export import export_fn, load_exported
    from zaru_tpu.pipeline import FaceTracker

    tracker = FaceTracker()
    state = tracker.init_state()
    frames = plan_frames()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "step.stablehlo")
        export_fn(lambda st, f: tracker.step(tracker.params, st, f), (state, frames[0]), path)
        call = load_exported(path)
    states, outs = [], []
    for frame in frames:
        states.append(flat_state(state))
        state, out = call(state, frame)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    arrays = {f"state/{k}": np.stack([s[k] for s in states]) for k in states[0]}
    arrays.update({f"out/{k}": np.stack([o[k] for o in outs]) for k in outs[0]})
    return arrays


def jax_analysis_and_sidecar():
    """zaru_tpu's cost reports of MODELS and a sidecar it wrote."""
    import tempfile

    from zaru_tpu.assets import model_path
    from zaru_tpu.export import save_state
    from zaru_tpu.onnx import load_model
    from zaru_tpu.onnx.analysis import analyze
    from zaru_tpu.pipeline import FaceTracker

    reports = [analyze(load_model(model_path(m))) for m in MODELS]
    out = {
        "flops": np.asarray([r.flops for r in reports], np.int64),
        "params": np.asarray([r.params for r in reports], np.int64),
        "param_bytes": np.asarray([r.param_bytes for r in reports], np.int64),
        "output_shapes": np.asarray(json.dumps([[list(s) for s in r.output_shapes] for r in reports])),
    }
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        save_state(FaceTracker().init_state(batch=2), path)
        with open(path, "rb") as f:
            out["sidecar"] = np.frombuffer(f.read(), np.uint8)
    return out


def jax_now():
    """Every JAX result the fixture stores."""
    return {**jax_step_run(), **jax_analysis_and_sidecar()}


def regen():
    arrays = jax_now()
    keep = {}
    if os.path.exists(FIXTURE):
        with np.load(FIXTURE) as f:
            keep = {k: f[k] for k in f.files if not k.startswith(PREFIX)}
    np.savez_compressed(FIXTURE, **keep, **{PREFIX + k: v for k, v in arrays.items()})
    print(f"wrote {FIXTURE}")


# --- the tests -----------------------------------------------------------------


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k[len(PREFIX):]: f[k] for k in f.files if k.startswith(PREFIX)}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two artifacts made through the CLI, shared by the tests: the
    single-stream step at the photo's 720×1280 and the batch-2 gated step
    at the cropped photo's 535×535, each with its sidecar and manifest."""
    import contextlib
    import io

    from zaru_tpu_torch.__main__ import main

    d = tmp_path_factory.mktemp("artifacts")
    single, batch = d / "step.pt2", d / "batch2.pt2"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(["export", str(single), "--height", "720", "--width", "1280", "--device", "cpu", "--verify"]) == 0
    assert main(["export", str(batch), "--batch", "2", "--height", "535", "--width", "535", "--device", "cpu"]) == 0
    return single, batch, err.getvalue()


@pytest.fixture(scope="module")
def tracker():
    from zaru_tpu_torch.pipeline import FaceTracker

    return FaceTracker(device="cpu")


def test_fixture_is_current(stored, tmp_path):
    """JAX's exported step, cost reports and sidecar are what zaru_tpu
    gives now (the regen machine's rounding aside: 1e-4 px; the sidecars
    compared by content, as a zip's bytes hold its time of writing)."""
    from zaru_tpu.export import load_state

    now = jax_now()
    assert set(now) == set(stored)
    for k, v in now.items():
        if k == "sidecar":
            (tmp_path / "now.npz").write_bytes(v.tobytes())
            (tmp_path / "stored.npz").write_bytes(stored[k].tobytes())
            a, b = load_state(tmp_path / "now.npz"), load_state(tmp_path / "stored.npz")
            assert torch.utils._pytree.tree_structure(a) == torch.utils._pytree.tree_structure(b)
            for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
                np.testing.assert_array_equal(x, y)
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(stored[k], v, rtol=0, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


def _ops_cases():
    from zaru_tpu_torch.ops.cnn_stage import fused_blocks, pack_blocks
    from zaru_tpu_torch.ops.letterbox import letterbox_sample
    from zaru_tpu_torch.ops.rotated_fast import rotated_sample_fast
    from zaru_tpu_torch.ops.yuv import rgb_to_yuv_fast

    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 40, 56, 4), dtype=np.uint8))
    rects = torch.tensor([[[20.0, 18, 30, 24, 0.4], [30, 20, 16, 16, -0.2]]] * 2)
    C = 16
    blocks = [{"dw_w": rng.normal(size=(C, 1, 3, 3)), "dw_b": rng.normal(size=C), "pw_w": rng.normal(size=(C, C, 1, 1)),
               "pw_b": rng.normal(size=C), "alpha": None if i else rng.normal(size=C)} for i in range(2)]
    packed = pack_blocks(blocks, C)
    x = torch.from_numpy(rng.normal(size=(2, C, 7, 9)).astype(np.float32))
    return {
        "rotated NHWC": lambda: rotated_sample_fast(frames, rects, 12, 8, -1.0, 1.0),
        "rotated planar, mirrored": lambda: rotated_sample_fast(frames, rects, 12, 8, 0.0, 1.0, 256, "NCHW",
                                                                (False, True)),
        "letterbox NHWC": lambda: letterbox_sample(frames, rects[:, 0], 16, 12, -1.0, 1.0),
        "letterbox planar": lambda: letterbox_sample(frames, rects[:, 0], 16, 12, -1.0, 1.0, "NCHW"),
        "stage NCHW": lambda: fused_blocks(x, packed, 7, 9, C),
        "stage channels_last": lambda: fused_blocks(x.contiguous(memory_format=torch.channels_last), packed, 7, 9, C),
        "RGB to YUV": lambda: rgb_to_yuv_fast(torch.from_numpy(rng.uniform(0, 1, (5, 6, 3)).astype(np.float32))),
    }


@pytest.mark.parametrize("case", list(_ops_cases()))
def test_fake_kernel_matches_real(case):
    """Each registered op's fake kernel gives its real output's shape,
    dtype and memory format: FakeTensorMode (export, analysis) sees what
    the CPU kernel computes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn = _ops_cases()[case]
    real = fn()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = fn()
    assert (tuple(fake.shape), fake.dtype) == (tuple(real.shape), real.dtype)
    assert fake.is_contiguous(memory_format=torch.channels_last) == real.is_contiguous(
        memory_format=torch.channels_last) or real.ndim != 4
    assert fake.is_contiguous() == real.is_contiguous()


def test_kernels_are_registered_ops():
    """The four kernels are torch.library ops with CPU and CUDA kernels;
    a traced step calls them as ops (no ctypes call is reachable from a
    graph)."""
    for name in ("rotated_sample", "letterbox_sample", "blaze_stage", "rgb_to_yuv"):
        op = getattr(torch.ops.zaru_tpu_torch, name).default
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CPU), name
        assert op.has_kernel_for_dispatch_key(torch._C.DispatchKey.CUDA), name


def test_eager_step_goes_through_torch_cond(tracker, monkeypatch):
    """The eager gated step takes its ROI sources from torch.cond over the
    branches, with the host-read predicate, and equals the branches called
    directly (the step before torch.cond) bit for bit."""
    calls = []
    real_cond = torch.cond

    def spy(pred, true_fn, false_fn, operands):
        calls.append(pred)
        return real_cond(pred, true_fn, false_fn, operands)

    monkeypatch.setattr(torch, "cond", spy)
    frames = torch.from_numpy(np.stack([photo_rgba()[::4, ::4]] * 2).copy())
    state = tracker.init_state(2)
    with torch.inference_mode():
        for force in (False, True, False):
            before = state
            state, out = tracker.step_batch(state, frames, force)
            tr = before["tracking"]
            sources = (tracker._kept(before["roi"], tr, frames) if not force and bool(tr.all())
                       else tracker._detect_lost(before["roi"], tr, frames))
            _, want = tracker._track_batch(before, frames, *sources, exact=False, eyes_exact=False)
            assert all(torch.equal(out[k], want[k]) for k in want)
    assert calls == [False, False, True]


def test_export_roundtrip_cli(artifacts):
    """`export --verify` writes the artifact (weights baked in), its
    sidecar and manifest, reloads it and runs it (test_cli.py's
    test_export_roundtrip, test_export_writes_manifest; the device takes
    the place of --platforms)."""
    single, batch, err = artifacts
    assert "exported face single-stream step for 720x1280 frames for device cpu" in err
    assert "verify: reloaded and ran" in err and "landmarks" in err
    assert single.stat().st_size > 1_000_000  # the weights are baked in
    meta = json.loads((single.parent / "step.pt2.manifest.json").read_text())
    assert meta["pipeline"] == "face" and meta["batch"] == 0 and meta["frame_shape"] == [720, 1280, 4]
    assert meta["framework"] == "zaru_tpu_torch" and meta["torch_version"] == torch.__version__
    assert meta["platforms"] == ["cpu"] and meta["framework_version"] and "jax_version" not in meta
    bmeta = json.loads((batch.parent / "batch2.pt2.manifest.json").read_text())
    assert bmeta["batch"] == 2 and bmeta["frame_shape"] == [2, 535, 535, 4] and bmeta["state_leaves"] == 5


def test_exported_steps_equal_eager(artifacts, tracker):
    """The reloaded programs are the eager steps bit for bit on the CPU:
    the single-stream step over PLAN (detect, track, loss, redetect) and the
    batch-2 gated step with a forced and an unforced detection."""
    from zaru_tpu_torch.export import load_exported

    single, batch, _ = artifacts
    call = load_exported(single)
    se = sx = tracker.init_state()
    for frame in plan_frames():
        f = torch.from_numpy(frame)
        with torch.inference_mode():
            se, oe = tracker.step(se, f)
        sx, ox = call(sx, f)
        assert all(torch.equal(oe[k], ox[k]) for k in oe)
    call = load_exported(batch)
    crop = photo_rgba()[100:635, 380:915]
    frames = torch.from_numpy(np.stack([crop, crop[:, ::-1]]).copy())
    se = sx = tracker.init_state(2)
    for _ in range(3):
        se, oe = tracker.step_batch(se, frames)
        sx, ox = call(sx, frames)
        assert all(torch.equal(oe[k], ox[k]) for k in oe)
    assert bool(ox["valid"].all())


def test_exported_step_matches_jax(artifacts, stored):
    """The exported program against JAX's exported program over PLAN: one
    step at a time from JAX's state within STEP_TOL_PX (flags equal), and
    free-running with flags equal and landmarks within FREE_TOL_PX."""
    from zaru_tpu_torch.export import load_exported

    call = load_exported(artifacts[0])
    frames = plan_frames()
    state = None
    for i, frame in enumerate(frames):
        jax_state = nested_state({k[len("state/"):]: v[i] for k, v in stored.items() if k.startswith("state/")})
        _, one = call(jax_state, frame)
        state, free = call(state if state is not None else jax_state, frame)
        for out, tol in ((one, STEP_TOL_PX), (free, FREE_TOL_PX)):
            assert bool(out["valid"]) == bool(stored["out/valid"][i]), i
            if bool(stored["out/valid"][i]):
                np.testing.assert_allclose(out["landmarks"].numpy(), stored["out/landmarks"][i], rtol=0, atol=tol)
        if bool(stored["out/valid"][i]):
            np.testing.assert_allclose(one["roi"].numpy(), stored["out/roi"][i], rtol=0, atol=STEP_TOL_PX)
    assert stored["out/valid"].tolist() == [True, True, False, True]


def test_sidecars_cross_packages(stored, tracker, tmp_path):
    """JAX's sidecar loads in the port leaf for leaf as the port's own
    batch-2 state, and the port's loads in JAX's ``load_state``; the
    container kinds, empty subtrees and None round-trip; the loader refuses
    pickles, unknown formats and other npz files (test_analysis_export.py's
    sidecar cases)."""
    import pickle

    from zaru_tpu.export import load_state as jax_load_state

    from zaru_tpu_torch.export import load_state, save_state

    jax_file = tmp_path / "jax.npz"
    jax_file.write_bytes(stored["sidecar"].tobytes())
    mine = tracker.init_state(2)
    back = load_state(jax_file)
    assert torch.utils._pytree.tree_structure(back) == torch.utils._pytree.tree_structure(mine)
    for a, b in zip(torch.utils._pytree.tree_leaves(back), torch.utils._pytree.tree_leaves(mine)):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    port_file = tmp_path / "port.state"  # no .npz suffix: written through a handle
    save_state({**mine, "extra": (torch.arange(3), [torch.zeros(2), None]), "empty": {}, "n": None}, port_file)
    jb = jax_load_state(port_file)
    np.testing.assert_array_equal(jb["roi"], mine["roi"].numpy())
    assert isinstance(jb["extra"], tuple) and isinstance(jb["extra"][1], list) and jb["extra"][1][1] is None
    assert jb["empty"] == {} and jb["n"] is None
    with np.load(port_file, allow_pickle=False) as data:
        assert "__tree__" in data.files and all(data[n].dtype != object for n in data.files)
    legacy = tmp_path / "legacy.npz"
    np.savez(legacy, __treedef__=np.frombuffer(pickle.dumps({"x": 1}), np.uint8), leaf_0=np.zeros(2))
    with pytest.raises(ValueError, match="legacy pickle-based"):
        load_state(legacy)
    tampered = tmp_path / "tampered.npz"
    np.savez(tampered, __format__=np.int64(2), __tree__=np.str_('{"kind":"leaf","i":0}'),
             leaf_0=np.array({"attack": "payload"}, dtype=object))
    with pytest.raises(ValueError):
        load_state(tampered)
    future = tmp_path / "future.npz"
    np.savez(future, __format__=np.int64(99), __tree__=np.str_('{"kind":"leaf","i":0}'), leaf_0=np.zeros(1))
    with pytest.raises(ValueError, match="unsupported sidecar format"):
        load_state(future)
    other = tmp_path / "random.npz"
    np.savez(other, x=np.zeros(3))
    with pytest.raises(ValueError, match="not a zaru_tpu state sidecar"):
        load_state(other)


def test_run_exported_deployment_loop(artifacts, tmp_path):
    """run-exported with the artifact and its sidecar alone tracks the
    fixture photo (test_cli.py's test_run_exported_deployment_loop)."""
    from zaru_tpu_torch.__main__ import main

    out = tmp_path / "out.jsonl"
    assert main(["run-exported", str(artifacts[0]), PHOTO, "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["valid"] is True and recs[0]["frame"] == 0
    assert np.asarray(recs[0]["landmarks"]).shape == (468, 3)


def test_run_exported_batch_artifact(artifacts, tmp_path):
    """A batch artifact gathers N frames a step; a short last step is
    padded and says so (test_cli.py's test_run_exported_batch_artifact)."""
    from zaru_tpu_torch.__main__ import main

    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for i in range(3):
        shutil.copy(CROPPED, imgdir / f"{i}.jpg")
    out = tmp_path / "out.jsonl"
    assert main(["run-exported", str(artifacts[1]), str(imgdir), "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2
    assert recs[0]["valid"] == [True, True] and "padded" not in recs[0]
    assert recs[1]["padded"] == 1 and recs[1]["frames"] == 2


def _copy(artifact, d):
    """The artifact with its sidecar and manifest, copied into ``d``."""
    for suffix in ("", ".state.npz", ".manifest.json"):
        shutil.copy(f"{artifact}{suffix}", d / f"{artifact.name}{suffix}")
    return d / artifact.name


def test_run_exported_refuses_mismatches(artifacts, tmp_path):
    """Checked before the frame loop, each with one line: a manifest that
    disagrees with the program, a sidecar of another artifact, and frames
    of another size (test_cli.py's tampered-manifest, stale-state and
    shape-mismatch cases)."""
    from zaru_tpu_torch.__main__ import main

    single, batch, _ = artifacts
    art = _copy(single, tmp_path)
    mpath = tmp_path / f"{art.name}.manifest.json"
    meta = json.loads(mpath.read_text())
    meta["frame_shape"] = [128, 128, 4]
    mpath.write_text(json.dumps(meta))
    with pytest.raises(SystemExit, match="manifest"):
        main(["run-exported", str(art), PHOTO])
    with pytest.raises(SystemExit, match="sidecar"):
        main(["run-exported", str(single), PHOTO, "--state", f"{batch}.state.npz"])
    with pytest.raises(SystemExit, match="exported signature"):
        main(["run-exported", str(single), CROPPED])


def test_export_options_and_shard(tmp_path, capsys):
    """--iris only with the face pipeline; --shard serves (one CPU shard
    with ``--device cpu``; tests/test_torch_serve.py holds its records)."""
    from zaru_tpu_torch.__main__ import main

    with pytest.raises(SystemExit):
        main(["export", str(tmp_path / "x.pt2"), "--pipeline", "hand", "--iris", "--device", "cpu"])
    out = tmp_path / "serve.jsonl"
    assert main(["serve", CROPPED, "--streams", "2", "--steps", "1", "--shard", "--device", "cpu",
                 "--out", str(out)]) == 0
    assert "sharding 2 streams over 1 cpu devices" in capsys.readouterr().err
    assert len(out.read_text().splitlines()) == 1


def test_analysis_matches_jax(stored):
    """``analyze`` on the three models: parameters, bytes and output shapes
    equal to JAX's, FLOPs within FLOPS_RTOL of XLA's count (module
    docstring), the same with and without a stage plan, and the speed of
    light at the H100's f32 rate."""
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import NeuralNetwork
    from zaru_tpu_torch.onnx.analysis import analyze

    shapes = json.loads(str(stored["output_shapes"]))
    for i, blob in enumerate(MODELS):
        net = NeuralNetwork.load(model_path(blob), device="cpu")
        rep = analyze(net)
        assert (rep.params, rep.param_bytes) == (stored["params"][i], stored["param_bytes"][i]), blob
        assert [list(s) for s in rep.output_shapes] == shapes[i], blob
        np.testing.assert_allclose(rep.flops, stored["flops"][i], rtol=FLOPS_RTOL, err_msg=blob)
        m = net.module
        planned = len(m.stages)
        with m.without_plans():  # the same graph, node by node
            assert analyze(net).flops == rep.flops, blob
        assert planned or blob == "slim_160_latest.onnx"
        assert rep.speed_of_light_us() == pytest.approx(rep.flops / 67e12 * 1e6)
        assert "@67TF" in str(rep) and "GFLOP" in str(rep)


@pytest.mark.parametrize("case", ["Resize with host-computed sizes", "Div by a host-computed value",
                                  "Resize linear 8x8 to 3x7"])
def test_analysis_leaves_the_module_usable(case):
    """``analyze`` runs the module under FakeTensorMode; the tensors the
    executor keeps from call to call (resize weights, host-computed values
    on the device) stay real, so the next eager call still gives JAX's
    stored outputs (onnx_dialect.npz)."""
    from zaru_tpu_torch.nn import NeuralNetwork
    from zaru_tpu_torch.onnx import dialect_cases
    from zaru_tpu_torch.onnx.analysis import analyze

    c = dialect_cases.load("ops/")[case]
    net = NeuralNetwork.load(c["graph"], device="cpu")
    assert analyze(net).output_shapes
    with torch.no_grad():
        outs = net.module(*[torch.from_numpy(x) for x in c["ins"]])
    for got, want in zip(outs, c["outs"]):
        ok, err = dialect_cases.compare(got.numpy(), want, c["tol"])
        assert ok, (case, err)


def test_profiling_hooks(tmp_path):
    """trace() writes a Chrome trace naming the kernels' ops and the
    annotated range."""
    from zaru_tpu_torch.ops.cnn_stage import fused_blocks, pack_blocks
    from zaru_tpu_torch.profiling import annotate, trace

    rng = np.random.default_rng(0)
    C = 16
    packed = pack_blocks([{"dw_w": rng.normal(size=(C, 1, 3, 3)), "dw_b": rng.normal(size=C),
                           "pw_w": rng.normal(size=(C, C, 1, 1)), "pw_b": rng.normal(size=C), "alpha": None}], C)
    x = torch.zeros(1, C, 5, 5)
    with trace(tmp_path / "prof"):
        with annotate("stage call"):
            fused_blocks(x, packed, 5, 5, C)
    (trace_file,) = (tmp_path / "prof").glob("*.json")
    text = trace_file.read_text()
    assert "zaru_tpu_torch::blaze_stage" in text and "stage call" in text


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen()
