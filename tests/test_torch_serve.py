"""The port's serving entry points (zaru_tpu_torch.serve, pipeline.ingest,
``python -m zaru_tpu_torch``) on the CPU.

- Host policies: the port's ``StreamSet``/``ServeStats`` against zaru_tpu's
  on the same scripted sources, one case per scenario of
  tests/test_serve.py's unit classes. Each scenario is run through both
  packages and its transcript (prime events, each gather's first pixel per
  slot and events, the slots' active/drop/served counts, joins, leaves, the
  stats line and summary with their clock-dependent numbers masked, or the
  error raised) is held equal.
- ``reset_state_slots`` bit-equal to JAX's on the same state, nested too,
  with the caller's state left as it was.
- ``FrameUploader`` and ``measure_ingest_bandwidth`` on the CPU.
- ``serve_loop`` on in-memory sources: its records bit-equal to the
  tracker's own ``run_frames_gated`` (``run_frame`` at one stream) on the
  same frames, and a join's slot reset to a fresh state.
- The CLI, as tests/test_cli.py and tests/test_serve.py drive zaru_tpu's,
  with ``--device cpu`` (``serve --shard`` over one CPU shard, and over two
  with the mesh replaced); without it, and without a GPU, it raises.

No JAX program is compiled here: the JAX side is the host policy classes
and ``reset_state_slots``, which run in numpy.
"""

import json
import re
import shutil

import numpy as np
import pytest
import torch

import zaru_tpu.serve as jserve
import zaru_tpu_torch.serve as tserve
from torch_port import one_torch_thread  # noqa: F401


def frames_source(n, value, shape=(4, 4, 4)):
    def factory():
        for _ in range(n):
            yield np.full(shape, value, np.uint8)

    factory.name = f"src{value}x{n}"
    return factory


class FlakyIter:
    """One good frame, one OSError, then good frames again, then the end:
    a camera hiccup, not a dead source."""

    def __init__(self):
        self.n = 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n == 2:
            raise OSError("truncated jpeg")
        if self.n > 5:
            raise StopIteration
        return np.full((4, 4, 4), 1 if self.n == 1 else 3, np.uint8)


def flaky_factory():
    return FlakyIter()


flaky_factory.name = "flaky"


def dying_factory():
    yield np.full((4, 4, 4), 1, np.uint8)
    raise OSError("device unplugged")


dying_factory.name = "dying"

# name: (initial sources, pending sources, gathers, stats steps (dt,
# n_active, n_dropped))
SCENARIOS = {
    "leave_then_join_from_pending": (
        lambda: [frames_source(2, 1), frames_source(5, 2)], lambda: [frames_source(3, 7)], 4, ()),
    "exhausted_slot_goes_inactive": (
        lambda: [frames_source(1, 3), frames_source(7, 5)], lambda: [], 5, ()),
    "corrupt_decode_counts_drop": (
        lambda: [flaky_factory, frames_source(9, 2)], lambda: [], 4, ()),
    "dead_generator_leaves_cleanly": (
        lambda: [dying_factory, frames_source(9, 2)], lambda: [], 4, ()),
    "midrun_join_rejects_wrong_resolution": (
        lambda: [frames_source(1, 1), frames_source(6, 2)],
        lambda: [frames_source(3, 7, shape=(8, 8, 4)), frames_source(3, 9)], 4, ()),
    "prime_rejects_mixed_resolutions": (
        lambda: [frames_source(2, 1), frames_source(2, 2, shape=(8, 8, 4))], lambda: [], 0, ()),
    "empty_slot_primed_from_pending": (
        lambda: [frames_source(2, 1), None], lambda: [frames_source(2, 4)], 2, ()),
    "fresh_frames_exclude_drops": (
        lambda: [frames_source(4, 1), frames_source(4, 2)], lambda: [],
        2, ((0.01, 2, 0), (0.01, 2, 1), (0.02, 2, 0))),
}

_CLOCK = re.compile(r"[0-9.]+(e[+-]?[0-9]+)?( ?(frames/s|ms|s)\b)")


def _masked(line: str) -> str:
    """A stats line with its clock-dependent numbers (rates, times) masked."""
    return _CLOCK.sub(r"#\2", line)


def transcript(mod, name):
    """Scenario ``name`` through ``mod``'s StreamSet and ServeStats."""
    initial, pending, gathers, steps = SCENARIOS[name]
    ss = mod.StreamSet(initial(), pending=pending())
    ev = lambda events: [(e.slot, e.kind, e.source) for e in events]  # noqa: E731
    out = {}
    try:
        out["prime"] = ev(ss.prime())
    except RuntimeError as e:
        ss.close()
        return {"prime_error": str(e)}
    out["gathers"] = []
    for _ in range(gathers):
        frames, events = ss.gather(wait=1.0)
        out["gathers"].append(([int(f.reshape(-1)[0]) for f in frames], [f.shape for f in frames], ev(events)))
    out.update(active=list(ss.active), drops=list(ss.drops), served=list(ss.served), joins=ss.joins,
               leaves=ss.leaves, n_active=ss.n_active)
    stats = mod.ServeStats(streams=ss.slots)
    for dt, n_active, n_dropped in steps:
        stats.record_step(dt, n_active, n_dropped=n_dropped)
    out.update(frames=stats.frames, steps=stats.steps, p50=stats._pct(50), p95=stats._pct(95),
               report=_masked(stats.report_line(ss)), summary=_masked(stats.summary(ss)))
    ss.close()
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_stream_policies_match_jax(name):
    """The scenario gives the same transcript in both packages."""
    got, want = transcript(tserve, name), transcript(jserve, name)
    assert got == want
    if name == "fresh_frames_exclude_drops":
        assert got["frames"] == 5 and "5 fresh frames" in got["summary"]
    if name == "prime_rejects_mixed_resolutions":
        assert "one resolution" in got["prime_error"]


def test_reset_state_slots_matches_jax():
    """On the same state (nested dicts, a leading stream axis) the port's
    reset equals JAX's bit for bit, at one slot and at two; the caller's
    tensors are left as they were, and no slot returns the state itself."""
    rng = np.random.default_rng(4)
    state = {"roi": rng.normal(size=(3, 5)).astype(np.float32), "tracking": np.array([True, True, True]),
             "filter": {"x": rng.normal(size=(3, 7, 3)).astype(np.float32),
                        "init": np.ones((3, 7, 3), bool)}}
    fresh = {"roi": np.zeros((3, 5), np.float32), "tracking": np.zeros(3, bool),
             "filter": {"x": np.zeros((3, 7, 3), np.float32), "init": np.zeros((3, 7, 3), bool)}}

    def torch_tree(t):
        return {k: torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in t.items()}

    def flat(t, prefix=""):
        for k, v in t.items():
            yield from flat(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    for slots in ([1], [0, 2]):
        tstate = torch_tree(state)
        before = {k: v.clone() for k, v in flat(tstate)}
        got = dict(flat(tserve.reset_state_slots(tstate, torch_tree(fresh), slots)))
        want = dict(flat(jserve.reset_state_slots(state, fresh, slots)))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        for k, v in flat(tstate):
            assert torch.equal(v, before[k]), k
    assert tserve.reset_state_slots(tstate, torch_tree(fresh), []) is tstate


def test_reset_state_slots_makes_tracker_slot_redetect():
    """Resetting slot 0 of a live FaceTracker state clears its tracking flag
    and filter, so the next gated step detects for that stream; slot 1
    keeps its state."""
    from zaru_tpu_torch.pipeline import FaceTracker

    tracker = FaceTracker(device="cpu")
    fresh = tracker.init_state(batch=2)
    live = {"roi": torch.ones((2, 5)), "tracking": torch.tensor([True, True]),
            "filter": {k: torch.ones_like(v) if v.dtype != torch.bool else torch.ones_like(v)
                       for k, v in fresh["filter"].items()}}
    out = tserve.reset_state_slots(live, fresh, [0])
    assert out["tracking"].tolist() == [False, True]
    assert torch.equal(out["roi"][0], fresh["roi"][0]) and torch.equal(out["roi"][1], live["roi"][1])
    for k, v in out["filter"].items():
        assert torch.equal(v[0], fresh["filter"][k][0]) and torch.equal(v[1], live["filter"][k][1]), k


def test_frame_uploader_round_trips_double_buffered():
    """2K flushes with the frames changed between them: each flush's device
    batch equals what was staged, and stays so until the flush after next
    (the double buffer); the host time counters advance."""
    from zaru_tpu_torch.pipeline.ingest import FrameUploader

    rng = np.random.default_rng(2)
    up = FrameUploader(batch=3, shape=(6, 5, 4), device="cpu")
    previous = None
    for _ in range(2 * 4):
        staged = rng.integers(0, 256, (3, 6, 5, 4), dtype=np.uint8)
        for slot in range(3):
            up.stage(slot, staged[slot])
        dev = up.flush()
        assert dev.dtype == torch.uint8 and tuple(dev.shape) == (3, 6, 5, 4)
        np.testing.assert_array_equal(dev.numpy(), staged)
        if previous is not None:
            np.testing.assert_array_equal(previous[0].numpy(), previous[1])
        previous = (dev, staged)
    assert up.stage_seconds > 0 and up.flush_seconds > 0
    with pytest.raises(ValueError):
        up.stage(0, np.zeros((5, 6, 4), np.uint8))


def test_ingest_bandwidth_and_device_rule(monkeypatch):
    """``measure_ingest_bandwidth`` returns both rates; the uploader with no
    device and no GPU raises instead of staging for the CPU."""
    from zaru_tpu_torch.pipeline.ingest import FrameUploader, measure_ingest_bandwidth

    got = measure_ingest_bandwidth(batch=2, shape=(8, 8, 4), iters=3, device="cpu")
    assert set(got) == {"gbytes_per_s", "frames_per_s"} and got["frames_per_s"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameUploader(2, (4, 4, 4))


# --- the serve loop on in-memory sources -----------------------------------


@pytest.fixture(scope="module")
def photo_small():
    """The cropped fixture photo (decoded by the port) as RGBA u8."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.image import Image

    return Image.load(fixture_path("sad_linus_cropped.jpg"), "cpu").to_numpy()


@pytest.fixture(scope="module")
def face_tracker():
    from zaru_tpu_torch.pipeline import FaceTracker

    return FaceTracker(device="cpu")


def shifted(rgba, stream, t):
    """Stream ``stream``'s frame ``t``: the photo shifted a few pixels, so a
    slot mix-up or a stale frame shows."""
    return np.roll(rgba, (3 * stream + t, 2 * t), axis=(0, 1))


def memory_source(rgba, stream, n):
    def factory():
        for t in range(n):
            yield shifted(rgba, stream, t)

    factory.name = f"memory{stream}"
    return factory


def run_loop(tracker, streams, batch, steps, single=False, no_loop=False):
    from zaru_tpu_torch.pipeline.ingest import FrameUploader

    streams.prime()
    up = FrameUploader(batch, streams.frames[0].shape, device="cpu")
    recs, outs, lines = [], [], []
    stats = tserve.serve_loop(
        tracker, streams, up, single=single, steps=steps, landmarks=True, no_loop=no_loop,
        emit=lambda rec, out: (recs.append(json.loads(json.dumps(rec))), outs.append(out)),
        log=lines.append, report_every=2,
    )
    streams.close()
    return recs, outs, lines, stats


def record_of(step, out):
    """The serve loop's record schema for outputs with a stream axis."""
    rec = {"step": step, "valid": out["valid"].numpy().tolist(),
           "confidence": np.round(out["confidence"].numpy(), 4).tolist(),
           "landmarks": out["landmarks"].numpy().tolist()}
    return json.loads(json.dumps(rec))


def test_serve_loop_equals_run_frames_gated(photo_small, face_tracker):
    """Two looping in-memory streams over 3 steps: the loop's records and
    outputs equal ``run_frames_gated`` called directly on the same frames,
    bit for bit; the stats line and summary come out, the summary with the
    program's counters over the loop: 7 host syncs in 3 steps (the gate
    each step, the letterbox fit on the first, which detects, and each
    step's output reads)."""
    streams = tserve.StreamSet([memory_source(photo_small, s, 3) for s in range(2)])
    recs, outs, lines, stats = run_loop(face_tracker, streams, 2, 3)
    state = face_tracker.init_state(batch=2)
    for t in range(3):
        frames = torch.from_numpy(np.stack([shifted(photo_small, s, t) for s in range(2)]))
        state, out = face_tracker.run_frames_gated(state, frames)
        for k in ("valid", "confidence", "landmarks"):
            assert torch.equal(outs[t][k], out[k]), (t, k)
        assert recs[t] == record_of(t, out)
    assert all(r["valid"] == [True, True] for r in recs)
    assert any("frames/s e2e" in line for line in lines)
    summary = stats.summary(streams)
    assert stats.frames == 6 and "6 fresh frames" in summary
    assert summary.endswith("; host syncs 2.33/step, host copies 0, detect steps 1, kernel builds 0")


def test_serve_loop_single_stream_equals_run_frame(photo_small, face_tracker):
    """One stream takes ``run_frame`` and keeps the batch schema (a leading
    stream axis): equal to ``run_frame`` called directly, bit for bit."""
    streams = tserve.StreamSet([memory_source(photo_small, 0, 3)])
    recs, outs, _, _ = run_loop(face_tracker, streams, 1, 3, single=True)
    state = face_tracker.init_state()
    for t in range(3):
        state, out = face_tracker.run_frame(state, torch.from_numpy(shifted(photo_small, 0, t)))
        out = {k: v[None] for k, v in out.items()}
        for k in ("valid", "confidence", "landmarks"):
            assert torch.equal(outs[t][k], out[k]), (t, k)
        assert recs[t] == record_of(t, out)
    assert recs[0]["valid"] == [True]


class _Recording:
    """A tracker that records the state each gated step starts from."""

    def __init__(self, tracker):
        self.tracker, self.states = tracker, []

    def init_state(self, batch=None):
        return self.tracker.init_state(batch)

    def run_frames_gated(self, state, frames):
        self.states.append(state)
        return self.tracker.run_frames_gated(state, frames)


def test_serve_loop_join_resets_slot(photo_small, face_tracker):
    """``no_loop``: slot 0's source ends after 2 frames and the pending one
    joins it; the step after the join starts slot 0 from a fresh state
    (so it re-detects) and slot 1 from its carried one. The loop ends when
    every source is exhausted."""
    rec_tracker = _Recording(face_tracker)
    streams = tserve.StreamSet([memory_source(photo_small, 0, 2), memory_source(photo_small, 1, 4)],
                               pending=[memory_source(photo_small, 2, 1)])
    recs, _, lines, stats = run_loop(rec_tracker, streams, 2, 10, no_loop=True)
    assert "stream slot 0: leave" in lines and "stream slot 0: join (memory2)" in lines
    assert "all sources exhausted" in lines
    join_step = next(i for i, r in enumerate(recs) if r.get("active") == [True, True] and i > 0)
    fresh = face_tracker.init_state(batch=2)
    start = rec_tracker.states[join_step]
    carried = rec_tracker.states[join_step - 1]
    assert not bool(start["tracking"][0]) and bool(carried["tracking"][0])
    assert torch.equal(start["roi"][0], fresh["roi"][0])
    for k, v in start["filter"].items():
        assert torch.equal(v[0], fresh["filter"][k][0]), k
    assert bool(start["tracking"][1])
    assert recs[join_step]["valid"][0]  # the joined stream is found again
    assert streams.joins == 1 and streams.leaves >= 1 and len(recs) < 10


class _RecordingSingle:
    """A tracker that records the state each single-stream step starts
    from."""

    def __init__(self, tracker):
        self.tracker, self.states = tracker, []

    def init_state(self, batch=None):
        return self.tracker.init_state(batch)

    def run_frame(self, state, frame):
        self.states.append(state)
        return self.tracker.run_frame(state, frame)


def test_serve_loop_single_stream_join_resets_state(photo_small, face_tracker):
    """One stream, ``no_loop``: when its source ends and the pending one
    joins, the next step starts from the fresh state (tests/test_serve.py
    ``test_single_stream_join_resets_state``), and the joined stream is
    found again."""
    rec_tracker = _RecordingSingle(face_tracker)
    streams = tserve.StreamSet([memory_source(photo_small, 0, 2)], pending=[memory_source(photo_small, 1, 2)])
    recs, _, lines, _ = run_loop(rec_tracker, streams, 1, 8, single=True, no_loop=True)
    assert "stream slot 0: leave" in lines and "stream slot 0: join (memory1)" in lines
    join_step = next(i for i, r in enumerate(recs) if i > 0 and r.get("active") == [True])
    assert bool(rec_tracker.states[join_step - 1]["tracking"])
    assert not bool(rec_tracker.states[join_step]["tracking"])
    assert recs[join_step]["valid"] == [True]


# --- the CLI -------------------------------------------------------------------


def test_cli_serve_two_streams(tmp_path):
    """tests/test_cli.py ``test_serve_two_streams`` with ``--device cpu``."""
    from zaru_tpu_torch.__main__ import main
    from zaru_tpu_torch.assets import fixture_path

    out = tmp_path / "serve.jsonl"
    rc = main(["serve", str(fixture_path("sad_linus_cropped.jpg")), "--streams", "2", "--steps", "2",
               "--device", "cpu", "--out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(r["valid"] == [True, True] for r in recs)
    assert all(min(r["confidence"]) > 0.9 for r in recs)


def test_cli_serve_no_loop_join_leave(tmp_path, capsys):
    """tests/test_serve.py ``test_no_loop_join_leave`` with ``--device cpu``:
    two slots, three finite sources, the join reported, the loop ending
    early, ``--batch-program`` at one stream taking the gated step."""
    from zaru_tpu_torch.__main__ import main
    from zaru_tpu_torch.assets import fixture_path

    src = fixture_path("sad_linus_cropped.jpg")
    dirs = []
    for name, count in (("a", 1), ("b", 4), ("c", 2)):
        d = tmp_path / name
        d.mkdir()
        for i in range(count):
            shutil.copy(src, d / f"{i}.jpg")
        dirs.append(str(d))
    out = tmp_path / "serve.jsonl"
    rc = main(["serve", *dirs, "--streams", "2", "--steps", "8", "--no-loop", "--out", str(out),
               "--report-every", "2", "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "slot 0: leave" in err and "slot 0: join" in err
    assert "drops" in err and "active" in err
    assert "joins 1" in err and "leaves" in err
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) < 8
    assert any(r.get("active") == [True, True] for r in recs)
    assert recs[-1]["active"] in ([False, True], [False, False])
    batch = tmp_path / "batch.jsonl"
    assert main(["serve", str(src), "--streams", "1", "--steps", "2", "--batch-program", "--device", "cpu",
                 "--out", str(batch)]) == 0
    recs = [json.loads(line) for line in batch.read_text().splitlines()]
    assert all(r["valid"] == [True] and len(r["confidence"]) == 1 for r in recs)


def test_cli_serve_soak_runs_for_duration(tmp_path, capsys):
    """``--soak SECONDS`` runs for that long instead of ``--steps`` and ends
    with the summary (tests/test_serve.py ``test_soak_mode_runs_for_duration``,
    one second here)."""
    import time

    from zaru_tpu_torch.__main__ import main
    from zaru_tpu_torch.assets import fixture_path

    out = tmp_path / "soak.jsonl"
    t0 = time.perf_counter()
    assert main(["serve", str(fixture_path("sad_linus_cropped.jpg")), "--streams", "2", "--soak", "1",
                 "--device", "cpu", "--out", str(out)]) == 0
    assert time.perf_counter() - t0 >= 1.0
    assert len(out.read_text().splitlines()) >= 1
    assert "served" in capsys.readouterr().err


def test_cli_track_photo_and_animation(tmp_path):
    """tests/test_cli.py ``test_track_face_fixture`` with ``--device cpu``:
    468×3 landmarks inside the photo and an annotated JPEG; and a two-frame
    GIF of the cropped photo through the animation reader, one record a
    frame."""
    from PIL import Image as PILImage

    from zaru_tpu_torch.__main__ import main
    from zaru_tpu_torch.assets import fixture_path

    out, ann = tmp_path / "out.jsonl", tmp_path / "ann"
    assert main(["track", str(fixture_path("sad_linus.jpg")), "--out", str(out), "--annotate", str(ann),
                 "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["frame"] == 0 and recs[0]["valid"] is True
    lm = np.asarray(recs[0]["landmarks"])
    assert lm.shape == (468, 3)
    h, w = 1080, 1440
    assert (lm[:, 0] > 0).all() and (lm[:, 0] < w).all()
    assert (lm[:, 1] > 0).all() and (lm[:, 1] < h).all()
    assert (ann / "frame_00000.jpg").stat().st_size > 1000

    img = PILImage.open(fixture_path("sad_linus_cropped.jpg")).convert("RGB")
    gif = tmp_path / "two.gif"
    img.save(gif, save_all=True, append_images=[img.transpose(PILImage.FLIP_LEFT_RIGHT)], duration=40)
    out = tmp_path / "gif.jsonl"
    assert main(["track", str(gif), "--out", str(out), "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["frame"] for r in recs] == [0, 1] and all(r["valid"] for r in recs)


def test_cli_info_lists_every_model(capsys):
    """``info`` names the runtime and every model blob of JAX's inventory,
    the missing pose blobs as missing."""
    from zaru_tpu.__main__ import _KNOWN_MODELS as JAX_MODELS
    from zaru_tpu_torch.__main__ import _KNOWN_MODELS, main

    assert _KNOWN_MODELS == JAX_MODELS
    assert main(["info"]) == 0
    text = capsys.readouterr().out
    assert text.startswith(f"torch {torch.__version__}")
    for wrapper, blob in _KNOWN_MODELS:
        assert wrapper in text and blob in text
    assert "pose_detection.onnx" in text and "MISSING" in text


def test_cli_refuses_shard_and_needs_a_device(monkeypatch):
    """``--shard`` refuses a stream count the mesh does not divide
    (tests/test_cli.py ``test_serve_shard_rejects_indivisible``; a mesh of
    three CPU shards stands in for a host with three cards); without
    ``--device`` and without a GPU the commands raise instead of running on
    the CPU."""
    import zaru_tpu_torch.parallel as parallel
    from zaru_tpu_torch.__main__ import main
    from zaru_tpu_torch.assets import fixture_path

    with monkeypatch.context() as m:
        m.setattr(parallel, "stream_mesh", lambda devices=None: (torch.device("cpu"),) * 3)
        with pytest.raises(SystemExit, match="divide evenly"):
            main(["serve", "x.jpg", "--streams", "2", "--shard", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["track", "x.mp4", "--pipeline", "hand", "--iris", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    photo = str(fixture_path("sad_linus_cropped.jpg"))
    for argv in (["track", photo], ["serve", photo, "--streams", "2", "--steps", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_cli_serve_shard(tmp_path, capsys, monkeypatch):
    """``serve --shard --device cpu`` (tests/test_cli.py
    ``test_serve_sharded``): one CPU shard, the ``sharding`` line on stderr,
    and records equal to those of serving without ``--shard``; over a mesh
    of two CPU shards the streams are served shard by shard through the
    sharded uploader and found in every record."""
    import zaru_tpu_torch.parallel as parallel
    from zaru_tpu_torch.__main__ import main
    from zaru_tpu_torch.assets import fixture_path

    photo = str(fixture_path("sad_linus_cropped.jpg"))
    args = ["serve", photo, "--streams", "2", "--steps", "3", "--device", "cpu", "--landmarks"]
    plain, sharded = tmp_path / "plain.jsonl", tmp_path / "sharded.jsonl"
    assert main([*args, "--out", str(plain)]) == 0
    capsys.readouterr()
    assert main([*args, "--shard", "--out", str(sharded)]) == 0
    assert "sharding 2 streams over 1 cpu devices" in capsys.readouterr().err
    recs = [json.loads(line) for line in sharded.read_text().splitlines()]
    assert recs == [json.loads(line) for line in plain.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2] and all(r["valid"] == [True, True] for r in recs)
    monkeypatch.setattr(parallel, "stream_mesh", lambda devices=None: (torch.device("cpu"),) * 2)
    two = tmp_path / "two.jsonl"
    assert main(["serve", photo, "--streams", "4", "--steps", "2", "--device", "cpu", "--shard",
                 "--out", str(two)]) == 0
    assert "sharding 4 streams over 2 cpu devices" in capsys.readouterr().err
    recs = [json.loads(line) for line in two.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and all(r["valid"] == [True] * 4 for r in recs)
    assert all(min(r["confidence"]) > 0.9 for r in recs)
