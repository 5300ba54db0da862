"""The port's stream sharding and data-parallel training
(zaru_tpu_torch.parallel, train.make_data_parallel_train_step) against
zaru_tpu's, on the CPU.

JAX's tests run its ``ShardedFaceTracker`` over eight virtual CPU devices
(tests/conftest.py); the port's run over a mesh of eight ``cpu`` shards
(``stream_mesh(["cpu"] * 8)``). Both take the same frames: the stored photo
(``sad_linus_track.npz``) at half size, 360×640, shifted 8 px a stream, and
streams BLANK black, so that some shards lose their face and detect every
step while the others track (each shard has its own gate). JAX's runs are
stored in ``zaru_tpu_torch/fixtures/parallel.npz``:

- ``step``: ``ShardedFaceTracker(FaceTracker()).step`` (JAX's
  ``shard_map(vmap(step))``), batch 8, STEPS steps;
- ``gated``: ``step_gated`` (``shard_map(step_batch)``), batch 8, STEPS
  steps;
- ``bucket``: ``FaceTracker(smooth=None, redetect_bucket=1)``, 16 streams
  over 8 shards, all lost at the start, two gated steps: each shard drains
  one lost stream a step (8 acquired, then 16; tests/test_parallel.py:67);
- ``multi``: ``ShardedTracker(MultiFaceTracker(max_faces=2))``, batch 8,
  STEPS gated steps;
- ``train``: ``make_data_parallel_train_step`` on slim_160 over the 8
  devices (tests/test_parallel.py:95's recipe): TRAIN_STEPS losses and the
  gradient of the first step's global-mean loss for a few parameters.

The port is held to them: flags equal at every step, landmarks within
FREE_TOL_PX (the cascade feeds each step's landmarks into the next ROI, so
small CNN differences grow; tests/test_torch_face_cascade.py); each shard's
outputs and state bit-equal to that shard's own ``step_batch`` /
``run_frames`` on its slice; the training step's first loss and gradient
within tests/test_torch_train.py's tolerances, its losses falling.
``test_fixture_is_current`` runs JAX again, in the test process.
Regenerate the fixture with::

    JAX_PLATFORMS=cpu python tests/test_torch_parallel.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "zaru_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "parallel.npz")
SHARDS, BATCH, STEPS = 8, 8, 3
BLANK = (3, 6)  # streams with no face
# Free-running landmarks against JAX's sharded run (px); see the docstring.
FREE_TOL_PX = 8.0
TRAIN_BLOB, TRAIN_STEPS, TRAIN_LR = "slim_160_latest.onnx", 6, 1e-4
# tests/test_torch_train.py's tolerances (its docstring says why).
FIRST_LOSS_RTOL, GRAD_TOL, LOSS_RTOL = 1e-5, 1e-4, 0.1


def photo_frames(batch: int) -> np.ndarray:
    """``[batch, 360, 640, 4] u8``: the stored photo at half size, stream
    ``i`` shifted ``8 i`` px to the right, the streams in BLANK black."""
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        rgb = f["rgb"][::2, ::2]
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    frames = np.stack([np.roll(rgba, 8 * i, axis=1) for i in range(batch)])
    frames[[i for i in BLANK if i < batch]] = 0
    return frames


def train_data():
    """tests/test_parallel.py:95's batch: x ``[8,3,160,160]`` in [-1, 1],
    y ``[8,143]`` in [0, 1], from seed 0."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(BATCH, 3, 160, 160)).astype(np.float32)
    y = rng.uniform(0, 1, size=(BATCH, 143)).astype(np.float32)
    return x, y


def kept_names(params: dict) -> list:
    """The parameters whose gradients are stored: the first and last by
    name of each rank, among those of at most 4096 values."""
    names = sorted((k for k in params if np.size(params[k]) <= 4096), key=lambda k: (np.ndim(params[k]), k))
    firsts = {}
    for k in names:
        firsts.setdefault(np.ndim(params[k]), []).append(k)
    return sorted({ks[i] for ks in firsts.values() for i in (0, -1)})


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_tracker_run(name: str) -> dict:
    """One of zaru_tpu's sharded runs over 8 virtual devices →
    ``{f"{step}/out/{key}": array, f"{step}/state/{key}": array}``."""
    import jax
    import jax.numpy as jnp

    from zaru_tpu.parallel import ShardedTracker, stream_mesh
    from zaru_tpu.pipeline import FaceTracker, MultiFaceTracker

    mesh = stream_mesh(jax.devices()[:SHARDS])
    batch, steps = (16, 2) if name == "bucket" else (BATCH, STEPS)
    tracker = {
        "step": lambda: FaceTracker(), "gated": lambda: FaceTracker(),
        "bucket": lambda: FaceTracker(smooth=None, redetect_bucket=1),
        "multi": lambda: MultiFaceTracker(max_faces=2),
    }[name]()
    sharded = ShardedTracker(tracker, mesh)
    frames = photo_frames(batch) if name != "bucket" else np.stack([photo_frames(1)[0]] * batch)
    state = sharded.init_state(batch)
    frames = sharded.shard_frames(jnp.asarray(frames))
    out = {}
    for t in range(steps):
        state, o = sharded.step(state, frames) if name == "step" else sharded.step_gated(state, frames)
        out.update({f"{t}/out/{k}": v for k, v in _flatten(o).items()})
        out.update({f"{t}/state/{k}": v for k, v in _flatten(state).items()})
    return out


def jax_train_run() -> dict:
    """zaru_tpu's data-parallel step over 8 virtual devices: the losses, and
    the gradient of the global-mean loss at the start for the kept
    parameters."""
    import jax
    import jax.numpy as jnp

    from zaru_tpu.assets import model_path
    from zaru_tpu.onnx import load_model
    from zaru_tpu.parallel import stream_mesh
    from zaru_tpu.train import landmark_mse_loss, make_data_parallel_train_step

    model = load_model(model_path(TRAIN_BLOB))
    mesh = stream_mesh(jax.devices()[:SHARDS])
    step, params, opt_state, shard_batch = make_data_parallel_train_step(model, mesh)
    x, y = train_data()
    grads = jax.jit(jax.grad(landmark_mse_loss(model)))(params, jnp.asarray(x), jnp.asarray(y))
    kept = kept_names({k: np.asarray(v) for k, v in model.params.items()})
    xs, ys = shard_batch(x), shard_batch(y)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state, xs, ys)
        losses.append(float(loss))
    out = {"losses": np.asarray(losses, np.float64)}
    out.update({f"grad/{k}": np.asarray(grads[k]) for k in kept})
    return out


RUNS = ("step", "gated", "bucket", "multi")


def jax_all() -> dict:
    """Every stored run."""
    runs = {name: jax_tracker_run(name) for name in RUNS}
    runs["train"] = jax_train_run()
    return {f"{name}/{k}": v for name, run in runs.items() for k, v in run.items()}


def regen():
    np.savez_compressed(FIXTURE, **jax_all())
    print(f"wrote {FIXTURE}")


# --- the tests -----------------------------------------------------------------


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def mesh():
    from zaru_tpu_torch.parallel import stream_mesh

    return stream_mesh(["cpu"] * SHARDS)


def port_tracker(name):
    from zaru_tpu_torch.pipeline import FaceTracker, MultiFaceTracker

    if name == "bucket":
        return FaceTracker(smooth=None, redetect_bucket=1, device="cpu")
    if name == "multi":
        return MultiFaceTracker(max_faces=2, device="cpu")
    return FaceTracker(device="cpu")


def run_frames_of(name):
    return (np.stack([photo_frames(1)[0]] * 16), 2) if name == "bucket" else (photo_frames(BATCH), STEPS)


def test_fixture_is_current(stored):
    """JAX's sharded runs and data-parallel step give the stored arrays now
    (flags and integer leaves equal; floats within 1e-3, the regen
    machine's own rounding; losses within 1e-6 relative)."""
    now = jax_all()
    assert set(now) == set(stored)
    for k, v in now.items():
        if k == "train/losses":
            np.testing.assert_allclose(v, stored[k], rtol=1e-6)
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(v, stored[k], rtol=0, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(v, stored[k], err_msg=k)


def _assert_shard_equal(sharded_tree, shard_trees):
    """Each leaf's shard ``s`` bit-equal to ``shard_trees[s]``'s leaf."""
    for k, v in sharded_tree.items():
        if isinstance(v, dict):
            _assert_shard_equal(v, [t[k] for t in shard_trees])
            continue
        assert len(v.shards) == len(shard_trees), k
        for s, t in enumerate(shard_trees):
            assert v.shards[s].device == t[k].device and torch.equal(v.shards[s], t[k]), (k, s)


@pytest.mark.parametrize("name", ["step", "gated", "multi"])
def test_sharded_run_matches_jax_and_each_shard(stored, mesh, name):
    """``step`` (each shard's ``run_frames``), ``step_gated`` (each shard's
    ``step_batch``) and ``MultiFaceTracker`` sharded: flags equal to JAX's
    sharded run at every step, landmarks within FREE_TOL_PX; outputs and
    state of every shard bit-equal to its own step on its slice, run by a
    tracker of its own."""
    from zaru_tpu_torch.parallel import Sharded, ShardedTracker

    sharded = ShardedTracker(port_tracker(name), mesh)
    own = port_tracker(name)
    method = "run_frames" if name == "step" else "step_batch"
    frames_np, steps = run_frames_of(name)
    frames = sharded.shard_frames(frames_np)
    state = sharded.init_state(len(frames_np))
    own_states = [own.init_state(len(f)) for f in frames.shards]
    for t in range(steps):
        state, out = sharded.step(state, frames) if name == "step" else sharded.step_gated(state, frames)
        own_runs = [getattr(own, method)(st, f) for st, f in zip(own_states, frames.shards)]
        own_states = [st for st, _ in own_runs]
        _assert_shard_equal(out, [o for _, o in own_runs])
        _assert_shard_equal(state, own_states)
        assert isinstance(out["valid"], Sharded) and out["valid"].sharding == sharded.frame_sharding
        valid = np.asarray(out["valid"])
        np.testing.assert_array_equal(valid, stored[f"{name}/{t}/out/valid"])
        np.testing.assert_array_equal(np.asarray(state["tracking" if name != "multi" else "active"]),
                                      stored[f"{name}/{t}/state/{'tracking' if name != 'multi' else 'active'}"])
        np.testing.assert_allclose(np.asarray(out["landmarks"])[valid], stored[f"{name}/{t}/out/landmarks"][valid],
                                   rtol=0, atol=FREE_TOL_PX)
    assert valid.sum() == (len(valid) - len(BLANK)) and not valid[list(BLANK)].any()


def test_redetect_bucket_is_per_shard(stored, mesh):
    """16 streams over 8 shards, all lost, ``redetect_bucket=1``: each shard
    drains one of its lost streams a step, so 8 are acquired at the first
    gated step and 16 at the second, as in JAX (tests/test_parallel.py:67)."""
    from zaru_tpu_torch.parallel import ShardedTracker

    sharded = ShardedTracker(port_tracker("bucket"), mesh)
    frames_np, steps = run_frames_of("bucket")
    state = sharded.init_state(len(frames_np))
    frames = sharded.shard_frames(frames_np)
    counts = []
    for t in range(steps):
        state, out = sharded.step_gated(state, frames)
        valid = np.asarray(out["valid"])
        np.testing.assert_array_equal(valid, stored[f"bucket/{t}/out/valid"])
        counts.append(int(valid.sum()))
    assert counts == [8, 16]


def test_uneven_batch_and_mesh_rules(mesh, monkeypatch):
    """``init_state(9)`` over 8 shards raises with JAX's message; a mesh is
    its devices in order, ``cuda`` by default, which raises without a
    GPU; ``ShardedFaceTracker`` is ``ShardedTracker``."""
    from zaru_tpu_torch.parallel import ShardedFaceTracker, ShardedTracker, stream_mesh

    assert ShardedFaceTracker is ShardedTracker
    sharded = ShardedTracker(port_tracker("gated"), mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded.init_state(9)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded.shard_frames(np.zeros((9, 4, 4, 4), np.uint8))
    assert mesh == (torch.device("cpu"),) * SHARDS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        stream_mesh([])


def test_sharded_layout_reads_and_writes():
    """A ``Sharded`` batch gathers on the host in mesh order, reads and
    writes one stream on its shard, and is re-placed as it is or re-split
    onto a mesh of another size."""
    from zaru_tpu_torch.parallel import Sharded, StreamSharding

    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    three = StreamSharding((torch.device("cpu"),) * 3)
    sh = three.put(x)
    assert [tuple(s.shape) for s in sh.shards] == [(2, 4)] * 3 and sh.shape == (6, 4)
    np.testing.assert_array_equal(np.asarray(sh), x)
    np.testing.assert_array_equal(sh[3].numpy(), x[3])
    twin = sh.clone()
    twin[-1] = torch.full((4,), -1.0)
    assert float(twin.shards[2][1, 0]) == -1.0 and float(sh.shards[2][1, 0]) == 20.0
    same = three.put(sh)
    assert all(a is b for a, b in zip(same.shards, sh.shards))
    two = StreamSharding((torch.device("cpu"),) * 2).put(sh)
    assert isinstance(two, Sharded) and [s.shape[0] for s in two.shards] == [3, 3]
    np.testing.assert_array_equal(np.asarray(two), x)
    with pytest.raises(IndexError):
        sh[6]


def test_uploader_stages_into_stream_sharding(mesh):
    """``FrameUploader(device=frame_sharding)`` returns each flush already in
    the sharded layout (each shard its slice of the staged batch, in its own
    buffers), and ``step_gated`` takes it as it is: the same outputs as from
    ``shard_frames`` of the same frames (tests/test_parallel.py:168)."""
    from zaru_tpu_torch.parallel import ShardedTracker
    from zaru_tpu_torch.pipeline.ingest import FrameUploader

    sharded = ShardedTracker(port_tracker("gated"), mesh)
    frames_np = photo_frames(BATCH)
    up = FrameUploader(batch=BATCH, shape=frames_np.shape[1:], device=sharded.frame_sharding)
    for slot in range(BATCH):
        up.stage(slot, frames_np[slot])
    frames = up.flush()
    assert frames.sharding == sharded.frame_sharding and len(frames.shards) == SHARDS
    np.testing.assert_array_equal(np.asarray(frames), frames_np)
    second = up.flush()
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(frames.shards, second.shards))  # double-buffered
    _, out = sharded.step_gated(sharded.init_state(BATCH), frames)
    _, ref = sharded.step_gated(sharded.init_state(BATCH), sharded.shard_frames(frames_np))
    assert torch.equal(out["landmarks"].cpu(), ref["landmarks"].cpu())


def test_shard_state_replaces_host_edited_state(mesh):
    """``serve.reset_state_slots`` on a sharded state, then ``shard_state``:
    the reset stream lost, the others tracking, each shard on its device;
    the reset stream re-detects on the next gated step
    (tests/test_parallel.py:192)."""
    from zaru_tpu_torch.parallel import ShardedTracker
    from zaru_tpu_torch.serve import reset_state_slots

    sharded = ShardedTracker(port_tracker("gated"), mesh)
    frames = sharded.shard_frames(np.stack([photo_frames(1)[0]] * BATCH))
    state, out = sharded.step_gated(sharded.init_state(BATCH), frames)
    assert np.asarray(out["valid"]).all()
    state = sharded.shard_state(reset_state_slots(state, sharded.init_state(BATCH), [3]))
    tr = np.asarray(state["tracking"])
    assert not tr[3] and tr[[0, 1, 2, 4, 5, 6, 7]].all()
    assert all(s.device == torch.device("cpu") for s in state["roi"].shards)
    state, out = sharded.step_gated(state, frames)
    assert np.asarray(out["valid"]).all()


@pytest.mark.parametrize("kind", ["FaceTracker(iris=True)", "MultiHandTracker"])
def test_replica_moves_every_tensor(kind):
    """A replica for another device (``meta`` here, the one other device a
    CPU machine has) holds no tensor of the source's device, after a step
    has filled the executor's kept copies; the source keeps its own; a
    function closing over a source tensor refuses to be replicated."""
    from zaru_tpu_torch.parallel.mesh import _replica
    from zaru_tpu_torch.pipeline import FaceTracker, MultiHandTracker

    tracker = FaceTracker(iris=True, device="cpu") if kind.startswith("Face") else MultiHandTracker(device="cpu")
    tracker.step_batch(tracker.init_state(1), torch.from_numpy(photo_frames(1)))
    cpu, meta = torch.device("cpu"), torch.device("meta")
    replica = _replica(tracker, cpu, meta)

    def devices(obj, seen):
        if id(obj) in seen:
            return set()
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            return {obj.device.type}
        if isinstance(obj, dict):
            return set().union(*(devices(v, seen) for v in obj.values()))
        if isinstance(obj, (list, tuple, set)):
            return set().union(*(devices(v, seen) for v in obj))
        if hasattr(obj, "__dict__") and not isinstance(obj, type):
            return set().union(*(devices(v, seen) for v in vars(obj).values()))
        return set()

    assert devices(replica, set()) == {"meta"} and replica.device == meta
    assert devices(tracker, set()) == {"cpu"} and tracker.device == cpu
    t = torch.zeros(1)
    with pytest.raises(ValueError, match="closes over"):
        _replica({"f": lambda: t}, cpu, meta)


def slim_160():
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import NeuralNetwork

    return NeuralNetwork.load(model_path(TRAIN_BLOB), device="cpu")


def test_data_parallel_training(stored, mesh):
    """``make_data_parallel_train_step`` on slim_160 over 8 shards returns
    JAX's four-tuple; the first loss and the averaged gradient as JAX's
    data-parallel step, the losses within LOSS_RTOL of JAX's and falling
    (tests/test_parallel.py:95)."""
    from zaru_tpu_torch.parallel import Replicated, Sharded
    from zaru_tpu_torch.train import make_data_parallel_train_step

    step, params, opt_state, shard_batch = make_data_parallel_train_step(slim_160(), mesh)
    assert all(isinstance(v, Replicated) for v in params.values()) and len(opt_state) == 1
    x, y = train_data()
    xs, ys = shard_batch(x), shard_batch(y)
    assert isinstance(xs, Sharded) and len(xs.shards) == SHARDS
    losses = []
    for t in range(TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state, xs, ys)
        losses.append(float(loss))
        if t == 0:
            for k in stored:
                if k.startswith("train/grad/"):
                    want = stored[k]
                    got = params[k[len("train/grad/"):]].copies[0].grad.numpy()
                    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(), err_msg=k)
    want = stored["train/losses"]
    np.testing.assert_allclose(losses[0], want[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0] and want[-1] < want[0]


def test_replicated_checkpoint_restore(mesh, tmp_path):
    """Replicated parameters save as they are (``.npz`` and directory) and
    restore through ``load_params(like=)`` and ``CheckpointManager.restore``
    as a copy on each replica's device; resuming from a checkpoint taken
    after step 1 gives step 2's loss bit for bit."""
    from zaru_tpu_torch.checkpoint import CheckpointManager, load_params, save_params
    from zaru_tpu_torch.parallel import Replicated
    from zaru_tpu_torch.train import make_data_parallel_train_step

    two = mesh[:2]
    step, params, opt_state, shard_batch = make_data_parallel_train_step(slim_160(), two)
    x, y = train_data()
    xs, ys = shard_batch(x[:2]), shard_batch(y[:2])
    params, opt_state, _ = step(params, opt_state, xs, ys)
    save_params(tmp_path / "p.npz", params)
    with CheckpointManager(tmp_path / "run") as mgr:
        mgr.save(1, params)
    snapshot = {k: v.copies[0].detach().clone() for k, v in params.items()}
    params, opt_state, loss2 = step(params, opt_state, xs, ys)
    for restored in (load_params(tmp_path / "p.npz", like=params), mgr.restore(like=params)):
        assert set(restored) == set(params)
        for k, v in restored.items():
            assert isinstance(v, Replicated) and v.devices == params[k].devices
            assert torch.equal(v.copies[0], snapshot[k]) and v.copies[0] is not params[k].copies[0]
    _, _, again = step(restored, opt_state, xs, ys)
    assert float(again) == float(loss2)


def test_serve_loop_sharded_join(mesh):
    """``serve_loop`` over two CPU shards with finite sources, uploading
    through the sharded uploader: slot 0's source ends, the pending one
    joins it, and the step after the join starts slot 0 from a fresh state
    placed back on its shard (``reset_state_slots``, then ``shard_state``)
    and slot 1 from its carried one; every active slot finds its face."""
    from zaru_tpu_torch.parallel import Sharded, ShardedTracker
    from zaru_tpu_torch.pipeline.ingest import FrameUploader
    from zaru_tpu_torch.serve import StreamSet, serve_loop

    class Recording(ShardedTracker):
        def run_frames_gated(self, state, frames):
            self.states.append(state)
            return super().run_frames_gated(state, frames)

    sharded = Recording(port_tracker("gated"), mesh[:2])
    sharded.states = []
    photo = photo_frames(1)[0]

    def source(n, name):
        def factory():
            for t in range(n):
                yield np.roll(photo, 2 * t, axis=1)

        factory.name = name
        return factory

    streams = StreamSet([source(2, "a"), source(4, "b")], pending=[source(1, "c")])
    streams.prime()
    up = FrameUploader(2, photo.shape, device=sharded.frame_sharding)
    recs, lines = [], []
    serve_loop(sharded, streams, up, single=False, steps=10, no_loop=True, emit=lambda rec, out: recs.append(rec),
               log=lines.append)
    streams.close()
    assert "stream slot 0: join (c)" in lines and "all sources exhausted" in lines
    join = next(i for i, r in enumerate(recs) if i > 0 and r.get("active") == [True, True])
    start = sharded.states[join]
    assert isinstance(start["tracking"], Sharded) and [s.device for s in start["tracking"].shards] == list(mesh[:2])
    assert np.asarray(start["tracking"]).tolist() == [False, True]
    assert all(v for r in recs for v, a in zip(r["valid"], r.get("active", [True, True])) if a)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen()
