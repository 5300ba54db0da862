"""A checkpoint leaf sharded over a mesh (zaru_tpu_torch.checkpoint with a
``parallel.Sharded`` leaf), held to JAX's sharded restore
(tests/test_checkpoint.py::test_sharded_save_restore_on_mesh): parameters
placed on a mesh of eight ``cpu`` shards (``stream_mesh(["cpu"] * 8)``, the
port's stand-in for JAX's eight virtual devices), the largest Face Mesh V1
weight whose axis 0 divides by 8 split over it, the others replicated or
plain, are saved and restored with ``like=``. The restored leaf has the
saved leaf's ``.sharding``, each shard on its mesh device, and every leaf
is bit-equal to what was saved. One case writes the archive with JAX's own
``zaru_tpu.checkpoint.save_params`` (numpy, nothing compiled).
"""

import numpy as np
import pytest
import torch

from torch_port import one_torch_thread  # noqa: F401

SHARDS = 8


@pytest.fixture(scope="module")
def mesh():
    from zaru_tpu_torch.parallel import stream_mesh

    return stream_mesh(["cpu"] * SHARDS)


@pytest.fixture(scope="module")
def weights():
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import NeuralNetwork

    net = NeuralNetwork.load(model_path("face_landmark.onnx"), device="cpu")
    return {k: v.detach().clone() for k, v in net.params.items()}


def sharded_key(weights):
    shardable = [k for k, v in weights.items() if v.ndim > 0 and v.shape[0] % SHARDS == 0 and v.numel() > SHARDS]
    return max(shardable, key=lambda k: weights[k].numel())


def placed_on(mesh, weights):
    """The weights on ``mesh``: one ``Sharded`` leaf, every other leaf
    ``Replicated`` over the mesh's distinct devices, but every fifth plain."""
    from zaru_tpu_torch.parallel import Replicated, StreamSharding

    devices = list(dict.fromkeys(mesh))
    placed = {}
    for i, (k, v) in enumerate(sorted(weights.items())):
        placed[k] = v.clone() if i % 5 == 0 else Replicated(v.to(d, copy=True) for d in devices)
    key = sharded_key(weights)
    placed[key] = StreamSharding(mesh).put(weights[key])
    return placed, key


def save_with(how, placed, weights, tmp_path):
    """Saves ``placed`` as ``how`` says; returns a function restoring it
    with ``like=``."""
    from zaru_tpu_torch.checkpoint import CheckpointManager, load_params, save_params, save_params_async

    if how == "manager":
        mgr = CheckpointManager(tmp_path / "mesh_ckpt")
        assert mgr.save(0, placed)
        mgr.wait_until_finished()
        return lambda like: mgr.restore(0, like=like)
    if how == "async":
        handle = save_params_async(tmp_path / "async_ckpt", placed)
        handle.wait_until_finished()
        return lambda like: load_params(tmp_path / "async_ckpt", like=like)
    if how == "npz":
        save_params(tmp_path / "params.npz", placed)
        return lambda like: load_params(tmp_path / "params.npz", like=like)
    assert how == "jax_npz"
    from zaru_tpu.checkpoint import save_params as jax_save

    jax_save(tmp_path / "jax.npz", {k: v.numpy() for k, v in weights.items()})
    return lambda like: load_params(tmp_path / "jax.npz", like=like)


@pytest.mark.parametrize("how", ["manager", "async", "npz", "jax_npz"])
def test_sharded_leaf_restores_shard_by_shard(how, mesh, weights, tmp_path):
    from zaru_tpu_torch.parallel import Replicated, Sharded

    placed, key = placed_on(mesh, weights)
    restore = save_with(how, placed, weights, tmp_path)
    restored = restore(placed)
    assert set(restored) == set(placed)
    leaf = restored[key]
    assert isinstance(leaf, Sharded)
    assert leaf.sharding == placed[key].sharding
    rows = weights[key].shape[0] // SHARDS
    for s, shard in enumerate(leaf.shards):
        assert shard.device == mesh[s]
        assert tuple(shard.shape) == (rows, *weights[key].shape[1:])
        assert torch.equal(shard, weights[key][s * rows:(s + 1) * rows])
    for k, like in placed.items():
        got = restored[k]
        if isinstance(like, Replicated):
            assert isinstance(got, Replicated) and got.devices == like.devices
            assert all(torch.equal(c, weights[k]) for c in got.copies)
        elif not isinstance(like, Sharded):
            assert isinstance(got, torch.Tensor) and got.device == like.device
            assert torch.equal(got, weights[k])
        np.testing.assert_array_equal(np.asarray(got), weights[k].numpy())


def test_sharded_leaf_that_does_not_divide_raises(mesh, tmp_path):
    """A saved leaf whose axis 0 does not divide over the mesh cannot be
    restored shard by shard: it raises rather than land elsewhere."""
    from zaru_tpu_torch.checkpoint import load_params, save_params
    from zaru_tpu_torch.parallel import StreamSharding

    save_params(tmp_path / "odd.npz", {"w": torch.arange(36.0).reshape(12, 3), "b": torch.zeros(())})
    like = {"w": StreamSharding(mesh).put(torch.zeros(16, 3)), "b": torch.zeros(())}
    with pytest.raises(ValueError, match="does not divide"):
        load_params(tmp_path / "odd.npz", like=like)
    like = {"w": torch.zeros(12, 3), "b": StreamSharding(mesh).put(torch.zeros(8))}
    with pytest.raises(ValueError, match="does not divide"):
        load_params(tmp_path / "odd.npz", like=like)
