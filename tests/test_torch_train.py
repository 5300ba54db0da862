"""The port's Trainer and checkpoints (zaru_tpu_torch.train, .checkpoint)
against zaru_tpu's, on the CPU.

The recipe is tests/test_training_e2e.py's at a small batch: jittered face
crops of the fixture photo (nearest-neighbour, made here with numpy from
the photo stored in ``sad_linus_track.npz``), pseudo-labels from the
pretrained slim_160 (the teacher: JAX's outputs), the weights perturbed from
a numpy seed (the same numbers in both packages), then K Adam steps at
``lr = 1e-4``. JAX's losses, a few of its parameters after the K steps and
a checkpoint it wrote (``save_params`` of those parameters) are stored in
``zaru_tpu_torch/fixtures/export_train.npz`` (keys ``train__*``;
tests/test_torch_export.py owns the ``export__*`` keys);
``test_fixture_is_current`` runs JAX again, in the test process. Regenerate
this file's keys with::

    JAX_PLATFORMS=cpu python tests/test_torch_train.py

Tolerances, measured here. From the same weights the port's first loss is
JAX's within 3.9e-7 (relative) and its gradient within 8.3e-6 of each
parameter's largest gradient: the two frameworks sum the convolutions in
another order. Then Adam's update ``m/(√v + ε)`` turns that rounding into
parameter differences of up to ``lr`` a step (not of an ulp) wherever a
gradient is near 0, and the runs part: the losses of the K steps differ by
up to 3.3% (2.1% on one thread), the stored parameters by up to 0.21 of
``lr·K`` (0.026 on one thread). So the first loss and the gradient are held
tightly (FIRST_LOSS_RTOL, GRAD_TOL), the K losses to LOSS_RTOL and the
parameters in units of ``lr·K`` (PARAM_TOL_LR_STEPS).
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "zaru_tpu_torch", "fixtures")
FIXTURE = os.path.join(FIXTURES, "export_train.npz")
PREFIX = "train__"
BLOB = "slim_160_latest.onnx"
BATCH, RES, STEPS, LR = 4, 160, 10, 1e-4
FIRST_LOSS_RTOL = 1e-5  # 3.9e-7 measured
GRAD_TOL = 1e-4  # of each parameter's largest |gradient|; 8.3e-6 measured
LOSS_RTOL = 0.1  # the K losses; 3.3% measured (see the docstring)
PARAM_TOL_LR_STEPS = 0.5  # 0.21 measured


def photo_rgb():
    with np.load(os.path.join(FIXTURES, "sad_linus_track.npz")) as f:
        return f["rgb"], f["roi"][0, 0]


def crops_u8():
    """BATCH jittered square crops of the face, nearest-neighbour at
    RES × RES (test_training_e2e.py's jitter: centre ±5%, side 0.9-1.15×)."""
    rgb, roi = photo_rgb()
    cx, cy, size = float(roi[0]), float(roi[1]), float(max(roi[2], roi[3]))
    rng = np.random.default_rng(7)
    out = []
    for _ in range(BATCH):
        jx, jy = rng.uniform(-0.05, 0.05, 2) * size
        side = size * float(rng.uniform(0.9, 1.15))
        grid = (np.arange(RES) + 0.5) * side / RES - side / 2
        xs = np.clip(np.floor(cx + jx + grid), 0, rgb.shape[1] - 1).astype(np.int64)
        ys = np.clip(np.floor(cy + jy + grid), 0, rgb.shape[0] - 1).astype(np.int64)
        out.append(rgb[ys[:, None], xs[None, :]])
    return np.stack(out)


def inputs(crops):
    """NCHW f32 in [-1, 1] (slim_160's colour range)."""
    x = crops.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def perturb(params: dict, scale=0.03, seed=3) -> dict:
    """test_training_e2e.py's perturbation, in sorted name order so both
    packages draw the same numbers for each parameter."""
    rng = np.random.default_rng(seed)
    return {
        k: (params[k] + rng.normal(0, scale * (np.std(params[k]) + 1e-6), np.shape(params[k]))).astype(np.float32)
        for k in sorted(params)
    }


def kept_names(params: dict) -> list:
    """A few parameters to store: the first and last by name of each rank,
    among those of at most 4096 values."""
    names = sorted((k for k in params if np.size(params[k]) <= 4096), key=lambda k: (np.ndim(params[k]), k))
    firsts = {}
    for k in names:
        firsts.setdefault(np.ndim(params[k]), []).append(k)
    return sorted({ks[i] for ks in firsts.values() for i in (0, -1)})


def jax_run(crops):
    """zaru_tpu's Trainer over the recipe → the fixture's arrays."""
    import jax
    import jax.numpy as jnp

    from zaru_tpu.assets import model_path
    from zaru_tpu.checkpoint import save_params
    from zaru_tpu.train import Trainer, landmark_mse_loss

    from zaru_tpu.onnx import load_model

    model = load_model(model_path(BLOB))
    x = inputs(crops)
    ys = np.asarray(jax.jit(model.apply)(model.params, jnp.asarray(x))[0])
    params = {k: np.asarray(v) for k, v in model.params.items()}
    trainer = Trainer(model, loss_fn=landmark_mse_loss(model))
    trainer.params = {k: jnp.asarray(v) for k, v in perturb(params).items()}
    trainer.opt_state = trainer.optimizer.init(trainer.params)
    grads = jax.grad(trainer.loss_fn)(trainer.params, jnp.asarray(x), jnp.asarray(ys))
    losses = [trainer.train_step(x, ys) for _ in range(STEPS)]
    kept = {k: np.asarray(trainer.params[k]) for k in kept_names(params)}
    buf = io.BytesIO()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"zaru_train_ckpt_{os.getpid()}.npz")
    save_params(path, kept)
    with open(path, "rb") as f:
        buf.write(f.read())
    os.remove(path)
    out = {"labels": ys, "losses": np.asarray(losses, np.float64),
           "checkpoint": np.frombuffer(buf.getvalue(), np.uint8)}
    out.update({f"param/{k}": v for k, v in kept.items()})
    out.update({f"grad/{k}": np.asarray(grads[k]) for k in kept})
    return out


def regen():
    crops = crops_u8()
    arrays = {"crops": crops, **jax_run(crops)}
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


def student(device="cpu"):
    """slim_160 on the CPU with the recipe's perturbed weights."""
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import NeuralNetwork

    net = NeuralNetwork.load(model_path(BLOB), device=device)
    net.load_params(perturb({k: v.detach().numpy() for k, v in net.params.items()}))
    return net


def test_fixture_is_current(stored):
    """The stored crops are the recipe's, and JAX's Trainer gives the stored
    losses, parameters and checkpoint now (the regen machine's own
    rounding aside: 1e-6 relative on the losses, 1e-6 on the parameters)."""
    crops = crops_u8()
    np.testing.assert_array_equal(stored["crops"], crops)
    now = jax_run(crops)
    assert set(now) == set(stored) - {"crops"}
    np.testing.assert_allclose(now["losses"], stored["losses"], rtol=1e-6)
    np.testing.assert_allclose(now["labels"], stored["labels"], rtol=0, atol=1e-6)
    for k in now:
        if k.startswith(("param/", "grad/")):
            np.testing.assert_allclose(now[k], stored[k], rtol=0, atol=1e-6, err_msg=k)


def test_trainer_matches_jax(stored):
    """K Adam steps from the same perturbed weights on the same crops and
    labels: the first loss and the gradient as JAX's, the K losses and the
    stored parameters within their measured tolerances, and the loss falls
    as in JAX's run."""
    from zaru_tpu_torch.train import Trainer

    net = student()
    trainer = Trainer(net)
    x = torch.from_numpy(inputs(stored["crops"]))
    y = torch.from_numpy(stored["labels"])
    trainer.loss_fn(x, y).backward()
    for k in stored:
        if k.startswith("grad/"):
            want = stored[k]
            got = net.params[k[len("grad/"):]].grad.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(), err_msg=k)
    losses = np.asarray([trainer.train_step(x, y) for _ in range(STEPS)])
    np.testing.assert_allclose(losses[0], stored["losses"][0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, stored["losses"], rtol=LOSS_RTOL)
    assert losses[-1] < 0.25 * losses[0] and stored["losses"][-1] < 0.25 * stored["losses"][0]
    params = net.params
    for k in stored:
        if k.startswith("param/"):
            got = params[k[len("param/"):]].detach().numpy()
            np.testing.assert_allclose(got, stored[k], rtol=0, atol=PARAM_TOL_LR_STEPS * LR * STEPS, err_msg=k)


def face_mesh():
    """Face Mesh V1 on the CPU (slim_160 has no chain the stage kernel
    takes; Face Mesh V1 has eight) and a seeded input at its 192×192."""
    from zaru_tpu_torch.assets import model_path
    from zaru_tpu_torch.nn import NeuralNetwork

    net = NeuralNetwork.load(model_path("face_landmark.onnx"), device="cpu")
    assert len(net.module.stages) == 8
    x = np.random.default_rng(5).uniform(-1, 1, (2, 3, 192, 192)).astype(np.float32)
    return net, torch.from_numpy(x)


def test_packed_weights_follow_training():
    """After a step the stage kernel's packed weights are the trained ones:
    inference through the stage plan equals the op-by-op graph on the
    trained weights (the CNN bar), and has moved from before the step."""
    from zaru_tpu_torch.train import Trainer

    net, x = face_mesh()
    module = net.module
    with torch.no_grad():
        before = module(x)[0]
    Trainer(net).train_step(x, torch.zeros(2, 1404))
    with torch.no_grad(), module.without_plans():
        op_by_op = module(x)[0]
    with torch.no_grad():
        fused = module(x)[0]
    np.testing.assert_allclose(fused.numpy(), op_by_op.numpy(), rtol=2e-3,
                               atol=1e-3 * max(1.0, float(op_by_op.abs().max())))
    assert float((fused - before).abs().max()) > 1e-3


def test_gradient_through_the_stage_op_raises():
    """The stage op has no autograd formula (JAX has no backward kernel):
    a gradient asked through it, or through a module's stage plan, raises
    instead of coming back empty."""
    from zaru_tpu_torch.ops.cnn_stage import fused_blocks, pack_blocks

    rng = np.random.default_rng(0)
    C = 16
    blocks = [{"dw_w": rng.normal(size=(C, 1, 3, 3)), "dw_b": rng.normal(size=C), "pw_w": rng.normal(size=(C, C, 1, 1)),
               "pw_b": rng.normal(size=C), "alpha": rng.normal(size=C)}]
    x = torch.randn(2, C, 6, 6, requires_grad=True)
    y = fused_blocks(x, pack_blocks(blocks, C), 6, 6, C)
    with pytest.raises(RuntimeError, match="autograd"):
        y.sum().backward()
    net, x = face_mesh()
    with pytest.raises(RuntimeError, match="autograd"):
        net.module(x.requires_grad_(True))[0].sum().backward()


def test_checkpoints_cross_packages(stored, tmp_path):
    """JAX's npz checkpoint loads in the port leaf for leaf, and the port's
    npz loads in numpy (and so in JAX's ``load_params``) as the same
    archive; ``like`` places leaves and refuses missing or extra names."""
    from zaru_tpu.checkpoint import load_params as jax_load

    from zaru_tpu_torch.checkpoint import load_params, save_params

    jax_file = tmp_path / "jax.npz"
    jax_file.write_bytes(stored["checkpoint"].tobytes())
    kept = {k[len("param/"):]: stored[k] for k in stored if k.startswith("param/")}
    got = load_params(jax_file)
    assert set(got) == set(kept)
    for k, v in kept.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    mine = tmp_path / "port.npz"
    save_params(mine, {k: torch.from_numpy(v) for k, v in kept.items()})
    back = jax_load(mine)
    for k, v in kept.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)
    like = {k: torch.zeros(v.shape) for k, v in kept.items()}
    placed = load_params(mine, like=like)
    assert all(placed[k].device == like[k].device for k in like)
    with pytest.raises(KeyError, match="missing params"):
        load_params(mine, like={**like, "absent": torch.zeros(1)})
    with pytest.raises(ValueError, match="not in the restore target"):
        load_params(mine, like=dict(list(like.items())[1:]))


def test_checkpoint_directory_and_async(tmp_path):
    """The port's own directory format round-trips exactly; an async save
    holds the values of when it was called, whatever happens to the
    tensors after; a trained module reloads to the same outputs."""
    from zaru_tpu_torch.checkpoint import load_params, save_params, save_params_async

    net = student()
    params = {k: v.detach().clone() for k, v in net.params.items()}
    save_params(tmp_path / "ckpt", params)
    back = load_params(tmp_path / "ckpt")
    assert set(back) == set(params)
    assert all(torch.equal(back[k], params[k]) for k in params)
    handle = save_params_async(tmp_path / "async", params)
    snapshot = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.add_(1.0)  # an optimizer's in-place update after the call
    handle.wait_until_finished()
    later = load_params(tmp_path / "async")
    assert all(torch.equal(later[k], snapshot[k]) for k in snapshot)
    x = torch.from_numpy(inputs(crops_u8()[:1]))
    other = student()
    other.load_params(load_params(tmp_path / "ckpt"))
    with torch.no_grad():
        assert torch.equal(other.module(x)[0], net.module(x)[0])


def test_checkpoint_manager(tmp_path):
    """Interval, retention, latest and a given step, and restore before any
    save; the manager is a context manager that flushes on exit."""
    from zaru_tpu_torch.checkpoint import CheckpointManager

    params = {"w": torch.zeros(3)}
    with CheckpointManager(tmp_path / "run", max_to_keep=2, save_interval_steps=2) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        started = []
        for step in range(7):
            params["w"].fill_(step)
            started.append(mgr.save(step, params))
    assert started == [True, False, True, False, True, False, True]
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    assert float(mgr.restore()["w"][0]) == 6.0
    assert float(mgr.restore(step=4)["w"][0]) == 4.0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen()
