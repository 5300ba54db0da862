"""The NHWC layout of the port's executor (zaru_tpu_torch/onnx/layout.py,
``torch.channels_last``) against JAX's NHWC import (zaru_tpu/onnx/layout.py)
on the CPU.

- The six models of tests/test_onnx_layout.py, loaded with
  ``Loader(...).with_layout("NHWC")``, at batch 2 on a seeded input against
  JAX's NHWC run of each image (``load_model(layout="NHWC")``) and against
  the port's own NCHW module, at the repo's CNN bar
  (``atol = 1e-3·max(1, |out|max)``, ``rtol = 2e-3``); their outputs leave
  NCHW-contiguous. Every other blob in ``assets/onnx`` loads and runs in
  NHWC, at the same bar against its NCHW module.
- bf16 with NHWC on the short-range detector against JAX's bf16 NHWC run,
  within tests/test_torch_bf16.py's ``NET_TOL_ULPS`` bf16 ulps of
  ``max(1, |out|max)``.
- Every 4-D value of the NHWC Face Mesh V1 module (``activations()``), the
  stage plan's chains included, is channels_last-contiguous: the PyTorch ops
  of the graph keep the format up to its heads.
- ``Cnn`` with an NHWC-layout Face Mesh V1 and BlazeFace: the samplers'
  NHWC stores feed the network through the permuted view, and give the NCHW
  module's outputs at the CNN bar.

JAX's outputs are stored in ``zaru_tpu_torch/fixtures/onnx_dialect.npz``
(keys ``layout/*``), which ``chip_smoke.py`` replays on the card;
``test_fixture_is_current`` runs JAX live on one model. Regenerate with::

    JAX_PLATFORMS=cpu python tests/test_torch_onnx_layout.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_bf16 import NET_TOL_ULPS  # noqa: E402
from test_torch_onnx_ops import ROOT, check, regen, stored_cases  # noqa: E402
from torch_port import one_torch_thread  # noqa: E402,F401

PREFIX = "layout/"
ONNX_DIR = os.path.join(ROOT, "assets", "onnx")
BATCH = 2
# tests/test_onnx_layout.py's models: name → input side.
MODELS = {
    "face_detection_short_range.onnx": 128,
    "face_landmark.onnx": 192,
    "face_landmarks_detector.onnx": 256,
    "iris_landmark.onnx": 64,
    "palm_detection_lite.onnx": 192,
    "slim_160_latest.onnx": 160,
}
CASES = {**{name: (name, None) for name in MODELS},
         "face_detection_short_range.onnx bf16": ("face_detection_short_range.onnx", "bf16")}
LIVE = ["iris_landmark.onnx"]


def build(name):
    model, _ = CASES[name]
    side = MODELS[model]
    x = np.random.default_rng(sorted(MODELS).index(model)).uniform(-1, 1, (BATCH, 3, side, side))
    return model, [x.astype(np.float32)]


def jax_run(name, model, feeds):
    import jax
    import jax.numpy as jnp

    from zaru_tpu.onnx import load_model

    dtype = jnp.bfloat16 if CASES[name][1] else None
    m = load_model(os.path.join(ONNX_DIR, model), layout="NHWC", compute_dtype=dtype)
    fn = jax.jit(m.apply)
    runs = [fn(m.params, feeds[0][i:i + 1]) for i in range(BATCH)]
    return [np.concatenate([np.asarray(r[k], np.float32) for r in runs]) for k in range(len(runs[0]))]


def case_arrays(name, model, feeds, outs) -> dict:
    tol = f"bf16:{NET_TOL_ULPS['short_range']}" if CASES[name][1] else "cnn"
    arrays = {f"{name}/model": np.asarray(model), f"{name}/tol": np.asarray(tol),
              f"{name}/layout": np.asarray("NHWC"), f"{name}/in0": feeds[0]}
    arrays.update({f"{name}/out{i}": o for i, o in enumerate(outs)})
    return arrays


def load(model, layout, compute_dtype=None):
    from zaru_tpu_torch.nn import Loader

    loader = Loader(os.path.join(ONNX_DIR, model), device="cpu").with_layout(layout)
    return (loader.with_bf16() if compute_dtype else loader).load()


@pytest.fixture(scope="module")
def stored():
    return stored_cases(PREFIX)


def test_fixture_is_current(stored):
    assert set(stored) == set(CASES)
    for name in CASES:
        model, feeds = build(name)
        assert str(stored[name]["model"]) == model
        np.testing.assert_array_equal(feeds[0], stored[name]["ins"][0], err_msg=name)
    for name in LIVE:
        c = stored[name]
        for got, want in zip(jax_run(name, str(c["model"]), c["ins"]), c["outs"], strict=True):
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_nhwc_matches_jax(stored, name):
    c = stored[name]
    x = torch.from_numpy(c["ins"][0])
    nhwc, nchw = load(name, "NHWC"), load(name, "NCHW")
    assert nhwc.module.layout == "NHWC"
    got, ref = nhwc.estimate(x), nchw.estimate(x)
    assert len(got) == len(c["outs"]) == len(ref)
    for i, (g, r, want) in enumerate(zip(got, ref, c["outs"])):
        assert g.is_contiguous(), f"{name} output {i} leaves {g.stride()}"
        check(g.numpy(), want, "cnn", f"{name} output {i} vs JAX")
        check(g.numpy(), r.numpy(), "cnn", f"{name} output {i} vs the NCHW module")


def test_bf16_nhwc_matches_jax(stored):
    """bf16 and NHWC together, as JAX allows both (importer.py:83)."""
    name = "face_detection_short_range.onnx bf16"
    c = stored[name]
    net = load(str(c["model"]), "NHWC", torch.bfloat16)
    assert net.module.compute_dtype == torch.bfloat16 and net.module.stages == []
    for i, (o, want) in enumerate(zip(net.estimate(torch.from_numpy(c["ins"][0])), c["outs"], strict=True)):
        assert o.dtype == torch.float32
        check(o.numpy(), want, c["tol"], f"output {i}")


def test_every_blob_loads_in_nhwc():
    """``with_layout("NHWC")`` loads every blob in assets/onnx; those not
    held to JAX above run at batch 1 at the CNN bar of their NCHW module."""
    names = sorted(n for n in os.listdir(ONNX_DIR) if n.endswith(".onnx"))
    assert len(names) == 10
    for name in names:
        net = load(name, "NHWC")
        if name in MODELS:
            continue
        shape = [d if isinstance(d, int) else 1 for d in net.inputs()[0].shape]
        x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, shape).astype(np.float32))
        for i, (g, r) in enumerate(zip(net.estimate(x), load(name, "NCHW").estimate(x), strict=True)):
            check(g.numpy(), r.numpy(), "cnn", f"{name} output {i}")


def test_activations_stay_channels_last():
    """Every 4-D value of the NHWC Face Mesh V1 module is
    channels_last-contiguous, from the input through the stage plan's
    chains to the heads."""
    net = load("face_landmark.onnx", "NHWC").module
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, 3, 192, 192)).astype(np.float32))
    with torch.inference_mode():
        env = net.activations(x)
    four = {k: v for k, v in env.items() if isinstance(v, torch.Tensor) and v.ndim == 4}
    assert len(four) > 40 and all(st.output in four for st in net.stages)
    bad = [k for k, v in four.items() if not v.is_contiguous(memory_format=torch.channels_last)]
    assert not bad, bad
    assert all(p.is_contiguous(memory_format=torch.channels_last) for p in net.params().values() if p.ndim == 4)


def test_layout_aware_ops_keep_channels_last():
    """In the fuzz graphs run in NHWC, every 4-D output of an op JAX runs in NHWC
    (``layout.CHANNELS_LAST_OPS``) whose 4-D input is channels_last is
    channels_last too, where PyTorch's own op would drop the format (a
    Resize through its weights, a Conv on a sliced view)."""
    from test_torch_onnx_ops import stored_cases as cases_of

    from zaru_tpu_torch.onnx import load_model
    from zaru_tpu_torch.onnx.layout import CHANNELS_LAST_OPS

    def cl(v):
        return isinstance(v, torch.Tensor) and v.ndim == 4 and v.is_contiguous(memory_format=torch.channels_last)

    seen = 0
    for name, c in cases_of("fuzz/").items():
        m = load_model(c["graph"], torch.device("cpu"), layout="NHWC")
        with torch.inference_mode():
            env = m.activations(torch.from_numpy(c["ins"][0]))
        for n in m.nodes:
            if n.op_type in CHANNELS_LAST_OPS and any(cl(env.get(x)) for x in n.inputs if x):
                for o in n.outputs:
                    if isinstance(env.get(o), torch.Tensor) and env[o].ndim == 4:
                        seen += 1
                        assert cl(env[o]), f"{name}: {n.op_type} output {o}"
    assert seen > 150


def test_cnn_feeds_nhwc_modules_without_a_copy():
    """``Cnn`` over an NHWC-layout module samples NHWC and hands the network
    the permuted view (no copy): the rotated views of Face Mesh V1 and the
    letterbox views of BlazeFace give the NCHW module's outputs."""
    from zaru_tpu_torch.assets import fixture_path
    from zaru_tpu_torch.nn import Cnn, ColorMapper
    from zaru_tpu_torch.pipeline import _ops

    with np.load(fixture_path("sad_linus_track.npz")) as f:
        rgb = f["rgb"]
    frame = torch.from_numpy(np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1))[None]
    frames = frame.expand(2, -1, -1, -1).contiguous()
    rois = torch.tensor([[[699.0, 405.0, 400.0, 440.0, 0.12]], [[650.0, 380.0, 300.0, 300.0, -0.3]]])
    mapper = ColorMapper.linear(-1.0, 1.0)
    for name, views in (("face_landmark.onnx", lambda c: c.apply_views_fast(frames, rois)),
                        ("face_detection_short_range.onnx", lambda c: c.apply_views_letterbox(
                            frames, _ops.full_frame_fit(frames, c.input_resolution())[1].expand(2, 5).contiguous()))):
        nhwc = Cnn.load(name, mapper, device="cpu", layout="NHWC")
        nchw = Cnn.load(name, mapper, device="cpu")
        assert nhwc._layout == "NHWC" and nhwc._permute and nchw._layout == "NCHW"
        with torch.inference_mode():
            got, want = views(nhwc), views(nchw)
            t = nhwc.sample_views_fast(frames, rois) if name == "face_landmark.onnx" else None
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            check(g.numpy(), w.numpy(), "cnn", f"{name} output {i}")
        if t is not None:  # the permuted NHWC sample is channels_last: the module takes it as it is
            v = t.reshape(-1, *t.shape[-3:]).permute(0, 3, 1, 2)
            assert v.is_contiguous(memory_format=torch.channels_last)
            with torch.inference_mode():
                for g, w in zip(nhwc.apply_tensor_hwc(t.reshape(-1, *t.shape[-3:])), got, strict=True):
                    assert torch.equal(g, w)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen(PREFIX, list(CASES), build, jax_run, case_arrays)
