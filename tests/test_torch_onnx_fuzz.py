"""JAX's differential fuzz of the ONNX dialect (tests/test_onnx_fuzz.py)
through the port's executor, on the CPU.

The graphs are ``GraphGen``'s, imported from that module, at its seeds: the
40 of its NCHW test (seeds 0-39, 3-8 ops) and the 10 of its NHWC test
(seeds 1000-1009, 3-6 ops). Each graph runs at batch 3 (the seed's own
input first, two more after it) in the port, against JAX's three batch-1
runs concatenated (``jax.jit(model.apply)`` per image; the NHWC graphs
through ``load_model(layout="NHWC")``, and in the port in its NHWC layout),
and at batch 1 on the first image; both at the repo's CNN bar,
``atol = 1e-3·max(1, |out|max)``, ``rtol = 2e-3``.

JAX's outputs are stored with the graphs and inputs in
``zaru_tpu_torch/fixtures/onnx_dialect.npz`` (keys ``fuzz/*``), which
``chip_smoke.py`` replays on the card; ``test_fixture_is_current``
rebuilds every graph and input and runs JAX live on a few. Regenerate
with::

    JAX_PLATFORMS=cpu python tests/test_torch_onnx_fuzz.py
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_onnx_ops import check, regen, run_port, stored_cases  # noqa: E402
from torch_port import one_torch_thread  # noqa: E402,F401

PREFIX = "fuzz/"
BATCH = 3
CASES = {**{f"nchw {s}": ("NCHW", s, 3, 9) for s in range(40)},
         **{f"nhwc {s}": ("NHWC", 1000 + s, 3, 7) for s in range(10)}}
LIVE = ["nchw 0", "nchw 17", "nhwc 3"]


def build(name):
    """The seed's graph and its input (test_onnx_fuzz.py's own draws), with
    two more images after it."""
    from test_onnx_fuzz import GraphGen

    _layout, seed, lo, hi = CASES[name]
    rng = np.random.default_rng(seed)
    gen = GraphGen(rng)
    data = gen.build(n_ops=int(rng.integers(lo, hi)))
    x = rng.normal(0, 1, gen.in_shape).astype(np.float32)
    more = np.random.default_rng(seed + 5000).normal(0, 1, (BATCH - 1,) + gen.in_shape[1:]).astype(np.float32)
    return data, [np.concatenate([x, more])]


def jax_run(name, data, feeds):
    import jax

    from zaru_tpu.onnx import load_model

    m = load_model(data, layout=CASES[name][0])
    fn = jax.jit(m.apply)
    runs = [fn(m.params, feeds[0][i:i + 1]) for i in range(BATCH)]
    return [np.concatenate([np.asarray(r[k]) for r in runs]) for k in range(len(runs[0]))]


def case_arrays(name, data, feeds, outs) -> dict:
    arrays = {f"{name}/graph": np.frombuffer(data, np.uint8), f"{name}/tol": np.asarray("cnn"),
              f"{name}/layout": np.asarray(CASES[name][0]), f"{name}/in0": feeds[0]}
    arrays.update({f"{name}/out{i}": o for i, o in enumerate(outs)})
    return arrays


@pytest.fixture(scope="module")
def stored():
    return stored_cases(PREFIX)


def test_fixture_is_current(stored):
    """Every stored graph and input is what GraphGen makes now, and JAX
    computes the stored outputs of a few of them now."""
    assert set(stored) == set(CASES)
    for name in CASES:
        data, feeds = build(name)
        assert data == stored[name]["graph"], name
        np.testing.assert_array_equal(feeds[0], stored[name]["ins"][0], err_msg=name)
    for name in LIVE:
        c = stored[name]
        for got, want in zip(jax_run(name, c["graph"], c["ins"]), c["outs"], strict=True):
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_fuzz_graph_matches_jax(stored, name):
    c = stored[name]
    layout = str(c["layout"])
    for batch in (BATCH, 1):
        _m, outs = run_port(c["graph"], [c["ins"][0][:batch]], layout=layout)
        assert len(outs) == len(c["outs"])
        for i, (got, want) in enumerate(zip(outs, c["outs"])):
            check(got, want[:batch], "cnn", f"{name} at batch {batch}, output {i}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    regen(PREFIX, list(CASES), build, jax_run, case_arrays)
