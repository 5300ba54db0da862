"""The measurement scripts on the port (zaru_tpu_torch/examples: benchsuite
and the single-purpose benches, with the bench helpers of ``_common``), run
in this process on the CPU at a small size: batch 1 or 2, 2 steps a window
and one window (``--steps``, ``--windows`` or the scripts' module
constants), the hand cascades at one stream.

Each benchsuite subcommand writes the records JAX's writes, with JAX's keys
(``JAX_KEYS``: the keys of examples/benchsuite.py's emit dicts, by record
kind), and the ledger's derived row adds its stages up. The scripts print
JAX's lines (or write JAX's records). A script given no ``--device`` raises
without a GPU, and a decoder or encoder that is not there gives a
``skipped`` row, never another backend's numbers.
"""

import importlib
import json
import re
import sys

import numpy as np
import pytest
import torch

from torch_port import one_torch_thread  # noqa: F401

from zaru_tpu_torch.examples import benchsuite

SMALL = ["--device", "cpu", "--batch", "1", "--steps", "2", "--windows", "1", "--sweep-batches", "1"]

# JAX's record keys (examples/benchsuite.py's emit dicts), by bench or check;
# a record's keys (without its time ``t``) are one of the listed sets.
_SCAN = {"bench", "config", "batch", "ms_per_step", "ms_per_step_median", "windows", "fps"}
JAX_KEYS = {
    "cascade_production": [{"bench", "batch", "ms_per_step", "ms_per_step_median", "windows", "fps", "fps_median"}],
    "cadence": [{"bench", "arm", "batch", "scan", "ms_per_step", "ms_per_step_median", "fps"},
                {"bench", "arm", "detect_frame_extra_ms", "predicted_prod_ms", "measured_prod_ms"}],
    "latency": [{"bench", "config", "tunnel_ms"},
                {"bench", "config", "batch", "steps", "ms_per_step", "ms_per_step_median", "ms_per_step_device",
                 "fps_device", "windows"},
                {"bench", "config", "batch", "target_fps"},
                {"bench", "config", "batch", "steps", "ms_per_step", "ms_per_step_device", "ms_per_step_median",
                 "windows"},
                {"bench", "config", "batch", "steps", "ms_per_step", "ms_per_step_device", "windows"}],
    "ledger": [{"bench", "stage", "batch", "steps", "ms_per_step", "ms_per_step_median", "us_per_frame"},
               {"bench", "stage", "batch", "stage_sum_amortized_ms", "cascade_ms", "gate_residual_ms",
                "detect_amortized_ms"}],
    "detect_iso": [{"bench", "stage", "batch", "ms_per_step", "ms_per_step_median"},
                   {"bench", "stage", "batch", "ms_per_step"}],
    "redetect_bucket": [{"bench", "path", "batch", "fps", "ms_per_step", "ms_per_step_median"},
                        {"bench", "path", "value"}],
    "landmark_half_pinned": [{"bench", "batch", "ms_per_step", "ms_per_step_median", "fps"}],
    "stage": [{"bench", "impl", "C", "H", "nb", "ms_per_step"},
              {"bench", "impl", "C", "H", "nb", "ms_per_step", "max_err", "speedup_vs_xla"}],
    "sampler": [_SCAN | {"theta", "size"}],
    "hand_sampler": [_SCAN],
    "hand_cascade": [{"bench", "config", "ms_per_step", "fps"}],
    "bf16_face_indist": [{"check", "tilt_deg", "lm_err_px", "conf_f32", "conf_bf16", "valid_both"}],
    "facemesh_model_only": [{"bench", "dtype", "ms_per_step"}],
    # The port's own: JAX's parity records compare the TPU sampler's modes.
    "device_parity": [{"check", "config", "theta", "size", "out", "prescale_m", "stride", "plain_eq", "exact_eq",
                       "exact_differ", "max_abs_diff"}],
    "letterbox_parity": [{"check", "out", "plain_eq", "exact_eq"}],
    # examples/irisbench.py and examples/ingestbench.py
    "iris_cascade": [{"bench", "batch", "ms_per_step", "fps", "tracked"}],
    "decode_1thread": [{"bench", "backend", "ms_per_frame", "fps"}, {"bench", "backend", "skipped"}],
    "decode_pool": [{"bench", "threads", "fps", "ncpu"}, {"bench", "backend", "skipped"}],
    "upload": [{"bench", "batch", "link", "gbytes_per_s", "frames_per_s"}],
    "e2e_ingest_cascade": [{"bench", "batch", "link", "fps", "decode_ms_per_batch", "tracked"},
                           {"bench", "batch", "link", "skipped"}],
}
# The record kinds each subcommand writes.
WRITES = {
    "cascade": {"cascade_production"},
    "batch-sweep": {"cascade_production"},
    "cadence": {"cadence"},
    "latency": {"latency"},
    "ledger": {"ledger"},
    "detect": {"detect_iso"},
    "gate": {"redetect_bucket"},
    "landmark": {"landmark_half_pinned"},
    "cnnstage": {"stage"},
    "parity": {"device_parity", "letterbox_parity"},
    "sampler": {"sampler"},
    "hand": {"hand_sampler", "hand_cascade"},
    "bf16": {"bf16_face_indist", "facemesh_model_only"},
}


def read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def assert_jax_keys(records):
    for rec in records:
        kind = rec.get("bench", rec.get("check"))
        keys = set(rec) - {"t"}
        assert keys in [set(k) for k in JAX_KEYS[kind]], (kind, sorted(keys))
        assert isinstance(rec["t"], int)


def test_bench_helpers(tmp_path, capsys):
    """``make_emit`` appends JSONL records with their second ``t`` and echoes
    them to stderr; ``timed_windows_stats`` makes one untimed call, then
    ``n`` timed ones each ending in a host read of the first tensor leaf;
    ``make_bench_frame`` is the bench frame."""
    from zaru_tpu_torch.bench_programs import make_1080p_frame
    from zaru_tpu_torch.examples import _common

    out = tmp_path / "r.jsonl"
    emit = _common.make_emit(str(out))
    emit({"bench": "x", "v": 1})
    emit({"bench": "y"})
    recs = read_records(out)
    assert [r["bench"] for r in recs] == ["x", "y"] and recs[0]["v"] == 1 and all(isinstance(r["t"], int) for r in recs)
    assert capsys.readouterr().err.count("RESULT") == 2

    calls = []

    def fn(a, b):
        calls.append((a, b))
        return {"first": (torch.full((2,), float(a + b)), 0), "second": "unread"}

    stats = _common.timed_windows_stats(fn, 1, 2, n=3, label="fake")
    assert set(stats) == {"best", "median", "spread", "n"} and stats["n"] == 3 and len(calls) == 4
    assert 0 < stats["best"] <= stats["median"] and stats["spread"] >= 0
    assert 0 < _common.timed_windows(fn, 1, 2, n=2) and len(calls) == 7
    np.testing.assert_array_equal(_common.make_bench_frame(), make_1080p_frame())


@pytest.mark.parametrize("sub", benchsuite.SUBCOMMANDS)
def test_benchsuite_subcommand(sub, tmp_path, monkeypatch):
    """Each subcommand at batch 1 (the hand cascades at one stream) writes
    its records with JAX's keys; the ledger's derived row is its stages'
    sum, and parity holds."""
    monkeypatch.setattr(benchsuite, "HAND_STREAMS", 1)
    monkeypatch.setattr(benchsuite, "LATENCY_HAND_BATCHES", (1,))
    out = tmp_path / "b.jsonl"
    benchsuite.main([sub, *SMALL, "--out", str(out)])
    recs = read_records(out)
    assert_jax_keys(recs)
    assert {r.get("bench", r.get("check")) for r in recs} == WRITES[sub]
    assert not any("error" in r for r in recs), recs
    if sub == "ledger":
        rows = {r["stage"]: r for r in recs}
        assert list(rows) == [*benchsuite.LEDGER_STAGES, "derived"]
        d, ms = rows["derived"], {k: v["ms_per_step"] for k, v in rows.items() if k != "derived"}
        want = ms["sampler"] + ms["landmark-cnn"] + ms["track-tail"] + ms["detect-full"] / 9.0
        assert d["stage_sum_amortized_ms"] == pytest.approx(want, abs=2e-3)
        assert d["cascade_ms"] == pytest.approx(ms["cascade"], abs=1e-3)
        assert d["gate_residual_ms"] == pytest.approx(ms["cascade"] - want, abs=3e-3)
        assert d["detect_amortized_ms"] == pytest.approx(ms["detect-full"] / 9.0, abs=1e-3)
    if sub == "parity":
        assert all(r["plain_eq"] for r in recs)
        assert all(r["exact_eq"] for r in recs if r.get("stride", [1, 1]) == [1, 1])
    if sub == "cadence":
        assert [r["arm"] for r in recs] == ["never", "prod", "always", "derived"]
        assert recs[0]["scan"] == 18  # at least 2 detects at 1-in-9, whatever --steps says


# The scripts' small runs: arguments, and the module constants set for a
# small window.
SCRIPTS = {
    "irisbench": (["1"], {"STEPS": 2, "WINDOWS": 1}),
    "identifybench": (["1", "16"], {"SCAN_STEPS": 2, "WINDOWS": 1}),
    "gatebench": (["1"], {"SCAN_STEPS": 2, "WINDOWS": 1}),
    "detbench": (["1"], {"SCAN_STEPS": 2, "WINDOWS": 1}),
    "multifacebench": (["1", "2"], {"SCAN_STEPS": 2, "WINDOWS": 1}),
    "handbench": (["1", "2"], {"SCAN_STEPS": 2, "WINDOWS": 1}),
    "ingestbench": ([], {}),
    "jpegbench": ([], {}),
}
# JAX's printed lines (format strings of the scripts' print calls).
LINES = {
    "identifybench": [rf"batch   1 G=16  {a:10s} +[\d.]+ ms/step \(\d+ fps\)" for a in ("identify", "track-only")],
    "gatebench": [rf"batch    1  {p:14s} +\d+ fps"
                  for p in ("vmap", "gated", "gated-worst", "landmark-only", "landmark-exact")],
    "detbench": [rf"batch    1  {p:16s} +[\d.]+ ms/step" for p in
                 ("letterbox-exact", "letterbox-fast", "letterbox-takes", "det-cnn", "detect-roi", "track-batch")],
    "multifacebench": [rf"batch   1x2  {a:13s} +[\d.]+ ms/step \(\d+ fps, \d+ faces/s\)"
                       for a in ("gated", "sample-slots", "lm-cnn", "track-slots")],
    "handbench": [rf"batch   1x2  {a:14s} +[\d.]+ ms/step \(\d+ fps\)"
                  for a in ("gated", "sample-slots", "lm-cnn", "detect", "track-slots")],
    "jpegbench": [rf" *{b}: +[\d.]+ ms/frame  \( *[\d.]+ MP/s\)" for b in ("cv2", "pil", "native")],
}


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_runs(name, tmp_path, monkeypatch, capsys):
    """Each single-purpose script with ``--device cpu`` at a small size:
    JAX's records or printed lines."""
    mod = importlib.import_module(f"zaru_tpu_torch.examples.{name}")
    args, consts = SCRIPTS[name]
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    out = tmp_path / "r.jsonl"
    if name == "irisbench":
        args = [*args, str(out)]
    elif name == "ingestbench":
        args = [str(out)]
    mod.main([*args, "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    if name in LINES:
        assert len(printed) == len(LINES[name]), printed
        for line, pat in zip(printed, LINES[name]):
            assert re.fullmatch(pat, line), (line, pat)
    if name in ("irisbench", "ingestbench"):
        recs = read_records(out)
        assert_jax_keys(recs)
        kinds = [r["bench"] for r in recs]
        if name == "irisbench":
            assert kinds == ["iris_cascade"] and recs[0]["tracked"] > 0.5
            assert json.loads(printed[-1])["ms_per_step"] == recs[0]["ms_per_step"]
        else:
            assert not any("skipped" in r for r in recs), recs
            assert kinds.count("decode_1thread") == 2 and kinds.count("upload") == 2
            assert kinds[-1] == "e2e_ingest_cascade" and recs[-1]["link"] == "local" and recs[-1]["tracked"] > 0.5


def test_missing_backends_are_skipped(tmp_path, monkeypatch, capsys):
    """Without OpenCV, PIL or the native library (a GPU machine may lack
    them all) jpegbench prints a ``skipped`` line for each backend and
    ingestbench writes ``skipped`` records for its decode and e2e sections:
    no number from a backend that stood in for another."""
    from zaru_tpu_torch import native
    from zaru_tpu_torch.examples import ingestbench, jpegbench

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("ZARU_TPU_NATIVE", "0")
    jpegbench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == ["cv2", "pil", "native"]
    assert all("skipped" in ln for ln in lines), lines
    out = tmp_path / "r.jsonl"
    ingestbench.main([str(out), "decode", "e2e", "--device", "cpu"])
    recs = read_records(out)
    assert_jax_keys(recs)
    assert [r["bench"] for r in recs] == ["decode_1thread", "decode_1thread", "decode_pool", "e2e_ingest_cascade"]
    assert all("no JPEG encoder" in r["skipped"] for r in recs), recs


def test_scripts_raise_without_a_gpu(monkeypatch, tmp_path):
    """Without ``--device cpu`` and without a GPU every script that runs on
    the device raises before it loads a model, rather than run on the CPU
    (jpegbench decodes on the host and takes no device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchsuite.main(["cascade", "--out", str(tmp_path / "b.jsonl")])
    for name in ("irisbench", "identifybench", "gatebench", "detbench", "multifacebench", "handbench"):
        mod = importlib.import_module(f"zaru_tpu_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["1"])
    from zaru_tpu_torch.examples import ingestbench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingestbench.main([str(tmp_path / "i.jsonl"), "upload"])
