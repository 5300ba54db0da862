"""The stored JAX runs that hold the executor to the JAX importer.

``fixtures/onnx_dialect.npz`` keeps, under ``<group>/<case>/<field>``, each
case's ONNX graph (or the bundled ``model`` it loads), its inputs, JAX's
outputs, its ``tol`` and, where it has one, its ``layout``. The groups are
``ops`` (tests/test_torch_onnx_ops.py), ``fuzz`` (test_torch_onnx_fuzz.py)
and ``layout`` (test_torch_onnx_layout.py); those files write them and
check the port against them on the CPU, and ``chip_smoke.py`` replays them
on the card. Both read them with :func:`load` and judge them with
:func:`compare`, so the tolerance rule has one definition:

- ``exact``, and any integer or bool result: equal values;
- ``ulp:N``: within N ulps, elementwise;
- ``abs:X``: within ``X·max(1, |want|max)``, absolute;
- ``cnn``: the repo's CNN bar, ``|got − want| ≤ 1e-3·max(1, |want|max) +
  2e-3·|want|``;
- ``bf16:N``: within N bf16 ulps of ``max(1, |want|max)``.

NaNs must sit where JAX's are.
"""

from __future__ import annotations

import numpy as np

from ..assets import fixture_path

__all__ = ["FIXTURE", "compare", "load"]

FIXTURE = "onnx_dialect.npz"


def load(prefix: str = "") -> dict:
    """``{name: {"graph": bytes, "tol": str, "ins": [...], "outs": [...],
    ...}}`` of the cases under ``prefix`` (names without it); the other
    string fields (``layout``, ``model``) as ``str``."""
    cases: dict = {}
    with np.load(fixture_path(FIXTURE)) as f:
        for k in f.files:
            if k.startswith(prefix):
                name, field = k[len(prefix):].rsplit("/", 1)
                cases.setdefault(name, {})[field] = f[k]
    out = {}
    for name, c in cases.items():
        case = {"ins": [c[f"in{i}"] for i in range(sum(k.startswith("in") for k in c))],
                "outs": [c[f"out{i}"] for i in range(sum(k.startswith("out") for k in c))]}
        for k, v in c.items():
            if k == "graph":
                case[k] = v.tobytes()
            elif not k.startswith(("in", "out")):
                case[k] = str(v)
        out[name] = case
    return out


def _ordered(a: np.ndarray) -> np.ndarray:
    """f32 values as integers in the order of their values, one apart an ulp."""
    i = a.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def compare(got: np.ndarray, want: np.ndarray, tol: str) -> tuple[bool, float]:
    """``(ok, error)`` of ``got`` against JAX's ``want`` at ``tol`` (see the
    module docstring): the error is the count of unequal values (``exact``,
    integers), the largest ulp distance (``ulp:N``), the largest absolute
    difference (``abs:X``, ``cnn``) or that in bf16 ulps (``bf16:N``)."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return False, float("inf")
    if tol == "exact" or want.dtype.kind in "biu":
        got = got.astype(want.dtype)
        differ = got != want
        if want.dtype.kind == "f":
            differ &= ~(np.isnan(got) & np.isnan(want))
        n = int(differ.sum())
        return n == 0, n
    got = got.astype(np.float32)
    want = want.astype(np.float32)
    nan = np.isnan(want)
    if (np.isnan(got) != nan).any():
        return False, float("inf")
    got, want = got[~nan], want[~nan]
    if not want.size:
        return True, 0.0
    if tol.startswith("ulp:"):
        u = int(np.abs(_ordered(got) - _ordered(want)).max())
        return u <= int(tol[4:]), u
    err = np.where(got == want, 0.0, np.abs(got - want))  # infinities of one sign agree
    top = max(1.0, float(np.abs(want).max()))
    if tol == "cnn":
        return bool((err <= 1e-3 * top + 2e-3 * np.abs(want)).all()), float(err.max())
    if tol.startswith("bf16:"):
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        return float(err.max()) <= int(tol[5:]) * ulp, float(err.max()) / ulp
    return float(err.max()) <= float(tol[4:]) * top, float(err.max())
