"""Approximate float comparison with abs/rel/ULP tolerances: the port's
own copy of zaru_tpu/approx.py (reference crates/zaru-linalg/src/approx.rs,
`ApproxEq` + `assert_approx_eq!`). Operates on scalars, arrays and tensors
(copied to the host).

It keeps the JAX package's behaviour where that differs from the
reference (ADVICE.md): ``ulps_diff_eq`` takes the sign from ``a < 0``, not
the sign bit, so -0.0 and a negative denormal one ulp away compare unequal;
``abs_diff_eq`` and ``rel_diff_eq`` have no short-circuit for non-finite
values, so ``inf`` against ``inf`` is unequal (``|inf - inf|`` is NaN).
"""

from __future__ import annotations

import numpy as np

from .num import to_numpy


def abs_diff_eq(a, b, abs_tolerance) -> bool:
    a, b = np.asarray(to_numpy(a), np.float32), np.asarray(to_numpy(b), np.float32)
    return bool(np.all(np.abs(a - b) <= abs_tolerance))


def rel_diff_eq(a, b, rel_tolerance) -> bool:
    """Relative comparison against the larger magnitude (approx.rs)."""
    a, b = np.asarray(to_numpy(a), np.float32), np.asarray(to_numpy(b), np.float32)
    scale = np.maximum(np.abs(a), np.abs(b))
    return bool(np.all(np.abs(a - b) <= rel_tolerance * scale))


def ulps_diff_eq(a, b, ulps_tolerance: int) -> bool:
    """Units-in-last-place comparison on float32 bit patterns.

    Reference contract (approx.rs:38-42): NaN is never equal to
    anything; -0.0 and +0.0 are always equal (their monotonic integer
    images coincide)."""
    a = np.asarray(to_numpy(a), np.float32)
    b = np.asarray(to_numpy(b), np.float32)
    if np.any(np.isnan(a)) or np.any(np.isnan(b)):
        return False
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    # Map negative floats to a monotonic integer line.
    ai = np.where(ai < 0, np.int64(-(2**31)) - ai, ai)
    bi = np.where(bi < 0, np.int64(-(2**31)) - bi, bi)
    same_sign = (a < 0) == (b < 0)
    return bool(np.all(same_sign & (np.abs(ai - bi) <= ulps_tolerance)))


def assert_approx_eq(a, b, abs=None, rel=None, ulps=None, msg=""):
    """Assert approximate equality, reference semantics (approx.rs
    Asserter::equal, 175-193): the values are equal if ANY supplied
    comparison passes (OR, not AND); with no tolerances supplied, the
    defaults are abs=f32 epsilon OR rel=f32 epsilon
    (approx.rs:59-60)."""
    eps = float(np.finfo(np.float32).eps)
    if abs is None and rel is None and ulps is None:
        abs, rel = eps, eps
    ok = False
    if abs is not None:
        ok = ok or abs_diff_eq(a, b, abs)
    if rel is not None:
        ok = ok or rel_diff_eq(a, b, rel)
    if ulps is not None:
        ok = ok or ulps_diff_eq(a, b, ulps)
    if not ok:
        raise AssertionError(f"assert_approx_eq failed: {a!r} !~ {b!r} {msg}")
