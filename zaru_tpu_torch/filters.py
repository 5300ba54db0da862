"""Filters (zaru_tpu/filters.py): each a pure ``(state, value) -> (state,
out)`` function over state arrays of any shape, with an ``init`` mask for
the first value.

- :class:`OneEuroFilter` (:125) on tensors for the trackers
  (``init_state(shape, device)``), and on numpy arrays for the host engines
  (``init_state(shape)``), the JAX package's numpy branch op for op;
- the host filters the engines take: :class:`Ema` (:53, which
  :class:`~zaru_tpu_torch.timer.Timer` smooths its spans with),
  :class:`AlphaBetaFilter` (:77), :class:`NoopFilter` (:180), the
  single-variable bundle :class:`SimpleFilter` (:189) and
  :class:`TimedFilterAdapter` (:220), which gives a time-based filter the
  wall-clock time since its last value.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .num import div

__all__ = [
    "AlphaBetaFilter",
    "Ema",
    "FilterParams",
    "NoopFilter",
    "OneEuroFilter",
    "SimpleFilter",
    "TimedFilterAdapter",
]


class FilterParams:
    """Base of the filters: the parameters; the state is per variable. A
    ``time_based`` filter's ``apply`` also takes the elapsed seconds."""

    time_based = False

    def init_state(self, shape=(), dtype=np.float32):
        raise NotImplementedError

    def apply(self, state, value):
        raise NotImplementedError


@dataclass(frozen=True)
class Ema(FilterParams):
    """Exponential moving average on the host (reference filter/ema.rs:7-51).

    ``alpha`` near 1.0 favours recent values.
    """

    alpha: float

    def __post_init__(self):
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"EMA alpha {self.alpha} is outside [0, 1]")

    def init_state(self, shape=(), dtype=np.float32):
        return {"last": np.zeros(shape, dtype), "init": np.zeros(shape, bool)}

    def apply(self, state, value):
        avg = self.alpha * value + (1.0 - self.alpha) * state["last"]
        out = np.where(state["init"], avg, value)
        return {"last": out, "init": np.ones_like(state["init"])}, out


@dataclass(frozen=True)
class AlphaBetaFilter(FilterParams):
    """Alpha-beta filter, predicting the value and its rate of change
    (reference filter/alpha_beta.rs:18-62), on the host."""

    alpha: float
    beta: float
    time_based = True

    def __post_init__(self):
        if not (0.0 <= self.alpha <= 1.0 and 0.0 <= self.beta <= 1.0):
            raise ValueError(f"alpha-beta parameters {self} are outside [0, 1]")

    def init_state(self, shape=(), dtype=np.float32):
        return {"x": np.zeros(shape, dtype), "v": np.zeros(shape, dtype), "init": np.zeros(shape, bool)}

    def apply(self, state, value, elapsed):
        prediction = state["x"] + state["v"] * elapsed
        residual = value - prediction
        x_new = prediction + self.alpha * residual
        # A zero interval holds the velocity instead of dividing by zero.
        safe_dt = np.where(elapsed > 0, elapsed, 1.0)
        v_upd = state["v"] + self.beta * residual / safe_dt
        v_new = np.where(elapsed > 0, v_upd, state["v"])
        out = np.where(state["init"], x_new, value)
        return {"x": out, "v": np.where(state["init"], v_new, state["v"]),
                "init": np.ones_like(state["init"])}, out


def _smoothing_factor(t_e, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


@dataclass(frozen=True)
class OneEuroFilter(FilterParams):
    """The 1€ filter: ``min_cutoff`` is the minimum cutoff frequency (lower:
    less jitter, more lag), ``beta`` the speed coefficient (higher: less
    lag)."""

    min_cutoff: float
    beta: float
    d_cutoff: float = 1.0
    time_based = True

    def __post_init__(self):
        if not (self.min_cutoff > 0.0 and self.beta >= 0.0):
            raise ValueError(f"invalid 1€ parameters {self}")

    def with_d_cutoff(self, d_cutoff: float) -> "OneEuroFilter":
        return OneEuroFilter(self.min_cutoff, self.beta, d_cutoff)

    def init_state(self, shape=(), device=None, dtype=np.float32) -> dict:
        """Tensors on ``device``, or numpy arrays for the host when it is
        left out."""
        if device is None:
            return {"x": np.zeros(shape, dtype), "dx": np.zeros(shape, dtype), "init": np.zeros(shape, bool)}
        return {
            "x": torch.zeros(shape, dtype=torch.float32, device=device),
            "dx": torch.zeros(shape, dtype=torch.float32, device=device),
            "init": torch.zeros(shape, dtype=torch.bool, device=device),
        }

    def apply(self, state: dict, value, elapsed):
        """One filter step: ``(new_state, smoothed value)``. ``elapsed == 0``
        is valid: the derivative term is 0 and the output is the previous
        estimate (the guard of filters.py:154-163)."""
        if not isinstance(value, torch.Tensor):
            return self._apply_host(state, value, elapsed)
        a_d = _smoothing_factor(elapsed, self.d_cutoff)
        if elapsed > 0:
            dx = div(value - state["x"], elapsed)
        else:
            dx = torch.zeros_like(value)
        dx_hat = a_d * dx + (1.0 - a_d) * state["dx"]
        cutoff = self.min_cutoff + self.beta * torch.abs(dx_hat)
        a = _smoothing_factor(elapsed, cutoff)
        x_hat = a * value + (1.0 - a) * state["x"]
        out = torch.where(state["init"], x_hat, value)
        new_state = {
            "x": out,
            "dx": torch.where(state["init"], dx_hat, torch.zeros_like(dx_hat)),
            "init": torch.ones_like(state["init"]),
        }
        return new_state, out

    def _apply_host(self, state: dict, value, elapsed):
        pos = elapsed > 0
        a_d = _smoothing_factor(elapsed, self.d_cutoff)
        dx = np.where(pos, (value - state["x"]) / np.where(pos, elapsed, 1.0), 0.0)
        dx_hat = a_d * dx + (1.0 - a_d) * state["dx"]
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = _smoothing_factor(elapsed, cutoff)
        x_hat = a * value + (1.0 - a) * state["x"]
        out = np.where(state["init"], x_hat, value)
        return {"x": out, "dx": np.where(state["init"], dx_hat, np.zeros_like(dx_hat)),
                "init": np.ones_like(state["init"])}, out


@dataclass(frozen=True)
class NoopFilter(FilterParams):
    """Pass-through filter (reference filter.rs:153-180)."""

    def init_state(self, shape=(), dtype=np.float32):
        return {}

    def apply(self, state, value, elapsed=None):
        return state, value


class SimpleFilter:
    """Filter + state bundle for a single variable (reference
    filter.rs:117-151). A time-based filter takes ``elapsed`` explicitly, or
    is wrapped in :class:`TimedFilterAdapter`."""

    def __init__(self, params: FilterParams, shape=(), dtype=np.float32):
        self.params = params
        self._shape, self._dtype = shape, dtype
        self.state = params.init_state(shape, dtype=dtype)

    def filter(self, value, elapsed=None):
        if self.params.time_based:
            if elapsed is None:
                raise ValueError("a time-based filter needs `elapsed`")
            self.state, out = self.params.apply(self.state, value, elapsed)
        else:
            self.state, out = self.params.apply(self.state, value)
        return out

    def set_params(self, params: FilterParams) -> None:
        self.params = params

    def reset_state(self) -> None:
        self.state = self.params.init_state(self._shape, dtype=self._dtype)


class TimedFilterAdapter:
    """Gives a time-based filter the wall-clock seconds since its previous
    value (reference filter.rs:91-115; the timestamp moves on each call)."""

    time_based = False

    def __init__(self, params: FilterParams, clock=time.monotonic):
        if not params.time_based:
            raise ValueError(f"{params} is not time-based")
        self.params = params
        self._clock = clock
        self._last = clock()

    def init_state(self, shape=(), dtype=np.float32):
        return self.params.init_state(shape, dtype=dtype)

    def apply(self, state, value):
        now = self._clock()
        elapsed = now - self._last
        self._last = now
        return self.params.apply(state, value, np.float32(elapsed))
