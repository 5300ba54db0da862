"""Filters: the 1€ filter on tensors (zaru_tpu/filters.py:125-175,
``OneEuroFilter`` ``init_state`` :145 and ``apply`` :152) for the trackers,
and the host-side ``Ema`` (:53) and ``SimpleFilter`` (:189) that
:class:`~zaru_tpu_torch.timer.Timer` smooths its spans with (numpy)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .num import div

__all__ = ["Ema", "OneEuroFilter", "SimpleFilter"]


@dataclass(frozen=True)
class Ema:
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


class SimpleFilter:
    """Filter + state bundle for a single variable (reference
    filter.rs:117-151)."""

    def __init__(self, params, shape=(), dtype=np.float32):
        self.params = params
        self._shape, self._dtype = shape, dtype
        self.state = params.init_state(shape, dtype)

    def filter(self, value):
        self.state, out = self.params.apply(self.state, value)
        return out

    def reset_state(self) -> None:
        self.state = self.params.init_state(self._shape, self._dtype)


def _smoothing_factor(t_e: float, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


@dataclass(frozen=True)
class OneEuroFilter:
    """The 1€ filter: ``min_cutoff`` is the minimum cutoff frequency (lower:
    less jitter, more lag), ``beta`` the speed coefficient (higher: less
    lag)."""

    min_cutoff: float
    beta: float
    d_cutoff: float = 1.0

    def __post_init__(self):
        if not (self.min_cutoff > 0.0 and self.beta >= 0.0):
            raise ValueError(f"invalid 1€ parameters {self}")

    def init_state(self, shape, device) -> dict:
        return {
            "x": torch.zeros(shape, dtype=torch.float32, device=device),
            "dx": torch.zeros(shape, dtype=torch.float32, device=device),
            "init": torch.zeros(shape, dtype=torch.bool, device=device),
        }

    def apply(self, state: dict, value, elapsed: float):
        """One filter step: ``(new_state, smoothed value)``. ``elapsed == 0``
        is valid: the derivative term is 0 and the output is the previous
        estimate (the guard of filters.py:154-163)."""
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
