"""Fine-tuning an imported model (zaru_tpu/train.py:27-61).

:class:`Trainer` fits an ``OnnxModule``'s parameters with a ``torch.optim``
optimizer (Adam at ``lr=1e-4`` unless given: optax's ``adam(1e-4)``, the
same update in another rounding) to :func:`landmark_mse_loss` or any loss of
``(x, y)``.

Two things of the executor shape it:

- the parameters are built frozen (``requires_grad=False``): the trainer
  makes them trainable;
- the stage plan runs each BlazeBlock chain through the stage kernel from a
  packed copy of the weights, and the kernel's op has no gradient. So the
  trainer differentiates the graph node by node (``stages=False``, the graph
  JAX differentiates), on the live parameters, and packs the weights again
  after every step (``OnnxModule._derive_weights``), so that inference
  through the stage kernel sees the trained weights.

``make_data_parallel_train_step`` (training over a device mesh) is not
ported yet: it comes with the slice that shards over devices.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["Trainer", "landmark_mse_loss"]


def _module(model):
    """An ``OnnxModule`` from itself or a ``nn.NeuralNetwork``."""
    return getattr(model, "module", model)


def landmark_mse_loss(model, output_index: int = 0) -> Callable:
    """``loss(x, y) = mean((out.reshape(y.shape) - y)**2)`` of the model's
    output ``output_index``, the chains run node by node: the natural loss
    for landmark regressors."""
    module = _module(model)

    def loss_fn(x, y):
        out = module(x, stages=False)[output_index]
        return torch.mean((out.reshape(y.shape) - y) ** 2)

    return loss_fn


class Trainer:
    """A minimal trainer over a model's parameters (``params``: the live
    ``{onnx name: parameter}`` dict, trained in place)."""

    def __init__(self, model, loss_fn=None, optimizer: torch.optim.Optimizer | None = None):
        self.module = _module(model)
        self.loss_fn = loss_fn or landmark_mse_loss(self.module)
        self.params = self.module.params()
        for p in self.params.values():
            p.requires_grad_(True)
        self.optimizer = optimizer or torch.optim.Adam(list(self.params.values()), lr=1e-4)

    def train_step(self, x, y) -> float:
        """One optimizer step on a batch; returns the loss before the
        step."""
        device = self.module.device
        x = torch.as_tensor(x, device=device)
        y = torch.as_tensor(y, device=device)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(x, y)
        loss.backward()
        self.optimizer.step()
        self.module._derive_weights()
        return float(loss.detach())
