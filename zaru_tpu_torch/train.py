"""Fine-tuning an imported model (zaru_tpu/train.py:27-108).

:class:`Trainer` fits an ``OnnxModule``'s parameters with a ``torch.optim``
optimizer (Adam at ``lr=1e-4`` unless given: optax's ``adam(1e-4)``, the
same update in another rounding) to :func:`landmark_mse_loss` or any loss of
``(x, y)``.

Two things of the executor shape it:

- the parameters are built frozen (``requires_grad=False``): the trainer
  makes them trainable;
- the plans (``onnx/fusion.py``) run fused blocks through hand-written
  kernels from a packed copy of the weights, and the kernels' ops have no
  gradient. So the trainer differentiates the graph node by node (inside
  ``OnnxModule.without_plans()``, the graph JAX differentiates), on the live
  parameters, and packs the weights again after every step
  (``OnnxModule._derive_weights``), so that inference through the kernels
  sees the trained weights.

:func:`make_data_parallel_train_step` trains over a mesh
(:func:`zaru_tpu_torch.parallel.stream_mesh`) in one process, as JAX's
single-controller step does: the parameters are replicated once per distinct
device of the mesh, the batch is sharded over the mesh's stream axis, each
shard runs forward and backward on its slice (node by node, as above), the
gradients are averaged over the shards (the gradient of the global batch's
mean loss, the shards being equal), and every replica takes the same Adam
update from that average.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .parallel.mesh import Replicated, Sharded, StreamSharding, _canonical, _replica, stream_mesh

__all__ = ["Trainer", "landmark_mse_loss", "make_data_parallel_train_step"]


def _module(model):
    """An ``OnnxModule`` from itself or a ``nn.NeuralNetwork``."""
    return getattr(model, "module", model)


def landmark_mse_loss(model, output_index: int = 0) -> Callable:
    """``loss(x, y) = mean((out.reshape(y.shape) - y)**2)`` of the model's
    output ``output_index``, the chains run node by node: the natural loss
    for landmark regressors."""
    module = _module(model)

    def loss_fn(x, y):
        with module.without_plans():
            out = module(x)[output_index]
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


def make_data_parallel_train_step(model, mesh, *, batch_axis: str = "stream", loss_fn=None, optimizer=None):
    """A data-parallel training step over ``mesh`` (a tuple of devices; see
    the module docstring) → ``(step, params, opt_state, shard_batch)``, as
    in JAX:

    - ``step(params, opt_state, x, y) -> (params, opt_state, loss)``: one
      step on the sharded batch; ``loss`` is the global batch's mean loss
      before the step (a 0-d tensor on the mesh's first device). The step
      updates the replicas in place and returns the same ``params`` and
      ``opt_state``; ``params`` given from elsewhere (a restored checkpoint)
      are copied into the replicas first. After the step each replica's
      parameters hold the averaged gradient in ``.grad``, and its stage
      weights are packed again;
    - ``params``: ``{onnx name: Replicated}``, the replicas' live parameters;
    - ``opt_state``: one optimizer per replica, in mesh order;
    - ``shard_batch(arr)``: an array in the sharded layout (a
      :class:`~zaru_tpu_torch.parallel.Sharded`).

    ``model``: an ``OnnxModule`` or ``nn.NeuralNetwork``; its device may
    keep the model itself as its replica (trained in place, as by
    :class:`Trainer`). ``loss_fn(module) -> loss(x, y)``: the loss of one
    replica's module (:func:`landmark_mse_loss` unless given).
    ``optimizer(parameters) -> torch.optim.Optimizer`` (Adam at ``lr=1e-4``
    unless given). ``batch_axis``: the mesh's one axis, ``"stream"``."""
    if batch_axis != "stream":
        raise ValueError(f"the mesh has one axis, 'stream'; got batch_axis={batch_axis!r}")
    mesh = stream_mesh(mesh)
    sharding = StreamSharding(mesh)
    source = _module(model)
    src = _canonical(source.device)
    modules = {d: source if d == src else _replica(source, src, d) for d in dict.fromkeys(mesh)}
    names = list(source.params())
    live = {d: m.params() for d, m in modules.items()}
    for ps in live.values():
        for p in ps.values():
            p.requires_grad_(True)
    make_loss = loss_fn or landmark_mse_loss
    losses = {d: make_loss(m) for d, m in modules.items()}
    make_opt = optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-4))
    opt_state = tuple(make_opt([live[d][k] for k in names]) for d in modules)
    params = {k: Replicated(live[d][k] for d in modules) for k in names}
    first = mesh[0]

    def step(params, opt_state, x, y):
        with torch.no_grad():
            for k in names:
                for d, c in zip(modules, params[k].copies):
                    if c is not live[d][k]:
                        live[d][k].copy_(c)
        xs, ys = sharding.put(x), sharding.put(y)
        shard_losses, shard_grads = [], []
        for s, d in enumerate(mesh):
            loss = losses[d](xs.shards[s], ys.shards[s])
            grads = torch.autograd.grad(loss, [live[d][k] for k in names], allow_unused=True)
            shard_losses.append(loss.detach().to(first))
            shard_grads.append([None if g is None else g.to(first) for g in grads])
        n = len(mesh)
        # A parameter the loss does not reach keeps no gradient, and the
        # optimizer skips it (as Trainer's backward leaves it).
        mean = [None if shard_grads[0][i] is None else torch.stack([g[i] for g in shard_grads]).sum(0) / n
                for i in range(len(names))]
        for d, opt in zip(modules, opt_state):
            for k, g in zip(names, mean):
                live[d][k].grad = None if g is None else g.to(d, copy=True)
            opt.step()
            modules[d]._derive_weights()
        loss = torch.stack(shard_losses).sum() / n
        return {k: Replicated(live[d][k] for d in modules) for k in names}, opt_state, loss

    def shard_batch(arr) -> Sharded:
        return sharding.put(arr if isinstance(arr, (torch.Tensor, Sharded)) else np.asarray(arr, np.float32))

    return step, params, opt_state, shard_batch
