"""Static cost of an imported graph (zaru_tpu/onnx/analysis.py).

:func:`analyze` runs a module once at its input shapes under
``FakeTensorMode`` (no arithmetic, no device memory: the kernels' ops run
their fake kernels) and counts its operations with ``FlopCounterMode``,
into a :class:`CostReport` of FLOPs, parameters and output shapes: the
inputs to a speed-of-light comparison with a measured time.

What counts (JAX's counts come from XLA's ``cost_analysis``, which also
counts elementwise work): a multiply-add is 2 (convolutions, matrix
products, ``FlopCounterMode``'s own formulas), a convolution's bias 1 an
output element, an elementwise arithmetic op (add, subtract, multiply,
divide, min/max, ReLU, clip and the like) 1 an output element; comparisons,
selects, copies and data movement 0. The stage kernel's op counts the
chain it replaces (``ops.cnn_stage.stage_flops``: ``B·H·W·C·(2·(9 + C) +
4)`` a block, the two convolutions, their biases, the residual Add and
PReLU's multiply), so a module reports the same FLOPs with and without a
stage plan.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop

__all__ = ["CostReport", "H100_F32_TFLOPS", "analyze"]

# H100 SXM, f32 outside the tensor cores (NVIDIA's data sheet), the rate the
# stage kernel's bound divides by.
H100_F32_TFLOPS = 67.0

aten = torch.ops.aten


@dataclass
class CostReport:
    name: str
    flops: int  # multiply-adds counted as 2
    params: int
    param_bytes: int
    output_shapes: list

    def speed_of_light_us(self, tflops: float = H100_F32_TFLOPS) -> float:
        """Ideal compute time on a device of ``tflops`` peak (default the
        H100's f32 rate)."""
        return self.flops / (tflops * 1e12) * 1e6

    def __str__(self) -> str:
        return (
            f"{self.name}: {self.flops / 1e9:.3f} GFLOP, "
            f"{self.params / 1e6:.2f}M params ({self.param_bytes / 1e6:.1f} MB), "
            f"SoL {self.speed_of_light_us():.1f}us @{H100_F32_TFLOPS:g}TF (H100 f32)"
        )


def _per_element(*_shapes, out_shape=None, **_kwargs) -> int:
    return _numel(out_shape)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _conv_with_bias(x_shape, w_shape, bias_shape, stride, padding, dilation, transposed, *args,
                    out_shape=None, **kwargs) -> int:
    macs = conv_flop.__wrapped__(x_shape, w_shape, bias_shape, stride, padding, dilation, transposed,
                                 out_shape=out_shape)  # the formula itself, on shapes
    return macs + (_numel(out_shape) if bias_shape is not None else 0)


_ELEMENTWISE = (
    aten.add, aten.sub, aten.mul, aten.div, aten.rsub, aten.neg, aten.reciprocal, aten.maximum, aten.minimum,
    aten.relu, aten.clamp, aten.clamp_min, aten.clamp_max, aten.hardtanh, aten.exp, aten.log, aten.sqrt,
    aten.rsqrt, aten.pow, aten.sigmoid, aten.tanh, aten.elu, aten.gelu, aten.abs, aten.floor, aten.ceil,
    aten.round, aten.erf,
)


def _mapping() -> dict:
    mapping = {op: _per_element for op in _ELEMENTWISE}
    mapping[aten.convolution] = _conv_with_bias
    return mapping


def analyze(module, name: str | None = None) -> CostReport:
    """The cost of one forward pass of ``module`` (an ``OnnxModule`` or a
    ``nn.NeuralNetwork``) at its graph's input shapes, symbolic dims taken
    as 1 and every input f32, as JAX's ``analyze`` does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    net = getattr(module, "module", module)
    shapes = [tuple(d if isinstance(d, int) else 1 for d in vi.shape) for vi in net.input_info]
    counter = FlopCounterMode(display=False, custom_mapping=_mapping())
    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True), counter:
        xs = [torch.empty(s, dtype=torch.float32, device=net.device) for s in shapes]
        outs = net(*xs)
    params = net.params()
    return CostReport(
        name=name or net.name,
        flops=int(counter.get_total_flops()),
        params=sum(p.numel() for p in params.values()),
        param_bytes=sum(p.numel() * p.element_size() for p in params.values()),
        output_shapes=[tuple(o.shape) for o in outs],
    )
