"""Networks and CNNs on image views (zaru_tpu/nn.py).

A :class:`NeuralNetwork` (nn.py:59) is a loaded ONNX graph on a device
that runs raw tensors (:meth:`NeuralNetwork.estimate`); :class:`Loader`
(:113) builds one with an output selection. A :class:`Cnn` (:153) is a
network plus its input layout (:class:`CnnInputShape`), resolution and
colour mapper. :meth:`Cnn.estimate` runs it on one image or view through
the exact sampler, stretching on an aspect mismatch as JAX does (:264);
the pipelines sample their inputs from batched frames with the port's
samplers and run the network on the batch:

- :meth:`Cnn.sample_views_fast`: rotated views through the rotated-ROI
  kernel (``nn.py:182-185``);
- :meth:`Cnn.sample_views_letterbox`: unrotated full-frame letterbox views
  through the letterbox kernel (``nn.py:190-193``);
- :meth:`Cnn.apply_tensor_hwc`: the network on ``[B,h,w,3]`` inputs
  (``nn.py:195-198``, batched instead of ``vmap``-ed);
- :meth:`Cnn.apply_views_fast`, :meth:`Cnn.apply_views_letterbox`: the
  network on views the samplers write in its own layout, with no copy
  between the sampler and the network: planar ``[N,3,h,w]`` for an NCHW
  module; for an NHWC-layout module (``NeuralNetwork.load(layout="NHWC")``,
  ``onnx/layout.py``) the samplers' NHWC stores, handed to the network as
  the ``permute(0, 3, 1, 2)`` view, which is channels_last, as JAX's
  ``Cnn`` feeds ``apply_nhwc`` (nn.py:171-176). The pipelines use these;
- :meth:`Cnn.sample_view_hwc`, :meth:`Cnn.apply_on_view`: the exact
  sampler (``ops/sampling.view_to_tensor_core``, ``nn.py:232,259``), which
  JAX runs as an XLA gather outside any Pallas kernel and the port runs as
  plain torch on every device; ``apply_on_view`` samples planar. The
  single-stream and ungated steps and ``fast_sampler=False`` use these.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence

import torch

from ._device import resolve_device
from .assets import model_path
from .image import as_view
from .onnx import OnnxModule, load_model
from .ops.letterbox import letterbox_sample
from .ops.rotated_fast import PRESCALE_M, rotated_sample_fast
from .ops.sampling import view_to_tensor_core
from .resolution import Resolution

__all__ = ["CnnInputShape", "ColorMapper", "Cnn", "NeuralNetwork", "Loader"]


class CnnInputShape(enum.Enum):
    """A CNN's input layout: ``[1,3,h,w]`` or ``[1,h,w,3]``
    (zaru_tpu/nn.py:35)."""

    NCHW = "NCHW"
    NHWC = "NHWC"


@dataclass(frozen=True)
class ColorMapper:
    """Linear sRGB → ``[lo, hi]`` mapper (zaru_tpu/nn.py:42)."""

    lo: float
    hi: float

    @staticmethod
    def linear(lo: float, hi: float) -> "ColorMapper":
        if not hi > lo:
            raise ValueError(f"colour range [{lo}, {hi}] is empty")
        return ColorMapper(lo, hi)


class NeuralNetwork:
    """A loaded ONNX network on a device (zaru_tpu/nn.py:59): the graph's
    inputs and outputs, its parameters by ONNX initializer name, and
    :meth:`estimate` on raw tensors."""

    def __init__(self, module: OnnxModule):
        self.module = module

    @staticmethod
    def load(path_or_bytes, *, output_subset=None, compute_dtype=None, device=None, layout=None) -> "NeuralNetwork":
        """Parses an ONNX file (or its bytes) onto ``device`` (``cuda``
        unless named); ``output_subset`` selects the outputs by name or
        position; ``compute_dtype=torch.bfloat16`` runs the body in bf16
        (the outputs stay f32; None is f32); ``layout="NHWC"`` keeps the
        activations channels_last (None is ``"NCHW"``)."""
        return NeuralNetwork(load_model(path_or_bytes, resolve_device(device), output_subset, compute_dtype,
                                        layout or "NCHW"))

    @property
    def device(self) -> torch.device:
        return self.module.device

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The float initializers by ONNX name."""
        return self.module.params()

    def load_params(self, params: dict) -> None:
        """Replaces the weights with ``{onnx name: array}`` (for instance
        :func:`zaru_tpu_torch.weights.network_params_from_jax` of a JAX
        ``NeuralNetwork.params``)."""
        self.module.load_params(params)

    def num_inputs(self) -> int:
        return len(self.module.input_info)

    def num_outputs(self) -> int:
        return len(self.module.output_names)

    def inputs(self) -> list:
        return list(self.module.input_info)

    def outputs(self) -> list:
        return list(self.module.output_info)

    def estimate(self, *tensors) -> list[torch.Tensor]:
        """The outputs for raw input tensors, on the network's device."""
        with torch.inference_mode():
            return self.module(*(torch.as_tensor(t, device=self.device) for t in tensors))


class Loader:
    """Builder of a :class:`NeuralNetwork` (zaru_tpu/nn.py:113)."""

    def __init__(self, path_or_bytes, device=None):
        self._src = path_or_bytes
        self._device = device
        self._output_subset = None
        self._compute_dtype = None
        self._layout = None

    def with_output_selection(self, names: Sequence[str]) -> "Loader":
        self._output_subset = list(names)
        return self

    def with_output_selection_by_index(self, indices: Sequence[int]) -> "Loader":
        self._output_subset = [int(i) for i in indices]
        return self

    def with_bf16(self) -> "Loader":
        """Runs the network body in bf16 (zaru_tpu/nn.py:132)."""
        self._compute_dtype = torch.bfloat16
        return self

    def with_layout(self, layout: str) -> "Loader":
        """The activations' layout (zaru_tpu/nn.py:138): ``"NCHW"``, the
        ONNX layout, or ``"NHWC"``, channels_last (``onnx/layout.py``)."""
        self._layout = layout
        return self

    def load(self) -> NeuralNetwork:
        return NeuralNetwork.load(
            self._src, output_subset=self._output_subset, compute_dtype=self._compute_dtype, device=self._device,
            layout=self._layout,
        )


class Cnn:
    """A CNN operating on image views (zaru_tpu/nn.py:153): a network with
    one ``[1,3,h,w]`` (NCHW) or ``[1,h,w,3]`` (NHWC) input, and the colour
    mapper its inputs take. An NCHW graph in an NHWC-layout module is fed
    NHWC samples through a permuted view (the module docstring)."""

    def __init__(self, nn: NeuralNetwork, shape: CnnInputShape, color_mapper: ColorMapper):
        self.nn = nn
        self.net = nn.module
        self.shape = shape
        self.mapper = color_mapper
        if nn.num_inputs() != 1:
            raise ValueError(f"a CNN takes exactly 1 input, this one takes {nn.num_inputs()}")
        t = [d if isinstance(d, int) else 1 for d in nn.inputs()[0].shape]
        if shape == CnnInputShape.NCHW and len(t) == 4 and t[0] == 1 and t[1] == 3:
            self._res = Resolution(t[3], t[2])
        elif shape == CnnInputShape.NHWC and len(t) == 4 and t[0] == 1 and t[3] == 3:
            self._res = Resolution(t[2], t[1])
        else:
            raise ValueError(f"invalid model input shape for {shape}: {t}")
        # The samplers' layout: the graph's own, or NHWC for an NCHW graph
        # whose module keeps its activations channels_last.
        self._layout = "NHWC" if nn.module.layout == "NHWC" else shape.value
        self._permute = shape == CnnInputShape.NCHW and self._layout == "NHWC"

    @staticmethod
    def load(
        filename: str, color_mapper: ColorMapper, device=None, output_subset=None, compute_dtype=None,
        layout=None,
    ) -> "Cnn":
        """Loads the NCHW network ``filename`` from the model directories
        onto ``device`` (``cuda`` unless named); ``output_subset`` selects
        its outputs by name or position (zaru_tpu/nn.py:126
        ``with_output_selection_by_index``), ``compute_dtype`` the dtype of
        its body, ``layout`` its activations' (:meth:`NeuralNetwork.load`)."""
        nn = NeuralNetwork.load(
            model_path(filename), output_subset=output_subset, compute_dtype=compute_dtype, device=device,
            layout=layout,
        )
        return Cnn(nn, CnnInputShape.NCHW, color_mapper)

    @property
    def layout(self) -> str:
        """The layout its samplers write for it (``"NCHW"`` planar or
        ``"NHWC"``): the one :meth:`apply_samples` takes."""
        return self._layout

    def apply_samples(self, xs) -> list[torch.Tensor]:
        """The network on samples in :attr:`layout`, ``[N,...]`` with the
        sample's three trailing axes (what the ``apply_views_*`` methods run
        on their samples)."""
        xs = xs.reshape(-1, *xs.shape[-3:])
        return self.net(xs.permute(0, 3, 1, 2) if self._permute else xs)

    def input_resolution(self) -> Resolution:
        return self._res

    def estimate(self, image) -> list[torch.Tensor]:
        """The network on one image or view (zaru_tpu/nn.py:264), sampled by
        the exact sampler at batch 1 on the network's device; an aspect
        mismatch stretches the view, as in the reference."""
        view = as_view(image)
        dev = self.nn.device
        rect = torch.from_numpy(view.view_rect.array.copy()).to(dev)
        with torch.inference_mode():
            return self.apply_on_view(view.image.data.to(dev)[None], rect[None])

    def sample_views_fast(
        self, frames_u8, rrects, prescale_m: int = PRESCALE_M, layout: str = "NHWC", mirror=None
    ):
        """``[B,H,W,4] u8`` + ``[B,...,5]`` rects → ``[B,...,h,w,3] f32``
        (or planar ``[B,...,3,h,w]``), through a prescale grid of side
        ``prescale_m``; ``mirror`` flips the slots it flags left to right."""
        r, m = self._res, self.mapper
        return rotated_sample_fast(
            frames_u8, rrects, r.width, r.height, m.lo, m.hi, prescale_m, layout, mirror
        )

    def sample_views_letterbox(self, frames_u8, rrects, layout: str = "NHWC"):
        """``[B,H,W,4] u8`` + ``[B,5]`` unrotated rects → ``[B,h,w,3] f32``
        (or planar ``[B,3,h,w]``)."""
        r, m = self._res, self.mapper
        return letterbox_sample(frames_u8, rrects, r.width, r.height, m.lo, m.hi, layout)

    def apply_tensor_hwc(self, t_hwc) -> list[torch.Tensor]:
        """The network on pre-sampled ``[B,h,w,3]`` f32 inputs (an
        NHWC-layout module takes them as the permuted view, no copy)."""
        if self.shape == CnnInputShape.NHWC:
            return self.net(t_hwc)
        t = t_hwc.permute(0, 3, 1, 2)
        return self.net(t if self._permute else t.contiguous())

    def apply_views_fast(
        self, frames_u8, rrects, prescale_m: int = PRESCALE_M, mirror=None
    ) -> list[torch.Tensor]:
        """The network on the rotated views of ``rrects [B,...,5]``, sampled
        in the network's own layout (planar, or NHWC for an NHWC-layout
        module): outputs over the ``N`` views flattened in rect order."""
        return self.apply_samples(self.sample_views_fast(frames_u8, rrects, prescale_m, self._layout, mirror))

    def apply_views_letterbox(self, frames_u8, rrects) -> list[torch.Tensor]:
        """The network on the letterbox views of ``rrects [B,5]``, sampled
        in the network's own layout."""
        return self.apply_samples(self.sample_views_letterbox(frames_u8, rrects, self._layout))

    def sample_view_hwc(self, frames_u8, rrects, mirror=None):
        """Exact rotated views: ``[B,H,W,4] u8`` + ``[B,...,5]`` rects →
        ``[B,...,h,w,3] f32``; ``mirror`` flips the slots it flags."""
        r, m = self._res, self.mapper
        return view_to_tensor_core(frames_u8, rrects, r.width, r.height, m.lo, m.hi, "NHWC", mirror)

    def sample_on_view(self, frames_u8, rrects, mirror=None):
        """Exact rotated views of ``rrects [B,...,5]`` in the network's own
        layout (what :meth:`apply_on_view` runs the network on)."""
        r, m = self._res, self.mapper
        return view_to_tensor_core(frames_u8, rrects, r.width, r.height, m.lo, m.hi, self._layout, mirror)

    def apply_on_view(self, frames_u8, rrects, mirror=None) -> list[torch.Tensor]:
        """The network on the exact rotated views of ``rrects [B,...,5]``,
        sampled in the network's own layout: outputs over the ``N`` views
        flattened in rect order."""
        return self.apply_samples(self.sample_on_view(frames_u8, rrects, mirror))
