"""CNNs on image views (zaru_tpu/nn.py:153-262, ``Cnn``).

A :class:`Cnn` is an ONNX network plus its input resolution and colour
mapper. It samples its inputs from batched frames with the port's samplers
and runs the network on the batch:

- :meth:`Cnn.sample_views_fast`: rotated views through the rotated-ROI
  kernel (``nn.py:182-185``);
- :meth:`Cnn.sample_views_letterbox`: unrotated full-frame letterbox views
  through the letterbox kernel (``nn.py:190-193``);
- :meth:`Cnn.apply_tensor_hwc`: the network on ``[B,h,w,3]`` inputs
  (``nn.py:195-198``, batched instead of ``vmap``-ed);
- :meth:`Cnn.apply_views_fast`, :meth:`Cnn.apply_views_letterbox`: the
  network on views the samplers write in its own planar ``[N,3,h,w]``
  layout, with no copy between the sampler and the network. The pipelines
  use these;
- :meth:`Cnn.sample_view_hwc`, :meth:`Cnn.apply_on_view`: the exact
  sampler (``ops/sampling.view_to_tensor_core``, ``nn.py:232,259``), which
  JAX runs as an XLA gather outside any Pallas kernel and the port runs as
  plain torch on every device; ``apply_on_view`` samples planar. The
  single-stream and ungated steps and ``fast_sampler=False`` use these.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ._device import resolve_device
from .assets import model_path
from .onnx import OnnxModule, load_model
from .ops.letterbox import letterbox_sample
from .ops.rotated_fast import PRESCALE_M, rotated_sample_fast
from .ops.sampling import view_to_tensor_core
from .resolution import Resolution

__all__ = ["ColorMapper", "Cnn"]


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


class Cnn:
    """A CNN operating on image views, with an NCHW ``[1,3,h,w]`` input."""

    def __init__(self, net: OnnxModule, color_mapper: ColorMapper):
        self.net = net
        self.mapper = color_mapper
        if len(net.input_info) != 1:
            raise ValueError(f"a CNN takes exactly 1 input, this one takes {len(net.input_info)}")
        shape = [d if isinstance(d, int) else 1 for d in net.input_info[0].shape]
        if len(shape) != 4 or shape[0] != 1 or shape[1] != 3:
            raise ValueError(f"invalid NCHW model input shape {shape}")
        self._res = Resolution(shape[3], shape[2])

    @staticmethod
    def load(filename: str, color_mapper: ColorMapper, device=None, output_subset=None) -> "Cnn":
        """Loads ``filename`` from the model directories onto ``device``
        (``cuda`` unless named); ``output_subset`` selects the network's
        outputs by name or position (zaru_tpu/nn.py:126
        ``with_output_selection_by_index``)."""
        return Cnn(load_model(model_path(filename), resolve_device(device), output_subset), color_mapper)

    def input_resolution(self) -> Resolution:
        return self._res

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
        """The network on pre-sampled ``[B,h,w,3]`` f32 inputs."""
        return self.net(t_hwc.permute(0, 3, 1, 2).contiguous())

    def apply_views_fast(
        self, frames_u8, rrects, prescale_m: int = PRESCALE_M, mirror=None
    ) -> list[torch.Tensor]:
        """The network on the rotated views of ``rrects [B,...,5]``, sampled
        planar: outputs over the ``N`` views flattened in rect order."""
        xs = self.sample_views_fast(frames_u8, rrects, prescale_m, "NCHW", mirror)
        return self.net(xs.reshape(-1, *xs.shape[-3:]))

    def apply_views_letterbox(self, frames_u8, rrects) -> list[torch.Tensor]:
        """The network on the letterbox views of ``rrects [B,5]``, sampled
        planar."""
        return self.net(self.sample_views_letterbox(frames_u8, rrects, "NCHW"))

    def sample_view_hwc(self, frames_u8, rrects, mirror=None):
        """Exact rotated views: ``[B,H,W,4] u8`` + ``[B,...,5]`` rects →
        ``[B,...,h,w,3] f32``; ``mirror`` flips the slots it flags."""
        r, m = self._res, self.mapper
        return view_to_tensor_core(frames_u8, rrects, r.width, r.height, m.lo, m.hi, "NHWC", mirror)

    def apply_on_view(self, frames_u8, rrects, mirror=None) -> list[torch.Tensor]:
        """The network on the exact rotated views of ``rrects [B,...,5]``,
        sampled planar: outputs over the ``N`` views flattened in rect
        order."""
        r, m = self._res, self.mapper
        xs = view_to_tensor_core(frames_u8, rrects, r.width, r.height, m.lo, m.hi, "NCHW", mirror)
        return self.net(xs.reshape(-1, *xs.shape[-3:]))
