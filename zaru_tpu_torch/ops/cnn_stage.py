"""The fused BlazeBlock stage: hand-written CUDA kernel and its plain version.

The counterpart of zaru_tpu/ops/cnn_stage.py. A stage is ``nb``
consecutive stride-1 BlazeBlocks on ``[B,C,H,W] f32``::

    x <- PReLU_i(x + pw1x1_i(dw3x3_i(x) + b_dw) + b_pw)

(depthwise 3×3 with zero padding 1 → pointwise 1×1 → residual Add →
PReLU; a ReLU block is PReLU with α = 0). The ONNX executor finds such
chains in the face CNNs (``onnx/fusion.py``) and runs each through
:func:`fused_blocks`: on a CUDA tensor it launches ``csrc/blaze_stage.cu``
(the kernel in ``csrc/blaze_stage.cuh``),
which keeps the stage's activations in shared memory; on a CPU tensor it
runs :func:`blaze_blocks_reference`, the plain version, which is the
executor's own per-op chain (the same ``F.conv2d`` calls, Add and PReLU in
the same order), so on the CPU the executor's numbers do not move.

The kernel reads and writes either memory layout of the logical
``[B,C,H,W]``: an NCHW-contiguous tensor, or a channels_last one (an NHWC
module, ``onnx/layout.py``; ``csrc/blaze_stage_nhwc.cu``), whose output is
channels_last too. The two variants differ only in the index maps of the
global load and store, so they are bit-equal on the same values. Each
counts its launches in ``profiling.counters``: ``launches.blaze_stage``
(NCHW) and ``launches.blaze_stage_nhwc``.

The stage is the registered op ``zaru_tpu_torch::blaze_stage``
(:func:`blaze_stage_op`): its CUDA kernel is the launch, its CPU kernel the
plain version, its fake kernel the output's shape and layout, so
``torch.export`` captures it and ``FakeTensorMode`` runs it; a FLOP formula
(:func:`stage_flops`) lets ``torch.utils.flop_counter`` count it as the
per-op chain it replaces.

Blocks are dicts of ``dw_w [C,1,3,3]``, ``dw_b [C]``, ``pw_w [C,C,1,1]``,
``pw_b [C]`` and ``alpha`` (``[C]``, any shape of C values, or None for a
ReLU), as in the JAX module. :func:`pack_blocks` lays them out for the
kernel: one row of ``C*C + 12*C`` floats per block, the pointwise weights
transposed to ``[C_in, C_out]``, the taps ``[9, C]``, then the depthwise
bias, the pointwise bias and the slopes. There is no image group ``G`` and
no block-diagonal weight inflation: both existed to fill the TPU's MXU.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from torch.utils.flop_counter import register_flop_formula

from .. import profiling
from ._build import library

__all__ = [
    "KERNEL_CHANNELS", "blaze_blocks_reference", "blaze_stage_op", "fused_blocks", "max_blocks", "pack_blocks",
    "stage_flops", "unpack_blocks",
]

SMEM_LIMIT = 232448  # dynamic shared memory one thread block may use (H100)
# The channel counts csrc/blaze_stage.cu is instantiated for: those of the
# face CNNs' chains.
KERNEL_CHANNELS = (16, 24, 32, 64, 96, 128)
THREADS = 256  # threads of a thread block (csrc/blaze_stage.cu kThreads)
# At 16 and 24 channels the kernel holds a pixel's depthwise values in
# registers (see _in_registers), this many pixels a thread (kPixels), so a
# region has at most PIXELS_PER_THREAD[C] * THREADS pixels and needs no
# depthwise buffer.
PIXELS_PER_THREAD = {16: 4, 24: 3}


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def pack_blocks(blocks, C: int) -> torch.Tensor:
    """``blocks`` → the kernel's ``[nb, C*C + 12*C] f32`` layout, on the
    device of the blocks' tensors (the CPU for numpy arrays)."""
    rows = []
    for b in blocks:
        dev = b["dw_w"].device if isinstance(b["dw_w"], torch.Tensor) else None
        dw = _f32(b["dw_w"], dev).reshape(C, 9)
        pw = _f32(b["pw_w"], dev).reshape(C, C)  # [out, in]
        alpha = (torch.zeros(C, device=dw.device) if b["alpha"] is None
                 else _f32(b["alpha"], dev).reshape(C))
        rows.append(torch.cat([
            pw.t().reshape(-1), dw.t().reshape(-1), _f32(b["dw_b"], dev).reshape(C),
            _f32(b["pw_b"], dev).reshape(C), alpha,
        ]))
    return torch.stack(rows).contiguous()


def unpack_blocks(packed, C: int) -> list[dict]:
    """The blocks of :func:`pack_blocks`'s layout; a block whose slopes are
    all zero comes back as a ReLU (``alpha`` None)."""
    blocks = []
    for row in packed:
        pw, rest = row[: C * C], row[C * C:]
        alpha = rest[11 * C:]
        blocks.append({
            "dw_w": rest[: 9 * C].reshape(9, C).t().reshape(C, 1, 3, 3),
            "dw_b": rest[9 * C: 10 * C],
            "pw_w": pw.reshape(C, C).t().reshape(C, C, 1, 1),
            "pw_b": rest[10 * C: 11 * C],
            "alpha": None if not bool(alpha.any()) else alpha,
        })
    return blocks


def blaze_blocks_reference(x, blocks):
    """Plain PyTorch version of the stage on any device and in either
    memory layout (its ops are logical NCHW): per block a depthwise
    ``F.conv2d`` with padding 1, a 1×1 ``F.conv2d``, the residual Add and
    PReLU (``torch.where(y < 0, a·y, y)``, the executor's) or ReLU."""
    C = x.shape[1]
    for b in blocks:
        f = lambda k: _f32(b[k], x.device)  # noqa: E731
        dw = F.conv2d(x, f("dw_w"), f("dw_b"), stride=1, padding=(1, 1), groups=C)
        y = x + F.conv2d(dw, f("pw_w"), f("pw_b"))
        if b["alpha"] is None:
            x = torch.relu(y)
        else:
            x = torch.where(y < 0, f("alpha").reshape(C, 1, 1) * y, y)
    return x


def _in_registers(C: int, rh: int, rw: int) -> bool:
    """Whether the kernel keeps the depthwise values in registers for a
    launch whose unclipped region is ``rh × rw``: at 16 and 24 channels,
    unless the region has no more pixels than half a thread block."""
    return C in PIXELS_PER_THREAD and rh * rw > THREADS // 2


def _smem_bytes(C: int, rh: int, rw: int) -> int:
    """The kernel's shared memory for a region of ``rh × rw`` pixels: the
    activation in its ring of zeros (``[C, rh+1, rw+1]`` and a tail of
    ``rw+2`` zeros rounded up to 4 floats), the depthwise result
    ``[C, rh, rw]`` unless it stays in registers, and one block's packed
    parameters."""
    ds = 0 if _in_registers(C, rh, rw) else C * rh * rw
    return (C * (rh + 1) * (rw + 1) + (rw + 5) // 4 * 4 + ds + C * C + 12 * C) * 4


def _fits(C: int, rh: int, rw: int) -> bool:
    """Whether a region of ``rh × rw`` pixels fits the shared memory and,
    where the depthwise stays in registers, the threads."""
    return _smem_bytes(C, rh, rw) <= SMEM_LIMIT and not (
        _in_registers(C, rh, rw) and rh * rw > PIXELS_PER_THREAD[C] * THREADS)


@functools.lru_cache(maxsize=None)
def max_blocks(C: int) -> int:
    """The most blocks a stage of ``C`` channels may have so that
    :func:`_tiling` finds a tiling at any image size: a 1×1 tile's region,
    ``(1 + 2·nb)²`` pixels, still fits (5 at 128 channels, 15 at 16). The
    executor splits longer chains."""
    nb = 1
    while _fits(C, 3 + 2 * nb, 3 + 2 * nb):
        nb += 1
    return nb


@functools.lru_cache(maxsize=None)
def _tiling(C: int, H: int, W: int, nb: int) -> tuple[int, int, int]:
    """``(tile_h, tile_w, shared-memory bytes)`` for a stage (the bytes
    of an unclipped region, at least any tile's): the even
    tiling that computes the fewest pixels (tile plus recomputed halo),
    where a tiling that needs more than half the shared memory (one thread
    block per SM instead of two) counts 1.5 times its pixels."""
    best = None
    for nty in range(1, H + 1):
        th = -(-H // nty)
        for ntx in range(1, W + 1):
            tw = -(-W // ntx)
            rh, rw = min(H, th + 2 * nb), min(W, tw + 2 * nb)
            region = rh * rw
            smem = _smem_bytes(C, rh, rw)
            if not _fits(C, rh, rw):
                continue
            cost = nty * ntx * region * (1.0 if smem <= SMEM_LIMIT // 2 - 1024 else 1.5)
            if best is None or cost < best[0]:
                best = (cost, th, tw, smem)
    if best is None:
        raise ValueError(f"a stage of {C} channels and {nb} blocks does not fit the shared memory "
                         f"(at most {max_blocks(C)} blocks fit at any size)")
    return best[1:]


def _check(x, packed, H, W, C):
    if x.dtype != torch.float32 or x.ndim != 4 or tuple(x.shape[1:]) != (C, H, W):
        raise ValueError(f"x must be [B,{C},{H},{W}] float32, got {tuple(x.shape)} {x.dtype}")
    if (packed.dtype != torch.float32 or packed.ndim != 2 or packed.shape[1] != C * C + 12 * C
            or packed.shape[0] < 1 or packed.device != x.device):
        raise ValueError(f"packed must be [nb,{C * C + 12 * C}] float32 on {x.device}, "
                         f"got {tuple(packed.shape)} {packed.dtype} on {packed.device}")


@torch.library.custom_op("zaru_tpu_torch::blaze_stage", mutates_args=(), device_types="cuda")
def blaze_stage_op(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The stage as a registered op on ``x [B,C,H,W] f32`` and its packed
    blocks: the CUDA kernel launches ``csrc/blaze_stage.cu`` (an
    NCHW-contiguous ``x``) or ``csrc/blaze_stage_nhwc.cu`` (a channels_last
    one) once and counts it in ``profiling.counters["launches.blaze_stage"]``
    or ``["launches.blaze_stage_nhwc"]``; the CPU kernel is the plain version.
    It has no autograd formula (JAX has no backward kernel either): a
    gradient asked through it raises."""
    B, C, H, W = x.shape
    nb = packed.shape[0]
    if C not in KERNEL_CHANNELS or not 0 < B <= 65535:
        raise ValueError(f"the kernel takes C in {KERNEL_CHANNELS} and 1..65535 images, "
                         f"got C={C}, B={B}")
    if x.is_contiguous():
        nhwc = False
    elif x.is_contiguous(memory_format=torch.channels_last):
        nhwc = True
    else:
        raise ValueError(f"x must be NCHW-contiguous or channels_last, got strides {x.stride()}")
    packed = packed.contiguous()
    tile_h, tile_w, smem = _tiling(C, H, W, nb)
    out = torch.empty_like(x)  # keeps x's memory format
    name = "blaze_stage_nhwc" if nhwc else "blaze_stage"
    fn = getattr(library(name), f"zaru_{name}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):  # the runtime's current device: cudaFuncSetAttribute and the launch
        rc = fn(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), B, C, H, W, nb, tile_h, tile_w, smem,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"blaze_stage kernel launch failed: CUDA error {rc}")
    profiling.counters[f"launches.{name}"] += 1
    return out


@blaze_stage_op.register_kernel("cpu")
def _(x, packed):
    return blaze_blocks_reference(x, unpack_blocks(packed, x.shape[1]))


@blaze_stage_op.register_fake
def _(x, packed):
    return torch.empty_like(x)


@register_flop_formula(torch.ops.zaru_tpu_torch.blaze_stage)
def stage_flops(x_shape, packed_shape, *args, out_shape=None, **kwargs) -> int:
    """``B·H·W·C·(2·(9 + C) + 4)`` a block: the depthwise 3×3 and the 1×1's
    multiply-adds at two operations each, and the two biases, the residual
    Add and PReLU at one each."""
    B, C, H, W = x_shape
    return packed_shape[0] * B * H * W * C * (2 * (9 + C) + 4)


def fused_blocks(x, packed, H: int, W: int, C: int):
    """Runs the packed stage over ``x [B,C,H,W] f32`` → the last block's
    output, same shape and layout, through :func:`blaze_stage_op`. A CUDA
    tensor launches the kernel (or raises): an NCHW-contiguous one the NCHW
    variant, a channels_last one the NHWC variant; any other strides raise,
    as do more blocks than :func:`max_blocks`. A CPU tensor runs the plain
    version."""
    _check(x, packed, H, W, C)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return blaze_stage_op(x, packed)
