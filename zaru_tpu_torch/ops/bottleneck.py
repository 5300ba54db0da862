"""The fused residual bottleneck block: hand-written CUDA kernel and its plain version.

A block, on ``[B,C,H,W] f32`` with ``M = C/2``::

    t = PReLU_1(conv1x1_{C→M}(x) + b1)
    u = dw3x3_M(t) + b_dw                (zero padding 1)
    x <- PReLU_2(x + conv1x1_{M→C}(u) + b2)

Face Mesh V2 (``face_landmarks_detector.onnx``) has 28 of them in seven
chains of four, the iris model 20. The ONNX executor finds the chains
(``onnx/fusion.py`` :func:`~zaru_tpu_torch.onnx.fusion.find_bottlenecks`)
and runs each through :func:`fused_bottlenecks`: on a CUDA tensor it
launches ``csrc/bottleneck_stage.cu``, a launch for a piece of the
chain (:func:`plan`: one block, or several where that is estimated to be
faster), which keeps ``t``, ``u`` and the activation between the piece's
blocks in shared memory, so device memory sees one read of the piece's
input and one write of its output; on a CPU tensor it runs
:func:`bottleneck_blocks_reference`, the executor's own per-op chain (the
same ``F.conv2d`` calls, PReLU as ``torch.where`` and the Add, in the same
order), so on the CPU the executor's numbers do not move. The kernel
replaces no TPU kernel: the JAX package leaves these blocks to XLA.

A chain is the registered op ``zaru_tpu_torch::bottleneck_stage``
(:func:`bottleneck_stage_op`): its CUDA kernel the launches, its CPU kernel
the plain version, its fake kernel the output's shape, so ``torch.export``
captures it and ``FakeTensorMode`` runs it; a FLOP formula
(:func:`bottleneck_flops`) counts it as ``onnx/analysis.analyze`` counts
the nodes it replaces. Each call is the span ``zaru.net.bottleneck`` and
adds its blocks to ``profiling.counters["bottleneck_blocks"]``; each launch
is counted in ``profiling.counters["launches.bottleneck_stage"]``.

Blocks are dicts of ``w1 [M,C,1,1]``, ``b1 [M]``, ``a1`` (M slopes, any
shape), ``dw_w [M,1,3,3]``, ``dw_b [M]``, ``w2 [C,M,1,1]``, ``b2 [C]`` and
``a2`` (C slopes). :func:`pack_bottlenecks` lays them out for the kernel:
one row of ``C*C + 8*C`` floats a block (``csrc/bottleneck_stage.cu``
``Packed``): the 1×1 weights input-major, the taps ``[9, M]``, then the
biases and slopes.
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
    "KERNEL_CHANNELS", "bottleneck_blocks_reference", "bottleneck_flops", "bottleneck_stage_op",
    "fused_bottlenecks", "pack_bottlenecks", "plan", "row_floats", "unpack_bottlenecks",
]

SMEM_LIMIT = 232448  # dynamic shared memory one thread block may use (H100)
SMS = 132  # streaming multiprocessors of an H100 SXM
# The block widths csrc/bottleneck_stage.cu is instantiated for: those of
# Face Mesh V2's and the iris model's blocks.
KERNEL_CHANNELS = (16, 32, 64, 128)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def row_floats(C: int) -> int:
    """Floats of one packed block."""
    return C * C + 8 * C


def pack_bottlenecks(blocks, C: int) -> torch.Tensor:
    """``blocks`` → the kernel's ``[nb, C*C + 8*C] f32`` layout, on the
    device of the blocks' tensors (the CPU for numpy arrays)."""
    M = C // 2
    rows = []
    for b in blocks:
        dev = b["w1"].device if isinstance(b["w1"], torch.Tensor) else None
        f = lambda k, *shape: _f32(b[k], dev).reshape(*shape)  # noqa: E731
        rows.append(torch.cat([
            f("w1", M, C).t().reshape(-1), f("b1", M), f("a1", M), f("dw_w", M, 9).t().reshape(-1),
            f("dw_b", M), f("w2", C, M).t().reshape(-1), f("b2", C), f("a2", C),
        ]))
    return torch.stack(rows).contiguous()


def unpack_bottlenecks(packed, C: int) -> list[dict]:
    """The blocks of :func:`pack_bottlenecks`'s layout, each weight a
    contiguous tensor of the ONNX shape, slopes ``[1, n, 1, 1]``."""
    M = C // 2
    sizes = [C * M, M, M, 9 * M, M, M * C, C, C]
    blocks = []
    for row in packed:
        w1, b1, a1, taps, dw_b, w2, b2, a2 = torch.split(row, sizes)
        blocks.append({
            "w1": w1.reshape(C, M).t().reshape(M, C, 1, 1).contiguous(), "b1": b1.contiguous(),
            "a1": a1.reshape(1, M, 1, 1).contiguous(),
            "dw_w": taps.reshape(9, M).t().reshape(M, 1, 3, 3).contiguous(), "dw_b": dw_b.contiguous(),
            "w2": w2.reshape(M, C).t().reshape(C, M, 1, 1).contiguous(), "b2": b2.contiguous(),
            "a2": a2.reshape(1, C, 1, 1).contiguous(),
        })
    return blocks


def bottleneck_blocks_reference(x, blocks):
    """Plain PyTorch version of a chain on any device: per block the
    executor's nodes, in its order: the 1×1 ``F.conv2d`` with its bias,
    PReLU (``torch.where(v < 0, a·v, v)``), the depthwise ``F.conv2d``
    with padding 1, the 1×1 back, the Add of the block's input, PReLU."""
    C = x.shape[1]
    M = C // 2
    for b in blocks:
        f = lambda k, *shape: _f32(b[k], x.device).reshape(*shape)  # noqa: E731
        t = F.conv2d(x, f("w1", M, C, 1, 1), f("b1", M))
        a1 = f("a1", 1, M, 1, 1)
        t = torch.where(t < 0, a1 * t, t)
        u = F.conv2d(t, f("dw_w", M, 1, 3, 3), f("dw_b", M), padding=(1, 1), groups=M)
        y = torch.add(x, F.conv2d(u, f("w2", C, M, 1, 1), f("b2", C)))
        a2 = f("a2", 1, C, 1, 1)
        x = torch.where(y < 0, a2 * y, y)
    return x


def _axis(size: int, tile: int, nb: int) -> tuple[int, int]:
    """Along one axis of an image cut into tiles of ``tile`` pixels: the
    largest region (a tile and ``nb`` pixels of halo, clipped to the image)
    and the largest window a launch's first block writes (the region less
    one pixel on each side inside the image)."""
    region = window = 0
    for a0 in range(0, size, tile):
        r0, r1 = max(0, a0 - nb), min(size, a0 + tile + nb)
        region = max(region, r1 - r0)
        window = max(window, r1 - r0 - (r0 > 0) - (r1 < size))
    return region, window


def _smem_bytes(C: int, H: int, W: int, th: int, tw: int, images: int, nb: int) -> int:
    """The kernel's shared memory for a launch of ``nb`` blocks on tiles of
    ``th × tw`` (``images`` whole images a tile where the tile is the
    image), at its largest tile: the blocks' packed parameters, x on the
    regions, the padded intermediate (each region in a ring of zeros) and
    the depthwise result on the first block's output window, the largest."""
    M = C // 2
    (rh, wh), (rw, ww) = _axis(H, th, nb), _axis(W, tw, nb)
    return 4 * (nb * row_floats(C) + images * (C * rh * rw + M * (rh + 2) * (rw + 2) + M * wh * ww))


def _candidates(H: int, W: int, B: int):
    """``(tile_h, tile_w, images)``: even splits of the image, one image a
    tile, and whole small images several a tile."""
    hs = sorted({-(-H // n) for n in range(1, H + 1)})
    ws = sorted({-(-W // n) for n in range(1, W + 1)})
    for th in hs:
        for tw in ws:
            yield th, tw, 1
    n = 2
    while n <= B and n * H * W <= 1024:
        yield H, W, n
        n *= 2


# The cost model, fitted to the kernel's times on an H100 (95 launches at
# Face Mesh V2's shapes, PERF.md section 6; within 14% rms). A thread block
# of 16 warps, one an SM (csrc/bottleneck_stage.cu kThreads), spends these
# seconds per multiply-add lane of its matrix products (pixels rounded up
# to warps of 32), per multiply-add of its depthwise, per row of x it loads
# (a channel's row of a region) and per block it runs (the barriers
# between phases, the fill and drain of each); the launch's device memory
# moves at BYTES_PER_S, and the launch takes the larger of the two times
# and MIX of the smaller.
COST = {"product": 5.67e-12, "depthwise": 2.58e-11, "row": 8.39e-9, "block": 3.93e-6}
BYTES_PER_S = 3.42e12
MIX = 0.455


def _tile_seconds(C: int, H: int, W: int, th: int, tw: int, images: int, nb: int) -> float:
    """A thread block's time on an interior tile by :data:`COST`: per block
    the two matrix products and the depthwise, on windows that shrink a
    pixel a block; the rows of x it loads."""
    M = C // 2
    up = lambda n: 32 * -(-n // 32)  # noqa: E731
    side = lambda k: images * min(H, th + 2 * k) * min(W, tw + 2 * k)  # noqa: E731
    products = sum(C * M * (up(side(nb - k)) + up(side(nb - k - 1))) for k in range(nb))
    depthwise = sum(9 * M * side(nb - k - 1) for k in range(nb))
    rows = C * images * min(H, th + 2 * nb)
    return COST["product"] * products + COST["depthwise"] * depthwise + COST["row"] * rows + COST["block"] * nb


def _costed(C: int, H: int, W: int, B: int, nb: int):
    """``(estimated seconds, tile_h, tile_w, images)`` of each candidate
    launch of ``nb`` blocks that fits the shared memory (see :data:`COST`):
    the waves of tiles the SMs run, and the device memory's time."""
    for th, tw, images in _candidates(H, W, B):
        if _smem_bytes(C, H, W, th, tw, images, nb) > SMEM_LIMIT:
            continue
        tiles = -(-H // th) * -(-W // tw) * -(-B // images)
        t_work = -(-tiles // SMS) * _tile_seconds(C, H, W, th, tw, images, nb)
        t_bytes = 8 * B * C * H * W / BYTES_PER_S
        yield max(t_work, t_bytes) + MIX * min(t_work, t_bytes), th, tw, images


@functools.lru_cache(maxsize=None)
def _tiling(C: int, H: int, W: int, B: int, nb: int) -> tuple:
    """The candidate of :func:`_costed` with the least estimated time."""
    best = min(_costed(C, H, W, B, nb), default=None)
    if best is None:
        raise ValueError(f"no tiling of {nb} {C}-channel {H}x{W} blocks fits the shared memory")
    return best


@functools.lru_cache(maxsize=None)
def plan(C: int, H: int, W: int, B: int, nb: int) -> tuple:
    """How a chain of ``nb`` blocks on ``[B,C,H,W]`` runs: a tuple of
    launches ``(blocks, tile_h, tile_w, images)``,
    pieces of one length (the last shorter), the length with the least
    estimated time. One block a launch moves the activation through device
    memory at every block; more recompute a halo that grows a pixel a
    block and hold more in shared memory."""
    best = None
    for size in range(1, nb + 1):
        pieces = [min(size, nb - s) for s in range(0, nb, size)]
        try:
            tilings = [_tiling(C, H, W, B, n) for n in pieces]
        except ValueError:
            continue
        cost = sum(t[0] for t in tilings)
        if best is None or cost < best[0]:
            best = (cost, tuple((n, *t[1:]) for n, t in zip(pieces, tilings)))
    if best is None:
        raise ValueError(f"no tiling of a {C}-channel {H}x{W} block fits the shared memory")
    return best[1]


def _check(x, packed, H, W, C):
    if x.dtype != torch.float32 or x.ndim != 4 or tuple(x.shape[1:]) != (C, H, W) or C % 2:
        raise ValueError(f"x must be [B,{C},{H},{W}] float32 with C even, got {tuple(x.shape)} {x.dtype}")
    if (packed.dtype != torch.float32 or packed.ndim != 2 or packed.shape[1] != row_floats(C)
            or packed.shape[0] < 1 or packed.device != x.device):
        raise ValueError(f"packed must be [nb,{row_floats(C)}] float32 on {x.device}, "
                         f"got {tuple(packed.shape)} {packed.dtype} on {packed.device}")


def _launch(x, packed):
    """The chain on a CUDA tensor: the launches of :func:`plan`, each into a
    fresh output, counted in ``launches.bottleneck_stage``. Raises on a
    width the kernel is not built for, more images than a launch takes, a
    non-contiguous input or a failed launch; nothing falls back."""
    B, C, H, W = x.shape
    if C not in KERNEL_CHANNELS or not 0 < B <= 65535:
        raise ValueError(f"the bottleneck kernel takes C in {KERNEL_CHANNELS} and 1..65535 images, "
                         f"got C={C}, B={B}")
    if not x.is_contiguous():
        raise ValueError(f"x must be NCHW-contiguous, got strides {x.stride()}")
    packed = packed.contiguous()
    fn = library("bottleneck_stage").zaru_bottleneck_stage
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    row = row_floats(C) * 4
    first = 0
    with torch.cuda.device(x.device):  # the runtime's current device: cudaFuncSetAttribute and the launch
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for nb, tile_h, tile_w, images in plan(C, H, W, B, packed.shape[0]):
            out = torch.empty_like(x)
            rc = fn(x.data_ptr(), packed.data_ptr() + first * row, out.data_ptr(), B, C, H, W, nb, tile_h, tile_w,
                    images, _smem_bytes(C, H, W, tile_h, tile_w, images, nb), stream)
            if rc != 0:
                raise RuntimeError(f"bottleneck_stage kernel launch failed: CUDA error {rc}")
            profiling.counters["launches.bottleneck_stage"] += 1
            first += nb
            x = out
    return x


@torch.library.custom_op("zaru_tpu_torch::bottleneck_stage", mutates_args=(), device_types="cuda")
def bottleneck_stage_op(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """A chain as a registered op on ``x [B,C,H,W] f32`` and its packed
    blocks: on CUDA the launches of ``csrc/bottleneck_stage.cu`` that
    :func:`plan` gives (:func:`_launch`), on the CPU the plain version. It has no autograd
    formula: a gradient asked through it raises (the trainer runs the
    graph node by node)."""
    return _launch(x, packed)


@bottleneck_stage_op.register_kernel("cpu")
def _(x, packed):
    return bottleneck_blocks_reference(x, unpack_bottlenecks(packed, x.shape[1]))


@bottleneck_stage_op.register_fake
def _(x, packed):
    return torch.empty_like(x)


@register_flop_formula(torch.ops.zaru_tpu_torch.bottleneck_stage)
def bottleneck_flops(x_shape, packed_shape, *args, out_shape=None, **kwargs) -> int:
    """``B·H·W·C·(2·C + 13.5)`` a block, as ``onnx/analysis.analyze``
    counts its nodes: each 1×1's multiply-adds (``C·C/2`` a pixel) at two
    operations and its bias at one an output, the depthwise's nine
    multiply-adds and its bias on ``C/2`` channels, PReLU's multiply on
    ``C/2`` and on ``C`` channels, the residual Add."""
    B, C, H, W = x_shape
    return packed_shape[0] * B * H * W * C * (4 * C + 27) // 2


def fused_bottlenecks(x, packed, H: int, W: int, C: int):
    """Runs the packed chain over ``x [B,C,H,W] f32`` → the last block's
    output, through :func:`bottleneck_stage_op`: a CUDA tensor launches the
    kernel (or raises), a CPU tensor runs the plain version.
    The call is the span ``zaru.net.bottleneck`` and counts its blocks in
    ``profiling.counters["bottleneck_blocks"]``."""
    _check(x, packed, H, W, C)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    profiling.counters["bottleneck_blocks"] += packed.shape[0]
    with profiling.span("zaru.net.bottleneck"):
        return bottleneck_stage_op(x, packed)
