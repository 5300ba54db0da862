"""The fused BlazeBlock whose residual is not its plain input: hand-written
CUDA kernel and its plain version.

A block, on ``x [B,C_in,H,W] f32``, with stride ``s`` 1 or 2::

    y = act(pw1x1_{C_in→C_out}(dw3x3_s(x) + b_dw) + b_pw + pad_C(pool_s(x)))

``pool_2`` is the 2×2 stride-2 max pool, ``pool_1`` the identity;
``pad_C`` zero-pads the channels from ``C_in`` to ``C_out`` (``C_out >=
C_in``; ``C_out == C_in`` only at stride 2: the stride-1 blocks of one
width are the stage kernel's, ``ops/cnn_stage.py``); the depthwise pads
are the node's ``(top, left, bottom, right)``, ``(1, 1, 1, 1)`` at stride
1 and one pixel in all on each axis at stride 2 (``(0, 0, 1, 1)`` in the
face models); ``act`` is ReLU or PReLU with ``C_out`` slopes. BlazeFace
short range has 11 such blocks (8 stride-1 blocks that widen the channels,
3 stride-2), Face Mesh V1 6 (all stride 2); BlazeFace full range has none
(its blocks are double: a 1×1 down, ReLU, a second depthwise and a 1×1 up
before the Add).

The ONNX executor finds them (``onnx/fusion.py``
:func:`~zaru_tpu_torch.onnx.fusion.find_blaze_blocks`) and runs each
through :func:`fused_blaze_block`: on a CUDA tensor it launches
``csrc/blaze_block.cu`` once, which reads the block's input once and
writes its output once (op by op the block is 5-8 passes over device
memory); on a CPU tensor it runs :func:`blaze_block_reference`, the
executor's own nodes (the same ``F.pad``, ``F.conv2d``, ``F.max_pool2d``
calls, the Add and the activation, in the same order), so on the CPU the
executor's numbers do not move. The kernel replaces no TPU kernel: the JAX
package leaves these blocks to XLA.

A block is the registered op ``zaru_tpu_torch::blaze_block``
(:func:`blaze_block_op`): its CUDA kernel the launch, its CPU kernel the
plain version, its fake kernel the output's shape, so ``torch.export``
captures it and ``FakeTensorMode`` runs it; a FLOP formula
(:func:`blaze_block_flops`) counts it as ``onnx/analysis.analyze`` counts
the nodes it replaces. Each call is the span ``zaru.net.blaze_block`` and
adds one to ``profiling.counters["blaze_blocks"]``; each launch is counted
in ``profiling.counters["launches.blaze_block"]``.

A block is a dict of ``dw_w [C_in,1,3,3]``, ``dw_b [C_in]``, ``pw_w
[C_out,C_in,1,1]``, ``pw_b [C_out]`` and ``alpha`` (``C_out`` slopes, any
shape, or None for a ReLU). :func:`pack_blaze_block` lays it out for the
kernel as one row of :func:`row_floats` floats (:func:`layout`): the 1×1
weights input-major with the outputs padded to ``Cp``, a multiple of 8,
by zeros, its bias and the slopes (each ``Cp``), the taps ``[C_in, 9]``,
the depthwise bias, zeros to a multiple of 4.
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
    "blaze_block_flops", "blaze_block_op", "blaze_block_reference", "fused_blaze_block", "layout",
    "out_size", "pack_blaze_block", "row_floats", "tiling", "unpack_blaze_block",
]

SMEM_LIMIT = 232448  # dynamic shared memory one thread block may use (H100)
SMS = 132  # streaming multiprocessors of an H100 SXM
# Shared memory that leaves room for three or two thread blocks an SM (228 KB
# an SM, 1 KB of it reserved for each thread block; csrc/blaze_block.cu
# asks for registers for three).
SMEM_PER_SM = {3: 75 * 1024, 2: 113 * 1024}
PIXELS = 256  # output pixels a thread block takes at most, by choice (csrc/blaze_block.cu kThreads)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def layout(c_in: int, c_out: int) -> dict:
    """Offsets (in floats) of the packed row's parts, and its length
    ``floats`` (csrc/blaze_block.cu ``Layout``)."""
    cp = -(-c_out // 8) * 8
    bpw = c_in * cp  # the 1x1 weights come first
    alpha = bpw + cp
    taps = alpha + cp
    bdw = taps + 9 * c_in
    return {"cp": cp, "bpw": bpw, "alpha": alpha, "taps": taps, "bdw": bdw, "floats": -(-(bdw + c_in) // 4) * 4}


def row_floats(c_in: int, c_out: int) -> int:
    """Floats of one packed block."""
    return layout(c_in, c_out)["floats"]


def pack_blaze_block(block: dict, c_in: int, c_out: int) -> torch.Tensor:
    """``block`` → the kernel's ``[row_floats(c_in, c_out)] f32`` row, on the
    device of the block's tensors (the CPU for numpy arrays). Raises where
    the depthwise is not 3×3 or the widths are not the block's."""
    dev = block["dw_w"].device if isinstance(block["dw_w"], torch.Tensor) else None
    dw_w = _f32(block["dw_w"], dev)
    if tuple(dw_w.shape) != (c_in, 1, 3, 3):
        raise ValueError(f"dw_w must be [{c_in},1,3,3] (a 3x3 depthwise), got {tuple(dw_w.shape)}")
    pw_w = _f32(block["pw_w"], dev)
    if tuple(pw_w.shape) != (c_out, c_in, 1, 1):
        raise ValueError(f"pw_w must be [{c_out},{c_in},1,1], got {tuple(pw_w.shape)}")
    lay = layout(c_in, c_out)
    cp = lay["cp"]
    row = torch.zeros(lay["floats"], dtype=torch.float32, device=dw_w.device)
    row[:c_in * cp].view(c_in, cp)[:, :c_out] = pw_w.reshape(c_out, c_in).t()
    row[lay["bpw"]:lay["bpw"] + c_out] = _f32(block["pw_b"], dev).reshape(c_out)
    if block.get("alpha") is not None:
        row[lay["alpha"]:lay["alpha"] + c_out] = _f32(block["alpha"], dev).reshape(c_out)
    row[lay["taps"]:lay["bdw"]] = dw_w.reshape(-1)
    row[lay["bdw"]:lay["bdw"] + c_in] = _f32(block["dw_b"], dev).reshape(c_in)
    return row


def unpack_blaze_block(packed, c_in: int, c_out: int, relu: bool) -> dict:
    """The block of :func:`pack_blaze_block`'s row, each weight a contiguous
    tensor of the ONNX shape, the slopes ``[1, C_out, 1, 1]`` (None for a
    ReLU)."""
    lay = layout(c_in, c_out)
    cp = lay["cp"]
    return {
        "dw_w": packed[lay["taps"]:lay["bdw"]].reshape(c_in, 1, 3, 3).contiguous(),
        "dw_b": packed[lay["bdw"]:lay["bdw"] + c_in].contiguous(),
        "pw_w": packed[:c_in * cp].view(c_in, cp)[:, :c_out].t().reshape(c_out, c_in, 1, 1).contiguous(),
        "pw_b": packed[lay["bpw"]:lay["bpw"] + c_out].contiguous(),
        "alpha": None if relu else packed[lay["alpha"]:lay["alpha"] + c_out].reshape(1, c_out, 1, 1).contiguous(),
    }


def out_size(size: int, stride: int, begin: int, end: int) -> int:
    """The depthwise's output size along one axis."""
    return (size + begin + end - 3) // stride + 1


def blaze_block_reference(x, block, stride: int, pads, relu: bool):
    """Plain PyTorch version of a block on any device: the executor's nodes,
    in its order: the depthwise ``F.conv2d`` with its bias (symmetric pads
    as its padding, others as an ``F.pad`` first), the 1×1 ``F.conv2d`` with
    its bias, the max pool (stride 2), the channels' ``F.pad``, the Add, then
    ``torch.relu`` or PReLU (``torch.where(v < 0, a·v, v)``)."""
    c_in = x.shape[1]
    pt, pl, pb, pr = pads
    f = lambda k: _f32(block[k], x.device)  # noqa: E731
    pw_w = f("pw_w")
    c_out = pw_w.shape[0]
    s = [stride, stride]
    if pt == pb and pl == pr:
        t = F.conv2d(x, f("dw_w"), f("dw_b"), stride=s, padding=(pt, pl), dilation=[1, 1], groups=c_in)
    else:
        t = F.conv2d(F.pad(x, (pl, pr, pt, pb)), f("dw_w"), f("dw_b"), stride=s, padding=0, dilation=[1, 1],
                     groups=c_in)
    u = F.conv2d(t, pw_w, f("pw_b"), stride=[1, 1], padding=(0, 0), dilation=[1, 1], groups=1)
    r = x if stride == 1 else F.max_pool2d(x, [2, 2], [2, 2], 0, [1, 1])
    if c_out > c_in:
        r = F.pad(r, [0, 0, 0, 0, 0, c_out - c_in, 0, 0])
    v = torch.add(r, u)
    if relu:
        return torch.relu(v)
    a = f("alpha").reshape(1, c_out, 1, 1)
    return torch.where(v < 0, a * v, v)


def _smem_bytes(c_in: int, c_out: int, H: int, W: int, stride: int, tile_h: int, images: int) -> int:
    """The kernel's shared memory for a thread block of ``images`` images'
    bands of ``tile_h`` output rows: the packed row, the input rows the band
    reads (all of each image's rows where the band is the image) of every
    input channel, and the depthwise's outputs."""
    ho, wo = out_size(H, stride, 1 if stride == 1 else 0, 1), out_size(W, stride, 1 if stride == 1 else 0, 1)
    rows = H if tile_h >= ho else (tile_h - 1) * stride + 3
    return 4 * (row_floats(c_in, c_out) + images * c_in * (rows * W + tile_h * wo))


@functools.lru_cache(maxsize=None)
def tiling(c_in: int, c_out: int, H: int, W: int, stride: int, B: int) -> tuple:
    """``(tile_h, images)`` of a launch on ``[B,c_in,H,W]``: a thread block
    takes bands of ``tile_h`` output rows of one image, or ``images`` whole
    images where the band is the image. Chosen, in this order (rules read
    off the kernel's times at the face models' 17 blocks on an H100, PERF.md
    section 6): thread blocks for at least half the SMs; at most
    :data:`PIXELS` output pixels; at least 32 (a warp's worth) where that
    fits; three thread blocks an SM, else two; then the most pixels where
    two fit, else the fewest; the least shared memory."""
    ho, wo = out_size(H, stride, 1 if stride == 1 else 0, 1), out_size(W, stride, 1 if stride == 1 else 0, 1)
    cands = [(th, 1) for th in range(1, ho + 1)]
    n = 2
    while n <= B and n * ho * wo <= PIXELS:
        cands.append((ho, n))
        n += 1
    best = None
    for th, n in cands:
        smem = _smem_bytes(c_in, c_out, H, W, stride, th, n)
        if smem > SMEM_LIMIT:
            continue
        px = n * th * wo
        tiles = -(-ho // th) * -(-B // n)
        two = smem <= SMEM_PER_SM[2]
        key = (tiles >= SMS // 2, px <= PIXELS, min(px, 32), smem <= SMEM_PER_SM[3], two, px if two else -px, -smem)
        if best is None or key > best[0]:
            best = (key, (th, n))
    if best is None:
        raise ValueError(f"no tiling of a {c_in}->{c_out} {H}x{W} block fits the shared memory")
    return best[1]


def _check(x, packed, c_out: int, stride: int, pads, relu: bool):
    """Raises on what the kernel does not take."""
    if x.dtype != torch.float32 or x.ndim != 4:
        raise ValueError(f"x must be [B,C,H,W] float32, got {tuple(x.shape)} {x.dtype}")
    c_in = x.shape[1]
    if stride not in (1, 2) or c_out < c_in or (c_out == c_in and stride == 1):
        raise ValueError(f"the kernel takes C_out > C_in at stride 1 and C_out >= C_in at stride 2, "
                         f"got {c_in}->{c_out} at stride {stride}")
    pt, pl, pb, pr = pads
    ok = (pt, pl, pb, pr) == (1, 1, 1, 1) if stride == 1 else (
        pt + pb == 1 and pl + pr == 1 and min(pads) >= 0 and x.shape[2] >= 2 and x.shape[3] >= 2)
    if not ok:
        raise ValueError(f"pads {tuple(pads)} at stride {stride} on {tuple(x.shape[2:])}: the kernel takes "
                         "(1, 1, 1, 1) at stride 1 and one pixel an axis at stride 2")
    n = row_floats(c_in, c_out)
    if packed.dtype != torch.float32 or packed.ndim != 1 or packed.shape[0] != n or packed.device != x.device:
        raise ValueError(f"packed must be [{n}] float32 on {x.device} (a 3x3 {c_in}->{c_out} block), got "
                         f"{tuple(packed.shape)} {packed.dtype} on {packed.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, its argument types set once."""
    fn = library("blaze_block").zaru_blaze_block
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _geometry(c_in: int, c_out: int, H: int, W: int, stride: int, pads: tuple, B: int) -> tuple:
    """``(Ho, Wo, tile_h, images, shared memory bytes)`` of a launch."""
    pt, pl, pb, pr = pads
    tile_h, images = tiling(c_in, c_out, H, W, stride, B)
    return (out_size(H, stride, pt, pb), out_size(W, stride, pl, pr), tile_h, images,
            _smem_bytes(c_in, c_out, H, W, stride, tile_h, images))


def _launch(x, packed, c_out: int, stride: int, pads, relu: bool):
    """The block on a CUDA tensor: one launch into a fresh output, counted in
    ``launches.blaze_block``. Raises on what the kernel does not take
    (:func:`_check`), a non-contiguous input or a failed launch; nothing
    falls back."""
    _check(x, packed, c_out, stride, pads, relu)
    if not x.is_contiguous():
        raise ValueError(f"x must be NCHW-contiguous, got strides {x.stride()}")
    B, c_in, H, W = x.shape
    ho, wo, tile_h, images, smem = _geometry(c_in, c_out, H, W, stride, tuple(pads), B)
    fn = _kernel()
    out = torch.empty((B, c_out, ho, wo), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the runtime's current device: cudaFuncSetAttribute and the launch
        rc = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(), B, c_in, c_out, H, W, ho, wo, stride, pads[0],
                pads[1], int(relu), tile_h, images, smem, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blaze_block kernel launch failed: CUDA error {rc}")
    profiling.counters["launches.blaze_block"] += 1
    return out


@torch.library.custom_op("zaru_tpu_torch::blaze_block", mutates_args=(), device_types="cuda")
def blaze_block_op(x: torch.Tensor, packed: torch.Tensor, c_out: int, stride: int, pads: list[int],
                   relu: bool) -> torch.Tensor:
    """A block as a registered op on ``x [B,C_in,H,W] f32`` and its packed
    row: on CUDA one launch of ``csrc/blaze_block.cu`` (:func:`_launch`), on
    the CPU the plain version. It has no autograd formula: a gradient asked
    through it raises (the trainer runs the graph node by node)."""
    return _launch(x, packed, c_out, stride, pads, relu)


@blaze_block_op.register_kernel("cpu")
def _(x, packed, c_out, stride, pads, relu):
    _check(x, packed, c_out, stride, pads, relu)  # the kernel's refusals, on the CPU too
    return blaze_block_reference(x, unpack_blaze_block(packed, x.shape[1], c_out, relu), stride, pads, relu)


@blaze_block_op.register_fake
def _(x, packed, c_out, stride, pads, relu):
    B, _, H, W = x.shape
    pt, pl, pb, pr = pads
    return x.new_empty((B, c_out, out_size(H, stride, pt, pb), out_size(W, stride, pl, pr)))


@register_flop_formula(torch.ops.zaru_tpu_torch.blaze_block)
def blaze_block_flops(x_shape, packed_shape, c_out, stride, pads, relu, *args, out_shape=None, **kwargs) -> int:
    """``B·Ho·Wo·(19·C_in + 2·C_in·C_out + 3·C_out)``, as
    ``onnx/analysis.analyze`` counts the nodes: the depthwise's nine
    multiply-adds and its bias on ``C_in`` channels, the 1×1's multiply-adds
    and its bias, the Add, and ReLU or PReLU's multiply on ``C_out``; the
    pads and the pool count nothing."""
    B, c_in, H, W = x_shape
    pt, pl, pb, pr = pads
    pixels = B * out_size(H, stride, pt, pb) * out_size(W, stride, pl, pr)
    return pixels * (19 * c_in + 2 * c_in * c_out + 3 * c_out)


def fused_blaze_block(x, packed, c_out: int, stride: int, pads, relu: bool):
    """Runs the packed block on ``x [B,C_in,H,W] f32`` → ``[B,C_out,Ho,Wo]``,
    through :func:`blaze_block_op`: a CUDA tensor launches the kernel (or
    raises), a CPU tensor runs the plain version; on both, what the kernel
    does not take raises (:func:`_check`, once, in the op). The call is the
    span ``zaru.net.blaze_block`` and adds one to
    ``profiling.counters["blaze_blocks"]``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    profiling.counters["blaze_blocks"] += 1
    with profiling.span("zaru.net.blaze_block"):
        return blaze_block_op(x, packed, c_out, stride, list(pads), relu)
