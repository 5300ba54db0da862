"""The stride-2 residual bottleneck ("entry") block: hand-written CUDA kernel
and its plain version.

A block, on ``x [B,C_in,H,W] f32`` (H and W even), with ``Ho = H/2``,
``Wo = W/2`` and ``C_out = 2·M``::

    t = PReLU_1(conv2x2,s2_{C_in→M}(x) + b1)            [B, M, Ho, Wo]
    u = dw3x3(t) + b_dw                                  zero padding 1
    y = PReLU_2(conv1x1_{M→C_out}(u) + b2 + pad_C(MaxPool2x2,s2(x)))

``pad_C`` appends zero channels from ``C_in`` up to ``C_out``. Face Mesh
V2 (``face_landmarks_detector.onnx``) and the iris model
(``iris_landmark.onnx``) have six such blocks each, and no other bundled
network has any: ``(C_in, M)`` is ``(16, 16)``, ``(32, 32)``, ``(64, 64)``
or ``(128, 64)`` (:data:`KERNEL_WIDTHS`, the widths the kernel is built
for).

The ONNX executor finds them (``onnx/fusion.py``
:func:`~zaru_tpu_torch.onnx.fusion.find_entry_blocks`) and runs each through
:func:`fused_entry_block`: on a CUDA tensor it launches
``csrc/entry_block.cu`` once, which reads ``x`` once for both the
convolution and the pool, keeps ``t`` and ``u`` in shared memory and
writes ``y`` once (op by op the block is some ten passes over device
memory); on a CPU tensor it runs :func:`entry_block_reference`, the
executor's own nodes (the same ``F.max_pool2d``, ``F.pad`` and
``F.conv2d`` calls, PReLU as ``torch.where``, the Add, in the same order),
so on the CPU the executor's numbers do not move. The kernel replaces no
TPU kernel: the JAX package leaves these blocks to XLA.

A block is the registered op ``zaru_tpu_torch::entry_block``
(:func:`entry_block_op`): its CUDA kernel the launch, its CPU kernel the
plain version, its fake kernel the output's shape, so ``torch.export``
captures it and ``FakeTensorMode`` runs it; a FLOP formula
(:func:`entry_block_flops`) counts it as ``onnx/analysis.analyze`` counts
the nodes it replaces. Each call is the span ``zaru.net.entry_block`` and
adds one to ``profiling.counters["entry_blocks"]``; each launch is counted
in ``profiling.counters["launches.entry_block"]``.

A block is a dict of ``w1 [M,C_in,2,2]``, ``b1 [M]``, ``a1`` (M slopes,
any shape), ``dw_w [M,1,3,3]``, ``dw_b [M]``, ``w2 [C_out,M,1,1]``, ``b2
[C_out]`` and ``a2`` (C_out slopes). :func:`pack_entry_block` lays it out
for the kernel as one row of :func:`row_floats` floats (:func:`layout`):
the 2×2 weights ``[4·C_in, M]`` (``k = 4·ci + 2·ky + kx``), then b1, a1,
b_dw, the taps ``[M, 9]``, the 1×1 weights ``[M, C_out]``, b2 and a2.
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
    "KERNEL_WIDTHS", "entry_block_flops", "entry_block_op", "entry_block_reference", "fused_entry_block", "layout",
    "pack_entry_block", "row_floats", "tiling", "unpack_entry_block",
]

SMEM_LIMIT = 232448  # dynamic shared memory one thread block may use (H100)
SMEM_TWO = 113 * 1024  # a thread block's share where two fit an SM (228 KB, 1 KB of it reserved for each)
SMS = 132  # streaming multiprocessors of an H100 SXM
THREADS = 256  # csrc/entry_block.cu kThreads
DOWN_GROUPS = 8  # csrc/entry_block.cu kDownGroups: 32-pixel groups a warp's unit of the 2x2 convolution takes
# The (C_in, M) pairs csrc/entry_block.cu is instantiated for: those of Face
# Mesh V2 and the iris model.
KERNEL_WIDTHS = ((16, 16), (32, 32), (64, 64), (128, 64))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def layout(c_in: int, m: int) -> dict:
    """Offsets (in floats) of the packed row's parts and its length
    ``floats`` (csrc/entry_block.cu ``Packed``)."""
    c_out = 2 * m
    b1 = 4 * c_in * m  # the 2x2 weights come first
    a1 = b1 + m
    bdw = a1 + m
    taps = bdw + m
    w2 = taps + 9 * m
    b2 = w2 + m * c_out
    a2 = b2 + c_out
    return {"b1": b1, "a1": a1, "bdw": bdw, "taps": taps, "w2": w2, "b2": b2, "a2": a2, "floats": a2 + c_out}


def row_floats(c_in: int, m: int) -> int:
    """Floats of one packed block."""
    return layout(c_in, m)["floats"]


def pack_entry_block(block: dict, c_in: int, m: int) -> torch.Tensor:
    """``block`` → the kernel's ``[row_floats(c_in, m)] f32`` row, on the
    device of the block's tensors (the CPU for numpy arrays). Raises where a
    weight is not of the block's shape (``C_out = 2·M``)."""
    dev = block["w1"].device if isinstance(block["w1"], torch.Tensor) else None
    c_out = 2 * m
    shapes = {"w1": (m, c_in, 2, 2), "dw_w": (m, 1, 3, 3), "w2": (c_out, m, 1, 1)}
    w = {k: _f32(block[k], dev) for k in shapes}
    for k, shape in shapes.items():
        if tuple(w[k].shape) != shape:
            raise ValueError(f"{k} must be {list(shape)}, got {tuple(w[k].shape)}")
    lay = layout(c_in, m)
    row = torch.empty(lay["floats"], dtype=torch.float32, device=w["w1"].device)
    row[:lay["b1"]] = w["w1"].permute(1, 2, 3, 0).reshape(-1)  # [c_in, ky, kx, m]
    for k, start, n in (("b1", "b1", m), ("a1", "a1", m), ("dw_b", "bdw", m), ("b2", "b2", c_out),
                        ("a2", "a2", c_out)):
        row[lay[start]:lay[start] + n] = _f32(block[k], dev).reshape(n)
    row[lay["taps"]:lay["w2"]] = w["dw_w"].reshape(-1)
    row[lay["w2"]:lay["b2"]] = w["w2"].reshape(c_out, m).t().reshape(-1)
    return row


def unpack_entry_block(packed, c_in: int, m: int) -> dict:
    """The block of :func:`pack_entry_block`'s row, each weight a contiguous
    tensor of the ONNX shape, the slopes ``[1, C, 1, 1]``."""
    lay = layout(c_in, m)
    c_out = 2 * m
    part = lambda k, n: packed[lay[k]:lay[k] + n]  # noqa: E731
    return {
        "w1": packed[:lay["b1"]].reshape(c_in, 2, 2, m).permute(3, 0, 1, 2).contiguous(),
        "b1": part("b1", m).contiguous(),
        "a1": part("a1", m).reshape(1, m, 1, 1).contiguous(),
        "dw_w": part("taps", 9 * m).reshape(m, 1, 3, 3).contiguous(),
        "dw_b": part("bdw", m).contiguous(),
        "w2": part("w2", m * c_out).reshape(m, c_out).t().reshape(c_out, m, 1, 1).contiguous(),
        "b2": part("b2", c_out).contiguous(),
        "a2": part("a2", c_out).reshape(1, c_out, 1, 1).contiguous(),
    }


def entry_block_reference(x, block):
    """Plain PyTorch version of a block on any device: the executor's nodes,
    in its order: the max pool, the channels' ``F.pad`` (where ``C_out >
    C_in``), the 2×2 stride-2 ``F.conv2d`` with its bias, PReLU
    (``torch.where(v < 0, a·v, v)``), the depthwise and the 1×1
    ``F.conv2d`` with their biases, the Add, PReLU."""
    c_in = x.shape[1]
    f = lambda k: _f32(block[k], x.device)  # noqa: E731
    w1, w2 = f("w1"), f("w2")
    m, c_out = w1.shape[0], w2.shape[0]
    r = F.max_pool2d(x, [2, 2], [2, 2], 0, [1, 1])
    if c_out > c_in:
        r = F.pad(r, [0, 0, 0, 0, 0, c_out - c_in, 0, 0])
    t = F.conv2d(x, w1, f("b1"), stride=[2, 2], padding=(0, 0), dilation=[1, 1], groups=1)
    a1 = f("a1").reshape(1, m, 1, 1)
    t = torch.where(t < 0, a1 * t, t)
    u = F.conv2d(t, f("dw_w"), f("dw_b"), stride=[1, 1], padding=(1, 1), dilation=[1, 1], groups=m)
    v = torch.add(r, F.conv2d(u, w2, f("b2"), stride=[1, 1], padding=(0, 0), dilation=[1, 1], groups=1))
    a2 = f("a2").reshape(1, c_out, 1, 1)
    return torch.where(v < 0, a2 * v, v)


def _geometry(H: int, W: int, tile_h: int, images: int) -> dict:
    """A launch's largest thread block as csrc/entry_block.cu ``Geometry``
    lays it out: region rows ``TR`` (the band and one row of halo each side,
    clipped; the image where the band is the image), band pixels ``NO``,
    region pixels ``NT``, and the floats of x an input channel ``XC``, of
    padded t an output channel ``TS``."""
    Ho, Wo = H // 2, W // 2
    whole = tile_h >= Ho
    TR = Ho if whole else min(Ho, tile_h + 2)
    th = Ho if whole else tile_h
    return {"TR": TR, "NO": images * th * Wo, "NT": images * TR * Wo, "XC": images * 2 * TR * W,
            "TS": images * (TR + 2) * (Wo + 2)}


def _smem_bytes(c_in: int, m: int, H: int, W: int, tile_h: int, images: int, cc: int) -> int:
    """The kernel's shared memory for a launch: the biases, slopes, taps and
    W2; the pooled residual ``[C_in, NO]``; and a region that holds the ring
    of chunk stages (x's rows of ``cc`` channels and their rows of W1; two
    stages where there is more than one chunk), later padded t and u."""
    g = _geometry(H, W, tile_h, images)
    stage = cc * g["XC"] + 4 * cc * m
    ring = (2 if c_in > cc else 1) * stage
    region = max(ring, m * g["TS"] + m * g["NO"])
    small = row_floats(c_in, m) - layout(c_in, m)["b1"]
    return 4 * (small + -(-c_in * g["NO"] // 4) * 4 + region)


def _fits(c_in: int, m: int, H: int, W: int, tile_h: int, images: int) -> bool:
    """Whether a warp's unit of the 2×2 convolution holds its share of the
    region's pixels (csrc/entry_block.cu: each warp one unit of 8 outputs,
    at most DOWN_GROUPS groups of 32 pixels)."""
    groups = -(-_geometry(H, W, tile_h, images)["NT"] // 32)
    return -(-groups // (THREADS // 32 // (m // 8))) <= DOWN_GROUPS


def _candidates(c_in: int, H: int, B: int):
    """``(tile_h, images, cc)``: bands of any height of one image, whole
    images several a thread block, and channel chunks that divide C_in."""
    Ho = H // 2
    chunks = [cc for cc in (2, 4, 8, 16, 32) if c_in % cc == 0]
    for cc in chunks:
        for th in range(1, Ho):
            yield th, 1, cc
        n = 1
        while n <= B:
            yield Ho, n, cc
            n *= 2


# The cost model, fitted to the kernel's times on an H100 (480 launches: every
# tiling that fits at Face Mesh V2's six block shapes at 512 and the iris
# model's four at 1,024, PERF.md section 6; 13% rms): a thread block spends
# COST["op"] seconds an operation of its two matrix products and depthwise
# (pixels rounded up to warps of 32), COST["chunk"] a chunk of input
# channels and COST["block"] once, and moves its bytes at COST["byte"]
# seconds each; one thread block an SM adds the two, two an SM overlap
# one's copies with the other's arithmetic.
COST = {"op": 3.47e-12, "chunk": 2.23e-7, "block": 5.11e-6, "byte": 4.84e-11}


def _seconds(c_in: int, m: int, H: int, W: int, B: int, tile_h: int, images: int, cc: int) -> float:
    """The estimated time of a launch (see :data:`COST`): the waves of
    thread blocks the SMs run, each wave the time of its thread blocks on
    an SM."""
    g = _geometry(H, W, tile_h, images)
    c_out = 2 * m
    up = lambda n: 32 * -(-n // 32)  # noqa: E731
    ops = up(g["NT"]) * m * (8 * c_in + 2) + g["NO"] * 19 * m + up(g["NO"]) * c_out * (2 * m + 3)
    compute = COST["op"] * ops + COST["chunk"] * (c_in // cc) + COST["block"]
    memory = COST["byte"] * 4 * (g["NT"] * 4 * c_in + g["NO"] * c_out)
    per_sm = 2 if _smem_bytes(c_in, m, H, W, tile_h, images, cc) <= SMEM_TWO else 1
    tiles = (1 if tile_h >= H // 2 else -(-(H // 2) // tile_h)) * -(-B // images)
    waves = -(-tiles // (SMS * per_sm))
    return waves * (compute + memory if per_sm == 1 else 2 * max(compute, memory))


@functools.lru_cache(maxsize=None)
def tiling(c_in: int, m: int, H: int, W: int, B: int) -> tuple:
    """``(tile_h, images, cc)`` of a launch on ``[B,c_in,H,W]``: a thread
    block takes bands of ``tile_h`` output rows of one image, or ``images``
    whole images (``tile_h = H/2``), and streams the input channels in
    chunks of ``cc``. The candidate that fits the shared memory and a
    warp's registers with the least estimated time (:func:`_seconds`);
    ties go to the least shared memory."""
    best = None
    for th, n, cc in _candidates(c_in, H, B):
        smem = _smem_bytes(c_in, m, H, W, th, n, cc)
        if smem > SMEM_LIMIT or not _fits(c_in, m, H, W, th, n):
            continue
        key = (_seconds(c_in, m, H, W, B, th, n, cc), smem)
        if best is None or key < best[0]:
            best = (key, (th, n, cc))
    if best is None:
        raise ValueError(f"no tiling of a {c_in}->{2 * m} {H}x{W} entry block fits the shared memory")
    return best[1]


def _check(x, packed, m: int):
    """Raises on what the kernel does not take."""
    if x.dtype != torch.float32 or x.ndim != 4:
        raise ValueError(f"x must be [B,C,H,W] float32, got {tuple(x.shape)} {x.dtype}")
    B, c_in, H, W = x.shape
    if (c_in, m) not in KERNEL_WIDTHS:
        raise ValueError(f"the entry block kernel takes (C_in, M) in {KERNEL_WIDTHS}, got ({c_in}, {m})")
    if H < 2 or W < 2 or H % 2 or W % 2 or not 0 < B <= 65535:
        raise ValueError(f"the entry block kernel takes even H and W and 1..65535 images, got {tuple(x.shape)}")
    n = row_floats(c_in, m)
    if packed.dtype != torch.float32 or packed.ndim != 1 or packed.shape[0] != n or packed.device != x.device:
        raise ValueError(f"packed must be [{n}] float32 on {x.device} (a {c_in}->{2 * m} block), got "
                         f"{tuple(packed.shape)} {packed.dtype} on {packed.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, its argument types set once."""
    fn = library("entry_block").zaru_entry_block
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, packed, m: int):
    """The block on a CUDA tensor: one launch into a fresh output, counted in
    ``launches.entry_block``. Raises on what the kernel does not take
    (:func:`_check`), a non-contiguous or misaligned input or a failed
    launch; nothing falls back."""
    _check(x, packed, m)
    if not x.is_contiguous() or x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError(f"x must be NCHW-contiguous and x and packed 16-byte aligned, got strides {x.stride()}")
    B, c_in, H, W = x.shape
    tile_h, images, cc = tiling(c_in, m, H, W, B)
    smem = _smem_bytes(c_in, m, H, W, tile_h, images, cc)
    fn = _kernel()
    out = torch.empty((B, 2 * m, H // 2, W // 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the runtime's current device: cudaFuncSetAttribute and the launch
        rc = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(), B, c_in, m, H, W, tile_h, images, cc, smem,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"entry_block kernel launch failed: CUDA error {rc}")
    profiling.counters["launches.entry_block"] += 1
    return out


@torch.library.custom_op("zaru_tpu_torch::entry_block", mutates_args=(), device_types="cuda")
def entry_block_op(x: torch.Tensor, packed: torch.Tensor, m: int) -> torch.Tensor:
    """A block as a registered op on ``x [B,C_in,H,W] f32`` and its packed
    row: on CUDA one launch of ``csrc/entry_block.cu`` (:func:`_launch`), on
    the CPU the plain version. It has no autograd formula: a gradient asked
    through it raises (the trainer runs the graph node by node)."""
    return _launch(x, packed, m)


@entry_block_op.register_kernel("cpu")
def _(x, packed, m):
    _check(x, packed, m)  # the kernel's refusals, on the CPU too
    return entry_block_reference(x, unpack_entry_block(packed, x.shape[1], m))


@entry_block_op.register_fake
def _(x, packed, m):
    B, _, H, W = x.shape
    return x.new_empty((B, 2 * m, H // 2, W // 2))


@register_flop_formula(torch.ops.zaru_tpu_torch.entry_block)
def entry_block_flops(x_shape, packed_shape, m, *args, out_shape=None, **kwargs) -> int:
    """``B·Ho·Wo·(M·(8·C_in + 2) + 19·M + C_out·(2·M + 3))``, as
    ``onnx/analysis.analyze`` counts the nodes: the 2×2 convolution's
    multiply-adds and its bias, PReLU_1's multiply, the depthwise's nine
    multiply-adds and its bias, the 1×1's multiply-adds and its bias, the
    Add and PReLU_2's multiply; the pool and the pad count nothing."""
    B, c_in, H, W = x_shape
    c_out = 2 * m
    return B * (H // 2) * (W // 2) * (m * (8 * c_in + 2) + 19 * m + c_out * (2 * m + 3))


def fused_entry_block(x, packed, m: int):
    """Runs the packed block on ``x [B,C_in,H,W] f32`` → ``[B,2M,H/2,W/2]``,
    through :func:`entry_block_op`: a CUDA tensor launches the kernel (or
    raises), a CPU tensor runs the plain version; on both, what the kernel
    does not take raises (:func:`_check`, once, in the op). The call is the
    span ``zaru.net.entry_block`` and adds one to
    ``profiling.counters["entry_blocks"]``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    profiling.counters["entry_blocks"] += 1
    with profiling.span("zaru.net.entry_block"):
        return entry_block_op(x, packed, m)
