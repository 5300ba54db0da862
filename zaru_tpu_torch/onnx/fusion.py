"""Which subgraphs of an ONNX graph run as one hand-written kernel, and how.

:class:`~zaru_tpu_torch.onnx.executor.OnnxModule` takes the plan of each
kind in :data:`KINDS` when it is built (:func:`find_plans`; f32 modules
only, of the layouts the kind's row names). It runs each entry at node
``entry.at`` as ``entry.run(x, entry.pack(params))`` (packed once) and
skips the entry's other ``nodes``: the executor knows no kernel by name.
On the CPU a kernel runs its plain version, the executor's own nodes, so a
plan changes no number there. Every intermediate of an entry is read by
the entry alone.

- **Stages** (:func:`find_stages`, ``ops/cnn_stage.py``; NCHW and NHWC):
  maximal chains of stride-1 BlazeBlocks, a depthwise 3×3 ``Conv``
  (pads 1) → a 1×1 ``Conv`` C→C → an ``Add`` with the depthwise's input →
  ``PRelu`` or ``Relu``, of a width in ``cnn_stage.KERNEL_CHANNELS``, cut
  into pieces of at most ``cnn_stage.max_blocks(C)`` blocks (each has a
  tiling at any image size).
- **Bottlenecks** (:func:`find_bottlenecks`, ``ops/bottleneck.py``; NCHW):
  maximal chains of stride-1 residual bottleneck blocks, a 1×1 ``Conv``
  C→C/2 → ``PRelu`` → a depthwise 3×3 ``Conv`` (pads 1) → a 1×1 ``Conv``
  C/2→C → an ``Add`` with the block's input → ``PRelu``, of a width in
  ``bottleneck.KERNEL_CHANNELS``.
- **BlazeBlocks** (:func:`find_blaze_blocks`, ``ops/blaze_block.py``; NCHW):
  a depthwise 3×3 ``Conv`` (stride 1 with pads 1, or stride 2 with one
  pixel of padding an axis) → a 1×1 ``Conv`` C_in→C_out → an ``Add`` with
  ``Pad(x)`` (zero channels), ``MaxPool(x)`` (2×2, stride 2) or
  ``Pad(MaxPool(x))`` of the depthwise's input ``x`` → ``Relu`` or
  ``PRelu``; C_out > C_in at stride 1. Two blocks may share one
  ``MaxPool`` (Face Mesh V1); it runs as a node only if others read it.
- **Entry blocks** (:func:`find_entry_blocks`, ``ops/entry_block.py``;
  NCHW): stride-2 residual bottleneck blocks, a 2×2 stride-2 ``Conv``
  C_in→M of x → ``PRelu`` → a depthwise 3×3 ``Conv`` (pads 1) → a 1×1
  ``Conv`` M→2M → an ``Add`` with ``MaxPool(x)`` (2×2, stride 2) or
  ``Pad(MaxPool(x))`` (zero channels up to 2M) → ``PRelu``, of widths in
  ``entry_block.KERNEL_WIDTHS``. The ``MaxPool`` and ``Pad`` are the
  block's only where the block alone reads them; else they run as nodes
  too.

**A new kernel** needs its ``ops/`` module, its ``csrc/`` source, and here
an entry class (its fields, ``at``, ``pack`` and ``run``), its finder and
a row of :data:`KINDS`; ``OnnxModule`` needs no edit. The finders share
:class:`_Graph`'s helpers and :func:`_chains`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..ops import blaze_block, bottleneck, cnn_stage, entry_block
from .proto import OnnxModel

__all__ = ["KINDS", "PLANS", "BlazeBlock", "Bottlenecks", "EntryBlock", "Stage", "find_blaze_blocks",
           "find_bottlenecks", "find_entry_blocks", "find_plans", "find_stages"]

# A stride-2 depthwise's pads (top, left, bottom, right): one pixel an axis.
_STRIDE2_PADS = frozenset((t, l, 1 - t, 1 - l) for t in (0, 1) for l in (0, 1))


class _Graph:
    """A graph's nodes and initializers with the maps the matchers read:
    ``consumers`` (value name → the indices of the nodes that read it, -1
    for a graph output) and ``producer`` (value name → its node's index)."""

    def __init__(self, model: OnnxModel):
        g = model.graph
        self.nodes, self.inits = g.nodes, g.initializers
        self.consumers: dict[str, list[int]] = {}
        for i, n in enumerate(self.nodes):
            for name in n.inputs:
                self.consumers.setdefault(name, []).append(i)
        for vi in g.outputs:
            self.consumers.setdefault(vi.name, []).append(-1)
        self.producer = {o: i for i, n in enumerate(self.nodes) for o in n.outputs}

    def only(self, name: str, *ops: str) -> int | None:
        """The node that alone reads ``name``, if its op is one of ``ops``."""
        cs = self.consumers.get(name, [])
        return cs[0] if len(cs) == 1 and cs[0] >= 0 and self.nodes[cs[0]].op_type in ops else None

    def weight(self, i: int):
        """The 4-D weights of ``nodes[i]`` if it is a Conv with a bias, else None."""
        n = self.nodes[i]
        w = self.inits.get(n.inputs[1]) if n.op_type == "Conv" and len(n.inputs) == 3 else None
        return w if w is not None and w.ndim == 4 else None

    def conv(self, i: int, src: str, shape: tuple, group: int = 1, stride: int = 1,
             pads=frozenset({(0, 0, 0, 0)})) -> bool:
        """Whether ``nodes[i]`` is a ``Conv`` of ``src`` with weights of
        ``shape`` (None: any size on that axis) and a bias among the
        initializers, ``group`` groups, ``stride`` on both axes, no dilation
        and pads ``(top, left, bottom, right)`` among ``pads`` (``auto_pad``
        unset, or VALID where there are none)."""
        n = self.nodes[i]
        if n.op_type != "Conv" or len(n.inputs) != 3 or n.inputs[0] != src or n.inputs[2] not in self.inits:
            return False
        w = self.inits.get(n.inputs[1])
        if w is None or w.ndim != len(shape) or any(s is not None and s != d for s, d in zip(shape, w.shape)):
            return False
        a = n.attrs
        p = tuple(a.get("pads") or (0, 0, 0, 0))
        auto_pad = a.get("auto_pad", "NOTSET")
        return (a.get("group", 1) == group and a.get("strides", [1, 1]) == [stride, stride]
                and a.get("dilations", [1, 1]) == [1, 1] and p in pads
                and (auto_pad == "NOTSET" or auto_pad == "VALID" and not any(p)))

    def activation(self, name: str, n: int, ops=("PRelu", "Relu")):
        """The node that alone reads ``name``, if it is a ``Relu`` of it or a
        ``PRelu`` of it with ``n`` slopes among the initializers (one of
        ``ops``): ``(its index, the slopes' name or None for a Relu)``; else
        None."""
        k = self.only(name, *ops)
        if k is None or self.nodes[k].inputs[0] != name:
            return None
        if self.nodes[k].op_type == "Relu":
            return k, None
        slope = self.nodes[k].inputs[1]
        return (k, slope) if slope in self.inits and self.inits[slope].size == n else None


@dataclass(frozen=True)
class _Block:
    """One block a chain matcher found: its input, channel count,
    initializer names, node indices (its first node first), its ``Add``'s
    index and its output."""

    input: str
    channels: int
    names: dict
    nodes: tuple
    add: int
    output: str


def _chains(g: _Graph, block_at) -> list[list[_Block]]:
    """The graph's maximal chains of the blocks ``block_at(g, i)`` finds
    (a :class:`_Block` whose first node is ``nodes[i]``, or None), in graph
    order. A block's output continues the chain where exactly the next
    block's first node and its ``Add`` read it."""
    chains, taken = [], set()
    for i in range(len(g.nodes)):
        if i in taken:
            continue
        block = block_at(g, i)
        if block is None:
            continue
        chain = [block]
        while True:
            cs = g.consumers.get(chain[-1].output, [])
            nxt = [f for f in (block_at(g, c) for c in cs if c >= 0)
                   if f is not None and set(cs) == {f.nodes[0], f.add}]
            if len(cs) != 2 or not nxt:
                break
            chain.append(nxt[-1])
        taken.update(k for b in chain for k in b.nodes)
        chains.append(chain)
    return chains


def _weights(names: dict, params: dict) -> dict:
    """A block's initializer names → their parameters (None stays None)."""
    return {k: None if v is None else params[v] for k, v in names.items()}


@dataclass(frozen=True)
class _Chain:
    """A chain of blocks: its input and output value names, its channel
    count, each block's initializer names and the indices of its nodes in
    the graph. It runs at its first node."""

    input: str
    output: str
    channels: int
    blocks: tuple
    nodes: tuple

    @property
    def at(self) -> int:
        return self.nodes[0]

    @classmethod
    def of(cls, blocks: list[_Block]):
        return cls(blocks[0].input, blocks[-1].output, blocks[0].channels, tuple(b.names for b in blocks),
                   tuple(k for b in blocks for k in b.nodes))


class Stage(_Chain):
    """A chain of stride-1 BlazeBlocks; a block's names are ``dw_w``,
    ``dw_b``, ``pw_w``, ``pw_b`` and ``alpha`` (None for a ReLU)."""

    def pack(self, params):
        return cnn_stage.pack_blocks([_weights(b, params) for b in self.blocks], self.channels)

    def run(self, x, packed):
        return cnn_stage.fused_blocks(x, packed, x.shape[2], x.shape[3], self.channels)


def _block_at(g: _Graph, i: int) -> _Block | None:
    """The stride-1 BlazeBlock whose depthwise conv is ``nodes[i]``."""
    dw, wt = g.nodes[i], g.weight(i)
    if wt is None:
        return None
    C, x = wt.shape[0], dw.inputs[0]
    if not g.conv(i, x, (C, 1, 3, 3), C, 1, {(1, 1, 1, 1)}):
        return None
    j = g.only(dw.outputs[0], "Conv")
    if j is None or not g.conv(j, dw.outputs[0], (C, C, 1, 1)):
        return None
    pw = g.nodes[j]
    k = g.only(pw.outputs[0], "Add")
    if k is None or sorted(g.nodes[k].inputs) != sorted([x, pw.outputs[0]]):
        return None
    act = g.activation(g.nodes[k].outputs[0], C)
    if act is None:
        return None
    names = {"dw_w": dw.inputs[1], "dw_b": dw.inputs[2], "pw_w": pw.inputs[1], "pw_b": pw.inputs[2],
             "alpha": act[1]}
    return _Block(x, C, names, (i, j, k, act[0]), k, g.nodes[act[0]].outputs[0])


def find_stages(model: OnnxModel) -> list[Stage]:
    """The graph's chains of BlazeBlocks that the stage kernel takes, in
    pieces of at most ``cnn_stage.max_blocks(C)`` blocks."""
    stages = []
    for chain in _chains(_Graph(model), _block_at):
        C = chain[0].channels
        if C in cnn_stage.KERNEL_CHANNELS:
            most = cnn_stage.max_blocks(C)
            stages += [Stage.of(chain[s:s + most]) for s in range(0, len(chain), most)]
    return stages


class Bottlenecks(_Chain):
    """A chain of residual bottleneck blocks; a block's names are ``w1``,
    ``b1``, ``a1``, ``dw_w``, ``dw_b``, ``w2``, ``b2`` and ``a2``."""

    def pack(self, params):
        return bottleneck.pack_bottlenecks([_weights(b, params) for b in self.blocks], self.channels)

    def run(self, x, packed):
        return bottleneck.fused_bottlenecks(x, packed, x.shape[2], x.shape[3], self.channels)


def _bottleneck_at(g: _Graph, i: int) -> _Block | None:
    """The bottleneck block whose first 1×1 conv is ``nodes[i]``."""
    c1, w1 = g.nodes[i], g.weight(i)
    if w1 is None:
        return None
    C, x = w1.shape[1], c1.inputs[0]
    M = C // 2
    if C % 2 or not g.conv(i, x, (M, C, 1, 1)):
        return None
    p1 = g.activation(c1.outputs[0], M, ("PRelu",))
    if p1 is None:
        return None
    mid = g.nodes[p1[0]].outputs[0]
    dw = g.only(mid, "Conv")
    if dw is None or not g.conv(dw, mid, (M, 1, 3, 3), M, 1, {(1, 1, 1, 1)}):
        return None
    c2 = g.only(g.nodes[dw].outputs[0], "Conv")
    if c2 is None or not g.conv(c2, g.nodes[dw].outputs[0], (C, M, 1, 1)):
        return None
    add = g.only(g.nodes[c2].outputs[0], "Add")
    if add is None or sorted(g.nodes[add].inputs) != sorted([x, g.nodes[c2].outputs[0]]):
        return None
    p2 = g.activation(g.nodes[add].outputs[0], C, ("PRelu",))
    if p2 is None:
        return None
    names = {"w1": c1.inputs[1], "b1": c1.inputs[2], "a1": p1[1], "dw_w": g.nodes[dw].inputs[1],
             "dw_b": g.nodes[dw].inputs[2], "w2": g.nodes[c2].inputs[1], "b2": g.nodes[c2].inputs[2], "a2": p2[1]}
    return _Block(x, C, names, (i, p1[0], dw, c2, add, p2[0]), add, g.nodes[p2[0]].outputs[0])


def find_bottlenecks(model: OnnxModel) -> list[Bottlenecks]:
    """The graph's chains of residual bottleneck blocks that the bottleneck
    kernel takes."""
    return [Bottlenecks.of(chain) for chain in _chains(_Graph(model), _bottleneck_at)
            if chain[0].channels in bottleneck.KERNEL_CHANNELS]


@dataclass(frozen=True)
class BlazeBlock:
    """A BlazeBlock with a pooled or channel-padded residual: its input and
    output value names, its widths, stride, the depthwise's pads ``(top,
    left, bottom, right)``, whether its activation is a ReLU, its
    initializer names (``dw_w``, ``dw_b``, ``pw_w``, ``pw_b``, ``alpha``;
    ``alpha`` None for a ReLU) and the indices of the nodes it replaces, in
    graph order (the activation last). It runs at its activation."""

    input: str
    output: str
    c_in: int
    c_out: int
    stride: int
    pads: tuple
    relu: bool
    names: dict
    nodes: tuple

    @property
    def at(self) -> int:
        return self.nodes[-1]

    def pack(self, params):
        return blaze_block.pack_blaze_block(_weights(self.names, params), self.c_in, self.c_out)

    def run(self, x, packed):
        return blaze_block.fused_blaze_block(x, packed, self.c_out, self.stride, self.pads, self.relu)


def _channel_pad(node, inits) -> int | None:
    """The channels a ``Pad`` node adds at the end of axis 1 of a 4-D value
    with zeros, padding nothing else, or None."""
    ins, a = node.inputs, node.attrs
    if node.op_type != "Pad" or a.get("mode", "constant") != "constant":
        return None
    pads = a.get("pads")
    if pads is None and len(ins) > 1:
        pads = inits[ins[1]].tolist() if ins[1] in inits else None
    value = a.get("value", 0.0)
    if len(ins) > 2 and ins[2]:
        v = inits.get(ins[2])
        value = None if v is None or v.size != 1 else float(v.reshape(-1)[0])
    if pads is None or len(pads) != 8 or value != 0.0 or any(pads[k] for k in (0, 1, 2, 3, 4, 6, 7)):
        return None
    return int(pads[5]) if pads[5] > 0 else None


def _max_pool_2x2(node) -> bool:
    a = node.attrs
    return (node.op_type == "MaxPool" and len(node.outputs) == 1 and a.get("kernel_shape") == [2, 2]
            and a.get("strides") == [2, 2] and not any(a.get("pads") or [])
            and a.get("auto_pad", "NOTSET") in ("NOTSET", "VALID") and not a.get("ceil_mode", 0)
            and a.get("dilations", [1, 1]) == [1, 1] and not a.get("storage_order", 0))


def _blaze_block_at(g: _Graph, i: int) -> BlazeBlock | None:
    """The BlazeBlock whose depthwise conv is ``nodes[i]``, its pool among its nodes."""
    dw, wt = g.nodes[i], g.weight(i)
    if wt is None:
        return None
    c_in, x = wt.shape[0], dw.inputs[0]
    stride = 1 if g.conv(i, x, (c_in, 1, 3, 3), c_in, 1, {(1, 1, 1, 1)}) else 2
    if stride == 2 and not g.conv(i, x, (c_in, 1, 3, 3), c_in, 2, _STRIDE2_PADS):
        return None
    j = g.only(dw.outputs[0], "Conv")
    if j is None or not g.conv(j, dw.outputs[0], (None, c_in, 1, 1)):
        return None
    pw = g.nodes[j]
    c_out = g.inits[pw.inputs[1]].shape[0]
    if c_out < c_in or (c_out == c_in and stride == 1):
        return None
    k = g.only(pw.outputs[0], "Add")
    if k is None or len(g.nodes[k].inputs) != 2 or pw.outputs[0] not in g.nodes[k].inputs:
        return None
    add = g.nodes[k]
    r = add.inputs[1] if add.inputs[0] == pw.outputs[0] else add.inputs[0]
    # The residual, from the Add back to x: Pad, then MaxPool at stride 2.
    taken, src = [], r
    if c_out > c_in:
        pad = g.producer.get(src)
        if pad is None or g.only(src, "Add") != k or _channel_pad(g.nodes[pad], g.inits) != c_out - c_in:
            return None
        taken.append(pad)
        src = g.nodes[pad].inputs[0]
    if stride == 2:
        pool = g.producer.get(src)
        if pool is None or not _max_pool_2x2(g.nodes[pool]):
            return None
        taken.append(pool)
        src = g.nodes[pool].inputs[0]
    if src != x:
        return None
    act = g.activation(add.outputs[0], c_out)
    if act is None:
        return None
    names = {"dw_w": dw.inputs[1], "dw_b": dw.inputs[2], "pw_w": pw.inputs[1], "pw_b": pw.inputs[2],
             "alpha": act[1]}
    pads = tuple(dw.attrs.get("pads"))
    return BlazeBlock(x, g.nodes[act[0]].outputs[0], c_in, c_out, stride, pads, act[1] is None, names,
                      tuple(sorted([i, j, k, act[0], *taken])))


def find_blaze_blocks(model: OnnxModel) -> list[BlazeBlock]:
    """The graph's BlazeBlocks that the BlazeBlock kernel takes. A
    ``MaxPool`` stays among a block's nodes only where the found blocks
    alone read it; else it runs as a node too."""
    g = _Graph(model)
    found = [b for b in (_blaze_block_at(g, i) for i in range(len(g.nodes))) if b is not None]
    pools = {k for b in found for k in b.nodes if g.nodes[k].op_type == "MaxPool"}
    inside = {k for b in found for k in b.nodes} - pools
    shared = {k for k in pools if not set(g.consumers.get(g.nodes[k].outputs[0], [])) <= inside}
    return [replace(b, nodes=tuple(k for k in b.nodes if k not in shared)) for b in found]


@dataclass(frozen=True)
class EntryBlock:
    """A stride-2 residual bottleneck block: its input and output value
    names, its widths (``c_out = 2·m``), its initializer names (``w1``,
    ``b1``, ``a1``, ``dw_w``, ``dw_b``, ``w2``, ``b2``, ``a2``) and the
    indices of the nodes it replaces, in graph order (the last PRelu last).
    It runs at its last PRelu."""

    input: str
    output: str
    c_in: int
    m: int
    c_out: int
    names: dict
    nodes: tuple

    @property
    def at(self) -> int:
        return self.nodes[-1]

    def pack(self, params):
        return entry_block.pack_entry_block(_weights(self.names, params), self.c_in, self.m)

    def run(self, x, packed):
        return entry_block.fused_entry_block(x, packed, self.m)


def _entry_block_at(g: _Graph, i: int) -> EntryBlock | None:
    """The entry block whose 2×2 stride-2 convolution is ``nodes[i]``."""
    c1, w1 = g.nodes[i], g.weight(i)
    if w1 is None:
        return None
    m, c_in, x = w1.shape[0], w1.shape[1], c1.inputs[0]
    c_out = 2 * m
    if (c_in, m) not in entry_block.KERNEL_WIDTHS or not g.conv(i, x, (m, c_in, 2, 2), 1, 2):
        return None
    p1 = g.activation(c1.outputs[0], m, ("PRelu",))
    if p1 is None:
        return None
    mid = g.nodes[p1[0]].outputs[0]
    dw = g.only(mid, "Conv")
    if dw is None or not g.conv(dw, mid, (m, 1, 3, 3), m, 1, {(1, 1, 1, 1)}):
        return None
    c2 = g.only(g.nodes[dw].outputs[0], "Conv")
    if c2 is None or not g.conv(c2, g.nodes[dw].outputs[0], (c_out, m, 1, 1)):
        return None
    v = g.nodes[c2].outputs[0]
    k = g.only(v, "Add")
    if k is None or len(g.nodes[k].inputs) != 2 or v not in g.nodes[k].inputs:
        return None
    add = g.nodes[k]
    # The residual, from the Add back to x: a channel Pad where C_out > C_in, then the MaxPool.
    residual, src = [], add.inputs[1] if add.inputs[0] == v else add.inputs[0]
    if c_out > c_in:
        pad = g.producer.get(src)
        if pad is None or _channel_pad(g.nodes[pad], g.inits) != c_out - c_in:
            return None
        residual.append(pad)
        src = g.nodes[pad].inputs[0]
    pool = g.producer.get(src)
    if pool is None or not _max_pool_2x2(g.nodes[pool]) or g.nodes[pool].inputs[0] != x:
        return None
    residual.append(pool)
    p2 = g.activation(add.outputs[0], c_out, ("PRelu",))
    if p2 is None:
        return None
    nodes = {i, p1[0], dw, c2, k, p2[0]}
    for j in residual:  # the Pad first: the MaxPool is the block's only where the block's Pad alone reads it
        if set(g.consumers.get(g.nodes[j].outputs[0], [])) <= nodes:
            nodes.add(j)
    names = {"w1": c1.inputs[1], "b1": c1.inputs[2], "a1": p1[1], "dw_w": g.nodes[dw].inputs[1],
             "dw_b": g.nodes[dw].inputs[2], "w2": g.nodes[c2].inputs[1], "b2": g.nodes[c2].inputs[2], "a2": p2[1]}
    return EntryBlock(x, g.nodes[p2[0]].outputs[0], c_in, m, c_out, names, tuple(sorted(nodes)))


def find_entry_blocks(model: OnnxModel) -> list[EntryBlock]:
    """The graph's stride-2 residual bottleneck blocks that the entry block
    kernel takes."""
    g = _Graph(model)
    return [b for b in (_entry_block_at(g, i) for i in range(len(g.nodes))) if b is not None]


# Each kind of plan, as OnnxModule's attribute names it: its finder, and the
# layouts of the f32 modules that build it (no bf16 module builds any).
KINDS = {
    "stages": (find_stages, ("NCHW", "NHWC")),
    "bottlenecks": (find_bottlenecks, ("NCHW",)),
    "blaze_blocks": (find_blaze_blocks, ("NCHW",)),
    "entry_blocks": (find_entry_blocks, ("NCHW",)),
}
PLANS = tuple(KINDS)


def find_plans(model: OnnxModel, compute_dtype, layout: str) -> dict[str, list]:
    """Each kind's entries in ``model`` for a module of ``compute_dtype``
    (None: f32) and ``layout``; none where the kind does not take it."""
    return {kind: find(model) if compute_dtype is None and layout in layouts else []
            for kind, (find, layouts) in KINDS.items()}
