"""Minimal ONNX protobuf writer, the encode counterpart of
:mod:`zaru_tpu_torch.onnx.proto` (zaru_tpu/onnx/writer.py).

No ``onnx`` package is needed: this serializes the ``ModelProto`` wire
format directly, with the public ``onnx.proto3`` field numbers the reader
uses. It covers what authoring small models takes: graph topology,
initializers (``raw_data``), attributes (float, int, string, tensor,
floats, ints) and static-shape value infos. Its bytes equal the JAX
package's writer's for the same graph, so a model authored with either
loads in both. Uses: stub models for networks whose blobs are missing
upstream, user models built in code, round-trip tests of the reader::

    w = OnnxWriter()
    w.input("x", (1, 3, 8, 8))
    w.initializer("w", np.zeros((4, 3, 1, 1), np.float32))
    w.node("Conv", ["x", "w"], ["y"], kernel_shape=[1, 1])
    w.output("y", (1, 4, 8, 8))
    module = zaru_tpu_torch.onnx.load_model(w.serialize(), device)
"""

from __future__ import annotations

import struct

import numpy as np

from .proto import TENSOR_DTYPES

__all__ = ["OnnxWriter", "node", "tensor_value_info", "build_model"]

_NP_TO_ONNX = {np.dtype(v): k for k, v in TENSOR_DTYPES.items()}


def _varint(v: int) -> bytes:
    assert v >= 0
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _varint((fnum << 3) | wtype)


def _ld(fnum: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _vint(fnum: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement int64, like the reader expects
    return _tag(fnum, 0) + _varint(v)


def _f32(fnum: int, v: float) -> bytes:
    return _tag(fnum, 5) + struct.pack("<f", v)


def _string(fnum: int, s: str) -> bytes:
    return _ld(fnum, s.encode())


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    onnx_dtype = _NP_TO_ONNX.get(arr.dtype)
    if onnx_dtype is None:
        raise ValueError(f"unsupported initializer dtype {arr.dtype}")
    buf = b"".join(_vint(1, d) for d in arr.shape)
    buf += _vint(2, onnx_dtype)
    buf += _string(8, name)
    buf += _ld(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return buf


def _encode_attribute(name: str, value) -> bytes:
    buf = _string(1, name)
    # AttributeProto.AttributeType: FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6
    # INTS=7
    if isinstance(value, bool):
        buf += _vint(3, int(value)) + _vint(20, 2)
    elif isinstance(value, int):
        buf += _vint(3, value) + _vint(20, 2)
    elif isinstance(value, float):
        buf += _f32(2, value) + _vint(20, 1)
    elif isinstance(value, (str, bytes)):
        s = value.encode() if isinstance(value, str) else value
        buf += _ld(4, s) + _vint(20, 3)
    elif isinstance(value, np.ndarray):
        buf += _ld(5, _encode_tensor("", value)) + _vint(20, 4)
    elif isinstance(value, (list, tuple)) and value and all(
        isinstance(v, float) for v in value
    ):
        buf += _ld(7, struct.pack(f"<{len(value)}f", *value)) + _vint(20, 6)
    elif isinstance(value, (list, tuple)):
        ints = [int(v) for v in value]
        packed = b"".join(
            _varint(v if v >= 0 else v + (1 << 64)) for v in ints
        )
        buf += _ld(8, packed) + _vint(20, 7)
    else:
        raise ValueError(f"unsupported attribute type for {name!r}: {type(value)}")
    return buf


def node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """Encodes one NodeProto."""
    buf = b"".join(_string(1, i) for i in inputs)
    buf += b"".join(_string(2, o) for o in outputs)
    if name:
        buf += _string(3, name)
    buf += _string(4, op_type)
    buf += b"".join(_ld(5, _encode_attribute(k, v)) for k, v in attrs.items())
    return buf


def tensor_value_info(name: str, shape, dtype=np.float32) -> bytes:
    """Encodes one ValueInfoProto with a static tensor shape."""
    dims = b"".join(_ld(1, _vint(1, int(d))) for d in shape)
    tensor_type = _vint(1, _NP_TO_ONNX[np.dtype(dtype)]) + _ld(2, dims)
    return _string(1, name) + _ld(2, _ld(1, tensor_type))


def build_model(
    *,
    nodes: list[bytes],
    inputs: list[bytes],
    outputs: list[bytes],
    initializers: dict[str, np.ndarray] | None = None,
    graph_name: str = "graph",
    producer: str = "zaru_tpu",
    opset: int = 13,
    ir_version: int = 8,
) -> bytes:
    """Assembles a serialized ModelProto from encoded parts."""
    graph = b"".join(_ld(1, n) for n in nodes)
    graph += _string(2, graph_name)
    for tname, arr in (initializers or {}).items():
        graph += _ld(5, _encode_tensor(tname, arr))
    graph += b"".join(_ld(11, i) for i in inputs)
    graph += b"".join(_ld(12, o) for o in outputs)

    model = _vint(1, ir_version)
    model += _string(2, producer)
    model += _ld(7, graph)
    model += _ld(8, _vint(2, opset))  # OperatorSetIdProto.version
    return model


class OnnxWriter:
    """Convenience class for authoring small models.

    >>> w = OnnxWriter()
    >>> w.input("x", (1, 3, 8, 8))
    >>> w.initializer("w", np.zeros((4, 3, 1, 1), np.float32))
    >>> w.node("Conv", ["x", "w"], ["y"], kernel_shape=[1, 1])
    >>> w.output("y", (1, 4, 8, 8))
    >>> data = w.serialize()
    """

    def __init__(self, graph_name: str = "graph", opset: int = 13):
        self._graph_name = graph_name
        self._opset = opset
        self._nodes: list[bytes] = []
        self._inputs: list[bytes] = []
        self._outputs: list[bytes] = []
        self._initializers: dict[str, np.ndarray] = {}

    def input(self, name: str, shape, dtype=np.float32) -> None:
        self._inputs.append(tensor_value_info(name, shape, dtype))

    def output(self, name: str, shape, dtype=np.float32) -> None:
        self._outputs.append(tensor_value_info(name, shape, dtype))

    def initializer(self, name: str, arr: np.ndarray) -> None:
        self._initializers[name] = np.asarray(arr)

    def node(self, op_type: str, inputs, outputs, **attrs) -> None:
        self._nodes.append(node(op_type, inputs, outputs, **attrs))

    def serialize(self) -> bytes:
        return build_model(
            nodes=self._nodes,
            inputs=self._inputs,
            outputs=self._outputs,
            initializers=self._initializers,
            graph_name=self._graph_name,
            opset=self._opset,
        )
