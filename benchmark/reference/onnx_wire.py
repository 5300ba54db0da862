"""A minimal ONNX protobuf reader for the plain reference: a frozen copy of
a wire parser for the subset the face models use (graph topology,
initializers, attributes, I/O value infos), so the reference reads the
model files without the program or the ``onnx`` package. Field numbers
follow the public ``onnx.proto3`` schema.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["OnnxModel", "OnnxGraph", "OnnxNode", "parse_model"]


# --- wire-format primitives -------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a serialized message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wtype == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wtype == 5:  # 32-bit
            val = buf[i : i + 4]
            i += 4
        elif wtype == 1:  # 64-bit
            val = buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _zigzag_to_signed(v: int, bits: int = 64) -> int:
    # ONNX int64 fields are plain (non-zigzag) varints; interpret as two's
    # complement.
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _packed_varints(val, wtype) -> list[int]:
    if wtype == 0:
        return [_zigzag_to_signed(val)]
    out = []
    i = 0
    while i < len(val):
        v, i = _read_varint(val, i)
        out.append(_zigzag_to_signed(v))
    return out


def _packed_f32(val, wtype) -> np.ndarray:
    if wtype == 5:
        return np.frombuffer(val, dtype="<f4")
    return np.frombuffer(val, dtype="<f4")


def _packed_f64(val, wtype) -> np.ndarray:
    return np.frombuffer(val, dtype="<f8")


# --- ONNX messages ------------------------------------------------------------

# TensorProto.DataType values → numpy dtypes.
TENSOR_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: list[np.ndarray] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[np.ndarray] = []

    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            dims.extend(_packed_varints(val, wtype))
        elif fnum == 2:
            data_type = val
        elif fnum == 4:
            float_data.append(_packed_f32(val, wtype))
        elif fnum == 5:
            int32_data.extend(_packed_varints(val, wtype))
        elif fnum == 7:
            int64_data.extend(_packed_varints(val, wtype))
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:
            double_data.append(_packed_f64(val, wtype))

    dtype = TENSOR_DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"unsupported tensor dtype {data_type} for {name!r}")

    if raw is not None:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
    elif float_data:
        arr = np.concatenate(float_data).astype(dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype)
    elif double_data:
        arr = np.concatenate(double_data).astype(dtype)
    else:
        arr = np.zeros(0, dtype=dtype)

    return name, arr.reshape(dims) if dims else arr.reshape(())


@dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict[str, Any] = field(default_factory=dict)


def _parse_attribute(buf: bytes) -> tuple[str, Any]:
    name = ""
    atype = 0
    f_val = None
    i_val = None
    s_val = None
    t_val = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []

    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i_val = _zigzag_to_signed(val)
        elif fnum == 4:
            s_val = val
        elif fnum == 5:
            t_val = _parse_tensor(val)[1]
        elif fnum == 7:
            floats.extend(_packed_f32(val, wtype).tolist() if wtype == 2 else [struct.unpack("<f", val)[0]])
        elif fnum == 8:
            ints.extend(_packed_varints(val, wtype))
        elif fnum == 9:
            strings.append(val)
        elif fnum == 20:
            atype = val

    # AttributeProto.AttributeType: FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6
    # INTS=7 STRINGS=8
    if atype == 1:
        return name, f_val
    if atype == 2:
        return name, i_val
    if atype == 3:
        return name, s_val.decode()
    if atype == 4:
        return name, t_val
    if atype == 6:
        return name, list(floats)
    if atype == 7:
        return name, list(ints)
    if atype == 8:
        return name, [s.decode() for s in strings]
    # Fall back on whichever field was present (some exporters omit `type`).
    for v in (f_val, i_val, t_val):
        if v is not None:
            return name, v
    if s_val is not None:
        return name, s_val.decode()
    if ints:
        return name, list(ints)
    if floats:
        return name, list(floats)
    if strings:
        return name, [s.decode() for s in strings]
    return name, None


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: bytes) -> tuple[str, list[int | str | None], int]:
    """Returns (name, shape, elem_type). Unknown dims are None or dim_param
    strings."""
    name = ""
    shape: list[int | str | None] = []
    elem_type = 1
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            elem_type = v3
                        elif f3 == 2:  # TensorShapeProto
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dim: int | str | None = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dim = _zigzag_to_signed(v5)
                                        elif f5 == 2:
                                            dim = v5.decode()
                                    shape.append(dim)
    return name, shape, elem_type


@dataclass
class ValueInfo:
    name: str
    shape: list
    dtype: Any


@dataclass
class OnnxGraph:
    name: str
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[ValueInfo]
    outputs: list[ValueInfo]


@dataclass
class OnnxModel:
    ir_version: int
    producer: str
    opset: int
    graph: OnnxGraph


def parse_model(data: bytes) -> OnnxModel:
    ir_version = 0
    producer = ""
    opset = 0
    graph = None
    for fnum, _wtype, val in _iter_fields(data):
        if fnum == 1:
            ir_version = val
        elif fnum == 2:
            producer = val.decode()
        elif fnum == 7:
            graph = val
        elif fnum == 8:
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 2:
                    opset = max(opset, _zigzag_to_signed(v2))
    if graph is None:
        raise ValueError("ONNX model has no graph")

    name = ""
    nodes: list[OnnxNode] = []
    initializers: dict[str, np.ndarray] = {}
    g_inputs: list[ValueInfo] = []
    g_outputs: list[ValueInfo] = []
    for fnum, _wtype, val in _iter_fields(graph):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 2:
            name = val.decode()
        elif fnum == 5:
            tname, arr = _parse_tensor(val)
            initializers[tname] = arr
        elif fnum in (11, 12):
            vname, shape, elem = _parse_value_info(val)
            vi = ValueInfo(vname, shape, TENSOR_DTYPES.get(elem, np.float32))
            (g_inputs if fnum == 11 else g_outputs).append(vi)

    return OnnxModel(
        ir_version=ir_version,
        producer=producer,
        opset=opset,
        graph=OnnxGraph(name, nodes, initializers, g_inputs, g_outputs),
    )
