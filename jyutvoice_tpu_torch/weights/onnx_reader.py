"""Dependency-free ONNX model reader (protobuf wire format, stdlib only).

The reference runs campplus.onnx / speech_tokenizer_v2.onnx through
onnxruntime (reference infer.py:355-362). This environment ships neither
`onnx` nor `onnxruntime`, and the rebuild only needs the *weights* (the
architectures are implemented natively in models/campplus.py and
models/s3_tokenizer.py) — so this module parses just enough of the ONNX
protobuf (onnx/onnx.proto) to extract graph initializers and node metadata:

  ModelProto.graph = 7 -> GraphProto{ node = 1, initializer = 5 }
  TensorProto{ dims=1, data_type=2, float_data=4, int32_data=5,
               int64_data=7, name=8, raw_data=9 }
  NodeProto{ input=1, output=2, name=3, op_type=4 }

Only the wire types actually used by these fields are implemented
(varint = 0, 64-bit = 1, length-delimited = 2, 32-bit = 5).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES = {
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


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) for a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            size, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + size]
            pos += size
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")


def _packed_varints(payload: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    # protobuf int64 varints are two's-complement in 64 bits
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:  # dims
            if wire == 0:
                dims.append(_signed(val))
            else:
                dims.extend(_signed(v) for v in _packed_varints(val))
        elif field == 2:
            data_type = val
        elif field == 4:  # float_data (packed)
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif field == 5:  # int32_data (packed varints)
            int32_data.extend(_packed_varints(val) if wire == 2 else [val])
        elif field == 7:  # int64_data
            if wire == 0:
                int64_data.append(_signed(val))
            else:
                int64_data.extend(_signed(v) for v in _packed_varints(val))
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = val
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"tensor {name}: unsupported data_type {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32).astype(dtype, copy=False)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_node(buf: bytes) -> dict:
    node = {"input": [], "output": [], "name": "", "op_type": "", "attrs": {}}
    for field, _wire, val in _fields(buf):
        if field == 1:
            node["input"].append(bytes(val).decode("utf-8"))
        elif field == 2:
            node["output"].append(bytes(val).decode("utf-8"))
        elif field == 3:
            node["name"] = bytes(val).decode("utf-8")
        elif field == 4:
            node["op_type"] = bytes(val).decode("utf-8")
        elif field == 5:  # AttributeProto — tensor attrs (Constant nodes)
            # and scalar int attrs (Gemm transA/transB, needed to bind
            # 2-D weights without guessing their orientation)
            attr_name = ""
            tensor = None
            int_val = None
            for afield, awire, aval in _fields(val):
                if afield == 1:
                    attr_name = bytes(aval).decode("utf-8")
                elif afield == 3 and awire == 0:  # AttributeProto.i
                    int_val = _signed(aval)
                elif afield == 5:  # AttributeProto.t
                    _tname, tensor = _parse_tensor(aval)
            if tensor is not None:
                node["attrs"][attr_name] = tensor
            elif int_val is not None:
                node["attrs"][attr_name] = int_val
    return node


@dataclasses.dataclass
class OnnxGraph:
    initializers: Dict[str, np.ndarray]
    nodes: List[dict]


def read_onnx_bytes(data: bytes) -> OnnxGraph:
    # memoryview: length-delimited slices stay zero-copy, which matters for
    # the ~0.5 GB speech_tokenizer_v2.onnx (raw_data feeds np.frombuffer
    # directly; only names get materialized as bytes)
    data = memoryview(data)
    graph_buf = None
    for field, _wire, val in _fields(data):
        if field == 7:  # ModelProto.graph
            graph_buf = val
            break
    if graph_buf is None:
        raise ValueError("no GraphProto in model (field 7 missing)")
    initializers: Dict[str, np.ndarray] = {}
    nodes: List[dict] = []
    for field, _wire, val in _fields(graph_buf):
        if field == 5:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif field == 1:  # GraphProto.node
            nodes.append(_parse_node(val))
    return OnnxGraph(initializers, nodes)


def read_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        return read_onnx_bytes(f.read())
