"""Minimal dependency-free ONNX reader: initializers AND graph topology.

The `onnx` python package is not available in this environment, but the
reference's model artifacts are ONNX files (version-RFB-320/640, reference
infer_server/src/nn.rs:21-22), and the reference *executes* the downloaded
graph (reference nn.rs:166-174: tract load -> optimize -> run) rather than
assuming its topology. This module implements enough of the protobuf wire
format to recover the full GraphProto — initializers, nodes with
attributes, and graph input/output value infos — so the converter can
*verify* the graph against the expected architecture (models/convert.py)
and the graph executor can run it directly (models/onnx_exec.py).

Wire-format facts used (protobuf encoding spec):
- message = stream of (tag, value); tag = (field_number << 3) | wire_type
- wire types: 0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32
- ModelProto.graph = field 7 (message)
- GraphProto: node = 1, initializer = 5, input = 11, output = 12
- NodeProto: input = 1, output = 2, name = 3, op_type = 4, attribute = 5
- AttributeProto: name = 1, f = 2, i = 3, s = 4, t = 5,
  floats = 7, ints = 8, type = 20
- TensorProto: dims = 1 (repeated int64), data_type = 2 (enum),
  float_data = 4 (packed float), int64_data = 7 (packed varint),
  name = 8 (string), raw_data = 9 (bytes)
- ValueInfoProto: name = 1, type = 2; TypeProto.tensor_type = 1;
  Tensor: elem_type = 1, shape = 2; TensorShapeProto.dim = 1;
  Dimension: dim_value = 1, dim_param = 2
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

# ONNX TensorProto.DataType -> numpy dtype (little-endian)
_DTYPES = {
    1: np.dtype("<f4"),   # FLOAT
    2: np.dtype("u1"),    # UINT8
    3: np.dtype("i1"),    # INT8
    5: np.dtype("<i2"),   # INT16
    6: np.dtype("<i4"),   # INT32
    7: np.dtype("<i8"),   # INT64
    9: np.dtype("?"),     # BOOL
    10: np.dtype("<f2"),  # FLOAT16
    11: np.dtype("<f8"),  # DOUBLE
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def iter_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, val


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    float_words: list[bytes] = []
    int64_vals: list[int] = []
    for field, wtype, val in iter_fields(buf):
        if field == 1 and wtype == 0:
            dims.append(int(val))  # type: ignore[arg-type]
        elif field == 1 and wtype == 2:
            # packed repeated int64 dims
            pos = 0
            while pos < len(val):  # type: ignore[arg-type]
                v, pos = _read_varint(val, pos)  # type: ignore[arg-type]
                dims.append(v)
        elif field == 2 and wtype == 0:
            data_type = int(val)  # type: ignore[arg-type]
        elif field == 4:
            if wtype == 2:  # packed floats
                float_words.append(val)  # type: ignore[arg-type]
            elif wtype == 5:
                float_words.append(val)  # type: ignore[arg-type]
        elif field == 7:
            if wtype == 2:
                pos = 0
                while pos < len(val):  # type: ignore[arg-type]
                    v, pos = _read_varint(val, pos)  # type: ignore
                    int64_vals.append(v)
            elif wtype == 0:
                int64_vals.append(int(val))  # type: ignore[arg-type]
        elif field == 8 and wtype == 2:
            name = val.decode("utf-8")  # type: ignore[union-attr]
        elif field == 9 and wtype == 2:
            raw = val
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"unsupported ONNX tensor dtype {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)  # type: ignore[arg-type]
    elif float_words:
        arr = np.frombuffer(b"".join(float_words), dtype=np.dtype("<f4"))
    elif int64_vals:
        arr = np.asarray(int64_vals, dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=dtype)
    # always apply dims: an empty dims list means a SCALAR tensor (shape
    # ()), which must not stay as shape (1,) — shape-math consumers
    # (Gather/Unsqueeze chains) depend on the rank
    if arr.size != int(np.prod(dims, dtype=np.int64)):
        raise ValueError(
            f"tensor {name!r}: payload has {arr.size} elements but dims "
            f"{dims} imply {int(np.prod(dims, dtype=np.int64))}")
    arr = arr.reshape(dims)
    return name, arr


def read_onnx_initializers(path: str) -> dict[str, np.ndarray]:
    """Extract graph initializers (name -> array) from an ONNX file."""
    return read_onnx_graph(path).initializers


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclasses.dataclass
class OnnxNode:
    """One GraphProto node: an operator application."""

    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, object]


@dataclasses.dataclass
class OnnxValueInfo:
    """Graph input/output: name, elem_type, shape (None = symbolic dim)."""

    name: str
    elem_type: int
    shape: list[int | None]


@dataclasses.dataclass
class OnnxGraph:
    """Parsed GraphProto: enough to validate topology and execute."""

    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[OnnxValueInfo]
    outputs: list[OnnxValueInfo]
    name: str = ""
    # default-domain opset version from the enclosing ModelProto (13
    # when absent/standalone): pre-13 Softmax-family ops have different
    # (flattened-2D) semantics
    opset: int = 13


# AttributeProto.AttributeType values
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_GRAPH = 5
_ATTR_FLOATS, _ATTR_INTS = 6, 7


def _parse_attribute(buf: bytes) -> tuple[str, object]:
    name = ""
    atype = 0
    f_val = 0.0
    i_val = 0
    s_val = b""
    t_val: np.ndarray | None = None
    g_val: "OnnxGraph | None" = None
    floats: list[float] = []
    ints: list[int] = []
    for field, wtype, val in iter_fields(buf):
        if field == 1 and wtype == 2:
            name = val.decode("utf-8")  # type: ignore[union-attr]
        elif field == 20 and wtype == 0:
            atype = int(val)  # type: ignore[arg-type]
        elif field == 2 and wtype == 5:
            f_val = float(np.frombuffer(val, "<f4")[0])  # type: ignore
        elif field == 3 and wtype == 0:
            i_val = _to_signed64(int(val))  # type: ignore[arg-type]
        elif field == 4 and wtype == 2:
            s_val = bytes(val)  # type: ignore[arg-type]
        elif field == 5 and wtype == 2:
            t_val = _parse_tensor(val)[1]  # type: ignore[arg-type]
        elif field == 6 and wtype == 2:  # g: nested GraphProto (If/Loop)
            g_val = parse_graph(val)  # type: ignore[arg-type]
        elif field == 7:
            if wtype == 5:
                floats.append(float(np.frombuffer(val, "<f4")[0]))
            elif wtype == 2:  # packed
                floats.extend(
                    np.frombuffer(val, "<f4").tolist())  # type: ignore
        elif field == 8:
            if wtype == 0:
                ints.append(_to_signed64(int(val)))  # type: ignore
            elif wtype == 2:  # packed
                pos = 0
                while pos < len(val):  # type: ignore[arg-type]
                    v, pos = _read_varint(val, pos)  # type: ignore
                    ints.append(_to_signed64(v))
    # proto3 omits zero-valued scalars, so the declared type — not field
    # presence — decides the value (a missing INT attr really is 0)
    by_type: dict[int, object] = {
        _ATTR_FLOAT: f_val, _ATTR_INT: i_val, _ATTR_STRING: s_val,
        _ATTR_TENSOR: t_val, _ATTR_GRAPH: g_val,
        _ATTR_FLOATS: floats, _ATTR_INTS: ints,
    }
    if atype in by_type:
        return name, by_type[atype]
    # very old exports may omit `type`; fall back to field presence
    for candidate in (t_val if t_val is not None else None,
                      g_val if g_val is not None else None,
                      s_val or None, floats or None, ints or None):
        if candidate is not None:
            return name, candidate
    return name, i_val if i_val else f_val


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", "", [], [], {})
    for field, wtype, val in iter_fields(buf):
        if field == 1 and wtype == 2:
            node.inputs.append(val.decode("utf-8"))  # type: ignore
        elif field == 2 and wtype == 2:
            node.outputs.append(val.decode("utf-8"))  # type: ignore
        elif field == 3 and wtype == 2:
            node.name = val.decode("utf-8")  # type: ignore[union-attr]
        elif field == 4 and wtype == 2:
            node.op_type = val.decode("utf-8")  # type: ignore[union-attr]
        elif field == 5 and wtype == 2:
            k, v = _parse_attribute(val)  # type: ignore[arg-type]
            node.attrs[k] = v
    return node


def _parse_value_info(buf: bytes) -> OnnxValueInfo:
    info = OnnxValueInfo("", 0, [])
    for field, wtype, val in iter_fields(buf):
        if field == 1 and wtype == 2:
            info.name = val.decode("utf-8")  # type: ignore[union-attr]
        elif field == 2 and wtype == 2:  # TypeProto
            for f2, w2, v2 in iter_fields(val):  # type: ignore[arg-type]
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in iter_fields(v2):  # type: ignore
                        if f3 == 1 and w3 == 0:
                            info.elem_type = int(v3)  # type: ignore
                        elif f3 == 2 and w3 == 2:  # shape
                            for f4, w4, v4 in iter_fields(v3):  # type: ignore
                                if f4 == 1 and w4 == 2:  # dim
                                    dim: int | None = None
                                    for f5, w5, v5 in iter_fields(v4):  # type: ignore
                                        if f5 == 1 and w5 == 0:
                                            dim = int(v5)  # type: ignore
                                    info.shape.append(dim)
    return info


def parse_graph(graph_buf: bytes) -> OnnxGraph:
    """Parse one serialized GraphProto."""
    g = OnnxGraph([], {}, [], [])
    for field, wtype, val in iter_fields(graph_buf):
        if field == 1 and wtype == 2:  # node
            g.nodes.append(_parse_node(val))  # type: ignore[arg-type]
        elif field == 2 and wtype == 2:
            g.name = val.decode("utf-8")  # type: ignore[union-attr]
        elif field == 5 and wtype == 2:  # initializer
            name, arr = _parse_tensor(val)  # type: ignore[arg-type]
            g.initializers[name] = arr
        elif field == 11 and wtype == 2:  # input
            g.inputs.append(_parse_value_info(val))  # type: ignore
        elif field == 12 and wtype == 2:  # output
            g.outputs.append(_parse_value_info(val))  # type: ignore
    # GraphProto.input includes initializers in older IR versions; keep
    # only true runtime inputs
    g.inputs = [i for i in g.inputs if i.name not in g.initializers]
    return g


def read_onnx_graph(path: str) -> OnnxGraph:
    """Parse an ONNX ModelProto file into an OnnxGraph.

    Malformed input raises ValueError (never IndexError/UnicodeError):
    truncated varints, out-of-range lengths, and garbage bytes all
    surface as a clean parse failure."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    opset = None
    try:
        for field, wtype, val in iter_fields(model):
            if field == 7 and wtype == 2:  # ModelProto.graph
                graph = parse_graph(val)  # type: ignore[arg-type]
            elif field == 8 and wtype == 2:  # opset_import
                domain = b""
                version = 0
                for f2, w2, v2 in iter_fields(val):  # type: ignore
                    if f2 == 1 and w2 == 2:
                        domain = bytes(v2)  # type: ignore[arg-type]
                    elif f2 == 2 and w2 == 0:
                        version = int(v2)  # type: ignore[arg-type]
                if domain in (b"", b"ai.onnx"):
                    opset = version
    except (IndexError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: malformed ONNX file ({e})") from e
    if graph is None:
        raise ValueError(
            f"{path}: no graph found (not an ONNX ModelProto?)")
    if opset is not None:
        graph.opset = opset
    return graph
