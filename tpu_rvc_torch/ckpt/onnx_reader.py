"""Minimal ONNX protobuf reader and writer, numpy only (port of
tpu_rvc/ckpt/onnx_reader.py; no onnx or onnxruntime dependency).

The reference's MDX-Net dereverb runs an opaque ONNX graph through
onnxruntime (infer/modules/uvr5/mdxnet.py:92-105), and its exporter writes
the synthesizer with the onnx package.  This module hand-decodes the
protobuf wire format for the subset of ONNX that conv-style model graphs
need (ModelProto -> GraphProto -> NodeProto/TensorProto/AttributeProto),
and encodes the same subset: `ckpt/torch2onnx.py` writes its models with
it, and the tests build fixture graphs with it.  Two repairs over the
JAX copy: negative entries of an INTS attribute read back negative (the
JAX reader gives their 64-bit two's complement), a tensor without dims
reads back 0-d (the JAX reader gives shape (1,)), and a list of floats is
written as FLOATS (the JAX writer truncates it to INTS).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ONNX TensorProto.DataType -> numpy
DTYPE = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
         9: np.bool_, 10: np.float16, 11: np.float64}


# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, v


@dataclass
class OnnxAttr:
    name: str = ""
    i: Optional[int] = None
    f: Optional[float] = None
    s: Optional[bytes] = None
    ints: List[int] = field(default_factory=list)
    floats: List[float] = field(default_factory=list)
    t: Optional[np.ndarray] = None

    @property
    def value(self):
        if self.ints:
            return list(self.ints)
        if self.floats:
            return list(self.floats)
        for v in (self.i, self.f, self.t):
            if v is not None:
                return v
        if self.s is not None:
            return self.s.decode("utf-8", "ignore")
        return None


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, OnnxAttr] = field(default_factory=dict)

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    # name -> (elem_type, shape) where shape dims are int or str (dim_param)
    input_info: Dict[str, Tuple[int, Tuple]] = field(default_factory=dict)


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    name = ""
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            dims.append(v)
        elif fnum == 2:
            dtype = v
        elif fnum == 4:  # float_data (packed)
            floats.extend(np.frombuffer(v, "<f4").tolist()) if wt == 2 else \
                floats.append(struct.unpack("<f", v)[0])
        elif fnum == 7:  # int64_data (packed varints)
            i = 0
            while i < len(v):
                val, i = _read_varint(v, i)
                ints.append(val - (1 << 64) if val >= (1 << 63) else val)
        elif fnum == 8:
            name = v.decode()
        elif fnum == 9:
            raw = v
    np_dtype = DTYPE.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np_dtype)
    elif ints:
        arr = np.asarray(ints, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    if not dims and arr.size == 1:
        return name, arr.reshape(())   # no dims: a 0-d tensor
    return name, arr.reshape(dims) if dims else arr


def _parse_attr(buf: bytes) -> OnnxAttr:
    a = OnnxAttr()
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            a.name = v.decode()
        elif fnum == 2:
            a.f = struct.unpack("<f", v)[0]
        elif fnum == 3:
            a.i = v - (1 << 64) if v >= (1 << 63) else v
        elif fnum == 4:
            a.s = v
        elif fnum == 5:
            _, a.t = _parse_tensor(v)
        elif fnum == 7:  # packed/unpacked repeated ints, two's complement
            if wt == 0:
                a.ints.append(_signed(v))
            else:
                i = 0
                while i < len(v):
                    val, i = _read_varint(v, i)
                    a.ints.append(_signed(val))
        elif fnum == 6:
            if wt == 5:
                a.floats.append(struct.unpack("<f", v)[0])
            else:
                a.floats.extend(np.frombuffer(v, "<f4").tolist())
    return a


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            node.inputs.append(v.decode())
        elif fnum == 2:
            node.outputs.append(v.decode())
        elif fnum == 3:
            node.name = v.decode()
        elif fnum == 4:
            node.op_type = v.decode()
        elif fnum == 5:
            a = _parse_attr(v)
            node.attrs[a.name] = a
    return node


def _parse_value_info(buf: bytes) -> Tuple[str, int, Optional[Tuple]]:
    name, elem, shape = "", 1, None
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            name = v.decode()
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _fields(v):
                if f2 != 1:  # tensor_type
                    continue
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        elem = v3
                    elif f3 == 2:  # TensorShapeProto
                        dims = []
                        for f4, _, v4 in _fields(v3):
                            if f4 != 1:
                                continue
                            d: Any = 0
                            for f5, _, v5 in _fields(v4):
                                if f5 == 1:
                                    d = v5
                                elif f5 == 3:
                                    d = v5.decode()
                            dims.append(d)
                        shape = tuple(dims)
    return name, elem, shape


def _parse_graph(buf: bytes) -> OnnxGraph:
    nodes, inits, ins, outs = [], {}, [], []
    info: Dict[str, Tuple[int, Tuple]] = {}
    name = ""
    for fnum, wt, v in _fields(buf):
        if fnum == 1:
            nodes.append(_parse_node(v))
        elif fnum == 2:
            name = v.decode()
        elif fnum == 5:
            tname, arr = _parse_tensor(v)
            inits[tname] = arr
        elif fnum == 11:
            iname, elem, shape = _parse_value_info(v)
            ins.append(iname)
            if shape is not None:
                info[iname] = (elem, shape)
        elif fnum == 12:
            outs.append(_parse_value_info(v)[0])
    ins = [n for n in ins if n not in inits]
    return OnnxGraph(nodes, inits, ins, outs, name, info)


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        buf = f.read()
    for fnum, wt, v in _fields(buf):
        if fnum == 7:  # ModelProto.graph
            return _parse_graph(v)
    raise ValueError("no graph in ONNX file")


# ---------------------------------------------------------------------------
# encoder (test fixtures)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wt: int) -> bytes:
    return _varint((fnum << 3) | wt)


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


# numpy dtype -> ONNX TensorProto.DataType (inverse of DTYPE above)
ONNX_DTYPE = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
              np.dtype(np.int8): 3, np.dtype(np.int32): 6,
              np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
              np.dtype(np.float16): 10, np.dtype(np.float64): 11}


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = ONNX_DTYPE[arr.dtype]
    out = b""
    for d in arr.shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(dt)
    out += _len_field(8, name.encode())
    out += _len_field(9, arr.tobytes())
    return out


def encode_value_info(name: str, elem_type: int = 1,
                      shape: Optional[Tuple] = None) -> bytes:
    """ValueInfoProto with TensorTypeProto; shape entries may be ints or
    strings (dim_param, the ONNX dynamic-axis spelling)."""
    out = _len_field(1, name.encode())
    if shape is None:
        return out
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _len_field(1, _len_field(3, d.encode()))
        else:
            dims += _len_field(1, _tag(1, 0) + _varint(int(d)))
    tensor_type = _tag(1, 0) + _varint(elem_type) + _len_field(2, dims)
    out += _len_field(2, _len_field(1, tensor_type))
    return out


def encode_attr(name: str, value) -> bytes:
    out = _len_field(1, name.encode())
    if isinstance(value, (list, tuple)) and any(
            isinstance(v, float) for v in value):
        for v in value:
            out += _tag(6, 5) + struct.pack("<f", float(v))
        out += _tag(20, 0) + _varint(6)  # type FLOATS
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _tag(7, 0) + _varint(int(v) & ((1 << 64) - 1))
        out += _tag(20, 0) + _varint(7)  # type INTS
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value)
        out += _tag(20, 0) + _varint(1)
    elif isinstance(value, str):
        out += _len_field(4, value.encode())
        out += _tag(20, 0) + _varint(3)
    else:
        out += _tag(3, 0) + _varint(int(value) & ((1 << 64) - 1))
        out += _tag(20, 0) + _varint(2)
    return out


def encode_node(op_type: str, inputs, outputs, **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    out += _len_field(4, op_type.encode())
    for k, v in attrs.items():
        out += _len_field(5, encode_attr(k, v))
    return out


def encode_model(nodes: List[bytes], initializers: Dict[str, np.ndarray],
                 inputs: List, outputs: List, opset: int = 17,
                 producer: str = "tpu_rvc") -> bytes:
    """ModelProto.  `inputs`/`outputs` entries are names (str) or typed
    (name, elem_type, shape) tuples — shape dims may be str for dynamic
    axes (see encode_value_info)."""
    g = bytearray()   # appends in place: a full-width model is 100s of MB
    for n in nodes:
        g += _len_field(1, n)
    for name, arr in initializers.items():
        g += _len_field(5, encode_tensor(name, arr))
    for i in inputs:
        vi = encode_value_info(i) if isinstance(i, str) else encode_value_info(*i)
        g += _len_field(11, vi)
    for o in outputs:
        vi = encode_value_info(o) if isinstance(o, str) else encode_value_info(*o)
        g += _len_field(12, vi)
    model = _tag(1, 0) + _varint(8)  # ir_version
    model += _len_field(2, producer.encode())
    # opset_import: OperatorSetIdProto {domain="", version=opset}
    model += _len_field(8, _len_field(1, b"") + _tag(2, 0) + _varint(opset))
    return bytes(model + _tag(7, 2) + _varint(len(g)) + g)
