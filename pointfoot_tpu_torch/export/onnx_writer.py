"""Pure-Python ONNX serializer for MLP actors, no `onnx` package needed
(pointfoot_tpu/export/onnx_writer.py, the port's own copy).

The actor MLP deploys as ONNX opset 13 through onnxruntime.  Neither the
`onnx` serializer nor onnxruntime is installed, so `torch.onnx.export`
cannot produce the file: the ModelProto protobuf wire format is encoded by
hand here.  The output is a standard `.onnx` file: `Gemm` (transB=1, as
torch exports `nn.Linear`) and `Elu`/`Relu`/`Tanh`/`Selu` nodes, float32
initializers in `raw_data`, opset 13, loadable by onnxruntime, netron or
onnx.load.  For the same layers it is byte for byte the JAX package's file.

A matching minimal parser (`read_mlp_onnx`) decodes the same subset, so a
file can be read back and run without any external dependency.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------- protobuf

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_varint(field: int, v: int) -> bytes:
    return _tag(field, _VARINT) + _varint(v)


def _field_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(data)) + data


def _field_str(field: int, s: str) -> bytes:
    return _field_bytes(field, s.encode("utf-8"))


def _field_float(field: int, f: float) -> bytes:
    return _tag(field, _I32) + struct.pack("<f", f)


# ------------------------------------------------------------- onnx pieces

_FLOAT = 1  # TensorProto.DataType.FLOAT

# AttributeProto.AttributeType
_ATTR_FLOAT, _ATTR_INT = 1, 2


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1(repeated), data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    out = b""
    for d in arr.shape:
        out += _field_varint(1, d)
    out += _field_varint(2, _FLOAT)
    out += _field_str(8, name)
    out += _field_bytes(9, arr.tobytes())
    return out


def _tensor_type(elem_type: int, shape: Sequence) -> bytes:
    """TypeProto{tensor_type=1{elem_type=1, shape=2{dim=1{dim_value=1 |
    dim_param=2}}}}."""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _field_bytes(1, _field_str(2, d))
        else:
            dims += _field_bytes(1, _field_varint(1, int(d)))
    tt = _field_varint(1, elem_type) + _field_bytes(2, dims)
    return _field_bytes(1, tt)


def _value_info(name: str, shape: Sequence) -> bytes:
    """ValueInfoProto: name=1, type=2."""
    return _field_str(1, name) + _field_bytes(2, _tensor_type(_FLOAT, shape))


def _attr_float(name: str, v: float) -> bytes:
    return (_field_str(1, name) + _field_float(2, v)
            + _field_varint(20, _ATTR_FLOAT))


def _attr_int(name: str, v: int) -> bytes:
    return (_field_str(1, name) + _field_varint(3, v)
            + _field_varint(20, _ATTR_INT))


def _node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str, attrs: Sequence[bytes] = ()) -> bytes:
    """NodeProto: input=1(rep), output=2(rep), name=3, op_type=4, attr=5."""
    out = b""
    for i in inputs:
        out += _field_str(1, i)
    for o in outputs:
        out += _field_str(2, o)
    out += _field_str(3, name)
    out += _field_str(4, op_type)
    for a in attrs:
        out += _field_bytes(5, a)
    return out


_ACT_OPS = {"elu": "Elu", "relu": "Relu", "tanh": "Tanh", "selu": "Selu"}


def write_mlp_onnx(layers: List[Tuple[np.ndarray, np.ndarray]], path: str,
                   activation: str = "elu", input_name: str = "obs",
                   output_name: str = "actions", opset: int = 13) -> str:
    """Serialize an MLP to ONNX.

    `layers`: [(W, b), ...] with W of shape (in, out) (the transpose of an
    nn.Linear weight; stored transposed as Gemm's B with transB=1, exactly
    what torch emits for nn.Linear).  Activation applied between layers,
    not after the last.
    """
    act_op = _ACT_OPS[activation]
    obs_dim = layers[0][0].shape[0]
    act_dim = layers[-1][0].shape[1]

    nodes = b""
    inits = b""
    cur = input_name
    for i, (W, b) in enumerate(layers):
        wname, bname = f"actor.{i}.weight", f"actor.{i}.bias"
        inits += _field_bytes(5, _tensor_proto(wname, np.asarray(W).T))
        inits += _field_bytes(5, _tensor_proto(bname, np.asarray(b)))
        out = output_name if i == len(layers) - 1 else f"gemm_{i}"
        nodes += _field_bytes(1, _node(
            "Gemm", [cur, wname, bname], [out], f"Gemm_{i}",
            [_attr_float("alpha", 1.0), _attr_float("beta", 1.0),
             _attr_int("transB", 1)]))
        cur = out
        if i < len(layers) - 1:
            act_out = f"act_{i}"
            attrs = [_attr_float("alpha", 1.0)] if act_op == "Elu" else []
            nodes += _field_bytes(1, _node(
                act_op, [cur], [act_out], f"{act_op}_{i}", attrs))
            cur = act_out

    graph = (
        nodes
        + _field_str(2, "actor")
        + inits
        + _field_bytes(11, _value_info(input_name, ["batch", obs_dim]))
        + _field_bytes(12, _value_info(output_name, ["batch", act_dim]))
    )
    model = (
        _field_varint(1, 7)  # ir_version 7 (opset-13 era)
        + _field_str(2, "pointfoot_tpu")
        + _field_str(3, "0.1")
        + _field_bytes(7, graph)
        + _field_bytes(8, _field_varint(2, opset))  # opset_import{version}
    )
    with open(path, "wb") as f:
        f.write(model)
    return path


# ---------------------------------------------------------------- reader


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            v, i = _read_varint(data, i)
        elif wire == _LEN:
            ln, i = _read_varint(data, i)
            v = data[i:i + ln]
            i += ln
        elif wire == _I32:
            v = struct.unpack("<f", data[i:i + 4])[0]
            i += 4
        elif wire == _I64:
            v = struct.unpack("<d", data[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def read_mlp_onnx(path: str):
    """Decode an MLP .onnx written by `write_mlp_onnx` (or torch's exporter
    with the same Gemm/activation structure).

    Returns (layers, activation, input_name, output_name, opset) with W in
    (in, out) layout: `layers` feeds straight into a numpy forward pass.
    """
    with open(path, "rb") as f:
        data = f.read()
    graph = None
    opset = None
    for field, _, v in _iter_fields(data):
        if field == 7:
            graph = v
        elif field == 8:
            for f2, _, v2 in _iter_fields(v):
                if f2 == 2:
                    opset = v2
    if graph is None:
        raise ValueError("no GraphProto in model")

    tensors = {}
    nodes = []
    io_names = {11: None, 12: None}
    for field, _, v in _iter_fields(graph):
        if field == 5:  # initializer
            dims, name, raw = [], None, None
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    dims.append(v2)
                elif f2 == 8:
                    name = v2.decode()
                elif f2 == 9:
                    raw = v2
            tensors[name] = np.frombuffer(raw, np.float32).reshape(dims)
        elif field == 1:  # node
            op, ins, outs = None, [], []
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    ins.append(v2.decode())
                elif f2 == 2:
                    outs.append(v2.decode())
                elif f2 == 4:
                    op = v2.decode()
            nodes.append((op, ins, outs))
        elif field in io_names:
            for f2, _, v2 in _iter_fields(v):
                if f2 == 1:
                    io_names[field] = v2.decode()

    layers = []
    activation = "linear"
    for op, ins, outs in nodes:
        if op == "Gemm":
            W = tensors[ins[1]].T  # transB=1 storage back to (in, out)
            b = tensors[ins[2]]
            layers.append((W, b))
        elif op in ("Elu", "Relu", "Tanh", "Selu"):
            activation = op.lower()
    return layers, activation, io_names[11], io_names[12], opset
