"""ONNX export of the transducer — no ``onnx`` package required.

The reference's CPU inference path exports its TransducerGRU to ONNX
(helen/modules/python/models/predict_cpu.py:224-239) so released models run
on any ONNX runtime. This is helen_tpu's exporter (helen_tpu/io/onnx_export.py)
for the port: it serializes a param tree (numpy arrays or tensors) to an
ONNX ModelProto with the reference's exact exported interface —

    inputs:  input_image  float32 [batch_size, seq, features]
             input_hidden float32 [batch_size, 2*gru_layers, hidden]
    outputs: output_pred  float32 [batch_size, seq, num_base_classes]
             output_rle   float32 [batch_size, seq, num_rle_classes]
             output_hidden float32 [batch_size, 2*gru_layers, hidden]

(raw logits + final decoder hidden, matching TransducerModel.py:61-81) —
so a file produced here drops into the reference's ONNX consumers.

The environment has neither the ``onnx`` package nor a protobuf runtime for
it, so the ModelProto bytes are written directly in protobuf wire format
(a ~60-line encoder; ONNX is an ordinary proto3 schema). For verification
the module also carries an independent decoder + numpy evaluator
(``run_onnx``): it parses the serialized bytes back (field numbers and wire
types are exercised by round-trip, not trusted) and executes the graph with
a from-the-spec ONNX GRU (gate order [z, r, h], ``linear_before_reset=1``)
— deliberately NOT sharing the exporter's [r, z, n] -> [z, r, n] weight
reshuffle, so a transcription error on either side breaks the parity tests
(tests/test_torch_onnx.py asserts equality with the port's forward, with
helen_tpu's exporter AND with the torch replica of the reference model).
:func:`export_onnx` checks itself against the port's ``forward`` in the
parity tier on the device the caller names: on a CUDA device that is the
window kernels.

Graph shape: one bidirectional ONNX GRU node per stacked layer (torch's
exporter lowers nn.GRU(num_layers=k) the same way), Transpose/Reshape
plumbing for the time-major <-> batch-major and (T, 2, B, H) -> (T, B, 2H)
layout moves, MatMul+Add heads. Opset 11.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format encoder (proto3; the subset ONNX needs)
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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _f_str(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


# ---------------------------------------------------------------------------
# ONNX message builders (field numbers from onnx.proto)
# ---------------------------------------------------------------------------

_FLOAT, _INT64 = 1, 7  # TensorProto.DataType
# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_INTS = 1, 2, 3, 7


def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        dt = _FLOAT
    elif arr.dtype == np.int64:
        dt = _INT64
    else:
        raise TypeError(f"unsupported initializer dtype {arr.dtype}")
    body = b"".join(_f_varint(1, int(d)) for d in arr.shape)
    body += _f_varint(2, dt)
    body += _f_str(8, name)
    body += _f_bytes(9, arr.tobytes())  # raw_data is always little-endian
    return body


def _attr(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, ints=8, type=20."""
    body = _f_str(1, name)
    if isinstance(value, str):
        body += _f_bytes(4, value.encode()) + _f_varint(20, _AT_STRING)
    elif isinstance(value, float):
        body += _f_float(2, value) + _f_varint(20, _AT_FLOAT)
    elif isinstance(value, (list, tuple)):
        body += b"".join(_f_varint(8, int(v)) for v in value)
        body += _f_varint(20, _AT_INTS)
    elif isinstance(value, int):
        body += _f_varint(3, value) + _f_varint(20, _AT_INT)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return body


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    body = b"".join(_f_str(1, i) for i in inputs)
    body += b"".join(_f_str(2, o) for o in outputs)
    if name:
        body += _f_str(3, name)
    body += _f_str(4, op)
    body += b"".join(_f_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return body


def _value_info(name: str, dims: Sequence) -> bytes:
    """ValueInfoProto{name=1, type=2}; TypeProto.tensor_type=1;
    Tensor{elem_type=1, shape=2}; TensorShapeProto.dim=1;
    Dimension{dim_value=1 | dim_param=2}. str dims become dim_param."""
    shape = b""
    for d in dims:
        dim = _f_str(2, d) if isinstance(d, str) else _f_varint(1, int(d))
        shape += _f_bytes(1, dim)
    tensor = _f_varint(1, _FLOAT) + _f_bytes(2, shape)
    return _f_str(1, name) + _f_bytes(2, _f_bytes(1, tensor))


def _graph(nodes: List[bytes], name: str, initializers: List[bytes],
           inputs: List[bytes], outputs: List[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    body = b"".join(_f_bytes(1, n) for n in nodes)
    body += _f_str(2, name)
    body += b"".join(_f_bytes(5, t) for t in initializers)
    body += b"".join(_f_bytes(11, i) for i in inputs)
    body += b"".join(_f_bytes(12, o) for o in outputs)
    return body


def _model(graph: bytes, opset: int = 11) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    graph=7, opset_import=8 (OperatorSetId{domain=1, version=2})."""
    from helen_tpu_torch.version import __version__

    body = _f_varint(1, 7)  # IR version 7 pairs with opset 11
    body += _f_str(2, "helen_tpu_torch")
    body += _f_str(3, __version__)
    body += _f_bytes(7, graph)
    body += _f_bytes(8, _f_varint(2, opset))  # default domain ""
    return body


# ---------------------------------------------------------------------------
# transducer -> ONNX graph
# ---------------------------------------------------------------------------


def _gru_dir_weights(dirp) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One direction's (W, R, B) rows in ONNX gate order [z, r, h].

    Our pytree keeps torch layout: w_ih (in, 3H), w_hh (H, 3H), gate blocks
    [r, z, n] on the 3H axis (models/gru.py). ONNX GRU wants W (3H, in) and
    R (3H, H) with blocks [z, r, h], and B = [Wb_z Wb_r Wb_h Rb_z Rb_r Rb_h].
    """
    w_ih = np.asarray(dirp["w_ih"], np.float32).T  # (3H, in)
    w_hh = np.asarray(dirp["w_hh"], np.float32).T  # (3H, H)
    b_ih = np.asarray(dirp["b_ih"], np.float32)
    b_hh = np.asarray(dirp["b_hh"], np.float32)
    h = w_hh.shape[1]
    reorder = lambda a: np.concatenate([a[h:2 * h], a[:h], a[2 * h:]], axis=0)
    bias = np.concatenate([reorder(b_ih), reorder(b_hh)])
    return reorder(w_ih), reorder(w_hh), bias


def build_onnx(params, seq_len: int = None) -> bytes:
    """Serialize a transducer params pytree to ONNX ModelProto bytes.

    seq_len defaults to the training/inference window length (the reference
    exports with a static window and a dynamic batch axis,
    predict_cpu.py:222-239); batch is the dynamic dim_param "batch_size".
    """
    from helen_tpu_torch.config import WINDOW
    from helen_tpu_torch.io.checkpoint import flatten_tree, unflatten_tree
    from helen_tpu_torch.models.transducer import _stack_layers, model_geometry

    params = unflatten_tree(flatten_tree(params))  # numpy leaves, from tensors too

    geom = model_geometry(params)
    T = int(seq_len) if seq_len else int(WINDOW.window)
    H, L, F = geom.hidden_size, geom.gru_layers, geom.input_features

    nodes: List[bytes] = []
    inits: List[bytes] = []

    def add_init(name: str, arr: np.ndarray) -> str:
        inits.append(_tensor(name, arr))
        return name

    nodes.append(_node("Transpose", ["input_image"], ["x_t"], perm=[1, 0, 2]))
    nodes.append(_node("Transpose", ["input_hidden"], ["h_t"], perm=[1, 0, 2]))

    def gru_stack(tag: str, cur: str, initial: List[str]) -> Tuple[str, List[str]]:
        """One bidirectional GRU node per stacked layer; returns the final
        (T, B, 2H) stream name and the per-layer Y_h names."""
        finals = []
        for li, lp in enumerate(_stack_layers(params[tag])):
            wf, rf, bf = _gru_dir_weights(lp["fwd"])
            wb, rb, bb = _gru_dir_weights(lp["bwd"])
            p = f"{tag}{li}"
            add_init(f"{p}_W", np.stack([wf, wb]))
            add_init(f"{p}_R", np.stack([rf, rb]))
            add_init(f"{p}_B", np.stack([bf, bb]))
            y, yh = f"{p}_Y", f"{p}_Yh"
            nodes.append(_node(
                "GRU",
                [cur, f"{p}_W", f"{p}_R", f"{p}_B", "", initial[li]],
                [y, yh], name=p,
                direction="bidirectional", hidden_size=H,
                linear_before_reset=1,
            ))
            # (T, 2, B, H) -> (T, B, 2, H) -> (T, B, 2H)
            nodes.append(_node("Transpose", [y], [f"{p}_Yt"], perm=[0, 2, 1, 3]))
            add_init(f"{p}_shape", np.asarray([0, -1, 2 * H], np.int64))
            nodes.append(_node("Reshape", [f"{p}_Yt", f"{p}_shape"], [f"{p}_out"]))
            cur, finals = f"{p}_out", finals + [yh]
        return cur, finals

    # per-layer slices of the (2L, B, H) hidden seed the encoder layers
    enc_init = []
    for li in range(L):
        add_init(f"hs{li}_starts", np.asarray([2 * li], np.int64))
        add_init(f"hs{li}_ends", np.asarray([2 * li + 2], np.int64))
        if li == 0:
            add_init("h_axes", np.asarray([0], np.int64))
        nodes.append(_node(
            "Slice", ["h_t", f"hs{li}_starts", f"hs{li}_ends", "h_axes"],
            [f"h_init{li}"],
        ))
        enc_init.append(f"h_init{li}")

    enc_out, enc_finals = gru_stack("encoder", "x_t", enc_init)
    dec_out, dec_finals = gru_stack("decoder", enc_out, enc_finals)

    if len(dec_finals) == 1:
        hidden_cat = dec_finals[0]
    else:
        hidden_cat = "dec_hidden_cat"
        nodes.append(_node("Concat", dec_finals, [hidden_cat], axis=0))
    nodes.append(_node("Transpose", [hidden_cat], ["output_hidden"],
                       perm=[1, 0, 2]))

    nodes.append(_node("Transpose", [dec_out], ["dec_bt"], perm=[1, 0, 2]))
    for head, out in (("base_head", "output_pred"), ("rle_head", "output_rle")):
        add_init(f"{head}_w", np.asarray(params[head]["w"], np.float32))
        add_init(f"{head}_b", np.asarray(params[head]["b"], np.float32))
        nodes.append(_node("MatMul", ["dec_bt", f"{head}_w"], [f"{head}_mm"]))
        nodes.append(_node("Add", [f"{head}_mm", f"{head}_b"], [out]))

    graph = _graph(
        nodes, "helen_transducer", inits,
        inputs=[
            _value_info("input_image", ["batch_size", T, F]),
            _value_info("input_hidden", ["batch_size", 2 * L, H]),
        ],
        outputs=[
            _value_info("output_pred", ["batch_size", T, geom.num_base_classes]),
            _value_info("output_rle", ["batch_size", T, geom.num_rle_classes]),
            _value_info("output_hidden", ["batch_size", 2 * L, H]),
        ],
    )
    return _model(graph)


def export_onnx(params, path: str, seq_len: int = None, verify: bool = True,
                device: str = "cuda") -> str:
    """Write ``params`` as an ONNX model; optionally verify the bytes by
    parsing them back and running one batch through the numpy evaluator
    against the port's ``forward`` on ``device`` in the parity tier
    (``"cuda"``, the default: the window kernels, raising where no GPU is
    visible; ``"cpu"``: their plain versions), atol 1e-4 (helen_tpu's
    bar). The batch is a uint8 image, as the kernels take it, and a random
    hidden state."""
    data = build_onnx(params, seq_len=seq_len)
    if verify:
        import torch

        from helen_tpu_torch.config import WINDOW
        from helen_tpu_torch.infer.consensus import resolve_device
        from helen_tpu_torch.io.checkpoint import flatten_tree, params_to_torch, unflatten_tree
        from helen_tpu_torch.models.transducer import (
            forward,
            model_geometry,
            resolve_backend,
            set_fp32_precision,
        )

        dev = resolve_device(device)
        set_fp32_precision()
        tp = params_to_torch(unflatten_tree(flatten_tree(params)), dev)
        geom = model_geometry(tp)
        T = int(seq_len) if seq_len else int(WINDOW.window)
        rng = np.random.default_rng(0)
        x = rng.integers(0, 40, (2, T, geom.input_features), dtype=np.uint8)
        hid = rng.standard_normal(
            (2, 2 * geom.gru_layers, geom.hidden_size)).astype(np.float32)
        got = run_onnx(data, {"input_image": x.astype(np.float32), "input_hidden": hid})
        with torch.no_grad():
            base, rle, hout = forward(tp, torch.from_numpy(x).to(dev),
                                      torch.from_numpy(hid).to(dev),
                                      resolve_backend("auto", dev, tp))
        for name, ours in (("output_pred", base), ("output_rle", rle),
                           ("output_hidden", hout)):
            err = float(np.max(np.abs(got[name] - ours.cpu().numpy())))
            if err > 1e-4:
                raise AssertionError(
                    f"ONNX verify failed: {name} max|diff|={err:.2e}")
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---------------------------------------------------------------------------
# independent decoder + numpy evaluator (verification / CPU interop check)
# ---------------------------------------------------------------------------


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples from a proto message."""
    i, n = 0, len(buf)
    while i < n:
        key = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims, dtype, raw, name = [], None, b"", ""
    for field, _, val in _iter_fields(buf):
        if field == 1:
            dims.append(val)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    np_dt = {_FLOAT: np.float32, _INT64: np.int64}[dtype]
    return name, np.frombuffer(raw, np_dt).reshape(dims).copy()


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    name, ints, out = "", [], None
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:
            out = struct.unpack("<f", val)[0]
        elif field == 3:
            out = val
        elif field == 4:
            out = val.decode()
        elif field == 8:
            ints.append(val)
    return name, (ints if ints else out)


def _parse_node(buf: bytes) -> Dict[str, Any]:
    node = {"inputs": [], "outputs": [], "op": "", "attrs": {}}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            node["inputs"].append(val.decode())
        elif field == 2:
            node["outputs"].append(val.decode())
        elif field == 4:
            node["op"] = val.decode()
        elif field == 5:
            k, v = _parse_attr(val)
            node["attrs"][k] = v
    return node


def parse_onnx(data: bytes) -> Dict[str, Any]:
    """Parse ModelProto bytes into {graph_inputs, outputs, nodes, inits}."""
    graph = None
    for field, _, val in _iter_fields(data):
        if field == 7:
            graph = val
    if graph is None:
        raise ValueError("no GraphProto in model bytes")
    nodes, inits, g_in, g_out = [], {}, [], []

    def vi_name(buf: bytes) -> str:
        for field, _, val in _iter_fields(buf):
            if field == 1:
                return val.decode()
        return ""

    for field, _, val in _iter_fields(graph):
        if field == 1:
            nodes.append(_parse_node(val))
        elif field == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif field == 11:
            g_in.append(vi_name(val))
        elif field == 12:
            g_out.append(vi_name(val))
    return {"nodes": nodes, "inits": inits, "inputs": g_in, "outputs": g_out}


def _onnx_gru(x, w, r, b, h0, hidden_size: int):
    """ONNX GRU, bidirectional, linear_before_reset=1, from the operator
    spec: gates [z, r, h]; zt=sig, rt=sig, ht=tanh(Xt Wh + Wbh + rt*(H R h +
    Rbh)); Ht = (1-zt)*ht + zt*H. Returns Y (T, 2, B, H), Y_h (2, B, H)."""
    T, B = x.shape[0], x.shape[1]
    H = hidden_size
    y = np.zeros((T, 2, B, H), np.float32)
    yh = np.zeros((2, B, H), np.float32)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    for d in range(2):
        wz, wr, wh = w[d, :H], w[d, H:2 * H], w[d, 2 * H:]
        rz, rr, rh = r[d, :H], r[d, H:2 * H], r[d, 2 * H:]
        wbz, wbr, wbh = b[d, :H], b[d, H:2 * H], b[d, 2 * H:3 * H]
        rbz, rbr, rbh = b[d, 3 * H:4 * H], b[d, 4 * H:5 * H], b[d, 5 * H:]
        h = h0[d].astype(np.float64)
        steps = range(T) if d == 0 else range(T - 1, -1, -1)
        for t in steps:
            xt = x[t].astype(np.float64)
            zt = sig(xt @ wz.T + wbz + h @ rz.T + rbz)
            rt = sig(xt @ wr.T + wbr + h @ rr.T + rbr)
            ht = np.tanh(xt @ wh.T + wbh + rt * (h @ rh.T + rbh))
            h = (1.0 - zt) * ht + zt * h
            y[t, d] = h.astype(np.float32)
        yh[d] = h.astype(np.float32)
    return y, yh


def run_onnx(data: bytes, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute parsed ONNX bytes with numpy (the ops build_onnx emits)."""
    model = parse_onnx(data)
    env: Dict[str, np.ndarray] = dict(model["inits"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    env[""] = None  # optional (omitted) inputs
    for node in model["nodes"]:
        op = node["op"]
        a = [env[i] for i in node["inputs"]]
        at = node["attrs"]
        if op == "Transpose":
            out = np.transpose(a[0], at["perm"])
        elif op == "Reshape":
            shape = [a[0].shape[i] if s == 0 else int(s)
                     for i, s in enumerate(a[1])]
            out = a[0].reshape(shape)
        elif op == "Slice":
            starts, ends, axes = a[1], a[2], a[3]
            idx = [slice(None)] * a[0].ndim
            for s, e, ax in zip(starts, ends, axes):
                idx[int(ax)] = slice(int(s), int(e))
            out = a[0][tuple(idx)]
        elif op == "Concat":
            out = np.concatenate(a, axis=int(at["axis"]))
        elif op == "MatMul":
            out = a[0] @ a[1]
        elif op == "Add":
            out = a[0] + a[1]
        elif op == "GRU":
            assert at["direction"] == "bidirectional"
            assert int(at["linear_before_reset"]) == 1
            y, yh = _onnx_gru(a[0], a[1], a[2], a[3], a[5],
                              int(at["hidden_size"]))
            env[node["outputs"][0]] = y
            env[node["outputs"][1]] = yh
            continue
        else:
            raise NotImplementedError(f"op {op}")
        env[node["outputs"][0]] = out
    return {name: env[name] for name in model["outputs"]}
