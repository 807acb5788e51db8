"""ONNX interop (counterpart of ``mxnet_tpu/contrib/onnx.py``): export of a
Symbol graph and its params to an ONNX file, and import of one, with no
``onnx`` package (``_onnx_proto`` writes and reads the wire format). The
files are byte-identical to the reference's for the same graph and params:
the same order of nodes, initializers and attributes, and little-endian
f32 ``raw_data`` from C-contiguous arrays. Covered surface:
- CNN/MLP: Conv, Gemm(+Flatten), BatchNormalization, activations,
  pooling (global too), Softmax/LogSoftmax, elementwise/broadcast
  arithmetic, Concat, Dropout, Reshape, Transpose, Sum, Clip, LeakyRelu,
  Identity, Tile, Slice, Squeeze/Unsqueeze.
- word_lm family: Embedding -> Cast + Gather, the fused RNN op (LSTM, GRU,
  vanilla; any num_layers, bidirectional) -> a chain of single-layer ONNX
  LSTM/GRU/RNN nodes with the cuDNN -> ONNX gate reorder, FC(flatten=False)
  -> Transpose + MatMul + Add.
- transformer family: dot/batch_dot -> MatMul (+Transpose), last-axis
  LayerNorm -> an opset-9 ReduceMean/Sub/Sqrt decomposition, erf-gelu ->
  an Erf decomposition, Exp/Log/Sqrt/Erf, Pow.
Opset 9, f32 tensors.
"""
from __future__ import annotations

import ast
from typing import Dict, List

import numpy as np

from . import _onnx_proto as P

__all__ = ["export_model", "import_model"]

# AttributeProto.type enum
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS, _AT_STRINGS = 6, 7, 8
_DT_FLOAT, _DT_INT64 = 1, 7


def _tuple(v, n=2):
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        v = (int(v),) * n
    return tuple(int(x) for x in v)


def _flag(v):
    return v in (True, 1, "1", "true", "True")


# --------------------------------------------------------------------------
# Attribute / tensor / node emitters
# --------------------------------------------------------------------------

def _attr_int(name, v):
    return P.field_message(5, P.field_string(1, name) + P.field_varint(3, v)
                           + P.field_varint(20, _AT_INT))


def _attr_float(name, v):
    return P.field_message(5, P.field_string(1, name)
                           + P.field_float(2, v) + P.field_varint(20, _AT_FLOAT))


def _attr_ints(name, vals):
    body = P.field_string(1, name)
    for v in vals:
        body += P.field_varint(8, v)
    return P.field_message(5, body + P.field_varint(20, _AT_INTS))


def _attr_str(name, s):
    return P.field_message(5, P.field_string(1, name) + P.field_string(4, s)
                           + P.field_varint(20, _AT_STRING))


def _tensor(name, arr):
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.int64:
        dt = _DT_INT64
    else:
        arr = arr.astype(np.float32)
        dt = _DT_FLOAT
    body = b""
    for d in arr.shape:
        body += P.field_varint(1, d)
    body += P.field_varint(2, dt)
    body += P.field_string(8, name)
    body += P.field_bytes(9, arr.tobytes())  # raw_data, little-endian
    return body


def _node(op_type, inputs, outputs, name, attrs=b""):
    body = b""
    for i in inputs:
        body += P.field_string(1, i)
    for o in outputs:
        body += P.field_string(2, o)
    body += P.field_string(3, name) + P.field_string(4, op_type) + attrs
    return P.field_message(1, body)  # GraphProto.node


def _value_info(name, shape, elem_type=_DT_FLOAT):
    dims = b""
    for d in shape:
        dims += P.field_message(1, P.field_varint(1, int(d)))
    ttype = P.field_varint(1, elem_type) + P.field_message(2, dims)
    return P.field_string(1, name) + P.field_message(2, P.field_message(1, ttype))


# --------------------------------------------------------------------------
# Export: mx Symbol graph -> ONNX GraphProto nodes
# --------------------------------------------------------------------------

_ACT_MAP = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
            "softrelu": "Softplus", "softsign": "Softsign"}
_ELEM_MAP = {"elemwise_add": "Add", "_plus": "Add", "broadcast_add": "Add",
             "elemwise_sub": "Sub", "_minus": "Sub", "broadcast_sub": "Sub",
             "elemwise_mul": "Mul", "_mul": "Mul", "broadcast_mul": "Mul",
             "elemwise_div": "Div", "_div": "Div", "broadcast_div": "Div"}


def _conv_attrs(a):
    kernel = _tuple(a.get("kernel", (1, 1)))
    stride = _tuple(a.get("stride", (1,) * len(kernel)), len(kernel))
    pad = _tuple(a.get("pad", (0,) * len(kernel)), len(kernel))
    dilate = _tuple(a.get("dilate", (1,) * len(kernel)), len(kernel))
    out = _attr_ints("kernel_shape", kernel) + _attr_ints("strides", stride)
    out += _attr_ints("pads", pad + pad) + _attr_ints("dilations", dilate)
    out += _attr_int("group", int(a.get("num_group", 1)))
    return out


# mx/cuDNN -> ONNX gate orders: LSTM [i,f,g,o]->[i,o,f,c], GRU
# [r,z,n]->[z,r,h] (both conventions use the cuDNN linear_before_reset
# recurrence our scan implements), vanilla: single gate.
_RNN_ONNX = {
    "lstm": ("LSTM", 4, (0, 3, 1, 2), (0, 2, 3, 1)),
    "gru": ("GRU", 3, (1, 0, 2), (1, 0, 2)),
    "rnn_tanh": ("RNN", 1, (0,), (0,)),
    "rnn_relu": ("RNN", 1, (0,), (0,)),
}


def _gate_reorder(mat, h, perm):
    """Permute stacked (g*h, ...) gate blocks between conventions."""
    blocks = [mat[i * h:(i + 1) * h] for i in range(len(perm))]
    return np.concatenate([blocks[j] for j in perm], axis=0)


def _export_node(node, in_names, out_name, params, extra_inits,
                 in_shapes=None):
    """Returns (onnx node bytes, handled: bool).

    in_shapes: per-input shapes when shape inference succeeded (None
    entries otherwise) — used for the opset-9 Softmax axis guard, RNN
    weight unpacking, and MatMul transpose perms.
    """
    op = node._op
    a = node._attrs
    nm = node._name
    in_rank = None
    if in_shapes and in_shapes[0] is not None:
        in_rank = len(in_shapes[0])
    if op == "Convolution":
        return _node("Conv", in_names, [out_name], nm, _conv_attrs(a)), True
    if op == "FullyConnected":
        flat_out = nm + "_flat"
        nodes = b""
        data_in = in_names[0]
        if not _flag(a.get("flatten", True)) and in_rank != 2:
            # ND input (e.g. the word_lm decoder over (T,N,H)): opset-9
            # Gemm is 2D-only, so emit Transpose(W) + MatMul (+ Add bias)
            wt = nm + "_wT"
            nodes += _node("Transpose", [in_names[1]], [wt], wt,
                           _attr_ints("perm", (1, 0)))
            mm = nm + "_mm" if len(in_names) > 2 else out_name
            nodes += _node("MatMul", [data_in, wt], [mm], nm + "_matmul")
            if len(in_names) > 2:
                nodes += _node("Add", [mm, in_names[2]], [out_name],
                               nm + "_bias")
            return nodes, True
        if _flag(a.get("flatten", True)):
            nodes += _node("Flatten", [in_names[0]], [flat_out],
                           nm + "_flatten", _attr_int("axis", 1))
            data_in = flat_out
        ins = [data_in] + in_names[1:]
        if len(ins) == 2:  # no_bias: opset-9 Gemm requires C — zeros
            zname = nm + "_zero_bias"
            num_hidden = int(a.get("num_hidden"))
            extra_inits.append((zname, np.zeros(num_hidden, np.float32)))
            ins.append(zname)
        nodes += _node("Gemm", ins, [out_name], nm, _attr_int("transB", 1))
        return nodes, True
    if op == "BatchNorm":
        # mxnet BatchNorm default eps is 1e-3 (ops/nn.py), not ONNX's 1e-5
        attrs = _attr_float("epsilon", float(a.get("eps", 1e-3)))
        attrs += _attr_float("momentum", float(a.get("momentum", 0.9)))
        return _node("BatchNormalization", in_names, [out_name], nm, attrs), True
    if op == "Activation":
        act = a.get("act_type", "relu")
        if act in _ACT_MAP:
            return _node(_ACT_MAP[act], in_names, [out_name], nm), True
        return b"", False
    if op in ("relu", "sigmoid", "tanh"):
        return _node(_ACT_MAP[op], in_names, [out_name], nm), True
    if op == "LeakyReLU":
        if a.get("act_type", "leaky") != "leaky":
            return b"", False
        return _node("LeakyRelu", in_names, [out_name], nm,
                     _attr_float("alpha", float(a.get("slope", 0.25)))), True
    if op == "Pooling":
        ptype = a.get("pool_type", "max")
        if _flag(a.get("global_pool", False)):
            op_t = "GlobalMaxPool" if ptype == "max" else "GlobalAveragePool"
            return _node(op_t, in_names, [out_name], nm), True
        kernel = _tuple(a.get("kernel", (1, 1)))
        # framework Pooling default stride is 1 (ops/nn.py), NOT kernel
        stride = _tuple(a.get("stride", (1,) * len(kernel)), len(kernel))
        pad = _tuple(a.get("pad", (0,) * len(kernel)), len(kernel))
        attrs = (_attr_ints("kernel_shape", kernel)
                 + _attr_ints("strides", stride)
                 + _attr_ints("pads", pad + pad))
        op_t = "MaxPool" if ptype == "max" else "AveragePool"
        if ptype == "avg":
            attrs += _attr_int(
                "count_include_pad",
                1 if _flag(a.get("count_include_pad", True)) else 0)
        return _node(op_t, in_names, [out_name], nm, attrs), True
    if op in ("softmax", "SoftmaxOutput", "SoftmaxActivation"):
        ins = in_names[:1]
        ax = int(a.get("axis", -1 if op == "softmax" else 1))
        # opset-9 Softmax coerces to 2D at `ax`: softmax over ALL trailing
        # dims, which equals mx single-axis softmax only when ax is the last
        # dim. Mirror the importer's guard — exporting anything else would
        # silently diverge on conformant runtimes (e.g. axis=1 on NCHW maps).
        last_ok = ax == -1 or (in_rank is not None and ax == in_rank - 1)
        if not last_ok:
            raise ValueError(
                f"mx2onnx: opset-9 Softmax with axis={ax} on a rank-"
                f"{in_rank if in_rank is not None else '?'} input uses "
                "coerce-to-2D semantics that diverge from single-axis "
                "softmax; only last-dim softmax exports faithfully")
        return _node("Softmax", ins, [out_name], nm, _attr_int("axis", ax)), True
    if op == "log_softmax":
        return _node("LogSoftmax", in_names, [out_name], nm,
                     _attr_int("axis", int(a.get("axis", -1)))), True
    if op in _ELEM_MAP:
        return _node(_ELEM_MAP[op], in_names, [out_name], nm), True
    if op == "Concat":
        ax = int(a.get("dim", a.get("axis", 1)))
        return _node("Concat", in_names, [out_name], nm,
                     _attr_int("axis", ax)), True
    if op == "Flatten":
        return _node("Flatten", in_names, [out_name], nm,
                     _attr_int("axis", 1)), True
    if op == "Dropout":
        return _node("Dropout", in_names[:1], [out_name], nm,
                     _attr_float("ratio", float(a.get("p", 0.5)))), True
    if op in ("Reshape", "reshape"):
        shape = _tuple(a.get("shape"), 1)
        sname = nm + "_shape"
        extra_inits.append((sname, np.asarray(shape, np.int64)))
        return _node("Reshape", [in_names[0], sname], [out_name], nm), True
    if op == "transpose":
        axes = a.get("axes", ())
        return _node("Transpose", in_names, [out_name], nm,
                     _attr_ints("perm", _tuple(axes, 1)) if axes else b""), True
    if op in ("add_n", "ElementWiseSum"):
        return _node("Sum", in_names, [out_name], nm), True
    if op == "mean" and not node._attrs.get("axis"):
        return b"", False
    if op == "clip":
        return _node("Clip", in_names, [out_name], nm,
                     _attr_float("min", float(a.get("a_min")))
                     + _attr_float("max", float(a.get("a_max")))), True
    if op == "identity":
        return _node("Identity", in_names, [out_name], nm), True
    if op == "Embedding":
        # mx Embedding takes float indices; ONNX Gather needs int64
        idx64 = nm + "_idx64"
        nodes = _node("Cast", [in_names[0]], [idx64], idx64,
                      _attr_int("to", 7))  # TensorProto.INT64
        nodes += _node("Gather", [in_names[1], idx64], [out_name], nm,
                       _attr_int("axis", 0))
        return nodes, True
    if op == "RNN":
        return _export_rnn(node, in_names, out_name, params, extra_inits,
                           in_shapes)
    if op in ("dot", "batch_dot"):
        ta = _flag(a.get("transpose_a", False))
        tb = _flag(a.get("transpose_b", False))
        nodes = b""
        names = list(in_names)
        for pos, t in ((0, ta), (1, tb)):
            if not t:
                continue
            shp = in_shapes[pos] if in_shapes else None
            rank = len(shp) if shp is not None else (2 if op == "dot" else 3)
            perm = tuple(range(rank - 2)) + (rank - 1, rank - 2)
            tnm = f"{nm}_in{pos}T"
            nodes += _node("Transpose", [names[pos]], [tnm], tnm,
                           _attr_ints("perm", perm))
            names[pos] = tnm
        nodes += _node("MatMul", names, [out_name], nm)
        return nodes, True
    if op == "LayerNorm":
        ax = int(a.get("axis", -1))
        rank = in_rank
        if not (ax == -1 or (rank is not None and ax == rank - 1)):
            raise ValueError(
                f"mx2onnx: LayerNorm axis={ax} export supports only the "
                "last axis (opset-9 decomposition reduces over -1)")
        eps_nm = nm + "_eps"
        extra_inits.append((eps_nm,
                            np.float32(a.get("eps", 1e-5)).reshape(())))
        x, g, b_ = in_names[0], in_names[1], in_names[2]
        # positive reduce axis when the rank is known — opset-9 Reduce ops
        # predate the negative-axes clarification
        red = [rank - 1] if rank is not None else [-1]
        n = lambda t: f"{nm}_{t}"  # noqa: E731
        nodes = _node("ReduceMean", [x], [n("m")], n("m"),
                      _attr_ints("axes", red) + _attr_int("keepdims", 1))
        nodes += _node("Sub", [x, n("m")], [n("d")], n("d"))
        nodes += _node("Mul", [n("d"), n("d")], [n("d2")], n("d2"))
        nodes += _node("ReduceMean", [n("d2")], [n("v")], n("v"),
                       _attr_ints("axes", red) + _attr_int("keepdims", 1))
        nodes += _node("Add", [n("v"), eps_nm], [n("ve")], n("ve"))
        nodes += _node("Sqrt", [n("ve")], [n("sd")], n("sd"))
        nodes += _node("Div", [n("d"), n("sd")], [n("q")], n("q"))
        nodes += _node("Mul", [n("q"), g], [n("sg")], n("sg"))
        nodes += _node("Add", [n("sg"), b_], [out_name], nm)
        return nodes, True
    if op == "gelu" and a.get("approximation", "erf") == "erf":
        # 0.5 * x * (1 + erf(x / sqrt(2))) — exact ops/elemwise.py form
        s2 = nm + "_sqrt2"
        half = nm + "_half"
        one = nm + "_one"
        extra_inits += [(s2, np.float32(1.4142135623730951).reshape(())),
                        (half, np.float32(0.5).reshape(())),
                        (one, np.float32(1.0).reshape(()))]
        x = in_names[0]
        n = lambda t: f"{nm}_{t}"  # noqa: E731
        nodes = _node("Div", [x, s2], [n("xs")], n("xs"))
        nodes += _node("Erf", [n("xs")], [n("e")], n("e"))
        nodes += _node("Add", [n("e"), one], [n("e1")], n("e1"))
        nodes += _node("Mul", [x, n("e1")], [n("xe")], n("xe"))
        nodes += _node("Mul", [n("xe"), half], [out_name], nm)
        return nodes, True
    if op in ("exp", "log", "sqrt", "erf"):
        return _node({"exp": "Exp", "log": "Log", "sqrt": "Sqrt",
                      "erf": "Erf"}[op], in_names, [out_name], nm), True
    if op == "squeeze":
        ax = a.get("axis")
        if ax is None:
            attrs = b""
        else:
            axes = [int(x) for x in _tuple(ax, 1)]
            if any(x < 0 for x in axes):
                if in_rank is None:
                    raise ValueError("mx2onnx: negative squeeze axis needs "
                                     "shape inference (opset-9 Squeeze "
                                     "requires non-negative axes)")
                axes = [x % in_rank for x in axes]
            attrs = _attr_ints("axes", axes)
        return _node("Squeeze", in_names, [out_name], nm, attrs), True
    if op == "expand_dims":
        ax = int(a.get("axis", 0))
        if ax < 0:
            if in_rank is None:
                raise ValueError("mx2onnx: negative expand_dims axis needs "
                                 "shape inference (opset-9 Unsqueeze "
                                 "requires non-negative axes)")
            ax %= in_rank + 1
        return _node("Unsqueeze", in_names, [out_name], nm,
                     _attr_ints("axes", [ax])), True
    if op == "tile":
        reps = _tuple(a.get("reps", a.get("repeats", ())), 1)
        rname = nm + "_reps"
        extra_inits.append((rname, np.asarray(reps, np.int64)))
        return _node("Tile", [in_names[0], rname], [out_name], nm), True
    if op == "slice_axis":
        ax = int(a.get("axis", 0))
        begin = int(a.get("begin", 0))
        end = a.get("end")
        end = 2 ** 31 - 1 if end in (None, "None") else int(end)
        return _node("Slice", in_names, [out_name], nm,
                     _attr_ints("axes", [ax]) + _attr_ints("starts", [begin])
                     + _attr_ints("ends", [end])), True
    return b"", False


def _attr_strs(name, vals):
    body = P.field_string(1, name)
    for v in vals:
        body += P.field_string(9, v)  # AttributeProto.strings = field 9
    return P.field_message(5, body + P.field_varint(20, _AT_STRINGS))


def _export_rnn(node, in_names, out_name, params, extra_inits, in_shapes):
    """mx fused RNN -> a chain of ONNX LSTM/GRU/RNN nodes, one per layer
    (the ONNX ops are single-layer). The cuDNN-canonical flat parameter
    vector (ops/rnn.py layout) unpacks into per-layer W/R/B with gate
    reorder; GRU exports linear_before_reset=1 (the cuDNN recurrence the
    scan implements). Dropout (`p`) is ignored — exported graphs are
    inference graphs, where it is inactive anyway."""
    a = node._attrs
    nm = node._name
    mode = a.get("mode", "rnn_tanh")
    onnx_op, g, perm, _ = _RNN_ONNX[mode]
    bidir = _flag(a.get("bidirectional", False))
    dirs = 2 if bidir else 1
    h = int(a.get("state_size"))
    L = int(a.get("num_layers", 1))
    pname = node._inputs[1]._base()._name
    pvec = params.get(pname)
    if pvec is None:
        raise ValueError(f"mx2onnx: RNN parameter vector {pname!r} must be "
                         "a stored parameter")
    if not in_shapes or in_shapes[0] is None:
        raise ValueError("mx2onnx: RNN export needs input shape inference")
    input_size = int(in_shapes[0][-1])
    pvec = np.asarray(pvec, np.float32).reshape(-1)
    # cuDNN-canonical layout: all (layer, direction) weights first, then
    # all biases in the same order (ops/rnn.py rnn_unpack_params)
    off = 0
    Ws, Rs, Bs = [], [], []
    for layer in range(L):
        isz = input_size if layer == 0 else h * dirs
        wd, rd = [], []
        for _d in range(dirs):
            wd.append(pvec[off:off + g * h * isz].reshape(g * h, isz))
            off += g * h * isz
            rd.append(pvec[off:off + g * h * h].reshape(g * h, h))
            off += g * h * h
        Ws.append(wd)
        Rs.append(rd)
    for layer in range(L):
        bd = []
        for _d in range(dirs):
            b_ih = pvec[off:off + g * h]
            off += g * h
            b_hh = pvec[off:off + g * h]
            off += g * h
            bd.append((b_ih, b_hh))
        Bs.append(bd)
    has_cell = mode == "lstm"
    attrs = _attr_int("hidden_size", h)
    if bidir:
        attrs += _attr_str("direction", "bidirectional")
    if mode == "gru":
        attrs += _attr_int("linear_before_reset", 1)
    elif mode == "rnn_relu":
        attrs += _attr_strs("activations", ["Relu"] * dirs)
    nodes = b""
    x_name = in_names[0]
    h0_name = in_names[2]
    c0_name = in_names[3] if has_cell and len(in_names) > 3 else None
    for layer in range(L):
        wn, rn, bn = (f"{nm}_W{layer}", f"{nm}_R{layer}", f"{nm}_B{layer}")
        extra_inits.append((wn, np.stack(
            [_gate_reorder(Ws[layer][d], h, perm) for d in range(dirs)])))
        extra_inits.append((rn, np.stack(
            [_gate_reorder(Rs[layer][d], h, perm) for d in range(dirs)])))
        extra_inits.append((bn, np.stack(
            [np.concatenate([_gate_reorder(Bs[layer][d][0], h, perm),
                             _gate_reorder(Bs[layer][d][1], h, perm)])
             for d in range(dirs)])))
        if L == 1:
            h0_l, c0_l = h0_name, c0_name
        else:
            sl = (_attr_ints("axes", [0])
                  + _attr_ints("starts", [layer * dirs])
                  + _attr_ints("ends", [(layer + 1) * dirs]))
            h0_l = f"{nm}_h0_{layer}"
            nodes += _node("Slice", [h0_name], [h0_l], h0_l, sl)
            c0_l = None
            if has_cell:
                c0_l = f"{nm}_c0_{layer}"
                nodes += _node("Slice", [c0_name], [c0_l], c0_l, sl)
        y4 = f"{nm}_l{layer}_y4"
        rnn_ins = [x_name, wn, rn, bn, "", h0_l]
        if has_cell:
            rnn_ins.append(c0_l)
        nodes += _node(onnx_op, rnn_ins, [y4], f"{nm}_l{layer}", attrs)
        y3 = out_name if layer == L - 1 else f"{nm}_l{layer}_y"
        if bidir:
            # ONNX Y (T, 2, N, h) -> mx (T, N, 2h): swap dir/batch axes,
            # then merge the direction axis into the feature dim
            yt = f"{nm}_l{layer}_yt"
            nodes += _node("Transpose", [y4], [yt], yt,
                           _attr_ints("perm", (0, 2, 1, 3)))
            shp = f"{nm}_l{layer}_yshape"
            extra_inits.append((shp, np.asarray([0, 0, 2 * h], np.int64)))
            nodes += _node("Reshape", [yt, shp], [y3], y3 + "_rs")
        else:
            # ONNX Y is (T, num_dir, N, h); drop the direction axis
            nodes += _node("Squeeze", [y4], [y3], y3 + "_sq",
                           _attr_ints("axes", [1]))
        x_name = y3
    return nodes, True


def export_model(sym, params, input_shape, input_type=None,
                 onnx_file_path="model.onnx", verbose=False, **kwargs):
    """Export a symbol + params to an ONNX file (reference mx2onnx API).

    input_shape: one shape tuple or a list of them (one per graph input).
    Returns onnx_file_path.
    """
    from ..ndarray import NDArray

    np_params = {}
    for k, v in dict(params or {}).items():
        k = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
        np_params[k] = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)

    base = sym._base() if hasattr(sym, "_base") else sym
    topo = base._topo()
    # fix_gamma BatchNorms ignore their stored gamma (it is forced to 1):
    # override BEFORE initializers serialize, or the stale values ship
    for node in topo:
        if node._op == "BatchNorm" and _flag(node._attrs.get("fix_gamma",
                                                             True)):
            gname = node._inputs[1]._base()._name
            if gname in np_params:
                np_params[gname] = np.ones_like(np_params[gname])
    shapes = ([tuple(input_shape)] if isinstance(input_shape[0], int)
              else [tuple(s) for s in input_shape])

    # Per-node shape inference (for rank-dependent export guards). Build the
    # known-shape map the same way the export loop assigns graph inputs:
    # params from np_params, data inputs from `shapes` in topo order.
    known = {}
    si = 0
    for node in topo:
        if node._op is not None:
            continue
        if node._name in np_params:
            known[node._name] = np_params[node._name].shape
        else:
            known[node._name] = shapes[min(si, len(shapes) - 1)]
            si += 1
    try:
        from ..symbol.symbol import infer_node_shapes
        node_shapes = infer_node_shapes(base, known)
    except Exception:
        node_shapes = {}

    # params consumed ONLY as RNN packed-parameter vectors are replaced by
    # the repacked per-layer W/R/B initializers — writing the flat vector
    # too would double the RNN weight bytes and leave a dead arg_param
    replaced_params = set()
    for node in topo:
        if node._op == "RNN" and len(node._inputs) > 1:
            replaced_params.add(node._inputs[1]._base()._name)
    for node in topo:
        for pos, i in enumerate(node._inputs):
            if node._op == "RNN" and pos == 1:
                continue
            replaced_params.discard(i._base()._name)

    out_of: Dict[int, str] = {}
    nodes = b""
    graph_inputs: List[bytes] = []
    inits = b""
    extra_inits: List = []
    shape_i = 0
    for node in topo:
        if node._op is None:
            out_of[id(node)] = node._name
            if node._name in np_params:
                if node._name not in replaced_params:
                    inits += P.field_message(5, _tensor(node._name,
                                                        np_params[node._name]))
            else:
                shp = shapes[min(shape_i, len(shapes) - 1)]
                shape_i += 1
                graph_inputs.append(P.field_message(
                    11, _value_info(node._name, shp)))
            continue
        for i in node._inputs:
            if i._index:
                raise ValueError(
                    f"mx2onnx: {node._op!r} consumes output {i._index} of a "
                    "multi-output node — not supported")
        in_names = [out_of[id(i._base())] for i in node._inputs]
        out_name = node._name + "_out"
        in_shapes = []
        for i in node._inputs:
            s = node_shapes.get(id(i._base()))
            if isinstance(s, list) and i._index is not None:
                s = s[i._index]
            in_shapes.append(s if isinstance(s, tuple) else None)
        nb, ok = _export_node(node, in_names, out_name, np_params,
                              extra_inits, in_shapes=in_shapes)
        if not ok:
            raise ValueError(f"mx2onnx: op {node._op!r} has no ONNX mapping; "
                             "supported set is the model-zoo CNN/MLP family")
        nodes += nb
        out_of[id(node)] = out_name
    for name, arr in extra_inits:
        inits += P.field_message(5, _tensor(name, arr))

    final = out_of[id(topo[-1])]
    graph = (nodes + P.field_string(2, "mxnet_tpu_export") + inits
             + b"".join(graph_inputs)
             + P.field_message(12, _value_info(final, ())))
    model = (P.field_varint(1, 7)                       # ir_version 7
             + P.field_string(2, "mxnet_tpu")
             + P.field_message(7, graph)
             + P.field_message(8, P.field_varint(2, 9)))  # opset 9
    with open(onnx_file_path, "wb") as f:
        f.write(model)
    if verbose:
        print(f"exported {len(topo)} nodes -> {onnx_file_path}")
    return onnx_file_path


# --------------------------------------------------------------------------
# Import: ONNX bytes -> mx Symbol + params
# --------------------------------------------------------------------------

def _parse_tensor(raw):
    f = P.parse_message(raw)
    dims = P.ints_of(f.get(1, []))
    dtype = f.get(2, [1])[0]
    name = P.string_of(f[8][0])
    if 9 in f:
        buf = f[9][0]
        arr = np.frombuffer(buf, np.float32 if dtype == _DT_FLOAT
                            else np.int64).reshape(dims)
    elif dtype == _DT_FLOAT and 4 in f:
        arr = np.array([P.float_of(x) for x in f[4]],
                       np.float32).reshape(dims)
    elif dtype == _DT_INT64 and 7 in f:
        arr = np.array(P.ints_of(f[7]), np.int64).reshape(dims)
    else:
        raise ValueError(f"unsupported TensorProto encoding for {name}")
    return name, arr


def _import_onnx_rnn(op, ins, outs, a, name, inits, sym_of, S):
    """ONNX LSTM/GRU/RNN node -> mx fused RNN symbol. W/R/B initializers
    repack (gate reorder + per-direction flatten) into the cuDNN-canonical
    vector ops/rnn.py unpacks; forward and bidirectional forms supported,
    Y (the per-step output) must be the consumed leg. GRU requires
    linear_before_reset=1 — the default-0 ONNX recurrence differs from the
    cuDNN variant the scan implements."""
    direction = a.get("direction", "forward")
    direction = (direction.decode() if isinstance(direction, bytes)
                 else str(direction))
    if direction not in ("forward", "bidirectional"):
        raise ValueError(f"onnx2mx: {op} direction={direction!r} "
                         "unsupported (forward|bidirectional)")
    bidir = direction == "bidirectional"
    if a.get("clip") is not None:
        raise ValueError(f"onnx2mx: {op} cell clipping unsupported")
    acts = [x.decode() if isinstance(x, bytes) else str(x)
            for x in (a.get("activations") or [])]
    n_dir = 2 if bidir else 1
    if op == "LSTM":
        # spec: the activations list repeats per direction
        if acts and acts != ["Sigmoid", "Tanh", "Tanh"] * n_dir:
            raise ValueError(f"onnx2mx: LSTM activations {acts} differ "
                             "from the fixed cuDNN recurrence")
        if len(ins) > 7 and ins[7]:
            raise ValueError("onnx2mx: LSTM peephole input P unsupported")
        mode = "lstm"
    elif op == "GRU":
        if not int(a.get("linear_before_reset", 0)):
            raise ValueError(
                "onnx2mx: GRU with linear_before_reset=0 uses a recurrence "
                "the cuDNN-convention scan cannot reproduce")
        if acts and acts != ["Sigmoid", "Tanh"] * n_dir:
            raise ValueError(f"onnx2mx: GRU activations {acts} differ "
                             "from the fixed cuDNN recurrence")
        mode = "gru"
    else:
        if acts and (acts[0] not in ("Tanh", "Relu")
                     or acts != [acts[0]] * len(acts)
                     or len(acts) not in (0, n_dir)):
            raise ValueError(f"onnx2mx: RNN activations {acts} unsupported "
                             "(both directions must share Tanh or Relu)")
        mode = "rnn_relu" if acts and acts[0] == "Relu" else "rnn_tanh"
    _, g, _, unperm_order = _RNN_ONNX[mode]
    if len(ins) > 4 and ins[4]:
        raise ValueError(f"onnx2mx: {op} sequence_lens input unsupported")
    for pos in (1, 2):
        if ins[pos] not in inits:
            raise ValueError(f"onnx2mx: {op} W/R must be initializers")
    h = int(a.get("hidden_size"))
    W = np.asarray(inits.pop(ins[1]), np.float32)
    R = np.asarray(inits.pop(ins[2]), np.float32)
    dirs = n_dir
    if W.shape[0] != dirs:
        raise ValueError(f"onnx2mx: {op} W num_directions {W.shape[0]} "
                         f"does not match direction={direction!r}")
    if len(ins) > 3 and ins[3]:
        if ins[3] not in inits:
            raise ValueError(f"onnx2mx: {op} B must be an initializer "
                             "(computed/graph-input biases unsupported)")
        B = np.asarray(inits.pop(ins[3]), np.float32)
    else:
        B = np.zeros((dirs, 2 * g * h), np.float32)

    def unperm(mat):
        return _gate_reorder(mat, h, unperm_order)

    # cuDNN-canonical: weights for every direction first, then biases
    parts = []
    for d in range(dirs):
        parts += [unperm(W[d]).reshape(-1), unperm(R[d]).reshape(-1)]
    for d in range(dirs):
        parts += [unperm(B[d][:g * h]), unperm(B[d][g * h:])]
    flat = np.concatenate(parts)
    pname = name + "_rnn_params"
    inits[pname] = flat

    def default_state():
        # spec default is zeros with the INPUT's batch dim — build it from
        # X so the shape stays symbolic: (1, N, 1) zeros tiled out
        t0 = S.slice_axis(sym_of(ins[0]), axis=0, begin=0, end=1)
        z = S.mean(t0, axis=-1, keepdims=True) * 0.0
        return S.tile(z, reps=(dirs, 1, h))

    h0 = (sym_of(ins[5]) if len(ins) > 5 and ins[5] else default_state())
    rnn_args = [sym_of(ins[0]), S.Variable(pname), h0]
    if mode == "lstm":
        rnn_args.append(sym_of(ins[6]) if len(ins) > 6 and ins[6]
                        else default_state())
    rnn = S.RNN(*rnn_args, state_size=h, num_layers=1, mode=mode,
                bidirectional=bidir, name=name)
    if not bidir:
        # ONNX Y is (T, num_dir=1, N, h): restore the direction axis the
        # mx RNN output (T, N, h) lacks so downstream Squeeze/Slice fit
        return S.expand_dims(rnn, axis=1, name=name + "_y4")
    # mx (T, N, 2h) -> ONNX Y (T, 2, N, h)
    r4 = S.reshape(rnn, shape=(0, 0, 2, h), name=name + "_split")
    return S.transpose(r4, axes=(0, 2, 1, 3), name=name + "_y4")


def _parse_attrs(node_fields):
    attrs = {}
    for raw in node_fields.get(5, []):
        f = P.parse_message(raw)
        name = P.string_of(f[1][0])
        if 3 in f:
            attrs[name] = P.ints_of(f[3])[0]
        elif 2 in f:
            attrs[name] = P.float_of(f[2][0])
        elif 8 in f:
            attrs[name] = P.ints_of(f[8])
        elif 9 in f:  # strings (e.g. RNN activations)
            attrs[name] = [P.string_of(x) for x in f[9]]
        elif 4 in f:
            attrs[name] = P.string_of(f[4][0])
        elif 5 in f:
            attrs[name] = _parse_tensor(f[5][0])[1]
    return attrs


def import_model(model_file):
    """ONNX file -> (sym, arg_params, aux_params) (reference onnx2mx API)."""
    from .. import symbol as sym_mod
    from ..ndarray import array

    with open(model_file, "rb") as f:
        model = P.parse_message(f.read())
    graph = P.parse_message(model[7][0])
    opset = 9
    for raw in model.get(8, []):  # opset_import (default domain)
        f8 = P.parse_message(raw)
        if 1 not in f8 or P.string_of(f8[1][0]) in ("", "ai.onnx"):
            opset = P.ints_of(f8.get(2, [9]))[0]

    inits = {}
    for raw in graph.get(5, []):
        name, arr = _parse_tensor(raw)
        inits[name] = arr

    tensors: Dict[str, object] = {}
    aux_names = set()
    for raw in graph.get(11, []):  # graph inputs
        name = P.string_of(P.parse_message(raw)[1][0])
        if name not in inits:
            tensors[name] = sym_mod.Variable(name)

    auto_vars = set()  # names sym_of materialized out of thin air

    def sym_of(name):
        if name not in tensors:
            tensors[name] = sym_mod.Variable(name)
            auto_vars.add(name)
        return tensors[name]

    # Initializers consumed as Clip bounds: read WITHOUT popping (exporters
    # dedupe constants — one min/max tensor may feed many Clip nodes, e.g.
    # every ReLU6 in a MobileNet). Count total input-uses per name so bound
    # tensors are stripped from params only when nothing else consumes them.
    use_count: Dict[str, int] = {}
    for raw in graph.get(1, []):
        for x in P.parse_message(raw).get(1, []):
            nm_u = P.string_of(x)
            use_count[nm_u] = use_count.get(nm_u, 0) + 1
    bound_uses: Dict[str, int] = {}

    pending_flatten: Dict[str, str] = {}  # flatten_out -> flatten_in
    for raw in graph.get(1, []):
        f = P.parse_message(raw)
        ins = [P.string_of(x) for x in f.get(1, [])]
        outs = [P.string_of(x) for x in f.get(2, [])]
        name = P.string_of(f[3][0]) if 3 in f else outs[0]
        op = P.string_of(f[4][0])
        a = _parse_attrs(f)
        S = sym_mod

        def two(key, default):
            v = a.get(key, default)
            return tuple(int(x) for x in v)

        if op == "Conv":
            k = two("kernel_shape", (1, 1))
            pads = a.get("pads", [0] * (2 * len(k)))
            if list(pads[:len(k)]) != list(pads[len(k):]):
                raise ValueError(
                    f"onnx2mx: asymmetric Conv pads {pads} are not "
                    "supported (mx Convolution pads symmetrically)")
            no_bias = len(ins) == 2
            args = dict(kernel=k, stride=two("strides", (1,) * len(k)),
                        pad=tuple(int(x) for x in pads[:len(k)]),
                        dilate=two("dilations", (1,) * len(k)),
                        num_group=int(a.get("group", 1)),
                        num_filter=int(inits[ins[1]].shape[0]),
                        no_bias=no_bias, name=name)
            syms = [sym_of(x) for x in ins]
            out = S.Convolution(*syms, **args)
        elif op == "Gemm":
            if (int(a.get("transB", 0)) != 1
                    or float(a.get("alpha", 1.0)) != 1.0
                    or float(a.get("beta", 1.0)) != 1.0):
                raise ValueError(
                    "onnx2mx: only Gemm(transB=1, alpha=1, beta=1) — the "
                    "FullyConnected layout — is supported")
            data_name = ins[0]
            flatten = data_name in pending_flatten
            if flatten:
                data_name = pending_flatten[ins[0]]
            w = inits[ins[1]]
            # only OUR exporter's synthetic placeholder marks no_bias — a
            # genuinely all-zero bias in a third-party model must survive
            zero_bias = (len(ins) > 2 and ins[2] in inits
                         and ins[2].endswith("_zero_bias")
                         and not inits[ins[2]].any())
            syms = [sym_of(data_name), sym_of(ins[1])]
            no_bias = zero_bias or len(ins) <= 2
            if not no_bias:
                syms.append(sym_of(ins[2]))
            elif len(ins) > 2:
                inits.pop(ins[2], None)
            out = S.FullyConnected(*syms, num_hidden=int(w.shape[0]),
                                   flatten=flatten, no_bias=no_bias,
                                   name=name)
        elif op == "Flatten":
            # fold Flatten+Gemm back into FC(flatten=True); standalone
            # Flatten emitted for any other consumer below
            pending_flatten[outs[0]] = ins[0]
            tensors[outs[0]] = S.Flatten(sym_of(ins[0]), name=name)
            continue
        elif op == "BatchNormalization":
            syms_bn = [sym_of(ins[0]), sym_of(ins[1]), sym_of(ins[2])]
            for aux in ins[3:5]:
                aux_names.add(aux)
                if aux not in tensors:
                    tensors[aux] = S.Variable(aux, __aux__=True)
                syms_bn.append(tensors[aux])
            out = S.BatchNorm(*syms_bn,
                              eps=float(a.get("epsilon", 1e-5)),
                              momentum=float(a.get("momentum", 0.9)),
                              fix_gamma=False, name=name)
        elif op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Softsign"):
            act = {v: k for k, v in _ACT_MAP.items()}[op]
            out = S.Activation(sym_of(ins[0]), act_type=act, name=name)
        elif op == "LeakyRelu":
            out = S.LeakyReLU(sym_of(ins[0]), act_type="leaky",
                              slope=float(a.get("alpha", 0.01)), name=name)
        elif op in ("MaxPool", "AveragePool", "GlobalMaxPool",
                    "GlobalAveragePool"):
            ptype = "max" if "Max" in op else "avg"
            if op.startswith("Global"):
                out = S.Pooling(sym_of(ins[0]), global_pool=True,
                                pool_type=ptype, kernel=(1, 1), name=name)
            else:
                k = two("kernel_shape", (1, 1))
                pads = a.get("pads", [0] * (2 * len(k)))
                if list(pads[:len(k)]) != list(pads[len(k):]):
                    raise ValueError(
                        f"onnx2mx: asymmetric pooling pads {pads} are not "
                        "supported (mx Pooling pads symmetrically)")
                out = S.Pooling(sym_of(ins[0]), kernel=k,
                                stride=two("strides", (1,) * len(k)),
                                pad=tuple(int(x) for x in pads[:len(k)]),
                                pool_type=ptype,
                                count_include_pad=bool(
                                    a.get("count_include_pad", 0)),
                                name=name)
        elif op in ("Softmax", "LogSoftmax"):
            # opset >= 13: single-axis semantics, default axis -1 (exact
            # match to mx softmax). opset < 13: coerce-to-2D semantics —
            # exactly equivalent to single-axis only when the axis is the
            # last dim; axis=1 (the old default) coincides for 2D inputs,
            # which is all our own exporter emits it for. Anything else
            # cannot be imported faithfully — fail loudly.
            ax = int(a.get("axis", -1 if opset >= 13 else 1))
            if opset < 13 and ax not in (-1, 1):
                raise ValueError(
                    f"onnx2mx: opset-{opset} {op} with axis={ax} uses "
                    "coerce-to-2D semantics that single-axis softmax "
                    "cannot reproduce")
            fn = S.softmax if op == "Softmax" else S.log_softmax
            out = fn(sym_of(ins[0]), axis=ax, name=name)
        elif op in ("Add", "Sub", "Mul", "Div"):
            fn = {"Add": S.broadcast_add, "Sub": S.broadcast_sub,
                  "Mul": S.broadcast_mul, "Div": S.broadcast_div}[op]
            out = fn(sym_of(ins[0]), sym_of(ins[1]), name=name)
        elif op == "Concat":
            out = S.Concat(*[sym_of(x) for x in ins],
                           dim=int(a.get("axis", 1)), name=name)
        elif op == "Dropout":
            out = S.Dropout(sym_of(ins[0]), p=float(a.get("ratio", 0.5)),
                            name=name)
        elif op == "Reshape":
            shape = tuple(int(x) for x in inits.pop(ins[1]))
            out = S.reshape(sym_of(ins[0]), shape=shape, name=name)
        elif op == "Transpose":
            perm = a.get("perm")
            out = S.transpose(sym_of(ins[0]),
                              axes=tuple(perm) if perm else None, name=name)
        elif op == "Sum":
            out = sym_of(ins[0])
            for extra in ins[1:]:
                out = S.broadcast_add(out, sym_of(extra))
        elif op == "Clip":
            # opset <= 6 passes bounds as attributes; opset >= 11 as
            # optional inputs 1-2 (must be initializers here — a dynamic
            # bound has no mx.clip counterpart, so fail loudly).
            lo, hi = a.get("min"), a.get("max")
            if len(ins) > 1:
                def _bound(nm_):
                    if not nm_:
                        return None
                    if nm_ in inits:
                        bound_uses[nm_] = bound_uses.get(nm_, 0) + 1
                        return float(np.asarray(inits[nm_]).reshape(()))
                    raise ValueError(
                        "onnx2mx: Clip min/max passed as non-initializer "
                        "inputs (dynamic bounds) — unsupported")
                lo = _bound(ins[1])
                hi = _bound(ins[2]) if len(ins) > 2 else None
            out = S.clip(sym_of(ins[0]),
                         a_min=float(lo) if lo is not None else -3e38,
                         a_max=float(hi) if hi is not None else 3e38,
                         name=name)
        elif op == "Identity":
            out = sym_of(ins[0])
        elif op == "Cast":
            to = int(a.get("to", 1))
            dt = {1: "float32", 6: "int32", 7: "int64", 10: "float16",
                  11: "float64", 16: "bfloat16"}.get(to)
            if dt is None:
                raise ValueError(f"onnx2mx: Cast to dtype enum {to} "
                                 "unsupported")
            out = S.Cast(sym_of(ins[0]), dtype=dt, name=name)
        elif op == "Gather":
            ax = int(a.get("axis", 0))
            out = S.take(sym_of(ins[0]), sym_of(ins[1]), axis=ax, name=name)
        elif op == "MatMul":
            # rank is unknown at import: a 2D initializer operand means the
            # projection form (dot); otherwise assume batched 3D matmul
            if ins[1] in inits and inits[ins[1]].ndim == 2:
                out = S.dot(sym_of(ins[0]), sym_of(ins[1]), name=name)
            elif ins[0] in inits and inits[ins[0]].ndim == 2:
                out = S.dot(sym_of(ins[0]), sym_of(ins[1]), name=name)
            else:
                out = S.batch_dot(sym_of(ins[0]), sym_of(ins[1]), name=name)
        elif op in ("LSTM", "GRU", "RNN"):
            out = _import_onnx_rnn(op, ins, outs, a, name, inits, sym_of, S)
            tensors[outs[0]] = out
            continue
        elif op == "Squeeze":
            axes = a.get("axes")
            out = S.squeeze(sym_of(ins[0]),
                            axis=(tuple(int(x) for x in axes)
                                  if axes is not None else None), name=name)
        elif op == "Unsqueeze":
            axes = tuple(int(x) for x in a.get("axes", (0,)))
            out = sym_of(ins[0])
            for ax in sorted(axes):
                out = S.expand_dims(out, axis=ax)
        elif op == "Slice":
            axes = [int(x) for x in a.get("axes", ())]
            starts = [int(x) for x in a.get("starts", ())]
            ends = [int(x) for x in a.get("ends", ())]
            if len(ins) > 1:
                raise ValueError("onnx2mx: opset-10+ Slice with bound "
                                 "inputs is unsupported (attrs only)")
            out = sym_of(ins[0])
            for ax, b0, e0 in zip(axes or range(len(starts)), starts, ends):
                out = S.slice_axis(out, axis=ax, begin=b0,
                                   end=None if e0 >= 2 ** 31 - 1 else e0)
        elif op == "ReduceMean":
            axes = a.get("axes")
            kd = bool(int(a.get("keepdims", 1)))
            out = S.mean(sym_of(ins[0]),
                         axis=(tuple(int(x) for x in axes)
                               if axes is not None else None),
                         keepdims=kd, name=name)
        elif op in ("Sqrt", "Exp", "Log", "Erf"):
            fn = {"Sqrt": S.sqrt, "Exp": S.exp, "Log": S.log,
                  "Erf": S.erf}[op]
            out = fn(sym_of(ins[0]), name=name)
        elif op == "Pow":
            out = S.broadcast_power(sym_of(ins[0]), sym_of(ins[1]),
                                    name=name)
        elif op == "Tile":
            if ins[1] not in inits:
                raise ValueError("onnx2mx: Tile repeats must be an "
                                 "initializer (dynamic repeats unsupported)")
            # read WITHOUT popping — exporters dedupe constants, one reps
            # tensor may feed several Tiles (same rule as Clip bounds)
            bound_uses[ins[1]] = bound_uses.get(ins[1], 0) + 1
            reps = tuple(int(x) for x in inits[ins[1]])
            out = S.tile(sym_of(ins[0]), reps=reps, name=name)
        else:
            raise ValueError(f"onnx2mx: unsupported ONNX op {op!r}")
        tensors[outs[0]] = out

    for nm_b, n_bound in bound_uses.items():  # bounds-only tensors: not params
        if use_count.get(nm_b, 0) <= n_bound:
            inits.pop(nm_b, None)

    # Fail loudly on dangling references: a node consuming a tensor that is
    # neither a graph input, an initializer, nor another node's output
    # (e.g. an unsupported multi-output leg like LSTM Y_h) would otherwise
    # silently import as a free Variable
    graph_input_names = {P.string_of(P.parse_message(r)[1][0])
                         for r in graph.get(11, [])}
    dangling = auto_vars - set(inits) - graph_input_names - aux_names
    if dangling:
        raise ValueError(
            f"onnx2mx: graph references undeclared tensors {sorted(dangling)}"
            " — likely an unsupported multi-output leg of an imported node")

    final_out = P.string_of(P.parse_message(graph[12][0])[1][0])
    sym = tensors[final_out]
    arg_params = {k: array(v) for k, v in inits.items()
                  if k not in aux_names}
    aux_params = {k: array(v) for k, v in inits.items() if k in aux_names}
    return sym, arg_params, aux_params
