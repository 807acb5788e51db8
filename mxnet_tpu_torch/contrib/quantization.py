"""INT8 quantization (counterpart of ``mxnet_tpu/contrib/quantization.py``).

``quantize_net`` is the Gluon API: calibrate a HybridBlock's Dense inputs,
then swap each Dense child for an int8 twin that quantizes its input, runs
``quantized_fully_connected`` (int32 accumulation; the int8 tensor cores
on the card) and dequantizes the result. Unmatched layers stay f32.

``quantize_model`` is the symbolic entry point: a graph rewrite that
replaces each calibrated FullyConnected/Convolution with the explicit
quantize_v2 -> int8 op -> dequantize node trio and int8 weight params.
``quantize_graph`` is the same rewrite without a calibration dataset.

Naive calibration takes each quantized layer's input min and max on the
device and reads two floats per layer and batch (the reference copies the
whole input to the host); min and max are exact, so the ranges are the
same.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_model", "quantize_net", "quantize_graph",
           "SUPPORTED_CALIB_MODES"]

# One list of calibration modes for every entry point. 'entropy' (KL
# threshold search, the reference's recommended calibration) is recognized
# and unimplemented: it raises NotImplementedError naming the gap, not a
# ValueError, so a caller can tell a typo from a missing feature.
SUPPORTED_CALIB_MODES = ("none", "naive")


def _check_calib_mode(calib_mode):
    """The calib_mode check every quantization entry point shares."""
    if calib_mode in SUPPORTED_CALIB_MODES:
        return
    if calib_mode == "entropy":
        raise NotImplementedError(
            "calib_mode='entropy' (KL threshold search, the reference's "
            "recommended calibration) is not implemented yet — tracked as "
            f"ROADMAP item 5. Supported modes: {SUPPORTED_CALIB_MODES}")
    raise ValueError(
        f"calib_mode {calib_mode!r} is not supported; choose one of "
        f"{SUPPORTED_CALIB_MODES} ('entropy' is recognized but "
        "unimplemented — ROADMAP item 5)")


def _minmax(tensors):
    """[(min, max)] of each tensor: reduced on its device, one host read."""
    if not tensors:
        return []
    both = torch.stack([torch.stack([t.min(), t.max()]).float()
                        for t in tensors])
    return [tuple(r) for r in both.tolist()]


def _widen(ranges, name, lo, hi):
    old = ranges.get(name)
    if old is None:
        ranges[name] = [lo, hi]
    else:
        old[0] = min(old[0], lo)
        old[1] = max(old[1], hi)


def _collect_ranges(net, calib_data, num_calib_batches=None):
    """Naive calibration: run forwards, record each Dense input's min and
    max."""
    from .. import autograd
    from ..gluon import nn
    from ..ndarray import NDArray

    ranges = {}
    installed = []  # (block, hook) pairs to remove

    def make_hook(blk):
        def pre_hook(b, inputs):
            x = inputs[0]
            if isinstance(x, NDArray):
                (lo, hi), = _minmax([x._data])
                _widen(ranges, b.name, lo, hi)
        return pre_hook

    def walk(b):
        if isinstance(b, nn.Dense):
            h = make_hook(b)
            b.register_forward_pre_hook(h)
            installed.append((b, h))
        for c in b._children.values():
            walk(c)

    walk(net)
    try:
        with autograd.pause():
            n = 0
            for batch in calib_data:
                xs = batch.data if hasattr(batch, "data") else [batch]
                net(*(xs if isinstance(xs, (list, tuple)) else [xs]))
                n += 1
                if num_calib_batches is not None and n >= num_calib_batches:
                    break
    finally:
        for b, h in installed:
            b._forward_pre_hooks.remove(h)
    return ranges


class _QuantizedDense:
    """Callable twin of a calibrated Dense: int8 input and weights, int32
    accumulation. ``in_range=None`` (calib_mode='none') quantizes the input
    against its own min and max each call (the reference's online
    mode)."""

    def __init__(self, dense, in_range):
        from ..ndarray import array

        wdata = dense.weight.data()
        w = wdata.asnumpy()
        self._w_max = float(np.abs(w).max()) or 1.0
        scale = 127.0 / self._w_max
        self._wq = array(np.clip(np.round(w * scale), -127, 127)
                         .astype(np.int8), ctx=wdata.context)
        self._bias = (dense.bias.data()
                      if getattr(dense, "bias", None) is not None
                      and dense.bias._data is not None else None)
        self._in_range = in_range
        self._flatten = getattr(dense, "_flatten", True)
        self._act = getattr(dense, "_act", None)
        self.name = dense.name

    def __call__(self, x):
        from ..ndarray.ndarray import invoke_fn
        from ..ops.registry import get_op

        rng = self._in_range
        w_max, flatten, act = self._w_max, self._flatten, self._act

        def pure(xd, wq, *maybe_bias):
            if rng is not None:
                qx, mn_d, mx_d = get_op("_contrib_quantize_v2").fn(
                    xd, min_calib_range=rng[0], max_calib_range=rng[1])
            else:  # online min/max
                qx, mn_d, mx_d = get_op("_contrib_quantize_v2").fn(xd)
            mn_w = torch.tensor([-w_max], dtype=torch.float32,
                                device=xd.device)
            mx_w = torch.tensor([w_max], dtype=torch.float32,
                                device=xd.device)
            acc, mn_o, mx_o = get_op("_contrib_quantized_fully_connected").fn(
                qx, wq, None, mn_d, mx_d, mn_w, mx_w, no_bias=True,
                flatten=flatten)
            out = get_op("_contrib_dequantize").fn(acc, mn_o, mx_o)
            if maybe_bias:
                out = out + maybe_bias[0]
            if act is not None:
                out = get_op("Activation").fn(out, act_type=act)
            return out

        ins = [x, self._wq] + ([self._bias] if self._bias is not None else [])
        return invoke_fn(pure, ins)


class _CallableBlockShim:
    """Block-like wrapper that puts a _QuantizedDense in the child
    traversal. Keeps the ORIGINAL Dense for everything but the forward:
    checkpoints still save and load the f32 weights (a fresh unquantized
    net can load them), hooks install on the original, parameters walk
    through it."""

    def __init__(self, q, original):
        self._q = q
        self._orig = original
        self.name = q.name + "_int8"
        self._children = {}
        self._reg_params = original._reg_params
        self._forward_hooks = original._forward_hooks
        self._forward_pre_hooks = original._forward_pre_hooks

    def __call__(self, x):
        for h in self._forward_pre_hooks:
            h(self, (x,))
        out = self._q(x)
        for h in self._forward_hooks:
            h(self, (x,), out)
        return out

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)

    def hybridize(self, *a, **kw):
        pass

    def _iter_params(self):
        return self._orig._iter_params()

    def _cast_hook(self, dtype):
        pass

    def _collect_params_with_prefix(self, prefix=""):
        return self._orig._collect_params_with_prefix(prefix)


def quantize_net(network, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", num_calib_batches=None,
                 exclude_layers=None, **kwargs):
    """Quantize ``network``'s calibrated Dense layers to int8 in place and
    return it; ``network._quantized_layers`` lists what was swapped."""
    if quantized_dtype not in ("int8", "auto"):
        raise ValueError(f"quantized_dtype {quantized_dtype!r} not supported")
    _check_calib_mode(calib_mode)
    if calib_mode == "naive":
        if calib_data is None:
            raise ValueError("calib_mode='naive' needs calib_data")
        ranges = _collect_ranges(network, calib_data, num_calib_batches)
    else:
        ranges = {}
    exclude = set(exclude_layers or ())

    from ..gluon import nn

    replaced = []
    online = calib_mode == "none"

    def quantizable(c):
        return (isinstance(c, nn.Dense) and c.name not in exclude
                and (online or c.name in ranges))

    def walk(b):
        for attr, c in list(b._children.items()):
            if quantizable(c):
                rng = None if online else tuple(ranges[c.name])
                shim = _CallableBlockShim(_QuantizedDense(c, rng), c)
                replaced.append(c.name)
                b._children[attr] = shim
            else:
                walk(c)

    if quantizable(network):  # the net IS a single Dense: return its shim
        rng = None if online else tuple(ranges[network.name])
        shim = _CallableBlockShim(_QuantizedDense(network, rng), network)
        shim._quantized_layers = [network.name]
        return shim
    walk(network)
    if not replaced:
        import warnings

        warnings.warn(
            "quantize_net: no Dense layer was quantized — with "
            "calib_mode='naive' this usually means calibration saw no "
            "forwards of the Dense layers (calib_data was empty, or every "
            "Dense was excluded)")
    network._quantized_layers = sorted(replaced)
    return network


def _quantize_param(arr, name, qparams):
    """f32 param -> int8 twin and its min/max range params (a symmetric
    grid). Returns the three new param names."""
    from ..ndarray import NDArray, array

    a = arr.asnumpy() if hasattr(arr, "asnumpy") else np.asarray(arr)
    ctx = arr.context if isinstance(arr, NDArray) else None
    m = float(np.abs(a).max()) or 1.0
    qparams[name + "_quantize"] = array(
        np.clip(np.round(a * (127.0 / m)), -127, 127).astype(np.int8),
        ctx=ctx)
    qparams[name + "_min"] = array(np.array([-m], np.float32), ctx=ctx)
    qparams[name + "_max"] = array(np.array([m], np.float32), ctx=ctx)
    return name + "_quantize", name + "_min", name + "_max"


def _rewrite_quantized(sym, arg_params, excluded, ranges, online):
    """Graph rewrite: each quantizable FC/Conv node becomes the explicit
    quantize_v2 -> int8 op -> dequantize chain. Returns (new_sym,
    qarg_params)."""
    from .. import symbol as S
    from ..symbol.symbol import Symbol

    qarg = dict(arg_params)
    base = sym._base() if sym._op != "_group" else sym
    topo = base._topo()
    memo = {}
    # tied weights: quantized once, the int8 twin reused by every consumer;
    # the f32 original goes only if no unquantized node still needs it
    qweight_cache = {}
    consumed = set()

    def remap(inp):
        new_b = memo[id(inp._base())]
        if inp._index is not None:
            return new_b[inp._index]
        return new_b

    def quantizable(node):
        if node._op not in ("FullyConnected", "Convolution"):
            return False
        if node._name in excluded:
            return False
        if not online and node._name not in ranges:
            return False
        wvar = node._inputs[1]._base()
        return wvar._op is None and wvar._name in arg_params

    for node in topo:
        if node._op is None:
            memo[id(node)] = node
            continue
        new_ins = [remap(i) for i in node._inputs]
        if quantizable(node):
            a = node._attrs
            nm = node._name
            no_bias = str(a.get("no_bias", False)).lower() in ("1", "true")
            wname = node._inputs[1]._base()._name
            if wname in qweight_cache:
                wq, wmin, wmax = qweight_cache[wname]
            else:
                wq, wmin, wmax = _quantize_param(arg_params[wname], wname,
                                                 qarg)
                qweight_cache[wname] = (wq, wmin, wmax)
            consumed.add(wname)
            if online:
                dq = S._contrib_quantize_v2(new_ins[0], name=nm + "_quantize")
            else:
                lo, hi = ranges[nm]
                dq = S._contrib_quantize_v2(
                    new_ins[0], min_calib_range=float(lo),
                    max_calib_range=float(hi), name=nm + "_quantize")
            # the int8 op runs without bias; the f32 bias (full precision,
            # nearer the int32 accumulator's exactness than an int8 bias
            # grid) is added after dequantize
            q_ins = [dq[0], S.Variable(wq), S.zeros((1,)),
                     dq[1], dq[2], S.Variable(wmin), S.Variable(wmax)]
            q_kwargs = {"no_bias": True}
            if node._op == "FullyConnected":
                qop = S._contrib_quantized_fully_connected
                q_kwargs["num_hidden"] = int(a.get("num_hidden", 1))
                q_kwargs["flatten"] = str(a.get("flatten", True)).lower() \
                    not in ("0", "false")
            else:
                qop = S._contrib_quantized_conv
                for key in ("kernel", "stride", "pad", "dilate"):
                    if key in a:
                        q_kwargs[key] = a[key]
                q_kwargs["num_filter"] = int(a.get("num_filter", 1))
                q_kwargs["num_group"] = int(a.get("num_group", 1))
            qnode = qop(*q_ins, name=nm + "_int8", **q_kwargs)
            deq = S._contrib_dequantize(qnode[0], qnode[1], qnode[2],
                                        name=nm + "_dequantize")
            if not no_bias and len(node._inputs) > 2:
                bias_sym = new_ins[2]
                if node._op == "Convolution":
                    bias_sym = S.reshape(bias_sym, shape=(1, -1, 1, 1),
                                         name=nm + "_bias_r")
                deq = S.broadcast_add(deq, bias_sym, name=nm + "_addbias")
            memo[id(node)] = deq._base()
        else:
            memo[id(node)] = Symbol(node._op, node._name, new_ins,
                                    node._attrs)
    out = memo[id(base)]
    if sym._index is not None:
        out = out[sym._index]
    # drop the quantized f32 originals unless an unquantized node still
    # reads them (a tied weight feeding an excluded layer)
    still_needed = set(out.list_arguments())
    for wname in consumed:
        if wname not in still_needed:
            qarg.pop(wname, None)
    return out, qarg


def _calibrate_ranges(sym, arg_params, aux_params, calib_data, data_names,
                      label_names, num_calib_examples, excluded, ctx=None):
    """Naive calibration: min and max of every quantizable node's data
    input, from a Group of those inputs evaluated over calib_data."""
    from .. import symbol as S_mod

    base = sym._base() if sym._op != "_group" else sym
    nodes = [n for n in base._topo()
             if n._op in ("FullyConnected", "Convolution")
             and n._name not in excluded]
    if not nodes:
        return {}
    group = S_mod.Group([n._inputs[0] for n in nodes])
    ranges = {}
    seen = 0
    execs = {}  # data-shape signature -> bound executor
    for batch in calib_data:
        xs = batch.data if hasattr(batch, "data") else [batch]
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        feed = dict(zip(data_names, xs))
        feed.update(arg_params)
        feed.update(aux_params or {})
        # one bind PER DATA SHAPE: the steady batches share one executor
        # and a ragged last batch gets its own
        sig = tuple(tuple(x.shape) for x in xs)
        exe = execs.get(sig)
        if exe is None:
            exe = execs[sig] = group.simple_bind(
                ctx=ctx, grad_req="null",
                **{k: v.shape for k, v in feed.items()})
        outs = exe.forward(is_train=False, **feed)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        for n, (lo, hi) in zip(nodes, _minmax([o._data for o in outs])):
            _widen(ranges, n._name, lo, hi)
        seen += int(xs[0].shape[0])
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    return ranges


def quantize_model(sym, arg_params=None, aux_params=None,
                   data_names=("data",), label_names=("softmax_label",),
                   ctx=None, excluded_sym_names=None, calib_mode="none",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", **kwargs):
    """The symbolic INT8 entry point: rewrite ``sym`` so every calibrated
    FullyConnected/Convolution runs as the explicit quantize_v2 -> int8 op
    -> dequantize chain, with int8 weight params. Returns (qsym,
    qarg_params, aux_params).

    calib_mode: 'none' (online min/max per batch) or 'naive' (min/max over
    ``calib_data``, bound on ``ctx``: the current context by default).
    'entropy' (KL threshold search) is not implemented and raises.
    """
    if quantized_dtype not in ("int8", "auto"):
        raise ValueError(f"quantized_dtype {quantized_dtype!r} not supported")
    _check_calib_mode(calib_mode)
    arg_params = dict(arg_params or {})
    aux_params = dict(aux_params or {})
    excluded = set(excluded_sym_names or ())
    if isinstance(data_names, str):
        data_names = (data_names,)
    if calib_mode == "naive":
        if calib_data is None:
            raise ValueError("calib_mode='naive' needs calib_data")
        ranges = _calibrate_ranges(sym, arg_params, aux_params, calib_data,
                                   data_names, label_names,
                                   num_calib_examples, excluded, ctx=ctx)
    else:
        ranges = {}
    qsym, qarg = _rewrite_quantized(sym, arg_params, excluded, ranges,
                                    online=(calib_mode == "none"))
    return qsym, qarg, aux_params


def quantize_graph(sym, arg_params=None, aux_params=None, ctx=None,
                   excluded_sym_names=None, calib_mode="none",
                   quantized_dtype="int8", **kwargs):
    """quantize_graph: the same rewrite as quantize_model, honouring
    ``calib_mode`` ('naive' needs calib_data in kwargs; 'entropy'
    raises). Returns (qsym, qarg_params, aux_params, collector); the
    collector slot is None, as calibration runs through quantize_model's
    calib_data path."""
    qsym, qarg, aux = quantize_model(
        sym, arg_params, aux_params, ctx=ctx,
        excluded_sym_names=excluded_sym_names, calib_mode=calib_mode,
        quantized_dtype=quantized_dtype, **kwargs)
    return qsym, qarg, aux, None
