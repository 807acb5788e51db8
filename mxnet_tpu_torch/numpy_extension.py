"""``mx.npx`` — the numpy-extension namespace (counterpart of
``mxnet_tpu/numpy_extension.py``).

The nn/operator surface for numpy-mode code — ``npx.relu``,
``npx.batch_norm``, ``npx.convolution`` ... with the reference's
signatures, computing through the registered op library on the autograd
tape — plus the ``set_np``/``use_np`` mode switches and context
re-exports. Any other registered op resolves by name.
"""
from __future__ import annotations

import torch

from .context import cpu, current_context, gpu  # noqa: F401
from .ndarray import NDArray, invoke, load, save, waitall  # noqa: F401
from .ndarray.ndarray import invoke_fn
from .ops import get_op, has_op

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape", "use_np",
           "use_np_array", "use_np_shape", "relu", "sigmoid", "softmax",
           "log_softmax", "masked_softmax", "masked_log_softmax", "gelu",
           "leaky_relu", "activation", "batch_norm", "layer_norm",
           "group_norm", "instance_norm", "l2_normalization",
           "fully_connected", "convolution", "deconvolution", "pooling",
           "dropout", "embedding", "rnn", "one_hot", "pick", "topk",
           "sequence_mask", "arange_like", "broadcast_like", "gather_nd",
           "scatter_nd", "shape_array", "reshape_like", "slice",
           "smooth_l1", "ctc_loss", "multibox_prior", "multibox_target",
           "multibox_detection", "box_nms", "roi_align", "cpu", "gpu",
           "current_context", "num_gpus", "load", "save", "waitall"]


def num_gpus() -> int:
    """The number of CUDA devices."""
    return torch.cuda.device_count()


_np_mode = {"array": False, "shape": False}


def set_np(shape=True, array=True, dtype=False):
    """Enable numpy semantics globally (reference npx.set_np)."""
    _np_mode["array"] = array
    _np_mode["shape"] = shape


def reset_np():
    _np_mode["array"] = False
    _np_mode["shape"] = False


def is_np_array():
    return _np_mode["array"]


def is_np_shape():
    return _np_mode["shape"]


def use_np(fn):
    """Decorator form (reference: activates np semantics for the callable;
    here np semantics are always available, so this is identity)."""
    return fn


use_np_array = use_np
use_np_shape = use_np


def _call(op_name, tensors, kwargs):
    return invoke(get_op(op_name), list(tensors), kwargs)


# --- activations ----------------------------------------------------------

def relu(data):
    return _call("relu", [data], {})


def sigmoid(data):
    return _call("sigmoid", [data], {})


def gelu(data, approximation="erf"):
    return _call("gelu", [data], {"approximation": approximation})


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25, **kw):
    ins = [data] + ([gamma] if gamma is not None else [])
    return _call("LeakyReLU", ins, {"act_type": act_type, "slope": slope})


def activation(data, act_type="relu"):
    return _call("Activation", [data], {"act_type": act_type})


def softmax(data, length=None, axis=-1, temperature=None, use_length=False):
    kw = {"axis": axis}
    if temperature is not None:
        kw["temperature"] = temperature
    if use_length and length is not None:
        kw["use_length"] = True
        return _call("softmax", [data, length], kw)
    return _call("softmax", [data], kw)


def log_softmax(data, axis=-1, temperature=None):
    kw = {"axis": axis}
    if temperature is not None:
        kw["temperature"] = temperature
    return _call("log_softmax", [data], kw)


def masked_softmax(data, mask=None, axis=-1, temperature=1.0):
    if mask is None:
        return softmax(data, axis=axis)

    def pure(d, m):
        keep = m.to(torch.bool)
        s = torch.where(keep, d / temperature,
                        torch.tensor(-1e30, dtype=d.dtype, device=d.device))
        out = torch.exp(s - torch.amax(s, dim=axis, keepdim=True))
        out = out * m.to(out.dtype)
        denom = torch.sum(out, dim=axis, keepdim=True)
        return out / torch.clamp(denom, min=1e-30)

    return invoke_fn(pure, [data, mask])


def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0):
    if mask is None:
        return log_softmax(data, axis=axis)

    def pure(d, m):
        keep = m.to(torch.bool)
        neg = torch.tensor(-1e30, dtype=d.dtype, device=d.device)
        s = torch.where(keep, d / temperature, neg)
        mx = torch.amax(s, dim=axis, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(s - mx), dim=axis,
                                  keepdim=True)) + mx
        return torch.where(keep, s - lse, neg)

    return invoke_fn(pure, [data, mask])


# --- normalization --------------------------------------------------------

def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1):
    return _call("BatchNorm", [x, gamma, beta, running_mean, running_var],
                 {"eps": eps, "momentum": momentum, "fix_gamma": fix_gamma,
                  "use_global_stats": use_global_stats,
                  "output_mean_var": output_mean_var, "axis": axis})


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return _call("LayerNorm", [data, gamma, beta],
                 {"axis": axis, "eps": eps})


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    return _call("GroupNorm", [data, gamma, beta],
                 {"num_groups": num_groups, "eps": eps})


def instance_norm(data, gamma, beta, eps=1e-3):
    return _call("InstanceNorm", [data, gamma, beta], {"eps": eps})


def l2_normalization(data, eps=1e-10, mode="instance"):
    return _call("L2Normalization", [data], {"eps": eps, "mode": mode})


# --- layers ---------------------------------------------------------------

def fully_connected(x, weight, bias=None, num_hidden=1, no_bias=False,
                    flatten=True):
    ins = [x, weight] + ([] if bias is None else [bias])
    return _call("FullyConnected", ins,
                 {"num_hidden": num_hidden, "no_bias": no_bias or bias is None,
                  "flatten": flatten})


def convolution(data=None, weight=None, bias=None, kernel=(1, 1),
                stride=(1, 1), dilate=(1, 1), pad=(0, 0), num_filter=1,
                num_group=1, no_bias=False, layout="NCHW", **kw):
    ins = [data, weight] + ([] if bias is None else [bias])
    return _call("Convolution", ins,
                 {"kernel": kernel, "stride": stride, "dilate": dilate,
                  "pad": pad, "num_filter": num_filter,
                  "num_group": num_group,
                  "no_bias": no_bias or bias is None, "layout": layout})


def deconvolution(data=None, weight=None, bias=None, **kw):
    ins = [data, weight] + ([] if bias is None else [bias])
    if bias is None:
        kw["no_bias"] = True
    return _call("Deconvolution", ins, kw)


def pooling(data, kernel=(1, 1), stride=None, pad=None, pool_type="max",
            global_pool=False, **kw):
    kwargs = {"kernel": kernel, "pool_type": pool_type,
              "global_pool": global_pool}
    if stride is not None:
        kwargs["stride"] = stride
    if pad is not None:
        kwargs["pad"] = pad
    return _call("Pooling", [data], kwargs)


def dropout(data, p=0.5, mode="training", **kw):
    return _call("Dropout", [data], {"p": p, "mode": mode})


def embedding(data, weight, input_dim=1, output_dim=1, dtype="float32",
              sparse_grad=False):
    return _call("Embedding", [data, weight],
                 {"input_dim": input_dim, "output_dim": output_dim,
                  "dtype": dtype})


def rnn(data=None, parameters=None, state=None, state_cell=None, mode="lstm",
        state_size=1, num_layers=1, bidirectional=False, p=0.0,
        state_outputs=False, **kw):
    ins = [data, parameters, state] + ([state_cell]
                                       if state_cell is not None else [])
    return _call("RNN", ins,
                 {"mode": mode, "state_size": state_size,
                  "num_layers": num_layers, "bidirectional": bidirectional,
                  "p": p, "state_outputs": state_outputs, **kw})


# --- indexing / shape -----------------------------------------------------

def one_hot(data, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    return _call("one_hot", [data], {"depth": depth, "on_value": on_value,
                                     "off_value": off_value, "dtype": dtype})


def pick(data, index, axis=-1, mode="clip", keepdims=False):
    return _call("pick", [data, index],
                 {"axis": axis, "mode": mode, "keepdims": keepdims})


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    return _call("topk", [data], {"axis": axis, "k": k, "ret_typ": ret_typ,
                                  "is_ascend": is_ascend, "dtype": dtype})


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    ins = [data] + ([sequence_length] if sequence_length is not None else [])
    return _call("SequenceMask", ins,
                 {"use_sequence_length": use_sequence_length or
                  sequence_length is not None, "value": value, "axis": axis})


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    return _call("_contrib_arange_like", [data],
                 {"start": start, "step": step, "repeat": repeat,
                  "axis": axis})


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    return _call("broadcast_like", [lhs, rhs],
                 {"lhs_axes": lhs_axes, "rhs_axes": rhs_axes})


def gather_nd(data, indices):
    return _call("gather_nd", [data, indices], {})


def scatter_nd(data, indices, shape):
    return _call("scatter_nd", [data, indices], {"shape": shape})


def shape_array(data):
    return _call("shape_array", [data], {})


def reshape_like(lhs, rhs, **kw):
    return invoke_fn(lambda a, b: a.reshape(b.shape), [lhs, rhs])


def slice(data, begin, end, step=None):  # noqa: A001 - reference name
    kw = {"begin": begin, "end": end}
    if step is not None:
        kw["step"] = step
    return _call("slice", [data], kw)


def smooth_l1(data, scalar=1.0):
    return _call("smooth_l1", [data], {"scalar": scalar})


def ctc_loss(data, label, data_lengths=None, label_lengths=None, **kw):
    ins = [data, label]
    if data_lengths is not None:
        ins.append(data_lengths)
        kw["use_data_lengths"] = True
    if label_lengths is not None:
        if data_lengths is None:
            raise ValueError("label_lengths requires data_lengths")
        ins.append(label_lengths)
        kw["use_label_lengths"] = True
    return _call("ctc_loss", ins, kw)


# --- contrib detection ops ------------------------------------------------

def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False, **kw):
    return _call("_contrib_MultiBoxPrior", [data],
                 {"sizes": sizes, "ratios": ratios, "clip": clip, **kw})


def multibox_target(anchor, label, cls_pred, **kw):
    return _call("_contrib_MultiBoxTarget", [anchor, label, cls_pred], kw)


def multibox_detection(cls_prob, loc_pred, anchor, **kw):
    return _call("_contrib_MultiBoxDetection", [cls_prob, loc_pred, anchor],
                 kw)


def box_nms(data, **kw):
    return _call("_contrib_box_nms", [data], kw)


def roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0, **kw):
    return _call("_contrib_ROIAlign", [data, rois],
                 {"pooled_size": pooled_size, "spatial_scale": spatial_scale,
                  **kw})


def __getattr__(name):
    """Fallback: any other registered op resolves by name (PascalCase legacy
    names included), so the namespace stays a superset of the reference."""
    if has_op(name):
        def f(*inputs, **kwargs):
            tensors = []
            rest = list(inputs)
            while rest and isinstance(rest[0], NDArray):
                tensors.append(rest.pop(0))
            return invoke(name, tensors, kwargs)

        f.__name__ = name
        globals()[name] = f
        return f
    raise AttributeError(
        f"module 'mxnet_tpu_torch.numpy_extension' has no attribute "
        f"{name!r}")
