"""2-bit gradient compression of the port (mxnet_tpu_torch.kvstore.
compression) against the JAX package's, on the CPU.

The same seeded numpy gradients (50 vectors, odd lengths included) go
through both packages: the packed bytes, the error-feedback residuals and
the decoded values must be byte-identical, through the numpy functions and
through the port's PyTorch route (the device store's), and the code-16
wire frames one package packs must unpack to the same values in the
other. Tolerance: none (bitwise).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import base as jbase
from mxnet_tpu.kvstore import compression as jc
from mxnet_tpu.kvstore import ps_server as jps
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kvstore import compression as tc
from mxnet_tpu_torch.kvstore import ps_server as tps

_LENGTHS = [1, 2, 3, 4, 5, 7, 8, 9, 13, 31, 64, 97, 127, 128, 255, 1001]


def _vectors():
    rng = np.random.RandomState(11)
    out = []
    for i in range(50):
        n = _LENGTHS[i % len(_LENGTHS)] + (i // len(_LENGTHS))
        thr = float(rng.choice([0.05, 0.3, 0.5, 0.7, 1.0]))
        g = (rng.randn(n) * rng.choice([0.1, 0.5, 2.0])).astype(np.float32)
        if i % 5 == 0:  # values exactly at the f32 threshold, both signs
            g[::3] = np.float32(thr)
            g[1::3] = -np.float32(thr)
        out.append((g, thr))
    return out


@pytest.mark.parametrize("i", range(50))
def test_packed_bytes_and_residuals_byte_identical(i):
    g, thr = _vectors()[i]
    ref_res, port_res = g.copy(), g.copy()
    ref = jc.quantize_2bit(ref_res, thr)
    port = tc.quantize_2bit(port_res, thr)
    assert ref.tobytes() == port.tobytes()
    assert ref_res.tobytes() == port_res.tobytes()
    # the PyTorch route (the device store's) gives the same bytes
    t_res = torch.from_numpy(g.copy())
    t_packed = tc.quantize_2bit_torch(t_res, thr)
    assert t_packed.numpy().tobytes() == ref.tobytes()
    assert t_res.numpy().tobytes() == ref_res.tobytes()
    dec = jc.dequantize_2bit(ref, thr, g.size)
    assert tc.dequantize_2bit(ref, thr, g.size).tobytes() == dec.tobytes()
    assert tc.dequantize_2bit_torch(torch.from_numpy(ref), thr,
                                    g.size).numpy().tobytes() == dec.tobytes()


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), ()])
def test_error_feedback_over_rounds_matches(shape):
    """Three rounds through GradientCompression: residuals carried, the
    packed rounds and the wire frames equal (numpy and tensor inputs)."""
    rng = np.random.RandomState(3)
    jg, tg, tt = (jc.GradientCompression(0.4), tc.GradientCompression(0.4),
                  tc.GradientCompression(0.4))
    for _ in range(3):
        g = np.asarray(rng.randn(*shape) * 0.3, np.float32)
        want = jg.compress("k", g)
        assert tg.compress("k", g).tobytes() == want.tobytes()
        assert tt.compress("k", torch.from_numpy(g)).numpy().tobytes() \
            == want.tobytes()
        assert tg._residuals["k"].tobytes() == \
            jg._residuals["k"].tobytes()
        assert tt._residuals["k"].numpy().tobytes() == \
            jg._residuals["k"].tobytes()
        np.testing.assert_array_equal(
            tt.decompress(torch.from_numpy(want), shape).numpy(),
            jg.decompress(want, shape))
    g = np.asarray(rng.randn(*shape), np.float32)
    assert jg.pack_wire("w", g) == tg.pack_wire("w", g)


def test_code_16_frames_unpack_across_packages():
    """A dtype-16 frame packed by either package unpacks to the same f32
    values in the other (the server dequantizes it on arrival)."""
    rng = np.random.RandomState(5)
    g = rng.randn(4, 9).astype(np.float32)
    frame = jc.GradientCompression(0.25).pack_wire("w", g)
    assert frame == tc.GradientCompression(0.25).pack_wire("w", g)
    want = jps._unpack_array(memoryview(frame))
    got = tps._unpack_array(memoryview(frame))
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert tps._array_nbytes(memoryview(frame)) == len(frame)
    with pytest.raises(ConnectionError):
        tps._unpack_array(memoryview(frame[:-3]))


@pytest.mark.parametrize("params", [
    {"type": "1bit"}, {"type": "2bit", "threshold": 0}, {"type": "2bit",
                                                         "bogus": 1},
    {"type": "none", "threshold": 0.5}])
def test_invalid_params_raise_in_both(params):
    with pytest.raises(jbase.MXNetError) as je:
        jc.validate_compression_params(params)
    with pytest.raises(MXNetError) as te:
        tc.validate_compression_params(params)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("params", [None, {"type": "none"},
                                    {"type": "2bit"},
                                    {"type": "2bit", "threshold": 2}])
def test_valid_params_agree(params):
    assert tc.validate_compression_params(params) == \
        jc.validate_compression_params(params)
