"""``mx.runtime`` of the port (``mxnet_tpu_torch/runtime.py``) against the
reference's on the CPU: the same public names, feature introspection
reporting this build (CUDA/cuDNN/NCCL from torch; the TPU build's
TPU/XLA/PALLAS/PJIT off), and the environment registry: the reference's
rows for every knob the port reads (the JAX-only knobs left out), the
port's own (``MXNET_MESH_LM``), and ``env_list``/``env_doc``.
"""
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import runtime

# the reference's knobs that exist for JAX alone (a jax platform pin, the
# XLA compile cache, buffer donation, matmul precision, the numpy
# delegate warning) or belong to modules the port has not yet ported
# (queue items A15(f) and A15(g)); the test suite's seed is read by the
# reference's conftest, not by either package
_NOT_PORTED = {"MXNET_FORCE_PLATFORM", "MXNET_COMPILE_CACHE",
               "MXNET_COMPILE_CACHE_DIR", "MXNET_FUSED_DONATE",
               "MXNET_MATMUL_PRECISION", "MXNET_NP_SILENT_FALLBACK",
               "MXNET_SERVE_WARMUP_THREADS", "MXNET_PS_PLATFORM",
               "MXNET_TSAN", "MXNET_TSAN_RAISE", "MXNET_TSAN_STALL_S",
               "MXNET_COPYTRACK", "MXNET_CHAOS_RPC",
               "MXNET_CHAOS_TUNNEL_HANG", "MXNET_PLATFORM_TIMEOUT",
               "MXNET_TEST_SEED"}


def test_mx_runtime_resolves():
    assert mx.runtime is runtime
    assert set(runtime.__all__) == set(jmx.runtime.__all__)


def test_features_report_this_build():
    feats = {f.name: f.enabled for f in runtime.feature_list()}
    assert set(feats) == {f.name for f in jmx.runtime.feature_list()}
    assert feats["CUDA"] == torch.cuda.is_available()
    assert not any(feats[k] for k in ("TPU", "XLA", "PALLAS", "PJIT"))
    assert feats["CPU"] and feats["BF16"] and feats["RING_ATTENTION"]
    f = runtime.Features()
    assert f.is_enabled("CPU") and not f.is_enabled("TPU")
    assert not f.is_enabled("NO_SUCH_FEATURE")
    assert runtime.is_enabled("CUDNN") == f.is_enabled("CUDNN")
    if not torch.cuda.is_available():
        assert not feats["CUDNN"] and not feats["NCCL"]


def test_env_registry_rows_are_the_references_where_they_apply():
    ref = jmx.runtime._ENV_REGISTRY
    port = runtime._ENV_REGISTRY
    assert set(ref) - set(port) == _NOT_PORTED
    assert set(port) - set(ref) == {"MXNET_MESH_LM"}
    # the defaults agree wherever both packages have the knob
    assert {k: port[k][0] for k in port if k in ref} == {
        k: ref[k][0] for k in port if k in ref}


def test_env_list_and_doc(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPH_LINT", "warn")
    evs = {e.name: e for e in runtime.env_list()}
    assert [e.name for e in runtime.env_list()] == sorted(evs)
    assert evs["MXNET_GRAPH_LINT"].current == "warn"
    assert evs["MXNET_GRAPH_LINT"].default == "off"
    assert "RNG seed" in runtime.env_doc("MXNET_SEED")
    assert runtime.env_doc("MXNET_MESH_LM").startswith(
        "MXNET_MESH_LM (default None): ")
    with pytest.raises(KeyError):
        runtime.env_doc("MXNET_NO_SUCH_KNOB")
