"""The PyTorch/CUDA port stands alone: ``mxnet_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")

_IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REF_PKG = re.compile(r"\bmxnet_tpu(?!_torch)\b")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


def test_import_loads_neither_jax_nor_reference():
    """Every module of the port, the numpy front end, sparse arrays,
    custom ops and the batch-serving stack included, imports without JAX
    and without the reference package."""
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.models, mxnet_tpu_torch.ops, "
            "mxnet_tpu_torch.parallel, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.gluon, mxnet_tpu_torch.ndarray, "
            "mxnet_tpu_torch.autograd, mxnet_tpu_torch.random, "
            "mxnet_tpu_torch.tools.nd_lm, mxnet_tpu_torch.progcache, "
            "mxnet_tpu_torch.tools.launch_cost_probe, "
            "mxnet_tpu_torch.symbol, mxnet_tpu_torch.executor, "
            "mxnet_tpu_torch.module, mxnet_tpu_torch.checkpoint, "
            "mxnet_tpu_torch.checkpoint.manager, "
            "mxnet_tpu_torch.checkpoint.state, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.callback, "
            "mxnet_tpu_torch.model, mxnet_tpu_torch.name, "
            "mxnet_tpu_torch.attribute, "
            "mxnet_tpu_torch.analysis.shape_infer, "
            "mxnet_tpu_torch.ndarray.serialization, "
            "mxnet_tpu_torch.registry, mxnet_tpu_torch.engine, "
            "mxnet_tpu_torch.visualization, mxnet_tpu_torch.subgraph, "
            "mxnet_tpu_torch.monitor, mxnet_tpu_torch.gluon.data, "
            "mxnet_tpu_torch.gluon.data.vision, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.gluon.data.vision.datasets, "
            "mxnet_tpu_torch.io.recordio, mxnet_tpu_torch.io.io, "
            "mxnet_tpu_torch.native, mxnet_tpu_torch.image, "
            "mxnet_tpu_torch.gluon.contrib, "
            "mxnet_tpu_torch.gluon.contrib.estimator, "
            "mxnet_tpu_torch.gluon.contrib.estimator.event_handler, "
            "mxnet_tpu_torch.tools.im2rec, mxnet_tpu_torch.ops.ordering, "
            "mxnet_tpu_torch.ops.sequence, mxnet_tpu_torch.ops.rnn, "
            "mxnet_tpu_torch.ops.loss_ops, mxnet_tpu_torch.ops.random_ops, "
            "mxnet_tpu_torch.ops.control_flow, "
            "mxnet_tpu_torch.ndarray.contrib, mxnet_tpu_torch.symbol.contrib, "
            "mxnet_tpu_torch.symbol.random, mxnet_tpu_torch.gluon.rnn, "
            "mxnet_tpu_torch.gluon.rnn.rnn_cell, "
            "mxnet_tpu_torch.gluon.rnn.rnn_layer, mxnet_tpu_torch.rnn, "
            "mxnet_tpu_torch.rnn.rnn_cell, mxnet_tpu_torch.rnn.io, "
            "mxnet_tpu_torch.models.seq2seq, "
            "mxnet_tpu_torch.ops.contrib, mxnet_tpu_torch.ops.image_ops, "
            "mxnet_tpu_torch.ops.quantization, mxnet_tpu_torch.ndarray.image, "
            "mxnet_tpu_torch.ndarray.linalg, mxnet_tpu_torch.gluon.contrib.nn, "
            "mxnet_tpu_torch.models.ssd, mxnet_tpu_torch.contrib, "
            "mxnet_tpu_torch.contrib.quantization, "
            "mxnet_tpu_torch.contrib.onnx, "
            "mxnet_tpu_torch.contrib._onnx_proto, "
            "mxnet_tpu_torch.numpy, mxnet_tpu_torch.numpy.linalg, "
            "mxnet_tpu_torch.numpy.random, mxnet_tpu_torch.numpy._ops, "
            "mxnet_tpu_torch.numpy_extension, mxnet_tpu_torch.util, "
            "mxnet_tpu_torch.operator, mxnet_tpu_torch.ndarray.sparse, "
            "mxnet_tpu_torch.wire, mxnet_tpu_torch.kvstore, "
            "mxnet_tpu_torch.kvstore.ps_server, "
            "mxnet_tpu_torch.kvstore.ps_client, "
            "mxnet_tpu_torch.kvstore.kvstore, mxnet_tpu_torch.kvstore.dist, "
            "mxnet_tpu_torch.kvstore.elastic, "
            "mxnet_tpu_torch.kvstore.compression, "
            "mxnet_tpu_torch.tools.launch, mxnet_tpu_torch.tools.dist_worker, "
            "mxnet_tpu_torch.parallel.ring_attention, "
            "mxnet_tpu_torch.tools.mesh_worker, "
            "mxnet_tpu_torch.serve.engine, mxnet_tpu_torch.serve.batcher, "
            "mxnet_tpu_torch.serve.server, mxnet_tpu_torch.serve.client, "
            "mxnet_tpu_torch.obs.health, mxnet_tpu_torch.obs.regress, "
            "mxnet_tpu_torch.chaos, mxnet_tpu_torch.chaos.nan, "
            "mxnet_tpu_torch.profiler, mxnet_tpu_torch.analysis.findings, "
            "mxnet_tpu_torch.tools.health_bench, "
            "mxnet_tpu_torch.tools.bench_compare, "
            "mxnet_tpu_torch.obs.fleetstats, mxnet_tpu_torch.chaos.slow, "
            "mxnet_tpu_torch.tools.train_report, "
            "mxnet_tpu_torch.tools.elastic_bench, "
            "mxnet_tpu_torch.tools.fleet_report, "
            "mxnet_tpu_torch.analysis, mxnet_tpu_torch.analysis.cli, "
            "mxnet_tpu_torch.analysis.repo_lint, mxnet_tpu_torch.runtime, "
            "mxnet_tpu_torch.tools.lint_repo, "
            "mxnet_tpu_torch.tools.graph_lint\n"
            "import mxnet_tpu_torch as mx\n"
            "assert mx.np.linalg and mx.npx.relu and mx.util.get_gpu_count "
            "and mx.operator.CustomOp and mx.nd.sparse.csr_matrix\n"
            "assert mx.serve.InferenceEngine and mx.serve.DynamicBatcher "
            "and mx.serve.ServeServer and mx.serve.ServeClient "
            "and mx.serve.load and mx.serve.load_params\n"
            "assert mx.kv.create('device').type == 'device' "
            "and mx.kvstore.KVStore\n"
            "assert mx.runtime.feature_list() and mx.analysis.GraphLinter\n"
            "from mxnet_tpu_torch import nd, autograd\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_or_reference(path):
    with open(path) as f:
        text = f.read()
    assert not _IMPORT_JAX.search(text), path
    code = "\n".join(line for line in text.splitlines()
                     if re.match(r"\s*(import|from)\s", line))
    assert not _REF_PKG.search(code), path


def test_fleet_obs_bench_and_test_utils_import_alone():
    """The serving fleet, the autoscaler, the metrics plane, serve_bench
    and test_utils import with neither JAX nor the reference loaded, and
    ``mx.obs``/``mx.test_utils`` resolve from the package."""
    code = ("import sys\n"
            "import mxnet_tpu_torch.obs, mxnet_tpu_torch.obs.metrics, "
            "mxnet_tpu_torch.obs.slo, mxnet_tpu_torch.obs.export, "
            "mxnet_tpu_torch.serve.fleet, mxnet_tpu_torch.serve.autoscale, "
            "mxnet_tpu_torch.tools.serve_bench, mxnet_tpu_torch.test_utils\n"
            "import mxnet_tpu_torch as mx\n"
            "assert mx.obs.metrics.snapshot() and mx.test_utils.list_tpus() "
            "== []\n"
            "for n in ('CircuitBreaker', 'LocalReplica', 'ProcReplica', "
            "'ReplicaPool', 'Router', 'FleetServer', 'Autoscaler', "
            "'AutoscalePolicy'):\n"
            "    assert getattr(mx.serve, n) and n in mx.serve.__all__\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"
