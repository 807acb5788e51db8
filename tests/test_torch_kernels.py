"""The port's kernel build and launch path (``mxnet_tpu_torch/ops/_kernels.py``)
on the CPU: what can be checked without ``nvcc`` or a card.

Every source names a C launcher and a Python entry point of the same name,
and the entry point takes as many arguments as the wrapper passes; the
constants the wrappers check against are the kernel's; a missing
``Python.h`` raises instead of building; the entry is bound once.
"""
import re
import sysconfig
import types
from pathlib import Path

import pytest

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import _kernels

CSRC = Path(_kernels.CSRC)

# the number of arguments each wrapper passes to its entry point
# (ops/flash_attention.py, tools/launch_cost_probe.py)
_WRAPPER_ARGS = {"paged_decode_attention": 22, "flash_attention_fwd": 15,
                 "flash_attention_bwd": 22, "copy_probe": 4}


@pytest.mark.parametrize("name", sorted(_kernels.KERNELS))
def test_source_defines_launcher_and_entry_point(name):
    text = (CSRC / _kernels.KERNELS[name]).read_text()
    assert f'extern "C" int {name}(' in text
    assert f"MXT_PY_MODULE({name}, py_launch)" in text
    nargs = re.search(r'nargs\(n, (\d+), "(\w+)"\)', text)
    assert nargs and nargs.group(2) == name
    assert int(nargs.group(1)) == _WRAPPER_ARGS[name]
    # Python.h comes before any standard header
    first = re.search(r'^#include [<"]([^>"]+)[>"]', text, re.M)
    assert first.group(1) == "pyentry.cuh"


def test_paged_limits_match_the_kernel():
    text = (CSRC / "paged_decode_attention.cu").read_text()
    assert "constexpr int kMaxD = 256;" in text
    assert "constexpr int kMaxChunkPages = 512;" in text
    src = Path(_kernels.__file__).with_name("flash_attention.py").read_text()
    assert "0 < d <= 256" in src and "chunk // page > 512" in src


def test_missing_python_headers_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels.sysconfig, "get_paths",
                        lambda: {"include": str(tmp_path)})
    with pytest.raises(MXNetError, match="Python.h"):
        _kernels._flags()
    with pytest.raises(MXNetError, match="Python.h"):
        _kernels._lib_path("copy_probe")


def test_library_name_follows_sources_and_flags(monkeypatch):
    if not Path(sysconfig.get_paths()["include"], "Python.h").exists():
        pytest.skip("no Python headers")
    paths = {n: _kernels._lib_path(n) for n in _kernels.KERNELS}
    assert len(set(paths.values())) == len(paths)
    assert all(p.parent == _kernels.BUILD_DIR for p in paths.values())
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ["-G"])
    assert _kernels._lib_path("copy_probe") != paths["copy_probe"]


def test_entry_is_bound_once(monkeypatch):
    calls = []

    def launch(*args):
        return len(args)

    def load(name):
        calls.append(name)
        return types.SimpleNamespace(launch=launch)

    monkeypatch.setattr(_kernels, "load", load)
    monkeypatch.setattr(_kernels, "_entries", {})
    assert _kernels.entry("copy_probe") is launch
    assert _kernels.entry("copy_probe") is launch
    assert calls == ["copy_probe"]
    assert _kernels.entry("copy_probe")(1, 2, 3, 4) == 4
