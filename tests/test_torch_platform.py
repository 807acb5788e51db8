"""The port's guarded platform entry points (``mxnet_tpu_torch/platform.py``)
and the hang injector (``chaos/platform.py``) against the reference's: the
cases of ``tests/test_platform.py`` less the TPU-only ones (``bench.py``,
``__graft_entry__``'s drivers). With ``MXNET_CHAOS_TUNNEL_HANG`` on, a
guarded first touch raises ``PlatformUnavailable`` within its budget, and
the port's tools exit non-zero with ONE parseable artifact line; without
a card the first touch raises, never falls back to the CPU."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import platform as jplatform
from mxnet_tpu_torch import platform as mxplatform
from mxnet_tpu_torch.chaos import platform as chaos_platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_injector(monkeypatch):
    monkeypatch.delenv("MXNET_CHAOS_TUNNEL_HANG", raising=False)
    yield


# ---------------------------------------------------------------------------
# watchdog semantics
# ---------------------------------------------------------------------------

def test_watchdog_passes_result_through():
    assert mxplatform.call_with_watchdog(lambda: 42, what="t",
                                         timeout=5) == 42


def test_watchdog_timeout_raises_bounded():
    t0 = time.monotonic()
    with pytest.raises(mxplatform.PlatformUnavailable) as ei:
        mxplatform.call_with_watchdog(lambda: time.sleep(30), what="hang",
                                      timeout=0.2)
    assert time.monotonic() - t0 < 5.0
    err = ei.value
    assert err.kind == "platform_unavailable"
    assert err.timeout_s == 0.2
    art = err.artifact()
    assert art["schema"] == mxplatform.ARTIFACT_SCHEMA
    assert art["error"] == "platform_unavailable"
    json.dumps(art)  # must be wire-serializable


def test_watchdog_init_raise_is_distinct():
    """A raise during the first touch is a real failure (driver, config)
    and is never triaged as the known hang."""

    def boom():
        raise RuntimeError("driver exploded")

    with pytest.raises(mxplatform.PlatformUnavailable) as ei:
        mxplatform.call_with_watchdog(boom, what="init", timeout=5)
    assert ei.value.kind == "platform_init_failed"
    assert "driver exploded" in ei.value.detail
    assert "hint" not in ei.value.artifact()  # the hang hint would mislead


def test_artifact_keys_and_schema_equal_the_reference():
    for kind in ("platform_unavailable", "platform_init_failed"):
        mine = mxplatform.PlatformUnavailable(
            "w", "d", kind=kind, timeout_s=1.0, elapsed_s=1.0).artifact()
        ref = jplatform.PlatformUnavailable(
            "w", "d", kind=kind, timeout_s=1.0, elapsed_s=1.0).artifact()
        assert sorted(mine) == sorted(ref)
        assert mine["schema"] == ref["schema"] == jplatform.ARTIFACT_SCHEMA
    assert sorted(mxplatform.__all__) == sorted(jplatform.__all__)


def test_devices_normal_path():
    devs = mxplatform.devices(timeout=60, backend="cpu")
    assert devs == [torch.device("cpu")]
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in mxplatform.devices(timeout=60))


def test_devices_without_a_card_raises_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the first touch succeeds")
    with pytest.raises(mxplatform.PlatformUnavailable) as ei:
        mxplatform.devices(timeout=60)
    assert ei.value.kind == "platform_init_failed"
    assert ei.value.what == "cuda.devices"
    with pytest.raises(mxplatform.PlatformUnavailable):
        mxplatform.device_put(np.zeros(2, np.float32), timeout=60)


def test_device_put_guarded_on_the_cpu():
    t = mxplatform.device_put(np.arange(3, dtype=np.float32), "cpu",
                              timeout=30)
    assert isinstance(t, torch.Tensor) and t.tolist() == [0.0, 1.0, 2.0]


# ---------------------------------------------------------------------------
# the hang injector
# ---------------------------------------------------------------------------

def test_hang_points_parse(monkeypatch):
    assert chaos_platform.hang_points() is None
    monkeypatch.setenv("MXNET_CHAOS_TUNNEL_HANG", "1")
    assert chaos_platform.hang_points() == {"*"}
    monkeypatch.setenv("MXNET_CHAOS_TUNNEL_HANG", "cuda.devices, device_put")
    assert chaos_platform.hang_points() == {"cuda.devices", "device_put"}
    from mxnet_tpu.chaos import platform as jchaos

    for spec in ("1", "all", "cuda.devices, device_put", " , x,"):
        monkeypatch.setenv("MXNET_CHAOS_TUNNEL_HANG", spec)
        assert chaos_platform.hang_points() == jchaos.hang_points()


def test_tunnel_hang_bounds_devices(monkeypatch):
    """With the injector on, the first touch fails within the watchdog's
    budget, carrying the platform_unavailable artifact."""
    monkeypatch.setenv("MXNET_CHAOS_TUNNEL_HANG", "1")
    for backend, what in ((None, "cuda.devices"), ("cpu", "cpu.devices")):
        t0 = time.monotonic()
        with pytest.raises(mxplatform.PlatformUnavailable) as ei:
            mxplatform.devices(timeout=0.3, backend=backend)
        assert time.monotonic() - t0 < 5.0
        assert ei.value.kind == "platform_unavailable"
        assert ei.value.what == what
    with pytest.raises(mxplatform.PlatformUnavailable) as ei:
        mxplatform.device_put(np.zeros(1, np.float32), "cpu", timeout=0.3)
    assert ei.value.what == "device_put"


def test_tunnel_hang_named_point_only(monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS_TUNNEL_HANG", "device_put")
    # an untargeted point passes straight through
    assert len(mxplatform.devices(timeout=30, backend="cpu")) == 1
    with pytest.raises(mxplatform.PlatformUnavailable):
        mxplatform.device_put(np.zeros(1, np.float32), "cpu", timeout=0.3)


def test_virtual_cpu_env_strips_injector_and_hides_the_card(monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS_TUNNEL_HANG", "1")
    env = mxplatform.virtual_cpu_env(4)
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert "MXNET_CHAOS_TUNNEL_HANG" not in env  # a CPU child needs no card
    assert "MXNET_CHAOS_TUNNEL_HANG" in os.environ  # the caller's is kept
    base = {"MXNET_CHAOS_TUNNEL_HANG": "1", "X": "y"}
    assert mxplatform.virtual_cpu_env(2, base=base) == {
        "X": "y", "CUDA_VISIBLE_DEVICES": ""}
    with pytest.raises(ValueError):
        mxplatform.virtual_cpu_env(0)


def test_default_timeout_reads_its_env(monkeypatch):
    monkeypatch.delenv("MXNET_PLATFORM_TIMEOUT", raising=False)
    assert mxplatform.default_timeout() == jplatform.default_timeout() == 90
    monkeypatch.setenv("MXNET_PLATFORM_TIMEOUT", "2.5")
    assert mxplatform.default_timeout() == 2.5


# ---------------------------------------------------------------------------
# the tools' bounded exit (subprocesses: the real degradation path)
# ---------------------------------------------------------------------------

def _run_hung_tool(args, budget=60.0):
    env = dict(os.environ)
    env["MXNET_CHAOS_TUNNEL_HANG"] = "1"
    env["MXNET_PLATFORM_TIMEOUT"] = "2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=budget)
    return out.returncode, out.stdout, time.monotonic() - t0


def _artifacts(stdout):
    arts = []
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if isinstance(d, dict):
                arts.append(d)
    assert arts, f"no JSON artifact line in the output:\n{stdout[-2000:]}"
    return arts


@pytest.mark.parametrize("tool,args", [
    ("serve_bench", ["--wire-hop", "--device", "cpu"]),
    ("launch_cost_probe", []),
])
def test_tool_exits_with_artifact_under_hang(tool, args):
    rc, out, wall = _run_hung_tool([f"mxnet_tpu_torch.tools.{tool}", *args])
    assert rc == 1
    assert wall < 60
    (art,) = _artifacts(out)
    assert art["schema"] == mxplatform.ARTIFACT_SCHEMA
    assert art["error"] == "platform_unavailable"
    assert art["driver"] == f"mxnet_tpu_torch/tools/{tool}.py"
    assert sorted(art) == sorted(jplatform.PlatformUnavailable(
        "w", "d", kind="platform_unavailable", timeout_s=1.0,
        elapsed_s=1.0).artifact(driver="x"))
