"""The port's regression dossier (``mxnet_tpu_torch/obs/regress.py``) and
``mxnet_tpu_torch/tools/bench_compare.py`` against the reference's
``mxnet_tpu/obs/regress.py`` and ``tools/bench_compare.py``, on the CPU:
the same round files give equal dossiers (gains, transitions, gaps,
anomalies, verdict and exit code), for the reference's synthetic
trajectories (``tests/test_device_obs.py``'s unit cases) and for the
committed ``BENCH_r01..r05`` history; the port's CLI prints and returns
what the reference's does.
"""
import json
import os
import sys

import pytest

from mxnet_tpu.obs import regress as jregress
from mxnet_tpu_torch.obs import regress as tregress
from mxnet_tpu_torch.tools import bench_compare as tcompare

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = [os.path.join(REPO, f"BENCH_r{i:02d}.json") for i in range(1, 6)]


def _fake_round(tmp_path, n, value=None, extra=None, rc=0, error=None):
    parsed = {"metric": "resnet50_v1 fp32 train throughput", "value": value,
              "unit": "images/sec", "vs_baseline": None}
    if extra is not None:
        parsed["extra"] = extra
    if error:
        parsed["error"] = error
    p = tmp_path / f"BENCH_r{n:02d}.json"
    p.write_text(json.dumps({"n": n, "rc": rc, "parsed": parsed}))
    return str(p)


SPREAD = {"fp32_spread": 0.02}
# (rounds as (n, kwargs), the expected transition classes, status)
CASES = {
    "improvement_noise_regression": (
        [(1, dict(value=100.0, extra=SPREAD)),
         (2, dict(value=120.0, extra=SPREAD)),
         (3, dict(value=121.0, extra=SPREAD)),
         (4, dict(value=90.0, extra=SPREAD))],
        ["improvement", "within_noise", "regression"], "regression"),
    "within_spread_band": (
        [(1, dict(value=100.0, extra={"fp32_spread": 0.10})),
         (2, dict(value=94.0, extra={"fp32_spread": 0.03}))],
        ["within_noise"], "clean"),
    "platform_gap": (
        [(1, dict(value=100.0, extra=SPREAD)),
         (2, dict(rc=1, error="device enumeration timed out")),
         (3, dict(value=101.0, extra=SPREAD))],
        ["within_noise"], "gap"),
    "bf16_piped_inversion": (
        [(1, dict(value=100.0, extra={"fp32_spread": 0.02,
                                      "resnet50_piped_ips": 170.0,
                                      "resnet50_piped_bf16_ips": 75.0}))],
        [], "regression"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dossier_equals_reference(tmp_path, case):
    rounds, classes, status = CASES[case]
    paths = [_fake_round(tmp_path, n, **kw) for n, kw in rounds]
    got, want = tregress.dossier(paths), jregress.dossier(paths)
    assert got == want
    t = got["gains"]["resnet50_fp32_ips"]["transitions"]
    assert [x["class"] for x in t] == classes
    assert got["status"] == status
    assert got["exit_code"] == {"regression": tregress.EXIT_REGRESSION,
                                "clean": tregress.EXIT_CLEAN,
                                "gap": tregress.EXIT_GAP}[status]
    assert tregress.render(got) == jregress.render(want)


def test_committed_trajectory_equals_reference(capsys):
    """BENCH_r01..r05: the bf16-piped inversion flagged, r05 a platform
    gap, a regression-class exit code, as the reference's CLI says."""
    got, want = tregress.dossier(COMMITTED), jregress.dossier(COMMITTED)
    assert got == want
    code = tcompare.main(COMMITTED)
    out = capsys.readouterr().out
    assert code == tregress.EXIT_REGRESSION
    assert "bf16_piped_inversion" in out
    assert "GAP" in out and "r05" in out
    assert out == tregress.render(got) + "\n"


def test_bench_compare_json_output_and_file(tmp_path, capsys):
    paths = [_fake_round(tmp_path, 1, value=100.0, extra=SPREAD),
             _fake_round(tmp_path, 2, value=130.0, extra=SPREAD)]
    out_path = str(tmp_path / "dossier.json")
    code = tcompare.main(paths + ["--json", "--out", out_path])
    assert code == tregress.EXIT_CLEAN
    doc = json.loads(capsys.readouterr().out)
    assert doc == jregress.dossier(paths)
    with open(out_path) as f:
        assert json.load(f) == doc
    assert tcompare.main(paths + ["--min-band", "0.5", "--json"]) == \
        tregress.EXIT_CLEAN


def test_bench_compare_loads_regress_without_the_package():
    """The CLI reads ``obs/regress.py`` by its path: no framework import
    (the reference's promise: it runs wherever the JSON does)."""
    mod = tcompare._load_regress()
    assert mod.__name__ == "_bench_regress"
    assert "torch" not in mod.__dict__ and mod.EXIT_GAP == 3
    assert sys.modules.get("_bench_regress") is None
