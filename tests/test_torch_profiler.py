"""``mx.profiler`` beyond dispatch counting (``mxnet_tpu_torch/profiler.py``)
against the reference's: idempotent start and stop, a chrome-trace JSON
written by ``Profiler``/``dump`` with the ``scope`` ranges in it, the
aggregate table of ``dumps()`` in the reference's format, and the same op
names aggregated for one imperative program."""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch import profiler


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    profiler.set_state("stop")
    profiler.reset_stats()
    profiler.set_config(filename=str(tmp_path / "profile.json"),
                        aggregate_stats=False)
    with tmx.cpu():
        yield
    profiler.set_state("stop")
    profiler.reset_stats()
    profiler.set_config(aggregate_stats=False)


def _prog(mx):
    nd = mx.nd
    x = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    y = nd.relu(x * 2 + 1)
    z = nd.dot(y, y.T)
    return z.sum().asnumpy(), nd.exp(y - 1).mean(axis=1).asnumpy()


def test_double_start_and_double_stop_are_noops():
    tobs.enable()
    try:
        profiler.set_state("run")
        prof = profiler._state["prof"]
        profiler.set_state("run")  # adopts the open window
        assert profiler._state["prof"] is prof and profiler._state["running"]
        profiler.set_state("stop")
        profiler.set_state("stop")  # nothing open
        assert not profiler._state["running"]
        names = [e[1] for e in tobs.trace.events()]
        assert names.count("profiler.start_trace") == 1
        assert names.count("profiler.stop_trace") == 1
    finally:
        tobs.disable()
        tobs.reset()
    with pytest.raises(ValueError):
        profiler.set_state("sideways")


def test_profiler_writes_a_chrome_trace_with_scope(tmp_path):
    path = str(tmp_path / "trace.json")
    with profiler.Profiler(filename=path):
        with profiler.scope("mx_scope_under_test"):
            _prog(tmx)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert len(events) > 10
    assert any(e.get("name") == "mx_scope_under_test" for e in events)
    # the ops ran inside the window: torch's own operator events
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    assert profiler.dumps().splitlines()[0] == \
        f"profiler trace file: {path}"


def test_pause_resume_windows_merge_into_one_dump(tmp_path):
    path = str(tmp_path / "windows.json")
    profiler.set_config(filename=path)
    profiler.set_state("run")
    with profiler.scope("first_window"):
        _prog(tmx)
    profiler.pause()
    with profiler.scope("between_windows"):
        _prog(tmx)
    profiler.resume()
    with profiler.scope("second_window"):
        _prog(tmx)
    assert profiler.dump() == path
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"first_window", "second_window"} <= names
    assert "between_windows" not in names


def test_dumps_table_equals_the_reference_for_the_same_stats():
    stats = [("dot", 0.004), ("relu", 0.001), ("dot", 0.002),
             ("sum", 0.0005), ("relu", 0.003)]
    for mod in (profiler, jmx.profiler):
        mod.reset_stats()
        for name, sec in stats:
            mod.record_op(name, sec)
    for kw in ({}, {"sort_by": "count"}, {"sort_by": "avg"},
               {"sort_by": "min", "ascending": True}):
        mine = profiler.dumps(**kw).splitlines()[1:]
        ref = jmx.profiler.dumps(**kw).splitlines()[1:]
        assert mine == ref
        assert mine[1] == "Profile Statistics (eager op dispatch):"
    assert profiler.dumps(reset=True) and not profiler._agg
    jmx.profiler.reset_stats()


def test_aggregate_op_names_equal_the_reference(tmp_path):
    names = {}
    for mx, tag in ((jmx, "ref"), (tmx, "port")):
        mx.profiler.reset_stats()
        mx.profiler.set_config(filename=str(tmp_path / f"{tag}.json"),
                               aggregate_stats=True)
        with mx.cpu():
            mx.profiler.set_state("run")
            out = _prog(mx)
            mx.profiler.set_state("stop")
        names[tag] = {k: v[0] for k, v in mx.profiler._agg.items()}
        mx.profiler.reset_stats()
        mx.profiler.set_config(aggregate_stats=False)
        assert float(out[0]) == 464.0
    assert names["port"] == names["ref"]
    assert {"dot", "relu", "exp", "sum"} <= set(names["port"])


def test_aggregate_timing_only_while_running():
    profiler.set_config(aggregate_stats=True)
    _prog(tmx)
    assert not profiler._agg  # the profiler is not running
    profiler.set_state("run")
    _prog(tmx)
    profiler.set_state("stop")
    assert all(v[1] >= 0.0 for v in profiler._agg.values())
    assert "dot" in profiler.dumps()
