"""The fleet's collection plane on the CPU: the port's counterpart of
``tests/test_obs_distributed.py::
test_flagship_fleet_trace_merges_across_processes_with_kill``.

Two ``ProcReplica`` children (``python -m mxnet_tpu_torch.serve.server``
pinned to the CPU, ``obs_dir=`` set, telemetry inherited) behind a
``Router``/``FleetServer``, mixed-shape load from three clients, one child
SIGKILLed mid-run and restarted by the supervisor. One ``OP_TELEMETRY``
against the front plus the children's ``replica-<pid>.jsonl`` evidence
(``tools/fleet_report.jsonl_to_part``) merge into one chrome trace in
which (a) every replica-side span carries a trace id the client rooted,
(b) those spans live on other pids' lanes than the client's, (c) the
``fleet.route`` hop joins the same traces and (d) the kill is a tagged
event on the same timeline. The port's ``trace_report`` reads the front's
export, the JSONL files and the corpse's ``-last.json`` bundle and shows
a lane per pid; ``fleet_report`` renders the collection and its
Prometheus text end to end.
"""
import json
import os
import threading
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, obs, serve
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.model import save_checkpoint
from mxnet_tpu_torch.serve import ServeClient
from mxnet_tpu_torch.serve.fleet import FleetServer, ReplicaPool, Router
from mxnet_tpu_torch.tools import fleet_report, trace_report


def _save_linear_ckpt(tmpdir):
    prefix = os.path.join(str(tmpdir), "lin")
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=4, no_bias=True, name="fc")
    save_checkpoint(prefix, 0, net,
                    {"fc_weight": nd.array(np.eye(4, dtype=np.float32),
                                             ctx=mx.cpu())}, {})
    return prefix


def test_flagship_fleet_trace_merges_across_processes_with_kill(tmp_path):
    prefix = _save_linear_ckpt(tmp_path)
    obs_dir = str(tmp_path / "obs")
    obs.disable()
    obs.reset()
    obs.enable()
    env = {"MXNET_SERVE_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "MXNET_OBS_BLACKBOX_FLUSH_S": "0.2"}
    pool = ReplicaPool.spawn(prefix, 2, env=env, obs_dir=obs_dir,
                             probe_interval=0.2, backoff_base=0.1,
                             backoff_cap=1.0, ready_timeout=180).start()
    front = None
    try:
        router = Router(pool, breaker_cooldown=0.3)
        front = FleetServer(router, port=0)
        front.start()
        addr = ("127.0.0.1", front.port)
        rng = np.random.RandomState(0)
        shapes = [rng.rand(n, 4).astype(np.float32) for n in (1, 2, 5)]
        stop = threading.Event()
        errors = []

        def load(worker):
            cli = ServeClient(*addr)
            i = 0
            while not stop.is_set():
                x = shapes[(worker + i) % len(shapes)]
                i += 1
                try:
                    np.testing.assert_array_equal(
                        cli.infer(x, deadline_ms=10000), x)
                except (serve.RequestRejected, serve.Draining,
                        serve.DeadlineExceeded):
                    pass  # clean degradation around the kill
                except serve.ServeError as e:
                    errors.append(repr(e))
            cli.close()

        workers = [threading.Thread(target=load, args=(w,))
                   for w in range(3)]
        for t in workers:
            t.start()
        time.sleep(1.0)
        corpse = pool.members()[0].handle.proc.pid
        time.sleep(0.5)  # let the corpse's recorder flush its last bundle
        pool.kill(0)  # a real SIGKILL mid-run
        deadline = time.monotonic() + 120
        m0 = pool.members()[0]
        while time.monotonic() < deadline and not (
                m0.restarts >= 1 and m0.state == "ready"):
            time.sleep(0.2)
        time.sleep(0.3)
        stop.set()
        for t in workers:
            t.join()
        assert not errors, errors[:3]
        assert m0.state == "ready"

        ctl = ServeClient(*addr)
        prom = ctl.telemetry(drain=False, fmt="prometheus")
        tel = ctl.telemetry()
        ctl.close()
        parts = tel["parts"]
        assert parts[0]["role"] == "fleet" and len(parts) >= 3
        assert 'role="replica1"' in prom and prom.endswith("# EOF\n")

        files = sorted(os.path.join(obs_dir, f) for f in os.listdir(obs_dir))
        jsonls = [f for f in files if os.path.basename(f).startswith(
            "replica-")]
        assert f"replica-{corpse}.jsonl" in map(os.path.basename, jsonls)
        live = {p["pid"] for p in parts}
        dead = [fleet_report.jsonl_to_part(p) for p in jsonls]
        merged = obs.export_mod.merge_chrome_parts(
            parts + [p for p in dead if p["pid"] not in live])
        evs = merged["traceEvents"]
        me = os.getpid()
        client_tids = {(e.get("args") or {}).get("trace_id") for e in evs
                       if e.get("ph") == "X" and e["pid"] == me
                       and e["name"] == "serve.client.rpc"}
        client_tids.discard(None)
        assert len(client_tids) > 10
        replica = [e for e in evs if e.get("ph") == "X" and e["pid"] != me
                   and e["name"] in ("serve.rpc", "serve.queue_wait",
                                     "serve.execute")]
        stitched = {(e.get("args") or {}).get("trace_id") for e in replica}
        stitched.discard(None)
        assert stitched and stitched <= client_tids
        assert corpse in {e["pid"] for e in replica}
        route = {(e.get("args") or {}).get("trace_id") for e in evs
                 if e["name"] == "fleet.route"}
        assert stitched & route
        assert [e for e in evs if e.get("ph") == "i" and e["name"] in
                ("fleet.chaos_kill", "fleet.replica_dead")]
        json.dumps(merged)

        # the readers: the front's export, the JSONL evidence and the
        # corpse's last flushed bundle, a lane per pid
        front_trace = obs.export(str(tmp_path / "front.json"))
        last = os.path.join(obs_dir, f"blackbox-{corpse}-last.json")
        assert os.path.exists(last)
        rep = trace_report.report([front_trace, last] + jsonls)
        assert {str(me), str(corpse)} <= set(rep["lanes"])
        bundle = trace_report.report([last])
        assert bundle["lanes"][str(corpse)]["blackbox"] == "flush"
        out = fleet_report.main(["--connect", f"{addr[0]}:{addr[1]}",
                                 "--trace", str(tmp_path / "m.json"),
                                 "--prom", str(tmp_path / "m.prom"),
                                 "--jsonl"] + jsonls + ["--json"])
        assert len(out["parts"]) >= 3 and "slo" in out
    finally:
        if front is not None:
            front.stop()
        pool.stop()
        obs.disable()
        obs.reset()
