"""The port's fault injectors (``mxnet_tpu_torch/chaos/``) against the
reference's: the cases of ``tests/test_chaos.py`` on the port's PS server
and client (exactly once under dropped replies and requests, duplicated
frames, sparse pushes and barriers; kill points; three ``chaos_kill``
resumes bitwise), ``MXNET_CHAOS_RPC`` strings firing the same occurrences
in both packages, the PS-SIGKILL flagship
(``tests/test_elastic.py``'s ``ps:post_apply`` warm restart), a
``ProcReplica`` killed at ``serve:infer_pre_reply`` failing over, and a
checkpoint writer killed at ``ckpt:pre_rename`` leaving the last valid
checkpoint. Every subprocess has a timeout."""
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mxnet_tpu_torch.chaos import rpc as chaos_rpc
from mxnet_tpu_torch.chaos.proc import run_to_completion, run_until_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    """A child's environment: the port importable from anywhere, one
    intra-op thread (children run side by side), no inherited chaos."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("MXNET_CHAOS_KILL", "MXNET_CHAOS_RPC", "MXNET_TSAN"):
        env.pop(k, None)
    env.update(extra)
    return env


@pytest.fixture
def ps_pair():
    """A started PSServer + connected PSClient; chaos rules cleared around
    each test so injected faults can't leak."""
    from mxnet_tpu_torch.kvstore.ps_client import PSClient
    from mxnet_tpu_torch.kvstore.ps_server import PSServer

    chaos_rpc.reset()
    srv = PSServer(host="127.0.0.1", port=0, num_workers=1)
    srv.start()
    cli = PSClient("127.0.0.1", srv.port, timeout=5, retries=6,
                   retry_interval=0.05)
    yield srv, cli
    chaos_rpc.reset()
    srv.stop()


# ---------------------------------------------------------------------------
# exactly-once pushes under injected connection faults (satellite)
# ---------------------------------------------------------------------------

def test_push_exactly_once_under_dropped_reply(ps_pair):
    """Drop the PUSH_SEQ reply: the server HAS applied the gradient, the
    client retries — the (client_id, seq) dedup must keep it applied exactly
    once (w == 1, not 2)."""
    srv, cli = ps_pair
    cli.init("w", np.zeros(4, np.float32))
    chaos_rpc.configure([chaos_rpc.Rule("push_seq", "drop_reply", {1})])
    cli.push("w", np.ones(4, np.float32))
    chaos_rpc.reset()
    np.testing.assert_array_equal(cli.pull("w"), np.ones(4, np.float32))


def test_push_exactly_once_under_dropped_request(ps_pair):
    """Drop the request instead: the server never saw attempt 1, so the
    retry is the first application — still exactly once."""
    srv, cli = ps_pair
    cli.init("w", np.zeros(4, np.float32))
    chaos_rpc.configure([chaos_rpc.Rule("push_seq", "drop_request", {1})])
    cli.push("w", np.ones(4, np.float32))
    chaos_rpc.reset()
    np.testing.assert_array_equal(cli.pull("w"), np.ones(4, np.float32))


def test_push_exactly_once_under_duplicated_frame(ps_pair):
    """A duplicating network sends the same frame twice back-to-back; the
    second copy carries the same seq and must be acked without re-applying."""
    srv, cli = ps_pair
    cli.init("w", np.zeros(4, np.float32))
    chaos_rpc.configure([chaos_rpc.Rule("push_seq", "dup", {1})])
    cli.push("w", np.ones(4, np.float32))
    chaos_rpc.reset()
    np.testing.assert_array_equal(cli.pull("w"), np.ones(4, np.float32))


def test_sparse_push_exactly_once_under_dropped_reply(ps_pair):
    """The sparse path (PUSH_SPARSE_SEQ) carries the same (client_id, seq)
    dedup: a retried row update lands exactly once."""
    srv, cli = ps_pair
    cli.init("emb", np.zeros((5, 3), np.float32))
    chaos_rpc.configure([chaos_rpc.Rule("push_sparse_seq", "drop_reply", {1})])
    cli.push_row_sparse("emb", np.array([1, 3], np.int32),
                        np.ones((2, 3), np.float32))
    chaos_rpc.reset()
    out = cli.pull("emb")
    expect = np.zeros((5, 3), np.float32)
    expect[[1, 3]] = 1.0
    np.testing.assert_array_equal(out, expect)


def test_sparse_push_exactly_once_under_duplicated_frame(ps_pair):
    srv, cli = ps_pair
    cli.init("emb", np.zeros((4, 2), np.float32))
    chaos_rpc.configure([chaos_rpc.Rule("push_sparse_seq", "dup", {1})])
    cli.push_row_sparse("emb", np.array([0, 0], np.int32),
                        np.full((2, 2), 2.0, np.float32))
    chaos_rpc.reset()
    # duplicate indices within ONE push still accumulate (np.add.at), but
    # the duplicated FRAME must not double that
    expect = np.zeros((4, 2), np.float32)
    expect[0] = 4.0
    np.testing.assert_array_equal(cli.pull("emb"), expect)


def test_interleaved_drops_converge_to_exact_sum(ps_pair):
    """A lossy session: several pushes with replies dropped at assorted
    occurrences — the final weight equals the exact sum of all gradients."""
    srv, cli = ps_pair
    cli.init("w", np.zeros(3, np.float32))
    chaos_rpc.configure([
        chaos_rpc.Rule("push_seq", "drop_reply", {2, 5}),
        chaos_rpc.Rule("push_seq", "drop_request", {7}),
    ])
    total = np.zeros(3, np.float32)
    for i in range(1, 6):
        g = np.full(3, float(i), np.float32)
        cli.push("w", g)
        total += g
    chaos_rpc.reset()
    np.testing.assert_array_equal(cli.pull("w"), total)


# ---------------------------------------------------------------------------
# idempotent barrier (satellite)
# ---------------------------------------------------------------------------

def test_barrier_idempotent_under_dropped_reply(ps_pair):
    """A lost barrier ack triggers a retry carrying the same epoch token;
    the server re-acks from its released set instead of double-entering.
    The follow-up barrier would hang (count leak) if the retry had been
    counted as a second arrival."""
    srv, cli = ps_pair
    chaos_rpc.configure([chaos_rpc.Rule("barrier", "drop_reply", {1})])
    cli.barrier(timeout=10.0)
    chaos_rpc.reset()
    cli.barrier(timeout=10.0)  # next round must still work
    assert srv._barrier_count == 0


def test_barrier_two_workers_with_lost_replies(ps_pair):
    """Both workers lose their first barrier ack; both retries must be
    deduped and round 2 must complete inside the straggler window."""
    from mxnet_tpu_torch.kvstore.ps_client import PSClient
    from mxnet_tpu_torch.kvstore.ps_server import PSServer

    srv = PSServer(host="127.0.0.1", port=0, num_workers=2,
                   barrier_timeout=15.0)
    srv.start()
    clients = [PSClient("127.0.0.1", srv.port, timeout=5, retries=6,
                        retry_interval=0.05) for _ in range(2)]
    # rules are process-wide; occurrence counters are thread-local, so each
    # worker thread drops ITS first reply
    chaos_rpc.configure([chaos_rpc.Rule("barrier", "drop_reply", {1})])
    errs = []

    def _rounds(cli):
        try:
            cli.barrier(timeout=20.0)
            cli.barrier(timeout=20.0)
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=_rounds, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    chaos_rpc.reset()
    srv.stop()
    assert not errs, errs
    assert srv._barrier_count == 0


def test_rpc_rules_count_occurrences_independently():
    """Two rules targeting the same (op, action) at different occurrences
    must each see every matching event once — a shared counter would make
    occurrence specs drift (the determinism contract)."""
    from mxnet_tpu_torch.kvstore.ps_server import OP_PUSH

    chaos_rpc.configure([chaos_rpc.Rule("push", "dup", {1}),
                         chaos_rpc.Rule("push", "dup", {3})])
    try:
        verdicts = [chaos_rpc.on_send(OP_PUSH, "k") for _ in range(4)]
        assert verdicts == ["dup", None, "dup", None]
    finally:
        chaos_rpc.reset()


# ---------------------------------------------------------------------------
# kill points (process-level injection)
# ---------------------------------------------------------------------------

def test_kill_point_sigkills_at_occurrence():
    code = (
        "from mxnet_tpu_torch.chaos.proc import kill_point\n"
        "for i in range(5):\n"
        "    kill_point('loop')\n"
        "    print('survived', i, flush=True)\n"
        "print('done', flush=True)\n")
    env = dict(os.environ)
    env["MXNET_CHAOS_KILL"] = "loop@3"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL
    assert "survived 1" in out.stdout and "survived 2" not in out.stdout


def test_kill_point_noop_when_unset():
    from mxnet_tpu_torch.chaos.proc import kill_point, reset_kill_points

    old = os.environ.pop("MXNET_CHAOS_KILL", None)
    reset_kill_points()
    try:
        for _ in range(3):
            kill_point("anything")  # must be a cheap no-op
    finally:
        if old is not None:
            os.environ["MXNET_CHAOS_KILL"] = old
        reset_kill_points()



# ---------------------------------------------------------------------------
# MXNET_CHAOS_RPC strings: the same occurrences fire in both packages
# ---------------------------------------------------------------------------

_SPECS = ["push_seq:drop_reply@1", "push_seq:drop_reply@2,5;"
          "push_seq:drop_request@7", "pull:delay@2:0.001;push:dup@1,3",
          "barrier:drop_reply@1;infer:dup@2;infer:drop_reply@3",
          "push_sparse_seq:dup"]
_OPS = ["push_seq", "pull", "push", "barrier", "push_sparse_seq", "infer",
        "push_seq", "push", "pull", "infer", "push_seq", "infer", "push",
        "push_seq", "push_seq", "push_seq", "barrier", "push_sparse_seq"]


def _fire_trace(rpc_mod, spec):
    """Each op's send verdict and whether its reply is dropped, with the
    rules from ``spec`` (the env path's parser, installed directly)."""
    import mxnet_tpu.kvstore.ps_server  # noqa: F401  (registers PS names)
    import mxnet_tpu.serve.server  # noqa: F401  (and the serve names)
    import mxnet_tpu_torch.kvstore.ps_server  # noqa: F401
    import mxnet_tpu_torch.serve.server  # noqa: F401

    by_name = {v: k for k, v in rpc_mod.OP_NAMES.items()}
    rpc_mod.configure(rpc_mod.parse_env(spec))
    out = []
    try:
        for op in _OPS:
            code = by_name[op]
            try:
                send = rpc_mod.on_send(code, "k")
            except ConnectionError:
                send = "dropped"
            try:
                rpc_mod.on_reply(code, "k")
                reply = "ok"
            except ConnectionError:
                reply = "dropped"
            out.append((op, send, reply))
    finally:
        rpc_mod.reset()
    return out


@pytest.mark.parametrize("spec", _SPECS)
def test_chaos_rpc_specs_fire_like_the_reference(spec):
    from mxnet_tpu.chaos import rpc as jrpc

    mine = _fire_trace(chaos_rpc, spec)
    assert mine == _fire_trace(jrpc, spec)
    assert any(s is not None or r != "ok" for _, s, r in mine)
    assert [repr(r) for r in chaos_rpc.parse_env(spec)] == \
        [repr(r) for r in jrpc.parse_env(spec)]


def test_op_names_cover_both_planes_like_the_reference():
    import mxnet_tpu.kvstore.ps_server  # noqa: F401
    import mxnet_tpu.serve.server  # noqa: F401
    import mxnet_tpu_torch.kvstore.ps_server  # noqa: F401
    import mxnet_tpu_torch.serve.server  # noqa: F401
    from mxnet_tpu.chaos import rpc as jrpc

    assert chaos_rpc.OP_NAMES == jrpc.OP_NAMES


# ---------------------------------------------------------------------------
# three chaos_kill resumes, bitwise (subprocesses, side by side)
# ---------------------------------------------------------------------------

_RESUMES = {"rename": (9, "ckpt:pre_rename@2"), "before_first_ckpt": (1, "")}


@pytest.fixture(scope="module")
def chaos_kill_runs(tmp_path_factory):
    """The orchestrator's own three legs for a kill at step 7, as a user
    runs it (its reference and victim side by side, then the resume) and,
    beside it, each other scenario's victim (SIGKILLed at its step, and at
    its kill point) and resumed run, one after the other: at most three
    workers at a time. The final parameters' bytes of the orchestrator's
    reference and of each resumed run."""
    from mxnet_tpu_torch.tools import chaos_kill as ck

    root = tmp_path_factory.mktemp("chaos_kill")

    def cmd(d):
        return [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_kill",
                "--train", "--ckpt-dir", str(d), "--device", "cpu"]

    def scenario(name):
        step, kill = _RESUMES[name]
        d = root / name
        d.mkdir()
        extra = {"MXNET_CHAOS_KILL": kill} if kill else {}
        rc, out = run_until_step(cmd(d), step, env=_env(**extra),
                                 timeout=240)
        assert rc == -signal.SIGKILL, out[-3000:]
        rc, out = run_to_completion(cmd(d), env=_env(), timeout=240)
        assert rc == 0 and "TRAIN_DONE" in out, out[-3000:]
        return (d / ck.FINAL).read_bytes()

    def scenarios():
        return {n: scenario(n) for n in sorted(_RESUMES)}

    def orchestrator():
        d = root / "cli"
        out = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_kill",
             "--kill-at-step", "7", "--device", "cpu", "--ckpt-dir",
             str(d)], env=_env(), cwd=str(root), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-3000:]
        assert "BITWISE MATCH" in out.stdout
        return ((d / "ref" / ck.FINAL).read_bytes(),
                (d / "victim" / ck.FINAL).read_bytes())

    with ThreadPoolExecutor(2) as ex:
        cli = ex.submit(orchestrator)
        runs = ex.submit(scenarios)
        ref, step7 = cli.result()
        return ref, {**runs.result(), "step7": step7}


@pytest.mark.parametrize("name", ["step7", *sorted(_RESUMES)])
def test_chaos_kill_resume_bitwise(chaos_kill_runs, name):
    """SIGKILL at a step (and, in ``rename``, the writer at its second
    commit's ``ckpt:pre_rename`` first), then ``resume="auto"``: the final
    parameters are byte-identical to the orchestrator's uninterrupted
    run's (``step7``: the orchestrator's own resumed run)."""
    ref, runs = chaos_kill_runs
    assert runs[name] == ref


# ---------------------------------------------------------------------------
# the PS-SIGKILL flagship: ps:post_apply, warm restart, exactly once
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_ps(port, snapshot_dir, **extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.kvstore.ps_server",
         "--port", str(port), "--snapshot-dir", str(snapshot_dir),
         "--snapshot-period", "0.5"],
        env=_env(**extra), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if "listening" in line:
            threading.Thread(target=proc.stdout.read, daemon=True).start()
            return proc
        if not line and proc.poll() is not None:
            break
    proc.kill()
    raise AssertionError("the PS server child did not start")


def test_flagship_ps_sigkill_mid_push_warm_restart_exactly_once(tmp_path):
    """SIGKILL the PS server with an update applied and logged but unacked
    (``ps:post_apply@3``), warm-restart it from its snapshot and WAL, with
    one more reply dropped by ``chaos.rpc``: the final weight equals the
    gradients summed in push order, bitwise (the sanitizer on in both
    server processes)."""
    from mxnet_tpu_torch.kvstore.ps_client import PSClient

    port = _free_port()
    snap = tmp_path / "ps_state"
    ps = _spawn_ps(port, snap, MXNET_CHAOS_KILL="ps:post_apply@3",
                   MXNET_TSAN="1")
    restarted = threading.Event()
    procs = [ps]

    def _supervisor():
        ps.wait()
        if ps.returncode == -signal.SIGKILL:
            procs.append(_spawn_ps(port, snap, MXNET_TSAN="1"))
            restarted.set()

    sup = threading.Thread(target=_supervisor, daemon=True)
    sup.start()
    chaos_rpc.configure([chaos_rpc.Rule("push_seq", "drop_reply", {5})])
    try:
        cli = PSClient("127.0.0.1", port, timeout=10, retries=14,
                       retry_interval=0.5, retry_max_interval=3.0)
        cli.init("w", np.zeros(3, np.float32))
        rng = np.random.RandomState(0)
        total = np.zeros(3, np.float32)
        for _ in range(6):
            g = rng.randn(3).astype(np.float32)
            cli.push("w", g)  # push 3 kills the server post-apply
            total += g
        sup.join(timeout=120)
        assert restarted.is_set(), "the server was never killed and restarted"
        np.testing.assert_array_equal(cli.pull("w"), total)
    finally:
        chaos_rpc.reset()
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait(timeout=10)


# ---------------------------------------------------------------------------
# a ProcReplica killed mid-INFER-reply fails over
# ---------------------------------------------------------------------------

def test_kill_mid_infer_reply_fails_over_within_deadline(tmp_path):
    """``MXNET_CHAOS_KILL_REPLICA0="serve:infer_pre_reply@1"``: replica 0's
    child dies with its first answer computed but unsent; every request
    succeeds within its deadline through the other replica, and the pool
    restarts the child (tests/test_fleet.py's case on the port)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import nd, serve, symbol as sym
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch.serve import ServeServer
    from mxnet_tpu_torch.serve.fleet import (LocalReplica, ProcReplica,
                                             ReplicaPool, Router)

    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    prefix = os.path.join(str(tmp_path), "lin")
    with tmx.cpu():
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=4,
                                 no_bias=True, name="fc")
        save_checkpoint(prefix, 0, net,
                        {"fc_weight": nd.array(np.eye(4, dtype=np.float32))},
                        {})

    def local():
        engine = serve.load(prefix, epoch=0, max_batch_size=8, lint="off",
                            ctx=tmx.cpu())
        srv = ServeServer(engine, port=0, max_linger_ms=0.0)
        srv.start()
        return srv

    env = {"MXNET_SERVE_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "MXNET_CHAOS_KILL_REPLICA0": "serve:infer_pre_reply@1"}
    pool = ReplicaPool([ProcReplica(prefix, env=env), LocalReplica(local)],
                       probe_interval=0.2, backoff_base=0.1, backoff_cap=1.0,
                       ready_timeout=120).start()
    try:
        router = Router(pool, breaker_cooldown=0.3)
        t0 = time.monotonic()
        deadline_ms = 20000.0
        for _ in range(6):
            outs, _ = router.infer([x], deadline_ms=deadline_ms)
            np.testing.assert_array_equal(outs[0], x)
        assert (time.monotonic() - t0) * 1e3 < deadline_ms
        assert router.failovers >= 1  # the mid-reply kill was absorbed
        deadline = time.monotonic() + 90
        while ((len(pool.ready_members()) < 2
                or pool.members()[0].restarts < 1)
               and time.monotonic() < deadline):
            time.sleep(0.2)
        assert len(pool.ready_members()) == 2
        assert pool.members()[0].restarts >= 1
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# a writer killed at ckpt:pre_rename leaves the last valid checkpoint
# ---------------------------------------------------------------------------

_WRITER = """
import sys
import numpy as np
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.checkpoint.state import TrainingState
mgr = CheckpointManager(sys.argv[1], async_write=False)
for step in (1, 2, 3):
    mgr.save(TrainingState({"arg:w": np.full(4, step, np.float32)},
                           {"format": 1}), step)
    print("saved", step, flush=True)
"""


@pytest.mark.parametrize("point,survivors", [
    ("ckpt:post_arrays@2", [1]), ("ckpt:pre_rename@2", [1]),
    ("ckpt:post_rename@2", [1, 2])])
def test_writer_killed_at_kill_point_leaves_last_valid(tmp_path, point,
                                                        survivors):
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    out = subprocess.run([sys.executable, "-c", _WRITER, str(tmp_path)],
                         env=_env(MXNET_CHAOS_KILL=point), cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL, out.stdout[-2000:]
    assert "saved 1" in out.stdout and "saved 2" not in out.stdout
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    try:
        assert mgr.list_steps() == survivors
        state = mgr.load_latest()
        np.testing.assert_array_equal(
            np.asarray(state.arrays["arg:w"]),
            np.full(4, survivors[-1], np.float32))
        # the torn commit's staging directory is swept at the next start
        assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    finally:
        mgr.close()
