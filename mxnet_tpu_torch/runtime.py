"""``mx.runtime`` — compiled-feature introspection and the environment
registry (counterpart of ``mxnet_tpu/runtime.py``).

Reference: ``src/libinfo.cc`` → ``mx.runtime.feature_list()``. Features
report this build: ``CUDA``, ``CUDNN`` and ``NCCL`` come from torch; the
TPU build's ``TPU``, ``XLA``, ``PALLAS`` and ``PJIT`` are False.

``_ENV_REGISTRY`` has one row per environment knob the port reads (the
data-plane lint's ``env-registry-drift`` rule holds every ``MXNET_*``
read of ``mxnet_tpu_torch/`` against it, both ways); ``env_list()``
reports it with the current values.
"""
from __future__ import annotations

from collections import namedtuple

__all__ = ["Feature", "feature_list", "Features", "is_enabled",
           "EnvVar", "env_list", "env_doc"]

Feature = namedtuple("Feature", ["name", "enabled"])


def _detect():
    import torch

    cuda = torch.cuda.is_available()
    nccl = False
    if cuda:
        try:
            import torch.distributed as dist

            nccl = dist.is_available() and dist.is_nccl_available()
        except (ImportError, AttributeError):
            nccl = False
    return {
        "TPU": False,
        "CPU": True,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": nccl,
        "XLA": False,
        "PALLAS": False,
        "PJIT": False,
        "SHARD_MAP": False,
        "RING_ATTENTION": True,
        "BF16": True,
        "INT8": True,
        "OPENCV": False,
        "PIL": _has("PIL"),
        "DIST_KVSTORE": True,
        "PS_DIST_ASYNC": True,
        "SIGNAL_HANDLER": True,
        "PROFILER": True,
    }


def _has(mod):
    try:
        __import__(mod)
        return True
    except ImportError:
        return False


def feature_list():
    return [Feature(k, v) for k, v in _detect().items()]


class Features(dict):
    def __init__(self):
        super().__init__({k: Feature(k, v) for k, v in _detect().items()})

    def is_enabled(self, name):
        return self.get(name, Feature(name, False)).enabled


def is_enabled(name):
    return Features().is_enabled(name)


# ---------------------------------------------------------------------------
# Environment-variable registry (the reference's documented MXNET_*
# surface, docs .../env_var.md). Every knob the port reads is declared
# here with its default and meaning. Knobs of modules not ported yet get
# their rows with them; the reference's JAX-only knobs (the jax platform
# pin, the XLA compile cache, buffer donation) do not apply here.
# ---------------------------------------------------------------------------

EnvVar = namedtuple("EnvVar", ["name", "default", "description", "current"])

_ENV_REGISTRY = {
    # core
    "MXNET_SEED": (None, "Global RNG seed (torch generator + numpy init "
                         "stream; reference MXNET_SEED)."),
    "MXNET_ENGINE_TYPE": (None, "Set to 'NaiveEngine' for synchronous "
                                "execution (wait for the card after every "
                                "op) — the reference's serial debug "
                                "engine."),
    "MX_SYNC": ("0", "1 = wait for the card after every eager op (race "
                     "debugging; alias of NaiveEngine mode)."),
    "MXNET_ATTENTION_IMPL": ("auto", "auto|plain|flash — fused-attention "
                             "dispatch policy (ops/attention.py); any "
                             "other value raises."),
    "MXNET_TEST_DEFAULT_CTX": (None, "Context for test_utils.default_context,"
                               " e.g. 'cpu' or 'gpu:0'."),
    "MXNET_NO_NATIVE_BUILD": (None, "1 = never build the native C++ "
                              "components (the JPEG record decoder, the "
                              "PS server); PIL/python fallbacks."),
    "MXNET_GRAPH_LINT": ("off", "off|warn|error — graph-lint severity "
                         "when an executor binds a symbolic graph."),
    "MXNET_FLASH_BLOCK_Q": (None, "Flash-attention Q tile of the plain "
                            "version (default 512, shrunk to divide S); "
                            "the CUDA kernels keep their own tiles."),
    "MXNET_FLASH_BLOCK_K": (None, "Flash-attention K tile of the plain "
                            "version."),
    "MXNET_FLASH_BWD": ("auto", "auto|kernel|plain — flash-attention "
                        "backward: the CUDA kernel on a card tensor, the "
                        "plain version, or the kernel only."),
    "MXNET_FUSED_UPDATE": ("1", "0 = bypass the fused optimizer-update "
                           "engine and run the eager per-array oracle "
                           "(optimizer/fused.py)."),
    # telemetry core (obs/__init__.py, obs/trace.py, obs/context.py,
    # serve/fleet.py)
    "MXNET_OBS": (None, "1 = enable the telemetry plane at import "
                  "(metrics registry, tracer, exporters)."),
    "MXNET_OBS_JSONL": (None, "Telemetry JSONL stream path (implies "
                        "MXNET_OBS=1); %p expands to the pid at the "
                        "child's obs import."),
    "MXNET_OBS_DIR": (None, "Fleet supervisor: directory for per-replica "
                      "telemetry streams and blackbox bundles."),
    "MXNET_OBS_BUFFER": ("65536", "Tracer ring capacity (retained "
                         "spans)."),
    "MXNET_OBS_SAMPLE": (None, "Head-based sampling probability for new "
                         "trace roots, 0..1 (default 1.0; children "
                         "inherit the root's verdict)."),
    "MXNET_OBS_WIRE": ("1", "0 = never put trace context on the wire "
                       "(escape hatch for old peers)."),
    # fault injection (chaos/)
    "MXNET_CHAOS_KILL": (None, "Chaos: SIGKILL this process at counted "
                         "guard-point hits, e.g. 'ckpt:pre_rename@3'. The "
                         "port's CheckpointManager refuses it: the kill "
                         "points are queue item A15(f)."),
    "MXNET_CHAOS_NAN": (None, "Chaos: poison a named tensor with NaN at "
                        "counted forward occurrences, e.g. 'data@5' "
                        "(chaos/nan.py — tests the breach/provenance/"
                        "rollback chain deterministically)."),
    "MXNET_CHAOS_SLOW": (None, "Chaos: delay a named rank's step phase at "
                         "counted occurrences, e.g. '1:forward@5-40:0.25' "
                         "(chaos/slow.py — proves the straggler detector "
                         "flags the injected rank AND phase). The seconds "
                         "field also takes a 'base+step' ramp, e.g. "
                         "'1:forward@5-40:0.1+0.02'."),
    # device-plane observability (obs/device.py)
    "MXNET_DEVICE_COST": (None, "1 = force device-cost capture at every "
                          "first-run site (0 = veto); default follows the "
                          "obs telemetry flag."),
    "MXNET_DEVICE_PEAK_TFLOPS": (None, "Peak compute rate used by analytic "
                                 "MFU/roofline math (overrides the card's "
                                 "data-sheet default)."),
    "MXNET_DEVICE_PEAK_GBPS": (None, "Peak memory bandwidth for the "
                               "roofline balance point."),
    "MXNET_OBS_MEMORY": ("1", "0 = skip the per-batch device.live_bytes "
                         "sampling even with telemetry on."),
    "MXNET_DEVICE_LEAK_WINDOW": ("10", "Leak-detector sliding window "
                                 "(samples)."),
    "MXNET_DEVICE_LEAK_BYTES_PER_STEP": (str(1 << 20), "Leak-detector "
                                         "slope threshold (bytes/step)."),
    # training-health plane (obs/health.py)
    "MXNET_OBS_HEALTH": (None, "1 = force the training-health plane's "
                         "numerics stats on (0 = veto); default: on while "
                         "a HealthMonitor is attached to a training "
                         "loop."),
    "MXNET_OBS_HEALTH_EVERY": ("10", "Health sampling period K: the "
                               "sentinel reads the device-resident stats "
                               "in one host copy every K optimizer "
                               "steps."),
    # training-fleet telemetry plane (obs/fleetstats.py)
    "MXNET_OBS_FLEET": (None, "0 = veto the training-fleet plane (per-rank "
                        "step-phase windows, heartbeat piggyback, "
                        "straggler detection) even with MXNET_OBS=1; it "
                        "is on by default whenever telemetry records."),
    "MXNET_OBS_FLEET_WINDOW": ("10", "Optimizer steps per accounting "
                               "window; windows seal at multiples of "
                               "this and ship on the next heartbeat."),
    "MXNET_OBS_FLEET_FACTOR": ("1.5", "Straggler threshold: a rank whose "
                               "own time (step minus reduce-wait) "
                               "exceeds the fleet median by this factor "
                               "is lagging."),
    "MXNET_OBS_FLEET_K": ("3", "Consecutive lagging windows before a "
                          "straggler verdict fires (and, symmetrically, "
                          "recovered windows before it clears)."),
    "MXNET_OBS_FLEET_SHIP_S": ("2", "Max seconds between heartbeat-"
                               "piggybacked telemetry ships when no new "
                               "window sealed (spans still flow)."),
    "MXNET_OBS_FLEET_MAX_SPANS": ("4096", "Newest spans kept per "
                                  "piggybacked ship."),
    "MXNET_OBS_FLEET_HOT_KEYS": ("32", "Capacity of the PS server's "
                                 "bounded top-N hot-key table "
                                 "(space-saving admission)."),
    # black-box plane (obs/tail.py, obs/profile.py, obs/blackbox.py)
    "MXNET_OBS_TAIL": (None, "1 = tail-based trace retention: the "
                       "keep-or-drop decision moves to root-span close "
                       "(latency/outcome/budget policy) instead of the "
                       "head-sampling coin flip."),
    "MXNET_OBS_TAIL_SLOW_MS": ("250", "Root latency at or above this is "
                               "'interesting' — retained while the "
                               "token-bucket budget has tokens."),
    "MXNET_OBS_TAIL_BUDGET": ("20", "Token-bucket refill rate: "
                              "interesting-trace retentions per second "
                              "(burst = 2x)."),
    "MXNET_OBS_TAIL_BASELINE": ("0.01", "Uniform keep probability applied "
                                "regardless of policy."),
    "MXNET_OBS_TAIL_TRACES": ("512", "Max traces pending a verdict "
                              "(oldest evicted past it)."),
    "MXNET_OBS_TAIL_SPANS": ("256", "Max held spans per pending trace."),
    "MXNET_OBS_TAIL_HOLD_S": ("20", "Replica-side hold window: pending "
                              "spans past it expire if no verdict "
                              "arrived over the telemetry plane."),
    "MXNET_OBS_PROF": (None, "1 = start the continuous sampling profiler "
                       "at import (phase-tagged stack samples, "
                       "collapsed-stack + chrome-trace exports)."),
    "MXNET_OBS_PROF_HZ": ("67", "Profiler sampling rate (Hz), off the "
                          "10ms-timer beat."),
    "MXNET_OBS_PROF_DEPTH": ("48", "Max folded-stack depth (innermost "
                             "frames win)."),
    "MXNET_OBS_PROF_BUFFER": ("65536", "Raw sample ring capacity (the "
                              "flight recorder's profiler slice)."),
    "MXNET_OBS_BLACKBOX": (None, "1 = arm the crash flight recorder: a "
                           "ring of recent spans/metrics/profiler stacks "
                           "dumped as a bundle on fatal signals, "
                           "SLO/health breaches, or OP_DUMP."),
    "MXNET_OBS_BLACKBOX_DIR": (None, "Bundle directory (setting it also "
                               "arms the recorder); the periodic "
                               "blackbox-<pid>-last.json flush lands "
                               "here — the SIGKILL artifact."),
    "MXNET_OBS_BLACKBOX_EVENTS": ("4096", "Flight-recorder ring capacity "
                                  "(most recent telemetry events)."),
    "MXNET_OBS_BLACKBOX_FLUSH_S": ("2", "Periodic last-bundle rewrite "
                                   "interval."),
    "MXNET_OBS_BLACKBOX_COOLDOWN_S": ("30", "Min seconds between automatic "
                                      "dumps."),
    "MXNET_OBS_BLACKBOX_PROF_S": ("10", "Seconds of profiler samples a "
                                  "bundle embeds."),
    # persistent program cache (progcache.py)
    "MXNET_PROGCACHE": (None, "1 = arm the persistent program cache at "
                        "the default dir; 0 = veto even with a dir set. "
                        "Holds the kernels' nvcc-built libraries and the "
                        "serve/decode/update program records."),
    "MXNET_PROGCACHE_DIR": (None, "Program-cache directory (setting it "
                            "arms the cache). Inherited by ProcReplica "
                            "children; a stale/foreign/corrupt entry is a "
                            "counted reject that degrades to a fresh "
                            "build."),
    "MXNET_PROGCACHE_KEEP": ("128", "Keep-last-N GC bound: most recently "
                             "used entries kept."),
    # autoregressive decode engine (serve/decode.py)
    "MXNET_DECODE_SLOTS": ("8", "Decode-step batch width: concurrent "
                           "generations per replica, fixed at engine "
                           "construction (idle slots park on the scratch "
                           "page)."),
    "MXNET_DECODE_PAGE_SIZE": ("16", "KV-cache page size in tokens. "
                               "Every prompt bucket is a multiple of it."),
    "MXNET_DECODE_PAGES": ("64", "KV page-pool capacity (page 0 is the "
                           "reserved scratch page)."),
    "MXNET_DECODE_MAX_NEW": ("64", "Default max new tokens per "
                             "generation when the request does not cap "
                             "it."),
    "MXNET_DECODE_TIMEOUT": ("30.0", "Default per-generation deadline "
                             "seconds when the request carries none."),
    "MXNET_DECODE_ATTN": ("auto", "Paged decode-attention path: auto (the "
                          "CUDA kernel on a card tensor, the plain "
                          "version on a CPU tensor), kernel, or plain."),
    # distributed (DMLC_* names kept for launcher compat; base.get_env
    # falls back from MXNET_DMLC_X to DMLC_X, so these rows document the
    # prefixed aliases too)
    "DMLC_ROLE": (None, "worker|server|scheduler — set by tools/launch.py."),
    "DMLC_PS_ROOT_URI": (None, "Coordinator/PS host (reference ps-lite env)."),
    "DMLC_PS_ROOT_PORT": (None, "Coordinator/PS port."),
    "DMLC_NUM_WORKER": ("1", "World size for dist kvstores."),
    "DMLC_WORKER_ID": ("0", "This worker's rank."),
    "MXNET_COORDINATOR": (None, "host:port of the torch.distributed "
                          "rendezvous (overrides DMLC_PS_ROOT_URI/PORT)."),
    "MXNET_NUM_WORKER": ("1", "Alias of DMLC_NUM_WORKER."),
    "MXNET_WORKER_ID": ("0", "Alias of DMLC_WORKER_ID."),
    "MXNET_PS_ADDR": (None, "dist_async parameter-server host (falls back "
                      "to DMLC_PS_ROOT_URI)."),
    "MXNET_PS_PORT": ("9091", "dist_async parameter-server port."),
    "MXNET_SERVE_PLATFORM": (None, "cpu|gpu placement pin for a serve "
                             "replica process (unset = the default "
                             "context, the card)."),
    "MXNET_MESH_LM": (None, "JSON kwargs of transformer_lm that cut the "
                      "LM of tools/mesh_worker.py's LM scenarios (e.g. "
                      "for a CPU rehearsal)."),
    # elastic training
    "MXNET_ELASTIC": (None, "1 = elastic dist_sync: reductions ride the PS "
                      "wire scoped to the live membership generation; a "
                      "dead worker releases barriers over survivors, a "
                      "restarted one rejoins from the shared checkpoint "
                      "(kvstore/elastic.py; launch.py -e)."),
    "MXNET_ELASTIC_HEARTBEAT_S": ("0.5", "Worker heartbeat interval; also "
                                  "the PS liveness-monitor sweep period."),
    "MXNET_ELASTIC_MISS_K": ("4", "Missed heartbeats before the PS "
                             "declares a worker dead and bumps the "
                             "membership generation."),
    "MXNET_ELASTIC_JOIN_TIMEOUT_S": ("600", "Max wait for a quarantined "
                                     "rejoiner's epoch-boundary "
                                     "activation (and epoch rendezvous)."),
    "MXNET_ELASTIC_REDUCE_TIMEOUT_S": ("120", "Generation-scoped reduce "
                                       "wait bound (carried in the "
                                       "request)."),
    "MXNET_ELASTIC_ALLOW_STALE_REJOIN": (None, "1 = let a rejoiner whose "
                                         "newest shared checkpoint lags "
                                         "the fleet's epoch proceed "
                                         "anyway (fit raises by "
                                         "default)."),
    # bounded-staleness async training
    "MXNET_ASYNC_STALENESS": (None, "Bounded-staleness async training: a "
                              "worker more than this many steps ahead of "
                              "the fleet's committed-clock floor blocks "
                              "at pull. Unset = classic unbounded "
                              "dist_async."),
    "MXNET_ASYNC_WIDEN": ("2", "Steps added to the staleness bound each "
                          "time the straggler policy widens it for a "
                          "compute-blamed rank."),
    "MXNET_ASYNC_MAX_STALENESS": ("16", "Hard cap on the effective "
                                  "staleness bound."),
    "MXNET_ASYNC_LR_COMP": ("1", "0 = disable worker-side staleness-aware "
                            "lr compensation."),
    "MXNET_ASYNC_GROUP": (None, "Hierarchical reduction group size for "
                          "elastic dist_sync (>1 = group-local scoped "
                          "sum, leaders-only cross-group sum, group "
                          "broadcast). Unset/0 = flat reduce."),
    "MXNET_PS_SNAPSHOT_DIR": (None, "PS durable-state directory: atomic+"
                              "CRC snapshots + push WAL; warm restart "
                              "resumes from the newest valid snapshot "
                              "with the seq-dedup table intact."),
    "MXNET_PS_SNAPSHOT_PERIOD_S": ("5", "Seconds between periodic PS "
                                   "snapshots (0 = only INIT/SET_OPT/"
                                   "shutdown snapshots)."),
    "MXNET_PS_WAL_FSYNC": ("1", "0 = skip the fsync-per-acked-push in the "
                           "PS write-ahead log."),
    "MXNET_PS_IDLE_PING_S": (None, "Idle threshold (seconds) after which "
                             "the PS client pings before reusing a "
                             "connection (half-open detection; needs a "
                             "python server)."),
}


def env_list():
    """All registered env vars with defaults, docs, and current values."""
    import os

    return [EnvVar(k, d, doc, os.environ.get(k)) for k, (d, doc)
            in sorted(_ENV_REGISTRY.items())]


def env_doc(name):
    d, doc = _ENV_REGISTRY[name]
    return f"{name} (default {d!r}): {doc}"
