"""The one place the port reads the process environment
(≙ splatt_tpu/utils/env.py, cut to the variables the port reads).

Every variable is declared once in :data:`ENV_VARS` (name → default →
doc) with the JAX package's default, and read through :func:`read_env`.
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple, Optional


class EnvVar(NamedTuple):
    """One declared environment variable: its default (None = unset)
    and a one-line doc string."""

    default: Optional[object]
    doc: str


ENV_VARS = {
    "SPLATT_ENGINE_FALLBACK": EnvVar("1", "runtime MTTKRP engine "
                                     "fallback; 0/off/false/no = fail "
                                     "loudly"),
    "SPLATT_EXPERIMENTAL_FUSED": EnvVar(None, "1 adds the row-major "
                                        "fused kernel (engine 'fused') "
                                        "to the engine chain"),
    "SPLATT_FAULTS": EnvVar("", "comma-separated fault-arming specs "
                            "site[:kind][:modifier]... for the fault-"
                            "injection harness (utils/faults.py)"),
    "SPLATT_IDX_WIDTH": EnvVar("i32", "blocked-layout index width: i32 = "
                               "v1 global int32 ids; auto = compact v2 "
                               "(per-block local ids, uint16 where each "
                               "mode's block extent fits, int32 "
                               "otherwise, plus int32 per-block bases); "
                               "u16 = v2 requiring uint16 everywhere; "
                               "u8 = v2 with the sorted mode's segment "
                               "ids at uint8 (every block span must fit "
                               "255); delta = v2 with the gather modes "
                               "as within-block differences at the "
                               "narrowest signed width; rle = v2 with "
                               "the sorted mode as per-block run-length "
                               "counts.  Encode failures degrade to v1"),
    "SPLATT_DECODE": EnvVar("kernel", "decode placement for compact "
                            "layouts: kernel = the fused_v2 engine reads "
                            "the encoded streams and decodes in "
                            "registers; prep = decode to global int32 "
                            "before the engine chain (fused_v2 leaves "
                            "it)"),
    "SPLATT_VAL_STORAGE": EnvVar("auto", "blocked-layout value storage: "
                                 "auto = the compute dtype; f32/bf16 pin "
                                 "it.  bf16 stores the values, and the "
                                 "factors derived from them, in bfloat16 "
                                 "with f32 accumulation"),
    "SPLATT_FIBER_PACKING": EnvVar("fixed", "blocked-layout fiber "
                                   "packing (docs/layout-balance.md): "
                                   "fixed = cut the sorted stream every "
                                   "nnz_block nonzeros; balanced = cut "
                                   "at fiber boundaries under a row-span "
                                   "cap, splitting fibers hotter than a "
                                   "block, so skewed tensors stop "
                                   "widening seg_width (a failed pack "
                                   "degrades classified to fixed).  An "
                                   "explicit Options.fiber_packing "
                                   "wins"),
    "SPLATT_REORDER": EnvVar(None, "relabeling applied before the "
                             "blocked layouts are built (docs/layout-"
                             "balance.md): identity | random | graph | "
                             "hgraph | fibsched.  One permutation "
                             "relabels every mode; cpd_als returns the "
                             "factors in the original row order.  An "
                             "explicit Options.reorder wins; a failed "
                             "reorder degrades classified to identity "
                             "(reorder_fallback)"),
    "SPLATT_DENSE": EnvVar("off", "dense-mode tile layout policy "
                           "(docs/dense.md): off = every mode keeps "
                           "the sparse blocked encoding; auto = a "
                           "mode whose padded fiber density crosses "
                           "SPLATT_DENSE_THRESHOLD (and whose dense "
                           "cells stay within the blowup cap) gets a "
                           "dense tile layout and the dense matmul "
                           "engines; on = force the dense tiling for "
                           "every geometrically feasible mode.  Any "
                           "dense build failure degrades classified "
                           "to the sparse encoding (format_fallback, "
                           "site=dense)"),
    "SPLATT_DENSE_THRESHOLD": EnvVar("0.05", "padded per-mode density "
                                     "(nnz / dense tile cells) at or "
                                     "above which SPLATT_DENSE=auto "
                                     "elects the dense tile layout "
                                     "(docs/dense.md)"),
    "SPLATT_HEALTH_RETRIES": EnvVar(3, "numerical-health sentinel "
                                    "rollback budget: how many times a "
                                    "run may restore the last-good "
                                    "snapshot (bumping regularization "
                                    "/ re-randomizing the offending "
                                    "factor) before degrading to "
                                    "checkpoint-and-abort; 0 disables "
                                    "the sentinel and its snapshots"),
    "SPLATT_DEADLINE_S": EnvVar(0.0, "deadline watchdog budget in "
                                "seconds for an engine's first launch "
                                "per shape (resilience.deadline); a "
                                "blown deadline classifies TIMEOUT and "
                                "demotes per shape like an out-of-"
                                "memory; <= 0 disables"),
    "SPLATT_TRACE": EnvVar(None, "1/on/true/yes enables structured "
                           "span recording (trace.py): host-side spans "
                           "(cpd -> sweep -> guard, dispatch, comm) "
                           "exportable as Chrome trace-event JSON via "
                           "--trace <path>.  Off by default: disabled "
                           "spans are no-ops (one boolean check); an "
                           "explicit Options.trace / CLI --trace wins.  "
                           "Event-derived metrics are always on"),
    "SPLATT_TRACE_MAX_RECORDS": EnvVar(100000, "in-memory span/point "
                                       "recorder bound: past this many "
                                       "finished records the oldest "
                                       "are dropped (counted, reported "
                                       "on the trace_written event)"),
    # the flight recorder (trace.py)
    "SPLATT_FLIGHT": EnvVar("auto", "flight recorder, the bounded ring of "
                            "recent spans and point events that survives "
                            "a SIGKILL: auto = armed by fleet-mode serve "
                            "at <root>/fleet/flight/<replica>.jsonl, off "
                            "elsewhere; 0/off disables it in fleet mode "
                            "too; 1/on keeps the fleet default"),
    "SPLATT_FLIGHT_BYTES": EnvVar(1 << 20, "flight recorder: rotate the "
                                  "ring file to <path>.1 once it "
                                  "outgrows this many bytes (one "
                                  "previous generation kept)"),
    "SPLATT_FLIGHT_FLUSH": EnvVar(32, "flight recorder: buffered records "
                                  "per ring-file flush; a SIGKILL loses "
                                  "at most this many trailing records"),
    # status / top (fleetobs.py)
    "SPLATT_STATUS_JOBS": EnvVar(8, "status/top: how many recent terminal "
                                 "jobs the dashboard lists"),
    "SPLATT_STATUS_WATCH_S": EnvVar(2.0, "top / status --watch: seconds "
                                    "between dashboard refreshes"),
    "SPLATT_AUTOTUNE": EnvVar("1", "MTTKRP dispatch consults the "
                              "autotuner's persisted plan cache "
                              "(tune.py) before the heuristic engine "
                              "chain, and BlockedSparse.compile builds "
                              "the layouts at the cached plans; "
                              "0/off/false/no = static heuristics.  An "
                              "explicit Options.autotune wins"),
    "SPLATT_TUNE_CACHE": EnvVar(None, "path of the autotuner's plan "
                                "cache (default: tune_cache.json in "
                                "splatt_tpu_torch/_build/)"),
    "SPLATT_PROBE_CACHE_TTL_S": EnvVar(14 * 24 * 3600.0, "seconds a "
                                       "plan-cache entry stays fresh "
                                       "(the JAX package's probe-cache "
                                       "TTL, which its plan cache "
                                       "shares); <= 0 disables expiry"),
    "SPLATT_COMM": EnvVar(None, "default row-exchange strategy of "
                          "FINE distributed runs: all2all (whole-factor "
                          "gathers and reduces), point2point (the sync "
                          "ring), async_ring (the ring kernels, one "
                          "launch per ring phase; on the CPU it "
                          "degrades classified point2point -> all2all "
                          "on failure); an explicit "
                          "Options.comm_pattern / --comm wins"),
    # the serve daemon (serve.py) and its predict lane (predict.py)
    "SPLATT_SERVE_WORKERS": EnvVar(1, "serve: concurrent job-supervisor "
                                   "threads; each job runs under its own "
                                   "resilience scope, sharing the warm "
                                   "plan cache"),
    "SPLATT_SERVE_QUEUE_MAX": EnvVar(16, "serve: bounded pending-queue "
                                     "depth; a submission past it is "
                                     "load-shed with an explicit "
                                     "queue_full rejection instead of "
                                     "queueing unboundedly; <= 0 disables "
                                     "the bound"),
    "SPLATT_SERVE_POLL_S": EnvVar(0.5, "serve: seconds between filed-"
                                  "request spool scans in the daemon "
                                  "loop"),
    "SPLATT_SERVE_JOB_DEADLINE_S": EnvVar(0.0, "serve: default per-job "
                                          "deadline in seconds (a job "
                                          "spec's deadline_s overrides, 0 "
                                          "= explicit opt-out); a blown "
                                          "job deadline classifies "
                                          "TIMEOUT and the job is marked "
                                          "failed, releasing its worker; "
                                          "<= 0 disables"),
    "SPLATT_SERVE_BATCH_MIN": EnvVar(0, "serve auto-coalescing: when the "
                                     "queue holds >= this many batchable "
                                     "jobs sharing one regime key, a "
                                     "worker dispatches them as one "
                                     "batched CPD (per-job journal "
                                     "lineage, results and quotas kept; "
                                     "a failure degrades classified to "
                                     "per-tensor dispatch); <= 0 "
                                     "disables"),
    "SPLATT_UPDATE_SWEEPS": EnvVar(5, "update jobs: warm-started ALS "
                                   "sweeps an incremental model update "
                                   "runs when its spec gives no iters"),
    "SPLATT_UPDATE_REFIT_EVERY": EnvVar(0, "update jobs: every Nth update "
                                        "of one base model runs a from-"
                                        "scratch refit of the merged "
                                        "tensor instead of the warm path "
                                        "(refit_scheduled event); <= 0 "
                                        "disables the periodic cadence "
                                        "(the health and failure repair "
                                        "paths stay active)"),
    # fleet-mode serve (fleet.py)
    "SPLATT_FLEET_REPLICA": EnvVar(None, "fleet: this replica's stable id "
                                   "(file-name-safe); default is a fresh "
                                   "pid+random id per process, so set it "
                                   "when a restarted replica should keep "
                                   "its identity"),
    "SPLATT_FLEET_LEASE_S": EnvVar(10.0, "fleet: job and membership lease "
                                   "in seconds, the failure-detection "
                                   "horizon: a replica silent this long "
                                   "is dead and live peers adopt its "
                                   "non-terminal jobs"),
    "SPLATT_FLEET_HEARTBEAT_S": EnvVar(0.0, "fleet: seconds between "
                                       "heartbeat and lease-renewal "
                                       "sweeps; <= 0 takes lease / 3"),
    "SPLATT_FLEET_AFFINITY": EnvVar("1", "fleet: cache-affinity routing, "
                                    "jobs prefer the replica whose plan "
                                    "cache and layouts are warm for "
                                    "their shape regime, load breaking "
                                    "ties; 0/off/false/no = priority and "
                                    "arrival order only"),
    "SPLATT_FLEET_TENANT_QUOTA": EnvVar(0, "serve admission control: max "
                                        "non-terminal jobs per tenant; "
                                        "past it submissions are shed "
                                        "with a quota_rejected event; <= "
                                        "0 disables"),
    "SPLATT_PREDICT_QUEUE_MAX": EnvVar(64, "serve predict lane: bounded "
                                       "pending-predict depth, separate "
                                       "from the fit/update queue; a "
                                       "predict past it is load-shed with "
                                       "an explicit queue_full rejection "
                                       "(<= 0 disables the bound)"),
    "SPLATT_PREDICT_CACHE_MAX": EnvVar(8, "predict hot-factor cache: "
                                       "(model, generation) entries kept "
                                       "per daemon, LRU-evicted past the "
                                       "bound; an update commit "
                                       "invalidates by generation "
                                       "advance, never deletion, so a "
                                       "pinned in-flight predict still "
                                       "finishes on its generation; <= 0 "
                                       "disables the cache"),
    "SPLATT_METRICS_PATH": EnvVar(None, "serve: when set, the metrics "
                                  "registry (trace.METRICS) is "
                                  "snapshotted to this file in "
                                  "Prometheus text format on a cadence "
                                  "(SPLATT_METRICS_INTERVAL_S) and at "
                                  "daemon exit, by atomic replace"),
    "SPLATT_METRICS_INTERVAL_S": EnvVar(30.0, "serve: seconds between "
                                        "metrics snapshots to "
                                        "SPLATT_METRICS_PATH; <= 0 "
                                        "snapshots only at daemon exit"),
    # the SLO layer of a daemon's metrics tick (fleetobs.py)
    "SPLATT_SLO_QUEUE_WAIT_P95_S": EnvVar(30.0, "SLO objective: 95% of "
                                          "jobs start within this many "
                                          "seconds of acceptance (the "
                                          "splatt_serve_queue_wait_"
                                          "seconds histogram; the "
                                          "threshold rounds up to a "
                                          "bucket bound)"),
    "SPLATT_SLO_JOB_WALL_P95_S": EnvVar(600.0, "SLO objective: 95% of "
                                        "terminal jobs finish within this "
                                        "many wall seconds (the "
                                        "splatt_job_seconds histogram)"),
    "SPLATT_SLO_AVAILABILITY": EnvVar(0.99, "SLO objective: the accepted "
                                      "fraction of submissions, 1 - "
                                      "(queue_full + quota_rejected) / "
                                      "offered"),
    "SPLATT_SLO_WINDOW_S": EnvVar(300.0, "SLO burn-rate short window in "
                                  "seconds; the long window is "
                                  "SPLATT_SLO_LONG_WINDOWS times this"),
    "SPLATT_SLO_LONG_WINDOWS": EnvVar(12, "SLO burn-rate long window, as "
                                      "a multiple of SPLATT_SLO_WINDOW_S"),
    "SPLATT_SLO_BURN": EnvVar(2.0, "SLO alert threshold: emit slo_burn "
                              "when the error-budget burn rate meets or "
                              "exceeds this multiple on both windows"),
    "SPLATT_SLO_PREDICT_P99_S": EnvVar(0.25, "SLO objective: 99% of "
                                       "served predicts complete within "
                                       "this many wall seconds accepted-"
                                       "to-served (the splatt_predict_"
                                       "latency_seconds histogram; the "
                                       "threshold rounds up to a bucket "
                                       "bound)"),
    "SPLATT_LOCKCHECK": EnvVar("0", "runtime lock-ownership sanitizer "
                               "(utils/lockcheck.py): the serve daemon's "
                               "job table, queues and running set and "
                               "the plan cache's memo are wrapped in "
                               "proxies asserting that their owning lock "
                               "is held by the mutating thread; off by "
                               "default (no wrappers)"),
}


def read_env(name: str) -> Optional[object]:
    """A declared variable's process value when set, its registered
    default otherwise.  An undeclared name raises."""
    spec = ENV_VARS.get(name)
    if spec is None:
        raise KeyError(
            f"environment variable {name!r} is not declared in "
            f"splatt_tpu_torch.utils.env.ENV_VARS; register it (with a "
            f"doc string) before reading it")
    raw = os.environ.get(name)
    return spec.default if raw is None else raw


def env_is_set(name: str) -> bool:
    """Whether the process environment sets a declared variable, as
    opposed to its registered default applying (≙ splatt_tpu.utils.env.
    env_is_set): the autotuner tells a pinned knob (measure only that)
    from an untouched default (measure the candidates)."""
    if name not in ENV_VARS:
        raise KeyError(
            f"environment variable {name!r} is not declared in "
            f"splatt_tpu_torch.utils.env.ENV_VARS")
    return name in os.environ


def max_mean_ratio(a) -> float:
    """round(max/mean, 3) of a nonnegative weight array, the one
    imbalance figure every layout and sharding balance stat reports; 1.0
    is perfectly balanced, or empty (≙ splatt_tpu.utils.env.
    max_mean_ratio)."""
    import numpy as np

    a = np.asarray(a)
    mean = float(a.mean()) if a.size else 0.0
    return round(float(a.max()) / mean, 3) if mean > 0 else 1.0


def read_env_int(name: str) -> int:
    """:func:`read_env` parsed as an int; a malformed value falls back
    to the registered default with one line on stderr
    (≙ splatt_tpu.utils.env.read_env_int)."""
    val = read_env(name)
    try:
        return int(val)
    except (TypeError, ValueError):
        print(f"splatt-tpu: bad {name}={val!r} (want an int); using the "
              f"default", file=sys.stderr)
        return int(ENV_VARS[name].default)


def read_env_float(name: str) -> float:
    """:func:`read_env` parsed as a float; a malformed value falls back
    to the registered default with one line on stderr
    (≙ splatt_tpu.utils.env.read_env_float)."""
    val = read_env(name)
    try:
        return float(val)
    except (TypeError, ValueError):
        print(f"splatt-tpu: bad {name}={val!r} (want a float); using the "
              f"default", file=sys.stderr)
        return float(ENV_VARS[name].default)


def host_fence(x):
    """Wait until the card has finished `x` and everything queued before
    it (≙ splatt_tpu.utils.env.host_fence): ``torch.cuda.synchronize``
    on the device of every CUDA tensor among `x` (a tensor, or a nested
    list/tuple of them); CPU tensors need no fence.  The profiled sweeps
    close each phase's timer with it, and the autotuner each timed
    candidate call.  Returns `x` for chaining."""
    import torch

    seen = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda" and v.device not in seen:
                seen.add(v.device)
                torch.cuda.synchronize(v.device)
        elif isinstance(v, (list, tuple)):
            for w in v:
                walk(w)

    walk(x)
    return x
