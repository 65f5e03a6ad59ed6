"""Structured span tracing, a metrics registry and the flight recorder
(≙ splatt_tpu/trace.py).

Span tree
    :func:`span` opens one named host-side span (a context manager);
    spans nest (``cpd.als`` → ``cpd.iter`` → ``cpd.sweep`` /
    ``mttkrp.dispatch`` / ``cpd.guard.*``), each carrying its start,
    duration and attributes (engine, mode, iteration, the job id of the
    active :func:`resilience.scope <splatt_tpu_torch.resilience.scope>`).
    Guard work (the health-pack fetch, snapshot refresh, rollback,
    deadline arm/disarm) has its own spans, so its cost is a query over
    the trace.  While a span records and CUDA is initialised, it also
    pushes an NVTX range of its name (``torch.cuda.nvtx``), so a device
    profile lines up with the host spans.

Point events
    Every run-report emission (``resilience.RunReport.add``) flows
    through :func:`point`: demotions, fallbacks and rollbacks become
    timestamped instant events attached to the enclosing span.

Metrics registry
    Counters, gauges and histograms declared in :data:`METRICS`.
    Event-driven metrics are always collected; :func:`metrics_text`
    renders them as Prometheus text and :func:`write_metrics` publishes
    that atomically.

Exporters
    :func:`write_chrome_trace` writes Chrome trace-event JSON (loadable
    in perfetto): ``cpd --trace <path>``.  :func:`summarize` /
    :func:`format_summary` drive the ``trace`` verb (top spans by self
    time, the per-iteration breakdown, the guard share), and
    :func:`merge_trace_files` merges several exports onto one timeline.

Flight recorder
    :func:`set_flight` arms a bounded, incrementally appended ring of the
    recent finished spans and point events (JSONL, rotated atomically to
    ``<path>.1``), so a SIGKILLed fleet replica leaves a readable black
    box: :func:`load_flight` reads it back.  A flush failure (the
    ``trace.flight`` fault site) disarms the recorder with a classified
    ``flight_degraded`` event and never fails the run.  Records reach the
    ring at span end, from the host clock: the recorder adds no
    synchronization with the card.

Fleet merge
    Every span and point is stamped with the replica id
    (:func:`set_replica`), and :func:`merge_trace_files` merges many
    replicas' Chrome exports and flight rings onto one timeline, with
    flow events linking an adopted job's spans on the victim to its
    continuation on the adopter.

Overhead
    Spans are no-ops unless enabled (``SPLATT_TRACE`` /
    ``Options.trace`` / :func:`set_enabled`): one boolean check and a
    shared no-op handle.  Enabled spans never synchronise the card: they
    read ``perf_counter`` only (the NVTX push is a host call).

Span names are a registry (:data:`SPANS`), as in the JAX package.

This module imports nothing heavy at import time; ``torch`` is touched
lazily, only for the NVTX ranges.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

#: every span name the port opens, name -> one-line doc (a trailing
#: ``.*`` declares an f-string family, ``timer.{name}``)
SPANS = {
    "cpd.als": "one cpd_als run end to end (attrs: rank, max_iterations, "
               "guard budget); the root every single-card span nests "
               "under",
    "cpd.iter": "one ALS iteration, sweep dispatch through the commit "
                "(attrs: it, fit at check iterations); per-iteration sums "
                "reconcile with the driver's printed sec/iter",
    "cpd.sweep": "the sweep invocation of one iteration (host-side "
                 "enqueue; the card's completion lands in the fit fetch)",
    "cpd.build_sweep": "(re)building the sweep callable (at the start, "
                       "after an engine demotion, and on a health "
                       "rollback's regularization bump)",
    "cpd.fit_check": "the fit's host fetch at a check iteration, the one "
                     "sync the enqueued work drains into",
    "cpd.checkpoint": "one atomic .npz checkpoint write",
    "cpd.batch": "one cpd_als_batched run end to end, K same-regime "
                 "tensors as one stacked sweep (attrs: rank, k, "
                 "max_iterations)",
    "cpd.batch.sweep": "one batched ALS iteration over every live slot, "
                       "sweep dispatch through the per-slot commit "
                       "(attrs: it)",
    "cpd.update": "the warm-update pre-pass (refresh_touched_rows): the "
                  "rows a delta touched re-solved before the warm sweeps "
                  "(attrs: modes, rows); a serve update job opens one "
                  "more around the pre-pass and its warm sweeps (attrs: "
                  "job, base, delta_nnz)",
    "serve.job": "one supervised serve job end to end (attrs: job, "
                 "resumed, in fleet mode the replica and adopted_from, "
                 "the terminal status once journaled, and on a card the "
                 "kernel launches made while it ran)",
    "serve.batch": "one coalesced batch's batched CPD invocation (attrs: "
                   "k, leader job id)",
    "serve.predict": "one generation-fenced predict job: the hot-cache "
                     "lookup (or the direct read) and the reconstruct or "
                     "top-k scan (attrs: job, model, gen, cache)",
    "cpd.guard.health_pack": "numerical-health sentinel: building and "
                             "fetching the packed finite-check vector "
                             "(rides the fit-check sync)",
    "cpd.guard.snapshot": "refreshing the last-good rollback snapshot "
                          "(references to the committed tensors, never "
                          "a copy)",
    "cpd.guard.rollback": "one health rollback: restore the last-good "
                          "snapshot, bump reg, re-randomize offenders",
    "guard.deadline.arm": "arming the deadline watchdog timer for one "
                          "guarded host-side call",
    "guard.deadline.disarm": "cancelling the watchdog timer (and "
                             "absorbing a raced interrupt) on exit",
    "mttkrp.dispatch": "one blocked-MTTKRP engine-chain dispatch (attrs: "
                       "mode, path, block, chosen engine, enc); the port "
                       "records it once per call (the JAX package once "
                       "per compilation)",
    "dist.als": "one distributed convergence loop (run_distributed_als)",
    "dist.step": "one distributed sweep step invocation",
    "dist.comm_select": "comm-strategy selection: probing the fallback "
                        "chain (async_ring -> ring -> all2all)",
    "dist.measure_overlap": "the achieved-overlap measurement of a "
                            "ring-variant sweep",
    "trace.export": "writing one Chrome-trace JSON file",
    "tune.measure": "one autotuner candidate measurement, warm and "
                    "timed calls of a forced engine (attrs: mode, path, "
                    "engine, block, scan_target)",
    "timer.*": "utils/timers.py brackets routed through the span layer "
               "(timer.cpd, timer.mttkrp, ...)",
}

#: every metric the code records, name -> (type, doc): the Prometheus
#: surface.  Recording an undeclared name raises.
METRICS = {
    "splatt_events_total": (
        "counter", "run-report events by kind (and job, inside a "
                   "resilience scope); every resilience event "
                   "increments this"),
    "splatt_retries_total": (
        "counter", "transient failures retried in place with backoff"),
    "splatt_demotions_total": (
        "counter", "engine demotions by failure class"),
    "splatt_health_rollbacks_total": (
        "counter", "numerical-health rollbacks to the last-good "
                   "snapshot"),
    "splatt_health_degraded_total": (
        "counter", "runs that exhausted the health budget and degraded "
                   "to checkpoint-and-abort"),
    "splatt_tune_cache_total": (
        "counter", "autotuner plan-cache consults by outcome (hit/miss), "
                   "one per tuned mode"),
    "splatt_serve_queue_depth": (
        "gauge", "serve: pending jobs in the bounded queue"),
    "splatt_serve_jobs_total": (
        "counter", "serve: terminal jobs by status "
                   "(converged/degraded/failed/rejected/served/refused)"),
    "splatt_job_seconds": (
        "histogram", "serve: per-job wall seconds accepted-to-terminal"),
    "splatt_fleet_adoptions_total": (
        "counter", "fleet: dead peers' jobs adopted by this replica "
                   "(expired-lease takeovers)"),
    "splatt_fleet_lease_expired_total": (
        "counter", "fleet: job-lease expiries by role (owner: this "
                   "replica's renew refused, job abandoned uncommitted; "
                   "adopter: an expired lease was taken over)"),
    "splatt_fleet_replicas": (
        "gauge", "fleet: replica count by liveness state (alive = "
                 "unexpired heartbeat, dead = present but expired), "
                 "synthesized into every merged exposition; serve members "
                 "mirror their last census into their own registry"),
    "splatt_serve_queue_wait_seconds": (
        "histogram", "serve: seconds a job waited accepted-to-started, "
                     "the queue-wait SLO's histogram"),
    "splatt_slo_burn_total": (
        "counter", "SLO burn-rate alerts by slo name: the error budget "
                   "burned at >= the alert multiple on both windows "
                   "(fleetobs.SloEvaluator); counts burning evaluations"),
    "splatt_serve_batches_total": (
        "counter", "serve: coalesced batch dispatches by outcome "
                   "(dispatched = ran as one batched CPD, degraded = fell "
                   "back classified to per-tensor dispatch)"),
    "splatt_serve_batch_jobs_total": (
        "counter", "serve: jobs whose terminal commit rode a coalesced "
                   "batch"),
    "splatt_serve_updates_total": (
        "counter", "serve: incremental update jobs by outcome (applied = "
                   "warm sweeps committed, refit = the full-refit repair "
                   "path ran)"),
    "splatt_predict_latency_seconds": (
        "histogram", "serve: predict-lane wall seconds accepted-to-served, "
                     "the predict p99 latency SLO's histogram; the "
                     "ms-scale buckets exist for this metric"),
    "splatt_predict_requests_total": (
        "counter", "serve: predict jobs by outcome (served = answered "
                   "from a fenced generation, refused = no intact "
                   "generation)"),
    "splatt_predict_cache_total": (
        "counter", "serve: hot-factor cache consults by outcome (hit/miss) "
                   "keyed on (model, generation)"),
    "splatt_predict_queue_depth": (
        "gauge", "serve: pending predicts in the bounded low-latency "
                 "lane"),
}

#: histogram bucket upper bounds (seconds); +Inf is implicit
HIST_BUCKETS = (0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0,
                900.0)

_TRACE_ENV = "SPLATT_TRACE"

# -- enablement --------------------------------------------------------------

_enabled_override: Optional[bool] = None
_CTX_ENABLED: contextvars.ContextVar = contextvars.ContextVar(
    "splatt_trace_enabled", default=None)
#: memoized SPLATT_TRACE verdict (None = not read yet): the disabled
#: hot path must be the promised single boolean test, not a registry
#: lookup per span open.  :func:`set_enabled` clears it, so tests (and
#: anyone genuinely flipping the env mid-process) re-earn the verdict
#: with ``set_enabled(None)``.
_env_verdict: Optional[bool] = None


def _env_enabled() -> bool:
    global _env_verdict
    if _env_verdict is None:
        from splatt_tpu_torch.utils.env import read_env

        _env_verdict = str(read_env(_TRACE_ENV) or "").lower() in (
            "1", "on", "true", "yes")
    return _env_verdict


def enabled() -> bool:
    """Whether spans are recorded: a per-run :func:`enabling` override
    (``Options.trace``) wins, else the process override
    (:func:`set_enabled` — the CLI ``--trace`` flag), else the
    ``SPLATT_TRACE`` env default (off).  This is THE hot-path check:
    when it returns False, :func:`span` costs one boolean test and
    returns a shared no-op."""
    ctx = _CTX_ENABLED.get()
    if ctx is not None:
        return ctx
    if _enabled_override is not None:
        return _enabled_override
    return _env_enabled()


def set_enabled(value: Optional[bool]) -> None:
    """Process-wide tracing override (None restores the env default,
    re-read fresh — the memoized verdict is cleared)."""
    global _enabled_override, _env_verdict
    _enabled_override = value
    _env_verdict = None


@contextlib.contextmanager
def enabling(value: Optional[bool]):
    """Scoped tracing override for one run (``Options.trace``): None is
    a no-op (the process/env resolution applies), True/False pin
    tracing on/off inside the block only — contextvars-backed, so
    concurrent serve jobs do not fight over a global."""
    if value is None:
        yield
        return
    token = _CTX_ENABLED.set(bool(value))
    try:
        yield
    finally:
        _CTX_ENABLED.reset(token)


# -- span recorder -----------------------------------------------------------

# the recorder's shared registries: plain containers under one plain
# lock (the JAX package wraps them in its lockcheck proxies, tooling of
# that package's static checker that the port does not carry)
_LOCK = threading.Lock()
_SIDS = itertools.count(1)
_DONE: List[dict] = []
_OPEN: Dict[int, dict] = {}
_POINTS: List[dict] = []
#: (wall-clock, perf_counter) anchor pair: spans time with the
#: monotonic perf_counter and the exporter maps onto the epoch once
_ANCHOR: Tuple[float, float] = (time.time(), time.perf_counter())

#: in-memory recorder bound (SPLATT_TRACE_MAX_RECORDS): past the cap
#: the oldest records are dropped in chunks and the drop is counted,
#: surfaced on the trace_written event.  None = not read yet.
_record_cap: Optional[int] = None
_DROPPED = {"spans": 0, "points": 0}


def _cap() -> int:
    global _record_cap
    if _record_cap is None:
        from splatt_tpu_torch.utils.env import read_env_int

        _record_cap = max(int(read_env_int("SPLATT_TRACE_MAX_RECORDS")),
                          1000)
    return _record_cap


def _bound_locked(lst: List[dict], what: str) -> None:
    """Drop the oldest ~10% once `lst` outgrows the cap (callers hold
    _LOCK; chunked so the O(n) front-delete amortizes)."""
    cap = _cap()
    if len(lst) > cap:
        drop = max(cap // 10, 1)
        del lst[:drop]
        _DROPPED[what] += drop
_STACK: contextvars.ContextVar = contextvars.ContextVar(
    "splatt_trace_stack", default=())

#: the replica id stamped on every span and point record (fleet mode):
#: None outside a fleet replica.  Set once per process by the serve
#: entry point, before its threads start.
_replica: Optional[str] = None

#: flight-recorder state: empty = disarmed; armed it holds path,
#: max_bytes, flush_every and buf, every key mutated under _LOCK.  buf
#: accumulates raw span and point records; _flight_flush drains it.
_FLIGHT: Dict[str, object] = {}
#: serializes ring-file IO across flushing threads (taken only after
#: _LOCK is released)
_FLIGHT_IO_LOCK = threading.Lock()


def set_replica(rid: Optional[str]) -> None:
    """Stamp every later span and point record (and the Chrome export's
    process row) with this replica id, what lets
    :func:`merge_trace_files` render N replicas as one fleet timeline."""
    global _replica
    _replica = str(rid) if rid else None


def replica() -> Optional[str]:
    return _replica


def _nvtx_push(name: str) -> bool:
    """Push an NVTX range named after a recording span when CUDA is
    initialised (the counterpart of the JAX package's TPU trace
    annotation); whether one was pushed.  Cosmetic: a failure never
    fails the traced work."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return False
        torch.cuda.nvtx.range_push(name)
        return True
    except Exception:
        return False


def _nvtx_pop() -> None:
    try:
        import torch

        torch.cuda.nvtx.range_pop()
    except Exception:
        pass


def _job() -> Optional[str]:
    from splatt_tpu_torch import resilience

    return resilience.current_job()


class _NoopSpan:
    """The disabled-path span: a shared singleton whose every method is
    a no-op — `with trace.span(...)` costs one enabled() check."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP = _NoopSpan()


class SpanHandle:
    """One live span: context manager; :meth:`set` attaches attributes
    mid-flight (the fit at a check iteration, the chosen engine)."""

    __slots__ = ("rec", "_nvtx")

    def __init__(self, name: str, attrs: dict):
        job = attrs.pop("job", None) or _job()
        self.rec = {"name": name, "sid": next(_SIDS), "parent": None,
                    "t0": 0.0, "dur": None, "args": attrs,
                    "tid": threading.get_ident(), "job": job,
                    "replica": _replica}
        self._nvtx = False

    def set(self, **attrs):
        self.rec["args"].update(attrs)
        return self

    def __enter__(self):
        stack = _STACK.get()
        self.rec["parent"] = stack[-1] if stack else None
        _STACK.set(stack + (self.rec["sid"],))
        with _LOCK:
            _OPEN[self.rec["sid"]] = self.rec
        self._nvtx = _nvtx_push(self.rec["name"])
        self.rec["t0"] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec["dur"] = time.perf_counter() - self.rec["t0"]
        if self._nvtx:
            _nvtx_pop()
            self._nvtx = False
        sid = self.rec["sid"]
        stack = _STACK.get()
        if sid in stack:
            # tolerate mis-nested timer brackets (start A, start B, stop
            # A): drop OUR sid wherever it sits; leaked children clean
            # themselves up on their own exit
            _STACK.set(tuple(s for s in stack if s != sid))
        flush_now = False
        with _LOCK:
            _OPEN.pop(sid, None)
            _DONE.append(self.rec)
            _bound_locked(_DONE, "spans")
            if _FLIGHT:
                _FLIGHT["buf"].append(self.rec)
                flush_now = len(_FLIGHT["buf"]) >= _FLIGHT["flush_every"]
        if flush_now:
            _flight_flush()
        return False


def span(name: str, **attrs):
    """Open one named span (context manager).  A no-op singleton when
    tracing is disabled — the overhead contract of the module
    docstring.  `name` is one of :data:`SPANS` (dynamic names use a
    declared ``x.*`` family)."""
    if not enabled():
        return NOOP
    return SpanHandle(name, attrs)


def begin(name: str, **attrs):
    """:func:`span` + immediate enter — for regions whose open/close
    straddle statement structure (a driver's root span around a loop
    with multiple exits).  Close with :func:`end`; a span left open at
    export rides along marked ``open`` (crash diagnostics)."""
    h = span(name, **attrs)
    h.__enter__()
    return h


def end(handle) -> None:
    """Close a :func:`begin` span (no-op for the disabled singleton)."""
    handle.__exit__(None, None, None)


def point(kind: str, info: Optional[dict] = None) -> None:
    """Record one instant event attached to the enclosing span — the
    hook every ``run_report().add`` emission flows through, so
    demotions/fallbacks/rollbacks appear in time order on the trace.
    Event-derived METRICS are updated even when span recording is off
    (metrics are always-on; spans are the gated part)."""
    info = {k: v for k, v in (info or {}).items()
            if k not in ("ts", "kind")}
    _event_metrics(kind, info)
    if not enabled():
        return
    stack = _STACK.get()
    rec = {"name": kind, "t": time.perf_counter(),
           "parent": stack[-1] if stack else None,
           "tid": threading.get_ident(), "args": info,
           "job": _job(), "replica": _replica}
    flush_now = False
    with _LOCK:
        _POINTS.append(rec)
        _bound_locked(_POINTS, "points")
        if _FLIGHT:
            _FLIGHT["buf"].append(rec)
            flush_now = len(_FLIGHT["buf"]) >= _FLIGHT["flush_every"]
    if flush_now:
        _flight_flush()


def spans(name: Optional[str] = None) -> List[dict]:
    """Finished span records (tests; the exporter's source)."""
    with _LOCK:
        out = list(_DONE)
    if name is not None:
        out = [s for s in out if s["name"] == name]
    return out


def points(kind: Optional[str] = None) -> List[dict]:
    """Recorded point events (tests)."""
    with _LOCK:
        out = list(_POINTS)
    if kind is not None:
        out = [p for p in out if p["name"] == kind]
    return out


def reset() -> None:
    """Drop every recorded span/point (a fresh run in one process;
    tests).  Open handles close harmlessly into the cleared recorder.
    Metrics are NOT cleared — use :func:`reset_metrics`."""
    global _record_cap
    with _LOCK:
        _DONE.clear()
        _OPEN.clear()
        _POINTS.clear()
    _DROPPED["spans"] = _DROPPED["points"] = 0
    _record_cap = None  # re-earn the env verdict (tests flip it)


# -- metrics registry --------------------------------------------------------

_MET_LOCK = threading.Lock()
#: (name, ((label, value), ...)) -> float | histogram-state dict
_SAMPLES: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}


def _declared(name: str, want: str) -> None:
    spec = METRICS.get(name)
    if spec is None:
        raise KeyError(
            f"metric {name!r} is not declared in splatt_tpu_torch.trace."
            f"METRICS; register it (with a type and doc) before "
            f"recording it")
    if spec[0] != want:
        raise TypeError(
            f"metric {name!r} is declared as a {spec[0]}, not a {want}")


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    if "job" not in labels:
        job = _job()
        if job is not None:
            labels = dict(labels, job=job)
    return tuple(sorted((k, str(v)) for k, v in labels.items()
                        if v is not None))


def metric_inc(name: str, value: float = 1.0, **labels) -> None:
    """Increment a declared counter (labels become Prometheus labels;
    the active serve job's id is stamped as ``job`` automatically)."""
    _declared(name, "counter")
    key = (name, _label_key(labels))
    with _MET_LOCK:
        _SAMPLES[key] = float(_SAMPLES.get(key, 0.0)) + float(value)


def metric_set(name: str, value: float, **labels) -> None:
    """Set a declared gauge to `value`."""
    _declared(name, "gauge")
    with _MET_LOCK:
        _SAMPLES[(name, _label_key(labels))] = float(value)


def metric_observe(name: str, value: float, **labels) -> None:
    """Record one observation into a declared histogram."""
    _declared(name, "histogram")
    key = (name, _label_key(labels))
    with _MET_LOCK:
        h = _SAMPLES.get(key)
        if not isinstance(h, dict):
            h = {"buckets": [0] * (len(HIST_BUCKETS) + 1),
                 "sum": 0.0, "count": 0}
            _SAMPLES[key] = h
        i = len(HIST_BUCKETS)
        for j, le in enumerate(HIST_BUCKETS):
            if value <= le:
                i = j
                break
        h["buckets"][i] += 1
        h["sum"] += float(value)
        h["count"] += 1


def reset_metrics() -> None:
    with _MET_LOCK:
        _SAMPLES.clear()


def samples() -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object]:
    """The raw registry samples, ``(name, label-key) -> value`` with
    histogram states copied: what the SLO evaluator consumes
    (fleetobs.py; ≙ splatt_tpu/trace.py:701)."""
    with _MET_LOCK:
        return {k: (dict(v, buckets=list(v["buckets"]))
                    if isinstance(v, dict) else v)
                for k, v in _SAMPLES.items()}


def _event_metrics(kind: str, info: dict) -> None:
    """Event-kind -> metric mapping: every run-report event counts into
    ``splatt_events_total``; load-bearing kinds get their own series."""
    labels = {}
    job = info.get("job")
    if job is not None:
        labels["job"] = job
    metric_inc("splatt_events_total", kind=kind, **labels)
    if kind == "transient_retry":
        metric_inc("splatt_retries_total", **labels)
    elif kind == "engine_demotion":
        metric_inc("splatt_demotions_total",
                   failure_class=info.get("failure_class", "unknown"),
                   **labels)
    elif kind == "health_rollback":
        metric_inc("splatt_health_rollbacks_total", **labels)
    elif kind == "health_degraded":
        metric_inc("splatt_health_degraded_total", **labels)
    elif kind == "slo_burn":
        metric_inc("splatt_slo_burn_total", slo=info.get("slo", "?"),
                   replica=info.get("replica"), **labels)


def _fmt_labels(lk: Tuple[Tuple[str, str], ...]) -> str:
    if not lk:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\")
                         .replace('"', '\\"').replace("\n", " "))
        for k, v in lk)
    return "{" + inner + "}"


def _job_match(lk: Tuple[Tuple[str, str], ...],
               job: Optional[str]) -> bool:
    if job is None:
        return True
    return dict(lk).get("job") == job


def metrics_text(job: Optional[str] = None) -> str:
    """The registry in Prometheus text exposition format.  With `job`,
    only samples carrying that job label are emitted — the per-tenant
    isolation cut a serve job's result embeds (a neighbor's counters
    never appear)."""
    with _MET_LOCK:
        samples = dict(_SAMPLES)
    return render_samples(samples, job=job)


def render_samples(samples: Dict, job: Optional[str] = None) -> str:
    """Render a raw sample map (:func:`samples`-shaped) as Prometheus
    text exposition.  Only :data:`METRICS`-declared names are emitted:
    the registry is the exposition contract."""
    lines: List[str] = []
    for name in METRICS:
        typ, doc = METRICS[name]
        mine = sorted((lk, v) for (n, lk), v in samples.items()
                      if n == name and _job_match(lk, job))
        if not mine:
            continue
        lines.append(f"# HELP {name} {doc}")
        lines.append(f"# TYPE {name} {typ}")
        for lk, v in mine:
            if typ == "histogram" and isinstance(v, dict):
                cum = 0
                for j, le in enumerate(HIST_BUCKETS):
                    cum += v["buckets"][j]
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(lk + (('le', str(le)),))} {cum}")
                cum += v["buckets"][-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(lk + (('le', '+Inf'),))} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(lk)} "
                             f"{round(v['sum'], 6)}")
                lines.append(f"{name}_count{_fmt_labels(lk)} "
                             f"{v['count']}")
            else:
                out = v if isinstance(v, (int, float)) else 0.0
                lines.append(f"{name}{_fmt_labels(lk)} {round(out, 6)}")
    return "\n".join(lines) + ("\n" if lines else "")


def metrics_snapshot(job: Optional[str] = None) -> dict:
    """JSON-embeddable view of the registry (the serve job-result
    form): ``{metric{labels}: value}`` for counters/gauges, histogram
    state dicts for histograms.  `job` cuts to that tenant's samples."""
    with _MET_LOCK:
        samples = dict(_SAMPLES)
    out: Dict[str, object] = {}
    for (name, lk), v in sorted(samples.items(),
                                key=lambda kv: (kv[0][0], kv[0][1])):
        if not _job_match(lk, job):
            continue
        out[f"{name}{_fmt_labels(lk)}"] = (dict(v) if isinstance(v, dict)
                                           else v)
    return out


def write_metrics(path: str, job: Optional[str] = None) -> dict:
    """Atomically write :func:`metrics_text` to `path` (tmp + rename —
    a scraper never reads a torn file) and record a
    ``metrics_snapshot`` run-report event.  A write failure degrades
    classified (the event carries the error) — metrics must never kill
    the daemon they observe."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils.durable import publish_text

    text = metrics_text(job=job)
    try:
        publish_text(str(path), text)
    except Exception as e:
        cls = resilience.classify_failure(e)
        return resilience.run_report().add(
            "metrics_snapshot", path=str(path), ok=False,
            failure_class=cls.value,
            error=resilience.failure_message(e)[:200])
    return resilience.run_report().add(
        "metrics_snapshot", path=str(path), ok=True,
        samples=text.count("\n"))


# -- Chrome trace-event export -----------------------------------------------

def _us(t: float) -> int:
    """perf_counter time -> epoch microseconds via the shared anchor,
    the one mapping every export uses, so merged files line up on the
    wall clock."""
    wall0, perf0 = _ANCHOR
    return int((wall0 + (t - perf0)) * 1e6)


def _span_event(rec: dict, pid: Optional[int] = None) -> dict:
    """One finished-span record -> its Chrome complete event."""
    args = dict(rec["args"], sid=rec["sid"])
    if rec["parent"] is not None:
        args["parent"] = rec["parent"]
    if rec["job"] is not None:
        args["job"] = rec["job"]
    if rec.get("replica") is not None:
        args["replica"] = rec["replica"]
    return {"name": rec["name"], "cat": "span", "ph": "X",
            "ts": _us(rec["t0"]),
            "dur": max(int((rec["dur"] or 0.0) * 1e6), 1),
            "pid": pid if pid is not None else os.getpid(),
            "tid": rec["tid"], "args": args}


def _point_event(rec: dict, pid: Optional[int] = None) -> dict:
    """One point-event record -> its Chrome instant event."""
    args = dict(rec["args"])
    if rec["parent"] is not None:
        args["parent"] = rec["parent"]
    if rec.get("job") is not None:
        args.setdefault("job", rec["job"])
    if rec.get("replica") is not None:
        args["replica"] = rec["replica"]
    return {"name": rec["name"], "cat": "event", "ph": "i",
            "s": "t", "ts": _us(rec["t"]),
            "pid": pid if pid is not None else os.getpid(),
            "tid": rec["tid"], "args": args}


def chrome_events() -> List[dict]:
    """The recorder as Chrome trace-event dicts: one complete event
    (``ph: "X"``) per finished span — still-open spans ride along with
    their duration-so-far and ``open: true`` (crash diagnostics) — and
    one instant event (``ph: "i"``) per point event.  ``args`` carries
    the span attributes plus ``sid``/``parent`` so the summarizer (and
    perfetto queries) can rebuild the tree without guessing from
    timestamps.  With a :func:`set_replica` stamp, a ``process_name``
    metadata row names the process row after the replica."""
    now = time.perf_counter()
    with _LOCK:
        done = list(_DONE)
        still_open = [dict(rec, dur=now - rec["t0"],
                           args=dict(rec["args"], open=True))
                      for rec in _OPEN.values()]
        pts = list(_POINTS)
    pid = os.getpid()
    evs = [_span_event(rec, pid) for rec in done + still_open]
    evs += [_point_event(p, pid) for p in pts]
    evs.sort(key=lambda e: e["ts"])
    if _replica is not None:
        evs.insert(0, {"name": "process_name", "ph": "M", "ts": 0,
                       "pid": pid,
                       "args": {"name": f"replica {_replica}"}})
    return evs


def write_chrome_trace(path: str) -> dict:
    """Export the recorder to a perfetto-loadable Chrome trace-event
    JSON file (atomic tmp + rename) and record a ``trace_written``
    run-report event.  A write failure degrades classified — losing
    the trace must never lose the run (the ``trace.export`` fault site
    drills exactly that)."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils import faults
    from splatt_tpu_torch.utils.durable import publish_json

    evs = chrome_events()
    with span("trace.export", path=str(path)):
        try:
            faults.maybe_fail("trace.export")
            publish_json(str(path), {"traceEvents": evs,
                                     "displayTimeUnit": "ms"})
        except Exception as e:
            cls = resilience.classify_failure(e)
            return resilience.run_report().add(
                "trace_written", path=str(path), ok=False,
                failure_class=cls.value,
                error=resilience.failure_message(e)[:200])
    extra = {}
    if _DROPPED["spans"] or _DROPPED["points"]:
        # the in-memory recorder hit SPLATT_TRACE_MAX_RECORDS and
        # dropped its oldest records: the export is honest about being
        # a suffix
        extra = {"dropped_spans": _DROPPED["spans"],
                 "dropped_points": _DROPPED["points"]}
    return resilience.run_report().add(
        "trace_written", path=str(path), ok=True,
        spans=sum(1 for e in evs if e["ph"] == "X"),
        events=sum(1 for e in evs if e["ph"] == "i"), **extra)


# -- the flight recorder ------------------------------------------------------
#
# The Chrome export exists only if the process lives to write it.  The
# flight recorder is the black box: every finished span and point event is
# also appended (buffered, as JSONL Chrome events on the shared wall-clock
# anchor) to a bounded ring file that rotates atomically, so after a kill
# the victim's timeline up to its last flush is readable.

def set_flight(path: Optional[str], max_bytes: Optional[int] = None,
               flush_every: Optional[int] = None) -> None:
    """Arm (or with ``path=None`` disarm) the flight recorder.  Spans must
    be enabled for records to exist; fleet-mode serve arms both (cli.py).
    `max_bytes` bounds the ring file before rotation
    (``SPLATT_FLIGHT_BYTES``); `flush_every` is the buffered-record flush
    threshold (``SPLATT_FLIGHT_FLUSH``): a SIGKILL loses at most that many
    trailing records."""
    from splatt_tpu_torch.utils.env import read_env_int

    if path:
        mb = int(max_bytes if max_bytes is not None
                 else read_env_int("SPLATT_FLIGHT_BYTES"))
        fe = max(int(flush_every if flush_every is not None
                     else read_env_int("SPLATT_FLIGHT_FLUSH")), 1)
    with _LOCK:
        _FLIGHT.clear()
        if path:
            _FLIGHT.update(path=str(path), max_bytes=mb,
                           flush_every=fe, buf=[])


def flight_path() -> Optional[str]:
    with _LOCK:
        return _FLIGHT.get("path") if _FLIGHT else None


def flight_flush() -> None:
    """Drain the buffered flight records to the ring file now (drain and
    exit paths; a no-op while disarmed)."""
    _flight_flush()


def _flight_flush() -> None:
    """One ring flush: drain the buffer under the recorder lock, write
    outside it (ring IO serialized by its own lock).  Any failure (the
    ``trace.flight`` fault site drills it) disarms the recorder and
    degrades classified (``flight_degraded``)."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils import faults
    from splatt_tpu_torch.utils.durable import ring_append

    with _LOCK:
        if not _FLIGHT or not _FLIGHT["buf"]:
            return
        recs = list(_FLIGHT["buf"])
        _FLIGHT["buf"].clear()
        path, max_bytes = _FLIGHT["path"], _FLIGHT["max_bytes"]
    lines = [json.dumps(_span_event(r) if "t0" in r
                        else _point_event(r)).encode() for r in recs]
    try:
        with _FLIGHT_IO_LOCK:
            faults.maybe_fail("trace.flight")
            ring_append(path, lines, max_bytes)
    except Exception as e:
        # disarm first: the report below flows through point(), which
        # must find the recorder already off
        set_flight(None)
        cls = resilience.classify_failure(e)
        resilience.run_report().add(
            "flight_degraded", path=str(path), failure_class=cls.value,
            error=resilience.failure_message(e)[:200])


def load_flight(path: str) -> List[dict]:
    """Read a flight ring (the rotated ``<path>.1`` generation first, then
    the live file) back into Chrome trace events.  A torn final line (the
    record a SIGKILL interrupted mid-append) is skipped: the black box is
    read as the crash left it."""
    out: List[dict] = []
    found = False
    for p in (path + ".1", path):
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:
            continue
        found = True
        for raw in data.split(b"\n"):
            if not raw.strip():
                continue
            try:
                ev = json.loads(raw.decode(errors="replace"))
            except ValueError:
                continue  # torn or garbled line: crash debris
            if isinstance(ev, dict) and ev.get("ph"):
                out.append(ev)
    if not found:
        raise FileNotFoundError(f"no flight ring at {path} (or .1)")
    return out


# -- trace summarization (the `trace` verb) ---------------------------------

def load_trace(path: str) -> List[dict]:
    """Parse a Chrome trace-event file → its event list (accepts both
    the ``{"traceEvents": [...]}`` object form we write and a bare
    array, which the format also permits)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("traceEvents", [])
    if not isinstance(data, list):
        raise ValueError(f"{path} is not a Chrome trace-event file")
    return data


# -- merging several traces (`trace f1 f2 ...`) ------------------------------

def expand_trace_paths(paths: List[str]) -> List[str]:
    """The verb's path resolution: files pass through, a directory
    expands to its ``*.json`` Chrome traces and ``*.jsonl`` flight rings,
    and a serve spool also to its ``fleet/flight/`` rings.  A ring is
    named by its base path even when only the rotated ``.jsonl.1``
    generation survives (a SIGKILL between rotation and the next flush
    leaves exactly that); :func:`load_flight` reads what exists."""
    import glob as _glob

    def rings_in(d: str) -> List[str]:
        rings = set(_glob.glob(os.path.join(d, "*.jsonl")))
        rings |= {q[:-len(".1")] for q in
                  _glob.glob(os.path.join(d, "*.jsonl.1"))}
        return sorted(rings)

    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out += sorted(_glob.glob(os.path.join(p, "*.json")))
            out += rings_in(p)
            flight = os.path.join(p, "fleet", "flight")
            if os.path.isdir(flight):
                out += rings_in(flight)
        elif p.endswith(".jsonl.1"):
            out.append(p[:-len(".1")])  # the ring's base names it
        else:
            out.append(p)
    return out


def _source_replica(events: List[dict]) -> Optional[str]:
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = str((e.get("args") or {}).get("name") or "")
            return name.replace("replica ", "") or None
        rep = (e.get("args") or {}).get("replica")
        if rep:
            return str(rep)
    return None


def merge_trace_files(paths: List[str]) -> List[dict]:
    """Merge N trace sources, Chrome exports (``.json``) and flight rings
    (``.jsonl``), into ONE timeline.  Every exporter stamps
    timestamps through the shared wall-clock↔perf_counter anchor, so
    the merge is a sort, not a re-clock; each source gets its own
    process row (pid = source index, named by its replica id) so pid
    reuse across restarted replicas can never collapse two replicas
    onto one row.  Flow events (:func:`_job_flows`) then link each
    adopted job's pre-kill events on the victim to its continuation on
    the adopter — the failover rendered as one logical job timeline."""
    merged: List[dict] = []
    pid_next = 1
    for path in expand_trace_paths(paths):
        events = (load_flight(path) if path.endswith(".jsonl")
                  else load_trace(path))
        if not any(e.get("ph") in ("X", "i") for e in events):
            continue  # e.g. a spool's journal.jsonl swept up by a
            #            directory expansion: no trace events, no row
        i, pid_next = pid_next, pid_next + 1
        label = _source_replica(events) or \
            os.path.splitext(os.path.basename(path))[0]
        merged.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": i, "args": {"name": f"replica {label}",
                                          "source": path}})
        for e in events:
            if e.get("ph") == "M":
                continue  # re-rowed above
            merged.append(dict(e, pid=i))
    merged += _job_flows(merged)
    merged.sort(key=lambda e: (e.get("ts", 0), e.get("ph") != "M"))
    return merged


def _job_flows(events: List[dict]) -> List[dict]:
    """Chrome flow events linking an adopted job across replicas: for
    every ``serve.job`` span carrying ``adopted_from``, draw an arrow
    from the previous owner's LAST event for that job (the victim's
    final pre-kill span or point, typically straight out of its
    flight ring) to the adopter's span start."""
    by_job: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "serve.job":
            job = (e.get("args") or {}).get("job")
            if job:
                by_job.setdefault(str(job), []).append(e)
    flows: List[dict] = []
    fid = 0
    for job, spans in sorted(by_job.items()):
        spans.sort(key=lambda e: e.get("ts", 0))
        for b in spans:
            src = (b.get("args") or {}).get("adopted_from")
            if not src:
                continue
            prior = [e for e in events
                     if e is not b and e.get("ph") in ("X", "i")
                     and (e.get("args") or {}).get("job") == job
                     and (e.get("args") or {}).get("replica") == src]
            if not prior:
                continue
            a = max(prior,
                    key=lambda e: e.get("ts", 0) + int(e.get("dur", 0)))
            fid += 1
            t_from = min(a.get("ts", 0) + int(a.get("dur", 0)),
                         b.get("ts", 0))
            common = {"name": "job_lineage", "cat": "fleet", "id": fid,
                      "args": {"job": job, "from_replica": src}}
            flows.append(dict(common, ph="s", pid=a["pid"],
                              tid=a.get("tid", 0), ts=t_from))
            flows.append(dict(common, ph="f", bp="e", pid=b["pid"],
                              tid=b.get("tid", 0), ts=b.get("ts", 0)))
    return flows


def _is_guard(name: str) -> bool:
    return name.startswith("cpd.guard.") or name.startswith("guard.")


def summarize(events: List[dict]) -> dict:
    """Aggregate a trace: per-name totals and SELF time (duration minus
    enclosed child spans — the honest 'where did the time go' number),
    the per-iteration breakdown (``cpd.iter``/``dist.step`` spans), the
    guard-overhead share, and point-event counts by kind."""
    sp = [e for e in events if e.get("ph") == "X"]
    pts = [e for e in events if e.get("ph") == "i"]
    child_us: Dict[object, int] = {}
    for e in sp:
        parent = (e.get("args") or {}).get("parent")
        if parent is not None:
            child_us[parent] = child_us.get(parent, 0) + int(e["dur"])
    names: Dict[str, dict] = {}
    iters: List[dict] = []
    guard_self_us = 0
    root_us = 0
    for e in sp:
        args = e.get("args") or {}
        self_us = max(int(e["dur"]) - child_us.get(args.get("sid"), 0), 0)
        agg = names.setdefault(
            e["name"], {"count": 0, "total_us": 0, "self_us": 0})
        agg["count"] += 1
        agg["total_us"] += int(e["dur"])
        agg["self_us"] += self_us
        if _is_guard(e["name"]):
            guard_self_us += self_us
        if e["name"] in ("cpd.als", "dist.als"):
            # SUM across driver runs (a serve trace holds one cpd.als
            # per job; bench A/B legs invoke the driver repeatedly) —
            # guard_self_us accumulates across all of them, so a max
            # here would overstate guard_pct by ~the number of runs
            root_us += int(e["dur"])
        if e["name"] in ("cpd.iter", "dist.step"):
            iters.append({"it": args.get("it"), "us": int(e["dur"]),
                          "fit": args.get("fit")})
    iters.sort(key=lambda r: (r["it"] is None, r["it"]))
    if root_us == 0:
        # no driver root span in the file: fall back to top-level spans
        root_us = sum(int(e["dur"]) for e in sp
                      if (e.get("args") or {}).get("parent") is None)
    kinds: Dict[str, int] = {}
    for p in pts:
        kinds[p["name"]] = kinds.get(p["name"], 0) + 1
    # fleet accounting: serve.job spans carry the
    # replica that ran them; adoption/lease-expiry point events carry
    # the failover story — `splatt trace` must account for every
    # adoption next to the per-replica job counts
    replicas: Dict[str, int] = {}
    jobs: Dict[str, List[dict]] = {}
    for e in sp:
        if e["name"] == "serve.job":
            args = e.get("args") or {}
            rid = args.get("replica")
            if rid:
                replicas[str(rid)] = replicas.get(str(rid), 0) + 1
            if args.get("job"):
                # per-job ownership lineage across a merged trace: one
                # entry per serve.job span, in time order — an adopted
                # job renders as victim(open) -> adopter(status), with
                # exactly one terminal commit
                jobs.setdefault(str(args["job"]), []).append({
                    "ts": int(e.get("ts", 0)),
                    "replica": rid, "status": args.get("status"),
                    "adopted_from": args.get("adopted_from"),
                    "open": bool(args.get("open"))})
    for rl in jobs.values():
        rl.sort(key=lambda r: r["ts"])
    fleet = None
    if replicas or kinds.get("job_adopted") or kinds.get("lease_expired"):
        fleet = {"replicas": replicas,
                 "adoptions": kinds.get("job_adopted", 0),
                 "lease_expired": kinds.get("lease_expired", 0)}
    return {"spans": sum(a["count"] for a in names.values()),
            "fleet": fleet,
            "jobs": jobs,
            "names": names,
            "top": sorted(names.items(), key=lambda kv: -kv[1]["self_us"]),
            "iters": iters,
            "iter_total_us": sum(r["us"] for r in iters),
            "guard_self_us": guard_self_us,
            "root_us": root_us,
            "guard_pct": round(100.0 * guard_self_us / root_us, 2)
            if root_us else 0.0,
            "points": kinds}


def summarize_file(path: str) -> dict:
    return summarize(load_trace(path))


def format_summary(s: dict, top_n: int = 12) -> List[str]:
    """Human-readable summary lines for the ``splatt trace`` verb."""
    lines = [f"trace: {s['spans']} spans, "
             f"{sum(s['points'].values())} point events, "
             f"root {s['root_us'] / 1e6:.3f}s"]
    lines.append("top spans by self-time:")
    lines.append(f"  {'span':<26s} {'count':>6s} {'self':>10s} "
                 f"{'total':>10s}")
    for name, agg in s["top"][:top_n]:
        lines.append(f"  {name:<26s} {agg['count']:>6d} "
                     f"{agg['self_us'] / 1e6:>9.4f}s "
                     f"{agg['total_us'] / 1e6:>9.4f}s")
    if s["iters"]:
        n = len(s["iters"])
        mean = s["iter_total_us"] / n / 1e6
        lines.append(f"iterations: {n} spans, {mean:.4f}s mean "
                     f"({s['iter_total_us'] / 1e6:.3f}s total)")
        for r in s["iters"][:8]:
            fit = (f"  fit={r['fit']:.5f}"
                   if isinstance(r.get("fit"), float) else "")
            lines.append(f"  it {r['it']}: {r['us'] / 1e6:.4f}s{fit}")
        if n > 8:
            lines.append(f"  ... {n - 8} more")
    lines.append(f"guard overhead: {s['guard_self_us'] / 1e6:.4f}s "
                 f"self-time = {s['guard_pct']}% of the run "
                 f"(cpd.guard.* + guard.* spans)")
    if s.get("fleet"):
        fl = s["fleet"]
        per = ", ".join(f"{rid}={n}"
                        for rid, n in sorted(fl["replicas"].items())) \
            or "(no serve.job spans)"
        lines.append(f"fleet: {fl['adoptions']} adoption(s), "
                     f"{fl['lease_expired']} lease expir"
                     f"{'y' if fl['lease_expired'] == 1 else 'ies'}; "
                     f"jobs per replica: {per}")
        for job, rl in sorted((s.get("jobs") or {}).items()):
            if len(rl) < 2 and not any(r.get("adopted_from")
                                       for r in rl):
                continue  # single-owner jobs need no lineage line
            hops = " -> ".join(
                f"{r.get('replica') or '?'}"
                + (f"[adopted_from={r['adopted_from']}]"
                   if r.get("adopted_from") else "")
                + (f":{r['status']}" if r.get("status")
                   else (":open" if r.get("open") else ""))
                for r in rl)
            lines.append(f"  job {job}: {hops}")
    if s["points"]:
        evs = ", ".join(f"{k}x{v}"
                        for k, v in sorted(s["points"].items()))
        lines.append(f"point events: {evs}")
    return lines
