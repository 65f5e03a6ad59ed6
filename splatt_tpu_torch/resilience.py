"""Resilience layer: failure taxonomy, transient retry, engine demotion,
the deadline watchdog, job scopes and the run report
(≙ splatt_tpu/resilience.py, cut to what the engine chain and the guarded
ALS drivers need).

- :func:`classify_failure` sorts an error into a :class:`FailureClass`
  by the same marker strings as the JAX package.  torch's ``CUDA out of
  memory`` message matches the ``out of memory`` RESOURCE marker, so an
  out-of-memory demotes an engine for one shape only.
- :func:`retry_transient` retries TRANSIENT failures in place with
  capped, jittered backoff; every other class propagates at once.
- :func:`demote_engine` / :func:`is_demoted` — the registry the engine
  chain (:func:`splatt_tpu_torch.ops.mttkrp.engine_chain`) prunes by.
  RESOURCE and TIMEOUT failures demote per shape, the rest process-wide.
- :func:`note_engine_attempt` / :func:`last_engine_attempt` — the engine
  the chain last handed work to, which the ALS driver's sweep-level
  rescue demotes when an error surfaces later with no call-site context.
- :func:`deadline` — a watchdog around a host-side call (an engine's
  first launch per shape); a blown deadline raises
  :class:`DeadlineExceeded`, classified TIMEOUT.
- :func:`scope` — a per-job isolation unit of the demotions, the last
  attempt, the run report and the health/deadline budgets.
- :func:`run_report` — the event log the CLI prints after a run:
  ``engine_demotion``, ``transient_retry``, and the compact format's
  ``format_v2`` (the achieved per-mode encodings), ``format_fallback``
  (an encode, or with ``site="decode"`` a dispatch, degraded to v1),
  ``format_decode`` (where an engine's decode ran), ``block_clamp``
  (a requested nnz block cut to the tensor's size), the balanced
  layouts' ``packing_fallback`` (a balanced pack degraded to the fixed
  slicing) and ``reorder_fallback`` (a reorder degraded to identity
  order), ``layout_imbalance`` (the achieved balance of a built layout or
  of a distributed sharding), and the distributed path's
  ``local_engine`` (the per-rank engine a run takes), ``comm_fallback`` (a comm strategy degraded down its chain) and
  ``ring_overlap`` (a ring sweep's exchange time hidden under compute);
  the guarded drivers' ``health_nonfinite``, ``health_rollback``,
  ``health_degraded`` and ``checkpoint_recovery``, the watchdog's
  ``deadline_blown`` and the trace exporter's ``trace_written``
  (:data:`RUN_REPORT_EVENTS`).  Every event is also a
  :func:`splatt_tpu_torch.trace.point`.

Outside any :func:`scope` the state is process-wide.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import enum
import random
import threading
import time
from typing import Callable, Dict, List, Optional


class FailureClass(enum.Enum):
    """What a probe/compile/runtime failure means for future dispatch."""

    DETERMINISTIC = "deterministic"   # persist: will always fail here
    TRANSIENT = "transient"           # retry w/ backoff; never persist
    RESOURCE = "resource"             # demote for this shape only
    UNKNOWN = "unknown"               # unproven
    NUMERICAL = "numerical"           # non-finite factors/fit
    TIMEOUT = "timeout"               # a deadline blew: demote per shape


# capacity first: an OOM message may also name a kernel compiler, and
# the right verdict there is a per-shape demotion
RESOURCE_MARKERS = (
    "RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM",
    "vmem limit", "VMEM limit", "scoped vmem", "exceeds the limit",
    "Attempting to allocate", "Attempting to reserve",
)

# proven kernel-compiler rejections and content-deterministic refusals
DETERMINISTIC_MARKERS = (
    "Mosaic", "mosaic", "Internal TPU kernel compiler",
    "Invalid input layout", "Unsupported lowering",
    "not implemented", "NotImplementedError",
    "truncated or torn", "ragged row", "bad token",
)

# service and relay hiccups: retried with backoff, never persisted
TRANSIENT_MARKERS = (
    "HTTP code 500", "HTTP code 502", "HTTP code 503", "HTTP code 504",
    "INTERNAL: ", "UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED",
    "Connection reset", "Connection refused", "Socket closed",
    "Broken pipe", "timed out", "TimeoutError",
    "temporarily unavailable", "Transient",
)

# a deadline the project set and blew: per-shape, like RESOURCE
TIMEOUT_MARKERS = ("splatt deadline blown",)

# non-finite factors/λ/fit: never evidence against an engine
NUMERICAL_MARKERS = ("non-finite", "NonFinite", "NumericalHealthError")


# a CUDA error that leaves the context unusable: it surfaces at a later
# sync, and every later launch fails too, so nothing retries it
STICKY_CUDA_MARKERS = (
    "illegal memory access", "an illegal instruction",
    "unspecified launch failure", "misaligned address",
    "device-side assert", "cudaErrorIllegalAddress",
    "cudaErrorLaunchFailure", "cudaErrorIllegalInstruction",
)


class DeadlineExceeded(RuntimeError):
    """The watchdog (:func:`deadline`) blew on a host-side call.
    Classifies as TIMEOUT: demoted per shape, like an out-of-memory."""


class NumericalHealthError(RuntimeError):
    """The numerical-health sentinel found non-finite factors, λ or fit
    in a sweep's outputs.  Classifies as NUMERICAL: rollback owns it,
    never the demotion registry."""


def sticky_cuda_error(exc) -> bool:
    """Whether `exc` is a CUDA error that poisons the context (an
    illegal address, a launch failure, a device-side assert): it is
    never rescued, because a rebuilt sweep on that context fails
    again."""
    msg = failure_message(exc)
    return any(m in msg for m in STICKY_CUDA_MARKERS)


def failure_message(exc) -> str:
    """The string classification runs on: "ExcType: message"."""
    if isinstance(exc, str):
        return exc
    return f"{type(exc).__name__}: {exc}"


def classify_failure(exc) -> FailureClass:
    """Classify an error (exception or message).  Order matters:
    TIMEOUT and NUMERICAL markers are exact and win; RESOURCE outranks
    DETERMINISTIC, which outranks TRANSIENT."""
    msg = failure_message(exc)
    if any(m in msg for m in TIMEOUT_MARKERS):
        return FailureClass.TIMEOUT
    if any(m in msg for m in NUMERICAL_MARKERS):
        return FailureClass.NUMERICAL
    if any(m in msg for m in RESOURCE_MARKERS):
        return FailureClass.RESOURCE
    if any(m in msg for m in DETERMINISTIC_MARKERS):
        return FailureClass.DETERMINISTIC
    if any(m in msg for m in TRANSIENT_MARKERS):
        return FailureClass.TRANSIENT
    return FailureClass.UNKNOWN


# -- run report --------------------------------------------------------------


class RunReport:
    """Append-only log of resilience events for one run; the CLI prints
    :meth:`summary` after the run and tests assert on :meth:`events`."""

    def __init__(self, job_id: Optional[str] = None):
        self._events: List[dict] = []
        self.job_id = job_id

    def add(self, kind: str, **info) -> dict:
        ev = dict(kind=kind, ts=time.time(), **info)
        if self.job_id is not None and "job" not in ev:
            ev["job"] = self.job_id
        self._events.append(ev)
        # every event is also a point on the trace and feeds the
        # always-on metrics registry
        from splatt_tpu_torch import trace

        trace.point(kind, ev)
        return ev

    def events(self, kind: Optional[str] = None) -> List[dict]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e["kind"] == kind]

    def clear(self) -> None:
        self._events.clear()

    def summary(self) -> List[str]:
        """Human-readable lines, one per noteworthy event (retries are
        aggregated)."""
        lines = []
        retries = self.events("transient_retry")
        if retries:
            lines.append(f"  {len(retries)} transient failure(s) retried "
                         f"with backoff")
        for e in self.events("engine_demotion"):
            scope = (f"shape {e['shape_key']}" if e.get("shape_key")
                     else "this process")
            lines.append(f"  engine {e['engine']} demoted for {scope} "
                         f"({e['failure_class']}: {e['error'][:80]})")
        for e in self.events("checkpoint_recovery"):
            lines.append(f"  checkpoint {e['path']} was corrupt "
                         f"({e['error'][:80]}); {e['action']}")
        negatives = self.events("tuner_negative")
        if negatives:
            lines.append(f"  {len(negatives)} autotuner candidate(s) "
                         f"failed to measure (deterministic failures "
                         f"recorded as negative plan-cache entries)")
        for e in self.events("tuner_degraded"):
            why = e.get("reason") or ("no measurable candidate — "
                                      "dispatch keeps the heuristic "
                                      "chain")
            lines.append(f"  autotuner: mode {e['mode']}: {why}")
        for e in self.events("tune_cache_io_error"):
            lines.append(f"  plan cache {e.get('op')} failed "
                         f"({e['failure_class']}: {e['error'][:80]}); "
                         f"degraded to re-tuning")
        nonfinite = self.events("health_nonfinite")
        if nonfinite:
            its = sorted({e.get("iteration") for e in nonfinite})
            lines.append(f"  numerical-health sentinel: non-finite "
                         f"sweep outputs at iteration(s) "
                         f"{', '.join(str(i) for i in its)}")
        for e in self.events("health_rollback"):
            lines.append(f"  rolled back to the last-good snapshot at "
                         f"iteration {e.get('iteration')} (attempt "
                         f"{e.get('attempt')}: reg={e.get('regularization')}"
                         f", re-randomized modes "
                         f"{e.get('rerandomized') or []})")
        for e in self.events("health_degraded"):
            lines.append(f"  HEALTH BUDGET EXHAUSTED at iteration "
                         f"{e.get('iteration')}: returned the last-good "
                         f"state ({e.get('action')})")
        for e in self.events("deadline_blown"):
            lines.append(f"  deadline watchdog blew at {e['site']} "
                         f"({e['seconds']:g}s budget)")
        for e in self.events("format_fallback"):
            if e.get("site") == "decode":
                lines.append(f"  compact-format decode failed at "
                             f"dispatch for mode {e.get('mode')} "
                             f"({e['failure_class']}: "
                             f"{e['error'][:80]}); degraded to the "
                             f"materialized v1 i32 path")
            elif e.get("site") == "dense":
                lines.append(f"  dense tile-layout build failed for "
                             f"mode {e.get('mode')} "
                             f"({e['failure_class']}: "
                             f"{e['error'][:80]}); mode keeps the "
                             f"sparse blocked encoding")
            else:
                lines.append(f"  compact-format encode failed for mode "
                             f"{e.get('mode')} "
                             f"(requested {e.get('idx_width')}; "
                             f"{e['failure_class']}: {e['error'][:80]}); "
                             f"degraded to the v1 i32 encoding")
        for e in self.events("dense_dispatch"):
            lines.append(f"  dense-mode dispatch [{e.get('engine')}]: "
                         f"mode {e.get('mode')} as "
                         f"{e.get('tile')}x{e.get('span')} value tiles "
                         f"({e.get('density_bucket') or 'dense'}; zero "
                         f"index bytes)")
        for e in self.events("packing_fallback"):
            lines.append(f"  balanced fiber pack failed for mode "
                         f"{e.get('mode')} ({e['failure_class']}: "
                         f"{e['error'][:80]}); degraded to fixed "
                         f"slicing")
        for e in self.events("reorder_fallback"):
            lines.append(f"  reorder recipe {e.get('how')!r} failed "
                         f"({e['failure_class']}: {e['error'][:80]}); "
                         f"degraded to identity order")
        for e in self.events("layout_imbalance"):
            # only imbalanced layouts and shardings are worth a line; the
            # full stats always ride in the --json events
            worst = max(e.get("block_nnz_max_mean", 1.0) or 1.0,
                        e.get("shard_max_mean", 1.0) or 1.0)
            if worst > 1.5:
                where = (f"{e.get('scope', 'layout')} mode {e['mode']}"
                         if "mode" in e else e.get("scope", "sharding"))
                lines.append(f"  load imbalance at {where} "
                             f"[{e.get('packing', e.get('policy', '?'))}]"
                             f": max/mean {worst} "
                             f"(seg_width {e.get('seg_width', '-')}, "
                             f"work x{e.get('work_amp', '-')}/nnz)")
        for e in self.events("local_engine"):
            lines.append(f"  per-rank engine: {e['engine']}"
                         + (f", out of core under {e['out_of_core']}"
                            if e.get("out_of_core") else ""))
        for e in self.events("comm_fallback"):
            lines.append(f"  comm engine {e['strategy']} degraded to "
                         f"{e['fallback_to']} ({e['failure_class']}: "
                         f"{e['error'][:80]})")
        for e in self.events("ring_overlap"):
            lines.append(f"  ring overlap [{e.get('engine')}]: "
                         f"{100 * e.get('overlap_frac', 0):.0f}% of "
                         f"{e.get('exchange_s')}s exchange hidden under "
                         f"compute ({e.get('model_mb_per_device')}MB/dev "
                         f"modeled)")
        for e in self.events("job_adopted"):
            lines.append(f"  job {e.get('job')} ADOPTED by "
                         f"{e.get('replica')} from dead peer "
                         f"{e.get('from_replica')}")
        for e in self.events("lease_expired"):
            if e.get("role") == "owner":
                lines.append(f"  job {e.get('job')}: lease expired under "
                             f"{e.get('replica')}; abandoned uncommitted "
                             f"(a peer may adopt)")
        routed = self.events("affinity_routed")
        if routed:
            by_reason: Dict[str, int] = {}
            for e in routed:
                by_reason[e.get("reason", "?")] = \
                    by_reason.get(e.get("reason", "?"), 0) + 1
            lines.append("  affinity routing: " + ", ".join(
                f"{k}x{v}" for k, v in sorted(by_reason.items())))
        for e in self.events("flight_degraded"):
            lines.append(f"  flight recorder {e.get('path')} DISARMED "
                         f"({e.get('failure_class')}: "
                         f"{str(e.get('error', ''))[:80]})")
        for e in self.events("trace_written"):
            if e.get("ok"):
                lines.append(f"  trace written to {e.get('path')} "
                             f"({e.get('spans')} spans, "
                             f"{e.get('events')} point events)")
            else:
                lines.append(f"  trace export {e.get('path')} degraded "
                             f"({e.get('failure_class')}: "
                             f"{str(e.get('error', ''))[:80]})")
        return lines


# -- per-job scoping ----------------------------------------------------------


@dataclasses.dataclass
class ResilienceScope:
    """One isolation unit of mutable resilience state: the demotion
    table, the last-attempt note, the run report, and per-scope
    overrides of the health-retry budget and the watchdog deadline (None
    = the env/process default) (≙ splatt_tpu.resilience.ResilienceScope).
    """

    job_id: Optional[str] = None
    demoted: Dict[str, "Demotion"] = dataclasses.field(default_factory=dict)
    last_attempt: Optional[tuple] = None
    health_retries: Optional[int] = None
    deadline_s: Optional[float] = None
    report: RunReport = None

    def __post_init__(self):
        if self.report is None:
            self.report = RunReport(job_id=self.job_id)


_GLOBAL_SCOPE = ResilienceScope()
_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "splatt_torch_resilience_scope", default=None)


def _state() -> ResilienceScope:
    """The active scope: the contextvar's inside :func:`scope`, else the
    process-global one."""
    return _SCOPE.get() or _GLOBAL_SCOPE


def current_job() -> Optional[str]:
    """The job id of the active scope, or None outside any scope."""
    sc = _SCOPE.get()
    return sc.job_id if sc is not None else None


def scope_health_retries() -> Optional[int]:
    """The active scope's health-retry budget, or None (the env default
    applies); read by ``cpd.health_retries``."""
    sc = _SCOPE.get()
    return sc.health_retries if sc is not None else None


@contextlib.contextmanager
def scope(job_id: str, health_retries: Optional[int] = None,
          deadline_s: Optional[float] = None):
    """Enter a fresh per-job scope: demotions, the last-attempt note,
    every run-report event and the eigensolver's cap flag
    (:func:`ops.linalg.solver_scope`) inside the block belong to
    `job_id` and are isolated from the global scope and from sibling
    jobs.  A scope starts empty.  `health_retries` / `deadline_s`
    override the sentinel budget and the watchdog deadline for this job
    only."""
    from splatt_tpu_torch.ops.linalg import solver_scope

    st = ResilienceScope(job_id=str(job_id), health_retries=health_retries,
                         deadline_s=deadline_s)
    token = _SCOPE.set(st)
    try:
        # the eigensolver's cap flag is the scope's own word too: a
        # sibling job's cap hit never raises, or is cleared, here
        with solver_scope():
            yield st
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def unscoped():
    """Run the block in the process-global scope, outside any job's: what
    it reports belongs to the process (a fleet replica losing a job's
    lease mid-run, whose job keeps no result to carry the event)."""
    token = _SCOPE.set(None)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def run_report() -> RunReport:
    """The active scope's event log (the process-wide log outside any
    :func:`scope`)."""
    return _state().report


#: every run-report event kind the port emits, name -> one-line doc
RUN_REPORT_EVENTS = {
    "transient_retry": "a transient failure was retried in place with "
                       "capped backoff and jitter (retry_transient)",
    "engine_demotion": "an MTTKRP engine (or comm.<strategy>) was "
                       "demoted at runtime, process-wide or per shape",
    "checkpoint_recovery": "a corrupt or torn checkpoint degraded the "
                           "resume to the .bak generation or a fresh "
                           "start (cpd.load_checkpoint_resilient)",
    "health_nonfinite": "the numerical-health sentinel found non-finite "
                        "factors, λ or fit in a sweep's outputs at a "
                        "fit-check iteration",
    "health_rollback": "the ALS driver rolled back to the last-good "
                       "snapshot, raised regularization and/or "
                       "re-randomized the offending factors, and "
                       "retried the sweep",
    "health_degraded": "the rollback budget (SPLATT_HEALTH_RETRIES) was "
                       "exhausted: the run checkpointed the last-good "
                       "state and stopped early",
    "deadline_blown": "the deadline watchdog expired on a host-side "
                      "call; classified TIMEOUT and demoted per shape",
    "bench_path_error": "one measured path failed; the error was "
                        "classified and recorded and the other paths "
                        "continued (record_path_error)",
    "tune_cache_io_error": "plan-cache IO failed and was degraded "
                           "(dispatch falls back to re-tuning or the "
                           "heuristic chain)",
    "tuned_plan": "cpd_als dispatched through autotuned MTTKRP plans; "
                  "carries the per-mode plans",
    "tuner_negative": "an autotuner candidate failed to measure; "
                      "deterministic/resource failures persist as "
                      "negative plan-cache entries",
    "tuner_degraded": "a mode keeps the heuristic chain instead of a "
                      "tuned plan: no candidate was measurable, or the "
                      "plan could not apply under the resolved "
                      "whole-tensor storage, reorder or packing "
                      "(blocked.py)",
    "format_v2": "blocked layouts were built at a non-default encoding",
    "format_fallback": "a compact-format encode, a stream decode at "
                       "dispatch (site=decode) or a dense tile build "
                       "(site=dense) failed and degraded classified",
    "format_decode": "an engine's first dispatch over a compact layout: "
                     "where its decode runs",
    "dense_dispatch": "an engine's first dispatch over a dense-mode "
                      "layout",
    "block_clamp": "a requested nnz block was cut to the tensor's size",
    "packing_fallback": "a balanced fiber pack degraded to the fixed "
                        "slicing",
    "reorder_fallback": "a reorder degraded to identity order",
    "layout_imbalance": "the achieved balance of a built layout or a "
                        "distributed sharding",
    "local_engine": "the per-rank MTTKRP engine a distributed CPD runs "
                    "and the scratch directory its build memmaps under",
    "comm_fallback": "a comm strategy degraded down its chain",
    "ring_overlap": "a ring sweep's exchange time hidden under compute",
    "trace_written": "a Chrome trace-event export was written, or "
                     "failed classified (trace.write_chrome_trace)",
    "metrics_snapshot": "the metrics registry was written as Prometheus "
                        "text (trace.write_metrics), or failed "
                        "classified",
    "job_accepted": "the serve daemon journaled a job submission and "
                    "queued it",
    "job_resumed": "journal replay re-queued a non-terminal job, which "
                   "resumes from its checkpoint",
    "job_started": "a serve worker began running an accepted job",
    "queue_full": "a bounded serve queue (the fit queue or the predict "
                  "lane) load-shed a submission",
    "quota_rejected": "admission control shed a submission: its tenant "
                      "was at its quota of non-terminal jobs",
    "job_degraded": "a supervised job finished degraded or failed, with "
                    "its failure class",
    "journal_torn": "journal replay skipped one unparseable record "
                    "(crash debris)",
    "journal_unknown_kind": "journal replay skipped a record whose kind "
                            "this version does not know",
    "batch_dispatched": "the serve daemon dispatched same-regime jobs as "
                        "one batched CPD",
    "batch_degraded": "a coalesced batch failed and degraded classified "
                      "to per-tensor dispatch of its members",
    "refit_scheduled": "an update job took the full-refit repair path "
                       "(no model, periodic, health, or a failed warm "
                       "path)",
    "update_applied": "an update job committed its warm sweeps",
    "model_generation_advanced": "a model commit advanced the model's "
                                 "generation stamp",
    "model_torn": "a model-store piece (a stamp, a checkpoint against its "
                  "stamp, a model tensor) failed to verify and was "
                  "skipped classified",
    "predict_served": "a predict job answered from a fenced model "
                      "generation",
    "predict_degraded": "a predict job's cache lookup or fenced read "
                        "failed classified (a refusal when nothing "
                        "intact was left)",
    "slo_burn": "an SLO's error budget burned at >= the alert multiple "
                "on both windows (fleetobs.SloEvaluator)",
    "job_adopted": "a fleet replica took over a dead peer's non-terminal "
                   "job after its lease expired; the job resumes from its "
                   "checkpoint on the adopter",
    "lease_expired": "a job lease expired: role=owner, this replica's "
                     "renew was refused and the running job was abandoned "
                     "uncommitted; role=adopter, an expired lease was "
                     "taken over",
    "affinity_routed": "the fleet scheduler made a cache-affinity "
                       "decision: a job run on this replica's warm caches "
                       "(warm_local), left for a warm peer (deferred), or "
                       "taken anyway at the deferral cap (load_tiebreak)",
    "flight_degraded": "a flight-recorder ring flush failed: the recorder "
                       "is disarmed for the rest of the process, the "
                       "failure classified",
    "crash_windows_exercised": "which durable-operation crash windows a "
                               "chaos soak's kill landed in (chaos.py "
                               "_crash_windows_exercised)",
    "cuda_context_lost": "a serve job met a sticky CUDA error: the daemon "
                         "drains, and every job on the card is journaled "
                         "interrupted for a fresh process to resume",
}


def record_path_error(label: str, exc) -> dict:
    """Classify one measured path's failure into a ``bench_path_error``
    event and return it, so the path is recorded and skipped instead of
    ending the whole measurement."""
    return run_report().add(
        "bench_path_error", path=label,
        failure_class=classify_failure(exc).value,
        error=failure_message(exc)[:200])


# -- transient retry ---------------------------------------------------------

TRANSIENT_RETRIES = 3
BACKOFF_BASE_S = 0.5
BACKOFF_CAP_S = 8.0


def retry_transient(fn: Callable, attempts: int = None,
                    base: float = BACKOFF_BASE_S,
                    cap: float = BACKOFF_CAP_S,
                    sleep: Optional[Callable] = None,
                    rng: Optional[Callable] = None,
                    label: str = "") -> object:
    """Run `fn`, retrying ONLY transient failures with capped
    exponential backoff and full jitter (delay ~ U(0, min(cap,
    base·2^a))).  Every other class propagates at once.  `sleep`/`rng`
    are injectable for tests."""
    if attempts is None:
        attempts = TRANSIENT_RETRIES
    if sleep is None:
        sleep = time.sleep
    if rng is None:
        rng = random.random
    for a in range(max(attempts, 1)):
        try:
            return fn()
        except Exception as e:
            if (classify_failure(e) is not FailureClass.TRANSIENT
                    or a >= attempts - 1):
                raise
            delay = min(cap, base * (2 ** a)) * rng()
            run_report().add("transient_retry", label=label,
                             attempt=a + 1, delay_s=round(delay, 3),
                             error=failure_message(e)[:200])
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover


# -- engine demotion registry ------------------------------------------------


@dataclasses.dataclass
class Demotion:
    """One runtime engine demotion: which engine, why, and its scope
    (shape_key=None means process-wide; otherwise this shape only)."""

    engine: str
    failure_class: FailureClass
    error: str
    shape_key: Optional[str] = None
    ts: float = dataclasses.field(default_factory=time.time)


def _demotion_key(engine: str, shape_key: Optional[str]) -> str:
    return engine if shape_key is None else f"{engine}@{shape_key}"


def demote_engine(engine: str, error, shape_key: Optional[str] = None
                  ) -> Demotion:
    """Record a runtime demotion of `engine`; the chain skips it from
    now on.  RESOURCE and TIMEOUT failures demote for `shape_key` only,
    everything else process-wide.  Never persisted."""
    cls = classify_failure(error)
    if cls not in (FailureClass.RESOURCE, FailureClass.TIMEOUT):
        shape_key = None
    d = Demotion(engine=engine, failure_class=cls,
                 error=failure_message(error)[:500], shape_key=shape_key)
    _state().demoted[_demotion_key(engine, shape_key)] = d
    run_report().add("engine_demotion", engine=engine,
                     failure_class=cls.value, shape_key=shape_key,
                     error=d.error[:200])
    return d


def is_demoted(engine: str, shape_key: Optional[str] = None) -> bool:
    """Whether `engine` was demoted process-wide, or for this shape."""
    demoted = _state().demoted
    if engine in demoted:
        return True
    return (shape_key is not None
            and _demotion_key(engine, shape_key) in demoted)


def demotions() -> List[Demotion]:
    return list(_state().demoted.values())


def reset_demotions() -> None:
    """Clear the runtime demotions (tests; a fresh run in one process)."""
    _state().demoted.clear()


# -- last-attempt tracking ---------------------------------------------------
#
# A failure on the card can surface after the call that picked the engine,
# at a later sync.  The chain notes which engine it handed work to; the ALS
# driver's sweep-level rescue demotes that engine when an error arrives
# with no call-site context.


def note_engine_attempt(engine: str, shape_key: Optional[str] = None
                        ) -> None:
    _state().last_attempt = (engine, shape_key)


def last_engine_attempt() -> Optional[tuple]:
    """(engine, shape_key) of the active scope's most recent dispatch,
    or None."""
    return _state().last_attempt


# -- engine fallback switch --------------------------------------------------

_FALLBACK_ENV = "SPLATT_ENGINE_FALLBACK"


def fallback_enabled() -> bool:
    """Whether runtime engine fallback is on (default yes).  CLI
    ``--engine-fallback off`` / ``SPLATT_ENGINE_FALLBACK=0`` turn it
    off: a test chasing a kernel bug wants the crash, not the rescue.
    ``Options.engine_fallback`` overrides it for one :func:`cpd_als`."""
    from splatt_tpu_torch.utils.env import read_env

    return str(read_env(_FALLBACK_ENV)).lower() not in (
        "0", "off", "false", "no")



# -- deadline watchdog -------------------------------------------------------
#
# A host-side call that hangs (a first launch that never returns) is bounded
# by a plain threading.Timer: no signals, and from the main thread the timer
# interrupts the blocked call between bytecodes.  A launch in flight on the
# card completes first; the blown deadline then raises.

_DEADLINE_ENV = "SPLATT_DEADLINE_S"
_deadline_override: Optional[float] = None


def set_deadline(seconds: Optional[float]) -> None:
    """Process-wide deadline override of the :func:`deadline` sites (None
    restores the env default; <= 0 disables them even when
    SPLATT_DEADLINE_S is set; a site's own `default` still applies)."""
    global _deadline_override
    _deadline_override = seconds


def deadline_seconds(default: Optional[float] = None) -> Optional[float]:
    """The configured watchdog deadline: the active scope's override if
    set, else the process override (<= 0: disabled, the caller's
    `default` still applies), else SPLATT_DEADLINE_S, else `default`.
    None = disabled."""
    sc = _SCOPE.get()
    if sc is not None and sc.deadline_s is not None:
        if sc.deadline_s > 0:
            return sc.deadline_s
        return default
    if _deadline_override is not None:
        if _deadline_override > 0:
            return _deadline_override
        return default
    from splatt_tpu_torch.utils.env import read_env_float

    env = read_env_float(_DEADLINE_ENV)
    if env is not None and float(env) > 0:
        return float(env)
    return default


@contextlib.contextmanager
def deadline(site: str, seconds: Optional[float] = None):
    """Bound a host-side call: when the block runs longer than `seconds`
    (default :func:`deadline_seconds`), raise :class:`DeadlineExceeded`
    (TIMEOUT, demoted per shape) and record a ``deadline_blown`` event
    (≙ splatt_tpu.resilience.deadline).

    A daemon ``threading.Timer`` fires after `seconds`.  From the main
    thread it also calls ``_thread.interrupt_main()``, so a call blocked
    in Python is interrupted between bytecodes (a call inside C that
    holds the GIL gets the raise when it returns); off the main thread
    the blown deadline raises when the block completes.  A raced
    interrupt is absorbed inside the block, so no stray
    ``KeyboardInterrupt`` escapes into later work.
    """
    if seconds is None:
        seconds = deadline_seconds()
    if not seconds or seconds <= 0:
        yield
        return
    state = {"fired": False, "done": False}
    lock = threading.Lock()
    on_main = threading.current_thread() is threading.main_thread()

    def fire():
        # the fired flag and the interrupt are one critical section: once
        # the main thread reads fired=True the interrupt is pending, so
        # the absorb sleep below receives it
        with lock:
            if state["done"]:
                return
            state["fired"] = True
            if on_main:
                import _thread

                _thread.interrupt_main()

    from splatt_tpu_torch import trace

    with trace.span("guard.deadline.arm", site=site,
                    seconds=float(seconds)):
        timer = threading.Timer(seconds, fire)
        timer.daemon = True
        timer.start()

    def blew() -> DeadlineExceeded:
        run_report().add("deadline_blown", site=site,
                         seconds=float(seconds))
        return DeadlineExceeded(
            f"splatt deadline blown at {site} after {seconds:g}s "
            f"(host-side call exceeded the watchdog budget)")

    try:
        try:
            yield
        finally:
            with trace.span("guard.deadline.disarm", site=site):
                with lock:
                    state["done"] = True
                timer.cancel()
                if state["fired"] and on_main:
                    # absorb the pending interrupt here, inside the
                    # guarded region
                    try:
                        time.sleep(0.05)
                    except KeyboardInterrupt:
                        pass
    except KeyboardInterrupt:
        # a genuine Ctrl-C inside a blown-deadline window reads as the
        # timeout; a second one aborts
        if state["fired"]:
            raise blew() from None
        raise
    if state["fired"]:
        raise blew()
