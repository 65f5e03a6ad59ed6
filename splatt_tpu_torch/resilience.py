"""Resilience layer: failure taxonomy, transient retry, engine demotion and
the run report (≙ splatt_tpu/resilience.py, cut to what the MTTKRP engine
chain needs).

- :func:`classify_failure` sorts an error into a :class:`FailureClass`
  by the same marker strings as the JAX package.  torch's ``CUDA out of
  memory`` message matches the ``out of memory`` RESOURCE marker, so an
  out-of-memory demotes an engine for one shape only.
- :func:`retry_transient` retries TRANSIENT failures in place with
  capped, jittered backoff; every other class propagates at once.
- :func:`demote_engine` / :func:`is_demoted` — the registry the engine
  chain (:func:`splatt_tpu_torch.ops.mttkrp.engine_chain`) prunes by.
  RESOURCE and TIMEOUT failures demote per shape, the rest process-wide.
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
  ``comm_fallback`` (a comm strategy degraded down its chain) and
  ``ring_overlap`` (a ring sweep's exchange time hidden under compute).

The state is process-wide, as outside any job scope in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import random
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

    def __init__(self):
        self._events: List[dict] = []

    def add(self, kind: str, **info) -> dict:
        ev = dict(kind=kind, ts=time.time(), **info)
        self._events.append(ev)
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
        return lines


@dataclasses.dataclass
class _State:
    demoted: Dict[str, "Demotion"] = dataclasses.field(default_factory=dict)
    report: RunReport = dataclasses.field(default_factory=RunReport)


_STATE = _State()


def run_report() -> RunReport:
    """The process-wide resilience event log."""
    return _STATE.report


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
    _STATE.demoted[_demotion_key(engine, shape_key)] = d
    run_report().add("engine_demotion", engine=engine,
                     failure_class=cls.value, shape_key=shape_key,
                     error=d.error[:200])
    return d


def is_demoted(engine: str, shape_key: Optional[str] = None) -> bool:
    """Whether `engine` was demoted process-wide, or for this shape."""
    demoted = _STATE.demoted
    if engine in demoted:
        return True
    return (shape_key is not None
            and _demotion_key(engine, shape_key) in demoted)


def demotions() -> List[Demotion]:
    return list(_STATE.demoted.values())


def reset_demotions() -> None:
    """Clear the runtime demotions (tests; a fresh run in one process)."""
    _STATE.demoted.clear()


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

