"""Fault injection: the test hook points of the resilience layer
(≙ splatt_tpu/utils/faults.py, cut to the engine, format, layout,
reorder, comm, checkpoint, sweep, trace-export, serve, predict and
model-store sites).

Production call sites call :func:`maybe_fail` / :func:`poison` with a
site name; tests (or an operator, via env var) arm faults against those
sites and the real error-handling paths run.

Arming a fault
    - context manager (tests)::

        with faults.inject("engine.fused_t", "oom"):
            ...   # the next fused_t dispatch raises an out-of-memory

    - env var (whole process, e.g. under the CLI)::

        SPLATT_FAULTS="engine.fused_t:runtime,engine.fused_tg:http500:2"

      Comma-separated ``site[:kind][:modifier]...`` specs; ``times``
      defaults to 1, ``*`` means every eligible call.  Schedule
      modifiers: ``iter=k`` (fire on the k-th call only, 1-based),
      ``p=x:seed=N`` (fire with probability x from a seeded draw),
      ``after=t`` (eligible t seconds after arming), ``delay=s`` (sleep
      length of the ``slow`` kind).  A spec without a kind defaults to
      ``runtime``.  :func:`parse_schedule` / :func:`format_schedule`
      round-trip the grammar.

:func:`scoped` overlays a per-context schedule on the process registry
(a job's own drill); :func:`consume` claims a non-raising fault (the torn
checkpoint write), :func:`active` and :func:`fired` read the registry.

Kinds map to canned exceptions whose messages classify as the JAX
package's do (:func:`splatt_tpu_torch.resilience.classify_failure`):
http500, internal, unavailable, timeout → transient; oom → resource;
mosaic → deterministic; runtime → unknown.  ``nan``/``inf`` are claimed
only by :func:`poison`, which multiplies the guarded value by NaN/Inf;
``slow`` makes :func:`maybe_fail` sleep instead of raising.  Every
exception :func:`maybe_fail` raises carries ``fault_site``
(:func:`injected`), so the engine chain can tell an armed fault from a
real error.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import random
import sys
import threading
import time
from typing import Dict, Optional, Tuple, Union

_FAULTS_ENV = "SPLATT_FAULTS"

#: times value meaning "every eligible call"
ALWAYS = -1

#: kinds whose firing RAISES a canned exception from maybe_fail
RAISING_KINDS = ("http500", "internal", "unavailable", "timeout",
                 "oom", "mosaic", "runtime")
#: kinds claimed only by poison(): corrupt a value instead of raising
POISON_KINDS = ("nan", "inf")
#: kinds claimed by maybe_fail() that sleep instead of raising
DELAY_KINDS = ("slow",)

#: default sleep of the ``slow`` kind (overridable per spec: delay=s)
SLOW_DELAY_S = 1.0

#: the declared fault sites of the port's production code, site → doc;
#: a trailing ``.*`` marks a family (the call passes an f-string)
SITES = {
    "engine.*": "an MTTKRP dispatch engine at call time, e.g. "
                "engine.fused_t / engine.xla_scan (ops/mttkrp.py); "
                "poison-armed specs corrupt the engine's OUTPUT "
                "instead of raising",
    "checkpoint_write": "raise during the checkpoint save (cpd.py)",
    "tuner.measure": "one autotuner candidate measurement, the warm and "
                     "timed MTTKRP calls of a forced engine (tune.py); "
                     "a raised fault skips the candidate, classified "
                     "(tuner_negative event): a mode left with no "
                     "measurable candidate keeps the heuristic chain "
                     "(tuner_degraded), never fails the tune",
    "checkpoint_torn": "consumed (not raised): the writer truncates "
                       "the bytes it just wrote, simulating a torn "
                       "write (cpd.py)",
    "cpd.sweep": "poisoned (not raised): corrupt one ALS sweep's "
                 "factor output with non-finite values, exercising "
                 "the numerical-health sentinel and its rollback "
                 "(cpd.py, parallel/common.py)",
    "cpd.batch.sweep": "poisoned (not raised): corrupt slot 0's last "
                       "factor of one batched sweep while the slot is "
                       "live, the per-slot isolation drill: slot 0 must "
                       "roll back alone (cpd.py cpd_als_batched)",
    "cpd.update": "the warm-update pre-pass (cpd.py "
                  "refresh_touched_rows); a raised fault surfaces to the "
                  "caller, which repairs it with a full refit",
    "trace.export": "the Chrome trace-event JSON export "
                    "(trace.write_chrome_trace); a raised fault must "
                    "degrade classified to a trace_written ok=False "
                    "event: losing the trace must never lose the run "
                    "it observed",
    "trace.flight": "one flight-recorder ring flush (trace.py "
                    "_flight_flush); a raised fault disarms the recorder "
                    "and degrades classified to a flight_degraded event: "
                    "losing the black box must never lose the run it "
                    "records",
    "fleet.lease_acquire": "one atomic job-lease acquisition (fleet.py "
                           "FleetMember.acquire, the flock + atomic-"
                           "rename claim); a raised fault drops the claim "
                           "classified, the job stays claimable and the "
                           "fleet scan re-surfaces it",
    "fleet.heartbeat": "one membership heartbeat and held-lease renewal "
                       "sweep (fleet.py FleetMember.beat); a raised fault "
                       "degrades classified: a missed beat makes the "
                       "replica look dead sooner, and peers adopt its "
                       "jobs after the lease",
    "fleet.adopt": "one dead-peer job takeover (fleet.py "
                   "FleetMember.adopt: an expired lease taken with a gen "
                   "bump); a raised fault leaves the job for the next "
                   "scan, classified",
    "format.encode": "the compact-format v2 encode of one blocked layout "
                     "(blocked.py build_layout/reencode_layout); a raised "
                     "fault degrades the build to the v1 int32 encoding "
                     "(format_fallback event), never fails it",
    "format.dense": "the dense tile-layout build of one mode (blocked.py "
                    "build_layout/from_coo/reencode_layout); a raised "
                    "fault degrades the build to the sparse blocked "
                    "encoding (format_fallback event with site=dense), "
                    "never fails it",
    "format.decode": "the compact layout's stream consumption at MTTKRP "
                     "dispatch (ops/mttkrp.py mttkrp_blocked); a raised "
                     "fault degrades the dispatch to the decoded v1 "
                     "layout (blocked.decode_to_v1, format_fallback event "
                     "with site=decode), never fails it",
    "layout.pack": "the balanced fiber packing of one blocked layout "
                   "(blocked.py build_layout); a raised fault degrades "
                   "the build to the fixed slicing (packing_fallback "
                   "event), never fails it",
    "reorder.apply": "the reorder permutation's compute and apply "
                     "(reorder.py apply_reorder); a raised fault degrades "
                     "the run to identity order (reorder_fallback "
                     "event), never fails it",
    "comm.ring_exchange": "the ring row-exchange of a distributed sweep "
                          "(parallel/ring_kernels.py and parallel/ring.py: "
                          "the ring kernels and the sync ring); on a CPU "
                          "mesh a raised fault degrades the sweep down "
                          "the comm chain, async_ring -> ring -> all2all "
                          "(comm_fallback events); on a CUDA mesh the "
                          "async_ring chain is the kernel alone, so it "
                          "raises",
    "serve.submit": "one job submission into the serve daemon's queue "
                    "(serve.py); a raised fault rejects that submission, "
                    "classified, and never kills the daemon",
    "serve.journal_write": "one durable journal append (serve.py); a "
                           "failure while journaling a submission rejects "
                           "the job (durability cannot be promised), a "
                           "failure on any later record degrades to "
                           "warn-and-continue",
    "serve.job_run": "the start of one supervised job (serve.py); a "
                     "raising kind marks the job failed, 'slow' holds "
                     "the job open (blowing a per-job deadline, or "
                     "pinning it for a kill-and-restart drill)",
    "serve.batch": "one coalesced batch dispatch (serve.py _run_batch); "
                   "a raised fault degrades the batch classified to "
                   "per-tensor dispatch of its members (batch_degraded "
                   "event): every member still reaches its own terminal "
                   "record",
    "predict.read": "the direct generation-fenced model read of one "
                    "predict (predict.py load_model_generation); a raised "
                    "fault refuses that predict classified "
                    "(predict_degraded event), never garbage",
    "predict.cache": "one hot-factor cache lookup on the predict lane "
                     "(predict.py HotFactorCache.get); a raised fault "
                     "degrades that predict classified to the direct "
                     "fenced read (predict_degraded event with a served "
                     "answer)",
    "model.generation": "the generation-stamp advance of one model commit "
                        "(predict.py advance_generation, called by "
                        "serve.py's fit and update commits); a raised "
                        "fault aborts that commit classified: the stamp "
                        "never advances, so readers keep serving the "
                        "previous generation",
    "ingest.read": "one chunk read from the raw record stream (ingest.py "
                   "IngestState.read_chunks); a raised fault aborts the "
                   "run classified with every committed chunk intact: a "
                   "re-run resumes from the journal watermark and re-reads "
                   "from the recorded byte offset, losing and duplicating "
                   "nothing",
    "ingest.vocab": "the vocab-delta publish of one chunk commit "
                    "(ingest.py IngestState.publish_vocab); a raised fault "
                    "aborts that chunk before its journal append, so the "
                    "watermark never moves and the vocab never lands "
                    "ahead of or behind the data",
    "ingest.commit": "the journal-append watermark fence of one chunk "
                     "commit (ingest.py IngestState.append_journal); a "
                     "raised fault leaves published segment/vocab debris "
                     "but no journal record, and the chunk re-commits "
                     "bit-identically on resume",
}


def _canned(kind: str, site: str) -> Exception:
    if kind == "http500":
        return RuntimeError(
            f"XLA:TPU compile failed: HTTP code 500 from remote compile "
            f"service (injected fault at {site})")
    if kind == "internal":
        return RuntimeError(
            f"INTERNAL: injected transient service failure at {site}")
    if kind == "unavailable":
        return RuntimeError(
            f"UNAVAILABLE: injected relay failure at {site}")
    if kind == "timeout":
        return TimeoutError(f"injected deadline expiry at {site}")
    if kind == "oom":
        return RuntimeError(
            f"RESOURCE_EXHAUSTED: injected out-of-memory at {site} "
            f"(attempting to allocate 128.00G)")
    if kind == "mosaic":
        return RuntimeError(
            f"Mosaic failed to compile the injected kernel at {site}")
    if kind == "runtime":
        return RuntimeError(f"injected engine runtime failure at {site}")
    raise ValueError(f"unknown fault kind {kind!r}")


def _validate_kind(kind: str) -> None:
    """Arm-time validation of every kind, raising or not."""
    if kind in POISON_KINDS or kind in DELAY_KINDS:
        return
    _canned(kind, "validate")  # raises ValueError on unknown kinds


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: what to do and the schedule deciding when.

    `times` bounds total firings (ALWAYS = unbounded); `iter_at`, `p`
    (+ `seed`) and `after` decide per-call eligibility.
    """

    kind: str
    times: int = 1          # remaining trigger count; ALWAYS = unbounded
    exc: Optional[Exception] = None   # overrides the canned exception
    fired: int = 0          # how often it actually triggered
    iter_at: Optional[int] = None     # fire on the N-th call only
    p: Optional[float] = None         # per-call Bernoulli probability
    seed: Optional[int] = None        # seeds the Bernoulli draw
    after: Optional[float] = None     # eligible after N seconds armed
    delay: Optional[float] = None     # 'slow' kind: sleep length
    calls: int = 0          # calls observed at the site since arming
    armed_ts: float = dataclasses.field(default_factory=time.monotonic)
    _rng: Optional[random.Random] = dataclasses.field(
        default=None, repr=False, compare=False)

    def rng(self) -> random.Random:
        if self._rng is None:
            self._rng = random.Random(self.seed)
        return self._rng


_LOCK = threading.Lock()
_ACTIVE: Dict[str, FaultSpec] = {}
_env_loaded = False


def parse_spec(item: str) -> Tuple[str, FaultSpec]:
    """Parse one ``site[:kind][:modifier]...`` spec → (site, FaultSpec).
    Raises ValueError on malformation."""
    parts = [p.strip() for p in item.split(":")]
    if len(parts) < 2 or not parts[0]:
        raise ValueError("want site:kind[:modifier]... or "
                         "site:modifier=value")
    site = parts[0]
    rest = parts[1:]
    kind = "runtime"
    if rest and "=" not in rest[0] and rest[0] != "*" \
            and not rest[0].isdigit():
        kind = rest[0]
        rest = rest[1:]
    _validate_kind(kind)
    spec = FaultSpec(kind=kind)
    for mod in rest:
        if mod == "*":
            spec.times = ALWAYS
        elif mod.isdigit():
            spec.times = int(mod)
        elif "=" in mod:
            key, _, val = mod.partition("=")
            key = key.strip()
            val = val.strip()
            if key == "iter":
                spec.iter_at = int(val)
                if spec.iter_at < 1:
                    raise ValueError("iter= is 1-based")
            elif key == "p":
                spec.p = float(val)
                if not 0.0 <= spec.p <= 1.0:
                    raise ValueError("p= must lie in [0, 1]")
            elif key == "seed":
                spec.seed = int(val)
            elif key == "after":
                spec.after = float(val)
            elif key == "delay":
                spec.delay = float(val)
            elif key == "times":
                spec.times = ALWAYS if val == "*" else int(val)
            else:
                raise ValueError(f"unknown schedule modifier {key!r}")
        else:
            raise ValueError(f"unparseable modifier {mod!r}")
    return site, spec


def format_spec(site: str, spec: FaultSpec) -> str:
    """Inverse of :func:`parse_spec`."""
    parts = [site, spec.kind]
    if spec.iter_at is not None:
        parts.append(f"iter={spec.iter_at}")
    if spec.p is not None:
        parts.append(f"p={spec.p:g}")
    if spec.seed is not None:
        parts.append(f"seed={spec.seed}")
    if spec.after is not None:
        parts.append(f"after={spec.after:g}")
    if spec.delay is not None:
        parts.append(f"delay={spec.delay:g}")
    if spec.times == ALWAYS:
        parts.append("*")
    elif spec.times != 1:
        parts.append(str(spec.times))
    return ":".join(parts)


def parse_schedule(text: str) -> Dict[str, FaultSpec]:
    """Parse a comma-separated schedule → {site: FaultSpec}.  Strict: a
    malformed entry raises (the env loader warns and ignores instead)."""
    out: Dict[str, FaultSpec] = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        site, spec = parse_spec(item)
        out[site] = spec
    return out


def format_schedule(schedule: Dict[str, FaultSpec]) -> str:
    """Inverse of :func:`parse_schedule`."""
    return ",".join(format_spec(site, spec)
                    for site, spec in schedule.items())


def arm(site: str, spec: FaultSpec) -> None:
    """Arm `spec` at `site` until :func:`reset`."""
    with _LOCK:
        _load_env_locked()
        _ACTIVE[site] = spec


def _load_env_locked() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    from splatt_tpu_torch.utils.env import read_env

    for item in read_env(_FAULTS_ENV).split(","):
        item = item.strip()
        if not item:
            continue
        # a typo in a production env var must not kill the run at some
        # random hook site: warn and ignore
        try:
            site, spec = parse_spec(item)
        except ValueError as e:
            print(f"splatt-tpu-torch: bad {_FAULTS_ENV} entry {item!r} "
                  f"({e}); ignored", file=sys.stderr)
            continue
        _ACTIVE[site] = spec


def _eligible_locked(spec: FaultSpec) -> bool:
    """Whether THIS call (already counted) satisfies the schedule."""
    if spec.iter_at is not None and spec.calls != spec.iter_at:
        return False
    if spec.after is not None \
            and time.monotonic() - spec.armed_ts < spec.after:
        return False
    if spec.p is not None and not spec.rng().random() < spec.p:
        return False
    return True


#: per-context overlay of the registry (:func:`scoped`): a site the
#: overlay names is governed by the overlay's spec, every other site by
#: the process registry
_SCOPED: contextvars.ContextVar = contextvars.ContextVar(
    "splatt_torch_faults_scope", default=None)


def _lookup_locked(site: str) -> Optional[FaultSpec]:
    """The spec governing `site` in this context: the scoped overlay's
    when it names the site, else the process registry's."""
    overlay = _SCOPED.get()
    if overlay is not None and site in overlay:
        return overlay[site]
    return _ACTIVE.get(site)


@contextlib.contextmanager
def scoped(schedule: Union[str, Dict[str, FaultSpec], None]):
    """Arm a per-context fault schedule (the SPLATT_FAULTS grammar, or a
    {site: FaultSpec} dict) over the process registry for the block;
    yields the {site: FaultSpec} dict, whose ``fired`` counters say what
    fired."""
    if schedule is None:
        specs: Dict[str, FaultSpec] = {}
    elif isinstance(schedule, str):
        specs = parse_schedule(schedule)
    else:
        specs = dict(schedule)
    token = _SCOPED.set(specs)
    try:
        yield specs
    finally:
        _SCOPED.reset(token)


def _take(site: str, kinds: Optional[tuple] = None) -> Optional[FaultSpec]:
    """Claim one firing of the fault armed at `site`, if any; `kinds`
    restricts which fault kinds this hook may claim (None: any)."""
    with _LOCK:
        _load_env_locked()
        spec = _lookup_locked(site)
        if spec is None or (kinds is not None and spec.kind not in kinds):
            return None
        spec.calls += 1
        if spec.times == 0 or not _eligible_locked(spec):
            return None
        if spec.times != ALWAYS:
            spec.times -= 1
        spec.fired += 1
        return spec


def maybe_fail(site: str) -> None:
    """Production hook: raise the armed fault for `site`, if any (marked
    with ``fault_site``), or sleep for the ``slow`` kind.  One dict
    lookup when nothing is armed."""
    spec = _take(site, RAISING_KINDS + DELAY_KINDS)
    if spec is None:
        return
    if spec.kind in DELAY_KINDS:
        time.sleep(spec.delay if spec.delay is not None else SLOW_DELAY_S)
        return
    exc = spec.exc if spec.exc is not None else _canned(spec.kind, site)
    exc.fault_site = site
    raise exc


def injected(exc: BaseException) -> bool:
    """Whether `exc` was raised by :func:`maybe_fail`."""
    return getattr(exc, "fault_site", None) is not None


def poison(site: str, value):
    """Production hook for non-finite injection: `value` times NaN/Inf
    when a ``nan``/``inf`` fault fires at `site`, else `value`."""
    spec = _take(site, POISON_KINDS)
    if spec is None:
        return value
    return value * float("nan" if spec.kind == "nan" else "inf")


def poison_many(site: str, values):
    """:func:`poison` over several tensors at one claim: every entry of
    the list `values` times NaN/Inf when a ``nan``/``inf`` fault fires at
    `site` (a factor held as one block per rank is poisoned whole), else
    `values` itself."""
    spec = _take(site, POISON_KINDS)
    if spec is None:
        return values
    scale = float("nan" if spec.kind == "nan" else "inf")
    return [v * scale for v in values]


def consume(site: str) -> bool:
    """Production hook of a non-raising fault (the torn checkpoint
    write): True when a fault armed at `site` fires (one firing is
    claimed)."""
    return _take(site) is not None


def active(site: str) -> bool:
    """Whether a fault is armed at `site` (nothing is claimed), the
    scoped overlay included."""
    with _LOCK:
        _load_env_locked()
        spec = _lookup_locked(site)
        return spec is not None and spec.times != 0


def fired(site: Optional[str] = None):
    """How often armed faults fired: a count for one `site`, or
    {site: count} for every armed site."""
    with _LOCK:
        _load_env_locked()
        overlay = _SCOPED.get() or {}
        if site is not None:
            spec = _lookup_locked(site)
            return spec.fired if spec is not None else 0
        merged = dict(_ACTIVE)
        merged.update(overlay)
        return {s: spec.fired for s, spec in merged.items()}


@contextlib.contextmanager
def inject(site: str, kind: str = "runtime", times: int = 1,
           exc: Optional[Exception] = None,
           iter_at: Optional[int] = None, p: Optional[float] = None,
           seed: Optional[int] = None, after: Optional[float] = None,
           delay: Optional[float] = None):
    """Arm a fault at `site` for the duration of the block (tests)."""
    if exc is None:
        _validate_kind(kind)
    spec = FaultSpec(kind=kind, times=times, exc=exc, iter_at=iter_at,
                     p=p, seed=seed, after=after, delay=delay)
    with _LOCK:
        _load_env_locked()
        prev = _ACTIVE.get(site)
        _ACTIVE[site] = spec
    try:
        yield spec
    finally:
        with _LOCK:
            if prev is None:
                _ACTIVE.pop(site, None)
            else:
                _ACTIVE[site] = prev


def reset() -> None:
    """Disarm everything and forget the env parse."""
    global _env_loaded
    with _LOCK:
        _ACTIVE.clear()
        _env_loaded = False
