"""Fault injection: the test hook points of the resilience layer
(≙ splatt_tpu/utils/faults.py, cut to the engine sites).

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
import dataclasses
import random
import sys
import threading
import time
from typing import Dict, Optional, Tuple

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


def _take(site: str, kinds: tuple) -> Optional[FaultSpec]:
    """Claim one firing of the fault armed at `site`, if any; `kinds`
    restricts which fault kinds this hook may claim."""
    with _LOCK:
        _load_env_locked()
        spec = _ACTIVE.get(site)
        if spec is None or spec.kind not in kinds:
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
