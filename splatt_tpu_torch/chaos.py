"""The chaos soaks and the serve daemon's seeded workloads
(≙ splatt_tpu/chaos.py, apart from ``run_bench_gate``).

:func:`synthetic_tensor` builds the tensor of a job spec's
``{"synthetic": {dims, nnz, seed}}`` workload and of an update's
``{"delta": ...}``.

:func:`run_chaos` (``chaos``) runs a small seeded CPD under a declarative
fault schedule and checks the guarded-execution invariant: converged or
gracefully degraded, nothing escaped, every fired fault left its
run-report evidence, every event kind declared.  On a CPU tensor it runs
the JAX package's schedule and invariant unchanged.  On the card it runs
:data:`CARD_SCHEDULE`, since a CUDA chain holds only kernel engines and a
CUDA mesh's ``ASYNC_RING`` has no fallback: every armed site must fire,
the kernel engine's failure must demote it to another kernel engine, and
the comm drill must raise the injected failure (a drill that completes
would be a hidden fallback).

:func:`run_serve_chaos` (``chaos --serve``) SIGKILLs a ``serve`` daemon
subprocess mid-job and restarts it: no accepted job lost, the NaN tenant
contained.  :func:`run_ingest_chaos` (``chaos --ingest``) SIGKILLs an
``ingest`` subprocess mid-stream and audits the resumed run's chunk
journal for exactly-once accounting.

:func:`run_fleet_chaos` (``chaos --fleet``) drives a real fleet of ``serve
--fleet`` replica subprocesses over one spool under multi-tenant load,
SIGKILLs the replica running a pinned job, restarts a replacement, and
audits the failover from the shared journal, the replicas' Prometheus
snapshots, Chrome traces and flight rings, and ``status``: no accepted job
lost, a single-owner lineage for every job, the pinned job adopted and
its warm plan-cache hits kept, tenants isolated, the kill visible in the
fleet aggregate (adoption, lease expiry, an SLO burn that recovers) and
in the victim's flight ring, the generation-fenced predicts never stale.

The daemons run on the card unless a soak is asked for the CPU; the
ingest soak is host code.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np


def synthetic_tensor(dims, nnz: int, seed: int):
    """Seeded power-law tensor, deduplicated and with empty slices
    removed, so the CPD's shapes are exact; the same draws and the same
    tensor as the JAX package's for one seed."""
    from splatt_tpu_torch.coo import SparseTensor

    rng = np.random.default_rng(seed)
    inds = np.empty((len(dims), nnz), dtype=np.int64)
    for m, d in enumerate(dims):
        raw = rng.zipf(1.4, size=nnz).astype(np.int64)
        inds[m] = (raw + rng.integers(0, d, size=nnz)) % d
    vals = rng.random(nnz) + 0.1
    return SparseTensor(inds, vals, dims).deduplicate() \
                                         .remove_empty_slices()


#: the JAX package's default schedule: a NaN poisoning at a fixed
#: iteration (sentinel + rollback), a slow tuner measurement under the
#: deadline watchdog (TIMEOUT), a transient failure at the terminal
#: ``xla`` engine (retry with backoff), and a ring-exchange failure in the
#: distributed comm drill (degrading down the CPU mesh's comm chain).
#: Deterministic: every trigger is count- or iteration-keyed.
DEFAULT_SCHEDULE = ("cpd.sweep:nan:iter=2,"
                    "tuner.measure:slow:delay=1.5,"
                    "engine.xla:internal:1,"
                    "comm.ring_exchange:runtime:1")

#: the default schedule on the card: a CUDA chain has no ``xla`` engine,
#: so the engine leg arms the first kernel engine of the smoke tensor's
#: sorted modes, ``fused_t``, with a failure that demotes it (to
#: ``fused_tg``); the comm leg's ring exchange raises on a CUDA mesh,
#: whose ``ASYNC_RING`` is ``("async_ring",)`` alone.  On the card
#: :func:`run_chaos` arms the ``engine.*`` legs after its tuner leg, so the
#: engine fault fires at the CPD's first ``fused_t`` dispatch and not in a
#: tuner measurement (where it would leave ``tuner_negative`` and demote
#: nothing).
CARD_SCHEDULE = ("cpd.sweep:nan:iter=2,"
                 "tuner.measure:slow:delay=1.5,"
                 "engine.fused_t:runtime:1,"
                 "comm.ring_exchange:runtime:1")

#: expected run-report evidence per fired fault kind: at least one of
#: these event kinds must appear when a fault of that kind fired
#: (≙ splatt_tpu.chaos._EVIDENCE; ``probe_downgrade`` has no counterpart)
_EVIDENCE = {
    "nan": ("health_nonfinite", "health_rollback", "health_degraded"),
    "inf": ("health_nonfinite", "health_rollback", "health_degraded"),
    "slow": ("deadline_blown",),
    "http500": ("transient_retry", "engine_demotion", "tuner_negative",
                "comm_fallback"),
    "internal": ("transient_retry", "engine_demotion", "tuner_negative",
                 "comm_fallback"),
    "unavailable": ("transient_retry", "engine_demotion",
                    "tuner_negative", "comm_fallback"),
    "timeout": ("transient_retry", "engine_demotion", "tuner_negative",
                "comm_fallback"),
    "oom": ("engine_demotion", "tuner_negative", "comm_fallback"),
    "mosaic": ("engine_demotion", "tuner_negative", "comm_fallback"),
    "runtime": ("engine_demotion", "tuner_negative",
                "checkpoint_recovery", "comm_fallback"),
}

#: the MTTKRP kernel wrapper each kernel engine launches
_ENGINE_KERNEL = {"fused_t": "fused_mttkrp_t", "fused_tg": "fused_mttkrp_tg",
                  "fused": "fused_mttkrp", "fused_v2": "fused_mttkrp_v2",
                  "fused_dense": "fused_dense"}


@dataclasses.dataclass
class ChaosResult:
    """One chaos run's verdict and its evidence."""

    verdict: str                  # "converged" | "degraded" | "violated"
    fit: Optional[float]
    finite: bool
    fired: Dict[str, int]         # site -> how often its fault fired
    events: List[dict]            # the full run report
    violations: List[str]         # invariant breaches (empty = pass)
    error: Optional[str] = None   # the escaped exception, if any
    schedule: str = ""            # the resolved schedule that ran
    device: str = "cpu"
    #: the comm drill: whether it raised, the error and its class
    drill: Optional[dict] = None
    #: kernel launches of the run on the card, by wrapper
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return dict(verdict=self.verdict, fit=self.fit,
                    finite=self.finite, fired=self.fired,
                    violations=self.violations, error=self.error,
                    schedule=self.schedule, device=self.device,
                    drill=self.drill, launches=self.launches,
                    events=[{k: v for k, v in e.items() if k != "ts"}
                            for e in self.events])


def _kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count."""
    from splatt_tpu_torch.ops import kernels, linalg
    from splatt_tpu_torch.parallel import ring_kernels

    return {k.__name__: int(k.launches) for k in
            kernels.KERNELS + ring_kernels.RING_KERNELS + (linalg.sym_eig,)}


def _reset_kernel_launches() -> None:
    from splatt_tpu_torch.ops import kernels, linalg
    from splatt_tpu_torch.parallel import ring_kernels

    kernels.reset_launches()
    ring_kernels.reset_launches()
    linalg.sym_eig.launches = 0


def run_chaos(schedule: Optional[str] = None, seed: int = 0,
              dims=(40, 32, 24), nnz: int = 3000, rank: int = 4,
              iters: int = 8, deadline_s: float = 0.5,
              tune_first: bool = True, smoke: bool = False,
              verbose: bool = False,
              trace_path: Optional[str] = None,
              device: str = "cuda") -> ChaosResult:
    """Run one seeded CPD soak under a chaos schedule on `device` and check
    the guarded-execution invariant (≙ splatt_tpu/chaos.py:121-302).

    Owns process-global resilience state (faults, demotions, the run
    report, the deadline override): it resets that state on entry and
    disarms on exit.  With `trace_path` span recording is on for the run,
    the recorder is exported there, and the invariant gains two legs: the
    export succeeded, and every fired fault's evidence is also a point
    event on the trace.

    On a CPU tensor the schedule (default :data:`DEFAULT_SCHEDULE`) and
    the invariant are the JAX package's: the comm drill's fault degrades
    down the CPU mesh's comm chain and the drill converges.  On the card
    the default is :data:`CARD_SCHEDULE`, the drill runs on a mesh of 4
    virtual ranks sharing the card, and the invariant adds: every armed
    site fired; a fired ``engine.*`` fault demoted its engine and the CPD
    went on to launch another kernel engine; and the drill raised the
    injected failure, recorded as its evidence, since a drill that
    completed would be a hidden fallback."""
    import tempfile

    import torch

    from splatt_tpu_torch import resilience, trace, tune
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import (CommPattern, Options, Verbosity,
                                         resolve_device)
    from splatt_tpu_torch.cpd import cpd_als
    from splatt_tpu_torch.parallel.mesh import make_mesh
    from splatt_tpu_torch.parallel.sharded import sharded_cpd_als
    from splatt_tpu_torch.utils import faults
    from splatt_tpu_torch.utils.env import read_env

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if schedule is None:
        schedule = str(read_env("SPLATT_CHAOS_SCHEDULE") or "") \
            or (CARD_SCHEDULE if on_card else DEFAULT_SCHEDULE)
    if smoke:
        dims, nnz, rank, iters = (20, 16, 12), 1200, 3, 6
    specs = faults.parse_schedule(schedule)

    faults.reset()
    resilience.reset_demotions()
    resilience.run_report().clear()
    if trace_path:
        trace.reset()
        trace.set_enabled(True)
    # 0 = explicit disable (beats an exported SPLATT_DEADLINE_S)
    resilience.set_deadline(deadline_s if deadline_s > 0 else 0.0)
    # on the card the engine legs wait for the CPD (CARD_SCHEDULE)
    late = {site: spec for site, spec in specs.items()
            if on_card and site.startswith("engine.")}
    for site, spec in specs.items():
        if site not in late:
            faults.arm(site, spec)

    tt = synthetic_tensor(dims, nnz, seed)
    opts = Options(random_seed=seed, max_iterations=iters,
                   verbosity=Verbosity.LOW if verbose else Verbosity.NONE,
                   autotune=False)     # plans measured live, not cached
    error = None
    fit = None
    finite = False
    out = None
    drill = None
    launches: Dict[str, int] = {}
    try:
        with tempfile.TemporaryDirectory(prefix="splatt-chaos-") as td:
            # a throwaway plan cache: plans measured under injected faults
            # never leak into the real cache
            tune.set_cache_path(f"{td}/tune_cache.json")
            if tune_first and "tuner.measure" in specs:
                # the tuner leg: measurements run under the deadline
                # watchdog and must degrade, not crash
                tune.tune(tt, rank=rank, opts=opts, blocks=(512,),
                          scan_targets=(1 << 21,), reps=1, device=dev)
            for site, spec in late.items():
                faults.arm(site, spec)
            if on_card:
                torch.cuda.synchronize(dev)
                _reset_kernel_launches()
            bs = BlockedSparse.from_coo(tt, opts, device=dev)
            out = cpd_als(bs, rank=rank, opts=opts, device=dev)
            if on_card:
                torch.cuda.synchronize(dev)
                launches = _kernel_launches()
            if "comm.ring_exchange" in specs:
                # the distributed comm drill: a small FINE async-ring CPD
                # under the armed ring-exchange fault
                dopts = Options(random_seed=seed, max_iterations=3,
                                verbosity=opts.verbosity, autotune=False,
                                comm_pattern=CommPattern.ASYNC_RING)
                if on_card:
                    try:
                        sharded_cpd_als(tt, rank=rank,
                                        mesh=make_mesh(4, device=dev),
                                        opts=dopts, measure_overlap=False)
                        drill = {"raised": False}
                    except Exception as e:  # the drill's evidence
                        if resilience.sticky_cuda_error(e):
                            raise
                        drill = {"raised": True,
                                 "failure_class":
                                     resilience.classify_failure(e).value,
                                 "error": resilience.failure_message(e)[
                                     :200]}
                    torch.cuda.synchronize(dev)
                    launches.update(
                        {k: v for k, v in _kernel_launches().items()
                         if k.startswith("ring_")})
                else:
                    dout = sharded_cpd_als(tt, rank=rank, opts=dopts,
                                           measure_overlap=False,
                                           device=dev)
                    if not all(bool(torch.isfinite(U).all())
                               for U in dout.factors):
                        raise RuntimeError(
                            "comm drill produced non-finite factors")
                    drill = {"raised": False}
        fit = float(out.fit)
        finite = bool(all(bool(torch.isfinite(U).all())
                          for U in out.factors)
                      and bool(torch.isfinite(out.lam).all()))
    except Exception as e:  # the invariant is "nothing escapes"
        error = (f"{resilience.classify_failure(e).value}: "
                 f"{resilience.failure_message(e)[:300]}")
    finally:
        fired = faults.fired()
        faults.reset()
        resilience.set_deadline(None)
        tune.set_cache_path(None)
        trace_ev = None
        trace_points: List[dict] = []
        if trace_path:
            trace_points = trace.points()
            trace_ev = trace.write_chrome_trace(trace_path)
            trace.set_enabled(None)

    report = resilience.run_report()
    events = report.events()
    degraded = bool(report.events("health_degraded"))

    violations: List[str] = []
    if error is not None:
        violations.append(f"unhandled exception escaped the guarded "
                          f"drivers: {error}")
    if trace_path:
        if not (trace_ev and trace_ev.get("ok")):
            violations.append(
                f"trace export to {trace_path} failed: "
                f"{(trace_ev or {}).get('failure_class')}: "
                f"{(trace_ev or {}).get('error')}")
        else:
            try:
                exported = trace.load_trace(trace_path)
                if not any(e.get("ph") == "X" for e in exported):
                    violations.append(
                        f"exported trace {trace_path} holds no spans — "
                        f"the soak ran with recording on")
            except (OSError, ValueError) as e:
                violations.append(
                    f"exported trace {trace_path} is not loadable "
                    f"Chrome trace-event JSON: {e}")
        point_kinds = {p["name"] for p in trace_points}
        for site, spec in specs.items():
            if fired.get(site, 0) == 0:
                continue
            want = _EVIDENCE.get(spec.kind, ())
            if want and not point_kinds & set(want):
                violations.append(
                    f"fault {site}:{spec.kind} fired but none of its "
                    f"evidence events {list(want)} reached the trace as "
                    f"point events — the event-on-span wiring is broken")
    for site, spec in specs.items():
        if fired.get(site, 0) == 0:
            continue
        want = _EVIDENCE.get(spec.kind, ())
        if site == "comm.ring_exchange" and on_card:
            # on the card the drill's raise is its evidence (below)
            continue
        if want and not any(report.events(kind) for kind in want):
            violations.append(
                f"fault {site}:{spec.kind} fired {fired[site]}x but left "
                f"none of the expected run-report events {list(want)} — "
                f"silent degradation")
    if on_card:
        violations += _card_violations(specs, fired, report, launches,
                                       drill, error)
    undeclared = sorted({e["kind"] for e in events}
                        - set(resilience.RUN_REPORT_EVENTS))
    if undeclared:
        violations.append(f"run report contains undeclared event kinds "
                          f"{undeclared}")
    if error is None and not finite and not degraded:
        violations.append("final factors are non-finite and the run did "
                          "not report a health_degraded verdict")

    verdict = ("violated" if violations
               else "degraded" if degraded else "converged")
    return ChaosResult(verdict=verdict, fit=fit, finite=finite,
                       fired=dict(fired), events=events,
                       violations=violations, error=error,
                       schedule=schedule, device=str(dev), drill=drill,
                       launches=launches)


def _card_violations(specs, fired: Dict[str, int], report,
                     launches: Dict[str, int], drill: Optional[dict],
                     error: Optional[str]) -> List[str]:
    """The legs the card adds to the invariant (see :func:`run_chaos`)."""
    from splatt_tpu_torch.utils import faults

    out: List[str] = []
    if error is not None:
        return out  # the escape is already the violation
    for site in specs:
        if fired.get(site, 0) == 0:
            out.append(f"armed site {site} never fired on the card — its "
                       f"leg of the invariant is vacuous")
    for site, spec in specs.items():
        if not site.startswith("engine.") or not fired.get(site) \
                or spec.kind not in faults.RAISING_KINDS:
            continue
        engine = site[len("engine."):]
        if not any(e.get("engine") == engine
                   for e in report.events("engine_demotion")):
            out.append(f"fault {site} fired but {engine} was not demoted")
        others = sum(n for name, n in launches.items()
                     if name in _ENGINE_KERNEL.values()
                     and name != _ENGINE_KERNEL.get(engine))
        if not others:
            out.append(f"{engine} was demoted but no other kernel engine "
                       f"launched: the CPD did not go on to a kernel "
                       f"engine (launches {launches})")
    if "comm.ring_exchange" in specs:
        if drill is None:
            out.append("the comm drill did not run")
        elif not drill.get("raised"):
            out.append("the comm drill completed under its armed "
                       "ring-exchange fault: a CUDA mesh's ASYNC_RING has "
                       "no fallback, so a completed drill is a hidden "
                       "fallback")
        elif "injected" not in str(drill.get("error")):
            out.append(f"the comm drill raised something other than the "
                       f"injected fault: {drill.get('error')}")
    return out


def _crash_windows_exercised(root: str) -> List[str]:
    """Classify the spool's post-kill state into the durable-op crash
    windows the kill evidently landed in.

    The window ids are the JAX package's (its crash-point checker's
    vocabulary); a soak's SIGKILL samples a handful per run, which the
    ``crash_windows_exercised`` event records.  The classification is
    conservative: only states that are unambiguous evidence of a window
    count.
    """
    from splatt_tpu_torch import serve

    windows = set()
    jpath = os.path.join(root, "journal.jsonl")
    try:
        with open(jpath, "rb") as f:
            data = f.read()
    except OSError:
        data = b""
    if data:
        windows.add("journal.append")
        if not data.endswith(b"\n"):
            windows.add("journal.append.torn")
    # publish-window debris: a crash between the tmp write and the
    # atomic rename leaves the pid-stamped tmp beside the destination
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            if ".tmp" not in name:
                continue
            if "gen.json.bak" in name:
                windows.add("stamp.bak.publish")
            elif "gen.json" in name:
                windows.add("stamp.publish")
            elif ".npz" in name:
                windows.add("ckpt.publish")
            elif os.path.basename(dirpath) == "results":
                windows.add("result.publish")
            elif os.path.basename(dirpath) == "leases":
                windows.add("lease.publish")
    try:
        recs, torn = serve.Journal(jpath).replay()
    except Exception:
        # best-effort evidence: an unreadable journal yields no windows,
        # and the soak's own audit reports the breakage
        recs, torn = [], 0
    if torn:
        windows.add("journal.append.torn")
    by_job: Dict[str, List[str]] = {}
    for r in recs:
        if r.get("job"):
            by_job.setdefault(r["job"], []).append(r.get("rec"))
    for jid, kinds in by_job.items():
        terminal = any(k in serve.TERMINAL for k in kinds)
        res = serve.read_result(root, jid)
        if res is not None and not terminal:
            # the terminal-commit protocol is result publish THEN the
            # terminal append: a result with no terminal record means
            # the crash landed before the final journal append
            windows.add("journal.append[done]")
        elif terminal and res is None:
            windows.add("result.publish")
    return sorted(windows)


# -- the fleet soak ----------------------------------------------------------

@dataclasses.dataclass
class FleetChaosResult:
    """One fleet kill-and-failover soak's verdict and evidence."""

    verdict: str                  # "survived" | "violated"
    jobs: Dict[str, str]          # job id -> terminal status
    replicas: List[str]           # replica ids (incl. the restart)
    victim: Optional[str]         # the SIGKILLed replica
    adopted: List[str]            # jobs that changed hands
    affinity: Dict[str, dict]     # adopted tune jobs' warm-cache stats
    violations: List[str]         # invariant breaches (empty = pass)
    error: Optional[str] = None
    #: fleet-aggregate evidence that the kill is visible end to end:
    #: merged adoption, lease-expiry and slo-burn counters, the liveness
    #: census, and the victim's flight-ring event count
    observability: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: which durable-operation crash windows the victim's SIGKILL landed
    #: in (:func:`_crash_windows_exercised`)
    crash_windows: List[str] = dataclasses.field(default_factory=list)
    #: the soak's spool, kept when an invariant was violated (else None:
    #: removed)
    spool: Optional[str] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _fleet_lineage_violations(recs: List[dict]) -> List[str]:
    """Audit the shared journal's per-job ownership lineage: a job may
    only start on a second replica after an ``adopted`` takeover (or a
    clean ``interrupted`` handback), and reaches at most one terminal
    record — the journal-level face of 'no job runs on two replicas
    at once'."""
    from splatt_tpu_torch import serve

    out: List[str] = []
    by_job: Dict[str, List[dict]] = {}
    for r in recs:
        if r.get("job") and r.get("rec"):
            by_job.setdefault(r["job"], []).append(r)
    for jid, rl in sorted(by_job.items()):
        owner = None
        terminals = 0
        for r in rl:
            k, rid = r["rec"], r.get("replica")
            if k == serve.STARTED:
                if owner is not None and rid != owner:
                    out.append(
                        f"job {jid} started on {rid} while owned by "
                        f"{owner} with no adoption/interruption "
                        f"between — double execution")
                owner = rid
            elif k == serve.ADOPTED:
                owner = rid
            elif k == serve.INTERRUPTED:
                owner = None
            elif k in (serve.DONE, serve.FAILED):
                terminals += 1
        if terminals > 1:
            out.append(f"job {jid} reached {terminals} terminal "
                       f"records — committed more than once")
    return out


def _predict_staleness_violations(recs: List[dict]) -> List[str]:
    """Audit the generation fence from the journal alone: every served
    prediction's generation must be >=
    the newest generation COMMITTED before that predict was accepted.
    Commit ``done`` records carry ``model``/``model_gen``; predict
    ``accepted`` records carry ``gen_pinned`` (the marker) and their
    spec; predict ``done`` records carry the served ``gen``.  The
    journal is totally ordered (one flocked file), so walking it in
    order reconstructs what any reader could have known."""
    from splatt_tpu_torch import serve

    out: List[str] = []
    committed: Dict[str, int] = {}
    floor: Dict[str, int] = {}
    for r in recs:
        k, jid = r.get("rec"), r.get("job")
        if k == serve.ACCEPTED and "gen_pinned" in r:
            model = str((r.get("spec") or {}).get("model") or "")
            floor[jid] = committed.get(model, 0)
        elif k == serve.DONE:
            if r.get("model_gen") is not None:
                m = str(r.get("model"))
                committed[m] = max(committed.get(m, 0),
                                   int(r["model_gen"]))
            if r.get("status") == "served" and jid in floor:
                gen = int(r.get("gen") or 0)
                if gen < floor[jid]:
                    out.append(
                        f"predict {jid} served generation {gen} but "
                        f"generation {floor[jid]} was committed before "
                        f"it was accepted — a STALE read")
    return out


def run_fleet_chaos(seed: int = 0, smoke: bool = True,
                    replicas: Optional[int] = None,
                    verbose: bool = False,
                    device: str = "cuda") -> FleetChaosResult:
    """Kill-and-failover soak of a serve fleet (≙ splatt_tpu/chaos.py:
    732-1297), its replicas ``serve --fleet --device <device>``
    subprocesses.

    Starts N replica daemons over one shared
    spool (short leases, shared warm caches, per-replica metrics and
    traces), warms one shape regime, then files multi-tenant load
    including a same-regime job pinned open by a slow fault.  SIGKILLs
    the replica that claimed the pinned job mid-run, restarts a
    replacement, and checks:

    1. every accepted job reaches a terminal state (zero jobs lost to
       the kill);
    2. the pinned job changed hands: an ``adopted`` journal record
       from the victim, its terminal record on a survivor, and the
       single-owner lineage audit clean for EVERY job (no job ever
       ran on two replicas at once);
    3. the adopted same-regime job hit the warm shared caches
       (``tune.cache_hits > 0`` with zero measurements) — affinity
       evidence surviving failover;
    4. per-tenant isolation: the NaN tenant rolled back/degraded with
       zero demotions, every clean tenant finished converged with no
       health events and no demotions;
    5. the fleet's observability accounts for the failover: the
       adopter's Prometheus snapshot counts the adoption and its span
       trace carries the ``job_adopted`` point event;
    6. the kill is visible END-TO-END in the fleet observability
       plane: the merged fleet aggregate
       shows the lease expiry + adoption + an ``slo_burn`` spike (the
       replicas run with tight ``SPLATT_SLO_*`` knobs, so the
       adoption's queue-wait outage burns the error budget) that
       RECOVERS once the fleet is quiet; the victim's flight-recorder
       ring replays its timeline up to the kill — the pinned job's
       ``job_started`` liveness mark included; and ``splatt status``
       agrees with the journal about every job's state;
    7. the generation-fenced predict plane under
       the same kill: a predict filed in the mid-kill burst is never
       lost, predicts interleaved with the update commit violate no
       staleness (every served generation >= the newest generation
       committed before acceptance, audited from the journal alone),
       >= 1 predict is served once the base model commits, and a
       predict against a shredded model (checkpoint + .bak + both
       generation stamps) REFUSES instead of serving garbage.

    Every wait is bounded, and every replica is stopped (SIGTERM, then
    SIGKILL) before the audit.  The spool is removed after a clean run and
    kept (``spool``) after a violated one.
    """
    import shutil
    import signal as _signal
    import subprocess
    import sys
    import tempfile
    import time

    from splatt_tpu_torch import resilience, serve, trace

    nrep = int(replicas) if replicas else (2 if smoke else 3)
    dims, nnz, rank, iters = (20, 16, 12), 1200, 3, 6
    if not smoke:
        dims, nnz, rank, iters = (40, 32, 24), 3000, 4, 10
    syn = {"dims": list(dims), "nnz": nnz, "seed": seed}
    violations: List[str] = []
    jobs: Dict[str, str] = {}
    adopted: List[str] = []
    affinity: Dict[str, dict] = {}
    crash_windows: List[str] = []
    rids = [f"r{i}" for i in range(nrep)]
    victim = None
    error = None
    procs: Dict[str, object] = {}
    logs = []
    tmp = tempfile.mkdtemp(prefix="splatt-fleet-chaos-")
    jpath = os.path.join(tmp, "journal.jsonl")
    # the replicas import this package from where it lies
    base_env = _child_env()
    # a shared warm plan cache (the point of the fleet), but a throwaway
    # one; short leases so the failover fits a smoke budget.  The
    # observability plane runs at soak scale too: sub-second metrics,
    # aggregation and SLO ticks, tight SLO knobs (any queue wait past 1 s,
    # such as the adoption's outage, burns the whole error budget at
    # once, so the kill must show as an slo_burn), and a flush per record
    # of the flight ring, so the victim's black box is current up to the
    # SIGKILL
    base_env.update(
        SPLATT_TUNE_CACHE=os.path.join(tmp, "tune_cache.json"),
        SPLATT_FLEET_LEASE_S="2.0", SPLATT_FLEET_HEARTBEAT_S="0.5",
        SPLATT_SERVE_POLL_S="0.25",
        SPLATT_METRICS_INTERVAL_S="0.7",
        SPLATT_SLO_QUEUE_WAIT_P95_S="1.0",
        SPLATT_SLO_WINDOW_S="3.0", SPLATT_SLO_LONG_WINDOWS="4",
        SPLATT_SLO_BURN="1.5", SPLATT_FLIGHT_FLUSH="1",
        # the batched and update tenants: two queued same-regime jobs
        # coalesce into one batched CPD, and the update tenant drives the
        # model store through the failover
        SPLATT_SERVE_BATCH_MIN="2", SPLATT_UPDATE_SWEEPS="2")
    # SPLATT_METRICS_PATH stays UNSET: fleet mode defaults each
    # replica's snapshot into <root>/fleet/metrics/<rid>.prom, which
    # is where the aggregator (and this soak's post-mortem) finds
    # them — retired/killed replicas' files included

    def spawn(rid: str):
        env = dict(base_env)
        log = open(os.path.join(tmp, f"{rid}.log"), "w")
        logs.append(log)
        cmd = [sys.executable, "-m", "splatt_tpu_torch.cli", "serve", tmp,
               "--fleet", "--replica", rid, "--workers", "1",
               "--device", device,
               "--trace", os.path.join(tmp, f"trace-{rid}.json")]
        if verbose:
            cmd.append("-v")
        procs[rid] = subprocess.Popen(cmd, env=env, stdout=log,
                                      stderr=subprocess.STDOUT)

    def states() -> Dict[str, tuple]:
        recs, _ = serve.Journal(jpath).replay()
        out: Dict[str, tuple] = {}
        for r in recs:
            if r.get("job") and r.get("rec"):
                out[r["job"]] = (r["rec"], r.get("replica"))
        return out

    def wait_for(pred, deadline_s: float, what: str) -> bool:
        end = time.time() + deadline_s
        while time.time() < end:
            if pred():
                return True
            if all(p.poll() is not None for p in procs.values()):
                violations.append(
                    f"every replica exited while waiting for {what}")
                return False
            time.sleep(0.15)
        violations.append(f"timed out waiting for {what}")
        return False

    try:
        for rid in rids:
            spawn(rid)
        # phase 1 — warm one shape regime fleet-wide: the shared plan
        # cache is what makes the later adoption's Nth request free
        warm = {"id": "fleet-0-warm", "tenant": "acme", "rank": rank,
                "iters": iters, "tune": True, "synthetic": syn}
        serve.file_request(tmp, warm)
        if not wait_for(lambda: states().get("fleet-0-warm",
                                             (None,))[0]
                        in serve.TERMINAL, 300, "the warm job"):
            raise RuntimeError("fleet soak setup failed")
        # phase 2 — multi-tenant load, including the pinned
        # same-regime job the kill will orphan mid-run
        pin = {"id": "fleet-1-pin", "tenant": "acme", "rank": rank,
               "iters": iters, "tune": True,
               "synthetic": dict(syn, seed=seed + 1),
               "faults": "serve.job_run:slow:delay=5"}
        nan = {"id": "fleet-2-nan", "tenant": "beta", "rank": rank,
               "iters": iters, "health_retries": 2,
               "synthetic": dict(syn, seed=seed + 2),
               "faults": "cpd.sweep:nan:iter=2"}
        clean = {"id": "fleet-3-clean", "tenant": "coyote",
                 "rank": rank, "iters": iters,
                 "synthetic": dict(syn, seed=seed + 3)}
        # the update tenant's base model: a plain cpd job whose
        # checkpoint becomes the model store the later update advances
        # (iters offset by one: a distinct coalescing key, so the base
        # never rides a batch — batched runs do not checkpoint, and
        # the update wants the warm model)
        base_job = {"id": "fleet-4-base", "tenant": "epsilon",
                    "rank": rank, "iters": iters + 1,
                    "checkpoint_every": 2,
                    "synthetic": dict(syn, seed=seed + 4)}
        for spec in (pin, nan, clean, base_job):
            serve.file_request(tmp, spec)
        if not wait_for(
                lambda: states().get("fleet-1-pin",
                                     (None,))[0] == serve.STARTED,
                120, "the pinned job to start"):
            raise RuntimeError("fleet soak setup failed")
        victim = states()["fleet-1-pin"][1]
        if victim not in procs:
            raise RuntimeError(f"journal names unknown replica "
                               f"{victim!r} for the pinned job")
        time.sleep(0.5)  # well inside the 5 s slow-fault window
        procs[victim].kill()  # SIGKILL: no drain, no lease release
        procs[victim].wait(timeout=60)
        # post-mortem before the survivors heal the spool: which crash
        # windows did this kill actually land in?
        crash_windows = _crash_windows_exercised(tmp)
        resilience.run_report().add(
            "crash_windows_exercised", soak="fleet",
            windows=",".join(crash_windows))
        # the batched tenants: filed in one burst
        # while the victim is dead, so one survivor ingests the set
        # together and its >= SPLATT_SERVE_BATCH_MIN same-key queue
        # coalesces into one batched CPD (ingestion races across
        # replicas can still split the set — the post-mortem records
        # achieved coverage, the lineage audit holds either way)
        bsyn = {"dims": [16, 12, 10], "nnz": 800}
        batch_jobs = [f"fleet-b{i}" for i in range(3)]
        for i, bid in enumerate(batch_jobs):
            serve.file_request(tmp, {
                "id": bid, "tenant": "delta", "rank": 3, "iters": 4,
                "synthetic": dict(bsyn, seed=seed + 10 + i),
                "seed": seed + 10 + i})
        # ...plus a predict riding the SAME mid-kill burst: accepted
        # while the victim is dead, it must reach a terminal answer
        # (served if the base model commits first, REFUSED if it runs
        # before the commit — either is honest; losing it is not)
        serve.file_request(tmp, {
            "id": "fleet-p0", "kind": "predict", "tenant": "epsilon",
            "model": "fleet-4-base", "coords": [[0, 0, 0], [1, 1, 1]]})
        # kill-and-RESTART: a replacement joins under a fresh id (a
        # new incarnation — the dead id's leases must EXPIRE, not be
        # silently re-owned)
        restart = f"{victim}b"
        rids.append(restart)
        spawn(restart)
        # the update tenant needs its base model DONE first: the
        # journal/checkpoint store must hold the model to advance
        all_jobs = ["fleet-0-warm", "fleet-1-pin", "fleet-2-nan",
                    "fleet-3-clean", "fleet-4-base", "fleet-p0",
                    *batch_jobs]
        if wait_for(lambda: states().get("fleet-4-base",
                                         (None,))[0]
                    in serve.TERMINAL, 300, "the update base job"):
            # the predict stream around the update commit: p1 is
            # pinned at the base generation, the update advances it,
            # p2 files after the update — the journal staleness audit
            # must hold across the whole interleaving
            serve.file_request(tmp, {
                "id": "fleet-p1", "kind": "predict",
                "tenant": "epsilon", "model": "fleet-4-base",
                "coords": [[0, 0, 0], [1, 2, 3]]})
            serve.file_request(tmp, {
                "id": "fleet-5-up", "kind": "update",
                "base": "fleet-4-base", "tenant": "epsilon",
                "delta": {"dims": list(dims), "nnz": max(nnz // 20, 8),
                          "seed": seed + 99}})
            serve.file_request(tmp, {
                "id": "fleet-p2", "kind": "predict",
                "tenant": "epsilon", "model": "fleet-4-base",
                "top_k": {"fixed": {"1": 0, "2": 0}, "mode": 0,
                          "k": 3}})
            # only a FILED update is waited on: a base-job timeout is
            # its own (already recorded) violation, not a reason to
            # burn the final wait polling a job that never existed
            all_jobs += ["fleet-p1", "fleet-5-up", "fleet-p2"]
        wait_for(lambda: all(states().get(j, (None,))[0]
                             in serve.TERMINAL for j in all_jobs),
                 300 if smoke else 900, "all jobs to finish")
        # phase 5 — corrupt-model refusal drill:
        # shred the base model's checkpoint AND its .bak, drop both
        # generation stamps, then predict against it — the fenced read
        # finds no intact (checkpoint, stamp) pair and must REFUSE
        # classified, never serve garbage
        ckdir = os.path.join(tmp, "ckpt")
        for name in ("fleet-4-base.npz", "fleet-4-base.npz.bak"):
            fp = os.path.join(ckdir, name)
            if os.path.exists(fp):
                with open(fp, "wb") as f:
                    f.write(b"shredded by the chaos drill")
        for name in ("fleet-4-base.gen.json",
                     "fleet-4-base.gen.json.bak"):
            try:
                os.remove(os.path.join(ckdir, name))
            except FileNotFoundError:
                pass
        serve.file_request(tmp, {
            "id": "fleet-p3", "kind": "predict", "tenant": "epsilon",
            "model": "fleet-4-base", "coords": [[0, 0, 0]]})
        all_jobs.append("fleet-p3")
        wait_for(lambda: states().get("fleet-p3", (None,))[0]
                 in serve.TERMINAL, 180, "the corrupt-model predict")
    except Exception as e:  # the harness itself must not crash the CLI
        error = (f"{resilience.classify_failure(e).value}: "
                 f"{resilience.failure_message(e)[:300]}")
        violations.append(f"fleet-chaos harness error: {error}")
    finally:
        for rid, p in procs.items():
            if p.poll() is None:
                p.send_signal(_signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=60)
        for log in logs:
            log.close()

    recs, _torn = serve.Journal(jpath).replay()
    accepted = sorted({r["job"] for r in recs
                       if r.get("rec") == serve.ACCEPTED})
    adopted = sorted({r["job"] for r in recs
                      if r.get("rec") == serve.ADOPTED})
    # 1. zero accepted jobs lost
    for jid in accepted:
        last = states().get(jid, (None, None))
        res = serve.read_result(tmp, jid)
        if last[0] not in serve.TERMINAL:
            violations.append(f"accepted job {jid} never reached a "
                              f"terminal state — a job was LOST")
            jobs[jid] = "lost"
            continue
        if res is None:
            violations.append(f"job {jid} is terminal but published "
                              f"no result record")
            jobs[jid] = "no-result"
            continue
        jobs[jid] = res["status"]
    # 2. the failover actually happened, and lineage is single-owner
    if victim is not None:
        pin_last = states().get("fleet-1-pin", (None, None))
        if pin_last[1] == victim:
            violations.append(
                f"the pinned job's terminal record is on the killed "
                f"replica {victim} — the kill exercised no failover")
        if not any(r.get("rec") == serve.ADOPTED
                   and r.get("job") == "fleet-1-pin"
                   and r.get("from_replica") == victim for r in recs):
            violations.append(
                "no adopted record shows the pinned job taken over "
                "from the killed replica — adoption lineage missing")
    violations.extend(_fleet_lineage_violations(recs))
    violations.extend(_predict_staleness_violations(recs))
    # 3./4. per-job evidence: warm-cache affinity + tenant isolation
    for jid, status in sorted(jobs.items()):
        res = serve.read_result(tmp, jid)
        if res is None:
            continue
        kinds = {e["kind"] for e in res.get("events", [])}
        if jid.startswith("fleet-p"):
            # predicts answer "served" or an honest classified
            # "refused" — anything else (or a served answer with no
            # generation stamp) breaks the fence contract
            if status not in ("served", "refused"):
                violations.append(
                    f"predict {jid} finished {status!r} — a predict "
                    f"either serves or refuses, never fails open")
            elif status == "served" and not res.get("gen"):
                violations.append(
                    f"predict {jid} served with no generation stamp "
                    f"— the answer is unauditable")
            continue
        if jid == "fleet-2-nan":
            if status == "converged" \
                    and not kinds & {"health_rollback",
                                     "health_degraded"}:
                violations.append(
                    "the NaN job converged with no health evidence — "
                    "the injected fault was silently lost")
            if res.get("demotions"):
                violations.append(
                    "the NaN job demoted engines — NUMERICAL failures "
                    "must roll back, never demote")
        else:
            if kinds & {"health_nonfinite", "health_rollback",
                        "health_degraded"}:
                violations.append(
                    f"clean job {jid} carries health events — the NaN "
                    f"tenant leaked into a neighbor")
            if res.get("demotions"):
                violations.append(
                    f"clean job {jid} carries engine demotions — "
                    f"cross-tenant poisoning")
            if status != "converged":
                violations.append(
                    f"clean job {jid} finished {status!r} instead of "
                    f"converging")
        if jid == "fleet-1-pin":
            tune_info = res.get("tune") or {}
            affinity[jid] = dict(
                cache_hits=tune_info.get("cache_hits"),
                measured=tune_info.get("measured"),
                adopted_from=res.get("adopted_from"),
                replica=res.get("replica"))
            if not tune_info or not tune_info.get("cache_hits"):
                violations.append(
                    "the adopted same-regime job reports no warm "
                    "plan-cache hits — the Nth-request-is-free "
                    "property did not survive the failover")
            elif tune_info.get("measured"):
                violations.append(
                    f"the adopted job re-measured "
                    f"{tune_info['measured']} plans despite the warm "
                    f"shared cache")
    # 5. the adopter's metrics + trace account for the failover
    pin_replica = states().get("fleet-1-pin", (None, None))[1]
    if pin_replica and pin_replica != victim:
        mpath = os.path.join(tmp, "fleet", "metrics",
                             f"{pin_replica}.prom")
        try:
            with open(mpath) as f:
                mtext = f.read()
            if "splatt_fleet_adoptions_total" not in mtext:
                violations.append(
                    f"the adopter {pin_replica}'s Prometheus snapshot "
                    f"carries no splatt_fleet_adoptions_total sample "
                    f"— the failover is unaccounted")
        except OSError as e:
            violations.append(f"no metrics snapshot from the adopter "
                              f"{pin_replica}: {e}")
        tpath = os.path.join(tmp, f"trace-{pin_replica}.json")
        try:
            summ = trace.summarize(trace.load_trace(tpath))
            fl = summ.get("fleet") or {}
            if not fl.get("adoptions"):
                violations.append(
                    f"the adopter {pin_replica}'s span trace carries "
                    f"no job_adopted point event — the failover left "
                    f"no trace evidence")
        except (OSError, ValueError) as e:
            violations.append(f"no loadable span trace from the "
                              f"adopter {pin_replica}: {e}")
    # 6. the fleet observability plane shows the kill end-to-end:
    # merged aggregate + SLO burn/recovery +
    # the victim's flight-recorder black box + status↔journal agreement
    from splatt_tpu_torch import fleetobs

    agg = fleetobs.aggregate(tmp)
    observability: Dict[str, float] = {
        "adoptions": agg.counter("splatt_fleet_adoptions_total"),
        "lease_expired": agg.counter(
            "splatt_fleet_lease_expired_total"),
        "slo_burns": agg.counter("splatt_slo_burn_total"),
        "replicas_dead": float(agg.samples.get(
            ("splatt_fleet_replicas", (("state", "dead"),)), 0.0)),
    }
    if victim is not None:
        if observability["adoptions"] < 1:
            violations.append(
                "the merged fleet aggregate counts no "
                "splatt_fleet_adoptions_total — the failover is "
                "invisible fleet-wide")
        if observability["lease_expired"] < 1:
            violations.append(
                "the merged fleet aggregate counts no "
                "splatt_fleet_lease_expired_total — the lease expiry "
                "is invisible fleet-wide")
        if observability["replicas_dead"] < 1:
            violations.append(
                "the liveness census counts no dead replica — the "
                "SIGKILLed victim's expired heartbeat went uncounted")
        if observability["slo_burns"] < 1:
            violations.append(
                "no slo_burn was counted anywhere in the fleet — the "
                "adoption outage burned no error budget, so a real "
                "incident would page nobody")
        else:
            # ...and the burn RECOVERS: a fresh two-point evaluation
            # over the now-quiet fleet (identical samples = zero new
            # errors in the window) must not be burning
            ev = fleetobs.SloEvaluator(window_s=3.0, long_windows=4,
                                       burn=1.5)
            t0 = time.time()
            ev.evaluate(agg.samples, now=t0)
            res2 = ev.evaluate(agg.samples, now=t0 + 60.0)
            still = [n for n, s in res2["slos"].items()
                     if s["burning"]]
            if still:
                violations.append(
                    f"SLOs {still} still burning over a quiet window "
                    f"— the burn evaluator cannot recover")
        # the victim's black box: its flight ring must replay the
        # timeline up to the kill, the pinned job's liveness mark
        # included (SPLATT_FLIGHT_FLUSH=1 makes every record durable
        # before the 0.5s kill window)
        fpath = os.path.join(tmp, "fleet", "flight",
                             f"{victim}.jsonl")
        try:
            fevs = trace.load_flight(fpath)
            observability["flight_events"] = float(len(fevs))
            if not any((e.get("args") or {}).get("job")
                       == "fleet-1-pin" and e.get("name")
                       == "job_started" for e in fevs):
                violations.append(
                    "the victim's flight ring carries no job_started "
                    "mark for the pinned job — the black box does "
                    "not show what the victim was running when killed")
        except (OSError, ValueError) as e:
            violations.append(
                f"the victim {victim}'s flight ring is unreadable — "
                f"the SIGKILL erased the black box: {e}")
    # 7. the batched and update tenants: the lineage
    # audit above already proves no batch member double-ran or double-
    # committed; here the batch/update evidence itself is checked.
    # (Spool-claim races can split the batched set across replicas, so
    # achieved coalescing coverage is recorded — and required of the
    # full-size soak, where the burst lands on the lone survivor.)
    batched_jobs = 0
    for jid in accepted:
        res = serve.read_result(tmp, jid)
        if res and res.get("batched"):
            batched_jobs += 1
            if res["batched"].get("k", 0) < 2:
                violations.append(
                    f"job {jid} claims a coalesced batch of "
                    f"k={res['batched'].get('k')} — a batch is >= 2")
    observability["batched_jobs"] = float(batched_jobs)
    if not smoke and batched_jobs < 2:
        violations.append(
            "no coalesced batch formed in the full soak — the batched "
            "tenant mix exercised nothing")
    if "fleet-5-up" in accepted:
        up = serve.read_result(tmp, "fleet-5-up")
        if up is not None:
            kinds = {e["kind"] for e in up.get("events", [])}
            if not kinds & {"update_applied", "refit_scheduled"}:
                violations.append(
                    "the update job left no update_applied/"
                    "refit_scheduled evidence — the model-store "
                    "lineage is unauditable")
            if not os.path.exists(os.path.join(
                    tmp, "ckpt", "fleet-4-base.npz")):
                violations.append(
                    "the update base model checkpoint is missing from "
                    "the store after the update committed")
    # 8. the generation-fenced predict plane: the
    # staleness audit above already walked the journal; here the
    # predict stream's coverage and refusal honesty are checked
    served = refused = 0
    for jid in accepted:
        if not jid.startswith("fleet-p"):
            continue
        res = serve.read_result(tmp, jid)
        if res and res.get("status") == "served":
            served += 1
        elif res and res.get("status") == "refused":
            refused += 1
    observability["predicts_served"] = float(served)
    observability["predicts_refused"] = float(refused)
    observability["predict_latency_obs"] = float(sum(
        int(v.get("count", 0)) for (n, _lk), v in agg.samples.items()
        if n == "splatt_predict_latency_seconds"
        and isinstance(v, dict)))
    if "fleet-p1" in accepted and served < 1:
        violations.append(
            "no predict was served across the kill despite a "
            "committed base model — the prediction plane never "
            "answered")
    if "fleet-p3" in accepted:
        p3 = serve.read_result(tmp, "fleet-p3")
        if p3 is None or p3.get("status") != "refused":
            violations.append(
                f"the corrupt-model predict finished "
                f"{(p3 or {}).get('status')!r} instead of refusing — "
                f"a torn model must REFUSE, never serve garbage")
    st = fleetobs.fleet_status(tmp)
    jstates = states()
    for jid in accepted:
        if st["jobs"].get(jid) != jstates.get(jid, (None,))[0]:
            violations.append(
                f"splatt status disagrees with the journal about "
                f"{jid}: {st['jobs'].get(jid)!r} vs "
                f"{jstates.get(jid, (None,))[0]!r}")
    verdict = "violated" if violations else "survived"
    if violations:
        spool = tmp
    else:
        spool = None
        shutil.rmtree(tmp, ignore_errors=True)
    return FleetChaosResult(verdict=verdict, jobs=jobs, replicas=rids,
                            victim=victim, adopted=adopted,
                            affinity=affinity, violations=violations,
                            error=error, observability=observability,
                            crash_windows=crash_windows, spool=spool)


def format_fleet_report(res: FleetChaosResult) -> List[str]:
    """Human-readable fleet-soak verdict lines for the CLI."""
    lines = [f"fleet chaos: replicas {', '.join(res.replicas)}; "
             f"SIGKILLed {res.victim or '(nobody)'}; adopted: "
             f"{', '.join(res.adopted) or '(none)'}"]
    for jid, status in sorted(res.jobs.items()):
        lines.append(f"  job {jid}: {status}")
    for jid, ev in sorted(res.affinity.items()):
        lines.append(f"  affinity {jid}: cache_hits={ev['cache_hits']} "
                     f"measured={ev['measured']} "
                     f"adopted_from={ev['adopted_from']} "
                     f"ran_on={ev['replica']}")
    if res.observability:
        ob = res.observability
        lines.append(
            f"  observability: adoptions={ob.get('adoptions', 0):g} "
            f"lease_expired={ob.get('lease_expired', 0):g} "
            f"slo_burns={ob.get('slo_burns', 0):g} "
            f"dead_replicas={ob.get('replicas_dead', 0):g} "
            f"victim_flight_events={ob.get('flight_events', 0):g}")
        lines.append(
            f"  predict plane: served={ob.get('predicts_served', 0):g} "
            f"refused={ob.get('predicts_refused', 0):g} "
            f"latency_obs={ob.get('predict_latency_obs', 0):g}")
    for v in res.violations:
        lines.append(f"INVARIANT VIOLATED: {v}")
    if res.spool:
        lines.append(f"  spool kept for the post-mortem: {res.spool}")
    lines.append(f"fleet chaos verdict: {res.verdict.upper()}")
    return lines


def format_report(res: ChaosResult) -> List[str]:
    """Human-readable chaos verdict lines for the CLI."""
    from splatt_tpu_torch import resilience

    lines = [f"chaos schedule: {res.schedule} (on {res.device})",
             "faults fired: " + (", ".join(
                 f"{s}x{n}" for s, n in sorted(res.fired.items()) if n)
                 or "(none)")]
    lines += ["run report:"] + (resilience.run_report().summary()
                                or ["  (no resilience events)"])
    if res.drill is not None and res.drill.get("raised"):
        lines.append(f"comm drill raised ({res.drill.get('failure_class')}: "
                     f"{str(res.drill.get('error'))[:120]})")
    if res.launches:
        lines.append("kernel launches: " + ", ".join(
            f"{k}={n}" for k, n in sorted(res.launches.items()) if n))
    if res.fit is not None:
        lines.append(f"final fit: {res.fit:0.5f} "
                     f"({'finite' if res.finite else 'NON-FINITE'})")
    for v in res.violations:
        lines.append(f"INVARIANT VIOLATED: {v}")
    lines.append(f"chaos verdict: {res.verdict.upper()}")
    return lines


def _child_env() -> Dict[str, str]:
    """The environment of a soak's subprocess: this one's, with this
    package's root first on PYTHONPATH, so the child imports the code
    that spawned it."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _stop(proc, timeout: float = 10.0) -> None:
    """Stop a child: SIGKILL unless it already exited, then reap it."""
    import subprocess

    if proc is None:
        return
    if proc.poll() is None:
        proc.kill()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass


# -- the serve daemon's kill-and-restart soak --------------------------------


@dataclasses.dataclass
class ServeChaosResult:
    """One serve kill-and-restart soak's verdict and evidence."""

    verdict: str                  # "survived" | "violated"
    jobs: Dict[str, str]          # job id -> terminal status
    killed_mid_queue: bool        # the SIGKILL landed before drain
    resumed: List[str]            # jobs the restart re-enqueued
    violations: List[str]         # invariant breaches (empty = pass)
    error: Optional[str] = None
    #: which durable-operation crash windows the SIGKILL landed in
    #: (:func:`_crash_windows_exercised`)
    crash_windows: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def run_serve_chaos(seed: int = 0, smoke: bool = True,
                    verbose: bool = False,
                    device: str = "cuda") -> ServeChaosResult:
    """Kill-and-restart soak of the serve daemon
    (≙ splatt_tpu/chaos.py:457-630), ``serve --device <device>``
    subprocesses.

    Files three jobs, one NaN-poisoned (sentinel + rollback) and pinned
    open by a slow fault so the SIGKILL lands mid-job, and two clean
    neighbours; starts the daemon, SIGKILLs it, restarts it with
    ``--once`` and checks:

    1. every accepted job reached a terminal state (none lost);
    2. the journal replays cleanly and shows a resume lineage;
    3. the NaN job's result carries the health evidence and demoted
       nothing;
    4. the clean jobs' results carry no health events and no demotions,
       and converged: the poisoned tenant stayed contained.

    Every wait is bounded and each daemon is stopped in a ``finally``."""
    import shutil
    import subprocess
    import sys
    import tempfile
    import time

    from splatt_tpu_torch import resilience, serve

    dims, nnz, rank, iters = (20, 16, 12), 1200, 3, 6
    if not smoke:
        dims, nnz, rank, iters = (40, 32, 24), 3000, 4, 10
    syn = {"dims": list(dims), "nnz": nnz, "seed": seed}
    violations: List[str] = []
    jobs: Dict[str, str] = {}
    resumed: List[str] = []
    crash_windows: List[str] = []
    killed_mid_queue = False
    error = None
    tmp = tempfile.mkdtemp(prefix="splatt-serve-chaos-")
    env = _child_env()
    # a throwaway plan cache: plans the soak's jobs measure never leak
    # into the real one
    env["SPLATT_TUNE_CACHE"] = os.path.join(tmp, "tune_cache.json")
    proc = None
    try:
        # the NaN job's id sorts first in the spool's filename order, so
        # with one worker it is the job the slow fault pins open
        nan_id = "chaos-0-nan"
        nan_job = {"id": nan_id, "rank": rank, "iters": iters,
                   "synthetic": syn, "health_retries": 2,
                   "faults": "serve.job_run:slow:delay=4,"
                             "cpd.sweep:nan:iter=2"}
        clean = [{"id": f"chaos-clean{i}", "rank": rank, "iters": iters,
                  "synthetic": dict(syn, seed=seed + 1 + i)}
                 for i in range(2)]
        for spec in [nan_job] + clean:
            serve.file_request(tmp, spec)
        cmd = [sys.executable, "-m", "splatt_tpu_torch.cli", "serve", tmp,
               "--once", "--workers", "1", "--device", device]
        jpath = os.path.join(tmp, "journal.jsonl")
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        deadline = time.time() + 180
        started = False
        while time.time() < deadline and proc.poll() is None:
            started = any(
                r.get("rec") == "started" and r.get("job") == nan_id
                for r in serve.Journal(jpath).replay()[0])
            if started:
                break
            time.sleep(0.1)
        if started and proc.poll() is None:
            time.sleep(0.5)  # well inside the 4 s slow-fault window
            proc.kill()      # SIGKILL: no drain, no cleanup
            killed_mid_queue = True
        else:
            violations.append(
                "daemon finished (or died) before the kill — the soak did "
                "not exercise a mid-queue restart")
        proc.wait(timeout=60)

        # the post-mortem, before the restart heals anything
        crash_windows = _crash_windows_exercised(tmp)
        resilience.run_report().add(
            "crash_windows_exercised", soak="serve",
            windows=",".join(crash_windows))

        restart = subprocess.run(cmd + ["--json"], env=env,
                                 capture_output=True, text=True,
                                 timeout=600)
        if restart.returncode != 0:
            violations.append(
                f"restarted daemon exited nonzero ({restart.returncode}): "
                f"{restart.stderr[-300:]}")

        recs, _torn = serve.Journal(jpath).replay()
        accepted = {r["job"] for r in recs if r.get("rec") == "accepted"}
        resumed = sorted({r["job"] for r in recs
                          if r.get("rec") == "resumed"})
        if killed_mid_queue and not resumed:
            violations.append("kill landed mid-queue but the restart "
                              "resumed nothing — journal replay broken")
        for jid in sorted(accepted):
            res = serve.read_result(tmp, jid)
            states = [r.get("rec") for r in recs if r.get("job") == jid]
            if not any(s in serve.TERMINAL for s in states):
                violations.append(f"accepted job {jid} never reached a "
                                  f"terminal state — a job was LOST")
                jobs[jid] = "lost"
                continue
            if res is None:
                violations.append(f"job {jid} is terminal but published "
                                  f"no result record")
                jobs[jid] = "no-result"
                continue
            jobs[jid] = res["status"]
            kinds = {e["kind"] for e in res.get("events", [])}
            if jid == nan_id:
                if res["status"] == "converged" \
                        and not kinds & {"health_rollback",
                                         "health_degraded"}:
                    violations.append(
                        "the NaN job converged with no health evidence — "
                        "the injected fault was silently lost")
                if res.get("demotions"):
                    violations.append(
                        "the NaN job demoted engines — numerical failures "
                        "must roll back, never demote")
            else:
                if kinds & {"health_nonfinite", "health_rollback",
                            "health_degraded"}:
                    violations.append(
                        f"clean job {jid} carries health events — the NaN "
                        f"tenant leaked into a neighbour")
                if res.get("demotions"):
                    violations.append(
                        f"clean job {jid} carries engine demotions "
                        f"{res['demotions']} — cross-job poisoning")
                if res["status"] != "converged":
                    violations.append(
                        f"clean job {jid} finished {res['status']!r} "
                        f"instead of converging")
    except Exception as e:  # the harness itself must not crash the CLI
        error = (f"{resilience.classify_failure(e).value}: "
                 f"{resilience.failure_message(e)[:300]}")
        violations.append(f"serve-chaos harness error: {error}")
    finally:
        _stop(proc)
        if not violations:
            shutil.rmtree(tmp, ignore_errors=True)
    verdict = "violated" if violations else "survived"
    return ServeChaosResult(verdict=verdict, jobs=jobs,
                            killed_mid_queue=killed_mid_queue,
                            resumed=resumed, violations=violations,
                            error=error, crash_windows=crash_windows)


def format_serve_report(res: ServeChaosResult) -> List[str]:
    """Human-readable serve-soak verdict lines for the CLI."""
    lines = [f"serve chaos: SIGKILL mid-queue "
             f"{'landed' if res.killed_mid_queue else 'MISSED'}; "
             f"resumed after restart: "
             f"{', '.join(res.resumed) or '(none)'}"]
    for jid, status in sorted(res.jobs.items()):
        lines.append(f"  job {jid}: {status}")
    for v in res.violations:
        lines.append(f"INVARIANT VIOLATED: {v}")
    lines.append(f"serve chaos verdict: {res.verdict.upper()}")
    return lines


# -- the ingest kill-and-resume soak -----------------------------------------


@dataclasses.dataclass
class IngestChaosResult:
    """One ingest kill-and-resume soak's verdict and evidence."""

    verdict: str                  # "survived" | "violated"
    killed_mid_stream: bool       # the SIGKILL landed before finalize
    watermark_at_kill: int        # journal watermark at the post-mortem
    chunks: int                   # chunks committed end to end
    nnz: int                      # nonzeros in the finalized tensor
    quarantined: int              # records quarantined end to end
    resumed: bool                 # the restart reported a journal resume
    violations: List[str]         # invariant breaches (empty = pass)
    error: Optional[str] = None
    #: which durable-operation crash windows the SIGKILL landed in
    #: (:func:`_ingest_crash_windows`)
    crash_windows: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _ingest_crash_windows(dest: str) -> List[str]:
    """Classify the ingest directory's post-kill state into the
    durable-operation crash windows the kill evidently landed in (the JAX
    package's window ids for the chunk-commit protocol).  Conservative:
    only unambiguous debris counts."""
    import json

    windows = set()
    jpath = os.path.join(dest, "journal.jsonl")
    try:
        with open(jpath, "rb") as f:
            data = f.read()
    except OSError:
        data = b""
    if data:
        if not data.endswith(b"\n"):
            windows.add("journal.append.torn")
        for ln in data.split(b"\n"):
            if not ln.strip():
                continue
            try:
                kind = json.loads(ln).get("rec")
            except ValueError:
                continue
            if kind:
                windows.add(f"journal.append[{kind}]")
    for dirpath, _dirs, names in os.walk(dest):
        base = os.path.basename(dirpath)
        for name in names:
            if ".tmp" not in name and ".build" not in name:
                continue
            if base == "seg":
                windows.add("ingest.seg.publish")
            elif base == "vocab":
                windows.add("ingest.vocab.publish")
            elif "tensor.bin" in name:
                windows.add("ingest.bin.publish")
    return sorted(windows)


def run_ingest_chaos(seed: int = 0, smoke: bool = True,
                     verbose: bool = False) -> IngestChaosResult:
    """Kill-and-resume soak of streaming ingest
    (≙ splatt_tpu/chaos.py:1419-1607); host code, so it takes no device.

    Generates a seeded record stream (string keys in mode 0, so the vocab
    store is in the blast radius, and a malformed record every 23rd line,
    so the quarantine sidecar is too), then:

    1. runs an ``ingest`` subprocess with a slow fault at
       ``ingest.commit``, so each chunk commit dawdles and the kill
       window is deterministic;
    2. SIGKILLs it once the journal shows >= 2 committed chunks;
    3. audits the surviving journal alone (:func:`ingest.audit_journal`);
    4. restarts the same command unfaulted and checks that it resumes from
       the watermark and converges;
    5. checks exactly-once accounting against the generator: records =
       lines written, nnz = good records, quarantined = malformed
       records, and ``tensor.bin`` loads with that nnz.

    Every wait is bounded and the child is stopped in a ``finally``."""
    import json
    import shutil
    import subprocess
    import sys
    import tempfile
    import time

    from splatt_tpu_torch import ingest, resilience
    from splatt_tpu_torch import io as _io

    chunk_records = 120 if smoke else 1000
    nchunks_target = 12 if smoke else 40
    violations: List[str] = []
    crash_windows: List[str] = []
    killed = False
    watermark_at_kill = -1
    resumed = False
    chunks = nnz = quarantined = 0
    error = None
    tmp = tempfile.mkdtemp(prefix="splatt-ingest-chaos-")
    src = os.path.join(tmp, "stream.tns")
    dest = os.path.join(tmp, "ingest")

    # seeded ground truth: every 23rd line malformed (bad arity), the rest
    # "u<k> <i> <j> <val>"
    rng = np.random.default_rng(seed)
    total = chunk_records * nchunks_target
    good = bad = 0
    with open(src, "w") as f:
        f.write("# ingest soak stream\n")
        for n in range(total):
            if n and n % 23 == 0:
                f.write("malformed\n")
                bad += 1
            else:
                f.write(f"u{rng.integers(0, 500)} "
                        f"{rng.integers(0, 64)} {rng.integers(0, 48)} "
                        f"{rng.random() + 0.1:.6f}\n")
                good += 1

    cmd = [sys.executable, "-m", "splatt_tpu_torch.cli", "ingest", src,
           dest, "--format", "tns", "--chunk", str(chunk_records), "--json"]
    env = _child_env()
    env["SPLATT_FAULTS"] = "ingest.commit:slow:delay=0.25:*"
    proc = None
    try:
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        deadline = time.time() + 180
        while time.time() < deadline and proc.poll() is None:
            recs, _torn = ingest.replay_journal(dest)
            if sum(1 for r in recs
                   if r.get("rec") == ingest.REC_CHUNK) >= 2:
                break
            time.sleep(0.05)
        if proc.poll() is None:
            proc.kill()      # SIGKILL: no drain, no cleanup
            killed = True
        else:
            violations.append(
                "ingest finished (or died) before the kill — the soak did "
                "not exercise a mid-stream resume")
        proc.wait(timeout=60)

        # the post-mortem, before the restart heals anything
        crash_windows = _ingest_crash_windows(dest)
        resilience.run_report().add(
            "crash_windows_exercised", soak="ingest",
            windows=",".join(crash_windows))
        aud = ingest.audit_journal(dest)
        watermark_at_kill = aud["watermark"]
        if not aud["ok"]:
            violations.append(
                f"journal audit after the SIGKILL found "
                f"{len(aud['violations'])} exactly-once violation(s): "
                f"{'; '.join(aud['violations'][:3])}")

        # the resume leg: the same command, faults disarmed
        env.pop("SPLATT_FAULTS", None)
        restart = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=600)
        if restart.returncode != 0:
            violations.append(
                f"restarted ingest exited nonzero ({restart.returncode}): "
                f"{restart.stdout[-300:]}")
        summary = None
        for line in reversed(restart.stdout.splitlines()):
            if line.startswith("{"):
                try:
                    summary = json.loads(line)
                    break
                except json.JSONDecodeError:
                    continue
        if summary is None:
            violations.append("restarted ingest printed no JSON summary — "
                              "accounting unauditable")
        else:
            resumed = bool(summary.get("resumed"))
            chunks = int(summary.get("chunks") or 0)
            nnz = int(summary.get("nnz") or 0)
            quarantined = int(summary.get("quarantined") or 0)
            if summary.get("status") != "converged":
                violations.append(
                    f"restarted ingest finished {summary.get('status')!r} "
                    f"instead of converging")
            if killed and watermark_at_kill >= 0 and not resumed:
                violations.append(
                    "the kill landed mid-stream but the restart did not "
                    "resume from the journal watermark")
            for name, got, want in (
                    ("records", summary.get("records"), good + bad),
                    ("nnz", nnz, good),
                    ("quarantined", quarantined, bad)):
                if got != want:
                    violations.append(
                        f"end-to-end {name} accounted {got}, ground truth "
                        f"is {want} — records were LOST or DUPLICATED "
                        f"across the kill")

        aud2 = ingest.audit_journal(dest)
        if not aud2["ok"]:
            violations.append(
                f"final journal audit found violations: "
                f"{'; '.join(aud2['violations'][:3])}")
        elif not aud2["finalized"]:
            violations.append("the journal carries no finalize record "
                              "after a converged run")
        try:
            tt = _io.load_memmap(os.path.join(dest, "tensor.bin"))
            if tt.nnz != good:
                violations.append(f"finalized tensor holds {tt.nnz} nnz, "
                                  f"ground truth is {good}")
        except (OSError, ValueError) as e:
            violations.append(f"finalized tensor.bin unloadable: {e}")
    except Exception as e:  # the harness itself must not crash the CLI
        error = (f"{resilience.classify_failure(e).value}: "
                 f"{resilience.failure_message(e)[:300]}")
        violations.append(f"ingest-chaos harness error: {error}")
    finally:
        _stop(proc)
        if not violations:
            shutil.rmtree(tmp, ignore_errors=True)
    verdict = "violated" if violations else "survived"
    return IngestChaosResult(verdict=verdict, killed_mid_stream=killed,
                             watermark_at_kill=watermark_at_kill,
                             chunks=chunks, nnz=nnz,
                             quarantined=quarantined, resumed=resumed,
                             violations=violations, error=error,
                             crash_windows=crash_windows)


def format_ingest_report(res: IngestChaosResult) -> List[str]:
    """Human-readable ingest-soak verdict lines for the CLI."""
    lines = [f"ingest chaos: SIGKILL mid-stream "
             f"{'landed' if res.killed_mid_stream else 'MISSED'} at "
             f"watermark {res.watermark_at_kill}; resume "
             f"{'replayed the journal' if res.resumed else 'MISSING'}",
             f"  end-to-end: {res.chunks} chunk(s), {res.nnz} nnz, "
             f"{res.quarantined} quarantined",
             f"  crash windows exercised: "
             f"{', '.join(res.crash_windows) or '(none)'}"]
    for v in res.violations:
        lines.append(f"INVARIANT VIOLATED: {v}")
    lines.append(f"ingest chaos verdict: {res.verdict.upper()}")
    return lines
