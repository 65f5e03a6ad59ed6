"""The fleet's kill-and-failover soak and the serve daemon's seeded
workloads (≙ splatt_tpu/chaos.py:105-118, :390-455 and :618-1329).

:func:`synthetic_tensor` builds the tensor of a job spec's
``{"synthetic": {dims, nnz, seed}}`` workload and of an update's
``{"delta": ...}``.

:func:`run_fleet_chaos` (``chaos --fleet``) drives a real fleet of ``serve
--fleet`` replica subprocesses over one spool under multi-tenant load,
SIGKILLs the replica running a pinned job, restarts a replacement, and
audits the failover from the shared journal, the replicas' Prometheus
snapshots, Chrome traces and flight rings, and ``status``: no accepted job
lost, a single-owner lineage for every job, the pinned job adopted and
its warm plan-cache hits kept, tenants isolated, the kill visible in the
fleet aggregate (adoption, lease expiry, an SLO burn that recovers) and
in the victim's flight ring, the generation-fenced predicts never stale.
The replicas run on the card unless the soak is asked for the CPU.

The guarded-ALS, serve-daemon and ingest soaks are ROADMAP queue A item
15.3.
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
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base_env = dict(os.environ)
    base_env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + [p for p in base_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
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
