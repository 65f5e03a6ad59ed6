"""``serve``: a crash-resumable multi-tenant decomposition daemon, alone
or as one replica of a fleet, with streaming-ingest jobs that feed a
served model (≙ splatt_tpu/serve.py).

Many concurrent jobs share one card without one tenant's failures
poisoning its neighbours:

Durable job queue
    Every accepted job is journaled to an append-only JSONL file
    (:class:`Journal`) before the submitter hears "accepted": one fsynced
    line per state transition (``accepted`` → ``started`` →
    ``done``/``failed``, plus ``resumed``/``interrupted``/``rejected``).
    A crashed daemon replays the journal on start: every accepted but
    unfinished job is queued again (a ``job_resumed`` event) and resumes
    from its last checkpoint under ``<root>/ckpt/``.  A torn final line
    (a kill mid-append) is skipped, never fatal.

Per-job isolation
    Each job runs under :func:`splatt_tpu_torch.resilience.scope`: its
    engine demotions, health verdicts, retry budget, deadline, run-report
    events and eigensolver cap flag belong to the job and are invisible
    to its neighbours.  A spec may declare its own fault schedule
    (``"faults"``, the SPLATT_FAULTS grammar), armed inside that job only
    (:func:`splatt_tpu_torch.utils.faults.scoped`).  The plan cache is
    shared and warm.

Overload
    The pending queue is bounded (``SPLATT_SERVE_QUEUE_MAX``); a
    submission past it is load-shed with an explicit rejection
    (``queue_full``).  Tenants are capped at ``SPLATT_FLEET_TENANT_QUOTA``
    non-terminal jobs each (``quota_rejected``), and ``priority:
    high|normal|low`` orders the queue.  Per-job deadlines are
    ``SPLATT_SERVE_JOB_DEADLINE_S`` / spec ``deadline_s``, seen at the
    job's fit checks.  SIGTERM drains: running jobs checkpoint through
    the cpd ``stop`` hook and are journaled ``interrupted``; queued jobs
    stay journaled.

Job API
    Clients drop ``<id>.json`` specs into ``<root>/requests/``
    (:func:`file_request` writes them atomically); the daemon ingests,
    journals and deletes them.  Results appear as
    ``<root>/results/<id>.json`` with the schema of ``cpd --json`` (fit,
    events, demotions) and the job's status.  :func:`read_status` and
    :func:`read_result` are the client-side readers; the :class:`Server`
    methods are the same API in process.

The model store
    A finished ``cpd`` job commits its factors as ``ckpt/<id>.npz`` and
    advances the model's generation stamp (:mod:`splatt_tpu_torch.
    predict`).  An ``update`` job merges a delta COO into a committed
    model, re-solves the rows it touched and runs a few warm sweeps (a
    full refit is the repair path), then commits a new generation.  A
    ``predict`` job reads a committed generation through the hot-factor
    cache on a lane of its own and answers on the host.  When the queue
    holds ``SPLATT_SERVE_BATCH_MIN`` batchable jobs of one regime they
    run as one :func:`splatt_tpu_torch.cpd.cpd_als_batched`; any batch
    failure degrades classified to per-tensor dispatch.

The card
    A :class:`Server` runs its jobs on one device, the card unless the
    caller names ``"cpu"``; where there is no card it raises.  Its worker
    threads share the card's context and its default stream.  A sticky
    CUDA error (an illegal address, a launch failure) leaves the context
    unusable for every job: the job that meets it, and every job that
    meets it after, is journaled ``interrupted`` (never ``done``: no
    result is committed from a read the error could have followed), a
    ``cuda_context_lost`` event is recorded, and the daemon drains, so a
    fresh process resumes the jobs from their checkpoints.  Before any
    job's result is committed the daemon synchronizes the card, so a
    committed result was read before any such error.

Fleet mode
    ``Server(root, fleet=True)`` (``serve --fleet``) runs this daemon as
    one of N replicas over the same root: the journal becomes a
    flock-serialized shared log every replica tails, job ownership a
    lease (:mod:`splatt_tpu_torch.fleet`: claimed at dispatch, renewed by
    a heartbeat thread, adopted by a live peer once a dead replica's lease
    expires), the request spool multi-consumer (a claim is an atomic
    rename), and scheduling cache-affinity routing: a job prefers the
    replica whose plan cache and layouts are warm for its shape regime,
    load breaking ties.  A terminal record, a result and every checkpoint
    and model write are fenced by a lease renewal (a checkpoint's after
    it is written, just before its rename): an owner whose lease expired
    (a stopped process, a stalled host) abandons the job uncommitted.  The
    replicas may share one card; each is a process with its own context,
    and an adopter rebuilds the layouts and resumes from the checkpoint,
    never from what the victim held on the card.

Streaming ingest
    An ``ingest`` job streams a record file into ``<root>/ingest/<id>/``
    under ingest.py's exactly-once chunk journal and, when it names a
    ``base`` model, submits one ``update`` job per watermark interval
    against it (``_run_ingest``).  The updates run on the daemon's card
    like any other update.

A spec's ``use_pallas`` has no counterpart on a GPU: it is accepted and
has no effect.

A job spec is a JSON object::

    {"id": "j1", "rank": 8, "iters": 25, "seed": 0,
     "synthetic": {"dims": [40, 32, 24], "nnz": 3000, "seed": 0},
     # or "tensor": "/path/to/tensor.tns",
     "tol": 1e-5, "checkpoint_every": 5, "tune": false,
     "autotune": null, "health_retries": null, "deadline_s": null,
     "faults": "", "tenant": "default", "priority": "normal"}

    {"id": "up1", "kind": "update", "base": "j1",
     "delta": {"dims": [40, 32, 24], "nnz": 100, "seed": 42},
     # or "delta_tensor": "/path/to/delta.tns",
     "iters": 5}

    {"id": "p1", "kind": "predict", "model": "j1",
     "coords": [[0, 1, 2]], "top_k": {"mode": 0, "k": 5,
                                      "fixed": {"1": 3, "2": 4}}}

    {"id": "in1", "kind": "ingest", "source": "/path/to/stream.tns",
     "base": "j1", "dims": [40, 32, 24], "update_every": 2,
     "chunk_records": 5000, "format": "auto"}
"""

from __future__ import annotations

import json
import os
import re
import signal
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

# journal record kinds (the `rec` field of each JSONL line)
#: in-memory-only reservation state while the accept append fsyncs
#: (never journaled; a concurrent same-id submission dedups on it)
ACCEPTING = "accepting"
ACCEPTED = "accepted"
STARTED = "started"
RESUMED = "resumed"
ADOPTED = "adopted"    # fleet: a live replica took over a dead peer's job
INTERRUPTED = "interrupted"
DONE = "done"          # terminal: converged, degraded or served
FAILED = "failed"      # terminal: a classified error
REJECTED = "rejected"  # terminal: load-shed or invalid

#: records after which a job needs no further work
TERMINAL = (DONE, FAILED, REJECTED)

#: every record kind the journal may hold: a replayed record of another
#: kind (a newer writer's, or debris) is skipped with a classified
#: ``journal_unknown_kind`` event
KNOWN_KINDS = (ACCEPTED, STARTED, RESUMED, ADOPTED, INTERRUPTED,
               DONE, FAILED, REJECTED)

#: admission priority classes, class -> rank (lower runs first); within a
#: class the queue is FIFO
PRIORITIES = {"high": 0, "normal": 1, "low": 2}

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

#: how many scheduler passes a job warm on a peer replica may be left to
#: that peer before this replica takes it anyway: affinity routes work,
#: it never starves it
AFFINITY_DEFER_MAX = 3

#: cap on one coalesced batch: K slots stack K bucket-padded tensors on
#: the card, so a flooded queue coalesces in bounded bites
BATCH_MAX = 32

#: job kinds a spec may declare
JOB_KINDS = ("cpd", "update", "predict", "ingest")


def _job_id(spec: dict) -> str:
    """The job's id: the spec's, else a fresh one.  Ids name journal
    records, checkpoint files and result files, so they are restricted
    to a filesystem-safe alphabet."""
    jid = str(spec.get("id") or uuid.uuid4().hex[:12])
    if not _ID_RE.match(jid):
        raise ValueError(
            f"job id {jid!r} is not filesystem-safe (want "
            f"[A-Za-z0-9][A-Za-z0-9._-]*, max 64 chars)")
    return jid


class Journal:
    """Append-only JSONL job journal with durable, atomic appends
    (≙ splatt_tpu/serve.py:178-272).

    One write of a full line and an fsync per record, serialized across
    threads (a lock) and processes (the ``flock`` of
    :func:`splatt_tpu_torch.utils.durable.append_line`, which also heals
    a torn tail before appending): a fleet of replicas shares one
    journal.  :meth:`replay` skips every unparseable record, final or
    mid-file, with a classified ``journal_torn`` event: the record it
    carried is re-derived (an unjournaled terminal record means the job
    runs again, and its checkpoint makes that cheap)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()

    def append(self, rec: dict) -> None:
        """Durably append one record (raises on IO failure: callers decide
        whether durability is load-bearing for this record)."""
        from splatt_tpu_torch.utils import faults
        from splatt_tpu_torch.utils.durable import append_line

        faults.maybe_fail("serve.journal_write")
        line = json.dumps(dict(rec, ts=time.time()), sort_keys=True)
        with self._lock:
            append_line(self.path, line.encode())

    def replay(self):
        """Parse every record -> (records, torn_line_count); a torn or
        garbled line, final or mid-file, is skipped with a
        ``journal_torn`` event."""
        recs, torn, _ = self._parse(self._read(0),
                                    partial_tail_is_torn=True)
        return recs, torn

    def replay_new(self, offset: int):
        """The fleet's incremental tail read: parse the complete records
        from byte `offset` on -> (records, torn, new_offset).  A final line
        with no newline yet is a peer's append in progress, not debris: it
        is left unconsumed (the offset stays before it) and read whole on a
        later call."""
        recs, torn, consumed = self._parse(self._read(offset),
                                           partial_tail_is_torn=False)
        return recs, torn, offset + consumed

    def _read(self, offset: int) -> bytes:
        try:
            with open(self.path, "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read()
        except FileNotFoundError:
            return b""  # a fresh serve root: nothing journaled yet

    def _parse(self, data: bytes, partial_tail_is_torn: bool):
        recs: List[dict] = []
        torn = 0
        consumed = 0
        for raw in data.split(b"\n"):
            complete = consumed + len(raw) < len(data)  # has its newline
            if not complete and not partial_tail_is_torn:
                break  # an append in progress: not ours to judge yet
            consumed += len(raw) + (1 if complete else 0)
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw.decode(errors="replace"))
                if not isinstance(rec, dict):
                    raise ValueError("journal record is not an object")
            except ValueError as e:
                torn += 1
                self._report_torn(raw, e)
                continue
            recs.append(rec)
        return recs, torn, consumed

    def _report_torn(self, raw: bytes, exc: Exception) -> None:
        """One skipped record -> a classified ``journal_torn`` event."""
        from splatt_tpu_torch import resilience

        resilience.run_report().add(
            "journal_torn", path=self.path,
            failure_class=resilience.classify_failure(exc).value,
            error=resilience.failure_message(exc)[:120],
            preview=raw[:60].decode(errors="replace"))


class Server:
    """The serve daemon: a bounded, journal-backed job queue and a small
    pool of worker threads, each job under its own resilience scope
    (≙ splatt_tpu/serve.py:274-2469).

    `device` is where the jobs run: the card by default (raising where
    there is none), or ``"cpu"``.  ``fleet=True`` makes it one replica of
    a fleet over `root` (`replica`, `lease_s`, `heartbeat_s` and
    `affinity` default to the ``SPLATT_FLEET_*`` knobs)."""

    def __init__(self, root: str, workers: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 job_deadline_s: Optional[float] = None,
                 verbose: bool = False,
                 fleet: bool = False, replica: Optional[str] = None,
                 lease_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None,
                 tenant_quota: Optional[int] = None,
                 affinity: Optional[bool] = None,
                 batch_min: Optional[int] = None,
                 device=None):
        from splatt_tpu_torch.config import resolve_device
        from splatt_tpu_torch.fleetobs import SloEvaluator
        from splatt_tpu_torch.predict import HotFactorCache
        from splatt_tpu_torch.utils import lockcheck
        from splatt_tpu_torch.utils.env import (read_env, read_env_float,
                                                read_env_int)

        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        self.requests_dir = os.path.join(self.root, "requests")
        self.results_dir = os.path.join(self.root, "results")
        self.ckpt_dir = os.path.join(self.root, "ckpt")
        for d in (self.root, self.requests_dir, self.results_dir,
                  self.ckpt_dir):
            os.makedirs(d, exist_ok=True)
        self.journal = Journal(os.path.join(self.root, "journal.jsonl"))
        self.workers = int(workers if workers is not None
                           else read_env_int("SPLATT_SERVE_WORKERS"))
        self.queue_max = int(queue_max if queue_max is not None
                             else read_env_int("SPLATT_SERVE_QUEUE_MAX"))
        self.poll_s = float(poll_s if poll_s is not None
                            else read_env_float("SPLATT_SERVE_POLL_S"))
        self.job_deadline_s = float(
            job_deadline_s if job_deadline_s is not None
            else read_env_float("SPLATT_SERVE_JOB_DEADLINE_S"))
        # auto coalescing: >= batch_min batchable jobs of one regime key
        # dispatch as one batched CPD; 0 disables
        self.batch_min = int(batch_min if batch_min is not None
                             else read_env_int("SPLATT_SERVE_BATCH_MIN"))
        # with a path set, the registry is snapshotted in Prometheus text
        # every interval seconds and at daemon exit; interval <= 0
        # snapshots at exit only
        self.metrics_path = read_env("SPLATT_METRICS_PATH") or None
        self.metrics_interval_s = float(
            read_env_float("SPLATT_METRICS_INTERVAL_S"))
        self._metrics_last = 0.0
        self.verbose = verbose
        # admission control: a per-tenant cap on non-terminal jobs (0 =
        # unlimited), layered over queue_full
        self.tenant_quota = int(
            tenant_quota if tenant_quota is not None
            else read_env_int("SPLATT_FLEET_TENANT_QUOTA"))
        # under SPLATT_LOCKCHECK the shared structures below become
        # owner-asserting proxies of this lock
        self._lock = lockcheck.guard_lock(threading.Lock())
        #: id -> {"spec": dict|None, "state": str, "status": str|None,
        #:        "resumed": bool, "tenant": str, "priority": str,
        #:        "seq": int, "regime": str|None, "t_accepted": float|None,
        #:        "gen_pinned": int|None, and in fleet mode "owner" (the
        #:        last journaled replica), "adopt_from", "adopted_from",
        #:        "deferred": int}
        self._jobs: Dict[str, dict] = lockcheck.guard(
            {}, self._lock, "serve.Server._jobs")
        #: pending job ids; _next() picks by (priority, arrival seq)
        self._queue: List[str] = lockcheck.guard(
            [], self._lock, "serve.Server._queue")
        #: pending predict ids: the low-latency lane, FIFO, bounded
        #: separately, dispatched before any fit or update
        self._pqueue: List[str] = lockcheck.guard(
            [], self._lock, "serve.Server._pqueue")
        self.predict_queue_max = int(
            read_env_int("SPLATT_PREDICT_QUEUE_MAX"))
        # hot factors keyed by (model, generation): an update commit
        # invalidates by advancing the generation, never by deleting, so
        # a pinned in-flight predict finishes bit for bit
        self._hot_cache = HotFactorCache(
            int(read_env_int("SPLATT_PREDICT_CACHE_MAX")))
        self._seq = 0
        #: job ids claimed by this daemon's workers
        self._running: set = lockcheck.guard(
            set(), self._lock, "serve.Server._running")
        self._draining = threading.Event()
        #: the sticky CUDA error that ended this daemon's use of the card
        self.context_lost: Optional[str] = None
        #: job id -> {part: host seconds} of its load, build, sweeps and
        #: commit (cpd and update jobs)
        self.timings: Dict[str, dict] = {}
        # fleet membership: job ownership is a lease, routing prefers
        # warm caches, dead peers' jobs are adopted
        self.fleet = None
        self._journal_offset = 0
        self._hb_thread: Optional[threading.Thread] = None
        if fleet:
            from splatt_tpu_torch.fleet import FleetMember

            self.fleet = FleetMember(self.root, replica=replica,
                                     lease_s=lease_s,
                                     heartbeat_s=heartbeat_s)
            self.affinity = bool(affinity if affinity is not None
                                 else str(read_env(
                                     "SPLATT_FLEET_AFFINITY")).lower()
                                 not in ("0", "off", "false", "no"))
            # each replica snapshots into the shared spool by default,
            # where the fleet aggregator finds it through the heartbeat.
            # (The process-wide replica stamp on spans is the cli's to
            # set: a library construction never flips global trace
            # state.)
            if not self.metrics_path:
                mdir = os.path.join(self.root, "fleet", "metrics")
                os.makedirs(mdir, exist_ok=True)
                self.metrics_path = os.path.join(
                    mdir, f"{self.fleet.replica}.prom")
            self.fleet.metrics_path = self.metrics_path
        else:
            self.affinity = False
        # the SLO layer rides the metrics cadence: a fleet replica
        # evaluates over the merged fleet samples, a lone daemon over its
        # own registry
        self._slo = SloEvaluator(
            replica=self.fleet.replica if self.fleet else None)
        self._replay()
        if self.fleet is not None:
            self.fleet.beat()
            self._start_heartbeat()

    # -- crash recovery -----------------------------------------------------

    def _new_job_locked(self, spec: Optional[dict] = None,
                        state: Optional[str] = None) -> dict:
        """One fresh job-table entry (callers hold the server lock)."""
        j = {"spec": spec, "state": state, "status": None,
             "resumed": False, "tenant": "default", "priority": "normal",
             "seq": self._seq, "owner": None, "adopt_from": None,
             "adopted_from": None, "deferred": 0, "regime": None,
             "t_accepted": None, "gen_pinned": None}
        self._seq += 1
        if spec is not None:
            self._fill_admission(j, spec)
        return j

    @staticmethod
    def _fill_admission(j: dict, spec: dict) -> None:
        """The admission and routing fields of a job spec: the tenant
        (quota unit), the priority class and the shape-regime key (the
        affinity and coalescing key)."""
        from splatt_tpu_torch.fleet import job_regime

        j["tenant"] = str(spec.get("tenant") or "default")
        p = str(spec.get("priority") or "normal")
        j["priority"] = p if p in PRIORITIES else "normal"
        j["regime"] = job_regime(spec)

    def _apply_rec_locked(self, rec: dict) -> Optional[str]:
        """Fold one journal record into the job table (the last record per
        job wins: the flock-serialized journal is totally ordered across
        fleet replicas too; callers hold the server lock).  Returns the
        job id."""
        jid = rec.get("job")
        kind = rec.get("rec")
        if not jid or not kind:
            return None
        if kind not in KNOWN_KINDS:
            # an unknown kind folded in would wedge the job in a state no
            # transition leaves: skip it, classified
            from splatt_tpu_torch import resilience

            resilience.run_report().add(
                "journal_unknown_kind", path=self.journal.path,
                job=str(jid), record_kind=str(kind)[:60],
                failure_class="permanent",
                error="journal record kind unknown to this version; "
                      "skipped (newer writer?)")
            return None
        j = self._jobs.setdefault(jid, self._new_job_locked())
        if kind == ACCEPTED:
            if rec.get("spec") is not None:
                j["spec"] = rec.get("spec")
                self._fill_admission(j, j["spec"])
            j["state"] = ACCEPTED
            # the journaled accept time feeds the queue-wait histogram of
            # replayed jobs too
            j["t_accepted"] = rec.get("ts")
            if rec.get("gen_pinned") is not None:
                j["gen_pinned"] = int(rec["gen_pinned"])
        else:
            j["state"] = kind
            if kind in (DONE, FAILED):
                j["status"] = rec.get("status")
        if rec.get("replica"):
            j["owner"] = rec["replica"]
        return jid

    def _rec(self, kind: str, jid: str, **kw) -> dict:
        """One journal record, stamped with this replica's id in fleet
        mode (the lineage audit and the adoption scan key on it)."""
        rec = {"rec": kind, "job": jid, **kw}
        if self.fleet is not None:
            rec["replica"] = self.fleet.replica
        return rec

    def _replay(self) -> None:
        """Rebuild the queues from the journal: the last record per job
        wins, and every accepted but unfinished job is queued again
        (``job_resumed``) to resume from its checkpoint.  In fleet mode a
        job whose lease a live peer holds is only tracked: the peer owns
        it, and the fleet scan takes it over if that peer dies."""
        from splatt_tpu_torch import resilience

        if self.fleet is not None:
            recs, torn, self._journal_offset = self.journal.replay_new(0)
        else:
            recs, torn = self.journal.replay()
        if torn:
            self._log(f"journal: skipped {torn} torn line(s) "
                      f"(crash debris)")
        # the table and queues change under the lock; the journal's
        # fsyncs run after it is released, as at every other append
        resumed: List[tuple] = []
        with self._lock:
            for rec in recs:
                self._apply_rec_locked(rec)
            for jid, j in self._jobs.items():
                if j["state"] in TERMINAL or j["spec"] is None:
                    continue
                if self.fleet is not None:
                    me = self.fleet.replica
                    lease = self.fleet.lease_of(jid)
                    if lease is not None and not lease.expired() \
                            and lease.replica != me:
                        continue  # a live peer's; watched by _fleet_scan
                    if lease is not None and lease.expired() \
                            and lease.replica != me:
                        j["adopt_from"] = lease.replica
                    elif lease is None \
                            and j.get("owner") not in (None, me) \
                            and not self.fleet.replica_alive(j["owner"]):
                        # accepted by a dead peer and never claimed:
                        # taking it over is an adoption, audited as one
                        j["adopt_from"] = j["owner"]
                j["resumed"] = True
                self._enqueue_locked(jid)
                resumed.append((jid, j["state"]))
            depth = len(self._queue)
            pdepth = len(self._pqueue)
        for jid, was in resumed:
            resilience.run_report().add("job_resumed", job=jid,
                                        from_state=was)
            self._log(f"job {jid}: resumed from journal (was {was})")
            try:
                self.journal.append(self._rec(RESUMED, jid))
            except Exception as e:
                # lineage only: the ACCEPTED record already makes a later
                # replay find this job
                self._warn_journal("resume", jid, e)
        if depth:
            self._queue_metric(depth)
        if pdepth:
            self._pqueue_metric(pdepth)

    # -- submission / job API ----------------------------------------------

    def submit(self, spec: dict) -> dict:
        """Accept (journal durably, then queue) or reject one job.

        The submitter hears "accepted" only after the journal append
        succeeded: a submission the journal cannot record is rejected.
        An unknown ``kind`` or ``priority``, a spec missing its workload,
        or a bad fault schedule is invalid; a tenant at
        its quota is shed (``quota_rejected``), and a full queue
        load-sheds (``queue_full``).  Re-submitting a known id is
        idempotent, except after a rejection."""
        from splatt_tpu_torch import resilience
        from splatt_tpu_torch.utils import faults

        faults.maybe_fail("serve.submit")
        jid = _job_id(spec)
        spec = dict(spec, id=jid)
        # decide under the lock, do the durable IO outside it
        reason = None
        with self._lock:
            known = self._jobs.get(jid)
            if known is not None and known["state"] != REJECTED:
                return {"job": jid, "state": known["state"],
                        "duplicate": True}
            tenant = str(spec.get("tenant") or "default")
            prio = spec.get("priority")
            kind = str(spec.get("kind") or "cpd")
            if kind not in JOB_KINDS:
                reason = (f"invalid: unknown kind {kind!r} (want one "
                          f"of {sorted(JOB_KINDS)})")
            elif kind == "update" and not spec.get("base"):
                reason = "invalid: update job needs 'base': <job id>"
            elif kind == "update" and not (spec.get("delta")
                                           or spec.get("delta_tensor")):
                reason = ("invalid: update job needs 'delta': "
                          "{dims, nnz, seed} or 'delta_tensor': <path>")
            elif kind == "cpd" and not (spec.get("synthetic")
                                        or spec.get("tensor")):
                reason = ("invalid: no workload (give 'synthetic' or "
                          "'tensor')")
            elif kind == "predict" and not spec.get("model"):
                reason = ("invalid: predict job needs 'model': "
                          "<job id of a committed model>")
            elif kind == "predict" and spec.get("coords") is None \
                    and not isinstance(spec.get("top_k"), dict):
                reason = ("invalid: predict job needs 'coords': "
                          "[[i0, i1, ...], ...] and/or 'top_k': "
                          "{fixed, mode, k}")
            elif kind == "ingest" and not spec.get("source"):
                reason = ("invalid: ingest job needs 'source': "
                          "<record stream path>")
            elif kind == "ingest" and spec.get("base") \
                    and not spec.get("dims"):
                reason = ("invalid: ingest job chaining updates "
                          "against 'base' needs 'dims' (the base "
                          "model's mode sizes — deltas must not grow "
                          "past the checkpointed factors)")
            elif prio is not None and str(prio) not in PRIORITIES:
                reason = (f"invalid: unknown priority {prio!r} (want "
                          f"one of {sorted(PRIORITIES)})")
            elif spec.get("faults"):
                # a typo in the declared schedule rejects this submission
                # instead of failing the job at run time
                try:
                    faults.parse_schedule(str(spec["faults"]))
                except (ValueError, TypeError) as e:
                    reason = f"invalid: bad faults schedule ({e})"
            if reason is None and self.tenant_quota > 0:
                live = sum(1 for j in self._jobs.values()
                           if j.get("tenant") == tenant
                           and j["state"] not in TERMINAL)
                if live >= self.tenant_quota:
                    resilience.run_report().add(
                        "quota_rejected", job=jid, tenant=tenant,
                        quota=self.tenant_quota, live=live)
                    reason = f"quota:{tenant}"
            if reason is None and kind == "predict":
                # the predict lane's own bound
                if self.predict_queue_max > 0 \
                        and len(self._pqueue) >= self.predict_queue_max:
                    resilience.run_report().add(
                        "queue_full", job=jid, lane="predict",
                        queue_max=self.predict_queue_max)
                    reason = "queue_full"
            elif reason is None and self.queue_max > 0 \
                    and len(self._queue) >= self.queue_max:
                resilience.run_report().add("queue_full", job=jid,
                                            queue_max=self.queue_max)
                reason = "queue_full"
            if reason is None:
                # reserve the id, so that a concurrent same-id submission
                # dedups while the accept record is journaled
                self._jobs[jid] = self._new_job_locked(spec, ACCEPTING)
        if reason is not None:
            return self._reject(jid, spec, reason)
        # a predict pins the newest committed generation at admission,
        # stamped into the durable ACCEPTED record: "served gen >= the
        # newest generation committed before acceptance" is auditable
        # from the journal alone
        gen_pinned = None
        if kind == "predict":
            from splatt_tpu_torch.predict import current_generation

            gen_pinned = int(current_generation(
                self.ckpt_dir, str(spec.get("model"))))
        try:
            acc = self._rec(ACCEPTED, jid, spec=spec)
            if gen_pinned is not None:
                acc["gen_pinned"] = gen_pinned
            self.journal.append(acc)
        except Exception as e:
            cls = resilience.classify_failure(e)
            return self._reject(
                jid, spec, f"journal_error ({cls.value}: "
                f"{resilience.failure_message(e)[:120]})")
        resilience.run_report().add("job_accepted", job=jid)
        with self._lock:
            self._jobs[jid]["state"] = ACCEPTED
            self._jobs[jid]["t_accepted"] = time.time()
            self._jobs[jid]["gen_pinned"] = gen_pinned
            if jid not in self._queue and jid not in self._pqueue \
                    and jid not in self._running:
                self._enqueue_locked(jid)
            self._queue_metric(len(self._queue))
            self._pqueue_metric(len(self._pqueue))
        self._log(f"job {jid}: accepted")
        return {"job": jid, "state": ACCEPTED}

    def _reject(self, jid: str, spec: dict, reason: str) -> dict:
        """Record one rejection: the result file and a best-effort journal
        line, never a silent drop."""
        from splatt_tpu_torch import trace

        with self._lock:
            j = self._new_job_locked(spec, REJECTED)
            j["status"] = "rejected"
            self._jobs[jid] = j
        try:
            self.journal.append(self._rec(REJECTED, jid, reason=reason))
        except Exception as e:
            # a rejected job that was never journaled simply never
            # existed after a restart
            self._warn_journal("reject", jid, e)
        self._write_result(jid, {"job": jid, "status": "rejected",
                                 "reason": reason})
        trace.metric_inc("splatt_serve_jobs_total", status="rejected",
                         job=jid)
        self._log(f"job {jid}: rejected ({reason})")
        return {"job": jid, "state": REJECTED, "reason": reason}

    def status(self, jid: str) -> dict:
        """The job's current state (and terminal status, when known)."""
        with self._lock:
            j = self._jobs.get(jid)
            if j is None:
                return {"job": jid, "state": None}
            return {"job": jid, "state": j["state"],
                    "status": j["status"], "resumed": j["resumed"]}

    def result(self, jid: str) -> Optional[dict]:
        """The job's result record, or None while it is not terminal."""
        return read_result(self.root, jid)

    def summary(self) -> dict:
        """The daemon's machine-readable summary (the ``serve`` exit
        report): per-job states, state counts, queue depths."""
        with self._lock:
            jobs = {jid: j["state"] for jid, j in self._jobs.items()}
            pending = len(self._queue)
            pending_predict = len(self._pqueue)
        counts: Dict[str, int] = {}
        for s in jobs.values():
            counts[s] = counts.get(s, 0) + 1
        out = {"jobs": jobs, "counts": counts, "pending": pending,
               "pending_predict": pending_predict,
               "draining": self._draining.is_set()}
        if self.fleet is not None:
            out["replica"] = self.fleet.replica
            out["held_leases"] = self.fleet.held()
        return out

    # -- filed-request spool -------------------------------------------------

    def scan_requests(self) -> int:
        """Ingest filed requests: every ``*.json`` under ``requests/`` is
        parsed, submitted and unlinked, journal first, so a crash between
        the journal and the unlink re-ingests a known id, which
        :meth:`submit` dedups.  A malformed or failing request is
        quarantined as ``<name>.bad``.

        In fleet mode the spool has N consumers: a replica first claims a
        request (an atomic rename to ``<name>.<replica>.claim``; exactly
        one of N racing replicas wins), then reads it from the claim.  A
        replica that dies between the claim and the journal leaves the
        claim behind; :meth:`_reclaim_requests` returns a dead claimant's
        files to the spool, so such a request is delayed, never lost."""
        from splatt_tpu_torch import resilience

        n = 0
        if self.fleet is not None:
            self._reclaim_requests()
        for name in sorted(os.listdir(self.requests_dir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.requests_dir, name)
            read_path = path
            if self.fleet is not None:
                claim = f"{path}.{self.fleet.replica}.claim"
                try:
                    os.replace(path, claim)
                except OSError:
                    continue  # a peer claimed this request first
                read_path = claim
            try:
                with open(read_path) as f:
                    spec = json.load(f)
                if not isinstance(spec, dict):
                    raise ValueError("job spec must be a JSON object")
                spec.setdefault("id", name[:-5])
                self.submit(spec)
                n += 1
            except Exception as e:
                cls = resilience.classify_failure(e)
                self._log(f"request {name} failed to ingest "
                          f"({cls.value}: "
                          f"{resilience.failure_message(e)[:120]}); "
                          f"quarantined as {name}.bad", error=True)
                try:
                    os.replace(read_path, path + ".bad")
                except OSError:
                    pass
                continue
            try:
                os.unlink(read_path)
            except OSError:
                pass  # re-ingested next scan; submit dedups
        return n

    def _reclaim_requests(self) -> None:
        """Return the ``<name>.json.<replica>.claim`` files of a dead
        claimant (or of this replica's previous life) to the spool: the
        claim guards against a double ingest, never against the ingest."""
        try:
            names = os.listdir(self.requests_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".claim"):
                continue
            parts = name[:-len(".claim")].rsplit(".", 1)
            if len(parts) != 2 or not parts[0].endswith(".json"):
                continue
            base, rid = parts
            if rid != self.fleet.replica \
                    and self.fleet.replica_alive(rid):
                continue  # the claimant lives; it is mid-ingest
            try:
                os.replace(os.path.join(self.requests_dir, name),
                           os.path.join(self.requests_dir, base))
            except OSError:
                pass

    # -- supervisor ----------------------------------------------------------

    def _order_locked(self) -> List[str]:
        """The queue in dispatch order: priority class first, arrival
        within a class (callers hold the server lock)."""
        return sorted(
            self._queue,
            key=lambda jid: (PRIORITIES.get(
                self._jobs[jid].get("priority") or "normal", 1),
                self._jobs[jid].get("seq", 0)))

    def _next(self) -> Optional[str]:
        """Pick (and in fleet mode lease-claim) the next job.

        The predict lane goes first (FIFO), then the highest-priority,
        oldest job.  In fleet mode cache affinity is the signal and load
        the tiebreaker: a job whose regime is warm here is taken first; a
        job warm only on a live, not busier peer is left to that peer for
        up to AFFINITY_DEFER_MAX passes.  The pick becomes ours only once
        its lease is acquired: a claim a peer won (or a claim fault)
        drops the job here, and the fleet scan re-surfaces it."""
        # the peer snapshot reads heartbeat files: outside the lock
        peers = (self.fleet.peers()
                 if self.fleet is not None and self.affinity else {})
        while True:
            routed = None  # (reason, jid, regime, peer), emitted below
            with self._lock:
                pick = None
                if self._pqueue:
                    # the predict lane: FIFO, no affinity, no deferral;
                    # the lease claim below still applies
                    pick = self._pqueue.pop(0)
                    self._running.add(pick)
                    self._pqueue_metric(len(self._pqueue))
                order = self._order_locked() if pick is None else []
                if pick is None and self.affinity \
                        and self.fleet is not None:
                    # any job warm here beats queue position
                    for jid in order:
                        reg = self._jobs[jid].get("regime")
                        if reg and self.fleet.warm(reg):
                            pick = jid
                            routed = ("warm_local", jid, reg, None)
                            break
                for jid in order if pick is None else ():
                    j = self._jobs[jid]
                    reg = j.get("regime")
                    if not self.affinity or self.fleet is None:
                        pick = jid
                        break
                    peer = self.fleet.peer_warm(reg, peers)
                    if peer is not None:
                        if j["deferred"] < AFFINITY_DEFER_MAX \
                                and int(peers[peer].get("active", 0)) \
                                <= self.fleet.active_count() + 1:
                            j["deferred"] += 1
                            if j["deferred"] == 1:
                                routed = ("deferred", jid, reg, peer)
                            continue  # leave it for the warm peer
                        routed = ("load_tiebreak", jid, reg, peer)
                    pick = jid
                    break
                if pick is not None and pick in self._queue:
                    self._queue.remove(pick)
                    self._running.add(pick)
                    self._queue_metric(len(self._queue))
            if routed is not None:
                self._route_event(*routed)
            if pick is None or self.fleet is None:
                return pick
            if self._claim(pick):
                return pick
            # a peer won the lease, finished the job first, or the claim
            # faulted: not ours; the fleet scan re-surfaces it if it goes
            # unowned
            with self._lock:
                self._running.discard(pick)

    def _terminal_after_claim(self, jid: str) -> bool:
        """The post-claim journal re-check (fleet mode): tail the shared
        journal and say whether `jid` is terminal now.  Called while
        holding the job's lease, which makes the read authoritative: a
        peer's terminal append happens under its lease, before its
        release, and a zombie cannot add one later (its renew fails
        against our generation)."""
        with self._lock:
            recs, _torn, self._journal_offset = \
                self.journal.replay_new(self._journal_offset)
            for rec in recs:
                done = self._apply_rec_locked(rec)
                if done and self._jobs[done]["state"] in TERMINAL:
                    self._unqueue_locked(done)
            return self._jobs[jid]["state"] in TERMINAL

    # -- auto coalescing -----------------------------------------------------

    def _batchable(self, jid: str, j: dict) -> bool:
        """Whether one job may ride a coalesced batch: a plain synthetic
        ``cpd`` job with nothing a batch cannot honour per slot (no fault
        schedule, pre-tune, deadline, health budget, engine knob or
        explicit checkpoint cadence).  A resumed job qualifies only when
        it left no checkpoint."""
        spec = j.get("spec") or {}
        if j.get("resumed") and os.path.exists(
                os.path.join(self.ckpt_dir, f"{jid}.npz")):
            return False
        return (j.get("regime") is not None
                and str(spec.get("kind") or "cpd") == "cpd"
                and bool(spec.get("synthetic"))
                and not spec.get("tensor")
                and not spec.get("faults")
                and not spec.get("tune")
                and spec.get("deadline_s") is None
                and spec.get("health_retries") is None
                and spec.get("use_pallas") is None
                and spec.get("engine_fallback") is None
                and spec.get("autotune") is None
                and "checkpoint_every" not in spec)

    def _batch_key(self, j: dict) -> tuple:
        """The coalescing key: one regime (the stacking precondition:
        bucket shape and rank) and one iteration and tolerance budget."""
        spec = j["spec"]
        return (j["regime"], int(spec.get("iters", 25)),
                float(spec.get("tol", 1e-5)))

    def _next_batch(self) -> List[str]:
        """The next unit of work: ``[jid]``, or, when the queue holds >=
        ``batch_min`` batchable jobs sharing the picked job's key, up to
        BATCH_MAX of them as one batch.  In fleet mode every mate is
        lease-claimed like a single pick: a mate a peer wins stays out of
        the batch."""
        jid = self._next()
        if jid is None:
            return []
        mates: List[str] = []
        with self._lock:
            j = self._jobs[jid]
            if self.batch_min >= 1 and self._batchable(jid, j):
                key = self._batch_key(j)
                mates = [q for q in self._order_locked()
                         if self._batchable(q, self._jobs[q])
                         and self._batch_key(self._jobs[q]) == key]
                if 1 + len(mates) < self.batch_min:
                    mates = []
                mates = mates[:BATCH_MAX - 1]
                for q in mates:
                    self._queue.remove(q)
                    self._running.add(q)
                if mates:
                    self._queue_metric(len(self._queue))
        batch = [jid]
        for q in mates:
            if self.fleet is None or self._claim(q):
                batch.append(q)
                continue
            with self._lock:
                self._running.discard(q)
        return batch

    def _route_event(self, reason: str, jid: str, regime: str,
                     peer: Optional[str]) -> None:
        """One ``affinity_routed`` audit event."""
        from splatt_tpu_torch import resilience

        info = dict(job=jid, regime=regime, reason=reason,
                    replica=self.fleet.replica)
        if peer is not None:
            info["to_replica"] = peer
        resilience.run_report().add("affinity_routed", **info)

    def _claim(self, jid: str) -> bool:
        """Acquire the job's lease (fleet mode): the plain claim for an
        unclaimed job, the audited ``fleet.adopt`` takeover for an expired
        one; True when the job is ours to run.  A job a peer finished
        before the claim is released and dropped, before anything is
        journaled.  A takeover journals an ``adopted`` record and leaves
        ``job_adopted`` and ``lease_expired`` evidence; any failure
        degrades classified, never a dead worker."""
        from splatt_tpu_torch import resilience, trace

        me = self.fleet.replica
        with self._lock:
            adopt_from = self._jobs[jid].get("adopt_from")
        try:
            lease = self.fleet.lease_of(jid)
            stale = (lease.replica if lease is not None
                     and lease.expired() else None)
            if stale is not None:
                ok = self.fleet.adopt(jid)
            else:
                ok = self.fleet.acquire(jid)
        except Exception as e:
            cls = resilience.classify_failure(e)
            self._log(f"job {jid}: lease claim degraded ({cls.value}: "
                      f"{resilience.failure_message(e)[:120]}); "
                      f"re-surfaced by the fleet scan", error=True)
            return False
        if not ok:
            return False
        if self._terminal_after_claim(jid):
            # a peer finished this job between our queue scan and our
            # claim: its terminal append happened under its lease, before
            # its release, so the journal read made while we hold the
            # lease is authoritative.  Checked before the adoption is
            # journaled: an `adopted` record after the terminal one would
            # read as a reopened job to every journal reader, and the
            # job would run twice
            self.fleet.release(jid)
            self._log(f"job {jid}: finished by a peer before our claim; "
                      f"dropped")
            return False
        victim = adopt_from or (stale if stale != me else None)
        if victim:
            resilience.run_report().add(
                "job_adopted", job=jid, replica=me, from_replica=victim)
            trace.metric_inc("splatt_fleet_adoptions_total")
            if stale is not None and stale != me:
                resilience.run_report().add(
                    "lease_expired", job=jid, replica=stale,
                    role="adopter")
                trace.metric_inc("splatt_fleet_lease_expired_total",
                                 role="adopter")
            try:
                self.journal.append(self._rec(ADOPTED, jid,
                                              from_replica=victim))
            except Exception as e:
                # lineage only: the lease itself is the ownership record
                self._warn_journal("adopt", jid, e)
            self._log(f"job {jid}: adopted from {victim}")
            with self._lock:
                self._jobs[jid]["adopt_from"] = None
                self._jobs[jid]["adopted_from"] = victim
                self._jobs[jid]["resumed"] = True
        return True

    @staticmethod
    def _queue_metric(depth: int) -> None:
        from splatt_tpu_torch import trace

        trace.metric_set("splatt_serve_queue_depth", float(depth))

    @staticmethod
    def _pqueue_metric(depth: int) -> None:
        from splatt_tpu_torch import trace

        trace.metric_set("splatt_predict_queue_depth", float(depth))

    def _enqueue_locked(self, jid: str) -> None:
        """Route one pending job to its lane (callers hold the server
        lock)."""
        j = self._jobs[jid]
        if str((j.get("spec") or {}).get("kind") or "cpd") == "predict":
            self._pqueue.append(jid)
        else:
            self._queue.append(jid)

    def _unqueue_locked(self, jid: str) -> None:
        """Drop one id from whichever lane holds it (callers hold the
        server lock)."""
        if jid in self._queue:
            self._queue.remove(jid)
        if jid in self._pqueue:
            self._pqueue.remove(jid)

    def run_once(self) -> dict:
        """Ingest the spool (and in fleet mode sync the shared journal and
        surface dead peers' jobs), then run every queued job to a terminal
        state (or until a drain) on `workers` threads.  Returns
        :meth:`summary`.  In fleet mode a pass may end with only jobs left
        for a warm peer; further passes bump their deferral counts to the
        steal, so ``--once`` still ends with every job dispatched."""
        from splatt_tpu_torch import resilience

        self.scan_requests()
        if self.fleet is not None:
            self._fleet_scan()

        def loop():
            self._bind_device()
            while not self._draining.is_set():
                jids = self._next_batch()
                if not jids:
                    return
                try:
                    if len(jids) > 1:
                        self._run_batch(jids)
                    else:
                        self._run_job(jids[0])
                except Exception as e:
                    # _run_job and _run_batch handle job failures
                    # themselves, so anything here is a supervisor bug:
                    # fail the job(s) classified rather than strand the
                    # queue behind a dead worker
                    cls = resilience.classify_failure(e)
                    msg = resilience.failure_message(e)[:200]
                    for jid in jids:
                        self._log(f"job {jid}: supervisor error "
                                  f"({cls.value}: {msg})", error=True)
                        self._backstop_fail(jid, cls, msg)
                finally:
                    for jid in jids:
                        with self._lock:
                            self._running.discard(jid)
                        if self.fleet is not None:
                            try:
                                # never leak a held lease past its job (a
                                # heartbeat renewing a finished job)
                                self.fleet.release(jid)
                            except Exception as e:
                                self._log(
                                    f"job {jid}: lease release degraded "
                                    f"({resilience.classify_failure(e).value}"
                                    f": {e})", error=True)

        while not self._draining.is_set():
            with self._lock:
                if not self._queue and not self._pqueue:
                    break  # an idle daemon starts no threads
            threads = [threading.Thread(target=loop, daemon=True,
                                        name=f"splatt-serve-w{i}")
                       for i in range(max(self.workers, 1))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if self.fleet is None:
                break
        return self.summary()

    def _renew_fence(self, jid: str) -> bool:
        """The live-lease commit fence: True when this replica may commit
        for `jid` now (journal a terminal record, publish a result, a
        checkpoint or a model).  A lone daemon has no leases: always
        True.  In fleet mode a renew refusal, or a lease that cannot be
        verified, means a peer owns the job: the caller abandons it
        uncommitted.  Callers renew after the costly part of a commit
        (a checkpoint is written before its fence), just before it is
        published."""
        if self.fleet is None:
            return True
        from splatt_tpu_torch import resilience

        # a refusal's lease_expired event is the replica's, not the job's
        # (an abandoned job keeps no result to carry it)
        with resilience.unscoped():
            try:
                return bool(self.fleet.renew(jid))
            except Exception:
                return False

    def _bind_device(self) -> None:
        """Make the daemon's card the calling worker thread's current
        device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)

    def _device_fence(self) -> None:
        """Wait for the card: a sticky CUDA error raised by any job
        surfaces here, before a result that could have been read after it
        is committed.  A no-op on the CPU."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def _lose_context(self, jid: str, exc) -> None:
        """A sticky CUDA error reached job `jid`: record it, and drain, so
        that no job starts on the lost context."""
        from splatt_tpu_torch import resilience

        msg = resilience.failure_message(exc)[:200]
        with self._lock:
            first = self.context_lost is None
            if first:
                self.context_lost = msg
        self._draining.set()
        resilience.run_report().add(
            "cuda_context_lost", job=jid,
            failure_class=resilience.classify_failure(exc).value,
            error=msg)
        if first:
            self._log(f"job {jid}: sticky CUDA error ({msg}); draining: "
                      f"the jobs on the card are journaled interrupted "
                      f"and resume in a fresh process", error=True)

    def _checkpoint_fence(self, jid: str) -> Optional[Callable[[], bool]]:
        """The checkpoint-publish fence of job `jid` (:func:`cpd.cpd_als`'s
        ``checkpoint_fence``): a lease renewal in fleet mode, between a
        checkpoint's write and its rename; None for a lone daemon."""
        if self.fleet is None:
            return None
        return lambda: self._renew_fence(jid)

    def _backstop_fail(self, jid: str, cls, msg: str) -> None:
        """Commit a supervisor-error FAILED verdict, unless the job is
        already terminal (the error was post-commit cleanup) or, in fleet
        mode, its lease is gone (a peer owns it: abandoned uncommitted)."""
        with self._lock:
            already = self._jobs[jid]["state"] in TERMINAL
        if already:
            self._log(f"job {jid}: already terminal; the supervisor "
                      f"error was post-commit cleanup", error=True)
            return
        if not self._renew_fence(jid):
            with self._lock:
                self._jobs[jid]["state"] = ACCEPTED
            self._log(f"job {jid}: supervisor error without a live lease; "
                      f"abandoned uncommitted", error=True)
            return
        self._write_result(jid, {"job": jid, "status": "failed",
                                 "failure_class": cls.value,
                                 "error": msg})
        try:
            self.journal.append(self._rec(FAILED, jid, status="failed"))
        except Exception as e2:
            self._warn_journal("finish", jid, e2)
        with self._lock:
            self._jobs[jid]["state"] = FAILED
            self._jobs[jid]["status"] = "failed"

    # -- fleet membership ----------------------------------------------------

    def _start_heartbeat(self) -> None:
        """The replica's liveness thread: publish the membership lease
        and renew every held job lease each ``heartbeat_s``, so a running
        job stays owned through sweeps of any length."""
        def beat_loop():
            while not self._draining.wait(self.fleet.heartbeat_s):
                self.fleet.beat()

        self._hb_thread = threading.Thread(
            target=beat_loop, daemon=True, name="splatt-fleet-hb")
        self._hb_thread.start()

    def _fleet_scan(self) -> None:
        """One fleet sync and adoption pass: fold the shared journal's new
        records into the job table, then surface every non-terminal job
        that is neither queued or running here nor validly leased
        elsewhere.  A dead peer's jobs become local queue entries marked
        ``adopt_from`` (claimed and audited by :meth:`_claim`); exactly
        one of N scanning replicas wins the lease."""
        me = self.fleet.replica
        with self._lock:
            recs, _torn, self._journal_offset = \
                self.journal.replay_new(self._journal_offset)
            for rec in recs:
                jid = self._apply_rec_locked(rec)
                if jid and self._jobs[jid]["state"] in TERMINAL:
                    # a peer finished a job we still had queued
                    self._unqueue_locked(jid)
            candidates = [
                jid for jid, j in self._jobs.items()
                if j["state"] not in (*TERMINAL, ACCEPTING)
                and j["spec"] is not None
                and jid not in self._queue and jid not in self._pqueue
                and jid not in self._running]
        for jid in candidates:
            lease = self.fleet.lease_of(jid)
            if lease is not None and not lease.expired():
                continue  # validly owned (a live peer's, or mid-claim)
            with self._lock:
                j = self._jobs.get(jid)
                if (j is None or j["state"] in (*TERMINAL, ACCEPTING)
                        or jid in self._queue or jid in self._pqueue
                        or jid in self._running):
                    continue
                owner = (lease.replica if lease is not None
                         else j.get("owner"))
                steal = False
                if lease is None and owner not in (None, me) \
                        and self.fleet.replica_alive(owner):
                    # its accepting replica lives and will claim it,
                    # unless we are warm for its regime: the receiving
                    # half of the peer's affinity deferral (the lease
                    # claim settles the race)
                    if not (self.affinity and j.get("regime")
                            and self.fleet.warm(j["regime"])):
                        continue
                    steal = True
                j["adopt_from"] = owner if not steal \
                    and owner not in (None, me) else None
                # resumed=True is safe for a job that never started: it
                # finds no checkpoint and starts afresh
                j["resumed"] = not steal or j["state"] != ACCEPTED
                j["deferred"] = 0
                self._enqueue_locked(jid)
                self._queue_metric(len(self._queue))
                self._pqueue_metric(len(self._pqueue))
                adopt_from = j["adopt_from"]
            if adopt_from:
                self._log(f"job {jid}: dead-peer candidate (owner "
                          f"{adopt_from}); queued for adoption")

    def serve_forever(self) -> dict:
        """The daemon loop: run the queue, poll the spool, repeat, until
        a drain (SIGTERM through :meth:`install_signal_handlers`, or
        :meth:`drain`).  Returns the final :meth:`summary`."""
        while not self._draining.is_set():
            self.run_once()
            self._maybe_write_metrics()
            self._draining.wait(self.poll_s)
        self.write_metrics_now()
        return self.summary()

    # -- metrics snapshots ---------------------------------------------------

    def _maybe_write_metrics(self) -> None:
        """One cadence tick: snapshot the registry to
        ``SPLATT_METRICS_PATH`` when the interval elapsed."""
        if not self.metrics_path or self.metrics_interval_s <= 0:
            return
        now = time.monotonic()
        if now - self._metrics_last >= self.metrics_interval_s:
            self.write_metrics_now()

    def write_metrics_now(self) -> Optional[dict]:
        """Force one Prometheus-text snapshot (a failed write degrades
        classified inside :func:`trace.write_metrics`), then run the SLO
        tick.  A no-op without ``SPLATT_METRICS_PATH``."""
        if not self.metrics_path:
            return None
        from splatt_tpu_torch import trace

        self._metrics_last = time.monotonic()
        ev = trace.write_metrics(self.metrics_path)
        self._slo_tick()
        return ev

    def _slo_tick(self) -> None:
        """One aggregator tick.  A fleet replica merges the fleet's
        snapshots into ``fleet/metrics.prom``, evaluates the SLO burn
        rates over the merged samples (a peer's outage burns this
        replica's alerts too) and persists its verdicts for ``status``; a
        lone daemon evaluates over its own registry.  A tick that burns
        snapshots again (and re-merges), so the burn is in the files.  Any
        failure degrades classified."""
        from splatt_tpu_torch import fleetobs, resilience, trace

        try:
            if self.fleet is not None:
                agg = fleetobs.aggregate(self.root)
                # mirror the census into this member's registry; the
                # aggregator itself stays a side-effect-free reader
                for state in ("alive", "dead"):
                    trace.metric_set(
                        "splatt_fleet_replicas",
                        float(agg.samples.get(
                            ("splatt_fleet_replicas",
                             (("state", state),)), 0.0)),
                        state=state)
                res = self._slo.evaluate(agg.samples)
                self._slo.write_state(fleetobs.slo_state_path(
                    self.root, self.fleet.replica))
                if any(s.get("burning") for s in res["slos"].values()):
                    trace.write_metrics(self.metrics_path)
                    agg = fleetobs.aggregate(self.root)
                fleetobs.write_fleet_metrics(agg)
            else:
                res = self._slo.evaluate(trace.samples())
                if any(s.get("burning") for s in res["slos"].values()):
                    trace.write_metrics(self.metrics_path)
        except Exception as e:
            cls = resilience.classify_failure(e)
            self._log(f"slo tick degraded ({cls.value}: "
                      f"{resilience.failure_message(e)[:120]})",
                      error=True)

    def drain(self) -> None:
        """Begin a graceful drain: stop taking queued jobs, stop running
        jobs at their next fit check (they checkpoint through the cpd
        ``stop`` hook and are journaled ``interrupted``), and leave the
        rest journaled for the next start."""
        self._draining.set()

    def shutdown(self) -> None:
        """:meth:`drain`, then stop the heartbeat thread and retire the
        membership lease, so peers route around this replica at once
        instead of waiting out the lease."""
        self.drain()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=max(self.fleet.heartbeat_s * 4,
                                             1.0))
        if self.fleet is not None:
            self.fleet.retire()

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (main thread only)."""
        signal.signal(signal.SIGTERM, lambda s, f: self.drain())
        signal.signal(signal.SIGINT, lambda s, f: self.drain())

    # -- one supervised job --------------------------------------------------

    def _run_job(self, jid: str, journal_start: bool = True) -> None:
        from splatt_tpu_torch import resilience, trace

        with self._lock:
            j = self._jobs[jid]
            spec, resumed = j["spec"], j["resumed"]
            regime = j.get("regime")
            adopted_from = j.get("adopted_from")
            t_accepted = j.get("t_accepted")
            j["state"] = STARTED
        if journal_start:
            # False on the batch-degrade path: the batch already journaled
            # STARTED and observed the queue wait for every member
            try:
                self.journal.append(self._rec(STARTED, jid))
            except Exception as e:
                # without this line a crash replays the job from ACCEPTED:
                # it runs again, and its checkpoint makes that cheap
                self._warn_journal("start", jid, e)
            resilience.run_report().add("job_started", job=jid,
                                        resumed=resumed)
            if t_accepted is not None:
                trace.metric_observe("splatt_serve_queue_wait_seconds",
                                     max(time.time() - float(t_accepted),
                                         0.0))
        self._log(f"job {jid}: started" + (" (resumed)" if resumed else ""))
        # in fleet mode the span carries the replica that ran the job and
        # the adoption lineage (the trace verb's fleet summary and the
        # merged trace's flow events key on them)
        attrs = dict(job=jid, resumed=resumed)
        if self.fleet is not None:
            attrs["replica"] = self.fleet.replica
            if adopted_from:
                attrs["adopted_from"] = adopted_from
        with trace.span("serve.job", **attrs) as sp:
            launches0 = self._launch_counts()
            record, stopped = self._execute(jid, spec, resumed)
            if launches0 is not None:
                sp.set(launches=self._launch_counts(launches0))
            if record is not None and not self._renew_fence(jid):
                # the commit fence: a terminal record is journaled only
                # under a live lease.  A stalled heartbeat (a stopped
                # process, a busy host) can let the lease expire unseen by
                # the cooperative poll; this renew catches it at the last
                # gate, so a zombie never commits a job a peer adopted
                stopped["lease"] = True
                record = None
            if record is not None:
                self._write_result(jid, record)
                kind = FAILED if record["status"] == "failed" else DONE
                # the generation evidence rides the terminal record, so
                # the staleness invariant is auditable from the journal
                fence = {k: record[k]
                         for k in ("model", "model_gen", "gen",
                                   "gen_pinned")
                         if record.get(k) is not None}
                try:
                    self.journal.append(self._rec(
                        kind, jid, status=record["status"], **fence))
                    # the span carries a verdict only once it is journaled
                    sp.set(status=record["status"])
                except Exception as e:
                    self._warn_journal("finish", jid, e)
        if record is None and stopped.get("lease"):
            # ownership moved on (the lease expired; maybe adopted):
            # abandon without committing anything, no terminal record, no
            # result; the current owner carries the job from here
            with self._lock:
                self._jobs[jid]["state"] = ACCEPTED
            self._log(f"job {jid}: lease lost mid-run; abandoned "
                      f"uncommitted (the adopter owns it now)", error=True)
            return
        if record is None:
            # a drain or a lost card: not terminal.  A drained job has
            # checkpointed through the stop hook; either way the restart
            # lineage is explicit
            try:
                self.journal.append(self._rec(INTERRUPTED, jid))
            except Exception as e:
                self._warn_journal("interrupt", jid, e)
            with self._lock:
                self._jobs[jid]["state"] = INTERRUPTED
            if self.fleet is not None:
                # released at once: any live replica may resume it
                self.fleet.release(jid)
            self._log(f"job {jid}: interrupted "
                      + ("(the card's context was lost)"
                         if stopped.get("cuda") else
                         "by drain (checkpointed; resumes next start)"),
                      error=bool(stopped.get("cuda")))
            return
        with self._lock:
            self._jobs[jid]["state"] = kind
            self._jobs[jid]["status"] = record["status"]
        if self.fleet is not None:
            self.fleet.release(jid)
            if kind == DONE:
                # advertise the regime as warm: same-regime jobs route
                # here and hit the plan cache warm.  A failed job proved
                # nothing about the caches
                self.fleet.add_regime(regime)
        self._log(f"job {jid}: {record['status']}"
                  + (f" fit={record['fit']:.5f}"
                     if record.get("fit") is not None else ""))

    def _launch_counts(self, since: Optional[dict] = None
                       ) -> Optional[dict]:
        """Every kernel's launch count in this process (on a card; None on
        the CPU), or with `since` the launches made after that reading:
        what the ``serve.job`` span records of the job it wraps (counted
        process-wide, so a neighbour's launches in that window count
        too)."""
        if self.device.type != "cuda":
            return None
        from splatt_tpu_torch.ops import kernels, linalg

        now = {k.__name__: int(k.launches)
               for k in (*kernels.KERNELS, linalg.sym_eig)}
        if since is None:
            return now
        return {k: v - since.get(k, 0) for k, v in now.items()
                if v - since.get(k, 0)}

    # -- one coalesced batch -------------------------------------------------

    def _run_batch(self, jids: List[str]) -> None:
        """Run >= 2 coalesced same-regime jobs as one batched CPD.  Every
        member keeps its own STARTED record (stamped with the leader),
        queue-wait observation, result file, terminal record and health
        evidence.  Any batch failure degrades classified to per-tensor
        dispatch (``batch_degraded``), except a sticky CUDA error, after
        which the members are journaled interrupted."""
        from splatt_tpu_torch import resilience, trace
        from splatt_tpu_torch.utils import faults

        lead = jids[0]
        t0 = time.time()
        with self._lock:
            specs = {jid: self._jobs[jid]["spec"] for jid in jids}
            regime = self._jobs[lead].get("regime")
            t_acc = {jid: self._jobs[jid].get("t_accepted")
                     for jid in jids}
            resumed = {jid: bool(self._jobs[jid].get("resumed"))
                       for jid in jids}
            for jid in jids:
                self._jobs[jid]["state"] = STARTED
        for jid in jids:
            try:
                self.journal.append(self._rec(STARTED, jid, batch=lead))
            except Exception as e:
                self._warn_journal("start", jid, e)
            resilience.run_report().add("job_started", job=jid,
                                        resumed=resumed[jid])
            if t_acc[jid] is not None:
                trace.metric_observe(
                    "splatt_serve_queue_wait_seconds",
                    max(time.time() - float(t_acc[jid]), 0.0))
        resilience.run_report().add("batch_dispatched", jobs=list(jids),
                                    regime=regime, k=len(jids))
        trace.metric_inc("splatt_serve_batches_total",
                         outcome="dispatched")
        self._log(f"batch [{lead} +{len(jids) - 1}]: dispatched "
                  f"(regime {regime}, k={len(jids)})")
        try:
            faults.maybe_fail("serve.batch")
            records = self._execute_batch(jids, specs, t0, resumed)
            if records is not None:
                self._device_fence()
        except Exception as e:
            if resilience.sticky_cuda_error(e):
                self._lose_context(lead, e)
                records = None
            else:
                cls = resilience.classify_failure(e)
                msg = resilience.failure_message(e)[:200]
                resilience.run_report().add(
                    "batch_degraded", jobs=list(jids),
                    failure_class=cls.value, error=msg)
                trace.metric_inc("splatt_serve_batches_total",
                                 outcome="degraded")
                self._log(f"batch [{lead} +{len(jids) - 1}]: degraded to "
                          f"per-tensor dispatch ({cls.value}: {msg})",
                          error=True)
                for jid in jids:
                    self._run_job(jid, journal_start=False)
                return
        if records is None:
            # a drain (or a lost card) mid-batch: batched runs keep no
            # checkpoints, so the members start afresh on resume
            for jid in jids:
                try:
                    self.journal.append(self._rec(INTERRUPTED, jid))
                except Exception as e:
                    self._warn_journal("interrupt", jid, e)
                with self._lock:
                    self._jobs[jid]["state"] = INTERRUPTED
                if self.fleet is not None:
                    self.fleet.release(jid)
            self._log(f"batch [{lead} +{len(jids) - 1}]: interrupted; "
                      f"members resume next start")
            return
        for jid in jids:
            self._commit_batch_member(jid, records[jid], regime)

    def _commit_batch_member(self, jid: str, record: dict,
                             regime: Optional[str] = None) -> None:
        """One member's terminal commit, its metrics recorded inside a
        scope of its own, so the samples carry this member's job label.
        The fences of :meth:`_run_job`'s tail: in fleet mode the terminal
        record is journaled only under a live lease (a refusal abandons
        this member uncommitted), and a done member advertises the
        regime."""
        from splatt_tpu_torch import resilience, trace

        if not self._renew_fence(jid):
            with self._lock:
                self._jobs[jid]["state"] = ACCEPTED
            self._log(f"job {jid}: lease lost mid-batch; abandoned "
                      f"uncommitted (the adopter owns it now)", error=True)
            return
        with resilience.scope(jid):
            trace.metric_inc("splatt_serve_jobs_total",
                             status=record["status"])
            trace.metric_inc("splatt_serve_batch_jobs_total")
            trace.metric_observe("splatt_job_seconds",
                                 float(record["seconds"]))
            record["metrics"] = trace.metrics_snapshot(job=jid)
        if self.fleet is not None:
            record["replica"] = self.fleet.replica
            with self._lock:
                adopted_from = self._jobs[jid].get("adopted_from")
            if adopted_from:
                record["adopted_from"] = adopted_from
        self._write_result(jid, record)
        kind = FAILED if record["status"] == "failed" else DONE
        try:
            self.journal.append(self._rec(kind, jid,
                                          status=record["status"]))
        except Exception as e:
            self._warn_journal("finish", jid, e)
        with self._lock:
            self._jobs[jid]["state"] = kind
            self._jobs[jid]["status"] = record["status"]
        if self.fleet is not None:
            self.fleet.release(jid)
            if kind == DONE:
                self.fleet.add_regime(regime)
        self._log(f"job {jid}: {record['status']}"
                  + (f" fit={record['fit']:.5f}"
                     if record.get("fit") is not None else ""))

    def _execute_batch(self, jids: List[str], specs: Dict[str, dict],
                       t0: float, resumed: Dict[str, bool]
                       ) -> Optional[Dict[str, dict]]:
        """The batch body: every member's workload through one
        :func:`splatt_tpu_torch.cpd.cpd_als_batched` under a batch scope.
        Returns per-job records (each with its slot's health events), or
        None when a drain interrupted the run.  Exceptions go to
        :meth:`_run_batch`."""
        from splatt_tpu_torch import resilience, trace
        from splatt_tpu_torch.config import Options, Verbosity
        from splatt_tpu_torch.cpd import cpd_als_batched

        lead = jids[0]
        spec0 = specs[lead]

        def _stop() -> bool:
            return self._draining.is_set()

        with resilience.scope(f"batch-{lead}") as sc:
            tensors = [_load_workload(specs[jid]) for jid in jids]
            seeds = [int(specs[jid].get("seed", 0)) for jid in jids]
            rank = int(spec0.get("rank", 8))
            opts = Options(
                random_seed=seeds[0],
                max_iterations=int(spec0.get("iters", 25)),
                tolerance=float(spec0.get("tol", 1e-5)),
                verbosity=(Verbosity.LOW if self.verbose
                           else Verbosity.NONE),
                autotune=spec0.get("autotune"))
            with trace.span("serve.batch", k=len(jids), leader=lead):
                res = cpd_als_batched(tensors, rank=rank, opts=opts,
                                      seeds=seeds, stop=_stop,
                                      device=self.device)
            if res.stopped or self._draining.is_set():
                return None
            events = [{k: v for k, v in e.items() if k != "ts"}
                      for e in sc.report.events()]
        records: Dict[str, dict] = {}
        for i, jid in enumerate(jids):
            status = res.statuses[i]
            slot_events = [e for e in events
                           if e.get("slot") in (None, i)]
            rec = {"job": jid, "status": status,
                   "fit": float(res.fits[i]),
                   "resumed": bool(resumed.get(jid)),
                   "seconds": round(time.time() - t0, 3),
                   "degraded": status != "converged",
                   "batched": {"k": res.k, "leader": lead, "slot": i,
                               "compiles": res.compiles,
                               "iterations": res.iterations,
                               "rollbacks": res.rollbacks[i]},
                   "events": slot_events, "demotions": []}
            if status == "degraded":
                rec["failure_class"] = "numerical"
            records[jid] = rec
        return records

    def _execute(self, jid: str, spec: dict, resumed: bool):
        """Run one job under its own resilience scope and fault schedule;
        returns ``(record, stopped)``: the result record, or None when a
        drain interrupted the run (already checkpointed), the job's lease
        was lost (``stopped["lease"]``: abandon, committing nothing, the
        adopter owns the job) or the card's context was lost
        (``stopped["cuda"]``)."""
        from splatt_tpu_torch import resilience, trace
        from splatt_tpu_torch.utils import faults

        t0 = time.time()
        stopped = {"drain": False, "deadline": False, "cuda": False,
                   "lease": False}

        # an explicit deadline_s (0 included: a documented opt-out) beats
        # the server default
        ds = spec.get("deadline_s")
        deadline_s = float(ds if ds is not None
                           else (self.job_deadline_s or 0.0))
        deadline_end = (time.monotonic() + deadline_s
                        if deadline_s > 0 else None)

        def _stop_or_deadline() -> bool:
            # the watchdog cannot preempt a worker thread, so the deadline
            # is also enforced through the fit-check poll the drain uses
            if deadline_end is not None \
                    and time.monotonic() > deadline_end:
                stopped["deadline"] = True
                return True
            if self.fleet is not None and self.fleet.lost(jid):
                # the heartbeat's renew was refused: ownership is gone,
                # stop before committing anything further
                stopped["lease"] = True
                return True
            if self._draining.is_set():
                stopped["drain"] = True
                return True
            return False

        with resilience.scope(jid,
                              health_retries=spec.get("health_retries"),
                              deadline_s=spec.get("deadline_s")) as sc:
            record: dict = {"job": jid}
            armed: Dict[str, object] = {}
            try:
                # the job's fault schedule parses inside the guarded
                # region: a tenant's typo fails that job, classified
                with faults.scoped(spec.get("faults") or "") as armed:
                    with resilience.deadline("serve.job_run",
                                             deadline_s
                                             if deadline_s > 0 else 0):
                        faults.maybe_fail("serve.job_run")
                        update_info = None
                        predict_rec = None
                        ingest_rec = None
                        model_gen = None
                        tune_info = None
                        job_kind = str(spec.get("kind") or "cpd")
                        if job_kind == "update":
                            out, update_info = self._run_update(
                                jid, spec, _stop_or_deadline)
                        elif job_kind == "predict":
                            predict_rec = self._run_predict(jid, spec)
                            out = None
                        elif job_kind == "ingest":
                            ingest_rec = self._run_ingest(
                                jid, spec, _stop_or_deadline)
                            out = None
                        else:
                            out, tune_info, model_gen = self._run_cpd(
                                jid, spec, _stop_or_deadline)
                        if stopped["deadline"]:
                            # the cooperative stop beat the timer: convert
                            # explicitly, so the verdict is TIMEOUT
                            resilience.run_report().add(
                                "deadline_blown", site="serve.job_run",
                                seconds=float(deadline_s))
                            raise resilience.DeadlineExceeded(
                                f"splatt deadline blown at "
                                f"serve.job_run after {deadline_s:g}s "
                                f"(cooperative job-deadline stop)")
                        if not (stopped["drain"] or stopped["lease"]) \
                                and predict_rec is None \
                                and ingest_rec is None:
                            # nothing is committed from a read a sticky
                            # error could have followed (a predict and an
                            # ingest touch the host only)
                            self._device_fence()
                if stopped["drain"] or stopped["lease"]:
                    return None, stopped
                if predict_rec is not None:
                    # "served"/"refused" is its own status class
                    record.update(predict_rec)
                elif ingest_rec is not None:
                    # "converged" on a finalized stream, "degraded" when
                    # the quarantine budget tripped: committed chunks
                    # survive either way
                    record.update(ingest_rec)
                else:
                    degraded = bool(sc.report.events("health_degraded"))
                    if degraded:
                        resilience.run_report().add(
                            "job_degraded", job=jid,
                            failure_class="numerical",
                            error="health-retry budget exhausted")
                    record.update(status="degraded" if degraded
                                  else "converged",
                                  fit=float(out.fit))
                if tune_info is not None:
                    record["tune"] = tune_info
                if update_info is not None:
                    record["update"] = update_info
                    if update_info.get("model_gen") is not None:
                        record["model"] = update_info["base"]
                        record["model_gen"] = update_info["model_gen"]
                if model_gen is not None:
                    record["model"] = jid
                    record["model_gen"] = model_gen
            except Exception as e:
                if resilience.sticky_cuda_error(e):
                    self._lose_context(jid, e)
                    stopped["cuda"] = True
                    return None, stopped
                cls = resilience.classify_failure(e)
                msg = resilience.failure_message(e)[:200]
                resilience.run_report().add(
                    "job_degraded", job=jid,
                    failure_class=cls.value, error=msg)
                record.update(status="failed",
                              failure_class=cls.value, error=msg)
            # the fired counts survive both outcomes; {} when the schedule
            # never parsed
            fired = {site: s.fired for site, s in armed.items()
                     if s.fired}
            record.update(
                resumed=resumed, seconds=round(time.time() - t0, 3),
                degraded=record["status"] not in ("converged",
                                                  "served"),
                events=[{k: v for k, v in e.items() if k != "ts"}
                        for e in sc.report.events()],
                demotions=[dict(engine=d.engine,
                                failure_class=d.failure_class.value,
                                shape_key=d.shape_key,
                                error=d.error[:120])
                           for d in resilience.demotions()])
            if fired:
                record["faults_fired"] = fired
            # terminal metrics inside the scope, so every sample carries
            # this tenant's job label; then the job's own cut of the
            # registry rides its result
            trace.metric_inc("splatt_serve_jobs_total",
                             status=record["status"])
            trace.metric_observe("splatt_job_seconds",
                                 float(record["seconds"]))
            record["metrics"] = trace.metrics_snapshot(job=jid)
            if self.fleet is not None:
                record["replica"] = self.fleet.replica
                with self._lock:
                    adopted_from = self._jobs[jid].get("adopted_from")
                if adopted_from:
                    record["adopted_from"] = adopted_from
        return record, stopped

    def _options(self, spec: dict, **kw):
        """A job's Options: its seed, iterations and tolerance, and the
        engine knobs it names.  ``use_pallas`` has no counterpart on a
        GPU and is ignored."""
        from splatt_tpu_torch.config import Options, Verbosity

        return Options(**dict(dict(
            random_seed=int(spec.get("seed", 0)),
            max_iterations=int(spec.get("iters", 25)),
            tolerance=float(spec.get("tol", 1e-5)),
            verbosity=Verbosity.LOW if self.verbose else Verbosity.NONE,
            autotune=spec.get("autotune"),
            engine_fallback=spec.get("engine_fallback")), **kw))

    def _run_cpd(self, jid: str, spec: dict, stop: Callable[[], bool]):
        """The ``cpd`` job body: workload, optional pre-tune, the blocked
        build, guarded cpd_als with a per-job checkpoint, then the fit
        commit: the final factors checkpointed and the generation
        advanced, which makes the fit servable."""
        import dataclasses

        from splatt_tpu_torch import tune as _tune
        from splatt_tpu_torch.blocked import BlockedSparse
        from splatt_tpu_torch.cpd import _save_checkpoint, cpd_als
        from splatt_tpu_torch.predict import advance_generation

        t = time.perf_counter()
        parts: Dict[str, float] = {}
        tt = _load_workload(spec)
        parts["load_s"] = time.perf_counter() - t
        rank = int(spec.get("rank", 8))
        opts = self._options(spec)
        tune_info = None
        if spec.get("tune"):
            # the Nth same-regime job hits the warm shared plan cache
            # (measured == 0)
            res = _tune.tune(tt, rank=rank, opts=opts, device=self.device)
            tune_info = dict(
                measured=res.measured, cache_hits=res.cache_hits,
                skipped=res.skipped,
                plans={str(m): dataclasses.asdict(p)
                       for m, p in sorted(res.plans.items())})
        t = time.perf_counter()
        bs = BlockedSparse.compile(tt, opts, device=self.device, rank=rank)
        parts["compile_s"] = time.perf_counter() - t
        ckpt = os.path.join(self.ckpt_dir, f"{jid}.npz")
        t = time.perf_counter()
        # in fleet mode every checkpoint is written first and renewed for
        # just before its rename: an owner whose lease was lost during
        # the write does not publish it over its adopter's
        out = cpd_als(bs, rank=rank, opts=opts, device=self.device,
                      checkpoint_path=ckpt,
                      checkpoint_every=int(spec.get("checkpoint_every", 5)),
                      stop=stop, checkpoint_fence=self._checkpoint_fence(jid))
        parts["sweeps_s"] = time.perf_counter() - t
        gen = None
        t = time.perf_counter()
        if not (stop is not None and stop()) and _save_checkpoint(
                ckpt, out.factors, out.lam, 0, float(out.fit),
                fence=self._checkpoint_fence(jid)) is not None \
                and self._renew_fence(jid):
            # the fit commit, each write renewed for just before it in
            # fleet mode; a failed stamp advance (the model.generation
            # fault site) raises, the commit aborts classified and readers
            # keep the previous generation
            gen = advance_generation(self.ckpt_dir, jid, out.factors,
                                     out.lam)
            parts["commit_s"] = time.perf_counter() - t
        with self._lock:
            self.timings[jid] = parts
        return out, tune_info, gen

    # -- one incremental model update ----------------------------------------

    def _run_update(self, jid: str, spec: dict,
                    stop: Callable[[], bool]):
        """The ``update`` job body (≙ splatt_tpu/serve.py:2020-2197):
        merge the delta COO into the base model's tensor, re-solve the
        rows it touched (:func:`cpd.refresh_touched_rows`), run a few
        warm-started sweeps, and commit a new generation.

        Repair path: a missing model, a periodic-refit boundary
        (``SPLATT_UPDATE_REFIT_EVERY``), a health degrade or any failure
        of the warm path (the ``cpd.update`` fault site included) runs a
        from-scratch refit of the merged tensor instead
        (``refit_scheduled``): an update can cost sweeps, never the
        model.  A sticky CUDA error is not repaired: it propagates."""
        from splatt_tpu_torch import resilience, trace
        from splatt_tpu_torch.blocked import BlockedSparse
        from splatt_tpu_torch.cpd import (_save_checkpoint, cpd_als,
                                          load_checkpoint_resilient,
                                          refresh_touched_rows,
                                          touched_rows)
        from splatt_tpu_torch.predict import advance_generation
        from splatt_tpu_torch.utils.env import read_env_int

        base = str(spec.get("base") or "")
        with self._lock:
            bj = self._jobs.get(base)
            base_spec = (dict(bj["spec"])
                         if bj is not None and bj.get("spec") else None)
            # the ordinal of this update against the base model: the
            # finished updates before it + 1, what the refit cadence
            # counts
            nup = 1 + sum(
                1 for q, j2 in self._jobs.items()
                if q != jid and j2["state"] == DONE
                and str((j2.get("spec") or {}).get("kind")
                        or "cpd") == "update"
                and str((j2.get("spec") or {}).get("base")
                        or "") == base)
        if base_spec is None:
            raise ValueError(
                f"update base {base!r} is unknown to this spool (the "
                f"base job's accepted spec must be in the journal)")
        t = time.perf_counter()
        parts: Dict[str, float] = {}
        delta = _load_delta(spec)
        ckpt = os.path.join(self.ckpt_dir, f"{base}.npz")
        tpath = os.path.join(self.ckpt_dir, f"{base}.model.npz")
        tt, applied = _load_model_tensor(tpath)
        if tt is None:
            tt = _load_workload(base_spec)
            applied = []
        if jid in applied:
            # a re-run of an update whose persist landed but whose
            # terminal record did not: never merge its delta twice
            merged = tt
        else:
            merged = _merge_delta(tt, delta)
        parts["load_s"] = time.perf_counter() - t
        rank = int(base_spec.get("rank", 8))
        sweeps = int(spec.get("iters")
                     or read_env_int("SPLATT_UPDATE_SWEEPS"))
        refit_every = int(read_env_int("SPLATT_UPDATE_REFIT_EVERY"))
        info = {"base": base, "delta_nnz": int(delta.nnz),
                "update_n": int(nup), "sweeps": int(sweeps)}

        def make_opts(iters: int):
            # reorder pinned to identity: the touched-row refresh runs in
            # the original row space of the checkpointed factors
            return self._options(
                dict(spec, seed=spec.get("seed", base_spec.get("seed", 0)),
                     tol=spec.get("tol", base_spec.get("tol", 1e-5)),
                     engine_fallback=None),
                max_iterations=int(iters), reorder="identity")

        reason = None
        out = None
        model = None
        if not (os.path.exists(ckpt) or os.path.exists(ckpt + ".bak")):
            reason = "no_model"
        else:
            # a base model checkpointed under a relabeled order degrades
            # here to None, the refit path
            model = load_checkpoint_resilient(
                ckpt, expect_reorder="identity")
            if model is None:
                reason = "no_model"
        if reason is None and refit_every > 0 and nup % refit_every == 0:
            reason = "periodic"
        if reason is None:
            try:
                factors = model[0]
                ck_dims = tuple(int(u.shape[0]) for u in factors)
                if ck_dims != tuple(merged.dims) \
                        or int(factors[0].shape[1]) != rank:
                    raise ValueError(
                        f"model checkpoint is for dims={ck_dims} "
                        f"rank={int(factors[0].shape[1])}, merged "
                        f"tensor wants dims={tuple(merged.dims)} "
                        f"rank={rank}")
                opts = make_opts(sweeps)
                t = time.perf_counter()
                bs = BlockedSparse.compile(merged, opts, device=self.device,
                                           rank=rank)
                parts["compile_s"] = time.perf_counter() - t
                t = time.perf_counter()
                with trace.span("cpd.update", job=jid, base=base,
                                delta_nnz=int(delta.nnz)):
                    warm = refresh_touched_rows(
                        bs, factors,
                        touched_rows(delta, merged.nmodes),
                        reg=opts.regularization)
                    out = cpd_als(bs, rank=rank, opts=opts, init=warm,
                                  device=self.device, stop=stop)
                parts["sweeps_s"] = time.perf_counter() - t
                if resilience.run_report().events("health_degraded"):
                    # a warm update that blew up numerically is repaired
                    # by a full refit, not committed
                    reason = "health"
                    out = None
            except Exception as e:
                if resilience.sticky_cuda_error(e):
                    raise
                cls = resilience.classify_failure(e)
                reason = f"failed:{cls.value}"
                self._log(f"job {jid}: warm update failed "
                          f"({cls.value}: "
                          f"{resilience.failure_message(e)[:120]}); "
                          f"repairing with a full refit", error=True)
        if reason is not None:
            resilience.run_report().add(
                "refit_scheduled", job=jid, base=base, reason=reason,
                update_n=int(nup))
            trace.metric_inc("splatt_serve_updates_total",
                             outcome="refit")
            info["refit"] = reason
            opts = make_opts(int(base_spec.get("iters", 25)))
            t = time.perf_counter()
            bs = BlockedSparse.compile(merged, opts, device=self.device,
                                       rank=rank)
            parts["compile_s"] = time.perf_counter() - t
            t = time.perf_counter()
            out = cpd_als(bs, rank=rank, opts=opts, device=self.device,
                          stop=stop)
            parts["sweeps_s"] = time.perf_counter() - t
        else:
            resilience.run_report().add(
                "update_applied", job=jid, base=base, update_n=int(nup),
                sweeps=int(sweeps), delta_nnz=int(delta.nnz),
                fit=float(out.fit))
            trace.metric_inc("splatt_serve_updates_total",
                             outcome="applied")
        t = time.perf_counter()
        if not (stop is not None and stop()) and _save_checkpoint(
                ckpt, out.factors, out.lam, 0, float(out.fit),
                fence=self._checkpoint_fence(jid)) is not None:
            # the model store advances only for complete runs, each write
            # renewed for just before it in fleet mode; the `applied`
            # stamps make a re-run idempotent even across a crash between
            # these writes and the terminal record
            if jid not in applied:
                applied = list(applied) + [jid]
            _save_model_tensor(tpath, merged, applied)
            # the generation fence seals the commit last: a failed
            # advance fails this update classified, the stamp never
            # moved, and readers verify the old stamp against the .bak
            # checkpoint, so the old generation keeps serving
            if self._renew_fence(jid):
                info["model_gen"] = int(advance_generation(
                    self.ckpt_dir, base, out.factors, out.lam))
                if spec.get("ingest_committed_ts"):
                    # an ingest-chained update: the source chunk's journal
                    # commit to this model commit is the live feed's
                    # freshness
                    lag = max(time.time()
                              - float(spec["ingest_committed_ts"]), 0.0)
                    trace.metric_observe(
                        "splatt_ingest_update_lag_seconds", lag)
                    info["ingest_lag_s"] = round(lag, 3)
            parts["commit_s"] = time.perf_counter() - t
        with self._lock:
            self.timings[jid] = parts
        return out, info

    # -- one generation-fenced predict ---------------------------------------

    def _run_predict(self, jid: str, spec: dict) -> dict:
        """The ``predict`` job body: answer from an intact model
        generation or refuse, never garbage.  The hot-factor cache at the
        generation pinned at admission first; a miss or a poisoned lookup
        (``predict.cache``) degrades to the direct fenced read
        (``predict.read`` inside), which serves the newest generation
        that verifies.  No intact generation: status "refused".  Host
        numpy only: no kernel runs here."""
        from splatt_tpu_torch import predict as _predict
        from splatt_tpu_torch import resilience, trace

        model = str(spec.get("model") or "")
        with self._lock:
            j = self._jobs.get(jid) or {}
            pinned = j.get("gen_pinned")
            t_accepted = j.get("t_accepted")
        rec: dict = {"model": model}
        if pinned is not None:
            rec["gen_pinned"] = int(pinned)
        with trace.span("serve.predict", job=jid, model=model) as sp:
            entry = None
            cache_outcome = "miss"
            if pinned:
                try:
                    entry = self._hot_cache.get(model, int(pinned))
                    if entry is not None:
                        cache_outcome = "hit"
                except Exception as e:
                    cls = resilience.classify_failure(e)
                    resilience.run_report().add(
                        "predict_degraded", job=jid, model=model,
                        reason="cache_poisoned",
                        failure_class=cls.value,
                        error=resilience.failure_message(e)[:120])
                    entry = None
            if entry is None:
                try:
                    entry = _predict.load_model_generation(
                        self.ckpt_dir, model)
                except Exception as e:
                    cls = resilience.classify_failure(e)
                    resilience.run_report().add(
                        "predict_degraded", job=jid, model=model,
                        reason="read_failed",
                        failure_class=cls.value,
                        error=resilience.failure_message(e)[:120])
                    entry = None
                if entry is not None:
                    self._hot_cache.put(model, entry["gen"], entry)
            if entry is None:
                resilience.run_report().add(
                    "predict_degraded", job=jid, model=model,
                    reason="no_intact_generation")
                trace.metric_inc("splatt_predict_requests_total",
                                 outcome="refused")
                sp.set(status="refused")
                rec.update(status="refused",
                           reason="no_intact_generation")
                return rec
            gen = int(entry["gen"])
            if spec.get("coords") is not None:
                vals = _predict.reconstruct_entries(
                    entry["factors"], entry["lam"], spec["coords"])
                rec["values"] = [float(v) for v in vals]
            tk = spec.get("top_k")
            if isinstance(tk, dict):
                fixed = {int(m): int(i) for m, i in
                         (tk.get("fixed") or {}).items()}
                idx, scores = _predict.top_k_slice(
                    entry["factors"], entry["lam"], fixed,
                    int(tk.get("mode", 0)), int(tk.get("k", 10)))
                rec["top_k"] = {"indices": [int(i) for i in idx],
                                "scores": [float(s) for s in scores]}
            rec.update(status="served", gen=gen, sha=entry["sha"],
                       cache=cache_outcome)
            resilience.run_report().add(
                "predict_served", job=jid, model=model, gen=gen,
                gen_pinned=(int(pinned) if pinned is not None
                            else None),
                cache=cache_outcome)
            trace.metric_inc("splatt_predict_requests_total",
                             outcome="served")
            if t_accepted is not None:
                trace.metric_observe(
                    "splatt_predict_latency_seconds",
                    max(time.time() - float(t_accepted), 0.0))
            sp.set(status="served", gen=gen, cache=cache_outcome)
        return rec

    # -- one streaming-ingest job --------------------------------------------

    def _run_ingest(self, jid: str, spec: dict, stop) -> dict:
        """The ``ingest`` job body (≙ splatt_tpu/serve.py:2298-2430):
        stream ``spec['source']`` into ``<root>/ingest/<jid>/`` under the
        exactly-once chunk journal (ingest.py) and, when the spec names a
        ``base`` model, emit one ``update`` job per watermark interval
        (``update_every`` / SPLATT_INGEST_UPDATE_EVERY committed chunks).
        Each carries its chunk's journal-commit time, so the model commit
        observes the update lag (``splatt_ingest_update_lag_seconds``).

        Emission is durable in its own right: each interval lands in
        ``deltas/updates.jsonl`` in fence order.  The delta file publishes
        atomically under a range-keyed name (a published delta is never
        overwritten), the intent is journaled, and only then is the job
        submitted under the deterministic id ``<jid>-up-<lo>-<hi>``.  A
        killed or lease-stopped ingest job re-runs whole: the chunk
        journal's replay makes the chunks exactly-once, and the updates
        journal's replay re-derives the chunk range already fed to
        updates.  The re-run never re-spans those chunks, re-assembles a
        journaled delta that went missing, and re-submits every journaled
        intent (the job table dedups known ids), so the update chain
        neither drops nor double-applies records across a crash.  The
        updates run on this daemon's card, as any submitted update does."""
        from splatt_tpu_torch import ingest as ingest_mod
        from splatt_tpu_torch.io import _bin_header
        from splatt_tpu_torch.utils.env import read_env_int

        source = str(spec["source"])
        dest = str(spec.get("dest")
                   or os.path.join(self.root, "ingest", jid))
        base = spec.get("base")
        update_every = int(spec.get("update_every")
                           or read_env_int("SPLATT_INGEST_UPDATE_EVERY"))
        dims = (tuple(int(d) for d in spec["dims"])
                if spec.get("dims") else None)
        updates: list = []
        ujournal = Journal(os.path.join(dest, "deltas", "updates.jsonl"))
        covered = {"hi": -1}

        def _submit_update(intent: dict) -> None:
            res = self.submit({
                "kind": "update", "base": str(base),
                "delta_tensor": str(intent["delta"]),
                "id": str(intent["id"]),
                "tenant": spec.get("tenant"),
                "ingest_committed_ts":
                    float(intent.get("ingest_committed_ts") or 0.0)})
            state = res.get("state") or ("queued" if res.get("job")
                                         else REJECTED)
            if res.get("job") and state != REJECTED:
                if res["job"] not in updates:
                    updates.append(res["job"])
            else:
                self._log(f"job {jid}: watermark update for chunks "
                          f"[{intent['lo']}, {intent['hi']}] not accepted "
                          f"({res}); the delta file and its journaled "
                          f"intent remain for the next re-run to retry",
                          error=True)

        if base:
            # re-run recovery from durable state, before any new interval
            # fires: the journaled intents say which chunks earlier runs
            # fed to updates, a missing delta re-assembles from the
            # committed segments, and every intent re-submits (dedup by
            # id)
            intents, _torn = ujournal.replay()
            for it in intents:
                if it.get("rec") != "update_intent":
                    continue
                covered["hi"] = max(covered["hi"], int(it["hi"]))
                if not int(it.get("nnz") or 0):
                    continue
                if not os.path.exists(str(it["delta"])):
                    ingest_mod.assemble_delta(
                        dest, int(it["lo"]), int(it["hi"]),
                        tuple(it.get("dims") or dims), str(it["delta"]))
                _submit_update(it)

        def on_watermark(st, rec):
            if not base:
                return
            n = int(rec["n"])
            if n - covered["hi"] < max(update_every, 1):
                return
            lo = covered["hi"] + 1
            dpath = os.path.join(dest, "deltas", f"up-{lo:08d}-{n:08d}.bin")
            os.makedirs(os.path.dirname(dpath), exist_ok=True)
            ddims = tuple(int(d) for d in (dims or st.final_dims()))
            if os.path.exists(dpath):
                # a crashed attempt already published this exact range
                # (publish is atomic, so the file is whole): reuse it
                nnz = int(_bin_header(dpath)[4])
            else:
                delta = ingest_mod.assemble_delta(dest, lo, n, ddims, dpath)
                nnz = int(delta.nnz)
            intent = {"rec": "update_intent", "lo": lo, "hi": n,
                      "id": f"{jid}-up-{lo}-{n}", "delta": dpath,
                      "nnz": nnz, "dims": [int(d) for d in ddims],
                      "ingest_committed_ts": float(rec.get("ts") or 0.0)}
            # the emission fence: the intent journals before the submit,
            # so a crash in between re-submits by id on the next run
            # instead of re-deriving an overlapping range; an append
            # failure aborts the job rather than risk a double-applied
            # interval
            ujournal.append(intent)
            covered["hi"] = n
            if nnz:
                _submit_update(intent)

        summary = ingest_mod.ingest_stream(
            source, dest, fmt=str(spec.get("format") or "auto"),
            chunk_records=(int(spec["chunk_records"])
                           if spec.get("chunk_records") else None),
            dims=dims, stop=stop, on_watermark=on_watermark)
        return {
            "status": summary["status"],
            "ingest": {k: summary[k] for k in
                       ("dest", "format", "chunks", "watermark", "records",
                        "nnz", "quarantined", "resumed", "stopped", "dims",
                        "tensor", "records_per_sec", "error")},
            "updates": updates,
        }

    # -- plumbing ------------------------------------------------------------

    def _write_result(self, jid: str, record: dict) -> None:
        """Atomic result publish: a reader never sees a torn result
        file."""
        from splatt_tpu_torch import resilience
        from splatt_tpu_torch.utils.durable import publish_json

        path = os.path.join(self.results_dir, f"{jid}.json")
        try:
            publish_json(path, record, sort_keys=True)
        except Exception as e:
            cls = resilience.classify_failure(e)
            self._log(f"job {jid}: result write failed ({cls.value}: "
                      f"{resilience.failure_message(e)[:120]}); the "
                      f"journal still carries the terminal state",
                      error=True)

    def _warn_journal(self, op: str, jid: str, exc) -> None:
        """Classified warn-and-continue for a journal append that is not
        load-bearing (a submission's is, and rejects instead)."""
        from splatt_tpu_torch import resilience

        cls = resilience.classify_failure(exc)
        self._log(f"job {jid}: journal append ({op}) failed "
                  f"({cls.value}: "
                  f"{resilience.failure_message(exc)[:120]}); "
                  f"continuing; replay re-derives this record",
                  error=True)

    def _log(self, msg: str, error: bool = False) -> None:
        import sys

        if error or self.verbose:
            print(f"splatt-serve: {msg}",
                  file=sys.stderr if error else sys.stdout, flush=True)


def _load_workload(spec: dict):
    """The job's tensor: a file (``tensor``) or a seeded synthetic
    (``synthetic: {dims, nnz, seed}``)."""
    if spec.get("tensor"):
        from splatt_tpu_torch.io import load

        return load(spec["tensor"])
    syn = spec.get("synthetic")
    if not isinstance(syn, dict) or not syn.get("dims"):
        raise ValueError("job spec needs 'tensor': <path> or "
                         "'synthetic': {dims, nnz, seed}")
    from splatt_tpu_torch.chaos import synthetic_tensor

    return synthetic_tensor(tuple(int(d) for d in syn["dims"]),
                            int(syn.get("nnz", 1000)),
                            int(syn.get("seed", 0)))


# -- the model store's delta and tensor plumbing -----------------------------

def _load_delta(spec: dict):
    """The update job's delta COO: a file (``delta_tensor``) or a seeded
    synthetic (``delta: {dims, nnz, seed}``)."""
    if spec.get("delta_tensor"):
        from splatt_tpu_torch.io import load

        return load(spec["delta_tensor"])
    d = spec.get("delta")
    if not isinstance(d, dict) or not d.get("dims"):
        raise ValueError("update job needs 'delta': {dims, nnz, seed} "
                         "or 'delta_tensor': <path>")
    from splatt_tpu_torch.chaos import synthetic_tensor

    return synthetic_tensor(tuple(int(x) for x in d["dims"]),
                            int(d.get("nnz", 100)),
                            int(d.get("seed", 0)))


def _merge_delta(tt, delta):
    """Append a delta COO to the model tensor.  A delta hitting an
    existing coordinate adds to its value (the MTTKRP's segment sums make
    duplicates additive).  The delta may not grow a mode past the model's
    dims: the checkpointed factors have no rows for new indices."""
    import numpy as np

    from splatt_tpu_torch.coo import SparseTensor

    if delta.nmodes != tt.nmodes:
        raise ValueError(f"delta has {delta.nmodes} modes, the model "
                         f"tensor has {tt.nmodes}")
    for m in range(tt.nmodes):
        if delta.dims[m] > tt.dims[m]:
            raise ValueError(
                f"delta grows mode {m} to {delta.dims[m]} past the "
                f"model's dim {tt.dims[m]}; the checkpointed factors "
                f"have no rows for new indices")
    return SparseTensor(
        inds=np.concatenate([np.asarray(tt.inds),
                             np.asarray(delta.inds)], axis=1),
        vals=np.concatenate([np.asarray(tt.vals),
                             np.asarray(delta.vals)]),
        dims=tt.dims)


def _save_model_tensor(path: str, tt, applied) -> None:
    """Persist the model's merged COO beside its checkpoint (atomic
    publish), with the ids of every applied update: the idempotency stamp
    a crashed update's re-run checks before merging its delta again.
    The payload and its digest are the JAX package's."""
    import io as _io

    import numpy as np

    from splatt_tpu_torch.cpd import _checkpoint_digest
    from splatt_tpu_torch.utils.durable import publish_bytes

    payload = {"inds": np.asarray(tt.inds), "vals": np.asarray(tt.vals),
               "dims": np.asarray(tt.dims),
               "applied": np.asarray(list(applied), dtype="U64")}
    buf = _io.BytesIO()
    np.savez(buf, checksum=np.asarray(_checkpoint_digest(payload)),
             **payload)
    publish_bytes(path, buf.getvalue())


def _load_model_tensor(path: str):
    """A persisted model tensor -> (SparseTensor, applied ids), or
    ``(None, [])`` when absent or unreadable: a torn one (unparseable,
    without its ``applied`` stamp, or failing its checksum) is a
    classified ``model_torn`` event, and the update rebuilds from the
    base workload."""
    import numpy as np

    from splatt_tpu_torch.coo import SparseTensor

    try:
        with np.load(path) as z:
            if "applied" not in z.files:
                raise ValueError(
                    "model tensor has no 'applied' idempotency stamp")
            if "checksum" in z.files:
                from splatt_tpu_torch.cpd import _checkpoint_digest

                payload = {k: np.asarray(z[k])
                           for k in ("inds", "vals", "dims", "applied")}
                want = str(z["checksum"])
                got = _checkpoint_digest(payload)
                if got != want:
                    raise ValueError(
                        f"model tensor checksum mismatch: stored "
                        f"{want[:12]} != computed {got[:12]}")
            tt = SparseTensor(inds=np.asarray(z["inds"]),
                              vals=np.asarray(z["vals"]),
                              dims=tuple(int(d) for d in z["dims"]))
            applied = [str(s) for s in z["applied"]]
        return tt, applied
    except FileNotFoundError:
        return None, []
    except Exception as e:
        from splatt_tpu_torch import resilience

        resilience.run_report().add(
            "model_torn", path=path, piece="model-tensor",
            failure_class=resilience.classify_failure(e).value,
            error=resilience.failure_message(e)[:200])
        return None, []


# -- client-side filed-request API -------------------------------------------

def file_request(root: str, spec: dict) -> str:
    """The client side of the filed-request API: drop a job spec into
    ``<root>/requests/`` atomically for a (possibly not yet running)
    daemon to ingest.  Returns the job id."""
    from splatt_tpu_torch.utils.durable import publish_json

    jid = _job_id(spec)
    spec = dict(spec, id=jid)
    reqs = os.path.join(os.path.abspath(root), "requests")
    os.makedirs(reqs, exist_ok=True)
    publish_json(os.path.join(reqs, f"{jid}.json"), spec)
    return jid


def read_result(root: str, jid: str) -> Optional[dict]:
    """The published result record of `jid`, or None while the job is not
    terminal (or unknown)."""
    path = os.path.join(os.path.abspath(root), "results", f"{jid}.json")
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except ValueError:
        return None  # a hand-damaged file reads as absent


def read_status(root: str, jid: str) -> dict:
    """The journal's view of a job (client side, no daemon needed): the
    last record wins, and the result rides along once the job is
    terminal."""
    journal = Journal(os.path.join(os.path.abspath(root),
                                   "journal.jsonl"))
    recs, _ = journal.replay()
    state = None
    status = None
    for rec in recs:
        if rec.get("job") != jid:
            continue
        state = rec.get("rec")
        if state in (DONE, FAILED):
            status = rec.get("status")
        elif state == REJECTED:
            status = "rejected"
        else:
            status = None  # re-accepted after a rejection: not terminal
    out = {"job": jid, "state": state, "status": status}
    if state in TERMINAL:
        res = read_result(root, jid)
        if res is not None:
            out["result"] = res
    # a spool file not yet ingested counts as "filed"
    if state is None and os.path.exists(
            os.path.join(os.path.abspath(root), "requests",
                         f"{jid}.json")):
        out["state"] = "filed"
    return out
