"""The fleet observability plane: metrics aggregation, SLOs, ``status``
(≙ splatt_tpu/fleetobs.py).

It reads nothing but the shared spool, so it runs the same inside a serve
replica, in the ``status``/``top`` verbs and in the fleet soak's
post-mortem.

Fleet metrics aggregation
    :func:`aggregate` scans the heartbeat leases
    ``<root>/fleet/replicas/*.json`` and each replica's metrics snapshot
    and merges them into one sample map: counters are summed (a dead
    replica's counted work still happened), gauges become per-``replica``
    series (a dead replica's gauges are dropped: a dead queue has no
    depth), histograms are bucket-merged, and a synthesized
    ``splatt_fleet_replicas{state=alive|dead}`` gauge carries the liveness
    census.  :func:`write_fleet_metrics` publishes the merged exposition
    (``<root>/fleet/metrics.prom``).  :func:`parse_prometheus` reads a
    snapshot back; the text is the JAX package's, so either package
    aggregates the other's replicas.

SLO layer with burn-rate alerts
    :func:`slo_specs` declares the serving SLOs: queue-wait p95
    (``splatt_serve_queue_wait_seconds``), job-wall p95
    (``splatt_job_seconds``), availability (1 − the shed and
    quota-rejected fraction) and predict-latency p99
    (``splatt_predict_latency_seconds``), with objectives from the
    ``SPLATT_SLO_*`` knobs.  :class:`SloEvaluator` evaluates multi-window
    error-budget burn rates over successive samples: when the budget burns
    at ≥ ``SPLATT_SLO_BURN`` × on both the short window
    (``SPLATT_SLO_WINDOW_S``) and the long one (``SPLATT_SLO_LONG_WINDOWS``
    × that), it emits an ``slo_burn`` run-report event, which counts into
    ``splatt_slo_burn_total``.  Each fleet replica persists its verdicts to
    ``<root>/fleet/slo-<replica>.json``.

Fleet status
    :func:`fleet_status` is the dashboard's data: replicas with their
    lease freshness, queue depths, per-tenant usage, running jobs with
    their age, recent terminal jobs, the fleet's adoption and lease-expiry
    totals and the latest SLO verdicts; :func:`format_status` renders it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

from splatt_tpu_torch import trace


#: the label key a merged gauge gains to stay per-replica
_REPLICA_LABEL = "replica"

#: metric names the aggregator synthesizes itself — per-replica copies
#: in the input snapshots are dropped so the census cannot double-count
_SYNTHESIZED = ("splatt_fleet_replicas",)

_SAMPLE_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_labels(raw: Optional[str]) -> Tuple[Tuple[str, str], ...]:
    if not raw:
        return ()
    out = []
    for k, v in _LABEL_RE.findall(raw):
        out.append((k, v.replace('\\"', '"').replace("\\\\", "\\")))
    return tuple(sorted(out))


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple], object]:
    """Parse Prometheus text exposition (the :func:`trace.render_samples`
    dialect) back into the raw sample map: ``(name, label-key) ->
    float`` for counters/gauges, a ``{buckets, sum, count}`` state dict
    for histograms (bucket bounds must match :data:`trace.HIST_BUCKETS`
    — the whole fleet shares one registry, so a mismatched series is
    skipped rather than mis-merged).  Unparseable lines are skipped:
    the aggregator must survive a foreign or hand-damaged snapshot."""
    out: Dict[Tuple[str, Tuple], object] = {}
    hists: Dict[Tuple[str, Tuple], dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels = m.group("name"), _parse_labels(m.group("labels"))
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        if name.endswith("_bucket"):
            base = name[:-len("_bucket")]
            le = dict(labels).get("le")
            lk = tuple((k, v) for k, v in labels if k != "le")
            h = hists.setdefault((base, lk), {"le": {}, "sum": 0.0,
                                              "count": 0})
            h["le"][le] = value
        elif name.endswith("_sum") and self_declared_hist(name[:-4]):
            hists.setdefault((name[:-4], labels),
                             {"le": {}, "sum": 0.0, "count": 0}
                             )["sum"] = value
        elif name.endswith("_count") and self_declared_hist(name[:-6]):
            hists.setdefault((name[:-6], labels),
                             {"le": {}, "sum": 0.0, "count": 0}
                             )["count"] = int(value)
        else:
            out[(name, labels)] = value
    # cumulative le series -> per-bucket counts in HIST_BUCKETS order
    bounds = [str(b) for b in trace.HIST_BUCKETS] + ["+Inf"]
    for key, h in hists.items():
        if not set(h["le"]) <= set(bounds):
            continue  # foreign bucket layout: cannot merge honestly
        cum = [h["le"].get(b, None) for b in bounds]
        buckets, prev = [], 0.0
        for c in cum:
            c = prev if c is None else c
            buckets.append(int(c - prev))
            prev = c
        out[key] = {"buckets": buckets, "sum": float(h["sum"]),
                    "count": int(h["count"])}
    return out


def self_declared_hist(name: str) -> bool:
    spec = trace.METRICS.get(name)
    return bool(spec and spec[0] == "histogram")


def _metric_type(name: str) -> Optional[str]:
    spec = trace.METRICS.get(name)
    return spec[0] if spec else None


# -- fleet aggregation -------------------------------------------------------

@dataclasses.dataclass
class FleetAggregate:
    """One aggregation pass over the shared spool."""

    root: str
    ts: float
    #: replica id -> {alive, pid, age_s, expires_in_s, active, regimes,
    #: metrics_path, snapshot (bool: a parseable snapshot was merged)}
    replicas: Dict[str, dict]
    #: the merged sample map (render with trace.render_samples)
    samples: Dict[Tuple[str, Tuple], object]

    def counter(self, name: str, **labels) -> float:
        """Sum of a merged counter across label keys matching `labels`
        (a convenience for soak audits and status summaries)."""
        want = set((k, str(v)) for k, v in labels.items())
        return sum(float(v) for (n, lk), v in self.samples.items()
                   if n == name and want <= set(lk)
                   and isinstance(v, (int, float)))


def _replica_metrics_path(root: str, rid: str, rec: dict) -> str:
    return str(rec.get("metrics")
               or os.path.join(root, "fleet", "metrics", f"{rid}.prom"))


def aggregate(root: str, now: Optional[float] = None) -> FleetAggregate:
    """One fleet aggregation pass: census the heartbeat leases, merge
    every replica's snapshot per the module-docstring semantics, and
    synthesize the ``splatt_fleet_replicas`` liveness gauge into the
    MERGED samples only — this is a side-effect-free reader (the
    status CLI and soak post-mortems call it); a serve replica mirrors
    the census into its own registry in ``Server._slo_tick``, the one
    caller that is a fleet member."""
    root = os.path.abspath(root)
    now = time.time() if now is None else now
    replicas: Dict[str, dict] = {}
    rep_dir = os.path.join(root, "fleet", "replicas")
    try:
        names = sorted(os.listdir(rep_dir))
    except OSError:
        names = []
    for fname in names:
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(rep_dir, fname)) as f:
                rec = json.load(f)
            rid = str(rec["replica"])
            expires = float(rec.get("expires", 0.0))
        except (OSError, ValueError, KeyError, TypeError):
            continue  # torn/foreign heartbeat: not a replica
        replicas[rid] = {
            "alive": expires > now, "pid": rec.get("pid"),
            "age_s": round(max(now - float(rec.get("ts", now)), 0.0), 3),
            "expires_in_s": round(expires - now, 3),
            "active": int(rec.get("active", 0)),
            "regimes": list(rec.get("regimes") or []),
            "metrics_path": _replica_metrics_path(root, rid, rec),
            "snapshot": False, "heartbeat": True,
        }
    # snapshots whose owner has NO heartbeat file (a gracefully
    # retired replica deletes its lease on exit): the counted work
    # still happened, so the counters merge like a dead replica's —
    # gauges dropped, no census entry (the liveness gauge reads the
    # heartbeat census only)
    mdir = os.path.join(root, "fleet", "metrics")
    try:
        for fname in sorted(os.listdir(mdir)):
            if not fname.endswith(".prom"):
                continue
            rid = fname[:-len(".prom")]
            if rid not in replicas:
                replicas[rid] = {
                    "alive": False, "pid": None, "age_s": None,
                    "expires_in_s": None, "active": 0, "regimes": [],
                    "metrics_path": os.path.join(mdir, fname),
                    "snapshot": False, "heartbeat": False,
                }
    except OSError:
        pass
    merged: Dict[Tuple[str, Tuple], object] = {}
    for rid, info in sorted(replicas.items()):
        try:
            with open(info["metrics_path"]) as f:
                samples = parse_prometheus(f.read())
        except OSError:
            continue  # no snapshot yet (or never configured)
        info["snapshot"] = True
        for (name, lk), v in samples.items():
            if name in _SYNTHESIZED:
                continue
            typ = _metric_type(name)
            if typ == "counter" and isinstance(v, (int, float)):
                key = (name, lk)
                merged[key] = float(merged.get(key, 0.0)) + float(v)
            elif typ == "gauge" and isinstance(v, (int, float)):
                if not info["alive"]:
                    continue  # a dead replica has no current readings
                key = (name, tuple(sorted(
                    dict(lk, **{_REPLICA_LABEL: rid}).items())))
                merged[key] = float(v)
            elif typ == "histogram" and isinstance(v, dict):
                key = (name, lk)
                h = merged.get(key)
                if not isinstance(h, dict):
                    h = {"buckets": [0] * (len(trace.HIST_BUCKETS) + 1),
                         "sum": 0.0, "count": 0}
                    merged[key] = h
                if len(v.get("buckets") or []) == len(h["buckets"]):
                    h["buckets"] = [a + b for a, b in
                                    zip(h["buckets"], v["buckets"])]
                    h["sum"] += float(v.get("sum", 0.0))
                    h["count"] += int(v.get("count", 0))
    alive = sum(1 for i in replicas.values() if i["alive"])
    dead = sum(1 for i in replicas.values()
               if i["heartbeat"] and not i["alive"])
    for state, n in (("alive", alive), ("dead", dead)):
        merged[("splatt_fleet_replicas",
                (("state", state),))] = float(n)
    # deliberately NO local-registry writes here: aggregate() is a
    # READER shared by the status CLI, soak post-mortems and library
    # callers — only a serve replica (Server._slo_tick) mirrors the
    # census into its own registry, because only a fleet member should
    # publish a fleet census
    return FleetAggregate(root=root, ts=now, replicas=replicas,
                          samples=merged)


def fleet_metrics_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), "fleet", "metrics.prom")


def write_fleet_metrics(agg: FleetAggregate,
                        path: Optional[str] = None) -> str:
    """Publish the merged exposition atomically (tmp + rename — the
    same torn-file guarantee every snapshot has).  Default target:
    ``<root>/fleet/metrics.prom``."""
    from splatt_tpu_torch.utils.durable import publish_text

    path = path or fleet_metrics_path(agg.root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    publish_text(path, trace.render_samples(agg.samples))
    return path



@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declared SLO: a good/total extraction over the merged
    samples plus an objective (the compliance target whose complement
    is the error budget)."""

    name: str
    doc: str
    kind: str        # "latency" (histogram-threshold) | "availability"
    metric: str      # the histogram, or "" for availability
    threshold_env: str = ""   # latency: the SPLATT_SLO_* seconds knob
    objective: float = 0.95   # latency default: a p95 objective


def slo_specs() -> List[SloSpec]:
    """The declared SLOs.  Objectives resolve from the ``SPLATT_SLO_*``
    knobs at evaluation time, so operators tighten them without code.
    The names and docs are the JAX package's."""
    from splatt_tpu_torch.utils.env import read_env_float

    return [
        SloSpec("queue_wait_p95",
                "95% of jobs start within SPLATT_SLO_QUEUE_WAIT_P95_S "
                "seconds of acceptance",
                kind="latency", metric="splatt_serve_queue_wait_seconds",
                threshold_env="SPLATT_SLO_QUEUE_WAIT_P95_S"),
        SloSpec("job_wall_p95",
                "95% of terminal jobs finish within "
                "SPLATT_SLO_JOB_WALL_P95_S wall seconds",
                kind="latency", metric="splatt_job_seconds",
                threshold_env="SPLATT_SLO_JOB_WALL_P95_S"),
        SloSpec("availability",
                "SPLATT_SLO_AVAILABILITY of offered submissions are "
                "accepted (not queue_full/quota shed)",
                kind="availability", metric="",
                objective=float(read_env_float("SPLATT_SLO_AVAILABILITY"))),
        SloSpec("predict_latency_p99",
                "99% of predicts are served within "
                "SPLATT_SLO_PREDICT_P99_S seconds of acceptance "
                "(the low-latency lane, docs/predict.md)",
                kind="latency", metric="splatt_predict_latency_seconds",
                threshold_env="SPLATT_SLO_PREDICT_P99_S",
                objective=0.99),
    ]


def _hist_good_total(samples: Dict, metric: str,
                     threshold_s: float) -> Tuple[int, int]:
    """(observations ≤ threshold, all observations) summed across a
    histogram's label keys.  The threshold rounds UP to the nearest
    declared bucket bound (documented; exact per-observation
    thresholds would need raw samples the exposition doesn't carry)."""
    idx = len(trace.HIST_BUCKETS)  # +Inf: a vacuous threshold
    for j, le in enumerate(trace.HIST_BUCKETS):
        if threshold_s <= le:
            idx = j
            break
    good = total = 0
    for (name, _lk), v in samples.items():
        if name == metric and isinstance(v, dict):
            good += sum(v["buckets"][:idx + 1])
            total += int(v.get("count", 0))
    return good, total


def _availability_good_total(samples: Dict) -> Tuple[int, int]:
    def kind_total(kind: str) -> float:
        return sum(float(v) for (n, lk), v in samples.items()
                   if n == "splatt_events_total"
                   and dict(lk).get("kind") == kind
                   and isinstance(v, (int, float)))

    shed = kind_total("queue_full") + kind_total("quota_rejected")
    offered = shed + kind_total("job_accepted")
    return int(offered - shed), int(offered)


class SloEvaluator:
    """Multi-window error-budget burn rates over successive sample
    aggregates.  One evaluator per process (serve drives it on the
    metrics cadence); it keeps only (timestamp, good/total) tuples —
    no raw samples — so its memory is bounded by the long window.

    Burn rate = (bad fraction over the window) / (1 − objective).  An
    alert (``slo_burn``) requires the burn at ≥ the threshold on BOTH
    the short and the long window: the short window alone would page
    on every blip, the long alone would page for an hour after a
    recovered spike — the standard multi-window gating, scaled by the
    ``SPLATT_SLO_*`` knobs.  The first evaluation is a baseline (no
    deltas yet, never burning); zero traffic in a window burns
    nothing.  Counter resets (a restarted replica shrinking a merged
    sum) clamp to zero instead of burning negative."""

    def __init__(self, window_s: Optional[float] = None,
                 long_windows: Optional[int] = None,
                 burn: Optional[float] = None,
                 replica: Optional[str] = None):
        from splatt_tpu_torch.utils.env import read_env_float, read_env_int

        self.window_s = float(window_s if window_s is not None
                              else read_env_float("SPLATT_SLO_WINDOW_S"))
        self.long_windows = max(int(
            long_windows if long_windows is not None
            else read_env_int("SPLATT_SLO_LONG_WINDOWS")), 1)
        self.burn = float(burn if burn is not None
                          else read_env_float("SPLATT_SLO_BURN"))
        self.replica = replica
        #: [(ts, {slo: (good, total)})] oldest-first
        self._history: List[Tuple[float, Dict[str, Tuple[int, int]]]] = []
        self.last: Optional[dict] = None

    @property
    def long_s(self) -> float:
        return self.window_s * self.long_windows

    def _totals(self, samples: Dict) -> Dict[str, Tuple[int, int]]:
        from splatt_tpu_torch.utils.env import read_env_float

        out: Dict[str, Tuple[int, int]] = {}
        for spec in slo_specs():
            if spec.kind == "latency":
                thr = float(read_env_float(spec.threshold_env))
                out[spec.name] = _hist_good_total(samples, spec.metric,
                                                  thr)
            else:
                out[spec.name] = _availability_good_total(samples)
        return out

    @staticmethod
    def _delta(now_gt: Tuple[int, int],
               base_gt: Tuple[int, int]) -> Tuple[int, int]:
        bad = max((now_gt[1] - now_gt[0]) - (base_gt[1] - base_gt[0]), 0)
        total = max(now_gt[1] - base_gt[1], 0)
        return bad, total

    def _base(self, now: float, horizon_s: float
              ) -> Optional[Dict[str, Tuple[int, int]]]:
        """The newest history entry at/older than ``now - horizon``
        (the window base); the oldest entry when history is still
        shorter than the window (a partial window is honest — the
        alternative is blindness until the window fills)."""
        if not self._history:
            return None
        base = self._history[0][1]
        for ts, totals in self._history:
            if ts <= now - horizon_s:
                base = totals
            else:
                break
        return base

    def evaluate(self, samples: Dict,
                 now: Optional[float] = None) -> dict:
        """One evaluation pass; emits ``slo_burn`` events for every
        SLO burning on both windows and returns (and remembers, as
        ``last``) the per-SLO verdicts."""
        from splatt_tpu_torch import resilience

        now = time.time() if now is None else now
        totals = self._totals(samples)
        baseline = not self._history
        short_base = self._base(now, self.window_s)
        long_base = self._base(now, self.long_s)
        self._history.append((now, totals))
        cutoff = now - self.long_s - self.window_s
        while len(self._history) > 1 and self._history[0][0] < cutoff:
            self._history.pop(0)
        slos: Dict[str, dict] = {}
        for spec in slo_specs():
            gt = totals[spec.name]
            entry = {"doc": spec.doc, "objective": spec.objective,
                     "good": gt[0], "total": gt[1],
                     "burn_short": 0.0, "burn_long": 0.0,
                     "burning": False, "baseline": baseline}
            if not baseline:
                budget = max(1.0 - spec.objective, 1e-9)
                burns = []
                for base in (short_base, long_base):
                    bad, total = self._delta(gt, base[spec.name])
                    frac = (bad / total) if total > 0 else 0.0
                    burns.append(frac / budget)
                entry["burn_short"], entry["burn_long"] = (
                    round(burns[0], 3), round(burns[1], 3))
                _, total_short = self._delta(gt, short_base[spec.name])
                entry["burning"] = bool(
                    total_short > 0 and burns[0] >= self.burn
                    and burns[1] >= self.burn)
                if entry["burning"]:
                    # replica rides the event → a replica label on
                    # splatt_slo_burn_total, so the merged counter
                    # stays per-emitter: every fleet member evaluates
                    # the same merged samples, and an unlabelled sum
                    # would scale one incident by fleet size.  (It
                    # counts burning EVALUATIONS — alert-ticks — per
                    # replica, not deduplicated incidents; documented.)
                    resilience.run_report().add(
                        "slo_burn", slo=spec.name,
                        replica=self.replica,
                        burn_short=entry["burn_short"],
                        burn_long=entry["burn_long"],
                        window_s=self.window_s,
                        objective=spec.objective)
            slos[spec.name] = entry
        self.last = {"ts": now, "window_s": self.window_s,
                     "long_windows": self.long_windows,
                     "burn_threshold": self.burn,
                     "replica": self.replica, "slos": slos}
        return self.last

    def write_state(self, path: str) -> None:
        """Persist the latest verdicts atomically (the per-replica
        ``fleet/slo-<replica>.json`` files `splatt status` merges) —
        best-effort observability, so failures degrade classified."""
        from splatt_tpu_torch import resilience
        from splatt_tpu_torch.utils.durable import publish_json

        if self.last is None:
            return
        try:
            publish_json(path, self.last)
        except Exception as e:
            cls = resilience.classify_failure(e)
            resilience.run_report().add(
                "metrics_snapshot", path=str(path), ok=False,
                failure_class=cls.value,
                error=resilience.failure_message(e)[:200])


def slo_state_path(root: str, replica: str) -> str:
    return os.path.join(os.path.abspath(root), "fleet",
                        f"slo-{replica}.json")


def read_slo_states(root: str) -> Dict[str, dict]:
    """Every replica's persisted SLO verdicts, freshest included as
    ``"latest"`` (status/top's SLO summary source)."""
    import glob as _glob

    out: Dict[str, dict] = {}
    for path in sorted(_glob.glob(os.path.join(
            os.path.abspath(root), "fleet", "slo-*.json"))):
        try:
            with open(path) as f:
                rec = json.load(f)
            if isinstance(rec, dict) and rec.get("slos"):
                out[str(rec.get("replica")
                        or os.path.basename(path)[4:-5])] = rec
        except (OSError, ValueError):
            continue
    if out:
        out["latest"] = max(out.values(),
                            key=lambda r: float(r.get("ts", 0)))
    return out


# -- fleet status (`splatt top` / `splatt status`) ---------------------------

def fleet_status(root: str, now: Optional[float] = None,
                 jobs_n: Optional[int] = None,
                 agg: Optional[FleetAggregate] = None) -> dict:
    """The dashboard's data, read ONLY from the shared spool — no
    daemon RPC, so it works on a live fleet, a draining one, and a
    post-mortem alike: journal-derived job states (queue depths,
    per-tenant usage, running jobs with age, recent terminal jobs),
    the heartbeat census, and the latest SLO verdicts.  Pass a fresh
    `agg` to reuse one aggregation pass (the watch loop and
    ``--metrics-out`` would otherwise scan the spool twice a tick)."""
    from splatt_tpu_torch import serve
    from splatt_tpu_torch.utils.env import read_env_int

    root = os.path.abspath(root)
    now = time.time() if now is None else now
    jobs_n = int(jobs_n if jobs_n is not None
                 else read_env_int("SPLATT_STATUS_JOBS"))
    if agg is None:
        agg = aggregate(root, now=now)

    jobs: Dict[str, dict] = {}
    recs, torn = serve.Journal(
        os.path.join(root, "journal.jsonl")).replay()
    for rec in recs:
        jid, kind = rec.get("job"), rec.get("rec")
        if not jid or not kind:
            continue
        j = jobs.setdefault(jid, {"state": None, "status": None,
                                  "tenant": None, "priority": None,
                                  "replica": None, "t_accepted": None,
                                  "t_started": None, "t_last": None,
                                  "adopted_from": None, "kind": "cpd",
                                  "base": None, "batch": None})
        ts = rec.get("ts")
        j["state"], j["t_last"] = kind, ts
        if rec.get("replica"):
            j["replica"] = rec["replica"]
        if kind == serve.ACCEPTED:
            j["t_accepted"] = ts
            spec = rec.get("spec") or {}
            j["tenant"] = str(spec.get("tenant") or "default")
            j["priority"] = str(spec.get("priority") or "normal")
            # model-store lineage: update jobs name
            # their base model; batched starts name their leader —
            # what `splatt status --json` audits
            j["kind"] = str(spec.get("kind") or "cpd")
            j["base"] = spec.get("base")
        elif kind == serve.STARTED:
            j["t_started"] = ts
            if rec.get("batch"):
                j["batch"] = rec["batch"]
        elif kind == serve.ADOPTED:
            j["adopted_from"] = rec.get("from_replica")
        if kind in (serve.DONE, serve.FAILED):
            j["status"] = rec.get("status")
        elif kind == serve.REJECTED:
            j["status"] = "rejected"

    counts: Dict[str, int] = {}
    tenants: Dict[str, int] = {}
    running: List[dict] = []
    terminal: List[dict] = []
    for jid, j in jobs.items():
        counts[j["state"]] = counts.get(j["state"], 0) + 1
        if j["state"] in serve.TERMINAL:
            terminal.append(dict(job=jid, status=j["status"],
                                 replica=j["replica"],
                                 t=j["t_last"],
                                 adopted_from=j["adopted_from"],
                                 kind=j["kind"], base=j["base"],
                                 batch=j["batch"]))
            continue
        tenants[j["tenant"] or "default"] = \
            tenants.get(j["tenant"] or "default", 0) + 1
        if j["state"] == serve.STARTED:
            running.append(dict(
                job=jid, replica=j["replica"], tenant=j["tenant"],
                age_s=round(now - (j["t_started"] or now), 1),
                adopted_from=j["adopted_from"]))
    running.sort(key=lambda r: -r["age_s"])
    terminal.sort(key=lambda r: -(r["t"] or 0))
    pending = sum(counts.get(k, 0) for k in
                  (serve.ACCEPTED, serve.RESUMED, serve.ADOPTED,
                   serve.INTERRUPTED))
    return {
        "root": root, "ts": now,
        "replicas": agg.replicas,
        "alive": sum(1 for r in agg.replicas.values() if r["alive"]),
        "dead": sum(1 for r in agg.replicas.values()
                    if r["heartbeat"] and not r["alive"]),
        "jobs": {jid: j["state"] for jid, j in jobs.items()},
        "counts": counts,
        "pending": pending,
        "running": running,
        "tenants": tenants,
        "recent": terminal[:jobs_n],
        "journal_torn": torn,
        "fleet_totals": {
            "adoptions": agg.counter("splatt_fleet_adoptions_total"),
            "lease_expired": agg.counter(
                "splatt_fleet_lease_expired_total"),
            "slo_burns": agg.counter("splatt_slo_burn_total"),
        },
        "slo": read_slo_states(root),
    }


def format_status(st: dict) -> List[str]:
    """`splatt top`'s textual dashboard, one aggregation pass."""
    when = time.strftime("%H:%M:%S", time.localtime(st["ts"]))
    lines = [f"splatt fleet @ {st['root']}  [{when}]  "
             f"replicas: {st['alive']} alive / {st['dead']} dead  "
             f"pending: {st['pending']}"]
    for rid, r in sorted(st["replicas"].items()):
        if not r.get("heartbeat"):
            lines.append(f"  gone  {rid:<16s} (retired; counters "
                         f"retained)")
            continue
        state = ("ALIVE" if r["alive"] else "dead ")
        regimes = (f" warm={len(r['regimes'])}" if r["regimes"] else "")
        lines.append(
            f"  {state} {rid:<16s} lease "
            f"{'+' if r['expires_in_s'] >= 0 else ''}"
            f"{r['expires_in_s']:.1f}s  active={r['active']}"
            f"{regimes}"
            + ("" if r["snapshot"] else "  (no metrics snapshot)"))
    if st["tenants"]:
        lines.append("tenants (non-terminal): " + ", ".join(
            f"{t}={n}" for t, n in sorted(st["tenants"].items())))
    for r in st["running"]:
        ad = (f" adopted_from={r['adopted_from']}"
              if r.get("adopted_from") else "")
        lines.append(f"  RUN  {r['job']:<20s} on {r['replica'] or '?'} "
                     f"age {r['age_s']:.1f}s tenant={r['tenant']}{ad}")
    if st["recent"]:
        lines.append(f"recent terminal ({len(st['recent'])}):")
        for r in st["recent"]:
            ad = (f" adopted_from={r['adopted_from']}"
                  if r.get("adopted_from") else "")
            if r.get("kind") == "update":
                ad += f" update_of={r.get('base')}"
            if r.get("batch"):
                ad += f" batch={r['batch']}"
            lines.append(f"  {r['status'] or '?':<10s} {r['job']:<20s} "
                         f"on {r['replica'] or '?'}{ad}")
    ft = st["fleet_totals"]
    lines.append(f"fleet: adoptions={ft['adoptions']:g} "
                 f"lease_expired={ft['lease_expired']:g} "
                 f"slo_burns={ft['slo_burns']:g}"
                 + (f"  journal_torn={st['journal_torn']}"
                    if st["journal_torn"] else ""))
    latest = (st.get("slo") or {}).get("latest")
    if latest:
        for name, s in sorted(latest["slos"].items()):
            flag = ("BURNING" if s.get("burning")
                    else "baseline" if s.get("baseline") else "ok")
            lines.append(
                f"  slo {name:<16s} {flag:<8s} "
                f"burn {s.get('burn_short', 0):g}x/"
                f"{s.get('burn_long', 0):g}x  "
                f"good {s.get('good', 0)}/{s.get('total', 0)}")
    else:
        lines.append("  slo: (no evaluations persisted yet)")
    return lines
