"""The SLO layer of a serve daemon's metrics tick
(≙ splatt_tpu/fleetobs.py:296-521).

:func:`slo_specs` declares the serving SLOs: queue-wait p95
(``splatt_serve_queue_wait_seconds``), job-wall p95
(``splatt_job_seconds``), availability (1 − the shed and quota-rejected
fraction) and predict-latency p99 (``splatt_predict_latency_seconds``),
with objectives from the ``SPLATT_SLO_*`` knobs.  :class:`SloEvaluator`
evaluates multi-window error-budget burn rates over successive samples of
the metrics registry (:func:`trace.samples`): when the budget burns at ≥
``SPLATT_SLO_BURN`` × on both the short window (``SPLATT_SLO_WINDOW_S``)
and the long one (``SPLATT_SLO_LONG_WINDOWS`` × that), it emits an
``slo_burn`` run-report event, which counts into
``splatt_slo_burn_total``.

The fleet half (merging replicas' snapshots, the fleet exposition,
``status``) is ROADMAP queue A item 15.2.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from splatt_tpu_torch import trace


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
