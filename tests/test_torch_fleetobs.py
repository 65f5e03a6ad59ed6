"""The port's fleet observability plane (``splatt_tpu_torch/fleetobs.py``,
the ``status`` and ``top`` verbs) against the JAX package's, on the CPU.

A spool is written by one package's own writers (journal appends,
heartbeats under a virtual clock, Prometheus snapshots of its metrics
registry, persisted SLO verdicts): three replicas, one alive, one dead and
one retired with only its snapshot left.  Over it ``parse_prometheus``,
``aggregate``, ``fleet_status`` and ``format_status`` of the port give the
JAX package's output, whichever package wrote the spool; the merged
expositions parse to the same samples (their ``# HELP`` texts are each
package's own).  A port fleet replica's metrics tick publishes the merged
exposition and its SLO verdicts, and the verbs print what
``fleet_status`` returns.
"""

import json
import os
import time

import pytest

from splatt_tpu import fleet as jfleet
from splatt_tpu import fleetobs as jfleetobs
from splatt_tpu import serve as jserve
from splatt_tpu import trace as jtrace
from splatt_tpu_torch import cli, fleet, fleetobs, serve, trace
from tests.torch_fixtures import private_tune_cache  # noqa: F401

PACKAGES = {"port": (serve, fleet, fleetobs, trace),
            "jax": (jserve, jfleet, jfleetobs, jtrace)}


@pytest.fixture(autouse=True)
def _clean_metrics():
    for mod in (trace, jtrace):
        mod.reset_metrics()
    yield
    for mod in (trace, jtrace):
        mod.reset_metrics()


def _record_metrics(tr, rid: str, adopted: bool):
    """One replica's registry: counters, a gauge and histograms, all
    declared by both packages."""
    tr.reset_metrics()
    tr.metric_inc("splatt_serve_jobs_total", status="converged")
    tr.metric_inc("splatt_serve_jobs_total", 2.0, status="failed")
    tr.metric_inc("splatt_events_total", 3.0, kind="job_accepted")
    tr.metric_inc("splatt_events_total", kind="queue_full")
    if adopted:
        tr.metric_inc("splatt_fleet_adoptions_total")
        tr.metric_inc("splatt_fleet_lease_expired_total", role="adopter")
    tr.metric_set("splatt_serve_queue_depth", 4.0 if adopted else 1.0)
    tr.metric_set("splatt_fleet_replicas", 2.0, state="alive")
    for v in (0.02, 0.3, 2.0 if adopted else 40.0):
        tr.metric_observe("splatt_serve_queue_wait_seconds", v)
        tr.metric_observe("splatt_job_seconds", v * 3)
    tr.metric_inc("splatt_slo_burn_total", slo="queue_wait_p95",
                  replica=rid)


def _write_spool(name: str, root: str, now: float) -> None:
    """A three-replica spool written by package `name`'s own writers."""
    smod, fmod, omod, tr = PACKAGES[name]
    j = smod.Journal(os.path.join(root, "journal.jsonl"))
    spec = {"rank": 3, "synthetic": {"dims": [9, 8, 7], "nnz": 100}}
    recs = [
        dict(rec="accepted", job="a1", replica="r0",
             spec=dict(spec, id="a1", tenant="acme")),
        dict(rec="started", job="a1", replica="r0"),
        dict(rec="done", job="a1", replica="r0", status="converged",
             model="a1", model_gen=1),
        dict(rec="accepted", job="b1", replica="r1",
             spec=dict(spec, id="b1", tenant="beta", priority="high")),
        dict(rec="started", job="b1", replica="r1"),
        dict(rec="adopted", job="b1", replica="r0", from_replica="r1"),
        dict(rec="started", job="b1", replica="r0"),
        dict(rec="accepted", job="u1", replica="r0",
             spec={"id": "u1", "kind": "update", "base": "a1",
                   "tenant": "acme", "delta": {"dims": [9, 8, 7]}}),
        dict(rec="started", job="u1", replica="r0", batch="u1"),
        dict(rec="done", job="u1", replica="r0", status="converged"),
        dict(rec="accepted", job="c1", replica="r1",
             spec=dict(spec, id="c1", tenant="coyote")),
        dict(rec="rejected", job="q1", replica="r1", reason="quota:acme"),
        dict(rec="accepted", job="f1", replica="r0",
             spec=dict(spec, id="f1")),
        dict(rec="started", job="f1", replica="r0"),
        dict(rec="failed", job="f1", replica="r0", status="failed"),
    ]
    for rec in recs:
        j.append(rec)
    mdir = os.path.join(root, "fleet", "metrics")
    os.makedirs(mdir, exist_ok=True)
    for rid, t_beat, adopted in (("r0", now - 1.0, True),
                                 ("r1", now - 30.0, False)):
        m = fmod.FleetMember(root, replica=rid, lease_s=10.0,
                             clock=lambda t=t_beat: t)
        m.metrics_path = os.path.join(mdir, f"{rid}.prom")
        m.add_regime(f"regime-{rid}")
        m.beat()
        _record_metrics(tr, rid, adopted)
        tr.write_metrics(m.metrics_path)
    # r2 retired: a snapshot, no heartbeat
    _record_metrics(tr, "r2", False)
    tr.write_metrics(os.path.join(mdir, "r2.prom"))
    tr.reset_metrics()
    ev = omod.SloEvaluator(window_s=3.0, long_windows=2, burn=1.5,
                           replica="r0")
    agg = omod.aggregate(root, now=now)
    ev.evaluate(agg.samples, now=now - 5.0)
    ev.evaluate(agg.samples, now=now)
    ev.write_state(omod.slo_state_path(root, "r0"))


@pytest.fixture(scope="module", params=["jax", "port"])
def spool(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"spool_{request.param}"))
    now = time.time()
    for mod in (trace, jtrace):
        mod.reset_metrics()
    _write_spool(request.param, root, now)
    return dict(root=root, now=now, writer=request.param)


def test_parse_prometheus_reads_each_snapshot_as_the_jax_package(spool):
    mdir = os.path.join(spool["root"], "fleet", "metrics")
    for name in sorted(os.listdir(mdir)):
        with open(os.path.join(mdir, name)) as f:
            text = f.read()
        got = fleetobs.parse_prometheus(text)
        assert got == jfleetobs.parse_prometheus(text)
        assert any(isinstance(v, dict) for v in got.values())


def test_aggregate_is_the_jax_packages(spool):
    got = fleetobs.aggregate(spool["root"], now=spool["now"])
    want = jfleetobs.aggregate(spool["root"], now=spool["now"])
    assert got.replicas == want.replicas
    assert got.samples == want.samples
    assert {rid: r["alive"] for rid, r in got.replicas.items()} == {
        "r0": True, "r1": False, "r2": False}
    assert got.samples[("splatt_fleet_replicas", (("state", "alive"),))] \
        == 1.0
    assert got.samples[("splatt_fleet_replicas", (("state", "dead"),))] \
        == 1.0
    # counters summed over all three, gauges kept per live replica only
    assert got.counter("splatt_serve_jobs_total", status="failed") == 6.0
    assert got.counter("splatt_fleet_adoptions_total") == 1.0
    depth = {lk: v for (n, lk), v in got.samples.items()
             if n == "splatt_serve_queue_depth"}
    assert depth == {(("replica", "r0"),): 4.0}


def test_merged_expositions_parse_to_the_same_samples(spool, tmp_path):
    agg = fleetobs.aggregate(spool["root"], now=spool["now"])
    jagg = jfleetobs.aggregate(spool["root"], now=spool["now"])
    p = fleetobs.write_fleet_metrics(agg, str(tmp_path / "port.prom"))
    q = jfleetobs.write_fleet_metrics(jagg, str(tmp_path / "jax.prom"))
    with open(p) as f, open(q) as g:
        got, want = f.read(), g.read()
    assert fleetobs.parse_prometheus(got) == jfleetobs.parse_prometheus(want)
    # the exposition rounds a histogram's sum to 6 decimals
    assert set(fleetobs.parse_prometheus(got)) == set(agg.samples)
    assert fleetobs.fleet_metrics_path(spool["root"]) == \
        jfleetobs.fleet_metrics_path(spool["root"])


def test_fleet_status_and_format_status_are_the_jax_packages(spool):
    now = spool["now"]
    got = fleetobs.fleet_status(spool["root"], now=now, jobs_n=8)
    want = jfleetobs.fleet_status(spool["root"], now=now, jobs_n=8)
    assert got == want
    assert got["jobs"] == {"a1": "done", "b1": "started", "u1": "done",
                           "c1": "accepted", "q1": "rejected",
                           "f1": "failed"}
    assert got["fleet_totals"]["adoptions"] == 1.0
    assert [r["job"] for r in got["running"]] == ["b1"]
    assert got["running"][0]["adopted_from"] == "r1"
    assert got["slo"]["latest"]["replica"] == "r0"
    assert fleetobs.format_status(got) == jfleetobs.format_status(want)
    assert fleetobs.read_slo_states(spool["root"]) == \
        jfleetobs.read_slo_states(spool["root"])


def test_a_fleet_replicas_tick_publishes_the_merged_view(tmp_path):
    root = str(tmp_path)
    srv = serve.Server(root, workers=1, fleet=True, replica="ra",
                       lease_s=5.0, device="cpu")
    try:
        srv.write_metrics_now()
    finally:
        srv.shutdown()
    merged = fleetobs.fleet_metrics_path(root)
    with open(merged) as f:
        samples = fleetobs.parse_prometheus(f.read())
    assert samples[("splatt_fleet_replicas", (("state", "alive"),))] == 1.0
    states = fleetobs.read_slo_states(root)
    assert states["ra"]["replica"] == "ra" and states["latest"]
    # the census is mirrored into the member's own registry
    assert trace.samples()[("splatt_fleet_replicas",
                            (("state", "alive"),))] == 1.0
    assert jfleetobs.read_slo_states(root) == states


def test_status_and_top_print_the_fleet_status(spool, capsys, tmp_path):
    assert cli.main(["status", spool["root"], "--json"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jfleetobs.fleet_status(spool["root"])
    assert got["jobs"] == want["jobs"] and got["counts"] == want["counts"]
    assert got["fleet_totals"] == want["fleet_totals"]
    out = str(tmp_path / "m.prom")
    assert cli.main(["top", spool["root"], "--once",
                     "--metrics-out", out]) == 0
    text = capsys.readouterr().out
    assert f"fleet metrics written to {out}" in text
    assert "splatt fleet @" in text and "ALIVE r0" in text
    assert "fleet: adoptions=1 lease_expired=1" in text
    assert os.path.exists(out)
