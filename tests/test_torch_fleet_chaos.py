"""The fleet soak of the port (``splatt_tpu_torch/chaos.py``
``run_fleet_chaos``) on the CPU, asserting what ``tests/test_chaos.py``
asserts of the JAX package's (≙ tests/test_chaos.py:281-337).

Two ``serve --fleet --device cpu`` replica subprocesses over one spool run
multi-tenant load; the replica running a slow-pinned job is SIGKILLed, a
replacement joins, and the soak audits the failover: every accepted job
terminal, the pinned job adopted from the victim with its warm plan-cache
hits, a single-owner lineage, tenant isolation, the kill visible in the
fleet aggregate and in the victim's flight ring, the predicts never
stale and the shredded model refused.  Every wait inside the soak is
bounded and every replica is stopped before its audit.  The CLI's other
soak modes exit 2, naming ROADMAP queue A item 15.3.
"""

import pytest

from splatt_tpu_torch import chaos, cli, resilience
from splatt_tpu_torch.utils import faults
from tests.torch_fixtures import private_tune_cache  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_state():
    resilience.reset_demotions()
    resilience.run_report().clear()
    faults.reset()
    yield
    resilience.reset_demotions()
    resilience.run_report().clear()
    faults.reset()


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    """One smoke soak, its spool under the test's temporary root."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", str(tmp_path_factory.mktemp("fleet_soak")))
        return chaos.run_fleet_chaos(smoke=True, device="cpu")


def test_fleet_chaos_smoke_kill_and_failover(soak):
    res = soak
    assert res.ok, res.violations
    assert res.verdict == "survived" and res.spool is None
    assert res.victim is not None        # the kill landed
    assert "fleet-1-pin" in res.adopted  # and forced an adoption
    assert set(res.jobs) == {"fleet-0-warm", "fleet-1-pin",
                             "fleet-2-nan", "fleet-3-clean",
                             "fleet-4-base", "fleet-5-up",
                             "fleet-b0", "fleet-b1", "fleet-b2",
                             "fleet-p0", "fleet-p1", "fleet-p2",
                             "fleet-p3"}
    assert all(s in ("converged", "degraded")
               for j, s in res.jobs.items() if not j.startswith("fleet-p"))
    assert all(s in ("served", "refused")
               for j, s in res.jobs.items() if j.startswith("fleet-p"))
    assert res.observability["predicts_served"] >= 1
    assert res.jobs["fleet-p3"] == "refused"
    assert "batched_jobs" in res.observability
    aff = res.affinity["fleet-1-pin"]
    assert aff["cache_hits"] and not aff["measured"]
    assert aff["adopted_from"] == res.victim
    ob = res.observability
    assert ob["adoptions"] >= 1 and ob["lease_expired"] >= 1
    assert ob["slo_burns"] >= 1
    assert ob["replicas_dead"] >= 1
    assert ob["flight_events"] >= 1
    rec = res.to_json()
    assert rec["verdict"] == "survived" and not rec["violations"]


def test_fleet_chaos_report_lines(soak):
    lines = chaos.format_fleet_report(soak)
    assert lines[0].startswith("fleet chaos: replicas r0, r1, ")
    assert f"SIGKILLed {soak.victim}" in lines[0]
    assert lines[-1] == "fleet chaos verdict: SURVIVED"
    assert not any(line.startswith("INVARIANT VIOLATED") for line in lines)


def test_lineage_and_staleness_audits_catch_violations():
    from splatt_tpu import chaos as jchaos

    recs = [{"rec": "accepted", "job": "a", "replica": "r0"},
            {"rec": "started", "job": "a", "replica": "r0"},
            {"rec": "started", "job": "a", "replica": "r1"},
            {"rec": "done", "job": "a", "replica": "r1"},
            {"rec": "done", "job": "a", "replica": "r0"},
            {"rec": "done", "job": "m", "model": "m", "model_gen": 2},
            {"rec": "accepted", "job": "p", "gen_pinned": 2,
             "spec": {"model": "m"}},
            {"rec": "done", "job": "p", "status": "served", "gen": 1}]
    got = chaos._fleet_lineage_violations(recs)
    assert got == jchaos._fleet_lineage_violations(recs) and len(got) == 2
    stale = chaos._predict_staleness_violations(recs)
    assert stale == jchaos._predict_staleness_violations(recs)
    assert len(stale) == 1 and "STALE" in stale[0]
    clean = [r for r in recs if r["job"] != "a" and r["job"] != "p"]
    assert chaos._fleet_lineage_violations(clean) == []


@pytest.mark.parametrize("flag", [[], ["--serve"], ["--ingest"]])
def test_the_other_soaks_exit_2_naming_the_roadmap(capsys, flag):
    assert cli.main(["chaos", "--smoke", "--device", "cpu"] + flag) == 2
    assert "15.3" in capsys.readouterr().err
