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
soak modes dispatch to their soaks (stubbed here; the soaks themselves
are tested in ``tests/test_torch_chaos.py``), and ``--bench-gate`` exits
2, naming the port's benchmark PR.
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


def _evidence(res) -> str:
    """What a failed check prints: every job's status, the soak's
    violations, its adoptions, affinity and observability counts, so a
    failure names its cause."""
    return (f"jobs={dict(sorted(res.jobs.items()))} "
            f"violations={res.violations} victim={res.victim} "
            f"adopted={res.adopted} affinity={res.affinity} "
            f"observability={res.observability} error={res.error}")


def test_fleet_chaos_smoke_kill_and_failover(soak):
    res = soak
    why = _evidence(res)
    assert res.ok, why
    assert res.verdict == "survived" and res.spool is None, why
    assert res.victim is not None, why        # the kill landed
    assert "fleet-1-pin" in res.adopted, why  # and forced an adoption
    assert set(res.jobs) == {"fleet-0-warm", "fleet-1-pin",
                             "fleet-2-nan", "fleet-3-clean",
                             "fleet-4-base", "fleet-5-up",
                             "fleet-b0", "fleet-b1", "fleet-b2",
                             "fleet-p0", "fleet-p1", "fleet-p2",
                             "fleet-p3"}, why
    assert all(s in ("converged", "degraded")
               for j, s in res.jobs.items()
               if not j.startswith("fleet-p")), why
    assert all(s in ("served", "refused")
               for j, s in res.jobs.items() if j.startswith("fleet-p")), why
    assert res.observability["predicts_served"] >= 1, why
    assert res.jobs["fleet-p3"] == "refused", why
    assert "batched_jobs" in res.observability, why
    aff = res.affinity["fleet-1-pin"]
    assert aff["cache_hits"] and not aff["measured"], why
    assert aff["adopted_from"] == res.victim, why
    ob = res.observability
    assert ob["adoptions"] >= 1 and ob["lease_expired"] >= 1, why
    assert ob["slo_burns"] >= 1, why
    assert ob["replicas_dead"] >= 1, why
    assert ob["flight_events"] >= 1, why
    rec = res.to_json()
    assert rec["verdict"] == "survived" and not rec["violations"], why


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


class _Stub:
    """What a stubbed soak returns: an ok result the CLI can print."""

    ok = True

    def to_json(self):
        return {"verdict": "stub"}


@pytest.mark.parametrize("flag,soak,report", [
    ([], "run_chaos", "format_report"),
    (["--serve"], "run_serve_chaos", "format_serve_report"),
    (["--ingest"], "run_ingest_chaos", "format_ingest_report")])
def test_the_other_soaks_exit_2_naming_the_roadmap(monkeypatch, capsys, flag,
                                                   soak, report):
    """Each mode of the chaos verb dispatches to its own soak, passing the
    device to the soaks that take one (≙ tests/test_chaos.py:272)."""
    calls = []

    def stub(**kw):
        calls.append(kw)
        return _Stub()

    for name in ("run_chaos", "run_serve_chaos", "run_ingest_chaos",
                 "run_fleet_chaos"):
        monkeypatch.setattr(chaos, name, stub if name == soak else None)
    monkeypatch.setattr(chaos, report, lambda res: [f"{soak} report"])
    args = cli.build_parser().parse_args(
        ["chaos", "--smoke", "--device", "cpu"] + flag)
    assert args.smoke and args.serve == (flag == ["--serve"])
    assert args.ingest == (flag == ["--ingest"])
    assert cli.main(["chaos", "--smoke", "--device", "cpu", "--json"]
                    + flag) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"{soak} report", '{"verdict": "stub"}']
    assert len(calls) == 1 and calls[0]["smoke"] is True
    if soak != "run_ingest_chaos":
        assert calls[0]["device"] == "cpu"


def test_chaos_bench_gate_exits_2_naming_the_benchmark_pr(capsys):
    assert cli.main(["chaos", "--smoke", "--bench-gate", "--device",
                     "cpu"]) == 2
    err = capsys.readouterr().err
    assert "benchmark PR" in err and "no gate ran" in err
