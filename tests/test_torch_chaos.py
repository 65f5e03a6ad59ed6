"""The port's chaos soaks other than the fleet's (``splatt_tpu_torch/
chaos.py``) on the CPU, asserting what ``tests/test_chaos.py:33-120`` and
``:209-272`` and ``tests/test_ingest.py:611`` assert of the JAX package's.

- ``chaos --smoke --device cpu``: the JAX package's default schedule and
  invariant (a NaN rolled back, a blown tuner deadline, a transient
  failure retried, the comm drill degraded down the CPU mesh's chain),
  its report lines and its JSON; budget exhaustion degrades; a seeded
  probabilistic schedule replays; the evidence map knows every fault
  kind; a bad schedule fails loudly; no armed state is left behind.
- The card's legs of the invariant (``chaos._card_violations``) on
  fabricated evidence: a site that never fired, a demotion with no other
  kernel engine launched, a drill that completed.
- ``run_serve_chaos`` on ``--device cpu``: the daemon SIGKILLed mid-job
  and restarted, no job lost, the NaN tenant contained; the crash-window
  classifiers against the JAX package's on a fabricated post-kill spool
  and ingest directory.
- ``run_ingest_chaos``: the ingest SIGKILL and resume.

Every subprocess wait inside the soaks is bounded, and each child is
killed in a ``finally``.
"""

import json
import os

import pytest

from splatt_tpu import chaos as jchaos
from splatt_tpu_torch import chaos, cli, resilience, tune
from splatt_tpu_torch.utils import faults
from tests.torch_fixtures import private_tune_cache  # noqa: F401


def _clean():
    resilience.reset_demotions()
    resilience.run_report().clear()
    resilience.set_deadline(None)
    faults.reset()
    tune.set_cache_path(None)


@pytest.fixture(autouse=True)
def _clean_state():
    _clean()
    yield
    _clean()


@pytest.fixture(scope="module")
def smoke():
    """One ``chaos --smoke --json --device cpu`` run: (rc, stdout, the
    armed state right after it)."""
    import contextlib
    import io

    _clean()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["chaos", "--smoke", "--json", "--device", "cpu"])
    after = dict(armed=faults.active("cpd.sweep"),
                 deadline=resilience.deadline_seconds(),
                 cache=tune._cache_path_override)
    _clean()
    return rc, buf.getvalue(), after


def test_chaos_smoke_invariant_holds(smoke):
    rc, out, _ = smoke
    assert rc == 0, out
    assert "chaos verdict: CONVERGED" in out or \
        "chaos verdict: DEGRADED" in out
    assert "INVARIANT VIOLATED" not in out
    assert f"chaos schedule: {chaos.DEFAULT_SCHEDULE} (on cpu)" in out
    # each leg of the JAX package's schedule left its evidence
    assert "rolled back to the last-good snapshot" in out
    assert "deadline watchdog blew at tuner.measure" in out
    assert "transient failure(s) retried" in out
    assert "comm engine async_ring degraded to ring" in out


def test_chaos_smoke_json(smoke):
    _, out, _ = smoke
    rec = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["verdict"] in ("converged", "degraded")
    assert rec["violations"] == [] and rec["finite"] is True
    assert rec["device"] == "cpu" and rec["drill"] == {"raised": False}
    kinds = {e["kind"] for e in rec["events"]}
    assert {"health_nonfinite", "health_rollback", "deadline_blown",
            "transient_retry", "comm_fallback"} <= kinds
    assert kinds <= set(resilience.RUN_REPORT_EVENTS)
    # all four armed legs fired
    assert set(rec["fired"]) == set(faults.parse_schedule(
        chaos.DEFAULT_SCHEDULE))
    assert all(n > 0 for n in rec["fired"].values())


def test_chaos_leaves_no_armed_state(smoke):
    _, _, after = smoke
    assert not after["armed"]
    assert after["deadline"] is None
    assert after["cache"] is None


def test_chaos_custom_schedule_budget_exhaustion():
    res = chaos.run_chaos(schedule="cpd.sweep:nan:*", smoke=True,
                          device="cpu")
    assert res.ok, res.violations
    assert res.verdict == "degraded"
    assert any(e["kind"] == "health_degraded" for e in res.events)


def test_chaos_probabilistic_schedule_is_seeded():
    sched = "cpd.sweep:nan:p=0.4:seed=11:*"
    a = chaos.run_chaos(schedule=sched, smoke=True, device="cpu")
    b = chaos.run_chaos(schedule=sched, smoke=True, device="cpu")
    assert a.ok and b.ok, (a.violations, b.violations)
    assert a.fired == b.fired and a.verdict == b.verdict


def test_chaos_detects_silent_degradation():
    res = chaos.run_chaos(schedule="cpd.sweep:nan:iter=2", smoke=True,
                          device="cpu")
    assert res.ok
    for kind in faults.RAISING_KINDS + faults.POISON_KINDS \
            + faults.DELAY_KINDS:
        assert kind in chaos._EVIDENCE, kind
    # the JAX package's map, less the probe's event (no counterpart)
    for kind, want in jchaos._EVIDENCE.items():
        assert chaos._EVIDENCE[kind] == tuple(
            k for k in want if k != "probe_downgrade")


def test_chaos_bad_schedule_fails_loudly():
    with pytest.raises(ValueError):
        chaos.run_chaos(schedule="site:notakind", smoke=True, device="cpu")


def test_card_schedule_arms_a_kernel_engine_and_the_comm_drill():
    specs = faults.parse_schedule(chaos.CARD_SCHEDULE)
    assert "engine.xla" not in specs
    assert specs["engine.fused_t"].kind in faults.RAISING_KINDS
    assert set(specs) - {"engine.fused_t"} == set(faults.parse_schedule(
        chaos.DEFAULT_SCHEDULE)) - {"engine.xla"}


class _Report:
    def __init__(self, events):
        self._events = events

    def events(self, kind=None):
        return [e for e in self._events if kind is None or e["kind"] == kind]


def test_card_legs_of_the_invariant_catch_each_violation():
    specs = faults.parse_schedule(chaos.CARD_SCHEDULE)
    fired = {s: 1 for s in specs}
    demoted = _Report([{"kind": "engine_demotion", "engine": "fused_t"}])
    launches = {"fused_mttkrp_t": 6, "fused_mttkrp_tg": 12, "sym_eig": 18}
    drill = {"raised": True, "failure_class": "unknown",
             "error": "RuntimeError: injected engine runtime failure at "
                      "comm.ring_exchange"}
    assert chaos._card_violations(specs, fired, demoted, launches, drill,
                                  None) == []
    got = chaos._card_violations(specs, dict(fired, **{"tuner.measure": 0}),
                                 demoted, launches, drill, None)
    assert len(got) == 1 and "never fired" in got[0]
    got = chaos._card_violations(specs, fired, _Report([]), launches, drill,
                                 None)
    assert len(got) == 1 and "not demoted" in got[0]
    got = chaos._card_violations(specs, fired, demoted,
                                 {"fused_mttkrp_t": 6}, drill, None)
    assert len(got) == 1 and "no other kernel engine" in got[0]
    got = chaos._card_violations(specs, fired, demoted, launches,
                                 {"raised": False}, None)
    assert len(got) == 1 and "hidden fallback" in got[0]
    got = chaos._card_violations(specs, fired, demoted, launches,
                                 dict(drill, error="boom"), None)
    assert len(got) == 1 and "other than the injected" in got[0]
    # an escaped error is the violation already
    assert chaos._card_violations(specs, {}, _Report([]), {}, None,
                                  "unknown: x") == []


# -- the serve daemon's kill-and-restart soak --------------------------------

def test_serve_chaos_smoke_kill_and_restart():
    res = chaos.run_serve_chaos(smoke=True, device="cpu")
    assert res.ok, res.violations
    assert res.verdict == "survived"
    assert res.killed_mid_queue and res.resumed
    assert set(res.jobs) == {"chaos-0-nan", "chaos-clean0", "chaos-clean1"}
    assert all(s in ("converged", "degraded") for s in res.jobs.values())
    rec = res.to_json()
    assert rec["verdict"] == "survived" and not rec["violations"]
    evs = resilience.run_report().events("crash_windows_exercised")
    assert evs and evs[0]["soak"] == "serve"
    assert evs[0]["windows"] == ",".join(res.crash_windows)
    lines = chaos.format_serve_report(res)
    assert lines[0].startswith("serve chaos: SIGKILL mid-queue landed")
    assert lines[-1] == "serve chaos verdict: SURVIVED"


def test_crash_window_classifiers_match_the_jax_packages(tmp_path):
    root = str(tmp_path / "spool")
    os.makedirs(os.path.join(root, "results"))
    os.makedirs(os.path.join(root, "leases"))
    with open(os.path.join(root, "journal.jsonl"), "w") as f:
        f.write('{"rec": "accepted", "job": "j1", "ts": 1}\n')
        f.write('{"rec": "done", "job": "j1", "ts": 2}\n')
        f.write('{"rec": "accepted", "job": "j3", "ts": 3}\n')
        f.write('{"rec": "acce')
    with open(os.path.join(root, "results", "j3.json"), "w") as f:
        json.dump({"job": "j3", "status": "converged"}, f)
    for debris in ("m1.gen.json.~7.tmp", "m1.gen.json.bak.~7.tmp",
                   "m1.npz.~7.tmp"):
        open(os.path.join(root, debris), "w").close()
    open(os.path.join(root, "leases", "j1.json.~7.tmp"), "w").close()
    got = chaos._crash_windows_exercised(root)
    assert got == jchaos._crash_windows_exercised(root)
    assert "journal.append[done]" in got and "lease.publish" in got
    dest = str(tmp_path / "ingest")
    for sub in ("seg", "vocab"):
        os.makedirs(os.path.join(dest, sub))
    with open(os.path.join(dest, "journal.jsonl"), "w") as f:
        f.write('{"rec": "begin"}\n{"rec": "chunk", "n": 0}\n{"rec": "ch')
    for p in ("seg/chunk-00000001.npz.~9.tmp",
              "vocab/delta-00000001.json.~9.tmp", "tensor.bin.~9.build"):
        open(os.path.join(dest, p), "w").close()
    got = chaos._ingest_crash_windows(dest)
    assert got == jchaos._ingest_crash_windows(dest)
    assert got == ["ingest.bin.publish", "ingest.seg.publish",
                   "ingest.vocab.publish", "journal.append.torn",
                   "journal.append[begin]", "journal.append[chunk]"]


# -- the ingest kill-and-resume soak -----------------------------------------

def test_ingest_chaos_smoke_sigkill_resume():
    res = chaos.run_ingest_chaos(seed=0, smoke=True)
    assert res.killed_mid_stream, res.violations
    assert res.ok, res.violations
    assert res.verdict == "survived" and res.resumed
    assert any(w.startswith("journal.append") for w in res.crash_windows)
    # the generator's ground truth: 1440 records, every 23rd malformed
    assert (res.chunks, res.nnz, res.quarantined) == (12, 1378, 62)
    lines = chaos.format_ingest_report(res)
    assert lines[-1] == "ingest chaos verdict: SURVIVED"
