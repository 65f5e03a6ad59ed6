"""The port's span tracing, metrics registry, timers and trace verb
(``splatt_tpu_torch/trace.py``, ``utils/timers.py``, ``cli.py``) against
the JAX package's (≙ tests/test_trace.py:57-341, :448-483, :520-560), and
the CLI's checkpoint, health and profiled runs against the JAX CLI's.

Cross-checks: the JAX package's ``summarize_file`` reads a port trace, and
the port's span names for a guarded 4-iteration ``cpd_als`` contain the
JAX run's.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import cli as jcli
from splatt_tpu import resilience as jres
from splatt_tpu import trace as jtrace
from splatt_tpu.blocked import BlockedSparse as JBlocked
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.cpd import cpd_als as jax_cpd_als
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import cli
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience, trace
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import Options, Verbosity
from splatt_tpu_torch.cpd import cpd_als, load_checkpoint
from splatt_tpu_torch.io import save
from splatt_tpu_torch.utils import faults
from splatt_tpu_torch.utils.timers import TimerRegistry, timers
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SPLATT_HEALTH_RETRIES", raising=False)
    monkeypatch.delenv("SPLATT_FAULTS", raising=False)
    monkeypatch.delenv("SPLATT_TRACE", raising=False)

    def reset():
        for mod in (trace, jtrace):
            mod.set_enabled(None)
            mod.reset()
            mod.reset_metrics()
        for mod in (resilience, jres):
            mod.reset_demotions()
            mod.run_report().clear()
        for mod in (faults, jfaults):
            mod.reset()
    reset()
    yield
    reset()


def _tensor(name="med"):
    tt = gen.fixture_tensor(name)
    return tt, tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


def _opts(**kw):
    base = dict(random_seed=0, max_iterations=3, verbosity=Verbosity.NONE,
                val_dtype=torch.float64, nnz_block=256)
    base.update(kw)
    return Options(**base)


def _jopts(**kw):
    base = dict(random_seed=0, max_iterations=3, verbosity=JVerbosity.NONE,
                val_dtype=np.float64, nnz_block=256, autotune=False,
                fit_check_every=1)
    base.update(kw)
    return JOptions(**base)


def _init(dims, rank=3):
    rng = np.random.default_rng(2)
    return [rng.random((d, rank)) for d in dims]


# -- span recorder -----------------------------------------------------------


def test_disabled_span_is_the_shared_noop():
    assert not trace.enabled()
    h = trace.span("cpd.sweep", mode=0)
    assert h is trace.NOOP
    with h:
        pass
    assert trace.spans() == []
    trace.end(trace.begin("cpd.iter"))
    assert trace.spans() == []


def test_span_nesting_attributes_and_stack():
    trace.set_enabled(True)
    with trace.span("cpd.als", rank=4) as root:
        with trace.span("cpd.iter", it=1) as it:
            it.set(fit=0.5)
        with trace.span("cpd.iter", it=2):
            pass
    recs = trace.spans()
    assert [r["name"] for r in recs] == ["cpd.iter", "cpd.iter", "cpd.als"]
    iters = trace.spans("cpd.iter")
    assert all(r["parent"] == root.rec["sid"] for r in iters)
    assert iters[0]["args"] == {"it": 1, "fit": 0.5}
    assert all(r["dur"] >= 0 for r in recs)
    root_rec = trace.spans("cpd.als")[0]
    assert root_rec["parent"] is None and root_rec["args"]["rank"] == 4


def test_enabling_scope_and_process_override():
    with trace.enabling(True):
        assert trace.enabled()
        with trace.span("cpd.sweep"):
            pass
    assert not trace.enabled()
    trace.set_enabled(True)
    assert trace.enabled()
    with trace.enabling(False):
        assert not trace.enabled()
        assert trace.span("cpd.sweep") is trace.NOOP
    trace.set_enabled(None)
    assert len(trace.spans("cpd.sweep")) == 1


def test_env_enablement(monkeypatch):
    monkeypatch.setenv("SPLATT_TRACE", "on")
    trace.set_enabled(None)
    assert trace.enabled()
    monkeypatch.setenv("SPLATT_TRACE", "0")
    assert trace.enabled()  # memoized
    trace.set_enabled(None)
    assert not trace.enabled()


def test_point_events_attach_to_enclosing_span():
    trace.set_enabled(True)
    with trace.span("cpd.als") as root:
        resilience.run_report().add("transient_retry", label="engine.xla",
                                    attempt=1)
    pts = trace.points("transient_retry")
    assert len(pts) == 1 and pts[0]["parent"] == root.rec["sid"]
    assert pts[0]["args"]["label"] == "engine.xla"


def test_mis_nested_timer_brackets_are_tolerated():
    trace.set_enabled(True)
    a = trace.begin("timer.cpd")
    b = trace.begin("timer.mttkrp")
    trace.end(a)
    trace.end(b)
    with trace.span("cpd.sweep") as h:
        assert h.rec["parent"] is None
    assert {r["name"] for r in trace.spans()} == {
        "timer.cpd", "timer.mttkrp", "cpd.sweep"}


def test_span_names_are_declared():
    trace.set_enabled(True)
    _, tt = _tensor()
    cpd_als(BlockedSparse.from_coo(tt, _opts(), device="cpu"), 3,
            _opts(max_iterations=2), device="cpu")
    fams = {n[:-1] for n in trace.SPANS if n.endswith(".*")}
    for r in trace.spans():
        assert (r["name"] in trace.SPANS
                or any(r["name"].startswith(f) for f in fams)), r["name"]


# -- Chrome export -----------------------------------------------------------


def test_chrome_export_roundtrip(tmp_path):
    trace.set_enabled(True)
    with trace.span("cpd.als", rank=3):
        with trace.span("cpd.iter", it=1):
            resilience.run_report().add("block_clamp", mode=0,
                                        requested=64, clamped=32)
    out = tmp_path / "trace.json"
    ev = trace.write_chrome_trace(str(out))
    assert ev["ok"] and ev["spans"] == 2 and ev["events"] == 1
    evs = json.loads(out.read_text())["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(spans) == {"cpd.als", "cpd.iter"}
    assert (spans["cpd.iter"]["args"]["parent"]
            == spans["cpd.als"]["args"]["sid"])
    pts = [e for e in evs if e["ph"] == "i"]
    assert len(pts) == 1 and pts[0]["name"] == "block_clamp"
    assert len(trace.load_trace(str(out))) == 3
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(evs))
    assert len(trace.load_trace(str(bare))) == 3
    # the JAX package's loader and summarizer read the port's file
    assert jtrace.summarize_file(str(out))["spans"] == 2


def test_open_span_rides_along_marked():
    trace.set_enabled(True)
    h = trace.begin("cpd.als")
    evs = trace.chrome_events()
    trace.end(h)
    open_evs = [e for e in evs if e["args"].get("open")]
    assert len(open_evs) == 1 and open_evs[0]["dur"] >= 1


def test_trace_export_fault_degrades_classified(tmp_path):
    trace.set_enabled(True)
    with trace.span("cpd.als"):
        pass
    out = tmp_path / "t.json"
    with faults.inject("trace.export", "runtime"):
        ev = trace.write_chrome_trace(str(out))
    assert ev["kind"] == "trace_written" and ev["ok"] is False
    assert ev["failure_class"] == "unknown"
    assert not out.exists()
    assert trace.write_chrome_trace(str(out))["ok"]


def test_merge_puts_two_files_on_one_timeline(tmp_path):
    trace.set_enabled(True)
    paths = []
    for i in range(2):
        trace.reset()
        with trace.span("cpd.als", run=i):
            pass
        paths.append(str(tmp_path / f"t{i}.json"))
        trace.write_chrome_trace(paths[-1])
    merged = trace.merge_trace_files([str(tmp_path)])
    assert sorted({e["pid"] for e in merged}) == [1, 2]
    assert len([e for e in merged if e["ph"] == "X"]) == 2
    assert merged == jtrace.merge_trace_files(paths)


# -- the driver's spans ------------------------------------------------------


def test_traced_cpd_adds_no_host_sync(monkeypatch):
    """Spans never touch the card: a traced run reads the fit as often as
    an untraced one (counted at the fit read and the sentinel's pack)."""
    import splatt_tpu_torch.cpd as tcpd

    _, tt = _tensor()
    counts = {}
    for enabled in (False, True):
        n = [0]
        real = tcpd._health_verdict

        def spy(*a):
            n[0] += 1
            return real(*a)

        monkeypatch.setattr(tcpd, "_health_verdict", spy)
        trace.reset()
        out = cpd_als(BlockedSparse.from_coo(tt, _opts(), device="cpu"), 3,
                      _opts(trace=enabled), device="cpu")
        monkeypatch.setattr(tcpd, "_health_verdict", real)
        counts[enabled] = n[0]
        assert np.isfinite(out.fit)
    assert counts[True] == counts[False] == 3
    assert {"cpd.als", "cpd.iter", "cpd.sweep", "cpd.fit_check",
            "mttkrp.dispatch"} <= {r["name"] for r in trace.spans()}
    assert trace.enabled() is False  # Options.trace pinned the run only


def test_traced_cpd_iteration_spans_reconcile(tmp_path):
    _, tt = _tensor()
    opts = _opts(trace=True, max_iterations=4, tolerance=0.0)
    out = cpd_als(BlockedSparse.from_coo(tt, opts, device="cpu"), 3, opts,
                  device="cpu")
    iters = trace.spans("cpd.iter")
    assert [r["args"]["it"] for r in iters] == [1, 2, 3, 4]
    assert [r["args"]["fit"] for r in iters] == list(out.fits)
    root = trace.spans("cpd.als")[0]
    assert sum(r["dur"] for r in iters) <= root["dur"] * 1.001
    assert trace.spans("cpd.guard.snapshot")
    assert trace.spans("cpd.guard.health_pack")
    path = tmp_path / "cpd.json"
    assert trace.write_chrome_trace(str(path))["ok"]
    s = trace.summarize_file(str(path))
    assert s["root_us"] >= root["dur"] * 1e6 * 0.99
    assert len(s["iters"]) == 4
    assert abs(s["iter_total_us"] / 1e6
               - sum(r["dur"] for r in iters)) < 0.05
    # the iterations' spans reconcile with the driver's clock
    assert s["iter_total_us"] / 1e6 >= sum(out.iter_seconds) * 0.99
    assert 0.0 <= s["guard_pct"] <= 100.0
    text = "\n".join(trace.format_summary(s))
    assert "guard overhead" in text and "iterations: 4 spans" in text


def test_jax_summarizer_reads_a_port_trace_and_names_contain_jax(tmp_path):
    jt, tt = _tensor()
    init = _init(tt.dims)
    cpd_als(BlockedSparse.from_coo(tt, _opts(), device="cpu"), 3,
            _opts(trace=True, max_iterations=4, tolerance=0.0), init=init,
            device="cpu")
    path = str(tmp_path / "port.json")
    assert trace.write_chrome_trace(path)["ok"]
    s = jtrace.summarize_file(path)
    assert len(s["iters"]) == 4 and [r["it"] for r in s["iters"]] == [
        1, 2, 3, 4]
    assert s["guard_self_us"] > 0
    assert {n for n in s["names"] if jtrace._is_guard(n)} == {
        "cpd.guard.snapshot", "cpd.guard.health_pack"}
    assert s == trace.summarize_file(path)
    jopts = _jopts(trace=True, max_iterations=4, tolerance=0.0)
    jax_cpd_als(JBlocked.from_coo(jt, jopts), 3, jopts,
                init=[jnp.asarray(u) for u in init])
    jax_names = {r["name"] for r in jtrace.spans()}
    assert jax_names <= set(s["names"])


def test_summarize_self_time_subtracts_children():
    evs = [
        {"name": "cpd.als", "ph": "X", "ts": 0, "dur": 1000,
         "args": {"sid": 1}},
        {"name": "cpd.iter", "ph": "X", "ts": 100, "dur": 600,
         "args": {"sid": 2, "parent": 1, "it": 1}},
        {"name": "cpd.guard.snapshot", "ph": "X", "ts": 150, "dur": 200,
         "args": {"sid": 3, "parent": 2}},
        {"name": "engine_demotion", "ph": "i", "ts": 300, "args": {}},
    ]
    s = trace.summarize(evs)
    assert s["names"]["cpd.als"]["self_us"] == 400
    assert s["names"]["cpd.iter"]["self_us"] == 400
    assert s["guard_self_us"] == 200 and s["root_us"] == 1000
    assert s["guard_pct"] == 20.0
    assert s["points"] == {"engine_demotion": 1}
    assert s["iters"] == [{"it": 1, "us": 600, "fit": None}]
    assert s == jtrace.summarize(evs)


def test_distributed_run_records_its_spans():
    from splatt_tpu_torch.parallel import distributed_cpd_als
    from splatt_tpu_torch.parallel.mesh import make_mesh

    _, tt = _tensor()
    opts = _opts(trace=True, max_iterations=2)
    from splatt_tpu_torch.config import Decomposition

    opts.decomposition = Decomposition.FINE
    distributed_cpd_als(tt, 3, opts=opts,
                        mesh=make_mesh(n_devices=4, device="cpu"))
    names = {r["name"] for r in trace.spans()}
    assert {"dist.als", "dist.step", "dist.comm_select",
            "mttkrp.dispatch"} <= names
    assert len(trace.spans("dist.step")) == 2
    assert trace.spans("dist.comm_select")[0]["args"]["variant"] == "all2all"


# -- metrics -----------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [-+0-9.eE]+$")


def _assert_prometheus_text(text: str):
    for line in text.splitlines():
        if not line or line.startswith(("# HELP ", "# TYPE ")):
            continue
        assert _PROM_LINE.match(line), f"bad Prometheus line: {line!r}"


def test_metrics_registry_discipline():
    with pytest.raises(KeyError):
        trace.metric_inc("splatt_not_a_metric")
    with pytest.raises(TypeError):
        trace.metric_set("splatt_events_total", 1.0)
    with pytest.raises(TypeError):
        trace.metric_observe("splatt_serve_queue_depth", 1.0)


def test_metrics_text_parses_and_histograms_accumulate():
    trace.metric_inc("splatt_events_total", kind="engine_demotion")
    trace.metric_inc("splatt_events_total", kind="engine_demotion")
    trace.metric_set("splatt_serve_queue_depth", 3)
    for v in (0.05, 0.3, 7.0, 1e9):
        trace.metric_observe("splatt_job_seconds", v)
    text = trace.metrics_text()
    _assert_prometheus_text(text)
    assert 'splatt_events_total{kind="engine_demotion"} 2' in text
    assert "splatt_serve_queue_depth 3" in text
    assert 'splatt_job_seconds_bucket{le="+Inf"} 4' in text
    assert "splatt_job_seconds_count 4" in text
    cums = [int(m.group(1)) for m in re.finditer(
        r'splatt_job_seconds_bucket\{le="[^"]+"\} (\d+)', text)]
    assert cums == sorted(cums) and cums[-1] == 4


def test_event_metrics_are_always_on_spans_are_not():
    assert not trace.enabled()
    resilience.run_report().add("transient_retry", label="engine.xla",
                                attempt=1)
    resilience.run_report().add("health_rollback", iteration=2, attempt=1)
    resilience.run_report().add("health_degraded", iteration=3, action="x")
    snap = trace.metrics_snapshot()
    assert snap['splatt_events_total{kind="transient_retry"}'] == 1.0
    assert snap["splatt_retries_total"] == 1.0
    assert snap["splatt_health_rollbacks_total"] == 1.0
    assert snap["splatt_health_degraded_total"] == 1.0
    assert trace.points() == []


def test_metrics_per_job_isolation_and_write(tmp_path):
    with resilience.scope("tenant-a"):
        resilience.run_report().add("health_rollback", iteration=1,
                                    attempt=1)
    with resilience.scope("tenant-b"):
        resilience.run_report().add("engine_demotion", engine="fused_t",
                                    failure_class="resource")
    a = trace.metrics_text(job="tenant-a")
    assert 'job="tenant-a"' in a and "tenant-b" not in a
    ev = trace.write_metrics(str(tmp_path / "m.prom"), job="tenant-b")
    assert ev["ok"]
    text = (tmp_path / "m.prom").read_text()
    _assert_prometheus_text(text)
    assert 'splatt_demotions_total{failure_class="resource",' in text


# -- timers ------------------------------------------------------------------


def test_timer_brackets_become_spans():
    reg = TimerRegistry()
    trace.set_enabled(True)
    reg.start("cpd")
    reg.stop("cpd")
    with reg.time("mttkrp"):
        pass
    assert {r["name"] for r in trace.spans()} == {"timer.cpd",
                                                  "timer.mttkrp"}
    assert reg["cpd"] >= 0.0


def test_timer_report_folds_in_running_interval():
    import time as _time

    reg = TimerRegistry()
    reg.start("cpd")
    _time.sleep(0.02)
    live = reg["cpd"]
    assert live >= 0.02
    rep = reg.report(level=2)
    assert "cpd" in rep and "(running)" in rep
    reg.stop("cpd")
    assert reg["cpd"] >= live
    assert "(running)" not in reg.report(level=2)


# -- the CLI against the JAX CLI ---------------------------------------------


@pytest.fixture
def med_tns(tmp_path):
    path = tmp_path / "med.tns"
    save(gen.fixture_tensor("med"), str(path))
    return str(path)


def _json_line(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def test_cli_checkpoint_twice_resumes_as_jax_does(tmp_path, med_tns,
                                                  capsys):
    ck, jck = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    base = ["-r", "3", "-i", "4", "--seed", "1", "--nowrite", "--json",
            "--checkpoint"]
    for run in range(2):
        assert cli.main(["cpd", med_tns, *base, ck, "--checkpoint-every",
                         "2", "--device", "cpu"]) == 0
        port = capsys.readouterr().out
        assert jcli.main(["cpd", med_tns, *base, jck, "--checkpoint-every",
                          "2"]) == 0
        jax_out = capsys.readouterr().out
        kinds = [e["kind"] for e in _json_line(port)["events"]]
        jkinds = [e["kind"] for e in _json_line(jax_out)["events"]]
        assert ([k for k in kinds if k.startswith(("health", "checkpoint"))]
                == [k for k in jkinds
                    if k.startswith(("health", "checkpoint"))] == [])
        assert _json_line(port)["degraded"] is False
        assert ("resuming from" in port) == (run == 1)
        assert ("resuming from" in jax_out) == (run == 1)
    assert load_checkpoint(ck)[2] == 4


def test_cli_sweep_fault_rolls_back_as_jax_does(monkeypatch, med_tns,
                                                capsys):
    monkeypatch.setenv("SPLATT_FAULTS", "cpd.sweep:nan:iter=2")
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "2")
    args = ["cpd", med_tns, "-r", "3", "-i", "4", "--seed", "1",
            "--nowrite", "--json"]
    faults.reset()
    assert cli.main(args + ["--device", "cpu"]) == 0
    port = _json_line(capsys.readouterr().out)
    jfaults.reset()
    assert jcli.main(args) == 0
    want = _json_line(capsys.readouterr().out)
    keys = ("kind", "iteration", "attempt", "regularization", "rerandomized")

    def health(rec):
        return [{k: v for k, v in e.items() if k in keys}
                for e in rec["events"] if e["kind"].startswith("health_")]

    assert health(port) == health(want)
    assert [e["kind"] for e in health(port)] == ["health_nonfinite",
                                                 "health_rollback"]
    assert port["degraded"] is want["degraded"] is False
    assert np.isfinite(port["fit"]) and 0.0 < port["fit"] <= 1.0
    # every kind the port emitted is declared, as the JAX package's are
    assert {e["kind"] for e in port["events"]} <= set(
        resilience.RUN_REPORT_EVENTS)
    assert {e["kind"] for e in health(port)} <= set(
        jres.RUN_REPORT_EVENTS)


def test_cli_trace_flag_and_trace_verb(tmp_path, med_tns, capsys):
    out = str(tmp_path / "run.json")
    assert cli.main(["cpd", med_tns, "-r", "3", "-i", "4", "--seed", "1",
                     "--nowrite", "--device", "cpu", "--trace", out]) == 0
    assert not trace.enabled()
    assert "trace written to" in capsys.readouterr().err
    s = trace.summarize_file(out)
    assert {"cpd.als", "cpd.iter", "timer.total"} <= set(s["names"])
    assert len(s["iters"]) == 4
    assert cli.main(["trace", out]) == 0
    text = capsys.readouterr().out
    assert "top spans by self-time" in text and "iterations: 4 spans" in text
    assert jcli.main(["trace", out]) == 0
    assert capsys.readouterr().out == text
    assert cli.main(["trace", out, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out.strip())
    assert payload["spans"] == s["spans"] and len(payload["iters"]) == 4
    merged = str(tmp_path / "merged.json")
    assert cli.main(["trace", out, out, "--out", merged, "--top", "3"]) == 0
    assert "written to" in capsys.readouterr().err
    assert len(trace.summarize_file(merged)["iters"]) == 8


def test_cli_verbose_twice_prints_the_phase_table(med_tns, capsys):
    timers.reset()
    assert cli.main(["cpd", med_tns, "-r", "3", "-i", "3", "--seed", "1",
                     "--nowrite", "--device", "cpu", "-v", "-v"]) == 0
    text = capsys.readouterr().out
    assert "Per-mode MTTKRP time (in-loop totals):" in text
    for m in range(3):
        assert re.search(rf"  mode {m}: \d+\.\d{{3}}s", text)
    assert "Timing information" in text
    for name in ("mttkrp", "solve", "normalize", "gram", "fit", "cpd",
                 "total", "blocked_build"):
        assert re.search(rf"  {name}:\s+\d+\.\d{{3}}s", text), name
    assert jcli.main(["cpd", med_tns, "-r", "3", "-i", "3", "--seed", "1",
                      "--nowrite", "-v", "-v"]) == 0
    jtext = capsys.readouterr().out
    assert "Per-mode MTTKRP time (in-loop totals):" in jtext


def test_cli_distributed_profiled_prints_the_phase_report(med_tns, capsys):
    assert cli.main(["cpd", med_tns, "-r", "3", "-i", "3", "--seed", "1",
                     "--nowrite", "--device", "cpu", "--decomp", "fine",
                     "--ndev", "4", "-v", "-v"]) == 0
    text = capsys.readouterr().out
    assert "distributed phase times (in-loop totals, warm iterations):" in text
    for label in ("gather rows", "local mttkrp", "reduce collective",
                  "solve+normalize+gram", "fit"):
        assert label in text, label
