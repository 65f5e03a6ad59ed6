"""The port's guarded ALS driver against the JAX package's, on the CPU:
deferred fit checks, the numerical-health sentinel and its rollback and
degrade, the sweep-level engine rescue, the deadline watchdog and the
resilience scopes (≙ tests/test_guarded.py, tests/test_resilience.py).

Both packages run the same COO tensor from the same numpy init, f64: fits
within 1e-9, λ and factors within 1e-8.  The JAX package's fits at check
iterations come from its ``cpd.iter`` spans, which carry them.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import resilience as jres
from splatt_tpu import trace as jtrace
from splatt_tpu.blocked import BlockedSparse as JBlocked
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.cpd import cpd_als as jax_cpd_als
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience, trace
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import Options, Verbosity
from splatt_tpu_torch.cpd import (_health_pack, _health_verdict,
                                  _try_engine_rescue, cpd_als,
                                  health_retries)
from splatt_tpu_torch.ops import mttkrp as tmttkrp
from splatt_tpu_torch.resilience import DeadlineExceeded, NumericalHealthError
from splatt_tpu_torch.utils import faults
from splatt_tpu_torch.utils.timers import timers
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

RANK = 4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SPLATT_HEALTH_RETRIES", raising=False)
    monkeypatch.delenv("SPLATT_DEADLINE_S", raising=False)

    def reset():
        for mod in (faults, jfaults):
            mod.reset()
        for mod in (resilience, jres):
            mod.reset_demotions()
            mod.run_report().clear()
        for mod in (trace, jtrace):
            mod.set_enabled(None)
            mod.reset()
        resilience.set_deadline(None)
        tmttkrp._DEADLINE_ARMED.clear()
    reset()
    yield
    reset()


def _tensor(name="med"):
    tt = gen.fixture_tensor(name)
    return tt, tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


def _init(dims, rank=RANK, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.random((d, rank)) for d in dims]


def _opts(**kw):
    base = dict(max_iterations=6, tolerance=0.0, val_dtype=torch.float64,
                verbosity=Verbosity.NONE, random_seed=1, nnz_block=256)
    base.update(kw)
    return Options(**base)


def _jopts(**kw):
    base = dict(max_iterations=6, tolerance=0.0, val_dtype=np.float64,
                verbosity=JVerbosity.NONE, random_seed=1, nnz_block=256,
                autotune=False)
    base.update(kw)
    return JOptions(**base)


def _port(tt, opts, init, **kw):
    bs = BlockedSparse.from_coo(tt, opts, device="cpu")
    return cpd_als(bs, RANK, opts, init=init, device="cpu", **kw)


def _jax(jt, jopts, init, **kw):
    return jax_cpd_als(JBlocked.from_coo(jt, jopts), RANK, jopts,
                       init=[jnp.asarray(u) for u in init], **kw)


def _jax_checks():
    """(iteration, fit) of the JAX run's checked iterations, from its
    cpd.iter spans."""
    return [(r["args"]["it"], r["args"]["fit"])
            for r in jtrace.spans("cpd.iter") if "fit" in r["args"]]


def _health(report):
    keys = ("kind", "iteration", "attempt", "regularization",
            "rerandomized", "modes")
    return [{k: v for k, v in e.items() if k in keys}
            for e in report.events() if e["kind"].startswith("health_")]


# -- deferred fit checks -----------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_deferred_checks_stop_where_jax_stops(k):
    jt, tt = _tensor()
    init = _init(tt.dims)
    got = _port(tt, _opts(max_iterations=40, tolerance=1e-4,
                          fit_check_every=k), init)
    _jax(jt, _jopts(max_iterations=40, tolerance=1e-4, fit_check_every=k,
                    trace=True), init)
    want = _jax_checks()
    assert list(got.fit_iters) == [it for it, _ in want]
    assert got.fit_iters[-1] < 40  # the tolerance stopped it mid-run
    assert all(it % k == 0 for it in got.fit_iters)
    np.testing.assert_allclose(got.fits, [f for _, f in want], atol=1e-9,
                               rtol=0)


def test_due_checkpoint_forces_a_check_and_scales_the_window(tmp_path):
    jt, tt = _tensor()
    init = _init(tt.dims)
    got = _port(tt, _opts(max_iterations=40, tolerance=1e-4,
                          fit_check_every=3), init,
                checkpoint_path=str(tmp_path / "p.npz"), checkpoint_every=2)
    _jax(jt, _jopts(max_iterations=40, tolerance=1e-4, fit_check_every=3,
                    trace=True), init,
         checkpoint_path=str(tmp_path / "j.npz"), checkpoint_every=2)
    want = _jax_checks()
    # checks at every multiple of 2 or 3, as the JAX run's
    assert list(got.fit_iters) == [it for it, _ in want]
    assert {2, 3, 4} <= set(got.fit_iters)
    np.testing.assert_allclose(got.fits, [f for _, f in want], atol=1e-9,
                               rtol=0)


def test_fit_check_every_is_validated():
    with pytest.raises(ValueError, match="fit_check_every"):
        Options(fit_check_every=0).validate()


def test_deferred_checks_leave_the_model_unchanged():
    _, tt = _tensor()
    init = _init(tt.dims)
    a = _port(tt, _opts(), init)
    b = _port(tt, _opts(fit_check_every=4), init)
    assert list(b.fit_iters) == [4, 6]
    assert b.fit == pytest.approx(a.fit, abs=1e-12)
    for u, v in zip(a.factors, b.factors):
        np.testing.assert_allclose(u.numpy(), v.numpy(), atol=1e-12)


# -- the numerical-health sentinel -------------------------------------------


@pytest.mark.parametrize("at", [2, 3, 5])
def test_sweep_nan_rolls_back_as_jax_does(monkeypatch, at):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "2")
    jt, tt = _tensor()
    init = _init(tt.dims)
    with faults.inject("cpd.sweep", "nan", iter_at=at):
        got = _port(tt, _opts(), init)
    with jfaults.inject("cpd.sweep", "nan", iter_at=at):
        _jax(jt, _jopts(), init)
    ev = _health(resilience.run_report())
    assert ev == _health(jres.run_report())
    assert [e["kind"] for e in ev] == ["health_nonfinite", "health_rollback"]
    assert ev[0]["iteration"] == at and ev[1]["rerandomized"] == [2]
    assert np.isfinite(got.fit) and 0.0 < got.fit <= 1.0
    assert all(np.isfinite(u.numpy()).all() for u in got.factors)


def test_inf_rolls_back_with_the_budget_from_a_scope():
    jt, tt = _tensor()
    init = _init(tt.dims)
    with resilience.scope("job-a", health_retries=1) as sc:
        assert health_retries() == 1
        with faults.inject("cpd.sweep", "inf", iter_at=4):
            got = _port(tt, _opts(), init)
    assert [e["kind"] for e in sc.report.events()
            if e["kind"].startswith("health_")] == ["health_nonfinite",
                                                    "health_rollback"]
    assert all(e["job"] == "job-a" for e in sc.report.events())
    assert not resilience.run_report().events()
    assert np.isfinite(got.fit)


def test_poisoned_engine_output_rolls_back_through_a_rebuilt_sweep(
        monkeypatch):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "2")
    _, tt = _tensor()
    trace.set_enabled(True)
    with faults.inject("engine.fused_t", "nan", iter_at=4):
        got = _port(tt, _opts(), _init(tt.dims))
    kinds = [e["kind"] for e in resilience.run_report().events()]
    assert "health_nonfinite" in kinds and "health_rollback" in kinds
    assert np.isfinite(got.fit)
    # the first build and the rollback's
    assert len(trace.spans("cpd.build_sweep")) == 2
    assert trace.spans("cpd.guard.rollback")
    assert not resilience.demotions()  # a NaN indicts no engine


def _arm_after(mod, n):
    """A stop hook that arms cpd.sweep with NaN on every later sweep once
    iteration `n` is checked (and never stops the run)."""
    seen = [0]

    def stop():
        seen[0] += 1
        if seen[0] == n:
            mod.arm("cpd.sweep", mod.FaultSpec(kind="nan",
                                               times=mod.ALWAYS))
        return False
    return stop


def test_exhausted_budget_degrades_and_checkpoints_the_last_good_check(
        monkeypatch, tmp_path):
    from splatt_tpu.cpd import load_checkpoint as jax_load
    from splatt_tpu_torch.cpd import load_checkpoint

    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "1")
    jt, tt = _tensor()
    init = _init(tt.dims)
    ck, jck = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    got = _port(tt, _opts(), init, checkpoint_path=ck, checkpoint_every=10,
                stop=_arm_after(faults, 2))
    want = _jax(jt, _jopts(), init, checkpoint_path=jck,
                checkpoint_every=10, stop=_arm_after(jfaults, 2))
    ev = _health(resilience.run_report())
    assert ev == _health(jres.run_report())
    assert [e["kind"] for e in ev] == ["health_nonfinite", "health_rollback",
                                       "health_nonfinite", "health_degraded"]
    deg = resilience.run_report().events("health_degraded")
    assert len(deg) == 1 and deg[0]["iteration"] == 3
    assert ck in deg[0]["action"]
    assert got.fit == pytest.approx(float(want.fit), abs=1e-9)
    f, lam, it, fit = load_checkpoint(ck)
    jf, jlam, jit, jfit = jax_load(jck)
    assert it == jit == 2 and fit == pytest.approx(jfit, abs=1e-9)
    for a, b in zip(f, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-8)


def test_zero_budget_takes_no_snapshot_and_records_no_guard_span(
        monkeypatch):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "0")
    _, tt = _tensor()
    trace.set_enabled(True)
    _port(tt, _opts(max_iterations=3), _init(tt.dims))
    names = {r["name"] for r in trace.spans()}
    assert {"cpd.als", "cpd.iter", "cpd.sweep", "cpd.fit_check"} <= names
    assert not any(n.startswith("cpd.guard.") for n in names)


def test_default_budget_is_the_jax_packages():
    assert health_retries() == 3 == __import__(
        "splatt_tpu.cpd", fromlist=["health_retries"]).health_retries()


@pytest.mark.parametrize("bad", ["factor", "lam", "fit"])
def test_health_pack_and_verdict_match_jax(bad):
    from splatt_tpu.cpd import _health_pack as jpack
    from splatt_tpu.cpd import _health_verdict as jverdict

    rng = np.random.default_rng(0)
    fs = [rng.random((5, 3)) for _ in range(3)]
    lam, fit = rng.random(3), 0.5
    if bad == "factor":
        fs[1][2, 0] = np.nan
    elif bad == "lam":
        lam[0] = np.inf
    else:
        fit = np.nan
    got = _health_pack([torch.from_numpy(u) for u in fs],
                       torch.from_numpy(lam), torch.tensor(fit))
    want = np.asarray(jpack([jnp.asarray(u) for u in fs], jnp.asarray(lam),
                            jnp.asarray(fit)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert _health_verdict(got.numpy(), 3)[1:] == jverdict(want, 3)[1:]


# -- the sweep-level engine rescue -------------------------------------------


def _bs():
    _, tt = _tensor()
    return BlockedSparse.from_coo(tt, _opts(), device="cpu")


def _jbs():
    jt, _ = _tensor()
    return JBlocked.from_coo(jt, _jopts())


def test_rescue_decisions_match_jax():
    from splatt_tpu.cpd import _try_engine_rescue as jrescue

    bs, jbs = _bs(), _jbs()
    err = RuntimeError("INTERNAL: async runtime failure")
    for res, rescue, b, o in ((resilience, _try_engine_rescue, bs, _opts()),
                              (jres, jrescue, jbs, _jopts())):
        res._state().last_attempt = None
        assert rescue(b, o, err) is False
        res.note_engine_attempt("fused_t", "ck1:b256")
        assert rescue(b, o, err) is True
        assert res.is_demoted("fused_t")
        # already demoted: nothing new was tried
        assert rescue(b, o, err) is False
        # the terminal engine: nothing left to fall back to
        res.note_engine_attempt("xla", None)
        assert rescue(b, o, err) is False
        res.note_engine_attempt("fused_tg", "ck1:b256")
        # an UNKNOWN error (a shape bug) must surface
        assert rescue(b, o, ValueError("shapes (3,4) and (5,6)")) is False
        assert rescue(b, o, NumericalHealthError("non-finite")) is False
        assert not res.is_demoted("fused_tg")


def test_rescue_refuses_fallback_off_coo_and_sticky_cuda_errors():
    bs = _bs()
    resilience.note_engine_attempt("fused_t", "ck1:b256")
    err = RuntimeError("INTERNAL: async runtime failure")
    assert _try_engine_rescue(bs, _opts(engine_fallback=False), err) is False
    _, tt = _tensor()
    assert _try_engine_rescue(tt, _opts(), err) is False
    for msg in ("INTERNAL: CUDA error: an illegal memory access was "
                "encountered",
                "UNAVAILABLE: CUDA error: unspecified launch failure",
                "RESOURCE_EXHAUSTED: CUDA error: device-side assert "
                "triggered"):
        assert resilience.sticky_cuda_error(RuntimeError(msg))
        assert _try_engine_rescue(bs, _opts(), RuntimeError(msg)) is False
    assert not resilience.is_demoted("fused_t")
    assert _try_engine_rescue(bs, _opts(), err) is True


def test_a_failure_at_the_fit_read_is_rescued_and_the_run_finishes(
        monkeypatch):
    _, tt = _tensor()
    init = _init(tt.dims)
    base = _port(tt, _opts(), init)
    import splatt_tpu_torch.cpd as tcpd

    real, calls = tcpd._fit, [0]

    def flaky(*a):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("UNAVAILABLE: injected async failure")
        return real(*a)

    monkeypatch.setattr(tcpd, "_fit", flaky)
    got = _port(tt, _opts(), init)
    dem = resilience.run_report().events("engine_demotion")
    assert len(dem) == 1 and dem[0]["engine"] == "fused_t"
    assert got.fit == pytest.approx(base.fit, abs=1e-9)


def test_timeout_demotes_per_shape_like_oom():
    resilience.demote_engine(
        "fused_t", DeadlineExceeded("splatt deadline blown at "
                                    "engine.fused_t after 2s"),
        shape_key="ck1:b4096")
    assert resilience.is_demoted("fused_t", "ck1:b4096")
    assert not resilience.is_demoted("fused_t", "ck1:b128")
    assert not resilience.is_demoted("fused_t")


# -- the deadline watchdog ---------------------------------------------------


def test_deadline_blows_and_reports():
    with pytest.raises(DeadlineExceeded, match="deadline blown at d1"):
        with resilience.deadline("d1", 0.2):
            time.sleep(0.8)
    ev = resilience.run_report().events("deadline_blown")
    assert len(ev) == 1 and ev[0]["site"] == "d1"
    assert (resilience.classify_failure(DeadlineExceeded("splatt deadline "
                                                         "blown at x"))
            is resilience.FailureClass.TIMEOUT)


def test_deadline_disabled_is_noop():
    with resilience.deadline("d2", 0):
        time.sleep(0.05)
    with resilience.deadline("d3", None):
        pass
    with resilience.deadline("d4"):
        pass
    assert not resilience.run_report().events("deadline_blown")


def test_deadline_override_and_generous_budget():
    resilience.set_deadline(5.0)
    assert resilience.deadline_seconds() == 5.0
    with resilience.deadline("d5"):
        time.sleep(0.02)
    resilience.set_deadline(None)
    assert resilience.deadline_seconds(default=240.0) == 240.0


def test_deadline_explicit_disable_beats_env(monkeypatch):
    monkeypatch.setenv("SPLATT_DEADLINE_S", "300")
    assert resilience.deadline_seconds() == 300.0
    resilience.set_deadline(0)
    assert resilience.deadline_seconds() is None
    assert resilience.deadline_seconds(default=240.0) == 240.0
    with resilience.deadline("d7"):
        time.sleep(0.02)
    with resilience.scope("j", deadline_s=3.0):
        assert resilience.deadline_seconds() == 3.0


def test_deadline_off_main_thread_raises_post_hoc():
    result = {}

    def work():
        try:
            with resilience.deadline("d6", 0.1):
                time.sleep(0.3)
            result["ok"] = True
        except DeadlineExceeded as e:
            result["err"] = e

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=5)
    assert isinstance(result.get("err"), DeadlineExceeded)


def test_deadline_fault_injectable_via_slow():
    with faults.inject("slow_site", "slow", delay=0.5):
        with pytest.raises(DeadlineExceeded):
            with resilience.deadline("slow_site", 0.15):
                faults.maybe_fail("slow_site")


def test_a_blown_first_launch_demotes_the_engine_for_its_shape(
        monkeypatch):
    bs = _bs()
    U = [torch.from_numpy(u) for u in _init(bs.dims)]
    real = tmttkrp._run_engine

    def slow_fused_t(engine, *a):
        if engine == "fused_t":
            time.sleep(0.5)
        return real(engine, *a)

    monkeypatch.setattr(tmttkrp, "_run_engine", slow_fused_t)
    resilience.set_deadline(0.15)
    got = tmttkrp.mttkrp(bs, U, bs.layouts[0].mode)
    monkeypatch.setattr(tmttkrp, "_run_engine", real)
    want = tmttkrp.mttkrp(bs, U, bs.layouts[0].mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-10)
    dem = resilience.run_report().events("engine_demotion")
    assert [(e["engine"], e["failure_class"]) for e in dem] == [
        ("fused_t", "timeout")]
    assert dem[0]["shape_key"] is not None
    assert resilience.run_report().events("deadline_blown")


# -- scopes ------------------------------------------------------------------


def test_scopes_isolate_demotions_attempts_and_reports():
    resilience.demote_engine("fused_tg", RuntimeError("Mosaic failed"))
    with resilience.scope("a") as a:
        assert resilience.current_job() == "a"
        assert not resilience.is_demoted("fused_tg")
        resilience.note_engine_attempt("fused_t", "k")
        resilience.run_report().add("transient_retry", label="x", attempt=1)
    assert resilience.current_job() is None
    assert resilience.last_engine_attempt() != ("fused_t", "k")
    assert resilience.is_demoted("fused_tg")
    assert a.report.events()[0]["job"] == "a"
    assert not resilience.run_report().events("transient_retry")


def test_profiled_sweep_equals_fused_and_jax(capsys):
    jt, tt = _tensor()
    init = _init(tt.dims)
    fused = _port(tt, _opts(max_iterations=4), init)
    timers.reset()
    trace.set_enabled(True)
    prof = _port(tt, _opts(max_iterations=4, verbosity=Verbosity.HIGH),
                 init)
    want = _jax(jt, _jopts(max_iterations=4, verbosity=JVerbosity.HIGH),
                init)
    capsys.readouterr()
    np.testing.assert_allclose(prof.fits, fused.fits, atol=1e-12)
    assert prof.fit == pytest.approx(float(want.fit), abs=1e-9)
    for a, b, c in zip(prof.factors, fused.factors, want.factors):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-8)
    for name in ("mttkrp", "solve", "normalize", "gram", "fit",
                 "mttkrp_mode0", "mttkrp_mode1", "mttkrp_mode2"):
        assert timers[name] > 0.0, name
    # the warm-up sweeps (2 of them) ran but were zeroed out
    spans = trace.spans("timer.mttkrp")
    assert len(spans) == 3 * (4 + 2)
    warm = sum(r["dur"] for r in spans[6:])
    assert timers["mttkrp"] == pytest.approx(warm, rel=0.05)
    assert timers["mttkrp"] < sum(r["dur"] for r in spans)


@pytest.mark.parametrize("kind", ["fine", "medium"])
def test_distributed_profiled_sweep_equals_the_plain_one(kind, capsys):
    """At Verbosity.HIGH FINE and MEDIUM run their profiled sweeps: the
    same model as the plain sweep, every phase timer of the report above
    zero after the first (warm-up) step was zeroed."""
    from splatt_tpu_torch.config import Decomposition
    from splatt_tpu_torch.parallel import distributed_cpd_als
    from splatt_tpu_torch.parallel.common import (DIST_TIMER_NAMES,
                                                  dist_phase_report)
    from splatt_tpu_torch.parallel.mesh import make_mesh

    _, tt = _tensor()
    init = _init(tt.dims)
    decomp = Decomposition.FINE if kind == "fine" else Decomposition.MEDIUM
    grid = None if kind == "fine" else (2, 2, 1)

    def run(verbosity):
        return distributed_cpd_als(
            tt, RANK, opts=_opts(max_iterations=4, decomposition=decomp,
                                 verbosity=verbosity),
            init=init, grid=grid, mesh=make_mesh(n_devices=4, device="cpu"),
            local_engine="blocked")

    plain = run(Verbosity.NONE)
    for name in DIST_TIMER_NAMES:
        timers.get(name).reset()
    prof = run(Verbosity.HIGH)
    text = capsys.readouterr().out
    assert "distributed phase times (in-loop totals, warm iterations):" \
        in text
    np.testing.assert_allclose(prof.fits, plain.fits, atol=1e-12)
    for a, b in zip(prof.factors, plain.factors):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    want = {"dist_mttkrp", "dist_comm", "dist_update", "dist_fit"}
    if kind == "fine":
        want.add("dist_gather")
    assert all(timers.get(n).seconds > 0 for n in want)
    assert len(dist_phase_report()) == 1 + len(want)
