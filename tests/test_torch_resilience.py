"""The port's resilience layer and fault harness against the JAX package's:
the same failure classes on the same messages, the same fault grammar and
firing schedules, retries of transient failures only, and the demotion
registry's scopes."""

import numpy as np
import pytest

from splatt_tpu import resilience as jres
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import resilience
from splatt_tpu_torch.utils import env, faults


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SPLATT_FAULTS", raising=False)
    monkeypatch.delenv("SPLATT_ENGINE_FALLBACK", raising=False)
    faults.reset()
    resilience.reset_demotions()
    resilience.run_report().clear()
    yield
    faults.reset()
    resilience.reset_demotions()
    resilience.run_report().clear()


MESSAGES = [
    "CUDA out of memory. Tried to allocate 3.73 GiB. GPU 0 has a total "
    "capacity of 79.19 GiB of which 1.02 GiB is free.",
    "OutOfMemoryError: CUDA out of memory. Tried to allocate 128.00 MiB",
    "RESOURCE_EXHAUSTED: Attempting to allocate 9.5G",
    "XLA:TPU compile failed: HTTP code 500 from remote compile service",
    "INTERNAL: Mosaic failed to compile TPU kernel",
    "INTERNAL: the relay dropped the connection",
    "UNAVAILABLE: injected relay failure",
    "Connection reset by peer",
    "splatt deadline blown at engine.fused_t after 5s",
    "non-finite factors at iteration 3",
    "CUDA error: an illegal memory access was encountered",
    "splatt_fused_mttkrp_t_f32: the card refused the launch "
    "(cudaErrorLaunchOutOfResources = 701)",
    "injected engine runtime failure at engine.fused_t",
    "NotImplementedError: no kernel for bf16",
    "something else entirely",
]


@pytest.mark.parametrize("msg", MESSAGES)
def test_classify_failure_matches_jax(msg):
    assert resilience.classify_failure(msg).value == \
        jres.classify_failure(msg).value


@pytest.mark.parametrize("kind", faults.RAISING_KINDS)
def test_canned_faults_classify_as_jax(kind):
    mine = faults._canned(kind, "engine.fused_t")
    theirs = jfaults._canned(kind, "engine.fused_t")
    assert resilience.failure_message(mine) == jres.failure_message(theirs)
    assert resilience.classify_failure(mine).value == \
        jres.classify_failure(theirs).value


def test_torch_oom_classifies_as_resource():
    import torch

    e = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                               "2.00 GiB")
    assert resilience.classify_failure(e) is \
        resilience.FailureClass.RESOURCE


SCHEDULES = [
    "engine.fused_t:runtime",
    "engine.fused_t:runtime,engine.fused_tg:oom:3",
    "engine.fused_t:http500:*",
    "engine.xla_scan:iter=3",
    "engine.fused:p=0.25:seed=7",
    "engine.unfused_pallas:slow:delay=0.5:after=2",
    "engine.fused_tg:nan:times=*",
    "engine.fused_t:mosaic:2,engine.xla_scan:inf",
]


@pytest.mark.parametrize("text", SCHEDULES)
def test_schedule_round_trips_as_jax(text):
    mine = faults.parse_schedule(text)
    theirs = jfaults.parse_schedule(text)
    assert faults.format_schedule(mine) == jfaults.format_schedule(theirs)
    assert faults.format_schedule(
        faults.parse_schedule(faults.format_schedule(mine))) == \
        faults.format_schedule(mine)
    for site, spec in mine.items():
        other = theirs[site]
        for f in ("kind", "times", "iter_at", "p", "seed", "after",
                  "delay"):
            assert getattr(spec, f) == getattr(other, f), (site, f)


@pytest.mark.parametrize("bad", ["engine.fused_t", ":runtime",
                                 "engine.fused_t:bogus",
                                 "engine.fused_t:iter=0",
                                 "engine.fused_t:p=2",
                                 "engine.fused_t:runtime:color=red"])
def test_bad_spec_raises_as_jax(bad):
    with pytest.raises(ValueError):
        jfaults.parse_spec(bad)
    with pytest.raises(ValueError):
        faults.parse_spec(bad)


def _firing_pattern(mod, schedule: str, calls: int):
    mod.reset()
    for site, spec in mod.parse_schedule(schedule).items():
        mod.arm(site, spec)
    pattern = []
    for _ in range(calls):
        try:
            mod.maybe_fail("engine.fused_t")
            pattern.append(0)
        except (RuntimeError, TimeoutError):
            pattern.append(1)
    mod.reset()
    return pattern


@pytest.mark.parametrize("schedule", ["engine.fused_t:runtime",
                                      "engine.fused_t:runtime:3",
                                      "engine.fused_t:iter=4",
                                      "engine.fused_t:p=0.4:seed=11:*",
                                      "engine.fused_t:timeout:*"])
def test_firing_schedule_matches_jax(schedule):
    assert _firing_pattern(faults, schedule, 12) == \
        _firing_pattern(jfaults, schedule, 12)


def test_env_arms_faults_and_marks_them(monkeypatch):
    monkeypatch.setenv("SPLATT_FAULTS",
                       "engine.fused_t:oom,engine.bad:bogus")
    faults.reset()
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as ei:
        faults.maybe_fail("engine.fused_t")
    assert faults.injected(ei.value)
    faults.maybe_fail("engine.fused_t")   # times=1: spent
    assert not faults.injected(RuntimeError("real"))


def test_poison_claims_only_poison_kinds():
    import torch

    with faults.inject("engine.xla", "nan"):
        faults.maybe_fail("engine.xla")     # a raising hook never claims it
        out = faults.poison("engine.xla", torch.ones(3))
    assert torch.isnan(out).all()
    assert torch.equal(faults.poison("engine.xla", torch.ones(3)),
                       torch.ones(3))


@pytest.mark.parametrize("kind", faults.RAISING_KINDS)
def test_retry_transient_retries_only_transient(kind):
    calls = []
    slept = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise faults._canned(kind, "engine.fused_t")
        return "ok"

    transient = (resilience.classify_failure(faults._canned(kind, "x"))
                 is resilience.FailureClass.TRANSIENT)
    if transient:
        assert resilience.retry_transient(fn, sleep=slept.append,
                                          rng=lambda: 0.5) == "ok"
        assert len(calls) == 2 and slept == [0.25]
        assert len(resilience.run_report().events("transient_retry")) == 1
    else:
        with pytest.raises(Exception):
            resilience.retry_transient(fn, sleep=slept.append)
        assert len(calls) == 1 and slept == []


def test_retry_transient_gives_up_after_budget():
    calls = []

    def fn():
        calls.append(1)
        raise RuntimeError("UNAVAILABLE: still down")

    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        resilience.retry_transient(fn, attempts=3, sleep=lambda s: None)
    assert len(calls) == 3


def test_demotion_scope_follows_failure_class():
    resilience.demote_engine("fused_t", RuntimeError("CUDA out of memory"),
                             shape_key="r64:b4096")
    assert resilience.is_demoted("fused_t", "r64:b4096")
    assert not resilience.is_demoted("fused_t", "r64:b128")
    resilience.demote_engine("fused_tg", RuntimeError("injected runtime"),
                             shape_key="r64:b4096")
    assert resilience.is_demoted("fused_tg", "r64:b128")
    assert resilience.is_demoted("fused_tg")
    evs = resilience.run_report().events("engine_demotion")
    assert [(e["engine"], e["failure_class"], e["shape_key"])
            for e in evs] == [("fused_t", "resource", "r64:b4096"),
                              ("fused_tg", "unknown", None)]
    assert len(resilience.run_report().summary()) == 2
    resilience.reset_demotions()
    assert not resilience.demotions()


@pytest.mark.parametrize("value,on", [(None, True), ("1", True),
                                      ("0", False), ("off", False),
                                      ("No", False), ("yes", True)])
def test_fallback_switch_reads_env_as_jax(monkeypatch, value, on):
    if value is not None:
        monkeypatch.setenv("SPLATT_ENGINE_FALLBACK", value)
    jres.set_fallback(None)
    assert resilience.fallback_enabled() is on
    assert jres.fallback_enabled() is on


def test_env_registry_defaults_match_jax():
    from splatt_tpu.utils import env as jenv

    for name, var in env.ENV_VARS.items():
        assert var.default == jenv.ENV_VARS[name].default, name
    with pytest.raises(KeyError):
        env.read_env("SPLATT_NOT_DECLARED")
    assert np.isscalar(env.read_env("SPLATT_ENGINE_FALLBACK"))
