"""The port's flight recorder and replica-stamped traces
(``splatt_tpu_torch/trace.py``) against the JAX package's, on the CPU.

- A ring written by one package, its rotated ``.1`` generation included,
  reads back to the same events through either package's ``load_flight``;
  a torn final line is skipped by both.
- A failing flush (the ``trace.flight`` fault site) disarms the recorder
  with a classified ``flight_degraded`` event in both packages.
- ``expand_trace_paths`` finds the same sources in a serve spool (Chrome
  exports, ``fleet/flight/`` rings, a ring whose live file is gone), and
  ``merge_trace_files`` and the ``trace`` verb merge a JAX ring and a port
  ring onto the JAX package's timeline, the adoption's flow included.
- The Chrome export names its process row after the replica and stamps
  every span and point with it.
"""

import json
import os

import pytest

from splatt_tpu import cli as jcli
from splatt_tpu import resilience as jres
from splatt_tpu import trace as jtrace
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import cli, resilience, trace
from splatt_tpu_torch.utils import faults

PACKAGES = {"port": (trace, resilience, faults),
            "jax": (jtrace, jres, jfaults)}


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for mod in (trace, jtrace):
            mod.set_flight(None)
            mod.set_replica(None)
            mod.set_enabled(None)
            mod.reset()
            mod.reset_metrics()
        for mod in (resilience, jres):
            mod.run_report().clear()
        for mod in (faults, jfaults):
            mod.reset()
    reset()
    yield
    reset()


def _record(name: str, path: str, rid: str, max_bytes: int = 1 << 20,
            n: int = 12) -> None:
    """Package `name` records a replica's spans and points into a ring at
    `path`, one flush per record."""
    tr, res, _ = PACKAGES[name]
    tr.set_enabled(True)
    tr.set_replica(rid)
    tr.set_flight(path, max_bytes=max_bytes, flush_every=1)
    with res.scope("job7"):
        with tr.span("serve.job", job="job7", resumed=False):
            res.run_report().add("job_started", job="job7",
                                 resumed=False)
            for i in range(n):
                with tr.span("cpd.iter", it=i + 1):
                    pass
    res.run_report().add("job_adopted", job="job7", replica=rid,
                         from_replica="rz")
    tr.flight_flush()
    tr.set_flight(None)
    tr.set_replica(None)
    tr.set_enabled(None)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rings_read_back_the_same_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "r1.jsonl")
    _record(writer, path, "r1")
    got, want = trace.load_flight(path), jtrace.load_flight(path)
    assert got == want
    names = [e["name"] for e in got]
    assert names.count("cpd.iter") == 12 and "job_started" in names
    assert "job_adopted" in names and "serve.job" in names
    assert all(e["args"]["replica"] == "r1" for e in got)
    started = [e for e in got if e["name"] == "job_started"][0]
    assert started["args"]["job"] == "job7" and started["ph"] == "i"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_rotated_ring_reads_its_older_generation_first(tmp_path, writer):
    path = str(tmp_path / "r1.jsonl")
    _record(writer, path, "r1", max_bytes=2048, n=40)
    assert os.path.exists(path + ".1")
    got = trace.load_flight(path)
    assert got == jtrace.load_flight(path)
    its = [e["args"]["it"] for e in got if e["name"] == "cpd.iter"]
    assert its == sorted(its) and its[-1] == 40 and len(its) < 40
    # only the rotated generation left: the ring is still named by its base
    os.remove(path)
    older = trace.load_flight(path)
    assert older and older == jtrace.load_flight(path)
    with pytest.raises(FileNotFoundError):
        trace.load_flight(str(tmp_path / "absent.jsonl"))


def test_both_packages_skip_a_torn_final_line(tmp_path):
    path = str(tmp_path / "r1.jsonl")
    _record("port", path, "r1", n=3)
    whole = trace.load_flight(path)
    with open(path, "ab") as f:
        f.write(b'{"name": "cpd.iter", "ph": "X", "ts": 1')
    assert trace.load_flight(path) == whole == jtrace.load_flight(path)


@pytest.mark.parametrize("name", ["port", "jax"])
def test_a_failing_flush_disarms_the_recorder_classified(tmp_path, name):
    tr, res, fmod = PACKAGES[name]
    path = str(tmp_path / "r1.jsonl")
    tr.set_enabled(True)
    tr.set_flight(path, flush_every=1)
    with fmod.inject("trace.flight", "runtime", times=1):
        with tr.span("cpd.iter", it=1):
            pass
    assert tr.flight_path() is None
    evs = res.run_report().events("flight_degraded")
    assert len(evs) == 1 and evs[0]["path"] == path
    assert evs[0]["failure_class"]
    with tr.span("cpd.iter", it=2):
        pass                       # disarmed: the run goes on, no ring
    assert not os.path.exists(path)


def test_the_chrome_export_is_stamped_with_the_replica(tmp_path):
    trace.set_enabled(True)
    trace.set_replica("r3")
    with trace.span("serve.job", job="j1"):
        resilience.run_report().add("job_started", job="j1")
    evs = trace.chrome_events()
    assert evs[0] == {"name": "process_name", "ph": "M", "ts": 0,
                      "pid": os.getpid(),
                      "args": {"name": "replica r3"}}
    assert all(e["args"]["replica"] == "r3" for e in evs[1:])
    out = str(tmp_path / "t.json")
    trace.write_chrome_trace(out)
    # the JAX package names the source after the replica too
    assert jtrace.merge_trace_files([out])[0]["args"]["name"] == \
        "replica r3"


def _spool(tmp_path) -> str:
    """A spool with a JAX ring (r0, rotated away), a port ring (r1) and a
    port Chrome export; the adoption's flow runs r0 -> r1."""
    root = tmp_path / "spool"
    fdir = root / "fleet" / "flight"
    fdir.mkdir(parents=True)
    r0 = str(fdir / "r0.jsonl")
    _record("jax", r0, "r0", n=3)
    os.replace(r0, r0 + ".1")
    jtrace.set_enabled(True)
    trace.set_enabled(True)
    trace.set_replica("r1")
    with trace.span("serve.job", job="job7", adopted_from="r0"):
        pass
    trace.set_flight(str(fdir / "r1.jsonl"), flush_every=1)
    with trace.span("cpd.iter", it=4):
        pass
    trace.flight_flush()
    trace.set_flight(None)
    trace.write_chrome_trace(str(root / "trace-r1.json"))
    trace.set_replica(None)
    (root / "journal.jsonl").write_text('{"rec": "accepted", "job": "x"}\n')
    return str(root)


def test_a_spools_sources_expand_and_merge_as_the_jax_package(tmp_path):
    root = _spool(tmp_path)
    got = trace.expand_trace_paths([root])
    assert got == jtrace.expand_trace_paths([root])
    # the journal is swept up too, and merges into no row
    assert [os.path.basename(p) for p in got] == [
        "trace-r1.json", "journal.jsonl", "r0.jsonl", "r1.jsonl"]
    ring1 = os.path.join(root, "fleet", "flight", "r0.jsonl.1")
    assert trace.expand_trace_paths([ring1]) == [ring1[:-2]]
    merged = trace.merge_trace_files(got)
    want = jtrace.merge_trace_files(got)
    assert merged == want
    flows = [e for e in merged if e.get("cat") == "fleet"]
    assert [e["ph"] for e in flows] == ["s", "f"]
    assert flows[0]["args"] == {"job": "job7", "from_replica": "r0"}


def test_the_trace_verb_reads_rings_as_the_jax_cli(tmp_path, capsys):
    root = _spool(tmp_path)
    out = str(tmp_path / "merged.json")
    assert cli.main(["trace", root, "--json", "--out", out]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(["trace", root, "--json"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["points"]["job_started"] == 1
    assert set(got["fleet"]["replicas"]) == {"r0", "r1"}
    assert trace.load_trace(out) == jtrace.merge_trace_files(
        jtrace.expand_trace_paths([root]))
    # one ring alone is read as a ring, not as a Chrome export
    ring = os.path.join(root, "fleet", "flight", "r1.jsonl")
    assert cli.main(["trace", ring, "--json"]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["names"]["cpd.iter"]["count"] == 1
