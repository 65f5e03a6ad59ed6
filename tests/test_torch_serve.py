"""The port's serve daemon against the JAX package's, on the CPU.

- One sequence of submissions (an accepted cpd, an invalid spec, a tenant
  over its quota, a full queue, priority order, a predict before and one
  after an update, a predict of an unknown model, a ``batch_min`` batch)
  goes through both packages' ``Server`` in two spools: the journals'
  record kinds, in order, and each result's status and keys match, and
  so do its numbers: every fit, the predicted values and top-k scores,
  and the model the update committed.  The port draws a seeded init
  from torch's generator and the JAX package from ``jax.random``, so
  for this sequence the port's ``init_factors`` is made to draw the JAX
  package's numbers.  From one init the port (f32) and the JAX package
  (f64, as the tests' x64 and f64 data make it) agree within 7.5e-7 of
  max|.| and 7e-8 in the fits; from their own draws they part by 3e-4
  to 7e-3 in the fits and by more than max|.| in the factors.
- A journal and spool written by the JAX package (torn tail and an
  unknown record kind included) are replayed by the port's ``Server`` to
  the JAX package's state map, and the port runs the resumed jobs.
- ``_merge_delta`` + ``_save_model_tensor`` give the JAX package's
  payload digest, and each package loads the other's model tensor.
- ``kind: "ingest"`` and the ``chaos`` soaks other than ``--fleet``
  refuse, naming ROADMAP queue A item 15.3; ``serve --fleet --once`` runs
  (fleet mode itself is held against the JAX package in
  ``tests/test_torch_fleet.py``); a spec's ``use_pallas`` is accepted and
  has no effect.
- ``serve --once`` and ``predict --wait`` run on ``--device cpu`` and
  print the JAX CLI's JSON keys.

The JAX side of each sequence runs once per module; every wait is
bounded and every server is drained.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from splatt_tpu import chaos as jchaos
from splatt_tpu import cli as jcli
from splatt_tpu import resilience as jres
from splatt_tpu import serve as jserve
from splatt_tpu import tune as jtune
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import chaos, cli, resilience, serve, tune
from splatt_tpu_torch.utils import faults
from tests.torch_fixtures import private_tune_cache  # noqa: F401

#: the two packages' served numbers from one init on the CPU: fits
#: (~0.1) within FIT_TOL, values, scores and factors within REL_TOL of
#: max|.| of the JAX package's
FIT_TOL = 1e-6
REL_TOL = 1e-5
DIMS = [14, 11, 9]
SYN = {"dims": DIMS, "nnz": 300, "seed": 0}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean():
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()


@pytest.fixture(autouse=True)
def _clean_state():
    _clean()
    yield
    _clean()


def _spec(jid, **kw):
    spec = {"id": jid, "rank": 3, "iters": 4, "tol": 0.0, "seed": 0,
            "synthetic": dict(SYN)}
    spec.update(kw)
    return spec


def _server(mod, root, **kw):
    if mod is serve:
        kw.setdefault("device", "cpu")
    return mod.Server(root, **kw)


def _sequence(mod, root):
    """The submissions of the differential run, in three rounds, each
    drained by run_once on one worker.  Returns {job: submit reply}."""
    srv = _server(mod, root, workers=1, queue_max=4, tenant_quota=2,
                  batch_min=3)
    replies = {}

    def submit(spec):
        replies[spec["id"]] = srv.submit(spec)

    # round 1: admission (checkpoint_every keeps these out of a batch)
    ck = dict(checkpoint_every=2)
    submit(_spec("m1", tenant="a", **ck))
    submit({"id": "bad", "rank": 3})
    submit(_spec("a2", tenant="a", priority="low", **ck))
    submit(_spec("a3", tenant="a", **ck))                    # over quota
    submit(_spec("hi", tenant="b", priority="high",
                 synthetic=dict(SYN, seed=1), **ck))
    submit(_spec("n4", tenant="c", synthetic=dict(SYN, seed=2), **ck))
    submit(_spec("full", tenant="d", **ck))                  # queue full
    submit(_spec("badprio", priority="urgent"))
    submit(_spec("badfaults", faults="engine.x:nonsense"))
    srv.run_once()
    # round 2: predict before the update runs (the lane goes first),
    # the update, then a predict after it and one of an unknown model
    submit({"id": "p1", "kind": "predict", "model": "m1",
            "coords": [[0, 1, 2], [3, 4, 5]],
            "top_k": {"mode": 0, "k": 3, "fixed": {"1": 2, "2": 3}}})
    submit({"id": "u1", "kind": "update", "base": "m1",
            "delta": {"dims": DIMS, "nnz": 20, "seed": 9}})
    srv.run_once()
    submit({"id": "p2", "kind": "predict", "model": "m1",
            "coords": [[0, 1, 2]]})
    submit({"id": "p3", "kind": "predict", "model": "nosuch",
            "coords": [[0, 0, 0]]})
    srv.run_once()
    # round 3: three batchable jobs of one regime run as one batch
    for i in range(3):
        submit(_spec(f"b{i}", rank=2, tenant=f"t{i}",
                     synthetic=dict(SYN, seed=10 + i)))
    summary = srv.run_once()
    srv.shutdown()
    return replies, summary


def _journal(root):
    recs, torn = jserve.Journal(os.path.join(root,
                                             "journal.jsonl")).replay()
    assert torn == 0
    return recs


def _jax_draw(dims, rank, generator, dtype=None, device=None):
    """The port's init_factors drawing the JAX package's numbers for the
    generator's seed (``splatt_tpu.cpd.init_factors``; in f64, as the JAX
    package draws and computes with x64 on and f64 data, rounded to the
    port's dtype)."""
    import jax
    import torch

    key = jax.random.PRNGKey(generator.initial_seed())
    return [torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, m), (d, rank), dtype="float64"))).to(
        device, dtype or torch.float32) for m, d in enumerate(dims)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sequence through both packages, each in its own spool, with
    private plan caches, the port's seeded init the JAX package's."""
    from splatt_tpu_torch import cpd as pcpd

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pcpd, "init_factors", _jax_draw)
        base = tmp_path_factory.mktemp("serve_seq")
        mp.setenv("SPLATT_TUNE_CACHE", str(base / "tc.json"))
        mp.setenv("SPLATT_PROBE_CACHE", str(base / "pc.json"))
        for name, mod in (("jax", jserve), ("port", serve)):
            tune.reset_memo()
            jtune.reset_memo()
            _clean()
            root = str(base / name)
            replies, summary = _sequence(mod, root)
            out[name] = dict(root=root, replies=replies, summary=summary,
                             journal=_journal(root))
        tune.reset_memo()
        jtune.reset_memo()
    return out


def test_sequence_journals_the_same_record_kinds(runs):
    got = [(r["rec"], r["job"]) for r in runs["port"]["journal"]]
    want = [(r["rec"], r["job"]) for r in runs["jax"]["journal"]]
    assert got == want
    # the batch members' STARTED records name the leader in both
    for name in ("port", "jax"):
        batch = {r["job"]: r.get("batch") for r in runs[name]["journal"]
                 if r["rec"] == "started" and r["job"].startswith("b")}
        assert batch == {"b0": "b0", "b1": "b0", "b2": "b0"}


def test_sequence_replies_and_summaries_match(runs):
    assert runs["port"]["replies"] == runs["jax"]["replies"]
    assert runs["port"]["summary"] == runs["jax"]["summary"]
    replies = runs["port"]["replies"]
    assert replies["a3"]["reason"] == "quota:a"
    assert replies["full"]["reason"] == "queue_full"
    assert replies["bad"]["state"] == "rejected"


def test_sequence_runs_in_priority_order(runs):
    for name in ("port", "jax"):
        started = [r["job"] for r in runs[name]["journal"]
                   if r["rec"] == "started"]
        assert started[:4] == ["hi", "m1", "n4", "a2"], name


JOBS = ("m1", "bad", "a2", "a3", "hi", "n4", "full", "badprio",
        "badfaults", "p1", "u1", "p2", "p3", "b0", "b1", "b2")


@pytest.mark.parametrize("jid", JOBS)
def test_sequence_results_have_the_same_status_and_keys(runs, jid):
    got = serve.read_result(runs["port"]["root"], jid)
    want = jserve.read_result(runs["jax"]["root"], jid)
    assert got["status"] == want["status"]
    assert set(got) == set(want)
    for key in ("reason", "gen", "gen_pinned", "model", "model_gen",
                "cache"):
        assert got.get(key) == want.get(key), key
    if "batched" in want:
        assert {k: v for k, v in got["batched"].items()
                if k != "compiles"} == {
            k: v for k, v in want["batched"].items() if k != "compiles"}
    assert serve.read_status(runs["port"]["root"], jid)["status"] == \
        jserve.read_status(runs["jax"]["root"], jid)["status"]
    # the numbers: every fit (cpd, update and batch members), the
    # predicted values and the top-k
    if "fit" in want:
        assert abs(got["fit"] - want["fit"]) <= FIT_TOL
    if "values" in want:
        w = np.asarray(want["values"])
        np.testing.assert_allclose(got["values"], w, rtol=0,
                                   atol=REL_TOL * np.abs(w).max())
    if want.get("top_k"):
        assert got["top_k"]["indices"] == want["top_k"]["indices"]
        w = np.asarray(want["top_k"]["scores"])
        np.testing.assert_allclose(got["top_k"]["scores"], w, rtol=0,
                                   atol=REL_TOL * np.abs(w).max())


def test_sequence_update_commits_the_jax_packages_model(runs):
    from splatt_tpu_torch.cpd import load_checkpoint

    got = load_checkpoint(os.path.join(runs["port"]["root"], "ckpt",
                                       "m1.npz"))
    with np.load(os.path.join(runs["jax"]["root"], "ckpt", "m1.npz")) as z:
        want = [z[f"factor{m}"] for m in range(len(DIMS))] + [z["lam"]]
    for g, w in zip(list(got[0]) + [got[1]], want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL_TOL * np.abs(w).max())


def test_sequence_predicts_serve_the_generation_of_the_moment(runs):
    root = runs["port"]["root"]
    p1, u1, p2 = (serve.read_result(root, j) for j in ("p1", "u1", "p2"))
    assert p1["gen"] == 1 and u1["model_gen"] == 2 and p2["gen"] == 2
    assert p1["sha"] != p2["sha"]
    assert len(p1["values"]) == 2 and len(p1["top_k"]["indices"]) == 3
    assert serve.read_result(root, "p3")["reason"] == \
        "no_intact_generation"
    # the update committed through the model store in both packages
    for name in ("port", "jax"):
        ck = os.path.join(runs[name]["root"], "ckpt")
        assert os.path.exists(os.path.join(ck, "m1.model.npz"))
        assert json.load(open(os.path.join(ck, "m1.gen.json")))["gen"] == 2


# -- the model store's tensor ------------------------------------------------

def test_synthetic_workloads_are_the_jax_packages():
    got = chaos.synthetic_tensor(DIMS, 300, 3)
    want = jchaos.synthetic_tensor(DIMS, 300, 3)
    np.testing.assert_array_equal(got.inds, want.inds)
    np.testing.assert_array_equal(got.vals, want.vals)
    assert got.dims == want.dims


def test_model_tensor_digest_matches_and_loads_both_ways(tmp_path):
    base = chaos.synthetic_tensor(DIMS, 300, 3)
    delta = chaos.synthetic_tensor(DIMS, 40, 4)
    jbase = jchaos.synthetic_tensor(DIMS, 300, 3)
    jdelta = jchaos.synthetic_tensor(DIMS, 40, 4)
    merged = serve._merge_delta(base, delta)
    jmerged = jserve._merge_delta(jbase, jdelta)
    port_path = str(tmp_path / "port.model.npz")
    jax_path = str(tmp_path / "jax.model.npz")
    serve._save_model_tensor(port_path, merged, ["u1", "u2"])
    jserve._save_model_tensor(jax_path, jmerged, ["u1", "u2"])
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert str(a["checksum"]) == str(b["checksum"])
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for load, path in ((serve._load_model_tensor, jax_path),
                       (jserve._load_model_tensor, port_path)):
        tt, applied = load(path)
        assert applied == ["u1", "u2"]
        np.testing.assert_array_equal(np.asarray(tt.inds), merged.inds)
        assert tuple(tt.dims) == merged.dims
    # a torn model tensor is skipped classified, as in the JAX package
    with open(port_path, "r+b") as f:
        f.truncate(100)
    assert serve._load_model_tensor(port_path) == (None, [])
    assert resilience.run_report().events("model_torn")[-1]["piece"] == \
        "model-tensor"
    with pytest.raises(ValueError, match="past the model's dim"):
        serve._merge_delta(chaos.synthetic_tensor([4, 4, 4], 20, 1),
                           chaos.synthetic_tensor([9, 4, 4], 20, 1))


# -- replay of the JAX package's journal -------------------------------------

def test_port_replays_a_jax_journal(tmp_path):
    src = str(tmp_path / "jax")
    js = jserve.Server(src, workers=1)
    js.submit(_spec("done1"))
    js.run_once()
    js.submit(_spec("queued1", synthetic=dict(SYN, seed=3)))
    js.submit({"id": "pq", "kind": "predict", "model": "done1",
               "coords": [[1, 1, 1]]})
    js.submit({"id": "rej"})
    js.shutdown()
    with open(os.path.join(src, "journal.jsonl"), "a") as f:
        f.write('{"rec": "paused_v99", "job": "done1", "ts": 1.0}\n')
        f.write('{"rec": "acce')   # torn mid-append
    copies = {}
    for name in ("jax", "port"):
        copies[name] = str(tmp_path / f"copy_{name}")
        shutil.copytree(src, copies[name])
    _clean()
    jre = jserve.Server(copies["jax"], workers=1)
    want = jre.summary()
    want_resumed = sorted(e["job"] for e in
                          jres.run_report().events("job_resumed"))
    port = serve.Server(copies["port"], workers=1, device="cpu")
    got = port.summary()
    assert got == want
    assert sorted(e["job"] for e in resilience.run_report().events(
        "job_resumed")) == want_resumed == ["pq", "queued1"]
    assert [e["record_kind"] for e in resilience.run_report().events(
        "journal_unknown_kind")] == ["paused_v99"]
    assert len(resilience.run_report().events("journal_torn")) == 1
    assert port.status("queued1")["resumed"] is True
    # the port runs what the JAX package left
    final = port.run_once()
    port.shutdown()
    assert final["counts"] == {"done": 3, "rejected": 1}
    assert serve.read_result(copies["port"], "pq")["status"] == "served"
    recs, torn = serve.Journal(os.path.join(copies["port"],
                                            "journal.jsonl")).replay()
    # the port's appends healed the torn tail: it stays one torn line
    assert torn == 1
    kinds = [r["rec"] for r in recs if r.get("job") == "queued1"]
    assert kinds == ["accepted", "resumed", "started", "done"]
    jre.shutdown()


# -- what this slice leaves out ----------------------------------------------

def test_fleet_and_ingest_refuse_naming_the_roadmap(tmp_path, capsys):
    """Ingest jobs and the non-fleet soaks are item 15.3; fleet mode
    runs (test_serve_fleet_once_runs_a_job)."""
    srv = serve.Server(str(tmp_path), device="cpu")
    rep = srv.submit({"id": "ing", "kind": "ingest", "source": "x.csv"})
    assert rep["state"] == serve.REJECTED and "15.3" in rep["reason"]
    assert serve.read_result(str(tmp_path), "ing")["status"] == "rejected"
    for flag in ([], ["--serve"], ["--ingest"]):
        assert cli.main(["chaos", "--smoke", "--device", "cpu"] + flag) == 2
        assert "15.3" in capsys.readouterr().err


def test_serve_fleet_once_runs_a_job(tmp_path, capsys):
    from splatt_tpu_torch import trace

    root = str(tmp_path)
    serve.file_request(root, _spec("f1"))
    try:
        # the fleet entry arms process-wide tracing, the replica stamp
        # and the flight ring: undone here for the tests that follow
        rc = cli.main(["serve", root, "--once", "--device", "cpu",
                       "--fleet", "--replica", "r1", "--lease", "3",
                       "--heartbeat", "1", "--json"])
    finally:
        trace.set_enabled(None)
        trace.set_flight(None)
        trace.set_replica(None)
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["counts"] == {"done": 1} and summary["replica"] == "r1"
    assert summary["held_leases"] == []
    res = serve.read_result(root, "f1")
    assert res["status"] == "converged" and res["replica"] == "r1"
    kinds = [(r["rec"], r.get("replica")) for r in _journal(root)]
    assert kinds == [("accepted", "r1"), ("started", "r1"), ("done", "r1")]
    # the replica retired on exit and left its flight ring and snapshot
    fleet_dir = os.path.join(root, "fleet")
    assert os.listdir(os.path.join(fleet_dir, "replicas")) == []
    assert os.path.exists(os.path.join(fleet_dir, "flight", "r1.jsonl"))
    assert os.path.exists(os.path.join(fleet_dir, "metrics", "r1.prom"))
    assert any(e["name"] == "job_started" for e in trace.load_flight(
        os.path.join(fleet_dir, "flight", "r1.jsonl")))


def test_use_pallas_is_accepted_and_changes_nothing(tmp_path):
    srv = serve.Server(str(tmp_path), workers=1, device="cpu")
    srv.submit(_spec("plain"))
    srv.submit(_spec("pallas", use_pallas=True))
    assert srv.run_once()["counts"] == {"done": 2}
    a = serve.read_result(str(tmp_path), "plain")
    b = serve.read_result(str(tmp_path), "pallas")
    assert a["status"] == b["status"] == "converged"
    assert a["fit"] == b["fit"]


def test_server_needs_a_card_unless_told_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Server(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["serve", str(tmp_path), "--once"])


def test_job_failures_stay_in_their_job(tmp_path):
    """A job's fault schedule fails that job alone, classified; a faulted
    job with fallback off fails rather than being rescued."""
    srv = serve.Server(str(tmp_path), workers=2, device="cpu")
    srv.submit(_spec("boom", faults="serve.job_run:runtime"))
    srv.submit(_spec("nofb", faults="engine.xla_scan:runtime,"
                     "engine.xla:runtime,engine.fused_t:runtime,"
                     "engine.fused_tg:runtime,"
                     "engine.onehot_reduce:runtime",
                     engine_fallback=False))
    srv.submit(_spec("fine"))
    summary = srv.run_once()
    srv.shutdown()
    assert summary["counts"] == {"done": 1, "failed": 2}
    boom = serve.read_result(str(tmp_path), "boom")
    assert boom["status"] == "failed" and boom["faults_fired"] == {
        "serve.job_run": 1}
    assert serve.read_result(str(tmp_path), "nofb")["status"] == "failed"
    fine = serve.read_result(str(tmp_path), "fine")
    assert fine["status"] == "converged" and fine["demotions"] == []
    assert "faults_fired" not in fine


def test_drain_interrupts_and_a_restart_resumes(tmp_path):
    root = str(tmp_path)
    srv = serve.Server(root, workers=1, device="cpu")
    srv.submit(_spec("d1", iters=6, checkpoint_every=2))
    srv.drain()
    assert srv.run_once()["counts"] == {"accepted": 1}
    srv2 = serve.Server(root, workers=1, device="cpu")
    assert srv2.run_once()["counts"] == {"done": 1}
    res = serve.read_result(root, "d1")
    assert res["status"] == "converged" and res["resumed"] is True


# -- the CLI -----------------------------------------------------------------

def test_cli_serve_once_prints_the_jax_clis_keys(tmp_path, capsys):
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        d = str(tmp_path / name)
        (serve if name == "port" else jserve).file_request(d, _spec("c1"))
        for flags in ([], ["--json"]):
            assert main(["serve", d, "--once"] + flags + extra) == 0
            outs[(name, bool(flags))] = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
    assert outs[("port", False)] == outs[("jax", False)] == {
        "jobs": {"done": 1}, "pending": 0}
    assert outs[("port", True)] == outs[("jax", True)]


def test_cli_predict_wait_answers_through_a_daemon(tmp_path, capsys):
    d = str(tmp_path)
    serve.file_request(d, _spec("m"))
    assert cli.main(["serve", d, "--once", "--device", "cpu"]) == 0
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "splatt_tpu_torch.cli", "predict", d,
         "--model", "m", "--id", "q", "--coords", "0,1,2", "--coords",
         "3,4,5", "--top-k", "3", "--mode", "0", "--fix", "1=2", "--fix",
         "2=3", "--wait", "60"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        req = os.path.join(d, "requests", "q.json")
        end = time.time() + 60
        while not os.path.exists(req) and time.time() < end \
                and proc.poll() is None:
            time.sleep(0.05)
        assert cli.main(["serve", d, "--once", "--device", "cpu"]) == 0
        capsys.readouterr()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    got = json.loads(out.strip().splitlines()[-1])
    assert got["status"] == "served" and got["gen"] == 1
    assert len(got["values"]) == 2 and len(got["top_k"]["scores"]) == 3
    assert set(got) == set(jserve.read_result(d, "q"))
    # the JAX CLI's predict reads the same spool: a filed request and
    # the same reply keys
    assert jcli.main(["predict", d, "--model", "m", "--coords",
                      "0,1,2"]) == 0
    assert set(json.loads(capsys.readouterr().out)) == {"job", "filed"}
