"""The port's streaming ingest (``splatt_tpu_torch/ingest.py`` and serve's
``ingest`` jobs) against the JAX package's, on the CPU.

- One seeded stream in each format (.tns, CSV, JSONL), with string keys in
  mode 0 and malformed records of every class, ingested by both packages
  into two destinations: the same journal records (``ts`` aside), the same
  quarantine sidecar, byte-identical segment and vocab files and a
  byte-identical ``tensor.bin``, and the same summaries.
- A destination half-written by one package (a commit fault mid-stream)
  is resumed exactly once by the other, and each package's
  ``audit_journal`` accepts the other's destination.
- Each fault site (``ingest.read``, ``ingest.vocab``, ``ingest.commit``)
  aborts and then resumes exactly once in both packages.
- Both quarantine budgets degrade the run, classified the same way.
- Both packages' ``Server``s run an ingest job chained to a base model from
  one init (the port's ``init_factors`` draws the JAX package's numbers,
  as in ``tests/test_torch_serve.py``): the same update ids over the same
  chunk ranges, models within FIT_TOL in the fit and REL_TOL of max|.|; a
  killed re-run resumes the update chain exactly once
  (≙ tests/test_ingest.py:491-610).

Streams are a few hundred records; every wait is bounded.
"""

import json
import os

import numpy as np
import pytest

from splatt_tpu import ingest as jingest
from splatt_tpu import resilience as jres
from splatt_tpu import serve as jserve
from splatt_tpu import tune as jtune
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import ingest, resilience, serve, tune
from splatt_tpu_torch.utils import faults
from tests.test_torch_serve import FIT_TOL, REL_TOL, _jax_draw
from tests.torch_fixtures import private_tune_cache  # noqa: F401

PKGS = {"port": (ingest, faults, resilience),
        "jax": (jingest, jfaults, jres)}


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


def _records(rng, n, bad_every):
    """n records as token lists (a string key in mode 0), each
    `bad_every`-th one malformed, cycling through every quarantine class
    (bad arity, a bad token, a negative index, a non-finite value)."""
    bads = (["u1", "2"], ["u1", "3", "3", "abc"], ["u2", "-4", "1", "0.5"],
            ["u3", "1", "1", "nan"])
    out = []
    good = 0
    for i in range(n):
        if bad_every and i and i % bad_every == 0:
            out.append(bads[(i // bad_every) % len(bads)])
        else:
            out.append([f"u{rng.integers(0, 40)}", str(rng.integers(0, 9)),
                        str(rng.integers(0, 7)),
                        f"{rng.random() + 0.1:.6f}"])
            good += 1
    return out, good


def _write(path, fmt, n=300, bad_every=11, seed=0):
    rows, good = _records(np.random.default_rng(seed), n, bad_every)
    with open(path, "w") as f:
        if fmt != "jsonl":
            f.write("# a stream\n\n")
        for r in rows:
            if fmt == "tns":
                f.write(" ".join(r) + "\n")
            elif fmt == "csv":
                f.write(",".join(r) + "\n")
            else:
                f.write(json.dumps(r) + "\n")
    return good, n - good


def _journal(dest):
    recs, torn = jingest.replay_journal(dest)
    assert torn == 0
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def _files(dest):
    """relative path -> bytes of every file under `dest` but the journal."""
    out = {}
    for d, _dirs, names in os.walk(dest):
        for n in names:
            p = os.path.join(d, n)
            rel = os.path.relpath(p, dest)
            if rel != "journal.jsonl":
                with open(p, "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("fmt", ["tns", "csv", "jsonl"])
def test_both_packages_write_the_same_destination(tmp_path, fmt):
    src = str(tmp_path / f"s.{fmt}")
    good, bad = _write(src, fmt)
    sums = {}
    for name, (mod, _f, res) in PKGS.items():
        res.run_report().clear()
        sums[name] = mod.ingest_stream(src, str(tmp_path / name),
                                       chunk_records=40)
        sums[name]["events"] = sorted(
            (e["kind"], e.get("quarantine_class", ""))
            for e in res.run_report().events())
    for s in sums.values():
        s.pop("dest")
        s.pop("tensor")
        s.pop("records_per_sec")
    assert sums["port"] == sums["jax"]
    assert sums["port"]["nnz"] == good and sums["port"]["quarantined"] == bad
    assert sums["port"]["status"] == "converged"
    assert _journal(str(tmp_path / "port")) == _journal(str(tmp_path / "jax"))
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    assert "tensor.bin" in got and "quarantine.jsonl" in got
    assert any(k.startswith("vocab") for k in got)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_a_half_written_destination_resumes_in_the_other_package(
        tmp_path, first, second):
    src = str(tmp_path / "s.tns")
    good, bad = _write(src, "tns", n=200)
    dest = str(tmp_path / "dest")
    mod, fmod, _ = PKGS[first]
    # the third chunk's journal append dies: chunks 0-1 land, chunk 2 not
    with fmod.inject("ingest.commit", "runtime", iter_at=3):
        with pytest.raises(RuntimeError):
            mod.ingest_stream(src, dest, fmt="tns", chunk_records=30)
    for audit in (ingest.audit_journal, jingest.audit_journal):
        aud = audit(dest)
        assert aud["ok"] and aud["watermark"] == 1, aud
    summary = PKGS[second][0].ingest_stream(src, dest, fmt="tns",
                                            chunk_records=30)
    assert summary["resumed"] and summary["status"] == "converged"
    assert summary["nnz"] == good and summary["quarantined"] == bad
    assert summary["records"] == good + bad
    for audit in (ingest.audit_journal, jingest.audit_journal):
        aud = audit(dest)
        assert aud["ok"] and aud["finalized"], aud
        assert aud["nnz"] == good and aud["quarantined"] == bad
    # the same tensor as one uninterrupted run of either package
    clean = str(tmp_path / "clean")
    ingest.ingest_stream(src, clean, fmt="tns", chunk_records=30)
    with open(os.path.join(dest, "tensor.bin"), "rb") as a, \
            open(os.path.join(clean, "tensor.bin"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["port", "jax"])
@pytest.mark.parametrize("site", ["ingest.read", "ingest.vocab",
                                  "ingest.commit"])
def test_each_fault_site_aborts_then_resumes_exactly_once(tmp_path, name,
                                                          site):
    mod, fmod, _ = PKGS[name]
    src = str(tmp_path / "s.tns")
    good, bad = _write(src, "tns", n=48, bad_every=7)
    dest = str(tmp_path / "ing")
    # the second call of each site: one chunk committed before the abort
    with fmod.inject(site, "runtime", iter_at=2):
        with pytest.raises(RuntimeError):
            mod.ingest_stream(src, dest, fmt="tns", chunk_records=12)
    assert mod.audit_journal(dest)["ok"]
    summary = mod.ingest_stream(src, dest, fmt="tns", chunk_records=12)
    assert summary["status"] == "converged" and summary["resumed"]
    assert summary["nnz"] == good and summary["quarantined"] == bad
    aud = mod.audit_journal(dest)
    assert aud["ok"] and aud["nnz"] == good and aud["quarantined"] == bad


@pytest.mark.parametrize("budget", [dict(quarantine_max=3),
                                    dict(quarantine_rate=0.05)])
def test_both_quarantine_budgets_degrade_classified_alike(tmp_path, budget):
    src = str(tmp_path / "s.tns")
    _write(src, "tns", n=400, bad_every=5)
    got = {}
    for name, (mod, _f, res) in PKGS.items():
        res.run_report().clear()
        s = mod.ingest_stream(src, str(tmp_path / name), fmt="tns",
                              chunk_records=50, **budget)
        ev, = res.run_report().events("ingest_degraded")
        got[name] = (s["status"], s["watermark"], s["quarantined"],
                     s["nnz"], s["error"], ev["failure_class"],
                     ev["watermark"], ev["quarantined"])
        assert mod.audit_journal(str(tmp_path / name))["ok"]
    assert got["port"] == got["jax"]
    assert got["port"][0] == "degraded"
    assert got["port"][5] == "deterministic"


def test_vocab_and_policy_replay_from_the_other_packages_journal(tmp_path):
    """A stopped run of one package leaves the vocab and the mode policy
    that the other's IngestState replays."""
    src = str(tmp_path / "s.tns")
    _write(src, "tns", n=120, bad_every=0)
    dest = str(tmp_path / "d")
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > 2

    jingest.ingest_stream(src, dest, fmt="tns", chunk_records=20, stop=stop)
    st = ingest.IngestState(src, dest, fmt="tns", chunk_records=20)
    jst = jingest.IngestState(src, dest, fmt="tns", chunk_records=20)
    for a in ("watermark", "resume_offset", "resume_line", "nnz_total",
              "records_total", "nmodes", "vocab_modes", "vocab",
              "max_index", "resumed"):
        assert getattr(st, a) == getattr(jst, a), a
    assert st.vocab_modes == [True, False, False] and st.watermark >= 0


def test_detect_format_and_parsers_match():
    for name in ("a.csv", "a.JSONL", "b.ndjson", "c.json", "d.tns", "e"):
        assert ingest.detect_format(name) == jingest.detect_format(name)
    lines = [b"1 2 3 0.5\n", b"  # c\n", b"\n", b"a,b , c,1\n",
             b'["u", 1, 2, 0.5]\n']
    for fmt in ("tns", "csv", "jsonl"):
        for raw in lines:
            try:
                want = jingest.PARSERS[fmt](raw)
            except ValueError:
                with pytest.raises(ValueError):
                    ingest.PARSERS[fmt](raw)
                continue
            assert ingest.PARSERS[fmt](raw) == want


# -- serve's ingest jobs, chained to a base model ----------------------------

BASE = {"id": "base", "rank": 3, "iters": 8, "seed": 7, "tol": 0.0,
        "checkpoint_every": 2,
        "synthetic": {"dims": [24, 16, 12], "nnz": 900, "seed": 3}}
DIMS = [24, 16, 12]


def _feed(path, n=40, seed=5):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write(f"{rng.integers(0, 24)} {rng.integers(0, 16)} "
                    f"{rng.integers(0, 12)} {rng.random() + 0.1:.5f}\n")


def _server(mod, root):
    kw = {"device": "cpu"} if mod is serve else {}
    return mod.Server(root, workers=1, **kw)


def _model(root):
    with np.load(os.path.join(root, "ckpt", "base.npz")) as z:
        return [z[f"factor{m}"] for m in range(len(DIMS))] + [z["lam"]]


@pytest.fixture(scope="module")
def chained(tmp_path_factory):
    """The base job and an ingest job chained to it through both packages'
    Servers, each in its own spool, from one init."""
    from splatt_tpu_torch import cpd as pcpd

    base = tmp_path_factory.mktemp("ingest_chain")
    src = str(base / "feed.tns")
    _feed(src)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pcpd, "init_factors", _jax_draw)
        mp.setenv("SPLATT_TUNE_CACHE", str(base / "tc.json"))
        mp.setenv("SPLATT_PROBE_CACHE", str(base / "pc.json"))
        for name, mod in (("jax", jserve), ("port", serve)):
            tune.reset_memo()
            jtune.reset_memo()
            _clean()
            root = str(base / name)
            srv = _server(mod, root)
            assert srv.submit(dict(BASE))["state"] == mod.ACCEPTED
            srv.run_once()
            assert srv.submit({"id": "ing", "kind": "ingest",
                               "source": src, "base": "base",
                               "dims": DIMS, "chunk_records": 10,
                               "update_every": 2})["state"] == mod.ACCEPTED
            srv.run_once()
            srv.shutdown()
            out[name] = root
        tune.reset_memo()
        jtune.reset_memo()
    return out


def test_chained_ingest_emits_the_same_updates(chained):
    got = serve.read_result(chained["port"], "ing")
    want = jserve.read_result(chained["jax"], "ing")
    assert got["status"] == want["status"] == "converged"
    assert got["updates"] == want["updates"] == ["ing-up-0-1", "ing-up-2-3"]
    keys = ("chunks", "watermark", "records", "nnz", "quarantined",
            "resumed", "stopped", "dims", "format")
    assert {k: got["ingest"][k] for k in keys} == \
        {k: want["ingest"][k] for k in keys}
    for name, mod in (("port", serve), ("jax", jserve)):
        recs, torn = mod.Journal(os.path.join(
            chained[name], "ingest", "ing", "deltas",
            "updates.jsonl")).replay()
        assert torn == 0
        assert [(r["lo"], r["hi"], r["id"], r["nnz"]) for r in recs] == [
            (0, 1, "ing-up-0-1", 20), (2, 3, "ing-up-2-3", 20)]
    for uid in got["updates"]:
        g = serve.read_result(chained["port"], uid)
        w = jserve.read_result(chained["jax"], uid)
        assert g["status"] == w["status"] == "converged"
        assert g["model_gen"] == w["model_gen"]
        assert g["update"]["ingest_lag_s"] is not None
        assert abs(g["fit"] - w["fit"]) <= FIT_TOL
        for name in ("port", "jax"):
            with open(os.path.join(chained[name], "ingest", "ing", "deltas",
                                   f"up-{int(uid.split('-')[2]):08d}-"
                                   f"{int(uid.split('-')[3]):08d}.bin"),
                      "rb") as f:
                data = f.read()
            if name == "port":
                port_delta = data
        assert port_delta == data  # byte-identical deltas


def test_chained_ingest_commits_the_jax_packages_model(chained):
    got, want = _model(chained["port"]), _model(chained["jax"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=REL_TOL * np.abs(w).max())
    for name in ("port", "jax"):
        with open(os.path.join(chained[name], "ckpt", "base.gen.json")) as f:
            assert json.load(f)["gen"] == 3


def test_killed_rerun_resumes_the_update_chain_exactly_once(tmp_path):
    """≙ tests/test_ingest.py:533: a stopped ingest job re-runs whole; the
    updates journal keeps the chain exactly-once, the published delta is
    never overwritten, and the ids are the JAX package's."""
    src = str(tmp_path / "s.tns")
    _feed(src)
    spec = {"id": "ing", "kind": "ingest", "source": src, "base": "base",
            "dims": DIMS, "chunk_records": 10, "update_every": 2}
    legs = {}
    for name, mod in (("port", serve), ("jax", jserve)):
        srv = _server(mod, str(tmp_path / name))
        assert srv.submit(dict(BASE))["state"] == mod.ACCEPTED
        srv.run_once()
        calls = {"n": 0}

        def stop_after_two():
            calls["n"] += 1
            return calls["n"] > 2

        r1 = srv._run_ingest("ing", spec, stop_after_two)
        assert r1["ingest"]["stopped"] and r1["ingest"]["watermark"] == 1
        dpath = os.path.join(srv.root, "ingest", "ing", "deltas",
                             "up-00000000-00000001.bin")
        with open(dpath, "rb") as f:
            delta1 = f.read()
        r2 = srv._run_ingest("ing", spec, lambda: False)
        assert r2["ingest"]["resumed"] and r2["ingest"]["watermark"] == 3
        with open(dpath, "rb") as f:
            assert f.read() == delta1
        recs, torn = mod.Journal(os.path.join(
            srv.root, "ingest", "ing", "deltas", "updates.jsonl")).replay()
        spans = [(r["lo"], r["hi"]) for r in recs
                 if r.get("rec") == "update_intent"]
        assert torn == 0 and spans == [(0, 1), (2, 3)]
        srv.run_once()
        for uid in r2["updates"]:
            ur = mod.read_result(srv.root, uid)
            assert ur["status"] == "converged"
            assert ur["update"]["base"] == "base"
        srv.shutdown()
        legs[name] = (r1["updates"], r2["updates"], delta1)
    assert legs["port"] == legs["jax"]
    assert legs["port"][:2] == (["ing-up-0-1"], ["ing-up-0-1", "ing-up-2-3"])


def test_registries_match_the_jax_packages_but_bench_and_probe():
    """Every variable, fault site, event, span and metric of the JAX
    package is the port's, apart from the benchmark's (the port's first
    benchmark PR takes them: the bench_* names and bench.py's
    SPLATT_SCALING_CHILD), those with no counterpart on a GPU (the probe,
    the compile cache, the platform) and the xla_scan target, which the
    port keeps a constant (ops/mttkrp.py SCAN_TARGET_ELEMS)."""
    from splatt_tpu import trace as jtrace
    from splatt_tpu.utils import env as jenv
    from splatt_tpu_torch import trace
    from splatt_tpu_torch.utils import env

    no_gpu = {"JAX_PLATFORMS", "SPLATT_COMPILE_CACHE", "SPLATT_PROBE_CACHE",
              "SPLATT_SCAN_TARGET_ELEMS", "SPLATT_SCALING_CHILD",
              "probe_compile", "compile_cache_error", "env_platform_error",
              "probe_cache_io_error", "probe_downgrade",
              "splatt_probe_cache_total"}

    def left(jax_names, port_names):
        return {n for n in set(jax_names) - set(port_names)
                if not n.startswith(("SPLATT_BENCH_", "bench_"))} - no_gpu

    assert left(jenv.ENV_VARS, env.ENV_VARS) == set()
    assert left(jfaults.SITES, faults.SITES) == set()
    assert left(jres.RUN_REPORT_EVENTS, resilience.RUN_REPORT_EVENTS) == set()
    assert left(jtrace.SPANS, trace.SPANS) == set()
    assert left(jtrace.METRICS, trace.METRICS) == set()
    for name in ("SPLATT_INGEST_CHUNK", "SPLATT_INGEST_INFLIGHT",
                 "SPLATT_INGEST_QUARANTINE_MAX",
                 "SPLATT_INGEST_QUARANTINE_RATE",
                 "SPLATT_INGEST_UPDATE_EVERY", "SPLATT_CHAOS_SCHEDULE"):
        assert env.ENV_VARS[name].default == jenv.ENV_VARS[name].default
    for metric in ("splatt_ingest_chunks_total", "splatt_ingest_records_total",
                   "splatt_ingest_watermark",
                   "splatt_ingest_update_lag_seconds"):
        assert trace.METRICS[metric][0] == jtrace.METRICS[metric][0]
