"""The port's fleet mode (``splatt_tpu_torch/fleet.py`` and the fleet half
of ``serve.py``) against the JAX package's, on the CPU.

- One scripted lease schedule (acquire, contention, renew after expiry,
  adopt with the ``gen`` fence, release, heartbeats, retire) runs on both
  packages' ``FleetMember`` under one virtual clock and gives the same
  decisions; a JAX replica and a port replica share one spool under it.
- Each package's ``FleetMember`` reads the other's lease and heartbeat
  files.
- In-process two-``Server`` fleets, one per package, through the same
  scenarios (dead-peer adoption, the zombie that cannot commit, affinity
  to a warm local regime, deferral to a warm peer and then a steal, a
  warm peer's steal of a live peer's job, the tenant quota, spool claims,
  a dead claimant's request reclaimed) journal the same record kinds in
  order.  The adopted job's fit and factors match the JAX package's
  within the tolerances of ``tests/test_torch_serve.py`` (FIT_TOL 1e-6,
  REL_TOL 1e-5 of max|.|) from the same init, as in that file.  The
  port's zombie also writes no checkpoint and no model generation: every
  checkpoint is renewed for after it is written, just before its rename,
  where the JAX package's zombie writes its model before its last renew
  fails.
- An owner that loses its lease while it writes a checkpoint publishes
  nothing, and a refused checkpoint leaves no debris.
- The three fleet fault sites degrade classified in both packages.

Every wait is bounded and every server is shut down.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest

from splatt_tpu import fleet as jfleet
from splatt_tpu import resilience as jres
from splatt_tpu import serve as jserve
from splatt_tpu import trace as jtrace
from splatt_tpu import tune as jtune
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import fleet, resilience, serve, trace, tune
from splatt_tpu_torch.utils import faults
from tests.torch_fixtures import private_tune_cache  # noqa: F401

#: the adopted job's numbers, the port's against the JAX package's from
#: one init: fits within FIT_TOL, factors within REL_TOL of max|.|
FIT_TOL = 1e-6
REL_TOL = 1e-5
SYN = {"dims": [14, 11, 9], "nnz": 300, "seed": 0}
#: a second shape regime (other power-of-two buckets than SYN)
SYN_BIG = {"dims": [40, 36, 33], "nnz": 2500, "seed": 0}
PACKAGES = {"port": (serve, fleet, resilience, faults),
            "jax": (jserve, jfleet, jres, jfaults)}


def _clean():
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()
    for mod in (trace, jtrace):
        mod.reset_metrics()


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
    return mod.Server(root, workers=1, **kw)


def _journal(mod, root):
    recs, _ = mod.Journal(os.path.join(root, "journal.jsonl")).replay()
    return recs


def _lineage(recs):
    """The journal as (record kind, job, replica, from_replica)."""
    return [(r["rec"], r["job"], r.get("replica"), r.get("from_replica"))
            for r in recs]


# -- the journal's incremental tail read -------------------------------------

def test_replay_new_withholds_an_append_in_progress(tmp_path):
    """A final line with no newline is a peer's append in progress: both
    packages leave it unconsumed and read it whole once it completes."""
    path = str(tmp_path / "journal.jsonl")
    serve.Journal(path).append({"rec": "accepted", "job": "a"})
    with open(path, "ab") as f:
        f.write(b'{"rec": "done", "job": "a"')
    got, want = serve.Journal(path), jserve.Journal(path)
    r1 = got.replay_new(0)
    assert [x["rec"] for x in r1[0]] == ["accepted"] and r1[1] == 0
    assert r1[2] == jserve.Journal(path).replay_new(0)[2]
    assert got.replay_new(r1[2]) == ([], 0, r1[2])
    with open(path, "ab") as f:
        f.write(b"}\n")
    r2 = got.replay_new(r1[2])
    w2 = want.replay_new(r1[2])
    assert [x["rec"] for x in r2[0]] == ["done"] and r2[2] == w2[2]
    assert not resilience.run_report().events("journal_torn")
    # the full replay judges the same file the same way in both
    assert got.replay()[1] == want.replay()[1] == 0


# -- the lease protocol under a virtual clock ---------------------------------

class _Clock:
    def __init__(self, t=1_000.0):
        self.t = t

    def __call__(self):
        return self.t


def _schedule(a, b, clock, leases_dir):
    """The scripted lease schedule on members `a` and `b` (lease 2 s):
    every decision and observation, in order."""
    out = []

    def note(what, value):
        out.append((what, value))

    note("a.acquire j1", a.acquire("j1"))
    note("b.acquire j1 (held)", b.acquire("j1"))
    note("b.adopt j1 (unexpired)", b.adopt("j1"))
    note("a.renew j1", a.renew("j1"))
    note("a.held", a.held())
    note("gen", b.lease_of("j1").gen)
    clock.t += 2.5                      # a's lease expires unrenewed
    note("a.renew j1 (expired)", a.renew("j1"))
    note("a.lost j1", a.lost("j1"))
    note("a.held after", a.held())
    note("b.acquire j1 (expired)", b.acquire("j1"))
    note("b.adopt j1", b.adopt("j1"))
    note("gen after adopt", a.lease_of("j1").gen)
    note("a.acquire j1 (fenced)", a.acquire("j1"))
    note("a.renew j1 (fenced)", a.renew("j1"))
    clock.t += 1.0
    note("b.renew j1", b.renew("j1"))
    b.release("j1")
    note("released", a.lease_of("j1"))
    note("sidecars", sorted(os.listdir(leases_dir)))
    note("a.acquire j1 again", a.acquire("j1"))
    note("gen of a fresh lease", b.lease_of("j1").gen)
    # membership
    a.add_regime("regimeX")
    note("a.warm", a.warm("regimeX"))
    a.beat()
    b.beat()
    peers = b.peers()
    note("b.peers", {rid: (rec["regimes"], rec["active"], rec["ts"],
                           rec["expires"]) for rid, rec in peers.items()})
    note("b.peer_warm", b.peer_warm("regimeX"))
    note("b sees a alive", b.replica_alive(a.replica))
    clock.t += 2.5                      # a's heartbeat expires
    note("b sees a dead", b.replica_alive(a.replica))
    note("b.peer_warm after", b.peer_warm("regimeX"))
    b.beat()
    b.retire()
    note("a.peers after retire", sorted(a.peers()))
    note("a.active", a.active_count())
    return out


def _members(mods, root, clock):
    return [m.FleetMember(str(root), replica=rid, lease_s=2.0, clock=clock)
            for m, rid in zip(mods, ("ra", "rb"))]


def test_scripted_lease_schedule_gives_the_same_decisions(tmp_path):
    runs = {}
    for name, mod in (("port", fleet), ("jax", jfleet)):
        clock = _Clock()
        a, b = _members((mod, mod), tmp_path / name, clock)
        runs[name] = _schedule(a, b, clock, a.leases_dir)
    assert runs["port"] == runs["jax"]
    got = dict(runs["port"])
    assert got["a.renew j1 (expired)"] is False and got["a.lost j1"]
    assert got["gen after adopt"] == 2 and got["b.adopt j1"] is True
    assert got["sidecars"] == []
    # the owner's expiry is a classified event with its metric in both
    for res, tr in ((resilience, trace), (jres, jtrace)):
        evs = res.run_report().events("lease_expired")
        assert [(e["job"], e["role"]) for e in evs] == [("j1", "owner")]
        assert any(n == "splatt_fleet_lease_expired_total"
                   for n, _ in tr.samples())


@pytest.mark.parametrize("owner", ["jax", "port"])
def test_a_mixed_fleet_runs_the_same_schedule(tmp_path, owner):
    """A JAX replica and a port replica on one spool: the schedule's
    decisions are those of a single-package fleet."""
    clock = _Clock()
    mods = (jfleet, fleet) if owner == "jax" else (fleet, jfleet)
    a, b = _members(mods, tmp_path / "mixed", clock)
    got = _schedule(a, b, clock, a.leases_dir)
    clock2 = _Clock()
    a2, b2 = _members((fleet, fleet), tmp_path / "port", clock2)
    assert got == _schedule(a2, b2, clock2, a2.leases_dir)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_fleet_files(tmp_path, writer):
    wmod, rmod = (jfleet, fleet) if writer == "jax" else (fleet, jfleet)
    clock = _Clock()
    w = wmod.FleetMember(str(tmp_path), replica="rw", lease_s=5.0,
                         clock=clock)
    r = rmod.FleetMember(str(tmp_path), replica="rr", lease_s=5.0,
                         clock=clock)
    w.metrics_path = "/spool/fleet/metrics/rw.prom"
    w.add_regime("regimeY")
    assert w.acquire("j9")
    w.beat()
    lease = r.lease_of("j9")
    assert (lease.job, lease.replica, lease.ts, lease.expires, lease.gen) \
        == ("j9", "rw", clock.t, clock.t + 5.0, 1)
    with open(os.path.join(w.replicas_dir, "rw.json")) as f:
        raw = json.load(f)
    assert set(raw) == {"replica", "pid", "ts", "expires", "regimes",
                        "active", "metrics"}
    assert r.peers()["rw"] == raw
    assert r.peer_warm("regimeY") == "rw" and r.replica_alive("rw")
    # the reader's package honours the writer's lease
    assert not r.acquire("j9") and not r.adopt("j9")
    clock.t += 6.0
    assert r.adopt("j9") and r.lease_of("j9").gen == 2
    assert not w.renew("j9") and w.lost("j9")


def test_lease_contention_gives_one_owner_across_packages(tmp_path):
    a = jfleet.FleetMember(str(tmp_path), replica="ra", lease_s=5.0)
    b = fleet.FleetMember(str(tmp_path), replica="rb", lease_s=5.0)
    jobs = [f"j{i}" for i in range(16)]
    wins = {"ra": set(), "rb": set()}

    def claim(m, key):
        for jid in jobs:
            if m.acquire(jid):
                wins[key].add(jid)

    ts = [threading.Thread(target=claim, args=(a, "ra")),
          threading.Thread(target=claim, args=(b, "rb"))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not (wins["ra"] & wins["rb"]), "a job got two owners"
    assert wins["ra"] | wins["rb"] == set(jobs)


def _ones_model(scale=1.0):
    import torch

    return ([scale * torch.ones(4, 2), scale * torch.ones(3, 2),
             scale * torch.ones(5, 2)], torch.ones(2))


def test_a_lease_lost_during_a_checkpoint_write_publishes_nothing(
        tmp_path, monkeypatch):
    """The owner stalls inside its checkpoint write; meanwhile its lease
    expires, a peer adopts the job and checkpoints it.  The owner's fence
    runs after the write, so it is refused and the peer's checkpoint
    stays (renewing before the write would publish over it)."""
    from splatt_tpu_torch import cpd

    now = [1000.0]
    owner = fleet.FleetMember(str(tmp_path), replica="ra", lease_s=5.0,
                              clock=lambda: now[0])
    peer = fleet.FleetMember(str(tmp_path), replica="rb", lease_s=5.0,
                             clock=lambda: now[0])
    assert owner.acquire("j")
    path = str(tmp_path / "j.npz")
    real = cpd.np.savez
    stalled = []

    def savez(*a, **kw):
        real(*a, **kw)
        if not stalled:
            stalled.append(True)
            now[0] += 60.0  # the owner stalls past its lease
            assert peer.adopt("j")
            assert cpd._save_checkpoint(
                path, *_ones_model(2.0), 3, 0.7,
                fence=lambda: peer.renew("j")) is not None

    monkeypatch.setattr(cpd.np, "savez", savez)
    assert cpd._save_checkpoint(path, *_ones_model(), 1, 0.5,
                                fence=lambda: owner.renew("j")) is None
    monkeypatch.setattr(cpd.np, "savez", real)
    factors, _, it, _ = cpd.load_checkpoint(path)
    assert it == 3 and float(factors[0].max()) == 2.0
    assert not glob.glob(path + ".~*")
    assert owner.lost("j") and peer.lease_of("j").gen == 2


def test_a_refused_checkpoint_publishes_nothing(tmp_path):
    """The checkpoint is written and synced before its fence, and a fence
    that refuses leaves the published generation and no debris."""
    from splatt_tpu_torch.cpd import _save_checkpoint, load_checkpoint

    path = str(tmp_path / "c.npz")
    assert _save_checkpoint(path, *_ones_model(), 1, 0.5) is not None
    seen = []

    def refuse():
        seen.append(len(glob.glob(path + ".~*.tmp.npz")))
        return False

    assert _save_checkpoint(path, *_ones_model(2.0), 2, 0.6,
                            fence=refuse) is None
    assert seen == [1]
    assert not glob.glob(path + ".~*")
    assert not os.path.exists(path + ".bak")
    got, _, it, _ = load_checkpoint(path)
    assert it == 1 and float(got[0].max()) == 1.0
    assert _save_checkpoint(path, *_ones_model(2.0), 2, 0.6,
                            fence=lambda: True) is not None
    assert load_checkpoint(path)[2] == 2 and os.path.exists(path + ".bak")


def test_job_regime_is_the_jax_packages():
    for spec in (_spec("x"), _spec("y", rank=8),
                 _spec("z", synthetic=dict(SYN_BIG)),
                 {"tensor": "/some/file.tns"},
                 {"kind": "predict", "model": "m"}):
        assert fleet.job_regime(spec) == jfleet.job_regime(spec)


# -- the fleet fault sites ---------------------------------------------------

@pytest.mark.parametrize("name", ["port", "jax"])
def test_lease_acquire_fault_degrades_and_the_job_survives(tmp_path, name):
    smod, _, _, fmod = PACKAGES[name]
    srv = _server(smod, str(tmp_path), fleet=True, replica="ra",
                  lease_s=5.0)
    try:
        srv.submit(_spec("f1"))
        with fmod.inject("fleet.lease_acquire", "runtime", times=1):
            srv.run_once()
        assert srv.status("f1")["state"] in (smod.ACCEPTED, smod.DONE)
        assert srv.run_once()["counts"][smod.DONE] == 1
        assert smod.read_result(str(tmp_path), "f1")["status"] == \
            "converged"
    finally:
        srv.shutdown()


@pytest.mark.parametrize("name", ["port", "jax"])
def test_heartbeat_fault_degrades_classified(tmp_path, capsys, name):
    _, fmod_fleet, _, fmod = PACKAGES[name]
    a = fmod_fleet.FleetMember(str(tmp_path), replica="ra", lease_s=5.0)
    assert a.acquire("j1")
    with fmod.inject("fleet.heartbeat", "runtime", times=1):
        assert a.beat() == []
    assert "heartbeat degraded" in capsys.readouterr().err
    assert a.beat() == [] and a.renew("j1")


@pytest.mark.parametrize("name", ["port", "jax"])
def test_adopt_fault_leaves_the_job_for_the_next_scan(tmp_path, name):
    _, fmod_fleet, _, fmod = PACKAGES[name]
    clock = _Clock()
    a = fmod_fleet.FleetMember(str(tmp_path), replica="ra", lease_s=2.0,
                               clock=clock)
    b = fmod_fleet.FleetMember(str(tmp_path), replica="rb", lease_s=5.0,
                               clock=clock)
    assert a.acquire("j1")
    clock.t += 3.0
    with fmod.inject("fleet.adopt", "runtime", times=1):
        with pytest.raises(RuntimeError):
            b.adopt("j1")
    assert b.lease_of("j1").replica == "ra"
    assert b.adopt("j1")


def test_registries_cover_the_fleet_surface():
    from splatt_tpu_torch.utils.env import ENV_VARS

    for ev in ("journal_torn", "job_adopted", "lease_expired",
               "quota_rejected", "affinity_routed", "flight_degraded"):
        assert ev in resilience.RUN_REPORT_EVENTS
    for site in ("fleet.lease_acquire", "fleet.heartbeat", "fleet.adopt",
                 "trace.flight"):
        assert site in faults.SITES
    for var in ("SPLATT_FLEET_REPLICA", "SPLATT_FLEET_LEASE_S",
                "SPLATT_FLEET_HEARTBEAT_S", "SPLATT_FLEET_TENANT_QUOTA",
                "SPLATT_FLEET_AFFINITY", "SPLATT_FLIGHT",
                "SPLATT_FLIGHT_BYTES", "SPLATT_FLIGHT_FLUSH"):
        assert var in ENV_VARS
    for metric in ("splatt_fleet_adoptions_total",
                   "splatt_fleet_lease_expired_total",
                   "splatt_fleet_replicas"):
        assert trace.METRICS[metric][0] == jtrace.METRICS[metric][0]


# -- in-process two-Server fleets --------------------------------------------

def _dead_peer(mod, root):
    """ra accepts a job and retires without running it; once its lease
    would have expired, rb adopts the job and runs it."""
    a = _server(mod, root, fleet=True, replica="ra", lease_s=0.3)
    a.submit(_spec("adoptme"))
    a.shutdown()
    time.sleep(0.4)
    b = _server(mod, root, fleet=True, replica="rb", lease_s=5.0)
    try:
        summary = b.run_once()
    finally:
        b.shutdown()
    return dict(counts=summary["counts"])


def _zombie(mod, root):
    """ra's lease (0.3 s, never renewed) expires while its job is pinned
    by a slow fault: it must abandon uncommitted; rb then adopts it."""
    a = _server(mod, root, fleet=True, replica="ra", lease_s=0.3,
                heartbeat_s=30.0)
    a.submit(_spec("z1", faults="serve.job_run:slow:delay=0.6"))
    a.run_once()
    zombie = dict(result=mod.read_result(root, "z1"),
                  kinds=[r["rec"] for r in _journal(mod, root)])
    a.drain()
    b = _server(mod, root, fleet=True, replica="rb", lease_s=5.0)
    try:
        summary = b.run_once()
    finally:
        b.shutdown()
    return dict(counts=summary["counts"], zombie=zombie)


def _warm_local(mod, root):
    srv = _server(mod, root, fleet=True, replica="ra", lease_s=5.0)
    try:
        srv.fleet.add_regime(_regime(mod, _spec("warm")))
        srv.submit(_spec("cold", synthetic=dict(SYN_BIG)))
        srv.submit(_spec("warm"))   # filed second, run first
        summary = srv.run_once()
    finally:
        srv.shutdown()
    return dict(counts=summary["counts"])


def _regime(mod, spec):
    return (fleet if mod is serve else jfleet).job_regime(spec)


def _defer_then_steal(mod, root):
    fmod = fleet if mod is serve else jfleet
    peer = fmod.FleetMember(root, replica="rb", lease_s=30.0)
    peer.add_regime(fmod.job_regime(_spec("x")))
    peer.beat()    # rb lives, is warm for the regime and idle
    srv = _server(mod, root, fleet=True, replica="ra", lease_s=5.0)
    try:
        srv.submit(_spec("x"))
        summary = srv.run_once()   # rb never claims: ra steals at the cap
    finally:
        srv.shutdown()
    return dict(counts=summary["counts"])


def _warm_peer_steals(mod, root):
    a = _server(mod, root, fleet=True, replica="ra", lease_s=5.0)
    b = None
    try:
        a.submit(_spec("hot"))      # accepted on ra, never run there
        b = _server(mod, root, fleet=True, replica="rb", lease_s=5.0)
        b.fleet.add_regime(_regime(mod, _spec("hot")))
        summary = b.run_once()
    finally:
        a.shutdown()
        if b is not None:
            b.shutdown()
    return dict(counts=summary["counts"])


def _quota(mod, root):
    srv = _server(mod, root, fleet=True, replica="ra", lease_s=5.0,
                  tenant_quota=1)
    try:
        replies = [srv.submit(_spec("q1", tenant="acme")),
                   srv.submit(_spec("q2", tenant="acme")),
                   srv.submit(_spec("q3", tenant="zeta"))]
        srv.run_once()
        replies.append(srv.submit(_spec("q2", tenant="acme")))
        summary = srv.run_once()
    finally:
        srv.shutdown()
    return dict(counts=summary["counts"], replies=replies)


def _claims(mod, root):
    a = _server(mod, root, fleet=True, replica="ra", lease_s=5.0)
    b = _server(mod, root, fleet=True, replica="rb", lease_s=5.0)
    try:
        for i in range(4):
            mod.file_request(root, _spec(f"s{i}"))
        scans = (a.scan_requests(), b.scan_requests())
    finally:
        a.shutdown()
        b.shutdown()
    left = sorted(os.listdir(os.path.join(root, "requests")))
    return dict(scans=scans, left=left)


def _reclaim(mod, root):
    os.makedirs(os.path.join(root, "requests"), exist_ok=True)
    with open(os.path.join(root, "requests", "lost1.json.rz.claim"),
              "w") as f:
        json.dump(_spec("lost1"), f)
    b = _server(mod, root, fleet=True, replica="rb", lease_s=5.0)
    try:
        n = b.scan_requests()    # rz has no heartbeat: dead
        state = b.status("lost1")["state"]
    finally:
        b.shutdown()
    return dict(scanned=n, state=state)


SCENARIOS = {"dead_peer": _dead_peer, "zombie": _zombie,
             "warm_local": _warm_local,
             "defer_then_steal": _defer_then_steal,
             "warm_peer_steals": _warm_peer_steals, "quota": _quota,
             "claims": _claims, "reclaim": _reclaim}


def _jax_draw(dims, rank, generator, dtype=None, device=None):
    """The port's init_factors drawing the JAX package's numbers for the
    generator's seed (as in tests/test_torch_serve.py)."""
    import jax
    import torch

    key = jax.random.PRNGKey(generator.initial_seed())
    return [torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, m), (d, rank), dtype="float64"))).to(
        device, dtype or torch.float32) for m, d in enumerate(dims)]


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Every scenario through both packages, each in its own spool, with
    private plan caches and the port's seeded init the JAX package's."""
    from splatt_tpu_torch import cpd as pcpd

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pcpd, "init_factors", _jax_draw)
        base = tmp_path_factory.mktemp("fleets")
        mp.setenv("SPLATT_TUNE_CACHE", str(base / "tc.json"))
        mp.setenv("SPLATT_PROBE_CACHE", str(base / "pc.json"))
        for scen, fn in SCENARIOS.items():
            for name, mod in (("jax", jserve), ("port", serve)):
                tune.reset_memo()
                jtune.reset_memo()
                _clean()
                root = str(base / scen / name)
                os.makedirs(root)
                res = fn(mod, root)
                rep = (resilience if mod is serve else jres).run_report()
                out[(scen, name)] = dict(
                    root=root, journal=_journal(mod, root), **res,
                    events=[{k: v for k, v in e.items() if k != "ts"}
                            for e in rep.events()
                            if e["kind"] in ("job_adopted", "lease_expired",
                                             "affinity_routed",
                                             "quota_rejected")])
        tune.reset_memo()
        jtune.reset_memo()
    _clean()
    return out


@pytest.mark.parametrize("scen", sorted(SCENARIOS))
def test_fleets_journal_the_same_records_in_order(fleets, scen):
    got, want = fleets[(scen, "port")], fleets[(scen, "jax")]
    assert _lineage(got["journal"]) == _lineage(want["journal"])
    assert got.get("counts") == want.get("counts")
    assert got["events"] == want["events"]
    for key in ("replies", "scans", "left", "scanned", "state"):
        assert got.get(key) == want.get(key), key


EXPECTED = {
    "dead_peer": [("accepted", "adoptme", "ra", None),
                  ("resumed", "adoptme", "rb", None),
                  ("adopted", "adoptme", "rb", "ra"),
                  ("started", "adoptme", "rb", None),
                  ("done", "adoptme", "rb", None)],
    "zombie": [("accepted", "z1", "ra", None),
               ("started", "z1", "ra", None),
               ("resumed", "z1", "rb", None),
               ("adopted", "z1", "rb", "ra"),
               ("started", "z1", "rb", None),
               ("done", "z1", "rb", None)],
}


@pytest.mark.parametrize("scen", sorted(EXPECTED))
def test_a_dead_or_stalled_owners_job_is_adopted(fleets, scen):
    got = fleets[(scen, "port")]
    assert _lineage(got["journal"]) == EXPECTED[scen]
    jid = EXPECTED[scen][0][1]
    res = serve.read_result(got["root"], jid)
    assert res["status"] == "converged"
    assert res["replica"] == "rb" and res["adopted_from"] == "ra"
    ev = [e for e in got["events"] if e["kind"] == "job_adopted"]
    assert [(e["job"], e["from_replica"]) for e in ev] == [(jid, "ra")]


def test_the_adopted_job_has_the_jax_packages_numbers(fleets):
    from splatt_tpu_torch.cpd import load_checkpoint

    got, want = fleets[("dead_peer", "port")], fleets[("dead_peer", "jax")]
    g = serve.read_result(got["root"], "adoptme")
    w = jserve.read_result(want["root"], "adoptme")
    assert set(g) == set(w)
    assert abs(g["fit"] - w["fit"]) <= FIT_TOL
    factors, lam, _, _ = load_checkpoint(
        os.path.join(got["root"], "ckpt", "adoptme.npz"))
    with np.load(os.path.join(want["root"], "ckpt", "adoptme.npz")) as z:
        ref = [z[f"factor{m}"] for m in range(3)] + [z["lam"]]
    for a, b in zip(list(factors) + [lam], ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL_TOL * np.abs(b).max())


def test_the_zombie_keeps_no_result_checkpoint_or_generation(fleets):
    got = fleets[("zombie", "port")]
    z = got["zombie"]
    assert z["result"] is None
    assert "done" not in z["kinds"] and "failed" not in z["kinds"]
    owner = [e for e in got["events"] if e["kind"] == "lease_expired"]
    assert [(e["replica"], e["role"]) for e in owner] == [
        ("ra", "owner"), ("ra", "adopter")]
    # the adopter ran the job from scratch (the zombie wrote no
    # checkpoint) and committed the first generation
    res = serve.read_result(got["root"], "z1")
    assert res["model_gen"] == 1 and res["resumed"] is True
    plain = fleets[("dead_peer", "port")]
    assert res["fit"] == serve.read_result(plain["root"],
                                           "adoptme")["fit"]


def test_affinity_routes_like_the_jax_package(fleets):
    started = {}
    for scen in ("warm_local", "defer_then_steal", "warm_peer_steals"):
        got = fleets[(scen, "port")]
        started[scen] = [r["job"] for r in got["journal"]
                         if r["rec"] == "started"]
        reasons = {(e["job"], e["reason"], e.get("to_replica"))
                   for e in got["events"] if e["kind"] == "affinity_routed"}
        started[scen + "_reasons"] = reasons
    assert started["warm_local"] == ["warm", "cold"]
    assert ("warm", "warm_local", None) in started["warm_local_reasons"]
    assert {("x", "deferred", "rb"), ("x", "load_tiebreak", "rb")} <= \
        started["defer_then_steal_reasons"]
    res = serve.read_result(fleets[("warm_peer_steals", "port")]["root"],
                            "hot")
    assert res["replica"] == "rb" and res.get("adopted_from") is None


def test_quota_claims_and_reclaims(fleets):
    q = fleets[("quota", "port")]
    assert [r["state"] for r in q["replies"]] == [
        "accepted", "rejected", "accepted", "accepted"]
    assert q["replies"][1]["reason"] == "quota:acme"
    c = fleets[("claims", "port")]
    assert sum(c["scans"]) == 4 and c["left"] == []
    accepted = [r["job"] for r in c["journal"] if r["rec"] == "accepted"]
    assert sorted(accepted) == [f"s{i}" for i in range(4)]
    r = fleets[("reclaim", "port")]
    assert r["scanned"] == 1 and r["state"] == "accepted"


def test_summary_names_the_replica_and_its_leases(tmp_path):
    srv = _server(serve, str(tmp_path), fleet=True, replica="ra",
                  lease_s=5.0)
    try:
        s = srv.summary()
        assert s["replica"] == "ra" and s["held_leases"] == []
        # the replica's snapshot defaults into the spool and is advertised
        assert srv.metrics_path == os.path.join(
            str(tmp_path), "fleet", "metrics", "ra.prom")
        with open(os.path.join(str(tmp_path), "fleet", "replicas",
                               "ra.json")) as f:
            assert json.load(f)["metrics"] == srv.metrics_path
    finally:
        srv.shutdown()
    assert not os.path.exists(os.path.join(str(tmp_path), "fleet",
                                           "replicas", "ra.json"))


def test_a_failed_job_advertises_no_regime(tmp_path):
    srv = _server(serve, str(tmp_path), fleet=True, replica="ra",
                  lease_s=5.0)
    try:
        spec = _spec("bad", tensor="/nonexistent/t.tns")
        del spec["synthetic"]
        srv.submit(spec)
        srv.run_once()
        assert serve.read_result(str(tmp_path), "bad")["status"] == "failed"
        assert not srv.fleet.warm(fleet.job_regime(_spec("probe")))
        assert srv.fleet.held() == []
        assert os.listdir(srv.fleet.leases_dir) == []
    finally:
        srv.shutdown()


def test_a_job_a_peer_committed_first_is_dropped_unjournaled(tmp_path):
    """Two live replicas queue a dead peer's job for adoption; one adopts
    and commits it before the other's worker reaches it.  The late worker
    acquires the now free lease, reads the commit in the journal and drops
    the job without journaling an adoption, so the job keeps one terminal
    record and its last record stays ``done``.  (The JAX package journals
    its ``adopted`` record before that read: a soak on a loaded host saw
    the job reopened and committed twice.)"""
    root = str(tmp_path)
    a = _server(serve, root, fleet=True, replica="ra", lease_s=0.3)
    a.submit(_spec("x1"))
    a.shutdown()
    time.sleep(0.4)
    b = _server(serve, root, fleet=True, replica="rb", lease_s=5.0)
    c = _server(serve, root, fleet=True, replica="rc", lease_s=5.0)
    try:
        assert c.run_once()["counts"] == {"done": 1}
        # rb's worker, without the scan that would fold rc's commit
        assert b._next_batch() == []
        assert b.fleet.held() == []
    finally:
        b.shutdown()
        c.shutdown()
    recs = [r for r in _journal(serve, root) if r["job"] == "x1"]
    # rc found rb (the last to journal the job) alive: a plain claim
    assert [(r["rec"], r.get("replica")) for r in recs] == [
        ("accepted", "ra"), ("resumed", "rb"), ("resumed", "rc"),
        ("started", "rc"), ("done", "rc")]
    from splatt_tpu_torch import chaos

    assert chaos._fleet_lineage_violations(recs) == []
