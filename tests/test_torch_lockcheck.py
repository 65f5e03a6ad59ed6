"""SPLATT_LOCKCHECK and the thread-safety of the port's shared state.

- ``utils/lockcheck.py`` behaves as the JAX package's: an owner-asserting
  proxy raises ``LockOwnershipError`` on a mutation without its lock held
  by the mutating thread, passes under it, and is no proxy at all when
  the sanitizer is off;
- under ``SPLATT_LOCKCHECK=1`` the serve daemon's job table, queues and
  running set and the plan cache's memo are guarded, under the names the
  JAX package gives them, and a daemon with two workers runs a mixed
  sequence without one unguarded mutation;
- the eigensolver's cap flag is one word per ``resilience.scope``
  (``ops/linalg.solver_scope``), so jobs on two threads hold two words,
  and a word a queued launch may still set is not handed out again
  before that launch has finished;
- the kernel launch counters lose no count across threads.
"""

import ctypes
import subprocess
import sys
import threading

import pytest

from splatt_tpu import serve as jserve
from splatt_tpu.utils import lockcheck as jlockcheck
from splatt_tpu_torch import resilience, serve
from splatt_tpu_torch.ops import kernels, linalg
from splatt_tpu_torch.utils import lockcheck
from tests.torch_fixtures import private_tune_cache  # noqa: F401

STRUCTS = {"dict": ({}, lambda s: s.__setitem__("k", 1)),
           "list": ([], lambda s: s.append(1)),
           "set": (set(), lambda s: s.add(1))}


@pytest.mark.parametrize("kind", sorted(STRUCTS))
@pytest.mark.parametrize("mod", [lockcheck, jlockcheck],
                         ids=["port", "jax"])
def test_guard_asserts_ownership(monkeypatch, mod, kind):
    monkeypatch.setenv("SPLATT_LOCKCHECK", "1")
    proto, mutate = STRUCTS[kind]
    lock = mod.guard_lock()
    assert isinstance(lock, mod.OwnedLock)
    s = mod.guard(type(proto)(), lock, f"test.{kind}")
    with pytest.raises(mod.LockOwnershipError, match=f"test.{kind}"):
        mutate(s)
    with lock:
        mutate(s)
    assert len(s) == 1 and mod.WRAPPED[f"test.{kind}"] is lock
    # another thread holding the lock does not make this thread's write
    # legal
    held, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert held.wait(10)
        with pytest.raises(mod.LockOwnershipError):
            mutate(s)
    finally:
        release.set()
        t.join(10)


@pytest.mark.parametrize("mod", [lockcheck, jlockcheck],
                         ids=["port", "jax"])
def test_disarmed_sanitizer_wraps_nothing(monkeypatch, mod):
    monkeypatch.setenv("SPLATT_LOCKCHECK", "0")
    assert mod.enabled() is False
    lock = mod.guard_lock()
    assert not isinstance(lock, mod.OwnedLock)
    d = {}
    assert mod.guard(d, lock, "x") is d
    # an armed sanitizer with a plain lock cannot tell owners apart
    monkeypatch.setenv("SPLATT_LOCKCHECK", "1")
    assert mod.guard(d, lock, "x") is d


def test_server_structures_are_guarded_under_lockcheck(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("SPLATT_LOCKCHECK", "1")
    names = ("serve.Server._jobs", "serve.Server._queue",
             "serve.Server._pqueue", "serve.Server._running")
    for name in names:
        lockcheck.WRAPPED.pop(name, None)
        jlockcheck.WRAPPED.pop(name, None)
    srv = serve.Server(str(tmp_path / "port"), workers=2, device="cpu",
                       batch_min=2)
    jserve.Server(str(tmp_path / "jax"), workers=1)
    for name in names:
        assert name in lockcheck.WRAPPED and name in jlockcheck.WRAPPED
    with pytest.raises(lockcheck.LockOwnershipError):
        srv._queue.append("rogue")
    syn = {"dims": [12, 10, 8], "nnz": 200, "seed": 0}
    srv.submit({"id": "m", "rank": 2, "iters": 3, "synthetic": syn,
                "checkpoint_every": 3})
    for i in range(2):
        srv.submit({"id": f"b{i}", "rank": 2, "iters": 3,
                    "synthetic": dict(syn, seed=i + 1)})
    srv.submit({"id": "bad"})
    assert srv.run_once()["counts"] == {"done": 3, "rejected": 1}
    srv.submit({"id": "p", "kind": "predict", "model": "m",
                "coords": [[1, 2, 3]]})
    srv.submit({"id": "u", "kind": "update", "base": "m",
                "delta": {"dims": [12, 10, 8], "nnz": 10, "seed": 5}})
    assert srv.run_once()["counts"] == {"done": 5, "rejected": 1}
    srv.shutdown()


def test_plan_cache_memo_is_guarded_under_lockcheck():
    probe = ("from splatt_tpu_torch import tune\n"
             "from splatt_tpu_torch.utils import lockcheck\n"
             "assert lockcheck.WRAPPED['tune._MEM'] is tune._MEM_LOCK\n"
             "try:\n"
             "    tune._MEM['x'] = 1\n"
             "except lockcheck.LockOwnershipError:\n"
             "    pass\n"
             "else:\n"
             "    raise SystemExit('unguarded write passed')\n"
             "tune.reset_memo()\n")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=120,
                       env=dict(__import__("os").environ,
                                SPLATT_LOCKCHECK="1"))
    assert r.returncode == 0, r.stdout + r.stderr


def test_each_scope_holds_its_own_solver_word():
    assert linalg._WORD.get() == 0
    free = len(linalg._FREE_WORDS)
    with resilience.scope("a"):
        a = linalg._WORD.get()
        with resilience.scope("b"):
            b = linalg._WORD.get()
        assert linalg._WORD.get() == a
    assert a != b and 0 not in (a, b)
    assert linalg._WORD.get() == 0 and len(linalg._FREE_WORDS) == free
    # no card has allocated the words here: a clear reads nothing
    with resilience.scope("c"):
        assert linalg.clear_solver_status() is False
        linalg.check_solver()


def test_threads_in_scopes_hold_distinct_words():
    words, barrier = {}, threading.Barrier(4)

    def job(name):
        with resilience.scope(name):
            barrier.wait(10)
            words[name] = linalg._WORD.get()
            barrier.wait(10)

    threads = [threading.Thread(target=job, args=(f"j{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads)
    assert len(set(words.values())) == 4 and 0 not in words.values()


class _Queued:
    """An event recorded after a launch the card has not finished."""

    def __init__(self):
        self.finished, self.waited = False, 0

    def query(self):
        return self.finished

    def synchronize(self):
        self.finished = True
        self.waited += 1


@pytest.fixture()
def status_block(monkeypatch):
    """A host block standing in for the card's mapped cap-flag words, and
    a private pool of them."""
    block = (ctypes.c_int * linalg.SOLVER_WORDS)()
    monkeypatch.setattr(linalg, "_STATUS", [ctypes.addressof(block), 0])
    monkeypatch.setattr(linalg, "_FREE_WORDS", list(linalg._FREE_WORDS))
    monkeypatch.setattr(linalg, "_QUARANTINE", [])
    monkeypatch.setattr(linalg, "_PENDING", {})
    return block


def test_a_late_cap_write_never_reaches_the_next_scope(status_block):
    ev = _Queued()
    with resilience.scope("a"):
        a = linalg._WORD.get()
        linalg._note_launch(a, "stream", ev)
    # a's launch was still queued when its job left the scope (a host-side
    # raise mid-sweep); it hits its sweep cap now
    status_block[a] = 1
    with resilience.scope("b"):
        assert linalg._WORD.get() != a
        assert linalg.clear_solver_status() is False
        linalg.check_solver()
    assert [w for w, _ in linalg._QUARANTINE] == [a]
    ev.finished = True
    with resilience.scope("c"):
        # finished: handed out again, cleared first
        assert linalg._WORD.get() == a and status_block[a] == 0
        linalg.check_solver()
    assert not linalg._QUARANTINE and ev.waited == 0


def test_an_exhausted_pool_waits_for_the_oldest_quarantined_word(
        status_block, monkeypatch):
    ev = _Queued()
    with resilience.scope("a"):
        a = linalg._WORD.get()
        linalg._note_launch(a, "stream", ev)
    status_block[a] = 1
    monkeypatch.setattr(linalg, "_FREE_WORDS", [])
    with resilience.scope("b"):
        assert linalg._WORD.get() == a and ev.waited == 1
        assert status_block[a] == 0
        linalg.check_solver()


def test_a_scope_still_reads_its_own_cap_hit(status_block):
    with resilience.scope("a"):
        a = linalg._WORD.get()
        linalg._note_launch(a, "stream", _Queued())
        status_block[a] = 1
        with pytest.raises(linalg.SolverError):
            linalg.check_solver()
        linalg.check_solver()


@pytest.fixture()
def fast_switches():
    """Thread switches every microsecond, so a lost update shows."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)


def test_launch_counters_lose_no_count_across_threads(fast_switches):
    kernels.reset_launches()
    n, per = 16, 2000

    def bump(_):
        for _ in range(per):
            kernels.count_launch(kernels.fused_mttkrp_t)

    _run_threads(bump, n)
    assert kernels.fused_mttkrp_t.launches == n * per
    kernels.reset_launches()
    assert kernels.fused_mttkrp_t.launches == 0


def test_concurrent_submissions_keep_quota_and_ids(tmp_path, monkeypatch,
                                                   fast_switches):
    """16 threads submit at once, each the same 12 ids of 4 tenants (3
    each) with a quota of 2: each tenant gets exactly 2 jobs accepted,
    each once (the rest are duplicates or quota rejections), and the queue
    holds exactly the accepted jobs; under SPLATT_LOCKCHECK, so an
    unguarded mutation would raise."""
    monkeypatch.setenv("SPLATT_LOCKCHECK", "1")
    srv = serve.Server(str(tmp_path), workers=1, device="cpu",
                       tenant_quota=2, queue_max=0)
    syn = {"dims": [12, 10, 8], "nnz": 200, "seed": 0}
    replies, lock = [], threading.Lock()

    def submit(i):
        for k in range(12):
            r = srv.submit({"id": f"j{k}", "tenant": f"t{k % 4}",
                            "rank": 2, "iters": 2, "synthetic": syn})
            with lock:
                replies.append(r)

    _run_threads(submit, 16)
    accepted = {r["job"] for r in replies
                if r["state"] == serve.ACCEPTED and not r.get("duplicate")}
    firsts = [r for r in replies
              if r["state"] == serve.ACCEPTED and not r.get("duplicate")]
    assert len(firsts) == len(accepted) == 8
    per_tenant = [sum(1 for j in accepted if int(j[1:]) % 4 == t)
                  for t in range(4)]
    assert per_tenant == [2, 2, 2, 2]
    assert any(r.get("reason", "").startswith("quota:") for r in replies)
    summary = srv.summary()
    assert summary["pending"] == 8
    assert sorted(srv._queue) == sorted(accepted)
    srv.drain()
