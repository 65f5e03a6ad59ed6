"""Fleet membership for ``serve``: leases, heartbeats, adoption
(≙ splatt_tpu/fleet.py).

N ``serve --fleet`` replicas over one spool form a fleet.  This module is
its membership layer; the lease and heartbeat files keep the JAX
package's JSON keys, so either package reads the other's spool.

Replica heartbeats
    Every replica keeps a lease file ``<root>/fleet/replicas/<replica>.json``
    holding ``{replica, pid, ts, expires, regimes, active}`` (and
    ``metrics``, its Prometheus snapshot's path) and renews it every
    ``heartbeat_s`` seconds.  A replica whose heartbeat expiry is past is
    dead as far as the fleet is concerned: there is no other failure
    detector.  ``regimes`` lists the shape regimes this replica has run
    (its plan cache and layouts are warm for them: the affinity signal),
    ``active`` its count of held job leases (the load tiebreaker).

Job leases
    A replica runs a job only while it holds the job's lease file
    ``<root>/fleet/leases/<job>.json``.  Every lease mutation happens
    under an exclusive ``flock`` on the job's ``.lock`` sidecar, reads the
    current lease inside the lock, decides, and publishes the new lease by
    a temporary write and ``os.replace`` (a reader outside the lock never
    sees a torn lease):

    - :meth:`FleetMember.acquire` claims an absent lease or renews one this
      replica holds; a lease validly held by a peer, and an expired lease
      (:meth:`FleetMember.adopt`'s), refuse.
    - :meth:`FleetMember.renew` extends a held lease and refuses once it
      expired or changed hands, even if nobody took it yet: ownership must
      be continuous.  The owner learns it lost the job and stops at its
      next cooperative poll.
    - :meth:`FleetMember.adopt` takes over an expired lease, bumping
      ``gen`` so that the previous owner's renew can never match again:
      a dead replica's jobs are adopted by a live peer and resume from
      their checkpoints.

    Expiry is the fence: an owner whose lease expired may still be
    computing (a stopped process with kernels queued on the card), but it
    can no longer journal a terminal record or keep a result.  A
    checkpoint or a model is written in full first and renewed for just
    before its rename, so what is left between the check and the write
    is a rename, not the write; no lock is held across it, since a
    stopped holder would keep its peers from ever adopting.

Fault sites: ``fleet.lease_acquire``, ``fleet.heartbeat`` and
``fleet.adopt``, each degrading classified without killing the replica.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

try:
    import fcntl
except ImportError:  # non-POSIX: leases degrade to rename-only
    fcntl = None

#: heartbeat cadence when SPLATT_FLEET_HEARTBEAT_S is unset or <= 0:
#: renew this many times per lease
_BEATS_PER_LEASE = 3.0

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclasses.dataclass
class Lease:
    """One published job lease: who owns the job until when.  ``gen``
    grows at every takeover, so a stale owner's renew (which matches on
    replica and gen) never revives a lease that changed hands."""

    job: str
    replica: str
    ts: float
    expires: float
    gen: int = 1

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.time()) >= self.expires

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class FleetMember:
    """This replica's view of the fleet: its heartbeat, the leases it
    holds, and the liveness and warmth of its peers.  `clock` is the
    protocol's time source (the wall clock by default; a test may inject a
    virtual one, so that expiry is a step of a script, not a race)."""

    def __init__(self, root: str, replica: Optional[str] = None,
                 lease_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        from splatt_tpu_torch.utils import lockcheck
        from splatt_tpu_torch.utils.env import read_env, read_env_float

        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "fleet")
        self.replicas_dir = os.path.join(self.dir, "replicas")
        self.leases_dir = os.path.join(self.dir, "leases")
        for d in (self.dir, self.replicas_dir, self.leases_dir):
            os.makedirs(d, exist_ok=True)
        rid = replica or read_env("SPLATT_FLEET_REPLICA") \
            or f"r-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.replica = _safe_name(str(rid))
        self.lease_s = float(lease_s if lease_s is not None
                             else read_env_float("SPLATT_FLEET_LEASE_S"))
        hb = float(heartbeat_s if heartbeat_s is not None
                   else read_env_float("SPLATT_FLEET_HEARTBEAT_S"))
        self.heartbeat_s = hb if hb > 0 \
            else max(self.lease_s / _BEATS_PER_LEASE, 0.05)
        self._clock = clock if clock is not None else time.time
        # owner-asserting proxies under SPLATT_LOCKCHECK
        self._lock = lockcheck.guard_lock(threading.Lock())
        self._held: Dict[str, Lease] = lockcheck.guard(
            {}, self._lock, "fleet.FleetMember._held")
        self._lost: set = lockcheck.guard(
            set(), self._lock, "fleet.FleetMember._lost")
        self._regimes: set = lockcheck.guard(
            set(), self._lock, "fleet.FleetMember._regimes")
        #: this replica's Prometheus snapshot path, advertised in the
        #: heartbeat so the fleet aggregator (fleetobs.py) finds every
        #: replica's metrics; set once at serve start, before the
        #: heartbeat thread exists
        self.metrics_path: Optional[str] = None

    # -- flock + atomic-rename primitives ------------------------------------

    @contextlib.contextmanager
    def _locked(self, jid: str):
        """Exclusive advisory lock on the job's ``.lock`` sidecar: two
        replicas racing an acquire, renew or adopt serialize here."""
        path = os.path.join(self.leases_dir, f"{_safe_name(jid)}.lock")
        f = open(path, "a")
        try:
            if fcntl is not None:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            yield
        finally:
            if fcntl is not None:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            f.close()

    def _lease_path(self, jid: str) -> str:
        return os.path.join(self.leases_dir, f"{_safe_name(jid)}.json")

    def _write_lease(self, lease: Lease) -> None:
        from splatt_tpu_torch.utils.durable import publish_json

        publish_json(self._lease_path(lease.job), lease.to_json())

    def lease_of(self, jid: str) -> Optional[Lease]:
        """The published lease of `jid`, or None (a lock-free read: the
        atomic rename makes the file whole; a malformed one reads as
        absent, that is claimable)."""
        try:
            with open(self._lease_path(jid)) as f:
                rec = json.load(f)
            return Lease(job=str(rec["job"]), replica=str(rec["replica"]),
                         ts=float(rec["ts"]), expires=float(rec["expires"]),
                         gen=int(rec.get("gen", 1)))
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # -- the lease state machine ---------------------------------------------

    def acquire(self, jid: str) -> bool:
        """Claim the job's lease: absent → this replica's; ours and
        unexpired → renewed; a peer's, or expired (:meth:`adopt`'s) →
        refused.  Exactly one of N racing replicas wins."""
        from splatt_tpu_torch.utils import faults

        faults.maybe_fail("fleet.lease_acquire")
        now = self._clock()
        with self._locked(jid):
            cur = self.lease_of(jid)
            if cur is not None:
                if cur.replica != self.replica or cur.expired(now):
                    return False
                lease = Lease(job=jid, replica=self.replica, ts=now,
                              expires=now + self.lease_s, gen=cur.gen)
            else:
                lease = Lease(job=jid, replica=self.replica, ts=now,
                              expires=now + self.lease_s, gen=1)
            self._write_lease(lease)
        with self._lock:
            self._held[jid] = lease
            self._lost.discard(jid)
        return True

    def renew(self, jid: str) -> bool:
        """Extend a held lease.  Refuses, and moves the job to the
        :meth:`lost` set, when the published lease is gone, expired, or no
        longer this replica's generation: an expired lease is never
        revived, even if no peer took it yet."""
        with self._lock:
            held = self._held.get(jid)
        if held is None:
            return False
        now = self._clock()
        with self._locked(jid):
            cur = self.lease_of(jid)
            if (cur is None or cur.replica != self.replica
                    or cur.gen != held.gen or cur.expired(now)):
                self._mark_lost(jid)
                return False
            lease = Lease(job=jid, replica=self.replica, ts=now,
                          expires=now + self.lease_s, gen=cur.gen)
            self._write_lease(lease)
        with self._lock:
            self._held[jid] = lease
        return True

    def adopt(self, jid: str) -> bool:
        """Take over an expired lease (or claim an absent one): the
        failover path for a dead peer's jobs.  Bumps ``gen`` so the
        previous owner's renew never matches.  Refuses while the lease is
        validly held by a peer."""
        from splatt_tpu_torch.utils import faults

        faults.maybe_fail("fleet.adopt")
        now = self._clock()
        with self._locked(jid):
            cur = self.lease_of(jid)
            if cur is not None and not cur.expired(now) \
                    and cur.replica != self.replica:
                return False
            gen = (cur.gen + 1) if cur is not None else 1
            lease = Lease(job=jid, replica=self.replica, ts=now,
                          expires=now + self.lease_s, gen=gen)
            self._write_lease(lease)
        with self._lock:
            self._held[jid] = lease
            self._lost.discard(jid)
        return True

    def release(self, jid: str) -> None:
        """Drop a held lease (the job reached a terminal state).  A lease
        this replica no longer owns is left to its owner."""
        with self._lock:
            held = self._held.pop(jid, None)
            self._lost.discard(jid)
        if held is None:
            return
        with self._locked(jid):
            cur = self.lease_of(jid)
            if cur is not None and cur.replica == self.replica \
                    and cur.gen == held.gen:
                try:
                    os.unlink(self._lease_path(jid))
                    # the sidecar too, or leases/ grows a file per job;
                    # job ids are never reused after a terminal release
                    os.unlink(os.path.join(
                        self.leases_dir, f"{_safe_name(jid)}.lock"))
                except OSError:
                    pass

    def lost(self, jid: str) -> bool:
        """Whether this replica lost its lease on `jid` (a renew was
        refused): the running job's stop poll reads it and abandons
        without committing."""
        with self._lock:
            return jid in self._lost

    def held(self) -> List[str]:
        with self._lock:
            return sorted(self._held)

    def _mark_lost(self, jid: str) -> None:
        with self._lock:
            if jid in self._held:
                del self._held[jid]
                self._lost.add(jid)
        from splatt_tpu_torch import resilience, trace

        resilience.run_report().add(
            "lease_expired", job=jid, replica=self.replica, role="owner")
        trace.metric_inc("splatt_fleet_lease_expired_total", role="owner")

    # -- membership heartbeat ------------------------------------------------

    def beat(self) -> List[str]:
        """One heartbeat: publish this replica's membership lease
        (liveness, warm regimes, load) and renew every held job lease.
        Returns the jobs whose renewal was refused.  A failure degrades
        classified: a missed beat makes this replica look dead sooner
        (peers adopt after ``lease_s``), never a crash."""
        from splatt_tpu_torch import resilience
        from splatt_tpu_torch.utils import faults

        lost: List[str] = []
        try:
            faults.maybe_fail("fleet.heartbeat")
            now = self._clock()
            with self._lock:
                regimes = sorted(self._regimes)
                active = len(self._held)
                held = list(self._held)
            rec = {"replica": self.replica, "pid": os.getpid(),
                   "ts": now, "expires": now + self.lease_s,
                   "regimes": regimes, "active": active}
            if self.metrics_path:
                rec["metrics"] = self.metrics_path
            from splatt_tpu_torch.utils.durable import publish_json

            publish_json(os.path.join(self.replicas_dir,
                                      f"{self.replica}.json"), rec)
            for jid in held:
                if not self.renew(jid):
                    lost.append(jid)
        except Exception as e:
            import sys

            cls = resilience.classify_failure(e)
            print(f"splatt-fleet[{self.replica}]: heartbeat degraded "
                  f"({cls.value}: "
                  f"{resilience.failure_message(e)[:120]}); peers may "
                  f"adopt after {self.lease_s:g}s", file=sys.stderr)
        return lost

    def peers(self) -> Dict[str, dict]:
        """Live peers (unexpired heartbeats, this replica excluded):
        replica -> its heartbeat record.  Dead or malformed heartbeat
        files read as absent."""
        out: Dict[str, dict] = {}
        now = self._clock()
        try:
            names = os.listdir(self.replicas_dir)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.replicas_dir, name)) as f:
                    rec = json.load(f)
                rid = str(rec["replica"])
                if rid == self.replica:
                    continue
                if float(rec.get("expires", 0)) > now:
                    out[rid] = rec
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    def replica_alive(self, rid: str) -> bool:
        """Whether `rid`'s membership lease is current (itself: yes)."""
        if rid == self.replica:
            return True
        return rid in self.peers()

    def retire(self) -> None:
        """Remove this replica's heartbeat (a graceful exit): peers stop
        routing around it at once instead of waiting out the lease."""
        try:
            os.unlink(os.path.join(self.replicas_dir,
                                   f"{self.replica}.json"))
        except OSError:
            pass

    # -- warm-regime advertisement (affinity routing, serve.py) --------------

    def add_regime(self, key: Optional[str]) -> None:
        """Advertise a shape regime as warm here (published at the next
        beat)."""
        if key:
            with self._lock:
                self._regimes.add(str(key))

    def warm(self, key: Optional[str]) -> bool:
        """Whether this replica is warm for `key`."""
        if not key:
            return False
        with self._lock:
            return key in self._regimes

    def peer_warm(self, key: Optional[str],
                  peers: Optional[Dict[str, dict]] = None
                  ) -> Optional[str]:
        """The least-loaded live peer advertising `key` warm, or None
        (`peers` reuses a snapshot of :meth:`peers`)."""
        if not key:
            return None
        if peers is None:
            peers = self.peers()
        best = None
        for rid, rec in sorted(peers.items()):
            if key in (rec.get("regimes") or []):
                load = int(rec.get("active", 0))
                if best is None or load < best[0]:
                    best = (load, rid)
        return best[1] if best else None

    def active_count(self) -> int:
        with self._lock:
            return len(self._held)


def _safe_name(name: str) -> str:
    """`name`, when it is safe as a file name; else ValueError."""
    if not _NAME_RE.match(name):
        raise ValueError(
            f"fleet name {name!r} is not filesystem-safe (want "
            f"[A-Za-z0-9][A-Za-z0-9._-]*, max 64 chars)")
    return name


def job_regime(spec: dict) -> Optional[str]:
    """The shape-regime key of a job spec: the plan cache's granularity
    (power-of-two dim and nnz buckets, :func:`tune.shape_regime`) and the
    rank, so "same regime" means "hits the same warm plans", the
    affinity-routing and coalescing key.  File-tensor jobs give None (the
    shape is unknown without loading; they route by load only), and so do
    predicts, which never wait on affinity or coalescing."""
    if str(spec.get("kind") or "cpd") == "predict":
        return None
    syn = spec.get("synthetic")
    if not isinstance(syn, dict) or not syn.get("dims"):
        return None
    from splatt_tpu_torch.tune import shape_regime

    try:
        dims = [int(d) for d in syn["dims"]]
        nnz = int(syn.get("nnz", 1000))
        rank = int(spec.get("rank", 8))
    except (TypeError, ValueError):
        return None
    return f"{shape_regime(dims, nnz)}:r{rank}"
