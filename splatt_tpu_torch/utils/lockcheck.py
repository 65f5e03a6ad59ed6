"""SPLATT_LOCKCHECK: a runtime lock-ownership sanitizer
(≙ splatt_tpu/utils/lockcheck.py).

The port's shared structures (the serve daemon's job table, queues and
running set, the plan cache's memo) are each guarded by one lock.  With
``SPLATT_LOCKCHECK=1`` they are wrapped in owner-assertion proxies whose
every mutating method asserts that the owning lock is held by the current
thread, so a mutation made without its lock raises
:class:`LockOwnershipError` at the call site, with its stack, in the test
that reaches it.

Disabled (the default), :func:`guard_lock` and :func:`guard` return their
arguments untouched: no wrappers and no cost.  :data:`WRAPPED` names what
was wrapped in this process.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

#: names registered by :func:`guard` in this process: name -> the
#: guarding OwnedLock
WRAPPED: Dict[str, "OwnedLock"] = {}


def enabled() -> bool:
    """Whether the sanitizer is armed (``SPLATT_LOCKCHECK`` truthy).
    Read per call: a test sets it before constructing the object under
    test."""
    from splatt_tpu_torch.utils.env import read_env

    return str(read_env("SPLATT_LOCKCHECK") or "").lower() in (
        "1", "on", "true", "yes")


class LockOwnershipError(AssertionError):
    """A guarded shared structure was mutated without its owning lock
    held by the current thread."""


class OwnedLock:
    """A ``threading.Lock`` wrapper that records the owning thread, which
    a non-reentrant Lock cannot report by itself.  It has the ``with`` /
    acquire / release surface of the wrapped lock."""

    def __init__(self, lock=None):
        self._lock = lock if lock is not None else threading.Lock()
        self._owner: Optional[int] = None

    def acquire(self, *a, **kw) -> bool:
        ok = self._lock.acquire(*a, **kw)
        if ok:
            self._owner = threading.get_ident()
        return ok

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()


def guard_lock(lock=None):
    """`lock` wrapped for ownership tracking when the sanitizer is armed,
    else `lock` itself (a fresh Lock when None)."""
    if not enabled():
        return lock if lock is not None else threading.Lock()
    return OwnedLock(lock)


def _assert_owned(lock: OwnedLock, name: str) -> None:
    if not lock.held_by_me():
        raise LockOwnershipError(
            f"SPLATT_LOCKCHECK: shared structure {name!r} mutated "
            f"without its owning lock held by this thread")


def _make_guarded(base, mutators):
    """A subclass of `base` whose listed mutators assert ownership."""
    ns = {"__slots__": ("_lc_lock", "_lc_name")}

    def mk(meth):
        orig = getattr(base, meth)

        def guarded(self, *a, **kw):
            _assert_owned(self._lc_lock, self._lc_name)
            return orig(self, *a, **kw)

        guarded.__name__ = meth
        return guarded

    for meth in mutators:
        if hasattr(base, meth):
            ns[meth] = mk(meth)
    return type(f"Guarded{base.__name__.capitalize()}", (base,), ns)


_DICT_MUTATORS = ("__setitem__", "__delitem__", "pop", "popitem",
                  "clear", "update", "setdefault")
_LIST_MUTATORS = ("__setitem__", "__delitem__", "append", "extend",
                  "insert", "remove", "pop", "clear", "sort", "reverse")
_SET_MUTATORS = ("add", "discard", "remove", "pop", "clear", "update",
                 "difference_update", "intersection_update",
                 "symmetric_difference_update")

_GuardedDict = _make_guarded(dict, _DICT_MUTATORS)
_GuardedList = _make_guarded(list, _LIST_MUTATORS)
_GuardedSet = _make_guarded(set, _SET_MUTATORS)


def guard(struct, lock, name: str):
    """`struct` (a dict, list or set) wrapped in an owner-assertion proxy
    bound to `lock` (an :class:`OwnedLock`); `struct` itself when the
    sanitizer is disarmed or the lock is a plain Lock, which cannot
    report its owner."""
    if not enabled() or not isinstance(lock, OwnedLock):
        return struct
    if isinstance(struct, dict):
        out = _GuardedDict(struct)
    elif isinstance(struct, list):
        out = _GuardedList(struct)
    elif isinstance(struct, set):
        out = _GuardedSet(struct)
    else:
        return struct
    out._lc_lock = lock
    out._lc_name = name
    WRAPPED[name] = lock
    return out
