"""Durable writes (≙ splatt_tpu/utils/durable.py): atomic publish of a
whole file, and the journal's durable append.

:func:`publish_file` / :func:`publish_bytes` / :func:`publish_text` /
:func:`publish_json` write the full content to a same-directory temp
file, ``fsync`` it, ``os.replace`` it onto the destination and fsync the
parent directory.  A reader never sees a torn file, and a crash between
the write and the rename leaves only debris.  The checkpoint writer
(``cpd.py``), the trace exporter (``trace.py``), the model store
(``predict.py``) and the serve daemon's result files publish through them.

:func:`append_line` appends one newline-terminated record and fsyncs it
under an exclusive ``flock``, first healing a dead writer's torn tail (a
final line with no newline), so crash debris never merges into the next
record: the serve journal's protocol.  :func:`ring_append` is the
bounded, unsynced append of a single-writer ring file.  Both leave the
bytes the JAX package's helpers leave.

The helpers raise on failure: the caller decides whether a failed write
is fatal (a checkpoint) or degrades classified (a trace export).
"""

from __future__ import annotations

import json
import os
from typing import Optional

try:
    import fcntl as _fcntl
except ImportError:  # non-POSIX: appends degrade to in-process safety
    _fcntl = None


def _fsync_dir(path: str) -> None:
    """Fsync the parent directory of `path`, making a just-completed
    ``os.replace`` (a directory-entry update) itself durable.  Without
    this the RENAME can be lost on power failure even though the
    file's content was fsynced.  Best-effort
    on filesystems/platforms where directories cannot be opened or
    fsynced (the rename then has the platform's weaker durability,
    which is the best available)."""
    dirpath = os.path.dirname(os.path.abspath(str(path))) or "."
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(dirpath, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def publish_file(tmp: str, path: str, fsync: bool = True) -> None:
    """Atomically publish an already-written temp file onto `path`:
    fsync the temp's content, ``os.replace``, then fsync the parent
    directory so the rename itself survives power loss.  For callers
    whose content is produced by a writer that needs the filename
    itself (``np.savez`` in the checkpoint writer)."""
    if fsync:
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path)


def publish_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Atomically publish `data` as the full new content of `path`
    (same-directory temp write + fsync + ``os.replace`` + parent-dir
    fsync).  The temp name carries the pid so concurrent publishers in
    different processes never collide on debris."""
    path = str(path)
    tmp = f"{path}.~{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def publish_text(path: str, text: str, fsync: bool = True) -> None:
    publish_bytes(path, text.encode(), fsync=fsync)


def publish_json(path: str, obj, fsync: bool = True,
                 indent: Optional[int] = None,
                 sort_keys: bool = False) -> None:
    publish_bytes(path, json.dumps(obj, indent=indent,
                                   sort_keys=sort_keys).encode(),
                  fsync=fsync)



def append_line(path: str, data: bytes, heal_tail: bool = True,
                fsync: bool = True, use_flock: bool = True) -> None:
    """Durably append one newline-terminated record to `path`,
    serialized across processes by an exclusive ``flock`` on the file
    itself (≙ splatt_tpu/utils/durable.py:124-156).  With `heal_tail`, a
    dead writer's partial final line is newline-terminated first;
    otherwise the two lines would merge into one garbage line and this
    record would be lost.  Threads sharing one appender serialize
    themselves: the journal holds its own lock around this call."""
    if not data.endswith(b"\n"):
        data = data + b"\n"
    with open(path, "ab") as f:
        if _fcntl is not None and use_flock:
            _fcntl.flock(f.fileno(), _fcntl.LOCK_EX)
        fresh = f.tell() == 0
        try:
            if heal_tail and f.tell() > 0:
                with open(path, "rb") as r:
                    r.seek(-1, os.SEEK_END)
                    if r.read(1) != b"\n":
                        f.write(b"\n")
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        finally:
            if _fcntl is not None and use_flock:
                _fcntl.flock(f.fileno(), _fcntl.LOCK_UN)
    if fsync and fresh:
        # the first append created the file: fsync the directory entry
        # too, or a crash can lose the whole journal
        _fsync_dir(path)


def ring_append(path: str, lines: list, max_bytes: int) -> int:
    """Append a batch of newline-terminated records to `path` and, once
    the file outgrows `max_bytes`, rotate it atomically to ``<path>.1``
    (one previous generation kept), so the file stays bounded; returns
    its size after the append (≙ splatt_tpu/utils/durable.py:159-184).

    No fsync and no flock: a ring has one writer, and a write plus flush
    reaches the page cache, which survives the writer being killed; only
    a host power loss can eat the tail, and readers tolerate a torn
    final line."""
    path = str(path)
    with open(path, "ab") as f:
        for line in lines:
            if not line.endswith(b"\n"):
                line = line + b"\n"
            f.write(line)
        f.flush()
        size = f.tell()
    if size >= max_bytes:
        os.replace(path, path + ".1")
        size = 0
    return size
