"""Durable writes: atomic publish of a whole file
(≙ splatt_tpu/utils/durable.py:48-122).

:func:`publish_file` / :func:`publish_bytes` / :func:`publish_text` /
:func:`publish_json` write the full content to a same-directory temp
file, ``fsync`` it, ``os.replace`` it onto the destination and fsync the
parent directory.  A reader never sees a torn file, and a crash between
the write and the rename leaves only debris.  The checkpoint writer
(``cpd.py``) and the trace exporter (``trace.py``) publish through them.

The helpers raise on failure: the caller decides whether a failed write
is fatal (a checkpoint) or degrades classified (a trace export).
"""

from __future__ import annotations

import json
import os
from typing import Optional


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

