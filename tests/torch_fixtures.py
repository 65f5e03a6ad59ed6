"""Fixtures every test of the PyTorch port shares.

Dispatch and ``BlockedSparse.compile`` read the autotuner's plan cache
(SPLATT_AUTOTUNE defaults to on), whose default file lives in the port's
build directory and outlives a run of ``splatt tune``.  A test module that
imports :func:`private_tune_cache` runs each test against an empty cache
file of its own, so plans left there never change the engine plans,
layouts or launch counts the tests assert.

:func:`private_jax_native` gives the JAX package's native library a build
of its own for the session.  That package compiles ``_native.so`` in
place with ``g++ -o <final path>`` at first use and marks a failed load
as permanent for the process, so on a fresh checkout a test worker that
loads while another worker's ``g++`` is still writing the file loses the
library for the rest of its run.  The private build is compiled once,
under a file lock, into a name keyed by the source and the flags, and
renamed into place whole.
"""

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import pytest

from splatt_tpu_torch import tune


@pytest.fixture(autouse=True)
def private_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SPLATT_TUNE_CACHE", str(tmp_path / "tune_cache.json"))
    tune.reset_memo()
    yield
    tune.reset_memo()


#: the JAX package's compile line (splatt_tpu/native.py, ``_build``):
#: first with ``-march=native``, then without for a toolchain that
#: rejects it
JAX_NATIVE_FLAGS = (("-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17"),
                    ("-O3", "-shared", "-fPIC", "-std=c++17"))


def build_jax_native(src: Path, out_dir: Path) -> Path:
    """Compile the JAX package's native source into `out_dir` once and
    return the library's path.  The name carries a hash of the source and
    the flags; the build runs under an ``fcntl`` lock on a file beside it,
    writes a private name and renames it into place, so concurrent callers
    build it once and never see a half-written file.  Raises RuntimeError
    when every compile line fails."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(repr(JAX_NATIVE_FLAGS).encode())
    out = out_dir / f"jax_native-{digest.hexdigest()[:16]}.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        errors = []
        for flags in JAX_NATIVE_FLAGS:
            r = subprocess.run(["g++", *flags, "-o", str(tmp), str(src)],
                               capture_output=True, text=True, timeout=300)
            if r.returncode == 0:
                os.replace(tmp, out)
                return out
            errors.append(r.stderr)
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed on " + src.name + ":\n"
                           + "\n".join(errors))


@pytest.fixture(scope="session")
def private_jax_native(tmp_path_factory):
    """The JAX package's ``native`` module, pointed for the session at a
    library built by :func:`build_jax_native` (shared by the session's
    workers, in the parent of their temporary directories), with its
    loader's state reset.  Skips where there is no ``g++``; a build or a
    load that fails is an error, never a skip."""
    from splatt_tpu import native as jnative

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native runtime cannot build")
    so = build_jax_native(Path(jnative._SRC_PATH),
                          tmp_path_factory.getbasetemp().parent
                          / "jax_native")
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_SO_PATH", so)
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_load_failed", False)
    assert jnative.available(), f"the JAX package's library {so} did not load"
    yield jnative
    mp.undo()
