"""The native host sort (≙ the ``sort_perm`` entry of ``splatt_tpu/native.py``).

Every blocked-layout build starts by sorting the nonzeros by one mode, then
the others (``coo.SparseTensor.sort_order``).  ``np.lexsort`` does that in
one pass per key; ``csrc/host_sort.cpp`` buckets the leading mode by a
counting sort and sorts each slice on the other modes packed into one
128-bit key, with the same stable permutation.

At first use :func:`build` compiles ``csrc/host_sort.cpp`` with ``g++ -O3
-shared -fPIC`` into ``splatt_tpu_torch/_build/`` under a name hashed from
the source, writing to a private name and renaming it into place, so
concurrent builds (test workers, ranks) never load a half-written library;
``ctypes`` loads it.  :func:`sort_perm` returns None when the library
cannot be built or loaded, or when it declines the input (a partial mode
order, a leading mode too long for its buckets, an index outside its
dim), and the caller sorts with ``np.lexsort``.  :func:`available` says
which of the two a process runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host_sort.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: longest leading mode the counting buckets take (one int64 count per
#: index); a longer one, past four counts per nonzero, sorts with lexsort
MAX_BUCKETS = 1 << 24

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: why the library could not be built or loaded in this process (it is
#: not tried again)
_ERROR: Optional[str] = None


def lib_path() -> Path:
    """The library built from the source, named by a hash of the source
    and the flags so an edit never loads a stale build."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"host_sort-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns the path.
    Raises RuntimeError when there is no ``g++`` or the compile fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host sort needs a "
                           "C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp.so")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises RuntimeError when
    it cannot be built or loaded (the reason is kept, and a later call
    raises it again without another attempt)."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise RuntimeError(_ERROR)
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _ERROR = f"native host sort unavailable: {e}"
            raise RuntimeError(_ERROR) from e
        fn = lib.splatt_sort_perm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the native sort runs in this process (it builds on the
    first call)."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def sort_perm(inds: np.ndarray, dims: Sequence[int],
              mode_order: Sequence[int]) -> Optional[np.ndarray]:
    """The stable permutation sorting the ``(nmodes, nnz)`` coordinates
    lexicographically by `mode_order` (its first entry the primary key),
    or None: the library is unavailable, `mode_order` is not a full
    order of the modes, the leading mode is too long for its buckets
    (:data:`MAX_BUCKETS`, unless the tensor has four nonzeros a bucket),
    or an index lies outside its dim."""
    nmodes, nnz = int(inds.shape[0]), int(inds.shape[1])
    order = [int(m) for m in mode_order]
    # the C comparator walks every mode after the first: a partial order
    # (the other modes left unordered) is lexsort's
    if len(order) != nmodes or sorted(order) != list(range(nmodes)):
        return None
    if int(dims[order[0]]) > max(MAX_BUCKETS, 4 * nnz):
        return None
    if not available():
        return None
    lib = library()
    inds = np.ascontiguousarray(inds, dtype=np.int64)
    dims_arr = np.ascontiguousarray(dims, dtype=np.int64)
    order_arr = np.asarray(order, dtype=np.int32)
    perm = np.empty(nnz, dtype=np.int64)
    rc = lib.splatt_sort_perm(inds.ctypes.data, nnz, nmodes,
                              dims_arr.ctypes.data, order_arr.ctypes.data,
                              perm.ctypes.data)
    return perm if rc == 0 else None
