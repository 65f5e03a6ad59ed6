"""The native host runtime (≙ ``splatt_tpu/native.py``): the layout sort,
the ``.tns`` parser, the streamed text-to-binary converter and the host
MTTKRP engine, in C++ under a plain C interface.

- :func:`sort_perm`: every blocked-layout build starts by sorting the
  nonzeros by one mode, then the others (``coo.SparseTensor.sort_order``).
  ``csrc/host_sort.cpp`` buckets the leading mode by a counting sort and
  sorts each slice on the other modes packed into one 128-bit key, with
  the stable permutation ``np.lexsort`` gives.
- :func:`parse_tns`: one buffered pass over a coordinate text file
  (``csrc/host_io.cpp``), which ``io.load`` takes first.
- :func:`stream_to_bin`: a text file to a ``.bin`` file in two passes with
  ~8 MB of buffers, for tensors larger than the host's memory (the
  ``convert ... bin`` verb).
- :func:`mttkrp`: a one-core MTTKRP over a v1 layout's host arrays, run
  only when asked (``ops.mttkrp.mttkrp(..., impl="native")`` on CPU
  tensors, the ``native`` algorithm of ``bench_algs.py``).

At first use :func:`build` compiles both sources with ``g++ -O3 -shared
-fPIC`` into one library in ``splatt_tpu_torch/_build/``, named by a hash
of the sources and the flags, writing to a private name and renaming it
into place, so concurrent builds (test workers, ranks) never load a
half-written library; ``ctypes`` loads it.  Every entry returns None (False
for :func:`stream_to_bin`) when the library cannot be built or loaded, and
its caller takes the numpy path; :func:`available` says which of the two a
process runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "host_sort.cpp", _PKG / "csrc" / "host_io.cpp")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: longest leading mode the counting buckets take (one int64 count per
#: index); a longer one, past four counts per nonzero, sorts with lexsort
MAX_BUCKETS = 1 << 24

#: most modes the host MTTKRP takes (its per-mode pointer arrays)
MTTKRP_MAX_MODES = 8

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: why the library could not be built or loaded in this process (it is
#: not tried again)
_ERROR: Optional[str] = None


def lib_path() -> Path:
    """The library built from the sources, named by a hash of the sources
    and the flags so an edit never loads a stale build."""
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"splatt_host-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless their library exists; returns the path.
    Raises RuntimeError when there is no ``g++`` or the compile fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime needs a "
                           "C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp.so")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                        *(str(s) for s in SOURCES)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on "
                           f"{', '.join(s.name for s in SOURCES)}:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    """The C interface's argument and result types."""
    vp, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.splatt_sort_perm.restype = cint
    lib.splatt_sort_perm.argtypes = [vp, i64, cint, vp, vp, vp]
    lib.tns_open.restype = vp
    lib.tns_open.argtypes = [ctypes.c_char_p]
    lib.tns_rows.restype = i64
    lib.tns_rows.argtypes = [vp]
    lib.tns_cols.restype = cint
    lib.tns_cols.argtypes = [vp]
    lib.tns_fill.restype = cint
    lib.tns_fill.argtypes = [vp, vp, vp]
    lib.tns_close.restype = None
    lib.tns_close.argtypes = [vp]
    lib.tns_stream_to_bin.restype = cint
    lib.tns_stream_to_bin.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for name in ("mttkrp_f32", "mttkrp_f64"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [vp, vp, i64, i64, cint, cint, ctypes.POINTER(vp), vp,
                       cint, vp, cint]


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
            _declare(lib)
        except (OSError, AttributeError, RuntimeError,
                subprocess.SubprocessError) as e:
            _ERROR = f"native host runtime unavailable: {e}"
            raise RuntimeError(_ERROR) from e
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the native runtime runs in this process (it builds on the
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


def parse_tns(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a coordinate text file into ``(inds (nmodes, nnz) int64, vals
    f64)``, the indices as written (the caller shifts a 1-indexed file).
    None when the library is unavailable, the file cannot be read, or its
    first data row has fewer than two fields: the caller parses in
    Python.  Raises ValueError on a malformed row (ragged, short,
    non-numeric), without its location."""
    if not available():
        return None
    lib = library()
    h = lib.tns_open(os.fsencode(path))
    if not h:
        return None
    try:
        nrows = lib.tns_rows(h)
        nmodes = lib.tns_cols(h) - 1
        inds = np.empty((nmodes, nrows), dtype=np.int64)
        vals = np.empty(nrows, dtype=np.float64)
        rc = lib.tns_fill(h, inds.ctypes.data, vals.ctypes.data)
    finally:
        lib.tns_close(h)
    if rc != 0:
        raise ValueError(f"{path}: malformed tensor file (native parser "
                         f"rc={rc})")
    return inds, vals


def stream_to_bin(src: str, dst: str) -> bool:
    """Convert a coordinate text file to a ``.bin`` file in two passes
    with ~8 MB of buffers (for tensors larger than the host's memory),
    the layout ``io.save`` writes.  False when the library is unavailable
    (the caller loads and saves).  Raises OSError when a file cannot be
    opened or a write fails, ValueError on malformed input (a negative
    coordinate included); either way no partial ``.bin`` is left."""
    if not available():
        return False
    rc = library().tns_stream_to_bin(os.fsencode(src), os.fsencode(dst))
    if rc == 0:
        return True
    # never leave a partial binary with a valid header behind
    try:
        os.unlink(dst)
    except OSError:
        pass
    if rc in (1, 5):
        raise OSError(f"cannot open {src if rc == 1 else dst}")
    if rc in (6, 7):
        raise OSError(f"{dst}: write failed during conversion (disk full, "
                      f"I/O error, or {src} changed, rc={rc})")
    raise ValueError(f"{src}: malformed tensor file (stream converter "
                     f"rc={rc})")


def mttkrp(inds: np.ndarray, vals: np.ndarray, factors, mode: int,
           dims: Sequence[int], sorted_by_mode: bool,
           nnz: int) -> Optional[np.ndarray]:
    """One-core MTTKRP of `mode` over a blocked layout's host arrays
    (≙ the reference's fiber loops, src/mttkrp.c:427-463, as a flat pass
    that accumulates runs of a sorted output row).

    inds: (nmodes, nnz_pad) int32; vals: (nnz_pad,) f32 or f64; factors:
    per mode a (dims[k], rank) array of vals' dtype (``factors[mode]`` is
    not read).  Only the first `nnz` entries are read: the padded tail's
    sentinel rows lie outside the factors.  Returns the (dims[mode],
    rank) output in vals' dtype, or None: the library is unavailable,
    the dtypes are not one of f32/f64 throughout, or there are more than
    :data:`MTTKRP_MAX_MODES` modes."""
    vals = np.ascontiguousarray(vals)
    if vals.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    if any(np.asarray(f).dtype != vals.dtype for f in factors):
        return None
    inds = np.ascontiguousarray(inds, dtype=np.int32)
    nmodes, nnz_pad = inds.shape
    if nmodes > MTTKRP_MAX_MODES or not available():
        return None
    lib = library()
    fn = lib.mttkrp_f32 if vals.dtype == np.float32 else lib.mttkrp_f64
    facs = [np.ascontiguousarray(f) for f in factors]
    rank = facs[0].shape[1]
    fac_ptrs = (ctypes.c_void_p * nmodes)(*[f.ctypes.data for f in facs])
    dims_arr = np.ascontiguousarray(dims, dtype=np.int64)
    out = np.zeros((int(dims[mode]), rank), dtype=vals.dtype)
    fn(inds.ctypes.data, vals.ctypes.data, min(int(nnz), nnz_pad), nnz_pad,
       nmodes, mode, fac_ptrs, dims_arr.ctypes.data, rank, out.ctypes.data,
       1 if sorted_by_mode else 0)
    return out
