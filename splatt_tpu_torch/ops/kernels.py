"""Hand-written CUDA kernels, their plain PyTorch versions and their loader.

Counterpart of ``splatt_tpu/ops/pallas_kernels.py``.  The CUDA sources live
in ``splatt_tpu_torch/csrc/``.  At first use, :func:`load_library` compiles
each source with ``nvcc`` for ``sm_90a`` into its own shared library with a
plain C interface under ``splatt_tpu_torch/_build/`` (one ``nvcc`` per
source, started together) and loads them with ``ctypes``.

Seven wrappers here, one per single-card TPU kernel (the two ring
kernels of ``csrc/ring.cu`` have theirs in ``parallel/ring_kernels.py``,
and the eigensolver of ``csrc/sym_eig.cu``, which replaces a library call,
has its wrapper in ``ops/linalg.py``):

- :func:`fused_mttkrp_t`, :func:`fused_mttkrp_tg`, :func:`fused_mttkrp`
  (``csrc/fused_mttkrp.cu``): gather + Hadamard + row reduce over a v1
  blocked layout, in the sorted (block partials) or accumulate (totals)
  contract;
- :func:`fused_mttkrp_v2` (``csrc/fused_mttkrp_v2.cu``): the same over a
  compact v2 layout, decoding its encoded streams in registers;
- :func:`onehot_reduce_sorted`, :func:`onehot_reduce_full`
  (``csrc/onehot_reduce.cu``): the same reduction of precomputed products;
  all six walk a block with several entries' rows (of the tables, or of
  the products) in flight per warp and vector row loads
  (``csrc/gather_walk.cuh``; :func:`gather_vec` picks the load width);
- :func:`fused_dense` (``csrc/fused_dense.cu``): a dense mode's value
  tiles times the Khatri-Rao operand it generates, on the tensor cores.

On a card the kernels take f32 or bf16 values, tables and products and
write f32.  A bf16 product is rounded to bf16 after each multiply, as the
plain versions' bf16 ``prod * rows`` is, so a kernel and its plain
version differ only in the order of their f32 sums; ``fused_dense`` with
f32 factors also in its 3xTF32 products (about 2^-21 of each, emulated by
:func:`fused_dense_tf32x3`).

A wrapper runs its plain version for tensors that lie on the CPU.  For CUDA
tensors it launches the kernel on the current stream or raises: a launch
the card refuses (:class:`KernelLaunchError`, which the engine chain may
demote), any other CUDA error, a failed build or load, or an operand the
kernel does not take.  Each wrapper's ``.launches`` counts its launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from splatt_tpu_torch.config import MAX_NMODES, acc_dtype

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_mttkrp.cu", "fused_mttkrp_v2.cu", "onehot_reduce.cu",
           "fused_dense.cu", "ring.cu", "sym_eig.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: largest rank fused_mttkrp_t, fused_mttkrp and fused_mttkrp_v2 hold in
#: registers (32 lanes x 8 sums); fused_mttkrp_tg and the reductions tile
#: any rank
MAX_RANK = 256
#: shared memory a CTA may use (227 KB): the sorted contract's (width,
#: cols) f32 tile and the scratch before it
SMEM_TILE_BYTES = 232448
#: the scratch of csrc/fused_mttkrp.cu before its tile: each warp's gather
#: ids, [7 modes][32 entries] int32 (kIdsInts)
FUSED_SCRATCH_BYTES = 8 * 7 * 32 * 4
#: the scratch of csrc/onehot_reduce.cu before its tile: each warp's 32
#: entry indices, int32 (kIdxInts)
REDUCE_SCRATCH_BYTES = 8 * 32 * 4
#: columns of the reductions' rank tile above that rank (one tile up to
#: it; :func:`reduce_rank_tile`), chosen by timing tiles of 128 and 256
#: in turns at R = 192, 256 and 512 on an H100 (PERF.md): the sorted
#: launch within 3% either way, the full launch's flushes up to 1.35x
#: (f32) and 2x (bf16) slower at 256
RANK_TILE = 128
#: columns of fused_mttkrp_tg's rank tile above that rank (one tile up to
#: it), chosen by timing 64, 128 and 256 in turns at R = 512 on an H100
#: (PERF.md): every launch gathers one tile's columns of the tables,
#: which stay resident in the 50 MB L2
TG_RANK_TILE = 128
#: the widest row load of csrc/gather_walk.cuh, bytes per lane
GATHER_LOAD_BYTES = 16
#: csrc/fused_dense.cu's CTA: output rows (two wgmma warpgroups of 64)
DENSE_ROWS = 128
#: the rank tiles N csrc/fused_dense.cu is built for (wgmma's N): R
#: rounded up to the next, more than 96 on grid.y (N = 128 with bf16
#: values and factors faulted on an H100).  The steps between are not
#: built: at R = 50, N = 64 ran as fast as N = 56 on an H100 (PERF.md)
DENSE_N_TILES = (8, 16, 32, 64, 96)
#: fused_dense's one static limit: the rank tiles run on grid.y, at most
#: 65535 of them.  It needs no residency limit: a CTA holds a ring of
#: (128, chunk) value boxes and (chunk, N) Khatri-Rao tiles, whatever the
#: span
DENSE_MAX_RANK = 65535 * DENSE_N_TILES[-1]

#: cudaError_t codes of a launch the card refused (bad configuration, too
#: many resources, an allocation): the kernel never ran and the context is
#: intact.  Any other code (an illegal address or launch failure left
#: sticky by earlier work, a kernel image the card cannot run) is not a
#: refusal of this launch.
LAUNCH_REFUSED = {1: "cudaErrorInvalidValue",
                  2: "cudaErrorMemoryAllocation",
                  9: "cudaErrorInvalidConfiguration",
                  701: "cudaErrorLaunchOutOfResources"}

_LOCK = threading.Lock()
_FNS: Optional[Dict[str, ctypes._CFuncPtr]] = None


class KernelLaunchError(RuntimeError):
    """The card refused a kernel's launch (:data:`LAUNCH_REFUSED`)."""


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return nvcc


def _lib_path(source: str) -> Path:
    """The library built from `source`, named by a hash of the source,
    the shared headers and the flags so an edit never loads a stale
    build."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict:
    """Compile each source in :data:`SOURCES` into its own shared
    library, one ``nvcc`` per source, all started together.  Sources
    already built are skipped unless `verbose`, which rebuilds with
    ``-Xptxas -v`` and returns nvcc's report (registers, shared memory,
    spills).  Returns the build seconds and the report."""
    todo = [s for s in SOURCES if verbose or not _lib_path(s).exists()]
    if not todo:
        return {"seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    procs = []
    for s in todo:
        # write to a private name, then rename: a concurrent build never
        # loads a half-written library
        lib = _lib_path(s)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        procs.append((s, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for s, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed on {s}:\n{out}")
            continue
        os.replace(tmp, _lib_path(s))
        logs.append(f"{s}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "log": "".join(logs)}


# C entry → (source, argument types); P pointer, I int, LL long long
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FUSED_ARGS = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I, _I,
               _I]
_ENTRIES = {
    "splatt_fused_mttkrp_t": ("fused_mttkrp.cu",
                              _FUSED_ARGS + [_I, _I, _P, _P]),
    "splatt_fused_mttkrp_tg": ("fused_mttkrp.cu",
                               _FUSED_ARGS + [_I, _I, _I, _P, _P]),
    "splatt_fused_mttkrp": ("fused_mttkrp.cu",
                            _FUSED_ARGS + [_I, _I, _I, _P, _P]),
    "splatt_fused_mttkrp_v2": ("fused_mttkrp_v2.cu",
                               [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "splatt_onehot_reduce_sorted": ("onehot_reduce.cu",
                                    [_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _P, _P]),
    "splatt_onehot_reduce_full": ("onehot_reduce.cu",
                                  [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _P, _P]),
    "splatt_fused_dense": ("fused_dense.cu",
                           [_P, _I, _P, _P, _I, _LL, _LL, _I, _I, _I, _I,
                            _I, _I, _P, _P]),
    "splatt_ring_gather": ("ring.cu", [_I, _P, _I, _I, _LL, _LL, _I, _LL,
                                       _P, _LL, _I, _LL, _LL, _P]),
    "splatt_ring_reduce": ("ring.cu", [_I, _P, _I, _I, _LL, _LL, _I, _LL,
                                       _P, _LL, _I, _P]),
    "splatt_ring_enable_peer": ("ring.cu", [_I, _I]),
    "splatt_ring_alloc_host": ("ring.cu", [_LL, _P, _P]),
    "splatt_sym_eig": ("sym_eig.cu", [_P, _I, _I, _I, _I, _I, _P, _P, _P,
                                      _P, _P]),
    "splatt_sym_eig_alloc_host": ("sym_eig.cu", [_LL, _P, _P]),
}

#: the value, table and product dtypes the kernels take on a card
CARD_FLOATS = (torch.float32, torch.bfloat16)

#: stream dtypes fused_mttkrp_v2 reads → its IdType code
#: (csrc/fused_mttkrp_v2.cu)
V2_ID_TYPES = {torch.uint8: 0, torch.uint16: 1, torch.int8: 2,
               torch.int16: 3, torch.int32: 4}
#: stream encodings fused_mttkrp_v2 reads → its Enc code
V2_ENCODINGS = {"loc": 0, "seg": 1, "delta": 2, "rle": 3}
#: ints of shared memory fused_mttkrp_v2 takes before its tile, beside the
#: S run ends of an RLE stream (kPrologueInts of csrc/fused_mttkrp_v2.cu:
#: per-warp delta sums and carries, bases, per-warp decoded ids)
V2_PROLOGUE_INTS = 8 * 8 + 8 + 8 + 8 * 8 + 8 * 8 * 32


def load_library() -> Dict[str, ctypes._CFuncPtr]:
    """Build (once) and load the kernel libraries; returns every C entry
    by name, with its argument and result types declared."""
    global _FNS
    with _LOCK:
        if _FNS is None:
            build()
            libs = {s: ctypes.CDLL(str(_lib_path(s))) for s in SOURCES}
            fns = {}
            for name, (source, argtypes) in _ENTRIES.items():
                fn = getattr(libs[source], name)
                fn.argtypes = argtypes
                fn.restype = _I
                fns[name] = fn
            _FNS = fns
        return _FNS


def _launch(name: str, *args) -> None:
    """Call C entry `name` on the current stream and raise on its
    cudaError_t: :class:`KernelLaunchError` for a refused launch,
    RuntimeError for any other error."""
    fn = load_library()[name]
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err in LAUNCH_REFUSED:
        raise KernelLaunchError(f"{name}: the card refused the launch "
                                f"({LAUNCH_REFUSED[err]} = {err})")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to `wrapper`'s launch count, under a lock: the serve
    daemon's worker threads launch the same kernels at once, and a bare
    ``+= 1`` on a function attribute can lose a count between threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    with _COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0


# -- operand contracts -------------------------------------------------------


def _check_tensor(name: str, t: torch.Tensor, dev, dtypes, shape,
                  strict: bool) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the layout on {dev}")
    if t.dtype not in dtypes:
        want = dtypes[0] if len(dtypes) == 1 else " or ".join(
            str(d) for d in dtypes)
        raise TypeError(f"{name} is {t.dtype}; expected {want}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if strict and not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_operands(layout, factors: Sequence[torch.Tensor], mode: int,
                   kernels: bool = True) -> None:
    """The caller's contract of a blocked MTTKRP: every operand on the
    layout's device; the index streams of a v1 layout (int32 ``(nmodes,
    nnz_pad)``) or of a v2 one (per mode a :data:`V2_ID_TYPES` stream of
    ``(nnz_pad,)`` ids or ``(nb, seg_width)`` RLE counts, and an int32
    ``(nb,)`` base), or of a dense layout (``(ntiles, tile, span)`` value
    tiles and a ``(span,)`` bool mask matching its geometry, serving only
    its own mode, each factor ``(dims[k], R)``); factor shapes ``(d_k,
    R)`` that match the layout, floating values and one floating dtype
    for the factors.  On a card, when a kernel may run (`kernels`), also
    what the kernels take: values and factors in :data:`CARD_FLOATS`,
    contiguous.  Raises ValueError or TypeError."""
    dense = layout.encoding == "dense"
    dev = layout.device
    strict = dev.type == "cuda" and kernels
    if layout.nmodes != len(factors) or not 2 <= len(factors) <= MAX_NMODES:
        raise ValueError(f"{len(factors)} factors for a {layout.nmodes}-mode "
                         f"layout (2..{MAX_NMODES} modes supported)")
    if not 0 <= mode < layout.nmodes:
        raise ValueError(f"mode {mode} out of range")
    R = int(factors[0].shape[1]) if factors[0].dim() == 2 else -1
    if R < 1:
        raise ValueError("factors must be (rows, R) with R >= 1")
    dtype = factors[0].dtype
    if not dtype.is_floating_point:
        raise TypeError(f"factors are {dtype}; a floating dtype is needed")
    values = layout.tiles if dense else layout.vals
    if not values.dtype.is_floating_point:
        raise TypeError(f"values are {values.dtype}; a floating dtype "
                        f"is needed")
    floats = CARD_FLOATS if strict else (values.dtype,)
    if dense:
        if mode != layout.mode:
            raise ValueError(f"a dense layout of mode {layout.mode} serves "
                             f"only its own mode, not mode {mode}")
        geo = layout.geometry
        named = [("tiles", layout.tiles, floats,
                  (geo.ntiles, geo.tile, geo.span)),
                 ("mask", layout.mask, (torch.bool,), (geo.span,))]
        rows = layout.dims
    else:
        nb, B = layout.nblocks, layout.block
        named = [("vals", layout.vals, floats, (nb * B,)),
                 ("row_start", layout.row_start, (torch.int32,), (nb,))]
        rows = [int(U.shape[0]) for U in factors]
        if layout.base is None:
            named.append(("inds", layout.inds, (torch.int32,),
                          (layout.nmodes, nb * B)))
        else:
            ids = tuple(V2_ID_TYPES)
            for k, enc in enumerate(layout.stream_encs()):
                shape = ((nb, layout.seg_width) if enc == "rle"
                         else (nb * B,))
                named += [(f"inds[{k}]", layout.inds[k], ids, shape),
                          (f"base[{k}]", layout.base[k], (torch.int32,),
                           (nb,))]
    if strict and dtype not in CARD_FLOATS:
        raise TypeError(f"factors are {dtype}; the CUDA kernels take "
                        f"{CARD_FLOATS}")
    named += [(f"factors[{k}]", U, (dtype,), (int(rows[k]), R))
              for k, U in enumerate(factors)]
    for name, t, dtypes, shape in named:
        _check_tensor(name, t, dev, dtypes, shape, strict)
    if any(int(U.shape[0]) < 1 for U in factors):
        raise ValueError("every factor needs at least one row")


def _check_fused(layout, factors, mode: int, width: int,
                 max_rank: Optional[int], v2: bool = False) -> None:
    check_operands(layout, factors, mode)
    if layout.encoding == "dense":
        raise ValueError("a dense layout runs fused_dense")
    R = int(factors[0].shape[1])
    if max_rank is not None and R > max_rank:
        raise ValueError(f"rank {R} above the kernel's {max_rank}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if (layout.base is not None) != v2:
        raise ValueError(
            "fused_mttkrp_v2 reads a compact v2 layout's encoded streams"
            if v2 else "this kernel reads a v1 layout; decode a v2 layout "
            "with blocked.decode_to_v1 first")


def _check_reduce(local: torch.Tensor, prod: torch.Tensor,
                  width: int) -> None:
    if local.dim() != 2 or prod.dim() != 3 \
            or tuple(prod.shape[:2]) != tuple(local.shape):
        raise ValueError(f"ids {tuple(local.shape)} and products "
                         f"{tuple(prod.shape)} must be (nb, B) and "
                         f"(nb, B, R)")
    if min(prod.shape) < 1 or width < 1:
        raise ValueError("empty operands or width")
    if local.device != prod.device:
        raise ValueError(f"ids on {local.device}, products on "
                         f"{prod.device}")
    if local.dtype != torch.int32 or prod.dtype not in CARD_FLOATS:
        raise TypeError(f"ids {local.dtype}, products {prod.dtype}; the "
                        f"CUDA kernel takes int32 and float32 or bfloat16")
    if not (local.is_contiguous() and prod.is_contiguous()):
        raise ValueError("ids and products must be contiguous")


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _pointers(tensors) -> tuple:
    """A host array of the tensors' device pointers: (the argument, the
    array, which the caller keeps alive across the launch)."""
    arr = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _ints(values) -> tuple:
    """A host int array: (the argument, the array), as :func:`_pointers`."""
    arr = (ctypes.c_int * len(values))(*values)
    return ctypes.cast(arr, ctypes.c_void_p), arr


# -- fused gather + Hadamard + row reduce ------------------------------------


def fused_mttkrp_t_plain(layout, factors: Sequence[torch.Tensor], mode: int,
                         width: int, accumulate: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mttkrp_t`: the gather
    product, then ``index_add_`` at ``b·width + local`` (or at the global
    id with `accumulate`), with ids outside ``[0, width)`` sent to a
    dropped spill row.  It reads v1 and v2 layouts alike, through the
    layout's decode (``mode_ids``, ``blocked_locals``)."""
    from splatt_tpu_torch.ops.mttkrp import _gather_prod_layout

    nb, B = layout.nblocks, layout.block
    prod = _gather_prod_layout(layout, factors, mode).reshape(nb, B, -1)
    if accumulate:
        return onehot_reduce_full_plain(
            layout.mode_ids(mode).reshape(nb, B), prod, width)
    return onehot_reduce_sorted_plain(layout.blocked_locals(), prod, width)


#: fused_mttkrp_tg computes fused_mttkrp_t's function at any rank
fused_mttkrp_tg_plain = fused_mttkrp_t_plain


def fused_mttkrp_plain(layout, factors: Sequence[torch.Tensor], mode: int,
                       width: int, accumulate: bool,
                       chunk: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mttkrp`.  Its ids are the
    same as fused_mttkrp_t's (``blocked_locals()`` sorted, ``mode_ids``
    accumulate), its gathers clip into ``[0, d-1]`` as ``_gather_prod``
    clamps, and `chunk` changes only how the kernel walks the blocks."""
    return fused_mttkrp_t_plain(layout, factors, mode, width, accumulate)


def fused_mttkrp_v2_plain(layout, factors: Sequence[torch.Tensor],
                          mode: int, width: int,
                          accumulate: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mttkrp_v2`: each stream
    decoded through the stream vocabulary (``mode_ids``: global ids;
    ``blocked_locals``: the sorted mode's segment ids), the gather
    product, then :func:`onehot_reduce_sorted_plain` or
    :func:`onehot_reduce_full_plain`."""
    if layout.base is None:
        raise ValueError("fused_mttkrp_v2 reads a compact v2 layout's "
                         "encoded streams")
    if not accumulate and mode != layout.mode:
        raise ValueError("the sorted contract needs the layout's own mode")
    return fused_mttkrp_t_plain(layout, factors, mode, width, accumulate)


def gather_vec(R: int, cols: int, itemsize: int,
               addresses: Sequence[int]) -> tuple:
    """``(nv, vec)`` of ``csrc/gather_walk.cuh``'s walk over a rank tile
    of `cols` columns of ``(d, R)`` tables with `itemsize`-byte elements
    at the device `addresses`: each lane owns nv chunks of vec
    consecutive columns, each read by one load of ``vec * itemsize``
    bytes.  The columns per lane ``nv * vec`` are the least power of two
    (1 to 8) whose 32 lanes cover `cols`; vec is the widest power of two
    that divides them, loads at most :data:`GATHER_LOAD_BYTES`, divides R
    and keeps every table's address aligned to the load.  So R = 512 in
    f32 takes one 16-byte load per lane per 128-column tile, R = 50 (a
    200-byte pitch) 8-byte loads, and an odd R scalar loads."""
    if not 1 <= cols <= 256:
        raise ValueError(f"a rank tile of {cols} columns; 1 to 256 "
                         f"are walked")
    per_lane = 1
    while 32 * per_lane < cols:
        per_lane *= 2
    vec = min(per_lane, max(1, GATHER_LOAD_BYTES // itemsize))
    while vec > 1 and (R % vec or any(a % (vec * itemsize)
                                      for a in addresses)):
        vec //= 2
    return per_lane // vec, vec


def _walk_chunks(factors: Sequence[torch.Tensor], mode: int,
                 cols: int) -> tuple:
    """:func:`gather_vec`'s ``(nv, vec)`` for a launch over rank tiles of
    `cols` columns of the tables that `mode`'s MTTKRP gathers."""
    return gather_vec(int(factors[0].shape[1]), cols,
                      factors[0].element_size(),
                      [U.data_ptr() for k, U in enumerate(factors)
                       if k != mode])


def tg_rank_tile(R: int) -> int:
    """Columns of fused_mttkrp_tg's rank tile at rank R: the whole rank
    up to :data:`TG_RANK_TILE`, that tile above it."""
    return R if R <= TG_RANK_TILE else TG_RANK_TILE


def _fused_launch(name: str, layout, factors: List[torch.Tensor], mode: int,
                  width: int, accumulate: bool, rtile: int,
                  *extra) -> torch.Tensor:
    nb, R = layout.nblocks, int(factors[0].shape[1])
    shape = (width, R) if accumulate else (nb, width, R)
    use_smem = (not accumulate and FUSED_SCRATCH_BYTES
                + width * min(rtile, R) * 4 <= SMEM_TILE_BYTES)
    # every row the kernel does not write must read 0: zero the output
    # unless each CTA writes its whole tile from shared memory
    alloc = torch.empty if use_smem else torch.zeros
    out = alloc(shape, dtype=torch.float32, device=layout.vals.device)
    ptrs, _keep = _pointers(factors)
    dims, _keep2 = _ints([int(U.shape[0]) for U in factors])
    with torch.cuda.device(layout.vals.device):
        _launch(name, layout.inds.data_ptr(), layout.vals.data_ptr(),
                _is_bf16(layout.vals), layout.row_start.data_ptr(), ptrs,
                dims, _is_bf16(factors[0]), len(factors), mode,
                layout.nblocks * layout.block, nb, layout.block, R, width,
                int(accumulate), int(use_smem), *extra, out.data_ptr())
    return out


def fused_mttkrp_t(layout, factors: Sequence[torch.Tensor], mode: int,
                   width: int, accumulate: bool) -> torch.Tensor:
    """Fused MTTKRP over one blocked layout
    (≙ splatt_tpu.ops.pallas_kernels.fused_mttkrp_t), R ≤ :data:`MAX_RANK`.

    Output: ``(nb, width, R)`` block partials at within-block ids, or
    with `accumulate` the ``(width, R)`` totals at global ids, in the
    accumulator dtype.  One CTA per block walks the whole rank in one
    tile with several entries' rows in flight per warp
    (``csrc/gather_walk.cuh``, loads of :func:`gather_vec`).  CPU tensors
    take :func:`fused_mttkrp_t_plain`; CUDA tensors launch
    ``csrc/fused_mttkrp.cu`` (a v1 layout, int32 ids, f32 or bf16 values
    and factors, contiguous) or raise.
    """
    factors = list(factors)
    if layout.vals.device.type == "cpu":
        return fused_mttkrp_t_plain(layout, factors, mode, width, accumulate)
    _check_fused(layout, factors, mode, width, MAX_RANK)
    R = int(factors[0].shape[1])
    out = _fused_launch("splatt_fused_mttkrp_t", layout, factors, mode,
                        width, accumulate, R,
                        *_walk_chunks(factors, mode, R))
    count_launch(fused_mttkrp_t)
    return out


def fused_mttkrp_tg(layout, factors: Sequence[torch.Tensor], mode: int,
                    width: int, accumulate: bool) -> torch.Tensor:
    """Rank-tiled fused MTTKRP
    (≙ splatt_tpu.ops.pallas_kernels.fused_mttkrp_tg): the contract of
    :func:`fused_mttkrp_t` at any rank, a grid over (block, rank tile of
    :func:`tg_rank_tile` columns), each block walked with several
    entries' rows in flight per warp (``csrc/gather_walk.cuh``, loads of
    :func:`gather_vec`).  CPU tensors take
    :func:`fused_mttkrp_tg_plain`; CUDA tensors launch the kernel or
    raise."""
    factors = list(factors)
    if layout.vals.device.type == "cpu":
        return fused_mttkrp_tg_plain(layout, factors, mode, width,
                                     accumulate)
    _check_fused(layout, factors, mode, width, None)
    out = fused_tg_launch(layout, factors, mode, width, accumulate,
                          tg_rank_tile(int(factors[0].shape[1])))
    count_launch(fused_mttkrp_tg)
    return out


def fused_tg_launch(layout, factors: List[torch.Tensor], mode: int,
                    width: int, accumulate: bool,
                    rtile: int) -> torch.Tensor:
    """One launch of ``splatt_fused_mttkrp_tg`` on operands that
    :func:`fused_mttkrp_tg` has checked, at rank tile `rtile` (the whole
    rank, or a multiple of 32 columns per lane).  It counts no launch:
    ``chip_smoke.py`` times rank tiles and diagnostic layouts with it."""
    cols = min(rtile, int(factors[0].shape[1]))
    return _fused_launch("splatt_fused_mttkrp_tg", layout, factors, mode,
                         width, accumulate, rtile, rtile,
                         *_walk_chunks(factors, mode, cols))


def fused_mttkrp(layout, factors: Sequence[torch.Tensor], mode: int,
                 width: int, accumulate: bool,
                 chunk: int = 1) -> torch.Tensor:
    """Row-major fused MTTKRP (≙ splatt_tpu.ops.pallas_kernels.
    fused_mttkrp), R ≤ :data:`MAX_RANK`: a CTA walks `chunk` consecutive
    blocks in turn, each as :func:`fused_mttkrp_t` walks one.  Output
    ``(nb, width, R)`` (sorted) or ``(width, R)`` (accumulate).  CPU
    tensors take :func:`fused_mttkrp_plain`; CUDA tensors launch the
    kernel or raise."""
    factors = list(factors)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if layout.vals.device.type == "cpu":
        return fused_mttkrp_plain(layout, factors, mode, width, accumulate,
                                  chunk)
    _check_fused(layout, factors, mode, width, MAX_RANK)
    R = int(factors[0].shape[1])
    out = _fused_launch("splatt_fused_mttkrp", layout, factors, mode,
                        width, accumulate, R, int(chunk),
                        *_walk_chunks(factors, mode, R))
    count_launch(fused_mttkrp)
    return out


def _v2_prologue_bytes(layout) -> int:
    """Shared bytes fused_mttkrp_v2 takes before its tile: the delta
    carries and, for an RLE stream, its S run ends, rounded to 16."""
    rle = "rle" in layout.stream_encs()
    ints = V2_PROLOGUE_INTS + (layout.seg_width if rle else 0)
    return -(-ints * 4 // 16) * 16


def fused_mttkrp_v2(layout, factors: Sequence[torch.Tensor], mode: int,
                    width: int, accumulate: bool) -> torch.Tensor:
    """Fused MTTKRP over a compact v2 layout, decoding its encoded
    streams in registers (≙ splatt_tpu.ops.pallas_kernels.
    fused_mttkrp_v2), R ≤ :data:`MAX_RANK`.  The contract of
    :func:`fused_mttkrp_t`: ``(nb, width, R)`` block partials at the
    sorted mode's segment ids (`mode` must be the layout's own), or with
    `accumulate` the ``(width, R)`` totals at the global ids of `mode`.
    CPU tensors take :func:`fused_mttkrp_v2_plain`; CUDA tensors launch
    ``csrc/fused_mttkrp_v2.cu`` or raise."""
    factors = list(factors)
    if layout.vals.device.type == "cpu":
        return fused_mttkrp_v2_plain(layout, factors, mode, width,
                                     accumulate)
    _check_fused(layout, factors, mode, width, MAX_RANK, v2=True)
    if not accumulate and mode != layout.mode:
        raise ValueError("the sorted contract needs the layout's own mode")
    nb, R = layout.nblocks, int(factors[0].shape[1])
    nv, vec = _walk_chunks(factors, mode, R)
    encs = layout.stream_encs()
    shape = (width, R) if accumulate else (nb, width, R)
    use_smem = (not accumulate and _v2_prologue_bytes(layout) + width * R * 4
                <= SMEM_TILE_BYTES)
    alloc = torch.empty if use_smem else torch.zeros
    out = alloc(shape, dtype=torch.float32, device=layout.vals.device)
    streams, _k1 = _pointers(layout.inds)
    bases, _k2 = _pointers(layout.base)
    ptrs, _k3 = _pointers(factors)
    codes, _k4 = _ints([c for k in range(layout.nmodes)
                        for c in (V2_ID_TYPES[layout.inds[k].dtype],
                                  V2_ENCODINGS[encs[k]])])
    dims, _k5 = _ints([int(U.shape[0]) for U in factors])
    scols = layout.seg_width if "rle" in encs else 0
    with torch.cuda.device(layout.vals.device):
        _launch("splatt_fused_mttkrp_v2", streams, codes, bases,
                layout.vals.data_ptr(), _is_bf16(layout.vals), ptrs, dims,
                _is_bf16(factors[0]), layout.nmodes, mode, nb, layout.block,
                scols, R, width, int(accumulate), int(use_smem), nv, vec,
                out.data_ptr())
    count_launch(fused_mttkrp_v2)
    return out


# -- reductions of precomputed products --------------------------------------


def _segment_sum(ids: torch.Tensor, prod: torch.Tensor,
                 nrows: int) -> torch.Tensor:
    """(nrows, R) sums of `prod` rows at `ids` in the accumulator dtype;
    ids outside ``[0, nrows)`` go to a dropped spill row."""
    acc = acc_dtype(prod.dtype)
    R = prod.shape[-1]
    ids = ids.reshape(-1).long()
    ok = (ids >= 0) & (ids < nrows)
    ids = torch.where(ok, ids, torch.full_like(ids, nrows))
    out = torch.zeros((nrows + 1, R), dtype=acc, device=prod.device)
    out.index_add_(0, ids, prod.reshape(-1, R).to(acc))
    return out[:nrows]


def onehot_reduce_sorted_plain(local: torch.Tensor, prod: torch.Tensor,
                               seg_width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`onehot_reduce_sorted`."""
    nb = local.shape[0]
    base = torch.arange(nb, device=local.device)[:, None] * seg_width
    ids = torch.where((local >= 0) & (local < seg_width),
                      local.long() + base, torch.full_like(base, -1))
    return _segment_sum(ids, prod, nb * seg_width).reshape(
        nb, seg_width, prod.shape[-1])


def onehot_reduce_full_plain(local: torch.Tensor, prod: torch.Tensor,
                             width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`onehot_reduce_full`."""
    return _segment_sum(local, prod, width)


def reduce_rank_tile(R: int) -> int:
    """Columns of the reductions' rank tile at rank R: the whole rank up
    to :data:`RANK_TILE`, that tile above it."""
    return R if R <= RANK_TILE else RANK_TILE


def reduce_uses_smem(width: int, cols: int) -> bool:
    """Whether the sorted reduction's ``(width, cols)`` f32 tile fits a
    CTA's shared memory after its scratch (else it adds into a zeroed
    output in device memory)."""
    return REDUCE_SCRATCH_BYTES + width * cols * 4 <= SMEM_TILE_BYTES


def onehot_reduce_launch(local: torch.Tensor, prod: torch.Tensor,
                         width: int, full: bool,
                         rtile: int) -> torch.Tensor:
    """One launch of ``splatt_onehot_reduce_full`` (`full`) or
    ``_sorted`` on operands that :func:`_check_reduce` has passed, at
    rank tile `rtile` (the whole rank, or a multiple of 32 columns per
    lane), each lane's chunks from :func:`gather_vec` over the products'
    address.  It counts no launch: ``chip_smoke.py`` times rank tiles
    with it."""
    nb, B, R = prod.shape
    cols = min(rtile, R)
    nv, vec = gather_vec(R, cols, prod.element_size(), [prod.data_ptr()])
    operands = (local.data_ptr(), prod.data_ptr(), _is_bf16(prod), nb, B, R,
                width)
    if full:
        out = torch.zeros((width, R), dtype=torch.float32,
                          device=prod.device)
        name = "splatt_onehot_reduce_full"
    else:
        use_smem = reduce_uses_smem(width, cols)
        # every CTA writes its whole tile from shared memory; otherwise
        # the rows it does not write must read 0
        alloc = torch.empty if use_smem else torch.zeros
        out = alloc((nb, width, R), dtype=torch.float32, device=prod.device)
        name = "splatt_onehot_reduce_sorted"
        operands += (int(use_smem),)
    with torch.cuda.device(prod.device):
        _launch(name, *operands, rtile, nv, vec, out.data_ptr())
    return out


def onehot_reduce_sorted(local: torch.Tensor, prod: torch.Tensor,
                         seg_width: int) -> torch.Tensor:
    """(nb, B) in-block ids + (nb, B, R) products → (nb, S, R) block
    partials (≙ splatt_tpu.ops.pallas_kernels.onehot_reduce_sorted); ids
    outside ``[0, S)`` add nothing.  CPU tensors take the plain version;
    CUDA tensors (int32 ids, f32 or bf16 products) launch
    ``csrc/onehot_reduce.cu`` (the walk of ``csrc/gather_walk.cuh``,
    rank tiles of :func:`reduce_rank_tile`) or raise."""
    if local.device.type == "cpu":
        return onehot_reduce_sorted_plain(local, prod, seg_width)
    _check_reduce(local, prod, seg_width)
    out = onehot_reduce_launch(local, prod, seg_width, False,
                               reduce_rank_tile(int(prod.shape[2])))
    count_launch(onehot_reduce_sorted)
    return out


def onehot_reduce_full(local: torch.Tensor, prod: torch.Tensor,
                       width: int) -> torch.Tensor:
    """(nb, B) global ids + (nb, B, R) products → (width, R) totals over
    all blocks (≙ splatt_tpu.ops.pallas_kernels.onehot_reduce_full); ids
    outside ``[0, width)`` add nothing.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/onehot_reduce.cu`` (as
    :func:`onehot_reduce_sorted`) or raise."""
    if local.device.type == "cpu":
        return onehot_reduce_full_plain(local, prod, width)
    _check_reduce(local, prod, width)
    out = onehot_reduce_launch(local, prod, width, True,
                               reduce_rank_tile(int(prod.shape[2])))
    count_launch(onehot_reduce_full)
    return out


# -- the dense-mode matmul ---------------------------------------------------


@contextlib.contextmanager
def ieee_matmul():
    """f32 matrix products in full f32 on the card while the block runs:
    cuBLAS may not fall to TF32 (the CPU ignores the flag)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def fused_dense_plain(layout, factors: Sequence[torch.Tensor],
                      mode: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_dense`: the ``(span, R)``
    Khatri-Rao operand ``w ⊙ u`` formed in the factor dtype, then each
    ``(tile, span)`` value tile (cast to the factor dtype) times it in
    the accumulator dtype, IEEE f32 on the card, trimmed to ``dim``
    rows."""
    from splatt_tpu_torch.ops.mttkrp import dense_operands

    if mode != layout.mode:
        raise ValueError("fused_dense requires the layout's own mode")
    factors = list(factors)
    dtype = factors[0].dtype
    acc = acc_dtype(dtype)
    R = int(factors[0].shape[1])
    w, u = dense_operands(layout, factors, mode)
    kr = (w[:, None, :] * u[None, :, :]).reshape(-1, R).to(acc)
    with ieee_matmul():
        out = torch.matmul(layout.tiles.to(dtype).to(acc), kr)
    return out.reshape(-1, R)[:layout.dim]


def tf32_split(x: torch.Tensor) -> tuple:
    """The 3xTF32 split of csrc/fused_dense.cu in torch: ``(big,
    small)`` with ``big = tf32(x)`` and ``small = tf32(x - big)``, each
    rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero (``cvt.rna.tf32.f32``), as f32.  For the tests and
    ``chip_smoke.py``; no engine calls it."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    big = rna(x)
    return big, rna(x - big)


def fused_dense_tf32x3(layout, factors: Sequence[torch.Tensor],
                       mode: int) -> torch.Tensor:
    """What :func:`fused_dense` computes with f32 factors, emulated in
    f64: the values and the f32 Khatri-Rao operand each split by
    :func:`tf32_split`, then ``a_big b_big + a_big b_small + a_small
    b_big`` (bf16 values have no small part), trimmed to ``dim`` rows.
    It keeps about 2^-21 of each product; for the tests and
    ``chip_smoke.py``."""
    from splatt_tpu_torch.ops.mttkrp import dense_operands

    R = int(factors[0].shape[1])
    w, u = dense_operands(layout, list(factors), mode)
    kr = (w[:, None, :] * u[None, :, :]).reshape(-1, R)
    a_big, a_small = (t.double() for t in tf32_split(layout.tiles.view(
        -1, layout.span)))
    b_big, b_small = (t.double() for t in tf32_split(kr))
    out = a_big @ b_big + a_big @ b_small + a_small @ b_big
    return out[:layout.dim]


class DenseTiling(NamedTuple):
    """The launch shape of csrc/fused_dense.cu for one mode."""

    n_tile: int        # rank columns per CTA (wgmma N)
    rank_tiles: int    # CTAs on grid.y
    chunk: int         # span columns per pipeline stage
    row_blocks: int    # ceil(rows / DENSE_ROWS)
    splits: int        # span splits per row block (split-K)


def dense_tiling(rows: int, span: int, inner_pad: int, R: int, sms: int,
                 tiles_bf16: bool = False,
                 fac_bf16: bool = False) -> DenseTiling:
    """The tiling of csrc/fused_dense.cu: N the first of
    :data:`DENSE_N_TILES` that holds R (or the last, with the rest of the
    rank on grid.y); a chunk is one 128-byte row of the narrower of the
    value and factor types (32 columns in f32, 64 when either is bf16);
    the span is split so the grid is about one wave of one CTA per SM (a
    mode with one row block still fills the card), as its u-stationary
    schedule allows (:func:`dense_split_chunks`): at most ``nib =
    inner_pad / chunk`` splits, or a whole multiple of nib."""
    n_tile = next((n for n in DENSE_N_TILES if n >= R), DENSE_N_TILES[-1])
    rank_tiles = -(-R // n_tile)
    chunk = 64 if (tiles_bf16 or fac_bf16) else 32
    row_blocks = -(-rows // DENSE_ROWS)
    nib, n_outer = inner_pad // chunk, span // inner_pad
    want = max(1, sms // (row_blocks * rank_tiles))
    splits = want if want <= nib else nib * min(n_outer, want // nib)
    return DenseTiling(n_tile, rank_tiles, chunk, row_blocks, splits)


def dense_split_chunks(t: DenseTiling, span: int, inner_pad: int,
                       split: int) -> List[int]:
    """The chunks split `split` of a row block takes, in order (the
    kernel's Schedule): chunk ``o * nib + ib`` is outer index o and inner
    rows ``ib * chunk ..``; a split takes whole u blocks ib (with splits
    <= nib: ib = split, split + splits, ..., every o) or, with splits a
    multiple of nib, block ``split % nib`` for part ``split // nib`` of
    the o range, so consecutive chunks share their u rows."""
    nib, n_outer = inner_pad // t.chunk, span // inner_pad
    if t.splits <= nib:
        return [o * nib + ib for ib in range(split, nib, t.splits)
                for o in range(n_outer)]
    parts = t.splits // nib
    part = split // nib
    return [o * nib + split % nib
            for o in range(n_outer * part // parts,
                           n_outer * (part + 1) // parts)]


def fused_dense(layout, factors: Sequence[torch.Tensor],
                mode: int) -> torch.Tensor:
    """Dense-mode MTTKRP over a :class:`blocked.DenseModeLayout`
    (≙ splatt_tpu.ops.pallas_kernels.fused_dense): the mode's value tiles
    times the Khatri-Rao operand of the other factors, ``(dim, R)`` in
    the accumulator dtype.  ``w`` and ``u`` come from
    ``ops.mttkrp.dense_operands``, built outside the kernel as the JAX
    entry builds them outside its pallas_call.  CPU tensors take
    :func:`fused_dense_plain`; CUDA tensors (f32 or bf16 tiles and
    factors, R ≤ :data:`DENSE_MAX_RANK`) launch ``csrc/fused_dense.cu``
    (the tensor cores: bf16 products, or 3xTF32 for f32 factors) or
    raise."""
    from splatt_tpu_torch.ops.mttkrp import dense_operands

    factors = list(factors)
    if layout.device.type == "cpu":
        return fused_dense_plain(layout, factors, mode)
    if layout.encoding != "dense":
        raise ValueError("fused_dense reads a dense layout's value tiles")
    check_operands(layout, factors, mode)
    R = int(factors[0].shape[1])
    if R > DENSE_MAX_RANK:
        raise ValueError(f"rank {R} above fused_dense's {DENSE_MAX_RANK}")
    if layout.tiles.data_ptr() % 16:
        raise ValueError("the value tiles must be 16-byte aligned")
    dev = layout.device
    rows, span = layout.dim, layout.span
    tiles_bf16, fac_bf16 = _is_bf16(layout.tiles), _is_bf16(factors[0])
    inner_pad = layout.geometry.inner_pad
    t = dense_tiling(
        rows, span, inner_pad, R,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        tiles_bf16, fac_bf16)
    # w and u in fresh buffers whose rows are rank_tiles * n_tile columns,
    # zero past R: the kernel copies a tile's columns in 16-byte pieces
    w, u = dense_operands(layout, factors, mode)
    w, u = (x.new_zeros((int(x.shape[0]), t.rank_tiles * t.n_tile))
            .index_copy_(1, torch.arange(R, device=dev), x) for x in (w, u))
    out = torch.zeros((rows, R), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("splatt_fused_dense", layout.tiles.data_ptr(), tiles_bf16,
                w.data_ptr(), u.data_ptr(), fac_bf16, rows, span,
                inner_pad, R, t.n_tile, t.rank_tiles, t.row_blocks,
                t.splits, out.data_ptr())
    count_launch(fused_dense)
    return out


KERNELS = (fused_mttkrp_t, fused_mttkrp_tg, fused_mttkrp, fused_mttkrp_v2,
           onehot_reduce_sorted, onehot_reduce_full, fused_dense)
reset_launches()
