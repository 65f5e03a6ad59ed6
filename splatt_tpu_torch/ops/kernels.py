"""Hand-written CUDA kernels, their plain PyTorch versions and their loader.

Counterpart of ``splatt_tpu/ops/pallas_kernels.py``.  The CUDA sources live
in ``splatt_tpu_torch/csrc/``.  At first use, :func:`load_library` compiles
each source with ``nvcc`` for ``sm_90a`` into its own shared library with a
plain C interface under ``splatt_tpu_torch/_build/`` (one ``nvcc`` per
source, started together) and loads them with ``ctypes``.

Five wrappers, one per TPU kernel:

- :func:`fused_mttkrp_t`, :func:`fused_mttkrp_tg`, :func:`fused_mttkrp`
  (``csrc/fused_mttkrp.cu``): gather + Hadamard + row reduce over a
  blocked layout, in the sorted (block partials) or accumulate (totals)
  contract;
- :func:`onehot_reduce_sorted`, :func:`onehot_reduce_full`
  (``csrc/onehot_reduce.cu``): the same reduction of precomputed products.

A wrapper runs its plain version for tensors that lie on the CPU.  For CUDA
tensors it launches the kernel on the current stream or raises: a launch
the card refuses (:class:`KernelLaunchError`, which the engine chain may
demote), any other CUDA error, a failed build or load, or an operand the
kernel does not take.  Each wrapper's ``.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from splatt_tpu_torch.config import MAX_NMODES, acc_dtype

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_mttkrp.cu", "onehot_reduce.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: largest rank fused_mttkrp_t and fused_mttkrp hold in registers
#: (32 lanes x 8 sums); fused_mttkrp_tg and the reductions tile any rank
MAX_RANK = 256
#: largest (width, cols) f32 tile a CTA keeps in shared memory (227 KB)
SMEM_TILE_BYTES = 232448
#: columns of the rank tile of fused_mttkrp_tg and the reductions
#: (csrc/*.cu: 32 * min(4, ceil(R / 32)))
RANK_TILE = 128

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
_FUSED_ARGS = [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _I, _I]
_ENTRIES = {
    "splatt_fused_mttkrp_t_f32": ("fused_mttkrp.cu",
                                  _FUSED_ARGS + [_P, _P]),
    "splatt_fused_mttkrp_tg_f32": ("fused_mttkrp.cu",
                                   _FUSED_ARGS + [_P, _P]),
    "splatt_fused_mttkrp_f32": ("fused_mttkrp.cu",
                                _FUSED_ARGS + [_I, _P, _P]),
    "splatt_onehot_reduce_sorted_f32": ("onehot_reduce.cu",
                                        [_P, _P, _I, _I, _I, _I, _I, _P,
                                         _P]),
    "splatt_onehot_reduce_full_f32": ("onehot_reduce.cu",
                                      [_P, _P, _I, _I, _I, _I, _P, _P]),
}


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


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


# -- operand contracts -------------------------------------------------------


def check_operands(layout, factors: Sequence[torch.Tensor], mode: int,
                   kernels: bool = True) -> None:
    """The caller's contract of a blocked MTTKRP: every operand on the
    layout's device, int32 ids and factor shapes ``(d_k, R)`` that match
    the layout, floating values and one floating dtype for the factors;
    on a card, when a kernel may run (`kernels`), what the kernels take:
    f32 and contiguous.  Raises ValueError or TypeError."""
    dev = layout.vals.device
    strict = dev.type == "cuda" and kernels
    if layout.nmodes != len(factors) or not 2 <= len(factors) <= MAX_NMODES:
        raise ValueError(f"{len(factors)} factors for a {layout.nmodes}-mode "
                         f"layout (2..{MAX_NMODES} modes supported)")
    if not 0 <= mode < layout.nmodes:
        raise ValueError(f"mode {mode} out of range")
    R = int(factors[0].shape[1]) if factors[0].dim() == 2 else -1
    if R < 1:
        raise ValueError("factors must be (rows, R) with R >= 1")
    dtype = torch.float32 if strict else factors[0].dtype
    if not dtype.is_floating_point:
        raise TypeError(f"factors are {dtype}; a floating dtype is needed")
    named = [("inds", layout.inds, torch.int32,
              (layout.nmodes, layout.nblocks * layout.block)),
             ("vals", layout.vals,
              torch.float32 if strict else layout.vals.dtype,
              (layout.nblocks * layout.block,)),
             ("row_start", layout.row_start, torch.int32, (layout.nblocks,))]
    named += [(f"factors[{k}]", U, dtype, (int(U.shape[0]), R))
              for k, U in enumerate(factors)]
    for name, t, want, shape in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the layout on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; expected {want}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if strict and not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if not layout.vals.dtype.is_floating_point:
        raise TypeError(f"vals are {layout.vals.dtype}; a floating dtype "
                        f"is needed")
    if any(int(U.shape[0]) < 1 for U in factors):
        raise ValueError("every factor needs at least one row")


def _check_fused(layout, factors, mode: int, width: int,
                 max_rank: Optional[int]) -> None:
    check_operands(layout, factors, mode)
    R = int(factors[0].shape[1])
    if max_rank is not None and R > max_rank:
        raise ValueError(f"rank {R} above the kernel's {max_rank}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")


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
    if local.dtype != torch.int32 or prod.dtype != torch.float32:
        raise TypeError(f"ids {local.dtype}, products {prod.dtype}; the "
                        f"CUDA kernel takes int32 and float32")
    if not (local.is_contiguous() and prod.is_contiguous()):
        raise ValueError("ids and products must be contiguous")


# -- fused gather + Hadamard + row reduce ------------------------------------


def fused_mttkrp_t_plain(layout, factors: Sequence[torch.Tensor], mode: int,
                         width: int, accumulate: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mttkrp_t`: the gather
    product, then ``index_add_`` at ``b·width + local`` (or at the global
    id with `accumulate`), with ids outside ``[0, width)`` sent to a
    dropped spill row."""
    from splatt_tpu_torch.ops.mttkrp import _gather_prod

    nb, B = layout.nblocks, layout.block
    prod = _gather_prod(layout.inds, layout.vals, factors, mode)
    ids = (layout.mode_ids(mode).reshape(nb, B) if accumulate
           else layout.blocked_locals())
    if accumulate:
        return onehot_reduce_full_plain(ids, prod.reshape(nb, B, -1), width)
    return onehot_reduce_sorted_plain(ids, prod.reshape(nb, B, -1), width)


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


def _fused_launch(name: str, layout, factors: List[torch.Tensor], mode: int,
                  width: int, accumulate: bool, rtile: int,
                  *extra) -> torch.Tensor:
    nb, R = layout.nblocks, int(factors[0].shape[1])
    shape = (width, R) if accumulate else (nb, width, R)
    use_smem = not accumulate and width * min(rtile, R) * 4 <= SMEM_TILE_BYTES
    # every row the kernel does not write must read 0: zero the output
    # unless each CTA writes its whole tile from shared memory
    alloc = torch.empty if use_smem else torch.zeros
    out = alloc(shape, dtype=torch.float32, device=layout.vals.device)
    ptrs = (ctypes.c_void_p * len(factors))(*(U.data_ptr() for U in factors))
    dims = (ctypes.c_int * len(factors))(*(int(U.shape[0]) for U in factors))
    with torch.cuda.device(layout.vals.device):
        _launch(name, layout.inds.data_ptr(), layout.vals.data_ptr(),
                layout.row_start.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p),
                ctypes.cast(dims, ctypes.c_void_p), len(factors), mode,
                layout.nblocks * layout.block, nb, layout.block, R, width,
                int(accumulate), int(use_smem), *extra, out.data_ptr())
    return out


def fused_mttkrp_t(layout, factors: Sequence[torch.Tensor], mode: int,
                   width: int, accumulate: bool) -> torch.Tensor:
    """Fused MTTKRP over one blocked layout
    (≙ splatt_tpu.ops.pallas_kernels.fused_mttkrp_t), R ≤ :data:`MAX_RANK`.

    Output: ``(nb, width, R)`` block partials at within-block ids, or
    with `accumulate` the ``(width, R)`` totals at global ids, in the
    accumulator dtype.  CPU tensors take :func:`fused_mttkrp_t_plain`;
    CUDA tensors launch ``csrc/fused_mttkrp.cu`` (f32 values and
    factors, int32 ids, contiguous) or raise.
    """
    factors = list(factors)
    if layout.vals.device.type == "cpu":
        return fused_mttkrp_t_plain(layout, factors, mode, width, accumulate)
    _check_fused(layout, factors, mode, width, MAX_RANK)
    out = _fused_launch("splatt_fused_mttkrp_t_f32", layout, factors, mode,
                        width, accumulate, MAX_RANK)
    fused_mttkrp_t.launches += 1
    return out


def fused_mttkrp_tg(layout, factors: Sequence[torch.Tensor], mode: int,
                    width: int, accumulate: bool) -> torch.Tensor:
    """Rank-tiled fused MTTKRP
    (≙ splatt_tpu.ops.pallas_kernels.fused_mttkrp_tg): the contract of
    :func:`fused_mttkrp_t` at any rank, a grid over (block, rank tile of
    :data:`RANK_TILE` columns).  CPU tensors take
    :func:`fused_mttkrp_tg_plain`; CUDA tensors launch the kernel or
    raise."""
    factors = list(factors)
    if layout.vals.device.type == "cpu":
        return fused_mttkrp_tg_plain(layout, factors, mode, width,
                                     accumulate)
    _check_fused(layout, factors, mode, width, None)
    out = _fused_launch("splatt_fused_mttkrp_tg_f32", layout, factors, mode,
                        width, accumulate, RANK_TILE)
    fused_mttkrp_tg.launches += 1
    return out


def fused_mttkrp(layout, factors: Sequence[torch.Tensor], mode: int,
                 width: int, accumulate: bool,
                 chunk: int = 1) -> torch.Tensor:
    """Row-major fused MTTKRP (≙ splatt_tpu.ops.pallas_kernels.
    fused_mttkrp), R ≤ :data:`MAX_RANK`: a CTA walks `chunk` consecutive
    blocks.  Output ``(nb, width, R)`` (sorted) or ``(width, R)``
    (accumulate).  CPU tensors take :func:`fused_mttkrp_plain`; CUDA
    tensors launch the kernel or raise."""
    factors = list(factors)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if layout.vals.device.type == "cpu":
        return fused_mttkrp_plain(layout, factors, mode, width, accumulate,
                                  chunk)
    _check_fused(layout, factors, mode, width, MAX_RANK)
    out = _fused_launch("splatt_fused_mttkrp_f32", layout, factors, mode,
                        width, accumulate, MAX_RANK, int(chunk))
    fused_mttkrp.launches += 1
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


def onehot_reduce_sorted(local: torch.Tensor, prod: torch.Tensor,
                         seg_width: int) -> torch.Tensor:
    """(nb, B) in-block ids + (nb, B, R) products → (nb, S, R) block
    partials (≙ splatt_tpu.ops.pallas_kernels.onehot_reduce_sorted); ids
    outside ``[0, S)`` add nothing.  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/onehot_reduce.cu`` or raise."""
    if local.device.type == "cpu":
        return onehot_reduce_sorted_plain(local, prod, seg_width)
    _check_reduce(local, prod, seg_width)
    nb, B, R = prod.shape
    use_smem = seg_width * min(RANK_TILE, R) * 4 <= SMEM_TILE_BYTES
    alloc = torch.empty if use_smem else torch.zeros
    out = alloc((nb, seg_width, R), dtype=torch.float32, device=prod.device)
    with torch.cuda.device(prod.device):
        _launch("splatt_onehot_reduce_sorted_f32", local.data_ptr(),
                prod.data_ptr(), nb, B, R, seg_width, int(use_smem),
                out.data_ptr())
    onehot_reduce_sorted.launches += 1
    return out


def onehot_reduce_full(local: torch.Tensor, prod: torch.Tensor,
                       width: int) -> torch.Tensor:
    """(nb, B) global ids + (nb, B, R) products → (width, R) totals over
    all blocks (≙ splatt_tpu.ops.pallas_kernels.onehot_reduce_full); ids
    outside ``[0, width)`` add nothing.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/onehot_reduce.cu`` or raise."""
    if local.device.type == "cpu":
        return onehot_reduce_full_plain(local, prod, width)
    _check_reduce(local, prod, width)
    nb, B, R = prod.shape
    out = torch.zeros((width, R), dtype=torch.float32, device=prod.device)
    with torch.cuda.device(prod.device):
        _launch("splatt_onehot_reduce_full_f32", local.data_ptr(),
                prod.data_ptr(), nb, B, R, width, out.data_ptr())
    onehot_reduce_full.launches += 1
    return out


KERNELS = (fused_mttkrp_t, fused_mttkrp_tg, fused_mttkrp,
           onehot_reduce_sorted, onehot_reduce_full)
reset_launches()
