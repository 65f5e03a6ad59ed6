"""Shared machinery of the distributed CPD (≙ splatt_tpu/parallel/common.py).

- :func:`bucket_scatter`: place nonzero n in bucket owner[n], pad the
  buckets to the largest (≙ the rearrange-to-owners steps of
  src/mpi/mpi_io.c).
- The out-of-core builds (≙ the reference streaming equal-nnz chunks
  from the root rank, src/mpi/mpi_io.c:587-648):
  :func:`streamed_bucket_scatter` is :func:`bucket_scatter` in chunked
  passes over a (memmapped) tensor, :func:`streamed_blocked_buckets` is
  :func:`blocked_buckets` as a chunked counting sort, both with their
  outputs memmapped under an ``out_dir``; :func:`upload` copies a
  memmapped array to a device in chunks.  Host memory stays bounded by
  the chunk, not the tensor.
- The blocked per-rank engine's host half: :func:`blocked_buckets` sorts
  and blocks each bucket for one mode, :func:`build_bucket_layout` is its
  one dispatch point, :class:`RankLayouts` holds one layout per rank on
  the rank's device, and :func:`blocked_local_mttkrp` runs the
  single-card engine chain (``ops/mttkrp.py``'s ``mttkrp_blocked``, with
  ``fused_mttkrp_t`` on a sorted mode) over one rank's layout
  (≙ every MPI rank calling mttkrp_csf, src/mpi/mpi_cpd.c:714);
  :func:`bucket_engine`, :func:`alloc_build_modes` and
  :func:`auto_local_engine` are its policies; each driver records the
  engine it runs with :func:`record_local_engine`.
- :func:`balanced_relabel`, :func:`relabel_tensor`: row relabelings of
  ``--rowdist balanced``; :func:`record_shard_imbalance` and
  :func:`imbalance_report`: the ``layout_imbalance`` event.
- :func:`comm_volume_model` / :func:`comm_volume_report`: the per-device
  wire model of each comm strategy.
- :func:`mode_update_tail`, :func:`fit_tail`: the per-mode ALS tail and
  the fit pieces.  The JAX package's ``psum``/``pmax`` over mesh axes
  become :func:`allreduce`: each group of ranks' tensors moved to its
  first rank's device, combined in rank order, and copied back to each
  rank's device (one group of every rank on a 1-D mesh; the ranks of a
  :meth:`GridMesh.group` on the MEDIUM grid).
- :func:`run_distributed_als`: the iterate/converge/post-process loop
  (≙ the outer loop of mpi_cpd_als_iterate + cpd_post_process) with the
  JAX package's checkpoints in the original row space, resume, deferred
  fit checks, the guarded rollback and the ``dist.*`` trace spans.
- :data:`DIST_TIMER_NAMES`, :func:`wrap_profiled_step`,
  :func:`dist_phase_report`: the phase timers of the profiled sweeps.

Sharded state is a list with one tensor per rank, each on its rank's
device; a "replicated" value (a Gram, λ) is such a list of equal copies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import mmap
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatt_tpu_torch.blocked import alloc_build_modes
from splatt_tpu_torch.config import Options, Verbosity, acc_dtype
from splatt_tpu_torch.kruskal import KruskalTensor, post_process
from splatt_tpu_torch.utils.env import max_mean_ratio


#: nonzeros per chunk of the streamed builds and of a memmapped upload
STREAM_CHUNK = 1 << 22


def ceil_to(x: int, mult: int) -> int:
    """Round x up to a multiple of mult."""
    return ((x + mult - 1) // mult) * mult


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")``; nonnegative keys below 2^16
    are sorted as uint16, which numpy's stable sort takes by radix sort:
    the same permutation, several times faster on millions of keys."""
    if keys.size and 0 <= int(keys.min()) and int(keys.max()) < 1 << 16:
        keys = keys.astype(np.uint16)
    return np.argsort(keys, kind="stable")


def bucket_scatter(inds: np.ndarray, vals: np.ndarray, owner: np.ndarray,
                   nbuckets: int, val_dtype
                   ) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Scatter nonzeros into equally padded buckets by owner id.

    Returns (binds (nmodes, nbuckets, C) int32, bvals (nbuckets, C), C,
    counts (nbuckets,), the true occupancy of each bucket).  Pad slots
    hold index 0 and value 0 (harmless to every kernel).
    """
    from splatt_tpu_torch.blocked import check_int32_dims

    nmodes, nnz = inds.shape
    owner = np.asarray(owner, dtype=np.int64)
    if owner.shape[0] != nnz:
        raise ValueError(
            f"partition/owner length {owner.shape[0]} != nnz {nnz}")
    if nnz == 0:
        return (np.zeros((nmodes, nbuckets, 1), dtype=np.int32),
                np.zeros((nbuckets, 1), dtype=val_dtype), 1,
                np.zeros(nbuckets, dtype=np.int64))
    if owner.min() < 0 or owner.max() >= nbuckets:
        raise ValueError(f"owner ids must lie in [0, {nbuckets})")
    if int(inds.max()) >= 2**31 - 1:
        check_int32_dims([int(inds.max()) + 1])
    counts = np.bincount(owner, minlength=nbuckets)
    C = max(int(counts.max()), 1)
    order = stable_argsort(owner)
    offsets = np.zeros(nbuckets + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(nnz) - offsets[owner[order]]
    flat = owner[order] * C + slot
    binds = np.zeros((nmodes, nbuckets * C), dtype=np.int32)
    for m in range(nmodes):
        binds[m, flat] = inds[m][order]
    bvals = np.zeros(nbuckets * C, dtype=val_dtype)
    bvals[flat] = vals[order]
    return (binds.reshape(nmodes, nbuckets, C), bvals.reshape(nbuckets, C),
            C, counts)


def blocked_buckets(binds: np.ndarray, bvals: np.ndarray,
                    counts: np.ndarray, mode: int, local_dim: int,
                    block: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Per-bucket sorted and blocked layout arrays for output `mode`, the
    distributed analog of ``blocked.build_layout`` with one shape for
    every bucket (≙ each MPI rank building its own CSF over its local
    nonzeros).  The same arrays as the JAX package's.

    binds: (nmodes, nbuckets, C) int32 with the mode-`mode` row in
    [0, local_dim); bvals: (nbuckets, C); counts: each bucket's true
    occupancy.  Each bucket's first ``counts[b]`` entries are stably
    sorted by the mode's row; its tail is re-marked with the sentinel
    `local_dim`, so it trails the sort (the single-card padding
    contract).  The block is ``max(128, min(block, ceil_to(C, 128)))``;
    ``row_start`` is each block's first row (the sentinel for an
    all-padding block), and ``seg_width`` the widest block span, clamped
    to `local_dim`, rounded up to 8.

    Returns (inds (nmodes, nbuckets, nnz_pad), vals (nbuckets, nnz_pad),
    row_start (nbuckets, nb) int32, block, seg_width).
    """
    nmodes, nbuckets, C = binds.shape
    block = max(128, min(block, ceil_to(max(C, 1), 128)))
    nnz_pad = max(block, ceil_to(C, block))
    nb = nnz_pad // block
    out_i = np.zeros((nmodes, nbuckets, nnz_pad), dtype=np.int32)
    out_v = np.zeros((nbuckets, nnz_pad), dtype=bvals.dtype)
    for b in range(nbuckets):
        n = int(counts[b])
        order = stable_argsort(binds[mode, b, :n])
        out_i[:, b, :n] = binds[:, b, :n][:, order]
        out_v[b, :n] = bvals[b, :n][order]
        out_i[mode, b, n:] = local_dim
    rows = out_i[mode].reshape(nbuckets, nb, block)
    row_start = np.ascontiguousarray(rows[:, :, 0]).astype(np.int32)
    if nbuckets > 0 and counts.size and int(counts.max()) > 0:
        span = int((rows[:, :, -1] - rows[:, :, 0]).max()) + 1
    else:
        span = 1
    # the sentinel tails inflate the last real block's span: clamp as
    # build_layout does (the kernels drop ids past the width)
    seg_width = ceil_to(min(span, local_dim if local_dim > 0 else 1), 8)
    return out_i, out_v, row_start, block, seg_width


def _memmap_of(arr) -> Optional[np.memmap]:
    """The np.memmap an array views (through its ``.base`` chain), or
    None."""
    while arr is not None and not isinstance(arr, np.memmap):
        arr = getattr(arr, "base", None)
    return arr


def is_memmapped(arr) -> bool:
    """Whether an array is (a view of) an np.memmap."""
    return _memmap_of(arr) is not None


def _memmap_dir(arr) -> Optional[str]:
    """The directory of the file backing a memmapped array, or None: where
    derived layouts go when the caller names no ``out_dir``."""
    fn = getattr(_memmap_of(arr), "filename", None)
    return os.path.dirname(str(fn)) if fn else None


def _drop_pages(*arrays) -> None:
    """Flush every memmap backing these arrays and advise its pages away
    (MADV_DONTNEED).  Touched file pages, dirty output pages above all,
    stay resident and count toward the RSS until reclaimed; dropping them
    after each chunk keeps a streamed build's peak RSS at the chunk, not
    the tensor.  The pages fault in again from the file when read."""
    for arr in arrays:
        a = _memmap_of(arr)
        if a is None:
            continue
        try:
            a.flush()
            a._mmap.madvise(mmap.MADV_DONTNEED)
        except (AttributeError, ValueError, OSError):
            pass  # no madvise on this platform, or no mmap behind it


class _FlushWindow:
    """The flush policy of the chunked writers into memmapped outputs:
    flush and drop the outputs' pages once `budget` bytes were written
    since the last flush.  A flush after every chunk is a writeback storm
    (each covers the whole file); never flushing leaves the RSS growing
    with the output.

    The count is exact for clustered writes (the scatter's per-bucket
    cursors, the sort's ascending positions) and an undercount for writes
    spread thinly over many pages; there the kernel's own writeback
    bounds the resident pages, which are always evictable."""

    def __init__(self, *arrays, budget: int = 256 << 20) -> None:
        self.arrays = arrays
        self.budget = budget
        self.dirty = 0

    def wrote(self, nbytes: int) -> None:
        self.dirty += nbytes
        if self.dirty >= self.budget:
            self.flush()

    def flush(self) -> None:
        if self.dirty > 0:
            _drop_pages(*self.arrays)
            self.dirty = 0


def _subdir(out_dir: Optional[str], name: str) -> Optional[str]:
    """``out_dir/name``, or None without an `out_dir`."""
    return None if out_dir is None else os.path.join(out_dir, name)


def _outputs(out_dir: Optional[str], names: Tuple[str, str], shapes,
             dtypes) -> Tuple[np.ndarray, np.ndarray]:
    """Two zeroed output arrays: ``.npy`` memmaps named `names` under
    `out_dir` (created; ``w+`` makes sparse zero-filled files), else in
    memory."""
    if out_dir is None:
        return tuple(np.zeros(sh, dtype=dt) for sh, dt in zip(shapes, dtypes))
    os.makedirs(out_dir, exist_ok=True)
    return tuple(np.lib.format.open_memmap(
        os.path.join(out_dir, name), mode="w+", dtype=np.dtype(dt),
        shape=sh) for name, sh, dt in zip(names, shapes, dtypes))


def streamed_bucket_scatter(inds, vals, owner_fn, nbuckets: int, val_dtype,
                            chunk: int = STREAM_CHUNK,
                            out_dir: Optional[str] = None,
                            postprocess=None,
                            counts: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, np.ndarray, int,
                                       np.ndarray]:
    """:func:`bucket_scatter` in two chunked passes over (possibly
    memmapped) nonzeros, the same arrays (≙ the reference streaming
    equal-nnz chunks from the root rank, mpi_simple_distribute,
    src/mpi/mpi_io.c:587-648).

    ``owner_fn(inds_chunk, start) -> (n,) bucket ids`` runs on each chunk
    (in both passes: recomputing beats an O(nnz) owner array); `start` is
    the chunk's first nonzero, for owners by position (equal-nnz fences,
    a partition file).  ``postprocess(binds_chunk)`` maps each chunk's
    int32 indices before they are placed (the fence-local indices of a
    grid or COARSE build).  With `out_dir` the outputs are ``binds.npy``
    and ``bvals.npy`` memmaps under it, and the host holds
    O(chunk + nbuckets).  `counts`, each bucket's occupancy when the
    caller has it (a grid build does, deciding its fences), skips the
    counting pass.
    """
    from splatt_tpu_torch.blocked import check_int32_dims

    nmodes, nnz = inds.shape
    if counts is None:
        counts = np.zeros(nbuckets, dtype=np.int64)
        for s in range(0, nnz, chunk):
            e = min(nnz, s + chunk)
            own = np.asarray(owner_fn(np.asarray(inds[:, s:e]), s),
                             dtype=np.int64)
            if own.min(initial=0) < 0 or own.max(initial=0) >= nbuckets:
                raise ValueError(f"owner ids must lie in [0, {nbuckets})")
            counts += np.bincount(own, minlength=nbuckets)
            _drop_pages(inds, vals)
    C = max(int(counts.max(initial=0)), 1)
    binds, bvals = _outputs(out_dir, ("binds.npy", "bvals.npy"),
                            ((nmodes, nbuckets, C), (nbuckets, C)),
                            (np.int32, val_dtype))
    cursor = np.zeros(nbuckets, dtype=np.int64)
    win = _FlushWindow(binds, bvals)
    for s in range(0, nnz, chunk):
        e = min(nnz, s + chunk)
        ichunk = np.asarray(inds[:, s:e])
        own = np.asarray(owner_fn(ichunk, s), dtype=np.int64)
        order = stable_argsort(own)
        own_s = own[order]
        ccounts = np.bincount(own_s, minlength=nbuckets)
        # each (sorted) nonzero's slot in its bucket
        offs = np.zeros(nbuckets + 1, dtype=np.int64)
        np.cumsum(ccounts, out=offs[1:])
        slot = cursor[own_s] + (np.arange(own_s.size) - offs[own_s])
        if ichunk.size and int(ichunk.max()) >= 2**31 - 1:
            check_int32_dims([int(ichunk.max()) + 1])
        placed = ichunk[:, order].astype(np.int32)
        if postprocess is not None:
            placed = postprocess(placed)
        binds[:, own_s, slot] = placed
        bvals[own_s, slot] = np.asarray(vals[s:e])[order]
        cursor += ccounts
        if out_dir is not None:
            _drop_pages(inds, vals)     # clean input pages: no writeback
            win.wrote((e - s) * (nmodes * 4 + bvals.dtype.itemsize))
    if out_dir is not None:
        win.flush()
    return binds, bvals, C, counts


def streamed_blocked_buckets(binds: np.ndarray, bvals: np.ndarray,
                             counts: np.ndarray, mode: int, local_dim: int,
                             block: int, out_dir: Optional[str] = None,
                             chunk: int = STREAM_CHUNK
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        int, int]:
    """:func:`blocked_buckets` with host memory bounded by the chunk, for
    (memmapped) buckets too large to sort in memory: the piece that keeps
    the blocked engine on an out-of-core tensor (the reference runs
    mttkrp_csf per rank at any scale, src/mpi/mpi_cpd.c:714).

    Per bucket, a two-pass counting sort on the mode's row (keys in
    [0, local_dim)): pass 1 counts the keys chunk by chunk, pass 2 moves
    each chunk to its final positions.  It is stable, so the permutation
    is :func:`blocked_buckets`' stable argsort bit for bit.  With
    `out_dir` the outputs are ``linds.npy`` and ``lvals.npy`` memmaps
    under it; input pages are dropped after every chunk, output pages
    through a :class:`_FlushWindow`.  Returns what
    :func:`blocked_buckets` returns, sentinel-padded tails included.
    """
    nmodes, nbuckets, C = binds.shape
    block = max(128, min(block, ceil_to(max(C, 1), 128)))
    nnz_pad = max(block, ceil_to(C, block))
    nb = nnz_pad // block
    out_i, out_v = _outputs(out_dir, ("linds.npy", "lvals.npy"),
                            ((nmodes, nbuckets, nnz_pad),
                             (nbuckets, nnz_pad)), (np.int32, bvals.dtype))
    row_start = np.zeros((nbuckets, nb), dtype=np.int32)
    span = 0
    win = _FlushWindow(out_i, out_v)
    row_bytes = nmodes * 4 + out_v.dtype.itemsize
    for b in range(nbuckets):
        n = int(counts[b])
        hist = np.zeros(local_dim, dtype=np.int64)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            hist += np.bincount(np.asarray(binds[mode, b, s:e]),
                                minlength=local_dim)
            _drop_pages(binds)
        offs = np.zeros(local_dim + 1, dtype=np.int64)
        np.cumsum(hist, out=offs[1:])
        cursor = np.zeros(local_dim, dtype=np.int64)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            keys = np.asarray(binds[mode, b, s:e])
            order = stable_argsort(keys)
            ks = keys[order]
            ccounts = np.bincount(ks, minlength=local_dim)
            coffs = np.zeros(local_dim + 1, dtype=np.int64)
            np.cumsum(ccounts, out=coffs[1:])
            # the stable rank: the key's offset, the earlier chunks'
            # entries of the key, the rank among the chunk's equal keys
            pos = offs[ks] + cursor[ks] + (np.arange(ks.size) - coffs[ks])
            for m in range(nmodes):
                out_i[m, b, pos] = np.asarray(binds[m, b, s:e])[order]
            out_v[b, pos] = np.asarray(bvals[b, s:e])[order]
            cursor += ccounts
            _drop_pages(binds, bvals)
            win.wrote((e - s) * row_bytes)
        for s in range(n, nnz_pad, chunk):       # the sentinel tail
            e = min(nnz_pad, s + chunk)
            out_i[mode, b, s:e] = local_dim
            win.wrote((e - s) * 4)
        firsts = np.asarray(out_i[mode, b, 0::block])
        lasts = np.asarray(out_i[mode, b, block - 1::block])
        row_start[b] = firsts.astype(np.int32)
        span = max(span, int((lasts - firsts).max(initial=0)) + 1)
        win.flush()
    if not (nbuckets > 0 and counts.size and int(counts.max()) > 0):
        span = 1
    seg_width = ceil_to(min(span, local_dim if local_dim > 0 else 1), 8)
    return out_i, out_v, row_start, block, seg_width


def auto_local_engine(tt, out_dir: Optional[str]) -> str:
    """The per-rank MTTKRP engine when the caller names none, the JAX
    package's rule for all three decompositions: the blocked engine,
    except for a memmapped tensor without a scratch directory, whose
    sorted copies would be a second O(nnz) allocation in host memory.
    (The FINE ring patterns are stream-only; their caller adds that.)"""
    return ("stream" if is_memmapped(tt.inds) and out_dir is None
            else "blocked")


def record_local_engine(engine: str, tt, out_dir: Optional[str]) -> dict:
    """Record the per-rank engine a distributed CPD runs as a
    ``local_engine`` event, beside ``out_of_core``: the scratch directory
    its build memmaps under, or None for an in-memory build (a tensor the
    driver relabeled in memory included).  Call it with the tensor the
    build reads: the streamed builds run exactly when that tensor is
    memmapped."""
    from splatt_tpu_torch import resilience

    return resilience.run_report().add(
        "local_engine", engine=engine,
        out_of_core=(out_dir if out_dir is not None and is_memmapped(tt.inds)
                     else None))


def build_bucket_layout(binds: np.ndarray, bvals: np.ndarray,
                        counts: np.ndarray, mode: int, local_dim: int,
                        block: int, out_dir: Optional[str] = None,
                        chunk: int = STREAM_CHUNK):
    """The one dispatch point of every decomposition's per-rank layouts:
    :func:`streamed_blocked_buckets` (its outputs under `out_dir`) for
    memmapped buckets, which exist exactly when the scatter ran with an
    ``out_dir``; :func:`blocked_buckets` for buckets in memory."""
    if is_memmapped(binds):
        return streamed_blocked_buckets(binds, bvals, counts, mode,
                                        local_dim, block, out_dir=out_dir,
                                        chunk=chunk)
    return blocked_buckets(binds, bvals, counts, mode, local_dim, block)


def bucket_engine(seg_width: int, opts: Options) -> str:
    """The path of a per-rank sorted layout's own mode: the port's one
    rule on every device (``ops/mttkrp.py`` ``choose_path``), the sorted
    per-block reduction whenever the block span fits ``onehot_cap``.  The
    JAX package takes it only on a TPU (``sorted_scatter`` on the CPU),
    with the same numbers."""
    return ("sorted_onehot" if seg_width <= opts.onehot_cap
            else "sorted_scatter")


def upload(arr: np.ndarray, dev, dtype=None,
           chunk: int = STREAM_CHUNK) -> torch.Tensor:
    """`arr` as a tensor on `dev` (in `dtype`, default its own).  An array
    in memory goes in one copy; a memmapped one goes into a tensor
    allocated on `dev` in chunks of at most `chunk` entries along its
    last axis, each chunk read into host memory (a copy: the map may be
    read-only), copied, and its pages dropped, so the host never holds
    more than a chunk of it."""
    if not is_memmapped(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev, dtype)
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
    out = torch.empty(arr.shape, device=dev, dtype=dtype)
    n = arr.shape[-1]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        out[..., s:e].copy_(torch.from_numpy(np.array(arr[..., s:e])))
        _drop_pages(arr)
    return out


def place_buckets(binds: np.ndarray, bvals: np.ndarray, mesh, dtype,
                  chunk: int = STREAM_CHUNK
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Bucket r of ``(nmodes, nbuckets, C)`` indices and ``(nbuckets, C)``
    values on rank r's device, the values in `dtype` (memmapped buckets
    in chunks, :func:`upload`)."""
    inds, vals = [], []
    for r, dev in enumerate(mesh.devices):
        inds.append(upload(binds[:, r], dev, chunk=chunk))
        vals.append(upload(bvals[r], dev, dtype, chunk=chunk))
    return inds, vals


@dataclasses.dataclass(frozen=True)
class RankLayouts:
    """One sorted and blocked layout per rank, each on its rank's device
    (≙ a shard_mapped layout array, one bucket per device), and the
    statics they share: `sort_mode` and its row count `sort_dim` (the
    sentinel), the block, the seg width and the path that mode `mode`
    of a sweep takes over them: the sorted `path` for the sort mode, and
    ``scatter`` (the gather product into ``index_add_``, plain torch)
    for a mode that shares another mode's layout."""

    inds: Tuple[torch.Tensor, ...]
    vals: Tuple[torch.Tensor, ...]
    row_start: Tuple[torch.Tensor, ...]
    counts: Tuple[int, ...]
    block: int
    seg_width: int
    path: str
    sort_mode: int
    sort_dim: int

    @staticmethod
    def place(built, counts, path: str, sort_mode: int, sort_dim: int,
              mesh, dtype) -> "RankLayouts":
        """Copy :func:`build_bucket_layout`'s host arrays `built` to the
        ranks' devices: bucket r to rank r, values in `dtype`."""
        i, v, rs, block, seg_width = built
        inds, vals = place_buckets(i, v, mesh, dtype)
        starts = [upload(rs[r], dev) for r, dev in enumerate(mesh.devices)]
        return RankLayouts(tuple(inds), tuple(vals), tuple(starts),
                           tuple(int(c) for c in counts), int(block),
                           int(seg_width), path, int(sort_mode),
                           int(sort_dim))

    def for_mode(self, m: int) -> "RankLayouts":
        """The layouts as mode m's sweep step reads them: the arrays
        shared by reference, the path ``scatter`` unless m is the sort
        mode."""
        if m == self.sort_mode:
            return self
        return dataclasses.replace(self, path="scatter")

    def layout(self, r: int):
        """Rank r's layout as a port ``ModeLayout``."""
        return bucket_layout(self.inds[r], self.vals[r], self.row_start[r],
                             self.sort_mode, self.sort_dim, self.block,
                             self.seg_width, self.counts[r])

    def mttkrp(self, r: int, factors: Sequence[torch.Tensor], mode: int,
               fallback: Optional[bool] = None) -> torch.Tensor:
        """Rank r's local MTTKRP of `mode` over its layout."""
        return blocked_local_mttkrp(
            self.inds[r], self.vals[r], self.row_start[r], factors, mode,
            dim=self.sort_dim, block=self.block, seg_width=self.seg_width,
            path=self.path, sort_mode=self.sort_mode, nnz=self.counts[r],
            fallback=fallback)


def rank_layouts_by_mode(built: dict, nmodes: int) -> List[RankLayouts]:
    """Per mode, the layouts its sweep step reads (≙ CellLayouts.
    device_put): the sort mode's own where the alloc policy built one
    (`built` maps sort mode to :class:`RankLayouts`, in build order),
    else the first built, shared by reference on the ``scatter`` path."""
    first = next(iter(built.values()))
    return [built.get(m, first).for_mode(m) for m in range(nmodes)]


def blocked_local_mttkrp(inds_b, vals_b, row_start_b, factors, mode: int,
                         dim: int, block: int, seg_width: int, path: str,
                         sort_mode: Optional[int] = None, nnz: int = 0,
                         fallback: Optional[bool] = None) -> torch.Tensor:
    """Run the single-card blocked MTTKRP engine over one rank's bucket
    (≙ each rank calling the optimized mttkrp_csf locally,
    src/mpi/mpi_cpd.c:714): a port ``ModeLayout`` over the bucket's
    arrays, on their device, through ``mttkrp_blocked``'s engine chain,
    so on a card ``fused_mttkrp_t`` serves a sorted mode.

    `sort_mode`/`dim` describe the layout (the mode its nonzeros are
    sorted by, and that mode's local row count, the sentinel); `mode` is
    the output mode.  When they differ `path` is ``scatter``.
    ``factors[mode]`` only carries the output row count on the sorted
    paths (its values are not read).  Returns ``(rows of factors[mode],
    R)`` in the accumulator dtype."""
    from splatt_tpu_torch.ops.mttkrp import mttkrp_blocked

    lay = bucket_layout(inds_b, vals_b, row_start_b,
                        mode if sort_mode is None else sort_mode, dim, block,
                        seg_width, nnz)
    return mttkrp_blocked(lay, list(factors), mode, path=path,
                          fallback=fallback)


def bucket_layout(inds_b, vals_b, row_start_b, sort_mode: int, dim: int,
                  block: int, seg_width: int, nnz: int = 0):
    """A port ``ModeLayout`` (v1) over one bucket's sorted arrays, on
    their device: `nnz` real entries sorted by `sort_mode`, whose `dim`
    rows are the sentinel of the padded tail."""
    from splatt_tpu_torch.blocked import ModeLayout

    return ModeLayout(inds=inds_b, vals=vals_b, row_start=row_start_b,
                      mode=sort_mode, dim=dim, block=block,
                      seg_width=seg_width, nnz=nnz)


def engine_fallback(opts: Options) -> bool:
    """Whether a failing per-rank MTTKRP engine is demoted for the next
    in its chain: ``opts.engine_fallback``, else the env default."""
    from splatt_tpu_torch import resilience

    return (resilience.fallback_enabled() if opts.engine_fallback is None
            else opts.engine_fallback)


def balanced_relabel(hist: np.ndarray, nparts: int, cap: int) -> np.ndarray:
    """nnz-balanced row → label map for equal-width fences (≙ the
    nnz-balanced layer boundaries of p_find_layer_boundaries,
    src/mpi/mpi_io.c:365-439): a capacity-constrained LPT pack assigns
    rows, heaviest first, to the least-loaded fence with free slots, then
    labels fence p's rows ``p*cap .. p*cap+count_p-1``.

    Args: hist (dim,) per-row nnz counts; nparts fences of cap labels
    each (nparts*cap >= dim).  Returns (dim,) int64 old → new labels.
    """
    import heapq

    dim = int(hist.shape[0])
    if nparts * cap < dim:
        raise ValueError(f"{nparts} fences x {cap} labels < {dim} rows")
    order = np.argsort(-hist, kind="stable")
    counts = np.zeros(nparts, dtype=np.int64)
    part_of = np.empty(dim, dtype=np.int64)
    heap = [(0, p) for p in range(nparts)]
    for r in order:
        load, p = heapq.heappop(heap)
        part_of[r] = p
        counts[p] += 1
        if counts[p] < cap:  # full fences never return to the heap
            heapq.heappush(heap, (load + int(hist[r]), p))
    by_part = np.lexsort((np.arange(dim), part_of))
    starts = np.zeros(nparts, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    part_sorted = part_of[by_part]
    slot = np.arange(dim) - starts[part_sorted]
    relabel = np.empty(dim, dtype=np.int64)
    relabel[by_part] = part_sorted * cap + slot
    return relabel


def relabel_tensor(tt, relabels: Sequence[Optional[np.ndarray]],
                   dims_pad: Sequence[int]):
    """`tt` with every mode's indices mapped through its relabel array
    (None = identity), at the padded dims."""
    from splatt_tpu_torch.coo import SparseTensor

    inds = np.stack([relabels[m][np.asarray(tt.inds[m])]
                     if relabels[m] is not None
                     else np.asarray(tt.inds[m])
                     for m in range(tt.nmodes)])
    return SparseTensor(inds, tt.vals, tuple(dims_pad))


def record_shard_imbalance(scope: str, counts: np.ndarray,
                           policy: str = "equal", **extra) -> dict:
    """Record a sharding's nnz balance as a ``layout_imbalance`` event:
    max/mean nnz per shard beside the policy that produced it."""
    from splatt_tpu_torch import resilience

    counts = np.asarray(counts, dtype=np.int64).ravel()
    stats = dict(scope=scope, policy=policy, shards=int(counts.size),
                 shard_max_mean=max_mean_ratio(counts),
                 min=int(counts.min()) if counts.size else 0,
                 mean=round(float(counts.mean()), 1) if counts.size else 0,
                 max=int(counts.max()) if counts.size else 0, **extra)
    resilience.run_report().add("layout_imbalance", **stats)
    return stats


def imbalance_report(counts: np.ndarray, label: str = "device") -> str:
    """nnz-per-rank balance line (≙ mpi_rank_stats, src/stats.c:298-457):
    max/avg is the padded-work waste factor (1.0 = balanced)."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0 or counts.sum() == 0:
        return f"  {label} nnz: (empty)"
    avg = counts.mean()
    imb = counts.max() / avg if avg > 0 else 1.0
    return (f"  {label} nnz: min={int(counts.min())} avg={avg:.1f} "
            f"max={int(counts.max())} imbalance={imb:.2f}")


def comm_volume_model(dims_pad: Sequence[int], rank: int, itemsize: int,
                      *, ndev: int = None, grid: Sequence[int] = None,
                      acc_itemsize: int = 4,
                      variant: str = "all2all") -> dict:
    """Per-iteration, per-rank wire model of a distributed sweep's
    exchanges (≙ mpi_send_recv_stats), the same numbers as the JAX
    package's model.  With `grid` (MEDIUM): per mode the layer reduce of
    one (block_rows, R) block over the other axes and the Gram/λ
    allreduce over axis m, all as ``allreduce_mb``.  Otherwise the FINE
    sweep's, by `variant`: "all2all" at the collectives' ring lower
    bounds; "ring" ndev hops per gather leg of one (dim/ndev, R) block and
    the blockwise reduce; "async_ring" ndev-1 hops per leg, the reduce
    point to point at accumulator width, ``per_hop_mb`` (the largest hop)
    and ``overlap_eligible_frac`` (the ring bytes a double buffer can
    hide: all but the pipeline fill)."""
    nmodes = len(dims_pad)
    mb = 1.0 / (1 << 20)
    out = dict(variant=variant if grid is None else "grid",
               gather_mb=0.0, reduce_mb=0.0, allreduce_mb=0.0,
               per_hop_mb=0.0, hops=0, overlap_eligible_frac=0.0)
    if grid is not None:
        allred = 0.0
        for m in range(nmodes):
            layer = int(np.prod([g for k, g in enumerate(grid) if k != m]))
            block = dims_pad[m] // max(grid[m], 1)
            if layer > 1:
                allred += (2.0 * (layer - 1) / layer * block * rank
                           * acc_itemsize)
            allred += 2.0 * rank * rank * acc_itemsize
        out["allreduce_mb"] = round(allred * mb, 4)
        return out
    w = max(int(ndev), 1)
    gather = reduce_b = allred = hop = 0.0
    for m in range(nmodes):
        allred += 2.0 * rank * rank * acc_itemsize
    if variant in ("ring", "async_ring"):
        real_hops = (w - 1) if variant == "async_ring" else w
        for m in range(nmodes):
            for k in range(nmodes):
                if k != m:
                    blk = (dims_pad[k] // w) * rank * itemsize
                    hop = max(hop, blk)
                    gather += real_hops * blk
            if variant == "async_ring":
                blk = (dims_pad[m] // w) * rank * acc_itemsize
                hop = max(hop, blk)
                reduce_b += (w - 1) * blk
            else:
                reduce_b += 2.0 * (w - 1) / w * dims_pad[m] * rank \
                    * acc_itemsize
        out["hops"] = int(real_hops)
        out["per_hop_mb"] = round(hop * mb, 4)
        if variant == "async_ring":
            out["overlap_eligible_frac"] = round((w - 1) / w, 4)
    else:
        for m in range(nmodes):
            for k in range(nmodes):
                if k != m:
                    gather += (w - 1) / w * dims_pad[k] * rank * itemsize
            reduce_b += (w - 1) / w * dims_pad[m] * rank * acc_itemsize
    out["gather_mb"] = round(gather * mb, 4)
    out["reduce_mb"] = round(reduce_b * mb, 4)
    out["allreduce_mb"] = round(allred * mb, 4)
    return out


def comm_volume_report(dims_pad: Sequence[int], rank: int, itemsize: int,
                       *, ndev: int = None, grid: Sequence[int] = None,
                       acc_itemsize: int = 4,
                       variant: str = "all2all") -> list:
    """The ``comm/iter/device`` lines over :func:`comm_volume_model`."""
    model = comm_volume_model(dims_pad, rank, itemsize, ndev=ndev,
                              grid=grid, acc_itemsize=acc_itemsize,
                              variant=variant)
    if grid is not None:
        return [f"  comm/iter/device: layer psum + gram allreduce "
                f"{model['allreduce_mb']:.2f}MB"]
    if model["variant"] in ("ring", "async_ring"):
        tag = ("async ring" if model["variant"] == "async_ring"
               else "ppermute ring")
        line = (f"  comm/iter/device [{tag}]: gather "
                f"{model['gather_mb']:.2f}MB "
                f"({model['hops']} hops x {model['per_hop_mb']:.2f}MB max) "
                f" reduce {model['reduce_mb']:.2f}MB  allreduce "
                f"{model['allreduce_mb']:.2f}MB")
        if model["variant"] == "async_ring":
            line += (f"  overlap-eligible "
                     f"{100 * model['overlap_eligible_frac']:.0f}%")
        return [line]
    return [f"  comm/iter/device: all_gather {model['gather_mb']:.2f}MB  "
            f"psum_scatter {model['reduce_mb']:.2f}MB  "
            f"allreduce {model['allreduce_mb']:.2f}MB"]


# -- cross-rank reductions ---------------------------------------------------


def allreduce(tensors: Sequence[torch.Tensor], mesh, op: str = "sum",
              groups: Optional[Sequence[Sequence[int]]] = None
              ) -> List[torch.Tensor]:
    """Each group's tensors combined on its first rank's device in rank
    order (``sum`` or ``max``), one copy of the result per rank of the
    group on its device (ranks that share a device share the copy).
    `groups` splits the ranks into disjoint groups (default: one group
    of every rank, a psum over a 1-D mesh's axis)."""
    if groups is None:
        groups = [range(mesh.ndev)]
    out: List[Optional[torch.Tensor]] = [None] * mesh.ndev
    for group in groups:
        group = list(group)
        home = mesh.devices[group[0]]
        tot = tensors[group[0]]
        for r in group[1:]:
            t = tensors[r].to(home)
            tot = tot + t if op == "sum" else torch.maximum(tot, t)
        copies = {}
        for r in group:
            dev = mesh.devices[r]
            out[r] = copies.setdefault(dev, tot.to(dev))
    return out


def mode_update_tail(M_l: Sequence[torch.Tensor], grams, m: int, reg: float,
                     first: bool, mesh, store_dtype=None, groups=None):
    """The per-mode ALS tail on every rank's block: the normal-equations
    solve, the normalization with λ reduced over the ranks
    (≙ mat_normalize, src/matrix.c:117-187) and the Gram reduced over the
    ranks (≙ mat_aTa, src/matrix.c:445-452).  `groups` are the rank
    groups of those two reductions (:func:`allreduce`): on the MEDIUM
    grid the ranks along axis m, so the replicas of a block on the other
    axes are not counted again.

    `grams[k]` holds rank copies of mode k's Gram.  The left-hand side
    is the same on every rank, so it is factored once, on rank 0's
    device, and each rank solves its rows with the factors copied over
    (:func:`solve_normals_many`).  Returns (U per rank, Gram per rank, λ
    per rank); U is stored in `store_dtype`, the rest in the
    accumulator dtype."""
    from splatt_tpu_torch.ops.linalg import form_normal_lhs, gram

    lhs = form_normal_lhs([g[0] for g in grams], m, reg)
    U = solve_normals_many(lhs, M_l)
    if first:
        lam = [torch.sqrt(s) for s in
               allreduce([torch.sum(u * u, dim=0) for u in U], mesh,
                         groups=groups)]
    else:
        lam = [torch.clamp(x, min=1.0) for x in
               allreduce([torch.max(u, dim=0).values for u in U], mesh,
                         op="max", groups=groups)]
    U = [u / torch.where(lm > 0, lm, torch.ones_like(lm))
         for u, lm in zip(U, lam)]
    if store_dtype is not None:
        U = [u.to(store_dtype) for u in U]
    grams_m = allreduce([gram(u) for u in U], mesh, groups=groups)
    return U, grams_m, lam


def solve_normals_many(lhs: torch.Tensor, rhs: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """:func:`splatt_tpu_torch.ops.linalg.solve_normals` of one `lhs`
    against each rank's `rhs`: the Cholesky and eigen factors of `lhs`
    are computed once (on a card by the eigensolver kernel, no host sync)
    and copied to each rank's device, and each rank picks the Cholesky or
    the pseudo-inverse solve on the same SPD test."""
    from splatt_tpu_torch.ops.linalg import pinv_parts

    L, info = torch.linalg.cholesky_ex(lhs)
    w, v, tol, w_inv = pinv_parts(lhs)
    spd_lhs = (info == 0) & (w.min() > tol)
    pinv_op = v * w_inv
    ops = {}
    out = []
    for r in rhs:
        dev = r.device
        if dev not in ops:
            ops[dev] = tuple(t.to(dev) for t in (L, pinv_op, v, spd_lhs))
        L_d, p_d, v_d, spd_d = ops[dev]
        r = r.to(acc_dtype(r.dtype))
        x_chol = torch.cholesky_solve(r.T, L_d).T
        x_pinv = (r @ p_d) @ v_d.T
        spd = spd_d & torch.isfinite(x_chol).all()
        out.append(torch.where(spd, x_chol, x_pinv))
    return out


def fit_tail(lam, grams, M_l, U_last, mesh, ranks=None):
    """⟨Z,Z⟩ from λ and the Grams, and ⟨X,Z⟩ from the last mode's MTTKRP
    blocks summed over `ranks` (default every rank; on the MEDIUM grid
    one holder of each block of the last mode) (≙ p_calc_fit + the fit
    allreduce, mpi_cpd.c:92-98); both on rank 0's device."""
    had = torch.outer(lam[0], lam[0])
    for g in grams:
        had = had * g[0]
    znormsq = torch.sum(had)
    ranks = list(range(mesh.ndev)) if ranks is None else list(ranks)
    home = mesh.devices[0]
    inner = None
    for r in ranks:
        part = torch.sum(M_l[r] * U_last[r].to(M_l[r].dtype)
                         * lam[r][None, :]).to(home)
        inner = part if inner is None else inner + part
    return znormsq, inner


def _fit(xnormsq: float, znormsq: torch.Tensor,
         inner: torch.Tensor) -> torch.Tensor:
    residual = torch.sqrt(torch.clamp(xnormsq + znormsq - 2.0 * inner,
                                      min=0.0))
    return 1.0 - residual / np.sqrt(xnormsq)


# -- the driver loop ---------------------------------------------------------


def _gather_global(shards) -> torch.Tensor:
    """One row-sharded factor, its shards concatenated on the host."""
    return torch.cat([s.cpu() for s in shards])


def _gather_original(factors, dims, row_select,
                     shard_ranks=None) -> List[torch.Tensor]:
    """Bring the row-sharded factors to the host, restore the original
    row order and strip the row padding.  `shard_ranks[m]`, when given,
    lists the ranks whose blocks of mode m, in that order, make the
    whole factor (default every rank)."""
    out = []
    for m, shards in enumerate(factors):
        if shard_ranks is not None:
            shards = [shards[r] for r in shard_ranks[m]]
        g = _gather_global(shards)
        sel = row_select[m] if row_select is not None else None
        out.append(g[:dims[m]] if sel is None
                   else g[torch.from_numpy(np.asarray(sel))])
    return out


#: the phase timers of the profiled distributed sweeps
DIST_TIMER_NAMES = ("dist_gather", "dist_mttkrp", "dist_comm",
                    "dist_update", "dist_fit")


def reset_dist_timers() -> None:
    """Zero the distributed phase timers (after a profiled step's first
    call, so its first launches stay out of the attribution)."""
    from splatt_tpu_torch.utils.timers import timers

    for name in DIST_TIMER_NAMES:
        timers.get(name).seconds = 0.0


def wrap_profiled_step(step: Callable) -> Callable:
    """A profiled step that zeroes the phase timers after its first call,
    so the attribution covers warm iterations only
    (≙ splatt_tpu.parallel.common.wrap_profiled_step)."""
    ncalls = [0]

    def wrapped(*args):
        out = step(*args)
        ncalls[0] += 1
        if ncalls[0] == 1:
            reset_dist_timers()
        return out

    return wrapped


def dist_phase_report() -> List[str]:
    """The measured per-phase totals of a profiled distributed run
    (≙ mpi_time_stats' per-phase table, mpi_cpd.c:893-939; the phases
    are fenced on every card, so one wall clock is the max)."""
    from splatt_tpu_torch.utils.timers import timers

    lines = ["distributed phase times (in-loop totals, warm iterations):"]
    for name, label in (("dist_gather", "gather rows"),
                        ("dist_mttkrp", "local mttkrp"),
                        ("dist_comm", "reduce collective"),
                        ("dist_update", "solve+normalize+gram"),
                        ("dist_fit", "fit")):
        t = timers.get(name)
        if t.seconds > 0:
            lines.append(f"  {label:<22s} {t.seconds:8.3f}s")
    return lines


def no_phase(name: str):
    """The plain sweeps' phase bracket: nothing."""
    return contextlib.nullcontext()


@contextlib.contextmanager
def profiled_phase(name: str, mesh):
    """One phase of a profiled distributed sweep: its timer bracket,
    closed after every card of `mesh` has finished the phase's work
    (no-op fence on a CPU mesh)."""
    from splatt_tpu_torch.utils.timers import timers

    with timers.time(name):
        yield
        if mesh.is_cuda:
            for card in mesh.cards:
                torch.cuda.synchronize(card)


def _health_pack_dist(factors, lam, fit, home) -> torch.Tensor:
    """The sentinel's vector for per-rank factors: ``[fit, isfinite of
    every rank's block of U_0, ..., of U_{n-1}, isfinite(λ),
    isfinite(fit)]`` on `home`, one host copy at the fit read."""
    fit = torch.as_tensor(fit)
    flags = [torch.stack([torch.isfinite(u).all().to(home)
                          for u in f]).all() for f in factors]
    flags.append(torch.isfinite(lam).all().to(home))
    flags.append(torch.isfinite(fit).to(home))
    return torch.cat([fit.reshape(1).to(home),
                      torch.stack(flags).to(fit.dtype)])


def run_distributed_als(step: Callable, factors, grams, rank: int,
                        opts: Options, xnormsq: float,
                        dims: Sequence[int], dtype, mesh,
                        row_select=None,
                        after_fit: Optional[Callable] = None,
                        shard_ranks=None,
                        place: Optional[Callable] = None,
                        gram_of: Optional[Callable] = None,
                        checkpoint_path: Optional[str] = None,
                        checkpoint_every: int = 10,
                        resume: bool = True) -> KruskalTensor:
    """Host convergence loop and post-processing of a distributed sweep.

    ``step(factors, grams, first) -> (factors, grams, λ, ⟨Z,Z⟩, ⟨X,Z⟩)``
    with factors and Grams as per-rank lists; it returns new lists and
    leaves its inputs alone.  The fit is read at check iterations
    (``opts.fit_check_every``, the last, and a due checkpoint); the
    eigensolver's status word is read right after it, then `after_fit`
    runs (the ring kernels' error check).  The factors come back to the
    host, in the original row order (`row_select[m]` maps an original
    row to its placement; on the MEDIUM grid `shard_ranks` names the
    ranks that hold one copy of each block), and are renormalized into
    λ (≙ cpd_post_process).

    Checkpoints (≙ splatt_tpu/parallel/common.py:787-1033): with
    `checkpoint_path` the factors are gathered to the original row space
    and written every `checkpoint_every` iterations and at the end, in
    the single-card format, so a checkpoint does not depend on the
    decomposition or the rank count; an existing one is resumed from
    (`resume`), re-placed by ``place(U, m) -> per-rank list`` with the
    Grams recomputed by ``gram_of(per-rank factor, m)``.  The sentinel
    (``SPLATT_HEALTH_RETRIES``) keeps references to the last verified
    per-rank tensors; a rollback restores them and redraws each
    offending factor in the original row space from
    ``np.random.default_rng(seed + 7919 + attempt)`` (as the JAX package
    does), leaving the regularization as it is (the step holds it); a
    checkpoint due at a rolled-back iteration is carried to the next
    healthy check; an exhausted budget returns the last verified state,
    checkpointed.
    """
    from splatt_tpu_torch import trace

    with trace.enabling(opts.trace):
        with trace.span("dist.als", rank=int(rank),
                        max_iterations=int(opts.max_iterations)):
            return _run_distributed_als_traced(
                step, factors, grams, rank, opts, xnormsq, dims, dtype,
                mesh, row_select, after_fit, shard_ranks, place, gram_of,
                checkpoint_path, checkpoint_every, resume)


def _run_distributed_als_traced(step, factors, grams, rank, opts, xnormsq,
                                dims, dtype, mesh, row_select, after_fit,
                                shard_ranks, place, gram_of,
                                checkpoint_path, checkpoint_every,
                                resume) -> KruskalTensor:
    """:func:`run_distributed_als` inside its ``dist.als`` root span."""
    import os

    from splatt_tpu_torch import resilience, trace
    from splatt_tpu_torch.config import fit_dtype
    from splatt_tpu_torch.cpd import (_health_verdict, _save_checkpoint,
                                      health_retries,
                                      load_checkpoint_resilient)
    from splatt_tpu_torch.ops.linalg import SolverError, check_solver
    from splatt_tpu_torch.utils import faults

    if checkpoint_path and checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if checkpoint_path and (place is None or gram_of is None):
        raise ValueError("checkpoints need the decomposition's place and "
                         "gram_of")
    home = mesh.devices[0]
    fit_dt = torch.promote_types(dtype, fit_dtype())
    fit_prev = 0.0
    start_it = 0
    lam = [torch.ones(rank, dtype=fit_dt, device=home)]
    if checkpoint_path and resume and (
            os.path.exists(checkpoint_path)
            or os.path.exists(checkpoint_path + ".bak")):
        loaded = load_checkpoint_resilient(checkpoint_path)
        if loaded is not None:
            fs, lam_ck, start_it, fit_ck = loaded
            if (len(fs) != len(factors)
                    or any(int(f.shape[0]) != d or int(f.shape[1]) != rank
                           for f, d in zip(fs, dims))):
                raise ValueError(
                    f"checkpoint {checkpoint_path} does not match this run "
                    f"(dims {tuple(dims)}, rank {rank}); pass resume=False "
                    f"to overwrite")
            factors = [place(U, m) for m, U in enumerate(fs)]
            grams = [gram_of(f, m) for m, f in enumerate(factors)]
            lam = [lam_ck.to(home, fit_dt)]
            fit_prev = fit_ck
            if opts.verbosity >= Verbosity.LOW:
                print(f"  resumed from {checkpoint_path} at iteration "
                      f"{start_it} (fit {fit_ck:0.5f})")
    k = opts.fit_check_every
    last_check_it = start_it
    done_it = start_it
    guard = health_retries()
    health_attempts = 0
    degraded = False
    save_pending = False
    # the rollback target: references to the last verified tensors (the
    # step never modifies its inputs, so nothing is copied)
    snap = (list(factors), list(grams), lam) if guard > 0 else None
    fits: List[float] = []
    seconds: List[float] = []
    fit_iters: List[int] = []
    for it in range(start_it, opts.max_iterations):
        t0 = time.perf_counter()
        with trace.span("dist.step", it=it + 1):
            factors, grams, lam, znormsq, inner = step(factors, grams,
                                                       it == 0)
        # chaos hook: poison the last factor (every rank's block)
        factors = list(factors)
        factors[-1] = faults.poison_many("cpd.sweep", list(factors[-1]))
        save_now = (checkpoint_path
                    and (it + 1) % checkpoint_every == 0
                    and it + 1 != opts.max_iterations)
        if ((it + 1) % k != 0 and it + 1 != opts.max_iterations
                and not save_now):
            if opts.verbosity >= Verbosity.HIGH:
                print(f"  its = {it + 1:3d} (deferred fit check)")
            continue
        fit_arr = _fit(xnormsq, znormsq, inner)
        if guard > 0:
            # the finite checks ride the fit read
            fitval, offending, healthy = _health_verdict(
                _health_pack_dist(factors, lam[0], fit_arr,
                                  home).cpu().numpy(), len(factors))
        else:
            fitval, offending, healthy = (float(fit_arr.reshape(1).cpu()[0]),
                                          [], True)
        if not healthy:
            health_attempts += 1
            try:
                check_solver()
            except SolverError:
                pass
            resilience.run_report().add(
                "health_nonfinite", iteration=it + 1, modes=offending,
                error=f"non-finite distributed sweep outputs at "
                      f"iteration {it + 1}")
            if health_attempts > guard:
                degraded = True
                break
            seq_f, seq_g = list(snap[0]), list(snap[1])
            rng = np.random.default_rng(opts.seed() + 7919
                                        + health_attempts)
            for m in offending:
                fresh = rng.random((int(dims[m]), rank))
                seq_f[m] = place(fresh, m)
                seq_g[m] = gram_of(seq_f[m], m)
            factors, grams, lam = seq_f, seq_g, snap[2]
            # a checkpoint due now goes to the next healthy check
            save_pending = save_pending or bool(save_now)
            resilience.run_report().add(
                "health_rollback", iteration=it + 1,
                attempt=health_attempts, regularization=None,
                rerandomized=offending)
            if opts.verbosity >= Verbosity.LOW:
                print(f"  non-finite sweep outputs at iteration "
                      f"{it + 1}; rolled back to the last-good "
                      f"snapshot (attempt {health_attempts}/{guard}, "
                      f"re-randomized modes {offending})")
            continue
        check_solver()
        if after_fit is not None:
            after_fit()
        if guard > 0:
            snap = (list(factors), list(grams), lam)
        if save_now or save_pending:
            _save_checkpoint(checkpoint_path,
                             _gather_original(factors, dims, row_select,
                                              shard_ranks),
                             lam[0], it + 1, fitval)
            save_pending = False
        fits.append(fitval)
        seconds.append(time.perf_counter() - t0)
        fit_iters.append(it + 1)
        if opts.verbosity >= Verbosity.LOW:
            print(f"  its = {it + 1:3d} ({seconds[-1]:.3f}s)"
                  f"  fit = {fitval:0.5f}  delta = {fitval - fit_prev:+0.4e}")
        # a checkpoint-forced check shortens the window: the tolerance
        # scales with it, so checkpoints cannot change convergence
        window = (it + 1) - last_check_it
        last_check_it = it + 1
        done_it = it + 1
        if it > 0 and abs(fitval - fit_prev) < opts.tolerance * window:
            fit_prev = fitval
            break
        fit_prev = fitval

    if degraded:
        gathered = _gather_original(snap[0], dims, row_select, shard_ranks)
        lam = snap[2]
        action = "stopped early with the last-good factors"
        if checkpoint_path:
            _save_checkpoint(checkpoint_path, gathered, lam[0], done_it,
                             fit_prev)
            action += f"; checkpointed to {checkpoint_path}"
        resilience.run_report().add("health_degraded",
                                    iteration=done_it, action=action)
        if opts.verbosity >= Verbosity.LOW:
            print(f"  health-retry budget ({guard}) exhausted; {action}")
        return post_process(gathered, lam[0].cpu(), fit_prev, fits,
                            seconds, fit_iters)
    gathered = _gather_original(factors, dims, row_select, shard_ranks)
    # the final save: a finished run's checkpoint is never stale
    if checkpoint_path and done_it > start_it:
        _save_checkpoint(checkpoint_path, gathered, lam[0], done_it,
                         fit_prev)
    return post_process(gathered, lam[0].cpu(), fit_prev, fits, seconds,
                        fit_iters)
