"""Tensor and factorization statistics (≙ src/stats.c).

Counterpart of ``splatt_tpu/stats.py``, the same text (the factoring
header names torch where the JAX package names XLA);
:func:`grid_stats_text` reads the port's
:class:`~splatt_tpu_torch.parallel.grid.GridDecomp`.

- :func:`tensor_stats`  ≙ stats_tt basic dims/nnz/density/storage
  (src/stats.c:26-42)
- :func:`cpd_stats_text` ≙ cpd_stats factoring header (rank, iters, tol,
  allocation, storage — src/stats.c:226-296)
"""

from __future__ import annotations

import numpy as np

from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import Options
from splatt_tpu_torch.coo import SparseTensor


def _human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}TB"


def coo_storage_bytes(tt: SparseTensor) -> int:
    return tt.inds.size * tt.inds.dtype.itemsize + tt.vals.nbytes


def tensor_stats(tt: SparseTensor, name: str = "tensor") -> str:
    dims = "x".join(str(d) for d in tt.dims)
    lines = [
        f"Tensor information ---------------------------------",
        f"FILE={name}",
        f"DIMS={dims} NNZ={tt.nnz}",
        f"DENSITY={tt.density():e}",
        f"COORD-STORAGE={_human_bytes(coo_storage_bytes(tt))}",
    ]
    return "\n".join(lines)


def skew_stats(tt: SparseTensor) -> dict:
    """Per-mode slice/fiber skew metrics (docs/layout-balance.md): how
    power-law an input is, as numbers.  Per mode: max/mean and
    p99/median nnz per nonempty slice, the hottest slice's share of all
    nonzeros, and the skew regime bucket the autotuner keys plans by
    (blocked.nnz_skew_bucket).  ``fiber_max_mean`` is the same ratio
    over the mode-rooted fibers of the smallest mode — fiber weight is
    what the balanced packing bin-packs."""
    from splatt_tpu_torch.blocked import nnz_skew_bucket

    out = {"modes": {}}
    for m in range(tt.nmodes):
        hist = tt.mode_histogram(m)
        nz = hist[hist > 0]
        if nz.size == 0:
            out["modes"][str(m)] = dict(max_mean=1.0, p99_median=1.0,
                                        top_share=0.0, bucket="k0")
            continue
        med = float(np.median(nz))
        out["modes"][str(m)] = dict(
            max_mean=round(float(nz.max()) / float(nz.mean()), 3),
            p99_median=round(float(np.percentile(nz, 99))
                             / max(med, 1.0), 3),
            top_share=round(float(nz.max()) / max(tt.nnz, 1), 4),
            nonempty=int(nz.size),
            bucket=nnz_skew_bucket(hist))
    if tt.nnz and tt.nmodes > 1:
        # fiber weights of the smallest mode's fibers (all coordinates
        # but `root` shared): the unit the balanced packer weighs.
        # 1-mode tensors have no other coordinates to key fibers by —
        # the slice stats above are the whole story there.
        root = int(np.argmin(tt.dims))
        others = [m for m in range(tt.nmodes) if m != root]
        keys = np.stack([np.asarray(tt.inds[m]) for m in others])
        order = np.lexsort(keys[::-1])
        sk = keys[:, order]
        new_fiber = np.ones(tt.nnz, dtype=bool)
        if tt.nnz > 1:
            new_fiber[1:] = np.any(sk[:, 1:] != sk[:, :-1], axis=0)
        sizes = np.diff(np.concatenate(
            [np.flatnonzero(new_fiber), [tt.nnz]]))
        out["fiber_max_mean"] = round(float(sizes.max())
                                      / float(sizes.mean()), 3)
        out["fiber_count"] = int(sizes.size)
    return out


def skew_stats_text(tt: SparseTensor) -> str:
    """Human-readable skew report (the `splatt stats` view of
    :func:`skew_stats`) — lets a user (and the log reader) tell a
    uniform tensor from a power-law one before picking layouts."""
    st = skew_stats(tt)
    lines = ["Slice skew -----------------------------------------"]
    for m, d in st["modes"].items():
        lines.append(
            f"  mode {m}: nnz/slice max/mean={d['max_mean']} "
            f"p99/median={d['p99_median']} top-slice "
            f"{100 * d['top_share']:.1f}% of nnz [{d['bucket']}]")
    if "fiber_max_mean" in st:
        lines.append(f"  fibers (smallest-mode-rooted): "
                     f"{st['fiber_count']} fibers, nnz/fiber "
                     f"max/mean={st['fiber_max_mean']}")
    return "\n".join(lines)


def density_stats(tt: SparseTensor, threshold: float = None) -> dict:
    """Per-mode density metrics (docs/dense.md): the raw mode density
    (nnz over the full dense cell count), the PADDED density against
    the dense tile layout's cells (what the verdict thresholds), the
    autotuner's density regime bucket, and the dense/sparse verdict at
    `threshold` (default: the resolved SPLATT_DENSE_THRESHOLD)."""
    from splatt_tpu_torch.blocked import (dense_mode_verdict, mode_density,
                                          mode_density_bucket,
                                          padded_mode_density)
    from splatt_tpu_torch.config import resolve_dense_threshold

    if threshold is None:
        threshold = resolve_dense_threshold(Options())
    out = {"threshold": threshold, "modes": {}}
    for m in range(tt.nmodes):
        out["modes"][str(m)] = dict(
            density=float(mode_density(tt.dims, m, tt.nnz)),
            padded_density=float(padded_mode_density(tt.dims, m, tt.nnz)),
            bucket=mode_density_bucket(tt.dims, m, tt.nnz),
            verdict=("dense" if dense_mode_verdict(tt.dims, m, tt.nnz,
                                                   threshold)
                     else "sparse"))
    return out


def density_stats_text(tt: SparseTensor) -> str:
    """Human-readable per-mode density report (the `splatt stats` view
    of :func:`density_stats`) — tells a dense-mode workload from a
    sparse one before picking layouts (docs/dense.md)."""
    st = density_stats(tt)
    lines = ["Mode density ---------------------------------------"]
    for m, d in st["modes"].items():
        bucket = f" [{d['bucket']}]" if d["bucket"] else ""
        lines.append(
            f"  mode {m}: density={d['density']:.3e} "
            f"padded={d['padded_density']:.3e}{bucket} -> "
            f"{d['verdict']}")
    lines.append(f"  (dense verdict at padded density >= "
                 f"{st['threshold']:g}; SPLATT_DENSE governs dispatch)")
    return "\n".join(lines)


def grid_stats_text(decomp) -> str:
    """Distributed decomposition stats (≙ mpi_global_stats /
    mpi_rank_stats / mpi_cpd_stats, src/stats.c:298-457)."""
    grid = "x".join(str(g) for g in decomp.grid)
    ncells = int(np.prod(decomp.grid))
    lines = [
        "Decomposition --------------------------------------",
        f"GRID={grid} CELLS={ncells} CELL-NNZ={decomp.cell_nnz} "
        f"FILL={decomp.fill:0.3f}",
        f"LAYER-ROWS={'x'.join(str(b) for b in decomp.block_rows)} "
        f"(padded dims {'x'.join(str(d) for d in decomp.dims_pad)})",
    ]
    # per-cell imbalance: padded slots are wasted work (exact counts
    # recorded at build time — explicit zero-valued entries count)
    occupied = np.asarray(decomp.cell_counts).ravel()
    if occupied.size:
        lines.append(
            f"CELL-NNZ min={int(occupied.min())} "
            f"avg={float(occupied.mean()):0.1f} max={int(occupied.max())}")
    return "\n".join(lines)


def partition_quality_text(tt: SparseTensor, parts: np.ndarray) -> str:
    """Quality of a nonzero-level partition (≙ the hypergraph partition
    stats, src/stats.c:53-170): load balance plus the connectivity-1
    cut of each mode's slice hyperedges — for every slice, the number
    of extra parts it spans (= factor rows that must be exchanged under
    the FINE decomposition).
    """
    parts = np.asarray(parts)
    if parts.shape[0] != tt.nnz:
        raise ValueError(
            f"partition length {parts.shape[0]} != nnz {tt.nnz}")
    nparts = int(parts.max()) + 1 if parts.size else 1
    counts = np.bincount(parts, minlength=nparts)
    avg = tt.nnz / max(nparts, 1)
    lines = [
        "Partition quality ----------------------------------",
        f"PARTS={nparts} NNZ-BALANCE max/avg={counts.max() / max(avg, 1e-12):0.3f} "
        f"(min={counts.min()} avg={avg:0.1f} max={counts.max()})",
    ]
    total_cut = 0
    for m in range(tt.nmodes):
        # distinct (slice, part) pairs minus nonempty slices
        key = tt.inds[m].astype(np.int64) * nparts + parts
        pairs = np.unique(key).size
        nonempty = np.unique(tt.inds[m]).size
        cut = pairs - nonempty
        total_cut += cut
        lines.append(f"  mode {m}: connectivity-1 cut = {cut} "
                     f"(of {nonempty} slices)")
    lines.append(f"TOTAL-CUT={total_cut}")
    return "\n".join(lines)


def cpd_stats_text(bs_or_tt, rank: int, opts: Options) -> str:
    lines = [
        "Factoring ------------------------------------------",
        f"NFACTORS={rank} MAXITS={opts.max_iterations} TOL={opts.tolerance:0.1e} "
        f"REG={opts.regularization:0.1e} SEED={opts.seed()} THREADS=torch",
    ]
    if isinstance(bs_or_tt, BlockedSparse):
        bs = bs_or_tt
        nlay = len(bs.layouts)
        lines.append(
            f"BLOCKED-ALLOC={bs.opts.block_alloc.value} NNZ-BLOCK={bs.opts.nnz_block} "
            f"LAYOUTS={nlay}")
        lines.append(f"BLOCKED-STORAGE={_human_bytes(bs.storage_bytes())}")
        for i, lay in enumerate(bs.layouts):
            if lay.encoding == "dense":
                # dense tile layouts have no blocks/segments/pad — the
                # tile geometry is the whole story (docs/dense.md)
                lines.append(
                    f"  layout[{i}]: mode={lay.mode} dense "
                    f"tiles={lay.ntiles}x{lay.block}x{lay.span} "
                    f"index_bytes=0")
                continue
            lines.append(
                f"  layout[{i}]: mode={lay.mode} nblocks={lay.nblocks} "
                f"seg_width={lay.seg_width} pad={lay.nnz_pad - lay.nnz}")
    return "\n".join(lines)
