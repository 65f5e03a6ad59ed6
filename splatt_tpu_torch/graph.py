"""Graph / hypergraph models of a sparse tensor (≙ src/graph.c).

Counterpart of ``splatt_tpu/graph.py``, host numpy only.  The analysis
structures (numpy CSR) the reorder and convert verbs use:

- :func:`tensor_to_graph`      ≙ graph_convert (src/graph.c:637-678):
  the m-partite weighted graph — one vertex per (mode, index), an edge
  between every pair of coordinates co-occurring in a nonzero, weighted
  by co-occurrence count.
- :func:`hypergraph_nnz`       ≙ hgraph_nnz_alloc (src/graph.c:452):
  nonzeros as vertices, index-slices as hyperedges.
- :func:`hypergraph_fibers`    ≙ hgraph_fib_alloc (src/graph.c:506):
  mode-rooted fibers as vertices.

External partitioner hooks (METIS/PaToH/Ashado, src/graph.h:180-228)
have no equivalent binary in this environment; partition files can be
supplied to the reorderer instead (≙ the FINE decomposition's partfile).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from splatt_tpu_torch.coo import SparseTensor


@dataclasses.dataclass
class Graph:
    """CSR adjacency with per-vertex/edge weights."""

    indptr: np.ndarray
    adj: np.ndarray
    vwts: Optional[np.ndarray]
    ewts: Optional[np.ndarray]
    nvtxs: int

    @property
    def nedges(self) -> int:
        return int(self.adj.shape[0])


@dataclasses.dataclass
class Hypergraph:
    """Vertices + CSR hyperedge membership (eptr/eind)."""

    nvtxs: int
    eptr: np.ndarray
    eind: np.ndarray
    vwts: Optional[np.ndarray]

    @property
    def nhedges(self) -> int:
        return int(self.eptr.shape[0] - 1)


def _mode_offsets(dims: Tuple[int, ...]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(dims)]).astype(np.int64)


def _merge_unique(uniq, cnts, u, c):
    """Merge two (sorted-unique keys, counts) pairs, summing counts."""
    merged = np.concatenate([uniq, u])
    mc = np.concatenate([cnts, c])
    u2, inv = np.unique(merged, return_inverse=True)
    c2 = np.zeros(u2.shape[0], dtype=np.int64)
    np.add.at(c2, inv, mc)
    return u2, c2


class _UniqueAccumulator:
    """Streaming (sorted-unique keys, counts) accumulation via
    binary-counter run merging (mergesort-run / LSM style): pushing n
    runs costs O(E log n) merge work with only O(log n) runs
    outstanding — neither n re-sorts of the running set nor all runs
    held at once."""

    def __init__(self):
        self._levels = []

    def push(self, u, c):
        run = (u, c)
        for i in range(len(self._levels)):
            if self._levels[i] is None:
                self._levels[i] = run
                return
            run = _merge_unique(*self._levels[i], *run)
            self._levels[i] = None
        self._levels.append(run)

    def result(self):
        out = None
        for lvl in self._levels:
            if lvl is None:
                continue
            out = lvl if out is None else _merge_unique(*out, *lvl)
        if out is None:
            return np.empty(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        return out


def tensor_to_graph(tt: SparseTensor, chunk: int = 1 << 23) -> Graph:
    """m-partite graph: vertex v = offset[m] + index, edges between all
    co-occurring coordinate pairs, weight = #co-occurrences.

    Edge keys are accumulated pair-by-pair in nnz chunks (unique per
    chunk, merged into the running unique set) — peak temporaries are
    O(chunk + edges), not the m·(m−1)·nnz concatenation that made
    NELL-2-scale graphs cost ~3.7GB of int64.
    """
    offs = _mode_offsets(tt.dims)
    nvtxs = int(offs[-1])
    nnz = tt.nnz
    acc = _UniqueAccumulator()
    for a in range(tt.nmodes):
        for b in range(tt.nmodes):
            if a == b:
                continue
            for s in range(0, max(nnz, 1), chunk):
                e = min(nnz, s + chunk)
                key = ((np.asarray(tt.inds[a][s:e], dtype=np.int64)
                        + offs[a]) * nvtxs
                       + np.asarray(tt.inds[b][s:e], dtype=np.int64)
                       + offs[b])
                u, c = np.unique(key, return_counts=True)
                acc.push(u, c.astype(np.int64))
    uniq, counts = acc.result()
    # keys are sorted, so (src, dst) is already lexicographic
    src_u = (uniq // nvtxs).astype(np.int64)
    dst_u = (uniq % nvtxs).astype(np.int64)
    indptr = np.zeros(nvtxs + 1, dtype=np.int64)
    np.add.at(indptr, src_u + 1, 1)
    np.cumsum(indptr, out=indptr)
    vwts = np.concatenate([tt.mode_histogram(m) for m in range(tt.nmodes)])
    return Graph(indptr=indptr, adj=dst_u, vwts=vwts,
                 ewts=counts, nvtxs=nvtxs)


def hypergraph_nnz(tt: SparseTensor) -> Hypergraph:
    """Nonzeros as vertices; hyperedge per (mode, index) containing the
    nonzeros in that slice."""
    offs = _mode_offsets(tt.dims)
    nhedges = int(offs[-1])
    counts = np.zeros(nhedges, dtype=np.int64)
    for m in range(tt.nmodes):
        counts[offs[m]:offs[m + 1]] = tt.mode_histogram(m)
    eptr = np.concatenate([[0], np.cumsum(counts)])
    eind = np.empty(int(eptr[-1]), dtype=np.int64)
    for m in range(tt.nmodes):
        order = np.argsort(tt.inds[m], kind="stable")
        seg = eptr[offs[m]] + np.arange(tt.nnz)
        eind[seg] = order
    return Hypergraph(nvtxs=tt.nnz, eptr=eptr.astype(np.int64), eind=eind,
                      vwts=None)


def hypergraph_fibers(tt: SparseTensor, mode: int) -> Hypergraph:
    """Mode-`mode`-rooted fibers as vertices (a fiber = all nnz sharing
    every coordinate except `mode`); hyperedges per (mode, index) list
    the fibers touching that slice."""
    others = [m for m in range(tt.nmodes) if m != mode]
    # fiber id = rank of the distinct coordinate tuple over `others`
    keys = np.stack([tt.inds[m] for m in others])
    order = np.lexsort(keys[::-1])
    sorted_keys = keys[:, order]
    new_fiber = np.ones(tt.nnz, dtype=bool)
    if tt.nnz > 1:
        new_fiber[1:] = np.any(sorted_keys[:, 1:] != sorted_keys[:, :-1], axis=0)
    fiber_of_sorted = np.cumsum(new_fiber) - 1
    fiber_id = np.empty(tt.nnz, dtype=np.int64)
    fiber_id[order] = fiber_of_sorted
    nfibers = int(fiber_of_sorted[-1]) + 1 if tt.nnz else 0

    offs = _mode_offsets(tt.dims)
    # hyperedges: for every (m, idx) slice, the set of fibers present
    pairs = []
    for m in range(tt.nmodes):
        key = (tt.inds[m] + offs[m]) * max(nfibers, 1) + fiber_id
        pairs.append(np.unique(key))
    allpairs = np.concatenate(pairs) if pairs else np.empty(0, np.int64)
    hedge = allpairs // max(nfibers, 1)
    vtx = allpairs % max(nfibers, 1)
    eptr = np.zeros(int(offs[-1]) + 1, dtype=np.int64)
    np.add.at(eptr, hedge + 1, 1)
    np.cumsum(eptr, out=eptr)
    return Hypergraph(nvtxs=nfibers, eptr=eptr, eind=vtx, vwts=None)


def hypergraph_uncut(h: Hypergraph, parts: np.ndarray) -> np.ndarray:
    """Hyperedges NOT cut by `parts`: every pin in one part
    (≙ hgraph_uncut, src/graph.c:576-624; empty hyperedges are
    trivially uncut).  `parts` maps vertex → part id."""
    parts = np.asarray(parts)
    pin_parts = parts[h.eind]
    # vectorized: an edge is cut iff any *within-edge* adjacent pin pair
    # disagrees (adjacency inequality detects any disagreement without
    # requiring sorted pins); edge-start positions are masked out so
    # pairs never straddle edges
    diff = np.zeros(len(pin_parts), dtype=bool)
    if len(pin_parts) > 1:
        diff[1:] = pin_parts[1:] != pin_parts[:-1]
    starts = h.eptr[:-1]
    diff[starts[starts < len(diff)]] = False
    pos = np.nonzero(diff)[0]
    cut = np.unique(np.searchsorted(h.eptr, pos, side="right") - 1)
    return np.setdiff1d(np.arange(h.nhedges), cut, assume_unique=True)


def write_graph(g: Graph, path: str) -> None:
    """METIS-like text format (≙ graph writers in src/io.c)."""
    has_ew = g.ewts is not None
    has_vw = g.vwts is not None
    fmt = f"{int(has_vw)}{int(has_ew)}"
    with open(path, "w") as f:
        f.write(f"{g.nvtxs} {g.nedges // 2} {fmt}\n")
        for v in range(g.nvtxs):
            parts = []
            if has_vw:
                parts.append(str(int(g.vwts[v])))
            for k in range(g.indptr[v], g.indptr[v + 1]):
                parts.append(str(int(g.adj[k]) + 1))
                if has_ew:
                    parts.append(str(int(g.ewts[k])))
            f.write(" ".join(parts) + "\n")


def write_hypergraph(h: Hypergraph, path: str) -> None:
    """PaToH/hMETIS-like text format."""
    with open(path, "w") as f:
        f.write(f"{h.nhedges} {h.nvtxs}\n")
        for e in range(h.nhedges):
            mem = h.eind[h.eptr[e]:h.eptr[e + 1]]
            f.write(" ".join(str(int(v) + 1) for v in mem) + "\n")
