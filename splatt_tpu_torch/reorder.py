"""Tensor reordering (≙ src/reorder.c).

Counterpart of ``splatt_tpu/reorder.py``, host numpy only.  A reorder
relabels each mode's indices so that nonzeros that share fibers get nearby
labels, which tightens the row spans of the blocked layouts.  Strategies
(≙ splatt_perm_type, src/reorder.h:15-22), each giving the JAX package's
permutation:

- ``random``: a uniform relabeling of every mode from a seeded numpy
  generator (≙ perm_rand);
- ``graph``: breadth-first order over the m-partite graph of
  :func:`graph.tensor_to_graph` from its heaviest vertex (a Python loop
  per edge: minutes at tens of millions of nonzeros);
- ``hgraph``: each mode's slices labeled by the mean position of their
  nonzeros in a sort keyed by the other modes (≙ perm_hgraph,
  src/reorder.c:364, without an external partitioner);
- ``fibsched``: the smallest mode's slices ordered by the first fiber
  that visits them.

:class:`Permutation` keeps both directions per mode (≙ permutation_t,
src/reorder.h:29-33): ``perms[m][old] = new``, ``iperms[m][new] = old``.
Its factor methods take numpy arrays or torch tensors.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.graph import (_mode_offsets, hypergraph_fibers,
                                    tensor_to_graph)

PERM_TYPES = ("random", "graph", "hgraph", "fibsched")

#: the seed a reorder of the layout path is computed under: the recipe's
#: name alone determines the permutation
REORDER_SEED = 0


def _take_rows(U, rows: np.ndarray):
    """``U[rows]`` for a numpy array or a torch tensor (the index moved to
    the tensor's device)."""
    if isinstance(U, np.ndarray):
        return U[rows]
    import torch

    return U.index_select(0, torch.from_numpy(rows).to(U.device))


@dataclasses.dataclass
class Permutation:
    perms: List[Optional[np.ndarray]]   # old -> new per mode
    iperms: List[Optional[np.ndarray]]  # new -> old per mode

    @staticmethod
    def identity(nmodes: int) -> "Permutation":
        return Permutation([None] * nmodes, [None] * nmodes)

    @staticmethod
    def from_perms(perms: Sequence[Optional[np.ndarray]]) -> "Permutation":
        return Permutation(list(perms),
                           [None if p is None else np.argsort(p)
                            for p in perms])

    def apply(self, tt: SparseTensor) -> SparseTensor:
        """Relabel the tensor's indices (≙ perm_apply, src/reorder.c:350)."""
        return tt.permute(self.perms)

    def undo(self, tt: SparseTensor) -> SparseTensor:
        return tt.permute(self.iperms)

    def apply_to_factor(self, U, mode: int):
        """A factor computed over the relabeled tensor back in the
        original labels: row `old` of the result is row
        ``perms[mode][old]`` of U."""
        p = self.perms[mode]
        return U if p is None else _take_rows(U, p)

    def permute_factor(self, U, mode: int):
        """The forward direction of :meth:`apply_to_factor`: a factor in
        the original labels moved into the relabeled row space (row
        ``perms[mode][old]`` of the result is row `old` of U), as a
        caller's init must be before a CPD over the relabeled tensor."""
        p = self.iperms[mode]
        return U if p is None else _take_rows(U, p)

    def undo_factors(self, factors: Sequence) -> List:
        """Every factor of a CPD over the relabeled tensor back in the
        original row order."""
        return [self.apply_to_factor(U, m) for m, U in enumerate(factors)]


def apply_reorder(tt: SparseTensor, how: str, seed: int = REORDER_SEED):
    """Compute and apply the relabeling `how` for the layout path:
    (relabeled tensor, :class:`Permutation`), or ``(tt, None)`` for
    "identity" and on any failure.  The compute and apply run under the
    ``reorder.apply`` fault site; a failure degrades, classified, to
    identity order with a ``reorder_fallback`` event."""
    if how in (None, "", "identity"):
        return tt, None
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils import faults

    try:
        faults.maybe_fail("reorder.apply")
        perm = reorder(tt, how, seed=seed)
        return perm.apply(tt), perm
    except Exception as e:
        cls = resilience.classify_failure(e)
        resilience.run_report().add(
            "reorder_fallback", how=how, failure_class=cls.value,
            error=resilience.failure_message(e)[:200])
        return tt, None


def reorder(tt: SparseTensor, how: str = "graph",
            seed: int = 0) -> Permutation:
    """Compute (not apply) a relabeling (≙ tt_perm, src/reorder.c:271-315)."""
    if how == "random":
        rng = np.random.default_rng(seed)
        return Permutation.from_perms([rng.permutation(d) for d in tt.dims])
    if how == "graph":
        return _graph_bfs_perm(tt)
    if how == "hgraph":
        return _hgraph_perm(tt)
    if how == "fibsched":
        return _fiber_perm(tt)
    raise ValueError(f"unknown reorder type {how!r} (one of {PERM_TYPES})")


def _graph_bfs_perm(tt: SparseTensor) -> Permutation:
    """Breadth-first order over the m-partite graph, each component from
    its heaviest unvisited vertex; each mode's indices labeled in
    first-visit order."""
    g = tensor_to_graph(tt)
    offs = _mode_offsets(tt.dims)
    visited = np.zeros(g.nvtxs, dtype=bool)
    order: List[int] = []
    candidates = np.argsort(-np.diff(g.indptr))
    ci = 0
    queue: deque = deque()
    while len(order) < g.nvtxs:
        while ci < g.nvtxs and visited[candidates[ci]]:
            ci += 1
        if not queue:
            if ci >= g.nvtxs:
                break
            queue.append(int(candidates[ci]))
            visited[candidates[ci]] = True
        while queue:
            v = queue.popleft()
            order.append(v)
            for n in g.adj[g.indptr[v]:g.indptr[v + 1]]:
                if not visited[n]:
                    visited[n] = True
                    queue.append(int(n))
    perms: List[np.ndarray] = [np.empty(d, dtype=np.int64) for d in tt.dims]
    next_label = [0] * tt.nmodes
    for v in order:
        m = int(np.searchsorted(offs, v, side="right")) - 1
        perms[m][v - offs[m]] = next_label[m]
        next_label[m] += 1
    return Permutation.from_perms(perms)


def _hgraph_perm(tt: SparseTensor) -> Permutation:
    """Per mode, the nonzeros sorted by the other modes (the hyperedges
    its slices share), and each slice labeled by the mean position of its
    nonzeros; empty slices last.  (A sort keyed by the mode itself would
    give the identity.)"""
    perms: List[np.ndarray] = []
    for m in range(tt.nmodes):
        others = [k for k in range(tt.nmodes) if k != m]
        order = tt.sort_order(others)
        pos = np.empty(tt.nnz, dtype=np.float64)
        pos[order] = np.arange(tt.nnz)
        sums = np.bincount(tt.inds[m], weights=pos, minlength=tt.dims[m])
        counts = tt.mode_histogram(m)
        centroid = np.where(counts > 0, sums / np.maximum(counts, 1),
                            np.inf)
        by_centroid = np.argsort(centroid, kind="stable")
        p = np.empty(tt.dims[m], dtype=np.int64)
        p[by_centroid] = np.arange(tt.dims[m])
        perms.append(p)
    return Permutation.from_perms(perms)


def _fiber_perm(tt: SparseTensor) -> Permutation:
    """The smallest mode's slices in the order of the first fiber that
    visits them; the other modes keep their labels."""
    root = int(np.argmin(tt.dims))
    h = hypergraph_fibers(tt, root)
    offs = _mode_offsets(tt.dims)
    perms: List[Optional[np.ndarray]] = [None] * tt.nmodes
    firsts = np.full(tt.dims[root], np.iinfo(np.int64).max, dtype=np.int64)
    base = offs[root]
    for idx in range(tt.dims[root]):
        lo, hi = h.eptr[base + idx], h.eptr[base + idx + 1]
        if hi > lo:
            firsts[idx] = h.eind[lo:hi].min()
    order = np.argsort(firsts, kind="stable")
    p = np.empty(tt.dims[root], dtype=np.int64)
    p[order] = np.arange(tt.dims[root])
    perms[root] = p
    return Permutation.from_perms(perms)


def partition_to_perm(parts: np.ndarray, dim: int) -> np.ndarray:
    """A relabeling that makes each part's indices contiguous, from a
    per-index part assignment (≙ the partition-file path,
    src/reorder.c:364-412)."""
    parts = np.asarray(parts[:dim])
    order = np.argsort(parts, kind="stable")
    perm = np.empty(dim, dtype=np.int64)
    perm[order] = np.arange(dim)
    return perm
