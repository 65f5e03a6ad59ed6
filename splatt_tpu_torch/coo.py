"""Host-side COO sparse tensor (≙ sptensor_t, src/sptensor.h:27-40).

Counterpart of ``splatt_tpu/coo.py``: host numpy arrays, ``inds`` an
``(nmodes, nnz)`` int64 (or int32, as a memory-mapped ``.bin`` gives it)
array, ``vals`` a float vector.  Device compute runs on
:class:`splatt_tpu_torch.blocked.BlockedSparse`.  Sorting takes the native
host sort (``native.py``) for a full mode order where it builds, else
``np.lexsort``; both give the same stable permutation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from splatt_tpu_torch.config import MAX_NMODES


@dataclasses.dataclass
class SparseTensor:
    """m-mode coordinate sparse tensor.

    Attributes:
      inds: (nmodes, nnz) int64 coordinates, 0-indexed.
      vals: (nnz,) values.
      dims: mode sizes.
      indmaps: per-mode local->global maps from :meth:`remove_empty_slices`.
    """

    inds: np.ndarray
    vals: np.ndarray
    dims: Tuple[int, ...]
    indmaps: Optional[List[Optional[np.ndarray]]] = None

    def __post_init__(self) -> None:
        self.inds = np.ascontiguousarray(self.inds)
        if self.inds.dtype not in (np.dtype(np.int32), np.dtype(np.int64)):
            self.inds = self.inds.astype(np.int64)
        self.vals = np.ascontiguousarray(self.vals)
        if self.inds.ndim != 2:
            raise ValueError("inds must be (nmodes, nnz)")
        if self.nmodes > MAX_NMODES:
            raise ValueError(
                f"nmodes {self.nmodes} exceeds MAX_NMODES={MAX_NMODES}")
        if self.inds.shape[1] != self.vals.shape[0]:
            raise ValueError("inds/vals nnz mismatch")
        self.dims = tuple(int(d) for d in self.dims)

    @property
    def nmodes(self) -> int:
        return self.inds.shape[0]

    @property
    def nnz(self) -> int:
        return self.inds.shape[1]

    def density(self) -> float:
        dense = 1.0
        for d in self.dims:
            dense *= float(d)
        return self.nnz / dense if dense > 0 else 0.0

    def normsq(self) -> float:
        """Squared Frobenius norm (≙ tt_normsq)."""
        return float(np.dot(self.vals, self.vals))

    def mode_histogram(self, mode: int) -> np.ndarray:
        """nnz count per slice of `mode` (≙ tt_get_hist)."""
        return np.bincount(self.inds[mode], minlength=self.dims[mode])

    def nslices_nonempty(self, mode: int) -> int:
        return int(np.count_nonzero(self.mode_histogram(mode)))

    @staticmethod
    def from_arrays(inds: Sequence[np.ndarray], vals: np.ndarray,
                    dims: Optional[Sequence[int]] = None) -> "SparseTensor":
        ind = np.stack([np.asarray(i, dtype=np.int64) for i in inds])
        if dims is None:
            dims = [int(ind[m].max()) + 1 if ind.shape[1] else 0
                    for m in range(ind.shape[0])]
        return SparseTensor(ind, np.asarray(vals), tuple(dims))

    @staticmethod
    def random(dims: Sequence[int], nnz: int, seed: int = 0,
               distinct: bool = True) -> "SparseTensor":
        """Uniform random tensor from a numpy generator seeded by `seed`
        (the JAX package's draws, so both give the same tensor)."""
        rng = np.random.default_rng(seed)
        ind = np.stack([rng.integers(0, d, size=nnz) for d in dims])
        vals = rng.random(nnz)
        tt = SparseTensor(ind, vals, tuple(int(d) for d in dims))
        if distinct:
            tt = tt.deduplicate()
        return tt

    def sort_order(self, mode_order: Sequence[int]) -> np.ndarray:
        """Stable permutation sorting the nonzeros lexicographically by
        `mode_order`, whose first entry is the primary key (≙ tt_sort,
        src/sort.c:912-961): the native host sort for a full mode order,
        else (a partial order, no compiler) ``np.lexsort``."""
        from splatt_tpu_torch import native

        order = list(mode_order)
        perm = native.sort_perm(self.inds, self.dims, order)
        if perm is not None:
            return perm
        # np.lexsort sorts by the LAST key first
        keys = tuple(self.inds[m] for m in reversed(order))
        return np.lexsort(keys)

    def sorted_by(self, mode_order: Sequence[int]) -> "SparseTensor":
        perm = self.sort_order(mode_order)
        return SparseTensor(self.inds[:, perm], self.vals[perm], self.dims,
                            indmaps=self.indmaps)

    def deduplicate(self) -> "SparseTensor":
        """Sum values at repeated coordinates (≙ tt_remove_dups)."""
        if self.nnz == 0:
            return self
        perm = self.sort_order(range(self.nmodes))
        ind = self.inds[:, perm]
        vals = self.vals[perm]
        new = np.empty(self.nnz, dtype=bool)
        new[0] = True
        np.any(ind[:, 1:] != ind[:, :-1], axis=0, out=new[1:])
        starts = np.flatnonzero(new)
        summed = np.add.reduceat(vals, starts)
        return SparseTensor(ind[:, starts], summed, self.dims,
                            indmaps=self.indmaps)

    def count_duplicates(self) -> int:
        if self.nnz == 0:
            return 0
        perm = self.sort_order(range(self.nmodes))
        ind = self.inds[:, perm]
        same = np.all(ind[:, 1:] == ind[:, :-1], axis=0)
        return int(np.count_nonzero(same))

    def remove_empty_slices(self) -> "SparseTensor":
        """Relabel each mode to drop empty slices (≙ tt_remove_empty);
        modes that shrank record their local->global ``indmap``."""
        new_inds = np.empty_like(self.inds)
        indmaps: List[Optional[np.ndarray]] = []
        dims: List[int] = []
        for m in range(self.nmodes):
            uniq, inv = np.unique(self.inds[m], return_inverse=True)
            if uniq.shape[0] == self.dims[m]:
                new_inds[m] = self.inds[m]
                indmaps.append(None)
                dims.append(self.dims[m])
            else:
                new_inds[m] = inv
                indmaps.append(uniq.copy())
                dims.append(int(uniq.shape[0]))
        if all(im is None for im in indmaps):
            return self
        return SparseTensor(new_inds, self.vals.copy(), tuple(dims),
                            indmaps=indmaps)

    def unfold(self, mode: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                         Tuple[int, int]]:
        """Mode-`mode` matricization as CSR (≙ tt_unfold,
        src/sptensor.h:183-196): (indptr, indices, data, shape), rows the
        dim of `mode`, columns the other modes row-major in increasing
        mode order, the last fastest."""
        rows = self.inds[mode]
        other = [m for m in range(self.nmodes) if m != mode]
        col = np.zeros(self.nnz, dtype=np.int64)
        stride = 1
        # int64 sums: int32 ids of a memory-mapped tensor would wrap once
        # the column space passes 2^31
        for m in reversed(other):
            col += self.inds[m].astype(np.int64) * stride
            stride *= self.dims[m]
        order = np.lexsort((col, rows))
        r, c, v = rows[order], col[order], self.vals[order]
        indptr = np.zeros(self.dims[mode] + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, c, v, (self.dims[mode], int(stride))

    def permute(self, perms: Sequence[Optional[np.ndarray]]
                ) -> "SparseTensor":
        """Relabel each mode by ``perms[m]`` (old -> new; None keeps the
        mode) (≙ perm_apply, src/reorder.c:350)."""
        new_inds = self.inds.copy()
        for m, p in enumerate(perms):
            if p is not None:
                new_inds[m] = np.asarray(p, dtype=np.int64)[self.inds[m]]
        return SparseTensor(new_inds, self.vals.copy(), self.dims,
                            indmaps=self.indmaps)

    def copy(self) -> "SparseTensor":
        return SparseTensor(
            self.inds.copy(), self.vals.copy(), self.dims,
            indmaps=None if self.indmaps is None else
            [None if m is None else m.copy() for m in self.indmaps])

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SparseTensor):
            return NotImplemented
        return (self.dims == other.dims
                and np.array_equal(self.inds, other.inds)
                and np.array_equal(self.vals, other.vals))

    def to_dense(self) -> np.ndarray:
        """The dense ndarray, duplicates summed: small tensors only."""
        out = np.zeros(self.dims, dtype=self.vals.dtype)
        np.add.at(out, tuple(self.inds), self.vals)
        return out
