"""Interop with other array libraries (≙ splatt_tpu/interop.py, the
counterpart of the reference's Octave/Matlab bindings, matlab/splatt_*.c,
README.md:177-245): torch and scipy sparse containers to and from
:class:`SparseTensor`, and the CPD and MTTKRP over them.

The CPD runs on `device` as every entry point of the port does (the card
unless the caller asks for the CPU); the MTTKRP runs on the factors'
device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from splatt_tpu_torch.config import Options
from splatt_tpu_torch.coo import SparseTensor


# -- torch ---------------------------------------------------------------


def from_torch(t: torch.Tensor) -> SparseTensor:
    """A torch sparse COO (or dense) tensor as a :class:`SparseTensor`:
    int64 indices, f64 values (the host tensor's convention)."""
    t = t.detach()
    if t.is_sparse:
        t = t.coalesce()
        inds = t.indices().cpu().numpy().astype(np.int64)
        vals = t.values().cpu().numpy().astype(np.float64)
        return SparseTensor(inds, vals, tuple(t.shape))
    dense = t.cpu().numpy()
    idx = np.nonzero(dense)
    return SparseTensor(np.stack([i.astype(np.int64) for i in idx]),
                        dense[idx].astype(np.float64), dense.shape)


def to_torch(tt: SparseTensor) -> torch.Tensor:
    """A :class:`SparseTensor` as a coalesced torch sparse COO tensor."""
    return torch.sparse_coo_tensor(
        torch.from_numpy(np.array(tt.inds, dtype=np.int64)),
        torch.from_numpy(np.array(tt.vals)), size=tt.dims,
        check_invariants=True).coalesce()


def kruskal_to_torch(kt) -> tuple:
    """A KruskalTensor as (factor matrices, λ): copies on the CPU, so an
    in-place edit of them leaves the model as it was."""
    return ([U.detach().cpu().clone() for U in kt.factors],
            kt.lam.detach().cpu().clone())


def cpd_als_torch(t: torch.Tensor, rank: int, opts: Optional[Options] = None,
                  device=None):
    """The CPD of a torch sparse tensor on `device`: (factors, λ, fit)
    (≙ the splatt_cpd MEX entry returning U, lambda and fit)."""
    from splatt_tpu_torch.cpd import cpd_als

    out = cpd_als(from_torch(t), rank, opts=opts, device=device)
    factors, lam = kruskal_to_torch(out)
    return factors, lam, float(out.fit)


def mttkrp_torch(t: torch.Tensor, factors: List[torch.Tensor],
                 mode: int) -> torch.Tensor:
    """The MTTKRP of a torch sparse tensor against factor matrices, on
    the factors' device (the stream path)."""
    from splatt_tpu_torch.ops.mttkrp import mttkrp

    return mttkrp(from_torch(t), [f.detach() for f in factors], mode)


# -- scipy ---------------------------------------------------------------


def from_scipy(mat) -> SparseTensor:
    """A scipy.sparse matrix as a 2-mode :class:`SparseTensor`."""
    coo = mat.tocoo()
    inds = np.stack([coo.row.astype(np.int64), coo.col.astype(np.int64)])
    return SparseTensor(inds, coo.data.astype(np.float64), coo.shape)


def unfold_to_scipy(tt: SparseTensor, mode: int):
    """The mode-`mode` unfolding as a scipy CSR matrix (≙ tt_unfold)."""
    from scipy.sparse import csr_matrix

    indptr, cols, vals, shape = tt.unfold(mode)
    return csr_matrix((vals, cols, indptr), shape=shape)
