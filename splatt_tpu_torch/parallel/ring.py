"""The sync ring of the FINE decomposition (≙ splatt_tpu/parallel/ring.py).

≙ SPLATT_OPTION_COMM = POINT2POINT (types_config.h:197-201): the
reference's Isend/Irecv row exchange (p_reduce_rows_point2point /
p_update_rows_point2point, src/mpi/mpi_cpd.c:323-546).  No rank ever
holds a whole factor or a whole MTTKRP output: a rank's peak is one row
block, O(dim/ndev · R).

Both functions take one tensor per rank (each on its rank's device) and a
mesh, and every hop is a ``Tensor.to`` onto the next rank's device.  They
are the ``ring`` comm variant and the references the ring kernels
(``parallel/ring_kernels.py``) are held to; the reduce is also the
reduce kernel's plain version:

- :func:`ring_gather_rows` (≙ mpi_update_rows): the factor blocks travel
  right; at step s rank d holds block (d - s) mod ndev and picks the rows
  of the nonzeros that block owns.  Each row is written once: exact.
- :func:`blockwise_reduce_rows` (≙ mpi_reduce_rows): the partial of block
  j starts at rank j+1 and travels right; each holder adds its local sum
  of block j, and after ndev-1 hops the owner holds its reduced rows.
  Rounding follows hop order (the JAX package's ``psum`` sums in its own
  order; the two agree to rounding).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from splatt_tpu_torch.config import acc_dtype


def ring_gather_rows(U_l: Sequence[torch.Tensor],
                     idx: Sequence[torch.Tensor], mesh
                     ) -> List[torch.Tensor]:
    """Each rank's rows of a row-sharded factor at its global ids, the
    ``ring`` variant's gather: :func:`gather_hops` behind the
    ``comm.ring_exchange`` fault site."""
    from splatt_tpu_torch.utils import faults

    # the ring row-exchange fault site covers the sync ring too: a drill
    # armed past the async engine lands here next
    faults.maybe_fail("comm.ring_exchange")
    return gather_hops(U_l, idx, mesh)


def gather_hops(U_l: Sequence[torch.Tensor], idx: Sequence[torch.Tensor],
                mesh) -> List[torch.Tensor]:
    """The sync ring's gather, the reference ``ring_gather`` is held to
    (its plain version, ``ring_kernels.ring_gather_plain``, walks the
    kernel's owner buckets instead).

    U_l[d]: (block, R) rank d's shard; idx[d]: (nnz_d,) global ids.
    Returns rank d's (nnz_d, R) rows in U's dtype.  Ids of no shard (a
    pad with owner -1, or past the last block) give zero rows.
    """
    ndev = mesh.ndev
    block = int(U_l[0].shape[0])
    rows = [torch.zeros((int(i.shape[0]), int(U.shape[1])), dtype=U.dtype,
                        device=U.device) for U, i in zip(U_l, idx)]
    cur = list(U_l)
    for step in range(ndev):
        for d in range(ndev):
            ids = idx[d].long()
            mask = torch.div(ids, block, rounding_mode="floor") \
                == (d - step) % ndev
            local = torch.where(mask, ids % block, torch.zeros_like(ids))
            picked = cur[d].index_select(0, local)
            rows[d] = torch.where(mask[:, None], picked, rows[d])
        if step < ndev - 1:
            cur = [cur[(d - 1) % ndev].to(mesh.devices[d])
                   for d in range(ndev)]
    return rows


def local_block_sum(prod: torch.Tensor, idx: torch.Tensor, j: int,
                    block: int) -> torch.Tensor:
    """One rank's sum of its products into block j's (block, R) rows, in
    the accumulator dtype."""
    out_dtype = acc_dtype(prod.dtype)
    ids = idx.long()
    mask = torch.div(ids, block, rounding_mode="floor") == j
    out = torch.zeros((block, int(prod.shape[1])), dtype=out_dtype,
                      device=prod.device)
    return out.index_add_(
        0, torch.where(mask, ids % block, torch.zeros_like(ids)),
        (prod * mask[:, None].to(prod.dtype)).to(out_dtype))


def blockwise_reduce_rows(prod: Sequence[torch.Tensor],
                          idx: Sequence[torch.Tensor], mesh,
                          block: int) -> List[torch.Tensor]:
    """The sync ring's reduce, the ``ring`` variant's and the plain
    version of ``ring_reduce``: each rank's reduced (block, R) rows in the
    accumulator dtype, without any rank holding the (dim_pad, R) partial.
    prod[d]: (nnz_d, R); idx[d]: (nnz_d,) global ids."""
    ndev = mesh.ndev
    held = [None] * ndev
    for step in range(ndev):
        new = []
        for d in range(ndev):
            part = local_block_sum(prod[d], idx[d], (d - 1 - step) % ndev,
                                   block)
            new.append(part if step == 0 else part + held[d])
        if step < ndev - 1:
            held = [new[(d - 1) % ndev].to(mesh.devices[d])
                    for d in range(ndev)]
        else:
            held = new
    return held
