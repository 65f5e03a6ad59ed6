"""The distributed CPD (≙ splatt_tpu/parallel): one process over a mesh of
devices (:mod:`splatt_tpu_torch.parallel.mesh`).  The FINE decomposition
is ported (:mod:`~splatt_tpu_torch.parallel.sharded`); MEDIUM
(``parallel/grid.py``) and COARSE (``parallel/coarse.py``) are queued
(ROADMAP.md slice 5 item 5)."""

from typing import Optional

import numpy as np

from splatt_tpu_torch.config import Decomposition, Options, default_opts
from splatt_tpu_torch.kruskal import KruskalTensor
from splatt_tpu_torch.parallel.mesh import auto_grid, make_mesh
from splatt_tpu_torch.parallel.sharded import (sharded_cpd_als,
                                               sharded_mttkrp)

_QUEUED = ("is not ported yet: ROADMAP.md slice 5 item 5 (MEDIUM, "
           "parallel/grid.py; COARSE, parallel/coarse.py); use "
           "Decomposition.FINE")


def distributed_cpd_als(tt, rank: int, opts: Optional[Options] = None,
                        init=None, partition: Optional[np.ndarray] = None,
                        mesh=None, row_distribute: Optional[str] = None,
                        local_engine: Optional[str] = None,
                        measure_overlap: Optional[bool] = None,
                        device=None) -> KruskalTensor:
    """Distributed CPD-ALS, dispatching on ``opts.decomposition``
    (≙ SPLATT_OPTION_DECOMP, types_config.h:179-190), as the JAX
    package's does: FINE (or any decomposition given a per-nonzero
    `partition`, except COARSE) runs :func:`sharded_cpd_als`; MEDIUM
    without a partition and COARSE raise NotImplementedError."""
    opts = (opts or default_opts()).validate()
    if opts.decomposition is Decomposition.MEDIUM and partition is None:
        if row_distribute is not None:
            raise ValueError("row_distribute applies to the FINE and "
                             "COARSE decompositions (the medium grid's "
                             "layer fences already localize inputs)")
        raise NotImplementedError(f"the MEDIUM decomposition {_QUEUED}")
    if opts.decomposition is Decomposition.COARSE:
        raise NotImplementedError(f"the COARSE decomposition {_QUEUED}")
    return sharded_cpd_als(tt, rank, mesh=mesh, opts=opts, init=init,
                           partition=partition,
                           row_distribute=row_distribute,
                           local_engine=local_engine,
                           measure_overlap=measure_overlap, device=device)


__all__ = ["auto_grid", "make_mesh", "sharded_cpd_als", "sharded_mttkrp",
           "distributed_cpd_als"]
