"""The distributed CPD (≙ splatt_tpu/parallel): one process over a mesh of
devices (:mod:`splatt_tpu_torch.parallel.mesh`), in all three
decompositions: MEDIUM (:mod:`~splatt_tpu_torch.parallel.grid`), COARSE
(:mod:`~splatt_tpu_torch.parallel.coarse`) and FINE
(:mod:`~splatt_tpu_torch.parallel.sharded`), each running the single-card
blocked MTTKRP engine in every rank by default."""

from typing import Optional, Tuple

import numpy as np

from splatt_tpu_torch.config import Decomposition, Options, default_opts
from splatt_tpu_torch.kruskal import KruskalTensor
from splatt_tpu_torch.parallel.coarse import coarse_cpd_als
from splatt_tpu_torch.parallel.grid import GridDecomp, grid_cpd_als
from splatt_tpu_torch.parallel.mesh import auto_grid, make_mesh
from splatt_tpu_torch.parallel.sharded import (sharded_cpd_als,
                                               sharded_mttkrp)


def distributed_cpd_als(tt, rank: int, opts: Optional[Options] = None,
                        init=None, grid: Optional[Tuple[int, ...]] = None,
                        partition: Optional[np.ndarray] = None,
                        mesh=None, row_distribute: Optional[str] = None,
                        local_engine: Optional[str] = None,
                        out_dir: Optional[str] = None,
                        measure_overlap: Optional[bool] = None,
                        device=None, checkpoint_path: Optional[str] = None,
                        checkpoint_every: int = 10,
                        resume: bool = True) -> KruskalTensor:
    """Distributed CPD-ALS, dispatching on ``opts.decomposition``
    (≙ SPLATT_OPTION_DECOMP, types_config.h:179-190), as the JAX
    package's does:

    - MEDIUM (the default): the n-D grid on `grid` (default
      :func:`auto_grid`), inputs local, outputs summed over the layer
      (:func:`grid_cpd_als`);
    - COARSE: per-mode owner-computes copies, gathered inputs, no output
      reduce (:func:`coarse_cpd_als`);
    - FINE, or any decomposition but COARSE given a per-nonzero
      `partition`: gathered inputs and reduced outputs
      (:func:`sharded_cpd_als`).

    `local_engine` None lets each decomposition's CPD pick
    (:func:`~splatt_tpu_torch.parallel.common.auto_local_engine`), and
    each records what it runs as a ``local_engine`` run-report event.
    `out_dir` is the scratch directory of the out-of-core build: with a
    memmapped tensor (``io.load_memmap``) every decomposition buckets and
    sorts in chunked passes into memmaps under it and keeps the blocked
    engine (≙ splatt_tpu/parallel/__init__.py:25-47).
    `checkpoint_path`, `checkpoint_every` and `resume` pass through to
    every decomposition (≙ splatt_tpu/parallel/__init__.py:21-46): the
    checkpoint is in the original row space and the single-card format,
    so any decomposition, or ``cpd_als``, resumes it."""
    ck = dict(checkpoint_path=checkpoint_path,
              checkpoint_every=checkpoint_every, resume=resume)
    opts = (opts or default_opts()).validate()
    if opts.decomposition is Decomposition.MEDIUM and partition is None:
        if row_distribute is not None:
            raise ValueError("row_distribute applies to the FINE and "
                             "COARSE decompositions (the medium grid's "
                             "layer fences already localize inputs)")
        return grid_cpd_als(tt, rank, grid=grid, mesh=mesh, opts=opts,
                            init=init, local_engine=local_engine,
                            out_dir=out_dir, device=device, **ck)
    if opts.decomposition is Decomposition.COARSE:
        if row_distribute not in (None, "balanced"):
            raise ValueError("COARSE supports row_distribute='balanced' "
                             "(nnz-weighted fences); 'greedy' is FINE-only")
        return coarse_cpd_als(tt, rank, mesh=mesh, opts=opts, init=init,
                              local_engine=local_engine, out_dir=out_dir,
                              row_distribute=row_distribute, device=device,
                              **ck)
    return sharded_cpd_als(tt, rank, mesh=mesh, opts=opts, init=init,
                           partition=partition,
                           row_distribute=row_distribute,
                           local_engine=local_engine, out_dir=out_dir,
                           measure_overlap=measure_overlap, device=device,
                           **ck)


__all__ = ["auto_grid", "make_mesh", "sharded_cpd_als", "sharded_mttkrp",
           "GridDecomp", "grid_cpd_als", "coarse_cpd_als",
           "distributed_cpd_als"]
