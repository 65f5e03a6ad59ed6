"""Seeded workloads of the serve daemon (≙ splatt_tpu/chaos.py:105-118).

:func:`synthetic_tensor` builds the tensor of a job spec's
``{"synthetic": {dims, nnz, seed}}`` workload and of an update's
``{"delta": ...}``.  The chaos soak itself is ROADMAP queue A item 15.3.
"""

from __future__ import annotations

import numpy as np


def synthetic_tensor(dims, nnz: int, seed: int):
    """Seeded power-law tensor, deduplicated and with empty slices
    removed, so the CPD's shapes are exact; the same draws and the same
    tensor as the JAX package's for one seed."""
    from splatt_tpu_torch.coo import SparseTensor

    rng = np.random.default_rng(seed)
    inds = np.empty((len(dims), nnz), dtype=np.int64)
    for m, d in enumerate(dims):
        raw = rng.zipf(1.4, size=nnz).astype(np.int64)
        inds[m] = (raw + rng.integers(0, d, size=nnz)) % d
    vals = rng.random(nnz) + 0.1
    return SparseTensor(inds, vals, dims).deduplicate() \
                                         .remove_empty_slices()
