"""Kruskal tensor — the CPD output (≙ splatt_kruskal, include/splatt/structs.h:25-44)."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch

from splatt_tpu_torch.config import acc_dtype
from splatt_tpu_torch.io import write_matrix, write_vector


@dataclasses.dataclass
class KruskalTensor:
    """Rank-R factorization ``X ≈ Σ_r λ_r · U1[:,r] ∘ ... ∘ Um[:,r]``.

    factors: (dim_m, rank) factor matrices; lam: (rank,) column norms;
    fit: quality of fit in [0, 1]; fits: the fit at each checked
    iteration (every iteration unless ``Options.fit_check_every`` > 1);
    iter_seconds: each checked iteration's host time, ending in the
    fit's fetch; fit_iters: the 1-based iteration of each entry of fits.
    """

    factors: List[torch.Tensor]
    lam: torch.Tensor
    fit: float
    fits: Tuple[float, ...] = ()
    iter_seconds: Tuple[float, ...] = ()
    fit_iters: Tuple[int, ...] = ()

    @property
    def rank(self) -> int:
        return int(self.factors[0].shape[1])

    @property
    def nmodes(self) -> int:
        return len(self.factors)

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(int(f.shape[0]) for f in self.factors)

    def save(self, directory: str, stem: str = "") -> None:
        """Write ``mode<N>.mat`` and ``lambda.mat`` (≙ cmd_cpd.c:206-233);
        bf16 factors are written at f32, which holds them exactly."""
        os.makedirs(directory, exist_ok=True)
        for m, U in enumerate(self.factors):
            write_matrix(U.to(acc_dtype(U.dtype)).cpu().numpy(),
                         os.path.join(directory, f"{stem}mode{m + 1}.mat"))
        write_vector(np.asarray(self.lam.cpu()),
                     os.path.join(directory, f"{stem}lambda.mat"))


def unstack_batched(factors, lam, fits, dims_list) -> List[KruskalTensor]:
    """Split stacked batched-ALS state into per-slot results
    (≙ splatt_tpu/kruskal.py:115-129): `factors` is the per-mode list of
    ``(K, dim_pad, R)`` stacks, `lam` the ``(K, R)`` λ, `fits` the
    per-slot fits and `dims_list` each slot's true dims;
    :func:`post_process` crops the bucket padding and folds the column
    norms into λ, as every single-tensor driver does."""
    return [post_process([F[i] for F in factors], lam[i], fits[i],
                         dims=tuple(dims))
            for i, dims in enumerate(dims_list)]


def post_process(factors, lam, fit, fits=(), iter_seconds=(),
                 fit_iters=(), dims=None) -> KruskalTensor:
    """Fold the remaining column norms into λ (≙ cpd_post_process,
    src/cpd.c:391-411), first cropping each factor to `dims` where given
    (the batched CPD's bucket padding)."""
    from splatt_tpu_torch.ops.linalg import normalize_columns

    out = []
    for m, U in enumerate(factors):
        if dims is not None:
            U = U[:dims[m]]
        U, norms = normalize_columns(U, "2")
        lam = lam * norms
        out.append(U)
    return KruskalTensor(factors=out, lam=lam, fit=float(fit),
                         fits=tuple(fits), iter_seconds=tuple(iter_seconds),
                         fit_iters=tuple(fit_iters))
