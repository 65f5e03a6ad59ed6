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

    @staticmethod
    def load(directory: str, nmodes: int, stem: str = "",
             device=None) -> "KruskalTensor":
        """Read the files :meth:`save` writes (≙ splatt_tpu/kruskal.py:
        68-83) onto `device`, the card unless the caller names another.
        The fit is not in the files: NaN marks it unknown rather than a
        zero-fit model."""
        from splatt_tpu_torch.config import resolve_device
        from splatt_tpu_torch.io import read_matrix

        device = resolve_device(device)
        factors = [torch.from_numpy(np.ascontiguousarray(read_matrix(
            os.path.join(directory, f"{stem}mode{m + 1}.mat")))).to(device)
            for m in range(nmodes)]
        lam = torch.from_numpy(np.ascontiguousarray(np.asarray(read_matrix(
            os.path.join(directory, f"{stem}lambda.mat"))).ravel()))
        return KruskalTensor(factors=factors, lam=lam.to(device),
                             fit=float("nan"))

    def _host(self):
        from splatt_tpu_torch.cpd import _host_array

        return [_host_array(U) for U in self.factors], _host_array(self.lam)

    def to_dense(self) -> np.ndarray:
        """The dense tensor, as a numpy array (small problems and tests;
        ≙ splatt_tpu/kruskal.py:40-51, term by term in the same order)."""
        factors, lam = self._host()
        out = None
        for r in range(self.rank):
            vec = None
            for f in factors:
                col = f[:, r]
                vec = col if vec is None else np.multiply.outer(vec, col)
            out = lam[r] * vec if out is None else out + lam[r] * vec
        return out

    def reconstruct(self, coords) -> np.ndarray:
        """Estimate entries at `coords` (``(B, nmodes)`` indices),
        ``x̂ = Σ_r λ_r Π_m U_m[i_m, r]``, on the host
        (:func:`predict.reconstruct_entries`)."""
        from splatt_tpu_torch.predict import reconstruct_entries

        factors, lam = self._host()
        return reconstruct_entries(factors, lam, coords)

    def top_k(self, fixed, mode: int, k: int):
        """The k best ``(indices, scores)`` along `mode` with every other
        mode fixed by ``fixed={mode: index}`` (:func:`predict.top_k_slice`)."""
        from splatt_tpu_torch.predict import top_k_slice

        factors, lam = self._host()
        return top_k_slice(factors, lam, fixed, mode, k)

    def normsq(self) -> torch.Tensor:
        """⟨Z,Z⟩ = λᵀ (⊛_m UᵐᵀUᵐ) λ (≙ p_kruskal_norm, src/cpd.c:116-152), a
        0-d tensor on the factors' device.  :func:`ops.linalg.gram` keeps
        bf16 factors' Grams in f32, and the sum accumulates in
        :func:`config.acc_dtype`."""
        from splatt_tpu_torch.ops.linalg import gram

        had = torch.outer(self.lam, self.lam)
        for f in self.factors:
            had = had * gram(f)
        return had.sum(dtype=acc_dtype(had.dtype))


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
