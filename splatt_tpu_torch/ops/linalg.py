"""Dense linear algebra for CPD-ALS (≙ src/matrix.c, src/splatt_lapack.h).

Counterpart of ``splatt_tpu/ops/linalg.py``.  The rank×rank and dim×rank
dense math is plain ``torch.matmul``/``torch.linalg``, as the JAX package
leaves it to XLA.  TF32 is switched off for float32 matmuls so the normal
equations keep full float32 precision.  bf16 operands are cast to f32
before any product (a bf16 ``torch.matmul`` returns bf16): Gram, solve and
normalization accumulate in f32 (≙ splatt_tpu/ops/linalg.py:33-36,
:74-83, :101-114).
"""

from __future__ import annotations

from typing import Sequence

import torch

from splatt_tpu_torch.config import acc_dtype

torch.backends.cuda.matmul.allow_tf32 = False


def gram(U: torch.Tensor) -> torch.Tensor:
    """UᵀU, accumulated in :func:`acc_dtype` (≙ mat_aTa)."""
    A = U.to(acc_dtype(U.dtype))
    return A.T @ A


def form_normal_lhs(grams: Sequence[torch.Tensor], mode: int,
                    regularization: float = 0.0) -> torch.Tensor:
    """Hadamard product of all Grams except `mode`, + ρI (≙ p_form_gram)."""
    rank = grams[0].shape[0]
    out = torch.ones((rank, rank), dtype=grams[0].dtype,
                     device=grams[0].device)
    for m, g in enumerate(grams):
        if m != mode:
            out = out * g
    if regularization != 0.0:
        out = out + regularization * torch.eye(rank, dtype=out.dtype,
                                               device=out.device)
    return out


def solve_normals(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``X · lhs = rhs`` for X (≙ mat_solve_normals).

    Both a Cholesky solve and an eigh pseudo-inverse solve (eigenvalues
    below √eps·max|w| cut) are computed, and ``torch.where`` picks one on
    the SPD test: no Python branch and no exception on a matrix that is
    not SPD (≙ splatt_tpu/ops/linalg.py:53-86).  ``torch.linalg.eigh``
    itself reads its solver status on the host.
    """
    rhs = rhs.to(acc_dtype(rhs.dtype))
    L, info = torch.linalg.cholesky_ex(lhs)
    x_chol = torch.cholesky_solve(rhs.T, L).T

    w, v = torch.linalg.eigh(lhs)
    tol = torch.finfo(lhs.dtype).eps ** 0.5 * w.abs().max()
    w_inv = torch.where(w.abs() > tol, 1.0 / w, torch.zeros_like(w))
    x_pinv = (rhs @ (v * w_inv)) @ v.T

    spd = (info == 0) & (w.min() > tol) & torch.isfinite(x_chol).all()
    return torch.where(spd, x_chol, x_pinv)


def normalize_columns(U: torch.Tensor, which: str = "2"):
    """Normalize columns, returning (normalized U, λ).

    "2": 2-norm (iteration 0).  "max": the signed column max floored at
    1, so an all-negative column gets λ = 1 (≙ p_mat_2norm/p_mat_maxnorm,
    src/matrix.c:87-205).
    """
    if which == "2":
        A = U.to(acc_dtype(U.dtype))
        lam = torch.sqrt((A * A).sum(dim=0))
    elif which == "max":
        lam = torch.clamp(U.max(dim=0).values, min=1.0)
    else:
        raise ValueError(f"unknown norm {which!r}")
    safe = torch.where(lam > 0, lam, torch.ones_like(lam))
    return U / safe.to(U.dtype), lam
