"""CPD-ALS (≙ src/cpd.c: splatt_cpd_als / cpd_als_iterate).

Counterpart of ``splatt_tpu/cpd.py``, single device.  One sweep updates each
mode in turn::

  M ← MTTKRP(X, U, m); U_m ← solve(⊛_{k≠m} Gram_k + ρI, M);
  (U_m, λ) ← normalize (2-norm on iteration 0, max-norm after);
  Gram_m ← U_mᵀU_m

and the fit is 1 − √(⟨X,X⟩ + ⟨Z,Z⟩ − 2⟨X,Z⟩)/√⟨X,X⟩, with ⟨Z,Z⟩ =
λᵀ(⊛ Grams)λ and ⟨X,Z⟩ from the last mode's MTTKRP.  The run stops when
the fit moves by less than the tolerance (src/cpd.c:368-370).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from splatt_tpu_torch import resilience
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import (Options, Verbosity, acc_dtype,
                                     default_opts, resolve_device,
                                     resolve_dtype)
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.kruskal import KruskalTensor, post_process
from splatt_tpu_torch.ops.linalg import (form_normal_lhs, gram,
                                         normalize_columns, solve_normals)
from splatt_tpu_torch.ops.mttkrp import describe_plan, mttkrp


def init_factors(dims: Sequence[int], rank: int, generator: torch.Generator,
                 dtype=torch.float32, device=None) -> List[torch.Tensor]:
    """Uniform [0, 1) factors drawn mode by mode from `generator` on the
    host, so every device starts from the same numbers (≙ mat_rand)."""
    return [torch.rand((d, rank), generator=generator,
                       dtype=dtype).to(device)
            for d in dims]


def _zz_inner(lam, grams, M, U_last) -> Tuple[torch.Tensor, torch.Tensor]:
    """⟨Z,Z⟩ = λᵀ(⊛ Grams)λ and ⟨X,Z⟩ from the last mode's MTTKRP
    (p_kruskal_norm / p_tt_kruskal_inner, src/cpd.c:116-218)."""
    acc = acc_dtype(M.dtype)
    had = torch.outer(lam, lam)
    for g in grams:
        had = had * g
    inner = torch.einsum("dr,dr,r->", M.to(acc), U_last.to(acc),
                         lam.to(acc))
    return had.to(acc).sum(), inner


def _fit(xnormsq: float, znormsq: torch.Tensor,
         inner: torch.Tensor) -> torch.Tensor:
    residual = torch.sqrt(torch.clamp(xnormsq + znormsq - 2.0 * inner,
                                      min=0.0))
    return 1.0 - residual / np.sqrt(xnormsq)


def _sweep(X, factors, grams, first: bool, reg: float, fallback: bool):
    """One ALS sweep over every mode; updates `factors` and `grams` in
    place and returns (λ, ⟨Z,Z⟩, ⟨X,Z⟩)."""
    nmodes = len(factors)
    lam = M = None
    for m in range(nmodes):
        M = mttkrp(X, factors, m, fallback=fallback)
        U = solve_normals(form_normal_lhs(grams, m, reg), M)
        U, lam = normalize_columns(U, "2" if first else "max")
        factors[m] = U.to(factors[m].dtype)
        grams[m] = gram(factors[m])
    znormsq, inner = _zz_inner(lam, grams, M, factors[nmodes - 1])
    return lam, znormsq, inner


def cpd_als(X: Union[SparseTensor, BlockedSparse], rank: int,
            opts: Optional[Options] = None, init=None,
            device=None) -> KruskalTensor:
    """Rank-`rank` CPD of X (≙ splatt_cpd_als, src/cpd.c:22-63).

    `X` is a :class:`BlockedSparse` (moved to `device` if it lies
    elsewhere) or a COO tensor, which takes the stream MTTKRP.  `init`
    is a list of numpy arrays or tensors; without it the factors come
    from a generator seeded by ``opts.random_seed``.  `device` defaults
    to the card and raises where there is none.  ``opts.engine_fallback``
    (else SPLATT_ENGINE_FALLBACK) decides whether a failing MTTKRP engine
    is demoted for the next one in its chain or the error propagates.
    """
    opts = (opts or default_opts()).validate()
    dev = resolve_device(device)
    if isinstance(X, SparseTensor):
        xnormsq = X.normsq()
        dtype = resolve_dtype(opts)
    else:
        if X.device != dev:
            X = X.to(dev)
        xnormsq = X.frobsq()
        dtype = X.layouts[0].vals.dtype
    if init is not None:
        factors = [torch.as_tensor(f).to(dev, dtype).clone() for f in init]
    else:
        gen = torch.Generator().manual_seed(opts.seed())
        factors = init_factors(X.dims, rank, gen, dtype=dtype, device=dev)
    grams = [gram(U) for U in factors]
    fallback = (resilience.fallback_enabled()
                if opts.engine_fallback is None else opts.engine_fallback)
    if opts.verbosity >= Verbosity.LOW:
        if isinstance(X, BlockedSparse):
            print(f"  {describe_plan(X, factors)}")
        else:
            print(f"  engine plan: impl={dev.type} mode*=stream "
                  f"(COO oracle)")

    lam = torch.ones(rank, dtype=dtype, device=dev)
    fit_prev = 0.0
    fits: List[float] = []
    seconds: List[float] = []
    for it in range(opts.max_iterations):
        t0 = time.perf_counter()
        lam, znormsq, inner = _sweep(X, factors, grams, it == 0,
                                     opts.regularization, fallback)
        # fetching the fit waits for the sweep: the iteration's time ends here
        fitval = float(_fit(xnormsq, znormsq, inner))
        fits.append(fitval)
        seconds.append(time.perf_counter() - t0)
        if opts.verbosity >= Verbosity.LOW:
            print(f"  its = {it + 1:3d} ({seconds[-1]:.3f}s)"
                  f"  fit = {fitval:0.5f}"
                  f"  delta = {fitval - fit_prev:+0.4e}")
        converged = it > 0 and abs(fitval - fit_prev) < opts.tolerance
        fit_prev = fitval
        if converged:
            break
    return post_process(factors, lam, fit_prev, fits, seconds)
