"""The port's symmetric eigensolver and the solve it feeds, on the CPU.

``sym_eig_plain`` (the schedule of ``csrc/sym_eig.cu``, transcribed)
against ``torch.linalg.eigh``, and the port's ``solve_normals`` against
the JAX package's, both with ``torch.linalg.eigh`` (the CPU path) and with
the Jacobi schedule in its place (the card's arithmetic).  Only the
invariants are compared: eigenvector signs and the basis of a repeated
eigenvalue are free.  Tolerances, relative to the largest entry: w within
1e-12 (f64) and 1e-5 (f32); the pseudo-inverse operator V·diag(w_inv)·Vᵀ
and the solve within 1e-10 (f64) and 1e-4 (f32); the same SPD decision
wherever w.min is not within 1% of the cut.
"""

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from splatt_tpu.ops import linalg as jl
from splatt_tpu_torch.ops import linalg as tl
from tests.test_torch_kernels_gpu import SPECTRA, spectrum
from tests.torch_fixtures import private_tune_cache  # noqa: F401

RANKS = [1, 2, 3, 17, 50, 64]
DTYPES = {"f32": torch.float32, "f64": torch.float64}
W_TOL = {"f32": 1e-5, "f64": 1e-12}
OP_TOL = {"f32": 1e-4, "f64": 1e-10}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got - want).max()) / scale


def _pinv_op(w, v, dtype) -> np.ndarray:
    tol = torch.finfo(dtype).eps ** 0.5 * w.abs().max()
    w_inv = torch.where(w.abs() > tol, 1.0 / w, torch.zeros_like(w))
    return ((v * w_inv) @ v.T).double().numpy()


@pytest.mark.parametrize("kind", SPECTRA)
@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("dt", DTYPES)
def test_sym_eig_plain_matches_eigh(dt, R, kind):
    dtype = DTYPES[dt]
    A = torch.from_numpy(spectrum(kind, R, seed=R)).to(dtype)
    w, v, sweeps = tl.sym_eig_plain(A)
    we, ve = torch.linalg.eigh(A)
    assert w.dtype == v.dtype == dtype and v.shape == (R, R)
    assert bool((w[1:] >= w[:-1]).all())
    assert 0 <= sweeps < tl.SYM_EIG_MAX_SWEEPS
    assert _rel(w, we) <= W_TOL[dt]
    assert _rel(_pinv_op(w, v, dtype), _pinv_op(we, ve, dtype)) <= OP_TOL[dt]
    # V is orthonormal and reconstructs A
    eye = np.eye(R)
    assert np.abs(v.double().numpy().T @ v.double().numpy() - eye).max() \
        <= 100 * torch.finfo(dtype).eps * R
    assert _rel((v * w) @ v.T, A) <= 10 * W_TOL[dt]


def test_sym_eig_plain_order_and_nonfinite():
    """Every pair once per sweep in disjoint rounds; the padding of odd R;
    a non-finite matrix gives NaN, as eigh does; the sweep cap raises."""
    for n in (2, 4, 18, 64):
        seen = set()
        for k in range(n - 1):
            p, q = tl.jacobi_round(n, k)
            assert len(set(p) | set(q)) == n
            seen |= set(zip(p, q))
        assert len(seen) == n * (n - 1) // 2
    A = torch.eye(3, dtype=torch.float64)
    A[1, 2] = A[2, 1] = float("nan")
    w, v, sweeps = tl.sym_eig_plain(A)
    assert torch.isnan(w).all() and torch.isnan(v).all() and sweeps == 0
    B = torch.from_numpy(spectrum("spd", 9, seed=1))
    with pytest.raises(tl.SolverError):
        tl.sym_eig_plain(B, max_sweeps=1)
    w, v = tl.sym_eig(B)            # the wrapper takes the plain version
    assert _rel(w, torch.linalg.eigh(B)[0]) <= W_TOL["f64"]
    assert tl.sym_eig.launches == 0


def test_sym_eig_gate():
    """The static gates: the kernel's, shared memory of one CTA, f32 and
    f64 only; the solve's, the kernel's up to SYM_EIG_SOLVE_MAX_RANK."""
    assert tl.sym_eig_fits(168, torch.float32)
    assert not tl.sym_eig_fits(169, torch.float32)
    assert tl.sym_eig_fits(118, torch.float64)
    assert not tl.sym_eig_fits(119, torch.float64)
    assert not tl.sym_eig_fits(512, torch.float32)
    assert not tl.sym_eig_fits(8, torch.bfloat16)
    top = tl.SYM_EIG_SOLVE_MAX_RANK
    for dt in (torch.float32, torch.float64):
        assert tl.solve_takes_sym_eig(1, dt) and tl.solve_takes_sym_eig(top, dt)
        assert not tl.solve_takes_sym_eig(top + 1, dt)
    assert not tl.solve_takes_sym_eig(8, torch.bfloat16)
    # on the CPU the solve keeps torch.linalg.eigh whatever R
    A = torch.from_numpy(spectrum("spd", 5, seed=2))
    w, v = tl.eigh(A)
    we, ve = torch.linalg.eigh(A)
    assert torch.equal(w, we) and torch.equal(v, ve)


def _jax_spd(lhs, rhs) -> bool:
    """The JAX solve's branch (splatt_tpu/ops/linalg.py:60-84)."""
    w = jnp.linalg.eigh(lhs)[0]
    tol = jnp.sqrt(jnp.finfo(lhs.dtype).eps) * jnp.max(jnp.abs(w))
    x = jsl.cho_solve(jsl.cho_factor(lhs, lower=True), rhs.T).T
    return bool((jnp.min(w) > tol) & jnp.all(jnp.isfinite(x)))


@pytest.mark.parametrize("eig", ["eigh", "jacobi"])
@pytest.mark.parametrize("kind", SPECTRA)
@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("dt", DTYPES)
def test_solve_normals_matches_jax(dt, R, kind, eig, monkeypatch):
    """The port's solve against the JAX package's, with eigh (the CPU
    path) or the Jacobi schedule (the card's) as the eigensolver."""
    dtype = DTYPES[dt]
    if eig == "jacobi":
        monkeypatch.setattr(tl, "eigh", tl.sym_eig)
    rng = np.random.default_rng(100 + R)
    lhs = spectrum(kind, R, seed=R).astype(np.float32 if dt == "f32"
                                            else np.float64)
    rhs = rng.random((11, R)).astype(lhs.dtype)
    want = np.asarray(jl.solve_normals(jnp.asarray(lhs), jnp.asarray(rhs)))
    lt, rt = torch.from_numpy(lhs), torch.from_numpy(rhs)
    got = tl.solve_normals(lt, rt)
    assert got.dtype == dtype and np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) <= OP_TOL[dt]
    # the branch: the port adds Cholesky's info to the JAX test
    L, info = torch.linalg.cholesky_ex(lt)
    x_chol = torch.cholesky_solve(rt.T, L).T
    w, _, tol, _ = tl.pinv_parts(lt)
    spd = bool((info == 0) & (w.min() > tol) & torch.isfinite(x_chol).all())
    if kind == "nonfinite_chol" and R > 1:
        assert not bool(torch.isfinite(x_chol).all())
    if abs(float(w.min()) - float(tol)) > 0.01 * abs(float(tol)):
        assert spd == _jax_spd(jnp.asarray(lhs), jnp.asarray(rhs))
    assert spd == (kind in ("spd", "repeated")
                   or (R == 1 and kind != "rank_deficient"))
