"""The port's dense linear algebra against the JAX package's, in f64.

Tolerance 1e-10 (the repo's TOL) on well-conditioned inputs; the
pseudo-inverse case compares at 1e-8, since eigh's cut of a
rank-deficient matrix amplifies last-bit differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu.ops import linalg as jl
from splatt_tpu_torch.ops import linalg as tl
from tests.test_mttkrp import TOL
from tests.torch_fixtures import private_tune_cache  # noqa: F401


def pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(got, want, atol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_gram_and_normal_lhs():
    rng = np.random.default_rng(1)
    us = [pair(rng.random((d, 7))) for d in (9, 13, 5)]
    jg = [jl.gram(j) for j, _ in us]
    tg = [tl.gram(t) for _, t in us]
    for j, t in zip(jg, tg):
        close(t, j)
    for mode in range(3):
        for reg in (0.0, 0.25):
            close(tl.form_normal_lhs(tg, mode, reg),
                  jl.form_normal_lhs(jg, mode, reg))


@pytest.mark.parametrize("kind", ["spd", "rank_deficient"])
def test_solve_normals(kind):
    rng = np.random.default_rng(2)
    A = rng.random((20, 6))
    if kind == "rank_deficient":
        A[:, 5] = A[:, 0] + A[:, 1]   # lhs has rank 5: pinv branch
    lhs = A.T @ A
    rhs = rng.random((11, 6))
    want = np.asarray(jl.solve_normals(*map(jnp.asarray, (lhs, rhs))))
    got = tl.solve_normals(*map(torch.from_numpy, (lhs, rhs)))
    assert np.isfinite(got.numpy()).all()
    close(got, want, atol=TOL if kind == "spd" else 1e-8)


@pytest.mark.parametrize("which", ["2", "max"])
def test_normalize_columns(which):
    rng = np.random.default_rng(3)
    U = rng.random((12, 5)) * 3 - 1
    U[:, 2] = -rng.random(12)        # all negative: max-norm λ = 1
    U[:, 4] *= 0.2                    # max below 1: floored at 1
    (ju, jlam), (tu, tlam) = [f(u, which) for f, u in
                              zip((jl.normalize_columns,
                                   tl.normalize_columns), pair(U))]
    close(tu, ju)
    close(tlam, jlam)
    if which == "max":
        assert float(tlam[2]) == 1.0
