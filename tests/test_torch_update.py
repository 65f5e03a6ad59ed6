"""The port's warm-update pre-pass (``touched_rows``,
``refresh_touched_rows``) against the JAX package's, and the warm path it
starts, on the CPU (≙ the function-level half of tests/test_update.py).

Same numpy model and delta through both packages, f64: the refreshed
factors agree within 1e-10, untouched rows are the input's bit for bit,
and the ``cpd.update`` fault site raises.  The warm path (refresh, then
``cpd_als`` with ``init=``) reaches a fit within 1e-3 of a from-scratch
refit of the merged tensor in a quarter of its sweeps (docs/batched.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import serve as jserve
from splatt_tpu.blocked import BlockedSparse as JBlocked
from splatt_tpu.chaos import synthetic_tensor
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.cpd import refresh_touched_rows as jax_refresh_touched_rows
from splatt_tpu.cpd import touched_rows as jax_touched_rows
from splatt_tpu_torch import resilience, trace
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import Options, Verbosity
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.cpd import cpd_als, refresh_touched_rows, touched_rows
from splatt_tpu_torch.utils import faults
from tests.torch_fixtures import private_tune_cache  # noqa: F401

DIMS = (20, 16, 12)
ITERS = 20          # the base and refit budget
UP_SWEEPS = 5       # <= 25% of ITERS


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    resilience.reset_demotions()
    resilience.run_report().clear()
    yield
    faults.reset()


def _port(tt):
    return SparseTensor(tt.inds, tt.vals, tt.dims)


def _opts(iters=6, seed=0, **kw):
    return Options(random_seed=seed, max_iterations=iters, autotune=False,
                   verbosity=Verbosity.NONE, **kw)


def _merged(tt, delta):
    """The model tensor with a delta appended, repeated coordinates
    summed."""
    return SparseTensor(np.concatenate([tt.inds, delta.inds], axis=1),
                        np.concatenate([tt.vals, delta.vals]),
                        tt.dims).deduplicate()


def test_touched_rows_matches_jax():
    delta = synthetic_tensor(DIMS, 30, seed=1)
    want = jax_touched_rows(delta, 3)
    got = touched_rows(_port(delta), 3)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for m in range(3):
        np.testing.assert_array_equal(got[m], want[m])
        np.testing.assert_array_equal(got[m], np.unique(delta.inds[m]))


@pytest.mark.parametrize("blocked", [True, False])
def test_refresh_touched_rows_matches_jax(blocked):
    tt = synthetic_tensor(DIMS, 400, seed=0)
    delta = synthetic_tensor(DIMS, 30, seed=1)
    merged = jserve._merge_delta(tt, delta)
    rng = np.random.default_rng(4)
    model = [rng.random((d, 3)) for d in DIMS]
    touched = jax_touched_rows(delta, 3)
    jopts = JOptions(val_dtype=np.float64, autotune=False,
                     verbosity=JVerbosity.NONE)
    opts = _opts(val_dtype=torch.float64)
    if blocked:
        jX = JBlocked.from_coo(merged, jopts)
        X = BlockedSparse.from_coo(_port(merged), opts, device="cpu")
    else:
        jX, X = merged, _port(merged)
    want = jax_refresh_touched_rows(jX, [jnp.asarray(U) for U in model],
                                    touched, reg=1e-3)
    got = refresh_touched_rows(X, model, touched, reg=1e-3)
    for m in range(3):
        assert got[m].dtype == torch.float64
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]),
                                   atol=1e-10, rtol=0)
        untouched = np.setdiff1d(np.arange(DIMS[m]), touched[m])
        np.testing.assert_array_equal(got[m].numpy()[untouched],
                                      model[m][untouched])
        assert not np.array_equal(got[m].numpy()[touched[m]],
                                  model[m][touched[m]])


def test_refresh_keeps_untouched_rows_of_a_converged_model():
    tt = _port(synthetic_tensor(DIMS, 400, seed=0))
    delta = _port(synthetic_tensor(DIMS, 30, seed=1))
    out = cpd_als(tt, 3, _opts(), device="cpu")
    touched = touched_rows(delta, 3)
    bs = BlockedSparse.from_coo(_merged(tt, delta), _opts(), device="cpu")
    warm = refresh_touched_rows(bs, out.factors, touched)
    for m in range(3):
        untouched = np.setdiff1d(np.arange(DIMS[m]), touched[m])
        assert torch.equal(warm[m][untouched], out.factors[m][untouched])
        assert warm[m].dtype == out.factors[m].dtype
        assert not torch.equal(warm[m][touched[m]],
                               out.factors[m][touched[m]])


@pytest.mark.parametrize("blocked", [True, False])
def test_refresh_rows_fault_site_raises(blocked):
    tt = _port(synthetic_tensor(DIMS, 200, seed=0))
    delta = _port(synthetic_tensor(DIMS, 10, seed=1))
    out = cpd_als(tt, 3, _opts(iters=2), device="cpu")
    X = BlockedSparse.from_coo(tt, _opts(), device="cpu") if blocked else tt
    with faults.inject("cpd.update", "runtime"):
        with pytest.raises(RuntimeError, match="injected"):
            refresh_touched_rows(X, out.factors, touched_rows(delta, 3))


def test_refresh_raises_when_its_solve_hits_the_cap(monkeypatch):
    """A refresh solve that hit the eigensolver's sweep cap raises at the
    end of the refresh, not in whatever runs next."""
    from splatt_tpu_torch import cpd as tcpd
    from splatt_tpu_torch.ops.linalg import SolverError

    real = tcpd.solve_normals

    def capped(lhs, rhs, return_capped=False):
        x, cap = real(lhs, rhs, return_capped=True)
        return (x, torch.ones_like(cap)) if return_capped else x

    tt = _port(synthetic_tensor(DIMS, 200, seed=0))
    factors = [torch.rand((d, 3), dtype=torch.float64) for d in DIMS]
    monkeypatch.setattr(tcpd, "solve_normals", capped)
    with pytest.raises(SolverError, match="refresh solve"):
        refresh_touched_rows(tt, factors, {0: np.array([1])})


def test_refresh_refuses_a_reordered_layout():
    tt = _port(synthetic_tensor(DIMS, 200, seed=0))
    bs = BlockedSparse.compile(tt, _opts(reorder="random"), device="cpu")
    assert bs.perm is not None
    factors = [torch.rand((d, 3)) for d in DIMS]
    with pytest.raises(ValueError, match="original row order"):
        refresh_touched_rows(bs, factors, {0: np.array([1])})


def test_refresh_records_its_span():
    tt = _port(synthetic_tensor(DIMS, 200, seed=0))
    factors = [torch.rand((d, 3), dtype=torch.float64) for d in DIMS]
    trace.reset()
    with trace.enabling(True):
        refresh_touched_rows(tt, factors, {0: np.array([1, 4]),
                                           2: np.array([3])})
    spans = [s for s in trace.spans() if s["name"] == "cpd.update"]
    assert len(spans) == 1 and spans[0]["args"]["rows"] == 3
    trace.reset()


def test_warm_update_reaches_refit_fit_in_a_quarter_of_the_sweeps():
    """The update acceptance of docs/batched.md on the port's own path:
    base model, delta, touched-row refresh, UP_SWEEPS warm sweeps on the
    merged tensor, against a from-scratch refit with ITERS."""
    assert UP_SWEEPS <= ITERS // 4
    tt = _port(synthetic_tensor(DIMS, 900, seed=3))
    delta = _port(synthetic_tensor(DIMS, 60, seed=42))
    merged = _merged(tt, delta)
    base = cpd_als(tt, 3, _opts(iters=ITERS, seed=7, tolerance=1e-5),
                   device="cpu")
    bs = BlockedSparse.from_coo(merged, _opts(), device="cpu")
    warm = refresh_touched_rows(bs, base.factors, touched_rows(delta, 3))
    up = cpd_als(bs, 3, _opts(iters=UP_SWEEPS, tolerance=1e-5), init=warm,
                 device="cpu")
    refit = cpd_als(merged, 3, _opts(iters=ITERS, seed=7, tolerance=1e-5),
                    device="cpu")
    assert len(up.fits) <= UP_SWEEPS
    assert abs(up.fit - refit.fit) < 1e-3
