"""The port's batched CPD (``cpd_als_batched``, ``batch_compile``,
``mttkrp_batched_stream``, the batched solve and ``sym_eig`` over a stack)
against the JAX package's and against the port's own single-tensor path,
on the CPU (≙ tests/test_batched.py).

Same numpy inputs through both packages: the stacked layouts are equal
element for element, the batched MTTKRP within 2e-5 of max|·| in f32 and
1e-12 in f64, and the f64 CPD from the same inits within 1e-10 (factors,
λ and each model's fit taken in f64 from its factors).  The JAX batched
driver keeps λ and the sweep's fit in f32 whatever the compute dtype (its
``fit_dtype``), and the port does the same, so the sweep fits themselves
agree to f32 resolution (2e-7).  Within the port: each slot equals its
own sequential ``cpd_als`` at the same seed (fit within 2e-4), frozen and
NaN-isolated neighbours are bit-identical, and ``compiles`` stays 1.
"""

import numpy as np
import pytest
import torch

from splatt_tpu import resilience as jres
from splatt_tpu import tune as jtune
from splatt_tpu.blocked import batch_compile as jax_batch_compile
from splatt_tpu.blocked import bucket_dims as jax_bucket_dims
from splatt_tpu.blocked import bucket_nnz_pad as jax_bucket_nnz_pad
from splatt_tpu.chaos import synthetic_tensor
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.cpd import cpd_als_batched as jax_cpd_als_batched
from splatt_tpu.kruskal import unstack_batched as jax_unstack_batched
from splatt_tpu.ops.mttkrp import \
    mttkrp_batched_stream as jax_mttkrp_batched_stream
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import cpd as tcpd
from splatt_tpu_torch import resilience, trace, tune
from splatt_tpu_torch.blocked import (BatchedBlocked, batch_compile,
                                      bucket_dims, bucket_nnz_pad)
from splatt_tpu_torch.config import Options, Verbosity
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.cpd import (SolverError, _health_pack_batched, cpd_als,
                                  cpd_als_batched, init_factors)
from splatt_tpu_torch.kruskal import unstack_batched
from splatt_tpu_torch.ops import linalg
from splatt_tpu_torch.ops.mttkrp import mttkrp_batched_stream, mttkrp_stream
from splatt_tpu_torch.utils import faults
from tests.torch_fixtures import private_tune_cache  # noqa: F401

DIMS = (20, 16, 12)
NNZ = 600
RANK = 4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SPLATT_HEALTH_RETRIES", raising=False)

    def reset():
        for mod in (faults, jfaults):
            mod.reset()
        for mod in (resilience, jres):
            mod.reset_demotions()
            mod.run_report().clear()

    reset()
    yield
    reset()


def _jax_tensors(k, seed0=0, dims=DIMS, nnz=NNZ):
    return [synthetic_tensor(dims, nnz, seed=seed0 + i) for i in range(k)]


def _port(tt):
    return SparseTensor(tt.inds, tt.vals, tt.dims)


def _tensors(k, seed0=0):
    return [_port(t) for t in _jax_tensors(k, seed0)]


def _opts(seed=0, iters=8, tol=0.0, **kw):
    return Options(random_seed=seed, max_iterations=iters, tolerance=tol,
                   verbosity=Verbosity.NONE, autotune=False, **kw)


def _jopts(iters=8, tol=0.0, **kw):
    return JOptions(random_seed=0, max_iterations=iters, tolerance=tol,
                    verbosity=JVerbosity.NONE, autotune=False, **kw)


def _run(tensors, opts=None, **kw):
    return cpd_als_batched(tensors, RANK, opts or _opts(), device="cpu",
                           **kw)


def _bit_equal(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a.factors, b.factors))
            and torch.equal(a.lam, b.lam))


def _dense(kt):
    """The model's dense tensor, f64."""
    f = [U.double().numpy() for U in kt.factors]
    return np.einsum("r,ir,jr,kr->ijk", kt.lam.double().numpy(), *f)


def _model_fit(tt, factors, lam):
    """1 - ‖X - Z‖/‖X‖ of one model against its COO tensor, in f64."""
    f = [np.asarray(U, dtype=np.float64) for U in factors]
    lam = np.asarray(lam, dtype=np.float64)
    had = np.outer(lam, lam)
    for U in f:
        had = had * (U.T @ U)
    rows = np.ones((tt.nnz, len(lam)))
    for m, U in enumerate(f):
        rows = rows * U[tt.inds[m]]
    inner = float(np.dot(tt.vals, rows @ lam))
    xx = float(np.dot(tt.vals, tt.vals))
    return 1.0 - np.sqrt(max(xx + had.sum() - 2 * inner, 0.0)) / np.sqrt(xx)


# -- stacking ----------------------------------------------------------------


@pytest.mark.parametrize("dims,nnz,block", [
    ((20, 16, 12), 600, 128), ((20, 16, 12), 600, 300),
    ((1000, 520, 777), 140_000, 4096), ((3, 2), 1, 128)])
def test_bucket_shapes_match_jax(dims, nnz, block):
    assert bucket_dims(dims) == jax_bucket_dims(dims)
    assert bucket_nnz_pad(nnz, block) == jax_bucket_nnz_pad(nnz, block)
    assert bucket_dims((20, 16, 12)) == (32, 32, 16)
    assert bucket_nnz_pad(600, 128) == 1024


@pytest.mark.parametrize("storage", ["f32", "f64", "bf16"])
def test_batch_compile_matches_jax(storage):
    jts = _jax_tensors(3)
    kw = {"f32": {}, "f64": {}, "bf16": {"val_storage": "bf16"}}[storage]
    jkw = dict(kw, val_dtype=np.float64 if storage == "f64" else np.float32)
    tkw = dict(kw, val_dtype=torch.float64 if storage == "f64"
               else torch.float32)
    want = jax_batch_compile(jts, _jopts(**jkw))
    got = batch_compile([_port(t) for t in jts], _opts(**tkw), device="cpu")
    assert isinstance(got, BatchedBlocked)
    np.testing.assert_array_equal(got.inds.numpy(), np.asarray(want.inds))
    assert got.inds.dtype == torch.int32
    np.testing.assert_array_equal(got.vals.double().numpy(),
                                  np.asarray(want.vals, dtype=np.float64))
    assert str(got.vals.dtype).replace("torch.", "") == \
        np.dtype(want.vals.dtype).name
    for field in ("dims", "slot_dims", "slot_nnz", "sort_mode", "block",
                  "regime", "val_storage", "k", "nmodes", "nnz_pad"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.slot_frobsq(), want.slot_frobsq())
    for i, tt in enumerate(jts):
        assert got.slot_nnz[i] == tt.nnz
    assert repr(got).replace("torch.", "") == repr(want)


@pytest.mark.parametrize("case,match", [
    ("empty", "at least one"), ("regime", "regime"), ("modes", "mode")])
def test_batch_compile_refuses_what_jax_refuses(case, match):
    if case == "empty":
        jts = []
    elif case == "regime":
        jts = _jax_tensors(2) + [synthetic_tensor((64, 50, 40), 5000, 9)]
    else:
        jts = [synthetic_tensor(DIMS, NNZ, seed=0),
               synthetic_tensor((20, 16, 12, 8), NNZ, seed=1)]
    with pytest.raises(ValueError, match=match) as want:
        jax_batch_compile(jts, _jopts())
    with pytest.raises(ValueError, match=match) as got:
        batch_compile([_port(t) for t in jts], _opts(), device="cpu")
    assert str(got.value) == str(want.value)


# -- the batched MTTKRP ------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("float64", 1e-12)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mttkrp_batched_stream_matches_jax_and_each_lane(dtype, tol, mode):
    jts = _jax_tensors(3)
    tdt = getattr(torch, dtype)
    bb = batch_compile([_port(t) for t in jts],
                       _opts(val_dtype=tdt), device="cpu")
    rng = np.random.default_rng(7)
    F = [rng.random((bb.k, d, RANK)).astype(dtype) for d in bb.dims]
    got = mttkrp_batched_stream(bb.inds, bb.vals, [torch.from_numpy(f)
                                                   for f in F],
                                mode, bb.dims[mode])
    want = np.asarray(jax_mttkrp_batched_stream(
        np.asarray(bb.inds), np.asarray(bb.vals.numpy()), F, mode,
        bb.dims[mode]))
    assert got.shape == (bb.k, bb.dims[mode], RANK) and got.dtype == tdt
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    for i in range(bb.k):
        lane = mttkrp_stream(bb.inds[i], bb.vals[i],
                             [torch.from_numpy(f[i]) for f in F], mode,
                             bb.dims[mode])
        torch.testing.assert_close(got[i], lane, rtol=0, atol=0)


def test_mttkrp_batched_stream_bf16_accumulates_f32():
    bb = batch_compile(_tensors(2), _opts(val_storage="bf16"), device="cpu")
    rng = np.random.default_rng(2)
    F = [torch.from_numpy(rng.random((bb.k, d, RANK), dtype=np.float32))
         .to(torch.bfloat16) for d in bb.dims]
    got = mttkrp_batched_stream(bb.inds, bb.vals, F, 1, bb.dims[1])
    assert got.dtype == torch.float32
    for i in range(bb.k):
        lane = mttkrp_stream(bb.inds[i], bb.vals[i], [f[i] for f in F], 1,
                             bb.dims[1])
        torch.testing.assert_close(got[i], lane, rtol=0, atol=0)


# -- the CPD against the JAX package -----------------------------------------


def test_cpd_batched_matches_jax_f64():
    jts = _jax_tensors(3)
    rng = np.random.default_rng(3)
    inits = [[rng.random((d, RANK)) for d in t.dims] for t in jts]
    want = jax_cpd_als_batched(jts, RANK, _jopts(val_dtype=np.float64),
                               inits=inits)
    got = _run([_port(t) for t in jts], _opts(val_dtype=torch.float64),
               inits=inits)
    assert got.compiles == want.compiles == 1
    assert got.statuses == want.statuses and got.rollbacks == want.rollbacks
    assert got.iterations == want.iterations
    # the sweep's fit is f32 in both drivers
    np.testing.assert_allclose(got.fits, want.fits, atol=2e-7, rtol=0)
    for tt, g, w in zip(jts, got.results, want.results):
        assert g.dims == tuple(tt.dims)             # cropped to true dims
        assert g.factors[0].dtype == torch.float64
        for a, b in zip(g.factors, w.factors):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10,
                                       rtol=0)
        np.testing.assert_allclose(g.lam.numpy(), np.asarray(w.lam),
                                   rtol=1e-10, atol=0)
        assert _model_fit(tt, [U.numpy() for U in g.factors],
                          g.lam.numpy()) == pytest.approx(
            _model_fit(tt, w.factors, w.lam), abs=1e-10)


def test_unstack_batched_matches_jax():
    rng = np.random.default_rng(5)
    dims_list = [(5, 3, 4), (7, 2, 4)]
    F = [rng.random((2, 8, RANK)) for _ in range(3)]
    lam = rng.random((2, RANK)) + 0.5
    fits = [0.25, 0.5]
    want = jax_unstack_batched(F, lam, fits, dims_list)
    got = unstack_batched([torch.from_numpy(f) for f in F],
                          torch.from_numpy(lam), fits, dims_list)
    for g, w, dims in zip(got, want, dims_list):
        assert g.dims == dims and g.fit == float(w.fit)
        for a, b in zip(g.factors, w.factors):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                       atol=0)
        np.testing.assert_allclose(g.lam.numpy(), np.asarray(w.lam),
                                   rtol=1e-14)


# -- the CPD within the port -------------------------------------------------


def test_batched_parity_with_sequential_loop():
    tensors = _tensors(4)
    seeds = [100 + i for i in range(4)]
    res = _run(tensors, seeds=seeds)
    assert res.compiles == 1 and res.k == 4
    assert res.statuses == ["converged"] * 4
    for i, tt in enumerate(tensors):
        out = cpd_als(tt, RANK, _opts(seed=seeds[i]), device="cpu")
        assert res.fits[i] == pytest.approx(out.fit, abs=2e-4)
        np.testing.assert_allclose(_dense(res.results[i]), _dense(out),
                                   atol=5e-3, rtol=1e-2)
        assert res.results[i].dims == tuple(tt.dims)


def test_batched_default_init_is_the_sequential_init():
    tensors = _tensors(2)
    bb = batch_compile(tensors, _opts(), device="cpu")
    stacked = tcpd._initial_batch(bb, RANK, [3, 9], None)
    for i, (tt, seed) in enumerate(zip(tensors, [3, 9])):
        want = init_factors(tt.dims, RANK, torch.Generator().manual_seed(seed))
        for m, U in enumerate(want):
            assert torch.equal(stacked[m][i, :tt.dims[m]], U)
            assert not stacked[m][i, tt.dims[m]:].any()


def test_batched_per_slot_convergence_freeze():
    tensors = _tensors(3)
    seeds = [31 + i for i in range(3)]
    res = _run(tensors, _opts(iters=30, tol=1e-4), seeds=seeds)
    for i, tt in enumerate(tensors):
        out = cpd_als(tt, RANK, _opts(seed=seeds[i], iters=30, tol=1e-4),
                      device="cpu")
        assert res.fits[i] == pytest.approx(out.fit, abs=2e-4)


def test_frozen_slot_is_bit_exact_while_neighbours_run():
    """A slot that converged is re-selected, never recomputed: with slot 1
    frozen before the sweep, its lanes come out bit for bit."""
    bb = batch_compile(_tensors(3), _opts(), device="cpu")
    factors = tcpd._initial_batch(bb, RANK, [1, 2, 3], None)
    grams = [linalg.gram(F) for F in factors]
    lam = torch.ones((3, RANK))
    sweep = tcpd._make_batched_sweep(bb, RANK, bb.slot_frobsq(),
                                     {"builds": 0})
    active = torch.tensor([True, False, True])
    f, g, lam2, fit, capped = sweep(factors, grams, lam, torch.zeros(3),
                                    active, True)
    for m in range(3):
        assert torch.equal(f[m][1], factors[m][1])
        assert torch.equal(g[m][1], grams[m][1])
        assert not torch.equal(f[m][0], factors[m][0])
    assert torch.equal(lam2[1], lam[1]) and not capped.any()


def test_batched_runs_are_bit_identical():
    tensors = _tensors(3)
    a = _run(tensors, seeds=[7, 8, 9])
    b = _run(tensors, seeds=[7, 8, 9])
    assert all(_bit_equal(x, y) for x, y in zip(a.results, b.results))
    assert a.fits == b.fits


def test_batched_stop_hook():
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] >= 2

    res = _run(_tensors(2), _opts(iters=20), seeds=[1, 2], stop=stop)
    assert res.stopped and res.iterations == 2


def test_batched_bf16_storage():
    tensors = _tensors(3)
    seeds = [11 + i for i in range(3)]
    res = _run(tensors, _opts(val_storage="bf16"), seeds=seeds)
    assert res.compiles == 1
    for i, kt in enumerate(res.results):
        assert all(f.dtype == torch.bfloat16 for f in kt.factors)
        assert np.isfinite(res.fits[i])
    f32 = _run(tensors, seeds=seeds)
    for a, b in zip(res.fits, f32.fits):
        assert a == pytest.approx(b, abs=0.03)


def test_batched_explicit_inits_validated():
    tensors = _tensors(2)
    inits = [[np.random.default_rng(5).random((d, RANK)) for d in t.dims]
             for t in tensors]
    res = _run(tensors, inits=inits, seeds=[5, 5])
    assert res.statuses == ["converged"] * 2
    bad = [[np.ones((8, RANK))] * 3, inits[1]]
    with pytest.raises(ValueError, match="init for slot 0 mode 0 has shape"):
        _run(tensors, inits=bad, seeds=[5, 5])
    with pytest.raises(ValueError, match="per slot"):
        _run(tensors, seeds=[1])


# -- per-slot health ---------------------------------------------------------


def test_batched_nan_slot_rolls_back_alone(monkeypatch):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "3")
    tensors = _tensors(3)
    seeds = [100 + i for i in range(3)]
    clean = _run(tensors, seeds=seeds)
    with resilience.scope("nan-batch") as sc:
        with faults.scoped("cpd.batch.sweep:nan:iter=2"):
            res = _run(tensors, seeds=seeds)
    assert res.rollbacks[0] >= 1 and res.rollbacks[1:] == [0, 0]
    assert res.statuses == ["converged"] * 3
    assert res.compiles == 1                  # the rollback rebuilt nothing
    assert all(bool(torch.isfinite(f).all())
               for f in res.results[0].factors)
    kinds = {(e["kind"], e.get("slot")) for e in sc.report.events()}
    assert ("health_nonfinite", 0) in kinds
    assert ("health_rollback", 0) in kinds
    assert not any(s not in (0, None) for _, s in kinds)
    for i in (1, 2):
        assert _bit_equal(clean.results[i], res.results[i])
        assert clean.fits[i] == res.fits[i]


def test_batched_budget_exhaustion_degrades_one_slot(monkeypatch):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "1")
    tensors = _tensors(3)
    seeds = [100 + i for i in range(3)]
    with resilience.scope("degrade-batch") as sc:
        with faults.scoped("cpd.batch.sweep:nan:*"):
            res = _run(tensors, seeds=seeds)
    assert res.statuses == ["degraded", "converged", "converged"]
    assert "health_degraded" in {e["kind"] for e in sc.report.events()}
    assert all(bool(torch.isfinite(f).all())
               for f in res.results[0].factors)
    clean = _run(tensors, seeds=seeds)
    for i in (1, 2):
        assert _bit_equal(clean.results[i], res.results[i])


def test_batched_guard_off_flows_through(monkeypatch):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "0")
    with faults.scoped("cpd.batch.sweep:nan:iter=2"):
        res = _run(_tensors(2), seeds=[1, 2])
    assert not bool(torch.isfinite(res.results[0].factors[0]).all()) \
        or not np.isfinite(res.fits[0])
    assert np.isfinite(res.fits[1])
    assert res.rollbacks == [0, 0]


@pytest.mark.parametrize("nan_slot", [False, True])
def test_batched_solver_cap_raises_only_for_a_finite_slot(monkeypatch,
                                                           nan_slot):
    """A slot whose eigensolver hit its cap raises SolverError naming it
    when its outputs are finite; a non-finite slot that hit it is the
    sentinel's, and its neighbours carry on."""
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "3")
    real = tcpd.solve_normals

    def capped_slot0(lhs, rhs, return_capped=False):
        x, capped = real(lhs, rhs, return_capped=True)
        capped = capped.clone()
        capped[0] = True
        return x, capped

    monkeypatch.setattr(tcpd, "solve_normals", capped_slot0)
    if not nan_slot:
        with pytest.raises(SolverError, match="batch slot 0"):
            _run(_tensors(2), _opts(iters=3), seeds=[1, 2])
        return
    with faults.scoped("cpd.batch.sweep:nan:iter=1"):
        # iteration 1's NaN is rolled back; from then on slot 0 is finite
        # again and its cap raises
        with pytest.raises(SolverError, match="batch slot 0"):
            _run(_tensors(2), _opts(iters=3), seeds=[1, 2])
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "1")
    with faults.scoped("cpd.batch.sweep:nan:*"):
        res = _run(_tensors(2), _opts(iters=3), seeds=[1, 2])
    assert res.statuses == ["degraded", "converged"]


def test_batched_cap_in_an_unchecked_sweep_still_raises(monkeypatch):
    """With fit_check_every=2 the first sweep is not read on its own: a
    cap slot 1 hit there is carried to the next check's pack and raises,
    though the checked sweep's own solves converge."""
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "3")
    real = tcpd.solve_normals
    calls = []

    def capped_first_sweep(lhs, rhs, return_capped=False):
        x, capped = real(lhs, rhs, return_capped=True)
        calls.append(1)
        if len(calls) <= 3:               # the first sweep's three modes
            capped = capped.clone()
            capped[1] = True
        return x, capped

    monkeypatch.setattr(tcpd, "solve_normals", capped_first_sweep)
    with pytest.raises(SolverError, match="batch slot 1"):
        _run(_tensors(2), _opts(iters=4, fit_check_every=2), seeds=[1, 2])
    assert len(calls) == 6                # raised at the first check


def test_health_pack_batched_flags_rows_apart():
    F = [torch.ones((3, 4, 2)), torch.ones((3, 5, 2))]
    F[1][2, 0, 0] = float("nan")
    lam = torch.ones((3, 2))
    fit = torch.tensor([0.5, float("inf"), 0.25])
    capped = torch.tensor([False, True, False])
    pack = _health_pack_batched(fit, capped, F, lam).numpy()
    assert pack.shape == (3, 6)
    np.testing.assert_array_equal(pack[:, 1], [0, 1, 0])
    np.testing.assert_array_equal(pack[0, 2:], [1, 1, 1, 1])
    np.testing.assert_array_equal(pack[1, 2:], [1, 1, 1, 0])
    np.testing.assert_array_equal(pack[2, 2:], [1, 0, 1, 1])
    assert _health_pack_batched(fit, capped).shape == (3, 2)


# -- the batched solve and sym_eig over a stack ------------------------------


def _normals(rng, K, R, dtype):
    A = rng.random((K, 3 * R, R))
    lhs = torch.from_numpy(np.einsum("kdr,kds->krs", A, A)).to(dtype)
    rhs = torch.from_numpy(rng.random((K, 9, R))).to(dtype)
    return lhs, rhs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_solve_equals_each_slot(dtype):
    rng = np.random.default_rng(4)
    lhs, rhs = _normals(rng, 4, 6, dtype)
    lhs[2] = torch.ones((6, 6), dtype=dtype)     # rank 1: the pinv branch
    got = linalg.solve_normals(lhs, rhs)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for i in range(4):
        want = linalg.solve_normals(lhs[i], rhs[i])
        torch.testing.assert_close(got[i], want, rtol=tol, atol=tol)
    G = linalg.gram(rhs)
    for i in range(4):
        torch.testing.assert_close(G[i], linalg.gram(rhs[i]), rtol=tol,
                                   atol=tol)
    U, lam = linalg.normalize_columns(rhs, "2")
    for i in range(4):
        Ui, li = linalg.normalize_columns(rhs[i], "2")
        torch.testing.assert_close(U[i], Ui, rtol=tol, atol=tol)
        torch.testing.assert_close(lam[i], li, rtol=tol, atol=tol)


@pytest.mark.parametrize("bad", ["nan", "inf", "zero"])
def test_batched_solve_bad_slot_leaves_neighbours_bit_identical(bad):
    rng = np.random.default_rng(8)
    lhs, rhs = _normals(rng, 3, 5, torch.float64)
    clean = linalg.solve_normals(lhs, rhs)
    lhs2 = lhs.clone()
    lhs2[1] = {"nan": float("nan"), "inf": float("inf"), "zero": 0.0}[bad]
    got, capped = linalg.solve_normals(lhs2, rhs, return_capped=True)
    assert not capped.any()
    for i in (0, 2):
        assert torch.equal(got[i], clean[i])
    if bad != "zero":
        assert not bool(torch.isfinite(got[1]).all())


def test_sym_eig_plain_over_a_batch_matches_eigh():
    rng = np.random.default_rng(6)
    lhs, _ = _normals(rng, 3, 7, torch.float64)
    lhs[1] = float("nan")
    w, v, sweeps = linalg.sym_eig_plain(lhs)
    assert w.shape == (3, 7) and v.shape == (3, 7, 7)
    assert sweeps.dtype == torch.int32 and int(sweeps[1]) == 0
    assert not bool(torch.isfinite(w[1]).any())
    for i in (0, 2):
        we, ve = torch.linalg.eigh(lhs[i])
        torch.testing.assert_close(w[i], we, rtol=0, atol=1e-12 * float(
            we.abs().max()))
        torch.testing.assert_close(v[i] @ torch.diag(w[i]) @ v[i].T, lhs[i],
                                   rtol=0, atol=1e-11 * float(
                                       lhs[i].abs().max()))
        w1, v1, s1 = linalg.sym_eig_plain(lhs[i])
        assert torch.equal(w[i], w1) and int(sweeps[i]) == s1
    # the wrapper takes a stack on the CPU through the plain version
    wb, vb = linalg.sym_eig(lhs)
    assert torch.equal(torch.nan_to_num(wb), torch.nan_to_num(w))


def test_sym_eig_plain_batch_marks_the_cap_per_slot():
    rng = np.random.default_rng(9)
    lhs, _ = _normals(rng, 2, 6, torch.float64)
    _, _, sweeps = linalg.sym_eig_plain(lhs, max_sweeps=1)
    assert sweeps.tolist() == [2, 2]
    with pytest.raises(SolverError):
        linalg.sym_eig_plain(lhs[0], max_sweeps=1)


# -- the tuner's batched plan ------------------------------------------------


def test_batched_block_for_fallbacks():
    assert tune.batched_block_for(DIMS, NNZ, 0, RANK, torch.float32, 8,
                                  device="cpu") is None
    # autotune off or no rank: None without reading the cache (whose
    # default device, the card, this host lacks)
    assert tune.batched_block_for(DIMS, NNZ, 0, RANK, torch.float32, 8,
                                  autotune=False) is None
    assert tune.batched_block_for(DIMS, NNZ, 0, None, torch.float32,
                                  8) is None
    # the plan keys are the JAX package's
    assert tune.plan_key(DIMS, NNZ, 0, RANK, torch.float32, batch=8) == \
        jtune.plan_key(DIMS, NNZ, 0, RANK, np.float32, batch=8)
    plan = {"path": "sorted_scatter", "engine": "xla", "nnz_block": 2048,
            "scan_target": 1 << 21, "sec": 0.1}
    tune._entry_store(tune.plan_key(DIMS, NNZ, 0, RANK, torch.float32),
                      {"plan": plan}, device="cpu")
    assert tune.batched_block_for(DIMS, NNZ, 0, RANK, torch.float32, 8,
                                  device="cpu") == 2048
    tune._entry_store(tune.plan_key(DIMS, NNZ, 0, RANK, torch.float32,
                                    batch=8),
                      {"plan": dict(plan, nnz_block=1024)}, device="cpu")
    assert tune.batched_block_for(DIMS, NNZ, 0, RANK, torch.float32, 8,
                                  device="cpu") == 1024
    # batch_compile takes the batched plan of its sort mode (the smallest
    # bucket mode, 2 here)
    tensors = _tensors(8)
    key_args = (tensors[0].dims, tensors[0].nnz, 2, RANK, torch.float32)
    tune._entry_store(tune.plan_key(*key_args, batch=8),
                      {"plan": dict(plan, nnz_block=256)}, device="cpu")
    bb = batch_compile(tensors, Options(autotune=True), rank=RANK,
                       device="cpu")
    assert bb.block == 256 and bb.sort_mode == 2
    assert batch_compile(tensors, Options(autotune=False), rank=RANK,
                         device="cpu").block == 640


# -- registries --------------------------------------------------------------


def test_batched_registry_entries():
    for span in ("cpd.batch", "cpd.batch.sweep", "cpd.update"):
        assert span in trace.SPANS
    for site in ("cpd.batch.sweep", "cpd.update"):
        assert site in faults.SITES


def test_batched_run_records_its_spans():
    trace.reset()
    res = cpd_als_batched(_tensors(2), RANK,
                          _opts(iters=3, trace=True), device="cpu",
                          seeds=[1, 2])
    names = [s["name"] for s in trace.spans()]
    assert names.count("cpd.batch") == 1
    assert names.count("cpd.batch.sweep") == res.iterations == 3
    trace.reset()
