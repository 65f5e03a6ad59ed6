"""The port's graph models, reorderings and their use by the CPDs against
the JAX package's, on the CPU.

Same numpy inputs through both packages: the graphs and hypergraphs and
their files are equal; the four strategies and ``partition_to_perm`` give
identical permutations; ``Permutation`` moves numpy and torch factors in
and out of the relabeled space; ``apply_reorder`` under the
``reorder.apply`` fault degrades to identity order with its event; the
MEDIUM grid CPD with a ``relabel=`` strategy on the port's CPU mesh
matches the JAX package's (fit within 1e-8, λ and factors within 1e-6).
"""

import numpy as np
import pytest
import torch

from splatt_tpu import blocked as jb
from splatt_tpu import cpd_als as jax_cpd_als
from splatt_tpu import graph as jgraph
from splatt_tpu import reorder as jreorder
from splatt_tpu import resilience as jres
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.parallel.grid import grid_cpd_als as jax_grid
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import blocked as tb
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import graph as tgraph
from splatt_tpu_torch import reorder as treorder
from splatt_tpu_torch import resilience, state
from splatt_tpu_torch.config import Options, Verbosity
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.parallel import grid_cpd_als
from splatt_tpu_torch.utils import faults
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

FIXTURES = ["small", "med", "small4", "med4", "med5"]


@pytest.fixture(autouse=True)
def _clean():
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()


def _zipf(dims=(60, 44, 52), nnz=4000, a=1.5, seed=0):
    rng = np.random.default_rng(seed)
    inds = np.stack([(rng.zipf(a, nnz) - 1) % d for d in dims])
    return JSparse(inds, np.round(rng.random(nnz), 3) + 0.1, dims)


def _tensor(name):
    jt = _zipf() if name == "zipf" else gen.fixture_tensor(name)
    return jt, tcoo.SparseTensor(jt.inds, jt.vals, jt.dims)


# -- graphs ----------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_graphs_and_hypergraphs_match_jax(name, tmp_path):
    jt, tt = _tensor(name)
    got, want = tgraph.tensor_to_graph(tt), jgraph.tensor_to_graph(jt)
    for k in ("indptr", "adj", "vwts", "ewts"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.nvtxs, got.nedges) == (want.nvtxs, want.nedges)
    # chunked accumulation gives the same graph
    small = tgraph.tensor_to_graph(tt, chunk=7)
    np.testing.assert_array_equal(small.adj, want.adj)
    np.testing.assert_array_equal(small.ewts, want.ewts)
    hypers = [(tgraph.hypergraph_nnz(tt), jgraph.hypergraph_nnz(jt))]
    hypers += [(tgraph.hypergraph_fibers(tt, m),
                jgraph.hypergraph_fibers(jt, m)) for m in range(tt.nmodes)]
    rng = np.random.default_rng(1)
    for h, jh in hypers:
        assert (h.nvtxs, h.nhedges) == (jh.nvtxs, jh.nhedges)
        np.testing.assert_array_equal(h.eptr, jh.eptr)
        np.testing.assert_array_equal(h.eind, jh.eind)
        parts = rng.integers(0, 3, max(h.nvtxs, 1))
        np.testing.assert_array_equal(tgraph.hypergraph_uncut(h, parts),
                                      jgraph.hypergraph_uncut(jh, parts))
    tgraph.write_graph(got, str(tmp_path / "g.port"))
    jgraph.write_graph(want, str(tmp_path / "g.jax"))
    assert (tmp_path / "g.port").read_bytes() == \
        (tmp_path / "g.jax").read_bytes()
    tgraph.write_hypergraph(hypers[1][0], str(tmp_path / "h.port"))
    jgraph.write_hypergraph(hypers[1][1], str(tmp_path / "h.jax"))
    assert (tmp_path / "h.port").read_bytes() == \
        (tmp_path / "h.jax").read_bytes()


# -- permutations ------------------------------------------------------------------


@pytest.mark.parametrize("how", treorder.PERM_TYPES)
@pytest.mark.parametrize("name", FIXTURES + ["zipf"])
def test_reorder_permutations_match_jax(name, how):
    jt, tt = _tensor(name)
    for seed in (0, 5):
        got = treorder.reorder(tt, how, seed=seed)
        want = jreorder.reorder(jt, how, seed=seed)
        for g, w in zip(got.perms + got.iperms, want.perms + want.iperms):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
        # a bijection per mode, and the relabeled tensor is the JAX one
        for m, p in enumerate(got.perms):
            if p is not None:
                assert sorted(p) == list(range(tt.dims[m]))
        rel, jrel = got.apply(tt), want.apply(jt)
        np.testing.assert_array_equal(rel.inds, jrel.inds)
        np.testing.assert_array_equal(rel.vals, jrel.vals)
        back = got.undo(rel)
        np.testing.assert_array_equal(back.inds, tt.inds)


def test_partition_to_perm_matches_jax():
    rng = np.random.default_rng(3)
    for dim, nparts in ((1, 1), (17, 3), (200, 8), (64, 64)):
        parts = rng.integers(0, nparts, dim + 5)
        got = treorder.partition_to_perm(parts, dim)
        np.testing.assert_array_equal(got,
                                      jreorder.partition_to_perm(parts, dim))
        assert sorted(got) == list(range(dim))


def test_unknown_strategy_raises():
    _, tt = _tensor("small")
    with pytest.raises(ValueError, match="unknown reorder"):
        treorder.reorder(tt, "sideways")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_permutation_moves_factors_in_and_out(as_tensor):
    jt, tt = _tensor("zipf")
    perm = treorder.reorder(tt, "hgraph")
    jperm = jreorder.reorder(jt, "hgraph")
    rng = np.random.default_rng(2)
    U = [rng.random((d, 4)) for d in tt.dims]
    T = [torch.from_numpy(u) for u in U] if as_tensor else U
    fwd = [perm.permute_factor(u, m) for m, u in enumerate(T)]
    for m, f in enumerate(fwd):
        np.testing.assert_array_equal(np.asarray(f),
                                      jperm.permute_factor(U[m], m))
        np.testing.assert_array_equal(
            np.asarray(perm.apply_to_factor(f, m)), U[m])
    back = perm.undo_factors(fwd)
    for a, u in zip(back, U):
        assert isinstance(a, torch.Tensor) == as_tensor
        np.testing.assert_array_equal(np.asarray(a), u)
    assert any(not np.array_equal(np.asarray(f), u)
               for f, u in zip(fwd, U))
    ident = treorder.Permutation.identity(3)
    assert ident.permute_factor(T[0], 0) is T[0]


# -- the layout path -------------------------------------------------------------


def test_apply_reorder_fault_degrades_to_identity_as_jax():
    jt, tt = _tensor("zipf")
    with faults.inject("reorder.apply", "runtime", times=1):
        got, perm = treorder.apply_reorder(tt, "hgraph")
    with jfaults.inject("reorder.apply", "runtime", times=1):
        jgot, jperm = jreorder.apply_reorder(jt, "hgraph")
    assert got is tt and perm is None and jperm is None
    ev = [{k: v for k, v in e.items() if k != "ts"}
          for e in resilience.run_report().events("reorder_fallback")]
    jev = [{k: v for k, v in e.items() if k != "ts"}
           for e in jres.run_report().events("reorder_fallback")]
    assert ev == jev and ev[0]["how"] == "hgraph"
    assert any("degraded to identity order" in ln
               for ln in resilience.run_report().summary())
    assert treorder.apply_reorder(tt, "identity") == (tt, None)


def test_compile_under_reorder_fault_runs_identity():
    _, tt = _tensor("zipf")
    opts = Options(reorder="hgraph", fiber_packing="balanced",
                   max_iterations=3, tolerance=0.0,
                   val_dtype=torch.float64, verbosity=Verbosity.NONE)
    with faults.inject("reorder.apply", "runtime", times=1):
        bs = tb.BlockedSparse.compile(tt, opts, device="cpu")
    assert bs.reorder == "identity" and bs.perm is None
    assert all(lay.reorder == "identity" for lay in bs.layouts)
    assert resilience.run_report().events("reorder_fallback")
    out = cpd_als(bs, 3, opts, device="cpu")
    assert np.isfinite(out.fit) and len(out.fits) == 3


@pytest.mark.parametrize("how", ["identity", "hgraph"])
def test_compile_records_its_stage_seconds(how):
    _, tt = _tensor("zipf")
    opts = Options(reorder=how, fiber_packing="balanced",
                   verbosity=Verbosity.NONE)
    bs = tb.BlockedSparse.compile(tt, opts, device="cpu")
    assert sorted(bs.build_seconds) == ["pack", "reorder", "sort"]
    assert all(s >= 0.0 for s in bs.build_seconds.values())
    assert sorted(tb.BlockedSparse.from_coo(
        tt, opts, device="cpu").build_seconds) == ["pack", "sort"]


@pytest.mark.parametrize("how", ["random", "graph", "hgraph", "fibsched"])
def test_cpd_init_lands_on_the_same_relabeled_rows_as_jax(how):
    """A numpy init given to both packages moves into the relabeled space
    by the same rows: with no iteration the output is the normalized
    init, back in the original order, in both."""
    jt, tt = _tensor("med")
    rng = np.random.default_rng(4)
    init = [rng.random((d, 3)) for d in tt.dims]
    for iters in (0, 2):
        jopts = JOptions(nnz_block=128, max_iterations=iters, tolerance=0.0,
                         val_dtype=np.float64, verbosity=JVerbosity.NONE,
                         autotune=False, reorder=how)
        want = jax_cpd_als(jb.BlockedSparse.compile(jt, jopts), 3, jopts,
                           init=init)
        opts = Options(nnz_block=128, max_iterations=iters, tolerance=0.0,
                       val_dtype=torch.float64, verbosity=Verbosity.NONE,
                       reorder=how)
        bs = tb.BlockedSparse.compile(tt, opts, device="cpu")
        got = state.to_numpy(cpd_als(bs, 3, opts, init=init, device="cpu"))
        for g, w in zip(got["factors"], want.factors):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-8)
        np.testing.assert_allclose(got["lam"], np.asarray(want.lam),
                                   rtol=0, atol=1e-8)


# -- the MEDIUM grid with a relabel ------------------------------------------------


@pytest.mark.parametrize("how", ["random", "graph", "hgraph", "fibsched"])
def test_grid_relabel_matches_jax(how):
    jt, tt = _tensor("med")
    rng = np.random.default_rng(7)
    init = [rng.random((d, 4)) for d in tt.dims]
    opts = Options(max_iterations=3, tolerance=0.0, val_dtype=torch.float64,
                   verbosity=Verbosity.NONE, random_seed=1)
    jopts = JOptions(max_iterations=3, tolerance=0.0, val_dtype=np.float64,
                     verbosity=JVerbosity.NONE, random_seed=1)
    got = grid_cpd_als(tt, 4, grid=(2, 2, 2), opts=opts, init=init,
                       relabel=how, device="cpu")
    want = jax_grid(jt, 4, grid=(2, 2, 2), opts=jopts,
                    init=[np.asarray(u) for u in init], relabel=how)
    assert float(got.fit) == pytest.approx(float(want.fit), abs=1e-8)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                               atol=1e-6, rtol=0)
    for g, w in zip(got.factors, want.factors):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    # a relabel takes the place of fence balancing, as in the JAX package
    ev = resilience.run_report().events("layout_imbalance")
    assert [e["policy"] for e in ev] == ["equal"]
