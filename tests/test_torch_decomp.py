"""The port's MEDIUM (grid) and COARSE distributed CPDs and its blocked
per-rank engine against the JAX package's, on the CPU.

The JAX package runs on the 8 virtual CPU devices of ``tests/conftest.py``,
the port on a virtual CPU mesh of as many ranks, from one numpy init, f64:
fit within 1e-8, λ and factors within 1e-6 (``tests/test_grid.py:66-75``).
On the CPU the port's blocked engine walks the chain the card walks, with
each kernel's plain version (``fused_mttkrp_t_plain`` on a sorted mode);
the JAX package's CPU path takes ``sorted_scatter`` there, so the two
agree to the order of their sums.  Then the host arrays (equal exactly),
the blocked engine against the stream engine in the port, the policies,
the meshes, the CLI and the faults.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import resilience as jres
from splatt_tpu.config import BlockAlloc as JAlloc
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.parallel import common as jcommon
from splatt_tpu.parallel.coarse import _bucket_by_mode as jax_bucket_by_mode
from splatt_tpu.parallel.coarse import coarse_cpd_als as jax_coarse
from splatt_tpu.parallel.grid import GridDecomp as JGrid
from splatt_tpu.parallel.grid import grid_cpd_als as jax_grid
from splatt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from splatt_tpu.parallel.sharded import sharded_cpd_als as jax_sharded
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience
from splatt_tpu_torch.cli import main as cli_main
from splatt_tpu_torch.config import (BlockAlloc, CommPattern, Decomposition,
                                     Options, Verbosity)
from splatt_tpu_torch.parallel import (coarse_cpd_als, distributed_cpd_als,
                                       grid_cpd_als)
from splatt_tpu_torch.parallel import common
from splatt_tpu_torch.parallel.coarse import _bucket_by_mode
from splatt_tpu_torch.parallel.grid import GridDecomp
from splatt_tpu_torch.parallel.mesh import (GridMesh, make_grid_mesh,
                                            make_mesh)
from splatt_tpu_torch.parallel.sharded import (shard_blocked_layouts,
                                               sharded_cpd_als)
from splatt_tpu_torch.utils import faults
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

RANK = 5
ITERS = 3


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()


def _tensor(name="med"):
    tt = gen.fixture_tensor(name)
    return tt, tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


def _init(dims, rank=RANK, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.random((d, rank)) for d in dims]


def _jopts(**kw):
    return JOptions(max_iterations=kw.pop("iters", ITERS), tolerance=0.0,
                    val_dtype=np.float64, verbosity=JVerbosity.NONE,
                    random_seed=1, **kw)


def _opts(**kw):
    return Options(max_iterations=kw.pop("iters", ITERS), tolerance=0.0,
                   val_dtype=torch.float64, verbosity=Verbosity.NONE,
                   random_seed=1, **kw)


def _jinit(init):
    return [jnp.asarray(i) for i in init]


def _cpu_mesh(n=8):
    return make_mesh(n_devices=n, device="cpu")


def _assert_same(got, want, fit_tol=1e-8, tol=1e-6):
    assert float(got.fit) == pytest.approx(float(want.fit), abs=fit_tol)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                               atol=tol, rtol=0)
    assert len(got.factors) == len(want.factors)
    for g, w in zip(got.factors, want.factors):
        assert tuple(g.shape) == tuple(np.asarray(w).shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0)


# -- MEDIUM against the JAX package -----------------------------------------


@pytest.mark.parametrize("grid", [(2, 2, 2), (4, 2, 1), (8, 1, 1),
                                  (1, 1, 1)])
def test_grid_cpd_matches_jax(grid):
    jt, tt = _tensor()
    init = _init(tt.dims)
    got = grid_cpd_als(tt, RANK, grid=grid, opts=_opts(), init=init,
                       device="cpu")
    _assert_same(got, jax_grid(jt, RANK, grid=grid, opts=_jopts(),
                               init=_jinit(init)))
    ev = resilience.run_report().events("layout_imbalance")
    jev = jres.run_report().events("layout_imbalance")
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in (ev + jev)]
    assert strip[:len(ev)] == strip[len(ev):]


def test_grid_cpd_4mode_matches_jax():
    jt, tt = _tensor("med4")
    init = _init(tt.dims, rank=3)
    got = grid_cpd_als(tt, 3, grid=(2, 2, 2, 1), opts=_opts(iters=4),
                       init=init, device="cpu")
    _assert_same(got, jax_grid(jt, 3, grid=(2, 2, 2, 1),
                               opts=_jopts(iters=4), init=_jinit(init)))


def _awkward():
    """Dims not divisible by the grid (≙ tests/test_grid.py:87-97)."""
    rng = np.random.default_rng(4)
    dims = (13, 7, 9)
    jt = JSparse(np.stack([rng.integers(0, d, size=151) for d in dims]),
                 rng.random(151), dims).deduplicate()
    return jt, tcoo.SparseTensor(jt.inds, jt.vals, jt.dims)


def test_grid_awkward_dims_match_jax():
    jt, tt = _awkward()
    init = _init(tt.dims, rank=3, seed=11)
    got = grid_cpd_als(tt, 3, grid=(2, 2, 2), opts=_opts(iters=4),
                       init=init, device="cpu")
    _assert_same(got, jax_grid(jt, 3, grid=(2, 2, 2), opts=_jopts(iters=4),
                               init=_jinit(init)))


def test_grid_balanced_relabel_matches_jax():
    jt, tt = _tensor()
    init = _init(tt.dims, rank=4)
    got = grid_cpd_als(tt, 4, grid=(2, 2, 2), opts=_opts(), init=init,
                       relabel="balanced", device="cpu")
    _assert_same(got, jax_grid(jt, 4, grid=(2, 2, 2), opts=_jopts(),
                               init=_jinit(init), relabel="balanced"))
    ev = resilience.run_report().events("layout_imbalance")
    assert [(e["scope"], e["policy"]) for e in ev] == [("grid_cell",
                                                        "balanced")]


# -- COARSE and FINE (blocked) against the JAX package ----------------------


@pytest.mark.parametrize("rowdist", [None, "balanced"])
def test_coarse_cpd_matches_jax(rowdist):
    jt, tt = _tensor()
    init = _init(tt.dims)
    got = coarse_cpd_als(tt, RANK, mesh=_cpu_mesh(), opts=_opts(), init=init,
                         row_distribute=rowdist)
    want = jax_coarse(jt, RANK, mesh=jax_make_mesh(n_devices=8,
                                                   axis_names=("d",)),
                      opts=_jopts(), init=_jinit(init),
                      row_distribute=rowdist)
    _assert_same(got, want)
    ev = resilience.run_report().events("layout_imbalance")
    assert [(e["scope"], e["mode"], e["max"]) for e in ev] == [
        (e["scope"], e["mode"], e["max"])
        for e in jres.run_report().events("layout_imbalance")]


@pytest.mark.parametrize("partitioned", [False, True])
def test_sharded_blocked_matches_jax(partitioned):
    jt, tt = _tensor()
    init = _init(tt.dims)
    part = (np.random.default_rng(5).integers(0, 4, size=tt.nnz)
            if partitioned else None)
    got = sharded_cpd_als(tt, RANK, mesh=_cpu_mesh(4),
                          opts=_opts(comm_pattern=CommPattern.ALL2ALL),
                          init=init, partition=part, local_engine="blocked")
    want = jax_sharded(jt, RANK, mesh=jax_make_mesh(n_devices=4),
                       opts=_jopts(), init=_jinit(init), partition=part,
                       local_engine="blocked")
    _assert_same(got, want)


def test_empty_rank_bucket_matches_jax():
    """A rank that gets no nonzeros holds an all-padding bucket: every
    block's row_start is the sentinel, and its partials are zero."""
    jt, tt = _tensor()
    init = _init(tt.dims)
    part = np.random.default_rng(6).integers(0, 3, size=tt.nnz)
    cells = shard_blocked_layouts(tt, _cpu_mesh(4), _opts(),
                                  tuple(-(-d // 4) * 4 for d in tt.dims),
                                  dtype=torch.float64, partition=part)
    lay = cells[cells[0].sort_mode]
    assert lay.counts[3] == 0
    assert (lay.row_start[3] == lay.sort_dim).all()
    got = sharded_cpd_als(tt, RANK, mesh=_cpu_mesh(4),
                          opts=_opts(comm_pattern=CommPattern.ALL2ALL),
                          init=init, partition=part)
    want = jax_sharded(jt, RANK, mesh=jax_make_mesh(n_devices=4),
                       opts=_jopts(), init=_jinit(init), partition=part,
                       local_engine="blocked")
    _assert_same(got, want)


# -- blocked against stream in the port (≙ tests/test_decomp.py:155-183) ----


def _cpds(tt, opts, engine):
    part = np.random.default_rng(3).integers(0, 8, tt.nnz)
    mesh = _cpu_mesh()
    return {
        "grid": lambda: grid_cpd_als(tt, 4, opts=opts, local_engine=engine,
                                     device="cpu"),
        "sharded": lambda: sharded_cpd_als(tt, 4, mesh=mesh, opts=opts,
                                           local_engine=engine),
        "coarse": lambda: coarse_cpd_als(tt, 4, mesh=mesh, opts=opts,
                                         local_engine=engine),
        "fine": lambda: sharded_cpd_als(tt, 4, mesh=mesh, opts=opts,
                                        partition=part,
                                        local_engine=engine),
    }


@pytest.mark.parametrize("cpd", ["grid", "sharded", "coarse", "fine"])
@pytest.mark.parametrize("name", ["med", "med4"])
def test_blocked_engine_matches_stream(name, cpd):
    _, tt = _tensor(name)
    opts = _opts(iters=4, comm_pattern=CommPattern.ALL2ALL)
    a = _cpds(tt, opts, "stream")[cpd]()
    b = _cpds(tt, opts, "blocked")[cpd]()
    assert float(a.fit) == pytest.approx(float(b.fit), abs=1e-9)
    for ua, ub in zip(a.factors, b.factors):
        np.testing.assert_allclose(ua.numpy(), ub.numpy(), atol=1e-8)


@pytest.mark.parametrize("alloc", ["onemode", "twomode", "allmode"])
def test_blocked_engine_alloc_policies(alloc):
    """The per-rank layouts follow the alloc policy: a mode without its
    own layout runs the scatter path on the first, and each sorted mode
    runs fused_t once per rank per sweep."""
    from splatt_tpu_torch.ops import mttkrp as mk

    _, tt = _tensor()
    opts = _opts(iters=2, block_alloc=BlockAlloc(alloc),
                 comm_pattern=CommPattern.ALL2ALL)
    nsorted = len(common.alloc_build_modes(tt.dims, opts))
    calls = []
    real = mk._run_engine

    def spy(engine, layout, factors, mode, path):
        calls.append((engine, path))
        return real(engine, layout, factors, mode, path)

    mk._run_engine = spy
    try:
        for fn in (grid_cpd_als, sharded_cpd_als):
            calls.clear()
            kw = {"device": "cpu"} if fn is grid_cpd_als else {
                "mesh": _cpu_mesh()}
            b = fn(tt, 4, opts=opts, local_engine="blocked", **kw)
            # 8 ranks x 2 iterations per mode
            assert calls.count(("fused_t", "sorted_onehot")) == \
                nsorted * 8 * 2, fn.__name__
            assert calls.count(("xla", "scatter")) == \
                (tt.nmodes - nsorted) * 8 * 2
            a = fn(tt, 4, opts=opts, local_engine="stream", **kw)
            for ua, ub in zip(a.factors, b.factors):
                np.testing.assert_allclose(ua.numpy(), ub.numpy(),
                                           atol=1e-8)
    finally:
        mk._run_engine = real


def test_blocked_sweep_keeps_no_stream_copy(monkeypatch):
    """With the blocked engine no decomposition copies the stream arrays to the
    ranks."""
    from splatt_tpu_torch.parallel import grid as pgrid
    from splatt_tpu_torch.parallel import sharded as psharded

    def refuse(*a, **k):
        raise AssertionError("the stream arrays were placed")

    monkeypatch.setattr(psharded, "shard_nnz", refuse)
    monkeypatch.setattr(pgrid.GridDecomp, "device_put", refuse)
    _, tt = _tensor()
    opts = _opts(iters=1, comm_pattern=CommPattern.ALL2ALL)
    sharded_cpd_als(tt, 3, mesh=_cpu_mesh(2), opts=opts)
    grid_cpd_als(tt, 3, grid=(2, 1, 1), opts=opts, device="cpu")


# -- host arrays, equal to the JAX package's --------------------------------


def test_blocked_buckets_equal_jax():
    rng = np.random.default_rng(0)
    dims = (16, 12, 20)
    inds = np.stack([rng.integers(0, d, 300) for d in dims]).astype(np.int64)
    vals = rng.random(300)
    owner = rng.integers(0, 4, 300)
    owner[owner == 2] = 1          # bucket 2 holds only padding
    b = common.bucket_scatter(inds, vals, owner, 4, np.float64)
    jb = jcommon.bucket_scatter(inds, vals, owner, 4, np.float64)
    for x, y in zip(b, jb):
        np.testing.assert_array_equal(x, y)
    for mode in range(3):
        for block in (128, 4096):
            got = common.blocked_buckets(b[0], b[1], b[3], mode, dims[mode],
                                         block)
            want = jcommon.blocked_buckets(jb[0], jb[1], jb[3], mode,
                                           dims[mode], block)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
            assert (got[2][2] == dims[mode]).all()


@pytest.mark.parametrize("balance", [False, True])
def test_grid_decomp_and_cell_layouts_equal_jax(balance):
    jt, tt = _tensor()
    got = GridDecomp.build(tt, grid=(2, 2, 2), val_dtype=np.float64,
                           balance=balance)
    want = JGrid.build(jt, grid=(2, 2, 2), val_dtype=np.float64,
                       balance=balance)
    for f in ("grid", "dims_pad", "block_rows", "cell_nnz", "nnz", "fill"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("inds_local", "vals", "cell_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.relabels is None) == (want.relabels is None)
    for a, b in zip(got.relabels or [], want.relabels or []):
        assert (a is None and b is None) or np.array_equal(a, b)
    opts = _opts(block_alloc=BlockAlloc.ALLMODE)
    jopts = _jopts(block_alloc=JAlloc.ALLMODE)
    cl, jcl = got.build_cell_layouts(opts), want.build_cell_layouts(jopts)
    assert cl.mode_map == jcl.mode_map
    for a, b in zip(cl.layouts, jcl.layouts):
        for k in ("inds", "vals", "row_start"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("block", "seg_width", "sort_mode", "sort_dim"):
            assert a[k] == b[k]


def test_bucket_by_mode_equal_jax():
    jt, tt = _tensor("med4")
    for m in range(tt.nmodes):
        got = _bucket_by_mode(tt, m, 8, np.float64)
        want = jax_bucket_by_mode(jt, m, 8, np.float64)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def test_shard_blocked_layouts_equal_jax():
    from splatt_tpu.parallel.sharded import (
        shard_blocked_layouts as jax_layouts)

    jt, tt = _tensor()
    dims_pad = tuple(-(-d // 4) * 4 for d in tt.dims)
    cells = shard_blocked_layouts(tt, _cpu_mesh(4), _opts(), dims_pad,
                                  dtype=torch.float64)
    meta, arrays = jax_layouts(jt, jax_make_mesh(n_devices=4), _jopts(),
                               dims_pad, val_dtype=np.float64)
    for m, (lay, mm, arr) in enumerate(zip(cells, meta, arrays)):
        assert (lay.block, lay.seg_width, lay.sort_mode, lay.sort_dim) == (
            mm["block"], mm["seg_width"], mm["sort_mode"], mm["sort_dim"])
        assert lay.path == ("scatter" if mm["path"] == "scatter"
                            else "sorted_onehot")
        np.testing.assert_array_equal(
            torch.stack(lay.inds, 1).numpy(), np.asarray(arr[0]))
        np.testing.assert_array_equal(torch.stack(lay.vals).numpy(),
                                      np.asarray(arr[1]))
        np.testing.assert_array_equal(torch.stack(lay.row_start).numpy(),
                                      np.asarray(arr[2]))


# -- policies ----------------------------------------------------------------


@pytest.mark.parametrize("alloc", ["onemode", "twomode", "allmode"])
def test_alloc_build_modes_equal_jax(alloc):
    for dims in [(40, 36, 44), (30, 24, 36, 20), (5, 5, 5), (7, 3)]:
        assert common.alloc_build_modes(
            dims, _opts(block_alloc=BlockAlloc(alloc))) == \
            jcommon.alloc_build_modes(dims,
                                      _jopts(block_alloc=JAlloc(alloc)))


def test_auto_local_engine_and_bucket_engine(tmp_path):
    _, tt = _tensor()
    assert common.auto_local_engine(tt, None) == "blocked"
    mm = np.lib.format.open_memmap(str(tmp_path / "i.npy"), mode="w+",
                                   dtype=np.int64, shape=tt.inds.shape)
    mm[:] = tt.inds
    tm = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    tm.inds = mm
    assert common.auto_local_engine(tm, None) == "stream"
    assert common.auto_local_engine(tm, str(tmp_path)) == "blocked"
    assert jcommon.auto_local_engine(tm, None) == "stream"
    # memmapped buckets take the streamed counting sort, bit for bit the
    # in-memory build's layouts
    binds, bvals, _, counts = common.bucket_scatter(
        tt.inds, tt.vals, tt.inds[0] % 2, 2, np.float64)
    mb = np.lib.format.open_memmap(str(tmp_path / "b.npy"), mode="w+",
                                   dtype=np.int32, shape=binds.shape)
    mb[:] = binds
    got = common.build_bucket_layout(mb, bvals, counts, 1, tt.dims[1], 128,
                                     chunk=97)
    want = common.blocked_buckets(binds, bvals, counts, 1, tt.dims[1], 128)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]
    opts = _opts()
    assert common.bucket_engine(opts.onehot_cap, opts) == "sorted_onehot"
    assert common.bucket_engine(opts.onehot_cap + 8, opts) == \
        "sorted_scatter"


def test_comm_volume_model_grid_equals_jax():
    for grid in [(2, 2, 2), (4, 2, 1), (1, 1, 1)]:
        dims_pad = (40, 36, 44)
        assert common.comm_volume_model(dims_pad, 16, 8, grid=grid) == \
            jcommon.comm_volume_model(dims_pad, 16, 8, grid=grid)
        assert common.comm_volume_report(dims_pad, 16, 8, grid=grid) == \
            jcommon.comm_volume_report(dims_pad, 16, 8, grid=grid)


# -- meshes and dispatch -----------------------------------------------------


def test_grid_mesh_groups():
    mesh = make_grid_mesh((2, 2, 2), device="cpu")
    assert isinstance(mesh, GridMesh) and mesh.ndev == 8
    assert mesh.axis_names == ("m0", "m1", "m2")
    assert mesh.coords(5) == (1, 0, 1)
    # λ and Grams of mode 0: the ranks that differ on axis 0 only
    assert mesh.group(5, [0]) == [1, 5]
    # the layer reduce of mode 0: every axis but 0
    assert mesh.group(5, [1, 2]) == [4, 5, 6, 7]
    assert mesh.groups([1, 2]) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.line(2) == [0, 1]
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_grid_mesh((2, 2, 2), devices=["cpu"] * 4)


def test_multiaxis_mesh_rejected_for_1d_decomps():
    _, tt = _tensor("small")
    grid_mesh = make_grid_mesh((2, 2, 1), device="cpu")
    for fn in (coarse_cpd_als, sharded_cpd_als):
        with pytest.raises(ValueError, match="1-D mesh"):
            fn(tt, 2, mesh=grid_mesh, opts=_opts(iters=1))


def test_grid_adopts_a_pool_mesh_and_a_grid_mesh():
    jt, tt = _tensor()
    init = _init(tt.dims)
    want = jax_grid(jt, RANK, grid=(2, 2, 1), opts=_jopts(),
                    init=_jinit(init))
    pool = grid_cpd_als(tt, RANK, mesh=_cpu_mesh(4), opts=_opts(),
                        init=init)
    grid = grid_cpd_als(tt, RANK, mesh=make_grid_mesh((2, 2, 1),
                                                      device="cpu"),
                        opts=_opts(), init=init)
    for got in (pool, grid):
        _assert_same(got, want)


@pytest.mark.parametrize("decomp", [Decomposition.MEDIUM,
                                    Decomposition.COARSE])
def test_dispatch_medium_and_coarse(decomp):
    _, tt = _tensor()
    init = _init(tt.dims)
    opts = _opts(decomposition=decomp)
    got = distributed_cpd_als(tt, RANK, opts, init=init, grid=(
        (2, 2, 2) if decomp is Decomposition.MEDIUM else None),
        mesh=_cpu_mesh())
    want = (grid_cpd_als(tt, RANK, grid=(2, 2, 2), opts=_opts(), init=init,
                         device="cpu")
            if decomp is Decomposition.MEDIUM
            else coarse_cpd_als(tt, RANK, mesh=_cpu_mesh(), opts=_opts(),
                                init=init))
    assert got.fits == want.fits
    with pytest.raises(ValueError, match="row_distribute|COARSE"):
        distributed_cpd_als(tt, RANK, opts, mesh=_cpu_mesh(),
                            row_distribute="greedy")


def test_unported_relabels_and_memmaps_raise(tmp_path):
    # a reorder.py relabel runs now (it raised until reorder.py was
    # ported) and gives the JAX package's result; so does a memmapped
    # tensor (it raised until the streamed builds were ported), with the
    # in-memory build's arrays
    jt, tt = _tensor()
    init = _init(tt.dims, rank=3)
    got = grid_cpd_als(tt, 3, grid=(2, 1, 1), opts=_opts(iters=1),
                       init=init, relabel="random", device="cpu")
    _assert_same(got, jax_grid(jt, 3, grid=(2, 1, 1), opts=_jopts(iters=1),
                               init=_jinit(init), relabel="random"))
    mm = np.lib.format.open_memmap(str(tmp_path / "i.npy"), mode="w+",
                                   dtype=np.int64, shape=tt.inds.shape)
    mm[:] = tt.inds
    tm = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    tm.inds = mm
    got, want = (GridDecomp.build(tm, grid=(2, 1, 1)),
                 GridDecomp.build(tt, grid=(2, 1, 1)))
    np.testing.assert_array_equal(got.inds_local, want.inds_local)
    np.testing.assert_array_equal(got.vals, want.vals)
    np.testing.assert_array_equal(got.cell_counts, want.cell_counts)
    for a, b in zip(_bucket_by_mode(tm, 0, 2, np.float64),
                    _bucket_by_mode(tt, 0, 2, np.float64)):
        np.testing.assert_array_equal(a, b)


# -- faults ------------------------------------------------------------------


def test_fused_t_fault_demotes_or_raises_in_every_rank():
    """An armed engine.fused_t fault demotes fused_t for the rest of the
    run with fallback on (the fits unchanged), and raises with it off."""
    _, tt = _tensor()
    init = _init(tt.dims)
    clean = grid_cpd_als(tt, RANK, grid=(2, 2, 1), opts=_opts(), init=init,
                         device="cpu")
    with faults.inject("engine.fused_t", "runtime", times=1):
        got = grid_cpd_als(tt, RANK, grid=(2, 2, 1),
                           opts=_opts(engine_fallback=True), init=init,
                           device="cpu")
    assert [d.engine for d in resilience.demotions()] == ["fused_t"]
    np.testing.assert_allclose(got.fits, clean.fits, atol=1e-12)
    resilience.reset_demotions()
    with faults.inject("engine.fused_t", "runtime", times=1):
        with pytest.raises(Exception, match="injected"):
            grid_cpd_als(tt, RANK, grid=(2, 2, 1),
                         opts=_opts(engine_fallback=False), init=init,
                         device="cpu")


# -- the CLI -----------------------------------------------------------------


def test_cli_medium_grid_and_coarse(tensors_dir, tmp_path, capsys):
    med = str(tensors_dir / "med.tns")
    for extra, line in (
            (["--decomp", "medium", "--grid", "2x2x2"],
             "DISTRIBUTED decomp=medium devices=8 grid=2x2x2"),
            (["--grid", "4x2x1"],
             "DISTRIBUTED decomp=medium devices=8 grid=4x2x1"),
            (["--decomp", "coarse", "--local-engine", "stream"],
             "DISTRIBUTED decomp=coarse devices=8")):
        out = tmp_path / "o"
        resilience.run_report().clear()
        assert cli_main(["cpd", med, "-r", "4", "-i", "3", "--seed", "3",
                         "--device", "cpu", "--json", "-o", str(out)]
                        + extra) == 0
        text = capsys.readouterr().out
        assert line in text and text.count("fit = ") == 3
        rec = json.loads(text.strip().splitlines()[-1])
        scopes = {e["scope"] for e in rec["events"]
                  if e["kind"] == "layout_imbalance"}
        assert scopes == {"grid_cell" if "medium" in line
                          else "coarse_bucket"}
        assert np.isfinite(rec["fit"]) and (out / "mode3.mat").exists()


def test_cli_grid_errors(tensors_dir):
    med = str(tensors_dir / "med.tns")
    for extra, match in ((["--decomp", "coarse", "--grid", "2x2x2"],
                          "medium decomposition only"),
                         (["--grid", "2x2"], "one positive factor"),
                         (["--grid", "2x0x2"], "one positive factor"),
                         (["--grid", "2xax2"], "one positive factor"),
                         (["--grid", "2x2x2", "--ndev", "4"],
                          "needs 8 devices")):
        with pytest.raises(ValueError, match=match):
            cli_main(["cpd", med, "-r", "2", "-i", "1", "--device", "cpu"]
                     + extra)
