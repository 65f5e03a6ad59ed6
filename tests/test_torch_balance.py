"""The port's balanced packing (docs/layout-balance.md) against the JAX
package's, on the CPU.

Same numpy inputs through both packages: the planner's cuts and every
array of a balanced layout (v1 and each v2 width) are equal; every
MTTKRP path and engine on a balanced layout matches the JAX package's
blocked MTTKRP within 1e-10 in f64 and the fixed layout's, the scatter
family bit for bit; ``compile`` + ``cpd_als`` under each packing and
reorder matches the JAX package's (fit within 1e-9, λ and factors within
1e-8, factors in the original row order); the ``layout.pack`` fault
degrades to the fixed cut with its event.
"""

import numpy as np
import pytest
import torch

from splatt_tpu import blocked as jb
from splatt_tpu import config as jconfig
from splatt_tpu import cpd_als as jax_cpd_als
from splatt_tpu import resilience as jres
from splatt_tpu.config import LayoutFormat as JFormat
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.ops.mttkrp import _engine_shape_key as jax_shape_key
from splatt_tpu.ops.mttkrp import mttkrp_blocked as jax_mttkrp_blocked
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import blocked as tb
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import config as tconfig
from splatt_tpu_torch import resilience, state
from splatt_tpu_torch.config import LayoutFormat, Options, Verbosity
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.ops import mttkrp as tm
from splatt_tpu_torch.utils import faults
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

IDX_WIDTHS = ("i32", "auto", "u16", "u8", "delta", "rle")


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
    """The JAX package's balance fixture (tests/test_balance.py:65-68)."""
    rng = np.random.default_rng(seed)
    inds = np.stack([(rng.zipf(a, nnz) - 1) % d for d in dims])
    return np.round(rng.random(nnz), 3) + 0.1, inds, dims


def _hot(nblocks_hot=3, block=128, seed=5):
    """One slice holding enough nonzeros to fill `nblocks_hot` blocks and
    more: its fiber is split over consecutive blocks."""
    rng = np.random.default_rng(seed)
    dims = (40, 30, 36)
    hot = nblocks_hot * block + block // 3
    rest = 900
    i0 = np.concatenate([np.full(hot, 7), rng.integers(0, 40, rest)])
    inds = np.stack([i0, rng.integers(0, 30, hot + rest),
                     rng.integers(0, 36, hot + rest)])
    return rng.random(hot + rest), inds, dims


def _single_fiber():
    rng = np.random.default_rng(6)
    dims = (10, 30, 40)
    inds = np.stack([np.full(900, 3), rng.integers(0, 30, 900),
                     rng.integers(0, 40, 900)])
    return rng.random(900), inds, dims


def _near_dense():
    """16 x 32 x 120, ~5000 nonzeros: modes 0 and 1 pass the dense
    verdict, mode 2 does not."""
    rng = np.random.default_rng(9)
    dims = (16, 32, 120)
    inds = np.stack([rng.integers(0, d, 6000) for d in dims])
    return tcoo.SparseTensor(inds, rng.random(6000), dims).deduplicate()


def _fixture(name):
    tt = gen.fixture_tensor(name)
    return tt.vals, tt.inds, tt.dims


CASES = {
    "zipf": lambda: _zipf(),
    "zipf_flat": lambda: _zipf(dims=(120, 90, 100), nnz=12000, a=1.2,
                               seed=3),
    "hot_split": lambda: _hot(),
    "single_fiber": _single_fiber,
    "med": lambda: _fixture("med"),
    "med4": lambda: _fixture("med4"),
    "tiny": lambda: (np.array([2.0]), np.array([[1], [2], [3]]), (4, 5, 6)),
    "empty": lambda: (np.zeros(0), np.zeros((3, 0), dtype=np.int64),
                      (4, 5, 6)),
}


def _pair(case):
    vals, inds, dims = CASES[case]()
    return (JSparse(np.asarray(inds), np.asarray(vals), dims),
            tcoo.SparseTensor(np.asarray(inds), np.asarray(vals), dims))


def _np(t):
    return np.asarray(t)


def _assert_layouts_equal(got, want):
    assert (got.mode, got.dim, got.block, got.seg_width, got.nnz,
            got.nblocks, got.packing, got.reorder,
            got.density_bucket, got.idx_width, got.encoding) == (
        want.mode, want.dim, want.block, want.seg_width, want.nnz,
        want.nblocks, want.packing, want.reorder,
        want.density_bucket, want.idx_width, want.encoding)
    assert got.format_desc() == want.format_desc()
    # the kernels read row-major streams
    streams = [got.inds] if got.base is None else list(got.inds)
    for t in streams + [got.vals, got.row_start] + list(got.base or ()):
        assert t.is_contiguous()
    if want.base is None:
        np.testing.assert_array_equal(got.inds.numpy(), _np(want.inds))
    else:
        for g, w in zip(got.inds, want.inds):
            assert g.numpy().dtype == _np(w).dtype
            np.testing.assert_array_equal(g.numpy(), _np(w))
        for g, w in zip(got.base, want.base):
            np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_array_equal(got.vals.numpy(), _np(want.vals))
    np.testing.assert_array_equal(got.row_start.numpy(),
                                  _np(want.row_start))
    if want.block_nnz is None:
        assert got.block_nnz is None
    else:
        np.testing.assert_array_equal(got.block_nnz.numpy(),
                                      _np(want.block_nnz))
    np.testing.assert_array_equal(got.real_mask(), want.real_mask())
    assert got.storage_bytes() == want.storage_bytes()


# -- the planner and the layouts ----------------------------------------------


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("case", ["zipf", "zipf_flat", "hot_split",
                                  "single_fiber", "med", "tiny", "empty"])
def test_plan_balanced_blocks_matches_jax(case, block):
    jt, _ = _pair(case)
    for mode in range(jt.nmodes):
        rows = np.sort(jt.inds[mode])
        got = tb.plan_balanced_blocks(rows, block, jt.dims[mode])
        want = jb.plan_balanced_blocks(rows, block, jt.dims[mode])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        if rows.size:
            # the balance contract: every nonzero placed once, within
            # the budget
            assert got[1].max() <= block and got[1].sum() == rows.size


def test_plan_balanced_blocks_explicit_caps_and_helpers():
    jt, _ = _pair("zipf")
    rows = np.sort(jt.inds[0])
    for caps in ([None], [8], [16, None], [4, 64]):
        got = tb.plan_balanced_blocks(rows, 256, jt.dims[0], span_caps=caps)
        want = jb.plan_balanced_blocks(rows, 256, jt.dims[0], span_caps=caps)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for counts in ([3, 0, 128], [128, 128], [1]):
        np.testing.assert_array_equal(tb.real_mask_from_counts(128, counts),
                                      jb.real_mask_from_counts(128, counts))
    for case in CASES:
        jt, _ = _pair(case)
        for m in range(jt.nmodes):
            hist = jt.mode_histogram(m)
            assert tb.nnz_skew_bucket(hist) == jb.nnz_skew_bucket(hist)


@pytest.mark.parametrize("idx", IDX_WIDTHS)
@pytest.mark.parametrize("case", ["zipf", "hot_split", "med", "med4",
                                  "tiny", "empty"])
def test_balanced_build_layout_matches_jax(case, idx):
    """Every array of a balanced layout, v1 and each v2 width (a failed
    v2 encode degrades to v1 in both packages alike)."""
    jt, tt = _pair(case)
    for mode in range(jt.nmodes):
        for packing in ("fixed", "balanced"):
            want = jb.build_layout(jt, mode, block=128,
                                   val_dtype=np.float64, packing=packing,
                                   fmt=JFormat(idx=idx), dense=False)
            got = tb.build_layout(tt, mode, block=128,
                                  val_dtype=torch.float64, packing=packing,
                                  fmt=LayoutFormat(idx=idx), dense=False,
                                  device="cpu")
            _assert_layouts_equal(got, want)
    if case == "empty":
        assert got.packing == "fixed"
    if case == "hot_split" and idx == "i32":
        lay = tb.build_layout(tt, 0, block=128, packing="balanced",
                              val_dtype=torch.float64, device="cpu")
        # the hot fiber is split over at least three consecutive blocks
        ids = lay.inds[0].reshape(lay.nblocks, lay.block).numpy()
        real = lay.real_mask()
        hot = [b for b in range(lay.nblocks) if (ids[b][real[b]] == 7).any()]
        assert len(hot) >= 3 and hot == list(range(hot[0], hot[-1] + 1))


def test_reencode_and_densify_a_balanced_layout_match_jax():
    """reencode_layout and densify_layout read the balanced pads through
    real_mask: the same streams as a direct balanced v2 build, the same
    tiles as a dense build of the tensor."""
    jt, tt = _pair("zipf")
    for mode in range(3):
        v1 = tb.build_layout(tt, mode, block=128, val_dtype=torch.float64,
                             packing="balanced", device="cpu")
        jv1 = jb.build_layout(jt, mode, block=128, val_dtype=np.float64,
                              packing="balanced")
        for idx in IDX_WIDTHS[1:]:
            got = tb.reencode_layout(v1, LayoutFormat(idx=idx))
            want = jb.reencode_layout(jv1, JFormat(idx=idx))
            _assert_layouts_equal(got, want)
            direct = tb.build_layout(tt, mode, block=128,
                                     val_dtype=torch.float64,
                                     packing="balanced",
                                     fmt=LayoutFormat(idx=idx),
                                     device="cpu")
            _assert_layouts_equal(got, direct)
    tt = _near_dense()
    for mode in range(3):
        v1 = tb.build_layout(tt, mode, block=128, val_dtype=torch.float64,
                             packing="balanced", reorder_label="hgraph",
                             device="cpu")
        dense = tb.densify_layout(v1, tt.dims)
        ref = tb.build_dense_layout(tt, mode, val_dtype=torch.float64,
                                    device="cpu")
        np.testing.assert_array_equal(dense.tiles.numpy(),
                                      ref.tiles.numpy())
        assert dense.reorder == "hgraph"


# -- MTTKRP on balanced layouts ------------------------------------------------

ENGINES = ("fused_t", "fused_tg", "fused", "unfused_pallas", "xla_scan",
           "xla")


def _factors(dims, rank=5, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.random((d, rank)) for d in dims]


def _port_layouts(tt, mode, fmt=None):
    kw = dict(block=128, val_dtype=torch.float64, device="cpu", fmt=fmt)
    return (tb.build_layout(tt, mode, packing="fixed", **kw),
            tb.build_layout(tt, mode, packing="balanced", **kw))


@pytest.mark.parametrize("path", ["sorted_onehot", "privatized", "scatter",
                                  "sorted_scatter"])
@pytest.mark.parametrize("case", ["zipf", "hot_split", "med4"])
def test_balanced_mttkrp_every_path_and_engine_matches_jax(case, path):
    jt, tt = _pair(case)
    facs = _factors(tt.dims)
    tf = [torch.from_numpy(U) for U in facs]
    jf = [np.asarray(U) for U in facs]
    lay_mode = 0
    for mode in range(tt.nmodes):
        if path in ("sorted_onehot", "sorted_scatter"):
            lay_mode = mode
        elif mode == lay_mode:
            continue
        fixed, bal = _port_layouts(tt, lay_mode)
        jbal = jb.build_layout(jt, lay_mode, block=128, val_dtype=np.float64,
                               packing="balanced", record_stats=False)
        want = np.asarray(jax_mttkrp_blocked(jbal, jf, mode, path))
        engines = (("xla",) if path in ("scatter", "sorted_scatter")
                   else ENGINES)
        for engine in engines:
            got = tm._run_engine(engine, bal, tf, mode, path).numpy()
            ref = tm._run_engine(engine, fixed, tf, mode, path).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10,
                                       err_msg=f"{engine} mode {mode}")
            if engine == "xla":
                # pads add exact zeros in the sorted order: bit for bit
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
        # and through the chain, as cpd_als calls it
        got = tm.mttkrp_blocked(bal, tf, mode, path).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("idx", IDX_WIDTHS[1:])
def test_balanced_v2_fused_v2_matches_v1(idx):
    """fused_v2 (its plain version on the CPU) reads a balanced v2
    layout's streams, RLE counts with the pads in the last row's run
    included, to the v1 balanced result."""
    jt, tt = _pair("hot_split")
    tf = [torch.from_numpy(U) for U in _factors(tt.dims)]
    for mode in range(3):
        _, v1 = _port_layouts(tt, mode)
        _, v2 = _port_layouts(tt, mode, LayoutFormat(idx=idx))
        for path in ("sorted_onehot", "privatized"):
            m = mode if path == "sorted_onehot" else (mode + 1) % 3
            want = tm._run_engine("fused_t", v1, tf, m, path).numpy()
            assert "fused_v2" in tm.engine_chain(v2, tf, m, path) or \
                v2.encoding == "v1"
            engine = "fused_v2" if v2.encoding == "v2" else "fused_t"
            got = tm._run_engine(engine, v2, tf, m, path).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_dense_path_beside_balanced_layouts_matches_fixed():
    """Under the dense policy the dense modes take their tile layouts and
    the sparse one its balanced layout; every mode's MTTKRP is the fixed
    build's."""
    tt = _near_dense()
    tf = [torch.from_numpy(U) for U in _factors(tt.dims)]
    base = dict(nnz_block=128, val_dtype=torch.float64, dense="auto",
                verbosity=Verbosity.NONE,
                block_alloc=tconfig.BlockAlloc.ALLMODE)
    fixed = tb.BlockedSparse.from_coo(tt, Options(**base), device="cpu")
    bal = tb.BlockedSparse.from_coo(
        tt, Options(fiber_packing="balanced", **base), device="cpu")
    paths = [tm._choose_path_bs(bal, m) for m in range(3)]
    assert paths == ["dense", "dense", "sorted_onehot"]
    assert bal.layout_for(2).packing == "balanced"
    for m in range(tt.nmodes):
        np.testing.assert_allclose(tm.mttkrp(bal, tf, m).numpy(),
                                   tm.mttkrp(fixed, tf, m).numpy(),
                                   rtol=0, atol=1e-10)


def test_shape_key_suffixes_scope_demotions_as_jax():
    jt, tt = _pair("med")
    facs = _factors(tt.dims)
    tf = [torch.from_numpy(U) for U in facs]
    keys, jkeys = [], []
    for packing, label in (("fixed", "identity"), ("balanced", "identity"),
                           ("balanced", "graph"), ("fixed", "hgraph")):
        lay = tb.build_layout(tt, 0, block=128, val_dtype=torch.float64,
                              packing=packing, reorder_label=label,
                              device="cpu")
        jlay = jb.build_layout(jt, 0, block=128, val_dtype=np.float64,
                               packing=packing, reorder_label=label,
                               record_stats=False)
        keys.append(tm._engine_shape_key(lay, tf, 0))
        jkeys.append(jax_shape_key(jlay, facs, 0))
    # the regime prefix differs between the packages; the suffixes agree
    assert [k[len(keys[0]):] for k in keys] == \
        [k[len(jkeys[0]):] for k in jkeys] == ["", ":bal", ":bal:ro", ":ro"]
    resilience.demote_engine("fused_t", MemoryError("out of memory"),
                             shape_key=keys[1])
    assert resilience.is_demoted("fused_t", keys[1])
    assert not resilience.is_demoted("fused_t", keys[0])


# -- events, stats and the fault -----------------------------------------------


def _events(mod, kind):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in mod.run_report().events(kind)]


@pytest.mark.parametrize("case", ["zipf", "hot_split", "med4", "tiny"])
def test_layout_imbalance_events_and_summary_match_jax(case):
    jt, tt = _pair(case)
    for packing in ("fixed", "balanced"):
        jopts = JOptions(nnz_block=128, val_dtype=np.float64,
                         verbosity=JVerbosity.NONE, autotune=False,
                         fiber_packing=packing,
                         block_alloc=jconfig.BlockAlloc.ALLMODE)
        want = jb.BlockedSparse.from_coo(jt, jopts)
        got = tb.BlockedSparse.from_coo(
            tt, Options(nnz_block=128, val_dtype=torch.float64,
                        verbosity=Verbosity.NONE, fiber_packing=packing,
                        block_alloc=tconfig.BlockAlloc.ALLMODE),
            device="cpu")
        assert _events(resilience, "layout_imbalance") == \
            _events(jres, "layout_imbalance")
        assert resilience.run_report().summary() == \
            jres.run_report().summary()
        for mod in (resilience, jres):
            mod.run_report().clear()


def test_packing_fault_degrades_to_fixed_as_jax():
    jt, tt = _pair("zipf")
    with faults.inject("layout.pack", "runtime", times=1):
        got = tb.build_layout(tt, 0, block=256, packing="balanced",
                              val_dtype=torch.float64, device="cpu")
    with jfaults.inject("layout.pack", "runtime", times=1):
        want = jb.build_layout(jt, 0, block=256, packing="balanced",
                               val_dtype=np.float64, record_stats=False)
    assert got.packing == want.packing == "fixed"
    assert got.block_nnz is None
    _assert_layouts_equal(got, want)
    ev = _events(resilience, "packing_fallback")
    assert ev == _events(jres, "packing_fallback")
    assert ev and ev[0]["failure_class"] == "unknown"
    assert any("balanced fiber pack failed" in ln
               for ln in resilience.run_report().summary())
    tf = [torch.from_numpy(U) for U in _factors(tt.dims)]
    assert torch.isfinite(tm.mttkrp_blocked(got, tf, 0,
                                            "sorted_scatter")).all()


def test_packing_and_reorder_resolution_match_jax(monkeypatch):
    for env in (None, "fixed", "balanced"):
        for field in (None, "fixed", "balanced"):
            if env is None:
                monkeypatch.delenv("SPLATT_FIBER_PACKING", raising=False)
            else:
                monkeypatch.setenv("SPLATT_FIBER_PACKING", env)
            got = Options(fiber_packing=field)
            want = JOptions(fiber_packing=field)
            assert tconfig.resolve_packing(got) == \
                jconfig.resolve_packing(want)
    for env in (None, "", "hgraph", " Random "):
        for field in (None, "identity", "graph"):
            if env is None:
                monkeypatch.delenv("SPLATT_REORDER", raising=False)
            else:
                monkeypatch.setenv("SPLATT_REORDER", env)
            assert tconfig.resolve_reorder(Options(reorder=field)) == \
                jconfig.resolve_reorder(JOptions(reorder=field))
    monkeypatch.setenv("SPLATT_FIBER_PACKING", "diagonal")
    with pytest.raises(ValueError, match="fiber_packing"):
        tconfig.resolve_packing(Options())
    with pytest.raises(ValueError, match="reorder"):
        Options(reorder="sideways").validate()


# -- the CPD under each packing and reorder ------------------------------------


@pytest.mark.parametrize("how", tconfig.REORDERS)
@pytest.mark.parametrize("packing", tconfig.PACKINGS)
def test_compile_cpd_matches_jax(packing, how):
    """compile + cpd_als from one numpy init: the fits, λ and the factors,
    in the original row order, are the JAX package's."""
    vals, inds, dims = _zipf(dims=(30, 24, 28), nnz=1500, seed=3)
    jt = JSparse(inds, vals, dims)
    tt = tcoo.SparseTensor(inds, vals, dims)
    rank, iters = 3, 3
    rng = np.random.default_rng(7)
    init = [rng.random((d, rank)) for d in dims]
    jopts = JOptions(nnz_block=128, max_iterations=iters, tolerance=0.0,
                     val_dtype=np.float64, verbosity=JVerbosity.NONE,
                     autotune=False, fiber_packing=packing, reorder=how)
    jbs = jb.BlockedSparse.compile(jt, jopts)
    want = jax_cpd_als(jbs, rank, jopts, init=init)
    opts = Options(nnz_block=128, max_iterations=iters, tolerance=0.0,
                   val_dtype=torch.float64, verbosity=Verbosity.NONE,
                   fiber_packing=packing, reorder=how)
    bs = tb.BlockedSparse.compile(tt, opts, device="cpu")
    assert bs.reorder == jbs.reorder == how
    assert (bs.perm is None) == (jbs.perm is None) == (how == "identity")
    assert [lay.packing for lay in bs.layouts] == \
        [lay.packing for lay in jbs.layouts]
    assert all(lay.reorder == how for lay in bs.layouts)
    got = state.to_numpy(cpd_als(bs, rank, opts, init=init, device="cpu"))
    assert got["fit"] == pytest.approx(float(want.fit), abs=1e-9)
    np.testing.assert_allclose(got["lam"], np.asarray(want.lam), rtol=0,
                               atol=1e-8)
    for g, w in zip(got["factors"], want.factors):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-8)
