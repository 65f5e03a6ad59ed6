"""The port's dense-mode tile layouts and hybrid per-mode dispatch against
the JAX package, from the same numpy inputs.

- Geometry, densities, buckets and verdicts are equal.
- ``build_dense_layout`` tiles and masks are equal (f32 and bf16, with
  duplicates accumulating in the same order); ``densify_layout`` equals a
  direct build.
- ``fused_dense_plain`` and ``dense_mttkrp`` match the JAX kernel in
  interpret mode and the JAX ``dense_mttkrp``: f64 within 1e-10 of
  max|ref| (the same products summed by two matmul libraries); bf16
  within tests/test_dense.py:259's rtol 2e-2, atol 2e-1.
- ``from_coo`` gives JAX's mode map and layout kinds under each policy,
  including a hybrid mix and the ``format.dense`` degrade.
- The hybrid ``cpd_als`` matches splatt_tpu.cpd_als (f64, plain XLA
  engines, 3 iterations): fit within 1e-9, λ and factors within 1e-8, as
  tests/test_torch_cpd.py holds the sparse path.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import blocked as jb
from splatt_tpu import cpd_als as jax_cpd_als
from splatt_tpu.config import BlockAlloc as JAlloc
from splatt_tpu.config import DENSE_POLICIES as JPOLICIES
from splatt_tpu.config import DENSE_THRESHOLD_DEFAULT as JTHRESHOLD
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.io import save as jsave
from splatt_tpu.ops.mttkrp import dense_mttkrp as jdense_mttkrp
from splatt_tpu.ops.pallas_kernels import fused_dense as jfused_dense
from splatt_tpu.utils import faults as jfaults
from splatt_tpu.utils.env import ENV_VARS as JENV
from splatt_tpu_torch import blocked as tb
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience, state
from splatt_tpu_torch.config import (DENSE_POLICIES, DENSE_THRESHOLD_DEFAULT,
                                     BlockAlloc, LayoutFormat, Options,
                                     Verbosity, resolve_dense,
                                     resolve_dense_threshold)
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.ops import kernels
from splatt_tpu_torch.ops import mttkrp as tm
from splatt_tpu_torch.utils import faults
from splatt_tpu_torch.utils.env import ENV_VARS
from tests.torch_fixtures import private_tune_cache  # noqa: F401

#: 3- and 4-mode dims, an inner dim that is no multiple of 128, a mode
#: above the 256-row tile (several row tiles)
GEOMETRY_DIMS = [(16, 32, 32), (12, 20, 20), (16, 32, 120), (5, 6, 7, 9),
                 (300, 12, 130), (3,), (4, 0, 5)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SPLATT_FAULTS", "SPLATT_DENSE", "SPLATT_DENSE_THRESHOLD",
                 "SPLATT_IDX_WIDTH", "SPLATT_VAL_STORAGE",
                 "SPLATT_ENGINE_FALLBACK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(resilience.time, "sleep", lambda s: None)

    def clear():
        faults.reset()
        jfaults.reset()
        resilience.reset_demotions()
        resilience.run_report().clear()
        tm._DENSE_NOTED.clear()

    clear()
    yield
    clear()


def _tensor(dims=(16, 32, 32), nnz=4000, seed=3, dups=0):
    """Unique random coordinates (tests/test_dense.py's dense-ish
    tensor), plus `dups` repeats of existing ones."""
    rng = np.random.default_rng(seed)
    lin = rng.choice(int(np.prod(dims)), size=nnz, replace=False)
    if dups:
        lin = np.concatenate([lin, rng.choice(lin, size=dups)])
    inds = np.stack(np.unravel_index(lin, dims)).astype(np.int64)
    return JSparse(inds, rng.random(lin.size) + 0.1, dims)


def port_tensor(tt):
    return tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


def _numpy(t):
    return state.to_numpy(t)


def assert_same_dense(got, want):
    assert got.encoding == want.encoding == "dense"
    assert (got.mode, got.dims, got.nnz, got.val_storage) == \
        (want.mode, tuple(want.dims), want.nnz, want.val_storage)
    assert (got.tile, got.ntiles, got.span, got.block) == \
        (want.tile, want.ntiles, want.span, want.block)
    assert got.idx_width == want.idx_width == "dense"
    assert got.packing == want.packing and got.skew == want.skew
    assert got.density_bucket == want.density_bucket
    assert got.density() == want.density()
    assert got.index_bytes() == want.index_bytes() == 0
    assert got.value_bytes() == want.value_bytes()
    assert got.storage_bytes() == want.storage_bytes()
    assert got.format_desc() == want.format_desc()
    assert repr(got) == repr(want)
    assert got.geometry == tuple(want.geometry)
    g, w = _numpy(got.tiles), np.asarray(want.tiles).astype(np.float32)
    assert g.shape == w.shape and g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(_numpy(got.mask), np.asarray(want.mask))


def _factors(dims, rank, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    f = [rng.random((d, rank)) for d in dims]
    if dtype == "bf16":
        return ([jnp.asarray(U, dtype=jnp.bfloat16) for U in f],
                [torch.from_numpy(U).to(torch.bfloat16) for U in f])
    return ([jnp.asarray(U.astype(dtype)) for U in f],
            [torch.from_numpy(U.astype(dtype)) for U in f])


# -- geometry, density, bucket, verdict --------------------------------------


@pytest.mark.parametrize("dims", GEOMETRY_DIMS)
def test_geometry_density_bucket_verdict_equal(dims):
    cells = 1
    for d in dims:
        cells *= max(d, 1)
    for mode in range(len(dims)):
        geo = tb.dense_tile_geometry(dims, mode)
        want = jb.dense_tile_geometry(dims, mode)
        assert (geo is None) == (want is None)
        if geo is not None:
            assert tuple(geo) == tuple(want)
            assert geo.span % 128 == 0 and geo.tile % 8 == 0
            assert geo.ntiles * geo.tile >= dims[mode]
        nnzs = [0, 1, 10, cells // 64, cells // 20, cells // 3, cells]
        if geo is not None:
            # on both sides of the blowup cap
            nnzs += [geo.cells // tb.DENSE_BLOWUP_CAP,
                     geo.cells // tb.DENSE_BLOWUP_CAP + 1]
        for nnz in nnzs:
            assert tb.mode_density(dims, mode, nnz) == \
                jb.mode_density(dims, mode, nnz)
            assert tb.padded_mode_density(dims, mode, nnz) == \
                jb.padded_mode_density(dims, mode, nnz)
            assert tb.mode_density_bucket(dims, mode, nnz) == \
                jb.mode_density_bucket(dims, mode, nnz)
            for thr in (1e-9, 0.05, 0.5, 1.0):
                for force in (False, True):
                    assert tb.dense_mode_verdict(dims, mode, nnz, thr,
                                                 force=force) == \
                        jb.dense_mode_verdict(dims, mode, nnz, thr,
                                              force=force), \
                        (dims, mode, nnz, thr, force)
    assert tb.DENSE_BLOWUP_CAP == jb.DENSE_BLOWUP_CAP


# -- layouts -----------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", ["3mode", "pad", "4mode", "rowtiles",
                                  "duplicates"])
def test_build_dense_layout_equal(case, bf16):
    tt = {"3mode": lambda: _tensor(),
          "pad": lambda: _tensor((12, 20, 20), 700),
          "4mode": lambda: _tensor((5, 6, 7, 9), 1200),
          "rowtiles": lambda: _tensor((300, 8, 128), 100000),
          "duplicates": lambda: _tensor(dups=1500)}[case]()
    jdt = jnp.bfloat16 if bf16 else np.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    for mode in range(tt.nmodes):
        want = jb.build_dense_layout(tt, mode, val_dtype=jdt)
        got = tb.build_dense_layout(port_tensor(tt), mode, val_dtype=tdt,
                                    device="cpu")
        assert got.tiles.dtype == tdt
        assert_same_dense(got, want)
        # the numpy hand-over carries a JAX dense layout as it is
        assert_same_dense(state.dense_layout_from_numpy(
            np.asarray(want.tiles), np.asarray(want.mask), mode=want.mode,
            dims=want.dims, nnz=want.nnz, val_storage=want.val_storage,
            device="cpu"), want)
    if case == "duplicates":
        lay = tb.build_dense_layout(port_tensor(tt), 0, device="cpu",
                                    val_dtype=torch.float64)
        assert float(lay.tiles.sum()) == pytest.approx(tt.vals.sum(),
                                                       rel=1e-12)


def test_build_dense_layout_refuses_past_the_cap():
    tt = _tensor()
    tiny = port_tensor(JSparse(tt.inds[:, :10], tt.vals[:10], tt.dims))
    with pytest.raises(ValueError, match="blowup"):
        tb.build_dense_layout(tiny, 0, device="cpu")
    with pytest.raises(ValueError, match="dense-tiled"):
        tb.build_dense_layout(tcoo.SparseTensor(np.zeros((1, 3), np.int64),
                                                np.ones(3), (4,)), 0,
                              device="cpu")


@pytest.mark.parametrize("bf16", [False, True])
def test_densify_equals_direct_build(bf16):
    tt = _tensor((16, 32, 120), 4000)
    X = port_tensor(tt)
    tdt = torch.bfloat16 if bf16 else torch.float32
    for mode in range(tt.nmodes):
        sparse = tb.build_layout(X, mode, block=512, val_dtype=tdt,
                                 device="cpu", dense=False)
        got = tb.densify_layout(sparse, tt.dims)
        want = tb.build_dense_layout(X, mode, val_dtype=tdt, device="cpu")
        assert got.tiles.dtype == tdt
        assert torch.equal(got.tiles, want.tiles)
        assert torch.equal(got.mask, want.mask)
        # the JAX package's densify gives the same tiles
        jsparse = jb.build_layout(tt, mode, block=512, val_dtype=np.float32,
                                  dense=False)
        jwant = jb.densify_layout(jsparse, tt.dims)
        if not bf16:
            assert_same_dense(got, jwant)
        # reencode_layout's dense branch is densify_layout
        again = tb.reencode_layout(sparse, LayoutFormat(), dense=True,
                                   dims=tt.dims)
        assert torch.equal(again.tiles, want.tiles)


def test_dense_layout_to_numpy_round_trips():
    lay = tb.build_dense_layout(port_tensor(_tensor()), 1, device="cpu",
                                val_dtype=torch.bfloat16)
    fields = state.to_numpy(lay)
    back = state.dense_layout_from_numpy(
        fields["tiles"], fields["mask"], mode=fields["mode"],
        dims=fields["dims"], nnz=fields["nnz"],
        val_storage=fields["val_storage"], device="cpu")
    assert back.tiles.dtype == torch.bfloat16
    assert torch.equal(back.tiles, lay.tiles)
    assert torch.equal(back.mask, lay.mask)
    assert repr(back) == repr(lay) and back.to("cpu").dims == lay.dims
    with pytest.raises(ValueError, match="disagree"):
        state.dense_layout_from_numpy(fields["tiles"], fields["mask"][:-1],
                                      mode=1, dims=lay.dims, nnz=lay.nnz,
                                      device="cpu")


# -- the plain version and the reference engine ------------------------------


@pytest.mark.parametrize("dtype", [np.float64, "bf16"])
@pytest.mark.parametrize("dims,nnz", [((16, 32, 120), 4000),
                                      ((5, 6, 7, 9), 1200),
                                      ((300, 8, 128), 100000)])
def test_plain_and_reference_match_jax(dims, nnz, dtype):
    tt = _tensor(dims, nnz)
    X = port_tensor(tt)
    bf16 = dtype == "bf16"
    jf, tf = _factors(dims, 7, 5, dtype)
    for mode in range(tt.nmodes):
        jlay = jb.build_dense_layout(
            tt, mode, val_dtype=jnp.bfloat16 if bf16 else np.float64)
        lay = tb.build_dense_layout(
            X, mode, device="cpu",
            val_dtype=torch.bfloat16 if bf16 else torch.float64)
        kern = np.asarray(jfused_dense(jlay, jf, mode, interpret=True),
                          dtype=np.float64)
        ref = np.asarray(jdense_mttkrp(jlay, jf, mode), dtype=np.float64)
        got_plain = kernels.fused_dense_plain(lay, tf, mode)
        got_ref = tm.dense_mttkrp(lay, tf, mode)
        assert got_plain.dtype == (torch.float32 if bf16 else torch.float64)
        assert got_plain.shape == (dims[mode], 7)
        # on a CPU tensor the wrapper is its plain version
        assert torch.equal(kernels.fused_dense(lay, tf, mode), got_plain)
        for got in (got_plain, got_ref):
            for want in (kern, ref):
                got_np = got.double().numpy()
                if bf16:
                    np.testing.assert_allclose(got_np, want, rtol=2e-2,
                                               atol=2e-1)
                else:
                    np.testing.assert_allclose(
                        got_np, want, rtol=0,
                        atol=1e-10 * np.abs(want).max())


def test_dense_against_the_sparse_oracle():
    """Every mode's dense MTTKRP equals the COO stream oracle, duplicates
    included (f64, 1e-10 of max|oracle|)."""
    tt = _tensor(dups=800)
    X = port_tensor(tt)
    _, tf = _factors(tt.dims, 5, 2)
    inds = torch.from_numpy(tt.inds)
    vals = torch.from_numpy(tt.vals)
    for mode in range(tt.nmodes):
        lay = tb.build_dense_layout(X, mode, device="cpu",
                                    val_dtype=torch.float64)
        want = tm.mttkrp_stream(inds, vals, tf, mode, tt.dims[mode])
        got = tm.mttkrp_blocked(lay, tf, mode)
        assert float((got - want).abs().max()) <= \
            1e-10 * float(want.abs().max())


def test_operands_and_operand_contract():
    tt = _tensor((5, 6, 7, 9), 1200)
    lay = tb.build_dense_layout(port_tensor(tt), 1, device="cpu")
    _, tf = _factors(tt.dims, 3, 1, np.float32)
    w, u = tm.dense_operands(lay, tf, 1)
    # w: modes 0 and 2 chained (5 * 7 rows), u: mode 3 padded to 128
    assert w.shape == (35, 3) and u.shape == (128, 3)
    assert torch.equal(w[8], tf[0][1] * tf[2][1])
    assert not u[9:].any()
    kernels.check_operands(lay, tf, 1)
    with pytest.raises(ValueError, match="own mode"):
        kernels.check_operands(lay, tf, 0)
    with pytest.raises(ValueError, match=r"factors\[2\]"):
        kernels.check_operands(lay, tf[:2] + [tf[2][:-1]] + tf[3:], 1)
    with pytest.raises(ValueError, match="mask"):
        kernels.check_operands(tb.DenseModeLayout(
            **{**lay.__dict__, "mask": lay.mask[:-1]}), tf, 1)
    with pytest.raises(TypeError, match="values"):
        kernels.check_operands(tb.DenseModeLayout(
            **{**lay.__dict__, "tiles": lay.tiles.int()}), tf, 1)
    with pytest.raises(ValueError, match="own mode"):
        kernels.fused_dense_plain(lay, tf, 2)


def _covered_once(t, span, inner_pad):
    """Every chunk of the span in exactly one split's schedule; the
    splits' lengths within one u block's o range of each other."""
    lists = [kernels.dense_split_chunks(t, span, inner_pad, s)
             for s in range(t.splits)]
    got = sorted(c for chunks in lists for c in chunks)
    assert got == list(range(span // t.chunk))
    return [len(chunks) for chunks in lists]


def test_dense_grid_fills_the_card():
    """The split of the span: the phase-10 modes of chip_smoke.py on 132
    SMs, every chunk covered once, about one CTA per SM, each split the
    same number of chunks."""
    for rows, span, inner_pad, R in [(96, 2_097_152, 2048, 50),
                                     (1024, 196_608, 2048, 50),
                                     (2048, 98_304, 1024, 50),
                                     (8, 128, 128, 3),
                                     (40_000, 128, 128, 300)]:
        t = kernels.dense_tiling(rows, span, inner_pad, R, 132)
        assert t.row_blocks == -(-rows // kernels.DENSE_ROWS)
        lengths = _covered_once(t, span, inner_pad)
        ctas = t.row_blocks * t.splits * t.rank_tiles
        assert ctas >= min(0.9 * 132, t.row_blocks * t.rank_tiles
                           * span // t.chunk)
        if rows <= 2048:
            assert max(lengths) == min(lengths)
        assert t.row_blocks * t.splits < 2**31


#: (span, inner_pad) of a dense unfolding: n_outer x inner_pad, inner_pad
#: a multiple of 128 (one outer index, a few, odd counts, the phase-10
#: modes)
AWKWARD_SPANS = ((128, 128), (384, 128), (128 * 1001, 128 * 7),
                 (256 * 7, 256), (98_304, 1024), (2_097_152, 2048))


@pytest.mark.parametrize("R", [1, 8, 24, 40, 50, 56, 64, 65, 257])
@pytest.mark.parametrize("rows", [1, 96, 100, 1024, 2048])
def test_dense_tiling_covers_rows_ranks_and_span(rows, R):
    """csrc/fused_dense.cu's launch shape for every value/factor dtype
    pair: a wgmma N it is built for (the smallest of 8, 16, 32, 64 and 96
    holding R, or 96 with the rest of the rank on grid.y), rank tiles
    covering R and no
    more, 128-row blocks covering the rows, chunks of one 128-byte row of
    the narrower type dividing inner_pad, the u-stationary schedule's
    splits (at most nib, or a multiple of it) covering each span's chunks
    exactly once, in at most one wave of 132 SMs."""
    for tiles_bf16 in (False, True):
        for fac_bf16 in (False, True):
            for span, inner_pad in AWKWARD_SPANS:
                t = kernels.dense_tiling(rows, span, inner_pad, R, 132,
                                         tiles_bf16, fac_bf16)
                assert kernels.DENSE_N_TILES == (8, 16, 32, 64, 96)
                assert t.n_tile in kernels.DENSE_N_TILES
                assert (t.rank_tiles - 1) * t.n_tile < R \
                    <= t.rank_tiles * t.n_tile
                if R <= 96:
                    assert t.rank_tiles == 1 and all(
                        n < R for n in kernels.DENSE_N_TILES if n < t.n_tile)
                assert t.chunk == (64 if tiles_bf16 or fac_bf16 else 32)
                assert inner_pad % t.chunk == 0
                assert t.row_blocks == -(-rows // 128)
                nib = inner_pad // t.chunk
                assert t.splits <= nib or (
                    t.splits % nib == 0
                    and t.splits // nib <= span // inner_pad)
                _covered_once(t, span, inner_pad)
                ctas = t.row_blocks * t.splits * t.rank_tiles
                assert ctas <= max(132, t.row_blocks * t.rank_tiles)


def test_tf32_split_rounds_as_the_card():
    """tf32_split: big keeps 10 mantissa bits, rounded to nearest with
    ties away from zero (cvt.rna.tf32.f32); small is the remainder's
    TF32 part; big + small is x within 2^-22 relative."""
    x = torch.tensor([1.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11),
                      1.0 + 3 * 2.0**-12, 3.0e-30, 0.0])
    big, small = kernels.tf32_split(x)
    assert big.tolist()[:4] == [1.0, 1.0 + 2.0**-10, -(1.0 + 2.0**-10),
                                1.0 + 2.0**-10]
    assert float(big[5]) == 0.0 and float(small[5]) == 0.0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    big, small = kernels.tf32_split(x)
    for part in (big, small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (x.double() - big.double() - small.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())


@pytest.mark.parametrize("vals", ["f32", "bf16"])
@pytest.mark.parametrize("dims,nnz", [((16, 32, 120), 4000),
                                      ((5, 6, 7, 9), 1200),
                                      ((300, 8, 128), 100000)])
def test_tf32x3_emulation_matches_plain_and_jax(dims, nnz, vals):
    """What fused_dense computes with f32 factors, 3xTF32 emulated in
    f64, against fused_dense_plain (f32, 1e-5 of max: the plain version's
    own f32 sums) and the JAX package's dense_mttkrp in f64 on the same
    f32-representable values and factors: within 2^-20 of max|ref|, as
    3xTF32 keeps about 2^-21 of each product (the dropped small x small
    term and the remainders' rounding) and the values are positive."""
    tt = _tensor(dims, nnz)
    bf16 = vals == "bf16"
    store = torch.bfloat16 if bf16 else torch.float32
    v = torch.from_numpy(tt.vals).to(store).double().numpy()
    tt = JSparse(tt.inds, v, tt.dims)
    X = port_tensor(tt)
    rng = np.random.default_rng(9)
    f32 = [rng.random((d, 6)).astype(np.float32) for d in dims]
    tf = [torch.from_numpy(U) for U in f32]
    jf = [jnp.asarray(U.astype(np.float64)) for U in f32]
    for mode in range(tt.nmodes):
        lay = tb.build_dense_layout(X, mode, device="cpu", val_dtype=store)
        jlay = jb.build_dense_layout(tt, mode, val_dtype=np.float64)
        got = kernels.fused_dense_tf32x3(lay, tf, mode)
        assert got.dtype == torch.float64 and got.shape == (dims[mode], 6)
        ref = np.asarray(jdense_mttkrp(jlay, jf, mode), dtype=np.float64)
        scale = np.abs(ref).max()
        assert np.abs(got.numpy() - ref).max() <= 2.0**-20 * scale
        plain = kernels.fused_dense_plain(lay, tf, mode).double().numpy()
        assert np.abs(got.numpy() - plain).max() <= 1e-5 * scale


# -- chain and dispatch ------------------------------------------------------


def _meta(rank=50, device="cpu"):
    dev = torch.device(device)
    lay = SimpleNamespace(block=256, encoding="dense", device=dev)
    return lay, [torch.empty((d, rank), device="meta")
                 for d in (96, 1024, 2048)]


def test_chain_gate_and_shape_key():
    lay, facs = _meta()
    assert tm.engine_chain(lay, facs, 0) == ["fused_dense", "dense_xla"]
    assert tm.engine_chain(lay, facs, 0, "dense") == ["fused_dense",
                                                       "dense_xla"]
    card, cfacs = _meta(device="cuda")
    assert tm.engine_chain(card, cfacs, 0) == ["fused_dense"]
    # the kernel's one static limit: the rank tiles on grid.y
    big, bfacs = _meta(rank=kernels.DENSE_MAX_RANK + 1)
    assert tm.engine_chain(big, bfacs, 0) == ["dense_xla"]
    big_card, _ = _meta(rank=1, device="cuda")
    assert tm.engine_chain(big_card, bfacs, 0) == []
    assert kernels.DENSE_MAX_RANK == 65535 * kernels.DENSE_N_TILES[-1]
    key = tm._engine_shape_key(lay, facs, 0)
    assert key == "r64:b256:dn"
    sparse = SimpleNamespace(block=256, encoding="v1")
    assert tm._engine_shape_key(sparse, facs, 0) == "r64:b256"


def test_dispatch_routes_dense_whatever_the_path():
    tt = _tensor()
    X = port_tensor(tt)
    _, tf = _factors(tt.dims, 4, 3, np.float32)
    lay = tb.build_dense_layout(X, 0, device="cpu")
    ref = kernels.fused_dense_plain(lay, tf, 0)
    assert tm.choose_path(lay, 0, Options()) == "dense"
    for path in ("sorted_onehot", "privatized", "scatter",
                 "sorted_scatter", "dense"):
        assert torch.equal(tm.mttkrp_blocked(lay, tf, 0, path), ref), path
    sparse = tb.build_layout(X, 0, block=512, device="cpu", dense=False)
    with pytest.raises(ValueError, match="dense layout"):
        tm.mttkrp_blocked(sparse, tf, 0, "dense")
    # once per (engine, shape, mode): warm dispatches add nothing
    (ev,) = resilience.run_report().events("dense_dispatch")
    assert ev == dict(ev, engine="fused_dense", mode=0, tile=16, span=4096,
                      density_bucket="dn5")
    assert not resilience.run_report().events("format_decode")
    assert any("dense-mode dispatch [fused_dense]: mode 0 as 16x4096"
               in ln for ln in resilience.run_report().summary())


def test_fault_demotes_to_dense_xla_and_dn_scope():
    tt = _tensor()
    X = port_tensor(tt)
    _, tf = _factors(tt.dims, 4, 3, np.float32)
    lay = tb.build_dense_layout(X, 0, device="cpu")
    sparse = tb.build_layout(X, 0, block=512, device="cpu", dense=False)
    ref = kernels.fused_dense_plain(lay, tf, 0)
    with faults.inject("engine.fused_dense", "runtime"):
        with pytest.raises(RuntimeError, match="injected"):
            tm.mttkrp_blocked(lay, tf, 0, fallback=False)
    with faults.inject("engine.fused_dense", "runtime"):
        assert torch.equal(tm.mttkrp_blocked(lay, tf, 0, fallback=True),
                           ref)
    (d,) = resilience.demotions()
    assert d.engine == "fused_dense"
    kd = tm._engine_shape_key(lay, tf, 0)
    ks = tm._engine_shape_key(sparse, tf, 0)
    assert kd == f"r32:b{lay.tile}:dn" and ks == "r32:b512"
    assert tm.engine_chain(lay, tf, 0) == ["dense_xla"]
    engines = [e["engine"] for e in
               resilience.run_report().events("dense_dispatch")]
    # the faulted engine never dispatched: only dense_xla left evidence
    assert engines == ["dense_xla"]
    # an out-of-memory at the dense key leaves the sparse key alone, and
    # the reverse
    resilience.reset_demotions()
    resilience.demote_engine("fused_dense", RuntimeError("CUDA out of "
                                                         "memory"),
                             shape_key=kd)
    assert resilience.is_demoted("fused_dense", kd)
    assert tm.engine_chain(sparse, tf, 0)[0] == "fused_t"
    resilience.reset_demotions()
    resilience.demote_engine("fused_t", RuntimeError("CUDA out of memory"),
                             shape_key=ks)
    assert tm.engine_chain(lay, tf, 0) == ["fused_dense", "dense_xla"]
    assert not resilience.is_demoted("fused_t", kd)


# -- from_coo and the policies -----------------------------------------------


def _jopts(**kw):
    return JOptions(verbosity=JVerbosity.NONE, use_pallas=False,
                    autotune=False, random_seed=1, val_dtype=np.float32,
                    **kw)


def _kinds(bs):
    return [lay.encoding for lay in bs.layouts]


@pytest.mark.parametrize("alloc", ["twomode", "allmode"])
@pytest.mark.parametrize("policy", ["off", "auto", "on", "env-auto",
                                    "threshold"])
def test_from_coo_matches_jax(policy, alloc, monkeypatch):
    # modes 0 and 1 pass the 5% verdict, mode 2 (6.1% raw, 1.6% padded)
    # does not: "auto" is a hybrid mix, "on" forces mode 2 too
    tt = _tensor((16, 32, 120), 4000)
    kw = dict(nnz_block=512)
    if policy == "env-auto":
        monkeypatch.setenv("SPLATT_DENSE", "auto")
    elif policy == "threshold":
        kw.update(dense="auto", dense_threshold=0.01)
    else:
        kw["dense"] = policy
    want = jb.BlockedSparse.from_coo(tt, _jopts(block_alloc=JAlloc(alloc),
                                                **kw))
    got = tb.BlockedSparse.from_coo(
        port_tensor(tt), Options(block_alloc=BlockAlloc(alloc),
                                 verbosity=Verbosity.NONE, **kw),
        device="cpu")
    assert got.mode_map == want.mode_map
    assert _kinds(got) == _kinds(want)
    assert got.format_summary() == want.format_summary()
    assert got.storage_bytes() == want.storage_bytes()
    assert got.layouts[0].encoding == "v1"      # frobsq and the dtype
    assert got.frobsq() == pytest.approx(float(np.dot(tt.vals, tt.vals)),
                                         rel=1e-6)
    for lay, jlay in zip(got.layouts, want.layouts):
        if lay.encoding == "dense":
            assert_same_dense(lay, jlay)
    dense_modes = [m for m in range(3)
                   if got.layout_for(m).encoding == "dense"]
    expect = {"off": [], "auto": [0, 1], "env-auto": [0, 1],
              "on": [0, 1, 2], "threshold": [0, 1, 2]}[policy]
    assert dense_modes == expect
    events = resilience.run_report().events("format_v2")
    assert bool(events) == bool(expect)
    # the hybrid plan: dense modes on fused_dense, the others sparse
    _, tf = _factors(tt.dims, 4, 2, np.float32)
    plan = tm.describe_plan(got, tf)
    for m in range(3):
        assert (f"mode{m}=dense/fused_dense" in plan) == (m in expect)


def test_format_dense_fault_degrades_like_jax(capsys):
    tt = _tensor((16, 32, 120), 4000)
    opts = dict(dense="on", nnz_block=512)
    with faults.inject("format.dense", "runtime", times=1):
        got = tb.BlockedSparse.from_coo(
            port_tensor(tt), Options(block_alloc=BlockAlloc.ALLMODE, **opts),
            device="cpu")
    with jfaults.inject("format.dense", "runtime", times=1):
        want = jb.BlockedSparse.from_coo(
            tt, _jopts(block_alloc=JAlloc.ALLMODE, **opts))
    assert got.mode_map == want.mode_map == {0: 0, 1: 3, 2: 4}
    assert _kinds(got) == _kinds(want)
    (ev,) = resilience.run_report().events("format_fallback")
    assert ev == dict(ev, mode=0, site="dense", idx_width="dense",
                      failure_class="unknown")
    assert "injected" in ev["error"]
    lines = resilience.run_report().summary()
    assert any("dense tile-layout build failed for mode 0" in ln
               and "sparse blocked encoding" in ln for ln in lines)
    out = capsys.readouterr().out
    assert "layout mode0: dense tiling failed" in out
    assert "format: mode0=i32/glob/f32" in out
    # the degraded mode runs its sparse kernel, the others the dense one
    _, tf = _factors(tt.dims, 4, 2, np.float32)
    plan = tm.describe_plan(got, tf)
    assert "mode0=sorted_onehot/fused_t" in plan
    assert "mode1=dense/fused_dense mode2=dense/fused_dense" in plan
    # build_layout and reencode_layout degrade the same way
    X = port_tensor(tt)
    with faults.inject("format.dense", "runtime", times=1):
        lay = tb.build_layout(X, 1, block=512, device="cpu", dense=True)
    assert lay.encoding == "v1"
    with faults.inject("format.dense", "runtime", times=1):
        again = tb.reencode_layout(lay, LayoutFormat(idx="auto"),
                                   dense=True, dims=tt.dims)
    assert again.encoding == "v2"
    assert [e["site"] for e in resilience.run_report().events(
        "format_fallback")] == ["dense"] * 3
    with pytest.raises(ValueError, match="dims"):
        tb.reencode_layout(lay, LayoutFormat(), dense=True)


def test_build_layout_reads_the_policy(monkeypatch):
    tt = _tensor()
    X = port_tensor(tt)

    def enc():
        got = tb.build_layout(X, 0, block=512, device="cpu").encoding
        assert got == jb.build_layout(tt, 0, block=512).encoding
        return got

    assert enc() == "v1"
    monkeypatch.setenv("SPLATT_DENSE", "auto")
    assert enc() == "dense"
    monkeypatch.setenv("SPLATT_DENSE_THRESHOLD", "0.5")
    assert enc() == "v1"
    monkeypatch.setenv("SPLATT_DENSE", "on")
    assert enc() == "dense"
    monkeypatch.setenv("SPLATT_DENSE", "off")
    assert enc() == "v1"


def test_config_and_registries(monkeypatch):
    assert DENSE_POLICIES == JPOLICIES
    assert DENSE_THRESHOLD_DEFAULT == JTHRESHOLD
    for name in ("SPLATT_DENSE", "SPLATT_DENSE_THRESHOLD"):
        assert ENV_VARS[name].default == JENV[name].default
    assert "format.dense" in faults.SITES
    assert resolve_dense(Options()) == "off"
    assert resolve_dense(Options(dense="on")) == "on"
    assert resolve_dense_threshold(Options()) == 0.05
    monkeypatch.setenv("SPLATT_DENSE", "auto")
    monkeypatch.setenv("SPLATT_DENSE_THRESHOLD", "0.2")
    assert resolve_dense(Options()) == "auto"
    assert resolve_dense_threshold(Options()) == 0.2
    assert resolve_dense_threshold(Options(dense_threshold=0.3)) == 0.3
    monkeypatch.setenv("SPLATT_DENSE_THRESHOLD", "lots")
    assert resolve_dense_threshold(Options()) == 0.05
    monkeypatch.setenv("SPLATT_DENSE", "sometimes")
    with pytest.raises(ValueError, match="dense"):
        resolve_dense(Options())
    for bad in (dict(dense="yes"), dict(dense_threshold=0.0),
                dict(dense_threshold=1.5)):
        with pytest.raises(ValueError, match="dense"):
            Options(**bad).validate()


# -- the whole slice ---------------------------------------------------------


@pytest.mark.parametrize("alloc,policy", [("twomode", "auto"),
                                          ("allmode", "on")])
def test_hybrid_cpd_matches_jax(alloc, policy):
    """auto: modes 0 and 1 dense, mode 2 sparse; on: every mode dense."""
    tt = _tensor((16, 32, 120), 4000)
    rank, iters = 5, 3
    init = [np.random.default_rng(11).random((d, rank)) for d in tt.dims]
    jopts = JOptions(block_alloc=JAlloc(alloc), nnz_block=512,
                     max_iterations=iters, tolerance=0.0,
                     val_dtype=np.float64, verbosity=JVerbosity.NONE,
                     autotune=False, use_pallas=False, dense=policy)
    want = jax_cpd_als(jb.BlockedSparse.from_coo(tt, jopts), rank, jopts,
                       init=init)
    opts = Options(block_alloc=BlockAlloc(alloc), nnz_block=512,
                   max_iterations=iters, tolerance=0.0,
                   val_dtype=torch.float64, verbosity=Verbosity.NONE,
                   dense=policy)
    bs = tb.BlockedSparse.from_coo(port_tensor(tt), opts, device="cpu")
    assert any(lay.encoding == "dense" for lay in bs.layouts)
    got = state.to_numpy(cpd_als(bs, rank, opts, init=init, device="cpu"))
    assert len(got["fits"]) == iters
    assert got["fit"] == pytest.approx(float(want.fit), abs=1e-9)
    np.testing.assert_allclose(got["lam"], np.asarray(want.lam), atol=1e-8,
                               rtol=0)
    for g, w in zip(got["factors"], want.factors):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-8, rtol=0)
    engines = {e["engine"] for e in
               resilience.run_report().events("dense_dispatch")}
    assert engines == {"fused_dense"}


def test_cli_dense_auto_on_the_cpu(tmp_path):
    tt = _tensor((16, 32, 120), 4000)
    path = tmp_path / "dense.tns"
    jsave(tt, str(path), one_indexed=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               SPLATT_DENSE="auto")
    r = subprocess.run(
        [sys.executable, "-m", "splatt_tpu_torch.cli", "cpd", str(path),
         "-r", "4", "-i", "3", "--seed", "1", "--alloc", "allmode",
         "--device", "cpu", "--json", "-o", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert "format: mode0=i32/glob/f32" in r.stdout
    assert "mode0=dense/t16/f32 mode1=dense/t32/f32" in r.stdout
    assert "mode0=dense/fused_dense mode1=dense/fused_dense " \
           "mode2=sorted_onehot/fused_t" in r.stdout
    assert "dense-mode dispatch [fused_dense]" in r.stdout
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert 0.0 < rec["fit"] <= 1.0
    modes = sorted(e["mode"] for e in rec["events"]
                   if e["kind"] == "dense_dispatch")
    assert modes == [0, 1]
