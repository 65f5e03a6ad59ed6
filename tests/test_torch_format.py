"""The port's compact blocked format v2 and bf16 value storage against the
JAX package, from the same numpy inputs.

- The stream vocabulary is bit-equal to splatt_tpu.blocked's helpers.
- ``build_layout`` / ``reencode_layout`` give byte-identical streams,
  bases and dtypes, and degrade to v1 where the JAX package does.
- ``fused_mttkrp_v2_plain`` equals the JAX kernel in interpret mode:
  rtol 1e-5 on f32; 1e-2 of max|ref| on bf16 (the two sum bf16 products
  in f32 in another order).
- On the CPU every engine of the chain gives the same bits over v2 as
  over v1, as ``test_v2_bitparity_forced_engines`` asserts in JAX.
- ``cpd_als`` over v2 matches splatt_tpu.cpd_als from the same init
  (f32 fits within 1e-5); bf16 storage reaches the planted-tensor fit of
  tests/test_format.py.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import blocked as jb
from splatt_tpu import cpd_als as jax_cpd_als
from splatt_tpu.config import BlockAlloc as JAlloc
from splatt_tpu.config import LayoutFormat as JFormat
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.ops.pallas_kernels import fused_mttkrp_v2 as jfused_v2
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import blocked as tb
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience, state
from splatt_tpu_torch.config import (BlockAlloc, LayoutFormat, Options,
                                     Verbosity, fit_dtype, layout_format,
                                     resolve_decode, resolve_storage_dtype)
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.ops import kernels
from splatt_tpu_torch.ops import mttkrp as tm
from splatt_tpu_torch.utils import faults
from splatt_tpu_torch.utils.env import ENV_VARS
from tests import gen
from tests.test_cpd import lowrank_tensor
from tests.test_torch_kernels_gpu import contracts
from tests.torch_fixtures import private_tune_cache  # noqa: F401

ENCODINGS = ("auto", "u16", "u8", "delta", "rle")
KERNEL_ENCODINGS = ("auto", "u8", "delta", "rle")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SPLATT_FAULTS", "SPLATT_IDX_WIDTH", "SPLATT_VAL_STORAGE",
                 "SPLATT_DECODE", "SPLATT_ENGINE_FALLBACK",
                 "SPLATT_EXPERIMENTAL_FUSED"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(resilience.time, "sleep", lambda s: None)

    def clear():
        faults.reset()
        jfaults.reset()
        resilience.reset_demotions()
        resilience.run_report().clear()
        tm._DECODE_NOTED.clear()

    clear()
    yield
    clear()


def _wide_tensor():
    """tests/test_format.py's tensor with a mode beyond uint16."""
    rng = np.random.default_rng(7)
    dims = (23, 70000, 31)
    nnz = 2500
    inds = np.stack([rng.integers(0, d, nnz) for d in dims])
    return JSparse(inds.astype(np.int64), rng.random(nnz) + 0.1, dims)


def _tensor(name):
    if name == "wide":
        return _wide_tensor()
    if name == "empty":
        return JSparse(np.zeros((3, 0), dtype=np.int64), np.zeros(0),
                       (5, 6, 7))
    return gen.fixture_tensor(name)


def port_tensor(tt):
    return tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


def port_layout(lay):
    """A JAX layout, v1 or v2, handed over as numpy arrays."""
    v2 = lay.base is not None
    return state.layout_from_numpy(
        [np.asarray(s) for s in lay.inds] if v2 else np.asarray(lay.inds),
        np.asarray(lay.vals), np.asarray(lay.row_start), mode=lay.mode,
        dim=lay.dim, block=lay.block, seg_width=lay.seg_width, nnz=lay.nnz,
        base=[np.asarray(b) for b in lay.base] if v2 else None,
        idx_width=lay.idx_width, val_storage=lay.val_storage, device="cpu")


def _numpy(t):
    return state.to_numpy(t)


def assert_same_layout(got, want):
    """Byte-identical streams, bases, values and metadata."""
    assert got.encoding == want.encoding
    assert got.idx_width == want.idx_width
    assert got.val_storage == want.val_storage
    assert (got.mode, got.dim, got.block, got.seg_width, got.nnz,
            got.nblocks) == (want.mode, want.dim, want.block,
                             want.seg_width, want.nnz, want.nblocks)
    assert got.idx_widths() == want.idx_widths()
    assert got.format_desc() == want.format_desc()
    assert got.storage_bytes() == want.storage_bytes()
    assert got.stream_encs() == want.stream_encs()
    np.testing.assert_array_equal(_numpy(got.row_start),
                                  np.asarray(want.row_start))
    np.testing.assert_array_equal(_numpy(got.vals),
                                  np.asarray(want.vals).astype(np.float64))
    for k in range(want.nmodes):
        g, w = _numpy(got.inds[k]), np.asarray(want.inds[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
        np.testing.assert_array_equal(_numpy(got.mode_ids(k)),
                                      np.asarray(want.mode_ids(k)))
    if want.base is not None:
        for k in range(want.nmodes):
            assert _numpy(got.base[k]).tobytes() == \
                np.asarray(want.base[k]).tobytes()
    np.testing.assert_array_equal(_numpy(got.blocked_locals()),
                                  np.asarray(want.blocked_locals()))


# -- the stream vocabulary ---------------------------------------------------


@pytest.mark.parametrize("enc,dtype", [
    ("glob", np.int32), ("loc", np.uint16), ("loc", np.int32),
    ("seg", np.uint8), ("delta", np.int8), ("delta", np.int16),
    ("rle", np.uint16)])
def test_vocabulary_bit_equal(enc, dtype):
    rng = np.random.default_rng(3)
    nb, B, S = 7, 128, 24
    base = rng.integers(0, 5000, size=(nb, 1)).astype(np.int32)
    if enc == "rle":
        cuts = np.sort(rng.integers(0, B + 1, size=(nb, S - 1)), axis=1)
        arr = np.diff(cuts, axis=1, prepend=0, append=B).astype(dtype)
        assert (arr.sum(axis=1) == B).all()
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(max(info.min, -100), min(info.max, 3000),
                           size=(nb, B)).astype(dtype)
    jarr, tarr = jnp.asarray(arr), torch.from_numpy(arr)
    jbase, tbase = jnp.asarray(base), torch.from_numpy(base)
    glob = None if enc == "glob" else jbase
    pairs = [(jb.widen_ids(jarr), tb.widen_ids(tarr)),
             (jb.decode_global_ids(jarr, glob, enc, B),
              tb.decode_global_ids(tarr, None if enc == "glob" else tbase,
                                   enc, B))]
    if enc in ("glob", "seg", "rle"):
        pairs.append((jb.decode_segment_ids(jarr, enc, B, row_start=jbase),
                      tb.decode_segment_ids(tarr, enc, B, row_start=tbase)))
    if enc in ("glob", "loc", "delta"):
        pairs.append((jb.decode_gather_ids(jarr, glob, enc),
                      tb.decode_gather_ids(tarr, None if enc == "glob"
                                           else tbase, enc)))
    if enc == "rle":
        pairs.append((jb.rle_expand(jarr, B), tb.rle_expand(tarr, B)))
    for want, got in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.int32
        assert got.numpy().tobytes() == want.astype(np.int32).tobytes()


def test_stream_encodings_match():
    assert tb.STREAM_ENCODINGS == jb.STREAM_ENCODINGS
    for idx in ("i32",) + ENCODINGS:
        for mode in range(4):
            assert tb.stream_encodings(idx, mode, 4) == \
                jb.stream_encodings(idx, mode, 4)


# -- the encoders and builders -----------------------------------------------


@pytest.mark.parametrize("idx", ENCODINGS)
@pytest.mark.parametrize("name", ["med", "med4", "wide", "empty"])
def test_build_and_reencode_byte_identical(name, idx):
    tt = _tensor(name)
    X = port_tensor(tt)
    for mode in range(tt.nmodes):
        want = jb.build_layout(tt, mode, block=128, val_dtype=np.float32,
                               fmt=JFormat(idx=idx))
        got = tb.build_layout(X, mode, block=128, device="cpu",
                              fmt=LayoutFormat(idx=idx))
        assert_same_layout(got, want)
        v1 = jb.build_layout(tt, mode, block=128, val_dtype=np.float32)
        re_want = jb.reencode_layout(v1, JFormat(idx=idx))
        re_got = tb.reencode_layout(tb.build_layout(X, mode, block=128,
                                                    device="cpu"),
                                    LayoutFormat(idx=idx))
        assert_same_layout(re_got, re_want)
        assert_same_layout(re_got, want)
        # the numpy hand-over carries a JAX v2 layout as it is
        assert_same_layout(port_layout(want), want)


def test_bf16_storage_matches():
    tt = gen.fixture_tensor("med")
    fmt = dict(idx="auto", val="bf16")
    want = jb.build_layout(tt, 1, block=256, val_dtype=jnp.bfloat16,
                           fmt=JFormat(**fmt))
    got = tb.build_layout(port_tensor(tt), 1, block=256,
                          val_dtype=torch.bfloat16, device="cpu",
                          fmt=LayoutFormat(**fmt))
    assert got.vals.dtype == torch.bfloat16
    assert got.format_desc() == want.format_desc() == "u16/seg/bf16"
    assert_same_layout(got, want)
    assert_same_layout(port_layout(want), want)
    assert "enc=v2" in repr(got) and "bf16" in repr(got)
    # numpy has no bf16: the factors' hand-over stages through f32
    U = np.asarray(jnp.asarray(np.random.default_rng(0).random((6, 3)),
                               dtype=jnp.bfloat16))
    k = state.kruskal_from_numpy([U, U], np.ones(3, np.float32),
                                 device="cpu")
    assert k.factors[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_numpy(k.factors[0]),
                                  U.astype(np.float32))


def test_storage_and_widths_shrink():
    tt = _wide_tensor()
    X = port_tensor(tt)
    v1 = tb.build_layout(X, 0, block=128, device="cpu")
    v2 = tb.build_layout(X, 0, block=128, device="cpu",
                         fmt=LayoutFormat(idx="auto"))
    assert v2.idx_widths() == ["u16", "i32", "u16"]
    assert v2.storage_bytes() < v1.storage_bytes()
    bf = tb.build_layout(X, 0, block=128, device="cpu",
                         val_dtype=torch.bfloat16,
                         fmt=LayoutFormat(idx="auto", val="bf16"))
    assert bf.storage_bytes() < v2.storage_bytes()
    assert "enc=v1" in repr(v1) and v1.format_desc() == "i32/glob/f32"


def _fallback_events():
    return resilience.run_report().events("format_fallback")


@pytest.mark.parametrize("case", ["u16", "u8", "rle", "fault"])
def test_encode_failures_degrade_to_v1(case):
    """A u16, u8 or RLE overflow, or an armed format.encode fault, leaves
    a v1 layout and a format_fallback event, as in the JAX package."""
    block = 128
    if case == "u16":
        tt, idx, mode = _wide_tensor(), "u16", 0
    elif case == "u8":
        inds = np.stack([np.arange(1000)] * 3)
        tt, idx, mode = JSparse(inds, np.ones(1000), (1000,) * 3), "u8", 0
        block = 1024
    elif case == "rle":
        inds = np.stack([np.arange(1000) * 2 % 2000, np.arange(1000) % 7,
                         np.arange(1000) % 5])
        inds[0].sort()
        tt, idx, mode = JSparse(inds, np.ones(1000), (2000, 7, 5)), "rle", 0
    else:
        tt, idx, mode = gen.fixture_tensor("med"), "auto", 1
    times = int(case == "fault")
    with faults.inject("format.encode", "runtime", times=times):
        got = tb.build_layout(port_tensor(tt), mode, block=block,
                              device="cpu", fmt=LayoutFormat(idx=idx))
    with jfaults.inject("format.encode", "runtime", times=times):
        want = jb.build_layout(tt, mode, block=block, val_dtype=np.float32,
                               fmt=JFormat(idx=idx))
    assert got.encoding == want.encoding == "v1"
    assert got.idx_width == "i32"
    (ev,) = _fallback_events()
    assert (ev["idx_width"], ev["mode"]) == (idx, mode)
    if times:
        assert ev["failure_class"] == "unknown"
        assert "injected" in ev["error"]
    else:
        assert idx in ev["error"]
    assert any("compact-format encode failed" in ln
               for ln in resilience.run_report().summary())
    # the degraded layout is the v1 build
    assert_same_layout(got, jb.build_layout(tt, mode, block=block,
                                            val_dtype=np.float32))
    v1 = tb.build_layout(port_tensor(tt), mode, block=block, device="cpu")
    with faults.inject("format.encode", "runtime", times=times):
        again = tb.reencode_layout(v1, LayoutFormat(idx=idx))
    assert again.encoding == "v1" and len(_fallback_events()) == 2


def test_from_coo_format_events_and_line(capsys, monkeypatch):
    tt = gen.fixture_tensor("med")
    X = port_tensor(tt)
    bs = tb.BlockedSparse.from_coo(X, Options(
        idx_width="delta", val_storage="bf16",
        block_alloc=BlockAlloc.ALLMODE, nnz_block=1 << 16), device="cpu")
    assert all(lay.encoding == "v2" and lay.vals.dtype == torch.bfloat16
               for lay in bs.layouts)
    (ev,) = resilience.run_report().events("format_v2")
    assert ev["modes"] == {str(lay.mode): lay.format_desc()
                           for lay in bs.layouts}
    out = capsys.readouterr().out
    assert f"  format: {bs.format_summary()}" in out
    assert bs.format_summary().startswith("mode0=i8")
    assert bs.storage_bytes() == sum(l.storage_bytes() for l in bs.layouts)
    clamps = resilience.run_report().events("block_clamp")
    assert len(clamps) == 3 and clamps[0]["idx_width"] == "delta"
    assert clamps[0]["val_storage"] == "bf16"
    assert clamps[0]["requested"] == 1 << 16
    # the env sets the format when Options leave it unset; an
    # always-armed encode fault leaves every layout v1 and the run goes on
    monkeypatch.setenv("SPLATT_IDX_WIDTH", "rle")
    assert layout_format(Options()) == LayoutFormat("rle", "auto")
    with faults.inject("format.encode", "runtime", times=99):
        bs = tb.BlockedSparse.from_coo(X, Options(
            verbosity=Verbosity.NONE, block_alloc=BlockAlloc.ALLMODE),
            device="cpu")
    assert all(lay.encoding == "v1" for lay in bs.layouts)
    assert len(_fallback_events()) == 3
    out = cpd_als(bs, 3, Options(max_iterations=2, random_seed=1,
                                 verbosity=Verbosity.NONE), device="cpu")
    assert np.isfinite(out.fit)


def test_config_and_registries():
    assert layout_format(Options()) == LayoutFormat("i32", "auto")
    assert not layout_format(Options()).v2
    assert layout_format(Options(idx_width="u8", val_storage="bf16")) == \
        LayoutFormat("u8", "bf16")
    assert resolve_storage_dtype("bf16", torch.float64) == torch.bfloat16
    assert resolve_storage_dtype("f32", torch.float64) == torch.float32
    assert resolve_storage_dtype("auto", torch.float64) == torch.float64
    assert fit_dtype() == torch.float32
    assert resolve_decode() == "kernel"
    for bad in (dict(idx_width="nope"), dict(val_storage="f8")):
        with pytest.raises(ValueError):
            Options(**bad).validate()
    with pytest.raises(ValueError, match="idx_width"):
        LayoutFormat(idx="u4").validate()
    from splatt_tpu.utils.env import ENV_VARS as JENV

    for name in ("SPLATT_IDX_WIDTH", "SPLATT_VAL_STORAGE", "SPLATT_DECODE"):
        assert ENV_VARS[name].default == JENV[name].default
    assert {"format.encode", "format.decode"} <= set(faults.SITES)


# -- fused_mttkrp_v2's plain version against the JAX kernel ------------------


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("idx", KERNEL_ENCODINGS)
def test_fused_v2_plain_matches_pallas_interpret(idx, bf16):
    tt = gen.fixture_tensor("med4" if idx == "delta" else "med")
    vdt = jnp.bfloat16 if bf16 else np.float32
    fmt = JFormat(idx=idx, val="bf16" if bf16 else "auto")
    lays = [jb.build_layout(tt, m, block=128, val_dtype=vdt, fmt=fmt)
            for m in range(tt.nmodes)]
    assert all(lay.encoding == "v2" for lay in lays)
    rng = np.random.default_rng(4)
    f32 = [rng.random((d, 7), dtype=np.float32) for d in tt.dims]
    jf = [jnp.asarray(U, dtype=vdt) for U in f32]
    tf = [torch.from_numpy(U).to(torch.bfloat16 if bf16 else torch.float32)
          for U in f32]
    for lay, m, width, acc in contracts(lays, tt.dims):
        want = np.asarray(jfused_v2(lay, jf, m, width, accumulate=acc,
                                    interpret=True))
        got = kernels.fused_mttkrp_v2(port_layout(lay), tf, m, width, acc)
        assert got.dtype == torch.float32 and got.shape == want.shape
        what = f"{idx} mode={m} acc={acc}"
        if bf16:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-2 * np.abs(want).max(),
                                       err_msg=what)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=what)


def test_fused_v2_needs_a_v2_layout_and_the_own_mode():
    tt = gen.fixture_tensor("med")
    X = port_tensor(tt)
    v1 = tb.build_layout(X, 0, block=128, device="cpu")
    v2 = tb.reencode_layout(v1, LayoutFormat(idx="auto"))
    tf = [torch.ones((d, 3)) for d in tt.dims]
    with pytest.raises(ValueError, match="compact v2"):
        kernels.fused_mttkrp_v2(v1, tf, 0, v1.seg_width, False)
    with pytest.raises(ValueError, match="own mode"):
        kernels.fused_mttkrp_v2(v2, tf, 1, v2.seg_width, False)


# -- every engine of the chain: v2 bits equal v1 bits ------------------------

ENGINES = ("fused_v2", "fused_t", "fused_tg", "fused", "unfused_pallas",
           "xla_scan", "xla")


@pytest.mark.parametrize("idx", KERNEL_ENCODINGS)
def test_every_engine_bit_identical_over_v2(idx):
    tt = gen.fixture_tensor("med")
    X = port_tensor(tt)
    rng = np.random.default_rng(5)
    tf = [torch.from_numpy(rng.random((d, 4), dtype=np.float32))
          for d in tt.dims]
    for mode in range(tt.nmodes):
        v1 = tb.build_layout(X, mode, block=128, device="cpu")
        v2 = tb.reencode_layout(v1, LayoutFormat(idx=idx))
        assert v2.encoding == "v2"
        other = (mode + 1) % tt.nmodes
        for m, path in ((mode, "sorted_onehot"), (other, "privatized")):
            for engine in ENGINES:
                # fused_v2 reads only v2 layouts: its v1 twin is fused_t
                twin = "fused_t" if engine == "fused_v2" else engine
                assert torch.equal(
                    tm._run_engine(engine, v2, tf, m, path),
                    tm._run_engine(twin, v1, tf, m, path)), \
                    f"{engine} {path} mode={m}"
        for path in ("sorted_scatter", "scatter"):
            m = mode if path == "sorted_scatter" else other
            assert torch.equal(tm.mttkrp_blocked(v2, tf, m, path),
                               tm.mttkrp_blocked(v1, tf, m, path))


def test_scan_decodes_per_chunk():
    """xla_scan over many small chunks (a ragged last one) equals one
    step, for the RLE and delta streams."""
    tt = gen.fixture_tensor("med")
    X = port_tensor(tt)
    tf = [torch.rand((d, 6), dtype=torch.float64) for d in tt.dims]
    for idx in ("rle", "delta"):
        lay = tb.build_layout(X, 0, block=128, val_dtype=torch.float64,
                              device="cpu", fmt=LayoutFormat(idx=idx))
        assert lay.nblocks > 3
        for acc, m, width in ((False, 0, lay.seg_width), (True, 1, 40)):
            one = tm._scan_fused(lay, tf, m, width, acc)
            many = tm._scan_fused(lay, tf, m, width, acc, 128 * 6 * 3)
            assert torch.equal(one, kernels.fused_mttkrp_v2_plain(
                lay, tf, m, width, acc))
            np.testing.assert_allclose(many.numpy(), one.numpy(),
                                       rtol=1e-12, atol=1e-12)


# -- the chain over v2 layouts -----------------------------------------------


def _meta(encoding, rank=50, device="cpu"):
    from types import SimpleNamespace

    lay = SimpleNamespace(block=4096, nnz_pad=20_000_768, encoding=encoding,
                          vals=SimpleNamespace(device=torch.device(device)))
    return lay, [torch.empty((d, rank), device="meta")
                 for d in (12092, 9184, 28818)]


def test_chain_heads_with_fused_v2(monkeypatch):
    lay, facs = _meta("v2")
    assert tm.engine_chain(lay, facs, 0) == [
        "fused_v2", "fused_t", "fused_tg", "unfused_pallas", "xla_scan",
        "xla"]
    card, cfacs = _meta("v2", device="cuda")
    assert tm.engine_chain(card, cfacs, 0, "privatized") == [
        "fused_v2", "fused_t", "fused_tg", "unfused_pallas"]
    assert tm.engine_chain(*_meta("v1"), 0)[0] == "fused_t"
    big, bfacs = _meta("v2", rank=257)
    assert tm.engine_chain(big, bfacs, 0)[0] == "fused_tg"
    assert tm.engine_chain(lay, facs, 0, "scatter") == ["xla"]
    monkeypatch.setenv("SPLATT_DECODE", "prep")
    assert "fused_v2" not in tm.engine_chain(lay, facs, 0)
    monkeypatch.setenv("SPLATT_DECODE", "nope")
    with pytest.raises(ValueError, match="SPLATT_DECODE"):
        tm.engine_chain(lay, facs, 0)


def test_v2_demotion_scope_leaves_v1_alone():
    v2, facs = _meta("v2")
    v1, _ = _meta("v1")
    k1 = tm._engine_shape_key(v1, facs, 0)
    k2 = tm._engine_shape_key(v2, facs, 0)
    assert k2 == k1 + ":v2" and ":v2" not in k1
    resilience.demote_engine("fused_v2", RuntimeError("CUDA out of memory"),
                             shape_key=k2)
    resilience.demote_engine("fused_t", RuntimeError("CUDA out of memory"),
                             shape_key=k2)
    assert tm.engine_chain(v2, facs, 0)[0] == "fused_tg"
    assert tm.engine_chain(v1, facs, 0)[0] == "fused_t"


def _bs(idx, val_storage=None, **kw):
    tt = gen.fixture_tensor("med")
    opts = Options(block_alloc=BlockAlloc.ALLMODE, nnz_block=128,
                   idx_width=idx, val_storage=val_storage,
                   verbosity=Verbosity.NONE, **kw)
    return tt, tb.BlockedSparse.from_coo(port_tensor(tt), opts,
                                         device="cpu")


def test_prep_decode_and_format_decode_events(monkeypatch):
    tt, bs = _bs("rle")
    _, v1 = _bs("i32")
    tf = [torch.rand((d, 4)) for d in tt.dims]
    ref = tm.mttkrp(v1, tf, 0)
    assert tm.describe_plan(bs, tf).count("sorted_onehot/fused_v2") == 3
    assert torch.equal(tm.mttkrp(bs, tf, 0), ref)
    assert torch.equal(tm.mttkrp(bs, tf, 0), ref)   # warm: no new event
    (ev,) = resilience.run_report().events("format_decode")
    assert ev == dict(ev, engine="fused_v2", mode=0, enc="u16/rle/f32",
                      strategy="kernel")
    with faults.inject("engine.fused_v2", "runtime"):
        assert torch.equal(tm.mttkrp(bs, tf, 0), ref)
    evs = resilience.run_report().events("format_decode")
    assert [e["strategy"] for e in evs] == ["kernel", "prep"]
    assert evs[-1]["engine"] == "fused_t"
    assert [d.engine for d in resilience.demotions()] == ["fused_v2"]
    resilience.reset_demotions()
    monkeypatch.setenv("SPLATT_DECODE", "prep")
    assert "fused_v2" not in tm.describe_plan(bs, tf)
    ran = []
    real = tm._run_engine

    def recording(engine, layout, *args):
        ran.append((engine, layout.encoding))
        return real(engine, layout, *args)

    monkeypatch.setattr(tm, "_run_engine", recording)
    assert torch.equal(tm.mttkrp(bs, tf, 0), ref)
    assert ran == [("fused_t", "v1")]


def test_decode_fault_degrades_to_v1():
    tt, bs = _bs("delta")
    _, v1 = _bs("i32")
    tf = [torch.rand((d, 3)) for d in tt.dims]
    ref = tm.mttkrp(v1, tf, 1)
    with faults.inject("format.decode", "runtime"):
        assert torch.equal(tm.mttkrp(bs, tf, 1), ref)
    (ev,) = resilience.run_report().events("format_fallback")
    assert ev["site"] == "decode" and ev["idx_width"] == "delta"
    assert ev["failure_class"] == "unknown" and ev["mode"] == 1
    assert any("decode failed at dispatch" in ln
               for ln in resilience.run_report().summary())
    assert not resilience.run_report().events("format_decode")
    assert torch.equal(tm.mttkrp(bs, tf, 1), ref)    # native again
    assert resilience.run_report().events("format_decode")


def test_operand_contract_for_v2():
    tt, bs = _bs("auto")
    lay = bs.layout_for(0)
    tf = [torch.rand((d, 3)) for d in tt.dims]
    kernels.check_operands(lay, tf, 0)
    bad = tb.ModeLayout(**{**lay.__dict__, "base": lay.base[:2] + (
        lay.base[2].long(),)})
    with pytest.raises(TypeError, match="base"):
        kernels.check_operands(bad, tf, 0)
    bad = tb.ModeLayout(**{**lay.__dict__, "inds": lay.inds[:2] + (
        lay.inds[2].long(),)})
    with pytest.raises(TypeError, match=r"inds\[2\]"):
        kernels.check_operands(bad, tf, 0)
    with pytest.raises(TypeError, match="int32"):
        kernels._check_reduce(torch.zeros((2, 3), dtype=torch.int64),
                              torch.zeros((2, 3, 4)), 8)
    kernels._check_reduce(torch.zeros((2, 3), dtype=torch.int32),
                          torch.zeros((2, 3, 4), dtype=torch.bfloat16), 8)


# -- cpd_als -----------------------------------------------------------------


@pytest.mark.parametrize("idx", KERNEL_ENCODINGS)
def test_cpd_over_v2_matches_jax(idx):
    tt = gen.fixture_tensor("med")
    rank, iters = 5, 4
    init = [np.random.default_rng(11).random((d, rank)).astype(np.float32)
            for d in tt.dims]
    jopts = JOptions(block_alloc=JAlloc.ALLMODE, nnz_block=256,
                     max_iterations=iters, tolerance=0.0,
                     val_dtype=np.float32, verbosity=JVerbosity.NONE,
                     autotune=False, idx_width=idx)
    want = jax_cpd_als(jb.BlockedSparse.from_coo(tt, jopts), rank, jopts,
                       init=init)
    fits = {}
    for fmt in ("i32", idx):
        opts = Options(block_alloc=BlockAlloc.ALLMODE, nnz_block=256,
                       max_iterations=iters, tolerance=0.0,
                       idx_width=fmt, verbosity=Verbosity.NONE)
        bs = tb.BlockedSparse.from_coo(port_tensor(tt), opts, device="cpu")
        fits[fmt] = cpd_als(bs, rank, opts, init=init, device="cpu")
    assert fits[idx].fits == fits["i32"].fits    # v2 is a relabeling
    assert len(fits[idx].fits) == iters
    assert fits[idx].fit == pytest.approx(float(want.fit), abs=1e-5)
    np.testing.assert_allclose(_numpy(fits[idx].lam), np.asarray(want.lam),
                               rtol=1e-3)


def test_bf16_storage_fit_parity():
    """bf16 values and factors with f32 accumulation reach the planted
    tensor's fit within 0.03 of f32 (≙ test_format.py:236-252)."""
    tt = lowrank_tensor((15, 12, 10), rank=3)
    fits = {}
    for name, kw in (("f32", {}),
                     ("bf16", dict(idx_width="auto", val_storage="bf16"))):
        opts = Options(random_seed=42, max_iterations=40, tolerance=1e-7,
                       verbosity=Verbosity.NONE,
                       block_alloc=BlockAlloc.ALLMODE, **kw)
        bs = tb.BlockedSparse.from_coo(port_tensor(tt), opts, device="cpu")
        out = cpd_als(bs, 5, opts, device="cpu")
        fits[name] = out.fit
        if name == "bf16":
            assert all(U.dtype == torch.bfloat16 for U in out.factors)
            assert out.lam.dtype == torch.float32
    assert fits["bf16"] > 0.97
    assert abs(fits["bf16"] - fits["f32"]) < 0.03


# -- the CLI -----------------------------------------------------------------


def _cli(tensors_dir, tmp_path, env):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **env)
    return subprocess.run(
        [sys.executable, "-m", "splatt_tpu_torch.cli", "cpd",
         str(tensors_dir / "med.tns"), "-r", "4", "-i", "3", "--seed", "1",
         "--device", "cpu", "--json", "-o", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)


def test_cli_reads_the_format_from_the_env(tensors_dir, tmp_path):
    r = _cli(tensors_dir, tmp_path,
             dict(SPLATT_IDX_WIDTH="u8", SPLATT_FAULTS="format.encode:runtime"))
    assert r.returncode == 0, r.stderr
    assert "compact-format encode failed for mode" in r.stdout
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    kinds = [e["kind"] for e in rec["events"]]
    assert "format_fallback" in kinds and "format_v2" in kinds
    r = _cli(tensors_dir, tmp_path, dict(SPLATT_IDX_WIDTH="rle",
                                         SPLATT_VAL_STORAGE="bf16"))
    assert r.returncode == 0, r.stderr
    assert "format: mode" in r.stdout and "/rle/bf16" in r.stdout
    assert "sorted_onehot/fused_v2" in r.stdout
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert 0.0 < rec["fit"] <= 1.0
    assert {e["strategy"] for e in rec["events"]
            if e["kind"] == "format_decode"} == {"kernel"}
