"""The port's native host runtime (``splatt_tpu_torch/native.py``,
``csrc/host_io.cpp``), its text route and host MTTKRP engine, and
``interop``/``version``, against the JAX package's, on the CPU.

Same files through both packages: ``parse_tns`` and ``stream_to_bin`` give
the same arrays and the same ``.bin`` bytes, refuse the same malformed
rows, and leave no partial file; ``io.load`` of a text file and the
``convert ... bin`` verb stream as the JAX package's do.  ``native.mttkrp``
matches the JAX package's engine on the same layout arrays and the port's
plain MTTKRP (f32 and f64), never reads the padding, declines balanced
layouts, and ``impl="native"`` refuses a tensor off the CPU.  The tests
that need the libraries (the ``native_lib`` fixture) skip where there is
no ``g++``.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from splatt_tpu import interop as jinterop
from splatt_tpu import io as jio
from splatt_tpu import native as jnative
from splatt_tpu import version as jversion
from splatt_tpu_torch import BlockedSparse, Options
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import interop, native, version
from splatt_tpu_torch import io as tio
from splatt_tpu_torch.config import BlockAlloc
from splatt_tpu_torch.ops.mttkrp import (mttkrp, mttkrp_stream,
                                         native_runnable, plan_mttkrp,
                                         run_native)
from tests import gen
from tests.torch_fixtures import (private_jax_native,  # noqa: F401
                                  private_tune_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = ["small", "med", "small4", "med4", "med5"]


@pytest.fixture
def native_lib(private_jax_native):
    """Both packages' native libraries, built here; skips without g++.
    The JAX package's is a private build (tests/torch_fixtures.py), so no
    load races another worker's in-place build of ``_native.so``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native runtime cannot build")
    assert native.available() and jnative.available()


def _write(tmp_path, name, text):
    p = tmp_path / name
    if isinstance(text, bytes):
        p.write_bytes(text)
    else:
        p.write_text(text)
    return str(p)


# -- parse_tns ---------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_parse_tns_matches_jax(native_lib, name, tmp_path):
    tt = gen.fixture_tensor(name)
    path = str(tmp_path / "t.tns")
    jio.save(tt, path)
    got, want = native.parse_tns(path), jnative.parse_tns(path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64
    np.testing.assert_array_equal(got[0] - 1, tt.inds)
    # io.load takes it, and equals the JAX package's load and the
    # Python parse
    a, b = tio.load(path), jio.load(path)
    np.testing.assert_array_equal(a.inds, b.inds)
    np.testing.assert_array_equal(a.vals, b.vals)
    assert a.dims == b.dims
    py = tio.parse_text_python(path)
    np.testing.assert_array_equal(py[0], got[0])
    np.testing.assert_array_equal(py[1], got[1])


@pytest.mark.parametrize("text", [
    "# hdr\n\n  # indented comment\n1 2 1 1.5\n2 1 2 -2.5e-1\n",
    b"1 1 1 2.0\n2 2 2 3.0",                  # no trailing newline
    "0 1 0 1.5\n\n2 0 1 -2.0\n",              # 0-indexed
    "1\t2  3 0.5\r\n4 5 6 7e-3\r\n",          # tabs, CRLF
], ids=["comments", "no_newline", "zero_indexed", "tabs_crlf"])
def test_parse_tns_layouts_match_jax(native_lib, text, tmp_path):
    path = _write(tmp_path, "t.tns", text)
    got, want = native.parse_tns(path), jnative.parse_tns(path)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    a, b = tio.load(path), jio.load(path)
    np.testing.assert_array_equal(a.inds, b.inds)
    assert a.dims == b.dims


BAD_ROWS = {
    "ragged": "1 2 3\n1 1 1 5.0\n",
    "short": "1 2 3 0.5\n1 2 0.7\n",
    "nonnumeric": "1 a 1 5.0\n",
    "extra": "1 2 3 0.5\n1 2 3 0.5 9\n",
}


@pytest.mark.parametrize("kind", sorted(BAD_ROWS))
def test_malformed_rows_raise_as_in_jax(native_lib, kind, tmp_path):
    path = _write(tmp_path, "bad.tns", BAD_ROWS[kind])
    with pytest.raises(ValueError):
        jnative.parse_tns(path)
    with pytest.raises(ValueError):
        native.parse_tns(path)
    # io.load names what the Python pass finds, as the JAX package does
    with pytest.raises(ValueError) as want:
        jio.load(path)
    with pytest.raises(ValueError) as got:
        tio.load(path)
    assert str(got.value) == str(want.value)


def test_parse_tns_declines_what_python_parses(native_lib, tmp_path):
    """A file whose first row has one field, or that cannot be opened, is
    left to the caller (None), as in the JAX package."""
    path = _write(tmp_path, "one.tns", "5\n")
    assert native.parse_tns(path) is None
    assert jnative.parse_tns(path) is None
    assert native.parse_tns(str(tmp_path / "missing.tns")) is None


# -- stream_to_bin -----------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES + ["small4_zeroidx"])
def test_stream_to_bin_bytes_equal_jax(native_lib, name, tensors_dir,
                                       tmp_path):
    src = str(tensors_dir / f"{name}.tns")
    got, want = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    assert native.stream_to_bin(src, got)
    assert jnative.stream_to_bin(src, want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    # the port's loaders read it back as the text
    mm, txt = tio.load_memmap(got), tio.load(src)
    np.testing.assert_array_equal(np.asarray(mm.inds), txt.inds)
    np.testing.assert_array_equal(np.asarray(mm.vals), txt.vals)
    assert mm.dims == txt.dims
    # and the in-memory save writes the same bytes
    tio.save(txt, str(tmp_path / "s.bin"))
    with open(got, "rb") as f, open(tmp_path / "s.bin", "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("text", [
    "# hdr\n0 1 0 1.5\n\n2 0 1 -2.0",
    "1 1 1 1.0\n3 2 5 2.0\n",
], ids=["zero_indexed_no_newline", "one_indexed"])
def test_stream_to_bin_layouts_match_jax(native_lib, text, tmp_path):
    src = _write(tmp_path, "z.tns", text)
    got, want = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    assert native.stream_to_bin(src, got)
    assert jnative.stream_to_bin(src, want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("kind", sorted(BAD_ROWS) + ["negative", "empty"])
def test_stream_to_bin_refuses_and_leaves_nothing(native_lib, kind,
                                                  tmp_path):
    text = dict(BAD_ROWS, negative="1 -3 1 2.5\n", empty="# only\n")[kind]
    src = _write(tmp_path, "bad.tns", text)
    for mod, name in ((native, "p.bin"), (jnative, "j.bin")):
        dst = tmp_path / name
        dst.write_bytes(b"SPTT stale")
        with pytest.raises(ValueError):
            mod.stream_to_bin(src, str(dst))
        assert not dst.exists()


def test_stream_to_bin_open_failures_raise_oserror(native_lib, tmp_path):
    src = _write(tmp_path, "ok.tns", "1 1 1 1.0\n")
    for mod in (native, jnative):
        with pytest.raises(OSError):
            mod.stream_to_bin(str(tmp_path / "missing.tns"),
                              str(tmp_path / "x.bin"))
        with pytest.raises(OSError):
            mod.stream_to_bin(src, str(tmp_path / "no_dir" / "x.bin"))


def test_cli_convert_streams_to_bin(native_lib, tensors_dir, tmp_path):
    src = str(tensors_dir / "med.tns")
    out = str(tmp_path / "med.bin")
    r = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli",
                        "convert", src, "bin", out], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"wrote bin (streamed): {out}"
    want = str(tmp_path / "j.bin")
    jnative.stream_to_bin(src, want)
    with open(out, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    # a .bin source is loaded and written whole
    again = str(tmp_path / "again.bin")
    r = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli",
                        "convert", out, "bin", again], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == f"wrote bin: {again}"


# -- the host MTTKRP ---------------------------------------------------------


def _layouts(dims, nnz, dtype, seed=0, **kw):
    rng = np.random.default_rng(seed)
    inds = np.stack([rng.integers(0, d, nnz) for d in dims])
    tt = tcoo.SparseTensor(inds, rng.random(nnz), dims).deduplicate()
    opts = Options(val_dtype=dtype, nnz_block=256, random_seed=1,
                   block_alloc=BlockAlloc.TWOMODE, **kw)
    return tt, BlockedSparse.from_coo(tt, opts, device="cpu")


@pytest.mark.parametrize("dims,dtype", [
    ((40, 30, 50), torch.float32), ((40, 30, 50), torch.float64),
    ((20, 16, 12, 10), torch.float64), ((60, 45), torch.float32)],
    ids=["3mode_f32", "3mode_f64", "4mode_f64", "2mode_f32"])
def test_native_mttkrp_matches_jax_and_plain(native_lib, dims, dtype):
    tt, bs = _layouts(dims, 3000, dtype)
    rng = np.random.default_rng(4)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    facs = [rng.random((d, 9)).astype(np_dt) for d in dims]
    tfacs = [torch.from_numpy(f) for f in facs]
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    for m in range(len(dims)):
        lay = bs.layout_for(m)
        assert native_runnable(lay, tfacs)
        assert plan_mttkrp(bs, tfacs, m, impl="native").engine == "native"
        got = mttkrp(bs, tfacs, m, impl="native")
        assert got.dtype == dtype
        # the JAX package's engine on the same arrays (its library is
        # built with -march=native, which may contract into FMAs)
        want = jnative.mttkrp(lay.inds.numpy(), lay.vals.numpy(), facs, m,
                              dims, sorted_by_mode=(m == lay.mode),
                              nnz=lay.nnz)
        gold = mttkrp_stream(torch.from_numpy(tt.inds),
                             torch.from_numpy(tt.vals), tfacs, m, dims[m])
        scale = float(gold.abs().max())
        assert float(np.abs(got.numpy() - want).max()) <= tol * scale
        # and the port's plain MTTKRP (the chain) and the stream oracle
        plain = mttkrp(bs, tfacs, m)
        assert float((got - plain).abs().max()) <= tol * scale
        assert float((got - gold).abs().max()) <= tol * scale


def test_native_mttkrp_never_reads_the_padding(native_lib):
    """The padded tail, poisoned with in-range rows and huge values, is
    never read (≙ tests/test_native.py:213-256)."""
    rng = np.random.default_rng(5)
    dims, nnz, rank = (11, 7, 9), 100, 6
    inds = np.stack([rng.integers(0, d, nnz) for d in dims])
    vals = rng.random(nnz)
    fac = [rng.random((d, rank)) for d in dims]
    pinds = np.ones((3, 256), dtype=np.int32)
    pinds[:, :nnz] = inds
    pvals = np.full(256, 1e30)
    pvals[:nnz] = vals
    for mode in range(3):
        gold = mttkrp_stream(torch.from_numpy(inds), torch.from_numpy(vals),
                             [torch.from_numpy(f) for f in fac], mode,
                             dims[mode]).numpy()
        for sorted_by_mode in (False, True):
            si, sv = pinds.copy(), pvals.copy()
            if sorted_by_mode:
                order = np.argsort(pinds[mode, :nnz], kind="stable")
                si[:, :nnz] = pinds[:, :nnz][:, order]
                sv[:nnz] = pvals[:nnz][order]
            got = native.mttkrp(si, sv, fac, mode, dims,
                                sorted_by_mode=sorted_by_mode, nnz=nnz)
            want = jnative.mttkrp(si, sv, fac, mode, dims,
                                  sorted_by_mode=sorted_by_mode, nnz=nnz)
            np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
            np.testing.assert_allclose(got, gold, atol=1e-10, rtol=0)


def test_native_mttkrp_declines_what_jax_declines(native_lib):
    rng = np.random.default_rng(6)
    dims = (5, 4, 3)
    inds = np.stack([rng.integers(0, d, 50) for d in dims]).astype(np.int32)
    vals = rng.random(50).astype(np.float32)
    fac64 = [rng.random((d, 4)) for d in dims]
    for mod in (native, jnative):
        assert mod.mttkrp(inds, vals, fac64, 0, dims, sorted_by_mode=False,
                          nnz=50) is None
        assert mod.mttkrp(inds, vals.astype(np.float16),
                          [f.astype(np.float16) for f in fac64], 0, dims,
                          sorted_by_mode=False, nnz=50) is None


def test_impl_native_declines_balanced_and_compact_layouts(native_lib):
    """The gate: balanced packing's mid-stream pads, a compact v2 layout,
    mixed dtypes and a forced path leave the call to the chain."""
    dims = (40, 30, 50)
    facs = [torch.rand(d, 5, dtype=torch.float64) for d in dims]
    for kw in (dict(fiber_packing="balanced"), dict(idx_width="u16")):
        tt, bs = _layouts(dims, 2000, torch.float64, **kw)
        for m in range(3):
            assert not native_runnable(bs.layout_for(m), facs)
            assert plan_mttkrp(bs, facs, m, impl="native").engine != "native"
            torch.testing.assert_close(mttkrp(bs, facs, m, impl="native"),
                                       mttkrp(bs, facs, m), rtol=0, atol=0)
    _, bs = _layouts(dims, 2000, torch.float64)
    lay = bs.layout_for(0)
    assert not native_runnable(lay, [f.float() for f in facs])
    assert not native_runnable(lay, facs, path="sorted_scatter")
    assert run_native(lay, facs, 0) is not None


def test_impl_native_refuses_tensors_off_the_cpu():
    """The host engine never copies from a device: a tensor elsewhere
    (here the meta device, as a card's would) raises."""
    dims = (40, 30, 50)
    _, bs = _layouts(dims, 2000, torch.float64)
    facs = [torch.rand(d, 5, dtype=torch.float64) for d in dims]
    off = [f.to("meta") for f in facs]
    with pytest.raises(ValueError, match="CPU tensors only"):
        mttkrp(bs, off, 0, impl="native")
    with pytest.raises(ValueError, match="CPU tensors only"):
        run_native(bs.layout_for(0), off, 0)
    with pytest.raises(ValueError, match="unknown impl"):
        mttkrp(bs, facs, 0, impl="pallas")


def test_native_plan_refuses_tensors_off_the_cpu():
    """plan_mttkrp names the dispatch mttkrp runs: for a tensor off the
    CPU it raises as mttkrp does, never reporting a host plan."""
    dims = (40, 30, 50)
    _, bs = _layouts(dims, 2000, torch.float64)
    facs = [torch.rand(d, 5, dtype=torch.float64) for d in dims]
    assert plan_mttkrp(bs, facs, 0, impl="native").engine == "native"
    with pytest.raises(ValueError, match="CPU tensors only"):
        plan_mttkrp(bs, [f.to("meta") for f in facs], 0, impl="native")


# -- interop and version -----------------------------------------------------


def test_interop_matches_jax():
    tt = gen.fixture_tensor("med")
    t = torch.sparse_coo_tensor(torch.from_numpy(tt.inds),
                                torch.from_numpy(tt.vals), tt.dims,
                                check_invariants=True)
    got, want = interop.from_torch(t), jinterop.from_torch(t)
    np.testing.assert_array_equal(got.inds, want.inds)
    np.testing.assert_array_equal(got.vals, want.vals)
    assert got.dims == want.dims
    dense = torch.from_numpy(np.arange(24.0).reshape(2, 3, 4) % 5)
    got, want = interop.from_torch(dense), jinterop.from_torch(dense)
    np.testing.assert_array_equal(got.inds, want.inds)
    np.testing.assert_array_equal(got.vals, want.vals)
    back = interop.to_torch(tcoo.SparseTensor(tt.inds, tt.vals, tt.dims))
    jback = jinterop.to_torch(tt)
    assert torch.equal(back.to_dense(), jback.to_dense())
    mat = sp.random(30, 20, density=0.2, random_state=np.random.default_rng(3),
                    format="csr")
    got, want = interop.from_scipy(mat), jinterop.from_scipy(mat)
    np.testing.assert_array_equal(got.inds, want.inds)
    np.testing.assert_array_equal(got.vals, want.vals)
    port_tt = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    for m in range(tt.nmodes):
        a, b = interop.unfold_to_scipy(port_tt, m), \
            jinterop.unfold_to_scipy(tt, m)
        assert a.shape == b.shape and (a != b).nnz == 0


def test_interop_mttkrp_and_cpd():
    tt = gen.fixture_tensor("med")
    t = torch.sparse_coo_tensor(torch.from_numpy(tt.inds),
                                torch.from_numpy(tt.vals), tt.dims,
                                check_invariants=True)
    rng = np.random.default_rng(2)
    facs = [torch.from_numpy(rng.random((d, 4))) for d in tt.dims]
    for m in range(3):
        got = interop.mttkrp_torch(t, facs, m)
        want = jinterop.mttkrp_torch(t, facs, m)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-10)
    factors, lam, fit = interop.cpd_als_torch(
        t, 3, Options(max_iterations=3, tolerance=0.0, random_seed=1,
                      val_dtype=torch.float64), device="cpu")
    assert [tuple(f.shape) for f in factors] == [(d, 3) for d in tt.dims]
    assert lam.shape == (3,) and 0.0 < fit <= 1.0
    factors[0].zero_()         # a copy: the result is the caller's


def test_version_matches_jax():
    import splatt_tpu_torch

    assert (version.version_major, version.version_minor,
            version.version_patch) == (jversion.version_major,
                                       jversion.version_minor,
                                       jversion.version_patch)
    assert splatt_tpu_torch.__version__ == jversion.__version__
    r = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli", "-V"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0
    assert r.stdout.strip() == f"splatt_tpu_torch {jversion.__version__}"
