"""The port's out-of-core route (``parallel/common.py``'s streamed builds,
the streamed branches of FINE, MEDIUM and COARSE, the chunked upload and
``cpd --scratch-dir``) against the JAX package's, on the CPU.

The same numpy-seeded tensors through both packages, with small chunks
(97, 101, 613) so every multi-chunk branch runs: the streamed bucket
scatter, the counting-sort layouts, the streamed grid, COARSE and FINE
builds equal the JAX package's arrays exactly (and the in-memory builds),
memmapped under ``out_dir`` when one is given.  The three CPDs on a
memmapped ``.bin`` with a scratch directory match the JAX package's in f64
and leave their sorted layouts (``linds.npy``) under it; without one no
sort runs (the stream engine).
"""

import glob
import json
import os
import subprocess
import sys
import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import io as jio
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.parallel import common as jcommon
from splatt_tpu.parallel.coarse import _bucket_by_mode as jax_bucket_by_mode
from splatt_tpu.parallel.coarse import coarse_cpd_als as jax_coarse
from splatt_tpu.parallel.grid import GridDecomp as JGrid
from splatt_tpu.parallel.grid import grid_cpd_als as jax_grid
from splatt_tpu.parallel.sharded import shard_nnz_host as jax_shard_nnz_host
from splatt_tpu.parallel.sharded import sharded_cpd_als as jax_sharded
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import io as tio
from splatt_tpu_torch.config import (CommPattern, Decomposition, Options,
                                     Verbosity)
from splatt_tpu_torch import resilience
from splatt_tpu_torch.parallel import (coarse_cpd_als, distributed_cpd_als,
                                       grid_cpd_als, sharded_cpd_als)
from splatt_tpu_torch.parallel import common
from splatt_tpu_torch.parallel.coarse import _bucket_by_mode
from splatt_tpu_torch.parallel.grid import GridDecomp
from splatt_tpu_torch.parallel.sharded import shard_nnz_host
from tests.torch_fixtures import private_tune_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = 3
ITERS = 3


def _tensor(seed=0, nnz=5000, dims=(64, 40, 96), skew=False):
    """The same tensor for both packages (≙ tests/test_streamed_decomp.py's
    generator)."""
    rng = np.random.default_rng(seed)
    if skew:
        inds = np.stack([np.minimum(rng.zipf(1.3, nnz) - 1, d - 1)
                         for d in dims]).astype(np.int64)
    else:
        inds = np.stack([rng.integers(0, d, nnz)
                         for d in dims]).astype(np.int64)
    vals = rng.random(nnz)
    return (JSparse(inds=inds, vals=vals, dims=dims),
            tcoo.SparseTensor(inds, vals, dims))


def _memmaps(tmp_path, jt, name="t.bin"):
    """The tensor saved as ``.bin`` and mapped by both packages."""
    path = str(tmp_path / name)
    jio.save(jt, path, binary=True)
    return jio.load_memmap(path), tio.load_memmap(path)


def _equal(got, want):
    """Arrays (or tuples of them and scalars) equal exactly."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            assert a == b


# -- the streamed pieces -----------------------------------------------------


@pytest.mark.parametrize("disk", [False, True], ids=["ram", "out_dir"])
@pytest.mark.parametrize("chunk", [97, 701, 1 << 22])
def test_streamed_bucket_scatter_matches_jax(disk, chunk, tmp_path):
    jt, tt = _tensor()
    nb = 6

    def owner(ic, s):
        return (ic[0] * 7 + ic[1] + s % 3) % nb

    def post(placed):
        placed[2] %= 17
        return placed

    got = common.streamed_bucket_scatter(
        tt.inds, tt.vals, owner, nb, np.float64, chunk=chunk,
        out_dir=str(tmp_path / "p") if disk else None, postprocess=post)
    want = jcommon.streamed_bucket_scatter(
        jt.inds, jt.vals, owner, nb, np.float64, chunk=chunk,
        out_dir=str(tmp_path / "j") if disk else None, postprocess=post)
    _equal(got, want)
    assert isinstance(got[0], np.memmap) == disk
    assert isinstance(got[1], np.memmap) == disk
    if disk:
        assert sorted(os.listdir(tmp_path / "p")) == ["binds.npy",
                                                      "bvals.npy"]
    # the in-memory scatter, fed the same owners, gives the same buckets
    own = np.concatenate([owner(tt.inds[:, s:s + chunk], s)
                          for s in range(0, tt.nnz, chunk)])
    b, v, c, n = common.bucket_scatter(tt.inds, tt.vals, own, nb, np.float64)
    b[2] %= 17
    _equal(got, (b, v, c, n))


def test_streamed_bucket_scatter_refuses_bad_owners():
    jt, tt = _tensor(nnz=300)
    for mod, t in ((common, tt), (jcommon, jt)):
        with pytest.raises(ValueError, match="owner ids"):
            mod.streamed_bucket_scatter(t.inds, t.vals,
                                        lambda ic, s: ic[0] - 1, 4,
                                        np.float64, chunk=101)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("disk", [False, True], ids=["ram", "out_dir"])
def test_streamed_blocked_buckets_match_jax(mode, disk, tmp_path):
    jt, tt = _tensor(1, skew=True)
    owner = tt.inds[2] % 4
    binds, bvals, _, counts = common.bucket_scatter(tt.inds, tt.vals, owner,
                                                    4, np.float64)
    local = tt.dims[mode]
    got = common.streamed_blocked_buckets(
        binds, bvals, counts, mode, local, 256, chunk=101,
        out_dir=str(tmp_path / "p") if disk else None)
    want = jcommon.streamed_blocked_buckets(
        binds, bvals, counts, mode, local, 256, chunk=101,
        out_dir=str(tmp_path / "j") if disk else None)
    _equal(got, want)
    assert isinstance(got[0], np.memmap) == disk
    # bit for bit the in-memory stable argsort's layouts
    _equal(got, common.blocked_buckets(binds, bvals, counts, mode, local,
                                       256))


def test_build_bucket_layout_dispatches_on_memmapped_buckets(tmp_path):
    jt, tt = _tensor(5, nnz=600, dims=(12, 10, 14))
    b0, v0, _, n0 = common.bucket_scatter(tt.inds, tt.vals, tt.inds[0] % 3,
                                          3, np.float64)
    b1, v1, _, n1 = common.streamed_bucket_scatter(
        tt.inds, tt.vals, lambda ic, s: ic[0] % 3, 3, np.float64, chunk=101,
        out_dir=str(tmp_path / "bk"))
    with mock.patch.object(common, "streamed_blocked_buckets",
                           side_effect=AssertionError("streamed")):
        ram = common.build_bucket_layout(b0, v0, n0, 1, tt.dims[1], 128)
    with mock.patch.object(common, "blocked_buckets",
                           side_effect=AssertionError("in memory")):
        disk = common.build_bucket_layout(b1, v1, n1, 1, tt.dims[1], 128,
                                          out_dir=str(tmp_path / "lay"),
                                          chunk=97)
    assert not isinstance(ram[0], np.memmap)
    assert isinstance(disk[0], np.memmap) and isinstance(disk[1], np.memmap)
    assert common._memmap_dir(disk[0]) == str(tmp_path / "lay")
    _equal(disk, ram)
    jdisk = jcommon.build_bucket_layout(b1, v1, n1, 1, tt.dims[1], 128,
                                        out_dir=str(tmp_path / "jlay"),
                                        chunk=97)
    _equal(disk, jdisk)


@pytest.mark.parametrize("balance", [False, True, None])
@pytest.mark.parametrize("disk", [False, True], ids=["ram", "out_dir"])
def test_streamed_grid_build_matches_jax(balance, disk, tmp_path):
    jt, tt = _tensor(2, skew=balance is not False)
    kw = dict(grid=(2, 2, 2), val_dtype=np.float64, balance=balance,
              streamed=True, chunk=613)
    got = GridDecomp.build(tt, out_dir=str(tmp_path / "p") if disk else None,
                           **kw)
    want = JGrid.build(jt, out_dir=str(tmp_path / "j") if disk else None,
                       **kw)
    ram = GridDecomp.build(tt, grid=(2, 2, 2), val_dtype=np.float64,
                           balance=balance, streamed=False)
    for other in (want, ram):
        assert got.cell_nnz == other.cell_nnz and got.fill == other.fill
        assert got.dims_pad == other.dims_pad
        _equal((got.inds_local, got.vals, got.cell_counts),
               (np.asarray(other.inds_local), np.asarray(other.vals),
                other.cell_counts))
        assert (got.relabels is None) == (other.relabels is None)
        if got.relabels is not None:
            for a, b in zip(got.relabels, other.relabels):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    assert common.is_memmapped(got.inds_local) == disk


@pytest.mark.parametrize("disk", [False, True], ids=["ram", "out_dir"])
def test_streamed_grid_cell_layouts_match_jax(disk, tmp_path):
    """The cells' sorted layouts, by the counting sort beside memmapped
    cells (their default ``out_dir``), equal the JAX package's."""
    from splatt_tpu.config import BlockAlloc as JAlloc

    from splatt_tpu_torch.config import BlockAlloc

    jt, tt = _tensor(3)
    got = GridDecomp.build(tt, grid=(2, 2, 1), val_dtype=np.float64,
                           out_dir=str(tmp_path / "p") if disk else None,
                           chunk=613, streamed=True)
    want = JGrid.build(jt, grid=(2, 2, 1), val_dtype=np.float64,
                       out_dir=str(tmp_path / "j") if disk else None,
                       chunk=613, streamed=True)
    opts = Options(block_alloc=BlockAlloc.ALLMODE, nnz_block=256,
                   verbosity=Verbosity.NONE)
    jopts = JOptions(block_alloc=JAlloc.ALLMODE, nnz_block=256,
                     verbosity=JVerbosity.NONE)
    cl = got.build_cell_layouts(opts, chunk=101)
    jcl = want.build_cell_layouts(jopts, chunk=101)
    assert cl.mode_map == jcl.mode_map
    for a, b in zip(cl.layouts, jcl.layouts):
        for key in ("inds", "vals", "row_start"):
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))
        for key in ("block", "seg_width", "sort_mode", "sort_dim"):
            assert a[key] == b[key]
        assert common.is_memmapped(a["inds"]) == disk
    if disk:
        assert sorted(os.listdir(tmp_path / "p")) == [
            "binds.npy", "bvals.npy", "cells_m0", "cells_m1", "cells_m2"]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("disk", [False, True], ids=["ram", "out_dir"])
def test_streamed_coarse_buckets_match_jax(mode, disk, tmp_path):
    jt, tt = _tensor(4, skew=True)
    got = _bucket_by_mode(tt, mode, 4, np.float64, streamed=True, chunk=101,
                          out_dir=str(tmp_path / "p") if disk else None)
    want = jax_bucket_by_mode(jt, mode, 4, np.float64, streamed=True,
                              chunk=101,
                              out_dir=str(tmp_path / "j") if disk else None)
    _equal(got, tuple(np.asarray(x) if isinstance(x, np.ndarray) else x
                      for x in want))
    _equal(got, _bucket_by_mode(tt, mode, 4, np.float64, streamed=False))
    assert common.is_memmapped(got[0]) == disk


@pytest.mark.parametrize("part", ["equal", "array", "memmap"])
@pytest.mark.parametrize("disk", [False, True], ids=["ram", "out_dir"])
def test_streamed_shard_nnz_host_matches_jax(part, disk, tmp_path):
    jt, tt = _tensor(6, nnz=4003)
    partition = None
    if part != "equal":
        partition = np.random.default_rng(1).integers(0, 5, tt.nnz)
        if part == "memmap":
            np.save(tmp_path / "part.npy", partition)
            partition = np.load(tmp_path / "part.npy", mmap_mode="r")
    got = shard_nnz_host(tt, 5, np.float64, partition=partition,
                         streamed=True, chunk=97,
                         out_dir=str(tmp_path / "p") if disk else None)
    want = jax_shard_nnz_host(jt, 5, np.float64, partition=partition,
                              streamed=True, chunk=97,
                              out_dir=str(tmp_path / "j") if disk else None)
    _equal(got, tuple(np.asarray(x) for x in want))
    assert common.is_memmapped(got[0]) == disk
    if part != "equal":
        _equal(got, shard_nnz_host(tt, 5, np.float64, partition=partition,
                                   streamed=False))


def test_upload_copies_a_memmap_in_chunks(tmp_path):
    arr = np.lib.format.open_memmap(str(tmp_path / "a.npy"), mode="w+",
                                    dtype=np.int32, shape=(3, 1000))
    arr[:] = np.arange(3000, dtype=np.int32).reshape(3, 1000)
    arr.flush()
    ro = np.load(tmp_path / "a.npy", mmap_mode="r")
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no read-only from_numpy warning
        got = common.upload(ro[:, 10:990], "cpu", chunk=97)
        vals = common.upload(ro[1], "cpu", torch.float64, chunk=101)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ro[:, 10:990]))
    assert vals.dtype == torch.float64
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ro[1]))
    # an array in memory goes in one copy, as before
    ram = common.upload(np.arange(5.0), "cpu", torch.float32)
    assert ram.dtype == torch.float32 and ram.tolist() == [0, 1, 2, 3, 4]


# -- the CPDs ----------------------------------------------------------------


def _opts(**kw):
    return Options(max_iterations=ITERS, tolerance=0.0,
                   val_dtype=torch.float64, verbosity=Verbosity.NONE,
                   random_seed=1, **kw)


def _jopts(**kw):
    return JOptions(max_iterations=ITERS, tolerance=0.0,
                    val_dtype=np.float64, verbosity=JVerbosity.NONE,
                    random_seed=1, **kw)


CPDS = {
    "medium": (lambda t, init, d: grid_cpd_als(
        t, RANK, grid=(2, 2, 2), opts=_opts(), init=init, out_dir=d,
        device="cpu"),
        lambda t, init, d: jax_grid(t, RANK, grid=(2, 2, 2), opts=_jopts(),
                                    init=[jnp.asarray(u) for u in init],
                                    out_dir=d)),
    "fine": (lambda t, init, d: sharded_cpd_als(
        t, RANK, opts=_opts(), init=init, out_dir=d, device="cpu"),
        lambda t, init, d: jax_sharded(t, RANK, opts=_jopts(),
                                       init=[jnp.asarray(u) for u in init],
                                       out_dir=d)),
    "coarse": (lambda t, init, d: coarse_cpd_als(
        t, RANK, opts=_opts(), init=init, out_dir=d, device="cpu"),
        lambda t, init, d: jax_coarse(t, RANK, opts=_jopts(),
                                      init=[jnp.asarray(u) for u in init],
                                      out_dir=d)),
}


@pytest.mark.parametrize("kind", sorted(CPDS))
def test_cpds_on_a_memmap_with_scratch_match_jax(kind, tmp_path):
    jt, tt = _tensor(9, nnz=2000, dims=(24, 18, 30))
    jmm, mm = _memmaps(tmp_path, jt)
    init = [np.random.default_rng(7).random((d, RANK)) for d in tt.dims]
    port, jax_run = CPDS[kind]
    d = str(tmp_path / "scratch")
    got = port(mm, init, d)
    want = jax_run(jmm, init, str(tmp_path / "jscratch"))
    assert len(got.fits) == ITERS
    assert float(got.fit) == pytest.approx(float(want.fit), abs=1e-10)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                               rtol=1e-10, atol=0)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)
    # the blocked engine ran on sorted layouts memmapped under the scratch
    # directory, and the in-memory build gives the same model
    assert glob.glob(os.path.join(d, "**", "linds.npy"), recursive=True)
    ram = port(tt, init, None)
    assert float(ram.fit) == pytest.approx(float(got.fit), abs=1e-12)
    for a, b in zip(got.factors, ram.factors):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def _engine(run):
    """The result of `run` and the ``local_engine`` event its driver
    recorded: (engine, out_of_core)."""
    resilience.run_report().clear()
    out = run()
    (ev,) = resilience.run_report().events("local_engine")
    return out, (ev["engine"], ev["out_of_core"])


@pytest.mark.parametrize("kind", sorted(CPDS))
def test_memmap_without_scratch_runs_neither_sort(kind, tmp_path):
    """The lean rule (≙ tests/test_streamed_decomp.py:159-201): a
    memmapped tensor without a scratch directory takes the stream engine,
    so neither layout sort runs; with one it takes the blocked engine."""
    jt, tt = _tensor(2, nnz=800, dims=(16, 12, 20))
    _, mm = _memmaps(tmp_path, jt)
    init = [np.random.default_rng(3).random((d, RANK)) for d in tt.dims]
    port, _ = CPDS[kind]
    with mock.patch.object(common, "blocked_buckets",
                           side_effect=AssertionError("in-memory sort")), \
            mock.patch.object(common, "streamed_blocked_buckets",
                              side_effect=AssertionError("streamed sort")):
        lean, engine = _engine(lambda: port(mm, init, None))
    assert engine == ("stream", None)
    d = str(tmp_path / "s")
    sorted_, engine = _engine(lambda: port(mm, init, d))
    assert engine == ("blocked", d)
    assert float(lean.fit) == pytest.approx(float(sorted_.fit), abs=1e-10)
    _, engine = _engine(lambda: port(tt, init, d))
    assert engine == ("blocked", None)


def test_distributed_cpd_passes_the_scratch_dir(tmp_path):
    jt, tt = _tensor(8, nnz=1500, dims=(20, 16, 24))
    _, mm = _memmaps(tmp_path, jt)
    init = [np.random.default_rng(2).random((d, RANK)) for d in tt.dims]
    for decomp, sub in ((Decomposition.MEDIUM, "scatter"),
                        (Decomposition.COARSE, "mode0"),
                        (Decomposition.FINE, "shards")):
        d = str(tmp_path / decomp.value)
        out, engine = _engine(lambda: distributed_cpd_als(
            mm, RANK, _opts(decomposition=decomp), init=init, out_dir=d,
            device="cpu"))
        assert np.isfinite(out.fit) and os.path.isdir(os.path.join(d, sub))
        assert engine == ("blocked", d)
    # the FINE ring patterns are stream-only, whatever the scratch dir
    d = str(tmp_path / "ring")
    _, engine = _engine(lambda: distributed_cpd_als(
        mm, RANK, _opts(decomposition=Decomposition.FINE,
                        comm_pattern=CommPattern.POINT2POINT),
        init=init, out_dir=d, device="cpu"))
    assert engine == ("stream", d)
    _, engine = _engine(lambda: distributed_cpd_als(
        tt, RANK, _opts(), init=init, local_engine="stream", out_dir=d,
        device="cpu"))
    assert engine == ("stream", None)


@pytest.mark.parametrize("decomp,lean", [(Decomposition.FINE, "blocked"),
                                         (Decomposition.COARSE, "stream")])
def test_rowdist_relabels_a_memmap_in_memory(decomp, lean, tmp_path):
    """--rowdist balanced relabels the tensor in memory before any build,
    so the event says the build was not out of core, with or without a
    scratch directory, and nothing is written under it.  As in the JAX
    package, FINE picks its engine after the relabel and COARSE before
    it (on the memmap: stream without a scratch directory)."""
    jt, _ = _tensor(4, nnz=1200, dims=(20, 16, 24))
    _, mm = _memmaps(tmp_path, jt)
    init = [np.random.default_rng(5).random((d, RANK)) for d in mm.dims]
    d = str(tmp_path / "scratch")
    for out_dir, want in ((None, lean), (d, "blocked")):
        out, engine = _engine(lambda: distributed_cpd_als(
            mm, RANK, _opts(decomposition=decomp), init=init,
            row_distribute="balanced", out_dir=out_dir, device="cpu"))
        assert np.isfinite(out.fit) and engine == (want, None)
    assert not os.path.exists(d)


# -- the CLI -----------------------------------------------------------------


def _cli(args):
    return subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli",
                           *args], capture_output=True, text=True, cwd=REPO,
                          timeout=600)


def test_cli_out_of_core_route(tensors_dir, tmp_path):
    """convert (streamed) -> cpd --mmap --decomp medium --scratch-dir on
    the CPU: the same fits as the in-memory run; the plan line names the
    engine; --scratch-dir alone exits non-zero."""
    binp = str(tmp_path / "med.bin")
    r = _cli(["convert", str(tensors_dir / "med.tns"), "bin", binp])
    assert r.returncode == 0 and "wrote bin (streamed)" in r.stdout
    common_args = ["cpd", binp, "-r", "4", "-i", "3", "--seed", "3",
                   "--tol", "0", "--f64", "--device", "cpu", "--json",
                   "--nowrite", "--decomp", "medium", "--grid", "2x2x2"]
    scratch = str(tmp_path / "scratch")
    ooc = _cli(common_args + ["--mmap", "--scratch-dir", scratch])
    assert ooc.returncode == 0, ooc.stdout + ooc.stderr
    assert (f"per-rank engine: blocked, out of core under {scratch}"
            in ooc.stdout)
    assert glob.glob(os.path.join(scratch, "cells_m*", "linds.npy"))
    ram = _cli(common_args)
    assert ram.returncode == 0, ram.stderr
    assert "per-rank engine: blocked\n" in ram.stdout
    lean = _cli(common_args + ["--mmap"])
    assert lean.returncode == 0, lean.stderr
    assert "per-rank engine: stream\n" in lean.stdout

    def fits(r):
        return [line.split("fit = ")[1].split()[0]
                for line in r.stdout.splitlines() if "fit = " in line]

    assert fits(ooc) == fits(ram) and len(fits(ooc)) == 3
    assert json.loads(ooc.stdout.strip().splitlines()[-1])["fit"] == \
        json.loads(ram.stdout.strip().splitlines()[-1])["fit"]
    alone = _cli(["cpd", binp, "-r", "4", "-i", "1", "--device", "cpu",
                  "--mmap", "--nowrite", "--scratch-dir", scratch])
    assert alone.returncode != 0
    assert "--scratch-dir applies to distributed runs" in alone.stderr
