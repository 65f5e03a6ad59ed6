"""The port's host build and preprocessing against the JAX package's, on
the CPU: the native sort, the COO methods, ``.bin`` I/O, the statistics,
the conversions and the CLI verbs ``check``, ``convert``, ``reorder`` and
``stats``, with the ``cpd`` verb's flags.

Same numpy inputs through both packages: permutations, tensors, files
(byte for byte) and printed text are equal.  Whether ``g++`` exists is
decided inside the tests that build the native sort.
"""

import contextlib
import io
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from splatt_tpu import io as jio
from splatt_tpu import stats as jstats
from splatt_tpu.cli import main as jax_cli
from splatt_tpu.config import Options as JOptions
from splatt_tpu.convert import convert as jax_convert
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.parallel.grid import GridDecomp as JGrid
from splatt_tpu.utils import env as jenv
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import io as tio
from splatt_tpu_torch import native
from splatt_tpu_torch import stats as tstats
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.cli import main as port_cli
from splatt_tpu_torch.config import BlockAlloc, Options, Verbosity
from splatt_tpu_torch.convert import CONVERT_TYPES, convert
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.parallel.grid import GridDecomp
from splatt_tpu_torch.utils import env as tenv
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

FIXTURES = ["small", "med", "small4", "med4", "med5"]


def _pair(name):
    jt = gen.fixture_tensor(name)
    return jt, tcoo.SparseTensor(jt.inds, jt.vals, jt.dims)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native sort cannot build")


# -- the native sort ---------------------------------------------------------------


def _awkward_tensors():
    """Dims of 1, long modes, duplicates, an empty tensor, and secondary
    spans too wide for one 128-bit key (the lexicographic branch)."""
    rng = np.random.default_rng(8)
    out = []
    for dims, nnz in (((1, 7, 5), 200), ((3, 1, 1), 50), ((2**20, 3, 9), 5000),
                      ((5, 4, 3, 2, 6), 3000), ((4, 5, 6), 0),
                      ((5, 2**45, 2**45, 2**45), 2000)):
        inds = np.stack([rng.integers(0, min(d, 40), nnz) for d in dims])
        out.append((inds, rng.random(nnz), dims))
    inds = np.stack([rng.integers(0, 3, 4000) for _ in range(3)])
    out.append((inds, rng.random(4000), (3, 3, 3)))    # heavy duplicates
    return out


def test_native_sort_matches_lexsort_and_jax():
    _need_gxx()
    assert native.available()
    for inds, vals, dims in _awkward_tensors():
        tt = tcoo.SparseTensor(inds, vals, dims)
        jt = JSparse(inds, vals, dims)
        nmodes = len(dims)
        for lead in range(nmodes):
            order = [lead] + [m for m in range(nmodes) if m != lead]
            for tail in (order[1:], order[1:][::-1]):
                full = [lead] + tail
                want = np.lexsort(tuple(inds[m] for m in reversed(full)))
                got = native.sort_perm(inds, dims, full)
                np.testing.assert_array_equal(tt.sort_order(full), want)
                if dims[lead] > native.MAX_BUCKETS:
                    # a lead mode too long for the counting buckets
                    # declines to lexsort (the JAX package's native sort
                    # would allocate its buckets)
                    assert got is None
                    continue
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(jt.sort_order(full), want)


def test_native_sort_declines_what_it_cannot_sort():
    _need_gxx()
    rng = np.random.default_rng(1)
    inds = np.stack([rng.integers(0, 9, 300) for _ in range(3)])
    # a partial order leaves the other modes unordered: lexsort's job
    assert native.sort_perm(inds, (9, 9, 9), [1, 0]) is None
    assert native.sort_perm(inds, (9, 9, 9), [0, 0, 1]) is None
    tt = tcoo.SparseTensor(inds, rng.random(300), (9, 9, 9))
    np.testing.assert_array_equal(tt.sort_order([1, 0]),
                                  np.lexsort((inds[0], inds[1])))
    # an index outside its dim declines, and the fallback still sorts
    bad = inds.copy()
    bad[2, 5] = 9
    assert native.sort_perm(bad, (9, 9, 9), [0, 1, 2]) is None
    tt = tcoo.SparseTensor(bad, rng.random(300), (9, 9, 9))
    np.testing.assert_array_equal(
        tt.sort_order([0, 1, 2]), np.lexsort((bad[2], bad[1], bad[0])))
    # int32 (memory-mapped) indices sort as int64 ones
    np.testing.assert_array_equal(
        native.sort_perm(inds.astype(np.int32), (9, 9, 9), [2, 0, 1]),
        np.lexsort((inds[1], inds[0], inds[2])))


def test_native_build_is_private_then_renamed(tmp_path, monkeypatch):
    """Two processes building into one empty directory at once both load
    a whole library: each writes a private name and renames it."""
    _need_gxx()
    code = ("import sys; from pathlib import Path;"
            "from splatt_tpu_torch import native;"
            "native.BUILD_DIR = Path(sys.argv[1]);"
            "print(native.available(), native.lib_path().name)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert [o[0] for o in outs] == ["True", "True"]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [outs[0][1]]    # no temporary left behind
    assert names[0].startswith("splatt_host-")


# -- COO -------------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_coo_methods_match_jax(name):
    jt, tt = _pair(name)
    assert tt.density() == jt.density()
    for m in range(tt.nmodes):
        assert tt.nslices_nonempty(m) == jt.nslices_nonempty(m)
        for g, w in zip(tt.unfold(m), jt.unfold(m)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    order = list(range(tt.nmodes))[::-1]
    s, js = tt.sorted_by(order), jt.sorted_by(order)
    np.testing.assert_array_equal(s.inds, js.inds)
    np.testing.assert_array_equal(s.vals, js.vals)
    dup = tcoo.SparseTensor(np.concatenate([tt.inds, tt.inds[:, :9]], 1),
                            np.concatenate([tt.vals, tt.vals[:9]]), tt.dims)
    jdup = JSparse(dup.inds, dup.vals, dup.dims)
    assert dup.count_duplicates() == jdup.count_duplicates() == 9
    rng = np.random.default_rng(0)
    perms = [rng.permutation(d) if m % 2 == 0 else None
             for m, d in enumerate(tt.dims)]
    np.testing.assert_array_equal(tt.permute(perms).inds,
                                  jt.permute(perms).inds)
    c = tt.copy()
    assert c == tt and c is not tt and c.inds is not tt.inds
    c.vals[0] += 1.0
    assert c != tt
    f = tcoo.SparseTensor.from_arrays(list(tt.inds), tt.vals)
    jf = JSparse.from_arrays(list(jt.inds), jt.vals)
    assert f.dims == jf.dims and f == tt.__class__(jf.inds, jf.vals, jf.dims)
    if np.prod(tt.dims) <= 1 << 20:
        np.testing.assert_array_equal(tt.to_dense(), jt.to_dense())


def test_coo_random_matches_jax():
    for dims, nnz, distinct in (((7, 8, 9), 300, True),
                                ((30, 20, 10, 5), 2000, False)):
        got = tcoo.SparseTensor.random(dims, nnz, seed=3, distinct=distinct)
        want = JSparse.random(dims, nnz, seed=3, distinct=distinct)
        np.testing.assert_array_equal(got.inds, want.inds)
        np.testing.assert_array_equal(got.vals, want.vals)


# -- .bin I/O ----------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_bin_round_trips_across_the_packages(name, tmp_path):
    jt, tt = _pair(name)
    tio.save(tt, str(tmp_path / "p.bin"))
    jio.save(jt, str(tmp_path / "j.bin"))
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    for path in ("p.bin", "j.bin"):
        got, want = tio.load(str(tmp_path / path)), jio.load(
            str(tmp_path / path))
        assert got == tt
        np.testing.assert_array_equal(got.inds, want.inds)
        np.testing.assert_array_equal(got.vals, want.vals)
        mm = tio.load_memmap(str(tmp_path / path))
        # a view of the mapped file, not a copy
        assert mm.inds.dtype == np.int32 and not mm.inds.flags.owndata
        assert mm.dims == tt.dims
        np.testing.assert_array_equal(mm.inds, tt.inds)
        np.testing.assert_array_equal(mm.vals, tt.vals)
    # the text writer, 1- and 0-indexed
    for one in (True, False):
        tio.save(tt, str(tmp_path / "p.tns"), one_indexed=one)
        jio.save(jt, str(tmp_path / "j.tns"), one_indexed=one)
        assert (tmp_path / "p.tns").read_bytes() == \
            (tmp_path / "j.tns").read_bytes()
        assert tio.load(str(tmp_path / "p.tns")) == tt


def test_bin_wide_indices_and_f32_values(tmp_path):
    dims = (3, 2**33, 4)
    inds = np.array([[0, 1, 2], [5, 2**32 + 7, 2**33 - 1], [0, 3, 1]])
    for vals in (np.array([1.5, -2.0, 3.25]),
                 np.array([1.5, -2.0, 3.25], dtype=np.float32)):
        tt = tcoo.SparseTensor(inds, vals, dims)
        tio.save(tt, str(tmp_path / "w.bin"))
        jio.save(JSparse(inds, vals, dims), str(tmp_path / "j.bin"))
        assert (tmp_path / "w.bin").read_bytes() == \
            (tmp_path / "j.bin").read_bytes()
        got = tio.load(str(tmp_path / "w.bin"))
        assert got == tt and got.vals.dtype == vals.dtype
        mm = tio.load_memmap(str(tmp_path / "w.bin"))
        assert mm.inds.dtype == np.int64
        np.testing.assert_array_equal(mm.inds, inds)


@pytest.mark.parametrize("cut", [3, 12, 30, 60, -5])
def test_torn_bin_refused_as_jax(tmp_path, cut):
    _, tt = _pair("small")
    tio.save(tt, str(tmp_path / "t.bin"))
    data = (tmp_path / "t.bin").read_bytes()
    (tmp_path / "t.bin").write_bytes(data[:cut])
    with pytest.raises(ValueError) as got:
        tio.load(str(tmp_path / "t.bin")) if cut > 4 else \
            tio.load_memmap(str(tmp_path / "t.bin"))
    with pytest.raises(ValueError) as want:
        jio.load(str(tmp_path / "t.bin")) if cut > 4 else \
            jio.load_memmap(str(tmp_path / "t.bin"))
    assert str(got.value) == str(want.value)


def test_matrix_and_permutation_files_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    perm = rng.permutation(17)
    tio.write_permutation(perm, str(tmp_path / "p"))
    jio.write_permutation(perm, str(tmp_path / "j"))
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    np.testing.assert_array_equal(tio.read_permutation(str(tmp_path / "p")),
                                  perm)
    mat = rng.random((5, 3))
    tio.write_matrix(mat, str(tmp_path / "m"))
    (tmp_path / "m2").write_text("# comment\n\n" +
                                 (tmp_path / "m").read_text())
    for name in ("m", "m2"):
        np.testing.assert_array_equal(tio.read_matrix(str(tmp_path / name)),
                                      jio.read_matrix(str(tmp_path / name)))
    np.testing.assert_array_equal(tio.read_matrix(str(tmp_path / "m")), mat)


# -- statistics and conversions ----------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_stats_text_matches_jax(name):
    jt, tt = _pair(name)
    assert tstats.tensor_stats(tt, "x") == jstats.tensor_stats(jt, "x")
    assert tstats.skew_stats(tt) == jstats.skew_stats(jt)
    assert tstats.skew_stats_text(tt) == jstats.skew_stats_text(jt)
    assert tstats.density_stats(tt) == jstats.density_stats(jt)
    assert tstats.density_stats_text(tt) == jstats.density_stats_text(jt)
    parts = np.random.default_rng(1).integers(0, 4, tt.nnz)
    assert tstats.partition_quality_text(tt, parts) == \
        jstats.partition_quality_text(jt, parts)
    with pytest.raises(ValueError, match="partition length"):
        tstats.partition_quality_text(tt, parts[:-1])


def test_grid_and_cpd_stats_text_match_jax():
    jt, tt = _pair("med")
    for grid, balance in (((2, 2, 2), False), ((4, 2, 1), True)):
        got = GridDecomp.build(tt, grid=grid, val_dtype=np.float64,
                               balance=balance)
        want = JGrid.build(jt, grid=grid, val_dtype=np.float64,
                           balance=balance)
        assert tstats.grid_stats_text(got) == jstats.grid_stats_text(want)
    opts = Options(nnz_block=256, random_seed=3, verbosity=Verbosity.NONE,
                   block_alloc=BlockAlloc.ALLMODE, val_dtype=torch.float64)
    bs = BlockedSparse.from_coo(tt, opts, device="cpu")
    jopts = JOptions(nnz_block=256, random_seed=3, autotune=False,
                     val_dtype=np.float64)
    from splatt_tpu.blocked import BlockedSparse as JBlocked
    from splatt_tpu.config import BlockAlloc as JAlloc

    jopts.block_alloc = JAlloc.ALLMODE
    jbs = JBlocked.from_coo(jt, jopts)
    got = tstats.cpd_stats_text(bs, 5, opts)
    want = jstats.cpd_stats_text(jbs, 5, jopts)
    assert got == want.replace("THREADS=XLA", "THREADS=torch")


@pytest.mark.parametrize("target", CONVERT_TYPES)
@pytest.mark.parametrize("name", ["small", "med4"])
def test_convert_targets_write_the_jax_files(name, target, tmp_path):
    jt, tt = _pair(name)
    for mode in range(tt.nmodes) if target in ("fibmat", "fibhgraph") \
            else (0,):
        convert(tt, target, str(tmp_path / "p"), mode=mode)
        jax_convert(jt, target, str(tmp_path / "j"), mode=mode)
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    with pytest.raises(ValueError, match="unknown convert target"):
        convert(tt, "png", str(tmp_path / "p"))


def test_env_helpers_match_jax(monkeypatch):
    for name in ("SPLATT_FIBER_PACKING", "SPLATT_REORDER"):
        assert tenv.ENV_VARS[name].default == jenv.ENV_VARS[name].default
        monkeypatch.delenv(name, raising=False)
        assert tenv.read_env(name) == jenv.read_env(name)
        monkeypatch.setenv(name, "")
        assert tenv.read_env(name) == jenv.read_env(name) == ""
    with pytest.raises(KeyError):
        tenv.read_env("SPLATT_NOT_DECLARED")
    for a in ([], [0, 0], [1, 2, 3], [5], [0.5, 7.25, 0]):
        assert tenv.max_mean_ratio(a) == jenv.max_mean_ratio(a)


# -- the CLI -------------------------------------------------------------------------


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _same_cli(tmp_path, argv, outputs=()):
    """Run one verb through both CLIs (the JAX one writing into j/, the
    port's into p/): the same exit code, text and output files."""
    res = {}
    for tag, main in (("p", port_cli), ("j", jax_cli)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        args = [a.replace("{out}", str(d)) for a in argv]
        rc, text = _run(main, args)
        res[tag] = (rc, text.replace(str(d), "{out}"),
                    [(d / o).read_bytes() for o in outputs])
    return res["p"], res["j"]


@pytest.mark.parametrize("name", ["small", "med", "small4",
                                  "small4_zeroidx"])
def test_cli_check_stats_reorder_match_jax(name, tensors_dir, tmp_path):
    src = str(tensors_dir / f"{name}.tns")
    got, want = _same_cli(tmp_path, ["check", src])
    assert got == want
    got, want = _same_cli(tmp_path, ["check", src, "--fix", "{out}/f.tns"],
                          ["f.tns"])
    assert got == want
    got, want = _same_cli(tmp_path, ["stats", src])
    assert got == want
    tt = tio.load(src)
    part = tmp_path / "part"
    part.write_text("\n".join(str(i % 3) for i in range(tt.nnz)) + "\n")
    got, want = _same_cli(tmp_path, ["stats", src, "-p", str(part)])
    assert got == want
    for how in ("random", "graph", "hgraph", "fibsched"):
        got, want = _same_cli(
            tmp_path, ["reorder", src, how, "{out}/r.tns", "--seed", "4",
                       "--write-perms"],
            ["r.tns"] + [f"r.tns.perm{m}" for m in range(tt.nmodes)
                         if how != "fibsched" or m == int(np.argmin(tt.dims))])
        assert got == want


def test_cli_check_flags_duplicates_and_empty_slices(tmp_path):
    bad = tmp_path / "bad.tns"
    bad.write_text("1 1 1 1.0\n1 1 1 2.0\n3 3 3 1.0\n")
    got, want = _same_cli(tmp_path, ["check", str(bad), "--fix",
                                     "{out}/f.bin"], ["f.bin"])
    assert got == want and got[0] == 1
    assert "duplicates: 1  empty slices: 3" in got[1]


@pytest.mark.parametrize("target", CONVERT_TYPES)
def test_cli_convert_matches_jax(target, tensors_dir, tmp_path):
    src = str(tensors_dir / "med4.tns")
    for mode in ("0", "2"):
        got, want = _same_cli(tmp_path, ["convert", src, target,
                                         "{out}/c", "-m", mode], ["c"])
        # both CLIs stream text to .bin through their native converter
        assert got == want
    # a .bin input converts the same way
    tio.save(tio.load(src), str(tmp_path / "in.bin"))
    got, want = _same_cli(tmp_path, ["convert", str(tmp_path / "in.bin"),
                                     target, "{out}/c"], ["c"])
    assert got == want


def _cpd_json(argv, env=None):
    r = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli", "cpd",
                        *argv, "--device", "cpu", "--json"],
                       capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout, json.loads(r.stdout.strip().splitlines()[-1])


def test_cli_cpd_outdir_writes_as_the_directory_stem(tensors_dir, tmp_path):
    import os

    common = ["cpd", str(tensors_dir / "small.tns"), "-r", "2", "-i", "2",
              "--seed", "3", "--device", "cpu"]
    for flag in (["-o", str(tmp_path / "o")],
                 ["-s", str(tmp_path / "s") + os.sep]):
        rc, _ = _run(port_cli, common + flag)
        assert rc == 0
    names = sorted(p.name for p in (tmp_path / "o").iterdir())
    assert names == ["lambda.mat", "mode1.mat", "mode2.mat", "mode3.mat"]
    assert names == sorted(p.name for p in (tmp_path / "s").iterdir())
    for n in names:
        assert (tmp_path / "o" / n).read_bytes() == \
            (tmp_path / "s" / n).read_bytes()


def test_cli_cpd_flags_bin_mmap_and_reorder_env(tensors_dir, tmp_path):
    import os

    src = str(tensors_dir / "med.tns")
    tio.save(tio.load(src), str(tmp_path / "med.bin"))
    common = ["-r", "3", "-i", "3", "--seed", "5", "--f64", "--block",
              "256", "--reg", "0.01", "--mode-order", "bigfirst"]
    text, base = _cpd_json([src, *common, "-s", str(tmp_path / "run")])
    assert (tmp_path / "run.mode1.mat").exists()
    assert (tmp_path / "run.lambda.mat").exists()
    env = dict(os.environ, SPLATT_FIBER_PACKING="balanced",
               SPLATT_REORDER="hgraph")
    text, got = _cpd_json([str(tmp_path / "med.bin"), *common, "--mmap",
                           "--nowrite", "-v"], env=env)
    assert "reorder=hgraph" in text and "[balanced]" in text
    assert got["fit"] == pytest.approx(base["fit"], abs=1e-9)
    kinds = {e["kind"] for e in got["events"]}
    assert "layout_imbalance" in kinds
    assert [e["packing"] for e in got["events"]
            if e["kind"] == "layout_imbalance"] == ["balanced"] * 2
    # the same run in process, against the API under the same options
    tt = tio.load(src)
    opts = Options(max_iterations=3, random_seed=5, nnz_block=256,
                   regularization=0.01, val_dtype=torch.float64,
                   verbosity=Verbosity.NONE, fiber_packing="balanced",
                   reorder="hgraph")
    from splatt_tpu_torch.config import ModeOrder

    opts.mode_order = ModeOrder.BIGFIRST
    out = cpd_als(BlockedSparse.compile(tt, opts, device="cpu"), 3, opts,
                  device="cpu")
    assert out.fit == pytest.approx(got["fit"], abs=1e-12)
    for m in range(3):
        U = tio.read_matrix(str(tmp_path / f"run.mode{m + 1}.mat"))
        np.testing.assert_allclose(U, out.factors[m].numpy(), rtol=0,
                                   atol=1e-8)
    (tmp_path / "d").mkdir()
    _cpd_json([src, "-r", "2", "-i", "1", "-s", str(tmp_path / "d")])
    assert (tmp_path / "d" / "mode1.mat").exists()
