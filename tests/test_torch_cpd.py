"""The port's cpd_als against splatt_tpu.cpd_als from the same numpy init
(f64: fit within 1e-9, λ and factors within 1e-8), and its CLI."""

import numpy as np
import pytest
import torch

from splatt_tpu import cpd_als as jax_cpd_als
from splatt_tpu.blocked import BlockedSparse as JBlocked
from splatt_tpu.config import BlockAlloc as JAlloc
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.io import read_matrix
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import state
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.cli import main as cli_main
from splatt_tpu_torch.config import BlockAlloc, Options, Verbosity
from splatt_tpu_torch.cpd import cpd_als
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("alloc", [BlockAlloc.TWOMODE, BlockAlloc.ALLMODE])
def test_cpd_matches_jax(alloc, iters):
    tt = gen.fixture_tensor("med")
    rank = 6
    rng = np.random.default_rng(11)
    init = [rng.random((d, rank)) for d in tt.dims]
    jopts = JOptions(block_alloc=JAlloc(alloc.value), nnz_block=256,
                     max_iterations=iters, tolerance=0.0,
                     val_dtype=np.float64, verbosity=JVerbosity.NONE,
                     autotune=False)
    want = jax_cpd_als(JBlocked.from_coo(tt, jopts), rank, jopts, init=init)
    opts = Options(block_alloc=alloc, nnz_block=256, max_iterations=iters,
                   tolerance=0.0, val_dtype=torch.float64,
                   verbosity=Verbosity.NONE)
    bs = BlockedSparse.from_coo(tcoo.SparseTensor(tt.inds, tt.vals, tt.dims),
                                opts, device="cpu")
    got = state.to_numpy(cpd_als(bs, rank, opts, init=init, device="cpu"))
    want = state.to_numpy(state.kruskal_from_numpy(
        [np.asarray(U) for U in want.factors], np.asarray(want.lam),
        float(want.fit), device="cpu"))
    assert len(got["fits"]) == iters
    assert got["fit"] == pytest.approx(want["fit"], abs=1e-9)
    np.testing.assert_allclose(got["lam"], want["lam"], atol=1e-8, rtol=0)
    for g, w in zip(got["factors"], want["factors"]):
        np.testing.assert_allclose(g, w, atol=1e-8, rtol=0)


def test_cli_cpd_writes_readable_outputs(tensors_dir, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli_main(["cpd", str(tensors_dir / "med.tns"), "-r", "4", "-i",
                     "3", "--seed", "5", "--device", "cpu", "-o",
                     str(out)]) == 0
    text = capsys.readouterr().out
    assert text.count("fit = ") == 3 and "Final fit" in text
    dims = gen.fixture_tensor("med").dims
    for m, d in enumerate(dims):
        U = read_matrix(str(out / f"mode{m + 1}.mat"))
        assert U.shape == (d, 4) and np.isfinite(U).all()
    lam = read_matrix(str(out / "lambda.mat")).ravel()
    assert lam.shape == (4,) and (lam > 0).all()
