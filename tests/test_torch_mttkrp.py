"""The port's mttkrp on every path against the JAX oracle mttkrp_stream,
in f64 at 1e-10 (the repo's TOL)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu.ops.mttkrp import mttkrp_stream
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import BlockAlloc, Options
from splatt_tpu_torch.ops.mttkrp import _choose_path_bs, mttkrp
from tests import gen
from tests.test_mttkrp import TOL, make_factors
from tests.torch_fixtures import private_tune_cache  # noqa: F401

PATHS = ["stream", "sorted_onehot", "sorted_scatter", "privatized",
         "scatter"]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", ["small", "med", "small4", "med4", "med5"])
def test_mttkrp_path_matches_stream(name, path):
    tt = gen.fixture_tensor(name)
    jf = make_factors(tt.dims)
    tf = [torch.from_numpy(np.array(U)) for U in jf]
    X = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    if path != "stream":
        X = BlockedSparse.from_coo(X, Options(
            block_alloc=BlockAlloc.ALLMODE, nnz_block=128,
            val_dtype=torch.float64), device="cpu")
    for mode in range(tt.nmodes):
        if path in ("privatized", "scatter"):
            # gather through a layout sorted by another mode
            X.mode_map[mode] = (mode + 1) % tt.nmodes
        want = mttkrp_stream(jnp.asarray(tt.inds), jnp.asarray(tt.vals), jf,
                             mode, tt.dims[mode])
        got = mttkrp(X, tf, mode, path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=f"{path} mode={mode}")


def test_path_choice_is_device_independent():
    tt = gen.fixture_tensor("med")
    X = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    bs = BlockedSparse.from_coo(X, Options(nnz_block=128, priv_threshold=1),
                                device="cpu")
    # TWOMODE on (40, 36, 44): mode 1 and mode 2 own layouts, mode 0 is
    # short enough (40 <= nnz) to privatize
    assert [_choose_path_bs(bs, m) for m in range(3)] == \
        ["privatized", "sorted_onehot", "sorted_onehot"]
    bs.opts.onehot_cap = 0
    assert _choose_path_bs(bs, 1) == "sorted_scatter"
    bs.opts.priv_cap = 40
    assert _choose_path_bs(bs, 0) == "scatter"
