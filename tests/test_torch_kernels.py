"""fused_mttkrp_t: the port's plain version against the JAX Pallas kernel
(interpret mode), in f64 at 1e-10 (the repo's TOL).  The CUDA kernels
against their plain versions on a card: tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

from splatt_tpu.blocked import build_layout
from splatt_tpu.ops.pallas_kernels import fused_mttkrp_t
from splatt_tpu_torch import state
from splatt_tpu_torch.ops import kernels
from tests import gen
from tests.test_torch_kernels_gpu import contracts
from tests.test_mttkrp import TOL, make_factors


def port_layout(lay):
    return state.layout_from_numpy(
        np.asarray(lay.inds), np.asarray(lay.vals), np.asarray(lay.row_start),
        mode=lay.mode, dim=lay.dim, block=lay.block,
        seg_width=lay.seg_width, nnz=lay.nnz, device="cpu")


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("name,block,rank", [("med", 128, 8),
                                             ("med", 512, 20),
                                             ("med4", 256, 12)])
def test_plain_matches_pallas_interpret(name, block, rank, accumulate):
    tt = gen.fixture_tensor(name)
    jf = make_factors(tt.dims, rank=rank)
    tf = [torch.from_numpy(np.array(U)) for U in jf]
    lays = [build_layout(tt, m, block=block, val_dtype=np.float64)
            for m in range(tt.nmodes)]
    for lay, m, width, acc in contracts(lays, tt.dims):
        if acc != accumulate:
            continue
        want = np.asarray(fused_mttkrp_t(lay, jf, m, width, accumulate=acc,
                                         interpret=True))
        got = kernels.fused_mttkrp_t(port_layout(lay), tf, m, width, acc)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"{name} mode={m} acc={acc}")
