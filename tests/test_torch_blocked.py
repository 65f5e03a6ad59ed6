"""The port's blocked layouts against the JAX package's, array for array."""

import numpy as np
import pytest
import torch

from splatt_tpu import blocked as jb
from splatt_tpu.config import BlockAlloc as JAlloc
from splatt_tpu.config import Options as JOptions
from splatt_tpu.parallel.common import alloc_build_modes as j_alloc_modes
from splatt_tpu_torch import blocked as tb
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch.config import BlockAlloc, Options
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

FIXTURES = ["small", "med", "small4", "med4", "med5"]


def port_tensor(tt):
    return tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


@pytest.mark.parametrize("block", [128, 512])
@pytest.mark.parametrize("name", FIXTURES)
def test_build_layout_matches(name, block):
    tt = gen.fixture_tensor(name)
    for mode in range(tt.nmodes):
        want = jb.build_layout(tt, mode, block=block, val_dtype=np.float64)
        got = tb.build_layout(port_tensor(tt), mode, block=block,
                              val_dtype=torch.float64, device="cpu")
        np.testing.assert_array_equal(got.inds.numpy(), np.asarray(want.inds))
        np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
        np.testing.assert_array_equal(got.row_start.numpy(),
                                      np.asarray(want.row_start))
        np.testing.assert_array_equal(got.blocked_locals().numpy(),
                                      np.asarray(want.blocked_locals()))
        assert (got.mode, got.dim, got.block, got.seg_width, got.nnz,
                got.nblocks) == (want.mode, want.dim, want.block,
                                 want.seg_width, want.nnz, want.nblocks)


@pytest.mark.parametrize("alloc", list(BlockAlloc))
def test_alloc_build_modes_and_from_coo_match(alloc):
    for dims in [(4, 4, 3), (40, 36, 44), (7, 7, 7), (30, 24, 36, 20),
                 (5, 9, 5, 9, 2)]:
        got = tb.alloc_build_modes(dims, Options(block_alloc=alloc))
        assert got == j_alloc_modes(dims, JOptions(
            block_alloc=JAlloc(alloc.value)))
    tt = gen.fixture_tensor("med4")
    jopts = JOptions(block_alloc=JAlloc(alloc.value), nnz_block=256,
                     val_dtype=np.float64, autotune=False)
    want = jb.BlockedSparse.from_coo(tt, jopts)
    got = tb.BlockedSparse.from_coo(
        port_tensor(tt), Options(block_alloc=alloc, nnz_block=256,
                                 val_dtype=torch.float64), device="cpu")
    assert got.mode_map == want.mode_map
    assert [lay.mode for lay in got.layouts] == \
        [lay.mode for lay in want.layouts]
    assert got.frobsq() == pytest.approx(want.frobsq(), rel=1e-15)
