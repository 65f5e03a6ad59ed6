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


#: (R, itemsize, table addresses, rank tile, (nv, vec)) of the gathering
#: walk: 16-byte loads at R = 512 in f32 and bf16, 8-byte loads at the
#: 200-byte pitch of R = 50, scalar loads at odd R or on a misaligned table
GATHER_VEC_CASES = [
    (512, 4, (0, 2048), 128, (1, 4)),
    (512, 2, (0, 1024), 128, (1, 4)),
    (512, 4, (0, 2048), 256, (2, 4)),
    (512, 2, (0, 1024), 256, (1, 8)),
    (512, 4, (0, 2048), 64, (1, 2)),
    (50, 4, (0, 200 * 7), 50, (1, 2)),
    (50, 2, (0, 100 * 7), 50, (1, 2)),
    (1, 4, (0, 4), 1, (1, 1)),
    (8, 4, (0, 32), 8, (1, 1)),
    (64, 4, (0, 256), 64, (1, 2)),
    (65, 4, (0, 260), 65, (4, 1)),
    (127, 2, (0, 254), 127, (4, 1)),
    (129, 4, (0, 516), 128, (4, 1)),
    (130, 4, (0, 520), 128, (2, 2)),
    (256, 4, (0, 1024), 256, (2, 4)),
    (256, 2, (0, 512), 256, (1, 8)),
    (256, 4, (0, 1028), 256, (8, 1)),    # a table 4 bytes off alignment
    (384, 4, (8, 1032), 128, (2, 2)),    # 8-byte aligned tables
    (640, 2, (0, 1280), 128, (1, 4)),
]


@pytest.mark.parametrize("R,itemsize,addresses,rtile,want", GATHER_VEC_CASES)
def test_gather_vec_picks_aligned_loads(R, itemsize, addresses, rtile,
                                        want):
    cols = min(rtile, R)
    nv, vec = kernels.gather_vec(R, cols, itemsize, addresses)
    assert (nv, vec) == want
    # every load is aligned: vec divides R, the tile and each address
    assert R % vec == 0 and (rtile >= R or rtile % vec == 0)
    assert all(a % (vec * itemsize) == 0 for a in addresses)
    assert vec * itemsize <= kernels.GATHER_LOAD_BYTES
    # lane l's chunk v covers columns (l + 32 v) * vec + [0, vec): the
    # chunks that start inside the tile cover it exactly once, and none
    # reaches past it (the kernel tests only a chunk's first column)
    covered = [(lane + 32 * v) * vec + i for lane in range(32)
               for v in range(nv) for i in range(vec)
               if (lane + 32 * v) * vec < cols]
    assert sorted(covered) == list(range(cols))
    # the rank tiles of a launch start at multiples of the load
    for r0 in range(0, R, rtile):
        assert r0 % vec == 0 and min(rtile, R - r0) % vec == 0


def test_gather_vec_refuses_a_tile_past_256_columns():
    with pytest.raises(ValueError):
        kernels.gather_vec(512, 512, 4, (0,))


@pytest.mark.parametrize("R", [1, 50, 127, 128, 129, 257, 384, 512, 640])
def test_tg_rank_tile_covers_the_rank(R):
    rtile = kernels.tg_rank_tile(R)
    assert rtile == min(R, kernels.TG_RANK_TILE)
    tiles = -(-R // rtile)
    assert (tiles - 1) * rtile < R <= tiles * rtile
    nv, vec = kernels.gather_vec(R, min(rtile, R), 4, (0,))
    # a tile narrower than the rank spans whole lanes' chunks
    assert rtile >= R or rtile % (32 * nv * vec) == 0


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("rtile", [64, 128, 256])
def test_gather_vec_spans_whole_rank_tiles_at_512(rtile, itemsize):
    """Each rank tile that fused_mttkrp_tg is timed at (64, 128 and 256
    columns at R = 512) is whole lanes' chunks of aligned loads, as
    csrc/fused_mttkrp.cu's entry requires, and no load is wider than 16
    bytes."""
    nv, vec = kernels.gather_vec(512, rtile, itemsize, (0, 1 << 20))
    assert rtile % (32 * nv * vec) == 0 and 32 * nv * vec >= rtile
    assert vec * itemsize <= kernels.GATHER_LOAD_BYTES
    assert 512 % vec == 0
