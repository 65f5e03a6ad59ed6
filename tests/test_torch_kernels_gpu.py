"""The CUDA kernels against their plain PyTorch versions on a card.

Every test here needs a card and skips itself where there is none.  The
file imports neither JAX nor the JAX package, so it runs on a machine
without them; there, skip the repo's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerance: f32 with atomics in a run-dependent order, 1e-5 of the largest
output.
"""

import numpy as np
import pytest
import torch

from splatt_tpu_torch import state
from splatt_tpu_torch.blocked import build_layout as port_build_layout
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.ops import kernels


def contracts(lays, dims):
    """(layout, mode, width, accumulate) for both contracts of each mode:
    sorted on the mode's own layout, accumulate on the next mode's."""
    for m, d in enumerate(dims):
        yield lays[m], m, lays[m].seg_width, False
        yield lays[(m + 1) % len(dims)], m, -(-(d + 1) // 8) * 8, True


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    skewed = (30, 24, 36, 20)
    wide = (4000, 6, 7)   # blocks of 512 span ~1000 rows: tile > smem
    cases = [(skewed, 3000, 128, 8), (skewed, 3000, 256, 50),
             (skewed, 3000, 512, 33), (skewed, 3000, 128, 256),
             (wide, 2048, 512, 64)]
    for dims, nnz, block, rank in cases:
        inds = np.stack([rng.zipf(1.5, size=nnz) % d for d in dims])
        if dims == wide:
            inds[0] = rng.integers(0, dims[0], size=nnz)
        X = SparseTensor(inds, rng.random(nnz), dims).deduplicate()
        lays = [port_build_layout(X, m, block=block, device="cuda")
                for m in range(len(dims))]
        tf = [torch.from_numpy(rng.random((d, rank), dtype=np.float32))
              .cuda() for d in dims]
        for lay, m, width, acc in contracts(lays, dims):
            before = kernels.fused_mttkrp_t.launches
            got = kernels.fused_mttkrp_t(lay, tf, m, width, acc)
            assert kernels.fused_mttkrp_t.launches == before + 1
            want = kernels.fused_mttkrp_t_plain(lay, tf, m, width, acc)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-5 * scale, \
                f"block={block} rank={rank} mode={m} accumulate={acc}"
    with pytest.raises(TypeError):
        kernels.fused_mttkrp_t(lays[0], [U.double() for U in tf], 0,
                               lays[0].seg_width, False)


def _pad_block(lay):
    """`lay` with one all-padding block appended (ids `dim` in the sorted
    mode, 0 elsewhere, values 0, row_start `dim`)."""
    inds = lay.inds.cpu().numpy()
    pad = np.zeros((inds.shape[0], lay.block), dtype=np.int32)
    pad[lay.mode] = lay.dim
    return state.layout_from_numpy(
        np.concatenate([inds, pad], axis=1),
        np.concatenate([lay.vals.cpu().numpy(),
                        np.zeros(lay.block, np.float32)]),
        np.concatenate([lay.row_start.cpu().numpy(), [lay.dim]]),
        mode=lay.mode, dim=lay.dim, block=lay.block,
        seg_width=lay.seg_width, nnz=lay.nnz, device=lay.vals.device)


def _close(got, want, what):
    torch.cuda.synchronize()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= 1e-5 * scale, what


@pytest.mark.gpu
def test_cuda_fused_tg_and_rowmajor_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(6)
    skewed = (30, 24, 36, 20)
    wide = (4000, 6, 7)   # blocks of 512 span ~1000 rows: tile > smem
    cases = [(skewed, 3000, 128, 1), (skewed, 3000, 256, 33),
             (skewed, 3000, 512, 512), (wide, 2048, 512, 64),
             (wide, 2048, 512, 512)]
    for dims, nnz, block, rank in cases:
        inds = np.stack([rng.zipf(1.5, size=nnz) % d for d in dims])
        if dims == wide:
            inds[0] = rng.integers(0, dims[0], size=nnz)
        X = SparseTensor(inds, rng.random(nnz), dims).deduplicate()
        lays = [_pad_block(port_build_layout(X, m, block=block,
                                             device="cuda"))
                for m in range(len(dims))]
        tf = [torch.from_numpy(rng.random((d, rank), dtype=np.float32))
              .cuda() for d in dims]
        for lay, m, width, acc in contracts(lays, dims):
            what = f"dims={dims} rank={rank} mode={m} accumulate={acc}"
            want = kernels.fused_mttkrp_t_plain(lay, tf, m, width, acc)
            before = kernels.fused_mttkrp_tg.launches
            _close(kernels.fused_mttkrp_tg(lay, tf, m, width, acc), want,
                   "tg " + what)
            assert kernels.fused_mttkrp_tg.launches == before + 1
            if rank <= kernels.MAX_RANK:
                for chunk in (1, 3):
                    _close(kernels.fused_mttkrp(lay, tf, m, width, acc,
                                                chunk=chunk), want,
                           f"row-major chunk={chunk} " + what)
    with pytest.raises(ValueError):
        kernels.fused_mttkrp(lays[0], tf, 0, 8, False, chunk=0)
    with pytest.raises(ValueError):   # rank 512: above the register budget
        kernels.fused_mttkrp(lays[0], tf, 0, 8, False)


@pytest.mark.gpu
def test_cuda_onehot_reductions_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(7)
    # (nb, B, S, R): ranks 1, 33, 512; S=2000 at R=33 is a 264 KB tile,
    # wider than shared memory
    for nb, B, S, R in [(7, 128, 16, 1), (5, 256, 40, 33),
                        (3, 512, 2000, 33), (4, 128, 24, 512)]:
        local = rng.integers(-1, S + 3, size=(nb, B)).astype(np.int32)
        local[-1] = S          # an all-padding last block
        local[:-1].sort(axis=1)
        local_t = torch.from_numpy(local).cuda()
        prod = torch.from_numpy(rng.random((nb, B, R),
                                           dtype=np.float32)).cuda()
        prod[-1] = 0.0
        what = f"nb={nb} B={B} S={S} R={R}"
        before = kernels.onehot_reduce_sorted.launches
        _close(kernels.onehot_reduce_sorted(local_t, prod, S),
               kernels.onehot_reduce_sorted_plain(local_t, prod, S),
               "sorted " + what)
        assert kernels.onehot_reduce_sorted.launches == before + 1
        ids = torch.from_numpy(rng.integers(0, S + 2, size=(nb, B))
                               .astype(np.int32)).cuda()
        _close(kernels.onehot_reduce_full(ids, prod, S),
               kernels.onehot_reduce_full_plain(ids, prod, S),
               "full " + what)
    with pytest.raises(TypeError):
        kernels.onehot_reduce_full(ids.long(), prod, S)
