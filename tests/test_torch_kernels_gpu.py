"""The CUDA kernels against their plain PyTorch versions on a card.

Every test here needs a card and skips itself where there is none.  The
file imports neither JAX nor the JAX package, so it runs on a machine
without them; there, skip the repo's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Tolerance: f32 with atomics in a run-dependent order, 1e-5 of the largest
output, for bf16 operands too: a kernel rounds each bf16 product as its
plain version does, so only the order of the f32 sums differs.
"""

import math

import numpy as np
import pytest
import torch

from splatt_tpu_torch import state
from splatt_tpu_torch.blocked import build_layout as port_build_layout
from splatt_tpu_torch.blocked import reencode_layout
from splatt_tpu_torch.config import LayoutFormat
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.ops import kernels
from tests.torch_fixtures import private_tune_cache  # noqa: F401


#: the matrices the eigensolver tests use (tests/test_torch_sym_eig.py too)
SPECTRA = ("spd", "rank_deficient", "repeated", "indefinite",
           "nonfinite_chol")


def spectrum(kind: str, R: int, seed: int) -> np.ndarray:
    """A symmetric (R, R) float64 matrix: "spd" eigenvalues in [1, 10];
    "rank_deficient" the Gram of a (4R, R) normal matrix with a
    duplicated column (a zero column at R = 1), so the pseudo-inverse
    branch runs; "repeated" eigenvalues 2 and 5 each about R/2 times;
    "indefinite" eigenvalues of both signs; "nonfinite_chol" all ones,
    whose Cholesky meets a zero pivot and solves to non-finite values."""
    rng = np.random.default_rng(seed)
    if kind == "rank_deficient":
        X = rng.standard_normal((4 * R, R))
        if R > 1:
            X[:, -1] = X[:, 0]
        else:
            X[:, 0] = 0.0
        return X.T @ X
    if kind == "nonfinite_chol":
        return np.ones((R, R))
    Q, _ = np.linalg.qr(rng.standard_normal((R, R)))
    if kind == "spd":
        lam = rng.uniform(1.0, 10.0, R)
    elif kind == "repeated":
        lam = np.where(np.arange(R) % 2 == 0, 2.0, 5.0)
    elif kind == "indefinite":
        lam = rng.uniform(1.0, 5.0, R) * np.where(np.arange(R) % 2, -1, 1)
    else:
        raise ValueError(kind)
    A = (Q * lam) @ Q.T
    return (A + A.T) / 2


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


#: the value and table dtypes the kernels take on a card, every pair
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32))


def _tables(rng, dims, rank, dtype, misaligned=False):
    """Factor tables on the card; `misaligned` puts each one element past
    an aligned address, so no table takes a load wider than one element
    (csrc/gather_walk.cuh's scalar loads)."""
    out = []
    for d in dims:
        U = torch.from_numpy(rng.random((d, rank), dtype=np.float32)).to(
            "cuda", dtype)
        if misaligned:
            buf = torch.empty(d * rank + 1, dtype=dtype, device="cuda")
            buf[1:].copy_(U.reshape(-1))
            U = buf[1:].view(d, rank)
        out.append(U)
    return out


@pytest.mark.gpu
def test_cuda_fused_tg_every_load_width():
    """fused_mttkrp_tg on the gathering walk against its plain version at
    ranks that take every load width and rank tiling (1 to 640: one tile,
    a tile and a column, several tiles, 16-, 8- and 4-byte loads and the
    scalar loads of odd R), both contracts, 2 modes (one gathered table),
    3 and 4 modes, all four value/table dtype pairs, an all-padding last
    block, and tables off their alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(16)
    launched = 0
    for dims in ((30, 24), (30, 24, 36), (30, 24, 36, 20)):
        X = _tensor(rng, dims, 3000, False)
        v1 = [_pad_block(port_build_layout(X, m, block=256, device="cuda"))
              for m in range(len(dims))]
        for rank in (1, 50, 127, 128, 129, 257, 384, 512, 640):
            for vdt, fdt in DTYPE_PAIRS:
                lays = [reencode_layout(lay, LayoutFormat(
                    val="bf16" if vdt == torch.bfloat16 else "f32"),
                    val_dtype=vdt) for lay in v1]
                for misaligned in (False, True):
                    if misaligned and rank not in (128, 512):
                        continue
                    tf = _tables(rng, dims, rank, fdt, misaligned)
                    for lay, m, width, acc in contracts(lays, dims):
                        what = (f"dims={dims} rank={rank} {vdt}/{fdt} "
                                f"misaligned={misaligned} mode={m} "
                                f"accumulate={acc}")
                        before = kernels.fused_mttkrp_tg.launches
                        _close(kernels.fused_mttkrp_tg(lay, tf, m, width,
                                                       acc),
                               kernels.fused_mttkrp_tg_plain(lay, tf, m,
                                                             width, acc),
                               what)
                        assert kernels.fused_mttkrp_tg.launches == \
                            before + 1
                        launched += 1
    assert launched == 2 * 9 * 4 * (9 + 2)


def _crosses_blocks(lay) -> bool:
    """Some block's first row continues its predecessor's last real row:
    a run cut by a block boundary, which a CTA of fused_mttkrp walking
    consecutive blocks must not carry across."""
    ids = lay.inds[lay.mode].reshape(lay.nblocks, -1).cpu()
    real = lay.vals.reshape(lay.nblocks, -1).cpu() != 0
    return any(bool(real[b - 1].any()) and int(ids[b - 1][real[b - 1]][-1])
               == int(ids[b][0]) for b in range(1, lay.nblocks))


@pytest.mark.gpu
def test_cuda_fused_t_and_rowmajor_every_load_width():
    """fused_mttkrp_t and fused_mttkrp (chunk 1 and 3) on the gathering
    walk, the whole rank in one tile, against their plain version at
    ranks that take every columns-per-lane count and load width (1, 17:
    scalar loads; 50: 8-byte; 128; 200, 256: 8 columns a lane), both
    contracts, 2 modes (one gathered table), 3 and 4 modes, all four
    value/table dtype pairs, an all-padding last block, row runs that
    cross block boundaries, and tables off their alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(18)
    launched = 0
    for dims in ((30, 24), (30, 24, 36), (30, 24, 36, 20)):
        X = _tensor(rng, dims, 3000, False)
        v1 = [_pad_block(port_build_layout(X, m, block=256, device="cuda"))
              for m in range(len(dims))]
        assert all(_crosses_blocks(lay) for lay in v1)
        for rank in (1, 17, 50, 128, 200, 256):
            for vdt, fdt in DTYPE_PAIRS:
                lays = [reencode_layout(lay, LayoutFormat(
                    val="bf16" if vdt == torch.bfloat16 else "f32"),
                    val_dtype=vdt) for lay in v1]
                for misaligned in (False, True):
                    if misaligned and rank not in (128, 256):
                        continue
                    tf = _tables(rng, dims, rank, fdt, misaligned)
                    for lay, m, width, acc in contracts(lays, dims):
                        what = (f"dims={dims} rank={rank} {vdt}/{fdt} "
                                f"misaligned={misaligned} mode={m} "
                                f"accumulate={acc}")
                        want = kernels.fused_mttkrp_t_plain(lay, tf, m,
                                                            width, acc)
                        before = kernels.fused_mttkrp_t.launches
                        _close(kernels.fused_mttkrp_t(lay, tf, m, width,
                                                      acc), want, what)
                        assert kernels.fused_mttkrp_t.launches == \
                            before + 1
                        for chunk in (1, 3):
                            before = kernels.fused_mttkrp.launches
                            _close(kernels.fused_mttkrp(lay, tf, m, width,
                                                        acc, chunk=chunk),
                                   want, f"chunk={chunk} " + what)
                            assert kernels.fused_mttkrp.launches == \
                                before + 1
                        launched += 1
    assert launched == 2 * 9 * 4 * (6 + 2)


@pytest.mark.gpu
def test_cuda_fused_v2_every_load_width():
    """fused_mttkrp_v2 on the gathering walk against its plain version at
    ranks that take every load width (1 to 256: 16-, 8- and 4-byte loads,
    the scalar loads of odd R), under u8, u16, delta, rle and auto, both
    contracts, 2 modes (one gathered table) and 3, all four value/table
    dtype pairs, with an all-padding last block, and tables off their
    alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(17)
    launched = 0
    for dims in ((30, 24), (30, 24, 36)):
        X = _tensor(rng, dims, 3000, False)
        v1 = [_pad_block(port_build_layout(X, m, block=256, device="cuda"))
              for m in range(len(dims))]
        for rank in (1, 8, 50, 64, 65, 130, 256):
            for vdt, fdt in DTYPE_PAIRS:
                for misaligned in (False, True):
                    if misaligned and rank not in (64, 256):
                        continue
                    tf = _tables(rng, dims, rank, fdt, misaligned)
                    for idx in ("u8", "u16", "delta", "rle", "auto"):
                        lays = [reencode_layout(lay, LayoutFormat(idx=idx),
                                                val_dtype=vdt) for lay in v1]
                        for lay, m, width, acc in contracts(lays, dims):
                            assert lay.encoding == "v2"
                            what = (f"dims={dims} rank={rank} {idx} "
                                    f"{vdt}/{fdt} misaligned={misaligned} "
                                    f"mode={m} accumulate={acc}")
                            before = kernels.fused_mttkrp_v2.launches
                            _close(kernels.fused_mttkrp_v2(lay, tf, m, width,
                                                           acc),
                                   kernels.fused_mttkrp_v2_plain(lay, tf, m,
                                                                 width, acc),
                                   what)
                            assert kernels.fused_mttkrp_v2.launches == \
                                before + 1
                            launched += 1
    assert launched == 4 * (7 + 2) * 5 * (4 + 6)


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



@pytest.mark.gpu
def test_cuda_onehot_reductions_every_load_width():
    """onehot_reduce_sorted and onehot_reduce_full on the gathering walk
    against their plain versions at ranks that take every load width
    and rank tiling (1, 17: scalar loads; 50: 8-byte; 128; 200, 256: the
    whole rank or tiles; 512: several tiles), f32 and bf16 products,
    aligned and one element off alignment (scalar loads), ids of -1 and
    past the width, an all-padding last block, sorted runs (sorted) and
    unsorted ids (full), and a sorted tile wider than shared memory (S =
    2000 at 29 or more columns: the device-memory branch); one launch
    per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(19)
    launched = 0
    for nb, B, S in [(6, 256, 16), (3, 512, 2000)]:
        for R in (1, 17, 50, 128, 200, 256, 512):
            for dtype in (torch.float32, torch.bfloat16):
                for shift in (0, 1):
                    local = rng.integers(-1, S + 3, size=(nb, B)).astype(
                        np.int32)
                    local[:-1].sort(axis=1)
                    local[-1] = S          # an all-padding last block
                    ids = rng.integers(-1, S + 2, size=(nb, B)).astype(
                        np.int32)
                    ids[-1] = -1
                    buf = torch.empty(nb * B * R + 1, dtype=dtype,
                                      device="cuda")
                    prod = buf[shift:shift + nb * B * R].view(nb, B, R)
                    prod.copy_(torch.from_numpy(rng.random(
                        (nb, B, R), dtype=np.float32)))
                    what = (f"nb={nb} B={B} S={S} R={R} {dtype} "
                            f"shift={shift}")
                    for name, idx in (("onehot_reduce_sorted", local),
                                      ("onehot_reduce_full", ids)):
                        fn = getattr(kernels, name)
                        plain = getattr(kernels, name + "_plain")
                        idx_t = torch.from_numpy(idx).cuda()
                        before = fn.launches
                        _close(fn(idx_t, prod, S), plain(idx_t, prod, S),
                               f"{name} {what}")
                        assert fn.launches == before + 1
                        launched += 1
    assert launched == 2 * 7 * 2 * 2 * 2


def _tensor(rng, dims, nnz, wide):
    inds = np.stack([rng.zipf(1.5, size=nnz) % d for d in dims])
    if wide:
        inds[0] = rng.integers(0, dims[0], size=nnz)
    return SparseTensor(inds, rng.random(nnz), dims).deduplicate()


@pytest.mark.gpu
def test_cuda_fused_v2_matches_plain():
    """fused_mttkrp_v2 against its plain version for every encoding, both
    contracts, f32 and bf16, with an all-padding last block (base dim in
    the sorted mode) and a tile wider than shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    skewed = (30, 24, 36, 20)
    wide = (4000, 6, 70000)   # blocks of 512 span ~1000 rows; an i32 mode
    cases = [(skewed, 3000, 128, 8), (skewed, 3000, 256, 50),
             (skewed, 3000, 512, 256), (wide, 2048, 512, 33)]
    launched = 0
    for dims, nnz, block, rank in cases:
        X = _tensor(rng, dims, nnz, dims == wide)
        v1 = [_pad_block(port_build_layout(X, m, block=block,
                                           device="cuda"))
              for m in range(len(dims))]
        for dtype in (torch.float32, torch.bfloat16):
            tf = [torch.from_numpy(rng.random((d, rank), dtype=np.float32))
                  .cuda().to(dtype) for d in dims]
            for idx in ("auto", "u8", "delta", "rle"):
                lays = [reencode_layout(lay, LayoutFormat(idx=idx),
                                        val_dtype=dtype) for lay in v1]
                for lay, m, width, acc in contracts(lays, dims):
                    if lay.encoding != "v2":
                        continue   # u8/rle overflow on the wide tensor
                    what = (f"dims={dims} rank={rank} {idx} {dtype} "
                            f"mode={m} accumulate={acc}")
                    before = kernels.fused_mttkrp_v2.launches
                    _close(kernels.fused_mttkrp_v2(lay, tf, m, width, acc),
                           kernels.fused_mttkrp_v2_plain(lay, tf, m, width,
                                                         acc), what)
                    assert kernels.fused_mttkrp_v2.launches == before + 1
                    launched += 1
    assert launched >= 60
    with pytest.raises(ValueError, match="v2"):
        kernels.fused_mttkrp_v2(v1[0], tf, 0, v1[0].seg_width, False)
    auto = reencode_layout(v1[0], LayoutFormat(idx="auto"))
    with pytest.raises(ValueError, match="decode_to_v1"):
        kernels.fused_mttkrp_t(auto, tf, 0, auto.seg_width, False)


@pytest.mark.gpu
def test_cuda_kernels_take_bf16():
    """The v1 kernels with bf16 values and tables, and the reductions with
    bf16 products, against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    dims = (30, 24, 36, 20)
    for nnz, block, rank in [(3000, 128, 8), (3000, 256, 50),
                             (3000, 512, 300)]:
        X = _tensor(rng, dims, nnz, False)
        lays = [_pad_block(port_build_layout(X, m, block=block,
                                             device="cuda"))
                for m in range(len(dims))]
        lays = [reencode_layout(lay, LayoutFormat(val="bf16"),
                                val_dtype=torch.bfloat16) for lay in lays]
        tf = [torch.from_numpy(rng.random((d, rank), dtype=np.float32))
              .cuda().to(torch.bfloat16) for d in dims]
        for lay, m, width, acc in contracts(lays, dims):
            what = f"rank={rank} mode={m} accumulate={acc}"
            want = kernels.fused_mttkrp_t_plain(lay, tf, m, width, acc)
            assert want.dtype == torch.float32
            _close(kernels.fused_mttkrp_tg(lay, tf, m, width, acc), want,
                   "tg " + what)
            if rank <= kernels.MAX_RANK:
                _close(kernels.fused_mttkrp_t(lay, tf, m, width, acc),
                       want, "t " + what)
                _close(kernels.fused_mttkrp(lay, tf, m, width, acc),
                       want, "row-major " + what)
        nb = lays[0].nblocks
        local_t = lays[0].blocked_locals().contiguous()
        prod = torch.from_numpy(rng.random((nb, block, rank),
                                           dtype=np.float32)).cuda().to(
                                               torch.bfloat16)
        S = lays[0].seg_width
        _close(kernels.onehot_reduce_sorted(local_t, prod, S),
               kernels.onehot_reduce_sorted_plain(local_t, prod, S),
               f"sorted bf16 rank={rank}")
        ids = lays[1].mode_ids(0).reshape(nb, block)
        W = -(-(dims[0] + 1) // 8) * 8
        _close(kernels.onehot_reduce_full(ids.contiguous(), prod, W),
               kernels.onehot_reduce_full_plain(ids, prod, W),
               f"full bf16 rank={rank}")


@pytest.mark.gpu
def test_cuda_fused_dense_matches_plain():
    """fused_dense against its plain version (IEEE f32 matmul) on 3- and
    4-mode tensors: a mode of one row, one of 96 rows in one tile, one
    above the 128-row CTA with pad rows, ranks from 1 to 257 (every
    wgmma N it is built for, 8 to 96, the common CP ranks 16-48 between,
    and rank tiles on grid.y), all four pairs of
    f32 and bf16 tiles and factors (3xTF32 keeps about 2^-21 of each
    product, inside the 1e-5 tolerance); then the dispatch on a card:
    the chain is fused_dense alone, so its armed fault raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.blocked import build_dense_layout
    from splatt_tpu_torch.ops.mttkrp import mttkrp_blocked
    from splatt_tpu_torch.utils import faults

    rng = np.random.default_rng(10)
    cases = [((16, 32, 120), 4000, (1, 50)), ((5, 6, 7, 9), 1200, (3, 64)),
             ((300, 8, 128), 100000, (50, 130)),
             ((96, 16, 128), 60000, (8, 257)), ((1, 40, 130), 3000, (65,)),
             ((24, 40, 128), 30000, (16, 24, 32, 40, 48))]
    launched = 0
    for dims, nnz, ranks in cases:
        lin = rng.choice(int(np.prod(dims)), size=nnz, replace=False)
        inds = np.stack(np.unravel_index(lin, dims))
        X = SparseTensor(inds, rng.random(nnz) + 0.1, dims)
        for rank in ranks:
            f32 = [torch.from_numpy(rng.random((d, rank), dtype=np.float32))
                   .cuda() for d in dims]
            for vdt, fdt in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.bfloat16),
                             (torch.float32, torch.bfloat16),
                             (torch.bfloat16, torch.float32)):
                tf = [U.to(fdt) for U in f32]
                for m in range(len(dims)):
                    lay = build_dense_layout(X, m, val_dtype=vdt,
                                             device="cuda")
                    before = kernels.fused_dense.launches
                    got = kernels.fused_dense(lay, tf, m)
                    assert kernels.fused_dense.launches == before + 1
                    assert got.dtype == torch.float32
                    _close(got, kernels.fused_dense_plain(lay, tf, m),
                           f"dims={dims} rank={rank} {vdt}/{fdt} mode={m}")
                    launched += 1
    assert launched == 4 * (3 * 2 + 4 * 2 + 3 * 2 + 3 * 2 + 3 + 3 * 5)
    # a dense layout takes the dense path whatever the caller's path
    before = kernels.fused_dense.launches
    for path in ("sorted_onehot", "dense"):
        _close(mttkrp_blocked(lay, tf, m, path),
               kernels.fused_dense_plain(lay, tf, m), path)
    assert kernels.fused_dense.launches == before + 2
    with faults.inject("engine.fused_dense", "runtime"):
        with pytest.raises(RuntimeError, match="injected"):
            mttkrp_blocked(lay, tf, m, fallback=True)
    with pytest.raises(ValueError, match="own mode"):
        kernels.fused_dense(lay, tf, (m + 1) % len(dims))


@pytest.mark.gpu
@pytest.mark.parametrize("fdt", [torch.float32, torch.bfloat16])
def test_cuda_fused_dense_long_span_per_cta(fdt):
    """fused_dense where each CTA sums a 65,536-column span alone (rank
    tiles past half the card's SMs leave one split per row block), on
    positive values and factors, where an accumulation that rounds with
    a bias loses most.  Held to an f64 reference within 1e-5 of its
    largest output: with f32 factors the 3xTF32 emulation
    (fused_dense_tf32x3: the products the card makes, summed in f64),
    with bf16 factors the plain version's bf16 roundings summed in f64.
    IEEE f32 sums of these products stay near 1e-6; sums in one
    tensor-core accumulator over the whole span drift to about 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.blocked import build_dense_layout
    from splatt_tpu_torch.ops.mttkrp import dense_operands

    rng = np.random.default_rng(11)
    dims = (100, 512, 128)
    inds = np.indices(dims).reshape(3, -1)
    X = SparseTensor(inds, rng.random(inds.shape[1]) + 0.1, dims)
    lay = build_dense_layout(X, 0, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    R = kernels.DENSE_N_TILES[-1] * (sms // 2 + 1)
    t = kernels.dense_tiling(lay.dim, lay.span, lay.geometry.inner_pad, R,
                             sms, False, fdt == torch.bfloat16)
    assert lay.span == 65536 and t.splits == 1
    tf = [torch.from_numpy(rng.random((d, R), dtype=np.float32)).cuda()
          .to(fdt) for d in dims]
    before = kernels.fused_dense.launches
    got = kernels.fused_dense(lay, tf, 0)
    assert kernels.fused_dense.launches == before + 1
    if fdt == torch.float32:
        want = kernels.fused_dense_tf32x3(lay, tf, 0)
    else:
        w, u = dense_operands(lay, tf, 0)
        kr = (w[:, None, :] * u[None, :, :]).reshape(-1, R)
        want = (lay.tiles.view(-1, lay.span).to(fdt).double()
                @ kr.double())[:lay.dim]
    err = float((got.double() - want).abs().max())
    scale = float(want.abs().max())
    assert err <= 1e-5 * scale, f"{fdt}: {err / scale:.3e} of max"


def _ring_mesh(ndev):
    """`ndev` ranks over the visible cards (virtual ranks when fewer)."""
    from splatt_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_devices=ndev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ring_kernels_match_plain(dtype):
    """ring_gather equals the sync ring's gather exactly (ids of no shard
    give zero rows), ring_reduce its reduce within 1e-5 of the largest
    output, for 1-4 ranks, twice in a row on the kept landing zones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.parallel import ring, ring_kernels

    rng = np.random.default_rng(7)
    for ndev in (1, 2, 3, 4):
        mesh = _ring_mesh(ndev)
        for block, R, nnz in ((37, 5, 300), (250, 50, 4000), (9, 70, 1)):
            U = [torch.from_numpy(rng.random((block, R))).to(dev, dtype)
                 for dev in mesh.devices]
            ids = []
            for dev in mesh.devices:
                i = rng.integers(0, ndev * block, size=nnz).astype(np.int32)
                i[:min(2, nnz)] = -1
                ids.append(torch.from_numpy(i).to(dev))
            prod = [torch.from_numpy(rng.random((nnz, R))).to(dev, dtype)
                    for dev in mesh.devices]
            for _ in range(2):
                before = ring_kernels.ring_gather.launches
                got = ring_kernels.ring_gather(U, ids, mesh)
                assert ring_kernels.ring_gather.launches \
                    == before + len(mesh.cards)
                want = ring.gather_hops(U, ids, mesh)
                red = ring_kernels.ring_reduce(prod, ids, mesh, block)
                red_want = ring.blockwise_reduce_rows(prod, ids, mesh, block)
                for c in mesh.cards:
                    torch.cuda.synchronize(c)
                ring_kernels.check_errors()
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w.cpu())
                for g, w in zip(red, red_want):
                    assert g.dtype == torch.float32
                    scale = max(float(w.abs().max()), 1e-30)
                    assert float((g - w).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_cuda_async_ring_cpd_is_the_kernels_alone():
    """On a CUDA mesh the ASYNC_RING chain is the kernel alone: the CPD
    launches each ring kernel once per card per leg, its fits follow the
    CPU's f64 run within 1e-4, and an armed comm.ring_exchange raises
    with fallback on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.config import CommPattern, Options, Verbosity
    from splatt_tpu_torch.parallel import ring_kernels, sharded_cpd_als
    from splatt_tpu_torch.parallel.mesh import make_mesh
    from splatt_tpu_torch.parallel.sharded import comm_chain
    from splatt_tpu_torch.utils import faults

    mesh = _ring_mesh(4)
    assert comm_chain(CommPattern.ASYNC_RING, mesh) == ("async_ring",)
    rng = np.random.default_rng(3)
    dims, rank, iters = (61, 47, 83), 8, 3
    X = SparseTensor(np.stack([rng.integers(0, d, size=5000) for d in dims]),
                     rng.random(5000), dims).deduplicate()
    init = [rng.random((d, rank)) for d in dims]

    def run(m, dtype, **kw):
        opts = Options(max_iterations=iters, tolerance=0.0, val_dtype=dtype,
                       comm_pattern=CommPattern.ASYNC_RING,
                       verbosity=Verbosity.NONE, **kw)
        return sharded_cpd_als(X, rank, mesh=m, opts=opts, init=init,
                               measure_overlap=False)

    ring_kernels.reset_launches()
    got = run(mesh, torch.float32, engine_fallback=False)
    assert ring_kernels.ring_gather.launches == 2 * 3 * iters * len(mesh.cards)
    assert ring_kernels.ring_reduce.launches == 3 * iters * len(mesh.cards)
    want = run(make_mesh(n_devices=4, device="cpu"), torch.float64)
    assert max(abs(a - b) for a, b in zip(got.fits, want.fits)) <= 1e-4
    for fallback in (True, False):
        resilience.reset_demotions()
        with faults.inject("comm.ring_exchange", "runtime", times=1):
            with pytest.raises(RuntimeError, match="injected"):
                run(mesh, torch.float32, engine_fallback=fallback)
    resilience.reset_demotions()
    resilience.run_report().clear()


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-300)


def _pinv_op(w, v, dtype):
    """V diag(w_inv) Vᵀ with the cut of the solve in `dtype`."""
    tol = torch.finfo(dtype).eps ** 0.5 * w.abs().max()
    w_inv = torch.where(w.abs() > tol, 1.0 / w, torch.zeros_like(w))
    return (v * w_inv) @ v.T


@pytest.mark.gpu
def test_cuda_sym_eig_matches_plain_and_eigh():
    """csrc/sym_eig.cu against its plain version and torch.linalg.eigh on
    the card, on every spectrum, f32 and f64, up to the gate's largest
    rank: sorted w within 1e-5 (f32) / 1e-12 (f64) of max|w|, the
    pseudo-inverse operator within 1e-4 / 1e-10, V orthonormal.  The
    eigh reference is the matrix's eigh in f64: on an H100, cuSOLVER's
    f32 eigh is itself about 1e-5 of max|w| from it at R >= 50, while the
    kernel and its plain version sit well inside that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.ops import linalg

    tols = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-10)}
    for dtype, top in ((torch.float32, 168), (torch.float64, 118)):
        w_tol, op_tol = tols[dtype]
        for R in (1, 2, 3, 17, 50, 64, top):
            for kind in SPECTRA:
                A = torch.from_numpy(spectrum(kind, R, seed=R)).to(
                    "cuda", dtype)
                what = f"{dtype} R={R} {kind}"
                before = linalg.sym_eig.launches
                w, v, sweeps = linalg.sym_eig(A, return_sweeps=True)
                assert linalg.sym_eig.launches == before + 1
                wp, vp, sp = linalg.sym_eig_plain(A)
                we, ve = torch.linalg.eigh(A.double())
                torch.cuda.synchronize()
                linalg.check_solver()
                assert 0 <= int(sweeps) < linalg.SYM_EIG_MAX_SWEEPS, what
                assert bool((w[1:] >= w[:-1]).all()), what
                for ref_w, ref_v in ((wp, vp), (we, ve)):
                    assert _rel(w, ref_w) <= w_tol, what
                    assert _rel(_pinv_op(w, v, dtype),
                                _pinv_op(ref_w, ref_v, dtype)) <= op_tol, what
                eye = torch.eye(R, dtype=dtype, device="cuda")
                assert float((v.T @ v - eye).abs().max()) \
                    <= 100 * torch.finfo(dtype).eps * R, what


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R", [32, 50])
def test_cuda_batched_sym_eig_matches_plain_and_single_launches(dtype, R):
    """One launch of csrc/sym_eig.cu over a stack of 12 matrices (every
    spectrum twice, one all-NaN slot, one zero slot) against
    sym_eig_plain over the stack (w within 1e-5 / 1e-12 of max|w|, the
    pseudo-inverse operator within 1e-4 / 1e-10) and against 12 single
    launches: each CTA's w, V and sweeps equal the single launch's bit for
    bit, the NaN slot gives NaN and 0 sweeps and sets no status.  Then the
    batched solve: one launch per stack, each slot within 1e-6 / 1e-12 of
    the one-matrix solve, no slot capped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.ops import linalg

    w_tol, op_tol = {torch.float32: (1e-5, 1e-4),
                     torch.float64: (1e-12, 1e-10)}[dtype]
    mats = [spectrum(kind, R, seed=R + i)
            for i, kind in enumerate(SPECTRA * 2)]
    mats += [np.full((R, R), np.nan), np.zeros((R, R))]
    A = torch.from_numpy(np.stack(mats)).to("cuda", dtype)
    K, nan_slot = len(mats), len(mats) - 2
    before = linalg.sym_eig.launches
    w, v, sweeps = linalg.sym_eig(A, return_sweeps=True)
    assert linalg.sym_eig.launches == before + 1
    wp, vp, sp = linalg.sym_eig_plain(A)
    singles = [linalg.sym_eig(A[i].contiguous(), return_sweeps=True)
               for i in range(K)]
    torch.cuda.synchronize()
    linalg.check_solver()
    assert w.shape == (K, R) and v.shape == (K, R, R)
    assert sweeps.shape == (K,)
    for i in range(K):
        ws, vs, ss = singles[i]
        assert torch.equal(torch.nan_to_num(w[i]), torch.nan_to_num(ws)), i
        assert torch.equal(torch.nan_to_num(v[i]), torch.nan_to_num(vs)), i
        assert int(sweeps[i]) == int(ss[0]), i
        if i == nan_slot:
            assert not bool(torch.isfinite(w[i]).any())
            assert int(sweeps[i]) == 0
            continue
        assert 0 <= int(sweeps[i]) < linalg.SYM_EIG_MAX_SWEEPS
        if float(wp[i].abs().max()) > 0:
            assert _rel(w[i], wp[i]) <= w_tol, i
            assert _rel(_pinv_op(w[i], v[i], dtype),
                        _pinv_op(wp[i], vp[i], dtype)) <= op_tol, i
    rhs = torch.rand((K, 7, R), dtype=dtype, device="cuda")
    before = linalg.sym_eig.launches
    x, capped = linalg.solve_normals(A, rhs, return_capped=True)
    assert linalg.sym_eig.launches == before + 1
    assert not bool(capped.any())
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for i in range(K):
        if i == nan_slot:
            continue
        xs = linalg.solve_normals(A[i].contiguous(), rhs[i])
        assert _rel(x[i], xs) <= tol, i


@pytest.mark.gpu
def test_cuda_solve_and_sweep_have_no_host_sync():
    """solve_normals, solve_normals_many and one cpd sweep run under
    torch.cuda.set_sync_debug_mode("error"): the eigensolver kernel took
    torch.linalg.eigh's place and nothing waits on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import BlockedSparse, Options
    from splatt_tpu_torch.cpd import _mttkrp_closure, _sweep
    from splatt_tpu_torch.ops import linalg
    from splatt_tpu_torch.parallel.common import solve_normals_many

    rng = np.random.default_rng(11)
    dims, rank = (40, 30, 50), 12
    X = _tensor(rng, dims, 4000, False)
    bs = BlockedSparse.from_coo(X, Options(), device="cuda")
    factors = [torch.from_numpy(rng.random((d, rank), dtype=np.float32))
               .cuda() for d in dims]
    lhs = torch.from_numpy(spectrum("spd", rank, seed=3)).float().cuda()
    rhs = [torch.from_numpy(rng.random((n, rank), dtype=np.float32)).cuda()
           for n in (17, 9)]
    do_mttkrp = _mttkrp_closure(bs, torch.device("cuda"), torch.float32,
                                False)

    def work():
        grams = [linalg.gram(U) for U in factors]
        facs = list(factors)
        x = linalg.solve_normals(lhs, rhs[0])
        xs = solve_normals_many(lhs, rhs)
        return _sweep(do_mttkrp, facs, grams, False, 0.0), x, xs

    work()                  # builds and loads the kernels first
    torch.cuda.synchronize()
    before = linalg.sym_eig.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        (lam, znormsq, inner), x, xs = work()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    linalg.check_solver()
    assert linalg.sym_eig.launches == before + 2 + len(dims)
    assert bool(torch.isfinite(x).all()) and all(
        bool(torch.isfinite(y).all()) for y in xs)
    assert math.isfinite(float(znormsq)) and math.isfinite(float(inner))


@pytest.mark.gpu
def test_cuda_sym_eig_launch_failure_raises():
    """A refused eigensolver launch raises; torch.linalg.eigh never takes
    its place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.ops import linalg

    lhs = torch.from_numpy(spectrum("spd", 8, seed=4)).float().cuda()
    rhs = torch.ones((5, 8), device="cuda")
    real_threads, real_eigh = linalg.sym_eig_threads, torch.linalg.eigh

    def no_eigh(*a, **k):
        raise AssertionError("torch.linalg.eigh stood in for the kernel")

    linalg.sym_eig_threads = lambda R: 2048     # above the CTA limit
    torch.linalg.eigh = no_eigh
    try:
        with pytest.raises(kernels.KernelLaunchError):
            linalg.solve_normals(lhs, rhs)
    finally:
        linalg.sym_eig_threads = real_threads
        torch.linalg.eigh = real_eigh


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ring_gather_plans_are_exact(dtype):
    """The bucketed ring_gather on 4 virtual ranks at R in {1, 7, 50, 64}
    (2- to 16-byte row vectors) equals its plain walk and the sync ring
    exactly, pads of no shard included, over plans built once on the card
    (equal to the CPU's) and reused by a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.parallel import ring, ring_kernels
    from splatt_tpu_torch.parallel.mesh import make_mesh

    mesh = _ring_mesh(4)
    cpu = make_mesh(n_devices=4, device="cpu")
    rng = np.random.default_rng(12)
    block, nnz = 301, 5000
    idx_cpu = []
    for _ in range(4):
        i = rng.integers(0, 4 * block, size=nnz).astype(np.int32)
        i[::9] = -1
        i[5::13] = 4 * block + 7
        idx_cpu.append(torch.from_numpy(i))
    idx = [i.to(dev) for i, dev in zip(idx_cpu, mesh.devices)]
    ring_kernels.reset_launches()
    plans = ring_kernels.build_ring_plans(idx, mesh, block)
    assert ring_kernels.build_ring_plans.builds == 4
    for p, q in zip(plans, ring_kernels.build_ring_plans(idx_cpu, cpu,
                                                         block)):
        for a, b in ((p.pos, q.pos), (p.loc, q.loc), (p.offsets, q.offsets)):
            assert torch.equal(a.cpu(), b)
    for R in (1, 7, 50, 64):
        U = [torch.from_numpy(rng.random((block, R))).to(dev, dtype)
             for dev in mesh.devices]
        want = ring.gather_hops(U, idx, mesh)
        plain = ring_kernels.ring_gather_plain(U, plans, mesh)
        for _ in range(2):
            before = ring_kernels.ring_gather.launches
            got = ring_kernels.ring_gather(U, idx, mesh, plans=plans)
            assert ring_kernels.ring_gather.launches \
                == before + len(mesh.cards)
            for c in mesh.cards:
                torch.cuda.synchronize(c)
            ring_kernels.check_errors()
            for g, w, p in zip(got, want, plain):
                assert torch.equal(g.cpu(), w.cpu()), f"R={R} {dtype}"
                assert torch.equal(g.cpu(), p.cpu()), f"R={R} {dtype}"
    assert ring_kernels.build_ring_plans.builds == 8


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ring_reduce_walks_the_sorted_plans(dtype):
    """ring_reduce over id-sorted plans on 4 virtual ranks at R in {1, 7,
    50, 64} (each product vector width), with pads of no shard, a bucket
    left empty and long runs of one row (runs cut by the warps' ranges),
    against its plain walk and the sync ring within 1e-5 of the largest
    output, twice over the same plans; an owner-stable plan is
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.parallel import ring, ring_kernels

    mesh = _ring_mesh(4)
    rng = np.random.default_rng(13)
    block, nnz = 301, 20000
    idx = []
    for d in range(4):
        i = rng.integers(0, 3 * block, size=nnz).astype(np.int32)  # shard 3
        i[::9] = -1                                                # empty
        i[5::13] = 4 * block + 7
        i[1::3] = block + 5 if d % 2 else 2 * block    # long runs of a row
        idx.append(torch.from_numpy(i).to(mesh.devices[d]))
    plans = ring_kernels.build_ring_plans(idx, mesh, block)
    for R in (1, 7, 50, 64):
        prod = [torch.from_numpy(rng.random((nnz, R))).to(dev, dtype)
                for dev in mesh.devices]
        want = ring.blockwise_reduce_rows(prod, idx, mesh, block)
        plain = ring_kernels.ring_reduce_plain(prod, plans, mesh)
        for _ in range(2):
            before = ring_kernels.ring_reduce.launches
            got = ring_kernels.ring_reduce(prod, idx, mesh, block,
                                           plans=plans)
            assert ring_kernels.ring_reduce.launches \
                == before + len(mesh.cards)
            for c in mesh.cards:
                torch.cuda.synchronize(c)
            ring_kernels.check_errors()
            for g, w, p in zip(got, want, plain):
                assert g.dtype == torch.float32
                scale = max(float(w.abs().max()), 1e-30)
                assert float((g - w).abs().max()) <= 1e-5 * scale, R
                assert float((g - p).abs().max()) <= 1e-5 * scale, R
    with pytest.raises(ValueError, match="does not match"):
        ring_kernels.ring_reduce(prod, idx, mesh, block + 1, plans=plans)


@pytest.mark.gpu
@pytest.mark.parametrize("decomp", ["fine", "medium", "coarse"])
def test_cuda_blocked_decomposition_cpd(decomp):
    """A 2-rank blocked CPD of each decomposition on the card: fused_t
    serves each sorted mode of each rank (launched exactly sorted modes x
    ranks x iterations times, fallback off, no demotion), and the fits
    follow the same run on the CPU in f64 within 1e-4.  Every nonzero
    lies in the first half of mode 0's rows, so rank 1 holds an
    all-padding bucket: FINE by its partition, MEDIUM on grid (2, 1, 1),
    COARSE in mode 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.config import (CommPattern, Options, Verbosity,
                                         default_opts)
    from splatt_tpu_torch.parallel import (coarse_cpd_als, grid_cpd_als,
                                           sharded_cpd_als)
    from splatt_tpu_torch.parallel.common import alloc_build_modes
    from splatt_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(17)
    dims, rank, iters, nnz = (60, 47, 83), 8, 3, 4000
    inds = np.stack([rng.integers(0, 30, size=nnz)]
                    + [rng.integers(0, d, size=nnz) for d in dims[1:]])
    X = SparseTensor(inds, rng.random(nnz) + 0.1, dims).deduplicate()
    init = [rng.random((d, rank)) for d in dims]

    def run(device, dtype, **kw):
        opts = Options(max_iterations=iters, tolerance=0.0, val_dtype=dtype,
                       comm_pattern=CommPattern.ALL2ALL,
                       verbosity=Verbosity.NONE, **kw)
        mesh = make_mesh(n_devices=2, device=device)
        if decomp == "fine":
            return sharded_cpd_als(X, rank, mesh=mesh, opts=opts, init=init,
                                   partition=np.zeros(X.nnz, np.int64),
                                   local_engine="blocked")
        if decomp == "medium":
            return grid_cpd_als(X, rank, grid=(2, 1, 1), opts=opts,
                                init=init, local_engine="blocked",
                                device=device)
        return coarse_cpd_als(X, rank, mesh=mesh, opts=opts, init=init,
                              local_engine="blocked")

    resilience.reset_demotions()
    kernels.reset_launches()
    got = run("cuda", torch.float32, engine_fallback=False)
    torch.cuda.synchronize()
    sort_dims = {"fine": [-(-d // 2) * 2 for d in dims],
                 "medium": [30, 47, 83], "coarse": dims}[decomp]
    nsorted = (len(dims) if decomp == "coarse"
               else len(alloc_build_modes(sort_dims, default_opts())))
    assert kernels.fused_mttkrp_t.launches == nsorted * 2 * iters
    assert resilience.demotions() == []
    want = run("cpu", torch.float64)
    assert max(abs(a - b) for a, b in zip(got.fits, want.fits)) <= 1e-4
    resilience.run_report().clear()


@pytest.mark.gpu
def test_cuda_out_of_core_grid_cpd(tmp_path):
    """A memmapped .bin through grid_cpd_als with a scratch directory on
    the card: the cells and their sorted layouts build in chunked passes
    into memmaps under it and go to the card in chunks; fused_t serves
    each sorted mode of each rank (sorted modes x ranks x iterations
    launches, fallback off, no demotion), the fits within 1e-4 of the
    in-memory run's, and the driver records the engine and the scratch
    directory.  The host engine (impl="native") and its plan refuse the
    card's tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import glob
    import os

    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.config import Options, Verbosity, default_opts
    from splatt_tpu_torch.io import load_memmap, save
    from splatt_tpu_torch.ops.mttkrp import mttkrp, plan_mttkrp
    from splatt_tpu_torch.parallel import grid_cpd_als
    from splatt_tpu_torch.parallel.common import (alloc_build_modes,
                                                  is_memmapped)

    rng = np.random.default_rng(23)
    dims, rank, iters, nnz = (120, 90, 150), 16, 3, 20000
    X = SparseTensor(np.stack([rng.integers(0, d, size=nnz) for d in dims]),
                     rng.random(nnz) + 0.1, dims).deduplicate()
    path = str(tmp_path / "x.bin")
    save(X, path)
    mm = load_memmap(path)
    assert is_memmapped(mm.inds)
    init = [rng.random((d, rank)) for d in dims]
    grid = (2, 2, 1)

    def run(tt, out_dir):
        resilience.reset_demotions()
        kernels.reset_launches()
        out = grid_cpd_als(tt, rank, grid=grid, device="cuda", init=init,
                           out_dir=out_dir,
                           opts=Options(max_iterations=iters, tolerance=0.0,
                                        verbosity=Verbosity.NONE,
                                        engine_fallback=False))
        torch.cuda.synchronize()
        assert resilience.demotions() == []
        return out, kernels.fused_mttkrp_t.launches

    scratch = str(tmp_path / "scratch")
    resilience.run_report().clear()
    ooc, launches = run(mm, scratch)
    (ev,) = resilience.run_report().events("local_engine")
    assert (ev["engine"], ev["out_of_core"]) == ("blocked", scratch)
    nsorted = len(alloc_build_modes([-(-d // g) for d, g in zip(dims, grid)],
                                    default_opts()))
    assert launches == nsorted * 4 * iters
    assert glob.glob(os.path.join(scratch, "cells_m*", "linds.npy"))
    ram, ram_launches = run(X, None)
    assert ram_launches == launches
    assert max(abs(a - b) for a, b in zip(ooc.fits, ram.fits)) <= 1e-4

    from splatt_tpu_torch.blocked import BlockedSparse

    bs = BlockedSparse.from_coo(X, Options(), device="cuda")
    facs = [torch.rand(d, 4, device="cuda") for d in dims]
    for call in (mttkrp, plan_mttkrp):
        with pytest.raises(ValueError, match="CPU tensors only"):
            call(bs, facs, 0, impl="native")
    resilience.run_report().clear()


def _balanced_tensor(rng, block):
    """Zipf-skewed modes and one slice of mode 0 holding three blocks'
    worth of nonzeros and more, so its balanced layout splits that fiber
    over at least three consecutive blocks and pads blocks mid-stream."""
    dims = (300, 40, 50)
    hot = 3 * block + block // 2
    nnz = 6000
    inds = np.stack([rng.zipf(1.4, size=nnz) % d for d in dims])
    inds = np.concatenate([inds, np.stack([
        np.full(hot, 17), rng.integers(0, 40, hot),
        rng.integers(0, 50, hot)])], axis=1)
    return SparseTensor(inds, rng.random(nnz + hot) + 0.1, dims)


@pytest.mark.gpu
def test_cuda_fused_t_and_v2_on_balanced_layouts():
    """fused_mttkrp_t and fused_mttkrp_v2 on balanced layouts, whose pads
    sit mid-stream with in-range rows (the block's last real row, value
    0) and whose hot fiber is split over three blocks, against their
    plain versions: both contracts, every v2 width, f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(23)
    block = 128
    X = _balanced_tensor(rng, block)
    v1 = [port_build_layout(X, m, block=block, packing="balanced",
                            device="cuda")
          for m in range(3)]
    lay = v1[0]
    counts = lay.block_nnz.cpu().numpy()
    assert lay.packing == "balanced" and (counts[:-1] < block).any()
    ids = lay.inds[0].reshape(lay.nblocks, block).cpu().numpy()
    real = lay.real_mask()
    hot = [b for b in range(lay.nblocks) if (ids[b][real[b]] == 17).any()]
    assert len(hot) >= 3
    launched = 0
    for rank in (8, 50, 256):
        for vdt, fdt in DTYPE_PAIRS[:2]:
            tf = _tables(rng, X.dims, rank, fdt)
            lays = [reencode_layout(lay, LayoutFormat(), val_dtype=vdt)
                    for lay in v1]
            for lay, m, width, acc in contracts(lays, X.dims):
                what = f"fused_t rank={rank} {vdt}/{fdt} mode={m} acc={acc}"
                _close(kernels.fused_mttkrp_t(lay, tf, m, width, acc),
                       kernels.fused_mttkrp_t_plain(lay, tf, m, width, acc),
                       what)
                launched += 1
            for idx in ("u8", "u16", "delta", "rle", "auto"):
                lays = [reencode_layout(lay, LayoutFormat(idx=idx),
                                        val_dtype=vdt) for lay in v1]
                for lay, m, width, acc in contracts(lays, X.dims):
                    if lay.encoding != "v2":
                        continue
                    what = (f"fused_v2 rank={rank} {idx} {vdt}/{fdt} "
                            f"mode={m} acc={acc}")
                    _close(kernels.fused_mttkrp_v2(lay, tf, m, width, acc),
                           kernels.fused_mttkrp_v2_plain(lay, tf, m, width,
                                                         acc), what)
                    launched += 1
    assert launched >= 3 * 2 * 6 * 2


def _guard_tensor(rng, dims=(60, 47, 83), nnz=6000):
    inds = np.stack([rng.integers(0, d, size=nnz) for d in dims])
    return SparseTensor(inds, rng.random(nnz) + 0.1, dims).deduplicate()


@pytest.mark.gpu
def test_cuda_guarded_and_checkpointed_cpd(tmp_path):
    """The guarded driver on the card with fused_t on every sorted mode: a
    cpd.sweep NaN at iteration 3 rolls back (one health_nonfinite and one
    health_rollback, a finite fit) with fused_t launched for the re-run
    sweep too; a run stopped after iteration 2 and resumed from its
    checkpoint follows the uninterrupted one within 1e-5, and the
    checkpoint verifies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import BlockAlloc, Options, Verbosity
    from splatt_tpu_torch.cpd import cpd_als, load_checkpoint
    from splatt_tpu_torch.utils import faults

    rng = np.random.default_rng(29)
    X = _guard_tensor(rng)
    rank, iters = 8, 5
    init = [rng.random((d, rank)) for d in X.dims]
    opts = Options(max_iterations=iters, tolerance=0.0, random_seed=1,
                   verbosity=Verbosity.NONE, engine_fallback=False,
                   block_alloc=BlockAlloc.ALLMODE)
    bs = BlockedSparse.from_coo(X, opts, device="cuda")
    resilience.reset_demotions()
    resilience.run_report().clear()
    whole = cpd_als(bs, rank, opts, init=init)
    with resilience.scope("card", health_retries=2) as sc:
        kernels.reset_launches()
        with faults.inject("cpd.sweep", "nan", iter_at=3):
            rolled = cpd_als(bs, rank, opts, init=init)
        torch.cuda.synchronize()
    kinds = [e["kind"] for e in sc.report.events()]
    assert kinds.count("health_nonfinite") == 1
    assert kinds.count("health_rollback") == 1
    assert math.isfinite(rolled.fit) and 0.0 < rolled.fit <= 1.0
    assert kernels.fused_mttkrp_t.launches == 3 * (iters + 1)
    assert not resilience.demotions()
    ck = str(tmp_path / "c.npz")
    first = cpd_als(bs, rank, opts, init=init, checkpoint_path=ck,
                    checkpoint_every=2, stop=lambda: True)
    assert list(first.fit_iters) == [1]
    assert load_checkpoint(ck)[2] == 1
    rest = cpd_als(bs, rank, opts, checkpoint_path=ck, checkpoint_every=2)
    assert list(rest.fit_iters) == [2, 3, 4, 5]
    np.testing.assert_allclose(first.fits + rest.fits, whole.fits,
                               atol=1e-5, rtol=0)
    assert load_checkpoint(ck)[2] == 4


def _count_syncs(fn) -> int:
    """How many host syncs `fn` makes, from the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in got)


@pytest.mark.gpu
def test_cuda_guard_and_trace_add_no_sync():
    """A checked iteration syncs the host as often with the sentinel and
    the tracing on as with both off (the finite checks ride the fit read;
    spans read the host clock only): syncs of a 3-iteration run less those
    of a 2-iteration run, per setting."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import resilience, trace
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import Options, Verbosity
    from splatt_tpu_torch.cpd import cpd_als

    rng = np.random.default_rng(31)
    X = _guard_tensor(rng)
    init = [rng.random((d, 8)) for d in X.dims]
    bs = BlockedSparse.from_coo(X, Options(), device="cuda")
    per_iter = {}
    for guard, traced in ((0, False), (2, False), (2, True)):
        counts = []
        for iters in (2, 3):
            opts = Options(max_iterations=iters, tolerance=0.0,
                           verbosity=Verbosity.NONE, trace=traced)
            with resilience.scope("s", health_retries=guard):
                counts.append(_count_syncs(
                    lambda: cpd_als(bs, 8, opts, init=init)))
        per_iter[(guard, traced)] = counts[1] - counts[0]
    trace.reset()
    assert len(set(per_iter.values())) == 1, per_iter
    assert per_iter[(0, False)] >= 1


#: the engines a tuner may measure on a card: kernel engines alone
CARD_ENGINES = ("fused_v2", "fused_t", "fused_tg", "fused",
                "unfused_pallas", "fused_dense")


def _tune_env(monkeypatch, tmp_path):
    from splatt_tpu_torch import resilience, tune

    monkeypatch.setenv("SPLATT_TUNE_CACHE", str(tmp_path / "tune.json"))
    tune.reset_memo()
    resilience.reset_demotions()
    resilience.run_report().clear()
    return tune


@pytest.mark.gpu
def test_cuda_tune_persists_kernel_engine_plans(monkeypatch, tmp_path):
    """A tune on the card measures kernel engines only and persists one
    plan per mode under the card's name; a second tune measures
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    from splatt_tpu_torch.config import Options, Verbosity

    tune = _tune_env(monkeypatch, tmp_path)
    X = _guard_tensor(np.random.default_rng(41))
    opts = Options(verbosity=Verbosity.NONE)
    kw = dict(blocks=(512, 2048), reorders=("identity",), reps=1,
              device="cuda")
    res = tune.tune(X, 8, opts, **kw)
    assert sorted(res.plans) == [0, 1, 2] and res.measured > 0
    assert all(p.engine in CARD_ENGINES for p in res.plans.values())
    envs = json.loads((tmp_path / "tune.json").read_text())["envs"]
    assert [k.split("|")[2] for k in envs] == [
        torch.cuda.get_device_name()]
    warm = tune.tune(X, 8, opts, **kw)
    assert (warm.measured, warm.cache_hits) == (0, 3)


@pytest.mark.gpu
def test_cuda_tuned_cpd_fit_matches_untuned(monkeypatch, tmp_path):
    """The CPD built and dispatched at the tuned plans (f32 values pinned,
    so the fits compare) follows the untuned one within 1e-4, carries a
    tuned_plan event for every mode and launches the tuned engines."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import BlockAlloc, Options, Verbosity
    from splatt_tpu_torch.cpd import cpd_als

    tune = _tune_env(monkeypatch, tmp_path)
    rng = np.random.default_rng(43)
    X = _guard_tensor(rng)
    init = [rng.random((d, 8)) for d in X.dims]
    opts = Options(max_iterations=5, tolerance=0.0, random_seed=1,
                   verbosity=Verbosity.NONE, engine_fallback=False,
                   block_alloc=BlockAlloc.ALLMODE)
    res = tune.tune(X, 8, opts, blocks=(512, 2048),
                    formats=[("i32", "auto"), ("auto", "auto")],
                    reorders=("identity",), reps=1, device="cuda")
    assert sorted(res.plans) == [0, 1, 2]
    tuned_bs = BlockedSparse.compile(X, opts, device="cuda", rank=8)
    assert [lay.block for lay in tuned_bs.layouts] == [
        res.plans[m].nnz_block for m in range(3)]
    kernels.reset_launches()
    tuned = cpd_als(tuned_bs, 8, opts, init=init)
    torch.cuda.synchronize()
    events = resilience.run_report().events("tuned_plan")
    assert len(events) == 1 and sorted(events[0]["plans"]) == [0, 1, 2]
    names = {"fused_t": "fused_mttkrp_t", "fused_tg": "fused_mttkrp_tg",
             "fused_v2": "fused_mttkrp_v2"}
    for m, p in res.plans.items():
        if p.engine in names:
            assert getattr(kernels, names[p.engine]).launches > 0
    off = Options(max_iterations=5, tolerance=0.0, random_seed=1,
                  verbosity=Verbosity.NONE, engine_fallback=False,
                  block_alloc=BlockAlloc.ALLMODE, autotune=False)
    plain = cpd_als(BlockedSparse.from_coo(X, off, device="cuda"), 8, off,
                    init=init)
    assert abs(tuned.fit - plain.fit) <= 1e-4


@pytest.mark.gpu
def test_cuda_bench_kernel_chain_agrees_with_stream():
    """bench's blocked_pallas (the kernel chain) and the plain algorithms
    on the card within the CLI's f32 gate of stream, each timed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.bench_algs import bench_mttkrp, crosscheck_mttkrp
    from splatt_tpu_torch.config import BlockAlloc, Options, Verbosity

    X = _guard_tensor(np.random.default_rng(47))
    opts = Options(block_alloc=BlockAlloc.TWOMODE, verbosity=Verbosity.NONE,
                   random_seed=3)
    algs = ("stream", "blocked", "blocked_pallas", "scatter", "ttbox")
    assert crosscheck_mttkrp(X, rank=16, algs=algs, opts=opts,
                             device="cuda") <= 9e-3
    res = bench_mttkrp(X, rank=16, algs=algs, opts=opts, reps=2,
                       device="cuda")
    assert all(t > 0 for alg in algs for t in res[alg])


@pytest.mark.gpu
def test_cuda_dense_tensor_tunes_over_fused_dense(monkeypatch, tmp_path):
    """On the near-dense tensor each dense-eligible mode's tune measures
    fused_dense (never the plain dense_xla), every winner is a kernel
    engine, and a dense winner builds a dense layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import Options, Verbosity

    tune = _tune_env(monkeypatch, tmp_path)
    rng = np.random.default_rng(9)
    dims = (16, 32, 120)
    flat = rng.choice(int(np.prod(dims)), 4000, replace=False)
    X = SparseTensor(np.stack(np.unravel_index(flat, dims)),
                     rng.random(4000) + 0.1, dims)
    seen = []
    real = tune._measure_candidate

    def spy(layout, factors, mode, path, engine, st, **kw):
        seen.append((mode, engine))
        return real(layout, factors, mode, path, engine, st, **kw)

    monkeypatch.setattr(tune, "_measure_candidate", spy)
    opts = Options(dense="auto", verbosity=Verbosity.NONE)
    res = tune.tune(X, 8, opts, blocks=(1024,), reorders=("identity",),
                    formats=[("i32", "auto")], reps=1, device="cuda")
    assert {(0, "fused_dense"), (1, "fused_dense")} <= set(seen)
    assert all(e in CARD_ENGINES for _, e in seen)
    assert all(p.engine in CARD_ENGINES for p in res.plans.values())
    # with the dense policy off, only a dense plan gives a dense layout
    bs = BlockedSparse.compile(X, Options(verbosity=Verbosity.NONE),
                               device="cuda", rank=8)
    for m, p in res.plans.items():
        assert (bs.layout_for(m).encoding == "dense") == (p.path == "dense")


@pytest.mark.gpu
def test_cuda_solver_cap_flag_stays_in_its_job(tmp_path):
    """A sym_eig launch forced to hit its sweep cap in one thread's
    resilience scope raises in that scope only: a neighbour's CPD on
    another thread, run after the cap hit and before the check, reads its
    own word at every fit check and finishes clean, and never clears the
    capped job's word."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import Options, Verbosity
    from splatt_tpu_torch.cpd import cpd_als
    from splatt_tpu_torch.ops import linalg

    capped, neighbour_done = threading.Event(), threading.Event()
    out = {}

    def job_a():
        with resilience.scope("a"):
            A = torch.from_numpy(spectrum("spd", 32, 3)).to("cuda",
                                                            torch.float32)
            linalg.sym_eig(A, max_sweeps=1)
            torch.cuda.synchronize()
            capped.set()
            neighbour_done.wait(120)
            try:
                linalg.check_solver()
                out["a"] = "no raise"
            except linalg.SolverError:
                out["a"] = "raised"
            # read once, then clear
            out["a_after"] = linalg.clear_solver_status()

    def job_b():
        with resilience.scope("b"):
            capped.wait(120)
            try:
                rng = np.random.default_rng(4)
                dims = (300, 200, 100)
                X = SparseTensor(
                    np.stack([rng.integers(0, d, 20000) for d in dims]),
                    rng.random(20000), dims).deduplicate()
                opts = Options(max_iterations=6, tolerance=0.0,
                               random_seed=1, engine_fallback=False,
                               verbosity=Verbosity.NONE)
                bs = BlockedSparse.from_coo(X, opts, device="cuda")
                launches = linalg.sym_eig.launches
                res = cpd_als(bs, 16, opts, device="cuda")
                out["b"] = (res.fit, linalg.sym_eig.launches - launches)
            except Exception as e:   # noqa: BLE001 - reported below
                out["b"] = e
            finally:
                neighbour_done.set()

    threads = [threading.Thread(target=job_a), threading.Thread(target=job_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not isinstance(out["b"], Exception), out["b"]
    fit, launches = out["b"]
    assert np.isfinite(fit) and launches >= 3 * 6
    assert out["a"] == "raised" and out["a_after"] is False
    # the process's own word saw neither
    linalg.check_solver()


@pytest.mark.gpu
def test_cuda_a_queued_cap_hit_stays_in_its_scope():
    """A job that leaves its resilience scope while its capped sym_eig
    launch is still queued behind a long kernel (a host-side raise before
    its next sync): the next scope, entered at once on the same thread,
    holds another word and never reads that cap hit, before or after the
    card finishes the launch; once it has, the word comes back cleared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.ops import linalg

    A = torch.from_numpy(spectrum("spd", 32, 3)).to("cuda", torch.float32)
    torch.cuda.synchronize()
    with resilience.scope("a"):
        a = linalg._WORD.get()
        torch.cuda._sleep(200_000_000)
        linalg.sym_eig(A, max_sweeps=1)
    with resilience.scope("b"):
        b = linalg._WORD.get()
        early = linalg.clear_solver_status()
        torch.cuda.synchronize()
        late = linalg.clear_solver_status()
    assert b != a and not early and not late
    with resilience.scope("c"):
        linalg.check_solver()
    linalg.check_solver()


@pytest.mark.gpu
def test_cuda_fleet_adoption_launches_the_kernels(monkeypatch, tmp_path):
    """Two fleet replicas in one process on the card: the first accepts a
    job and stops before running it; once its lease would have expired the
    second adopts the job, which launches fused_mttkrp_t and sym_eig on
    the adopter's worker (engine fallback off), and the job's serve.job
    span counts those launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from splatt_tpu_torch import serve, trace
    from splatt_tpu_torch.ops import linalg

    monkeypatch.setenv("SPLATT_ENGINE_FALLBACK", "0")
    root = str(tmp_path / "spool")
    spec = {"id": "adopt", "rank": 16, "iters": 5, "tol": 0.0, "seed": 0,
            "synthetic": {"dims": [600, 400, 200], "nnz": 60000,
                          "seed": 3}}
    a = serve.Server(root, workers=1, fleet=True, replica="ra",
                     lease_s=0.3)
    a.submit(spec)
    a.shutdown()
    time.sleep(0.4)
    kernels.reset_launches()
    linalg.sym_eig.launches = 0
    trace.set_enabled(True)
    try:
        b = serve.Server(root, workers=1, fleet=True, replica="rb",
                         lease_s=30.0)
        try:
            assert b.run_once()["counts"] == {"done": 1}
        finally:
            b.shutdown()
        span, = [s for s in trace.spans("serve.job") if s["job"] == "adopt"]
    finally:
        trace.set_enabled(None)
        trace.reset()
    res = serve.read_result(root, "adopt")
    assert res["status"] == "converged" and res["demotions"] == []
    assert res["replica"] == "rb" and res["adopted_from"] == "ra"
    launches = span["args"]["launches"]
    assert launches.get("fused_mttkrp_t", 0) > 0
    assert launches["fused_mttkrp_t"] == kernels.fused_mttkrp_t.launches
    assert launches.get("sym_eig", 0) == linalg.sym_eig.launches > 0


@pytest.mark.gpu
def test_cuda_chaos_card_schedule_demotes_to_a_kernel_and_the_drill_raises():
    """The plain chaos soak on the card under its default schedule
    (chaos.CARD_SCHEDULE): every armed site fires, the fused_t fault
    demotes fused_t and the CPD goes on to launch fused_mttkrp_tg, and the
    comm drill on 4 virtual ranks of the card raises the injected
    failure, caught and recorded as the drill's evidence."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from splatt_tpu_torch import chaos, resilience
    from splatt_tpu_torch.utils import faults

    try:
        res = chaos.run_chaos(smoke=True, device="cuda")
    finally:
        faults.reset()
        resilience.reset_demotions()
    assert res.ok, res.violations
    assert res.schedule == chaos.CARD_SCHEDULE
    assert all(res.fired.get(site) for site in faults.parse_schedule(
        chaos.CARD_SCHEDULE)), res.fired
    assert any(e["kind"] == "engine_demotion" and e.get("engine") == "fused_t"
               for e in res.events)
    assert res.launches.get("fused_mttkrp_tg", 0) > 0, res.launches
    assert res.drill["raised"] and "injected" in res.drill["error"]
    assert res.finite and res.verdict in ("converged", "degraded")
