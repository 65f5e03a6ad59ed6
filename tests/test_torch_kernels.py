"""fused_mttkrp_t and fused_mttkrp: the port's plain versions against the
JAX Pallas kernels (interpret mode), in f64 at 1e-10 (the repo's TOL);
the gathering walk's load widths and the operands the wrappers hand the C
entries.  The CUDA kernels against their plain versions on a card:
tests/test_torch_kernels_gpu.py.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from splatt_tpu.blocked import build_layout
from splatt_tpu.ops.pallas_kernels import fused_mttkrp, fused_mttkrp_t
from splatt_tpu_torch import state
from splatt_tpu_torch.ops import kernels
from tests import gen
from tests.test_torch_kernels_gpu import _crosses_blocks, contracts
from tests.test_mttkrp import TOL, make_factors
from tests.torch_fixtures import private_tune_cache  # noqa: F401


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


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("chunk", [3, 5])
def test_plain_rowmajor_matches_pallas_across_blocks(chunk, accumulate):
    """fused_mttkrp with `chunk` blocks per grid step (5 does not divide
    the 12 blocks, so the JAX kernel pads) against the port's plain
    versions of fused_mttkrp and fused_mttkrp_t, on blocks of 64 whose
    row runs cross block boundaries."""
    tt = gen.fixture_tensor("med")
    jf = make_factors(tt.dims, rank=6)
    tf = [torch.from_numpy(np.array(U)) for U in jf]
    lays = [build_layout(tt, m, block=64, val_dtype=np.float64)
            for m in range(tt.nmodes)]
    assert all(lay.nblocks % 5 and _crosses_blocks(port_layout(lay))
               for lay in lays)
    for lay, m, width, acc in contracts(lays, tt.dims):
        if acc != accumulate:
            continue
        want = np.asarray(fused_mttkrp(lay, jf, m, width, accumulate=acc,
                                       interpret=True, chunk=chunk))
        port = port_layout(lay)
        for got in (kernels.fused_mttkrp(port, tf, m, width, acc,
                                         chunk=chunk),
                    kernels.fused_mttkrp_t(port, tf, m, width, acc)):
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                       err_msg=f"chunk={chunk} mode={m}")


#: (nv, vec) pairs csrc/gather_walk.cuh's dispatch_chunks builds, by
#: element bytes
BUILT_CHUNKS = {4: {(1, 1), (2, 1), (1, 2), (4, 1), (2, 2), (1, 4), (8, 1),
                    (4, 2), (2, 4)},
                2: {(1, 1), (2, 1), (1, 2), (4, 1), (2, 2), (1, 4), (8, 1),
                    (4, 2), (2, 4), (1, 8)}}


@pytest.mark.parametrize("R", list(range(1, 257)) + [257, 300, 512])
def test_gather_vec_takes_the_whole_rank(R):
    """fused_mttkrp_t and fused_mttkrp walk the whole rank in one tile
    (cols = R): up to 256 columns the walk's (nv, vec) is one it builds,
    covers R with the fewest columns a lane, loads aligned and as wide
    as R and the tables allow (R = 50 f32 8-byte loads, R = 256 f32 2 x
    16 bytes, odd R scalar loads); past 256 it refuses."""
    for itemsize in (4, 2):
        aligned = (0, 7 * R * itemsize + 4096)
        off = (0, 7 * R * itemsize + 4096 + itemsize)   # a table 1 off
        if R > 256:
            with pytest.raises(ValueError):
                kernels.gather_vec(R, R, itemsize, aligned)
            continue
        for addresses in (aligned, off):
            nv, vec = kernels.gather_vec(R, R, itemsize, addresses)
            assert (nv, vec) in BUILT_CHUNKS[itemsize]
            c = nv * vec
            assert 32 * c >= R and (c == 1 or 16 * c < R)
            assert R % vec == 0 and vec * itemsize <= 16
            assert all(a % (vec * itemsize) == 0 for a in addresses)
            if addresses is off:
                assert vec == 1
            else:
                # the widest power of two dividing R, the lane's columns
                # and the 16-byte load
                widest = 1
                while (widest * 2 <= min(c, 16 // itemsize)
                       and R % (widest * 2) == 0):
                    widest *= 2
                assert vec == widest
            covered = sorted((lane + 32 * v) * vec + i for lane in range(32)
                             for v in range(nv) for i in range(vec)
                             if (lane + 32 * v) * vec < R)
            assert covered == list(range(R))
    if R == 50:
        assert kernels.gather_vec(50, 50, 4, (0, 1400)) == (1, 2)
    if R == 256:
        assert kernels.gather_vec(256, 256, 4, (0, 1024)) == (2, 4)


def _meta_layout(lay):
    """A port layout whose tensors lie on the meta device: the wrappers
    take their kernel path (not the CPU's plain version) without a card,
    and the factors' data_ptr() are their byte offsets."""
    port = port_layout(lay)
    return dataclasses.replace(port, inds=port.inds.to("meta"),
                               vals=port.vals.to("meta"),
                               row_start=port.row_start.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 17, 50, 128, 200, 256])
@pytest.mark.parametrize("name", ["fused_mttkrp_t", "fused_mttkrp"])
def test_wrappers_pass_the_walks_load_width(name, R, dtype, monkeypatch):
    """fused_mttkrp_t and fused_mttkrp hand their C entry the (nv, vec)
    of gather_vec over the whole rank and the gathered tables'
    addresses, in the argument order of the entry's declared types, and
    count one launch; no card: the C call is recorded."""
    tt = gen.fixture_tensor("med")
    lay = _meta_layout(build_layout(tt, 0, block=64, val_dtype=np.float32))
    calls = []
    monkeypatch.setattr(kernels, "_launch",
                        lambda entry, *args: calls.append((entry, args)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    fn = getattr(kernels, name)
    monkeypatch.setattr(fn, "launches", 0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    for shift in (0, 1):
        # the second set of tables starts one element off alignment
        buf = [torch.empty(d * R + 1, dtype=dtype, device="meta")
               for d in tt.dims]
        tf = [b[shift:shift + d * R].view(d, R)
              for b, d in zip(buf, tt.dims)]
        kw = {"chunk": 3} if name == "fused_mttkrp" else {}
        fn(dataclasses.replace(lay, vals=lay.vals.to(dtype)), tf, 0,
           lay.seg_width, False, **kw)
        entry, args = calls[-1]
        assert entry == f"splatt_{name}"
        # the entry's declared operands, less the stream _launch appends
        assert len(args) + 1 == len(kernels._ENTRIES[entry][1])
        want = kernels.gather_vec(R, R, itemsize,
                                  [U.data_ptr() for U in tf[1:]])
        assert tuple(args[-3:-1]) == want
        if shift:
            assert want[1] == 1
        if kw:
            assert args[-4] == 3
        assert args[12] == R   # the rank operand
    assert fn.launches == 2


#: ranks the reductions' wrappers are checked at: scalar loads (1, 17),
#: 8-byte loads (50), one tile of 128, the whole rank or tiles above it
#: (200, 256), several tiles (512)
REDUCE_RANKS = [1, 17, 50, 128, 200, 256, 512]


@pytest.mark.parametrize("R", REDUCE_RANKS + [129, 257, 640])
def test_reduce_rank_tile_covers_the_rank(R):
    """The reductions' rank tile is the whole rank up to RANK_TILE and
    that tile above it; every tile is walked in whole aligned chunks
    (csrc/onehot_reduce.cu refuses anything else)."""
    rtile = kernels.reduce_rank_tile(R)
    assert rtile == min(R, kernels.RANK_TILE)
    tiles = -(-R // rtile)
    assert (tiles - 1) * rtile < R <= tiles * rtile
    for itemsize in (4, 2):
        nv, vec = kernels.gather_vec(R, min(rtile, R), itemsize, (0,))
        assert (nv, vec) in BUILT_CHUNKS[itemsize]
        assert rtile >= R or rtile % (32 * nv * vec) == 0
        assert 32 * nv * vec >= min(rtile, R) and R % vec == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", REDUCE_RANKS)
@pytest.mark.parametrize("name", ["onehot_reduce_sorted",
                                  "onehot_reduce_full"])
def test_reduction_wrappers_pass_the_walks_load_width(name, R, dtype,
                                                      monkeypatch):
    """onehot_reduce_sorted and onehot_reduce_full hand their C entry the
    rank tile of reduce_rank_tile and the (nv, vec) of gather_vec over
    that tile and the products' address, in the argument order of the
    entry's declared types, and count one launch each; the sorted
    wrapper's use_smem is that of its tile (a width whose tile fits
    shared memory, and the narrowest that does not); products aligned
    and one element off.  No card: meta-device tensors, the C call
    recorded."""
    nb, B = 3, 64
    calls = []
    monkeypatch.setattr(kernels, "_launch",
                        lambda entry, *args: calls.append((entry, args)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    fn = getattr(kernels, name)
    monkeypatch.setattr(fn, "launches", 0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    rtile = kernels.reduce_rank_tile(R)
    cols = min(rtile, R)
    fits = (kernels.SMEM_TILE_BYTES - kernels.REDUCE_SCRATCH_BYTES) \
        // (4 * cols)
    ids = torch.empty((nb, B), dtype=torch.int32, device="meta")
    n = 0
    for width in (8, fits + 1):
        for shift in (0, 1):
            buf = torch.empty(nb * B * R + 1, dtype=dtype, device="meta")
            prod = buf[shift:shift + nb * B * R].view(nb, B, R)
            out = fn(ids, prod, width)
            n += 1
            entry, args = calls[-1]
            assert entry == f"splatt_{name}"
            # the entry's declared operands, less the stream _launch
            # appends
            assert len(args) + 1 == len(kernels._ENTRIES[entry][1])
            assert args[1] == prod.data_ptr() == shift * itemsize
            assert args[2] == int(dtype == torch.bfloat16)
            assert tuple(args[3:7]) == (nb, B, R, width)
            want = kernels.gather_vec(R, cols, itemsize, [prod.data_ptr()])
            assert tuple(args[-3:-1]) == want
            assert args[-4] == rtile
            if shift:
                assert want[1] == 1
            if name == "onehot_reduce_sorted":
                assert len(args) == 12
                assert args[7] == int(width == 8)
                assert bool(args[7]) == kernels.reduce_uses_smem(width, cols)
                assert out.shape == (nb, width, R)
            else:
                assert len(args) == 11
                assert out.shape == (width, R)
            assert out.dtype == torch.float32
    assert fn.launches == n == 4


@pytest.mark.parametrize("name", sorted(kernels._ENTRIES))
def test_every_c_entry_declares_each_argument(name):
    """Each C entry's ctypes signature has one type per parameter of its
    definition in csrc/, the stream included: an argument left undeclared
    is passed as a C int, which truncates a pointer."""
    import re

    source, argtypes = kernels._ENTRIES[name]
    text = (kernels.CSRC / source).read_text()
    m = re.search(r"\bint\s+" + name + r"\(([^)]*)\)\s*\{", text)
    assert m is not None, f"{name} is not defined in {source}"
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(argtypes), (name, params)
