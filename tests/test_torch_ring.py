"""The port's sync ring, ring-kernel entries, mesh and distributed helpers
against the JAX package's, on the CPU.

The JAX functions run under ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py`` (its async entries take their ppermute fallback off
the TPU), the port's on a virtual CPU mesh of the same rank count, from
the same numpy inputs in f64.  Tolerances: the gather is exact (each row
is a copy); the reduce 1e-12 (the port sums in hop order, the JAX ring in
psum's order).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from splatt_tpu.parallel import common as jcommon
from splatt_tpu.parallel import distribute as jdistribute
from splatt_tpu.parallel.mesh import auto_grid as jax_auto_grid
from splatt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from splatt_tpu.parallel.ring import blockwise_reduce_rows as jax_reduce
from splatt_tpu.parallel.ring import ring_gather_rows as jax_gather
from splatt_tpu.parallel.ring_kernels import (
    async_blockwise_reduce_rows as jax_async_reduce,
    async_ring_gather_rows as jax_async_gather)
from splatt_tpu.utils.env import shard_map
from splatt_tpu_torch import resilience
from splatt_tpu_torch.parallel import common, distribute, ring, ring_kernels
from splatt_tpu_torch.parallel.mesh import Mesh, auto_grid, make_mesh
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

NDEVS = [2, 3, 4, 8]
R = 4
NNZ_PER_RANK = 23


def _inputs(ndev: int, seed: int):
    """A (ndev*block, R) factor, each rank's ids over all of it (some in
    every shard), each rank's (nnz, R) products."""
    rng = np.random.default_rng(seed)
    block = 5 + ndev
    U = rng.random((ndev * block, R))
    idx = rng.integers(0, ndev * block,
                       size=(ndev, NNZ_PER_RANK)).astype(np.int32)
    prod = rng.random((ndev, NNZ_PER_RANK, R))
    return block, U, idx, prod


def _jax_run(fn, ndev, a, idx, out_spec):
    mesh = jax_make_mesh(n_devices=ndev)
    a_s = jax.device_put(jnp.asarray(a.reshape(-1, R)),
                         NamedSharding(mesh, P("nnz", None)))
    i_s = jax.device_put(jnp.asarray(idx.reshape(-1)),
                         NamedSharding(mesh, P("nnz")))

    @partial(shard_map, mesh=mesh, in_specs=(P("nnz", None), P("nnz")),
             out_specs=out_spec, check_vma=False)
    def run(a_l, idx_l):
        return fn(a_l, idx_l)

    return np.asarray(run(a_s, i_s))


def _port_operands(ndev, block, U, idx, prod):
    mesh = make_mesh(n_devices=ndev, device="cpu")
    U_l = [torch.from_numpy(U[d * block:(d + 1) * block]) for d in range(ndev)]
    idx_l = [torch.from_numpy(idx[d]) for d in range(ndev)]
    prod_l = [torch.from_numpy(prod[d]) for d in range(ndev)]
    return mesh, U_l, idx_l, prod_l


@pytest.mark.parametrize("entry", ["sync", "async"])
@pytest.mark.parametrize("ndev", NDEVS)
def test_gather_matches_jax(ndev, entry):
    block, U, idx, prod = _inputs(ndev, seed=ndev)
    jfn = jax_gather if entry == "sync" else jax_async_gather
    want = _jax_run(lambda u, i: jfn(u, i, "nnz", ndev), ndev, U, idx,
                    P("nnz", None)).reshape(ndev, NNZ_PER_RANK, R)
    mesh, U_l, idx_l, _ = _port_operands(ndev, block, U, idx, prod)
    fn = (ring.ring_gather_rows if entry == "sync"
          else ring_kernels.async_ring_gather_rows)
    got = fn(U_l, idx_l, mesh)
    for d in range(ndev):
        np.testing.assert_array_equal(got[d].numpy(), want[d])
        np.testing.assert_array_equal(got[d].numpy(), U[idx[d]])


@pytest.mark.parametrize("entry", ["sync", "async"])
@pytest.mark.parametrize("ndev", NDEVS)
def test_reduce_matches_jax(ndev, entry):
    block, U, idx, prod = _inputs(ndev, seed=10 + ndev)
    jfn = jax_reduce if entry == "sync" else jax_async_reduce
    want = _jax_run(lambda p, i: jfn(p, i, "nnz", ndev, block), ndev, prod,
                    idx, P("nnz", None))
    mesh, _, idx_l, prod_l = _port_operands(ndev, block, U, idx, prod)
    fn = (ring.blockwise_reduce_rows if entry == "sync"
          else ring_kernels.async_blockwise_reduce_rows)
    got = torch.cat(fn(prod_l, idx_l, mesh, block)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    dense = np.zeros((ndev * block, R))
    np.add.at(dense, idx.reshape(-1), prod.reshape(-1, R))
    np.testing.assert_allclose(got, dense, atol=1e-12, rtol=0)


def test_async_entries_equal_sync_ring_bitwise_on_cpu():
    ndev = 4
    block, U, idx, prod = _inputs(ndev, seed=3)
    mesh, U_l, idx_l, prod_l = _port_operands(ndev, block, U, idx, prod)
    for a, b in zip(ring_kernels.async_ring_gather_rows(U_l, idx_l, mesh),
                    ring.ring_gather_rows(U_l, idx_l, mesh)):
        assert torch.equal(a, b)
    for a, b in zip(ring_kernels.async_blockwise_reduce_rows(
            prod_l, idx_l, mesh, block),
            ring.blockwise_reduce_rows(prod_l, idx_l, mesh, block)):
        assert torch.equal(a, b)


def test_kernel_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing."""
    ndev = 3
    block, U, idx, prod = _inputs(ndev, seed=4)
    mesh, U_l, idx_l, prod_l = _port_operands(ndev, block, U, idx, prod)
    ring_kernels.reset_launches()
    for a, b in zip(ring_kernels.ring_gather(U_l, idx_l, mesh),
                    ring.gather_hops(U_l, idx_l, mesh)):
        assert torch.equal(a, b)
    for a, b in zip(ring_kernels.ring_reduce(prod_l, idx_l, mesh, block),
                    ring.blockwise_reduce_rows(prod_l, idx_l, mesh, block)):
        assert torch.equal(a, b)
    assert ring_kernels.ring_gather.launches == 0
    assert ring_kernels.ring_reduce.launches == 0


def test_ids_of_no_shard_give_zero_rows():
    """A pad id (owner -1) or an id past the last block matches no shard:
    a zero gathered row and nothing added."""
    ndev, block = 3, 4
    mesh = make_mesh(n_devices=ndev, device="cpu")
    U_l = [torch.full((block, 2), float(d + 1)) for d in range(ndev)]
    idx_l = [torch.tensor([-1, 5, ndev * block + 3], dtype=torch.int32)
             for _ in range(ndev)]
    for rows in ring.gather_hops(U_l, idx_l, mesh):
        assert rows[0].abs().sum() == 0 and rows[2].abs().sum() == 0
        assert torch.equal(rows[1], torch.full((2,), 2.0))
    prod_l = [torch.ones((3, 2)) for _ in range(ndev)]
    out = torch.cat(ring.blockwise_reduce_rows(prod_l, idx_l, mesh, block))
    assert float(out.sum()) == 2.0 * ndev and float(out[5, 0]) == ndev


def test_bf16_gather_is_exact_and_reduce_accumulates_f32():
    ndev = 4
    block, U, idx, prod = _inputs(ndev, seed=5)
    mesh, U_l, idx_l, prod_l = _port_operands(ndev, block, U, idx, prod)
    U_b = [u.to(torch.bfloat16) for u in U_l]
    p_b = [p.to(torch.bfloat16) for p in prod_l]
    full = torch.cat(U_b)
    for d, rows in enumerate(ring.gather_hops(U_b, idx_l, mesh)):
        assert rows.dtype == torch.bfloat16
        assert torch.equal(rows, full[idx_l[d].long()])
    out = ring.blockwise_reduce_rows(p_b, idx_l, mesh, block)
    assert all(o.dtype == torch.float32 for o in out)
    dense = np.zeros((ndev * block, R))
    np.add.at(dense, idx.reshape(-1),
              torch.cat(p_b).double().numpy())
    np.testing.assert_allclose(torch.cat(out).double().numpy(), dense,
                               rtol=1e-6)


def test_make_mesh_on_the_cpu():
    mesh = make_mesh(n_devices=4, device="cpu")
    assert mesh.ndev == 4 and mesh.virtual and not mesh.is_cuda
    assert mesh.axis == "nnz" and mesh.ranks_on(mesh.devices[0]) \
        == [0, 1, 2, 3]
    assert make_mesh(device="cpu").ndev == 8
    two = make_mesh(n_devices=5, devices=["cpu"])
    assert two.ndev == 5 and two.cards == (torch.device("cpu"),)
    assert Mesh((torch.device("cpu"),)).virtual is False
    with pytest.raises(ValueError):
        make_mesh(n_devices=0, device="cpu")


def test_make_mesh_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(n_devices=2)


@pytest.mark.parametrize("n,dims", [(8, (100, 50, 25)), (12, (7, 300, 40)),
                                    (6, (10, 10))])
def test_auto_grid_matches_jax(n, dims):
    assert auto_grid(n, dims) == jax_auto_grid(n, dims)


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("variant", ["all2all", "ring", "async_ring"])
def test_comm_volume_model_matches_jax(variant, ndev):
    dims_pad = (64, 48, 80)
    for itemsize, acc in ((8, 8), (4, 4), (2, 4)):
        assert common.comm_volume_model(
            dims_pad, 16, itemsize, ndev=ndev, acc_itemsize=acc,
            variant=variant) == jcommon.comm_volume_model(
            dims_pad, 16, itemsize, ndev=ndev, acc_itemsize=acc,
            variant=variant)
    assert common.comm_volume_report(dims_pad, 16, 4, ndev=ndev,
                                     variant=variant) \
        == jcommon.comm_volume_report(dims_pad, 16, 4, ndev=ndev,
                                      variant=variant)


def test_bucket_scatter_matches_jax():
    tt = gen.fixture_tensor("med")
    owner = np.random.default_rng(1).integers(0, 5, size=tt.nnz)
    got = common.bucket_scatter(tt.inds, tt.vals, owner, 5, np.float64)
    want = jcommon.bucket_scatter(tt.inds, tt.vals, owner, 5, np.float64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="owner ids"):
        common.bucket_scatter(tt.inds, tt.vals, owner + 5, 5, np.float64)


def test_row_relabels_match_jax():
    tt = gen.fixture_tensor("med4")
    for m in range(tt.nmodes):
        hist = tt.mode_histogram(m)
        cap = -(-tt.dims[m] // 4)
        np.testing.assert_array_equal(common.balanced_relabel(hist, 4, cap),
                                      jcommon.balanced_relabel(hist, 4, cap))
    got, gst = distribute.comm_minimizing_relabels(tt.inds, tt.dims, 4)
    want, wst = jdistribute.comm_minimizing_relabels(tt.inds, tt.dims, 4)
    assert gst == wst
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_imbalance_records_match_jax():
    from splatt_tpu import resilience as jres

    counts = np.array([10, 40, 5, 5])
    assert common.imbalance_report(counts, "shard") \
        == jcommon.imbalance_report(counts, "shard")
    assert common.max_mean_ratio(counts) == 2.667
    resilience.run_report().clear()
    jres.run_report().clear()
    got = common.record_shard_imbalance("shard", counts, policy="equal")
    want = jcommon.record_shard_imbalance("shard", counts, policy="equal")
    assert got == want
    assert resilience.run_report().summary() == jres.run_report().summary()
    resilience.run_report().clear()
    jres.run_report().clear()


def _plan_ids(ndev: int, block: int, nnz: int, seed: int):
    """Each rank's int32 ids over every shard, with pads of no shard (-1
    and ids past the last block) among them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, ndev * block, size=(ndev, nnz)).astype(np.int32)
    ids[:, ::7] = -1
    ids[:, 3::11] = ndev * block + 2
    return [torch.from_numpy(i) for i in ids]


@pytest.mark.parametrize("ndev", NDEVS)
def test_gather_plan_buckets_by_owner(ndev):
    """Each rank's plan is a permutation of its nonzeros, sorted by id and
    stable among equal ids within a bucket; bucket b holds exactly the ids
    with id // block == b at their within-block rows; ids of no shard get
    the last bucket, in their own order."""
    block, nnz = 6 + ndev, 97
    mesh = make_mesh(n_devices=ndev, device="cpu")
    idx = _plan_ids(ndev, block, nnz, seed=ndev)
    ring_kernels.reset_launches()
    plans = ring_kernels.build_ring_plans(idx, mesh, block)
    assert ring_kernels.build_ring_plans.builds == ndev
    for ids, plan in zip(idx, plans):
        assert plan.pos.dtype == plan.loc.dtype == plan.offsets.dtype \
            == torch.int32
        assert plan.offsets.shape == (ndev + 2,)
        pos = plan.pos.long()
        assert torch.equal(torch.sort(pos).values, torch.arange(nnz))
        off = plan.offsets.tolist()
        assert off[0] == 0 and off[-1] == nnz
        ids = ids.long()
        for b in range(ndev + 1):
            sel = pos[off[b]:off[b + 1]]
            got = ids[sel]
            if b < ndev:
                step = got[1:] - got[:-1]
                assert bool((step >= 0).all())             # by id
                assert bool((sel[1:] > sel[:-1])[step == 0].all())
            else:
                assert bool((sel[1:] > sel[:-1]).all())    # stable
            if b < ndev:
                assert bool((torch.div(got, block, rounding_mode="floor")
                             == b).all())
                assert torch.equal(plan.loc[off[b]:off[b + 1]].long(),
                                   got - b * block)
            else:
                assert bool(((got < 0) | (got >= ndev * block)).all())
        none = (ids < 0) | (ids >= ndev * block)
        assert off[ndev + 1] - off[ndev] == int(none.sum())


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("ndev", NDEVS)
def test_async_gather_through_the_plan_equals_sync_ring(ndev, dtype):
    """async_ring_gather_rows over the plans, and the kernel's plain walk,
    equal the sync ring bit for bit on a CPU mesh, pads included, and a
    plan serves every later gather at the same ids."""
    block, nnz = 5 + ndev, 61
    mesh = make_mesh(n_devices=ndev, device="cpu")
    idx = _plan_ids(ndev, block, nnz, seed=20 + ndev)
    plans = ring_kernels.build_ring_plans(idx, mesh, block)
    rng = np.random.default_rng(ndev)
    for _ in range(2):
        U_l = [torch.from_numpy(rng.random((block, R))).to(dtype)
               for _ in range(ndev)]
        want = ring.ring_gather_rows(U_l, idx, mesh)
        for got in (ring_kernels.async_ring_gather_rows(U_l, idx, mesh,
                                                        plans),
                    ring_kernels.ring_gather_plain(U_l, plans, mesh),
                    ring_kernels.ring_gather(U_l, idx, mesh, plans=plans)):
            for g, w in zip(got, want):
                assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("ndev", [4, 8])
def test_fine_run_builds_one_plan_per_mode_per_rank(ndev):
    """A FINE ASYNC_RING run on virtual CPU ranks builds its ring plans
    once: nmodes x ndev, however many iterations, gathers and reduces
    share them; its fits equal the ring run's."""
    from splatt_tpu_torch.config import CommPattern, Options, Verbosity
    from splatt_tpu_torch.coo import SparseTensor
    from splatt_tpu_torch.parallel import sharded_cpd_als

    tt = gen.fixture_tensor("med")
    X = SparseTensor(tt.inds, tt.vals, tt.dims)
    mesh = make_mesh(n_devices=ndev, device="cpu")
    rng = np.random.default_rng(ndev)
    init = [rng.random((d, 3)) for d in X.dims]
    fits = {}
    for comm in (CommPattern.ASYNC_RING, CommPattern.POINT2POINT):
        ring_kernels.reset_launches()
        out = sharded_cpd_als(X, 3, mesh=mesh, init=init, opts=Options(
            max_iterations=3, tolerance=0.0, comm_pattern=comm,
            val_dtype=torch.float64, verbosity=Verbosity.NONE),
            measure_overlap=False)
        fits[comm] = out.fits
        want = X.nmodes * ndev if comm is CommPattern.ASYNC_RING else 0
        assert ring_kernels.build_ring_plans.builds == want
    assert fits[CommPattern.ASYNC_RING] == fits[CommPattern.POINT2POINT]
