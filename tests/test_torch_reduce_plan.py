"""The ring kernels' id-sorted plans and the reduce's plain walk over them,
against the sync ring and the JAX package's ring, on the CPU.

A :class:`~splatt_tpu_torch.parallel.ring_kernels.RingPlan` sorts each
rank's nonzeros by global id, so ``ring_reduce`` can keep a running row sum
over a row's contiguous nonzeros; ``ring_reduce_plain`` is its walk in
torch, ``ring_gather_plain`` the gather's over the same plan.  The JAX
reduce runs under ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``.  Tolerances: the gather is exact (each row is a
copy); the reduce in f64 1e-10 (the plan walk sums a bucket in id order,
the sync ring in nonzero order, the JAX ring in psum's order); with f32
or bf16 products, summed in f32, 1e-5 of the largest output.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from splatt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from splatt_tpu.parallel.ring import blockwise_reduce_rows as jax_reduce
from splatt_tpu.utils.env import shard_map
from splatt_tpu_torch.parallel import ring, ring_kernels
from splatt_tpu_torch.parallel.mesh import make_mesh
from tests.torch_fixtures import private_tune_cache  # noqa: F401

NDEVS = [2, 4, 8]
R = 5
#: case -> (block, nonzeros per rank): awkward block sizes, buckets left
#: empty, pads of no shard, one long run of one row
CASES = {"awkward": (7, 53), "empty": (13, 41), "pads": (5, 37),
         "one_row": (3, 29)}
DTYPES = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


def _ids(case: str, ndev: int, seed: int) -> np.ndarray:
    """(ndev, nnz) int32 global ids of one case."""
    block, nnz = CASES[case]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, ndev * block, size=(ndev, nnz))
    if case == "empty":
        # only the first and last shards own nonzeros
        ids = np.where(rng.random((ndev, nnz)) < 0.5, ids % block,
                       (ndev - 1) * block + ids % block)
    elif case == "pads":
        ids[:, ::3] = -1
        ids[:, 1::5] = ndev * block + 1
    elif case == "one_row":
        ids[:] = block + 1 if ndev > 1 else 1
        ids[:, ::4] = 0
    return ids.astype(np.int32)


def _operands(case: str, ndev: int, dtype, seed: int):
    block, nnz = CASES[case]
    ids = _ids(case, ndev, seed)
    prod = np.random.default_rng(seed + 1).random((ndev, nnz, R))
    idx_l = [torch.from_numpy(i) for i in ids]
    prod_l = [torch.from_numpy(p).to(dtype) for p in prod]
    return block, ids, prod, idx_l, prod_l


def _jax_reduce(ndev: int, block: int, prod: np.ndarray,
                ids: np.ndarray) -> np.ndarray:
    mesh = jax_make_mesh(n_devices=ndev)
    p_s = jax.device_put(jnp.asarray(prod.reshape(-1, R)),
                         NamedSharding(mesh, P("nnz", None)))
    i_s = jax.device_put(jnp.asarray(ids.reshape(-1)),
                         NamedSharding(mesh, P("nnz")))

    @partial(shard_map, mesh=mesh, in_specs=(P("nnz", None), P("nnz")),
             out_specs=P("nnz", None), check_vma=False)
    def run(p_l, i_l):
        return jax_reduce(p_l, i_l, "nnz", ndev, block)

    return np.asarray(run(p_s, i_s))


def _owner_stable(plans):
    """The plans' positions stable by owner alone (each bucket's
    positions ascending), the order the gather walked before."""
    out = []
    for p in plans:
        owner = torch.repeat_interleave(
            torch.arange(int(p.offsets.shape[0]) - 1),
            torch.diff(p.offsets.long()))
        order = torch.sort(owner * int(p.pos.shape[0])
                           + p.pos.long()).indices
        out.append(ring_kernels.RingPlan(p.pos[order], p.loc[order],
                                         p.offsets, p.block))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ndev", NDEVS)
def test_plan_is_sorted_by_id_with_pads_last(ndev, case):
    """Each rank's plan is a permutation of its nonzeros sorted by global
    id, stable among equal ids; ids of no shard come last in their own
    order; the offsets bound the owner buckets, whose sizes are the
    owners' counts; loc is the row within the owner's block."""
    block, nnz = CASES[case]
    mesh = make_mesh(n_devices=ndev, device="cpu")
    ids = _ids(case, ndev, seed=ndev)
    ring_kernels.reset_launches()
    plans = ring_kernels.build_ring_plans(
        [torch.from_numpy(i) for i in ids], mesh, block)
    assert ring_kernels.build_ring_plans.builds == ndev
    for raw, plan in zip(ids, plans):
        assert plan.block == block
        assert plan.pos.dtype == plan.loc.dtype == plan.offsets.dtype \
            == torch.int32
        pos = plan.pos.long().numpy()
        assert np.array_equal(np.sort(pos), np.arange(nnz))
        owner = np.where((raw >= 0) & (raw < ndev * block), raw // block,
                         ndev)
        off = plan.offsets.tolist()
        assert off == [0] + np.cumsum(np.bincount(
            owner, minlength=ndev + 1)).tolist()
        real = off[ndev]
        got = raw[pos[:real]].astype(np.int64)
        step = np.diff(got)
        assert (step >= 0).all()
        assert (np.diff(pos[:real])[step == 0] > 0).all()      # stable
        assert np.array_equal(plan.loc[:real].numpy(),
                              got - (got // block) * block)
        pads = pos[real:]
        assert (owner[pads] == ndev).all() and (np.diff(pads) > 0).all()
        assert not plan.loc[real:].any()
        if case == "empty" and ndev > 2:
            assert off[1] == off[ndev - 1]      # the middle buckets


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ndev", NDEVS)
def test_reduce_plain_matches_sync_ring_and_jax(ndev, case, dtype):
    """ring_reduce_plain over the plans equals the sync ring's reduce and,
    in f64, the JAX package's ring and a dense numpy sum; f32 and bf16
    products sum in f32."""
    block, ids, prod, idx_l, prod_l = _operands(case, ndev, DTYPES[dtype],
                                                seed=3 * ndev)
    mesh = make_mesh(n_devices=ndev, device="cpu")
    plans = ring_kernels.build_ring_plans(idx_l, mesh, block)
    got = ring_kernels.ring_reduce_plain(prod_l, plans, mesh)
    sync = ring.blockwise_reduce_rows(prod_l, idx_l, mesh, block)
    want_dtype = torch.float64 if dtype == "f64" else torch.float32
    assert all(g.dtype == want_dtype and g.shape == (block, R) for g in got)
    got = torch.cat(got).double().numpy()
    sync = torch.cat(sync).double().numpy()
    if dtype == "f64":
        np.testing.assert_allclose(got, sync, atol=1e-10, rtol=0)
        np.testing.assert_allclose(got, _jax_reduce(ndev, block, prod, ids),
                                   atol=1e-10, rtol=0)
        dense = np.zeros((ndev * block, R))
        keep = (ids >= 0) & (ids < ndev * block)
        np.add.at(dense, ids[keep], prod[keep])
        np.testing.assert_allclose(got, dense, atol=1e-10, rtol=0)
    else:
        scale = max(float(np.abs(sync).max()), 1e-30)
        assert float(np.abs(got - sync).max()) <= 1e-5 * scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ndev", NDEVS)
def test_gather_plain_is_exact_on_both_orders(ndev, case, dtype):
    """The gather's plain walk over the id-sorted plans, and over the
    same buckets in the owner-stable order it walked before, equals the
    sync ring bit for bit, pads included."""
    block, _, _, idx_l, _ = _operands(case, ndev, dtype, seed=ndev + 7)
    mesh = make_mesh(n_devices=ndev, device="cpu")
    rng = np.random.default_rng(ndev)
    U_l = [torch.from_numpy(rng.random((block, R))).to(dtype)
           for _ in range(ndev)]
    want = ring.gather_hops(U_l, idx_l, mesh)
    plans = ring_kernels.build_ring_plans(idx_l, mesh, block)
    for plans in (plans, _owner_stable(plans)):
        for g, w in zip(ring_kernels.ring_gather_plain(U_l, plans, mesh),
                        want):
            assert g.dtype == dtype and torch.equal(g, w)


def test_reduce_takes_only_id_sorted_plans():
    """The reduce's running row sums need a row's nonzeros contiguous,
    which the id-sorted plan of its own ids over its own shards gives: a
    plan of other shards or of other ids is refused."""
    ndev, block = 3, 7
    mesh = make_mesh(n_devices=ndev, device="cpu")
    idx_l = [torch.from_numpy(i) for i in _ids("awkward", ndev, seed=1)]
    plans = ring_kernels.build_ring_plans(idx_l, mesh, block)
    for name in ("ring_reduce", "ring_gather"):
        ring_kernels._check_plans(name, plans, idx_l, block)
        with pytest.raises(ValueError, match="does not match"):
            ring_kernels._check_plans(name, plans, idx_l, block + 1)
        with pytest.raises(ValueError, match="does not match"):
            ring_kernels._check_plans(name, plans, [i[1:] for i in idx_l],
                                      block)
