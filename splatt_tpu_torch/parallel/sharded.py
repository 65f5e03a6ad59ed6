"""The FINE distributed CPD (≙ splatt_tpu/parallel/sharded.py).

The reference's distributed ALS (mpi_cpd_als_iterate,
src/mpi/mpi_cpd.c:627-804) does, per mode per iteration: fetch the factor
rows the local nonzeros need, local MTTKRP, reduce the rows each rank owns,
solve for the owned rows, normalize (λ allreduce), Gram allreduce.  Here the
nonzeros are split over the ranks of a :class:`~splatt_tpu_torch.parallel.
mesh.Mesh` (equal chunks, or a user partition) and every factor is
row-sharded over the same ranks, as in the JAX package.  A sweep is a host
loop over the modes that runs each rank's work on its own device; nothing
in it synchronizes the host but the fit read at the end of an iteration.

The two row exchanges follow ``Options.comm_pattern``:

- ``all2all``: every rank gathers each whole factor and reduces a whole
  (dim_pad, R) partial, scattered to the owners;
- ``ring`` (POINT2POINT): the sync ring of ``parallel/ring.py``;
- ``async_ring``: the ring kernels of ``parallel/ring_kernels.py``, one
  launch per card per ring phase;
- ``local_stub``: a timing-only variant for :func:`measure_ring_overlap`,
  the same compute with no traffic; its math is wrong by design.

The per-rank MTTKRP follows `local_engine`: ``blocked`` (the default
under ``all2all``, as in the JAX package) runs the single-card engine
chain over each rank's own sorted layouts (:func:`shard_blocked_layouts`),
so on a card ``fused_mttkrp_t`` serves each sorted mode; ``stream`` (the
ring patterns' only engine) forms the ``(nnz_l, R)`` product per rank.

On a CPU mesh the ``ASYNC_RING`` chain is the JAX ladder ``async_ring ->
ring -> all2all``: a failing strategy is probed, demoted under its
``:comm`` shape key and degraded (``comm_fallback`` events).  On a CUDA
mesh it is ``async_ring`` alone, and its failure raises.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatt_tpu_torch.config import (CommPattern, Options, Verbosity,
                                     acc_dtype, default_opts,
                                     resolve_comm_pattern, resolve_dtype)
from splatt_tpu_torch import trace
from splatt_tpu_torch.kruskal import KruskalTensor
from splatt_tpu_torch.parallel.common import (STREAM_CHUNK, RankLayouts,
                                              _subdir, allreduce,
                                              alloc_build_modes,
                                              bucket_engine, bucket_scatter,
                                              build_bucket_layout, ceil_to,
                                              comm_volume_report,
                                              dist_phase_report,
                                              engine_fallback, fit_tail,
                                              imbalance_report, is_memmapped,
                                              mode_update_tail, no_phase,
                                              rank_layouts_by_mode,
                                              run_distributed_als,
                                              streamed_bucket_scatter,
                                              upload, wrap_profiled_step)
from splatt_tpu_torch.parallel.mesh import make_mesh, single_axis_of


def shard_nnz_host(tt, ndev: int, val_dtype=np.float64,
                   partition: Optional[np.ndarray] = None,
                   streamed: Optional[bool] = None,
                   out_dir: Optional[str] = None,
                   chunk: int = STREAM_CHUNK
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The padded (nmodes, nnz_pad) int32 indices and (nnz_pad,) values
    of :func:`shard_nnz`, on the host: equal contiguous chunks, or
    nonzero n in bucket ``partition[n]`` with the buckets padded to the
    largest.  Pads point at row 0 with value 0.

    `streamed` (None: when the tensor's indices are memmapped) buckets in
    chunked passes (:func:`streamed_bucket_scatter`), so the host holds
    O(chunk); the partition may itself be a memmap.  With `out_dir` the
    outputs are memmaps under it: a tensor larger than the host's memory
    shards end to end (≙ src/mpi/mpi_io.c:587-648)."""
    from splatt_tpu_torch.blocked import check_int32_dims

    check_int32_dims(tt.dims)
    if streamed is None:
        streamed = is_memmapped(tt.inds)
    if streamed:
        if partition is None:
            csize = max(ndev, ceil_to(tt.nnz, ndev)) // ndev

            def owner_fn(ic, s):
                return np.minimum(
                    (s + np.arange(ic.shape[1], dtype=np.int64)) // csize,
                    ndev - 1)
        else:
            def owner_fn(ic, s):
                return np.asarray(partition[s:s + ic.shape[1]],
                                  dtype=np.int64)

        binds, bvals, _, _ = streamed_bucket_scatter(
            tt.inds, tt.vals, owner_fn, ndev, val_dtype, chunk=chunk,
            out_dir=out_dir)
        return binds.reshape(tt.nmodes, -1), bvals.reshape(-1)
    if partition is None:
        nnz_pad = max(ndev, ceil_to(tt.nnz, ndev))
        inds = np.zeros((tt.nmodes, nnz_pad), dtype=np.int32)
        inds[:, :tt.nnz] = tt.inds
        vals = np.zeros(nnz_pad, dtype=val_dtype)
        vals[:tt.nnz] = tt.vals
        return inds, vals
    binds, bvals, _, _ = bucket_scatter(tt.inds, tt.vals,
                                        np.asarray(partition), ndev,
                                        val_dtype)
    return binds.reshape(tt.nmodes, -1), bvals.reshape(-1)


def shard_nnz(tt, mesh, dtype=torch.float32,
              partition: Optional[np.ndarray] = None,
              out_dir: Optional[str] = None
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each rank's (nmodes, nnz_l) int32 indices and (nnz_l,) values in
    `dtype`, on its device (≙ mpi_simple_distribute, or p_rearrange_fine
    with a user partition, src/mpi/mpi_io.c).  A memmapped tensor shards
    in chunked passes, its shards memmapped under `out_dir` when given
    (:func:`shard_nnz_host`), and goes to the ranks in chunks."""
    inds, vals = shard_nnz_host(tt, mesh.ndev, val_dtype=tt.vals.dtype,
                                partition=partition, out_dir=out_dir)
    per = inds.shape[1] // mesh.ndev
    out_i, out_v = [], []
    for d, dev in enumerate(mesh.devices):
        lo, hi = d * per, (d + 1) * per
        out_i.append(upload(inds[:, lo:hi], dev))
        out_v.append(upload(vals[lo:hi], dev, dtype))
    return out_i, out_v


def shard_blocked_layouts(tt, mesh, opts: Options, dims_pad: Tuple[int, ...],
                          dtype=torch.float32,
                          partition: Optional[np.ndarray] = None,
                          out_dir: Optional[str] = None,
                          chunk: int = STREAM_CHUNK) -> List[RankLayouts]:
    """Per-rank sorted and blocked layouts, so each rank runs the
    single-card blocked MTTKRP engine over its own nonzeros (≙ each MPI
    rank building CSF over its local nonzeros, mpi_cpd.c:714), built
    once per run, each rank's arrays on its device.  The nonzeros are
    bucketed as :func:`shard_nnz` places them (equal contiguous chunks, or
    a `partition`).  The mode-m row space stays global (the owners'
    reduce splits it), so a layout's sentinel is ``dims_pad[sort_mode]``.

    ``opts.block_alloc`` sets the layouts built, as on one card
    (:func:`alloc_build_modes`); a mode without its own shares the first
    by reference on the ``scatter`` path.  A memmapped tensor builds in
    chunked passes (the bucket scatter and the counting sort), with the
    buckets under ``out_dir/shards`` and mode m's layouts under
    ``out_dir/blocked_m<m>`` when `out_dir` is given.  Returns one
    :class:`RankLayouts` per mode."""
    ndev = mesh.ndev
    fence = max(ndev, ceil_to(tt.nnz, ndev)) // ndev
    if is_memmapped(tt.inds):
        if partition is None:
            def owner_fn(ic, s):
                return np.arange(s, s + ic.shape[1], dtype=np.int64) // fence
        else:
            def owner_fn(ic, s):
                return np.asarray(partition[s:s + ic.shape[1]],
                                  dtype=np.int64)

        binds, bvals, _, counts = streamed_bucket_scatter(
            tt.inds, tt.vals, owner_fn, ndev, tt.vals.dtype, chunk=chunk,
            out_dir=_subdir(out_dir, "shards"))
    else:
        owner = (np.arange(tt.nnz, dtype=np.int64) // fence
                 if partition is None
                 else np.asarray(partition, dtype=np.int64))
        binds, bvals, _, counts = bucket_scatter(tt.inds, tt.vals, owner,
                                                 ndev, tt.vals.dtype)
    built = {}
    for m in alloc_build_modes(dims_pad, opts):
        host = build_bucket_layout(binds, bvals, counts, m, dims_pad[m],
                                   opts.nnz_block, chunk=chunk,
                                   out_dir=_subdir(out_dir, f"blocked_m{m}"))
        built[m] = RankLayouts.place(host, counts,
                                     bucket_engine(host[4], opts), m,
                                     dims_pad[m], mesh, dtype)
        del host
    return rank_layouts_by_mode(built, tt.nmodes)


def shard_factors(factors: Sequence, dims: Tuple[int, ...], mesh,
                  dtype=torch.float32,
                  relabels: Optional[List[Optional[np.ndarray]]] = None,
                  dims_pad: Optional[Sequence[int]] = None
                  ) -> List[List[torch.Tensor]]:
    """Row-shard factors (numpy arrays or tensors in the original row
    space), zero-padding the rows to the rank count (or to `dims_pad`).
    Zero pad rows keep the Grams, norms and solves exact.  `relabels[m]`,
    when given, places row `old` at label ``relabels[m][old]``."""
    ndev = mesh.ndev
    out = []
    for m, (U, d) in enumerate(zip(factors, dims)):
        U = torch.as_tensor(np.asarray(U) if not torch.is_tensor(U) else U)
        U = U.detach().cpu()
        d_pad = ceil_to(d, ndev) if dims_pad is None else int(dims_pad[m])
        U_pad = torch.zeros((d_pad, U.shape[1]), dtype=U.dtype)
        rl = relabels[m] if relabels is not None else None
        if rl is None:
            U_pad[:d] = U[:d]
        else:
            U_pad[torch.from_numpy(np.asarray(rl))] = U[:d]
        block = d_pad // ndev
        out.append([U_pad[r * block:(r + 1) * block].to(dev, dtype)
                    for r, dev in enumerate(mesh.devices)])
    return out


def _exchanges(mesh, dims_pad, variant: str, plans=None):
    """(gather_rows, reduce_rows) of a comm variant: ``gather_rows(U_l,
    idx, k)`` gives each rank's rows of mode k's row-sharded factor at its
    ids; ``reduce_rows(prod, idx, m)`` each rank's reduced (block, R) rows
    of mode m's MTTKRP, in the accumulator dtype.  `plans[k]`, when given,
    are the ring kernels' plans of mode k's ids
    (``ring_kernels.build_ring_plans``), built once per run: mode k's
    gather and mode k's reduce read the same ids, and so one plan."""
    ndev = mesh.ndev

    def plans_of(k):
        return None if plans is None else plans[k]

    if variant == "ring":
        from splatt_tpu_torch.parallel.ring import (blockwise_reduce_rows,
                                                    ring_gather_rows)

        def gather_rows(U_l, idx, k):
            return ring_gather_rows(U_l, idx, mesh)

        def reduce_rows(prod, idx, m):
            return blockwise_reduce_rows(prod, idx, mesh,
                                         dims_pad[m] // ndev)
    elif variant == "async_ring":
        from splatt_tpu_torch.parallel.ring_kernels import (
            async_blockwise_reduce_rows, async_ring_gather_rows)

        def gather_rows(U_l, idx, k):
            return async_ring_gather_rows(U_l, idx, mesh, plans_of(k))

        def reduce_rows(prod, idx, m):
            return async_blockwise_reduce_rows(prod, idx, mesh,
                                               dims_pad[m] // ndev,
                                               plans_of(m))
    elif variant == "local_stub" and mesh.is_cuda:
        # the kernels with the exchange off: each step's compute, no hop
        from splatt_tpu_torch.parallel.ring_kernels import (ring_gather,
                                                            ring_reduce)

        def gather_rows(U_l, idx, k):
            return ring_gather(U_l, idx, mesh, exchange=False,
                               plans=plans_of(k))

        def reduce_rows(prod, idx, m):
            return ring_reduce(prod, idx, mesh, dims_pad[m] // ndev,
                               exchange=False, plans=plans_of(m))
    elif variant == "local_stub":
        from splatt_tpu_torch.parallel.ring import local_block_sum

        def gather_rows(U_l, idx, k):
            block = int(U_l[0].shape[0])
            out = []
            for d, (U, ids) in enumerate(zip(U_l, idx)):
                ids = ids.long()
                rows = torch.zeros((int(ids.shape[0]), int(U.shape[1])),
                                   dtype=U.dtype, device=U.device)
                for step in range(ndev):
                    mask = torch.div(ids, block, rounding_mode="floor") \
                        == (d - step) % ndev
                    local = torch.where(mask, ids % block,
                                        torch.zeros_like(ids))
                    rows = torch.where(mask[:, None],
                                       U.index_select(0, local), rows)
                out.append(rows)
            return out

        def reduce_rows(prod, idx, m):
            block = dims_pad[m] // ndev
            out = []
            for d, (p, ids) in enumerate(zip(prod, idx)):
                for jb in range(ndev):
                    part = local_block_sum(p, ids, jb, block)
                    if jb == d:
                        keep = part
                out.append(keep)
            return out
    elif variant == "all2all":
        def gather_rows(U_l, idx, k):
            full = gather_full(U_l, mesh)
            return [full[mesh.devices[d]].index_select(0, idx[d])
                    for d in range(ndev)]

        def reduce_rows(prod, idx, m):
            # local partials over the global row space, then the owners'
            # sums
            dim = dims_pad[m]
            parts = []
            for p, ids in zip(prod, idx):
                acc = acc_dtype(p.dtype)
                parts.append(torch.zeros((dim, int(p.shape[1])), dtype=acc,
                                         device=p.device)
                             .index_add_(0, ids, p.to(acc)))
            return owner_sums(parts, mesh, dim // ndev)
    else:
        raise ValueError(f"unknown comm variant {variant!r}")
    return gather_rows, reduce_rows


def gather_full(U_l: Sequence[torch.Tensor], mesh) -> dict:
    """≙ mpi_update_rows under all2all: a row-sharded factor's shards
    concatenated on every card of the mesh, keyed by card."""
    return {dev: torch.cat([u.to(dev) for u in U_l]) for dev in mesh.cards}


def owner_sums(parts: Sequence[torch.Tensor], mesh, block: int
               ) -> List[torch.Tensor]:
    """≙ mpi_reduce_rows under all2all: the ranks' partials over the whole
    row space summed in rank order, each rank keeping its `block` of
    rows, on its device."""
    out = []
    for d, dev in enumerate(mesh.devices):
        tot = parts[0][d * block:(d + 1) * block].to(dev)
        for e in range(1, len(parts)):
            tot = tot + parts[e][d * block:(d + 1) * block].to(dev)
        out.append(tot)
    return out


def sharded_mttkrp(inds: Sequence[torch.Tensor],
                   vals: Sequence[torch.Tensor], factors, mode: int,
                   mesh, variant: str = "all2all") -> List[torch.Tensor]:
    """Distributed MTTKRP of mode `mode`: each rank's (block, R) rows, in
    the accumulator dtype.  `factors[k]` holds rank k's shards; `inds`
    and `vals` each rank's nonzeros (:func:`shard_nnz`)."""
    dims_pad = tuple(sum(int(s.shape[0]) for s in f) for f in factors)
    gather_rows, reduce_rows = _exchanges(mesh, dims_pad, variant)
    dtype = factors[0][0].dtype
    prod = [v[:, None].to(dtype) for v in vals]
    for k in range(len(factors)):
        if k != mode:
            rows = gather_rows(factors[k], [i[k] for i in inds], k)
            prod = [p * r for p, r in zip(prod, rows)]
    return reduce_rows(prod, [i[mode] for i in inds], mode)


def make_sharded_sweep(mesh, nmodes: int, reg: float,
                       dims_pad: Tuple[int, ...], variant: str = "all2all",
                       plans=None, cells: Optional[List[RankLayouts]] = None,
                       fallback: Optional[bool] = None, phase=no_phase):
    """One ALS iteration over the mesh, as ``sweep(inds, vals, factors,
    grams, first) -> (factors, grams, λ, ⟨Z,Z⟩, ⟨X,Z⟩)``: per-rank
    lists in, new per-rank lists out (the inputs are not modified, so a
    probe's result can be thrown away).  `first` selects the 2-norm
    (iteration 0) over the max-norm (≙ src/cpd.c:343-347).  `plans`: the
    ring plans of each mode's ids (:func:`_exchanges`).

    `cells` (:func:`shard_blocked_layouts`; ``all2all`` only): per mode,
    every rank gathers the other factors whole, runs the blocked engine
    over its layout into a ``(dims_pad[m], R)`` partial (`fallback`
    passed to the engine chain), and the owners' sums reduce the
    partials; `inds` and `vals` are not read.  `phase(name)` brackets
    each phase of the sweep (:func:`make_sharded_profiled_sweep`)."""
    if cells is not None and variant != "all2all":
        raise ValueError("the blocked local engine requires the all2all "
                         "variant (the ring reduce is blockwise)")
    gather_rows, reduce_rows = _exchanges(mesh, dims_pad, variant, plans)
    ndev = mesh.ndev
    carriers = {}

    def blocked_parts(full, factors, m):
        # the output mode's table only carries its row count: one zero
        # (dims_pad[m], R) tensor per card, kept for the run
        U = factors[m][0]
        key = (m, U.dtype, int(U.shape[1]))
        if key not in carriers:
            carriers[key] = {dev: torch.zeros((dims_pad[m], int(U.shape[1])),
                                              dtype=U.dtype, device=dev)
                             for dev in mesh.cards}
        parts = []
        for d, dev in enumerate(mesh.devices):
            facs = [carriers[key][dev] if k == m else full[k][dev]
                    for k in range(nmodes)]
            parts.append(cells[m].mttkrp(d, facs, m, fallback))
        return parts

    def sweep(inds, vals, factors, grams, first: bool):
        factors = [list(f) for f in factors]
        grams = [list(g) for g in grams]
        dtype = factors[0][0].dtype
        lam = M = None
        if cells is not None:
            # factor 0 is regathered after its update, before it is read
            with phase("dist_gather"):
                full = [None] + [gather_full(f, mesh) for f in factors[1:]]
        for m in range(nmodes):
            if cells is not None:
                with phase("dist_mttkrp"):
                    parts = blocked_parts(full, factors, m)
                with phase("dist_comm"):
                    M = owner_sums(parts, mesh, dims_pad[m] // ndev)
                del parts
            else:
                prod = [v[:, None].to(dtype) for v in vals]
                for k in range(nmodes):
                    if k != m:
                        with phase("dist_gather"):
                            rows = gather_rows(factors[k],
                                               [i[k] for i in inds], k)
                        with phase("dist_mttkrp"):
                            prod = [p * r for p, r in zip(prod, rows)]
                        del rows
                # the stream reduce sums each rank's rows and exchanges
                # the sums in one step: both land in dist_comm
                with phase("dist_comm"):
                    M = reduce_rows(prod, [i[m] for i in inds], m)
                del prod
            with phase("dist_update"):
                U, g, lam = mode_update_tail(M, grams, m, reg, first, mesh,
                                             store_dtype=dtype)
            factors[m] = U
            grams[m] = g
            if cells is not None and m < nmodes - 1:
                with phase("dist_gather"):
                    full[m] = gather_full(U, mesh)
        with phase("dist_fit"):
            znormsq, inner = fit_tail(lam, grams, M, factors[nmodes - 1],
                                      mesh)
        return factors, grams, lam, znormsq, inner

    return sweep


def make_sharded_profiled_sweep(mesh, nmodes: int, reg: float,
                                dims_pad: Tuple[int, ...],
                                cells: Optional[List[RankLayouts]] = None,
                                fallback: Optional[bool] = None):
    """The all2all sweep with each phase (gather, local MTTKRP, reduce,
    update, fit) in its ``dist_*`` timer bracket, closed after every card
    has finished it (≙ splatt_tpu/parallel/sharded.py:435-567, the
    measured attribution of mpi_time_stats).  The fences cost the overlap
    of the plain sweep: ``Verbosity.HIGH`` only."""
    from splatt_tpu_torch.parallel.common import profiled_phase

    return make_sharded_sweep(mesh, nmodes, reg, dims_pad,
                              variant="all2all", cells=cells,
                              fallback=fallback,
                              phase=lambda name: profiled_phase(name, mesh))


#: ordered comm-strategy chains (≙ splatt_tpu/parallel/sharded.py:562-566):
#: a failing strategy degrades to the next entry, all2all last
_COMM_CHAINS = {
    CommPattern.ALL2ALL: ("all2all",),
    CommPattern.POINT2POINT: ("ring", "all2all"),
    CommPattern.ASYNC_RING: ("async_ring", "ring", "all2all"),
}


def comm_chain(comm: CommPattern, mesh=None) -> tuple:
    """The ordered comm-strategy chain of a pattern.  On a CUDA mesh the
    ``ASYNC_RING`` chain is the kernel alone: no plain-torch exchange
    stands in for the ring kernels on the card."""
    if comm is CommPattern.ASYNC_RING and mesh is not None and mesh.is_cuda:
        return ("async_ring",)
    return _COMM_CHAINS[comm]


def _comm_shape_key(dims_pad, ndev: int, rank: int, dtype) -> str:
    """Demotion scope of a comm-strategy failure: its own ``:comm``
    suffix keeps ring demotions apart from the MTTKRP engine keys."""
    dims = "x".join(str(int(d)) for d in dims_pad)
    name = str(dtype).replace("torch.", "")
    return f"d{dims}:w{ndev}:r{int(rank)}:{name}:comm"


def sync_mesh(mesh) -> None:
    """Wait for every card of the mesh, and raise a ring kernel's error
    (no-op on a CPU mesh)."""
    if mesh.is_cuda:
        from splatt_tpu_torch.parallel.ring_kernels import check_errors

        for card in mesh.cards:
            torch.cuda.synchronize(card)
        check_errors()


def _select_comm_sweep(chain, mesh, nmodes, reg, dims_pad, inds, vals,
                       factors, grams, dtype, opts, plans=None, cells=None):
    """The sweep on the best live comm strategy: each strategy but the
    last is probed with one discarded step; a probe failure demotes
    ``comm.<variant>`` under the comm shape key (per shape for RESOURCE
    and TIMEOUT failures, process-wide otherwise) and falls to the next
    strategy with a ``comm_fallback`` event.  With fallback off the first
    strategy is taken unprobed, and its failure raises.  Returns
    (variant, step)."""
    from splatt_tpu_torch import resilience

    rank = int(factors[0][0].shape[1])
    ckey = _comm_shape_key(dims_pad, mesh.ndev, rank, dtype)
    fallback = engine_fallback(opts)
    live = [v for v in chain
            if v == chain[-1]
            or not resilience.is_demoted(f"comm.{v}", ckey)]
    for i, variant in enumerate(live):
        sweep = make_sharded_sweep(mesh, nmodes, reg, dims_pad,
                                   variant=variant, plans=plans, cells=cells,
                                   fallback=fallback)

        def step(f, g, first, sweep=sweep):
            return sweep(inds, vals, f, g, first)

        if i == len(live) - 1 or not fallback:
            return variant, step
        try:
            step(factors, grams, True)
            sync_mesh(mesh)
            return variant, step
        except Exception as e:
            cls = resilience.classify_failure(e)
            resilience.demote_engine(f"comm.{variant}", e, shape_key=ckey)
            resilience.run_report().add(
                "comm_fallback", strategy=variant, fallback_to=live[i + 1],
                failure_class=cls.value,
                error=resilience.failure_message(e)[:200])
            if opts.verbosity >= Verbosity.LOW:
                print(f"  comm engine {variant} failed ({cls.value}); "
                      f"falling back to {live[i + 1]}")
    raise AssertionError("unreachable: the last comm strategy returns")


def _make_exchange_only(mesh, nmodes, dims_pad, rank, dtype, hops: int):
    """A function that moves exactly one sweep's ring traffic (every
    gather leg's hops and the reduce leg's) with no MTTKRP compute: the
    fully exposed exchange time, the denominator of the overlap metric.
    Each hop is a copy onto the next rank's device (a copy within the
    card between virtual ranks)."""
    ndev = mesh.ndev
    acc = acc_dtype(dtype)

    def hop(blocks):
        return [blocks[(d - 1) % ndev].to(mesh.devices[d], copy=True)
                for d in range(ndev)]

    def exchange(factors):
        out = []
        for m in range(nmodes):
            for k in range(nmodes):
                if k != m:
                    cur = factors[k]
                    for _ in range(hops):
                        cur = hop(cur)
                    out.append(cur[0])
            cur = [torch.zeros((dims_pad[m] // ndev, rank), dtype=acc,
                               device=dev) for dev in mesh.devices]
            for _ in range(hops):
                cur = hop(cur)
            out.append(cur[0])
        return out

    return exchange


def measure_ring_overlap(mesh, nmodes, reg, dims_pad, axis, variant,
                         inds, vals, factors, grams, dtype,
                         reps: int = 3, step_fn=None, plans=None) -> dict:
    """The achieved comm/compute overlap of a ring sweep (docs/ring.md):

        exchange_s  the sweep's ring traffic alone, fully exposed
        compute_s   a ``local_stub`` step: the same compute, no traffic
                    (on a CUDA mesh the ring kernels with the exchange
                    off)
        step_s      the real step

        exposed = max(0, step_s - compute_s)
        hidden  = max(0, exchange_s - exposed)
        overlap_frac = hidden / exchange_s

    Each is the median of `reps` warm runs ending in a sync of every
    card.  The exchange makes ndev-1 hops per leg, as both of the port's
    rings do.  The JAX package's fields, with the wire model's bytes
    beside; ``engine`` names the exchange that ran."""
    from splatt_tpu_torch.parallel.common import comm_volume_model

    ndev = mesh.ndev
    rank = int(factors[0][0].shape[1])
    if step_fn is None:
        sweep = make_sharded_sweep(mesh, nmodes, reg, dims_pad,
                                   variant=variant, plans=plans)

        def step_fn(f, g, first):
            return sweep(inds, vals, f, g, first)
    stub = make_sharded_sweep(mesh, nmodes, reg, dims_pad,
                              variant="local_stub", plans=plans)
    exchange = _make_exchange_only(mesh, nmodes, dims_pad, rank, dtype,
                                   hops=max(ndev - 1, 0))

    def timed(fn) -> float:
        fn()
        sync_mesh(mesh)
        ts = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            fn()
            sync_mesh(mesh)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2]

    t_comm = timed(lambda: exchange(factors))
    t_comp = timed(lambda: stub(inds, vals, factors, grams, False))
    t_step = timed(lambda: step_fn(factors, grams, False))
    exposed = max(0.0, t_step - t_comp)
    hidden = max(0.0, t_comm - exposed)
    overlap = hidden / t_comm if t_comm > 0 else 0.0
    itemsize = torch.empty(0, dtype=dtype).element_size()
    model = comm_volume_model(
        dims_pad, rank, itemsize, ndev=ndev, variant=variant,
        acc_itemsize=torch.empty(0, dtype=acc_dtype(dtype)).element_size())
    kernels = variant == "async_ring" and mesh.is_cuda
    return dict(variant=variant,
                backend=mesh.devices[0].type,
                engine="cuda_ring" if kernels else "sync_ring",
                step_s=round(t_step, 6), compute_s=round(t_comp, 6),
                exchange_s=round(t_comm, 6),
                exposed_comm_s=round(exposed, 6),
                hidden_comm_s=round(hidden, 6),
                overlap_frac=round(overlap, 4),
                model_mb_per_device=round(
                    model["gather_mb"] + model["reduce_mb"]
                    + model["allreduce_mb"], 4),
                per_hop_mb=model["per_hop_mb"],
                overlap_eligible_frac=model["overlap_eligible_frac"])


def sharded_cpd_als(tt, rank: int, mesh=None,
                    opts: Optional[Options] = None, init=None,
                    axis: str = "nnz",
                    partition: Optional[np.ndarray] = None,
                    row_distribute: Optional[str] = None,
                    local_engine: Optional[str] = None,
                    out_dir: Optional[str] = None,
                    measure_overlap: Optional[bool] = None,
                    device=None, checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 10,
                    resume: bool = True) -> KruskalTensor:
    """Distributed CPD-ALS over a mesh (≙ the mpirun cpd path,
    src/cmds/mpi_cmd_cpd.c:175-338), FINE decomposition.

    `mesh` defaults to :func:`make_mesh` on `device` (every card, or with
    ``device="cpu"`` virtual CPU ranks).  `init` is a list of numpy arrays
    (or tensors) in the original row space; without it the factors come
    from a generator seeded by ``opts.random_seed``.  Either way they are
    drawn before sharding, so the result does not depend on the rank
    count.  ``opts.comm_pattern`` (else SPLATT_COMM, else ALL2ALL) picks
    the row exchange.  `measure_overlap` (None = at HIGH verbosity)
    reports a ring sweep's achieved overlap as a ``ring_overlap`` event.

    `row_distribute`: "greedy" relabels each mode's rows so a shard's
    touched rows fall in its own fence (≙ p_greedy_mat_distribution);
    "balanced" spreads hot rows over the fences by nnz.  `partition`
    places nonzero n on rank ``partition[n]``.  `local_engine`: "blocked"
    (the default under ALL2ALL, :func:`auto_local_engine`) runs the
    single-card engine chain over each rank's sorted layouts
    (:func:`shard_blocked_layouts`, built once per run; the stream arrays
    are then never copied to the ranks); "stream" (the ring patterns'
    default and only engine) the gather product per rank.  A memmapped
    tensor keeps the blocked engine when `out_dir` is given: the shards
    and the per-rank sorts build in chunked passes, memmapped under
    `out_dir`, so the host's memory stays bounded at any scale; without
    it the stream engine runs (its shards streamed in memory).

    At ``Verbosity.HIGH`` outside the ring patterns the profiled sweep
    (:func:`make_sharded_profiled_sweep`) runs and the phase table is
    printed.  `checkpoint_path`, `checkpoint_every` and `resume` are
    :func:`run_distributed_als`'s.  The result's factors and λ lie on
    the CPU.
    """
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.parallel.common import (auto_local_engine,
                                                  record_local_engine,
                                                  record_shard_imbalance,
                                                  relabel_tensor)

    opts = (opts or default_opts()).validate()
    mesh, axis = single_axis_of(mesh, axis)
    mesh = mesh or make_mesh(axis=axis, device=device)
    ndev = mesh.ndev
    nmodes = tt.nmodes
    dims_pad = tuple(ceil_to(d, ndev) for d in tt.dims)
    xnormsq = tt.normsq()
    dtype = resolve_dtype(opts)

    orig_dims = tt.dims
    relabels = None
    if row_distribute == "greedy":
        from splatt_tpu_torch.parallel.distribute import (
            comm_minimizing_relabels)

        shard_of = (np.asarray(partition, dtype=np.int64)
                    if partition is not None else None)
        relabels, dstats = comm_minimizing_relabels(
            np.asarray(tt.inds), orig_dims, ndev, shard_of=shard_of)
        if opts.verbosity >= Verbosity.HIGH:
            for st in dstats:
                print(f"  rowdist mode {st['mode']}: local touches "
                      f"{st['local_before']:.1%} -> {st['local_after']:.1%}")
        tt = relabel_tensor(tt, relabels, dims_pad)
    elif row_distribute == "balanced":
        from splatt_tpu_torch.parallel.common import balanced_relabel

        relabels = [balanced_relabel(tt.mode_histogram(m), ndev,
                                     dims_pad[m] // ndev)
                    if ndev > 1 else None
                    for m in range(nmodes)]
        tt = relabel_tensor(tt, relabels, dims_pad)
    elif row_distribute is not None:
        raise ValueError(f"unknown row_distribute {row_distribute!r}")

    comm = resolve_comm_pattern(opts)
    chain = comm_chain(comm, mesh)
    ring_family = chain[0] != "all2all"
    if local_engine is None:
        local_engine = ("stream" if ring_family
                        else auto_local_engine(tt, out_dir))
    elif local_engine == "blocked" and ring_family:
        raise ValueError(f"local_engine='blocked' is not supported with "
                         f"the {comm.value} (ring) comm pattern; use "
                         f"ALL2ALL or local_engine='stream'")
    if local_engine not in ("blocked", "stream"):
        raise ValueError(f"unknown local_engine {local_engine!r}")
    record_local_engine(local_engine, tt, out_dir)
    if "async_ring" in chain and mesh.is_cuda:
        from splatt_tpu_torch.parallel.ring_kernels import prepare

        prepare(mesh, dtype)
    cells = None
    if local_engine == "blocked":
        # the blocked sweep never reads the stream arrays: no O(nnz)
        # copy of them goes to the ranks
        cells = shard_blocked_layouts(tt, mesh, opts, dims_pad, dtype=dtype,
                                      partition=partition, out_dir=out_dir)
        inds = vals = None
    else:
        inds, vals = shard_nnz(tt, mesh, dtype=dtype, partition=partition,
                               out_dir=out_dir)
    plans = None
    if "async_ring" in chain:
        # the ring kernels' id-sorted buckets of each mode's ids, shared
        # by the mode's gathers and its reduce: once per run
        from splatt_tpu_torch.parallel.ring_kernels import build_ring_plans

        plans = [build_ring_plans([i[k] for i in inds], mesh,
                                  dims_pad[k] // ndev)
                 for k in range(nmodes)]
    if init is None:
        from splatt_tpu_torch.cpd import init_factors

        gen = torch.Generator().manual_seed(opts.seed())
        init = init_factors(orig_dims, rank, gen, dtype=dtype)
    factors = shard_factors(init, orig_dims, mesh, dtype=dtype,
                            relabels=relabels)
    from splatt_tpu_torch.ops.linalg import gram

    grams = [allreduce([gram(u) for u in f], mesh) for f in factors]

    # ≙ mpi_rank_stats: measured occupancy, always recorded (the
    # layout_imbalance event rides `cpd --json`), printed at HIGH
    if partition is not None:
        counts = np.bincount(np.asarray(partition), minlength=ndev)
    else:
        chunk = max(ndev, ceil_to(tt.nnz, ndev)) // ndev
        counts = np.clip(tt.nnz - chunk * np.arange(ndev), 0, chunk)
    fence_mm = None
    if row_distribute is not None or opts.verbosity >= Verbosity.HIGH:
        from splatt_tpu_torch.utils.env import max_mean_ratio

        fence_mm = {}
        for m in range(nmodes):
            fences = np.add.reduceat(
                np.bincount(np.asarray(tt.inds[m]), minlength=dims_pad[m]),
                np.arange(0, dims_pad[m], dims_pad[m] // ndev))
            fence_mm[str(m)] = max_mean_ratio(fences)
            if opts.verbosity >= Verbosity.HIGH:
                print(imbalance_report(fences, f"mode{m} row-fence"))
    record_shard_imbalance(
        "shard", counts,
        policy=row_distribute or ("partition" if partition is not None
                                  else "equal"),
        **({"row_fence_max_mean": fence_mm} if fence_mm is not None
           else {}))
    if opts.verbosity >= Verbosity.HIGH:
        print(imbalance_report(counts, "shard"))

    profiled = opts.verbosity >= Verbosity.HIGH and not ring_family
    if profiled:
        # phase barriers mean nothing under a ring's overlap: the ring
        # patterns report the achieved-overlap metric instead
        variant = "all2all"
        sweep = make_sharded_profiled_sweep(mesh, nmodes,
                                            opts.regularization, dims_pad,
                                            cells=cells,
                                            fallback=engine_fallback(opts))

        def step(f, g, first):
            return sweep(inds, vals, f, g, first)

        step = wrap_profiled_step(step)
    else:
        with trace.enabling(opts.trace):
            with trace.span("dist.comm_select") as sp:
                variant, step = _select_comm_sweep(
                    chain, mesh, nmodes, opts.regularization, dims_pad,
                    inds, vals, factors, grams, dtype, opts, plans, cells)
                sp.set(variant=variant)
    if opts.verbosity >= Verbosity.HIGH:
        for line in comm_volume_report(
                dims_pad, rank, torch.empty(0, dtype=dtype).element_size(),
                ndev=ndev, variant=variant):
            print(line)
    if variant in ("ring", "async_ring") and measure_overlap is not False \
            and (measure_overlap or opts.verbosity >= Verbosity.HIGH):
        # best effort: a failed measurement never takes down the run
        try:
            with trace.enabling(opts.trace):
                with trace.span("dist.measure_overlap", variant=variant):
                    ov = measure_ring_overlap(
                        mesh, nmodes, opts.regularization, dims_pad, axis,
                        variant, inds, vals, factors, grams, dtype,
                        step_fn=step, plans=plans)
            resilience.run_report().add("ring_overlap", **ov)
            if opts.verbosity >= Verbosity.LOW:
                print(f"  ring overlap [{ov['engine']}]: "
                      f"exchange {ov['exchange_s']:.4f}s, "
                      f"{100 * ov['overlap_frac']:.0f}% hidden "
                      f"(exposed {ov['exposed_comm_s']:.4f}s of "
                      f"step {ov['step_s']:.4f}s)")
        except Exception as e:
            cls = resilience.classify_failure(e)
            if opts.verbosity >= Verbosity.LOW:
                print(f"  ring overlap measurement skipped "
                      f"({cls.value}: {resilience.failure_message(e)[:120]})")

    after_fit = None
    if mesh.is_cuda:
        from splatt_tpu_torch.parallel.ring_kernels import check_errors

        after_fit = check_errors
    def place(U, m):
        return shard_factors([U], (orig_dims[m],), mesh, dtype=dtype,
                             relabels=None if relabels is None
                             else [relabels[m]],
                             dims_pad=(dims_pad[m],))[0]

    def gram_of(f, m):
        return allreduce([gram(u) for u in f], mesh)

    out = run_distributed_als(step, factors, grams, rank, opts, xnormsq,
                              orig_dims, dtype, mesh, row_select=relabels,
                              after_fit=after_fit, place=place,
                              gram_of=gram_of,
                              checkpoint_path=checkpoint_path,
                              checkpoint_every=checkpoint_every,
                              resume=resume)
    if profiled:
        for line in dist_phase_report():
            print(line)
    return out
