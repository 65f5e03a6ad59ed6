"""The coarse-grained decomposition: owner computes over per-mode copies
(≙ splatt_tpu/parallel/coarse.py, the reference's COARSE decomposition,
types_config.h:179-190, src/cmds/mpi_cmd_cpd.c:223-258).

Each rank owns a contiguous block of every mode's rows and keeps one copy
of the nonzeros per mode: mode m's copy holds every nonzero whose mode-m
row lies in the rank's fence, sorted by that row.  Updating mode m needs
no output reduction at all, at the price of nmodes copies of the nonzeros
and a gather of the other factors.  Per mode m a sweep runs:

1. every rank gathers the other factors whole (≙ mpi_update_rows);
2. its local MTTKRP over its mode-m copy into its own rows (with the
   blocked engine, ``fused_mttkrp_t`` on a card: every mode has its own
   fence-local sorted layout);
3. the local solve, and the λ and Gram allreduce over the ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from splatt_tpu_torch.config import (Options, acc_dtype, default_opts,
                                     resolve_dtype)
from splatt_tpu_torch.kruskal import KruskalTensor
from splatt_tpu_torch.parallel.common import (STREAM_CHUNK, RankLayouts,
                                              _subdir, allreduce,
                                              auto_local_engine,
                                              bucket_engine, bucket_scatter,
                                              build_bucket_layout, ceil_to,
                                              engine_fallback, fit_tail,
                                              is_memmapped, mode_update_tail,
                                              place_buckets,
                                              record_local_engine,
                                              record_shard_imbalance,
                                              run_distributed_als,
                                              streamed_bucket_scatter)
from splatt_tpu_torch.parallel.mesh import make_mesh, single_axis_of
from splatt_tpu_torch.parallel.sharded import gather_full, shard_factors


def _bucket_by_mode(tt, mode: int, ndev: int, val_dtype,
                    streamed: Optional[bool] = None,
                    out_dir: Optional[str] = None,
                    chunk: int = STREAM_CHUNK):
    """Bucket the nonzeros by the equal row fences of `mode`.

    Returns (inds (nmodes, ndev, C) int32 with the mode-`mode` indices
    local to the fence, vals (ndev, C), block_rows, counts), the JAX
    package's arrays.  `streamed` (None: when the tensor's indices are
    memmapped) buckets in chunked passes, with the buckets memmapped
    under `out_dir` when given, so a tensor larger than the host's memory
    builds its per-mode copies end to end."""
    dim_pad = ceil_to(max(tt.dims[mode], ndev), ndev)
    block = dim_pad // ndev
    if streamed is None:
        streamed = is_memmapped(tt.inds)
    if streamed:
        def postprocess(placed):
            placed[mode] %= block
            return placed

        binds, bvals, _, counts = streamed_bucket_scatter(
            tt.inds, tt.vals, lambda ic, s: ic[mode] // block, ndev,
            val_dtype, chunk=chunk, out_dir=out_dir,
            postprocess=postprocess)
        return binds, bvals, block, counts
    owner = tt.inds[mode] // block
    binds, bvals, _, counts = bucket_scatter(tt.inds, tt.vals, owner, ndev,
                                             val_dtype)
    binds[mode] %= block  # local to the fence (pad slots stay 0)
    return binds, bvals, block, counts


def coarse_rank_layouts(per_mode, opts: Options, mesh,
                        dtype=torch.float32, out_dir: Optional[str] = None):
    """Each mode's sorted, fence-local layouts of its buckets
    (:func:`_bucket_by_mode`'s tuples), one per rank on its device: every
    mode has its own, so every mode takes the sorted path.  Memmapped
    buckets sort in chunked passes, mode m's layouts memmapped under
    ``out_dir/mode<m>/blocked`` when `out_dir` is given."""
    out = []
    for m, (bi, bv, blk_rows, counts) in enumerate(per_mode):
        host = build_bucket_layout(
            bi, bv, counts, m, blk_rows, opts.nnz_block,
            out_dir=_subdir(_subdir(out_dir, f"mode{m}"), "blocked"))
        out.append(RankLayouts.place(host, counts,
                                     bucket_engine(host[4], opts), m,
                                     blk_rows, mesh, dtype))
        del host
    return out


def make_coarse_sweep(mesh, blocks, reg: float, cells=None,
                      fallback: Optional[bool] = None):
    """One ALS sweep of the coarse decomposition, as ``sweep(inds, vals,
    factors, grams, first) -> (factors, grams, λ, ⟨Z,Z⟩, ⟨X,Z⟩)`` with
    per-rank lists.  With `cells` (:func:`coarse_rank_layouts`) each rank
    runs the single-card blocked engine over its mode-m layout
    (`fallback` passed to its chain) and `inds`/`vals` are not read;
    without, the stream formulation over ``inds[m][r]``/``vals[m][r]``,
    the oracle."""
    nmodes = len(blocks)
    ndev = mesh.ndev

    def local_mttkrp(inds, vals, full, factors, m, r):
        dev = mesh.devices[r]
        # the local fence is mode m's row space (and its row count)
        facs = [factors[m][r] if k == m else full[k][dev]
                for k in range(nmodes)]
        if cells is not None:
            return cells[m].mttkrp(r, facs, m, fallback)
        ids = inds[m][r]
        prod = vals[m][r][:, None].to(facs[0].dtype)
        for k in range(nmodes):
            if k != m:
                prod = prod * facs[k].index_select(0, ids[k])
        acc = acc_dtype(prod.dtype)
        return torch.zeros((blocks[m], int(prod.shape[1])), dtype=acc,
                           device=dev).index_add_(0, ids[m], prod.to(acc))

    def sweep(inds, vals, factors, grams, first: bool):
        factors = [list(f) for f in factors]
        grams = [list(g) for g in grams]
        dtype = factors[0][0].dtype
        # factor 0 is regathered after its update, before any mode reads it
        full = [None] + [gather_full(f, mesh) for f in factors[1:]]
        lam = M = None
        for m in range(nmodes):
            # owner computes: every nonzero of a rank's rows is local, so
            # its MTTKRP block needs no reduction
            M = [local_mttkrp(inds, vals, full, factors, m, r)
                 for r in range(ndev)]
            U, g, lam = mode_update_tail(M, grams, m, reg, first, mesh,
                                         store_dtype=dtype)
            factors[m] = U
            grams[m] = g
            if m < nmodes - 1:
                full[m] = gather_full(U, mesh)
        znormsq, inner = fit_tail(lam, grams, M, factors[nmodes - 1], mesh)
        return factors, grams, lam, znormsq, inner

    return sweep


def coarse_cpd_als(tt, rank: int, mesh=None, opts: Optional[Options] = None,
                   init=None, axis: str = "d",
                   local_engine: Optional[str] = None,
                   out_dir: Optional[str] = None,
                   row_distribute: Optional[str] = None,
                   device=None, checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 10,
                   resume: bool = True) -> KruskalTensor:
    """Distributed CPD-ALS, coarse-grained owner computes.

    `mesh` defaults to :func:`make_mesh` on `device`.
    `row_distribute="balanced"` relabels each mode's rows by nnz before
    the equal fences are cut (balanced_relabel), so a hot slice no longer
    fattens one rank's bucket; the factors come back in the original row
    order.  `local_engine`: "blocked" (the default,
    :func:`auto_local_engine`) sorts each mode's buckets and runs the
    single-card blocked engine on every rank (≙ mttkrp_csf over each
    rank's per-mode tensor copy); "stream" keeps the gather product, the
    oracle.  A memmapped tensor keeps the blocked engine when `out_dir`
    is given: each mode's buckets and sorted layouts build in chunked
    passes, memmapped under ``out_dir/mode<m>`` and
    ``out_dir/mode<m>/blocked``; without it the stream engine runs.  The
    factors and λ come back on the CPU.
    `checkpoint_path`, `checkpoint_every` and `resume` are
    :func:`run_distributed_als`'s.
    """
    opts = (opts or default_opts()).validate()
    mesh, axis = single_axis_of(mesh, axis)
    mesh = mesh or make_mesh(axis=axis, device=device)
    ndev = mesh.ndev
    nmodes = tt.nmodes
    xnormsq = tt.normsq()
    dtype = resolve_dtype(opts)
    if local_engine is None:
        local_engine = auto_local_engine(tt, out_dir)
    if local_engine not in ("blocked", "stream"):
        raise ValueError(f"unknown local_engine {local_engine!r}")

    orig_dims = tt.dims
    relabels = None
    if row_distribute == "balanced":
        # every mode relabels at once: mode k's indices feed the gathered
        # factor-k lookups of every other mode's update
        from splatt_tpu_torch.parallel.common import (balanced_relabel,
                                                      relabel_tensor)

        relabels = [balanced_relabel(tt.mode_histogram(m), ndev,
                                     ceil_to(max(tt.dims[m], ndev), ndev)
                                     // ndev)
                    if ndev > 1 else None
                    for m in range(nmodes)]
        tt = relabel_tensor(tt, relabels, tuple(ceil_to(max(d, ndev), ndev)
                                                for d in tt.dims))
    elif row_distribute is not None:
        raise ValueError(f"unknown row_distribute {row_distribute!r} "
                         f"(coarse supports 'balanced')")

    record_local_engine(local_engine, tt, out_dir)
    # one bucketed copy per mode (≙ per-mode tensors + ALLMODE)
    per_mode = [_bucket_by_mode(tt, m, ndev, tt.vals.dtype,
                                out_dir=_subdir(out_dir, f"mode{m}"))
                for m in range(nmodes)]
    blocks = tuple(b for (_, _, b, _) in per_mode)
    dims_pad = tuple(b * ndev for b in blocks)
    for m, (_, _, _, counts) in enumerate(per_mode):
        record_shard_imbalance("coarse_bucket", counts,
                               policy=row_distribute or "equal", mode=m)
    cells = inds = vals = None
    if local_engine == "blocked":
        cells = coarse_rank_layouts(per_mode, opts, mesh, dtype, out_dir)
    else:
        inds, vals = zip(*(place_buckets(bi, bv, mesh, dtype)
                           for bi, bv, _, _ in per_mode))
    del per_mode

    # init in the original row space; relabels only move placement
    if init is None:
        from splatt_tpu_torch.cpd import init_factors

        gen = torch.Generator().manual_seed(opts.seed())
        init = init_factors(orig_dims, rank, gen, dtype=dtype)
    factors = shard_factors(init, orig_dims, mesh, dtype=dtype,
                            relabels=relabels, dims_pad=dims_pad)
    from splatt_tpu_torch.ops.linalg import gram

    grams = [allreduce([gram(u) for u in f], mesh) for f in factors]
    sweep = make_coarse_sweep(mesh, blocks, opts.regularization, cells=cells,
                              fallback=engine_fallback(opts))

    def step(f, g, first):
        return sweep(inds, vals, f, g, first)

    def place(U, m):
        return shard_factors([U], (orig_dims[m],), mesh, dtype=dtype,
                             relabels=None if relabels is None
                             else [relabels[m]],
                             dims_pad=(dims_pad[m],))[0]

    def gram_of(f, m):
        return allreduce([gram(u) for u in f], mesh)

    return run_distributed_als(step, factors, grams, rank, opts, xnormsq,
                               orig_dims, dtype, mesh, row_select=relabels,
                               place=place, gram_of=gram_of,
                               checkpoint_path=checkpoint_path,
                               checkpoint_every=checkpoint_every,
                               resume=resume)
