"""Shared machinery of the distributed CPD (≙ splatt_tpu/parallel/common.py,
cut to what the FINE decomposition runs).

- :func:`bucket_scatter`: place nonzero n in bucket owner[n], pad the
  buckets to the largest (≙ the rearrange-to-owners steps of
  src/mpi/mpi_io.c).
- :func:`balanced_relabel`, :func:`relabel_tensor`: row relabelings of
  ``--rowdist balanced``; :func:`record_shard_imbalance` and
  :func:`imbalance_report`: the ``layout_imbalance`` event.
- :func:`comm_volume_model` / :func:`comm_volume_report`: the per-device
  wire model of each comm strategy.
- :func:`mode_update_tail`, :func:`fit_tail`: the per-mode ALS tail and
  the fit pieces.  The JAX package's ``psum``/``pmax`` over the mesh axis
  become :func:`allreduce`: the ranks' tensors moved to rank 0's device,
  combined in rank order, and copied back to each rank's device.
- :func:`run_distributed_als`: the iterate/converge/post-process loop
  (≙ the outer loop of mpi_cpd_als_iterate + cpd_post_process), without
  the JAX package's checkpoints, guarded rollback and trace spans
  (ROADMAP.md slice 7).

Sharded state is a list with one tensor per rank, each on its rank's
device; a "replicated" value (a Gram, λ) is such a list of equal copies.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatt_tpu_torch.config import Options, Verbosity, acc_dtype
from splatt_tpu_torch.kruskal import KruskalTensor, post_process


def ceil_to(x: int, mult: int) -> int:
    """Round x up to a multiple of mult."""
    return ((x + mult - 1) // mult) * mult


def max_mean_ratio(a) -> float:
    """round(max/mean, 3) of a nonnegative weight array; 1.0 means
    balanced, or empty (≙ splatt_tpu.utils.env.max_mean_ratio)."""
    a = np.asarray(a)
    mean = float(a.mean()) if a.size else 0.0
    return round(float(a.max()) / mean, 3) if mean > 0 else 1.0


def bucket_scatter(inds: np.ndarray, vals: np.ndarray, owner: np.ndarray,
                   nbuckets: int, val_dtype
                   ) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Scatter nonzeros into equally padded buckets by owner id.

    Returns (binds (nmodes, nbuckets, C) int32, bvals (nbuckets, C), C,
    counts (nbuckets,), the true occupancy of each bucket).  Pad slots
    hold index 0 and value 0 (harmless to every kernel).
    """
    from splatt_tpu_torch.blocked import check_int32_dims

    nmodes, nnz = inds.shape
    owner = np.asarray(owner, dtype=np.int64)
    if owner.shape[0] != nnz:
        raise ValueError(
            f"partition/owner length {owner.shape[0]} != nnz {nnz}")
    if nnz == 0:
        return (np.zeros((nmodes, nbuckets, 1), dtype=np.int32),
                np.zeros((nbuckets, 1), dtype=val_dtype), 1,
                np.zeros(nbuckets, dtype=np.int64))
    if owner.min() < 0 or owner.max() >= nbuckets:
        raise ValueError(f"owner ids must lie in [0, {nbuckets})")
    if int(inds.max()) >= 2**31 - 1:
        check_int32_dims([int(inds.max()) + 1])
    counts = np.bincount(owner, minlength=nbuckets)
    C = max(int(counts.max()), 1)
    order = np.argsort(owner, kind="stable")
    offsets = np.zeros(nbuckets + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = np.arange(nnz) - offsets[owner[order]]
    flat = owner[order] * C + slot
    binds = np.zeros((nmodes, nbuckets * C), dtype=np.int32)
    for m in range(nmodes):
        binds[m, flat] = inds[m][order]
    bvals = np.zeros(nbuckets * C, dtype=val_dtype)
    bvals[flat] = vals[order]
    return (binds.reshape(nmodes, nbuckets, C), bvals.reshape(nbuckets, C),
            C, counts)


def auto_local_engine(tt, out_dir: Optional[str]) -> str:
    """The per-rank MTTKRP engine when the caller names none.  The JAX
    package picks its blocked engine for in-memory tensors; the port runs
    the stream engine until the blocked one is ported (ROADMAP.md, queue
    A, the item after slice 5's FINE path)."""
    return "stream"


def balanced_relabel(hist: np.ndarray, nparts: int, cap: int) -> np.ndarray:
    """nnz-balanced row → label map for equal-width fences (≙ the
    nnz-balanced layer boundaries of p_find_layer_boundaries,
    src/mpi/mpi_io.c:365-439): a capacity-constrained LPT pack assigns
    rows, heaviest first, to the least-loaded fence with free slots, then
    labels fence p's rows ``p*cap .. p*cap+count_p-1``.

    Args: hist (dim,) per-row nnz counts; nparts fences of cap labels
    each (nparts*cap >= dim).  Returns (dim,) int64 old → new labels.
    """
    import heapq

    dim = int(hist.shape[0])
    if nparts * cap < dim:
        raise ValueError(f"{nparts} fences x {cap} labels < {dim} rows")
    order = np.argsort(-hist, kind="stable")
    counts = np.zeros(nparts, dtype=np.int64)
    part_of = np.empty(dim, dtype=np.int64)
    heap = [(0, p) for p in range(nparts)]
    for r in order:
        load, p = heapq.heappop(heap)
        part_of[r] = p
        counts[p] += 1
        if counts[p] < cap:  # full fences never return to the heap
            heapq.heappush(heap, (load + int(hist[r]), p))
    by_part = np.lexsort((np.arange(dim), part_of))
    starts = np.zeros(nparts, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    part_sorted = part_of[by_part]
    slot = np.arange(dim) - starts[part_sorted]
    relabel = np.empty(dim, dtype=np.int64)
    relabel[by_part] = part_sorted * cap + slot
    return relabel


def relabel_tensor(tt, relabels: Sequence[Optional[np.ndarray]],
                   dims_pad: Sequence[int]):
    """`tt` with every mode's indices mapped through its relabel array
    (None = identity), at the padded dims."""
    from splatt_tpu_torch.coo import SparseTensor

    inds = np.stack([relabels[m][np.asarray(tt.inds[m])]
                     if relabels[m] is not None
                     else np.asarray(tt.inds[m])
                     for m in range(tt.nmodes)])
    return SparseTensor(inds, tt.vals, tuple(dims_pad))


def record_shard_imbalance(scope: str, counts: np.ndarray,
                           policy: str = "equal", **extra) -> dict:
    """Record a sharding's nnz balance as a ``layout_imbalance`` event:
    max/mean nnz per shard beside the policy that produced it."""
    from splatt_tpu_torch import resilience

    counts = np.asarray(counts, dtype=np.int64).ravel()
    stats = dict(scope=scope, policy=policy, shards=int(counts.size),
                 shard_max_mean=max_mean_ratio(counts),
                 min=int(counts.min()) if counts.size else 0,
                 mean=round(float(counts.mean()), 1) if counts.size else 0,
                 max=int(counts.max()) if counts.size else 0, **extra)
    resilience.run_report().add("layout_imbalance", **stats)
    return stats


def imbalance_report(counts: np.ndarray, label: str = "device") -> str:
    """nnz-per-rank balance line (≙ mpi_rank_stats, src/stats.c:298-457):
    max/avg is the padded-work waste factor (1.0 = balanced)."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0 or counts.sum() == 0:
        return f"  {label} nnz: (empty)"
    avg = counts.mean()
    imb = counts.max() / avg if avg > 0 else 1.0
    return (f"  {label} nnz: min={int(counts.min())} avg={avg:.1f} "
            f"max={int(counts.max())} imbalance={imb:.2f}")


def comm_volume_model(dims_pad: Sequence[int], rank: int, itemsize: int,
                      *, ndev: int = None, acc_itemsize: int = 4,
                      variant: str = "all2all") -> dict:
    """Per-iteration, per-rank wire model of the FINE sweep's exchanges
    (≙ mpi_send_recv_stats), the same numbers as the JAX package's model:
    "all2all" at the collectives' ring lower bounds; "ring" ndev hops per
    gather leg of one (dim/ndev, R) block and the blockwise reduce;
    "async_ring" ndev-1 hops per leg, the reduce point to point at
    accumulator width, ``per_hop_mb`` (the largest hop) and
    ``overlap_eligible_frac`` (the ring bytes a double buffer can hide:
    all but the pipeline fill)."""
    nmodes = len(dims_pad)
    mb = 1.0 / (1 << 20)
    out = dict(variant=variant, gather_mb=0.0, reduce_mb=0.0,
               allreduce_mb=0.0, per_hop_mb=0.0, hops=0,
               overlap_eligible_frac=0.0)
    w = max(int(ndev), 1)
    gather = reduce_b = allred = hop = 0.0
    for m in range(nmodes):
        allred += 2.0 * rank * rank * acc_itemsize
    if variant in ("ring", "async_ring"):
        real_hops = (w - 1) if variant == "async_ring" else w
        for m in range(nmodes):
            for k in range(nmodes):
                if k != m:
                    blk = (dims_pad[k] // w) * rank * itemsize
                    hop = max(hop, blk)
                    gather += real_hops * blk
            if variant == "async_ring":
                blk = (dims_pad[m] // w) * rank * acc_itemsize
                hop = max(hop, blk)
                reduce_b += (w - 1) * blk
            else:
                reduce_b += 2.0 * (w - 1) / w * dims_pad[m] * rank \
                    * acc_itemsize
        out["hops"] = int(real_hops)
        out["per_hop_mb"] = round(hop * mb, 4)
        if variant == "async_ring":
            out["overlap_eligible_frac"] = round((w - 1) / w, 4)
    else:
        for m in range(nmodes):
            for k in range(nmodes):
                if k != m:
                    gather += (w - 1) / w * dims_pad[k] * rank * itemsize
            reduce_b += (w - 1) / w * dims_pad[m] * rank * acc_itemsize
    out["gather_mb"] = round(gather * mb, 4)
    out["reduce_mb"] = round(reduce_b * mb, 4)
    out["allreduce_mb"] = round(allred * mb, 4)
    return out


def comm_volume_report(dims_pad: Sequence[int], rank: int, itemsize: int,
                       *, ndev: int = None, acc_itemsize: int = 4,
                       variant: str = "all2all") -> list:
    """The ``comm/iter/device`` lines over :func:`comm_volume_model`."""
    model = comm_volume_model(dims_pad, rank, itemsize, ndev=ndev,
                              acc_itemsize=acc_itemsize, variant=variant)
    if model["variant"] in ("ring", "async_ring"):
        tag = ("async ring" if model["variant"] == "async_ring"
               else "ppermute ring")
        line = (f"  comm/iter/device [{tag}]: gather "
                f"{model['gather_mb']:.2f}MB "
                f"({model['hops']} hops x {model['per_hop_mb']:.2f}MB max) "
                f" reduce {model['reduce_mb']:.2f}MB  allreduce "
                f"{model['allreduce_mb']:.2f}MB")
        if model["variant"] == "async_ring":
            line += (f"  overlap-eligible "
                     f"{100 * model['overlap_eligible_frac']:.0f}%")
        return [line]
    return [f"  comm/iter/device: all_gather {model['gather_mb']:.2f}MB  "
            f"psum_scatter {model['reduce_mb']:.2f}MB  "
            f"allreduce {model['allreduce_mb']:.2f}MB"]


# -- cross-rank reductions ---------------------------------------------------


def allreduce(tensors: Sequence[torch.Tensor], mesh, op: str = "sum"
              ) -> List[torch.Tensor]:
    """The ranks' tensors combined on rank 0's device in rank order
    (``sum`` or ``max``), one copy per rank on its device (ranks that
    share a device share the copy)."""
    home = mesh.devices[0]
    tot = tensors[0]
    for t in tensors[1:]:
        t = t.to(home)
        tot = tot + t if op == "sum" else torch.maximum(tot, t)
    copies = {}
    return [copies.setdefault(dev, tot.to(dev)) for dev in mesh.devices]


def mode_update_tail(M_l: Sequence[torch.Tensor], grams, m: int, reg: float,
                     first: bool, mesh, store_dtype=None):
    """The per-mode ALS tail on every rank's block: the normal-equations
    solve, the normalization with λ reduced over the ranks
    (≙ mat_normalize, src/matrix.c:117-187) and the Gram reduced over the
    ranks (≙ mat_aTa, src/matrix.c:445-452).

    `grams[k]` holds rank copies of mode k's Gram.  The left-hand side
    is the same on every rank, so it is factored once, on rank 0's
    device, and each rank solves its rows with the factors copied over
    (:func:`solve_normals_many`).  Returns (U per rank, Gram per rank, λ
    per rank); U is stored in `store_dtype`, the rest in the
    accumulator dtype."""
    from splatt_tpu_torch.ops.linalg import form_normal_lhs, gram

    lhs = form_normal_lhs([g[0] for g in grams], m, reg)
    U = solve_normals_many(lhs, M_l)
    if first:
        lam = [torch.sqrt(s) for s in
               allreduce([torch.sum(u * u, dim=0) for u in U], mesh)]
    else:
        lam = [torch.clamp(x, min=1.0) for x in
               allreduce([torch.max(u, dim=0).values for u in U], mesh,
                         op="max")]
    U = [u / torch.where(lm > 0, lm, torch.ones_like(lm))
         for u, lm in zip(U, lam)]
    if store_dtype is not None:
        U = [u.to(store_dtype) for u in U]
    grams_m = allreduce([gram(u) for u in U], mesh)
    return U, grams_m, lam


def solve_normals_many(lhs: torch.Tensor, rhs: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """:func:`splatt_tpu_torch.ops.linalg.solve_normals` of one `lhs`
    against each rank's `rhs`: the Cholesky and eigen factors of `lhs`
    are computed once (on a card by the eigensolver kernel, no host sync)
    and copied to each rank's device, and each rank picks the Cholesky or
    the pseudo-inverse solve on the same SPD test."""
    from splatt_tpu_torch.ops.linalg import pinv_parts

    L, info = torch.linalg.cholesky_ex(lhs)
    w, v, tol, w_inv = pinv_parts(lhs)
    spd_lhs = (info == 0) & (w.min() > tol)
    pinv_op = v * w_inv
    ops = {}
    out = []
    for r in rhs:
        dev = r.device
        if dev not in ops:
            ops[dev] = tuple(t.to(dev) for t in (L, pinv_op, v, spd_lhs))
        L_d, p_d, v_d, spd_d = ops[dev]
        r = r.to(acc_dtype(r.dtype))
        x_chol = torch.cholesky_solve(r.T, L_d).T
        x_pinv = (r @ p_d) @ v_d.T
        spd = spd_d & torch.isfinite(x_chol).all()
        out.append(torch.where(spd, x_chol, x_pinv))
    return out


def fit_tail(lam, grams, M_l, U_last, mesh):
    """⟨Z,Z⟩ from λ and the Grams, and ⟨X,Z⟩ from the last mode's MTTKRP
    blocks summed over the ranks (≙ p_calc_fit + the fit allreduce,
    mpi_cpd.c:92-98); both on rank 0's device."""
    had = torch.outer(lam[0], lam[0])
    for g in grams:
        had = had * g[0]
    znormsq = torch.sum(had)
    inner = allreduce([torch.sum(M * U.to(M.dtype) * lm[None, :])
                       for M, U, lm in zip(M_l, U_last, lam)], mesh)[0]
    return znormsq, inner


def _fit(xnormsq: float, znormsq: torch.Tensor,
         inner: torch.Tensor) -> torch.Tensor:
    residual = torch.sqrt(torch.clamp(xnormsq + znormsq - 2.0 * inner,
                                      min=0.0))
    return 1.0 - residual / np.sqrt(xnormsq)


# -- the driver loop ---------------------------------------------------------


def _gather_global(shards) -> torch.Tensor:
    """One row-sharded factor, its shards concatenated on the host."""
    return torch.cat([s.cpu() for s in shards])


def _gather_original(factors, dims, row_select) -> List[torch.Tensor]:
    """Bring the row-sharded factors to the host, restore the original
    row order and strip the row padding."""
    out = []
    for m, shards in enumerate(factors):
        g = _gather_global(shards)
        sel = row_select[m] if row_select is not None else None
        out.append(g[:dims[m]] if sel is None
                   else g[torch.from_numpy(np.asarray(sel))])
    return out


def run_distributed_als(step: Callable, factors, grams, rank: int,
                        opts: Options, xnormsq: float,
                        dims: Sequence[int], dtype, mesh,
                        row_select=None,
                        after_fit: Optional[Callable] = None
                        ) -> KruskalTensor:
    """Host convergence loop and post-processing of a distributed sweep.

    ``step(factors, grams, first) -> (factors, grams, λ, ⟨Z,Z⟩, ⟨X,Z⟩)``
    with factors and Grams as per-rank lists.  Reading the fit is the
    iteration's one host sync; the eigensolver's status word is read
    right after it, then `after_fit` runs (the ring kernels' error
    check).  The factors come back to the host, in the original row
    order (`row_select[m]` maps an original row to its placement), and
    are renormalized into λ (≙ cpd_post_process).
    """
    from splatt_tpu_torch.config import fit_dtype
    from splatt_tpu_torch.ops.linalg import check_solver

    fit_prev = 0.0
    fits: List[float] = []
    seconds: List[float] = []
    lam = [torch.ones(rank, dtype=torch.promote_types(dtype, fit_dtype()),
                      device=mesh.devices[0])]
    for it in range(opts.max_iterations):
        t0 = time.perf_counter()
        factors, grams, lam, znormsq, inner = step(factors, grams, it == 0)
        fitval = float(_fit(xnormsq, znormsq, inner))
        check_solver()
        if after_fit is not None:
            after_fit()
        fits.append(fitval)
        seconds.append(time.perf_counter() - t0)
        if opts.verbosity >= Verbosity.LOW:
            print(f"  its = {it + 1:3d} ({seconds[-1]:.3f}s)"
                  f"  fit = {fitval:0.5f}  delta = {fitval - fit_prev:+0.4e}")
        converged = it > 0 and abs(fitval - fit_prev) < opts.tolerance
        fit_prev = fitval
        if converged:
            break
    gathered = _gather_original(factors, dims, row_select)
    return post_process(gathered, lam[0].cpu(), fit_prev, fits, seconds)
