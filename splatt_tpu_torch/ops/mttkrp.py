"""MTTKRP — the hot kernel (≙ src/mttkrp.c).

Counterpart of ``splatt_tpu/ops/mttkrp.py``.  For every output row i of
`mode`::

    M[i, :] = Σ_{nnz n : ind_mode[n] = i}  val[n] · ∏_{k≠mode} U_k[ind_k[n], :]

Paths (the algorithm, chosen by :func:`_choose_path_bs`):

- ``stream``: COO gather product and ``index_add_``, the oracle.
- ``sorted_onehot``: a layout sorted by the output mode; an engine gives
  per-block partials ``(nb, S, R)``, which ``index_add_`` combines at
  ``row_start + s``.
- ``privatized``: a short mode without its own layout; an engine sums all
  blocks into one ``(ceil8(dim+1), R)`` accumulator.
- ``scatter`` / ``sorted_scatter``: the gather product fed to
  ``index_add_`` in plain torch, as the JAX package leaves it to XLA;
- ``dense``: a dense tile layout's own mode, the matmul of its value
  tiles with the Khatri-Rao operand of the other factors (docs/dense.md).

Engines (who computes ``sorted_onehot`` and ``privatized``), in the order
:func:`engine_chain` tries them, with the JAX package's names:

- ``fused_v2`` — :func:`kernels.fused_mttkrp_v2`, R ≤ 256, only on a
  compact v2 layout under ``SPLATT_DECODE=kernel``: it reads the encoded
  streams and decodes in registers;
- ``fused_t`` — :func:`kernels.fused_mttkrp_t`, R ≤ 256;
- ``fused_tg`` — :func:`kernels.fused_mttkrp_tg`, any R;
- ``fused`` — :func:`kernels.fused_mttkrp`, only with
  ``SPLATT_EXPERIMENTAL_FUSED=1``;
- ``unfused_pallas`` — the ``(nnz_pad, R)`` product in plain torch, then
  :func:`kernels.onehot_reduce_sorted` / :func:`kernels.onehot_reduce_full`;
- ``xla_scan`` — plain torch, chunked over blocks so the ``(nnz, R)``
  product never exists whole (CPU tensors only);
- ``xla`` — the terminal: plain-torch gather and ``index_add_`` (CPU
  tensors only, and the scatter paths on every device).

The ``dense`` path has its own chain: ``fused_dense``
(:func:`kernels.fused_dense`), then, on a CPU tensor only, the plain-torch
``dense_xla`` (:func:`dense_mttkrp`).

Over a v2 layout, ``fused_v2``, ``xla_scan`` and ``xla`` read the encoded
streams (:data:`STREAM_NATIVE_ENGINES`); the other kernel engines read the
layout decoded to v1 first (prep decode, ``blocked.decode_to_v1``).
``SPLATT_DECODE=prep`` decodes before the chain, so every engine runs the
v1 dataflow; an armed ``format.decode`` fault does the same for one call
and leaves a ``format_fallback`` event.

``impl="native"`` asks :func:`mttkrp` for the host C++ engine
(``native.mttkrp``) instead of the chain, on CPU tensors only: it runs
where :func:`native_runnable` holds (the JAX package's gate) and the chain
runs otherwise; on a CUDA tensor it raises, never copying to the host.
The JAX package picks that engine by default on a CPU; the port's CPU
default stays the chain's plain versions, which hold the kernel engines'
dataflow in the CPU tests.

:func:`mttkrp_blocked` walks the chain, headed by the engine of an
applicable autotuned plan (``tune.py``).  An engine's own failure (an armed
fault, a launch the card refused, an out-of-memory) demotes it in the
resilience registry and the next engine runs; every other error
propagates.  On a CPU tensor each kernel engine runs its kernel's plain
version, so the CPU walks the kernel engines the card walks.  On a card
the chain ends at the last kernel engine: its failure raises, and no
plain-torch engine stands in for a kernel.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from splatt_tpu_torch.blocked import (BlockedSparse, ModeLayout,
                                      decode_global_ids, decode_segment_ids,
                                      decode_to_v1)
from splatt_tpu_torch.config import Options, acc_dtype, resolve_decode
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch import trace
from splatt_tpu_torch.ops import kernels

#: elements of the (C·B, R) gather product one step of the xla_scan
#: engine materializes
SCAN_TARGET_ELEMS = 1 << 23

#: blocks per CTA of the fused engine (the JAX engine's chunk too): 5,
#: which cuts the NELL-2 grid to 8 CTAs per SM of an H100, ran 1.4x
#: slower than 1 (PERF.md)
FUSED_CHUNK = 1

#: device-memory budget of the unfused engine's (nnz_pad, R) product
#: (≙ _unfused_hbm_ok's 6 GiB, at the real R: the card pads no lanes)
UNFUSED_BUDGET_BYTES = 6 << 30

#: engines that read a compact layout's encoded streams themselves
#: (fused_v2 in the kernel, xla_scan per chunk, xla through mode_ids);
#: the others read it decoded to v1 (≙ splatt_tpu.ops.mttkrp)
STREAM_NATIVE_ENGINES = ("fused_v2", "xla_scan", "xla")

#: (engine, shape key) pairs whose first dispatch over a compact layout
#: left its format_decode event
_DECODE_NOTED: set = set()
#: (engine, shape key, mode) triples whose first dispatch over a dense
#: layout left its dense_dispatch event; the JAX package keys on (engine,
#: shape key) alone, which leaves silent a second mode of the same row tile
_DENSE_NOTED: set = set()
#: (engine, shape key) pairs whose first launch ran under the deadline
#: watchdog (resilience.deadline); later launches skip the timer thread
_DEADLINE_ARMED: set = set()


def _hadamard(vals: torch.Tensor, factors: Sequence[torch.Tensor],
              mode: int, ids_of) -> torch.Tensor:
    """(n, R) partial products val · ⊛_{k≠mode} U_k[ids_of(k)], formed
    in the factor dtype; ids clamp into range (sentinel entries carry
    value 0)."""
    prod = vals.to(factors[0].dtype)[:, None]
    for k, U in enumerate(factors):
        if k != mode:
            idx = ids_of(k).clamp(0, U.shape[0] - 1)
            prod = prod * U.index_select(0, idx)
    return prod


def _gather_prod(inds: torch.Tensor, vals: torch.Tensor,
                 factors: Sequence[torch.Tensor], mode: int) -> torch.Tensor:
    """(nnz, R) partial products over global ids ``inds[k]``."""
    return _hadamard(vals, factors, mode, lambda k: inds[k])


def _gather_prod_layout(layout: ModeLayout, factors: Sequence[torch.Tensor],
                        mode: int) -> torch.Tensor:
    """(nnz_pad, R) partial products over a layout of either encoding:
    each mode's ids decoded through ``mode_ids``, bf16-stored values
    cast to the factor dtype (≙ splatt_tpu.ops.mttkrp.
    _gather_prod_layout)."""
    return _hadamard(layout.vals, factors, mode, layout.mode_ids)


def mttkrp_stream(inds: torch.Tensor, vals: torch.Tensor,
                  factors: Sequence[torch.Tensor], mode: int,
                  dim: int) -> torch.Tensor:
    """COO streaming MTTKRP — the oracle (≙ src/mttkrp.c:1697-1757)."""
    prod = _gather_prod(inds, vals, factors, mode)
    acc = acc_dtype(prod.dtype)
    out = torch.zeros((dim, prod.shape[1]), dtype=acc, device=prod.device)
    return out.index_add_(0, inds[mode].long(), prod.to(acc))


def mttkrp_batched_stream(inds: torch.Tensor, vals: torch.Tensor,
                          factors: Sequence[torch.Tensor], mode: int,
                          dim: int) -> torch.Tensor:
    """:func:`mttkrp_stream` of each slot of a stacked same-regime batch
    (≙ splatt_tpu.ops.mttkrp.mttkrp_batched_stream, a vmapped segment sum
    that the JAX package leaves to XLA; plain torch here, as the scatter
    path is).  `inds` is ``(K, nmodes, nnz_pad)`` global int32 ids, `vals`
    ``(K, nnz_pad)``, `factors` per-mode ``(K, dim_m, R)``; returns ``(K,
    dim, R)`` in the accumulator dtype (f32 under bf16 storage).

    The factors are flattened to ``(K·dim_m, R)`` and each slot's ids
    offset by ``slot·dim_m``, so one gather per mode and one ``index_add_``
    serve every slot, and no slot reads another's rows.  Ids are clamped
    into the slot's bucket first, as the single-tensor gather clamps
    them; pads carry value 0."""
    K = int(vals.shape[0])
    slots = torch.arange(K, device=vals.device, dtype=torch.int64)[:, None]
    prod = vals.to(factors[0].dtype)[..., None]
    for k, U in enumerate(factors):
        if k != mode:
            d = int(U.shape[1])
            idx = inds[:, k].clamp(0, d - 1).long() + slots * d
            prod = prod * U.reshape(K * d, -1).index_select(
                0, idx.reshape(-1)).reshape(K, -1, U.shape[2])
    acc = acc_dtype(prod.dtype)
    out = torch.zeros((K * dim, prod.shape[2]), dtype=acc,
                      device=prod.device)
    rows = (inds[:, mode].long() + slots * dim).reshape(-1)
    out.index_add_(0, rows, prod.reshape(-1, prod.shape[2]).to(acc))
    return out.reshape(K, dim, -1)


def mttkrp_ttbox(inds: torch.Tensor, vals: torch.Tensor,
                 factors: Sequence[torch.Tensor], mode: int,
                 dim: int) -> torch.Tensor:
    """The column-at-a-time MTTKRP (≙ mttkrp_ttbox, src/mttkrp.c:1655-1695;
    splatt_tpu.ops.mttkrp.mttkrp_ttbox): one pass over the nonzeros per
    rank column, accumulated like :func:`mttkrp_stream`.  A bench
    baseline only."""
    acc = acc_dtype(factors[0].dtype)
    ids = inds[mode].long()
    R = int(factors[0].shape[1])
    out = torch.zeros((dim, R), dtype=acc, device=vals.device)
    for r in range(R):
        p = vals.to(factors[0].dtype)
        for k, U in enumerate(factors):
            if k != mode:
                idx = inds[k].clamp(0, U.shape[0] - 1)
                p = p * U[:, r].index_select(0, idx)
        out[:, r].index_add_(0, ids, p.to(acc))
    return out


# -- the dense path (docs/dense.md) -----------------------------------------


def dense_operands(layout, factors: Sequence[torch.Tensor], mode: int):
    """The two Khatri-Rao operands of the dense-mode matmul
    (≙ splatt_tpu.ops.mttkrp.dense_operands): ``w``, the chained
    Khatri-Rao product of the outer factors ``(n_outer, R)`` (all ones
    when the mode has one other), and ``u``, the inner factor zero-padded
    to ``(inner_pad, R)``, so the value tiles' pad columns meet exact
    zeros.  Column c of the unfolding is ``outer · inner_pad + inner``,
    the row order of ``(w[:, None, :] * u[None, :, :]).reshape(span,
    R)``.  Both are formed in the factor dtype; the kernel and its plain
    version share them."""
    geo = layout.geometry
    dtype = factors[0].dtype
    R = int(factors[0].shape[1])
    dev = factors[0].device
    w = torch.ones((1, R), dtype=dtype, device=dev)
    for k in geo.others[:-1]:
        w = (w[:, None, :] * factors[k][None, :, :]).reshape(-1, R)
    u = factors[geo.inner]
    pad = geo.inner_pad - int(u.shape[0])
    if pad:
        u = torch.nn.functional.pad(u, (0, 0, 0, pad))
    return w, u


def dense_mttkrp(layout, factors: Sequence[torch.Tensor],
                 mode: int) -> torch.Tensor:
    """The ``dense_xla`` engine (≙ splatt_tpu.ops.mttkrp.dense_mttkrp):
    the value tiles contracted against the Khatri-Rao operand in one
    batched matmul, no index streams, gathers or scatter.  It closes the
    dense chain on a CPU tensor and computes what
    :func:`kernels.fused_dense_plain` computes, which it calls."""
    return kernels.fused_dense_plain(layout, factors, mode)


# -- engines -----------------------------------------------------------------


def _scan_fused(layout: ModeLayout, factors: Sequence[torch.Tensor],
                mode: int, width: int, accumulate: bool,
                target_elems: int = SCAN_TARGET_ELEMS) -> torch.Tensor:
    """The ``xla_scan`` engine (≙ _scan_fused, splatt_tpu/ops/
    mttkrp.py:264-376) in plain torch: decode, gather, Hadamard and the
    row reduce one chunk of C blocks at a time, so only a (C·B, R)
    product and the chunk's decoded ids exist at once.  Each stream
    decodes per chunk through the stream vocabulary; a chunk boundary is
    a block boundary, so a delta or RLE stream needs no carry.  The last
    chunk is ragged rather than padded, so no pad blocks (and no RLE pad
    count vectors) are made.  Output as :func:`kernels.fused_mttkrp_t`."""
    nb, B = layout.nblocks, layout.block
    R = int(factors[0].shape[1])
    C = max(1, min(nb, target_elems // max(B * R, 1)))
    acc = acc_dtype(factors[0].dtype)
    dev = layout.vals.device
    streams, bases, encs = layout.mode_streams()
    blocked = [st.reshape(nb, -1) for st in streams]
    if accumulate:
        out = torch.zeros((width, R), dtype=acc, device=dev)
    else:
        out = torch.empty((nb, width, R), dtype=acc, device=dev)
    for b0 in range(0, nb, C):
        b1 = min(b0 + C, nb)
        lo, hi = b0 * B, b1 * B

        def ids_of(k, sl=slice(b0, b1)):
            base = None if bases is None else bases[k][sl, None]
            return decode_global_ids(blocked[k][sl], base, encs[k], B)

        prod = _hadamard(layout.vals[lo:hi], factors, mode,
                         lambda k: ids_of(k).reshape(-1)).reshape(
                             b1 - b0, B, R)
        if accumulate:
            out += kernels.onehot_reduce_full_plain(ids_of(mode), prod,
                                                    width)
        else:
            ids = decode_segment_ids(blocked[mode][b0:b1], encs[mode], B,
                                     row_start=layout.row_start[b0:b1, None])
            out[b0:b1] = kernels.onehot_reduce_sorted_plain(ids, prod, width)
    return out


def _run_engine(engine: str, layout: ModeLayout,
                factors: Sequence[torch.Tensor], mode: int,
                path: str,
                scan_target: int = SCAN_TARGET_ELEMS) -> torch.Tensor:
    """MTTKRP of one layout along `path` with `engine`; ``(dim, R)``.
    An engine outside :data:`STREAM_NATIVE_ENGINES` reads a v2 layout
    decoded to v1; `scan_target` sizes the xla_scan engine's chunks."""
    if engine == "fused_dense":
        return kernels.fused_dense(layout, factors, mode)
    if engine == "dense_xla":
        return dense_mttkrp(layout, factors, mode)
    dim = int(factors[mode].shape[0])
    R = int(factors[mode].shape[1])
    if engine not in STREAM_NATIVE_ENGINES:
        layout = decode_to_v1(layout)
    if engine == "xla":
        # the stream formulation over the layout's arrays: any mode, no
        # kernel; the sorted mode's pads carry id dim (a spill row) in a
        # fixed v1 layout, the block's last real row with value 0 in v2
        # and in a balanced layout
        prod = _gather_prod_layout(layout, factors, mode)
        acc = acc_dtype(prod.dtype)
        nseg = dim + 1 if mode == layout.mode else dim
        out = torch.zeros((nseg, R), dtype=acc, device=prod.device)
        out.index_add_(0, layout.mode_ids(mode).long(), prod.to(acc))
        return out[:dim]
    nb, B = layout.nblocks, layout.block
    accumulate = path == "privatized"
    # the privatized accumulator has a row for the sentinel id dim
    width = -(-(dim + 1) // 8) * 8 if accumulate else layout.seg_width
    if engine == "fused_v2":
        parts = kernels.fused_mttkrp_v2(layout, factors, mode, width,
                                        accumulate)
    elif engine == "fused_t":
        parts = kernels.fused_mttkrp_t(layout, factors, mode, width,
                                       accumulate)
    elif engine == "fused_tg":
        parts = kernels.fused_mttkrp_tg(layout, factors, mode, width,
                                        accumulate)
    elif engine == "fused":
        parts = kernels.fused_mttkrp(layout, factors, mode, width,
                                     accumulate, chunk=FUSED_CHUNK)
    elif engine == "unfused_pallas":
        prod = _gather_prod_layout(layout, factors, mode).reshape(nb, B, R)
        if accumulate:
            parts = kernels.onehot_reduce_full(
                layout.mode_ids(mode).reshape(nb, B), prod, width)
        else:
            parts = kernels.onehot_reduce_sorted(layout.blocked_locals(),
                                                 prod, width)
    elif engine == "xla_scan":
        parts = _scan_fused(layout, factors, mode, width, accumulate,
                            target_elems=scan_target)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    if accumulate:
        return parts[:dim]
    idx = (layout.row_start.long()[:, None]
           + torch.arange(width, device=parts.device)).reshape(-1)
    out = torch.zeros((dim + width + 1, R), dtype=parts.dtype,
                      device=parts.device)
    out.index_add_(0, idx, parts.reshape(-1, R))
    return out[:dim]


# -- the engine chain --------------------------------------------------------


def _engine_shape_key(layout: ModeLayout, factors: Sequence[torch.Tensor],
                      mode: int) -> str:
    """Demotion scope of RESOURCE failures: ``r{R rounded up to the
    32-lane rank tile}:b{block}``, so an out-of-memory at one shape
    never demotes the engine for shapes that fit; a compact layout adds
    ``:v2``, so an out-of-memory under v2 leaves v1 alone (and the
    reverse); a dense layout adds ``:dn`` (its block is the row tile); a
    balanced layout ``:bal`` and a reordered one ``:ro``
    (≙ splatt_tpu/ops/mttkrp.py:783-791), so the default layouts' keys
    are unchanged."""
    R = int(factors[0].shape[1])
    key = f"r{-(-R // 32) * 32}:b{layout.block}"
    # getattr: chain tests pass stand-in layouts
    enc = getattr(layout, "encoding", "v1")
    if enc == "dense":
        key += ":dn"
    elif enc != "v1":
        key += ":v2"
    if getattr(layout, "packing", "fixed") != "fixed":
        key += ":bal"
    if getattr(layout, "reorder", "identity") != "identity":
        key += ":ro"
    return key


def _unfused_fits(layout: ModeLayout, R: int, itemsize: int) -> bool:
    """Whether the unfused engine's (nnz_pad, R) product fits its
    device-memory budget (≙ _unfused_hbm_ok)."""
    return layout.nnz_pad * R * itemsize <= UNFUSED_BUDGET_BYTES


def engine_chain(layout: ModeLayout, factors: Sequence[torch.Tensor],
                 mode: int, path: str = "sorted_onehot", *,
                 shape_key: Optional[str] = None) -> List[str]:
    """The ordered engine chain of this call: every engine whose static
    gate passes and that is not demoted, best first
    (≙ splatt_tpu.ops.mttkrp.engine_chain).  Gates: ``fused_v2`` a
    compact v2 layout, ``SPLATT_DECODE=kernel`` and R ≤
    :data:`kernels.MAX_RANK`; ``fused_t`` and
    ``fused`` R ≤ :data:`kernels.MAX_RANK` (register budget);
    ``fused_tg`` any R; ``fused`` only with SPLATT_EXPERIMENTAL_FUSED=1;
    ``unfused_pallas`` the (nnz_pad, R) product within
    :data:`UNFUSED_BUDGET_BYTES`.  On a CPU tensor the chain goes on to
    ``xla_scan`` and ends in the terminal ``xla`` engine, which has no
    gate and cannot be demoted out, as in the JAX package.  On a card it
    holds only kernel engines, and is empty once all are demoted.

    A dense layout has its own chain:
    ``fused_dense`` (gate R ≤ :data:`kernels.DENSE_MAX_RANK`; the JAX
    gate, a VMEM residency plan, has no counterpart since the kernel
    tiles both the span and the rank), then on a CPU tensor the terminal
    ``dense_xla``."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils.env import read_env

    if path in ("scatter", "sorted_scatter", "stream"):
        return ["xla"]
    R = int(factors[0].shape[1])
    itemsize = factors[0].element_size()
    if shape_key is None:
        shape_key = _engine_shape_key(layout, factors, mode)

    def live(name):
        return not resilience.is_demoted(name, shape_key)

    if getattr(layout, "encoding", "v1") == "dense":
        chain = []
        if live("fused_dense") and R <= kernels.DENSE_MAX_RANK:
            chain.append("fused_dense")
        if layout.device.type != "cuda":
            chain.append("dense_xla")
        return chain
    chain = []
    if (getattr(layout, "encoding", "v1") != "v1"
            and resolve_decode() == "kernel" and live("fused_v2")
            and R <= kernels.MAX_RANK):
        chain.append("fused_v2")
    if live("fused_t") and R <= kernels.MAX_RANK:
        chain.append("fused_t")
    if live("fused_tg"):
        chain.append("fused_tg")
    if (read_env("SPLATT_EXPERIMENTAL_FUSED") == "1" and live("fused")
            and R <= kernels.MAX_RANK):
        chain.append("fused")
    if live("unfused_pallas") and _unfused_fits(layout, R, itemsize):
        chain.append("unfused_pallas")
    if layout.vals.device.type == "cuda":
        return chain
    if live("xla_scan"):
        chain.append("xla_scan")
    chain.append("xla")
    return chain


def _engine_failure(exc: BaseException) -> bool:
    """Whether `exc` is an engine's own failure, the only kind the chain
    demotes: an armed fault, a launch the card refused, an
    out-of-memory, or a first launch that blew its deadline (TIMEOUT,
    demoted per shape).  A wrong operand, a failed build or load, and a
    CUDA error left by earlier work propagate."""
    from splatt_tpu_torch.resilience import DeadlineExceeded
    from splatt_tpu_torch.utils import faults

    return (faults.injected(exc)
            or isinstance(exc, (kernels.KernelLaunchError,
                                torch.OutOfMemoryError, DeadlineExceeded)))


#: the per-layout lookup memo's mark of a call signature not yet answered
_NO_ANSWER = object()


def _tuned_plan_for(layout: ModeLayout, factors: Sequence[torch.Tensor],
                    mode: int, path: str, autotune: Optional[bool] = None,
                    shape_key: Optional[str] = None):
    """The cached autotuner plan that applies to this dispatch, or None
    (≙ splatt_tpu.ops.mttkrp._tuned_plan_for).  The match is strict: the
    plan's path, block, index width, value storage, packing and reorder
    must be this layout's, and its engine must not be demoted for this
    shape.  The match (:func:`_resolve_tuned_plan`) is memoized on the
    layout per call signature and plan-cache generation, so a warm
    dispatch is one dict hit and the demotion check."""
    from splatt_tpu_torch import resilience, tune

    if autotune is False or getattr(layout, "nnz", None) is None:
        return None  # autotune off, or a stand-in layout without a key
    gen = tune.memo_generation()
    memo = layout.__dict__.get("_tuned_memo")
    if memo is None or memo[0] != gen:
        memo = layout.__dict__["_tuned_memo"] = (gen, {})
    key = (autotune, os.environ.get(tune._AUTOTUNE_ENV),
           os.environ.get(tune._CACHE_ENV), mode, path,
           int(factors[0].shape[1]), factors[0].dtype)
    plan = memo[1].get(key, _NO_ANSWER)
    if plan is _NO_ANSWER:
        plan = memo[1][key] = _resolve_tuned_plan(layout, factors, mode,
                                                  path, autotune)
    if plan is None:
        return None
    if shape_key is None:
        shape_key = _engine_shape_key(layout, factors, mode)
    if resilience.is_demoted(plan.engine, shape_key):
        return None
    return plan


def _resolve_tuned_plan(layout: ModeLayout,
                        factors: Sequence[torch.Tensor], mode: int,
                        path: str, autotune: Optional[bool]):
    """The cached plan whose match fields are this layout's, or None,
    before the demotion check.  The key's skew is ``layout.skew``, which
    the build stamped."""
    from splatt_tpu_torch import tune

    if not tune.autotune_enabled(autotune):
        return None
    nnz = layout.nnz
    plan = tune.cached_plan([int(f.shape[0]) for f in factors], nnz, mode,
                            int(factors[0].shape[1]), factors[0].dtype,
                            skew=getattr(layout, "skew", ""),
                            mode_density=getattr(layout, "density_bucket",
                                                 ""),
                            device=layout.device)
    if (plan is None or plan.path != path
            or plan.nnz_block != layout.block
            or plan.idx_width != getattr(layout, "idx_width", "i32")
            or plan.val_storage != getattr(layout, "val_storage", "auto")
            or plan.packing != getattr(layout, "packing", "fixed")
            or plan.reorder != getattr(layout, "reorder", "identity")):
        return None
    return plan


def _tuned_chain(chain: List[str], tuned) -> List[str]:
    """`chain` with an applicable plan's engine moved to its head (a plan
    whose engine the chain does not hold, gated out or demoted, leaves
    it as it is)."""
    if tuned is None or tuned.engine not in chain:
        return chain
    return [tuned.engine] + [e for e in chain if e != tuned.engine]


def mttkrp_blocked(layout: ModeLayout, factors: Sequence[torch.Tensor],
                   mode: int, path: str = "sorted_onehot",
                   fallback: Optional[bool] = None,
                   autotune: Optional[bool] = None) -> torch.Tensor:
    """Blocked MTTKRP over one layout along `path`; returns ``(dim, R)``.

    The caller's contract (device, dtype, contiguity, shapes) is checked
    once before anything runs, and on a card the kernels are built and
    loaded first: a wrong operand or a failed build raises and is never
    demoted.  A compact layout is decoded to v1 first under
    ``SPLATT_DECODE=prep``, or when an armed ``format.decode`` fault
    fires (a classified ``format_fallback`` event with ``site="decode"``,
    as in the JAX package).  Then the :func:`engine_chain` is walked; an
    engine's first dispatch over a compact layout leaves a
    ``format_decode`` event naming where its decode runs.  Each attempt runs
    under ``faults.maybe_fail(f"engine.{engine}")`` and is retried in
    place on TRANSIENT failures.  With `fallback` (default
    ``resilience.fallback_enabled()``) an engine's own failure
    (:func:`_engine_failure`) demotes it and the next engine runs; without
    it, for any other error, or at the chain's last engine, the error
    propagates.  On a card the chain holds only kernel engines, so a
    failure of the last one raises, and a call whose kernel engines are
    all demoted raises before it runs.  Nothing here synchronises the
    card: an error left sticky by a kernel surfaces at a later sync and
    propagates from there.

    Around each attempt (≙ splatt_tpu/ops/mttkrp.py:542-611) the walk
    notes the engine (``resilience.note_engine_attempt``, which the ALS
    driver's sweep-level rescue reads), opens a ``mttkrp.dispatch`` span
    (mode, path, engine, block, encoding), runs the engine's first launch
    per (engine, shape) under ``resilience.deadline`` (a blown deadline
    is TIMEOUT and demotes per shape; the kernels are built before the
    walk, so the watchdog never bounds ``nvcc``) and passes the output
    through ``faults.poison(f"engine.{engine}")``.  The JAX span fires
    once per compilation, at trace time; this one fires once per call.

    A dense layout takes the ``dense`` path whatever `path` says, skips
    the decode machinery (it has no streams), and its engine's first
    dispatch per shape and mode leaves a ``dense_dispatch`` event.

    The autotuner's plan heads the chain (`autotune`, default
    ``Options.autotune`` via :func:`mttkrp`, else SPLATT_AUTOTUNE): when
    the plan cache holds an applicable winner (:func:`_tuned_plan_for`)
    its engine is tried first, and everything above applies to it
    unchanged.  The xla_scan engine's chunks take the plan's
    ``scan_target`` when xla_scan is its engine, else
    :data:`SCAN_TARGET_ELEMS`.
    """
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils import faults

    dense = layout.encoding == "dense"
    if dense:
        path = "dense"
    if path not in ("sorted_onehot", "privatized", "scatter",
                    "sorted_scatter", "dense"):
        raise ValueError(f"unknown path {path!r}")
    if path == "dense" and not dense:
        raise ValueError("the dense path needs a dense layout")
    if path in ("sorted_onehot", "sorted_scatter") and mode != layout.mode:
        raise ValueError(f"{path} requires the layout's own mode")
    factors = list(factors)
    if fallback is None:
        fallback = resilience.fallback_enabled()
    uses_kernels = path in ("sorted_onehot", "privatized", "dense")
    kernels.check_operands(layout, factors, mode, kernels=uses_kernels)
    if layout.encoding not in ("v1", "dense"):
        if resolve_decode() == "prep":
            layout = decode_to_v1(layout)
        else:
            try:
                faults.maybe_fail("format.decode")
            except Exception as e:
                # a failed stream read degrades the call, classified, to
                # the decoded v1 layout every engine reads
                cls = resilience.classify_failure(e)
                resilience.run_report().add(
                    "format_fallback", mode=int(mode), site="decode",
                    idx_width=layout.idx_width, failure_class=cls.value,
                    error=resilience.failure_message(e)[:200])
                layout = decode_to_v1(layout)
    shape_key = _engine_shape_key(layout, factors, mode)
    chain = engine_chain(layout, factors, mode, path, shape_key=shape_key)
    tuned = _tuned_plan_for(layout, factors, mode, path, autotune=autotune,
                            shape_key=shape_key)
    chain = _tuned_chain(chain, tuned)
    scan_target = (tuned.scan_target if tuned is not None
                   and tuned.engine == "xla_scan" else SCAN_TARGET_ELEMS)
    if not chain:
        raise RuntimeError(
            f"no kernel engine left for {path} mode {mode} at "
            f"{shape_key} on {layout.device}: demoted "
            f"{[d.engine for d in resilience.demotions()]}")
    if uses_kernels and layout.device.type == "cuda":
        kernels.load_library()
    last = len(chain) - 1
    for i, engine in enumerate(chain):

        def attempt(engine=engine):
            faults.maybe_fail(f"engine.{engine}")
            if dense:
                if (engine, shape_key, mode) not in _DENSE_NOTED:
                    _DENSE_NOTED.add((engine, shape_key, mode))
                    resilience.run_report().add(
                        "dense_dispatch", engine=engine, mode=int(mode),
                        tile=layout.tile, span=layout.span,
                        density_bucket=layout.density_bucket)
            elif (layout.encoding != "v1"
                    and (engine, shape_key) not in _DECODE_NOTED):
                _DECODE_NOTED.add((engine, shape_key))
                resilience.run_report().add(
                    "format_decode", engine=engine, mode=int(mode),
                    enc=layout.format_desc(),
                    strategy=("kernel" if engine in STREAM_NATIVE_ENGINES
                              else "prep"))
            # only the xla_scan engine reads the scan target
            extra = (scan_target,) if engine == "xla_scan" else ()
            if (engine, shape_key) not in _DEADLINE_ARMED:
                # the watchdog bounds an engine's first launch per shape;
                # the kernels were built and loaded before the walk, so
                # it never bounds nvcc
                _DEADLINE_ARMED.add((engine, shape_key))
                with resilience.deadline(f"engine.{engine}"):
                    out = _run_engine(engine, layout, factors, mode, path,
                                      *extra)
            else:
                out = _run_engine(engine, layout, factors, mode, path,
                                  *extra)
            return faults.poison(f"engine.{engine}", out)

        try:
            resilience.note_engine_attempt(engine, shape_key)
            with trace.span("mttkrp.dispatch", mode=int(mode), path=path,
                            engine=engine, block=int(layout.block),
                            enc=layout.format_desc()):
                return resilience.retry_transient(attempt,
                                                  label=f"engine.{engine}")
        except Exception as e:
            if not fallback or i == last or not _engine_failure(e):
                raise
            resilience.demote_engine(engine, e, shape_key=shape_key)
    raise AssertionError("engine chain exhausted")  # pragma: no cover


# -- plans -------------------------------------------------------------------


def engine_plan(layout: ModeLayout, factors: Sequence[torch.Tensor],
                mode: int, path: str = "sorted_onehot",
                autotune: Optional[bool] = None) -> str:
    """The engine :func:`mttkrp_blocked` will run first for this call:
    an applicable autotuned plan's engine, else the head of its chain
    (the port has no lazy capability probes), or ``none`` on a card
    whose kernel engines are all demoted."""
    chain = _tuned_chain(engine_chain(layout, factors, mode, path),
                         _tuned_plan_for(layout, factors, mode, path,
                                         autotune=autotune))
    return chain[0] if chain else "none"


class Plan(NamedTuple):
    """One MTTKRP dispatch decision: where it runs (`impl`: "cuda" or
    "cpu"), the algorithm (`path`), and the engine that will run
    (`engine`).  :func:`plan_mttkrp` is the single source of it."""

    impl: str
    path: str
    engine: str


def plan_mttkrp(X: BlockedSparse, factors: Sequence[torch.Tensor],
                mode: int, path: Optional[str] = None,
                impl: Optional[str] = None) -> Plan:
    """The dispatch decision :func:`mttkrp` will execute for this call
    (`impl` as :func:`mttkrp` takes it, raising as it does for a tensor
    on a card)."""
    if impl == "native":
        _check_host([f.device for f in factors] + [X.device])
        if native_runnable(X.layout_for(mode), factors, path):
            return Plan("cpu", _choose_path_bs(X, mode), "native")
    path = path or _choose_path_bs(X, mode)
    return Plan(X.device.type, path,
                engine_plan(X.layout_for(mode), factors, mode, path,
                            autotune=X.opts.autotune))


def describe_plan(X: BlockedSparse, factors: Sequence[torch.Tensor]) -> str:
    """One line naming, per mode, the path and engine :func:`mttkrp`
    will run, and the engines demoted so far
    (≙ splatt_tpu.ops.mttkrp.describe_plan)."""
    from splatt_tpu_torch import resilience

    parts = []
    for m in range(X.nmodes):
        plan = plan_mttkrp(X, factors, m)
        parts.append(f"mode{m}={plan.path}/{plan.engine}")
    note = ""
    demoted = resilience.demotions()
    if demoted:
        labels = [d.engine + (f"@{d.shape_key}" if d.shape_key else "")
                  for d in demoted]
        note = f" [demoted this run: {', '.join(sorted(set(labels)))}]"
    return f"engine plan: impl={X.device.type} " + " ".join(parts) + note


# -- path choice and the public entry ----------------------------------------


def native_runnable(layout: ModeLayout, factors: Sequence[torch.Tensor],
                    path: Optional[str] = None) -> bool:
    """Exactly when an ``impl="native"`` call runs the host engine
    (≙ splatt_tpu.ops.mttkrp._native_runnable): no forced `path`, a v1
    layout without the balanced packing's mid-stream pads (the engine
    reads the first ``nnz`` entries as the real ones), f32 or f64 values
    with factors of the same dtype, at most ``native.MTTKRP_MAX_MODES``
    modes, and the library available."""
    from splatt_tpu_torch import native

    if path is not None or layout.encoding != "v1":
        return False
    if layout.block_nnz is not None:
        return False
    vdt = layout.vals.dtype
    if vdt not in (torch.float32, torch.float64):
        return False
    if any(f.dtype != vdt for f in factors):
        return False
    if layout.nmodes > native.MTTKRP_MAX_MODES:
        return False
    return native.available()


def _check_host(devices) -> None:
    """Raise unless every operand of a host-engine call lies on the CPU."""
    on_card = [d for d in devices if d.type != "cpu"]
    if on_card:
        raise ValueError(f"impl='native' is the host engine: it takes CPU "
                         f"tensors only, not {on_card[0]} (nothing is "
                         f"copied to the host)")


def run_native(layout: ModeLayout, factors: Sequence[torch.Tensor],
               mode: int) -> Optional[torch.Tensor]:
    """The host engine's MTTKRP of `mode` over a v1 layout on the CPU, in
    the values' dtype (``native.mttkrp`` over the tensors' own memory),
    or None when the library declines.  Raises ValueError for an operand
    on a card."""
    from splatt_tpu_torch import native

    _check_host([layout.vals.device] + [f.device for f in factors])
    dims = [int(f.shape[0]) for f in factors]
    out = native.mttkrp(layout.inds.numpy(), layout.vals.numpy(),
                        [f.detach().contiguous().numpy() for f in factors],
                        mode, dims, sorted_by_mode=(mode == layout.mode),
                        nnz=layout.nnz)
    return None if out is None else torch.from_numpy(out)


def choose_path(layout: ModeLayout, mode: int, opts: Options) -> str:
    """Path for a mode the layout may be sorted by.

    One rule on every device, so the CPU tests walk the paths the card
    runs: the kernel reduces a sorted block without the one-hot's
    redundant multiply-adds, so the sorted path is taken whenever the
    block row span fits ``onehot_cap``.  (The JAX package takes it only
    on a TPU, where a matrix unit executes those multiply-adds.)  A
    dense layout takes the ``dense`` path.
    """
    if layout.encoding == "dense":
        return "dense"
    if mode == layout.mode:
        if layout.seg_width <= opts.onehot_cap:
            return "sorted_onehot"
        return "sorted_scatter"
    return "scatter"


def _choose_path_bs(bs: BlockedSparse, mode: int) -> str:
    """As :func:`choose_path`, plus the privatized path for a short mode
    without its own layout (≙ p_is_privatized, src/mttkrp.c:221-236).
    The hybrid per-mode dispatch: a mode mapped to a dense layout takes
    the ``dense`` path, every other mode its sparse one."""
    layout = bs.layout_for(mode)
    dim = bs.dims[mode]
    if (mode != layout.mode and dim + 16 <= bs.opts.priv_cap
            and dim <= bs.opts.priv_threshold * max(bs.nnz, 1)):
        return "privatized"
    return choose_path(layout, mode, bs.opts)


def mttkrp(X: Union[SparseTensor, BlockedSparse],
           factors: Sequence[torch.Tensor], mode: int,
           path: Optional[str] = None,
           fallback: Optional[bool] = None,
           impl: Optional[str] = None) -> torch.Tensor:
    """Public MTTKRP (≙ splatt_mttkrp, include/splatt/api_kernels.h:98-119).

    A COO tensor takes the stream path on the factors' device; a
    :class:`BlockedSparse` takes :func:`_choose_path_bs`'s path unless
    `path` forces one, through :func:`mttkrp_blocked`'s engine chain,
    with ``X.opts.autotune`` deciding whether a cached plan heads it.
    ``impl="native"`` runs the host C++ engine instead where
    :func:`native_runnable` holds (the chain otherwise, as the JAX
    package falls back), on CPU tensors only: it raises for a tensor on a
    card.
    """
    if impl not in (None, "native"):
        raise ValueError(f"unknown impl {impl!r} (None or 'native')")
    if impl == "native":
        _check_host([f.device for f in factors]
                    + ([X.device] if isinstance(X, BlockedSparse) else []))
        if isinstance(X, BlockedSparse) and native_runnable(
                X.layout_for(mode), factors, path):
            out = run_native(X.layout_for(mode), factors, mode)
            if out is not None:
                return out
    if isinstance(X, SparseTensor):
        if path not in (None, "stream"):
            raise ValueError(
                f"path={path!r} requires a BlockedSparse input; a COO "
                f"SparseTensor only supports the stream path")
        dev = factors[0].device
        inds = torch.from_numpy(X.inds).to(dev)
        vals = torch.from_numpy(X.vals).to(dev)
        return mttkrp_stream(inds, vals, factors, mode, X.dims[mode])
    path = path or _choose_path_bs(X, mode)
    return mttkrp_blocked(X.layout_for(mode), factors, mode, path,
                          fallback=fallback, autotune=X.opts.autotune)
