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
  ``index_add_`` in plain torch, as the JAX package leaves it to XLA.

Engines (who computes ``sorted_onehot`` and ``privatized``), in the order
:func:`engine_chain` tries them, with the JAX package's names:

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

:func:`mttkrp_blocked` walks the chain.  An engine's own failure (an armed
fault, a launch the card refused, an out-of-memory) demotes it in the
resilience registry and the next engine runs; every other error
propagates.  On a CPU tensor each kernel engine runs its kernel's plain
version, so the CPU walks the kernel engines the card walks.  On a card
the chain ends at the last kernel engine: its failure raises, and no
plain-torch engine stands in for a kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from splatt_tpu_torch.blocked import BlockedSparse, ModeLayout
from splatt_tpu_torch.config import Options, acc_dtype
from splatt_tpu_torch.coo import SparseTensor
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


def _gather_prod(inds: torch.Tensor, vals: torch.Tensor,
                 factors: Sequence[torch.Tensor], mode: int) -> torch.Tensor:
    """(nnz, R) partial products val · ⊛_{k≠mode} U_k[ind_k]; ids clamp
    into range (sentinel entries carry value 0)."""
    prod = vals.to(factors[0].dtype)[:, None]
    for k, U in enumerate(factors):
        if k != mode:
            idx = inds[k].clamp(0, U.shape[0] - 1)
            prod = prod * U.index_select(0, idx)
    return prod


def mttkrp_stream(inds: torch.Tensor, vals: torch.Tensor,
                  factors: Sequence[torch.Tensor], mode: int,
                  dim: int) -> torch.Tensor:
    """COO streaming MTTKRP — the oracle (≙ src/mttkrp.c:1697-1757)."""
    prod = _gather_prod(inds, vals, factors, mode)
    acc = acc_dtype(prod.dtype)
    out = torch.zeros((dim, prod.shape[1]), dtype=acc, device=prod.device)
    return out.index_add_(0, inds[mode].long(), prod.to(acc))


# -- engines -----------------------------------------------------------------


def _scan_fused(layout: ModeLayout, factors: Sequence[torch.Tensor],
                mode: int, width: int, accumulate: bool,
                target_elems: int = SCAN_TARGET_ELEMS) -> torch.Tensor:
    """The ``xla_scan`` engine (≙ _scan_fused, splatt_tpu/ops/
    mttkrp.py:264-376) in plain torch: gather, Hadamard and the row
    reduce one chunk of C blocks at a time, so only a (C·B, R) product
    exists at once.  Output as :func:`kernels.fused_mttkrp_t`."""
    nb, B = layout.nblocks, layout.block
    R = int(factors[0].shape[1])
    C = max(1, min(nb, target_elems // max(B * R, 1)))
    acc = acc_dtype(factors[0].dtype)
    dev = layout.vals.device
    ids = (layout.mode_ids(mode).reshape(nb, B) if accumulate
           else layout.blocked_locals())
    if accumulate:
        out = torch.zeros((width, R), dtype=acc, device=dev)
    else:
        out = torch.empty((nb, width, R), dtype=acc, device=dev)
    for b0 in range(0, nb, C):
        b1 = min(b0 + C, nb)
        lo, hi = b0 * B, b1 * B
        prod = _gather_prod(layout.inds[:, lo:hi], layout.vals[lo:hi],
                            factors, mode).reshape(b1 - b0, B, R)
        if accumulate:
            out += kernels.onehot_reduce_full_plain(ids[b0:b1], prod, width)
        else:
            out[b0:b1] = kernels.onehot_reduce_sorted_plain(ids[b0:b1], prod,
                                                            width)
    return out


def _run_engine(engine: str, layout: ModeLayout,
                factors: Sequence[torch.Tensor], mode: int,
                path: str) -> torch.Tensor:
    """MTTKRP of one layout along `path` with `engine`; ``(dim, R)``."""
    dim = int(factors[mode].shape[0])
    R = int(factors[mode].shape[1])
    if engine == "xla":
        # the stream formulation over the layout's arrays: any mode, no
        # kernel; the sorted mode's sentinels carry id dim (a spill row)
        prod = _gather_prod(layout.inds, layout.vals, factors, mode)
        acc = acc_dtype(prod.dtype)
        nseg = dim + 1 if mode == layout.mode else dim
        out = torch.zeros((nseg, R), dtype=acc, device=prod.device)
        out.index_add_(0, layout.mode_ids(mode).long(), prod.to(acc))
        return out[:dim]
    nb, B = layout.nblocks, layout.block
    accumulate = path == "privatized"
    # the privatized accumulator has a row for the sentinel id dim
    width = -(-(dim + 1) // 8) * 8 if accumulate else layout.seg_width
    if engine == "fused_t":
        parts = kernels.fused_mttkrp_t(layout, factors, mode, width,
                                       accumulate)
    elif engine == "fused_tg":
        parts = kernels.fused_mttkrp_tg(layout, factors, mode, width,
                                        accumulate)
    elif engine == "fused":
        parts = kernels.fused_mttkrp(layout, factors, mode, width,
                                     accumulate, chunk=FUSED_CHUNK)
    elif engine == "unfused_pallas":
        prod = _gather_prod(layout.inds, layout.vals, factors,
                            mode).reshape(nb, B, R)
        if accumulate:
            parts = kernels.onehot_reduce_full(
                layout.mode_ids(mode).reshape(nb, B), prod, width)
        else:
            parts = kernels.onehot_reduce_sorted(layout.blocked_locals(),
                                                 prod, width)
    elif engine == "xla_scan":
        parts = _scan_fused(layout, factors, mode, width, accumulate)
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
    never demotes the engine for shapes that fit."""
    R = int(factors[0].shape[1])
    return f"r{-(-R // 32) * 32}:b{layout.block}"


def _unfused_fits(layout: ModeLayout, R: int, itemsize: int) -> bool:
    """Whether the unfused engine's (nnz_pad, R) product fits its
    device-memory budget (≙ _unfused_hbm_ok)."""
    return layout.nnz_pad * R * itemsize <= UNFUSED_BUDGET_BYTES


def engine_chain(layout: ModeLayout, factors: Sequence[torch.Tensor],
                 mode: int, path: str = "sorted_onehot", *,
                 shape_key: Optional[str] = None) -> List[str]:
    """The ordered engine chain of this call: every engine whose static
    gate passes and that is not demoted, best first
    (≙ splatt_tpu.ops.mttkrp.engine_chain).  Gates: ``fused_t`` and
    ``fused`` R ≤ :data:`kernels.MAX_RANK` (register budget);
    ``fused_tg`` any R; ``fused`` only with SPLATT_EXPERIMENTAL_FUSED=1;
    ``unfused_pallas`` the (nnz_pad, R) product within
    :data:`UNFUSED_BUDGET_BYTES`.  On a CPU tensor the chain goes on to
    ``xla_scan`` and ends in the terminal ``xla`` engine, which has no
    gate and cannot be demoted out, as in the JAX package.  On a card it
    holds only kernel engines, and is empty once all are demoted."""
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

    chain = []
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
    demotes: an armed fault, a launch the card refused, or an
    out-of-memory.  A wrong operand, a failed build or load, and a CUDA
    error left by earlier work propagate."""
    from splatt_tpu_torch.utils import faults

    return (faults.injected(exc)
            or isinstance(exc, (kernels.KernelLaunchError,
                                torch.OutOfMemoryError)))


def mttkrp_blocked(layout: ModeLayout, factors: Sequence[torch.Tensor],
                   mode: int, path: str = "sorted_onehot",
                   fallback: Optional[bool] = None) -> torch.Tensor:
    """Blocked MTTKRP over one layout along `path`; returns ``(dim, R)``.

    The caller's contract (device, dtype, contiguity, shapes) is checked
    once before anything runs, and on a card the kernels are built and
    loaded first: a wrong operand or a failed build raises and is never
    demoted.  Then the :func:`engine_chain` is walked: each attempt runs
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
    """
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils import faults

    if path not in ("sorted_onehot", "privatized", "scatter",
                    "sorted_scatter"):
        raise ValueError(f"unknown path {path!r}")
    if path in ("sorted_onehot", "sorted_scatter") and mode != layout.mode:
        raise ValueError(f"{path} requires the layout's own mode")
    factors = list(factors)
    if fallback is None:
        fallback = resilience.fallback_enabled()
    shape_key = _engine_shape_key(layout, factors, mode)
    chain = engine_chain(layout, factors, mode, path, shape_key=shape_key)
    uses_kernels = path in ("sorted_onehot", "privatized")
    kernels.check_operands(layout, factors, mode, kernels=uses_kernels)
    if not chain:
        raise RuntimeError(
            f"no kernel engine left for {path} mode {mode} at "
            f"{shape_key} on {layout.vals.device}: demoted "
            f"{[d.engine for d in resilience.demotions()]}")
    if uses_kernels and layout.vals.device.type == "cuda":
        kernels.load_library()
    last = len(chain) - 1
    for i, engine in enumerate(chain):

        def attempt(engine=engine):
            faults.maybe_fail(f"engine.{engine}")
            out = _run_engine(engine, layout, factors, mode, path)
            return faults.poison(f"engine.{engine}", out)

        try:
            return resilience.retry_transient(attempt,
                                              label=f"engine.{engine}")
        except Exception as e:
            if not fallback or i == last or not _engine_failure(e):
                raise
            resilience.demote_engine(engine, e, shape_key=shape_key)
    raise AssertionError("engine chain exhausted")  # pragma: no cover


# -- plans -------------------------------------------------------------------


def engine_plan(layout: ModeLayout, factors: Sequence[torch.Tensor],
                mode: int, path: str = "sorted_onehot") -> str:
    """The engine :func:`mttkrp_blocked` will run first for this call:
    the head of its chain (the port has no lazy capability probes), or
    ``none`` on a card whose kernel engines are all demoted."""
    chain = engine_chain(layout, factors, mode, path)
    return chain[0] if chain else "none"


class Plan(NamedTuple):
    """One MTTKRP dispatch decision: where it runs (`impl`: "cuda" or
    "cpu"), the algorithm (`path`), and the engine that will run
    (`engine`).  :func:`plan_mttkrp` is the single source of it."""

    impl: str
    path: str
    engine: str


def plan_mttkrp(X: BlockedSparse, factors: Sequence[torch.Tensor],
                mode: int, path: Optional[str] = None) -> Plan:
    """The dispatch decision :func:`mttkrp` will execute for this call."""
    path = path or _choose_path_bs(X, mode)
    return Plan(X.device.type, path,
                engine_plan(X.layout_for(mode), factors, mode, path))


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


def choose_path(layout: ModeLayout, mode: int, opts: Options) -> str:
    """Path for a mode the layout may be sorted by.

    One rule on every device, so the CPU tests walk the paths the card
    runs: the kernel reduces a sorted block without the one-hot's
    redundant multiply-adds, so the sorted path is taken whenever the
    block row span fits ``onehot_cap``.  (The JAX package takes it only
    on a TPU, where a matrix unit executes those multiply-adds.)
    """
    if mode == layout.mode:
        if layout.seg_width <= opts.onehot_cap:
            return "sorted_onehot"
        return "sorted_scatter"
    return "scatter"


def _choose_path_bs(bs: BlockedSparse, mode: int) -> str:
    """As :func:`choose_path`, plus the privatized path for a short mode
    without its own layout (≙ p_is_privatized, src/mttkrp.c:221-236)."""
    layout = bs.layout_for(mode)
    dim = bs.dims[mode]
    if (mode != layout.mode and dim + 16 <= bs.opts.priv_cap
            and dim <= bs.opts.priv_threshold * max(bs.nnz, 1)):
        return "privatized"
    return choose_path(layout, mode, bs.opts)


def mttkrp(X: Union[SparseTensor, BlockedSparse],
           factors: Sequence[torch.Tensor], mode: int,
           path: Optional[str] = None,
           fallback: Optional[bool] = None) -> torch.Tensor:
    """Public MTTKRP (≙ splatt_mttkrp, include/splatt/api_kernels.h:98-119).

    A COO tensor takes the stream path on the factors' device; a
    :class:`BlockedSparse` takes :func:`_choose_path_bs`'s path unless
    `path` forces one, through :func:`mttkrp_blocked`'s engine chain.
    """
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
                          fallback=fallback)
