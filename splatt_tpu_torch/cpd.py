"""CPD-ALS (≙ src/cpd.c: splatt_cpd_als / cpd_als_iterate).

Counterpart of ``splatt_tpu/cpd.py``, single device.  One sweep updates each
mode in turn::

  M ← MTTKRP(X, U, m); U_m ← solve(⊛_{k≠m} Gram_k + ρI, M);
  (U_m, λ) ← normalize (2-norm on iteration 0, max-norm after);
  Gram_m ← U_mᵀU_m

and the fit is 1 − √(⟨X,X⟩ + ⟨Z,Z⟩ − 2⟨X,Z⟩)/√⟨X,X⟩, with ⟨Z,Z⟩ =
λᵀ(⊛ Grams)λ and ⟨X,Z⟩ from the last mode's MTTKRP.  The run stops when
the fit moves by less than the tolerance (src/cpd.c:368-370).

Under bf16 value storage the factors are bf16 (their dtype comes from the
layouts' values); the MTTKRP, the Grams, the solve and the normalization
accumulate in f32, each updated factor is cast back to bf16, and λ and the
fit stay f32 (≙ splatt_tpu/cpd.py:107-115, :601-605).

The driver is the JAX package's guarded one (≙ splatt_tpu/cpd.py:182-1011):
atomic checksummed checkpoints with a ``.bak`` generation and resume,
deferred fit checks (``Options.fit_check_every``), the numerical-health
sentinel with its rollback and degrade (``SPLATT_HEALTH_RETRIES``), a
cooperative ``stop`` hook, the sweep-level engine rescue, trace spans, and
at ``Verbosity.HIGH`` the profiled sweep, whose phase timers close on a
fence.  The sentinel's finite checks ride the fit read: one stacked
vector, one host copy per checked iteration.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import uuid
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from splatt_tpu_torch import resilience, trace
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import (Options, Verbosity, acc_dtype,
                                     default_opts, fit_dtype,
                                     resolve_device, resolve_dtype)
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.kruskal import KruskalTensor, post_process
from splatt_tpu_torch.ops.linalg import (SolverError, check_solver,
                                         form_normal_lhs, gram,
                                         normalize_columns, solve_normals)
from splatt_tpu_torch.ops.mttkrp import describe_plan, mttkrp, mttkrp_stream
from splatt_tpu_torch.utils.timers import timers


def init_factors(dims: Sequence[int], rank: int, generator: torch.Generator,
                 dtype=torch.float32, device=None) -> List[torch.Tensor]:
    """Uniform [0, 1) factors drawn mode by mode from `generator` on the
    host, so every device starts from the same numbers (≙ mat_rand).  A
    bf16 or f16 dtype draws in f32 and rounds."""
    draw = acc_dtype(dtype)
    return [torch.rand((d, rank), generator=generator,
                       dtype=draw).to(device, dtype)
            for d in dims]


def _zz_inner(lam, grams, M, U_last) -> Tuple[torch.Tensor, torch.Tensor]:
    """⟨Z,Z⟩ = λᵀ(⊛ Grams)λ and ⟨X,Z⟩ from the last mode's MTTKRP
    (p_kruskal_norm / p_tt_kruskal_inner, src/cpd.c:116-218)."""
    acc = acc_dtype(M.dtype)
    had = torch.outer(lam, lam)
    for g in grams:
        had = had * g
    inner = torch.einsum("dr,dr,r->", M.to(acc), U_last.to(acc),
                         lam.to(acc))
    return had.to(acc).sum(), inner


def _fit(xnormsq: float, znormsq: torch.Tensor,
         inner: torch.Tensor) -> torch.Tensor:
    residual = torch.sqrt(torch.clamp(xnormsq + znormsq - 2.0 * inner,
                                      min=0.0))
    return 1.0 - residual / np.sqrt(xnormsq)


def _report_tuned_plans(X: BlockedSparse, factors, opts: Options) -> None:
    """With autotune on, one ``tuned_plan`` event carrying each mode's
    plan that dispatch will apply (through dispatch's own filter,
    ``_tuned_plan_for``: a plan it rejects is never claimed), and at
    verbosity LOW a ``tuned plan:`` line (≙ splatt_tpu/cpd.py:671-701)."""
    from splatt_tpu_torch import tune
    from splatt_tpu_torch.ops.mttkrp import _choose_path_bs, _tuned_plan_for

    if not tune.autotune_enabled(opts.autotune):
        return
    plans = {}
    for m in range(X.nmodes):
        lay = X.layout_for(m)
        plan = _tuned_plan_for(lay, factors, m, _choose_path_bs(X, m),
                               autotune=opts.autotune)
        if plan is not None:
            plans[m] = dict(dataclasses.asdict(plan),
                            mode_density=getattr(lay, "density_bucket", ""))
    if not plans:
        return
    resilience.run_report().add("tuned_plan", plans=plans)
    if opts.verbosity >= Verbosity.LOW:
        print("  tuned plan: " + " ".join(
            f"mode{m}={p['path']}/{p['engine']} b{p['nnz_block']} "
            f"s{p['scan_target']} {p['idx_width']}/{p['val_storage']} "
            f"{p['packing']}/{p['reorder']}"
            for m, p in sorted(plans.items())))


def _mttkrp_closure(X, dev, dtype, fallback: bool):
    """The run's MTTKRP (≙ splatt_tpu/cpd.py:56-68): a COO tensor's
    indices and values are copied to `dev` once per run, the values in
    the compute dtype, and every sweep reads those copies."""
    if isinstance(X, SparseTensor):
        inds = torch.from_numpy(X.inds).to(dev)
        vals = torch.from_numpy(X.vals).to(dev, dtype)
        dims = X.dims

        def do_mttkrp(factors, m):
            return mttkrp_stream(inds, vals, factors, m, dims[m])
    else:
        def do_mttkrp(factors, m):
            return mttkrp(X, factors, m, fallback=fallback)
    return do_mttkrp


def _sweep(do_mttkrp, factors, grams, first: bool, reg: float):
    """One ALS sweep over every mode; assigns the new factors and Grams
    into the lists `factors` and `grams` (the tensors they held are not
    modified) and returns (λ, ⟨Z,Z⟩, ⟨X,Z⟩)."""
    nmodes = len(factors)
    lam = M = None
    for m in range(nmodes):
        M = do_mttkrp(factors, m)
        U = solve_normals(form_normal_lhs(grams, m, reg), M)
        U, lam = normalize_columns(U, "2" if first else "max")
        # back to the storage dtype; the solve ran in the f32 accumulator
        factors[m] = U.to(factors[m].dtype)
        grams[m] = gram(factors[m])
    znormsq, inner = _zz_inner(lam, grams, M, factors[nmodes - 1])
    return lam, znormsq, inner


def _profiled_sweep(do_mttkrp, factors, grams, first: bool, reg: float):
    """:func:`_sweep` with each phase in a timer bracket closed by a
    fence, so mttkrp / solve / normalize / gram / fit time is the card's
    (≙ splatt_tpu/cpd.py:182-228, the reference's TIMER_MTTKRP /
    TIMER_INV / TIMER_FIT brackets, src/cpd.c:318-352).  The fences cost
    the overlap of the fused sweep: `-v -v` only."""
    from splatt_tpu_torch.utils.env import host_fence as sync

    nmodes = len(factors)
    lam = M = None
    for m in range(nmodes):
        # per-mode timers at level 3: the CLI prints them in its own
        # per-mode block, out of the level-2 report
        timers.get(f"mttkrp_mode{m}", level=3)
        with timers.time("mttkrp"), timers.time(f"mttkrp_mode{m}"):
            M = sync(do_mttkrp(factors, m))
        with timers.time("solve"):
            U = sync(solve_normals(form_normal_lhs(grams, m, reg), M))
        with timers.time("normalize"):
            U, lam = sync(normalize_columns(U, "2" if first else "max"))
        factors[m] = U.to(factors[m].dtype)
        with timers.time("gram"):
            grams[m] = sync(gram(factors[m]))
    with timers.time("fit"):
        znormsq, inner = sync(_zz_inner(lam, grams, M, factors[nmodes - 1]))
    return lam, znormsq, inner


#: the profiled sweep's phase timers, zeroed after its warm-up
PROFILED_PHASES = ("mttkrp", "solve", "normalize", "gram", "fit")


def _make_sweep(do_mttkrp, reg: float, profiled: bool) -> Callable:
    """The sweep of one run as ``sweep(factors, grams, first) -> (factors,
    grams, λ, ⟨Z,Z⟩, ⟨X,Z⟩)``: new lists out, the caller's lists and
    tensors untouched, so the driver commits a sweep only after its
    check and a rollback restores what it held."""
    body = _profiled_sweep if profiled else _sweep

    def sweep(factors, grams, first: bool):
        factors, grams = list(factors), list(grams)
        lam, znormsq, inner = body(do_mttkrp, factors, grams, first, reg)
        return factors, grams, lam, znormsq, inner

    return sweep


def _try_engine_rescue(X, opts: Options, err: Exception) -> bool:
    """Whether a failed sweep should be rebuilt and retried
    (≙ splatt_tpu/cpd.py:231-270): demotes the engine the chain last
    handed work to (``resilience.last_engine_attempt``).  False, so the
    error propagates, when fallback is off, the input has no engine chain
    (a COO tensor), the error is a sticky CUDA error (an illegal address
    or a launch failure poisons the context: a rebuilt sweep would fail
    again), it does not look like an engine's failure (UNKNOWN: a
    LinAlgError or a shape bug must surface), it is NUMERICAL (the
    sentinel's to roll back), no engine was attempted, the attempted one
    is the terminal plain engine, or it is already demoted (nothing new
    to try).  An engine's synchronous failure is handled one level down,
    in the chain walk."""
    if not isinstance(X, BlockedSparse):
        return False
    enabled = (opts.engine_fallback if opts.engine_fallback is not None
               else resilience.fallback_enabled())
    if not enabled or resilience.sticky_cuda_error(err):
        return False
    if resilience.classify_failure(err) in (
            resilience.FailureClass.UNKNOWN,
            resilience.FailureClass.NUMERICAL):
        return False
    attempt = resilience.last_engine_attempt()
    if attempt is None:
        return False
    engine, shape_key = attempt
    if engine in ("xla", "dense_xla") or resilience.is_demoted(engine,
                                                               shape_key):
        return False
    resilience.demote_engine(engine, err, shape_key=shape_key)
    if opts.verbosity >= Verbosity.LOW:
        print(f"  engine {engine} failed at runtime "
              f"({type(err).__name__}); falling back to the next engine "
              f"in the chain")
    return True


# -- numerical-health sentinel -----------------------------------------------


def _health_pack(factors, lam, fit) -> torch.Tensor:
    """The sentinel's finite checks folded into one small tensor on the
    card, ``[fit, isfinite(U_0), ..., isfinite(U_{n-1}), isfinite(λ),
    isfinite(fit)]`` (flags 1/0 in the fit's dtype), so the check rides
    the fit read: one host copy per checked iteration
    (≙ splatt_tpu/cpd.py:280-292)."""
    fit = torch.as_tensor(fit)
    flags = [torch.isfinite(U).all() for U in factors]
    flags.append(torch.isfinite(lam).all())
    flags.append(torch.isfinite(fit))
    flags = [f.to(fit.device) for f in flags]
    return torch.cat([fit.reshape(1), torch.stack(flags).to(fit.dtype)])


def _health_verdict(vec, nmodes: int):
    """(fit, offending modes, healthy) from a fetched :func:`_health_pack`
    vector; a λ- or fit-only blowup offends no mode (the rollback then
    raises the regularization without a redraw)."""
    vec = np.asarray(vec)
    fitval = float(vec[0])
    flags = vec[1:] > 0.5
    offending = [m for m in range(nmodes) if not flags[m]]
    return fitval, offending, bool(flags.all())


def health_retries() -> int:
    """The sentinel's rollback budget: the active resilience scope's
    override when set, else SPLATT_HEALTH_RETRIES (default 3, as in the
    JAX package).  0 disables the sentinel and its snapshots."""
    from splatt_tpu_torch.utils.env import read_env_int

    scoped = resilience.scope_health_retries()
    if scoped is not None:
        return int(scoped)
    return int(read_env_int("SPLATT_HEALTH_RETRIES"))


def _redraw(shape, dtype, device, seed: int, attempt: int, mode: int):
    """A rollback's fresh draw of one offending factor: uniform [0, 1)
    from a torch generator seeded by the run's seed + 7919 with
    ``attempt * 64 + mode`` folded in (the JAX package folds the same
    numbers into a jax.random key, which torch cannot reproduce)."""
    gen = torch.Generator().manual_seed(
        ((seed + 7919) * 1_000_003 + attempt * 64 + mode) % (1 << 63))
    return torch.rand(shape, generator=gen,
                      dtype=acc_dtype(dtype)).to(device, dtype)


# -- checkpoints ---------------------------------------------------------------

#: checkpoint schema: v2 adds `schema` and a sha256 `checksum` over every
#: payload field, so a torn or corrupt file is detected at load
_CKPT_SCHEMA = 2


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable, truncated, or fails its checksum;
    a dims/rank mismatch is a caller's error and stays a ValueError."""


def _checkpoint_digest(payload: dict) -> str:
    """sha256 over every payload field in sorted-key order, covering
    dtype, shape and bytes (≙ splatt_tpu/cpd.py:337-349)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(payload):
        a = np.asarray(payload[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _host_array(t) -> np.ndarray:
    """A factor or λ as a host numpy array; bf16 goes to f32, which holds
    it exactly (numpy has no bfloat16)."""
    if torch.is_tensor(t):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _save_checkpoint(path: str, factors, lam, it: int, fit: float,
                     reorder: str = "identity",
                     fence: Optional[Callable[[], bool]] = None
                     ) -> Optional[dict]:
    """Atomic checksummed ``.npz`` checkpoint (≙ splatt_tpu/cpd.py:352-395):
    the same fields, dtypes and digest as the JAX package's, so either
    package loads the other's files.  The previous generation is kept as
    ``<path>.bak``.  `reorder` stamps the row-label space of the factors
    (a reordered run checkpoints relabeled factors).  Returns the
    seconds of its parts (``copy_s`` to the host, ``sha_s``, ``write_s``
    for ``np.savez``, ``publish_s`` for the fsync and renames).

    `fence`, when given, is called once the file is written and synced,
    just before the renames: a False (a fleet replica's lease renewal
    refused) removes the temporary file and returns None, so a writer
    that lost its lease during the write publishes nothing."""
    from splatt_tpu_torch.utils import faults
    from splatt_tpu_torch.utils.durable import publish_file

    with trace.span("cpd.checkpoint", path=path, it=int(it)):
        faults.maybe_fail("checkpoint_write")
        t0 = time.perf_counter()
        # a name of this writer's own: a stalled owner and its adopter
        # may write one job's checkpoint at once
        tmp = f"{path}.~{uuid.uuid4().hex[:12]}.tmp.npz"
        payload = {f"factor{m}": _host_array(U)
                   for m, U in enumerate(factors)}
        payload.update(nmodes=len(factors), it=int(it), fit=float(fit),
                       lam=_host_array(lam),
                       dims=np.asarray([U.shape[0] for U in factors]),
                       rank=int(factors[0].shape[1]))
        t1 = time.perf_counter()
        digest = _checkpoint_digest(payload)
        t2 = time.perf_counter()
        np.savez(tmp, schema=_CKPT_SCHEMA, checksum=digest,
                 reorder=np.str_(reorder), **payload)
        if faults.consume("checkpoint_torn"):
            # injected torn write: drop the tail of the bytes just
            # written, as a crashed writer or dying mount would
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as f:
                f.truncate(max(size // 2, 1))
        t3 = time.perf_counter()
        if fence is not None:
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            if not fence():
                os.unlink(tmp)
                return None
        if os.path.exists(path):
            os.replace(path, path + ".bak")
        publish_file(tmp, path)
        t4 = time.perf_counter()
    return {"copy_s": t1 - t0, "sha_s": t2 - t1, "write_s": t3 - t2,
            "publish_s": t4 - t3}


def load_checkpoint(path: str, verify: bool = True,
                    expect_reorder: Optional[str] = None):
    """Load a checkpoint → (factors, λ, it, fit), the factors and λ as CPU
    tensors (≙ splatt_tpu/cpd.py:398-448).  Schema-v2 files are
    checksum-verified (`verify=False` skips); v1 files still load.  An
    unreadable, truncated or checksum-failing file, or one stamped with
    another reorder than `expect_reorder` (files without the stamp count
    as "identity"), raises :class:`CheckpointError`."""
    try:
        with np.load(path) as z:
            nmodes = int(z["nmodes"])
            factors_np = [np.asarray(z[f"factor{m}"])
                          for m in range(nmodes)]
            lam = np.asarray(z["lam"])
            it = int(z["it"])
            fit = float(z["fit"])
            dims = np.asarray(z["dims"])
            rank = int(z["rank"])
            stored = str(z["checksum"]) if "checksum" in z.files else None
            ck_reorder = (str(z["reorder"]) if "reorder" in z.files
                          else "identity")
        if expect_reorder is not None and ck_reorder != expect_reorder:
            raise CheckpointError(
                f"checkpoint {path} stores factors in "
                f"reorder={ck_reorder!r} row space but this run "
                f"resolved reorder={expect_reorder!r}; resuming would "
                f"mix row labelings (pass resume=False to overwrite)")
        if verify and stored is not None:
            payload = {f"factor{m}": factors_np[m] for m in range(nmodes)}
            payload.update(nmodes=nmodes, it=it, fit=fit, lam=lam,
                           dims=dims, rank=rank)
            if _checkpoint_digest(payload) != stored:
                raise CheckpointError(
                    f"checkpoint {path} failed its integrity checksum "
                    f"(torn write or on-disk corruption)")
        return ([torch.from_numpy(f) for f in factors_np],
                torch.from_numpy(lam), it, fit)
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path} is unreadable "
            f"({type(e).__name__}: {e})") from e


def load_checkpoint_resilient(path: str,
                              expect_reorder: Optional[str] = None):
    """The resume path's load (≙ splatt_tpu/cpd.py:451-487): `path`, else
    its ``.bak`` generation, else None (start fresh).  Each recovery is a
    ``checkpoint_recovery`` event and a line on stderr."""
    try:
        return load_checkpoint(path, expect_reorder=expect_reorder)
    except CheckpointError as e:
        first_err = str(e)
    bak = path + ".bak"
    if os.path.exists(bak):
        try:
            out = load_checkpoint(bak, expect_reorder=expect_reorder)
            resilience.run_report().add(
                "checkpoint_recovery", path=path, error=first_err,
                action=f"resumed from previous generation {bak}")
            print(f"splatt-tpu: WARNING: {first_err}; resumed from the "
                  f"previous generation {bak}", file=sys.stderr, flush=True)
            return out
        except CheckpointError as e2:
            first_err = f"{first_err}; .bak also unusable ({e2})"
    resilience.run_report().add(
        "checkpoint_recovery", path=path, error=first_err,
        action="no usable generation; starting fresh")
    print(f"splatt-tpu: WARNING: {first_err}; no usable checkpoint "
          f"generation — starting from scratch", file=sys.stderr, flush=True)
    return None


def factor_content_sha(factors, lam) -> str:
    """Content sha over the factor matrices and λ alone, the identity a
    model-generation stamp records (≙ splatt_tpu/cpd.py:490-500).
    Narrower than the checkpoint checksum: two commits of bit-identical
    factors get the same sha whatever their iteration count or fit,
    which makes a re-commit idempotent at the generation fence.  Factors
    go through :func:`_host_array`, so f32 and f64 factors hash the bytes
    the JAX package hashes; bf16 ones are widened to f32 first (numpy has
    no bfloat16), so a bf16 model's sha is the port's own."""
    payload = {f"factor{m}": _host_array(U) for m, U in enumerate(factors)}
    payload["lam"] = _host_array(lam)
    return _checkpoint_digest(payload)


def load_checkpoint_resilient_gen(path: str, stamp: Optional[dict],
                                  bak_stamp: Optional[dict] = None,
                                  expect_reorder: Optional[str] = None):
    """The generation-fenced load (≙ splatt_tpu/cpd.py:503-546): the
    newest checkpoint generation whose factor content verifies against a
    generation stamp, or None.

    `stamp` / `bak_stamp` are the parsed current and previous stamps
    (``{"gen": int, "sha": str}``, read by predict.py).  The pairs are
    tried newest first: (path, stamp), then (path.bak, stamp) for a
    commit that advanced the checkpoint but died before the stamp, then
    (path.bak, bak_stamp); each torn or mismatched pair is a classified
    ``model_torn`` event.  Returns ``(factors, lam, it, fit, gen, sha)``
    for the first intact pair (the factors and λ as CPU tensors, as
    :func:`load_checkpoint` gives them), or None when nothing verifies:
    a reader refuses rather than serve stale or torn factors."""
    candidates = []
    if stamp is not None:
        candidates.append((path, stamp))
        candidates.append((path + ".bak", stamp))
    if bak_stamp is not None:
        candidates.append((path + ".bak", bak_stamp))
    for cpath, cstamp in candidates:
        want = str(cstamp.get("sha") or "")
        try:
            gen = int(cstamp["gen"])
        except (KeyError, TypeError, ValueError):
            continue
        if not want or not os.path.exists(cpath):
            continue
        try:
            factors, lam, it, fit = load_checkpoint(
                cpath, expect_reorder=expect_reorder)
            got = factor_content_sha(factors, lam)
            if got != want:
                raise CheckpointError(
                    f"checkpoint {cpath} factor content {got[:12]} does "
                    f"not match generation {gen} stamp {want[:12]} "
                    f"(torn commit or stale stamp)")
            return factors, lam, it, fit, gen, want
        except CheckpointError as e:
            resilience.run_report().add(
                "model_torn", path=cpath, piece="checkpoint-vs-stamp",
                gen=gen,
                failure_class=resilience.classify_failure(e).value,
                error=str(e)[:200])
    return None


def cpd_als(X: Union[SparseTensor, BlockedSparse], rank: int,
            opts: Optional[Options] = None, init=None,
            device=None, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 10, resume: bool = True,
            stop: Optional[Callable[[], bool]] = None,
            checkpoint_fence: Optional[Callable[[], bool]] = None
            ) -> KruskalTensor:
    """Rank-`rank` CPD of X (≙ splatt_cpd_als, src/cpd.c:22-63).

    `X` is a :class:`BlockedSparse` (moved to `device` if it lies
    elsewhere) or a COO tensor, which takes the stream MTTKRP.  `init`
    is a list of numpy arrays or tensors; without it the factors come
    from a generator seeded by ``opts.random_seed``.  `device` defaults
    to the card and raises where there is none.  ``opts.engine_fallback``
    (else SPLATT_ENGINE_FALLBACK) decides whether a failing MTTKRP engine
    is demoted for the next one in its chain or the error propagates.

    A reordered :class:`BlockedSparse` (``X.perm``, from
    :meth:`BlockedSparse.compile`) computes in the relabeled row space:
    `init`, in the original labels, moves in through the permutation,
    and the output factors move back out (≙ splatt_tpu/cpd.py:612-617,
    :1003-1010), so the caller sees the original row order.  A seeded
    init is drawn in the original labels too (the JAX package draws it
    in the relabeled ones), so one seed gives one CPD whatever the
    reorder.  Checkpoints hold the relabeled factors, stamped with the
    reorder.

    With `checkpoint_path` the factors are written atomically every
    `checkpoint_every` iterations (:func:`_save_checkpoint`), and an
    existing checkpoint (or only its ``.bak``) is resumed from unless
    `resume` is False.  `stop` is polled at check iterations: when it
    returns True the run checkpoints what it just committed and returns.
    `checkpoint_fence`, when given, is called after every checkpoint is
    written and before it is published (:func:`_save_checkpoint`'s
    `fence`), and a False skips the publish: a fleet replica whose job
    lease was lost must not overwrite its adopter's checkpoint.
    ``opts.fit_check_every`` = k reads the fit (one host sync) every k
    iterations, at the last and wherever a checkpoint is due; the
    tolerance scales with the iterations since the last check.  The
    result's ``fits``, ``iter_seconds`` and ``fit_iters`` hold the
    checked iterations.  ``opts.trace`` pins span recording for the run.
    """
    opts = (opts or default_opts()).validate()
    with trace.enabling(opts.trace):
        with trace.span("cpd.als", rank=int(rank),
                        max_iterations=int(opts.max_iterations)):
            return _cpd_als_traced(X, rank, opts, init, device,
                                   checkpoint_path, checkpoint_every,
                                   resume, stop, checkpoint_fence)


def _cpd_als_traced(X, rank: int, opts: Options, init, device,
                    checkpoint_path, checkpoint_every: int, resume: bool,
                    stop, checkpoint_fence=None) -> KruskalTensor:
    """:func:`cpd_als` inside its ``cpd.als`` root span
    (≙ splatt_tpu/cpd.py:592-1011)."""
    from splatt_tpu_torch.utils import faults

    def save_checkpoint(*args, **kw) -> None:
        _save_checkpoint(*args, fence=checkpoint_fence, **kw)

    dev = resolve_device(device)
    if isinstance(X, SparseTensor):
        xnormsq = X.normsq()
        dtype = resolve_dtype(opts)
    else:
        if X.device != dev:
            X = X.to(dev)
        xnormsq = X.frobsq()
        dtype = X.layouts[0].vals.dtype
    dims, nmodes = tuple(X.dims), len(X.dims)
    perm = getattr(X, "perm", None)
    reorder_label = (getattr(X, "reorder", "identity")
                     if perm is not None else "identity")
    if perm is not None and init is not None:
        init = [perm.permute_factor(U, m) for m, U in enumerate(init)]

    start_it = 0
    ck_lam = None
    ck_fit = 0.0
    if checkpoint_path is not None and checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if checkpoint_path is not None and resume and (
            os.path.exists(checkpoint_path)
            or os.path.exists(checkpoint_path + ".bak")):
        # .bak alone counts: a crash between the writer's two renames can
        # leave only the previous generation
        loaded = load_checkpoint_resilient(checkpoint_path,
                                           expect_reorder=reorder_label)
        if loaded is not None:
            ck_factors, ck_lam, start_it, ck_fit = loaded
            ck_dims = tuple(int(U.shape[0]) for U in ck_factors)
            ck_rank = int(ck_factors[0].shape[1])
            if ck_dims != dims or ck_rank != rank:
                raise ValueError(
                    f"checkpoint {checkpoint_path} is for "
                    f"dims={ck_dims} rank={ck_rank}, not "
                    f"dims={dims} rank={rank}; "
                    f"pass resume=False to overwrite it")
            # already in the run's (relabeled) row space
            init = ck_factors
            if opts.verbosity >= Verbosity.LOW:
                print(f"  resuming from {checkpoint_path} "
                      f"(iteration {start_it})")
    if init is not None:
        factors = [torch.as_tensor(f).to(dev, dtype).clone() for f in init]
    else:
        gen = torch.Generator().manual_seed(opts.seed())
        factors = init_factors(dims, rank, gen, dtype=dtype, device=dev)
        if perm is not None:
            # drawn in the original labels, so a seed gives one CPD
            # whatever the reorder
            factors = [perm.permute_factor(U, m)
                       for m, U in enumerate(factors)]
    grams = [gram(U) for U in factors]
    fallback = (resilience.fallback_enabled()
                if opts.engine_fallback is None else opts.engine_fallback)
    do_mttkrp = _mttkrp_closure(X, dev, dtype, fallback)
    if opts.verbosity >= Verbosity.LOW:
        if isinstance(X, BlockedSparse):
            print(f"  {describe_plan(X, factors)}")
        else:
            print(f"  engine plan: impl={dev.type} mode*=stream "
                  f"(COO oracle)")
    if isinstance(X, BlockedSparse):
        _report_tuned_plans(X, factors, opts)

    # -v -v: the profiled sweep, each phase fenced into its timer
    profiled = opts.verbosity >= Verbosity.HIGH

    def build_sweep(reg=opts.regularization):
        # a factory: rebuilt after an engine demotion or a rollback's
        # regularization bump
        with trace.span("cpd.build_sweep", regularization=float(reg),
                        profiled=profiled):
            return _make_sweep(do_mttkrp, reg, profiled)

    sweep = build_sweep()
    if profiled:
        # warm both normalizations on the committed state (the sweep
        # leaves it untouched), then zero the phase timers: the report
        # shows steady-state cost, not the first launches
        for first in (True, False):
            sweep(factors, grams, first)
        for name in (*PROFILED_PHASES,
                     *(f"mttkrp_mode{m}" for m in range(nmodes))):
            timers.get(name).reset()

    fit_dt = torch.promote_types(dtype, fit_dtype())
    # resuming past max_iterations runs no sweep: the checkpointed λ
    # and fit are the result
    fit_prev = ck_fit
    lam = (ck_lam.to(dev, fit_dt) if ck_lam is not None
           else torch.ones(rank, dtype=fit_dt, device=dev))
    # the sentinel's rollback target: references to the last verified
    # state.  The sweep never modifies its inputs and the port donates
    # no buffer, so holding the tensors is the snapshot (never a copy)
    guard = health_retries()
    snap = None

    def snapshot():
        with trace.span("cpd.guard.snapshot", host_copy=False):
            return (list(factors), list(grams), lam)

    if guard > 0:
        snap = snapshot()
    timers.start("cpd")
    k = opts.fit_check_every
    last_check_it = start_it
    health_attempts = 0
    degraded = False
    fits: List[float] = []
    seconds: List[float] = []
    fit_iters: List[int] = []
    for it in range(start_it, opts.max_iterations):
        t0 = time.perf_counter()
        # one span per iteration, sweep dispatch through the commit
        it_span = trace.begin("cpd.iter", it=it + 1)
        try:
            # the fit comes to the host only at check iterations; a due
            # checkpoint forces a check
            checkpoint_due = (checkpoint_path is not None
                              and (it + 1) % checkpoint_every == 0)
            check = ((it + 1) % k == 0 or it + 1 == opts.max_iterations
                     or checkpoint_due)
            rescue_attempts = 0
            while True:
                try:
                    # host-side enqueue; the card's work drains into the
                    # fit check
                    with trace.span("cpd.sweep"):
                        f_new, g_new, lam_new, znormsq, inner = sweep(
                            factors, grams, it == 0)
                    # chaos hook: poison the LAST factor, which every
                    # next-sweep MTTKRP reads
                    f_new[-1] = faults.poison("cpd.sweep", f_new[-1])
                    fit = _fit(xnormsq, znormsq, inner)
                    if check and guard > 0:
                        # the finite checks ride the fit read: one host
                        # copy of one stacked vector
                        with trace.span("cpd.fit_check", it=it + 1):
                            with trace.span("cpd.guard.health_pack"):
                                packed = _health_pack(
                                    f_new, lam_new, fit).cpu().numpy()
                        fitval, offending, healthy = _health_verdict(
                            packed, nmodes)
                        if not healthy:
                            err = resilience.NumericalHealthError(
                                f"non-finite sweep outputs at iteration "
                                f"{it + 1} (factor modes "
                                f"{offending or 'none'}; λ/fit "
                                f"{'finite' if offending else 'non-finite'})")
                            err.offending = offending
                            raise err
                    elif check:
                        # one host copy of a one-element vector, as the
                        # guarded read copies its packed vector
                        with trace.span("cpd.fit_check", it=it + 1):
                            fitval = float(fit.reshape(1).cpu()[0])
                    else:
                        fitval = None
                    if check:
                        # the eigensolver's status word, after the fit read
                        check_solver()
                    break
                except resilience.NumericalHealthError as e:
                    health_attempts += 1
                    offending = getattr(e, "offending", [])
                    try:
                        # the Jacobi sweeps may not converge on the
                        # discarded sweep's non-finite Grams
                        check_solver()
                    except SolverError:
                        pass
                    resilience.run_report().add(
                        "health_nonfinite", iteration=it + 1,
                        modes=offending,
                        error=resilience.failure_message(e)[:200])
                    if health_attempts > guard:
                        degraded = True
                        break
                    # rollback: the last-good state, a raised
                    # regularization and the offending factors redrawn,
                    # on a rebuilt sweep
                    with trace.span("cpd.guard.rollback", it=it + 1,
                                    attempt=health_attempts):
                        factors, grams, lam = (list(snap[0]),
                                               list(snap[1]), snap[2])
                        reg = ((opts.regularization
                                if opts.regularization > 0 else 1e-6)
                               * (10.0 ** health_attempts))
                        for m in offending:
                            factors[m] = _redraw(
                                factors[m].shape, factors[m].dtype, dev,
                                opts.seed(), health_attempts, m)
                            grams[m] = gram(factors[m])
                    resilience.run_report().add(
                        "health_rollback", iteration=it + 1,
                        attempt=health_attempts, regularization=reg,
                        rerandomized=offending)
                    if opts.verbosity >= Verbosity.LOW:
                        print(f"  non-finite sweep outputs at iteration "
                              f"{it + 1}; rolled back to the last-good "
                              f"snapshot (attempt {health_attempts}/"
                              f"{guard}: reg={reg:g}, re-randomized modes "
                              f"{offending})")
                    sweep = build_sweep(reg)
                except Exception as e:
                    # a failure that escaped the chain walk (one that
                    # surfaced at the fit read): demote the engine last
                    # attempted and retry this iteration from the
                    # committed state, which the failed sweep left alone
                    rescue_attempts += 1
                    if (rescue_attempts > 6
                            or not _try_engine_rescue(X, opts, e)):
                        raise
                    sweep = build_sweep()
            if degraded:
                factors, grams, lam = list(snap[0]), list(snap[1]), snap[2]
                action = "stopped early with the last-good factors"
                if checkpoint_path is not None:
                    # the snapshot is the LAST HEALTHY check: a resume
                    # redoes the rolled-back window
                    save_checkpoint(checkpoint_path, factors, lam,
                                     last_check_it, fit_prev,
                                     reorder=reorder_label)
                    action += f"; checkpointed to {checkpoint_path}"
                resilience.run_report().add(
                    "health_degraded", iteration=it + 1, action=action)
                if opts.verbosity >= Verbosity.LOW:
                    print(f"  health-retry budget ({guard}) exhausted at "
                          f"iteration {it + 1}; {action}")
                break
            factors, grams, lam = f_new, g_new, lam_new
            if not check:
                if opts.verbosity >= Verbosity.HIGH:
                    print(f"  its = {it + 1:3d} (deferred fit check)")
                continue
            it_span.set(fit=fitval)
            elapsed = time.perf_counter() - t0
            fits.append(fitval)
            seconds.append(elapsed)
            fit_iters.append(it + 1)
            if guard > 0:
                # the rollback target moves only after a verified check
                snap = snapshot()
            if opts.verbosity >= Verbosity.LOW:
                print(f"  its = {it + 1:3d} ({elapsed:.3f}s)"
                      f"  fit = {fitval:0.5f}"
                      f"  delta = {fitval - fit_prev:+0.4e}")
            if checkpoint_due:
                save_checkpoint(checkpoint_path, factors, lam, it + 1,
                                 fitval, reorder=reorder_label)
            if stop is not None and stop():
                # cooperative interruption: the committed state is
                # checkpointed, so a resume redoes nothing
                if checkpoint_path is not None and not checkpoint_due:
                    save_checkpoint(checkpoint_path, factors, lam,
                                     it + 1, fitval, reorder=reorder_label)
                fit_prev = fitval
                break
            # the tolerance scales with the iterations since the last
            # check (≙ the k = 1 test, src/cpd.c:368-370)
            window = (it + 1) - last_check_it
            last_check_it = it + 1
            if it > 0 and abs(fitval - fit_prev) < opts.tolerance * window:
                fit_prev = fitval
                break
            fit_prev = fitval
        finally:
            trace.end(it_span)
    timers.stop("cpd")

    out = post_process(factors, lam, fit_prev, fits, seconds, fit_iters)
    if perm is not None:
        out.factors = perm.undo_factors(out.factors)
    return out


# -- the batched CPD (docs/batched.md) -----------------------------------------
#
# K small same-regime tensors decomposed as one stacked sweep
# (≙ splatt_tpu/cpd.py:1025-1397).  Each slot keeps its own init seed, fit
# trajectory, convergence stop and health verdict, as data on the batch
# axis: one sweep closure, one launch of each kernel per mode, one host
# read per checked iteration for all of them.


@dataclasses.dataclass
class BatchedCPD:
    """Per-slot results and the batch's evidence (≙ splatt_tpu.cpd.
    BatchedCPD): ``compiles`` counts builds of the one sweep closure (1,
    rollbacks included), ``rollbacks`` each slot's health rollbacks."""

    results: List[KruskalTensor]
    statuses: List[str]            # "converged" | "degraded" per slot
    fits: List[float]
    iterations: int
    compiles: int
    rollbacks: List[int]
    stopped: bool = False          # the stop hook interrupted the run

    @property
    def k(self) -> int:
        return len(self.results)


def _health_pack_batched(fit, capped, factors=None, lam=None
                         ) -> torch.Tensor:
    """The batch's check read as one ``(K, 2)`` or ``(K, nmodes + 4)``
    tensor, one host copy: each slot's fit, whether its eigensolver hit
    the sweep cap, then, with `factors` and `lam` (the sentinel on), its
    finite flags, one per factor, then λ, then the fit (≙ splatt_tpu/
    cpd.py:1056-1066).  One slot's NaN trips only its own row."""
    cols = [fit, capped.to(fit.dtype)]
    if factors is not None:
        cols += [torch.isfinite(U).flatten(1).all(dim=1).to(fit.dtype)
                 for U in factors]
        cols.append(torch.isfinite(lam).all(dim=1).to(fit.dtype))
        cols.append(torch.isfinite(fit).to(fit.dtype))
    return torch.stack(cols, dim=1)


def _zz_inner_batched(lam, grams, M, U_last):
    """:func:`_zz_inner` of each slot: ``(K,)`` ⟨Z,Z⟩ and ⟨X,Z⟩."""
    acc = acc_dtype(M.dtype)
    had = lam[:, :, None] * lam[:, None, :]
    for g in grams:
        had = had * g
    inner = torch.einsum("kdr,kdr,kr->k", M.to(acc), U_last.to(acc),
                         lam.to(acc))
    return had.to(acc).sum(dim=(1, 2)), inner


def _make_batched_sweep(bb, rank: int, xnormsq, counter: dict) -> Callable:
    """The one sweep of a batch (≙ splatt_tpu/cpd.py:1069-1151), as
    ``sweep(factors, grams, λ, reg, active, first) -> (factors, grams, λ,
    fit, capped)`` over stacked ``(K, ...)`` tensors; new lists out, the
    inputs untouched.  Each mode: the batched stream MTTKRP, the batched
    normal equations plus each slot's ``reg``, one batched solve (one
    :func:`~splatt_tpu_torch.ops.linalg.sym_eig` launch for every slot on
    a card), the norm (`first` picks the 2-norm), the Gram.  A frozen
    slot (``active`` False) is re-selected with ``torch.where``, bit for
    bit; ``capped`` flags the live slots whose eigensolver hit its cap.
    Nothing waits on the host.  ``counter["builds"]`` counts the builds."""
    from splatt_tpu_torch.ops.mttkrp import mttkrp_batched_stream

    counter["builds"] += 1
    nmodes, dims = bb.nmodes, bb.dims
    inds, vals = bb.inds, bb.vals
    dev = vals.device
    fdt = fit_dtype()
    xn_sq = torch.tensor(np.asarray(xnormsq, dtype=np.float64), dtype=fdt,
                         device=dev)
    xn = torch.tensor(np.sqrt(np.maximum(xnormsq, 1e-300)), dtype=fdt,
                      device=dev)
    # the Grams' dtype: the accumulator of the factors' (storage) dtype
    eye = torch.eye(rank, dtype=acc_dtype(vals.dtype), device=dev)

    def sweep(factors, grams, lam, reg, active, first: bool):
        factors, grams = list(factors), list(grams)
        keep2, keep3 = active[:, None], active[:, None, None]
        capped = torch.zeros_like(active)
        M = None
        for m in range(nmodes):
            M = mttkrp_batched_stream(inds, vals, factors, m, dims[m])
            lhs = (form_normal_lhs(grams, m)
                   + reg.to(eye.dtype)[:, None, None] * eye)
            U, cap = solve_normals(lhs, M, return_capped=True)
            capped = capped | cap
            U, lam_m = normalize_columns(U, "2" if first else "max")
            U = U.to(factors[m].dtype)
            factors[m] = torch.where(keep3, U, factors[m])
            grams[m] = torch.where(keep3, gram(factors[m]), grams[m])
            lam = torch.where(keep2, lam_m.to(lam.dtype), lam)
        # a frozen slot recomputes the same M from its frozen factors, so
        # its fit is its committed one
        znormsq, inner = _zz_inner_batched(lam, grams, M, factors[-1])
        fit = 1.0 - torch.sqrt(torch.clamp(
            xn_sq + znormsq.to(fdt) - 2.0 * inner.to(fdt), min=0.0)) / xn
        return factors, grams, lam, fit, capped & active

    return sweep


def _host_to(a: np.ndarray, dtype, dev) -> torch.Tensor:
    """A small host array on `dev` with no host sync: through pinned
    memory on a card (a pageable copy would wait)."""
    t = torch.from_numpy(np.array(a)).to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def cpd_als_batched(tensors, rank: int, opts: Optional[Options] = None,
                    seeds: Optional[List[int]] = None, inits=None,
                    stop: Optional[Callable[[], bool]] = None,
                    device=None) -> BatchedCPD:
    """Decompose K same-regime tensors as one stacked ALS
    (≙ splatt_tpu.cpd.cpd_als_batched, docs/batched.md).

    `tensors` is a list of COO tensors, stacked here by
    :func:`~splatt_tpu_torch.blocked.batch_compile`, or a built
    :class:`~splatt_tpu_torch.blocked.BatchedBlocked`; either runs on
    `device` (the card unless the caller names another).  `seeds` gives
    each slot its init seed (default ``opts.seed() + slot``): slot i
    starts where :func:`cpd_als` with ``random_seed=seeds[i]`` starts.
    `inits` gives per-slot factor lists at each slot's true dims instead
    (numpy arrays or tensors).  `stop` is polled at check iterations.

    Per slot: fits, convergence stops (a converged slot is frozen, bit
    for bit, while its neighbours iterate) and results are its own.  The
    health sentinel runs per slot: a non-finite slot rolls back alone to
    its last-good state, with its regularization raised and its offending
    factors redrawn from its seed, and an exhausted budget degrades only
    that slot (status "degraded").  A finite slot whose eigensolver hit
    its sweep cap raises :class:`SolverError` naming it.  ``compiles``
    counts builds of the sweep closure: 1, rollbacks included."""
    from splatt_tpu_torch.blocked import BatchedBlocked, batch_compile

    opts = (opts or default_opts()).validate()
    with trace.enabling(opts.trace):
        k = (tensors.k if isinstance(tensors, BatchedBlocked)
             else len(tensors))
        with trace.span("cpd.batch", rank=int(rank), k=k,
                        max_iterations=int(opts.max_iterations)):
            if isinstance(tensors, BatchedBlocked):
                dev = resolve_device(device)
                bb = tensors if tensors.device == dev else tensors.to(dev)
            else:
                bb = batch_compile(list(tensors), opts, rank=rank,
                                   device=device)
            return _cpd_als_batched_traced(bb, rank, opts, seeds, inits,
                                           stop)


def _initial_batch(bb, rank: int, seeds, inits) -> List[torch.Tensor]:
    """The stacked initial factors, each slot at its true dims and zero in
    the bucket rows (zero rows stay zero through every sweep: a zero
    MTTKRP row solves to a zero row and adds nothing to the Gram)."""
    dtype = bb.vals.dtype
    stage = acc_dtype(dtype)
    factors = [torch.zeros((bb.k, d, rank), dtype=dtype) for d in bb.dims]
    for i, dims in enumerate(bb.slot_dims):
        if inits is None:
            gen = torch.Generator().manual_seed(int(seeds[i]))
            slot = init_factors(dims, rank, gen, dtype=dtype)
        else:
            slot = []
            for m, d in enumerate(dims):
                U = torch.as_tensor(inits[i][m])
                if tuple(U.shape) != (d, rank):
                    raise ValueError(
                        f"init for slot {i} mode {m} has shape "
                        f"{tuple(U.shape)}, want {(d, rank)}")
                slot.append(U.to("cpu", stage).to(dtype))
        for m, U in enumerate(slot):
            factors[m][i, :dims[m]] = U
    return [F.to(bb.device) for F in factors]


def _cpd_als_batched_traced(bb, rank: int, opts: Options, seeds, inits,
                            stop) -> BatchedCPD:
    """:func:`cpd_als_batched` inside its ``cpd.batch`` span
    (≙ splatt_tpu/cpd.py:1203-1397)."""
    from splatt_tpu_torch.kruskal import unstack_batched
    from splatt_tpu_torch.ops.linalg import (SYM_EIG_MAX_SWEEPS,
                                             clear_solver_status)
    from splatt_tpu_torch.utils import faults

    K, nmodes, dev = bb.k, bb.nmodes, bb.device
    fdt = fit_dtype()
    if seeds is None:
        base = opts.seed()
        seeds = [base + i for i in range(K)]
    if len(seeds) != K or (inits is not None and len(inits) != K):
        raise ValueError(f"need one seed/init per slot (k={K})")
    factors = _initial_batch(bb, rank, seeds, inits)
    grams = [gram(F) for F in factors]
    lam = torch.ones((K, rank), dtype=fdt, device=dev)

    counter = {"builds": 0}
    sweep = _make_batched_sweep(bb, rank, bb.slot_frobsq(), counter)
    guard = health_retries()
    reg = np.full(K, float(opts.regularization), dtype=np.float32)
    active = np.ones(K, dtype=bool)
    reg_dev, active_dev = _host_to(reg, fdt, dev), _host_to(active,
                                                            torch.bool, dev)
    degraded = np.zeros(K, dtype=bool)
    attempts = np.zeros(K, dtype=np.int64)
    fit_prev = np.zeros(K, dtype=np.float64)
    fits = np.zeros(K, dtype=np.float64)
    last_check_it = 0
    stopped = False
    # the last-good state of each slot lives on the device: the sweep
    # never modifies its inputs, so the snapshot holds references, and a
    # check moves only its healthy slots' lanes into it
    snap = (list(factors), list(grams), lam) if guard > 0 else None

    def restore_slot(i: int) -> None:
        nonlocal lam
        for m in range(nmodes):
            factors[m] = factors[m].clone()
            factors[m][i] = snap[0][m][i]
            grams[m] = grams[m].clone()
            grams[m][i] = snap[1][m][i]
        lam = lam.clone()
        lam[i] = snap[2][i]

    kchk = opts.fit_check_every
    # each slot's cap flags ORed over the sweeps since the last check (an
    # unchecked sweep's cap is read with the next check's pack)
    capped_acc = None
    it = -1
    for it in range(opts.max_iterations):
        if not active.any():
            break
        it_span = trace.begin("cpd.batch.sweep", it=it + 1)
        try:
            f_new, g_new, lam_new, fit_dev, capped_dev = sweep(
                factors, grams, lam, reg_dev, active_dev, it == 0)
            capped_acc = (capped_dev if capped_acc is None
                          else capped_acc | capped_dev)
            # chaos hook: a poison-armed cpd.batch.sweep fault corrupts
            # slot 0's last factor while the slot is live (a frozen
            # slot's lanes are no longer the sweep's to corrupt)
            if active[0]:
                p = faults.poison("cpd.batch.sweep", 1.0)
                if not np.isfinite(p):
                    f_new[-1] = f_new[-1].clone()
                    f_new[-1][:1] = f_new[-1][:1] * p
            factors, grams, lam = list(f_new), list(g_new), lam_new
            if not ((it + 1) % kchk == 0 or it + 1 == opts.max_iterations):
                continue
            # the fit, the cap flags and the sentinel's flags: one copy
            with trace.span("cpd.fit_check", it=it + 1):
                with trace.span("cpd.guard.health_pack"):
                    pack = _health_pack_batched(
                        fit_dev, capped_acc,
                        *((factors, lam) if guard > 0 else ())
                    ).cpu().numpy().astype(np.float64)
            capped_acc = None
            fitv = pack[:, 0]
            # with the sentinel off every live slot counts as healthy and
            # a NaN flows into its own result (guards are free when off)
            flags = pack[:, 2:] if guard > 0 else np.ones((K, nmodes + 2))
            finite = (flags.min(axis=1) > 0.5 if guard > 0
                      else np.isfinite(fitv))
            # each slot's cap flags since the last check decide, not the
            # process's word; a slot whose outputs are non-finite is the
            # sentinel's
            clear_solver_status()
            bad = np.flatnonzero(active & (pack[:, 1] > 0.5) & finite)
            if bad.size:
                raise SolverError(
                    f"sym_eig: batch slot {int(bad[0])} did not converge "
                    f"within {SYM_EIG_MAX_SWEEPS} sweeps")
            if guard > 0:
                for i in np.flatnonzero(active):
                    if flags[i].min() > 0.5:
                        continue
                    offending = [m for m in range(nmodes)
                                 if flags[i][m] <= 0.5]
                    attempts[i] += 1
                    resilience.run_report().add(
                        "health_nonfinite", iteration=it + 1, slot=int(i),
                        modes=offending,
                        error="non-finite batched sweep outputs")
                    if attempts[i] > guard:
                        degraded[i] = True
                        active[i] = False
                        restore_slot(int(i))
                        fits[i] = fit_prev[i]
                        resilience.run_report().add(
                            "health_degraded", iteration=it + 1,
                            slot=int(i),
                            action="slot frozen at its last-good "
                                   "snapshot; batch neighbors continue")
                        continue
                    with trace.span("cpd.guard.rollback", it=it + 1,
                                    slot=int(i), attempt=int(attempts[i])):
                        restore_slot(int(i))
                        reg[i] = ((opts.regularization
                                   if opts.regularization > 0 else 1e-6)
                                  * (10.0 ** attempts[i]))
                        for m in offending:
                            d = bb.slot_dims[i][m]
                            U = torch.zeros_like(factors[m][i])
                            U[:d] = _redraw((d, rank), U.dtype, dev,
                                            int(seeds[i]), int(attempts[i]),
                                            m)
                            factors[m][i] = U
                            grams[m][i] = gram(U)
                    reg_dev = _host_to(reg, fdt, dev)
                    resilience.run_report().add(
                        "health_rollback", iteration=it + 1, slot=int(i),
                        attempt=int(attempts[i]),
                        regularization=float(reg[i]),
                        rerandomized=offending)
                    if opts.verbosity >= Verbosity.LOW:
                        print(f"  batch slot {i}: non-finite at iteration "
                              f"{it + 1}; rolled back alone (attempt "
                              f"{int(attempts[i])}/{guard})")
            window = max((it + 1) - last_check_it, 1)
            last_check_it = it + 1
            healthy = active & (flags.min(axis=1) > 0.5)
            for i in np.flatnonzero(healthy):
                fits[i] = fitv[i]
                if it > 0 and abs(fitv[i] - fit_prev[i]) \
                        < opts.tolerance * window:
                    active[i] = False       # converged: frozen from here
                fit_prev[i] = fitv[i]
            if guard > 0 and healthy.any():
                # only verified-finite slots move the snapshot
                h = _host_to(healthy, torch.bool, dev)
                snap = ([torch.where(h[:, None, None], F, S)
                         for F, S in zip(factors, snap[0])],
                        [torch.where(h[:, None, None], G, S)
                         for G, S in zip(grams, snap[1])],
                        torch.where(h[:, None], lam, snap[2]))
            active_dev = _host_to(active, torch.bool, dev)
            if opts.verbosity >= Verbosity.LOW:
                print(f"  batch its = {it + 1:3d}  fit[0] = {fitv[0]:0.5f}"
                      f"  done {K - int(active.sum())}/{K}")
            if stop is not None and stop():
                stopped = True
                break
        finally:
            trace.end(it_span)

    statuses = ["degraded" if degraded[i] else "converged"
                for i in range(K)]
    return BatchedCPD(
        results=unstack_batched(factors, lam, fits, bb.slot_dims),
        statuses=statuses, fits=[float(f) for f in fits],
        iterations=it + 1, compiles=counter["builds"],
        rollbacks=[int(a) for a in attempts], stopped=stopped)


# -- the warm update pre-pass (docs/batched.md) --------------------------------


def touched_rows(delta, nmodes: int) -> dict:
    """Each mode's sorted unique row ids that a delta COO touches, the
    rows :func:`refresh_touched_rows` re-solves (≙ splatt_tpu.cpd.
    touched_rows)."""
    return {m: np.unique(np.asarray(delta.inds[m])) for m in range(nmodes)}


def refresh_touched_rows(X, factors, touched: dict,
                         reg: float = 0.0) -> List[torch.Tensor]:
    """The warm-update pre-pass (≙ splatt_tpu.cpd.refresh_touched_rows):
    re-solve only the rows a delta touched, before warm-started sweeps.

    Each touched mode runs the full MTTKRP, the port's :func:`mttkrp` (on
    a card the engine chain, ``fused_mttkrp_t`` on a sorted mode), solves
    the normal equations, normalizes by the max-norm into the warm
    factors' column scale, and commits only the touched rows: every other
    row keeps its value bit for bit.  `factors` are numpy arrays or
    tensors, moved to X's device; X must be in the original row order (a
    reordered :class:`BlockedSparse` raises ValueError).  Runs under the
    ``cpd.update`` fault site, whose raised fault surfaces to the
    caller."""
    from splatt_tpu_torch.ops.linalg import (SYM_EIG_MAX_SWEEPS,
                                             clear_solver_status)
    from splatt_tpu_torch.utils import faults

    faults.maybe_fail("cpd.update")
    if getattr(X, "perm", None) is not None:
        raise ValueError("refresh_touched_rows works in the original row "
                         "order: build X with reorder='identity'")
    dev = X.device if isinstance(X, BlockedSparse) else None
    out = [torch.as_tensor(U) for U in factors]
    if dev is not None:
        out = [U.to(dev) for U in out]
    with trace.span("cpd.update", modes=len(touched),
                    rows=int(sum(np.size(r) for r in touched.values()))):
        grams = [gram(U) for U in out]
        capped = []
        for m in sorted(touched):
            rows = np.asarray(touched[m], dtype=np.int64)
            if rows.size == 0:
                continue
            M = mttkrp(X, out, m)
            U, cap = solve_normals(form_normal_lhs(grams, m, reg), M,
                                   return_capped=True)
            capped.append(cap)
            U, _ = normalize_columns(U, "max")
            idx = torch.from_numpy(rows).to(U.device)
            out[m] = out[m].clone()
            out[m][idx] = U[idx].to(out[m].dtype)
            grams[m] = gram(out[m])
        # its own solves' caps, read once here (one sync) and cleared from
        # the process's word, so that no later run is blamed for them
        if capped and bool(torch.stack(capped).any()):
            clear_solver_status()
            raise SolverError(f"sym_eig: a refresh solve did not converge "
                              f"within {SYM_EIG_MAX_SWEEPS} sweeps")
    return out
