"""Dense linear algebra for CPD-ALS (≙ src/matrix.c, src/splatt_lapack.h).

Counterpart of ``splatt_tpu/ops/linalg.py``.  The rank×rank and dim×rank
dense math is plain ``torch.matmul``/``torch.linalg``, as the JAX package
leaves it to XLA, but for the symmetric eigendecomposition of the solve:
on a card that is :func:`sym_eig`, the hand-written Jacobi kernel of
``csrc/sym_eig.cu``, because ``torch.linalg.eigh`` reads its solver status
on the host once per call and the JAX sweep never waits on the host.
TF32 is switched off for float32 matmuls so the normal equations keep full
float32 precision.  bf16 operands are cast to f32 before any product (a
bf16 ``torch.matmul`` returns bf16): Gram, solve and normalization
accumulate in f32 (≙ splatt_tpu/ops/linalg.py:33-36, :74-83, :101-114).

Each function also takes a stack of problems on a leading batch axis, the
batched CPD's K slots (≙ the ``jax.vmap`` of splatt_tpu/cpd.py:1117-1133):
``(K, R, R)`` matrices, ``(K, d, R)`` factors.  Every reduction is per
slot (the eigenvalue cut, the SPD test, the norms), so one slot's
non-finite input never changes a neighbour's result.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from splatt_tpu_torch.config import acc_dtype
from splatt_tpu_torch.ops import kernels

torch.backends.cuda.matmul.allow_tf32 = False

#: sweeps :func:`sym_eig` runs before it gives up and sets its status word
SYM_EIG_MAX_SWEEPS = 40
#: the dtypes csrc/sym_eig.cu takes
SYM_EIG_FLOATS = (torch.float32, torch.float64)


class SolverError(RuntimeError):
    """The eigensolver did not converge within its sweep cap."""


def gram(U: torch.Tensor) -> torch.Tensor:
    """UᵀU, accumulated in :func:`acc_dtype` (≙ mat_aTa); a ``(K, d, R)``
    stack gives ``(K, R, R)``."""
    A = U.to(acc_dtype(U.dtype))
    return A.mT @ A


def form_normal_lhs(grams: Sequence[torch.Tensor], mode: int,
                    regularization: float = 0.0) -> torch.Tensor:
    """Hadamard product of all Grams except `mode`, + ρI (≙ p_form_gram);
    stacked ``(K, R, R)`` Grams give a stack."""
    rank = grams[0].shape[-1]
    out = torch.ones_like(grams[0])
    for m, g in enumerate(grams):
        if m != mode:
            out = out * g
    if regularization != 0.0:
        out = out + regularization * torch.eye(rank, dtype=out.dtype,
                                               device=out.device)
    return out


# -- the symmetric eigensolver -----------------------------------------------


def sym_eig_smem_bytes(R: int, itemsize: int) -> int:
    """Shared bytes of csrc/sym_eig.cu's CTA for rank R (its smem_bytes):
    A and V at an odd row stride, the rotations, 32 reduction slots, the
    pairs and the sort ranks."""
    n = R + (R & 1)
    h = n // 2
    return (2 * n * (n + 1) + 2 * h + 32) * itemsize + (2 * h + n + 4) * 4


def sym_eig_fits(R: int, dtype: torch.dtype) -> bool:
    """What the kernel takes: a dtype of :data:`SYM_EIG_FLOATS` and an R
    whose A and V fit one CTA's shared memory (f32 up to R = 168, f64 up
    to 118).  The solve's gate, :func:`solve_takes_sym_eig`, is
    narrower."""
    if dtype not in SYM_EIG_FLOATS:
        return False
    itemsize = torch.empty(0, dtype=dtype).element_size()
    return sym_eig_smem_bytes(R, itemsize) <= kernels.SMEM_TILE_BYTES


#: the largest rank at which the solve takes :func:`sym_eig`.  Above it
#: the one-CTA kernel loses to ``torch.linalg.eigh`` even with eigh's host
#: sync counted: on an H100, the NELL-2-shaped CPD of chip_smoke.py's
#: phase 5 ran at least as fast per iteration with the kernel up to
#: R = 96 and faster with eigh from R = 112 (ROADMAP.md, queue C)
SYM_EIG_SOLVE_MAX_RANK = 96


def solve_takes_sym_eig(R: int, dtype: torch.dtype) -> bool:
    """The solve's static gate on a card: the kernel takes rank R in
    `dtype` (:func:`sym_eig_fits`) and R is at most
    :data:`SYM_EIG_SOLVE_MAX_RANK`."""
    return sym_eig_fits(R, dtype) and R <= SYM_EIG_SOLVE_MAX_RANK


def sym_eig_threads(R: int) -> int:
    """Threads of the kernel's one CTA: 256 up to R = 32, else 1024 (a
    round's updates are latency-bound, and from R = 50 up more warps hide
    more of it; on an H100, 1024 threads ran R = 50 faster than 256, and
    256 were the faster at R = 17)."""
    return 256 if R <= 32 else 1024


def jacobi_round(n: int, k: int) -> Tuple[List[int], List[int]]:
    """Round k of a sweep over the even size n, the kernel's round-robin
    order: index 0 stays and 1..n-1 turn, so the n/2 pairs (p < q) are
    disjoint and n - 1 rounds visit every pair once."""
    m = n - 1
    ps, qs = [], []
    for i in range(n // 2):
        x, y = (0, 1 + k) if i == 0 else (1 + (k + i) % m,
                                          1 + (k - i + m) % m)
        ps.append(min(x, y))
        qs.append(max(x, y))
    return ps, qs


def sym_eig_plain(A: torch.Tensor, max_sweeps: int = SYM_EIG_MAX_SWEEPS):
    """Plain PyTorch version of :func:`sym_eig`, the kernel's schedule
    transcribed: the padding to an even n, the power-of-two scale, the
    round-robin pair order, the skip threshold eps·‖A‖_F/n, the stop at
    off(A) ≤ eps·‖A‖_F and the sort.  Returns (w ascending, V, sweeps);
    a non-finite A gives NaN, and the sweep cap raises
    :class:`SolverError`.  A ``(K, R, R)`` stack, as one launch of the
    kernel takes it, gives ``(K, R)`` w, ``(K, R, R)`` V and a ``(K,)``
    int32 tensor of sweeps, ``max_sweeps + 1`` where a matrix hit the cap
    (the batch raises nothing: its caller reads each slot's count)."""
    if A.dim() == 3:
        parts = [_sym_eig_plain_one(a, max_sweeps) for a in A]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]),
                torch.tensor([p[2] for p in parts], dtype=torch.int32))
    w, v, sweeps = _sym_eig_plain_one(A, max_sweeps)
    if sweeps > max_sweeps:
        raise SolverError(f"sym_eig: no convergence in {max_sweeps} "
                          f"sweeps at R = {int(A.shape[0])}")
    return w, v, sweeps


def _sym_eig_plain_one(A: torch.Tensor, max_sweeps: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`sym_eig_plain` of one matrix; ``max_sweeps + 1`` sweeps
    where it hit the cap, whose (w, V) are then the last sweep's."""
    R = int(A.shape[0])
    dt, dev = A.dtype, A.device
    if not bool(torch.isfinite(A).all()):
        nan = float("nan")
        return (torch.full((R,), nan, dtype=dt, device=dev),
                torch.full((R, R), nan, dtype=dt, device=dev), 0)
    n = R + (R & 1)
    eps = torch.finfo(dt).eps
    M = torch.zeros((n, n), dtype=dt, device=dev)
    M[:R, :R] = A
    V = torch.eye(n, dtype=dt, device=dev)
    amax = M.abs().max()
    e = int(torch.frexp(amax).exponent) if float(amax) > 0 else 0
    M = M * 2.0 ** -e
    tol_off = eps * torch.sqrt((M * M).sum())
    thresh = tol_off / n
    offdiag = 1 - torch.eye(n, dtype=dt, device=dev)
    upper = torch.ones((n // 2, n // 2), dtype=torch.bool,
                       device=dev).triu(1)
    sweeps = 0
    while True:
        off = M * offdiag
        if bool((off * off).sum() <= tol_off * tol_off):
            break
        if sweeps == max_sweeps:
            sweeps += 1
            break
        for k in range(n - 1):
            ps, qs = jacobi_round(n, k)
            P = torch.tensor(ps, device=dev)
            Q = torch.tensor(qs, device=dev)
            apq, app, aqq = M[P, Q], M[P, P], M[Q, Q]
            rot = apq.abs() > thresh
            if not bool(rot.any()):
                continue
            theta = (aqq - app) / (2 * torch.where(rot, apq,
                                                   torch.ones_like(apq)))
            t = torch.copysign(torch.ones_like(theta), theta) / (
                theta.abs() + torch.sqrt(theta * theta + 1))
            c = torch.where(rot, 1 / torch.sqrt(t * t + 1),
                            torch.ones_like(t))
            s = torch.where(rot, t * c, torch.zeros_like(t))
            # each block between pairs i and j: Z = Ji^T X Jj
            Pr, Pc, Qr, Qc = P[:, None], P[None, :], Q[:, None], Q[None, :]
            xpp, xpq, xqp, xqq = M[Pr, Pc], M[Pr, Qc], M[Qr, Pc], M[Qr, Qc]
            ci, si, cj, sj = c[:, None], s[:, None], c[None, :], s[None, :]
            ypp, ypq = cj * xpp - sj * xpq, sj * xpp + cj * xpq
            yqp, yqq = cj * xqp - sj * xqq, sj * xqp + cj * xqq
            zpp, zqp = ci * ypp - si * yqp, si * ypp + ci * yqp
            zpq, zqq = ci * ypq - si * yqq, si * ypq + ci * yqq
            # the blocks i < j and their transposes: A stays symmetric
            npp = torch.where(upper, zpp, zpp.T)
            npq = torch.where(upper, zpq, zqp.T)
            nqp = torch.where(upper, zqp, zpq.T)
            nqq = torch.where(upper, zqq, zqq.T)
            # each pair's own block: diagonal where it rotated
            d = torch.arange(n // 2, device=dev)
            npp[d, d] = torch.where(rot, app - t * apq, app)
            nqq[d, d] = torch.where(rot, aqq + t * apq, aqq)
            npq[d, d] = torch.where(rot, torch.zeros_like(apq), apq)
            nqp[d, d] = npq[d, d]
            M[Pr, Pc], M[Pr, Qc], M[Qr, Pc], M[Qr, Qc] = npp, npq, nqp, nqq
            vp, vq = V[:, P], V[:, Q]
            V[:, P], V[:, Q] = c * vp - s * vq, s * vp + c * vq
        sweeps += 1
    w, order = torch.sort(torch.diagonal(M)[:R], stable=True)
    return torch.ldexp(w, torch.tensor(e, device=dev)), \
        V[:R, :R][:, order], sweeps


_LOCK = threading.Lock()
_STATUS: List[int] = []        # [host address, device address]
#: cap-flag words in the mapped host block: word 0 is the process's,
#: outside any scope; each :func:`solver_scope` holds one of the rest
SOLVER_WORDS = 1024
_FREE_WORDS: List[int] = list(range(SOLVER_WORDS - 1, 0, -1))
#: words whose scope ended while a launch under them may still be queued,
#: oldest first, each with its launches' events (:func:`_note_launch`)
_QUARANTINE: List[Tuple[int, list]] = []
#: word -> {stream: event recorded after that stream's last launch}
_PENDING: Dict[int, dict] = {}
_WORD: contextvars.ContextVar = contextvars.ContextVar(
    "splatt_torch_solver_word", default=0)


def _status_word() -> int:
    """The device address of the calling scope's word in the mapped host
    block, which the kernel sets when it hits its sweep cap."""
    with _LOCK:
        if not _STATUS:
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            err = kernels.load_library()["splatt_sym_eig_alloc_host"](
                4 * SOLVER_WORDS, ctypes.byref(host), ctypes.byref(dev))
            if err != 0:
                raise RuntimeError(f"splatt_sym_eig_alloc_host: CUDA error "
                                   f"{err}")
            _STATUS[:] = [host.value, dev.value]
        return _STATUS[1] + 4 * _WORD.get()


def _take_word(word: int) -> bool:
    """Whether `word` is set; it is cleared."""
    if not _STATUS:
        return False
    flag = ctypes.c_int.from_address(_STATUS[0] + 4 * word)
    if flag.value == 0:
        return False
    flag.value = 0
    return True


def _note_launch(word: int, stream, event) -> None:
    """Remember `event`, recorded on `stream` just after a launch that
    writes `word`: the word is not handed to another scope before the
    event has completed."""
    if word:
        with _LOCK:
            _PENDING.setdefault(word, {})[stream] = event


def _done(events: list) -> bool:
    """Whether every launch before `events` has finished (False where the
    card cannot say: a lost context keeps the word out of the pool)."""
    try:
        return all(e.query() for e in events)
    except Exception:   # noqa: BLE001 - a sticky error: never reuse it
        return False


def _acquire_word() -> int:
    """A cleared word no queued launch can still set: the oldest
    quarantined word whose launches have finished, else a fresh one, else
    the oldest quarantined word once its launches have finished.  Called
    under ``_LOCK``."""
    for i, (word, events) in enumerate(_QUARANTINE):
        if _done(events):
            del _QUARANTINE[i]
            break
    else:
        if _FREE_WORDS:
            word = _FREE_WORDS.pop()
        elif _QUARANTINE:
            word, events = _QUARANTINE.pop(0)
            for e in events:
                e.synchronize()
        else:
            raise RuntimeError(f"solver_scope: all {SOLVER_WORDS - 1} "
                               f"cap-flag words are held")
    _take_word(word)
    return word


@contextlib.contextmanager
def solver_scope():
    """Give the block a cap flag of its own: every :func:`sym_eig` launch
    inside it sets this word, and :func:`check_solver` /
    :func:`clear_solver_status` read only it, so jobs on threads of one
    process (the serve daemon's workers) never raise, or clear, each
    other's cap hits.  ``resilience.scope`` enters one.  When the block
    ends, a word none of whose launches can still be queued is cleared
    and returned to the pool; one that a launch may still set (a job
    that raised before its next sync) is quarantined until the events
    recorded after its launches have completed, and cleared as it is
    handed out again, so a late write never reaches the next scope."""
    with _LOCK:
        word = _acquire_word()
    token = _WORD.set(word)
    try:
        yield word
    finally:
        _WORD.reset(token)
        with _LOCK:
            events = list(_PENDING.pop(word, {}).values())
            if _done(events):
                _take_word(word)
                _FREE_WORDS.append(word)
            else:
                _QUARANTINE.append((word, events))


def clear_solver_status() -> bool:
    """Whether a :func:`sym_eig` launch of the calling scope
    (:func:`solver_scope`; the process's word outside one) hit its sweep
    cap since the last clear; the word is cleared.  The word lies in
    mapped host memory: reading it is no CUDA call, so the caller reads
    it after a sync it already makes (the iteration's fit read).  The
    batched CPD clears it and reads each slot's sweep count instead, so
    that a cap hit by one slot is told apart from its neighbours'."""
    return _take_word(_WORD.get())


def check_solver() -> None:
    """Raise :class:`SolverError` when a :func:`sym_eig` launch of the
    calling scope hit its sweep cap (:func:`clear_solver_status`)."""
    if clear_solver_status():
        raise SolverError(f"sym_eig: the Jacobi sweeps did not converge "
                          f"within {SYM_EIG_MAX_SWEEPS} sweeps")


def sym_eig(A: torch.Tensor, return_sweeps: bool = False,
            max_sweeps: Optional[int] = None):
    """(w ascending, V) of the symmetric (R, R) `A`, ``A = V diag(w) Vᵀ``,
    in A's dtype, as ``torch.linalg.eigh`` returns them; a ``(K, R, R)``
    stack gives ``(K, R)`` and ``(K, R, R)`` in one launch of K CTAs.  CPU
    tensors take :func:`sym_eig_plain`; CUDA tensors (f32 or f64, within
    :func:`sym_eig_fits`) launch ``csrc/sym_eig.cu`` on the current stream
    with no sync, or raise.  A run that hits the sweep cap sets the status
    word of the calling scope, which :func:`check_solver` reads;
    `max_sweeps` lowers the cap for one call (a drill forcing a cap hit).
    With `return_sweeps`, a third value: the sweeps run (on a card an
    int32 tensor of one element, or of K for a stack, the cap + 1 where a
    matrix hit the cap)."""
    if (A.dim() not in (2, 3) or A.shape[-1] != A.shape[-2]
            or A.shape[-1] < 1):
        raise ValueError(f"sym_eig takes a square matrix or a stack of "
                         f"them, got {tuple(A.shape)}")
    if A.device.type == "cpu":
        w, v, sweeps = sym_eig_plain(A)
        return (w, v, sweeps) if return_sweeps else (w, v)
    R = int(A.shape[-1])
    if not sym_eig_fits(R, A.dtype):
        raise ValueError(f"sym_eig takes f32 up to R = 168 and f64 up to "
                         f"118, got {A.dtype} at R = {R}")
    batch = A.shape[:-2]
    K = int(A.shape[0]) if A.dim() == 3 else 1
    w = torch.empty((*batch, R), dtype=A.dtype, device=A.device)
    v = torch.empty((*batch, R, R), dtype=A.dtype, device=A.device)
    sweeps = (torch.empty(batch if A.dim() == 3 else (1,),
                          dtype=torch.int32, device=A.device)
              if return_sweeps else None)
    A = A.contiguous()
    status = _status_word()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream()
        kernels._launch("splatt_sym_eig", A.data_ptr(),
                        int(A.dtype == torch.float64), R, K,
                        SYM_EIG_MAX_SWEEPS if max_sweeps is None
                        else int(max_sweeps), sym_eig_threads(R),
                        w.data_ptr(),
                        v.data_ptr(),
                        None if sweeps is None else sweeps.data_ptr(),
                        status)
        word = _WORD.get()
        if word:
            event = torch.cuda.Event()
            event.record(stream)
            _note_launch(word, stream, event)
    kernels.count_launch(sym_eig)
    return (w, v, sweeps) if return_sweeps else (w, v)


sym_eig.launches = 0


def eigh(lhs: torch.Tensor, return_capped: bool = False):
    """The solve's eigendecomposition: :func:`sym_eig` on a card within
    its static gate (:func:`solve_takes_sym_eig`), ``torch.linalg.eigh``
    on the CPU (no host sync to remove there) and above the gate.  Never
    a fallback on failure: a failed build, load or launch raises.

    A ``(K, R, R)`` stack is one :func:`sym_eig` launch; on the eigh route
    its non-finite slots are decomposed as the identity and come back NaN
    (eigh raises on a NaN matrix; the kernel writes NaN for one), so one
    slot's NaN neither fails nor moves the batch.  With `return_capped`, a
    third value: a bool tensor of the batch's shape, True where the
    kernel hit its sweep cap (all False on the eigh route, which raises
    instead)."""
    if lhs.device.type == "cuda" and solve_takes_sym_eig(
            int(lhs.shape[-1]), lhs.dtype):
        if not return_capped:
            return sym_eig(lhs)
        w, v, sweeps = sym_eig(lhs, return_sweeps=True)
        return w, v, sweeps.reshape(lhs.shape[:-2]) > SYM_EIG_MAX_SWEEPS
    if lhs.dim() == 3:
        finite = torch.isfinite(lhs).flatten(1).all(dim=1)
        eye = torch.eye(lhs.shape[-1], dtype=lhs.dtype, device=lhs.device)
        w, v = torch.linalg.eigh(torch.where(finite[:, None, None], lhs,
                                             eye))
        nan = torch.full((), float("nan"), dtype=lhs.dtype,
                         device=lhs.device)
        w = torch.where(finite[:, None], w, nan)
        v = torch.where(finite[:, None, None], v, nan)
    else:
        w, v = torch.linalg.eigh(lhs)
    if not return_capped:
        return w, v
    return w, v, torch.zeros(lhs.shape[:-2], dtype=torch.bool,
                             device=lhs.device)


def pinv_parts(lhs: torch.Tensor, return_capped: bool = False):
    """(w, V, tol, w_inv) of the pseudo-inverse solve: eigenvalues below
    √eps·max|w| are cut (≙ splatt_tpu/ops/linalg.py:60-84), the cut per
    slot of a stack (tol has the batch's shape).  With `return_capped`,
    :func:`eigh`'s cap flags last."""
    w, v, *capped = eigh(lhs, return_capped=True) if return_capped \
        else eigh(lhs)
    tol = torch.finfo(lhs.dtype).eps ** 0.5 * w.abs().amax(dim=-1)
    w_inv = torch.where(w.abs() > tol[..., None], 1.0 / w,
                        torch.zeros_like(w))
    return (w, v, tol, w_inv, *capped)


def solve_normals(lhs: torch.Tensor, rhs: torch.Tensor,
                  return_capped: bool = False):
    """Solve ``X · lhs = rhs`` for X (≙ mat_solve_normals).

    Both a Cholesky solve and an eigh pseudo-inverse solve (eigenvalues
    below √eps·max|w| cut) are computed, and ``torch.where`` picks one on
    the SPD test: no Python branch, no exception on a matrix that is not
    SPD, and on a card no host sync (≙ splatt_tpu/ops/linalg.py:53-86).
    A stack, ``(K, R, R)`` against ``(K, d, R)``, picks per slot.  With
    `return_capped`, also the eigensolver's per-slot cap flags
    (:func:`eigh`).
    """
    rhs = rhs.to(acc_dtype(rhs.dtype))
    L, info = torch.linalg.cholesky_ex(lhs)
    if lhs.dim() == 2:
        x_chol = torch.cholesky_solve(rhs.T, L).T
    else:
        # X L Lᵀ = rhs as two triangular solves (cuBLAS trsm on a card),
        # where a stack's torch.cholesky_solve spends far more host time
        x_chol = torch.linalg.solve_triangular(
            L, torch.linalg.solve_triangular(L.mT, rhs, upper=True,
                                             left=False),
            upper=False, left=False)

    w, v, tol, w_inv, *capped = pinv_parts(lhs, return_capped)
    x_pinv = (rhs @ (v * w_inv[..., None, :])) @ v.mT

    spd = ((info == 0) & (w.amin(dim=-1) > tol)
           & torch.isfinite(x_chol).all(dim=(-2, -1)))
    # contiguous: the kernels take the solved factor as their table
    x = torch.where(spd[..., None, None], x_chol, x_pinv).contiguous()
    return (x, *capped) if return_capped else x


def normalize_columns(U: torch.Tensor, which: str = "2"):
    """Normalize columns, returning (normalized U, λ).

    "2": 2-norm (iteration 0).  "max": the signed column max floored at
    1, so an all-negative column gets λ = 1 (≙ p_mat_2norm/p_mat_maxnorm,
    src/matrix.c:87-205).  A ``(K, d, R)`` stack gives ``(K, R)`` λ.
    """
    if which == "2":
        A = U.to(acc_dtype(U.dtype))
        lam = torch.sqrt((A * A).sum(dim=-2))
    elif which == "max":
        lam = torch.clamp(U.max(dim=-2).values, min=1.0)
    else:
        raise ValueError(f"unknown norm {which!r}")
    safe = torch.where(lam > 0, lam, torch.ones_like(lam))
    return U / safe.to(U.dtype)[..., None, :], lam
