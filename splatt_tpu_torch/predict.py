"""The generation-fenced prediction plane (≙ splatt_tpu/predict.py).

The model store of the serve daemon is ``ckpt/<model>.npz`` (the
checkpoint of a finished fit or update), ``<model>.gen.json`` (its
generation stamp, the previous one kept as ``.bak``) and, once an update
ran, ``<model>.model.npz`` (the merged COO tensor).  A prediction must
never be computed from a stale, torn or half-merged model; this module is
that contract, host numpy throughout, as in the JAX package (no kernel
runs here):

Model generations
    Every model-store commit atomically advances a per-model generation
    stamp, a monotonic ordinal plus the factor-content sha
    (:func:`cpd.factor_content_sha`), published by
    :func:`durable.publish_json` beside the factors.  The advance is
    serialized across processes by a flock sidecar and is idempotent:
    re-committing bit-identical factors returns the current ordinal.

Fenced reads
    :func:`load_model_generation` returns only factors whose content sha
    verifies against a stamp (:func:`cpd.load_checkpoint_resilient_gen`
    walks the (checkpoint, stamp) pairs newest first); a torn pair
    degrades classified (``model_torn``) to the ``.bak`` generation, and
    when nothing verifies the caller refuses.

Hot-factor cache
    :class:`HotFactorCache` keys entries by ``(model, generation)``: an
    update commit invalidates by advancing the generation, never by
    deleting, so an in-flight predict pinned at admission finishes on its
    generation bit for bit.  LRU-bounded (SPLATT_PREDICT_CACHE_MAX); a
    poisoned lookup (the ``predict.cache`` fault site) degrades to the
    direct fenced read.

The math: an entry estimate is ``x̂(i₁..i_N) = Σ_r λ_r Π_m U_m[i_m, r]``,
and a top-k slice scan fixes all modes but one, one ``(I_mode × R) @
(R,)`` product.  Both run in numpy on the host, so replies are
deterministic and bit-identical to the JAX package's on the same factors.

Either package serves the other's model store: the checkpoint, the stamp
and the sha are the same bytes for f32 and f64 factors.  A bf16 model is
the exception: the port widens bf16 factors to f32 before hashing and
checkpointing (numpy has no bfloat16), where the JAX package hashes
ml_dtypes' bfloat16, so a bf16 model's stamp is the port's own.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import fcntl as _fcntl
except ImportError:  # non-POSIX: advances degrade to in-process safety
    _fcntl = None

from splatt_tpu_torch import trace
from splatt_tpu_torch.utils import faults
from splatt_tpu_torch.utils.durable import publish_json


# -- generation stamps -------------------------------------------------------

def stamp_path(ckpt_dir: str, model: str) -> str:
    """The generation stamp published beside the model's factors:
    ``<ckpt_dir>/<model>.gen.json`` (previous generation at ``.bak``)."""
    return os.path.join(str(ckpt_dir), f"{model}.gen.json")


def read_stamp(path: str) -> Optional[dict]:
    """Parse one generation stamp -> ``{"model","gen","sha","ts"}``,
    or None.  A MISSING stamp is silently None (the model predates the
    fence or was never committed); an unreadable/garbage one is a torn
    artifact and degrades classified with a ``model_torn`` event —
    the caller falls back a generation or refuses, never guesses."""
    from splatt_tpu_torch import resilience

    try:
        with open(path, "r") as f:
            obj = json.load(f)
        if not isinstance(obj, dict) or "gen" not in obj \
                or not obj.get("sha"):
            raise ValueError(f"stamp {path} missing gen/sha fields")
        obj["gen"] = int(obj["gen"])
        return obj
    except FileNotFoundError:
        return None
    except Exception as e:
        resilience.run_report().add(
            "model_torn", path=path, piece="generation-stamp",
            failure_class=resilience.classify_failure(e).value,
            error=str(e)[:200])
        return None


def advance_generation(ckpt_dir: str, model: str, factors,
                       lam) -> int:
    """Atomically advance `model`'s generation stamp to cover the
    factor content just committed, returning the new (or, idempotent,
    current) ordinal.

    Serialized across replicas by a flock sidecar so two concurrent
    commits cannot both mint ordinal N+1; the previous stamp is kept
    as ``.bak`` (the rollback generation readers degrade to).  A
    bit-identical re-commit — same content sha — returns the current
    ordinal WITHOUT advancing: a replayed/adopted commit must not
    invalidate every reader's cache for nothing.  The
    ``model.generation`` fault site fires before any write: a failed
    advance raises, the calling commit aborts classified, and the old
    generation keeps serving (the stamp never moved).
    """
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.cpd import factor_content_sha

    spath = stamp_path(ckpt_dir, model)
    lockf = open(spath + ".lock", "a+")
    try:
        if _fcntl is not None:
            _fcntl.flock(lockf.fileno(), _fcntl.LOCK_EX)
        faults.maybe_fail("model.generation")
        sha = factor_content_sha(factors, lam)
        cur = read_stamp(spath)
        if cur is not None and cur.get("sha") == sha:
            return int(cur["gen"])
        gen = int(cur["gen"]) + 1 if cur is not None else 1
        if cur is not None:
            # keep the outgoing generation as the rollback stamp
            publish_json(spath + ".bak", cur)
        publish_json(spath, {"model": str(model), "gen": gen,
                             "sha": sha, "ts": time.time()})
        resilience.run_report().add(
            "model_generation_advanced", model=str(model), gen=gen,
            sha=sha[:12])
        return gen
    finally:
        if _fcntl is not None:
            _fcntl.flock(lockf.fileno(), _fcntl.LOCK_UN)
        lockf.close()


def current_generation(ckpt_dir: str, model: str) -> int:
    """The model's committed generation ordinal right now (0 = no
    intact stamp) — what a predict pins at admission.  Reads the
    stamp only; the factors are verified against it at serve time."""
    cur = read_stamp(stamp_path(ckpt_dir, model))
    return int(cur["gen"]) if cur is not None else 0


def load_model_generation(ckpt_dir: str, model: str,
                          expect_reorder: Optional[str] = None
                          ) -> Optional[dict]:
    """The direct fenced read: load the newest generation of `model`
    whose factor content verifies against a stamp.

    Returns ``{"factors": [np arrays], "lam": np array, "gen": int,
    "sha": str}`` or None (REFUSE — no intact generation).  The
    ``predict.read`` fault site covers the whole read; torn pairs
    degrade through cpd.load_checkpoint_resilient_gen's ``model_torn``
    classification down to the ``.bak`` generation.  A checkpoint
    with NO stamp at all is not servable: "never stale or torn" wins
    over "best effort", and the first commit through
    :func:`advance_generation` makes it servable."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.cpd import (_host_array,
                                      load_checkpoint_resilient_gen)

    faults.maybe_fail("predict.read")
    ckpt = os.path.join(str(ckpt_dir), f"{model}.npz")
    spath = stamp_path(ckpt_dir, model)
    stamp = read_stamp(spath)
    bak = read_stamp(spath + ".bak")
    if stamp is None and bak is None:
        if os.path.exists(ckpt):
            resilience.run_report().add(
                "model_torn", path=ckpt, piece="no-generation-stamp",
                failure_class="permanent",
                error="checkpoint exists but no generation stamp "
                      "verifies it; refusing to serve unfenced factors")
        return None
    out = load_checkpoint_resilient_gen(ckpt, stamp, bak,
                                        expect_reorder=expect_reorder)
    if out is None:
        return None
    factors, lam, _it, _fit, gen, sha = out
    return {"factors": [_host_array(U) for U in factors],
            "lam": _host_array(lam), "gen": int(gen), "sha": sha}


# -- hot-factor cache --------------------------------------------------------

class HotFactorCache:
    """A daemon's hot factors keyed by ``(model, generation)``.

    The invalidation protocol is the whole design: an update commit
    advances the generation, so new predicts key a NEW entry and the
    old one ages out by LRU — it is never deleted under a reader, so
    an in-flight predict pinned to the old generation still finishes
    on it bit-exactly.  ``max_entries <= 0`` disables storage (every
    lookup is a recorded miss and predicts take the direct read)."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Tuple[str, int], dict]" \
            = collections.OrderedDict()

    def get(self, model: str, gen: int) -> Optional[dict]:
        """One consult (the ``predict.cache`` fault site; a raised
        fault is the poisoned-cache drill — callers degrade to the
        direct fenced read).  Records hit/miss into
        splatt_predict_cache_total."""
        faults.maybe_fail("predict.cache")
        with self._lock:
            entry = self._entries.get((str(model), int(gen)))
            if entry is not None:
                self._entries.move_to_end((str(model), int(gen)))
        trace.metric_inc("splatt_predict_cache_total",
                         outcome="hit" if entry is not None else "miss")
        return entry

    def put(self, model: str, gen: int, entry: dict) -> None:
        if self.max_entries <= 0:
            return
        with self._lock:
            self._entries[(str(model), int(gen))] = entry
            self._entries.move_to_end((str(model), int(gen)))
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# -- the math ----------------------------------------------------------------

def reconstruct_entries(factors: Sequence, lam,
                        coords) -> np.ndarray:
    """Batched entry reconstruction: for each coordinate row
    ``(i₁..i_N)`` return ``x̂ = Σ_r λ_r Π_m U_m[i_m, r]``.

    `coords` is ``(B, nmodes)`` integer indices.  Host-side numpy —
    a (B × R) gather-product per mode then one ``@ λ`` contraction —
    keeps replies deterministic and bit-exact across replays (the
    generation-fence tests depend on it)."""
    fs = [np.asarray(U) for U in factors]
    lam = np.asarray(lam)
    coords = np.asarray(coords)
    if coords.ndim == 1:
        coords = coords[None, :]
    coords = coords.astype(np.int64)
    if coords.shape[1] != len(fs):
        raise ValueError(
            f"coords have {coords.shape[1]} modes, model has {len(fs)}")
    for m, U in enumerate(fs):
        col = coords[:, m]
        if col.size and (col.min() < 0 or col.max() >= U.shape[0]):
            raise ValueError(
                f"coordinate out of range for mode {m} "
                f"(dim {U.shape[0]})")
    rows = np.ones((coords.shape[0], fs[0].shape[1]),
                   dtype=np.result_type(*[U.dtype for U in fs]))
    for m, U in enumerate(fs):
        rows = rows * U[coords[:, m], :]
    return rows @ lam


def top_k_slice(factors: Sequence, lam, fixed: Dict[int, int],
                mode: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k scan of one slice: fix every mode but `mode` at the
    indices in `fixed`, score all I_mode candidates, return the k
    best ``(indices, scores)`` in descending score order.

    The rank-R reduction ``w_r = λ_r Π_fixed U_m[i_m, r]`` collapses
    the fixed modes to one weight vector, and the scan is the tall
    product ``U_mode @ w`` (GenTen's completion use-case)."""
    fs = [np.asarray(U) for U in factors]
    mode = int(mode)
    if not 0 <= mode < len(fs):
        raise ValueError(f"mode {mode} out of range for {len(fs)} modes")
    want = set(range(len(fs))) - {mode}
    got = {int(m) for m in fixed}
    if got != want:
        raise ValueError(
            f"fixed must pin exactly the non-target modes "
            f"{sorted(want)}, got {sorted(got)}")
    w = np.asarray(lam).astype(np.result_type(*[U.dtype for U in fs]),
                               copy=True)
    for m in sorted(want):
        idx = int(fixed[m])
        if not 0 <= idx < fs[m].shape[0]:
            raise ValueError(
                f"coordinate out of range for mode {m} "
                f"(dim {fs[m].shape[0]})")
        w = w * fs[m][idx, :]
    scores = fs[mode] @ w
    k = max(1, min(int(k), scores.shape[0]))
    part = np.argpartition(-scores, k - 1)[:k]
    order = part[np.argsort(-scores[part], kind="stable")]
    return order.astype(np.int64), scores[order]
