"""The autotuner of MTTKRP plans and its plan cache (≙ splatt_tpu/tune.py).

For a (shape regime, rank, dtype) on one device, :func:`tune` times the
candidate plans of each mode with short warm and timed calls:

    reorder recipe x fiber packing x nnz_block x layout format
      x engine (the port's :func:`~splatt_tpu_torch.ops.mttkrp.engine_chain`
        for the layout's device) x scan_target (the xla_scan engine only)

plus, where the dense policy and the mode's density allow, the dense tile
layout's engines.  Each mode's fastest candidate is persisted in a
versioned on-disk plan cache.  On a card the chain holds only the kernel
engines (``fused_v2``, ``fused_t``, ``fused_tg``, ``unfused_pallas``,
``fused_dense``; the scatter paths' plain ``xla``), so every candidate
there runs a hand-written kernel; on a CPU tensor each kernel engine runs
its plain version, then the plain ``xla_scan`` and ``xla`` engines.

Dispatch reads the cache: :func:`~splatt_tpu_torch.ops.mttkrp.
mttkrp_blocked` moves a matching plan's engine to the head of its chain,
and :meth:`~splatt_tpu_torch.blocked.BlockedSparse.compile` builds each
layout at its plan's block, format, packing and reorder.  A plan applies
only to a layout built at exactly the configuration it was measured
under, so the tuner can make dispatch faster, never wronger.  Autotuning
is on by default (``SPLATT_AUTOTUNE``, ``Options.autotune``), as in the
JAX package; only :func:`tune` (the ``tune`` and ``bench`` verbs)
measures.

The cache file is ``tune_cache.json`` in ``splatt_tpu_torch/_build/``
(``$SPLATT_TUNE_CACHE`` or :func:`set_cache_path` name another).  Its
entries live under an environment key, ``torch version | CUDA version |
device name | source hash`` (:func:`_cache_env_key`): the device name is
``torch.cuda.get_device_name`` or ``cpu``, and the hash covers every
kernel source and the modules a plan's timing depends on, so editing a
kernel invalidates every plan.  Entries expire after
``SPLATT_PROBE_CACHE_TTL_S`` (14 days).  Reads are best-effort and writes
are one locked, atomic read-modify-write: a broken cache degrades to a
re-tune with a ``tune_cache_io_error`` event, never to a failed dispatch.

Failures follow the engine chain's rule (``ops/mttkrp._engine_failure``):
only an engine's own failure (an armed fault, a launch the card refused,
an out-of-memory, a blown deadline) skips a candidate with a
``tuner_negative`` event; deterministic and resource failures among them
persist as negative entries that later tunes skip, a blown deadline never
does, and transient ones are retried in place.  Any other error (a failed
``nvcc`` build or library load, a wrong operand, a CUDA error left sticky
by earlier work) propagates out of :func:`tune` and writes nothing: a
kernel that fails to build is never cached as slower than nothing.  A
mode with no measurable candidate gets no plan and a ``tuner_degraded``
event; dispatch keeps the heuristic chain.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splatt_tpu_torch.utils import lockcheck as _lockcheck

#: the JAX package's plan schema generation: a cache written by another
#: generation is re-tuned, not reinterpreted
PLAN_CACHE_VERSION = 5

#: candidate nnz blocks (build_layout clamps small tensors; duplicate
#: effective blocks are measured once)
NNZ_BLOCKS = (1024, 2048, 4096, 8192, 16384)

#: scan_target ladder of the xla_scan engine (elements of the gather
#: product one chunk materializes); the middle rung is the default
SCAN_TARGETS = (1 << 21, 1 << 23, 1 << 25)

#: candidate index widths when SPLATT_IDX_WIDTH / Options.idx_width is
#: not pinned; an encode that degrades collapses into a measured one
IDX_CANDIDATES = ("i32", "auto", "u8", "delta", "rle")

#: candidate fiber packings when the knob is not pinned; a balanced pack
#: that degrades to fixed collapses into the fixed candidate
PACKING_CANDIDATES = ("fixed", "balanced")

#: candidate reorder recipes when the knob is not pinned ("random" only
#: destroys locality: a control, available pinned)
REORDER_CANDIDATES = ("identity", "graph", "hgraph", "fibsched")

_AUTOTUNE_ENV = "SPLATT_AUTOTUNE"
_CACHE_ENV = "SPLATT_TUNE_CACHE"
_TTL_ENV = "SPLATT_PROBE_CACHE_TTL_S"

#: the default cache file, in the gitignored build directory the kernels
#: build into
DEFAULT_CACHE = (pathlib.Path(__file__).resolve().parent / "_build"
                 / "tune_cache.json")


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """One persisted dispatch decision: the measured fastest (path,
    engine, nnz_block, scan_target) of a plan key with the layout format
    and balance axes it was measured under, and its median seconds per
    MTTKRP call.  Dispatch applies it only to a layout built at exactly
    ``nnz_block``, ``idx_width``, ``val_storage``, ``packing`` and
    ``reorder``."""

    path: str
    engine: str
    nnz_block: int
    scan_target: int
    sec: float
    idx_width: str = "i32"
    val_storage: str = "auto"
    packing: str = "fixed"
    reorder: str = "identity"


#: the plan-cache schema (≙ splatt_tpu.tune.PLAN_SCHEMA): ``key`` the
#: regime components :func:`plan_key` folds in, ``fields`` every
#: :class:`TunedPlan` field, ``match`` the fields dispatch compares with
#: the built layout (``ops/mttkrp._tuned_plan_for``), ``exempt`` the
#: evidence and outputs
PLAN_SCHEMA = {
    "version": 5,
    "key": ("dims", "nnz", "mode", "rank", "dtype", "skew", "batch",
            "mode_density"),
    "fields": ("path", "engine", "nnz_block", "scan_target", "sec",
               "idx_width", "val_storage", "packing", "reorder"),
    "match": ("path", "nnz_block", "idx_width", "val_storage",
              "packing", "reorder"),
    "exempt": ("engine", "scan_target", "sec"),
}


@dataclasses.dataclass
class TuneResult:
    """What one :func:`tune` did: the per-mode winning plans, how many
    candidate measurements ran (0 on a warm cache), how many modes the
    cache answered, and how many candidates were skipped (negative
    entries, failures)."""

    plans: Dict[int, TunedPlan]
    measured: int = 0
    cache_hits: int = 0
    skipped: int = 0


# -- enablement and keys ------------------------------------------------------


def autotune_enabled(override: Optional[bool] = None) -> bool:
    """Whether dispatch consults the plan cache: an explicit
    ``Options.autotune`` wins, else SPLATT_AUTOTUNE (on unless
    0/off/false/no)."""
    if override is not None:
        return bool(override)
    from splatt_tpu_torch.utils.env import read_env

    return str(read_env(_AUTOTUNE_ENV)).lower() not in (
        "0", "off", "false", "no")


def shape_regime(dims: Sequence[int], nnz: int) -> str:
    """Power-of-two shape regime: per-mode dim buckets and an nnz
    bucket; tensors within 2x of each other per mode share plans."""
    db = "-".join(str(int(d).bit_length()) for d in dims)
    return f"m{len(dims)}:d{db}:z{int(max(nnz, 1)).bit_length()}"


def skew_regime(bucket: str) -> str:
    """The plan-key component of a slice-skew bucket
    (:func:`blocked.nnz_skew_bucket`): near-uniform buckets (max/mean <
    8) collapse to "", heavier skew keys its own regime."""
    return "" if bucket in ("", "k0", "k1", "k2", "k3") else bucket


def skew_of(tt, mode: int) -> str:
    """The slice-skew bucket of one mode of a COO tensor, what
    :func:`blocked.build_layout` stamps into ``ModeLayout.skew``
    (permutation-invariant)."""
    from splatt_tpu_torch.blocked import nnz_skew_bucket

    return nnz_skew_bucket(tt.mode_histogram(mode))


def dtype_name(dtype) -> str:
    """numpy's name of a torch, numpy or named dtype ("float32",
    "float64", "bfloat16"), so a plan key is byte-identical to the JAX
    package's for the same data."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


def plan_key(dims: Sequence[int], nnz: int, mode: int, rank: int,
             dtype, skew: str = "", batch: int = 1,
             mode_density: str = "") -> str:
    """The cache key of one tuned dispatch site (≙ splatt_tpu.tune.
    plan_key): the shape regime, mode, rank and dtype, then the skew
    regime (:func:`skew_regime`, "" for near-uniform), the mode-density
    bucket ("" for a sparse mode) and a power-of-two batch bucket
    (``batch=1`` adds none).  The device and source hash live in the
    environment key."""
    sk = skew_regime(skew)
    md = str(mode_density or "")
    bt = f":bk{int(batch).bit_length()}" if int(batch) > 1 else ""
    return (f"{shape_regime(dims, nnz)}:mode{mode}:r{int(rank)}"
            f":{dtype_name(dtype)}" + (f":{sk}" if sk else "")
            + (f":{md}" if md else "") + bt)


def _negative_key(key: str, engine: str, block: int, scan_target: int,
                  fmt: str = "i32-auto") -> str:
    return f"neg:{key}:{engine}:b{block}:s{scan_target}:{fmt}"


# -- the plan-cache file ------------------------------------------------------

#: process-wide cache path override (beats the env var); None = the
#: env/default resolution
_cache_path_override: Optional[str] = None


def set_cache_path(path: Optional[str]) -> None:
    """Point this process at another plan-cache file (None restores the
    env/default resolution) and forget the memo."""
    global _cache_path_override
    _cache_path_override = str(path) if path is not None else None
    reset_memo()


def cache_path() -> pathlib.Path:
    """The plan-cache file: the process override, else
    $SPLATT_TUNE_CACHE, else :data:`DEFAULT_CACHE`."""
    from splatt_tpu_torch.utils.env import read_env

    if _cache_path_override:
        return pathlib.Path(_cache_path_override)
    p = read_env(_CACHE_ENV)
    if p:
        return pathlib.Path(p)
    return DEFAULT_CACHE


def probe_cache_ttl() -> float:
    """Seconds a cache entry stays fresh (<= 0 disables expiry)."""
    from splatt_tpu_torch.utils.env import read_env_float

    return read_env_float(_TTL_ENV)


@functools.cache
def _kernel_src_hash() -> str:
    """Hash of the sources a plan's timing depends on: every file under
    ``csrc/``, the kernels' wrappers, the engine chain, the layout and
    tensor builders and the options; editing any of them invalidates
    every cached plan."""
    import hashlib

    pkg = pathlib.Path(__file__).resolve().parent
    h = hashlib.sha256()
    try:
        srcs = sorted(p for p in (pkg / "csrc").iterdir() if p.is_file())
        srcs += [pkg / "ops" / "kernels.py", pkg / "ops" / "mttkrp.py",
                 pkg / "blocked.py", pkg / "coo.py", pkg / "config.py",
                 pkg / "utils" / "env.py"]
        for src in srcs:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:12]
    except OSError:
        # sources unreadable (a frozen install): one shared namespace
        return "nosrc"


@functools.cache
def _device_name(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def _cache_env_key(device=None) -> str:
    """``torch version | CUDA version | device name | source hash`` of
    `device` (default: the card)."""
    from splatt_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    return (f"{torch.__version__}|{torch.version.cuda}|"
            f"{_device_name(str(dev))}|{_kernel_src_hash()}")


def _cache_io_error(op: str, exc) -> None:
    """Report a plan-cache IO failure, classified, as a
    ``tune_cache_io_error`` event."""
    from splatt_tpu_torch import resilience

    resilience.run_report().add(
        "tune_cache_io_error", op=op,
        failure_class=resilience.classify_failure(exc).value,
        error=resilience.failure_message(exc)[:200])


def _json_cache_load(path):
    """Read a JSON cache file: None when it is missing (the first run);
    any other failure is reported (:func:`_cache_io_error`) and reads as
    None.  Readers take no lock: writers replace the file atomically."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except Exception as e:
        _cache_io_error("load", e)
        return None


#: serializes this process's read-modify-writes (the file lock below
#: serializes processes)
_JSON_CACHE_THREAD_LOCK = threading.Lock()


def _json_cache_update(path, mutate) -> None:
    """Locked, atomic read-modify-write of a small JSON cache file:
    `mutate(data) -> data` transforms the loaded dict (``{}`` when the
    file is missing or corrupt), under this process's lock and an
    ``flock`` on ``<path>.lock``, and the result is published with
    :func:`utils.durable.publish_json`, so concurrent writers never drop
    each other's entries and readers never see a torn file.  Every
    failure is reported (:func:`_cache_io_error`) and swallowed: cache IO
    never breaks a tune or a dispatch."""
    import fcntl

    from splatt_tpu_torch.utils.durable import publish_json

    path = pathlib.Path(path)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with _JSON_CACHE_THREAD_LOCK, open(str(path) + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                with open(path) as f:
                    data = json.load(f)
            except FileNotFoundError:
                data = {}
            except Exception as e:
                # corrupt: replaced whole below, which drops its entries
                _cache_io_error("store", e)
                data = {}
            publish_json(path, mutate(data), indent=1, sort_keys=True)
    except Exception as e:
        _cache_io_error("store", e)


#: in-process memo of resolved entries, (cache file, env key, entry key)
#: -> entry dict | False (a miss).  Dispatch consults the cache on every
#: MTTKRP call, so a warm lookup is one dict hit.  Its lock guards every
#: mutation; under SPLATT_LOCKCHECK both become ownership-asserting
#: proxies (utils/lockcheck.py)
_MEM_LOCK = _lockcheck.guard_lock(threading.Lock())
_MEM: dict = _lockcheck.guard({}, _MEM_LOCK, "tune._MEM")
_MISS = object()
#: bumped by every reset and store, so a memo derived from this one (the
#: dispatch's per-layout answer, ``ops/mttkrp._tuned_plan_for``) can tell
#: that it may be stale
_generation = 0


def reset_memo() -> None:
    """Forget memoized cache entries (tests; a re-tune in process)."""
    global _generation
    with _MEM_LOCK:
        _MEM.clear()
        _generation += 1


def memo_generation() -> int:
    """The memo's generation: it changes whenever a memoized answer
    may have changed (:func:`reset_memo`, a store)."""
    return _generation


def _load_file() -> Optional[dict]:
    """The cache file's content, or None when it is missing, unreadable
    (reported) or of another schema generation (re-tuned)."""
    data = _json_cache_load(cache_path())
    if not isinstance(data, dict) \
            or data.get("version") != PLAN_CACHE_VERSION:
        return None
    return data


def _entry_get(key: str, device=None) -> Optional[dict]:
    """One cache entry (plan or negative) of `device`'s environment, with
    TTL expiry, memoized per (file, environment)."""
    env_key = _cache_env_key(device)
    memo_key = (str(cache_path()), env_key, key)
    with _MEM_LOCK:
        hit = _MEM.get(memo_key, _MISS)
    if hit is not _MISS:
        return hit if hit is not False else None
    entry = None
    data = _load_file()
    if data is not None:
        try:
            entry = data.get("envs", {}).get(env_key, {}).get(key)
            if entry is not None:
                ttl = probe_cache_ttl()
                if ttl > 0 and time.time() - float(entry.get("ts", 0)) > ttl:
                    entry = None  # expired: re-earn the plan
        except (AttributeError, TypeError, ValueError) as e:
            _cache_io_error("load", e)
            entry = None
    with _MEM_LOCK:
        # a concurrent store may have landed since our read: adopt it
        # rather than memoize our older miss over it
        cur = _MEM.get(memo_key, _MISS)
        if cur is _MISS:
            _MEM[memo_key] = entry if entry is not None else False
        else:
            entry = cur if cur is not False else None
    return entry


def _entry_store(key: str, value: dict, device=None) -> None:
    """Persist one entry in `device`'s environment (a locked atomic
    read-modify-write) and write it through to the memo."""
    entry = dict(value, ts=time.time())
    env_key = _cache_env_key(device)

    def mutate(data):
        if data.get("version") != PLAN_CACHE_VERSION:
            # new or foreign-generation file: start this schema
            data.clear()
            data["version"] = PLAN_CACHE_VERSION
        data.setdefault("envs", {}).setdefault(env_key, {})[key] = entry
        return data

    _json_cache_update(cache_path(), mutate)
    global _generation
    with _MEM_LOCK:
        _MEM[(str(cache_path()), env_key, key)] = entry
        _generation += 1


def cached_plan(dims: Sequence[int], nnz: int, mode: int, rank: int,
                dtype, skew: str = "", mode_density: str = "",
                device=None) -> Optional[TunedPlan]:
    """The persisted winning plan of this dispatch site on `device`, or
    None (never tuned, expired, negative only, unreadable, or an entry
    with fields the schema does not declare)."""
    entry = _entry_get(plan_key(dims, nnz, mode, rank, dtype, skew=skew,
                                mode_density=mode_density), device)
    if not entry or "plan" not in entry:
        return None
    p = entry["plan"]
    unknown = set(p) - set(PLAN_SCHEMA["fields"])
    if unknown:
        _cache_io_error("load", ValueError(
            f"plan entry carries undeclared fields {sorted(unknown)}"))
        return None
    try:
        return TunedPlan(path=str(p["path"]), engine=str(p["engine"]),
                         nnz_block=int(p["nnz_block"]),
                         scan_target=int(p["scan_target"]),
                         sec=float(p.get("sec", 0.0)),
                         idx_width=str(p.get("idx_width", "i32")),
                         val_storage=str(p.get("val_storage", "auto")),
                         packing=str(p.get("packing", "fixed")),
                         reorder=str(p.get("reorder", "identity")))
    except (KeyError, TypeError, ValueError) as e:
        _cache_io_error("load", e)
        return None


def tuned_build_for(tt, rank: int, dtype,
                    device=None) -> Dict[int, TunedPlan]:
    """Each mode's cached plan on `device`, which
    :meth:`BlockedSparse.compile` builds the layouts at.  Takes the COO
    tensor: the keys' skew component needs its mode histograms."""
    from splatt_tpu_torch.blocked import mode_density_bucket

    out = {}
    for m in range(tt.nmodes):
        plan = cached_plan(tt.dims, tt.nnz, m, rank, dtype,
                           skew=skew_of(tt, m),
                           mode_density=mode_density_bucket(tt.dims, m,
                                                            tt.nnz),
                           device=device)
        if plan is not None:
            out[m] = plan
    return out


def tuned_blocks_for(tt, rank: int, dtype, device=None) -> Dict[int, int]:
    """Each mode's tuned nnz_block (the block-only view of
    :func:`tuned_build_for`)."""
    return {m: p.nnz_block
            for m, p in tuned_build_for(tt, rank, dtype, device).items()}


def batched_block_for(dims: Sequence[int], nnz: int, mode: int,
                      rank: Optional[int], dtype, k: int,
                      autotune: Optional[bool] = None,
                      device=None) -> Optional[int]:
    """The tuned ``nnz_block`` of a batched dispatch of `k` same-regime
    tensors on `device` (≙ splatt_tpu.tune.batched_block_for), or None,
    when the caller keeps the options' default.  The batch-axis plan key
    comes first (a verdict measured under batching), then the
    single-tensor plan of the same site (the batch multiplies the work
    per block but not its shape).  Without a rank, or with autotune off,
    None without reading the cache."""
    if rank is None or not autotune_enabled(autotune):
        return None
    entry = _entry_get(plan_key(dims, nnz, mode, rank, dtype, batch=k),
                       device)
    if entry and "plan" in entry:
        try:
            return int(entry["plan"]["nnz_block"])
        except (KeyError, TypeError, ValueError) as e:
            _cache_io_error("load", e)
    plan = cached_plan(dims, nnz, mode, rank, dtype, device=device)
    return plan.nnz_block if plan is not None else None


# -- measurement ---------------------------------------------------------------


def _measure_candidate(layout, factors, mode: int, path: str, engine: str,
                       scan_target: int, warm: int = 1,
                       reps: int = 2) -> float:
    """Median seconds of one forced-engine MTTKRP over `layout` after
    `warm` warm-up calls, each call timed by the host clock to a
    ``torch.cuda.synchronize`` of the layout's device (so a card's time
    holds the call's host enqueue, as the JAX package's host fence
    does).  Runs under a ``tune.measure`` span, the deadline watchdog
    (a blown deadline is TIMEOUT: skipped, never persisted) and the
    ``tuner.measure`` and ``engine.<engine>`` fault sites."""
    from splatt_tpu_torch import resilience, trace
    from splatt_tpu_torch.ops.mttkrp import _run_engine
    from splatt_tpu_torch.utils import faults
    from splatt_tpu_torch.utils.env import host_fence

    def call():
        return _run_engine(engine, layout, factors, mode, path,
                           scan_target=scan_target)

    with trace.span("tune.measure", mode=int(mode), path=path,
                    engine=engine, block=int(layout.block),
                    scan_target=int(scan_target)):
        with resilience.deadline("tuner.measure"):
            faults.maybe_fail("tuner.measure")
            faults.maybe_fail(f"engine.{engine}")
            for _ in range(max(warm, 1)):
                host_fence(call())
            times = []
            for _ in range(max(reps, 1)):
                t0 = time.perf_counter()
                host_fence(call())
                times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _format_candidates(opts, dtype) -> List[Tuple[str, str]]:
    """(idx_width, val_storage) candidates: a pinned knob (an Options
    field, or a set SPLATT_IDX_WIDTH / SPLATT_VAL_STORAGE) is measured
    alone; an unpinned index width spans :data:`IDX_CANDIDATES`, an
    unpinned storage "auto", plus "bf16" when computing in f32."""
    from splatt_tpu_torch.config import torch_dtype
    from splatt_tpu_torch.utils.env import env_is_set, read_env

    if opts.idx_width is not None:
        idx = (opts.idx_width,)
    elif env_is_set("SPLATT_IDX_WIDTH"):
        idx = (str(read_env("SPLATT_IDX_WIDTH")),)
    else:
        idx = IDX_CANDIDATES
    if opts.val_storage is not None:
        val = (opts.val_storage,)
    elif env_is_set("SPLATT_VAL_STORAGE"):
        val = (str(read_env("SPLATT_VAL_STORAGE")),)
    elif torch_dtype(dtype) == torch.float32:
        val = ("auto", "bf16")
    else:
        val = ("auto",)
    return [(i, v) for i in idx for v in val]


def _packing_candidates(opts) -> Tuple[str, ...]:
    """A pinned packing (:func:`config.packing_pinned`) alone, else
    :data:`PACKING_CANDIDATES`."""
    from splatt_tpu_torch.config import packing_pinned

    pinned = packing_pinned(opts)
    return (pinned,) if pinned is not None else PACKING_CANDIDATES


def _reorder_candidates(opts) -> Tuple[str, ...]:
    """A pinned reorder (``Options.reorder`` / SPLATT_REORDER) alone,
    else :data:`REORDER_CANDIDATES`."""
    from splatt_tpu_torch.config import resolve_reorder

    pinned = resolve_reorder(opts)
    return (pinned,) if pinned is not None else REORDER_CANDIDATES


def _candidates(layout, factors, mode: int, path: str,
                scan_targets: Sequence[int],
                default_scan: int) -> List[Tuple[str, int]]:
    """(engine, scan_target) candidates of one layout: every engine of
    its live :func:`engine_chain` (demoted engines are never candidates),
    the scan ladder applied to ``xla_scan`` alone."""
    from splatt_tpu_torch.ops.mttkrp import engine_chain

    out = []
    for engine in engine_chain(layout, factors, mode, path):
        if engine == "xla_scan":
            out.extend((engine, int(st)) for st in scan_targets)
        else:
            out.append((engine, int(default_scan)))
    return out


def tune(tt, rank: int, opts=None, modes: Optional[Sequence[int]] = None,
         blocks: Optional[Sequence[int]] = None,
         scan_targets: Optional[Sequence[int]] = None,
         formats: Optional[Sequence[Tuple[str, str]]] = None,
         packings: Optional[Sequence[str]] = None,
         reorders: Optional[Sequence[str]] = None,
         warm: int = 1, reps: int = 2, force: bool = False,
         device=None) -> TuneResult:
    """Tune each mode's MTTKRP plan of `tt` at `rank` on `device` (default
    the card) and persist the winners (≙ splatt_tpu.tune.tune).

    Each reorder recipe's permutation is computed once, on the first
    cache miss; each mode's host sort and sorted copy once per recipe;
    each (block, packing) pair is one build from that copy without its
    ``layout_imbalance`` event; each format is a re-encode of it
    (bf16 storage measured with bf16 factors), and a candidate layout
    that collapsed into a measured one (a clamped block, a degraded
    encode or pack) is measured once.  A cached, unexpired plan answers
    its mode with no measurement (``force`` re-measures); a warm cache
    makes no measurement, permutation or build.  A winner stored at a
    narrower storage dtype is also stored under that dtype's key, and a
    skewed mode's dense winner under the key without skew, where
    dispatch looks them up.  Failure handling: the module docstring."""
    from splatt_tpu_torch import resilience, trace
    from splatt_tpu_torch.blocked import (build_dense_layout, build_layout,
                                          dense_mode_verdict,
                                          layout_sort_order,
                                          mode_density_bucket,
                                          reencode_layout)
    from splatt_tpu_torch.config import (LayoutFormat, Verbosity,
                                         default_opts, resolve_dense,
                                         resolve_dense_threshold,
                                         resolve_device, resolve_dtype,
                                         resolve_storage_dtype)
    from splatt_tpu_torch.coo import SparseTensor
    from splatt_tpu_torch.cpd import init_factors
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import (SCAN_TARGET_ELEMS,
                                             _engine_failure, choose_path)
    from splatt_tpu_torch.reorder import apply_reorder
    from splatt_tpu_torch.utils import faults

    opts = (opts or default_opts()).validate()
    dev = resolve_device(device)
    dtype = resolve_dtype(opts)
    default_scan = SCAN_TARGET_ELEMS
    blocks = tuple(blocks) if blocks else NNZ_BLOCKS
    scan_targets = tuple(scan_targets) if scan_targets else SCAN_TARGETS
    formats = (list(formats) if formats
               else _format_candidates(opts, dtype))
    packings = tuple(packings) if packings else _packing_candidates(opts)
    reorders = tuple(reorders) if reorders else _reorder_candidates(opts)
    modes = range(tt.nmodes) if modes is None else modes
    loud = opts.verbosity >= Verbosity.LOW
    tensors = None
    facs_by_dtype = {}

    def reorder_tensors():
        # built on the first cache miss only, with the kernels' build: a
        # build or load failure raises here, before anything is stored
        nonlocal tensors
        if tensors is None:
            if dev.type == "cuda":
                kernels.load_library()
            tensors = {}
            for how in reorders:
                if how == "identity":
                    tensors[how] = tt
                else:
                    tt_r, rperm = apply_reorder(tt, how)
                    if rperm is not None:
                        tensors[how] = tt_r
                    elif loud:
                        print(f"  tune: reorder recipe {how!r} failed "
                              f"(classified); skipping its candidates")
        return tensors

    def factors_for(storage):
        # timing needs shapes and the dispatch dtype, not the caller's
        # factors; narrow-storage candidates take narrow factors
        if dtype not in facs_by_dtype:
            facs_by_dtype[dtype] = init_factors(
                tt.dims, rank, torch.Generator().manual_seed(0),
                dtype=dtype, device=dev)
        if storage not in facs_by_dtype:
            facs_by_dtype[storage] = [f.to(storage)
                                      for f in facs_by_dtype[dtype]]
        return facs_by_dtype[storage]

    def measure(key, layout, fac, m, path, fmt_tag, label, result):
        """Measure every engine candidate of one layout; returns
        [(sec, engine, scan_target)] of those that ran."""
        kernels.check_operands(layout, fac, m, kernels=path in (
            "sorted_onehot", "privatized", "dense"))
        timed = []
        for engine, st in _candidates(layout, fac, m, path, scan_targets,
                                      default_scan):
            neg_key = _negative_key(key, engine, layout.block, st, fmt_tag)
            if _entry_get(neg_key, dev) is not None:
                result.skipped += 1
                continue

            def attempt(engine=engine, st=st):
                return _measure_candidate(layout, fac, m, path, engine, st,
                                          warm=warm, reps=reps)

            try:
                sec = resilience.retry_transient(attempt,
                                                 label=f"tuner.{engine}")
            except Exception as e:
                if not _engine_failure(e):
                    # a failed build or load, a wrong operand, a sticky
                    # CUDA error: never a verdict on the candidate
                    raise
                cls = resilience.classify_failure(e)
                if cls in (resilience.FailureClass.DETERMINISTIC,
                           resilience.FailureClass.RESOURCE):
                    _entry_store(neg_key, {
                        "state": cls.value,
                        "error": resilience.failure_message(e)[:200]}, dev)
                resilience.run_report().add(
                    "tuner_negative", key=key, engine=engine,
                    block=layout.block, scan_target=st, fmt=fmt_tag,
                    failure_class=cls.value,
                    error=resilience.failure_message(e)[:200])
                result.skipped += 1
                continue
            result.measured += 1
            if loud:
                print(f"  tune mode {m}: {path}/{engine} {label} s{st} "
                      f"{fmt_tag}: {sec:.4f}s")
            timed.append((sec, engine, st))
        return timed

    result = TuneResult(plans={})
    for m in modes:
        skew = skew_of(tt, m)
        md = mode_density_bucket(tt.dims, m, tt.nnz)
        key = plan_key(tt.dims, tt.nnz, m, rank, dtype, skew=skew,
                       mode_density=md)
        if not force:
            plan = cached_plan(tt.dims, tt.nnz, m, rank, dtype, skew=skew,
                               mode_density=md, device=dev)
            trace.metric_inc("splatt_tune_cache_total",
                             outcome="hit" if plan is not None else "miss")
            if plan is not None:
                result.cache_hits += 1
                result.plans[m] = plan
                if loud:
                    print(f"  tune mode {m}: plan cache hit "
                          f"({plan.engine} b{plan.nnz_block} "
                          f"s{plan.scan_target} "
                          f"{plan.idx_width}/{plan.val_storage} "
                          f"{plan.packing}/{plan.reorder}) — "
                          f"skipping measurement")
                continue
        best: Optional[TunedPlan] = None
        seen = set()
        for how, tt_how in reorder_tensors().items():
            # one host sort and gather per mode and recipe serves every
            # block and packing: the builds read the sorted copy in place
            perm = layout_sort_order(tt_how, m, opts.mode_order,
                                     opts.mode_order_custom)
            tt_sorted = SparseTensor(tt_how.inds[:, perm],
                                     tt_how.vals[perm], tt_how.dims)
            for req_block in blocks:
                for pack in packings:
                    base = build_layout(
                        tt_sorted, m, block=int(req_block), val_dtype=dtype,
                        mode_order=opts.mode_order,
                        mode_order_custom=opts.mode_order_custom,
                        device=dev, packing=pack, reorder_label=how,
                        record_stats=False, dense=False,
                        presorted=True)
                    path = choose_path(base, m, opts)
                    for iw, vs in formats:
                        storage = resolve_storage_dtype(vs, dtype)
                        if (iw, vs) == ("i32", "auto"):
                            layout = base
                        else:
                            # a failed v2 encode degrades classified to
                            # v1 inside reencode_layout
                            layout = reencode_layout(
                                base, LayoutFormat(idx=iw, val=vs),
                                val_dtype=(None if storage == dtype
                                           else storage))
                        cand = (layout.block, layout.idx_width,
                                layout.val_storage, layout.packing, how)
                        if cand in seen:
                            continue
                        seen.add(cand)
                        fmt_tag = (f"{layout.idx_width}-"
                                   f"{layout.val_storage}-"
                                   f"{layout.packing}-{how}")
                        for sec, engine, st in measure(
                                key, layout, factors_for(storage), m, path,
                                fmt_tag, f"b{layout.block}", result):
                            if best is None or sec < best.sec:
                                best = TunedPlan(
                                    path=path, engine=engine,
                                    nnz_block=layout.block, scan_target=st,
                                    sec=sec, idx_width=layout.idx_width,
                                    val_storage=layout.val_storage,
                                    packing=layout.packing, reorder=how)
        # dense candidates, where the policy allows and the mode passes
        # the verdict: one tile layout per value storage, identity order
        # (a relabeling moves cells, not density); a failed build
        # degrades classified to "no dense candidates"
        pol = resolve_dense(opts)
        if pol != "off" and dense_mode_verdict(
                tt.dims, m, tt.nnz,
                threshold=resolve_dense_threshold(opts),
                force=(pol == "on")):
            for vs in dict.fromkeys(v for _, v in formats):
                storage = resolve_storage_dtype(vs, dtype)
                try:
                    faults.maybe_fail("format.dense")
                    dlay = build_dense_layout(tt, m, val_dtype=storage,
                                              device=dev)
                except Exception as e:
                    cls = resilience.classify_failure(e)
                    resilience.run_report().add(
                        "format_fallback", mode=m, site="dense",
                        idx_width="dense", failure_class=cls.value,
                        error=resilience.failure_message(e)[:200])
                    continue
                fmt_tag = f"dense-{dlay.val_storage}-fixed-identity"
                for sec, engine, st in measure(
                        key, dlay, factors_for(storage), m, "dense",
                        fmt_tag, f"t{dlay.tile}", result):
                    if best is None or sec < best.sec:
                        best = TunedPlan(
                            path="dense", engine=engine,
                            nnz_block=dlay.tile, scan_target=st, sec=sec,
                            idx_width="dense",
                            val_storage=dlay.val_storage,
                            packing="fixed", reorder="identity")
        if best is None:
            # every candidate failed or was skipped: dispatch keeps the
            # heuristic chain, observably
            resilience.run_report().add("tuner_degraded", mode=m, key=key)
            if loud:
                print(f"  tune mode {m}: no candidate measurable; "
                      f"dispatch keeps the heuristic chain")
            continue
        _entry_store(key, {"plan": dataclasses.asdict(best)}, dev)
        if best.path == "dense" and skew_regime(skew):
            # a dense layout has no nnz stream, so dispatch keys it
            # without the skew bucket
            _entry_store(plan_key(tt.dims, tt.nnz, m, rank, dtype,
                                  mode_density=md),
                         {"plan": dataclasses.asdict(best)}, dev)
        storage = resolve_storage_dtype(best.val_storage, dtype)
        if storage != dtype:
            # dispatch over narrow storage sees narrow factors: alias the
            # plan under that dtype's key
            _entry_store(plan_key(tt.dims, tt.nnz, m, rank, storage,
                                  skew=skew, mode_density=md),
                         {"plan": dataclasses.asdict(best)}, dev)
        result.plans[m] = best
        if loud:
            print(f"  tune mode {m}: winner {best.path}/{best.engine} "
                  f"b{best.nnz_block} s{best.scan_target} "
                  f"{best.idx_width}/{best.val_storage} "
                  f"{best.packing}/{best.reorder} "
                  f"({best.sec:.4f}s)")
    return result
