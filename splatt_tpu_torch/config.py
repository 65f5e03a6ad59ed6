"""Run-time options and the dtype and device policy of the PyTorch port.

Counterpart of ``splatt_tpu/config.py``, cut to the fields the single-device
CPD-ALS path and the distributed paths read.  The defaults are the
same (≙ splatt_default_opts, SPLATT's opts.c).  No field is read from the
environment; a field left None (``engine_fallback``, ``idx_width``,
``val_storage``, ``fiber_packing``, ``reorder``, ``dense``,
``dense_threshold``, ``comm_pattern``, ``autotune``) defers to the env default its
consumer reads (``utils/env.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

# ≙ SPLATT_MAX_NMODES (include/splatt/constants.h:14-16)
MAX_NMODES = 8


class BlockAlloc(enum.Enum):
    """How many per-mode sorted layouts to build (≙ csf allocation)."""

    ONEMODE = "onemode"    # one layout (sorted for the smallest mode)
    TWOMODE = "twomode"    # smallest mode + largest mode layouts
    ALLMODE = "allmode"    # one layout per mode


class ModeOrder(enum.Enum):
    """Order of the non-output modes inside a layout (≙ csf_find_mode_order).

    The output mode is always the primary sort key; SMALLFIRST sorts the
    rest by ascending dim and equals SORTED_MINUSONE.
    """

    SMALLFIRST = "smallfirst"
    BIGFIRST = "bigfirst"
    INORDER_MINUSONE = "inorder_minusone"
    SORTED_MINUSONE = "sorted_minusone"
    CUSTOM = "custom"


class Decomposition(enum.Enum):
    """Distributed decomposition (≙ types_config.h:179-190)."""

    COARSE = "coarse"   # 1-D per mode
    MEDIUM = "medium"   # n-D cartesian grid (the default)
    FINE = "fine"       # nonzero-level partition


class CommPattern(enum.Enum):
    """Row-exchange pattern of the FINE decomposition
    (≙ types_config.h:197-201).

    ALL2ALL (default): every rank gathers whole factors and reduces a
    whole (dim_pad, R) partial.  POINT2POINT: the sync ring
    (``parallel/ring.py``), factor blocks travel rank to rank, so no rank
    holds a whole factor.  ASYNC_RING: the same ring as one kernel
    launch per ring phase on the card (``parallel/ring_kernels.py``),
    the next block landing in a neighbour's double buffer while the
    current one is consumed.
    """

    ALL2ALL = "all2all"
    POINT2POINT = "point2point"
    ASYNC_RING = "async_ring"


def resolve_comm_pattern(opts: "Options") -> CommPattern:
    """The comm strategy of a distributed run: ``Options.comm_pattern``
    wins, else the ``SPLATT_COMM`` env default, else ALL2ALL."""
    from splatt_tpu_torch.utils.env import read_env

    if opts.comm_pattern is not None:
        return opts.comm_pattern
    env = str(read_env("SPLATT_COMM") or "").strip().lower()
    if env:
        try:
            return CommPattern(env)
        except ValueError:
            raise ValueError(
                f"SPLATT_COMM must be one of "
                f"{[c.value for c in CommPattern]}, got {env!r}")
    return CommPattern.ALL2ALL


class Verbosity(enum.IntEnum):
    """≙ SPLATT_VERBOSITY_{NONE,LOW,HIGH,MAX} (types_config.h:143-149)."""

    NONE = 0
    LOW = 1
    HIGH = 2
    MAX = 3


# -- compact blocked format v2 (≙ splatt_tpu/config.py:122-354) -------------
#
# "i32" keeps the v1 global-int32 layout; every other index width is the
# v2 encoding: per-block local ids at the narrowest width that fits, plus
# per-block int32 bases, the sorted mode's stream holding segment ids.
# "u8" narrows the sorted mode's segment ids to uint8, "delta" stores the
# gather modes as within-block differences, "rle" replaces the sorted
# mode's stream with per-block run-length counts.  Value storage "bf16"
# stores the values, and so the factors, in bfloat16 with f32
# accumulation.

#: legal index-width policies (SPLATT_IDX_WIDTH / Options.idx_width)
IDX_WIDTHS = ("i32", "auto", "u16", "u8", "delta", "rle")

#: legal decode-placement policies (SPLATT_DECODE): "kernel" lets the
#: fused_v2 engine read the encoded streams; "prep" decodes to global
#: int32 before any engine runs
DECODES = ("kernel", "prep")

#: legal value-storage policies (SPLATT_VAL_STORAGE /
#: Options.val_storage); "auto" = the resolved compute dtype
VAL_STORAGES = ("auto", "f32", "bf16")


#: legal fiber-packing policies (SPLATT_FIBER_PACKING /
#: Options.fiber_packing, docs/layout-balance.md): "fixed" cuts the sorted
#: stream every nnz_block nonzeros; "balanced" cuts it at fiber boundaries
#: under a row-span cap, splitting fibers hotter than a block, so one
#: block landing on a run of tiny fibers cannot widen seg_width for every
#: block (≙ the chains-on-chains partitioner,
#: src/thread_partition.c:156-195)
PACKINGS = ("fixed", "balanced")

#: legal reorder policies (SPLATT_REORDER / Options.reorder): "identity"
#: keeps the tensor's labels; the others are the relabelings of
#: ``reorder.py`` (≙ splatt_perm_type, src/reorder.h:15-22).  One
#: permutation relabels every mode before the layouts are built, and
#: cpd_als returns the factors in the original row order.
REORDERS = ("identity", "random", "graph", "hgraph", "fibsched")


def resolve_packing(opts: "Options") -> str:
    """The fiber-packing policy of a run: ``Options.fiber_packing`` wins,
    else SPLATT_FIBER_PACKING (default "fixed")."""
    from splatt_tpu_torch.utils.env import read_env

    pol = (opts.fiber_packing if opts.fiber_packing is not None
           else str(read_env("SPLATT_FIBER_PACKING")))
    if pol not in PACKINGS:
        raise ValueError(
            f"fiber_packing must be one of {PACKINGS}, got {pol!r}")
    return pol


def packing_pinned(opts: "Options") -> Optional[str]:
    """The packing the user pinned: a set ``Options.fiber_packing`` or a
    set SPLATT_FIBER_PACKING, checked through :func:`resolve_packing`;
    None when the knob is left to the tuner (≙ splatt_tpu.config.
    packing_pinned).  A pinned packing beats a cached tuned one: the
    tuner measures it alone, and ``BlockedSparse.compile`` drops plans
    measured under the other."""
    from splatt_tpu_torch.utils.env import env_is_set

    if opts.fiber_packing is None and not env_is_set("SPLATT_FIBER_PACKING"):
        return None
    return resolve_packing(opts)


def resolve_reorder(opts: "Options") -> Optional[str]:
    """The pinned reorder policy: ``Options.reorder`` wins, else a
    non-empty SPLATT_REORDER; None when neither is set (then
    ``BlockedSparse.compile`` keeps the identity)."""
    from splatt_tpu_torch.utils.env import read_env

    how = opts.reorder
    if how is None:
        env = str(read_env("SPLATT_REORDER") or "").strip().lower()
        how = env or None
    if how is not None and how not in REORDERS:
        raise ValueError(
            f"reorder must be one of {REORDERS}, got {how!r}")
    return how


def resolve_decode() -> str:
    """The decode-placement policy from SPLATT_DECODE (default
    "kernel"); "prep" makes dispatch decode a compact layout to v1
    before the chain, and fused_v2 leaves it."""
    from splatt_tpu_torch.utils.env import read_env

    pol = str(read_env("SPLATT_DECODE"))
    if pol not in DECODES:
        raise ValueError(
            f"SPLATT_DECODE must be one of {DECODES}, got {pol!r}")
    return pol


@dataclasses.dataclass(frozen=True)
class LayoutFormat:
    """One blocked-layout encoding request: index width x value
    storage.  ``idx`` "i32" is the v1 global encoding; "auto" encodes v2
    local ids at the narrowest width that fits each mode (uint16 where
    possible, int32 otherwise); "u16" requires uint16 everywhere (a mode
    that does not fit is an encode failure, degraded to v1).  ``val``
    picks the stored value dtype ("auto" = compute dtype)."""

    idx: str = "i32"
    val: str = "auto"

    def validate(self) -> "LayoutFormat":
        if self.idx not in IDX_WIDTHS:
            raise ValueError(
                f"idx_width must be one of {IDX_WIDTHS}, got {self.idx!r}")
        if self.val not in VAL_STORAGES:
            raise ValueError(
                f"val_storage must be one of {VAL_STORAGES}, "
                f"got {self.val!r}")
        return self

    @property
    def v2(self) -> bool:
        return self.idx != "i32"


def layout_format(opts: "Options") -> LayoutFormat:
    """The layout format of a run: the Options fields win, else the
    SPLATT_IDX_WIDTH / SPLATT_VAL_STORAGE env defaults (v1 i32 ids,
    compute-dtype values)."""
    from splatt_tpu_torch.utils.env import read_env

    idx = opts.idx_width if opts.idx_width is not None \
        else str(read_env("SPLATT_IDX_WIDTH"))
    val = opts.val_storage if opts.val_storage is not None \
        else str(read_env("SPLATT_VAL_STORAGE"))
    return LayoutFormat(idx=idx, val=val).validate()


def resolve_storage_dtype(val_storage: str, compute_dtype) -> torch.dtype:
    """The dtype layout values are stored at: "auto" keeps the compute
    dtype, "f32"/"bf16" pin it."""
    if val_storage == "bf16":
        return torch.bfloat16
    if val_storage == "f32":
        return torch.float32
    return torch_dtype(compute_dtype)


#: legal dense-mode policies (SPLATT_DENSE / Options.dense, docs/dense.md):
#: "off" keeps every mode on the sparse blocked encodings (the default);
#: "auto" switches a mode to the dense tile layout when its padded fiber
#: density meets the threshold; "on" forces it for every mode that is
#: feasible to tile (the blowup cap still applies)
DENSE_POLICIES = ("off", "auto", "on")

#: default padded-density threshold of the dense-mode verdict
#: (SPLATT_DENSE_THRESHOLD / Options.dense_threshold)
DENSE_THRESHOLD_DEFAULT = 0.05


def resolve_dense(opts: "Options") -> str:
    """The dense-mode policy: the Options field wins, else SPLATT_DENSE
    (default "off": dense tiling is opt-in)."""
    from splatt_tpu_torch.utils.env import read_env

    pol = (opts.dense if opts.dense is not None
           else str(read_env("SPLATT_DENSE")))
    if pol not in DENSE_POLICIES:
        raise ValueError(
            f"dense must be one of {DENSE_POLICIES}, got {pol!r}")
    return pol


def resolve_dense_threshold(opts: "Options") -> float:
    """The dense verdict's padded-density threshold: the Options field
    wins, else SPLATT_DENSE_THRESHOLD (default
    :data:`DENSE_THRESHOLD_DEFAULT`)."""
    from splatt_tpu_torch.utils.env import read_env_float

    thr = (opts.dense_threshold if opts.dense_threshold is not None
           else read_env_float("SPLATT_DENSE_THRESHOLD"))
    if not 0.0 < thr <= 1.0:
        raise ValueError(
            f"dense_threshold must lie in (0, 1], got {thr!r}")
    return thr


def fit_dtype() -> torch.dtype:
    """The dtype of λ and the fit: f32 even under bf16 storage (the
    MTTKRP, the solve and the normalization accumulate in f32)."""
    return torch.float32


@dataclasses.dataclass
class Options:
    """Run-time options (≙ splatt_default_opts)."""

    tolerance: float = 1e-5
    max_iterations: int = 50
    regularization: float = 0.0
    # fetch the fit (and test convergence) every k iterations; the fit is
    # computed on the card every sweep, k > 1 only batches the host
    # syncs.  k = 1 is the reference's semantics (src/cpd.c:357-370)
    fit_check_every: int = 1
    # None ≙ seed-from-time, pinned on first use by seed()
    random_seed: Optional[int] = None
    verbosity: Verbosity = Verbosity.LOW
    block_alloc: BlockAlloc = BlockAlloc.TWOMODE
    nnz_block: int = 4096
    mode_order: ModeOrder = ModeOrder.SMALLFIRST
    mode_order_custom: Optional[tuple] = None
    # a mode without its own layout is "privatized" (one (width, R)
    # accumulator for all blocks) when dim <= priv_threshold * nnz and
    # dim + 16 <= priv_cap
    priv_threshold: float = 0.02
    priv_cap: int = 4096
    # widest block row span the sorted per-block reduction takes
    onehot_cap: int = 1024
    # compute dtype of values and factors; None = float32
    val_dtype: Optional[object] = None
    # runtime MTTKRP engine fallback (a failing engine is demoted and the
    # next one in the chain runs); None = SPLATT_ENGINE_FALLBACK
    engine_fallback: Optional[bool] = None
    # compact blocked format v2: index width (IDX_WIDTHS) and value
    # storage (VAL_STORAGES); None = SPLATT_IDX_WIDTH / SPLATT_VAL_STORAGE
    idx_width: Optional[str] = None
    val_storage: Optional[str] = None
    # load-balanced layouts: the fiber packing (PACKINGS; None =
    # SPLATT_FIBER_PACKING) and the relabeling applied before the layouts
    # are built (REORDERS; None = SPLATT_REORDER, else identity)
    fiber_packing: Optional[str] = None
    reorder: Optional[str] = None
    # dense-mode tile layouts (DENSE_POLICIES) and the padded-density
    # threshold of their verdict; None = SPLATT_DENSE /
    # SPLATT_DENSE_THRESHOLD
    dense: Optional[str] = None
    dense_threshold: Optional[float] = None
    # distributed decomposition, and the FINE row-exchange strategy
    # (None = SPLATT_COMM, else ALL2ALL; resolve_comm_pattern)
    decomposition: Decomposition = Decomposition.MEDIUM
    comm_pattern: Optional[CommPattern] = None
    # the autotuner (tune.py): when on, MTTKRP dispatch consults the plan
    # cache before the heuristic engine chain and BlockedSparse.compile
    # builds the layouts at the cached plans; None = SPLATT_AUTOTUNE (on
    # unless 0/off/false/no), False pins the static heuristics.  Only
    # tune.tune() (the tune and bench verbs) measures
    autotune: Optional[bool] = None
    # structured span tracing (trace.py): None = the process/env default
    # (SPLATT_TRACE, off); True records the run's host-side spans, False
    # pins tracing off for this run.  Event metrics are always on
    trace: Optional[bool] = None

    def validate(self) -> "Options":
        if self.tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {self.tolerance}")
        if self.max_iterations < 0:
            raise ValueError(
                f"max_iterations must be >= 0, got {self.max_iterations}")
        if self.regularization < 0:
            raise ValueError(
                f"regularization must be >= 0, got {self.regularization}")
        if self.fit_check_every < 1:
            raise ValueError(
                f"fit_check_every must be >= 1, got {self.fit_check_every}")
        if self.nnz_block < 1:
            raise ValueError(f"nnz_block must be >= 1, got {self.nnz_block}")
        if self.priv_threshold < 0:
            raise ValueError(
                f"priv_threshold must be >= 0, got {self.priv_threshold}")
        if self.idx_width is not None and self.idx_width not in IDX_WIDTHS:
            raise ValueError(
                f"idx_width must be one of {IDX_WIDTHS}, "
                f"got {self.idx_width!r}")
        if (self.val_storage is not None
                and self.val_storage not in VAL_STORAGES):
            raise ValueError(
                f"val_storage must be one of {VAL_STORAGES}, "
                f"got {self.val_storage!r}")
        if (self.fiber_packing is not None
                and self.fiber_packing not in PACKINGS):
            raise ValueError(
                f"fiber_packing must be one of {PACKINGS}, "
                f"got {self.fiber_packing!r}")
        if self.reorder is not None and self.reorder not in REORDERS:
            raise ValueError(
                f"reorder must be one of {REORDERS}, got {self.reorder!r}")
        if self.dense is not None and self.dense not in DENSE_POLICIES:
            raise ValueError(
                f"dense must be one of {DENSE_POLICIES}, got {self.dense!r}")
        if (self.dense_threshold is not None
                and not 0.0 < self.dense_threshold <= 1.0):
            raise ValueError(
                f"dense_threshold must lie in (0, 1], "
                f"got {self.dense_threshold!r}")
        if not isinstance(self.decomposition, Decomposition):
            raise TypeError(f"decomposition must be a Decomposition, got "
                            f"{self.decomposition!r}")
        if (self.comm_pattern is not None
                and not isinstance(self.comm_pattern, CommPattern)):
            raise TypeError(f"comm_pattern must be a CommPattern or None, "
                            f"got {self.comm_pattern!r}")
        if self.val_dtype is not None and not torch_dtype(
                self.val_dtype).is_floating_point:
            raise ValueError(
                f"val_dtype must be a floating dtype, got {self.val_dtype}")
        return self

    def seed(self) -> int:
        """Resolve (and pin) the RNG seed, time-based when unset."""
        if self.random_seed is None:
            import time

            self.random_seed = int(time.time()) & 0x7FFFFFFF
        return int(self.random_seed)


def default_opts() -> Options:
    return Options()


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def acc_dtype(dtype) -> torch.dtype:
    """Reductions over bf16/f16 accumulate in f32; every other dtype
    accumulates in itself (≙ splatt_tpu.config.acc_dtype)."""
    dtype = torch_dtype(dtype)
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def resolve_dtype(opts: Options) -> torch.dtype:
    """The compute dtype: ``opts.val_dtype`` when set, else float32."""
    if opts.val_dtype is None:
        return torch.float32
    return torch_dtype(opts.val_dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  Asking for CUDA where there is none raises; nothing
    falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
