"""Run-time options and the dtype and device policy of the PyTorch port.

Counterpart of ``splatt_tpu/config.py``, cut to the fields the single-device
CPD-ALS path reads.  The defaults are the same (≙ splatt_default_opts,
SPLATT's opts.c).  No field is read from the environment; a field left
None (``engine_fallback``) defers to the env default its consumer reads
(``utils/env.py``).
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


class Verbosity(enum.IntEnum):
    """≙ SPLATT_VERBOSITY_{NONE,LOW,HIGH,MAX} (types_config.h:143-149)."""

    NONE = 0
    LOW = 1
    HIGH = 2
    MAX = 3


@dataclasses.dataclass
class Options:
    """Run-time options (≙ splatt_default_opts)."""

    tolerance: float = 1e-5
    max_iterations: int = 50
    regularization: float = 0.0
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

    def validate(self) -> "Options":
        if self.tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {self.tolerance}")
        if self.max_iterations < 0:
            raise ValueError(
                f"max_iterations must be >= 0, got {self.max_iterations}")
        if self.regularization < 0:
            raise ValueError(
                f"regularization must be >= 0, got {self.regularization}")
        if self.nnz_block < 1:
            raise ValueError(f"nnz_block must be >= 1, got {self.nnz_block}")
        if self.priv_threshold < 0:
            raise ValueError(
                f"priv_threshold must be >= 0, got {self.priv_threshold}")
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
