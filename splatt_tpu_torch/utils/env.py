"""The one place the port reads the process environment
(≙ splatt_tpu/utils/env.py, cut to the variables the port reads).

Every variable is declared once in :data:`ENV_VARS` (name → default →
doc) with the JAX package's default, and read through :func:`read_env`.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional


class EnvVar(NamedTuple):
    """One declared environment variable: its default (None = unset)
    and a one-line doc string."""

    default: Optional[object]
    doc: str


ENV_VARS = {
    "SPLATT_ENGINE_FALLBACK": EnvVar("1", "runtime MTTKRP engine "
                                     "fallback; 0/off/false/no = fail "
                                     "loudly"),
    "SPLATT_EXPERIMENTAL_FUSED": EnvVar(None, "1 adds the row-major "
                                        "fused kernel (engine 'fused') "
                                        "to the engine chain"),
    "SPLATT_FAULTS": EnvVar("", "comma-separated fault-arming specs "
                            "site[:kind][:modifier]... for the fault-"
                            "injection harness (utils/faults.py)"),
}


def read_env(name: str) -> Optional[object]:
    """A declared variable's process value when set, its registered
    default otherwise.  An undeclared name raises."""
    spec = ENV_VARS.get(name)
    if spec is None:
        raise KeyError(
            f"environment variable {name!r} is not declared in "
            f"splatt_tpu_torch.utils.env.ENV_VARS; register it (with a "
            f"doc string) before reading it")
    raw = os.environ.get(name)
    return spec.default if raw is None else raw
