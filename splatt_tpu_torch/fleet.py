"""Fleet helpers the single-replica serve daemon needs
(≙ splatt_tpu/fleet.py:428-461).

:func:`job_regime` is a job spec's shape-regime key, the key the daemon
coalesces same-regime jobs by (``serve --batch-min``); :func:`_safe_name`
checks that a name is safe as a file name.  Fleet membership (leases,
heartbeats, adoption, affinity routing) is the next step of the port
(ROADMAP queue A item 15.2).
"""

from __future__ import annotations

import re
from typing import Optional

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def _safe_name(name: str) -> str:
    """`name`, when it is safe as a file name; else ValueError."""
    if not _NAME_RE.match(name):
        raise ValueError(
            f"fleet name {name!r} is not filesystem-safe (want "
            f"[A-Za-z0-9][A-Za-z0-9._-]*, max 64 chars)")
    return name


def job_regime(spec: dict) -> Optional[str]:
    """The shape-regime key of a job spec: the plan cache's granularity
    (power-of-two dim and nnz buckets, :func:`tune.shape_regime`) and the
    rank, so "same regime" means "hits the same warm plans".  File-tensor
    jobs give None (the shape is unknown without loading), and so do
    predicts, which are never coalesced."""
    if str(spec.get("kind") or "cpd") == "predict":
        return None
    syn = spec.get("synthetic")
    if not isinstance(syn, dict) or not syn.get("dims"):
        return None
    from splatt_tpu_torch.tune import shape_regime

    try:
        dims = [int(d) for d in syn["dims"]]
        nnz = int(syn.get("nnz", 1000))
        rank = int(spec.get("rank", 8))
    except (TypeError, ValueError):
        return None
    return f"{shape_regime(dims, nnz)}:r{rank}"
