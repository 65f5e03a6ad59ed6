"""Carry state across from the JAX package as numpy arrays.

The two packages share no objects: a caller hands this module the numpy
arrays of a JAX-built layout (v1, v2 with its per-mode streams and bases,
or a dense mode's value tiles) or of a factorization, and gets the port's
objects on a given device.  :func:`to_numpy` goes the other way.  numpy
has no bfloat16 of its own: a bf16 array (``dtype.name == "bfloat16"``)
stages through f32, which holds every bf16 value exactly, and narrows
back on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from splatt_tpu_torch.blocked import DenseModeLayout, ModeLayout
from splatt_tpu_torch.config import resolve_device
from splatt_tpu_torch.kruskal import KruskalTensor


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A private copy of numpy array `a` on `device`; bf16 stages
    through f32 (exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def kruskal_from_numpy(factors: Sequence[np.ndarray], lam: np.ndarray,
                       fit: float = float("nan"),
                       device=None) -> KruskalTensor:
    """Factor matrices ``(dim_m, R)`` and λ ``(R,)`` → KruskalTensor on
    `device` (default: the card)."""
    device = resolve_device(device)
    return KruskalTensor(
        factors=[tensor_from_numpy(U, device) for U in factors],
        lam=tensor_from_numpy(lam, device), fit=float(fit))


def layout_from_numpy(inds, vals: np.ndarray, row_start: np.ndarray, *,
                      mode: int, dim: int, block: int, seg_width: int,
                      nnz: int, base: Optional[Sequence] = None,
                      idx_width: str = "i32", val_storage: str = "auto",
                      device=None) -> ModeLayout:
    """A layout's arrays and metadata → ModeLayout on `device` (default:
    the card).  v1: ``inds (nmodes, nnz_pad)`` int32 and no `base`.  v2:
    `inds` and `base` are per-mode sequences of the encoded streams (at
    their stored widths) and the (nb,) int32 bases, `idx_width` the
    policy they were encoded under.  ``vals (nnz_pad,)``, ``row_start
    (nb,)`` int32."""
    device = resolve_device(device)
    row_start = np.array(row_start, dtype=np.int32, order="C")
    vals = tensor_from_numpy(vals, device)
    nb = row_start.shape[0]
    if vals.shape[0] != nb * block:
        raise ValueError(f"{vals.shape[0]} entries are not {nb} blocks "
                         f"of {block}")
    if base is None:
        inds = np.array(inds, dtype=np.int32, order="C")
        if inds.ndim != 2 or inds.shape[1] != vals.shape[0]:
            raise ValueError(f"inds {inds.shape} and vals "
                             f"{tuple(vals.shape)} disagree")
        inds = torch.from_numpy(inds).to(device)
        idx_width = "i32"
    else:
        if len(inds) != len(base):
            raise ValueError(f"{len(inds)} streams and {len(base)} bases")
        inds = tuple(tensor_from_numpy(s, device) for s in inds)
        base = tuple(torch.from_numpy(np.array(b, dtype=np.int32,
                                               order="C")).to(device)
                     for b in base)
    return ModeLayout(inds=inds, vals=vals,
                      row_start=torch.from_numpy(row_start).to(device),
                      mode=int(mode), dim=int(dim), block=int(block),
                      seg_width=int(seg_width), nnz=int(nnz), base=base,
                      idx_width=idx_width, val_storage=val_storage)


def dense_layout_from_numpy(tiles, mask, *, mode: int, dims: Sequence[int],
                            nnz: int, val_storage: str = "auto",
                            device=None) -> DenseModeLayout:
    """A dense layout's ``(ntiles, tile, span)`` value tiles, its
    ``(span,)`` mask and metadata → DenseModeLayout on `device` (default:
    the card); bf16 tiles stage through f32, and tiles under
    ``val_storage="bf16"`` are stored in bf16."""
    device = resolve_device(device)
    tiles = tensor_from_numpy(tiles, device)
    if val_storage == "bf16":
        tiles = tiles.to(torch.bfloat16)
    mask = torch.from_numpy(np.array(mask, dtype=bool, order="C")).to(device)
    if tiles.dim() != 3 or tuple(mask.shape) != (tiles.shape[2],):
        raise ValueError(f"tiles {tuple(tiles.shape)} and mask "
                         f"{tuple(mask.shape)} disagree")
    return DenseModeLayout(tiles=tiles, mask=mask, mode=int(mode),
                           dims=tuple(int(d) for d in dims), nnz=int(nnz),
                           val_storage=val_storage)


def to_numpy(x):
    """Tensors, lists of them, KruskalTensors and layouts → numpy
    (dataclasses become dicts of their fields; bf16 widens to f32)."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x
