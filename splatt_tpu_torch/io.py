"""Tensor and matrix file IO (≙ src/io.c), text formats only.

Counterpart of ``splatt_tpu/io.py``: coordinate ``.tns`` files with ``#``
comments and 0/1-index autodetection, the dense matrix and vector
writers of the CPD outputs, and the permutation (partition) reader.  Binary ``.bin`` tensors are not read yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from splatt_tpu_torch.coo import SparseTensor

_BIN_MAGIC = b"SPTT"


def _parse_text(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a coordinate text file into (inds (m, nnz) int64, vals f64)."""
    with open(path, "rb") as f:
        data = f.read()
    body = [ln for ln in data.split(b"\n")
            if ln.strip() and not ln.lstrip().startswith(b"#")]
    if not body:
        raise ValueError(f"{path}: empty tensor file")
    ncols = len(body[0].split())
    try:
        toks = np.array(b" ".join(body).split(), dtype=np.float64)
    except ValueError:
        raise _diagnose_text(path, data, ncols) from None
    if toks.size % ncols != 0:
        raise _diagnose_text(path, data, ncols)
    table = toks.reshape(-1, ncols)
    inds = table[:, :-1].astype(np.int64).T
    vals = np.ascontiguousarray(table[:, -1])
    return np.ascontiguousarray(inds), vals


def _diagnose_text(path: str, data: bytes, ncols: int) -> ValueError:
    """The error naming the first malformed line and its byte offset."""
    offset = 0
    for lineno, ln in enumerate(data.split(b"\n"), start=1):
        stripped = ln.strip()
        if stripped and not stripped.startswith(b"#"):
            toks = stripped.split()
            if len(toks) != ncols:
                return ValueError(
                    f"{path}: ragged row at line {lineno} (file offset "
                    f"{offset}): expected {ncols} columns, got {len(toks)}")
            for t in toks:
                try:
                    float(t)
                except ValueError:
                    return ValueError(
                        f"{path}: bad token "
                        f"{t.decode('utf-8', 'replace')!r} at line "
                        f"{lineno} (file offset {offset})")
        offset += len(ln) + 1
    return ValueError(f"{path}: malformed tensor file")


def load_coord(path: str) -> SparseTensor:
    """Load a coordinate text tensor (≙ tt_read, src/io.c:230-270).

    1-indexed files shift to 0-indexed; a file holding any 0 index is
    read as 0-indexed (≙ tt_get_dims, src/io.c:273-348).
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _BIN_MAGIC:
        raise ValueError(f"{path}: binary tensors are not supported by "
                         f"this port yet; convert it to .tns")
    inds, vals = _parse_text(path)
    if inds.size and inds.min() > 0:
        inds = inds - 1
    if inds.size and inds.min() < 0:
        raise ValueError(f"{path}: negative coordinate in tensor file")
    dims = tuple(int(inds[m].max()) + 1 if inds.shape[1] else 0
                 for m in range(inds.shape[0]))
    return SparseTensor(inds, vals, dims)


load = load_coord


def write_matrix(mat: np.ndarray, path: str) -> None:
    """One row per line, full precision (≙ mat_write)."""
    mat = np.asarray(mat)
    with open(path, "w") as f:
        for row in mat:
            f.write(" ".join(f"{v:.17g}" for v in row))
            f.write("\n")


def write_vector(vec: np.ndarray, path: str) -> None:
    """One value per line, full precision (≙ vec_write)."""
    with open(path, "w") as f:
        for v in np.asarray(vec).ravel():
            f.write(f"{v:.17g}\n")


def read_permutation(path: str) -> np.ndarray:
    """A whitespace-separated integer vector, one entry per line as the
    writer of the JAX package puts it (a per-nonzero partition of the
    FINE decomposition)."""
    with open(path) as f:
        return np.asarray([int(x) for x in f.read().split()], dtype=np.int64)
