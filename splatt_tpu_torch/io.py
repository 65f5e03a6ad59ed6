"""Tensor and matrix file IO (≙ src/io.c).

Counterpart of ``splatt_tpu/io.py``, byte for byte in the binary format:

- text coordinate ``.tns`` files: whitespace-separated indices and a
  value, ``#`` comments, 0/1-index autodetection (≙ tt_get_dims,
  src/io.c:273-348);
- binary ``.bin`` files: the magic ``SPTT``, a header of version, mode
  count and index and value widths (little-endian u32), the dims and the
  nonzero count (u64), then each mode's indices (int32 when every index
  fits, else int64) and the values (≙ bin_header, src/io.h:82-87, the
  writer src/io.c:118-150).  :func:`load` tells the two apart by the
  magic, :func:`save` by the extension; :func:`load_memmap` maps a
  ``.bin`` file without reading it.

Text is parsed by the native parser (``native.parse_tns``) where its
library builds; a malformed file is parsed again in Python for the error
that names the line, and without the library the Python pass parses.  A
tensor larger than the host's memory goes text to ``.bin`` through
``native.stream_to_bin`` (the ``convert ... bin`` verb), then
:func:`load_memmap` maps it.

Also the writers and readers of dense matrices, vectors and permutation
files.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from splatt_tpu_torch.coo import SparseTensor

# binary format: magic, then version, nmodes, index and value widths in
# bytes (u32), dims[nmodes] (u64), nnz (u64), the indices mode by mode,
# the values
_BIN_MAGIC = b"SPTT"
_BIN_VERSION = 1


def _parse_text(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a coordinate text file into (inds (m, nnz) int64, vals f64):
    the native parser first; on its ValueError the Python pass runs for
    the error naming the line."""
    from splatt_tpu_torch import native

    try:
        parsed = native.parse_tns(path)
    except ValueError:
        with open(path, "rb") as f:
            data = f.read()
        first = next((ln for ln in data.split(b"\n")
                      if ln.strip() and not ln.lstrip().startswith(b"#")),
                     b"")
        raise _diagnose_text(path, data, len(first.split())) from None
    return parsed if parsed is not None else parse_text_python(path)


def parse_text_python(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The Python parse of :func:`_parse_text`: one vectorized pass over
    the whole file, and on a malformed file the error naming the first
    bad line and its byte offset."""
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
    """Load a coordinate tensor, binary or text by its first four bytes
    (≙ tt_read, src/io.c:230-270).

    Text: 1-indexed files shift to 0-indexed; a file holding any 0 index
    is read as 0-indexed (≙ tt_get_dims, src/io.c:273-348).
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _BIN_MAGIC:
        return _load_binary(path)
    inds, vals = _parse_text(path)
    if inds.size and inds.min() > 0:
        inds = inds - 1
    if inds.size and inds.min() < 0:
        raise ValueError(f"{path}: negative coordinate in tensor file")
    dims = tuple(int(inds[m].max()) + 1 if inds.shape[1] else 0
                 for m in range(inds.shape[0]))
    return SparseTensor(inds, vals, dims)


load = load_coord


def save(tt: SparseTensor, path: str, binary: Optional[bool] = None,
         one_indexed: bool = True) -> None:
    """Write a tensor as text, or as binary for a ``.bin`` path (or
    `binary`)."""
    if binary is None:
        binary = path.endswith(".bin")
    if binary:
        _save_binary(tt, path)
    else:
        _save_text(tt, path, one_indexed=one_indexed)


def _save_text(tt: SparseTensor, path: str, one_indexed: bool = True) -> None:
    shift = 1 if one_indexed else 0
    cols = [tt.inds[m] + shift for m in range(tt.nmodes)]
    with open(path, "w") as f:
        for row in zip(*cols, tt.vals):
            f.write(" ".join(str(int(x)) for x in row[:-1]))
            f.write(f" {row[-1]:.17g}\n")


def _save_binary(tt: SparseTensor, path: str) -> None:
    # 32-bit indices whenever that is lossless (≙ src/io.c:118-150)
    idx_width = 4 if (tt.nnz == 0 or tt.inds.max() < 2**31) else 8
    val_width = tt.vals.dtype.itemsize
    with open(path, "wb") as f:
        f.write(_BIN_MAGIC)
        f.write(struct.pack("<IIII", _BIN_VERSION, tt.nmodes, idx_width,
                            val_width))
        f.write(np.asarray(tt.dims, dtype=np.uint64).tobytes())
        f.write(struct.pack("<Q", tt.nnz))
        idt = np.int32 if idx_width == 4 else np.int64
        for m in range(tt.nmodes):
            f.write(np.ascontiguousarray(tt.inds[m], dtype=idt).tobytes())
        f.write(np.ascontiguousarray(tt.vals).tobytes())


def _bin_header(path: str):
    """Decode and validate a binary header before any array maps it: a
    half-written or torn file is refused here with a "truncated or torn"
    error (a deterministic failure class), never read short later.
    Returns (nmodes, idx_width, val_width, dims, nnz, data_offset)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(4) != _BIN_MAGIC:
            raise ValueError(f"{path}: bad magic")
        head = f.read(16)
        if len(head) != 16:
            raise ValueError(
                f"{path}: truncated or torn binary header "
                f"({4 + len(head)} of 20 bytes)")
        version, nmodes, idx_width, val_width = struct.unpack("<IIII", head)
        if version != _BIN_VERSION:
            raise ValueError(f"{path}: unsupported binary version {version}")
        if not 0 < nmodes <= 64:
            raise ValueError(
                f"{path}: implausible mode count {nmodes} — "
                f"truncated or torn header")
        if idx_width not in (4, 8) or val_width not in (4, 8):
            raise ValueError(
                f"{path}: bad index/value widths "
                f"({idx_width}/{val_width}) — truncated or torn header")
        draw = f.read(8 * nmodes)
        if len(draw) != 8 * nmodes:
            raise ValueError(
                f"{path}: truncated or torn dims block "
                f"({len(draw)} of {8 * nmodes} bytes)")
        dims = np.frombuffer(draw, dtype=np.uint64).astype(np.int64)
        if (dims < 0).any():
            raise ValueError(
                f"{path}: implausible dimension — truncated or torn header")
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: truncated or torn nnz field")
        (nnz,) = struct.unpack("<Q", raw)
        data_offset = f.tell()
    expect = data_offset + nmodes * nnz * idx_width + nnz * val_width
    if size < expect:
        raise ValueError(
            f"{path}: truncated or torn binary tensor — header promises "
            f"{expect} bytes ({nnz} nnz x {nmodes} modes), file has {size}")
    return (nmodes, idx_width, val_width, tuple(int(d) for d in dims),
            int(nnz), data_offset)


def _bin_dtypes(idx_width: int, val_width: int):
    return (np.int32 if idx_width == 4 else np.int64,
            np.float32 if val_width == 4 else np.float64)


def load_memmap(path: str) -> SparseTensor:
    """Memory-map a binary tensor: the ``(nmodes, nnz)`` indices (at the
    file's width, int32 or int64) and the values stay on disk, read only
    as the caller touches them."""
    nmodes, idx_width, val_width, dims, nnz, off = _bin_header(path)
    idt, vdt = _bin_dtypes(idx_width, val_width)
    inds = np.memmap(path, dtype=idt, mode="r", offset=off,
                     shape=(nmodes, nnz))
    vals = np.memmap(path, dtype=vdt, mode="r",
                     offset=off + nmodes * nnz * idx_width, shape=(nnz,))
    return SparseTensor(inds, vals, dims)


def _load_binary(path: str) -> SparseTensor:
    nmodes, idx_width, val_width, dims, nnz, off = _bin_header(path)
    idt, vdt = _bin_dtypes(idx_width, val_width)
    with open(path, "rb") as f:
        f.seek(off)
        inds = np.empty((nmodes, nnz), dtype=np.int64)
        for m in range(nmodes):
            inds[m] = np.frombuffer(f.read(idx_width * nnz), dtype=idt)
        vals = np.frombuffer(f.read(val_width * nnz), dtype=vdt).copy()
    return SparseTensor(inds, vals, dims)


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


def read_matrix(path: str) -> np.ndarray:
    """A whitespace-separated text matrix, ``#`` comments skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append([float(t) for t in line.split()])
    return np.asarray(rows)


def write_permutation(perm: np.ndarray, path: str) -> None:
    """One integer per line."""
    with open(path, "w") as f:
        for p in np.asarray(perm).ravel():
            f.write(f"{int(p)}\n")


def read_permutation(path: str) -> np.ndarray:
    """A whitespace-separated integer vector, one entry per line as the
    writer of the JAX package puts it (a per-nonzero partition of the
    FINE decomposition)."""
    with open(path) as f:
        return np.asarray([int(x) for x in f.read().split()], dtype=np.int64)
