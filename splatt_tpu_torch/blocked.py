"""Blocked sparse layouts, ``fixed`` and ``balanced`` packing, v1 and the
compact v2 encodings (≙ src/csf.c).

Counterpart of ``splatt_tpu/blocked.py``.  A layout holds the nonzeros
sorted by one output mode, cut into blocks of ``block`` slots.  Each block
records the first output row it touches (``row_start``); ``seg_width`` is
the widest row span of any block, rounded up to 8.  Sorting, blocking and
encoding run on the host in numpy; the finished arrays move to the device
once.  Two packings (docs/layout-balance.md):

- ``fixed`` cuts the sorted stream every ``block`` nonzeros and pads the
  last block with sentinel entries (id ``dim`` in the sorted mode, 0
  elsewhere, value 0): the reals are the first ``nnz`` slots.
- ``balanced`` (:func:`plan_balanced_blocks`) cuts at fiber boundaries
  under a row-span cap and splits fibers hotter than a block, so the pads
  sit mid-stream: block b's reals are its first ``block_nnz[b]`` slots,
  and its pads repeat its last real row in the sorted mode (0 elsewhere,
  value 0).  :meth:`ModeLayout.real_mask` is the one reader of that
  contract.

A reorder (``reorder.py``) may relabel the tensor before the build; the
layout carries its name (``reorder``) and :meth:`BlockedSparse.compile`
its :class:`~splatt_tpu_torch.reorder.Permutation`.

Two encodings share :class:`ModeLayout` (docs/format.md):

- v1: ``inds`` is one ``(nmodes, nnz_pad)`` int32 tensor of global ids.
- v2: ``inds`` is a tuple of per-mode streams of local ids at the narrowest
  width that fits, with per-block int32 ``base`` offsets (global = local +
  base); the sorted mode's base is ``row_start``, so its stream holds
  segment ids.  ``idx_width`` names the variant: "auto"/"u16", "u8"
  (uint8 segment ids), "delta" (the gather modes as within-block
  differences), "rle" (the sorted mode as per-block run-length counts).

Every consumer reads a layout through the stream vocabulary below
(:func:`decode_gather_ids`, :func:`decode_segment_ids`,
:func:`decode_global_ids`, :func:`rle_expand`), as in the JAX package.

A mode dense enough for the dense verdict (``SPLATT_DENSE``,
docs/dense.md) gets a :class:`DenseModeLayout` instead: its unfolding as
``(ntiles, tile, span)`` value tiles and no index streams at all.
:meth:`BlockedSparse.from_coo` appends such layouts after the sparse ones
and remaps those modes to them (the hybrid per-mode dispatch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from splatt_tpu_torch.config import (BlockAlloc, LayoutFormat, ModeOrder,
                                     Options, Verbosity, default_opts,
                                     layout_format, resolve_dense,
                                     resolve_dense_threshold, resolve_device,
                                     resolve_dtype, resolve_packing,
                                     resolve_reorder, resolve_storage_dtype,
                                     torch_dtype)
from splatt_tpu_torch.coo import SparseTensor

#: short dtype names for format descriptions ("mode0=u16/seg/bf16")
_DTYPE_SHORT = {torch.float32: "f32", torch.float64: "f64",
                torch.bfloat16: "bf16", torch.float16: "f16"}

#: short integer-dtype names for achieved index widths (signed widths
#: appear under the "delta" encoding)
_IDX_SHORT = {torch.uint8: "u8", torch.uint16: "u16", torch.int8: "i8",
              torch.int16: "i16", torch.int32: "i32", torch.int64: "i64"}


def ceil_to(x: int, mult: int) -> int:
    """Round x up to a multiple of mult."""
    return ((x + mult - 1) // mult) * mult


# -- the stream vocabulary (≙ splatt_tpu/blocked.py:65-163) -----------------

#: per-mode stream-encoding kinds:
#:   "glob"  — global int32 ids (v1; no base)
#:   "loc"   — narrow local ids; global = local + base[block]
#:   "seg"   — the sorted mode's within-block segment ids (base is
#:             row_start); global = seg + base[block]
#:   "delta" — within-block first differences of "loc"; decode is an
#:             exact integer cumulative sum, then + base
#:   "rle"   — per-block (seg_width,) run-length counts in place of the
#:             sorted mode's per-nonzero stream
STREAM_ENCODINGS = ("glob", "loc", "seg", "delta", "rle")


class ModeStreams(NamedTuple):
    """A layout's raw encoded per-mode streams, their per-block bases
    (None for v1) and their :data:`STREAM_ENCODINGS` kinds."""

    streams: tuple
    bases: Optional[tuple]
    encs: Tuple[str, ...]


def stream_encodings(idx_width: str, mode: int,
                     nmodes: int) -> Tuple[str, ...]:
    """Per-mode encoding kinds of a layout sorted by `mode` and built
    under `idx_width`."""
    if idx_width == "i32":
        return ("glob",) * nmodes
    out = []
    for k in range(nmodes):
        if k == mode:
            out.append("rle" if idx_width == "rle" else "seg")
        else:
            out.append("delta" if idx_width == "delta" else "loc")
    return tuple(out)


def widen_ids(arr: torch.Tensor) -> torch.Tensor:
    """A stored index stream at the int32 the compute reads."""
    return arr.to(torch.int32)


def decode_gather_ids(arr: torch.Tensor, base, enc: str) -> torch.Tensor:
    """Decode a gather-mode chunk ``(..., B)`` to global int32 ids.
    `base` broadcasts against the stream (None for "glob"); "delta"
    sums along the last axis, which is the block axis."""
    ids = widen_ids(arr)
    if enc == "glob":
        return ids
    if enc == "delta":
        ids = torch.cumsum(ids, dim=-1, dtype=torch.int32)
    return ids + base


def rle_expand(counts: torch.Tensor, block: int) -> torch.Tensor:
    """Per-block run-length counts ``(..., S)`` → the nondecreasing
    within-block segment ids ``(..., block)`` they encode: entry j's id
    is the number of run ends at or before j."""
    ends = torch.cumsum(widen_ids(counts), dim=-1, dtype=torch.int32)
    iota = torch.arange(block, dtype=torch.int32, device=counts.device)
    iota = iota.expand(*ends.shape[:-1], block).contiguous()
    return torch.searchsorted(ends.contiguous(), iota, right=True,
                              out_int32=True)


def decode_segment_ids(arr: torch.Tensor, enc: str, block: int,
                       row_start=None) -> torch.Tensor:
    """Decode the sorted mode's chunk to within-block segment ids
    ``(..., block)``: "seg" widens, "rle" expands the counts, "glob"
    subtracts the block's run start `row_start`."""
    if enc == "rle":
        return rle_expand(arr, block)
    if enc == "glob":
        return widen_ids(arr) - row_start
    return widen_ids(arr)


def decode_global_ids(arr: torch.Tensor, base, enc: str,
                      block: int) -> torch.Tensor:
    """Decode a chunk of any kind to global int32 ids, e.g. the sorted
    mode's segment or RLE stream read as a gather stream."""
    if enc in ("seg", "rle"):
        return decode_segment_ids(arr, enc, block) + base
    return decode_gather_ids(arr, base, enc)


@dataclasses.dataclass
class ModeLayout:
    """One sorted and blocked copy of the nonzeros (≙ one splatt_csf).

    inds: v1 ``(nmodes, nnz_pad)`` int32 global ids sorted by ``mode``;
      v2 a tuple of per-mode encoded streams (``(nnz_pad,)``, or
      ``(nblocks, seg_width)`` counts for an RLE sorted mode).
    vals: (nnz_pad,) values at the storage dtype, zero-padded.
    row_start: (nblocks,) int32 first output row of each block (``dim``
      for an all-padding block).
    base: v2 per-mode (nblocks,) int32 block offsets; None for v1.
    mode, dim, block, seg_width, nnz: as in the JAX package.
    idx_width / val_storage: the requested format policy.
    block_nnz: (nblocks,) int32 real nonzeros per block under the
      balanced packing (each block's reals are its first block_nnz[b]
      slots); None for the fixed packing (the reals are the first nnz).
    packing: "fixed" or "balanced"; reorder: the relabeling the tensor
      went through before the build ("identity" when none);
      density_bucket: :func:`mode_density_bucket` of the mode; skew:
      :func:`nnz_skew_bucket` of the sorted mode's slice histogram, which
      :func:`build_layout` stamps and the autotuner's plan key reads
      ("" for a layout built otherwise).
    """

    inds: Union[torch.Tensor, Tuple[torch.Tensor, ...]]
    vals: torch.Tensor
    row_start: torch.Tensor
    mode: int
    dim: int
    block: int
    seg_width: int
    nnz: int
    base: Optional[Tuple[torch.Tensor, ...]] = None
    idx_width: str = "i32"
    val_storage: str = "auto"
    block_nnz: Optional[torch.Tensor] = None
    packing: str = "fixed"
    reorder: str = "identity"
    density_bucket: str = ""
    skew: str = ""

    @property
    def nnz_pad(self) -> int:
        return int(self.vals.shape[0])

    @property
    def nblocks(self) -> int:
        return int(self.row_start.shape[0])

    @property
    def nmodes(self) -> int:
        # len() covers the v1 (nmodes, nnz_pad) tensor and the v2 tuple
        return len(self.inds)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def encoding(self) -> str:
        """"v1" (global int32) or "v2" (local narrow + base)."""
        return "v1" if self.base is None else "v2"

    def stream_encs(self) -> Tuple[str, ...]:
        """Per-mode :data:`STREAM_ENCODINGS` kinds."""
        return stream_encodings(self.idx_width if self.base is not None
                                else "i32", self.mode, self.nmodes)

    def mode_ids(self, k: int) -> torch.Tensor:
        """(nnz_pad,) int32 global ids of mode `k`, decoded per block
        from a v2 stream."""
        enc = self.stream_encs()[k]
        if enc == "glob":
            return widen_ids(self.inds[k])
        return decode_global_ids(
            self.inds[k].reshape(self.nblocks, -1),
            self.base[k][:, None], enc, self.block).reshape(-1)

    def blocked_locals(self) -> torch.Tensor:
        """(nblocks, block) int32 within-block ids of the sorted mode."""
        enc = self.stream_encs()[self.mode]
        return decode_segment_ids(
            self.inds[self.mode].reshape(self.nblocks, -1), enc,
            self.block, row_start=(self.row_start[:, None]
                                   if enc == "glob" else None))

    def mode_streams(self) -> ModeStreams:
        """The raw encoded streams, bases and kinds, for consumers that
        decode per chunk or inside a kernel."""
        return ModeStreams(
            streams=tuple(self.inds[k] for k in range(self.nmodes)),
            bases=None if self.base is None else tuple(self.base),
            encs=self.stream_encs())

    def real_mask(self) -> np.ndarray:
        """(nblocks, block) bool host mask of real entries: the fixed
        packing's reals are the first ``nnz`` positions, the balanced
        packing's each block's first ``block_nnz[b]`` slots."""
        if self.block_nnz is None:
            real = np.zeros(self.nblocks * self.block, dtype=bool)
            real[:self.nnz] = True
            return real.reshape(self.nblocks, self.block)
        return real_mask_from_counts(self.block,
                                     self.block_nnz.cpu().numpy())

    def idx_widths(self) -> List[str]:
        """Per-mode stored index width ("u8"/"u16"/"i8"/"i16"/"i32")."""
        return [_IDX_SHORT.get(self.inds[k].dtype, "i32")
                for k in range(self.nmodes)]

    def format_desc(self) -> str:
        """Achieved format, e.g. ``u16/seg/bf16`` (v2) or ``i32/glob/f32``
        (v1): index width(s) / sorted-mode encoding / value dtype."""
        widths = sorted(set(self.idx_widths()))
        idx = widths[0] if len(widths) == 1 else "+".join(widths)
        if self.base is None:
            enc = "glob"
        else:
            enc = {"delta": "dlt", "rle": "rle"}.get(self.idx_width, "seg")
        val = _DTYPE_SHORT.get(self.vals.dtype,
                               str(self.vals.dtype).replace("torch.", ""))
        return f"{idx}/{enc}/{val}"

    def storage_bytes(self) -> int:
        """≙ csf_storage (src/csf.c:729-767): the encoded bytes of the
        stored streams, bases, values and run starts."""

        def nbytes(t):
            return t.numel() * t.element_size()

        if self.base is None:
            idx = nbytes(self.inds)
        else:
            idx = sum(nbytes(a) for a in self.inds)
            idx += sum(nbytes(b) for b in self.base)
        if self.block_nnz is not None:
            idx += nbytes(self.block_nnz)
        return idx + nbytes(self.vals) + nbytes(self.row_start)

    def __repr__(self) -> str:
        extra = "" if self.packing == "fixed" else f", pack={self.packing}"
        if self.reorder != "identity":
            extra += f", reorder={self.reorder}"
        return (f"ModeLayout(mode={self.mode}, dim={self.dim}, "
                f"block={self.block}, seg_width={self.seg_width}, "
                f"nnz={self.nnz}, nnz_pad={self.nnz_pad}, "
                f"nblocks={self.nblocks}, enc={self.encoding}"
                f"[{self.format_desc()}]{extra})")

    def to(self, device) -> "ModeLayout":
        if self.base is None:
            inds = self.inds.to(device)
            base = None
        else:
            inds = tuple(s.to(device) for s in self.inds)
            base = tuple(b.to(device) for b in self.base)
        block_nnz = (None if self.block_nnz is None
                     else self.block_nnz.to(device))
        return dataclasses.replace(self, inds=inds, base=base,
                                   vals=self.vals.to(device),
                                   row_start=self.row_start.to(device),
                                   block_nnz=block_nnz)


def secondary_order(dims, mode: int, policy: Optional[ModeOrder] = None,
                    custom=None) -> List[int]:
    """Order of the non-output modes inside a layout
    (≙ csf_find_mode_order, src/csf.c:694-726)."""
    policy = policy or ModeOrder.SMALLFIRST
    others = [m for m in range(len(dims)) if m != mode]
    if policy in (ModeOrder.SMALLFIRST, ModeOrder.SORTED_MINUSONE):
        return sorted(others, key=lambda m: (dims[m], m))
    if policy is ModeOrder.BIGFIRST:
        return sorted(others, key=lambda m: (-dims[m], m))
    if policy is ModeOrder.INORDER_MINUSONE:
        return others
    if policy is ModeOrder.CUSTOM:
        if custom is None:
            raise ValueError("ModeOrder.CUSTOM requires mode_order_custom")
        seq = [m for m in custom if m != mode]
        if sorted(seq) != others:
            raise ValueError(
                f"mode_order_custom {custom!r} is not a permutation "
                f"covering all non-output modes for mode {mode}")
        return seq
    raise ValueError(f"unknown mode order {policy!r}")


def check_int32_dims(dims) -> None:
    """Every dim must lie below INT32_MAX: ids are int32 and ``dim`` is
    the padding sentinel."""
    limit = 2**31 - 1
    if max(dims, default=0) >= limit:
        raise ValueError(
            f"dims {tuple(dims)} exceed the int32 device index width "
            f"(max dim must be < {limit}); relabel/split the mode first")


# -- balanced packing (≙ splatt_tpu/blocked.py:406-760, docs/layout-balance.md)


def real_mask_from_counts(block: int, counts) -> np.ndarray:
    """(nblocks, block) bool mask of real entries from per-block real
    counts: the balanced packing's pad contract (each block's reals are
    its first ``counts[b]`` slots), defined once for the encoder, the
    build's stats and :meth:`ModeLayout.real_mask`."""
    counts = np.asarray(counts, dtype=np.int64)
    return np.arange(block, dtype=np.int64)[None, :] < counts[:, None]


def nnz_skew_bucket(hist: np.ndarray) -> str:
    """``k<n>``, n the bit length of the max/mean nonzeros per nonempty
    slice: k0/k1 about uniform, k4 and above power-law."""
    hist = np.asarray(hist, dtype=np.int64)
    hist = hist[hist > 0]
    if hist.size == 0:
        return "k0"
    ratio = float(hist.max()) / float(hist.mean())
    return f"k{int(max(ratio, 1.0)).bit_length()}"


#: the balanced packing's fill floor: a span cap whose blocks average
#: less than this share of real slots is infeasible (it would cap the
#: max/mean real nonzeros per block near 1.1 and the padding's bytes)
MIN_FILL = 0.91


def plan_balanced_blocks(rows: np.ndarray, block: int, dim: int,
                         span_caps: Optional[Sequence] = None):
    """The nnz-balanced cut of a sorted row stream into blocks of at most
    `block` real nonzeros (≙ splatt_tpu.blocked.plan_balanced_blocks).

    A block fills to `block` nonzeros (splitting the fiber it ends in,
    which adds no rows to either block) unless a row-span cap W closes it
    first at a fiber boundary.  Each candidate cap (powers of two below
    the fixed span, and None, which is the fixed slicing) is simulated;
    of those whose fill reaches :data:`MIN_FILL`, the one with the least
    ``nblocks x (ceil8(span) + 8)`` wins, None first on a tie, and when
    none does, the fullest.  Returns (starts, counts, span): each block's
    start in the sorted stream, its real count, and the widest row span
    of any block."""
    nnz = int(rows.shape[0])
    B = int(block)
    if nnz == 0:
        return (np.zeros(1, dtype=np.int64), np.zeros(1, dtype=np.int64), 1)
    rows = np.asarray(rows, dtype=np.int64)
    starts_f = np.flatnonzero(
        np.concatenate([[True], rows[1:] != rows[:-1]]))
    run_rows = rows[starts_f]
    bounds = np.concatenate([starts_f, [nnz]])
    nruns = int(run_rows.shape[0])

    def simulate(W, materialize=False, max_blocks=None):
        # max_blocks gives up on a cap the fill floor will reject anyway,
        # so a tight cap over one-nonzero rows does not walk the tensor
        pos = 0
        nb = 0
        max_span = 1
        out_starts = [] if materialize else None
        out_counts = [] if materialize else None
        while pos < nnz:
            row0 = int(rows[pos])
            if W is None:
                e_span = nnz
            else:
                # the first fiber whose row leaves [row0, row0 + W)
                rj = int(np.searchsorted(run_rows, row0 + W, side="left"))
                e_span = int(bounds[rj]) if rj < nruns else nnz
            end = min(pos + B, e_span)
            nb += 1
            if max_blocks is not None and nb > max_blocks:
                return None, None
            max_span = max(max_span, int(rows[end - 1]) - row0 + 1)
            if materialize:
                out_starts.append(pos)
                out_counts.append(end - pos)
            pos = end
        if materialize:
            return (np.asarray(out_starts, dtype=np.int64),
                    np.asarray(out_counts, dtype=np.int64), max_span)
        return nb, max_span

    if span_caps is None:
        fixed_span = int(rows[-1]) - int(rows[0]) + 1
        caps, W = [None], 8
        while W < min(fixed_span, dim if dim > 0 else 1):
            caps.insert(1, W)
            W *= 2
    else:
        caps = list(span_caps)
    feasible_nb = int(nnz / (MIN_FILL * B)) + 1
    best_cap, best_cost, best_fill_cap, best_fill = None, None, None, -1.0
    for W in caps:
        nb, span = simulate(
            W, max_blocks=None if W is None else feasible_nb)
        if nb is None:
            continue
        fill = nnz / float(nb * B)
        if fill > best_fill:
            best_fill_cap, best_fill = W, fill
        if fill < MIN_FILL:
            continue
        cost = nb * (ceil_to(min(span, dim if dim > 0 else 1), 8) + 8)
        if best_cost is None or cost < best_cost:
            best_cap, best_cost = W, cost
    if best_cost is None:
        best_cap = best_fill_cap
    return simulate(best_cap, materialize=True)


def _pack_balanced(sinds: np.ndarray, svals: np.ndarray, mode: int,
                   block: int, dim: int):
    """The balanced packing of a sorted nonzero stream: padded ``(nmodes,
    nblocks * block)`` int32 global ids, the values (at `svals`' dtype),
    row_start, the per-block real counts and the widest span.  A pad
    repeats its block's last real row in the sorted mode (the stream stays
    nondecreasing, and the row's partial gains a zero), points at row 0 in
    the others, and holds value 0."""
    nmodes, nnz = sinds.shape
    starts, counts, span = plan_balanced_blocks(sinds[mode], block, dim)
    offs = np.arange(block, dtype=np.int64)[None, :]
    sel = starts[:, None] + offs
    valid = offs < counts[:, None]
    take = np.clip(np.where(valid, sel, 0), 0, max(nnz - 1, 0)).reshape(-1)
    mask = valid.reshape(-1)
    # fancy indexing along axis 1 may hand back a transposed buffer: the
    # kernels read a row-major (nmodes, nnz_pad) array
    inds = np.ascontiguousarray(sinds[:, take], dtype=np.int32)
    last_row = sinds[mode][starts + counts - 1]
    for k in range(nmodes):
        pad = np.repeat(last_row, block) if k == mode else 0
        inds[k] = np.where(mask, inds[k], pad)
    vals = np.where(mask, svals[take], 0)
    row_start = sinds[mode][starts].astype(np.int32)
    return inds, vals, row_start, counts.astype(np.int32), span


def _record_imbalance(mode: int, packing: str, block: int, seg_width: int,
                      hist: np.ndarray, counts: np.ndarray,
                      spans: np.ndarray, nnz: int, verbose: bool) -> None:
    """One ``layout_imbalance`` event per layout build: max/mean real
    nonzeros and row span per block, the input's slice skew and the
    padded work per real nonzero (``nblocks x seg_width x block / nnz``)."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils.env import max_mean_ratio as max_mean

    hist = hist[hist > 0]
    counts = np.asarray(counts)
    spans = np.asarray(spans)
    work_amp = len(counts) * seg_width * block / max(nnz, 1)
    resilience.run_report().add(
        "layout_imbalance", mode=mode, packing=packing, block=block,
        seg_width=seg_width, nblocks=len(counts),
        slice_max_mean=max_mean(hist),
        block_nnz_max_mean=max_mean(counts),
        span_max_mean=max_mean(spans),
        work_amp=round(work_amp, 2))
    if verbose:
        print(f"  layout mode{mode} [{packing}]: block nnz max/mean "
              f"{max_mean(counts)}, span max/mean {max_mean(spans)}, "
              f"seg_width {seg_width}, one-hot work x{work_amp:.1f}/nnz")


# -- the v2 encoders (≙ splatt_tpu/blocked.py:559-699), numpy on the host ---


def _delta_width(delta: np.ndarray):
    """Narrowest signed numpy dtype holding every within-block delta."""
    lo = int(delta.min()) if delta.size else 0
    hi = int(delta.max()) if delta.size else 0
    for width in (np.int8, np.int16):
        info = np.iinfo(width)
        if info.min <= lo and hi <= info.max:
            return width
    return np.int32


def _encode_rle(loc: np.ndarray, seg_width: int, block: int) -> np.ndarray:
    """The sorted mode's (nblocks, block) segment ids as per-block
    (seg_width,) counts.  Ids must be nondecreasing within each block,
    and a seg_width above the block would invert the compression: both
    are encode errors, which the callers degrade to v1."""
    nb = loc.shape[0]
    if seg_width > block:
        raise ValueError(
            f"idx_width=rle would invert compression: seg_width "
            f"{seg_width} exceeds the block size {block}; use "
            f"idx_width=auto for wide-span layouts")
    if loc.size and np.any(np.diff(loc, axis=1) < 0):
        raise ValueError(
            "idx_width=rle requires nondecreasing within-block segment "
            "ids; the sorted-mode stream is not monotone")
    offs = loc.astype(np.int64) + np.arange(nb, dtype=np.int64)[:, None] \
        * seg_width
    counts = np.bincount(offs.ravel(),
                         minlength=nb * seg_width).reshape(nb, seg_width)
    width = np.uint16 if block <= np.iinfo(np.uint16).max else np.int32
    return counts.astype(width)


def _encode_v2(inds: np.ndarray, row_start: np.ndarray, mode: int,
               block: int, nnz: int, fmt: LayoutFormat,
               real: Optional[np.ndarray] = None,
               seg_width: Optional[int] = None):
    """Sorted, padded global (nmodes, nnz_pad) int32 ids → the v2
    per-mode streams and per-block int32 bases.

    Gather modes: local ids against the block's smallest real id, at
    uint16 where the mode's largest extent fits, else int32 ("u16"
    makes a misfit an error); "delta" stores their within-block
    differences at the narrowest signed width.  The sorted mode: segment
    ids against ``row_start``, uint8 under "u8" (a span above 255 is an
    error), per-block counts under "rle" (`seg_width` needed).  Pads:
    the sorted mode's take the block's last real segment id (0 in an
    all-pad block, whose base is the sentinel ``dim``), the others 0.
    """
    nmodes, nnz_pad = inds.shape
    nb = nnz_pad // block
    u8_max = int(np.iinfo(np.uint8).max)
    u16_max = int(np.iinfo(np.uint16).max)
    if real is None:
        real = np.zeros(nnz_pad, dtype=bool)
        real[:nnz] = True
        real = real.reshape(nb, block)
    else:
        real = np.asarray(real, dtype=bool).reshape(nb, block)
    any_pad = not real.all()
    locs, bases = [], []
    for k in range(nmodes):
        rows = inds[k].reshape(nb, block)
        if k == mode:
            base = row_start.astype(np.int32).copy()
        else:
            masked = np.where(real, rows, np.iinfo(np.int32).max)
            base = masked.min(axis=1)
            base[base == np.iinfo(np.int32).max] = 0
            base = base.astype(np.int32)
        loc = rows - base[:, None]
        if any_pad:
            if k == mode:
                maxloc = np.where(real, loc, 0).max(axis=1)
                loc = np.where(real, loc, maxloc[:, None])
            else:
                loc = np.where(real, loc, 0)
        if k == mode and fmt.idx == "rle":
            if seg_width is None:
                raise ValueError("idx_width=rle requires the layout's "
                                 "seg_width at encode time")
            locs.append(_encode_rle(loc, int(seg_width), block))
            bases.append(base)
            continue
        if k != mode and fmt.idx == "delta":
            delta = np.diff(loc, axis=1, prepend=0)
            locs.append(delta.reshape(-1).astype(_delta_width(delta)))
            bases.append(base)
            continue
        extent = int(loc.max()) if loc.size else 0
        if fmt.idx == "u16" and extent > u16_max:
            raise ValueError(
                f"idx_width=u16 requested but mode {k}'s maximum "
                f"per-block extent {extent} exceeds uint16; use "
                f"idx_width=auto (which falls back to int32 per mode)")
        if fmt.idx == "u8" and k == mode and extent > u8_max:
            raise ValueError(
                f"idx_width=u8 requested but the sorted mode's maximum "
                f"block span {extent} exceeds uint8; use idx_width=auto "
                f"(u16/i32 segment ids)")
        if fmt.idx == "u8" and k == mode:
            width = np.uint8
        else:
            width = np.uint16 if extent <= u16_max else np.int32
        locs.append(loc.reshape(-1).astype(width))
        bases.append(base)
    return locs, bases


def _format_fallback(mode: int, fmt: LayoutFormat, e: Exception,
                     verbose: bool) -> None:
    """Record a v2 encode that degraded to v1 (``format_fallback``)."""
    from splatt_tpu_torch import resilience

    cls = resilience.classify_failure(e)
    resilience.run_report().add(
        "format_fallback", mode=mode, idx_width=fmt.idx,
        failure_class=cls.value,
        error=resilience.failure_message(e)[:200])
    if verbose:
        print(f"  layout mode{mode}: v2 ({fmt.idx}) encode failed "
              f"({cls.value}); falling back to the v1 i32 encoding")


def _encoded(locs, bases, dev) -> dict:
    return dict(inds=tuple(torch.from_numpy(np.ascontiguousarray(s)).to(dev)
                           for s in locs),
                base=tuple(torch.from_numpy(b).to(dev) for b in bases))


# -- the builders -------------------------------------------------------------


def layout_sort_order(tt: SparseTensor, mode: int, mode_order=None,
                      mode_order_custom=None) -> np.ndarray:
    """The permutation that sorts `tt` for mode `mode`'s layout: by the
    output mode, then the others in the mode order's sequence."""
    return tt.sort_order([mode] + secondary_order(
        tt.dims, mode, mode_order, mode_order_custom))


def build_layout(tt: SparseTensor, mode: int, block: int = 4096,
                 val_dtype=torch.float32, mode_order=None,
                 mode_order_custom=None, device=None,
                 fmt: Optional[LayoutFormat] = None,
                 verbose: bool = False, dense: Optional[bool] = None,
                 packing: str = "fixed", reorder_label: str = "identity",
                 seconds: Optional[Dict[str, float]] = None,
                 record_stats: bool = True, presorted: bool = False
                 ) -> Union[ModeLayout, "DenseModeLayout"]:
    """Sort, block and pad the tensor for output mode `mode`
    (≙ csf_alloc's sort + fiber build, src/csf.c:613-726).

    `fmt` picks the encoding: v1 global int32 by default, or v2.  A v2
    encode that fails (an armed ``format.encode`` fault, a u16/u8/RLE
    overflow) degrades to v1 with a ``format_fallback`` event.  A
    requested block cut to the tensor's size leaves a ``block_clamp``
    event.

    `packing` picks the cut: "fixed" every `block` nonzeros, "balanced"
    :func:`plan_balanced_blocks`'s fiber-aligned cut, whose pads sit
    mid-stream (``block_nnz``).  A balanced pack that fails (an armed
    ``layout.pack`` fault) degrades to the fixed cut with a
    ``packing_fallback`` event; an empty tensor has nothing to balance
    and is cut fixed.  `reorder_label` names the relabeling the caller
    applied to `tt` (the layout carries it).  Every sparse build leaves
    one ``layout_imbalance`` event (:func:`_record_imbalance`) unless
    `record_stats` is False (the autotuner's candidate builds), stamps
    the mode's slice skew (:func:`nnz_skew_bucket`) into the layout, and
    adds its host seconds into `seconds`, when given: the sort under
    ``"sort"``, the rest of the build (pack, encode, copy to the device)
    under ``"pack"``.  `presorted` says `tt` is already in
    :func:`layout_sort_order`'s order for `mode` and skips the sort: the
    autotuner's candidate builds of one mode read one sorted copy.

    `dense` picks the dense tile layout: True forces it, False forbids
    it, None reads the SPLATT_DENSE policy and :func:`dense_mode_verdict`.
    A dense build that fails (an armed ``format.dense`` fault, a blowup
    past the cap) degrades to this sparse build with a
    ``format_fallback`` event carrying ``site="dense"``."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils import faults

    nmodes, nnz = tt.nmodes, tt.nnz
    check_int32_dims(tt.dims)
    fmt = (fmt or LayoutFormat()).validate()
    if packing not in ("fixed", "balanced"):
        raise ValueError(f"unknown packing {packing!r}")
    dev = resolve_device(device)
    if dense is None:
        dense = _wants_dense(tt.dims, mode, nnz, Options())
    if dense:
        lay = _dense_or_degrade(mode, verbose, lambda: build_dense_layout(
            tt, mode, val_dtype=val_dtype, device=dev, verbose=verbose,
            reorder_label=reorder_label))
        if lay is not None:
            return lay
    t0 = time.perf_counter()
    perm = (slice(None) if presorted else
            layout_sort_order(tt, mode, mode_order, mode_order_custom))
    t_sorted = time.perf_counter()
    if seconds is not None:
        seconds["sort"] = seconds.get("sort", 0.0) + t_sorted - t0
    dim = tt.dims[mode]
    hist = tt.mode_histogram(mode)

    # the block never dwarfs a small tensor: clamp to the nnz count
    # padded to 128
    requested = int(block)
    block = max(128, min(requested, ceil_to(max(nnz, 1), 128)))
    if block != requested:
        resilience.run_report().add("block_clamp", mode=mode,
                                    requested=requested, effective=block,
                                    nnz=nnz, idx_width=fmt.idx,
                                    val_storage=fmt.val)
        if verbose:
            print(f"  layout mode{mode} [{fmt.idx}/{fmt.val}]: requested "
                  f"nnz_block {requested} clamped to {block} (nnz={nnz})")

    block_nnz = None
    if packing == "balanced" and nnz > 0:
        try:
            faults.maybe_fail("layout.pack")
            inds, svals, row_start, block_nnz, span = _pack_balanced(
                tt.inds[:, perm].astype(np.int64), np.asarray(tt.vals)[perm],
                mode, block, dim)
            vals = torch.from_numpy(svals).to(val_dtype)
        except Exception as e:
            # a failed balanced pack degrades the build, classified, to
            # the fixed cut
            cls = resilience.classify_failure(e)
            resilience.run_report().add(
                "packing_fallback", mode=mode, failure_class=cls.value,
                error=resilience.failure_message(e)[:200])
            if verbose:
                print(f"  layout mode{mode}: balanced packing failed "
                      f"({cls.value}); falling back to fixed slicing")
            block_nnz = None
    if block_nnz is None:
        packing = "fixed"
        nnz_pad = max(block, ceil_to(nnz, block))
        inds = np.zeros((nmodes, nnz_pad), dtype=np.int32)
        inds[:, :nnz] = tt.inds[:, perm]
        inds[mode, nnz:] = dim
        vals = torch.zeros(nnz_pad, dtype=val_dtype)
        vals[:nnz] = torch.from_numpy(np.ascontiguousarray(tt.vals[perm]))
        rows = inds[mode].reshape(-1, block)
        row_start = rows[:, 0].astype(np.int32)
        span = int((rows[:, -1] - rows[:, 0]).max()) + 1 if nnz else 1
    nblocks = int(row_start.shape[0])
    # sentinels in the last real block can inflate its span: clamp to the
    # widest span real rows can have
    seg_width = ceil_to(min(span, dim if dim > 0 else 1), 8)

    if record_stats:
        rows_b = inds[mode].reshape(nblocks, block)
        counts_b = (block_nnz if block_nnz is not None
                    else np.minimum(np.maximum(
                        nnz - block * np.arange(nblocks), 0), block))
        # spans over the real entries only: a fixed layout's sentinels
        # carry row `dim`
        realm = real_mask_from_counts(block, counts_b)
        hi = np.where(realm, rows_b, -1).max(axis=1)
        lo = np.where(realm, rows_b, dim).min(axis=1)
        spans_b = np.where(counts_b > 0, hi - lo + 1, 1)
        _record_imbalance(mode, packing, block, seg_width, hist, counts_b,
                          np.minimum(spans_b, dim if dim > 0 else 1), nnz,
                          verbose)

    statics = dict(vals=vals.to(dev),
                   row_start=torch.from_numpy(row_start).to(dev),
                   mode=mode, dim=dim, block=block, seg_width=seg_width,
                   nnz=nnz, val_storage=fmt.val, packing=packing,
                   reorder=reorder_label, skew=nnz_skew_bucket(hist),
                   density_bucket=mode_density_bucket(tt.dims, mode, nnz),
                   block_nnz=(None if block_nnz is None
                              else torch.from_numpy(block_nnz).to(dev)))
    lay = None
    if fmt.v2:
        try:
            faults.maybe_fail("format.encode")
            real = (None if block_nnz is None
                    else real_mask_from_counts(block, block_nnz))
            locs, bases = _encode_v2(inds, row_start, mode, block, nnz,
                                     fmt, real=real, seg_width=seg_width)
            lay = ModeLayout(**_encoded(locs, bases, dev),
                             idx_width=fmt.idx, **statics)
        except Exception as e:
            # a failed v2 encode degrades the build, classified, to the
            # v1 encoding every engine reads
            _format_fallback(mode, fmt, e, verbose)
    if lay is None:
        lay = ModeLayout(inds=torch.from_numpy(inds).to(dev),
                         idx_width="i32", **statics)
    if seconds is not None:
        seconds["pack"] = (seconds.get("pack", 0.0) + time.perf_counter()
                           - t_sorted)
    return lay


def reencode_layout(layout: ModeLayout, fmt: LayoutFormat,
                    val_dtype=None, dense: bool = False,
                    dims: Optional[Sequence[int]] = None
                    ) -> Union[ModeLayout, "DenseModeLayout"]:
    """Re-encode a v1 layout under `fmt` (and optionally another value
    dtype) without sorting again.  A failed v2 encode returns the v1
    layout with a ``format_fallback`` event, as :func:`build_layout`
    does.  `dense` re-encodes to the dense tile layout instead
    (:func:`densify_layout`; `dims` gives the other modes' extents); a
    failed dense tiling degrades to the `fmt` re-encode with a
    ``format_fallback`` event carrying ``site="dense"``."""
    from splatt_tpu_torch.utils import faults

    fmt = fmt.validate()
    if layout.encoding != "v1":
        raise ValueError("reencode_layout expects a v1 source layout")
    if dense:
        if dims is None:
            raise ValueError("dense re-encode needs the tensor dims")
        lay = _dense_or_degrade(layout.mode, False, lambda: densify_layout(
            layout, dims, val_dtype=val_dtype))
        if lay is not None:
            return lay
    vals = layout.vals if val_dtype is None else layout.vals.to(val_dtype)
    v1 = dataclasses.replace(layout, vals=vals, idx_width="i32",
                             val_storage=fmt.val)
    if not fmt.v2:
        return v1
    try:
        faults.maybe_fail("format.encode")
        locs, bases = _encode_v2(layout.inds.cpu().numpy(),
                                 layout.row_start.cpu().numpy(),
                                 layout.mode, layout.block, layout.nnz,
                                 fmt, real=layout.real_mask(),
                                 seg_width=layout.seg_width)
        return dataclasses.replace(v1, idx_width=fmt.idx,
                                   **_encoded(locs, bases, layout.device))
    except Exception as e:
        _format_fallback(layout.mode, fmt, e, False)
        return v1


def decode_to_v1(layout: ModeLayout) -> ModeLayout:
    """A compact layout's global-int32 v1 form, decoded on its device
    through :meth:`ModeLayout.mode_ids`: what ``SPLATT_DECODE=prep``,
    the ``format.decode`` degradation and the prep-decoding kernel
    engines read."""
    if layout.encoding == "v1":
        return layout
    inds = torch.stack([layout.mode_ids(k) for k in range(layout.nmodes)])
    return dataclasses.replace(layout, inds=inds, base=None,
                               idx_width="i32")


# -- the dense-mode tile layout (≙ splatt_tpu/blocked.py:1057-1355) ----------
#
# A dense mode's unfolding X_(m) is stored as (tile, span) value tiles and
# its MTTKRP is the matmul X_(m) @ KR(other factors).  Column c of the
# unfolding linearizes the non-output modes row-major in ascending mode
# order, the last one fastest; that inner mode's extent is padded to a
# multiple of 128, and the pad columns hold zero values and meet the zero
# rows of the padded inner factor (ops/mttkrp.py dense_operands), so no
# mask is read on the hot path.

#: a dense tiling whose padded cells exceed this multiple of nnz is
#: refused, even under dense="on"
DENSE_BLOWUP_CAP = 64


class DenseGeometry(NamedTuple):
    """Tile geometry of one mode's dense unfolding, derived from (dims,
    mode) and never stored."""

    others: Tuple[int, ...]   # non-output modes, ascending
    inner: int                # the fastest-varying (last) other mode
    n_outer: int              # product of the remaining other dims (>= 1)
    inner_pad: int            # dims[inner] padded to a multiple of 128
    tile: int                 # output rows per tile (a multiple of 8)
    ntiles: int               # row tiles (ntiles * tile >= dim)
    span: int                 # columns per tile = n_outer * inner_pad
    cells: int                # padded cells = ntiles * tile * span


def dense_tile_geometry(dims: Sequence[int],
                        mode: int) -> Optional[DenseGeometry]:
    """The geometry of mode `mode`'s dense unfolding, or None when it
    cannot be tiled (fewer than two modes, or an empty dim)."""
    dims = tuple(int(d) for d in dims)
    others = tuple(k for k in range(len(dims)) if k != mode)
    if not others or min(dims, default=0) < 1:
        return None
    inner = others[-1]
    n_outer = 1
    for k in others[:-1]:
        n_outer *= dims[k]
    inner_pad = ceil_to(dims[inner], 128)
    dim = dims[mode]
    tile = min(ceil_to(dim, 8), 256)
    ntiles = -(-dim // tile)
    span = n_outer * inner_pad
    return DenseGeometry(others=others, inner=inner, n_outer=n_outer,
                         inner_pad=inner_pad, tile=tile, ntiles=ntiles,
                         span=span, cells=ntiles * tile * span)


def mode_density(dims: Sequence[int], mode: int, nnz: int) -> float:
    """nnz over the product of all dims: the fill of the unfolding."""
    total = 1
    for d in dims:
        total *= max(int(d), 1)
    return float(nnz) / float(max(total, 1))


def padded_mode_density(dims: Sequence[int], mode: int, nnz: int) -> float:
    """nnz over the padded tile cells, which the dense verdict judges: the
    padding of the inner mode is the blowup a tiling would pay."""
    geo = dense_tile_geometry(dims, mode)
    if geo is None:
        return 0.0
    return float(nnz) / float(max(geo.cells, 1))


def mode_density_bucket(dims: Sequence[int], mode: int, nnz: int) -> str:
    """``dn<n>``, n the bit length of 1 / padded density (dn1 more than
    half full, dn5 about 5%); "" at or below 1/32 or without a
    geometry."""
    pd = padded_mode_density(dims, mode, nnz)
    if pd <= 1.0 / 32.0:
        return ""
    return f"dn{int(1.0 / pd).bit_length()}"


def dense_mode_verdict(dims: Sequence[int], mode: int, nnz: int,
                       threshold: float, force: bool = False) -> bool:
    """Whether mode `mode` is stored as dense tiles: a feasible geometry
    whose padded cells stay within :data:`DENSE_BLOWUP_CAP` x nnz, and a
    padded density at or above `threshold` (`force`, the "on" policy,
    skips only the threshold)."""
    geo = dense_tile_geometry(dims, mode)
    if geo is None or nnz < 1:
        return False
    if geo.cells > DENSE_BLOWUP_CAP * nnz:
        return False
    return force or padded_mode_density(dims, mode, nnz) >= threshold


@dataclasses.dataclass
class DenseModeLayout:
    """The dense tile layout of one mode (≙ splatt_tpu.blocked.
    DenseModeLayout).

    tiles: ``(ntiles, tile, span)`` values at the storage dtype, zero in
      the pad rows and columns.
    mask: ``(span,)`` bool, True at the real unfolding columns (False at
      the inner mode's pad columns); no engine reads it.

    It carries :class:`ModeLayout`'s plan-matching surface (``encoding``
    and ``idx_width`` read "dense", ``block`` is the row tile), so the
    demotion keys and the format lines treat it like any layout.
    """

    tiles: torch.Tensor
    mask: torch.Tensor
    mode: int
    dims: Tuple[int, ...]
    nnz: int
    val_storage: str = "auto"
    reorder: str = "identity"

    @property
    def dim(self) -> int:
        return int(self.dims[self.mode])

    @property
    def nmodes(self) -> int:
        return len(self.dims)

    @property
    def geometry(self) -> DenseGeometry:
        return dense_tile_geometry(self.dims, self.mode)

    @property
    def ntiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def tile(self) -> int:
        return int(self.tiles.shape[1])

    @property
    def span(self) -> int:
        return int(self.tiles.shape[2])

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def encoding(self) -> str:
        return "dense"

    @property
    def idx_width(self) -> str:
        return "dense"

    @property
    def block(self) -> int:
        """The row tile, in nnz_block's place in the demotion keys."""
        return self.tile

    @property
    def packing(self) -> str:
        return "fixed"

    @property
    def skew(self) -> str:
        return ""

    @property
    def density_bucket(self) -> str:
        return mode_density_bucket(self.dims, self.mode, self.nnz)

    def density(self) -> float:
        return mode_density(self.dims, self.mode, self.nnz)

    def index_bytes(self) -> int:
        """Zero: the point of the format."""
        return 0

    def value_bytes(self) -> int:
        return self.tiles.numel() * self.tiles.element_size()

    def storage_bytes(self) -> int:
        mask = self.mask.numel() * self.mask.element_size()
        return self.value_bytes() + mask

    def format_desc(self) -> str:
        val = _DTYPE_SHORT.get(self.tiles.dtype,
                               str(self.tiles.dtype).replace("torch.", ""))
        return f"dense/t{self.tile}/{val}"

    def __repr__(self) -> str:
        extra = ("" if self.reorder == "identity"
                 else f", reorder={self.reorder}")
        return (f"DenseModeLayout(mode={self.mode}, dim={self.dim}, "
                f"tile={self.tile}x{self.span}, ntiles={self.ntiles}, "
                f"nnz={self.nnz}, density={self.density():.3g}{extra})")

    def to(self, device) -> "DenseModeLayout":
        return dataclasses.replace(self, tiles=self.tiles.to(device),
                                   mask=self.mask.to(device))


def _wants_dense(dims: Sequence[int], mode: int, nnz: int,
                 opts: Options) -> bool:
    """Whether the dense policy of `opts` (else SPLATT_DENSE and
    SPLATT_DENSE_THRESHOLD) gives mode `mode` a dense layout."""
    pol = resolve_dense(opts)
    return pol != "off" and dense_mode_verdict(
        dims, mode, nnz, resolve_dense_threshold(opts), force=pol == "on")


def _dense_or_degrade(mode: int, verbose: bool, build):
    """`build()`'s dense layout under the ``format.dense`` fault site, or
    None when it fails: the failure is classified into a
    ``format_fallback`` event with ``site="dense"`` and the caller keeps
    the sparse encoding."""
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.utils import faults

    try:
        faults.maybe_fail("format.dense")
        return build()
    except Exception as e:
        cls = resilience.classify_failure(e)
        resilience.run_report().add(
            "format_fallback", mode=mode, site="dense", idx_width="dense",
            failure_class=cls.value,
            error=resilience.failure_message(e)[:200])
        if verbose:
            print(f"  layout mode{mode}: dense tiling failed "
                  f"({cls.value}); the mode keeps the sparse encoding")
        return None


def build_dense_layout(tt: SparseTensor, mode: int, val_dtype=None,
                       device=None, verbose: bool = False,
                       reorder_label: str = "identity"
                       ) -> DenseModeLayout:
    """Mode `mode`'s unfolding as dense value tiles, built on the host
    and moved to `device` once.  Raises on an infeasible geometry or a
    blowup past :data:`DENSE_BLOWUP_CAP`; the callers degrade.  Duplicate
    coordinates accumulate (``np.add.at`` in the staging dtype, in entry
    order, as the JAX package adds them)."""
    check_int32_dims(tt.dims)
    val_dtype = torch_dtype(torch.float32 if val_dtype is None
                            else val_dtype)
    dev = resolve_device(device)
    geo = dense_tile_geometry(tt.dims, mode)
    if geo is None:
        raise ValueError(
            f"mode {mode} of dims {tuple(tt.dims)} cannot be dense-tiled "
            f"(need two+ nonempty modes)")
    if geo.cells > DENSE_BLOWUP_CAP * max(tt.nnz, 1):
        raise ValueError(
            f"dense tiling of mode {mode} would materialize {geo.cells} "
            f"padded cells for {tt.nnz} nonzeros (> {DENSE_BLOWUP_CAP}x "
            f"blowup); keeping the sparse encoding")
    # numpy has no bfloat16: bf16 stages through f32 and rounds once
    stage = (np.dtype(np.float32) if val_dtype == torch.bfloat16
             else torch.empty(0, dtype=val_dtype).numpy().dtype)
    arr = np.zeros(geo.cells, dtype=stage)
    if tt.nnz:
        inds = tt.inds.astype(np.int64, copy=False)
        if len(geo.others) > 1:
            outer = np.ravel_multi_index(
                [inds[k] for k in geo.others[:-1]],
                [tt.dims[k] for k in geo.others[:-1]])
        else:
            outer = np.zeros(tt.nnz, dtype=np.int64)
        flat = np.ravel_multi_index(
            (inds[mode], outer, inds[geo.inner]),
            (geo.ntiles * geo.tile, geo.n_outer, geo.inner_pad))
        np.add.at(arr, flat, np.asarray(tt.vals, dtype=stage))
    mask = np.zeros((geo.n_outer, geo.inner_pad), dtype=bool)
    mask[:, :tt.dims[geo.inner]] = True
    tiles = torch.from_numpy(arr.reshape(geo.ntiles, geo.tile, geo.span))
    lay = DenseModeLayout(
        tiles=tiles.to(dev).to(val_dtype),
        mask=torch.from_numpy(mask.reshape(-1)).to(dev),
        mode=mode, dims=tuple(int(d) for d in tt.dims), nnz=tt.nnz,
        val_storage="bf16" if val_dtype == torch.bfloat16 else "auto",
        reorder=reorder_label)
    if verbose:
        print(f"  layout mode{mode}: dense tiles {geo.ntiles}x{geo.tile}"
              f"x{geo.span} (density {lay.density():.3g}, zero index "
              f"bytes)")
    return lay


def densify_layout(layout: ModeLayout, dims: Sequence[int],
                   val_dtype=None) -> DenseModeLayout:
    """The dense tiles of a sorted layout's mode without sorting the COO
    again: the real entries are recovered through ``mode_ids`` and
    ``real_mask``, so the result equals :func:`build_dense_layout` of
    the same tensor.  `dims` gives the other modes' extents."""
    real = torch.from_numpy(layout.real_mask().reshape(-1)).to(
        layout.device)
    inds = torch.stack([layout.mode_ids(k)
                        for k in range(layout.nmodes)])[:, real]
    vals = layout.vals[real].to(torch.float64)
    tt = SparseTensor(inds.cpu().numpy().astype(np.int64),
                      vals.cpu().numpy(), tuple(int(d) for d in dims))
    return build_dense_layout(
        tt, layout.mode,
        val_dtype=layout.vals.dtype if val_dtype is None else val_dtype,
        device=layout.device, reorder_label=layout.reorder)


def alloc_build_modes(dims: Sequence[int], opts: Options) -> List[int]:
    """Which modes get their own sorted layout (≙ splatt_csf_alloc,
    src/csf.c:770-814): ONEMODE the smallest mode, TWOMODE the smallest
    and the largest, ALLMODE every mode."""
    nmodes = len(dims)
    by_size = sorted(range(nmodes), key=lambda m: (dims[m], m))
    if opts.block_alloc is BlockAlloc.ONEMODE:
        return [by_size[0]]
    if opts.block_alloc is BlockAlloc.TWOMODE:
        modes = [by_size[0]]
        if nmodes > 1 and by_size[-1] != by_size[0]:
            modes.append(by_size[-1])
        return modes
    return list(range(nmodes))


@dataclasses.dataclass
class BlockedSparse:
    """Per-mode layouts and the mode -> layout map (≙ splatt_csf[]).

    ``perm`` is the :class:`~splatt_tpu_torch.reorder.Permutation` the
    tensor was relabeled by before the layouts were built (None for the
    identity) and ``reorder`` its recipe: factors computed over these
    layouts live in the relabeled row space, and :func:`cpd_als` moves
    its init in and its output factors out through ``perm``.
    ``build_seconds`` holds the host seconds of the build's stages:
    ``"sort"`` and ``"pack"`` summed over the sparse layouts, and
    ``"reorder"`` when :meth:`compile` built it."""

    layouts: List[Union[ModeLayout, DenseModeLayout]]
    mode_map: Dict[int, int]
    dims: Tuple[int, ...]
    nnz: int
    opts: Options
    perm: Optional[object] = None
    reorder: str = "identity"
    build_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def nmodes(self) -> int:
        return len(self.dims)

    @property
    def device(self) -> torch.device:
        return self.layouts[0].device

    def layout_for(self, mode: int) -> ModeLayout:
        return self.layouts[self.mode_map[mode]]

    def to(self, device) -> "BlockedSparse":
        return dataclasses.replace(
            self, layouts=[lay.to(device) for lay in self.layouts])

    def storage_bytes(self) -> int:
        return sum(lay.storage_bytes() for lay in self.layouts)

    def format_summary(self) -> str:
        """One achieved format per layout, e.g.
        ``mode0=u16/seg/bf16 mode1=u16/seg/bf16``."""
        return " ".join(f"mode{lay.mode}={lay.format_desc()}"
                        for lay in self.layouts)

    def imbalance(self) -> Dict[str, dict]:
        """Per-layout balance recomputed from the layouts on the host
        (≙ splatt_tpu.blocked.BlockedSparse.imbalance): real nonzeros per
        block and row span per block as max/mean, and the one-hot work
        per nonzero; the figures ``layout_imbalance`` events carry.  Dense
        layouts have no nonzero stream and are left out."""
        from splatt_tpu_torch.utils.env import max_mean_ratio

        out = {}
        for lay in self.layouts:
            if lay.encoding == "dense":
                continue
            real = lay.real_mask()
            counts = np.count_nonzero(real, axis=1)
            rows = lay.mode_ids(lay.mode).cpu().numpy().reshape(
                lay.nblocks, lay.block).astype(np.int64)
            rows = np.where(real, rows, rows.min(axis=1, keepdims=True))
            spans = np.minimum(rows.max(axis=1) - rows.min(axis=1) + 1,
                               lay.dim if lay.dim > 0 else 1)
            out[f"mode{lay.mode}"] = dict(
                packing=lay.packing, nblocks=lay.nblocks,
                seg_width=lay.seg_width,
                block_nnz_max_mean=max_mean_ratio(counts),
                span_max_mean=max_mean_ratio(spans),
                work_amp=round(lay.nblocks * lay.seg_width * lay.block
                               / max(lay.nnz, 1), 2))
        return out

    @staticmethod
    def from_coo(tt: SparseTensor, opts: Optional[Options] = None,
                 device=None, reorder_label: str = "identity",
                 tuned_blocks: Optional[Dict[int, int]] = None,
                 tuned_formats: Optional[Dict[int, LayoutFormat]] = None,
                 tuned_packings: Optional[Dict[int, str]] = None,
                 tuned_dense: Optional[Dict[int, bool]] = None
                 ) -> "BlockedSparse":
        """Build the layouts the alloc policy asks for; a mode without
        its own layout maps to the first one.  The format comes from
        ``opts`` else the env (:func:`layout_format`), the packing from
        ``opts`` else the env (:func:`resolve_packing`); every layout stores its values at one
        dtype, so the CPD derives one factor dtype from them.
        `reorder_label` names the relabeling `tt` went through (every
        layout carries it; :meth:`compile` applies it).

        The autotuner's hooks (≙ splatt_tpu/blocked.py:1432-1581), which
        :meth:`compile` fills from the plan cache: `tuned_blocks`,
        `tuned_formats` and `tuned_packings` (mode -> nnz_block,
        :class:`LayoutFormat`, packing) override the run's for that
        mode's build, and `tuned_dense` (mode -> True) gives a mode a
        dense layout whatever the dense policy says.  The value storage
        is one for the whole tensor: a pinned policy wins, else a
        unanimous tuned verdict; the plan of a mode whose tuned storage
        cannot follow it is dropped whole, with a ``tuner_degraded``
        event.

        The hybrid per-mode dispatch: under the dense policy
        (``opts.dense`` else SPLATT_DENSE) each mode that passes
        :func:`dense_mode_verdict` gets a :class:`DenseModeLayout`
        appended after the sparse layouts and its ``mode_map`` entry
        remapped to it.  ``layouts[0]`` stays a sparse layout, which
        :meth:`frobsq` and the CPD's dtype read.  A failed dense build
        (an armed ``format.dense`` fault, a blowup past the cap) leaves
        the mode on its sparse layout, with a ``format_fallback`` event
        carrying ``site="dense"``.  A non-default format leaves a
        ``format_v2`` event and, at verbosity LOW, a ``format:`` line."""
        from splatt_tpu_torch import resilience

        opts = (opts or default_opts()).validate()
        dev = resolve_device(device)
        fmt = layout_format(opts)
        packing = resolve_packing(opts)
        tuned_blocks = dict(tuned_blocks or {})
        tuned_formats = dict(tuned_formats or {})
        tuned_packings = dict(tuned_packings or {})
        tuned_dense = dict(tuned_dense or {})
        # one storage dtype across layouts: pinned policy > unanimous
        # tuned verdict > compute dtype
        val_pol = fmt.val
        if val_pol == "auto" and tuned_formats:
            verdicts = {f.val for f in tuned_formats.values()}
            if len(verdicts) == 1:
                val_pol = verdicts.pop()
        for m in sorted(m for m, f in tuned_formats.items()
                        if f.val != val_pol):
            # built at a storage it was never measured at, the plan would
            # make a layout dispatch's strict match rejects: drop it whole
            tuned_formats.pop(m)
            tuned_blocks.pop(m, None)
            tuned_packings.pop(m, None)
            resilience.run_report().add(
                "tuner_degraded", mode=m,
                reason=f"tuned val_storage could not apply under the "
                       f"resolved storage policy {val_pol!r}; mode keeps "
                       f"the default format and the heuristic chain")
        seconds = {"sort": 0.0, "pack": 0.0}
        storage = resolve_storage_dtype(val_pol, resolve_dtype(opts))
        verbose = opts.verbosity >= Verbosity.LOW
        build_modes = alloc_build_modes(tt.dims, opts)
        layouts = [build_layout(tt, m, block=tuned_blocks.get(m, opts.nnz_block),
                                val_dtype=storage,
                                mode_order=opts.mode_order,
                                mode_order_custom=opts.mode_order_custom,
                                device=dev,
                                fmt=LayoutFormat(
                                    idx=(tuned_formats[m].idx
                                         if m in tuned_formats else fmt.idx),
                                    val=val_pol),
                                verbose=verbose, dense=False,
                                packing=tuned_packings.get(m, packing),
                                reorder_label=reorder_label,
                                seconds=seconds)
                   for m in build_modes]
        mode_map = {m: build_modes.index(m) if m in build_modes else 0
                    for m in range(tt.nmodes)}
        for m in range(tt.nmodes):
            want = tuned_dense.get(m)
            if want is None:
                want = _wants_dense(tt.dims, m, tt.nnz, opts)
            if not want:
                continue
            dense = _dense_or_degrade(m, verbose, lambda m=m: (
                build_dense_layout(tt, m, val_dtype=storage, device=dev,
                                   verbose=verbose,
                                   reorder_label=reorder_label)))
            if dense is not None:
                mode_map[m] = len(layouts)
                layouts.append(dense)
        bs = BlockedSparse(layouts=layouts, mode_map=mode_map,
                           dims=tt.dims, nnz=tt.nnz, opts=opts,
                           reorder=reorder_label, build_seconds=seconds)
        if (any(lay.encoding in ("v2", "dense") for lay in layouts)
                or val_pol != "auto"):
            resilience.run_report().add(
                "format_v2",
                modes={str(lay.mode): lay.format_desc() for lay in layouts})
            if verbose:
                print(f"  format: {bs.format_summary()}")
        return bs

    @staticmethod
    def compile(tt: SparseTensor, opts: Optional[Options] = None,
                device=None, rank: Optional[int] = None) -> "BlockedSparse":
        """:meth:`from_coo` after the run's reorder, at the autotuner's
        cached plans (≙ splatt_tpu.blocked.BlockedSparse.compile).

        With a `rank` and autotune on (``opts.autotune`` else
        SPLATT_AUTOTUNE), each mode's plan for this tensor's regime
        (:func:`tune.tuned_build_for`, the cache of `device`) gives its
        layout's block, index width, value storage and packing, or a
        dense layout.  The reorder is one for the whole tensor: a pinned
        one (``opts.reorder`` else SPLATT_REORDER) wins, else the plans'
        unanimous recipe, else identity.  A plan that cannot apply is
        dropped whole, with a ``tuner_degraded`` event: one measured
        under another recipe, under the packing the user pinned
        (:func:`config.packing_pinned`), or under a recipe that degraded
        to identity.  Without a rank, or with autotune off, the reorder
        is the pinned one or identity and the layouts follow the run's
        options.

        The reorder relabels the whole tensor under the ``reorder.apply``
        fault site, where any failure degrades to identity order with a
        ``reorder_fallback`` event (:func:`reorder.apply_reorder`).  The
        result carries the :class:`~splatt_tpu_torch.reorder.Permutation`
        (``perm``), so :func:`cpd_als` returns factors in the original
        row order, and ``build_seconds["reorder"]`` the reorder's host
        seconds."""
        from splatt_tpu_torch import resilience
        from splatt_tpu_torch.config import packing_pinned
        from splatt_tpu_torch.reorder import apply_reorder

        opts = (opts or default_opts()).validate()
        dev = resolve_device(device)
        plans = {}
        if rank is not None:
            from splatt_tpu_torch import tune

            if tune.autotune_enabled(opts.autotune):
                plans = tune.tuned_build_for(tt, rank, resolve_dtype(opts),
                                             device=dev)

        def drop(modes, reason: str) -> None:
            for m in sorted(modes):
                plans.pop(m)
                resilience.run_report().add("tuner_degraded", mode=m,
                                            reason=reason)

        how = resolve_reorder(opts)
        if how is None:
            verdicts = {p.reorder for p in plans.values()}
            how = verdicts.pop() if len(verdicts) == 1 else "identity"
        drop([m for m, p in plans.items() if p.reorder != how],
             f"tuned reorder recipe could not apply under the resolved "
             f"whole-tensor recipe {how!r}; mode keeps the default layout "
             f"policy")
        pinned = packing_pinned(opts)
        if pinned is not None:
            drop([m for m, p in plans.items() if p.packing != pinned],
                 f"tuned fiber packing could not apply under the pinned "
                 f"policy {pinned!r}; mode keeps the default layout policy")
        t0 = time.perf_counter()
        tt, perm = apply_reorder(tt, how)
        reorder_s = time.perf_counter() - t0
        if perm is None and how != "identity":
            # the recipe degraded: the plans measured under it go too
            drop([m for m, p in plans.items() if p.reorder != "identity"],
                 f"tuned plan was measured under reorder {how!r}, which "
                 f"degraded to identity; mode keeps the default layout "
                 f"policy")
            how = "identity"
        # dense-path plans leave the sparse build: their block is the row
        # tile and their idx_width the sentinel "dense"
        sparse = {m: p for m, p in plans.items() if p.path != "dense"}
        bs = BlockedSparse.from_coo(
            tt, opts, device=dev, reorder_label=how,
            tuned_blocks={m: p.nnz_block for m, p in sparse.items()},
            tuned_formats={m: LayoutFormat(idx=p.idx_width,
                                           val=p.val_storage)
                           for m, p in sparse.items()},
            tuned_packings={m: p.packing for m, p in sparse.items()},
            tuned_dense={m: True for m, p in plans.items()
                         if p.path == "dense"})
        bs.perm = perm
        bs.build_seconds["reorder"] = reorder_s
        return bs

    def frobsq(self) -> float:
        """Squared Frobenius norm of the first layout's values, which is
        always a sparse one, accumulated in f64 on the host
        (≙ csf_frobsq, src/csf.c:828-851)."""
        v = self.layouts[0].vals.to("cpu", torch.float64)
        return float(torch.dot(v, v))


# -- batched fleets (docs/batched.md) -----------------------------------------
#
# Many small tensors of one shape regime, each too small to fill the card
# alone: K slots are padded to the regime's bucket shape and stacked on a
# leading batch axis, so one sweep serves all of them (≙ splatt_tpu/
# blocked.py:1729-1886).  Each slot keeps its own fit and health verdict.


def bucket_dims(dims: Sequence[int]) -> Tuple[int, ...]:
    """The regime's padded bucket shape: each mode padded to the power of
    two just above its :func:`splatt_tpu_torch.tune.shape_regime` bucket
    (``1 << bit_length``), so every tensor of one regime pads to the same
    shape."""
    return tuple(1 << int(d).bit_length() for d in dims)


def bucket_nnz_pad(nnz: int, block: int) -> int:
    """The regime's padded nonzero count: the nnz bucket (``1 <<
    bit_length``) rounded up to whole blocks, shared by every slot of
    every batch of the regime."""
    return ceil_to(1 << int(max(nnz, 1)).bit_length(), block)


@dataclasses.dataclass
class BatchedBlocked:
    """K same-regime tensors stacked into one batch (≙ splatt_tpu.blocked.
    BatchedBlocked).

    Each slot is built by :func:`build_layout` at one common
    configuration: one sort mode, one block, v1 global int32 ids (per-slot
    v2 widths would differ and could not stack), fixed packing, no dense
    mode, one value-storage dtype (bf16 included: the factors follow it
    and accumulate in f32 as in the single-tensor sweep).  Then it is
    padded to the regime's bucket shape.  Pads are additive identities by
    the layouts' sentinel policy: value 0, sorted-mode id the slot's true
    ``dim`` (a padded row), 0 elsewhere.

    inds: ``(K, nmodes, nnz_pad)`` int32 global ids; vals: ``(K,
    nnz_pad)`` at the storage dtype; dims: the bucket (padded) dims;
    slot_dims, slot_nnz: each slot's true dims and nonzero count.
    """

    inds: torch.Tensor
    vals: torch.Tensor
    dims: Tuple[int, ...] = ()
    slot_dims: Tuple[Tuple[int, ...], ...] = ()
    slot_nnz: Tuple[int, ...] = ()
    sort_mode: int = 0
    block: int = 4096
    regime: str = ""
    val_storage: str = "auto"

    @property
    def k(self) -> int:
        return int(self.vals.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.dims)

    @property
    def nnz_pad(self) -> int:
        return int(self.vals.shape[1])

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "BatchedBlocked":
        return dataclasses.replace(self, inds=self.inds.to(device),
                                   vals=self.vals.to(device))

    def slot_frobsq(self) -> np.ndarray:
        """(K,) per-slot squared Frobenius norms, accumulated in f64 on
        the host like :meth:`BlockedSparse.frobsq` (pads are zero)."""
        v = self.vals.to("cpu", torch.float64).numpy()
        return np.einsum("kz,kz->k", v, v)

    def __repr__(self) -> str:
        return (f"BatchedBlocked(k={self.k}, dims={self.dims}, "
                f"nnz_pad={self.nnz_pad}, block={self.block}, "
                f"sort_mode={self.sort_mode}, regime={self.regime!r}, "
                f"val={str(self.vals.dtype).replace('torch.', '')})")


def batch_compile(tensors: Sequence[SparseTensor],
                  opts: Optional[Options] = None,
                  rank: Optional[int] = None, device=None) -> BatchedBlocked:
    """Stack K same-regime COO tensors into one :class:`BatchedBlocked`
    (≙ splatt_tpu.blocked.batch_compile), built on the host and moved to
    `device` (the card unless the caller names another) once.

    Every slot must share one :func:`splatt_tpu_torch.tune.shape_regime`
    and one mode count, else ValueError.  The sort mode is the smallest
    bucket mode (ties to the lowest index).  The block is the autotuner's
    batched plan (:func:`splatt_tpu_torch.tune.batched_block_for`, the
    batch axis in the plan key), else ``opts.nnz_block``, clamped to the
    largest slot's nonzeros padded to 128."""
    from splatt_tpu_torch import tune as _tune

    if not tensors:
        raise ValueError("batch_compile needs at least one tensor")
    opts = (opts or default_opts()).validate()
    dev = resolve_device(device)
    nmodes = tensors[0].nmodes
    regime = _tune.shape_regime(tensors[0].dims, tensors[0].nnz)
    for i, tt in enumerate(tensors):
        if tt.nmodes != nmodes:
            raise ValueError(
                f"batch slot {i} has {tt.nmodes} modes, slot 0 has "
                f"{nmodes} — a batch must be mode-count homogeneous")
        r = _tune.shape_regime(tt.dims, tt.nnz)
        if r != regime:
            raise ValueError(
                f"batch slot {i} is in shape regime {r}, slot 0 in "
                f"{regime} — a batch must share one regime "
                f"(docs/batched.md)")
    dims_pad = bucket_dims(tensors[0].dims)
    sort_mode = int(np.argmin(np.asarray(dims_pad)))
    fmt = layout_format(opts)
    compute = resolve_dtype(opts)
    storage = resolve_storage_dtype(fmt.val, compute)
    block = _tune.batched_block_for(
        tensors[0].dims, tensors[0].nnz, sort_mode, rank, compute,
        len(tensors), autotune=opts.autotune, device=dev)
    if block is None:
        block = opts.nnz_block
    most = max(t.nnz for t in tensors)
    block = max(128, min(int(block), ceil_to(most, 128)))
    nnz_pad = bucket_nnz_pad(most, block)

    inds = np.zeros((len(tensors), nmodes, nnz_pad), dtype=np.int32)
    vals = torch.zeros((len(tensors), nnz_pad), dtype=storage)
    for i, tt in enumerate(tensors):
        lay = build_layout(tt, sort_mode, block=block, val_dtype=storage,
                           mode_order=opts.mode_order,
                           mode_order_custom=opts.mode_order_custom,
                           device="cpu",
                           fmt=LayoutFormat(idx="i32", val=fmt.val),
                           packing="fixed", record_stats=False, dense=False)
        n = lay.nnz_pad
        inds[i, :, :n] = lay.inds.numpy()
        # past the slot's own blocks the sentinel row is its true dim,
        # which lies inside the bucket and collects only zeros
        inds[i, sort_mode, n:] = tt.dims[sort_mode]
        vals[i, :n] = lay.vals
    return BatchedBlocked(
        inds=torch.from_numpy(inds).to(dev), vals=vals.to(dev),
        dims=dims_pad, slot_dims=tuple(tuple(t.dims) for t in tensors),
        slot_nnz=tuple(t.nnz for t in tensors), sort_mode=sort_mode,
        block=block, regime=regime, val_storage=fmt.val)
