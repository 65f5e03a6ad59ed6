"""MTTKRP algorithm comparison (≙ splatt_tpu/bench_algs.py; src/bench.c and
cmd_bench.c).

The algorithms keep the JAX package's names:

- ``stream``: the COO gather product and ``index_add_`` (the oracle);
- ``blocked``: the plain one-hot engine (``xla_scan``, chunked over
  blocks) forced on the layouts, on either device: a timing baseline;
- ``blocked_pallas``: the kernel chain (``mttkrp_blocked``, an autotuned
  plan at its head), on a card only: a CPU tensor has no kernels, so it
  reads nan there;
- ``scatter``: the gather product and ``index_add_`` over the layouts'
  arrays;
- ``ttbox``: one pass per rank column (:func:`mttkrp_ttbox`);
- ``native``: the host C++ engine (``ops.mttkrp.run_native``) on a CPU
  v1 layout where ``native_runnable`` holds; nan on a card and wherever
  it does not run.

A time is host seconds per call, fenced with ``torch.cuda.synchronize``
on a card.  The bytes and flop models are the JAX package's arithmetic;
the peaks are the port's own table (:data:`HBM_PEAK_GBS`,
:data:`FLOP_PEAK_GFLOPS`), and any device outside it, the CPU included,
takes the nominal CPU figures in the roofline verdict.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from splatt_tpu_torch.blocked import BlockedSparse, ceil_to
from splatt_tpu_torch.config import (BlockAlloc, Options, resolve_device,
                                     resolve_dtype)
from splatt_tpu_torch.coo import SparseTensor
from splatt_tpu_torch.cpd import init_factors
from splatt_tpu_torch.ops.mttkrp import (_run_engine, mttkrp_blocked,
                                         mttkrp_stream, mttkrp_ttbox,
                                         native_runnable, run_native)
from splatt_tpu_torch.utils.env import host_fence

ALGS = ("stream", "blocked", "blocked_pallas", "scatter", "ttbox",
        "native")


def _alg_plan(alg: str, layout, mode: int, dim: int, opts: Options):
    """(path, forced engine or None for the chain) of a layout algorithm,
    or None when the configuration cannot run (a privatized width over
    ``priv_cap``).  Raises on an unknown name."""
    if alg == "scatter":
        return ("sorted_scatter" if layout.mode == mode else "scatter"), None
    if alg in ("blocked", "blocked_pallas"):
        if layout.encoding == "dense":
            return "dense", ("dense_xla" if alg == "blocked" else None)
        path = "sorted_onehot" if layout.mode == mode else "privatized"
        if path == "privatized" and dim + 16 > opts.priv_cap:
            return None
        return path, ("xla_scan" if alg == "blocked" else None)
    raise ValueError(f"unknown algorithm {alg!r}")


def _runner(alg: str, bs, inds, vals, factors, mode: int, dim: int,
            opts: Options):
    """A no-argument call computing `alg`'s MTTKRP of `mode`, or None
    when the algorithm does not run here."""
    dev = factors[0].device
    if alg == "stream":
        return lambda: mttkrp_stream(inds, vals, factors, mode, dim)
    if alg == "ttbox":
        return lambda: mttkrp_ttbox(inds, vals, factors, mode, dim)
    if alg == "native":
        layout = bs.layout_for(mode)
        if dev.type != "cpu" or not native_runnable(layout, factors):
            return None
        return lambda: run_native(layout, factors, mode)
    if alg == "blocked_pallas" and dev.type != "cuda":
        return None
    layout = bs.layout_for(mode)
    plan = _alg_plan(alg, layout, mode, dim, opts)
    if plan is None:
        return None
    path, engine = plan
    if engine is not None:
        return lambda: _run_engine(engine, layout, factors, mode, path)
    return lambda: mttkrp_blocked(layout, factors, mode, path=path)


def _time_call(fn, warmup: int = 1, reps: int = 3) -> float:
    for _ in range(warmup):
        host_fence(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    host_fence(out)
    return (time.perf_counter() - t0) / reps


def _operands(tt: SparseTensor, rank: int, opts: Options, dev):
    dtype = resolve_dtype(opts)
    gen = torch.Generator().manual_seed(opts.seed() or 1)
    factors = init_factors(tt.dims, rank, gen, dtype=dtype, device=dev)
    inds = torch.from_numpy(np.ascontiguousarray(tt.inds)).to(dev)
    vals = torch.from_numpy(np.ascontiguousarray(tt.vals)).to(dev, dtype)
    return factors, inds, vals


def bench_mttkrp(tt: SparseTensor, rank: int = 16,
                 algs: Sequence[str] = ALGS,
                 opts: Optional[Options] = None, reps: int = 3,
                 return_layouts: bool = False, device=None):
    """Seconds per call of each algorithm on each mode, on `device`
    (default the card): alg -> [sec per mode], nan where it does not run
    (≙ the per-mode timing loop of src/bench.c:84-117).  With
    `return_layouts`, also each mode's layout for the roofline model."""
    opts = opts or Options(block_alloc=BlockAlloc.ALLMODE)
    dev = resolve_device(device)
    factors, inds, vals = _operands(tt, rank, opts, dev)
    needs_blocked = any(a not in ("stream", "ttbox") for a in algs)
    bs = BlockedSparse.from_coo(tt, opts, device=dev) if needs_blocked \
        else None
    results: Dict[str, List[float]] = {}
    for alg in algs:
        times: List[float] = []
        for mode in range(tt.nmodes):
            fn = _runner(alg, bs, inds, vals, factors, mode, tt.dims[mode],
                         opts)
            times.append(float("nan") if fn is None
                         else _time_call(fn, reps=reps))
        results[alg] = times
    if return_layouts:
        layouts = ([bs.layout_for(m) for m in range(tt.nmodes)]
                   if bs is not None else None)
        return results, layouts
    return results


def crosscheck_mttkrp(tt: SparseTensor, rank: int = 16,
                      algs: Sequence[str] = ALGS,
                      opts: Optional[Options] = None, device=None) -> float:
    """Largest deviation of any algorithm from ``stream`` over all modes,
    relative to max(max|stream|, 1) (≙ splatt_tpu.bench_algs.
    crosscheck_mttkrp).  Configurations that do not run here are counted
    on stderr."""
    import sys

    opts = opts or Options(block_alloc=BlockAlloc.ALLMODE)
    dev = resolve_device(device)
    factors, inds, vals = _operands(tt, rank, opts, dev)
    bs = BlockedSparse.from_coo(tt, opts, device=dev)
    worst = 0.0
    skipped = 0
    for mode in range(tt.nmodes):
        ref = mttkrp_stream(inds, vals, factors, mode, tt.dims[mode])
        ref = ref.to("cpu", torch.float64)
        scale = max(float(ref.abs().max()), 1.0)
        for alg in algs:
            if alg == "stream":
                continue
            fn = _runner(alg, bs, inds, vals, factors, mode, tt.dims[mode],
                         opts)
            if fn is None:
                skipped += 1
                continue
            out = fn().to("cpu", torch.float64)
            worst = max(worst, float((out - ref).abs().max()) / scale)
    if skipped:
        print(f"crosscheck: {skipped} (alg, mode) configs skipped (not "
              f"runnable on {dev.type}, or a privatized width over "
              f"priv_cap)", file=sys.stderr)
    return worst


def format_bench(results: Dict[str, List[float]]) -> str:
    lines = []
    for alg, times in results.items():
        cols = "  ".join(
            f"mode{m}: {'  nan  ' if np.isnan(t) else f'{t:0.5f}'}"
            for m, t in enumerate(times))
        total = np.nansum(times)
        lines.append(f"  {alg:<16s} {cols}  total: {total:0.5f}s")
    return "\n".join(lines)


# -- the roofline model --------------------------------------------------------

#: peak device-memory bandwidth (GB/s) by torch.cuda.get_device_name():
#: H100 SXM5 data sheet, HBM3 3.35 TB/s, for the card that nvidia-smi
#: reports as "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_PEAK_GBS = {"NVIDIA H100 80GB HBM3": 3350.0}

#: peak f32 compute outside the tensor cores (FFMA, GFLOP/s) by device
#: name: H100 SXM5 data sheet, 67 TFLOP/s, for "NVIDIA H100 80GB HBM3,
#: 700.00 W" (a card set below 700 W runs slower under load)
FLOP_PEAK_GFLOPS = {"NVIDIA H100 80GB HBM3": 67000.0}

#: nominal CPU peaks (≙ splatt_tpu.bench_algs): the verdict only needs
#: the ridge's order of magnitude, on any device outside the tables
NOMINAL_CPU_GBS = 50.0
NOMINAL_CPU_GFLOPS = 100.0


def _device_name(device) -> Optional[str]:
    """The card's name, or None for the CPU (or no card)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def hbm_peak_gbs(device=None) -> Optional[float]:
    """Peak memory bandwidth of `device` (default the current card) from
    :data:`HBM_PEAK_GBS`, or None (the CPU, or a card not in it)."""
    return HBM_PEAK_GBS.get(_device_name(device))


def compute_peak_gflops(device=None) -> Optional[float]:
    """Peak f32 compute of `device` from :data:`FLOP_PEAK_GFLOPS`, or
    None (the JAX package's ``mxu_peak_gflops``)."""
    return FLOP_PEAK_GFLOPS.get(_device_name(device))


def mttkrp_bytes(alg: str, tt: SparseTensor, rank: int, mode: int,
                 itemsize: int, layout=None) -> float:
    """First-order device-memory bytes of one MTTKRP (≙ splatt_tpu.
    bench_algs.mttkrp_bytes): the index and value streams, one factor
    row per nonzero per input mode, and the output, plus each
    algorithm's own traffic: the blocked algorithms' ``(nb, S, R)``
    partials written and combined, the kernel chain's tables read once
    instead of a row per nonzero, ttbox's pass per rank column."""
    nnz = tt.nnz
    nmodes = tt.nmodes
    acc = 4  # f32 accumulator width
    out = tt.dims[mode] * rank * acc
    idx_val = nnz * (nmodes * 4 + itemsize)
    rows = (nmodes - 1) * nnz * rank * itemsize
    if alg == "stream":
        return idx_val + rows + out
    if alg == "ttbox":
        return rank * (idx_val + (nmodes - 1) * nnz * itemsize) + out
    if alg == "scatter":
        return idx_val + rows + out
    if alg in ("blocked", "blocked_pallas"):
        # a dense layout has no blocks: the model without a layout (the
        # JAX package raises there)
        nb = getattr(layout, "nblocks", 1)
        S = getattr(layout, "seg_width", 8)
        partials = 2 * nb * S * rank * acc
        if alg == "blocked_pallas":
            tables = sum(d * rank * itemsize
                         for k, d in enumerate(tt.dims) if k != mode)
            return idx_val + tables + partials + out
        return idx_val + rows + partials + out
    if alg == "native":
        return idx_val + rows + out
    raise ValueError(f"unknown algorithm {alg!r}")


def mttkrp_bytes_encoded(alg: str, X: BlockedSparse, rank: int, mode: int,
                         factor_itemsize: int) -> float:
    """:func:`mttkrp_bytes` over a built :class:`BlockedSparse`, the
    streams at their stored widths (``storage_bytes``) and the factor
    terms at the factors' itemsize; a dense layout streams its tiles,
    the tables once and its Khatri-Rao operand (≙ splatt_tpu.
    bench_algs.mttkrp_bytes_encoded)."""
    lay = X.layout_for(mode)
    nmodes, nnz = lay.nmodes, lay.nnz
    acc = 4  # f32 accumulator width
    out = X.dims[mode] * rank * acc
    streams = lay.storage_bytes()
    if lay.encoding == "dense":
        tables = sum(d * rank * factor_itemsize
                     for k, d in enumerate(X.dims) if k != mode)
        kr = 2 * lay.span * rank * factor_itemsize
        return streams + tables + kr + out
    rows = (nmodes - 1) * nnz * rank * factor_itemsize
    if alg in ("blocked", "blocked_pallas"):
        partials = 2 * lay.nblocks * lay.seg_width * rank * acc
        if alg == "blocked_pallas":
            tables = sum(d * rank * factor_itemsize
                         for k, d in enumerate(X.dims) if k != mode)
            return streams + tables + partials + out
        return streams + rows + partials + out
    return streams + rows + out


def mttkrp_decode_bytes(X: BlockedSparse, rank: int, mode: int,
                        engine: str) -> float:
    """Extra bytes an engine's operand prep spends decoding a compact
    layout to global int32 before its kernel (≙ splatt_tpu.bench_algs.
    mttkrp_decode_bytes; the JAX package's arithmetic, including its
    transposed-table request tiles for ``fused_t``/``fused_tg``).  Zero
    on v1 and dense layouts and for the stream-native engines."""
    from splatt_tpu_torch.ops.mttkrp import STREAM_NATIVE_ENGINES

    lay = X.layout_for(mode)
    if (lay.encoding in ("v1", "dense")
            or engine in STREAM_NATIVE_ENGINES or engine == "native"):
        return 0.0
    decoded = 2.0 * lay.nmodes * lay.nnz_pad * 4   # i32 write + read
    if engine in ("fused_t", "fused_tg"):
        b_pad = ceil_to(lay.block, 128)
        for k, d in enumerate(X.dims):
            if k != mode:
                d_pad = ceil_to(int(d), 128)
                ck = -(-b_pad // d_pad)
                decoded += 2.0 * lay.nblocks * ck * 8 * d_pad * 4
    return decoded


def mttkrp_flops(alg: str, X: BlockedSparse, rank: int,
                 mode: int) -> float:
    """First-order operations of one MTTKRP (≙ splatt_tpu.bench_algs.
    mttkrp_flops): a dense layout's matmul over its padded cells plus
    the Khatri-Rao build; otherwise a Hadamard chain and accumulate per
    nonzero per rank column, plus the one-hot expansion's
    multiply-adds for the blocked algorithms."""
    lay = X.layout_for(mode)
    if lay.encoding == "dense":
        geo = lay.geometry
        return 2.0 * geo.cells * rank + geo.span * rank
    flops = 2.0 * lay.nnz * rank * (lay.nmodes - 1)
    if alg in ("blocked", "blocked_pallas"):
        flops += 2.0 * lay.nblocks * lay.seg_width * lay.block * rank
    return flops


def roofline_verdict(bytes_moved: float, flops: float,
                     device=None) -> dict:
    """Arithmetic intensity (operations per byte), the device's ridge
    (peak operations over peak bandwidth) and the side of it the path
    sits on; devices outside the tables take the nominal CPU peaks."""
    peak_bw = hbm_peak_gbs(device) or NOMINAL_CPU_GBS
    peak_fl = compute_peak_gflops(device) or NOMINAL_CPU_GFLOPS
    intensity = flops / max(bytes_moved, 1.0)
    ridge = peak_fl / peak_bw
    return dict(intensity=round(intensity, 3), ridge=round(ridge, 3),
                bound=("compute" if intensity >= ridge else "memory"))


def roofline_report(tt: SparseTensor, results: Dict[str, List[float]],
                    rank: int, itemsize: int, layouts=None,
                    device=None) -> List[str]:
    """Per algorithm and mode, the model's GB/s and, on a card in
    :data:`HBM_PEAK_GBS`, its share of the peak."""
    peak = hbm_peak_gbs(device)
    lines = []
    for alg, times in results.items():
        cells = []
        for m, t in enumerate(times):
            if math.isnan(t) or t <= 0:
                cells.append(f"mode{m}:    --  ")
                continue
            lay = layouts[m] if layouts is not None else None
            gbs = mttkrp_bytes(alg, tt, rank, m, itemsize, lay) / t / 1e9
            pct = f" ({100 * gbs / peak:3.0f}%)" if peak else ""
            cells.append(f"mode{m}: {gbs:6.1f}{pct}")
        label = f"  {alg:<16s}"
        lines.append(label + "  ".join(cells)
                     + ("  GB/s of HBM peak" if peak else "  GB/s (model)"))
    return lines
