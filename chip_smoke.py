#!/usr/bin/env python3
"""Drive the PyTorch port's CPD-ALS main path on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: needs CUDA; prints the card, its power limit and the versions;
2. build: compiles every kernel from ``splatt_tpu_torch/csrc`` with
   ``nvcc -Xptxas -v`` and prints registers, shared memory and spills;
3. kernel against plain: NELL-2-shaped synthetic tensor (12092 x 9184 x
   28818, 20M nonzeros, rank 50, f32, ALLMODE).  For each mode the sorted
   contract of ``fused_mttkrp_t`` on the mode's own layout and the
   accumulate contract on layout (m+1) % 3 are held against
   ``fused_mttkrp_t_plain`` (max error <= 1e-4 of max|plain|), and both are
   timed with CUDA events beside the bound;
4. parity: a planted rank-8 tensor of the same dims (216k nonzeros),
   rank 16: ``cpd_als`` on the card (f32, kernel) against the CPU (f64,
   plain) from the same numpy init, 5 iterations, fits within 1e-4 at
   every iteration;
5. main path at full width: ``cpd_als`` on the phase-3 tensor for 5
   iterations with engine fallback off and every launch counter set to 0
   just before; the fit must be finite in (0, 1], no engine demoted and
   the kernel launched nmodes x iterations times; then each phase of a
   sweep is timed alone;
6. the other four kernels against their plain versions on the phase-3
   layouts: ``fused_mttkrp_tg`` and ``fused_mttkrp`` in both contracts on
   every mode (the phase-3 cases), ``onehot_reduce_sorted`` on each mode's
   own layout and ``onehot_reduce_full`` at width ceil8(dim+1) on layout
   (m+1) % 3, the products made once per case; each timed beside its
   bound, its plain version and, for the two reductions, one
   ``index_add_`` call; ``fused_mttkrp`` runs at its engine's chunk and is
   also timed at the chunk that cuts the grid to 8 CTAs per SM.  Then ``fused_mttkrp_tg`` against its plain
   version at rank 512 on a 2M-nonzero tensor of the same dims;
7. the engine chain at full width: ``cpd_als`` on the phase-3 tensor, rank
   50, 3 iterations, from one numpy init, under armed engine faults (see
   ``CHAIN_SCHEDULES``): each schedule's demotions and launch counts, fits
   within 1e-4 of the unfaulted run at every iteration, λ within 1e-4 of
   it, and each mode's MTTKRP through the engines left within 1e-4 of
   ``fused_mttkrp_t``'s.  Under ``RAISING_SCHEDULES`` ``cpd_als`` must
   raise: on the card the chain ends at the last kernel engine, so with
   every kernel engine faulted (or with fallback off) no plain-torch
   engine runs;
8. rank 512 at full width: ``cpd_als`` on the phase-3 layouts, 3
   iterations, no fault: the plan reads ``fused_tg`` on every mode, no
   demotion, ``fused_mttkrp_tg`` launched 9 times, the fit finite in
   (0, 1].

The line before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np

NELL2 = (12092, 9184, 28818)
NNZ = 20_000_000
RANK = 50
ITERS = 5
CHAIN_ITERS = 3
BIG_RANK = 512
BIG_RANK_NNZ = 2_000_000
PARITY_RANK = 16
PARITY_TOL = 1e-4      # f32 on the card against f64 on the CPU
KERNEL_TOL = 1e-4      # relative to max|plain|, f32 with atomics
LAMBDA_TOL = 1e-4      # λ of a faulted CPD against the unfaulted, relative
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic_tensor(dims, nnz: int, seed: int = 0):
    """Power-law synthetic tensor: zipf-skewed indices per mode (the
    flagship generator of the JAX package's bench.py)."""
    from splatt_tpu_torch.coo import SparseTensor

    rng = np.random.default_rng(seed)
    inds = np.empty((len(dims), nnz), dtype=np.int64)
    for m, d in enumerate(dims):
        raw = rng.zipf(1.3, size=nnz).astype(np.int64)
        inds[m] = (raw * 2654435761 + rng.integers(0, d, size=nnz)) % d
    vals = rng.random(nnz)
    return SparseTensor(inds, vals, dims)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def least_ms(moved: int, flops: int) -> tuple:
    """(ms, "bytes" or "operations"): the larger of `moved` bytes over the
    HBM rate and `flops` over the f32 rate."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def bound(layout, factors, mode: int, out) -> tuple:
    """Least time in ms for one fused MTTKRP call (fused_mttkrp_t, _tg or
    fused_mttkrp): every input byte read once and the output written once
    over the HBM rate, against nmodes x R FLOP per real nonzero over the
    f32 rate."""
    moved = nbytes(layout.inds, layout.vals, layout.row_start, out)
    moved += nbytes(*(U for k, U in enumerate(factors) if k != mode))
    return least_ms(moved, layout.nmodes * int(factors[0].shape[1])
                    * layout.nnz)


def reduce_bound(ids, prod, out, nnz: int) -> tuple:
    """Least time in ms for one onehot_reduce_* call: ids and products
    read once, the output written once, against R additions per real
    nonzero."""
    return least_ms(nbytes(ids, prod, out), int(prod.shape[-1]) * nnz)


def compare(fn, plain, label: str, reps: int = 20,
            plain_reps: int = 3) -> tuple:
    """Run a kernel wrapper and its plain version on the same inputs,
    fail past KERNEL_TOL of max|plain|, and time both; returns the
    kernel's output and the row of numbers."""
    import torch

    got = fn()
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel = err / scale if scale > 0 else err
    del want
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{label}: relative error {rel:.3e} > "
                             f"{KERNEL_TOL}")
    ms = time_ms(fn, reps=reps, warmup=2)
    plain_ms = time_ms(plain, reps=plain_reps)
    return got, dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                     plain_ms=plain_ms)


def phase_device() -> dict:
    import torch

    from splatt_tpu_torch.ops.kernels import nvcc_path

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {name}")
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc: {nvcc[-1]}")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> None:
    from splatt_tpu_torch.ops import kernels

    res = kernels.build(verbose=True)
    log(f"[build] nvcc -Xptxas -v over {len(kernels.SOURCES)} source(s): "
        f"{res['seconds']:.2f} s")
    for line in res["log"].splitlines():
        if re.search(r"registers|spill|smem|Compiling entry", line):
            log(f"[build]   {line.strip()}")
    kernels.load_library()


def random_factors(bs, rank: int, seed: int) -> list:
    """f32 uniform [0, 1) factor tables on the layouts' device."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((d, rank), dtype=np.float32)).to(
        bs.device) for d in bs.dims]


def contracts(bs):
    """(contract, layout, width, accumulate, mode) for both contracts of
    each mode: sorted on the mode's own layout, accumulate at width
    ceil8(dim+1) on layout (m+1) % nmodes."""
    for m in range(bs.nmodes):
        yield ("sorted", bs.layout_for(m), bs.layout_for(m).seg_width,
               False, m)
        yield ("accumulate", bs.layout_for((m + 1) % bs.nmodes),
               -(-(bs.dims[m] + 1) // 8) * 8, True, m)


def phase_kernels(bs, rank: int, seed: int = 1) -> list:
    """Each mode's two contracts against the plain version, timed."""
    import torch

    from splatt_tpu_torch.ops.kernels import (fused_mttkrp_t,
                                              fused_mttkrp_t_plain)

    factors = random_factors(bs, rank, seed)
    rows = []
    for contract, lay, width, acc, m in contracts(bs):
        got, row = compare(
            lambda: fused_mttkrp_t(lay, factors, m, width, acc),
            lambda: fused_mttkrp_t_plain(lay, factors, m, width, acc),
            f"fused_mttkrp_t {contract} mode {m}")
        row.update(contract=contract, mode=m, layout_mode=lay.mode,
                   width=width, nblocks=lay.nblocks, block=lay.block)
        row["bound_ms"], row["bound_by"] = bound(lay, factors, m, got)
        log(f"[kernel] {json.dumps(row)}")
        rows.append(row)
        del got
        torch.cuda.empty_cache()
    return rows


def planted_tensor(dims, clusters: int, side: int, seed: int):
    """An exactly rank-`clusters` tensor of the given dims: cluster c is the
    outer product of random positive vectors over rows [c*side, (c+1)*side)
    of every mode.  A CPD reaches a fit far from 0, so the card's and the
    CPU's fits are compared where they carry digits; adjacent clusters keep
    every block's row span small, so the sorted modes run the kernel."""
    from splatt_tpu_torch.coo import SparseTensor

    rng = np.random.default_rng(seed)
    grid = np.indices((side,) * len(dims)).reshape(len(dims), -1)
    inds, vals = [], []
    for c in range(clusters):
        inds.append(grid + c * side)
        v = np.ones(grid.shape[1])
        for m in range(len(dims)):
            v *= (rng.random(side) + 0.5)[grid[m]]
        vals.append(v)
    return SparseTensor(np.concatenate(inds, axis=1), np.concatenate(vals),
                        dims)


def phase_parity() -> None:
    """cpd_als on the card (f32) against the CPU (f64), same init."""
    import torch

    from splatt_tpu_torch import BlockedSparse, Options, cpd_als
    from splatt_tpu_torch.config import Verbosity

    tt = planted_tensor(NELL2, clusters=8, side=30, seed=3)
    rng = np.random.default_rng(4)
    init = [rng.random((d, PARITY_RANK)) for d in tt.dims]
    fits = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        opts = Options(max_iterations=ITERS, tolerance=0.0,
                       val_dtype=dtype, verbosity=Verbosity.NONE)
        bs = BlockedSparse.from_coo(tt, opts, device=dev)
        fits[dev] = cpd_als(bs, PARITY_RANK, opts, init=init,
                            device=dev).fits
    diff = max(abs(a - b) for a, b in zip(fits["cuda"], fits["cpu"]))
    log(f"[parity] fits card f32 {fits['cuda']}")
    log(f"[parity] fits cpu  f64 {fits['cpu']}")
    log(f"[parity] max |fit difference| {diff:.3e} (tolerance {PARITY_TOL})")
    if len(fits["cuda"]) != ITERS or not diff <= PARITY_TOL:
        raise AssertionError("card and CPU fits disagree")
    if not fits["cpu"][-1] > 0.5:
        raise AssertionError("the planted rank-8 model was not recovered")


def phase_main_path(bs, rank: int) -> dict:
    """The full-width CPD with the launch counter read around it, then
    each phase of a sweep timed alone on the final factors."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.config import BlockAlloc
    from splatt_tpu_torch.ops import kernels

    # fallback off: no rescue can hide a broken kernel
    opts = Options(block_alloc=BlockAlloc.ALLMODE, max_iterations=ITERS,
                   tolerance=0.0, random_seed=0, engine_fallback=False)
    resilience.reset_demotions()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = cpd_als(bs, rank, opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.fused_mttkrp_t.launches
    if resilience.demotions():
        raise AssertionError(f"demotions on the main path: "
                             f"{resilience.demotions()}")
    peak = torch.cuda.max_memory_allocated()
    fit = out.fit
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    log(f"[cpd] fits {list(out.fits)}")
    log(f"[cpd] iteration seconds {list(out.iter_seconds)}")
    log(f"[cpd] {steady:.5f} s/iteration (iterations 2..{ITERS}); whole "
        f"call {seconds:.3f} s with init, norm and post-processing; peak "
        f"device memory {peak / 2**30:.2f} GiB; fused_mttkrp_t launches "
        f"{launches}")
    if not (math.isfinite(fit) and 0.0 < fit <= 1.0):
        raise AssertionError(f"fit {fit} is not finite in (0, 1]")
    if launches != bs.nmodes * ITERS:
        raise AssertionError(f"fused_mttkrp_t launched {launches} times, "
                             f"expected {bs.nmodes * ITERS}")
    parts = sweep_phases(bs, out.factors, steady, "[cpd]")
    return {"launches": launches, "sec_per_iter": steady, "phases": parts}


def sweep_phases(bs, U, steady: float, tag: str) -> dict:
    """Where a sweep's time goes: each phase timed alone on factors `U`,
    summed over modes."""
    from splatt_tpu_torch import mttkrp
    from splatt_tpu_torch.ops.linalg import (form_normal_lhs, gram,
                                             normalize_columns,
                                             solve_normals)

    grams = [gram(u) for u in U]
    parts = {"mttkrp": 0.0, "solve": 0.0, "normalize+gram": 0.0}
    for m in range(bs.nmodes):
        M = mttkrp(bs, U, m)
        lhs = form_normal_lhs(grams, m)
        parts["mttkrp"] += time_ms(lambda: mttkrp(bs, U, m), reps=5)
        parts["solve"] += time_ms(lambda: solve_normals(lhs, M), reps=5)
        parts["normalize+gram"] += time_ms(
            lambda: gram(normalize_columns(M, "max")[0]), reps=5)
    log(f"{tag} sweep phases, ms summed over modes: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; MTTKRP share of a steady iteration "
          f"{parts['mttkrp'] / 1e3 / steady:.1%}")
    return parts


def phase_new_kernels(bs, rank: int, seed: int = 1) -> dict:
    """The other four kernels against their plain versions on the phase-3
    layouts and factors, timed beside their bounds."""
    import torch

    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import FUSED_CHUNK, _gather_prod

    dev = bs.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    factors = random_factors(bs, rank, seed)
    rows = {k: [] for k in ("fused_mttkrp_tg", "fused_mttkrp",
                            "onehot_reduce_sorted", "onehot_reduce_full")}
    for contract, lay, width, acc, m in contracts(bs):
        where = dict(contract=contract, mode=m, layout_mode=lay.mode,
                     width=width)
        # fused_mttkrp at its engine's chunk; also timed at the chunk that
        # cuts the grid to 8 CTAs per SM, the evidence for FUSED_CHUNK
        wide = -(-lay.nblocks // (8 * sms))
        fused = (("fused_mttkrp_tg", kernels.fused_mttkrp_tg,
                  kernels.fused_mttkrp_tg_plain, {}),
                 ("fused_mttkrp", kernels.fused_mttkrp,
                  kernels.fused_mttkrp_plain, {"chunk": FUSED_CHUNK}))
        for name, fn, plain, kw in fused:
            got, row = compare(
                lambda: fn(lay, factors, m, width, acc, **kw),
                lambda: plain(lay, factors, m, width, acc),
                f"{name} {contract} mode {m}")
            row.update(where, **kw)
            if kw:
                row["wide_chunk"] = wide
                row["wide_chunk_ms"] = time_ms(
                    lambda: fn(lay, factors, m, width, acc, chunk=wide),
                    reps=20, warmup=2)
            row["bound_ms"], row["bound_by"] = bound(lay, factors, m, got)
            log(f"[kernel] {name} {json.dumps(row)}")
            rows[name].append(row)
            del got
        # the reductions: the products once per case, and the flat ids
        # of the one index_add_ call that computes the same sum
        nb, B = lay.nblocks, lay.block
        prod = _gather_prod(lay.inds, lay.vals, factors,
                            m).reshape(nb, B, rank)
        if acc:
            name, fn, plain = ("onehot_reduce_full",
                               kernels.onehot_reduce_full,
                               kernels.onehot_reduce_full_plain)
            ids = lay.mode_ids(m).reshape(nb, B)
            flat, nrows = ids.long(), width
        else:
            name, fn, plain = ("onehot_reduce_sorted",
                               kernels.onehot_reduce_sorted,
                               kernels.onehot_reduce_sorted_plain)
            ids = lay.blocked_locals()
            flat = ids.long() + (torch.arange(nb, device=dev)[:, None]
                                 * width)
            nrows = nb * width
        ok = (ids >= 0) & (ids < width)
        flat = torch.where(ok, flat, torch.full_like(flat, nrows))
        flat = flat.reshape(-1)
        got, row = compare(lambda: fn(ids, prod, width),
                           lambda: plain(ids, prod, width),
                           f"{name} {contract} mode {m}")
        lib = torch.zeros((nrows + 1, rank), dtype=torch.float32,
                          device=dev)
        prod2 = prod.reshape(-1, rank)
        row["library_ms"] = time_ms(
            lambda: lib.zero_().index_add_(0, flat, prod2), reps=5)
        row.update(where)
        row["bound_ms"], row["bound_by"] = reduce_bound(ids, prod, got,
                                                        lay.nnz)
        log(f"[kernel] {name} {json.dumps(row)}")
        rows[name].append(row)
        del prod, prod2, got, lib, flat, ids
        torch.cuda.empty_cache()
    return rows


def phase_big_rank(seed: int = 5) -> list:
    """fused_mttkrp_tg against its plain version at rank 512, both
    contracts on every mode, on a 2M-nonzero tensor of the NELL-2 dims
    (the plain version needs ~3 x nnz x R x 4 bytes)."""
    import torch

    from splatt_tpu_torch import BlockedSparse, Options
    from splatt_tpu_torch.config import BlockAlloc
    from splatt_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    bs = BlockedSparse.from_coo(synthetic_tensor(NELL2, BIG_RANK_NNZ, seed),
                                Options(block_alloc=BlockAlloc.ALLMODE))
    log(f"[rank{BIG_RANK}] {BIG_RANK_NNZ}-nonzero layouts in "
        f"{time.perf_counter() - t0:.2f} s")
    factors = random_factors(bs, BIG_RANK, seed)
    rows = []
    for contract, lay, width, acc, m in contracts(bs):
        got, row = compare(
            lambda: kernels.fused_mttkrp_tg(lay, factors, m, width, acc),
            lambda: kernels.fused_mttkrp_tg_plain(lay, factors, m, width,
                                                  acc),
            f"fused_mttkrp_tg rank {BIG_RANK} {contract} mode {m}",
            reps=5, plain_reps=1)
        row.update(contract=contract, mode=m, layout_mode=lay.mode,
                   width=width, nnz=lay.nnz)
        row["bound_ms"], row["bound_by"] = bound(lay, factors, m, got)
        # the kernel's own traffic: each rank tile re-reads the id and
        # value streams
        tiles = -(-BIG_RANK // kernels.RANK_TILE)
        streams = nbytes(lay.inds, lay.vals, lay.row_start)
        row["rank_tiles"] = tiles
        row["tiled_bytes_ms"] = least_ms(
            streams * tiles + nbytes(got) + nbytes(
                *(U for k, U in enumerate(factors) if k != m)), 0)[0]
        log(f"[rank{BIG_RANK}] fused_mttkrp_tg {json.dumps(row)}")
        rows.append(row)
        del got
        torch.cuda.empty_cache()
    return rows


KERNEL_FAULTS = ("engine.fused_t:runtime,engine.fused_tg:runtime,"
                 "engine.fused:runtime,engine.unfused_pallas:runtime")

#: phase 7: (label, armed faults, SPLATT_EXPERIMENTAL_FUSED, privatize
#: mode 0, engines demoted, launches of each kernel, unlisted = 0)
CHAIN_SCHEDULES = [
    ("no fault", "", False, False, [], {"fused_mttkrp_t": 9}),
    ("fused_t faulted", "engine.fused_t:runtime", False, False,
     ["fused_t"], {"fused_mttkrp_tg": 9}),
    ("fused_t, fused_tg faulted",
     "engine.fused_t:runtime,engine.fused_tg:runtime", False, False,
     ["fused_t", "fused_tg"], {"onehot_reduce_sorted": 9}),
    ("fused_t, fused_tg faulted, experimental fused",
     "engine.fused_t:runtime,engine.fused_tg:runtime", True, False,
     ["fused_t", "fused_tg"], {"fused_mttkrp": 9}),
    ("fused_t, fused_tg faulted, mode 0 privatized",
     "engine.fused_t:runtime,engine.fused_tg:runtime", False, True,
     ["fused_t", "fused_tg"],
     {"onehot_reduce_full": 3, "onehot_reduce_sorted": 6}),
]

#: phase 7: schedules under which cpd_als must raise, no kernel launched:
#: (label, armed faults, SPLATT_EXPERIMENTAL_FUSED, engine fallback,
#: engines demoted, site named by the error)
RAISING_SCHEDULES = [
    ("every kernel engine faulted, experimental fused", KERNEL_FAULTS, True,
     True, ["fused_t", "fused_tg", "fused"], "engine.unfused_pallas"),
    ("every kernel engine faulted", KERNEL_FAULTS, False, True,
     ["fused_t", "fused_tg"], "engine.unfused_pallas"),
    ("fused_t faulted, fallback off", "engine.fused_t:runtime", False,
     False, [], "engine.fused_t"),
]


def phase_chain(bs, rank: int) -> dict:
    """cpd_als at full width under each of CHAIN_SCHEDULES (demotions,
    launch counts, fits and λ against the unfaulted run, each mode's
    MTTKRP through the engines left against fused_mttkrp_t's) and
    RAISING_SCHEDULES (cpd_als raises)."""
    import dataclasses
    import os

    import torch

    from splatt_tpu_torch import Options, cpd_als, mttkrp, resilience
    from splatt_tpu_torch.config import BlockAlloc, Verbosity
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import describe_plan
    from splatt_tpu_torch.utils import faults

    rng = np.random.default_rng(9)
    init = [rng.random((d, rank)) for d in bs.dims]
    plan_factors = [torch.as_tensor(U, dtype=torch.float32, device=bs.device)
                    for U in init]
    # mode 0 on mode 1's layout, short enough to privatize: the
    # accumulate contract on a full CPD
    priv = dataclasses.replace(
        bs, mode_map={0: 1, 1: 1, 2: 2},
        opts=Options(block_alloc=BlockAlloc.ALLMODE, priv_cap=1 << 15,
                     priv_threshold=1.0))

    def reset():
        faults.reset()
        resilience.reset_demotions()
        resilience.run_report().clear()
        kernels.reset_launches()

    def run(X, schedule: str, experimental: bool, fallback: bool):
        reset()
        for site, spec in faults.parse_schedule(schedule).items():
            faults.arm(site, spec)
        if experimental:
            os.environ["SPLATT_EXPERIMENTAL_FUSED"] = "1"
        try:
            opts = Options(max_iterations=CHAIN_ITERS, tolerance=0.0,
                           verbosity=Verbosity.NONE,
                           engine_fallback=fallback)
            t0 = time.perf_counter()
            out = cpd_als(X, rank, opts, init=init)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            faults.reset()

    def demoted_now():
        return [e["engine"] for e in
                resilience.run_report().events("engine_demotion")]

    def launches_now():
        return {k.__name__: k.launches for k in kernels.KERNELS}

    plan = describe_plan(bs, plan_factors)
    log(f"[chain] {plan}")
    if plan.count("sorted_onehot/fused_t") != bs.nmodes:
        raise AssertionError(f"unfaulted plan is not fused_t: {plan}")
    priv_plan = describe_plan(priv, plan_factors)
    log(f"[chain] mode 0 privatized: {priv_plan}")
    if "mode0=privatized/fused_t" not in priv_plan:
        raise AssertionError(f"mode 0 not privatized: {priv_plan}")
    # each mode's MTTKRP on fused_mttkrp_t, the reference of every engine
    reset()
    ref = [mttkrp(bs, plan_factors, m) for m in range(bs.nmodes)]
    base = None
    runs = []
    for label, schedule, experimental, privatize, demoted, want in \
            CHAIN_SCHEDULES:
        X = priv if privatize else bs
        try:
            out, seconds = run(X, schedule, experimental, True)
            launches = launches_now()
            got_demoted = demoted_now()
            # the engines the run was left with, on the reference factors
            mttkrp_err = 0.0
            for m in range(bs.nmodes):
                got = mttkrp(X, plan_factors, m)
                mttkrp_err = max(mttkrp_err, float(
                    (got - ref[m]).abs().max() / ref[m].abs().max()))
            plan_after = describe_plan(X, plan_factors)
        finally:
            os.environ.pop("SPLATT_EXPERIMENTAL_FUSED", None)
        if base is None:
            base = out
        fit_diff = max(abs(a - b) for a, b in zip(out.fits, base.fits))
        lam_diff = float((out.lam - base.lam).abs().max()
                         / base.lam.abs().max())
        row = dict(schedule=label, faults=schedule, demoted=got_demoted,
                   launches=launches, fits=list(out.fits),
                   max_fit_diff=fit_diff, lambda_rel_diff=lam_diff,
                   mttkrp_rel_err=mttkrp_err, seconds=seconds,
                   plan_after=plan_after)
        log(f"[chain] {json.dumps(row)}")
        if got_demoted != demoted:
            raise AssertionError(f"{label}: demoted {got_demoted}, "
                                 f"expected {demoted}")
        expect = {k.__name__: want.get(k.__name__, 0)
                  for k in kernels.KERNELS}
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{expect}")
        if len(out.fits) != CHAIN_ITERS or not fit_diff <= PARITY_TOL:
            raise AssertionError(f"{label}: fits {out.fits} against "
                                 f"{base.fits}")
        if not lam_diff <= LAMBDA_TOL:
            raise AssertionError(f"{label}: λ differs from the unfaulted "
                                 f"run's by {lam_diff:.3e} (relative)")
        if not mttkrp_err <= KERNEL_TOL:
            raise AssertionError(f"{label}: MTTKRP differs from "
                                 f"fused_mttkrp_t's by {mttkrp_err:.3e}")
        runs.append(row)
    for label, schedule, experimental, fallback, demoted, site in \
            RAISING_SCHEDULES:
        try:
            run(bs, schedule, experimental, fallback)
        except RuntimeError as e:
            err = e
        else:
            raise AssertionError(f"{label}: cpd_als did not raise")
        finally:
            os.environ.pop("SPLATT_EXPERIMENTAL_FUSED", None)
        row = dict(schedule=label, faults=schedule, fallback=fallback,
                   demoted=demoted_now(), launches=launches_now(),
                   raised=repr(err))
        log(f"[chain] {json.dumps(row)}")
        if site not in str(err):
            raise AssertionError(f"{label}: raised {err!r}, not the fault "
                                 f"at {site}")
        if row["demoted"] != demoted:
            raise AssertionError(f"{label}: demoted {row['demoted']}, "
                                 f"expected {demoted}")
        if any(row["launches"].values()):
            raise AssertionError(f"{label}: launches {row['launches']}")
        runs.append(row)
    reset()
    return {r["schedule"]: r for r in runs}


def phase_rank512(bs) -> dict:
    """cpd_als at rank 512 on the phase-3 layouts: fused_tg on every
    mode, no fault, no demotion."""
    import torch

    from splatt_tpu_torch import Options, cpd_als, resilience
    from splatt_tpu_torch.config import Verbosity
    from splatt_tpu_torch.ops import kernels
    from splatt_tpu_torch.ops.mttkrp import describe_plan

    rng = np.random.default_rng(12)
    init = [rng.random((d, BIG_RANK)) for d in bs.dims]
    plan = describe_plan(bs, [torch.as_tensor(U, dtype=torch.float32,
                                              device=bs.device)
                              for U in init])
    log(f"[rank{BIG_RANK}] {plan}")
    if plan.count("sorted_onehot/fused_tg") != bs.nmodes:
        raise AssertionError(f"rank {BIG_RANK} plan is not fused_tg: {plan}")
    resilience.reset_demotions()
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opts = Options(max_iterations=CHAIN_ITERS, tolerance=0.0,
                   verbosity=Verbosity.NONE, engine_fallback=False)
    out = cpd_als(bs, BIG_RANK, opts, init=init)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = kernels.fused_mttkrp_tg.launches
    steady = sum(out.iter_seconds[1:]) / (len(out.iter_seconds) - 1)
    log(f"[rank{BIG_RANK}] fits {list(out.fits)}; iteration seconds "
        f"{list(out.iter_seconds)}; {steady:.5f} s/iteration (iterations "
        f"2..{CHAIN_ITERS}); peak device memory {peak / 2**30:.2f} GiB; "
        f"fused_mttkrp_tg launches {launches}")
    if resilience.demotions():
        raise AssertionError(f"demotions at rank {BIG_RANK}")
    if launches != bs.nmodes * CHAIN_ITERS:
        raise AssertionError(f"fused_mttkrp_tg launched {launches} times")
    if not (math.isfinite(out.fit) and 0.0 < out.fit <= 1.0):
        raise AssertionError(f"fit {out.fit} is not finite in (0, 1]")
    # the kernel alone at this width, per mode, on the final factors,
    # beside its bound and the bytes its rank tiles stream
    kernel = []
    tiles = -(-BIG_RANK // kernels.RANK_TILE)
    for m in range(bs.nmodes):
        lay = bs.layout_for(m)

        def launch():
            return kernels.fused_mttkrp_tg(lay, out.factors, m,
                                           lay.seg_width, False)

        got = launch()
        row = dict(mode=m, ms=time_ms(launch, reps=5))
        row["bound_ms"], row["bound_by"] = bound(lay, out.factors, m, got)
        row["tiled_bytes_ms"] = least_ms(
            nbytes(lay.inds, lay.vals, lay.row_start) * tiles + nbytes(got)
            + nbytes(*(U for k, U in enumerate(out.factors) if k != m)),
            0)[0]
        kernel.append(row)
        del got
    log(f"[rank{BIG_RANK}] fused_mttkrp_tg per sorted launch by mode "
        f"{json.dumps(kernel)}")
    parts = sweep_phases(bs, out.factors, steady, f"[rank{BIG_RANK}]")
    return {"launches": launches, "sec_per_iter": steady,
            "peak_gib": peak / 2**30, "fits": list(out.fits),
            "kernel": kernel, "phases": parts}


def _record_row(name: str, source: str, replaces: str, launches: int,
                rows: list, library, **extra) -> dict:
    """One kernel's entry of the kernels line: ms, plain, bound and
    library means over `rows` (the contract the main path runs)."""

    def mean(key):
        return sum(r[key] for r in rows) / len(rows)

    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                max_rel_err=max(r["max_rel_err"] for r in rows),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"), bound_by=rows[0]["bound_by"],
                library_ms=None if library is None else mean(library),
                **extra)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from splatt_tpu_torch import BlockedSparse, Options
    from splatt_tpu_torch.config import BlockAlloc

    dev = phase_device()
    phase_build()

    t0 = time.perf_counter()
    tt = synthetic_tensor(NELL2, NNZ, seed=0)
    log(f"[data] NELL-2-shaped {NELL2} nnz={tt.nnz}: generated in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bs = BlockedSparse.from_coo(tt, Options(block_alloc=BlockAlloc.ALLMODE))
    torch.cuda.synchronize()
    log(f"[layout] host sort + block of {bs.nmodes} layouts and transfer: "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"[layout] " + " ".join(
        f"mode{lay.mode}: nblocks={lay.nblocks} seg_width={lay.seg_width}"
        for lay in bs.layouts))
    del tt

    rows = phase_kernels(bs, RANK)
    phase_parity()
    main_path = phase_main_path(bs, RANK)
    new_rows = phase_new_kernels(bs, RANK)
    big_rows = phase_big_rank()
    chain = phase_chain(bs, RANK)
    big = phase_rank512(bs)

    def main_rows(rs):
        """The rows of the contract the main path runs: sorted."""
        return [r for r in rs if r["contract"] == "sorted"]

    def launches(label, kernel):
        return chain[label]["launches"][kernel]

    fused_src = "splatt_tpu_torch/csrc/fused_mttkrp.cu"
    reduce_src = "splatt_tpu_torch/csrc/onehot_reduce.cu"
    pk = "splatt_tpu/ops/pallas_kernels.py"
    note = ("ms/plain_ms/bound_ms: mean per launch over the 3 modes at rank "
            f"{RANK}, 20M nonzeros; launches: the phase that runs it on a "
            "full CPD; every case is in 'contracts'")
    record = {"kernels": [
        _record_row("fused_mttkrp_t", fused_src, f"{pk}:355",
                    main_path["launches"], main_rows(rows), None,
                    note=note + " (phase 5, the main path)", contracts=rows,
                    cpd_sec_per_iter=main_path["sec_per_iter"],
                    sweep_phase_ms=main_path["phases"]),
        _record_row("fused_mttkrp_tg", fused_src, f"{pk}:507",
                    launches("fused_t faulted", "fused_mttkrp_tg"),
                    main_rows(new_rows["fused_mttkrp_tg"]), None,
                    note=note + " (phase 7, fused_t faulted); rank512: "
                    "phase 8's CPD, where it is the head of the chain",
                    contracts=new_rows["fused_mttkrp_tg"],
                    rank512=dict(launches=big["launches"],
                                 sorted_20m=big["kernel"],
                                 contracts_2m=big_rows,
                                 cpd_sec_per_iter=big["sec_per_iter"],
                                 peak_gib=big["peak_gib"],
                                 sweep_phase_ms=big["phases"])),
        _record_row("fused_mttkrp", fused_src, f"{pk}:1340",
                    launches("fused_t, fused_tg faulted, experimental fused",
                             "fused_mttkrp"),
                    main_rows(new_rows["fused_mttkrp"]), None,
                    note=note + " (phase 7, SPLATT_EXPERIMENTAL_FUSED=1)",
                    contracts=new_rows["fused_mttkrp"]),
        _record_row("onehot_reduce_sorted", reduce_src, f"{pk}:148",
                    launches("fused_t, fused_tg faulted",
                             "onehot_reduce_sorted"),
                    new_rows["onehot_reduce_sorted"], "library_ms",
                    note=note + " (phase 7); library: one index_add_",
                    contracts=new_rows["onehot_reduce_sorted"]),
        _record_row("onehot_reduce_full", reduce_src, f"{pk}:1415",
                    launches("fused_t, fused_tg faulted, mode 0 privatized",
                             "onehot_reduce_full"),
                    new_rows["onehot_reduce_full"], "library_ms",
                    note=note.replace("over the 3 modes", "over the 3 "
                                      "modes, accumulate contract")
                    + " (phase 7, mode 0 privatized); library: one "
                      "index_add_",
                    contracts=new_rows["onehot_reduce_full"]),
    ], "chain": chain, "power": dev["smi"]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
