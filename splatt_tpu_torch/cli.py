"""Command line of the PyTorch port (≙ src/cmds/: cmd_cpd.c, cmd_check.c,
cmd_convert.c, cmd_reorder.c, cmd_stats.c).

    python -m splatt_tpu_torch.cli cpd T.tns|T.bin -r R [-i ITERS]
        [--tol TOL] [--reg REG] [--seed SEED]
        [--alloc onemode|twomode|allmode] [--mode-order ORDER]
        [--block NNZ] [--f64] [--mmap] [-v] [--device cuda|cpu]
        [--engine-fallback on|off] [--json] [-o DIR | -s STEM]
        [--nowrite] [--decomp medium|coarse|fine] [--grid IxJxK]
        [--comm all2all|point2point|async_ring] [--rowdist greedy|balanced]
        [-p PARTITION] [--ndev N] [--local-engine blocked|stream]
        [--scratch-dir DIR] [--checkpoint FILE [--checkpoint-every N]]
        [--trace OUT_JSON] [--autotune on|off]
    python -m splatt_tpu_torch.cli tune T -r R [--reps N] [--force]
        [--alloc ...] [--f64] [-v] [--device cuda|cpu]
    python -m splatt_tpu_torch.cli bench T [-r R] [-a ALG]... [--reps N]
        [--seed S] [--alloc ...] [--mode-order ORDER] [--block NNZ] [--f64]
        [--permute TYPE] [--check] [-v] [--device cuda|cpu]
    python -m splatt_tpu_torch.cli trace FILE... [--out OUT_JSON]
        [--top N] [--json]
    python -m splatt_tpu_torch.cli check T [--fix OUT]
    python -m splatt_tpu_torch.cli convert T TYPE OUT [-m MODE]
    python -m splatt_tpu_torch.cli reorder T TYPE OUT [--seed S]
        [--write-perms]
    python -m splatt_tpu_torch.cli stats T [-p PARTITION]
    python -m splatt_tpu_torch.cli serve DIR [--once] [--workers N]
        [--queue-max N] [--poll S] [--job-deadline S] [--tenant-quota N]
        [--batch-min N] [--fleet [--replica ID] [--lease S]
        [--heartbeat S]] [--json] [-v] [--device cuda|cpu]
        [--trace OUT_JSON] | serve DIR --submit SPEC_JSON
        | serve DIR --status JOB_ID
    python -m splatt_tpu_torch.cli status DIR [--json] [--metrics-out PROM]
        [--watch] [--interval S]
    python -m splatt_tpu_torch.cli top DIR [--once] [--json]
        [--metrics-out PROM] [--interval S]
    python -m splatt_tpu_torch.cli predict DIR --model JOB_ID
        [--coords I,J,K]... [--top-k K --mode M --fix MODE=INDEX...]
        [--id ID] [--tenant T] [--wait S]
    python -m splatt_tpu_torch.cli chaos [--schedule SPEC] [--smoke]
        [-r RANK] [-i ITERS] [--deadline S] [--trace OUT_JSON]
        [--serve | --ingest | --fleet [--replicas N]] [--seed S] [--json]
        [-v] [--device cuda|cpu]
    python -m splatt_tpu_torch.cli ingest SOURCE DEST
        [--format auto|tns|csv|jsonl] [--chunk N] [--dims IxJxK]
        [--quarantine-max N] [--quarantine-rate X] [--json]

``cpd`` prints the MTTKRP engine plan, one fit line per iteration and the
resilience events of the run (engine demotions, transient retries, format,
packing and reorder fallbacks), and writes ``mode<N>.mat`` and
``lambda.mat`` by the JAX CLI's ``-s`` stem (a bare stem writes
``<stem>.mode<N>.mat``, a trailing ``/`` or an existing directory plain
names inside it; default ``./``; ``-o DIR`` is ``-s DIR/``), nothing
with ``--nowrite``.  ``--json`` adds one line ``{"fit": ..., "events": [...],
"demotions": [...]}``.  A tensor is read as text or ``.bin`` by its
magic; ``--mmap`` maps a ``.bin`` file instead of reading it.  The
layout format comes from the environment, as in the JAX CLI:
``SPLATT_IDX_WIDTH`` (i32|auto|u16|u8|delta|rle), ``SPLATT_VAL_STORAGE``
(auto|f32|bf16) and ``SPLATT_DECODE`` (kernel|prep); a non-default format
prints a ``format:`` line.  So does dense mode: ``SPLATT_DENSE``
(off|auto|on) with ``SPLATT_DENSE_THRESHOLD`` (default 0.05) gives each
mode whose padded fiber density meets the threshold a dense tile layout
and the ``dense/fused_dense`` plan.  ``SPLATT_FIBER_PACKING``
(fixed|balanced) picks the layouts' packing and ``SPLATT_REORDER``
(identity|random|graph|hgraph|fibsched) relabels the tensor before they
are built (``BlockedSparse.compile``); the factors are written in the
original row order.

``--decomp``, ``--grid``, ``--comm``, ``--rowdist`` or ``-p`` run the
distributed CPD over a mesh of ``--ndev`` ranks (default: every card, or 8
virtual ranks with ``--device cpu``) and print a ``DISTRIBUTED
decomp=...`` line, with the JAX CLI's implications: ``--grid IxJxK``
implies MEDIUM (the grid of its ranks, one factor per mode) and rejects
the other decompositions; ``--comm``, ``--rowdist`` and ``-p`` imply FINE.
``--local-engine`` picks the per-rank MTTKRP (default: the blocked engine,
except on the FINE ring patterns and for a memmapped tensor without a
scratch directory); the driver's ``local_engine`` event names it, and
whether its build ran out of core, as a ``per-rank engine:`` line under
``Resilience events:``.
``--scratch-dir DIR`` with ``--mmap`` builds out of core: the buckets and
the per-rank sorted layouts go to memmaps under DIR in chunked passes, so
the host holds a few chunks, not the tensor; it applies to distributed
runs only.  ``--json`` ring runs carry the ``ring_overlap`` event, and
every distributed run the ``layout_imbalance`` event.  ``convert T.tns
bin OUT`` streams the text to ``.bin`` (``wrote bin (streamed)``).

``--checkpoint FILE`` writes an atomic checksummed ``.npz`` every
``--checkpoint-every`` iterations (default 10; the previous generation
kept as ``FILE.bak``) and resumes from it when it exists, on one card or
distributed.  The guarded driver's events (``health_nonfinite``,
``health_rollback``, ``health_degraded``, ``checkpoint_recovery``) print
under ``Resilience events:`` and ride the ``--json`` line, which also
carries ``"degraded"``; ``SPLATT_HEALTH_RETRIES`` sets the rollback
budget and ``SPLATT_DEADLINE_S`` the watchdog of each engine's first
launch.  ``--trace OUT_JSON`` records the run's spans and exports a
Chrome trace-event file on exit, which the ``trace`` verb summarizes
(top spans by self time, the iterations, the guard share; several files
merge onto one timeline, ``--out`` writes the merge; a flight-recorder
``.jsonl`` ring, or a serve spool, whose ``fleet/flight/`` rings it reads,
is an input too).  ``-v`` prints the
timer report; ``-v -v`` runs the profiled sweep and adds its phase
timers and a per-mode MTTKRP block (distributed runs print the phase
table of their profiled sweep).

The autotuner (``tune.py``) is on by default, as in the JAX CLI
(``SPLATT_AUTOTUNE``, ``--autotune on|off``): ``cpd`` builds its layouts
at the plan cache's plans for its rank (``BlockedSparse.compile``), a
cached plan heads each mode's engine chain, and the plans in effect print
as a ``tuned plan:`` line and ride ``--json`` as a ``tuned_plan`` event.
``tune`` measures the candidate plans of every mode on ``--device`` and
persists the winners (``tuned N/M modes (... measurements, ... cache
hits, ... skipped) -> CACHE``); the cache is ``$SPLATT_TUNE_CACHE``, else
``splatt_tpu_torch/_build/tune_cache.json``.  ``bench`` times the MTTKRP
algorithms per mode (``stream``, ``blocked``, ``blocked_pallas`` on a card
only, ``scatter``, ``ttbox``; ``native`` prints ``--``) with the bytes
model's GB/s, and ``--check`` holds each against ``stream`` (1e-10 in
f64, 9e-3 in f32; exit 1 beyond it).

``serve DIR`` runs the multi-tenant daemon (``serve.py``) on ``--device``
over DIR's journal, spool and model store: ``--once`` drains the spool
and the queue and exits (1 when a job failed outright, or when the card's
context was lost), and the last line is ``{"jobs": {state: count},
"pending": N}`` (``--json``: the whole summary).  ``predict DIR --model
ID`` files a predict job and, with ``--wait S``, prints its result record
(``"status": "served"``, ``values``, ``top_k``, ``gen``, ``sha``) and
exits 0 when served.  ``serve --fleet`` runs the daemon as one replica of
a fleet over DIR (``--replica`` its id, ``--lease`` and ``--heartbeat``
its lease and renewal period): leases, heartbeats, adoption of a dead
peer's jobs and affinity routing; it stamps its spans with the replica
id, keeps a flight-recorder ring at ``DIR/fleet/flight/<replica>.jsonl``
(``SPLATT_FLIGHT=0`` turns it off) and a metrics snapshot at
``DIR/fleet/metrics/<replica>.prom``.  On a card a replica loads (or
builds) the kernels before it serves and exits non-zero when it cannot.
``status DIR`` and ``top DIR`` print the fleet dashboard from the spool
alone (replicas and their leases, queue depths, tenants, running and
recent jobs, adoptions, SLO verdicts; ``--metrics-out`` writes the merged
fleet exposition).  ``chaos`` runs the soaks of ``chaos.py`` and exits 0
when every invariant held: plain, a seeded CPD on ``--device`` under a
fault schedule (on the card ``chaos.CARD_SCHEDULE``); ``--serve``, a
``serve`` daemon SIGKILLed mid-job and restarted; ``--ingest``, an
``ingest`` run SIGKILLed mid-stream and resumed; ``--fleet``, replica
subprocesses under multi-tenant load, one SIGKILLed mid-job, its jobs
adopted.  ``--bench-gate`` waits for the port's benchmark and exits 2.
``ingest`` streams a record file into DEST under the exactly-once chunk
journal (``ingest.py``); a re-run resumes from the watermark.  An
``ingest`` job on ``serve`` does the same and chains update jobs.

``check``, ``convert``, ``reorder`` and ``stats`` run on the host and
write the JAX CLI's files and text: duplicates and empty slices (``--fix``
writes the deduplicated tensor with empty slices removed); the graph,
``fibmat``, hypergraph, ``bin`` and ``coord`` conversions; a relabeled
tensor (``--write-perms`` adds ``OUT.perm<m>``); the tensor, slice-skew
and density statistics.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from splatt_tpu_torch.config import BlockAlloc


def _build_opts(args):
    """The run's Options from a verb's flags; a flag the verb lacks keeps
    the default (≙ splatt_tpu.cli._build_opts)."""
    from splatt_tpu_torch.config import ModeOrder, Options, Verbosity

    opts = Options(verbosity=Verbosity(min(1 + getattr(args, "verbose", 0),
                                           3)))
    if getattr(args, "iters", None) is not None:
        opts.max_iterations = args.iters
    if getattr(args, "tol", None) is not None:
        opts.tolerance = args.tol
    if getattr(args, "seed", None) is not None:
        opts.random_seed = args.seed
    if getattr(args, "alloc", None):
        opts.block_alloc = BlockAlloc(args.alloc)
    if getattr(args, "reg", None) is not None:
        opts.regularization = args.reg
    if getattr(args, "block", None):
        opts.nnz_block = args.block
    if getattr(args, "f64", False):
        opts.val_dtype = torch.float64
    if getattr(args, "mode_order", None):
        opts.mode_order = ModeOrder(args.mode_order)
    if getattr(args, "engine_fallback", None):
        opts.engine_fallback = args.engine_fallback == "on"
    if getattr(args, "autotune", None):
        opts.autotune = args.autotune == "on"
    return opts


def _write_factors(out, args) -> None:
    """The ``-s`` stem (≙ cmd_cpd.c:209-230): a bare stem writes
    ``<stem>.mode<N>.mat``, a trailing separator, "." or an existing
    directory plain names inside it (``-o DIR`` is ``-s DIR/``)."""
    stem = args.stem
    if stem.endswith(os.sep) or stem in (".", "./") or os.path.isdir(stem):
        out.save(stem.rstrip(os.sep) or ".", stem="")
    else:
        d, base = os.path.split(stem)
        out.save(d or ".", stem=base + ".")


def cmd_cpd(args) -> int:
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import Verbosity
    from splatt_tpu_torch.cpd import cpd_als
    from splatt_tpu_torch.io import load, load_memmap
    from splatt_tpu_torch.utils.timers import timers

    opts = _build_opts(args)
    timers.start("total")
    t0 = time.perf_counter()
    with timers.time("io"):
        tt = load_memmap(args.tensor) if args.mmap else load(args.tensor)
    print(f"Tensor {args.tensor}: dims={'x'.join(map(str, tt.dims))} "
          f"nnz={tt.nnz} ({time.perf_counter() - t0:.3f}s)")
    bs = None
    if (args.decomp is not None or args.grid is not None
            or args.partition is not None or args.comm is not None
            or args.rowdist is not None):
        out = _distributed(args, opts, tt)
    else:
        if args.scratch_dir:
            # never silently ignore an explicit out-of-core request
            raise ValueError(
                "--scratch-dir applies to distributed runs (--decomp/"
                "--grid/...); the single-card blocked build "
                "materializes its layouts in RAM")
        t0 = time.perf_counter()
        with timers.time("blocked_build"):
            # with autotune on, the layouts are built at the plan cache's
            # plans for this rank
            bs = BlockedSparse.compile(tt, opts, device=args.device,
                                       rank=args.rank)
        print(f"Layouts: {len(bs.layouts)} on {bs.device} "
              f"({time.perf_counter() - t0:.3f}s)"
              + ("" if bs.reorder == "identity"
                 else f" reorder={bs.reorder}"))
        out = cpd_als(bs, rank=args.rank, opts=opts, device=args.device,
                      checkpoint_path=args.checkpoint,
                      checkpoint_every=args.checkpoint_every)
    print(f"Final fit: {out.fit:0.5f}")
    report = resilience.run_report()
    _print_report()
    if bs is not None and opts.verbosity >= Verbosity.HIGH:
        # the profiled sweep ran: true in-loop totals per mode
        # (≙ the per-mode times of `cpd -v -v`, src/cpd.c:361-366)
        print("Per-mode MTTKRP time (in-loop totals):")
        for m in range(bs.nmodes):
            print(f"  mode {m}: {timers[f'mttkrp_mode{m}']:0.3f}s")
    if not args.nowrite:
        _write_factors(out, args)
    timers.stop("total")
    if opts.verbosity >= Verbosity.LOW:
        print(timers.report(level=2 if opts.verbosity >= Verbosity.HIGH
                            else 1))
    if args.json:
        # the last line of stdout
        print(json.dumps(_resilience_record(report, fit=float(out.fit))))
    return 0


def _distributed(args, opts, tt):
    """The distributed CPD of the cpd verb (≙ splatt_tpu.cli.cmd_cpd's
    distributed branch)."""
    from splatt_tpu_torch.config import CommPattern, Decomposition
    from splatt_tpu_torch.io import read_permutation
    from splatt_tpu_torch.parallel import distributed_cpd_als, make_mesh

    if args.comm:
        opts.comm_pattern = CommPattern(args.comm)
    if args.decomp:
        opts.decomposition = Decomposition(args.decomp)
    elif args.grid:
        opts.decomposition = Decomposition.MEDIUM
    else:
        # comm patterns, partitions and row distribution are
        # fine-decomposition concepts
        opts.decomposition = Decomposition.FINE
    if args.partition and opts.decomposition is not Decomposition.FINE:
        raise ValueError(
            "-p/--partition is a FINE-decomposition input; combine it "
            f"with --decomp fine, not {opts.decomposition.value}")
    if (args.comm in ("point2point", "async_ring")
            and opts.decomposition is not Decomposition.FINE):
        raise ValueError(f"--comm {args.comm} (ring) applies to the fine "
                         f"decomposition only")
    if args.grid and opts.decomposition is not Decomposition.MEDIUM:
        raise ValueError("--grid applies to the medium decomposition only")
    grid = None
    if args.grid:
        try:
            grid = tuple(int(g) for g in args.grid.split("x"))
        except ValueError:
            grid = ()
        if len(grid) != tt.nmodes or any(g < 1 for g in grid):
            raise ValueError(
                f"--grid must give one positive factor per mode "
                f"({tt.nmodes} modes), got {args.grid!r}")
    partition = (read_permutation(args.partition) if args.partition
                 else None)
    ndev = args.ndev
    if grid is not None and ndev is None:
        ndev = int(np.prod(grid))
    mesh = make_mesh(n_devices=ndev, device=args.device)
    print(f"DISTRIBUTED decomp={opts.decomposition.value} "
          f"devices={mesh.ndev}"
          + (f" grid={args.grid}" if args.grid else "")
          + (" (virtual ranks)" if mesh.virtual else ""))
    # --json ring runs always carry the achieved-overlap metric
    return distributed_cpd_als(tt, rank=args.rank, opts=opts, grid=grid,
                               partition=partition,
                               row_distribute=args.rowdist, mesh=mesh,
                               local_engine=args.local_engine,
                               out_dir=args.scratch_dir,
                               measure_overlap=True if args.json else None,
                               checkpoint_path=args.checkpoint,
                               checkpoint_every=args.checkpoint_every)


def _print_report() -> None:
    from splatt_tpu_torch import resilience

    lines = resilience.run_report().summary()
    if lines:
        print("Resilience events:")
        for line in lines:
            print(line)


def cmd_tune(args) -> int:
    """Pre-tune a tensor (≙ splatt_tpu.cli.cmd_tune): measure each mode's
    candidate MTTKRP plans on ``--device`` and persist the winners, so
    later ``cpd`` runs in the same regime build and dispatch at them with
    no measurement.  Exits 1 when no mode got a plan."""
    from splatt_tpu_torch import tune
    from splatt_tpu_torch.io import load
    from splatt_tpu_torch.stats import tensor_stats

    opts = _build_opts(args)
    tt = load(args.tensor)
    print(tensor_stats(tt, args.tensor))
    res = tune.tune(tt, rank=args.rank, opts=opts, reps=args.reps,
                    force=args.force, device=args.device)
    for m in sorted(res.plans):
        p = res.plans[m]
        print(f"  mode {m}: path={p.path} engine={p.engine} "
              f"nnz_block={p.nnz_block} scan_target={p.scan_target} "
              f"({p.sec:.4f}s/call)")
    print(f"tuned {len(res.plans)}/{tt.nmodes} modes "
          f"({res.measured} measurements, {res.cache_hits} cache hits, "
          f"{res.skipped} skipped) -> {tune.cache_path()}")
    _print_report()
    return 0 if res.plans else 1


def cmd_bench(args) -> int:
    """≙ splatt_bench_cmd (src/cmds/cmd_bench.c:198-286) and
    splatt_tpu.cli.cmd_bench: seconds per MTTKRP of each algorithm and
    mode, the bytes model's GB/s, and with ``--check`` each algorithm
    against ``stream``."""
    from splatt_tpu_torch.bench_algs import (ALGS, bench_mttkrp,
                                             crosscheck_mttkrp, format_bench,
                                             roofline_report)
    from splatt_tpu_torch.config import resolve_dtype
    from splatt_tpu_torch.io import load
    from splatt_tpu_torch.reorder import reorder
    from splatt_tpu_torch.stats import tensor_stats

    opts = _build_opts(args)
    tt = load(args.tensor)
    print(tensor_stats(tt, args.tensor))
    if args.permute:
        tt = reorder(tt, args.permute, seed=opts.seed()).apply(tt)
        print(f"  (reordered: {args.permute})")
    algs = args.alg or list(ALGS)
    results, layouts = bench_mttkrp(tt, rank=args.rank, algs=algs,
                                    opts=opts, reps=args.reps,
                                    return_layouts=True, device=args.device)
    print(f"Benchmarking MTTKRP, rank {args.rank}, {args.reps} reps")
    print(format_bench(results))
    dtype = resolve_dtype(opts)
    print("Effective bandwidth (first-order bytes model):")
    for line in roofline_report(tt, results, args.rank,
                                torch.empty(0, dtype=dtype).element_size(),
                                layouts, device=args.device):
        print(line)
    if args.check:
        dev = crosscheck_mttkrp(tt, rank=args.rank, algs=algs, opts=opts,
                                device=args.device)
        print(f"cross-check max relative |alg - stream| = {dev:.3e}")
        tol = 1e-10 if dtype == torch.float64 else 9e-3
        if dev > tol:
            print(f"error: algorithms disagree beyond tolerance {tol}")
            return 1
    return 0


def _resilience_record(report, **extra) -> dict:
    """The machine-readable run summary of ``--json``: the final fit,
    every run-report event and every engine demotion
    (≙ splatt_tpu.cli._resilience_record)."""
    from splatt_tpu_torch import resilience

    return dict(
        extra,
        degraded=bool(report.events("health_degraded")),
        events=[{k: v for k, v in e.items() if k != "ts"}
                for e in report.events()],
        demotions=[dict(engine=d.engine,
                        failure_class=d.failure_class.value,
                        shape_key=d.shape_key, error=d.error[:120])
                   for d in resilience.demotions()])


def cmd_trace(args) -> int:
    """Summarize (and with several inputs merge) recorded Chrome traces
    (≙ splatt_tpu.cli.cmd_trace): top spans by self time, the
    per-iteration breakdown, the guard share and the point-event
    counts."""
    from splatt_tpu_torch import trace

    files = trace.expand_trace_paths(args.file)
    if not files:
        raise ValueError(f"no trace files under {args.file}")
    if len(files) == 1 and not files[0].endswith(".jsonl"):
        events = trace.load_trace(files[0])
    else:
        events = trace.merge_trace_files(files)
    if args.out:
        from splatt_tpu_torch.utils.durable import publish_json

        publish_json(args.out, {"traceEvents": events,
                                "displayTimeUnit": "ms"})
        # stderr: the --json stdout is machine-readable
        print(f"merged trace ({len(files)} source(s)) written to "
              f"{args.out}", file=sys.stderr)
    s = trace.summarize(events)
    if args.json:
        print(json.dumps({k: v for k, v in s.items() if k != "top"}))
        return 0
    for line in trace.format_summary(s, top_n=args.top):
        print(line)
    return 0


def cmd_serve(args) -> int:
    """``serve DIR``: the crash-resumable multi-tenant decomposition
    daemon over DIR's journal and spool, on ``--device``, alone or as one
    replica of a fleet (≙ splatt_tpu/cli.py:398-489).  ``--submit`` and
    ``--status`` are the client side of the filed-request API and need no
    device."""
    from splatt_tpu_torch import resilience, serve, trace

    if args.submit:
        with open(args.submit) as f:
            spec = json.load(f)
        jid = serve.file_request(args.dir, spec)
        print(json.dumps({"job": jid, "filed": True}))
        return 0
    if args.status:
        print(json.dumps(serve.read_status(args.dir, args.status)))
        return 0
    from splatt_tpu_torch.config import resolve_device

    if resolve_device(args.device).type == "cuda":
        _load_kernels()
    srv = serve.Server(args.dir, workers=args.workers,
                       queue_max=args.queue_max, poll_s=args.poll,
                       job_deadline_s=args.job_deadline,
                       verbose=args.verbose > 0,
                       fleet=args.fleet, replica=args.replica,
                       lease_s=args.lease, heartbeat_s=args.heartbeat,
                       tenant_quota=args.tenant_quota,
                       batch_min=args.batch_min, device=args.device)
    if args.fleet:
        _arm_fleet_observability(srv, args.dir)
    srv.install_signal_handlers()
    try:
        summary = srv.run_once() if args.once else srv.serve_forever()
        if args.once:
            # the daemon loop's exit snapshot, which --once skips; before
            # the retirement below, so the exit aggregation still sees
            # this replica's heartbeat
            srv.write_metrics_now()
    finally:
        if args.fleet:
            # retire the membership lease on the way out (peers route
            # around this replica at once); the ring keeps everything
            # recorded up to the exit
            srv.shutdown()
            trace.flight_flush()
    lines = resilience.run_report().summary()
    if lines and args.verbose > 0:
        print("Resilience events:")
        for line in lines:
            print(line)
    print(json.dumps(summary if args.json
                     else {"jobs": summary["counts"],
                           "pending": summary["pending"]}))
    if srv.context_lost is not None:
        print(f"splatt-serve: the card's context was lost "
              f"({srv.context_lost}); the interrupted jobs resume when the "
              f"daemon restarts", file=sys.stderr)
        return 1
    # --once is the batch entry: non-zero when an accepted job failed
    # outright (degraded but terminal is a success of the guarded
    # contract; interrupted jobs resume next start)
    if args.once and summary["counts"].get(serve.FAILED):
        return 1
    return 0


def _load_kernels() -> None:
    """Load (building only what ``_build/`` lacks) every kernel library
    before a daemon on the card takes a job, and say how long it took: a
    replica that cannot load its kernels exits here, before it claims a
    job it could run only on plain versions."""
    from splatt_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    built = kernels.build()
    kernels.load_library()
    print(f"splatt-serve: kernels loaded in {time.perf_counter() - t0:.2f} "
          f"s (nvcc {built['seconds']:.2f} s)", file=sys.stderr,
          flush=True)


def _arm_fleet_observability(srv, root: str) -> None:
    """A fleet replica's observability (≙ splatt_tpu/cli.py:425-456):
    every span and point stamped with the replica id, and the flight
    recorder armed (span recording on and a bounded ring in the spool) so
    that a SIGKILLed replica leaves a readable black box.  ``SPLATT_FLIGHT
    =0`` keeps the ring off; an explicit ``SPLATT_TRACE=0`` wins over its
    default, with a warning.  Done here, in the daemon's entry, so that a
    library construction never flips process-wide tracing state."""
    from splatt_tpu_torch import trace
    from splatt_tpu_torch.utils.env import read_env

    off = ("0", "off", "false", "no")
    trace.set_replica(srv.fleet.replica)
    flight = str(read_env("SPLATT_FLIGHT") or "auto").lower()
    trace_off = str(read_env("SPLATT_TRACE") or "").lower() in off
    if flight not in off and trace_off:
        print("splatt-serve: flight recorder off: SPLATT_TRACE is "
              "explicitly disabled (set SPLATT_FLIGHT=0 to silence this, "
              "or drop SPLATT_TRACE=0 to arm the black box)",
              file=sys.stderr)
    elif flight not in off:
        fdir = os.path.join(root, "fleet", "flight")
        os.makedirs(fdir, exist_ok=True)
        trace.set_enabled(True)
        trace.set_flight(os.path.join(fdir, f"{srv.fleet.replica}.jsonl"))


def cmd_status(args) -> int:
    """``status DIR`` / ``top DIR``: the fleet dashboard, read only from
    the shared spool (≙ splatt_tpu/cli.py:577-622): replicas with their
    leases, queue depths, tenants, running jobs with their age, recent
    terminal jobs, SLO verdicts.  ``--metrics-out`` writes the merged
    fleet exposition; ``--watch`` refreshes (``top`` watches by
    default)."""
    from splatt_tpu_torch import fleetobs
    from splatt_tpu_torch.utils.env import read_env_float

    interval = float(args.interval if args.interval is not None
                     else read_env_float("SPLATT_STATUS_WATCH_S"))

    def once(clear: bool = False) -> None:
        # one aggregation pass feeds the view and the exposition write
        agg = fleetobs.aggregate(args.dir)
        st = fleetobs.fleet_status(args.dir, agg=agg)
        out = []
        if args.metrics_out:
            path = fleetobs.write_fleet_metrics(agg, args.metrics_out)
            out.append(f"fleet metrics written to {path}")
        if args.json:
            out.append(json.dumps(st))
        else:
            out.extend(fleetobs.format_status(st))
        if clear:
            print("\x1b[2J\x1b[H", end="")
        print("\n".join(out), flush=True)

    if not args.watch or interval <= 0:
        # an interval of 0 runs once even for `top`
        once()
        return 0
    try:
        while True:
            once(clear=not args.json)
            time.sleep(max(interval, 0.1))
    except KeyboardInterrupt:
        return 0


#: what ``chaos --bench-gate`` answers: the gate drives a benchmark the
#: port does not have yet
BENCH_GATE_TODO = ("--bench-gate drives the benchmark of the port, which "
                   "the port's first benchmark PR adds (ROADMAP); no gate "
                   "ran")


def cmd_chaos(args) -> int:
    """The chaos soaks (≙ splatt_tpu/cli.py:263-343): plain (a seeded CPD
    on ``--device`` under a fault schedule), ``--serve``, ``--ingest`` and
    ``--fleet``.  Exit 0 when the soak's invariant held."""
    from splatt_tpu_torch import chaos

    if args.bench_gate:
        print(f"splatt-chaos: {BENCH_GATE_TODO}", file=sys.stderr)
        return 2
    if args.fleet:
        res = chaos.run_fleet_chaos(seed=args.seed, smoke=args.smoke,
                                    replicas=args.replicas,
                                    verbose=args.verbose > 0,
                                    device=args.device)
        lines = chaos.format_fleet_report(res)
    elif args.serve:
        res = chaos.run_serve_chaos(seed=args.seed, smoke=args.smoke,
                                    verbose=args.verbose > 0,
                                    device=args.device)
        lines = chaos.format_serve_report(res)
    elif args.ingest:
        # host code: the ingest soak takes no device
        res = chaos.run_ingest_chaos(seed=args.seed, smoke=args.smoke,
                                     verbose=args.verbose > 0)
        lines = chaos.format_ingest_report(res)
    else:
        # the schedule resolves in run_chaos (--schedule, else
        # $SPLATT_CHAOS_SCHEDULE, else the device's default)
        res = chaos.run_chaos(schedule=args.schedule, seed=args.seed,
                              rank=args.rank, iters=args.iters,
                              deadline_s=args.deadline, smoke=args.smoke,
                              verbose=args.verbose > 0,
                              trace_path=args.trace, device=args.device)
        lines = chaos.format_report(res)
    for line in lines:
        print(line)
    if args.json:
        print(json.dumps(res.to_json()))
    return 0 if res.ok else 1


def cmd_ingest(args) -> int:
    """``ingest``: stream a record file (.tns / CSV / JSONL) into a COO
    tensor under the exactly-once chunk journal (≙ splatt_tpu/cli.py:
    345-395).  Re-running the same SOURCE into the same DEST resumes from
    the journal watermark.  Exit 0 on a finalized run, 1 when the
    quarantine budget degraded it or nothing could be committed, 2 on a
    bad ``--dims``.  Host code: it takes no device."""
    from splatt_tpu_torch import ingest, resilience

    dims = None
    if args.dims:
        try:
            dims = tuple(int(d) for d in args.dims.lower().split("x"))
        except ValueError:
            print(f"splatt ingest: bad --dims {args.dims!r} (want IxJxK)",
                  flush=True)
            return 2
    try:
        summary = ingest.ingest_stream(
            args.source, args.dest, fmt=args.format,
            chunk_records=args.chunk, dims=dims,
            quarantine_max=args.quarantine_max,
            quarantine_rate=args.quarantine_rate)
    except (OSError, ValueError) as e:
        cls = resilience.classify_failure(e)
        print(f"splatt ingest: FAILED ({cls.value}): "
              f"{resilience.failure_message(e)[:200]}", flush=True)
        if args.json:
            print(json.dumps({"status": "failed",
                              "failure_class": cls.value,
                              "error": str(e)[:200]}))
        return 1
    verb = "resumed and " if summary["resumed"] else ""
    print(f"splatt ingest: {verb}{summary['status']} — "
          f"{summary['chunks']} chunk(s), {summary['nnz']} nnz from "
          f"{summary['records']} record(s) "
          f"({summary['quarantined']} quarantined) at "
          f"{summary['records_per_sec']} rec/s")
    if summary.get("tensor"):
        print(f"splatt ingest: tensor at {summary['tensor']} "
              f"(dims {'x'.join(str(d) for d in summary['dims'])})")
    lines = resilience.run_report().summary()
    if lines:
        print("Resilience events:")
        for line in lines:
            print(line)
    if args.json:
        print(json.dumps(summary))
    return 0 if summary["status"] == "converged" else 1


def cmd_predict(args) -> int:
    """``predict DIR``: file one generation-fenced predict against a
    committed model and, with ``--wait``, poll for the answer (≙
    splatt_tpu/cli.py:625-666).  Speaks only the filed-request API, so a
    daemon on any device answers it."""
    from splatt_tpu_torch import serve

    spec: dict = {"kind": "predict", "model": args.model}
    if args.id:
        spec["id"] = args.id
    if args.tenant:
        spec["tenant"] = args.tenant
    if args.coords:
        spec["coords"] = [[int(x) for x in c.split(",")]
                          for c in args.coords]
    if args.top_k:
        fixed = {}
        for kv in (args.fix or []):
            m, _, i = kv.partition("=")
            fixed[int(m)] = int(i)
        spec["top_k"] = {"mode": args.mode, "k": args.top_k,
                         "fixed": fixed}
    jid = serve.file_request(args.dir, spec)
    if not args.wait:
        print(json.dumps({"job": jid, "filed": True}))
        return 0
    end = time.time() + float(args.wait)
    while time.time() < end:
        st = serve.read_status(args.dir, jid)
        if st.get("state") in serve.TERMINAL:
            out = st.get("result") or {"job": jid,
                                       "state": st.get("state")}
            print(json.dumps(out))
            return 0 if out.get("status") == "served" else 1
        time.sleep(0.2)
    print(json.dumps({"job": jid, "state": "pending",
                      "error": "timed out waiting for the answer"}))
    return 1


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def cmd_check(args) -> int:
    """≙ splatt_check_cmd (src/cmds/cmd_check.c:63-116): count (and with
    ``--fix`` remove) duplicate nonzeros and empty slices; exits 1 when
    there are any, or indices outside the dims."""
    from splatt_tpu_torch.io import load, save

    tt = load(args.tensor)
    # out-of-range first: the histograms below assume in-range indices
    noob = sum(int(np.count_nonzero((tt.inds[m] < 0)
                                    | (tt.inds[m] >= tt.dims[m])))
               for m in range(tt.nmodes))
    if noob:
        print(f"out-of-range: {noob}")
        print("error: tensor declares indices outside its dimensions "
              "(corrupt file?)")
        return 1
    ndup = tt.count_duplicates()
    nempty = sum(tt.dims[m] - tt.nslices_nonempty(m)
                 for m in range(tt.nmodes))
    print(f"duplicates: {ndup}  empty slices: {nempty}  "
          f"out-of-range: 0")
    if args.fix:
        fixed = tt.deduplicate().remove_empty_slices()
        save(fixed, args.fix)
        print(f"wrote fixed tensor: {args.fix} "
              f"(nnz {tt.nnz} -> {fixed.nnz}, dims {tt.dims} -> "
              f"{fixed.dims})")
    return 0 if (ndup == 0 and nempty == 0) else 1


def cmd_convert(args) -> int:
    """≙ splatt_convert_cmd (src/cmds/cmd_convert.c).  A text tensor to
    ``bin`` streams through the native converter (bounded memory, for
    tensors larger than the host's); without its library, and for every
    other target, the tensor is loaded whole."""
    from splatt_tpu_torch.convert import convert
    from splatt_tpu_torch.io import load

    if args.type == "bin":
        with open(args.tensor, "rb") as f:
            is_binary = f.read(4) == b"SPTT"
        if not is_binary:
            from splatt_tpu_torch import native

            if native.stream_to_bin(args.tensor, args.output):
                print(f"wrote bin (streamed): {args.output}")
                return 0
    tt = load(args.tensor)
    convert(tt, args.type, args.output, mode=args.mode)
    print(f"wrote {args.type}: {args.output}")
    return 0


def cmd_reorder(args) -> int:
    """≙ splatt_reorder_cmd (src/cmds/cmd_reorder.c)."""
    from splatt_tpu_torch.io import load, save, write_permutation
    from splatt_tpu_torch.reorder import reorder

    tt = load(args.tensor)
    perm = reorder(tt, args.type, seed=args.seed or 0)
    save(perm.apply(tt), args.output)
    for m, p in enumerate(perm.perms):
        if p is not None and args.write_perms:
            write_permutation(p, f"{args.output}.perm{m}")
    print(f"wrote reordered tensor: {args.output}")
    return 0


def cmd_stats(args) -> int:
    """≙ splatt_stats_cmd (src/cmds/cmd_stats.c; ``-p`` adds the quality
    of a nonzero partition, src/stats.c:53-170)."""
    from splatt_tpu_torch.io import load, read_permutation
    from splatt_tpu_torch.stats import (density_stats_text,
                                        partition_quality_text,
                                        skew_stats_text, tensor_stats)

    tt = load(args.tensor)
    print(tensor_stats(tt, args.tensor))
    if args.partition:
        print(partition_quality_text(tt, read_permutation(args.partition)))
    for m in range(tt.nmodes):
        hist = tt.mode_histogram(m)
        nz = hist[hist > 0]
        print(f"  mode {m}: dim={tt.dims[m]} nonempty={nz.size} "
              f"nnz/slice min={nz.min() if nz.size else 0} "
              f"avg={tt.nnz / max(nz.size, 1):.1f} "
              f"max={nz.max() if nz.size else 0}")
    print(skew_stats_text(tt))
    print(density_stats_text(tt))
    return 0


def build_parser() -> argparse.ArgumentParser:
    from splatt_tpu_torch.version import __version__

    p = argparse.ArgumentParser(prog="splatt_tpu_torch",
                                description="CPD-ALS on an NVIDIA GPU")
    p.add_argument("-V", "--version", action="version",
                   version=f"splatt_tpu_torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cpd", help="CPD-ALS factorization")
    c.add_argument("tensor", help="coordinate tensor file (.tns/.bin)")
    c.add_argument("-v", "--verbose", action="count", default=0,
                   help="increase verbosity (repeatable)")
    c.add_argument("-r", "--rank", type=int, default=10)
    c.add_argument("-i", "--iters", type=int, default=50)
    c.add_argument("-t", "--tol", type=float, default=1e-5)
    c.add_argument("--reg", type=float, default=None,
                   help="Tikhonov regularization of the solve")
    c.add_argument("--seed", type=int, default=None)
    c.add_argument("--alloc", choices=[a.value for a in BlockAlloc],
                   default="twomode")
    c.add_argument("--mode-order", dest="mode_order",
                   choices=["smallfirst", "bigfirst", "inorder_minusone",
                            "sorted_minusone"],
                   help="secondary mode ordering within a layout "
                        "(the reference's csf_find_mode_order policies)")
    c.add_argument("--block", type=int, help="nnz per block")
    c.add_argument("--f64", action="store_true", help="double precision")
    c.add_argument("--mmap", action="store_true",
                   help="memory-map a .bin tensor instead of reading it "
                        "(no host copy of the tensor at load; pair with a "
                        "distributed --decomp and --scratch-dir for a "
                        "build that is out of core throughout; the "
                        "single-card blocked build still holds its "
                        "layouts in RAM)")
    c.add_argument("--nowrite", action="store_true",
                   help="skip writing factor files")
    c.add_argument("-s", "--stem", default="./", metavar="PATH",
                   help="file stem of the factor files (default ./): "
                        "<stem>.mode1.mat etc.; a trailing / (or an "
                        "existing directory) writes plain mode1.mat "
                        "inside it")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.add_argument("--engine-fallback", choices=["on", "off"],
                   dest="engine_fallback",
                   help="runtime engine fallback (default on, or "
                        "SPLATT_ENGINE_FALLBACK): a failing MTTKRP engine "
                        "is demoted and the next engine in the chain "
                        "runs; 'off' fails loudly")
    c.add_argument("--json", action="store_true",
                   help="print one JSON line with the fit, the resilience "
                        "events and the engine demotions")
    c.add_argument("-o", "--outdir", dest="stem", metavar="DIR",
                   type=lambda d: os.path.join(d, ""),
                   help="write plain mode<N>.mat and lambda.mat into DIR "
                        "(the same as -s DIR/)")
    c.add_argument("--decomp", choices=["medium", "coarse", "fine"],
                   help="run distributed over a mesh with this "
                        "decomposition")
    c.add_argument("--grid", metavar="IxJxK",
                   help="rank grid for the medium decomposition (implies "
                        "--decomp medium; default: sized from the ranks)")
    c.add_argument("-p", "--partition", metavar="FILE",
                   help="per-nonzero partition file (fine decomposition)")
    c.add_argument("--comm", choices=["all2all", "point2point",
                                      "async_ring"],
                   help="row-exchange pattern for --decomp fine (default: "
                        "$SPLATT_COMM, else all2all): point2point = the "
                        "sync ring, memory-lean; async_ring = the ring "
                        "kernels, one launch per ring phase")
    c.add_argument("--rowdist", choices=["greedy", "balanced"],
                   help="factor-row distribution: greedy = comm-"
                        "minimizing row claiming; balanced = nnz-"
                        "weighted fences")
    c.add_argument("--ndev", type=int, default=None,
                   help="ranks of the distributed mesh (default: every "
                        "card; 8 virtual ranks with --device cpu); ranks "
                        "share cards round-robin when there are fewer")
    c.add_argument("--local-engine", choices=["blocked", "stream"],
                   dest="local_engine",
                   help="per-rank MTTKRP engine of a distributed run "
                        "(default: blocked, each rank's sorted layouts "
                        "through the single-card engine chain; the fine "
                        "ring patterns, and a memmapped tensor without "
                        "--scratch-dir, take stream)")
    c.add_argument("--scratch-dir", dest="scratch_dir", metavar="DIR",
                   help="disk-backed scratch for a distributed run's "
                        "buckets and per-rank layouts: with --mmap the "
                        "whole build is out of core (host memory bounded "
                        "by the chunk, not the tensor); the files stay "
                        "after the run")
    c.add_argument("--checkpoint", metavar="FILE",
                   help="write an atomic checksummed .npz checkpoint (the "
                        "previous generation kept as FILE.bak) every "
                        "--checkpoint-every iterations and resume from it "
                        "when present (one card or distributed; a corrupt "
                        "file degrades to the .bak generation)")
    c.add_argument("--checkpoint-every", type=_positive_int, default=10,
                   metavar="N", help="iterations between checkpoints")
    c.add_argument("--trace", metavar="OUT_JSON",
                   help="record the run's spans and export a Chrome "
                        "trace-event JSON file on exit; summarize it with "
                        "the trace verb")
    c.add_argument("--autotune", choices=["on", "off"],
                   help="consult the autotuner's plan cache for the "
                        "layouts and the engine plan (default on, or "
                        "SPLATT_AUTOTUNE; pre-tune with the tune verb)")
    c.set_defaults(func=cmd_cpd)

    from splatt_tpu_torch.reorder import PERM_TYPES

    c = sub.add_parser("tune", help="pre-tune the MTTKRP plan of a tensor",
                       epilog="Times the candidate plans (reorder x "
                              "packing x nnz_block x format x engine) of "
                              "each mode with short warm and timed calls "
                              "and persists the winners in the plan cache "
                              "($SPLATT_TUNE_CACHE, else "
                              "splatt_tpu_torch/_build/tune_cache.json)")
    c.add_argument("tensor", help="coordinate tensor file (.tns/.bin)")
    c.add_argument("-v", "--verbose", action="count", default=0,
                   help="increase verbosity (repeatable)")
    c.add_argument("-r", "--rank", type=int, default=10)
    c.add_argument("--reps", type=int, default=2,
                   help="timed calls per candidate (the median wins)")
    c.add_argument("--force", action="store_true",
                   help="measure again even where the cache holds an "
                        "unexpired plan")
    c.add_argument("--alloc", choices=[a.value for a in BlockAlloc])
    c.add_argument("--f64", action="store_true", help="double precision")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.add_argument("--trace", metavar="OUT_JSON",
                   help="record the tune's spans and export a Chrome "
                        "trace-event JSON file on exit")
    c.set_defaults(func=cmd_tune)

    c = sub.add_parser("bench", help="benchmark the MTTKRP algorithms")
    c.add_argument("tensor", help="coordinate tensor file (.tns/.bin)")
    c.add_argument("-v", "--verbose", action="count", default=0,
                   help="increase verbosity (repeatable)")
    c.add_argument("-r", "--rank", type=int, default=16)
    c.add_argument("-a", "--alg", action="append",
                   help="algorithm (repeatable): stream/blocked/"
                        "blocked_pallas/scatter/ttbox/native")
    c.add_argument("--reps", type=int, default=3)
    c.add_argument("--seed", type=int)
    c.add_argument("--alloc", choices=[a.value for a in BlockAlloc])
    c.add_argument("--mode-order", dest="mode_order",
                   choices=["smallfirst", "bigfirst", "inorder_minusone",
                            "sorted_minusone"],
                   help="secondary mode ordering within a layout")
    c.add_argument("--block", type=int, help="nnz per block")
    c.add_argument("--f64", action="store_true", help="double precision")
    c.add_argument("--permute", choices=list(PERM_TYPES),
                   help="reorder the tensor first")
    c.add_argument("--check", action="store_true",
                   help="hold every algorithm against stream (1e-10 in "
                        "f64, 9e-3 in f32)")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.add_argument("--trace", metavar="OUT_JSON",
                   help="record the bench's spans and export a Chrome "
                        "trace-event JSON file on exit")
    c.set_defaults(func=cmd_bench)

    c = sub.add_parser("trace", help="summarize (and merge) recorded span "
                                     "traces")
    c.add_argument("file", nargs="+",
                   help="Chrome trace-event JSON file(s), flight-recorder "
                        ".jsonl rings, or a directory holding them (a "
                        "serve spool: its fleet/flight/ rings too)")
    c.add_argument("--out", metavar="OUT_JSON",
                   help="also write the merged Chrome trace-event file")
    c.add_argument("--top", type=int, default=12, metavar="N",
                   help="rows in the top-spans table (default 12)")
    c.add_argument("--json", action="store_true",
                   help="print the summary as JSON instead")
    c.set_defaults(func=cmd_trace)

    from splatt_tpu_torch.convert import CONVERT_TYPES

    c = sub.add_parser(
        "serve", help="run the multi-tenant decomposition daemon",
        epilog="A journal-backed job queue over DIR: clients drop job "
               "specs into DIR/requests/ (or --submit them), the daemon "
               "runs each job on --device under the guarded CPD with "
               "per-job isolation, and results appear in "
               "DIR/results/<id>.json.  A killed daemon replays its "
               "journal on restart and resumes every accepted job from "
               "its checkpoint; SIGTERM drains.  --fleet runs it as one "
               "replica of N over DIR: leases, heartbeats, adoption of a "
               "dead peer's jobs, cache-affinity routing.")
    c.add_argument("dir", help="serve state directory (journal, "
                               "requests/, results/, ckpt/)")
    c.add_argument("-v", "--verbose", action="count", default=0)
    c.add_argument("--workers", type=_positive_int,
                   help="concurrent job-supervisor threads (default: "
                        "$SPLATT_SERVE_WORKERS)")
    c.add_argument("--queue-max", type=int, dest="queue_max",
                   help="bounded pending-queue depth; submissions past it "
                        "are load-shed with a queue_full rejection "
                        "(default: $SPLATT_SERVE_QUEUE_MAX; <= 0 "
                        "unbounded)")
    c.add_argument("--poll", type=float,
                   help="seconds between request-spool scans (default: "
                        "$SPLATT_SERVE_POLL_S)")
    c.add_argument("--job-deadline", type=float, dest="job_deadline",
                   help="default per-job deadline in seconds; a blown "
                        "deadline fails the job TIMEOUT (default: "
                        "$SPLATT_SERVE_JOB_DEADLINE_S; <= 0 off)")
    c.add_argument("--once", action="store_true",
                   help="process the spool and the queue to completion, "
                        "then exit (non-zero when a job failed outright)")
    c.add_argument("--fleet", action="store_true",
                   help="fleet mode: run as one of N replicas over this "
                        "DIR (job leases, heartbeats, dead-peer adoption, "
                        "cache-affinity routing)")
    c.add_argument("--replica", metavar="ID",
                   help="fleet: this replica's stable id (default: "
                        "$SPLATT_FLEET_REPLICA, else a fresh pid+random "
                        "id)")
    c.add_argument("--lease", type=float, metavar="S",
                   help="fleet: lease in seconds, the failure-detection "
                        "horizon (default: $SPLATT_FLEET_LEASE_S)")
    c.add_argument("--heartbeat", type=float, metavar="S",
                   help="fleet: heartbeat and renewal period (default: "
                        "$SPLATT_FLEET_HEARTBEAT_S, else lease/3)")
    c.add_argument("--tenant-quota", type=int, dest="tenant_quota",
                   help="admission control: max non-terminal jobs per "
                        "tenant (default: $SPLATT_FLEET_TENANT_QUOTA; <= "
                        "0 off)")
    c.add_argument("--batch-min", type=int, dest="batch_min",
                   help="dispatch >= this many queued same-regime jobs as "
                        "one batched CPD (default: "
                        "$SPLATT_SERVE_BATCH_MIN; <= 0 off)")
    c.add_argument("--submit", metavar="SPEC_JSON",
                   help="client mode: file this job-spec JSON into "
                        "DIR/requests/ and exit")
    c.add_argument("--status", metavar="JOB_ID",
                   help="client mode: print the job's journal-derived "
                        "state (and result, when terminal) as JSON")
    c.add_argument("--json", action="store_true",
                   help="print the full per-job state map on exit")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.add_argument("--trace", metavar="OUT_JSON",
                   help="record the daemon's spans and export a Chrome "
                        "trace-event JSON file on exit")
    c.set_defaults(func=cmd_serve)

    for verb, watching in (("status", False), ("top", True)):
        c = sub.add_parser(
            verb,
            help=("watch-mode textual fleet dashboard" if watching
                  else "one-shot fleet status from the shared spool"),
            epilog="Reads only the shared serve spool (journal, fleet/ "
                   "heartbeats and leases, per-replica metrics "
                   "snapshots, persisted SLO verdicts): it works on a "
                   "live fleet, a draining one and a post-mortem alike.")
        c.add_argument("dir", help="the serve spool directory")
        c.add_argument("--json", action="store_true",
                       help="print the machine-readable status object")
        c.add_argument("--metrics-out", dest="metrics_out", metavar="PROM",
                       help="also write the merged fleet Prometheus "
                            "exposition to this file, atomically")
        if watching:
            c.add_argument("--once", dest="watch", action="store_false",
                           help="one-shot instead of watching")
        else:
            c.add_argument("--watch", action="store_true",
                           help="refresh continuously (the top default)")
        c.add_argument("--interval", type=float, metavar="S",
                       help="watch refresh seconds (default: "
                            "$SPLATT_STATUS_WATCH_S)")
        c.set_defaults(func=cmd_status, watch=watching)

    c = sub.add_parser(
        "chaos", help="chaos soaks: the guarded CPD, serve, ingest, fleet",
        epilog="Plain: a small seeded CPD on --device under a fault "
               "schedule (the SPLATT_FAULTS grammar plus iter=k / "
               "p=x:seed=N / after=t), checked to converge or degrade "
               "gracefully with nothing escaping and every fired fault "
               "leaving its run-report evidence; on the card the default "
               "schedule arms kernel engines and the comm drill must "
               "raise.  --serve SIGKILLs a serve daemon mid-job and "
               "restarts it; --ingest SIGKILLs an ingest run mid-stream "
               "and audits the resumed journal; --fleet starts N serve "
               "--fleet replicas over one spool, SIGKILLs the one running "
               "a pinned job and audits the failover.  Exit 0 iff every "
               "invariant held.  --bench-gate exits 2: the port's "
               "benchmark does not exist yet.")
    c.add_argument("-v", "--verbose", action="count", default=0)
    c.add_argument("--schedule", metavar="SPEC",
                   help="fault schedule (default: $SPLATT_CHAOS_SCHEDULE, "
                        "else the device's default recipe)")
    c.add_argument("--smoke", action="store_true",
                   help="the small, seconds-scale soak")
    c.add_argument("--bench-gate", action="store_true",
                   help="the bench regression gate: waits for the port's "
                        "benchmark (exits 2)")
    c.add_argument("--fleet", action="store_true",
                   help="soak a serve fleet")
    c.add_argument("--serve", action="store_true",
                   help="soak the serve daemon: SIGKILL it mid-job, "
                        "restart, no accepted job lost")
    c.add_argument("--ingest", action="store_true",
                   help="soak streaming ingest: SIGKILL it mid-stream, "
                        "resume, audit the chunk journal")
    c.add_argument("--replicas", type=int, default=None, metavar="N",
                   help="fleet soak: replica count (default 2 with "
                        "--smoke, else 3)")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("-r", "--rank", type=int, default=4)
    c.add_argument("-i", "--iters", type=int, default=8)
    c.add_argument("--deadline", type=float, default=0.5, metavar="S",
                   help="watchdog budget of the plain soak (seconds; the "
                        "slow fault kind blows it on purpose)")
    c.add_argument("--trace", metavar="OUT_JSON",
                   help="plain soak: record spans, export them to "
                        "OUT_JSON, and check that every fired fault's "
                        "evidence is a point event on the trace")
    c.add_argument("--json", action="store_true",
                   help="also print the full result as JSON")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the soak's CPDs and daemons run (the "
                        "ingest soak is host code)")
    c.set_defaults(func=cmd_chaos)

    c = sub.add_parser(
        "ingest", help="stream a raw record file into a COO tensor",
        epilog="Chunked, crash-resumable ingest: SOURCE is cut into chunks "
               "of --chunk records; each chunk parses (malformed records "
               "quarantined to DEST/quarantine.jsonl with classified "
               "events), vocab-maps string keys, publishes its segment "
               "atomically and journals last, so a SIGKILL at any point "
               "resumes from DEST/journal.jsonl with no record lost or "
               "duplicated.  A finalized run writes DEST/tensor.bin in the "
               "binary layout (cpd DEST/tensor.bin --mmap ...).")
    c.add_argument("source", help="record stream: .tns text, CSV, or JSONL "
                                  "arrays [i0, ..., val]")
    c.add_argument("dest", help="ingest state directory (journal, seg/, "
                                "vocab/, quarantine sidecar, tensor.bin)")
    c.add_argument("--format", choices=["auto", "tns", "csv", "jsonl"],
                   default="auto",
                   help="record format (default: by file extension)")
    c.add_argument("--chunk", type=_positive_int, metavar="N",
                   help="records per chunk commit (default: "
                        "$SPLATT_INGEST_CHUNK; a resume must match the "
                        "journal's value)")
    c.add_argument("--dims", metavar="IxJxK",
                   help="declared mode sizes: out-of-range indices "
                        "quarantine as bad_index instead of growing the "
                        "tensor")
    c.add_argument("--quarantine-max", type=int, dest="quarantine_max",
                   metavar="N",
                   help="bad-record budget (default: "
                        "$SPLATT_INGEST_QUARANTINE_MAX); past it the run "
                        "degrades classified")
    c.add_argument("--quarantine-rate", type=float, dest="quarantine_rate",
                   metavar="X",
                   help="largest quarantined/parsed ratio (default: "
                        "$SPLATT_INGEST_QUARANTINE_RATE)")
    c.add_argument("--json", action="store_true",
                   help="also print the run summary as JSON")
    c.add_argument("-v", "--verbose", action="count", default=0)
    c.set_defaults(func=cmd_ingest)

    c = sub.add_parser(
        "predict", help="query a served model: reconstruct entries / top-k",
        epilog="Files a generation-fenced predict job into DIR's serve "
               "spool: a daemon answers from an intact model generation "
               "or refuses.  --coords reconstructs entries; --top-k scans "
               "one mode with every other mode pinned by --fix.")
    c.add_argument("dir", help="the serve spool directory")
    c.add_argument("--model", required=True,
                   help="the committed model's job id")
    c.add_argument("--id", help="predict job id (default: generated)")
    c.add_argument("--tenant", help="tenant label for quota accounting")
    c.add_argument("--coords", action="append", metavar="I,J,K",
                   help="an index tuple to reconstruct (repeatable)")
    c.add_argument("--top-k", dest="top_k", type=int, metavar="K",
                   help="return the K best indices along --mode")
    c.add_argument("--mode", type=int, default=0,
                   help="the scanned mode for --top-k (default 0)")
    c.add_argument("--fix", action="append", metavar="MODE=INDEX",
                   help="pin a non-scanned mode for --top-k (repeatable)")
    c.add_argument("--wait", type=float, default=0.0, metavar="S",
                   help="poll up to S seconds for the answer (default: "
                        "file and exit; exit 0 on served)")
    c.set_defaults(func=cmd_predict)

    c = sub.add_parser("check", help="check for duplicates/empty slices")
    c.add_argument("tensor", help="coordinate tensor file (.tns/.bin)")
    c.add_argument("--fix", metavar="OUT",
                   help="write a fixed tensor to OUT")
    c.set_defaults(func=cmd_check)
    c = sub.add_parser("convert", help="convert to other formats")
    c.add_argument("tensor", help="coordinate tensor file (.tns/.bin)")
    c.add_argument("type", choices=list(CONVERT_TYPES))
    c.add_argument("output")
    c.add_argument("-m", "--mode", type=int, default=0)
    c.set_defaults(func=cmd_convert)
    c = sub.add_parser("reorder", help="relabel tensor indices")
    c.add_argument("tensor", help="coordinate tensor file (.tns/.bin)")
    c.add_argument("type", choices=list(PERM_TYPES))
    c.add_argument("output")
    c.add_argument("--seed", type=int)
    c.add_argument("--write-perms", action="store_true")
    c.set_defaults(func=cmd_reorder)
    c = sub.add_parser("stats", help="print tensor statistics")
    c.add_argument("tensor", help="coordinate tensor file (.tns/.bin)")
    c.add_argument("-p", "--partition", metavar="FILE",
                   help="also report quality of this nonzero partition")
    c.set_defaults(func=cmd_stats)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # --trace: record every span of this invocation and export on the way
    # out, on success or error (a failed run's partial trace is the one
    # worth having)
    trace_out = getattr(args, "trace", None)
    if trace_out:
        from splatt_tpu_torch import trace

        trace.set_enabled(True)
    try:
        return args.func(args)
    finally:
        if trace_out:
            ev = trace.write_chrome_trace(trace_out)
            trace.set_enabled(None)
            print("splatt-tpu: trace "
                  + (f"written to {trace_out} ({ev.get('spans')} spans, "
                     f"{ev.get('events')} point events); summarize with: "
                     f"python -m splatt_tpu_torch.cli trace {trace_out}"
                     if ev.get("ok") else
                     f"export to {trace_out} FAILED "
                     f"({ev.get('failure_class')}: {ev.get('error')})"),
                  file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
