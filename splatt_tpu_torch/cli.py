"""Command line of the PyTorch port (≙ src/cmds/cmd_cpd.c).

    python -m splatt_tpu_torch.cli cpd T.tns -r R [-i ITERS] [--tol TOL]
        [--seed SEED] [--alloc onemode|twomode|allmode] [--device cuda|cpu]
        [--engine-fallback on|off] [--json] [-o DIR]
        [--decomp medium|coarse|fine] [--grid IxJxK]
        [--comm all2all|point2point|async_ring] [--rowdist greedy|balanced]
        [-p PARTITION] [--ndev N] [--local-engine blocked|stream]

prints the MTTKRP engine plan, one fit line per iteration and the
resilience events of the run (engine demotions, transient retries, format
fallbacks), and writes ``mode<N>.mat`` and ``lambda.mat`` into DIR.
``--json`` adds one line ``{"fit": ..., "events": [...], "demotions":
[...]}``.  The layout format comes from the environment, as in the JAX
CLI: ``SPLATT_IDX_WIDTH`` (i32|auto|u16|u8|delta|rle),
``SPLATT_VAL_STORAGE`` (auto|f32|bf16) and ``SPLATT_DECODE``
(kernel|prep); a non-default format prints a ``format:`` line.  So does
dense mode: ``SPLATT_DENSE`` (off|auto|on) with ``SPLATT_DENSE_THRESHOLD``
(default 0.05) gives each mode whose padded fiber density meets the
threshold a dense tile layout and the ``dense/fused_dense`` plan.

``--decomp``, ``--grid``, ``--comm``, ``--rowdist`` or ``-p`` run the
distributed CPD over a mesh of ``--ndev`` ranks (default: every card, or 8
virtual ranks with ``--device cpu``) and print a ``DISTRIBUTED
decomp=...`` line, with the JAX CLI's implications: ``--grid IxJxK``
implies MEDIUM (the grid of its ranks, one factor per mode) and rejects
the other decompositions; ``--comm``, ``--rowdist`` and ``-p`` imply FINE.
``--local-engine`` picks the per-rank MTTKRP (default: the blocked engine,
except on the FINE ring patterns).  ``--json`` ring runs carry the
``ring_overlap`` event, and every distributed run the
``layout_imbalance`` event.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from splatt_tpu_torch.config import BlockAlloc


def cmd_cpd(args) -> int:
    from splatt_tpu_torch import resilience
    from splatt_tpu_torch.blocked import BlockedSparse
    from splatt_tpu_torch.config import Options
    from splatt_tpu_torch.cpd import cpd_als
    from splatt_tpu_torch.io import load

    opts = Options(max_iterations=args.iters, tolerance=args.tol,
                   random_seed=args.seed,
                   block_alloc=BlockAlloc(args.alloc))
    if args.engine_fallback:
        opts.engine_fallback = args.engine_fallback == "on"
    t0 = time.perf_counter()
    tt = load(args.tensor)
    print(f"Tensor {args.tensor}: dims={'x'.join(map(str, tt.dims))} "
          f"nnz={tt.nnz} ({time.perf_counter() - t0:.3f}s)")
    if (args.decomp is not None or args.grid is not None
            or args.partition is not None or args.comm is not None
            or args.rowdist is not None):
        out = _distributed(args, opts, tt)
    else:
        t0 = time.perf_counter()
        bs = BlockedSparse.from_coo(tt, opts, device=args.device)
        print(f"Layouts: {len(bs.layouts)} on {bs.device} "
              f"({time.perf_counter() - t0:.3f}s)")
        out = cpd_als(bs, rank=args.rank, opts=opts, device=args.device)
    print(f"Final fit: {out.fit:0.5f}")
    report = resilience.run_report()
    lines = report.summary()
    if lines:
        print("Resilience events:")
        for line in lines:
            print(line)
    if args.json:
        print(json.dumps(_resilience_record(report, fit=float(out.fit))))
    out.save(args.outdir)
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
                               measure_overlap=True if args.json else None)


def _resilience_record(report, **extra) -> dict:
    """The machine-readable run summary of ``--json``: the final fit,
    every run-report event and every engine demotion
    (≙ splatt_tpu.cli._resilience_record)."""
    from splatt_tpu_torch import resilience

    return dict(
        extra,
        events=[{k: v for k, v in e.items() if k != "ts"}
                for e in report.events()],
        demotions=[dict(engine=d.engine,
                        failure_class=d.failure_class.value,
                        shape_key=d.shape_key, error=d.error[:120])
                   for d in resilience.demotions()])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="splatt_tpu_torch",
                                description="CPD-ALS on an NVIDIA GPU")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cpd", help="CPD-ALS factorization")
    c.add_argument("tensor")
    c.add_argument("-r", "--rank", type=int, default=10)
    c.add_argument("-i", "--iters", type=int, default=50)
    c.add_argument("--tol", type=float, default=1e-5)
    c.add_argument("--seed", type=int, default=None)
    c.add_argument("--alloc", choices=[a.value for a in BlockAlloc],
                   default="twomode")
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
    c.add_argument("-o", "--outdir", default=".")
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
                        "ring patterns take stream)")
    c.set_defaults(func=cmd_cpd)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
