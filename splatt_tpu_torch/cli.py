"""Command line of the PyTorch port (≙ src/cmds/cmd_cpd.c).

    python -m splatt_tpu_torch.cli cpd T.tns -r R [-i ITERS] [--tol TOL]
        [--seed SEED] [--alloc onemode|twomode|allmode] [--device cuda|cpu]
        [--engine-fallback on|off] [--json] [-o DIR]

prints the MTTKRP engine plan, one fit line per iteration and the
resilience events of the run (engine demotions, transient retries), and
writes ``mode<N>.mat`` and ``lambda.mat`` into DIR.  ``--json`` adds one
line ``{"fit": ..., "events": [...], "demotions": [...]}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

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
    c.set_defaults(func=cmd_cpd)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
