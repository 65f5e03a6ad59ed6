"""The port's MTTKRP benchmark (splatt_tpu_torch/bench_algs.py) and the
``tune``/``bench`` verbs against the JAX package's, on the CPU.

Same numpy inputs through both packages: the bytes, decode-bytes and
flop models give equal numbers on the same layouts, the roofline verdict
and report and the bench table equal the JAX package's for the same
times, and ``mttkrp_ttbox`` equals its counterpart (1e-10 in f64).
``crosscheck_mttkrp`` holds every algorithm that runs on a CPU (the host
engine included) within 1e-10 of ``stream`` in f64, and ``bench_mttkrp``
times them (the kernel chain reads nan here).  The CLI as subprocesses:
``tune`` twice (the second makes no measurement), ``cpd --autotune on``
(a ``tuned_plan`` event) and ``off`` (none), ``bench --check``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import bench_algs as jbench
from splatt_tpu import blocked as jb
from splatt_tpu.config import BlockAlloc as JAlloc
from splatt_tpu.config import Options as JOptions
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.ops.mttkrp import mttkrp_ttbox as jax_ttbox
from splatt_tpu_torch import bench_algs as bench
from splatt_tpu_torch import blocked as tb
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience, tune
from splatt_tpu_torch.config import BlockAlloc, Options
from splatt_tpu_torch.io import save
from tests import gen

RANK = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("SPLATT_TUNE_CACHE", str(tmp_path / "tune_cache.json"))
    tune.reset_memo()
    resilience.run_report().clear()
    yield
    tune.reset_memo()
    resilience.run_report().clear()


def _tensor(name):
    if name == "dense":
        rng = np.random.default_rng(9)
        dims = (16, 32, 120)
        flat = rng.choice(int(np.prod(dims)), 4000, replace=False)
        inds = np.stack(np.unravel_index(flat, dims))
        vals = np.round(rng.random(4000), 3) + 0.1
    elif name == "zipf":
        rng = np.random.default_rng(0)
        dims = (60, 44, 52)
        inds = np.stack([(rng.zipf(1.5, 4000) - 1) % d for d in dims])
        vals = np.round(rng.random(4000), 3) + 0.1
    else:
        tt = gen.fixture_tensor(name)
        vals, inds, dims = tt.vals, tt.inds, tt.dims
    return (JSparse(np.asarray(inds), np.asarray(vals), dims),
            tcoo.SparseTensor(np.asarray(inds), np.asarray(vals), dims))


LAYOUTS = {"v1": dict(idx_width="i32"),
           "v2": dict(idx_width="auto"),
           "bf16": dict(idx_width="delta", val_storage="bf16"),
           "balanced": dict(fiber_packing="balanced"),
           "dense": dict(dense="auto")}


def _built(name, case):
    J, X = _tensor(name)
    kw = dict(block_alloc="ALLMODE", nnz_block=512, **LAYOUTS[case])
    alloc = kw.pop("block_alloc")
    bs = tb.BlockedSparse.from_coo(
        X, Options(block_alloc=getattr(BlockAlloc, alloc),
                   val_dtype=torch.float64, **kw), device="cpu")
    jbs = jb.BlockedSparse.from_coo(
        J, JOptions(block_alloc=getattr(JAlloc, alloc), val_dtype=np.float64,
                    **kw))
    return J, X, bs, jbs


#: (tensor, layouts); the dense policy elects modes of "dense" alone
MODEL_CASES = [(n, c) for n in ("med", "zipf", "dense") for c in LAYOUTS
               if c != "dense" or n == "dense"]


@pytest.mark.parametrize("name,case", MODEL_CASES)
def test_the_traffic_and_flop_models_equal_the_references(name, case):
    J, X, bs, jbs = _built(name, case)
    if case == "dense":
        assert any(lay.encoding == "dense" for lay in bs.layouts)
    for m in range(X.nmodes):
        lay, jlay = bs.layout_for(m), jbs.layout_for(m)
        for alg in bench.ALGS:
            for itemsize in (2, 4, 8):
                if lay.encoding == "dense":
                    # the JAX model reads no dense layout (it has no
                    # blocks); the port's reads it as no layout
                    assert bench.mttkrp_bytes(alg, X, RANK, m, itemsize,
                                              lay) == \
                        jbench.mttkrp_bytes(alg, J, RANK, m, itemsize)
                else:
                    assert bench.mttkrp_bytes(alg, X, RANK, m, itemsize,
                                              lay) == \
                        jbench.mttkrp_bytes(alg, J, RANK, m, itemsize, jlay)
                assert bench.mttkrp_bytes_encoded(alg, bs, RANK, m,
                                                  itemsize) == \
                    jbench.mttkrp_bytes_encoded(alg, jbs, RANK, m, itemsize)
        for alg in ("stream", "scatter", "blocked", "blocked_pallas"):
            assert bench.mttkrp_flops(alg, bs, RANK, m) == \
                jbench.mttkrp_flops(alg, jbs, RANK, m)
        for engine in ("fused_v2", "fused_t", "fused_tg", "fused",
                       "unfused_pallas", "xla_scan", "xla", "native"):
            assert bench.mttkrp_decode_bytes(bs, RANK, m, engine) == \
                jbench.mttkrp_decode_bytes(jbs, RANK, m, engine)
        b = bench.mttkrp_bytes_encoded("blocked_pallas", bs, RANK, m, 8)
        f = bench.mttkrp_flops("blocked_pallas", bs, RANK, m)
        assert bench.roofline_verdict(b, f, device="cpu") == \
            jbench.roofline_verdict(b, f)
    with pytest.raises(ValueError, match="unknown algorithm"):
        bench.mttkrp_bytes("giga", X, RANK, 0, 8)


def test_the_report_and_table_equal_the_references():
    J, X, bs, jbs = _built("med", "v1")
    rng = np.random.default_rng(3)
    results = {alg: [float(t) for t in rng.random(X.nmodes) * 1e-3]
               for alg in bench.ALGS}
    results["native"] = [float("nan")] * X.nmodes
    results["blocked_pallas"][1] = float("nan")
    lays = [bs.layout_for(m) for m in range(X.nmodes)]
    jlays = [jbs.layout_for(m) for m in range(X.nmodes)]
    assert bench.roofline_report(X, results, RANK, 8, lays,
                                 device="cpu") == \
        jbench.roofline_report(J, results, RANK, 8, jlays)
    assert bench.format_bench(results) == jbench.format_bench(results)
    assert bench.hbm_peak_gbs("cpu") is None
    assert bench.compute_peak_gflops("cpu") is None


@pytest.mark.parametrize("name", ["med", "med4", "zipf"])
def test_ttbox_equals_the_references(name):
    J, X = _tensor(name)
    rng = np.random.default_rng(1)
    facs = [rng.random((d, RANK)) for d in X.dims]
    inds, vals = torch.from_numpy(X.inds), torch.from_numpy(X.vals)
    for m in range(X.nmodes):
        got = bench.mttkrp_ttbox(inds, vals,
                                 [torch.from_numpy(U) for U in facs], m,
                                 X.dims[m])
        want = jax_ttbox(jnp.asarray(J.inds), jnp.asarray(J.vals),
                         [jnp.asarray(U) for U in facs], m, J.dims[m])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("name,case", [
    (n, c) for n in ("med", "med4", "dense")
    for c in ("v1", "v2", "balanced", "dense") if c != "dense" or n == "dense"])
def test_crosscheck_holds_every_cpu_algorithm_to_stream(name, case):
    _, X = _tensor(name)
    opts = Options(block_alloc=BlockAlloc.TWOMODE, nnz_block=512,
                   val_dtype=torch.float64, random_seed=3, **LAYOUTS[case])
    assert bench.crosscheck_mttkrp(X, rank=RANK, opts=opts,
                                   device="cpu") <= 1e-10


def test_bench_times_what_runs_on_a_cpu():
    _, X = _tensor("med")
    opts = Options(block_alloc=BlockAlloc.TWOMODE, val_dtype=torch.float64)
    results, layouts = bench.bench_mttkrp(X, rank=RANK, opts=opts, reps=1,
                                          return_layouts=True, device="cpu")
    assert list(results) == list(bench.ALGS)
    for alg, times in results.items():
        # the kernel chain needs a card; the host engine runs here
        nan = alg == "blocked_pallas"
        assert all(np.isnan(t) == nan for t in times), alg
        assert all(np.isnan(t) or t > 0 for t in times)
    assert [lay.mode for lay in layouts] == [
        tb.BlockedSparse.from_coo(X, opts, device="cpu").layout_for(m).mode
        for m in range(X.nmodes)]
    only = bench.bench_mttkrp(X, rank=RANK, algs=("stream", "ttbox"),
                              opts=opts, reps=1, device="cpu")
    assert set(only) == {"stream", "ttbox"}


def test_the_alg_plans_follow_the_references():
    J, X, bs, jbs = _built("med", "v1")
    for alg in ("scatter", "blocked", "blocked_pallas"):
        for m in range(X.nmodes):
            got = bench._alg_plan(alg, bs.layout_for(m), m, X.dims[m],
                                  bs.opts)
            want = jbench._alg_plan(alg, jbs.layout_for(m), m, J.dims[m],
                                    jbs.opts)
            assert got[0] == want[0]
    with pytest.raises(ValueError):
        bench._alg_plan("giga", bs.layout_for(0), 0, X.dims[0], bs.opts)


# -- the verbs ----------------------------------------------------------------------

def _cli(args, env):
    r = subprocess.run([sys.executable, "-m", "splatt_tpu_torch.cli", *args],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    return r


def test_tune_then_cpd_then_bench_through_the_cli(tmp_path):
    _, X = _tensor("med")
    path = str(tmp_path / "med.tns")
    save(X, path)
    cache = tmp_path / "cli_cache.json"
    # the reorder and the value storage are one for the whole tensor, so
    # modes whose noisy CPU winners disagree on them would be dropped
    # (tuner_degraded): pin both, as a user tuning for one recipe does
    env = dict(os.environ, SPLATT_TUNE_CACHE=str(cache),
               SPLATT_REORDER="identity", SPLATT_VAL_STORAGE="auto",
               PYTHONPATH=REPO)
    env.pop("SPLATT_FAULTS", None)
    r = _cli(["tune", path, "-r", "4", "--device", "cpu"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "tuned 3/3 modes" in r.stdout and cache.exists()
    r = _cli(["tune", path, "-r", "4", "--device", "cpu"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "tuned 3/3 modes (0 measurements, 3 cache hits" in r.stdout
    for flag, want in (("on", True), ("off", False)):
        r = _cli(["cpd", path, "-r", "4", "-i", "3", "--device", "cpu",
                  "--autotune", flag, "--json", "--nowrite"], env)
        assert r.returncode == 0, r.stdout + r.stderr
        events = json.loads(r.stdout.strip().splitlines()[-1])["events"]
        kinds = [e["kind"] for e in events]
        assert ("tuned_plan" in kinds) == want, kinds
        assert ("tuned plan:" in r.stdout) == want
        assert "tuner_degraded" not in kinds
    r = _cli(["bench", path, "-r", "4", "--reps", "1", "--check",
              "--device", "cpu", "--f64"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "cross-check max relative |alg - stream|" in r.stdout
    assert "blocked_pallas" in r.stdout and "GB/s (model)" in r.stdout
    r = _cli(["bench", path, "-r", "4", "--reps", "1", "--check", "-a",
              "stream", "-a", "scatter", "--device", "cpu"], env)
    assert r.returncode == 0, r.stdout + r.stderr
