"""The port's FINE distributed CPD against the JAX package's, on the CPU.

``splatt_tpu.parallel.sharded_cpd_als`` runs on the 8 virtual CPU devices
of ``tests/conftest.py`` (``make_mesh(n_devices=ndev)``), the port's on a
virtual CPU mesh of the same rank count, from one numpy init, f64, 3
iterations: fit within 1e-9, λ and factors within 1e-8 (the tolerances of
the port's single-device differential tests).  Then the comm ladder
against the JAX package's recorded events, the overlap metric, the
dispatch of ``distributed_cpd_als``, the CLI, and the single-device COO
CPD's one upload per run.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import resilience as jres
from splatt_tpu.config import CommPattern as JComm
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from splatt_tpu.parallel.sharded import measure_ring_overlap as jax_overlap
from splatt_tpu.parallel.sharded import shard_factors as jax_shard_factors
from splatt_tpu.parallel.sharded import shard_nnz as jax_shard_nnz
from splatt_tpu.parallel.sharded import sharded_cpd_als as jax_sharded
from splatt_tpu.parallel.sharded import sharded_mttkrp as jax_mttkrp
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience
from splatt_tpu_torch.cli import main as cli_main
from splatt_tpu_torch.config import (CommPattern, Decomposition, Options,
                                     Verbosity, resolve_comm_pattern)
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.parallel import distributed_cpd_als, sharded_mttkrp
from splatt_tpu_torch.parallel.mesh import make_mesh
from splatt_tpu_torch.parallel.sharded import (comm_chain,
                                               measure_ring_overlap,
                                               shard_factors, shard_nnz,
                                               sharded_cpd_als)
from splatt_tpu_torch.utils import faults
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

RANK = 5
ITERS = 3
COMMS = ["all2all", "point2point", "async_ring"]


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()


def _tensor(name="med"):
    tt = gen.fixture_tensor(name)
    return tt, tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


def _init(dims, rank=RANK, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.random((d, rank)) for d in dims]


def _jax(tt, ndev, comm, init, iters=ITERS, **kw):
    opts = JOptions(max_iterations=iters, tolerance=0.0,
                    val_dtype=np.float64, comm_pattern=JComm(comm),
                    verbosity=JVerbosity.NONE, random_seed=1,
                    **kw.pop("opts_kw", {}))
    kw.setdefault("local_engine", "stream")
    return jax_sharded(tt, init[0].shape[1], mesh=jax_make_mesh(n_devices=ndev),
                       opts=opts, init=[jnp.asarray(i) for i in init], **kw)


def _port(tt, ndev, comm, init, iters=ITERS, **kw):
    opts = Options(max_iterations=iters, tolerance=0.0,
                   val_dtype=torch.float64, comm_pattern=CommPattern(comm),
                   verbosity=Verbosity.NONE, random_seed=1,
                   **kw.pop("opts_kw", {}))
    return sharded_cpd_als(tt, init[0].shape[1],
                           mesh=make_mesh(n_devices=ndev, device="cpu"),
                           opts=opts, init=init, **kw)


def _assert_same(got, want, fit_tol=1e-9, tol=1e-8):
    assert float(got.fit) == pytest.approx(float(want.fit), abs=fit_tol)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                               atol=tol, rtol=0)
    assert len(got.factors) == len(want.factors)
    for g, w in zip(got.factors, want.factors):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("comm", COMMS)
def test_fine_cpd_matches_jax(comm, ndev):
    jt, tt = _tensor()
    init = _init(tt.dims)
    got = _port(tt, ndev, comm, init)
    assert len(got.fits) == ITERS
    _assert_same(got, _jax(jt, ndev, comm, init))


def _awkward(case):
    """dims not divisible by the rank count, or fewer nonzeros than
    ranks."""
    rng = np.random.default_rng(3)
    if case == "dims":
        dims, nnz, ndev = (13, 11, 17), 200, 3
    else:
        dims, nnz, ndev = (5, 4, 6), 3, 4
    inds = np.stack([rng.integers(0, d, size=nnz) for d in dims])
    for m, d in enumerate(dims):
        inds[m, :min(nnz, d)] = np.arange(min(nnz, d))
    vals = rng.random(nnz) + 0.5
    from splatt_tpu.coo import SparseTensor as JSparse

    return (JSparse(inds, vals, dims), tcoo.SparseTensor(inds, vals, dims),
            ndev)


@pytest.mark.parametrize("comm", ["all2all", "async_ring"])
@pytest.mark.parametrize("case", ["dims", "nnz_below_ranks"])
def test_fine_cpd_awkward_sizes_match_jax(case, comm):
    jt, tt, ndev = _awkward(case)
    init = _init(tt.dims, rank=3, seed=11)
    _assert_same(_port(tt, ndev, comm, init), _jax(jt, ndev, comm, init))


@pytest.mark.parametrize("comm", ["all2all", "async_ring"])
def test_fine_cpd_partition_matches_jax(comm):
    jt, tt = _tensor()
    init = _init(tt.dims)
    part = np.random.default_rng(5).integers(0, 4, size=tt.nnz)
    _assert_same(_port(tt, 4, comm, init, partition=part),
                 _jax(jt, 4, comm, init, partition=part))


@pytest.mark.parametrize("rowdist", [None, "greedy", "balanced"])
def test_fine_cpd_row_distribute_matches_jax(rowdist):
    jt, tt = _tensor("med4")
    init = _init(tt.dims)
    got = _port(tt, 4, "point2point", init, row_distribute=rowdist)
    _assert_same(got, _jax(jt, 4, "point2point", init,
                           row_distribute=rowdist))
    ev = resilience.run_report().events("layout_imbalance")
    assert [e["policy"] for e in ev] == [rowdist or "equal"]
    assert ("row_fence_max_mean" in ev[0]) == (rowdist is not None)


def test_rank_count_invariance_and_single_device_parity():
    """The same factors at 1, 2 and 4 ranks, and the same as the port's
    single-device COO cpd_als."""
    _, tt = _tensor()
    init = _init(tt.dims)
    runs = [_port(tt, n, "async_ring", init) for n in (1, 2, 4)]
    single = cpd_als(tt, RANK, Options(max_iterations=ITERS, tolerance=0.0,
                                       val_dtype=torch.float64,
                                       verbosity=Verbosity.NONE),
                     init=init, device="cpu")
    for other in runs[1:] + [single]:
        assert other.fit == pytest.approx(runs[0].fit, abs=1e-10)
        for a, b in zip(other.factors, runs[0].factors):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9)


@functools.lru_cache(maxsize=None)
def _jax_mttkrps(ndev):
    """The JAX package's sharded MTTKRP of every mode of the med tensor
    (compiled once per rank count, shared by the port's variants)."""
    jt, _ = _tensor()
    jmesh = jax_make_mesh(n_devices=ndev)
    ji, jv = jax_shard_nnz(jt, jmesh, val_dtype=np.float64)
    jf = jax_shard_factors([jnp.asarray(u) for u in _init(jt.dims)],
                           jt.dims, jmesh)
    return [np.asarray(jax_mttkrp(ji, jv, jf, m, jmesh))
            for m in range(jt.nmodes)]


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("variant", ["all2all", "ring", "async_ring"])
def test_sharded_mttkrp_matches_jax(variant, ndev):
    _, tt = _tensor()
    mesh = make_mesh(n_devices=ndev, device="cpu")
    inds, vals = shard_nnz(tt, mesh, dtype=torch.float64)
    facs = shard_factors(_init(tt.dims), tt.dims, mesh, dtype=torch.float64)
    for m, want in enumerate(_jax_mttkrps(ndev)):
        got = torch.cat(sharded_mttkrp(inds, vals, facs, m, mesh,
                                       variant=variant)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)


# -- the comm ladder on the CPU, against the JAX package's events ----------


def _ladder(pkg):
    """(comm_fallback (strategy, fallback_to, class) triples, demoted
    engines and their shape keys) of one package's run report."""
    evs = [(e["strategy"], e["fallback_to"], e["failure_class"])
           for e in pkg.run_report().events("comm_fallback")]
    dem = sorted((d.engine, d.shape_key) for d in pkg.demotions())
    return evs, dem


def _arm(mod, text):
    for site, spec in mod.parse_schedule(text).items():
        mod.arm(site, spec)


def test_comm_fallback_lands_on_sync_ring_as_jax():
    jt, tt = _tensor()
    init = _init(tt.dims)
    clean = _port(tt, 4, "point2point", init)
    resilience.run_report().clear()
    _arm(faults, "comm.ring_exchange:runtime:1")
    _arm(jfaults, "comm.ring_exchange:runtime:1")
    got = _port(tt, 4, "async_ring", init, iters=5)
    _jax(jt, 4, "async_ring", init, iters=5)
    assert _ladder(resilience) == _ladder(jres)
    assert _ladder(resilience)[0] == [("async_ring", "ring", "unknown")]
    assert got.fits[:ITERS] == clean.fits


def test_comm_oom_demotes_per_shape_and_never_all2all_as_jax():
    jt, tt = _tensor()
    init = _init(tt.dims)
    _arm(faults, "comm.ring_exchange:oom:2")
    _arm(jfaults, "comm.ring_exchange:oom:2")
    out = _port(tt, 8, "async_ring", init)
    _jax(jt, 8, "async_ring", init)
    assert np.isfinite(out.fit)
    assert _ladder(resilience) == _ladder(jres)
    evs, dem = _ladder(resilience)
    assert evs == [("async_ring", "ring", "resource"),
                   ("ring", "all2all", "resource")]
    assert {e for e, _ in dem} == {"comm.async_ring", "comm.ring"}
    assert all(k.endswith(":comm") for _, k in dem)
    assert not resilience.is_demoted("comm.all2all", None)
    assert not resilience.is_demoted("comm.async_ring",
                                     "d8x8x8:w8:r5:float64:comm")
    assert not resilience.is_demoted("fused_t")


def test_demoted_comm_strategy_is_skipped_next_run():
    _, tt = _tensor()
    init = _init(tt.dims)
    _arm(faults, "comm.ring_exchange:runtime:1")
    _port(tt, 4, "async_ring", init)
    assert len(resilience.run_report().events("comm_fallback")) == 1
    faults.reset()
    out = _port(tt, 4, "async_ring", init)
    assert len(resilience.run_report().events("comm_fallback")) == 1
    assert np.isfinite(out.fit)


def test_comm_fallback_off_raises():
    _, tt = _tensor()
    _arm(faults, "comm.ring_exchange:runtime:1")
    with pytest.raises(RuntimeError, match="injected"):
        _port(tt, 4, "async_ring", _init(tt.dims),
              opts_kw=dict(engine_fallback=False))
    assert not resilience.run_report().events("comm_fallback")


def test_comm_chains_and_resolution(monkeypatch):
    cpu = make_mesh(n_devices=2, device="cpu")
    assert comm_chain(CommPattern.ASYNC_RING, cpu) \
        == ("async_ring", "ring", "all2all")
    assert comm_chain(CommPattern.POINT2POINT, cpu) == ("ring", "all2all")
    assert comm_chain(CommPattern.ALL2ALL) == ("all2all",)
    monkeypatch.setenv("SPLATT_COMM", "async_ring")
    assert resolve_comm_pattern(Options()) is CommPattern.ASYNC_RING
    assert resolve_comm_pattern(Options(comm_pattern=CommPattern.ALL2ALL)) \
        is CommPattern.ALL2ALL
    monkeypatch.setenv("SPLATT_COMM", "bogus")
    with pytest.raises(ValueError, match="SPLATT_COMM"):
        resolve_comm_pattern(Options())
    monkeypatch.delenv("SPLATT_COMM")
    assert resolve_comm_pattern(Options()) is CommPattern.ALL2ALL
    with pytest.raises(TypeError):
        Options(comm_pattern="ring").validate()
    with pytest.raises(TypeError):
        Options(decomposition="fine").validate()
    assert "comm.ring_exchange" in faults.SITES


# -- the overlap metric ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_overlap_fields():
    jt, _ = _tensor()
    mesh = jax_make_mesh(n_devices=4)
    dims_pad = tuple(-(-d // 4) * 4 for d in jt.dims)
    ji, jv = jax_shard_nnz(jt, mesh, val_dtype=np.float64)
    jf = tuple(jax_shard_factors([jnp.asarray(u) for u in _init(jt.dims)],
                                 jt.dims, mesh))
    from splatt_tpu.ops.linalg import gram

    jg = tuple(gram(u) for u in jf)
    return jax_overlap(mesh, jt.nmodes, 0.0, dims_pad, "nnz", "async_ring",
                       ji, jv, jf, jg, jnp.float64, reps=1)


def test_measure_ring_overlap_fields_match_jax():
    _, tt = _tensor()
    mesh = make_mesh(n_devices=4, device="cpu")
    dims_pad = tuple(-(-d // 4) * 4 for d in tt.dims)
    inds, vals = shard_nnz(tt, mesh, dtype=torch.float64)
    facs = shard_factors(_init(tt.dims), tt.dims, mesh, dtype=torch.float64)
    from splatt_tpu_torch.parallel.common import allreduce
    from splatt_tpu_torch.ops.linalg import gram

    grams = [allreduce([gram(u) for u in f], mesh) for f in facs]
    ov = measure_ring_overlap(mesh, tt.nmodes, 0.0, dims_pad, "nnz",
                              "async_ring", inds, vals, facs, grams,
                              torch.float64, reps=1)
    want = _jax_overlap_fields()
    assert set(ov) == set(want)
    for k in ("variant", "model_mb_per_device", "per_hop_mb",
              "overlap_eligible_frac"):
        assert ov[k] == want[k], k
    assert ov["backend"] == "cpu" and ov["engine"] == "sync_ring"
    assert 0.0 <= ov["overlap_frac"] <= 1.0
    assert ov["exchange_s"] > 0 and ov["step_s"] > 0
    assert ov["exposed_comm_s"] >= 0 and ov["hidden_comm_s"] >= 0


def test_ring_overlap_event_only_when_asked():
    _, tt = _tensor()
    init = _init(tt.dims)
    _port(tt, 4, "async_ring", init, measure_overlap=True)
    evs = resilience.run_report().events("ring_overlap")
    assert len(evs) == 1 and evs[0]["variant"] == "async_ring"
    lines = resilience.run_report().summary()
    assert any(ln.startswith("  ring overlap [sync_ring]") for ln in lines)
    resilience.run_report().clear()
    _port(tt, 4, "async_ring", init)
    assert not resilience.run_report().events("ring_overlap")
    resilience.run_report().clear()
    _port(tt, 4, "all2all", init, measure_overlap=True)
    assert not resilience.run_report().events("ring_overlap")


def test_comm_fallback_summary_line_matches_jax():
    for rep in (resilience.run_report(), jres.run_report()):
        rep.add("comm_fallback", strategy="async_ring", fallback_to="ring",
                failure_class="resource", error="RESOURCE_EXHAUSTED: x")
        rep.add("ring_overlap", engine="e", overlap_frac=0.25,
                exchange_s=0.5, model_mb_per_device=1.5)
    assert resilience.run_report().summary() == jres.run_report().summary()


# -- dispatch, engines, CLI --------------------------------------------------


@pytest.mark.parametrize("decomp", [Decomposition.MEDIUM,
                                    Decomposition.COARSE])
def test_medium_and_coarse_dispatch_match_jax(decomp):
    """distributed_cpd_als runs MEDIUM (on the auto grid of its mesh) and
    COARSE, as the JAX package's dispatch does."""
    from splatt_tpu.config import Decomposition as JDecomp
    from splatt_tpu.parallel import distributed_cpd_als as jax_dispatch

    jt, tt = _tensor()
    init = _init(tt.dims)
    got = distributed_cpd_als(
        tt, RANK, Options(decomposition=decomp, max_iterations=ITERS,
                          tolerance=0.0, val_dtype=torch.float64,
                          verbosity=Verbosity.NONE),
        init=init, mesh=make_mesh(n_devices=4, device="cpu"))
    jopts = JOptions(decomposition=JDecomp(decomp.value),
                     max_iterations=ITERS, tolerance=0.0,
                     val_dtype=np.float64, verbosity=JVerbosity.NONE)
    want = jax_dispatch(jt, RANK, jopts, init=[jnp.asarray(i) for i in init],
                        mesh=jax_make_mesh(n_devices=4))
    _assert_same(got, want, fit_tol=1e-8, tol=1e-6)


def test_fine_dispatch_and_partition_imply_fine():
    _, tt = _tensor()
    init = _init(tt.dims)
    opts = Options(decomposition=Decomposition.FINE, max_iterations=2,
                   tolerance=0.0, val_dtype=torch.float64,
                   verbosity=Verbosity.NONE)
    mesh = make_mesh(n_devices=2, device="cpu")
    a = distributed_cpd_als(tt, RANK, opts, init=init, mesh=mesh)
    part = np.arange(tt.nnz) % 2
    opts.decomposition = Decomposition.MEDIUM
    b = distributed_cpd_als(tt, RANK, opts, init=init, mesh=mesh,
                            partition=part)
    assert np.isfinite(a.fit) and np.isfinite(b.fit)
    with pytest.raises(ValueError, match="row_distribute"):
        distributed_cpd_als(tt, RANK, opts, mesh=mesh,
                            row_distribute="greedy")


@pytest.mark.parametrize("comm,exc", [("async_ring", ValueError)])
def test_blocked_local_engine_raises(comm, exc):
    _, tt = _tensor()
    with pytest.raises(exc, match="ring"):
        _port(tt, 2, comm, _init(tt.dims), local_engine="blocked")


@pytest.mark.parametrize("partitioned", [False, True])
def test_blocked_local_engine_all2all_matches_stream(partitioned):
    """local_engine="blocked" runs under ALL2ALL (its default there) and
    matches the stream engine and the JAX package's stream CPD."""
    jt, tt = _tensor()
    init = _init(tt.dims)
    part = (np.random.default_rng(5).integers(0, 4, size=tt.nnz)
            if partitioned else None)
    blocked = _port(tt, 4, "all2all", init, partition=part,
                    local_engine="blocked")
    _assert_same(blocked, _port(tt, 4, "all2all", init, partition=part,
                                local_engine="stream"))
    _assert_same(blocked, _jax(jt, 4, "all2all", init, partition=part))


def test_cli_async_ring_json(tensors_dir, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli_main(["cpd", str(tensors_dir / "med.tns"), "-r", "4", "-i",
                     "3", "--comm", "async_ring", "--device", "cpu",
                     "--json", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "DISTRIBUTED decomp=fine devices=8" in text
    assert text.count("fit = ") == 3
    rec = json.loads(text.strip().splitlines()[-1])
    kinds = [e["kind"] for e in rec["events"]]
    assert "layout_imbalance" in kinds and "ring_overlap" in kinds
    assert (out / "mode1.mat").exists() and (out / "lambda.mat").exists()


def test_cli_partition_and_decomp_errors(tensors_dir, tmp_path, capsys):
    tt = gen.fixture_tensor("med")
    part = tmp_path / "part.txt"
    part.write_text("\n".join(str(i % 3) for i in range(tt.nnz)) + "\n")
    assert cli_main(["cpd", str(tensors_dir / "med.tns"), "-r", "3", "-i",
                     "2", "-p", str(part), "--ndev", "3", "--device", "cpu",
                     "-o", str(tmp_path / "o")]) == 0
    assert "DISTRIBUTED decomp=fine devices=3" in capsys.readouterr().out
    with pytest.raises(ValueError, match="ring"):
        cli_main(["cpd", str(tensors_dir / "med.tns"), "--decomp", "coarse",
                  "--comm", "point2point", "--device", "cpu"])
    with pytest.raises(ValueError, match="FINE"):
        cli_main(["cpd", str(tensors_dir / "med.tns"), "--decomp", "medium",
                  "-p", str(part), "--device", "cpu"])
    assert cli_main(["cpd", str(tensors_dir / "med.tns"), "-r", "3", "-i",
                     "2", "--decomp", "medium", "--device", "cpu", "-o",
                     str(tmp_path / "o")]) == 0
    assert "DISTRIBUTED decomp=medium devices=8" in capsys.readouterr().out


def test_coo_cpd_uploads_the_tensor_once(monkeypatch):
    """The single-device COO cpd_als copies its indices and values to the
    device once per run, not once per MTTKRP."""
    _, tt = _tensor()
    calls = []
    real = torch.from_numpy

    def spy(a):
        calls.append(a.shape)
        return real(a)

    monkeypatch.setattr(torch, "from_numpy", spy)
    cpd_als(tt, 4, Options(max_iterations=4, tolerance=0.0,
                           verbosity=Verbosity.NONE),
            init=_init(tt.dims, rank=4), device="cpu")
    big = [s for s in calls if tt.nnz in s]
    assert sorted(big) == sorted([tt.inds.shape, tt.vals.shape])
