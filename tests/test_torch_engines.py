"""The port's MTTKRP engine chain and the plain versions of its kernels,
against the JAX package.

- Each new plain version against its Pallas kernel in interpret mode, on
  the same inputs (f64, 1e-10: the repo's TOL).
- The chain: order, gates and demotion as splatt_tpu.ops.mttkrp's; under
  every armed fault schedule ``mttkrp`` equals splatt_tpu's
  ``mttkrp_stream`` at 1e-10; only an engine's own failure demotes.
- ``cpd_als`` and the CLI through an engine fault.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu.blocked import build_layout
from splatt_tpu.ops.mttkrp import mttkrp_stream
from splatt_tpu.ops.pallas_kernels import fused_mttkrp as jfused
from splatt_tpu.ops.pallas_kernels import fused_mttkrp_tg as jfused_tg
from splatt_tpu.ops.pallas_kernels import onehot_reduce_full as jfull
from splatt_tpu.ops.pallas_kernels import onehot_reduce_sorted as jsorted
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import BlockAlloc, Options, Verbosity
from splatt_tpu_torch.cpd import cpd_als
from splatt_tpu_torch.ops import kernels
from splatt_tpu_torch.ops import mttkrp as tm
from splatt_tpu_torch.utils import faults
from tests import gen
from tests.test_mttkrp import TOL, make_factors
from tests.test_torch_kernels import port_layout
from tests.test_torch_kernels_gpu import contracts
from tests.torch_fixtures import private_tune_cache  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors gain nothing from torch's intra-op threads, and the
    suite runs beside other pytest workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SPLATT_FAULTS", raising=False)
    monkeypatch.delenv("SPLATT_ENGINE_FALLBACK", raising=False)
    monkeypatch.delenv("SPLATT_EXPERIMENTAL_FUSED", raising=False)
    # transient retries back off for real: not in these tests
    monkeypatch.setattr(resilience.time, "sleep", lambda s: None)

    def clear():
        faults.reset()
        resilience.reset_demotions()
        resilience.run_report().clear()

    clear()
    yield
    clear()


# -- plain versions against the Pallas kernels (interpret mode) --------------


@pytest.mark.parametrize("rank", [1, 8, 13, 50])
def test_onehot_reduce_sorted_plain_matches_pallas(rank):
    rng = np.random.default_rng(0)
    nb, B, S = 5, 128, 16
    local = rng.integers(-1, S + 3, size=(nb, B)).astype(np.int32)
    prod = rng.random((nb, B, rank))
    want = np.asarray(jsorted(jnp.asarray(local), jnp.asarray(prod), S,
                              interpret=True))
    got = kernels.onehot_reduce_sorted(torch.from_numpy(local),
                                       torch.from_numpy(prod), S)
    assert got.dtype == torch.float64 and got.shape == (nb, S, rank)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("rank", [1, 8, 13, 50])
def test_onehot_reduce_full_plain_matches_pallas(rank):
    rng = np.random.default_rng(1)
    nb, B, W = 9, 128, 24   # nb not divisible by the Pallas chunk
    local = rng.integers(-1, W + 4, size=(nb, B)).astype(np.int32)
    prod = rng.random((nb, B, rank))
    want = np.asarray(jfull(jnp.asarray(local), jnp.asarray(prod), W,
                            interpret=True))
    got = kernels.onehot_reduce_full(torch.from_numpy(local),
                                     torch.from_numpy(prod), W)
    assert got.shape == (W, rank)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def _layouts(name, block):
    tt = gen.fixture_tensor(name)
    return tt, [build_layout(tt, m, block=block, val_dtype=np.float64)
                for m in range(tt.nmodes)]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("name,block,rank", [("med", 128, 8),
                                             ("med", 512, 13),
                                             ("med4", 256, 20),
                                             ("small", 128, 264)])
def test_fused_tg_plain_matches_pallas(name, block, rank, accumulate):
    tt, lays = _layouts(name, block)
    jf = make_factors(tt.dims, rank=rank)
    tf = [torch.from_numpy(np.array(U)) for U in jf]
    for lay, m, width, acc in contracts(lays, tt.dims):
        if acc != accumulate:
            continue
        want = np.asarray(jfused_tg(lay, jf, m, width, accumulate=acc,
                                    interpret=True))
        got = kernels.fused_mttkrp_tg(port_layout(lay), tf, m, width, acc)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"{name} mode={m} acc={acc}")


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("name,block,rank,chunk", [("med", 128, 8, 1),
                                                   ("med", 256, 13, 3),
                                                   ("med4", 256, 12, 2)])
def test_fused_plain_matches_pallas(name, block, rank, chunk, accumulate):
    tt, lays = _layouts(name, block)
    jf = make_factors(tt.dims, rank=rank)
    tf = [torch.from_numpy(np.array(U)) for U in jf]
    for lay, m, width, acc in contracts(lays, tt.dims):
        if acc != accumulate:
            continue
        want = np.asarray(jfused(lay, jf, m, width, accumulate=acc,
                                 interpret=True, chunk=chunk))
        got = kernels.fused_mttkrp(port_layout(lay), tf, m, width, acc,
                                   chunk=chunk)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                   err_msg=f"{name} mode={m} acc={acc}")


@pytest.mark.parametrize("accumulate", [False, True])
def test_xla_scan_chunks_match_one_step(accumulate):
    """The xla_scan engine over many small steps (a ragged last one)
    equals the one-step reduction, and fused_mttkrp_t's plain version."""
    tt, lays = _layouts("med", 128)
    tf = [torch.from_numpy(np.array(U)) for U in make_factors(tt.dims, 6)]
    for lay, m, width, acc in contracts([port_layout(x) for x in lays],
                                        tt.dims):
        if acc != accumulate:
            continue
        want = kernels.fused_mttkrp_t_plain(lay, tf, m, width, acc)
        assert lay.nblocks > 3
        for target in (128 * 6 * 3, tm.SCAN_TARGET_ELEMS):
            got = tm._scan_fused(lay, tf, m, width, acc, target)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                       rtol=0)


# -- the chain: order and gates -----------------------------------------------


def _meta_call(nnz_pad, rank, dims=(12092, 9184, 28818), block=4096,
               device="cpu"):
    """A stand-in layout on `device` and factors of a given size:
    engine_chain reads only shapes and the layout's device, so nothing is
    allocated."""
    lay = SimpleNamespace(block=block, nnz_pad=nnz_pad,
                          vals=SimpleNamespace(device=torch.device(device)))
    facs = [torch.empty((d, rank), device="meta") for d in dims]
    return lay, facs


def test_chain_at_nell2_shape():
    lay, facs = _meta_call(20_000_768, 50)
    assert tm.engine_chain(lay, facs, 0) == [
        "fused_t", "fused_tg", "unfused_pallas", "xla_scan", "xla"]
    assert tm.engine_chain(lay, facs, 0, "privatized")[0] == "fused_t"
    lay, facs = _meta_call(20_000_768, 512)
    # the (nnz_pad, 512) product is 41 GB: past the unfused budget
    assert tm.engine_chain(lay, facs, 0) == ["fused_tg", "xla_scan", "xla"]


def test_card_chain_holds_only_kernel_engines(monkeypatch):
    """On a card the chain ends at the last kernel engine: no plain-torch
    engine stands in for a kernel there, and once every kernel engine is
    demoted the chain is empty."""
    lay, facs = _meta_call(20_000_768, 50, device="cuda")
    assert tm.engine_chain(lay, facs, 0) == [
        "fused_t", "fused_tg", "unfused_pallas"]
    monkeypatch.setenv("SPLATT_EXPERIMENTAL_FUSED", "1")
    assert tm.engine_chain(lay, facs, 0, "privatized") == [
        "fused_t", "fused_tg", "fused", "unfused_pallas"]
    lay, facs = _meta_call(20_000_768, 512, device="cuda")
    assert tm.engine_chain(lay, facs, 0) == ["fused_tg"]
    for path in ("scatter", "sorted_scatter"):
        assert tm.engine_chain(lay, facs, 0, path) == ["xla"]
    resilience.demote_engine("fused_tg", RuntimeError("injected runtime"))
    assert tm.engine_chain(lay, facs, 0) == []
    assert tm.engine_plan(lay, facs, 0) == "none"


@pytest.mark.parametrize("rank,head", [(1, "fused_t"), (50, "fused_t"),
                                       (256, "fused_t"), (257, "fused_tg"),
                                       (300, "fused_tg")])
def test_chain_head_follows_rank(rank, head):
    lay, facs = _meta_call(4096, rank)
    chain = tm.engine_chain(lay, facs, 1)
    assert chain[0] == head
    assert chain[-2:] == ["xla_scan", "xla"]


def test_experimental_flag_inserts_fused(monkeypatch):
    lay, facs = _meta_call(4096, 50)
    monkeypatch.setenv("SPLATT_EXPERIMENTAL_FUSED", "1")
    assert tm.engine_chain(lay, facs, 0) == [
        "fused_t", "fused_tg", "fused", "unfused_pallas", "xla_scan", "xla"]
    lay, facs = _meta_call(4096, 300)
    assert "fused" not in tm.engine_chain(lay, facs, 0)


def test_scatter_paths_are_single_engine():
    lay, facs = _meta_call(4096, 50)
    for path in ("scatter", "sorted_scatter", "stream"):
        assert tm.engine_chain(lay, facs, 0, path) == ["xla"]


def test_chain_skips_demoted_and_keeps_terminal():
    lay, facs = _meta_call(4096, 16)
    full = tm.engine_chain(lay, facs, 0)
    resilience.demote_engine("fused_t", RuntimeError("injected runtime"))
    assert tm.engine_chain(lay, facs, 0) == full[1:]
    assert tm.engine_plan(lay, facs, 0) == "fused_tg"
    # an out-of-memory demotes for its shape only
    key = tm._engine_shape_key(lay, facs, 0)
    resilience.demote_engine("fused_tg", RuntimeError("CUDA out of memory"),
                             shape_key=key)
    assert "fused_tg" not in tm.engine_chain(lay, facs, 0)
    other, ofacs = _meta_call(4096, 16, block=128)
    assert "fused_tg" in tm.engine_chain(other, ofacs, 0)
    for e in full:
        resilience.demote_engine(e, RuntimeError("injected runtime"))
    assert tm.engine_chain(lay, facs, 0) == ["xla"]


# -- the chain: runs ----------------------------------------------------------


def _port_bs(name, block=128):
    tt = gen.fixture_tensor(name)
    X = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    bs = BlockedSparse.from_coo(X, Options(
        block_alloc=BlockAlloc.ALLMODE, nnz_block=block,
        val_dtype=torch.float64), device="cpu")
    return tt, bs


def _oracle(tt, jf, mode):
    return np.asarray(mttkrp_stream(jnp.asarray(tt.inds),
                                    jnp.asarray(tt.vals), jf, mode,
                                    tt.dims[mode]))


KERNEL_FAULTS = ("engine.fused_t:runtime:*,engine.fused_tg:runtime:*,"
                 "engine.fused:runtime:*,engine.unfused_pallas:runtime:*")

# (schedule, experimental flag, engines demoted, engine that finishes)
SCHEDULES = [
    ("", False, [], "fused_t"),
    ("engine.fused_t:runtime", False, ["fused_t"], "fused_tg"),
    ("engine.fused_t:oom", False, ["fused_t"], "fused_tg"),
    ("engine.fused_t:http500", False, [], "fused_t"),
    ("engine.fused_t:runtime,engine.fused_tg:mosaic", False,
     ["fused_t", "fused_tg"], "unfused_pallas"),
    ("engine.fused_t:runtime,engine.fused_tg:runtime", True,
     ["fused_t", "fused_tg"], "fused"),
    (KERNEL_FAULTS, True,
     ["fused_t", "fused_tg", "fused", "unfused_pallas"], "xla_scan"),
    (KERNEL_FAULTS, False, ["fused_t", "fused_tg", "unfused_pallas"],
     "xla_scan"),
    (KERNEL_FAULTS + ",engine.xla_scan:unavailable:*", False,
     ["fused_t", "fused_tg", "unfused_pallas", "xla_scan"], "xla"),
]


@pytest.mark.parametrize("path", ["sorted_onehot", "privatized"])
@pytest.mark.parametrize("schedule,experimental,demoted,last", SCHEDULES)
@pytest.mark.parametrize("name", ["med", "med4"])
def test_mttkrp_under_faults_matches_stream(monkeypatch, name, schedule,
                                            experimental, demoted, last,
                                            path):
    if experimental:
        monkeypatch.setenv("SPLATT_EXPERIMENTAL_FUSED", "1")
    monkeypatch.setenv("SPLATT_FAULTS", schedule)
    faults.reset()
    ran = []
    run_engine = tm._run_engine

    def recording(engine, *args):
        ran.append(engine)
        return run_engine(engine, *args)

    monkeypatch.setattr(tm, "_run_engine", recording)
    tt, bs = _port_bs(name)
    jf = make_factors(tt.dims, rank=6)
    tf = [torch.from_numpy(np.array(U)) for U in jf]
    for mode in range(tt.nmodes):
        if path == "privatized":
            bs.mode_map[mode] = (mode + 1) % tt.nmodes
        got = tm.mttkrp(bs, tf, mode, path=path)
        np.testing.assert_allclose(got.numpy(), _oracle(tt, jf, mode),
                                   atol=TOL, rtol=0,
                                   err_msg=f"{schedule} mode={mode}")
        assert ran[-1] == last
    evs = resilience.run_report().events("engine_demotion")
    assert [e["engine"] for e in evs] == demoted
    if "http500" in schedule:
        assert len(resilience.run_report().events("transient_retry")) == 1


def test_fallback_off_raises_and_demotes_nothing(monkeypatch):
    tt, bs = _port_bs("med")
    tf = [torch.from_numpy(np.array(U)) for U in make_factors(tt.dims, 4)]
    with faults.inject("engine.fused_t", "runtime", times=faults.ALWAYS):
        with pytest.raises(RuntimeError, match="injected"):
            tm.mttkrp(bs, tf, 0, fallback=False)
        monkeypatch.setenv("SPLATT_ENGINE_FALLBACK", "0")
        with pytest.raises(RuntimeError, match="injected"):
            tm.mttkrp(bs, tf, 0)
        assert not resilience.demotions()
        # the options of one cpd_als run override the env
        _cpd(bs, engine_fallback=True)
    assert [d.engine for d in resilience.demotions()] == ["fused_t"]


def test_terminal_engine_failure_propagates():
    tt, bs = _port_bs("med")
    tf = [torch.from_numpy(np.array(U)) for U in make_factors(tt.dims, 4)]
    faults.arm("engine.xla", faults.parse_spec("engine.xla:runtime:*")[1])
    with faults.inject("engine.fused_t", "runtime", times=faults.ALWAYS):
        with faults.inject("engine.fused_tg", "runtime",
                           times=faults.ALWAYS):
            with faults.inject("engine.unfused_pallas", "runtime",
                               times=faults.ALWAYS):
                with faults.inject("engine.xla_scan", "runtime",
                                   times=faults.ALWAYS):
                    with pytest.raises(RuntimeError, match="engine.xla"):
                        tm.mttkrp(bs, tf, 0)
    assert len(resilience.demotions()) == 4


@pytest.mark.parametrize("exc,demotes,scope", [
    (kernels.KernelLaunchError("the card refused the launch "
                               "(cudaErrorLaunchOutOfResources = 701)"),
     True, None),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
     True, "r32:b128"),
    (ValueError("an operand bug"), False, None),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False, None),
])
def test_only_an_engines_own_failure_demotes(monkeypatch, exc, demotes,
                                             scope):
    tt, bs = _port_bs("med")
    jf = make_factors(tt.dims, rank=4)
    tf = [torch.from_numpy(np.array(U)) for U in jf]

    def broken(*args, **kw):
        raise exc

    monkeypatch.setattr(kernels, "fused_mttkrp_t", broken)
    if demotes:
        got = tm.mttkrp(bs, tf, 1)
        np.testing.assert_allclose(got.numpy(), _oracle(tt, jf, 1),
                                   atol=TOL, rtol=0)
        (d,) = resilience.demotions()
        assert (d.engine, d.shape_key) == ("fused_t", scope)
    else:
        with pytest.raises(type(exc)):
            tm.mttkrp(bs, tf, 1)
        assert not resilience.demotions()


@pytest.mark.parametrize("bad", ["int_factors", "mixed_dtypes",
                                 "wrong_rank", "wrong_device"])
def test_wrong_operand_raises_before_any_demotion(bad):
    tt, bs = _port_bs("med")
    # the build's own layout_imbalance events are not the dispatch's
    resilience.run_report().clear()
    tf = [torch.from_numpy(np.array(U)) for U in make_factors(tt.dims, 4)]
    if bad == "int_factors":
        tf = [U.long() for U in tf]
    elif bad == "mixed_dtypes":
        tf[1] = tf[1].float()
    elif bad == "wrong_rank":
        tf[2] = tf[2][:, :3]
    else:
        tf[2] = torch.empty(tf[2].shape, dtype=tf[2].dtype, device="meta")
    with faults.inject("engine.fused_t", "runtime", times=faults.ALWAYS):
        with pytest.raises((TypeError, ValueError)):
            tm.mttkrp(bs, tf, 0)
    assert not resilience.demotions()
    assert not resilience.run_report().events()


def test_plan_names_engines_and_demotions():
    tt, bs = _port_bs("med")
    tf = [torch.from_numpy(np.array(U)) for U in make_factors(tt.dims, 4)]
    assert tm.plan_mttkrp(bs, tf, 0) == tm.Plan("cpu", "sorted_onehot",
                                                "fused_t")
    assert tm.describe_plan(bs, tf) == (
        "engine plan: impl=cpu mode0=sorted_onehot/fused_t "
        "mode1=sorted_onehot/fused_t mode2=sorted_onehot/fused_t")
    with faults.inject("engine.fused_t", "runtime"):
        tm.mttkrp(bs, tf, 0)
    assert tm.describe_plan(bs, tf).endswith(
        "mode2=sorted_onehot/fused_tg [demoted this run: fused_t]")


# -- cpd_als and the CLI through faults ---------------------------------------


def _cpd(bs, **kw):
    opts = Options(block_alloc=BlockAlloc.ALLMODE, nnz_block=128,
                   max_iterations=4, tolerance=0.0, val_dtype=torch.float64,
                   verbosity=Verbosity.NONE, **kw)
    init = [np.random.default_rng(3).random((d, 5)) for d in bs.dims]
    return cpd_als(bs, 5, opts, init=init, device="cpu")


@pytest.mark.parametrize("schedule", ["engine.fused_t:runtime",
                                      "engine.fused_t:oom:*",
                                      KERNEL_FAULTS])
def test_cpd_through_engine_fault_matches_unfaulted(monkeypatch, schedule):
    tt, bs = _port_bs("med4")
    base = _cpd(bs)
    monkeypatch.setenv("SPLATT_FAULTS", schedule)
    faults.reset()
    faulted = _cpd(bs, engine_fallback=True)
    np.testing.assert_allclose(faulted.fits, base.fits, atol=1e-12, rtol=0)
    assert resilience.run_report().events("engine_demotion")


def test_cpd_with_fallback_off_raises(capsys):
    tt, bs = _port_bs("med")
    with faults.inject("engine.fused_t", "runtime"):
        with pytest.raises(RuntimeError, match="injected"):
            _cpd(bs, engine_fallback=False)
    assert not resilience.demotions()


def test_cpd_prints_the_plan(capsys):
    tt, bs = _port_bs("med")
    opts = Options(max_iterations=1, val_dtype=torch.float64)
    cpd_als(bs, 3, opts, device="cpu")
    assert "engine plan: impl=cpu mode0=sorted_onehot/fused_t" in \
        capsys.readouterr().out


def _cli(tensors_dir, tmp_path, *extra, faults_env=""):
    env = dict(os.environ, SPLATT_FAULTS=faults_env, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "splatt_tpu_torch.cli", "cpd",
         str(tensors_dir / "med.tns"), "-r", "4", "-i", "2", "--seed", "1",
         "--device", "cpu", "-o", str(tmp_path), *extra],
        capture_output=True, text=True, timeout=300, env=env)


def test_cli_json_reports_the_demotion(tensors_dir, tmp_path):
    r = _cli(tensors_dir, tmp_path, "--json",
             faults_env="engine.fused_t:runtime")
    assert r.returncode == 0, r.stderr
    assert "Resilience events:" in r.stdout
    assert "engine fused_t demoted for this process" in r.stdout
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert 0.0 < rec["fit"] <= 1.0
    assert [e["engine"] for e in rec["events"]
            if e["kind"] == "engine_demotion"] == ["fused_t"]
    assert rec["demotions"][0]["failure_class"] == "unknown"


def test_cli_fallback_off_exits_nonzero(tensors_dir, tmp_path):
    r = _cli(tensors_dir, tmp_path, "--engine-fallback", "off",
             faults_env="engine.fused_t:runtime")
    assert r.returncode != 0
    assert "injected engine runtime failure" in r.stderr
