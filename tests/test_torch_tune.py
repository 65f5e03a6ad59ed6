"""The port's autotuner (splatt_tpu_torch/tune.py) against the JAX
package's, on the CPU.

Same numpy inputs through both packages: plan keys, shape and skew regimes
and density buckets are byte-identical for f32, f64 and bf16; under one
deterministic stand-in cost (a function of the candidate layout, never of
the engine, whose chains differ) both tuners measure the same candidate
layouts and pick the same (path, block, index width, value storage,
packing, reorder) per mode; from the same plans both ``compile(rank=)``
builds equal host arrays and drop the same modes with ``tuner_degraded``;
a tuned f64 CPD equals the untuned one and the JAX package's tuned CPD
(1e-10).  The port alone: the cache's life (warm, restart, TTL, source
hash, corrupt and foreign files, concurrent writers), failure handling
(negative entries, retries, the ``tuner.measure`` drill, a blown deadline,
and a build or load failure, a wrong operand or a sticky CUDA error, which
propagate and write nothing), and dispatch (the plan heads the chain only
where it applies).  Every test has its own plan-cache files.
"""

import json
import pathlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import blocked as jb
from splatt_tpu import cpd_als as jax_cpd_als
from splatt_tpu import resilience as jres
from splatt_tpu import tune as jtune
from splatt_tpu.config import BlockAlloc as JAlloc
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.coo import SparseTensor as JSparse
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import blocked as tb
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience, tune
from splatt_tpu_torch.config import BlockAlloc, Options, Verbosity
from splatt_tpu_torch.cpd import cpd_als, init_factors
from splatt_tpu_torch.ops import kernels
from splatt_tpu_torch.ops import mttkrp as tm
from splatt_tpu_torch.utils import faults
from tests import gen

RANK = 4
CPU = "cpu"


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Each test: its own plan caches (the port's through
    SPLATT_TUNE_CACHE, the JAX package's through its override), clean
    demotions, reports and faults, instant transient backoff."""
    monkeypatch.setenv("SPLATT_TUNE_CACHE", str(tmp_path / "tune_cache.json"))
    jtune.set_cache_path(str(tmp_path / "jax_tune_cache.json"))
    for mod in (resilience, jres):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        mod.reset_demotions()
        mod.run_report().clear()
    tune.reset_memo()
    yield
    jtune.set_cache_path(None)
    tune.reset_memo()
    for mod in (faults, jfaults):
        mod.reset()
    for mod in (resilience, jres):
        mod.reset_demotions()
        mod.run_report().clear()


def _cache_file() -> pathlib.Path:
    return tune.cache_path()


# -- tensors --------------------------------------------------------------------


def _med():
    tt = gen.fixture_tensor("med")
    return tt.vals, tt.inds, tt.dims


def _zipf():
    """The JAX package's balance fixture (tests/test_balance.py:65-68)."""
    rng = np.random.default_rng(0)
    dims = (60, 44, 52)
    inds = np.stack([(rng.zipf(1.5, 4000) - 1) % d for d in dims])
    return np.round(rng.random(4000), 3) + 0.1, inds, dims


def _dense():
    """16 x 32 x 120, 4000 unique nonzeros: modes 0 and 1 pass the dense
    verdict at the default threshold."""
    rng = np.random.default_rng(9)
    dims = (16, 32, 120)
    flat = rng.choice(int(np.prod(dims)), 4000, replace=False)
    inds = np.stack(np.unravel_index(flat, dims))
    return np.round(rng.random(4000), 3) + 0.1, inds, dims


TENSORS = {"med": _med, "zipf": _zipf, "dense": _dense}


def _pair(name):
    vals, inds, dims = TENSORS[name]()
    return (JSparse(np.asarray(inds), np.asarray(vals), dims),
            tcoo.SparseTensor(np.asarray(inds), np.asarray(vals), dims))


def _port(name):
    return _pair(name)[1]


def _opts(**kw):
    kw.setdefault("random_seed", 42)
    kw.setdefault("verbosity", Verbosity.NONE)
    kw.setdefault("val_dtype", torch.float64)
    return Options(**kw)


def _jopts(**kw):
    kw.setdefault("random_seed", 42)
    kw.setdefault("verbosity", JVerbosity.NONE)
    kw.setdefault("val_dtype", np.float64)
    kw.setdefault("use_pallas", True)   # the sorted one-hot path on a CPU
    return JOptions(**kw)


def _quick(tt, opts=None, **kw):
    """A tune over one block, format, packing and reorder: every engine
    of the CPU chain, measured for real."""
    kw.setdefault("blocks", (512,))
    kw.setdefault("formats", [("i32", "auto")])
    kw.setdefault("packings", ("fixed",))
    kw.setdefault("reorders", ("identity",))
    return tune.tune(tt, RANK, opts=opts or _opts(), reps=1, device=CPU,
                     **kw)


# -- keys -----------------------------------------------------------------------

DTYPES = {"f32": (torch.float32, jnp.float32),
          "f64": (torch.float64, jnp.float64),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(TENSORS))
def test_plan_keys_match_the_reference(name, dtype):
    J, X = _pair(name)
    tdt, jdt = DTYPES[dtype]
    assert tune.shape_regime(X.dims, X.nnz) == jtune.shape_regime(
        J.dims, J.nnz)
    for m in range(X.nmodes):
        skew = tune.skew_of(X, m)
        assert skew == jtune.skew_of(J, m)
        md = tb.mode_density_bucket(X.dims, m, X.nnz)
        assert md == jb.mode_density_bucket(J.dims, m, J.nnz)
        for batch in (1, 5):
            assert tune.plan_key(X.dims, X.nnz, m, RANK, tdt, skew=skew,
                                 batch=batch, mode_density=md) == \
                jtune.plan_key(J.dims, J.nnz, m, RANK, jdt, skew=skew,
                               batch=batch, mode_density=md)
        # numpy and named dtypes key as the torch dtype does
        assert tune.plan_key(X.dims, X.nnz, m, RANK, str(jnp.dtype(jdt)),
                             skew=skew) == tune.plan_key(
            X.dims, X.nnz, m, RANK, tdt, skew=skew)
        # build_layout stamps the skew the key reads at dispatch
        assert tb.build_layout(X, m, block=256, device=CPU).skew == skew
    if name == "zipf":
        assert any(tune.skew_regime(tune.skew_of(X, m))
                   for m in range(X.nmodes))
    if name == "dense":
        assert tb.mode_density_bucket(X.dims, 0, X.nnz)


# -- the same winner under one stand-in cost ---------------------------------

_IDX_COST = {"i32": 3e-3, "auto": 1e-3, "u8": 4e-3, "delta": 2e-3,
             "rle": 5e-3, "dense": 5e-4}
_REORDER_COST = {"identity": 0.0, "graph": 1.5e-3, "hgraph": 7e-4,
                 "fibsched": 2.2e-3, "random": 9e-3}


def _cost(layout) -> float:
    """A deterministic cost of the candidate layout alone: the engines of
    the two packages' chains differ, the layouts must not."""
    return (1.0 + 1e-2 * ((layout.block // 128) % 7)
            + _IDX_COST[layout.idx_width]
            + (2e-3 if layout.packing == "balanced" else 0.0)
            + _REORDER_COST[layout.reorder]
            + (1e-4 if layout.val_storage == "bf16" else 0.0)
            + 1e-5 * layout.mode)


def _spies(monkeypatch):
    seen = {"jax": set(), "torch": set()}

    def record(tag, layout):
        seen[tag].add((layout.mode, layout.block, layout.idx_width,
                       layout.val_storage, layout.packing, layout.reorder))
        return _cost(layout)

    monkeypatch.setattr(
        jtune, "_measure_candidate",
        lambda layout, f, m, path, impl, engine, st, **kw:
        record("jax", layout))
    monkeypatch.setattr(
        tune, "_measure_candidate",
        lambda layout, f, m, path, engine, st, **kw: record("torch", layout))
    return seen


def _layout_axes(plan):
    return (plan.path, plan.nnz_block, plan.idx_width, plan.val_storage,
            plan.packing, plan.reorder)


WINNER_CASES = [("med", "f64", {}), ("zipf", "f64", {}),
                ("med", "f32", {}), ("dense", "f64", {"dense": "auto"})]


@pytest.mark.parametrize("name,dtype,extra", WINNER_CASES)
def test_same_winner_and_candidates_under_a_shared_cost(monkeypatch, name,
                                                        dtype, extra):
    J, X = _pair(name)
    tdt, jdt = DTYPES[dtype]
    seen = _spies(monkeypatch)
    kw = dict(blocks=(128, 512, 2048))
    got = tune.tune(X, RANK, opts=_opts(val_dtype=tdt, **extra), device=CPU,
                    **kw)
    want = jtune.tune(J, RANK, opts=_jopts(val_dtype=jdt, **extra), **kw)
    assert set(got.plans) == set(want.plans) == set(range(X.nmodes))
    for m in range(X.nmodes):
        assert _layout_axes(got.plans[m]) == _layout_axes(want.plans[m])
    assert seen["torch"] == seen["jax"]
    if name == "dense":
        assert any(p.path == "dense" for p in got.plans.values())


def test_candidate_builds_equal_builds_from_scratch(monkeypatch):
    """The tune's candidates, built from one sorted copy per mode and
    recipe, equal build_layout of the tensor itself."""
    X = _port("zipf")
    seen = []
    monkeypatch.setattr(
        tune, "_measure_candidate",
        lambda layout, f, m, path, engine, st, **kw:
        seen.append(layout) or _cost(layout))
    tune.tune(X, RANK, opts=_opts(), device=CPU, blocks=(256, 1024),
              formats=[("i32", "auto")], reorders=("identity",))
    assert {(lay.mode, lay.packing) for lay in seen} == {
        (m, p) for m in range(X.nmodes) for p in ("fixed", "balanced")}
    for lay in seen:
        want = tb.build_layout(X, lay.mode, block=lay.block,
                               val_dtype=torch.float64, device=CPU,
                               packing=lay.packing)
        assert lay.skew == want.skew
        for a, b in ((lay.inds, want.inds), (lay.vals, want.vals),
                     (lay.row_start, want.row_start)):
            assert torch.equal(a, b)
        assert (lay.block_nnz is None) == (want.block_nnz is None)
        if lay.block_nnz is not None:
            assert torch.equal(lay.block_nnz, want.block_nnz)


# -- the same layouts from the same plans ------------------------------------

def _plan(path="sorted_onehot", block=512, idx="i32", val="auto",
          packing="fixed", reorder="identity", engine="xla"):
    return dict(path=path, engine=engine, nnz_block=block,
                scan_target=1 << 23, sec=0.001, idx_width=idx,
                val_storage=val, packing=packing, reorder=reorder)


def _store_both(J, X, m, dtype, plan):
    tdt, jdt = DTYPES[dtype]
    skew = tune.skew_of(X, m)
    md = tb.mode_density_bucket(X.dims, m, X.nnz)
    tune._entry_store(tune.plan_key(X.dims, X.nnz, m, RANK, tdt, skew=skew,
                                    mode_density=md), {"plan": plan}, CPU)
    jtune._entry_store(jtune.plan_key(J.dims, J.nnz, m, RANK, jdt,
                                      skew=skew, mode_density=md),
                       {"plan": plan})


LAYOUT_CASES = {
    "unanimous_hgraph": ("zipf", {}, {
        0: _plan(block=512, idx="auto", packing="balanced",
                 reorder="hgraph"),
        1: _plan(block=256, packing="fixed", reorder="hgraph"),
        2: _plan(block=1024, idx="delta", packing="balanced",
                 reorder="hgraph")}),
    "mixed_reorder": ("zipf", {}, {
        0: _plan(block=512, reorder="graph"),
        1: _plan(block=256, reorder="identity"),
        2: _plan(block=1024, reorder="identity", packing="balanced")}),
    "pinned_reorder": ("med", {"reorder": "identity"}, {
        0: _plan(block=256, reorder="hgraph"),
        1: _plan(block=512, idx="auto"),
        2: _plan(block=1024, reorder="hgraph")}),
    "pinned_packing": ("zipf", {"fiber_packing": "fixed"}, {
        0: _plan(block=512, packing="balanced"),
        1: _plan(block=256, idx="rle"),
        2: _plan(block=1024, packing="balanced")}),
    "mixed_storage": ("med", {}, {
        0: _plan(block=512, val="bf16"),
        1: _plan(block=256, val="bf16"),
        2: _plan(block=1024, val="auto", idx="u8")}),
    "dense_plans": ("dense", {}, {
        0: _plan(path="dense", block=16, idx="dense", engine="dense_xla"),
        1: _plan(path="dense", block=32, idx="dense", engine="dense_xla"),
        2: _plan(block=1024, idx="auto")}),
}


def _same_layout(got, want):
    assert got.encoding == want.encoding
    assert (got.mode, got.block, got.nnz, got.idx_width, got.val_storage,
            got.packing, got.reorder, got.density_bucket) == (
        want.mode, want.block, want.nnz, want.idx_width, want.val_storage,
        want.packing, want.reorder, want.density_bucket)
    assert got.format_desc() == want.format_desc()
    if got.encoding == "dense":
        np.testing.assert_array_equal(got.tiles.numpy(),
                                      np.asarray(want.tiles))
        return
    assert (got.seg_width, got.nblocks, got.skew) == (
        want.seg_width, want.nblocks, want.skew)
    if want.base is None:
        np.testing.assert_array_equal(got.inds.numpy(),
                                      np.asarray(want.inds))
    else:
        for g, w in zip(list(got.inds) + list(got.base),
                        list(want.inds) + list(want.base)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.vals.to(torch.float64).numpy(),
                                  np.asarray(want.vals).astype(np.float64))
    np.testing.assert_array_equal(got.row_start.numpy(),
                                  np.asarray(want.row_start))
    assert (got.block_nnz is None) == (want.block_nnz is None)
    if got.block_nnz is not None:
        np.testing.assert_array_equal(got.block_nnz.numpy(),
                                      np.asarray(want.block_nnz))


def _degraded(mod):
    return sorted(e["mode"] for e in mod.run_report().events(
        "tuner_degraded"))


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_compile_builds_the_references_layouts_from_the_same_plans(case):
    name, pins, plans = LAYOUT_CASES[case]
    J, X = _pair(name)
    for m, plan in plans.items():
        _store_both(J, X, m, "f64", plan)
    bs = tb.BlockedSparse.compile(
        X, _opts(block_alloc=BlockAlloc.ALLMODE, **pins), device=CPU,
        rank=RANK)
    jbs = jb.BlockedSparse.compile(
        J, _jopts(block_alloc=JAlloc.ALLMODE, **pins), rank=RANK)
    assert bs.mode_map == jbs.mode_map
    assert bs.reorder == jbs.reorder
    assert len(bs.layouts) == len(jbs.layouts)
    for got, want in zip(bs.layouts, jbs.layouts):
        _same_layout(got, want)
    assert (bs.perm is None) == (jbs.perm is None)
    if bs.perm is not None:
        for g, w in zip(bs.perm.perms, jbs.perm.perms):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert _degraded(resilience) == _degraded(jres)
    if case in ("mixed_reorder", "pinned_reorder", "pinned_packing",
                "mixed_storage"):
        assert _degraded(resilience)
    # without a rank, or with autotune off, compile ignores the cache
    for off in (dict(rank=None), dict(rank=RANK)):
        plain = tb.BlockedSparse.compile(
            X, _opts(block_alloc=BlockAlloc.ALLMODE, autotune=False,
                     **pins), device=CPU, **off)
        assert all(lay.block == 4096 or lay.block >= X.nnz
                   or lay.encoding == "dense" for lay in plain.layouts)


# -- the same fit -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["med", "zipf"])
def test_tuned_f64_cpd_equals_untuned_and_the_reference(monkeypatch, name):
    J, X = _pair(name)
    _spies(monkeypatch)
    kw = dict(blocks=(256, 1024), formats=[("i32", "auto"), ("auto", "auto")])
    got = tune.tune(X, RANK, opts=_opts(), device=CPU, **kw)
    want = jtune.tune(J, RANK, opts=_jopts(), **kw)
    assert {m: _layout_axes(p) for m, p in got.plans.items()} == \
        {m: _layout_axes(p) for m, p in want.plans.items()}
    rng = np.random.default_rng(7)
    init = [rng.random((d, RANK)) for d in X.dims]
    tuned = cpd_als(tb.BlockedSparse.compile(X, _opts(), device=CPU,
                                             rank=RANK),
                    RANK, opts=_opts(max_iterations=6, tolerance=0.0),
                    init=init, device=CPU)
    assert resilience.run_report().events("tuned_plan")
    untuned = cpd_als(tb.BlockedSparse.compile(X, _opts(autotune=False),
                                               device=CPU),
                      RANK, opts=_opts(max_iterations=6, tolerance=0.0,
                                       autotune=False),
                      init=init, device=CPU)
    ref = jax_cpd_als(jb.BlockedSparse.compile(J, _jopts(), rank=RANK),
                      RANK, opts=_jopts(max_iterations=6, tolerance=0.0),
                      init=[jnp.asarray(U) for U in init])
    assert abs(tuned.fit - untuned.fit) <= 1e-10
    assert abs(tuned.fit - float(ref.fit)) <= 1e-10
    for a, b in zip(tuned.factors, ref.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


# -- the cache's life -------------------------------------------------------------

def test_warm_cache_makes_no_measurement_and_plans_survive_a_restart():
    X = _port("med")
    res = _quick(X)
    assert set(res.plans) == set(range(X.nmodes))
    assert res.measured > 0 and res.cache_hits == 0
    assert _cache_file().exists()
    res2 = _quick(X)
    assert (res2.measured, res2.cache_hits) == (0, X.nmodes)
    assert res2.plans == res.plans
    tune.reset_memo()  # a fresh process
    plan = tune.cached_plan(X.dims, X.nnz, 0, RANK, torch.float64,
                            skew=tune.skew_of(X, 0), device=CPU)
    assert plan == res.plans[0]
    # the cache is keyed by device: the card's environment holds nothing
    env = json.loads(_cache_file().read_text())["envs"]
    assert list(env) == [tune._cache_env_key(CPU)]
    assert tune._cache_env_key(CPU).split("|")[2] == "cpu"


def test_ttl_expiry_retunes():
    X = _port("med")
    _quick(X)
    data = json.loads(_cache_file().read_text())
    for env in data["envs"].values():
        for entry in env.values():
            entry["ts"] = 1.0
    _cache_file().write_text(json.dumps(data))
    tune.reset_memo()
    assert tune.cached_plan(X.dims, X.nnz, 0, RANK, torch.float64,
                            skew=tune.skew_of(X, 0), device=CPU) is None
    assert _quick(X).measured > 0


def test_a_source_edit_invalidates_every_plan(monkeypatch):
    X = _port("med")
    _quick(X)
    tune.reset_memo()
    monkeypatch.setattr(tune, "_kernel_src_hash", lambda: "edited123456")
    assert tune.cached_plan(X.dims, X.nnz, 0, RANK, torch.float64,
                            skew=tune.skew_of(X, 0), device=CPU) is None
    assert _quick(X).measured > 0


def test_the_source_hash_covers_the_kernels():
    covered = tune._kernel_src_hash()
    assert len(covered) == 12 and covered != "nosrc"


@pytest.mark.parametrize("how", ["corrupt", "foreign_version",
                                 "undeclared_field"])
def test_broken_cache_degrades_to_a_retune(how):
    X = _port("med")
    if how == "corrupt":
        _cache_file().write_text("{ not json")
    else:
        _quick(X)
        data = json.loads(_cache_file().read_text())
        if how == "foreign_version":
            data["version"] = tune.PLAN_CACHE_VERSION + 1
        else:
            for env in data["envs"].values():
                for entry in env.values():
                    entry.get("plan", {})["speedup"] = 2.0
        _cache_file().write_text(json.dumps(data))
        tune.reset_memo()
    assert tune.cached_plan(X.dims, X.nnz, 0, RANK, torch.float64,
                            skew=tune.skew_of(X, 0), device=CPU) is None
    if how != "foreign_version":
        assert resilience.run_report().events("tune_cache_io_error")
    res = _quick(X)
    assert res.plans and res.measured > 0
    tune.reset_memo()
    assert tune.cached_plan(X.dims, X.nnz, 0, RANK, torch.float64,
                            skew=tune.skew_of(X, 0), device=CPU) is not None


def test_concurrent_stores_lose_no_winner():
    n, errs = 16, []

    def store(i):
        try:
            tune._entry_store(f"conc:key{i}", {"plan": _plan(block=512)
                                               | {"sec": 0.001 * (i + 1)}},
                              CPU)
        except Exception as e:  # pragma: no cover - the assert reports it
            errs.append(e)

    threads = [threading.Thread(target=store, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    env = json.loads(_cache_file().read_text())["envs"][
        tune._cache_env_key(CPU)]
    assert {f"conc:key{i}" for i in range(n)} <= set(env)
    tune.reset_memo()
    for i in range(n):
        assert tune._entry_get(f"conc:key{i}", CPU)["plan"]["sec"] == \
            pytest.approx(0.001 * (i + 1))


def test_concurrent_loads_and_stores_never_read_a_torn_entry():
    stop, errs = threading.Event(), []

    def writer(i):
        try:
            for k in range(6):
                tune._entry_store(f"mix:w{i}k{k}", {"plan": _plan()}, CPU)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    def reader():
        try:
            while not stop.is_set():
                tune.reset_memo()
                for i in range(4):
                    ent = tune._entry_get(f"mix:w{i}k0", CPU)
                    assert ent is None or ent["plan"]["sec"] == 0.001
        except Exception as e:  # pragma: no cover
            errs.append(e)

    writers = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    for t in readers:
        t.join()
    assert not errs
    tune.reset_memo()
    assert all(tune._entry_get(f"mix:w{i}k{k}", CPU) is not None
               for i in range(4) for k in range(6))


def test_a_read_adopts_a_store_that_landed_meanwhile(monkeypatch):
    real = tune._load_file

    def stale_read():
        tune._entry_store("race:key", {"plan": _plan()}, CPU)
        return None

    monkeypatch.setattr(tune, "_load_file", stale_read)
    assert tune._entry_get("race:key", CPU) is not None
    monkeypatch.setattr(tune, "_load_file", real)
    assert tune._entry_get("race:key", CPU) is not None


# -- failure handling --------------------------------------------------------------

def test_a_deterministic_failure_becomes_a_negative_entry():
    X = _port("med")
    with faults.inject("engine.fused_t", "mosaic", times=faults.ALWAYS):
        res = _quick(X)
    assert all(p.engine != "fused_t" for p in res.plans.values())
    negs = resilience.run_report().events("tuner_negative")
    assert negs and {e["engine"] for e in negs} == {"fused_t"}
    assert all(e["failure_class"] == "deterministic" for e in negs)
    assert "neg:" in _cache_file().read_text()
    # a forced re-tune skips the negative candidates without measuring
    with faults.inject("engine.fused_t", "mosaic",
                       times=faults.ALWAYS) as spec:
        res2 = _quick(X, force=True)
    assert spec.fired == 0 and res2.skipped >= X.nmodes


@pytest.mark.parametrize("exc", [
    kernels.KernelLaunchError("splatt_fused_mttkrp_t: the card refused the "
                              "launch (cudaErrorLaunchOutOfResources = 701)"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
])
def test_an_engines_own_failure_skips_its_candidate(monkeypatch, exc):
    real = tune._measure_candidate

    def failing(layout, factors, mode, path, engine, st, **kw):
        if engine == "fused_tg":
            raise exc
        return real(layout, factors, mode, path, engine, st, **kw)

    monkeypatch.setattr(tune, "_measure_candidate", failing)
    res = _quick(_port("med"))
    assert len(res.plans) == 3
    negs = resilience.run_report().events("tuner_negative")
    assert {e["engine"] for e in negs} == {"fused_tg"}
    assert res.skipped == len(negs)


def test_a_transient_failure_is_retried_in_place():
    X = _port("med")
    with faults.inject("engine.fused_t", "http500", times=2):
        res = _quick(X, modes=[0])
    assert 0 in res.plans
    assert len(resilience.run_report().events("transient_retry")) == 2
    assert not resilience.run_report().events("tuner_negative")
    assert "neg:" not in _cache_file().read_text()


@pytest.mark.parametrize("armed", ["inject", "env"])
def test_the_tuner_measure_drill_degrades_every_mode(monkeypatch, armed):
    X = _port("med")
    if armed == "env":
        monkeypatch.setenv("SPLATT_FAULTS", "tuner.measure:runtime:*")
        faults.reset()
        res = _quick(X)
    else:
        with faults.inject("tuner.measure", "runtime", times=faults.ALWAYS):
            res = _quick(X)
    assert not res.plans and res.measured == 0
    assert _degraded(resilience) == [0, 1, 2]
    # UNKNOWN failures are never persisted; dispatch keeps the chain
    assert not _cache_file().exists()
    faults.reset()
    monkeypatch.delenv("SPLATT_FAULTS", raising=False)
    out = cpd_als(tb.BlockedSparse.compile(X, _opts(), device=CPU,
                                           rank=RANK),
                  RANK, opts=_opts(max_iterations=3), device=CPU)
    assert np.isfinite(out.fit)


def test_a_blown_deadline_is_skipped_and_never_persisted(monkeypatch):
    """A fake watchdog: the deadline blows on every fused_t measurement,
    with no wall-clock limit involved."""
    import contextlib

    real = resilience.deadline
    armed = {"engine": None}
    real_measure = tune._measure_candidate

    def measure(layout, factors, mode, path, engine, st, **kw):
        armed["engine"] = engine
        return real_measure(layout, factors, mode, path, engine, st, **kw)

    @contextlib.contextmanager
    def fake_deadline(site, seconds=None):
        if site == "tuner.measure" and armed["engine"] == "fused_t":
            yield
            resilience.run_report().add("deadline_blown", site=site,
                                        seconds=0.0)
            raise resilience.DeadlineExceeded(
                f"splatt deadline blown at {site} after 0s")
        with real(site, seconds):
            yield

    monkeypatch.setattr(tune, "_measure_candidate", measure)
    monkeypatch.setattr(resilience, "deadline", fake_deadline)
    res = _quick(_port("med"))
    assert len(res.plans) == 3
    negs = resilience.run_report().events("tuner_negative")
    assert negs and {e["engine"] for e in negs} == {"fused_t"}
    assert {e["failure_class"] for e in negs} == {"timeout"}
    assert "neg:" not in _cache_file().read_text()


@pytest.mark.parametrize("where", ["build", "load", "operand", "sticky"])
def test_a_non_engine_failure_propagates_and_writes_nothing(monkeypatch,
                                                            where):
    X = _port("med")
    _quick(X, modes=[0])
    before = _cache_file().read_bytes()
    errors = {
        "build": RuntimeError("nvcc failed on fused_mttkrp.cu: error"),
        "load": OSError("fused_mttkrp-0123.so: cannot open shared object "
                        "file"),
        "sticky": RuntimeError("CUDA error: an illegal memory access was "
                               "encountered"),
    }
    if where == "operand":
        def check(*a, **k):
            raise ValueError("factor 1 is on cuda:0, the layout on cpu")
        monkeypatch.setattr(kernels, "check_operands", check)
    else:
        def run(*a, **k):
            raise errors[where]
        monkeypatch.setattr(tm, "_run_engine", run)
    with pytest.raises((RuntimeError, OSError, ValueError)):
        _quick(X, modes=[1, 2])
    assert _cache_file().read_bytes() == before
    assert not resilience.run_report().events("tuner_negative")


def test_a_demoted_engine_is_never_a_candidate(monkeypatch):
    resilience.demote_engine("fused_t", RuntimeError("injected"))
    measured = []
    monkeypatch.setattr(
        tune, "_measure_candidate",
        lambda layout, f, m, path, engine, st, **kw:
        measured.append(engine) or 0.001)
    _quick(_port("med"))
    assert measured and "fused_t" not in measured


# -- dispatch -------------------------------------------------------------------------

def _lay_and_factors(name="med", **kw):
    X = _port(name)
    lay = tb.build_layout(X, 0, block=512, val_dtype=torch.float64,
                          device=CPU, **kw)
    facs = init_factors(X.dims, RANK, torch.Generator().manual_seed(0),
                        dtype=torch.float64)
    return X, lay, facs


def _store_port(X, m, **plan):
    tune._entry_store(tune.plan_key(X.dims, X.nnz, m, RANK, torch.float64,
                                    skew=tune.skew_of(X, m)),
                      {"plan": _plan(**plan)}, CPU)


def test_the_cached_plan_heads_the_engine_chain():
    X, lay, facs = _lay_and_factors()
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=False) == "fused_t"
    _store_port(X, 0, engine="xla", block=lay.block)
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=True) == "xla"
    out = tm.mttkrp_blocked(lay, facs, 0, "sorted_onehot", autotune=True)
    assert resilience.last_engine_attempt()[0] == "xla"
    ref = tm.mttkrp_stream(torch.from_numpy(X.inds),
                           torch.from_numpy(X.vals), facs, 0, X.dims[0])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-10)


def test_a_warm_dispatch_answers_from_the_layouts_memo(monkeypatch):
    X, lay, facs = _lay_and_factors()
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=True) == "fused_t"  # a memoized miss
    _store_port(X, 0, engine="xla", block=lay.block)  # a new generation
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=True) == "xla"
    calls = []
    real = tune.cached_plan
    monkeypatch.setattr(tune, "cached_plan",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    for _ in range(3):
        tm.mttkrp_blocked(lay, facs, 0, "sorted_onehot", autotune=True)
        assert resilience.last_engine_attempt()[0] == "xla"
    assert calls == []
    monkeypatch.setenv("SPLATT_AUTOTUNE", "0")  # the env is in the key
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot") == "fused_t"
    monkeypatch.setenv("SPLATT_AUTOTUNE", "1")
    tune.reset_memo()
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot") == "xla"
    assert len(calls) == 1


def test_an_xla_scan_plan_takes_its_scan_target(monkeypatch):
    X, lay, facs = _lay_and_factors()
    _store_port(X, 0, engine="xla_scan", block=lay.block)
    tune._entry_store(tune.plan_key(X.dims, X.nnz, 0, RANK, torch.float64,
                                    skew=tune.skew_of(X, 0)),
                      {"plan": dict(_plan(engine="xla_scan",
                                          block=lay.block),
                                    scan_target=1 << 12)}, CPU)
    targets = []
    real = tm._scan_fused

    def spy(*a, target_elems=tm.SCAN_TARGET_ELEMS, **k):
        targets.append(target_elems)
        return real(*a, target_elems=target_elems, **k)

    monkeypatch.setattr(tm, "_scan_fused", spy)
    tm.mttkrp_blocked(lay, facs, 0, "sorted_onehot", autotune=True)
    assert targets == [1 << 12]


@pytest.mark.parametrize("field,value", [
    ("block", 1024), ("path", "sorted_scatter"), ("idx", "auto"),
    ("val", "bf16"), ("packing", "balanced"), ("reorder", "hgraph")])
def test_an_inapplicable_plan_keeps_the_heuristic_chain(field, value):
    X, lay, facs = _lay_and_factors()
    plan = dict(engine="xla", block=lay.block)
    plan[field] = value
    _store_port(X, 0, **plan)
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=True) == "fused_t"


@pytest.mark.parametrize("scope", ["process", "shape"])
def test_a_demoted_plan_engine_keeps_the_heuristic_chain(scope):
    X, lay, facs = _lay_and_factors()
    _store_port(X, 0, engine="fused_tg", block=lay.block)
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=True) == "fused_tg"
    key = tm._engine_shape_key(lay, facs, 0) if scope == "shape" else None
    resilience.demote_engine("fused_tg", RuntimeError("injected"),
                             shape_key=key)
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=True) == "fused_t"
    assert tm._tuned_plan_for(lay, facs, 0, "sorted_onehot",
                              autotune=True) is None


def test_autotune_off_and_the_env_kill_switch_ignore_plans(monkeypatch):
    X, lay, facs = _lay_and_factors()
    _store_port(X, 0, engine="xla", block=lay.block)
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot",
                          autotune=False) == "fused_t"
    monkeypatch.setenv("SPLATT_AUTOTUNE", "0")
    assert tune.autotune_enabled(None) is False
    assert tune.autotune_enabled(True) is True
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot") == "fused_t"
    monkeypatch.setenv("SPLATT_AUTOTUNE", "1")
    assert tune.autotune_enabled(None) is True
    assert tune.autotune_enabled(False) is False
    assert tm.engine_plan(lay, facs, 0, "sorted_onehot") == "xla"


@pytest.mark.parametrize("autotune", [None, False])
def test_the_tuned_plan_event_rides_the_report(capsys, autotune):
    X = _port("med")
    for m in range(X.nmodes):
        _store_port(X, m, engine="xla", block=512, idx="auto")
    opts = _opts(block_alloc=BlockAlloc.ALLMODE, nnz_block=4096,
                 autotune=autotune, verbosity=Verbosity.LOW)
    bs = tb.BlockedSparse.compile(X, opts, device=CPU, rank=RANK)
    assert all((lay.block == 512) == (autotune is None)
               for lay in bs.layouts)
    cpd_als(bs, RANK, opts=opts, device=CPU)
    events = resilience.run_report().events("tuned_plan")
    printed = capsys.readouterr().out
    if autotune is None:
        assert len(events) == 1
        assert sorted(events[0]["plans"]) == [0, 1, 2]
        assert all(p["engine"] == "xla" and p["idx_width"] == "auto"
                   for p in events[0]["plans"].values())
        assert "tuned plan: mode0=sorted_onehot/xla b512" in printed
        assert "mode0=sorted_onehot/xla" in printed  # the engine plan
    else:
        assert not events and "tuned plan:" not in printed


def test_build_layout_can_leave_its_stats_out():
    X = _port("zipf")
    tb.build_layout(X, 0, block=256, device=CPU, record_stats=False)
    assert not resilience.run_report().events("layout_imbalance")
    tb.build_layout(X, 0, block=256, device=CPU)
    assert len(resilience.run_report().events("layout_imbalance")) == 1


@pytest.mark.parametrize("packing", ["fixed", "balanced"])
def test_imbalance_equals_the_reference(packing):
    J, X = _pair("zipf")
    bs = tb.BlockedSparse.from_coo(
        X, _opts(block_alloc=BlockAlloc.ALLMODE, nnz_block=256,
                 fiber_packing=packing), device=CPU)
    jbs = jb.BlockedSparse.from_coo(
        J, _jopts(block_alloc=JAlloc.ALLMODE, nnz_block=256,
                  fiber_packing=packing))
    assert bs.imbalance() == jbs.imbalance()
