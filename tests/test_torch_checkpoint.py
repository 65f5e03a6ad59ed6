"""Checkpoints of the port's single-card and distributed CPDs against the
JAX package's, on the CPU: the two packages load each other's files
(digests verified both ways), a resume equals the JAX package's resume
from the same file, a stopped and resumed run equals the uninterrupted
one, torn files degrade to the ``.bak`` generation, and the distributed
drivers (FINE, MEDIUM on a grid that splits two axes, COARSE, 4 virtual
CPU ranks) checkpoint, resume, roll back and degrade as the JAX package's
do (≙ tests/test_guarded.py, tests/test_sharded.py).

f64 throughout: single-card fits within 1e-9 and factors and λ within
1e-8; distributed runs within the tolerances of
``tests/test_torch_decomp.py`` (fit 1e-8, factors and λ 1e-6).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import cpd as jcpd
from splatt_tpu import resilience as jres
from splatt_tpu.blocked import BlockedSparse as JBlocked
from splatt_tpu.config import Decomposition as JDecomp
from splatt_tpu.config import Options as JOptions
from splatt_tpu.config import Verbosity as JVerbosity
from splatt_tpu.parallel import distributed_cpd_als as jax_distributed
from splatt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import resilience
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import Decomposition, Options, Verbosity
from splatt_tpu_torch.cpd import (CheckpointError, cpd_als, load_checkpoint,
                                  load_checkpoint_resilient)
from splatt_tpu_torch.parallel import distributed_cpd_als
from splatt_tpu_torch.parallel.mesh import make_mesh
from splatt_tpu_torch.utils import faults
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

RANK = 4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("SPLATT_HEALTH_RETRIES", raising=False)

    def reset():
        for mod in (faults, jfaults):
            mod.reset()
        for mod in (resilience, jres):
            mod.reset_demotions()
            mod.run_report().clear()
    reset()
    yield
    reset()


def _tensor(name="med"):
    tt = gen.fixture_tensor(name)
    return tt, tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)


def _init(dims, rank=RANK, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.random((d, rank)) for d in dims]


def _opts(**kw):
    base = dict(max_iterations=6, tolerance=0.0, val_dtype=torch.float64,
                verbosity=Verbosity.NONE, random_seed=1, nnz_block=256)
    base.update(kw)
    return Options(**base)


def _jopts(**kw):
    base = dict(max_iterations=6, tolerance=0.0, val_dtype=np.float64,
                verbosity=JVerbosity.NONE, random_seed=1, nnz_block=256,
                autotune=False)
    base.update(kw)
    return JOptions(**base)


def _port(tt, opts, init, bs=None, **kw):
    bs = bs or BlockedSparse.from_coo(tt, opts, device="cpu")
    return cpd_als(bs, RANK, opts, init=init, device="cpu", **kw)


def _jax(jt, jopts, init, **kw):
    return jcpd.cpd_als(JBlocked.from_coo(jt, jopts), RANK, jopts,
                        init=None if init is None
                        else [jnp.asarray(u) for u in init], **kw)


def _same(got, want, fit_tol=1e-9, tol=1e-8):
    assert float(got.fit) == pytest.approx(float(want.fit), abs=fit_tol)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(want.lam),
                               atol=tol, rtol=0)
    for g, w in zip(got.factors, want.factors):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol,
                                   rtol=0)


# -- the file format, both ways ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_port_checkpoint_verifies_in_the_jax_loader(tmp_path, dtype):
    _, tt = _tensor()
    ck = str(tmp_path / "p.npz")
    out = _port(tt, _opts(max_iterations=4, val_dtype=dtype),
                _init(tt.dims), checkpoint_path=ck, checkpoint_every=2)
    f, lam, it, fit = jcpd.load_checkpoint(ck)  # digest verified
    pf, plam, pit, pfit = load_checkpoint(ck)
    assert it == pit == 4 and fit == pfit == pytest.approx(out.fit)
    assert np.asarray(f[0]).dtype == pf[0].numpy().dtype
    assert pf[0].dtype == dtype and plam.dtype == dtype
    for a, b in zip(f, pf):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(lam), plam.numpy())
    with np.load(ck) as z:
        assert set(z.files) == {"schema", "checksum", "reorder", "nmodes",
                                "it", "fit", "lam", "dims", "rank",
                                "factor0", "factor1", "factor2"}
        assert str(z["reorder"]) == "identity" and int(z["schema"]) == 2
    assert os.path.exists(ck + ".bak")  # the iteration-2 generation


def test_jax_checkpoint_verifies_in_the_port_loader(tmp_path):
    jt, _ = _tensor()
    ck = str(tmp_path / "j.npz")
    _jax(jt, _jopts(max_iterations=4), _init(jt.dims), checkpoint_path=ck,
         checkpoint_every=2)
    f, lam, it, fit = load_checkpoint(ck)
    jf, jlam, jit, jfit = jcpd.load_checkpoint(ck)
    assert it == jit == 4 and fit == jfit
    for a, b in zip(f, jf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_corrupt_file_fails_its_digest_in_both_loaders(tmp_path, writer):
    jt, tt = _tensor()
    ck = str(tmp_path / "c.npz")
    if writer == "jax":
        _jax(jt, _jopts(max_iterations=2), _init(jt.dims),
             checkpoint_path=ck, checkpoint_every=2)
    else:
        _port(tt, _opts(max_iterations=2), _init(tt.dims),
              checkpoint_path=ck, checkpoint_every=2)
    with np.load(ck) as z:
        data = {k: z[k] for k in z.files}
    data["factor1"] = data["factor1"].copy()
    data["factor1"][0, 0] += 1.0
    np.savez(ck, **data)
    with pytest.raises(CheckpointError, match="checksum"):
        load_checkpoint(ck)
    with pytest.raises(jcpd.CheckpointError, match="checksum"):
        jcpd.load_checkpoint(ck)
    assert load_checkpoint(ck, verify=False)[2] == 2


# -- resume ------------------------------------------------------------------


def test_port_resumed_from_a_jax_checkpoint_equals_jax_resumed(tmp_path):
    import shutil

    jt, tt = _tensor()
    ck, ck2 = str(tmp_path / "j.npz"), str(tmp_path / "j2.npz")
    _jax(jt, _jopts(max_iterations=3), _init(jt.dims), checkpoint_path=ck,
         checkpoint_every=3)
    shutil.copy(ck, ck2)
    want = _jax(jt, _jopts(), None, checkpoint_path=ck)
    got = _port(tt, _opts(), None, checkpoint_path=ck2)
    _same(got, want)
    assert list(got.fit_iters) == [4, 5, 6]


def test_stopped_and_resumed_equals_uninterrupted(tmp_path):
    _, tt = _tensor()
    init = _init(tt.dims)
    whole = _port(tt, _opts(), init)
    ck = str(tmp_path / "s.npz")
    seen = []

    def stop():
        seen.append(1)
        return len(seen) == 4

    first = _port(tt, _opts(), init, checkpoint_path=ck,
                  checkpoint_every=2, stop=stop)
    assert list(first.fit_iters) == [1, 2, 3, 4]
    assert load_checkpoint(ck)[2] == 4
    rest = _port(tt, _opts(), None, checkpoint_path=ck, checkpoint_every=2)
    assert list(rest.fit_iters) == [5, 6]
    np.testing.assert_allclose(first.fits + rest.fits, whole.fits,
                               atol=1e-12, rtol=0)
    _same(rest, whole, fit_tol=1e-12, tol=1e-12)


def test_resume_past_the_end_returns_the_checkpointed_state(tmp_path):
    _, tt = _tensor()
    ck = str(tmp_path / "e.npz")
    a = _port(tt, _opts(max_iterations=4), _init(tt.dims),
              checkpoint_path=ck, checkpoint_every=2)
    b = _port(tt, _opts(max_iterations=4), None, checkpoint_path=ck)
    assert b.fits == () and b.fit == pytest.approx(a.fit, abs=1e-12)
    _same(b, a, fit_tol=1e-12, tol=1e-12)


def test_torn_write_degrades_to_the_bak_generation(tmp_path, capsys):
    _, tt = _tensor()
    init = _init(tt.dims)
    ck = str(tmp_path / "t.npz")
    with faults.inject("checkpoint_torn", times=1, iter_at=2):
        _port(tt, _opts(max_iterations=4), init, checkpoint_path=ck,
              checkpoint_every=2)
    with pytest.raises(CheckpointError):
        load_checkpoint(ck)
    out = load_checkpoint_resilient(ck)
    assert out is not None and out[2] == 2  # the .bak generation
    ev = resilience.run_report().events("checkpoint_recovery")
    assert len(ev) == 1 and "previous generation" in ev[0]["action"]
    assert "resumed from the previous generation" in capsys.readouterr().err
    resumed = _port(tt, _opts(max_iterations=4), None, checkpoint_path=ck)
    assert list(resumed.fit_iters) == [3, 4]


def test_no_usable_generation_starts_fresh(tmp_path):
    _, tt = _tensor()
    ck = str(tmp_path / "n.npz")
    for p in (ck, ck + ".bak"):
        with open(p, "wb") as f:
            f.write(b"not a checkpoint")
    out = _port(tt, _opts(max_iterations=2), _init(tt.dims),
                checkpoint_path=ck, checkpoint_every=2)
    assert list(out.fit_iters) == [1, 2]
    ev = resilience.run_report().events("checkpoint_recovery")
    assert ev and "starting fresh" in ev[-1]["action"]
    assert load_checkpoint(ck)[2] == 2


def test_bak_only_directory_still_resumes(tmp_path):
    _, tt = _tensor()
    ck = str(tmp_path / "b.npz")
    _port(tt, _opts(max_iterations=2), _init(tt.dims), checkpoint_path=ck,
          checkpoint_every=2)
    os.replace(ck, ck + ".bak")
    out = _port(tt, _opts(max_iterations=4), None, checkpoint_path=ck,
                checkpoint_every=2)
    assert list(out.fit_iters) == [3, 4]


def test_mismatches_and_bad_arguments_raise(tmp_path):
    _, tt = _tensor()
    ck = str(tmp_path / "m.npz")
    _port(tt, _opts(max_iterations=2), _init(tt.dims), checkpoint_path=ck,
          checkpoint_every=2)
    bs = BlockedSparse.from_coo(tt, _opts(), device="cpu")
    with pytest.raises(ValueError, match="rank=3"):
        cpd_als(bs, 3, _opts(), device="cpu", checkpoint_path=ck)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _port(tt, _opts(), None, checkpoint_path=ck, checkpoint_every=0)
    with pytest.raises(CheckpointError, match="reorder"):
        load_checkpoint(ck, expect_reorder="hgraph")
    with faults.inject("checkpoint_write"):
        with pytest.raises(RuntimeError, match="checkpoint_write"):
            _port(tt, _opts(max_iterations=2), _init(tt.dims),
                  checkpoint_path=str(tmp_path / "w.npz"),
                  checkpoint_every=2)
    assert not os.path.exists(tmp_path / "w.npz")


def test_reordered_run_checkpoints_relabeled_factors(tmp_path):
    _, tt = _tensor()
    init = _init(tt.dims)
    opts = _opts(reorder="random")
    bs = BlockedSparse.compile(tt, opts, device="cpu")
    assert bs.reorder == "random"
    whole = _port(tt, opts, init, bs=bs)
    ck = str(tmp_path / "r.npz")
    first = _port(tt, _opts(reorder="random", max_iterations=3), init, bs=bs,
                  checkpoint_path=ck, checkpoint_every=3)
    f, _, it, _ = load_checkpoint(ck, expect_reorder="random")
    assert it == 3
    with np.load(ck) as z:
        assert str(z["reorder"]) == "random"
    # relabeled space: the checkpoint's factor is the output's, permuted
    for m in range(3):
        np.testing.assert_allclose(
            bs.perm.undo_factors(f)[m].numpy()
            / np.linalg.norm(f[m].numpy(), axis=0),
            first.factors[m].numpy(), atol=1e-12)
    rest = _port(tt, opts, None, bs=bs, checkpoint_path=ck)
    _same(rest, whole, fit_tol=1e-12, tol=1e-12)
    # another row space refuses the file: the run starts fresh
    plain = BlockedSparse.from_coo(tt, _opts(), device="cpu")
    out = cpd_als(plain, RANK, _opts(max_iterations=1), init=init,
                  device="cpu", checkpoint_path=ck, checkpoint_every=5)
    assert list(out.fit_iters) == [1]
    assert "reorder" in resilience.run_report().events(
        "checkpoint_recovery")[-1]["error"]


# -- distributed -------------------------------------------------------------

DECOMPS = {
    "fine": dict(decomp=Decomposition.FINE, grid=None),
    "medium": dict(decomp=Decomposition.MEDIUM, grid=(2, 2, 1)),
    "coarse": dict(decomp=Decomposition.COARSE, grid=None),
}


def _dist(tt, kind, init, iters=6, **kw):
    d = DECOMPS[kind]
    return distributed_cpd_als(
        tt, RANK, opts=_opts(max_iterations=iters, decomposition=d["decomp"]),
        init=init, grid=d["grid"], mesh=make_mesh(n_devices=4, device="cpu"),
        local_engine="blocked", **kw)


def _jdist(jt, kind, init, iters=6, **kw):
    d = DECOMPS[kind]
    axis = ("d",) if kind == "coarse" else ("nnz",)
    mesh = None if d["grid"] else jax_make_mesh(n_devices=4,
                                                axis_names=axis)
    return jax_distributed(
        jt, RANK, opts=_jopts(max_iterations=iters,
                              decomposition=JDecomp(d["decomp"].value)),
        init=[jnp.asarray(u) for u in init], grid=d["grid"], mesh=mesh,
        local_engine="blocked", **kw)


@pytest.mark.parametrize("kind", ["fine", "medium", "coarse"])
def test_distributed_stop_resume_equals_uninterrupted_and_jax(tmp_path,
                                                              kind):
    jt, tt = _tensor()
    init = _init(tt.dims)
    whole = _dist(tt, kind, init)
    ck = str(tmp_path / f"{kind}.npz")
    first = _dist(tt, kind, init, iters=4, checkpoint_path=ck,
                  checkpoint_every=2)
    assert load_checkpoint(ck)[2] == 4
    rest = _dist(tt, kind, init, checkpoint_path=ck, checkpoint_every=2)
    assert list(rest.fit_iters) == [5, 6]
    np.testing.assert_allclose(first.fits + rest.fits, whole.fits,
                               atol=1e-12, rtol=0)
    _same(rest, whole, fit_tol=1e-12, tol=1e-10)
    _same(whole, _jdist(jt, kind, init), fit_tol=1e-8, tol=1e-6)


@pytest.mark.parametrize("kind", ["fine", "medium"])
def test_distributed_and_single_card_checkpoints_interchange(tmp_path,
                                                             kind):
    _, tt = _tensor()
    init = _init(tt.dims)
    single = _port(tt, _opts(), init)
    ck = str(tmp_path / "x.npz")
    _dist(tt, kind, init, iters=3, checkpoint_path=ck, checkpoint_every=3)
    from_dist = _port(tt, _opts(), None, checkpoint_path=ck)
    _same(from_dist, single, fit_tol=1e-9, tol=1e-7)
    ck2 = str(tmp_path / "y.npz")
    _port(tt, _opts(max_iterations=3), init, checkpoint_path=ck2,
          checkpoint_every=3)
    from_single = _dist(tt, kind, None, checkpoint_path=ck2)
    _same(from_single, single, fit_tol=1e-9, tol=1e-7)


@pytest.mark.parametrize("kind", ["fine", "medium", "coarse"])
def test_distributed_rollback_redraws_as_jax_does(monkeypatch, kind):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "2")
    jt, tt = _tensor()
    init = _init(tt.dims)
    with faults.inject("cpd.sweep", "nan", iter_at=3):
        got = _dist(tt, kind, init)
    with jfaults.inject("cpd.sweep", "nan", iter_at=3):
        want = _jdist(jt, kind, init)
    keys = ("kind", "iteration", "attempt", "regularization", "rerandomized")
    ev = [{k: v for k, v in e.items() if k in keys}
          for e in resilience.run_report().events()
          if e["kind"].startswith("health_")]
    assert ev == [{k: v for k, v in e.items() if k in keys}
                  for e in jres.run_report().events()
                  if e["kind"].startswith("health_")]
    assert [e["kind"] for e in ev] == ["health_nonfinite", "health_rollback"]
    assert ev[1]["rerandomized"] == [2] and ev[1]["regularization"] is None
    _same(got, want, fit_tol=1e-8, tol=1e-6)


def test_distributed_rollback_carries_a_due_save(monkeypatch, tmp_path):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "2")
    _, tt = _tensor()
    ck = str(tmp_path / "c.npz")
    with faults.inject("cpd.sweep", "nan", iter_at=2):
        _dist(tt, "fine", _init(tt.dims), iters=3, checkpoint_path=ck,
              checkpoint_every=2)
    assert load_checkpoint(ck)[2] == 3


def test_distributed_degrade_on_an_exhausted_budget(monkeypatch, tmp_path):
    monkeypatch.setenv("SPLATT_HEALTH_RETRIES", "1")
    _, tt = _tensor()
    ck = str(tmp_path / "d.npz")
    with faults.inject("cpd.sweep", "nan", times=faults.ALWAYS):
        out = _dist(tt, "fine", _init(tt.dims), checkpoint_path=ck,
                    checkpoint_every=2)
    kinds = [e["kind"] for e in resilience.run_report().events()
             if e["kind"].startswith("health_")]
    assert kinds == ["health_nonfinite", "health_rollback",
                     "health_nonfinite", "health_degraded"]
    assert all(np.isfinite(u.numpy()).all() for u in out.factors)
    f, _, it, _ = load_checkpoint(ck)
    assert it == 0
    np.testing.assert_allclose(f[0].numpy(), _init(tt.dims)[0], atol=1e-12)
