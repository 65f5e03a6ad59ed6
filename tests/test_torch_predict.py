"""The port's model store and predict math against the JAX package's, on
the same numpy inputs.

- ``reconstruct_entries``, ``top_k_slice`` and ``KruskalTensor``'s
  ``reconstruct``/``top_k``/``to_dense`` are bit for bit the JAX
  package's in f32 and f64 (host numpy on both sides); ``normsq`` agrees
  within 1e-12 relative in f64; bad inputs raise the same error types
  with the same messages;
- ``durable.append_line`` and ``ring_append`` leave the same bytes,
  torn tails and rotations included;
- a model store written by one package (``_save_checkpoint`` and
  ``advance_generation``) is served by the other's
  ``load_model_generation`` with the same factors, generation and sha,
  in the torn, ``.bak``, shredded and unstamped cases of
  tests/test_predict.py too; bf16 factors are the one divergence: the
  port hashes them widened to f32, so a bf16 model's sha is its own.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatt_tpu import predict as jpredict
from splatt_tpu import resilience as jres
from splatt_tpu.cpd import _save_checkpoint as j_save
from splatt_tpu.cpd import factor_content_sha as j_sha
from splatt_tpu.kruskal import KruskalTensor as JKruskal
from splatt_tpu.utils import durable as jdurable
from splatt_tpu.utils import faults as jfaults
from splatt_tpu_torch import predict, resilience
from splatt_tpu_torch.cpd import _save_checkpoint, factor_content_sha
from splatt_tpu_torch.kruskal import KruskalTensor
from splatt_tpu_torch.utils import durable, faults
from tests.torch_fixtures import private_tune_cache  # noqa: F401

DIMS = (12, 10, 8)
DTYPES = (np.float32, np.float64)


@pytest.fixture(autouse=True)
def _clean_state():
    def clean():
        for mod in (faults, jfaults):
            mod.reset()
        for mod in (resilience, jres):
            mod.reset_demotions()
            mod.run_report().clear()

    clean()
    yield
    clean()


def _kt(seed=0, dims=DIMS, rank=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    factors = [rng.standard_normal((d, rank)).astype(dtype) for d in dims]
    lam = rng.uniform(0.5, 2.0, rank).astype(dtype)
    return factors, lam


def _both(factors, lam):
    """The same model as a port and a JAX KruskalTensor."""
    port = KruskalTensor([torch.from_numpy(U.copy()) for U in factors],
                         torch.from_numpy(lam.copy()), 1.0)
    jax_kt = JKruskal([jnp.asarray(U) for U in factors], jnp.asarray(lam),
                      jnp.asarray(1.0))
    return port, jax_kt


COORDS = [[0, 0, 0], [3, 4, 5], [11, 9, 7], [5, 0, 2], [11, 0, 7]]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reconstruct_entries_is_bit_for_bit(dtype):
    factors, lam = _kt(seed=1, dtype=dtype)
    got = predict.reconstruct_entries(factors, lam, COORDS)
    want = jpredict.reconstruct_entries(factors, lam, COORDS)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        predict.reconstruct_entries(factors, lam, [3, 4, 5]),
        jpredict.reconstruct_entries(factors, lam, [3, 4, 5]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,fixed,k", [(0, {1: 2, 2: 1}, 4),
                                          (1, {0: 3, 2: 0}, 999),
                                          (2, {0: 11, 1: 9}, 1)])
def test_top_k_slice_is_bit_for_bit(dtype, mode, fixed, k):
    factors, lam = _kt(seed=2, dtype=dtype)
    idx, scores = predict.top_k_slice(factors, lam, fixed, mode, k)
    jidx, jscores = jpredict.top_k_slice(factors, lam, fixed, mode, k)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(scores, jscores)
    assert idx.dtype == jidx.dtype and scores.dtype == jscores.dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_kruskal_read_half_is_bit_for_bit(dtype):
    factors, lam = _kt(seed=3, dtype=dtype)
    port, jax_kt = _both(factors, lam)
    np.testing.assert_array_equal(port.to_dense(), jax_kt.to_dense())
    np.testing.assert_array_equal(port.reconstruct(COORDS),
                                  jax_kt.reconstruct(COORDS))
    for got, want in zip(port.top_k({0: 3, 2: 0}, 1, 4),
                         jax_kt.top_k({0: 3, 2: 0}, 1, 4)):
        np.testing.assert_array_equal(got, want)


def test_kruskal_normsq_f64():
    factors, lam = _kt(seed=4, dtype=np.float64)
    port, jax_kt = _both(factors, lam)
    got = port.normsq()
    want = float(jax_kt.normsq())
    assert got.dtype == torch.float64 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-12 * abs(want)
    # against the dense tensor's squared norm
    assert abs(want - float((port.to_dense() ** 2).sum())) <= 1e-10 * want


def test_kruskal_normsq_bf16_accumulates_in_f32():
    factors, lam = _kt(seed=5, dtype=np.float32)
    port = KruskalTensor([torch.from_numpy(U).to(torch.bfloat16)
                          for U in factors], torch.from_numpy(lam), 1.0)
    got = port.normsq()
    assert got.dtype == torch.float32
    wide = KruskalTensor([U.float() for U in port.factors], port.lam, 1.0)
    assert float(got) == pytest.approx(float(wide.normsq()), rel=1e-6)


def test_kruskal_load_reads_the_jax_packages_files(tmp_path):
    factors, lam = _kt(seed=6)
    _, jax_kt = _both(factors, lam)
    jax_kt.save(str(tmp_path), stem="m.")
    got = KruskalTensor.load(str(tmp_path), 3, stem="m.", device="cpu")
    want = JKruskal.load(str(tmp_path), 3, stem="m.")
    for U, W in zip(got.factors, want.factors):
        np.testing.assert_array_equal(U.numpy(), np.asarray(W))
    np.testing.assert_array_equal(got.lam.numpy(), np.asarray(want.lam))
    assert np.isnan(got.fit) and np.isnan(float(want.fit))


BAD_INPUTS = [
    ("reconstruct", dict(coords=[[0, 0]])),
    ("reconstruct", dict(coords=[[0, 0, 99]])),
    ("reconstruct", dict(coords=[[-1, 0, 0]])),
    ("top_k", dict(fixed={1: 0}, mode=0, k=2)),
    ("top_k", dict(fixed={0: 0, 1: 0, 2: 0}, mode=0, k=2)),
    ("top_k", dict(fixed={1: 99, 2: 0}, mode=0, k=2)),
    ("top_k", dict(fixed={}, mode=7, k=2)),
]


@pytest.mark.parametrize("fn,kw", BAD_INPUTS)
def test_bad_input_raises_what_the_jax_package_raises(fn, kw):
    factors, lam = _kt()

    def call(mod):
        if fn == "reconstruct":
            return mod.reconstruct_entries(factors, lam, **kw)
        return mod.top_k_slice(factors, lam, **kw)

    with pytest.raises(Exception) as got:
        call(predict)
    with pytest.raises(Exception) as want:
        call(jpredict)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


# -- durable appends ---------------------------------------------------------

def test_append_line_bytes_match_with_a_torn_tail(tmp_path):
    paths = {}
    for name, mod in (("port", durable), ("jax", jdurable)):
        p = str(tmp_path / f"{name}.jsonl")
        mod.append_line(p, b'{"rec": "accepted", "job": "a"}')
        mod.append_line(p, b'{"rec": "started", "job": "a"}\n')
        with open(p, "ab") as f:
            f.write(b'{"rec": "do')   # a writer killed mid-line
        mod.append_line(p, b'{"rec": "resumed", "job": "a"}')
        mod.append_line(p, b"")
        paths[name] = p
    with open(paths["port"], "rb") as f:
        got = f.read()
    with open(paths["jax"], "rb") as f:
        want = f.read()
    assert got == want
    assert got.endswith(b'{"rec": "do\n{"rec": "resumed", "job": "a"}\n\n')


def test_ring_append_bytes_and_rotation_match(tmp_path):
    sizes = {}
    for name, mod in (("port", durable), ("jax", jdurable)):
        p = str(tmp_path / f"{name}.ring")
        sizes[name] = [mod.ring_append(p, [b"x" * n, b"y\n"], 64)
                       for n in (5, 17, 30, 3, 40, 1)]
    assert sizes["port"] == sizes["jax"]
    assert 0 in sizes["port"]   # a rotation happened
    for suffix in ("", ".1"):
        with open(str(tmp_path / f"port.ring{suffix}"), "rb") as f:
            got = f.read()
        with open(str(tmp_path / f"jax.ring{suffix}"), "rb") as f:
            want = f.read()
        assert got == want


# -- the model store, both ways ---------------------------------------------

WRITERS = {
    "jax": (j_save, jpredict.advance_generation),
    "port": (_save_checkpoint, predict.advance_generation),
}
READERS = {"jax": jpredict.load_model_generation,
           "port": predict.load_model_generation}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _commit(writer, d, factors, lam, fit=0.9):
    save, advance = WRITERS[writer]
    save(os.path.join(d, "m.npz"), factors, lam, 0, fit)
    return advance(d, "m", factors, lam)


def _assert_serves(out, factors, lam, gen):
    assert out is not None and out["gen"] == gen
    assert out["sha"] == j_sha(factors, lam)
    for U, W in zip(out["factors"], factors):
        np.testing.assert_array_equal(np.asarray(U), W)
    np.testing.assert_array_equal(np.asarray(out["lam"]), lam)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_store_crosses_intact(tmp_path, writer, reader, dtype):
    d = str(tmp_path)
    f1, l1 = _kt(seed=2, dtype=dtype)
    assert _commit(writer, d, f1, l1) == 1
    assert factor_content_sha(f1, l1) == j_sha(f1, l1)
    out = READERS[reader](d, "m")
    _assert_serves(out, f1, l1, 1)
    assert out["factors"][0].dtype == dtype


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_store_crosses_torn_commit_serves_bak(tmp_path, writer, reader):
    d = str(tmp_path)
    f1, l1 = _kt(seed=2)
    f2, l2 = _kt(seed=3)
    _commit(writer, d, f1, l1)
    # the new factors landed, the stamp still names generation 1: the
    # .bak checkpoint is what it verifies
    WRITERS[writer][0](os.path.join(d, "m.npz"), f2, l2, 0, 0.9)
    _assert_serves(READERS[reader](d, "m"), f1, l1, 1)
    events = (resilience if reader == "port" else jres).run_report()
    assert [e["piece"] for e in events.events("model_torn")] == [
        "checkpoint-vs-stamp"]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_store_crosses_shredded_checkpoint_falls_back(tmp_path, writer,
                                                      reader):
    d = str(tmp_path)
    f1, l1 = _kt(seed=2)
    f2, l2 = _kt(seed=3)
    _commit(writer, d, f1, l1)
    assert _commit(writer, d, f2, l2, fit=0.95) == 2
    _assert_serves(READERS[reader](d, "m"), f2, l2, 2)
    with open(os.path.join(d, "m.npz"), "wb") as f:
        f.write(b"shredded")
    _assert_serves(READERS[reader](d, "m"), f1, l1, 1)
    os.remove(os.path.join(d, "m.npz.bak"))
    assert READERS[reader](d, "m") is None


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_store_crosses_unstamped_refuses(tmp_path, writer, reader):
    d = str(tmp_path)
    f1, l1 = _kt(seed=2)
    WRITERS[writer][0](os.path.join(d, "m.npz"), f1, l1, 0, 0.9)
    assert READERS[reader](d, "m") is None
    events = (resilience if reader == "port" else jres).run_report()
    assert events.events("model_torn")[-1]["piece"] == "no-generation-stamp"


@pytest.mark.parametrize("first,second", DIRECTIONS)
def test_generations_advance_across_packages(tmp_path, first, second):
    """Commits by both packages share one stamp sequence: a bit-identical
    re-commit by the other package does not advance it."""
    d = str(tmp_path)
    f1, l1 = _kt(seed=2, dtype=np.float32)
    f2, l2 = _kt(seed=3, dtype=np.float32)
    assert _commit(first, d, f1, l1) == 1
    assert WRITERS[second][1](d, "m", f1, l1) == 1
    assert _commit(second, d, f2, l2) == 2
    assert predict.current_generation(d, "m") == \
        jpredict.current_generation(d, "m") == 2
    bak = predict.read_stamp(predict.stamp_path(d, "m") + ".bak")
    assert bak == jpredict.read_stamp(jpredict.stamp_path(d, "m") + ".bak")
    assert bak["gen"] == 1 and bak["sha"] == j_sha(f1, l1)
    for reader in READERS.values():
        _assert_serves(reader(d, "m"), f2, l2, 2)


def test_port_commits_torch_tensors_the_jax_package_serves(tmp_path):
    """The serve daemon commits the CPD's tensors, not numpy arrays."""
    d = str(tmp_path)
    f1, l1 = _kt(seed=7, dtype=np.float32)
    _commit("port", d, [torch.from_numpy(U) for U in f1],
            torch.from_numpy(l1))
    _assert_serves(jpredict.load_model_generation(d, "m"), f1, l1, 1)


def test_bf16_stamps_are_the_ports_own(tmp_path):
    """The port widens bf16 factors to f32 before hashing and
    checkpointing; the JAX package hashes ml_dtypes' bfloat16 bytes."""
    f1, l1 = _kt(seed=8, dtype=np.float32)
    t16 = [torch.from_numpy(U).to(torch.bfloat16) for U in f1]
    widened = [U.float().numpy() for U in t16]
    sha = factor_content_sha(t16, torch.from_numpy(l1))
    assert sha == j_sha(widened, l1)
    assert sha != j_sha([jnp.asarray(U, dtype=jnp.bfloat16) for U in f1],
                        l1)
    d = str(tmp_path)
    _commit("port", d, t16, torch.from_numpy(l1))
    out = predict.load_model_generation(d, "m")
    assert out["sha"] == sha and out["factors"][0].dtype == np.float32


def test_generation_fault_aborts_the_advance(tmp_path):
    d = str(tmp_path)
    f1, l1 = _kt(seed=2)
    f2, l2 = _kt(seed=3)
    assert _commit("port", d, f1, l1) == 1
    with faults.inject("model.generation", "runtime"):
        with pytest.raises(RuntimeError):
            predict.advance_generation(d, "m", f2, l2)
    assert predict.current_generation(d, "m") == 1
    assert [e["gen"] for e in resilience.run_report().events(
        "model_generation_advanced")] == [1]


def test_predict_read_fault_and_garbage_stamp(tmp_path):
    d = str(tmp_path)
    f1, l1 = _kt(seed=2)
    _commit("port", d, f1, l1)
    with faults.inject("predict.read", "runtime"):
        with pytest.raises(RuntimeError):
            predict.load_model_generation(d, "m")
    assert predict.load_model_generation(d, "m")["gen"] == 1
    spath = str(tmp_path / "x.gen.json")
    with open(spath, "w") as f:
        f.write("{not json")
    assert predict.read_stamp(spath) is None is jpredict.read_stamp(spath)
    assert resilience.run_report().events("model_torn")[0]["piece"] == \
        "generation-stamp"


def test_hot_factor_cache_is_lru_by_generation_and_faultable():
    cache = predict.HotFactorCache(2)
    jcache = jpredict.HotFactorCache(2)
    for c in (cache, jcache):
        c.put("m", 1, {"gen": 1})
        c.put("m", 2, {"gen": 2})
        assert c.get("m", 1) == {"gen": 1}   # 1 is now the newest
        c.put("m", 3, {"gen": 3})            # evicts 2
        assert c.get("m", 2) is None and len(c) == 2
    with faults.inject("predict.cache", "runtime"):
        with pytest.raises(RuntimeError):
            cache.get("m", 1)
    off = predict.HotFactorCache(0)
    off.put("m", 1, {"gen": 1})
    assert off.get("m", 1) is None and len(off) == 0
