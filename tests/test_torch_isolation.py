"""The port stands alone: no module of it loads JAX or the JAX package
(each is imported in a fresh interpreter), and its entry points, the
batched CPD's and the serve daemon's included, run on the card unless the
caller asks for the CPU."""

import subprocess
import sys

import pytest
import torch

from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch.blocked import BlockedSparse, batch_compile
from splatt_tpu_torch.config import Options
from splatt_tpu_torch.cpd import cpd_als, cpd_als_batched
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

PROBE = """
import importlib, pkgutil, sys
import splatt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(splatt_tpu_torch.__path__,
                                                "splatt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("IMPORTED", len(names), names)
if not {"splatt_tpu_torch.cli", "splatt_tpu_torch.ops.kernels",
        "splatt_tpu_torch.resilience", "splatt_tpu_torch.trace",
        "splatt_tpu_torch.utils.durable", "splatt_tpu_torch.utils.timers",
        "splatt_tpu_torch.utils.faults", "splatt_tpu_torch.tune",
        "splatt_tpu_torch.bench_algs", "splatt_tpu_torch.serve",
        "splatt_tpu_torch.predict", "splatt_tpu_torch.fleet",
        "splatt_tpu_torch.fleetobs", "splatt_tpu_torch.chaos",
        "splatt_tpu_torch.utils.lockcheck"} <= set(names):
    sys.exit(2)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "splatt_tpu")
             or m.startswith(("jax.", "jaxlib.", "splatt_tpu.")))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_no_jax_and_no_jax_package():
    r = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


ALONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "splatt_tpu")
             or m.startswith(("jax.", "jaxlib.", "splatt_tpu.")))
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("module", [
    "splatt_tpu_torch.trace", "splatt_tpu_torch.utils.timers",
    "splatt_tpu_torch.utils.durable", "splatt_tpu_torch.cpd",
    "splatt_tpu_torch.parallel.common", "splatt_tpu_torch.tune",
    "splatt_tpu_torch.bench_algs", "splatt_tpu_torch.cli",
    "splatt_tpu_torch.blocked", "splatt_tpu_torch.kruskal",
    "splatt_tpu_torch.ops.linalg", "splatt_tpu_torch.ops.mttkrp",
    "splatt_tpu_torch.serve", "splatt_tpu_torch.predict",
    "splatt_tpu_torch.fleet", "splatt_tpu_torch.fleetobs",
    "splatt_tpu_torch.chaos", "splatt_tpu_torch.utils.lockcheck",
    "splatt_tpu_torch.utils.env", "splatt_tpu_torch.resilience"])
def test_each_observability_module_imports_alone_without_jax(module):
    """The slice's new and extended modules, each imported first in a
    fresh interpreter, pull in neither JAX nor the JAX package."""
    r = subprocess.run([sys.executable, "-c", ALONE, module],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    tt = gen.fixture_tensor("small")
    X = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockedSparse.from_coo(X, Options())
    bs = BlockedSparse.from_coo(X, Options(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cpd_als(bs, 2, Options(max_iterations=1))


def test_batched_entry_points_need_a_card_unless_told_cpu():
    """batch_compile and cpd_als_batched (a list of tensors, or a batch
    built on the CPU) run on the card unless told to use the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    tt = gen.fixture_tensor("small")
    X = tcoo.SparseTensor(tt.inds, tt.vals, tt.dims)
    opts = Options(max_iterations=1, autotune=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_compile([X, X], opts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cpd_als_batched([X, X], 2, opts)
    bb = batch_compile([X, X], opts, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cpd_als_batched(bb, 2, opts)
    assert cpd_als_batched(bb, 2, opts, device="cpu").k == 2


def test_serve_entry_points_need_a_card_unless_told_cpu(tmp_path):
    """serve.Server and the serve verb run on the card unless told to use
    the CPU; the client side (file_request, read_status, predict without
    --wait) needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from splatt_tpu_torch import cli, serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.Server(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["serve", str(tmp_path), "--once"])
    assert serve.Server(str(tmp_path), device="cpu").device.type == "cpu"
    from splatt_tpu_torch.kruskal import KruskalTensor

    KruskalTensor(factors=[torch.ones(2, 1)] * 3, lam=torch.ones(1),
                  fit=0.5).save(str(tmp_path / "kt"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KruskalTensor.load(str(tmp_path / "kt"), 3)
    assert KruskalTensor.load(str(tmp_path / "kt"), 3,
                              device="cpu").dims == (2, 2, 2)
    assert cli.main(["predict", str(tmp_path), "--model", "m",
                     "--coords", "0,0,0"]) == 0
    assert serve.read_status(str(tmp_path), "nosuch")["state"] is None
