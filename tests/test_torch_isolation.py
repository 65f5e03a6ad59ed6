"""The port stands alone: no module of it loads JAX or the JAX package
(each is imported in a fresh interpreter), and its entry points run on the
card unless the caller asks for the CPU."""

import subprocess
import sys

import pytest
import torch

from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch.blocked import BlockedSparse
from splatt_tpu_torch.config import Options
from splatt_tpu_torch.cpd import cpd_als
from tests import gen

PROBE = """
import importlib, pkgutil, sys
import splatt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(splatt_tpu_torch.__path__,
                                                "splatt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("IMPORTED", len(names), names)
if not {"splatt_tpu_torch.cli", "splatt_tpu_torch.ops.kernels",
        "splatt_tpu_torch.resilience",
        "splatt_tpu_torch.utils.faults"} <= set(names):
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
