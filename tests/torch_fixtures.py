"""Fixtures every test of the PyTorch port shares.

Dispatch and ``BlockedSparse.compile`` read the autotuner's plan cache
(SPLATT_AUTOTUNE defaults to on), whose default file lives in the port's
build directory and outlives a run of ``splatt tune``.  A test module that
imports :func:`private_tune_cache` runs each test against an empty cache
file of its own, so plans left there never change the engine plans,
layouts or launch counts the tests assert.
"""

import pytest

from splatt_tpu_torch import tune


@pytest.fixture(autouse=True)
def private_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SPLATT_TUNE_CACHE", str(tmp_path / "tune_cache.json"))
    tune.reset_memo()
    yield
    tune.reset_memo()
