"""The port's .tns reader and COO tensor against the JAX package's."""

import numpy as np
import pytest

from splatt_tpu import io as jio
from splatt_tpu_torch import coo as tcoo
from splatt_tpu_torch import io as tio
from tests import gen
from tests.torch_fixtures import private_tune_cache  # noqa: F401

FIXTURES = ["small", "med", "small4", "med4", "med5"]


@pytest.mark.parametrize("name", FIXTURES + ["small4_zeroidx"])
def test_load_coord_matches(tensors_dir, name):
    path = str(tensors_dir / f"{name}.tns")
    want, got = jio.load_coord(path), tio.load_coord(path)
    assert got.dims == want.dims
    np.testing.assert_array_equal(got.inds, want.inds)
    np.testing.assert_array_equal(got.vals, want.vals)


BAD = {"ragged": "1 2 3 1.0\n1 2 2.0\n",
       "token": "1 2 3 1.0\n1 2 x 2.0\n",
       "empty": "# only a comment\n\n",
       "negative": "0 2 3 1.0\n-1 1 1 2.0\n"}


@pytest.mark.parametrize("kind", sorted(BAD))
def test_bad_files_raise_the_same_error(tmp_path, kind):
    path = tmp_path / "bad.tns"
    path.write_text(BAD[kind])
    with pytest.raises(ValueError) as want:
        jio.load_coord(str(path))
    with pytest.raises(ValueError) as got:
        tio.load_coord(str(path))
    assert str(got.value) == str(want.value)


def test_missing_file_raises(tmp_path):
    for load in (jio.load_coord, tio.load_coord):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "missing.tns"))


@pytest.mark.parametrize("name", FIXTURES)
def test_coo_transforms_match(name):
    want = gen.fixture_tensor(name)
    rng = np.random.default_rng(0)
    # repeat a fifth of the nonzeros and leave slices empty so dedup and
    # empty-slice removal have work to do
    pick = rng.integers(0, want.nnz, size=max(1, want.nnz // 5))
    inds = np.concatenate([want.inds, want.inds[:, pick]], axis=1) * 2
    vals = np.concatenate([want.vals, want.vals[pick]])
    dims = tuple(2 * d + 1 for d in want.dims)
    j = type(want)(inds, vals, dims)
    t = tcoo.SparseTensor(inds, vals, dims)
    assert t.normsq() == j.normsq()
    for m in range(j.nmodes):
        np.testing.assert_array_equal(t.mode_histogram(m),
                                      j.mode_histogram(m))
    order = list(reversed(range(j.nmodes)))
    np.testing.assert_array_equal(t.sort_order(order), j.sort_order(order))
    jd, td = j.deduplicate().remove_empty_slices(), \
        t.deduplicate().remove_empty_slices()
    assert td.dims == jd.dims
    np.testing.assert_array_equal(td.inds, jd.inds)
    np.testing.assert_array_equal(td.vals, jd.vals)
    for a, b in zip(td.indmaps, jd.indmaps):
        np.testing.assert_array_equal(a, b)
