"""PyTorch/CUDA port, slice 11: the C++ batch packer and the hinge loss,
against the JAX package on the CPU.

* `pharmaforge_tpu_torch.native` (a byte copy of the JAX package's
  `packer.cpp`, built with g++ into `build/pharmaforge_tpu_torch/`), run
  natively and with `PHARMAFORGE_NATIVE=0` (its numpy fallback): `pack_batch`
  and `pack_batch_gather` bit-equal to the JAX package's, overflow raising
  the same `ValueError`, and the port dataset's `pack_batch` equal to the
  collation of its `__getitem__` samples and to the JAX dataset's
  `pack_batch`, with pharmacophore subsampling on and off (the same draws
  from the same seed), as `tests/test_native.py` holds the JAX package.
* `losses.distance_hinge_loss` against the JAX function on random points,
  with and without `pos_b`, within 1e-6 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu import native as jnative
from pharmaforge_tpu.data.dataset import (
    ProteinPharmacophoreDataset as JaxDataset,
)
from pharmaforge_tpu.losses import distance_hinge_loss as jax_hinge
from pharmaforge_tpu_torch import native
from pharmaforge_tpu_torch.data.batch import collate_complexes
from pharmaforge_tpu_torch.data.dataset import ProteinPharmacophoreDataset
from pharmaforge_tpu_torch.data.synthetic import (
    make_synthetic_processed_dataset,
)
from pharmaforge_tpu_torch.losses import distance_hinge_loss

BATCH_FIELDS = ("pharm_x", "pharm_h", "pharm_mask", "prot_x", "prot_h",
                "prot_mask")


@pytest.fixture(params=["native", "numpy"])
def packer(request, monkeypatch):
    """Which packer path runs: the C++ library or, with
    PHARMAFORGE_NATIVE=0, the numpy fallback."""
    monkeypatch.setenv("PHARMAFORGE_NATIVE",
                       "1" if request.param == "native" else "0")
    return request.param


def flat_arrays(seed: int = 0, n_rows: int = 40):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_rows, 3)).astype(np.float32)
    feat = rng.integers(0, 6, n_rows).astype(np.int32)
    return pos, feat


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_native_available(packer):
    # g++ is on this host: the native path must build and load, and the
    # environment switch must reach the fallback
    assert native.native_available() == (packer == "native")
    if packer == "native":
        assert native.library_path().exists()


def test_pack_batch_matches_jax(packer):
    pos, feat = flat_arrays()
    spans = np.array([[0, 4], [4, 12], [12, 12], [12, 30]], np.int64)
    got = native.pack_batch(pos, feat, spans, 20, 6)
    assert_bit_equal(got, jnative.pack_batch(pos, feat, spans, 20, 6))
    np.testing.assert_array_equal(got[2].sum(1), [4, 8, 0, 18])
    assert (got[1].sum(-1) == got[2].astype(np.float32)).all()


def test_pack_batch_gather_matches_jax(packer):
    pos, feat = flat_arrays(1)
    idx = np.array([0, 5, 7, 2, 3, 39, 11], np.int64)
    offsets = np.array([0, 3, 5, 5, 7], np.int64)
    got = native.pack_batch_gather(pos, feat, idx, offsets, 6, 6)
    assert_bit_equal(got,
                     jnative.pack_batch_gather(pos, feat, idx, offsets, 6, 6))
    np.testing.assert_array_equal(got[2].sum(1), [3, 2, 0, 2])
    np.testing.assert_array_equal(got[0][0, :3], pos[[0, 5, 7]])


@pytest.mark.parametrize("fn", ["pack_batch", "pack_batch_gather"])
def test_overflow_raises_the_jax_error(packer, fn):
    pos, feat = flat_arrays()
    if fn == "pack_batch":
        args = (pos, feat, np.array([[0, 4], [4, 30]], np.int64), 10, 6)
    else:
        args = (pos, feat, np.arange(14, dtype=np.int64),
                np.array([0, 3, 14], np.int64), 10, 6)
    with pytest.raises(ValueError) as want:
        getattr(jnative, fn)(*args)
    with pytest.raises(ValueError) as got:
        getattr(native, fn)(*args)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_processed_dataset(
        str(tmp_path_factory.mktemp("native") / "data"), n_splits=1,
        samples_per_split=8, n_prot_range=(20, 60), seed=5)


@pytest.mark.parametrize("subsample", [False, True])
def test_dataset_pack_batch_matches_getitem_and_jax(packer, synthetic,
                                                    subsample):
    kw = dict(name="t", split_idxs=[0], raw_data_dir=str(synthetic),
              processed_data_dir=str(synthetic), graph_cutoffs={},
              prot_elements=list("CNOSPFLBIDx"), ph_type_map=list("abcdef"),
              subsample_pharms=subsample, subsample_min=4, subsample_max=8,
              seed=3)
    idxs = [0, 3, 5, 7, 1]
    packed = ProteinPharmacophoreDataset(**kw)
    batches = [packed.pack_batch(idxs, max_pharm=12, max_prot=64)
               for _ in range(2)]
    # the same draws: a second dataset from the same seed, sample by sample
    items = ProteinPharmacophoreDataset(**kw)
    for batch in batches:
        want = collate_complexes([items[i] for i in idxs], max_pharm=12,
                                 max_prot=64)
        assert_bit_equal([getattr(batch, f) for f in BATCH_FIELDS],
                         [getattr(want, f) for f in BATCH_FIELDS])
    jax_ds = JaxDataset(**kw)
    for batch in batches:
        want = jax_ds.pack_batch(idxs, max_pharm=12, max_prot=64)
        assert_bit_equal([getattr(batch, f) for f in BATCH_FIELDS],
                         [np.asarray(getattr(want, f)) for f in BATCH_FIELDS])
    if subsample:
        counts = batches[0].pharm_mask.sum(1)
        assert ((counts >= 3) & (counts <= 8)).all()


@pytest.mark.parametrize("with_b", [False, True])
def test_distance_hinge_loss_matches_jax(with_b):
    rng = np.random.default_rng(7)
    a = rng.normal(scale=2.0, size=(9, 3)).astype(np.float32)
    b = rng.normal(scale=2.0, size=(6, 3)).astype(np.float32) if with_b \
        else None
    want = float(jax_hinge(jnp.asarray(a), None if b is None
                           else jnp.asarray(b), 2.5))
    got = distance_hinge_loss(torch.as_tensor(a), None if b is None
                              else torch.as_tensor(b), 2.5)
    assert got.device.type == "cpu" and got.dim() == 0
    assert want > 0
    assert abs(float(got) - want) <= 1e-6 * abs(want)
