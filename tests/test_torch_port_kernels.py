"""PyTorch/CUDA port, kernel module: `pharmaforge_tpu_torch.ops.knn_select`.

On the CPU the port's plain version is held against the JAX package's
plain version and its Pallas kernel run in interpret mode: indices,
validity and gathered coordinates equal, distances within rtol 1e-6 (the
JAX kernel test's tolerance). The CUDA kernel itself runs only on a card:
its tests are in tests/test_torch_port_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.ops.pallas.knn_select import (
    knn_select as jax_knn_select,
    knn_select_reference as jax_knn_reference,
)
from pharmaforge_tpu_torch.ops import _build
from pharmaforge_tpu_torch.ops import knn_select as ks
from pharmaforge_tpu_torch.utils import trace

BIG = 1e30


def make_inputs(rng, b=4, f=8, p=64, ties=False):
    pharm_x = rng.normal(scale=3.0, size=(b, f, 3)).astype(np.float32)
    prot_x = rng.normal(scale=6.0, size=(b, p, 3)).astype(np.float32)
    pharm_mask = np.ones((b, f), bool)
    prot_mask = np.ones((b, p), bool)
    pharm_mask[0, 5:] = False
    prot_mask[1, 50:] = False
    prot_mask[2, 3:] = False          # fewer valid atoms than k
    if ties:
        prot_x[0, 7] = prot_x[0, 3]   # exact duplicate coordinates
        prot_x[3, 20] = prot_x[3, 11]
        prot_x[3, 40] = prot_x[3, 11]
        pharm_mask[1, :] = False      # a masked-out pharm row
    return pharm_x, pharm_mask, prot_x, prot_mask


def port(args, k):
    idx, dist, xg = ks.knn_select_reference(
        *(torch.from_numpy(a) for a in args), k)
    return idx.numpy(), dist.numpy(), xg.numpy()


def assert_same_selection(got, want):
    idx_g, d_g, xg_g = got
    idx_w, d_w, xg_w = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(idx_g, idx_w)
    np.testing.assert_array_equal(d_g < BIG, d_w < BIG)
    np.testing.assert_array_equal(xg_g, xg_w)
    np.testing.assert_allclose(d_g, d_w, rtol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_plain_matches_jax_reference(rng, k, ties):
    args = make_inputs(rng, ties=ties)
    assert_same_selection(port(args, k), jax_knn_reference(
        *(jnp.asarray(a) for a in args), k))


@pytest.mark.parametrize("k", [1, 5, 8])
def test_plain_matches_interpreted_pallas_kernel(rng, k):
    args = make_inputs(rng, ties=True)
    assert_same_selection(port(args, k), jax_knn_select(
        *(jnp.asarray(a) for a in args), k, interpret=True))


def test_plain_odd_batch_and_k_above_p(rng):
    args = make_inputs(rng, b=3, p=6)
    got = port(args, 9)           # k clamps to P, as the JAX kernel does
    assert got[0].shape == (3, 8, 6)
    assert_same_selection(got, jax_knn_select(
        *(jnp.asarray(a) for a in args), 9, interpret=True))


def test_exhausted_passes_walk_invalid_slots_in_index_order(rng):
    args = make_inputs(rng)
    idx, dist, _ = port(args, 5)
    # row 2 has 3 valid atoms: passes 4 and 5 take slots 0.. of the rest
    valid_sel = idx[2, 0, :3]
    assert sorted(valid_sel) == [0, 1, 2]
    np.testing.assert_array_equal(idx[2, 0, 3:], [3, 4])
    assert (dist[2, 0, 3:] == np.float32(BIG)).all()
    # a masked pharm row selects 0..k-1, all invalid
    np.testing.assert_array_equal(idx[0, 6], [0, 1, 2, 3, 4])
    assert (dist[0, 6] == np.float32(BIG)).all()


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing(rng):
    args = [torch.from_numpy(a) for a in make_inputs(rng, ties=True)]
    before = trace.counters()["knn_select.launches"]
    got = ks.knn_select(*args, 5)
    want = ks.knn_select_reference(*args, 5)
    assert trace.counters()["knn_select.launches"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int32


def test_wrapper_refuses_other_devices(rng):
    args = [torch.from_numpy(a).to("meta") for a in make_inputs(rng)]
    with pytest.raises(ValueError, match="unsupported device"):
        ks.knn_select(*args, 5)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if (_build.Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("knn_select")


def test_build_is_keyed_on_source_and_flags():
    path = _build.library_path("knn_select")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("knn_select-") and path.suffix == ".so"
    assert path == _build.library_path("knn_select")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    # per-kernel flags: K1 is held bit-equal and builds without multiply-add
    # contraction; K2 is held to a tolerance and keeps it
    assert "--fmad=false" in _build.nvcc_flags("knn_select")
    assert "--fmad=false" not in _build.nvcc_flags("pp_message")
    assert _build.library_path("pp_message").name.startswith("pp_message-")

