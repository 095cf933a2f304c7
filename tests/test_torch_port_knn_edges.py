"""PyTorch/CUDA port, the pf/fp edges of one denoiser call:
`pharmaforge_tpu_torch.ops.knn_select.knn_pf_edges` and the pf branch of
`models/edges.py::build_edge_bundle`.

On the CPU the plain version `knn_pf_edges_reference` is held against the
JAX package's `knn_select_reference` followed by its
`models/edges.py::_pair_geometry`: indices and validity bit-equal, the
directions and RBF within 1e-6 (the port's geometry tolerance,
tests/test_torch_port_modules.py). The inputs hold exact duplicate
coordinates, a masked pharm row and a batch row with fewer valid atoms
than k. The kernel itself runs only on a card: its tests are in
tests/test_torch_port_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pharmaforge_tpu.models import edges as jedges
from pharmaforge_tpu.ops.pallas.knn_select import (
    knn_select_reference as jax_knn_reference,
)
from pharmaforge_tpu_torch.models import edges as tedges
from pharmaforge_tpu_torch.ops import knn_select as ks

CUTOFFS = {"pp": 3.5, "pf": 8.0, "fp": 8.0, "ff": 9.0}
GEOM_ATOL = 1e-6


def make_inputs(rng, b=4, f=8, p=48):
    pharm_x = rng.normal(scale=3.0, size=(b, f, 3)).astype(np.float32)
    prot_x = rng.normal(scale=6.0, size=(b, p, 3)).astype(np.float32)
    pharm_mask = np.ones((b, f), bool)
    prot_mask = np.ones((b, p), bool)
    pharm_mask[0, 5:] = False
    pharm_mask[1, :] = False          # a masked-out pharm row
    prot_mask[2, 3:] = False          # fewer valid atoms than k
    prot_mask[3, 40:] = False
    prot_x[0, 7] = prot_x[0, 3]       # exact duplicate coordinates: ties
    prot_x[3, 20] = prot_x[3, 11]
    prot_x[3, 30] = prot_x[3, 11]
    return pharm_x, pharm_mask, prot_x, prot_mask


def close(got, want, atol=GEOM_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_plain_pf_edges_match_jax_selection_and_geometry(rng, k):
    args = make_inputs(rng)
    idx, mask, x_dir, x_dir_fp, d_rbf = ks.knn_pf_edges_reference(
        *(torch.from_numpy(a) for a in args), k)
    j_idx, j_dist, j_xg = jax_knn_reference(*(jnp.asarray(a) for a in args),
                                            k)
    j_dir, j_rbf = jedges._pair_geometry(jnp.asarray(args[0]), j_xg)
    assert idx.dtype == torch.int64 and mask.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(j_dist) < jedges._BIG)
    assert mask[2, 0].sum() == min(3, k) and not mask[1].any()
    close(x_dir, j_dir)
    close(d_rbf, j_rbf)
    assert torch.equal(x_dir_fp, -x_dir)
    assert d_rbf.shape == (4, 8, k, jedges.RBF_DIM)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_edge_bundle_pf_and_fp_match_jax(rng, k):
    px, pm, qx, qm = make_inputs(rng)
    want = jedges.build_edge_bundle(
        jnp.asarray(px), jnp.asarray(pm), jnp.asarray(qx), jnp.asarray(qm),
        CUTOFFS, ff_k=0, pf_k=k, pp_nbrs=None, pp_edge=0)
    got = tedges.build_edge_bundle(
        *(torch.from_numpy(a) for a in (px, pm, qx, qm)), CUTOFFS, ff_k=0,
        pf_k=k, pp_edge=0)
    for kind in ("pf", "fp"):
        g, w = got[kind], want[kind]
        np.testing.assert_array_equal(g.idx.numpy(), np.asarray(w.idx))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        close(g.x_dir, w.x_dir)
        close(g.d_rbf, w.d_rbf)
    assert got["fp"].n_dst == want["fp"].n_dst == qx.shape[1]


@pytest.mark.parametrize("k", [1, 5, 8])
def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing(rng, k):
    args = [torch.from_numpy(a) for a in make_inputs(rng)]
    before = ks.launches
    got = ks.knn_pf_edges(*args, k)
    want = ks.knn_pf_edges_reference(*args, k)
    assert ks.launches == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_wrapper_refuses_other_devices(rng):
    args = [torch.from_numpy(a).to("meta") for a in make_inputs(rng)]
    with pytest.raises(ValueError, match="unsupported device"):
        ks.knn_pf_edges(*args, 5)


@pytest.mark.parametrize("which", [0, 2])
def test_wrapper_refuses_inputs_that_require_grad(rng, which):
    args = [torch.from_numpy(a) for a in make_inputs(rng)]
    args[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ks.knn_pf_edges(*args, 5)
    with torch.no_grad():
        ks.knn_pf_edges(*args, 5)
