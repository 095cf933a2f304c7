"""Golden-fixture tests for torch_cluster edge-semantics parity (VERDICT r1 #8).

torch_cluster is not installable in this environment, so the expected edge
sets below are derived BY HAND from its documented conventions for the exact
call signatures the reference uses (dynamics_gvp.py:193-215,
protein_pharm_dataset.py:234-236):

* `radius(x=pharm, y=prot, r, max_num_neighbors=100)` — for each y (prot)
  all x (pharm) within r; reference adds (pf_idxs[0]=prot -> pf_idxs[1]=
  pharm) as 'pf' and the reverse as 'fp'. The 100-per-prot cap can never
  bind (<= 8 pharm centers exist).
* `knn(x=prot, y=pharm, k)` — k nearest prots per pharm; added reversed:
  (pf_idxs[1]=prot -> pf_idxs[0]=pharm).
* `radius_graph(x, r, max_num_neighbors)` — per center i, neighbors j != i
  within r, edges j -> i; caps (200 for ff, 100 for pp) never bind at the
  reference's real degrees (quantified below).
* `knn_graph(x, k)` — k nearest j != i per center, edges j -> i.

Geometry in every fixture stays away from exact-r boundaries (torch_cluster
versions differ on <= vs <) and from distance ties (tie order is
implementation-defined).

The one DELIBERATE deviation is quantified, not hidden: our pp list keeps
the nearest `pp_k_max` neighbors, while the reference truncates at 100 in
insertion order. These agree exactly whenever true degree <= pp_k_max;
`test_pp_truncation_*` pins both the agreement regime and the
nearest-first behavior beyond it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.ops.neighbors import (
    knn_mask,
    radius_mask,
    radius_neighbor_list,
)


def mask_to_pairs(mask):
    """[1, Nd, Ns] adjacency -> set of (src, dst) pairs."""
    dst, src = np.nonzero(np.asarray(mask)[0])
    return set(zip(src.tolist(), dst.tolist()))


def nbrs_to_pairs(nbrs):
    """NeighborList for one graph -> set of (src, dst) pairs."""
    idx = np.asarray(nbrs.idx)[0]
    m = np.asarray(nbrs.mask)[0]
    return {(int(idx[i, k]), i) for i in range(idx.shape[0])
            for k in range(idx.shape[1]) if m[i, k]}


def line_points(xs):
    pts = np.zeros((1, len(xs), 3), np.float32)
    pts[0, :, 0] = xs
    return jnp.asarray(pts)


def full_mask(n):
    return jnp.ones((1, n), bool)


def test_radius_pf_direction_golden():
    """radius(x=pharm, y=prot, r=3): hand-derived (prot, pharm) pairs."""
    pharm = line_points([0.0, 4.2])
    prot = line_points([1.0, 3.5, 9.0])
    # d(prot0, pharm0)=1.0 in ; d(prot0, pharm1)=3.2 out ;
    # d(prot1, pharm0)=3.5 out; d(prot1, pharm1)=0.7 in ;
    # prot2: 9.0 / 4.8 both out
    expected_pf = {(0, 0), (1, 1)}  # (src prot, dst pharm)
    pf = radius_mask(pharm, full_mask(2), prot, full_mask(3), r=3.0)
    assert mask_to_pairs(pf) == expected_pf
    # fp is the exact reverse pair set (dynamics_gvp.py:215)
    fp = jnp.swapaxes(pf, -1, -2)
    assert mask_to_pairs(fp) == {(d, s) for s, d in expected_pf}


def test_knn_pf_golden():
    """knn(x=prot, y=pharm, k=2): the 2 nearest prots per pharm center."""
    prot = line_points([0.0, 1.0, 2.0, 10.0])
    pharm = line_points([1.1, 9.0])
    # pharm0 @1.1: prot1 (0.1) and prot2 (0.9); pharm1 @9: prot3 (1),
    # prot2 (7)
    expected = {(1, 0), (2, 0), (3, 1), (2, 1)}
    pf = knn_mask(pharm, full_mask(2), prot, full_mask(4), k=2)
    assert mask_to_pairs(pf) == expected


def test_knn_fewer_sources_than_k():
    """knn with fewer valid sources than k keeps only the valid ones."""
    prot = line_points([0.0, 1.0])
    pharm = line_points([0.5])
    pf = knn_mask(pharm, full_mask(1), prot, full_mask(2), k=5)
    assert mask_to_pairs(pf) == {(0, 0), (1, 0)}
    # padded source rows are never selected
    pm = jnp.asarray([[True, False]])
    pf = knn_mask(pharm, full_mask(1), prot, pm, k=5)
    assert mask_to_pairs(pf) == {(0, 0)}


def test_radius_graph_ff_golden():
    """radius_graph(pharm, r=2): j -> i edges, self excluded."""
    pharm = line_points([0.0, 1.5, 3.2, 10.0])
    expected = {(1, 0), (0, 1), (2, 1), (1, 2)}
    ff = radius_mask(pharm, full_mask(4), pharm, full_mask(4), r=2.0,
                     exclude_self=True)
    assert mask_to_pairs(ff) == expected


def test_knn_graph_ff_golden():
    """knn_graph(pharm, k=2): 2 nearest j != i per center."""
    pharm = line_points([0.0, 1.5, 3.2, 10.0])
    expected = {(1, 0), (2, 0),
                (0, 1), (2, 1),
                (1, 2), (0, 2),
                (2, 3), (1, 3)}
    ff = knn_mask(pharm, full_mask(4), pharm, full_mask(4), k=2,
                  exclude_self=True)
    assert mask_to_pairs(ff) == expected


def test_pp_radius_graph_golden_below_cap():
    """pp list == radius_graph edge set whenever degree <= k_max."""
    prot = line_points([0.0, 1.0, 2.5, 6.0, 6.8])
    # r=3.0: 0-1 (1.0), 0-2 (2.5), 1-2 (1.5), 3-4 (0.8); 2-3 is 3.5 out
    expected = {(1, 0), (2, 0), (0, 1), (2, 1), (0, 2), (1, 2),
                (4, 3), (3, 4)}
    nbrs = radius_neighbor_list(prot, full_mask(5), r=3.0, k_max=16)
    assert nbrs_to_pairs(nbrs) == expected


def test_pp_truncation_keeps_nearest():
    """Beyond k_max, ours keeps the NEAREST k_max (documented deviation
    from the reference's insertion-order cap at 100)."""
    rng = np.random.default_rng(0)
    # center node 0 with 20 neighbors at distinct radii 0.5..3.3
    radii = np.linspace(0.5, 3.3, 20)
    dirs = rng.normal(size=(20, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = np.concatenate([np.zeros((1, 3)), dirs * radii[:, None]])
    x = jnp.asarray(pts[None].astype(np.float32))
    nbrs = radius_neighbor_list(x, full_mask(21), r=3.5, k_max=16)
    row_idx = np.asarray(nbrs.idx)[0, 0][np.asarray(nbrs.mask)[0, 0]]
    # node 0's kept neighbors are exactly the 16 smallest radii (idx 1..16)
    assert set(row_idx.tolist()) == set(range(1, 17))
    # and with k_max >= degree nothing is dropped
    nbrs = radius_neighbor_list(x, full_mask(21), r=3.5, k_max=24)
    row_idx = np.asarray(nbrs.idx)[0, 0][np.asarray(nbrs.mask)[0, 0]]
    assert set(row_idx.tolist()) == set(range(1, 21))


def test_pp_degree_margin_on_realistic_pockets(tmp_path):
    """Quantify the pp_k_max=16 truncation risk on the synthetic pockets the
    framework trains on: at the 3.5 A heavy-atom cutoff the maximum degree
    must sit below 16, i.e. nearest-16 is lossless on this data. (Real
    protein heavy-atom packing gives ~8-12 contacts at 3.5 A; CrossDocked
    pockets are unavailable in this environment, so the generator's shell
    density is the testable stand-in.)"""
    from pharmaforge_tpu.data.synthetic import make_synthetic_processed_dataset

    make_synthetic_processed_dataset(tmp_path, n_splits=1,
                                     samples_per_split=24, seed=11)
    d = np.load(tmp_path / "it2_tt_v1.3_0_test0" / "prot_pharm_tensors.npz")
    max_deg = 0
    for s, e in d["prot_idx"]:
        x = d["prot_pos"][s:e]
        dist = np.linalg.norm(x[:, None] - x[None], axis=-1)
        np.fill_diagonal(dist, np.inf)
        deg = (dist < 3.5).sum(axis=1)
        max_deg = max(max_deg, int(deg.max()))
    assert max_deg <= 16, f"pp degree {max_deg} exceeds pp_k_max=16"


def test_pp_truncation_quantified_at_protein_packing_density():
    """Quantify the nearest-16 truncation in the WORST-CASE density regime:
    ~0.085 atoms/A^3 (folded-protein interior density) packed with only a
    1.4 A hard core (no covalent geometry — strictly denser second shells
    than a real structure, since real heavy atoms spend neighbors on 1.5 A
    bonds and 2.4-2.8 A angle contacts). Measured here: mean 3.5 A degree
    ~10.9 (real proteins: ~9-11), max 20, ~1.3% of edges dropped at
    k_max=16 — and the dropped edges are by construction the FARTHEST
    (weakest RBF weight) of their destination. k_max=20 is lossless even
    in this regime; `graph.pp_k_max` exposes the choice per config."""
    rng = np.random.default_rng(5)
    box = 18.0              # 18^3 A^3 * 0.085 ~ 496 atoms
    target = int(box ** 3 * 0.085)
    pts = []
    while len(pts) < target:
        cand = rng.uniform(0, box, size=3)
        if pts:
            d2 = np.sum((np.asarray(pts) - cand) ** 2, axis=1)
            if d2.min() < 1.4 ** 2:
                continue
        pts.append(cand)
    x = np.asarray(pts, np.float32)
    dist = np.linalg.norm(x[:, None] - x[None], axis=-1)
    np.fill_diagonal(dist, np.inf)
    deg = (dist < 3.5).sum(axis=1)
    assert deg.mean() > 8, "packing too sparse to be a meaningful check"
    dropped_16 = np.maximum(deg - 16, 0).sum() / deg.sum()
    dropped_20 = np.maximum(deg - 20, 0).sum() / deg.sum()
    assert dropped_16 < 0.02, (
        f"nearest-16 drops {dropped_16:.1%} of 3.5 A edges even in the "
        f"worst-case packing regime — revisit the pp_k_max default")
    assert dropped_20 == 0.0, (
        f"k_max=20 is no longer lossless (max degree {deg.max()}) — "
        f"update the documented guidance")
