"""Synthetic pockets and processed datasets.

Copy of `pharmaforge_tpu/data/synthetic.py`, kept here so the port imports
nothing from the JAX package; the same seed writes the same files in both
packages. A dataset is written in the on-disk format of the reference
preprocessing (process_crossdocked.py:173-263): per-split directories with
`prot_pharm_tensors.npz`, `prot_file_names.pkl.gz` and `lig_rdmol.pkl.gz`.
Pocket atoms sit in a shell around a cavity; receptor sites are
projections of pocket atoms toward the cavity, typed by element; the
pharmacophore centres are complementary to the sites nearest the cavity,
so the conditional distribution has structure a model can learn and the
validity metric (analysis/metrics.py) measures it.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path

import numpy as np

# complementary pharm type for each receptor-site type, in PH_IDX_TO_TYPE
# order (Aromatic, HDonor, HAcceptor, PositiveIon, NegativeIon,
# Hydrophobic); consistent with analysis.metrics.MATCHING_TYPES
SITE_TO_PHARM_TYPE = np.array([0, 2, 1, 4, 3, 5])
# matching distance per pharm type (analysis.metrics.MATCHING_DISTANCE)
PHARM_TYPE_MAX_DIST = np.array([7.0, 4.0, 4.0, 5.0, 5.0, 5.0])


def _thin_points(pts: np.ndarray, min_dist: float) -> np.ndarray:
    """Greedy thinning: drop points closer than `min_dist` to an earlier
    kept point (heavy atoms never overlap in real structures)."""
    kept: list = []
    min_sq = min_dist * min_dist
    for p in pts:
        if not kept or np.min(np.sum((np.asarray(kept) - p) ** 2,
                                     axis=1)) >= min_sq:
            kept.append(p)
    return np.asarray(kept)


def make_synthetic_pocket(rng, center, n_prot, n_prot_elements=11):
    """Pocket atoms in a shell of radius 4-12 A around the cavity, thinned
    to a protein-like minimum heavy-atom spacing so the local degree at the
    3.5 A pp cutoff stays realistic (~<= 14). Returns (positions,
    elements)."""
    dirs = rng.normal(size=(n_prot, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(4.0, 12.0, size=(n_prot, 1))
    p_pos = (center + dirs * radii
             + rng.normal(scale=0.6, size=(n_prot, 3)))
    p_pos = _thin_points(p_pos, min_dist=1.7)
    p_elem = rng.integers(0, n_prot_elements, size=len(p_pos))
    return p_pos, p_elem


def make_sites_and_pharms(rng, center, p_pos, p_elem, n_pharm, n_prot_ph,
                          n_ph_types=6, site_rule="random"):
    """Receptor sites and pharmacophore centres for a fixed pocket.
    site_rule 'random' picks `n_prot_ph` random pocket atoms as sites;
    'deterministic' takes the atoms nearest the cavity centre (the count
    from the pocket size), so the sites follow from the pocket alone.
    Returns (site_pos, site_type, pharm_pos, pharm_type)."""
    n_prot = len(p_pos)
    if site_rule == "deterministic":
        n_prot_ph = min(max(6, n_prot // 9), 40, n_prot)
        src = np.argsort(np.linalg.norm(p_pos - center, axis=1))[:n_prot_ph]
    elif site_rule == "random":
        n_prot_ph = min(n_prot_ph, n_prot)
        src = rng.choice(n_prot, size=n_prot_ph, replace=False)
    else:
        raise ValueError(f"unknown site_rule {site_rule!r}")
    toward = center - p_pos[src]
    toward /= np.linalg.norm(toward, axis=1, keepdims=True)
    q_pos = (p_pos[src] + 1.5 * toward
             + rng.normal(scale=0.3, size=(n_prot_ph, 3)))
    q_type = p_elem[src] % n_ph_types

    # pharm centres: complementary to the sites nearest the cavity centre
    order = np.argsort(np.linalg.norm(q_pos - center, axis=1))
    pick = order[rng.integers(0, max(len(order) // 2, 1), size=n_pharm)]
    f_type = SITE_TO_PHARM_TYPE[q_type[pick]]
    inward = center - q_pos[pick]
    inward /= np.linalg.norm(inward, axis=1, keepdims=True)
    dist = rng.uniform(1.0, PHARM_TYPE_MAX_DIST[f_type] - 0.7)
    f_pos = (q_pos[pick] + dist[:, None] * inward
             + rng.normal(scale=0.2, size=(n_pharm, 3)))
    return q_pos, q_type, f_pos, f_type


def _spans(arrs) -> np.ndarray:
    """[start, end) rows of each array in their concatenation."""
    n = np.array([len(a) for a in arrs])
    idx = np.zeros((len(arrs), 2), dtype=int)
    idx[:, 1] = np.cumsum(n)
    idx[1:, 0] = idx[:-1, 1]
    return idx


def make_synthetic_processed_dataset(
        out_dir: str,
        n_splits: int = 3,
        samples_per_split: int = 32,
        n_prot_range=(60, 360),
        n_pharm_range=(3, 12),
        n_prot_ph_range=(6, 40),
        n_prot_elements: int = 11,
        n_ph_types: int = 6,
        seed: int = 0,
        site_rule: str = "random") -> Path:
    """Write `n_splits` split directories of `samples_per_split` synthetic
    complexes under `out_dir`; returns it as a Path."""
    out = Path(out_dir)
    rng = np.random.default_rng(seed)
    for split in range(n_splits):
        split_dir = out / f"it2_tt_v1.3_0_test{split}"
        split_dir.mkdir(parents=True, exist_ok=True)
        cols = {k: [] for k in ("pharm_pos", "pharm_feat", "prot_pos",
                                "prot_feat", "prot_ph_pos", "prot_ph_feat")}
        names = []
        for i in range(samples_per_split):
            center = rng.normal(scale=30.0, size=3)
            n_prot = int(rng.integers(*n_prot_range))
            n_pharm = int(rng.integers(*n_pharm_range))
            n_prot_ph = min(int(rng.integers(*n_prot_ph_range)), n_prot)
            p_pos, p_elem = make_synthetic_pocket(rng, center, n_prot,
                                                  n_prot_elements)
            q_pos, q_type, f_pos, f_type = make_sites_and_pharms(
                rng, center, p_pos, p_elem, n_pharm, n_prot_ph, n_ph_types,
                site_rule=site_rule)
            cols["pharm_pos"].append(f_pos.astype(np.float32))
            cols["pharm_feat"].append(f_type.astype(np.int32))
            cols["prot_pos"].append(p_pos.astype(np.float32))
            cols["prot_feat"].append(p_elem.astype(np.int32))
            cols["prot_ph_pos"].append(q_pos.astype(np.float32))
            cols["prot_ph_feat"].append(q_type.astype(np.float32))
            names.append(f"synthetic/pocket_{split}_{i}.pdb")
        np.savez_compressed(
            split_dir / "prot_pharm_tensors.npz",
            prot_pos=np.concatenate(cols["prot_pos"]),
            prot_feat=np.concatenate(cols["prot_feat"]),
            prot_idx=_spans(cols["prot_pos"]),
            pharm_pos=np.concatenate(cols["pharm_pos"]),
            pharm_feat=np.concatenate(cols["pharm_feat"]),
            pharm_idx=_spans(cols["pharm_pos"]),
            prot_ph_pos=np.concatenate(cols["prot_ph_pos"]),
            prot_ph_feat=np.concatenate(cols["prot_ph_feat"]),
            prot_ph_idx=_spans(cols["prot_ph_pos"]),
        )
        with gzip.open(split_dir / "prot_file_names.pkl.gz", "wb") as f:
            pickle.dump(names, f)
        with gzip.open(split_dir / "lig_rdmol.pkl.gz", "wb") as f:
            pickle.dump([None] * samples_per_split, f)
    return out
