"""Synthetic pocket geometry.

Copy of the pocket generator of `pharmaforge_tpu/data/synthetic.py`
(`make_synthetic_pocket`, `_thin_points`), kept here so the port imports
nothing from the JAX package. The same seed gives the same pocket in both
packages.
"""

from __future__ import annotations

import numpy as np


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
