"""Pharmacophore validity metric.

Port of `pharmaforge_tpu/analysis/metrics.py` (reference
analysis/metrics.py:7-86): the fraction of generated centres that lie
within a type-specific distance of a complementary receptor site, its
breakdown by generated type, and the type histogram. Host numpy over
small decoded samples.
"""

from __future__ import annotations

from typing import List

import numpy as np

from pharmaforge_tpu_torch.analysis.pharm_builder import SampledPharmacophore
from pharmaforge_tpu_torch.constants import PH_IDX_TO_TYPE

MATCHING_TYPES = {
    "Aromatic": ["Aromatic", "PositiveIon"],
    "HydrogenDonor": ["HydrogenAcceptor"],
    "HydrogenAcceptor": ["HydrogenDonor"],
    "PositiveIon": ["NegativeIon", "Aromatic"],
    "NegativeIon": ["PositiveIon"],
    "Hydrophobic": ["Hydrophobic"],
}

MATCHING_DISTANCE = {
    "Aromatic": 7,
    "Hydrophobic": 5,
    "HydrogenAcceptor": 4,
    "HydrogenDonor": 4,
    "NegativeIon": 5,
    "PositiveIon": 5,
}


def compute_complementarity(pharm_types: List[str], pharm_pos: np.ndarray,
                            prot_ph_types: List[str], prot_ph_pos: np.ndarray,
                            return_count: bool = False):
    """Fraction (or count) of generated centres near a complementary
    receptor site (reference metrics.py:53-86)."""
    if len(prot_ph_types) == 0 or len(pharm_types) == 0:
        return 0 if return_count else 0.0
    distances = np.linalg.norm(
        np.asarray(pharm_pos, np.float64)[:, None, :]
        - np.asarray(prot_ph_pos, np.float64)[None, :, :], axis=-1)
    reach = np.array([MATCHING_DISTANCE[t] for t in pharm_types])[:, None]
    matching = np.array([[rec in MATCHING_TYPES[ph] for rec in prot_ph_types]
                         for ph in pharm_types])
    count = int(((distances <= reach) & matching).any(axis=1).sum())
    return count if return_count else count / len(pharm_types)


class SampleAnalyzer:

    def analyze(self, sample: List[SampledPharmacophore]) -> dict:
        """{'validity': complementary centres / all centres} over samples
        that carry their pocket's receptor sites (reference
        metrics.py:9-35)."""
        valid, total = 0, 0
        for ph in sample:
            if ph.prot_ph_pos is None or ph.prot_ph_types is None:
                raise ValueError(
                    "sample lacks receptor pharmacophore sites (prot_ph); "
                    "validity is only computable for dataset pockets")
            valid += compute_complementarity(
                pharm_types=ph.ph_types, pharm_pos=ph.ph_coords,
                prot_ph_types=ph.prot_ph_types, prot_ph_pos=ph.prot_ph_pos,
                return_count=True)
            total += ph.n_ph_centers
        return {"validity": valid / max(total, 1)}

    def analyze_per_type(self, sample: List[SampledPharmacophore]) -> dict:
        """Validity by generated-centre type (the JAX package's extension
        of the reference): {'validity_<Type>': fraction of generated
        <Type> centres near a complementary receptor site, 'count_<Type>':
        how many were generated}. `analyze`'s 'validity' is their
        count-weighted mean."""
        num = dict.fromkeys(MATCHING_TYPES, 0)
        den = dict.fromkeys(MATCHING_TYPES, 0)
        for ph in sample:
            if ph.prot_ph_pos is None or ph.prot_ph_types is None:
                raise ValueError(
                    "sample lacks receptor pharmacophore sites (prot_ph); "
                    "validity is only computable for dataset pockets")
            for i, t in enumerate(ph.ph_types):
                den[t] += 1
                num[t] += compute_complementarity(
                    pharm_types=[t], pharm_pos=ph.ph_coords[i:i + 1],
                    prot_ph_types=ph.prot_ph_types,
                    prot_ph_pos=ph.prot_ph_pos, return_count=True)
        out = {}
        for t in MATCHING_TYPES:
            out[f"validity_{t}"] = num[t] / max(den[t], 1)
            out[f"count_{t}"] = den[t]
        return out

    def pharm_feat_freq(self, sample: List[SampledPharmacophore]
                        ) -> np.ndarray:
        """Per-type counts over all sampled centres (reference
        metrics.py:37-51)."""
        type_counts = np.zeros(len(PH_IDX_TO_TYPE))
        for ph in sample:
            for val in ph.ph_feats_idxs:
                type_counts[int(val)] += 1
        return type_counts
