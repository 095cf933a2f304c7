"""Canonical pharmacophore type ordering.

Copy of `pharmaforge_tpu/constants.py`, kept here so the port imports
nothing from the JAX package. The ordering is load-bearing: preprocessing,
the model's one-hot feature axis, the validity metric and the xyz element
mapping all index into this list.
"""

PH_IDX_TO_TYPE = [
    "Aromatic",
    "HydrogenDonor",
    "HydrogenAcceptor",
    "PositiveIon",
    "NegativeIon",
    "Hydrophobic",
]

PH_TYPE_TO_IDX = {val: idx for idx, val in enumerate(PH_IDX_TO_TYPE)}

# Placeholder chemical elements used when writing pharmacophore centers to
# .xyz files. Index-aligned with PH_IDX_TO_TYPE: Aromatic->P,
# HydrogenDonor->S, HydrogenAcceptor->F, PositiveIon->N, NegativeIon->O,
# Hydrophobic->C.
TYPE_IDX_TO_ELEM = ["P", "S", "F", "N", "O", "C"]

N_PH_TYPES = len(PH_IDX_TO_TYPE)

# aliases matching the reference's public names
ph_idx_to_type = PH_IDX_TO_TYPE
ph_type_to_idx = PH_TYPE_TO_IDX
