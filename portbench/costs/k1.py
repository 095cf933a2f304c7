"""K1's work: `knn_pf_edges`, each pharm centre's pf_k nearest pocket
atoms with the edge geometry (`csrc/knn_select.cu`).

The least work the call's data needs, counted as `chip_smoke.py` counts
it: the inputs read once (pharm and prot coordinates as fp32 and their
masks, 13 bytes a row), the outputs written once (idx 8 bytes, mask 1,
x_dir and its negation 12 each, RBF_DIM fp32 RBF values a slot); the
squared distances and k selection passes, then 17 operations of geometry
and 5 per RBF value a slot."""

RBF_DIM = 16


def cost(b: int, f: int, p: int, k: int):
    """(bytes, operations) of one call on [B, F] centres and [B, P]
    pocket slots with k neighbours."""
    n_bytes = bytes_in(b, f, p) + bytes_out(b, f, k)
    n_ops = b * f * p * (8 + k) + b * f * k * (17 + 5 * RBF_DIM)
    return n_bytes, n_ops


def bytes_in(b: int, f: int, p: int) -> int:
    return b * f * 13 + b * p * 13


def bytes_out(b: int, f: int, k: int) -> int:
    return b * f * k * (8 + 1 + 12 + 12 + 4 * RBF_DIM)
