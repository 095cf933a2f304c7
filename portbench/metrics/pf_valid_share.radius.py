"""Denoiser (`models/edges.py`'s radius pf edge): the share of the dense
[B, F, P] pf rows that are valid (centre, pocket atom) pairs within r_pf,
in %: the program's `edges.pf_radius_pairs` over `edges.pf_radius_rows`
in the eager work step. Each pf and fp message chain runs every row; the
rest are masked out after the chain."""


def read(run):
    rows = run.work.get("pf_radius_rows")
    pairs = run.work.get("pf_radius_pairs")
    if not rows or pairs is None:
        return None
    return 100.0 * pairs / rows
