"""The benchmark's one traffic generator: pockets, pharmacophore sizes,
per-call seeds and processed training sets, all drawn from `--seed` and a
mix's parameters (a `traffic/<name>.json` file).

Pockets follow the port's `data/synthetic.py` (atoms in a shell of radius
4-12 A around the cavity, thinned to a 1.7 A minimum spacing, random
elements; receptor sites and pharmacophore centres complementary to the
sites nearest the cavity), with two changes: a pocket has exactly the
number of atoms asked for (thinning stops there), and the thinning of many
pockets runs in lockstep with numpy.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

# the synthetic site rule's six pharmacophore types, in the order of a
# configuration's `ph_type_map`
SITE_TO_PHARM_TYPE = np.array([0, 2, 1, 4, 3, 5])
PHARM_TYPE_MAX_DIST = np.array([7.0, 4.0, 4.0, 5.0, 5.0, 5.0])
MIN_SPACING = 1.7


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose (`keys`) of run seed `seed`."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64,
                                 *(int(k) % 2 ** 32 for k in keys)])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] % np.uint64(2 ** 63))


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *keys))


def spaced_sizes(lo: int, hi: int, n: int) -> np.ndarray:
    """n sizes spread evenly over [lo, hi]: every seed gets the same set
    of sizes, in an order of its own."""
    return np.round(np.linspace(lo, hi, n)).astype(int)


def make_pockets(gen: np.random.Generator, sizes: Sequence[int],
                 n_elements: int, spare: int = 2
                 ) -> List[Dict[str, np.ndarray]]:
    """One pocket per size: exactly that many atoms, in a shell of radius
    4-12 A around the origin, at least 1.7 A apart, with elements drawn
    from `n_elements`.

    Candidates (`spare` per atom, and 32 more) are kept greedily in order
    while they keep the spacing; all pockets step through their
    candidates together. Pockets that run out of candidates are drawn
    again with twice the spare."""
    sizes = np.asarray(sizes, int)
    m = spare * int(sizes.max()) + 32
    n = len(sizes)
    dirs = gen.normal(size=(n, m, 3))
    dirs /= np.linalg.norm(dirs, axis=2, keepdims=True)
    pos = (dirs * gen.uniform(4.0, 12.0, size=(n, m, 1))
           + gen.normal(scale=0.6, size=(n, m, 3))).astype(np.float32)
    keep = np.zeros((n, m), bool)
    count = np.zeros(n, int)
    for chunk in range(0, n, 64):
        rows = slice(chunk, chunk + 64)
        p = pos[rows]
        sq = (p * p).sum(-1)
        d2 = np.einsum("nid,njd->nij", p, p)
        d2 *= -2.0
        d2 += sq[:, :, None]
        d2 += sq[:, None, :]
        close = d2 < MIN_SPACING ** 2
        k, c, want = keep[rows], count[rows], sizes[rows]
        for i in range(m):
            ok = ~(close[:, i] & k).any(1) & (c < want)
            k[:, i] = ok
            c += ok
            if (c >= want).all():
                break
        keep[rows], count[rows] = k, c
    pockets = [{"prot_x": pos[j][keep[j]],
                "prot_elem": gen.integers(0, n_elements, size=int(sizes[j]))}
               for j in range(n)]
    short = np.flatnonzero(count != sizes)
    if len(short):
        again = make_pockets(gen, sizes[short], n_elements, 2 * spare)
        for j, pocket in zip(short, again):
            pockets[j] = pocket
    return pockets


def one_hot(idx, n: int) -> np.ndarray:
    return np.eye(n, dtype=np.float32)[np.asarray(idx, np.int64)]


def sites_and_pharms(gen, p_pos, p_elem, n_pharm: int, n_sites: int):
    """Receptor sites on `n_sites` random pocket atoms and `n_pharm`
    centres complementary to the sites nearest the cavity (the port's
    `make_sites_and_pharms`, site_rule 'random')."""
    src = gen.choice(len(p_pos), size=min(n_sites, len(p_pos)),
                     replace=False)
    toward = -p_pos[src]
    toward /= np.linalg.norm(toward, axis=1, keepdims=True)
    q_pos = p_pos[src] + 1.5 * toward + gen.normal(scale=0.3,
                                                   size=(len(src), 3))
    q_type = p_elem[src] % len(SITE_TO_PHARM_TYPE)
    order = np.argsort(np.linalg.norm(q_pos, axis=1))
    pick = order[gen.integers(0, max(len(order) // 2, 1), size=n_pharm)]
    f_type = SITE_TO_PHARM_TYPE[q_type[pick]]
    inward = -q_pos[pick]
    inward /= np.linalg.norm(inward, axis=1, keepdims=True)
    dist = gen.uniform(1.0, PHARM_TYPE_MAX_DIST[f_type] - 0.7)
    f_pos = (q_pos[pick] + dist[:, None] * inward
             + gen.normal(scale=0.2, size=(n_pharm, 3)))
    return q_pos, q_type, f_pos, f_type


def _spans(arrs) -> np.ndarray:
    n = np.array([len(a) for a in arrs])
    idx = np.zeros((len(arrs), 2), dtype=int)
    idx[:, 1] = np.cumsum(n)
    idx[1:, 0] = idx[:-1, 1]
    return idx


def write_processed(out_dir: Path, gen: np.random.Generator,
                    split_sizes: Sequence[int], atoms: Sequence[int],
                    centres: Sequence[int], sites: Sequence[int],
                    n_elements: int, n_ph_types: int) -> Path:
    """A processed dataset in the reference preprocessing's format
    (process_crossdocked.py:173-263), one split directory per entry of
    `split_sizes`; every complex centred at a random point, its pocket of
    `atoms[0]`..`atoms[1]` atoms of `n_elements` elements."""
    if n_ph_types != len(SITE_TO_PHARM_TYPE):
        raise ValueError(f"the synthetic site rule has "
                         f"{len(SITE_TO_PHARM_TYPE)} pharmacophore types, "
                         f"the configuration {n_ph_types}")
    out = Path(out_dir)
    for split, n in enumerate(split_sizes):
        split_dir = out / f"synthetic_split{split}"
        split_dir.mkdir(parents=True, exist_ok=True)
        sizes = gen.integers(atoms[0], atoms[1] + 1, size=n)
        pockets = make_pockets(gen, sizes, n_elements)
        cols = {k: [] for k in ("pharm_pos", "pharm_feat", "prot_pos",
                                "prot_feat", "prot_ph_pos", "prot_ph_feat")}
        for pocket in pockets:
            center = gen.normal(scale=30.0, size=3)
            n_ph = int(gen.integers(centres[0], centres[1] + 1))
            n_sites = int(gen.integers(sites[0], sites[1] + 1))
            q_pos, q_type, f_pos, f_type = sites_and_pharms(
                gen, pocket["prot_x"], pocket["prot_elem"], n_ph, n_sites)
            cols["pharm_pos"].append((f_pos + center).astype(np.float32))
            cols["pharm_feat"].append(f_type.astype(np.int32))
            cols["prot_pos"].append((pocket["prot_x"] + center)
                                    .astype(np.float32))
            cols["prot_feat"].append(pocket["prot_elem"].astype(np.int32))
            cols["prot_ph_pos"].append((q_pos + center).astype(np.float32))
            cols["prot_ph_feat"].append(q_type.astype(np.float32))
        np.savez(split_dir / "prot_pharm_tensors.npz",
                 **{k: np.concatenate(v) for k, v in cols.items()},
                 pharm_idx=_spans(cols["pharm_pos"]),
                 prot_idx=_spans(cols["prot_pos"]),
                 prot_ph_idx=_spans(cols["prot_ph_pos"]))
        with gzip.open(split_dir / "prot_file_names.pkl.gz", "wb") as f:
            pickle.dump([f"synthetic/pocket_{split}_{i}.pdb"
                         for i in range(n)], f)
        with gzip.open(split_dir / "lig_rdmol.pkl.gz", "wb") as f:
            pickle.dump([None] * n, f)
    return out
