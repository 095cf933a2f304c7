"""Plain re-derivation of the training batches from a processed dataset.

The reference's data path (protein_pharm_dataset.py, the dataset and its
size-bucketed loader) written out plainly over the raw `.npz` files: the
train splits' complexes grouped by padded pocket size, shuffled per bucket
and then as batches by the loader's seed, each pharmacophore of more than
`subsample_min` - 1 centres subsampled by the dataset's own generator
(seed 0) in batch order, and packed into padded, one-hot batches. It
imports nothing of the program.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Sequence

import numpy as np


def bucket_size(n: int, multiple: int = 64, minimum: int = 64) -> int:
    return max(minimum, ((n + multiple - 1) // multiple) * multiple)


class Complexes:
    """The complexes of the split directories whose index (the last
    character of the name) is in `splits`, in directory order."""

    def __init__(self, root: Path, splits: Sequence[int]):
        parts = {k: [] for k in ("pharm_pos", "pharm_feat", "prot_pos",
                                 "prot_feat")}
        spans = {k: [] for k in ("pharm", "prot")}
        offsets = {"pharm": 0, "prot": 0}
        for d in sorted(Path(root).iterdir()):
            if not d.is_dir() or int(d.name[-1]) not in splits:
                continue
            data = np.load(d / "prot_pharm_tensors.npz")
            for k in parts:
                parts[k].append(data[k])
            for side in spans:
                spans[side].append(data[f"{side}_idx"] + offsets[side])
                offsets[side] += len(data[f"{side}_pos"])
        self.cols = {k: np.concatenate(v) for k, v in parts.items()}
        self.pharm_idx = np.concatenate(spans["pharm"])
        self.prot_idx = np.concatenate(spans["prot"])

    def __len__(self) -> int:
        return len(self.prot_idx)


def batches(data: Complexes, batch_size: int, loader_seed: int,
            sub_min: int, sub_max: int, n_types: int, n_elements: int,
            dataset_seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch's padded batches, in order."""
    order_rng = np.random.default_rng(loader_seed)
    sub_rng = np.random.default_rng(dataset_seed)
    buckets: Dict[int, List[int]] = {}
    for i, (s, e) in enumerate(data.prot_idx):
        buckets.setdefault(bucket_size(int(e - s)), []).append(i)
    plan = []
    for bucket, idxs in buckets.items():
        idxs = list(idxs)
        order_rng.shuffle(idxs)
        for i in range(0, len(idxs), batch_size):
            plan.append((bucket, idxs[i:i + batch_size]))
    order_rng.shuffle(plan)
    eye_t = np.eye(n_types, dtype=np.float32)
    eye_e = np.eye(n_elements, dtype=np.float32)
    for bucket, chunk in plan:
        b = len(chunk)
        out = {"pharm_x": np.zeros((b, sub_max, 3), np.float32),
               "pharm_h": np.zeros((b, sub_max, n_types), np.float32),
               "pharm_mask": np.zeros((b, sub_max), bool),
               "prot_x": np.zeros((b, bucket, 3), np.float32),
               "prot_h": np.zeros((b, bucket, n_elements), np.float32),
               "prot_mask": np.zeros((b, bucket), bool)}
        for row, i in enumerate(chunk):
            rs, re = data.prot_idx[i]
            n_p = re - rs
            out["prot_x"][row, :n_p] = data.cols["prot_pos"][rs:re]
            out["prot_h"][row, :n_p] = eye_e[data.cols["prot_feat"][rs:re]]
            out["prot_mask"][row, :n_p] = True
            ps, pe = data.pharm_idx[i]
            n = int(pe - ps)
            rows = np.arange(ps, pe)
            if n > sub_min - 1:
                hi = min(sub_max, n)
                k = sub_min if sub_min == hi else int(
                    sub_rng.integers(sub_min, hi + 1))
                rows = ps + sub_rng.choice(n, size=k, replace=False)
            out["pharm_x"][row, :len(rows)] = data.cols["pharm_pos"][rows]
            out["pharm_h"][row, :len(rows)] = eye_t[
                data.cols["pharm_feat"][rows]]
            out["pharm_mask"][row, :len(rows)] = True
        yield out
