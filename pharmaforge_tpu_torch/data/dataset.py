"""Processed-tensor dataset and its size-bucketed loader.

Port of `pharmaforge_tpu/data/dataset.py`. A processed dataset (the
reference's format, process_crossdocked.py:173-263, which
`cli/process_crossdocked.py` writes) is a directory of split directories,
each holding `prot_pharm_tensors.npz` (flat arrays `pharm_pos`,
`pharm_feat`, `prot_pos`, `prot_feat`, `prot_ph_pos`, `prot_ph_feat` with
`[start, end)` index arrays `pharm_idx` / `prot_idx` / `prot_ph_idx`),
`prot_file_names.pkl.gz` (each sample's receptor file) and
`lig_rdmol.pkl.gz` (its RDKit ligand, loaded where it unpickles, that is
where RDKit is importable, and None otherwise: only the test CLI's
reference files need it). `get_files` hands both to the test CLI. Split
directory names end in the split index. Samples are numpy dicts; the
loader packs padded `PharmComplexBatch`es grouped by protein-size bucket.

`pack_batch` packs a batch through the C++ packer (`native`, numpy where
it is not built), with the same values as collating `__getitem__`
samples and the same random draws for the pharmacophore subsampling.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from pharmaforge_tpu_torch import native
from pharmaforge_tpu_torch.data.batch import (
    PharmComplexBatch,
    bucket_size,
)
from pharmaforge_tpu_torch.utils.relative_paths import fix_relative_path


class ProteinPharmacophoreDataset:

    def __init__(self, name: str, split_idxs: List[int], raw_data_dir: str,
                 processed_data_dir: str, graph_cutoffs: dict,
                 prot_elements: List[str], ph_type_map: List[str],
                 subsample_pharms: bool = False, subsample_min: int = 3,
                 subsample_max: int = 9, seed: int = 0, **kwargs):
        """Loads the split directories of `processed_data_dir` whose index
        is in `split_idxs`; a relative data directory that does not exist
        is taken relative to the repository's root. `graph_cutoffs` and
        extra config keys are accepted and not read."""
        self.name = name
        self.prot_elements = list(prot_elements)
        self.ph_type_map = list(ph_type_map)
        self.subsample_pharms = subsample_pharms
        self.subsample_min = subsample_min
        self.subsample_max = subsample_max
        self._rng = np.random.default_rng(seed)
        self.processed_data_dir = Path(processed_data_dir)
        if not self.processed_data_dir.exists():
            self.processed_data_dir = Path(
                fix_relative_path(processed_data_dir))
            if not self.processed_data_dir.exists():
                raise FileNotFoundError(f"no processed data directory at "
                                        f"{self.processed_data_dir}")
        self.raw_data_dir = raw_data_dir
        if raw_data_dir and not Path(raw_data_dir).exists():
            fixed = fix_relative_path(raw_data_dir)
            if Path(fixed).exists():
                self.raw_data_dir = fixed
        self.prot_file_names: List[str] = []
        self.lig_rdmol_objects: List[object] = []

        keys = ("pharm_pos", "pharm_feat", "prot_pos", "prot_feat",
                "prot_ph_pos", "prot_ph_feat")
        cols: Dict[str, list] = {k: [] for k in keys}
        spans: Dict[str, list] = {k: [] for k in ("pharm", "prot", "prot_ph")}
        offsets = dict.fromkeys(spans, 0)
        for split_dir in sorted(self.processed_data_dir.iterdir()):
            if not split_dir.is_dir():
                continue
            try:
                split_idx = int(split_dir.name.split("_")[-1][-1])
            except ValueError:
                continue
            if split_idx not in split_idxs:
                continue
            names_file = split_dir / "prot_file_names.pkl.gz"
            if names_file.exists():
                with gzip.open(names_file, "rb") as f:
                    self.prot_file_names.extend(pickle.load(f))
            data = np.load(split_dir / "prot_pharm_tensors.npz")
            self.lig_rdmol_objects.extend(
                _ligands(split_dir / "lig_rdmol.pkl.gz",
                         len(data["prot_idx"])))
            for k in keys:
                cols[k].append(data[k])
            for side in spans:
                spans[side].append(data[f"{side}_idx"] + offsets[side])
                offsets[side] += len(data[f"{side}_pos"])
        if not cols["pharm_pos"]:
            raise FileNotFoundError(f"no split directories matching "
                                    f"{split_idxs} under "
                                    f"{self.processed_data_dir}")
        self.pharm_pos = np.concatenate(cols["pharm_pos"]).astype(np.float32)
        self.pharm_feat = np.concatenate(cols["pharm_feat"]).astype(
            np.int32)
        self.prot_pos = np.concatenate(cols["prot_pos"]).astype(np.float32)
        self.prot_feat = np.concatenate(cols["prot_feat"]).astype(np.int32)
        self.prot_ph_pos = np.concatenate(cols["prot_ph_pos"]).astype(
            np.float32)
        self.prot_ph_feat = np.concatenate(cols["prot_ph_feat"])
        self.pharm_idx = np.concatenate(spans["pharm"])
        self.prot_idx = np.concatenate(spans["prot"])
        self.prot_ph_idx = np.concatenate(spans["prot_ph"])

    def __len__(self) -> int:
        return self.prot_idx.shape[0]

    def prot_size(self, i: int) -> int:
        s, e = self.prot_idx[i]
        return int(e - s)

    def _subsample(self, n: int) -> Optional[np.ndarray]:
        """Row selection of a pharmacophore of `n` centres under
        subsampling (reference protein_pharm_dataset.py:158-168), or None
        to keep it whole."""
        if not self.subsample_pharms or n <= self.subsample_min - 1:
            return None
        sub_max = min(self.subsample_max, n)
        k = (self.subsample_min if self.subsample_min == sub_max
             else int(self._rng.integers(self.subsample_min, sub_max + 1)))
        return self._rng.choice(n, size=k, replace=False)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        ps, pe = self.pharm_idx[i]
        rs, re = self.prot_idx[i]
        qs, qe = self.prot_ph_idx[i]
        eye_ph = np.eye(len(self.ph_type_map), dtype=np.float32)
        pharm_pos = self.pharm_pos[ps:pe]
        pharm_h = eye_ph[self.pharm_feat[ps:pe].astype(np.int64)]
        sel = self._subsample(len(pharm_pos))
        if sel is not None:
            pharm_pos, pharm_h = pharm_pos[sel], pharm_h[sel]
        return {
            "pharm_x": pharm_pos, "pharm_h": pharm_h,
            "prot_x": self.prot_pos[rs:re],
            "prot_h": np.eye(len(self.prot_elements), dtype=np.float32)[
                self.prot_feat[rs:re].astype(np.int64)],
            "prot_ph_x": self.prot_ph_pos[qs:qe],
            "prot_ph_h": eye_ph[self.prot_ph_feat[qs:qe].astype(np.int64)],
        }

    def pack_batch(self, indices, max_pharm: int, max_prot: int
                   ) -> PharmComplexBatch:
        """A padded batch straight from the flat arrays: rows sliced,
        one-hot encoded and zero-padded to `max_pharm` / `max_prot` slots
        by the C++ packer, pharmacophores subsampled row by row (as
        `pharmaforge_tpu/data/dataset.py::pack_batch`)."""
        indices = np.asarray(indices)
        n_ph, n_el = len(self.ph_type_map), len(self.prot_elements)
        prot_x, prot_h, prot_mask = native.pack_batch(
            self.prot_pos, self.prot_feat, self.prot_idx[indices], max_prot,
            n_el)
        pharm_spans = self.pharm_idx[indices]
        if self.subsample_pharms:
            rows = []
            for s, e in pharm_spans:
                sel = self._subsample(int(e - s))
                rows.append(np.arange(s, e) if sel is None else s + sel)
            offsets = np.cumsum([0] + [len(r) for r in rows])
            pharm_x, pharm_h, pharm_mask = native.pack_batch_gather(
                self.pharm_pos, self.pharm_feat, np.concatenate(rows),
                offsets, max_pharm, n_ph)
        else:
            pharm_x, pharm_h, pharm_mask = native.pack_batch(
                self.pharm_pos, self.pharm_feat, pharm_spans, max_pharm,
                n_ph)
        return PharmComplexBatch(
            pharm_x=pharm_x, pharm_h=pharm_h, pharm_mask=pharm_mask,
            prot_x=prot_x, prot_h=prot_h, prot_mask=prot_mask)

    def get_files(self, idx: int):
        """(raw data dir, receptor file name, RDKit ligand) of sample `idx`
        (reference protein_pharm_dataset.py:201-207); the name or the
        ligand is None where the processed set does not hold it or it did
        not unpickle."""
        name = (self.prot_file_names[idx]
                if idx < len(self.prot_file_names) else None)
        lig = (self.lig_rdmol_objects[idx]
               if idx < len(self.lig_rdmol_objects) else None)
        return self.raw_data_dir, name, lig


def _ligands(path: Path, n: int) -> list:
    """The `n` ligands of one split's `lig_rdmol.pkl.gz`, or `n` Nones
    where it is missing or does not unpickle (no RDKit to rebuild its
    molecules)."""
    if path.exists():
        try:
            with gzip.open(path, "rb") as f:
                return list(pickle.load(f))
        except (ImportError, AttributeError, pickle.UnpicklingError):
            pass
    return [None] * n


def get_dataloader(dataset: ProteinPharmacophoreDataset, batch_size: int,
                   shuffle: bool = True, seed: int = 0,
                   max_pharm: Optional[int] = None,
                   prot_bucket_multiple: int = 64,
                   drop_last: bool = False) -> "BucketedLoader":
    return BucketedLoader(dataset, batch_size, shuffle=shuffle, seed=seed,
                          max_pharm=max_pharm,
                          prot_bucket_multiple=prot_bucket_multiple,
                          drop_last=drop_last)


class BucketedLoader:
    """Batches grouped by protein-size bucket, so every batch has one of a
    few padded shapes. Batch order, shuffling and the pharm slot count
    follow the JAX package's loader draw for draw."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, max_pharm: Optional[int] = None,
                 prot_bucket_multiple: int = 64, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        if max_pharm is None:
            # one pharm slot count for every batch: the subsample cap under
            # augmentation, else the dataset-wide maximum
            if getattr(dataset, "subsample_pharms", False):
                max_pharm = int(dataset.subsample_max)
            else:
                max_pharm = int(np.max(dataset.pharm_idx[:, 1]
                                       - dataset.pharm_idx[:, 0]))
        self.max_pharm = max_pharm
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._buckets: Dict[int, List[int]] = {}
        for i in range(len(dataset)):
            b = bucket_size(dataset.prot_size(i), prot_bucket_multiple)
            self._buckets.setdefault(b, []).append(i)

    def __len__(self) -> int:
        total = 0
        for idxs in self._buckets.values():
            total += len(idxs) // self.batch_size
            if not self.drop_last and len(idxs) % self.batch_size:
                total += 1
        return total

    def __iter__(self) -> Iterator[PharmComplexBatch]:
        batches = []
        for bucket, idxs in self._buckets.items():
            idxs = list(idxs)
            if self.shuffle:
                self._rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i:i + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                batches.append((bucket, chunk))
        if self.shuffle:
            self._rng.shuffle(batches)
        for bucket, chunk in batches:
            yield self.dataset.pack_batch(chunk, max_pharm=self.max_pharm,
                                          max_prot=bucket)
