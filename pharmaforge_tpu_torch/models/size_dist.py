"""Pharmacophore size sampling distribution.

Port of `pharmaforge_tpu/models/size_dist.py` (reference
models/n_nodes_dist.py): sizes come from the processed dataset's
empirical histogram when one is found, else uniformly from 3..8.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


class PharmSizeDistribution:

    def __init__(self, dataset_dir: Optional[str] = None,
                 min_size: int = 3, max_size: int = 8, seed: int = 0):
        self.min_size = min_size
        self.max_size = max_size
        self._rng = np.random.default_rng(seed)
        self._sizes: Optional[np.ndarray] = None
        self._probs: Optional[np.ndarray] = None
        if dataset_dir is not None:
            self._load_histogram(Path(dataset_dir))

    def _load_histogram(self, dataset_dir: Path) -> None:
        if not dataset_dir.exists():
            return
        counts: list = []
        for split_dir in sorted(dataset_dir.iterdir()):
            tensor_file = split_dir / "prot_pharm_tensors.npz"
            if tensor_file.exists():
                idx = np.load(tensor_file)["pharm_idx"]
                counts.extend((idx[:, 1] - idx[:, 0]).tolist())
        if counts:
            arr = np.clip(np.asarray(counts), self.min_size, self.max_size)
            sizes, freq = np.unique(arr, return_counts=True)
            self._sizes = sizes
            self._probs = freq / freq.sum()

    def sample_uniformly(self, n_replicates: int) -> np.ndarray:
        """U{min_size..max_size} (reference n_nodes_dist.py:13-14)."""
        return self._rng.integers(self.min_size, self.max_size + 1,
                                  size=n_replicates)

    def sample(self, n_replicates: int) -> np.ndarray:
        """The dataset's empirical distribution when available, else
        uniform."""
        if self._sizes is None:
            return self.sample_uniformly(n_replicates)
        return self._rng.choice(self._sizes, size=n_replicates, p=self._probs)
