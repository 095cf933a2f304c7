"""Train/validation split management over the processed splits.

Port of `pharmaforge_tpu/data/datamodule.py` (reference
dataset/protein_pharmacophore_datamodule.py:16-67): the validation splits
are a user-chosen strict, non-empty subset of the three preprocessed
split directories; the rest trains.
"""

from __future__ import annotations

from typing import Sequence

from pharmaforge_tpu_torch.data.dataset import (
    BucketedLoader,
    ProteinPharmacophoreDataset,
    get_dataloader,
)


class CrossdockedDataModule:

    def __init__(self, dataset_config: dict, batch_size: int,
                 num_workers: int = 0, validation_splits: Sequence[int] = ()):
        self.dataset_config = dict(dataset_config)
        self.batch_size = batch_size
        self.num_workers = num_workers
        held_out = set(validation_splits)
        all_splits = {0, 1, 2}
        if not held_out:
            raise NotImplementedError(
                "a validation hold-out is required: pick at least one of "
                "splits 0/1/2")
        if len(held_out) >= len(all_splits):
            raise ValueError("cannot hold out every split for validation; "
                             "leave at least one to train on")
        if not held_out <= all_splits:
            raise ValueError(f"validation_splits {sorted(held_out)} outside "
                             f"the available splits {sorted(all_splits)}")
        self.train_split_idxs = sorted(all_splits - held_out)
        self.val_split_idxs = sorted(held_out)
        self.train_dataset = None
        self.val_dataset = None

    def setup(self, stage: str = "fit") -> None:
        if stage == "fit":
            self.train_dataset = ProteinPharmacophoreDataset(
                name="train", split_idxs=self.train_split_idxs,
                **self.dataset_config)
        if stage in ("fit", "test"):
            self.val_dataset = ProteinPharmacophoreDataset(
                name="val", split_idxs=self.val_split_idxs,
                **self.dataset_config)

    def train_dataloader(self, seed: int = 0) -> BucketedLoader:
        return get_dataloader(self.train_dataset, self.batch_size, seed=seed)

    def val_dataloader(self, seed: int = 0) -> BucketedLoader:
        return get_dataloader(self.val_dataset, self.batch_size,
                              shuffle=False, seed=seed)
