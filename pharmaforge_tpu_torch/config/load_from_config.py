"""Factories: a merged config dict -> model / data module.

Port of `pharmaforge_tpu/config/load_from_config.py` (reference
config_utils/load_from_config.py:6-43). The config is a plain dict (a
YAML file's, or one built in Python); nothing here reads YAML.
"""

from __future__ import annotations

import torch

from pharmaforge_tpu_torch.data.datamodule import CrossdockedDataModule
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)


def model_from_config(config: dict, device=None,
                      seed: int = 0) -> PharmacophoreDiffusion:
    """The model of `config` on `device` (CUDA by default), its weights
    drawn with torch's default init from a generator seeded with `seed`."""
    return PharmacophoreDiffusion(
        DiffusionConfig.from_config(config), device=device,
        generator=torch.Generator().manual_seed(seed))


def data_module_from_config(config: dict) -> CrossdockedDataModule:
    dataset_config = dict(config["dataset"])
    dataset_config["graph_cutoffs"] = config["graph"]["graph_cutoffs"]
    return CrossdockedDataModule(
        dataset_config=dataset_config,
        batch_size=config["training"]["batch_size"],
        num_workers=config["training"].get("num_workers", 0),
        validation_splits=config["training"]["validation_splits"])
