"""Load a trained model from a run directory or a checkpoint path.

Port of `pharmaforge_tpu/training/restore.py`, the inference side's
counterpart of PL's `load_from_checkpoint` (reference test.py:113-115,
generate_pharmacophores.py:267-269): the run directory's `config.yaml`
builds the model, and the weights come from one of its checkpoints
(`RunCheckpointer`) or from a reference `.ckpt` file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import torch

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.config.load_from_config import model_from_config
from pharmaforge_tpu_torch.config.yaml_io import load_file
from pharmaforge_tpu_torch.interop import load_torch_checkpoint
from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
from pharmaforge_tpu_torch.training.checkpoints import RunCheckpointer


def resolve_run_dir(ckpt: Optional[Path], model_dir: Optional[Path]
                    ) -> Tuple[Path, str]:
    """(run_dir, which checkpoint) from the --ckpt / --model_dir flags
    (reference test.py:62-69): a checkpoint's run dir is its parent's
    parent."""
    if ckpt is not None:
        return Path(ckpt).parent.parent, str(ckpt)
    if model_dir is not None:
        return Path(model_dir), "last"
    raise ValueError("Must provide either --ckpt or --model_dir")


def load_config(run_dir: Path) -> dict:
    """The run's `config.yaml` (or `config.yml`)."""
    run_dir = Path(run_dir)
    config_file = run_dir / "config.yaml"
    if not config_file.exists():
        config_file = run_dir / "config.yml"
        if not config_file.exists():
            raise FileNotFoundError(f"config file not found in {run_dir}")
    return load_file(config_file)


def load_model(run_dir: Path, which: str = "last", device=None
               ) -> Tuple[PharmacophoreDiffusion, dict]:
    """(model holding the weights, on `device`; config) of a run.

    `which` is 'last', 'best' or a checkpoint directory of the run
    (`RunCheckpointer.path_of`), or a reference PL `.ckpt` file: then the
    config still comes from the run dir, and the weights from the file
    (`interop.load_torch_checkpoint`)."""
    device = resolve_device(device)
    run_dir = Path(run_dir)
    config = load_config(run_dir)
    model = model_from_config(config, device="cpu")
    if str(which).endswith(".ckpt"):
        # a missing .ckpt must fail here, not be taken for a checkpoint
        # directory of the run
        if not Path(which).is_file():
            raise FileNotFoundError(f"checkpoint file not found: {which}")
        state = load_torch_checkpoint(which, model.config)
    else:
        path = RunCheckpointer(run_dir).path_of(which)
        state = torch.load(path / "model.pt", map_location="cpu",
                           weights_only=True)
    model.load_state_dict(state)
    return model.to(device), config
