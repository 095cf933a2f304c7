"""Train and validation steps.

Port of `pharmaforge_tpu/training/train_state.py`: `train_step`
differentiates the masked diffusion loss and applies (or, with gradient
accumulation, accumulates) the Adam update at the learning rate given for
this step; `eval_step` computes the validation metrics with dropout off
and no gradient. The JAX package's `make_multi_train_step` scans K steps
inside one device call to amortize TPU dispatch, with per-step numerics
identical to the single step; the port's trainer runs them one by one.
"""

from __future__ import annotations

from typing import Dict

import torch

from pharmaforge_tpu_torch.data.batch import PharmComplexBatch
from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
from pharmaforge_tpu_torch.training.optim import Adam


def train_step(model: PharmacophoreDiffusion, optimizer: Adam,
               batch: PharmComplexBatch, generator: torch.Generator,
               lr: float) -> Dict[str, float]:
    """One optimizer step (one micro-batch under accumulation): loss in
    train mode, backward, update at `lr`. Returns the metrics as floats."""
    optimizer.zero_grad()
    total, aux = model.loss(batch, generator, train=True, phase="train")
    total.backward()
    optimizer.step(lr)
    return _floats(aux)


@torch.no_grad()
def eval_step(model: PharmacophoreDiffusion, batch: PharmComplexBatch,
              generator: torch.Generator) -> Dict[str, float]:
    """Validation metrics: dropout off, fresh diffusion noise."""
    _, aux = model.loss(batch, generator, train=False, phase="val")
    return _floats(aux)


def _floats(aux: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar metric tensors as floats, in one device-to-host copy."""
    vals = torch.stack([v.detach().float() for v in aux.values()]).tolist()
    return dict(zip(aux, vals))
