"""Train and validation steps.

Port of `pharmaforge_tpu/training/train_state.py`: `train_step`
differentiates the masked diffusion loss and applies (or, with gradient
accumulation, accumulates) the Adam update at the learning rate given for
this step; `eval_step` computes the validation metrics with dropout off
and no gradient. The JAX package's `make_multi_train_step` scans K steps
inside one device call to amortize TPU dispatch, with per-step numerics
identical to the single step; the port's trainer runs them one by one.

Under data parallelism (`rows`, see `PharmacophoreDiffusion.loss`) each
rank differentiates its share of the global loss and the gradients are
summed over the ranks before the update, so every rank applies the
global batch's update to identical parameters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from pharmaforge_tpu_torch.data.batch import PharmComplexBatch
from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
from pharmaforge_tpu_torch.parallel.mesh import all_reduce_grads
from pharmaforge_tpu_torch.training.optim import Adam


def train_step(model: PharmacophoreDiffusion, optimizer: Adam,
               batch: PharmComplexBatch, generator: torch.Generator,
               lr: float, rows: Optional[Tuple[int, int]] = None
               ) -> Dict[str, float]:
    """One optimizer step (one micro-batch under accumulation): loss in
    train mode, backward, update at `lr`. Returns the metrics as floats.
    With `rows` (this rank's slice of the global batch) the gradients are
    summed over the ranks before the update."""
    optimizer.zero_grad()
    total, aux = model.loss(batch, generator, train=True, phase="train",
                            rows=rows)
    total.backward()
    if rows is not None:
        all_reduce_grads(list(model.parameters()))
    optimizer.step(lr)
    return _floats(aux)


@torch.no_grad()
def eval_step(model: PharmacophoreDiffusion, batch: PharmComplexBatch,
              generator: torch.Generator,
              rows: Optional[Tuple[int, int]] = None) -> Dict[str, float]:
    """Validation metrics: dropout off, fresh diffusion noise; the global
    batch's with `rows`."""
    _, aux = model.loss(batch, generator, train=False, phase="val",
                        rows=rows)
    return _floats(aux)


def _floats(aux: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar metric tensors as floats, in one device-to-host copy."""
    vals = torch.stack([v.detach().float() for v in aux.values()]).tolist()
    return dict(zip(aux, vals))
