"""Geometric Vector Perceptron primitives.

Port of `pharmaforge_tpu/models/gvp.py`. Modules act on
`(scalars [..., S], vectors [..., V, 3])` pairs with any leading dims, so
one module serves nodes ([B, N, ...]) and edges ([B, N, K, ...]).

Parameter names follow the reference PyTorch layout (`Wh`, `Wu`,
`to_feats_out.0.*`, `scalar_to_vector_gates.*`, `feat_norm.*`), so
reference state dicts load with no key mapping. `reset_parameters_`
draws torch's default init from an explicit generator.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from pharmaforge_tpu_torch.ops.geometry import norm_no_nan
from pharmaforge_tpu_torch.ops.gvp_chain import (
    fused_gvp_chain,
    gvp_chain_reference,
    needs_grad,
)

GVPData = Tuple[torch.Tensor, torch.Tensor]


def _activation(name: str) -> nn.Module:
    if name == "silu":
        return nn.SiLU()
    if name == "sigmoid":
        return nn.Sigmoid()
    if name == "identity":
        return nn.Identity()
    raise ValueError(f"unknown activation {name!r}")


class GVP(nn.Module):
    """One geometric vector perceptron with vector gating (reference
    gvp.py:43-116)."""

    def __init__(self, dim_vectors_in: int, dim_vectors_out: int,
                 dim_feats_in: int, dim_feats_out: int,
                 hidden_vectors: Optional[int] = None,
                 feats_activation: str = "silu",
                 vectors_activation: str = "sigmoid"):
        super().__init__()
        dim_h = (max(dim_vectors_in, dim_vectors_out)
                 if hidden_vectors is None else hidden_vectors)
        self.Wh = nn.Parameter(torch.empty(dim_vectors_in, dim_h))
        self.Wu = nn.Parameter(torch.empty(dim_h, dim_vectors_out))
        self.to_feats_out = nn.Sequential(
            nn.Linear(dim_feats_in + dim_h, dim_feats_out),
            _activation(feats_activation))
        self.scalar_to_vector_gates = nn.Linear(dim_feats_out,
                                                dim_vectors_out)
        self.vectors_activation = _activation(vectors_activation)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for w in (self.Wh, self.Wu):
            bound = 1.0 / math.sqrt(w.shape[0])
            with torch.no_grad():
                w.uniform_(-bound, bound, generator=generator)

    def forward(self, data: GVPData) -> GVPData:
        """Runs in the dtype of `feats`: the weights are cast to it, the
        channel norms are taken in fp32 and cast back (the JAX package's
        bf16 edge-message chains, conv.py:229-236, 357)."""
        feats, vectors = data
        dt = feats.dtype
        vh = torch.einsum("...vc,vh->...hc", vectors, self.Wh.to(dt))
        vu = torch.einsum("...hc,hu->...uc", vh, self.Wu.to(dt))
        sh = norm_no_nan(vh.float()).to(dt)
        lin, act = self.to_feats_out
        feats_out = act(nn.functional.linear(
            torch.cat([feats, sh], dim=-1), lin.weight.to(dt),
            lin.bias.to(dt)))
        gates = self.scalar_to_vector_gates
        gating = nn.functional.linear(feats_out, gates.weight.to(dt),
                                      gates.bias.to(dt))
        return feats_out, self.vectors_activation(gating)[..., None] * vu


def run_gvps(gvps: Sequence[GVP], data: GVPData) -> GVPData:
    """The GVPs `gvps` applied in turn to `data`: one launch of the chain
    kernel (`ops/gvp_chain.py::fused_gvp_chain`, K4) where the tensors lie
    on the card and no gradient is needed (grad mode off, or nothing that
    enters the chain requires grad: sampling, validation), else the plain
    PyTorch chain (the CPU, training)."""
    feats, vectors = data
    if feats.is_cuda and not needs_grad(gvps, feats, vectors):
        return fused_gvp_chain(gvps, feats, vectors)
    return gvp_chain_reference(gvps, feats, vectors)


class GVPChain(nn.ModuleList):
    """GVPs applied in sequence (the reference's nn.Sequential of GVPs;
    children are named 0, 1, ...), through `run_gvps`."""

    def __init__(self, specs: Sequence[dict]):
        super().__init__([GVP(**spec) for spec in specs])

    def forward(self, data: GVPData) -> GVPData:
        return run_gvps(list(self), data)


def gvp_specs(n: int, vector_size: int, scalar_size: int) -> list:
    """`n` square GVP specs (silu scalars, sigmoid gates) -- the update
    chains."""
    return [dict(dim_vectors_in=vector_size, dim_vectors_out=vector_size,
                 dim_feats_in=scalar_size, dim_feats_out=scalar_size)
            for _ in range(n)]


# (first row, rows of the global batch) while this process holds a slice
# of a global batch (`batch_rows`); None otherwise
_BATCH_ROWS: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def batch_rows(start: int, n_global: int):
    """Inside the block the tensors hold rows start.. of a global batch of
    `n_global` rows (data parallelism): `GVPDropout` draws its masks at the
    global batch shape and keeps those rows, so the masks do not depend on
    how the batch is split."""
    global _BATCH_ROWS
    saved, _BATCH_ROWS = _BATCH_ROWS, (int(start), int(n_global))
    try:
        yield
    finally:
        _BATCH_ROWS = saved


def _rand(shape, generator, device) -> torch.Tensor:
    """torch.rand of `shape` ([B, ...]), drawn at the global batch shape
    inside `batch_rows`."""
    if _BATCH_ROWS is None:
        return torch.rand(shape, generator=generator, device=device)
    start, n = _BATCH_ROWS
    return torch.rand((n,) + tuple(shape[1:]), generator=generator,
                      device=device)[start:start + shape[0]]


class GVPDropout(nn.Module):
    """Scalar dropout plus whole-3-vector dropout (reference
    gvp.py:118-149, JAX gvp.py `gvp_dropout`); the identity in eval mode.
    Both masks are drawn from the explicit `generator` (which must lie on
    the tensors' device): the scalar mask over `feats`, then one keep flag
    per 3-vector. Inside `batch_rows` both are drawn at the global batch
    shape."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, feats: torch.Tensor, vectors: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> GVPData:
        if not self.training or self.rate == 0.0:
            return feats, vectors
        if generator is None:
            raise ValueError("GVPDropout in train mode needs a generator")
        keep = 1.0 - self.rate
        feat_mask = _rand(feats.shape, generator, feats.device) < keep
        feats = torch.where(feat_mask, feats / keep, 0.0)
        vec_mask = _rand(vectors.shape[:-1], generator,
                         vectors.device) < keep
        return feats, vectors * vec_mask[..., None] / keep


class GVPLayerNorm(nn.Module):
    """LayerNorm on scalars and a parameter-free norm on vectors:
    v / (sqrt(mean_channels(|v|^2) + eps) + eps) (reference
    gvp.py:152-166)."""

    def __init__(self, feats_h_size: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.feat_norm = nn.LayerNorm(feats_h_size, eps=eps)

    def forward(self, feats: torch.Tensor, vectors: torch.Tensor
                ) -> GVPData:
        vn = norm_no_nan(vectors, dim=-1, keepdim=True, sqrt=False)
        vn = torch.sqrt(torch.mean(vn, dim=-2, keepdim=True) + self.eps) \
            + self.eps
        return self.feat_norm(feats), vectors / vn


def reset_parameters_(module: nn.Module, generator: torch.Generator
                      ) -> nn.Module:
    """Re-draw every parameter under `module` with torch's default init
    from `generator`: Linear weight and bias U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)), GVP Wh/Wu likewise, LayerNorm ones and zeros."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, GVP):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
    return module
