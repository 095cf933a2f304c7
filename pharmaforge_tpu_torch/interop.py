"""Carry weights into the port.

The port's module tree has the reference PyTorch state-dict layout
(`dynamics.noise_predictor.conv_layers.{i}.edge_message_fns.{etype}.{j}.Wh`,
...), so:

* `load_reference_state_dict` loads a reference-layout state dict (a
  reference checkpoint's, or the `sd::` arrays of the golden fixtures)
  with no key mapping;
* `params_from_jax` turns the JAX package's Flax param tree (as numpy)
  into the port's state dict through a copy of the JAX package's
  reference<->Flax key map (`pharmaforge_tpu/interop/torch_import.py`).

Torch Linear weights are [out, in] and Flax kernels [in, out]; GVP Wh/Wu
are [in, out] on both sides; LayerNorm weight <-> scale. The final conv's
dead prot tail has no parameters in the port, and its reference keys are
skipped.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)

# GVP leaf: reference key -> (Flax key, transpose?)
GVP_LEAVES = {
    "Wh": ("Wh", False),
    "Wu": ("Wu", False),
    "to_feats_out.0.weight": ("to_feats_out.kernel", True),
    "to_feats_out.0.bias": ("to_feats_out.bias", False),
    "scalar_to_vector_gates.weight": ("scalar_to_vector_gates.kernel", True),
    "scalar_to_vector_gates.bias": ("scalar_to_vector_gates.bias", False),
}

ETYPE_KEYS = ("pharm_ff_pharm", "prot_pf_pharm", "pharm_fp_prot",
              "prot_pp_prot")


def key_map(n_convs: int, n_message_gvps: int, n_update_gvps: int,
            n_noise_gvps: int, prune_dead_prot_tail: bool
            ) -> Dict[str, tuple]:
    """Reference state-dict key -> (flattened Flax key, transpose?)."""
    mapping: Dict[str, tuple] = {}
    for enc in ("pharm_encoder", "prot_encoder"):
        mapping[f"dynamics.{enc}.0.weight"] = (f"{enc}.linear.kernel", True)
        mapping[f"dynamics.{enc}.0.bias"] = (f"{enc}.linear.bias", False)
        mapping[f"dynamics.{enc}.2.weight"] = (f"{enc}.norm.scale", False)
        mapping[f"dynamics.{enc}.2.bias"] = (f"{enc}.norm.bias", False)

    for i in range(n_convs):
        last = i == n_convs - 1
        tprefix = f"dynamics.noise_predictor.conv_layers.{i}"
        fprefix = f"conv_layers_{i}"
        for ek in ETYPE_KEYS:
            if last and prune_dead_prot_tail and ek.endswith("_prot"):
                continue
            for j in range(n_message_gvps):
                for tk, (fk, tr) in GVP_LEAVES.items():
                    mapping[f"{tprefix}.edge_message_fns.{ek}.{j}.{tk}"] = (
                        f"{fprefix}.edge_message_fns_{ek}.layers_{j}.{fk}",
                        tr)
        for nt in ("pharm", "prot"):
            if last and prune_dead_prot_tail and nt == "prot":
                continue
            for j in range(n_update_gvps):
                for tk, (fk, tr) in GVP_LEAVES.items():
                    mapping[f"{tprefix}.node_update_fns.{nt}.{j}.{tk}"] = (
                        f"{fprefix}.node_update_fns_{nt}.layers_{j}.{fk}",
                        tr)
            for ln in ("message_layer_norms", "update_layer_norms"):
                mapping[f"{tprefix}.{ln}.{nt}.feat_norm.weight"] = (
                    f"{fprefix}.{ln}_{nt}.feat_norm.scale", False)
                mapping[f"{tprefix}.{ln}.{nt}.feat_norm.bias"] = (
                    f"{fprefix}.{ln}_{nt}.feat_norm.bias", False)

    head = "dynamics.noise_predictor.noise_predictor"
    for j in range(n_noise_gvps):
        for tk, (fk, tr) in GVP_LEAVES.items():
            mapping[f"{head}.gvps.{j}.{tk}"] = (
                f"noise_predictor.gvps.layers_{j}.{fk}", tr)
    mapping[f"{head}.to_scalar_output.weight"] = (
        "noise_predictor.to_scalar_output.kernel", True)
    mapping[f"{head}.to_scalar_output.bias"] = (
        "noise_predictor.to_scalar_output.bias", False)
    return mapping


def _config_key_map(cfg: DiffusionConfig) -> Dict[str, tuple]:
    return key_map(cfg.n_convs, cfg.n_message_gvps, cfg.n_update_gvps,
                   cfg.n_noise_gvps, cfg.prune_dead_prot_tail)


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a.b.c': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def params_from_jax(params: Mapping, cfg: DiffusionConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax param tree (numpy leaves) for `cfg` -> the
    port's state dict."""
    flat = flatten(params)
    out = {}
    for tkey, (fkey, transpose) in _config_key_map(cfg).items():
        arr = np.asarray(flat[fkey], dtype=np.float32)
        out[tkey] = torch.from_numpy((arr.T if transpose else arr).copy())
    return out


def load_reference_state_dict(state_dict: Mapping, cfg: DiffusionConfig,
                              device=None) -> PharmacophoreDiffusion:
    """A `PharmacophoreDiffusion` for `cfg` on `device` holding the weights
    of a reference-layout state dict (numpy or torch values). Keys the
    port has no parameter for -- the final conv's dead prot tail, the
    saved noise schedule -- are skipped; a missing key raises."""
    model = PharmacophoreDiffusion(cfg, device="cpu")
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict]
    if missing:
        raise KeyError(f"reference state dict lacks {len(missing)} keys, "
                       f"e.g. {missing[:3]}")
    model.load_state_dict({
        k: torch.as_tensor(np.asarray(state_dict[k], np.float32))
        for k in own})
    return model.to(resolve_device(device))
