"""Carry weights into the port.

The port's module tree has the reference PyTorch state-dict layout
(`dynamics.noise_predictor.conv_layers.{i}.edge_message_fns.{etype}.{j}.Wh`,
...), so:

* `load_reference_state_dict` loads a reference-layout state dict (a
  reference checkpoint's, or the `sd::` arrays of the golden fixtures)
  with no key mapping;
* `params_from_jax` turns the JAX package's Flax param tree (as numpy)
  into the port's state dict through a copy of the JAX package's
  reference<->Flax key map (`pharmaforge_tpu/interop/torch_import.py`);
* `load_torch_checkpoint` and `model_from_torch_checkpoint` serve a
  reference PyTorch-Lightning `.ckpt` file (the config from its
  `hyper_parameters`, the saved noise schedule checked against the
  port's), and `export_reference_checkpoint` writes a port run as one.

Torch Linear weights are [out, in] and Flax kernels [in, out]; GVP Wh/Wu
are [in, out] on both sides; LayerNorm weight <-> scale. The final conv's
dead prot tail has no parameters in the port, and its reference keys are
skipped.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.constants import PH_IDX_TO_TYPE
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.models.schedules import make_gamma_table

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


def config_from_hyper_parameters(hparams: dict) -> DiffusionConfig:
    """A reference PL `hyper_parameters` dict -> DiffusionConfig (JAX
    `interop/torch_import.py:146`). The reference saves its constructor's
    keyword arguments (pharmacodiff.py:78): top-level diffusion keys and
    the nested `graph_config` (= config['graph']) and `dynamics_config`
    (= config['dynamics']). Keys the reference itself ignores are ignored.
    A checkpoint trained under another pharmacophore type order raises:
    it would load and decode every type under the wrong name."""
    tmap = hparams.get("ph_type_map")
    if tmap is not None and list(tmap) != list(PH_IDX_TO_TYPE):
        raise ValueError(
            f"checkpoint ph_type_map {list(tmap)} does not match this "
            f"framework's canonical ordering {list(PH_IDX_TO_TYPE)}; "
            f"serving it would permute pharmacophore-type semantics")
    kwargs = {}
    for k in ("pharm_nf", "rec_nf", "n_timesteps", "precision",
              "pharm_feat_norm_constant", "endpoint_param_feat",
              "endpoint_param_coord", "weighted_loss", "remove_com"):
        if k in hparams:
            kwargs[k] = hparams[k]
    dynamics = hparams.get("dynamics_config") or {}
    for k in ("vector_size", "n_convs", "n_hidden_scalars", "message_norm",
              "n_message_gvps", "n_update_gvps", "n_noise_gvps", "dropout",
              "ff_k", "pf_k"):
        if k in dynamics:
            kwargs[k] = dynamics[k]
    cutoffs = (hparams.get("graph_config") or {}).get("graph_cutoffs")
    if cutoffs:
        kwargs["graph_cutoffs"] = tuple(
            (str(k), float(v)) for k, v in dict(cutoffs).items())
    return DiffusionConfig(**kwargs)


def _check_gamma_table(state: Mapping, cfg: DiffusionConfig,
                       atol: float = 1e-6) -> None:
    """Hold a checkpoint's saved noise schedule (`gamma.gamma`, where
    present) to the table the port builds for `cfg` (JAX
    `torch_import.py:194`): a mismatch means the weights would run under
    the wrong schedule."""
    saved = state.get("gamma.gamma")
    if saved is None:
        return
    ours = make_gamma_table(cfg.noise_schedule, cfg.n_timesteps,
                            precision=cfg.precision)
    saved = np.asarray(saved, np.float64).reshape(-1)
    if saved.shape != np.asarray(ours).shape:
        raise ValueError(
            f"checkpoint gamma table has {saved.shape[0] - 1} timesteps but "
            f"the config says n_timesteps={cfg.n_timesteps}")
    if not np.allclose(saved, ours, atol=atol):
        raise ValueError(
            f"checkpoint gamma table does not match the "
            f"{cfg.noise_schedule} schedule at precision={cfg.precision} "
            f"(max abs diff {np.abs(saved - ours).max():.3e})")


def _read_checkpoint(path) -> dict:
    """A PL `.ckpt` file as torch.load gives it. The file holds pickled
    Python objects (`weights_only=False`, as the JAX package loads it):
    load only checkpoints you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _state_of(ckpt: Mapping, cfg: DiffusionConfig
              ) -> Dict[str, torch.Tensor]:
    """The port's state dict for `cfg` from a loaded checkpoint, its
    noise schedule checked first."""
    state = {k: v.detach().cpu().numpy()
             for k, v in ckpt.get("state_dict", ckpt).items()
             if isinstance(v, torch.Tensor)}
    _check_gamma_table(state, cfg)
    out = {}
    for k in _config_key_map(cfg):
        if k not in state:
            raise KeyError(f"reference checkpoint missing key {k}")
        out[k] = torch.from_numpy(np.asarray(state[k], np.float32))
    return out


def load_torch_checkpoint(path, cfg: DiffusionConfig
                          ) -> Dict[str, torch.Tensor]:
    """The weights of a reference PL `.ckpt` file as the port's state dict
    for `cfg` (CPU float32 tensors; JAX `torch_import.py:218`). The
    saved noise schedule, where present, must match `cfg`'s."""
    return _state_of(_read_checkpoint(path), cfg)


def model_from_torch_checkpoint(path, device=None) -> PharmacophoreDiffusion:
    """A reference PL `.ckpt` file served as it is: the model built from
    its `hyper_parameters`, holding its weights, on `device` (CUDA by
    default; JAX `torch_import.py:229`, the reference's
    `load_from_checkpoint`)."""
    ckpt = _read_checkpoint(path)
    hparams = ckpt.get("hyper_parameters")
    if hparams is None:
        raise ValueError(
            f"{path} has no 'hyper_parameters' entry; pass an explicit "
            f"config to load_torch_checkpoint instead")
    cfg = config_from_hyper_parameters(dict(hparams))
    return load_reference_state_dict(_state_of(ckpt, cfg), cfg, device)


def _reference_hyper_parameters(cfg: DiffusionConfig, config: dict) -> dict:
    """`hyper_parameters` shaped like the reference constructor's keyword
    arguments (pharmacodiff.py:27-78) for a run of `cfg` under the
    merged `config` (as `scripts/export_torch_ckpt.py` writes them)."""
    dataset = config.get("dataset", {})
    return {
        "pharm_nf": cfg.pharm_nf,
        "rec_nf": cfg.rec_nf,
        "ph_type_map": dataset.get("ph_type_map", list(PH_IDX_TO_TYPE)),
        "processed_data_dir": dataset.get("processed_data_dir", ""),
        "n_timesteps": cfg.n_timesteps,
        "graph_config": config.get("graph", {}),
        "dynamics_config": {
            "vector_size": cfg.vector_size,
            "n_convs": cfg.n_convs,
            "n_hidden_scalars": cfg.n_hidden_scalars,
            "message_norm": cfg.message_norm,
            "dropout": cfg.dropout,
            "ff_k": cfg.ff_k,
            "pf_k": cfg.pf_k,
            "n_message_gvps": cfg.n_message_gvps,
            "n_update_gvps": cfg.n_update_gvps,
            "n_noise_gvps": cfg.n_noise_gvps,
        },
        "lr_scheduler_config": config.get("lr_scheduler", {}),
        "precision": cfg.precision,
        "pharm_feat_norm_constant": cfg.pharm_feat_norm_constant,
        "endpoint_param_feat": cfg.endpoint_param_feat,
        "endpoint_param_coord": cfg.endpoint_param_coord,
        "weighted_loss": cfg.weighted_loss,
        "remove_com": cfg.remove_com,
        "batch_size": config.get("training", {}).get("batch_size", 64),
    }


def export_reference_checkpoint(run_dir, which: str = "last",
                                out: Optional[Path] = None) -> Path:
    """Write checkpoint `which` of a port run as a reference-layout PL
    `.ckpt` (the counterpart of `scripts/export_torch_ckpt.py`): the
    weights as `state_dict`, the noise schedule as `gamma.gamma`, and
    `hyper_parameters` shaped like the reference constructor's keyword
    arguments. By default it goes to
    `<run_dir>/checkpoints/exported_reference.ckpt`, where `--ckpt`
    finds the run dir (its parent's parent). Returns the path."""
    from pharmaforge_tpu_torch.training.restore import load_model
    model, config = load_model(run_dir, which, device="cpu")
    cfg = model.config
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state["gamma.gamma"] = torch.from_numpy(np.asarray(make_gamma_table(
        cfg.noise_schedule, cfg.n_timesteps, precision=cfg.precision)))
    ckpt = {"pytorch-lightning_version": "2.1.0", "state_dict": state,
            "hyper_parameters": _reference_hyper_parameters(cfg, config)}
    if out is None:
        ckpt_dir = Path(run_dir) / "checkpoints"
        ckpt_dir.mkdir(exist_ok=True)
        out = ckpt_dir / "exported_reference.ckpt"
    out = Path(out)
    torch.save(ckpt, out)
    return out
