"""Hyperparameter CLI flags and YAML-config merging.

Copy of `pharmaforge_tpu/config/cmdline.py` (reference
config_utils/cmdline.py:4-164), kept here so the port imports nothing
from the JAX package: one declarative table, each row a flag, its
argparse group, its type and the dotted config path it overrides. The
YAML config is the source of truth; a flag takes effect only when given
on the command line.

The reference's vestigial flags (accepted but never read downstream:
--h_skip_connections, --agg_across_edge_types, --dynamics_rec_enc_multiplier,
--use_tanh, --max_fake_atom_frac, --architecture, --pp_k) are kept for CLI
compatibility; those with a config destination in the reference are
recorded into the config the same way, the rest are parse-only.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional, Sequence


def _strtobool(val: str) -> int:
    val = val.lower()
    if val in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if val in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {val!r}")


def _parse_use_tanh(val: str) -> int:
    if val not in ("True", "False"):
        raise ValueError()
    return _strtobool(val)


def _parse_message_norm(val: str):
    # bare decimals mean a constant normalizer; keywords pass through
    return float(val) if val.isdecimal() else val


def _check_feature_norm(val: int) -> int:
    if val not in (0, 1):
        raise ValueError("feature_norm must be 0 or 1")
    return val


@dataclasses.dataclass(frozen=True)
class Flag:
    """One CLI override: flag name -> dotted path into the config dict."""

    name: str
    type: Callable
    path: Optional[Sequence[str]]  # None = parse/validate only, never stored
    group: Optional[str] = None
    help: Optional[str] = None
    convert: Optional[Callable] = None  # applied to the value before storing


FLAGS: tuple[Flag, ...] = (
    # --- diffusion ---------------------------------------------------------
    Flag("precision", float, ("diffusion", "precision"), group="diffusion"),
    Flag("feat_norm_constant", float,
         ("diffusion", "pharm_feat_norm_constant"), group="diffusion"),
    Flag("pf_dist_threshold", float, ("diffusion", "pf_dist_threshold"),
         group="diffusion",
         help="distance threshold for protein-pharmacophore loss function"),
    Flag("remove_com", bool, ("diffusion", "remove_com"), group="diffusion"),
    Flag("endpoint_param_feat", bool, ("diffusion", "endpoint_param_feat"),
         group="diffusion"),
    Flag("endpoint_param_coord", bool, ("diffusion", "endpoint_param_coord"),
         group="diffusion"),
    Flag("n_timesteps", int, ("diffusion", "n_timesteps"), group="diffusion"),
    # --- dynamics ----------------------------------------------------------
    Flag("vector_size", int, ("dynamics", "vector_size"), group="dynamics"),
    Flag("n_convs", int, ("dynamics", "n_convs"), group="dynamics",
         help="number of graph convolutions in the dynamics model"),
    Flag("n_hidden_scalars", int, ("dynamics", "n_hidden_scalars"),
         group="dynamics"),
    Flag("dropout", float, ("dynamics", "dropout"), group="dynamics"),
    Flag("h_skip_connections", bool, ("dynamics", "h_skip_connections"),
         group="dynamics"),
    Flag("agg_across_edge_types", bool, ("dynamics", "agg_across_edge_types"),
         group="dynamics"),
    Flag("dynamics_rec_enc_multiplier", int, None, group="dynamics"),
    # --- training ----------------------------------------------------------
    Flag("max_epochs", int, ("training", "trainer_args", "max_epochs"),
         group="training", help="Max number of epochs to train model for"),
    Flag("pf_hinge_loss_weight", float, ("training", "pf_hinge_loss_weight"),
         group="training",
         help="weight applied to protein-pharmacophore hinge loss"),
    Flag("lr", float, ("training", "learning_rate"), group="training",
         help="base learning rate"),
    Flag("weight_decay", float, ("training", "weight_decay"),
         group="training"),
    Flag("clip_value", float, ("training", "clip_value"), group="training",
         help="max gradient value for clipping"),
    Flag("batch_size", int, ("training", "batch_size"), group="training"),
    Flag("warmup_length", float, ("training", "scheduler", "warmup_length"),
         group="training"),
    Flag("restart_interval", float,
         ("training", "scheduler", "restart_interval"), group="training"),
    Flag("restart_type", str, ("training", "scheduler", "restart_type"),
         group="training"),
    # --- ungrouped ---------------------------------------------------------
    Flag("feature_norm", int, None, convert=_check_feature_norm),
    Flag("ff_cutoff", float, ("graph", "graph_cutoffs", "ff")),
    Flag("pf_cutoff", float, ("graph", "graph_cutoffs", "pf")),
    Flag("pp_cutoff", float, ("graph", "graph_cutoffs", "pp")),
    Flag("fp_cutoff", float, ("graph", "graph_cutoffs", "fp")),
    Flag("ff_k", int, ("dynamics", "ff_k")),
    Flag("pf_k", int, ("dynamics", "pf_k")),
    Flag("pp_k", int, None),
    Flag("max_fake_atom_frac", float, ("dataset", "max_fake_atom_frac")),
    Flag("use_tanh", str, ("dynamics", "use_tanh"),
         convert=_parse_use_tanh),
    Flag("message_norm", str, ("dynamics", "message_norm"),
         convert=_parse_message_norm),
    Flag("exp_name", str, ("experiment", "name")),
    Flag("architecture", str, None),
)


def register_hyperparameter_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Add every flag in FLAGS to the parser, grouped as in the reference."""
    groups: dict[Optional[str], argparse._ActionsContainer] = {None: p}
    for flag in FLAGS:
        if flag.group not in groups:
            groups[flag.group] = p.add_argument_group(flag.group)
        groups[flag.group].add_argument(
            f"--{flag.name}", type=flag.type, default=None, help=flag.help)
    return p


def merge_config_and_args(config: dict, args: argparse.Namespace) -> dict:
    """Overlay explicitly-provided CLI flags onto the YAML config."""
    provided = vars(args)
    for flag in FLAGS:
        value = provided.get(flag.name)
        if value is None:
            continue
        if flag.convert is not None:
            value = flag.convert(value)
        if flag.path is None:
            continue  # parse-only flag (validated above, never stored)
        node = config
        for key in flag.path[:-1]:
            node = node.setdefault(key, {})
        node[flag.path[-1]] = value
    return config


class ArgumentParser(argparse.ArgumentParser):
    """argparse's parser, raising `ValueError` on a bad command line where
    argparse would exit the process, so a CLI's `main` can run inside
    another program."""

    def error(self, message: str):
        raise ValueError(f"{self.prog}: {message}")
