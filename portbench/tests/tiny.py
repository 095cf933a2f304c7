"""Cells of the benchmark at a size the CPU runs in seconds: the cell's
own workload, traffic kind and comparison, with narrow widths, short
chains and small pockets."""

from __future__ import annotations

import copy
import json

from portbench import manifest

TINY_MODEL = {"n_hidden_scalars": 16, "vector_size": 4, "n_timesteps": 4}
TINY_TRAFFIC = {
    "sample_stacked": {"pockets_per_call": 2, "samples_per_pocket": 3,
                       "pocket_atoms": [40, 40], "pocket_pool": 3,
                       "prot_slots": 64, "check_calls": 2},
    "sample_pocket": {"samples": 3, "pocket_atoms": [30, 70],
                      "pocket_pool": 4, "trace_calls": 2, "check_calls": 2},
    "train_call": {"batch_size": 4, "steps_per_call": 2,
                   "train_split_samples": 8, "val_samples": 4,
                   "pocket_atoms": [40, 40], "trace_calls": 1},
}


def shrink(config: dict, traffic: dict):
    config = copy.deepcopy(config)
    config["model"].update(TINY_MODEL)
    return config, dict(traffic, **TINY_TRAFFIC[traffic["kind"]])


def cell(name: str, limit: float = 1e30) -> manifest.Cell:
    """Cell `name` of BENCHMARK.json, shrunk; every limit `limit`."""
    full = manifest.Cell.find(manifest.load_manifest(), name)
    config, traffic = shrink(full.config, full.traffic)
    limits = {k: {"limit": limit} for k in full.limits}
    m = manifest.load_manifest()
    return manifest.Cell(name, full.entry, config, traffic, limits,
                         m["end_to_end"], m["per_layer"])


def unlisted(config: str, traffic: str, limits: dict,
             end_to_end: list) -> manifest.Cell:
    """A shrunk cell of `configs/<config>.json` under
    `traffic/<traffic>.json`, a pair BENCHMARK.json does not list yet,
    with the given limits and end-to-end metrics and no per-layer ones."""
    cfg, mix = shrink(
        manifest.read_json(manifest.ROOT / "configs" / f"{config}.json"),
        manifest.read_json(manifest.ROOT / "traffic" / f"{traffic}.json"))
    entry = {"name": f"{config}.{traffic}", "config": config,
             "traffic": traffic, "chips": 1}
    return manifest.Cell(entry["name"], entry, cfg, mix, limits,
                         end_to_end, [])


def dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True)
