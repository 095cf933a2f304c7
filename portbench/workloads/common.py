"""What the workloads share: the configuration in the program's and the
reference's terms, the weights made from the seed, the program's model,
and the sampling comparison against the plain reference."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import traffic
from portbench.reference import chain as rc
from portbench.reference import model as rm

def n_ph_types(config: dict) -> int:
    """Pharmacophore types: the configuration's `ph_type_map`."""
    return len(config["dataset"]["ph_type_map"])


def n_elements(config: dict) -> int:
    """Receptor atom elements: the configuration's `prot_elements`."""
    return len(config["dataset"]["prot_elements"])


def reference_config(config: dict) -> dict:
    """The reference's settings from a configuration file."""
    m = config["model"]
    return {
        "n_hidden_scalars": m["n_hidden_scalars"],
        "vector_size": m["vector_size"], "pharm_nf": n_ph_types(config),
        "rec_nf": n_elements(config), "n_convs": m["n_convs"],
        "n_message_gvps": m["n_message_gvps"],
        "n_update_gvps": m["n_update_gvps"],
        "n_noise_gvps": m["n_noise_gvps"], "pf_k": m["pf_k"],
        "ff_cutoff": float(m["graph_cutoffs"]["ff"]),
        "pp_cutoff": float(m["graph_cutoffs"]["pp"]),
        "pp_k_max": m["pp_k_max"], "n_timesteps": m["n_timesteps"],
        "precision": m["precision"],
        "endpoint_param_coord": m["endpoint_param_coord"],
        "endpoint_param_feat": m["endpoint_param_feat"],
        "pharm_feat_norm_constant": m["pharm_feat_norm_constant"],
        "dropout": m["dropout"],
    }


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights, drawn on `device` from the run's seed."""
    gen = torch.Generator(device=device).manual_seed(traffic.derive(seed, 1))
    return rm.init_values(rm.skeleton(reference_config(config)), gen, device)


def program_model(config: dict, weights: Dict[str, torch.Tensor], device,
                  use: str):
    """The program's model at the configuration, holding `weights`, in the
    dtype the configuration states for `use` ("sampling", "training")."""
    from pharmaforge_tpu_torch.models.diffusion import (
        DiffusionConfig, PharmacophoreDiffusion)
    m = dict(config["model"], compute_dtype=config[use]["compute_dtype"])
    m["graph_cutoffs"] = tuple(sorted((k, float(v)) for k, v in
                                      m["graph_cutoffs"].items()))
    model = PharmacophoreDiffusion(DiffusionConfig(**m), device=device)
    model.load_state_dict(weights)
    return model


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on for "tensorfloat32", off otherwise, inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = precision == "tensorfloat32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_model(config: dict, weights, device, precision: str):
    """The plain reference holding `weights`; `precision` is "float32",
    a rounding of the edge chains ("bfloat16", "float8") or
    "tensorfloat32" (fp32 with TF32 matmuls, set by `matmul_precision`)."""
    edge = precision if precision in rm.ROUNDING else "float32"
    return rm.build(reference_config(config), weights, device, edge)


def pocket_tensors(pockets: Sequence[dict], slots: int, device):
    """Padded prot_x [N,P,3], one-hot prot_h [N,P,elements], mask [N,P]."""
    n = len(pockets)
    x = np.zeros((n, slots, 3), np.float32)
    h = np.zeros((n, slots, pockets[0]["prot_h"].shape[1]), np.float32)
    m = np.zeros((n, slots), bool)
    for i, p in enumerate(pockets):
        k = len(p["prot_x"])
        x[i, :k], h[i, :k], m[i, :k] = p["prot_x"], p["prot_h"], True
    return (torch.from_numpy(x).to(device), torch.from_numpy(h).to(device),
            torch.from_numpy(m).to(device))


def make_pockets(config: dict, gen: np.random.Generator,
                 sizes) -> List[dict]:
    """The traffic's pockets of `sizes` atoms, each with its one-hot
    elements as the configuration lists them."""
    n = n_elements(config)
    pockets = traffic.make_pockets(gen, sizes, n)
    for p in pockets:
        p["prot_h"] = traffic.one_hot(p["prot_elem"], n)
    return pockets


class Answer:
    """One sampled pharmacophore due in the window, as the program
    returned it: its pocket, its centre count, the seed and batch shape
    of its device call and its row there, and the program's dense output
    row (pharm_x [F,3], pharm_h [F,nf])."""

    def __init__(self, pocket, size, call_seed, batch, row, f, x, h):
        self.pocket, self.size = pocket, int(size)
        self.call_seed, self.batch, self.row, self.f = (
            int(call_seed), int(batch), int(row), int(f))
        self.x, self.h = np.asarray(x), np.asarray(h)


@torch.no_grad()
def reference_answers(config: dict, weights, answers: List[Answer],
                      device, precision: str = "float32"):
    """The reference's pharm_x / pharm_h for `answers`, each row's chain
    run from its call's noise (redrawn from the call's seed at the call's
    batch shape)."""
    cfg = reference_config(config)
    n_t = cfg["n_timesteps"]
    f = max(a.f for a in answers)
    slots = max(len(a.pocket["prot_x"]) for a in answers)
    prot_x, prot_h, prot_mask = pocket_tensors([a.pocket for a in answers],
                                               slots, device)
    fmask = torch.zeros(len(answers), f, dtype=torch.bool, device=device)
    for i, a in enumerate(answers):
        fmask[i, :a.size] = True
    noise = {k: [] for k in ("x_T", "h_T", "pos", "feat")}
    draws = {}
    for a in answers:
        key = (a.call_seed, a.batch, a.f)
        if key not in draws:
            draws[key] = rc.chain_noise(
                torch.Generator(device=device).manual_seed(a.call_seed),
                a.batch, a.f, cfg["pharm_nf"], n_t)
        d = draws[key]
        noise["x_T"].append(d["x_T"][a.row, :f])
        noise["h_T"].append(d["h_T"][a.row, :f])
        noise["pos"].append(d["pos"][:, a.row, :f])
        noise["feat"].append(d["feat"][:, a.row, :f])
    del draws
    noise = {k: torch.stack(v, dim=0 if k in ("x_T", "h_T") else 1)
             for k, v in noise.items()}
    com = rc.masked_com(prot_x, prot_mask)
    with matmul_precision(precision):
        model = reference_model(config, weights, device, precision)
        out = rc.sample(model, cfg, fmask, prot_x, prot_h, prot_mask, com,
                        noise)
    return {k: v.cpu().numpy() for k, v in out.items()}


def answer_gaps(answers: List[Answer], ref: dict) -> Dict[str, float]:
    """The gaps between the program's answers and the reference's over
    the valid centres: the widest coordinate gap (A) and feature gap, and
    the median over the answers of each answer's widest coordinate gap
    (a pf list that flips on a near tie moves one answer's coordinates
    further than rounding does, and that swings the widest gap)."""
    x_each, h_gap = [], 0.0
    for i, a in enumerate(answers):
        n = a.size
        x_each.append(float(np.abs(a.x[:n] - ref["pharm_x"][i, :n]).max()))
        h_gap = max(h_gap, float(np.abs(a.h[:n] - ref["pharm_h"][i, :n])
                                 .max()))
    return {"x_gap": max(x_each), "x_gap_median": float(np.median(x_each)),
            "h_gap": h_gap}


def pick(seed: int, key: int, n: int, k: int) -> List[int]:
    """k of range(n), drawn from the seed (all where k >= n)."""
    if k >= n:
        return list(range(n))
    return sorted(traffic.rng(seed, key).choice(n, size=k, replace=False)
                  .tolist())


def compare_answers(wl, precision: str = "float32") -> Dict[str, float]:
    """A sampling workload's numbers compared: its answers against the
    reference's (the reference in `precision`: the control's)."""
    answers = wl.answers()
    ref = reference_answers(wl.config, wl.weights, answers, wl.run.device,
                            precision)
    return answer_gaps(answers, ref)


def bound(n_bytes: int, n_ops: int, dtype: str, peaks: dict):
    """(least seconds, what bounds it) of work at the card's peaks."""
    t_bytes = n_bytes / peaks["bytes_per_s"]
    t_ops = n_ops / peaks["ops_per_s"][dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
