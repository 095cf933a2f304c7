"""Host-level batched sampling orchestration.

Port of `pharmaforge_tpu/training/sampling.py::PocketSampler`: pockets are
tiled into dense batches (`data.batch.tile_pocket`), chunked by
`max_batch_size`, run through the reverse chain on the device (on the card
as replays of CUDA graphs, `models/diffusion.py::ChainGraphs`: one device
program per chain, no host round trip between steps), and split back
into `SampledPharmacophore` objects that carry their pocket's
receptor sites for the validity metric. Random draws come from an explicit
`torch.Generator`. Grouped batches probe the pocket-copy correction's
`pp_k_out` once per device call (`probe_pp_k_out`).

Spans (`utils/trace.py`): each device call of `sample_stacked`, and each
chunk of `sample_pocket`, is one root span "sampler.call" holding
"sampler.tile" (tiling, stacking, centres of mass), "sampler.probe",
the chain's spans (`PharmacophoreDiffusion.sample_given_receptor`) and
"sampler.split" (`SampledPharmacophore.from_batch`).

Inside a process group of N ranks (`parallel/mesh.py`) a device batch is
split into N contiguous row blocks where each block is whole pocket groups
or an equal part of one (JAX sampling.py:178-192, 271-281: the copies of
one pocket, or whole pockets of a stacked sweep), and otherwise runs
whole on every rank. Every rank draws the chain's noise at the global
batch shape and keeps its rows, so N ranks sample what one rank samples;
the rows are gathered back on every rank. Each rank captures its own
chain on its own device; no collective runs inside a chain (the gather
follows it). As in JAX, the pocket-copy correction is off with more than
one rank.
"""

from __future__ import annotations

import dataclasses
import os
from math import ceil
from typing import List, Optional, Sequence

import numpy as np
import torch

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.analysis.pharm_builder import SampledPharmacophore
from pharmaforge_tpu_torch.constants import PH_IDX_TO_TYPE
from pharmaforge_tpu_torch.data.batch import (
    DEFAULT_MAX_PHARM,
    concat_batches,
    tile_pocket,
)
from pharmaforge_tpu_torch.models.conv import message_norm_is_dynamic
from pharmaforge_tpu_torch.models.diffusion import (
    PharmacophoreDiffusion,
    draw_chain_noise,
)
from pharmaforge_tpu_torch.models.edges import (
    build_pp_edge,
    max_pp_out_degree,
)
from pharmaforge_tpu_torch.parallel.mesh import all_gather_object, rank, world
from pharmaforge_tpu_torch.utils import trace


def probe_pp_k_out(model: PharmacophoreDiffusion, prot_x_g,
                   prot_mask_g) -> int:
    """`pp_k_out` for the pocket-copy correction (JAX sampling.py:27): the
    pp graph's maximum out-degree over the pocket-group representatives
    (prot_x_g [G,P,3], prot_mask_g [G,P]), rounded up to a multiple of 8
    and at least 8. Returns 0 (correction off) where it cannot engage:
    fewer than 4 convs, no knn pf, a dynamic message norm, `fused_pp` off,
    `PHARMAFORGE_PP_CORR=0`, or, a guard the JAX probe lacks, the compact
    prot tail off (the correction runs only on top of it)."""
    cfg = model.config
    if os.environ.get("PHARMAFORGE_PP_CORR", "1") == "0":
        return 0
    if cfg.n_convs < 4 or not cfg.pf_k or cfg.pf_k <= 0:
        return 0
    if message_norm_is_dynamic(cfg.message_norm) or not cfg.fused_pp:
        return 0
    if not (cfg.compact_prot_tail and cfg.prune_dead_prot_tail):
        return 0
    dev = model.device
    _, ed = build_pp_edge(
        torch.as_tensor(np.asarray(prot_x_g, np.float32), device=dev),
        torch.as_tensor(np.asarray(prot_mask_g, bool), device=dev),
        float(model.cutoffs["pp"]), int(cfg.pp_k_max))
    return max(8, -(-max_pp_out_degree(ed) // 8) * 8)


def _site_types(pocket: dict):
    """(receptor site positions, their type names) of a pocket dict."""
    pos = pocket.get("prot_ph_x")
    if pos is None or not len(pos):
        return pos, None
    idxs = np.asarray(pocket["prot_ph_h"]).argmax(axis=1)
    return pos, [PH_IDX_TO_TYPE[int(i)] for i in idxs]


class PocketSampler:

    def __init__(self, model: PharmacophoreDiffusion,
                 pharm_type_map: Optional[List[str]] = None,
                 prot_bucket_multiple: int = 64,
                 fixed_prot_slots: Optional[int] = None,
                 device=None):
        """Runs `model` on `device` (CUDA by default; raises without CUDA
        unless a device is named). `fixed_prot_slots` pads every pocket to
        one prot slot count, which lets `sample` stack a multi-pocket
        sweep into one device batch."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.pharm_type_map = pharm_type_map or PH_IDX_TO_TYPE
        self.prot_bucket_multiple = prot_bucket_multiple
        self.fixed_prot_slots = fixed_prot_slots
        # dense output of the last device call (numpy), for inspection
        self.last_output: Optional[dict] = None

    def _pp_k_out(self, batch, group: int) -> int:
        """`probe_pp_k_out` over the batch's pocket-group representatives;
        0 for ungrouped batches and with more than one rank (JAX
        sampling.py:108-113)."""
        if group <= 1 or world() > 1:
            return 0
        with trace.span("sampler.probe"):
            return probe_pp_k_out(self.model, batch.prot_x[::group],
                                  batch.prot_mask[::group])

    @staticmethod
    def _rank_group(b: int, group: int) -> int:
        """The pocket group size within each rank's rows of a batch of `b`
        rows, or 0 where the rows do not split over the ranks: each rank's
        rows must be whole groups or an equal part of one."""
        n = world()
        if n <= 1 or b % n:
            return 0
        per = b // n
        if per % group == 0:
            return group
        return per if group % per == 0 else 0

    def _run(self, batch, generator, com, group: int,
             visualize: bool = False) -> dict:
        """One device call: the chain of `batch` (this rank's rows of it
        inside a process group), its outputs on the host."""
        b = batch.batch_size
        local_group = self._rank_group(b, group)
        if not local_group:
            out = self.model.sample_given_receptor(
                batch, generator=generator, init_pharm_com=com,
                visualize_trajectory=visualize, pocket_group_size=group,
                pp_k_out=self._pp_k_out(batch, group), to_host=True)
        else:
            # the global batch's draws, this rank's rows of everything
            per = b // world()
            rows = slice(rank() * per, (rank() + 1) * per)
            noise = draw_chain_noise(
                generator, b, batch.pharm_mask.shape[1],
                self.model.config.pharm_nf, self.model.config.n_timesteps)
            noise = {k: v[rows] if v.dim() == 3 else v[:, rows]
                     for k, v in noise.items()}
            mine = type(batch)(**{f.name: getattr(batch, f.name)[rows]
                                  for f in dataclasses.fields(batch)})
            out = self.model.sample_given_receptor(
                mine, noise=noise, init_pharm_com=np.asarray(com)[rows],
                visualize_trajectory=visualize,
                pocket_group_size=local_group, pp_k_out=0, to_host=True)
            parts = all_gather_object(out)
            out = {k: np.concatenate([p[k] for p in parts],
                                     axis=1 if k.startswith("traj") else 0)
                   for k in parts[0]}
        self.last_output = out
        return out

    def sample_pocket(self, pocket: dict, pharm_sizes: Sequence[int],
                      generator: Optional[torch.Generator] = None,
                      max_batch_size: int = 32,
                      init_pharm_com: Optional[np.ndarray] = None,
                      visualize_trajectory: bool = False
                      ) -> List[SampledPharmacophore]:
        """len(pharm_sizes) pharmacophores for one pocket (a dataset sample
        dict: prot_x, prot_h, optional prot_ph_x/prot_ph_h). Sizes are
        sliced per chunk; every chunk is padded to one batch size."""
        n_total = len(pharm_sizes)
        n_chunks = ceil(n_total / max_batch_size)
        prot_ph_pos, prot_ph_types = _site_types(pocket)
        results: List[SampledPharmacophore] = []
        for c in range(n_chunks):
            chunk = list(pharm_sizes[c * max_batch_size:
                                     (c + 1) * max_batch_size])
            n_real = len(chunk)
            pad_sizes = chunk + [3] * (max_batch_size - n_real) \
                if n_chunks > 1 else chunk
            with trace.span("sampler.call"):
                with trace.span("sampler.tile"):
                    batch = tile_pocket(
                        pocket["prot_x"], pocket["prot_h"], pad_sizes,
                        n_pharm_feats=self.model.config.pharm_nf,
                        max_pharm=max(DEFAULT_MAX_PHARM, max(pad_sizes)),
                        max_prot=self.fixed_prot_slots,
                        prot_bucket_multiple=self.prot_bucket_multiple)
                    if init_pharm_com is not None:
                        com = np.broadcast_to(
                            np.asarray(init_pharm_com,
                                       np.float32).reshape(1, 3),
                            (batch.batch_size, 3))
                    else:
                        pm = batch.prot_mask[..., None]
                        com = ((batch.prot_x * pm).sum(1)
                               / np.maximum(pm.sum(1), 1)).astype(
                                   np.float32)
                # one pocket per chunk: the whole chunk is one pocket group
                out = self._run(batch, generator, com, batch.batch_size,
                                visualize_trajectory)
                with trace.span("sampler.split"):
                    out = {k: (v[:, :n_real] if k.startswith("traj")
                               else v[:n_real]) for k, v in out.items()}
                    results.extend(SampledPharmacophore.from_batch(
                        out, self.pharm_type_map,
                        with_trajectory=visualize_trajectory,
                        prot_ph_pos=prot_ph_pos,
                        prot_ph_types=prot_ph_types))
        return results

    def sample(self, pockets: List[dict], n_pharms: List[Sequence[int]],
               generator: Optional[torch.Generator] = None,
               max_batch_size: int = 32,
               init_pharm_com: Optional[np.ndarray] = None,
               visualize_trajectory: bool = False
               ) -> List[List[SampledPharmacophore]]:
        """Per-pocket lists of sampled pharmacophores. With one sample
        count for every pocket, fixed prot slots and one chunk per pocket,
        the whole sweep runs as ONE stacked device batch."""
        same_count = len({len(s) for s in n_pharms}) == 1
        if (same_count and self.fixed_prot_slots and len(pockets) > 1
                and len(n_pharms[0]) <= max_batch_size
                and not visualize_trajectory):
            return self.sample_stacked(pockets, n_pharms, generator,
                                       init_pharm_com=init_pharm_com)
        per_pocket = []
        for i, (pocket, sizes) in enumerate(zip(pockets, n_pharms)):
            com_i = None
            if init_pharm_com is not None:
                com_i = np.asarray(init_pharm_com)[i]
            per_pocket.append(self.sample_pocket(
                pocket, sizes, generator, max_batch_size=max_batch_size,
                init_pharm_com=com_i,
                visualize_trajectory=visualize_trajectory))
        return per_pocket

    def sample_stacked(self, pockets: List[dict],
                       n_pharms: List[Sequence[int]],
                       generator: Optional[torch.Generator] = None,
                       init_pharm_com: Optional[np.ndarray] = None
                       ) -> List[List[SampledPharmacophore]]:
        """All pockets x samples in one device batch, pocket-major (pocket
        i holds rows [i*c, (i+1)*c)), with `pocket_group_size` = c, the
        samples per pocket."""
        with trace.span("sampler.call"):
            return self._sample_stacked(pockets, n_pharms, generator,
                                        init_pharm_com)

    def _sample_stacked(self, pockets, n_pharms, generator, init_pharm_com):
        c = len(n_pharms[0])
        with trace.span("sampler.tile"):
            f_max = max(DEFAULT_MAX_PHARM, max(max(s) for s in n_pharms))
            batch = concat_batches([
                tile_pocket(p["prot_x"], p["prot_h"], sizes,
                            n_pharm_feats=self.model.config.pharm_nf,
                            max_pharm=f_max, max_prot=self.fixed_prot_slots,
                            prot_bucket_multiple=self.prot_bucket_multiple)
                for p, sizes in zip(pockets, n_pharms)])
            if init_pharm_com is not None:
                coms = np.asarray(init_pharm_com, np.float32).reshape(-1, 3)
            else:
                pm = batch.prot_mask[::c][..., None]
                coms = ((batch.prot_x[::c] * pm).sum(1)
                        / np.maximum(pm.sum(1), 1)).astype(np.float32)
            coms = np.repeat(coms, c, axis=0)
        out = self._run(batch, generator, coms, c)
        per_pocket = []
        with trace.span("sampler.split"):
            for i, pocket in enumerate(pockets):
                prot_ph_pos, prot_ph_types = _site_types(pocket)
                sub = {k: v[i * c:(i + 1) * c] for k, v in out.items()}
                per_pocket.append(SampledPharmacophore.from_batch(
                    sub, self.pharm_type_map, with_trajectory=False,
                    prot_ph_pos=prot_ph_pos, prot_ph_types=prot_ph_types))
        return per_pocket
