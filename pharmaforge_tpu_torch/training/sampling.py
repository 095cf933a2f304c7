"""Host-level batched sampling orchestration.

Port of `pharmaforge_tpu/training/sampling.py::PocketSampler`: pockets are
tiled into dense batches (`data.batch.tile_pocket`), chunked by
`max_batch_size`, run through the reverse chain on the device, and split
back into `SampledPharmacophore` objects that carry their pocket's
receptor sites for the validity metric. Random draws come from an explicit
`torch.Generator`.
"""

from __future__ import annotations

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
from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion


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

    def _run(self, batch, generator, com, group: int,
             visualize: bool = False) -> dict:
        out = self.model.sample_given_receptor(
            batch, generator=generator, init_pharm_com=com,
            visualize_trajectory=visualize, pocket_group_size=group)
        out = {k: v.cpu().numpy() for k, v in out.items()}
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
            batch = tile_pocket(
                pocket["prot_x"], pocket["prot_h"], pad_sizes,
                n_pharm_feats=self.model.config.pharm_nf,
                max_pharm=max(DEFAULT_MAX_PHARM, max(pad_sizes)),
                max_prot=self.fixed_prot_slots,
                prot_bucket_multiple=self.prot_bucket_multiple)
            if init_pharm_com is not None:
                com = np.broadcast_to(
                    np.asarray(init_pharm_com, np.float32).reshape(1, 3),
                    (batch.batch_size, 3))
            else:
                pm = batch.prot_mask[..., None]
                com = ((batch.prot_x * pm).sum(1)
                       / np.maximum(pm.sum(1), 1)).astype(np.float32)
            # one pocket per chunk: the whole chunk is one pocket group
            out = self._run(batch, generator, com, batch.batch_size,
                            visualize_trajectory)
            out = {k: (v[:, :n_real] if k.startswith("traj") else v[:n_real])
                   for k, v in out.items()}
            results.extend(SampledPharmacophore.from_batch(
                out, self.pharm_type_map,
                with_trajectory=visualize_trajectory,
                prot_ph_pos=prot_ph_pos, prot_ph_types=prot_ph_types))
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
        c = len(n_pharms[0])
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
        out = self._run(batch, generator, np.repeat(coms, c, axis=0), c)
        per_pocket = []
        for i, pocket in enumerate(pockets):
            prot_ph_pos, prot_ph_types = _site_types(pocket)
            sub = {k: v[i * c:(i + 1) * c] for k, v in out.items()}
            per_pocket.append(SampledPharmacophore.from_batch(
                sub, self.pharm_type_map, with_trajectory=False,
                prot_ph_pos=prot_ph_pos, prot_ph_types=prot_ph_types))
        return per_pocket
