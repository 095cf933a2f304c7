"""Sampled-pharmacophore result object and xyz writers.

Port of `pharmaforge_tpu/analysis/pharm_builder.py`, built from plain
numpy arrays (one row of the dense sampling output).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pharmaforge_tpu_torch.constants import TYPE_IDX_TO_ELEM


class SampledPharmacophore:

    type_idx_to_elem = TYPE_IDX_TO_ELEM

    def __init__(self,
                 ph_coords: np.ndarray,          # [n, 3] final coordinates
                 ph_feats: np.ndarray,           # [n, T] final type scores
                 pharm_type_map: List[str],
                 traj_frames: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 prot_ph_pos: Optional[np.ndarray] = None,
                 prot_ph_types: Optional[List[str]] = None,
                 ref_prot_file=None,
                 ref_rdkit_lig=None):
        self.ph_coords = np.asarray(ph_coords)
        self.ph_feats = np.asarray(ph_feats)
        self.pharm_type_map = list(pharm_type_map)
        self.ref_prot_file = ref_prot_file
        self.ref_rdkit_lig = ref_rdkit_lig
        # receptor pharmacophore sites (read by the validity metric)
        self.prot_ph_pos = prot_ph_pos
        self.prot_ph_types = prot_ph_types

        # argmax decode of the one-hot diffusion output
        self.ph_feats_idxs = self.ph_feats.argmax(axis=1)
        self.ph_types = [self.pharm_type_map[int(i)]
                         for i in self.ph_feats_idxs]
        self.n_ph_centers = self.ph_coords.shape[0]

        if traj_frames is None:
            self.pos_frames = None
            self.feat_frames = None
        else:
            self.pos_frames, self.feat_frames = traj_frames

        if len(pharm_type_map) != len(self.type_idx_to_elem):
            raise ValueError(f"pharm_type_map must have "
                             f"{len(self.type_idx_to_elem)} elements")
        self.ph_type_to_elem = {
            self.pharm_type_map[i]: self.type_idx_to_elem[i]
            for i in range(len(self.pharm_type_map))}

    @classmethod
    def from_batch(cls, out: dict, pharm_type_map: List[str],
                   with_trajectory: bool = False, **kwargs
                   ) -> List["SampledPharmacophore"]:
        """Split a dense sampling output (numpy arrays) into per-sample
        objects, keeping each row's valid slots."""
        x, h, mask = out["pharm_x"], out["pharm_h"], out["pharm_mask"]
        with_traj = with_trajectory and "traj_x" in out
        pharms = []
        for b in range(x.shape[0]):
            m = mask[b]
            traj = None
            if with_traj:
                traj = (out["traj_x"][:, b, m], out["traj_h"][:, b, m])
            pharms.append(cls(x[b, m], h[b, m], pharm_type_map,
                              traj_frames=traj, **kwargs))
        return pharms

    def pharm_to_xyz(self, pos: np.ndarray, types: List[str]) -> str:
        out = f"{len(pos)}\n"
        for i in range(len(pos)):
            elem = self.ph_type_to_elem[types[i]]
            out += f"{elem} {pos[i, 0]:.3f} {pos[i, 1]:.3f} {pos[i, 2]:.3f}\n"
        return out

    def to_xyz_file(self, filename: Optional[str] = None):
        out = self.pharm_to_xyz(self.ph_coords, self.ph_types)
        if filename is None:
            return out
        with open(filename, "w") as f:
            f.write(out)
        return None

    def traj_to_xyz(self, filename: Optional[str] = None):
        if self.pos_frames is None:
            raise ValueError(
                "Cannot write trajectory because no trajectory frames were "
                "passed to the SampledPharmacophore object")
        out = ""
        frame_type_idxs = self.feat_frames.argmax(axis=2)
        for i in range(self.pos_frames.shape[0]):
            frame_types = [self.pharm_type_map[int(idx)]
                           for idx in frame_type_idxs[i]]
            out += self.pharm_to_xyz(self.pos_frames[i], frame_types)
        if filename is None:
            return out
        with open(filename, "w") as f:
            f.write(out)
        return None
