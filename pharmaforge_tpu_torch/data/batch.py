"""Padded dense mask-batched complex representation.

Port of `pharmaforge_tpu/data/batch.py` without flax: a batch is a plain
dataclass of numpy arrays. Batching is a leading axis, variable sizes are
validity masks, and "N samples of different sizes from one pocket" is
pocket tiling plus per-row pharm masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# default pharm slot count: dataset sizes are 3-8 centres
DEFAULT_MAX_PHARM = 8


@dataclasses.dataclass
class PharmComplexBatch:
    """One batch of protein-pocket / pharmacophore complexes.

    pharm_x:    [B, F, 3]   pharmacophore centre coordinates
    pharm_h:    [B, F, T]   one-hot pharmacophore types (T=6)
    pharm_mask: [B, F]      validity of pharm slots
    prot_x:     [B, P, 3]   pocket heavy-atom coordinates
    prot_h:     [B, P, E]   one-hot pocket elements (E=11)
    prot_mask:  [B, P]      validity of protein slots
    """

    pharm_x: np.ndarray
    pharm_h: np.ndarray
    pharm_mask: np.ndarray
    prot_x: np.ndarray
    prot_h: np.ndarray
    prot_mask: np.ndarray

    @property
    def batch_size(self) -> int:
        return self.pharm_x.shape[0]


def concat_batches(batches: Sequence[PharmComplexBatch]
                   ) -> PharmComplexBatch:
    """Same-width batches joined along the batch axis."""
    return PharmComplexBatch(**{
        f.name: np.concatenate([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(PharmComplexBatch)})


def bucket_size(n: int, multiple: int = 64, minimum: int = 64) -> int:
    """Round a node count up to a padding bucket boundary."""
    return max(minimum, ((n + multiple - 1) // multiple) * multiple)


def pad_to(arr: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    """Zero-pad `arr` along `axis` to length `n`."""
    pad = n - arr.shape[axis]
    if pad < 0:
        raise ValueError(
            f"cannot pad axis of size {arr.shape[axis]} down to {n}")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def collate_complexes(samples: Sequence[dict],
                      max_pharm: Optional[int] = None,
                      max_prot: Optional[int] = None,
                      prot_bucket_multiple: int = 64) -> PharmComplexBatch:
    """Per-sample dicts (numpy pharm_x [f,3], pharm_h [f,T], prot_x [p,3],
    prot_h [p,E]) collated into one zero-padded batch (the reference's
    `dgl.batch` over its complex graphs)."""
    f_max = max_pharm or max(max(s["pharm_x"].shape[0] for s in samples),
                             DEFAULT_MAX_PHARM)
    p_raw = max(s["prot_x"].shape[0] for s in samples)
    p_max = max_prot or bucket_size(p_raw, prot_bucket_multiple)
    cols = {f.name: [] for f in dataclasses.fields(PharmComplexBatch)}
    for s in samples:
        for side, n_max in (("pharm", f_max), ("prot", p_max)):
            x = np.asarray(s[f"{side}_x"], np.float32)
            cols[f"{side}_x"].append(pad_to(x, n_max))
            cols[f"{side}_h"].append(pad_to(np.asarray(s[f"{side}_h"],
                                                       np.float32), n_max))
            m = np.zeros(n_max, bool)
            m[:x.shape[0]] = True
            cols[f"{side}_mask"].append(m)
    return PharmComplexBatch(**{k: np.stack(v) for k, v in cols.items()})


def pad_batch_to_multiple(batch: PharmComplexBatch, multiple: int):
    """Pad the batch axis up to a multiple of `multiple` (JAX
    parallel/mesh.py): padding rows repeat row 0 with all-false masks, so
    they add nothing to the masked loss. Returns (batch, real size)."""
    b = batch.batch_size
    rem = (-b) % multiple
    if rem == 0:
        return batch, b

    def pad(name):
        arr = np.asarray(getattr(batch, name))
        fill = np.repeat(arr[:1], rem, axis=0)
        if name.endswith("mask"):
            fill = np.zeros_like(fill)
        return np.concatenate([arr, fill], axis=0)

    return PharmComplexBatch(**{
        f.name: pad(f.name) for f in dataclasses.fields(PharmComplexBatch)}), b


def tile_pocket(prot_x: np.ndarray, prot_h: np.ndarray,
                pharm_sizes: Sequence[int],
                n_pharm_feats: int = 6,
                max_pharm: Optional[int] = None,
                max_prot: Optional[int] = None,
                prot_bucket_multiple: int = 64) -> PharmComplexBatch:
    """One pocket replicated over a batch with per-copy pharm sizes (the
    reference `copy_graph` + `dgl.batch`); pharm features start at zero
    and the requested sizes become per-row masks."""
    pharm_sizes = [int(s) for s in pharm_sizes]
    b = len(pharm_sizes)
    f_max = max_pharm or max(max(pharm_sizes), DEFAULT_MAX_PHARM)
    p = prot_x.shape[0]
    p_max = max_prot or bucket_size(p, prot_bucket_multiple)

    prot_x_pad = pad_to(np.asarray(prot_x, np.float32), p_max)
    prot_h_pad = pad_to(np.asarray(prot_h, np.float32), p_max)
    prot_mask = np.zeros(p_max, bool)
    prot_mask[:p] = True

    pharm_mask = np.zeros((b, f_max), bool)
    for i, sz in enumerate(pharm_sizes):
        if sz > f_max:
            raise ValueError(f"pharm size {sz} exceeds slot count {f_max}")
        pharm_mask[i, :sz] = True

    return PharmComplexBatch(
        pharm_x=np.zeros((b, f_max, 3), np.float32),
        pharm_h=np.zeros((b, f_max, n_pharm_feats), np.float32),
        pharm_mask=pharm_mask,
        prot_x=np.broadcast_to(prot_x_pad, (b, p_max, 3)).copy(),
        prot_h=np.broadcast_to(prot_h_pad, (b,) + prot_h_pad.shape).copy(),
        prot_mask=np.broadcast_to(prot_mask, (b, p_max)).copy(),
    )
