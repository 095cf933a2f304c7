"""pf k-nearest-neighbor selection: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (`csrc/knn_select.cu`) replaces the Pallas TPU kernel
`pharmaforge_tpu/ops/pallas/knn_select.py::knn_select`. The sampling chain
rebuilds the prot->pharm edge list from the noisy pharm coordinates on
every denoiser call; this selects, for each (b, f), the k nearest valid
prot atoms with `lax.top_k`'s tie order and gathers their coordinates.

Bound on the card: it reads about B*P*13 + B*F*13 bytes and writes
B*F*K*20 bytes (about 1 MB at the sampling shape B=240, F=8, P=230, K=5),
so it is bound by launch latency rather than bytes or arithmetic. The
kernel does the distance grid, all k passes and the gather in one launch,
with one block per batch row staging that row's prot atoms in shared
memory and one warp per pharm row.

`knn_select` launches the kernel for CUDA tensors (or raises) and runs
`knn_select_reference` for CPU tensors. The plain version is what the CPU
tests run and what the kernel is held against on the card; the main path
on the card never calls it. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

_BIG = 1e30
# shared memory a block may use on Hopper (bytes)
_MAX_SMEM = 232448

launches = 0

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def knn_select_reference(pharm_x: torch.Tensor, pharm_mask: torch.Tensor,
                         prot_x: torch.Tensor, prot_mask: torch.Tensor,
                         k: int) -> Tensors:
    """Plain version: (idx [B,F,K] int32, dist [B,F,K] f32, selected prot
    coords [B,F,K,3] f32). Distances are computed component-wise,
    (dx*dx + dy*dy) + dz*dz; each of the k passes takes the min, the
    lowest index at the min, and knocks that slot out with +inf."""
    p = prot_x.shape[1]
    k = min(k, p)
    diff = pharm_x[:, :, None, :] - prot_x[:, None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    valid = pharm_mask.bool()[:, :, None] & prot_mask.bool()[:, None, :]
    cur = torch.where(valid, d2, _BIG)
    cols = torch.arange(p, device=prot_x.device)
    idxs, vals = [], []
    for _ in range(k):
        v = torch.amin(cur, dim=-1)
        i = torch.amin(torch.where(cur == v[..., None], cols, p), dim=-1)
        vals.append(v)
        idxs.append(i)
        cur = torch.where(cols == i[..., None], torch.inf, cur)
    idx = torch.stack(idxs, dim=-1)
    dist = torch.stack(vals, dim=-1)
    b, f = idx.shape[:2]
    xg = prot_x[torch.arange(b, device=prot_x.device)[:, None, None], idx]
    return idx.to(torch.int32), dist, xg


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"knn_select: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"knn_select: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"knn_select: {name} must be contiguous")


@functools.cache
def _launcher():
    from pharmaforge_tpu_torch.ops import _build
    lib = _build.load("knn_select")
    fn = lib.knn_select_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    lib.knn_select_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.knn_select_smem_bytes.restype = ctypes.c_size_t
    return lib


def knn_select(pharm_x: torch.Tensor, pharm_mask: torch.Tensor,
               prot_x: torch.Tensor, prot_mask: torch.Tensor,
               k: int) -> Tensors:
    """Same contract as `knn_select_reference`. CUDA tensors go through the
    kernel; CPU tensors through the plain version."""
    dev = pharm_x.device
    if dev.type == "cpu":
        return knn_select_reference(pharm_x, pharm_mask, prot_x, prot_mask,
                                    k)
    if dev.type != "cuda":
        raise ValueError(f"knn_select: unsupported device {dev}")
    b, f = pharm_mask.shape
    p = prot_mask.shape[1]
    k = min(k, p)
    _check("pharm_x", pharm_x, torch.float32, (b, f, 3))
    _check("pharm_mask", pharm_mask, torch.bool, (b, f))
    _check("prot_x", prot_x, torch.float32, (b, p, 3))
    _check("prot_mask", prot_mask, torch.bool, (b, p))
    for name, t in (("pharm_mask", pharm_mask), ("prot_x", prot_x),
                    ("prot_mask", prot_mask)):
        if t.device != dev:
            raise ValueError(f"knn_select: {name} on {t.device}, "
                             f"pharm_x on {dev}")
    if k < 1:
        raise ValueError(f"knn_select: need k >= 1 and P >= 1, got k={k}")
    lib = _launcher()
    if lib.knn_select_smem_bytes(f, p) > _MAX_SMEM:
        raise ValueError(f"knn_select: P={p} needs more shared memory than "
                         f"a block has")
    idx = torch.empty((b, f, k), dtype=torch.int32, device=dev)
    dist = torch.empty((b, f, k), dtype=torch.float32, device=dev)
    xg = torch.empty((b, f, k, 3), dtype=torch.float32, device=dev)
    if b * f == 0:
        return idx, dist, xg
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_select_launch(
            pharm_x.data_ptr(), pharm_mask.data_ptr(), prot_x.data_ptr(),
            prot_mask.data_ptr(), b, f, p, k, idx.data_ptr(),
            dist.data_ptr(), xg.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_select kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return idx, dist, xg
