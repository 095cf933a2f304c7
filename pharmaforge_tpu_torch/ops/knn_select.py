"""pf k-nearest-neighbor selection (K1): the CUDA kernel's two entries and
their plain PyTorch versions.

The kernel (`csrc/knn_select.cu`) replaces the Pallas TPU kernel
`pharmaforge_tpu/ops/pallas/knn_select.py::knn_select`. The sampling chain
rebuilds the prot->pharm edge list from the noisy pharm coordinates on
every denoiser call; this selects, for each (b, f), the k nearest valid
prot atoms with `lax.top_k`'s tie order.

* `knn_select` returns the JAX kernel's contract: (idx int32, dist, the
  selected prot coordinates). It is the yardstick of the selection's
  exactness.
* `knn_pf_edges` returns what the denoiser's pf and fp edges need:
  (idx int64, mask, x_dir, x_dir_fp = -x_dir, d_rbf), the geometry
  computed in the same launch. `models/edges.py::build_edge_bundle`
  calls it.

Bound on the card: the fused entry reads about B*P*13 + B*F*13 bytes and
writes B*F*K*97 bytes (about 1.7 MB at the sampling shape B=240, F=8,
P=230, K=5), so it is bound by launch latency rather than bytes or
arithmetic. One warp per (b, f) row keeps its candidates in registers
and runs each of the k passes as two warp reductions (the csrc note
describes the design).

Both entries launch the kernel for CUDA tensors (or raise) and run their
plain version for CPU tensors. The plain versions are what the CPU tests
run and what the kernel is held against on the card; the main path on the
card never calls them. The counter `knn_select.launches`
(`utils/trace.py`) counts kernel launches of either entry. Inside a CUDA
graph capture it counts the launch where it is captured, not where it is
replayed: a captured graph's replays count theirs under
`<kind>.replayed.knn_select`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from pharmaforge_tpu_torch.ops.geometry import RBF_DIM, pair_geometry
from pharmaforge_tpu_torch.utils import trace

_BIG = 1e30
# shared memory a block may use on Hopper (bytes)
_MAX_SMEM = 232448


Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
PfEdges = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


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


def knn_pf_edges_reference(pharm_x: torch.Tensor, pharm_mask: torch.Tensor,
                           prot_x: torch.Tensor, prot_mask: torch.Tensor,
                           k: int) -> PfEdges:
    """Plain version of the pf/fp edges: (idx [B,F,K] int64, mask
    [B,F,K] bool, x_dir [B,F,K,3], x_dir_fp = -x_dir, d_rbf
    [B,F,K,RBF_DIM]): the selection, then `pair_geometry` of the pharm
    centres against the selected prot atoms."""
    idx, dist, xg = knn_select_reference(pharm_x, pharm_mask, prot_x,
                                         prot_mask, k)
    x_dir, d_rbf = pair_geometry(pharm_x, xg)
    return idx.long(), dist < _BIG, x_dir, -x_dir, d_rbf


@functools.cache
def _launcher():
    from pharmaforge_tpu_torch.ops import _build
    lib = _build.load("knn_select")
    lib.knn_select_launch.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p] * 4)
    lib.knn_pf_edges_launch.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p] * 6)
    for fn in (lib.knn_select_launch, lib.knn_pf_edges_launch,
               lib.knn_select_rbf_dim):
        fn.restype = ctypes.c_int
    lib.knn_select_smem_bytes.argtypes = [ctypes.c_int]
    lib.knn_select_smem_bytes.restype = ctypes.c_size_t
    if lib.knn_select_rbf_dim() != RBF_DIM:
        raise RuntimeError(f"knn_select: the kernel's RBF width "
                           f"{lib.knn_select_rbf_dim()} differs from "
                           f"RBF_DIM={RBF_DIM}")
    return lib


@functools.cache
def _fits(p: int) -> bool:
    """Whether the kernel takes P prot slots (shared memory a block has)."""
    return _launcher().knn_select_smem_bytes(p) <= _MAX_SMEM


def _shape(name: str, pharm_x, pharm_mask, prot_x, prot_mask,
           k: int) -> Tuple[int, int, int, int]:
    """Check a CUDA call's inputs against the kernel's contract; returns
    (B, F, P, k clamped to P). The messages are built only on failure:
    this runs on every denoiser call."""
    b, f = pharm_mask.shape
    p = prot_mask.shape[1]
    dev = pharm_x.device
    for arg, t, dtype, shape in (
            ("pharm_x", pharm_x, torch.float32, (b, f, 3)),
            ("pharm_mask", pharm_mask, torch.bool, (b, f)),
            ("prot_x", prot_x, torch.float32, (b, p, 3)),
            ("prot_mask", prot_mask, torch.bool, (b, p))):
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: {arg} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, pharm_x on {dev}")
    k = min(k, p)
    if k < 1:
        raise ValueError(f"{name}: need k >= 1 and P >= 1, got k={k}")
    if not _fits(p):
        raise ValueError(f"{name}: P={p} needs more shared memory than a "
                         f"block has")
    return b, f, p, k


def _launch(entry, dev, inputs, b: int, f: int, p: int, k: int,
            outputs) -> None:
    """One launch of `entry` on the current stream of `dev`."""
    if b * f == 0:
        return
    with torch.cuda.device(dev):
        err = entry(*(t.data_ptr() for t in inputs), b, f, p, k,
                    *(t.data_ptr() for t in outputs),
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_select kernel launch failed: CUDA error "
                           f"{err}")
    trace.count("knn_select.launches")


def _on_card(name: str, dev: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raises for others."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def knn_select(pharm_x: torch.Tensor, pharm_mask: torch.Tensor,
               prot_x: torch.Tensor, prot_mask: torch.Tensor,
               k: int) -> Tensors:
    """Same contract as `knn_select_reference`. CUDA tensors go through the
    kernel; CPU tensors through the plain version."""
    inputs = (pharm_x, pharm_mask, prot_x, prot_mask)
    dev = pharm_x.device
    if not _on_card("knn_select", dev):
        return knn_select_reference(*inputs, k)
    b, f, p, k = _shape("knn_select", *inputs, k)
    idx = torch.empty((b, f, k), dtype=torch.int32, device=dev)
    dist = torch.empty((b, f, k), dtype=torch.float32, device=dev)
    xg = torch.empty((b, f, k, 3), dtype=torch.float32, device=dev)
    _launch(_launcher().knn_select_launch, dev, inputs, b, f, p, k,
            (idx, dist, xg))
    return idx, dist, xg


def knn_pf_edges(pharm_x: torch.Tensor, pharm_mask: torch.Tensor,
                 prot_x: torch.Tensor, prot_mask: torch.Tensor,
                 k: int) -> PfEdges:
    """Same contract as `knn_pf_edges_reference`. CUDA tensors go through
    one kernel launch; CPU tensors through the plain version. The edges
    get no gradient (the JAX kernel has no backward either): an input
    that requires grad raises."""
    inputs = (pharm_x, pharm_mask, prot_x, prot_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError("knn_pf_edges: the pf edges get no gradient; "
                           "detach the coordinates")
    dev = pharm_x.device
    if not _on_card("knn_pf_edges", dev):
        return knn_pf_edges_reference(*inputs, k)
    b, f, p, k = _shape("knn_pf_edges", *inputs, k)
    idx = torch.empty((b, f, k), dtype=torch.int64, device=dev)
    mask = torch.empty((b, f, k), dtype=torch.bool, device=dev)
    x_dir = torch.empty((b, f, k, 3), dtype=torch.float32, device=dev)
    x_dir_fp = torch.empty_like(x_dir)
    d_rbf = torch.empty((b, f, k, RBF_DIM), dtype=torch.float32, device=dev)
    _launch(_launcher().knn_pf_edges_launch, dev, inputs, b, f, p, k,
            (idx, mask, x_dir, x_dir_fp, d_rbf))
    return idx, mask, x_dir, x_dir_fp, d_rbf
