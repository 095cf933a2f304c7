"""Fused prot-prot message chain + masked K-sum: the CUDA kernel's wrapper
and its plain PyTorch version.

The kernel (`csrc/pp_message.cu`) replaces the Pallas TPU kernel
`pharmaforge_tpu/ops/pallas/pp_message.py::_kernel` (launched by
`_pallas_impl`). The middle convolutions of the reference-size model run
the prot-prot message GVP chain per copy of the pocket at full width; this
computes, for every batch row and destination atom, the gather of its K
neighbours' node-table rows, the whole message chain on each edge row and
the masked sum over the K slots, without writing a [B, Nd, K, ...] edge
tensor to device memory.

Bound on the card: at the sampling shape (B=120, Nd=P=230, K=16, S=128,
V=16, three message GVPs) about 43 GFLOP a call against about 35 MB of
inputs and outputs, so it is bound by operations (PERF.md). The kernel
runs the products on the fp32 FMA units with every per-edge activation
kept in shared memory (see the source's note).

Numerics follow the JAX package's twin (`_ref_impl`): the node tables and
edge terms arrive in the compute dtype, every product is accumulated in
fp32 and rounded once to the compute dtype, the adds round in the compute
dtype, channel norms (clamped at 1e-8), SiLU and sigmoid run in fp32, and
the masked K-sum is fp32. The edge terms `rterm = rbf @ W1_d + b1` and
`dirterm = x_dir (x) Wh[0]` are computed here, at pocket-group level, by
plain PyTorch for both the kernel and the plain version.

`fused_message_agg` launches the kernel for CUDA tensors (or raises) and
runs `message_agg_reference` for CPU tensors. `launches` counts kernel
launches. The function is forward only: its backward is the JAX package's
second kernel (`_bwd_kernel`), which comes with training, so an input that
requires grad while grad is enabled raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

# shared memory a block may use on Hopper (bytes)
_MAX_SMEM = 232448
# the kernel's limits (csrc/pp_message.cu): edge rows per block, widths
_MAX_K = 64
_MAX_WIDTH = 128

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

launches = 0

Tensors = Tuple[torch.Tensor, torch.Tensor]


def split_weights(gvps: Sequence[torch.nn.Module], s: int, r: int) -> tuple:
    """The message chain's weights in the JAX package's `_split_weights`
    layout ([in, out] matrices): GVP 0 as (wh0 [H0], wu [H0,V], w1_d [r,S],
    w1_sh [H0,S], b1 [S], wg [S,V], bg [V]), each later GVP j as
    (whj [V,Hj], wuj [Hj,V], w1f [S,S], w1sh [Hj,S], b1j, wgj, bgj). Torch
    Linear weights are [out, in]; `s` scalar and `r` RBF channels lead
    GVP 0's scalar input."""
    g0, *rest = gvps
    w1 = g0.to_feats_out[0]
    gates = g0.scalar_to_vector_gates
    out = [g0.Wh[0], g0.Wu, w1.weight[:, s:s + r].T, w1.weight[:, s + r:].T,
           w1.bias, gates.weight.T, gates.bias]
    for gj in rest:
        w1 = gj.to_feats_out[0]
        gates = gj.scalar_to_vector_gates
        out += [gj.Wh, gj.Wu, w1.weight[:, :s].T, w1.weight[:, s:].T,
                w1.bias, gates.weight.T, gates.bias]
    return tuple(out)


def _edge_terms(weights: tuple, x_dir: torch.Tensor, d_rbf: torch.Tensor,
                dt: torch.dtype) -> Tensors:
    """Group-level edge terms in the compute dtype: rterm [G,Nd,K,S] (an
    fp32 product plus the bias, rounded once) and dirterm [G,Nd,K,3,H0]."""
    wh0, _, w1_d, _, b1 = weights[:5]
    rterm = (d_rbf.to(dt).float() @ w1_d.to(dt).float()
             + b1.to(dt).float()).to(dt)
    dirterm = x_dir.to(dt)[..., :, None] * wh0.to(dt)
    return rterm, dirterm


def _chain_plain(tab_s, tab_v, idx, mask, rterm, dirterm, weights, dt,
                 copies: int) -> Tensors:
    """The message chain and masked K-sum in plain PyTorch. tab_s [B,P,S]
    and tab_v [B,P,3,H0] are per batch row; idx, mask, rterm and dirterm are
    per pocket group (B = G * copies)."""
    if copies > 1:
        idx, mask, rterm, dirterm = (torch.repeat_interleave(a, copies, dim=0)
                                     for a in (idx, mask, rterm, dirterm))
    rows = torch.arange(tab_s.shape[0], device=tab_s.device)[:, None, None]
    idx = idx.long()
    g_s = tab_s[rows, idx]                           # [B,Nd,K,S]
    g_v = tab_v[rows, idx]                           # [B,Nd,K,3,H0]
    w = [a.to(dt) for a in weights]

    def dot(a, m):
        # fp32 accumulation, one rounding to the compute dtype
        return torch.matmul(a.float(), m.float()).to(dt)

    def norms(vh):
        sq = vh.float() ** 2
        tot = sq[..., 0, :] + sq[..., 1, :] + sq[..., 2, :]
        return torch.sqrt(torch.clamp(tot, min=1e-8)).to(dt)

    def silu(x):
        xf = x.float()
        return (xf * torch.sigmoid(xf)).to(dt)

    def sigmoid(x):
        return torch.sigmoid(x.float()).to(dt)

    _, wu, _, w1_sh, _, wg, bg = w[:7]
    vh = g_v + dirterm
    feats = silu(g_s + rterm + dot(norms(vh), w1_sh))
    gate = sigmoid(dot(feats, wg) + bg)
    vec = gate[..., None, :] * dot(vh, wu)           # [B,Nd,K,3,V]
    for j in range(7, len(w), 7):
        whj, wuj, w1f, w1sh, b1j, wgj, bgj = w[j:j + 7]
        vh = dot(vec, whj)
        feats = silu(dot(feats, w1f) + dot(norms(vh), w1sh) + b1j)
        gate = sigmoid(dot(feats, wgj) + bgj)
        vec = gate[..., None, :] * dot(vh, wuj)
    m = mask.float()[..., None]
    s_sum = torch.sum(feats.float() * m, dim=2)
    v_sum = torch.sum(vec.float() * m[..., None], dim=2)
    return s_sum, v_sum.transpose(-1, -2)


def message_agg_reference(pre_s: torch.Tensor,
                          vh_planes: Sequence[torch.Tensor], edge,
                          layer_params: Sequence[torch.nn.Module], *,
                          scalar_size: int, vector_size: int, rbf_dim: int,
                          compute_dtype: str = "float32",
                          copies: int = 1) -> Tensors:
    """Plain version, the contract of `fused_message_agg`. Differentiable."""
    del vector_size
    dt = COMPUTE_DTYPES[compute_dtype]
    weights = split_weights(layer_params, scalar_size, rbf_dim)
    rterm, dirterm = _edge_terms(weights, edge.x_dir, edge.d_rbf, dt)
    tab_v = torch.stack(list(vh_planes), dim=2).to(dt)
    return _chain_plain(pre_s.to(dt), tab_v, edge.idx, edge.mask, rterm,
                        dirterm, weights, dt, copies)


def _pack_weights(weights: tuple, dt: torch.dtype) -> torch.Tensor:
    """The kernel's weight buffer: GVP 0's (w1_sh, wg, bg, wu), then each
    later GVP's (wh, wu, w1f, w1sh, b1, wg, bg), each flattened row-major
    ([in, out]) and zero-padded to a multiple of 8 elements
    (csrc/pp_message.cu, `layer0_offsets` / `layerj_offsets`)."""
    order = [weights[3], weights[5], weights[6], weights[1]]
    for j in range(7, len(weights), 7):
        whj, wuj, w1f, w1sh, b1j, wgj, bgj = weights[j:j + 7]
        order += [whj, wuj, w1f, w1sh, b1j, wgj, bgj]
    pieces = []
    for a in order:
        flat = a.reshape(-1)
        pieces.append(flat)
        if flat.numel() % 8:
            pieces.append(flat.new_zeros(8 - flat.numel() % 8))
    return torch.cat(pieces).to(dt).contiguous()


@functools.cache
def _launcher():
    from pharmaforge_tpu_torch.ops import _build
    lib = _build.load("pp_message")
    fn = lib.pp_message_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    for name in ("pp_message_weights_size", "pp_message_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 5
    lib.pp_message_weights_size.restype = ctypes.c_int
    lib.pp_message_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_message_agg: {msg}")


def fused_message_agg(pre_s: torch.Tensor, vh_planes: Sequence[torch.Tensor],
                      edge, layer_params: Sequence[torch.nn.Module], *,
                      scalar_size: int, vector_size: int, rbf_dim: int,
                      compute_dtype: str = "float32",
                      copies: int = 1) -> Tensors:
    """Fused (gather -> message chain -> masked K-sum) for the prot-prot
    edge type.

    pre_s:      [B, P, S] node-level h_src @ W1_h (compute dtype)
    vh_planes:  3 x [B, P, H0] node-level v_src @ Wh[1:], one per spatial
                component (H0 = V + 1)
    edge:       idx/mask [G, Nd, K], x_dir [G, Nd, K, 3],
                d_rbf [G, Nd, K, rbf_dim] at pocket-group level when
                copies > 1 (B = G * copies; models/edges.py GroupedEdgeData)
    layer_params: the message chain's GVP modules (models/gvp.py)

    Returns the pre-normalization sums s_sum [B, Nd, S] fp32 and
    v_sum [B, Nd, V, 3] fp32; the caller normalizes."""
    weights = split_weights(layer_params, scalar_size, rbf_dim)
    planes = list(vh_planes)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pre_s, *planes, edge.x_dir,
                                      edge.d_rbf, *weights)):
        raise RuntimeError(
            "fused_message_agg has no backward yet (the JAX package's "
            "backward kernel is not ported); call it under torch.no_grad()")
    dev = pre_s.device
    kw = dict(scalar_size=scalar_size, vector_size=vector_size,
              rbf_dim=rbf_dim, compute_dtype=compute_dtype, copies=copies)
    if dev.type == "cpu":
        return message_agg_reference(pre_s, planes, edge, layer_params, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_message_agg: unsupported device {dev}")

    dt = COMPUTE_DTYPES[compute_dtype]
    b, p, s = pre_s.shape
    g, nd, k = edge.mask.shape
    v = vector_size
    h0 = planes[0].shape[-1]
    n_layers = 1 + (len(weights) - 7) // 7
    hj = weights[7].shape[1] if n_layers > 1 else 0
    _check(s == scalar_size, f"pre_s has {s} channels, scalar_size is "
                             f"{scalar_size}")
    _check(g * copies == b, f"edge batch {g} x copies {copies} != table "
                            f"batch {b}")
    _check(len(planes) == 3 and all(tuple(q.shape) == (b, p, h0)
                                    for q in planes),
           "vh_planes must be three [B, P, H0] tensors")
    _check(tuple(edge.idx.shape) == (g, nd, k), "idx and mask shapes differ")
    _check(1 <= k <= _MAX_K, f"K={k} outside [1, {_MAX_K}]")
    _check(max(s, v, h0, hj) <= _MAX_WIDTH,
           f"widths S={s} V={v} H0={h0} Hj={hj} above {_MAX_WIDTH}")
    _check(all(weights[j].shape[1] == hj for j in range(7, len(weights), 7)),
           "every message GVP after the first must have one hidden width")
    for name, t in (("pre_s", pre_s), ("vh_planes", planes[0]),
                    ("idx", edge.idx), ("mask", edge.mask),
                    ("x_dir", edge.x_dir), ("d_rbf", edge.d_rbf),
                    ("weights", weights[0])):
        _check(t.device == dev, f"{name} on {t.device}, pre_s on {dev}")
    lib = _launcher()
    _check(lib.pp_message_smem_bytes(s, v, h0, hj, n_layers) <= _MAX_SMEM,
           "the widths need more shared memory than a block has")

    rterm, dirterm = _edge_terms(weights, edge.x_dir, edge.d_rbf, dt)
    packed = _pack_weights(weights, dt)
    _check(packed.numel() == lib.pp_message_weights_size(s, v, h0, hj,
                                                          n_layers),
           "packed weight layout differs from the kernel's")
    tab_s = pre_s.to(dt).contiguous()
    tab_v = torch.stack(planes, dim=2).to(dt).contiguous()
    idx = edge.idx.to(torch.int32).contiguous()
    mask = edge.mask.to(torch.float32).contiguous()
    rterm, dirterm = rterm.contiguous(), dirterm.contiguous()
    s_sum = torch.empty((b, nd, s), dtype=torch.float32, device=dev)
    v_sum = torch.empty((b, nd, v, 3), dtype=torch.float32, device=dev)
    if b * nd == 0:
        return s_sum, v_sum
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pp_message_launch(
            int(dt == torch.bfloat16), tab_s.data_ptr(), tab_v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), rterm.data_ptr(),
            dirterm.data_ptr(), packed.data_ptr(), b, p, g, copies, nd, k, s,
            v, h0, hj, n_layers, s_sum.data_ptr(), v_sum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pp_message kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return s_sum, v_sum
