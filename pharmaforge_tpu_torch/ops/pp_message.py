"""Fused prot-prot message chain + masked K-sum: the CUDA kernels'
wrapper and its plain PyTorch version.

Two kernels, one differentiable function:

* K2, `csrc/pp_message.cu`, replaces the Pallas TPU kernel
  `pharmaforge_tpu/ops/pallas/pp_message.py::_kernel` (launched by
  `_pallas_impl`). The middle convolutions of the reference-size model run
  the prot-prot message GVP chain per copy of the pocket at full width;
  K2 computes, for every batch row and destination atom, the gather of its
  K neighbours' node-table rows, the whole message chain on each edge row
  and the masked sum over the K slots, without writing a [B, Nd, K, ...]
  edge tensor to device memory.
* K3, `csrc/pp_message_bwd.cu`, replaces the backward kernel
  `_bwd_kernel` (launched by `_pallas_bwd_impl`): it recomputes the chain
  per destination tile, backpropagates through it, scatters the node-table
  gradients and accumulates every weight gradient, the edge terms' weights
  (`w1_d`, `b1`, `wh0`) included.

Numerics follow the JAX package's twin (`_ref_impl`): the node tables and
edge terms arrive in the compute dtype, every product is accumulated in
fp32 and rounded once to the compute dtype, the adds round in the compute
dtype, channel norms (clamped at 1e-8), SiLU and sigmoid run in fp32, and
the masked K-sum is fp32. The edge terms `rterm = rbf @ W1_d + b1` and
`dirterm = x_dir (x) Wh[0]` are computed here, at pocket-group level, by
plain PyTorch for both the kernel and the plain version.

`fused_message_agg` runs `message_agg_reference` for CPU tensors
(differentiated by autograd) and, for CUDA tensors, a
`torch.autograd.Function` whose forward launches K2 and whose backward
launches K3 (or raises: there is no fallback). Its inputs are the node
tables and the split weights (`split_weights`), views of the GVP
parameters, so autograd routes each weight gradient back to its parameter.
The edge geometry gets no gradient, as in the JAX backward kernel: an
`x_dir` or `d_rbf` that requires grad raises. `launches` counts K2
launches and `bwd_launches` K3 launches. Inside a CUDA graph capture they
count a launch where it is captured, not where it is replayed: a
captured sampling chain adds its replays' launches to
`models/diffusion.py::replayed_launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import torch

# shared memory a block may use on Hopper (bytes)
_MAX_SMEM = 232448
# the kernels' limits (csrc/pp_message*.cu): edge rows per block, widths
_MAX_K = 64
_MAX_WIDTH = 128

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the plain version also runs in float64 (every product and sum in fp64):
# the reference K3's fp32 weight gradients, sums over ~20 k edge rows, are
# held against, since fp32 autograd rounds those sums as much as K3 does
REFERENCE_DTYPES = {**COMPUTE_DTYPES, "float64": torch.float64}

launches = 0
bwd_launches = 0

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


def _acc(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype: fp32, or fp64 for the float64 plain version."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _edge_terms(weights: tuple, x_dir: torch.Tensor, d_rbf: torch.Tensor,
                dt: torch.dtype) -> Tensors:
    """Group-level edge terms in the compute dtype: rterm [G,Nd,K,S] (an
    fp32 product plus the bias, rounded once) and dirterm [G,Nd,K,3,H0]."""
    wh0, _, w1_d, _, b1 = weights[:5]
    acc = _acc(dt)
    rterm = (d_rbf.to(dt).to(acc) @ w1_d.to(dt).to(acc)
             + b1.to(dt).to(acc)).to(dt)
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
    acc = _acc(dt)

    def dot(a, m):
        # fp32 (fp64) accumulation, one rounding to the compute dtype
        return torch.matmul(a.to(acc), m.to(acc)).to(dt)

    def norms(vh):
        sq = vh.to(acc) ** 2
        tot = sq[..., 0, :] + sq[..., 1, :] + sq[..., 2, :]
        return torch.sqrt(torch.clamp(tot, min=1e-8)).to(dt)

    def silu(x):
        xf = x.to(acc)
        return (xf * torch.sigmoid(xf)).to(dt)

    def sigmoid(x):
        return torch.sigmoid(x.to(acc)).to(dt)

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
    m = mask.to(acc)[..., None]
    s_sum = torch.sum(feats.to(acc) * m, dim=2)
    v_sum = torch.sum(vec.to(acc) * m[..., None], dim=2)
    return s_sum, v_sum.transpose(-1, -2)


def message_agg_reference(pre_s: torch.Tensor,
                          vh_planes: Sequence[torch.Tensor], edge,
                          layer_params: Sequence[torch.nn.Module], *,
                          scalar_size: int, vector_size: int, rbf_dim: int,
                          compute_dtype: str = "float32",
                          copies: int = 1) -> Tensors:
    """Plain version, the contract of `fused_message_agg`. Differentiable:
    autograd through it is the plain version of K3. `compute_dtype` may
    also be "float64" (sums returned in fp64)."""
    del vector_size
    dt = REFERENCE_DTYPES[compute_dtype]
    weights = split_weights(layer_params, scalar_size, rbf_dim)
    rterm, dirterm = _edge_terms(weights, edge.x_dir, edge.d_rbf, dt)
    tab_v = torch.stack(list(vh_planes), dim=2).to(dt)
    return _chain_plain(pre_s.to(dt), tab_v, edge.idx, edge.mask, rterm,
                        dirterm, weights, dt, copies)


def _pack_weights(weights: tuple, dt: torch.dtype) -> torch.Tensor:
    """The kernels' weight buffer: GVP 0's (w1_sh, wg, bg, wu), then each
    later GVP's (wh, wu, w1f, w1sh, b1, wg, bg), each flattened row-major
    ([in, out]) and zero-padded to a multiple of 8 elements
    (csrc/pp_message*.cu, `layer0_offsets` / `layerj_offsets`)."""
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
    lib.pp_message_weights_size.argtypes = [ctypes.c_int] * 5
    lib.pp_message_weights_size.restype = ctypes.c_int
    lib.pp_message_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.pp_message_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _bwd_launcher():
    from pharmaforge_tpu_torch.ops import _build
    lib = _build.load("pp_message_bwd")
    fn = lib.pp_message_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.pp_message_bwd_scratch_floats.argtypes = [ctypes.c_int] * 10
    lib.pp_message_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.pp_message_bwd_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.pp_message_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.pp_message_bwd_grads_size.argtypes = [ctypes.c_int] * 6
    lib.pp_message_bwd_grads_size.restype = ctypes.c_int
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_message_agg: {msg}")


@dataclasses.dataclass(frozen=True)
class _Dims:
    """Shapes of one call (B = G * copies)."""
    b: int
    p: int
    g: int
    copies: int
    nd: int
    k: int
    s: int
    v: int
    h0: int
    hj: int
    r: int
    n_layers: int
    dt: torch.dtype


def _dims(pre_s, planes, edge, weights, *, scalar_size, vector_size,
          rbf_dim, compute_dtype, copies) -> _Dims:
    """Check a CUDA call's inputs against the kernels' contract."""
    b, p, s = pre_s.shape
    g, nd, k = edge.mask.shape
    h0 = planes[0].shape[-1]
    n_layers = 1 + (len(weights) - 7) // 7
    hj = weights[7].shape[1] if n_layers > 1 else 0
    v = vector_size
    _check(s == scalar_size, f"pre_s has {s} channels, scalar_size is "
                             f"{scalar_size}")
    _check(g * copies == b, f"edge batch {g} x copies {copies} != table "
                            f"batch {b}")
    _check(len(planes) == 3 and all(tuple(q.shape) == (b, p, h0)
                                    for q in planes),
           "vh_planes must be three [B, P, H0] tensors")
    _check(tuple(edge.idx.shape) == (g, nd, k), "idx and mask shapes differ")
    _check(tuple(edge.d_rbf.shape) == (g, nd, k, rbf_dim),
           f"d_rbf must be [G, Nd, K, {rbf_dim}]")
    _check(1 <= k <= _MAX_K, f"K={k} outside [1, {_MAX_K}]")
    _check(max(s, v, h0, hj, rbf_dim) <= _MAX_WIDTH,
           f"widths S={s} V={v} H0={h0} Hj={hj} R={rbf_dim} above "
           f"{_MAX_WIDTH}")
    _check(all(weights[j].shape[1] == hj for j in range(7, len(weights), 7)),
           "every message GVP after the first must have one hidden width")
    dev = pre_s.device
    for name, t in (("pre_s", pre_s), ("vh_planes", planes[0]),
                    ("idx", edge.idx), ("mask", edge.mask),
                    ("x_dir", edge.x_dir), ("d_rbf", edge.d_rbf),
                    ("weights", weights[0])):
        _check(t.device == dev, f"{name} on {t.device}, pre_s on {dev}")
    return _Dims(b, p, g, copies, nd, k, s, v, h0, hj, rbf_dim, n_layers,
                 COMPUTE_DTYPES[compute_dtype])


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_fwd(d: _Dims, tab_s, tab_v, idx, mask, rterm, dirterm,
                packed) -> Tensors:
    """K2 on contiguous kernel inputs: (s_sum [B,Nd,S], v_sum [B,Nd,V,3])."""
    lib = _launcher()
    bf16 = int(d.dt == torch.bfloat16)
    _check(lib.pp_message_smem_bytes(bf16, d.s, d.v, d.h0, d.hj, d.n_layers)
           <= _MAX_SMEM, "the widths need more shared memory than a block "
                         "has")
    _check(packed.numel() == lib.pp_message_weights_size(
        d.s, d.v, d.h0, d.hj, d.n_layers),
        "packed weight layout differs from the kernel's")
    dev = tab_s.device
    s_sum = torch.empty((d.b, d.nd, d.s), dtype=torch.float32, device=dev)
    v_sum = torch.empty((d.b, d.nd, d.v, 3), dtype=torch.float32, device=dev)
    if d.b * d.nd == 0:
        return s_sum, v_sum
    with torch.cuda.device(dev):
        err = lib.pp_message_launch(
            bf16, tab_s.data_ptr(), tab_v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), rterm.data_ptr(),
            dirterm.data_ptr(), packed.data_ptr(), d.b, d.p, d.g, d.copies,
            d.nd, d.k, d.s, d.v, d.h0, d.hj, d.n_layers, s_sum.data_ptr(),
            v_sum.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"pp_message kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return s_sum, v_sum


@functools.cache
def _bwd_scratch(dev: torch.device, d: _Dims) -> int:
    """4-byte words of K3's scratch at these shapes (each block's fp32
    weight-gradient slice, the work items' counts), queried once per device
    and shape."""
    with torch.cuda.device(dev):
        words = _bwd_launcher().pp_message_bwd_scratch_floats(
            int(d.dt == torch.bfloat16), d.b, d.nd, d.k, d.s, d.v, d.h0,
            d.hj, d.r, d.n_layers)
    if words <= 0:
        raise RuntimeError(f"pp_message_bwd kernel setup failed: CUDA error "
                           f"{-words}")
    return words


def _launch_bwd(d: _Dims, saved: tuple, ds: torch.Tensor, dv: torch.Tensor
                ) -> tuple:
    """K3 on K2's kernel inputs and the output cotangents ds [B,Nd,S],
    dv [B,Nd,V,3]: (d_tab_s [B,P,S] and d_tab_v [B,P,3,H0] fp32, the flat
    weight gradients in `split_weights` order, summed in fp64). Each block
    of the kernel sums its weight gradients into its own fp32 slice of a
    scratch buffer; another kernel adds the slices in block order."""
    tab_s, tab_v, idx, mask, rterm, dirterm, rbf, xdir, packed = saved
    lib = _bwd_launcher()
    _check(lib.pp_message_bwd_smem_bytes(d.s, d.v, d.h0, d.hj, d.r,
                                         d.n_layers) <= _MAX_SMEM,
           "the widths need more shared memory than a backward block has")
    dev = tab_s.device
    ds = ds.to(torch.float32).contiguous()
    dv = dv.to(torch.float32).contiguous()
    _check(tuple(ds.shape) == (d.b, d.nd, d.s)
           and tuple(dv.shape) == (d.b, d.nd, d.v, 3),
           "output cotangents differ from the outputs' shapes")
    d_tab_s = torch.zeros((d.b, d.p, d.s), dtype=torch.float32, device=dev)
    d_tab_v = torch.zeros((d.b, d.p, 3, d.h0), dtype=torch.float32,
                          device=dev)
    n_w = lib.pp_message_bwd_grads_size(d.s, d.v, d.h0, d.hj, d.r,
                                        d.n_layers)
    d_w = torch.zeros(n_w, dtype=torch.float64, device=dev)
    if d.b * d.nd == 0:
        return d_tab_s, d_tab_v, d_w
    words = _bwd_scratch(dev, d)
    scratch = torch.empty(words, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pp_message_bwd_launch(
            int(d.dt == torch.bfloat16), tab_s.data_ptr(), tab_v.data_ptr(),
            idx.data_ptr(), mask.data_ptr(), rterm.data_ptr(),
            dirterm.data_ptr(), rbf.data_ptr(), xdir.data_ptr(),
            packed.data_ptr(), ds.data_ptr(), dv.data_ptr(), d.b, d.p, d.g,
            d.copies, d.nd, d.k, d.s, d.v, d.h0, d.hj, d.r, d.n_layers,
            d_tab_s.data_ptr(), d_tab_v.data_ptr(), d_w.data_ptr(),
            scratch.data_ptr(), words, _stream(dev))
    if err != 0:
        raise RuntimeError(f"pp_message_bwd kernel launch failed: CUDA "
                           f"error {err}")
    global bwd_launches
    bwd_launches += 1
    return d_tab_s, d_tab_v, d_w


def kernel_inputs(d: _Dims, pre_s, planes, edge, weights) -> tuple:
    """The contiguous tensors K2 and K3 read: (tab_s [B,P,S],
    tab_v [B,P,3,H0], idx int32, mask fp32, rterm, dirterm, rbf, x_dir,
    packed weights), in the compute dtype where not stated."""
    dt = d.dt
    rterm, dirterm = _edge_terms(weights, edge.x_dir, edge.d_rbf, dt)
    return (pre_s.to(dt).contiguous(),
            torch.stack(list(planes), dim=2).to(dt).contiguous(),
            edge.idx.to(torch.int32).contiguous(),
            edge.mask.to(torch.float32).contiguous(),
            rterm.contiguous(), dirterm.contiguous(),
            edge.d_rbf.to(dt).contiguous(), edge.x_dir.to(dt).contiguous(),
            _pack_weights(weights, dt))


def message_agg_cost(pre_s, vh_planes, edge, layer_params, *,
                     scalar_size: int, vector_size: int, rbf_dim: int,
                     copies: int = 1, **_) -> Tuple[int, int, int]:
    """(bytes, operations, edge rows) of one `fused_message_agg` call (its
    arguments), counting what this call's data needs: the tables and the
    weights read once, idx and mask of every group-level slot, x_dir and
    d_rbf of the slots whose mask is set (a masked slot's geometry is
    never used), and the fp32 outputs written once; two operations per
    multiply-add of the edge terms over the valid group-level slots and
    of the chain over the valid edge rows. The least work K2 can do: the
    yardstick of its bound, and its share of a step's FLOPs where a
    counter of PyTorch's ops cannot see the kernel. One host sync (the
    valid slots)."""
    s, v, r = scalar_size, vector_size, rbf_dim
    b, p, _ = pre_s.shape
    g, nd, k = edge.mask.shape
    h0 = vh_planes[0].shape[-1]
    w = split_weights(layer_params, s, r)
    hj = w[7].shape[1] if len(w) > 7 else 0
    n_j = (len(w) - 7) // 7
    valid = int(edge.mask.sum())
    n_bytes = (pre_s.numel() * pre_s.element_size()
               + sum(a.numel() * a.element_size() for a in vh_planes)
               + sum(a.numel() * a.element_size() for a in w)
               + g * nd * k * (edge.idx.element_size()
                               + edge.mask.element_size())
               + valid * (3 * edge.x_dir.element_size()
                          + r * edge.d_rbf.element_size())
               + 4 * b * nd * (s + 3 * v))
    macs = (h0 * s + s * v + 3 * h0 * v
            + n_j * (3 * v * hj + s * s + hj * s + s * v + 3 * hj * v))
    rows = valid * copies
    return n_bytes, 2 * (macs * rows + (r * s + 3 * h0) * valid), rows


class _FusedMessageAgg(torch.autograd.Function):
    """K2 forward, K3 backward. Inputs: the call's shapes, the edge
    descriptors (no gradient), pre_s, the three vh planes and the split
    weights."""

    @staticmethod
    def forward(ctx, d: _Dims, edge, pre_s, p0, p1, p2, *weights):
        saved = kernel_inputs(d, pre_s, (p0, p1, p2), edge, weights)
        out = _launch_fwd(d, *saved[:6], saved[8])
        ctx.d = d
        ctx.shapes = [(w.shape, w.dtype) for w in weights]
        ctx.table_dtypes = (pre_s.dtype, p0.dtype, p1.dtype, p2.dtype)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, ds, dv):
        d = ctx.d
        d_tab_s, d_tab_v, d_w = _launch_bwd(d, ctx.saved_tensors, ds, dv)
        grads, off = [], 0
        for shape, dtype in ctx.shapes:
            n = shape.numel()
            grads.append(d_w[off:off + n].view(shape).to(dtype))
            off += n
        dt_s, *dt_v = ctx.table_dtypes
        return (None, None, d_tab_s.to(dt_s),
                *(d_tab_v[:, :, c].to(dt_v[c]) for c in range(3)), *grads)


def fused_message_agg(pre_s: torch.Tensor, vh_planes: Sequence[torch.Tensor],
                      edge, layer_params: Sequence[torch.nn.Module], *,
                      scalar_size: int, vector_size: int, rbf_dim: int,
                      compute_dtype: str = "float32",
                      copies: int = 1) -> Tensors:
    """Fused (gather -> message chain -> masked K-sum) for the prot-prot
    edge type; differentiable in the node tables and the GVP weights.

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
    if torch.is_grad_enabled() and (edge.x_dir.requires_grad
                                    or edge.d_rbf.requires_grad):
        raise RuntimeError(
            "fused_message_agg: the edge geometry (x_dir, d_rbf) gets no "
            "gradient (the backward kernel, like the JAX package's, "
            "differentiates the node tables and weights only); detach it")
    dev = pre_s.device
    kw = dict(scalar_size=scalar_size, vector_size=vector_size,
              rbf_dim=rbf_dim, compute_dtype=compute_dtype, copies=copies)
    if dev.type == "cpu":
        return message_agg_reference(pre_s, planes, edge, layer_params, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_message_agg: unsupported device {dev}")
    d = _dims(pre_s, planes, edge, weights, **kw)
    return _FusedMessageAgg.apply(d, edge, pre_s, *planes, *weights)
