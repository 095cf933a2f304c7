"""A chain of GVPs in one launch: the K4 kernel's wrapper and its plain
twin.

K4, `csrc/gvp_chain.cu`, replaces no Pallas kernel (the JAX package
leaves the GVP to XLA's fusion). It runs a whole `GVPChain` forward --
every GVP's two vector products, channel norms, feature and gate products
and activations -- as one launch, where the plain chain takes ~17 PyTorch
launches a GVP. The activations stay on chip; the weights are read in
place from the fp32 parameters and rounded to the chain's dtype as the
kernel stages them.

`gvp_chain_reference` is the plain chain, the GVP's PyTorch code
(`models/gvp.py::GVP.forward`) applied in turn. `fused_gvp_chain` checks
the chain against the kernel's limits (raising `ValueError` beyond them),
then runs the plain chain for CPU tensors and launches K4 for CUDA
tensors. It has no backward: a CUDA call whose inputs or weights need a
gradient raises. `models/gvp.py::run_gvps` decides which of the two a
chain takes. The counter `gvp_chain.launches` (`utils/trace.py`) counts
K4 launches; inside a CUDA graph capture a launch counts once, where it is
captured, and the graph's replays count theirs under
`<kind>.replayed.gvp_chain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
from torch import nn

from pharmaforge_tpu_torch.utils import trace

# the kernel's limits (csrc/gvp_chain.cu): GVPs in a chain; S_out, V_out
# and the hidden vector width of each GVP; shared memory a block may use
# on Hopper (bytes)
MAX_LAYERS = 8
MAX_WIDTH = 128
MAX_SMEM = 232448
# shared memory of a Hopper SM that blocks can share (228 KB less the 1 KB
# each block reserves, for two blocks)
MAX_SMEM_SM = 231424
# rows a block holds, largest first; the kernel has an instantiation for
# each, in each dtype
TILE_ROWS = (64, 32, 16)
DTYPES = (torch.float32, torch.bfloat16)
# activation codes of the kernel
ACTIVATIONS = {nn.Identity: 0, nn.SiLU: 1, nn.Sigmoid: 2}

Tensors = Tuple[torch.Tensor, torch.Tensor]


def gvp_chain_reference(gvps: Sequence[nn.Module], feats: torch.Tensor,
                        vectors: torch.Tensor) -> Tensors:
    """The plain chain: each GVP's PyTorch forward in turn."""
    data = (feats, vectors)
    for gvp in gvps:
        data = gvp(data)
    return data


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_gvp_chain: {msg}")


def layer_dims(gvps: Sequence[nn.Module]) -> List[Tuple[int, ...]]:
    """Each GVP's (V_in, H, V_out, S_in, S_out, feature activation,
    vector activation) as the kernel takes them."""
    dims = []
    for g in gvps:
        v_in, h = g.Wh.shape
        u = g.Wu.shape[1]
        lin, act = g.to_feats_out
        o = lin.weight.shape[0]
        _check(type(act) in ACTIVATIONS
               and type(g.vectors_activation) in ACTIVATIONS,
               "activations must be identity, SiLU or sigmoid")
        dims.append((v_in, h, u, lin.weight.shape[1] - h, o,
                     ACTIVATIONS[type(act)],
                     ACTIVATIONS[type(g.vectors_activation)]))
    return dims


def _rup(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def smem_bytes(bf16: bool, rows_per_block: int, dims) -> int:
    """Dynamic shared memory of one K4 block, in bytes (mirrors
    `smem_layout` in csrc/gvp_chain.cu): the [row][channel] activation
    tiles and one GVP's staged weights and biases."""
    es = 2 if bf16 else 4
    q = 16 // es

    def ld(c):  # row stride: padded, odd in 16-byte units
        return _rup(c, 2 * q) + q

    def wsz(kd, n):  # staged weight block: mma fragments or fp32 rows
        return (_rup(kd, 16) * _rup(n, 8) if bf16
                else _rup(kd, 4) * (_rup(n, 4) + 4))

    def take(n_bytes):
        return _rup(n_bytes, 16)

    cx = max(max(s_in + h, o) for v_in, h, u, s_in, o, *_ in dims)
    cg = max(u for _, _, u, *_ in dims)
    cva = max(max(v_in, u) for v_in, _, u, *_ in dims)
    cvh = max(h for _, h, *_ in dims)
    cb = max(_rup(o, 4) + _rup(u, 4) for _, _, u, _, o, *_ in dims)
    cw = max(wsz(v_in, h) + wsz(h, u) + wsz(s_in + h, o) + wsz(o, u)
             for v_in, h, u, s_in, o, *_ in dims)
    r = rows_per_block
    return (take(es * r * ld(cx)) + take(es * r * ld(cg))
            + take(es * 3 * r * ld(cva)) + take(es * 3 * r * ld(cvh))
            + take(4 * cb) + take(es * cw))


def check_chain(gvps: Sequence[nn.Module], feats: torch.Tensor,
                vectors: torch.Tensor) -> List[Tuple[int, ...]]:
    """The chain's `layer_dims` after checking the call against the
    kernel's limits: 1 to MAX_LAYERS GVPs that chain, S_out, V_out and H
    at most MAX_WIDTH, fp32 or bf16 inputs of one dtype, fp32 weights, and
    a block of 16 rows within MAX_SMEM bytes of shared memory. Raises
    ValueError."""
    _check(1 <= len(gvps) <= MAX_LAYERS,
           f"{len(gvps)} GVPs, the kernel takes 1 to {MAX_LAYERS}")
    dims = layer_dims(gvps)
    for j, (v_in, h, u, s_in, o, *_) in enumerate(dims):
        _check(max(h, u, o) <= MAX_WIDTH,
               f"GVP {j}: S_out={o}, V_out={u} and H={h} must be at most "
               f"{MAX_WIDTH}")
        if j:
            _check((s_in, v_in) == (dims[j - 1][4], dims[j - 1][2]),
                   f"GVP {j} takes ({s_in}, {v_in}) channels, GVP {j - 1} "
                   f"gives ({dims[j - 1][4]}, {dims[j - 1][2]})")
    v_in, s_in = dims[0][0], dims[0][3]
    _check(feats.shape[-1] == s_in and tuple(vectors.shape[-2:]) == (v_in, 3)
           and feats.shape[:-1] == vectors.shape[:-2],
           f"inputs {tuple(feats.shape)} and {tuple(vectors.shape)} do not "
           f"match [..., {s_in}] and [..., {v_in}, 3]")
    _check(feats.dtype == vectors.dtype and feats.dtype in DTYPES,
           f"inputs in {feats.dtype} and {vectors.dtype}; the kernel takes "
           f"float32 or bfloat16, both alike")
    _check(all(p.dtype == torch.float32 for g in gvps for p in g.parameters()),
           "the GVPs' parameters must be float32")
    need = smem_bytes(feats.dtype == torch.bfloat16, TILE_ROWS[-1], dims)
    _check(need <= MAX_SMEM,
           f"the chain's widths need {need} bytes of shared memory at "
           f"{TILE_ROWS[-1]} rows, a block has {MAX_SMEM}")
    return dims


@functools.cache
def _launcher():
    from pharmaforge_tpu_torch.ops import _build
    lib = _build.load("gvp_chain")
    lib.gvp_chain_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.gvp_chain_launch.restype = ctypes.c_int
    lib.gvp_chain_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.gvp_chain_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rows_per_block(rows: int, n_sm: int, bf16: bool, dims) -> int:
    """The tile height of TILE_ROWS whose block fits in shared memory and
    whose waves of blocks cost least: a wave of blocks (two a SM where a
    block of at most 32 rows leaves room for two) takes about the time of
    a block, a fixed part (staging, barriers) worth ~32 rows plus its
    rows; ties go to the larger tile."""
    best, best_cost = TILE_ROWS[-1], None
    for r in TILE_ROWS:
        need = smem_bytes(bf16, r, dims)
        if need > MAX_SMEM:
            continue
        per_sm = 2 if r <= 32 and 2 * need <= MAX_SMEM_SM else 1
        waves = -(-(-(-rows // r)) // (per_sm * n_sm))
        cost = waves * (r + 32)
        if best_cost is None or cost < best_cost:
            best, best_cost = r, cost
    return best


def _c_dims(dims) -> ctypes.Array:
    flat = [x for d in dims for x in d]
    return (ctypes.c_int * len(flat))(*flat)


def _launch(gvps, dims, feats: torch.Tensor, vectors: torch.Tensor
            ) -> Tensors:
    """K4 on the chain's rows: (scalars [..., S_out], vectors
    [..., V_out, 3]) in the inputs' dtype."""
    dev, dt = feats.device, feats.dtype
    lead = feats.shape[:-1]
    rows = lead.numel()
    _check(rows < 2 ** 31, f"{rows} rows, the kernel takes fewer than 2^31")
    s_in = feats.reshape(rows, -1).contiguous()
    v_in = vectors.reshape(rows, -1).contiguous()
    o, u = dims[-1][4], dims[-1][2]
    s_out = torch.empty((rows, o), dtype=dt, device=dev)
    v_out = torch.empty((rows, u, 3), dtype=dt, device=dev)
    if rows:
        bf16 = dt == torch.bfloat16
        tile = rows_per_block(rows, _sm_count(dev.index
                                              if dev.index is not None
                                              else torch.cuda.current_device()),
                              bf16, dims)
        ptrs = []
        for g in gvps:
            lin = g.to_feats_out[0]
            gates = g.scalar_to_vector_gates
            for p in (g.Wh, g.Wu, lin.weight, lin.bias, gates.weight,
                      gates.bias):
                _check(p.device == dev and p.is_contiguous(),
                       f"parameters on {p.device} (contiguous: "
                       f"{p.is_contiguous()}), inputs on {dev}")
                ptrs.append(p.data_ptr())
        weights = (ctypes.c_void_p * len(ptrs))(*ptrs)
        with torch.cuda.device(dev):
            err = _launcher().gvp_chain_launch(
                int(bf16), tile, s_in.data_ptr(), v_in.data_ptr(), rows,
                len(dims), _c_dims(dims), weights, s_out.data_ptr(),
                v_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gvp_chain kernel launch failed: CUDA error "
                               f"{err}")
        trace.count("gvp_chain.launches")
    return s_out.reshape(*lead, o), v_out.reshape(*lead, u, 3)


def needs_grad(gvps: Sequence[nn.Module], feats: torch.Tensor,
               vectors: torch.Tensor) -> bool:
    """Whether autograd would record the chain: grad mode on, and the
    inputs or any GVP parameter requiring a gradient."""
    return torch.is_grad_enabled() and (
        feats.requires_grad or vectors.requires_grad
        or any(p.requires_grad for g in gvps for p in g.parameters()))


def fused_gvp_chain(gvps: Sequence[nn.Module], feats: torch.Tensor,
                    vectors: torch.Tensor) -> Tensors:
    """The GVPs `gvps` applied in turn to (feats [..., S_in],
    vectors [..., V_in, 3]): the plain chain for CPU tensors, one K4
    launch for CUDA tensors. Returns (scalars [..., S_out],
    vectors [..., V_out, 3]) in the inputs' dtype. Raises ValueError for a
    chain beyond the kernel's limits (`check_chain`), on any device, and
    RuntimeError for a CUDA call that needs a gradient."""
    gvps = list(gvps)
    dims = check_chain(gvps, feats, vectors)
    dev = feats.device
    if dev.type == "cpu":
        return gvp_chain_reference(gvps, feats, vectors)
    _check(dev.type == "cuda" and vectors.device == dev,
           f"inputs on {dev} and {vectors.device}")
    if needs_grad(gvps, feats, vectors):
        raise RuntimeError("fused_gvp_chain: the kernel has no backward; "
                           "a chain that needs a gradient runs the plain "
                           "chain (models/gvp.py::run_gvps)")
    return _launch(gvps, dims, feats, vectors)
