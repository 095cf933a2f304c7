"""K3's work: the backward of one `fused_message_agg` call
(`csrc/pp_message_bwd.cu`).

A copy of `chip_smoke.py::ppbwd_bound`, as a function of the call's
shapes and valid counts: the node tables and weights read once in the
compute dtype, idx and mask of every group-level slot, x_dir and d_rbf of
the slots whose mask is set, the fp32 cotangents read once, its outputs
written once (fp32 node-table gradients, fp64 weight gradients); two
operations per multiply-add of the chain's recompute and backward over
the valid edge rows."""

from portbench.costs.k2 import chain_dims


def cost(*, b: int, p: int, g: int, nd: int, k: int, valid: int,
         copies: int, s: int, v: int, r: int, n_gvps: int, elem: int,
         idx_bytes: int = 8, mask_bytes: int = 1, geom_bytes: int = 4):
    """(bytes, operations, edge rows) of one call, `elem` bytes per
    element of the compute dtype."""
    h0, hj, n_j, grads = chain_dims(s, v, r, n_gvps)
    n_bytes = (elem * (b * p * (s + 3 * h0) + grads)
               + g * nd * k * (idx_bytes + mask_bytes)
               + valid * (3 + r) * geom_bytes
               + 4 * b * nd * (s + 3 * v)
               + 4 * b * p * (s + 3 * h0) + 8 * grads)
    fwd = (h0 * s + s * v + 3 * h0 * v
           + n_j * (3 * v * hj + s * s + hj * s + s * v + 3 * hj * v))
    bwd = (2 * s * v + 6 * h0 * v + r * s + 2 * h0 * s + 3 * h0
           + n_j * (2 * s * v + 12 * v * hj + 2 * s * s + 2 * hj * s))
    rows = valid * copies
    return n_bytes, 2 * (fwd + bwd) * rows, rows
