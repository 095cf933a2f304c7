"""K2's work: one `fused_message_agg` call, the prot-prot message chain
gathered, computed and summed per destination (`csrc/pp_message.cu`).

A copy of `ops/pp_message.py::message_agg_cost`, as a function of the
call's shapes and valid counts: the node tables and the weights read once,
idx and mask of every group-level slot, x_dir and d_rbf of the slots whose
mask is set (a masked slot's geometry is never used), the fp32 outputs
written once; two operations per multiply-add of the edge terms over the
valid group-level slots and of the chain over the valid edge rows."""


def chain_dims(s: int, v: int, r: int, n_gvps: int):
    """(H0, Hj, number of later GVPs, weight elements) of a message chain
    of `n_gvps` GVPs at S scalars, V vectors and r RBF channels."""
    h0, hj, n_j = v + 1, v, n_gvps - 1
    first = h0 + h0 * v + r * s + h0 * s + s + s * v + v
    later = v * hj + hj * v + s * s + hj * s + s + s * v + v
    return h0, hj, n_j, first + n_j * later


def cost(*, b: int, p: int, g: int, nd: int, k: int, valid: int,
         copies: int, s: int, v: int, r: int, n_gvps: int,
         table_bytes: int, idx_bytes: int = 8, mask_bytes: int = 1,
         geom_bytes: int = 4, weight_bytes: int = 4):
    """(bytes, operations, edge rows) of one call: node tables [B, P] in
    `table_bytes` per element, the edge [G, Nd, K] at group level with
    `valid` set slots, each used by `copies` batch rows."""
    h0, hj, n_j, n_w = chain_dims(s, v, r, n_gvps)
    n_bytes = (b * p * s * table_bytes + 3 * b * p * h0 * table_bytes
               + n_w * weight_bytes
               + g * nd * k * (idx_bytes + mask_bytes)
               + valid * (3 + r) * geom_bytes
               + 4 * b * nd * (s + 3 * v))
    macs = (h0 * s + s * v + 3 * h0 * v
            + n_j * (3 * v * hj + s * s + hj * s + s * v + 3 * hj * v))
    rows = valid * copies
    return n_bytes, 2 * (macs * rows + (r * s + 3 * h0) * valid), rows
