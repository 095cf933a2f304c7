"""K4's work: one `fused_gvp_chain` call, a chain of GVPs over its rows in
one launch (`csrc/gvp_chain.cu`).

A copy of `chip_smoke.gvp_chain_cost`, as a function of the chain's
widths: the inputs and outputs at the dtype's width and the fp32 weights
each read once; two operations a multiply-add of each GVP's five products
(the two vector products, the feature product over scalars and channel
norms, the gate product) over every row."""

from __future__ import annotations

from typing import List, Sequence, Tuple

Dims = Tuple[int, int, int, int, int]


def dims(gvps) -> List[Dims]:
    """Each GVP's (V_in, H, V_out, S_in, S_out), read from its parameters'
    shapes (Wh [V_in, H], Wu [H, V_out], the feature Linear's weight
    [S_out, S_in + H])."""
    out = []
    for g in gvps:
        v_in, h = g.Wh.shape
        o, width = g.to_feats_out[0].weight.shape
        out.append((int(v_in), int(h), int(g.Wu.shape[1]), int(width - h),
                    int(o)))
    return out


def weights(chain: Sequence[Dims]) -> int:
    """The chain's parameters: Wh, Wu, the feature Linear's weight and
    bias, the gate Linear's weight and bias."""
    return sum(v_in * h + h * u + (s_in + h) * o + o + o * u + u
               for v_in, h, u, s_in, o in chain)


def cost(chain: Sequence[Dims], rows: int, dtype: str):
    """(bytes, operations) of one call over `rows` rows in `dtype`
    ("float32" or "bfloat16")."""
    es = 2 if dtype == "bfloat16" else 4
    macs = sum(3 * v_in * h + 3 * h * u + (s_in + h) * o + o * u
               for v_in, h, u, s_in, o in chain)
    v_in, s_in = chain[0][0], chain[0][3]
    u, o = chain[-1][2], chain[-1][4]
    n_bytes = rows * es * (s_in + 3 * v_in + o + 3 * u) + 4 * weights(chain)
    return n_bytes, 2 * macs * rows
