"""The GVP-chain kernel's wrapper (`ops/gvp_chain.py`, K4) on the CPU: the
plain chain it runs there, the rule `models/gvp.py::run_gvps` applies
(the kernel only for CUDA tensors that need no gradient), the launch
counter, the kernel's limits and its shared-memory plan. The kernel itself
is held to the plain chain by the `cuda` tests in
`test_torch_port_cuda.py`. No JAX: the arithmetic is the port's own GVP,
which `test_torch_port_modules.py` holds to the JAX package."""

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu_torch.models.conv import message_specs
from pharmaforge_tpu_torch.models.dynamics import NoisePredictionBlock
from pharmaforge_tpu_torch.models.gvp import (
    GVPChain,
    gvp_specs,
    reset_parameters_,
    run_gvps,
)
from pharmaforge_tpu_torch.ops import gvp_chain as gc
from pharmaforge_tpu_torch.utils import trace

# pforge-full's chains at narrow widths: (scalars, vectors) in, and the
# chain. The message chain's first GVP takes 16 RBF channels and the unit
# direction beside the source; the noise head's last GVP is identity-gated
# (64 scalars at full width, 1 vector).
CHAINS = {
    "message": lambda: GVPChain(message_specs(3, 8, 32, 16)),
    "update": lambda: GVPChain(gvp_specs(2, 8, 32)),
    "noise": lambda: NoisePredictionBlock(32, 6, 8, n_gvps=4,
                                          intermediate_scalar_dim=16).gvps,
}


def chain_case(kind: str, dtype=torch.float32, rows=(3, 5), seed=0):
    gen = torch.Generator().manual_seed(seed)
    chain = reset_parameters_(CHAINS[kind](), gen)
    g0 = chain[0]
    s_in = g0.to_feats_out[0].weight.shape[1] - g0.Wh.shape[1]
    feats = torch.randn(*rows, s_in, generator=gen).to(dtype)
    vectors = torch.randn(*rows, g0.Wh.shape[0], 3, generator=gen).to(dtype)
    return chain, feats, vectors


def old_chain(chain, data):
    """`GVPChain.forward` as it was: each GVP in turn."""
    for layer in chain:
        data = layer(data)
    return data


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(CHAINS))
def test_wrapper_equals_the_plain_chain_on_cpu(kind, dtype):
    chain, feats, vectors = chain_case(kind, dtype)
    want = old_chain(chain, (feats, vectors))
    for got in (gc.fused_gvp_chain(list(chain), feats, vectors),
                chain((feats, vectors)),
                gc.gvp_chain_reference(list(chain), feats, vectors)):
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
    u = chain[-1].Wu.shape[1]
    assert want[1].shape == feats.shape[:-1] + (u, 3)


def test_a_chain_that_needs_a_gradient_runs_autograd():
    """Inputs that require grad take the plain chain, which passes a
    gradient to every parameter and to the inputs."""
    chain, feats, vectors = chain_case("message")
    feats.requires_grad_(True)
    s, v = chain((feats, vectors))
    (s.square().sum() + v.square().sum()).backward()
    assert feats.grad is not None and feats.grad.abs().sum() > 0
    for name, p in chain.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_which_calls_need_a_gradient():
    chain, feats, vectors = chain_case("update")
    gvps = list(chain)
    assert gc.needs_grad(gvps, feats, vectors)        # trainable weights
    with torch.no_grad():
        assert not gc.needs_grad(gvps, feats, vectors)
    chain.requires_grad_(False)
    assert not gc.needs_grad(gvps, feats, vectors)
    assert gc.needs_grad(gvps, feats.requires_grad_(True), vectors)


def test_run_gvps_keeps_cpu_tensors_on_the_plain_chain(monkeypatch):
    """On the CPU `run_gvps` never reaches the wrapper, with or without a
    gradient, so the CPU tests against the JAX package see the old code."""
    from pharmaforge_tpu_torch.models import gvp
    called = []
    monkeypatch.setattr(gvp, "fused_gvp_chain",
                        lambda *a: called.append(a) or None)
    chain, feats, vectors = chain_case("noise")
    with torch.no_grad():
        got = run_gvps(list(chain), (feats, vectors))
    want = old_chain(chain, (feats, vectors))
    assert not called
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_calls_count_no_launches():
    before = trace.counters()["gvp_chain.launches"]
    for kind in CHAINS:
        chain, feats, vectors = chain_case(kind)
        with torch.no_grad():
            gc.fused_gvp_chain(list(chain), feats, vectors)
            chain((feats, vectors))
    assert trace.counters()["gvp_chain.launches"] == before


def wide_chain(n: int = 2, s: int = 32, v: int = 8, **first) -> list:
    specs = gvp_specs(n, v, s)
    specs[0] = dict(specs[0], **first)
    return list(GVPChain(specs))


@pytest.mark.parametrize("case,match", [
    ("nine GVPs", "1 to 8"),
    ("S_out 129", "at most 128"),
    ("V_out 129", "at most 128"),
    ("shared memory", "shared memory"),
    ("float64", "float32 or bfloat16"),
    ("mixed dtypes", "float32 or bfloat16"),
    ("input width", "do not match"),
    ("bf16 weights", "parameters must be float32"),
    ("chain break", "GVP 1 takes"),
])
def test_wrapper_raises_beyond_the_kernels_limits(case, match):
    feats, vectors = torch.zeros(4, 32), torch.zeros(4, 8, 3)
    gvps = wide_chain()
    if case == "nine GVPs":
        gvps = wide_chain(9)
    elif case == "S_out 129":
        gvps = wide_chain(1, dim_feats_out=129)
    elif case == "V_out 129":
        gvps = wide_chain(1, dim_vectors_out=129)
    elif case == "shared memory":
        # 256 scalars in and out at 64 vectors: one fp32 GVP's weights alone
        # exceed a block's shared memory
        gvps = wide_chain(1, s=256, v=64, dim_feats_out=128)
        feats, vectors = torch.zeros(4, 256), torch.zeros(4, 64, 3)
    elif case == "float64":
        feats, vectors = feats.double(), vectors.double()
    elif case == "mixed dtypes":
        feats = feats.bfloat16()
    elif case == "input width":
        feats = torch.zeros(4, 31)
    elif case == "bf16 weights":
        gvps[0].to(torch.bfloat16)
    elif case == "chain break":
        gvps = [gvps[0], wide_chain(1, s=16)[0]]
    with pytest.raises(ValueError, match=match):
        gc.fused_gvp_chain(gvps, feats, vectors)


def test_shared_memory_plan_at_the_step_widths():
    """pforge-full's chains fit a block at every tile height in both
    dtypes; tiles follow the row count: 16 rows spread the 960-row chains
    over 60 SMs; the larger chains take the tile with the fewest waves, 32
    bf16 rows (two blocks a SM) or 64 fp32 rows (one)."""
    msg = gc.layer_dims(list(GVPChain(message_specs(3, 16, 128, 16))))
    upd = gc.layer_dims(list(GVPChain(gvp_specs(2, 16, 128))))
    for dims in (msg, upd):
        for bf16 in (True, False):
            assert all(gc.smem_bytes(bf16, r, dims) <= gc.MAX_SMEM
                       for r in gc.TILE_ROWS)
    # the step's row counts on 132 SMs
    for dims, bf16, tile in ((upd, False, 64), (msg, True, 32)):
        picks = {rows: gc.rows_per_block(rows, 132, bf16, dims)
                 for rows in (960, 1024, 4800, 7680, 16384, 30720)}
        assert picks == {960: 16, 1024: 16, 4800: tile, 7680: tile,
                         16384: tile, 30720: tile}
