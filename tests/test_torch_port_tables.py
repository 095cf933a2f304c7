"""PyTorch/CUDA port, slice 10: the sampling chain's step tables
(`models/dynamics.py::precompute_sampling_tables`, `precompute_step_tables`)
against the JAX package's on the CPU, at a tiny size (S=32, V=8, T=3-6).

The five cases of tests/test_step_tables.py (ungrouped at message_norm
'mean', 0 and 10; grouped with the dev-style compact first conv;
n_convs=3; n_convs=1 without a pp chain; the budget gate), each with the
same weights (`params_from_jax`) and the same injected noise: the port's
chain with tables against the JAX chain with tables at rtol 1e-4 /
atol 1e-5, and against the port's own chain without them at the same
tolerance. One case JAX's file lacks, the full-scale dataflow (n_convs=4,
`fused_pp`, grouped, the pocket-copy correction on; JAX through its
interpreted kernel): the chain tolerance 2e-3 of
tests/test_torch_port_corr.py. The tables built in chunks of steps equal
the tables built at once, bit for bit, in fp32 and bf16. JAX matmuls run
in full fp32 (tests/conftest.py).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.data.batch import PharmComplexBatch as JaxBatch
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu_torch.data.batch import concat_batches, tile_pocket
from pharmaforge_tpu_torch.interop import params_from_jax
from pharmaforge_tpu_torch.models import diffusion as tdiffusion
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
    step_table_plan,
)
from pharmaforge_tpu_torch.models.dynamics import (
    precompute_sampling_tables,
)
from pharmaforge_tpu_torch.models.edges import build_pp_edge
from pharmaforge_tpu_torch.training.sampling import probe_pp_k_out

TOL = dict(rtol=1e-4, atol=1e-5)


def tiny_kw(**kw):
    base = dict(n_timesteps=6, n_convs=2, vector_size=8, n_hidden_scalars=32,
                message_norm="mean", n_message_gvps=2, n_update_gvps=1,
                n_noise_gvps=2, pf_k=4, pp_k_max=8)
    base.update(kw)
    return base


def tiled_batch(rng, b=6, p=40):
    prot_x = rng.normal(scale=6.0, size=(p, 3)).astype(np.float32)
    prot_h = np.eye(11, dtype=np.float32)[rng.integers(0, 11, p)]
    return tile_pocket(prot_x, prot_h, rng.integers(3, 9, b))


def chain_noise(rng, batch, steps):
    b, f = batch.pharm_mask.shape
    noise = {"x_T": rng.normal(size=(b, f, 3)),
             "h_T": rng.normal(size=(b, f, 6)),
             "pos": rng.normal(size=(steps, b, f, 3)),
             "feat": rng.normal(size=(steps, b, f, 6))}
    return {k: v.astype(np.float32) for k, v in noise.items()}


def count_builds(monkeypatch) -> list:
    """Records the T of every step-table build of the port's chain."""
    seen = []
    real = tdiffusion.precompute_sampling_tables

    def spy(dynamics, prot_h, prot_mask, pp_edge, t_values, chunk):
        seen.append(t_values.shape[0])
        return real(dynamics, prot_h, prot_mask, pp_edge, t_values, chunk)

    monkeypatch.setattr(tdiffusion, "precompute_sampling_tables", spy)
    return seen


def run_cases(batch, group, seed=0, k_out=False, jax_kw=None, **kw):
    """The JAX chain with tables and the port's with and without them,
    from the same weights and noise: (JAX, port on, port off) outputs."""
    rng = np.random.default_rng(seed + 10)
    steps = kw.get("n_timesteps", 6)
    noise = chain_noise(rng, batch, steps)
    jbatch = JaxBatch(**dataclasses.asdict(batch))
    jmodel = JaxDiffusion(JaxConfig(**tiny_kw(**{
        **kw, "precompute_step_tables": True, **(jax_kw or {})})))
    params = jax.device_get(jmodel.init_params(jax.random.key(seed), jbatch))
    outs = []
    for on in (True, False):
        cfg = DiffusionConfig(**tiny_kw(precompute_step_tables=on, **kw))
        model = PharmacophoreDiffusion(cfg, device="cpu")
        model.load_state_dict(params_from_jax(params, cfg))
        pp_k_out = probe_pp_k_out(model, batch.prot_x[::group],
                                  batch.prot_mask[::group]) if k_out else 0
        outs.append(model.sample_given_receptor(
            batch, noise=noise, pocket_group_size=group, pp_k_out=pp_k_out))
    want = jmodel.sample_given_receptor(
        params, jbatch, jax.random.key(1), noise=noise,
        pocket_group_size=group, pp_k_out=pp_k_out)
    return want, outs[0], outs[1]


def assert_close(got, want, tol, what):
    for key in ("pharm_x", "pharm_h"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), **tol,
            err_msg=f"{what} {key}")


@pytest.mark.parametrize("message_norm", ["mean", 0, 10])
def test_tables_match_jax_ungrouped(monkeypatch, message_norm):
    builds = count_builds(monkeypatch)
    batch = tiled_batch(np.random.default_rng(0))
    want, on, off = run_cases(batch, 1, message_norm=message_norm)
    assert builds == [6]
    assert_close(on, want, TOL, "port tables vs JAX tables")
    assert_close(on, off, TOL, "port tables on vs off")


def test_tables_match_jax_grouped(monkeypatch):
    """Two pockets x 3 copies: the first conv is the compact one, so the
    prot scalars stay at group level through it."""
    builds = count_builds(monkeypatch)
    rng = np.random.default_rng(1)
    batch = concat_batches([tiled_batch(rng, b=3, p=32),
                            tiled_batch(rng, b=3, p=32)])
    want, on, off = run_cases(batch, 3)
    assert builds == [6]
    assert_close(on, want, TOL, "port tables vs JAX tables")
    assert_close(on, off, TOL, "port tables on vs off")


def test_tables_match_jax_deeper_stack():
    """n_convs=3: the first conv is not the compact one, so the group-level
    encoder output is repeated per copy."""
    batch = tiled_batch(np.random.default_rng(2), b=4, p=36)
    want, on, off = run_cases(batch, 2, n_convs=3)
    assert_close(on, want, TOL, "port tables vs JAX tables")
    assert_close(on, off, TOL, "port tables on vs off")


def test_tables_match_jax_single_conv_without_pp(monkeypatch):
    """n_convs=1 with the pruned prot tail: no pp chain, so only the
    encoder and the pf table are built."""
    seen = []
    real = precompute_sampling_tables

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(tdiffusion, "precompute_sampling_tables", spy)
    batch = tiled_batch(np.random.default_rng(3), b=4, p=30)
    want, on, off = run_cases(batch, 1, n_convs=1)
    (tables,) = seen
    assert tables.pp_s is None and tables.pp_cnt is None
    assert tables.enc.shape == tables.pf_table.shape == (6, 4, 64, 32)
    assert_close(on, want, TOL, "port tables vs JAX tables")
    assert_close(on, off, TOL, "port tables on vs off")


def test_budget_gate_runs_the_per_step_chain(monkeypatch):
    """Above `precompute_table_budget` no table is built, in JAX and here:
    the port's chain is then its per-step chain, bit for bit."""
    builds = count_builds(monkeypatch)
    batch = tiled_batch(np.random.default_rng(4), b=3, p=24)
    want, on, off = run_cases(batch, 1, precompute_table_budget=1)
    assert builds == []
    for key in ("pharm_x", "pharm_h"):
        assert torch.equal(on[key], off[key])
    assert_close(on, want, TOL, "port vs JAX, tables gated off")


def test_full_scale_dataflow_with_tables_matches_jax(monkeypatch):
    """n_convs=4, the fused pp branch, 2 pockets x 3 copies, the
    pocket-copy correction on: tables and correction together, as the
    full-scale model runs them (JAX diffusion.py:499-501)."""
    from pharmaforge_tpu_torch.models import conv as tconv
    builds = count_builds(monkeypatch)
    corrections = []
    real = tconv.GVPMultiEdgeConv._fused_pp_corrected

    def spy(self, *args):
        corrections.append(args[4])
        return real(self, *args)

    monkeypatch.setattr(tconv.GVPMultiEdgeConv, "_fused_pp_corrected", spy)
    rng = np.random.default_rng(5)
    copies = 3
    batch = concat_batches([tiled_batch(rng, b=copies, p=24),
                            tiled_batch(rng, b=copies, p=24)])
    batch = dataclasses.replace(batch, prot_x=batch.prot_x * 0.3)
    kw = dict(n_timesteps=3, n_convs=4, vector_size=4, n_hidden_scalars=16,
              fused_pp=True)
    want, on, off = run_cases(batch, copies, k_out=True,
                              jax_kw=dict(fused_pp="interpret"), **kw)
    assert builds == [3]
    assert corrections == [copies] * 6          # both port chains
    tol = dict(rtol=0, atol=2e-3)
    assert_close(on, want, tol, "port tables vs JAX tables")
    assert_close(on, off, tol, "port tables on vs off")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_chunked_build_equals_one_build(compute_dtype):
    cfg = DiffusionConfig(**tiny_kw(n_timesteps=7, n_convs=4,
                                    compute_dtype=compute_dtype))
    model = PharmacophoreDiffusion(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    px = torch.tensor(rng.normal(scale=3.0, size=(3, 40, 3)),
                      dtype=torch.float32)
    pm = torch.tensor(rng.random((3, 40)) > 0.1)
    ph = torch.tensor(np.eye(11, dtype=np.float32)[
        rng.integers(0, 11, (3, 40))])
    _, ed = build_pp_edge(px, pm, 3.5, 8)
    tv = torch.rand(7, generator=torch.Generator().manual_seed(1))
    whole = precompute_sampling_tables(model.dynamics, ph, pm, ed, tv)
    assert whole.pf_table.dtype == model.dynamics.noise_predictor \
        .conv_layers[0].dtype
    for chunk in (1, 2, 3, 6):
        got = precompute_sampling_tables(model.dynamics, ph, pm, ed, tv,
                                         chunk)
        for a, b in zip(whole, got):
            assert torch.equal(a, b), chunk
    # the plan: the JAX budget count, and chunks that fit the budget
    table, chunk = step_table_plan(cfg, 3, 40, 8)
    s, v = 32, 8
    elt = 2 if compute_dtype == "bfloat16" else 4
    assert table == 7 * 3 * 40 * (4 * (2 * s + 3 * v + 1) + elt * s)
    assert chunk == 7
    small = dataclasses.replace(cfg, precompute_table_budget=3 * 40 * 8
                                * 4 * (8 * s + 12 * (v + 1)) * 2)
    assert step_table_plan(small, 3, 40, 8)[1] == 2


def test_step_tables_need_eval_mode_and_the_group_axis():
    cfg = DiffusionConfig(**tiny_kw())
    model = PharmacophoreDiffusion(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    batch = tiled_batch(np.random.default_rng(7), b=4, p=24)
    t = {k: torch.as_tensor(getattr(batch, k)) for k in
         ("pharm_h", "pharm_x", "pharm_mask", "prot_h", "prot_x",
          "prot_mask")}
    _, ed = build_pp_edge(t["prot_x"], t["prot_mask"], 3.5, 8)
    tables = precompute_sampling_tables(
        model.dynamics, t["prot_h"][::2], t["prot_mask"][::2],
        type(ed)(*(a[::2] for a in ed)), torch.tensor([0.5]))
    args = (t["pharm_h"], t["pharm_x"], t["pharm_mask"], t["prot_h"],
            t["prot_x"], t["prot_mask"], torch.full((4,), 0.5))
    with pytest.raises(ValueError, match="group axis 2 x pocket_group_size "
                                         "1 != batch 4"):
        model.dynamics(*args, pp_edge=ed, step_tables=tables.step(0))
    model.dynamics.train()
    with pytest.raises(ValueError, match="eval mode"):
        model.dynamics(*args, pp_edge=ed, step_tables=tables.step(0),
                       pocket_group_size=2,
                       generator=torch.Generator().manual_seed(0))
