"""PyTorch/CUDA port, the reverse chain split into set-up, step and result
(`PharmacophoreDiffusion.chain_setup` / `chain_step` / `chain_result`) and
its runner (`models/diffusion.py::ChainGraphs`), on the CPU.

* the split chain against the JAX package's `sample_given_receptor` at
  T=12 for U = `sample_scan_unroll` in {1, 3, 5}, eps and endpoint
  parameterisations, with and without the trajectory, within the chain
  tolerance of `test_torch_port_chain.py` (2e-3);
* the port's chain at every U bit-equal to U=1 on the CPU, and the step
  loop driven by hand bit-equal to `sample_given_receptor`;
* the step-tables chain against the per-step chain (rtol 1e-4 / atol
  1e-5, `test_torch_port_tables.py`'s);
* a planted fault, the step index never advancing, fails the comparison
  by more than 10 x the chain tolerance;
* the runner's replay logic (warm-up, capture of U steps and of the
  T mod U left, replays, the kept graphs reused with a later chain's
  inputs) with a stand-in for CUDA graphs that records the steps of a
  capture and replays them: bit-equal to the eager chain. The real graphs
  run in the card tests (`test_torch_port_cuda.py`).
"""

import contextlib
import dataclasses

import numpy as np
import jax
import pytest
import torch

import chip_smoke
from pharmaforge_tpu.data.batch import PharmComplexBatch as JaxBatch
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu_torch.data.batch import PharmComplexBatch, tile_pocket
from pharmaforge_tpu_torch.interop import params_from_jax
from pharmaforge_tpu_torch.models import diffusion
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)

TOL = 2e-3          # test_torch_port_chain.py's chain tolerance
TABLES_TOL = dict(rtol=1e-4, atol=1e-5)
T = 12


def model_kw(**kw):
    base = dict(n_timesteps=T, vector_size=8, n_convs=2, n_hidden_scalars=32,
                n_message_gvps=2, n_update_gvps=1, n_noise_gvps=2,
                message_norm="mean", pf_k=4, ff_k=0, pp_k_max=16,
                precision=1e-5)
    base.update(kw)
    return base


def chain_inputs(seed=0, n_pockets=2, copies=2, p=32):
    """`n_pockets` pockets x `copies` rows, pocket-major, noise and COMs
    made with numpy."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_pockets):
        px = rng.normal(scale=4.0, size=(p - 4, 3)).astype(np.float32)
        ph = np.eye(11, dtype=np.float32)[rng.integers(0, 11, p - 4)]
        rows.append(tile_pocket(px, ph, rng.integers(3, 9, copies),
                                max_prot=p))
    batch = PharmComplexBatch(**{
        f.name: np.concatenate([getattr(r, f.name) for r in rows])
        for f in dataclasses.fields(PharmComplexBatch)})
    b = batch.batch_size
    noise = {"x_T": rng.normal(size=(b, 8, 3)),
             "h_T": rng.normal(size=(b, 8, 6)),
             "pos": rng.normal(size=(T, b, 8, 3)),
             "feat": rng.normal(size=(T, b, 8, 6))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    com = rng.normal(scale=2.0, size=(b, 3)).astype(np.float32)
    return batch, noise, com


@pytest.fixture(scope="module")
def jax_chains():
    """The JAX chain (with its trajectory) and its weights, per
    parameterisation, on one batch and noise."""
    batch, noise, com = chain_inputs()
    out = {}
    for endpoint in (False, True):
        kw = model_kw(endpoint_param_feat=endpoint,
                      endpoint_param_coord=endpoint)
        jmodel = JaxDiffusion(JaxConfig(**kw))
        jbatch = JaxBatch(**dataclasses.asdict(batch))
        params = jax.device_get(jmodel.init_params(jax.random.key(5),
                                                   jbatch))
        want = jmodel.sample_given_receptor(
            params, jbatch, jax.random.key(0), init_pharm_com=com,
            visualize_trajectory=True, noise=noise, pocket_group_size=2)
        out[endpoint] = (kw, params, {k: np.asarray(v)
                                      for k, v in want.items()})
    return batch, noise, com, out


@pytest.mark.parametrize("visualize", [False, True])
@pytest.mark.parametrize("endpoint", [False, True])
@pytest.mark.parametrize("unroll", [1, 3, 5])
def test_split_chain_matches_jax(jax_chains, unroll, endpoint, visualize):
    batch, noise, com, chains = jax_chains
    kw, params, want = chains[endpoint]
    cfg = DiffusionConfig(**kw, sample_scan_unroll=unroll)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    got = model.sample_given_receptor(
        batch, init_pharm_com=com, visualize_trajectory=visualize,
        noise=noise, pocket_group_size=2)
    keys = ["pharm_x", "pharm_h"] + (["traj_x", "traj_h"] if visualize
                                     else [])
    assert sorted(got) == sorted(keys + ["pharm_mask"])
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=TOL,
                                   rtol=0, err_msg=key)


def small_model(**kw):
    return PharmacophoreDiffusion(
        DiffusionConfig(**model_kw(**kw)), device="cpu",
        generator=torch.Generator().manual_seed(0))


def with_unroll(model, unroll: int):
    m = PharmacophoreDiffusion(dataclasses.replace(
        model.config, sample_scan_unroll=unroll), device="cpu")
    m.load_state_dict(model.state_dict())
    return m


@pytest.mark.parametrize("unroll", [2, 3, 5, 7, 12, 20])
def test_every_unroll_bit_equal_to_one_on_cpu(unroll):
    batch, noise, com = chain_inputs(seed=1)
    base = small_model(n_convs=4, fused_pp=True, endpoint_param_feat=True,
                       endpoint_param_coord=True)
    kw = dict(init_pharm_com=com, noise=noise, pocket_group_size=2,
              visualize_trajectory=True, pp_k_out=16)
    want = base.sample_given_receptor(batch, **kw)
    got = with_unroll(base, unroll).sample_given_receptor(batch, **kw)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_step_loop_by_hand_equals_sample_given_receptor():
    batch, noise, com = chain_inputs(seed=2)
    model = small_model()
    kw = dict(init_pharm_com=com, noise=noise, pocket_group_size=2,
              visualize_trajectory=True)
    want = model.sample_given_receptor(batch, **kw)
    chain = model.chain_setup(batch, **kw)
    assert chain.n_steps == T and int(chain.state["i"]) == 0
    for _ in range(T):
        model.chain_step(chain)
    assert int(chain.state["i"]) == T
    got = model.chain_result(chain)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # the result owns its tensors: another step leaves it alone
    before = got["traj_x"].clone()
    chain.state["i"].zero_()
    model.chain_step(chain)
    assert torch.equal(got["traj_x"], before)


@pytest.mark.parametrize("fused", [False, True])
def test_step_tables_chain_matches_per_step_chain(fused):
    batch, noise, com = chain_inputs(seed=3)
    kw = dict(n_convs=4, fused_pp=True) if fused else {}
    base = small_model(**kw)
    tables = PharmacophoreDiffusion(dataclasses.replace(
        base.config, precompute_step_tables=True, sample_scan_unroll=5),
        device="cpu")
    tables.load_state_dict(base.state_dict())
    run = dict(init_pharm_com=com, noise=noise, pocket_group_size=2,
               visualize_trajectory=True, pp_k_out=16 if fused else 0)
    want = base.sample_given_receptor(batch, **run)
    got = tables.sample_given_receptor(batch, **run)
    for key in ("pharm_x", "pharm_h", "traj_x", "traj_h"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   **TABLES_TOL, err_msg=key)


def test_frozen_step_index_fails_the_comparison():
    batch, noise, com = chain_inputs(seed=4)
    model = small_model()
    kw = dict(init_pharm_com=com, noise=noise, pocket_group_size=2)
    want = model.sample_given_receptor(batch, **kw)["pharm_x"]
    with chip_smoke.step_index_frozen():
        got = model.sample_given_receptor(batch, **kw)["pharm_x"]
    # a chain that rereads step 0 may overflow: a non-finite value misses
    # by infinitely many tolerances
    units = float(torch.nan_to_num((got - want).abs(), nan=np.inf).max()) \
        / TOL
    assert units > 10, f"the frozen step index moved the chain only " \
                       f"{units:.3f} x the tolerance"


class RecordingGraph:
    """Stands in for `torch.cuda.CUDAGraph`: a capture records the steps
    made inside it (their Python code runs on a copy, as a capture runs
    the host code without the kernels' effects); a replay reruns them."""

    capturing = []

    def __init__(self):
        self.steps = []

    def pool(self):
        return "pool"

    def replay(self):
        for step, chain in self.steps:
            step(chain)


def recording_capture(monkeypatch):
    """torch.cuda replaced by CPU stand-ins for the runner's calls."""
    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None):
        RecordingGraph.capturing.append(g)
        try:
            yield
        finally:
            RecordingGraph.capturing.pop()

    cuda = torch.cuda
    for name, value in (
            ("device", lambda d=None: contextlib.nullcontext()),
            ("Stream", lambda d=None: Stream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("current_stream", lambda d=None: Stream()),
            ("synchronize", lambda d=None: None),
            ("empty_cache", lambda: None),
            ("memory_reserved", lambda d=None: 0),
            ("CUDAGraph", RecordingGraph), ("graph", graph)):
        monkeypatch.setattr(cuda, name, value)
    monkeypatch.setattr(diffusion.ReverseChain, "device",
                        property(lambda self: torch.device("cuda")))
    real = diffusion.ChainGraphs.__init__

    def init(self, step, chain, unroll, key):
        def recorded(ch):
            if RecordingGraph.capturing:
                RecordingGraph.capturing[-1].steps.append((step, ch))
                step(dataclasses.replace(
                    ch, inputs=diffusion._clone(ch.inputs),
                    state=diffusion._clone(ch.state)))
            else:
                step(ch)
        real(self, recorded, chain, unroll, key)

    monkeypatch.setattr(diffusion.ChainGraphs, "__init__", init)


@pytest.mark.parametrize("unroll", [1, 5, 12, 20])
def test_runner_replays_and_reuses_its_graphs(monkeypatch, unroll):
    batch, noise, com = chain_inputs(seed=5)
    base = small_model()
    kw = dict(init_pharm_com=com, pocket_group_size=2,
              visualize_trajectory=True)
    second = {k: v[::-1].copy() for k, v in noise.items()}
    want = [base.sample_given_receptor(batch, noise=n, **kw)
            for n in (noise, second)]
    recording_capture(monkeypatch)
    model = with_unroll(base, unroll)
    graphs = []
    for n, w in zip((noise, second), want):
        diffusion.graph_replays = 0
        chain = model.chain_setup(batch, noise=n, **kw)
        g = model._graphs_for(chain, unroll)
        g.run()
        got = model.chain_result(g.chain)
        graphs.append(g)
        u = min(unroll, T)
        assert diffusion.graph_replays == T // u + int(T % u > 0)
        assert [len(x.steps) for x, _, _ in g.graphs] == \
            [u] + ([T % u] if T % u else [])
        for key in w:
            assert torch.equal(got[key], w[key]), key
    # the second chain (same shapes) ran in the first one's graphs
    assert graphs[0] is graphs[1]
    # another signature captures anew
    chain = model.chain_setup(batch, noise=noise, init_pharm_com=com,
                              pocket_group_size=1)
    assert model._graphs_for(chain, unroll) is not graphs[0]
