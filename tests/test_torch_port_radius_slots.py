"""The radius pf/fp edge on M slots a centre (`models/edges.py`:
`radius_slot_bound`, `radius_slot_count`, `radius_slots`), which a
sampling chain on the radius graph (`pf_k` 0) runs in place of the dense
[B, F, P] layout, on the CPU in fp32 and, marked `cuda`, on the card:

* the slots scattered back to [B, F, P] are `radius_mask`, pair for pair,
  with centres at random, all at the point where the most atoms lie
  within r_pf, on atoms, on the widened bounding box and all in one spot;
* the bound is at least a brute-force count at 10^5 points and at most
  the valid atoms, also for a pocket packed into one ball;
* one denoiser call (eval, pocket groups of 3, P=96 prot slots, twice
  M) in slots against the dense layout and the plain radius reference
  (`portbench/reference/radius.py`);
* the chain keeps M in its graph signature, and an eager step whose rows
  hold more pairs than a forced-small M raises;
* on the card: 20 K4 launches a radius denoiser call, 7 of them at B*F*M
  rows; a captured step counts no pairs and replays as the eager step; a
  chain of the same M reuses the graphs, one of another M captures anew.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu_torch.data.batch import concat_batches, tile_pocket
from pharmaforge_tpu_torch.models.edges import (
    GroupedEdgeData,
    build_pp_edge,
    radius_slot_bound,
    radius_slot_count,
    radius_slots,
)
from pharmaforge_tpu_torch.ops.neighbors import radius_mask
from pharmaforge_tpu_torch.utils import graphs, trace
from portbench.workloads import common, sample_radius
# by its own name: pytest puts this directory on the path (a `tests`
# package installed elsewhere may shadow `tests.`)
from test_torch_port_radius import (
    CALL_TOL,
    CPU,
    SEED,
    call_gap,
    inputs,
    reference_call,
    small_config,
)

R_PF = 8.0
PLACEMENTS = ("random", "densest", "atoms", "box", "one_spot")


def pocket(seed: int, atoms: int, slots: int):
    """One pocket of the benchmark's generator: prot_x [1, slots, 3],
    prot_mask [1, slots]."""
    pk = common.make_pockets(small_config(), np.random.default_rng(seed),
                             [atoms])
    x, _, m = common.pocket_tensors(pk, slots, CPU)
    return x, m


def brute_counts(points, prot_x, prot_mask, r: float = R_PF):
    """Valid atoms strictly within r of each point: points [N, 3], one
    pocket's prot_x [P, 3] / prot_mask [P]."""
    d2 = ((points[:, None] - prot_x[None]) ** 2).sum(-1)
    return ((d2 < r * r) & prot_mask[None]).sum(-1)


def densest_point(prot_x, prot_mask, r: float = R_PF):
    """The point of a 0.25 A grid over the atoms' box with the most valid
    atoms within r."""
    x = prot_x[prot_mask]
    axes = [torch.arange(float(lo), float(hi) + 0.25, 0.25)
            for lo, hi in zip(x.min(0).values, x.max(0).values)]
    grid = torch.cartesian_prod(*axes)
    counts = torch.cat([brute_counts(g, prot_x, prot_mask, r)
                        for g in grid.split(4096)])
    return grid[int(counts.argmax())]


def place(kind: str, prot_x, prot_mask, b: int, f: int, seed: int):
    """Centre coordinates [b, f, 3] for the rows of one pocket each
    (prot_x [b, P, 3]); every placement puts many centres near atoms."""
    gen = torch.Generator().manual_seed(seed)
    out = torch.empty(b, f, 3)
    for i in range(b):
        x = prot_x[i][prot_mask[i]]
        lo, hi = x.min(0).values - R_PF, x.max(0).values + R_PF
        if kind == "random":
            out[i] = torch.randn(f, 3, generator=gen) * 3.0
        elif kind == "densest":
            out[i] = densest_point(prot_x[i], prot_mask[i])
        elif kind == "atoms":
            pick = torch.randint(len(x), (f,), generator=gen)
            out[i] = x[pick]
        elif kind == "box":
            # corners and face points of the widened box, and points r
            # from an atom along an axis (that atom just outside)
            corner = torch.randint(2, (f, 3), generator=gen).float()
            out[i] = lo + corner * (hi - lo)
            out[i, ::2, 0] = x[0, 0] + R_PF
            out[i, ::2, 1:] = x[0, 1:]
        else:
            out[i] = torch.randn(3, generator=gen)
    return out


def scattered(nbrs, p: int):
    """The slot layout's pairs as a dense [B, F, P] mask."""
    dense = torch.zeros(nbrs.idx.shape[:-1] + (p + 1,), dtype=torch.bool)
    at = torch.where(nbrs.mask, nbrs.idx, p)
    return dense.scatter_(-1, at, True)[..., :p]


@pytest.mark.parametrize("kind", PLACEMENTS)
@pytest.mark.parametrize("seed", [1, 2])
def test_the_slots_are_the_radius_mask(kind, seed):
    args = inputs(small_config(), 2, seed, slots=96)
    prot_x, prot_mask = args[4], args[5]
    b, f = args[2].shape
    m = radius_slot_count(prot_x[::2], prot_mask[::2], R_PF)
    assert m < prot_x.shape[1] // 2
    pharm_x = place(kind, prot_x, prot_mask, b, f, seed)
    mask = radius_mask(pharm_x, args[2], prot_x, prot_mask, R_PF)
    nbrs = radius_slots(mask, m)
    assert nbrs.idx.shape == nbrs.mask.shape == (b, f, m)
    assert torch.equal(scattered(nbrs, prot_x.shape[1]), mask)
    # ascending atoms in the leading slots
    assert torch.equal(nbrs.mask.sum(-1), mask.sum(-1))
    steps = nbrs.idx.diff(dim=-1)
    assert bool((steps[nbrs.mask[..., 1:]] > 0).all())
    if kind == "densest":
        # the rows reach what the bound allows for
        assert int(mask.sum(-1).max()) > m - 32


@pytest.mark.parametrize("seed,atoms,slots", [(1, 40, 64), (2, 40, 64),
                                               (3, 40, 64), (4, 230, 256)])
def test_the_bound_holds_at_random_points(seed, atoms, slots):
    prot_x, prot_mask = pocket(seed, atoms, slots)
    bound = int(radius_slot_bound(prot_x, prot_mask, R_PF)[0])
    x, m = prot_x[0], prot_mask[0]
    valid = x[m]
    lo, hi = valid.min(0).values - R_PF, valid.max(0).values + R_PF
    gen = torch.Generator().manual_seed(seed)
    points = torch.cat([lo + (hi - lo) * torch.rand(100_000, 3,
                                                    generator=gen),
                        valid, densest_point(x, m)[None]])
    most = int(brute_counts(points, x, m).max())
    assert most <= bound <= int(m.sum()) <= x.shape[0]
    # not far above what the points show: the benchmark's pockets take
    # half their slots
    assert bound <= most + 32
    if atoms == 230:
        assert radius_slot_count(prot_x, prot_mask, R_PF) == 128


def test_a_pocket_in_one_ball_takes_every_slot():
    gen = torch.Generator().manual_seed(0)
    prot_x = torch.zeros(1, 64, 3)
    prot_x[0, :50] = torch.randn(50, 3, generator=gen) * 0.5
    prot_mask = torch.arange(64)[None] < 50
    assert int(radius_slot_bound(prot_x, prot_mask, R_PF)[0]) == 50
    assert radius_slot_count(prot_x, prot_mask, R_PF) == 64
    empty = torch.zeros(1, 64, dtype=torch.bool)
    assert int(radius_slot_bound(prot_x, empty, R_PF)[0]) == 0
    assert radius_slot_count(prot_x, empty, R_PF) == 32


@pytest.fixture(scope="module")
def weights():
    return common.make_weights(small_config(), SEED, CPU)


def slot_call(config, weights, args, copies: int, slots):
    """The port's denoiser in eval on `args` with radius slots `slots`
    (None: dense)."""
    model = common.program_model(config, weights, CPU, "sampling")
    dyn = model.dynamics.eval()
    prot_x, prot_mask = args[4], args[5]
    _, pp = build_pp_edge(prot_x[::copies], prot_mask[::copies],
                          float(config["model"]["graph_cutoffs"]["pp"]),
                          config["model"]["pp_k_max"])
    with torch.no_grad():
        return dyn(*args, pp_edge=GroupedEdgeData(*pp, copies=copies),
                   pocket_group_size=copies, pf_slots=slots)


def test_a_denoiser_call_in_slots_matches_dense_and_the_reference(weights):
    config = small_config()
    args = inputs(config, 3, slots=96)
    m = radius_slot_count(args[4][::3], args[5][::3], R_PF)
    assert 2 * m <= args[4].shape[1]
    got = slot_call(config, weights, args, 3, m)
    dense = slot_call(config, weights, args, 3, None)
    want = reference_call(config, weights, args, train=False)
    assert call_gap(got, dense) <= CALL_TOL
    assert call_gap(got, want) <= CALL_TOL
    assert float(want[0].abs().max()) > 0.1


def stacked_batch(config, seed: int, atoms, copies: int, slots: int):
    """`sample_stacked`'s batch: one pocket of each size in `atoms`,
    `copies` rows each of 3-8 centres."""
    pockets = common.make_pockets(config, np.random.default_rng(seed),
                                  atoms)
    sizes = np.random.default_rng(seed + 1).integers(3, 9, (len(atoms),
                                                             copies))
    return concat_batches([
        tile_pocket(p["prot_x"], p["prot_h"], list(s), max_prot=slots)
        for p, s in zip(pockets, sizes)])


def chain_of(model, batch, copies: int, seed: int = 0):
    return model.chain_setup(batch, torch.Generator(
        device=model.device).manual_seed(seed), pocket_group_size=copies)


def test_the_chain_signature_holds_the_slot_count(weights):
    config = small_config()
    model = common.program_model(config, weights, CPU, "sampling")
    one = chain_of(model, stacked_batch(config, 1, [40, 36], 2, 96), 2)
    two = chain_of(model, stacked_batch(config, 2, [40, 38], 2, 96), 2)
    big = chain_of(model, stacked_batch(config, 3, [90, 90], 2, 96), 2)
    m = one.inputs["pf_slots"]
    assert m == two.inputs["pf_slots"] < big.inputs["pf_slots"] <= 96
    spec = graphs.spec(one.inputs)
    assert ("pf_slots", m) in spec
    assert spec == graphs.spec(two.inputs)
    assert spec != graphs.spec(big.inputs)
    knn = common.program_model(dict(config, model=dict(config["model"],
                                                       pf_k=5)),
                               weights, CPU, "sampling")
    assert chain_of(knn, stacked_batch(config, 1, [40, 36], 2, 96),
                    2).inputs["pf_slots"] is None


def test_an_eager_step_past_its_slots_raises(weights):
    config = small_config()
    model = common.program_model(config, weights, CPU, "sampling")
    chain = chain_of(model, stacked_batch(config, 1, [40, 36], 2, 96), 2)
    model.chain_step(chain)
    chain.inputs["pf_slots"] = 1
    with pytest.raises(ValueError, match="radius slots"):
        model.chain_step(chain)
    mask = torch.ones(1, 2, 40, dtype=torch.bool)
    with pytest.raises(ValueError, match="radius slots"):
        radius_slots(mask, 32)


# ------------------------------------------------------------- on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 and CUDA graph capture")
    return torch.device("cuda")


def card_model(dev, dtype: str, n_timesteps: int = 4):
    """pforge-radius at its widths (K4 takes its chains), T small."""
    from portbench import manifest
    config = manifest.read_json(manifest.ROOT / "configs"
                                / "pforge-radius.json")
    config["model"]["n_timesteps"] = n_timesteps
    config["sampling"]["compute_dtype"] = dtype
    w = common.make_weights(config, SEED, dev)
    return config, common.program_model(config, w, dev, "sampling")


@pytest.mark.cuda
def test_a_radius_call_launches_k4_on_its_slots(dev):
    config, model = card_model(dev, "bfloat16")
    chain = chain_of(model, stacked_batch(config, 1, [230, 230], 3, 256), 3)
    m = chain.inputs["pf_slots"]
    assert m < 256
    with sample_radius.k4_launches() as seen:
        model.chain_step(chain)
    torch.cuda.synchronize()
    rows = [r for _, r, _ in seen]
    assert len(rows) == 20
    assert rows.count(6 * 8 * m) == 7


@pytest.mark.cuda
def test_a_captured_radius_step_counts_no_pairs(dev):
    config, model = card_model(dev, "float32")
    chain = chain_of(model, stacked_batch(config, 2, [230, 230], 3, 256), 3)
    copy = lambda: graphs.stage(chain)  # noqa: E731
    eager, warm, graphed = copy(), copy(), copy()
    model.chain_step(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.chain_step(warm)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    trace.reset()
    graph = torch.cuda.CUDAGraph()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.cuda.graph(graph):
            model.chain_step(graphed)
    got = trace.counters()
    assert got["edges.pf_radius_rows"] == 6 * 8 * chain.inputs["pf_slots"]
    assert got["edges.pf_radius_pairs"] == 0
    graph.replay()
    torch.cuda.synchronize()
    for key in ("x", "h", "prot_x"):
        torch.testing.assert_close(graphed.state[key], eager.state[key],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_graphs_are_kept_for_the_same_slot_count(dev):
    config, model = card_model(dev, "bfloat16")

    def sample(atoms, seed):
        batch = stacked_batch(config, seed, atoms, 3, 256)
        before = trace.counters()["chain.captures"]
        model.sample_given_receptor(
            batch, torch.Generator(device=dev).manual_seed(seed),
            pocket_group_size=3)
        torch.cuda.synchronize()
        (key, runner), = model._chain_graphs.graphs.items()
        return key, runner.chain.inputs["pf_slots"], \
            trace.counters()["chain.captures"] - before

    first, m_first, captured = sample([230, 230], 1)
    again, _, recaptured = sample([230, 230], 2)
    other, m_other, moved = sample([120, 120], 3)
    assert captured == 1 and recaptured == 0 and moved == 1
    assert first == again != other
    slots = m_first, m_other
    assert slots[0] != slots[1]
    assert all(s % 32 == 0 and s <= 256 for s in slots)
