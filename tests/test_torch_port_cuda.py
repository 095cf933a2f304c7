"""PyTorch/CUDA port on the card: the CUDA kernels (K1's two entries, K2,
K3, K4) against their plain versions, the golden chain through K1, the
reverse chain as CUDA graph replays against its eager step loop, one
full-width training step on the card against the CPU, captured train
calls (`training/train_state.py::TrainGraphs`) against eager steps, with
their planted faults, a short fit that replays every step, and captured
validation (`EvalGraphs`) against eager, after a train call too and in
an NCCL group of one rank.

Every test here is marked `cuda` and skips without a card. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
import chip_smoke
from pharmaforge_tpu_torch.ops import knn_select as ks
from pharmaforge_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def make_inputs(rng, b=4, f=8, p=64, ties=False):
    pharm_x = rng.normal(scale=3.0, size=(b, f, 3)).astype(np.float32)
    prot_x = rng.normal(scale=6.0, size=(b, p, 3)).astype(np.float32)
    pharm_mask = np.ones((b, f), bool)
    prot_mask = np.ones((b, p), bool)
    pharm_mask[0, 5:] = False
    prot_mask[1, 50:] = False
    prot_mask[2 % b, 3:] = False      # fewer valid atoms than k
    if ties:
        prot_x[0, 7] = prot_x[0, 3]   # exact duplicate coordinates
        pharm_mask[1, :] = False      # a masked-out pharm row
    return pharm_x, pharm_mask, prot_x, prot_mask


# the sampling shape, ties and masked rows, k above P, the register
# variants' largest P (1,024), the shared-memory variant (1,500) and k
# above 32
KNN_CASES = [(240, 230, 5, False), (3, 64, 5, False), (4, 64, 1, True),
             (4, 64, 5, True), (4, 64, 8, True), (2, 6, 9, False),
             (4, 1024, 5, True), (4, 1500, 5, True), (2, 230, 40, True)]


@pytest.mark.parametrize("b,p,k,ties", KNN_CASES)
def test_kernel_bit_equal_to_plain(dev, b, p, k, ties):
    rng = np.random.default_rng(b * 100 + k)
    args = [torch.from_numpy(a).to(dev)
            for a in make_inputs(rng, b=b, p=p, ties=ties)]
    before = trace.counters()["knn_select.launches"]
    got = ks.knn_select(*args, k)
    want = ks.knn_select_reference(*args, k)
    torch.cuda.synchronize()
    assert trace.counters()["knn_select.launches"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,p,k,ties", KNN_CASES)
def test_pf_edges_kernel_matches_plain(dev, b, p, k, ties):
    """knn_pf_edges in one launch against its plain version: idx and mask
    bit-equal, x_dir, x_dir_fp and d_rbf within chip_smoke.KNN_GEOM_ATOL
    (2e-6, the reason beside it). The largest error is printed."""
    rng = np.random.default_rng(b * 100 + k)
    args = [torch.from_numpy(a).to(dev)
            for a in make_inputs(rng, b=b, p=p, ties=ties)]
    before = trace.counters()["knn_select.launches"]
    got = ks.knn_pf_edges(*args, k)
    want = ks.knn_pf_edges_reference(*args, k)
    torch.cuda.synchronize()
    assert trace.counters()["knn_select.launches"] == before + 1
    worst = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype in (torch.int64, torch.bool):
            assert torch.equal(g, w)
        else:
            worst = max(worst, float((g - w).abs().max()))
    print(f"B={b} P={p} k={k}: geometry max abs err {worst}")
    assert worst <= chip_smoke.KNN_GEOM_ATOL


def test_kernel_refuses_bad_inputs(dev):
    args = [torch.from_numpy(a).to(dev)
            for a in make_inputs(np.random.default_rng(0))]
    for entry in (ks.knn_select, ks.knn_pf_edges):
        with pytest.raises(TypeError):
            entry(args[0], args[1].float(), args[2], args[3], 5)
        with pytest.raises(ValueError):
            entry(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                  *args[1:], 5)
        # a pocket beyond the shared-memory variant's rows
        wide = torch.zeros(1, 60000, 3, device=dev)
        with pytest.raises(ValueError, match="shared memory"):
            entry(args[0][:1], args[1][:1], wide,
                  torch.ones(1, 60000, dtype=torch.bool, device=dev), 5)
    with pytest.raises(RuntimeError, match="no gradient"):
        ks.knn_pf_edges(args[0].clone().requires_grad_(True), *args[1:], 5)


# the shared-memory variant's largest pocket: four warps' rows of 4-byte
# keys fill a Hopper block's 232,448 bytes
KNN_MAX_P = 14528


def test_kernel_takes_the_largest_pocket(dev):
    """At the largest P both entries launch (the shared-memory attribute
    raised above 48 KB) and match their plain versions; one atom more
    raises."""
    rng = np.random.default_rng(7)
    args = [torch.from_numpy(a).to(dev)
            for a in make_inputs(rng, b=3, p=KNN_MAX_P, ties=True)]
    for g, w in zip(ks.knn_select(*args, 5), ks.knn_select_reference(*args, 5)):
        assert torch.equal(g, w)
    got = ks.knn_pf_edges(*args, 5)
    want = ks.knn_pf_edges_reference(*args, 5)
    for g, w in zip(got, want):
        if g.dtype in (torch.int64, torch.bool):
            assert torch.equal(g, w)
        else:
            assert float((g - w).abs().max()) <= chip_smoke.KNN_GEOM_ATOL
    wide = torch.zeros(1, KNN_MAX_P + 1, 3, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ks.knn_select(args[0][:1], args[1][:1], wide,
                      torch.ones(1, KNN_MAX_P + 1, dtype=torch.bool,
                                 device=dev), 5)


PP_CASES = chip_smoke.PP_CASES


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(PP_CASES))
def test_pp_kernel_matches_plain(dev, case, dtype):
    """K2 against its plain version at chip_smoke.py's pp cases, within
    chip_smoke.PP_TOL (fp32 rtol 1e-5 / atol 1e-6; bf16 rtol 1e-2 /
    atol 1e-3, the reason beside it)."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    args, kw = chip_smoke.pp_case(dev, dtype=dtype, **PP_CASES[case])
    before = trace.counters()["pp_message.launches"]
    with torch.no_grad():
        got = ppm.fused_message_agg(*args, **kw)
        want = ppm.message_agg_reference(*args, **kw)
    torch.cuda.synchronize()
    assert trace.counters()["pp_message.launches"] == before + 1
    chip_smoke.compare(case, got, want, chip_smoke.PP_TOL[dtype])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", chip_smoke.PP_REPEAT)
def test_pp_kernel_is_deterministic(dev, case, dtype):
    """Two K2 calls on the same inputs return bit-equal sums: each
    destination's rows are added in k order, with no atomics."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    args, kw = chip_smoke.pp_case(dev, dtype=dtype, **PP_CASES[case])
    with torch.no_grad():
        first = ppm.fused_message_agg(*args, **kw)
        second = ppm.fused_message_agg(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("n_gvps", [3, 4, 5, 6])
def test_pp_shared_memory_fits_deeper_chains(dev, n_gvps):
    """K2's shared memory per block, for each dtype, stays within a Hopper
    block's at the sampling widths for chains of 3-6 GVPs: bf16 keeps the
    chain's weights resident while they fit and stages them per GVP, as
    fp32 does, beyond."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    lib = ppm._launcher()
    bf16, fp32 = (lib.pp_message_smem_bytes(t, 128, 16, 17, 16, n_gvps)
                  for t in (1, 0))
    assert bf16 <= ppm._MAX_SMEM and fp32 <= ppm._MAX_SMEM


def test_pp_kernel_refuses_bad_inputs(dev):
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    args, kw = chip_smoke.pp_case(dev, dtype="float32", n_groups=2, copies=3)
    with torch.no_grad():
        with pytest.raises(ValueError, match="copies"):
            ppm.fused_message_agg(*args, **dict(kw, copies=2))
        with pytest.raises(ValueError, match="K=65"):
            pre_s, planes, edge, chain = args
            wide = type(edge)(*(a.repeat_interleave(5, dim=2)[:, :, :65]
                                for a in (edge.mask, edge.idx, edge.x_dir,
                                          edge.d_rbf)), copies=3)
            ppm.fused_message_agg(pre_s, planes, wide, chain, **kw)


@pytest.mark.parametrize("case", list(chip_smoke.GVP_CHAIN_CASES))
def test_gvp_chain_kernel_matches_plain(dev, case):
    """K4 against the plain chain in the chain's dtype at the full-screen
    step's shapes (960 to 30,720 rows) and a few more, within
    chip_smoke.GVP_CHAIN_TOL (fp32 rtol 1e-5 / atol 1e-6; bf16 rtol 2^-6 /
    atol 2^-8, the reason beside it); two launches bit-equal, one counted
    each; a launch captured in a CUDA graph bit-equal to eager."""
    r = chip_smoke.gvp_chain_run(dev, case)
    print(r)
    assert r["launches"] == 2
    assert r["repeat_equal"] and r["graph_equal"]
    assert r["tol_units"] <= 1.0


def test_gvp_chain_shared_memory_plan_matches_the_kernels(dev):
    """The wrapper's shared-memory plan (`ops/gvp_chain.py::smem_bytes`),
    which picks the tile and refuses a chain, equals the kernel's own for
    every chain kind, dtype and tile height."""
    from pharmaforge_tpu_torch.ops import gvp_chain as gcm
    lib = gcm._launcher()
    for case in ("noise-960", "pf-message-4800", "prot-update-30720"):
        dims = gcm.layer_dims(chip_smoke.gvp_chain_case(dev, case)[0])
        flat = gcm._c_dims(dims)
        for bf16 in (True, False):
            for rows in gcm.TILE_ROWS:
                assert lib.gvp_chain_smem_bytes(int(bf16), rows, len(dims),
                                                flat) \
                    == gcm.smem_bytes(bf16, rows, dims), (case, bf16, rows)


def test_gvp_chain_needs_no_gradient(dev):
    """A chain whose inputs need a gradient runs the plain chain on the
    card (no K4 launch) and back-propagates; the wrapper itself refuses
    such a call."""
    from pharmaforge_tpu_torch.models.gvp import GVPChain, gvp_specs
    from pharmaforge_tpu_torch.ops.gvp_chain import fused_gvp_chain
    chain = GVPChain(gvp_specs(2, 16, 128)).to(dev)
    feats = torch.randn(64, 128, device=dev, requires_grad=True)
    vectors = torch.randn(64, 16, 3, device=dev)
    before = trace.counters()["gvp_chain.launches"]
    s, v = chain((feats, vectors))
    (s.sum() + v.sum()).backward()
    assert trace.counters()["gvp_chain.launches"] == before
    assert feats.grad is not None
    assert all(p.grad is not None for p in chain.parameters())
    with pytest.raises(RuntimeError, match="no backward"):
        fused_gvp_chain(list(chain), feats, vectors)
    with torch.no_grad():
        chain((feats, vectors))
    assert trace.counters()["gvp_chain.launches"] == before + 1


def test_fullscreen_chain_with_k4_matches_plain_chains(dev):
    """One full-screen chain (pforge-full, 4 pockets x 30, T=1000) with K4
    against the same weights and noise with the plain chains, within the
    benchmark's `x_gap_median` and `h_gap` limits; 21 K4 launches a step,
    21,000 replayed."""
    g = chip_smoke.fullscale_gvp_gaps(dev)
    print(g)
    for key, limit in chip_smoke.FULLSCREEN_LIMITS.items():
        assert g[key] <= limit, key
    assert g["replayed"] == chip_smoke.GVP_CHAINS_PER_STEP * g["steps"]


def test_train_calls_launch_no_gvp_chain_kernel(dev, monkeypatch):
    """Training needs gradients, so neither the eager steps nor the
    captured train calls of `chip_smoke.trainstep_cases` reach K4; the
    last call's replays count none."""
    from pharmaforge_tpu_torch.ops import gvp_chain as gcm
    calls = []
    real = gcm._launch
    monkeypatch.setattr(gcm, "_launch",
                        lambda *a: calls.append(1) or real(*a))
    model, batches = trainstep_case(dev, 3)
    chip_smoke.trainstep_cases(dev, model, batches, 3)
    counts = trace.counters()
    assert counts["train.replays"] > 0
    assert not calls
    assert counts["gvp_chain.launches"] == 0
    assert counts["train.replayed.gvp_chain"] == 0


def test_golden_knn_chain_on_card(dev):
    from pharmaforge_tpu_torch.data.batch import PharmComplexBatch
    from pharmaforge_tpu_torch.interop import load_reference_state_dict
    from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig

    data = np.load(ROOT / "tests" / "golden" / "trajectory_knn.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    cfg = DiffusionConfig(n_timesteps=100, vector_size=8, n_convs=2,
                          n_hidden_scalars=32, n_message_gvps=2,
                          n_update_gvps=1, n_noise_gvps=2,
                          message_norm="mean", pp_k_max=24, precision=1e-5,
                          **meta["config_overrides"])
    state = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    model = load_reference_state_dict(state, cfg, device=dev)
    sizes, f, p = meta["pharm_sizes"], meta["f_slots"], meta["p_slots"]
    b, n = len(sizes), data["prot_x"].shape[0]
    px = np.zeros((b, p, 3), np.float32)
    ph = np.zeros((b, p, 11), np.float32)
    pm = np.zeros((b, p), bool)
    px[:, :n], ph[:, :n], pm[:, :n] = data["prot_x"], data["prot_h"], True
    fm = np.arange(f)[None] < np.asarray(sizes)[:, None]
    batch = PharmComplexBatch(np.zeros((b, f, 3), np.float32),
                              np.zeros((b, f, 6), np.float32), fm, px, ph, pm)
    noise = {"x_T": data["noise_x_T"], "h_T": data["noise_h_T"],
             "pos": data["noise_pos"], "feat": data["noise_feat"]}
    chip_smoke.reset_launches()
    out = model.sample_given_receptor(
        batch, init_pharm_com=np.broadcast_to(data["init_com"], (b, 3)),
        visualize_trajectory=True, noise=noise)
    # captured: the chain's K1 launches are its graph replays'
    assert chip_smoke.read_replayed()["knn_select"] == cfg.n_timesteps
    assert chip_smoke.replay_counts()[0] == cfg.n_timesteps
    traj = out["traj_x"].cpu().numpy()
    for i, m in enumerate(sizes):
        assert np.abs(traj[1:, i, :m] - data[f"ref_frames_{i}"]).max() < 2e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["train", "copies=3", "hj=V+1",
                                  "masked destination", "repeated source",
                                  "K=1", "odd batch B=3", "5 GVPs"])
def test_pp_backward_kernel_matches_plain(dev, case, dtype):
    """K3 against autograd through the plain version at chip_smoke.py's
    ppbwd cases: fp32 within rtol 2e-4 / atol 2e-5 of the plain version
    run in fp64; bf16 against the fp32
    plain gradients within max(0.25, 1.5 x the plain version's own bf16
    deviation) relative to max(|b|, 1) (chip_smoke.PPBWD_TOL, the reason
    beside it). The value reached is printed."""
    import chip_smoke as cs
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    args, kw = cs.pp_case(dev, dtype=dtype, table_dtype=torch.float32,
                          **cs.PPBWD_CASES[case])
    gen = torch.Generator(device=dev).manual_seed(5)
    b, nd = args[0].shape[0], args[2].mask.shape[1]
    cot = (torch.randn(b, nd, kw["scalar_size"], generator=gen, device=dev),
           torch.randn(b, nd, kw["vector_size"], 3, generator=gen,
                       device=dev))
    before = trace.counters()["pp_message.bwd_launches"]
    got = cs.ppbwd_grads(args, kw, True, cot)
    torch.cuda.synchronize()
    assert trace.counters()["pp_message.bwd_launches"] == before + 1
    want = cs.ppbwd_want(args, kw, dtype, cot)
    bound = None
    if dtype == "bfloat16":
        floor = cs.bf16_rel(cs.ppbwd_grads(args, kw, False, cot), want)
        bound = max(cs.PPBWD_TOL["bfloat16"], cs.PPBWD_BF16_FLOOR * floor)
    print(f"{case} {dtype}: {cs.ppbwd_compare(case, got, want, dtype, bound)}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_gvps", [3, 4, 5, 6])
def test_pp_backward_shared_memory_fits_deeper_chains(dev, n_gvps, dtype):
    """K3's shared memory per block stays within a Hopper block's at the
    training widths (S=128, V=16, H0=17, Hj=16, R=16) for chains of 3-6
    GVPs (16-row chunks where 32 rows do not fit), and K3 runs such a
    chain in each dtype."""
    import chip_smoke as cs
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    lib = ppm._bwd_launcher()
    assert lib.pp_message_bwd_smem_bytes(128, 16, 17, 16, 16,
                                         n_gvps) <= ppm._MAX_SMEM
    args, kw = cs.pp_case(dev, dtype=dtype, table_dtype=torch.float32,
                          n_groups=1, copies=2, n_gvps=n_gvps)
    b, nd = args[0].shape[0], args[2].mask.shape[1]
    cot = (torch.ones(b, nd, kw["scalar_size"], device=dev),
           torch.ones(b, nd, kw["vector_size"], 3, device=dev))
    before = trace.counters()["pp_message.bwd_launches"]
    got = cs.ppbwd_grads(args, kw, True, cot)
    torch.cuda.synchronize()
    assert trace.counters()["pp_message.bwd_launches"] == before + 1
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_one_train_step_on_card_matches_cpu(dev):
    """One fp32 optimizer step's loss and gradients of the full-width
    model (chip_smoke.train_config at dropout 0, injected noise) on the
    card and on the CPU, through K1, K2 and K3 on the card."""
    import tempfile
    import chip_smoke as cs
    from pharmaforge_tpu_torch.config.load_from_config import (
        data_module_from_config, model_from_config)
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_processed_dataset(
            tmp, n_splits=3, samples_per_split=8, n_prot_range=(200, 230),
            seed=11)
        config = cs.train_config(str(data), batch_size=8)
        dm = data_module_from_config(config)
        dm.setup("fit")
        batch = next(iter(dm.train_dataloader(0)))
        print(cs.card_vs_cpu_step(model_from_config(config, device=dev),
                                  batch))


def graph_case(dev, unroll: int = 1, seed: int = 0, **kw):
    """A small dev-style model on the card (T=12, pf_k=4, 2 pockets x 3
    rows, pocket-major), its batch and the chain's keywords with numpy
    noise."""
    from pharmaforge_tpu_torch.data.batch import concat_batches, tile_pocket
    from pharmaforge_tpu_torch.models.diffusion import (
        DiffusionConfig, PharmacophoreDiffusion)
    cfg = DiffusionConfig(n_timesteps=12, vector_size=8, n_convs=2,
                          n_hidden_scalars=32, n_message_gvps=2,
                          n_update_gvps=1, n_noise_gvps=2,
                          message_norm="mean", pf_k=4, pp_k_max=16,
                          precision=1e-5, sample_scan_unroll=unroll, **kw)
    model = PharmacophoreDiffusion(
        cfg, device=dev, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(seed)
    batch = concat_batches([tile_pocket(
        rng.normal(scale=4.0, size=(40, 3)).astype(np.float32),
        np.eye(11, dtype=np.float32)[rng.integers(0, 11, 40)],
        rng.integers(3, 9, 3), max_prot=48) for _ in range(2)])
    noise = chip_smoke.chain_noise(batch.batch_size, cfg.n_timesteps,
                                   seed=seed)
    return model, batch, dict(noise=noise, pocket_group_size=3,
                              visualize_trajectory=True)


@pytest.mark.parametrize("unroll", [1, 5, 12])
def test_captured_chain_matches_eager_step_loop(dev, unroll):
    model, batch, kw = graph_case(dev, unroll)
    want = chip_smoke.eager_chain(model, batch, **kw)
    chip_smoke.reset_launches()
    got = model.sample_given_receptor(batch, **kw)
    torch.cuda.synchronize()
    u = min(unroll, 12)
    assert chip_smoke.replay_counts()[0] == 12 // u + int(12 % u > 0)
    assert chip_smoke.read_replayed()["knn_select"] == 12
    # a first call: the warm-up step, then U steps and the T mod U left
    # captured
    counts = trace.counters()
    assert counts["knn_select.launches"] == 1 + u + 12 % u
    assert counts["chain.captures"] == 1
    for key in ("pharm_x", "pharm_h", "traj_x", "traj_h"):
        err = float((got[key] - want[key]).abs().max())
        assert err < 2e-3, (key, err)


def test_kept_graphs_serve_a_later_chain(dev):
    model, batch, kw = graph_case(dev)
    model.sample_given_receptor(batch, **kw)
    later = dict(kw, noise=chip_smoke.chain_noise(batch.batch_size, 12,
                                                  seed=9))
    kept = list(model._chain_graphs.graphs.values())
    chip_smoke.reset_launches()
    got = model.sample_given_receptor(batch, **later)
    torch.cuda.synchronize()
    counts = trace.counters()
    assert list(model._chain_graphs.graphs.values()) == kept
    assert counts["knn_select.launches"] == 0
    assert counts["chain.captures"] == 0
    assert chip_smoke.read_replayed()["knn_select"] == 12
    want = chip_smoke.eager_chain(model, batch, **later)
    for key in ("pharm_x", "traj_x"):
        assert float((got[key] - want[key]).abs().max()) < 2e-3, key


def test_frozen_step_index_fails_on_card(dev):
    model, batch, kw = graph_case(dev)
    want = chip_smoke.eager_chain(model, batch, **kw)["pharm_x"]
    fresh, _, _ = graph_case(dev)
    with chip_smoke.step_index_frozen():
        got = fresh.sample_given_receptor(batch, **kw)["pharm_x"]
    miss = torch.nan_to_num((got - want).abs(), nan=np.inf).max()
    assert float(miss) > 10 * 2e-3


def trainstep_case(dev, k: int):
    """The train cell's model at narrow widths (32 scalars, 8 vectors,
    n_convs=4, so K1, K2 and K3 all run) and 2k batches of 4 pockets of 40
    atoms in 64 slots."""
    import dataclasses
    from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig
    cfg = dataclasses.replace(
        DiffusionConfig.from_config(chip_smoke.train_config("")),
        n_hidden_scalars=32, vector_size=8, n_timesteps=100)
    return (chip_smoke.trainstep_model(dev, cfg),
            chip_smoke.train_batches(2 * k, batch_size=4, atoms=40,
                                     slots=64))


@pytest.mark.parametrize("k", [3, 8])
def test_captured_train_calls_match_eager(dev, k):
    """`chip_smoke.trainstep_cases` at a small size: captured calls of K
    and of 1 step, and at accumulate 3 from two phases, against eager
    steps within the train-step tolerance with equal generator states and
    exact replayed counts; the planted faults `frozen_lr` and
    `stale_batches` at least 10 x the tolerance away."""
    model, batches = trainstep_case(dev, k)
    lines, faults, _ = chip_smoke.trainstep_cases(dev, model, batches, k)
    print("; ".join(lines), faults)
    assert set(faults) == {"frozen_lr", "stale_batches"}
    assert all(miss >= 10 for miss in faults.values())


def test_trainer_fit_replays_every_step(dev, tmp_path):
    """A short `Trainer.fit` at 3 steps a call on the card: every call a
    replay of its graph with 1 K1, 2 K2 and 2 K3 a step
    (`chip_smoke.check_calls`), calls of 3 and leftovers."""
    from pharmaforge_tpu_torch.config.load_from_config import (
        data_module_from_config, model_from_config)
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    from pharmaforge_tpu_torch.training.trainer import Trainer
    data = make_synthetic_processed_dataset(
        str(tmp_path / "data"), n_splits=3, samples_per_split=14,
        n_prot_range=(30, 60), seed=11)
    config = chip_smoke.train_config(str(data), max_epochs=1, batch_size=4)
    config["training"]["steps_per_call"] = 3
    config["training"]["evaluation"]["sample_interval"] = 0
    config["dynamics"].update(n_hidden_scalars=32, vector_size=8)
    trainer = Trainer(config, tmp_path / "run", device=dev)
    calls: list = []
    chip_smoke.count_calls(trainer, calls)
    trainer.fit(model_from_config(config, device=dev),
                data_module_from_config(config))
    assert chip_smoke.check_calls("fit", calls) == trainer.global_step
    assert all(c["captured"] for c in calls)
    assert {c["steps"] for c in calls} >= {1, 3}


def fit_setup(dev, tmp_path):
    """A `Trainer` on the card with a narrow train-cell model, its
    generator and optimizer, but no fit, and a data module over a
    synthetic set whose validation split fills two prot buckets."""
    from pharmaforge_tpu_torch.config.load_from_config import (
        data_module_from_config, model_from_config)
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    from pharmaforge_tpu_torch.training.optim import Adam
    from pharmaforge_tpu_torch.training.trainer import Trainer
    data = make_synthetic_processed_dataset(
        str(tmp_path / "data"), n_splits=3, samples_per_split=14,
        n_prot_range=(30, 90), seed=11)
    config = chip_smoke.train_config(str(data), max_epochs=1, batch_size=4)
    config["dynamics"].update(n_hidden_scalars=32, vector_size=8)
    dm = data_module_from_config(config)
    dm.setup("fit")
    trainer = Trainer(config, tmp_path / "run", device=dev)
    trainer.model = model_from_config(config, device=dev)
    trainer.generator = torch.Generator(device=dev).manual_seed(0)
    trainer.optimizer = Adam(trainer.model.parameters(), 1e-3,
                             weight_decay=1e-12)
    return trainer, dm


def validate_pair(trainer, dm) -> tuple:
    """`trainer.validate` eagerly, then captured from the same generator
    and dataset states: (eager metrics, captured metrics, the generators'
    states equal after, the captured run's validation record)."""
    gen, data = (trainer.generator.get_state(),
                 dm.val_dataset._rng.bit_generator.state)
    with chip_smoke.eager_validation():
        want = trainer.validate(dm)
    after = trainer.generator.get_state()
    trainer.generator.set_state(gen)
    dm.val_dataset._rng.bit_generator.state = data
    vals: list = []
    got = chip_smoke.record_validation(trainer, trainer.validate, dm, vals)
    return want, got, torch.equal(after, trainer.generator.get_state()), \
        vals[0]


def test_captured_validation_matches_eager(dev, tmp_path):
    """`Trainer.validate` on the card, each batch one replay of a kept
    graph (one per bucket), against the eager batches from the same
    generator state: every metric within rtol 1e-5, the generators'
    states equal, 1 K1 and 2 K2 a batch replayed."""
    trainer, dm = fit_setup(dev, tmp_path)
    before = trace.counters()["eval.captures"]
    want, got, same, val = validate_pair(trainer, dm)
    assert set(got) == set(want) and same
    assert chip_smoke.metric_miss(want, got) <= 1, (want, got)
    assert chip_smoke.check_vals("validate", [val], captured=True) >= 2
    assert val["built"] == len(chip_smoke.eval_graphs(trainer.model)) == 2
    assert trace.counters()["eval.captures"] - before == 2


def test_captured_validation_after_a_train_call(dev, tmp_path):
    """A validation on the kept graphs after a captured train call sees
    the new weights: within rtol 1e-5 of the eager one, generators equal,
    no graph built anew."""
    from pharmaforge_tpu_torch.data.batch import pad_batch_to_multiple
    trainer, dm = fit_setup(dev, tmp_path)
    validate_pair(trainer, dm)
    batch = next(iter(dm.train_dataloader(0)))
    trainer.train_call([pad_batch_to_multiple(batch, 4)[0]])
    before = trace.counters()["eval.captures"]
    want, got, same, val = validate_pair(trainer, dm)
    assert same and chip_smoke.metric_miss(want, got) <= 1, (want, got)
    assert val["built"] == 0 and val["replays"] == val["batches"]
    # a kept signature replays and never captures
    assert trace.counters()["eval.captures"] == before


def nccl_validation(state: dict, batch) -> tuple:
    """One rank of an NCCL group of one: the batch's validation metrics
    eagerly and as a captured replay (its all-reduces inside the graph)
    from equal generator states, with the rank's row range; (eager,
    captured, generators equal, replays, `step_mode`)."""
    from pharmaforge_tpu_torch.models import diffusion
    from pharmaforge_tpu_torch.parallel import mesh
    from pharmaforge_tpu_torch.training import train_state
    dev = mesh.init_distributed(device="cuda:0", backend="nccl")
    model = trainstep_case(dev, 1)[0]
    model.load_state_dict(state)
    local, rows = mesh.local_batch(batch)
    gens = [torch.Generator(device=dev).manual_seed(2) for _ in range(2)]
    names, out = train_state.eager_eval(model, local, gens[0], rows)
    want = dict(zip(names, out.tolist()))
    replays = trace.counters()["eval.replays"]
    got = train_state.eval_step(model, local, gens[1], rows)
    return (want, got, torch.equal(*(g.get_state() for g in gens)),
            trace.counters()["eval.replays"] - replays,
            train_state.step_mode(dev))


def test_validation_captured_in_an_nccl_group(dev):
    """A validation batch captured as the one rank of an NCCL group: its
    metrics within rtol 1e-5 of the rank's eager ones and of the eager
    ones without a group, generators equal, one replay."""
    from pharmaforge_tpu_torch.parallel.mesh import spawn_local
    from pharmaforge_tpu_torch.training.train_state import eager_eval
    model, _ = trainstep_case(dev, 1)
    batch = chip_smoke.train_batches(1, batch_size=4, atoms=40, slots=64)[0]
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    (want, got, same, replays, mode), = spawn_local(
        1, nccl_validation, state, batch, timeout_s=300)
    names, out = eager_eval(model, batch,
                            torch.Generator(device=dev).manual_seed(2))
    alone = dict(zip(names, out.tolist()))
    assert same and replays == 1 and mode.startswith("captured"), mode
    assert chip_smoke.metric_miss(want, got) <= 1, (want, got)
    assert chip_smoke.metric_miss(alone, got) <= 1, (alone, got)


def test_a_failed_capture_raises(dev):
    """A step that syncs with the host cannot be captured: the chain
    raises, and there is no eager retry. (Last in the file: the process
    has seen a capture fail.)"""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    model, batch, kw = graph_case(dev)
    real = PharmacophoreDiffusion.chain_step

    def syncing(self, chain):
        real(self, chain)
        float(chain.state["x"].sum())

    PharmacophoreDiffusion.chain_step = syncing
    try:
        with pytest.raises(RuntimeError):
            model.sample_given_receptor(batch, **kw)
    finally:
        PharmacophoreDiffusion.chain_step = real
    assert not model._chain_graphs.graphs
