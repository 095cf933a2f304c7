"""PyTorch/CUDA port on the card: the CUDA kernels (K1, K2, K3) against
their plain versions, the golden chain through K1, and one full-width
training step on the card against the CPU.

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

import chip_smoke
from pharmaforge_tpu_torch.ops import knn_select as ks

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


@pytest.mark.parametrize("b,p,k,ties", [
    (240, 230, 5, False), (3, 64, 5, False), (4, 64, 1, True),
    (4, 64, 5, True), (4, 64, 8, True), (2, 6, 9, False)])
def test_kernel_bit_equal_to_plain(dev, b, p, k, ties):
    rng = np.random.default_rng(b * 100 + k)
    args = [torch.from_numpy(a).to(dev)
            for a in make_inputs(rng, b=b, p=p, ties=ties)]
    before = ks.launches
    got = ks.knn_select(*args, k)
    want = ks.knn_select_reference(*args, k)
    torch.cuda.synchronize()
    assert ks.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_kernel_refuses_bad_inputs(dev):
    args = [torch.from_numpy(a).to(dev)
            for a in make_inputs(np.random.default_rng(0))]
    with pytest.raises(TypeError):
        ks.knn_select(args[0], args[1].float(), args[2], args[3], 5)
    with pytest.raises(ValueError):
        ks.knn_select(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                      *args[1:], 5)


PP_CASES = chip_smoke.PP_CASES


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(PP_CASES))
def test_pp_kernel_matches_plain(dev, case, dtype):
    """K2 against its plain version at chip_smoke.py's pp cases, within
    chip_smoke.PP_TOL (fp32 rtol 1e-5 / atol 1e-6; bf16 rtol 1e-2 /
    atol 1e-3, the reason beside it)."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    args, kw = chip_smoke.pp_case(dev, dtype=dtype, **PP_CASES[case])
    before = ppm.launches
    with torch.no_grad():
        got = ppm.fused_message_agg(*args, **kw)
        want = ppm.message_agg_reference(*args, **kw)
    torch.cuda.synchronize()
    assert ppm.launches == before + 1
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
    before = ks.launches
    out = model.sample_given_receptor(
        batch, init_pharm_com=np.broadcast_to(data["init_com"], (b, 3)),
        visualize_trajectory=True, noise=noise)
    assert ks.launches - before == cfg.n_timesteps
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
    before = ppm.bwd_launches
    got = cs.ppbwd_grads(args, kw, True, cot)
    torch.cuda.synchronize()
    assert ppm.bwd_launches == before + 1
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
    before = ppm.bwd_launches
    got = cs.ppbwd_grads(args, kw, True, cot)
    torch.cuda.synchronize()
    assert ppm.bwd_launches == before + 1
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
