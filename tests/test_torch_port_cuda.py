"""PyTorch/CUDA port on the card: the CUDA kernel against its plain version
and the golden chain through it.

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
