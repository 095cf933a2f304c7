"""PyTorch/CUDA port, the sampling chain and its entry points, on the CPU.

* the frozen golden chains (tests/golden/trajectory_*.npz) within 2e-3,
  the JAX package's full-chain tolerance over T=100;
* a random-init JAX chain against the port's chain, weights carried by
  `params_from_jax`, noise injected on both sides, within 2e-3;
* pocket-group dedup against the ungrouped chain, the host-side sampler,
  the options the port lacks or refuses, and the port's import and device
  contracts.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
import yaml

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.data.batch import PharmComplexBatch as JaxBatch
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.data.batch import PharmComplexBatch, tile_pocket
from pharmaforge_tpu_torch.interop import (
    load_reference_state_dict,
    params_from_jax,
)
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.training.sampling import PocketSampler

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
TOL = 2e-3


def golden_config(**overrides):
    kw = dict(n_timesteps=100, vector_size=8, n_convs=2,
              n_hidden_scalars=32, n_message_gvps=2, n_update_gvps=1,
              n_noise_gvps=2, message_norm="mean", ff_k=0, pf_k=0,
              pp_k_max=24, precision=1e-5)
    kw.update(overrides)
    return DiffusionConfig(**kw)


def dense_batch(prot_x, prot_h, sizes, f_slots, p_slots):
    b, n = len(sizes), prot_x.shape[0]
    px = np.zeros((b, p_slots, 3), np.float32)
    ph = np.zeros((b, p_slots, prot_h.shape[1]), np.float32)
    pm = np.zeros((b, p_slots), bool)
    px[:, :n], ph[:, :n], pm[:, :n] = prot_x, prot_h, True
    fm = np.arange(f_slots)[None] < np.asarray(sizes)[:, None]
    return PharmComplexBatch(np.zeros((b, f_slots, 3), np.float32),
                             np.zeros((b, f_slots, 6), np.float32), fm,
                             px, ph, pm)


@pytest.mark.parametrize("name", ["radius", "knn"])
def test_golden_chain_matches_frozen_frames(name):
    data = np.load(GOLDEN / f"trajectory_{name}.npz")
    meta = json.loads(bytes(data["meta"]).decode())
    state = {k[len("sd::"):]: data[k] for k in data.files
             if k.startswith("sd::")}
    cfg = golden_config(**meta["config_overrides"])
    model = load_reference_state_dict(state, cfg, device="cpu")
    sizes = meta["pharm_sizes"]
    batch = dense_batch(data["prot_x"], data["prot_h"], sizes,
                        meta["f_slots"], meta["p_slots"])
    noise = {"x_T": data["noise_x_T"], "h_T": data["noise_h_T"],
             "pos": data["noise_pos"], "feat": data["noise_feat"]}
    out = model.sample_given_receptor(
        batch, init_pharm_com=np.broadcast_to(data["init_com"],
                                              (len(sizes), 3)),
        visualize_trajectory=True, noise=noise)
    traj = out["traj_x"].numpy()
    assert traj.shape == (cfg.n_timesteps + 1, len(sizes), 8, 3)
    for i, n in enumerate(sizes):
        # the initial frame comes first: frame k+1 <-> reference step k
        dev = np.abs(traj[1:, i, :n] - data[f"ref_frames_{i}"]).max()
        assert dev < TOL, f"graph {i}: max per-step deviation {dev:.2e}"
        np.testing.assert_allclose(out["pharm_x"][i, :n].numpy(),
                                   data[f"ref_x_{i}"], atol=TOL)
        np.testing.assert_allclose(out["pharm_h"][i, :n].numpy(),
                                   data[f"ref_h_{i}"], atol=TOL)


def chain_inputs(rng, n_pockets=2, copies=2, t_steps=50, p=32):
    """`n_pockets` pockets x `copies` rows, pocket-major, plus noise."""
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
             "pos": rng.normal(size=(t_steps, b, 8, 3)),
             "feat": rng.normal(size=(t_steps, b, 8, 6))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    com = rng.normal(scale=2.0, size=(b, 3)).astype(np.float32)
    return batch, noise, com


@pytest.mark.parametrize("endpoint", [False, True])
def test_random_init_chain_matches_jax(rng, endpoint):
    kw = dict(n_timesteps=50, vector_size=8, n_convs=2, n_hidden_scalars=32,
              n_message_gvps=2, n_update_gvps=1, n_noise_gvps=2,
              message_norm="mean", pf_k=4, ff_k=0, pp_k_max=16,
              precision=1e-5, endpoint_param_feat=endpoint,
              endpoint_param_coord=endpoint)
    batch, noise, com = chain_inputs(rng, t_steps=50)
    jmodel = JaxDiffusion(JaxConfig(**kw))
    jbatch = JaxBatch(**dataclasses.asdict(batch))
    params = jax.device_get(jmodel.init_params(jax.random.key(5), jbatch))
    want = jmodel.sample_given_receptor(
        params, jbatch, jax.random.key(0), init_pharm_com=com,
        visualize_trajectory=True, noise=noise, pocket_group_size=2)

    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    got = model.sample_given_receptor(
        batch, init_pharm_com=com, visualize_trajectory=True, noise=noise,
        pocket_group_size=2)
    for key in ("traj_x", "traj_h", "pharm_x", "pharm_h"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=0, err_msg=key)


def small_model(seed=0, **kw):
    base = dict(n_timesteps=12, vector_size=8, n_convs=2,
                n_hidden_scalars=32, n_message_gvps=2, n_update_gvps=1,
                n_noise_gvps=2, message_norm="mean", pf_k=4, pp_k_max=16,
                precision=1e-5)
    base.update(kw)
    return PharmacophoreDiffusion(
        DiffusionConfig(**base), device="cpu",
        generator=torch.Generator().manual_seed(seed))


def test_grouped_chain_equals_ungrouped(rng):
    batch, noise, com = chain_inputs(rng, copies=3, t_steps=12)
    model = small_model()
    kw = dict(init_pharm_com=com, noise=noise)
    grouped = model.sample_given_receptor(batch, pocket_group_size=3, **kw)
    flat = model.sample_given_receptor(batch, pocket_group_size=1, **kw)
    for key in ("pharm_x", "pharm_h"):
        np.testing.assert_allclose(grouped[key].numpy(), flat[key].numpy(),
                                   atol=1e-5, rtol=0)


def test_pocket_sampler_stacked_sweep(rng):
    pockets = []
    for _ in range(2):
        n = int(rng.integers(20, 30))
        pockets.append({
            "prot_x": rng.normal(scale=4.0, size=(n, 3)).astype(np.float32),
            "prot_h": np.eye(11, dtype=np.float32)[rng.integers(0, 11, n)],
            "prot_ph_x": rng.normal(size=(4, 3)).astype(np.float32),
            "prot_ph_h": np.eye(6, dtype=np.float32)[[0, 1, 2, 5]]})
    sizes = [[3, 5, 8], [4, 4, 6]]
    sampler = PocketSampler(small_model(), fixed_prot_slots=32,
                            device="cpu")
    res = sampler.sample(pockets, sizes, torch.Generator().manual_seed(1))
    out = sampler.last_output
    assert out["pharm_x"].shape == (6, 8, 3)     # one stacked device batch
    mask = out["pharm_mask"]
    assert not out["pharm_x"][~mask].any() and not out["pharm_h"][~mask].any()
    assert [[r.n_ph_centers for r in rs] for rs in res] == sizes
    assert res[0][0].prot_ph_types == ["Aromatic", "HydrogenDonor",
                                       "HydrogenAcceptor", "Hydrophobic"]
    assert np.isfinite(res[1][2].ph_coords).all()
    assert res[1][2].to_xyz_file().startswith("6\n")
    traj = sampler.sample_pocket(pockets[0], [3, 4],
                                 torch.Generator().manual_seed(2),
                                 visualize_trajectory=True)
    assert traj[1].pos_frames.shape == (13, 4, 3)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        small_model(compute_dtype="float16")
    # bf16 edge chains and the fused pp branch are ported
    for kw in (dict(compute_dtype="bfloat16"), dict(fused_pp=True),
               dict(n_convs=4), dict(n_convs=4, fused_pp=False)):
        small_model(**kw)
    # the pocket-copy correction is ported: a pp_k_out below the pp
    # graph's maximum out-degree raises instead of dropping edges
    batch, noise, _ = chain_inputs(np.random.default_rng(0), t_steps=12)
    with pytest.raises(ValueError, match="out-degree"):
        small_model().sample_given_receptor(batch, noise=noise,
                                            pocket_group_size=2, pp_k_out=1)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = small_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        PocketSampler(model, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        PharmacophoreDiffusion(model.config)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_reference_state_dict_missing_key_raises():
    model = small_model()
    sd = model.state_dict()
    sd.pop("dynamics.pharm_encoder.0.weight")
    with pytest.raises(KeyError):
        load_reference_state_dict(sd, model.config, device="cpu")


def test_config_from_dev_yml_matches_jax():
    config = yaml.safe_load((ROOT / "configs" / "dev.yml").read_text())
    assert dataclasses.asdict(DiffusionConfig.from_config(config)) == \
        dataclasses.asdict(JaxConfig.from_config(config))


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pharmaforge_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'pharmaforge_tpu', 'optax',\n"
        "              'orbax', 'wandb', 'yaml'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('pharmaforge_tpu_torch.')]))\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_mods, bad = res.stdout.strip().splitlines()
    assert int(n_mods) >= 34
    assert bad == "[]"


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    import shutil
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    for cwd in (ROOT, tmp_path):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
