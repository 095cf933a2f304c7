"""PyTorch/CUDA port, slice 3: training, against the JAX package on the CPU.

* The loss: the same weights, batch and diffusion draws (the JAX key's
  draws injected into the port) through JAX `loss` (its unfused
  `fused_pp=False` path, which tests/test_pp_fused.py:388-415 ties to the
  fused one) and the port's `loss` (its fused prot-prot branch, the plain
  version on the CPU), at dropout 0 and n_convs=3: every loss and metric
  within rtol 1e-5, every parameter gradient within
  max|a - b| <= 2e-4 max|b| + 2e-5 per leaf.
* Adam with weight decay, clip and 2-step accumulation against optax on
  the same gradients: 1e-6 over 5 updates. ReduceLROnPlateau: the same
  learning-rate sequence.
* The synthetic dataset files and the loader's batches: bit-equal to the
  JAX package's for the same seed; collate and padding likewise.
* A tiny `Trainer.fit` on the CPU: fit, checkpoint round trip, resume,
  train-time sampling; the trained weights loaded into the JAX package by
  `import_torch_state_dict` give the same denoiser forward within 2e-4.
JAX matmuls run in full fp32 (tests/conftest.py).
"""

import dataclasses
import gzip
import json
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.analysis import metrics as jmetrics
from pharmaforge_tpu.data import batch as jbatch
from pharmaforge_tpu.data import dataset as jdataset
from pharmaforge_tpu.data import synthetic as jsynth
from pharmaforge_tpu.interop.torch_import import import_torch_state_dict
from pharmaforge_tpu.models import edges as jedges
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu.models.size_dist import PharmSizeDistribution as JaxSizes
from pharmaforge_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
from pharmaforge_tpu.training import optim as joptim
from pharmaforge_tpu.training.train_state import _set_lr
from pharmaforge_tpu_torch.analysis import metrics as tmetrics
from pharmaforge_tpu_torch.config.load_from_config import (
    data_module_from_config,
    model_from_config,
)
from pharmaforge_tpu_torch.data import batch as tbatch
from pharmaforge_tpu_torch.data import dataset as tdataset
from pharmaforge_tpu_torch.data import synthetic as tsynth
from pharmaforge_tpu_torch.interop import params_from_jax
from pharmaforge_tpu_torch.models import edges as tedges
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.models.gvp import GVPDropout
from pharmaforge_tpu_torch.models.size_dist import PharmSizeDistribution
from pharmaforge_tpu_torch.training.checkpoints import RunCheckpointer
from pharmaforge_tpu_torch.training.optim import Adam, ReduceLROnPlateau
from pharmaforge_tpu_torch.training.trainer import Trainer
from tests.conftest import make_complex_batch

ELEMENTS = ["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B", "D"]
PH_TYPES = ["Aromatic", "HydrogenDonor", "HydrogenAcceptor", "PositiveIon",
            "NegativeIon", "Hydrophobic"]
CUTOFFS = {"pp": 3.5, "pf": 8.0, "fp": 8.0, "ff": 9.0}


def t(a):
    return torch.from_numpy(np.array(a))


def port_batch(jb):
    return tbatch.PharmComplexBatch(**{
        f.name: np.asarray(getattr(jb, f.name))
        for f in dataclasses.fields(tbatch.PharmComplexBatch)})


def grad_close(got, want, name):
    """max |a - b| <= 2e-4 max |b| + 2e-5 on one gradient leaf."""
    err = float(np.abs(got - want).max())
    bound = 2e-4 * float(np.abs(want).max()) + 2e-5
    assert err <= bound, f"{name}: max |a - b| {err:.3e} > {bound:.3e}"


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("endpoint,weighted", [(False, False), (True, True)])
def test_loss_and_gradients_match_jax(rng, endpoint, weighted):
    kw = dict(n_timesteps=20, vector_size=4, n_convs=3, n_hidden_scalars=16,
              n_message_gvps=3, n_update_gvps=2, n_noise_gvps=3,
              message_norm="mean", pf_k=4, pp_k_max=8, dropout=0.0,
              precision=1e-4, endpoint_param_feat=endpoint,
              endpoint_param_coord=endpoint, weighted_loss=weighted)
    jb = make_complex_batch(rng, b=3, p=40, f_valid=(5, 3, 7),
                            p_valid=(36, 30, 40))
    jb = jb.replace(prot_x=jb.prot_x * 0.4)      # pp edges at 3.5 A
    jmodel = JaxDiffusion(JaxConfig(fused_pp=False, **kw))
    params = jmodel.init_params(jax.random.key(1), jb)
    key = jax.random.key(7)
    (j_total, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, key, train=True), has_aux=True))(params)
    # the JAX loss's own draws, injected into the port
    k_t, k_ex, k_eh, _ = jax.random.split(key, 4)
    b, f = jb.pharm_mask.shape
    noise = {"t_int": np.asarray(jax.random.randint(k_t, (b,), 0, 20)),
             "eps_x": np.asarray(jax.random.normal(k_ex, (b, f, 3))),
             "eps_h": np.asarray(jax.random.normal(k_eh, (b, f, 6)))}

    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg))
    total, aux = model.loss(port_batch(jb), train=True, noise=noise)
    assert model.training
    total.backward()
    assert set(aux) == set(j_aux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = params_from_jax(jax.device_get(j_grads), cfg)
    for name, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        grad_close(got.numpy(), want[name].numpy(), name)


def test_loss_draws_from_the_generator_and_needs_one(rng):
    cfg = DiffusionConfig(n_timesteps=10, vector_size=4, n_convs=2,
                          n_hidden_scalars=16, message_norm="mean",
                          dropout=0.1, pp_k_max=8)
    model = PharmacophoreDiffusion(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    batch = port_batch(make_complex_batch(rng))
    with pytest.raises(ValueError, match="generator"):
        model.loss(batch)
    runs = [model.loss(batch, torch.Generator().manual_seed(s))[0].item()
            for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]
    model.loss(batch, torch.Generator().manual_seed(3), train=False)
    assert not model.training


def test_dropout_masks_come_from_the_generator():
    drop = GVPDropout(0.25).train()
    feats, vecs = torch.ones(64, 32), torch.ones(64, 8, 3)
    with pytest.raises(ValueError, match="generator"):
        drop(feats, vecs)
    a = drop(feats, vecs, torch.Generator().manual_seed(1))
    b = drop(feats, vecs, torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    kept = a[0] != 0
    assert torch.allclose(a[0][kept], torch.tensor(1 / 0.75))
    # a whole 3-vector is kept or dropped
    assert torch.equal((a[1] != 0).all(-1), (a[1] != 0).any(-1))
    assert 0.6 < float(kept.float().mean()) < 0.9
    drop.eval()
    assert drop(feats, vecs)[0] is feats


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("accumulate", [1, 2])
def test_adam_matches_optax(rng, accumulate):
    shapes = [(4, 3), (5,)]
    params0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = 5 * accumulate
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    lrs = [1e-2 * 0.7 ** (i // 2) for i in range(steps)]
    opt = joptim.make_optimizer(1e-2, weight_decay=1e-2, clip_value=0.8)
    if accumulate > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accumulate)
    jp = [jnp.asarray(p) for p in params0]
    state = opt.init(jp)
    tp = [torch.nn.Parameter(t(p)) for p in params0]
    adam = Adam(tp, 1e-2, weight_decay=1e-2, clip_value=0.8,
                accumulate=accumulate)
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        state = _set_lr(state, lr)
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = t(x)
        assert adam.step(lr) == ((i + 1) % accumulate == 0)
        for a, w in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("reload", [False, True])
@pytest.mark.parametrize("accumulate", [1, 3])
def test_adam_rate_and_state_round_trip(rng, accumulate, reload):
    """The rate set with `set_lr` between updates (no rebuild) takes
    effect; with `reload` the state goes through `state_dict` into a fresh
    optimizer before every micro-step, mid-accumulation too; both against
    optax as `test_adam_matches_optax`."""
    shapes = [(4, 3), (5,)]
    params0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = 4 * accumulate
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    lrs = [1e-2 * 0.5 ** (i // accumulate) for i in range(steps)]
    opt = joptim.make_optimizer(1e-2, weight_decay=1e-2, clip_value=0.8)
    if accumulate > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accumulate)
    jp = [jnp.asarray(p) for p in params0]
    state = opt.init(jp)
    tp = [torch.nn.Parameter(t(p)) for p in params0]

    def fresh():
        return Adam(tp, 1e-2, weight_decay=1e-2, clip_value=0.8,
                    accumulate=accumulate)

    adam = fresh()
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        state = _set_lr(state, lr)
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        if reload:
            saved = adam.state_dict()
            adam = fresh()
            adam.load_state_dict(saved)
            assert adam.mini_step == i % accumulate
        for p, x in zip(tp, g):
            p.grad = t(x)
        adam.set_lr(lr)
        assert adam.step() == ((i + 1) % accumulate == 0)
        for a, w in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                       rtol=0, atol=1e-6)


def test_plateau_schedule_matches_jax():
    kw = dict(factor=0.5, patience=2, min_lr=1e-4, mode="min")
    mine, theirs = ReduceLROnPlateau(**kw), joptim.ReduceLROnPlateau(**kw)
    metrics = [1.0, 0.9, 0.95, 0.93, 0.92, 0.91, 0.95, 0.97, 0.99, 0.8,
               0.85, 0.86, 0.9, 0.95, 0.96, 0.97, 0.98]
    lr_m = lr_t = 1e-3
    for m in metrics:
        lr_m, lr_t = mine.step(m, lr_m), theirs.step(m, lr_t)
        assert lr_m == lr_t
    assert mine.state_dict() == theirs.state_dict()
    fresh = ReduceLROnPlateau(**kw)
    fresh.load_state_dict(mine.state_dict())
    assert fresh.state_dict() == mine.state_dict()


# ------------------------------------------------------------------ data

def _write_both(tmp_path, **kw):
    jsynth.make_synthetic_processed_dataset(str(tmp_path / "jax"), **kw)
    tsynth.make_synthetic_processed_dataset(str(tmp_path / "port"), **kw)
    return tmp_path / "jax", tmp_path / "port"


def _dataset(mod, root, splits, seed=0):
    return mod.ProteinPharmacophoreDataset(
        name="x", split_idxs=splits, raw_data_dir="",
        processed_data_dir=str(root), graph_cutoffs=CUTOFFS,
        prot_elements=ELEMENTS, ph_type_map=PH_TYPES, subsample_pharms=True,
        subsample_min=3, subsample_max=8, seed=seed)


def test_synthetic_dataset_and_loader_match_jax(tmp_path):
    j_root, p_root = _write_both(tmp_path, n_splits=3, samples_per_split=10,
                                 n_prot_range=(20, 140), seed=3,
                                 site_rule="deterministic")
    for split in sorted(p.name for p in j_root.iterdir()):
        a, b = (np.load(r / split / "prot_pharm_tensors.npz")
                for r in (j_root, p_root))
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        for name in ("prot_file_names.pkl.gz", "lig_rdmol.pkl.gz"):
            with gzip.open(j_root / split / name) as fa, \
                    gzip.open(p_root / split / name) as fb:
                assert pickle.load(fa) == pickle.load(fb)

    j_ds, p_ds = _dataset(jdataset, j_root, [0, 1]), \
        _dataset(tdataset, p_root, [0, 1])
    for i in (0, 5, 19):
        a, b = j_ds[i], p_ds[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    j_ld = jdataset.BucketedLoader(j_ds, 4, shuffle=True, seed=2)
    p_ld = tdataset.BucketedLoader(p_ds, 4, shuffle=True, seed=2)
    assert len(j_ld) == len(p_ld) and j_ld.max_pharm == p_ld.max_pharm
    n = 0
    for _ in range(2):                   # two epochs: the RNGs keep in step
        for jb, pb in zip(j_ld, p_ld):
            for f in dataclasses.fields(tbatch.PharmComplexBatch):
                a, b = np.asarray(getattr(jb, f.name)), getattr(pb, f.name)
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            n += 1
    assert n == 2 * len(p_ld)


def test_collate_and_padding_match_jax(rng):
    samples = [{"pharm_x": rng.normal(size=(n, 3)).astype(np.float32),
                "pharm_h": np.eye(6, dtype=np.float32)[rng.integers(0, 6, n)],
                "prot_x": rng.normal(size=(m, 3)).astype(np.float32),
                "prot_h": np.eye(11, dtype=np.float32)[rng.integers(0, 11, m)]}
               for n, m in ((3, 50), (7, 70), (5, 65))]
    j = jbatch.collate_complexes(samples)
    p = tbatch.collate_complexes(samples)
    jp, jn = jax_pad(j, 4)
    pp, pn = tbatch.pad_batch_to_multiple(p, 4)
    assert jn == pn == 3
    for f in dataclasses.fields(tbatch.PharmComplexBatch):
        for a, b in ((getattr(j, f.name), getattr(p, f.name)),
                     (getattr(jp, f.name), getattr(pp, f.name))):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


def test_validity_metric_and_size_distribution_match_jax(tmp_path, rng):
    for _ in range(5):
        n, m = rng.integers(1, 8), rng.integers(0, 10)
        args = ([PH_TYPES[i] for i in rng.integers(0, 6, n)],
                rng.normal(scale=4, size=(n, 3)),
                [PH_TYPES[i] for i in rng.integers(0, 6, m)],
                rng.normal(scale=4, size=(m, 3)))
        for count in (True, False):
            assert tmetrics.compute_complementarity(*args, count) == \
                jmetrics.compute_complementarity(*args, count)
    _, root = _write_both(tmp_path, n_splits=2, samples_per_split=6,
                          n_prot_range=(20, 40), seed=1)
    for d in (str(root), None):
        mine, theirs = PharmSizeDistribution(d, seed=4), JaxSizes(d, seed=4)
        assert np.array_equal(mine.sample(20), theirs.sample(20))
        assert np.array_equal(mine.sample_uniformly(9),
                              theirs.sample_uniformly(9))


# --------------------------------------------------------------- trainer

def tiny_config(data_dir, max_epochs=2):
    """A full-structure model (n_convs=4, 3/2/3 GVPs, knn pf, endpoint) at
    test widths over a tiny synthetic dataset, as a Python dict."""
    return {
        "training": {"batch_size": 4, "validation_splits": [2],
                     "steps_per_call": 2,
                     "trainer_args": {"max_epochs": max_epochs,
                                      "accumulate_grad_batches": 1},
                     "evaluation": {"pharms_per_pocket": 2, "n_pockets": 2,
                                    "sample_interval": 1.0,
                                    "val_loss_interval": 0.5}},
        "lr_scheduler": {"base_lr": 1e-3, "weight_decay": 1e-12,
                         "reducelronplateau": {"patience": 20}},
        "checkpointing": {"save_last": True, "save_top_k": 2},
        "wandb": {"mode": "disabled"},
        "dataset": {"raw_data_dir": "", "processed_data_dir": str(data_dir),
                    "prot_elements": ELEMENTS, "ph_type_map": PH_TYPES,
                    "subsample_pharms": True, "subsample_min": 3,
                    "subsample_max": 8},
        "graph": {"graph_cutoffs": CUTOFFS, "pp_k_max": 8},
        "diffusion": {"n_timesteps": 10, "precision": 1e-4,
                      "endpoint_param_feat": True,
                      "endpoint_param_coord": True},
        "dynamics": {"vector_size": 4, "n_convs": 4, "n_hidden_scalars": 16,
                     "message_norm": "mean", "dropout": 0.1, "pf_k": 3,
                     "n_message_gvps": 3, "n_update_gvps": 2,
                     "n_noise_gvps": 3},
    }


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    data = tsynth.make_synthetic_processed_dataset(
        str(root / "data"), n_splits=3, samples_per_split=6,
        n_prot_range=(30, 50), seed=1, site_rule="deterministic")
    config = tiny_config(data)
    model = model_from_config(config, device="cpu")
    trainer = Trainer(config, root / "run", device="cpu")
    trainer.fit(model, data_module_from_config(config))
    return config, root, model, trainer


def test_trainer_fit_checkpoints_resumes_and_samples(trained):
    config, root, model, trainer = trained
    assert trainer.epoch == 2 and trainer.global_step == 6
    # one optimizer step counted per batch
    assert trainer.global_step == 6
    records = [json.loads(ln) for ln in
               (root / "run" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train total loss"] for r in records
              if "train total loss" in r]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert any("validity" in r for r in records)          # sampled
    assert sum("val total loss" in r for r in records) >= 3
    ckpt = root / "run" / "checkpoints"
    meta = json.loads((ckpt / "last" / "meta.json").read_text())
    assert (meta["step"], meta["epoch"]) == (6, 2)
    assert set(meta) >= {"lr", "plateau", "monitored"}
    assert len(list((ckpt / "top").iterdir())) == 2
    # the checkpoint restores bit-equal weights
    state, _ = RunCheckpointer(root / "run").restore("last")
    for k, v in model.state_dict().items():
        assert torch.equal(state["model"][k], v), k
    # a third epoch from 'last', into a fresh model
    config3 = tiny_config(config["dataset"]["processed_data_dir"], 3)
    resumed = Trainer(config3, root / "run", device="cpu")
    fresh = model_from_config(config3, device="cpu", seed=9)
    resumed.fit(fresh, data_module_from_config(config3), resume_from="last")
    assert resumed.epoch == 3 and resumed.global_step == 9
    assert json.loads((ckpt / "last" / "meta.json").read_text())["epoch"] == 3


def test_trained_weights_load_into_jax(trained, rng):
    config, _, model, _ = trained
    cfg = model.config
    jcfg = JaxConfig.from_config(config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    params = import_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    jb = make_complex_batch(rng, b=2, p=40, f_valid=(5, 3),
                            p_valid=(36, 30))
    jb = jb.replace(prot_x=jb.prot_x * 0.4)
    tv = np.float32([0.3, 0.8])
    px, pm = jnp.asarray(jb.prot_x), jnp.asarray(jb.prot_mask)
    nbrs, pp_edge = jedges.build_pp_edge(px, pm, 3.5, cfg.pp_k_max)
    want = jax.jit(lambda p: JaxDiffusion(jcfg).dynamics.apply(
        {"params": p}, jnp.asarray(jb.pharm_h), jnp.asarray(jb.pharm_x),
        jnp.asarray(jb.pharm_mask), jnp.asarray(jb.prot_h), px, pm,
        jnp.asarray(tv), nbrs, pp_edge=pp_edge))(params)
    model.eval()
    _, pp_t = tedges.build_pp_edge(t(jb.prot_x), t(jb.prot_mask), 3.5,
                                   cfg.pp_k_max)
    with torch.no_grad():
        got = model.dynamics(t(jb.pharm_h), t(jb.pharm_x), t(jb.pharm_mask),
                             t(jb.prot_h), t(jb.prot_x), t(jb.prot_mask),
                             t(tv), pp_edge=pp_t)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=2e-4,
                                   rtol=0)


def test_trainer_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tiny_config(tmp_path), tmp_path / "run")
    with pytest.raises(RuntimeError, match="CUDA"):
        model_from_config(tiny_config(tmp_path))
