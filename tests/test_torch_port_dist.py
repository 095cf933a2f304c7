"""PyTorch/CUDA port, slice 10: data parallelism over `torch.distributed`
(`parallel/mesh.py`), two gloo ranks on the CPU against one process, at a
tiny size. Data parallelism must be a pure performance transform, as the
JAX package's own check (tests/_dp_invariance_main.py) pins it:

* one train step (dropout 0.1, rows with 3-8 valid centres and a padded
  row): the loss within rtol 1e-5, each summed gradient leaf within
  2e-4 max|b| + 2e-5 of the one-process gradient (the train-step
  tolerance; the one-process step is the one test_torch_port_train.py
  holds against JAX), the two ranks' updated parameters bit-equal;
* `Trainer.fit` for 2 epochs, then a resumed third: rank 0's files only
  (each metric line once), the metrics within rtol 1e-4 of one process's;
* `PocketSampler.sample_pocket` (the copies split) and `sample_stacked`
  (whole pockets per rank; and an odd pocket count, run whole on each
  rank): final centres within the chain tolerance 2e-3 of one process,
  whose chain takes the pocket-copy correction while the ranks' do not;
* the train and test CLIs with `--n_devices 2 --device cpu` end to end;
* a rank that raises, or outlives its limit, fails the spawn in time.

Nothing here imports JAX, so the spawned ranks start quickly. Each spawn
has a wall-clock limit (`LIMIT_S`).
"""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu_torch.cli import test as ttest
from pharmaforge_tpu_torch.cli import train as ttrain
from pharmaforge_tpu_torch.config.load_from_config import (
    data_module_from_config,
    model_from_config,
)
from pharmaforge_tpu_torch.config.yaml_io import dump_file
from pharmaforge_tpu_torch.data.batch import (
    PharmComplexBatch,
    pad_batch_to_multiple,
    tile_pocket,
)
from pharmaforge_tpu_torch.data.synthetic import (
    make_synthetic_processed_dataset,
)
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.parallel import mesh
from pharmaforge_tpu_torch.training.optim import Adam
from pharmaforge_tpu_torch.training.sampling import PocketSampler
from pharmaforge_tpu_torch.training.train_state import train_step
from pharmaforge_tpu_torch.training.trainer import Trainer

# the hard limit of each spawn: a guard against a hung rank, far above the
# 5-20 s a spawn takes here, so that a loaded test machine does not trip it
LIMIT_S = 300.0
CHAIN_TOL = 2e-3


def model_kw(**kw):
    base = dict(n_timesteps=20, vector_size=4, n_convs=4,
                n_hidden_scalars=16, n_message_gvps=2, n_update_gvps=1,
                n_noise_gvps=2, message_norm="mean", pf_k=4, pp_k_max=8,
                dropout=0.1, precision=1e-4, fused_pp=True)
    base.update(kw)
    return base


def complex_batch(seed, b=3, f=8, p=40, f_valid=(5, 3, 8),
                  p_valid=(36, 30, 40)) -> PharmComplexBatch:
    """Random complexes: rows with different valid centre counts."""
    rng = np.random.default_rng(seed)
    pharm_mask = np.arange(f)[None] < np.array(f_valid)[:b, None]
    prot_mask = np.arange(p)[None] < np.array(p_valid)[:b, None]
    pharm_h = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (b, f))]
    prot_h = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (b, p))]
    return PharmComplexBatch(
        pharm_x=rng.normal(scale=3.0, size=(b, f, 3)).astype(np.float32)
        * pharm_mask[..., None],
        pharm_h=pharm_h * pharm_mask[..., None], pharm_mask=pharm_mask,
        prot_x=rng.normal(scale=2.4, size=(b, p, 3)).astype(np.float32)
        * prot_mask[..., None],
        prot_h=prot_h * prot_mask[..., None], prot_mask=prot_mask)


def grad_close(got, want, name):
    """max |a - b| <= 2e-4 max |b| + 2e-5 on one gradient leaf."""
    err = float((got - want).abs().max())
    bound = 2e-4 * float(want.abs().max()) + 2e-5
    assert err <= bound, f"{name}: max |a - b| {err:.3e} > {bound:.3e}"


# ------------------------------------------------------------ train step

def one_step(state, batch, distributed: bool):
    """One Adam step of the model `state` on the global `batch` (padded to
    4 rows), in this process or as one rank of a group: (metrics,
    gradients, parameters after the step)."""
    if distributed:
        mesh.init_distributed(device="cpu")
    model = PharmacophoreDiffusion(DiffusionConfig(**model_kw()),
                                   device="cpu")
    model.load_state_dict(state)
    opt = Adam(model.parameters(), 1e-3, 1e-12)
    batch, _ = pad_batch_to_multiple(batch, 4)
    local, rows = mesh.local_batch(batch)
    aux = train_step(model, opt, local, torch.Generator().manual_seed(5),
                     1e-3, rows)
    return (aux, {k: p.grad.clone() for k, p in model.named_parameters()
                  if p.grad is not None},
            {k: v.clone() for k, v in model.state_dict().items()})


def test_train_step_on_two_ranks_equals_one_process():
    model = PharmacophoreDiffusion(DiffusionConfig(**model_kw()),
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    batch = complex_batch(1)
    state = model.state_dict()
    aux, grads, _ = one_step(state, batch, False)
    ranks = mesh.spawn_local(2, one_step, state, batch, True,
                             timeout_s=LIMIT_S)
    for r_aux, r_grads, _ in ranks:
        assert set(r_aux) == set(aux)
        for k, v in aux.items():
            np.testing.assert_allclose(r_aux[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        assert set(r_grads) == set(grads)
        for k, g in grads.items():
            grad_close(r_grads[k], g, k)
    # both ranks applied the same summed gradient
    for k, v in ranks[0][2].items():
        assert torch.equal(v, ranks[1][2][k]), k


def test_local_rows_and_padding():
    batch, n = pad_batch_to_multiple(complex_batch(2), 4)
    assert n == 3 and batch.batch_size == 4
    assert not batch.pharm_mask[3].any() and not batch.prot_mask[3].any()
    assert mesh.process_local_rows(6) == (0, 6)
    assert mesh.local_batch(batch) == (batch, None)


# ------------------------------------------------------------ Trainer.fit

def fit_config(data_dir, max_epochs=2):
    """n_convs=4 at test widths, T=6, batch 4, one sampling evaluation in
    the first two epochs, validation once an epoch."""
    return {
        "training": {"batch_size": 4, "validation_splits": [2],
                     "trainer_args": {"max_epochs": max_epochs},
                     "evaluation": {"pharms_per_pocket": 2, "n_pockets": 2,
                                    "sample_interval": 1.0,
                                    "val_loss_interval": 1.0}},
        "lr_scheduler": {"base_lr": 1e-3, "weight_decay": 1e-12,
                         "reducelronplateau": {"patience": 20}},
        "checkpointing": {"save_last": True, "save_top_k": 2},
        "wandb": {"mode": "disabled"},
        "dataset": {"raw_data_dir": "", "processed_data_dir": str(data_dir),
                    "prot_elements": ["C", "N", "O", "S", "P", "F", "Cl",
                                      "Br", "I", "B", "D"],
                    "ph_type_map": ["Aromatic", "HydrogenDonor",
                                    "HydrogenAcceptor", "PositiveIon",
                                    "NegativeIon", "Hydrophobic"],
                    "subsample_pharms": True, "subsample_min": 3,
                    "subsample_max": 8, "pocket_cutoff": 8},
        "graph": {"graph_cutoffs": {"pp": 3.5, "pf": 8, "fp": 8, "ff": 9},
                  "pp_k_max": 8},
        "diffusion": {"n_timesteps": 6, "precision": 1e-4,
                      "endpoint_param_feat": True,
                      "endpoint_param_coord": True},
        "dynamics": {"vector_size": 4, "n_convs": 4, "n_hidden_scalars": 16,
                     "message_norm": "mean", "dropout": 0.1, "pf_k": 3,
                     "n_message_gvps": 2, "n_update_gvps": 1,
                     "n_noise_gvps": 2},
    }


def fit(data_dir, run_dir, distributed: bool, epochs: int = 2,
        resume: bool = False):
    """`Trainer.fit` for `epochs` (resumed from 'last' with `resume`), in
    this process or as one rank: (global step, epoch)."""
    if distributed:
        mesh.init_distributed(device="cpu")
    config = fit_config(data_dir, epochs)
    trainer = Trainer(config, run_dir, device="cpu")
    trainer.fit(model_from_config(config, device="cpu", seed=3),
                data_module_from_config(config),
                resume_from="last" if resume else None)
    return trainer.global_step, trainer.epoch


def metric_lines(run_dir: Path) -> list:
    out = []
    for ln in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(ln)
        rec.pop("time")
        out.append(rec)
    return out


def files(d: Path) -> list:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


def assert_metrics_equal(got: list, want: list) -> None:
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {w['step']} {k}")


def test_fit_and_resume_on_two_ranks_equal_one_process(tmp_path):
    data = make_synthetic_processed_dataset(
        str(tmp_path / "data"), n_splits=3, samples_per_split=6,
        n_prot_range=(30, 50), seed=1, site_rule="deterministic")
    one, two = tmp_path / "one", tmp_path / "two"
    assert fit(data, one, False) == (6, 2)
    assert mesh.spawn_local(2, fit, data, two, True,
                            timeout_s=LIMIT_S) == [(6, 2)] * 2
    assert files(two) == files(one)
    got, want = metric_lines(two), metric_lines(one)
    assert sum("validity" in r for r in want) == 1
    assert_metrics_equal(got, want)
    assert fit(data, one, False, epochs=3, resume=True) == (9, 3)
    assert mesh.spawn_local(2, fit, data, two, True, 3, True,
                            timeout_s=LIMIT_S) == [(9, 3)] * 2
    assert_metrics_equal(metric_lines(two), metric_lines(one))


# --------------------------------------------------------------- sampling

def pockets(seed, n, atoms=30):
    rng = np.random.default_rng(seed)
    return [{"prot_x": rng.normal(scale=2.4, size=(atoms, 3))
             .astype(np.float32),
             "prot_h": np.eye(11, dtype=np.float32)[
                 rng.integers(0, 11, atoms)]} for _ in range(n)]


def sample(state, how: str, n_pockets: int, distributed: bool):
    """Final centres of one `how` call ('pocket': 4 copies of one pocket;
    'stacked': n_pockets x 3), the pp_k_out each device call probed, the
    rows of each chain and the gathered dense centres."""
    if distributed:
        mesh.init_distributed(device="cpu")
    cfg = DiffusionConfig(**model_kw(n_timesteps=6))
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(state)
    sampler = PocketSampler(model, fixed_prot_slots=32, device="cpu")
    probes, rows = [], []
    real = sampler._pp_k_out
    sampler._pp_k_out = lambda batch, group: probes.append(
        real(batch, group)) or probes[-1]
    chain = model.sample_given_receptor
    model.sample_given_receptor = lambda batch, **kw: rows.append(
        batch.batch_size) or chain(batch, **kw)
    gen = torch.Generator().manual_seed(11)
    ps = pockets(4, n_pockets)
    if how == "pocket":
        res = [sampler.sample_pocket(ps[0], [3, 5, 8, 4], gen)]
    else:
        res = sampler.sample_stacked(ps, [[3, 6, 8]] * n_pockets, gen)
    return [[r.ph_coords for r in rs] for rs in res], probes, rows, \
        sampler.last_output["pharm_x"]


@pytest.mark.parametrize("how,n_pockets,split", [
    ("pocket", 1, True), ("stacked", 2, True), ("stacked", 3, False)])
def test_sampler_on_two_ranks_equals_one_process(how, n_pockets, split):
    model = PharmacophoreDiffusion(DiffusionConfig(**model_kw(n_timesteps=6)),
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(2))
    state = model.state_dict()
    want, probes, rows, _ = sample(state, how, n_pockets, False)
    assert probes and all(k > 0 for k in probes)   # the correction is on
    ranks = mesh.spawn_local(2, sample, state, how, n_pockets, True,
                             timeout_s=LIMIT_S)
    for got, r_probes, r_rows, _ in ranks:
        assert not any(r_probes)                   # and off under 2 ranks
        assert r_rows == [r // 2 if split else r for r in rows]
        assert len(got) == len(want)
        for g_pocket, w_pocket in zip(got, want):
            assert [len(g) for g in g_pocket] == [len(w) for w in w_pocket]
            for g, w in zip(g_pocket, w_pocket):
                np.testing.assert_allclose(g, w, atol=CHAIN_TOL, rtol=0)
    np.testing.assert_array_equal(ranks[0][3], ranks[1][3])


def test_rank_groups_follow_the_jax_sharding(monkeypatch):
    monkeypatch.setattr(mesh, "world", lambda: 2)
    import pharmaforge_tpu_torch.training.sampling as sampling
    monkeypatch.setattr(sampling, "world", lambda: 2)
    group = PocketSampler._rank_group
    assert group(30, 30) == 15           # one pocket: the copies split
    assert group(120, 30) == 30          # 4 pockets: 2 per rank
    assert group(90, 30) == 0            # 3 pockets: whole on each rank
    assert group(7, 7) == 0              # odd copies: whole on each rank


# ------------------------------------------------------------------- CLIs

def cli_config(tmp_path) -> dict:
    config = fit_config(tmp_path / "data", max_epochs=1)
    config["training"]["output_dir"] = str(tmp_path / "runs")
    config["training"]["evaluation"]["sample_interval"] = 0
    config["dataset"].update(synthetic=True, dataset_size=24)
    return config


def test_train_and_test_clis_on_two_ranks(tmp_path):
    dump_file(cli_config(tmp_path), tmp_path / "c.yml")
    run = ttrain.main(["--config", str(tmp_path / "c.yml"), "--n_devices",
                       "2", "--device", "cpu", "--seed", "1"])
    assert run.parent == tmp_path / "runs"
    assert [p.name for p in (tmp_path / "runs").iterdir()] == [run.name]
    records = metric_lines(run)
    steps = [r["step"] for r in records if "train total loss" in r]
    assert steps == sorted(set(steps)) and len(steps) > 0
    assert (run / "checkpoints" / "last" / "model.pt").is_file()
    outs = {}
    for n in ("1", "2"):
        outs[n] = ttest.main(["--model_dir", str(run), "--output_dir",
                              str(tmp_path / f"samples{n}"),
                              "--samples_per_pocket", "2", "--dataset_size",
                              "2", "--n_devices", n, "--device", "cpu",
                              "--metrics"])
    assert files(outs["2"]) == files(outs["1"])
    for name in ("pocket_0/pharms.xyz", "pocket_1/pharms.xyz"):
        rows = [[ln.split() for ln in (outs[n] / name).read_text()
                 .splitlines() if len(ln.split()) == 4] for n in ("1", "2")]
        assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
        np.testing.assert_allclose(
            np.array([r[1:] for r in rows[1]], float),
            np.array([r[1:] for r in rows[0]], float), atol=CHAIN_TOL)


# ----------------------------------------------------------------- faults

def raise_on_rank_1():
    mesh.init_distributed(device="cpu", timeout_s=30)
    if mesh.rank() == 1:
        raise ValueError("planted fault on rank 1")
    mesh.barrier()      # rank 0 would wait here for ever


def sleep(seconds):
    time.sleep(seconds)


def test_a_failing_rank_fails_the_spawn_in_time():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                                           "(.|\n)*planted fault"):
        mesh.spawn_local(2, raise_on_rank_1, timeout_s=LIMIT_S)
    assert time.monotonic() - t0 < LIMIT_S / 2
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 of 2 ranks"):
        mesh.spawn_local(2, sleep, 120, timeout_s=5)
    assert time.monotonic() - t0 < 60


def test_distributed_flags_need_a_group(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator, num_processes"):
        mesh.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="process_id 2 outside"):
        mesh.init_distributed("127.0.0.1:1", 2, 2, device="cpu")
    with pytest.raises(ValueError, match="does not join"):
        ttrain.main(["--config", "x.yml", "--n_devices", "2",
                     "--distributed", "--device", "cpu"])
    assert mesh.rank_device("cuda", 3) == torch.device("cuda", 3)
    assert mesh.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert mesh.rank_device("cpu", 3) == torch.device("cpu")
