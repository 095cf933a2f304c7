"""PyTorch/CUDA port, slice 9: the port's train, test and generate CLIs
beside the JAX package's `train.py`, `test.py` and
`generate_pharmacophores.py`, on the CPU at a tiny size (n_convs=2, T=10,
narrow widths), the JAX weights carried into the port with
`params_from_jax`:

* train, then resume: the same run-dir layout, config.yaml, metric names
  and step counts;
* the test CLI stacked, pocket by pocket, for one pocket and with
  trajectories: the same files, frame counts, pharmacophore sizes per
  pocket, `stacked N/call` line and metrics.txt keys;
* the generate CLI on the realchem aspirin fixture in both pocket modes:
  pocket.pdb byte-equal, the same files, frame count and sizes;
* the generate CLI with `--latency_mode on` (the step tables) beside the
  JAX CLI's, and within 2e-3 of the port's own per-step chain;
* without CUDA the CLIs' default device raises; flags that cannot go
  together raise ValueError.
"""

import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu_torch.cli import generate as tgen
from pharmaforge_tpu_torch.cli import test as ttest
from pharmaforge_tpu_torch.cli import train as ttrain
from pharmaforge_tpu_torch.config import yaml_io
from pharmaforge_tpu_torch.interop import params_from_jax
from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig
from pharmaforge_tpu_torch.training.checkpoints import RunCheckpointer
from tests.test_torch_port_io import REALCHEM, ROOT, bound_pose, jax_run_dir


def tiny_config(tmp_path, name: str = "data", runs: str = "") -> dict:
    """A run config at a tiny size: n_convs=2, T=10, 8 vectors, 16
    scalars; a synthetic dataset of 3 x 8 pockets; no sampling
    evaluation inside the fit."""
    return {
        "training": {
            "output_dir": str(tmp_path / f"runs_{runs or name}"),
            "batch_size": 4,
            "num_workers": 0, "validation_splits": [2],
            "trainer_args": {"max_epochs": 2},
            "evaluation": {"pharms_per_pocket": 1, "n_pockets": 2,
                           "sample_interval": 0, "val_loss_interval": 1.0},
        },
        "lr_scheduler": {"base_lr": 1e-3, "weight_decay": 1e-12,
                         "reducelronplateau": {"mode": "min", "factor": 0.1,
                                               "patience": 20,
                                               "min_lr": 1e-5}},
        "checkpointing": {"save_last": True, "save_top_k": 2},
        "wandb": {"mode": "disabled"},
        "dataset": {
            "raw_data_dir": "", "synthetic": True, "dataset_size": 24,
            "processed_data_dir": str(tmp_path / name),
            "prot_elements": ["C", "N", "O", "S", "P", "F", "Cl", "Br", "I",
                              "B", "D"],
            "ph_type_map": ["Aromatic", "HydrogenDonor", "HydrogenAcceptor",
                            "PositiveIon", "NegativeIon", "Hydrophobic"],
            "pocket_cutoff": 8, "subsample_pharms": True,
            "subsample_min": 4, "subsample_max": 8,
        },
        "graph": {"graph_cutoffs": {"pp": 3.5, "pf": 8, "fp": 8, "ff": 9},
                  "pp_k_max": 8},
        "diffusion": {"n_timesteps": 10, "precision": 1e-5,
                      "remove_com": True},
        "dynamics": {"vector_size": 8, "n_convs": 2, "n_hidden_scalars": 16,
                     "message_norm": "mean", "dropout": 0.1, "ff_k": 0,
                     "pf_k": 4, "n_message_gvps": 2, "n_update_gvps": 1,
                     "n_noise_gvps": 2},
    }


def run_jax_cli(monkeypatch, script: str, argv: list) -> None:
    monkeypatch.setattr(sys, "argv", [script] + [str(a) for a in argv])
    runpy.run_path(str(ROOT / script), run_name="__main__")


def tree(d: Path) -> list:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


def frame_sizes(xyz: Path) -> list:
    """The centre count of every frame of an xyz file."""
    lines = xyz.read_text().splitlines()
    sizes, i = [], 0
    while i < len(lines):
        n = int(lines[i])
        sizes.append(n)
        i += n + 1
    return sizes


# ------------------------------------------------------------------ train

def test_synthetic_dataset_of_a_config_matches_the_jax_cli(tmp_path):
    jtrain = runpy.run_path(str(ROOT / "train.py"))
    for side, make in (("jax", jtrain["maybe_make_synthetic"]),
                       ("port", ttrain.maybe_make_synthetic)):
        make(tiny_config(tmp_path, side))
    splits = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert splits == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(splits) == 3
    for split in splits:
        a = np.load(tmp_path / "jax" / split / "prot_pharm_tensors.npz")
        b = np.load(tmp_path / "port" / split / "prot_pharm_tensors.npz")
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
        assert len(a["prot_idx"]) == 8


def small_dataset(config: dict) -> None:
    """The config's dataset, made ahead of the CLIs with pockets of 30-60
    atoms: one bucket, so the JAX trainer compiles one train step."""
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    make_synthetic_processed_dataset(
        config["dataset"]["processed_data_dir"], n_splits=3,
        samples_per_split=8, n_prot_range=(30, 60), seed=2)


def test_train_and_resume_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    runs = {}
    small_dataset(tiny_config(tmp_path))
    for side in ("jax", "port"):
        config = tiny_config(tmp_path, runs=side)
        yaml_io.dump_file(config, tmp_path / f"{side}.yml")
        argv = ["--config", tmp_path / f"{side}.yml", "--seed", "1"]
        if side == "jax":
            run_jax_cli(monkeypatch, "train.py", argv)
        else:
            ttrain.main([str(a) for a in argv] + ["--device", "cpu"])
        (run,) = Path(config["training"]["output_dir"]).iterdir()
        runs[side] = run
    out = capsys.readouterr().out
    assert out.count("Results are being written to:") == 2

    def layout(run):
        ck = run / "checkpoints"
        top = sorted(int(p.name) for p in (ck / "top").iterdir())
        return (sorted(p.name for p in run.iterdir()),
                sorted(p.name for p in ck.iterdir()), len(top),
                all((p / "meta.json").exists()
                    for p in [ck / "last", *(ck / "top").iterdir()]), top)

    def records(run):
        recs = [yaml.safe_load(ln) for ln in
                (run / "metrics.jsonl").read_text().splitlines()]
        return [(r["step"], sorted(set(r) - {"time"})) for r in recs]

    def meta(run):
        m = yaml.safe_load((run / "checkpoints/last/meta.json").read_text())
        return m["step"], m["epoch"]

    jrun, trun = runs["jax"], runs["port"]
    assert re.fullmatch(r"run_[a-z0-9]{8}", trun.name)
    assert layout(trun) == layout(jrun)
    assert layout(trun)[0] == ["checkpoints", "config.yaml", "metrics.jsonl"]
    assert records(trun) == records(jrun)
    assert meta(trun) == meta(jrun)
    jconf = yaml.safe_load((jrun / "config.yaml").read_text())
    tconf = yaml_io.load_file(trun / "config.yaml")
    assert tconf["resume"]["run_id"] == trun.name.split("_")[1]
    for conf, side in ((jconf, "jax"), (tconf, "port")):
        conf.pop("resume")
        assert conf["training"].pop("output_dir").endswith(side)
    assert tconf == jconf

    # resume: the step count goes on from the first fit; the layout keeps
    # the JAX fit's shape (the JAX package's own tests resume JAX runs)
    steps, epoch = meta(trun)
    first = records(trun)
    for epochs, target in ((3, trun), (4, trun / "checkpoints" / "last")):
        conf = yaml_io.load_file(trun / "config.yaml")
        conf["training"]["trainer_args"]["max_epochs"] = epochs
        yaml_io.dump_file(conf, trun / "config.yaml")
        ttrain.main(["--resume", str(target), "--device", "cpu"])
        assert meta(trun) == (steps * epochs // epoch, epochs)
        recs = records(trun)
        assert recs[:len(first)] == first
        assert [s for s, _ in recs[len(first):]][0] == \
            steps * (epochs - 1) // epoch + 1
        first = recs
        got = layout(trun)
        assert got[:4] == layout(jrun)[:4]
        assert set(got[4]) <= {steps * e // epoch
                               for e in range(1, epochs + 1)}


# --------------------------------------------------------------- sampling

@pytest.fixture(scope="module")
def run_pair(tmp_path_factory):
    """A JAX run dir and a port run dir with the same config and weights."""
    tmp = tmp_path_factory.mktemp("cli")
    config = tiny_config(tmp)
    small_dataset(config)
    jrun, params = jax_run_dir(tmp, config)
    trun = tmp / "port_run"
    trun.mkdir()
    yaml_io.dump_file(config, trun / "config.yaml")
    cfg = DiffusionConfig.from_config(config)
    RunCheckpointer(trun).save({"model": params_from_jax(params, cfg)},
                               {"step": 1})
    return jrun, trun


def sample_both(monkeypatch, capsys, run_pair, tmp_path, argv):
    jrun, trun = run_pair
    outs, stdout = {}, {}
    for side, run in (("jax", jrun), ("port", trun)):
        out = tmp_path / side
        full = ["--model_dir", run, "--output_dir", out, "--seed", "5"] + argv
        if side == "jax":
            run_jax_cli(monkeypatch, "test.py", full)
        else:
            ttest.main([str(a) for a in full] + ["--device", "cpu"])
        outs[side] = out
        stdout[side] = capsys.readouterr().out
    return outs, stdout


@pytest.mark.parametrize("argv,stacked", [
    (["--samples_per_pocket", "3", "--dataset_size", "5",
      "--max_batch_size", "6", "--metrics"], "stacked 2/call"),
    (["--samples_per_pocket", "2", "--dataset_size", "2",
      "--pockets_per_call", "1"], None),
    (["--samples_per_pocket", "2", "--dataset_idx", "1",
      "--use_ref_pharm_com"], None),
    (["--samples_per_pocket", "2", "--dataset_idx", "1", "--dataset_size",
      "2", "--dataset_idx_as_start", "--visualize_trajectory", "--metrics"],
     None)], ids=["stacked", "per_pocket", "single", "trajectory"])
def test_test_cli_matches_the_jax_cli(monkeypatch, capsys, run_pair,
                                      tmp_path, argv, stacked):
    outs, stdout = sample_both(monkeypatch, capsys, run_pair, tmp_path, argv)
    jout, tout = outs["jax"], outs["port"]
    assert tree(tout) == tree(jout)
    for out in stdout.values():
        found = re.search(r"stacked \d+/call", out)
        assert (found and found.group()) == stacked
    for f in sorted(tout.rglob("*.xyz")):
        assert frame_sizes(f) == frame_sizes(jout / f.relative_to(tout)), f
        xyz = np.array([ln.split()[1:] for ln in f.read_text().splitlines()
                        if len(ln.split()) == 4], float)
        assert np.isfinite(xyz).all()
    if "--metrics" in argv:
        def keys(out):
            return [ln.split(":")[0] for ln in
                    (out / "metrics.txt").read_text().splitlines()]
        assert keys(tout) == keys(jout)
        assert keys(tout)[0] == "validity"


@pytest.mark.parametrize("mode", ["ligand", "residues"])
def test_generate_cli_matches_the_jax_cli(monkeypatch, run_pair, tmp_path,
                                          mode):
    pocket = (["--ref_ligand_file", bound_pose(tmp_path)] if mode == "ligand"
              else ["--residue_list", "A:30", "A:75", "B:12"])
    jrun, trun = run_pair
    dirs = {}
    for side, run in (("jax", jrun), ("port", trun)):
        argv = [REALCHEM / "aspirin_rec.pdb", *pocket, "--model_dir", run,
                "--samples_per_pocket", "5", "--output_dir", tmp_path / side,
                "--seed", "3"]
        if side == "jax":
            run_jax_cli(monkeypatch, "generate_pharmacophores.py", argv)
        else:
            tgen.main([str(a) for a in argv] + ["--device", "cpu"])
        dirs[side] = tmp_path / side / "aspirin_rec"
    jd, td = dirs["jax"], dirs["port"]
    assert tree(td) == tree(jd)
    assert (td / "pocket.pdb").read_bytes() == (jd / "pocket.pdb").read_bytes()
    sizes = frame_sizes(td / "pharms.xyz")
    assert sizes == frame_sizes(jd / "pharms.xyz")
    assert len(sizes) == 5 and all(3 <= n <= 8 for n in sizes)


def test_generate_cli_latency_mode_on_matches_the_jax_cli(
        monkeypatch, run_pair, tmp_path):
    """`--latency_mode on`: the same files, pocket and sizes as the JAX
    CLI's; the chain built its step tables once, and its centres are
    within the chain tolerance of the port's per-step chain (same seed,
    so the same noise)."""
    from pharmaforge_tpu_torch.models import diffusion
    jrun, trun = run_pair
    dirs = {}
    built = []
    real = diffusion.precompute_sampling_tables
    monkeypatch.setattr(diffusion, "precompute_sampling_tables",
                        lambda *a: built.append(a[-2].shape) or real(*a))
    for side, run, mode in (("jax", jrun, "on"), ("port", trun, "on"),
                            ("port_off", trun, "off")):
        argv = [REALCHEM / "aspirin_rec.pdb", "--residue_list", "A:30",
                "A:75", "B:12", "--model_dir", run,
                "--samples_per_pocket", "4", "--output_dir", tmp_path / side,
                "--seed", "3", "--latency_mode", mode]
        if side == "jax":
            run_jax_cli(monkeypatch, "generate_pharmacophores.py", argv)
        else:
            tgen.main([str(a) for a in argv] + ["--device", "cpu"])
        dirs[side] = tmp_path / side / "aspirin_rec"
    assert built == [(10,)]                      # T = 10, one build
    jd, td, off = dirs["jax"], dirs["port"], dirs["port_off"]
    assert tree(td) == tree(jd)
    assert (td / "pocket.pdb").read_bytes() == (jd / "pocket.pdb").read_bytes()
    sizes = frame_sizes(td / "pharms.xyz")
    assert sizes == frame_sizes(jd / "pharms.xyz") == \
        frame_sizes(off / "pharms.xyz")

    def centres(d):
        return np.array([ln.split()[1:] for ln in (d / "pharms.xyz")
                         .read_text().splitlines() if len(ln.split()) == 4],
                        float)
    np.testing.assert_allclose(centres(td), centres(off), atol=2e-3, rtol=0)


# ----------------------------------------------------------------- errors

def test_cli_errors(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rec = str(REALCHEM / "aspirin_rec.pdb")
    config = tmp_path / "c.yml"
    yaml_io.dump_file(tiny_config(tmp_path), config)
    for main, argv in ((ttrain.main, ["--config", str(config)]),
                       (ttest.main, ["--model_dir", str(tmp_path)]),
                       (tgen.main, [rec, "--residue_list", "A:30",
                                    "--model_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    with pytest.raises(ValueError, match="does not join"):
        ttrain.main(["--config", str(config), "--n_devices", "2",
                     "--distributed", "--device", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        ttrain.main(["--config", str(config), "--resume", str(tmp_path)])
    with pytest.raises(ValueError, match="invalid choice"):
        ttest.main(["--model_dir", str(tmp_path), "--matmul_precision",
                    "float16"])
    with pytest.raises(ValueError, match="resume argument"):
        ttrain.main(["--resume", str(tmp_path / "nope"), "--device", "cpu"])


def test_matmul_precision_is_restored_after_a_cli(run_pair, tmp_path):
    import torch
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    seen = []
    real = ttest._run

    def spy(args, device):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cudnn.allow_tf32))
        return real(args, device)

    ttest._run = spy
    try:
        ttest.main(["--model_dir", str(run_pair[1]), "--output_dir",
                    str(tmp_path), "--dataset_idx", "0", "--device", "cpu",
                    "--matmul_precision", "tensorfloat32"])
    finally:
        ttest._run = real
    assert seen == [("high", True)]
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32) == saved
