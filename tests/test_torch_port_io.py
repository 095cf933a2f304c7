"""PyTorch/CUDA port, slice 9: the modules behind the CLIs, against the JAX
package on the CPU.

* `config/yaml_io.py` against PyYAML (`yaml.load(FullLoader)`, what the
  JAX package reads configs with): every config in the repo, `yaml.dump`
  of the tiny test configs, the YAML 1.1 scalar rules; the writer's
  output reads back equal through both readers; input outside the subset
  raises.
* `config/cmdline.py`: the same flag table and the same merged configs
  and errors as JAX's.
* `training/restore.py`: `resolve_run_dir` and `load_config` as JAX's,
  raises included; `load_model` from a checkpoint directory and from a
  `.ckpt` file.
* `interop.py`'s file-level entry points: `config_from_hyper_parameters`
  field for field, the same errors; a `.ckpt` exported from a JAX run dir
  serves the same loss in the port, and the port's export serves the
  same loss in JAX (rtol 1e-5, fp32, JAX matmuls in full fp32 by
  tests/conftest.py).
* `preprocessing/structure.py` and the generate CLI's pocket arrays:
  equal to JAX's on the realchem fixture and the synthetic PDB, mmCIF
  and SDF files of tests/test_structure_io.py.
* An import guard: every module of the port imports with `jax`, `flax`,
  `yaml` and `pharmaforge_tpu` made unimportable.
"""

import argparse
import dataclasses
import glob
import math
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import torch_threads  # noqa: F401  (one torch thread a worker)
import generate_pharmacophores as jgen
from pharmaforge_tpu.config import cmdline as jcmd
from pharmaforge_tpu.interop import torch_import as jinterop
from pharmaforge_tpu.models.diffusion import DiffusionConfig as JaxConfig
from pharmaforge_tpu.preprocessing import structure as jstruct
from pharmaforge_tpu.training import restore as jrestore
from pharmaforge_tpu_torch import interop
from pharmaforge_tpu_torch.cli import generate as tgen
from pharmaforge_tpu_torch.config import cmdline as tcmd
from pharmaforge_tpu_torch.config import yaml_io
from pharmaforge_tpu_torch.config.load_from_config import model_from_config
from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig
from pharmaforge_tpu_torch.preprocessing import structure as tstruct
from pharmaforge_tpu_torch.training import restore as trestore
from pharmaforge_tpu_torch.training.checkpoints import RunCheckpointer
from pharmaforge_tpu_torch.utils.misc import get_prot_atom_ph_type_maps
from tests.conftest import make_complex_batch
from tests.test_structure_io import mmcif_file, pdb_file, sdf_file  # noqa: F401
from tests.test_torch_port_train import port_batch

ROOT = Path(__file__).resolve().parent.parent
REALCHEM = ROOT / "tests" / "fixtures" / "realchem"
CONFIGS = ["configs/dev.yml"] + sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        str(ROOT / "evidence" / "*" / "config.yaml")))


def pyyaml(text):
    return yaml.load(text, Loader=yaml.FullLoader)


def tiny_configs(tmp_path):
    from tests.test_e2e_train import tiny_config as e2e_tiny
    from tests.test_torch_port_cli import tiny_config as cli_tiny
    return [e2e_tiny(tmp_path), cli_tiny(tmp_path)]


# ------------------------------------------------------------------- YAML

def test_the_configs_in_the_repo_are_six_evidence_runs_and_dev():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_and_writer_match_pyyaml_on_repo_configs(path):
    text = (ROOT / path).read_text()
    want = pyyaml(text)
    assert yaml_io.load(text) == want
    written = yaml_io.dump(want)
    assert yaml_io.load(written) == want
    assert pyyaml(written) == want
    # the writer writes what yaml.dump writes (sorted, indentless lists)
    assert written == yaml.dump(want)


def test_yaml_reader_and_writer_match_pyyaml_on_dumped_test_configs(
        tmp_path):
    for config in tiny_configs(tmp_path):
        dumped = yaml.dump(config)
        assert yaml_io.load(dumped) == config
        written = yaml_io.dump(config)
        assert pyyaml(written) == config
        assert yaml_io.load(written) == config


SCALARS = ["1.0e-3", "1e-3", "1.0e3", "1.0E+3", "-2.5e-05", "1.", ".5",
           "+.5", "-.inf", ".Inf", "True", "true", "TRUE", "tRue", "yes",
           "Yes", "on", "ON", "off", "No", "n", "y", "~", "null", "Null",
           "", "0", "-0", "08", "0x1f", "0o17", "1_000", "+12", "abc def",
           "a'b", "it's #1", "'quoted # not a comment'", "'it''s'",
           '"a\\tb\\\\c\\"d"',
           "[1, 2.0, a, 'b', [c, {d: e}]]", "{'pp': 3.5, pf: 8, q: }",
           "[]", "{}", "[a, b,]", "v # comment"]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalar_rules_match_pyyaml(text):
    want = pyyaml(f"k: {text}\n")["k"]
    got = yaml_io.load(f"k: {text}\n")["k"]
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", [
    "a:\n- 1\n- 2\nb: 3\n", "a:\n  - x\n  - 'y'\n", "- a\n- [b, c]\n",
    "1: x\n~: y\nyes: z\n", "a:\n  b:\n    c: 1\n  d:\ne: []\n",
    "a: 1   # trailing\n# whole line\n\nb: 'x: y'\n", "'key w': 1\n",
    "a:\n  3.5\n"])
def test_yaml_block_structure_matches_pyyaml(text):
    assert yaml_io.load(text) == pyyaml(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n", "a: >\n  text\n",
    "a: two\n  lines\n", "a: 'open\n  quote'\n", "---\na: 1\n",
    "%YAML 1.1\n---\na: 1\n", "a: 2001-12-14\n", "? a\n: b\n",
    "a:\n- b: 1\n", "a:\n-\n  - 1\n", "<<: {a: 1}\n", "a: [1,\n 2]\n",
    "a:\n\t b: 1\n", "a: b: c\n", "a: '1' x\n", 'a: "\\q"\n',
    # binary, octal and base-60 numbers and the escapes beyond one
    # character: PyYAML resolves them, this reader refuses them
    "a: 017\n", "a: 0b101\n", "a: 1:30\n", "a: -1:30\n", "a: 1:30.5\n",
    'a: "\\u00e9"\n', 'a: "\\x41"\n', 'a: "\\U0001F600"\n', 'a: "\\N"\n'])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(yaml_io.YamlError):
        yaml_io.load(text)


def as_read(value):
    """`value` as a YAML reader gives it back: tuples become lists."""
    if isinstance(value, dict):
        return {k: as_read(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [as_read(v) for v in value]
    return value


@pytest.mark.parametrize("value", [
    {"s": ["1e-3", "yes", "~", "", " x", "a: b", "#c", "x #y", "it's",
           "2001-12-14", "[a]", "-", "0x1f", "1.0", "null", "a,b", "<<",
           "017", "0b101", "1:30"]},
    {"f": [1e-05, 1e20, 0.1, -2.0, float("inf"), float("-inf")],
     "i": [0, -3, 10 ** 12], "b": [True, False], "n": None},
    {"nested": {"empty": {}, "lst": [], "deep": {"x": [1, [2, 3],
                                                        {"k": "v"}]}}},
    ["top", "level", 3], {1: "int key", "ok": (1, 2)}])
def test_yaml_writer_round_trips_through_both_readers(value):
    text = yaml_io.dump(value)
    assert yaml_io.load(text) == as_read(value) == pyyaml(text)


def test_yaml_writer_refuses_what_it_cannot_read_back():
    for value in ({"a": "two\nlines"}, {"a": np.float32(1.0)},
                  {"a": object()}):
        with pytest.raises(yaml_io.YamlError):
            yaml_io.dump(value)


# ---------------------------------------------------------------- cmdline

def test_flag_table_equals_jax():
    def row(f):
        return (f.name, f.type if f.convert is None else f.type.__name__,
                tuple(f.path) if f.path else None, f.group, f.help,
                f.convert.__name__ if f.convert else None)
    assert [row(f) for f in tcmd.FLAGS] == [row(f) for f in jcmd.FLAGS]
    jp = jcmd.register_hyperparameter_args(argparse.ArgumentParser())
    tp = tcmd.register_hyperparameter_args(argparse.ArgumentParser())
    assert ([(g.title, [a.dest for a in g._group_actions])
             for g in tp._action_groups]
            == [(g.title, [a.dest for a in g._group_actions])
                for g in jp._action_groups])


def every_flag_argv():
    argv = []
    for f in jcmd.FLAGS:
        value = {"use_tanh": "True", "message_norm": "4",
                 "feature_norm": "1", "restart_type": "linear",
                 "exp_name": "x", "architecture": "gvp"}.get(f.name, "3")
        argv += [f"--{f.name}", value]
    return argv


def base_config():
    return {"training": {"batch_size": 32,
                         "trainer_args": {"max_epochs": 10}},
            "diffusion": {"n_timesteps": 100, "precision": 1e-5},
            "dynamics": {"n_convs": 2, "message_norm": "mean", "ff_k": 0},
            "graph": {"graph_cutoffs": {"pp": 3.5, "pf": 8}},
            "dataset": {}}


@pytest.mark.parametrize("argv", [
    [], every_flag_argv(), ["--message_norm", "mean", "--use_tanh", "False",
                            "--pf_cutoff", "6.5", "--lr", "0.01"]])
def test_merge_equals_jax(argv):
    def merged(mod):
        p = mod.register_hyperparameter_args(argparse.ArgumentParser())
        return mod.merge_config_and_args(base_config(), p.parse_args(argv))
    got, want = merged(tcmd), merged(jcmd)
    assert got == want
    assert yaml_io.dump(got) == yaml.dump(want)


@pytest.mark.parametrize("argv", [["--use_tanh", "yes"],
                                  ["--feature_norm", "2"],
                                  ["--use_tanh", "true"]])
def test_bad_flag_values_raise_as_in_jax(argv):
    for mod in (jcmd, tcmd):
        p = mod.register_hyperparameter_args(argparse.ArgumentParser())
        with pytest.raises(ValueError):
            mod.merge_config_and_args(base_config(), p.parse_args(argv))


def test_cli_parser_raises_where_argparse_exits():
    p = tcmd.register_hyperparameter_args(tcmd.ArgumentParser(prog="x"))
    for argv in (["--n_convs", "two"], ["--no_such_flag"]):
        with pytest.raises(ValueError, match="x: "):
            p.parse_args(argv)


# ---------------------------------------------------------------- restore

def test_resolve_run_dir_and_load_config_match_jax(tmp_path):
    ckpt = tmp_path / "run" / "checkpoints" / "last.ckpt"
    for args in ((ckpt, None), (None, tmp_path / "run"),
                 (ckpt, tmp_path / "other")):
        assert trestore.resolve_run_dir(*args) == \
            jrestore.resolve_run_dir(*args)
    for mod in (jrestore, trestore):
        with pytest.raises(ValueError, match="--ckpt or --model_dir"):
            mod.resolve_run_dir(None, None)
    run = tmp_path / "run"
    run.mkdir()
    for mod in (jrestore, trestore):
        with pytest.raises(FileNotFoundError, match="config file"):
            mod.load_config(run)
    (run / "config.yml").write_text((ROOT / "configs/dev.yml").read_text())
    assert trestore.load_config(run) == jrestore.load_config(run)
    (run / "config.yaml").write_text("a: {'b': [1, 2.0e-3]}\n")
    assert trestore.load_config(run) == jrestore.load_config(run) == {
        "a": {"b": [1, 2e-3]}}


# ---------------------------------------------------------------- interop

MODEL = dict(n_timesteps=20, vector_size=4, n_convs=2, n_hidden_scalars=16,
             n_message_gvps=2, n_update_gvps=1, n_noise_gvps=2,
             message_norm="mean", pf_k=4, pp_k_max=8, dropout=0.0,
             precision=1e-4, endpoint_param_feat=True)


def run_config(tmp_path):
    """A run config whose model is MODEL (the JAX schema)."""
    from tests.test_torch_port_cli import tiny_config
    config = tiny_config(tmp_path)
    config["diffusion"].update(n_timesteps=20, precision=1e-4,
                               endpoint_param_feat=True)
    config["dynamics"].update(vector_size=4, n_convs=2, n_hidden_scalars=16,
                              n_message_gvps=2, n_update_gvps=1,
                              n_noise_gvps=2, pf_k=4, dropout=0.0)
    config["graph"]["pp_k_max"] = 8
    return config


def hparams(**over):
    base = {"pharm_nf": 6, "rec_nf": 11, "n_timesteps": 20,
            "precision": 1e-4, "endpoint_param_feat": True,
            "rl_dist_threshold": 0,
            "ph_type_map": ["Aromatic", "HydrogenDonor", "HydrogenAcceptor",
                            "PositiveIon", "NegativeIon", "Hydrophobic"],
            "graph_config": {"graph_cutoffs": {"pp": 3.5, "pf": 7,
                                               "fp": 8, "ff": 9}},
            "dynamics_config": {"vector_size": 4, "n_convs": 3,
                                "message_norm": 10, "pf_k": 4,
                                "n_noise_gvps": 2, "unknown": 1}}
    base.update(over)
    return base


@pytest.mark.parametrize("over", [{}, {"graph_config": None,
                                       "dynamics_config": None},
                                  {"weighted_loss": True, "remove_com": False,
                                   "ph_type_map": None}])
def test_config_from_hyper_parameters_matches_jax(over):
    got = interop.config_from_hyper_parameters(hparams(**over))
    want = jinterop.config_from_hyper_parameters(hparams(**over))
    assert dataclasses.asdict(got) == {
        f.name: getattr(want, f.name) for f in dataclasses.fields(got)}
    assert {f.name for f in dataclasses.fields(got)} == {
        f.name for f in dataclasses.fields(want)}


def test_permuted_type_map_raises_as_in_jax():
    h = hparams(ph_type_map=list(reversed(hparams()["ph_type_map"])))
    for mod in (jinterop, interop):
        with pytest.raises(ValueError, match="ph_type_map"):
            mod.config_from_hyper_parameters(h)


def reference_ckpt(path, state, hp=None, gamma=None):
    ckpt = {"state_dict": {k: torch.as_tensor(np.asarray(v))
                           for k, v in state.items()}}
    if gamma is not None:
        ckpt["state_dict"]["gamma.gamma"] = torch.as_tensor(gamma)
    if hp is not None:
        ckpt["hyper_parameters"] = hp
    torch.save(ckpt, path)
    return path


def test_checkpoint_errors_raise_as_in_jax(tmp_path):
    cfg = DiffusionConfig(**MODEL)
    state = PharmacophoreDiffusionCPU(cfg).state_dict()
    bad_gamma = np.linspace(0, 1, cfg.n_timesteps + 1)
    short_gamma = np.zeros(cfg.n_timesteps)
    jcfg = JaxConfig(**MODEL)
    for gamma, match in ((bad_gamma, "does not match"),
                         (short_gamma, "timesteps")):
        path = reference_ckpt(tmp_path / "g.ckpt", state, gamma=gamma)
        with pytest.raises(ValueError, match=match):
            interop.load_torch_checkpoint(path, cfg)
        with pytest.raises(ValueError, match=match):
            jinterop.load_torch_checkpoint(str(path), jcfg)
    path = reference_ckpt(tmp_path / "noh.ckpt", state)
    for fn in (interop.model_from_torch_checkpoint,
               jinterop.model_from_torch_checkpoint):
        with pytest.raises(ValueError, match="hyper_parameters"):
            fn(str(path))
    missing = dict(state)
    missing.pop(next(iter(missing)))
    path = reference_ckpt(tmp_path / "miss.ckpt", missing)
    with pytest.raises(KeyError):
        interop.load_torch_checkpoint(path, cfg)
    with pytest.raises(KeyError):
        jinterop.load_torch_checkpoint(str(path), jcfg)
    # a missing .ckpt file fails as a missing file in both load_models
    run = tmp_path / "run"
    run.mkdir()
    yaml_io.dump_file(run_config(tmp_path), run / "config.yaml")
    with pytest.raises(FileNotFoundError, match="checkpoint file"):
        jrestore.load_model(run, str(tmp_path / "nope.ckpt"))
    with pytest.raises(FileNotFoundError, match="checkpoint file"):
        trestore.load_model(run, str(tmp_path / "nope.ckpt"), device="cpu")


def PharmacophoreDiffusionCPU(cfg):
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    return PharmacophoreDiffusion(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(3))


def loss_pair(jmodel, jparams, tmodel, rng):
    """(JAX loss, port loss) of one batch with the same injected draws."""
    jb = make_complex_batch(rng, b=3, p=40, f_valid=(5, 3, 7),
                            p_valid=(36, 30, 40))
    jb = jb.replace(prot_x=jb.prot_x * 0.4)
    key = jax.random.key(7)
    j_total, _ = jax.jit(lambda p: jmodel.loss(p, jb, key, train=True))(
        jparams)
    k_t, k_ex, k_eh, _ = jax.random.split(key, 4)
    b, f = jb.pharm_mask.shape
    t_max = jmodel.config.n_timesteps
    noise = {"t_int": np.asarray(jax.random.randint(k_t, (b,), 0, t_max)),
             "eps_x": np.asarray(jax.random.normal(k_ex, (b, f, 3))),
             "eps_h": np.asarray(jax.random.normal(k_eh, (b, f, 6)))}
    t_total, _ = tmodel.loss(port_batch(jb), train=True, noise=noise)
    return float(j_total), t_total.item()


def jax_run_dir(tmp_path, config):
    """A JAX run dir: config.yaml by yaml.dump, random params saved."""
    from pharmaforge_tpu.config.load_from_config import (
        model_from_config as jax_model_from_config)
    from pharmaforge_tpu.training.checkpoints import (
        RunCheckpointer as JaxCheckpointer)
    rd = tmp_path / "jax_run"
    rd.mkdir()
    with open(rd / "config.yaml", "w") as f:
        yaml.dump(config, f)
    model = jax_model_from_config(config)
    params = jax.device_get(jax.jit(model.init_params)(
        jax.random.key(0), jrestore.dummy_batch(model)))
    JaxCheckpointer(rd, **config["checkpointing"]).save(
        {"params": params}, {"step": 1})
    return rd, params


def test_jax_export_serves_the_same_loss_in_the_port(tmp_path, rng):
    from scripts.export_torch_ckpt import export_run
    rd, _ = jax_run_dir(tmp_path, run_config(tmp_path))
    path = export_run(rd)
    assert path == rd / "checkpoints" / "exported_reference.ckpt"
    jmodel, jparams = jinterop.model_from_torch_checkpoint(str(path))
    tmodel = interop.model_from_torch_checkpoint(path, device="cpu")
    j, t = loss_pair(jmodel, jparams, tmodel, rng)
    np.testing.assert_allclose(t, j, rtol=1e-5)
    # the run dir's own route: config.yaml + the .ckpt file
    model, config = trestore.load_model(rd, str(path), device="cpu")
    assert config == pyyaml((rd / "config.yaml").read_text())
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), tmodel.state_dict().values()))


def test_port_export_serves_the_same_loss_in_jax(tmp_path, rng):
    config = run_config(tmp_path)
    rd = tmp_path / "port_run"
    rd.mkdir()
    yaml_io.dump_file(config, rd / "config.yaml")
    model = model_from_config(config, device="cpu", seed=5)
    RunCheckpointer(rd).save({"model": model.state_dict()}, {"step": 1})
    path = interop.export_reference_checkpoint(rd)
    assert path == rd / "checkpoints" / "exported_reference.ckpt"
    state = interop.load_torch_checkpoint(path, model.config)
    assert all(torch.equal(state[k], v)
               for k, v in model.state_dict().items())
    assert set(state) == set(model.state_dict())
    jmodel, jparams = jinterop.model_from_torch_checkpoint(str(path))
    tmodel = interop.model_from_torch_checkpoint(path, device="cpu")
    j, t = loss_pair(jmodel, jparams, tmodel, rng)
    np.testing.assert_allclose(t, j, rtol=1e-5)
    loaded, _ = trestore.load_model(rd, "last", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        loaded.state_dict().values(), model.state_dict().values()))


# -------------------------------------------------------------- structure

def atoms_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a) == tuple(b)
        np.testing.assert_array_equal(a.coord, b.coord)


def test_structure_parsers_match_jax(pdb_file, mmcif_file,  # noqa: F811
                                     sdf_file):  # noqa: F811
    for path in (pdb_file, REALCHEM / "aspirin_rec.pdb"):
        atoms_equal(tstruct.parse_pdb_atoms(path),
                    jstruct.parse_pdb_atoms(path))
        got = tstruct.group_residues(tstruct.parse_pdb_atoms(path))
        want = jstruct.group_residues(jstruct.parse_pdb_atoms(path))
        assert [k for k, _ in got] == [k for k, _ in want]
    atoms_equal(tstruct.parse_structure_atoms(mmcif_file),
                jstruct.parse_structure_atoms(mmcif_file))
    for path in (sdf_file, REALCHEM / "aspirin_rec_asp_lig_tt_docked.sdf"):
        for remove_h in (False, True):
            np.testing.assert_array_equal(
                tstruct.parse_sdf_coords(path, remove_hydrogen=remove_h),
                jstruct.parse_sdf_coords(path, remove_hydrogen=remove_h))
    assert tstruct.STANDARD_AA == jstruct.STANDARD_AA


def bound_pose(tmp_path):
    """The fixture SDF's second record, the bound aspirin pose (its first
    record is a decoy 40 A away, which selects no pocket)."""
    text = (REALCHEM / "aspirin_rec_asp_lig_tt_docked.sdf").read_text()
    path = tmp_path / "aspirin_bound.sdf"
    path.write_text(text.split("$$$$\n")[1] + "$$$$\n")
    return path


def test_generate_pocket_arrays_bit_equal_to_jax(tmp_path, pdb_file,  # noqa: F811
                                                 mmcif_file,  # noqa: F811
                                                 sdf_file):  # noqa: F811
    elements, _ = get_prot_atom_ph_type_maps(yaml_io.load_file(
        ROOT / "configs/dev.yml")["dataset"])
    cases = [(REALCHEM / "aspirin_rec.pdb", bound_pose(tmp_path), ()),
             (REALCHEM / "aspirin_rec.pdb", None, ("A:30", "A:75", "B:12")),
             (pdb_file, sdf_file, ()), (mmcif_file, sdf_file, ()),
             (pdb_file, None, ("A:1", "B:7"))]
    for i, (rec, lig, residues) in enumerate(cases):
        outs = []
        for j, mod in enumerate((jgen, tgen)):
            d = tmp_path / f"case{i}_{j}"
            d.mkdir()
            outs.append((d, mod.process_ligand_and_pocket(
                rec, d, elements, 8.0, lig_file=lig,
                residue_list=list(residues))))
        (dj, want), (dt, got) = outs
        assert set(got) == set(want) == {"prot_x", "prot_h", "init_com"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (dt / "pocket.pdb").read_bytes() == \
            (dj / "pocket.pdb").read_bytes()


# ------------------------------------------------------------------ utils

def test_utils_match_jax(tmp_path):
    from pharmaforge_tpu.training.logging import generate_run_id as jid
    from pharmaforge_tpu.utils import misc as jmisc
    from pharmaforge_tpu.utils import relative_paths as jpaths
    from pharmaforge_tpu.utils import timing as jtiming
    from pharmaforge_tpu_torch.training.logging import generate_run_id
    from pharmaforge_tpu_torch.utils import misc as tmisc
    from pharmaforge_tpu_torch.utils import relative_paths as tpaths
    from pharmaforge_tpu_torch.utils import timing as ttiming

    dataset = yaml_io.load_file(ROOT / "configs/dev.yml")["dataset"]
    assert tmisc.get_prot_atom_ph_type_maps(dataset) == \
        jmisc.get_prot_atom_ph_type_maps(dataset)
    rng = np.random.default_rng(3)
    coords = [rng.normal(size=(n, 3)).astype(np.float32) for n in (3, 5)]
    types = [rng.integers(0, 6, n) for n in (3, 5)]
    assert tmisc.write_pharmacophore_file(coords, types, []) == \
        jmisc.write_pharmacophore_file(coords, types, [])
    tmisc.write_pharmacophore_file(coords, types, [], tmp_path / "a.xyz")
    jmisc.write_pharmacophore_file(coords, types, [], tmp_path / "b.xyz")
    assert (tmp_path / "a.xyz").read_bytes() == \
        (tmp_path / "b.xyz").read_bytes()
    assert tpaths.fix_relative_path("configs/dev.yml") == \
        jpaths.fix_relative_path("configs/dev.yml")
    tree = {"a": torch.tensor([1.5, 2.0]), "b": [torch.tensor([[3.25]]),
                                                 (torch.zeros(0),)]}
    assert ttiming.fence(tree) == jtiming.fence(
        {"a": np.array([1.5, 2.0], np.float32),
         "b": [np.array([[3.25]], np.float32)]}) == 4.75
    for run_id in (generate_run_id(), jid()):
        assert len(run_id) == 8 and set(run_id) <= set(
            "abcdefghijklmnopqrstuvwxyz0123456789")
    with pytest.raises(ValueError, match="matmul precision"):
        tmisc.set_matmul_precision("float16")


def test_sample_analyzer_matches_jax():
    """The numbers of the test CLI's metrics.txt and pharm_counts_* files:
    both packages' `SampleAnalyzer` on one set of sampled pharmacophores
    with receptor sites, half of the centres placed near a site."""
    from pharmaforge_tpu.analysis.metrics import SampleAnalyzer as JAnalyzer
    from pharmaforge_tpu.analysis.pharm_builder import \
        SampledPharmacophore as JPharm
    from pharmaforge_tpu_torch.analysis.metrics import SampleAnalyzer
    from pharmaforge_tpu_torch.analysis.pharm_builder import \
        SampledPharmacophore
    from pharmaforge_tpu_torch.constants import PH_IDX_TO_TYPE

    rng = np.random.default_rng(11)
    samples = {"jax": [], "port": []}
    for _ in range(12):
        sites = rng.uniform(-6, 6, size=(20, 3))
        site_types = [PH_IDX_TO_TYPE[i] for i in rng.integers(0, 6, 20)]
        n = int(rng.integers(3, 9))
        near = sites[rng.integers(0, 20, n)] + rng.normal(0, 0.8, (n, 3))
        coords = np.where(rng.random((n, 1)) < 0.5, near,
                          rng.uniform(-6, 6, (n, 3)))
        feats = rng.normal(size=(n, 6))
        for key, cls in (("jax", JPharm), ("port", SampledPharmacophore)):
            samples[key].append(cls(coords, feats, PH_IDX_TO_TYPE,
                                    prot_ph_pos=sites,
                                    prot_ph_types=site_types))
    jax_a, port_a = JAnalyzer(), SampleAnalyzer()
    want = jax_a.analyze(samples["jax"])
    assert 0 < want["validity"] < 1
    assert port_a.analyze(samples["port"]) == want
    per_type = jax_a.analyze_per_type(samples["jax"])
    assert port_a.analyze_per_type(samples["port"]) == per_type
    assert sum(per_type[f"count_{t}"] for t in PH_IDX_TO_TYPE) == sum(
        ph.n_ph_centers for ph in samples["jax"])
    freq = port_a.pharm_feat_freq(samples["port"])
    want_freq = jax_a.pharm_feat_freq(samples["jax"])
    assert freq.dtype == want_freq.dtype
    np.testing.assert_array_equal(freq, want_freq)


# ----------------------------------------------------------- import guard

GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
          "pharmaforge_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
import pharmaforge_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               "pharmaforge_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print(len(names))
"""


def test_every_port_module_imports_without_jax_yaml_or_the_jax_package():
    expected = {m.name for m in pkgutil.walk_packages(
        [str(ROOT / "pharmaforge_tpu_torch")], "pharmaforge_tpu_torch.")}
    assert {"pharmaforge_tpu_torch.cli.train",
            "pharmaforge_tpu_torch.cli.test",
            "pharmaforge_tpu_torch.cli.generate",
            "pharmaforge_tpu_torch.config.yaml_io",
            "pharmaforge_tpu_torch.config.cmdline",
            "pharmaforge_tpu_torch.preprocessing.structure",
            "pharmaforge_tpu_torch.training.restore",
            "pharmaforge_tpu_torch.utils.misc",
            "pharmaforge_tpu_torch.utils.timing",
            "pharmaforge_tpu_torch.utils.relative_paths",
            "pharmaforge_tpu_torch.preprocessing.crossdocked",
            "pharmaforge_tpu_torch.preprocessing.receptor_utils",
            "pharmaforge_tpu_torch.cli.process_crossdocked",
            "pharmaforge_tpu_torch.native",
            "pharmaforge_tpu_torch.losses.dist_hinge_loss"} <= expected
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) == len(expected)
