"""PyTorch/CUDA port, slice 11: CrossDocked preprocessing, against the JAX
package on the CPU.

The port's `preprocessing/crossdocked.py`, `preprocessing/receptor_utils.py`
and `cli/process_crossdocked.py` beside the JAX package's modules and its
`process_crossdocked.py`, on the two raw trees the JAX package's own tests
build (`tests/test_preprocessing.py`'s stubbed tree and
`tests/test_realchem.py`'s real-format fixtures), with their stand-ins: a
stub `pharmit` on PATH, the RDKit SDF stand-in of `tests/chem_stubs.py`
and `get_mol_pharm` patched in both packages to the same sites.

* `parse_pharmit_json` / `pharmit_points`, `read_types_files` /
  `resolve_pair_paths`: equal outputs.
* `getfeatures`: equal 5-tuples (arrays bit-equal, dtypes equal) for
  conformer 0, a nonzero conformer and the failure sentinel, with the same
  printed lines.
* `write_processed_dataset`: the same npz arrays and dtypes, the same
  pickles.
* Both CLIs with `--max_workers 1` (the JAX one through `runpy`): equal
  split files array for array and the same four count lines per split.
* The port's output loads through the port's datamodule and trains one
  step in the port's train CLI (n_convs=1, 32 scalars, T=10); the port's
  test CLI on that run prints the JAX package's skip line for
  `pocket.pdb` and the reference files.
* Without the chemistry toolkits `receptor_utils` raises the JAX
  package's `ImportError`s.

The SMARTS matches of `get_mol_pharm`, Biopython's pocket writer and a
real `pharmit` need the toolkits and stay unchecked here, as they are in
the JAX package's tests.
"""

import gzip
import json
import pickle
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.preprocessing import crossdocked as jcd
from pharmaforge_tpu.preprocessing import receptor_utils as jru
from pharmaforge_tpu_torch.cli import process_crossdocked as tproc
from pharmaforge_tpu_torch.cli import test as ttest
from pharmaforge_tpu_torch.cli import train as ttrain
from pharmaforge_tpu_torch.config import yaml_io
from pharmaforge_tpu_torch.preprocessing import crossdocked as tcd
from pharmaforge_tpu_torch.preprocessing import receptor_utils as tru
from tests.test_preprocessing import raw_tree as stub_tree  # noqa: F401
from tests.test_realchem import FIXTURES
from tests.test_realchem import raw_tree as realchem_tree  # noqa: F401
from tests.test_torch_port_cli import tiny_config

ROOT = Path(__file__).resolve().parents[1]
ELEMENTS = ["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B", "D"]
COUNT_LINES = ("processing types file ", " samples in ", "failed to parse ",
               "processed ")


@pytest.fixture(params=["stub", "realchem"])
def raw(request, monkeypatch):
    """One of the JAX tests' raw trees, its stand-ins installed, and the
    port's `get_mol_pharm` patched to the JAX module's stand-in."""
    tree = request.getfixturevalue(f"{request.param}_tree")
    monkeypatch.setattr(tcd, "get_mol_pharm", jcd.get_mol_pharm)
    return tree


def pairs(raw_dir: Path) -> list:
    """The label-1 (receptor, ligand) rows of split 0."""
    found = dict(jcd.read_types_files(str(raw_dir)))
    return next(v for k, v in found.items() if k.endswith("test0.types"))


def assert_same(got, want):
    """Equal nested tuples / lists: arrays bit-equal with equal dtypes,
    RDKit stand-in molecules by their positions."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif hasattr(want, "GetConformer"):
        np.testing.assert_array_equal(got.GetConformer().GetPositions(),
                                      want.GetConformer().GetPositions())
    else:
        assert got == want


@pytest.mark.parametrize("doc", ["double object", "realchem", "empty"])
def test_pharmit_document_matches_jax(doc):
    if doc == "double object":
        text = json.dumps({"points": [
            {"name": "Aromatic", "x": 1.0, "y": 2.0, "z": 3.0,
             "enabled": True},
            {"name": "Hydrophobic", "x": 0.0, "y": 0.0, "z": 0.0,
             "enabled": False},
            {"name": "ExclusionSphere", "x": 5.0, "y": 0.0, "z": 0.0,
             "enabled": True},
            {"name": "NegativeIon", "x": -1.0, "y": 0.5, "z": 2.0,
             "enabled": True},
        ]}) + json.dumps({"second": "object"})
    elif doc == "realchem":
        text = (FIXTURES / "ph.json").read_text()
    else:
        text = json.dumps({"points": []})
    got, want = tcd.parse_pharmit_json(text), jcd.parse_pharmit_json(text)
    assert got == want
    assert_same(tcd.pharmit_points(got), jcd.pharmit_points(want))


def test_types_files_and_pair_paths_match_jax(raw):
    for size in (None, 0):
        got = tcd.read_types_files(str(raw), size)
        assert got == jcd.read_types_files(str(raw), size)
        assert len(got) == 3
    for rec, lig in pairs(raw):
        assert (tcd.resolve_pair_paths(rec, lig)
                == jcd.resolve_pair_paths(rec, lig))
    for mod in (tcd, jcd):
        with pytest.raises(ValueError, match="unrecognized ligand entry"):
            mod.resolve_pair_paths("A/r_0.gninatypes", "A/not-a-types-name")


def test_getfeatures_matches_jax(raw, capsys):
    data_dir = raw / "CrossDocked2020"
    kinds = set()
    for pair in pairs(raw):
        want = jcd.getfeatures(pair, crossdocked_data_dir=data_dir,
                               pocket_cutoff=8)
        want_out = capsys.readouterr().out
        got = tcd.getfeatures(pair, crossdocked_data_dir=data_dir,
                              pocket_cutoff=8)
        assert capsys.readouterr().out == want_out
        assert_same(got, want)
        conformer = tcd.resolve_pair_paths(*pair)[2]
        kinds.add("failure" if want[2] is None else f"conformer {conformer}")
        if want[2] is None:
            assert got[2:] == (None, None, None)
            assert "preprocessing failed for" in want_out
    assert kinds == ({"conformer 0", "conformer 1", "failure"}
                     if "recA" in str(pairs(raw)) else {"conformer 1"})


def test_write_processed_dataset_matches_jax(raw, tmp_path):
    data_dir = raw / "CrossDocked2020"
    data = [jcd.getfeatures(p, crossdocked_data_dir=data_dir,
                            pocket_cutoff=8) for p in pairs(raw)]
    data = [ex for ex in data if ex[2]]
    outs = [mod.write_processed_dataset(
        str(tmp_path / name), "types/it2_tt_v1.3_0_test0.types", data,
        pocket_element_map=ELEMENTS, min_pharm_centers=3)
        for name, mod in (("port", tcd), ("jax", jcd))]
    assert [o.name for o in outs] == ["it2_tt_v1.3_0_test0"] * 2
    assert_split_equal(*outs)


def assert_split_equal(got: Path, want: Path) -> None:
    """Two processed split directories hold the same files, npz arrays
    (values and dtypes) and pickles."""
    assert sorted(p.name for p in got.iterdir()) == sorted(
        p.name for p in want.iterdir())
    a = np.load(got / "prot_pharm_tensors.npz")
    b = np.load(want / "prot_pharm_tensors.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("prot_file_names.pkl.gz", "lig_rdmol.pkl.gz"):
        with gzip.open(got / name) as f, gzip.open(want / name) as g:
            assert_same(pickle.load(f), pickle.load(g))


def preprocess_config(raw_dir: Path, out: Path) -> dict:
    return {"dataset": {"raw_data_dir": str(raw_dir),
                        "processed_data_dir": str(out), "pocket_cutoff": 8,
                        "min_pharm_centers": 3, "prot_elements": ELEMENTS}}


def run_both_clis(raw_dir: Path, tmp_path: Path, monkeypatch, capsys):
    """Both CLIs over `raw_dir` with --max_workers 1: ({side: processed
    dir}, {side: the count lines printed})."""
    dirs, lines = {}, {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / f"processed_{side}"
        cfg = tmp_path / f"preprocess_{side}.yml"
        cfg.write_text(yaml.dump(preprocess_config(raw_dir, dirs[side])))
        argv = ["--config", str(cfg), "--max_workers", "1"]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["process_crossdocked.py", *argv])
            runpy.run_path(str(ROOT / "process_crossdocked.py"),
                           run_name="__main__")
        else:
            assert tproc.main(argv) == dirs[side]
        lines[side] = [ln for ln in capsys.readouterr().out.splitlines()
                       if any(k in ln for k in COUNT_LINES)]
    return dirs, lines


def test_cli_matches_jax(raw, tmp_path, monkeypatch, capsys):
    dirs, lines = run_both_clis(raw, tmp_path, monkeypatch, capsys)
    assert lines["port"] == lines["jax"]
    assert len(lines["jax"]) == 12
    splits = sorted(p.name for p in dirs["jax"].iterdir())
    assert splits == [f"it2_tt_v1.3_0_test{i}" for i in range(3)]
    assert sorted(p.name for p in dirs["port"].iterdir()) == splits
    for split in splits:
        assert_split_equal(dirs["port"] / split, dirs["jax"] / split)


def test_port_output_trains_and_tests(realchem_tree, tmp_path, monkeypatch,
                                      capsys):
    """The port's preprocessing output through the port's datamodule, one
    step of the port's train CLI and its test CLI on the CPU."""
    monkeypatch.setattr(tcd, "get_mol_pharm", jcd.get_mol_pharm)
    processed = tmp_path / "processed"
    cfg = tmp_path / "preprocess.yml"
    yaml_io.dump_file(preprocess_config(realchem_tree, processed), cfg)
    tproc.main(["--config", str(cfg), "--max_workers", "1"])

    config = tiny_config(tmp_path)
    del config["dataset"]["synthetic"], config["dataset"]["dataset_size"]
    config["dataset"].update(
        raw_data_dir=str(realchem_tree / "CrossDocked2020"),
        processed_data_dir=str(processed), subsample_pharms=False)
    config["training"].update(batch_size=2)
    config["training"]["trainer_args"]["max_epochs"] = 1
    config["dynamics"].update(n_convs=1, n_hidden_scalars=32)
    yaml_io.dump_file(config, tmp_path / "run.yml")
    run = ttrain.main(["--config", str(tmp_path / "run.yml"), "--seed", "1",
                       "--device", "cpu"])
    records = [json.loads(ln) for ln in
               (run / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "train total loss" in r]
    assert len(steps) == 1 and np.isfinite(steps[0]["train total loss"])

    # the JAX package's line: the ImportError its pocket writer raises
    # without Biopython
    monkeypatch.setitem(sys.modules, "Bio", None)
    with pytest.raises(ImportError) as err:
        jru.write_pocket_file(Path("rec.pdb"), None, Path("pocket.pdb"))
    capsys.readouterr()
    out = ttest.main(["--model_dir", str(run), "--samples_per_pocket", "2",
                      "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert f"skipping pocket.pdb/reference files ({err.value})" in printed
    assert (out / "pocket_0" / "pharms.xyz").is_file()
    assert not (out / "pocket_0" / "pocket.pdb").exists()


@pytest.mark.parametrize("call", ["get_mol_pharm", "PocketSelector",
                                  "write_pocket_file"])
def test_receptor_utils_raise_the_jax_import_errors(call, monkeypatch):
    for name in ("rdkit", "Bio", "openbabel"):
        monkeypatch.setitem(sys.modules, name, None)
    args = {"get_mol_pharm": ("rec.pdb",), "PocketSelector": ([],),
            "write_pocket_file": (Path("rec.pdb"), None, Path("out.pdb"))}
    messages = []
    for mod in (tru, jru):
        with pytest.raises(ImportError) as err:
            getattr(mod, call)(*args[call])
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "required" in messages[0]
