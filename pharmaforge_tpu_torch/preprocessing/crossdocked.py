"""CrossDocked2020 -> training tensors (host-side preprocessing).

Port of `pharmaforge_tpu/preprocessing/crossdocked.py` (reference
process_crossdocked.py): reads gnina `.types` files (keeping label==1
rows) and extracts, for each protein-ligand pair,

* the ligand pharmacophore through the external `pharmit pharma` binary,
* the receptor pharmacophore sites by SMARTS matching
  (`receptor_utils.get_mol_pharm`, looked up here at call time), cut to
  within `pocket_cutoff` of the ligand,
* the pocket heavy atoms of the residues within `pocket_cutoff`,

then packs the pairs into the flat-array `.npz` + `.pkl.gz` layout that
`data/dataset.py` reads. numpy and host code only: nothing here
initialises CUDA, so `cli/process_crossdocked.py` can fork its workers.
RDKit, Biopython and scipy are imported inside the functions; without
Biopython the pocket atoms come from the builtin PDB parser
(`preprocessing/structure.py`) with the same selection.
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
import re
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from pharmaforge_tpu_torch.constants import PH_TYPE_TO_IDX
from pharmaforge_tpu_torch.preprocessing.receptor_utils import get_mol_pharm


def element_fixer(element: str) -> str:
    if len(element) > 1:
        element = element[0] + element[1:].lower()
    return element


def parse_pharmit_json(text: str) -> dict:
    """Parse a pharmit `ph.json` document, tolerating the quirk where some
    outputs contain a SECOND concatenated JSON object — only the first is
    the pharmacophore (reference process_crossdocked.py:75-79). Returns the
    decoded dict (with its 'points' list)."""
    return json.JSONDecoder().raw_decode(text)[0]


def pharmit_points(ph: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(coords [N,3], type indices [N]) of the ENABLED feature points of a
    parsed pharmit document; empty arrays when there are none.

    Points whose name is not one of the 6 feature types are skipped:
    pharmit session/query files can carry ExclusionSphere/InclusionSphere
    points, which are spatial constraints, not pharmacophore features."""
    pts = [p for p in ph.get("points", [])
           if p["enabled"] and p["name"] in PH_TYPE_TO_IDX]
    if not pts:
        return np.zeros((0, 3)), np.zeros((0,), int)
    coords = np.array([(p["x"], p["y"], p["z"]) for p in pts])
    kinds = np.array([PH_TYPE_TO_IDX[p["name"]] for p in pts])
    return coords, kinds


def run_pharmit(rec_path: str, lig_path: str, tmp_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Ligand pharmacophore extraction through the pharmit binary
    (reference process_crossdocked.py:71-87)."""
    phfile = os.path.join(tmp_dir, "ph.json")
    cmd = f"pharmit pharma -receptor {rec_path} -in {lig_path} -out {phfile}"
    subprocess.check_call(cmd, shell=True)

    coords, kinds = pharmit_points(parse_pharmit_json(
        Path(phfile).read_text()))
    if len(coords) == 0:
        return [], []
    return coords, kinds


def resolve_pair_paths(rec: str, glig: str) -> Tuple[str, str, int]:
    """Map the .gninatypes names a types-file row uses onto the on-disk
    receptor PDB / gzipped multi-conformer SDF, plus the conformer index
    encoded in the ligand name's trailing _<n>."""
    rec_pdb = rec.replace("_0.gninatypes", ".pdb")
    m = re.search(r"(\S+)_(\d+)\.gninatypes", glig)
    if m is None:
        raise ValueError(f"unrecognized ligand entry {glig!r}")
    return rec_pdb, m.group(1) + ".sdf.gz", int(m.group(2))


def extract_conformer(lig_gz_path: str, conformer: int, out_dir: str) -> str:
    """Slice conformer #n out of a gzipped multi-record SDF as raw text
    (no chemical parsing) and write it as a standalone .sdf."""
    records = gzip.open(lig_gz_path).read().split(b"$$$$\n")
    out_path = os.path.join(out_dir, "lig.sdf")
    with open(out_path, "wb") as out:
        out.write(records[conformer] + b"$$$$\n")
    return out_path


def load_ligand(lig_path: str):
    """First molecule of a (possibly gzipped) SDF, unsanitized, plus its
    conformer coordinates."""
    from rdkit.Chem import AllChem as Chem

    if lig_path.endswith(".gz"):
        with gzip.open(lig_path) as f:
            mol = next(Chem.ForwardSDMolSupplier(f, sanitize=False))
    else:
        mol = next(Chem.ForwardSDMolSupplier(lig_path, sanitize=False))
    return mol, mol.GetConformer().GetPositions()


def receptor_sites_near_ligand(rec_path: str, lig_coords: np.ndarray,
                               cutoff: float) -> Tuple[np.ndarray, np.ndarray]:
    """SMARTS-derived receptor pharmacophore sites within `cutoff` of any
    ligand atom, as (coords [M,3], type indices [M])."""
    from scipy.spatial.distance import cdist

    site_coords, site_kinds = [np.zeros((0, 3))], [np.zeros((0,), dtype=int)]
    for feature, coords in get_mol_pharm(rec_path).items():
        coords = np.asarray(coords).reshape(-1, 3)
        near = (cdist(coords, lig_coords) <= cutoff).any(axis=1)
        site_coords.append(coords[near])
        site_kinds.append(np.full(int(near.sum()), PH_TYPE_TO_IDX[feature],
                                  dtype=int))
    return np.concatenate(site_coords), np.concatenate(site_kinds)


def pocket_heavy_atoms(pdb_struct, lig_coords: np.ndarray, cutoff: float):
    """Heavy atoms of standard residues with any atom within `cutoff` of the
    ligand: (coords, element symbols, atom names, residue ids)."""
    from Bio.PDB.Polypeptide import is_aa
    from scipy.spatial.distance import cdist

    coords, elements, names, res_ids = [], [], [], []
    for residue in pdb_struct[0].get_residues():
        if not is_aa(residue.get_resname(), standard=True):
            continue
        atoms = list(residue.get_atoms())
        res_coords = np.array([a.get_coord() for a in atoms])
        if cdist(lig_coords, res_coords).min() >= cutoff:
            continue
        for atom in atoms:
            if atom.element == "H":
                continue
            coords.append(atom.get_coord())
            elements.append(element_fixer(atom.element))
            names.append(atom.name)
            res_ids.append(residue.id[1])
    return (np.asarray(coords), np.asarray(elements), np.asarray(names),
            np.asarray(res_ids))


def pocket_heavy_atoms_from_file(rec_path: str, lig_coords: np.ndarray,
                                 cutoff: float):
    """`pocket_heavy_atoms` for a receptor path; uses biopython when
    installed, otherwise the builtin fixed-column PDB parser
    (preprocessing/structure.py) with identical selection semantics."""
    try:
        from Bio.PDB import PDBParser
    except ImportError:
        from pharmaforge_tpu_torch.preprocessing.structure import (
            STANDARD_AA, group_residues, parse_pdb_atoms)

        coords, elements, names, res_ids = [], [], [], []
        residues = group_residues(
            a for a in parse_pdb_atoms(rec_path) if a.record == "ATOM")
        for (chain, resseq, icode, resname), atoms in residues:
            if resname not in STANDARD_AA:
                continue
            res_coords = np.stack([a.coord for a in atoms])
            d2 = np.sum((lig_coords[:, None] - res_coords[None]) ** 2, -1)
            if float(d2.min()) >= cutoff ** 2:
                continue
            for a in atoms:
                if a.element == "H":
                    continue
                coords.append(a.coord)
                elements.append(element_fixer(a.element))
                names.append(a.name)
                res_ids.append(resseq)
        return (np.asarray(coords), np.asarray(elements), np.asarray(names),
                np.asarray(res_ids))
    pdb_struct = PDBParser(QUIET=True).get_structure("", rec_path)
    return pocket_heavy_atoms(pdb_struct, lig_coords, cutoff)


def getfeatures(reclig: Tuple[str, str], crossdocked_data_dir: Path,
                pocket_cutoff: float = 8):
    """Extract all features for one (receptor, ligand) pair. Capability
    parity with reference process_crossdocked.py:39-171; returns the same
    5-tuple layout with None sentinels on failure."""
    rec, glig = reclig
    try:
        rec_rel, lig_rel, conformer = resolve_pair_paths(rec, glig)
        rec = rec_rel
        rec_path = str(crossdocked_data_dir / rec_rel)
        lig_path = str(crossdocked_data_dir / lig_rel)
        for path in (rec_path, lig_path):
            if not os.path.exists(path):
                print(f"missing input file: {path}")

        with tempfile.TemporaryDirectory() as tmp:
            if conformer != 0:
                lig_path = extract_conformer(lig_path, conformer, tmp)
            feature_coords, feature_kind = run_pharmit(rec_path, lig_path,
                                                       tmp)
            ligand, lig_coords = load_ligand(lig_path)

        site_coords, site_kinds = receptor_sites_near_ligand(
            rec_path, lig_coords, pocket_cutoff)
        pocket_coords, pocket_elements, pocket_anames, pocket_rid = \
            pocket_heavy_atoms_from_file(rec_path, lig_coords, pocket_cutoff)

        return (rec, glig, ligand, (feature_coords, feature_kind),
                (pocket_coords, pocket_elements, site_coords, site_kinds,
                 pocket_anames, pocket_rid))
    except Exception as e:  # per-sample fault tolerance
        print(f"preprocessing failed for ({rec}, {glig}): {e}")
        return (rec, glig, None, None, None)


def write_processed_dataset(processed_data_dir: str, types_file_path: str,
                            data: list, pocket_element_map: list,
                            min_pharm_centers: int = 3) -> Path:
    """Pack extracted features into the flat-array npz layout
    (reference process_crossdocked.py:173-263)."""
    pocket_element_to_idx = {el: i for i, el in enumerate(pocket_element_map)}

    prot_file_name, lig_rdmol = [], []
    pharm_pos_arr, pharm_feat_arr = [], []
    prot_pos_arr, prot_feat_arr = [], []
    prot_ph_pos_arr, prot_ph_feat_arr = [], []

    for item in data:
        pharm_types = item[3][1]
        if pharm_types.shape[0] < min_pharm_centers:
            continue
        prot_file_name.append(item[0])
        lig_rdmol.append(item[2])
        pharm_pos_arr.append(item[3][0])
        pharm_feat_arr.append(item[3][1])
        prot_pos_arr.append(item[4][0])
        prot_feat_arr.append(item[4][1])
        prot_ph_pos_arr.append(item[4][2])
        prot_ph_feat_arr.append(item[4][3])

    def spans(arrs):
        n = np.array([len(x) for x in arrs])
        idx = np.zeros((len(arrs), 2), dtype=int)
        idx[:, 1] = np.cumsum(n)
        idx[1:, 0] = idx[:-1, 1]
        return idx

    pharm_pos = np.concatenate(pharm_pos_arr, axis=0, dtype=np.float32)
    pharm_feat = np.concatenate(pharm_feat_arr, axis=0, dtype=np.int32)
    prot_pos = np.concatenate(prot_pos_arr, axis=0, dtype=np.float32)
    prot_ph_pos = np.concatenate(prot_ph_pos_arr, axis=0, dtype=np.float32)
    prot_ph_feat = np.concatenate(prot_ph_feat_arr, axis=0, dtype=np.float32)

    prot_feat_strs = np.concatenate(prot_feat_arr, axis=0)
    prot_feat = np.array([pocket_element_to_idx[el] for el in prot_feat_strs],
                         dtype=np.int32)

    types_file_stem = Path(types_file_path).name.split(".types")[0]
    output_dir = Path(processed_data_dir) / types_file_stem
    output_dir.mkdir(parents=True, exist_ok=True)

    np.savez_compressed(
        output_dir / "prot_pharm_tensors.npz",
        prot_pos=prot_pos, prot_feat=prot_feat, prot_idx=spans(prot_pos_arr),
        pharm_pos=pharm_pos, pharm_feat=pharm_feat,
        pharm_idx=spans(pharm_pos_arr),
        prot_ph_pos=prot_ph_pos, prot_ph_feat=prot_ph_feat,
        prot_ph_idx=spans(prot_ph_pos_arr))

    with gzip.open(output_dir / "lig_rdmol.pkl.gz", "wb") as f:
        pickle.dump(lig_rdmol, f)
    with gzip.open(output_dir / "prot_file_names.pkl.gz", "wb") as f:
        pickle.dump(prot_file_name, f)
    return output_dir


def read_types_files(crossdocked_path: str,
                     dataset_size: Optional[int] = None,
                     pattern: str = "it2_tt_v1.3_0_test*types"
                     ) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """Collect (types_file, [(rec, lig), ...]) pairs with label==1
    (reference process_crossdocked.py:283-298)."""
    import glob
    allinputs = []
    types_files = os.path.join(crossdocked_path, "types", pattern)
    for fname in glob.glob(types_files):
        inputs = []
        with open(fname) as f:
            for idx, line in enumerate(f):
                label, affinity, rmsd, rec, glig, _ = line.split()
                if label == "1":
                    inputs.append((rec, glig))
                if dataset_size is not None and idx > dataset_size:
                    break
        allinputs.append((fname, inputs))
    return allinputs
