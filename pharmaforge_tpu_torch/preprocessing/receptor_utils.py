"""Receptor pharmacophore extraction and pocket PDB writing (host-side).

Port of `pharmaforge_tpu/preprocessing/receptor_utils.py` (reference
dataset/receptor_utils.py:18-106). The chemistry toolkits (RDKit,
OpenBabel, Biopython) and scipy are imported inside the functions: the
training and sampling paths never touch them, and hosts without them get
the same `ImportError` as the JAX package, only when these functions run.

SMARTS matching: the reference matches each pattern with both OpenBabel
and RDKit, averaging the matched atoms' coordinates per hit and
deduplicating RDKit hits against the OpenBabel ones. That holds where
OpenBabel is installed; without it the matching is RDKit only (the JAX
package's documented difference: OpenBabel-only matches are missed).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

# SMARTS pattern library for the 6 feature classes
# (reference receptor_utils.py:29-37)
PHARMACOPHORE_SMARTS: Dict[str, List[str]] = {
    "Aromatic": ["a1aaaaa1", "a1aaaa1"],
    "PositiveIon": ["[+,+2,+3,+4]", "[$(C(N)(N)=N)]", "[$(n1cc[nH]c1)]"],
    "NegativeIon": ["[-,-2,-3,-4]", "C(=O)[O-,OH,OX1]"],
    "HydrogenAcceptor": [
        "[#7&!$([nX3])&!$([NX3]-*=[!#6])&!$([NX3]-[a])&!$([NX4])&!$(N=C([C,N])N)]",
        "[$([O])&!$([OX2](C)C=O)&!$(*(~a)~a)]",
    ],
    "HydrogenDonor": [
        "[#7!H0&!$(N-[SX4](=O)(=O)[CX4](F)(F)F)]",
        "[#8!H0&!$([OH][C,S,P]=O)]",
        "[#16!H0]",
    ],
    "Hydrophobic": [
        "a1aaaaa1", "a1aaaa1",
        "[$([CH3X4,CH2X3,CH1X2,F,Cl,Br,I])&!$(**[CH3X4,CH2X3,CH1X2,F,Cl,Br,I])]",
        "[$(*([CH3X4,CH2X3,CH1X2,F,Cl,Br,I])[CH3X4,CH2X3,CH1X2,F,Cl,Br,I])&!$(*([CH3X4,CH2X3,CH1X2,F,Cl,Br,I])([CH3X4,CH2X3,CH1X2,F,Cl,Br,I])[CH3X4,CH2X3,CH1X2,F,Cl,Br,I])]([CH3X4,CH2X3,CH1X2,F,Cl,Br,I])[CH3X4,CH2X3,CH1X2,F,Cl,Br,I]",
        "[CH2X4,CH1X3,CH0X2]~[CH3X4,CH2X3,CH1X2,F,Cl,Br,I]",
        "[$([CH2X4,CH1X3,CH0X2]~[$([!#1]);!$([CH2X4,CH1X3,CH0X2])])]~[CH2X4,CH1X3,CH0X2]~[CH2X4,CH1X3,CH0X2]",
        "[$([S]~[#6])&!$(S~[!#6])]",
    ],
}


def _require_rdkit():
    try:
        from rdkit.Chem import MolFromSmarts, rdmolfiles  # noqa: F401
        import rdkit.Chem as Chem  # noqa: F401
        return True
    except ImportError as e:
        raise ImportError(
            "rdkit is required for receptor pharmacophore extraction; "
            "install it on the preprocessing host") from e


def get_mol_pharm(pdb_file_path: str) -> Dict[str, List[np.ndarray]]:
    """Pharmacophore feature locations in a protein
    (reference receptor_utils.py:18-69).

    Returns {feature_name: [xyz, ...]} where each xyz is the mean of the
    matched atoms' coordinates.
    """
    _require_rdkit()
    from rdkit.Chem import MolFromSmarts, rdmolfiles

    rdmol = rdmolfiles.MolFromPDBFile(pdb_file_path, sanitize=True)

    try:
        from openbabel import pybel
        pybel.ob.obErrorLog.StopLogging()
        pybel.ob.obErrorLog.SetOutputLevel(0)
        obmol = next(pybel.readfile("pdb", pdb_file_path))
        atoms = obmol.atoms
        atom_coords = np.array([a.coords for a in atoms])
        have_ob = True
    except ImportError:
        obmol = None
        have_ob = False
        if rdmol is None:
            return {}
        conf = rdmol.GetConformer()
        atom_coords = np.array(
            [list(conf.GetAtomPosition(i)) for i in range(rdmol.GetNumAtoms())])

    feats: Dict[str, List[np.ndarray]] = {}

    def add(key: str, positions: np.ndarray, dedup: bool):
        bucket = feats.setdefault(key, [])
        if dedup and any(np.array_equal(positions, p) for p in bucket):
            return
        bucket.append(positions)

    for key, patterns in PHARMACOPHORE_SMARTS.items():
        for smart in patterns:
            if have_ob:
                from openbabel import pybel
                obsmarts = pybel.Smarts(smart)
                for match in obsmarts.findall(obmol):
                    pos = atom_coords[[i - 1 for i in match]].mean(axis=0)
                    add(key, pos, dedup=False)
            try:
                from rdkit.Chem import MolFromSmarts
                smarts_mol = MolFromSmarts(smart)
                if rdmol is None or smarts_mol is None:
                    continue
                for match in rdmol.GetSubstructMatches(smarts_mol,
                                                       uniquify=True):
                    pos = atom_coords[list(match)].mean(axis=0)
                    add(key, pos, dedup=True)
            except Exception:
                pass
    return feats


class PocketSelector:
    """Bio.PDB Select restricted to pocket residues
    (reference receptor_utils.py:71-78)."""

    def __init__(self, residues: list):
        try:
            from Bio.PDB.PDBIO import Select
        except ImportError as e:
            raise ImportError("biopython is required for pocket selection") from e
        self.residues = residues
        # dynamically subclass Select so Bio.PDB accepts this object
        sel = self

        class _Sel(Select):
            def accept_residue(self, residue):
                return residue in sel.residues

        self._select = _Sel()

    def accept_residue(self, residue):
        return residue in self.residues

    @property
    def bio_select(self):
        return self._select


class Unparsable(Exception):
    pass


def write_pocket_file(rec_file: Path, lig_rdmol, output_pocket_file: Path,
                      cutoff: float = 5):
    """Write the pocket residues (within `cutoff` of the ligand) to a PDB
    (reference receptor_utils.py:83-106)."""
    try:
        from Bio.PDB import PDBIO, PDBParser
    except ImportError as e:
        raise ImportError("biopython is required for pocket PDB writing") from e
    from scipy.spatial.distance import cdist

    pdb_struct = PDBParser(QUIET=True).get_structure("", rec_file)

    ligand_conformer = lig_rdmol.GetConformer()
    atom_positions = ligand_conformer.GetPositions()

    try:
        from Bio.PDB.Polypeptide import is_aa
    except ImportError as e:
        raise ImportError("biopython is required") from e

    pocket_residues = []
    for residue in pdb_struct[0].get_residues():
        if not is_aa(residue.get_resname(), standard=True):
            continue
        res_coords = np.array([a.get_coord() for a in residue.get_atoms()])
        if cdist(atom_positions, res_coords).min() < cutoff:
            pocket_residues.append(residue)

    pocket_selector = PocketSelector(pocket_residues)
    pdb_io = PDBIO()
    pdb_io.set_structure(pdb_struct)
    pdb_io.save(str(output_pocket_file), pocket_selector.bio_select)
