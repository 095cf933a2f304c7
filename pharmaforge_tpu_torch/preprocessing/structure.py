"""Dependency-free protein/ligand structure IO.

Port of `pharmaforge_tpu/preprocessing/structure.py` (numpy only): the
parsers the arbitrary-receptor CLI (`cli/generate.py`) builds its pocket
with -- PDB and mmCIF receptors, SDF V2000 reference ligands -- with the
selection semantics of the reference inference path's libraries
(reference generate_pharmacophores.py:120-220):

* fixed-column ``ATOM``/``HETATM`` records, first ``MODEL`` only, first
  altloc only (biopython's default atom iteration);
* element from PDB columns 77-78, falling back to the atom-name columns
  with the standard right-justification rule when the element field is
  blank (old PDB writers);
* SDF atom coordinates from the V2000 counts/atom block (rdkit
  ``GetConformer().GetPositions()`` equivalent -- only positions are
  consumed by the inference CLI).

No bond perception, no occupancy/anisou handling, no polymer detection
beyond the standard amino-acid table.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Sequence, Tuple

import numpy as np

# the 20 standard amino acids — biopython's is_aa(standard=True) table
STANDARD_AA = frozenset(
    "ALA ARG ASN ASP CYS GLN GLU GLY HIS ILE LEU LYS MET PHE PRO SER THR "
    "TRP TYR VAL".split())

# two-letter elements that legitimately appear in protein/ligand PDB files;
# used only by the atom-name fallback when columns 77-78 are blank
_TWO_LETTER_ELEMENTS = frozenset(
    "BR CL FE ZN MG MN CU NA CA SE CO NI CD HG".split())


class PdbAtom(NamedTuple):
    """One PDB coordinate record (original line retained for re-writing)."""

    record: str     # 'ATOM' | 'HETATM'
    name: str       # atom name, stripped
    resname: str
    chain: str
    resseq: int
    icode: str      # insertion code, ' ' when absent
    x: float
    y: float
    z: float
    element: str    # capitalized, e.g. 'C', 'Zn'
    line: str       # the verbatim input line

    @property
    def coord(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], dtype=np.float32)


def _element_from_name(raw_name: str) -> str:
    """Derive the element from the atom-name columns (13-16).

    PDB right-justifies one-letter elements so column 13 is blank for
    ' CA ' (an alpha carbon) but filled for 'CA  ' (calcium) — the
    column-13 test distinguishes them. Digits (as in 'HG21') are ignored.
    """
    letters = "".join(c for c in raw_name if c.isalpha())
    if not letters:
        return ""
    if raw_name[:1] != " " and letters[:2].upper() in _TWO_LETTER_ELEMENTS:
        return letters[:2].capitalize()
    return letters[0].upper()


def parse_pdb_atoms(path) -> List[PdbAtom]:
    """Parse the coordinate records of a PDB file (first model only)."""
    atoms: List[PdbAtom] = []
    with open(path) as f:
        for line in f:
            rec = line[:6].strip()
            if rec == "ENDMDL":
                break  # biopython-equivalent default: first model
            if rec not in ("ATOM", "HETATM"):
                continue
            if len(line) < 54:
                raise ValueError(f"truncated PDB coordinate record: {line!r}")
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue  # keep the first alternate location only
            element = line[76:78].strip() if len(line) >= 78 else ""
            if element:
                element = element.capitalize()
            else:
                element = _element_from_name(line[12:16])
            atoms.append(PdbAtom(
                record=rec,
                name=line[12:16].strip(),
                resname=line[17:20].strip(),
                chain=line[21],
                resseq=int(line[22:26]),
                icode=line[26] if len(line) > 26 else " ",
                x=float(line[30:38]),
                y=float(line[38:46]),
                z=float(line[46:54]),
                element=element,
                line=line.rstrip("\n"),
            ))
    if not atoms:
        raise ValueError(f"no ATOM/HETATM records found in {path}")
    return atoms


ResidueKey = Tuple[str, int, str, str]  # (chain, resseq, icode, resname)


def group_residues(
        atoms: Iterable[PdbAtom]) -> List[Tuple[ResidueKey, List[PdbAtom]]]:
    """Group atoms into residues, preserving file order."""
    order: List[ResidueKey] = []
    groups = {}
    for a in atoms:
        key = (a.chain, a.resseq, a.icode, a.resname)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(a)
    return [(k, groups[k]) for k in order]


def write_pdb_lines(atoms: Sequence[PdbAtom], path) -> None:
    """Write atoms back out verbatim (the pocket.pdb artifact)."""
    with open(path, "w") as f:
        for a in atoms:
            f.write(a.line + "\n")
        f.write("END\n")


def _pdb_line_from_fields(record, serial, name, altloc, resname, chain,
                          resseq, icode, x, y, z, element) -> str:
    """Format one PDB coordinate record (for pocket.pdb written from a
    non-PDB source). Columns per the PDB spec; one-letter elements are
    right-justified in the name field."""
    name_field = name if len(name) >= 4 else (
        f"{name:<4s}" if len(element) == 2 else f" {name:<3s}")
    return (f"{record:<6s}{serial:>5d} {name_field[:4]}{altloc}"
            f"{resname:>3s} {chain[:1]}{resseq:>4d}{icode}   "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          "
            f"{element:>2s}")


def parse_mmcif_atoms(path) -> List[PdbAtom]:
    """Parse the `_atom_site` loop of an mmCIF file into `PdbAtom`s.

    Minimal by design: whitespace-tokenized rows with single/double-quote
    handling, first model only, first altloc only — the subset the
    inference path needs (biopython's MMCIFParser equivalent for pocket
    selection). `line` is a reconstructed PDB record so pocket.pdb can be
    written from an mmCIF source.
    """
    cols: List[str] = []
    atoms: List[PdbAtom] = []
    in_loop = False

    def tokens(s: str) -> List[str]:
        out, i, n = [], 0, len(s)
        while i < n:
            c = s[i]
            if c.isspace():
                i += 1
            elif c in "'\"":
                j = s.find(c, i + 1)
                j = n if j < 0 else j
                out.append(s[i + 1:j])
                i = j + 1
            else:
                j = i
                while j < n and not s[j].isspace():
                    j += 1
                out.append(s[i:j])
                i = j
        return out

    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if line.startswith("loop_"):
                cols, in_loop = [], True
                continue
            if in_loop and line.startswith("_"):
                cols.append(line.split()[0])
                continue
            if in_loop and cols and not all(
                    c.startswith("_atom_site.") for c in cols):
                in_loop = False
                cols = []
            if not (in_loop and cols):
                continue
            if not line or line.startswith(("#", "_")):
                if line.startswith("#"):
                    in_loop = False
                continue
            row = tokens(line)
            if len(row) != len(cols):
                continue
            rec = dict(zip((c.split(".", 1)[1] for c in cols), row))
            group = rec.get("group_PDB", "ATOM")
            if group not in ("ATOM", "HETATM"):
                continue
            model = rec.get("pdbx_PDB_model_num", "1")
            if model not in ("1", ".", "?"):
                continue
            alt = rec.get("label_alt_id", ".")
            if alt not in (".", "?", "A"):
                continue
            name = rec.get("auth_atom_id", rec.get("label_atom_id", ""))
            resname = rec.get("auth_comp_id", rec.get("label_comp_id", ""))
            chain = rec.get("auth_asym_id", rec.get("label_asym_id", " "))
            seq = rec.get("auth_seq_id", rec.get("label_seq_id", "0"))
            icode = rec.get("pdbx_PDB_ins_code", "?")
            icode = " " if icode in (".", "?") else icode
            x = float(rec["Cartn_x"])
            y = float(rec["Cartn_y"])
            z = float(rec["Cartn_z"])
            element = rec.get("type_symbol", "")
            element = (element.capitalize() if element not in (".", "?", "")
                       else _element_from_name(f" {name:<3s}"))
            serial = len(atoms) + 1
            atoms.append(PdbAtom(
                record=group, name=name, resname=resname, chain=chain[:1],
                resseq=int(seq), icode=icode, x=x, y=y, z=z, element=element,
                line=_pdb_line_from_fields(group, serial, name, " ", resname,
                                           chain, int(seq), icode, x, y, z,
                                           element.upper()),
            ))
    if not atoms:
        raise ValueError(f"no _atom_site records found in {path}")
    return atoms


def parse_structure_atoms(path) -> List[PdbAtom]:
    """Dispatch on suffix: .pdb -> fixed columns, .mmcif/.cif -> atom_site."""
    suffix = str(path).lower()
    if suffix.endswith((".mmcif", ".cif")):
        return parse_mmcif_atoms(path)
    return parse_pdb_atoms(path)


def parse_sdf_coords(path, remove_hydrogen: bool = False) -> np.ndarray:
    """Atom positions [N, 3] from the first molecule of an SDF (V2000)."""
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) < 4:
        raise ValueError(f"not an SDF file: {path}")
    counts = lines[3]
    if "V2000" not in counts:
        raise ValueError(
            f"unsupported SDF version in {path!r} (only V2000 molblocks are "
            "supported without rdkit; install rdkit for V3000)")
    n_atoms = int(counts[:3])
    if len(lines) < 4 + n_atoms:
        raise ValueError(f"SDF atom block truncated in {path}")
    coords, elements = [], []
    for i in range(n_atoms):
        row = lines[4 + i]
        coords.append((float(row[0:10]), float(row[10:20]),
                       float(row[20:30])))
        elements.append(row[31:34].strip())
    out = np.asarray(coords, dtype=np.float32)
    if remove_hydrogen:
        keep = np.array([e != "H" for e in elements], bool)
        out = out[keep]
    if out.shape[0] == 0:
        raise ValueError(f"no atoms left after hydrogen removal in {path}")
    return out


def min_dists(a: np.ndarray, b: np.ndarray) -> float:
    """min pairwise distance between two coordinate sets (cdist-free)."""
    d2 = np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    return float(np.sqrt(d2.min()))
